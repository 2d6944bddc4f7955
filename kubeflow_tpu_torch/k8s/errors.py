"""Typed API errors mirroring Kubernetes apimachinery status reasons.

The port's own copy of ``kubeflow_tpu/k8s/errors.py``: the same exception
types, codes, reasons and predicates (``is_not_found``, ``is_conflict``),
so a controller's error handling reads the same against either package's
cluster.
"""

from __future__ import annotations


class ApiError(Exception):
    code: int = 500
    reason: str = "InternalError"

    def __init__(self, message: str = ""):
        super().__init__(message or self.reason)
        self.message = message


class NotFoundError(ApiError):
    code = 404
    reason = "NotFound"


class AlreadyExistsError(ApiError):
    code = 409
    reason = "AlreadyExists"


class ConflictError(ApiError):
    """Optimistic-concurrency failure (stale resourceVersion)."""

    code = 409
    reason = "Conflict"


class InvalidError(ApiError):
    code = 422
    reason = "Invalid"


class WebhookDeniedError(ApiError):
    """An admission webhook rejected the request."""

    code = 403
    reason = "Forbidden"


class ExpiredError(ApiError):
    """Watch/list resourceVersion older than the server's retention window
    (HTTP 410 Gone) — the client must relist."""

    code = 410
    reason = "Expired"


def is_not_found(err: Exception) -> bool:
    return isinstance(err, NotFoundError)


def is_conflict(err: Exception) -> bool:
    return isinstance(err, ConflictError)


def is_already_exists(err: Exception) -> bool:
    return isinstance(err, AlreadyExistsError)
