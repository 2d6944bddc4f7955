"""Client interface: the seam between controllers and the API server.

The port's own copy of ``kubeflow_tpu/k8s/client.py``. Controllers talk
only through this protocol, so the in-memory ``FakeCluster`` and a real
API server client are interchangeable; ``retry_on_conflict`` re-runs a
read-modify-write on 409 as client-go's ``retry.RetryOnConflict`` does.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Protocol, TypeVar

from kubeflow_tpu_torch.k8s.errors import ConflictError


class Client(Protocol):
    def get(self, kind: str, name: str, namespace: str = "") -> dict: ...

    def list(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[dict] = None,
        field_selector: Optional[dict] = None,
    ) -> list[dict]: ...

    def create(self, obj: dict) -> dict: ...

    def update(self, obj: dict) -> dict: ...

    def update_status(self, obj: dict) -> dict: ...

    def patch(self, kind: str, name: str, namespace: str, patch: dict) -> dict: ...

    def delete(self, kind: str, name: str, namespace: str = "") -> None: ...


T = TypeVar("T")


def retry_on_conflict(
    fn: Callable[[], T],
    attempts: int = 5,
    backoff_s: float = 0.0,
) -> T:
    """client-go retry.RetryOnConflict: re-run read-modify-write on 409.

    Every annotation/finalizer mutation in the reference is wrapped in this
    (e.g. reference culling_controller.go:170-197); same discipline here.
    """
    last: Exception = ConflictError("no attempts made")
    for i in range(attempts):
        try:
            return fn()
        except ConflictError as err:
            last = err
            if backoff_s and i < attempts - 1:
                time.sleep(backoff_s * (2**i))
    raise last
