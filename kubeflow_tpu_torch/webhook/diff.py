"""First-difference reporting for update-blocking diagnostics.

The port's own copy of ``kubeflow_tpu/webhook/diff.py``.

Counterpart of the reference's go-cmp ``FirstDifferenceReporter``
(reference notebook_mutating_webhook.go:602-646, including its panic guards)
used to annotate *why* an update is pending on a running notebook.
"""

from __future__ import annotations

from typing import Any, Optional


def first_difference(a: Any, b: Any, path: str = "") -> Optional[str]:
    """Human-readable path + values of the first difference, or None."""
    if type(a) is not type(b):
        return f"{path or '.'}: type {type(a).__name__} != {type(b).__name__}"
    if isinstance(a, dict):
        for key in sorted(set(a) | set(b)):
            sub_path = f"{path}.{key}" if path else key
            if key not in a:
                return f"{sub_path}: added {_short(b[key])}"
            if key not in b:
                return f"{sub_path}: removed {_short(a[key])}"
            diff = first_difference(a[key], b[key], sub_path)
            if diff:
                return diff
        return None
    if isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            diff = first_difference(x, y, f"{path}[{i}]")
            if diff:
                return diff
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        return None
    if a != b:
        return f"{path or '.'}: {_short(a)} != {_short(b)}"
    return None


def _short(value: Any, limit: int = 64) -> str:
    text = repr(value)
    return text if len(text) <= limit else text[: limit - 3] + "..."
