"""Helpers over dict-shaped Kubernetes objects.

The port's own copy of ``kubeflow_tpu/k8s/objects.py``. Objects are plain
dicts in the JSON shape the API server uses, so manifests, fixtures and
admission payloads round-trip without a typed layer. The helpers cover
controller references, label and field selectors, JSON merge patch
(RFC 7386), conditions and the API server's timestamps.
"""

from __future__ import annotations

import copy
from typing import Any, Optional


def name_of(obj: dict) -> str:
    return obj.get("metadata", {}).get("name", "")


def namespace_of(obj: dict) -> str:
    return obj.get("metadata", {}).get("namespace", "")


def uid_of(obj: dict) -> str:
    return obj.get("metadata", {}).get("uid", "")


def labels_of(obj: dict) -> dict:
    return obj.setdefault("metadata", {}).setdefault("labels", {})


def annotations_of(obj: dict) -> dict:
    return obj.setdefault("metadata", {}).setdefault("annotations", {})


def get_annotation(obj: dict, key: str, default: Optional[str] = None) -> Optional[str]:
    return obj.get("metadata", {}).get("annotations", {}).get(key, default)


def set_annotation(obj: dict, key: str, value: str) -> None:
    annotations_of(obj)[key] = value


def remove_annotation(obj: dict, key: str) -> bool:
    anns = obj.get("metadata", {}).get("annotations", {})
    if key in anns:
        del anns[key]
        return True
    return False


def new_object(
    api_version: str,
    kind: str,
    name: str,
    namespace: str = "",
    labels: Optional[dict] = None,
    annotations: Optional[dict] = None,
) -> dict:
    meta: dict[str, Any] = {"name": name}
    if namespace:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    return {"apiVersion": api_version, "kind": kind, "metadata": meta}


# ---------------------------------------------------------------------------
# Owner references


def set_controller_reference(owner: dict, obj: dict) -> None:
    """Mark ``obj`` as controlled by ``owner`` (controllerutil semantics)."""
    refs = obj.setdefault("metadata", {}).setdefault("ownerReferences", [])
    for ref in refs:
        if ref.get("controller") and ref.get("uid") != uid_of(owner):
            raise ValueError(
                f"{name_of(obj)} already controlled by {ref.get('name')}"
            )
    ref = {
        "apiVersion": owner.get("apiVersion", ""),
        "kind": owner.get("kind", ""),
        "name": name_of(owner),
        "uid": uid_of(owner),
        "controller": True,
        "blockOwnerDeletion": True,
    }
    refs[:] = [r for r in refs if r.get("uid") != ref["uid"]] + [ref]


def set_owner_reference(owner: dict, obj: dict) -> None:
    """Non-controller owner reference (GC only)."""
    refs = obj.setdefault("metadata", {}).setdefault("ownerReferences", [])
    if not any(r.get("uid") == uid_of(owner) for r in refs):
        refs.append(
            {
                "apiVersion": owner.get("apiVersion", ""),
                "kind": owner.get("kind", ""),
                "name": name_of(owner),
                "uid": uid_of(owner),
            }
        )


def owner_uid(obj: dict) -> Optional[str]:
    """UID of the controlling owner, if any."""
    for ref in obj.get("metadata", {}).get("ownerReferences", []):
        if ref.get("controller"):
            return ref.get("uid")
    return None


def is_controlled_by(owner: dict, obj: dict) -> bool:
    return owner_uid(obj) == uid_of(owner) and uid_of(owner) != ""


# ---------------------------------------------------------------------------
# Selectors and patch


def matches_labels(obj: dict, selector: Optional[dict]) -> bool:
    if not selector:
        return True
    labels = obj.get("metadata", {}).get("labels", {})
    return all(labels.get(k) == v for k, v in selector.items())


def matches_fields(obj: dict, selector: Optional[dict]) -> bool:
    """fieldSelector equality over dotted paths (the apiserver's indexed
    subset, e.g. ``involvedObject.name=wb-0`` on Events)."""
    if not selector:
        return True
    for path, want in selector.items():
        cur = obj
        for part in path.split("."):
            if not isinstance(cur, dict):
                cur = None
                break
            cur = cur.get(part)
        if cur != want:
            return False
    return True


def merge_patch(obj: dict, patch: dict) -> dict:
    """Apply an RFC 7386 JSON merge patch, returning a new object."""
    result = copy.deepcopy(obj)
    _merge_into(result, patch)
    return result


def _merge_into(target: dict, patch: dict) -> None:
    for key, value in patch.items():
        if value is None:
            target.pop(key, None)
        elif isinstance(value, dict) and isinstance(target.get(key), dict):
            _merge_into(target[key], value)
        else:
            target[key] = copy.deepcopy(value)


# ---------------------------------------------------------------------------
# Conditions (metav1.Condition idiom)


def get_condition(obj: dict, cond_type: str) -> Optional[dict]:
    for c in obj.get("status", {}).get("conditions", []):
        if c.get("type") == cond_type:
            return c
    return None


def set_condition(obj: dict, condition: dict, now: Optional[str] = None) -> None:
    """Upsert a condition by type (meta.SetStatusCondition semantics).

    ``lastTransitionTime`` is stamped when the condition first appears or its
    status flips; unchanged statuses keep the previous transition time.
    """
    if now is None:
        import time

        now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    conds = obj.setdefault("status", {}).setdefault("conditions", [])
    for i, c in enumerate(conds):
        if c.get("type") == condition.get("type"):
            if (
                c.get("status") == condition.get("status")
                and c.get("reason") == condition.get("reason")
                and c.get("message") == condition.get("message")
            ):
                return
            if c.get("status") == condition.get("status"):
                condition.setdefault(
                    "lastTransitionTime", c.get("lastTransitionTime", now)
                )
            else:
                condition["lastTransitionTime"] = now
            conds[i] = condition
            return
    condition.setdefault("lastTransitionTime", now)
    conds.append(condition)


def parse_timestamp(ts) -> "float | None":
    """RFC3339 apiserver timestamp → epoch seconds, None if unparseable.

    The ONE home for this parse (culling idleness math, spawn-latency
    metrics, pre-pull retry backoff all consume apiserver timestamps);
    a format tolerance added here reaches every consumer."""
    import calendar
    import time

    try:
        return float(calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")))
    except (ValueError, TypeError, OverflowError):
        return None
