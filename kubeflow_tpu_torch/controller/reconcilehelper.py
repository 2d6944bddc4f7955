"""Create-or-update helpers with field-copy diffing.

The port's own copy of ``kubeflow_tpu/controller/reconcilehelper.py``
(reference components/common/reconcilehelper/util.go:18-219), with its
one fix over the reference: the StatefulSet's pod template takes part in
the diff, so a template change alone rolls out.
"""

from __future__ import annotations

import copy
from typing import Callable

from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict
from kubeflow_tpu_torch.k8s.errors import NotFoundError
from kubeflow_tpu_torch.k8s import objects as obj_util


def copy_statefulset_fields(desired: dict, existing: dict) -> bool:
    """Copy reconcile-relevant STS fields onto ``existing``; True if changed."""
    changed = _copy_meta(desired, existing)
    for field in ("replicas", "template", "podManagementPolicy", "serviceName"):
        want = desired.get("spec", {}).get(field)
        have = existing.get("spec", {}).get(field)
        if want != have:
            existing.setdefault("spec", {})[field] = copy.deepcopy(want)
            changed = True
    return changed


def copy_service_fields(desired: dict, existing: dict) -> bool:
    """Copy Service fields, deliberately preserving the allocated ClusterIP
    (reference util.go:166-195)."""
    changed = _copy_meta(desired, existing)
    want_spec = copy.deepcopy(desired.get("spec", {}))
    have_spec = existing.get("spec", {})
    # ClusterIP is allocated by the API server; never copy it.
    want_spec.pop("clusterIP", None)
    comparable_have = {k: v for k, v in have_spec.items() if k != "clusterIP"}
    if want_spec != comparable_have:
        preserved = have_spec.get("clusterIP")
        existing["spec"] = want_spec
        if preserved is not None:
            existing["spec"]["clusterIP"] = preserved
        changed = True
    return changed


def copy_virtual_service_fields(desired: dict, existing: dict) -> bool:
    """Istio VirtualService: meta + whole-spec copy (reference
    CopyVirtualService, util.go:199-219 — nested-map spec compare, update
    when drifted)."""
    changed = _copy_meta(desired, existing)
    want = desired.get("spec")
    if want is not None and existing.get("spec") != want:
        existing["spec"] = copy.deepcopy(want)
        changed = True
    return changed


def copy_generic_fields(desired: dict, existing: dict) -> bool:
    """Labels/annotations + every non-meta top-level field (ConfigMap data,
    NetworkPolicy/HTTPRoute/RoleBinding specs, ...)."""
    changed = _copy_meta(desired, existing)
    for key, value in desired.items():
        if key in ("apiVersion", "kind", "metadata", "status"):
            continue
        if existing.get(key) != value:
            existing[key] = copy.deepcopy(value)
            changed = True
    return changed


def _copy_meta(desired: dict, existing: dict) -> bool:
    changed = False
    for field in ("labels", "annotations"):
        want = desired.get("metadata", {}).get(field)
        if want is not None and existing.get("metadata", {}).get(field) != want:
            existing.setdefault("metadata", {})[field] = copy.deepcopy(want)
            changed = True
    return changed


def reconcile_child(
    client: Client,
    owner: dict,
    desired: dict,
    copy_fields: Callable[[dict, dict], bool] = copy_generic_fields,
    set_owner: bool = True,
) -> dict:
    """Level-triggered create-or-update of one owned child object."""
    if set_owner:
        obj_util.set_controller_reference(owner, desired)
    kind = desired.get("kind", "")
    name = obj_util.name_of(desired)
    namespace = obj_util.namespace_of(desired)
    def write():
        try:
            existing = client.get(kind, name, namespace)
        except NotFoundError:
            return client.create(desired)
        if copy_fields(desired, existing):
            return client.update(existing)
        return existing

    # The conflicting writer is usually a status update racing the spec
    # copy; re-running the whole read-modify-write re-diffs against the
    # fresh object, so the retry cannot clobber the other writer.
    return retry_on_conflict(write)
