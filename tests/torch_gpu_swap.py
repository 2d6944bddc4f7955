"""The stated replacements between the JAX package's TPU outputs and the
port's GPU outputs, applied to a copy of a JAX object.

``swap`` is the GPU-node outputs' replacement (webhook and generators):

- the resource entry ``google.com/tpu: <chips a host>`` becomes
  ``nvidia.com/gpu: <cards a host>`` in limits and requests;
- the nodeSelector's two TPU keys become the GPU node label;
- the toleration's key ``google.com/tpu`` becomes ``nvidia.com/gpu``;
- the values of ``TPU_ACCELERATOR_TYPE``, ``TPU_TOPOLOGY``,
  ``TPU_CHIPS_PER_HOST_BOUNDS`` and ``TPU_HOST_BOUNDS`` become the GPU
  slice's, and so does the resolved-topology annotation, which is
  ``<TPU_ACCELERATOR_TYPE>/<TPU_TOPOLOGY>``.

``swap_cluster`` extends it to every object of a cluster the controller
loop drove:

- ``status.tpu`` becomes ``status.gpu``, its ``acceleratorType`` the GPU
  slice's; the condition ``TPUTopologyValid`` becomes ``GPUTopologyValid``
  and its message names the GPU slice's type;
- the event reason ``InvalidTPUTopology`` becomes ``InvalidGPUTopology``;
  the culler's "released N TPU chips" becomes "released M GPU cards";
  each Event named after its content is renamed after the swapped
  content, as ``EventRecorder`` names it;
- the nodes: ``add_tpu_node_pool``'s names, labels and ``google.com/tpu``
  allocatable become ``add_gpu_node_pool``'s, and each pod's
  ``spec.nodeName`` follows; the FakeKubelet's Unschedulable message says
  GPU where it says TPU;
- the catalog's error messages: each key of ``messages`` (a JAX refusal)
  becomes its value (the port's refusal of the same spec);
- a warm claim's event names the slice type in parentheses, JAX's and
  the port's;
- the slice-health reconciler's interruption event: "in-notebook JAX
  state is gone" becomes "in-notebook PyTorch state is gone" (``TEXTS``);
- the admission webhooks' texts: "spec.tpu" becomes "spec.gpu", and a
  reserved port's owner is the port's name for it ("the torch.distributed
  rendezvous", "the multislice coordinator") (``TEXTS``);
- the pre-pull pods: each is named ``prepull-<node>-<image-set digest>``,
  so its name follows its node's, as its ``spec.nodeName`` and its node
  annotation do; the pre-puller selects GPU nodes by the GPU node label,
  where JAX's selects TPU nodes by ``gke-tpu-accelerator``.

``swap_text`` applies ``TEXTS`` to one string, a webhook's denial, and
puts the port's ``GPUSpec`` repr where the JAX one's ``TPUSpec`` repr
stands (the validating webhook names the old and new spec).
"""

from __future__ import annotations

import copy
import hashlib

from kubeflow_tpu.api import annotations as JA

SWAPPED_ENV = ("TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY",
               "TPU_CHIPS_PER_HOST_BOUNDS", "TPU_HOST_BOUNDS")
# Texts inside a longer string: (JAX's, the port's).
TEXTS = (("in-notebook JAX state is gone",
          "in-notebook PyTorch state is gone"),
         ("spec.tpu", "spec.gpu"),
         ("the JAX distributed coordinator", "the torch.distributed rendezvous"),
         ("the multislice (megascale) coordinator",
          "the multislice coordinator"))


def swap(tree, jtopo, ptopo):
    """The GPU-node outputs' replacement, applied to a copy of a JAX
    output."""
    values = {
        "TPU_ACCELERATOR_TYPE": ptopo.accelerator_type,
        "TPU_TOPOLOGY": ptopo.topology_str,
        "TPU_CHIPS_PER_HOST_BOUNDS": ptopo.chip_bounds_str(),
        "TPU_HOST_BOUNDS": ptopo.host_bounds_str(),
    }
    resolved = (f"{jtopo.accelerator_type}/{jtopo.topology_str}",
                f"{ptopo.accelerator_type}/{ptopo.topology_str}")

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        if not isinstance(node, dict):
            return node
        out = {}
        for key, value in node.items():
            if key in ("limits", "requests") and "google.com/tpu" in value:
                assert value["google.com/tpu"] == str(jtopo.chips_per_host)
                value = {k: v for k, v in value.items()
                         if k != "google.com/tpu"}
                value["nvidia.com/gpu"] = str(ptopo.chips_per_host)
            elif key == "nodeSelector":
                value = {k: v for k, v in value.items()
                         if k not in jtopo.node_selector()}
                value.update(ptopo.node_selector())
            elif key == JA.TPU_RESOLVED_TOPOLOGY:
                assert value == resolved[0]
                value = resolved[1]
            out[key] = walk(value)
        if out.get("key") == "google.com/tpu" and "operator" in out:
            out["key"] = "nvidia.com/gpu"
        if out.get("name") in values and "value" in out:
            out["value"] = values[out["name"]]
        return out

    return walk(copy.deepcopy(tree))


def swap_text(text: str, jspec=None, pspec=None) -> str:
    """A JAX text with ``TEXTS`` replaced, and ``repr(jspec)`` (a
    ``TPUSpec``) replaced by ``repr(pspec)`` (a ``GPUSpec``)."""
    if jspec is not None:
        text = text.replace(repr(jspec), repr(pspec))
    for old, new in TEXTS:
        text = text.replace(old, new)
    return text


def event_name(event: dict) -> str:
    """The name ``EventRecorder`` gives an Event of this content."""
    inv = event.get("involvedObject", {})
    digest = hashlib.sha1(
        f"{inv.get('kind')}/{inv.get('name')}/{event.get('reason')}/"
        f"{event.get('message')}".encode()).hexdigest()[:10]
    return f"{inv.get('name')}.{digest}"


def swap_cluster(objects: dict, jtopo, ptopo, nodes: dict = None,
                 messages: dict = None) -> dict:
    """{(kind, namespace, name): object} of a JAX cluster → the port's
    objects, by ``swap`` and the loop's replacements. ``nodes`` maps JAX
    node names to the port's; ``jtopo``/``ptopo`` may be None for a
    cluster without a slice (then only the node, message and event rules
    apply)."""
    nodes = nodes or {}
    messages = dict(messages or {})
    if jtopo is not None:
        messages[f"{jtopo.accelerator_type} ({jtopo.hosts} hosts)"] = (
            f"{ptopo.accelerator_type} ({ptopo.hosts} hosts)")
    replace = {"TPUTopologyValid": "GPUTopologyValid",
               "InvalidTPUTopology": "InvalidGPUTopology",
               "0/N nodes match TPU nodeSelector/allocatable":
                   "0/N nodes match GPU nodeSelector/allocatable"}

    def text(value: str) -> str:
        for old, new in TEXTS:
            value = value.replace(old, new)
        if jtopo is not None:
            value = value.replace(f"({jtopo.accelerator_type})",
                                  f"({ptopo.accelerator_type})")
        if value in messages:
            return messages[value]
        if value in replace:
            return replace[value]
        if "released" in value and "TPU chips" in value:
            head, tail = value.rsplit("released ", 1)
            chips = int(tail.split()[0])
            cards = chips // jtopo.chips * ptopo.chips
            return f"{head}released {cards} GPU cards"
        return nodes.get(value, value)

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        if isinstance(node, str):
            return text(node)
        if not isinstance(node, dict):
            return node
        out = {}
        for key, value in node.items():
            if key == "tpu" and isinstance(value, dict) and (
                    "sliceHealth" in value):
                key = "gpu"
                value = dict(value, acceleratorType=ptopo.accelerator_type)
            out[key] = walk(value)
        return out

    result = {}
    for (kind, ns, name), obj in objects.items():
        was_named = kind == "Event" and name == event_name(obj)
        new = swap(obj, jtopo, ptopo) if jtopo is not None else copy.deepcopy(
            obj)
        new = walk(new)
        if kind == "Node":
            labels = new["metadata"]["labels"]
            if jtopo is not None and all(
                    obj["metadata"]["labels"].get(k) == v
                    for k, v in jtopo.node_selector().items()):
                for k in jtopo.node_selector():
                    del labels[k]
                labels.update(ptopo.node_selector())
            alloc = new["status"]["allocatable"]
            if "google.com/tpu" in alloc:
                assert alloc.pop("google.com/tpu") == str(jtopo.chips_per_host)
                alloc["nvidia.com/gpu"] = str(ptopo.chips_per_host)
        if was_named:
            new["metadata"]["name"] = event_name(new)
        if kind == "Pod" and JA.PREPULL_LABEL in new["metadata"].get(
                "labels", {}):
            old = obj["spec"]["nodeName"]
            new["metadata"]["name"] = new["metadata"]["name"].replace(
                f"prepull-{old}-", f"prepull-{nodes[old]}-")
        result[(kind, ns, new["metadata"]["name"])] = new
    return result
