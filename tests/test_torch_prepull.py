"""The port's image pre-puller against the JAX package's, on the CPU.

Each scenario of ``tests/test_prepull.py`` but the manager gate (which
builds ``cmd/``'s manager, ROADMAP item 20 (b)) runs on a JAX cluster and
on the port's (``tests/torch_controller_env.py``: four ``v5e`` 4x4 hosts
against four ``h100`` 32 hosts and a CPU node each), with the
``notebook-prepull-images`` ConfigMap, a ``PrePullReconciler`` and a
``FakePodRunner`` added as ``tests/test_prepull.py`` adds them. After
every step every object, every Event and the two metrics expositions are
equal after ``tests/torch_gpu_swap.swap_cluster``: the pre-pull pods sit
on the GPU nodes (``cloud.google.com/gke-accelerator``) where JAX's sit
on the TPU nodes, and each pod's name follows its node's. At the end the
JAX test's own assertions hold on both sides:

- one Succeeded pod per accelerator node, none on the CPU node, each
  pulling the set through the busybox recipe and requesting no card or
  chip, and ``tpu_prepull_nodes_covered == tpu_prepull_nodes_target``;
- a live GPU notebook's image joins the set (a TPU one's on JAX's side);
- a changed set rolls every pod, and an empty set removes them;
- a Failed pull is kept through its backoff, then retried;
- a disabled reconciler garbage-collects the pods.
"""

from __future__ import annotations

import dataclasses

import pytest

from kubeflow_tpu.controller import prepull as JPp
from kubeflow_tpu_torch.controller import prepull as PPp
from kubeflow_tpu_torch.controller import slicepool as PS
from tests.test_torch_controller_loop import (  # noqa: F401 (autouse)
    _fixed_condition_clock,
)
from tests.torch_controller_env import lockstep, make_side, notebook

NS = "kubeflow"
NODE_LABELS = {True: "cloud.google.com/gke-tpu-accelerator",
               False: "cloud.google.com/gke-accelerator"}


def _side(jax, images=("workbench:v1",), fail_images=()):
    m = make_side(jax)
    if images:
        m.c.create({
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "notebook-prepull-images", "namespace": NS},
            "data": {f"img{i}": img for i, img in enumerate(images)},
        })
    m.pre = m.Pp.PrePullReconciler(
        m.c, config=m.Pp.PrePullConfig(namespace=NS), metrics=m.metrics,
        clock=m.clock)
    m.pre.register(m.mgr)
    m.X.FakePodRunner(m.c, fail_images=frozenset(fail_images)).register(
        m.mgr)
    return m


def _pods(m):
    return [p for p in m.c.list("Pod", NS)
            if m.Pp.PREPULL_LABEL in (p["metadata"].get("labels") or {})]


def _gauge(m, name):
    return m.metrics.registry.get_sample_value(name)


# -- the scenarios ---------------------------------------------------------------


def one_per_node(m):
    m.mgr.run_until_idle()
    yield "covered"


def check_one_per_node(m):
    pods = _pods(m)
    assert len(pods) == 4
    nodes = {n["metadata"]["name"] for n in m.c.list("Node")
             if NODE_LABELS[m.jax] in (n["metadata"].get("labels") or {})}
    assert len(nodes) == 4
    assert {p["spec"]["nodeName"] for p in pods} == nodes
    for p in pods:
        assert p["status"]["phase"] == "Succeeded"
        pulled = [c["image"] for c in p["spec"]["initContainers"]
                  if c["name"].startswith("pull-")]
        assert pulled == ["workbench:v1", "workbench:v2"]
        assert p["spec"]["initContainers"][0]["name"] == "copy-busybox"
        assert p["spec"]["priorityClassName"] == PS.PLACEHOLDER_PRIORITY_CLASS
        for c in p["spec"]["containers"] + p["spec"]["initContainers"]:
            limits = c.get("resources", {}).get("limits", {})
            assert not {"google.com/tpu", "nvidia.com/gpu"} & set(limits)
    assert _gauge(m, "tpu_prepull_nodes_covered") == 4
    assert _gauge(m, "tpu_prepull_nodes_target") == 4


def notebook_image(m):
    m.mgr.run_until_idle()
    yield "covered"
    m.c.create(notebook(m, name="nb1", image="notebook:latest"))
    m.mgr.run_until_idle()
    yield "notebook"


def check_notebook_image(m):
    pods = _pods(m)
    assert pods
    for p in pods:
        pulled = {c["image"] for c in p["spec"]["initContainers"]
                  if c["name"].startswith("pull-")}
        assert pulled == {"workbench:v1", "notebook:latest"}
        assert p["status"]["phase"] == "Succeeded"


def set_change(m):
    m.mgr.run_until_idle()
    m.old = {p["metadata"]["name"] for p in _pods(m)}
    yield "covered"
    cm = m.c.get("ConfigMap", "notebook-prepull-images", NS)
    cm["data"]["img0"] = "workbench:v2"
    m.c.update(cm)
    m.mgr.run_until_idle()
    yield "rolled"


def check_set_change(m):
    new = {p["metadata"]["name"] for p in _pods(m)}
    assert new and not (new & m.old)
    digest = m.Pp.image_set_digest(["workbench:v2"])
    assert all(name.endswith(digest) for name in new)


def empty_set(m):
    m.mgr.run_until_idle()
    assert _pods(m)
    yield "covered"
    m.c.delete("ConfigMap", "notebook-prepull-images", NS)
    m.mgr.run_until_idle()
    yield "emptied"


def check_empty_set(m):
    assert _pods(m) == []


def failed_pull(m):
    m.mgr.run_until_idle()
    pods = _pods(m)
    assert pods and all(p["status"]["phase"] == "Failed" for p in pods)
    m.first = {p["metadata"]["name"] for p in pods}
    yield "failed"
    m.mgr.run_until_idle()
    assert {p["metadata"]["name"] for p in _pods(m)} == m.first
    assert _gauge(m, "tpu_prepull_nodes_covered") == 0
    yield "kept"
    m.clock.advance(m.Pp.RETRY_FAILED_AFTER + 1)
    m.mgr.tick(0)
    m.mgr.run_until_idle()
    yield "retried"


def check_failed_pull(m):
    again = _pods(m)
    assert again and all(p["status"]["phase"] == "Failed" for p in again)


def disabled(m):
    m.mgr.run_until_idle()
    assert _pods(m)
    yield "covered"
    pre = m.Pp.PrePullReconciler(m.c, config=m.Pp.PrePullConfig(namespace=NS),
                                 clock=m.clock, enabled=False)
    pre.reconcile(m.M.Request("notebook-prepull-images", NS))
    yield "swept"


def check_disabled(m):
    assert _pods(m) == []


# name: (scenario, check, side keywords)
SCENARIOS = {
    "one-pod-per-gpu-node": (one_per_node, check_one_per_node,
                             {"images": ("workbench:v1", "workbench:v2")}),
    "notebook-image-joins-set": (notebook_image, check_notebook_image, {}),
    "set-change-rolls-pods": (set_change, check_set_change, {}),
    "empty-set-removes-pods": (empty_set, check_empty_set, {}),
    "failed-pull-backs-off": (failed_pull, check_failed_pull,
                              {"images": ("broken:ref",),
                               "fail_images": ("broken:ref",)}),
    "disabled-gate-collects-pods": (disabled, check_disabled, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_prepull_equals_jax_step_by_step(name):
    scenario, check, kw = SCENARIOS[name]
    lockstep(_side(True, **kw), _side(False, **kw), scenario, check,
             what=name)


def test_pod_generator_and_config_equal_jax():
    """The pod, its name and the digest of one set equal JAX's but for the
    node, and the config reads the env as JAX's does."""
    images = ["a:1", "b:2"]
    digest = PPp.image_set_digest(images)
    assert digest == JPp.image_set_digest(images)
    for node in ("n0", "a-node-name-long-enough-to-take-the-hashed-fallback0"):
        assert PPp.prepull_pod_name(node, digest) == JPp.prepull_pod_name(
            node, digest)
        got = PPp.generate_prepull_pod(PPp.PrePullConfig(), node, images,
                                       digest)
        want = JPp.generate_prepull_pod(JPp.PrePullConfig(), node, images,
                                        digest)
        assert got == want
    for env in ({}, {"K8S_NAMESPACE": "x", "IMAGE_PREPULL_CONFIGMAP": "y"}):
        assert dataclasses.asdict(PPp.PrePullConfig.from_env(env)) == (
            dataclasses.asdict(JPp.PrePullConfig.from_env(env)))
    assert PPp.GPU_NODE_LABEL == "cloud.google.com/gke-accelerator"
    assert PPp.PREPULL_LABEL == JPp.PREPULL_LABEL
    assert PPp.RETRY_FAILED_AFTER == JPp.RETRY_FAILED_AFTER
