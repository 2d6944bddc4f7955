"""The port's GPU-node outputs against the JAX package's TPU outputs.

One Notebook is rendered twice at equal host counts: with ``spec.tpu``
through the JAX package (``webhook/mutating.py``'s device steps in its
order, then ``controller/notebook.py``'s generators), and with
``spec.gpu`` through the port (``webhook/gpu_env.mutate_gpu_notebook``,
then ``controller/notebook.py``'s generators). The mutated Notebook (its
env list included), every StatefulSet, the routing Service and the
headless Service must be equal after one stated replacement, ``_swap``,
applied to the JAX side:

- the resource entry ``google.com/tpu: <chips a host>`` becomes
  ``nvidia.com/gpu: <cards a host>`` in limits and requests;
- the nodeSelector's two TPU keys become the GPU node label;
- the toleration's key ``google.com/tpu`` becomes ``nvidia.com/gpu``;
- the values of ``TPU_ACCELERATOR_TYPE``, ``TPU_TOPOLOGY``,
  ``TPU_CHIPS_PER_HOST_BOUNDS`` and ``TPU_HOST_BOUNDS`` become the GPU
  slice's, and so does the resolved-topology annotation, which is
  ``<TPU_ACCELERATOR_TYPE>/<TPU_TOPOLOGY>``.

Nothing else may differ. Also here: ``inject_gpu_env``'s idempotence and
its shrink to one host, the annotation projections against JAX's, the
catalog's counts and errors in JAX's wording, the spec's refusals and
schema, and ``runtime_from_env`` over each pod's rendered env against
JAX's over JAX's.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import re

import pytest

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.api import names as JN
from kubeflow_tpu.api.notebook import Notebook as JNotebook
from kubeflow_tpu.api.notebook import TPUSpec, new_notebook
from kubeflow_tpu.controller import notebook as JC
from kubeflow_tpu.deploy import manifests as JM
from kubeflow_tpu.tpu import topology as JT
from kubeflow_tpu.webhook import tpu_env as JE
from kubeflow_tpu.webhook.mutating import NotebookMutatingWebhook
from kubeflow_tpu_torch.api import annotations as PA
from kubeflow_tpu_torch.api import names as PN
from kubeflow_tpu_torch.api.notebook import GPUSpec, Notebook, gpu_spec_schema
from kubeflow_tpu_torch.controller import notebook as PC
from kubeflow_tpu_torch.gpu import topology as PT
from kubeflow_tpu_torch.runtime import env as PE
from kubeflow_tpu_torch.webhook import gpu_env as PW

JB = importlib.import_module("kubeflow_tpu.runtime.bootstrap")
PB = importlib.import_module("kubeflow_tpu_torch.runtime.bootstrap")

LONG_NAME = "a-notebook-name-of-sixty-characters-for-the-hashed-fallback0"
assert len(LONG_NAME) == 60

ANNOTATIONS = {
    JA.TPU_CHECKPOINT_GRACE: "120",
    JA.TPU_CHECKPOINT_DIR: "/mnt/ckpt",
    JA.TPU_QUANTIZATION: "int8",
    JA.TPU_SERVING_PORT: "9000",
    JA.TPU_PROFILING_PORT: "9012",
    JA.LAST_ACTIVITY: "2026-01-01T00:00:00Z",  # never copied to templates
    "team": "ml",
}

# (case, name, tpu (accelerator, topology), gpu (accelerator, topology),
#  slices, spot, stopped): equal host counts on both sides.
CASES = [
    ("one-host", "nb", ("v5e", "2x2"), ("h100", "4"), 1, False, False),
    ("four-hosts", "nb", ("v5e", "4x4"), ("h100", "32"), 1, True, False),
    ("multislice", "ms", ("v5e", "4x4"), ("h100-mega", "32"), 2, False,
     False),
    ("stopped", "nb", ("v5e", "4x4"), ("h100", "32"), 1, False, True),
    ("long-name", LONG_NAME, ("v5e", "4x4"), ("h100", "32"), 2, False,
     False),
]
CASE_IDS = [c[0] for c in CASES]


def _objects(case):
    _, name, (tacc, ttop), (gacc, gtop), slices, spot, stopped = case
    annotations = dict(ANNOTATIONS)
    if stopped:
        annotations[JA.STOP] = "2026-01-01T00:00:00Z"
    jobj = new_notebook(
        name, "user-ns",
        tpu=TPUSpec(tacc, ttop, spot=spot, slice_count=slices),
        annotations=annotations, labels={"app": "lab"})
    pobj = copy.deepcopy(jobj)
    del pobj["spec"]["tpu"]
    pobj["spec"]["gpu"] = {"accelerator": gacc, "topology": gtop,
                           "spot": spot, "sliceCount": slices}
    return jobj, pobj


def _jax_mutate(obj: dict) -> None:
    """The JAX webhook's device steps, in ``handle``'s order (the client
    is used only by the steps that do not depend on the device)."""
    nb = JNotebook(obj)
    wh = NotebookMutatingWebhook(client=None)
    wh._inject_tpu(nb)
    wh._handle_quant_env(nb)
    wh._handle_profiling_env(nb)
    wh._handle_serving_env(nb)
    wh._handle_checkpoint_env(nb)


def _render(case):
    """Both packages' outputs: {"notebook", "statefulsets", "service",
    "headless"} each, and the two slices."""
    jobj, pobj = _objects(case)
    _jax_mutate(jobj)
    PW.mutate_gpu_notebook(pobj)
    jnb, pnb = JNotebook(jobj), Notebook(pobj)
    jtopo, ptopo = jnb.tpu.slice_topology(), pnb.gpu.slice_topology()
    slices = jnb.tpu.slice_count
    jax = {
        "notebook": jobj,
        "statefulsets": [JC.generate_statefulset(
            jnb, jtopo, JC.ControllerConfig(), j, slices)
            for j in range(slices)],
        "service": JC.generate_service(jnb),
        "headless": JC.generate_headless_service(jnb, jtopo),
    }
    port = {
        "notebook": pobj,
        "statefulsets": [PC.generate_statefulset(
            pnb, ptopo, PC.ControllerConfig(), j, slices)
            for j in range(slices)],
        "service": PC.generate_service(pnb),
        "headless": PC.generate_headless_service(pnb, ptopo),
    }
    return jax, port, jtopo, ptopo


SWAPPED_ENV = ("TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY",
               "TPU_CHIPS_PER_HOST_BOUNDS", "TPU_HOST_BOUNDS")


def _swap(tree, jtopo, ptopo):
    """The stated replacement, applied to a copy of a JAX output."""
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


def _strip_spec(notebook: dict) -> dict:
    out = copy.deepcopy(notebook)
    out["spec"].pop("tpu", None)
    out["spec"].pop("gpu", None)
    return out


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_outputs_equal_jax_after_the_stated_replacement(case):
    jax, port, jtopo, ptopo = _render(case)
    assert ptopo.hosts == jtopo.hosts
    assert _strip_spec(port["notebook"]) == _swap(
        _strip_spec(jax["notebook"]), jtopo, ptopo)
    assert len(port["statefulsets"]) == len(jax["statefulsets"])
    for got, want in zip(port["statefulsets"], jax["statefulsets"]):
        assert got == _swap(want, jtopo, ptopo)
    assert port["service"] == _swap(jax["service"], jtopo, ptopo)
    assert port["headless"] == _swap(jax["headless"], jtopo, ptopo)


def _container(sts_or_nb: dict, name: str) -> dict:
    spec = sts_or_nb["spec"]["template"]
    spec = spec.get("spec", spec)
    return next(c for c in spec["containers"] if c["name"] == name)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_the_replacement_is_all_that_differs(case):
    """The raw outputs do differ, and only where ``_swap`` says: the
    same outputs with the swapped values put back are JAX's."""
    jax, port, jtopo, ptopo = _render(case)
    name = case[1]
    for got, want in zip(port["statefulsets"], jax["statefulsets"]):
        assert got != want
        gc, wc = _container(got, name), _container(want, name)
        assert {e["name"] for e in gc["env"]} == {e["name"] for e in wc["env"]}
        diff = {e["name"] for e in gc["env"]
                if e != next(w for w in wc["env"] if w["name"] == e["name"])}
        # The host bounds agree where both sides have one host.
        assert {"TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY"} <= diff <= set(
            SWAPPED_ENV)
        assert gc["resources"]["limits"] == {
            "nvidia.com/gpu": str(ptopo.chips_per_host)}
        pod = got["spec"]["template"]["spec"]
        assert [t["key"] for t in pod["tolerations"]] == ["nvidia.com/gpu"]
        assert pod["nodeSelector"]["cloud.google.com/gke-accelerator"] == (
            ptopo.accelerator.gke_label)
        assert not any("tpu" in k for k in pod["nodeSelector"])
    assert port["service"] == jax["service"]
    assert port["headless"] == jax["headless"]


def test_known_values_of_a_two_node_h100_pod():
    _, pobj = _objects(("", "nb", ("v5e", "4x4"), ("h100", "16"), 1, False,
                        False))
    PW.mutate_gpu_notebook(pobj)
    nb = Notebook(pobj)
    sts = PC.generate_statefulset(nb, nb.gpu.slice_topology(),
                                  PC.ControllerConfig())
    assert sts["spec"]["replicas"] == 2
    assert sts["spec"]["podManagementPolicy"] == "Parallel"
    env = PW.pod_env(_container(sts, "nb"), 1)
    assert env["TPU_WORKER_ID"] == "1"
    assert env["TPU_CHIPS_PER_HOST_BOUNDS"] == "8,1,1"
    assert env["TPU_HOST_BOUNDS"] == "2,1,1"
    assert env["TPU_ACCELERATOR_TYPE"] == "h100-80gb-16"
    assert env["JAX_NUM_PROCESSES"] == "2"
    assert env["JAX_COORDINATOR_ADDRESS"] == (
        "nb-0.nb-hosts.user-ns.svc.cluster.local:8476")
    assert env["TPU_CHECKPOINT_GRACE_S"] == "120"
    assert sts["spec"]["template"]["spec"][
        "terminationGracePeriodSeconds"] == 150
    assert "TPU_RUNTIME_VERSION" not in env


def test_pod_env_refuses_what_it_cannot_resolve():
    container = {"env": [{"name": "A", "value": "1"}, {
        "name": "B", "valueFrom": {"secretKeyRef": {"name": "s",
                                                    "key": "k"}}}]}
    with pytest.raises(ValueError, match="env B: cannot resolve"):
        PW.pod_env(container, 0)


# -- names -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["nb", LONG_NAME, "x" * 52, "x" * 53,
                                  "y" * 63, "z" * 70])
def test_names_equal_jax_byte_for_byte(name):
    assert PN.routing_service_name(name) == JN.routing_service_name(name)
    for suffix, limit in (("", 52), ("-s1", 52), ("-hosts", 63), ("", 63)):
        assert PN.derived_name(name, suffix, limit) == JN.derived_name(
            name, suffix, limit)
    assert PC.headless_service_name(name) == JC.headless_service_name(name)
    assert PC.slice_sts_names(name, 3) == JC.slice_sts_names(name, 3)
    assert (PN.NOTEBOOK_PORT, PN.JAX_COORDINATOR_PORT, PN.MEGASCALE_PORT) == (
        JN.NOTEBOOK_PORT, JN.JAX_COORDINATOR_PORT, JN.MEGASCALE_PORT)


def test_a_sixty_character_name_takes_the_hashed_fallback():
    sts = PC.slice_sts_name(LONG_NAME, 0)
    assert len(sts) == 52 and sts != LONG_NAME
    assert re.fullmatch(r"[a-z0-9-]+-[0-9a-f]{8}", sts)
    assert len(PC.headless_service_name(LONG_NAME)) == 63


ANNOTATION_NAMES = [
    "STOP", "RESTART", "UPDATE_PENDING", "LAST_ACTIVITY",
    "LAST_ACTIVITY_CHECK", "TPU_SLICE_INTERRUPTED", "TPU_RECOVERY_STARTED",
    "TPU_RECOVERY_ESCALATIONS", "TPU_RECOVERY_LAST_ESCALATION",
    "TPU_LAST_INTERRUPTION_DURATION", "TPU_RESOLVED_TOPOLOGY",
    "TPU_QUANTIZATION", "TPU_QUANTIZATION_VALUES", "QUANT_ENV_NAME",
    "TPU_PROFILING_PORT", "PROFILING_ENV_NAME", "TPU_SERVING_PORT",
    "SERVING_ENV_NAME", "TPU_CHECKPOINT_GRACE", "CHECKPOINT_GRACE_ENV_NAME",
    "TPU_CHECKPOINT_DIR", "CHECKPOINT_DIR_ENV_NAME", "DEFAULT_CHECKPOINT_DIR",
    "NOTEBOOK_NAME_LABEL"]
ENV_NAMES = ["TPU_CHIPS_PER_HOST_BOUNDS", "TPU_HOST_BOUNDS",
             "TPU_RUNTIME_VERSION", "MEGASCALE_COORDINATOR_ADDRESS"]


def test_keys_and_env_names_are_jaxs():
    for name in ANNOTATION_NAMES:
        assert getattr(PA, name) == getattr(JA, name), name
    for name in ENV_NAMES:
        assert getattr(PE, name) == getattr(JE, name), name
    assert PC._TEMPLATE_ANNOTATION_SKIP == JC._TEMPLATE_ANNOTATION_SKIP
    assert PW.POD_INDEX_LABEL == JE.POD_INDEX_LABEL
    # runtime/env.py holds the annotations module's objects, not copies.
    assert PE.parse_checkpoint_grace is PA.parse_checkpoint_grace
    assert PE.parse_profiling_port is PA.parse_profiling_port
    for grace in (None, 1, 120, 3600):
        assert PW.termination_grace_seconds(grace) == (
            JM.termination_grace_seconds(grace))


# -- inject_gpu_env ----------------------------------------------------------


def _env(container, name):
    return next((e for e in container.get("env", []) if e["name"] == name),
                None)


def test_inject_is_idempotent_and_a_shrink_drops_the_coordinator():
    jobj, pobj = _objects(("", "nb", ("v5e", "4x4"), ("h100", "32"), 1,
                           False, False))
    jnb, pnb = JNotebook(jobj), Notebook(pobj)
    jc, pc = jnb.primary_container(), pnb.primary_container()
    # A stale runtime version from an earlier render goes.
    pc.setdefault("env", []).append(
        {"name": "TPU_RUNTIME_VERSION", "value": "v2-alpha-tpuv5-lite"})
    assert PW.inject_gpu_env(pnb, pnb.gpu.slice_topology())
    assert JE.inject_tpu_env(jnb, jnb.tpu.slice_topology())
    assert _env(pc, "TPU_RUNTIME_VERSION") is None
    before = copy.deepcopy(pc)
    assert not PW.inject_gpu_env(pnb, pnb.gpu.slice_topology())
    assert pc == before
    assert _env(pc, "JAX_NUM_PROCESSES")["value"] == "4"
    assert _env(pc, "JAX_COORDINATOR_ADDRESS")["value"] == (
        "nb-0.nb-hosts.user-ns.svc.cluster.local:8476")

    # A topology edit to one host, on both sides.
    pobj["spec"]["gpu"]["topology"] = "4"
    jobj["spec"]["tpu"]["topology"] = "2x2"
    assert PW.inject_gpu_env(pnb, pnb.gpu.slice_topology())
    assert JE.inject_tpu_env(jnb, jnb.tpu.slice_topology())
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        assert _env(pc, name) is None and _env(jc, name) is None
    assert _env(pc, "TPU_WORKER_HOSTNAMES") == _env(jc, "TPU_WORKER_HOSTNAMES")
    assert _env(pc, "TPU_WORKER_HOSTNAMES")["value"].count(",") == 0
    assert [e["name"] for e in pc["env"]] == [e["name"] for e in jc["env"]]
    assert not PW.inject_gpu_env(pnb, pnb.gpu.slice_topology())


def test_no_container_is_no_change():
    obj = {"metadata": {"name": "nb", "namespace": "ns"},
           "spec": {"gpu": {"accelerator": "h100", "topology": "8"}}}
    nb = Notebook(obj)
    assert not PW.inject_gpu_env(nb, nb.gpu.slice_topology())


# -- the annotation projections ------------------------------------------------

PROJECTION_CASES = [
    {},
    {JA.TPU_QUANTIZATION: "int4"},
    {JA.TPU_QUANTIZATION: "bf16"},
    {JA.TPU_QUANTIZATION: "int2"},
    {JA.TPU_SERVING_PORT: "80", JA.TPU_PROFILING_PORT: "²"},
    {JA.TPU_SERVING_PORT: " 9000 ", JA.TPU_PROFILING_PORT: "65535"},
    {JA.TPU_CHECKPOINT_GRACE: "3601"},
    {JA.TPU_CHECKPOINT_GRACE: "1", JA.TPU_CHECKPOINT_DIR: "  "},
    {JA.TPU_CHECKPOINT_GRACE: "60", JA.TPU_CHECKPOINT_DIR: "/data"},
]


@pytest.mark.parametrize("annotations", PROJECTION_CASES, ids=repr)
@pytest.mark.parametrize("device", [True, False], ids=["slice", "cpu-nb"])
def test_projections_equal_jaxs(annotations, device):
    """A stale env entry of each projection, then the annotations: both
    webhooks leave the same env and grace period."""
    stale = [{"name": n, "value": "stale"} for n in (
        JA.QUANT_ENV_NAME, JA.PROFILING_ENV_NAME, JA.SERVING_ENV_NAME,
        JA.CHECKPOINT_GRACE_ENV_NAME)]
    jobj = new_notebook("nb", "ns", tpu=TPUSpec("v5e", "2x2") if device
                        else None, annotations=annotations,
                        container_overrides={"env": copy.deepcopy(stale)})
    pobj = copy.deepcopy(jobj)
    if device:
        del pobj["spec"]["tpu"]
        pobj["spec"]["gpu"] = {"accelerator": "h100", "topology": "4"}
    _jax_mutate(jobj)
    PW.mutate_gpu_notebook(pobj)
    jc, pc = JNotebook(jobj).primary_container(), Notebook(
        pobj).primary_container()
    keep = {JA.QUANT_ENV_NAME, JA.PROFILING_ENV_NAME, JA.SERVING_ENV_NAME,
            JA.CHECKPOINT_GRACE_ENV_NAME, JA.CHECKPOINT_DIR_ENV_NAME}
    assert [e for e in pc["env"] if e["name"] in keep] == [
        e for e in jc["env"] if e["name"] in keep]
    assert pobj["spec"]["template"]["spec"].get(
        "terminationGracePeriodSeconds") == jobj["spec"]["template"][
        "spec"].get("terminationGracePeriodSeconds")


# -- the catalog ---------------------------------------------------------------


@pytest.mark.parametrize("topology,hosts,cards,bounds", [
    ("1", 1, 1, ("1,1,1", "1,1,1")), ("2", 1, 2, ("2,1,1", "1,1,1")),
    ("4", 1, 4, ("4,1,1", "1,1,1")), ("8", 1, 8, ("8,1,1", "1,1,1")),
    ("16", 2, 8, ("8,1,1", "2,1,1")), ("64", 8, 8, ("8,1,1", "8,1,1")),
    (" 24 ", 3, 8, ("8,1,1", "3,1,1"))])
@pytest.mark.parametrize("accelerator", ["h100", "H100", "nvidia-h100-80gb",
                                         "h100-mega", "a3-megagpu"])
def test_valid_counts(accelerator, topology, hosts, cards, bounds):
    st = PT.slice_from_spec(accelerator, topology)
    assert (st.hosts, st.chips_per_host) == (hosts, cards)
    assert (st.chip_bounds_str(), st.host_bounds_str()) == bounds
    assert st.single_host == (hosts == 1)
    assert st.host_shape() == ((st.chips,) if hosts == 1 else (8,))
    assert st.host_bounds() == (hosts,)
    assert st.topology_str == topology.strip()
    assert st.node_selector() == {
        "cloud.google.com/gke-accelerator": st.accelerator.gke_label}
    assert st.accelerator.gke_label in ("nvidia-h100-80gb",
                                        "nvidia-h100-mega-80gb")
    assert st.accelerator.hbm_gib_per_chip == 80
    assert st.accelerator_type == f"{st.accelerator.type_prefix}-{st.chips}"
    assert st.worker_hostnames("nb", "nb-hosts", "ns") == [
        f"nb-{i}.nb-hosts.ns.svc.cluster.local" for i in range(hosts)]


def _message(fn, *args) -> str:
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value)


def test_refusals_follow_jaxs_wording():
    assert issubclass(PT.InvalidTopologyError, ValueError)
    # Unknown accelerator.
    got = _message(PT.slice_from_spec, "a100", "8")
    want = _message(JT.slice_from_spec, "a100", "2x2")
    assert got.split(";")[0] == want.split(";")[0].replace("TPU", "GPU")
    assert got.startswith("unknown GPU accelerator 'a100'; known: "
                          "['h100', 'h100-mega'] (aliases: ")
    # Malformed topology.
    for bad in ("", "x", "0", "-8", "8.0", "eight"):
        assert _message(PT.slice_from_spec, "h100", bad) == _message(
            JT.slice_from_spec, "v5e", bad)
    # Not one-dimensional.
    assert _message(PT.slice_from_spec, "h100", "2x4") == (
        _message(JT.slice_from_spec, "v5e", "2x2x2")
        .replace("v5e", "h100").replace("2-D", "1-D")
        .replace("'2x2x2'", "'2x4'"))
    # A count that does not fill whole hosts.
    for count in ("12", "20", "33"):
        assert _message(PT.slice_from_spec, "h100", count) == (
            _message(JT.slice_from_spec, "v4", "2x3x4")
            .replace("'2x3x4'", repr(count)).replace("v4", "h100")
            .replace("2x2x1", "8"))
    # Counts that one host does not take.
    for count in ("3", "5", "6", "7"):
        assert _message(PT.slice_from_spec, "h100-mega", count) == (
            f"topology {count!r} is not a h100-mega host shape (one host "
            "takes 1, 2, 4, 8 cards)")
    assert _message(GPUSpec("h100", "8", slice_count=0).slice_topology) == (
        _message(TPUSpec("v5e", "2x2", slice_count=0).slice_topology))


def test_the_spec_refuses_both_blocks_and_a_runtime_version():
    both = new_notebook("nb", "ns", tpu=TPUSpec("v5e", "2x2"))
    both["spec"]["gpu"] = {"accelerator": "h100", "topology": "4"}
    with pytest.raises(PT.InvalidTopologyError,
                       match=r"spec\.tpu and spec\.gpu are exclusive"):
        Notebook(both).gpu
    with pytest.raises(PT.InvalidTopologyError,
                       match=r"spec\.tpu and spec\.gpu"):
        PW.mutate_gpu_notebook(both)
    rv = new_notebook("nb", "ns")
    rv["spec"]["gpu"] = {"accelerator": "h100", "topology": "4",
                         "runtimeVersion": "v2-alpha-tpuv5-lite"}
    with pytest.raises(PT.InvalidTopologyError,
                       match=r"spec\.gpu\.runtimeVersion"):
        PW.mutate_gpu_notebook(rv)
    bad = new_notebook("nb", "ns")
    bad["spec"]["gpu"] = {"accelerator": "h100", "topology": "12"}
    with pytest.raises(PT.InvalidTopologyError, match="does not tile"):
        PW.mutate_gpu_notebook(bad)
    # A notebook with neither is a CPU notebook: projections only.
    cpu = new_notebook("nb", "ns", annotations={JA.TPU_QUANTIZATION: "fp8"})
    PW.mutate_gpu_notebook(cpu)
    nb = Notebook(cpu)
    assert nb.gpu is None
    assert [e["name"] for e in nb.primary_container()["env"]] == [
        "KUBEFLOW_TPU_QUANT"]
    sts = PC.generate_statefulset(nb, None, PC.ControllerConfig())
    assert sts["spec"]["replicas"] == 1 and sts["spec"]["serviceName"] == "nb"
    assert "podManagementPolicy" not in sts["spec"]


def test_gpu_schema_mirrors_the_tpu_schema():
    got, want = gpu_spec_schema(), JM._tpu_spec_schema()
    assert got["required"] == want["required"]
    # sliceCount as JAX's, its description without TPU's DCN and ICI.
    assert {k: v for k, v in got["properties"]["sliceCount"].items()
            if k != "description"} == {
        k: v for k, v in want["properties"]["sliceCount"].items()
        if k != "description"}
    assert got["properties"]["spot"] == want["properties"]["spot"]
    enum = got["properties"]["accelerator"]["enum"]
    assert set(PT.ACCELERATORS) <= set(enum)
    assert not set(enum) & set(want["properties"]["accelerator"]["enum"])
    pattern = re.compile(got["properties"]["topology"]["pattern"])
    for ok in ("1", "8", "16", "256"):
        assert pattern.match(ok)
        assert not re.match(want["properties"]["topology"]["pattern"], ok)
    for bad in ("0", "2x4", "", "08", "-8"):
        assert not pattern.match(bad)
    assert got["x-kubernetes-validations"] == [{
        "rule": "!has(self.runtimeVersion)",
        "message": "spec.gpu.runtimeVersion names a libtpu; GPU nodes take "
                   "none"}]
    assert GPUSpec.from_dict({"accelerator": "h100", "topology": "8",
                              "spot": True, "sliceCount": 2}) == GPUSpec(
        "h100", "8", spot=True, slice_count=2)
    assert GPUSpec.from_dict({}) == GPUSpec("", "")


# -- the runtime's view of each pod --------------------------------------------


def _jax_fields(rt) -> dict:
    names = [f.name for f in dataclasses.fields(JB.SliceRuntime)]
    out = {name: getattr(rt, name) for name in names}
    out.update(is_multi_host=rt.is_multi_host, process_id=rt.process_id,
               is_coordinator=rt.is_coordinator)
    return out


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_runtime_from_env_of_every_pod_equals_jaxs(case):
    jax, port, jtopo, ptopo = _render(case)
    name = case[1]
    for jsts, psts in zip(jax["statefulsets"], port["statefulsets"]):
        for index in range(jtopo.hosts):
            jenv = PW.pod_env(_container(jsts, name), index)
            penv = PW.pod_env(_container(psts, name), index)
            want = _jax_fields(JB.runtime_from_env(jenv))
            want.update(accelerator_type=ptopo.accelerator_type,
                        topology=ptopo.topology_str)
            rt = PB.runtime_from_env(penv)
            assert _jax_fields(rt) == want
            assert rt.cards_per_host == ptopo.chips_per_host
