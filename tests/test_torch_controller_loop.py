"""The port's controller loop against the JAX package's, on the CPU.

``test_torch_gpu_outputs.py``'s ``CASES`` (one host, four hosts,
multislice, stopped, long name), each Notebook mutated as that file
mutates it (JAX's webhook steps on the ``spec.tpu`` copy,
``mutate_gpu_notebook`` on the ``spec.gpu`` one), are created in a JAX ``FakeCluster`` and in the
port's, each with a node pool of its device (``add_tpu_node_pool`` and
``add_gpu_node_pool``), a ``FakeKubelet`` and a ``NotebookReconciler``
under one ``Manager`` on its own ``FakeClock``. The same script runs on
both; after each step's ``run_until_idle``:

- create (pods Pending, the slice "Forming"), pods Ready ("Healthy",
  ``tpu_slice_ready_seconds`` observed once), the restart annotation
  (every host's pod deleted and recreated), a pod Warning event
  re-emitted onto the Notebook (a Normal one and another pod's not),
  stop (replicas 0), a slice added while stopped and the resume, the
  slice taken away again (the stale StatefulSet pruned), and an invalid
  topology (condition False and a Warning event);
- every object in the two clusters (Notebook, StatefulSets, Services,
  pods, nodes and Events, with their uids, resourceVersions and
  timestamps) is equal after ``tests/torch_gpu_swap.swap_cluster``, the
  GPU-node outputs' replacement extended by the loop's (``status.gpu``,
  ``GPUTopologyValid``, ``InvalidGPUTopology``, the node pool, the
  catalog's refusal text);
- the two metrics expositions are equal, ``tpu_chips_in_use`` counting
  the port's cards where JAX's counts chips.

A second test runs the same script and shows that the raw objects differ
only where the replacement says. A third holds the Istio VirtualService
and ``ControllerConfig.from_env`` to JAX's, and a fourth the cursor tokens
and watch map functions.
"""

from __future__ import annotations

import copy
import time
import types

import pytest

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.api.notebook import Notebook as JNotebook
from kubeflow_tpu.controller import notebook as JC
from kubeflow_tpu.k8s import fake as JF
from kubeflow_tpu.k8s import fixtures as JX
from kubeflow_tpu.k8s import manager as JM
from kubeflow_tpu.metrics import metrics as JMm
from kubeflow_tpu.tpu import topology as JT
from kubeflow_tpu_torch.api import annotations as PA
from kubeflow_tpu_torch.api.notebook import Notebook as PNotebook
from kubeflow_tpu_torch.controller import notebook as PC
from kubeflow_tpu_torch.gpu import topology as PT
from kubeflow_tpu_torch.k8s import fake as PF
from kubeflow_tpu_torch.k8s import fixtures as PX
from kubeflow_tpu_torch.k8s import manager as PM
from kubeflow_tpu_torch.metrics import metrics as PMm
from kubeflow_tpu_torch.webhook import gpu_env as PW
from tests.test_torch_gpu_outputs import CASE_IDS, CASES, _jax_mutate, _objects
from tests.test_torch_metrics import _lines
from tests.torch_gpu_swap import SWAPPED_ENV, event_name, swap_cluster

FIXED_NOW = 1_800_000_000.0
# An invalid shape on each side: neither tiles its hosts.
INVALID = {"tpu": "3x4", "gpu": "12"}


@pytest.fixture(autouse=True)
def _fixed_condition_clock(monkeypatch):
    """``objects.set_condition`` stamps ``lastTransitionTime`` from the
    wall clock (``time.gmtime()`` with no argument) on both sides; pin it
    so the two clusters can be compared."""
    real = time.gmtime
    monkeypatch.setattr(time, "gmtime", lambda secs=None: real(
        FIXED_NOW if secs is None else secs))


def _spot(obj: dict, key: str) -> bool:
    return bool(obj["spec"][key].get("spot"))


def _side(jax: bool, obj: dict, hosts: int, topo):
    m = types.SimpleNamespace(jax=jax, key="tpu" if jax else "gpu")
    mods = (JF, JM, JX, JMm, JC) if jax else (PF, PM, PX, PMm, PC)
    F, M, X, Mm, C = mods
    m.clock = M.FakeClock()
    m.c = F.FakeCluster(clock=m.clock)
    m.mgr = M.Manager(m.c, clock=m.clock)
    m.kubelet = X.FakeKubelet(m.c, auto_ready=False)
    m.kubelet.register(m.mgr)
    if jax:
        X.add_tpu_node_pool(m.c, topo.gke_accelerator_label,
                            topo.topology_str, hosts=hosts,
                            chips_per_host=topo.chips_per_host)
    else:
        X.add_gpu_node_pool(m.c, topo.gke_accelerator_label,
                            topo.topology_str, hosts=hosts,
                            cards_per_host=topo.chips_per_host)
    if _spot(obj, m.key):
        for node in m.c.list("Node"):
            m.c.patch("Node", node["metadata"]["name"], "", {"metadata": {
                "labels": {"cloud.google.com/gke-spot": "true"}}})
    m.metrics = Mm.Metrics(m.c)
    C.NotebookReconciler(m.c, metrics=m.metrics, clock=m.clock).register(
        m.mgr)
    m.obj = obj
    m.name, m.ns = obj["metadata"]["name"], obj["metadata"]["namespace"]
    return m


def _world(case):
    jobj, pobj = _objects(case)
    _jax_mutate(jobj)
    PW.mutate_gpu_notebook(pobj)
    jtopo = JNotebook(jobj).tpu.slice_topology()
    ptopo = PNotebook(pobj).gpu.slice_topology()
    slices = case[4]
    # Room for one more slice than the notebook asks for.
    hosts = jtopo.hosts * (slices + 1)
    j = _side(True, jobj, hosts, jtopo)
    p = _side(False, pobj, hosts, ptopo)
    nodes = {f"tpu-node-{jtopo.topology_str}-{i}":
             f"gpu-node-{ptopo.topology_str}-{i}" for i in range(hosts)}
    return j, p, jtopo, ptopo, nodes


def _ready_all(m):
    for pod in m.c.list("Pod", m.ns):
        if pod["status"].get("phase") == "Pending" and pod["spec"].get(
                "nodeName"):
            pod["status"] = m.kubelet._running_status(pod)
            m.c.update_status(pod)


def _annotate(m, key, value):
    m.c.patch("Notebook", m.name, m.ns, {"metadata": {
        "annotations": {key: value}}})


def _spec(m, **fields):
    m.c.patch("Notebook", m.name, m.ns, {"spec": {m.key: fields}})


def _pod_event(m, pod, kind, reason, message):
    m.c.create({"apiVersion": "v1", "kind": "Event",
                "metadata": {"name": f"{pod}.{reason.lower()}",
                             "namespace": m.ns},
                "involvedObject": {"kind": "Pod", "name": pod,
                                   "namespace": m.ns},
                "type": kind, "reason": reason, "message": message})


def _step_create(m, case):
    m.c.create(copy.deepcopy(m.obj))


def _step_ready(m, case):
    _ready_all(m)


def _step_restart(m, case):
    _annotate(m, JA.RESTART, "true")
    m.mgr.run_until_idle()
    _ready_all(m)


def _step_event(m, case):
    sts0 = PC.slice_sts_name(m.name, 0)
    _pod_event(m, f"{sts0}-0", "Warning", "FailedMount",
               "MountVolume.SetUp failed")
    _pod_event(m, f"{sts0}-0", "Normal", "Pulled", "image pulled")
    _pod_event(m, "stranger-0", "Warning", "BackOff", "not ours")


def _step_stop(m, case):
    _annotate(m, JA.STOP, "2026-01-01T00:00:00Z")


def _step_grow(m, case):
    _spec(m, sliceCount=case[4] + 1)
    m.mgr.run_until_idle()
    _annotate(m, JA.STOP, None)
    m.mgr.run_until_idle()
    _ready_all(m)


def _step_shrink(m, case):
    _spec(m, sliceCount=case[4])


def _step_invalid(m, case):
    _spec(m, topology=INVALID[m.key])


STEPS = [("create", _step_create), ("ready", _step_ready),
         ("restart", _step_restart), ("event", _step_event),
         ("stop", _step_stop), ("grow", _step_grow),
         ("shrink", _step_shrink), ("invalid", _step_invalid)]


def _messages(jtopo, ptopo) -> dict:
    """The catalog's refusal of each side's invalid shape."""
    out = {}
    with pytest.raises(JT.InvalidTopologyError) as jerr:
        JT.slice_from_spec(jtopo.accelerator.name, INVALID["tpu"])
    with pytest.raises(PT.InvalidTopologyError) as perr:
        PT.slice_from_spec(ptopo.accelerator.name, INVALID["gpu"])
    out[str(jerr.value)] = str(perr.value)
    return out


def _strip(objects: dict) -> dict:
    """The objects without the Notebook's device block, which the test
    writes itself (``spec.tpu`` on one side, ``spec.gpu`` on the other)."""
    out = copy.deepcopy(objects)
    for (kind, _, _), obj in out.items():
        if kind == "Notebook":
            obj["spec"].pop("tpu", None)
            obj["spec"].pop("gpu", None)
    return out


def _samples(m, port: bool) -> dict:
    out = {}
    for line in _lines(m.metrics.expose().decode(), port):
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = value
    return out


def _run(case):
    """Both sides through STEPS: yields (step, jax side, port side, the
    two slices, the node map, the message map)."""
    j, p, jtopo, ptopo, nodes = _world(case)
    messages = _messages(jtopo, ptopo)
    for name, step in STEPS:
        for m in (j, p):
            m.clock.advance(7)
            step(m, case)
            m.mgr.run_until_idle()
            assert not m.mgr.reconcile_errors, m.mgr.reconcile_errors
        yield name, j, p, jtopo, ptopo, nodes, messages


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_cluster_state_equals_jax_after_each_step(case):
    seen = {}
    for name, j, p, jtopo, ptopo, nodes, messages in _run(case):
        want = swap_cluster(_strip(j.c._objects), jtopo, ptopo, nodes,
                            messages)
        got = _strip(p.c._objects)
        assert sorted(got) == sorted(want), name
        for key in want:
            assert got[key] == want[key], (name, key)
        assert (p.c._uid, len(p.c.events)) == (j.c._uid, len(j.c.events))
        jm, pm = _samples(j, False), _samples(p, True)
        chips = float(jm.pop("tpu_chips_in_use"))
        cards = float(pm.pop("tpu_chips_in_use"))
        assert cards == chips / jtopo.chips_per_host * ptopo.chips_per_host
        assert pm == jm, name
        nb = p.c.get("Notebook", p.name, p.ns)
        seen[name] = (nb.get("status", {}), pm, nb["metadata"].get(
            "annotations", {}), got)
    stopped = case[6]
    status = seen["ready"][0]
    assert status["gpu"]["sliceHealth"] == (
        "Stopped" if stopped else "Healthy")
    assert status["gpu"]["acceleratorType"] == ptopo.accelerator_type
    conds = {c["type"]: c for c in status["conditions"]}
    assert conds["GPUTopologyValid"]["status"] == "True"
    assert seen["ready"][1]["notebook_create_total"] == "1.0"
    assert seen["ready"][1]["tpu_slice_ready_seconds_count"] == (
        "0.0" if stopped else "1.0")
    assert seen["stop"][0]["gpu"]["sliceHealth"] == "Stopped"
    assert seen["stop"][0]["readyReplicas"] == 0
    events = [o for (k, _, _), o in seen["event"][3].items()
              if k == "Event" and o["involvedObject"]["kind"] == "Notebook"]
    reemitted = [e for e in events if e["reason"] == "FailedMount"]
    # A hashed StatefulSet name hides the notebook from
    # ``_event_to_notebook`` (it maps a pod event by the pod's name
    # prefix), so JAX, and the port with it, surfaces the event only at
    # the notebook's next reconcile.
    hashed = PC.slice_sts_name(case[1], 0) != case[1]
    assert len(reemitted) == (0 if hashed else 1)
    assert PA.LAST_SEEN_EVENT_RV in seen["event"][2]
    assert not [k for k in seen["shrink"][3]
                if k[0] == "StatefulSet" and k[2].endswith(
                    f"-s{case[4]}")]
    assert [k for k in seen["grow"][3] if k[0] == "StatefulSet"
            and k[2].endswith(f"-s{case[4]}")]
    bad = seen["invalid"][0]["conditions"]
    assert any(c["type"] == "GPUTopologyValid" and c["status"] == "False"
               for c in bad)
    assert any(o.get("reason") == "InvalidGPUTopology"
               for (k, _, _), o in seen["invalid"][3].items()
               if k == "Event")


def _diff(a, b, path=()):
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                out.append(path + (k,))
            else:
                out += _diff(a[k], b[k], path + (k,))
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out += _diff(x, y, path + (i,))
        return out
    return [] if a == b else [path]


def _explained(kind: str, path: tuple, jobj: dict) -> bool:
    """Whether one differing leaf is one the replacement names."""
    keys = [k for k in path if isinstance(k, str)]
    last = path[-1]
    if {"tpu", "gpu", "nodeSelector", "google.com/tpu",
            "nvidia.com/gpu", JA.TPU_RESOLVED_TOPOLOGY} & set(keys):
        return True
    if "tolerations" in keys and last == "key":
        return True
    if "env" in keys and last == "value":
        node = jobj
        for k in path[:-1]:
            node = node[k]
        return node["name"] in SWAPPED_ENV
    if "conditions" in keys and last in ("type", "message"):
        return True
    if kind == "Event" and path in (("reason",), ("message",),
                                    ("metadata", "name")):
        return True
    if kind == "Node" and keys[:2] in (["metadata", "name"],
                                       ["metadata", "labels"],
                                       ["status", "allocatable"]):
        return True
    if kind == "Pod" and (path == ("spec", "nodeName")
                          or keys[-1:] == ["message"]):
        return True
    return False


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_the_replacement_is_all_that_differs(case):
    differing = set()
    for name, j, p, jtopo, ptopo, nodes, messages in _run(case):
        for key, jobj in j.c._objects.items():
            (pkey,) = swap_cluster({key: jobj}, jtopo, ptopo, nodes,
                                   messages)
            pobj = p.c._objects[pkey]
            for path in _diff(jobj, pobj):
                assert _explained(key[0], path, jobj), (name, key, path)
                differing.add((key[0], path[0]))
    # The replacement is not empty: the raw objects do differ.
    assert ("StatefulSet", "spec") in differing
    assert ("Notebook", "status") in differing


def test_event_names_follow_the_recorder():
    """``swap_cluster``'s renaming is ``EventRecorder``'s naming."""
    from kubeflow_tpu_torch.k8s.events import EventRecorder

    c = PF.FakeCluster()
    owner = c.create({"apiVersion": "v1", "kind": "Notebook",
                      "metadata": {"name": "nb", "namespace": "ns"}})
    ev = EventRecorder(c).eventf(owner, "Warning", "InvalidGPUTopology", "m")
    assert ev["metadata"]["name"] == event_name(ev)


# -- the VirtualService, the config, tokens and map functions ------------------


@pytest.mark.parametrize("annotations", [
    {},
    {JA.REWRITE_URI: "/lab/"},
    {JA.HEADERS_REQUEST_SET: '{"X-A": "1", "n": 2}'},
    {JA.HEADERS_REQUEST_SET: "not json"},
    {JA.HEADERS_REQUEST_SET: "[1, 2]"},
], ids=["plain", "rewrite", "headers", "bad-json", "not-an-object"])
@pytest.mark.parametrize("name", ["nb", CASES[-1][1]], ids=["short", "long"])
def test_virtual_service_equals_jax(annotations, name):
    obj = {"metadata": {"name": name, "namespace": "user-ns",
                        "annotations": dict(annotations)}, "spec": {}}
    env = {"USE_ISTIO": "TRUE", "ISTIO_GATEWAY": "gw/ns",
           "CLUSTER_DOMAIN": "example.org"}
    jcfg, pcfg = JC.ControllerConfig.from_env(env), PC.ControllerConfig.from_env(
        env)
    assert vars(pcfg) == vars(jcfg)
    assert PC.generate_virtual_service(PNotebook(copy.deepcopy(obj)), pcfg) \
        == JC.generate_virtual_service(JNotebook(copy.deepcopy(obj)), jcfg)
    assert PC.virtual_service_name(name, "ns") == JC.virtual_service_name(
        name, "ns")


@pytest.mark.parametrize("env", [
    {}, {"ADD_FSGROUP": "False", "USE_ISTIO": "yes", "ISTIO_HOST": ""},
    {"USE_ISTIO": "true", "ISTIO_HOST": "nb.example.org"}])
def test_controller_config_from_env_equals_jax(env):
    assert vars(PC.ControllerConfig.from_env(env)) == vars(
        JC.ControllerConfig.from_env(env))


def test_the_istio_loop_renders_the_virtual_service_as_jax():
    out = []
    for C, F, M in ((JC, JF, JM), (PC, PF, PM)):
        c = F.FakeCluster(clock=M.FakeClock())
        mgr = M.Manager(c, clock=M.FakeClock())
        cfg = C.ControllerConfig(use_istio=True)
        C.NotebookReconciler(c, config=cfg, clock=mgr.clock).register(mgr)
        c.create({"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
                  "metadata": {"name": "nb", "namespace": "ns"},
                  "spec": {"template": {"spec": {"containers": [
                      {"name": "nb", "image": "img"}]}}}})
        mgr.run_until_idle()
        out.append(copy.deepcopy(c._objects))
    assert out[1] == out[0]
    assert ("VirtualService", "ns", "notebook-ns-nb") in out[1]


EVENTS = [
    {"metadata": {"resourceVersion": "42", "name": "a"}},
    {"metadata": {"resourceVersion": "7", "name": "b"}},
    {"metadata": {"resourceVersion": "opaque", "name": "c"},
     "lastTimestamp": "2026-01-01T00:00:05Z"},
    {"metadata": {"name": "d", "creationTimestamp": "2026-01-01T00:00:01Z"}},
    {"metadata": {"resourceVersion": None, "name": "e"}},
    {},
]


def test_cursor_tokens_equal_jax():
    for e in EVENTS:
        tok = PC._event_token(e)
        assert tok == JC._event_token(e)
        assert PC._token_regime(tok) == JC._token_regime(tok)
    for raw in ("", "12", "00012", ".2026/x", "!", "abc"):
        assert PC._cursor_token(raw) == JC._cursor_token(raw)
        assert PC._token_regime(raw) == JC._token_regime(raw)
    # Compared as strings across the regimes: '!' < '.' < digits.
    toks = sorted(PC._event_token(e) for e in EVENTS)
    assert toks == sorted(JC._event_token(e) for e in EVENTS)
    assert PC._CURSOR_FLOOR < toks[0] and toks[-1] == f"{42:020d}"
    assert PC._event_token(EVENTS[1]) < PC._event_token(EVENTS[0])


def _ev(kind, obj, name="x", ns="ns"):
    return JF.WatchEvent("ADDED", kind, ns, name, obj)


@pytest.mark.parametrize("obj", [
    {"metadata": {"labels": {"notebook-name": "nb"}}},
    {"metadata": {"labels": {}}},
    {"involvedObject": {"kind": "Pod", "name": "nb-3"}},
    {"involvedObject": {"kind": "Pod", "name": "nb-s1-0"}},
    {"involvedObject": {"kind": "Pod", "name": "nb-s-0"}},
    {"involvedObject": {"kind": "Pod", "name": "nb-x"}},
    {"involvedObject": {"kind": "Pod", "name": "-0"}},
    {"involvedObject": {"kind": "Notebook", "name": "nb-0"}},
    {"status": {"conditions": [{"type": "Ready", "status": "True"}]}},
    {"status": {"conditions": [{"type": "Ready", "status": "False"}]}},
])
def test_map_functions_and_pod_helpers_equal_jax(obj):
    for fn in ("_pod_to_notebook", "_event_to_notebook"):
        got = [repr(r) for r in getattr(PC, fn)(_ev("Pod", obj))]
        assert got == [repr(r) for r in getattr(JC, fn)(_ev("Pod", obj))]
    assert PC._pod_ready(obj) == JC._pod_ready(obj)
    existing = [{"type": "GPUTopologyValid", "status": "True"},
                {"type": "Ready", "status": "False", "reason": "old"}]
    pod = obj.get("status", {}).get("conditions", []) + [
        {"type": "Scheduled", "status": "True", "message": "m",
         "lastTransitionTime": "t", "reason": ""}]
    assert PC._merge_pod_conditions(existing, pod) == JC._merge_pod_conditions(
        existing, pod)
