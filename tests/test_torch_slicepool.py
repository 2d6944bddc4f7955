"""The port's warm SlicePool against the JAX package's, on the CPU.

A JAX cluster and the port's each run a ``FakeKubelet``, a
``SlicePoolReconciler`` and a ``NotebookReconciler`` under one
``Manager`` on its own ``FakeClock``, over node pools of two shapes
(``v5e`` 2x2 and 2x4 against ``h100`` 4 and 8: the same hosts and the
same chips a host as cards a host). The same script runs on both:

- a fixed pool of 2 warm slices is filled; a notebook of its shape claims
  one on creation (the placeholder fenced, then deleted) and the pool
  refills; the notebook is stopped (its claim marker cleared) and
  resumed (a second claim);
- two notebooks of the other shape: the first takes the one warm slice
  of that shape, the second misses, so every autoscaled pool of that
  shape gets ``last-miss`` and its ``miss-count`` bumped, and the pool
  grows by the misses, then decays to its minimum after
  ``scaleDownAfterSeconds`` with no demand;
- a pool with an invalid shape reports it; a deleted pool drops its
  gauge.

After each step every object is equal after the stated replacements
(``spec.gpu`` for ``spec.tpu``, ``nvidia.com/gpu`` for ``google.com/tpu``,
the GPU node label for the TPU ones, each shape's names, the event
reasons, ``status.gpu``), and so are the watch logs and the metrics. The
one value masked is the claim fence (``slicepools.kubeflow.org/claimed-
by``), a token from ``secrets`` on both sides.

``WarmSliceReplicaSource.acquire`` and ``stats`` are held to JAX's over
the same pools: hits, misses, the demand signals, a failing client, and
the deadline's refusal.
"""

from __future__ import annotations

import copy
import re
import types

import pytest

from kubeflow_tpu.api import slicepool as JSp
from kubeflow_tpu.api.notebook import TPUSpec
from kubeflow_tpu.controller import notebook as JC
from kubeflow_tpu.controller import slicepool as JS
from kubeflow_tpu.k8s import fake as JF
from kubeflow_tpu.k8s import fixtures as JX
from kubeflow_tpu.k8s import manager as JM
from kubeflow_tpu.metrics import metrics as JMm
from kubeflow_tpu.models import gateway as JG
from kubeflow_tpu.tpu import topology as JT
from kubeflow_tpu_torch.api import slicepool as PSp
from kubeflow_tpu_torch.api.notebook import GPUSpec
from kubeflow_tpu_torch.controller import notebook as PC
from kubeflow_tpu_torch.controller import slicepool as PS
from kubeflow_tpu_torch.gpu import topology as PT
from kubeflow_tpu_torch.k8s import fake as PF
from kubeflow_tpu_torch.k8s import fixtures as PX
from kubeflow_tpu_torch.k8s import manager as PM
from kubeflow_tpu_torch.metrics import metrics as PMm
from kubeflow_tpu_torch.models import gateway as PG
from tests.test_torch_controller_loop import (  # noqa: F401 (autouse)
    _fixed_condition_clock,
    _samples,
)
from tests.torch_gpu_swap import event_name

NS = "team"
# (JAX shape, port shape, hosts of nodes): one host each, equal per-host.
SHAPES = [(("v5e", "2x2"), ("h100", "4"), 6), (("v5e", "2x4"), ("h100", "8"),
                                               3)]
TOKEN = re.compile(r"^claim-[0-9a-f]{8}$")


def _side(jax: bool):
    m = types.SimpleNamespace(jax=jax)
    F, M, X, Mm, C, S = ((JF, JM, JX, JMm, JC, JS) if jax
                         else (PF, PM, PX, PMm, PC, PS))
    m.S, m.Sp = S, (JSp if jax else PSp)
    m.clock = M.FakeClock()
    m.c = F.FakeCluster(clock=m.clock)
    m.mgr = M.Manager(m.c, clock=m.clock)
    X.FakeKubelet(m.c).register(m.mgr)
    for (jshape, pshape, hosts) in SHAPES:
        if jax:
            t = JT.slice_from_spec(*jshape)
            X.add_tpu_node_pool(m.c, t.gke_accelerator_label, t.topology_str,
                                hosts=hosts, chips_per_host=t.chips_per_host)
        else:
            t = PT.slice_from_spec(*pshape)
            X.add_gpu_node_pool(m.c, t.gke_accelerator_label, t.topology_str,
                                hosts=hosts, cards_per_host=t.chips_per_host)
    m.metrics = Mm.Metrics(m.c)
    S.SlicePoolReconciler(m.c, metrics=m.metrics, clock=m.clock).register(
        m.mgr)
    C.NotebookReconciler(m.c, metrics=m.metrics, clock=m.clock).register(
        m.mgr)
    return m


def _spec(m, shape: int, **kw):
    jshape, pshape, _ = SHAPES[shape]
    return (TPUSpec(*jshape, **kw) if m.jax else GPUSpec(*pshape, **kw))


def _notebook(m, name, shape):
    key = "tpu" if m.jax else "gpu"
    return {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": NS},
            "spec": {"template": {"spec": {"containers": [
                {"name": name, "image": "img"}]}},
                key: _spec(m, shape).to_dict()}}


def _pool(m, name, shape, warm=1, autoscale=None, spec=None):
    obj = m.Sp.new_slicepool(name, NS, _spec(m, shape), warm_replicas=warm,
                             image="img:1")
    if autoscale:
        obj["spec"]["autoscale"] = autoscale
    if spec:
        obj["spec"]["tpu" if m.jax else "gpu"].update(spec)
    m.c.create(obj)


def _annotate(m, kind, name, key, value):
    m.c.patch(kind, name, NS, {"metadata": {"annotations": {key: value}}})


def _strings() -> dict:
    """Each JAX shape's names → the port's (exact string values)."""
    out = {"InvalidTPUTopology": "InvalidGPUTopology",
           "TPUTopologyValid": "GPUTopologyValid",
           "0/N nodes match TPU nodeSelector/allocatable":
               "0/N nodes match GPU nodeSelector/allocatable"}
    for jshape, pshape, hosts in SHAPES:
        jt, pt = JT.slice_from_spec(*jshape), PT.slice_from_spec(*pshape)
        out.update({jt.accelerator.name: pt.accelerator.name,
                    jt.topology_str: pt.topology_str,
                    jt.accelerator_type: pt.accelerator_type,
                    jt.gke_accelerator_label: pt.gke_accelerator_label,
                    f"{jt.accelerator_type} ({jt.hosts} hosts)":
                        f"{pt.accelerator_type} ({pt.hosts} hosts)"})
        for i in range(hosts):
            out[f"tpu-node-{jt.topology_str}-{i}"] = (
                f"gpu-node-{pt.topology_str}-{i}")
    return out


def _norm(tree, strings, fence=True):
    """A JAX object (or a port one with ``strings`` empty) with the stated
    replacements, and the claim fence's token masked."""
    def text(s):
        if s in strings:
            return strings[s]
        for old, new in strings.items():
            if f"({old})" in s:
                s = s.replace(f"({old})", f"({new})")
        return s

    def walk(node):
        if isinstance(node, list):
            return [walk(x) for x in node]
        if isinstance(node, str):
            return text(node)
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k in ("nodeSelector", "labels") and isinstance(v, dict):
                v = {("cloud.google.com/gke-accelerator"
                      if kk == "cloud.google.com/gke-tpu-accelerator" else kk):
                     vv for kk, vv in v.items()
                     if kk != "cloud.google.com/gke-tpu-topology"}
            if k == JSp.CLAIMED_BY and fence:
                assert TOKEN.match(v), v
                v = "<token>"
            k = {"google.com/tpu": "nvidia.com/gpu", "tpu": "gpu"}.get(k, k)
            out[k] = walk(v)
        if out.get("key") == "google.com/tpu":
            out["key"] = "nvidia.com/gpu"
        return out

    return walk(copy.deepcopy(tree))


def _objects(m, strings):
    out = {}
    for (kind, ns, name), obj in m.c._objects.items():
        new = _norm(obj, strings)
        if kind == "Event" and name == event_name(obj):
            new["metadata"]["name"] = event_name(new)
        out[(kind, ns, new["metadata"]["name"])] = new
    return out


def _log(m, strings):
    out = []
    for e in m.c.events:
        obj = _norm(e.object, strings)
        if e.kind == "Event" and e.name == event_name(e.object):
            obj["metadata"]["name"] = event_name(obj)
        out.append((e.type, e.kind, e.namespace, obj["metadata"]["name"], obj))
    return out


def _step_fixed_pool(m):
    _pool(m, "fixed", 0, warm=2)


def _step_claim(m):
    m.c.create(_notebook(m, "nb", 0))


def _step_stop(m):
    _annotate(m, "Notebook", "nb", "kubeflow-resource-stopped", "x")


def _step_resume(m):
    _annotate(m, "Notebook", "nb", "kubeflow-resource-stopped", None)


def _step_autoscaled(m):
    _pool(m, "auto", 1, warm=0, autoscale={"min": 0, "max": 2,
                                           "scaleDownAfterSeconds": 300})
    _pool(m, "auto-b", 1, warm=0, autoscale={"min": 1, "max": 1})
    _pool(m, "fixed-b", 1, warm=0)


def _step_miss(m):
    m.c.create(_notebook(m, "big", 1))
    m.c.create(_notebook(m, "big2", 1))


def _step_decay(m):
    for _ in range(8):
        m.mgr.tick(100)


def _step_invalid_and_delete(m):
    _pool(m, "broken", 0, spec={"topology": "3x4" if m.jax else "12"})
    m.mgr.run_until_idle()
    m.c.delete("SlicePool", "fixed-b", NS)
    m.c.delete("SlicePool", "broken", NS)


def _step_fixed_again(m):
    # Back to fixed sizing: autoscale state and demand annotations go.
    m.c.patch("SlicePool", "auto", NS, {"spec": {"autoscale": None,
                                                 "warmReplicas": 1}})


STEPS = [_step_fixed_pool, _step_claim, _step_stop, _step_resume,
         _step_autoscaled, _step_miss, _step_decay, _step_invalid_and_delete,
         _step_fixed_again]


def _run():
    j, p = _side(True), _side(False)
    strings = _strings()
    messages = {}
    for shape in ("3x4", "12"):
        try:
            (JT if shape == "3x4" else PT).slice_from_spec(
                "v5e" if shape == "3x4" else "h100", shape)
        except ValueError as err:
            messages[shape] = str(err)
    strings[messages["3x4"]] = messages["12"]
    strings["3x4"] = "12"
    for step in STEPS:
        for m in (j, p):
            m.clock.advance(11)
            step(m)
            m.mgr.run_until_idle()
            assert not m.mgr.reconcile_errors, m.mgr.reconcile_errors
        yield step.__name__, j, p, strings


def test_pools_claims_misses_and_refills_equal_jax():
    seen = {}
    for name, j, p, strings in _run():
        want, got = _objects(j, strings), _objects(p, {})
        assert sorted(got) == sorted(want), name
        for key in want:
            assert got[key] == want[key], (name, key)
        assert _log(p, {}) == _log(j, strings), name
        assert _samples(p, True) == _samples(j, False), name
        seen[name] = (copy.deepcopy(p.c._objects), _samples(p, True))
    objs, samples = seen["_step_claim"]
    nb = objs[("Notebook", NS, "nb")]
    assert nb["metadata"]["annotations"][PSp.CLAIMED_FROM] == "fixed"
    assert samples["tpu_slicepool_claims_total"] == "1.0"
    warm = [k for k in objs if k[0] == "StatefulSet" and "warm" in k[2]]
    assert [k[2] for k in sorted(warm)] == ["fixed-warm-1", "fixed-warm-2"]
    assert PSp.CLAIMED_FROM not in seen["_step_stop"][0][
        ("Notebook", NS, "nb")]["metadata"].get("annotations", {})
    assert seen["_step_resume"][1]["tpu_slicepool_claims_total"] == "2.0"
    objs, samples = seen["_step_miss"]
    auto = objs[("SlicePool", NS, "auto")]
    # "big" takes auto-b's warm slice (min 1); "big2" misses.
    assert objs[("Notebook", NS, "big")]["metadata"]["annotations"][
        PSp.CLAIMED_FROM] == "auto-b"
    assert auto["metadata"]["annotations"][PSp.MISS_COUNT] == "1"
    assert auto["status"]["autoscaleTarget"] == 1
    assert samples["tpu_slicepool_claim_misses_total"] == "1.0"
    assert samples["tpu_slicepool_claims_total"] == "3.0"
    assert PSp.MISS_COUNT not in objs[("SlicePool", NS, "fixed-b")][
        "metadata"].get("annotations", {})
    assert seen["_step_decay"][0][("SlicePool", NS, "auto")]["status"][
        "autoscaleTarget"] == 0
    broken = seen["_step_invalid_and_delete"]
    assert 'tpu_slicepool_warm_ready{pool="fixed-b"}' not in broken[1]
    auto = seen["_step_fixed_again"][0][("SlicePool", NS, "auto")]
    assert "autoscaleTarget" not in auto["status"]
    assert PSp.MISS_COUNT not in auto["metadata"].get("annotations", {})


def test_the_fence_token_is_the_only_masked_value():
    """Two claims' fences are distinct random tokens on both sides; with
    them masked nothing else is."""
    tokens = {}
    for name, j, p, strings in _run():
        pass
    for m in (j, p):
        for e in m.c.events:
            ann = e.object.get("metadata", {}).get("annotations", {})
            if JSp.CLAIMED_BY in ann:
                tokens.setdefault(m.jax, set()).add(ann[JSp.CLAIMED_BY])
    assert len(tokens[True]) == len(tokens[False]) == 3
    assert not tokens[True] & tokens[False]
    assert all(TOKEN.match(t) for t in tokens[True] | tokens[False])


def test_generate_warm_statefulset_equals_jax():
    for (jshape, pshape, _) in SHAPES:
        jpool = JSp.SlicePool(JSp.new_slicepool("p", NS, TPUSpec(*jshape)))
        ppool = PSp.SlicePool(PSp.new_slicepool("p", NS, GPUSpec(*pshape)))
        got = PS.generate_warm_statefulset(
            ppool, ppool.gpu.slice_topology(), 7)
        want = JS.generate_warm_statefulset(
            jpool, jpool.tpu.slice_topology(), 7)
        assert got == _norm(want, _strings())
        assert PS.warm_sts_name("x" * 60, 3) == JS.warm_sts_name("x" * 60, 3)
    assert (PSp.POOL_LABEL, PSp.STATE_LABEL, PSp.ACCELERATOR_LABEL,
            PSp.TOPOLOGY_LABEL, PSp.CLAIMED_FROM, PSp.CLAIMED_BY,
            PSp.LAST_CLAIM, PSp.LAST_MISS, PSp.MISS_COUNT) == (
        JSp.POOL_LABEL, JSp.STATE_LABEL, JSp.ACCELERATOR_LABEL,
        JSp.TOPOLOGY_LABEL, JSp.CLAIMED_FROM, JSp.CLAIMED_BY,
        JSp.LAST_CLAIM, JSp.LAST_MISS, JSp.MISS_COUNT)
    assert PS.PLACEHOLDER_PRIORITY_CLASS == JS.PLACEHOLDER_PRIORITY_CLASS
    pool = PSp.SlicePool({"spec": {"autoscale": {"min": 3, "max": 1}}})
    assert pool.autoscale == JSp.SlicePool(
        {"spec": {"autoscale": {"min": 3, "max": 1}}}).autoscale


# -- WarmSliceReplicaSource --------------------------------------------------------


def _source_world(jax: bool):
    m = _side(jax)
    _pool(m, "fixed", 0, warm=1)
    _pool(m, "auto", 1, warm=0, autoscale={"min": 0, "max": 3})
    m.mgr.run_until_idle()
    return m


def _stats(src) -> dict:
    st = src.stats()
    assert st["claim_latency_s"] >= 0 and st["claim_latency_total_s"] >= 0
    return {k: v for k, v in st.items() if "latency" not in k}


def test_warm_slice_replica_source_equals_jax():
    out = []
    for jax in (True, False):
        m = _source_world(jax)
        G = JG if jax else PG
        strings = _strings() if jax else {}
        topos = [(JT if jax else PT).slice_from_spec(
            *(s[0] if jax else s[1])) for s in SHAPES]
        src = G.WarmSliceReplicaSource(m.c, NS, topos[0])
        miss = G.WarmSliceReplicaSource(m.c, NS, topos[1],
                                        claim_deadline_s=2.0)
        trail = [src.acquire(now=m.clock.now()), _stats(src),
                 src.acquire(now=m.clock.now())]
        m.mgr.run_until_idle()
        trail += [src.acquire(now=m.clock.now()), _stats(src),
                  miss.acquire(now=5.0), miss.acquire(
                      now=6.0, pools=m.c.list("SlicePool", NS)),
                  _stats(miss)]

        class Broken:
            def list(self, *a, **k):
                raise RuntimeError("apiserver down")

        broken = G.WarmSliceReplicaSource(Broken(), NS, topos[0])
        with pytest.raises(RuntimeError, match="apiserver down"):
            broken.acquire()
        trail.append(_stats(broken))
        with pytest.raises(ValueError) as err:
            G.WarmSliceReplicaSource(m.c, NS, topos[0], claim_deadline_s=0)
        trail.append(str(err.value))
        # A deadline already past: a clean miss with no claim made.
        late = G.WarmSliceReplicaSource(m.c, NS, topos[0],
                                        claim_deadline_s=1e-9)
        trail += [late.acquire(now=7.0), _stats(late)]
        out.append((_norm(trail, strings), _objects(m, strings),
                    _log(m, strings)))
    assert out[1] == out[0]
    trail = out[1][0]
    assert trail[0] == "fixed" and trail[2] is None and trail[3] == "fixed"
    assert trail[1] == {"claim_attempts": 1, "claim_failures": 0,
                        "claim_deadline_s": 5.0}
    assert trail[5] is None and trail[7]["claim_failures"] == 2


def test_gateway_scales_up_through_the_warm_slice_source(monkeypatch):
    """``gateway_from_env`` with the autoscaler on takes the source, and
    ``scale_up`` claims a warm slice through it, as JAX's does."""
    monkeypatch.setenv("KUBEFLOW_TPU_AUTOSCALE_ENABLE", "1")
    monkeypatch.setenv("KUBEFLOW_TPU_GATEWAY_PORT", "0")
    out = []
    for jax in (True, False):
        m = _source_world(jax)
        G = JG if jax else PG
        topo = (JT if jax else PT).slice_from_spec(
            *(SHAPES[0][0] if jax else SHAPES[0][1]))
        src = G.WarmSliceReplicaSource(m.c, NS, topo)
        gw = G.gateway_from_env(replica_source=src)
        try:
            out.append((gw.autoscaler is not None,
                        gw.scale_up(now=m.clock.now()),
                        gw.scale_up(now=m.clock.now()), _stats(src)))
        finally:
            gw.stop()
    assert out[1] == out[0] == (True, "fixed", None, {
        "claim_attempts": 2, "claim_failures": 1, "claim_deadline_s": 5.0})


def test_claim_races_land_on_distinct_slices():
    """Two claimants with fixed identities over one pool: the second
    fence conflicts and walks on, on both sides."""
    out = []
    for jax in (True, False):
        m = _side(jax)
        _pool(m, "fixed", 0, warm=2)
        m.mgr.run_until_idle()
        S = m.S
        topo = (JT if jax else PT).slice_from_spec(
            *(SHAPES[0][0] if jax else SHAPES[0][1]))
        first = sorted(m.c.list("StatefulSet", NS), key=lambda s: s[
            "metadata"]["name"])
        won = []
        fenced = copy.deepcopy(first[0])
        fenced["metadata"].setdefault("annotations", {})[
            m.Sp.CLAIMED_BY] = "claim-other"
        m.c.update(fenced)
        won.append(S.claim_warm_slice(m.c, NS, topo, claimant="claim-me"))
        won.append(S.claim_warm_slice(m.c, NS, topo, claimant="claim-me"))
        try:
            S._claim_candidate(m.c, first[0], "claim-me")
        except S.ClaimLost as err:
            won.append(str(err))
        out.append((won, sorted(m.c._objects)))
    assert out[1][0] == out[0][0]
    assert out[1][0][:2] == ["fixed", None]
    assert len(out[1][1]) == len(out[0][1])
