"""The port's cluster client layer against the JAX package's, on the CPU.

Each scenario is one script of API calls run on a JAX ``FakeCluster`` and
on the port's, each on its own ``FakeClock`` from the same start. After
every call both sides must have returned the same object, or raised the
same error (its type's name and its message), and at the end both
clusters hold the same objects (uids, resourceVersions, generations,
timestamps), the same watch log and the same compaction horizon:

- CRUD, optimistic concurrency, the status subresource, no-op writes,
  merge patches, selectors, cluster-scoped kinds;
- finalizers and two-phase delete; owner-reference garbage collection;
- admission: mutating hooks that rewrite, validating hooks that deny,
  DELETE hooks;
- the watch log: absolute cursors, compaction and the 410 it raises.

``Manager``: a recording reconciler on each side sees the same requests in
the same order at the same clock readings (watch mapping, dedup, timed
requeues with tied due times, the retry backoff after a failure).
``EventRecorder``: the same Event names, counts and dedup.
``retry_on_conflict``: the same attempts and the same final error.
``FakeKubelet`` and ``FakePodRunner``: the same pods, bindings,
Unschedulable pods, preemptions and terminal pods, after the resource and
node-label replacement (``nvidia.com/gpu`` for ``google.com/tpu``).
"""

from __future__ import annotations

import copy
import dataclasses
import types

import pytest

from kubeflow_tpu.k8s import client as JCl
from kubeflow_tpu.k8s import errors as JE
from kubeflow_tpu.k8s import events as JEv
from kubeflow_tpu.k8s import fake as JF
from kubeflow_tpu.k8s import fixtures as JX
from kubeflow_tpu.k8s import manager as JM
from kubeflow_tpu.k8s import objects as JO
from kubeflow_tpu_torch.k8s import client as PCl
from kubeflow_tpu_torch.k8s import errors as PE
from kubeflow_tpu_torch.k8s import events as PEv
from kubeflow_tpu_torch.k8s import fake as PF
from kubeflow_tpu_torch.k8s import fixtures as PX
from kubeflow_tpu_torch.k8s import manager as PM
from kubeflow_tpu_torch.k8s import objects as PO

JAX = types.SimpleNamespace(F=JF, E=JE, M=JM, O=JO, Ev=JEv, Cl=JCl, X=JX,
                            resource="google.com/tpu")
PORT = types.SimpleNamespace(F=PF, E=PE, M=PM, O=PO, Ev=PEv, Cl=PCl, X=PX,
                             resource="nvidia.com/gpu")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as err:  # the error's type and message are compared
        return ("raised", type(err).__name__, str(err))


def _state(cluster) -> dict:
    return {
        "objects": copy.deepcopy(cluster._objects),
        "events": [dataclasses.astuple(e) for e in cluster.events],
        "events_base": cluster.events_base,
        "uid": cluster._uid,
    }


def _both(script):
    out = []
    for m in (JAX, PORT):
        clock = m.M.FakeClock()
        cluster = m.F.FakeCluster(clock=clock)
        log = []
        script(m, cluster, clock, log)
        out.append((log, _state(cluster)))
    return out


def _nb(name, ns="ns", **extra):
    obj = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
           "metadata": {"name": name, "namespace": ns}, "spec": {"a": 1}}
    obj.update(extra)
    return obj


# -- FakeCluster scripts ----------------------------------------------------


def crud(m, c, clock, log):
    step = lambda fn: log.append(_outcome(fn))  # noqa: E731
    step(lambda: c.create(_nb("a", labels={})))
    step(lambda: c.create(_nb("a")))                     # AlreadyExists
    step(lambda: c.create({"kind": "Notebook", "metadata": {}}))  # Invalid
    step(lambda: c.get("Notebook", "missing", "ns"))     # NotFound
    clock.advance(7.5)
    obj = c.get("Notebook", "a", "ns")
    stale = copy.deepcopy(obj)
    obj["spec"]["a"] = 2
    step(lambda: c.update(obj))                          # generation 2
    step(lambda: c.update(stale))                        # Conflict
    step(lambda: c.update(c.get("Notebook", "a", "ns")))  # no-op
    fresh = c.get("Notebook", "a", "ns")
    fresh["status"] = {"ready": 1}
    step(lambda: c.update_status(fresh))
    step(lambda: c.update_status(c.get("Notebook", "a", "ns")))  # no-op
    clobber = c.get("Notebook", "a", "ns")
    clobber["status"] = {"ready": 9}
    clobber["metadata"]["labels"] = {"x": "y"}
    step(lambda: c.update(clobber))     # status preserved, labels land
    step(lambda: c.update_status(stale))                 # stale on status
    step(lambda: c.patch("Notebook", "a", "ns", {
        "metadata": {"labels": {"x": None, "k": "v"}}, "spec": {"b": [1]}}))
    step(lambda: c.patch("Notebook", "zz", "ns", {}))
    step(lambda: c.create({"apiVersion": "v1", "kind": "Node",
                           "metadata": {"name": "n0", "namespace": "ignored",
                                        "labels": {"pool": "p"}}}))
    step(lambda: c.get("Node", "n0", "other"))
    step(lambda: c.list("Node", "whatever"))
    for i, ns in enumerate(("ns", "ns2", "ns")):
        step(lambda i=i, ns=ns: c.create(
            _nb(f"b{i}", ns, metadata={"name": f"b{i}", "namespace": ns,
                                       "labels": {"k": str(i % 2)}})))
    step(lambda: c.list("Notebook"))
    step(lambda: c.list("Notebook", "ns", label_selector={"k": "0"}))
    step(lambda: c.list("Notebook", field_selector={
        "metadata.namespace": "ns2"}))
    step(lambda: c.list("Notebook", field_selector={"spec.a.deep": 1}))
    step(lambda: c.exists("Notebook", "b1", "ns2"))
    step(lambda: c.delete("Notebook", "b1", "ns2"))
    step(lambda: c.delete("Notebook", "b1", "ns2"))      # NotFound
    step(lambda: c.update(_nb("ghost")))                 # NotFound


def finalizers(m, c, clock, log):
    step = lambda fn: log.append(_outcome(fn))  # noqa: E731
    step(lambda: c.create(_nb("f", metadata={
        "name": "f", "namespace": "ns", "finalizers": ["x/y"]})))
    clock.advance(3)
    step(lambda: c.delete("Notebook", "f", "ns"))
    step(lambda: c.delete("Notebook", "f", "ns"))        # already deleting
    obj = c.get("Notebook", "f", "ns")
    obj["metadata"].pop("deletionTimestamp")
    obj["spec"]["a"] = 5
    step(lambda: c.update(obj))                          # keeps the stamp
    obj = c.get("Notebook", "f", "ns")
    obj["metadata"]["finalizers"] = []
    step(lambda: c.update(obj))                          # removed now
    step(lambda: c.exists("Notebook", "f", "ns"))


def garbage(m, c, clock, log):
    step = lambda fn: log.append(_outcome(fn))  # noqa: E731
    owner = c.create(_nb("owner"))
    log.append(owner)
    for i in range(3):
        child = {"apiVersion": "apps/v1", "kind": "StatefulSet",
                 "metadata": {"name": f"s{i}", "namespace": "ns"}}
        if i < 2:
            m.O.set_controller_reference(owner, child)
        step(lambda child=child: c.create(child))
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": "s0-0", "namespace": "ns"}}
    m.O.set_controller_reference(c.get("StatefulSet", "s0", "ns"), pod)
    step(lambda: c.create(pod))
    other = c.get("StatefulSet", "s2", "ns")
    step(lambda: m.O.set_controller_reference(owner, other))
    m.O.set_owner_reference(owner, other)
    m.O.set_owner_reference(owner, other)
    step(lambda: c.update(other))
    try:
        m.O.set_controller_reference(c.get("Notebook", "owner", "ns"),
                                     c.get("Pod", "s0-0", "ns"))
    except ValueError as err:
        log.append(("refused", str(err)))
    clock.advance(1)
    step(lambda: c.delete("Notebook", "owner", "ns"))
    step(lambda: sorted(c._objects))
    log.append([m.O.owner_uid(o) for o in c.list("StatefulSet")])


def admission(m, c, clock, log):
    step = lambda fn: log.append(_outcome(fn))  # noqa: E731
    seen = []

    def mutate(req):
        seen.append((req.operation, m.O.name_of(req.object),
                     req.old_object is not None))
        obj = copy.deepcopy(req.object)
        m.O.labels_of(obj)["mutated"] = req.operation.lower()
        if m.O.name_of(obj) == "rename":
            obj["metadata"]["name"] = "renamed"
        return obj

    def validate(req):
        if req.object.get("spec", {}).get("deny"):
            raise m.E.WebhookDeniedError("denied: spec.deny is set")

    def on_delete(req):
        seen.append(("DELETE-hook", m.O.name_of(req.object)))
        if m.O.labels_of(req.object).get("pinned"):
            raise m.E.WebhookDeniedError("pinned")

    c.register_mutating_webhook("Notebook", mutate)
    c.register_mutating_webhook("Notebook", lambda req: None)
    c.register_validating_webhook("Notebook", validate)
    c.register_validating_webhook("Notebook", on_delete, ("DELETE",))
    step(lambda: c.create(_nb("plain")))
    step(lambda: c.create(_nb("rename")))
    step(lambda: c.create(_nb("rename")))   # stored as "renamed": taken
    step(lambda: c.create(_nb("deny", spec={"deny": True})))
    obj = c.get("Notebook", "plain", "ns")
    obj["spec"]["deny"] = True
    step(lambda: c.update(obj))
    step(lambda: c.patch("Notebook", "plain", "ns",
                         {"metadata": {"labels": {"pinned": "1"}}}))
    step(lambda: c.delete("Notebook", "plain", "ns"))
    step(lambda: c.delete("Notebook", "renamed", "ns"))
    log.append(seen)


def watch(m, c, clock, log):
    step = lambda fn: log.append(_outcome(fn))  # noqa: E731
    for i in range(5):
        c.create(_nb(f"w{i}"))
        clock.advance(1)
    events, cur = c.drain_events(0)
    log.append(([dataclasses.astuple(e) for e in events], cur))
    step(lambda: c.event_cursor())
    c.delete("Notebook", "w0", "ns")
    step(lambda: [dataclasses.astuple(e) for e in c.drain_events(cur)[0]])
    c.compact_events(keep_last=2)
    step(lambda: c.drain_events(1))                      # Expired
    step(lambda: [dataclasses.astuple(e)
                  for e in c.drain_events(c.events_base)[0]])
    c.compact_events(keep_last=10)
    step(lambda: c.drain_events(c.event_cursor()))
    obj = c.get("Notebook", "w1", "ns")
    obj["spec"]["a"] = 3
    c.update(obj)
    # An object's resourceVersion is the log cursor after its event.
    step(lambda: (c.get("Notebook", "w1", "ns")["metadata"]
                  ["resourceVersion"], c.event_cursor()))


SCRIPTS = {"crud": crud, "finalizers": finalizers, "garbage": garbage,
           "admission": admission, "watch": watch}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_fake_cluster_equals_jax(name):
    (jlog, jstate), (plog, pstate) = _both(SCRIPTS[name])
    assert plog == jlog
    assert pstate == jstate
    assert len(jlog) > 3 and jstate["events"]


@pytest.mark.parametrize("kind", ["ApiError", "NotFoundError",
                                  "AlreadyExistsError", "ConflictError",
                                  "InvalidError", "WebhookDeniedError",
                                  "ExpiredError"])
def test_errors_equal_jax(kind):
    j, p = getattr(JE, kind), getattr(PE, kind)
    assert (p.code, p.reason) == (j.code, j.reason)
    assert [c.__name__ for c in p.__mro__[:-2]] == [
        c.__name__ for c in j.__mro__[:-2]]
    for msg in ("", "x not found"):
        pe, je = p(msg), j(msg)
        assert (str(pe), pe.message, pe.args) == (str(je), je.message, je.args)
        for pred in ("is_not_found", "is_conflict", "is_already_exists"):
            assert getattr(PE, pred)(pe) == getattr(JE, pred)(je)


def test_object_helpers_equal_jax():
    obj = {"kind": "Notebook", "metadata": {"name": "n", "uid": "u1"},
           "status": {"conditions": [{"type": "A", "status": "True",
                                      "lastTransitionTime": "t0"}]}}
    for m in (JO, PO):
        o = copy.deepcopy(obj)
        m.set_annotation(o, "k", "v")
        assert m.remove_annotation(o, "k") and not m.remove_annotation(o, "k")
    cases = [
        ("A", "True", None, "t1"), ("A", "False", "r", "t2"),
        ("A", "False", "r", "t3"), ("B", "True", "x", "t4"),
    ]
    outs = []
    for m in (JO, PO):
        o = copy.deepcopy(obj)
        trail = []
        for ctype, status, reason, now in cases:
            cond = {"type": ctype, "status": status}
            if reason:
                cond["reason"] = reason
            m.set_condition(o, cond, now=now)
            trail.append(copy.deepcopy(o["status"]))
        trail.append(m.get_condition(o, "B"))
        trail.append(m.merge_patch({"a": {"b": 1, "c": [1]}, "d": 2},
                                   {"a": {"b": None, "c": [2]}, "e": {"f": 1}}))
        trail.append(m.new_object("v1", "Pod", "p", "ns", {"l": "1"},
                                  {"a": "2"}))
        trail.append(m.new_object("v1", "Node", "n"))
        for ts in ("2026-01-01T00:00:00Z", "2026-01-01T00:00:00.5Z", "",
                   None, "garbage"):
            trail.append(m.parse_timestamp(ts))
        trail.append(m.matches_fields({"a": {"b": "c"}}, {"a.b": "c"}))
        trail.append(m.matches_fields({"a": "x"}, {"a.b": "c"}))
        outs.append(trail)
    assert outs[1] == outs[0]


# -- retry_on_conflict --------------------------------------------------------


@pytest.mark.parametrize("fails", [0, 2, 4, 5, 7])
def test_retry_on_conflict_equals_jax(fails):
    out = []
    for cl, e in ((JCl, JE), (PCl, PE)):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise e.ConflictError(f"stale {len(calls)}")
            return len(calls)

        out.append((_outcome(lambda: cl.retry_on_conflict(fn)), len(calls)))
    assert out[1] == out[0]
    assert _outcome(lambda: PCl.retry_on_conflict(lambda: 1, attempts=0)) == (
        _outcome(lambda: JCl.retry_on_conflict(lambda: 1, attempts=0)))


# -- EventRecorder -------------------------------------------------------------


def test_event_recorder_equals_jax():
    def script(m, c, clock, log):
        owner = c.create(_nb("nb"))
        rec = m.Ev.EventRecorder(c)
        culler = m.Ev.EventRecorder(c, component="culler")
        for r, kind, reason, msg in (
                (rec, "Warning", "FailedScheduling", "0/3 nodes"),
                (rec, "Warning", "FailedScheduling", "0/3 nodes"),
                (culler, "Normal", "NotebookCulled", "idle"),
                (rec, "Warning", "FailedScheduling", "0/4 nodes")):
            clock.advance(1)
            log.append(r.eventf(owner, kind, reason, msg))
        log.append(r.eventf({"kind": "Pod", "metadata": {"name": "p"}},
                            "Normal", "X", "no namespace"))
        log.append(m.Ev.events_for(c, "Notebook", "nb", "ns"))

    (jlog, jstate), (plog, pstate) = _both(script)
    assert plog == jlog and pstate == jstate
    names = [e["metadata"]["name"] for e in plog[:4]]
    assert names[0] == names[1] != names[3]
    assert plog[1]["count"] == 2


# -- Manager -------------------------------------------------------------------


class _Recorder:
    """A reconciler that records each call and answers from a script:
    {request name: [result or exception, ...]} consumed in call order."""

    def __init__(self, m, name, clock, log, answers):
        self.m, self.name, self.clock, self.log = m, name, clock, log
        self.answers = answers

    def reconcile(self, req):
        self.log.append((self.name, req.name, req.namespace,
                         self.clock.now()))
        todo = self.answers.get(req.name)
        if todo:
            got = todo.pop(0)
            if isinstance(got, Exception):
                raise got
            return self.m.M.Result(requeue_after=got)
        return self.m.M.Result()


def _manager_script(m, c, clock, log):
    mgr = m.M.Manager(c, clock=clock)
    answers = {"a": [5.0, 5.0, 0.0], "b": [5.0],
               "c": [RuntimeError("boom"), RuntimeError("boom"), 2.0],
               "d": [5.0, 1.0]}
    nbs = _Recorder(m, "nb", clock, log, answers)
    other = _Recorder(m, "other", clock, log, {})

    def pods_to_all(ev):
        return [m.M.Request(o["metadata"]["name"], "ns")
                for o in c.list("Notebook", "ns")][::-1]

    mgr.register(nbs, for_kind="Notebook", owns=("StatefulSet",),
                 watches=[("Pod", pods_to_all)], name="nb")
    mgr.register(other, for_kind="StatefulSet")
    log.append(mgr.watched_kinds())
    for name in ("a", "b", "c", "d"):
        c.create(_nb(name))
    owner = c.get("Notebook", "b", "ns")
    sts = {"apiVersion": "apps/v1", "kind": "StatefulSet",
           "metadata": {"name": "b", "namespace": "ns"}}
    m.O.set_controller_reference(owner, sts)
    c.create(sts)
    foreign = {"apiVersion": "apps/v1", "kind": "StatefulSet",
               "metadata": {"name": "x", "namespace": "ns",
                            "ownerReferences": [{"kind": "Deployment",
                                                 "name": "a",
                                                 "controller": True}]}}
    c.create(foreign)
    log.append(("calls", mgr.run_until_idle()))
    log.append(("next", mgr.next_requeue_in(), mgr.cursor))
    c.create({"apiVersion": "v1", "kind": "Pod",
              "metadata": {"name": "p", "namespace": "ns"}})
    for dt in (0.001, 0.004, 0.01, 1.0, 2.0, 5.0, 5.0, 10.0):
        log.append(("tick", dt, mgr.tick(dt), mgr.next_requeue_in()))
    log.append([(n, r.name, type(e).__name__, str(e))
                for n, r, e in mgr.reconcile_errors])
    log.append(sorted((k[0], k[1].name, v) for k, v in mgr._pending.items()))
    log.append(mgr._failures == {})


def test_manager_dispatch_order_and_requeue_times_equal_jax():
    (jlog, jstate), (plog, pstate) = _both(_manager_script)
    assert plog == jlog
    assert pstate == jstate
    dispatched = [e for e in plog if isinstance(e, tuple) and len(e) == 4
                  and e[0] in ("nb", "other")]
    assert len(dispatched) > 10


def test_manager_livelock_and_clocks_equal_jax():
    out = []
    for m in (JAX, PORT):
        clock = m.M.FakeClock(start=100.0)
        c = m.F.FakeCluster(clock=clock)

        class Churn:
            def reconcile(self, req, c=c):
                obj = c.get("Notebook", req.name, req.namespace)
                obj["spec"]["a"] += 1
                c.update(obj)
                return m.M.Result()

        mgr = m.M.Manager(c, clock=clock)
        mgr.register(Churn(), for_kind="Notebook")
        c.create(_nb("loop"))
        got = _outcome(lambda: mgr.run_until_idle(max_cycles=5))
        real = m.M.RealClock()
        real.advance(10)
        clock.advance(2.5)
        out.append((got, clock(), clock.now(), repr(m.M.Request("a", "b")),
                    repr(m.M.Result()), abs(real.now() - real()) < 1.0))
    assert out[1] == out[0]


# -- FakeKubelet and FakePodRunner -----------------------------------------------


def _gpu_swap(tree):
    """google.com/tpu → nvidia.com/gpu, the TPU node labels → the GPU
    node label, tpu-node → gpu-node, and the Unschedulable message's
    device word."""
    if isinstance(tree, list):
        return [_gpu_swap(x) for x in tree]
    if isinstance(tree, str):
        return (tree.replace("tpu-node", "gpu-node")
                .replace("TPU nodeSelector", "GPU nodeSelector"))
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "google.com/tpu":
            k = "nvidia.com/gpu"
        if k in ("labels", "nodeSelector") and isinstance(v, dict) and (
                "cloud.google.com/gke-tpu-accelerator" in v):
            v = {("cloud.google.com/gke-accelerator"
                  if kk == "cloud.google.com/gke-tpu-accelerator" else kk): vv
                 for kk, vv in v.items()
                 if kk != "cloud.google.com/gke-tpu-topology"}
        out[k] = _gpu_swap(v)
    return out


def _kubelet_script(m, c, clock, log):
    mgr = m.M.Manager(c, clock=clock)
    m.X.FakeKubelet(c).register(mgr)
    m.X.FakePodRunner(c, fail_images=frozenset({"bad:1"})).register(mgr)
    if m is JAX:
        m.X.add_tpu_node_pool(c, "acc", "8", hosts=2, chips_per_host=8)
    else:
        m.X.add_gpu_node_pool(c, "acc", "8", hosts=2, cards_per_host=8)
    m.X.add_cpu_node(c)
    m.X.add_cpu_node(c)

    def sts(name, replicas, per_pod, selector):
        return {"apiVersion": "apps/v1", "kind": "StatefulSet",
                "metadata": {"name": name, "namespace": "ns"},
                "spec": {"replicas": replicas, "serviceName": f"{name}-h",
                         "template": {
                             "metadata": {"labels": {"app": name},
                                          "annotations": {"a": "1"}},
                             "spec": {"nodeSelector": selector,
                                      "containers": [{
                                          "name": "c", "image": "img",
                                          "resources": {"limits": {
                                              m.resource: str(per_pod)}}}]}}}}

    tpu_sel = ({"cloud.google.com/gke-tpu-accelerator": "acc",
                "cloud.google.com/gke-tpu-topology": "8"} if m is JAX
               else {"cloud.google.com/gke-accelerator": "acc"})
    c.create(sts("big", 2, 8, tpu_sel))
    c.create(sts("late", 1, 4, tpu_sel))       # no room: Unschedulable
    c.create(sts("cpu", 1, 0, {}))
    log.append(("calls", mgr.run_until_idle()))
    log.append(c.list("Pod", "ns"))
    kubelet = m.X.FakeKubelet(c)
    kubelet.preempt_pod("big-1", "ns")
    log.append(("calls", mgr.run_until_idle()))
    big = c.get("StatefulSet", "big", "ns")
    big["spec"]["replicas"] = 1
    c.update(big)                               # frees a node: late binds
    log.append(("calls", mgr.run_until_idle()))
    for name, image in (("pull-ok", "good:1"), ("pull-bad", "bad:1")):
        c.create({"apiVersion": "v1", "kind": "Pod",
                  "metadata": {"name": name, "namespace": "ns"},
                  "spec": {"nodeName": "cpu-node-0", "restartPolicy": "Never",
                           "containers": [{"name": "p", "image": image}]}})
    clock.advance(3)
    log.append(("calls", mgr.run_until_idle()))
    log.append(mgr.reconcile_errors)


def test_kubelet_and_pod_runner_equal_jax_after_the_gpu_swap():
    (jlog, jstate), (plog, pstate) = _both(_kubelet_script)
    assert plog == _gpu_swap(jlog)
    assert pstate["objects"] == {
        tuple(_gpu_swap(list(k))): _gpu_swap(v)
        for k, v in jstate["objects"].items()}
    assert pstate["events"] == [tuple(_gpu_swap(list(e)))
                                for e in jstate["events"]]
    pods = {p["metadata"]["name"]: p for p in plog[1]}
    assert pods["late-0"]["status"]["phase"] == "Pending"
    late = pstate["objects"][("Pod", "ns", "late-0")]
    assert late["status"]["phase"] == "Running"
    assert late["spec"]["nodeName"] == "gpu-node-8-1"
    assert pstate["objects"][("Pod", "ns", "pull-bad")]["status"][
        "phase"] == "Failed"
    node = pstate["objects"][("Node", "", "gpu-node-8-0")]
    assert node["status"]["allocatable"] == {"nvidia.com/gpu": "8"}
    assert node["metadata"]["labels"] == {
        "cloud.google.com/gke-accelerator": "acc"}
