"""The port's idle culler and native prober against the JAX package's, on
the CPU.

A 4-host notebook (``v5e`` 4x4 on the JAX side, ``h100`` 32 on the
port's) is created and made Ready in a JAX cluster and in the port's, as
``test_torch_controller_loop.py`` does, then a ``CullingReconciler``
(idle time 10 min, period 1 min) joins each side's ``Manager`` with a
scripted prober, and both managers tick a minute at a time. After every
tick both clusters are equal after ``swap_cluster`` and so are the
metrics (``tpu_chips_reclaimed_total`` counting cards on the port's side):

- a busy host 3 keeps the slice alive (last activity follows the clock);
- the clock-skew guard: a host whose clock runs ahead moves last activity
  forward, and a later, older report never moves it back;
- a slice with no reachable host is never culled, however long it idles;
- an idle slice is culled: the migration trigger fires once, the stop
  annotation lands, the reconciler scales every StatefulSet to 0, the
  pods go, and the event says "released 32 GPU cards" where JAX's says
  "released 16 TPU chips".

``fold_host_activity`` equals JAX's on hypothesis inputs. The native
prober, built here with g++ from ``csrc/host/prober.cpp``, equals the
Python prober on 16 loopback stubs, some unreachable, and JAX's native
prober (its source built here into a temporary library); ``make_prober`` returns it (and the
Python prober only in DEV mode), and a broken source raises naming its
build log.
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import socket
import threading

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.api.notebook import Notebook as JNotebook
from kubeflow_tpu.controller import culling as JCu
from kubeflow_tpu_torch.api.notebook import Notebook as PNotebook
from kubeflow_tpu_torch.controller import culling as PCu
from kubeflow_tpu_torch.controller import prober as PPr
from kubeflow_tpu_torch.ops import _build
from tests.test_torch_controller_loop import (  # noqa: F401 (autouse)
    _fixed_condition_clock,
    _ready_all,
    _samples,
    _strip,
    _world,
)
from tests.torch_gpu_swap import swap_cluster

FOUR_HOSTS = ("four", "nb", ("v5e", "4x4"), ("h100", "32"), 1, False, False)
CONFIG = dict(enable_culling=True, cull_idle_time_min=10,
              idleness_check_period_min=1)
TICKS = 16


class _ScriptedProber:
    """Reports each host as ``script(now, index)`` says: (busy, last
    activity or None, reachable), in the culler module's own types."""

    def __init__(self, mod, clock, script, calls):
        self.mod, self.clock, self.script, self.calls = mod, clock, script, calls

    def probe(self, nb, hosts):
        self.calls.append(list(hosts))
        out = []
        for i, host in enumerate(hosts):
            busy, last, reachable = self.script(self.clock.now(), i)
            out.append(self.mod.HostActivity(host, busy, last, reachable))
        return out


def _busy_host_3(now, i):
    return (i == 3, now - 7200.0, True)


def _idle(now, i):
    return (False, now - 7200.0 if i else None, True)


def _unreachable(now, i):
    return (False, None, False)


class _Skewed:
    """Host 2's clock runs 5 min ahead for three probes, then reports an
    older activity; every other host is idle."""

    def __init__(self):
        self.seen = 0

    def __call__(self, now, i):
        if i != 2:
            return (False, None, True)
        self.seen += 1
        if self.seen <= 3:
            return (False, now + 300.0, True)
        return (False, now - 1800.0, True)


SCRIPTS = {"busy-host-3": lambda: _busy_host_3, "skew": _Skewed,
           "unreachable": lambda: _unreachable, "idle-cull": lambda: _idle}


def _culling_world(script_name):
    j, p, jtopo, ptopo, nodes = _world(FOUR_HOSTS)
    for m, mod in ((j, JCu), (p, PCu)):
        m.probes, m.triggers = [], []
        script = SCRIPTS[script_name]()
        mod.CullingReconciler(
            m.c, config=mod.CullerConfig(**CONFIG),
            prober=_ScriptedProber(mod, m.clock, script, m.probes),
            metrics=m.metrics, clock=m.clock,
            migration_trigger=lambda obj, why, m=m: m.triggers.append(
                (obj["metadata"]["name"], why)),
        ).register(m.mgr)
        m.clock.advance(5)
        m.c.create(dict(m.obj))
        m.mgr.run_until_idle()
        _ready_all(m)
        m.mgr.run_until_idle()
    return j, p, jtopo, ptopo, nodes


def _activity(m):
    anns = m.c.get("Notebook", m.name, m.ns)["metadata"]["annotations"]
    return anns.get(JA.LAST_ACTIVITY), anns.get(JA.LAST_ACTIVITY_CHECK), (
        JA.STOP in anns)


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_culler_equals_jax_tick_by_tick(script):
    j, p, jtopo, ptopo, nodes = _culling_world(script)
    trail = []
    for tick in range(TICKS):
        for m in (j, p):
            m.mgr.tick(60)
            assert not m.mgr.reconcile_errors, m.mgr.reconcile_errors
        want = swap_cluster(_strip(j.c._objects), jtopo, ptopo, nodes)
        got = _strip(p.c._objects)
        assert sorted(got) == sorted(want), tick
        for key in want:
            assert got[key] == want[key], (tick, key)
        jm, pm = _samples(j, False), _samples(p, True)
        for name in ("tpu_chips_in_use", "tpu_chips_reclaimed_total"):
            jv, pv = float(jm.pop(name)), float(pm.pop(name))
            per = ((jtopo.chips_per_host, ptopo.chips_per_host)
                   if name == "tpu_chips_in_use"
                   else (jtopo.chips, ptopo.chips))
            assert pv == jv / per[0] * per[1], (tick, name)
        assert pm == jm, tick
        assert p.probes == j.probes and p.triggers == j.triggers
        trail.append((_activity(p), pm))
    # Every host of the slice is probed.
    assert p.probes and all(len(h) == ptopo.hosts for h in p.probes)
    assert p.probes[0][3].startswith("nb-3.nb-hosts.user-ns.svc")
    stops = [stop for (_, _, stop), _ in trail]
    culled = script == "idle-cull"
    assert stops[-1] == culled
    assert float(trail[-1][1]["notebook_culling_total"]) == float(culled)
    if script == "busy-host-3":
        # Last activity follows the probes: never older than a period.
        assert len({last for (last, _, _), _ in trail}) >= TICKS - 1
    if script == "skew":
        lasts = [last for (last, _, _), _ in trail]
        assert lasts == sorted(lasts) and len(set(lasts)) >= 3
    if script == "unreachable":
        checks = {check for (_, check, _), _ in trail}
        assert len(checks) == 1  # never observed, never judged
    if culled:
        assert p.triggers == [("nb", "idle-cull")]
        sts = p.c.get("StatefulSet", "nb", "user-ns")
        assert sts["spec"]["replicas"] == 0
        assert p.c.list("Pod", "user-ns") == []
        nb = p.c.get("Notebook", "nb", "user-ns")
        assert nb["status"]["gpu"]["sliceHealth"] == "Stopped"
        # Stopped: the activity annotations are cleared.
        assert JA.LAST_ACTIVITY not in nb["metadata"]["annotations"]
        events = [o["message"] for (k, _, _), o in p.c._objects.items()
                  if k == "Event" and o["reason"] == "NotebookCulled"]
        assert len(events) == 1 and events[0].endswith(
            "released 32 GPU cards")
        assert p.metrics.registry.get_sample_value(
            "tpu_chips_reclaimed_total") == 32.0
    else:
        assert p.triggers == []


def test_a_trigger_that_raises_does_not_block_the_cull():
    out = []
    for mod, nb_cls in ((JCu, JNotebook), (PCu, PNotebook)):
        calls = []

        def boom(obj, why):
            calls.append(why)
            raise RuntimeError("save failed")

        j, p, *_ = _culling_world("idle-cull")
        m = j if mod is JCu else p
        culler = mod.CullingReconciler(
            m.c, config=mod.CullerConfig(**CONFIG), metrics=m.metrics,
            clock=m.clock, migration_trigger=boom)
        nb = nb_cls(m.c.get("Notebook", m.name, m.ns))
        culler._cull(nb, m.clock.now(), m.clock.now() - 3600)
        out.append((calls, _activity(m)[2]))
    assert out[1] == out[0] == (["idle-cull"], True)


def test_config_from_env_and_host_dns_equal_jax():
    for env in ({}, {"ENABLE_CULLING": "TRUE", "CULL_IDLE_TIME": "30",
                     "IDLENESS_CHECK_PERIOD": "2", "DEV": "true",
                     "CLUSTER_DOMAIN": "x.org"}):
        assert dataclasses.asdict(PCu.CullerConfig.from_env(env)) == (
            dataclasses.asdict(JCu.CullerConfig.from_env(env)))
    base = {"metadata": {"name": "nb", "namespace": "ns"}, "spec": {}}
    cases = [({}, {}), ({"tpu": {"accelerator": "v5e", "topology": "4x4"}},
                        {"gpu": {"accelerator": "h100", "topology": "32"}}),
             ({"tpu": {"accelerator": "v5e", "topology": "2x2",
                       "sliceCount": 2}},
              {"gpu": {"accelerator": "h100", "topology": "8",
                       "sliceCount": 2}}),
             ({"tpu": {"accelerator": "v5e", "topology": "3x4"}},
              {"gpu": {"accelerator": "h100", "topology": "12"}})]
    for jspec, pspec in cases:
        jnb = JNotebook({**base, "spec": jspec})
        pnb = PNotebook({**base, "spec": pspec})
        assert PCu.CullingReconciler(None, prober=object(), metrics=object(),
                                     recorder=object())._host_dns(pnb) == (
            JCu.CullingReconciler(None, prober=object(), metrics=object(),
                                  recorder=object())._host_dns(jnb))


# -- fold_host_activity ----------------------------------------------------------

_TIMES = st.one_of(
    st.datetimes(min_value=__import__("datetime").datetime(2000, 1, 1),
                 max_value=__import__("datetime").datetime(2100, 1, 1)).map(
        lambda d: d.strftime("%Y-%m-%dT%H:%M:%S.%fZ")),
    st.sampled_from(["", "garbage", "2026-07-29T10:00:00Z",
                     "2026-13-01T00:00:00.1Z"]),
    st.none())
_KERNEL = st.fixed_dictionaries(
    {}, optional={"execution_state": st.sampled_from(
        ["busy", "idle", "starting", "dead"]), "last_activity": _TIMES})


@settings(max_examples=200, deadline=None)
@given(kernels=st.one_of(st.none(), st.lists(_KERNEL, max_size=5)),
       terminals=st.one_of(st.none(), st.lists(
           st.fixed_dictionaries({}, optional={"last_activity": _TIMES}),
           max_size=4)))
def test_fold_host_activity_equals_jax(kernels, terminals):
    got = PCu.fold_host_activity("h", kernels, terminals)
    want = JCu.fold_host_activity("h", kernels, terminals)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- the native prober -----------------------------------------------------------

BUSY = [{"execution_state": "busy",
         "last_activity": "2026-07-29T10:00:00.000000Z"}]
IDLE = [{"execution_state": "idle",
         "last_activity": "2026-07-28T09:00:00.000000Z"},
        {"execution_state": "idle",
         "last_activity": "2026-07-28T09:30:00.123Z"}]
TERM = [{"last_activity": "2026-07-29T11:00:00.000000Z"}]

# Host i's (kernels, terminals) bodies and status; None: nothing listens.
STUBS = [
    (BUSY, TERM, 200), (IDLE, [], 200), (IDLE, TERM, 200), None,
    ([], [], 200), (BUSY, None, 200), (IDLE, TERM, 404),
    (IDLE, TERM, 500), None, ("not json", TERM, 200), (IDLE, "[]", 200),
    (BUSY + IDLE, TERM, 200), None, ([], TERM, 200), (IDLE, IDLE, 200),
    None,
]


class _Stub(http.server.BaseHTTPRequestHandler):
    kernels = terminals = None
    status = 200

    def do_GET(self):
        if self.path.endswith("/api/kernels"):
            payload = self.kernels
        elif self.path.endswith("/api/terminals"):
            payload = self.terminals
        else:
            payload = None
        if payload is None:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = (payload if isinstance(payload, str)
                else json.dumps(payload)).encode()
        self.send_response(self.status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def stubs():
    """16 loopback hosts (127.0.0.2..17) on one port, four of them with
    nothing listening."""
    port = _free_port()
    servers, hosts = [], []
    for i, stub in enumerate(STUBS):
        host = f"127.0.0.{i + 2}"
        hosts.append(host)
        if stub is None:
            continue
        kernels, terminals, status = stub
        handler = type("H", (_Stub,), {"kernels": kernels,
                                       "terminals": terminals,
                                       "status": status})
        srv = http.server.ThreadingHTTPServer((host, port), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    yield port, hosts
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _python_prober(mod, port):
    """The module's Python prober on ``port`` instead of Jupyter's 8888
    (the loopback stubs share one port)."""

    class OnPort(mod.JupyterHTTPProber):
        def _probe_host(self, nb, host):
            base = f"http://{host}:{port}/notebook/{nb.namespace}/{nb.name}"
            kernels = self._get_json(f"{base}/api/kernels")
            terminals = (self._get_json(f"{base}/api/terminals")
                         if kernels is not None else None)
            return kernels, terminals

    return OnPort(timeout_s=2.0)


def _nb(cls):
    return cls({"metadata": {"name": "nb", "namespace": "user"}, "spec": {}})


def test_native_prober_equals_the_python_prober(stubs):
    port, hosts = stubs
    native = PPr.NativeFanoutProber(timeout_s=2.0, port=port)
    got = [dataclasses.asdict(a) for a in native.probe(_nb(PNotebook), hosts)]
    python = [dataclasses.asdict(a) for a in _python_prober(PCu, port).probe(
        _nb(PNotebook), hosts)]
    jax = [dataclasses.asdict(a) for a in _python_prober(JCu, port).probe(
        _nb(JNotebook), hosts)]
    assert got == python == jax
    reachable = [a["reachable"] for a in got]
    assert reachable.count(False) >= 6  # 4 dead hosts, a 500, bad JSON
    assert [a["busy"] for a in got][:3] == [True, False, False]


def test_native_prober_equals_jaxs_native_prober(stubs, tmp_path):
    """JAX's ``native/prober.cpp``, built here into a temporary library
    and handed to JAX's binding, against the port's."""
    import ctypes
    import pathlib
    import subprocess

    from kubeflow_tpu.controller import prober as JPr

    src = pathlib.Path(JPr.__file__).resolve().parents[2] / "native"
    so = tmp_path / "libprober.so"
    subprocess.run(["g++", *_build.GXX_FLAGS, str(src / "prober.cpp"), "-o",
                    str(so)], check=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.pr_probe.argtypes = PPr.load_lib().pr_probe.argtypes
    lib.pr_probe.restype = ctypes.c_int
    port, hosts = stubs
    got = PPr.NativeFanoutProber(timeout_s=2.0, port=port).probe(
        _nb(PNotebook), hosts)
    want = JPr.NativeFanoutProber(timeout_s=2.0, lib=lib, port=port).probe(
        _nb(JNotebook), hosts)
    assert [dataclasses.asdict(a) for a in got] == [
        dataclasses.asdict(a) for a in want]


def test_make_prober_is_native_and_python_only_in_dev_mode():
    assert isinstance(PPr.make_prober(), PPr.NativeFanoutProber)
    dev = PPr.make_prober(timeout_s=3.0, dev_proxy="http://127.0.0.1:1")
    assert type(dev) is PCu.JupyterHTTPProber
    assert (dev.timeout_s, dev.dev_proxy) == (3.0, "http://127.0.0.1:1")
    path = _build.host_library_path(PPr._SRC)
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert PPr.load_lib() is PPr.load_lib()


def test_a_broken_source_raises_naming_its_build_log(tmp_path, monkeypatch):
    broken = tmp_path / "prober.cpp"
    broken.write_text(PPr._SRC.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(PPr, "_SRC", broken)
    with pytest.raises(RuntimeError, match=r"host build of prober\.cpp "
                                           r"failed .*see .*\.log"):
        PPr.make_prober()
    logs = list((tmp_path / "_build").glob("*.log"))
    assert logs and "error" in logs[0].read_text()


def test_native_prober_marks_a_truncated_list_busy(stubs):
    """A kernel list over the 64 KiB body cap reads as busy, as JAX's
    native prober reads it."""
    big = [{"execution_state": "idle",
            "last_activity": "2026-07-28T09:00:00.000000Z"}] * 2000
    handler = type("H", (_Stub,), {"kernels": big, "terminals": []})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        got = PPr.NativeFanoutProber(
            timeout_s=2.0, port=srv.server_address[1]).probe(
            _nb(PNotebook), ["127.0.0.1"])
    finally:
        srv.shutdown()
        srv.server_close()
    assert [dataclasses.asdict(a) for a in got] == [
        {"host": "127.0.0.1", "busy": True, "last_activity": None,
         "reachable": True}]
