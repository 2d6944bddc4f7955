"""The port's manager layer against the JAX package's, on the CPU.

The cases of ``tests/test_entrypoints.py`` run on both packages and
compare what they observe: the two managers' flags (``Options`` equal
field for field, the same ``FlagError``), ``detect_namespace``, leader
election (each call's answer, the Lease objects and the transitions),
the health registry and its HTTP server, the serve watchdog, ``serve``
beating it, ``build`` with and without culling, a bundle reconciling a
notebook (the whole cluster and the metrics after
``tests/torch_gpu_swap.swap_cluster``), leadership gating, the platform
bundle's webhooks, reconciler and TLS watcher, and the cache transform.
"""

from __future__ import annotations

import dataclasses
import json
import types
import urllib.request

import pytest

from kubeflow_tpu.cmd import notebook_manager as JNm
from kubeflow_tpu.cmd import platform_manager as JPm
from kubeflow_tpu.controller import tls as JTls
from kubeflow_tpu.k8s import cache as JCa
from kubeflow_tpu.k8s import health as JH
from kubeflow_tpu.k8s import leader as JL
from kubeflow_tpu.k8s import serve as JSv
from kubeflow_tpu_torch.cmd import notebook_manager as PNm
from kubeflow_tpu_torch.cmd import platform_manager as PPm
from kubeflow_tpu_torch.controller import tls as PTls
from kubeflow_tpu_torch.k8s import cache as PCa
from kubeflow_tpu_torch.k8s import health as PH
from kubeflow_tpu_torch.k8s import leader as PL
from kubeflow_tpu_torch.k8s import serve as PSv
from tests.test_torch_controller_loop import (  # noqa: F401 (autouse)
    _fixed_condition_clock,
)
from tests.torch_controller_env import (
    JPOOL_LABEL,
    JTOPO,
    PTOPO,
    compare,
    make_side,
    notebook,
)

SIDES = (True, False)


class _Prober:
    """A prober that reports nothing (the culler is built, not driven)."""

    def probe(self, nb, hosts):
        return []


def _mods(jax):
    return types.SimpleNamespace(
        nm=JNm if jax else PNm, pm=JPm if jax else PPm,
        L=JL if jax else PL, H=JH if jax else PH, Sv=JSv if jax else PSv,
        Ca=JCa if jax else PCa, Tls=JTls if jax else PTls)


def _world(jax):
    """A side (``make_side``'s nodes and clock) with no reconcilers: a
    bundle under test registers its own."""
    m = make_side(jax, sa_pull_secrets=False, slice_health=False)
    m.c = m.F.FakeCluster(clock=m.clock)
    m.X.add_cpu_node(m.c, "cpu-node-0")
    if jax:
        m.X.add_tpu_node_pool(m.c, JPOOL_LABEL, JTOPO.topology_str, hosts=4,
                              chips_per_host=JTOPO.chips_per_host)
    else:
        m.X.add_gpu_node_pool(m.c, PTOPO.gke_accelerator_label,
                              PTOPO.topology_str, hosts=4,
                              cards_per_host=PTOPO.chips_per_host)
    return m


# -- flags -----------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    [], ["--metrics-addr", ":9090", "--enable-leader-election",
         "--burst", "100"],
    ["--probe-addr", "127.0.0.1:1", "--qps", "5", "--metrics-addr", "0"]])
def test_notebook_manager_flags_equal_jaxs(argv):
    got = [dataclasses.asdict(m.parse_args(list(argv))) for m in (JNm, PNm)]
    assert got[1] == got[0]
    if not argv:
        assert got[1] == {"metrics_addr": ":8080", "probe_addr": ":8081",
                          "enable_leader_election": False, "burst": 0,
                          "qps": 0}


@pytest.mark.parametrize("argv", [
    ["--kube-rbac-proxy-image", "proxy:v1", "--webhook-port", "9443"],
    ["--kube-rbac-proxy-image", "p", "--cert-dir", "/certs",
     "--enable-leader-election", "--probe-addr", ":1"]])
def test_platform_manager_flags_equal_jaxs(argv):
    got = [dataclasses.asdict(m.parse_args(list(argv))) for m in (JPm, PPm)]
    assert got[1] == got[0]
    assert got[1]["kube_rbac_proxy_image"] == argv[1]


@pytest.mark.parametrize("argv", [[], ["--webhook-port", "1"]])
def test_platform_manager_requires_rbac_proxy_image(argv):
    texts = []
    for mod in (JPm, PPm):
        with pytest.raises(mod.FlagError) as err:
            mod.parse_args(argv)
        texts.append(str(err.value))
    assert texts[1] == texts[0] == "--kube-rbac-proxy-image is required"
    assert issubclass(PPm.FlagError, ValueError)


def test_an_unknown_flag_exits_both():
    for mod in (JNm, PNm, JPm, PPm):
        with pytest.raises(SystemExit):
            mod.parse_args(["--no-such-flag"])


def test_detect_namespace_equals_jaxs(tmp_path):
    ns_file = tmp_path / "namespace"
    ns_file.write_text("from-file\n")
    empty = tmp_path / "empty"
    empty.write_text("  \n")
    for env, path, want in (
            ({"K8S_NAMESPACE": "from-env"}, ns_file, "from-env"),
            ({}, ns_file, "from-file"),
            ({}, empty, "opendatahub"),
            ({}, tmp_path / "absent", "opendatahub")):
        got = [m.detect_namespace(env, str(path)) for m in (JPm, PPm)]
        assert got == [want, want]


# -- leader election -------------------------------------------------------------


def _election(jax, script):
    """Run ``script(clock, a, b)`` (two electors on one Lease) on one side;
    returns its answers, the Lease and the transitions."""
    m = _world(jax)
    mods = _mods(jax)
    a, b = (mods.L.LeaderElector(m.c, "lock", "ns", who, lease_duration=15,
                                 clock=m.clock) for who in ("a", "b"))
    answers = script(m.clock, a, b)
    lease = m.c.get("Lease", "lock", "ns") if m.c.exists(
        "Lease", "lock", "ns") else None
    return answers, lease, (a.transitions, b.transitions)


def _acquire_and_block(clock, a, b):
    out = [a.try_acquire(), a.is_leader(), b.try_acquire(), b.is_leader()]
    clock.advance(10)
    out.append(a.try_acquire())
    clock.advance(10)
    out.append(b.try_acquire())
    return out


def _expiry_takeover(clock, a, b):
    out = [a.try_acquire()]
    clock.advance(20)
    return out + [b.try_acquire(), b.is_leader(), a.is_leader(),
                  a.try_acquire()]


def _release_hands_off(clock, a, b):
    out = [a.try_acquire()]
    a.release()
    out += [a.is_leader(), b.try_acquire(), b.is_leader()]
    b.release()
    a.release()  # not the holder: no change
    return out + [a.try_acquire()]


@pytest.mark.parametrize("script,want", [
    (_acquire_and_block, [True, True, False, False, True, False]),
    (_expiry_takeover, [True, True, True, False, False]),
    (_release_hands_off, [True, False, True, True, True])])
def test_leader_election_equals_jaxs(script, want):
    jax, port = (_election(jax, script) for jax in SIDES)
    assert port == jax
    assert port[0] == want
    assert (PL.UPSTREAM_LEASE, PL.PLATFORM_LEASE) == (
        JL.UPSTREAM_LEASE, JL.PLATFORM_LEASE)


# -- health ----------------------------------------------------------------------


def _checks(mods):
    checks = mods.H.HealthChecks()
    checks.add_healthz_check("healthz", mods.H.ping)

    def not_synced():
        raise RuntimeError("not synced")

    checks.add_readyz_check("cache", not_synced)
    return checks


def test_health_checks_equal_jaxs():
    got = []
    for jax in SIDES:
        checks = _checks(_mods(jax))
        got.append([checks.handle(p) for p in (
            "/healthz", "/healthz/", "/readyz", "/nope")])
    assert got[1] == got[0]
    assert [code for code, _ in got[1]] == [200, 200, 500, 404]
    assert "not synced" in json.loads(got[1][2][1])["cache"]


def test_health_server_serves_http():
    checks = PH.HealthChecks()
    checks.add_healthz_check("healthz", PH.ping)
    checks.add_readyz_check("readyz", PH.ping)
    server = PH.HealthServer(checks)
    server.start()
    try:
        for path in ("/healthz", "/readyz"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}{path}") as resp:
                assert resp.status == 200
                assert resp.headers["Content-Type"] == "application/json"
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/x")
        assert err.value.code == 404
    finally:
        server.stop()


def test_serve_watchdog_equals_jaxs():
    got = []
    for jax in SIDES:
        mods, m = _mods(jax), _world(jax)
        dog = mods.H.ServeWatchdog(window_s=60.0, clock=m.clock)
        checks = mods.H.HealthChecks()
        dog.register(checks)
        seen = [checks.handle("/readyz")]
        dog.beat(cursor=7)
        seen.append(checks.handle("/readyz"))
        m.clock.advance(59)
        seen.append(checks.handle("/readyz"))
        m.clock.advance(2)
        seen.append(checks.handle("/readyz"))
        dog.beat(cursor=8)
        seen.append(checks.handle("/readyz"))
        got.append(seen)
    assert got[1] == got[0]
    assert [code for code, _ in got[1]] == [500, 200, 200, 500, 200]
    assert "not completed a cycle" in got[1][0][1]
    assert "stalled" in got[1][3][1] and "cursor 7" in got[1][3][1]


def test_serve_loop_beats_the_watchdog():
    m = _world(False)
    bundle = PNm.build(m.c, env={}, clock=m.clock)
    assert bundle.health.handle("/readyz")[0] == 200
    dog = PH.ServeWatchdog(window_s=60.0)
    PSv.serve(bundle, m.c, max_iterations=2, max_idle_wait=0.01,
              watchdog=dog)
    assert dog.last_cursor == bundle.manager.cursor
    assert bundle.health.handle("/readyz")[0] == 200
    assert json.loads(bundle.health.handle("/readyz")[1]) == {
        "readyz": "ok", "serve-loop": "ok"}


@pytest.mark.parametrize("addr,want", [
    (":8080", ("0.0.0.0", 8080)), ("localhost:9", ("localhost", 9)),
    ("127.0.0.1:0", ("127.0.0.1", 0))])
def test_split_addr_equals_jaxs(addr, want):
    assert PSv.split_addr(addr) == JSv.split_addr(addr) == want


# -- the notebook manager --------------------------------------------------------


@pytest.mark.parametrize("env", [
    {}, {"ENABLE_CULLING": "true", "CULL_IDLE_TIME": "30"},
    {"ENABLE_IMAGE_PREPULL": "true", "K8S_NAMESPACE": "team"}])
def test_build_equals_jaxs(env):
    got = []
    for jax in SIDES:
        m = _world(jax)
        bundle = _mods(jax).nm.build(m.c, env=dict(env), clock=m.clock,
                                     prober=_Prober())
        culler = bundle.culling_reconciler
        got.append((
            culler is None or dataclasses.asdict(culler.config),
            bundle.prepull_reconciler.enabled,
            bundle.manager.watched_kinds(),
            [r.name for r in bundle.manager._registrations],
            dataclasses.asdict(bundle.options)))
    assert got[1] == got[0]
    if env.get("ENABLE_CULLING"):
        assert got[1][0]["cull_idle_time_min"] == 30
    else:
        assert got[1][0] is True


def _reconciled(jax, argv=None):
    m = _world(jax)
    bundle = _mods(jax).nm.build(m.c, env={}, argv=argv, clock=m.clock)
    m.X.FakeKubelet(m.c).register(bundle.manager)
    m.metrics, m.mgr = bundle.metrics, bundle.manager
    return m, bundle


def test_manager_bundle_reconciles_a_notebook_as_jaxs():
    sides = []
    for jax in SIDES:
        m, bundle = _reconciled(jax)
        m.c.create(notebook(m))
        assert bundle.run_until_idle() > 0
        assert m.c.get("StatefulSet", "nb", "ns")["spec"]["replicas"] == 4
        assert not bundle.manager.reconcile_errors
        sides.append(m)
    compare(*sides)
    assert sides[1].c.get("Notebook", "nb", "ns")["status"]["gpu"][
        "sliceHealth"] == "Healthy"


def test_leader_gating_blocks_non_leader():
    counts = []
    for jax in SIDES:
        m = _world(jax)
        nm = _mods(jax).nm
        leader, follower = (nm.build(m.c, env={}, argv=[
            "--enable-leader-election"], clock=m.clock, identity=who)
            for who in ("a", "b"))
        assert leader.elector.try_acquire()
        assert leader.elector.namespace == "kubeflow"
        m.c.create(notebook(m))
        t0 = m.clock.now()
        seen = [follower.run_until_idle(), follower.tick(5)]
        assert m.clock.now() == t0 + 5  # the follower's tick moves time
        seen.append(leader.run_until_idle())
        assert m.c.exists("StatefulSet", "nb", "ns")
        counts.append(seen)
    assert counts[1] == counts[0]
    assert counts[1][:2] == [0, 0] and counts[1][2] > 0


# -- the platform manager --------------------------------------------------------


def _platform(jax, argv=("--kube-rbac-proxy-image", "proxy:v1"), env=None):
    m = make_side(jax, platform=False)
    bundle = _mods(jax).pm.build(
        m.c, env=env if env is not None else {"K8S_NAMESPACE": "opendatahub"},
        argv=list(argv), clock=m.clock)
    return m, bundle


def test_platform_build_registers_webhooks_and_reconciler():
    sides = []
    for jax in SIDES:
        m, bundle = _platform(jax)
        assert bundle.tls_profile == _mods(jax).Tls.INTERMEDIATE
        created = m.c.create(notebook(m, name="nb1"))
        assert created["metadata"]["annotations"]["kubeflow-resource-stopped"]
        bundle.run_until_idle()
        m.mgr.run_until_idle()
        bundle.run_until_idle()
        assert m.c.exists("NetworkPolicy", "nb1-ctrl-np", "ns")
        assert not bundle.manager.reconcile_errors
        sides.append(m)
    compare(*sides)


def test_platform_webhook_config_from_flags_and_env():
    got = []
    for jax in SIDES:
        _, bundle = _platform(jax, ("--kube-rbac-proxy-image", "proxy:v42"),
                              env={"MLFLOW_ENABLED": "true",
                                   "GATEWAY_URL": "https://gw"})
        got.append(dataclasses.asdict(bundle.mutating_webhook.config))
    assert got[1] == got[0]
    assert got[1]["rbac_proxy_image"] == "proxy:v42"
    assert got[1]["controller_namespace"] == "opendatahub"
    assert got[1]["mlflow_enabled"]


def test_platform_build_without_argv_uses_a_placeholder_image():
    for jax in SIDES:
        m = make_side(jax)
        bundle = _mods(jax).pm.build(m.c, env={}, clock=m.clock)
        assert bundle.options.kube_rbac_proxy_image == "x"


def test_tls_watcher_requests_restart_on_change():
    got = []
    for jax in SIDES:
        m, bundle = _platform(jax, ("--kube-rbac-proxy-image", "p"), {})
        bundle.run_until_idle()
        assert bundle.restart_requested == []
        m.c.create({"apiVersion": "config.openshift.io/v1",
                    "kind": "APIServer", "metadata": {"name": "cluster"},
                    "spec": {"tlsSecurityProfile": {"type": "Modern"}}})
        bundle.run_until_idle()
        got.append([dataclasses.asdict(p) for p in bundle.restart_requested])
    assert got[1] == got[0] == [dataclasses.asdict(PTls.MODERN)]


def test_platform_leader_election_on_its_lease():
    for jax in SIDES:
        m, bundle = _platform(jax, ("--kube-rbac-proxy-image", "p",
                                    "--enable-leader-election"))
        assert bundle.elector.lease_name == "odh-notebook-controller"
        assert bundle.elector.namespace == "opendatahub"
        assert bundle.run_until_idle() >= 0 and bundle.elector.is_leader()


# -- the cache transform ---------------------------------------------------------


def _cm(name, labels=None, kind="ConfigMap"):
    return {"apiVersion": "v1", "kind": kind,
            "metadata": {"name": name, "namespace": "ns",
                         "labels": labels or {}},
            "data": {"k": "v" * 100}}


@pytest.mark.parametrize("obj", [
    _cm("random-cm"), _cm("odh-trusted-ca-bundle"),
    _cm("workbench-trusted-ca-bundle"), _cm("pipeline-runtime-images"),
    _cm("img", labels={"opendatahub.io/runtime-image": "true"}),
    _cm("feast", labels={"opendatahub.io/feast-integration": "true"}),
    _cm("ds-pipeline-config", kind="Secret"), _cm("other", kind="Secret"),
    _cm("pod", kind="Pod")])
def test_strip_payload_equals_jaxs(obj):
    got = PCa.strip_payload(obj)
    assert got == JCa.strip_payload(obj)
    assert PCa.default_keep(obj) == JCa.default_keep(obj)
    if obj["metadata"]["name"] in ("random-cm", "other"):
        assert "data" not in got
        assert got["metadata"]["annotations"][PCa.STRIPPED_MARK] == "true"
    assert "annotations" not in obj["metadata"]


def test_transforming_client_round_trip():
    got = []
    for jax in SIDES:
        m = _world(jax)
        client = _mods(jax).Ca.TransformingClient(m.c)
        client.create(_cm("random-cm"))
        client.create(_cm("odh-trusted-ca-bundle"))
        seen = [client.get("ConfigMap", "random-cm", "ns"),
                sorted((o["metadata"]["name"], "data" in o)
                       for o in client.list("ConfigMap", "ns")),
                client.exists("ConfigMap", "random-cm", "ns")]
        assert "data" in m.c.get("ConfigMap", "random-cm", "ns")
        client.patch("ConfigMap", "random-cm", "ns", {"data": {"k": "w"}})
        client.delete("ConfigMap", "random-cm", "ns")
        seen.append(client.exists("ConfigMap", "random-cm", "ns"))
        got.append(seen)
    assert got[1] == got[0]
    assert got[1][1] == [("odh-trusted-ca-bundle", True),
                         ("random-cm", False)]
    assert (PCa.DEFAULT_KEEP_NAMES, PCa.DEFAULT_KEEP_LABELS) == (
        JCa.DEFAULT_KEEP_NAMES, JCa.DEFAULT_KEEP_LABELS)
