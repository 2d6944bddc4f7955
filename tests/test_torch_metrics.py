"""The port's metrics bundle and registry against the JAX package's, on the
CPU.

The same incs, sets and observes go to JAX's ``Metrics`` (over
``prometheus_client``) and to the port's (over its own registry), and the
two expositions must be equal line by line: every HELP and TYPE line,
every sample's name, labels and value. Only two things are replaced:

- the values of ``_created`` samples, a wall clock at each series'
  creation; their names and labels must be there on both sides;
- the HELP strings of ``tpu_chips_in_use`` and
  ``tpu_chips_reclaimed_total`` (and their ``_created``), which say
  "GPU cards" in the port where JAX's say "TPU chips".

Also: ``collect_running`` over the same StatefulSets (``nvidia.com/gpu``
limits for ``google.com/tpu``), the ``STATS_PARITY`` table, the errors of
misuse, ``get_sample_value``, and the ``/metrics`` endpoint over HTTP.
"""

from __future__ import annotations

import re
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu.k8s.fake import FakeCluster as JCluster
from kubeflow_tpu.metrics import metrics as JMm
from kubeflow_tpu.metrics import server as JSrv
from kubeflow_tpu_torch.k8s.fake import FakeCluster as PCluster
from kubeflow_tpu_torch.metrics import metrics as PMm
from kubeflow_tpu_torch.metrics import registry as PR
from kubeflow_tpu_torch.metrics import server as PSrv

CHIP_FAMILIES = ("tpu_chips_in_use", "tpu_chips_reclaimed_total",
                 "tpu_chips_reclaimed_created")
CREATED = re.compile(r"^(\S*_created(\{[^}]*\})?) (\S+)$")


def _lines(text: str, port: bool) -> list[str]:
    out = []
    for line in text.splitlines():
        m = CREATED.match(line)
        if m:
            float(m.group(3))  # a number on both sides
            line = f"{m.group(1)} <created>"
        if port and line.startswith("# HELP ") and line.split()[2] in (
                CHIP_FAMILIES):
            assert "GPU cards" in line, line
            line = line.replace("GPU cards", "TPU chips")
        out.append(line)
    return out


def _expose(metrics) -> str:
    return metrics.expose().decode()


def _apply(m, script):
    for path, method, args in script:
        target = m
        for part in path:
            target = (target.labels(*part) if isinstance(part, tuple)
                      else getattr(target, part))
        getattr(target, method)(*args)


SCRIPTS = {
    "fresh": [],
    "counters": [
        (("create_total",), "inc", ()),
        (("create_total",), "inc", (2.5,)),
        (("culling_total",), "inc", (0,)),
        (("chips_reclaimed_total",), "inc", (32,)),
        (("serving_kv_transfer_bytes_total",), "inc", (12345678901,)),
    ],
    "gauges": [
        (("last_culling_timestamp",), "set", (1_700_000_123.25,)),
        (("serving_queue_depth",), "set", (7,)),
        (("serving_queue_depth",), "set", (8.5,)),
        (("serving_ragged_batch_fill",), "set", (0.1 + 0.2,)),
        (("serving_kv_swap_bytes",), "set", (1e-7,)),
        (("migration_seconds",), "set", (-3.0,)),
        (("serving_drain_seconds",), "set", (float("inf"),)),
    ],
    "labels": [
        (("pool_warm_ready", ("p1",)), "set", (2,)),
        (("pool_warm_ready", ("p0",)), "set", (1,)),
        (("pool_warm_ready",), "remove", ("p1",)),
        (("pool_warm_ready",), "remove", ("never",)),
        (("pool_warm_ready", ("p1",)), "set", (3,)),
        (("gateway_shed_total", ('a"b\\c\nd',)), "inc", (4,)),
        (("gateway_shed_total", ("other",)), "inc", ()),
        (("slo_burn_rate", ("ttft", "5m")), "set", (1.5,)),
        (("slo_burn_rate", ("itl", "1h")), "set", (0.25,)),
        (("slo_breach_total", ("ttft",)), "inc", ()),
        (("autoscaler_replicas", (7,)), "set", (3,)),
    ],
    "histograms": [
        (("slice_ready_seconds",), "observe", (5,)),
        (("slice_ready_seconds",), "observe", (5.000001,)),
        (("slice_ready_seconds",), "observe", (0,)),
        (("slice_ready_seconds",), "observe", (601,)),
        (("slice_ready_seconds",), "observe", (1e12,)),
        (("slice_recovery_seconds",), "observe", (3600,)),
        (("checkpoint_save_seconds",), "observe", (0.1,)),
        (("checkpoint_save_seconds",), "observe", (-1,)),
    ],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_exposition_equals_jax_sample_by_sample(name):
    jm, pm = JMm.Metrics(), PMm.Metrics()
    _apply(jm, SCRIPTS[name])
    _apply(pm, SCRIPTS[name])
    jt, pt = _expose(jm), _expose(pm)
    assert _lines(pt, True) == _lines(jt, False)
    assert pt != jt  # the _created values and the two HELP strings
    assert pt.endswith("\n") and len(pt.splitlines()) > 300


def test_every_created_series_is_named_on_both_sides():
    jm, pm = JMm.Metrics(), PMm.Metrics()
    for m in (jm, pm):
        _apply(m, SCRIPTS["labels"] + SCRIPTS["histograms"])
    names = [[m.group(1) for m in map(CREATED.match, t.splitlines()) if m]
             for t in (_expose(jm), _expose(pm))]
    assert names[1] == names[0] and len(names[0]) > 40


def test_help_replacement_is_the_only_help_that_differs():
    jt, pt = _expose(JMm.Metrics()), _expose(PMm.Metrics())
    jh = [x for x in jt.splitlines() if x.startswith("# HELP")]
    ph = [x for x in pt.splitlines() if x.startswith("# HELP")]
    differ = [(a, b) for a, b in zip(jh, ph) if a != b]
    assert [b.split()[2] for _, b in differ] == [
        "tpu_chips_reclaimed_total", "tpu_chips_reclaimed_created",
        "tpu_chips_in_use"]
    assert all("TPU chips" in a and "GPU cards" in b for a, b in differ)


def test_stats_parity_table_equals_jax():
    assert PMm.STATS_PARITY == JMm.STATS_PARITY
    assert list(PMm.STATS_PARITY) == list(JMm.STATS_PARITY)


def _sts(name, replicas, resource, per_host, ns="ns"):
    return {"apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"replicas": replicas, "template": {"spec": {
                "containers": [
                    {"name": "main", "resources": {"limits": {
                        resource: str(per_host)}}},
                    {"name": "side"}]}}}}


@pytest.mark.parametrize("fleet", [
    [],
    [(4, 8)],
    [(4, 8), (0, 8), (1, 1), (2, 0)],
    [(1, 4), (3, 8), (1, 2)],
])
def test_collect_running_counts_cards_as_jax_counts_chips(fleet):
    out = []
    for cluster_cls, metrics_mod, resource in (
            (JCluster, JMm, "google.com/tpu"),
            (PCluster, PMm, "nvidia.com/gpu")):
        c = cluster_cls()
        for i, (replicas, per_host) in enumerate(fleet):
            c.create(_sts(f"s{i}", replicas, resource, per_host,
                          ns=f"ns{i % 2}"))
        m = metrics_mod.Metrics(c)
        out.append(_lines(_expose(m), metrics_mod is PMm))
        out.append((m.registry.get_sample_value("notebook_running"),
                    m.registry.get_sample_value("tpu_chips_in_use")))
    assert out[2] == out[0] and out[3] == out[1]
    assert out[3][1] == sum(r * h for r, h in fleet)
    # A bundle without a client leaves the gauges where they were.
    pm = PMm.Metrics()
    pm.running.set(5)
    pm.collect_running()
    assert pm.registry.get_sample_value("notebook_running") == 5


def _error(fn):
    try:
        fn()
    except Exception as err:
        return type(err).__name__, str(err)
    return None


def test_misuse_raises_as_jax():
    for call in (
            lambda m: m.create_total.inc(-1),
            lambda m: m.pool_warm_ready.set(1),
            lambda m: m.pool_warm_ready.labels("a", "b"),
            lambda m: m.pool_warm_ready.labels(pool="a", x="b"),
            lambda m: m.pool_warm_ready.labels("a", pool="a"),
            lambda m: m.pool_warm_ready.remove(),
            lambda m: m.create_total.labels("a"),
            lambda m: m.create_total.remove("a"),
    ):
        got, want = _error(lambda: call(PMm.Metrics())), _error(
            lambda: call(JMm.Metrics()))
        assert got is not None and got[0] == want[0]
    assert PMm.Metrics().pool_warm_ready.labels(pool="a") is not None
    with pytest.raises(ValueError, match="sorted"):
        PR.Histogram("h", "d", buckets=(2, 1))


def test_get_sample_value_equals_jax():
    jm, pm = JMm.Metrics(), PMm.Metrics()
    for m in (jm, pm):
        _apply(m, SCRIPTS["labels"] + SCRIPTS["histograms"]
               + SCRIPTS["counters"])
    for name, labels in (
            ("notebook_create_total", None),
            ("notebook_create_created", None),
            ("tpu_slicepool_warm_ready", {"pool": "p1"}),
            ("tpu_slicepool_warm_ready", {"pool": "never"}),
            ("tpu_slice_ready_seconds_bucket", {"le": "5.0"}),
            ("tpu_slice_ready_seconds_bucket", {"le": "+Inf"}),
            ("tpu_slice_ready_seconds_count", None),
            ("tpu_slice_ready_seconds_sum", None),
            ("tpu_slo_burn_rate", {"objective": "ttft", "window": "5m"}),
            ("no_such_family", None)):
        want = jm.registry.get_sample_value(name, labels)
        got = pm.registry.get_sample_value(name, labels)
        if name.endswith("_created"):
            assert (got is None) == (want is None)
        else:
            assert got == want, name


@pytest.mark.parametrize("value", [0.0, 1.0, -2.5, 1e-7, 123456.0, 1234567.0,
                                   12345678.0, 1.7e9, 2.0 ** 70, 0.1 + 0.2,
                                   float("inf"), float("-inf"), float("nan")])
def test_go_float_equals_prometheus_client(value):
    from prometheus_client.utils import floatToGoString

    assert PR.go_float(value) == floatToGoString(value)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers["Content-Type"], err.read()


def test_metrics_server_equals_jax_over_http():
    out = []
    for srv_mod, metrics_mod, cluster_cls, resource in (
            (JSrv, JMm, JCluster, "google.com/tpu"),
            (PSrv, PMm, PCluster, "nvidia.com/gpu")):
        c = cluster_cls()
        c.create(_sts("s", 2, resource, 8))
        m = metrics_mod.Metrics(c)
        m.create_total.inc()
        srv = srv_mod.MetricsServer(m, port=0)
        srv.start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            ok = _get(base + "/metrics")
            slash = _get(base + "/")
            missing = _get(base + "/other")
            m.collect_running = lambda: (_ for _ in ()).throw(
                RuntimeError("list failed"))
            broken = _get(base + "/metrics")
        finally:
            srv.stop()
        port = metrics_mod is PMm
        out.append([(ok[0], ok[1], _lines(ok[2].decode(), port)),
                    (slash[0], _lines(slash[2].decode(), port)),
                    missing, broken])
    assert out[1] == out[0]
    assert out[1][0][0] == 200 and out[1][2][0] == 404
    assert out[1][3][:2] == (500, PR.CONTENT_TYPE)
    assert "tpu_chips_in_use 16.0" in out[1][0][2]
