"""The fleet: the port's gateway, telemetry plane, SLO engine and
autoscaler against the JAX package's, scenario by scenario.

Each test runs one scenario through the JAX module and through the
port's copy, under a fake clock and the same seed, and compares what
comes out:

- ``HashRing``: each key's node, the keys that move on a join and on a
  leave, and the successor walks;
- ``PrefixRouter``, ``chain_key`` and ``prompt_chain_keys``: the route
  key of every prompt of a seeded stream (shared system prompts, sub-block
  prompts, adapters, a router small enough to evict);
- the gateway's tenant-fair admission: the admit or shed decision of each
  request of a seeded stream of arrivals and releases, with its message
  and the gateway's counters;
- ``SignalHub``: rates, sums, gauge windows and histogram quantiles at
  each tick of a seeded event stream, and ``FleetTelemetry`` snapshots
  over replica scrapes (a counter reset included);
- ``SLOEngine``: burn rates, alerts and breach latches at each tick;
- ``FleetAutoscaler``: the decisions with their reasons, and the
  provisioner's calls, through a scripted fused and disagg run against
  the JAX suite's own fake gateway, telemetry and provisioner;
- the env parsers: the same configs, and the same refusals.

End to end, the port's ``ServingGateway`` and the JAX one, each in turn in
front of the same two port replicas (f32 ``tiny``, the prefix-cache
engine, on the CPU), give the same tokens, blocking and streamed, and the
same route for every request, fused and ``disagg`` (prefill on one
replica, decode on the other through ``/kv/*``).
"""

from __future__ import annotations

import hashlib
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from kubeflow_tpu.models import autoscaler as JA
from kubeflow_tpu.models import gateway as JG
from kubeflow_tpu.observability import signals as JSig
from kubeflow_tpu.observability import slo as JSlo
from kubeflow_tpu.observability import tracing as JT
from kubeflow_tpu_torch.models import autoscaler as PA
from kubeflow_tpu_torch.models import gateway as PG
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models import server as TS
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.observability import signals as PSig
from kubeflow_tpu_torch.observability import slo as PSlo
from kubeflow_tpu_torch.observability import tracing as PT
from tests.test_autoscaler import (
    EP0,
    EP1,
    EP2,
    EP3,
    FakeClock,
    FakeGateway,
    FakeProvisioner,
    FakeTelemetry,
    _slo,
)
from tests.test_torch_paged import _models

GATEWAY = {"jax": JG, "port": PG}
AUTOSCALER = {"jax": JA, "port": PA}
SIGNALS = {"jax": JSig, "port": PSig}
SLO = {"jax": JSlo, "port": PSlo}
TRACING = {"jax": JT, "port": PT}
BS = 8


def _both(scenario):
    """The scenario's output through the JAX module and the port's."""
    return scenario("jax"), scenario("port")


def _keys(n, salt=b""):
    return [hashlib.sha1(salt + str(i).encode()).digest() for i in range(n)]


# -- ring and router ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_ring_placement_and_movement_match_jax(seed):
    keys = _keys(1500)

    def scenario(fw):
        ring = GATEWAY[fw].HashRing(vnodes=64, seed=seed)
        for node in ("a:1", "b:1", "c:1"):
            ring.add(node)
        before = [ring.lookup(k) for k in keys]
        ring.add("d:1")
        joined = [ring.lookup(k) for k in keys]
        ring.remove("b:1")
        left = [ring.lookup(k) for k in keys]
        walks = [ring.successors(k, 3) for k in keys[:200]]
        return before, joined, left, walks, sorted(ring.nodes()), len(ring)

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    before, joined, left = port_out[:3]
    moved = [i for i in range(len(keys)) if before[i] != joined[i]]
    assert moved and all(joined[i] == "d:1" for i in moved)
    assert {joined[i] for i in range(len(keys))
            if joined[i] != left[i]} == {"b:1"}


def test_router_route_keys_match_jax():
    rng = np.random.default_rng(3)
    system = [int(t) for t in rng.integers(3, 250, size=40)]
    prompts = []
    for _ in range(120):
        kind = rng.integers(0, 3)
        tail = [int(t) for t in rng.integers(3, 250,
                                             size=int(rng.integers(1, 30)))]
        prompts.append(system[:int(rng.integers(8, 40))] + tail
                       if kind else tail)

    def scenario(fw):
        mod = GATEWAY[fw]
        out = []
        for block, entries in ((BS, 65536), (4, 16), (16, 65536)):
            router = mod.PrefixRouter(block_size=block, max_entries=entries)
            out.append([router.route_key(p).hex() for p in prompts])
            out.append([[k.hex() for k in mod.prompt_chain_keys(p, block)]
                        for p in prompts[:30]])
        out.append([mod.chain_key(None, p[:BS], adapter).hex()
                    for p in prompts[:20] for adapter in (None, 3, 11)])
        return out

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    # The port's engine keys its blocks with the same chain.
    p = prompts[0]
    assert (PG.chain_key(None, p[:BS])
            == TP.PagedBatcher._chain_key(None, p[:BS]))


def test_tenant_fair_shed_decisions_match_jax():
    """A seeded stream of arrivals and completions from five tenants of
    uneven weight against a gateway of capacity 6: every admit or shed,
    its message, and the in-flight and shed counters after each event."""
    rng = np.random.default_rng(11)
    events = []
    for _ in range(400):
        if rng.random() < 0.55:
            events.append(("admit", str(rng.choice(
                ["heavy", "heavy", "heavy", "mid", "mid", "a", "b", "c"]))))
        else:
            events.append(("release", None))

    def scenario(fw):
        gw = GATEWAY[fw].ServingGateway([], port=0, max_inflight=6)
        try:
            live, out = [], []
            for kind, tenant in events:
                if kind == "release":
                    if live:
                        gw._release(live.pop(0))
                    out.append("release")
                    continue
                try:
                    gw._admit(tenant)
                    live.append(tenant)
                    out.append(("admit", tenant))
                except Exception as err:  # GatewayOverloadedError
                    out.append((type(err).__name__, str(err)))
            st = gw.stats()
            return out, st["shed"], st["inflight"]
        finally:
            gw.stop()

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    assert port_out[1] > 0
    assert any(o[0] == "GatewayOverloadedError" and "fair share" in o[1]
               for o in port_out[0] if isinstance(o, tuple))


# -- telemetry plane ----------------------------------------------------------


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _event_stream(seed, n=600):
    rng = np.random.default_rng(seed)
    t, out = 1000.0, []
    for _ in range(n):
        t += float(rng.exponential(0.7))
        kind = int(rng.integers(0, 3))
        child = (None, "t0", "t1")[int(rng.integers(0, 3))]
        value = float(rng.lognormal(-1.5, 0.8))
        out.append((t, kind, child, value))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_signal_hub_windows_and_quantiles_match_jax(seed):
    events = _event_stream(seed)

    def scenario(fw):
        clock = _Clock()
        hub = SIGNALS[fw].SignalHub(window_s=10.0, windows=12, clock=clock,
                                    samples_per_window=16)
        out = []
        for i, (t, kind, child, value) in enumerate(events):
            clock.t = t
            if kind == 0:
                hub.inc("reqs", value, child=child)
            elif kind == 1:
                hub.set_gauge("qw", value, child=child or "r0")
            else:
                hub.observe("ttft", value, child=child)
            if i % 25 == 0:
                out.append([
                    hub.rate("reqs", 60.0), hub.rate("reqs", 30.0, "t0"),
                    hub.counter_sum("reqs", 120.0),
                    hub.counter_total("reqs"),
                    hub.gauge_last("qw", "r0"),
                    hub.gauge_windows_over("qw", 0.3, 60.0),
                    [hub.quantile("ttft", q, 60.0)
                     for q in (0.5, 0.95, 0.99)],
                    hub.quantile("ttft", 0.95, 120.0, child="t1"),
                    hub.fraction_over("ttft", 0.25, 60.0),
                    hub.event_count("ttft", 60.0),
                    sorted(map(str, hub.counter_children("reqs"))),
                ])
        return out

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out


def test_fleet_telemetry_snapshots_match_jax():
    rng = np.random.default_rng(5)

    def scenario(fw):
        clock = _Clock()
        tel = SIGNALS[fw].FleetTelemetry(
            SIGNALS[fw].SignalsConfig(window_s=10.0, windows=12,
                                      top_k_tenants=2), clock=clock)
        out, served = [], {EP0: 0, EP1: 0}
        rng_local = np.random.default_rng(5)
        for step in range(60):
            clock.t += 2.5
            tenant = f"t{int(rng_local.integers(0, 4))}"
            tel.observe_request(tenant, ok=bool(rng_local.random() > 0.1),
                                ttft_s=float(rng_local.random()),
                                inter_token=[0.01 * (step % 5)],
                                e2e_s=1.0)
            if step % 7 == 0:
                tel.observe_shed(tenant)
            for ep in (EP0, EP1):
                served[ep] += int(rng_local.integers(0, 5))
                if ep == EP1 and step == 30:
                    served[ep] = 1  # a restart resets its counters
                tel.ingest_replica(ep, {
                    "requests": served[ep], "active_slots": step % 4,
                    "queued": step % 3, "queue_wait_p95_s": 0.1 * (step % 6),
                    "ragged": {"fill": 0.5}, "tier_role": "fused"})
            if step % 10 == 9:
                out.append([tel.snapshot(), tel.scrape_ages(),
                            tel.evaluate_slo()])
        return out

    del rng
    jax_out, port_out = _both(scenario)
    assert port_out == jax_out


@pytest.mark.parametrize("seed", [2, 3])
def test_slo_burn_rates_and_alerts_match_jax(seed):
    rng = np.random.default_rng(seed)
    # Calm, then a latency and error storm, then calm again.
    ticks = []
    for i in range(240):
        storm = 80 <= i < 150
        ticks.append([(float(rng.lognormal(-0.5 if storm else -2.0, 0.6)),
                       bool(rng.random() < (0.3 if storm else 0.01)))
                      for _ in range(int(rng.integers(1, 6)))])

    class _Metrics:
        def __init__(self):
            self.calls = []
            outer = self

            class _Family:
                def __init__(self, name):
                    self.name = name

                def labels(self, **kw):
                    fam = self

                    class _Child:
                        def inc(self, v=1.0):
                            outer.calls.append((fam.name, "inc", kw, v))

                        def set(self, v):
                            outer.calls.append((fam.name, "set", kw, v))
                    return _Child()

            self.slo_breach_total = _Family("breach")
            self.slo_burn_rate = _Family("burn")

    def scenario(fw):
        clock = _Clock()
        hub = SIGNALS[fw].SignalHub(window_s=10.0, windows=200, clock=clock)
        metrics = _Metrics()
        eng = SLO[fw].SLOEngine(hub, SLO[fw].default_objectives(),
                                clock=clock, metrics=metrics)
        reports = []
        for batch in ticks:
            clock.t += 10.0
            for lat, bad in batch:
                hub.observe("ttft_s", lat)
                hub.observe("inter_token_s", lat / 5)
                hub.inc("requests")
                if bad:
                    hub.inc("bad_requests")
            hub.set_gauge("replica_queue_wait_p95_s", lat, child=EP0)
            reports.append(eng.evaluate())
        return reports, metrics.calls

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    reports = port_out[0]
    assert any(r["breaching"] for r in reports)
    assert not reports[-1]["breaching"] or reports[-1] != reports[100]


# -- autoscaler ---------------------------------------------------------------


def _cfg(fw, **kw):
    base = dict(
        min_replicas=1, max_replicas=4, up_consecutive=2,
        down_consecutive=3, up_cooldown_s=5.0, down_cooldown_s=5.0,
        max_actions_per_window=4, actions_window_s=60.0,
        drain_budget_s=30.0, stale_after_s=10.0, claim_backoff_base_s=2.0,
        claim_backoff_max_s=60.0, claim_backoff_jitter=0.25)
    base.update(kw)
    return AUTOSCALER[fw].AutoscalerConfig(**base)


def _scaler(fw, n, *, tier_mode="fused", roles=None, **cfg_kw):
    clock = FakeClock()
    tel = FakeTelemetry(clock)
    gw = FakeGateway(tel)
    gw.tier_mode = tier_mode
    for i, ep in enumerate([EP0, EP1, EP2, EP3][:n]):
        gw.add(ep, role=roles[i] if roles else "fused")
    prov = FakeProvisioner()
    rolls = iter(np.random.default_rng(9).random(1000).tolist())
    scaler = AUTOSCALER[fw].FleetAutoscaler(
        gw, _cfg(fw, **cfg_kw), provisioner=prov, clock=clock,
        rng=lambda: next(rolls))
    return scaler, gw, tel, prov, clock


def _run_script(scaler, gw, tel, prov, clock, script):
    log = []
    for step in script:
        step(gw, tel, prov, clock)
        log.append(scaler.tick())
        clock.advance(1.0)
    debug = scaler.debug()
    debug["claim_latency_s"] = None  # a host clock, not the fake one
    return log, debug, prov.claims, prov.drains, prov.releases, gw.begun, \
        gw.removed, tel.actions


def _set(**kw):
    def step(gw, tel, prov, clock):
        for key, value in kw.items():
            if key == "slo":
                tel.slo = value
            elif key == "fleet":
                tel.fleet = value
            elif key == "claim":
                prov.claim_result = value
            elif key == "drained":
                prov.drained_eps.add(value)
            elif key == "age":
                tel.ages.update(value)
            elif key == "active":
                for ep, n in value.items():
                    gw.replicas[ep]["stats"]["active_slots"] = n
            elif key == "advance":
                clock.advance(value)
    return step


def test_autoscaler_fused_decisions_match_jax():
    """Ramp, cooldown hold, claim failures with jittered backoff, a
    stale-scrape freeze and thaw, then an ebb that drains and releases."""
    hot = _slo(ttft=(1.5, 1.2))
    script = (
        [_set(slo=hot)] * 2 + [_set()] * 3            # ramp, cooldown hold
        + [_set(claim=None)] * 2 + [_set(advance=2.0)] * 3   # backoff
        + [_set(claim="pool/warm-1", advance=10.0)] * 2
        + [_set(age={EP1: 99.0})] * 2 + [_set(age={EP1: 0.0})]  # freeze
        + [_set(slo=_slo(), active={EP0: 3})] * 4      # ebb → drain EP1
        + [_set()] + [_set(drained=EP1)] + [_set()] * 2  # release
        + [_set(advance=31.0)] * 4                      # next ebb, budget
    )

    def scenario(fw):
        return _run_script(*_scaler(fw, 2), script)

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    actions = [d["action"] for tick in port_out[0] for d in tick]
    for want in ("scale_up", "hold", "freeze", "scale_down", "release"):
        assert want in actions, actions


def test_autoscaler_disagg_decisions_match_jax():
    """A long-prompt storm grows prefill alone; decode pressure grows
    decode alone; a decode member's queue never grows prefill; then the
    tiers ebb on their own."""
    script = (
        [_set(slo=_slo(ttft=(2.0, 1.6)),
              fleet={"replica_queue_wait_p95_s": {EP0: 0.9}})] * 3
        + [_set(slo=_slo(inter=(1.4, 1.1)), fleet={})] * 3
        + [_set(slo=_slo(),
                fleet={"replica_queue_wait_p95_s": {EP2: 0.9}})] * 3
        + [_set(fleet={})] * 6 + [_set(advance=40.0)] * 3
    )

    def scenario(fw):
        return _run_script(*_scaler(
            fw, 4, tier_mode="disagg",
            roles=["prefill", "prefill", "decode", "decode"],
            down_consecutive=2), script)

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    ups = [d["tier"] for tick in port_out[0] for d in tick
           if d["action"] == "scale_up"]
    assert ups[:2] == ["prefill", "decode"]


# -- env contract ---------------------------------------------------------------


ENV_CASES = [
    {},
    {"KUBEFLOW_TPU_SIGNALS_ENABLE": "1", "KUBEFLOW_TPU_SIGNALS_WINDOW_S": "5",
     "KUBEFLOW_TPU_SIGNALS_WINDOWS": "30",
     "KUBEFLOW_TPU_SIGNALS_TENANTS": "3",
     "KUBEFLOW_TPU_SLO_TTFT_P95_MS": "250",
     "KUBEFLOW_TPU_SLO_FAST_BURN": "10"},
    {"KUBEFLOW_TPU_SIGNALS_ENABLE": "maybe"},
    {"KUBEFLOW_TPU_SLO_ERROR_BUDGET": "2"},
    {"KUBEFLOW_TPU_AUTOSCALE_ENABLE": "true",
     "KUBEFLOW_TPU_AUTOSCALE_MIN_REPLICAS": "2",
     "KUBEFLOW_TPU_AUTOSCALE_MAX_REPLICAS": "6",
     "KUBEFLOW_TPU_AUTOSCALE_DRAIN_BUDGET_S": "12.5"},
    {"KUBEFLOW_TPU_AUTOSCALE_ENABLE": "1",
     "KUBEFLOW_TPU_AUTOSCALE_MAX_REPLICAS": "-3"},
    {"KUBEFLOW_TPU_GATEWAY_PORT": "0",
     "KUBEFLOW_TPU_GATEWAY_REPLICAS": "127.0.0.1:1,127.0.0.1:2",
     "KUBEFLOW_TPU_GATEWAY_AFFINITY": "random",
     "KUBEFLOW_TPU_GATEWAY_HASH_SEED": "4",
     "KUBEFLOW_TPU_GATEWAY_REROUTE_BUDGET": "1",
     "KUBEFLOW_TPU_GATEWAY_TIER_MODE": "disagg",
     "KUBEFLOW_TPU_GATEWAY_TIER_PREFILL": "127.0.0.1:1",
     "KUBEFLOW_TPU_GATEWAY_TIER_DECODE": "127.0.0.1:2,127.0.0.1:3",
     "KUBEFLOW_TPU_KV_PEER_FANOUT": "2"},
    {"KUBEFLOW_TPU_GATEWAY_AFFINITY": "sticky"},
    {"KUBEFLOW_TPU_GATEWAY_TIER_PREFILL": "127.0.0.1:1",
     "KUBEFLOW_TPU_GATEWAY_TIER_DECODE": "127.0.0.1:1"},
    {"KUBEFLOW_TPU_KV_TRANSFER_TIMEOUT_S": "0"},
]


def _env_outcome(call):
    try:
        return "ok", call()
    except ValueError as err:
        return "ValueError", str(err)


@pytest.mark.parametrize("env", ENV_CASES, ids=range(len(ENV_CASES)))
def test_env_parsers_match_jax(monkeypatch, env):
    monkeypatch.setenv("KUBEFLOW_TPU_GATEWAY_PORT", "0")
    for name, value in env.items():
        monkeypatch.setenv(name, value)

    def scenario(fw):
        out = [
            _env_outcome(lambda: SIGNALS[fw].signals_from_env()),
            _env_outcome(lambda: SLO[fw].slo_from_env()),
            _env_outcome(lambda: AUTOSCALER[fw].autoscaler_from_env()),
        ]
        out = [(k, v.__dict__ if hasattr(v, "__dict__") else v)
               for k, v in out]
        if "KUBEFLOW_TPU_AUTOSCALE_ENABLE" in env:
            return out  # the gateway half is the next test's
        kind, got = _env_outcome(lambda: GATEWAY[fw].gateway_from_env())
        if kind == "ok":
            gw = got
            try:
                got = (gw.stats(), gw.reroute_budget, gw.kv_peer_fanout,
                       sorted(gw._tier_roles.items()))
            finally:
                gw.stop()
        out.append((kind, got))
        return out

    jax_out, port_out = _both(scenario)

    def norm(out):
        # Dataclass configs compare by their fields; objectives by theirs.
        return json.loads(json.dumps(out, default=lambda o: getattr(
            o, "__dict__", repr(o))))

    assert norm(port_out) == norm(jax_out)


def test_gateway_from_env_with_autoscaling_needs_a_replica_source(
        monkeypatch):
    """With the autoscaler on from the env and no replica source, both
    packages build a gateway whose autoscaler can never scale up
    (``scale_up`` returns None), as JAX's does; the port's warm-slice
    source is ``WarmSliceReplicaSource`` (tests/test_torch_slicepool.py).
    Given a source, both build the same gateway, and ``scale_up`` with no
    source returns None in both."""
    monkeypatch.setenv("KUBEFLOW_TPU_AUTOSCALE_ENABLE", "1")
    monkeypatch.setenv("KUBEFLOW_TPU_GATEWAY_PORT", "0")
    for mod in (JG, PG):
        gw = mod.gateway_from_env()
        try:
            assert gw.autoscaler is not None and gw.scale_up() is None
            assert gw.replica_source is None
        finally:
            gw.stop()

    class Source:
        def __init__(self):
            self.claims = []

        def acquire(self, now=None):
            self.claims.append(now)
            return "pool/warm-0"

    gws = []
    try:
        for mod in (JG, PG):
            src = Source()
            gw = mod.gateway_from_env(replica_source=src)
            gws.append(gw)
            assert gw.autoscaler is not None
            assert gw.scale_up(now=5.0) == "pool/warm-0"
            assert src.claims == [5.0]
        monkeypatch.delenv("KUBEFLOW_TPU_AUTOSCALE_ENABLE")
        bare = PG.gateway_from_env()
        gws.append(bare)
        assert bare.autoscaler is None and bare.scale_up() is None
    finally:
        for gw in gws:
            gw.stop()


# -- end to end: both gateways in front of the same port replicas -------------


@pytest.fixture(scope="module")
def replicas():
    """Two port replicas of f32 ``tiny`` (the prefix-cache paged engine)."""
    torch.set_num_threads(1)
    _, tcfg, _, tparams = _models("tiny", "f32")
    servers = []
    for _ in range(2):
        eng = TP.PagedBatcher(
            tparams, tcfg, gen=TGen(max_new_tokens=6, eos_id=-1), slots=2,
            num_blocks=64, block_size=BS, prompt_bucket=64,
            prefix_cache=True, device="cpu")
        servers.append(TS.InferenceServer(eng, port=0,
                                          drain_s=0.5).start())
    yield [f"{s.host}:{s.port}" for s in servers]
    for s in servers:
        s.stop()


SYSTEM = [7, 31, 62, 5, 90, 14, 27, 3, 44, 19, 8, 66, 71, 2, 9, 11, 53, 38]
FLEET_PROMPTS = [SYSTEM + [100 + i, 4, 4 + i] for i in range(4)] + [
    [200, 201, 202], [9, 9, 9, 9, 9, 9, 9, 9, 9, 1], [150] * 12]


def _post(gw, body):
    req = urllib.request.Request(
        f"http://{gw.host}:{gw.port}/v1/completions",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read().decode()
        rid = resp.headers["X-Request-Id"]
    if not body.get("stream"):
        return rid, json.loads(raw)["choices"][0]["tokens"]
    events = [line[6:] for line in raw.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return rid, [json.loads(e)["token"] for e in events[:-1]]


def _drive(fw, eps, tier_mode):
    """Every prompt through ``fw``'s gateway, blocking then streamed:
    (tokens, routes) in order, the routes read off the gateway's own
    spans."""
    mod, tr = GATEWAY[fw], TRACING[fw]
    exp = tr.InMemoryExporter()
    tr.set_tracer_provider(tr.TracerProvider(exp))
    roles = ({eps[0]: "prefill", eps[1]: "decode"}
             if tier_mode == "disagg" else None)
    gw = mod.ServingGateway(eps, port=0, block_size=BS,
                            health_interval_s=0.2, tier_mode=tier_mode,
                            tier_roles=roles).start()
    try:
        tokens, routes = [], []
        for p in FLEET_PROMPTS:
            for stream in (False, True):
                rid, toks = _post(gw, {"prompt": p, "max_tokens": 6,
                                       "stream": stream})
                tokens.append(toks)
                # The root span ends once the relay has finished.
                deadline = time.monotonic() + 30
                while not any(s.trace_id == rid and s.name ==
                              "gateway.request" for s in exp.spans):
                    assert time.monotonic() < deadline, rid
                    time.sleep(0.01)
                spans = [s for s in exp.spans if s.trace_id == rid]
                route = sorted(
                    (s.name, k, v) for s in spans
                    for k, v in s.attributes.items()
                    if k in ("endpoint", "prefill_endpoint",
                             "decode_endpoint"))
                routes.append(route)
        stats = gw.stats()
        return tokens, routes, stats["kv_transfers"], stats["requests"]
    finally:
        gw.stop()
        tr.set_tracer_provider(tr.TracerProvider())


@pytest.mark.parametrize("tier_mode", ["fused", "disagg"])
def test_port_gateway_routes_and_serves_as_jax_s(replicas, tier_mode):
    jax_out = _drive("jax", replicas, tier_mode)
    port_out = _drive("port", replicas, tier_mode)
    assert port_out == jax_out
    tokens, routes, transfers, requests = port_out
    assert all(len(t) == 6 for t in tokens)
    assert tokens[0::2] == tokens[1::2]  # streamed = blocking
    assert requests == 2 * len(FLEET_PROMPTS)
    if tier_mode == "fused":
        assert transfers == 0
        # The prompts that share the system prompt land on one replica
        # from the second on (the first one routes by its own chain).
        shared = {r[0][2] for r in routes[2:8]}
        assert len(shared) == 1
        assert all(r and r[0][:2] == ("gateway.route", "endpoint")
                   for r in routes)
    else:
        # A streamed request prefills on the prefill tier and decodes on
        # the decode tier; a blocking one takes the fused route.
        assert transfers == len(FLEET_PROMPTS)
        for r in routes[1::2]:
            assert r == [("gateway.route", "decode_endpoint", replicas[1]),
                         ("gateway.route", "prefill_endpoint", replicas[0]),
                         ("kv_transfer", "endpoint", replicas[1])]
        assert all(r[0][:2] == ("gateway.route", "endpoint")
                   for r in routes[0::2])
