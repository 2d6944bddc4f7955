"""The port's server observability against the JAX server's, on the CPU.

JAX and port servers over the same f32 ``tiny`` weights (the port's
through the bridge) take the same traffic, one request at a time, so both
engines run the same schedule:

- tracing: the spans of each sent trace (names, parent links, attribute
  keys, event names, status) are equal, as are the ``engine.step`` spans
  (roots, one a quantum, equal attribute keys) and ``/debug/traces``;
- ``/stats``: the ``flight`` block has the same keys and the same step
  count, and ``engine_step_stalls`` is there;
- metrics: one of the JAX package's Prometheus ``Metrics`` bundles a
  server; every ``STATS_PARITY`` family the server mirrors reads the same
  sample on both (shed, cancel, deadline, queue depth, ragged fill, stall,
  prefix cache, swap, speculation and the LoRA hot cache), and the port's
  samples equal its own ``/stats``.

Everything compared is exact; servers bind port 0, every HTTP call has a
timeout, and every server is stopped.
"""

from __future__ import annotations

import json
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.metrics.metrics import STATS_PARITY, Metrics
from kubeflow_tpu.models import lora as JL
from kubeflow_tpu.models import multilora as JM
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models import server as JS
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu.observability import tracing as JT
from kubeflow_tpu_torch.models import lora as TLo
from kubeflow_tpu_torch.models import multilora as TM
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models import server as TS
from kubeflow_tpu_torch.models.bridge import lora_from_jax
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.observability import tracing as TT
from tests.test_torch_multilora import LCFG, NAMES, _adapter
from tests.test_torch_paged import _models
from tests.test_torch_speculative import _spec_pair

TIMEOUT = 60
PROMPTS = [[5, 9, 17, 33], [7, 1, 200, 3, 99], [250, 4, 4, 8, 8, 8]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny", "f32")


def _paged(tiny, max_new=4, **kw):
    jcfg, tcfg, jparams, tparams = tiny
    kw = {"slots": 2, "num_blocks": 32, "block_size": 8, "prompt_bucket": 16,
          "ragged": True, "token_budget": 16, **kw}
    if not kw["ragged"]:
        kw.pop("token_budget")
    return (JP.PagedBatcher(jparams, jcfg, gen=JGen(max_new_tokens=max_new,
                                                    eos_id=-1),
                            attn_kernel=False, **kw),
            TP.PagedBatcher(tparams, tcfg, gen=TGen(max_new_tokens=max_new,
                                                    eos_id=-1),
                            device="cpu", **kw))


def _post(port, body, traceparent=None):
    headers = {"Content-Type": "application/json"}
    if traceparent:
        headers["traceparent"] = traceparent
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(), method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.headers.get("X-Request-Id"), resp.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def _wait_for(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {fn}")


# -- tracing -------------------------------------------------------------------


def _traffic(srv, tids):
    """One blocking and one streamed request, each under its own sent
    trace, one after the other; returns the X-Request-Id headers."""
    ids = []
    for tid, (prompt, stream) in zip(tids, ((PROMPTS[0], False),
                                            (PROMPTS[1], True))):
        req_id, _ = _post(srv.port, {"prompt": prompt, "stream": stream},
                          traceparent=f"00-{tid}-{'cd' * 8}-01")
        ids.append(req_id)
    return ids


def _shape(spans, tid):
    """A trace's spans as (name, parent's name, attribute keys, event
    names, status), sorted: the remote parent reads "remote"."""
    mine = [s for s in spans if s.trace_id == tid]
    names = {s.span_id: s.name for s in mine}
    return sorted(
        (s.name, "remote" if s.parent_id == "cd" * 8
         else names.get(s.parent_id, s.parent_id),
         tuple(sorted(s.attributes)), tuple(e["name"] for e in s.events),
         s.status) for s in mine)


def _serve_traced(mod, server_mod, engine, tids):
    exporter, ring = mod.InMemoryExporter(), mod.RingBufferExporter(512)
    mod.set_tracer_provider(mod.TracerProvider(exporter, exporters=[ring]))
    srv = server_mod.InferenceServer(engine, port=0).start()
    try:
        ids = _traffic(srv, tids)
        _wait_for(lambda: sum(s.name == "server.request"
                              for s in exporter.spans) == len(tids))
        stats = _get(srv.port, "/stats")
        traces = _get(srv.port, "/debug/traces")["traces"]
    finally:
        srv.stop()
        mod.set_tracer_provider(mod.TracerProvider())
    return ids, list(exporter.spans), stats, traces


@pytest.mark.parametrize("ragged", [True, False],
                         ids=["ragged", "alternating"])
def test_spans_and_flight_equal_jax(tiny, ragged):
    jeng, teng = _paged(tiny, ragged=ragged)
    tids = ["ab" * 16, "ef" * 16]
    jids, jspans, jstats, jtraces = _serve_traced(JT, JS, jeng, tids)
    tids_, tspans, tstats, ttraces = _serve_traced(TT, TS, teng, tids)
    # The responses carry the sent trace ids.
    assert tids_ == jids == tids
    for tid in tids:
        want = _shape(jspans, tid)
        assert _shape(tspans, tid) == want
        assert [n for n, *_ in want] == sorted(
            ["server.request", "queue_wait", "prefill", "first_decode"])
        assert ("queue_wait", "server.request") in [w[:2] for w in want]
        assert ("server.request", "remote") in [w[:2] for w in want]
    # engine.step: a root span a quantum, the same count and keys.
    jsteps = [s for s in jspans if s.name == "engine.step"]
    tsteps = [s for s in tspans if s.name == "engine.step"]
    assert len(tsteps) == len(jsteps) == jstats["flight"]["steps"] > 0
    assert all(s.parent_id == "" for s in tsteps)
    assert [sorted(s.attributes) for s in tsteps] == \
        [sorted(s.attributes) for s in jsteps]
    # /stats: the flight block and the stall count under JAX's names.
    assert set(tstats["flight"]) == set(jstats["flight"])
    for key in ("step_s", "fill"):
        assert set(tstats["flight"][key]) == set(jstats["flight"][key])
    assert tstats["flight"]["steps"] == jstats["flight"]["steps"]
    assert tstats["engine_step_stalls"] == jstats["engine_step_stalls"] == 0
    assert set(tstats) == set(jstats)
    # /debug/traces: the ring's spans, in the same shape.
    assert sorted(t["name"] for t in ttraces) == \
        sorted(t["name"] for t in jtraces)
    assert set(ttraces[0]) == set(jtraces[0])


def test_a_request_id_header_wins_and_an_abort_marks_its_spans(tiny):
    _, teng = _paged(tiny)
    exporter = TT.InMemoryExporter()
    TT.set_tracer_provider(TT.TracerProvider(exporter))
    srv = TS.InferenceServer(teng, port=0, default_deadline_s=1e-6).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps({"prompt": PROMPTS[0], "stream": True}).encode(),
            method="POST", headers={"x-request-id": "req-7"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            assert resp.headers["X-Request-Id"] == "req-7"
            events = [json.loads(line[6:]) for line in
                      resp.read().decode().splitlines()
                      if line.startswith("data: {")]
        assert events[-1] == {"error": "deadline", "request_id": "req-7"}
        _wait_for(lambda: exporter.by_name("server.request"))
        errored = [s.name for s in exporter.spans if s.status == "ERROR"]
        assert errored and set(errored) <= {"queue_wait", "prefill"}
    finally:
        srv.stop()
        TT.set_tracer_provider(TT.TracerProvider())


# -- metrics mirroring ---------------------------------------------------------


# The STATS_PARITY families a serving replica mirrors (the rest are the
# gateway's, the autoscaler's and migration's), the drain's duration apart:
# a wall time, only checked to be set.
SERVER_FAMILIES = sorted(
    f for f in STATS_PARITY if f.startswith(("tpu_serving_", "tpu_engine_"))
    and "kv_transfer" not in f and "kv_peer" not in f
    and f != "tpu_serving_drain_seconds")
# The /stats value each family reads, where a run fixes it exactly.
STATS_OF = {
    "tpu_serving_requests_shed_total": ("requests_shed",),
    "tpu_serving_requests_cancelled_total": ("requests_cancelled",),
    "tpu_serving_deadline_expired_total": ("deadline_expired",),
    "tpu_engine_step_stall_total": ("engine_step_stalls",),
    "tpu_serving_prefix_cache_hits_total": ("prefix_cache", "hits"),
    "tpu_serving_prefix_cache_misses_total": ("prefix_cache", "misses"),
    "tpu_serving_prefix_cache_evictions_total": ("prefix_cache",
                                                 "evictions"),
    "tpu_serving_prefix_cached_blocks": ("prefix_cache", "cached_blocks"),
    "tpu_serving_kv_swap_out_total": ("kv_swap", "swap_out"),
    "tpu_serving_kv_swap_in_total": ("kv_swap", "swap_in"),
    "tpu_serving_kv_swap_restored_tokens_total": ("kv_swap",
                                                  "restored_tokens"),
    "tpu_serving_kv_swap_bytes": ("kv_swap", "swap_bytes"),
    "tpu_serving_spec_accept_total": ("speculative", "accepted"),
    "tpu_serving_spec_rounds_total": ("speculative", "rounds"),
    "tpu_serving_lora_cache_hits_total": ("lora_cache", "hits"),
    "tpu_serving_lora_cache_misses_total": ("lora_cache", "misses"),
    "tpu_serving_lora_cache_evictions_total": ("lora_cache", "evictions"),
}


@pytest.fixture(scope="module")
def world(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    jads = [_adapter(jcfg, 1), _adapter(jcfg, 5)]
    tads = [lora_from_jax(jax.tree.map(np.asarray, ad), device="cpu")
            for ad in jads]
    return (JM.stack_adapters(jads, jcfg, JL.LoraConfig(**LCFG)),
            TM.stack_adapters(tads, tcfg, TLo.LoraConfig(**LCFG)))


def _engines(kind, tiny, world):
    if kind == "lifecycle":
        return _paged(tiny), [(PROMPTS[2], None)]
    if kind in ("prefix-swap", "prefix-evict"):
        a, b = list(range(3, 27)) + [2], list(range(100, 124)) + [2]
        swap = {"swap_bytes": 1 << 22} if kind == "prefix-swap" else {}
        return (_paged(tiny, max_new=6, ragged=False, prefix_cache=True,
                       slots=1, num_blocks=7, prompt_bucket=32, **swap),
                [(a, None), (b, None), (a, None)])
    if kind == "spec":
        # The target as its own draft: every proposal accepted.
        return (_spec_pair(tiny, None, "paged", ragged=True),
                [(p, None) for p in PROMPTS[:2]])
    jcfg, tcfg, jparams, tparams = tiny
    jstack, tstack = world
    kw = {"slots": 2, "num_blocks": 40, "block_size": 8, "prompt_bucket": 16,
          "ragged": True, "token_budget": 16, "lora_cache_slots": 1}
    pair = (JM.MultiLoraPagedBatcher(
                jparams, jcfg, jstack, JL.LoraConfig(**LCFG),
                adapter_names=NAMES, gen=JGen(max_new_tokens=4),
                attn_kernel=False, **kw),
            TM.MultiLoraPagedBatcher(
                tparams, tcfg, tstack, TLo.LoraConfig(**LCFG),
                adapter_names=NAMES, gen=TGen(max_new_tokens=4),
                device="cpu", **kw))
    return pair, [(p, t) for p, t in zip(PROMPTS, ["a0", "a1", "a0"])]


def _mirror_run(server_mod, engine, traffic, lifecycle):
    metrics = Metrics()
    srv = server_mod.InferenceServer(engine, port=0, metrics=metrics,
                                     max_queue_depth=2, model_name="tiny")
    try:
        if lifecycle:
            # Before the engine thread runs: a stall in the recorder, two
            # queued requests (one cancelled, one past its deadline) and
            # a third one shed by the full queue.
            for _ in range(16):
                srv.flight.record_step(1.0)
            assert srv.flight.record_step(100.0)
            rid, _ = srv._submit(PROMPTS[0], 4)
            late, expiring = srv._submit(PROMPTS[1], 4, deadline_s=1e-6)
            with pytest.raises(server_mod.OverloadedError):
                srv._submit(PROMPTS[2], 4)
            srv._cancel(rid)
            srv._finish(rid)
        srv.start()
        if lifecycle:
            item = expiring.get(timeout=TIMEOUT)
            while not isinstance(item, server_mod._Abort):
                item = expiring.get(timeout=TIMEOUT)
            assert item.reason == "deadline"
            srv._finish(late)
        for prompt, model in traffic:
            body = {"prompt": prompt}
            if model:
                body["model"] = model
            _post(srv.port, body)
        stats = _get(srv.port, "/stats")
    finally:
        srv.stop()
    samples = {f: metrics.registry.get_sample_value(f)
               for f in SERVER_FAMILIES}
    return samples, stats, metrics.registry.get_sample_value(
        "tpu_serving_drain_seconds")


@pytest.mark.parametrize("kind", ["lifecycle", "prefix-swap", "prefix-evict",
                                  "spec", "lora"])
def test_metrics_mirror_equals_jax(tiny, world, kind):
    (jeng, teng), traffic = _engines(kind, tiny, world)
    lifecycle = kind == "lifecycle"
    jsamples, jstats, jdrain = _mirror_run(JS, jeng, traffic, lifecycle)
    tsamples, tstats, tdrain = _mirror_run(TS, teng, traffic, lifecycle)
    assert tsamples == jsamples
    # The wrapper engines (speculative, multi-LoRA) reach the timed
    # drive_once as JAX's do: the same quanta on the flight recorder.
    assert tstats["flight"]["steps"] == jstats["flight"]["steps"] > 0
    assert jdrain is not None and tdrain is not None and tdrain >= 0
    # Each family reads what the port's /stats says.
    for family, path in STATS_OF.items():
        value = tstats
        for key in path:
            value = value.get(key) if isinstance(value, dict) else None
        if value is not None:
            assert tsamples[family] == value, family
    moved = {
        "lifecycle": ("tpu_serving_requests_shed_total",
                      "tpu_serving_requests_cancelled_total",
                      "tpu_serving_deadline_expired_total",
                      "tpu_engine_step_stall_total",
                      "tpu_serving_ragged_batch_fill",
                      "tpu_serving_queue_depth"),
        "prefix-swap": ("tpu_serving_prefix_cache_hits_total",
                        "tpu_serving_kv_swap_out_total",
                        "tpu_serving_kv_swap_in_total"),
        "prefix-evict": ("tpu_serving_prefix_cache_misses_total",
                         "tpu_serving_prefix_cache_evictions_total"),
        "spec": ("tpu_serving_spec_accept_total",
                 "tpu_serving_spec_rounds_total"),
        "lora": ("tpu_serving_lora_cache_misses_total",
                 "tpu_serving_lora_cache_evictions_total"),
    }[kind]
    for family in moved:
        assert tsamples[family] > 0, family
