"""A port replica behind the reference gateway, beside a JAX replica.

The JAX package's ``ServingGateway`` (unchanged) fronts one JAX and one
port ``InferenceServer``, each over a ``ContinuousBatcher`` on the same
f32 ``tiny`` weights (the port's through the bridge), on the CPU. Each
replica in turn takes all the traffic (the other is out of the ring):

- blocking and streamed responses through the gateway are the same
  tokens from either replica, exactly;
- a request served by the port replica is ONE trace from the gateway's
  root span (JAX tracer) through ``gateway.route`` and the port's
  ``server.request`` (joined by the traceparent header) to its
  ``queue_wait``, ``prefill`` and ``first_decode`` spans (port tracer),
  and the client's ``X-Request-Id`` is that trace id;
- those three spans sum to the TTFT the port server measured within 10%
  (and 5 ms), as ``tests/test_tracing.py::TestEndToEndFleet`` holds the
  JAX fleet;
- the gateway's scrape of the port replica carries its flight recorder.
"""

from __future__ import annotations

import json
import time
import urllib.request

import pytest
import torch

from kubeflow_tpu.models import continuous as JCB
from kubeflow_tpu.models import server as JS
from kubeflow_tpu.models.gateway import ServingGateway
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu.observability import tracing as JT
from kubeflow_tpu_torch.models import continuous as TCB
from kubeflow_tpu_torch.models import server as TS
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.observability import tracing as TT
from tests.test_torch_paged import _models

TIMEOUT = 120
PROMPTS = [[3, 4, 5, 6, 7], [9, 200, 31], [17, 17, 40, 2, 8, 101, 5]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _post(gw, body):
    req = urllib.request.Request(
        f"http://{gw.host}:{gw.port}/v1/completions",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        raw = resp.read().decode()
        req_id = resp.headers["X-Request-Id"]
    if not body.get("stream"):
        return req_id, json.loads(raw)["choices"][0]["tokens"]
    events = [line[6:] for line in raw.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return req_id, [json.loads(e)["token"] for e in events[:-1]]


def _wait_for(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {fn}")


def test_port_replica_serves_and_traces_behind_the_gateway():
    jcfg, tcfg, jparams, tparams = _models("tiny", "f32")
    kw = dict(slots=2, cache_len=128, prompt_bucket=16)
    jexp, texp = JT.InMemoryExporter(), TT.InMemoryExporter()
    JT.set_tracer_provider(JT.TracerProvider(jexp))
    TT.set_tracer_provider(TT.TracerProvider(texp))
    jsrv = JS.InferenceServer(JCB.ContinuousBatcher(
        jparams, jcfg, gen=JGen(max_new_tokens=4, eos_id=-1), **kw),
        port=0).start()
    tsrv = TS.InferenceServer(TCB.ContinuousBatcher(
        tparams, tcfg, gen=TGen(max_new_tokens=4, eos_id=-1), device="cpu",
        **kw), port=0).start()
    jep, tep = (f"{s.host}:{s.port}" for s in (jsrv, tsrv))
    gw = ServingGateway([jep, tep], port=0, block_size=16,
                        health_interval_s=0.2).start()
    try:
        served = {}
        for alone, other in ((tep, jep), (jep, tep)):
            gw.remove_replica(other)
            served[alone] = [_post(gw, {"prompt": p, "stream": stream})
                             for p in PROMPTS for stream in (False, True)]
            gw.add_replica(other)
        tokens = {ep: [t for _, t in got] for ep, got in served.items()}
        assert tokens[tep] == tokens[jep]
        assert all(len(t) == 4 for t in tokens[tep])
        assert tokens[tep][0::2] == tokens[tep][1::2]  # streamed = blocking

        # The first request the port replica served: one trace.
        req_id = served[tep][0][0]
        _wait_for(lambda: [s for s in texp.spans
                           if s.trace_id == req_id
                           and s.name == "server.request"])
        (gw_root,) = [s for s in jexp.by_name("gateway.request")
                      if s.trace_id == req_id]
        (route,) = [s for s in jexp.by_name("gateway.route")
                    if s.trace_id == req_id]
        mine = {s.name: s for s in texp.spans if s.trace_id == req_id}
        assert sorted(mine) == ["first_decode", "prefill", "queue_wait",
                                "server.request"]
        srv_root = mine["server.request"]
        assert route.parent_id == gw_root.span_id
        assert route.attributes["endpoint"] == tep
        assert srv_root.parent_id == route.span_id  # via traceparent
        for name in ("queue_wait", "prefill", "first_decode"):
            assert mine[name].parent_id == srv_root.span_id, name
        (evt,) = [e for e in srv_root.events if e["name"] == "first_token"]
        span_sum = sum(mine[n].duration_s
                       for n in ("queue_wait", "prefill", "first_decode"))
        assert span_sum == pytest.approx(evt["attributes"]["ttft_s"],
                                         rel=0.10, abs=0.005)
        # The gateway scrapes the port replica's flight recorder.
        gw.probe_once()
        scraped = gw._replicas[tep].stats
        assert scraped["engine_step_stalls"] == 0
        assert scraped["flight"]["steps"] > 0
    finally:
        gw.stop()
        jsrv.stop()
        tsrv.stop()
        JT.set_tracer_provider(JT.TracerProvider())
        TT.set_tracer_provider(TT.TracerProvider())
