"""The port's InferenceServer over a tiny port engine, on the CPU.

Blocking and streamed completions must equal ``engine.run()`` on the same
prompts; ``/stats`` must carry the ported keys under the JAX server's
names; a full queue sheds with 429; garbage env knobs raise naming the
variable. Servers bind port 0, every HTTP call has a timeout, and every
server is stopped.
"""

from __future__ import annotations

import concurrent.futures
import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models import server as JS
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import server as TS
from kubeflow_tpu_torch.models.bridge import params_from_jax
from kubeflow_tpu_torch.models.continuous import ContinuousBatcher
from kubeflow_tpu_torch.models.paged import PagedBatcher
from kubeflow_tpu_torch.models.serving import GenerationConfig

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    cfg = L.LLAMA_CONFIGS["tiny"]
    tree = jax.tree.map(np.asarray, L.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = TL.LLAMA_CONFIGS["tiny"]
    return tcfg, params_from_jax(tree, tcfg, device="cpu")


def _engine(tiny, ragged=True, **kw):
    cfg, params = tiny
    return PagedBatcher(params, cfg, gen=GenerationConfig(max_new_tokens=6,
                                                          eos_id=-1),
                        slots=2, num_blocks=16, block_size=8,
                        prompt_bucket=16, ragged=ragged,
                        token_budget=16 if ragged else None,
                        device="cpu", **kw)


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, resp.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


PROMPTS = [[5, 9, 17, 33], [7, 1, 200, 3, 99], [250, 4, 4, 8, 8, 8]]


def test_completions_blocking_and_streamed_equal_run(tiny):
    ref_engine = _engine(tiny)
    rids = [ref_engine.submit(p) for p in PROMPTS]
    ref = ref_engine.run()
    ref = [ref[r] for r in rids]
    srv = TS.InferenceServer(_engine(tiny), port=0).start()
    try:
        def blocking(p):
            code, body = _post(srv.port, {"prompt": p})
            assert code == 200
            choice = json.loads(body)["choices"][0]
            assert choice["finish_reason"] == "length"
            return choice["tokens"]

        def streamed(p):
            code, body = _post(srv.port, {"prompt": p, "stream": True})
            assert code == 200
            events = [ln[6:] for ln in body.splitlines()
                      if ln.startswith("data: ")]
            assert events[-1] == "[DONE]"
            return [json.loads(e)["token"] for e in events[:-1]]

        # One at a time: each request runs alone, as in ref's schedule
        # per slot, so the tokens must match exactly.
        for p, want in zip(PROMPTS, ref):
            assert blocking(p) == want
            assert streamed(p) == want
        # Concurrently (batched together): still the same greedy tokens.
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            got = list(pool.map(blocking, PROMPTS[:2]))
        assert got == ref[:2]
        stats = _get(srv.port, "/stats")
        assert stats["served"] == 2 * len(PROMPTS) + 2
        assert _get(srv.port, "/healthz") == {"status": "ok"}
        assert _get(srv.port, "/v1/models")["data"][0]["id"] == "kubeflow-tpu"
    finally:
        srv.stop()


def test_stats_keys_carry_the_jax_names(tiny):
    cfg = L.LLAMA_CONFIGS["tiny"]
    jparams = L.init_params(cfg, jax.random.PRNGKey(0))
    jsrv = JS.InferenceServer(
        JP.PagedBatcher(jparams, cfg, slots=2, num_blocks=16, block_size=8,
                        prompt_bucket=16, attn_kernel=False, ragged=True,
                        token_budget=16), port=0).start()
    tsrv = TS.InferenceServer(_engine(tiny), port=0).start()
    try:
        jstats = _get(jsrv.port, "/stats")
        tstats = _get(tsrv.port, "/stats")
    finally:
        jsrv.stop()
        tsrv.stop()
    assert set(tstats) <= set(jstats), set(tstats) - set(jstats)
    for key in ("active_slots", "queued", "admitting", "slots", "served",
                "tokens_generated", "tokens_per_sec_lifetime", "ttft_s",
                "e2e_latency_s", "queue_wait_s", "inter_token_s",
                "requests_shed", "requests_cancelled", "deadline_expired",
                "max_queue_depth", "draining", "drain_duration_s",
                "kv_pool", "ragged"):
        assert key in tstats, key
    for key in ("kv_pool", "ragged", "ttft_s"):
        assert set(tstats[key]) == set(jstats[key])


def test_full_queue_sheds_429(tiny):
    srv = TS.InferenceServer(_engine(tiny), port=0, max_queue_depth=1,
                             drain_s=0.1)
    # HTTP only: with no engine thread the first request stays queued.
    srv._http_thread.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            first = pool.submit(_post, srv.port, {"prompt": [5, 9]})
            deadline = time.monotonic() + TIMEOUT
            while not srv.engine._queue and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(srv.engine._queue) == 1
            with pytest.raises(urllib.error.HTTPError) as info:
                _post(srv.port, {"prompt": [5, 9]})
            assert info.value.code == 429
            assert info.value.headers["Retry-After"] == "1"
            srv.stop()  # aborts the queued request
            with pytest.raises(urllib.error.HTTPError) as info:
                first.result(timeout=TIMEOUT)
            assert info.value.code == 500
        assert srv.stats()["requests_shed"] == 1
    finally:
        srv.stop()


@pytest.mark.parametrize("var,value,fn", [
    ("KUBEFLOW_TPU_SERVING_PORT", "80", TS.serving_port_from_env),
    ("KUBEFLOW_TPU_SERVING_PORT", "http", TS.serving_port_from_env),
    ("KUBEFLOW_TPU_SERVING_RAGGED", "yes", TS.ragged_from_env),
    ("KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET", "-4", TS.ragged_from_env),
    ("KUBEFLOW_TPU_KV_BITS", "4", TS.kv_pool_from_env),
])
def test_garbage_env_raises_naming_the_variable(monkeypatch, var, value, fn):
    monkeypatch.setenv(var, value)
    with pytest.raises(ValueError, match=var):
        fn()


def test_env_knobs_parse(monkeypatch):
    monkeypatch.setenv("KUBEFLOW_TPU_SERVING_PORT", "8123")
    monkeypatch.setenv("KUBEFLOW_TPU_SERVING_RAGGED", "1")
    monkeypatch.setenv("KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET", "64")
    monkeypatch.setenv("KUBEFLOW_TPU_KV_BITS", "8")
    assert TS.serving_port_from_env() == JS.serving_port_from_env() == 8123
    assert TS.ragged_from_env() == JS.ragged_from_env() == (True, 64)
    assert TS.kv_pool_from_env() == {"kv_bits": 8}


def test_alternating_engine_serves_completions(tiny):
    """``PagedBatcher(ragged=False)`` behind the server: blocking and
    streamed completions equal ``run()`` on the same prompts."""
    ref_engine = _engine(tiny, ragged=False)
    rids = [ref_engine.submit(p) for p in PROMPTS]
    ref = ref_engine.run()
    srv = TS.InferenceServer(_engine(tiny, ragged=False), port=0).start()
    try:
        for p, rid in zip(PROMPTS, rids):
            code, body = _post(srv.port, {"prompt": p})
            assert code == 200
            assert json.loads(body)["choices"][0]["tokens"] == ref[rid]
            code, body = _post(srv.port, {"prompt": p, "stream": True})
            events = [ln[6:] for ln in body.splitlines()
                      if ln.startswith("data: ")]
            assert events[-1] == "[DONE]"
            assert [json.loads(e)["token"] for e in events[:-1]] == ref[rid]
        stats = _get(srv.port, "/stats")
        assert stats["served"] == 2 * len(PROMPTS)
        assert "ragged" not in stats
    finally:
        srv.stop()


@pytest.mark.parametrize("value,ragged", [(None, False), ("0", False),
                                          ("1", True)])
def test_serve_http_follows_the_ragged_env(monkeypatch, value, ragged):
    """Unset or 0 serves the alternating engine, 1 the ragged one, as the
    JAX entry point decides (``ragged_from_env``)."""
    from kubeflow_tpu_torch.examples import serve_http

    class Built(Exception):
        pass

    class NoServer:
        def __init__(self, engine, **kw):
            self.engine = engine

        def start(self):
            raise Built(self.engine)

    if value is None:
        monkeypatch.delenv("KUBEFLOW_TPU_SERVING_RAGGED", raising=False)
    else:
        monkeypatch.setenv("KUBEFLOW_TPU_SERVING_RAGGED", value)
    assert JS.ragged_from_env()[0] == ragged
    monkeypatch.setattr(TS, "InferenceServer", NoServer)
    with pytest.raises(Built) as info:
        serve_http.main(["--config", "tiny", "--device", "cpu", "--port",
                         "0", "--paged", "--num-blocks", "16", "--slots",
                         "2"])
    engine = info.value.args[0]
    assert isinstance(engine, PagedBatcher)
    assert engine.ragged is ragged
    assert engine.device.type == "cpu" and engine.attn_kernel is False


def test_serve_http_without_paged_serves_the_continuous_engine(monkeypatch):
    """No ``--paged``: ``ContinuousBatcher`` with the JAX entry point's
    default cache_len 1024, whatever KUBEFLOW_TPU_SERVING_RAGGED says;
    ``--paged --admit-chunk`` exits with the JAX message."""
    from kubeflow_tpu_torch.examples import serve_http

    class Built(Exception):
        pass

    class NoServer:
        def __init__(self, engine, **kw):
            raise Built(engine)

    monkeypatch.setenv("KUBEFLOW_TPU_SERVING_RAGGED", "1")
    monkeypatch.setattr(TS, "InferenceServer", NoServer)
    base = ["--config", "tiny", "--device", "cpu", "--port", "0",
            "--slots", "2"]
    with pytest.raises(Built) as info:
        serve_http.main(base)
    engine = info.value.args[0]
    assert isinstance(engine, ContinuousBatcher)
    assert engine.cache_len == 1024 and engine.ragged is False
    assert engine._attn_kernel == 0 and engine._admit_chunk is None
    with pytest.raises(Built) as info:
        serve_http.main(base + ["--admit-chunk", "16"])
    assert info.value.args[0]._admit_chunk == 16
    with pytest.raises(SystemExit) as info:
        serve_http.main(base + ["--paged", "--admit-chunk", "4"])
    assert str(info.value) == ("--admit-chunk is a continuous-engine "
                               "feature; drop it or drop --paged")


def _continuous(tiny, **kw):
    cfg, params = tiny
    return ContinuousBatcher(params, cfg, gen=GenerationConfig(
        max_new_tokens=6, eos_id=-1), slots=2, cache_len=32,
        prompt_bucket=16, device="cpu", **kw)


def test_continuous_engine_serves_completions(tiny):
    """``ContinuousBatcher`` behind the server: blocking and streamed
    completions equal ``run()`` on the same prompts."""
    ref_engine = _continuous(tiny)
    rids = [ref_engine.submit(p) for p in PROMPTS]
    ref = ref_engine.run()
    srv = TS.InferenceServer(_continuous(tiny), port=0).start()
    try:
        for p, rid in zip(PROMPTS, rids):
            code, body = _post(srv.port, {"prompt": p})
            assert code == 200
            assert json.loads(body)["choices"][0]["tokens"] == ref[rid]
            code, body = _post(srv.port, {"prompt": p, "stream": True})
            events = [ln[6:] for ln in body.splitlines()
                      if ln.startswith("data: ")]
            assert events[-1] == "[DONE]"
            assert [json.loads(e)["token"] for e in events[:-1]] == ref[rid]
        stats = _get(srv.port, "/stats")
        assert stats["served"] == 2 * len(PROMPTS)
        assert "ragged" not in stats and "kv_pool" not in stats
    finally:
        srv.stop()


def test_stats_over_a_ragged_continuous_engine(tiny):
    """The ragged ``ContinuousBatcher`` keeps no ragged counters: /stats
    answers 200 without a ``ragged`` block, and counts a staged admission
    under ``admitting``."""
    srv = TS.InferenceServer(_continuous(tiny, admit_chunk=8, ragged=True),
                             port=0)
    srv._http_thread.start()  # no engine thread: the admission stays staged
    try:
        with srv._lock:
            srv.engine.submit([5, 9, 17, 33])
            srv.engine._admit_free_slots()
        assert srv.engine._admitting is not None
        stats = _get(srv.port, "/stats")
        assert stats["admitting"] == 1 and stats["queued"] == 0
        assert "ragged" not in stats
    finally:
        srv.stop()
