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


SERVING_KNOBS = ("KUBEFLOW_TPU_SERVING_PORT", "KUBEFLOW_TPU_SERVING_RAGGED",
                 "KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET", "KUBEFLOW_TPU_KV_BITS",
                 "KUBEFLOW_TPU_HBM_FRACTION", "KUBEFLOW_TPU_KV_SWAP_BYTES",
                 "KUBEFLOW_TPU_SPEC_DRAFT_LEN", "KUBEFLOW_TPU_SPEC_ADAPTIVE",
                 "KUBEFLOW_TPU_SERVING_TP", "KUBEFLOW_TPU_LORA_CACHE_SLOTS")
# (env, the parser both packages have under this name): every knob the
# JAX serve_http reads, with garbage.
GARBAGE_KNOBS = [
    ({"KUBEFLOW_TPU_SERVING_PORT": "80"}, "serving_port_from_env"),
    ({"KUBEFLOW_TPU_SERVING_RAGGED": "yes"}, "ragged_from_env"),
    ({"KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET": "x"}, "ragged_from_env"),
    ({"KUBEFLOW_TPU_KV_BITS": "4"}, "kv_pool_from_env"),
    ({"KUBEFLOW_TPU_HBM_FRACTION": "half"}, "kv_pool_from_env"),
    ({"KUBEFLOW_TPU_HBM_FRACTION": "1.5"}, "kv_pool_from_env"),
    ({"KUBEFLOW_TPU_KV_SWAP_BYTES": "-1"}, "kv_pool_from_env"),
    ({"KUBEFLOW_TPU_SPEC_DRAFT_LEN": "banana"}, "spec_from_env"),
    ({"KUBEFLOW_TPU_SPEC_ADAPTIVE": "maybe"}, "spec_from_env"),
    ({"KUBEFLOW_TPU_SPEC_ADAPTIVE": "1"}, "spec_from_env"),
    ({"KUBEFLOW_TPU_SERVING_TP": "0"}, "serving_tp_from_env"),
    ({"KUBEFLOW_TPU_LORA_CACHE_SLOTS": "-2"}, "lora_cache_from_env"),
]
PAGED_ARGS = ["--config", "tiny", "--device", "cpu", "--port", "0",
              "--paged", "--num-blocks", "16", "--slots", "2"]


@pytest.fixture
def clean_env(monkeypatch):
    for var in SERVING_KNOBS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


class _Built(Exception):
    pass


def _no_weights(*args, **kwargs):
    raise AssertionError("serve_http made weights before refusing a knob")


def _knob_id(case):
    return ",".join(f"{k[13:]}={v}" for k, v in case[0].items())


@pytest.mark.parametrize("env,fn", GARBAGE_KNOBS,
                         ids=[_knob_id(c) for c in GARBAGE_KNOBS])
def test_garbage_knob_raises_the_jax_message(clean_env, env, fn):
    for var, value in env.items():
        clean_env.setenv(var, value)
    with pytest.raises(ValueError) as jax_err:
        getattr(JS, fn)()
    with pytest.raises(ValueError) as port_err:
        getattr(TS, fn)()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("env,fn", GARBAGE_KNOBS,
                         ids=[_knob_id(c) for c in GARBAGE_KNOBS])
def test_serve_http_exits_on_a_garbage_knob(clean_env, env, fn):
    """``--paged`` reads every knob; garbage exits with the JAX parser's
    message before any weight is made."""
    from kubeflow_tpu_torch.examples import serve_http

    for var, value in env.items():
        clean_env.setenv(var, value)
    with pytest.raises(ValueError) as jax_err:
        getattr(JS, fn)()
    clean_env.setattr(TL, "init_params", _no_weights)
    args = [a for a in PAGED_ARGS if "SERVING_PORT" not in str(env)
            or a not in ("--port", "0")]
    with pytest.raises(SystemExit) as info:
        serve_http.main(args)
    assert str(info.value) == str(jax_err.value)


@pytest.mark.parametrize("env,paged,says", [
    ({"KUBEFLOW_TPU_SERVING_TP": "2"}, True, "item 11"),
    ({"KUBEFLOW_TPU_SERVING_TP": "2"}, False, "item 11"),
    # The JAX order: on the alternating engine, "needs the ragged engine".
    ({"KUBEFLOW_TPU_SPEC_DRAFT_LEN": "3"}, True,
     "KUBEFLOW_TPU_SPEC_DRAFT_LEN needs the ragged engine (set "
     "KUBEFLOW_TPU_SERVING_RAGGED=1)"),
])
def test_serve_http_refuses_a_knob_the_port_lacks(clean_env, env, paged,
                                                  says):
    """A valid value of a knob whose feature is not ported exits at
    startup, before any weight or engine is made, naming the ROADMAP
    queue-1 item that brings it."""
    from kubeflow_tpu_torch.examples import serve_http

    for var, value in env.items():
        clean_env.setenv(var, value)
    clean_env.setattr(TL, "init_params", _no_weights)
    args = PAGED_ARGS if paged else [a for a in PAGED_ARGS if a != "--paged"]
    with pytest.raises(SystemExit) as info:
        serve_http.main(args)
    message = str(info.value)
    assert says in message
    assert next(iter(env)) in message


def test_serve_http_swap_bytes_turns_the_prefix_cache_on(clean_env):
    """KUBEFLOW_TPU_KV_SWAP_BYTES > 0 gives the alternating engine that
    swap tier and its prefix cache, as in JAX; with
    KUBEFLOW_TPU_SERVING_RAGGED=1 the engine refuses the pair with JAX's
    message."""
    from kubeflow_tpu_torch.examples import serve_http

    class NoServer:
        def __init__(self, engine, **kw):
            self.engine = engine

        def start(self):
            raise _Built(self.engine)

    clean_env.setenv("KUBEFLOW_TPU_KV_SWAP_BYTES", "1048576")
    clean_env.setattr(TS, "InferenceServer", NoServer)
    with pytest.raises(_Built) as info:
        serve_http.main(PAGED_ARGS)
    engine = info.value.args[0]
    assert engine.swap_bytes_limit == 1048576
    assert engine._prefix_cache_enabled and not engine.ragged
    clean_env.setenv("KUBEFLOW_TPU_SERVING_RAGGED", "1")
    cfg = L.LLAMA_CONFIGS["tiny"]
    with pytest.raises(ValueError) as jax_err:
        JP.PagedBatcher(L.init_params(cfg, jax.random.PRNGKey(0)), cfg,
                        ragged=True, prefix_cache=True, swap_bytes=1048576)
    with pytest.raises(ValueError) as port_err:
        serve_http.main(PAGED_ARGS)
    assert str(port_err.value) == str(jax_err.value)


def test_serve_http_honors_hbm_fraction(clean_env):
    """KUBEFLOW_TPU_HBM_FRACTION reaches ``PagedBatcher(hbm_fraction=)``;
    unset, the keyword stays out (the engine default)."""
    from kubeflow_tpu_torch.examples import serve_http
    from kubeflow_tpu_torch.models import paged as paged_mod

    def built(*args, **kw):
        raise _Built(kw)

    clean_env.setattr(paged_mod, "PagedBatcher", built)
    with pytest.raises(_Built) as info:
        serve_http.main(PAGED_ARGS)
    assert "hbm_fraction" not in info.value.args[0]
    clean_env.setenv("KUBEFLOW_TPU_HBM_FRACTION", "0.5")
    assert JS.kv_pool_from_env() == TS.kv_pool_from_env() == {
        "hbm_fraction": 0.5}
    with pytest.raises(_Built) as info:
        serve_http.main(PAGED_ARGS)
    assert info.value.args[0]["hbm_fraction"] == 0.5


@pytest.mark.parametrize("paged", [True, False])
def test_serve_http_notes_lora_cache_slots_and_serves(clean_env, capsys,
                                                      paged):
    """KUBEFLOW_TPU_LORA_CACHE_SLOTS=4, as in JAX: under ``--paged`` the
    server starts and prints the notice that the knob sizes multi-LoRA
    engines; without ``--paged`` it is not read."""
    from kubeflow_tpu_torch.examples import serve_http

    class NoServer:
        def __init__(self, engine, **kw):
            self.engine = engine

        def start(self):
            raise _Built(self.engine)

    clean_env.setenv("KUBEFLOW_TPU_LORA_CACHE_SLOTS", "4")
    clean_env.setattr(TS, "InferenceServer", NoServer)
    args = PAGED_ARGS if paged else [a for a in PAGED_ARGS if a != "--paged"]
    with pytest.raises(_Built) as info:
        serve_http.main(args)
    assert isinstance(info.value.args[0],
                      PagedBatcher if paged else ContinuousBatcher)
    notice = "lora cache slots=4 (no adapters registered by this example"
    assert (notice in capsys.readouterr().out) is paged
    if paged:
        assert JS.lora_cache_from_env() == TS.lora_cache_from_env() == 4


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
