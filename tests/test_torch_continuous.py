"""PyTorch port of ``ContinuousBatcher`` vs the JAX engine.

Both engines get the same weights (JAX ``init_params`` through the
bridge) and the same numpy prompts, and are driven in lockstep, one
``drive_once`` at a time, in the regimes of tests/test_continuous.py
(single request, slot reuse, EOS frees a slot early, submit validation,
the cache-size refusal) and in chunked admission (``admit_chunk=4``),
ragged admission (``ragged=True, admit_chunk=8`` at a ``cache_len`` with
room) and an int8 cache (``kv_bits=8``). On f32 ``tiny-gqa`` every quantum
must emit the same tokens, with logprobs within 1e-4. JAX runs its XLA
attention on the CPU, the port its plain versions.

``_cb_step(attn_kernel=256)`` is also called directly on both sides: JAX
interprets the Pallas dense kernel, the port's wrapper runs its plain
version on CPU tensors, so the kernel branch of the step is held on the
CPU. Last, a port-only test pins the repair of a reference fault: JAX's
ragged engine writes a decode row's chunk near the cache's end at
``C - K`` (over an earlier token), the port clips it, so the port's ragged
engine emits its one-shot engine's tokens where JAX's forks.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import continuous as JC
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu_torch.models import continuous as TC
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models.bridge import params_from_jax
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.ops import paged_attention as TPA
from kubeflow_tpu_torch.parallel import mesh as TM


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def f32_gqa():
    jcfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny-gqa"], dtype=jnp.float32)
    tcfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny-gqa"],
                               dtype=torch.float32)
    jparams = L.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(n, seed, lo=4, hi=16, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _pair(models, max_new, eos_id=-1, **kw):
    jcfg, tcfg, jparams, tparams = models
    jcb = JC.ContinuousBatcher(jparams, jcfg, gen=JGen(max_new_tokens=max_new,
                                                       eos_id=eos_id), **kw)
    tcb = TC.ContinuousBatcher(tparams, tcfg, gen=TGen(max_new_tokens=max_new,
                                                       eos_id=eos_id),
                               device="cpu", **kw)
    return jcb, tcb


def _lockstep(jcb, tcb, prompts, between=None):
    """Drive both engines one quantum at a time; every quantum must emit
    the same (rid, token) events. Returns the JAX engine's run()."""
    events = ([], [])
    for eng, ev in zip((jcb, tcb), events):
        eng.on_token = lambda rid, tok, ev=ev: ev.append((rid, tok))
        for p in prompts:
            eng.submit(p)
    step = 0
    while jcb._pending() or tcb._pending():
        if between is not None:
            between(step, jcb, tcb)
        n0 = [len(e) for e in events]
        jcb.drive_once()
        tcb.drive_once()
        assert events[0][n0[0]:] == events[1][n0[1]:], f"step {step}"
        assert jcb.last_step == tcb.last_step, f"step {step}"
        step += 1
    jout, tout = jcb.run(), tcb.run()
    assert jout == tout
    for rid in jout:
        np.testing.assert_allclose(tcb.run_logprobs()[rid],
                                   jcb.run_logprobs()[rid], atol=1e-4)
    return jout


class TestF32Parity:
    def test_single_request(self, f32_gqa):
        jcb, tcb = _pair(f32_gqa, 8, slots=1, cache_len=24, prompt_bucket=16)
        out = _lockstep(jcb, tcb, [[5, 9, 17, 33]])
        assert [len(t) for t in out.values()] == [8]

    def test_slot_reuse(self, f32_gqa):
        """More requests than slots: admissions into recycled slots."""
        jcb, tcb = _pair(f32_gqa, 10, slots=3, cache_len=26, prompt_bucket=16)
        out = _lockstep(jcb, tcb, _prompts(7, seed=1))
        assert all(len(t) == 10 for t in out.values())

    def test_eos_frees_slot_early(self, f32_gqa):
        _, probe = _pair(f32_gqa, 6, slots=2, cache_len=22, prompt_bucket=16)
        prompts = _prompts(4, seed=2)
        rids = [probe.submit(p) for p in prompts]
        eos = probe.run()[rids[0]][2]
        jcb, tcb = _pair(f32_gqa, 6, eos_id=eos, slots=2, cache_len=22,
                         prompt_bucket=16)
        out = _lockstep(jcb, tcb, prompts)
        assert len(out[0]) == 2  # request 0 retired at its EOS
        assert all(eos not in t for t in out.values())

    def test_chunked_admission(self, f32_gqa):
        jcb, tcb = _pair(f32_gqa, 6, slots=2, cache_len=32, prompt_bucket=16,
                         admit_chunk=4)
        seen = []

        def admitting(step, jcb, tcb):
            seen.append(tcb._admitting is not None)
            assert (jcb._admitting is None) == (tcb._admitting is None)

        _lockstep(jcb, tcb, _prompts(4, seed=3), between=admitting)
        assert any(seen)

    def test_ragged_admission_with_room(self, f32_gqa):
        jcb, tcb = _pair(f32_gqa, 8, slots=2, cache_len=64, prompt_bucket=16,
                         admit_chunk=8, ragged=True)
        _lockstep(jcb, tcb, _prompts(4, seed=4))

    def test_int8_cache(self, f32_gqa):
        jcb, tcb = _pair(f32_gqa, 6, slots=3, cache_len=32, prompt_bucket=16,
                         kv_bits=8)
        _lockstep(jcb, tcb, _prompts(5, seed=5))
        assert tcb.cache["k"].dtype == torch.int8
        assert tcb._attn_kernel == 0

    def test_int8_chunked_admission(self, f32_gqa):
        jcb, tcb = _pair(f32_gqa, 5, slots=2, cache_len=32, prompt_bucket=16,
                         kv_bits=8, admit_chunk=8)
        _lockstep(jcb, tcb, _prompts(3, seed=6))

    def test_cancel_mid_chunked_admission(self, f32_gqa):
        jcb, tcb = _pair(f32_gqa, 6, slots=2, cache_len=32, prompt_bucket=16,
                         admit_chunk=4)

        def cancel_first(step, jcb, tcb):
            if step == 1:
                for eng in (jcb, tcb):
                    assert eng._admitting["req"].rid == 0
                    assert eng.cancel(0)

        _lockstep(jcb, tcb, _prompts(3, seed=7, lo=12), between=cancel_first)
        assert tcb.run_aborted() == jcb.run_aborted() == {0: "cancelled"}


def test_submit_validation_and_empty_run(f32_gqa):
    jcb, tcb = _pair(f32_gqa, 8, slots=2, cache_len=64, prompt_bucket=16)
    for bad, match in (([], "empty"), (list(range(20)), "exceeds bucket")):
        with pytest.raises(ValueError, match=match) as jerr:
            jcb.submit(bad)
        with pytest.raises(ValueError) as terr:
            tcb.submit(bad)
        assert str(terr.value) == str(jerr.value)
    assert tcb.run() == jcb.run() == {}


def _refusal(make):
    with pytest.raises((ValueError, NotImplementedError)) as info:
        make()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("kw", [
    dict(cache_len=64),                               # max_new 128 overflows
    dict(max_new=8, admit_chunk=5),
    dict(max_new=8, ragged=True),
    dict(max_new=8, ragged=True, admit_chunk=8, kv_bits=8),
    dict(max_new=8, ragged=True, admit_chunk=8, attn_kernel=True),
    dict(max_new=8, attn_kernel=True, kv_bits=8),
    dict(max_new=8, attn_kernel=True, window=8),
    dict(max_new=8, admit_chunk=8, plan=True),
    dict(max_new=8, attn_kernel=True, plan=True),
])
def test_constructor_refusals_carry_the_jax_messages(f32_gqa, kw):
    """Each refusal with JAX's type and text. The one deliberate
    difference: JAX refuses ``attn_kernel=True`` with ``plan=``, the port
    accepts the pair (a rank's cache is its own), so on the CPU it refuses
    only for want of the card."""
    jcfg, tcfg, jparams, tparams = f32_gqa
    kw = dict(kw)
    max_new = kw.pop("max_new", 128)
    if kw.pop("window", 0):
        jcfg = dataclasses.replace(jcfg, sliding_window=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8)
    planned = kw.pop("plan", False)
    jplan = JM.MeshPlan(JM.make_mesh(devices=jax.devices()[:1])) \
        if planned else None
    tplan = TM.MeshPlan(TM.make_mesh()) if planned else None
    base = dict(slots=2, cache_len=kw.pop("cache_len", 64), prompt_bucket=16,
                **kw)
    jerr = _refusal(lambda: JC.ContinuousBatcher(
        jparams, jcfg, gen=JGen(max_new_tokens=max_new), plan=jplan, **base))
    # Under a plan the engine takes a rank's shard, cut here.
    terr = _refusal(lambda: TC.ContinuousBatcher(
        tplan.shard_params(copy.deepcopy(tparams)) if planned else tparams,
        tcfg, gen=TGen(max_new_tokens=max_new),
        device="cpu", plan=tplan, **base))
    if planned and kw.get("attn_kernel"):
        assert "does not compose with plan=" in jerr[1]
        assert terr[0] is ValueError and "needs the CUDA card" in terr[1]
        return
    assert terr == jerr


def test_port_only_refusals(f32_gqa, monkeypatch):
    """The port's own refusals: a sequence-sharded plan is item 13, and
    the dense kernel needs the card. A tp plan constructs (its kv heads
    on this rank); on the card it takes ``attn_kernel=True``, which JAX
    refuses with a plan, and goes on to its next check."""
    _, tcfg, _, tparams = f32_gqa
    kw = dict(gen=TGen(max_new_tokens=8), slots=2, cache_len=64,
              prompt_bucket=16, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        TC.ContinuousBatcher(tparams, tcfg, plan=TM.MeshPlan(
            TM.make_mesh(sp=2, devices=[0, 1])), **kw)
    one = TM.MeshPlan(TM.make_mesh())
    shard = one.shard_params(copy.deepcopy(tparams))
    cb = TC.ContinuousBatcher(shard, tcfg, plan=one, **kw)
    assert cb.mesh_axes == {"tp": 1} and cb._attn_kernel == 0
    with monkeypatch.context() as m:
        m.setattr(TC, "resolve_device", lambda device: torch.device("cuda"))
        bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="params live on"):
            TC.ContinuousBatcher(shard, bf16, attn_kernel=True, plan=one,
                                 **dict(kw, device=None))
    with pytest.raises(ValueError, match="CUDA card"):
        TC.ContinuousBatcher(tparams, tcfg, attn_kernel=True, **kw)
    cb = TC.ContinuousBatcher(tparams, tcfg, **kw)
    assert cb._attn_kernel == 0 and cb.ragged is False


def test_dense_kernel_needs_a_bf16_model(f32_gqa, monkeypatch):
    """On the card the kernel reads bf16 only: an explicit ``attn_kernel``
    with an f32 model is refused, and the default leaves it off (the
    constructor goes on to its next check, the params' device)."""
    _, tcfg, _, tparams = f32_gqa
    monkeypatch.setattr(TC, "resolve_device",
                        lambda device: torch.device("cuda"))
    kw = dict(gen=TGen(max_new_tokens=8), slots=2, cache_len=64,
              prompt_bucket=16)
    with pytest.raises(ValueError, match="needs a bf16 cache"):
        TC.ContinuousBatcher(tparams, tcfg, attn_kernel=True, **kw)
    with pytest.raises(ValueError, match="params live on"):
        TC.ContinuousBatcher(tparams, tcfg, **kw)


@pytest.mark.parametrize("cache_len,chunk", [(1024, 512), (768, 256),
                                             (80, 16), (100, 0)])
def test_kernel_block_size_matches_jax(cache_len, chunk, monkeypatch):
    """The block-size rule on the card: the largest power of two in
    [16, 512] dividing cache_len (JAX's rule, asked of the TPU backend).
    Where none divides, JAX turns its kernel off (0) and the port keeps
    the CUDA kernel on with block_size = cache_len."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jcfg = L.LLAMA_CONFIGS["tiny"]
    jcb = JC.ContinuousBatcher(L.init_params(jcfg, jax.random.PRNGKey(0)),
                               jcfg, gen=JGen(max_new_tokens=8), slots=1,
                               cache_len=cache_len, prompt_bucket=16)
    assert jcb._attn_kernel == chunk
    assert TC._kernel_block_size(cache_len) == (chunk or cache_len)


@pytest.mark.parametrize("cache_len,block", [(1000, 1000), (1024, 512)])
def test_dense_kernel_default_on_the_card_at_any_cache_len(cache_len, block,
                                                           monkeypatch):
    """On the card the default turns the kernel on for a bf16 cache of any
    length, with a block size dividing it. The device is patched to CUDA,
    so the constructor stops at its params check, after the choice."""
    monkeypatch.setattr(TC, "resolve_device",
                        lambda device: torch.device("cuda"))
    cfg = TL.LLAMA_CONFIGS["tiny"]
    assert cfg.dtype == torch.bfloat16
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cb = TC.ContinuousBatcher.__new__(TC.ContinuousBatcher)
    with pytest.raises(ValueError, match="params live on"):
        cb.__init__(params, cfg, gen=TGen(max_new_tokens=8), slots=1,
                    cache_len=cache_len, prompt_bucket=16)
    assert cb._attn_kernel == block
    TPA._validate_dense(torch.zeros(1, cfg.n_heads, cfg.head_dim),
                        torch.zeros(1, cfg.n_kv_heads, cache_len,
                                    cfg.head_dim),
                        torch.zeros(1, cache_len, dtype=torch.bool), block)


def _t(x):
    a = np.asarray(x)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_cb_step_with_the_dense_kernel_branch(f32_gqa, kv_bits):
    """``_cb_step(attn_kernel=256)`` at mixed positions with an idle slot:
    JAX interprets the Pallas dense kernel (bf16 cache only; an int8 cache
    keeps the XLA attention on both sides), the port runs the wrapper's
    plain version. Next tokens equal, logprobs and the written cache within
    1e-5."""
    jcfg, tcfg, jparams, tparams = f32_gqa
    rng = np.random.default_rng(8)
    b, c = 3, 256
    cache_j = L.init_kv_cache(jcfg, b, c, kv_bits=kv_bits)
    cache_j = {n: (jnp.asarray(rng.normal(size=leaf.shape).astype(np.float32)
                               ).astype(leaf.dtype)
                   if leaf.dtype != jnp.int8 else
                   jnp.asarray(rng.integers(-127, 128, size=leaf.shape),
                               jnp.int8))
               for n, leaf in cache_j.items()}
    cache_np = {n: np.asarray(leaf.astype(jnp.float32) if leaf.dtype
                              == jnp.bfloat16 else leaf)
                for n, leaf in cache_j.items()}
    cache_t = {n: (torch.from_numpy(a.copy()).to(torch.bfloat16)
                   if cache_j[n].dtype == jnp.bfloat16
                   else torch.from_numpy(a.copy()))
               for n, a in cache_np.items()}
    tokens = np.array([[5], [77], [0]], np.int32)
    positions = np.array([40, 200, 0], np.int32)
    kv_mask = np.ones((b, c), bool)
    kv_mask[0, :7] = False  # left padding
    kv_mask[2] = False      # an idle slot
    temps = np.zeros(b, np.float32)
    jn, jl, jcache = JC._cb_step(
        jparams, jcfg, jnp.asarray(tokens), cache_j, jnp.asarray(positions),
        jnp.asarray(kv_mask), jax.random.PRNGKey(0), jnp.asarray(temps), 0,
        1.0, attn_kernel=256)
    before = TPA.dense_decode_attention.launches
    tn, tlp = TC._cb_step(
        tparams, tcfg, _t(tokens), cache_t, _t(positions), _t(kv_mask),
        torch.Generator().manual_seed(0), _t(temps), 0, 1.0, attn_kernel=256)
    assert TPA.dense_decode_attention.launches == before  # CPU: plain
    np.testing.assert_array_equal(tn.numpy()[:2], np.asarray(jn)[:2])
    np.testing.assert_allclose(tlp.numpy()[:2], np.asarray(jl)[:2],
                               atol=1e-5)
    for name, leaf in jcache.items():
        ref = np.asarray(leaf.astype(jnp.float32) if leaf.dtype
                         == jnp.bfloat16 else leaf)
        got = cache_t[name].float().numpy()
        if leaf.dtype == jnp.int8:
            assert np.abs(got - ref).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_ragged_engine_near_the_cache_end_matches_one_shot(f32_gqa):
    """Port only. At cache_len 40 (bucket 16 + 24 new tokens) decode rows
    of the ragged engine write 8-column chunks past the cache's end; the
    port clips them, so its tokens equal the one-shot engine's. (JAX's
    ragged engine forks from its one-shot engine on these prompts at
    tokens 18-19.)"""
    _, tcfg, _, tparams = f32_gqa
    prompts = _prompts(4, seed=9)

    def serve(**kw):
        cb = TC.ContinuousBatcher(tparams, tcfg,
                                  gen=TGen(max_new_tokens=24, eos_id=-1),
                                  slots=2, cache_len=40, prompt_bucket=16,
                                  device="cpu", **kw)
        rids = [cb.submit(p) for p in prompts]
        out = cb.run()
        return [out[r] for r in rids]

    one_shot = serve()
    assert all(len(t) == 24 for t in one_shot)
    assert serve(admit_chunk=8, ragged=True) == one_shot


def test_cache_store_rows_clips_at_the_end():
    """Row 0 fits; row 1 runs 2 columns past C = 8 and writes its first
    2; row 2 starts past the end and writes nothing. int8 values and
    scales follow the same rule."""
    rng = np.random.default_rng(10)
    for kv_bits in (0, 8):
        cache = TL._kv_cache_leaves((3, 2, 8, 4), torch.float32, kv_bits)
        before = {n: leaf.clone() for n, leaf in cache.items()}
        k = torch.from_numpy(rng.normal(size=(3, 2, 4, 4)).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=(3, 2, 4, 4)).astype(np.float32))
        TL._cache_store_rows(cache, k, v, torch.tensor([1, 6, 9]))
        want_k, want_v = k, v
        if kv_bits:
            want_k, ks = TL._kv_quantize(k)
            want_v, vs = TL._kv_quantize(v)
        for name, new in (("k", want_k), ("v", want_v)):
            leaf = cache[name]
            assert torch.equal(leaf[0, :, 1:5], new[0])
            assert torch.equal(leaf[1, :, 6:8], new[1, :, :2])
            assert torch.equal(leaf[2], before[name][2])
            assert torch.equal(leaf[0, :, :1], before[name][0, :, :1])
            assert torch.equal(leaf[1, :, :6], before[name][1, :, :6])
        if kv_bits:
            assert torch.equal(cache["k_scale"][1, :, 6:8], ks[1, :, :2])
            assert torch.equal(cache["v_scale"][0, :, 1:5], vs[0])


# -- sliding-window configs ---------------------------------------------------


@pytest.mark.parametrize("entry", ["oneshot", "ragged", "generate"])
def test_sliding_window_parity(f32_gqa, entry):
    """A ``sliding_window=8`` config with prompts longer than the window:
    the dense engine with one-shot admission and with ragged admission in
    lockstep with JAX's (the window in the flash prefill, the chunked
    admissions and the gathered decode), and ``generate`` token for token
    against JAX's."""
    jcfg, tcfg, jparams, tparams = f32_gqa
    models = (dataclasses.replace(jcfg, sliding_window=8),
              dataclasses.replace(tcfg, sliding_window=8), jparams, tparams)
    prompts = _prompts(4, seed=5, lo=10, hi=16)
    if entry == "generate":
        toks = np.asarray([p[:10] for p in prompts], np.int32)
        ref = np.asarray(L.generate(jparams, models[0], jnp.asarray(toks),
                                    steps=8, cache_len=24))
        out = TL.generate(tparams, models[1], torch.from_numpy(toks),
                          steps=8, cache_len=24)
        np.testing.assert_array_equal(out.numpy(), ref)
        return
    kw = ({"ragged": True, "admit_chunk": 8, "cache_len": 40}
          if entry == "ragged" else {"cache_len": 32})
    jcb, tcb = _pair(models, 8, slots=2, prompt_bucket=16, **kw)
    out = _lockstep(jcb, tcb, prompts)
    assert all(len(t) == 8 for t in out.values())
