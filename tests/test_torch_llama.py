"""PyTorch port of models/llama.py vs the JAX reference, op by op.

The same numpy inputs, made from a seed, go through the JAX function and
its port. Tolerances: f32 1e-5; bf16 within one unit in the last place
(the two frameworks may round a sum at another point); ``_kv_quantize``
byte-equal (it is a storage format); the filters and greedy sampling
exact; sampled draws only structurally (a torch Generator cannot
reproduce ``jax.random``'s bits).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models.bridge import params_from_jax


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """bf16 values as order-preserving integers (ulp distance = difference)."""
    if isinstance(x, torch.Tensor):
        b = x.detach().contiguous().view(torch.int16).numpy().astype(np.int32)
    else:
        b = np.asarray(x).view(np.int16).astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _close(jx, tx, dtype):
    if dtype == "bf16":
        assert tx.dtype == torch.bfloat16
        diff = np.abs(_bits(jx) - _bits(tx))
        assert diff.max() <= 1, f"{diff.max()} ulp apart"
    else:
        np.testing.assert_allclose(np.asarray(tx, np.float32),
                                   np.asarray(jx, np.float32),
                                   rtol=1e-5, atol=1e-5)


def _pair(x: np.ndarray, dtype: str):
    """One f32 numpy array as (jax, torch) arrays of ``dtype`` — both
    round f32 → bf16 to nearest even, so the inputs are bit-identical."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _cfgs(name, dtype, **kw):
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    return (dataclasses.replace(L.LLAMA_CONFIGS[name], dtype=jd, **kw),
            dataclasses.replace(TL.LLAMA_CONFIGS[name], dtype=td, **kw))


def _model(name, dtype, seed=0, **kw):
    """JAX init_params → numpy (biases randomized) → both frameworks."""
    jcfg, tcfg = _cfgs(name, dtype, **kw)
    tree = jax.tree.map(np.asarray, L.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):
        if b in tree["layers"]:
            tree["layers"][b] = np.asarray(
                jnp.asarray(rng.normal(size=tree["layers"][b].shape)
                            .astype(np.float32), jcfg.dtype))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jparams, params_from_jax(tree, tcfg, device="cpu")


class TestConfig:
    def test_every_config_has_the_same_fields_and_values(self):
        assert list(TL.LLAMA_CONFIGS) == list(L.LLAMA_CONFIGS)
        for name, jcfg in L.LLAMA_CONFIGS.items():
            tcfg = TL.LLAMA_CONFIGS[name]
            jf = {f.name for f in dataclasses.fields(jcfg)}
            assert jf == {f.name for f in dataclasses.fields(tcfg)}
            for field in jf:
                jv, tv = getattr(jcfg, field), getattr(tcfg, field)
                if field == "dtype":
                    assert np.dtype(jv).name == str(tv).removeprefix("torch.")
                elif field == "rope_scaling" and jv is not None:
                    assert dataclasses.asdict(jv) == dataclasses.asdict(tv)
                else:
                    assert jv == tv, (name, field)
            assert jcfg.head_dim == tcfg.head_dim
            assert jcfg.param_count() == tcfg.param_count()


class TestLayers:
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("add_unit", [False, True])
    def test_rms_norm(self, dtype, add_unit):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(3, 5, 64)).astype(np.float32)
        w = rng.normal(size=(64,)).astype(np.float32)
        (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
        _close(L.rms_norm(jx, jw, 1e-5, add_unit),
               TL.rms_norm(tx, tw, 1e-5, add_unit), dtype)

    @pytest.mark.parametrize("name", ["tiny", "llama-3-8b", "llama-3.1-8b"])
    def test_rope_frequencies(self, name):
        jcfg, tcfg = L.LLAMA_CONFIGS[name], TL.LLAMA_CONFIGS[name]
        pos = np.arange(0, 64, dtype=np.int32)
        jc, js = L.rope_frequencies(jcfg, jnp.asarray(pos))
        tc, ts = TL.rope_frequencies(tcfg, torch.from_numpy(pos))
        _close(jc, tc, "f32")
        _close(js, ts, "f32")

    def test_llama3_scale_freqs(self):
        rs = L.RopeScaling()
        freqs = 500000.0 ** (-np.arange(64, dtype=np.float32) / 64)
        _close(L._llama3_scale_freqs(rs, jnp.asarray(freqs)),
               TL._llama3_scale_freqs(TL.RopeScaling(), torch.from_numpy(freqs)),
               "f32")

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("rank", ["shared", "per_batch", "per_row_pos"])
    def test_apply_rope(self, dtype, rank):
        rng = np.random.default_rng(2)
        b, h, s, d = 3, 4, (1 if rank == "per_batch" else 5), 32
        x = rng.normal(size=(b, h, s, d)).astype(np.float32)
        shape = {"shared": (s, d // 2), "per_batch": (b, d // 2),
                 "per_row_pos": (b, s, d // 2)}[rank]
        ang = rng.uniform(-3, 3, size=shape).astype(np.float32)
        c, sn = np.cos(ang), np.sin(ang)
        jx, tx = _pair(x, dtype)
        pb = rank == "per_batch"
        _close(L.apply_rope(jx, jnp.asarray(c), jnp.asarray(sn), per_batch=pb),
               TL.apply_rope(tx, torch.from_numpy(c), torch.from_numpy(sn),
                             per_batch=pb), dtype)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("act", ["silu", "gelu"])
    def test_mlp(self, dtype, act):
        jcfg, tcfg, jp, tp = _model("tiny", dtype, act=act)
        x = np.random.default_rng(3).normal(size=(2, 3, 128)).astype(np.float32)
        jx, tx = _pair(x, dtype)
        layer = jax.tree.map(lambda a: a[0], jp["layers"])
        _close(L._mlp(layer, jx, jcfg), TL._mlp(tp.layers[0], tx, tcfg), dtype)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_qkv_with_bias(self, dtype):
        jcfg, tcfg, jp, tp = _model("tiny-gqa", dtype, attn_bias=True)
        x = np.random.default_rng(4).normal(size=(2, 3, 128)).astype(np.float32)
        jx, tx = _pair(x, dtype)
        layer = jax.tree.map(lambda a: a[1], jp["layers"])
        for j, t in zip(L._qkv(jx, layer), TL._qkv(tx, tp.layers[1])):
            _close(j, t, dtype)

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("tied", [False, True])
    def test_lm_head_logits(self, dtype, tied):
        jcfg, tcfg, jp, tp = _model("tiny", dtype, tie_embeddings=tied)
        assert ("lm_head" in jp) == (tp.lm_head is not None) == (not tied)
        x = np.random.default_rng(5).normal(size=(4, 128)).astype(np.float32)
        jx, tx = _pair(x, dtype)
        out = TL._lm_head_logits(tx, tp)
        assert out.dtype == torch.float32
        ref = L._lm_head_logits(jx, jp)
        if dtype == "bf16":
            # Product in bf16, then f32: compare the bf16 values.
            _close(ref.astype(jnp.bfloat16), out.to(torch.bfloat16), dtype)
        else:
            _close(ref, out, dtype)

    def test_embed_scale(self):
        jcfg, tcfg, jp, tp = _model("tiny", "bf16", embed_scale=True)
        toks = np.array([[1, 7, 255]], np.int32)
        _close(L._embed(jp, jcfg, jnp.asarray(toks)),
               TL._embed(tp, tcfg, torch.from_numpy(toks).long()), "bf16")


class TestKvQuantize:
    @pytest.mark.parametrize("case", ["random", "ties", "zeros"])
    def test_values_and_scales_byte_equal(self, case):
        rng = np.random.default_rng(6)
        x = rng.normal(size=(2, 3, 7, 64)).astype(np.float32) * 3
        if case == "ties":
            # amax 127 → scale exactly 1, so x / scale lands on .5 ties.
            x = np.round(rng.uniform(-120, 120, size=x.shape)) + 0.5
            x[..., 0] = 127.0
            x = x.astype(np.float32)
        elif case == "zeros":
            x[:, 1] = 0.0
        for dtype in ("f32", "bf16"):
            jx, tx = _pair(x, dtype)
            jq, js = L._kv_quantize(jx)
            tq, ts = TL._kv_quantize(tx)
            assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(
                ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))

    def test_cache_leaves(self):
        leaves = TL._kv_cache_leaves((2, 3, 4, 8), torch.bfloat16, 8)
        ref = L._kv_cache_leaves((2, 3, 4, 8), jnp.bfloat16, 8)
        assert set(leaves) == set(ref)
        for name, leaf in leaves.items():
            assert tuple(leaf.shape) == ref[name].shape
            assert str(leaf.dtype).removeprefix("torch.") == str(ref[name].dtype)
        with pytest.raises(ValueError, match="kv_bits"):
            TL._kv_cache_leaves((2, 3), torch.bfloat16, 4)


class TestSampling:
    @pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9),
                                             (7, 0.6)])
    def test_filter_top_k_top_p_exact(self, top_k, top_p):
        logits = np.random.default_rng(7).normal(size=(6, 50)).astype(
            np.float32) * 3
        ref = np.asarray(L._filter_top_k_top_p(jnp.asarray(logits), top_k, top_p))
        out = TL._filter_top_k_top_p(torch.from_numpy(logits), top_k, top_p)
        np.testing.assert_array_equal(out.numpy(), ref)

    def test_greedy_rows_exact_first_index_on_ties(self):
        logits = np.random.default_rng(8).normal(size=(5, 40)).astype(np.float32)
        logits[2, [3, 9]] = 10.0  # a tie: argmax takes the first index
        temps = np.zeros(5, np.float32)
        ref = L.sample_logits_per_row(jnp.asarray(logits), jax.random.PRNGKey(0),
                                      jnp.asarray(temps))
        out = TL.sample_logits_per_row(torch.from_numpy(logits),
                                       torch.Generator().manual_seed(0),
                                       torch.from_numpy(temps))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert int(out[2]) == 3
        greedy = TL.sample_logits(torch.from_numpy(logits),
                                  torch.Generator(), temperature=0.0)
        np.testing.assert_array_equal(greedy.numpy(), np.asarray(ref))

    def test_sampled_rows_stay_inside_top_k_and_top_p(self):
        """Draws cannot match JAX's bit for bit; they must land inside
        the filtered set, and greedy rows stay argmax."""
        rng = np.random.default_rng(9)
        logits = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
        temps = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.0, 2.0, 0.5, 1.0])
        gen = torch.Generator().manual_seed(1)
        for top_k, top_p in ((4, 1.0), (0, 0.5), (6, 0.8)):
            for _ in range(20):
                out = TL.sample_logits_per_row(logits, gen, temps, top_k, top_p)
                allowed = TL._filter_top_k_top_p(
                    logits / torch.clamp_min(temps, 1e-6)[:, None], top_k, top_p
                ) > TL.NEG_INF
                assert bool(allowed[torch.arange(8), out].all())
                greedy = temps <= 0
                assert torch.equal(out[greedy], logits.argmax(-1)[greedy])
        draws = {int(TL.sample_logits(logits[1:2], gen, 1.0)[0])
                 for _ in range(50)}
        assert len(draws) > 1  # it does sample


class TestFullSequence:
    """``forward`` and ``_prefill_impl`` (logits and the primed cache) at
    1e-5 on f32 ``tiny`` and ``tiny-gqa``; JAX runs its XLA attention on
    the CPU and the port its plain flash version. int8 caches: values
    within 1 count, scales within 1e-5 relative (a last-bit difference in
    K can move a value across a rounding boundary)."""

    @staticmethod
    def _tokens(b, s, seed):
        return np.random.default_rng(seed).integers(3, 256, size=(b, s)) \
            .astype(np.int32)

    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_forward(self, name):
        jcfg, tcfg, jp, tp = _model(name, "f32")
        toks = self._tokens(2, 12, seed=10)
        ref = L.forward(jp, jcfg, jnp.asarray(toks))
        out = TL.forward(tp, tcfg, torch.from_numpy(toks))
        assert out.dtype == torch.float32
        _close(ref, out, "f32")
        hidden = TL.forward_hidden(tp, tcfg, torch.from_numpy(toks))
        _close(L.forward_hidden(jp, jcfg, jnp.asarray(toks)), hidden, "f32")

    @pytest.mark.parametrize("kv_bits", [0, 8])
    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_prefill_left_padded(self, name, kv_bits):
        jcfg, tcfg, jp, tp = _model(name, "f32")
        toks = self._tokens(3, 16, seed=11)
        # Left padding: row 1 has 5 pads, row 2 has 11.
        mask = np.arange(16)[None, :] >= np.array([[0], [5], [11]])
        toks = np.where(mask, toks, 0).astype(np.int32)
        jl, jc = L._prefill_impl(jp, jcfg, jnp.asarray(toks),
                                 L.init_kv_cache(jcfg, 3, 16, kv_bits),
                                 kv_mask=jnp.asarray(mask))
        cache = TL.init_kv_cache(tcfg, 3, 16, kv_bits, device="cpu")
        tl, tc = TL._prefill_impl(tp, tcfg, torch.from_numpy(toks), cache,
                                  kv_mask=torch.from_numpy(mask))
        assert tc is cache  # written in place
        _close(jl, tl, "f32")
        assert set(tc) == set(jc)
        for leaf, ref in jc.items():
            got = tc[leaf]
            assert tuple(got.shape) == ref.shape
            if leaf in ("k", "v") and kv_bits:
                diff = np.abs(got.numpy().astype(np.int32)
                              - np.asarray(ref).astype(np.int32))
                assert diff.max() <= 1
            elif kv_bits:
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                    rtol=1e-5, atol=0)
            else:
                _close(ref, got, "f32")

    def test_prefill_entry_point(self):
        jcfg, tcfg, jp, tp = _model("tiny-gqa", "f32")
        toks = self._tokens(1, 8, seed=12)
        jl, _ = L.prefill(jp, jcfg, jnp.asarray(toks),
                          L.init_kv_cache(jcfg, 1, 8))
        tl, _ = TL.prefill(tp, tcfg, torch.from_numpy(toks),
                           TL.init_kv_cache(tcfg, 1, 8, device="cpu"))
        _close(jl, tl, "f32")


@pytest.mark.parametrize("int8", [False, True])
def test_gqa_decode_attention(int8):
    rng = np.random.default_rng(13)
    b, h, hkv, length, d = 3, 4, 2, 24, 32
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, length, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, length, d)).astype(np.float32)
    pos = np.array([3, 17, 23], np.int32)
    mask = rng.random((b, length)) > 0.2
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    kw = {}
    if int8:
        jk, ks = L._kv_quantize(jk)
        jv, vs = L._kv_quantize(jv)
        kw = dict(k_scale=ks, v_scale=vs)
    ref = L._gqa_decode_attention(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                  kv_mask=jnp.asarray(mask), per_batch=True,
                                  **kw)

    def t(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    out = TL._gqa_decode_attention(
        t(q), t(jk), t(jv), t(pos), kv_mask=t(mask), per_batch=True,
        **{k_: t(v_) for k_, v_ in kw.items()})
    _close(ref, out, "f32")


class TestDecodeFamily:
    """The cached-chunk decode family and the generation loops at 1e-5
    (tokens exact) on f32 ``tiny`` and ``tiny-gqa``: JAX's jitted programs
    against the port's in-place loops, on one primed cache each."""

    @staticmethod
    def _primed(name, kv_bits=0, b=2, s=8, cache_len=32, seed=20):
        jcfg, tcfg, jp, tp = _model(name, "f32")
        toks = np.random.default_rng(seed).integers(3, 256, size=(b, s)) \
            .astype(np.int32)
        _, jc = L._prefill_impl(jp, jcfg, jnp.asarray(toks),
                                L.init_kv_cache(jcfg, b, cache_len, kv_bits))
        _, tc = TL._prefill_impl(tp, tcfg, torch.from_numpy(toks),
                                 TL.init_kv_cache(tcfg, b, cache_len, kv_bits,
                                                  device="cpu"))
        return jcfg, tcfg, jp, tp, jc, tc

    @staticmethod
    def _cache_close(jc, tc):
        for leaf, ref in jc.items():
            got = tc[leaf]
            if got.dtype == torch.int8:
                diff = np.abs(got.numpy().astype(np.int32)
                              - np.asarray(ref).astype(np.int32))
                assert diff.max() <= 1, leaf
            elif got.dtype == torch.bfloat16:
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                    rtol=1e-5, atol=0)
            else:
                _close(ref, got, "f32")

    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_decode_step(self, name):
        jcfg, tcfg, jp, tp, jc, tc = self._primed(name)
        tok = np.array([[7], [200]], np.int32)
        jl, jc = L.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                               jnp.asarray(8, jnp.int32))
        tl, out = TL.decode_step(tp, tcfg, torch.from_numpy(tok), tc, 8)
        assert out is tc  # written in place
        _close(jl, tl, "f32")
        self._cache_close(jc, tc)

    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_decode_chunk_with_left_padding(self, name):
        jcfg, tcfg, jp, tp, jc, tc = self._primed(name)
        chunk = np.random.default_rng(21).integers(3, 256, size=(2, 5)) \
            .astype(np.int32)
        mask = np.ones((2, 32), bool)
        mask[1, :3] = False
        jl, jc = L._decode_chunk_impl(jp, jcfg, jnp.asarray(chunk), jc,
                                      jnp.asarray(8, jnp.int32),
                                      kv_mask=jnp.asarray(mask))
        tl, _ = TL._decode_chunk_impl(tp, tcfg, torch.from_numpy(chunk), tc,
                                      8, kv_mask=torch.from_numpy(mask))
        _close(jl, tl, "f32")
        self._cache_close(jc, tc)

    @pytest.mark.parametrize("kv_bits", [0, 8])
    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_decode_chunk_batch_per_row_offsets(self, name, kv_bits):
        jcfg, tcfg, jp, tp, jc, tc = self._primed(name, kv_bits, b=3)
        chunk = np.random.default_rng(22).integers(3, 256, size=(3, 4)) \
            .astype(np.int32)
        positions = np.array([8, 11, 20], np.int32)
        jl, jc = L._decode_chunk_batch_impl(jp, jcfg, jnp.asarray(chunk), jc,
                                            jnp.asarray(positions))
        tl, _ = TL._decode_chunk_batch_impl(tp, tcfg, torch.from_numpy(chunk),
                                            tc, torch.from_numpy(positions))
        if kv_bits:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                       atol=1e-4)
        else:
            _close(jl, tl, "f32")
        self._cache_close(jc, tc)

    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_prefill_chunked(self, name):
        jcfg, tcfg, jp, tp = _model(name, "f32")
        toks = np.random.default_rng(23).integers(3, 256, size=(2, 12)) \
            .astype(np.int32)
        jl, jc = L.prefill_chunked(jp, jcfg, jnp.asarray(toks),
                                   L.init_kv_cache(jcfg, 2, 16), chunk=4)
        tl, tc = TL.prefill_chunked(tp, tcfg, torch.from_numpy(toks),
                                    TL.init_kv_cache(tcfg, 2, 16,
                                                     device="cpu"), chunk=4)
        _close(jl, tl, "f32")
        self._cache_close(jc, tc)
        with pytest.raises(ValueError, match="not divisible by chunk 5"):
            TL.prefill_chunked(tp, tcfg, torch.from_numpy(toks),
                               TL.init_kv_cache(tcfg, 2, 16, device="cpu"),
                               chunk=5)
        primed = TL.prime_kv_cache(tp, tcfg, torch.from_numpy(toks),
                                   TL.init_kv_cache(tcfg, 2, 16,
                                                    device="cpu"))
        self._cache_close(L.prime_kv_cache(jp, jcfg, jnp.asarray(toks),
                                           L.init_kv_cache(jcfg, 2, 16)),
                          primed)

    @pytest.mark.parametrize("kv_bits", [0, 8])
    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_generate_greedy_and_sample_at_temperature_zero(self, name,
                                                            kv_bits):
        jcfg, tcfg, jp, tp = _model(name, "f32")
        prompt = np.random.default_rng(24).integers(3, 256, size=(2, 6)) \
            .astype(np.int32)
        jt, tt = jnp.asarray(prompt), torch.from_numpy(prompt)
        ref = np.asarray(L.generate(jp, jcfg, jt, steps=7, cache_len=16,
                                    kv_bits=kv_bits))
        np.testing.assert_array_equal(
            TL.generate(tp, tcfg, tt, steps=7, cache_len=16,
                        kv_bits=kv_bits).numpy(), ref)
        if kv_bits:
            return
        np.testing.assert_array_equal(
            TL.sample(tp, tcfg, tt, torch.Generator(), steps=7, cache_len=16,
                      temperature=0.0).numpy(),
            np.asarray(L.sample(jp, jcfg, jt, jax.random.PRNGKey(0), steps=7,
                                cache_len=16, temperature=0.0)))
        np.testing.assert_array_equal(
            TL.generate_tokens(tp, tcfg, tt,
                               TL.init_kv_cache(tcfg, 2, 16, device="cpu"),
                               steps=7).numpy(), ref)
        np.testing.assert_array_equal(
            TL.greedy_generate(tp, tcfg, tt, 7).numpy(),
            np.asarray(L.greedy_generate(jp, jcfg, jt, 7)))

    def test_sample_draws_stay_in_the_vocab(self):
        _, tcfg, _, tp = _model("tiny", "f32")
        prompt = torch.from_numpy(np.full((2, 4), 9, np.int32))
        out = TL.sample(tp, tcfg, prompt, torch.Generator().manual_seed(3),
                        steps=5, cache_len=12, temperature=1.0, top_k=8)
        assert tuple(out.shape) == (2, 5)
        assert bool(((out >= 0) & (out < tcfg.vocab_size)).all())
