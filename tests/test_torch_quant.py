"""PyTorch port of models/quant.py and the serving half of models/fp8.py
vs the JAX reference.

The same numpy weights, made from a seed, are quantized by both: int8,
int4 (groups 32 and 128, compared unpacked) and fp8 values and scales
agree byte for byte (a storage format), stacked ``(L, in, out)`` leaves
and ``(V, D)`` heads alike, and whole models cross the bridge both ways
unchanged. The products' plain versions hold JAX's ``_mm`` and
``_lm_head_logits`` within 1e-5 in f32 and one bf16 unit in the last
place in bf16; f32 ``forward`` within 1e-5; the quantized ragged
``PagedBatcher`` and ``ContinuousBatcher`` emit JAX's tokens step by step,
logprobs within 1e-4. The entry points run on the CPU when asked to and
refuse what the port lacks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.api.annotations import QUANT_ENV_NAME
from kubeflow_tpu.models import continuous as JC
from kubeflow_tpu.models import fp8 as JF
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models import quant as JQ
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu_torch.models import continuous as TC
from kubeflow_tpu_torch.models import fp8 as TF
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models import quant as TQ
from kubeflow_tpu_torch.models.bridge import params_from_jax, params_to_numpy
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.ops import quant_matmul as QM


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


def _weights(shape, dtype, seed):
    """One numpy weight as (jax, torch) arrays of ``dtype``, bit-identical;
    a zero channel and a zero group exercise the 1e-8 floor."""
    w = (np.random.default_rng(seed).normal(size=shape) * 0.02).astype(
        np.float32)
    w[..., 0] = 0.0
    w[..., :32, 1] = 0.0
    if dtype == "bf16":
        return (jnp.asarray(w, jnp.bfloat16),
                torch.from_numpy(w).to(torch.bfloat16))
    return jnp.asarray(w), torch.from_numpy(w)


def _q_bytes(q) -> np.ndarray:
    """A JAX or port value tensor as comparable integers (fp8 as its
    bytes, int4 unpacked)."""
    if isinstance(q, TQ.QuantizedWeight):
        q = q.values()
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn
                else q).numpy().astype(np.int16)
    q = np.asarray(q)
    if q.dtype.name == "float8_e4m3fn":
        q = q.view(np.uint8)
    return q.astype(np.int16)


# (stored shape, contraction axis): a stacked layer leaf, one layer's
# weight, and a (V, D) head.
SHAPES = [((3, 128, 96), 1), ((128, 96), 0), ((160, 128), 1)]
SCHEMES = [("int8", None), ("fp8", None), ("int4", 32), ("int4", 128)]


def _quantize_both(scheme, group, jw, tw, axis):
    if scheme == "int8":
        return JQ.quantize_weight(jw, axis=axis), TQ.quantize_weight(tw, axis)
    if scheme == "fp8":
        return JF.quantize_weight_fp8(jw, axis=axis), \
            TF.quantize_weight_fp8(tw, axis)
    return (JQ.quantize_weight_int4(jw, axis=axis, group=group),
            TQ.quantize_weight_int4(tw, axis, group))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,axis", SHAPES)
@pytest.mark.parametrize("scheme,group", SCHEMES)
def test_values_and_scales_byte_equal(scheme, group, shape, axis, dtype):
    if group is not None and shape[axis] <= group:
        group = 32
    jw, tw = _weights(shape, dtype, seed=sum(shape))
    ref, out = _quantize_both(scheme, group, jw, tw, axis)
    assert out.scheme == scheme and tuple(out.shape) == shape
    np.testing.assert_array_equal(_q_bytes(out), _q_bytes(ref["q"]))
    assert out.s.dtype == torch.float32
    assert out.s.numpy().tobytes() == np.asarray(ref["s"]).tobytes()
    if scheme == "int4":
        assert out.q.dtype == torch.uint8
        assert tuple(out.q.shape) == shape[:-1] + (shape[-1] // 2,)
        assert JQ.int4_axis_group(ref["q"], ref["s"]) == \
            TQ.int4_axis_group(out)


def test_int4_packing_puts_the_even_index_in_the_low_nibble():
    vals = torch.tensor([[-7, 7, 0, -1, 3, -8]], dtype=torch.int8)
    packed = QM.pack_int4(vals)
    assert packed.tolist() == [[0x79, 0xF0, 0x83]]
    assert torch.equal(QM.unpack_int4(packed), vals)


@pytest.mark.parametrize("shape,axis,group", [
    ((128, 96), 0, 48),    # contraction not divisible
    ((128, 96), 0, 128),   # group == contraction: one group
    ((128, 96), 0, 1),     # below 2
    ((3, 96, 64), 1, 96),
])
def test_check_int4_shape_raises_the_jax_errors(shape, axis, group):
    w = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as ref:
        JQ._check_int4_shape(w, axis, group)
    with pytest.raises(ValueError) as out:
        TQ._check_int4_shape(torch.from_numpy(w), axis, group)
    assert str(out.value) == str(ref.value)
    with pytest.raises(ValueError) as out:
        TQ.quantize_weight_int4(torch.from_numpy(w), axis, group)
    assert str(out.value) == str(ref.value)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheme,group", SCHEMES)
def test_dequantize_weight(scheme, group, dtype):
    jw, tw = _weights((256, 384), dtype, seed=5)
    for axis in (0, 1):
        ref, out = _quantize_both(scheme, group, jw, tw, axis)
        jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        td = torch.bfloat16 if dtype == "bf16" else torch.float32
        a = JQ.dequantize_weight(ref, jd)
        b = TQ.dequantize_weight(out, td)
        assert b.dtype == td and tuple(b.shape) == (256, 384)
        assert np.asarray(a.astype(jnp.float32)).tobytes() == \
            b.float().numpy().tobytes()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scheme,group", SCHEMES)
@pytest.mark.parametrize("head", [False, True])
def test_product_reference_matches_jax(scheme, group, head, dtype):
    """quant_matmul_reference against JAX's ``_mm`` (a layer weight, x of
    leading shape (2, 3)) and ``_lm_head_logits`` (the head)."""
    k, n = 256, 96
    jw, tw = _weights((n, k) if head else (k, n), dtype, seed=7)
    ref, out = _quantize_both(scheme, group, jw, tw, 1 if head else 0)
    x = np.random.default_rng(8).normal(size=(2, 3, k)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    if head:
        want = L._lm_head_logits(jx, {"lm_head": ref})
        got = TQ.matmul(tx, out)
        assert got.dtype == torch.float32
        # f32 logits of a bf16 product: one bf16 ulp of the logit.
        tol = 2.0 ** -7 if dtype == "bf16" else 1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)
    else:
        want = L._mm(jx, ref)
        got = TQ.matmul(tx, out)
        assert got.shape == (2, 3, n)
        _close(want, got, dtype)
    # The wrapper takes the plain version for a CPU tensor.
    assert torch.equal(QM.quant_matmul(tx, out.q, out.s, scheme, head), got)


def test_product_wrapper_refusals():
    w = TQ.quantize_weight(torch.randn(64, 32), 0)
    with pytest.raises(ValueError, match="features"):
        QM.quant_matmul(torch.randn(2, 48), w.q, w.s, "int8")
    with pytest.raises(ValueError, match="scheme"):
        QM.quant_matmul(torch.randn(2, 64), w.q, w.s, "int2")
    with pytest.raises(ValueError, match="scales"):
        QM.quant_matmul(torch.randn(2, 64), w.q, w.s.T.contiguous(), "int8")


def test_weight_keeps_its_kernel_plan_until_q_or_s_changes(monkeypatch):
    """The checked launch arguments live on the weight: made once, and made
    anew after ``q`` or ``s`` is replaced or the module is moved (a new
    tensor at the old address must not inherit an old plan)."""
    made = []

    def plan(q, s, scheme, head):
        made.append((q, s, scheme, head))
        return len(made)

    monkeypatch.setattr(TQ, "kernel_plan", plan)
    w = TQ.quantize_weight(torch.randn(64, 32), 1)
    assert (w.plan(), w.plan()) == (1, 1)
    assert made[0][0] is w.q and made[0][2:] == ("int8", True)
    w.q = w.q.T.contiguous().T  # same shape, other strides
    assert w.plan() == 2 and made[1][0] is w.q
    w.s = w.s.clone()
    assert w.plan() == 3
    w.to(torch.device("cpu"))
    assert (w.plan(), w.plan()) == (4, 4)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4096, 1040), (256, 16)])
@pytest.mark.parametrize("sms", [132, 114])
def test_kernel_split_covers_every_k_step_once(k, n, sms):
    """kn_plan's CTAs fit one wave where the tiles allow and cover the
    contraction's k-steps with no empty CTA."""
    tiles, spc, ksplit = QM.kn_plan(k, n, sms)
    assert tiles == -(-n // QM.TILE_N)
    assert spc * ksplit >= k // 16 > spc * (ksplit - 1)
    assert tiles * ksplit <= max(sms, tiles)
    assert QM.kernel_ctas(k, n, False, sms) == tiles * ksplit


def _tiny(name, dtype="f32", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jcfg = dataclasses.replace(L.LLAMA_CONFIGS[name], dtype=jd, **kw)
    tcfg = dataclasses.replace(TL.LLAMA_CONFIGS[name], dtype=td, **kw)
    jparams = L.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def f32_gqa():
    return _tiny("tiny-gqa")


def _same_tree(a, b):
    ta, tb = jax.tree.structure(a), jax.tree.structure(b)
    assert ta == tb, (ta, tb)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("lm_head", [True, False])
@pytest.mark.parametrize("name", ["tiny-gqa", "gemma-tied"])
def test_quantize_params_tree_through_the_bridge(name, lm_head, bits):
    """Quantized by each framework, the trees are byte-equal both ways
    through the bridge; a tied config keeps its (unquantized) embedding
    as the head."""
    if name == "gemma-tied":
        jcfg, tcfg, jp, tp = _tiny("tiny", tie_embeddings=True)
    else:
        jcfg, tcfg, jp, tp = _tiny(name)
    jq = JQ.quantize_params(jp, quantize_lm_head=lm_head, bits=bits,
                            group=32)
    tq = TQ.quantize_params(tp, quantize_lm_head=lm_head, bits=bits,
                            group=32)
    jtree = jax.tree.map(np.asarray, jq)
    _same_tree(jtree, params_to_numpy(tq, like=jtree))
    back = params_from_jax(jtree, tcfg, device="cpu")
    _same_tree(jtree, params_to_numpy(back, like=jtree))
    assert isinstance(tq.layers[1].w_down, TQ.QuantizedWeight)
    head_q = lm_head and not tcfg.tie_embeddings
    assert isinstance(tq.lm_head, TQ.QuantizedWeight) is head_q
    assert isinstance(tq.embed, torch.nn.Parameter)
    # The source model is left as it was, and shares what stays dense.
    assert isinstance(tp.layers[0].wq, torch.nn.Parameter)
    assert tq.embed is tp.embed and tq.layers[0].attn_norm is \
        tp.layers[0].attn_norm
    if bits != 4:  # JAX counts an int4 value as a byte; the port packs
        assert TQ.quantized_bytes(tq) == JQ.quantized_bytes(jq)
    else:
        packed = sum(getattr(layer, t).q.numel() for layer in tq.layers
                     for t in TQ._LAYER_TARGETS)
        assert TQ.quantized_bytes(tq) < JQ.quantized_bytes(jq)
        assert packed * 2 == sum(np.asarray(jq["layers"][t]["q"]).size
                                 for t in TQ._LAYER_TARGETS)


def test_bridge_refuses_a_quantized_leaf_of_the_wrong_shape(f32_gqa):
    jcfg, tcfg, jp, _ = f32_gqa
    tree = jax.tree.map(np.asarray, JQ.quantize_params(jp))
    tree["layers"]["wq"]["q"] = tree["layers"]["wq"]["q"][:, :, :64]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tree, tcfg, device="cpu")


def test_free_source_validates_before_releasing_anything(f32_gqa):
    _, tcfg, _, tp = f32_gqa
    keep = {n: p.clone() for n, p in tp.named_parameters()}
    for bad in (dict(bits=4, group=96), dict(bits=3)):
        with pytest.raises(ValueError):
            TQ.quantize_params(tp, free_source=True, **bad)
        for n, p in tp.named_parameters():
            assert torch.equal(p, keep[n]), n
    # A valid call releases every quantized source and nothing else.
    _, tcfg, _, src = _tiny("tiny-gqa")
    out = TQ.quantize_params(src, free_source=True, bits=4, group=32)
    assert all(getattr(layer, t).numel() == 0 for layer in src.layers
               for t in TQ._LAYER_TARGETS)
    assert src.lm_head.numel() == 0 and src.embed.numel() > 0
    assert TL.forward(out, tcfg, torch.tensor([[5, 6, 7]])).shape == \
        (1, 3, tcfg.vocab_size)


@pytest.mark.parametrize("value", [None, "", "bf16", "int8", "int4", "fp8",
                                   "int3", "FP8"])
def test_quant_bits_from_env(monkeypatch, value):
    assert TQ.QUANT_ENV_NAME == QUANT_ENV_NAME
    if value is None:
        monkeypatch.delenv(QUANT_ENV_NAME, raising=False)
    else:
        monkeypatch.setenv(QUANT_ENV_NAME, value)
    try:
        want = JQ.quant_bits_from_env()
    except ValueError as err:
        with pytest.raises(ValueError) as out:
            TQ.quant_bits_from_env()
        assert str(out.value) == str(err)
        return
    assert TQ.quant_bits_from_env() == want


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
def test_forward_under_each_scheme(name, bits):
    jcfg, tcfg, jp, tp = _tiny(name)
    toks = np.random.default_rng(10).integers(3, 256, size=(2, 12)).astype(
        np.int32)
    ref = L.forward(JQ.quantize_params(jp, bits=bits, group=32), jcfg,
                    jnp.asarray(toks))
    out = TL.forward(TQ.quantize_params(tp, bits=bits, group=32), tcfg,
                     torch.from_numpy(toks))
    _close(ref, out, "f32")


def _prompts(n, seed, lo=4, hi=16, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _lockstep(jeng, teng, prompts):
    """Drive both engines one quantum at a time; every quantum must emit
    the same (rid, token) events, logprobs within 1e-4."""
    events = ([], [])
    for eng, ev in zip((jeng, teng), events):
        eng.on_token = lambda rid, tok, ev=ev: ev.append((rid, tok))
        for p in prompts:
            eng.submit(p)
    step = 0
    while jeng._pending() or teng._pending():
        n0 = [len(e) for e in events]
        jeng.drive_once()
        teng.drive_once()
        assert events[0][n0[0]:] == events[1][n0[1]:], f"step {step}"
        step += 1
    jout, tout = jeng.run(), teng.run()
    assert jout == tout and jout
    for rid in jout:
        np.testing.assert_allclose(teng.run_logprobs()[rid],
                                   jeng.run_logprobs()[rid], atol=1e-4)
    return jout


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("engine", ["ragged", "continuous"])
def test_quantized_engines_emit_jax_tokens(f32_gqa, engine, bits):
    jcfg, tcfg, jp, tp = f32_gqa
    jq = JQ.quantize_params(jp, bits=bits, group=32)
    tq = TQ.quantize_params(tp, bits=bits, group=32)
    if engine == "ragged":
        kw = dict(slots=3, num_blocks=24, block_size=8, prompt_bucket=16,
                  token_budget=12, ragged=True)
        jeng = JP.PagedBatcher(jq, jcfg, gen=JGen(max_new_tokens=6,
                                                  eos_id=-1),
                               attn_kernel=False, **kw)
        teng = TP.PagedBatcher(tq, tcfg, gen=TGen(max_new_tokens=6,
                                                  eos_id=-1),
                               device="cpu", **kw)
    else:
        kw = dict(slots=3, cache_len=26, prompt_bucket=16)
        jeng = JC.ContinuousBatcher(jq, jcfg, gen=JGen(max_new_tokens=8,
                                                       eos_id=-1), **kw)
        teng = TC.ContinuousBatcher(tq, tcfg, gen=TGen(max_new_tokens=8,
                                                       eos_id=-1),
                                    device="cpu", **kw)
    out = _lockstep(jeng, teng, _prompts(5, seed=3))
    assert len(out) == 5


# The largest difference between the two frameworks' bf16 ``forward``
# logits on tiny (the rounding noise that can flip a near-tie) reads
# 0.020-0.040 on these prompts' sequences, dense and quantized alike, and a
# forked token lies at most 0.035 under its row's argmax: a near-tie is a
# logit within 0.06 of the argmax.
BF16_NEAR_TIE = 0.06


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
def test_bf16_greedy_tokens_on_pinned_prompts(bits):
    """bf16 rounds at other places in the two frameworks. Tokens agree on
    these prompts; where a near-tie forks them, every port token must
    still be a near-tie (``BF16_NEAR_TIE``) of JAX ``forward`` on the
    port's own sequence (greedy consistency). On every prompt's sequence
    the two frameworks' bf16 ``forward`` logits differ by less than
    ``BF16_NEAR_TIE``. At least one prompt agrees."""
    jcfg, tcfg, jp, tp = _tiny("tiny", "bf16")
    jq = JQ.quantize_params(jp, bits=bits, group=32)
    tq = TQ.quantize_params(tp, bits=bits, group=32)
    prompts = [[5, 9, 17, 33], [7, 1, 200, 3, 99, 45, 12], [250, 4, 4, 4, 8]]
    kw = dict(slots=2, num_blocks=16, block_size=8, prompt_bucket=16,
              token_budget=16, ragged=True)
    jeng = JP.PagedBatcher(jq, jcfg, gen=JGen(max_new_tokens=8, eos_id=-1),
                           attn_kernel=False, **kw)
    teng = TP.PagedBatcher(tq, tcfg, gen=TGen(max_new_tokens=8, eos_id=-1),
                           device="cpu", **kw)
    jids = [jeng.submit(p) for p in prompts]
    tids = [teng.submit(p) for p in prompts]
    jout, tout = jeng.run(), teng.run()
    forks = []
    for p, jr, tr in zip(prompts, jids, tids):
        seq = [p + tout[tr]]
        logits = np.asarray(L.forward(jq, jcfg, jnp.asarray(seq)))[0]
        noise = float(np.abs(logits - TL.forward(
            tq, tcfg, torch.tensor(seq)).float().numpy()[0]).max())
        assert noise < BF16_NEAR_TIE, f"forward logits differ by {noise}"
        if jout[jr] == tout[tr]:
            continue
        forks.append(p)
        for i, tok in enumerate(tout[tr]):
            row = logits[len(p) - 1 + i]
            gap = float(row.max() - row[tok])
            assert gap <= BF16_NEAR_TIE, (
                f"token {i} ({tok}) off the greedy path by {gap} (forward "
                f"logits differ by {noise})")
    assert len(forks) < len(prompts), f"every prompt forked: {forks}"


# Shrunk configs of each family: the family's flags at test widths.
_SMALL = dict(vocab_size=256, dim=128, n_layers=2, ffn_hidden=256)
FAMILIES = {
    "qwen2.5": ("qwen2.5-7b", dict(n_heads=4, n_kv_heads=2)),
    "llama-3.1": ("llama-3.1-8b", dict(n_heads=4, n_kv_heads=2)),
    "gemma": ("gemma-2b", dict(n_heads=2, n_kv_heads=1)),
    "mistral": ("mistral-7b", dict(n_heads=4, n_kv_heads=2,
                                   sliding_window=8)),
}
FAMILY_CASES = [(f, q, e) for f in FAMILIES for q in ("dense", "int8")
                for e in ("forward", "generate")
                if not (f == "mistral" and e == "generate")]


@pytest.mark.parametrize("family,quant,entry", FAMILY_CASES)
def test_family_parity(family, quant, entry):
    """f32 ``forward`` and ``generate`` of each family's shrunk config,
    dense and int8: qwen2.5's biases (left unquantized), llama-3.1's rope
    scaling, gemma's tied embeddings at head dim 256 through the cached
    decode, mistral's sliding window through ``forward``."""
    name, kw = FAMILIES[family]
    jcfg, tcfg, jp, tp = _tiny(name, **_SMALL, **kw)
    if jcfg.attn_bias:
        # Random biases, so that they reach the outputs.
        rng = np.random.default_rng(1)
        tree = jax.tree.map(np.asarray, jp)
        for b in ("bq", "bk", "bv"):
            tree["layers"][b] = rng.normal(
                size=tree["layers"][b].shape).astype(np.float32)
        jp = jax.tree.map(jnp.asarray, tree)
        tp = params_from_jax(tree, tcfg, device="cpu")
    if quant == "int8":
        jp = JQ.quantize_params(jp)
        tp = TQ.quantize_params(tp)
        assert isinstance(tp.layers[0].wq, TQ.QuantizedWeight)
        if jcfg.attn_bias:
            assert isinstance(tp.layers[0].bq, torch.nn.Parameter)
    toks = np.random.default_rng(11).integers(3, 256, size=(2, 12)).astype(
        np.int32)
    if entry == "forward":
        # 1e-5 of the logits' scale: gemma's sqrt(dim) embedding scale and
        # tied head put its logits' f32 rounding above 1e-5 absolute.
        ref = np.asarray(L.forward(jp, jcfg, jnp.asarray(toks)))
        out = TL.forward(tp, tcfg, torch.from_numpy(toks)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        ref = np.asarray(L.generate(jp, jcfg, jnp.asarray(toks[:, :6]),
                                    steps=6, cache_len=16))
        out = TL.generate(tp, tcfg, torch.from_numpy(toks[:, :6]), steps=6,
                          cache_len=16)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_training_a_quantized_model_is_refused(f32_gqa):
    from kubeflow_tpu_torch.models import train as TT

    _, tcfg, _, tp = f32_gqa
    init_state, _ = TT.make_train_step(tcfg, plan="cpu")
    with pytest.raises(NotImplementedError,
                       match="the JAX package cannot train one either"):
        init_state(TQ.quantize_params(tp))


# -- entry points ------------------------------------------------------------

def _serve_batched(argv, capsys):
    from kubeflow_tpu_torch.examples import serve_batched

    serve_batched.main(["--device", "cpu", "--max-new-tokens", "4"] + argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("argv,env,label", [
    ([], None, None),
    (["--int8"], None, "int8"),
    (["--int4"], None, "int4"),
    (["--fp8"], None, "fp8"),
    (["--kv8", "--int8"], None, "int8"),
    (["--paged", "--int4"], None, "int4"),
    (["--paged", "--kv8", "--fp8"], None, "fp8"),
    ([], "int4", "int4"),
    (["--int8"], "fp8", "int8"),   # the flag wins over the env
    ([], "bf16", None),
])
def test_serve_batched_runs_on_the_cpu(monkeypatch, capsys, argv, env, label):
    if env is None:
        monkeypatch.delenv(QUANT_ENV_NAME, raising=False)
    else:
        monkeypatch.setenv(QUANT_ENV_NAME, env)
    # The entry point quantizes int4 at JAX's fixed group of 128, which
    # tiny's 128-wide projections cannot take (the refusal is held in
    # test_serve_batched_exits_with_the_jax_messages); here the group it
    # passes, none, becomes 32.
    real, calls = TQ.quantize_params, []

    def quantize_params(params, **kw):
        calls.append(kw)
        if kw.get("bits") == 4:
            kw = dict(kw, group=32)
        return real(params, **kw)

    monkeypatch.setattr(TQ, "quantize_params", quantize_params)
    out = _serve_batched(argv, capsys)
    assert [set(kw) for kw in calls] == ([{"free_source", "bits"}]
                                         if label else [])
    assert ("weight-only quantization applied" in out) is (label is not None)
    if label:
        assert out.startswith(f"{label} weight-only quantization applied")
    assert sum(line.startswith(f"[{i}] ") for line in out.splitlines()
               for i in range(3)) == 3
    assert ("blocks free after run" in out) is ("--paged" in argv)


@pytest.mark.parametrize("argv,message", [
    (["--int8", "--fp8"], "--int8/--int4/--fp8 are mutually exclusive"),
    (["--prompt-cache", "--prefix-cache", "--paged"],
     "--prompt-cache and --prefix-cache are mutually exclusive"),
    # --tp is ported (tests/test_torch_tp_serving.py runs it); quantized
    # weights under it are refused, as JAX cannot shard them either.
    pytest.param(["--tp", "2", "--int8"],
                 "quantized weights cannot be sharded", id="argv2-item 11"),
    # --sp is ported (tests/test_torch_sp_serving.py runs it); the paged
    # and speculative engines under it exit with JAX's messages, and
    # quantized weights as under --tp.
    pytest.param(["--sp", "2", "--paged"],
                 "--paged supports --tp but not --sp (use continuous "
                 "batching for sp)", id="argv3-item 13"),
    pytest.param(["--sp", "2", "--speculative", "1"],
                 "--speculative supports --tp but not --sp (use plain "
                 "continuous batching for sp)", id="argv4-item 13"),
    pytest.param(["--sp", "2", "--int8"],
                 "quantized weights cannot be sharded", id="argv5-item 13"),
])
def test_serve_batched_refuses_what_the_port_lacks(monkeypatch, argv,
                                                   message):
    from kubeflow_tpu_torch.examples import serve_batched

    def no_weights(*a, **kw):
        raise AssertionError("serve_batched made weights before refusing")

    monkeypatch.setattr(TL, "init_params", no_weights)
    with pytest.raises(SystemExit) as info:
        serve_batched.main(["--device", "cpu"] + argv)
    assert message in str(info.value)


@pytest.mark.parametrize("flag", ["--prompt-cache", "--prefix-cache"])
def test_serve_batched_serves_with_a_sharing_tier(monkeypatch, capsys, flag):
    """``--prompt-cache`` and ``--prefix-cache`` reach the ``--paged``
    engine (the sharing tiers of ROADMAP queue 1 item 7), which serves
    the three prompts with the tier on."""
    from kubeflow_tpu_torch.examples import serve_batched
    from kubeflow_tpu_torch.models import paged as TP

    built = []
    real = TP.PagedBatcher

    def engine(*a, **kw):
        built.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(TP, "PagedBatcher", engine)
    serve_batched.main(["--device", "cpu", "--paged", flag])
    out = capsys.readouterr().out
    assert "blocks free after run" in out
    assert sum(line.startswith(f"[{i}] ") for line in out.splitlines()
               for i in range(3)) == 3
    (kw,) = built
    on = flag.lstrip("-").replace("-", "_")
    off = "prefix_cache" if on == "prompt_cache" else "prompt_cache"
    assert kw[on] is True and kw[off] is False


def test_serve_batched_exits_with_the_jax_messages(monkeypatch):
    from kubeflow_tpu_torch.examples import serve_batched

    monkeypatch.setenv(QUANT_ENV_NAME, "int2")
    with pytest.raises(SystemExit) as info:
        serve_batched.main(["--device", "cpu"])
    assert str(info.value) == ("KUBEFLOW_TPU_QUANT='int2': want 'int8', "
                               "'int4', 'fp8', or 'bf16'")
    monkeypatch.delenv(QUANT_ENV_NAME)
    # tiny's 128-wide projections cannot take JAX's fixed group of 128.
    with pytest.raises(ValueError) as ref:
        JQ._check_int4_shape(np.zeros((128, 128)), 0, 128)
    with pytest.raises(SystemExit) as info:
        serve_batched.main(["--device", "cpu", "--int4"])
    assert str(info.value) == str(ref.value)


@pytest.mark.parametrize("paged", [False, True])
def test_serve_http_int8_serves_a_quantized_model(monkeypatch, paged):
    from kubeflow_tpu_torch.examples import serve_http
    from kubeflow_tpu_torch.models import server as TS

    class Built(Exception):
        pass

    class NoServer:
        def __init__(self, engine, **kw):
            raise Built(engine)

    monkeypatch.setattr(TS, "InferenceServer", NoServer)
    # serve_http, like the JAX entry point, does not read the env.
    monkeypatch.setenv(QUANT_ENV_NAME, "int4")
    args = ["--config", "tiny", "--device", "cpu", "--port", "0", "--slots",
            "2", "--num-blocks", "16"] + (["--paged"] if paged else [])
    for extra, quantized in (([], False), (["--int8"], True)):
        with pytest.raises(Built) as info:
            serve_http.main(args + extra)
        params = info.value.args[0].params
        assert isinstance(params.layers[0].wq, TQ.QuantizedWeight) is quantized
        if quantized:
            assert {getattr(layer, t).scheme for layer in params.layers
                    for t in TQ._LAYER_TARGETS} == {"int8"}
            assert params.lm_head.scheme == "int8"
        engine = info.value.args[0]
        rid = engine.submit([5, 9, 17])
        assert len(engine.run()[rid]) > 0


# -- the alternating engine keeps an admitted request's deadline -------------

def test_alternating_engine_retires_an_admitted_request_at_its_deadline(
        f32_gqa):
    """The port's alternating ``PagedBatcher`` keeps an admitted request's
    deadline: once the injected clock passes it, the request retires with
    reason "deadline" at its next token. The reference builds the admitted
    request without it (``kubeflow_tpu/models/paged.py:1834-1839``), so
    the same request there runs to its token budget."""
    jcfg, tcfg, jp, tp = f32_gqa
    kw = dict(slots=2, num_blocks=24, block_size=8, prompt_bucket=16)
    jeng = JP.PagedBatcher(jp, jcfg, gen=JGen(max_new_tokens=8, eos_id=-1),
                           attn_kernel=False, **kw)
    teng = TP.PagedBatcher(tp, tcfg, gen=TGen(max_new_tokens=8, eos_id=-1),
                           device="cpu", **kw)
    assert not teng.ragged
    results = []
    for eng in (jeng, teng):
        now = [100.0]
        eng._clock = lambda now=now: now[0]
        aborted = []
        eng.on_abort = lambda rid, toks, reason, a=aborted: a.append(
            (rid, len(toks), reason))
        emitted = []
        eng.on_token = lambda rid, tok, e=emitted: e.append(tok)
        rid = eng.submit([5, 9, 17, 33], deadline_s=5.0)
        assert eng._queue[0].deadline == 105.0
        eng.drive_once()  # admitted, and decoding inside the deadline
        eng.drive_once()
        assert eng._by_slot[0] is not None and eng._by_slot[0].rid == rid
        before = len(emitted)
        now[0] += 10.0
        while eng._pending():
            eng.drive_once()
        results.append((rid, aborted, eng.run(), before, len(emitted)))
    (jrid, jab, jout, _, jn), (trid, tab, tout, before, tn) = results
    assert jab == [] and len(jout[jrid]) == jn == 8
    # Retired at its first token past the deadline, which is not emitted.
    assert 0 < before < 8 and tn == before
    assert tab == [(trid, before, "deadline")]
    assert trid not in tout
