"""Llama model family in PyTorch: the parts the serving engines and the
trainer run.

Counterpart of ``kubeflow_tpu/models/llama.py``. Parameters live in
``nn.Module``s (``Llama`` holding one ``LlamaLayer`` per layer) instead of
a pytree stacked on a leading layer axis: PyTorch runs eagerly, so the
layer scan becomes a Python loop over ``Llama.layers``. Weights keep the
JAX package's ``(in, out)`` layout — every projection is ``x @ w`` — so
the weight bridge (``models/bridge.py``) only unstacks and never
transposes.

The numerics mirror the JAX functions at the places a straightforward
port would drift: RMSNorm casts to the model dtype BEFORE the weight
multiply (Gemma's ``1 + w`` stays in f32), the MLP's gate and up
projections run in f32, RoPE is split-half in f32, the lm head multiplies
in the model dtype and casts to f32 after, and ``_kv_quantize`` divides
(never multiplies by a reciprocal) and rounds half to even, so int8
values and bf16 scales come out byte-equal to JAX's.

The full-sequence path (``forward``, ``forward_hidden``, ``prefill``,
``_prefill_impl``) attends through ``ops/attention.py``'s
``flash_attention`` — the CUDA flash kernel on the card, the plain version
on the CPU. The cached-chunk decode family (``_chunk_decode_scan`` under
``_decode_chunk_impl``, ``_decode_chunk_batch_impl``, ``_decode_impl``,
``decode_step``, ``prefill_chunked``) attends through
``_gqa_decode_attention`` in plain PyTorch, as JAX does in plain XLA; the
generation functions (``generate``, ``generate_tokens``, ``sample``,
``greedy_generate``) are Python loops over the steps where JAX runs one
jitted scan, and draw from a ``torch.Generator`` where JAX takes a key.
Caches are updated IN PLACE (JAX donates them and returns new ones), and
the functions return the cache they were given.

Under a tensor-parallel plan (``parallel/mesh.py``'s ``shard_params``)
a rank's ``Llama`` holds its slice of every sharded leaf and a ``shard``
record (the tp group, this rank's vocab rows) on itself and each layer.
The forward reads the local head counts from the widths it is given
(``_split_heads`` splits by the head dim) and adds the collectives GSPMD
inserts in JAX: one ``all_reduce`` of the partial outputs of ``wo`` and
of ``w_down`` each, in the model dtype (``_tp_sum``), a masked lookup of
the vocab-split embedding plus ``all_reduce`` (exact: one value and
zeros), and an ``all_gather`` of the vocab-split head's f32 logits. The
vocab must divide by tp (every ``LLAMA_CONFIGS`` vocab divides by 8).
Without a shard the forward is unchanged.

Projections and the lm head may be quantized (``models/quant.py``: int8,
int4, fp8): ``_mm`` and ``_lm_head_logits`` take a ``QuantizedWeight``
with the JAX functions' rounding points, through the hand-written
``quant_matmul`` kernel at decode widths on the card. For fp8 training a
projection may be an ``Fp8Weight`` (``models/fp8.py``), which ``_mm``
sends through ``fp8_matmul``.

Training: ``forward_hidden`` and ``forward`` record an autograd graph when
grad mode is on and the weights require grad. Weights are created frozen
(``requires_grad=False``), as serving wants them; ``params.requires_grad_()``
makes them trainable (``models/train.py``'s ``init_state`` does). Attention
then differentiates through ``FlashAttention`` (the backward kernels on the
card). ``forward_hidden``'s ``remat`` picks one of ``_REMAT_POLICIES``, the
JAX names: ``"full"`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) and recomputes it in the
backward; ``"dots"`` saves the outputs of the projections (``aten.mm``,
and ``aten._scaled_mm`` for fp8 training on the card: the products with
no batch dims) and recomputes the rest, attention included; ``"none"``
saves what autograd saves. The serving functions run under
``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as _ckpt

from kubeflow_tpu_torch.models.fp8 import Fp8Weight, fp8_matmul
from kubeflow_tpu_torch.models.quant import QuantizedWeight
from kubeflow_tpu_torch.models.quant import matmul as quant_matmul
from kubeflow_tpu_torch.ops.attention import NEG_INF, flash_attention


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1 "llama3" rope scaling (frequency-dependent NTK stretch).
    Field semantics follow the HF config.json rope_scaling block."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-family transformer config; the same fields and values as the
    JAX package's, with a torch dtype.

    Family flags: Mistral ``sliding_window``; Gemma ``act="gelu"``,
    ``norm_add_unit``, ``embed_scale``, ``head_dim_override``,
    ``tie_embeddings``; Qwen2 ``attn_bias``."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_hidden: int = 11008
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    max_seq_len: int = 4096
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    sliding_window: int = 0  # 0 = full causal attention
    act: str = "silu"  # "silu" (llama/mistral) | "gelu" (gemma, tanh approx)
    norm_add_unit: bool = False  # RMSNorm weight is (1 + w) (gemma)
    embed_scale: bool = False  # scale embeddings by sqrt(dim) (gemma)
    head_dim_override: int = 0  # 0 = dim // n_heads
    tie_embeddings: bool = False  # lm_head shares the embedding matrix
    attn_bias: bool = False  # q/k/v projections carry biases (qwen2)

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.dim // self.n_heads

    def param_count(self) -> int:
        embed = self.vocab_size * self.dim
        attn = self.dim * self.head_dim * (2 * self.n_heads + 2 * self.n_kv_heads)
        mlp = 3 * self.dim * self.ffn_hidden
        norms = 2 * self.dim
        n_embed = 1 if self.tie_embeddings else 2
        return n_embed * embed + self.n_layers * (attn + mlp + norms) + self.dim


LLAMA_CONFIGS: dict[str, LlamaConfig] = {
    "llama-2-7b": LlamaConfig(),
    "llama-2-13b": LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                               ffn_hidden=13824),
    "llama-2-70b": LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8,
                               ffn_hidden=28672),
    "llama-3-8b": LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, ffn_hidden=14336,
                              rope_theta=500000.0, max_seq_len=8192),
    "llama-3.1-8b": LlamaConfig(vocab_size=128256, dim=4096, n_layers=32,
                                n_heads=32, n_kv_heads=8, ffn_hidden=14336,
                                rope_theta=500000.0, max_seq_len=131072,
                                rope_scaling=RopeScaling()),
    "mistral-7b": LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                              n_heads=32, n_kv_heads=8, ffn_hidden=14336,
                              max_seq_len=32768, sliding_window=4096),
    "gemma-2b": LlamaConfig(vocab_size=256000, dim=2048, n_layers=18,
                            n_heads=8, n_kv_heads=1, ffn_hidden=16384,
                            max_seq_len=8192, act="gelu", norm_add_unit=True,
                            embed_scale=True, head_dim_override=256,
                            tie_embeddings=True),
    "gemma-7b": LlamaConfig(vocab_size=256000, dim=3072, n_layers=28,
                            n_heads=16, n_kv_heads=16, ffn_hidden=24576,
                            max_seq_len=8192, act="gelu", norm_add_unit=True,
                            embed_scale=True, head_dim_override=256,
                            tie_embeddings=True),
    "qwen2.5-7b": LlamaConfig(vocab_size=152064, dim=3584, n_layers=28,
                              n_heads=28, n_kv_heads=4, ffn_hidden=18944,
                              rope_theta=1000000.0, max_seq_len=32768,
                              norm_eps=1e-6, attn_bias=True),
    # Tiny configs for tests.
    "tiny": LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=4, ffn_hidden=256, max_seq_len=256),
    "tiny-gqa": LlamaConfig(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_hidden=256, max_seq_len=256),
}


# ---------------------------------------------------------------------------
# Parameters


def _weight(shape: tuple, cfg: LlamaConfig, device) -> nn.Parameter:
    # Frozen by default, so serving records no autograd graph through them;
    # training turns grads on with ``Llama.requires_grad_()``.
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


class LlamaLayer(nn.Module):
    """One transformer layer's weights, ``(in, out)`` layout. A projection
    may be a ``models/quant.py`` ``QuantizedWeight`` in place of its
    parameter (``quantize_params``). ``shard`` is the tp record of a
    sharded layer (``parallel/mesh.py``), None for a whole one."""

    shard = None

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        hd = cfg.head_dim
        self.attn_norm = _weight((cfg.dim,), cfg, device)
        self.wq = _weight((cfg.dim, cfg.n_heads * hd), cfg, device)
        self.wk = _weight((cfg.dim, cfg.n_kv_heads * hd), cfg, device)
        self.wv = _weight((cfg.dim, cfg.n_kv_heads * hd), cfg, device)
        self.wo = _weight((cfg.n_heads * hd, cfg.dim), cfg, device)
        self.mlp_norm = _weight((cfg.dim,), cfg, device)
        self.w_gate = _weight((cfg.dim, cfg.ffn_hidden), cfg, device)
        self.w_up = _weight((cfg.dim, cfg.ffn_hidden), cfg, device)
        self.w_down = _weight((cfg.ffn_hidden, cfg.dim), cfg, device)
        for name, width in (("bq", cfg.n_heads * hd), ("bk", cfg.n_kv_heads * hd),
                            ("bv", cfg.n_kv_heads * hd)):
            self.register_parameter(
                name, _weight((width,), cfg, device) if cfg.attn_bias else None
            )


class Llama(nn.Module):
    """A whole model's weights: embedding, layers, final norm and (untied
    configs only) the lm head. Tied configs carry NO ``lm_head``: the
    head projects through ``embed``, as in the JAX tree. ``shard`` is the
    tp record of a sharded model, None for a whole one."""

    shard = None

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_size, cfg.dim), cfg, device)
        self.final_norm = _weight((cfg.dim,), cfg, device)
        self.register_parameter(
            "lm_head",
            None if cfg.tie_embeddings
            else _weight((cfg.vocab_size, cfg.dim), cfg, device),
        )
        self.layers = nn.ModuleList(
            LlamaLayer(cfg, device) for _ in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device=None, plan=None) -> Llama:
    """Random init, 1/sqrt(fan_in) scaling, on ``device`` (resolved by
    ``device.resolve_device``: the card unless ``"cpu"`` is asked for).
    Values come from ``generator`` (seed 0 on the device when None) and
    are drawn directly in the model dtype, so an 8B init never holds an
    f32 temporary. They do not match JAX's ``PRNGKey`` draws; parity tests
    bring JAX weights over through ``models/bridge.py`` instead.

    ``plan`` (a tp MeshPlan, ``parallel/mesh.py``) returns this rank's
    shard of the same model: each leaf is drawn whole, in the whole
    model's order, and cut to the rank's slice at once, so the values are
    the unsharded init's and the peak extra memory is one whole leaf."""
    from kubeflow_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if plan is None:
        model = Llama(cfg, dev)
        whole = dict(model.named_parameters())
    else:
        plan.check_serving()
        model = Llama(plan.shard_config(cfg), dev)
        model.cfg = cfg
        whole = dict(Llama(cfg, "meta").named_parameters())
    local = dict(model.named_parameters())
    with torch.no_grad():
        for name, meta in whole.items():
            leaf = name.rsplit(".", 1)[-1]
            p = meta if plan is None else torch.empty(
                meta.shape, dtype=cfg.dtype, device=dev)
            if leaf in ("attn_norm", "mlp_norm", "final_norm"):
                p.fill_(1.0)
            elif leaf in ("bq", "bk", "bv"):
                p.zero_()
            else:
                p.normal_(generator=generator)
                p.mul_(torch.tensor(1.0 / math.sqrt(p.shape[-2]),
                                    dtype=cfg.dtype, device=dev))
            if plan is not None:
                local[name].copy_(plan.shard_leaf(leaf, p))
                del p
    if plan is not None:
        plan.mark(model)
    return model


# ---------------------------------------------------------------------------
# Building blocks (f32 internals, model-dtype boundaries)


def _mm(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is dense OR quantized (``models/quant.py``) OR an
    fp8-training wrapper (``models/fp8.py``). Quantized: int8 and fp8
    ``(x @ q) * s``, the product rounded to the model dtype and then
    scaled; int4 ``x @ dequantize(w)``, the operand dequantized in f32 and
    rounded, as the JAX function rounds them. fp8 training: the master
    weight ``hp`` and its delayed-scaling histories through
    ``fp8_matmul``, the products with fp8 operands."""
    if isinstance(w, QuantizedWeight):
        return quant_matmul(x, w)
    if isinstance(w, Fp8Weight):
        return fp8_matmul(x, w.hp, w.meta())
    if not isinstance(w, torch.Tensor):
        raise TypeError(
            f"only dense or quantized weights are supported, got "
            f"{type(w).__name__}"
        )
    return x @ w


def _qkv(h: torch.Tensor, layer: LlamaLayer):
    """q/k/v projections with optional qwen2-style biases."""
    q, k, v = _mm(h, layer.wq), _mm(h, layer.wk), _mm(h, layer.wv)
    if layer.bq is not None:
        q, k, v = q + layer.bq, k + layer.bk, v + layer.bv
    return q, k, v


def _tp_group(owner):
    """The tp group of a sharded model or layer; None for a whole one."""
    shard = owner.shard
    return None if shard is None else shard.group


def _tp_sum(y: torch.Tensor, owner) -> torch.Tensor:
    """Sum the partial outputs of a row-sharded projection (``wo``,
    ``w_down``) over the tp group, in place and in their dtype: the psum
    GSPMD inserts after them in JAX. The identity without a shard."""
    group = _tp_group(owner)
    if group is None:
        return y
    y = y.contiguous()
    torch.distributed.all_reduce(y, group=group)
    return y


def _lm_head_logits(x: torch.Tensor, params: Llama) -> torch.Tensor:
    """x @ lm_head.T in the model dtype, THEN cast to f32 logits. Tied
    models project through the embedding matrix. A quantized head gives
    f32(x @ q.T) * s (int8, fp8) or f32(x @ dequantize(w).T) (int4). A
    vocab-split head gathers every rank's f32 logits along the vocab, so
    each rank samples from the full row."""
    w = params.lm_head if params.lm_head is not None else params.embed
    if isinstance(w, QuantizedWeight):
        return quant_matmul(x, w)
    logits = (x @ w.T).float()
    group = _tp_group(params)
    if group is None:
        return logits
    parts = [torch.empty_like(logits) for _ in range(params.shard.size)]
    torch.distributed.all_gather(parts, logits.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             add_unit: bool = False) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if add_unit:
        # Gemma: multiply by (1 + w) in f32, THEN cast (matches HF).
        return ((xf * rms) * (weight.float() + 1.0)).to(x.dtype)
    return (xf * rms).to(x.dtype) * weight


def _norm(x: torch.Tensor, weight: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return rms_norm(x, weight, cfg.norm_eps, add_unit=cfg.norm_add_unit)


def _embed(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    if _tp_group(params) is None:
        x = params.embed[tokens]
    else:
        # Vocab-split rows: each rank looks up the tokens it holds, zeros
        # elsewhere, and the sum over ranks is the one row, exactly.
        shard = params.shard
        local = tokens - shard.vocab_lo
        held = (local >= 0) & (local < shard.vocab_local)
        x = params.embed[local.clamp(0, shard.vocab_local - 1)]
        x = torch.where(held[..., None], x, torch.zeros_like(x))
        torch.distributed.all_reduce(x, group=shard.group)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.dim), dtype=x.dtype, device=x.device)
    return x


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as a true f32 division. ``float / tensor`` in torch
    is ``reciprocal(den) * num``, which can differ from JAX's division in
    the last bit."""
    return torch.full_like(den, num) / den


def rope_frequencies(cfg: LlamaConfig, positions: torch.Tensor):
    """cos/sin tables for the given positions: (S, head_dim/2) each, f32."""
    half = cfg.head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freqs = torch.pow(
        torch.tensor(cfg.rope_theta, dtype=torch.float32,
                     device=positions.device),
        exponent,
    )
    scaling = getattr(cfg, "rope_scaling", None)
    if scaling is not None:
        freqs = _llama3_scale_freqs(scaling, freqs)
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _llama3_scale_freqs(rs: RopeScaling, freqs: torch.Tensor) -> torch.Tensor:
    """Llama-3.1 frequency-dependent scaling: high frequencies kept, low
    frequencies stretched by ``factor``, a smooth ramp between the two
    wavelength cutoffs (the HF "llama3" rope_type)."""
    low_wavelen = rs.original_max_position_embeddings / rs.low_freq_factor
    high_wavelen = rs.original_max_position_embeddings / rs.high_freq_factor
    wavelen = _rdiv(2.0 * math.pi, freqs)
    smooth = (_rdiv(float(rs.original_max_position_embeddings), wavelen)
              - rs.low_freq_factor) / (rs.high_freq_factor - rs.low_freq_factor)
    smooth = torch.clamp(smooth, 0.0, 1.0)
    return torch.where(
        wavelen > low_wavelen,
        freqs / rs.factor,
        torch.where(
            wavelen < high_wavelen,
            freqs,
            (1.0 - smooth) * freqs / rs.factor + smooth * freqs,
        ),
    )


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               per_batch: bool = False) -> torch.Tensor:
    """x: (B, H, S, D). Rotate pairs (split-half convention) in f32.

    cos/sin (S, half) are shared across the batch; with ``per_batch`` they
    are (B, half) with S == 1 (one position per row); 3-D (B, S, half)
    are per-row per-position."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 3:
        c, s = cos[:, None, :, :], sin[:, None, :, :]
    elif per_batch:
        c, s = cos[:, None, None, :], sin[:, None, None, :]
    else:
        c, s = cos[None, None, :, :], sin[None, None, :, :]
    x1f, x2f = x1.float(), x2.float()
    out1 = x1f * c - x2f * s
    out2 = x2f * c + x1f * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, S, H·D) → (B, H, S, D): the head count is read off the width,
    so a tp rank's slice splits into its local heads."""
    b, s, _ = x.shape
    return x.reshape(b, s, -1, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _mlp(layer: LlamaLayer, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    pre = _mm(x, layer.w_gate).float()
    if cfg.act == "gelu":
        gate = F.gelu(pre, approximate="tanh")  # pytorch-tanh gelu
    else:
        gate = F.silu(pre)
    up = _mm(x, layer.w_up).float()
    return _tp_sum(_mm((gate * up).to(x.dtype), layer.w_down), layer)


def _layer_fwd(layer: LlamaLayer, cfg: LlamaConfig, x: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor,
               attn_impl: str) -> torch.Tensor:
    """One transformer layer, full sequence. K/V go in unrepeated:
    ``flash_attention`` reads the GQA group's kv head itself."""
    h = _norm(x, layer.attn_norm, cfg)
    hq, hk, hv = _qkv(h, layer)
    q = apply_rope(_split_heads(hq, cfg.head_dim), cos, sin)
    k = apply_rope(_split_heads(hk, cfg.head_dim), cos, sin)
    v = _split_heads(hv, cfg.head_dim)
    attn = flash_attention(q, k, v, causal=True, impl=attn_impl,
                           window=cfg.sliding_window)
    x = x + _tp_sum(_mm(_merge_heads(attn), layer.wo), layer)
    h = _norm(x, layer.mlp_norm, cfg)
    return x + _mlp(layer, h, cfg)


# ---------------------------------------------------------------------------
# Entry points


# The products with no batch dims: the projections' (``aten.mm``) and the
# fp8 ones on the card (``aten._scaled_mm``, ``models/fp8.py``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten._scaled_mm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the projections' outputs (the products with
    no batch dims, JAX's ``dots_with_no_batch_dims_saveable``) and
    recompute everything else."""
    if op in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# Remat policies for the layer loop, keyed by the JAX names: each wraps
# one layer's forward.
_REMAT_POLICIES = {
    "full": lambda body: functools.partial(
        _ckpt.checkpoint, body, use_reentrant=False),
    "dots": lambda body: functools.partial(
        _ckpt.checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)),
    "none": lambda body: body,
}


def forward_hidden(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                   attn_impl: str = "auto", remat: str = "full"
                   ) -> torch.Tensor:
    """Tokens (B, S) → final-normed hidden states (B, S, dim), without the
    lm head: the seam of the chunked cross entropy (``models/train.py``).
    ``remat`` picks the ``_REMAT_POLICIES`` entry; with no graph recorded
    (grad mode off) no layer is checkpointed, so it costs nothing at
    inference."""
    if remat not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {remat!r} (want {sorted(_REMAT_POLICIES)})"
        )
    x = _embed(params, cfg, tokens)
    cos, sin = rope_frequencies(
        cfg, torch.arange(tokens.shape[1], device=tokens.device))
    wrap = _REMAT_POLICIES[remat if torch.is_grad_enabled() else "none"]
    for layer in params.layers:
        x = wrap(functools.partial(_layer_fwd, layer, cfg))(
            x, cos, sin, attn_impl)
    return _norm(x, params.final_norm, cfg)


def forward(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
            attn_impl: str = "auto") -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) → logits (B, S, V) f32."""
    return _lm_head_logits(forward_hidden(params, cfg, tokens, attn_impl),
                           params)


# ---------------------------------------------------------------------------
# KV storage


def _kv_cache_leaves(shape: tuple, dtype, kv_bits: int, device=None) -> dict:
    """The structure-keyed storage format: ``shape`` is the (..., S, D)
    value-leaf shape; kv_bits=8 stores int8 values plus bf16 scale leaves
    one rank lower. The leaves' names decide how writes quantize and how
    attention dequantizes."""
    if kv_bits == 8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                   device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                   device=device),
        }
    if kv_bits:
        raise ValueError(f"kv_bits must be 0 or 8, got {kv_bits}")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _kv_quantize(x: torch.Tensor):
    """(..., S, D) → (int8 values, (..., S) bf16 scales): symmetric
    per-(position, head) amax quantization over the head dim. A true
    division and round-half-to-even, as in JAX, so the bytes agree."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  kv_bits: int = 0, device=None) -> dict:
    """Stacked KV cache: (L, B, Hkv, max_len, head_dim) per value leaf;
    ``kv_bits=8`` stores int8 values plus (L, B, Hkv, max_len) bf16 scale
    leaves. The leaves' names carry the format: writes quantize, decode
    attention dequantizes, prefill attention runs on the fresh K/V."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return _kv_cache_leaves(shape, cfg.dtype, kv_bits, device)


def _cache_store(cache_l: dict, k: torch.Tensor, v: torch.Tensor,
                 position: int) -> dict:
    """Write (B, Hkv, S, D) K/V into one layer's cache slice at a shared
    ``position``, IN PLACE (JAX returns an updated copy), and return the
    slice dict. Quantizes on write when the cache carries scale leaves."""
    s = k.shape[2]
    if "k_scale" in cache_l:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        cache_l["k"][:, :, position:position + s] = kq
        cache_l["v"][:, :, position:position + s] = vq
        cache_l["k_scale"][:, :, position:position + s] = ks
        cache_l["v_scale"][:, :, position:position + s] = vs
    else:
        cache_l["k"][:, :, position:position + s] = k
        cache_l["v"][:, :, position:position + s] = v
    return cache_l


def _row_targets(positions: torch.Tensor, k_len: int, c: int) -> tuple:
    """Where ``_cache_store_rows`` writes a (B, K) chunk at per-row
    ``positions`` in a cache of C columns: (rows, cols, at_end, j_last,
    has_last). It depends on no layer, so a layer loop computes it once."""
    positions = positions.long()
    posmat = positions[:, None] + torch.arange(k_len, device=positions.device)
    # The chunk column that belongs at C - 1, where the chunk reaches it.
    j_last = (c - 1 - positions).clamp(0, k_len - 1)
    has_last = (positions <= c - 1) & (positions + k_len - 1 >= c - 1)
    rows = torch.arange(positions.shape[0], device=positions.device)
    return (rows, posmat.clamp_max(c - 1), (posmat >= c - 1)[..., None],
            j_last, has_last[:, None])


def _cache_store_rows(cache_l: dict, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, targets: Optional[tuple] = None
                      ) -> dict:
    """Per-ROW offsets variant of _cache_store: row b of the (B, Hkv, K, D)
    chunk goes to positions[b] .. positions[b] + K - 1, IN PLACE.
    ``targets`` is ``_row_targets(positions, K, C)``, computed here when
    not given.

    Unlike JAX, the write is CLIPPED at the cache's end: a row whose chunk
    would run past C writes its first C - positions[b] columns and drops
    the rest. JAX's ``dynamic_update_slice`` instead shifts the whole chunk
    back to start at C - K, so a decode row near the end of the cache
    writes its one real token over an earlier one (the ragged
    ContinuousBatcher's tokens fork there). The dropped tail is only pad
    columns past the write pointer. One indexed write per leaf, with no
    host sync: the dropped columns are aimed at column C - 1 with the value
    that column ends up holding, so duplicate targets carry equal values."""
    c = cache_l["k"].shape[2]
    if targets is None:
        targets = _row_targets(positions, k.shape[2], c)
    rows, cols, at_end, j_last, has_last = targets

    def put(leaf, new):  # new (B, Hkv, K[, D])
        new = new.transpose(1, 2)  # (B, K, Hkv[, D])
        tail = (...,) if new.dim() == 3 else (..., None)
        last = torch.where(has_last[tail], new[rows, j_last],
                           leaf[:, :, c - 1])  # (B, Hkv[, D])
        leaf[rows[:, None], :, cols] = torch.where(
            at_end[tail], last[:, None], new)

    if "k_scale" in cache_l:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            put(cache_l[name], new)
    else:
        put(cache_l["k"], k)
        put(cache_l["v"], v)
    return cache_l


@torch.no_grad()
def _prefill_impl(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                  kv_cache: dict, kv_mask: Optional[torch.Tensor] = None,
                  attn_impl: str = "auto") -> tuple[torch.Tensor, dict]:
    """Prefill: write the prompt's K/V into ``kv_cache`` (in place) and
    return (last-position logits (B, V), the cache) in one pass.

    ``kv_mask`` (B, S) bool marks real prompt tokens of LEFT-padded
    batches; RoPE positions stay absolute cache indices (shift-equivariant,
    so the pad offset cancels in q·k). A pad row sees no key and gives 0.
    ``attn_impl`` goes to ``flash_attention`` (JAX always uses "auto")."""
    x = _embed(params, cfg, tokens)
    s = tokens.shape[1]
    cos, sin = rope_frequencies(cfg, torch.arange(s, device=tokens.device))
    for li, layer in enumerate(params.layers):
        cache_l = {name: leaf[li] for name, leaf in kv_cache.items()}
        h = _norm(x, layer.attn_norm, cfg)
        hq, hk, hv = _qkv(h, layer)
        q = apply_rope(_split_heads(hq, cfg.head_dim), cos, sin)
        k = apply_rope(_split_heads(hk, cfg.head_dim), cos, sin)
        v = _split_heads(hv, cfg.head_dim)
        _cache_store(cache_l, k, v, 0)
        # Attention runs on the FRESH full-precision K/V; an int8 cache
        # quantizes storage only.
        attn = flash_attention(q, k, v, causal=True, impl=attn_impl,
                               window=cfg.sliding_window, kv_mask=kv_mask)
        x = x + _tp_sum(_mm(_merge_heads(attn), layer.wo), layer)
        h = _norm(x, layer.mlp_norm, cfg)
        x = x + _mlp(layer, h, cfg)
    x_last = _norm(x[:, -1], params.final_norm, cfg)
    return _lm_head_logits(x_last, params), kv_cache


def prefill(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
            kv_cache: dict) -> tuple[torch.Tensor, dict]:
    """Prompt pass: (last-position logits, primed cache) in ONE pass."""
    return _prefill_impl(params, cfg, tokens, kv_cache)


def _gqa_decode_attention(
    q: torch.Tensor,            # (B, H, Sq, D)
    k: torch.Tensor,            # (B, Hkv, L, D) — int8 when k_scale given
    v: torch.Tensor,            # (B, Hkv, L, D)
    position,                   # int | (Sq,) | (B,) or (B, Sq) with per_batch
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,   # (B, L) valid-key mask
    per_batch: bool = False,
    k_scale: Optional[torch.Tensor] = None,   # (B, Hkv, L) int8-cache scales
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped-query decode attention against the UNREPEATED cache: q is
    folded to (B, Hkv, G, Sq, D). int8 caches fold the K scales into the
    f32 scores and the V scales into the probabilities. Plain softmax at
    NEG_INF, as in JAX: a row with no valid key averages V uniformly
    (callers never read such a row)."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    scale = 1.0 / math.sqrt(d)
    if k_scale is not None:
        k = k.to(q.dtype)
    scores = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(), k.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, None, :]
    pos = torch.as_tensor(position, device=q.device)
    if per_batch:
        pos_q = (pos[:, None, None, :, None] if pos.dim() == 2
                 else pos[:, None, None, None, None])
    else:
        if pos.dim() == 0:
            pos = pos.expand(sq)
        pos_q = pos[None, None, None, :, None]
    k_pos = torch.arange(k.shape[2], device=q.device)[None, None, None, None, :]
    mask = k_pos <= pos_q
    if window:
        mask = mask & (k_pos > pos_q - window)
    if kv_mask is not None:
        mask = mask & kv_mask.to(torch.bool)[:, None, None, None, :]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float()[:, :, None, None, :]
        v = v.to(q.dtype)
        out = torch.einsum("bgrqk,bgkd->bgrqd", probs.to(q.dtype).float(),
                           v.float()).to(q.dtype)
        return out.reshape(b, h, sq, d)
    out = torch.einsum("bgrqk,bgkd->bgrqd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(b, h, sq, d)


def _plain_attend(cfg: LlamaConfig, attn_positions,
                  kv_mask: Optional[torch.Tensor], per_batch: bool):
    """The ``attend(q, cache_l)`` of ``_chunk_decode_scan`` that runs
    ``_gqa_decode_attention`` (int8 caches with their scales folded in)."""

    def attend(q, cache_l):
        return _gqa_decode_attention(
            q, cache_l["k"], cache_l["v"], attn_positions,
            window=cfg.sliding_window, kv_mask=kv_mask, per_batch=per_batch,
            k_scale=cache_l.get("k_scale"), v_scale=cache_l.get("v_scale"),
        )

    return attend


@torch.no_grad()
def _chunk_decode_scan(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                       kv_cache: dict, cos: torch.Tensor, sin: torch.Tensor,
                       store, attend) -> tuple[torch.Tensor, dict]:
    """THE cached-chunk decode body (a loop over layers), parameterized by
    what its callers differ in: the cache ``store(cache_l, k, v)`` strategy
    (in place) and ``attend(q, cache_l)``, the attention over the layer's
    cache (``_plain_attend``, or the dense kernel in ``_cb_step``). The
    cache's leaves decide the storage format (int8 + scales, or the model
    dtype). Returns (logits (B, K, V), the cache)."""
    x = _embed(params, cfg, tokens)
    for li, layer in enumerate(params.layers):
        cache_l = {name: leaf[li] for name, leaf in kv_cache.items()}
        h = _norm(x, layer.attn_norm, cfg)
        hq, hk, hv = _qkv(h, layer)
        q = apply_rope(_split_heads(hq, cfg.head_dim), cos, sin)
        k = apply_rope(_split_heads(hk, cfg.head_dim), cos, sin)
        v = _split_heads(hv, cfg.head_dim)
        store(cache_l, k, v)
        attn = attend(q, cache_l)
        x = x + _tp_sum(_mm(_merge_heads(attn), layer.wo), layer)
        h = _norm(x, layer.mlp_norm, cfg)
        x = x + _mlp(layer, h, cfg)
    x = _norm(x, params.final_norm, cfg)
    return _lm_head_logits(x, params), kv_cache


def _decode_chunk_impl(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                       kv_cache: dict, position,
                       kv_mask: Optional[torch.Tensor] = None):
    """Cached decode of a CHUNK: (B, K) tokens written at cache slots
    ``position .. position+K-1`` → (logits (B, K, V), the cache). K == 1 is
    ordinary decode. Query i attends cache slots <= position + i;
    ``kv_mask`` (B, cache_len) marks valid slots (False on left pads)."""
    position = int(position)
    positions = position + torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_frequencies(cfg, positions)

    def store(cache_l, k, v):
        # One whole-batch slice write at the shared offset.
        _cache_store(cache_l, k, v, position)

    return _chunk_decode_scan(
        params, cfg, tokens, kv_cache, cos, sin, store,
        _plain_attend(cfg, positions, kv_mask, per_batch=False))


def _decode_chunk_batch_impl(params: Llama, cfg: LlamaConfig,
                             tokens: torch.Tensor, kv_cache: dict,
                             positions: torch.Tensor,
                             kv_mask: Optional[torch.Tensor] = None):
    """Cached decode of a chunk at PER-ROW offsets: row b's (1, K) tokens
    written at ``positions[b] .. positions[b]+K-1`` (clipped at the cache's
    end, see ``_cache_store_rows``) → (logits (B, K, V), the cache). Query
    i of row b attends cache slots <= positions[b] + i."""
    positions = positions.long()
    posmat = positions[:, None] + torch.arange(tokens.shape[1],
                                               device=tokens.device)
    cos, sin = rope_frequencies(cfg, posmat.reshape(-1))
    cos = cos.reshape(*posmat.shape, -1)  # (B, K, half)
    sin = sin.reshape(*posmat.shape, -1)

    targets = _row_targets(positions, tokens.shape[1],
                           next(iter(kv_cache.values())).shape[3])

    def store(cache_l, k, v):
        _cache_store_rows(cache_l, k, v, positions, targets)

    return _chunk_decode_scan(
        params, cfg, tokens, kv_cache, cos, sin, store,
        _plain_attend(cfg, posmat, kv_mask, per_batch=True))


def _decode_impl(params: Llama, cfg: LlamaConfig, token: torch.Tensor,
                 kv_cache: dict, position,
                 kv_mask: Optional[torch.Tensor] = None):
    """Single-token decode: (B, 1) token → (logits (B, V), the cache)."""
    logits, cache = _decode_chunk_impl(params, cfg, token, kv_cache, position,
                                       kv_mask=kv_mask)
    return logits[:, 0], cache


def decode_step(params: Llama, cfg: LlamaConfig, token: torch.Tensor,
                kv_cache: dict, position) -> tuple[torch.Tensor, dict]:
    """One autoregressive step: (B, 1) token at ``position`` → (logits
    (B, V), the cache written in place)."""
    return _decode_impl(params, cfg, token, kv_cache, position)


def prefill_chunked(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                    kv_cache: dict, chunk: int = 512):
    """Long-prompt prefill in fixed chunks: (last-position logits, cache),
    with activations bounded at O(chunk) rows. Each chunk attends the cache
    written so far plus itself, chunk-causally."""
    b, s = tokens.shape
    if s % chunk:
        raise ValueError(f"prompt length {s} not divisible by chunk {chunk}")
    last = None
    for start in range(0, s, chunk):
        logits, kv_cache = _decode_chunk_impl(
            params, cfg, tokens[:, start:start + chunk], kv_cache, start)
        last = logits[:, -1]
    return last, kv_cache


def prime_kv_cache(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                   kv_cache: dict) -> dict:
    """Write the prompt's K/V into the cache (prefill side-product)."""
    return _prefill_impl(params, cfg, tokens, kv_cache)[1]


# ---------------------------------------------------------------------------
# Sampling


def _filter_top_k_top_p(logits: torch.Tensor, top_k: int,
                        top_p: float) -> torch.Tensor:
    """The top-k / nucleus filter: top-k keeps the k best per row; top-p
    cuts tokens whose EXCLUSIVE prefix mass already covers top_p — the
    best token always survives."""
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]  # (B, 1)
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gumbel-max draw per row — the scheme of ``jax.random.categorical``
    with a torch Generator's bits (the draws differ from JAX's)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """temperature → top-k → top-p → categorical; temperature == 0 is
    greedy (argmax, first index on ties) and draws nothing."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return _categorical(
        _filter_top_k_top_p(logits / temperature, top_k, top_p), generator
    )


def sample_logits_per_row(logits: torch.Tensor, generator: torch.Generator,
                          temps: torch.Tensor, top_k: int = 0,
                          top_p: float = 1.0) -> torch.Tensor:
    """sample_logits with a PER-ROW temperature: greedy rows (temp <= 0)
    take the argmax, the rest a categorical draw; top_k/top_p are
    engine-wide."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = _filter_top_k_top_p(
        logits / torch.clamp_min(temps, 1e-6)[:, None], top_k, top_p
    )
    sampled = _categorical(scaled, generator)
    return torch.where(temps <= 0.0, greedy, sampled)


# ---------------------------------------------------------------------------
# Generation loops: a Python loop over the steps (one jitted scan in JAX)


def greedy_generate(params: Llama, cfg: LlamaConfig, prompt: torch.Tensor,
                    max_new_tokens: int,
                    kv_cache: Optional[dict] = None) -> torch.Tensor:
    """Greedy decoding: prefill once, then stepwise decode; returns
    (B, max_new_tokens). A given ``kv_cache`` is written in place."""
    b, s_prompt = prompt.shape
    if kv_cache is None:
        kv_cache = init_kv_cache(cfg, b, s_prompt + max_new_tokens,
                                 device=prompt.device)
    last_logits, kv_cache = prefill(params, cfg, prompt, kv_cache)
    next_token = torch.argmax(last_logits, dim=-1)[:, None]
    tokens = [next_token]
    for i in range(max_new_tokens - 1):
        logits, kv_cache = decode_step(params, cfg, next_token, kv_cache,
                                       s_prompt + i)
        next_token = torch.argmax(logits, dim=-1)[:, None]
        tokens.append(next_token)
    return torch.cat(tokens, dim=1)


def _generate_impl(params: Llama, cfg: LlamaConfig, prompt: torch.Tensor,
                   kv_cache: dict, steps: int,
                   generator: Optional[torch.Generator] = None,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 1.0) -> torch.Tensor:
    """ONE prefill + decode loop for greedy AND sampled generation;
    returns (B, steps). temperature == 0 is greedy and draws nothing."""
    s_prompt = prompt.shape[1]
    if generator is None:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    logits, kv_cache = _prefill_impl(params, cfg, prompt, kv_cache)
    tok = sample_logits(logits, generator, temperature, top_k, top_p)[:, None]
    toks = [tok]
    # The last emitted token is not decoded (JAX decodes it and drops the
    # result), so the cache needs s_prompt + steps - 1 positions.
    for i in range(steps - 1):
        logits, kv_cache = _decode_impl(params, cfg, tok, kv_cache,
                                        s_prompt + i)
        tok = sample_logits(logits, generator, temperature, top_k,
                            top_p)[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1)[:, :steps]


def generate_tokens(params: Llama, cfg: LlamaConfig, prompt: torch.Tensor,
                    kv_cache: dict, steps: int) -> torch.Tensor:
    """Prefill + ``steps`` greedy decode steps into the given cache."""
    return _generate_impl(params, cfg, prompt, kv_cache, steps)


def sample(params: Llama, cfg: LlamaConfig, prompt: torch.Tensor,
           generator: Optional[torch.Generator], steps: int, cache_len: int,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """Sampled generation (the sampling counterpart of ``generate``);
    draws from ``generator`` where JAX takes a key."""
    kv_cache = init_kv_cache(cfg, prompt.shape[0], cache_len,
                             device=prompt.device)
    return _generate_impl(params, cfg, prompt, kv_cache, steps,
                          generator=generator, temperature=temperature,
                          top_k=top_k, top_p=top_p)


def generate(params: Llama, cfg: LlamaConfig, prompt: torch.Tensor,
             steps: int, cache_len: int, kv_bits: int = 0) -> torch.Tensor:
    """Greedy generation into a fresh cache of ``cache_len`` positions;
    ``kv_bits=8`` decodes against an int8 cache."""
    cache = init_kv_cache(cfg, prompt.shape[0], cache_len, kv_bits=kv_bits,
                          device=prompt.device)
    return _generate_impl(params, cfg, prompt, cache, steps)
