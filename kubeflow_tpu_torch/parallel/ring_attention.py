"""Ring attention: sequence (context) parallelism over the ``sp`` axis.

Counterpart of ``kubeflow_tpu/parallel/ring_attention.py``. The sequence
is cut over the sp ranks; each rank holds its Q/K/V shard, attends the
K/V chunk it currently holds, and passes K/V on around the ring
(``collectives.ppermute``), merging the partial softmaxes with the
log-sum-exp (flash) recursion. Memory a rank stays O(S/sp · D) while
every query sees the whole sequence.

Masking, as in JAX: ``causal`` with ``q_offset`` (the q shard's global
positions start at ``q_offset``), ``window`` (ring steps whose chunk lies
outside every query's window contribute nothing) and ``kv_mask`` (B,
S_local) valid-key marks, which rotate with their K/V chunk.

Decode (a few queries against an sp-cut KV cache) rotates nothing:
``sp_decode_attention`` takes one partial (m, l, o) a rank over its cache
shard and merges them over sp with one ``pmax`` and two ``psum``s, the
flash-decoding split-KV reduction.

Plain PyTorch, as the JAX module is plain ``jnp``: no kernel of its own.
The scores and the value products take the operands in their dtype
(bf16 in training) and accumulate in f32, as JAX's einsums with
``preferred_element_type=f32``: the operands are cast to f32 for the
product, which is exact for bf16 values.

What differs from JAX:
- The functions run on one rank with an explicit ``group`` (the sp
  process group, None for one rank) and this rank's ``index`` on it,
  where JAX's run inside ``shard_map`` and read ``axis_index``.
- The ring passes K/V on after each step but the last (JAX's scan also
  rotates after the last step and drops the result): n − 1 hops, the
  same values. Each hop moves K, V and the mask in one
  ``batch_isend_irecv``, one autograd node, so the backward walks the
  hops back in one order on every rank.
- ``make_sharded_ring_attention(plan)`` and
  ``make_sharded_sp_decode(plan)`` bind a ``MeshPlan``'s sp group and
  this rank's index; their callables take this rank's pieces (batch rows
  of (dp, fsdp), heads of tp, positions of sp), where JAX's take global
  arrays. JAX's ``cached_sharded`` builds and caches one ``shard_map``
  per static configuration; eager PyTorch has no program to build, so it
  has no counterpart.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from kubeflow_tpu_torch.parallel import collectives

NEG_INF = -1e30
# Key-width of the inner flash-style sub-block (see ring_attention): caps
# the materialized score buffer at (B, H, SqL, _RING_BLOCK) f32.
_RING_BLOCK = 1024


def _group_size(group) -> int:
    return 1 if group is None else torch.distributed.get_world_size(group)


def ring_perm(n: int) -> list:
    """Each rank to the next, around the ring."""
    return [(i, (i + 1) % n) for i in range(n)]


def scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q·kᵀ · scale in f32 from operands in their dtype: (B, H, Sq, Sk)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def lse_merge(m, l, o, s, v_blk):
    """One online-softmax (lse) recursion step shared by the SP attention
    functions (ring, zigzag): fold the already-masked score block ``s``
    and its values into the running (m, l, o)."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.matmul(
        p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l_new, o_new


def pick_kblock(ck: int) -> int:
    """Key-width sub-block for the flash-style inner scan: the largest
    aligned divisor of ``ck`` up to _RING_BLOCK (single block if none)."""
    blk = next((c for c in (_RING_BLOCK, 512, 256, 128) if ck % c == 0), ck)
    return min(blk, ck)


def safe_finish(m, l, o):
    """Normalize + safe-softmax: rows with no visible keys output zero
    instead of normalized garbage (shared convention with
    ops.attention)."""
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return torch.where((m > NEG_INF * 0.5)[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def _update(q, q_pos, scale, causal, window, m, l, o, k_blk, v_blk,
            mask_blk, k_start):
    """One flash-style (m, l, o) update against a key sub-block whose
    first key sits at global position ``k_start``."""
    s = scores(q, k_blk, scale)
    if causal or window:
        k_pos = k_start + torch.arange(k_blk.shape[2], device=q.device)[None]
        mask = (k_pos <= q_pos) if causal else torch.ones_like(k_pos <= q_pos)
        if window:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask[None, None], s, NEG_INF)
    if mask_blk is not None:
        s = torch.where(mask_blk[:, None, None, :], s, NEG_INF)
    return lse_merge(m, l, o, s, v_blk)


def ring_attention(
    q: torch.Tensor,  # local (B, H, Sq_local, D)
    k: torch.Tensor,  # local (B, H, Sk_local, D)
    v: torch.Tensor,
    group=None,
    index: int = 0,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # local (B, Sk_local) valid keys
) -> torch.Tensor:
    """Blockwise ring attention on this rank (``index`` on ``group``).

    Global positions: the q shard on ring index ``r`` covers
    ``q_offset + r*Sq_local .. q_offset + (r+1)*Sq_local - 1``; the K/V
    chunk that ORIGINATED on ring index ``c`` covers
    ``c*Sk_local .. (c+1)*Sk_local - 1`` (K/V always anchor at 0 — they
    are the full cached context; q may be a later chunk of it).

    Each held chunk is scanned in sub-blocks of at most ``_RING_BLOCK``
    keys with the same recursion, so the score buffer is (B, H, SqL,
    block); with more than one sub-block each runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``), so the backward
    holds O(block) too."""
    n = _group_size(group)
    b, h, sq_local, d = q.shape
    sk_local = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    q_pos = (q_offset + index * sq_local
             + torch.arange(sq_local, device=q.device)[:, None])
    blk = pick_kblock(sk_local)
    nblk = sk_local // blk
    update = _update
    if nblk > 1 and torch.is_grad_enabled():
        def update(*args):
            return _ckpt.checkpoint(_update, *args, use_reentrant=False)

    m = torch.full((b, h, sq_local), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq_local), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq_local, d), dtype=torch.float32,
                    device=q.device)
    k_cur, v_cur, mask_cur = k, v, kv_mask
    for step in range(n):
        # The chunk held now originated on rank (index - step).
        k_start0 = ((index - step) % n) * sk_local
        for j in range(nblk):
            span = slice(j * blk, (j + 1) * blk)
            m, l, o = update(
                q, q_pos, scale, causal, window, m, l, o,
                k_cur[:, :, span], v_cur[:, :, span],
                None if mask_cur is None else mask_cur[:, span],
                k_start0 + j * blk)
        if step < n - 1:
            moved = collectives.ppermute(
                [k_cur, v_cur] + ([] if mask_cur is None else [mask_cur]),
                group, ring_perm(n))
            k_cur, v_cur = moved[0], moved[1]
            mask_cur = None if mask_cur is None else moved[2]
    return safe_finish(m, l, o).to(q.dtype)


@torch.no_grad()
def sp_decode_attention(
    q: torch.Tensor,  # REPLICATED over sp: (B, H, Sq, D), Sq small (1..K)
    k: torch.Tensor,  # local cache shard (B, Hkv, Skl, D), UNREPEATED (GQA)
    v: torch.Tensor,
    position,  # scalar or (Sq,); (B,) with per_batch=True
    group=None,
    index: int = 0,
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # local (B, Skl) valid slots
    per_batch: bool = False,
    k_scale: Optional[torch.Tensor] = None,  # local (B, Hkv, Skl): int8
    v_scale: Optional[torch.Tensor] = None,  #   cache scales
) -> torch.Tensor:
    """Split-KV decode: this rank attends its local KV-cache shard, then
    the partial softmaxes merge over ``group`` with one pmax and two psums
    (the flash-decoding reduction). Returns the merged (B, H, Sq, D) on
    every rank.

    GQA-native: k/v carry their real head count (H % Hkv == 0); q folds
    to (B, Hkv, rep, Sq, D) against the unrepeated shard. An int8 shard
    (``k_scale`` given) casts its values to q's dtype for the products and
    folds the per-(head, position) scales into the f32 scores and the
    probabilities, as JAX does.

    Rank r's shard covers absolute slots r*Skl .. (r+1)*Skl-1. Query i
    attends slots <= position[i] (and > position[i]-window when
    windowed); ``per_batch`` positions are (B,), one a row (Sq == 1)."""
    b, h, sq, d = q.shape
    hkv, skl = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, h // hkv, sq, d)
    kk = k.to(q.dtype) if k_scale is not None else k
    s = torch.matmul(qg.float(), kk.float()[:, :, None].transpose(-1, -2)
                     ) * scale  # (B, G, R, Sq, Skl)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, None, :]
    pos = torch.as_tensor(position, device=q.device)
    k_pos = index * skl + torch.arange(skl, device=q.device)[None, :]
    if per_batch:
        q_pos = pos[:, None]  # (B, 1)
        mask = k_pos <= q_pos  # (B, Skl)
        if window:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    else:
        if pos.dim() == 0:
            pos = pos.expand(sq)
        q_pos = pos[:, None]  # (Sq, 1)
        mask = k_pos <= q_pos
        if window:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask[None, None, None], s, NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask.to(torch.bool)[:, None, None, None, :], s,
                        NEG_INF)
    # A shard whose every slot is masked contributes exp(-inf) = 0.
    m = collectives.pmax(s.amax(dim=-1), group)  # (B, G, R, Sq)
    p = torch.exp(s - m[..., None])
    l = collectives.psum(p.sum(dim=-1), group)
    if v_scale is not None:
        # The value scales folded into the probabilities: (…, Skl) work,
        # not a dequantized (…, Skl, D) cache.
        p = p * v_scale.float()[:, :, None, None, :]
        pv, vv = p.to(q.dtype), v.to(q.dtype)
    else:
        pv, vv = p.to(v.dtype), v
    o = collectives.psum(torch.matmul(pv.float(), vv.float()[:, :, None]),
                         group)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where((m > NEG_INF * 0.5)[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(b, h, sq, d).to(q.dtype)


def make_sharded_ring_attention(plan):
    """attention(q, k, v, causal, q_offset, window, kv_mask) over
    ``plan``'s sp group, on this rank's pieces: batch rows of (dp, fsdp),
    heads of tp, positions of sp. Signature-compatible with
    ``ops.attention.flash_attention``, so it can be passed as ``impl``."""
    group, index = plan.sp_group, plan.sp_index

    def attention(q, k, v, causal=True, q_offset=0, window=0, kv_mask=None,
                  impl=None):
        return ring_attention(q, k, v, group, index, causal=causal,
                              q_offset=q_offset, window=window,
                              kv_mask=kv_mask)

    return attention


def make_sharded_sp_decode(plan):
    """decode(q, k_shard, v_shard, position, window, kv_mask, per_batch,
    k_scale, v_scale) with q replicated over sp and this rank's piece of
    a KV cache cut over sp along the sequence: the serving-side
    counterpart of make_sharded_ring_attention. K/V may be GQA-unrepeated
    (their head axis the rank's kv heads under tp)."""
    group, index = plan.sp_group, plan.sp_index

    def decode(q, k, v, position, window=0, kv_mask=None, per_batch=False,
               k_scale=None, v_scale=None):
        if (k_scale is None) != (v_scale is None):
            raise ValueError(
                "k_scale and v_scale must be passed together (int8 cache "
                "shards carry both, models.llama init_kv_cache kv_bits=8)"
            )
        return sp_decode_attention(
            q, k, v, position, group, index, window=window, kv_mask=kv_mask,
            per_batch=per_batch, k_scale=k_scale, v_scale=v_scale)

    return decode
