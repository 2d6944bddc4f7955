"""Zigzag ring attention: load-balanced CAUSAL sequence parallelism.

Counterpart of ``kubeflow_tpu/parallel/zigzag_attention.py``. The
contiguous ring (``parallel/ring_attention.py``) computes every (q shard
× k chunk) score block and masks the causally invisible half. Zigzag
gives each rank a PAIRED shard, one chunk from the sequence's front half
and its mirror from the back half, so every ring step carries the same,
fully visible work on every rank:

- the global sequence splits into ``2n`` chunks of C rows; rank ``r``
  owns chunks ``(r, 2n-1-r)`` ("early", "late");
- at ring step ``s`` the received K/V pair originated on rank
  ``c = (r - s) mod n``. For ``c < r`` both of this rank's q chunks see
  the received early chunk and neither sees the late one; for ``c > r``
  only q_late sees anything, but it sees both received chunks. Either
  way two C×C products, no masking. Step 0 (the local diagonal)
  computes three;
- partial softmaxes merge with the ring's lse recursion; K/V pairs
  rotate around the ring.

Callers keep the natural contiguous layout: the redistribution to the
zigzag layout and back happens inside, each a permutation whose slot is
decided by the receiver's parity.

Scope, as in JAX: causal, q_offset=0, no sliding window, no kv_mask.

What differs from JAX: one SPMD program serves every device there, so
JAX selects each step's case with traced ``jnp.where``s; a torch rank
knows its index and branches on it, computing only the products its
case needs. Every rank still issues the same collectives in the same
order, in the forward and in autograd's backward: each redistribution
(the three tensors' halves over both permutations) is one
``ppermute_segments`` call, one autograd node, and each step's rotation
of the K/V pair is one node fed by the previous one, so the nodes'
dependencies order the backward's collectives alike on every rank,
whatever each rank computed between them. The function takes the sp group and this rank's index on
it; ``make_sharded_zigzag_attention(plan)`` binds a ``MeshPlan``'s.
"""

from __future__ import annotations

import math

import torch
from torch.utils import checkpoint as _ckpt

from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.ring_attention import (
    NEG_INF,
    lse_merge,
    pick_kblock,
    ring_perm,
    safe_finish,
    scores,
)


def _owner(j: int, n: int) -> int:
    """Zigzag owner of global chunk j (0..2n-1): front-half chunks go to
    their own index, back-half chunks mirror onto the same ranks."""
    return j if j < n else 2 * n - 1 - j


def _block_update(m, l, o, q, k_blk, v_blk, scale, k_start, tri):
    s = scores(q, k_blk, scale)
    if tri:
        q_pos = torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = k_start + torch.arange(k_blk.shape[2], device=q.device)[None]
        s = torch.where((k_pos <= q_pos)[None, None], s, NEG_INF)
    return lse_merge(m, l, o, s, v_blk)


def _flash_update(acc, q, k, v, scale, tri=False):
    """lse-merge the accumulator ``acc`` = (m, l, o) with the scores
    q·kᵀ, k in sub-blocks of at most ``_RING_BLOCK`` keys (each under
    ``torch.utils.checkpoint`` when there are several, as JAX's
    ``jax.checkpoint``). ``tri`` applies the step-0 within-chunk causal
    triangle."""
    ck = k.shape[2]
    blk = pick_kblock(ck)
    update = _block_update
    if ck // blk > 1 and torch.is_grad_enabled():
        def update(*args):
            return _ckpt.checkpoint(_block_update, *args, use_reentrant=False)
    m, l, o = acc
    for j in range(ck // blk):
        span = slice(j * blk, (j + 1) * blk)
        m, l, o = update(m, l, o, q, k[:, :, span], v[:, :, span], scale,
                         j * blk, tri)
    return m, l, o


def zigzag_ring_attention(
    q: torch.Tensor,  # local contiguous (B, H, 2C, D)
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    index: int = 0,
) -> torch.Tensor:
    """Balanced causal ring attention on this rank (``index`` on
    ``group``); local shards are the natural contiguous rows
    ``[r·2C, (r+1)·2C)``, the zigzag redistribution internal."""
    n = 1 if group is None else torch.distributed.get_world_size(group)
    r = index
    b, h, s_local, d = q.shape
    if s_local % 2:
        raise ValueError(f"local sequence length {s_local} must be even")
    c_len = s_local // 2
    scale = 1.0 / math.sqrt(d)
    even = r % 2 == 0

    # Contiguous rank r holds global chunks (2r, 2r+1) as halves; the
    # zigzag owner maps are static permutations, A routing the first
    # halves and B the second.
    perm_a = [(i, _owner(2 * i, n)) for i in range(n)]
    perm_b = [(i, _owner(2 * i + 1, n)) for i in range(n)]
    recv_a, recv_b = collectives.ppermute_segments(
        [([t[:, :, :c_len] for t in (q, k, v)], perm_a),
         ([t[:, :, c_len:] for t in (q, k, v)], perm_b)], group)
    # What came through A is the receiver's early chunk iff it is even.
    (qe, ke, ve), (ql, kl, vl) = ((recv_a, recv_b) if even
                                  else (recv_b, recv_a))

    def acc():
        return (torch.full((b, h, c_len), NEG_INF, dtype=torch.float32,
                           device=q.device),
                torch.zeros((b, h, c_len), dtype=torch.float32,
                            device=q.device),
                torch.zeros((b, h, c_len, d), dtype=torch.float32,
                            device=q.device))

    early, late = acc(), acc()
    # Step 0, the local diagonal: q_early×k_early (triangle), q_late×k_late
    # (triangle), q_late×k_early (chunk r < chunk 2n-1-r: all visible).
    early = _flash_update(early, qe, ke, ve, scale, tri=True)
    late = _flash_update(late, ql, kl, vl, scale, tri=True)
    late = _flash_update(late, ql, ke, ve, scale)

    pair = [ke, kl, ve, vl]
    for step in range(1, n):
        # Rotate first: step 0 ran on the local pair, so step s computes
        # against the pair that originated s hops upstream.
        pair = collectives.ppermute(pair, group, ring_perm(n))
        ke_c, kl_c, ve_c, vl_c = pair
        if (r - step) % n < r:
            # Both q chunks see the received early chunk, nothing sees
            # the late one.
            early = _flash_update(early, qe, ke_c, ve_c, scale)
            late = _flash_update(late, ql, ke_c, ve_c, scale)
        else:
            # Only q_late sees anything, and it sees both chunks.
            late = _flash_update(late, ql, ke_c, ve_c, scale)
            late = _flash_update(late, ql, kl_c, vl_c, scale)

    out_e = safe_finish(*early).to(q.dtype)
    out_l = safe_finish(*late).to(q.dtype)
    # Back to the contiguous layout: rank r re-collects chunks (2r, 2r+1),
    # each from the rank the same map sent it to; the sender's parity
    # says which slot holds it.
    send_a, send_b = (out_e, out_l) if even else (out_l, out_e)
    inv_a = [(dst, src) for src, dst in perm_a]
    inv_b = [(dst, src) for src, dst in perm_b]
    (h0,), (h1,) = collectives.ppermute_segments(
        [([send_a], inv_a), ([send_b], inv_b)], group)
    return torch.cat([h0, h1], dim=2)


def make_sharded_zigzag_attention(plan):
    """Drop-in ``sp_impl`` callable for make_train_step over ``plan``'s sp
    group, on this rank's pieces — signature-compatible with
    ops.attention.flash_attention, rejecting the masking options the
    balanced schedule cannot honor."""
    group, index = plan.sp_group, plan.sp_index

    def attention(q, k, v, causal=True, q_offset=0, window=0, kv_mask=None,
                  impl=None):
        if not causal or q_offset or window or kv_mask is not None:
            raise ValueError(
                "zigzag sp attention is causal-only (no q_offset/window/"
                "kv_mask): its balanced schedule derives from pure "
                "causality — use sp_impl='ring' for masked variants"
            )
        return zigzag_ring_attention(q, k, v, group, index)

    return attention
