"""Ulysses sequence parallelism: all-to-all head↔sequence re-sharding.

Counterpart of ``kubeflow_tpu/parallel/ulysses.py``, the second
long-context strategy beside ring attention: instead of rotating K/V
around a ring, two all-to-alls swap the cut axis. Inbound, each rank
trades its sequence shard for a HEAD shard (it then holds the whole
sequence for H/sp heads) and runs the ordinary flash attention locally;
outbound, the output goes back to sequence shards.

The local attention is the port's ``flash_attention(impl=local_impl)``:
on the card the flash forward kernel (``csrc/flash_attention.cu``) and,
in training, the dQ and dK/dV kernels of its backward. The K/V reach it
broadcast to the full heads (``flash_attention`` with a callable impl
broadcasts them first, as JAX's does), so each rank's local call runs at
GQA group 1.

Ulysses caps sp at the head count: the heads a rank holds (after tp)
must divide by sp, or it raises, as JAX does. ``kv_mask`` has no head
axis to trade and is all-gathered over sp instead.

What differs from JAX: the functions run on one rank with the sp process
group (``ulysses_attention``'s ``group``; None for one rank), and
``make_sharded_ulysses_attention(plan)`` binds a ``MeshPlan``'s, its
callable taking this rank's pieces (batch rows of (dp, fsdp), heads of
tp, positions of sp) where JAX's takes global arrays.
"""

from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops.attention import flash_attention
from kubeflow_tpu_torch.parallel import collectives


def ulysses_attention(
    q: torch.Tensor,  # local (B, H_local, S_local, D) — H_local is post-tp
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    causal: bool = True,
    local_impl="auto",
    q_offset: int = 0,
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # local (B, Sk_local)
) -> torch.Tensor:
    """All-to-all attention over ``group``.

    Requires H_local % sp == 0 (after any GQA repeat done by the caller).
    After the inbound all-to-all each rank holds the FULL sequence for its
    head group, so ``q_offset``/``window`` pass straight through to the
    local attention; ``kv_mask`` is all-gathered over sp."""
    sp = 1 if group is None else torch.distributed.get_world_size(group)
    if sp == 1:
        return flash_attention(q, k, v, causal=causal, impl=local_impl,
                               q_offset=q_offset, window=window,
                               kv_mask=kv_mask)
    h_local = q.shape[1]
    if h_local % sp != 0:
        raise ValueError(
            f"ulysses needs heads ({h_local}) divisible by sp ({sp}); "
            "repeat GQA K/V heads or lower sp"
        )
    if kv_mask is not None:
        kv_mask = collectives.gather_mask(kv_mask, group)  # (B, Sk) full
    # Trade sequence shards for head shards: (B, H, S/sp, D) → (B, H/sp, S, D).
    qs, ks, vs = (collectives.all_to_all(t, group, 1, 2) for t in (q, k, v))
    out = flash_attention(qs, ks, vs, causal=causal, impl=local_impl,
                          q_offset=q_offset, window=window, kv_mask=kv_mask)
    # Trade back: (B, H/sp, S, D) → (B, H, S/sp, D).
    return collectives.all_to_all(out, group, 2, 1)


def make_sharded_ulysses_attention(plan, local_impl="auto"):
    """attention(q, k, v, causal, q_offset, window, kv_mask) over
    ``plan``'s sp group, on this rank's pieces — a drop-in for
    make_sharded_ring_attention."""
    group, sp = plan.sp_group, plan.sp

    def attention(q, k, v, causal=True, q_offset=0, window=0, kv_mask=None,
                  impl=None):
        if q.shape[1] % sp != 0:
            raise ValueError(
                f"heads-per-tp-shard {q.shape[1]} not divisible by sp={sp}; "
                "the model layer must repeat GQA K/V up to full heads "
                "before sequence-parallel attention"
            )
        return ulysses_attention(q, k, v, group, causal=causal,
                                 local_impl=local_impl, q_offset=q_offset,
                                 window=window, kv_mask=kv_mask)

    return attention
