"""The collectives of a sharded forward, each differentiable.

PyTorch has no GSPMD: where JAX's compiler inserts a psum, an
all-gather or their transposes around a sharded product, the port's
forward calls them itself (``models/llama.py``). Each one here is an
``autograd.Function`` whose backward is the collective GSPMD would put in
the backward pass:

- ``tp_sum``: all_reduce over tp in the forward (the partial outputs of
  the row-parallel ``wo`` and ``w_down``, and the vocab-split embedding's
  masked lookup), the identity in the backward (the gradient of a
  replicated output is already whole on every rank);
- ``tp_copy``: its conjugate before every column-parallel product (``wq``,
  ``wk``, ``wv``, ``w_gate``, ``w_up`` and the lm head): the identity in
  the forward, all_reduce over tp in the backward, where each rank holds
  its heads' share of the input's gradient (Megatron's f/g pair);
- ``tp_gather``: all_gather of the vocab-split head's logits along the
  last dim; the backward keeps this rank's slice of the gradient;
- ``fsdp_gather``: all_gather of a leaf's fsdp slice along the dim fsdp
  splits, inside the layer body that remat wraps (so a recompute gathers
  again and the whole model is never gathered at once); the backward
  reduce-scatters the gradient back to the slice, summed over fsdp.

Gloo (on the CPU, and for two ranks on one card, where NCCL refuses)
takes CUDA tensors for every one of them, staged through the host.

Without a group every function is the identity (no collective, no
autograd node), so an unsharded model runs as it did. Outside autograd
(serving, no grad) ``Function.apply`` records nothing, so the same
functions serve: ``tp_sum`` reduces in place there as in training.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of the group, concatenated along ``dim`` in
    group-rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum of ``t`` over the group, cut along ``dim`` into one slice a
    rank: this rank's slice. ``t.shape[dim]`` divides by the group size."""
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // _size(group), *moved.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


class _TpSum(torch.autograd.Function):
    """all_reduce of ``y`` in place (``y`` is contiguous): the serving
    path pays no copy."""

    @staticmethod
    def forward(ctx, y, group):
        dist.all_reduce(y, group=group)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """all_gather along ``dim`` forward, this rank's slice of the (already
    summed, ``reduce``=False) or reduce-scattered gradient backward."""

    @staticmethod
    def forward(ctx, t, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        ctx.size = t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        rank = dist.get_rank(ctx.group)
        return (g.narrow(ctx.dim, rank * ctx.size, ctx.size).contiguous(),
                None, None, None)


def tp_sum(y: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``y`` over the tp group, reduced in place."""
    if group is None:
        return y
    return _TpSum.apply(y.contiguous(), group)


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; in the backward its gradient summed over tp."""
    if group is None:
        return x
    return _TpCopy.apply(x, group)


def tp_gather(logits: torch.Tensor, group) -> torch.Tensor:
    """Every tp rank's logits concatenated along the vocab (last) dim."""
    if group is None:
        return logits
    return _Gather.apply(logits, group, logits.dim() - 1, False)


def fsdp_gather(w: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The leaf whole along ``dim`` (its fsdp slices gathered); in the
    backward the gradient reduce-scattered back to this rank's slice."""
    if group is None:
        return w
    return _Gather.apply(w, group, dim, True)
