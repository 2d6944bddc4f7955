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

The same ``tp_sum`` / ``tp_copy`` pair serves the pipeline's and the
experts' groups (``parallel/pipeline.py``, ``models/moe.py``): a sum of
partial results over a group, and the copy whose gradient is summed.

For sequence parallelism (``parallel/ring_attention.py``, ``ulysses.py``,
``zigzag_attention.py``) and the pipeline's hops:

- ``ppermute``: JAX's ``lax.ppermute`` over a group, for one tensor or a
  list of them, on ONE ``batch_isend_irecv`` a call (a rank that nobody
  sends to gets zeros, as in JAX); differentiable, its backward the
  inverse permutation of the gradients (of the floating tensors; a mask
  rides along without one). One call is one autograd node, so a chain of
  rotations is walked back in one order on every rank;
  ``ppermute_segments`` moves several tensor lists along several
  permutations as one such call (zigzag's redistributions);
- ``all_to_all``: JAX's tiled ``lax.all_to_all`` (split along one dim,
  one piece a rank, the pieces received concatenated along another);
  differentiable, its backward the swapped all-to-all;
- ``pmax`` and ``psum``: the no-grad reductions of the split-KV decode's
  merge;
- ``gather_mask``: an all_gather of a (B, S_local) key mask over the
  group, along the sequence.

Gloo (on the CPU, and for two ranks on one card, where NCCL refuses)
takes CUDA tensors for the all_reduce, all_gather and reduce-scatter,
staged through the host by gloo itself. For its point-to-point ops and
its all-to-all the port stages a CUDA tensor through host memory itself,
chosen by the group's backend (gloo) and the tensor's device, never by
catching an error: ``HOST_STAGING`` counts those copies (calls, bytes,
host seconds). On NCCL nothing is staged.

Without a group every function is the identity (no collective, no
autograd node), so an unsharded model runs as it did. Outside autograd
(serving, no grad) ``Function.apply`` records nothing, so the same
functions serve: ``tp_sum`` reduces in place there as in training.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

# The port's own host staging of gloo's point-to-point and all-to-all
# transfers of CUDA tensors: calls, bytes copied each way, host seconds.
HOST_STAGING = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _size(group) -> int:
    return dist.get_world_size(group)


def _staged(group, t: torch.Tensor) -> bool:
    """Whether the port stages ``t`` through host memory for a gloo
    point-to-point or all-to-all: a CUDA tensor over a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the bytes a transfer moves, flat uint8: a point-to-point
    op or an all-to-all copies bytes, and gloo's all-to-all takes neither
    bool nor 16-bit types (int16 raises "Invalid scalar type" there)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _to_host(ts: list) -> list:
    t0 = time.perf_counter()
    out = [t.cpu() for t in ts]
    HOST_STAGING["calls"] += 1
    HOST_STAGING["bytes"] += sum(t.numel() * t.element_size() for t in out)
    HOST_STAGING["seconds"] += time.perf_counter() - t0
    return out


def _to_device(ts: list, device) -> list:
    t0 = time.perf_counter()
    out = [t.to(device) for t in ts]
    HOST_STAGING["bytes"] += sum(t.numel() * t.element_size() for t in ts)
    HOST_STAGING["seconds"] += time.perf_counter() - t0
    return out


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


# ---------------------------------------------------------------------------
# Sequence parallelism and the pipeline's hops


def _exchange(segments: list, group) -> list:
    """Each segment ``(tensors, perm)``'s tensors sent along its ``perm``
    (pairs of group ranks, source to destination), all on one
    ``batch_isend_irecv``: what this rank receives, a list a segment,
    zeros where no rank sends to it. Sends to one peer arrive in the order
    they are posted, so the segments keep theirs."""
    rank = dist.get_rank(group)
    flat = [t for ts, _ in segments for t in ts]
    stage = bool(flat) and _staged(group, flat[0])
    ops, out = [], []
    for ts, perm in segments:
        to = {s: d for s, d in perm}.get(rank)
        frm = {d: s for s, d in perm}.get(rank)
        if to == rank:
            out.append([t.clone() for t in ts])
            continue
        wire = [_wire(t) for t in ts]
        send = _to_host(wire) if stage and to is not None else wire
        recv = [torch.zeros_like(w, device="cpu" if stage else w.device)
                for w in wire]
        if to is not None:
            peer = dist.get_global_rank(group, to)
            ops += [dist.P2POp(dist.isend, w, peer, group) for w in send]
        if frm is not None:
            peer = dist.get_global_rank(group, frm)
            ops += [dist.P2POp(dist.irecv, w, peer, group) for w in recv]
        out.append((recv, ts))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    done = []
    for got in out:
        if isinstance(got, tuple):
            recv, ts = got
            if stage:
                recv = _to_device(recv, flat[0].device)
            got = [r.view(t.dtype).view(t.shape) for r, t in zip(recv, ts)]
        done.append(got)
    return done


class _PPermute(torch.autograd.Function):
    """The tensors ``ts``, cut into segments of ``counts`` tensors, each
    segment sent along its permutation of ``perms``: one node, one
    ``batch_isend_irecv`` each way."""

    @staticmethod
    def forward(ctx, group, perms, counts, *ts):
        ctx.group, ctx.perms, ctx.counts = group, perms, counts
        ctx.float = [t.is_floating_point() for t in ts]
        outs = [o for seg in _exchange(_segments(ts, perms, counts), group)
                for o in seg]
        ctx.mark_non_differentiable(
            *[o for o, f in zip(outs, ctx.float) if not f])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        inverse = [[(d, s) for s, d in perm] for perm in ctx.perms]
        moved = _segments(grads, inverse, ctx.counts)
        floats = _segments(ctx.float, inverse, ctx.counts)
        back = _exchange([([g for g, f in zip(gs, fs) if f], perm)
                          for (gs, perm), (fs, _) in zip(moved, floats)],
                         ctx.group)
        out = []
        for (fs, _), got in zip(floats, back):
            got = iter(got)
            out += [next(got) if f else None for f in fs]
        return (None, None, None) + tuple(out)


def _segments(items, perms, counts) -> list:
    """``items`` cut into ``(items, perm)`` segments of ``counts``."""
    out, i = [], 0
    for perm, n in zip(perms, counts):
        out.append((list(items[i:i + n]), perm))
        i += n
    return out


def ppermute_segments(segments: list, group) -> list:
    """Several ``ppermute``s as one: each ``(tensors, perm)`` segment's
    tensors along its permutation, on one ``batch_isend_irecv`` and one
    autograd node (so a rank's backward issues them at one point, whatever
    it computed between). Returns a list of received tensors a segment."""
    counts = tuple(len(ts) for ts, _ in segments)
    if group is None:
        return [list(ts) for ts, _ in segments]
    perms = tuple(tuple(perm) for _, perm in segments)
    flat = _PPermute.apply(group, perms, counts,
                           *[t for ts, _ in segments for t in ts])
    return [list(seg) for seg, _ in _segments(flat, perms, counts)]


def ppermute(t, group, perm):
    """JAX's ``lax.ppermute`` over ``group``: ``t`` (a tensor, or a list
    or tuple of tensors moved together) sent from each source rank to its
    destination, ``perm`` a sequence of ``(source, destination)`` group
    ranks; a rank no pair sends to receives zeros. Differentiable: the
    backward sends each floating tensor's gradient along the inverse
    permutation (a mask rides along without one). One call is one
    autograd node. ``group`` None is the one-rank group (each pair must
    be ``(0, 0)``): the tensors themselves."""
    single = isinstance(t, torch.Tensor)
    (out,) = ppermute_segments([([t] if single else list(t), perm)], group)
    return out[0] if single else out


def _all_to_all(t: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = _size(group)
    chunks = t.chunk(n, dim=split_dim)
    piece = chunks[0].shape
    wire = torch.cat([_wire(c) for c in chunks])
    stage = _staged(group, t)
    if stage:
        (wire,) = _to_host([wire])
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    if stage:
        (out,) = _to_device([out], t.device)
    parts = out.view(t.dtype).reshape(n, *piece)
    return torch.cat(list(parts.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(t, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(t: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all``: ``t`` cut along ``split_dim`` into
    one piece a rank of ``group`` (piece j to group rank j), the pieces
    received concatenated along ``concat_dim`` in group-rank order.
    ``t.shape[split_dim]`` divides by the group size. Differentiable: the
    backward is the all-to-all with the two dims swapped. ``group`` None:
    ``t`` itself."""
    if group is None:
        return t
    return _AllToAll.apply(t, group, split_dim, concat_dim)


@torch.no_grad()
def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``t`` over ``group`` (a new tensor)."""
    if group is None:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


@torch.no_grad()
def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor)."""
    if group is None:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, group=group)
    return t


@torch.no_grad()
def gather_mask(mask: torch.Tensor, group) -> torch.Tensor:
    """A (B, S_local) bool key mask gathered over ``group`` along the
    sequence: (B, S_local · n), group-rank order."""
    if group is None:
        return mask
    return all_gather(mask.to(torch.uint8), group, 1).to(torch.bool)
