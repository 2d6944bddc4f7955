"""Training step: causal-LM loss and AdamW, on one device or sharded
over a mesh of ``torch.distributed`` ranks.

Counterpart of ``kubeflow_tpu/models/train.py``: the same losses (dense,
and chunked so full (B, S, vocab) logits never exist), the same remat
policies (``models/llama.py`` ``_REMAT_POLICIES``), AdamW with optax's
semantics and schedule, gradient accumulation over strided microbatches,
and fp8 training with delayed scaling (``models/fp8.py``). Attention
differentiates through the flash kernels' ``FlashAttention``
(``ops/attention.py``).

Sharded (``plan`` a ``MeshPlan``, after ``shard_state``): each rank holds
its slice of every parameter and Adam moment (``parallel/mesh.py``'s
``param_spec``: tp over heads, hidden and vocab, fsdp over the input
dim), takes its ``batch_sharding`` rows of the global batch, and runs the
forward with the collectives GSPMD would insert (``models/llama.py``).
After the backward the gradients are averaged over the batch axes: a leaf
fsdp cuts was reduce-scattered over fsdp in the backward and is summed
over dp; every other leaf is summed over dp · fsdp. The loss returned is
the global mean, the clip's norm the global norm (each leaf's squares
counted once however many ranks hold a replica), and AdamW updates each
rank's slices elementwise, so a sharded step is the unsharded step's
arithmetic in another order.

What differs from JAX:
- The train state is ``{"params": Llama, "opt_state": torch.optim.AdamW,
  "step": int64 scalar tensor}``, and ``train_step`` updates it IN PLACE
  (JAX donates the state and returns a new one) and returns it with the
  step's loss. ``shard_state`` cuts it in place too.
- ``plan`` may also be ``None`` or a device: one device, no collective.
  A quantized model is refused: the JAX package cannot train one either.
- Under an sp axis each rank holds every parameter whole and its
  positions of its rows (``MeshPlan.local_batch``), and writes out the
  three facts GSPMD hides: rope positions are global (``forward_hidden``'s
  ``offset``), the last target of a rank's piece is the next rank's first
  token (only the last rank drops a position, ``MeshPlan.seq_piece``),
  and each rank's loss is its positions' share of the global mean over B
  · (S − 1), its gradients summed over sp as well as over dp · fsdp.
  Attention is ``sp_impl``'s (``parallel/ring_attention.py``,
  ``ulysses.py``, ``zigzag_attention.py``); with ``use_ring_sp=False``
  on an sp mesh each rank attends the K/V gathered over sp, the dense
  attention GSPMD would run. The pipeline and expert-parallel steps are
  ``parallel/pipeline.py``'s and ``models/moe.py``'s.
- ``train_step`` is a ``TrainStep``: calling it is JAX's step; its
  ``loss_and_grads``, ``grad_norm`` and ``apply`` are the step's parts.
- fp8 (``fp8=True``): JAX partitions the optimizer with
  ``optax.multi_transform``; here AdamW is made over the master weights
  alone (``fp8.fp8_partition_labels``), so its decay and the clip never
  see a history, and after AdamW's update each history is replaced by its
  gradient, its next value (``fp8.fp8_meta_replace``: optax's ``h + (next
  - h)``).
- AdamW's state is allocated when the state is made, not at the first
  step, so a checkpoint of a fresh state has every leaf of a trained one.
- ``make_tiny_trainer`` draws its batches with numpy from the seed (JAX
  draws them with ``jax.random``), so its runs match each other, not
  JAX's. Its state goes through ``shard_state`` on a one-rank plan, as
  JAX's does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from kubeflow_tpu_torch.models.fp8 import (
    fp8_meta_replace,
    fp8_partition_labels,
    has_fp8_params,
)
from kubeflow_tpu_torch.models.llama import (
    LLAMA_CONFIGS,
    Llama,
    LlamaConfig,
    _head_weight,
    _lm_head_logits,
    forward,
    forward_hidden,
    init_params,
)
from kubeflow_tpu_torch.models.quant import QuantizedWeight
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import (
    AXES,
    SP_FSDP_GRAD_AXES,
    SP_GRAD_AXES,
    MeshPlan,
    SeqPiece,
    _world,
    make_mesh,
    place,
    placement_of,
)


def _shift(tokens: torch.Tensor, seq: Optional[SeqPiece]) -> tuple:
    """The next-token pairing of a batch: (positions that have a target,
    their targets, the positions with a target in a global row). Under
    sp (``seq``) the last target of a rank's piece is the next rank's
    first token, and only the last rank drops a position."""
    if seq is None or seq.nxt is None:
        keep, targets = tokens.shape[1] - 1, tokens[:, 1:]
    else:
        keep = tokens.shape[1]
        targets = torch.cat([tokens[:, 1:], seq.nxt[:, None].to(tokens.dtype)],
                            dim=1)
    total = tokens.shape[1] if seq is None else seq.total
    return keep, targets.long(), total - 1


def per_token_nll(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                  attn_impl="auto", seq: Optional[SeqPiece] = None
                  ) -> torch.Tensor:
    """(B, S-1) next-token negative log likelihoods — the one place the
    NLL math lives (training mean-loss and perplexity eval both fold it).
    ``seq``: a sequence-parallel rank's piece (its positions that have a
    target)."""
    keep, targets, _ = _shift(tokens, seq)
    logits = forward(params, cfg, tokens, attn_impl=attn_impl,
                     offset=0 if seq is None else seq.offset)[:, :keep]
    logprobs = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logprobs, -1, targets[..., None])[..., 0]


def causal_lm_loss(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                   attn_impl="auto", seq: Optional[SeqPiece] = None
                   ) -> torch.Tensor:
    """Next-token cross entropy over (B, S) token batches. Under sp
    (``seq``) a rank's share of the global mean: its NLL sum over the
    global row's positions, B · (S-1)."""
    nll = per_token_nll(params, cfg, tokens, attn_impl, seq)
    if seq is None:
        return torch.mean(nll)
    return torch.sum(nll) / (tokens.shape[0] * (seq.total - 1))


def _chunk_nll_sum(params: Llama, h_c: torch.Tensor, t_c: torch.Tensor,
                   w) -> torch.Tensor:
    logits = _lm_head_logits(h_c, params, w)  # (B, c, V) f32, one chunk
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, t_c.long()[..., None])[..., 0]
    return torch.sum(lse - tgt)


def chunked_causal_lm_loss(params: Llama, cfg: LlamaConfig,
                           tokens: torch.Tensor, attn_impl="auto",
                           chunk: int = 512, remat: str = "full",
                           seq: Optional[SeqPiece] = None) -> torch.Tensor:
    """causal_lm_loss without ever materializing (B, S, vocab) logits.

    The lm head and cross entropy run per sequence chunk, each chunk
    checkpointed (the backward recomputes its logits), so at most one
    chunk's f32 logits are alive; a tail shorter than ``chunk`` runs
    unchecked, as in JAX. The same lse − target arithmetic in f32 as
    ``causal_lm_loss``. ``remat`` goes to the layer stack. The head's
    weight is taken (under fsdp: gathered) once for every chunk. Under sp
    (``seq``) the chunks run over the rank's positions and the sum is
    divided by the global row's, as in ``causal_lm_loss``."""
    b, s = tokens.shape
    s_global = s if seq is None else seq.total
    if s_global < 2:
        raise ValueError(
            f"causal LM loss needs sequences of >= 2 tokens, got S={s_global}"
        )
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    hidden = forward_hidden(params, cfg, tokens, attn_impl, remat=remat,
                            offset=0 if seq is None else seq.offset)
    n_pos, targets, n_global = _shift(tokens, seq)
    hidden = hidden[:, :n_pos]
    chunk = min(chunk, max(n_pos, 1))
    n_chunks = n_pos // chunk
    w = _head_weight(params)
    body = functools.partial(_chunk_nll_sum, params)
    if torch.is_grad_enabled():
        body = functools.partial(_ckpt.checkpoint, body, use_reentrant=False)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        span = slice(c * chunk, (c + 1) * chunk)
        total = total + body(hidden[:, span], targets[:, span], w)
    if n_chunks * chunk < n_pos:  # S-1 is rarely chunk-aligned
        total = total + _chunk_nll_sum(params, hidden[:, n_chunks * chunk:],
                                       targets[:, n_chunks * chunk:], w)
    return total / (b * n_global)


# ---------------------------------------------------------------------------
# Optimizer


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init → end over ``steps``, then end."""
    def value(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return value


def _cosine(init: float, decay_steps: int,
            alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: init → init·alpha over decay_steps."""
    def value(count: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                     / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return value


def _join(first: Callable, second: Callable,
          boundary: int) -> Callable[[int], float]:
    """optax.join_schedules: the second piece from ``boundary`` on, fed
    the count less the boundary."""
    def value(count: int) -> float:
        return first(count) if count < boundary else second(count - boundary)
    return value


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw(schedule, b1=0.9, b2=0.95, weight_decay=...)`` (eps
    1e-8, decay on every leaf), after ``optax.clip_by_global_norm`` when
    ``clip_norm`` > 0, over ``torch.optim.AdamW``: fused on the card (its
    foreach path would hold temporaries as large as the params), the
    single-tensor path on the CPU. ``schedule(n)`` is the lr of update n,
    counted from 0."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.1
    clip_norm: float = 0.0

    def init(self, params) -> torch.optim.AdamW:
        """The optimizer over ``params`` (a model's parameters, a dict tree
        of tensors in sorted-key order as JAX flattens it, or a list), its
        moments allocated now (zeros) in the layout ``torch.optim.AdamW``
        gives them at its first step."""
        plist = tensor_leaves(params)
        fused = plist[0].device.type == "cuda"
        opt = torch.optim.AdamW(
            plist, lr=self.schedule(0), betas=(0.9, 0.95), eps=1e-8,
            weight_decay=self.weight_decay,
            fused=fused, foreach=False if not fused else None)
        for p in plist:
            opt.state[p] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if fused else "cpu"),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
            }
        return opt

    def update(self, opt: torch.optim.AdamW, count: int,
               norm: Optional[torch.Tensor] = None) -> None:
        """Update n = ``count`` from the grads in each parameter's
        ``.grad``: clip (optax's formula: ``g / ‖g‖ · clip`` when ‖g‖ is
        not below ``clip_norm``, with no ``+1e-6``), set the lr, step.
        ``norm``: the global norm of the grads where the caller has it
        (a sharded step's, over the mesh)."""
        grads = [p.grad for group in opt.param_groups for p in group["params"]
                 if p.grad is not None]
        if self.clip_norm > 0 and grads:
            norm = global_norm(grads) if norm is None else norm
            keep = norm < self.clip_norm
            for g in grads:
                g.copy_(torch.where(keep, g,
                                    g / norm.to(g.dtype) * self.clip_norm))
        lr = float(self.schedule(count))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a module (its parameters), a dict tree (sorted keys)
    or a sequence, in order."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in tensor_leaves(tree[key])]
    return [t for item in tree for t in tensor_leaves(item)]


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ x²) over every element of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup_steps: int = 0, decay_steps: int = 0,
                   end_lr_ratio: float = 0.1, clip_norm: float = 0.0
                   ) -> AdamW:
    """AdamW with the standard LLM training schedule knobs.

    - warmup_steps > 0: linear warmup from 0 to ``lr``;
    - decay_steps > 0: cosine decay from ``lr`` to ``lr*end_lr_ratio``
      over exactly ``decay_steps`` steps AFTER warmup; with
      decay_steps=0 the lr stays at peak forever after warmup;
    - clip_norm > 0: global-norm gradient clipping before the update.
    """
    if warmup_steps or decay_steps:
        warm = _linear(0.0, lr, max(warmup_steps, 1))
        rest = (_cosine(lr, decay_steps, end_lr_ratio) if decay_steps
                else (lambda count: lr))
        schedule = _join(warm, rest, warmup_steps)
    else:
        def schedule(count: int) -> float:
            return lr
    return AdamW(schedule, weight_decay=weight_decay, clip_norm=clip_norm)


# ---------------------------------------------------------------------------
# Train step


def _mesh_plan(plan) -> Optional[MeshPlan]:
    """The ``MeshPlan`` of a sharded step; None for one device (``plan``
    None or a device)."""
    if plan is None or isinstance(plan, (str, torch.device)):
        return None
    if not isinstance(plan, MeshPlan):
        raise TypeError(
            f"plan {plan!r}: want None, a device or a MeshPlan")
    return plan


def _placed_replicas(t: torch.Tensor, plan: MeshPlan) -> int:
    """How many ranks of ``plan``'s mesh hold the piece ``t`` is."""
    pl = placement_of(t)
    return plan.mesh.size if pl is None else pl.replicas


def shard_state(plan: MeshPlan, state: dict) -> dict:
    """Place params + optimizer state onto the mesh per the plan, IN PLACE
    (and return the state): every parameter is cut to this rank's slice
    by ``param_spec`` with its ``Placement`` (``MeshPlan.cut``; a
    parameter already cut stays), each Adam moment takes its parameter's
    placement (JAX's path-stripping rule) and is cut where it is still
    whole, and scalars (the step counts) stay whole: replicated. A moment
    is cut one at a time, so the peak extra memory is one leaf."""
    plan.cut(state["params"])
    place_moments(state["opt_state"])
    return state


def place_moments(opt: torch.optim.AdamW) -> None:
    """Give each Adam moment its parameter's ``Placement``, cutting the
    moments still whole to the parameter's piece, one at a time."""
    with torch.no_grad():
        for group in opt.param_groups:
            for p in group["params"]:
                pl = placement_of(p)
                moments = opt.state.get(p, {})
                for key, m in list(moments.items()):
                    if m.dim() == 0:
                        continue
                    if (tuple(m.shape) == pl.global_shape
                            != pl.local_shape):
                        m = pl.slice(m).clone()
                        moments[key] = m
                    place(m, pl)


def batch_mean(plan: MeshPlan, grads: list, loss: torch.Tensor,
               loss_group="batch") -> torch.Tensor:
    """The mean over the plan's batch axes: of each gradient of ``grads``,
    ``(grad, group)`` pairs, in place (summed over ``group`` first, where
    there is one), and of ``loss``, returned (summed over ``loss_group``
    first: by default the batch axes' group; under sp the group over the
    batch axes and sp, each sp rank's loss its positions' share)."""
    dist = torch.distributed
    n = plan.n_batch
    for grad, group in grads:
        if group is not None:
            dist.all_reduce(grad, group=group)
        if n > 1:
            grad.div_(n)
    if loss_group == "batch":
        loss_group = plan.batch_group
    if loss_group is not None:
        loss = loss.clone()
        dist.all_reduce(loss, group=loss_group)
    return loss / n if n > 1 else loss


def _gathered_attention(plan: MeshPlan):
    """The attention JAX's GSPMD runs for ``impl="auto"`` on a batch cut
    over sp: each rank's queries against the whole sequence's K/V,
    gathered over sp (the gradient reduce-scattered back, the pair
    ``fsdp_gather`` is), through ``flash_attention(impl="auto")`` at the
    rank's ``q_offset``."""
    group, index = plan.sp_group, plan.sp_index

    def attention(q, k, v, causal=True, q_offset=0, window=0, kv_mask=None,
                  impl=None):
        from kubeflow_tpu_torch.ops.attention import flash_attention

        k, v = (collectives.fsdp_gather(t, group, 2) for t in (k, v))
        if kv_mask is not None:
            kv_mask = collectives.gather_mask(kv_mask, group)
        return flash_attention(q, k, v, causal=causal,
                               q_offset=q_offset + index * q.shape[2],
                               window=window, kv_mask=kv_mask)

    return attention


def sp_attention(plan: Optional[MeshPlan], use_ring_sp: Optional[bool],
                 sp_impl: str):
    """The attention impl of a step under ``plan`` (JAX's choice in
    ``make_train_step``): "auto" without an sp axis unless
    ``use_ring_sp``; else ``sp_impl``'s mesh-bound attention. An sp mesh
    with ``use_ring_sp=False`` gathers K/V over sp, as GSPMD does for
    JAX's dense attention there."""
    from kubeflow_tpu_torch.parallel.ring_attention import (
        make_sharded_ring_attention,
    )
    from kubeflow_tpu_torch.parallel.ulysses import (
        make_sharded_ulysses_attention,
    )
    from kubeflow_tpu_torch.parallel.zigzag_attention import (
        make_sharded_zigzag_attention,
    )

    sp = 1 if plan is None else plan.sp
    if use_ring_sp is None:
        use_ring_sp = sp > 1
    if not use_ring_sp:
        return "auto" if sp == 1 else _gathered_attention(plan)
    if plan is None:
        raise ValueError("sequence-parallel attention needs a MeshPlan plan")
    return {"ring": make_sharded_ring_attention,
            "ulysses": make_sharded_ulysses_attention,
            "zigzag": make_sharded_zigzag_attention}[sp_impl](plan)


class TrainStep:
    """``state, loss = train_step(state, tokens)``: one optimizer step,
    the state updated in place. Its parts, for a caller that reads the
    gradients between them: ``loss_and_grads`` (the loss, the gradients
    left in each parameter's ``.grad``, averaged over the batch axes under
    a plan), ``grad_norm`` (their global norm) and ``apply`` (the update,
    the fp8 histories replaced, the step counted)."""

    def __init__(self, cfg, plan, optimizer, grad_accum, loss_chunk, remat,
                 fp8, attn_impl="auto"):
        self.cfg, self.plan, self.optimizer = cfg, plan, optimizer
        self.grad_accum, self.loss_chunk = grad_accum, loss_chunk
        self.remat, self.fp8, self.attn_impl = remat, fp8, attn_impl

    def loss_fn(self, params: Llama, tokens: torch.Tensor,
                seq: Optional[SeqPiece] = None) -> torch.Tensor:
        if self.loss_chunk:
            return chunked_causal_lm_loss(params, self.cfg, tokens,
                                          self.attn_impl,
                                          chunk=self.loss_chunk,
                                          remat=self.remat, seq=seq)
        return causal_lm_loss(params, self.cfg, tokens, self.attn_impl, seq)

    def _masters(self, params: Llama) -> list:
        labels = fp8_partition_labels(params)
        return [(name, p) for name, p in params.named_parameters()
                if labels[name] == "default"]

    def loss_and_grads(self, state: dict, tokens: torch.Tensor
                       ) -> torch.Tensor:
        params = state["params"]
        ga = self.grad_accum
        params.zero_grad(set_to_none=True)
        seq = None
        if self.plan is not None:
            seq = self.plan.seq_piece(tokens)
            tokens = self.plan.local_batch(tokens)
        if ga == 1:
            loss = self.loss_fn(params, tokens, seq)
            loss.backward()
            loss = loss.detach()
        else:
            b = tokens.shape[0]
            if b % ga:
                if self.plan is not None:
                    raise ValueError(
                        f"this rank's {b} rows of the batch are not "
                        f"divisible by grad_accum {ga}: its strided "
                        "microbatches would not be the global batch's")
                raise ValueError(f"batch {b} not divisible by grad_accum {ga}")
            plist = list(params.parameters())
            sums = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in plist]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(ga):
                micro_seq = None if seq is None else dataclasses.replace(
                    seq, nxt=None if seq.nxt is None else seq.nxt[i::ga])
                micro_loss = self.loss_fn(params, tokens[i::ga], micro_seq)
                micro_loss.backward()
                loss = loss + micro_loss.detach()
                for acc, p in zip(sums, plist):
                    acc += p.grad.float()
                    p.grad = None
            loss = loss / ga
            for acc, p in zip(sums, plist):
                p.grad = (acc / ga).to(p.dtype)
        if self.plan is not None:
            loss = self._average(params, loss)
        return loss

    def _average(self, params: Llama, loss: torch.Tensor) -> torch.Tensor:
        """The global mean of the loss and the gradients over the batch
        axes. A leaf fsdp cuts had its gradient summed over fsdp by the
        backward's reduce-scatter: it is summed over dp here; every other
        master over dp · fsdp. Under sp each rank's loss and gradients are
        its positions' share, summed over sp too. The fp8 histories' next
        values are already the mesh's (their amaxes are)."""
        plan = self.plan
        sp = plan.sp > 1
        grads = []
        for _, p in self._masters(params):
            if p.grad is None:
                continue
            pl = placement_of(p)
            if pl is not None and pl.split_dim("fsdp") is not None:
                group = plan.mesh.group(SP_FSDP_GRAD_AXES if sp else "dp")
            else:
                group = (plan.mesh.group(SP_GRAD_AXES) if sp
                         else plan.batch_group)
            grads.append((p.grad, group))
        return batch_mean(plan, grads, loss, plan.mesh.group(SP_GRAD_AXES)
                          if sp else "batch")

    def grad_norm(self, state: dict) -> torch.Tensor:
        """The global norm of the masters' gradients: under a plan each
        rank's squares over the replicas of its pieces, summed over the
        mesh."""
        grads = [(p, p.grad) for _, p in self._masters(state["params"])
                 if p.grad is not None]
        if self.plan is None or self.plan.mesh.size == 1:
            return global_norm([g for _, g in grads])
        total = sum(torch.sum(g.float() * g.float())
                    / _placed_replicas(p, self.plan) for p, g in grads)
        group = self.plan.mesh.group(AXES)
        if group is not None:
            torch.distributed.all_reduce(total, group=group)
        return torch.sqrt(total)

    def apply(self, state: dict) -> None:
        params = state["params"]
        norm = None
        if self.optimizer.clip_norm > 0 and self.plan is not None:
            norm = self.grad_norm(state)
        self.optimizer.update(state["opt_state"], int(state["step"]), norm)
        if self.fp8:
            fp8_meta_replace(params)
        params.zero_grad(set_to_none=True)
        state["step"] += 1

    def __call__(self, state: dict, tokens: torch.Tensor):
        loss = self.loss_and_grads(state, tokens)
        self.apply(state)
        return state, loss


def make_train_step(
    cfg: LlamaConfig,
    plan=None,
    optimizer: Optional[AdamW] = None,
    use_ring_sp: Optional[bool] = None,
    sp_impl: str = "ring",
    grad_accum: int = 1,
    loss_chunk: int = 512,
    remat: str = "full",
    fp8: bool = False,
):
    """Build ``(init_state, train_step)`` for one device or a mesh.

    ``init_state(params)`` turns the params' grads on and returns the
    state dict; ``train_step(state, tokens)`` (a ``TrainStep``) computes
    the loss and grads, takes one optimizer update and returns ``(state,
    loss)``, the state updated in place.

    ``use_ring_sp`` (default: the mesh has an sp axis > 1) runs attention
    sequence-parallel with ``sp_impl``: "ring" (K/V rotate around the sp
    ranks), "ulysses" (two all-to-alls trade sequence shards for head
    shards; the heads a tp rank holds must divide by sp) or "zigzag" (the
    balanced causal ring; causal-only, so not for sliding-window
    configs). ``sp_impl`` is validated always and ignored without sp, as
    in JAX.

    ``plan``: None or a device trains on one device; a ``MeshPlan``
    trains sharded over its mesh (each rank calls the step on the same
    global batch, or on its piece from ``data.loader.device_put_global``,
    and takes its ``batch_sharding`` rows; pass the state through
    ``shard_state`` first). The loss returned is the global batch's.

    ``grad_accum`` > 1 splits the batch into that many microbatches and
    sums their f32 gradients before ONE update (JAX's scan carry), each
    microbatch STRIDED (``micro[i] = tokens[i::grad_accum]``, as JAX's
    reshape-transpose gives). The f32 sum holds twice the bf16 params'
    bytes beside them, as JAX's carry does. The batch's leading dim must
    be divisible by grad_accum; under a plan each rank's rows must be,
    so that its strided rows are its share of the global microbatches.

    ``loss_chunk`` > 0 uses chunked_causal_lm_loss (full (B, S, vocab)
    logits never materialize); 0 falls back to the dense loss.
    ``remat`` picks the layer-stack checkpoint policy
    (llama._REMAT_POLICIES: "full" | "dots" | "none").

    ``fp8=True`` trains with fp8 product operands (models/fp8.py): pass
    params through ``fp8.wrap_params_fp8`` first; AdamW sees the master
    weights while each fp8 history is replaced by its autograd-carried
    next value (averaged over the microbatches under ``grad_accum``).
    init_state raises if the params tree and the flag disagree."""
    if sp_impl not in ("ring", "ulysses", "zigzag"):
        # Validate even when sp ends up inactive: a typo'd sp_impl on an
        # sp=1 mesh must not silently run dense attention.
        raise ValueError(
            f"unknown sp_impl {sp_impl!r} (want 'ring'|'ulysses'|'zigzag')"
        )
    mesh_plan = _mesh_plan(plan)
    attn_impl = sp_attention(mesh_plan, use_ring_sp, sp_impl)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    optimizer = optimizer or make_optimizer()

    def init_state(params: Llama) -> dict:
        if has_fp8_params(params) != fp8:
            raise ValueError(
                "params tree and fp8 flag disagree: "
                f"has_fp8_params={has_fp8_params(params)}, fp8={fp8} "
                "(wrap with fp8.wrap_params_fp8 AND pass fp8=True)"
            )
        quantized = [name for name, mod in params.named_modules()
                     if isinstance(mod, QuantizedWeight)]
        if quantized:
            raise NotImplementedError(
                f"{quantized[0]} is quantized: a quantized model cannot be "
                "trained, and the JAX package cannot train one either (its "
                "make_train_step fails in jax.grad on the int8 leaves, its "
                "make_lora_train_step in merge_lora)")
        params.requires_grad_(True)
        labels = fp8_partition_labels(params)
        masters = [p for name, p in params.named_parameters()
                   if labels[name] == "default"]
        return {"params": params, "opt_state": optimizer.init(masters),
                "step": torch.zeros((), dtype=torch.int64)}

    return init_state, TrainStep(cfg, mesh_plan, optimizer, grad_accum,
                                 loss_chunk, remat, fp8, attn_impl)


@torch.no_grad()
def token_nll(params: Llama, cfg: LlamaConfig,
              tokens: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Per-batch (sum NLL, token count) for perplexity evaluation."""
    nll = per_token_nll(params, cfg, tokens)
    return torch.sum(nll), nll.numel()


def evaluate_perplexity(params: Llama, cfg: LlamaConfig, batches) -> dict:
    """Corpus perplexity over an iterable of (B, S) token batches.

    Returns {"nll": mean per-token NLL, "perplexity": exp(nll),
    "tokens": count}. Positions 1..S-1 are scored against the model's
    prediction from the prefix."""
    total = 0.0
    count = 0
    for tokens in batches:
        s, n = token_nll(params, cfg, tokens)
        total += float(s)
        count += int(n)
    if count == 0:
        raise ValueError("no evaluation tokens")
    nll = total / count
    return {"nll": nll, "perplexity": math.exp(nll), "tokens": count}


def make_tiny_trainer(steps: int = 4, batch: int = 2, seq: int = 16,
                      seed: int = 0, device=None):
    """Deterministic single-device tiny-llama trainer for durability
    tests: ``(step_fn, fresh_state, batches)`` where ``fresh_state(key)``
    builds an init state from weights seeded by ``key`` and ``batches`` is
    a fixed token list (numpy draws from ``seed``). Rebuilding with the
    same seed reproduces the exact run, so an interrupted-and-resumed run
    can be held to an uninterrupted one with zero divergence."""
    from kubeflow_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    plan = MeshPlan(make_mesh(devices=[_world()[1]]))
    cfg = LLAMA_CONFIGS["tiny"]
    init_state, step_fn = make_train_step(cfg, plan)

    def fresh_state(key: int = 0) -> dict:
        gen = torch.Generator(device=dev).manual_seed(key)
        return shard_state(plan, init_state(init_params(cfg, gen, dev)))

    batches = [
        torch.from_numpy(np.random.default_rng(seed * 1000 + 100 + i).integers(
            0, cfg.vocab_size, size=(batch, seq))).to(dev)
        for i in range(steps)
    ]
    return step_fn, fresh_state, batches
