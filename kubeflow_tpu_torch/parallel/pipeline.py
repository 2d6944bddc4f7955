"""Pipeline parallelism over the ``pp`` axis: the GPipe schedule.

Counterpart of ``kubeflow_tpu/parallel/pipeline.py``. The layer stack is
cut into ``pp`` stages of consecutive layers, one a rank; a GPipe
microbatch schedule runs ``n_micro + pp − 1`` steps, in each of which
every stage runs its layers on the activation it holds and passes the
result one stage on (``collectives.ppermute``). The embedding, the final
norm and the lm head stay whole on every rank, as JAX replicates them.

What differs from JAX:
- The port's layers are a list of modules, not leaves stacked on a
  layer axis: ``split_layers_into_stages`` cuts the list into pp lists
  and ``merge_stages_into_layers`` joins them; ``shard_pipeline_params``
  keeps this rank's stage in the model (IN PLACE) and records it.
- Bubbles are skipped. In JAX's one SPMD program every stage computes at
  every step and a bubble's result is masked away; here stage ``i``
  runs its layers at step ``t`` only on a real microbatch (``0 <= t - i
  < n_micro``) and passes its input on unchanged otherwise, which never
  reaches an output. So a rank runs its layers ``n_micro`` times a
  forward, each layer launching the flash forward once (twice under
  ``remat="full"``, whose backward recomputes it) and the dQ and dK/dV
  kernels once in the backward. The last step's hop, whose result JAX
  drops, is not sent.
- The collectives GSPMD derives from ``shard_map``'s transpose are
  written out: the output's masked psum is a ``tp_sum`` over pp (only the
  last stage's collected microbatches are nonzero), and the replicated
  input takes a ``tp_copy`` over pp, so the embedding's gradient, which
  only stage 0 computes, is summed over pp onto every rank. Every rank's
  received activation and input enter its graph (with zero gradient
  where the schedule does not read them), so every rank's backward walks
  the same hops in the same order, each hop's node fed by the previous.
- ``remat`` ("none", JAX's, or "full") checkpoints each layer of a stage
  (``models/llama.py``'s policies): the same values, less memory.
- Other mesh axes are ignored: every rank of a stage computes the whole
  batch, as JAX's ``shard_map`` (stage over pp, all else replicated)
  does.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from kubeflow_tpu_torch.models.llama import (
    _REMAT_POLICIES,
    Llama,
    LlamaConfig,
    _embed,
    _layer_fwd,
    _lm_head_logits,
    _norm,
    rope_frequencies,
)
from kubeflow_tpu_torch.parallel import collectives


def split_layers_into_stages(layers, pp: int) -> list:
    """The layer list → pp lists of L/pp consecutive layers."""
    layers = list(layers)
    if len(layers) % pp:
        raise ValueError(f"n_layers={len(layers)} not divisible by pp={pp}")
    n = len(layers) // pp
    return [layers[i * n:(i + 1) * n] for i in range(pp)]


def merge_stages_into_layers(staged: list) -> list:
    """Inverse of split_layers_into_stages."""
    return [layer for stage in staged for layer in stage]


def _stage(plan) -> tuple:
    """(pp group, pp size, this rank's stage index) of ``plan``."""
    pp = int(plan.mesh.shape.get("pp", 1))
    idx = plan.mesh.coordinate("pp") if pp > 1 else 0
    return plan.mesh.group("pp"), pp, idx


def shard_pipeline_params(params: Llama, plan) -> Llama:
    """Keep this rank's stage of ``params``' layers, IN PLACE (the other
    stages' layers are dropped), and record it as ``params.stage`` =
    (index, pp); the rest stays whole on every rank. Returns
    ``params``."""
    _, pp, idx = _stage(plan)
    if getattr(params, "stage", None) is not None:
        if params.stage != (idx, pp):
            raise ValueError(f"params already hold stage {params.stage}")
        return params
    params.layers = nn.ModuleList(
        split_layers_into_stages(params.layers, pp)[idx])
    params.stage = (idx, pp)
    return params


class _Join(torch.autograd.Function):
    """``keep`` in the forward; in the backward its gradient, and zeros
    for ``also``: a value the schedule receives but does not read still
    enters the graph, so its collective's backward runs on every rank."""

    @staticmethod
    def forward(ctx, keep, also):
        ctx.also = also.shape
        return keep.clone()

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.also)


def make_pipelined_apply(cfg: LlamaConfig, plan, n_micro: int,
                         remat: str = "none"):
    """apply(stage_layers, x, cos, sin) -> x: the layer stack pipelined
    over ``plan``'s pp axis with ``n_micro`` microbatches, each rank
    running ``stage_layers`` (its stage). x: (B, S, D) with B % n_micro
    == 0, the same on every rank; the result is replicated."""
    group, pp, idx = _stage(plan)
    wrap = _REMAT_POLICIES[remat]
    perm = [(i, (i + 1) % pp) for i in range(pp)]

    def stage_fn(layers, x, cos, sin):
        body = wrap if torch.is_grad_enabled() else _REMAT_POLICIES["none"]
        for layer in layers:
            x = body(functools.partial(_layer_fwd, layer, cfg))(
                x, cos, sin, "auto")
        return x

    def apply(layers, x, cos, sin):
        b, s, d = x.shape
        if b % n_micro:
            raise ValueError(
                f"batch {b} not divisible by n_micro={n_micro}")
        inputs = collectives.tp_copy(x, group).reshape(
            n_micro, b // n_micro, s, d)
        buf = torch.zeros_like(inputs[0])
        collected = [torch.zeros_like(inputs[0]) for _ in range(n_micro)]
        n_steps = n_micro + pp - 1
        for t in range(n_steps):
            # Stage 0 ingests microbatch t (the clamped feed of a bubble
            # is never read); the others read what was passed to them.
            feed = inputs[min(t, n_micro - 1)]
            buf = _Join.apply(feed, buf) if idx == 0 else _Join.apply(
                buf, feed)
            y = stage_fn(layers, buf, cos, sin) if 0 <= t - idx < n_micro \
                else buf
            out_t = t - (pp - 1)
            if idx == pp - 1 and out_t >= 0:
                collected[out_t] = y
            if t < n_steps - 1:
                buf = collectives.ppermute(y, group, perm)
        # Only the last stage holds real outputs: its masked sum over pp.
        # The other stages' zeros carry their last activation into the
        # graph, so the loss's backward reaches every hop on every rank.
        out = torch.stack(collected)
        if idx != pp - 1:
            out = _Join.apply(out, y)
        out = collectives.tp_sum(out, group)
        return out.reshape(b, s, d)

    return apply


def pipeline_forward(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                     plan, n_micro: int, remat: str = "none"
                     ) -> torch.Tensor:
    """Full forward with the layer stack pipelined: ``params`` holds this
    rank's stage (``shard_pipeline_params``). Logits (B, S, V) f32 on
    every rank."""
    apply = make_pipelined_apply(cfg, plan, n_micro, remat)
    x = _embed(params, cfg, tokens)
    cos, sin = rope_frequencies(
        cfg, torch.arange(tokens.shape[1], device=tokens.device))
    x = apply(params.layers, x, cos, sin)
    x = _norm(x, params.final_norm, cfg)
    return _lm_head_logits(x, params)


class PipelineStep:
    """``state, loss = step(state, tokens)``: one AdamW step of the
    pipelined model, the state updated in place; its parts
    ``loss_and_grads`` and ``grad_norm`` (the global norm: the stages'
    squares summed over pp, the replicated leaves' counted once) and
    ``apply``."""

    def __init__(self, cfg, plan, n_micro, optimizer, remat):
        self.cfg, self.plan, self.n_micro = cfg, plan, n_micro
        self.optimizer, self.remat = optimizer, remat

    def loss_fn(self, params: Llama, tokens: torch.Tensor) -> torch.Tensor:
        logits = pipeline_forward(params, self.cfg, tokens, self.plan,
                                  self.n_micro, self.remat)
        targets = tokens[:, 1:].long()
        logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
        return -torch.gather(logprobs, -1, targets[..., None])[..., 0].mean()

    def loss_and_grads(self, state: dict, tokens: torch.Tensor
                       ) -> torch.Tensor:
        params = state["params"]
        params.zero_grad(set_to_none=True)
        loss = self.loss_fn(params, tokens)
        loss.backward()
        return loss.detach()

    def grad_norm(self, state: dict) -> torch.Tensor:
        params = state["params"]
        stage = [p.grad for p in params.layers.parameters()
                 if p.grad is not None]
        ids = {id(p) for p in params.layers.parameters()}
        rest = [p.grad for p in params.parameters()
                if id(p) not in ids and p.grad is not None]
        sq = sum(torch.sum(g.float() * g.float()) for g in stage)
        group, _, _ = _stage(self.plan)
        sq = collectives.psum(sq, group)
        return torch.sqrt(sq + sum(torch.sum(g.float() * g.float())
                                   for g in rest))

    def apply(self, state: dict) -> None:
        self.optimizer.update(state["opt_state"], int(state["step"]))
        state["params"].zero_grad(set_to_none=True)
        state["step"] += 1

    def __call__(self, state: dict, tokens: torch.Tensor):
        loss = self.loss_and_grads(state, tokens)
        self.apply(state)
        return state, loss


def make_pipeline_train_step(cfg: LlamaConfig, plan, n_micro: int,
                             optimizer=None, remat: str = "none"):
    """(init_state, step): causal-LM training with pp-pipelined layers,
    the dense loss over full logits (JAX's); AdamW at JAX's defaults (lr
    3e-4, b2 0.95, weight decay 0.1, no clip) unless ``optimizer`` is
    given. ``init_state(params)`` takes the model with this rank's stage
    (``shard_pipeline_params``), turns its grads on and allocates AdamW
    over it; each rank steps its stage and its copy of the replicated
    leaves, whose gradients are whole on every rank. Every rank calls the
    step with the same global batch."""
    from kubeflow_tpu_torch.models.train import make_optimizer

    if remat not in _REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {remat!r} (want {sorted(_REMAT_POLICIES)})"
        )
    optimizer = optimizer or make_optimizer()

    def init_state(params: Llama) -> dict:
        if getattr(params, "stage", None) is None:
            raise ValueError(
                "the pipeline trains a model cut to its stage: pass the "
                "params through shard_pipeline_params first")
        params.requires_grad_(True)
        return {"params": params, "opt_state": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int64)}

    return init_state, PipelineStep(cfg, plan, n_micro, optimizer, remat)

