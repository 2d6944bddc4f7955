"""LoRA adapters for the Llama family: finetuning and serving.

Counterpart of ``kubeflow_tpu/models/lora.py``. An adapter keeps the JAX
tree's layout, one dict per target weight with the layer axis stacked
first: for a target W (in, out) of every layer, ``{"a": (L, in, r), "b":
(L, r, out)}``, and W' = W + (alpha/r) · a@b.

- Serving: ``merge_lora`` folds an adapter into a new ``Llama`` that
  shares every other weight, under ``torch.no_grad``;
  ``models/multilora.py`` serves many adapters over one base instead.
- Finetuning: ``make_lora_train_step`` trains only the adapters.
  ``merge_lora_differentiable`` merges every layer's targets before the
  forward, as JAX's step does, but keeps the graph from ``a`` and ``b``
  to the merged weights; every base weight enters as a detached view, so
  the base never requires grad and gets no gradient. At llama-3-8b the
  merged wq and wv copies hold ~1.34 GB beside the base.
- Finetuning under a plan (JAX's ``make_lora_train_step(plan=)``): the
  base is this rank's shard (``MeshPlan.shard_params``), the adapters
  stay whole on every rank, and each rank merges its slice of ``a @ b``
  into its slice of each target (``a``'s rows and ``b``'s columns that
  the target's placement gives it). The batch is split over dp · fsdp;
  each adapter's gradient is summed over the mesh (every rank computed
  its slice's share) and averaged over the batch axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
from kubeflow_tpu_torch.models.quant import QuantizedWeight, _set
from kubeflow_tpu_torch.models.train import (
    _mesh_plan,
    batch_mean,
    sp_attention,
    causal_lm_loss,
    make_optimizer,
    tensor_leaves,
)
from kubeflow_tpu_torch.parallel.mesh import (
    AXES,
    SP_GRAD_AXES,
    place,
    placement_of,
)

# Weights eligible for adapters: every layer's (in, out) projection.
_ADAPTABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # Llama-paper default: attention q/v projections.
    targets: tuple = ("wq", "wv")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def init_lora_params(cfg: LlamaConfig, lcfg: LoraConfig,
                     generator: Optional[torch.Generator] = None,
                     dtype=None, device=None) -> dict:
    """a ~ N(0, 1/in), b = 0: the adapted model starts exactly at the base
    model, the standard LoRA init. Values come from ``generator`` (seed 0
    on the device when None), target by target in ``lcfg.targets`` order;
    they do not match JAX's ``PRNGKey`` draws (parity tests bring JAX
    adapters over through ``models/bridge.py``)."""
    dtype = cfg.dtype if dtype is None else dtype
    bad = [t for t in lcfg.targets if t not in _ADAPTABLE]
    if bad:
        raise ValueError(f"unknown LoRA targets {bad}; valid: {_ADAPTABLE}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    shapes = _target_shapes(cfg)
    out: dict = {}
    for target in lcfg.targets:
        d_in, d_out = shapes[target]
        a = torch.randn((cfg.n_layers, d_in, lcfg.rank), generator=generator,
                        dtype=dtype, device=dev)
        a = a * torch.tensor(1.0 / math.sqrt(d_in), dtype=dtype, device=dev)
        b = torch.zeros((cfg.n_layers, lcfg.rank, d_out), dtype=dtype,
                        device=dev)
        out[target] = {"a": a, "b": b}
    return out


def _target_shapes(cfg: LlamaConfig) -> dict:
    hd = cfg.head_dim
    return {
        "wq": (cfg.dim, cfg.n_heads * hd),
        "wk": (cfg.dim, cfg.n_kv_heads * hd),
        "wv": (cfg.dim, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, cfg.dim),
        "w_gate": (cfg.dim, cfg.ffn_hidden),
        "w_up": (cfg.dim, cfg.ffn_hidden),
        "w_down": (cfg.ffn_hidden, cfg.dim),
    }


def _merged(params: Llama, lora: dict, lcfg: LoraConfig,
            graph: bool) -> Llama:
    """A new ``Llama`` over ``params``' weights with each target merged:
    W + (a@b) · scaling, summed in f32 (a@b accumulated in f32, as JAX's
    ``preferred_element_type``) and cast back to the weight's dtype, one
    layer at a time. With ``graph`` the merged targets keep their graph
    and every base weight enters detached; without, the base parameters
    are shared as they are and the merged ones are frozen parameters."""
    quantized = [name for name, mod in params.named_modules()
                 if isinstance(mod, QuantizedWeight)]
    if quantized:
        raise ValueError(
            f"merge_lora needs dense weights; quantized: {quantized[:3]}"
        )
    out = Llama(params.cfg, device="meta")
    for name, p in params.named_parameters():
        _set(out, name, _placed_like(p.detach(), p) if graph else p)
    for target, ab in lora.items():
        for i, layer in enumerate(params.layers):
            base = getattr(layer, target)
            w = base.detach()
            a, b = ab["a"][i], ab["b"][i]
            pl = placement_of(base)
            if pl is not None:
                # This rank's slice of a @ b: a's rows of the target's
                # first dim, b's columns of its second.
                (r0, r1), (c0, c1) = pl.index()
                a, b = a[r0:r1], b[:, c0:c1]
            delta = (a.float() @ b.float()) * lcfg.scaling
            merged = (w.float() + delta).to(w.dtype)
            if graph:
                _set(out.layers[i], target, _placed_like(merged, base))
            else:
                _set(out.layers[i], target, _placed_like(
                    nn.Parameter(merged, requires_grad=False), base))
    out.shard = params.shard
    for layer, src in zip(out.layers, params.layers):
        layer.shard = src.shard
    return out


def _placed_like(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``t`` with ``src``'s ``Placement`` beside it, where it has one."""
    pl = placement_of(src)
    return t if pl is None else place(t, pl)


@torch.no_grad()
def merge_lora(params: Llama, lora: dict, lcfg: LoraConfig) -> Llama:
    """Base params + scaled adapter deltas → a new ``Llama`` (every entry
    point works unchanged) that shares each weight the adapter does not
    touch with ``params``; no graph is recorded."""
    return _merged(params, lora, lcfg, graph=False)


def merge_lora_differentiable(params: Llama, lora: dict,
                              lcfg: LoraConfig) -> Llama:
    """``merge_lora`` that keeps its graph: the merged targets are tensors
    computed from ``a`` and ``b``, and every other weight a detached view
    of ``params``' (shared storage, never requiring grad), so a loss on
    the result differentiates into the adapters alone."""
    return _merged(params, lora, lcfg, graph=True)


def lora_param_count(cfg: LlamaConfig, lcfg: LoraConfig) -> int:
    shapes = _target_shapes(cfg)
    return sum(
        cfg.n_layers * lcfg.rank * (shapes[t][0] + shapes[t][1])
        for t in lcfg.targets
    )


def make_lora_train_step(cfg: LlamaConfig, lcfg: LoraConfig, plan=None,
                         optimizer=None, learning_rate: float = 1e-4):
    """Build ``(init_state, step)`` where ONLY the adapters train.

    ``init_state(lora_params)`` turns the adapters' grads on and returns
    ``{"lora", "opt_state", "step"}``; ``step(state, base_params, tokens)``
    takes the dense ``causal_lm_loss`` of the merged model
    (``merge_lora_differentiable``), one AdamW update of the adapters
    (``make_optimizer(lr=learning_rate, weight_decay=0.0)`` unless
    ``optimizer`` is given) and returns ``(state, loss)``, the state
    updated in place (JAX donates it and returns a new one). The base
    stays frozen: it records no graph and is never written. ``plan`` is
    ``None`` or a device, or a ``MeshPlan`` whose shard ``base_params``
    is (the batch a global one each rank takes its rows of, as
    ``make_train_step``'s); the loss returned is the global batch's. Under
    an sp axis each rank takes its positions of its rows too, and attends
    through the dense attention JAX keeps there ("auto" under GSPMD): its
    queries against the K/V gathered over sp (``train.sp_attention`` with
    ``use_ring_sp=False``), not the ring."""
    plan = _mesh_plan(plan)
    attn_impl = sp_attention(plan, False, "ring")
    optimizer = optimizer or make_optimizer(lr=learning_rate,
                                            weight_decay=0.0)

    def init_state(lora_params: dict) -> dict:
        for t in tensor_leaves(lora_params):
            t.requires_grad_(True)
        return {"lora": lora_params,
                "opt_state": optimizer.init(lora_params),
                "step": torch.zeros((), dtype=torch.int64)}

    def step(state: dict, base_params: Llama, tokens: torch.Tensor):
        leaves = tensor_leaves(state["lora"])
        for t in leaves:
            t.grad = None
        seq = None
        if plan is not None:
            seq = plan.seq_piece(tokens)
            tokens = plan.local_batch(tokens)
        merged = merge_lora_differentiable(base_params, state["lora"], lcfg)
        loss = causal_lm_loss(merged, cfg, tokens, attn_impl, seq)
        loss.backward()
        del merged
        loss = loss.detach()
        if plan is not None:
            # Each adapter's gradient is summed over the mesh (every rank
            # holds its share of its slice of each product, or of its
            # positions under sp), then averaged over the batch axes.
            group = plan.mesh.group(AXES)
            loss = batch_mean(plan, [(t.grad, group) for t in leaves], loss,
                              plan.mesh.group(SP_GRAD_AXES) if plan.sp > 1
                              else "batch")
        optimizer.update(state["opt_state"], int(state["step"]))
        for t in leaves:
            t.grad = None
        state["step"] += 1
        return state, loss

    return init_state, step
