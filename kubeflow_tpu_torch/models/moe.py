"""Mixture-of-Experts transformer (Mixtral-style) with expert parallelism.

Counterpart of ``kubeflow_tpu/models/moe.py``: the Llama attention and a
top-k softmax router over expert SwiGLU FFNs, with the Switch/Mixtral
load-balancing auxiliary loss (aux = E · Σ_e fraction_routed_e ·
mean_router_prob_e). Routing is the dense one-hot dispatch and combine of
JAX's: every expert runs on every token, masked to the ones routed to it,
and the gates weight the outputs back; the router runs in f32.

Weights keep JAX's layout, one ``MoELayer`` a layer where JAX stacks a
leading layer axis: the expert leaves are ``(E, dim, hidden)`` (gate,
up) and ``(E, hidden, dim)`` (down), the router ``(dim, E)`` f32
(``models/bridge.py``'s ``moe_from_jax`` unstacks JAX's tree).

Expert parallelism (``plan`` a ``MeshPlan`` with an ep axis): a rank holds
E/ep experts (``moe_param_spec``, ``shard_moe_params``), attention and the
router whole. JAX's GSPMD inserts the collectives; here they are written
out with ``parallel/collectives.py``'s pair: the expert input and the
gates are a ``tp_copy`` over ep (their gradients summed over the ranks'
experts) and the combine a ``tp_sum`` over ep (each rank's experts' share,
summed in f32 before the cast, as JAX's f32 combine). The batch is cut
over (dp, fsdp), and a leaf fsdp cuts is gathered at use.

What differs from JAX:
- The aux loss's fraction routed is a mean over the global batch: under
  dp/fsdp each rank takes it summed over the batch axes (no gradient
  flows through it, as none does in JAX), and its loss carries
  E · Σ_e fraction_e · its own rows' mean prob_e, whose mean over the
  ranks is the global aux and whose gradient is the global one.
- tp does not cut the MoE leaves here: a plan with tp, sp or pp > 1
  raises ``ValueError`` (JAX's ``moe_param_spec`` cuts expert and
  attention dims over tp; the port's MoE forward has no tp sums).
- The train state is updated in place (``make_moe_train_step``'s step is
  a ``models/train.py`` ``TrainStep``, with its ``loss_and_grads``,
  ``grad_norm`` and ``apply``), as the Llama one's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn
from torch.nn import functional as F

from kubeflow_tpu_torch.models.llama import (
    _merge_heads,
    _split_heads,
    _whole,
    apply_rope,
    rms_norm,
    rope_frequencies,
)
from kubeflow_tpu_torch.ops.attention import flash_attention
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel.mesh import Placement, place, placement_of


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14336
    n_experts: int = 8
    top_k: int = 2
    aux_loss_coef: float = 0.01
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


MOE_CONFIGS = {
    "mixtral-8x7b": MoEConfig(),
    "tiny-moe": MoEConfig(
        vocab_size=512,
        dim=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=256,
        n_experts=4,
        top_k=2,
    ),
}


def _weight(shape: tuple, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MoELayer(nn.Module):
    """One layer's weights, ``(in, out)`` layout; the expert leaves carry
    the experts axis first."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        hd, e, dt = cfg.head_dim, cfg.n_experts, cfg.dtype
        self.attn_norm = _weight((cfg.dim,), dt, device)
        self.mlp_norm = _weight((cfg.dim,), dt, device)
        self.wq = _weight((cfg.dim, cfg.n_heads * hd), dt, device)
        self.wk = _weight((cfg.dim, cfg.n_kv_heads * hd), dt, device)
        self.wv = _weight((cfg.dim, cfg.n_kv_heads * hd), dt, device)
        self.wo = _weight((cfg.n_heads * hd, cfg.dim), dt, device)
        # Router in f32: tiny, and logit precision decides routing.
        self.router = _weight((cfg.dim, e), torch.float32, device)
        self.w_gate = _weight((e, cfg.dim, cfg.ffn_hidden), dt, device)
        self.w_up = _weight((e, cfg.dim, cfg.ffn_hidden), dt, device)
        self.w_down = _weight((e, cfg.ffn_hidden, cfg.dim), dt, device)


class MoE(nn.Module):
    """A whole model's weights: embedding, layers, final norm, lm head."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _weight((cfg.vocab_size, cfg.dim), cfg.dtype, device)
        self.final_norm = _weight((cfg.dim,), cfg.dtype, device)
        self.lm_head = _weight((cfg.vocab_size, cfg.dim), cfg.dtype, device)
        self.layers = nn.ModuleList(
            MoELayer(cfg, device) for _ in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# Expert-parallel placement


def moe_param_spec(path: tuple) -> tuple:
    """Sharding rules, as the port holds a leaf (one layer): experts over
    ep; within-expert dims over fsdp/tp; attention follows the llama
    rules."""
    name = "/".join(str(p) for p in path)
    if any(k in name for k in ("w_gate", "w_up")):
        return ("ep", "fsdp", "tp")  # (E, dim, hidden)
    if "w_down" in name:
        return ("ep", "tp", "fsdp")  # (E, hidden, dim)
    if "router" in name:
        return ()  # tiny; replicated
    if "embed" in name or "lm_head" in name:
        return ("tp", "fsdp")
    if any(k in name for k in ("wq", "wk", "wv")):
        return ("fsdp", "tp")
    if "wo" in name:
        return ("tp", "fsdp")
    return ()


def check_moe_plan(plan) -> None:
    """Refuse the axes the port's MoE does not cut: tp, sp and pp."""
    bad = {ax: n for ax in ("tp", "sp", "pp")
           if (n := int(plan.mesh.shape.get(ax, 1))) > 1}
    if bad:
        raise ValueError(
            f"the MoE model shards over dp, fsdp and ep; mesh {plan.axes} "
            f"also cuts {bad} (tp would need the expert and attention sums "
            "the forward does not make)")


def _placement(plan, name: str, shape: tuple) -> Placement:
    return Placement(plan.mesh, moe_param_spec(tuple(name.split("."))),
                     tuple(shape))


@torch.no_grad()
def shard_moe_params(plan, params: MoE) -> MoE:
    """Cut a whole ``MoE`` to this rank's shard IN PLACE, one leaf at a
    time, each leaf with its ``Placement`` (``moe_param_spec``); a leaf
    that already carries one stays. Returns ``params``."""
    check_moe_plan(plan)
    for name, param in params.named_parameters():
        if placement_of(param) is not None:
            continue
        pl = _placement(plan, name, tuple(param.shape))
        piece = pl.slice(param.data)
        if piece is not param.data:
            param.data = piece.clone()
        place(param, pl)
    return params


def init_params(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
                device=None, plan=None) -> MoE:
    """Random init on ``device`` (the card unless ``"cpu"``): the dense
    leaves normal · 1/sqrt(fan_in) drawn in the model dtype, the router
    normal · 0.02 in f32, norms ones. Values do not match JAX's
    ``PRNGKey`` draws (parity tests bring JAX weights over through
    ``models/bridge.py``). ``plan``: this rank's shard of the same model,
    each leaf drawn whole in the whole model's order and cut at once."""
    from kubeflow_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if plan is not None:
        check_moe_plan(plan)
    model = MoE(cfg, "meta")
    with torch.no_grad():
        for name, meta in list(model.named_parameters()):
            leaf = name.rsplit(".", 1)[-1]
            p = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
            if leaf.endswith("norm"):
                p.fill_(1.0)
            elif leaf == "router":
                p.normal_(generator=generator).mul_(0.02)
            else:
                p.normal_(generator=generator)
                p.mul_(torch.tensor(1.0 / math.sqrt(p.shape[-2]),
                                    dtype=p.dtype, device=dev))
            pl = None if plan is None else _placement(plan, name, p.shape)
            if pl is not None:
                piece = pl.slice(p)
                p = piece.clone() if piece is not p else p
            owner, attr = model, name
            if "." in name:
                path, attr = name.rsplit(".", 1)
                owner = model.get_submodule(path)
            param = nn.Parameter(p, requires_grad=False)
            setattr(owner, attr, param if pl is None else place(param, pl))
    return model


# ---------------------------------------------------------------------------
# Forward


def _ep(plan) -> tuple:
    """(ep group, ep index) of ``plan`` (None, 0 without one)."""
    if plan is None or int(plan.mesh.shape.get("ep", 1)) == 1:
        return None, 0
    return plan.mesh.group("ep"), plan.mesh.coordinate("ep")


def moe_ffn(layer: MoELayer, cfg: MoEConfig, x: torch.Tensor,
            plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN. x: (B, S, D) → (out, aux_loss).

    Dense one-hot dispatch: gates (B,S,E) select and weight experts; the
    dispatch gives (E_local, B, S, D), each of this rank's experts runs
    its SwiGLU, and the combine reduces back (summed over ep)."""
    router_logits = x.float() @ _whole(layer.router)  # (B,S,E)
    probs = torch.softmax(router_logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, cfg.top_k, dim=-1)  # (B,S,K)
    # Renormalized top-k gates, scattered back to (B,S,E).
    top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
    one_hot = F.one_hot(top_idx, cfg.n_experts).float()  # (B,S,K,E)
    gates = torch.einsum("bsk,bske->bse", top_vals, one_hot)
    mask = torch.sum(one_hot, dim=2)  # (B,S,E) in {0,1}

    # Load-balancing aux loss; the fraction routed over the global batch.
    frac_routed = torch.mean(mask, dim=(0, 1))  # (E,)
    if plan is not None and plan.n_batch > 1:
        frac_routed = collectives.psum(frac_routed,
                                       plan.batch_group) / plan.n_batch
    mean_prob = torch.mean(probs, dim=(0, 1))  # (E,)
    aux = cfg.n_experts * torch.sum(frac_routed * mean_prob)

    # Dispatch → this rank's experts' SwiGLU → combine.
    group, idx = _ep(plan)
    wg, wu, wd = (_whole(w) for w in (layer.w_gate, layer.w_up,
                                      layer.w_down))
    e_local = wg.shape[0]
    lo = idx * e_local
    xe = collectives.tp_copy(x, group)
    gates = collectives.tp_copy(gates, group)[..., lo:lo + e_local]
    sel = mask[..., lo:lo + e_local].permute(2, 0, 1)[..., None]
    xin = (xe.float()[None] * sel).to(x.dtype)  # (E_local, B, S, D)
    b, s, d = x.shape
    xin = xin.reshape(e_local, b * s, d)
    h = F.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    out_e = torch.bmm(h, wd).reshape(e_local, b, s, d)
    out = torch.einsum("ebsd,bse->bsd", out_e.float(), gates)
    return collectives.tp_sum(out, group).to(x.dtype), aux


def _layer_fwd(layer: MoELayer, cfg: MoEConfig, x, cos, sin, plan=None):
    h = rms_norm(x, layer.attn_norm, cfg.norm_eps)
    hd = cfg.head_dim
    q = apply_rope(_split_heads(h @ _whole(layer.wq), hd), cos, sin)
    k = apply_rope(_split_heads(h @ _whole(layer.wk), hd), cos, sin)
    v = _split_heads(h @ _whole(layer.wv), hd)
    attn = flash_attention(q, k, v, causal=True)  # GQA folded in the kernel
    x = x + _merge_heads(attn) @ _whole(layer.wo)
    h = rms_norm(x, layer.mlp_norm, cfg.norm_eps)
    ffn_out, aux = moe_ffn(layer, cfg, h, plan)
    return x + ffn_out, aux


def forward(params: MoE, cfg: MoEConfig, tokens: torch.Tensor, plan=None):
    """(logits (B,S,V) f32, mean aux loss). ``plan``: the mesh a sharded
    model runs over (its ep group, and the batch group the aux loss's
    fraction routed is summed over)."""
    x = _whole(params.embed)[tokens]
    cos, sin = rope_frequencies(
        cfg, torch.arange(tokens.shape[1], device=tokens.device))
    auxes = []
    for layer in params.layers:
        x, aux = _layer_fwd(layer, cfg, x, cos, sin, plan)
        auxes.append(aux)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ _whole(params.lm_head).T).float()
    return logits, torch.mean(torch.stack(auxes))


# ---------------------------------------------------------------------------
# Expert-parallel training


def make_moe_train_step(cfg: MoEConfig, plan=None, optimizer=None):
    """(init_state, step, shard_state) over ``plan``'s mesh with ep expert
    sharding (``plan`` None: one device).

    ``init_state(params)`` turns the grads on and allocates AdamW (JAX's
    ``optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)`` unless
    ``optimizer`` is given); ``shard_state(state)`` cuts the params and
    moments to this rank's pieces (``moe_param_spec``), in place;
    ``step(state, tokens)`` takes the global batch (each rank its (dp,
    fsdp) rows), the loss mean NLL + ``aux_loss_coef`` · aux, and one
    update, returning ``(state, loss)``."""
    from kubeflow_tpu_torch.models.train import (
        TrainStep,
        _mesh_plan,
        make_optimizer,
        place_moments,
    )

    plan = _mesh_plan(plan)
    if plan is not None:
        check_moe_plan(plan)
    optimizer = optimizer or make_optimizer()

    class MoEStep(TrainStep):
        def loss_fn(self, params, tokens, seq=None):
            logits, aux = forward(params, cfg, tokens, self.plan)
            targets = tokens[:, 1:].long()
            logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
            nll = -torch.gather(logprobs, -1, targets[..., None])[..., 0]
            return torch.mean(nll) + cfg.aux_loss_coef * aux

    def init_state(params: MoE) -> dict:
        params.requires_grad_(True)
        return {"params": params, "opt_state": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int64)}

    def shard_state(state: dict) -> dict:
        shard_moe_params(plan, state["params"])
        place_moments(state["opt_state"])
        return state

    step = MoEStep(cfg, plan, optimizer, grad_accum=1, loss_chunk=0,
                   remat="none", fp8=False)
    return init_state, step, shard_state
