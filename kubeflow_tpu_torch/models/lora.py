"""LoRA adapters for the Llama family: the serving half.

Counterpart of ``kubeflow_tpu/models/lora.py`` up to its train step. An
adapter keeps the JAX tree's layout, one dict per target weight with the
layer axis stacked first: for a target W (in, out) of every layer,
``{"a": (L, in, r), "b": (L, r, out)}``, and W' = W + (alpha/r) · a@b.
``merge_lora`` folds an adapter into a new ``Llama`` that shares every
other weight; ``models/multilora.py`` serves many adapters over one base
instead.

Not here yet: ``make_lora_train_step``, the LoRA finetune (ROADMAP queue
1 item 12).
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


@torch.no_grad()
def merge_lora(params: Llama, lora: dict, lcfg: LoraConfig) -> Llama:
    """Base params + scaled adapter deltas → a new ``Llama`` (every entry
    point works unchanged) that shares each weight the adapter does not
    touch with ``params``. Each merged weight is summed in f32 (a@b
    accumulated in f32, as JAX's ``preferred_element_type``) and cast back
    to the weight's dtype, one layer at a time."""
    quantized = [name for name, mod in params.named_modules()
                 if isinstance(mod, QuantizedWeight)]
    if quantized:
        raise ValueError(
            f"merge_lora needs dense weights; quantized: {quantized[:3]}"
        )
    out = Llama(params.cfg, device="meta")
    for name, p in params.named_parameters():
        _set(out, name, p)
    for target, ab in lora.items():
        for i, layer in enumerate(params.layers):
            w = getattr(layer, target)
            delta = (ab["a"][i].float() @ ab["b"][i].float()) * lcfg.scaling
            merged = (w.float() + delta).to(w.dtype)
            _set(out.layers[i], target,
                 nn.Parameter(merged, requires_grad=False))
    return out


def lora_param_count(cfg: LlamaConfig, lcfg: LoraConfig) -> int:
    shapes = _target_shapes(cfg)
    return sum(
        cfg.n_layers * lcfg.rank * (shapes[t][0] + shapes[t][1])
        for t in lcfg.targets
    )
