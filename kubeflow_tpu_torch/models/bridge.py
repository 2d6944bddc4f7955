"""Weight bridge between the JAX package's parameter tree and ``Llama``.

The JAX tree is a dict of arrays with every layer leaf STACKED on a
leading ``n_layers`` axis (it feeds ``lax.scan``); the port holds one
``LlamaLayer`` module per layer. Both keep the ``(in, out)`` weight
layout, so the bridge only unstacks and restacks — it never transposes.

The bridge takes and returns plain numpy arrays, so it imports no JAX.
bf16 leaves arrive as numpy arrays whose dtype is named ``bfloat16`` (an
extension dtype numpy itself lacks); they cross as raw 16-bit words —
``.view(np.uint16)`` on one side, ``.view(torch.bfloat16)`` on the
other — so no bf16 conversion library is needed and every bit survives.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig

_LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                 "w_gate", "w_up", "w_down", "bq", "bk", "bv")
_TOP_LEAVES = ("embed", "final_norm", "lm_head")


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    # A copy: JAX hands out read-only numpy views.
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor, like: np.ndarray = None) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy().view(np.uint16)
        # Without a bf16 template the words come back as uint16.
        return words if like is None else words.view(like.dtype)
    return t.numpy()


def params_from_jax(tree: dict, cfg: LlamaConfig, device=None) -> Llama:
    """A JAX ``init_params``-shaped tree of numpy arrays → ``Llama`` on
    ``device``. Raises on a leaf whose shape or dtype the config does not
    expect, or on a leaf the model has no place for."""
    dev = resolve_device(device)
    model = Llama(cfg, dev)
    unknown = set(tree) - set(_TOP_LEAVES) - {"layers"}
    unknown |= set(tree["layers"]) - set(_LAYER_LEAVES)
    if unknown:
        raise ValueError(f"unexpected parameter leaves: {sorted(unknown)}")

    def put(param, arr, name):
        src = _to_torch(arr)
        if tuple(src.shape) != tuple(param.shape) or src.dtype != param.dtype:
            raise ValueError(
                f"{name}: got {tuple(src.shape)} {src.dtype}, model wants "
                f"{tuple(param.shape)} {param.dtype}"
            )
        with torch.no_grad():
            param.copy_(src)

    for name in _TOP_LEAVES:
        param = getattr(model, name)
        if (param is None) != (name not in tree):
            raise ValueError(f"leaf {name!r} does not match the config")
        if param is not None:
            put(param, tree[name], name)
    for name in _LAYER_LEAVES:
        stacked = tree["layers"].get(name)
        if (getattr(model.layers[0], name) is None) != (stacked is None):
            raise ValueError(f"layer leaf {name!r} does not match the config")
        if stacked is None:
            continue
        if len(stacked) != cfg.n_layers:
            raise ValueError(
                f"layers/{name}: {len(stacked)} stacked layers, config has "
                f"{cfg.n_layers}"
            )
        for i, layer in enumerate(model.layers):
            put(getattr(layer, name), stacked[i], f"layers/{name}[{i}]")
    return model


def params_to_numpy(model: Llama, like: dict = None) -> dict:
    """Inverse of ``params_from_jax``: the stacked JAX-shaped tree as
    numpy arrays. bf16 leaves take ``like``'s numpy dtype (a JAX tree
    brought to numpy) where given, else they come back as uint16 words."""
    like = like or {}
    like_layers = like.get("layers", {})
    out: dict = {}
    for name in _TOP_LEAVES:
        param = getattr(model, name)
        if param is not None:
            out[name] = _to_numpy(param, like.get(name))
    layers: dict = {}
    for name in _LAYER_LEAVES:
        if getattr(model.layers[0], name) is None:
            continue
        ref = like_layers.get(name)
        layers[name] = np.stack([
            _to_numpy(getattr(layer, name), ref) for layer in model.layers
        ])
    out["layers"] = layers
    return out
