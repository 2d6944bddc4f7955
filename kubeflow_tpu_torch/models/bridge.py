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

Quantized leaves (``models/quant.py``) are ``{"q", "s"}`` dicts: a
stacked layer leaf ``q`` (L, in, out) with ``s`` (L, 1, out) or, int4,
(L, in/group, out); the lm head ``q`` (V, D) with ``s`` (V, 1) or
(V, D/group). ``q`` is int8, ``float8_e4m3fn`` (crossing as its bytes) or
int4 (a dtype named ``int4``, read with ``astype(np.int8)`` and packed two
a byte); each becomes a ``QuantizedWeight``. ``params_to_numpy`` gives
them back byte for byte, int4 unpacked and cast to the ``like`` leaf's
dtype.

fp8-training leaves (``models/fp8.py``'s ``wrap_params_fp8``) are
``{"hp": (L, in, out), "fp8": {"x_hist", "w_hist", "g_hist": (L, H)}}``:
the master stacked as any layer leaf and each history stacked per layer;
each layer's slice becomes an ``Fp8Weight`` and comes back stacked, so a
train state crosses both ways.

The MoE tree (``models/moe.py``) crosses the same way: ``moe_from_jax``
unstacks each layer leaf, the expert leaves ``(L, E, …)`` to one
``(E, …)`` a layer and the f32 router ``(L, dim, E)`` to ``(dim, E)``.

LoRA adapters (``models/lora.py``) keep JAX's tree as it is, a dict of
``{"a", "b"}`` per target: ``lora_from_jax``/``lora_to_numpy`` move one
adapter, ``stacked_from_jax`` a ``stack_adapters`` tree, leaf by leaf and
byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.fp8 import _META, Fp8Weight
from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig
from kubeflow_tpu_torch.models.quant import QuantizedWeight, _set
from kubeflow_tpu_torch.ops.quant_matmul import pack_int4

_LAYER_LEAVES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                 "w_gate", "w_up", "w_down", "bq", "bk", "bv")
_TOP_LEAVES = ("embed", "final_norm", "lm_head")


_SCHEME_OF = {"int8": "int8", "float8_e4m3fn": "fp8", "int4": "int4"}


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    # A copy: JAX hands out read-only numpy views.
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    if arr.dtype.name == "int4":
        return torch.from_numpy(arr.astype(np.int8))
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor, like: np.ndarray = None) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        words = t.view(torch.int16 if t.dtype == torch.bfloat16
                       else torch.uint8).numpy()
        words = words.view(np.uint16) if t.dtype == torch.bfloat16 else words
        # Without a template the raw words come back (uint16, uint8).
        return words if like is None else words.view(like.dtype)
    if like is not None and like.dtype.name == "int4":
        return t.numpy().astype(like.dtype)
    return t.numpy()


def _quantized(leaf: dict, like: torch.Tensor, axis: int, device,
               name: str) -> QuantizedWeight:
    """One layer's (or the head's) ``{"q", "s"}`` leaf as a
    ``QuantizedWeight`` in place of ``like``, shape-checked."""
    if set(leaf) != {"q", "s"}:
        raise ValueError(f"{name}: a quantized leaf holds q and s, got "
                         f"{sorted(leaf)}")
    scheme = _SCHEME_OF.get(np.asarray(leaf["q"]).dtype.name)
    q, s = _to_torch(leaf["q"]), _to_torch(leaf["s"])
    if scheme is None or s.dtype != torch.float32:
        raise ValueError(f"{name}: q {np.asarray(leaf['q']).dtype} / s "
                         f"{s.dtype} is no quantized weight")
    if tuple(q.shape) != tuple(like.shape):
        raise ValueError(f"{name}: got {tuple(q.shape)}, model wants "
                         f"{tuple(like.shape)}")
    if scheme == "int4":
        q = pack_int4(q)
    return QuantizedWeight(q.to(device), s.to(device), scheme, axis,
                           like.shape)


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

    def put(owner, attr, arr, name, axis):
        param = getattr(owner, attr)
        if isinstance(arr, dict) and "hp" in arr:
            if set(arr) != {"hp", "fp8"} or set(arr["fp8"]) != set(_META):
                raise ValueError(f"{name}: an fp8 leaf holds hp and fp8 "
                                 f"{_META}, got {sorted(arr)}")
            put(owner, attr, arr["hp"], f"{name}/hp", axis)
            meta = {h: _to_torch(arr["fp8"][h]).to(dev) for h in _META}
            if any(m.dtype != torch.float32 or m.dim() != 1
                   for m in meta.values()):
                raise ValueError(f"{name}/fp8: histories must be 1-D f32")
            _set(owner, attr, Fp8Weight(getattr(owner, attr), meta))
            return
        if isinstance(arr, dict):
            _set(owner, attr, _quantized(arr, param, axis, dev, name))
            return
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
            put(model, name, tree[name], name, 1)
    for name in _LAYER_LEAVES:
        stacked = tree["layers"].get(name)
        if (getattr(model.layers[0], name) is None) != (stacked is None):
            raise ValueError(f"layer leaf {name!r} does not match the config")
        if stacked is None:
            continue
        if isinstance(stacked, dict) and "hp" in stacked:
            count = len(stacked["hp"])
            parts = [len(h) for h in stacked["fp8"].values()]
        elif isinstance(stacked, dict):
            count, parts = len(stacked["q"]), [len(stacked["s"])]
        else:
            count, parts = len(stacked), []
        if count != cfg.n_layers or any(n != count for n in parts):
            raise ValueError(
                f"layers/{name}: {count} stacked layers, config has "
                f"{cfg.n_layers}"
            )
        for i, layer in enumerate(model.layers):
            arr = _layer_slice(stacked, i)
            put(layer, name, arr, f"layers/{name}[{i}]", 0)
    return model


def _layer_slice(stacked, i: int):
    """Layer ``i`` of a stacked leaf, a dict leaf sliced leaf by leaf."""
    if isinstance(stacked, dict):
        return {k: _layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _stacked(per_layer: list):
    """Inverse of ``_layer_slice``: per-layer leaves stacked on axis 0."""
    if isinstance(per_layer[0], dict):
        return {k: _stacked([p[k] for p in per_layer]) for k in per_layer[0]}
    return np.stack(per_layer)


def params_to_numpy(model: Llama, like: dict = None) -> dict:
    """Inverse of ``params_from_jax``: the stacked JAX-shaped tree as
    numpy arrays. bf16 leaves take ``like``'s numpy dtype (a JAX tree
    brought to numpy) where given, else they come back as uint16 words."""
    like = like or {}
    like_layers = like.get("layers", {})

    def leaf(w, ref):
        if isinstance(w, Fp8Weight):
            ref = ref or {}
            return {"hp": _to_numpy(w.hp, ref.get("hp")),
                    "fp8": {h: _to_numpy(m) for h, m in w.meta().items()}}
        if not isinstance(w, QuantizedWeight):
            return _to_numpy(w, ref)
        ref = ref or {}
        return {"q": _to_numpy(w.values(), ref.get("q")),
                "s": _to_numpy(w.s, ref.get("s"))}

    out: dict = {}
    for name in _TOP_LEAVES:
        param = getattr(model, name)
        if param is not None:
            out[name] = leaf(param, like.get(name))
    layers: dict = {}
    for name in _LAYER_LEAVES:
        if getattr(model.layers[0], name) is None:
            continue
        ref = like_layers.get(name)
        layers[name] = _stacked([leaf(getattr(layer, name), ref)
                                 for layer in model.layers])
    out["layers"] = layers
    return out


def _adapter_tree(tree: dict, rank: int, device, convert) -> dict:
    """Check a LoRA tree's structure ({target: {"a", "b"}} with leaves of
    ``rank`` dims) and map ``convert`` over its leaves."""
    from kubeflow_tpu_torch.models.lora import _ADAPTABLE

    unknown = set(tree) - set(_ADAPTABLE)
    if unknown:
        raise ValueError(f"unknown LoRA targets {sorted(unknown)}; valid: "
                         f"{_ADAPTABLE}")
    out = {}
    for target, ab in tree.items():
        if set(ab) != {"a", "b"}:
            raise ValueError(f"{target}: an adapter holds a and b, got "
                             f"{sorted(ab)}")
        for side in ("a", "b"):
            if np.ndim(ab[side]) != rank:
                raise ValueError(
                    f"{target}/{side}: {np.ndim(ab[side])} dims, want {rank}")
        out[target] = {side: convert(ab[side]) for side in ("a", "b")}
    return out


def lora_from_jax(tree: dict, device=None) -> dict:
    """One JAX adapter tree of numpy leaves ({target: {"a": (L, in, r),
    "b": (L, r, out)}}) → the same tree of tensors on ``device``, byte for
    byte (bf16 as its 16-bit words)."""
    dev = resolve_device(device)
    return _adapter_tree(tree, 3, dev, lambda a: _to_torch(a).to(dev))


def lora_to_numpy(lora: dict, like: dict = None) -> dict:
    """Inverse of ``lora_from_jax`` (and of ``stacked_from_jax``): bf16
    leaves take ``like``'s numpy dtype where given, else come back as
    uint16 words."""
    like = like or {}
    return {t: {side: _to_numpy(ab[side], like.get(t, {}).get(side))
                for side in ("a", "b")}
            for t, ab in lora.items()}


def stacked_from_jax(tree: dict, device=None) -> dict:
    """A JAX ``stack_adapters`` tree of numpy leaves ({target: {"a":
    (N+1, L, in, r), "b": (N+1, L, r, out)}}, the zero base row last) →
    the same tree of tensors on ``device``, byte for byte."""
    dev = resolve_device(device)
    return _adapter_tree(tree, 4, dev, lambda a: _to_torch(a).to(dev))


def moe_from_jax(tree: dict, cfg, device=None):
    """A JAX ``models/moe.py`` ``init_params`` tree of numpy arrays →
    ``MoE`` on ``device``, leaf by leaf and byte for byte. Raises on a
    leaf whose shape or dtype the config does not expect, or on a leaf
    the model has no place for."""
    from kubeflow_tpu_torch.models.moe import MoE

    dev = resolve_device(device)
    model = MoE(cfg, dev)
    want = {name for name, _ in model.layers[0].named_parameters()}
    unknown = (set(tree) - {"embed", "final_norm", "lm_head", "layers"}) | (
        set(tree["layers"]) ^ want)
    if unknown:
        raise ValueError(f"unexpected or missing leaves: {sorted(unknown)}")

    def put(param, arr, name):
        src = _to_torch(arr)
        if tuple(src.shape) != tuple(param.shape) or src.dtype != param.dtype:
            raise ValueError(
                f"{name}: got {tuple(src.shape)} {src.dtype}, model wants "
                f"{tuple(param.shape)} {param.dtype}")
        with torch.no_grad():
            param.copy_(src)

    for name in ("embed", "final_norm", "lm_head"):
        put(getattr(model, name), tree[name], name)
    for name, stacked in tree["layers"].items():
        if len(stacked) != cfg.n_layers:
            raise ValueError(f"layers/{name}: {len(stacked)} stacked layers, "
                             f"config has {cfg.n_layers}")
        for i, layer in enumerate(model.layers):
            put(getattr(layer, name), stacked[i], f"layers/{name}[{i}]")
    return model
