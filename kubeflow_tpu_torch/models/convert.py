"""Hugging Face checkpoints for the port's Llama family.

Counterpart of ``kubeflow_tpu/models/convert.py``: ``config_from_hf`` maps
a ``config.json`` (or a transformers config object) to ``LlamaConfig``;
``params_from_hf_state_dict`` turns an HF ``*ForCausalLM`` state dict into
a ``Llama`` module and ``params_to_hf_state_dict`` goes back;
``load_hf_checkpoint`` reads a checkpoint directory.

Layout: HF's ``nn.Linear.weight`` is ``(out, in)`` and the port's
projections are ``(in, out)``, so every projection is transposed once at
load time (on the device, after the copy); norms, biases, the embedding
and ``lm_head.weight`` (``(vocab, dim)`` on both sides) are taken as they
are. transformers keeps q/k in the rotate-half RoPE order that
``models/llama.py`` uses, so no head permutation is needed. Tied
checkpoints (``tie_word_embeddings``) carry no ``lm_head.weight`` and the
model has no ``lm_head``. Exports that prefix every key but ``lm_head``
with ``model.`` load as well as unprefixed ones.

``load_hf_checkpoint`` reads the safetensors format itself (an 8-byte
little-endian header length, a JSON header with each tensor's dtype,
shape and byte offsets, then the raw bytes), so the port needs neither
the ``safetensors`` package nor a bfloat16 extension for numpy. Each
tensor is memory-mapped alone, viewed in place with ``torch.frombuffer``,
copied to the device in its stored dtype, converted and transposed
there, and unmapped before the next one: the host never holds more than
a tensor's worth of the checkpoint, and bf16 weights never pass through
f32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import pathlib
import struct
from typing import Any, Mapping, Optional

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.bridge import _to_torch
from kubeflow_tpu_torch.models.llama import Llama, LlamaConfig, RopeScaling
from kubeflow_tpu_torch.models.quant import QuantizedWeight


def _rope_scaling_from_hf(raw: Any) -> Optional[RopeScaling]:
    """Map HF's rope_scaling block; raise rather than drop it: ignoring
    Llama-3.1's "llama3" schedule would load cleanly and generate garbage
    past the scaling regime."""
    if raw is None:
        return None
    if not isinstance(raw, Mapping):
        raw = dict(raw)
    kind = raw.get("rope_type", raw.get("type", "default"))
    if kind == "default":
        return None
    if kind == "llama3":
        return RopeScaling(
            factor=float(raw["factor"]),
            low_freq_factor=float(raw["low_freq_factor"]),
            high_freq_factor=float(raw["high_freq_factor"]),
            original_max_position_embeddings=int(
                raw["original_max_position_embeddings"]
            ),
        )
    raise NotImplementedError(
        f"rope_scaling type {kind!r} is not supported (have: llama3); "
        "loading would produce wrong positions silently"
    )


def _sliding_window_from_hf(get, model_type: str) -> int:
    """Mistral windows every layer. Qwen2 windows only layers >=
    max_window_layers when use_sliding_window is set, so with HF's default
    max_window_layers == n_layers NO layer is windowed; a split between
    windowed and full layers is refused."""
    if model_type == "mistral":
        return int(get("sliding_window") or 0)
    if model_type == "qwen2" and get("use_sliding_window", False):
        n_layers = get("num_hidden_layers")
        cutoff = get("max_window_layers", n_layers)
        if cutoff >= n_layers:
            return 0  # HF applies the window to no layer
        if cutoff == 0:
            return int(get("sliding_window") or 0)  # every layer windowed
        raise NotImplementedError(
            f"qwen2 max_window_layers={cutoff} < num_hidden_layers="
            f"{n_layers}: per-layer sliding-window splits are not "
            "supported (all-or-nothing only)"
        )
    return 0


def config_from_hf(hf_config: Any) -> LlamaConfig:
    """A transformers config (object or ``config.json`` dict) →
    ``LlamaConfig``: llama (with llama3 rope scaling), mistral (sliding
    window), gemma (GeGLU, 1 + w norms, scaled and tied embeddings, its
    own head dim) and qwen2 (q/k/v biases). The dtype stays bf16."""
    get = (
        hf_config.get
        if isinstance(hf_config, Mapping)
        else lambda k, d=None: getattr(hf_config, k, d)
    )
    model_type = get("model_type", "llama") or "llama"
    if model_type not in ("llama", "mistral", "gemma", "qwen2"):
        raise NotImplementedError(
            f"model_type {model_type!r} is not in the supported Llama "
            "family (llama, mistral, gemma, qwen2)"
        )
    n_heads = get("num_attention_heads")
    default_head_dim = get("hidden_size") // n_heads
    act = get("hidden_activation") or get("hidden_act") or "silu"
    is_gemma = model_type == "gemma"
    return LlamaConfig(
        vocab_size=get("vocab_size"),
        dim=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=n_heads,
        n_kv_heads=get("num_key_value_heads", n_heads) or n_heads,
        ffn_hidden=get("intermediate_size"),
        rope_theta=float(get("rope_theta", 10000.0)),
        rope_scaling=_rope_scaling_from_hf(get("rope_scaling")),
        max_seq_len=get("max_position_embeddings", 4096),
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        sliding_window=_sliding_window_from_hf(get, model_type),
        act="gelu" if act.startswith("gelu") else "silu",
        norm_add_unit=is_gemma,
        embed_scale=is_gemma,
        head_dim_override=(
            hd if (hd := get("head_dim", 0) or 0) != default_head_dim else 0
        ),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        attn_bias=model_type == "qwen2",
    )


# Each layer leaf: (the port's name, HF's name under layers.{i}., is it a
# projection to transpose). The order is the JAX loader's, so the first
# missing tensor named in an error is the one it names.
_LAYER_LEAVES = (
    ("attn_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("mlp_norm", "post_attention_layernorm.weight", False),
    ("w_gate", "mlp.gate_proj.weight", True),
    ("w_up", "mlp.up_proj.weight", True),
    ("w_down", "mlp.down_proj.weight", True),
)
_BIAS_LEAVES = (
    ("bq", "self_attn.q_proj.bias", False),
    ("bk", "self_attn.k_proj.bias", False),
    ("bv", "self_attn.v_proj.bias", False),
)


def _plan(cfg: LlamaConfig, prefix: str) -> list[tuple]:
    """(HF key, (layer index or None, the port's leaf), transpose) for
    every leaf the config has, in the JAX loader's order."""
    out = []
    for ours, theirs, linear in _LAYER_LEAVES + (
            _BIAS_LEAVES if cfg.attn_bias else ()):
        out += [(f"{prefix}layers.{i}.{theirs}", (i, ours), linear)
                for i in range(cfg.n_layers)]
    out.append((f"{prefix}embed_tokens.weight", (None, "embed"), False))
    out.append((f"{prefix}norm.weight", (None, "final_norm"), False))
    if not cfg.tie_embeddings:
        # Tied configs carry no lm_head; untied checkpoints must have it.
        out.append(("lm_head.weight", (None, "lm_head"), False))
    return out


def _prefix(keys) -> str:
    # Some exports prefix everything with "model." except lm_head.
    return "model." if any(k.startswith("model.") for k in keys) else ""


def _check_keys(plan: list[tuple], have: Mapping) -> None:
    for key, _, _ in plan:
        if key not in have:
            raise KeyError(
                f"checkpoint is missing '{key}' "
                f"(have {len(have)} tensors; is this a Llama-family export?)"
            )


def _put(model: Llama, leaf: tuple, src: torch.Tensor, linear: bool,
         key: str, plan=None, whole: Optional[tuple] = None) -> None:
    """Copy ``src`` (HF layout, any device) into the model's leaf: to the
    model's device in its own dtype first, then converted and, for a
    projection, transposed there. Under a tp ``plan`` the model is a
    rank's shard and ``whole`` the leaf's unsharded shape: ``src`` is cut
    to the rank's slice before the copy, so only the slice moves."""
    layer, name = leaf
    param = getattr(model if layer is None else model.layers[layer], name)
    shape = tuple(param.shape) if whole is None else whole
    want = shape[::-1] if linear else shape
    if tuple(src.shape) != want:
        raise ValueError(f"{key}: got shape {tuple(src.shape)}, the config "
                         f"wants {want}")
    if plan is not None:
        src = plan.shard_leaf(name, src, transposed=linear)
    src = src.to(param.device)
    with torch.no_grad():
        param.copy_(src.T if linear else src)


def _as_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return _to_torch(np.asarray(value))


def _with_dtype(cfg: LlamaConfig, dtype) -> LlamaConfig:
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def params_from_hf_state_dict(cfg: LlamaConfig, state_dict: Mapping[str, Any],
                              dtype: Optional[torch.dtype] = None,
                              device=None) -> Llama:
    """HF state dict (torch tensors, or numpy arrays) → ``Llama`` on
    ``device`` (the card unless ``"cpu"`` is asked for). ``dtype``
    defaults to ``cfg.dtype``; the returned model's ``cfg`` carries it.
    Raises ``KeyError`` naming the first missing tensor, ``ValueError`` on
    a tensor of the wrong shape."""
    dev = resolve_device(device)
    cfg = _with_dtype(cfg, dtype)
    sd = dict(state_dict)
    plan = _plan(cfg, _prefix(sd))
    _check_keys(plan, sd)
    model = Llama(cfg, dev)
    for key, leaf, linear in plan:
        _put(model, leaf, _as_tensor(sd[key]), linear, key)
    return model


def params_to_hf_state_dict(cfg: LlamaConfig, params: Llama) -> dict:
    """Inverse of ``params_from_hf_state_dict``: HF's ``model.``-prefixed
    names and ``(out, in)`` layout. The values are views of the model's
    weights, on its device and in its dtype (the JAX function returns f32
    numpy copies); ``.contiguous()`` one at a time to write them. Quantized
    weights have no HF layout and raise ``TypeError``."""
    out = {}
    for key, (layer, name), linear in _plan(cfg, "model."):
        w = getattr(params if layer is None else params.layers[layer], name)
        if isinstance(w, QuantizedWeight):
            raise TypeError(f"{key}: a quantized weight has no HF layout; "
                            "export the model before quantize_params")
        w = w.detach()
        out[key] = w.T if linear else w
    return out


# safetensors dtype names the reader takes; any other raises naming it.
_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16}
_MAX_HEADER_BYTES = 100 << 20


def _read_header(path: pathlib.Path) -> tuple[int, int, dict]:
    """(the file's size, the byte offset of its data section, {key: header
    entry})."""
    size = path.stat().st_size
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter "
                             "than its 8-byte header length)")
        (n,) = struct.unpack("<Q", raw)
        if n > min(_MAX_HEADER_BYTES, size - 8):
            raise ValueError(f"{path}: header length {n} does not fit the "
                             f"file ({size} bytes)")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return size, 8 + n, header


def _entry(path: pathlib.Path, size: int, base: int, key: str,
           entry: dict) -> tuple[torch.dtype, tuple, int, int]:
    """Check one header entry: (dtype, shape, byte offset, byte count)."""
    dtype = _ST_DTYPES.get(entry.get("dtype"))
    if dtype is None:
        raise ValueError(
            f"{path}: tensor {key!r} has dtype {entry.get('dtype')!r}; the "
            f"reader takes {', '.join(_ST_DTYPES)}")
    shape = tuple(int(d) for d in entry["shape"])
    begin, end = (int(x) for x in entry["data_offsets"])
    nbytes = math.prod(shape) * dtype.itemsize
    if end - begin != nbytes or begin < 0 or base + end > size:
        raise ValueError(
            f"{path}: tensor {key!r} spans bytes [{begin}, {end}) of the "
            f"data section, which does not hold {shape} {entry['dtype']}")
    return dtype, shape, base + begin, nbytes


def load_hf_checkpoint(path, dtype: Optional[torch.dtype] = None,
                       device=None, plan=None) -> tuple[LlamaConfig, Llama]:
    """(config, model) from an HF checkpoint directory: ``config.json``
    and every ``*.safetensors`` shard, F32, F16 or BF16 (a later shard's
    tensor wins over an earlier one of the same name, tensors the model
    does not take are skipped). The model lands on ``device`` (the card
    unless ``"cpu"`` is asked for) in ``dtype`` (default bf16), and the
    returned config carries that dtype. ``plan`` (a tp MeshPlan,
    ``parallel/mesh.py``) loads this rank's shard alone: each tensor is
    cut to the rank's slice as it is read, so a rank's device never holds
    the whole model (the values are ``shard_params`` of the whole load)."""
    path = pathlib.Path(path)
    cfg = config_from_hf(json.loads((path / "config.json").read_text()))
    shards = sorted(path.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    dev = resolve_device(device)
    cfg = _with_dtype(cfg, dtype)
    index = {}
    for shard in shards:
        size, base, header = _read_header(shard)
        for key, entry in header.items():
            index[key] = (shard, size, base, entry)
    leaves = _plan(cfg, _prefix(index))
    _check_keys(leaves, index)
    whole: dict = {}
    if plan is None:
        model = Llama(cfg, dev)
    else:
        plan.check_serving()
        model = Llama(plan.shard_config(cfg), dev)
        model.cfg = cfg
        whole = {name: tuple(p.shape)
                 for name, p in Llama(cfg, "meta").named_parameters()}
    todo: dict[pathlib.Path, list] = {}
    for key, leaf, linear in leaves:
        shard, size, base, entry = index[key]
        todo.setdefault(shard, []).append(
            (_entry(shard, size, base, key, entry), key, leaf, linear))
    grain = mmap.ALLOCATIONGRANULARITY
    for shard, items in todo.items():
        with open(shard, "rb") as f:
            # In file order, so the reads stream through the shard. Each
            # tensor is mapped alone and unmapped once its copy has
            # landed: the host holds one tensor's pages at a time.
            for (dt, shape, offset, nbytes), key, leaf, linear in sorted(
                    items, key=lambda item: item[0][2]):
                start = offset // grain * grain
                with mmap.mmap(f.fileno(), offset + nbytes - start,
                               access=mmap.ACCESS_COPY, offset=start) as mm:
                    src = torch.frombuffer(mm, dtype=dt,
                                           count=math.prod(shape),
                                           offset=offset - start).view(shape)
                    layer, name = leaf
                    _put(model, leaf, src, linear, key, plan, whole.get(
                        name if layer is None else f"layers.{layer}.{name}"))
                    del src
    if plan is not None:
        plan.mark(model)
    return cfg, model
