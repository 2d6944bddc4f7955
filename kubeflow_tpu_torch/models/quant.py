"""Weight-only int8 / int4 / fp8 quantization for the Llama family.

Counterpart of ``kubeflow_tpu/models/quant.py``. Decode reads every
projection once a step, so storing them in fewer bits cuts the bytes a
step reads. Two schemes, plus fp8 (``models/fp8.py``):
- **int8, per output channel**: scale = max|w| / 127 over the contraction
  axis, applied to the product's output;
- **int4, group-wise**: one scale per ``group`` contraction values of each
  output channel (max|w| / 7), applied to the weight operand.

A quantized projection is a ``QuantizedWeight``: a small ``nn.Module``
with buffers ``q`` and ``s`` that takes the place of the ``nn.Parameter``
on ``LlamaLayer`` (``(in, out)``, contraction axis 0: ``q`` (in, out),
``s`` (1, out) f32, int4 ``s`` (in/group, out)) or of ``Llama.lm_head``
(``(V, D)``, axis 1: ``s`` (V, 1), int4 (V, D/group)). int4 values are
packed two to a byte into ``uint8`` along the stored tensor's last axis,
the even index in the low nibble (``ops/quant_matmul.pack_int4``), so the
4× fewer bytes are real. Embeddings stay in the model dtype (a gather,
read once a token), and tied configs, which have no ``lm_head``, keep the
embedding as their head, as in JAX.

The arithmetic is the JAX function's, op for op, and the values and scales
agree byte for byte: f32 upcast, ``max(amax, 1e-8)`` times the f32
reciprocal of 127 (7, E4M3_MAX) — XLA turns that division by a constant
into a multiplication, so the port multiplies too — the weight divided by
its scale, rounded half to even, clipped, cast.

``llama._mm`` and ``llama._lm_head_logits`` take a ``QuantizedWeight``
through ``matmul``: on the card the hand-written kernel of
``ops/quant_matmul.py`` up to ``MAX_ROWS`` rows, the dequantized
``torch.matmul`` above; on the CPU the plain version.
"""

from __future__ import annotations

import itertools
import os

import torch
from torch import nn

from kubeflow_tpu_torch.ops.quant_matmul import (
    MAX_ROWS,
    KernelPlan,
    dequantize,
    kernel_plan,
    pack_int4,
    quant_matmul,
    quant_matmul_wide,
    unpack_int4,
)

# Per-layer (in, out) projections; the (V, D) lm_head is the other target.
_LAYER_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
# The notebook runtime option, as the webhook projects it (the JAX
# package's ``api/annotations.py`` QUANT_ENV_NAME).
QUANT_ENV_NAME = "KUBEFLOW_TPU_QUANT"


class QuantizedWeight(nn.Module):
    """A weight stored quantized: buffers ``q`` (int8, ``float8_e4m3fn``,
    or packed int4 ``uint8``) and ``s`` (f32 scales). ``scheme`` is
    "int8", "int4" or "fp8", ``axis`` the contraction axis (0 for a layer
    weight, 1 for the lm head) and ``shape`` the weight's unpacked shape.
    On the card it keeps the kernel's checked launch arguments
    (``plan``), made on first use and dropped whenever ``q`` or ``s`` is
    replaced or moved."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, scheme: str,
                 axis: int, shape) -> None:
        super().__init__()
        self._plan = None
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.scheme = scheme
        self.axis = axis
        self.shape = torch.Size(shape)

    def __setattr__(self, name, value) -> None:
        if name in ("q", "s"):
            self._plan = None
        super().__setattr__(name, value)

    def _apply(self, fn, recurse=True):
        # .to(), .cuda() and the like put new tensors in the buffers.
        self._plan = None
        return super()._apply(fn, recurse)

    def plan(self) -> KernelPlan:
        """``kernel_plan`` of ``q`` and ``s`` as they stand, made once."""
        if self._plan is None:
            self._plan = kernel_plan(self.q, self.s, self.scheme,
                                     self.axis == 1)
        return self._plan

    def values(self) -> torch.Tensor:
        """The stored values, unpacked (int4 as int8)."""
        return unpack_int4(self.q) if self.scheme == "int4" else self.q


def _scale(amax: torch.Tensor, levels: float) -> torch.Tensor:
    """``max(amax, 1e-8) / levels`` as XLA computes it: times the f32
    reciprocal of ``levels``."""
    recip = torch.ones((), dtype=torch.float32, device=amax.device) / levels
    return torch.clamp_min(amax, 1e-8) * recip


def quantize_weight(w: torch.Tensor, axis: int) -> QuantizedWeight:
    """Symmetric per-channel int8: scale = max|w| / 127 over ``axis`` (the
    contraction axis), so dequantization scales the product's output."""
    wf = w.float()
    scale = _scale(torch.amax(torch.abs(wf), dim=axis, keepdim=True), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q, scale, "int8", axis, w.shape)


def _check_int4_shape(w, axis: int, group: int) -> None:
    """Validate one target's (shape, axis, group) before any quantization
    side effect: ``quantize_params`` checks every target up front so that
    ``free_source`` never releases half a model and then fails."""
    if w.shape[axis] % group:
        raise ValueError(
            f"contraction dim {w.shape[axis]} not divisible by group {group}"
        )
    if not 2 <= group < w.shape[axis]:
        raise ValueError(
            f"group {group} must be in [2, {w.shape[axis]}) — the grouping "
            "is encoded in the scale tensor's shape, which needs "
            "n_groups != contraction dim and != group count of 1"
        )


def quantize_weight_int4(w: torch.Tensor, axis: int,
                         group: int = 128) -> QuantizedWeight:
    """Symmetric group-wise int4: the contraction axis is split into groups
    of ``group``; each (group, output channel) gets scale = max|w| / 7.
    ``q`` holds the values packed two a byte along the last axis, ``s`` the
    f32 scales with n_groups in the contraction axis' place."""
    _check_int4_shape(w, axis, group)
    wf = w.float()
    shape = list(wf.shape)
    shape[axis:axis + 1] = [shape[axis] // group, group]
    grouped = wf.reshape(shape)
    scale = _scale(torch.amax(torch.abs(grouped), dim=axis + 1,
                              keepdim=True), 7.0)
    q = torch.clamp(torch.round(grouped / scale), -7, 7).to(torch.int8)
    return QuantizedWeight(pack_int4(q.reshape(w.shape)),
                           scale.squeeze(axis + 1), "int4", axis, w.shape)


def int4_axis_group(w: QuantizedWeight) -> tuple[int, int]:
    """(contraction axis, group size) of an int4 weight, from its unpacked
    shape and its scales' shape (the one axis where they differ)."""
    for i, (qd, sd) in enumerate(zip(w.shape, w.s.shape)):
        if qd != sd:
            return i, qd // sd
    raise ValueError(f"no grouped axis between shapes {tuple(w.shape)} / "
                     f"{tuple(w.s.shape)}")


def dequantize_weight(w: QuantizedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight in ``dtype``, at its unpacked shape."""
    return dequantize(w.q, w.s, w.scheme, w.axis, dtype)


def matmul(x: torch.Tensor, w: QuantizedWeight) -> torch.Tensor:
    """``x @ W`` (a layer weight) or the f32 logits ``x @ W.T`` (the lm
    head, ``axis`` 1). On the card, by the row count alone: the
    ``quant_matmul`` kernel up to MAX_ROWS rows, ``quant_matmul_wide``
    above; on the CPU the plain version."""
    head = w.axis == 1
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if x.device.type != "cuda":
        return quant_matmul(x, w.q, w.s, w.scheme, head)
    if rows > MAX_ROWS:
        return quant_matmul_wide(x, w.q, w.s, w.scheme, head)
    return quant_matmul(x, w.q, w.s, w.scheme, head, w.plan())


def _set(module: nn.Module, name: str, value) -> None:
    """Put ``value`` at ``module``'s dotted ``name``; a module (a quantized
    or fp8-training weight) or a plain tensor (a merged LoRA weight) takes
    the place of a parameter."""
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    if not isinstance(value, nn.Parameter) and leaf in module._parameters:
        delattr(module, leaf)
    setattr(module, leaf, value)


def _release(param: nn.Parameter) -> None:
    """Free a source weight's storage: the model that held it is invalid
    from then on, as a deleted JAX buffer is."""
    param.data = torch.empty(0, dtype=param.dtype, device=param.device)


def quantize_params(params, targets=_LAYER_TARGETS,
                    quantize_lm_head: bool = True,
                    free_source: bool = False,
                    bits=8, group: int = 128):
    """A model whose projections are int8 (``bits=8``, per channel), int4
    (``bits=4``, group-wise) or fp8 (``bits="fp8"``, per-channel e4m3).

    Returns a new ``Llama`` that shares every other weight with ``params``;
    ``params`` itself is left as it was. ``free_source=True`` releases
    each source weight's storage as soon as its quantized copy exists,
    layer by layer, so a model quantizes in place on a card that cannot
    hold both (``params``' projections are invalid afterwards). Each
    weight is upcast to f32 on its own, so no f32 copy of the model ever
    exists."""
    from kubeflow_tpu_torch.models.fp8 import quantize_weight_fp8
    from kubeflow_tpu_torch.models.llama import Llama

    head = quantize_lm_head and params.lm_head is not None
    if bits == "fp8":
        quantize = quantize_weight_fp8
    elif bits == 8:
        quantize = quantize_weight
    elif bits == 4:
        def quantize(w, axis):
            return quantize_weight_int4(w, axis=axis, group=group)
        # Validate EVERY target up front: with free_source, a shape error
        # after earlier releases would leave neither model usable.
        for t in targets:
            _check_int4_shape(getattr(params.layers[0], t), 0, group)
        if head:
            _check_int4_shape(params.lm_head, 1, group)
    else:
        raise ValueError(f"bits must be 8, 4, or 'fp8', got {bits}")
    quantized = [name for name, mod in params.named_modules()
                 if isinstance(mod, QuantizedWeight)]
    if quantized:
        raise ValueError(f"already quantized: {quantized}")

    # The new model on the meta device (no storage), then every parameter
    # of ``params`` put in it as it is: shared, not copied.
    out = Llama(params.cfg, device="meta")
    for name, p in params.named_parameters():
        _set(out, name, p)
    for i, layer in enumerate(params.layers):
        for t in targets:
            src = getattr(layer, t)
            _set(out.layers[i], t, quantize(src, axis=0))
            if free_source:
                _release(src)
    if head:
        _set(out, "lm_head", quantize(params.lm_head, axis=1))
        if free_source:
            _release(params.lm_head)
    return out


def refuse_sharding(params) -> None:
    """ValueError when ``params`` (a ``Llama`` or the bridge's numpy tree)
    holds a quantized or fp8-training weight: a tp plan cannot shard one
    (its per-column scales would not split with the columns; JAX's
    ``device_put`` raises on the ``(L, 1, out)`` scale of ``wo``). Called
    before any leaf is placed, so a refused model is left as it was."""
    from kubeflow_tpu_torch.models.fp8 import Fp8Weight

    if isinstance(params, nn.Module):
        found = [name for name, mod in params.named_modules()
                 if isinstance(mod, (QuantizedWeight, Fp8Weight))]
    else:
        found = [name for name, leaf in
                 [*params.items(), *params.get("layers", {}).items()]
                 if isinstance(leaf, dict) and name != "layers"]
    if found:
        raise ValueError(
            f"quantized weights cannot be sharded by a tp plan "
            f"({', '.join(sorted(found))}): their scales do not split with "
            "the columns; serve a quantized model on one rank"
        )


def quantized_bytes(params) -> int:
    """Device bytes of a (possibly quantized) model: every parameter and
    buffer as stored (int4 packed two values a byte)."""
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(params.parameters(), params.buffers()))


def quant_bits_from_env(env=None):
    """Serving-side half of the notebook runtime option: the webhook
    projects the ``notebooks.kubeflow.org/tpu-quantization`` annotation into
    KUBEFLOW_TPU_QUANT ("int8" | "int4" | "fp8"; absent or "bf16" = 0).
    Returns the ``bits`` argument of ``quantize_params`` (0 = stay in the
    model dtype). Raises on a value the validating webhook would have
    denied: a hand-set variable must not quietly serve full precision."""
    value = (os.environ if env is None else env).get(QUANT_ENV_NAME, "")
    if value in ("", "bf16"):
        return 0
    if value == "int8":
        return 8
    if value == "int4":
        return 4
    if value == "fp8":
        return "fp8"
    raise ValueError(
        f"{QUANT_ENV_NAME}={value!r}: want 'int8', 'int4', 'fp8', or 'bf16'"
    )
