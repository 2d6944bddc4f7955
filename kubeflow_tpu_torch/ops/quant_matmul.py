"""Products with a weight-only quantized weight: int8, fp8 e4m3, int4.

The JAX package has no kernel for this: ``kubeflow_tpu/models/llama.py``'s
``_mm`` and ``_lm_head_logits`` write the product of a ``{"q", "s"}``
weight as plain XLA, which fuses the dequantization into the matmul so
that the quantized tensor is what crosses HBM. Eager PyTorch would write a
bf16 copy of the weight and read it back; here the fusion is a
hand-written CUDA kernel for decode widths.

- ``quant_matmul`` — the wrapper of ``csrc/quant_matmul.cu`` (built by
  ``ops/_build.py``, bound with ctypes). On a CUDA tensor with at most
  ``MAX_ROWS`` rows it launches the kernel on the current stream or
  raises; it never falls back. ``quant_matmul.launches`` counts its
  launches, one a call. On a CPU tensor it returns the plain version.
- ``quant_matmul_reference`` — the plain version: the JAX expressions,
  with their rounding points. A layer weight (``head=False``): int8 and
  fp8 ``(x @ q.to(x.dtype)) * s.to(x.dtype)`` (the product rounded to the
  model dtype, then scaled); int4 ``x @ dequantize(q, s)`` (the operand
  dequantized in f32, then rounded). The lm head (``head=True``): f32
  logits, int8 and fp8 ``f32(x @ q.T) * s[:, 0]``, int4
  ``f32(x @ dequantize(q, s).T)``.
- ``quant_matmul_wide`` — the product for more than ``MAX_ROWS`` rows on
  the card (admissions, chunked prefill): the plain version's expression,
  a dequantized copy and ``torch.matmul``, the large product the JAX
  package also leaves outside any kernel. There the weight is read once
  for many rows, so the copy is small beside the FLOPs. Which path runs
  depends on the row count alone (``models/quant.py``'s ``matmul``);
  ``quant_matmul_wide.calls`` counts its calls.

Stored layouts (``models/quant.py``): a layer weight ``q`` (K, N) int8 or
``float8_e4m3fn`` with ``s`` (1, N) f32, or int4 packed two values a byte
into ``uint8`` (K, N/2), the even index in the low nibble, with ``s``
(K/group, N); the lm head ``q`` (V, K) with ``s`` (V, 1), or int4
(V, K/2) with ``s`` (V, K/group).

On the card the kernel takes bf16 ``x`` of 1..16 rows (any leading
shape), K and N multiples of 16 for a layer weight, K a multiple of 64
(int4: 128) for the head, and an int4 group that is a multiple of 32. A
layer product is split over CTAs by ``kn_plan`` (128-channel tiles, the
contraction split where the tiles alone would not fill the SMs), a split
tile's partials merged by a ticket in split order, in the decode
kernels' per-stream scratch (``ops.paged_attention.stream_buffers``): one
launch a call, repeats bit-equal, nothing allocated but the output. A
decode step makes 7 calls a layer, so a weight is checked once
(``kernel_plan``) and its launch arguments passed to every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from kubeflow_tpu_torch.ops.paged_attention import stream_buffers

_C_KN = "kftt_quant_matmul_kn"
_C_NK = "kftt_quant_matmul_nk"
SCHEMES = {"int8": 0, "fp8": 1, "int4": 2}
# The most rows of x the kernel takes: two 8-row mma tiles (M = 8 is the
# 8-slot decode step of every engine and the ragged engine's width-8
# dispatch).
MAX_ROWS = 16
# A layer product's CTA covers TILE_N output channels; its contraction is
# cut into k-steps of 16 rows, at least MIN_STEPS of them a CTA.
TILE_N = 128
MIN_STEPS = 16
# The head kernel's CTA covers NK_ROWS rows of the (V, K) weight.
NK_ROWS = 128


def pack_int4(values: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7] → uint8, two a byte along the last axis (its
    length even), the even index in the low nibble."""
    u = (values.to(torch.int16) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: int8 values, the last axis doubled. Each
    nibble is sign-extended by arithmetic shifts of the byte."""
    b = packed.view(torch.int8)
    vals = torch.stack([(b << 4) >> 4, b >> 4], dim=-1)
    return vals.reshape(*packed.shape[:-1], 2 * packed.shape[-1])


def dequantize(q: torch.Tensor, s: torch.Tensor, scheme: str, axis: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """The weight in ``dtype``: each value times its scale in f32, rounded
    once. ``axis`` is the contraction axis; an int4 scale tensor has the
    groups in its place."""
    if scheme == "int4":
        vals = unpack_int4(q)
        shape = list(vals.shape)
        groups = s.shape[axis]
        grouped = vals.reshape(shape[:axis] + [groups, shape[axis] // groups]
                               + shape[axis + 1:])
        # int8 times f32 promotes to f32 in the product's own kernel.
        return (grouped * s.unsqueeze(axis + 1)).reshape(shape).to(dtype)
    return (q.float() * s).to(dtype)


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                           scheme: str, head: bool = False) -> torch.Tensor:
    """Plain version: ``x @ W`` (a layer weight, in x's dtype) or f32
    ``x @ W.T`` logits (``head``), with the JAX functions' rounding
    points."""
    if scheme == "int4":
        w = dequantize(q, s, scheme, 1 if head else 0, x.dtype)
        return (x @ w.T).float() if head else x @ w
    if head:
        return (x @ q.T.to(x.dtype)).float() * s[:, 0]
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


def quant_matmul_wide(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      scheme: str, head: bool = False) -> torch.Tensor:
    """The product for more than ``MAX_ROWS`` rows of x: a dequantized
    copy and ``torch.matmul``, with the plain version's rounding points."""
    quant_matmul_wide.calls += 1
    return quant_matmul_reference(x, q, s, scheme, head)


quant_matmul_wide.calls = 0


@functools.lru_cache(maxsize=None)
def _layout(q_shape: tuple, s_shape: tuple, scheme: str, head: bool):
    """(K, N or V, group) of a stored weight, from the shapes of q and s;
    raises on a layout the module does not store."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {sorted(SCHEMES)}, got "
                         f"{scheme!r}")
    if len(q_shape) != 2 or len(s_shape) != 2:
        raise ValueError(f"q and s must be 2-D, got {tuple(q_shape)} and "
                         f"{tuple(s_shape)}")
    rows, cols = q_shape
    if scheme == "int4":
        cols *= 2
    k, n = (cols, rows) if head else (rows, cols)
    if scheme == "int4":
        groups = s_shape[1] if head else s_shape[0]
        want = (n, groups) if head else (groups, n)
        if groups <= 0 or k % groups or tuple(s_shape) != want:
            raise ValueError(f"int4 scales {tuple(s_shape)} do not group "
                             f"a ({k}, {n}) contraction")
        return k, n, k // groups
    want = (n, 1) if head else (1, n)
    if tuple(s_shape) != want:
        raise ValueError(f"scales {tuple(s_shape)} != {want}")
    return k, n, 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def kn_plan(k: int, n: int, sms: int) -> tuple[int, int, int]:
    """(channel tiles, k-steps a CTA, CTAs a tile) of a layer product:
    128-channel tiles, and where they alone leave SMs idle the contraction
    split over up to ``sms // tiles`` CTAs of at least MIN_STEPS k-steps
    (16 rows each), none empty. From the shapes and SM count alone."""
    tiles = -(-n // TILE_N)
    ksteps = k // 16
    ksplit = max(1, min(sms // tiles, -(-ksteps // MIN_STEPS)))
    spc = -(-ksteps // ksplit)
    return tiles, spc, -(-ksteps // spc)


def kernel_ctas(k: int, n: int, head: bool, sms: int) -> int:
    """The CTAs one launch runs for this weight shape."""
    if head:
        return -(-n // NK_ROWS)
    tiles, _, ksplit = kn_plan(k, n, sms)
    return tiles * ksplit


def _library() -> ctypes.CDLL:
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("quant_matmul")
    for name, pointers, ints in ((_C_KN, 6, 7), (_C_NK, 4, 5)):
        fn = getattr(lib, name)
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


class KernelPlan(NamedTuple):
    """A weight's checked launch arguments (``kernel_plan``)."""
    fn: object  # the C function: the layer or the head kernel
    k: int
    n: int
    code: int  # SCHEMES[scheme]
    group: int
    tiles: int  # kn_plan's channel tiles, k-steps a CTA, CTAs a tile
    spc: int
    ksplit: int
    device: int  # the index of the card that holds q and s


def kernel_plan(q: torch.Tensor, s: torch.Tensor, scheme: str,
                head: bool) -> KernelPlan:
    """Check that the kernel takes this stored weight (dtypes, one card,
    contiguous and 16-byte aligned, its K, N and group) and return its
    launch arguments. A decode step makes 7 products a layer plus the
    head's, so the host's cost of a call shows in every step:
    ``models/quant.py``'s ``QuantizedWeight`` makes its plan once and
    passes it to every ``quant_matmul`` call."""
    k, n, group = _layout(q.shape, s.shape, scheme, head)
    want = torch.uint8 if scheme == "int4" else (
        torch.int8 if scheme == "int8" else torch.float8_e4m3fn)
    if q.dtype != want or s.dtype != torch.float32:
        raise ValueError(f"{scheme} needs q {want} and s float32, got "
                         f"{q.dtype} and {s.dtype}")
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError("x, q and s must be on one CUDA device")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("q and s must be contiguous (the kernel reads the "
                         "weight in place and never copies it)")
    if q.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError("q and s must be 16-byte aligned")
    if head and (k % (128 if scheme == "int4" else 64)):
        raise ValueError(f"the head kernel needs K % "
                         f"{128 if scheme == 'int4' else 64} == 0, got {k}")
    if not head and (k % 16 or n % 16):
        raise ValueError(f"the layer kernel needs K and N multiples of 16, "
                         f"got ({k}, {n})")
    if scheme == "int4" and group % 32:
        raise ValueError(f"the kernel needs an int4 group that is a "
                         f"multiple of 32, got {group}")
    lib = _library()
    index = q.get_device()
    tiles, spc, ksplit = ((0, 0, 0) if head
                          else kn_plan(k, n, _sm_count(index)))
    return KernelPlan(getattr(lib, _C_NK if head else _C_KN), k, n,
                      SCHEMES[scheme], group, tiles, spc, ksplit, index)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 scheme: str, head: bool = False,
                 plan: KernelPlan | None = None) -> torch.Tensor:
    """``x @ W`` for a quantized layer weight, in x's dtype, or with
    ``head`` the f32 logits ``x @ W.T`` of a quantized lm head. CUDA
    tensors launch the kernel (bf16 x of at most MAX_ROWS rows) and raise
    on anything else; CPU tensors run the plain version. ``plan`` is
    ``kernel_plan(q, s, scheme, head)`` of these very tensors, made once
    by the caller; without it the call checks the weight itself."""
    device = x.device
    if device.type != "cuda":
        k, _, _ = _layout(q.shape, s.shape, scheme, head)
        if x.shape[-1] != k:
            raise ValueError(f"x has {x.shape[-1]} features, the weight "
                             f"contracts {k}")
        if device.type == "cpu":
            return quant_matmul_reference(x, q, s, scheme, head)
        raise ValueError(f"unsupported device {device}")
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return quant_matmul(x, q, s, scheme, head, plan)
    if plan is None:
        plan = kernel_plan(q, s, scheme, head)
    fn, k, n, code, group, tiles, spc, ksplit, index = plan
    if index != device.index:
        raise ValueError("x, q and s must be on one CUDA device")
    if x.shape[-1] != k:
        raise ValueError(f"x has {x.shape[-1]} features, the weight "
                         f"contracts {k}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16 on CUDA, got {x.dtype}")
    rows = x.numel() // k
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows > MAX_ROWS {MAX_ROWS}: the kernel is "
                         "for decode widths (quant_matmul_wide takes more)")
    out = torch.empty(x.shape[:-1] + (n,),
                      dtype=torch.float32 if head else x.dtype, device=device)
    if rows == 0:
        return out  # nothing launched or counted
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if head:
        rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                rows, k, n, code, group,
                torch._C._cuda_getCurrentRawStream(device.index))
    else:
        scratch, counters, stream = stream_buffers(
            device, tiles, tiles * ksplit * MAX_ROWS * TILE_N)
        rc = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), counters.data_ptr(), rows, k, n, code,
                group, spc, ksplit, stream)
    if rc != 0:
        raise RuntimeError("quant_matmul launch failed: "
                           + _library().kftt_error_string(rc).decode())
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
