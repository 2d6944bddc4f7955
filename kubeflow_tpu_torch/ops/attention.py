"""Full-sequence attention: the flash forward kernel and its plain version.

Counterpart of the forward half of ``kubeflow_tpu/ops/attention.py``, with
its names, argument order and layouts:

- ``flash_attention(q, k, v, causal, q_offset, impl, window, kv_mask)`` —
  (B, H, Sq, D) queries against (B, Hkv, Sk, D) keys/values with GQA
  (K/V unrepeated, q head ``i`` reads kv head ``i // (H // Hkv)``);
  returns O. ``impl="auto"`` launches the kernel on a CUDA tensor and runs
  the plain version on a CPU tensor; ``impl="xla"`` asks for the plain
  version on either (the only way to it on the card). ``impl`` may also
  be a callable of this signature or a name given to
  ``register_attention_impl`` (the sequence-parallel attentions of
  ``parallel/``, bound to a mesh): K/V are broadcast to the full heads
  first, as in JAX, and the call goes to it.
- ``flash_attention_fwd`` — the kernel's wrapper, counterpart of
  ``_fwd_pallas_call``: returns ``(O, lse)``, lse (B, H, Sq) f32 in
  natural-log units. On a CUDA tensor it launches the hand-written kernel
  ``csrc/flash_attention.cu`` (built by ``ops/_build.py``, bound with
  ctypes) or raises; ``flash_attention_fwd.launches`` counts its launches.
  The kernel replaces both Pallas forwards, the whole-K/V one and the
  streamed one: they compute one function, and their split is a choice of
  the TPU's VMEM. It takes bf16 q/k/v, head_dim 64, 128 or 256, and any
  Sq, Sk >= 1 (the TPU's 128-alignment limit is not carried over).
- ``flash_attention_reference`` — the plain PyTorch version: a masked
  softmax in f32 with the safe-softmax rule of ``_attention_xla`` (a row
  with no visible key gives O = 0) and lse = NEG_INF for such a row, as
  the Pallas kernels' ``_flush_output`` leaves it.

- ``flash_attention_bwd`` — the backward's wrapper, counterpart of
  ``_bwd_pallas_call``: from the forward's saved O and lse and the
  incoming dO it returns ``(dq, dk, dv)`` in q's, k's and v's dtypes.
  ``delta = rowsum(dO ⊙ O)`` is a plain f32 reduction here (XLA's, outside
  the Pallas kernels, in JAX). On a CUDA tensor it launches the two
  hand-written kernels of ``csrc/flash_attention_bwd.cu`` — dQ
  (``flash_bwd_dq``, replacing the Pallas dq call: a wgmma kernel per q
  tile and q head) and dK/dV (``flash_bwd_dkv``, replacing the dk/dv
  call: a wgmma kernel per key tile and q head, at head_dim 256 also per
  half of the head dim, then a group sum over each kv head's q heads in a
  fixed order, so dk and dv repeat bit for bit), each wrapper counting
  its calls in ``.launches`` — or raises; a CPU
  tensor runs ``flash_attention_bwd_reference``, the plain f32 version
  of the formula above ``_bwd_dq_kernel``. The kernels take bf16 and
  head_dim 64, 128 or 256.
- ``flash_attention(impl="auto")`` goes through ``FlashAttention``, a
  ``torch.autograd.Function`` whose forward is ``flash_attention_fwd``
  (saving q, k, v, O, lse and the mask, as the JAX ``custom_vjp`` saves
  its residuals) and whose backward is ``flash_attention_bwd``; the mask
  gets no gradient. ``impl="xla"`` is the plain forward, differentiated
  by autograd.

Visibility: key position ``k <= q + q_offset`` when causal,
``k > q + q_offset - window`` when ``window > 0``, and ``kv_mask[b, k]``
(B, Sk) bool when given. A row with no visible key has lse = NEG_INF and
gets p = 0, so zero gradients.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.nn import functional as F

NEG_INF = -1e30  # the JAX package's finite mask value and masked-row lse
# The plain version scores at most this many (row, key) pairs at once, so a
# long prompt's f32 score matrix stays bounded in memory.
_PLAIN_CHUNK_ELEMS = 1 << 27
_C_FUNC = "kftt_flash_attention_fwd"
_BWD_HEAD_DIMS = (64, 128, 256)


def _check_heads(q: torch.Tensor, k: torch.Tensor) -> None:
    h, hkv = q.shape[1], k.shape[1]
    if h != hkv and h % hkv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")


def _check_inputs(q, k, v, kv_mask) -> None:
    _check_heads(q, k)
    b, _, _, d = q.shape
    sk = k.shape[2]
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, sk):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, sk)}")


def _mask_bytes(kv_mask: Optional[torch.Tensor], sk: int):
    """(Sk_pad, the mask as (B, Sk_pad) bytes or None). The kernels read
    each tile's mask bytes as one aligned 64-byte copy: every row is padded
    to a multiple of 64 (the pad is past Sk, never read as a key)."""
    sk_pad = -(-sk // 64) * 64
    if kv_mask is None:
        return sk_pad, None
    return sk_pad, F.pad(kv_mask.to(torch.uint8), (0, sk_pad - sk)).contiguous()


# Pluggable implementations: the parallel layer may register a mesh-bound
# attention (ring, Ulysses, zigzag) under a name, so model code stays
# mesh-agnostic. Mesh-bound impls are better passed as callables, so two
# meshes never fight over one name.
_IMPL_REGISTRY: dict = {}


def register_attention_impl(name: str, fn) -> None:
    _IMPL_REGISTRY[name] = fn


def _broadcast_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, Hkv, S, D) → (B, Hkv·rep, S, D), kv head j serving q heads
    j·rep .. (j+1)·rep - 1."""
    return x.repeat_interleave(rep, dim=1)


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    causal: bool = True,
    q_offset: int = 0,
    impl="auto",
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Sk) bool, True = valid
) -> torch.Tensor:
    """Multi-head attention with GQA; returns O (B, H, Sq, D) in q's
    dtype. ``q_offset`` is q's position relative to k (a cached prefill
    continuation); ``window`` > 0 adds sliding-window masking; ``kv_mask``
    marks valid keys (left padding in batched serving)."""
    _check_heads(q, k)
    h, hkv = q.shape[1], k.shape[1]
    if callable(impl) or impl in _IMPL_REGISTRY:
        fn = impl if callable(impl) else _IMPL_REGISTRY[impl]
        if h != hkv:  # SP impls shard the head axis; give them full heads
            k = _broadcast_kv(k, h // hkv)
            v = _broadcast_kv(v, h // hkv)
        return fn(q, k, v, causal=causal, q_offset=q_offset, window=window,
                  kv_mask=kv_mask)
    if impl not in ("auto", "xla"):
        raise ValueError(
            f"unknown attention impl {impl!r}: 'auto', 'xla', a callable, "
            "or a name given to register_attention_impl"
        )
    if impl == "xla":
        return flash_attention_reference(q, k, v, causal, q_offset, window,
                                          kv_mask)[0]
    return FlashAttention.apply(q, k, v, kv_mask, causal, q_offset, window)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the kernels' backward: the counterpart of the
    JAX ``custom_vjp`` pair ``_flash_pallas`` / ``_flash_pallas_masked``.
    Under activation checkpointing the recompute replays ``forward``, so a
    checkpointed layer launches the forward kernel twice."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, q_offset, window):
        out, lse = flash_attention_fwd(q, k, v, causal, q_offset, window,
                                       kv_mask)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.args = (causal, q_offset, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.args,
                                         kv_mask=kv_mask)
        return dq, dk, dv, None, None, None, None


def _library() -> ctypes.CDLL:
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    fn = getattr(lib, _C_FUNC)
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Sk)
) -> tuple[torch.Tensor, torch.Tensor]:
    """(O (B, H, Sq, D), lse (B, H, Sq) f32). A CUDA tensor launches the
    kernel (bf16, head_dim 64/128/256) and raises on anything else; a CPU
    tensor runs the plain version."""
    _check_inputs(q, k, v, kv_mask)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, q_offset, window,
                                          kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError(
            f"q/k/v must be bfloat16 on CUDA, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if d not in (64, 128, 256):
        raise ValueError(f"head_dim {d} not in (64, 128, 256)")
    tensors = [q, k, v] + ([kv_mask] if kv_mask is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or sk == 0:
        # No row or no key: nothing to launch, nothing counted.
        out.zero_()
        lse.fill_(NEG_INF)
        return out, lse
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    sk_pad, mask8 = _mask_bytes(kv_mask, sk)
    if any(x.data_ptr() % 16 for x in [q, k, v] + (
            [mask8] if mask8 is not None else [])):
        raise ValueError("q, k, v and the mask must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _C_FUNC)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask8.data_ptr() if mask8 is not None else None,
            out.data_ptr(), lse.data_ptr(), b, h, hkv, sq, sk, sk_pad, d,
            int(bool(causal)), int(q_offset), int(window), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "flash_attention launch failed: "
            + lib.kftt_error_string(rc).decode()
        )
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_reference(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Sk)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain masked softmax in f32; returns (O in q's dtype, lse f32).
    Query rows go in chunks, so at most ``_PLAIN_CHUNK_ELEMS`` scores are
    held at once; each row's result does not depend on the chunking."""
    _check_heads(q, k)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, group, sq, d)
    kf = k.float()[:, :, None]  # (B, Hkv, 1, Sk, D)
    vf = v.float()[:, :, None]
    k_pos = torch.arange(sk, device=q.device)
    kvm = None if kv_mask is None else kv_mask.to(torch.bool)[:, None, None,
                                                              None, :]
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * h * sk))
    outs, lses = [], []
    for r0 in range(0, sq, rows):
        qc = qf[:, :, :, r0:r0 + rows]
        scores = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        q_pos = torch.arange(r0, r0 + qc.shape[3], device=q.device)[:, None] \
            + q_offset
        visible = torch.ones((qc.shape[3], sk), dtype=torch.bool,
                             device=q.device)
        if causal:
            visible = visible & (k_pos[None, :] <= q_pos)
        if window:
            visible = visible & (k_pos[None, :] > q_pos - window)
        visible = visible[None, None, None]
        if kvm is not None:
            visible = visible & kvm
        scores = torch.where(visible, scores, NEG_INF)
        m = torch.amax(scores, dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        lsum = torch.sum(p, dim=-1, keepdim=True)
        has = torch.any(visible, dim=-1, keepdim=True)
        probs = torch.where(has, p / lsum, 0.0)
        outs.append(torch.matmul(probs, vf))
        lses.append(torch.where(has, m + torch.log(lsum), NEG_INF)[..., 0])
    out = torch.cat(outs, dim=3).reshape(b, h, sq, d).to(q.dtype)
    lse = torch.cat(lses, dim=3).reshape(b, h, sq)
    return out, lse


# ---------------------------------------------------------------------------
# Backward


def _bwd_library() -> ctypes.CDLL:
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("flash_attention_bwd")
    for name, n_ptr in (("kftt_flash_bwd_dq", 8), ("kftt_flash_bwd_dkv", 11)):
        fn = getattr(lib, name)
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 11 + [
                ctypes.c_void_p
            ]
            fn.restype = ctypes.c_int
    return lib


def _launch(name: str, ptrs: list, ints: list, device) -> None:
    lib = _bwd_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*ptrs, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.kftt_error_string(rc).decode())


def flash_bwd_dq(q, k, v, dout, lse_pad, delta_pad, mask8, dq, ints) -> None:
    """Launch kernel 6 (dQ) on prepared CUDA tensors: q, k, v, dout
    contiguous bf16, lse/delta (B, H, Sq_pad) f32, mask8 (B, Sk_pad) bytes
    or None, dq the output; ``ints`` the C function's integer arguments."""
    _launch("kftt_flash_bwd_dq", [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse_pad.data_ptr(), delta_pad.data_ptr(),
        None if mask8 is None else mask8.data_ptr(), dq.data_ptr()],
        ints, q.device)
    flash_bwd_dq.launches += 1


def flash_bwd_dkv(q, k, v, dout, lse_pad, delta_pad, mask8, dk, dv,
                  ints) -> None:
    """Launch kernel 7 (dK and dV, each kv head's GQA group summed) on the
    tensors ``flash_bwd_dq`` takes: one CTA per (64-key tile, q head,
    batch row; at head_dim 256 also per half of the head dim's columns)
    writes that q head's f32 share of dK and dV into scratch
    allocated here (2 × B·H·Sk·D f32, freed on return), then the group
    sum adds the shares of each group in a fixed order into dk and dv (so
    repeats are bit-equal). One call, one count."""
    part = torch.empty((2,) + tuple(q.shape[:2]) + tuple(k.shape[2:]),
                       dtype=torch.float32, device=q.device)
    _launch("kftt_flash_bwd_dkv", [
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse_pad.data_ptr(), delta_pad.data_ptr(),
        None if mask8 is None else mask8.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), dk.data_ptr(), dv.data_ptr()], ints, q.device)
    flash_bwd_dkv.launches += 1


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,     # (B, H, Sq, D)
    k: torch.Tensor,     # (B, Hkv, Sk, D)
    v: torch.Tensor,     # (B, Hkv, Sk, D)
    out: torch.Tensor,   # (B, H, Sq, D), the forward's O
    lse: torch.Tensor,   # (B, H, Sq) f32, the forward's lse
    dout: torch.Tensor,  # (B, H, Sq, D)
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Sk)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's saved O and lse. A CUDA tensor
    launches the dQ and the dK/dV kernels (bf16, head_dim 64, 128 or 256)
    and raises on anything else; a CPU tensor runs the plain version."""
    _check_inputs(q, k, v, kv_mask)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    for name, x, shape in (("out", out, q.shape), ("dout", dout, q.shape),
                           ("lse", lse, (b, h, sq))):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} shape {tuple(x.shape)} != "
                             f"{tuple(shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, dout, causal,
                                             q_offset, window, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v, out, dout)):
        raise ValueError("q/k/v/out/dout must be bfloat16 on CUDA, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}/{out.dtype}/"
                         f"{dout.dtype}")
    if lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32, got {lse.dtype}")
    if d not in _BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_BWD_HEAD_DIMS} for the "
                         "backward kernels")
    tensors = [q, k, v, out, lse, dout] + (
        [kv_mask] if kv_mask is not None else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    if q.numel() == 0 or sk == 0:
        # No row or no key: nothing to launch, nothing counted.
        return dq.zero_(), dk.zero_(), dv.zero_()
    *inputs, ints = _bwd_inputs(q, k, v, out, lse, dout, causal, q_offset,
                                window, kv_mask)
    flash_bwd_dq(*inputs, dq, ints)
    flash_bwd_dkv(*inputs, dk, dv, ints)
    return dq, dk, dv


def _bwd_inputs(q, k, v, out, lse, dout, causal, q_offset, window, kv_mask):
    """The kernels' inputs from checked CUDA tensors: (q, k, v, dout
    contiguous, lse and delta padded to (B, H, Sq_pad), the mask bytes or
    None, the C functions' integer arguments)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    # dout arrives as a transposed view (_merge_heads); the kernels read
    # rows of D contiguous values.
    q, k, v, dout = (x.contiguous() for x in (q, k, v, dout))
    delta = torch.sum(dout.float() * out.float(), dim=-1)
    # lse and delta padded to whole 64-row tiles, so a tile's values are
    # aligned 16-byte copies; a pad row's lse NEG_INF gives it p = 0.
    sq_pad = -(-sq // 64) * 64
    lse_pad = F.pad(lse, (0, sq_pad - sq), value=NEG_INF).contiguous()
    delta_pad = F.pad(delta, (0, sq_pad - sq)).contiguous()
    sk_pad, mask8 = _mask_bytes(kv_mask, sk)
    if any(x.data_ptr() % 16 for x in [q, k, v, dout] + (
            [mask8] if mask8 is not None else [])):
        raise ValueError("q, k, v, dout and the mask must be 16-byte aligned")
    ints = [b, h, hkv, sq, sk, sk_pad, sq_pad, d, int(bool(causal)),
            int(q_offset), int(window)]
    return q, k, v, dout, lse_pad, delta_pad, mask8, ints


def flash_attention_bwd_reference(
    q: torch.Tensor,     # (B, H, Sq, D)
    k: torch.Tensor,     # (B, Hkv, Sk, D)
    v: torch.Tensor,     # (B, Hkv, Sk, D)
    out: torch.Tensor,   # (B, H, Sq, D)
    lse: torch.Tensor,   # (B, H, Sq) f32
    dout: torch.Tensor,  # (B, H, Sq, D)
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    kv_mask: Optional[torch.Tensor] = None,  # (B, Sk)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward in f32 from the saved lse, the formula above the
    JAX ``_bwd_dq_kernel``: p = exp(q·kᵀ·scale − lse) on visible keys of
    rows with lse > NEG_INF/2 (else 0), dv = Σ pᵀ·dO, dp = dO·vᵀ,
    ds = p ⊙ (dp − delta), dq = ds·k·scale, dk = Σ dsᵀ·q·scale, the sums
    over each kv head's GQA group. Returns (dq, dk, dv) in q's, k's and
    v's dtypes; query rows go in chunks as in the forward."""
    _check_heads(q, k)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(d)

    def grouped(x):
        return x.float().reshape(b, hkv, group, sq, -1)

    qf, dof = grouped(q), grouped(dout)
    lsef = lse.float().reshape(b, hkv, group, sq, 1)
    deltaf = torch.sum(dof * grouped(out), dim=-1, keepdim=True)
    kf = k.float()[:, :, None]  # (B, Hkv, 1, Sk, D)
    vf = v.float()[:, :, None]
    k_pos = torch.arange(sk, device=q.device)
    kvm = None if kv_mask is None else kv_mask.to(torch.bool)[:, None, None,
                                                              None, :]
    dk = torch.zeros((b, hkv, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, b * h * sk))
    dqs = []
    for r0 in range(0, sq, rows):
        qc, doc = qf[:, :, :, r0:r0 + rows], dof[:, :, :, r0:r0 + rows]
        lsec = lsef[:, :, :, r0:r0 + rows]
        s = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        q_pos = torch.arange(r0, r0 + qc.shape[3], device=q.device)[:, None] \
            + q_offset
        visible = torch.ones((qc.shape[3], sk), dtype=torch.bool,
                             device=q.device)
        if causal:
            visible = visible & (k_pos[None, :] <= q_pos)
        if window:
            visible = visible & (k_pos[None, :] > q_pos - window)
        visible = visible[None, None, None] & (lsec > NEG_INF * 0.5)
        if kvm is not None:
            visible = visible & kvm
        p = torch.where(visible, torch.exp(s - lsec), 0.0)
        dv += torch.matmul(p.transpose(-1, -2), doc).sum(dim=2)
        ds = p * (torch.matmul(doc, vf.transpose(-1, -2))
                  - deltaf[:, :, :, r0:r0 + rows])
        dqs.append(torch.matmul(ds, kf) * scale)
        dk += torch.matmul(ds.transpose(-1, -2), qc).sum(dim=2) * scale
    dq = torch.cat(dqs, dim=3).reshape(b, h, sq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
