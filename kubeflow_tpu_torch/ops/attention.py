"""Full-sequence attention: the flash forward kernel and its plain version.

Counterpart of the forward half of ``kubeflow_tpu/ops/attention.py``, with
its names, argument order and layouts:

- ``flash_attention(q, k, v, causal, q_offset, impl, window, kv_mask)`` —
  (B, H, Sq, D) queries against (B, Hkv, Sk, D) keys/values with GQA
  (K/V unrepeated, q head ``i`` reads kv head ``i // (H // Hkv)``);
  returns O. ``impl="auto"`` launches the kernel on a CUDA tensor and runs
  the plain version on a CPU tensor; ``impl="xla"`` asks for the plain
  version on either (the only way to it on the card). Registered and
  callable impls (ring, Ulysses) are not ported yet and raise.
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

Visibility: key position ``k <= q + q_offset`` when causal,
``k > q + q_offset - window`` when ``window > 0``, and ``kv_mask[b, k]``
(B, Sk) bool when given.
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


def _check_heads(q: torch.Tensor, k: torch.Tensor) -> None:
    h, hkv = q.shape[1], k.shape[1]
    if h != hkv and h % hkv != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {hkv}")


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
    if callable(impl) or impl not in ("auto", "xla"):
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported to PyTorch yet (the "
            "registered and callable impls, ring and Ulysses, come with the "
            "sequence-parallel slice); use impl='auto' or 'xla'"
        )
    if impl == "xla":
        return flash_attention_reference(q, k, v, causal, q_offset, window,
                                          kv_mask)[0]
    return flash_attention_fwd(q, k, v, causal, q_offset, window, kv_mask)[0]


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
    _check_heads(q, k)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v shape {tuple(v.shape)} != k shape {tuple(k.shape)}")
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, sk):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != {(b, sk)}")
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
    # The kernel reads each tile's mask bytes as one aligned 64-byte copy:
    # pad every row to a multiple of 64 (the pad is past Sk, never read as
    # a key).
    sk_pad = -(-sk // 64) * 64
    mask8 = None
    if kv_mask is not None:
        mask8 = F.pad(kv_mask.to(torch.uint8), (0, sk_pad - sk)).contiguous()
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
