"""Paged-attention decode: attend through the block tables.

Counterpart of ``paged_decode_attention`` in
``kubeflow_tpu/ops/paged_attention.py``, with its signature, layouts and
shape checks:

- ``paged_decode_attention`` — the wrapper of the hand-written CUDA kernel
  ``csrc/paged_attention.cu`` (built by ``ops/_build.py``, bound with
  ctypes). On a CUDA tensor it launches the kernel on the current stream
  or raises; it never falls back. ``paged_decode_attention.launches``
  counts its launches. On a CPU tensor it returns the plain version.
- ``paged_decode_reference`` — the plain PyTorch version: it gathers each
  slot's logical view through the tables and applies ``kv_mask AND
  k_pos < seq_len`` in f32; a row whose keys are all masked gives 0, as
  the Pallas kernel's ``_attend`` does.

Layouts: q (B, Hq, D), one new token per slot; pools (NB, Hkv, BS, D)
bf16 (int8 pools keep the engine's gathered path, as in JAX); tables
(B, MAXB) int32; kv_mask (B, MAXB·BS) bool; seq_lens (B,) int32, the
position + 1 that bounds the walk. The kernel walks only the slot's
``min(ceil(seq_len / BS), MAXB)`` live blocks.
"""

from __future__ import annotations

import ctypes
import math

import torch

_C_FUNC = "kftt_paged_decode_attention"


def _validate(q, k_pool, tables, kv_mask, block_size) -> None:
    """The JAX wrapper's checks, with its messages."""
    b, hq, _ = q.shape
    _, hkv, bs, _ = k_pool.shape
    if bs != block_size:
        raise ValueError(f"pool block size {bs} != block_size {block_size}")
    if hq % hkv:
        raise ValueError(f"{hq} q heads not divisible by {hkv} kv heads")
    max_blocks = tables.shape[1]
    if tuple(kv_mask.shape) != (b, max_blocks * bs):
        raise ValueError(
            f"kv_mask shape {tuple(kv_mask.shape)} != ({b}, {max_blocks * bs}) "
            "(tables × block_size layout)"
        )


def _library() -> ctypes.CDLL:
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = getattr(lib, _C_FUNC)
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def paged_decode_attention(
    q: torch.Tensor,         # (B, Hq, D) — the single new token per slot
    k_pool: torch.Tensor,    # (NB, Hkv, BS, D) bf16 block pool
    v_pool: torch.Tensor,    # (NB, Hkv, BS, D)
    tables: torch.Tensor,    # (B, MAXB) physical block ids
    kv_mask: torch.Tensor,   # (B, MAXB·BS) bool valid-key mask
    seq_lens: torch.Tensor,  # (B,) position + 1 (bounds the block walk)
    block_size: int,
) -> torch.Tensor:
    """Paged GQA decode attention; returns (B, Hq, D). CUDA tensors launch
    the kernel (bf16 q and pools, head_dim 64/128/256, Hq/Hkv <= 16) and
    raise on anything else; CPU tensors run the plain version."""
    _validate(q, k_pool, tables, kv_mask, block_size)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, tables, kv_mask,
                                      seq_lens, block_size)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    maxb = tables.shape[1]
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16 on CUDA, got {q.dtype}")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise ValueError(
            "paged_decode_attention reads bf16 pools only, got "
            f"{k_pool.dtype}/{v_pool.dtype} (int8 pools take the gathered "
            "path)"
        )
    if d not in (64, 128, 256):
        raise ValueError(f"head_dim {d} not in (64, 128, 256)")
    if hq // hkv > 16:
        raise ValueError(f"group {hq // hkv} q heads per kv head > 16")
    if any(x.device != q.device
           for x in (k_pool, v_pool, tables, kv_mask, seq_lens)):
        raise ValueError("all inputs must be on one CUDA device")
    q = q.contiguous()
    k_pool = k_pool.contiguous()
    v_pool = v_pool.contiguous()
    tables = tables.to(torch.int32).contiguous()
    kv_mask = kv_mask.to(torch.bool).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    if any(x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out  # no slot: nothing launched, nothing counted
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _C_FUNC)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), kv_mask.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), b, hq, hkv, d, bs, maxb, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "paged_decode_attention launch failed: "
            + lib.kftt_error_string(rc).decode()
        )
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_reference(
    q: torch.Tensor,         # (B, Hq, D)
    k_pool: torch.Tensor,    # (NB, Hkv, BS, D)
    v_pool: torch.Tensor,    # (NB, Hkv, BS, D)
    tables: torch.Tensor,    # (B, MAXB)
    kv_mask: torch.Tensor,   # (B, MAXB·BS)
    seq_lens: torch.Tensor,  # (B,)
    block_size: int,
) -> torch.Tensor:
    """Plain gathered version; returns (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    maxb = tables.shape[1]
    group = hq // hkv
    tables = tables.long()

    def gathered(pool):
        g = pool[tables]  # (B, MAXB, Hkv, BS, D)
        return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, maxb * bs, d).float()

    qf = q.reshape(b, hkv, group, d).float()
    scores = torch.einsum("bhgd,bhld->bhgl", qf, gathered(k_pool)) \
        * (1.0 / math.sqrt(d))
    k_pos = torch.arange(maxb * bs, device=q.device)
    valid = kv_mask.to(torch.bool) & (k_pos[None, :] < seq_lens.long()[:, None])
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, -math.inf)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(scores - m), 0.0)
    lsum = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgl,bhld->bhgd", p, gathered(v_pool)) \
        / torch.clamp_min(lsum, 1e-30)
    return out.reshape(b, hq, d).to(q.dtype)
