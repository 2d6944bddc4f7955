"""Decode attention: through the block tables, or over a dense cache.

Counterpart of ``paged_decode_attention`` and ``dense_decode_attention``
in ``kubeflow_tpu/ops/paged_attention.py``, with their signatures, layouts
and shape checks. Both wrappers launch one hand-written CUDA source,
``csrc/paged_attention.cu``, whose body is shared and differs only in
where a slot's keys live, as the two Pallas kernels share ``_attend``.

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

- ``dense_decode_attention`` — the same decode over the dense per-slot
  cache of ``ContinuousBatcher``: k/v caches (B, Hkv, C, D) bf16, one
  layer's slice of the stacked cache, read in place (a non-contiguous
  cache raises; it is never copied); kv_mask (B, C). The kernel walks only
  each slot's first ``min(seq_len, C)`` keys, in 64-key tiles.
  ``block_size`` bounds the walk in JAX and changes no result; it is kept,
  with JAX's ``C % block_size`` check. ``dense_decode_attention.launches``
  counts its launches; a CPU tensor runs ``dense_decode_reference``.
- ``dense_decode_reference`` — its plain version: valid keys are
  ``kv_mask AND k_pos < seq_len``, in f32; a row with no valid key gives 0.
"""

from __future__ import annotations

import ctypes
import math

import torch

_C_FUNC = "kftt_paged_decode_attention"
_C_DENSE = "kftt_dense_decode_attention"


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
    for name, pointers, ints in ((_C_FUNC, 7, 6), (_C_DENSE, 6, 5)):
        fn = getattr(lib, name)
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints \
                + [ctypes.c_void_p]
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


def _validate_dense(q, k_cache, kv_mask, block_size) -> None:
    """The JAX wrapper's checks, with its messages."""
    b, hq, _ = q.shape
    _, hkv, c, _ = k_cache.shape
    if c % block_size:
        raise ValueError(
            f"cache_len {c} not divisible by block_size {block_size}"
        )
    if hq % hkv:
        raise ValueError(f"{hq} q heads not divisible by {hkv} kv heads")
    if tuple(kv_mask.shape) != (b, c):
        raise ValueError(f"kv_mask shape {tuple(kv_mask.shape)} != ({b}, {c})")


def dense_decode_attention(
    q: torch.Tensor,         # (B, Hq, D) — the single new token per slot
    k_cache: torch.Tensor,   # (B, Hkv, C, D) bf16 per-slot dense cache
    v_cache: torch.Tensor,   # (B, Hkv, C, D)
    kv_mask: torch.Tensor,   # (B, C) bool valid-key mask
    seq_lens: torch.Tensor,  # (B,) position + 1 (bounds the read)
    block_size: int = 256,
) -> torch.Tensor:
    """Length-bounded dense GQA decode attention; returns (B, Hq, D). CUDA
    tensors launch the kernel (bf16 q and contiguous bf16 caches, head_dim
    64/128/256, Hq/Hkv <= 16) and raise on anything else; CPU tensors run
    the plain version."""
    _validate_dense(q, k_cache, kv_mask, block_size)
    if q.device.type == "cpu":
        return dense_decode_reference(q, k_cache, v_cache, kv_mask, seq_lens,
                                      block_size)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, hq, d = q.shape
    _, hkv, c, _ = k_cache.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16 on CUDA, got {q.dtype}")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError(
            "dense_decode_attention reads bf16 caches only, got "
            f"{k_cache.dtype}/{v_cache.dtype} (int8 caches take "
            "_gqa_decode_attention)"
        )
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"v_cache shape {tuple(v_cache.shape)} != k_cache "
                         f"shape {tuple(k_cache.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the caches must be contiguous (the kernel reads "
                         "them in place and never copies a cache)")
    if d not in (64, 128, 256):
        raise ValueError(f"head_dim {d} not in (64, 128, 256)")
    if hq // hkv > 16:
        raise ValueError(f"group {hq // hkv} q heads per kv head > 16")
    if any(x.device != q.device
           for x in (k_cache, v_cache, kv_mask, seq_lens)):
        raise ValueError("all inputs must be on one CUDA device")
    q = q.contiguous()
    kv_mask = kv_mask.to(torch.bool).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError("q and the caches must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out  # no slot: nothing launched, nothing counted
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _C_DENSE)(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_mask.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            b, hq, hkv, d, c, stream,
        )
    if rc != 0:
        raise RuntimeError(
            "dense_decode_attention launch failed: "
            + lib.kftt_error_string(rc).decode()
        )
    dense_decode_attention.launches += 1
    return out


dense_decode_attention.launches = 0


def dense_decode_reference(
    q: torch.Tensor,         # (B, Hq, D)
    k_cache: torch.Tensor,   # (B, Hkv, C, D)
    v_cache: torch.Tensor,   # (B, Hkv, C, D)
    kv_mask: torch.Tensor,   # (B, C)
    seq_lens: torch.Tensor,  # (B,)
    block_size: int = 256,
) -> torch.Tensor:
    """Plain version; returns (B, Hq, D) in q's dtype. ``block_size`` only
    bounds the kernel's walk and is not used."""
    del block_size
    b, hq, d = q.shape
    _, hkv, c, _ = k_cache.shape
    qf = q.reshape(b, hkv, hq // hkv, d).float()
    scores = torch.einsum("bhgd,bhld->bhgl", qf, k_cache.float()) \
        * (1.0 / math.sqrt(d))
    k_pos = torch.arange(c, device=q.device)
    valid = kv_mask.to(torch.bool) & (k_pos[None, :] < seq_lens.long()[:, None])
    scores = torch.where(valid[:, None, None, :], scores, -math.inf)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(scores - m), 0.0)
    lsum = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgl,bhld->bhgd", p, v_cache.float()) \
        / torch.clamp_min(lsum, 1e-30)
    return out.reshape(b, hq, d).to(q.dtype)
