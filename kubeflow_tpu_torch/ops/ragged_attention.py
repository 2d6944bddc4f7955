"""Ragged paged attention: one fused dispatch for mixed decode/prefill.

Counterpart of ``kubeflow_tpu/ops/ragged_attention.py`` with the same
signatures and layouts:

- ``ragged_paged_attention`` — the wrapper of the hand-written CUDA kernel
  ``csrc/ragged_attention.cu`` (built by ``ops/_build.py``, bound with
  ctypes). On a CUDA tensor it launches the kernel on the current stream
  or raises; it never falls back. ``ragged_paged_attention.launches``
  counts its launches. On a CPU tensor it returns the plain version,
  because a CPU tensor is all it was given.
- ``ragged_attention_reference`` — the plain PyTorch version: it derives
  each row's owning sequence from the metadata, gathers the slot's
  logical view through the tables and applies the validity rule
  (stored kv_mask AND ``k_pos <= kv_len - seq_len + j``) in f32. It is
  the only attention the port runs on CPU tensors.

Layout contract (produced by the ragged scheduler, models/paged.py):
q (T, Hq, D); pools (NB, Hkv, BS, D) bf16, or int8 with
``k_scale_pool``/``v_scale_pool`` (NB, Hkv, BS) bf16; tables (S, MAXB)
int32; kv_mask (S, MAXB·BS) bool, carrying padding only (the positional
bound hides future positions); seq_starts/seq_lens/kv_lens (S,) int32
with disjoint left-to-right row spans and ``seq_lens == 0`` for an idle
slot. Rows owned by no sequence come out 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

_C_FUNC = "kftt_ragged_paged_attention"


def _validate(q, k_pool, tables, kv_mask, block_size, k_scale_pool,
              v_scale_pool) -> bool:
    """The JAX wrapper's checks, with its messages; returns whether the
    pools are int8 + scales."""
    _, hq, _ = q.shape
    nb, hkv, bs, _ = k_pool.shape
    if bs != block_size:
        raise ValueError(f"pool block size {bs} != block_size {block_size}")
    if hq % hkv:
        raise ValueError(f"{hq} q heads not divisible by {hkv} kv heads")
    quantized = k_scale_pool is not None
    if quantized != (v_scale_pool is not None):
        raise ValueError("k_scale_pool and v_scale_pool must come together")
    if quantized and tuple(k_scale_pool.shape) != (nb, hkv, bs):
        raise ValueError(
            f"scale pool shape {tuple(k_scale_pool.shape)} != {(nb, hkv, bs)} "
            "(one scale per stored kv position)"
        )
    s, max_blocks = tables.shape
    if tuple(kv_mask.shape) != (s, max_blocks * bs):
        raise ValueError(
            f"kv_mask shape {tuple(kv_mask.shape)} != ({s}, {max_blocks * bs}) "
            "(tables × block_size layout)"
        )
    return quantized


def _library() -> ctypes.CDLL:
    from kubeflow_tpu_torch.ops import _build

    lib = _build.load("ragged_attention")
    fn = getattr(lib, _C_FUNC)
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
    return lib


def ragged_paged_attention(
    q: torch.Tensor,           # (T, Hq, D) flattened mixed-batch queries
    k_pool: torch.Tensor,      # (NB, Hkv, BS, D) block pool
    v_pool: torch.Tensor,      # (NB, Hkv, BS, D)
    tables: torch.Tensor,      # (S, MAXB) physical block ids per slot
    kv_mask: torch.Tensor,     # (S, MAXB·BS) bool valid-key mask per slot
    seq_starts: torch.Tensor,  # (S,) first q row of each sequence
    seq_lens: torch.Tensor,    # (S,) q rows this step (0 = inactive)
    kv_lens: torch.Tensor,     # (S,) kv length INCLUDING this chunk
    block_size: int,
    q_tile: int = 16,
    k_scale_pool: Optional[torch.Tensor] = None,  # (NB, Hkv, BS) bf16
    v_scale_pool: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Ragged paged GQA attention over a mixed batch; returns (T, Hq, D).

    Row r of sequence s attends slot s's blocks at kv positions
    ``<= kv_lens[s] - seq_lens[s] + (r - seq_starts[s])`` where kv_mask
    allows. CUDA tensors launch the kernel (bf16 q and pools, or int8
    pools with bf16 scales; head_dim 64, 128 or 256; q_tile·Hq/Hkv <= 128)
    and raise on anything else; CPU tensors run the plain version."""
    quantized = _validate(q, k_pool, tables, kv_mask, block_size,
                          k_scale_pool, v_scale_pool)
    if q.device.type == "cpu":
        return ragged_attention_reference(
            q, k_pool, v_pool, tables, kv_mask, seq_starts, seq_lens,
            kv_lens, block_size, k_scale_pool=k_scale_pool,
            v_scale_pool=v_scale_pool,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    t, hq, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    s, maxb = tables.shape
    pool_dtype = torch.int8 if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bfloat16 on CUDA, got {q.dtype}")
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise ValueError(
            f"pools must be {pool_dtype}, got {k_pool.dtype}/{v_pool.dtype}"
        )
    if quantized and (k_scale_pool.dtype != torch.bfloat16
                      or v_scale_pool.dtype != torch.bfloat16):
        raise ValueError("scale pools must be bfloat16")
    if d not in (64, 128, 256):
        raise ValueError(f"head_dim {d} not in (64, 128, 256)")
    if not 1 <= q_tile * (hq // hkv) <= 128:
        raise ValueError(
            f"q_tile {q_tile} × group {hq // hkv} must be in 1..128 rows"
        )
    tensors = [q, k_pool, v_pool, tables, kv_mask, seq_starts, seq_lens,
               kv_lens] + ([k_scale_pool, v_scale_pool] if quantized else [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must be on one CUDA device")
    q = q.contiguous()
    k_pool = k_pool.contiguous()
    v_pool = v_pool.contiguous()
    tables = tables.to(torch.int32).contiguous()
    kv_mask = kv_mask.to(torch.bool).contiguous()
    seq_starts = seq_starts.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    if quantized:
        k_scale_pool = k_scale_pool.contiguous()
        v_scale_pool = v_scale_pool.contiguous()
    if any(x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    # Unowned rows read 0, as in the plain version.
    out = torch.zeros_like(q)
    if t == 0 or s == 0:
        return out  # no row or no sequence: nothing launched, nothing counted
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, _C_FUNC)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale_pool.data_ptr() if quantized else None,
            v_scale_pool.data_ptr() if quantized else None,
            tables.data_ptr(), kv_mask.data_ptr(), seq_starts.data_ptr(),
            seq_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            t, hq, hkv, d, bs, s, maxb, q_tile, int(quantized), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "ragged_paged_attention launch failed: "
            + lib.kftt_error_string(rc).decode()
        )
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def ragged_attention_reference(
    q: torch.Tensor,           # (T, Hq, D)
    k_pool: torch.Tensor,      # (NB, Hkv, BS, D)
    v_pool: torch.Tensor,      # (NB, Hkv, BS, D)
    tables: torch.Tensor,      # (S, MAXB)
    kv_mask: torch.Tensor,     # (S, MAXB·BS)
    seq_starts: torch.Tensor,  # (S,)
    seq_lens: torch.Tensor,    # (S,)
    kv_lens: torch.Tensor,     # (S,)
    block_size: int,
    k_scale_pool: Optional[torch.Tensor] = None,  # (NB, Hkv, BS)
    v_scale_pool: Optional[torch.Tensor] = None,  # (NB, Hkv, BS)
) -> torch.Tensor:
    """Plain gather/segment-softmax version; returns (T, Hq, D).

    Gathers each row's slot view through the tables and applies the
    validity rule in f32. Rows owned by no sequence come out 0. Scale
    pools dequantize int8 values as ``value.float() * scale[..., None]``,
    as the kernel does."""
    t, hq, d = q.shape
    s, maxb = tables.shape
    hkv = k_pool.shape[1]
    group = hq // hkv
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("k_scale_pool and v_scale_pool must come together")
    tables = tables.long()
    seq_starts, seq_lens, kv_lens = (
        seq_starts.long(), seq_lens.long(), kv_lens.long()
    )
    rows = torch.arange(t, device=q.device)
    in_seq = (rows[None, :] >= seq_starts[:, None]) & (
        rows[None, :] < (seq_starts + seq_lens)[:, None]
    )  # (S, T)
    tok_seq = torch.argmax(in_seq.to(torch.int32), dim=0)  # 0 where unowned
    tok_own = torch.any(in_seq, dim=0)
    tok_pos = (
        kv_lens[tok_seq] - seq_lens[tok_seq] + rows - seq_starts[tok_seq]
    )  # absolute kv position per row

    def gathered(pool, scale=None):
        g = pool[tables]  # (S, MAXB, Hkv, BS, D)
        g = g.permute(0, 2, 1, 3, 4).reshape(s, hkv, maxb * block_size, d)
        if scale is None:
            return g
        sg = scale[tables].permute(0, 2, 1, 3).reshape(
            s, hkv, maxb * block_size
        )  # (S, Hkv, L)
        return g.float() * sg.float()[..., None]

    kg = gathered(k_pool, k_scale_pool)[tok_seq].float()
    vg = gathered(v_pool, v_scale_pool)[tok_seq].float()
    qf = q.reshape(t, hkv, group, d).float()
    scores = torch.einsum("thgd,thld->thgl", qf, kg) / math.sqrt(d)
    k_pos = torch.arange(maxb * block_size, device=q.device)
    valid = (
        kv_mask.to(torch.bool)[tok_seq][:, None, None, :]
        & (k_pos[None, None, None, :] <= tok_pos[:, None, None, None])
        & tok_own[:, None, None, None]
    )
    scores = torch.where(valid, scores, -math.inf)
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(m), torch.exp(scores - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("thgl,thld->thgd", p, vg) / torch.clamp_min(l, 1e-30)
    return out.reshape(t, hq, d).to(q.dtype)
