#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The port serves ``llama-3-8b`` at full width and depth (random weights
from a seed) behind ``InferenceServer`` on three main paths, each run with
every kernel's launch count set to 0 just before it and read just after:

- the ragged engine, ``PagedBatcher(ragged=True)``, whose every step runs
  ``kubeflow_tpu_torch/csrc/ragged_attention.cu`` in each layer;
- the alternating engine, ``PagedBatcher(ragged=False)`` (what the server
  runs when ``KUBEFLOW_TPU_SERVING_RAGGED`` is unset), whose admissions
  prefill through ``csrc/flash_attention.cu`` and whose decode steps run
  ``csrc/paged_attention.cu``, each once per layer;
- the continuous engine, ``ContinuousBatcher`` over a dense bf16 cache of
  1024 positions per slot (what ``serve_http`` runs without ``--paged``),
  whose admissions prefill through ``csrc/flash_attention.cu`` and whose
  decode steps run the dense decode kernel of ``csrc/paged_attention.cu``,
  each once per layer.

Phases, in order; any failure raises and the script exits non-zero:

1. card — needs ``torch.cuda.is_available()`` and drives one card (the
   first visible one); prints the card's ``nvidia-smi`` name and power
   limit; turns TF32 off;
2. build — compiles every ``csrc/*.cu`` with ``nvcc``, one process per
   source, all at once, and prints ptxas's register / shared-memory /
   spill lines for each;
3. kernel vs plain — each kernel's wrapper against its plain PyTorch
   version (kept in f32) on the same inputs, held to three gates: max abs
   error <= 2e-2; element by element
   ``|out - ref| <= 2^-7 · (|ref| + ref_abs)``, where ``ref_abs`` is the
   plain version over ``|v|`` (the size of the weighted sum before any
   cancellation); for each row and q head ``‖out - ref‖ <= 2^-6 · ‖ref‖``
   over the head dim. Ragged attention: the span layouts of the CPU suite
   and one main-path shape, bf16 and int8 pools, on owned rows; unowned
   rows exactly 0. Flash forward: the CPU suite's cases, the main-path
   prefill (Hq 32, Hkv 8, Sq = Sk = 512, D 128, causal, left padding), a
   shape past the TPU's 4 MB whole-K/V line (Sq = Sk = 16384), window
   cases and a 528-row continuation; lse within 1e-3 where a row sees a
   key, and <= -1e29 with O = 0 where it sees none. Paged decode: the CPU
   suite's layouts and the main-path decode (8 slots, lengths 8..576),
   an idle slot and a stale length. Dense decode: the CPU suite's layouts
   and the main-path decode (8 slots, C 1024, lengths 8..576), a mask with
   a hole, an idle slot (all-False row, exactly 0) and a slot at
   seq_len == C;
4. timing — CUDA events at the main-path shapes (L2 flushed between
   launches): each kernel, its plain version, and one library call (a
   yardstick the port never calls: ``scaled_dot_product_attention`` over
   a per-slot batched view, with ``enable_gqa`` for the flash and decode
   kernels, over ``cache[:, :, :max_len]`` for the dense decode kernel),
   beside the least time the card could take (bytes over 3.35 TB/s, FLOPs
   of the visible pairs over 989 TFLOP/s);
5. engines — 16 prompts of 8..500 tokens, 64 new tokens each: the ragged
   engine with a bf16 and an int8 pool, where launches must equal
   ``ragged_steps × n_layers``; the alternating engine with a bf16 pool,
   where flash launches must equal ``_paged_admit`` calls × n_layers and
   decode launches ``_paged_step`` calls × n_layers (calls counted here,
   by wrapping the two functions); the continuous engine (8 slots, cache
   1024, bucket 512), where flash launches must equal ``_admit_slot``
   calls × n_layers and dense decode launches ``_cb_step`` calls ×
   n_layers. 4 prompts are then served again with the kernels and with
   plain attention (``attn_kernel=False``, and for the alternating and
   continuous engines' prefill ``impl="xla"``) and compared (tokens equal,
   or a fork after the first token with chosen-token logprobs before it
   within 2e-2); the continuous engine serves them once more with chunked
   admission (``admit_chunk=128``), compared to one-shot admission by the
   same rule; last, 8 prompts are served once more under
   ``torch.profiler``, and that one run's trace gives the card's busy
   time, idle share and time by kernel;
6. HTTP — 4 concurrent ``/v1/completions`` (2 streamed) against the
   server over each bf16 engine; streamed tokens must equal the blocking
   response for the same prompt; then ``/stats`` and a clean stop.

It prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch
from torch.nn import functional as F

from kubeflow_tpu_torch.models import continuous as cont_mod
from kubeflow_tpu_torch.models import llama as L
from kubeflow_tpu_torch.models import paged as paged_mod
from kubeflow_tpu_torch.models.continuous import ContinuousBatcher
from kubeflow_tpu_torch.models.llama import _kv_quantize
from kubeflow_tpu_torch.models.paged import PagedBatcher
from kubeflow_tpu_torch.models.server import InferenceServer
from kubeflow_tpu_torch.models.serving import GenerationConfig
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention_fwd,
    flash_attention_reference,
)
from kubeflow_tpu_torch.ops.paged_attention import (
    dense_decode_attention,
    dense_decode_reference,
    paged_decode_attention,
    paged_decode_reference,
)
from kubeflow_tpu_torch.ops.ragged_attention import (
    ragged_attention_reference,
    ragged_paged_attention,
)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
TOL = 2e-2
# Kernel vs plain: the limit of each error _errors measures. "rel" is twice
# the bf16 rounding bound; "row_rel" four times bf16's 2^-8.
GATES = {"abs": TOL, "rel": 2.0 ** -7, "row_rel": 2.0 ** -6}
SEED = 0
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Kernel cases


def _case(spans, *, hq, hkv, d, bs, maxb, nb, t, seed, all_true=False):
    """Random bf16 q/pools and the metadata for [(seq_len, kv_len)]."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    q = torch.randn((t, hq, d), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((nb, hkv, bs, d), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((nb, hkv, bs, d), generator=g, device=dev).to(torch.bfloat16)
    s = len(spans)
    tables = torch.randperm(nb - 1, generator=g, device=dev)[: s * maxb]
    tables = (tables + 1).reshape(s, maxb).to(torch.int32)
    starts, lens, kvls, row = [], [], [], 0
    for n, kvl in spans:
        starts.append(row)
        lens.append(n)
        kvls.append(kvl)
        row += n
    check(row <= t, f"spans need {row} rows > {t}")
    kvl_t = torch.tensor(kvls, dtype=torch.int32, device=dev)
    if all_true:
        kv_mask = torch.ones((s, maxb * bs), dtype=torch.bool, device=dev)
    else:
        kv_mask = torch.arange(maxb * bs, device=dev)[None, :] < kvl_t[:, None]
    return dict(
        q=q, k_pool=kp, v_pool=vp, tables=tables, kv_mask=kv_mask,
        seq_starts=torch.tensor(starts, dtype=torch.int32, device=dev),
        seq_lens=torch.tensor(lens, dtype=torch.int32, device=dev),
        kv_lens=kvl_t, block_size=bs,
    )


def _quantized(case):
    out = dict(case)
    out["k_pool"], out["k_scale_pool"] = _kv_quantize(case["k_pool"])
    out["v_pool"], out["v_scale_pool"] = _kv_quantize(case["v_pool"])
    return out


def _owned(case) -> torch.Tensor:
    t = case["q"].shape[0]
    owned = torch.zeros(t, dtype=torch.bool, device=DEVICE)
    for s0, n in zip(case["seq_starts"].tolist(), case["seq_lens"].tolist()):
        owned[s0:s0 + n] = True
    return owned


# The span layouts of the CPU suite (tests/test_torch_ragged_attention.py).
SMALL = dict(hq=8, hkv=4, d=128, bs=16, maxb=6, nb=32, t=24)
SMALL_LAYOUTS = [
    ([(1, 17), (1, 40), (1, 96)], 16, False),   # decode-only
    ([(8, 8), (12, 12), (4, 20)], 16, False),   # prefill-only chunks
    ([(1, 33), (10, 10), (1, 5)], 16, False),   # mixed decode + prefill
    ([(1, 64), (1, 96), (6, 22)], 16, False),   # mixed, longer histories
    ([(5, 30), (1, 1), (0, 0)], 16, False),     # single-token tail + idle
    ([(1, 33), (20, 20), (1, 5)], 8, False),    # chunk spans 3 q-tiles
    ([(3, 19), (9, 41), (12, 12)], 4, False),   # every span spills a tile
    ([(5, 21), (7, 39), (1, 64)], 4, False),    # spill rows of a partial tile
    ([(1, 25), (7, 18), (1, 90)], 16, True),    # all-True mask
]
# Main-path shape: llama-3-8b heads, 8 slots, 512 rows mixing 4 decode
# rows and 4 prefill chunks, kv lengths up to 640.
MAIN = dict(hq=32, hkv=8, d=128, bs=16, maxb=40, nb=8 * 40 + 1, t=512)
MAIN_SPANS = [(1, 640), (200, 200), (1, 300), (150, 430), (1, 129),
              (100, 100), (1, 17), (58, 640)]


def _errors(out, case, owned) -> dict:
    """The kernel's error against the plain version on the same values
    kept in f32 (the error is the kernel's own, not a second bf16
    rounding), over owned rows, each to be held to its entry in GATES:

    - ``abs``: max |out − ref|;
    - ``rel``: max |out − ref| / (|ref| + ref_abs), element by element,
      ``ref_abs`` being the plain version over ``|v|``. The kernel's only
      roundings are to bf16, of each probability (int8: of probability ×
      V scale) before P·V and of the output, each at most 2^-8 relative
      (bf16 keeps 8 significant bits), so a right kernel stays within
      2^-8 · (|ref| + ref_abs) even where the weighted sum cancels;
    - ``row_rel``: max over (row, q head) of ‖out − ref‖ / ‖ref‖ over the
      head dim. Independent roundings shrink like the weighted sum itself
      as a row attends more keys, so this stays near 2^-8 on long rows,
      where ``rel``'s bound, set by ``ref_abs``, is loose."""
    plain = {**case, "q": case["q"].float()}
    ref = ragged_attention_reference(**plain)[owned]
    ref_abs = ragged_attention_reference(
        **{**plain, "v_pool": case["v_pool"].abs()})[owned]
    return _diff_errors(out.float()[owned], ref, ref_abs)


def _diff_errors(out, ref, ref_abs) -> dict:
    """The GATES errors of ``out`` against ``ref`` (both f32, the head dim
    last), ``ref_abs`` being the plain version over ``|v|``."""
    diff = (out - ref).abs()
    rel = diff / (ref.abs() + ref_abs).clamp_min(1e-30)
    row_rel = (torch.linalg.vector_norm(diff, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30))
    return {"abs": float(diff.max()), "rel": float(rel.max()),
            "row_rel": float(row_rel.max())}


def _gate(name: str, errs: dict, worst: dict) -> None:
    """Hold each of ``errs`` to its GATES limit; keep the worst."""
    for gate, limit in GATES.items():
        check(math.isfinite(errs[gate]) and errs[gate] <= limit,
              f"{name}: kernel vs plain {gate} error {errs[gate]} > {limit}")
        worst[gate] = max(worst.get(gate, 0.0), errs[gate])


def kernel_vs_plain():
    """Phase 3, ragged attention: every case, bf16 and int8; returns
    {variant: {gate: the worst error}}."""
    cases = [(_case(spans, seed=i, all_true=all_true, **SMALL), q_tile,
              f"small#{i}")
             for i, (spans, q_tile, all_true) in enumerate(SMALL_LAYOUTS)]
    # The other head dims the kernel is built for, and 32-token q-tiles
    # (128 query rows per CTA, every warp its own rows).
    cases += [(_case(SMALL_LAYOUTS[i][0], seed=50 + i, **{**SMALL, "d": d}),
               16, f"d{d}#{i}") for i, d in ((2, 64), (3, 256))]
    cases.append((_case(MAIN_SPANS, seed=100, **MAIN), 16, "main"))
    cases.append((_case(MAIN_SPANS, seed=101, **MAIN), 32, "main-qt32"))
    worst = {v: dict.fromkeys(GATES, 0.0) for v in ("bf16", "int8")}
    for base, q_tile, name in cases:
        for variant in ("bf16", "int8"):
            case = base if variant == "bf16" else _quantized(base)
            out = ragged_paged_attention(**case, q_tile=q_tile)
            torch.cuda.synchronize()
            owned = _owned(case)
            errs = _errors(out, case, owned)
            torch.cuda.synchronize()
            unowned_zero = bool((out[~owned] == 0).all())
            log(f"  {name:9s} {variant}: " + " ".join(
                f"max_{k}_err={v:.3e}" for k, v in errs.items())
                + f" unowned_rows_zero={unowned_zero}")
            _gate(f"{name} {variant}", errs, worst[variant])
            check(unowned_zero, f"{name} {variant}: unowned rows not 0")
    return worst


# Flash forward cases. The CPU suite's (tests/test_torch_flash_attention.py):
# (b, h, hkv, sq, sk, causal, q_offset, window, left pads per batch row).
FLASH_SMALL = [
    (1, 2, 2, 384, 384, True, 0, 0, None),
    (1, 8, 2, 256, 256, True, 0, 0, None),
    (2, 4, 2, 384, 384, True, 0, 0, (100, 300)),
    (1, 2, 2, 256, 384, True, 128, 150, None),
    (1, 2, 1, 256, 384, False, 0, 0, None),
]
# The main-path prefill: one 512-token bucket, llama-3-8b heads, a prompt
# of 312 tokens left-padded by 200.
FLASH_MAIN = (1, 32, 8, 512, 512, True, 0, 0, (200,))
FLASH_CASES = [(c, 128, f"small#{i}") for i, c in enumerate(FLASH_SMALL)] + [
    (FLASH_MAIN, 128, "main-prefill"),
    # A continuation re-admitted at 528 rows (a multiple of 16, not 128).
    ((1, 32, 8, 528, 528, True, 0, 0, (17,)), 128, "continuation-528"),
    # Past the TPU's whole-K/V line (2·Sk·D·2 B > 4 MB): its streamed kernel.
    ((1, 32, 8, 16384, 16384, True, 0, 0, None), 128, "long-16384"),
    ((1, 32, 8, 1024, 1024, True, 0, 256, (64,)), 128, "window-256"),
    ((2, 8, 2, 300, 700, True, 400, 333, (0, 250)), 128, "window-q-offset"),
    ((1, 8, 2, 200, 200, True, 0, 0, (30,)), 64, "d64"),
    ((1, 8, 2, 200, 200, True, 0, 0, (30,)), 256, "d256"),
]
LSE_TOL = 1e-3


def _flash_case(shape, d, seed):
    b, h, hkv, sq, sk, causal, q_offset, window, pads = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=g, device=DEVICE).to(torch.bfloat16)

    kv_mask = None
    if pads is not None:
        kv_mask = (torch.arange(sk, device=DEVICE)[None, :]
                   >= torch.tensor(pads, device=DEVICE)[:, None])
    return dict(q=randn(b, h, sq, d), k=randn(b, hkv, sk, d),
                v=randn(b, hkv, sk, d), causal=causal, q_offset=q_offset,
                window=window, kv_mask=kv_mask)


def _flash_errors(out, lse, case) -> dict:
    """GATES errors of O against the plain version kept in f32, plus
    ``lse``: the worst |lse − ref| over rows that see a key, and whether
    every row that sees none has O = 0 and lse <= -1e29."""
    plain = {**case, **{n: case[n].float() for n in ("q", "k", "v")}}
    ref, ref_lse = flash_attention_reference(**plain)
    ref_abs, _ = flash_attention_reference(**{**plain, "v": plain["v"].abs()})
    errs = _diff_errors(out.float(), ref, ref_abs)
    has = ref_lse > NEG_INF / 2
    errs["lse"] = float((lse - ref_lse).abs()[has].max()) if has.any() else 0.0
    errs["keyless_rows_ok"] = bool((lse[~has] <= -1e29).all()
                                   and (out[~has] == 0).all())
    return errs


def flash_vs_plain():
    """Phase 3, flash forward; returns {gate: the worst error}."""
    worst: dict = {}
    for i, (shape, d, name) in enumerate(FLASH_CASES):
        case = _flash_case(shape, d, seed=200 + i)
        out, lse = flash_attention_fwd(**case)
        torch.cuda.synchronize()
        errs = _flash_errors(out, lse, case)
        torch.cuda.synchronize()
        log(f"  flash {name:17s}: " + " ".join(
            f"max_{k}_err={v:.3e}" for k, v in errs.items()
            if k != "keyless_rows_ok")
            + f" keyless_rows_ok={errs['keyless_rows_ok']}")
        _gate(f"flash {name}", errs, worst)
        check(errs["lse"] <= LSE_TOL,
              f"flash {name}: lse error {errs['lse']} > {LSE_TOL}")
        worst["lse"] = max(worst.get("lse", 0.0), errs["lse"])
        check(errs["keyless_rows_ok"],
              f"flash {name}: a row with no visible key is not 0 / NEG_INF")
        del case, out, lse
    return worst


# Paged decode cases. The CPU suite's layouts
# (tests/test_torch_paged_attention.py), then the main-path decode:
# llama-3-8b heads, 8 slots, block 16, the engine's 37-block tables,
# lengths 8..576 with a quarter of each history left padding.
DEC_SMALL = dict(hq=8, hkv=4, d=128, bs=16, maxb=6, nb=32)
DEC_MAIN = dict(hq=32, hkv=8, d=128, bs=16, maxb=37, nb=8 * 37 + 1)
DEC_MAIN_LENS = [int(x) for x in np.linspace(8, 576, 8)]
DEC_CASES = [
    ([17, 40, 96], DEC_SMALL, {}, "partial-tails"),
    ([1, 33, 96], DEC_SMALL, {"all_true": True}, "all-true"),
    ([60, 60, 60], DEC_SMALL, {"holes": True}, "holes"),
    ([30, 50, 90], {**DEC_SMALL, "hkv": 2}, {}, "gqa-4"),
    # An idle slot (table row 0, position 0, all-False mask) and a stale
    # length past MAXB·BS beside live ones.
    ([1, 10_000, 45], DEC_SMALL, {"idle": (0,)}, "idle-stale"),
    (DEC_MAIN_LENS, DEC_MAIN, {"pad_frac": 0.25}, "main-decode"),
    ([17, 40, 96], {**DEC_SMALL, "d": 64}, {}, "d64"),
    ([17, 40, 96], {**DEC_SMALL, "d": 256}, {}, "d256"),
]


def _decode_case(seq_lens, *, hq, hkv, d, bs, maxb, nb, seed, all_true=False,
                 holes=False, idle=(), pad_frac=0.0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = len(seq_lens)

    def randn(*size):
        return torch.randn(size, generator=g, device=DEVICE).to(torch.bfloat16)

    tables = torch.randperm(nb - 1, generator=g, device=DEVICE)[: b * maxb]
    tables = (tables + 1).reshape(b, maxb).to(torch.int32)
    seq = torch.tensor(seq_lens, dtype=torch.int32, device=DEVICE)
    k_pos = torch.arange(maxb * bs, device=DEVICE)[None, :]
    if all_true:
        kv_mask = torch.ones((b, maxb * bs), dtype=torch.bool, device=DEVICE)
    else:
        pads = (seq.float() * pad_frac).long()[:, None]
        kv_mask = (k_pos < seq[:, None]) & (k_pos >= pads)
    if holes:
        kv_mask[0, 5:9] = False
        kv_mask[1, 16:32] = False  # a wholly masked block
    for i in idle:
        tables[i] = 0
        seq[i] = 1
        kv_mask[i] = False
    return dict(q=randn(b, hq, d), k_pool=randn(nb, hkv, bs, d),
                v_pool=randn(nb, hkv, bs, d), tables=tables, kv_mask=kv_mask,
                seq_lens=seq, block_size=bs)


def _decode_vs_plain(label, cases, make_case, kernel, reference, kv_names):
    """Phase 3 for a decode kernel: each case through ``kernel`` and
    through ``reference`` on the same values in f32 (``kv_names`` the two
    K/V inputs); idle rows must be exactly 0. Returns {gate: the worst
    error}."""
    k_name, v_name = kv_names
    worst: dict = {}
    for i, (lens, shape, opts, name, seed) in enumerate(cases):
        case = make_case(lens, seed=seed, **shape, **opts)
        out = kernel(**case)
        torch.cuda.synchronize()
        plain = {**case, **{n: case[n].float() for n in ("q", k_name, v_name)}}
        ref = reference(**plain)
        ref_abs = reference(**{**plain, v_name: plain[v_name].abs()})
        errs = _diff_errors(out.float(), ref, ref_abs)
        finite = bool(torch.isfinite(out).all())
        idle_zero = all(bool((out[j] == 0).all()) for j in opts.get("idle", ()))
        log(f"  {label} {name:14s}: " + " ".join(
            f"max_{k}_err={v:.3e}" for k, v in errs.items())
            + f" finite={finite} idle_rows_zero={idle_zero}")
        _gate(f"{label} {name}", errs, worst)
        check(finite and idle_zero, f"{label} {name}: non-finite output or "
                                    "an idle row not exactly 0")
    return worst


def decode_vs_plain():
    """Phase 3, paged decode; returns {gate: the worst error}."""
    return _decode_vs_plain(
        "decode", [c + (300 + i,) for i, c in enumerate(DEC_CASES)],
        _decode_case, paged_decode_attention, paged_decode_reference,
        ("k_pool", "v_pool"))


# Dense decode cases. The CPU suite's layouts
# (tests/test_torch_dense_decode.py), then the main-path decode: llama-3-8b
# heads, 8 slots, the engine's cache of 1024 positions, lengths 8..576 with
# a quarter of each history left padding and the mask True past it, as the
# engine keeps it (the positional bound hides the rest).
DENSE_SMALL = dict(hq=8, hkv=4, d=128, c=256)
DENSE_MAIN = dict(hq=32, hkv=8, d=128, c=1024)
DENSE_CASES = [
    ([1, 100, 256], DENSE_SMALL, {"hole": (1, 10, 20)}, "hole"),
    ([17, 65, 130], DENSE_SMALL, {}, "partial-blocks"),
    ([40, 90, 200], DENSE_SMALL, {"pad_frac": 0.5}, "left-padding"),
    ([30, 50, 90], {**DENSE_SMALL, "hkv": 2}, {}, "gqa-4"),
    ([1, 256, 77], DENSE_SMALL, {"idle": (0,)}, "idle-and-full"),
    (DEC_MAIN_LENS, DENSE_MAIN, {"pad_frac": 0.25}, "main-decode"),
    (DEC_MAIN_LENS, DENSE_MAIN, {"pad_frac": 0.25, "hole": (5, 300, 364)},
     "main-hole"),
    ([1] + DEC_MAIN_LENS[1:], DENSE_MAIN, {"pad_frac": 0.25, "idle": (0,)},
     "main-idle"),
    ([1024] + DEC_MAIN_LENS[1:], DENSE_MAIN, {"pad_frac": 0.25},
     "main-full"),
    ([17, 65, 130], {**DENSE_SMALL, "d": 64}, {}, "d64"),
    ([17, 65, 130], {**DENSE_SMALL, "d": 256}, {}, "d256"),
]


def _dense_case(seq_lens, *, hq, hkv, d, c, seed, hole=None, idle=(),
                pad_frac=0.0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = len(seq_lens)

    def randn(*size):
        return torch.randn(size, generator=g, device=DEVICE).to(torch.bfloat16)

    seq = torch.tensor(seq_lens, dtype=torch.int32, device=DEVICE)
    pads = (seq.float() * pad_frac).long()[:, None]
    kv_mask = torch.arange(c, device=DEVICE)[None, :] >= pads
    if hole is not None:
        row, lo, hi = hole
        kv_mask[row, lo:hi] = False
    for i in idle:
        seq[i] = 1
        kv_mask[i] = False
    return dict(q=randn(b, hq, d), k_cache=randn(b, hkv, c, d),
                v_cache=randn(b, hkv, c, d), kv_mask=kv_mask, seq_lens=seq,
                block_size=256)


def dense_vs_plain():
    """Phase 3, dense decode; returns {gate: the worst error}."""
    return _decode_vs_plain(
        "dense", [c + (600 + i,) for i, c in enumerate(DENSE_CASES)],
        _dense_case, dense_decode_attention, dense_decode_reference,
        ("k_cache", "v_cache"))


# ---------------------------------------------------------------------------
# Timing


def _spin_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call by CUDA events, the 50 MB L2 flushed
    before each (the engine finds each layer's pool cold). A spin kernel
    queued ahead of each call keeps the card busy, for three times as long
    as the host takes to queue the call, so the events time the card's
    work and not the host's Python."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int((3 * host_ms + 1.0) * _spin_cycles_per_ms())
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _bound(case) -> tuple[float, str, dict]:
    """Least time for this case's work: each input byte read once (live
    K/V blocks, their scales, q, metadata) and the output written once,
    over HBM bandwidth; 4·Σ rows·visible keys·Hq·D FLOPs over the bf16
    peak. Visible keys follow this run's mask and positions."""
    q = case["q"]
    t, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    quant = case.get("k_scale_pool") is not None
    elem = 1 if quant else 2
    mask = case["kv_mask"].cpu().numpy()
    starts = case["seq_starts"].tolist()
    lens = case["seq_lens"].tolist()
    kvls = case["kv_lens"].tolist()
    live_blocks = 0
    visible = 0
    for s, (s0, n, kvl) in enumerate(zip(starts, lens, kvls)):
        if n == 0:
            continue
        live_blocks += -(-kvl // bs)
        cum = np.cumsum(mask[s])
        for j in range(n):
            visible += int(cum[kvl - n + j])
    kv_bytes = live_blocks * hkv * bs * d * elem * 2
    if quant:
        kv_bytes += live_blocks * hkv * bs * 2 * 2
    meta = sum(case[k].numel() * case[k].element_size()
               for k in ("tables", "kv_mask", "seq_starts", "seq_lens",
                         "kv_lens"))
    nbytes = kv_bytes + 2 * t * hq * d * 2 + meta
    flops = 4 * visible * hq * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_flops)
    return bound, ("bytes" if t_bytes >= t_flops else "operations"), {
        "bytes": nbytes, "flops": flops}


def _library_call(case):
    """One SDPA call over a per-slot batched view: slot s's query rows,
    padded to the longest span, against its own MAXB·BS gathered keys, with
    the same validity rule as a boolean mask. The gather (and int8
    dequant) is set-up, untimed. Checks once that the call computes the
    kernel's function on the owned rows."""
    q, tables, mask = case["q"], case["tables"].long(), case["kv_mask"]
    _, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    s, maxb = tables.shape
    length = maxb * bs
    spans = list(zip(case["seq_starts"].tolist(), case["seq_lens"].tolist(),
                     case["kv_lens"].tolist()))
    rows = max(n for _, n, _ in spans)

    def dense(pool, scale):
        g = pool[tables]  # (S, MAXB, Hkv, BS, D)
        if scale is not None:
            g = (g.float() * scale[tables].float()[..., None]).to(q.dtype)
        g = g.permute(0, 2, 1, 3, 4).reshape(s, hkv, length, d)
        return g.repeat_interleave(hq // hkv, dim=1)  # q head i → i // G

    k = dense(case["k_pool"], case.get("k_scale_pool"))
    v = dense(case["v_pool"], case.get("v_scale_pool"))
    qd = torch.zeros((s, hq, rows, d), dtype=q.dtype, device=DEVICE)
    allowed = torch.zeros((s, 1, rows, length), dtype=torch.bool,
                          device=DEVICE)
    k_pos = torch.arange(length, device=DEVICE)
    for si, (s0, n, kvl) in enumerate(spans):
        qd[si, :, :n] = q[s0:s0 + n].transpose(0, 1)
        last = kvl - n + torch.arange(n, device=DEVICE)
        allowed[si, 0, :n] = mask[si][None, :] & (k_pos[None, :]
                                                  <= last[:, None])

    def call():
        return F.scaled_dot_product_attention(qd, k, v, attn_mask=allowed)

    out = call()
    ref = ragged_attention_reference(**{**case, "q": q.float()})
    for si, (s0, n, _) in enumerate(spans):
        err = float((out[si, :, :n].transpose(0, 1).float()
                     - ref[s0:s0 + n]).abs().max()) if n else 0.0
        check(err <= TOL, f"library yardstick differs from the plain "
                          f"version by {err} on slot {si}")
    return call


def timing():
    """Phase 4: the main-path shape, bf16 and int8."""
    base = _case(MAIN_SPANS, seed=100, **MAIN)
    rows = {}
    for variant in ("bf16", "int8"):
        case = base if variant == "bf16" else _quantized(base)
        saved = ragged_paged_attention.launches
        kernel_ms = _time_ms(lambda: ragged_paged_attention(**case))
        ragged_paged_attention.launches = saved  # timing is no main path
        plain_ms = _time_ms(lambda: ragged_attention_reference(**case))
        library_ms = _time_ms(_library_call(case))
        bound_ms, bound_by, work = _bound(case)
        rows[variant] = dict(ms=kernel_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by, **work)
        log(f"  {variant}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {work['bytes']} B, {work['flops']} FLOP)")
    return rows


def _bound_of(nbytes: int, flops: int) -> tuple[float, str, dict]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_flops), (
        "bytes" if t_bytes >= t_flops else "operations"), {
        "bytes": nbytes, "flops": flops}


def _flash_visible(case, b: int) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query row of batch row ``b`` sees."""
    sq, sk = case["q"].shape[2], case["k"].shape[2]
    q_pos = torch.arange(sq, device=DEVICE)[:, None] + case["q_offset"]
    k_pos = torch.arange(sk, device=DEVICE)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=DEVICE)
    if case["causal"]:
        vis = vis & (k_pos <= q_pos)
    if case["window"]:
        vis = vis & (k_pos > q_pos - case["window"])
    if case["kv_mask"] is not None:
        vis = vis & case["kv_mask"][b][None, :]
    return vis


def _flash_bound(case):
    """Least time: q, k, v and the mask read once, O and lse written once,
    over HBM bandwidth; 4·D FLOPs for each visible (row, key) pair of each
    q head (this run's causal bound, window and mask) over the bf16 peak."""
    q, k = case["q"], case["k"]
    b, h, sq, d = q.shape
    pairs = sum(int(_flash_visible(case, i).sum()) for i in range(b)) * h
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * sq
    if case["kv_mask"] is not None:
        nbytes += case["kv_mask"].numel()
    return _bound_of(nbytes, 4 * pairs * d)


def _flash_library_call(case):
    """One SDPA call with ``enable_gqa`` and the visibility as a boolean
    mask; checked once against the plain version on rows that see a
    key (SDPA gives NaN on rows that see none)."""
    q, k, v = case["q"], case["k"], case["v"]
    b = q.shape[0]
    allowed = torch.stack([_flash_visible(case, i) for i in range(b)])[:, None]

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                              enable_gqa=True)

    out = call()
    ref, ref_lse = flash_attention_reference(
        **{**case, **{n: case[n].float() for n in ("q", "k", "v")}})
    has = ref_lse > NEG_INF / 2
    err = float((out.float() - ref).abs()[has].max())
    check(err <= TOL, f"flash library yardstick differs from the plain "
                      f"version by {err}")
    return call


def timing_flash():
    """Phase 4, flash forward: the main-path prefill, and the long shape
    (kernel and library only: the plain version there is a yardstick of
    nothing and takes seconds)."""
    rows = {}
    by_name = {name: (shape, d) for shape, d, name in FLASH_CASES}
    for name, iters in (("main-prefill", 20), ("long-16384", 5)):
        case = _flash_case(*by_name[name], seed=400)
        saved = flash_attention_fwd.launches
        kernel_ms = _time_ms(lambda: flash_attention_fwd(**case), iters=iters)
        flash_attention_fwd.launches = saved  # timing is no main path
        plain_ms = (_time_ms(lambda: flash_attention_reference(**case))
                    if name == "main-prefill" else None)
        library_ms = _time_ms(_flash_library_call(case), iters=iters)
        bound_ms, bound_by, work = _flash_bound(case)
        rows[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, **work)
        log(f"  flash {name}: kernel {kernel_ms:.4f} ms, plain "
            f"{plain_ms if plain_ms is None else round(plain_ms, 4)} ms, "
            f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; {work['bytes']} B, {work['flops']} FLOP)")
        del case
    return rows


def _decode_visible(case) -> torch.Tensor:
    """(B, MAXB·BS) or (B, C) bool: the keys each slot's query sees."""
    k_pos = torch.arange(case["kv_mask"].shape[1], device=DEVICE)
    return case["kv_mask"] & (k_pos[None, :] < case["seq_lens"].long()[:, None])


def _decode_bound(case):
    """Least time: the K and V rows of each slot's visible keys (kv_mask ∧
    k_pos < seq_len), the table entries and mask bytes of its live prefix,
    q and seq_lens read once, the output written once, over HBM bandwidth;
    4·D FLOPs per visible (slot, key) pair of each q head over the bf16
    peak."""
    q, tables = case["q"], case["tables"]
    b, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    maxb = tables.shape[1]
    prefix = [min(n, maxb * bs) for n in case["seq_lens"].tolist()]
    blocks = sum(-(-n // bs) for n in prefix)
    keys = int(_decode_visible(case).sum())
    nbytes = (keys * hkv * d * 2 * 2 + blocks * tables.element_size()
              + sum(prefix) + 2 * q.numel() * 2
              + case["seq_lens"].numel() * 4)
    return _bound_of(nbytes, 4 * keys * hq * d)


def _decode_library_call(case):
    """One SDPA call over the per-slot gathered view (gather untimed) with
    ``enable_gqa`` and the validity as a boolean mask; checked once
    against the plain version."""
    q, tables = case["q"], case["tables"].long()
    b, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    length = tables.shape[1] * bs

    def dense(pool):
        return pool[tables].permute(0, 2, 1, 3, 4).reshape(b, hkv, length, d)

    k, v = dense(case["k_pool"]), dense(case["v_pool"])
    qd = q[:, :, None, :]
    allowed = _decode_visible(case)[:, None, None, :]

    def call():
        return F.scaled_dot_product_attention(qd, k, v, attn_mask=allowed,
                                              enable_gqa=True)

    out = call()[:, :, 0]
    ref = paged_decode_reference(**{**case, "q": q.float()})
    err = float((out.float() - ref.float()).abs().max())
    check(err <= TOL, f"decode library yardstick differs from the plain "
                      f"version by {err}")
    return call


def _timing_decode(label, case, kernel, reference, library_call, bound):
    """Phase 4 for a decode kernel at one case: the kernel, its plain
    version, the library call and the bound."""
    saved = kernel.launches
    kernel_ms = _time_ms(lambda: kernel(**case))
    kernel.launches = saved  # timing is no main path
    plain_ms = _time_ms(lambda: reference(**case))
    library_ms = _time_ms(library_call(case))
    bound_ms, bound_by, work = bound(case)
    log(f"  {label} main: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {work['bytes']} B, {work['flops']} FLOP)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, **work)


def timing_decode():
    """Phase 4, paged decode at the main-path decode shape."""
    return _timing_decode(
        "decode", _decode_case(DEC_MAIN_LENS, seed=500, pad_frac=0.25,
                               **DEC_MAIN),
        paged_decode_attention, paged_decode_reference,
        _decode_library_call, _decode_bound)


def _dense_bound(case):
    """Least time: the K and V rows of each slot's visible keys (kv_mask ∧
    k_pos < seq_len), the mask bytes of its live prefix (its first
    min(seq_len, C) columns), q and seq_lens read once, the output written
    once, over HBM bandwidth; 4·D FLOPs per visible (slot, key) pair of
    each q head over the bf16 peak."""
    q = case["q"]
    b, hq, d = q.shape
    _, hkv, c, _ = case["k_cache"].shape
    prefix = sum(min(n, c) for n in case["seq_lens"].tolist())
    keys = int(_decode_visible(case).sum())
    nbytes = (keys * hkv * d * 2 * 2 + prefix + 2 * q.numel() * 2
              + case["seq_lens"].numel() * 4)
    return _bound_of(nbytes, 4 * keys * hq * d)


def _dense_library_call(case):
    """One SDPA call with ``enable_gqa`` over ``cache[:, :, :max_len]``
    (the longest live prefix) with the validity as a boolean mask; checked
    once against the plain version."""
    q = case["q"]
    max_len = min(int(case["seq_lens"].max()), case["k_cache"].shape[2])
    k = case["k_cache"][:, :, :max_len]
    v = case["v_cache"][:, :, :max_len]
    qd = q[:, :, None, :]
    allowed = _decode_visible(case)[:, None, None, :max_len]

    def call():
        return F.scaled_dot_product_attention(qd, k, v, attn_mask=allowed,
                                              enable_gqa=True)

    out = call()[:, :, 0]
    ref = dense_decode_reference(**{**case, "q": q.float()})
    err = float((out.float() - ref.float()).abs().max())
    check(err <= TOL, f"dense library yardstick differs from the plain "
                      f"version by {err}")
    return call


def timing_dense():
    """Phase 4, dense decode at the main-path decode shape."""
    return _timing_decode(
        "dense", _dense_case(DEC_MAIN_LENS, seed=700, pad_frac=0.25,
                             **DENSE_MAIN),
        dense_decode_attention, dense_decode_reference,
        _dense_library_call, _dense_bound)


# ---------------------------------------------------------------------------
# Engines


def _zero_counts() -> None:
    for wrapper in (ragged_paged_attention, flash_attention_fwd,
                    paged_decode_attention, dense_decode_attention):
        wrapper.launches = 0


def _counts() -> dict:
    return {"ragged": ragged_paged_attention.launches,
            "flash": flash_attention_fwd.launches,
            "decode": paged_decode_attention.launches,
            "dense": dense_decode_attention.launches}


def _prompts(cfg, n: int, lo: int, hi: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    return [rng.integers(3, cfg.vocab_size, size=int(m)).tolist()
            for m in lengths]


def _engine(params, cfg, kv_bits: int, attn_kernel=None, ragged=True):
    return PagedBatcher(
        params, cfg, gen=GenerationConfig(max_new_tokens=64, eos_id=-1),
        slots=8, num_blocks=8 * 37 + 24, block_size=16, prompt_bucket=512,
        ragged=ragged, token_budget=512 if ragged else None,
        kv_bits=kv_bits, attn_kernel=attn_kernel, device=DEVICE,
    )


def _cont_engine(params, cfg, attn_kernel=None, admit_chunk=None):
    return ContinuousBatcher(
        params, cfg, gen=GenerationConfig(max_new_tokens=64, eos_id=-1),
        slots=8, cache_len=1024, prompt_bucket=512, attn_kernel=attn_kernel,
        admit_chunk=admit_chunk, device=DEVICE,
    )


@contextlib.contextmanager
def _counting_calls(module, *names):
    """Count the calls of ``module.<name>`` for each name while inside;
    yields {name: calls}. The engines look these functions up in their
    module at each call, so the wrappers see every one."""
    calls = dict.fromkeys(names, 0)
    real = {n: getattr(module, n) for n in names}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(module, name, real[name])


@contextlib.contextmanager
def _plain_prefill(module, name):
    """An engine's admissions (``module.<name>``) with ``impl="xla"``: the
    plain flash attention on the card."""
    real = getattr(module, name)
    setattr(module, name, functools.partial(real, attn_impl="xla"))
    try:
        yield
    finally:
        setattr(module, name, real)


def _serve(engine, prompts):
    rids = [engine.submit(p) for p in prompts]
    out = engine.run()
    lps = engine.run_logprobs()
    return [out[r] for r in rids], [lps[r] for r in rids]


def _check_outputs(cfg, toks, lps) -> None:
    for tk, lp in zip(toks, lps):
        check(len(tk) == 64 and len(lp) == 64, "a request stopped early")
        check(all(0 <= x < cfg.vocab_size for x in tk), "token off vocab")
        check(all(math.isfinite(x) and x <= 1e-4 for x in lp),
              "non-finite or positive logprob")


def _compare(kern, plain) -> dict:
    """Tokens equal, or a fork after the first token with the chosen-token
    logprobs before it within TOL. Returns per prompt the fork position
    (-1: none), the largest logprob gap before it, and the two engines'
    chosen-token logprobs at the fork (close values mean a near-tie)."""
    report = []
    for (kt, kl), (pt, pl) in zip(zip(*kern), zip(*plain)):
        fork = next((i for i, (a, b) in enumerate(zip(kt, pt)) if a != b),
                    -1)
        check(fork != 0, "kernel and plain engines disagree on the first "
                         "token")
        upto = len(kt) if fork < 0 else fork
        diff = max((abs(a - b) for a, b in zip(kl[:upto], pl[:upto])),
                   default=0.0)
        check(diff <= TOL, f"chosen-token logprobs differ by {diff} before "
                           f"the fork at {fork}")
        report.append({"fork": fork, "max_logprob_diff": diff,
                       "at_fork": None if fork < 0 else [kl[fork], pl[fork]]})
    return report


def engine_phase(params, cfg):
    """Phase 5, the ragged engine: returns ({variant: launches}, the bf16
    engine)."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    launches, engines = {}, {}
    for variant, bits in (("bf16", 0), ("int8", 8)):
        engine = _engine(params, cfg, bits)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
        launches[variant] = counts["ragged"]
        steps = engine.ragged_steps
        check(steps > 0, "the engine ran no step")
        check(launches[variant] == steps * cfg.n_layers,
              f"{variant}: {launches[variant]} kernel launches for {steps} "
              f"ragged steps × {cfg.n_layers} layers")
        check(counts["flash"] == counts["decode"] == counts["dense"] == 0,
              f"{variant}: the ragged engine launched {counts}")
        _check_outputs(cfg, toks, lps)
        n_tok = sum(len(tk) for tk in toks)
        peak = torch.cuda.max_memory_allocated()
        log(f"  ragged {variant}: {steps} steps, {engine.ragged_tokens} rows,"
            f" {n_tok} tokens out, {wall:.3f} s wall, {launches[variant]} "
            f"kernel launches, peak {peak / 2**30:.2f} GiB")
        # Kernel vs plain attention on the same 4 prompts and schedule.
        sub = prompts[::4]
        kern = _serve(_engine(params, cfg, bits), sub)
        plain = _serve(_engine(params, cfg, bits, attn_kernel=False), sub)
        report = _compare(kern, plain)
        log(f"  ragged {variant}: kernel vs plain engine on 4 prompts "
            f"(fork -1 = tokens equal): {json.dumps(report)}")
        traced = _engine(params, cfg, bits)
        trace = _trace(traced, prompts[::2], {"attention": "ragged_kernel"})
        trace["steps"] = traced.ragged_steps
        log(f"  ragged {variant}: traced rerun of 8 prompts: "
            f"{json.dumps(trace)}")
        engines[variant] = engine
    return launches, engines["bf16"]


def alternating_phase(params, cfg):
    """Phase 5, the alternating engine with a bf16 pool: returns
    ({"flash": launches, "decode": launches}, the engine)."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    engine = _engine(params, cfg, 0, ragged=False)
    check(engine.attn_kernel, "the alternating engine's decode kernel is off")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting_calls(paged_mod, "_paged_admit", "_paged_step") as calls:
        _zero_counts()
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
    admits, steps = calls["_paged_admit"], calls["_paged_step"]
    check(admits > 0 and steps > 0, "the engine ran no admission or step")
    check(counts["flash"] == admits * cfg.n_layers,
          f"{counts['flash']} flash launches for {admits} admissions × "
          f"{cfg.n_layers} layers")
    check(counts["decode"] == steps * cfg.n_layers,
          f"{counts['decode']} decode launches for {steps} steps × "
          f"{cfg.n_layers} layers")
    check(counts["ragged"] == counts["dense"] == 0,
          f"the alternating engine launched {counts}")
    _check_outputs(cfg, toks, lps)
    n_tok = sum(len(tk) for tk in toks)
    peak = torch.cuda.max_memory_allocated()
    log(f"  alternating bf16: {admits} admissions, {steps} decode steps, "
        f"{n_tok} tokens out, {wall:.3f} s wall, {counts['flash']} flash and "
        f"{counts['decode']} decode launches, peak {peak / 2**30:.2f} GiB")
    sub = prompts[::4]
    kern = _serve(_engine(params, cfg, 0, ragged=False), sub)
    with _plain_prefill(paged_mod, "_paged_admit"):
        plain = _serve(_engine(params, cfg, 0, ragged=False,
                               attn_kernel=False), sub)
    report = _compare(kern, plain)
    log(f"  alternating bf16: kernels vs plain engine on 4 prompts "
        f"(fork -1 = tokens equal): {json.dumps(report)}")
    with _counting_calls(paged_mod, "_paged_admit", "_paged_step") as calls:
        trace = _trace(_engine(params, cfg, 0, ragged=False), prompts[::2],
                       {"flash": "flash_fwd_kernel",
                        "decode": "paged_decode_kernel"})
    trace["admissions"] = calls["_paged_admit"]
    trace["steps"] = calls["_paged_step"]
    log(f"  alternating bf16: traced rerun of 8 prompts: {json.dumps(trace)}")
    return {"flash": counts["flash"], "decode": counts["decode"]}, engine


def continuous_phase(params, cfg):
    """Phase 5, the continuous engine with a bf16 cache of 1024 positions
    per slot: returns ({"flash": launches, "dense": launches}, the
    engine)."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    engine = _cont_engine(params, cfg)
    check(engine._attn_kernel == 512,
          f"the continuous engine's dense kernel is off "
          f"(block size {engine._attn_kernel})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting_calls(cont_mod, "_admit_slot", "_cb_step") as calls:
        _zero_counts()
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
    admits, steps = calls["_admit_slot"], calls["_cb_step"]
    check(admits > 0 and steps > 0, "the engine ran no admission or step")
    check(counts["flash"] == admits * cfg.n_layers,
          f"{counts['flash']} flash launches for {admits} admissions × "
          f"{cfg.n_layers} layers")
    check(counts["dense"] == steps * cfg.n_layers,
          f"{counts['dense']} dense decode launches for {steps} steps × "
          f"{cfg.n_layers} layers")
    check(counts["ragged"] == counts["decode"] == 0,
          f"the continuous engine launched {counts}")
    _check_outputs(cfg, toks, lps)
    n_tok = sum(len(tk) for tk in toks)
    peak = torch.cuda.max_memory_allocated()
    log(f"  continuous bf16: {admits} admissions, {steps} decode steps, "
        f"{n_tok} tokens out, {wall:.3f} s wall, {counts['flash']} flash and "
        f"{counts['dense']} dense decode launches, peak "
        f"{peak / 2**30:.2f} GiB")
    sub = prompts[::4]
    kern = _serve(_cont_engine(params, cfg), sub)
    with _plain_prefill(cont_mod, "_admit_slot"):
        plain = _serve(_cont_engine(params, cfg, attn_kernel=False), sub)
    report = _compare(kern, plain)
    log(f"  continuous bf16: kernels vs plain engine on 4 prompts "
        f"(fork -1 = tokens equal): {json.dumps(report)}")
    chunked = _serve(_cont_engine(params, cfg, admit_chunk=128), sub)
    report = _compare(kern, chunked)
    log(f"  continuous bf16: one-shot vs admit_chunk=128 on 4 prompts "
        f"(fork -1 = tokens equal): {json.dumps(report)}")
    with _counting_calls(cont_mod, "_admit_slot", "_cb_step") as calls:
        trace = _trace(_cont_engine(params, cfg), prompts[::2],
                       {"flash": "flash_fwd_kernel",
                        "decode": "dense_decode_kernel"})
    trace["admissions"] = calls["_admit_slot"]
    trace["steps"] = calls["_cb_step"]
    log(f"  continuous bf16: traced rerun of 8 prompts: {json.dumps(trace)}")
    return {"flash": counts["flash"], "dense": counts["dense"]}, engine


def _busy_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals (us), in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def _trace(engine, prompts, kernels: dict) -> dict:
    """Serve the prompts under ``torch.profiler`` (card activity only) and
    read that one run: its wall seconds, the card's busy seconds (the
    union of kernel intervals), the idle share 1 − busy/wall, each of
    ``kernels``' ({label: name substring}) device seconds and share of
    busy time, and the six largest kernels' device seconds. The
    profiler's own cost on the host stretches this run's wall, so its
    idle share is an upper bound for an untraced run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name: dict[str, float] = {}
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e6)
            intervals.append((ev.time_range.start, ev.time_range.end))
    busy = _busy_seconds(intervals)
    check(busy > 0, "the trace holds no kernel on the card")
    out = {"wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall}
    for label, needle in kernels.items():
        seconds = sum(v for k, v in by_name.items() if needle in k)
        check(seconds > 0, f"the trace holds no {needle} on the card")
        out[f"{label}_s"] = seconds
        out[f"{label}_share_of_busy"] = seconds / busy
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["top_kernels_s"] = [[k[:60], v] for k, v in top]
    return out


# ---------------------------------------------------------------------------
# HTTP


def _post(port: int, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read().decode()
    if not body.get("stream"):
        return json.loads(raw)["choices"][0]["tokens"]
    events = [line[len("data: "):] for line in raw.splitlines()
              if line.startswith("data: ")]
    check(events and events[-1] == "[DONE]", "stream did not end with [DONE]")
    out = [json.loads(e) for e in events[:-1]]
    check(all("token" in e for e in out), f"stream carried an error: {out}")
    return [e["token"] for e in out]


def http_phase(engine, label: str):
    """Phase 6: 2 prompts × (blocking, streamed), all 4 at once. On the
    ragged engine two-token prompts keep every dispatch at the 8-row
    floor; on the alternating and continuous ones every admission is one
    (1, 512) prefill and every step runs all 8 slots: either way a
    streamed copy and a blocking copy run at one width and must agree
    token for token."""
    srv = InferenceServer(engine, port=0, model_name="llama-3-8b",
                          drain_s=30.0).start()
    try:
        prompts = [[128000, 9906], [128000, 791]]
        bodies = [{"prompt": p, "max_tokens": 16, "stream": stream}
                  for p in prompts for stream in (False, True)]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            results = list(pool.map(lambda b: _post(srv.port, b), bodies))
        for i in range(0, 4, 2):
            check(len(results[i]) == 16, "blocking response length")
            check(results[i] == results[i + 1],
                  f"streamed {results[i + 1]} != blocking {results[i]}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
        check(stats["served"] == 4, f"/stats served {stats['served']} != 4")
        log(f"  {label}: 4 completions ok; /stats: served={stats['served']} "
            f"tokens_generated={stats['tokens_generated']} "
            f"ttft_s={stats['ttft_s']} ragged={stats.get('ragged')}")
    finally:
        srv.stop()


# ---------------------------------------------------------------------------


def main() -> int:
    # One card, the first visible one, set before CUDA starts: the process
    # drives and counts one card however many the host has.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card_id = "0" if visible is None else visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card_id
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    phases = {}

    log("[1/6] card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", card_id, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    phases["card"] = time.monotonic() - t_start

    log("[2/6] build")
    t0 = time.monotonic()
    seconds = _build.build()
    for name, took in seconds.items():
        for line in _build.log_path(name).read_text().splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
        log(f"  {name}: library already built" if took is None
            else f"  {name}: nvcc took {took:.2f} s")
    phases["build"] = time.monotonic() - t0

    log("[3/6] kernel vs plain")
    t0 = time.monotonic()
    errors = kernel_vs_plain()
    flash_errors = flash_vs_plain()
    decode_errors = decode_vs_plain()
    dense_errors = dense_vs_plain()
    phases["kernel_vs_plain"] = time.monotonic() - t0

    log("[4/6] timing at the main-path shapes")
    t0 = time.monotonic()
    times = timing()
    flash_times = timing_flash()
    decode_times = timing_decode()
    dense_times = timing_dense()
    phases["timing"] = time.monotonic() - t0

    log("[5/6] engines: llama-3-8b, full width and depth, random weights")
    t0 = time.monotonic()
    cfg = L.LLAMA_CONFIGS["llama-3-8b"]
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    log(f"  init {cfg.param_count() / 1e9:.2f}B params in "
        f"{time.monotonic() - t0:.2f} s")
    launches, engine = engine_phase(params, cfg)
    alt_launches, alt_engine = alternating_phase(params, cfg)
    cont_launches, cont_engine = continuous_phase(params, cfg)
    phases["engine"] = time.monotonic() - t0

    log("[6/6] HTTP")
    t0 = time.monotonic()
    http_phase(engine, "ragged")
    http_phase(alt_engine, "alternating")
    http_phase(cont_engine, "continuous")
    phases["http"] = time.monotonic() - t0

    def entry(name, source, replaces, launched, errs, timed, **extra):
        return {
            "name": name, **extra, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": errs["abs"], "max_rel_err": errs["rel"],
            "max_row_rel_err": errs["row_rel"],
            **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        }

    long_run = flash_times["long-16384"]
    kernels = [
        entry("ragged_paged_attention",
              "kubeflow_tpu_torch/csrc/ragged_attention.cu",
              "kubeflow_tpu/ops/ragged_attention.py:330", launches[variant],
              errors[variant], times[variant], variant=variant)
        for variant in ("bf16", "int8")
    ] + [
        entry("flash_attention", "kubeflow_tpu_torch/csrc/flash_attention.cu",
              "kubeflow_tpu/ops/attention.py:301", alt_launches["flash"],
              flash_errors, flash_times["main-prefill"],
              also_replaces="kubeflow_tpu/ops/attention.py:547",
              launches_continuous=cont_launches["flash"],
              max_lse_err=flash_errors["lse"],
              long_16384={k: long_run[k] for k in (
                  "ms", "library_ms", "bound_ms", "bound_by")}),
        entry("paged_decode_attention",
              "kubeflow_tpu_torch/csrc/paged_attention.cu",
              "kubeflow_tpu/ops/paged_attention.py:233",
              alt_launches["decode"], decode_errors, decode_times),
        entry("dense_decode_attention",
              "kubeflow_tpu_torch/csrc/paged_attention.cu",
              "kubeflow_tpu/ops/paged_attention.py:298",
              cont_launches["dense"], dense_errors, dense_times),
    ]
    phases["total"] = time.monotonic() - t_start
    log(f"phases (s): {json.dumps({k: round(v, 2) for k, v in phases.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
