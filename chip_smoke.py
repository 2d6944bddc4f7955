#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is ragged paged serving of ``llama-3-8b`` at full width and
depth (random weights from a seed): ``PagedBatcher(ragged=True)`` behind
``InferenceServer``, whose every engine step runs the hand-written CUDA
kernel ``kubeflow_tpu_torch/csrc/ragged_attention.cu`` in each layer.
Phases, in order; any failure raises and the script exits non-zero:

1. card — needs ``torch.cuda.is_available()`` and drives one card (the
   first visible one); prints the card's ``nvidia-smi`` name and power
   limit; turns TF32 off;
2. build — compiles the kernel with ``nvcc`` and prints ptxas's register /
   shared-memory / spill lines;
3. kernel vs plain — the kernel's wrapper against its plain PyTorch
   version (kept in f32) on the same inputs, on the span layouts of the
   CPU suite and one main-path shape, bf16 and int8 pools: on owned rows
   max abs error <= 2e-2; element by element
   ``|out - ref| <= 2^-7 · (|ref| + ref_abs)``, where ``ref_abs`` is the
   plain version over ``|v|`` (the size of the weighted sum before any
   cancellation); for each row and q head ``‖out - ref‖ <= 2^-6 · ‖ref‖``
   over the head dim; unowned rows exactly 0;
4. timing — CUDA events at the main-path shape (L2 flushed between
   launches): the kernel, the plain version, and one library call
   (``scaled_dot_product_attention`` over a per-slot batched view, a
   yardstick the port never calls), beside the least time the card could
   take (bytes over 3.35 TB/s, FLOPs over 989 TFLOP/s);
5. engine — 16 prompts of 8..500 tokens, 64 new tokens each, once with a
   bf16 pool and once with ``kv_bits=8``; each kernel's launch count is
   zeroed just before the run and must equal ``ragged_steps × n_layers``
   after it; 4 prompts are then served again with the kernel and with the
   plain attention and compared (tokens equal, or a fork after the first
   token with chosen-token logprobs before it within 2e-2); last, the 16
   prompts are served once more under ``torch.profiler``, and that one
   run's trace gives the card's busy time, idle share and time by kernel;
6. HTTP — 4 concurrent ``/v1/completions`` (2 streamed) against the
   server over the bf16 engine; streamed tokens must equal the blocking
   response for the same prompt; then ``/stats`` and a clean stop.

It prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
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

from kubeflow_tpu_torch.models import llama as L
from kubeflow_tpu_torch.models.llama import _kv_quantize
from kubeflow_tpu_torch.models.paged import PagedBatcher
from kubeflow_tpu_torch.models.server import InferenceServer
from kubeflow_tpu_torch.models.serving import GenerationConfig
from kubeflow_tpu_torch.ops import _build
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
    diff = (out.float()[owned] - ref).abs()
    rel = diff / (ref.abs() + ref_abs).clamp_min(1e-30)
    row_rel = (torch.linalg.vector_norm(diff, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30))
    return {"abs": float(diff.max()), "rel": float(rel.max()),
            "row_rel": float(row_rel.max())}


def kernel_vs_plain():
    """Phase 3: every case, bf16 and int8; returns {variant: {gate: the
    worst error}}."""
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
            for gate, limit in GATES.items():
                check(math.isfinite(errs[gate]) and errs[gate] <= limit,
                      f"{name} {variant}: kernel vs plain {gate} error "
                      f"{errs[gate]} > {limit}")
                worst[variant][gate] = max(worst[variant][gate], errs[gate])
            check(unowned_zero, f"{name} {variant}: unowned rows not 0")
    return worst


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


# ---------------------------------------------------------------------------
# Engine


def _prompts(cfg, n: int, lo: int, hi: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    return [rng.integers(3, cfg.vocab_size, size=int(m)).tolist()
            for m in lengths]


def _engine(params, cfg, kv_bits: int, attn_kernel=None):
    return PagedBatcher(
        params, cfg, gen=GenerationConfig(max_new_tokens=64, eos_id=-1),
        slots=8, num_blocks=8 * 37 + 24, block_size=16, prompt_bucket=512,
        ragged=True, token_budget=512, kv_bits=kv_bits,
        attn_kernel=attn_kernel, device=DEVICE,
    )


def _serve(engine, prompts):
    rids = [engine.submit(p) for p in prompts]
    out = engine.run()
    lps = engine.run_logprobs()
    return [out[r] for r in rids], [lps[r] for r in rids]


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
    """Phase 5: returns ({variant: launches}, the bf16 engine)."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    launches, engines = {}, {}
    for variant, bits in (("bf16", 0), ("int8", 8)):
        engine = _engine(params, cfg, bits)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ragged_paged_attention.launches = 0
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches[variant] = ragged_paged_attention.launches
        steps = engine.ragged_steps
        check(steps > 0, "the engine ran no step")
        check(launches[variant] == steps * cfg.n_layers,
              f"{variant}: {launches[variant]} kernel launches for {steps} "
              f"ragged steps × {cfg.n_layers} layers")
        for tk, lp in zip(toks, lps):
            check(len(tk) == 64 and len(lp) == 64, "a request stopped early")
            check(all(0 <= x < cfg.vocab_size for x in tk), "token off vocab")
            check(all(math.isfinite(x) and x <= 1e-4 for x in lp),
                  "non-finite or positive logprob")
        n_tok = sum(len(tk) for tk in toks)
        peak = torch.cuda.max_memory_allocated()
        log(f"  {variant}: {steps} steps, {engine.ragged_tokens} rows, "
            f"{n_tok} tokens out, {wall:.3f} s wall, {launches[variant]} "
            f"kernel launches, peak {peak / 2**30:.2f} GiB")
        # Kernel vs plain attention on the same 4 prompts and schedule.
        sub = prompts[::4]
        kern = _serve(_engine(params, cfg, bits), sub)
        plain = _serve(_engine(params, cfg, bits, attn_kernel=False), sub)
        report = _compare(kern, plain)
        log(f"  {variant}: kernel vs plain engine on 4 prompts "
            f"(fork -1 = tokens equal): {json.dumps(report)}")
        trace = _trace(_engine(params, cfg, bits), prompts)
        log(f"  {variant}: traced rerun of the 16 prompts: "
            f"{json.dumps(trace)}")
        engines[variant] = engine
    return launches, engines["bf16"]


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


def _trace(engine, prompts) -> dict:
    """Serve the prompts under ``torch.profiler`` (card activity only) and
    read that one run: its wall seconds, the card's busy seconds (the
    union of kernel intervals), the idle share 1 − busy/wall, and the
    ragged attention kernel's and the six largest kernels' device seconds.
    The profiler's own cost on the host stretches this run's wall, so its
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
    attention = sum(v for k, v in by_name.items() if "ragged_kernel" in k)
    check(busy > 0 and attention > 0,
          "the trace holds no ragged attention kernel on the card")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": engine.ragged_steps, "wall_s": wall, "busy_s": busy,
            "idle_share": 1.0 - busy / wall, "attention_s": attention,
            "attention_share_of_busy": attention / busy,
            "top_kernels_s": [[k[:60], v] for k, v in top]}


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


def http_phase(engine):
    """Phase 6: 2 prompts × (blocking, streamed), all 4 at once. Two-token
    prompts keep every dispatch at the 8-row floor, so a streamed copy and
    a blocking copy run at one width and must agree token for token."""
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
        log(f"  4 completions ok; /stats: served={stats['served']} "
            f"tokens_generated={stats['tokens_generated']} "
            f"ttft_s={stats['ttft_s']} ragged={stats['ragged']}")
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
    for line in _build.log_path().read_text().splitlines():
        if "ptxas" in line or "spill" in line:
            log(f"  {line.strip()}")
    log("  library already built" if seconds is None
        else f"  nvcc took {seconds:.2f} s")
    phases["build"] = time.monotonic() - t0

    log("[3/6] kernel vs plain")
    t0 = time.monotonic()
    errors = kernel_vs_plain()
    phases["kernel_vs_plain"] = time.monotonic() - t0

    log("[4/6] timing at the main-path shape")
    t0 = time.monotonic()
    times = timing()
    phases["timing"] = time.monotonic() - t0

    log("[5/6] engine: llama-3-8b, full width and depth, random weights")
    t0 = time.monotonic()
    cfg = L.LLAMA_CONFIGS["llama-3-8b"]
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    log(f"  init {cfg.param_count() / 1e9:.2f}B params in "
        f"{time.monotonic() - t0:.2f} s")
    launches, engine = engine_phase(params, cfg)
    phases["engine"] = time.monotonic() - t0

    log("[6/6] HTTP")
    t0 = time.monotonic()
    http_phase(engine)
    phases["http"] = time.monotonic() - t0

    kernels = [
        {
            "name": "ragged_paged_attention",
            "variant": variant,
            "route": "cuda",
            "source": "kubeflow_tpu_torch/csrc/ragged_attention.cu",
            "replaces": "kubeflow_tpu/ops/ragged_attention.py:330",
            "launches": launches[variant],
            "max_abs_err": errors[variant]["abs"],
            "max_rel_err": errors[variant]["rel"],
            "max_row_rel_err": errors[variant]["row_rel"],
            "ms": times[variant]["ms"],
            "plain_ms": times[variant]["plain_ms"],
            "bound_ms": times[variant]["bound_ms"],
            "bound_by": times[variant]["bound_by"],
            "library_ms": times[variant]["library_ms"],
        }
        for variant in ("bf16", "int8")
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
