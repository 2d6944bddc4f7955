"""chip_smoke.py's kernel-vs-plain gates and continuous engine phase,
rehearsed on the CPU.

The card runs each CUDA kernel against its plain version; here the plain
version stands in for the kernel: rounded once to bf16 it must pass every
gate, and with one 16-key block of a 640-key history dropped, or its
output 3% off, it must fail. Shapes are llama-3-8b's heads: 16 rows of
the ragged kernel (bf16 and int8 pools) and of the flash kernel (rows at
positions 624..639), and 2 slots of the paged and dense decode kernels.

The flash backward's gates are held the same way: the plain backward on
the forward's O and lse, its dq, dk and dv rounded to bf16, passes them;
with one 64-key tile of the 640 keys dropped, or 3% off, it fails them.
Phase 3's repeat checks (dq, dk and dv, and the forward's O and lse,
bit-equal over two runs on the same inputs) pass on two runs of the plain
version and fail when one element is one ulp off. The backward's cases
cover head dims 64, 128 and 256. The forward's SDPA
yardstick takes ``is_causal`` exactly for the square, causal, unmasked,
unwindowed cases at q_offset 0, and the forward's cases cover every head
dim, visibility rule and GQA group the kernel takes. The CTA count read
from a profiler trace survives a trace that drops the kernel's record,
and fails when three do.

The decode kernels' repeat check passes on two runs of the plain version
and fails on a one-ulp nudge; their phase-3 cases cover a boundary of the
runs of keys that ``decode_splits`` picks (one key either side), a
masked span longer than a run, 8192 keys, an idle slot and a stale length
beside split slots; ``decode_splits`` covers every span in runs of a
multiple of 64 keys from shapes alone; a decode kernel's timing reads
its CTAs, its kernels a call and its runs a slot from one traced call,
and fails unless the call was one launch of ``decode_splits``' grid; the
decode SDPA yardstick drops its mask exactly where the visibility is a
live prefix, and names the backend from a trace's kernels. The paged and dense kernels' phase-3
cases run through ``decode_vs_plain`` and ``dense_vs_plain`` as they
will on the card (the wrapper's plain version stands in for the kernel).
``continuous_phase`` and ``train_phase`` (and ``train_phases`` over a
llama-shaped and a gemma-shaped config) run at a small width on the CPU
with the kernel wrappers they reach replaced by counting stand-ins that
call the plain versions, so their launch arithmetic, comparisons and
output checks are exercised before the card sees them.

Phase 8's helpers, the same way: the verify-span cases (5 rows a slot,
each bounded by ``k_pos <= kv_len − 5 + j``) against a row-by-row
attention written out here; the rollback byte check, which passes on the
engine and fails when the rollback is skipped; the launch-count formula;
the adapter draw's delta size; and the whole phase at ``tiny`` width with
counting stand-ins.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import continuous as TC
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.ops import attention as TA
from kubeflow_tpu_torch.ops import paged_attention as TPA
from kubeflow_tpu_torch.ops import ragged_attention as TRA
from kubeflow_tpu_torch.ops.attention import flash_attention_reference
from kubeflow_tpu_torch.ops.paged_attention import (
    dense_decode_reference,
    paged_decode_reference,
)
from kubeflow_tpu_torch.ops.ragged_attention import ragged_attention_reference

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(hq=32, hkv=8, d=128, bs=16, maxb=40, nb=81, t=16)
SPANS = [(1, 640), (8, 640)]  # a decode row and a chunk, 640 keys each
FLASH_SHAPE = (1, 32, 8, 16, 640, True, 624, 0, None)
DECODE_SHAPE = dict(hq=32, hkv=8, d=128, bs=16, maxb=40, nb=81)
DENSE_SHAPE = dict(hq=32, hkv=8, d=128, c=1024)
# 64 rows at positions 576..639 against 640 keys, llama-3-8b heads.
BWD_SHAPE = (1, 32, 8, 64, 640, True, 576, 0, None)
VARIANTS = ["bf16", "int8", "flash", "decode", "dense"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke():
    """A private copy of chip_smoke whose cases are built on the CPU."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_on_cpu", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.DEVICE = "cpu"
    return mod


def _case(smoke, variant):
    if variant == "flash":
        return smoke._flash_case(FLASH_SHAPE, 128, seed=0)
    if variant == "decode":
        return smoke._decode_case([640, 640], seed=0, **DECODE_SHAPE)
    if variant == "dense":
        return smoke._dense_case([640, 640], seed=0, **DENSE_SHAPE)
    case = smoke._case(SPANS, seed=0, **SHAPE)
    return case if variant == "bf16" else smoke._quantized(case)


def _errors(smoke, variant, drop_block=False, scale=1.0):
    """The gates' errors of the plain version standing in for the kernel:
    run on the case (with one 16-key block of every history masked when
    ``drop_block``), its output times ``scale`` and rounded to bf16, held
    against the case as chip_smoke holds the kernel."""
    case = _case(smoke, variant)
    run = dict(case)
    if drop_block:
        mask = (torch.ones((1, 640), dtype=torch.bool) if variant == "flash"
                else case["kv_mask"].clone())
        mask[:, 320:336] = False
        run["kv_mask"] = mask
    if variant == "flash":
        out, lse = flash_attention_reference(**run)
        return smoke._flash_errors((out.float() * scale).to(torch.bfloat16),
                                   lse, case)
    if variant in ("decode", "dense"):
        plain_fn, k, v = ((paged_decode_reference, "k_pool", "v_pool")
                          if variant == "decode" else
                          (dense_decode_reference, "k_cache", "v_cache"))
        out = (plain_fn(**run).float() * scale).to(torch.bfloat16)
        plain = {**case, **{n: case[n].float() for n in ("q", k, v)}}
        ref = plain_fn(**plain)
        ref_abs = plain_fn(**{**plain, v: plain[v].abs()})
        return smoke._diff_errors(out.float(), ref, ref_abs)
    # bf16 q: the plain version rounds its output once.
    out = (ragged_attention_reference(**run).float() * scale).to(
        torch.bfloat16)
    return smoke._errors(out, case, smoke._owned(case))


def _failed(smoke, errs) -> list[str]:
    return [g for g, limit in smoke.GATES.items() if not errs[g] <= limit]


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_version_rounded_to_bf16_passes_every_gate(smoke, variant):
    errs = _errors(smoke, variant)
    assert not _failed(smoke, errs), errs
    if variant == "flash":
        assert errs["lse"] <= smoke.LSE_TOL and errs["keyless_rows_ok"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_a_dropped_kv_block_fails_the_relative_gates(smoke, variant):
    errs = _errors(smoke, variant, drop_block=True)
    assert {"rel", "row_rel"} <= set(_failed(smoke, errs)), errs


@pytest.mark.parametrize("variant", VARIANTS)
def test_an_output_three_percent_off_fails_the_row_gate(smoke, variant):
    errs = _errors(smoke, variant, scale=1.03)
    assert "row_rel" in _failed(smoke, errs), errs


@pytest.fixture
def no_card(monkeypatch):
    """The torch.cuda calls the phases make around their work, as no-ops."""
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def test_dense_vs_plain_rehearsed_on_the_cpu(smoke, no_card):
    worst = smoke.dense_vs_plain()
    assert set(worst) == set(smoke.GATES)
    assert all(worst[g] <= smoke.GATES[g] for g in worst)


def test_decode_vs_plain_rehearsed_on_the_cpu(smoke, no_card):
    worst = smoke.decode_vs_plain()
    assert set(worst) == set(smoke.GATES)
    assert all(worst[g] <= smoke.GATES[g] for g in worst)


def _decode_twice(smoke, kernel):
    """Two runs of a decode wrapper (the plain version on the CPU) on a
    case over several of the kernel's runs of keys, with left padding."""
    if kernel == "paged":
        case = smoke._decode_case([300, 700], seed=0, pad_frac=0.25,
                                  **smoke.DEC_SPLIT)
        wrapper = TPA.paged_decode_attention
    else:
        case = smoke._dense_case([300, 700], seed=0, pad_frac=0.25,
                                 **smoke.DENSE_SPLIT)
        wrapper = TPA.dense_decode_attention
    return wrapper(**case), wrapper(**case)


@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_decode_repeat_check_passes_on_two_equal_runs(smoke, kernel):
    first, second = _decode_twice(smoke, kernel)
    smoke.check_decode_repeat(first, second, "rehearsal")


@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_decode_repeat_check_fails_on_one_ulp(smoke, kernel):
    """One element of the output one ulp off: the check fails."""
    first, second = _decode_twice(smoke, kernel)
    again = second.clone()
    again.view(-1).view(torch.int16)[again.numel() // 2] += 1
    assert not torch.equal(first, again)
    with pytest.raises(AssertionError, match="differs between two runs"):
        smoke.check_decode_repeat(first, again, "rehearsal")


def _case_kinds(smoke, cases, span_of):
    """{kind: names} of the decode cases: a length at a run boundary of
    ``decode_splits``' split for the case's span with one key either side,
    a masked span longer than a run, 8192 keys, an idle slot, and a stale
    length (past the span) beside slots over several runs."""
    kinds: dict = {}
    for lens, shape, opts, name in cases:
        span = span_of(shape)
        split, nsplit = TPA.decode_splits(span, len(lens), shape["hkv"])
        if nsplit > 1 and any({k * split - 1, k * split, k * split + 1}
                              <= set(lens) for k in range(1, nsplit)):
            kinds.setdefault("boundary", []).append(name)
        if "hole" in opts and opts["hole"][2] - opts["hole"][1] > split:
            kinds.setdefault("masked-run", []).append(name)
        if max(lens) >= 8192:
            kinds.setdefault("8192", []).append(name)
        if opts.get("idle"):
            kinds.setdefault("idle", []).append(name)
        if max(lens) > span and nsplit > 1:
            kinds.setdefault("stale-split", []).append(name)
    return kinds


@pytest.mark.parametrize("kernel", ["paged", "dense"])
def test_decode_cases_cover_the_split_design(smoke, kernel):
    cases, span_of = (
        (smoke.DEC_CASES, lambda s: s["maxb"] * s["bs"]) if kernel == "paged"
        else (smoke.DENSE_CASES, lambda s: s["c"]))
    kinds = _case_kinds(smoke, cases, span_of)
    assert set(kinds) == {"boundary", "masked-run", "8192", "idle",
                          "stale-split"}, kinds
    assert {64, 128, 256} <= {shape["d"] for _, shape, _, _ in cases}


def test_timed_decode_shapes(smoke):
    assert [name for name, _, _ in smoke.DECODE_TIMED] == [
        "main-decode", "long-4096", "single-8192"]


DENSE_RECORD = {"cat": "kernel", "name": "void dense_decode_kernel<64>",
                "args": {"grid": [4, 2, 1]}}


@pytest.mark.parametrize("records,fails", [
    ([DENSE_RECORD], None),
    ([DENSE_RECORD, {"cat": "kernel", "name": "elementwise_kernel",
                     "args": {"grid": [1, 1, 1]}}], "launched 2 kernels"),
    ([{**DENSE_RECORD, "args": {"grid": [2, 2, 1]}}], "4 CTAs launched"),
])
def test_timing_decode_checks_the_launch_it_traced(smoke, monkeypatch,
                                                   records, fails):
    """One traced call gives the CTAs, the kernels a call and, through the
    grid, the runs a slot: the row holds them only if the call was one
    launch of ``decode_splits``' grid (4 runs of 64 keys × 2 kv heads × 1
    slot here), and the timing fails otherwise."""
    traces = iter([records, [{"cat": "kernel", "name": "cudnn_sdpa"}]])
    monkeypatch.setattr(smoke, "_kernel_records", lambda fn: next(traces))
    monkeypatch.setattr(smoke, "_time_ms", lambda fn: (fn(), 1.0)[1])
    case = smoke._dense_case([40], seed=0, hq=4, hkv=2, d=64, c=256)
    args = ("dense rehearsal", case, TPA.dense_decode_attention,
            dense_decode_reference, smoke._dense_library_call,
            smoke._dense_bound, "dense_decode_kernel")
    if fails:
        with pytest.raises(AssertionError, match=fails):
            smoke._timing_decode(*args)
        return
    row = smoke._timing_decode(*args)
    assert (row["ctas"], row["split"], row["launches_per_call"]) == (8, 64, 1)
    assert row["library_backend"] == "cuDNN"


@pytest.mark.parametrize("span,b,hkv", [
    (96, 3, 4), (592, 8, 8), (1024, 8, 8), (1024, 1, 8), (4096, 8, 8),
    (8192, 1, 8), (8192, 8, 8), (100_000, 4, 8), (1, 1, 1),
])
def test_decode_splits_cover_the_span_in_runs_of_64(span, b, hkv):
    split, nsplit = TPA.decode_splits(span, b, hkv)
    assert split % 64 == 0 and 64 <= split <= TPA.MAX_SPLIT
    assert (nsplit - 1) * split < span <= nsplit * split or span <= split
    assert nsplit <= TPA.MAX_RUNS or split == TPA.MAX_SPLIT


def test_decode_splits_read_only_shapes():
    """The split is fixed from ints the host has (span, B, Hkv): no
    tensor, so no seq_lens, reaches it, and no call waits on the card."""
    import inspect

    assert list(inspect.signature(TPA.decode_splits).parameters) == [
        "span", "b", "hkv"]
    assert TPA.decode_splits(592, 8, 8) == (64, 10)
    assert TPA.decode_splits(4096, 8, 8) == (256, 16)
    assert TPA.decode_splits(8192, 1, 8) == (256, 32)


@pytest.mark.parametrize("lens,pad_frac,prefix", [
    ([8192], 0.0, 8192), ([300, 300], 0.0, 300), ([300, 700], 0.0, None),
    ([700], 0.25, None),
])
def test_sdpa_gets_no_mask_exactly_for_a_live_prefix(smoke, lens, pad_frac,
                                                      prefix):
    case = smoke._dense_case(lens, seed=0, pad_frac=pad_frac, hq=2, hkv=1,
                             d=64, c=8192)
    assert smoke._live_prefix(case) == prefix


@pytest.mark.parametrize("names,backend", [
    (["cudnn_generated_fort_native_sdpa_sm90_flash_fprop"], "cuDNN"),
    (["void pytorch_flash::flash_fwd_kernel<...>"], "flash"),
    (["fmha_cutlassF_bf16_aligned_64x64_rf_sm80"], "efficient"),
    (["gemv2T_kernel", "softmax_warp_forward"], "math"),
])
def test_sdpa_decode_yardstick_names_the_backend_that_ran(smoke, monkeypatch,
                                                          names, backend):
    """The backend is read from the kernels of a traced call; a trace that
    holds none is taken again."""
    traces = iter([[], [{"cat": "kernel", "name": n} for n in names]])
    monkeypatch.setattr(smoke, "_kernel_records", lambda fn: next(traces))
    case = smoke._dense_case([40], seed=0, hq=4, hkv=2, d=64, c=64)
    _, got = smoke._dense_library_call(case)
    assert got == backend


def test_continuous_phase_rehearsed_on_the_cpu(smoke, no_card, monkeypatch):
    """The engine phase at f32 ``tiny`` width on the CPU: the flash and
    dense wrappers count like the kernels and compute the plain versions,
    the engine is told its kernel is on, and the profiler is not run."""
    real_flash, real_dense = TA.flash_attention_fwd, TPA.dense_decode_attention

    def flash(*a, **kw):
        real_flash.launches += 1
        return TA.flash_attention_reference(*a, **kw)

    def dense(*a, **kw):
        real_dense.launches += 1
        return TPA.dense_decode_reference(*a, **kw)

    monkeypatch.setattr(TA, "flash_attention_fwd", flash)
    monkeypatch.setattr(TC, "dense_decode_attention", dense)
    real_engine = smoke._cont_engine

    def engine(params, cfg, attn_kernel=None, admit_chunk=None, max_new=64):
        eng = real_engine(params, cfg, attn_kernel=False,
                          admit_chunk=admit_chunk, max_new=max_new)
        if attn_kernel is not False:
            eng._attn_kernel = TC._kernel_block_size(eng.cache_len)
        return eng

    monkeypatch.setattr(smoke, "_cont_engine", engine)
    monkeypatch.setattr(smoke, "_trace", lambda *a, **k: {})
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    launches, eng = smoke.continuous_phase(params, cfg)
    assert launches["flash"] == 16 * cfg.n_layers
    assert launches["dense"] > 0 and launches["dense"] % cfg.n_layers == 0
    assert isinstance(eng, TC.ContinuousBatcher) and not eng._pending()


def _bwd_errors(smoke, drop_tile=False, scale=1.0):
    """The backward gates' errors of the plain backward standing in for
    the kernels: run on the case (with keys 320..383 masked when
    ``drop_tile``), its grads times ``scale`` and rounded to bf16."""
    case = smoke._bwd_case(BWD_SHAPE, 128, seed=0)
    run = dict(case)
    if drop_tile:
        mask = torch.ones((1, 640), dtype=torch.bool)
        mask[:, 320:384] = False
        run["kv_mask"] = mask
    grads = [(g.float() * scale).to(torch.bfloat16)
             for g in TA.flash_attention_bwd_reference(**run)]
    return smoke._bwd_errors(grads, case)


def _bwd_failed(smoke, errs) -> dict:
    return {t: [g for g, limit in smoke.BWD_GATES.items()
                if not errs[t][g] <= limit] for t in ("dq", "dk", "dv")}


def test_plain_backward_rounded_to_bf16_passes_the_gates(smoke):
    errs = _bwd_errors(smoke)
    assert _bwd_failed(smoke, errs) == {"dq": [], "dk": [], "dv": []}, errs
    assert errs["zeros_ok"]


def test_a_dropped_key_tile_fails_the_backward_row_gate(smoke):
    errs = _bwd_errors(smoke, drop_tile=True)
    assert all("row_rel" in f for f in _bwd_failed(smoke, errs).values()), errs


def test_gradients_three_percent_off_fail_the_backward_row_gate(smoke):
    errs = _bwd_errors(smoke, scale=1.03)
    assert all("row_rel" in f for f in _bwd_failed(smoke, errs).values()), errs


def _bwd_twice(smoke):
    """Two runs of the backward wrapper (the plain version on the CPU) on
    one case of group 8 (16 q heads over 2 kv heads)."""
    case = smoke._bwd_case((1, 16, 2, 64, 128, True, 64, 0, None), 128,
                           seed=0)
    return case, TA.flash_attention_bwd(**case), TA.flash_attention_bwd(**case)


def test_backward_repeat_check_passes_on_two_equal_runs(smoke):
    _, first, second = _bwd_twice(smoke)
    smoke.check_bwd_repeat(first, second, "rehearsal")


@pytest.mark.parametrize("which", [0, 1, 2])
def test_backward_repeat_check_fails_on_one_ulp(smoke, which):
    """One element of dq (or dk, or dv) one bf16 ulp off: the check
    fails."""
    _, first, second = _bwd_twice(smoke)
    again = [g.to(torch.bfloat16) for g in second]
    first = [g.to(torch.bfloat16) for g in first]
    smoke.check_bwd_repeat(first, again, "rehearsal")
    bits = again[which].view(-1).view(torch.int16)
    bits[bits.numel() // 2] += 1
    assert not torch.equal(first[which], again[which])
    with pytest.raises(AssertionError, match="differs between two runs"):
        smoke.check_bwd_repeat(first, again, "rehearsal")


def _stand_in_kernels(smoke, monkeypatch):
    """The flash forward and backward wrappers replaced by stand-ins that
    count like the kernels and compute the plain versions; S 64 in loss
    chunks of 16."""
    real_fwd = TA.flash_attention_fwd

    def fwd(*a, **kw):
        real_fwd.launches += 1
        return TA.flash_attention_reference(*a, **kw)

    def bwd(*a, **kw):
        TA.flash_bwd_dq.launches += 1
        TA.flash_bwd_dkv.launches += 1
        return TA.flash_attention_bwd_reference(*a, **kw)

    monkeypatch.setattr(TA, "flash_attention_fwd", fwd)
    monkeypatch.setattr(TA, "flash_attention_bwd", bwd)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 64)
    monkeypatch.setattr(smoke, "LOSS_CHUNK", 16)


def test_train_phase_rehearsed_on_the_cpu(smoke, no_card, monkeypatch):
    """The train phase at ``tiny`` width (bf16, 2 layers) on the CPU."""
    _stand_in_kernels(smoke, monkeypatch)
    cfg = TL.LLAMA_CONFIGS["tiny"]
    launched = smoke.train_phase(cfg)
    n = cfg.n_layers * smoke.TRAIN_STEPS
    assert launched == {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n}


def test_train_phase_gates_the_backward_kernels_wq_cosine(smoke, no_card,
                                                          monkeypatch):
    """A backward stand-in whose dq is 0 (a dQ kernel that wrote nothing)
    under the plain forward fails the backward kernels' wq cosine gate."""
    _stand_in_kernels(smoke, monkeypatch)
    counting = TA.flash_attention_bwd

    def no_dq(*a, **kw):
        dq, dk, dv = counting(*a, **kw)
        return torch.zeros_like(dq), dk, dv

    monkeypatch.setattr(TA, "flash_attention_bwd", no_dq)
    with pytest.raises(AssertionError, match="of the backward kernels"):
        smoke.train_phase(TL.LLAMA_CONFIGS["tiny"])


def test_train_phase_gates_the_all_kernels_wq_cosine(smoke, no_card,
                                                     monkeypatch):
    """A forward stand-in that scales the scores twice over (a wrong
    softmax scale) under the plain backward's stand-in fails the
    all-kernels wq cosine gate, which the nudge holds at 0.99 here."""
    _stand_in_kernels(smoke, monkeypatch)
    counting = TA.flash_attention_fwd

    def hot(q, *a, **kw):
        return counting(q * 2, *a, **kw)

    monkeypatch.setattr(TA, "flash_attention_fwd", hot)
    with pytest.raises(AssertionError, match="of all the kernels"):
        smoke.train_phase(TL.LLAMA_CONFIGS["tiny"])


# wq grad cosines at layers 0 and last on the card (PERF.md §6, PR 8): the
# nudge's, the least each layer's all-kernels cosine may be, and the
# kernels' own readings, which must pass.
@pytest.mark.parametrize("nudged,floor,kernels", [
    ((0.999699, 0.999787), (0.99, 0.99), (0.999735, 0.999842)),  # llama-3-8b
    ((0.929557, 0.894733), (0.924557, 0.889733), (0.950978, 0.922978)),
])
def test_wq_cos_floor_is_the_bound_or_just_under_the_nudge(smoke, nudged,
                                                           floor, kernels):
    got = smoke._wq_cos_floor(nudged)
    assert got == pytest.approx(floor, abs=1e-12)
    assert all(c >= f for c, f in zip(kernels, got))
    assert all(f <= smoke.TRAIN_TOL["wq_cos"] for f in got)


def test_train_phases_with_gemma_rehearsed_on_the_cpu(smoke, no_card,
                                                      monkeypatch):
    """Phase 7 as the card runs it, a llama config and then a gemma one
    (head dim 256, GELU, (1 + w) norms, scaled and tied embeddings, 2 q
    heads over 1 kv head), each cut to a small width and 2 layers in bf16,
    then the checkpoint round trip once."""
    _stand_in_kernels(smoke, monkeypatch)
    assert smoke.TRAIN_MODELS == ("llama-3-8b", "gemma-2b")
    gemma = dataclasses.replace(
        TL.LLAMA_CONFIGS["gemma-2b"], vocab_size=256, dim=128, n_layers=2,
        n_heads=2, n_kv_heads=1, ffn_hidden=256, max_seq_len=256)
    assert gemma.head_dim == 256 and gemma.tie_embeddings
    rounds, real_round_trip = [], smoke.checkpoint_round_trip
    monkeypatch.setattr(smoke, "checkpoint_round_trip",
                        lambda: rounds.append(real_round_trip()))
    launched = smoke.train_phases({"tiny": TL.LLAMA_CONFIGS["tiny"],
                                   "gemma-2b": gemma})
    n = 2 * smoke.TRAIN_STEPS
    assert launched == {name: {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n}
                        for name in ("tiny", "gemma-2b")}
    assert rounds == [None]


def test_backward_cases_cover_every_head_dim_the_kernels_take(smoke):
    """Head dims 64, 128 and 256 (as ``_BWD_HEAD_DIMS``), and at 256
    gemma-2b's heads, a q_offset, a window, a mask and keyless rows."""
    assert {d for _, d, _ in smoke.BWD_CASES} == set(TA._BWD_HEAD_DIMS) == {
        64, 128, 256}
    d256 = [shape for shape, d, _ in smoke.BWD_CASES if d == 256]
    assert any(s[1:3] == (8, 1) for s in d256)
    assert any(s[6] > 0 for s in d256) and any(s[7] > 0 for s in d256)
    assert any(s[8] is not None for s in d256)
    assert any(not all(bool(smoke._flash_visible(_shape_case(s), i)
                            .any(-1).all()) for i in range(s[0]))
               for s in d256)
    timed = {name: (shape, d) for name, shape, d in smoke.BWD_TIMED}
    assert timed == {"train-2048": (smoke.BWD_TRAIN, 128),
                     "gemma-2b-2048": (smoke.BWD_GEMMA, 256)}


def test_forward_cases_cover_every_timed_backward_shape(smoke):
    """The forward kernel that feeds each timed backward shape (O and lse)
    is held to its plain version at that shape in phase 3."""
    checked = {(shape, d) for shape, d, _ in smoke.FLASH_CASES}
    assert all((shape, d) in checked for _, shape, d in smoke.BWD_TIMED)


def _fwd_twice(smoke):
    """Two runs of the forward wrapper (the plain version on the CPU) on
    one case of group 4 with left padding."""
    case = smoke._flash_case((1, 8, 2, 64, 96, True, 32, 0, (40,)), 128,
                             seed=0)
    return TA.flash_attention_fwd(**case), TA.flash_attention_fwd(**case)


def test_forward_repeat_check_passes_on_two_equal_runs(smoke):
    first, second = _fwd_twice(smoke)
    smoke.check_fwd_repeat(first, second, "rehearsal")


@pytest.mark.parametrize("which", [0, 1])
def test_forward_repeat_check_fails_on_one_bit(smoke, which):
    """One element of O (or lse) one ulp off: the check fails."""
    first, second = _fwd_twice(smoke)
    again = [t.clone() for t in second]
    bits = again[which].view(-1).view(
        torch.int16 if again[which].dtype == torch.bfloat16 else torch.int32)
    bits[bits.numel() // 2] += 1
    assert not torch.equal(first[which], again[which])
    with pytest.raises(AssertionError, match="differs between two runs"):
        smoke.check_fwd_repeat(first, again, "rehearsal")


def _shape_case(shape):
    """A flash case with the shape's metadata and empty head dims: what
    ``_sdpa_is_causal`` and ``_flash_visible`` read, at no cost."""
    b, h, hkv, sq, sk, causal, q_offset, window, pads = shape
    kv_mask = (None if pads is None else
               torch.arange(sk)[None, :] >= torch.tensor(pads)[:, None])
    return dict(q=torch.empty((b, h, sq, 0)), k=torch.empty((b, hkv, sk, 0)),
                causal=causal, q_offset=q_offset, window=window,
                kv_mask=kv_mask)


SQUARE_CAUSAL = (1, 32, 8, 2048, 2048, True, 0, 0, None)


@pytest.mark.parametrize("shape,expected", [
    (SQUARE_CAUSAL, True),
    ((1, 32, 8, 16384, 16384, True, 0, 0, None), True),
    ((2, 8, 8, 100, 100, True, 0, 0, None), True),
    ((1, 32, 8, 2048, 2049, True, 0, 0, None), False),   # Sq != Sk
    ((1, 32, 8, 2048, 2048, False, 0, 0, None), False),  # not causal
    ((1, 32, 8, 2048, 2048, True, 1, 0, None), False),   # q_offset
    ((1, 32, 8, 2048, 2048, True, 0, 256, None), False),  # window
    ((1, 32, 8, 2048, 2048, True, 0, 0, (0,)), False),   # a mask
])
def test_sdpa_takes_is_causal_exactly_for_plain_causal_shapes(smoke, shape,
                                                              expected):
    assert smoke._sdpa_is_causal(_shape_case(shape)) is expected


def test_timed_flash_cases_use_is_causal_where_they_qualify(smoke):
    by_name = {name: shape for shape, _, name in smoke.FLASH_CASES}
    chosen = {name: smoke._sdpa_is_causal(_shape_case(by_name[name]))
              for name, _ in smoke.FLASH_TIMED}
    assert chosen == {"main-prefill": False, "continuation-528": False,
                      "train-2048": True, "long-16384": True}


def test_flash_cases_cover_every_kind_the_kernel_takes(smoke):
    """Head dims 64/128/256, a window, a q_offset, a kv_mask, rows that see
    no key, and GQA groups of 1, 4 and 8."""
    shapes = [(shape, d) for shape, d, _ in smoke.FLASH_CASES]
    assert {d for _, d in shapes} == {64, 128, 256}
    assert any(s[7] > 0 for s, _ in shapes)
    assert any(s[6] > 0 for s, _ in shapes)
    assert any(s[8] is not None for s, _ in shapes)
    assert {1, 4, 8} <= {s[1] // s[2] for s, _ in shapes}
    keyless = [name for shape, _, name in smoke.FLASH_CASES
               if max(shape[3], shape[4]) <= 4096 and not all(
                   bool(smoke._flash_visible(_shape_case(shape), i)
                        .any(-1).all()) for i in range(shape[0]))]
    assert keyless, "no case has a row that sees no key"


FWD_RECORD = {"cat": "kernel", "name": "void flash_fwd_kernel<128>(...)",
              "args": {"grid": [32, 32, 1]}}


def _fake_profiler(monkeypatch, traces):
    """``torch.profiler.profile`` replaced by one whose successive traces
    hold the given kernel records."""
    traces = iter(traces)

    class Profile:
        def __init__(self, activities):
            self.events = next(traces)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": self.events}, f)

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_launched_ctas_traces_again_when_a_record_is_dropped(smoke,
                                                             monkeypatch):
    _fake_profiler(monkeypatch, [[], [FWD_RECORD]])
    calls = []
    got = smoke._launched_ctas(lambda: calls.append(1),
                               {"ctas": "flash_fwd_kernel"})
    assert got == {"ctas": 1024} and len(calls) == 2


def test_launched_ctas_fails_when_three_traces_miss_the_kernel(smoke,
                                                               monkeypatch):
    _fake_profiler(monkeypatch, [[], [], [], [FWD_RECORD]])
    with pytest.raises(AssertionError, match="3 traces hold no"):
        smoke._launched_ctas(lambda: None, {"ctas": "flash_fwd_kernel"})


# Ragged attention's split design: phase 3's repeat check and cases, and
# phase 4's shapes and traced launch, rehearsed on the CPU.


def _ragged_twice(smoke, variant):
    """Two runs of the ragged wrapper (the plain version on the CPU) on a
    case whose tiles span several of the kernel's runs of keys."""
    case = smoke._case([(1, 700), (30, 900)], seed=0, **smoke.RAG_SPLIT)
    if variant == "int8":
        case = smoke._quantized(case)
    return TRA.ragged_paged_attention(**case), \
        TRA.ragged_paged_attention(**case)


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_ragged_repeat_check_passes_on_two_equal_runs(smoke, variant):
    first, second = _ragged_twice(smoke, variant)
    smoke.check_ragged_repeat(first, second, "rehearsal")


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_ragged_repeat_check_fails_on_one_ulp(smoke, variant):
    """One element of the output one ulp off: the check fails."""
    first, second = _ragged_twice(smoke, variant)
    again = second.clone()
    again.view(-1).view(torch.int16)[again.numel() // 3] += 1
    assert not torch.equal(first, again)
    with pytest.raises(AssertionError, match="differs between two runs"):
        smoke.check_ragged_repeat(first, again, "rehearsal")


def _tile_bounds(spans, q_tile, span):
    """The causal bound hi of every tile of every sequence: its rows see
    no key at or past min(kv_len − n + (t + 1)·q_tile, kv_len, span)."""
    return [max(0, min(kvl - n + (t + 1) * q_tile, kvl, span))
            for n, kvl in spans for t in range(-(-n // q_tile))]


def _ragged_kinds(cases):
    """{kind: names} of phase 3's ragged cases over several of
    ``ragged_splits``' runs: a tile bound at a run boundary with one key
    either side, a masked span longer than a run, 8192 keys, an idle slot
    with a stale kv_len past the span, 32-token q-tiles of 128 rows, and
    each head dim."""
    kinds: dict = {}
    for spans, shape, opts, q_tile, name, _ in cases:
        span = shape["maxb"] * shape["bs"]
        split, nsplit = TRA.ragged_splits(shape["t"], len(spans), span,
                                          shape["hkv"], q_tile)
        his = set(_tile_bounds(spans, q_tile, span))
        if nsplit == 1 or max(his) <= split:
            continue
        kind = kinds.setdefault
        kind(f"d{shape['d']}", []).append(name)
        if any({k * split - 1, k * split, k * split + 1} <= his
               for k in range(1, nsplit)):
            kind("boundary", []).append(name)
        if "hole" in opts and opts["hole"][2] - opts["hole"][1] > split:
            kind("masked-run", []).append(name)
        if max(kvl for n, kvl in spans if n) >= 8192:
            kind("8192", []).append(name)
        if any(n == 0 and kvl > span for n, kvl in spans):
            kind("idle-stale", []).append(name)
        if q_tile * shape["hq"] // shape["hkv"] == 128:
            kind("qt32", []).append(name)
    return kinds


def test_ragged_cases_cover_the_split_design(smoke):
    kinds = _ragged_kinds(smoke.RAGGED_CASES)
    assert {"boundary", "masked-run", "8192", "idle-stale", "qt32", "d64",
            "d128", "d256"} <= set(kinds), kinds


def test_timed_ragged_shapes(smoke):
    assert [(name, variants) for name, _, _, _, variants
            in smoke.RAGGED_TIMED] == [
        ("main-mixed", ("bf16", "int8")), ("ragged-decode", ("bf16", "int8")),
        ("ragged-long-4096", ("bf16",)), ("ragged-single-8192", ("bf16",)),
        ("ragged-chunk-4096", ("bf16",)), ("ragged-verify", ("bf16", "int8")),
        ("ragged-verify-4096", ("bf16", "int8"))]


@pytest.mark.parametrize("t,s,span,hkv,q_tile", [
    (512, 8, 640, 8, 16), (8, 8, 592, 8, 16), (8, 8, 4096, 8, 16),
    (8, 1, 8192, 8, 16), (512, 1, 4096, 8, 16), (96, 7, 1024, 4, 16),
    (24, 3, 96, 4, 16), (512, 8, 640, 8, 32), (2048, 64, 100_000, 8, 16),
    (1, 1, 16, 1, 16),
])
def test_ragged_splits_cover_every_tile_span_in_runs_of_64(t, s, span, hkv,
                                                           q_tile):
    split, nsplit = TRA.ragged_splits(t, s, span, hkv, q_tile)
    assert split % 64 == 0 and split >= 64
    assert 1 <= nsplit <= TRA.MAX_RUNS
    # The runs cover the span, each of them holding some of it.
    assert (nsplit - 1) * split < span <= nsplit * split
    tiles = TRA.ragged_tiles(t, s, q_tile)
    assert tiles * hkv * nsplit <= TRA.MAX_CTAS or nsplit == 1


def test_ragged_splits_read_only_shapes():
    """The split is fixed from ints the host has (T, S, span, Hkv,
    q_tile): no tensor, so no seq_lens, reaches it, and no call waits on
    the card."""
    import inspect

    assert list(inspect.signature(TRA.ragged_splits).parameters) == [
        "t", "s", "span", "hkv", "q_tile"]
    # The engine's shapes: no split where the tiles already fill two waves
    # (an admission step, a long chunk), runs where few tiles walk far.
    assert TRA.ragged_splits(512, 8, 640, 8, 16) == (640, 1)
    assert TRA.ragged_splits(8, 8, 592, 8, 16) == (320, 2)
    assert TRA.ragged_splits(8, 8, 4096, 8, 16) == (2048, 2)
    assert TRA.ragged_splits(8, 1, 8192, 8, 16) == (512, 16)
    assert TRA.ragged_splits(512, 1, 4096, 8, 16) == (4096, 1)


def _random_layouts(seed: int):
    """(T, q_tile, spans) layouts as the ragged scheduler makes them:
    disjoint row spans within T, idle slots (0 rows) among them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(200):
        t = int(rng.choice([8, 16, 64, 512, 2048]))
        q_tile = int(rng.choice([1, 4, 16, 32]))
        s = int(rng.integers(1, 65))
        cuts = np.sort(rng.integers(0, t + 1, size=s - 1))
        lens = np.diff(np.concatenate([[0], cuts, [rng.integers(0, t + 1)]]))
        lens = np.clip(lens, 0, None)
        lens[rng.random(s) < 0.2] = 0
        out.append((t, q_tile, [(int(n), 1) for n in lens]))
    return out


@pytest.mark.parametrize("layouts", ["phase-3"] + [f"random-{i}"
                                                   for i in range(4)])
def test_compact_grid_bounds_the_owned_tiles(smoke, layouts):
    """Every tile that owns rows lies inside the kernel's compact tile
    axis, ragged_tiles(T, S, q_tile), for every phase-3 layout and for
    random schedules."""
    if layouts == "phase-3":
        cases = [(shape["t"], q_tile, spans)
                 for spans, shape, _, q_tile, _, _ in smoke.RAGGED_CASES]
    else:
        cases = _random_layouts(int(layouts.split("-")[1]))
    for t, q_tile, spans in cases:
        assert sum(n for n, _ in spans) <= t
        owned = sum(-(-n // q_tile) for n, _ in spans)
        assert owned <= TRA.ragged_tiles(t, len(spans), q_tile), (
            t, q_tile, spans)


def test_ragged_vs_plain_rehearsed_on_the_cpu(smoke, no_card, monkeypatch):
    """Phase 3's ragged cases at their small shapes (every head dim, the
    run boundaries, the masked run, the idle stale slot, 32-token q-tiles,
    the verify spans and GQA groups 1 and 8 at head dim 256), each run
    twice, as on the card."""
    cases = [c for c in smoke.RAGGED_CASES
             if c[1]["t"] <= 96 and c[1]["maxb"] * c[1]["bs"] <= 1024]
    assert len(cases) == 20
    monkeypatch.setattr(smoke, "RAGGED_CASES", cases)
    worst = smoke.kernel_vs_plain()
    for variant in ("bf16", "int8"):
        assert all(worst[variant][g] <= smoke.GATES[g] for g in smoke.GATES)


# One launch of 6 runs × 2 kv heads × 1 tile: a row of 300 keys at span
# 384 (ragged_splits: 6 runs of 64 keys).
RAGGED_RECORD = {"cat": "kernel", "name": "void ragged_kernel<64, false>",
                 "args": {"grid": [6, 2, 1]}}


# The wrapper's zero fill of the output (torch.zeros_like), as the
# profiler names it.
FILL_RECORD = {"cat": "kernel", "name": "void at::native::vectorized_"
               "elementwise_kernel<4, at::native::FillFunctor<c10::BFloat16>"
               ">", "args": {"grid": [16, 1, 1]}}


@pytest.mark.parametrize("records,fails", [
    ([RAGGED_RECORD], None),
    ([FILL_RECORD, RAGGED_RECORD], None),
    ([RAGGED_RECORD, RAGGED_RECORD], "launched 2 ragged kernels"),
    ([FILL_RECORD, RAGGED_RECORD, {
        "cat": "kernel", "name": "void at::native::index_elementwise_kernel",
        "args": {"grid": [1, 1, 1]}}], "launched 1 ragged kernels and"),
    ([{**RAGGED_RECORD, "args": {"grid": [3, 2, 1]}}], "6 CTAs launched"),
])
def test_timing_ragged_checks_the_launch_it_traced(smoke, monkeypatch,
                                                   records, fails):
    """One traced call gives the CTAs and the kernels a call: the row holds
    them only if the call was one launch of ragged_tiles · Hkv · nsplit
    CTAs beside at most the output's zero fill, and the timing fails on
    two launches of the kernel, on any other kernel and on another grid.
    A one-row-a-slot case takes the decode yardstick, its backend named
    from a trace."""
    traces = iter([records, [{"cat": "kernel", "name": "cudnn_sdpa"}]])
    monkeypatch.setattr(smoke, "_kernel_records", lambda fn: next(traces))
    monkeypatch.setattr(smoke, "_time_ms", lambda fn: (fn(), 1.0)[1])
    case = smoke._case([(1, 300)], seed=0, hq=4, hkv=2, d=64, bs=16,
                       maxb=24, nb=25, t=8)
    if fails:
        with pytest.raises(AssertionError, match=fails):
            smoke._timing_ragged("rehearsal", case)
        return
    row = smoke._timing_ragged("rehearsal", case)
    assert (row["ctas"], row["launches_per_call"]) == (12, 1)
    assert row["kernels_per_call"] == len(records)
    assert row["library_backend"] == "cuDNN"


def test_trace_splits_each_kernel_by_launch_grid(smoke, monkeypatch):
    """The traced rerun sums each kernel's device time by name, and by
    launch grid, from the chrome trace: a width-8 step's launch (4 runs ×
    8 kv heads × 8 tiles) apart from a 512-row step's (39 tiles); its busy
    time is the union of the card's records, a copy's too."""
    decode = {"cat": "kernel", "name": "void ragged_kernel<128, false>",
              "args": {"grid": [4, 8, 8]}, "dur": 20.0}
    admit = {**decode, "args": {"grid": [1, 8, 39]}, "dur": 60.0}
    other = {"cat": "kernel", "name": "nvjet_gemm", "args": {"grid": [1]},
             "dur": 100.0}
    copy = {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 10.0}
    host = {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 5.0}
    records = [{**ev, "ts": 1000.0 * i}
               for i, ev in enumerate([decode, decode, admit, other, copy,
                                       host])]
    _fake_profiler(monkeypatch, [records])
    monkeypatch.setattr(smoke, "_serve", lambda engine, prompts: None)
    out = smoke._trace(None, [], {"attention": "ragged_kernel"})
    assert out["nccl_s"] == 0 and out["nccl_launches"] == 0
    assert out["attention_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(210e-6)
    assert out["attention_by_grid"] == {
        "1x8x39": [1, pytest.approx(60e-6)],
        "4x8x8": [2, pytest.approx(40e-6)]}


# -- quantized weights --------------------------------------------------------

QUANT_SMALL = (("layer", 256, 160, False), ("head", 200, 256, True))


@pytest.fixture
def quant_small(smoke, monkeypatch):
    """Phase 3 and 4's quant_matmul at small shapes on the CPU: one layer
    weight, one head; the trace of a call stands in as one launch of the
    kernel with the CTAs kernel_ctas names."""
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(smoke, "QUANT_SHAPES", QUANT_SMALL)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda *a: Props())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(smoke.qmm_mod, "kernel_ctas", lambda *a: 3)
    monkeypatch.setattr(smoke, "_kernel_records", lambda fn: (fn(), [
        {"cat": "kernel", "name": "void quant_mm_kn_kernel<0, 1>",
         "args": {"grid": [3, 1, 1]}}])[1])
    monkeypatch.setattr(smoke, "QUANT_GROUP", 32)


def test_quant_vs_plain_rehearsed_on_the_cpu(smoke, no_card, quant_small):
    worst = smoke.quant_vs_plain()
    assert set(worst) == {"abs", "rel", "row_rel"}
    assert all(worst[g] <= smoke.QUANT_GATES[g] for g in smoke.QUANT_GATES)


def test_quant_vs_plain_fails_on_a_second_kernel_in_the_call(
        smoke, no_card, quant_small, monkeypatch):
    monkeypatch.setattr(smoke, "_kernel_records", lambda fn: [
        {"cat": "kernel", "name": "void quant_mm_kn_kernel<0, 1>",
         "args": {"grid": [3, 1, 1]}},
        {"cat": "kernel", "name": "elementwise_kernel copy",
         "args": {"grid": [4096, 1, 1]}}])
    with pytest.raises(AssertionError, match="one call launched"):
        smoke.quant_vs_plain()


def _quant_pair(smoke, scheme, head):
    name, rows, cols, _ = QUANT_SMALL[1 if head else 0]
    src = smoke._quant_source(name, rows, cols, head, seed=3)
    w = smoke._quantize_one(src, scheme, head)
    x = smoke._quant_x(8, cols if head else rows, seed=4)
    ref = smoke.quant_matmul_reference(x, w.q, w.s, scheme, head)
    return x, w, ref


@pytest.mark.parametrize("scheme", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("head", [False, True])
def test_quant_gates_pass_one_rounding_and_fail_one_percent(smoke, quant_small,
                                                            scheme, head):
    """One element moved by one bf16 unit in the last place passes the
    gates; the whole output 1% off fails the row gate; a zeroed row fails
    both."""
    x, w, ref = _quant_pair(smoke, scheme, head)
    nudged = ref.clone()
    bits = nudged.view(torch.int16 if ref.dtype == torch.bfloat16
                       else torch.int32).reshape(-1)
    bits[bits.numel() // 3] += 1 if ref.dtype == torch.bfloat16 else 1 << 16
    errs = smoke._quant_errors(nudged, ref, x, w, head)
    assert all(errs[g] <= smoke.QUANT_GATES[g] for g in smoke.QUANT_GATES)
    errs = smoke._quant_errors(ref * 1.01, ref, x, w, head)
    assert errs["row_rel"] > smoke.QUANT_GATES["row_rel"]
    zeroed = ref.clone()
    zeroed[3] = 0
    errs = smoke._quant_errors(zeroed, ref, x, w, head)
    assert all(errs[g] > smoke.QUANT_GATES[g] for g in smoke.QUANT_GATES)


def test_quant_repeat_check_fails_on_one_ulp(smoke, quant_small):
    _, _, ref = _quant_pair(smoke, "int8", False)
    smoke.check_quant_repeat(ref, ref.clone(), "rehearsal")
    again = ref.clone()
    again.view(torch.int16).reshape(-1)[5] += 1
    with pytest.raises(AssertionError, match="repeats differ"):
        smoke.check_quant_repeat(ref, again, "rehearsal")


def test_timing_quant_rehearsed_on_the_cpu(smoke, no_card, quant_small,
                                           monkeypatch):
    monkeypatch.setattr(smoke, "_time_ms", lambda fn: (fn(), 1.0)[1])
    rows = smoke.timing_quant()
    assert set(rows) == {"layer", "head"}
    for name, by_scheme in rows.items():
        assert set(by_scheme) == {"int8", "int4", "fp8"}
        for row in by_scheme.values():
            assert set(smoke.QUANT_ROW_KEYS) <= set(row)
            assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
    # int8 reads (K, N) bytes, int4 half of them, plus the scales.
    layer = rows["layer"]
    assert layer["int4"]["bytes"] < layer["int8"]["bytes"]


@pytest.mark.parametrize("kind,widths,admits,steps,want", [
    ("ragged", [8, 8, 512, 16, 32], 0, 5, {"quant": 3 * 225 + 2,
                                            "wide": 2 * 224}),
    ("continuous", (), 3, 10, {"quant": 10 * 225 + 3, "wide": 3 * 224}),
])
def test_expected_quant_calls(smoke, kind, widths, admits, steps, want):
    """A 32-layer decode step launches 7·32 + 1 kernels; a step wider than
    MAX_ROWS takes its 7·32 products on the wide path and its head (one
    row a slot, or an admission's one sampled row) on the kernel."""
    assert smoke._expected_quant_calls(kind, widths, admits, steps,
                                       32) == want


class _Stream:
    """A stand-in CUDA stream: ordering calls do nothing on the CPU."""

    def wait_stream(self, other):
        pass


@pytest.mark.parametrize("streams,calls,fails", [
    ([7, 7, 13, 7, 13], 2, None), ([7, 7, 7], 0, None),
    ([7, 7, 7], 2, "off the engine's stream")])
def test_wide_seconds_counts_the_kernels_off_the_engine_stream(
        smoke, monkeypatch, streams, calls, fails):
    """The wide path's kernels are those on another stream than the one
    most kernels ran on; wide-path calls with none of them fail. The
    traced rerun (``_trace(wide=True)``) makes ``calls`` wide-path calls
    through the side-stream wrapper, which is taken away after."""
    records = [{"cat": "kernel", "name": f"k{i}", "dur": 10 * (i + 1),
                "ts": 1000.0 * i, "args": {"stream": st}}
               for i, st in enumerate(streams)]
    real = smoke.quant_mod.quant_matmul_wide
    w = smoke.quant_mod.quantize_weight(torch.randn(4, 4), 0)

    def serve(engine, prompts):
        for _ in range(calls):
            smoke.quant_mod.quant_matmul_wide(torch.zeros(1, 4), w.q, w.s,
                                              "int8")

    _fake_profiler(monkeypatch, [records])
    monkeypatch.setattr(smoke, "_serve", serve)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda st: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, st: None)
    if fails:
        with pytest.raises(AssertionError, match=fails):
            smoke._trace(None, [], {}, wide=True)
    else:
        out = smoke._trace(None, [], {}, wide=True)
        assert out["wide_path_calls"] == calls
        assert out["wide_path_s"] == pytest.approx(sum(
            10 * (i + 1) for i, st in enumerate(streams) if st == 13) * 1e-6)
    assert smoke.quant_mod.quant_matmul_wide is real


def test_quant_engine_phase_rehearsed_on_the_cpu(smoke, no_card,
                                                 monkeypatch):
    """Phase 5's quantized engines at a small width on the CPU (f32, dim
    256 so that int4's group of 128 fits): the products go through a
    stand-in of ``models.quant.matmul`` that counts like the card would
    (the kernel up to MAX_ROWS rows, the wide path above), the attention
    wrappers through counting stand-ins, and the profiler is not run."""
    from kubeflow_tpu_torch.models import paged as TP
    from kubeflow_tpu_torch.models import quant as TQ
    from kubeflow_tpu_torch.ops import quant_matmul as QM

    def product(x, w):
        head = w.axis == 1
        if x.numel() // x.shape[-1] > QM.MAX_ROWS:
            return QM.quant_matmul_wide(x, w.q, w.s, w.scheme, head)
        QM.quant_matmul.launches += 1
        return QM.quant_matmul_reference(x, w.q, w.s, w.scheme, head)

    real_ragged, real_flash = TRA.ragged_paged_attention, TA.flash_attention_fwd
    real_dense = TPA.dense_decode_attention

    def ragged(*a, **kw):
        real_ragged.launches += 1
        return TRA.ragged_attention_reference(*a, **kw)

    def flash(*a, **kw):
        real_flash.launches += 1
        return TA.flash_attention_reference(*a, **kw)

    def dense(*a, **kw):
        real_dense.launches += 1
        return TPA.dense_decode_reference(*a, **kw)

    monkeypatch.setattr(TL, "quant_matmul", product)
    monkeypatch.setattr(TP, "ragged_paged_attention", ragged)
    monkeypatch.setattr(TA, "flash_attention_fwd", flash)
    monkeypatch.setattr(TC, "dense_decode_attention", dense)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    real_engine, real_cont = smoke._engine, smoke._cont_engine

    def engine(params, cfg, kv_bits, attn_kernel=None, ragged=True,
               max_new=64):
        eng = real_engine(params, cfg, kv_bits, attn_kernel=False,
                          ragged=ragged, max_new=max_new)
        eng.attn_kernel = attn_kernel is not False
        return eng

    def cont(params, cfg, attn_kernel=None, admit_chunk=None, max_new=64):
        eng = real_cont(params, cfg, attn_kernel=False,
                        admit_chunk=admit_chunk, max_new=max_new)
        if attn_kernel is not False:
            eng._attn_kernel = TC._kernel_block_size(eng.cache_len)
        return eng

    monkeypatch.setattr(smoke, "_engine", engine)
    monkeypatch.setattr(smoke, "_cont_engine", cont)
    monkeypatch.setattr(smoke, "_trace", lambda *a, **k: {
        "quant_s": 0.5, "busy_s": 2.0, "idle_share": 0.5,
        **({"wide_path_s": 0.25, "wide_path_calls": 3}
           if k.get("wide") else {})})
    monkeypatch.setattr(smoke, "QUANT_ENGINES",
                        ((8, ("ragged", "continuous")), (4, ("ragged",))))
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dim=256,
                              ffn_hidden=512, dtype=torch.float32)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rows = smoke.quant_engine_phase(params, cfg)
    assert set(rows) == {"ragged-int8", "continuous-int8", "ragged-int4"}
    for label, row in rows.items():
        assert row["launches"] > 0 and row["wide_calls"] > 0, label
        assert row["trace"]["weight_products_s"] == pytest.approx(0.75)
        assert all(r["fork"] != 0 for r in row["compare"])
    cont_row = rows["continuous-int8"]
    assert cont_row["wide_calls"] == 7 * cfg.n_layers * 16  # 16 admissions
    assert isinstance(params.layers[0].wq, torch.nn.Parameter)
    assert not any(isinstance(m, TQ.QuantizedWeight) for m in params.modules())


@pytest.fixture
def prefix_stand_ins(smoke, monkeypatch):
    """Phase 7 on the CPU: the attention wrappers the engines reach count
    like the kernels and compute the plain versions, and every engine is
    told its kernel is on."""
    from kubeflow_tpu_torch.models import paged as TP

    real = {"decode": TPA.paged_decode_attention,
            "ragged": TRA.ragged_paged_attention,
            "flash": TA.flash_attention_fwd}
    plain = {"decode": TPA.paged_decode_reference,
             "ragged": TRA.ragged_attention_reference,
             "flash": TA.flash_attention_reference}

    def stand_in(name):
        def call(*a, **kw):
            real[name].launches += 1
            return plain[name](*a, **kw)
        return call

    monkeypatch.setattr(TP, "paged_decode_attention", stand_in("decode"))
    monkeypatch.setattr(TP, "ragged_paged_attention", stand_in("ragged"))
    monkeypatch.setattr(TA, "flash_attention_fwd", stand_in("flash"))
    real_engine = smoke._prefix_engine

    def engine(params, cfg, **kw):
        eng = real_engine(params, cfg, **kw)
        eng.attn_kernel = True
        return eng

    monkeypatch.setattr(smoke, "_prefix_engine", engine)


def test_prefix_phase_rehearsed_on_the_cpu(smoke, no_card, prefix_stand_ins):
    """Phase 7 at f32 ``tiny`` width: 360 prefix hits, the launch
    arithmetic of each engine, the swap tier's promoted blocks byte-equal
    to their snapshots, every imported block byte-equal to its payload,
    and the HTTP hops."""
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = smoke.prefix_phase(params, cfg, "a CPU rehearsal")
    assert out["prefix_hits"] == 15 * 24
    assert out["prompt_cache_hits"] == 7
    assert out["flash_launches"] == cfg.n_layers
    assert out["decode_launches"] > 0 and out["swap_in"] > 0
    for kind in ("alternating", "ragged"):
        assert out[f"{kind}_launches"] % cfg.n_layers == 0
    assert out["payload_mb"] > 0


def test_imported_bytes_check_fails_on_one_byte(smoke, no_card,
                                                prefix_stand_ins):
    """``check_imported_bytes`` passes on an import and fails when one
    byte of one block's payload differs from the pool."""
    import base64

    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    a = smoke._prefix_engine(params, cfg, prefix_cache=True)
    out = {}
    a.on_token = lambda rid, tok: out.setdefault(rid, a.export_blocks(rid))
    rid = a.submit(list(range(3, 43)), max_new_tokens=1)
    a.run()
    payload = out[rid]
    b = smoke._prefix_engine(params, cfg)
    bid = b.import_blocks(payload)
    assert smoke.check_imported_bytes(b, bid, payload) == 3
    raw = bytearray(base64.b64decode(payload["blocks"][1]["data"]["v"]))
    raw[5] ^= 1
    payload["blocks"][1]["data"]["v"] = base64.b64encode(bytes(raw)).decode()
    with pytest.raises(AssertionError, match="block 1's v"):
        smoke.check_imported_bytes(b, bid, payload)


# -- phase 8: speculation and multi-LoRA --------------------------------------


def _row_by_row(case):
    """Attention of each owned row over its slot's keys, the span's causal
    rule written out: row j of a span of n rows over kv_len keys sees
    k_pos <= kv_len − n + j where the mask is set."""
    q = case["q"].float()
    out = torch.zeros_like(q)
    bs = case["block_size"]
    g = q.shape[1] // case["k_pool"].shape[1]
    for s, (s0, n, kvl) in enumerate(zip(case["seq_starts"].tolist(),
                                         case["seq_lens"].tolist(),
                                         case["kv_lens"].tolist())):
        blocks = case["tables"][s].long()
        k = case["k_pool"][blocks].float().permute(1, 0, 2, 3).reshape(
            case["k_pool"].shape[1], -1, q.shape[2])
        v = case["v_pool"][blocks].float().permute(1, 0, 2, 3).reshape(
            k.shape)
        for j in range(n):
            seen = (torch.arange(k.shape[1]) <= kvl - n + j) & \
                case["kv_mask"][s]
            for h in range(q.shape[1]):
                scores = (k[h // g] @ q[s0 + j, h]) / q.shape[2] ** 0.5
                p = torch.softmax(scores.masked_fill(~seen, -1e30), dim=0)
                out[s0 + j, h] = p @ v[h // g]
    return out


def test_verify_span_cases_hold_the_span_causality(smoke):
    """Phase 8's "verify-spans" case: 8 slots × 5 rows over 8..564 keys at
    the 64-row width the engine pads to; the plain version equals the
    span rule written out, on every owned row."""
    assert smoke.VERIFY_SPANS == [(5, n) for n in smoke.VERIFY_LENS]
    assert smoke.VERIFY_LENS[0] == 8 and smoke.VERIFY_LENS[-1] == 564
    shape = {**smoke.RAG_VERIFY, "hq": 8, "hkv": 2, "d": 32}
    case = smoke._case(smoke.VERIFY_SPANS, seed=158, **shape)
    owned = smoke._owned(case)
    assert int(owned.sum()) == 40 and case["q"].shape[0] == 64
    plain = ragged_attention_reference(**{**case, "q": case["q"].float()})
    torch.testing.assert_close(plain[owned], _row_by_row(case)[owned],
                               rtol=1e-5, atol=1e-5)
    names = [c[4] for c in smoke.RAGGED_CASES]
    assert {"verify-spans", "verify-spans-4096"} <= set(names)


def test_expected_spec_counts(smoke):
    assert smoke._expected_spec_counts("ragged", 7, 3 * 8, 32) == {
        "ragged": 224, "flash": 24, "decode": 0, "dense": 0}
    for kind in ("alternating", "continuous"):
        assert smoke._expected_spec_counts(kind, 0, 4 * 40, 32) == {
            "ragged": 0, "flash": 160, "decode": 0, "dense": 0}


def test_adapter_draw_is_a_few_percent_of_the_projection(smoke):
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dim=512,
                              ffn_hidden=1024, dtype=torch.float32)
    from kubeflow_tpu_torch.models.lora import LoraConfig

    lcfg = LoraConfig(rank=16, alpha=16.0,
                      targets=("wq", "wk", "w_up", "w_down"))
    ad = smoke._draw_adapter(cfg, lcfg, 30)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for target, ab in ad.items():
        w = getattr(params.layers[1], target)
        x = torch.randn((256, w.shape[0]), generator=torch.Generator()
                        .manual_seed(1))
        ratio = float((x @ ab["a"][1] @ ab["b"][1] * lcfg.scaling).std()
                      / (x @ w).std())
        assert 0.5 * smoke.LORA_DELTA < ratio < 2 * smoke.LORA_DELTA, (
            target, ratio)
    again = smoke._draw_adapter(cfg, lcfg, 30)
    assert all(torch.equal(again[t]["b"], ad[t]["b"]) for t in ad)


@pytest.fixture
def spec_stand_ins(smoke, monkeypatch):
    """Phase 8 on the CPU: the attention wrappers count like the kernels
    and compute the plain versions; every paged engine is told its kernel
    is on; the draft is one layer of tiny's two."""
    from kubeflow_tpu_torch.models import paged as TP

    real = {"ragged": TRA.ragged_paged_attention,
            "flash": TA.flash_attention_fwd}
    plain = {"ragged": TRA.ragged_attention_reference,
             "flash": TA.flash_attention_reference}

    def stand_in(name):
        def call(*a, **kw):
            real[name].launches += 1
            return plain[name](*a, **kw)
        return call

    monkeypatch.setattr(TP, "ragged_paged_attention", stand_in("ragged"))
    monkeypatch.setattr(TA, "flash_attention_fwd", stand_in("flash"))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(smoke, "DRAFT_LAYERS", 1)
    real_prompts = smoke._prompts
    # Prompts of up to 100 tokens where the card's reach 500: the
    # schedules keep their shape (two waves of 8 slots) at a fifth of
    # the CPU's prefill work.
    monkeypatch.setattr(smoke, "_prompts", lambda cfg, n, lo, hi, seed:
                        real_prompts(cfg, n, lo, min(hi, 100), seed))
    for name, inner in (("_spec_engine", "_pb"), ("_engine", None),
                        ("_lora_engine", None)):
        real_make = getattr(smoke, name)

        def make(*a, real_make=real_make, inner=inner, **kw):
            eng = real_make(*a, **kw)
            target = getattr(eng, inner) if inner else eng
            if target.ragged and kw.get("attn_kernel") is not False:
                target.attn_kernel = True
            return eng

        monkeypatch.setattr(smoke, name, make)


def _tiny_f32():
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    return cfg, TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_rollback_check_passes_and_fails_when_skipped(smoke, no_card,
                                                      spec_stand_ins,
                                                      monkeypatch):
    from kubeflow_tpu_torch.models import paged as TP
    from kubeflow_tpu_torch.models.speculative import truncated_draft

    cfg, params = _tiny_f32()
    dparams, dcfg = truncated_draft(params, cfg, 1)
    prompt = smoke._prompts(cfg, 1, 40, 40, 3)[0]
    for bits in (0, 8):
        sb = smoke._spec_engine(params, cfg, dparams, dcfg, bits)
        assert smoke.check_rollback_round(sb, prompt) > 0
        assert sb.free_blocks == sb._pb.num_blocks - 1
    monkeypatch.setattr(TP, "_restore_cells", lambda *a: None)
    sb = smoke._spec_engine(params, cfg, dparams, dcfg, 8)
    with pytest.raises(AssertionError, match="rejected cell"):
        smoke.check_rollback_round(sb, prompt)


def test_spec_lora_phase_rehearsed_on_the_cpu(smoke, no_card,
                                              spec_stand_ins):
    """Phase 8 at f32 ``tiny`` width: the launch arithmetic of each
    engine, free blocks restored, a rollback round, the self-draft's
    acceptance, the adapters' rows against merged engines, the hot cache's
    churn and the HTTP surface."""
    cfg, params = _tiny_f32()
    out = smoke.spec_lora_phase(params, cfg, "a CPU rehearsal")
    for variant in ("bf16", "int8"):
        row = out["ragged"][variant]
        assert row["launches"] > 0 and row["launches"] % cfg.n_layers == 0
        assert row["flash_launches"] >= 16 * smoke.DRAFT_LAYERS
        assert sum(row["widths"].values()) * cfg.n_layers == row["launches"]
    assert out["ragged"]["self_draft_acceptance"] >= smoke.SELF_DRAFT_MIN
    for kind in ("alternating", "continuous"):
        assert out["other"][kind]["flash_launches"] >= 4 * (
            cfg.n_layers + smoke.DRAFT_LAYERS)
    assert out["lora"]["lora_cache"]["evictions"] >= 1


# -- phase 9: checkpoint and observability -------------------------------------


def _tiny_bf16(vocab=256, layers=4):
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny-gqa"], vocab_size=vocab,
                              n_layers=layers)
    return cfg, TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_checkpoint_writer_shards_read_back_equal(smoke, tmp_path):
    """``write_hf_checkpoint``'s 4 shards, read back by ``safetensors``,
    by the port's reader and by ``transformers``, hold the served leaves
    bit for bit under HF's names; its index and config are HF's."""
    import transformers
    from safetensors.torch import load_file

    from kubeflow_tpu_torch.models import convert as TCv

    cfg, params = _tiny_bf16()
    out = smoke.write_hf_checkpoint(params, cfg, str(tmp_path))
    want = TCv.params_to_hf_state_dict(cfg, params)
    shards = sorted(tmp_path.glob("*.safetensors"))
    assert [p.name for p in shards] == [
        f"model-0000{i}-of-00004.safetensors" for i in range(1, 5)]
    assert out == {"bytes": sum(v.numel() * 2 for v in want.values()),
                   "shards": 4, "tensors": len(want)}
    index = json.loads((tmp_path / "model.safetensors.index.json")
                       .read_text())
    read = {}
    for shard in shards:
        got = load_file(str(shard))
        assert got and all(index["weight_map"][k] == shard.name for k in got)
        read.update(got)
    assert set(read) == set(want) == set(index["weight_map"])
    for key, value in want.items():
        assert read[key].dtype == torch.bfloat16
        assert torch.equal(read[key].view(torch.int16),
                           value.contiguous().view(torch.int16)), key
    lcfg, loaded = TCv.load_hf_checkpoint(tmp_path, device="cpu")
    assert lcfg == cfg
    for (n, a), (_, b) in zip(params.named_parameters(),
                              loaded.named_parameters()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n
    hf = transformers.LlamaForCausalLM.from_pretrained(
        tmp_path, torch_dtype=torch.bfloat16)
    for key, value in hf.state_dict().items():
        assert torch.equal(value.view(torch.int16),
                           want[key].contiguous().view(torch.int16)), key


def test_phase_numbering_and_kernels_line_are_kept(smoke):
    """Sixteen phases in order, the checkpoint phase ninth, the finetune
    phase eleventh, the resume phase twelfth, the tp phase thirteenth,
    the train_sharded phase fourteenth, the sp_pp_ep phase fifteenth and
    the fleet_mesh phase last, and the kernels line still naming every
    kernel of the port with all its keys, after the sp_pp_ep and
    fleet_mesh lines."""
    import inspect
    import re

    main = inspect.getsource(smoke.main)
    assert re.findall(r'log\(f?"\[(\d+)/(\d+)\]', main) == [
        (str(i), "16") for i in range(1, 17)]
    assert '"[9/16] checkpoint and observability"' in main
    assert main.index("checkpoint_phase(") < main.index("train_phases(")
    assert main.index("train_phases(") < main.index("finetune_phase(")
    assert main.index("finetune_phase(") < main.index("resume_phase(")
    assert main.index("resume_phase(") < main.index("= tp_phase(")
    assert main.index("= tp_phase(") < main.index("= train_sharded_phase(")
    assert main.index("= train_sharded_phase(") < main.index(
        "= sp_pp_ep_phase(")
    assert main.index("= sp_pp_ep_phase(") < main.index(
        "= fleet_mesh_phase(")
    assert main.index('print(json.dumps({"fleet_mesh": fleet_mesh}))') < (
        main.index('print(json.dumps({"kernels": kernels}))'))
    assert 'print(json.dumps({"train_sharded": sharded}))' in main
    assert main.index('print(json.dumps({"sp_pp_ep": spp}))') < main.index(
        'print(json.dumps({"kernels": kernels}))')
    for name in ("ragged_paged_attention", "flash_attention",
                 "paged_decode_attention", "dense_decode_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "quant_matmul"):
        assert f'"{name}"' in main, name
    for key in ("route", "source", "replaces", "launches", "max_abs_err",
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert f'"{key}"' in main, key
    assert 'print(json.dumps({"ok": True, "device": {' in main


def test_request_trace_check_fails_on_a_broken_chain(smoke):
    def span(name, sid, parent, start, end, events=()):
        return {"name": name, "trace_id": "t", "span_id": sid,
                "parent_id": parent, "start_time": start, "end_time": end,
                "events": list(events)}

    root = span("server.request", "r", "p", 0.0, 1.0, [
        {"name": "first_token", "attributes": {"ttft_s": 0.5}}])
    good = [root, span("queue_wait", "q", "r", 0.0, 0.1),
            span("prefill", "f", "r", 0.1, 0.5),
            span("first_decode", "d", "r", 0.5, 0.5),
            dict(span("engine.step", "s", "", 0.2, 0.3), trace_id="u")]
    assert smoke.check_request_traces(good, {"t": "p"}) == {"t": (0.5, 0.5)}
    broken = [dict(s, parent_id="x") if s["name"] == "prefill" else s
              for s in good]
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_request_traces(broken, {"t": "p"})
    slow = [dict(s, end_time=0.8) if s["name"] == "prefill" else s
            for s in good]
    with pytest.raises(AssertionError, match="spans sum"):
        smoke.check_request_traces(slow, {"t": "p"})
    with pytest.raises(AssertionError, match="hangs off"):
        smoke.check_request_traces(good, {"t": "other"})


def test_checkpoint_phase_rehearsed_on_the_cpu(smoke, no_card, monkeypatch):
    """Phase 9 at tiny width in bf16 (vocab 128256, for phase 6's prompt
    ids) on the CPU: the writer and the bit-equal load; ``serve_http
    --checkpoint --device cpu`` as a process, paged-ragged then
    continuous, held to in-process servers over engines of the same flags
    (phase 6's role), with its traces, /stats and SIGTERM drain; the
    in-process stall capture with a counting ragged stand-in and a stand-in
    profiler whose trace names the ragged kernel."""
    import contextlib as _contextlib

    from kubeflow_tpu_torch.models import paged as TP
    from kubeflow_tpu_torch.models.paged import PagedBatcher
    from kubeflow_tpu_torch.models.serving import GenerationConfig
    from kubeflow_tpu_torch.observability import profiling

    cfg, params = _tiny_bf16(vocab=128256, layers=2)
    monkeypatch.setattr(smoke, "SERVE_DEVICE", ["--device", "cpu"])
    monkeypatch.setattr(smoke, "SERVE_PAGED", [
        "--paged", "--slots", "2", "--num-blocks", "64", "--block-size",
        "16", "--prompt-bucket", "32", "--max-new-tokens", "16"])
    monkeypatch.setattr(smoke, "SERVE_CONT", [
        "--slots", "2", "--cache-len", "64", "--prompt-bucket", "32",
        "--max-new-tokens", "16"])
    monkeypatch.setattr(smoke, "SERVE_ENV", {
        "KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET": "32",
        "KUBEFLOW_TPU_TRACE_RING": "512"})
    gen = GenerationConfig(max_new_tokens=16, eos_id=-1)
    http_tokens = {
        "ragged": smoke.http_phase(PagedBatcher(
            params, cfg, gen=gen, slots=2, num_blocks=64, block_size=16,
            prompt_bucket=32, ragged=True, token_budget=32, device="cpu"),
            "ragged"),
        "continuous": smoke.http_phase(TC.ContinuousBatcher(
            params, cfg, gen=gen, slots=2, cache_len=64, prompt_bucket=32,
            device="cpu"), "continuous")}

    real = TRA.ragged_paged_attention

    def ragged(*a, **kw):
        real.launches += 1
        return TRA.ragged_attention_reference(*a, **kw)

    monkeypatch.setattr(TP, "ragged_paged_attention", ragged)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    real_engine, real_prompts = smoke._engine, smoke._prompts

    def engine(params, cfg, kv_bits, attn_kernel=None, ragged=True,
               max_new=64):
        eng = real_engine(params, cfg, kv_bits, attn_kernel=False,
                          ragged=ragged, max_new=max_new)
        eng.attn_kernel = True
        return eng

    monkeypatch.setattr(smoke, "_engine", engine)
    monkeypatch.setattr(smoke, "_prompts", lambda cfg, n, lo, hi, seed:
                        real_prompts(cfg, n, lo, min(hi, 100), seed))

    @_contextlib.contextmanager
    def trace(log_dir, name):
        path = Path(log_dir) / name
        path.mkdir(parents=True)
        yield path
        (path / profiling.TRACE_FILE).write_text(json.dumps({
            "traceEvents": [{"cat": "kernel", "name": "ragged_kernel<128>"},
                            {"cat": "cpu_op", "name": "aten::mm"}]}))

    monkeypatch.setattr(profiling, "trace", trace)
    out = smoke.checkpoint_phase(params, cfg, "a CPU rehearsal", http_tokens)
    numbers = out["numbers"]
    nbytes = sum(p.numel() * 2 for p in params.parameters())
    assert numbers["load_rss_growth_gb"] < (
        nbytes * 1.25 + smoke.RSS_SLACK) / 1e9
    for kind in ("ragged", "continuous"):
        assert numbers["healthz_s"][kind] > 0
        assert len(numbers["ttft_span_sum_s"][kind]) == (
            4 if kind == "ragged" else 2)
    stall = out["stall"]
    assert stall["launches"] == stall["steps"] * cfg.n_layers > 0
    assert stall["stalls"] >= 1 and stall["trace_ragged_kernels"] == 1
    assert stall["metrics"]["engine_step_stall_total"] == stall["stalls"]


# -- phase 11, finetune -------------------------------------------------------


def _stand_in_fp8_product(monkeypatch):
    """``fp8_product`` replaced by a stand-in that counts like the card's
    ``_scaled_mm`` calls and computes the plain version."""
    from kubeflow_tpu_torch.models import fp8 as TF

    def product(a, b):
        product.launches += 1
        return TF.fp8_product_reference(a, b)

    product.launches = 0
    monkeypatch.setattr(TF, "fp8_product", product)
    return product


@pytest.fixture
def finetune_small(smoke, monkeypatch):
    """Phase 11 at a CPU's size: the flash wrappers and the fp8 product
    counted by stand-ins, S 64 in loss chunks of 16, tiny (bf16, 2 layers)
    for llama-3-8b, 32 rows through three small fp8 shapes, timing stubbed
    (each timed function still runs once) and the example on the CPU."""
    _stand_in_kernels(smoke, monkeypatch)
    product = _stand_in_fp8_product(monkeypatch)
    monkeypatch.setattr(smoke, "FT_MODEL", "tiny")
    monkeypatch.setattr(smoke, "FP8_ROWS", 32)
    monkeypatch.setattr(smoke, "FP8_SHAPES", (("wq", 64, 64),
                                              ("w_gate", 64, 96),
                                              ("w_down", 96, 64)))
    monkeypatch.setattr(smoke, "_time_ms", lambda fn: (fn(), 1.0)[1])
    monkeypatch.setattr(smoke, "SERVE_DEVICE", ["--device", "cpu"])
    return product


def test_fp8_products_rehearsed_on_the_cpu(smoke, no_card, finetune_small):
    rows = smoke.fp8_products_phase("cpu")
    assert set(rows) == {"wq", "w_gate", "w_down"}
    for name, k, n in smoke.FP8_SHAPES:
        by_product = rows[name]
        assert set(by_product) == {"forward", "dx", "dw"}
        assert by_product["forward"]["shape"] == [32, k, n]
        assert by_product["dx"]["shape"] == [32, n, k]
        assert by_product["dw"]["shape"] == [k, 32, n]
        assert by_product["dx"]["dtypes"] == ["torch.float8_e5m2",
                                              "torch.float8_e4m3fn"]
        assert by_product["dw"]["dtypes"] == ["torch.float8_e4m3fn",
                                              "torch.float8_e5m2"]
        for row in by_product.values():
            assert set(smoke.FP8_ROW_KEYS) <= set(row)
            assert all(row[g] <= smoke.GATES[g] for g in smoke.GATES)


def test_fp8_product_gate_fails_on_a_wrong_scale(smoke, no_card,
                                                 finetune_small,
                                                 monkeypatch):
    """A product whose epilogue lost one factor of 1 + 2^-6 fails the
    gates: the check reads the product's own output."""
    real = finetune_small

    def off(a, b):
        return real(a, b) * (1 + 2.0 ** -6)

    off.launches = 0
    from kubeflow_tpu_torch.models import fp8 as TF

    monkeypatch.setattr(TF, "fp8_product", off)
    with pytest.raises(AssertionError, match="fp8 wq forward: kernel vs plain"):
        smoke.fp8_products_phase("cpu")


def test_history_fill_check(smoke):
    cfg = TL.LLAMA_CONFIGS["tiny"]
    from kubeflow_tpu_torch.models import fp8 as TF

    params = TF.wrap_params_fp8(TL.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    assert smoke._check_history_fill(params, 0) == dict.fromkeys(
        ("x_hist", "w_hist", "g_hist"), 0)
    with torch.no_grad():
        for w in smoke._fp8_weights(params):
            for h in w.meta().values():
                h[:2] = 1.0
    assert smoke._check_history_fill(params, 2)["g_hist"] == 0
    # A flushed gradient: a g observation of 0 is counted, not refused.
    params.layers[0].wq.g_hist.data[1] = 0.0
    assert smoke._check_history_fill(params, 2)["g_hist"] == 1
    params.layers[1].w_up.g_hist.data[2] = 3.0
    with pytest.raises(AssertionError, match="more than 2 observations"):
        smoke._check_history_fill(params, 2)
    params.layers[1].w_up.g_hist.data[2] = 0.0
    params.layers[1].w_up.x_hist.data[0] = 0.0
    with pytest.raises(AssertionError, match="zero observations"):
        smoke._check_history_fill(params, 2)


def test_finetune_phase_rehearsed_on_the_cpu(smoke, no_card, finetune_small):
    """Phase 11 whole at tiny width: the LoRA steps launch 2n / n / n flash
    kernels and no fp8 product, the fp8 steps 2n / n / n and 4 × 7 × n fp8
    products, the example 2 × 2 × 2 / 4 / 4."""
    out = smoke.finetune_phase("cpu")
    n = 2 * smoke.TRAIN_STEPS
    assert out["lora"]["launches"] == {"flash": 2 * n, "bwd_dq": n,
                                       "bwd_dkv": n}
    assert out["fp8"]["launches"] == {"flash": 2 * n, "bwd_dq": n,
                                      "bwd_dkv": n, "fp8": 28 * n}
    assert out["example"] == {"flash": 8, "bwd_dq": 4, "bwd_dkv": 4}
    assert abs(out["fp8"]["losses"][0] - out["fp8"]["bf16_loss"]) < 0.15
    assert out["fp8"]["after"] < out["fp8"]["losses"][0]
    assert out["lora"]["after"] < out["lora"]["losses"][0]


def test_finetune_phase_catches_a_moved_base(smoke, no_card, finetune_small,
                                             monkeypatch):
    """A LoRA step that also writes the base fails the byte check."""
    from kubeflow_tpu_torch.models import lora as TLo

    real = TLo.make_lora_train_step

    def leaky(*a, **kw):
        init, step = real(*a, **kw)

        def step_and_write(state, base, tokens):
            with torch.no_grad():
                base.layers[0].wk.data.view(torch.int16)[0, 0] += 1
            return step(state, base, tokens)
        return init, step_and_write

    monkeypatch.setattr(TLo, "make_lora_train_step", leaky)
    with pytest.raises(AssertionError, match="a base weight changed"):
        smoke.finetune_phase("cpu")


# -- phase 12: resume after a preemption --------------------------------------


def test_resume_child_arguments(smoke):
    got = smoke.resume_child_args(["c.bin", "gemma-2b", "4", "2048", "512",
                                   "3", "", "1"])
    assert got == {"corpus": "c.bin", "model": "gemma-2b", "layers": 4,
                   "seq": 2048, "loss_chunk": 512, "steps": 3,
                   "device": None, "expected_devices": 1}
    assert smoke.resume_child_args(["c", "tiny", "2", "32", "0", "1",
                                    "cpu", "1"])["device"] == "cpu"
    assert smoke.resume_config("gemma-2b", 4) == dataclasses.replace(
        TL.LLAMA_CONFIGS["gemma-2b"], n_layers=4)
    for bad in ([], ["c", "gemma-2b", "4", "2048", "512", "3", ""],
                ["c", "gemma-2b", "2048", "512", "3", "", "1"],
                ["c", "no-such-model", "2", "32", "16", "3", "", "1"],
                ["c", "tiny", "0", "32", "16", "3", "", "1"],
                ["c", "tiny", "2", "x", "16", "3", "", "1"],
                ["c", "tiny", "2", "1", "16", "3", "", "1"],
                ["c", "tiny", "2", "32", "-1", "3", "", "1"],
                ["c", "tiny", "2", "32", "16", "0", "", "1"],
                ["c", "tiny", "2", "32", "16", "3", "", "0"],
                ["c", "tiny", "2", "32", "16", "3", "", "x"]):
        with pytest.raises(SystemExit):
            smoke.resume_child_args(bad)


def test_resume_pod_is_the_rendered_single_card_pod(smoke):
    """Phase 12's child env and expected devices come from the pod the
    port renders: one h100 card, grace 120 s → 150 s of termination
    grace, the checkpoint directory, pod index 0."""
    pod = smoke.resume_pod("/ckpt")
    assert pod["expected_devices"] == 1
    assert pod["termination_grace_s"] == smoke.RESUME_GRACE_S + 30
    assert pod["accelerator"].name == "h100"
    assert pod["accelerator"].hbm_gib_per_chip == 80
    env = pod["env"]
    assert {k: env[k] for k in (
        "TPU_WORKER_ID", "TPU_CHECKPOINT_GRACE_S",
        "KUBEFLOW_TPU_CHECKPOINT_DIR", "TPU_CHIPS_PER_HOST_BOUNDS",
        "TPU_HOST_BOUNDS", "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY")} == {
        "TPU_WORKER_ID": "0", "TPU_CHECKPOINT_GRACE_S": "120",
        "KUBEFLOW_TPU_CHECKPOINT_DIR": "/ckpt",
        "TPU_CHIPS_PER_HOST_BOUNDS": "1,1,1", "TPU_HOST_BOUNDS": "1,1,1",
        "TPU_ACCELERATOR_TYPE": "h100-80gb-1", "TPU_TOPOLOGY": "1"}
    assert env["TPU_WORKER_HOSTNAMES"] == (
        "resume-0.resume-hosts.smoke.svc.cluster.local")
    # The pod is the one the controller loop's kubelet made, and the
    # Notebook it mirrors is Healthy.
    loop = pod["loop"]
    try:
        c = loop["cluster"]
        (made,) = c.list("Pod", "smoke")
        assert made["metadata"]["name"] == "resume-0"
        assert made["spec"]["nodeName"] == "gpu-node-1-0"
        status = c.get("Notebook", "resume", "smoke")["status"]
        assert status["gpu"] == {"hosts": 1, "readyHosts": 1,
                                 "sliceHealth": "Healthy",
                                 "acceleratorType": "h100-80gb-1"}
        assert not loop["manager"].reconcile_errors
    finally:
        loop["stub"].stop()


@pytest.mark.parametrize("gpu,match", [
    ({"accelerator": "h100", "topology": "2"}, "nvidia.com/gpu resources"),
    ({"accelerator": "h100-mega", "topology": "1"}, "nodeSelector"),
    ({"accelerator": "h100", "topology": "1", "runtimeVersion": "v2"},
     "runtimeVersion")])
def test_resume_pod_refuses_another_pod(smoke, monkeypatch, gpu, match):
    monkeypatch.setitem(smoke.RESUME_POD, "gpu", gpu)
    with pytest.raises((AssertionError, ValueError), match=match):
        smoke.resume_pod("/ckpt")


def test_cull_pod_culls_and_scales_the_notebook_to_zero(smoke):
    """Phase 12's loop after the child's last save, on the CPU: the
    counters, the idle kernel the stub reports, the cull through the DEV
    proxy, replicas 0 and no pod, the scrape, and the native prober's
    fold equal to the Python prober's."""
    pod = smoke.resume_pod("/ckpt")
    loop = pod["loop"]
    try:
        got = smoke.cull_pod(loop)
        reg = loop["metrics"].registry
        assert reg.get_sample_value("notebook_culling_total") == 1.0
        assert reg.get_sample_value("tpu_chips_reclaimed_total") == 1.0
        assert reg.get_sample_value("tpu_chips_in_use") == 0.0
        assert got["activity"]["reachable"] and not got["activity"]["busy"]
        assert got["probe_s"] > 0 and got["stopped_at"] > 0
        # The culler's two, the native prober's two and the Python one's.
        assert loop["stub"].requests == 6
        events = [e["message"] for e in loop["cluster"].list("Event",
                                                             "smoke")
                  if e["reason"] == "NotebookCulled"]
        assert len(events) == 1 and events[0].endswith(
            "released 1 GPU cards")
    finally:
        loop["stub"].stop()


def test_cull_pod_fails_when_the_idle_time_is_not_reached(smoke,
                                                          monkeypatch):
    pod = smoke.resume_pod("/ckpt")
    try:
        # The culler keeps its 10 minutes; the clock moves 2.
        monkeypatch.setattr(smoke, "RESUME_IDLE_MIN", 1)
        with pytest.raises(AssertionError, match="no stop annotation"):
            smoke.cull_pod(pod["loop"])
    finally:
        pod["loop"]["stub"].stop()


class _StatsServer:
    def __init__(self, stats):
        self._stats = stats

    def stats(self):
        return self._stats


def test_check_metrics_mirror_holds_each_family_to_stats(smoke):
    from kubeflow_tpu_torch.metrics.metrics import Metrics

    m = Metrics()
    m.serving_requests_shed_total.inc(2)
    m.serving_ragged_batch_fill.set(0.123456)
    m.serving_drain_seconds.set(0.5)
    m.serving_prefix_cache_hits_total.inc(24)
    stats = {"requests_shed": 2, "requests_cancelled": 0,
             "deadline_expired": 0, "drain_duration_s": 0.5,
             "ragged": {"batch_fill": 0.1235}, "engine_step_stalls": 0,
             "prefix_cache": {"hits": 24, "misses": 0, "evictions": 0,
                              "cached_blocks": 0}}
    got = smoke.check_metrics_mirror(_StatsServer(stats), m, "t")
    assert got["tpu_serving_prefix_cache_hits_total"] == 24.0
    assert got["tpu_serving_ragged_batch_fill"] == 0.1235
    assert "tpu_serving_kv_swap_out_total" not in got
    assert set(smoke.SERVER_FAMILIES) <= set(smoke.STATS_PARITY)
    bad = dict(stats, requests_shed=3)
    with pytest.raises(AssertionError, match="requests_shed"):
        smoke.check_metrics_mirror(_StatsServer(bad), m, "t")
    m.serving_kv_swap_out_total.inc()  # no kv_swap block: must read 0
    with pytest.raises(AssertionError, match="kv_swap_out"):
        smoke.check_metrics_mirror(_StatsServer(stats), m, "t")


def _digest_by_numpy(t: torch.Tensor, prime: int) -> list:
    raw = t.reshape(-1).view(torch.uint8).numpy().astype(np.int64)
    pos = np.arange(raw.size, dtype=np.int64) % prime
    return [int(raw.sum()), int((raw * pos % prime).sum() % prime)]


def test_leaf_digest_sums_bytes_and_weights_them_by_position(smoke,
                                                             monkeypatch):
    g = torch.Generator().manual_seed(0)
    leaves = [torch.randn((37, 5), generator=g),
              torch.randn(41, generator=g).to(torch.bfloat16),
              torch.tensor(3, dtype=torch.int64), torch.tensor(2.0),
              torch.randn((4, 6), generator=g).t()]  # not contiguous
    want = [_digest_by_numpy(t.contiguous(), smoke.DIGEST_PRIME)
            for t in leaves]
    assert [smoke.leaf_digest(t) for t in leaves] == want
    monkeypatch.setattr(smoke, "DIGEST_CHUNK", 7)  # many chunks a leaf
    assert [smoke.leaf_digest(t) for t in leaves] == want
    # Two bytes swapped keep the sum and move the weighted sum; one byte
    # changed moves both.
    raw = leaves[0].reshape(-1).view(torch.uint8).clone()
    i = int(torch.nonzero(raw[1:] != raw[:-1])[0])
    swapped = raw.clone()
    swapped[i], swapped[i + 1] = raw[i + 1], raw[i]
    got = smoke.leaf_digest(swapped)
    assert got[0] == want[0][0] and got[1] != want[0][1]
    raw[5] ^= 1
    got = smoke.leaf_digest(raw)
    assert got[0] != want[0][0] and got[1] != want[0][1]


def test_child_records_and_logged_seconds(smoke):
    line = smoke.RESUME_TAG + json.dumps({"event": "saved", "step": 3})
    assert smoke.child_record(line) == {"event": "saved", "step": 3}
    assert smoke.child_record("kubeflow_tpu_torch INFO saved 3") is None
    lines = [
        "kubeflow_tpu_torch.runtime.checkpoint INFO checkpoint step 1 "
        "committed in 11.250s",
        "kubeflow_tpu_torch.runtime.checkpoint WARNING emergency save: "
        "committed step 3 in 12.34s",
    ]
    assert smoke.logged_seconds(
        lines, "emergency save: committed step 3") == 12.34
    assert smoke.logged_seconds(lines, "checkpoint step 1 committed") == 11.25
    with pytest.raises(AssertionError, match="no 'step 9'"):
        smoke.logged_seconds(lines, "step 9")


@pytest.fixture()
def resume_small(smoke, no_card, monkeypatch):
    """Phase 12 at ``tiny`` on the CPU: S 64 in loss chunks of 16; the
    parent's flash wrappers are counting stand-ins, the child's run their
    plain versions and count nothing."""
    _stand_in_kernels(smoke, monkeypatch)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    return TL.LLAMA_CONFIGS["tiny"]


def test_resume_phase_rehearsed_on_the_cpu(smoke, resume_small):
    """The child dies of SIGTERM after committing step 3; the parent's
    restore through the orchestrator gives the child's digests, the
    cursor 3, and a step with the stand-ins' launches."""
    out = smoke.resume_phase("tiny")
    n = smoke.RESUME_LAYERS  # the phase's depth cut, whatever the model's
    assert out["layers"] == n != resume_small.n_layers
    assert out["launches"] == {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n}
    assert out["child_launches"] == {
        s: {"flash": 0, "bwd_dq": 0, "bwd_dkv": 0} for s in (1, 2, 3)}
    assert set(out["migration_s"]) == {"save", "claim", "restore", "flip"}
    assert len(out["snapshot_s"]) == len(out["child_step_s"]) == 3
    assert 0 < out["emergency_save_s"] and 0 < out["sigterm_to_exit_s"] < 125
    assert out["restore_validate_s"] + out["restore_copy_s"] <= out[
        "restore_s"]
    assert out["leaves_equal_at_init"] < out["leaves"]


def test_resume_phase_catches_a_wrong_restore(smoke, resume_small,
                                              monkeypatch):
    """A restore that copies every leaf but then zeroes one fails the
    digest check."""
    from kubeflow_tpu_torch.runtime import checkpoint as TCk

    real = TCk._copy_into

    def lossy(copies, own):
        real(copies, own)
        next(t for t, _ in copies if t.is_floating_point()).zero_()

    monkeypatch.setattr(TCk, "_copy_into", lossy)
    with pytest.raises(AssertionError, match="restored leaves differ"):
        smoke.resume_phase("tiny")


def test_group_one_and_eight_cases_run_on_the_card(smoke):
    """Phase 3 holds the ragged kernel at GQA groups 1 and 8 (bf16 and
    int8 pools) and both decode kernels at group 1, beside the groups they
    had."""
    ragged = {s["hq"] // s["hkv"] for _, s, *_ in smoke.RAGGED_CASES}
    decode = {s["hq"] // s["hkv"] for _, s, *_ in smoke.DEC_CASES}
    dense = {s["hq"] // s["hkv"] for _, s, *_ in smoke.DENSE_CASES}
    assert {1, 8} <= ragged and 1 in decode and 1 in dense
    for cases in (smoke.RAGGED_CASES, smoke.DEC_CASES, smoke.DENSE_CASES):
        names = [c[-2] if cases is smoke.RAGGED_CASES else c[-1]
                 for c in cases]
        assert len(names) == len(set(names))


def test_tp_phase_rehearsed_on_the_cpu(smoke, no_card, monkeypatch):
    """Phase 13 at ``tiny`` in float32 on the CPU (bf16 ``tiny``'s
    chosen-token logprobs move by up to 0.022 with the psum order, past
    the rule's 2e-2, where llama-3-8b's move by the 0.004-0.008 of phase
    5's kernel against plain): the kernels at a rank's shapes through
    their plain versions, two gloo children (which count no launches on
    the CPU) held to a one-rank run by the near-tie rule and to each
    other, and the degree-1 plan over a world-1 gloo group bit for bit
    against the one-rank run, its collective functions timed on the
    host."""
    monkeypatch.setattr(smoke, "TP_MODEL", "tiny")
    monkeypatch.setattr(smoke, "TP_DTYPE", "float32")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    prompts = smoke._prompts(cfg, 16, 8, 500, smoke.SEED)
    params = TL.init_params(cfg, torch.Generator().manual_seed(smoke.SEED),
                            "cpu")
    t0 = time.monotonic()
    ragged = smoke._serve(smoke._tp_engine(params, cfg, None, True, 64),
                          prompts)
    p5 = {"ragged": (*ragged, time.monotonic() - t0),
          "alternating": smoke._serve(
              smoke._engine(params, cfg, 0, ragged=False), prompts[::4]),
          "continuous": smoke._serve(smoke._cont_engine(params, cfg),
                                     prompts[::4])}
    out = smoke.tp_phase(p5)
    two = out["degree_2"]
    assert two["launches"] == {"ragged": [0, 0], "flash": [0, 0],
                               "decode": [0, 0], "continuous_flash": [0, 0],
                               "dense": [0, 0]}
    assert two["ragged_steps"] > 0 and two["decode_steps"] > 0
    assert two["continuous_admissions"] == 4
    assert two["continuous_steps"] > 0
    assert two["wq_shape"] == [cfg.dim, cfg.dim // 2]
    assert two["w_down_shape"] == [cfg.ffn_hidden // 2, cfg.dim]
    assert set(two["seconds"]) == {"spawn", "init", "serve", "total"}
    assert len(two["forks"]["ragged"]) == 8
    assert len(two["forks"]["alternating"]) == 4
    assert len(two["forks"]["continuous"]) == 4
    one = out["degree_1"]
    assert one["bit_equal_to_phase_5"]
    assert one["backend"] == "gloo"
    steps = one["steps"]
    assert steps > 0 and one["launches"] == 0
    # A forward's collectives: wo and w_down a layer, the embedding and the
    # head.
    calls = {k: v["calls"] for k, v in one["host_s"].items()}
    assert calls["_tp_sum"] == 2 * cfg.n_layers * calls["_embed"]
    assert calls["_embed"] == calls["_lm_head_logits"] == steps
    assert set(out["kernels"]) == {"ragged", "flash", "decode", "dense"}


def test_train_sharded_phase_rehearsed_on_the_cpu(smoke, no_card,
                                                  monkeypatch):
    """Phase 14 at ``tiny`` (fsdp=2) and ``tiny-gqa`` (tp=2) in float32 on
    the CPU, S 64 in loss chunks of 16: the rank-shape kernels through
    their plain versions at a small shape, the unsharded reference, two
    gloo children each for (a) and (b) (which count no launches on the
    CPU) held to it and to each other, (a)'s save into two ``proc<k>``
    roots and its restore with every digest equal, and
    ``examples/train_sharded`` over a world-1 gloo group resuming at step
    2; then the ``train_sharded`` line's keys."""
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(smoke, "TRAIN_SEQ", 64)
    monkeypatch.setattr(smoke, "LOSS_CHUNK", 16)
    monkeypatch.setattr(smoke, "TS_RANK_SHAPE",
                        (1, 4, 2, 64, 64, True, 0, 0, None))
    monkeypatch.setattr(smoke, "TS_FSDP_MODEL", "tiny")
    monkeypatch.setattr(smoke, "TS_TP_MODEL", "tiny-gqa")
    monkeypatch.setattr(smoke, "TP_DTYPE", "float32")
    cfg = smoke._tp_config("tiny-gqa", "float32")
    # Phase 10's step 1, recorded where it runs.
    with smoke.tempfile.TemporaryDirectory() as tmp:
        corpus = smoke._train_corpus(tmp, cfg.vocab_size)
        with smoke.TokenLoader(corpus, 1, 64, seed=smoke.SEED + 1) as ld:
            tokens = torch.from_numpy(ld.next())
    smoke.STEP_ONE[cfg] = smoke._ts_reference(cfg, tokens)
    out = smoke.train_sharded_phase()
    fsdp, tp = out["fsdp"], out["tp"]
    zero = {"flash": 0, "bwd_dq": 0, "bwd_dkv": 0}
    assert fsdp["launches"] == [zero] * smoke.TS_FSDP_STEPS
    assert tp["launches"] == [zero] * smoke.TS_TP_STEPS
    for part in (fsdp, tp):
        assert part["step1"]["loss_rel"] <= 1e-4
        assert part["step1"]["grad_norm_rel"] <= 1e-4
        assert set(part["seconds"]) >= {"reference", "spawn", "init",
                                        "train", "total"}
        assert len(part["collective_bytes_per_step"]) == len(part["losses"])
        assert all(b > 0 for b in part["collective_bytes_per_step"])
    tiny = TL.LLAMA_CONFIGS["tiny"]
    # fsdp cuts the input dim, tp the output one.
    assert fsdp["wq_shape"] == [tiny.dim // 2, tiny.dim]
    assert tp["wq_shape"] == [cfg.dim, cfg.dim // 2]
    assert fsdp["state_gb"][0] == fsdp["state_gb"][1] > 0
    assert fsdp["resumed_launches"] == [zero, zero]
    assert all(x < fsdp["losses"][0] for x in fsdp["after_loss"])
    assert set(fsdp["seconds"]) >= {"checkpoint"}
    assert out["example"]["backend"] == "gloo"
    assert len(out["example"]["steps"]) == smoke.TS_EXAMPLE_STEPS + 1
    assert set(out["kernels"]) == {"flash", "dq", "dk", "dv"}
    assert smoke.TS_EXAMPLE_NAME not in TL.LLAMA_CONFIGS


# -- phase 15: sequence, pipeline and expert parallelism ---------------------


def test_sp_pp_ep_phase_rehearsed_on_the_cpu(smoke, no_card, monkeypatch):
    """Phase 15 on small stand-ins in float32 on the CPU: the rank-shape
    kernels through their plain versions (the parent's counting
    stand-ins) at a small shape, the MoE reference here (``tiny-moe`` at
    2 layers), and two gloo children (which count no launches on the CPU)
    running (a) ``tiny`` under sp=2 with each sp_impl and (b) under pp=2,
    both held to a reference recorded as phase 14 (a) records it, (c) the
    MoE under ep=2, and (d) ``tiny`` served by the continuous engine at
    sp=2, held to a one-rank run of phase 5's continuous engine by the
    near-tie rule; then the ``sp_pp_ep`` line's keys."""
    _stand_in_kernels(smoke, monkeypatch)
    monkeypatch.setattr(smoke, "TP_MODEL", "tiny")
    monkeypatch.setattr(smoke, "TP_DTYPE", "float32")
    monkeypatch.setattr(smoke, "SPP_MOE_MODEL", "tiny-moe")
    monkeypatch.setattr(smoke, "SPP_MOE_BATCH", (1, 64))
    monkeypatch.setattr(smoke, "SPP_RANK_SHAPE",
                        (2, 4, 4, 64, 64, True, 0, 0, None))
    monkeypatch.setattr(smoke, "SPP_RANK_D", 64)
    cfg = smoke._tp_config("tiny", "float32")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    smoke.SP_REFERENCE.update(model="tiny", tokens=tokens,
                              ref=smoke._ts_reference(cfg, tokens))
    params = TL.init_params(cfg, torch.Generator().manual_seed(smoke.SEED),
                            "cpu")
    prompts = smoke._prompts(cfg, 16, 8, 500, smoke.SEED)[::4]
    p5 = {"continuous": smoke._serve(smoke._cont_engine(params, cfg),
                                     prompts)}
    del params
    out = smoke.sp_pp_ep_phase(p5)
    zero = {"flash": 0, "bwd_dq": 0, "bwd_dkv": 0}
    for impl in smoke.SPP_IMPLS:
        rec = out["sp"]["impls"][impl]
        assert rec["launches"] == [zero, zero]
        assert max(rec["loss_rel"] + rec["grad_norm_rel"]) <= 1e-4, impl
        assert all(c["calls"] > 0 and c["bytes"] > 0
                   for c in rec["collectives"])
    assert out["sp"]["local_seq"] == 32
    assert out["pp"]["launches"] == [zero, zero]
    assert out["pp"]["stage_layers"] == [1, 1]
    assert max(out["pp"]["loss_rel"] + out["pp"]["grad_norm_rel"]) <= 1e-4
    assert out["ep"]["launches"] == [zero, zero]
    assert out["ep"]["experts_per_rank"] == [2, 2]
    assert max(out["ep"]["loss_rel"] + out["ep"]["grad_norm_rel"]) <= 1e-4
    serve = out["serve"]
    assert serve["admissions"] == 4 and serve["decode_steps"] > 0
    assert serve["flash_launches"] == [0, 0]
    assert serve["cache_shape"][3] == 512
    assert len(serve["forks"]) == 4
    assert set(out["kernels"]) == {"flash", "dq", "dk", "dv"}
    for part in ("sp", "pp", "ep", "serve"):
        assert len(out[part]["peak_gib"]) == 2


def test_fleet_mesh_phase_rehearsed_on_the_cpu(smoke, no_card, monkeypatch):
    """Phase 16 on the CPU. (a) at ``tiny`` in bf16 (serve_http's dtype):
    two ``serve_http --device cpu`` replicas behind the port's gateway,
    fused (held to the first replica served directly, the shared-prefix
    prompts on one replica with its prefix hits, one trace from the
    gateway to the replica's prefill span), disagg over ``/kv/*`` and one
    scale-down through ``SmokeProvisioner`` with a stream on each
    replica. (b) at ``tiny`` in float32, cut to 2 layers: two gloo
    children under fsdp=2 and dp=2 (which count no launches on the CPU),
    held to the unsharded engines and to each other, an fsdp rank holding
    half of each leaf fsdp cuts."""
    monkeypatch.setattr(smoke, "SERVE_DEVICE", ["--device", "cpu"])
    monkeypatch.setattr(smoke, "FLEET_MODEL", "tiny")
    monkeypatch.setattr(smoke, "FLEET_SYSTEM", 64)
    monkeypatch.setattr(smoke, "FLEET_OTHER", (24, 70))
    monkeypatch.setattr(smoke, "FLEET_FLAGS", [
        "--paged", "--slots", "4", "--num-blocks", "256", "--block-size",
        "16", "--prompt-bucket", "128", "--max-new-tokens", "180"])
    # tiny decodes fast on the CPU: streams long enough to be in flight
    # through two autoscaler ticks (64 + 180 tokens fit its 256).
    monkeypatch.setattr(smoke, "FLEET_STREAM_NEW", 180)
    monkeypatch.setattr(smoke, "MESH_MODEL", "tiny")
    monkeypatch.setattr(smoke, "MESH_DTYPE", "float32")
    monkeypatch.setattr(smoke, "MESH_LAYERS", 2)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    out = smoke.fleet_mesh_phase("cpu")
    fleet, mesh = out["fleet"], out["mesh"]
    assert len(fleet["healthz_s"]) == 2
    assert fleet["fused"]["trace"] == ["gateway.request", "gateway.route",
                                       "server.request", "prefill"]
    home = fleet["fused"]["home"]
    assert fleet["fused"]["prefix_hits"][home] >= 8
    assert [len(r) for r in fleet["fused"]["routes"].values()] == [6, 6]
    assert len(fleet["disagg"]["handoffs"]) == 6
    assert all(h["bytes"] > 0 for h in fleet["disagg"]["handoffs"])
    down = fleet["scale_down"]
    assert [d["action"] for d in down["decisions"]
            if d["action"] in ("scale_down", "release")] == [
        "scale_down", "release"]
    assert down["victim"] != down["survivor"]
    assert set(out["seconds"]) == {"fleet", "mesh", "total"}
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32,
                              n_layers=2)
    fsdp, dp = mesh["fsdp2"], mesh["dp2"]
    assert fsdp["embed_shape"] == [cfg.vocab_size, cfg.dim // 2]
    assert fsdp["wq_shape"] == [cfg.dim // 2, cfg.dim]
    assert dp["embed_shape"] == [cfg.vocab_size, cfg.dim]
    assert dp["weight_bytes"] == [mesh["whole_weight_bytes"]] * 2
    assert all(b < 0.55 * mesh["whole_weight_bytes"]
               for b in fsdp["weight_bytes"])
    for part in (fsdp, dp):
        for kind in ("ragged", "alternating"):
            assert part[kind]["launches"] == {"ragged": 0, "flash": 0,
                                              "decode": 0}
            assert part[kind]["forwards"] > 0
            assert len(part[kind]["forks"]) == 2
    assert fsdp["ragged"]["gathered_bytes_per_step"] > 0
    assert dp["ragged"]["gathered_bytes_per_step"] == 0
