"""chip_smoke.py's kernel-vs-plain gates and continuous engine phase,
rehearsed on the CPU.

The card runs each CUDA kernel against its plain version; here the plain
version stands in for the kernel: rounded once to bf16 it must pass every
gate, and with one 16-key block of a 640-key history dropped, or its
output 3% off, it must fail. Shapes are llama-3-8b's heads: 16 rows of
the ragged kernel (bf16 and int8 pools) and of the flash kernel (rows at
positions 624..639), and 2 slots of the paged and dense decode kernels.

The dense kernel's phase-3 cases run through ``dense_vs_plain`` as they
will on the card (the wrapper's plain version stands in for the kernel).
``continuous_phase`` runs at a small f32 width on the CPU with the kernel
wrappers it reaches replaced by counting stand-ins that call the plain
versions, so its launch arithmetic, comparisons and output checks are
exercised before the card sees them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from kubeflow_tpu_torch.models import continuous as TC
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.ops import attention as TA
from kubeflow_tpu_torch.ops import paged_attention as TPA
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

    def engine(params, cfg, attn_kernel=None, admit_chunk=None):
        eng = real_engine(params, cfg, attn_kernel=False,
                          admit_chunk=admit_chunk)
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
