"""chip_smoke.py's kernel-vs-plain gates, exercised on the CPU.

The card runs the CUDA kernel against the plain version; here the plain
version stands in for the kernel: rounded once to bf16 it must pass every
gate, and with one block of a 640-key history dropped, or its output 3%
off, it must fail. Shapes are llama-3-8b's heads at 16 rows.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from kubeflow_tpu_torch.ops.ragged_attention import ragged_attention_reference

ROOT = Path(__file__).resolve().parent.parent
SHAPE = dict(hq=32, hkv=8, d=128, bs=16, maxb=40, nb=81, t=16)
SPANS = [(1, 640), (8, 640)]  # a decode row and a chunk, 640 keys each


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
    case = smoke._case(SPANS, seed=0, **SHAPE)
    return case if variant == "bf16" else smoke._quantized(case)


def _failed(smoke, errs) -> list[str]:
    return [g for g, limit in smoke.GATES.items() if not errs[g] <= limit]


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_plain_version_rounded_to_bf16_passes_every_gate(smoke, variant):
    case = _case(smoke, variant)
    out = ragged_attention_reference(**case)  # bf16 q: one output rounding
    errs = smoke._errors(out, case, smoke._owned(case))
    assert not _failed(smoke, errs), errs


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_a_dropped_kv_block_fails_the_relative_gates(smoke, variant):
    case = _case(smoke, variant)
    mask = case["kv_mask"].clone()
    mask[:, 320:336] = False  # one 16-key block in the middle of each slot
    out = ragged_attention_reference(**{**case, "kv_mask": mask})
    errs = smoke._errors(out, case, smoke._owned(case))
    assert {"rel", "row_rel"} <= set(_failed(smoke, errs)), errs


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_an_output_three_percent_off_fails_the_row_gate(smoke, variant):
    case = _case(smoke, variant)
    out = (ragged_attention_reference(**case).float() * 1.03).to(
        torch.bfloat16)
    errs = smoke._errors(out, case, smoke._owned(case))
    assert "row_rel" in _failed(smoke, errs), errs
