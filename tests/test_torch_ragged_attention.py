"""PyTorch port of ops/ragged_attention.py vs the JAX reference.

The same numpy inputs go through JAX ``ragged_attention_reference`` (and,
on two layouts, the Pallas kernel in interpret mode) and the port's plain
version, on the span layouts of tests/test_ragged_attention.py, bf16 and
int8 pools. Tolerances on owned rows: f32 inputs 1e-5; bf16 inputs 2e-2
(the two sides round the bf16 output at different points). Unowned rows
are exactly 0. The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models.llama import _kv_quantize
from kubeflow_tpu.ops import ragged_attention as J
from kubeflow_tpu_torch.ops import ragged_attention as T

BS, MAXB, NB, TROWS = 16, 6, 32, 24

LAYOUTS = [
    [(1, 17), (1, 40), (1, 96)],          # decode-only
    [(8, 8), (12, 12), (4, 20)],          # prefill-only chunks
    [(1, 33), (10, 10), (1, 5)],          # mixed decode + prefill
    [(1, 64), (1, 96), (6, 22)],          # mixed, longer histories
    [(5, 30), (1, 1), (0, 0)],            # single-token tail + idle
]
ALL_TRUE = [(1, 25), (7, 18), (1, 90)]    # kv_mask True everywhere


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(spans, seed, all_true=False, hq=8, hkv=4, d=128):
    """numpy q/pools/tables + metadata for [(seq_len, kv_len)]."""
    rng = np.random.default_rng(seed)
    s = len(spans)
    out = {
        "q": rng.normal(size=(TROWS, hq, d)).astype(np.float32),
        "k_pool": rng.normal(size=(NB, hkv, BS, d)).astype(np.float32),
        "v_pool": rng.normal(size=(NB, hkv, BS, d)).astype(np.float32),
        "tables": rng.permutation(NB)[: s * MAXB].reshape(s, MAXB)
        .astype(np.int32),
    }
    starts, lens, kvls, row = [], [], [], 0
    for n, kvl in spans:
        starts.append(row)
        lens.append(n)
        kvls.append(kvl)
        row += n
    out["seq_starts"] = np.asarray(starts, np.int32)
    out["seq_lens"] = np.asarray(lens, np.int32)
    out["kv_lens"] = np.asarray(kvls, np.int32)
    out["kv_mask"] = (np.ones((s, MAXB * BS), bool) if all_true else
                      np.arange(MAXB * BS)[None, :] < out["kv_lens"][:, None])
    return out


def _both(inp: dict, dtype: str, int8: bool):
    """The same values for both frameworks: q/pools cast to ``dtype`` (f32
    → bf16 rounds to nearest even on both sides); int8 pools quantized
    once, by JAX, and handed over as bytes."""
    jx = {k: jnp.asarray(v) for k, v in inp.items()}
    if dtype == "bf16":
        for k in ("q", "k_pool", "v_pool"):
            jx[k] = jx[k].astype(jnp.bfloat16)
    if int8:
        jx["k_pool"], jx["k_scale_pool"] = _kv_quantize(jx["k_pool"])
        jx["v_pool"], jx["v_scale_pool"] = _kv_quantize(jx["v_pool"])
    tx = {}
    for k, v in jx.items():
        a = np.asarray(v)
        tx[k] = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                 if a.dtype.name == "bfloat16" else torch.from_numpy(a.copy()))
    return jx, tx


def _owned(inp) -> np.ndarray:
    owned = np.zeros(TROWS, bool)
    for s0, n in zip(inp["seq_starts"], inp["seq_lens"]):
        owned[s0:s0 + n] = True
    return owned


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _check(jout, tout, inp, dtype):
    owned = _owned(inp)
    tol = 1e-5 if dtype == "f32" else 2e-2
    err = np.abs(_f32(jout)[owned] - _f32(tout)[owned]).max()
    assert err <= tol, f"port diverges from JAX by {err}"
    assert not _f32(tout)[~owned].any(), "unowned rows must read 0"


@pytest.mark.parametrize("int8", [False, True], ids=["bf16pool", "int8pool"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", range(len(LAYOUTS) + 1))
def test_reference_matches_jax_reference(layout, dtype, int8):
    all_true = layout == len(LAYOUTS)
    inp = _inputs(ALL_TRUE if all_true else LAYOUTS[layout], seed=layout,
                  all_true=all_true)
    jx, tx = _both(inp, dtype, int8)
    jout = J.ragged_attention_reference(**jx, block_size=BS)
    tout = T.ragged_attention_reference(**tx, block_size=BS)
    assert tout.dtype == tx["q"].dtype and tuple(tout.shape) == jout.shape
    _check(jout, tout, inp, dtype)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16pool", "int8pool"])
@pytest.mark.parametrize("spans", [LAYOUTS[2], [(3, 19), (9, 41), (12, 12)]])
def test_reference_matches_pallas_kernel_interpreted(spans, int8):
    inp = _inputs(spans, seed=11)
    jx, tx = _both(inp, "bf16", int8)
    jout = J.ragged_paged_attention(**jx, block_size=BS, q_tile=8,
                                    interpret=True)
    tout = T.ragged_attention_reference(**tx, block_size=BS)
    # The Pallas kernel leaves unowned rows unspecified: owned rows only.
    owned = _owned(inp)
    err = np.abs(_f32(jout)[owned] - _f32(tout)[owned]).max()
    assert err <= 2e-2, f"port diverges from the Pallas kernel by {err}"


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_wrapper_validation_raises_like_jax():
    inp = _inputs(LAYOUTS[0], seed=0)
    jx, tx = _both(inp, "bf16", int8=True)
    jq, tq = _both(inp, "bf16", int8=False)
    cases = [
        # (jax kwargs, torch kwargs): pool block size, head divisibility,
        # scale pairing, scale shape, kv_mask shape.
        (dict(jq, block_size=8), dict(tq, block_size=8)),
        (dict(jq, q=jq["q"][:, :7], block_size=BS),
         dict(tq, q=tq["q"][:, :7], block_size=BS)),
        (dict(jq, k_scale_pool=jx["k_scale_pool"], block_size=BS),
         dict(tq, k_scale_pool=tx["k_scale_pool"], block_size=BS)),
        (dict(jx, k_scale_pool=jx["k_scale_pool"][:, :, :8],
              block_size=BS),
         dict(tx, k_scale_pool=tx["k_scale_pool"][:, :, :8],
              block_size=BS)),
        (dict(jq, kv_mask=jq["kv_mask"][:, :7], block_size=BS),
         dict(tq, kv_mask=tq["kv_mask"][:, :7], block_size=BS)),
    ]
    for jkw, tkw in cases:
        jmsg = _jax_error(lambda: J.ragged_paged_attention(**jkw,
                                                           interpret=True))
        with pytest.raises(ValueError) as info:
            T.ragged_paged_attention(**tkw)
        assert str(info.value) == jmsg


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor must never reach the kernel")

    monkeypatch.setattr(T, "_library", no_kernel)
    inp = _inputs(LAYOUTS[2], seed=5)
    _, tx = _both(inp, "bf16", int8=True)
    before = T.ragged_paged_attention.launches
    out = T.ragged_paged_attention(**tx, block_size=BS)
    assert T.ragged_paged_attention.launches == before
    ref = T.ragged_attention_reference(**tx, block_size=BS)
    assert torch.equal(out, ref)
