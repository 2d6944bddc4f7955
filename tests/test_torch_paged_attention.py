"""PyTorch port of ops/paged_attention.py vs the JAX reference.

The same numpy inputs go through JAX ``paged_decode_attention`` (the
Pallas kernel in interpret mode) and the port's plain version, on the
layouts of tests/test_paged_attention.py::TestKernelVsGathered: partial
tail blocks, all-True mask rows bounded by position, holes and a wholly
masked block, and GQA. Tolerances: f32 pools 1e-5; bf16 pools within one
bf16 rounding of the output (2^-8 relative, of the larger of |ref| and
1). A row that sees no key gives 0. The wrapper's shape refusals carry
JAX's messages. The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import paged_attention as J
from kubeflow_tpu_torch.ops import paged_attention as T

BS, MAXB, NB = 16, 6, 32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seq_lens, seed, hq=8, hkv=4, d=128, mask=None):
    rng = np.random.default_rng(seed)
    b = len(seq_lens)
    seq = np.asarray(seq_lens, np.int32)
    if mask is None:
        mask = np.arange(MAXB * BS)[None, :] < seq[:, None]
    return {
        "q": rng.normal(size=(b, hq, d)).astype(np.float32),
        "k_pool": rng.normal(size=(NB, hkv, BS, d)).astype(np.float32),
        "v_pool": rng.normal(size=(NB, hkv, BS, d)).astype(np.float32),
        "tables": rng.permutation(NB)[: b * MAXB].reshape(b, MAXB)
        .astype(np.int32),
        "kv_mask": mask,
        "seq_lens": seq,
    }


def _holes():
    mask = np.arange(MAXB * BS)[None, :] < np.full((3, 1), 60)
    mask[0, 5:9] = False
    mask[1, 16:32] = False  # block 1 wholly masked
    return mask


LAYOUTS = {
    "partial-tails": dict(seq_lens=[17, 40, 96]),
    "all-true-bounded-by-position": dict(
        seq_lens=[1, 33, 96], mask=np.ones((3, MAXB * BS), bool)),
    "holes-and-masked-block": dict(seq_lens=[60, 60, 60], mask=_holes()),
    "gqa": dict(seq_lens=[30, 50, 90], hq=8, hkv=2),
}


def _both(inp, dtype):
    jx = {k: jnp.asarray(v) for k, v in inp.items()}
    if dtype == "bf16":
        for k in ("q", "k_pool", "v_pool"):
            jx[k] = jx[k].astype(jnp.bfloat16)
    tx = {}
    for k, v in jx.items():
        a = np.asarray(v)
        tx[k] = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                 if a.dtype.name == "bfloat16" else torch.from_numpy(a.copy()))
    return jx, tx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_version_matches_pallas_kernel_interpreted(layout, dtype):
    inp = _inputs(seed=len(layout), **LAYOUTS[layout])
    jx, tx = _both(inp, dtype)
    jout = np.asarray(J.paged_decode_attention(
        **jx, block_size=BS, interpret=True).astype(jnp.float32))
    tout = T.paged_decode_attention(**tx, block_size=BS)
    assert tout.dtype == tx["q"].dtype and tuple(tout.shape) == jout.shape
    if dtype == "f32":
        np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5, rtol=1e-5)
    else:
        err = np.abs(tout.float().numpy() - jout)
        assert (err <= 2.0 ** -8 * np.maximum(np.abs(jout), 1.0)).all(), \
            err.max()


def test_a_row_with_no_visible_key_gives_zero():
    """An idle slot of the engine: table row 0, position 0, all-False
    mask; and a stale length past MAXB·BS, which must stop at MAXB."""
    inp = _inputs(seed=9, seq_lens=[1, 10_000, 40])
    inp["kv_mask"][0] = False
    _, tx = _both(inp, "f32")
    out = T.paged_decode_attention(**tx, block_size=BS)
    assert not out[0].any()
    assert torch.isfinite(out).all()


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_shape_refusals_carry_the_jax_messages():
    inp = _inputs(seed=0, seq_lens=[4, 4, 4])
    jx, tx = _both(inp, "bf16")
    cases = [
        (dict(jx, block_size=8), dict(tx, block_size=8)),
        (dict(jx, q=jx["q"][:, :5], block_size=BS),
         dict(tx, q=tx["q"][:, :5], block_size=BS)),
        (dict(jx, kv_mask=jnp.ones((3, 2 * MAXB * BS), bool), block_size=BS),
         dict(tx, kv_mask=torch.ones((3, 2 * MAXB * BS), dtype=torch.bool),
              block_size=BS)),
    ]
    for jkw, tkw in cases:
        jmsg = _jax_error(lambda: J.paged_decode_attention(**jkw,
                                                           interpret=True))
        with pytest.raises(ValueError) as info:
            T.paged_decode_attention(**tkw)
        assert str(info.value) == jmsg


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor must never reach the kernel")

    monkeypatch.setattr(T, "_library", no_kernel)
    _, tx = _both(_inputs(seed=5, seq_lens=[17, 40, 96]), "bf16")
    before = T.paged_decode_attention.launches
    out = T.paged_decode_attention(**tx, block_size=BS)
    assert T.paged_decode_attention.launches == before
    assert torch.equal(out, T.paged_decode_reference(**tx, block_size=BS))
