"""PyTorch port of ``dense_decode_attention`` vs the JAX reference.

The same numpy inputs go through JAX ``dense_decode_attention`` (the
Pallas kernel in interpret mode) and the port's plain version, on the
layout of tests/test_paged_attention.py::TestDenseKernel (3 slots, 8 q /
4 kv heads, C 256, lengths 1/100/256, a hole) and beside it: partial
blocks under an all-True mask, left padding, GQA 4, an idle slot (all-False
row) and a slot at seq_len == C. Tolerances: f32 caches 1e-5; bf16 within
one bf16 rounding of the output (2^-8 relative, of the larger of |ref| and
1). A row that sees no key gives exactly 0. The wrapper's shape refusals
carry JAX's messages. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import paged_attention as J
from kubeflow_tpu_torch.ops import paged_attention as T

C = 256


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seq_lens, seed, hq=8, hkv=4, d=128, mask=None):
    rng = np.random.default_rng(seed)
    b = len(seq_lens)
    return {
        "q": rng.normal(size=(b, hq, d)).astype(np.float32),
        "k_cache": rng.normal(size=(b, hkv, C, d)).astype(np.float32),
        "v_cache": rng.normal(size=(b, hkv, C, d)).astype(np.float32),
        "kv_mask": np.ones((b, C), bool) if mask is None else mask,
        "seq_lens": np.asarray(seq_lens, np.int32),
    }


def _mask(fn, b=3):
    mask = np.ones((b, C), bool)
    fn(mask)
    return mask


LAYOUTS = {
    "hole": dict(seq_lens=[1, 100, 256],
                 mask=_mask(lambda m: m.__setitem__((1, slice(10, 20)),
                                                    False))),
    "partial-blocks": dict(seq_lens=[17, 65, 130]),
    "left-padding": dict(seq_lens=[40, 90, 200],
                         mask=np.arange(C)[None, :] >= np.array(
                             [[0], [30], [150]])),
    "gqa-4": dict(seq_lens=[30, 50, 90], hq=8, hkv=2),
    "idle-and-full": dict(seq_lens=[1, 256, 77],
                          mask=_mask(lambda m: m.__setitem__(0, False))),
}


def _both(inp, dtype):
    jx = {k: jnp.asarray(v) for k, v in inp.items()}
    if dtype == "bf16":
        for k in ("q", "k_cache", "v_cache"):
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
    jout = np.asarray(J.dense_decode_attention(
        **jx, block_size=64, interpret=True).astype(jnp.float32))
    tout = T.dense_decode_attention(**tx, block_size=64)
    assert tout.dtype == tx["q"].dtype and tuple(tout.shape) == jout.shape
    if dtype == "f32":
        np.testing.assert_allclose(tout.numpy(), jout, atol=1e-5, rtol=1e-5)
    else:
        err = np.abs(tout.float().numpy() - jout)
        assert (err <= 2.0 ** -8 * np.maximum(np.abs(jout), 1.0)).all(), \
            err.max()


def test_idle_slot_gives_zero_and_full_slot_reads_every_key():
    """An idle slot (all-False row, position 0) gives exactly 0; a slot at
    seq_len == C sees every key, so its output changes when the last key
    does."""
    inp = _inputs(seed=9, seq_lens=[1, C, 40], mask=_mask(
        lambda m: m.__setitem__(0, False)))
    _, tx = _both(inp, "f32")
    out = T.dense_decode_attention(**tx)
    assert not out[0].any() and torch.isfinite(out).all()
    tx["v_cache"][1, :, C - 1] += 10.0
    assert not torch.equal(T.dense_decode_attention(**tx)[1], out[1])


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_shape_refusals_carry_the_jax_messages():
    jx, tx = _both(_inputs(seed=0, seq_lens=[4, 4, 4]), "bf16")
    cases = [
        ({"block_size": 96}, {"block_size": 96}),
        ({"q": jx["q"][:, :5]}, {"q": tx["q"][:, :5]}),
        ({"kv_mask": jnp.ones((3, 2 * C), bool)},
         {"kv_mask": torch.ones((3, 2 * C), dtype=torch.bool)}),
    ]
    for jkw, tkw in cases:
        jmsg = _jax_error(lambda: J.dense_decode_attention(
            **{**jx, **jkw}, interpret=True))
        with pytest.raises(ValueError) as info:
            T.dense_decode_attention(**{**tx, **tkw})
        assert str(info.value) == jmsg


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor must never reach the kernel")

    monkeypatch.setattr(T, "_library", no_kernel)
    _, tx = _both(_inputs(seed=5, seq_lens=[17, 40, 96]), "bf16")
    before = T.dense_decode_attention.launches
    out = T.dense_decode_attention(**tx)
    assert T.dense_decode_attention.launches == before
    assert torch.equal(out, T.dense_decode_reference(**tx))
