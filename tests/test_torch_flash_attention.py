"""PyTorch port of ops/attention.py's flash forward vs the JAX reference.

The same numpy inputs (f32, from a seed) go through the Pallas forward
``_fwd_pallas_call`` in interpret mode and the port's forward on a CPU
tensor (its plain version). Each case runs twice: as is, which takes the
whole-K/V kernel (``_fwd_whole_call``), and with ``_WHOLE_KV_MAX_BYTES``
set to 0, which takes the streamed kernel, as
tests/test_flash_kernel.py::test_whole_and_streamed_agree does. O and lse
must agree within atol = rtol = 1e-5; lse only where a row sees a key
(a row that sees none gives O = 0 and lse <= -1e29 on both sides). The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as A
from kubeflow_tpu_torch.ops import attention as TA

TOL = dict(atol=1e-5, rtol=1e-5)

# name: (b, h, hkv, sq, sk, causal, q_offset, window, mask rows' left pads)
CASES = {
    "causal": (1, 2, 2, 384, 384, True, 0, 0, None),
    "gqa-8/2": (1, 8, 2, 256, 256, True, 0, 0, None),
    # Row 1's first 300 keys are padding: its first 300 query rows see no
    # key under the causal bound.
    "kv-mask-left-pad": (2, 4, 2, 384, 384, True, 0, 0, (100, 300)),
    "window-q-offset": (1, 2, 2, 256, 384, True, 128, 150, None),
    "non-causal": (1, 2, 1, 256, 384, False, 0, 0, None),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(b, h, hkv, sq, sk, pads, seed=0, d=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    mask = None
    if pads is not None:
        mask = np.arange(sk)[None, :] >= np.asarray(pads)[:, None]
    return q, k, v, mask


def _jax_fwd(q, k, v, mask, causal, q_offset, window):
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out, lse = A._fwd_pallas_call(
        jnp.asarray(q.reshape(b * h, sq, d)),
        jnp.asarray(k.reshape(b * hkv, sk, d)),
        jnp.asarray(v.reshape(b * hkv, sk, d)),
        causal, q_offset, window, A._pick_block(sq), A._pick_block(sk),
        interpret=True,
        kv_mask8=(None if mask is None
                  else jnp.asarray(mask.astype(np.int8).reshape(b, 1, sk))),
        heads=h, kv_heads=hkv,
    )
    return (np.asarray(out).reshape(b, h, sq, d),
            np.asarray(lse).reshape(b, h, sq))


def _visible_rows(b, h, sq, sk, causal, q_offset, window, mask):
    q_pos = np.arange(sq)[:, None] + q_offset
    k_pos = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= k_pos <= q_pos
    if window:
        vis &= k_pos > q_pos - window
    vis = np.broadcast_to(vis, (b, sq, sk))
    if mask is not None:
        vis = vis & mask[:, None, :]
    return np.broadcast_to(vis.any(-1)[:, None, :], (b, h, sq))


@pytest.mark.parametrize("variant", ["whole", "streamed"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_pallas_kernel_interpreted(name, variant,
                                                   monkeypatch):
    b, h, hkv, sq, sk, causal, q_offset, window, pads = CASES[name]
    if variant == "streamed":
        monkeypatch.setattr(A, "_WHOLE_KV_MAX_BYTES", 0)
    assert A._whole_kv_ok(sk, 128, 4) == (variant == "whole")
    q, k, v, mask = _inputs(b, h, hkv, sq, sk, pads)
    jout, jlse = _jax_fwd(q, k, v, mask, causal, q_offset, window)
    tout, tlse = TA.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, q_offset, window,
        None if mask is None else torch.from_numpy(mask))
    assert tout.dtype == torch.float32 and tlse.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)
    has = _visible_rows(b, h, sq, sk, causal, q_offset, window, mask)
    np.testing.assert_allclose(tlse.numpy()[has], jlse[has], **TOL)
    if not has.all():
        assert name == "kv-mask-left-pad"
        assert (tlse.numpy()[~has] <= -1e29).all()
        assert (jlse[~has] <= -1e29).all()
        assert not tout.numpy()[~has].any()


def test_flash_attention_matches_the_xla_path_at_unaligned_lengths():
    """The port takes any Sq, Sk: hold it to JAX's XLA path (the only one
    JAX runs at unaligned lengths), with GQA, a mask and a window."""
    q, k, v, mask = _inputs(2, 4, 2, 100, 100, (7, 60), seed=3, d=64)
    kw = dict(causal=True, q_offset=0, window=40)
    ref = A.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            impl="xla", kv_mask=jnp.asarray(mask), **kw)
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    for impl in ("auto", "xla"):
        out = TA.flash_attention(tq, tk, tv, impl=impl, kv_mask=tm, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor must never reach the kernel")

    monkeypatch.setattr(TA, "_library", no_kernel)
    q, k, v, mask = _inputs(1, 4, 2, 64, 64, (5,), seed=4)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    before = TA.flash_attention_fwd.launches
    out, lse = TA.flash_attention_fwd(*args, kv_mask=torch.from_numpy(mask))
    assert TA.flash_attention_fwd.launches == before
    ref, ref_lse = TA.flash_attention_reference(
        *args, kv_mask=torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_refusals():
    q = torch.zeros((1, 4, 8, 64))
    k = torch.zeros((1, 2, 8, 64))
    for impl in ("ring", "pallas", lambda *a, **kw: None):
        with pytest.raises(NotImplementedError, match="sequence-parallel"):
            TA.flash_attention(q, k, k, impl=impl)
    with pytest.raises(ValueError, match="not a multiple"):
        TA.flash_attention(torch.zeros((1, 5, 8, 64)), k, k)
    with pytest.raises(ValueError, match="kv_mask shape"):
        TA.flash_attention_fwd(q, k, k, kv_mask=torch.ones((1, 7), dtype=bool))
