"""PyTorch port of ops/attention.py's flash backward vs the JAX reference.

The same numpy inputs (f32, from a seed) go through the Pallas backward
``_bwd_pallas_call`` in interpret mode (its dq and dk/dv kernels, from the
Pallas forward's O and lse) and through the port's ``flash_attention_bwd``
on CPU tensors (its plain version), from the same O and lse, at head dim
128 and, in two cases of gemma's shape, 256. dq, dk and
dv must agree within 1e-4 of the largest |reference| value; a row that
sees no key has dq exactly 0 on both sides, and a key no row sees has dk
and dv exactly 0. Then ``torch.autograd`` through the port's
``flash_attention`` (the ``FlashAttention`` Function, plain path) is held
to ``jax.grad`` through ``_flash_attention_pallas(interpret=True)`` at the
same tolerance. The CUDA kernels are held against the plain version on
the card by chip_smoke.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import attention as A
from kubeflow_tpu_torch.ops import attention as TA

TOL = 1e-4  # of max |reference|

# name: (b, h, hkv, sq, sk, causal, q_offset, window, mask rows' left pads)
CASES = {
    # GQA 4/2 with a cached-continuation offset and a sliding window at
    # once, tests/test_flash_kernel.py's hardest backward case.
    "gqa-window-q-offset": (1, 4, 2, 256, 384, True, 128, 120, None),
    # Row 1's first 300 keys are padding: its first 300 query rows see no
    # key, and keys 0..99 (row 0) and 0..299 (row 1) are seen by no row.
    "kv-mask-left-pad": (2, 4, 2, 384, 384, True, 0, 0, (100, 300)),
    "non-causal-gqa": (1, 4, 1, 256, 384, False, 0, 0, None),
    # chip_smoke's two kernel-7 schedule cases: a group of 8 q heads per kv
    # head with a q_offset, and a group of 1 with left-padded keys over two
    # batch rows (keys 0..36 and 0..89 seen by no row).
    "group-8": (1, 16, 2, 192, 256, True, 64, 0, None),
    "group-1-mask": (2, 4, 4, 200, 200, False, 0, 0, (37, 90)),
    # Head dim 256 (gemma): gemma-2b's group of q heads over one kv head
    # with a q_offset, and a left-padded mask with a window whose first
    # rows see no key.
    "d256-gemma-q-offset": (1, 4, 1, 128, 192, True, 64, 0, None),
    "d256-mask-window": (2, 2, 1, 128, 128, True, 0, 48, (20, 100)),
}
# Head dim of a case: 128 unless named here.
HEAD_DIM = {"d256-gemma-q-offset": 256, "d256-mask-window": 256}


def _block(length: int) -> int:
    """The Pallas kernels' block: theirs where the length is 128-aligned,
    else 64 or the whole length (interpret mode has no TPU tiling)."""
    return A._pick_block(length) or (64 if length % 64 == 0 else length)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(b, h, hkv, sq, sk, pads, seed=0, d=128):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(b, h, sq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
            for _ in range(2))
    mask = None
    if pads is not None:
        mask = np.arange(sk)[None, :] >= np.asarray(pads)[:, None]
    return q, k, v, do, mask


def _close(got: torch.Tensor, ref, name: str) -> None:
    ref = np.asarray(ref).reshape(got.shape)
    scale = float(np.abs(ref).max()) + 1e-9
    err = float(np.abs(got.detach().numpy() - ref).max())
    assert err / scale < TOL, (name, err, scale)


def _visible(b, h, sq, sk, causal, q_offset, window, mask):
    """(B, H, Sq, Sk) bool: the keys each row sees."""
    q_pos = np.arange(sq)[:, None] + q_offset
    k_pos = np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= k_pos <= q_pos
    if window:
        vis &= k_pos > q_pos - window
    vis = np.broadcast_to(vis, (b, h, sq, sk))
    if mask is not None:
        vis = vis & mask[:, None, None, :]
    return vis


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_pallas_kernels_interpreted(name):
    b, h, hkv, sq, sk, causal, q_offset, window, pads = CASES[name]
    q, k, v, do, mask = _inputs(b, h, hkv, sq, sk, pads,
                                d=HEAD_DIM.get(name, 128))
    d = q.shape[-1]
    mask8 = (None if mask is None
             else jnp.asarray(mask.astype(np.int8).reshape(b, 1, sk)))
    qf = jnp.asarray(q.reshape(b * h, sq, d))
    kf = jnp.asarray(k.reshape(b * hkv, sk, d))
    vf = jnp.asarray(v.reshape(b * hkv, sk, d))
    dof = jnp.asarray(do.reshape(b * h, sq, d))
    blocks = (_block(sq), _block(sk))
    out, lse = A._fwd_pallas_call(qf, kf, vf, causal, q_offset, window,
                                  *blocks, interpret=True, kv_mask8=mask8,
                                  heads=h, kv_heads=hkv)
    delta = jnp.sum(dof * out, axis=-1)
    jdq, jdk, jdv = A._bwd_pallas_call(
        qf, kf, vf, dof, lse, delta, causal, q_offset, window, *blocks,
        interpret=True, kv_mask8=mask8, heads=h, kv_heads=hkv)

    before = (TA.flash_bwd_dq.launches, TA.flash_bwd_dkv.launches)
    tdq, tdk, tdv = TA.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(out).reshape(b, h, sq, d)),
        torch.from_numpy(np.array(lse).reshape(b, h, sq)),
        torch.from_numpy(do), causal, q_offset, window,
        None if mask is None else torch.from_numpy(mask))
    assert (TA.flash_bwd_dq.launches, TA.flash_bwd_dkv.launches) == before
    for name_, got, ref in (("dq", tdq, jdq), ("dk", tdk, jdk),
                            ("dv", tdv, jdv)):
        assert got.dtype == torch.float32
        _close(got, ref, name_)

    vis = _visible(b, h, sq, sk, causal, q_offset, window, mask)
    keyless = ~vis.any(-1)                                  # (B, H, Sq)
    unseen = ~vis.reshape(b, hkv, h // hkv, sq, sk).any((2, 3))  # (B, Hkv, Sk)
    if name == "kv-mask-left-pad":
        assert keyless.any() and unseen.any()
    if name == "group-1-mask":
        assert unseen.any() and not keyless.any()
    if name == "d256-mask-window":
        assert keyless.any() and unseen.any()
    assert not tdq.numpy()[keyless].any()
    assert not np.asarray(jdq).reshape(b, h, sq, d)[keyless].any()
    assert not tdk.numpy()[unseen].any() and not tdv.numpy()[unseen].any()


@pytest.mark.parametrize("name", ["gqa-window-q-offset", "kv-mask-left-pad",
                                  "d256-mask-window"])
def test_autograd_through_the_function_matches_jax_grad(name):
    """Loss = Σ O ⊙ G for a fixed random G, so dO = G."""
    b, h, hkv, sq, sk, causal, q_offset, window, pads = CASES[name]
    q, k, v, g, mask = _inputs(b, h, hkv, sq, sk, pads, seed=1,
                               d=HEAD_DIM.get(name, 128))

    def jloss(q, k, v):
        out = A._flash_attention_pallas(
            q, k, v, causal, q_offset, window, interpret=True,
            kv_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TA.flash_attention(
        tq, tk, tv, causal=causal, q_offset=q_offset, window=window,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    torch.sum(out * torch.from_numpy(g)).backward()
    for name_, got, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                               jgrads):
        _close(got, ref, name_)


def test_xla_impl_differentiates_the_plain_forward():
    """impl="xla" is the plain forward under autograd, no Function: its
    grads equal the Function's on the same inputs within f32 rounding."""
    q, k, v, g, mask = _inputs(1, 4, 2, 64, 96, (10,), seed=2, d=64)
    grads = {}
    for impl in ("auto", "xla"):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = TA.flash_attention(tq, tk, tv, q_offset=32, impl=impl,
                                 kv_mask=torch.from_numpy(mask))
        assert ("FlashAttention" in type(out.grad_fn).__name__) == (
            impl == "auto")
        torch.sum(out * torch.from_numpy(g)).backward()
        grads[impl] = (tq.grad, tk.grad, tv.grad)
    for a, r in zip(grads["auto"], grads["xla"]):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)


def test_backward_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("a CPU tensor must never reach the kernels")

    monkeypatch.setattr(TA, "_bwd_library", no_kernel)
    q, k, v, do, mask = _inputs(1, 4, 2, 40, 72, (3,), seed=3, d=64)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    out, lse = TA.flash_attention_fwd(*args)
    got = TA.flash_attention_bwd(*args, out, lse,
                                 torch.from_numpy(do).to(torch.bfloat16))
    ref = TA.flash_attention_bwd_reference(
        *args, out, lse, torch.from_numpy(do).to(torch.bfloat16))
    for a, r, x in zip(got, ref, args):
        assert a.dtype == x.dtype == torch.bfloat16 and torch.equal(a, r)


def test_backward_refusals():
    q = torch.zeros((1, 4, 8, 64))
    k = torch.zeros((1, 2, 8, 64))
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="dout shape"):
        TA.flash_attention_bwd(q, k, k, q, lse, q[:, :, :4])
    with pytest.raises(ValueError, match="lse shape"):
        TA.flash_attention_bwd(q, k, k, q, lse[:, :2], q)
    with pytest.raises(ValueError, match="not a multiple"):
        TA.flash_attention_bwd(q, k[:, :1].expand(1, 3, 8, 64), k[:, :1]
                               .expand(1, 3, 8, 64), q, lse, q)
