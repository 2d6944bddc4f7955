"""Sequence-parallel attention: the port's ring, Ulysses and zigzag
attention and the split-KV sp decode over gloo ranks vs the JAX package's
``make_sharded_*`` functions on a mesh of the same shape over its forced
CPU devices.

The JAX reference runs in this process. The port runs as groups of 2, 3
and 4 gloo processes (``tests/torch_sp_worker.py``), all spawned at once
for the module; each rank attends its piece (batch rows of (dp, fsdp),
heads of tp, positions of sp) and returns its output and the gradients of
sum(out · w) with respect to its q, k and v. Inputs are f32, drawn with
numpy from a seed.

Held within 1e-5 (abs and rel), forward and gradient, each rank's piece
against the same slice of JAX's global result (``jax.grad`` of the
sharded JAX function):

- ring at sp = 2 and 4: causal, non-causal, window, ``q_offset``,
  ``kv_mask`` and all three at once, and with the sub-block scan forced
  (``_RING_BLOCK`` patched to 8 on both sides, several sub-blocks a held
  chunk), and at sp = 3;
- Ulysses at sp = 2 and 4, causal and not, ``kv_mask``, window, and
  composed with tp = 2 (sp = 2 × tp = 2);
- zigzag at sp = 2, 3 and 4;
- the sp decode at sp = 2, 4 and sp = 2 × tp = 2 (GQA-native, 4 q / 2 kv
  heads): scalar, vector and ``per_batch`` positions, window, ``kv_mask``
  and int8 values with their scales, alone and with mask and window.

In this process: ``flash_attention`` with a callable and a registered
impl broadcasts K/V to the full heads as JAX does, and the refusals keep
JAX's messages.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu.parallel.ring_attention import (
    make_sharded_ring_attention,
    make_sharded_sp_decode,
)
from kubeflow_tpu.parallel.ulysses import make_sharded_ulysses_attention
from kubeflow_tpu.parallel.zigzag_attention import (
    make_sharded_zigzag_attention,
)
from kubeflow_tpu_torch.ops import attention as TA
from kubeflow_tpu_torch.parallel import mesh as TM
from tests.torch_sp_harness import collect, launch, region

JR = importlib.import_module("kubeflow_tpu.parallel.ring_attention")
JAX_MAKERS = {"ring": make_sharded_ring_attention,
              "ulysses": make_sharded_ulysses_attention,
              "zigzag": make_sharded_zigzag_attention}
B, H, D = 2, 4, 16
SEQ = {2: 64, 3: 48, 4: 64}
HKV, S_CACHE = 2, 64
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(name, kind, axes, causal=True, q_offset=0, window=0, mask=False,
          block=None):
    return dict(name=name, kind=kind, axes=axes, causal=causal,
                q_offset=q_offset, window=window, mask=mask, block=block)


SP2, SP4, SP3 = dict(sp=2), dict(sp=4), dict(sp=3)
SP2TP2 = dict(sp=2, tp=2)
ATTENTION = {
    2: [
        _case("ring-causal", "ring", SP2),
        _case("ring-full", "ring", SP2, causal=False),
        _case("ring-window", "ring", SP2, window=24),
        _case("ring-offset", "ring", SP2, q_offset=16),
        _case("ring-mask", "ring", SP2, mask=True),
        _case("ring-all", "ring", SP2, q_offset=8, window=40, mask=True),
        _case("ring-block", "ring", SP2, block=8),
        _case("ring-block-all", "ring", SP2, q_offset=8, window=40,
              mask=True, block=8),
        _case("ulysses-causal", "ulysses", SP2),
        _case("ulysses-full", "ulysses", SP2, causal=False),
        _case("ulysses-mask", "ulysses", SP2, mask=True),
        _case("ulysses-window", "ulysses", SP2, window=24, q_offset=4),
        _case("zigzag", "zigzag", SP2),
    ],
    3: [
        _case("zigzag", "zigzag", SP3),
        _case("ring-all", "ring", SP3, q_offset=8, window=40, mask=True),
    ],
    4: [
        _case("ring-causal", "ring", SP4),
        _case("ring-block-all", "ring", SP4, q_offset=8, window=40,
              mask=True, block=8),
        _case("ulysses-causal", "ulysses", SP4),
        _case("ulysses-full-mask", "ulysses", SP4, causal=False, mask=True),
        _case("ulysses-sp2tp2", "ulysses", SP2TP2),
        _case("ulysses-sp2tp2-mask", "ulysses", SP2TP2, mask=True),
        _case("zigzag", "zigzag", SP4),
    ],
}


def _dec(name, axes, pos, per_batch=False, window=0, mask=False,
         int8=False):
    sq = 1 if per_batch or np.ndim(pos) == 0 else len(pos)
    return dict(name=name, axes=axes, pos=pos, per_batch=per_batch,
                window=window, mask=mask, int8=int8, sq=sq)


DECODE = {
    2: [
        _dec("scalar", SP2, 40),
        _dec("vector", SP2, [30, 31, 32]),
        _dec("per-batch", SP2, [20, 50], per_batch=True),
        _dec("window", SP2, 45, window=16),
        _dec("mask", SP2, 60, mask=True),
        _dec("per-batch-window-mask", SP2, [33, 60], per_batch=True,
             window=20, mask=True),
        _dec("int8", SP2, 50, int8=True),
        _dec("int8-window-mask", SP2, [40, 41, 42], window=30, mask=True,
             int8=True),
    ],
    3: [],
    4: [
        _dec("scalar", SP4, 40),
        _dec("per-batch-int8", SP4, [10, 63], per_batch=True, int8=True),
        _dec("sp2tp2-mask", SP2TP2, [20, 50], per_batch=True, mask=True),
        _dec("sp2tp2-int8", SP2TP2, 47, window=12, int8=True),
    ],
}


def _inputs(world: int) -> dict:
    rng = np.random.default_rng(100 + world)
    s = SEQ[world]
    attn = {n: rng.standard_normal((B, H, s, D)).astype(np.float32)
            for n in ("q", "k", "v", "w")}
    mask = np.ones((B, s), bool)
    mask[0, :5] = False
    mask[1, 10:14] = False
    attn["mask"] = mask
    dec = {n: rng.standard_normal((B, HKV, S_CACHE, D)).astype(np.float32)
           for n in ("k", "v")}
    dec["q"] = rng.standard_normal((B, H, 3, D)).astype(np.float32)
    dec["kq"], dec["vq"] = (rng.integers(-127, 128, (B, HKV, S_CACHE, D))
                            .astype(np.int8) for _ in range(2))
    dec["ks"], dec["vs"] = (rng.uniform(0.001, 0.02, (B, HKV, S_CACHE))
                            .astype(np.float32) for _ in range(2))
    dmask = np.ones((B, S_CACHE), bool)
    dmask[0, 3:9] = False
    dmask[1, 35:40] = False
    dec["mask"] = dmask
    return {"attn": attn, "decode": dec}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: (numpy inputs, [each rank's record])}: the groups of 2, 3 and
    4 ranks, run at once."""
    tmp = tmp_path_factory.mktemp("sp-attention")
    started = {}
    for world in (2, 3, 4):
        inp = _inputs(world)
        tensors = {k: {n: torch.from_numpy(np.ascontiguousarray(a))
                       for n, a in v.items()} for k, v in inp.items()}
        scenarios = ["attention"] + (["decode"] if DECODE[world] else [])
        started[world] = (inp, launch(
            tmp, f"w{world}", world, scenarios, tensors,
            attention_cases=ATTENTION[world], decode_cases=DECODE[world]))
    return {w: (inp, collect(*run)) for w, (inp, run) in started.items()}


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return JM.make_mesh(**axes, devices=jax.devices()[:n])


def _jax_attention(inp, case, monkeypatch):
    a = {n: jnp.asarray(v) for n, v in inp["attn"].items()}
    fn = JAX_MAKERS[case["kind"]](_jmesh(case["axes"]))
    kw = {}
    if case["kind"] != "zigzag":
        kw = dict(causal=case["causal"], q_offset=case["q_offset"],
                  window=case["window"],
                  kv_mask=a["mask"] if case["mask"] else None)
    with monkeypatch.context() as m:
        if case["block"]:
            m.setattr(JR, "_RING_BLOCK", case["block"])

        @jax.jit
        def out_and_grads(q, k, v, w):
            out, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, **kw), q, k, v)
            return (out,) + vjp(w)

        got = out_and_grads(a["q"], a["k"], a["v"], a["w"])
    return [np.asarray(x) for x in got]


@pytest.mark.parametrize("world,name", [
    (w, c["name"]) for w in (2, 3, 4) for c in ATTENTION[w]])
def test_attention_matches_jax_forward_and_gradient(runs, monkeypatch,
                                                    world, name):
    inp, recs = runs[world]
    case = next(c for c in ATTENTION[world] if c["name"] == name)
    want = _jax_attention(inp, case, monkeypatch)
    for rec in recs:
        got = rec["attention"][name]
        for key, ref in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(
                got[key].numpy(), region(ref, got["index"]), **TOL,
                err_msg=f"{name} {key} rank {rec['rank']}")


@pytest.mark.parametrize("world,name", [
    (w, c["name"]) for w in (2, 4) for c in DECODE[w]])
def test_sp_decode_matches_jax(runs, world, name):
    inp, recs = runs[world]
    case = next(c for c in DECODE[world] if c["name"] == name)
    d = {n: jnp.asarray(v) for n, v in inp["decode"].items()}
    q = d["q"][:, :, :case["sq"]]
    k, v = (d["kq"], d["vq"]) if case["int8"] else (d["k"], d["v"])
    scales = dict(k_scale=d["ks"], v_scale=d["vs"]) if case["int8"] else {}
    decode = make_sharded_sp_decode(_jmesh(case["axes"]))
    want = np.asarray(jax.jit(lambda q, k, v, pos, mask, scales: decode(
        q, k, v, pos, window=case["window"], kv_mask=mask,
        per_batch=case["per_batch"], **scales))(
            q, k, v, jnp.asarray(case["pos"]),
            d["mask"] if case["mask"] else None, scales))
    for rec in recs:
        got = rec["decode"][name]
        np.testing.assert_allclose(got["out"].numpy(),
                                   region(want, got["index"]), **TOL,
                                   err_msg=f"{name} rank {rec['rank']}")


def test_callable_and_registered_impls_get_full_heads():
    """A callable or registered impl receives K/V broadcast to the q heads
    (kv head j serving q heads j·G .. (j+1)·G - 1), as JAX's dispatch
    gives them, with the mask options passed through."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16))
                             .astype(np.float32)) for _ in range(2))
    seen = {}

    def impl(q, k, v, causal, q_offset, window, kv_mask):
        seen.update(k=k, v=v, causal=causal, q_offset=q_offset,
                    window=window, kv_mask=kv_mask)
        return q

    TA.register_attention_impl("test-impl", impl)
    for choice in (impl, "test-impl"):
        seen.clear()
        assert TA.flash_attention(q, k, v, causal=False, q_offset=3,
                                  window=5, impl=choice) is q
        assert torch.equal(seen["k"], k.repeat_interleave(2, dim=1))
        assert torch.equal(seen["v"][:, 3], v[:, 1])
        assert (seen["causal"], seen["q_offset"], seen["window"],
                seen["kv_mask"]) == (False, 3, 5, None)


def test_refusals_keep_the_jax_messages():
    """Ulysses refuses heads that do not divide by sp and zigzag the masks
    its balanced schedule cannot honor, with JAX's messages; decode wants
    both int8 scales."""
    from kubeflow_tpu_torch.parallel.ring_attention import (
        make_sharded_sp_decode as t_decode,
    )
    from kubeflow_tpu_torch.parallel.ulysses import (
        make_sharded_ulysses_attention as t_ulysses,
    )
    from kubeflow_tpu_torch.parallel.zigzag_attention import (
        make_sharded_zigzag_attention as t_zigzag,
    )

    tplan = TM.MeshPlan(TM.make_mesh(sp=3, devices=[0, 1, 2]))
    jmesh = _jmesh(dict(sp=3))
    q = np.zeros((1, 4, 6, 8), np.float32)
    with pytest.raises(ValueError) as want:
        make_sharded_ulysses_attention(jmesh)(*(jnp.asarray(q),) * 3)
    with pytest.raises(ValueError) as got:
        t_ulysses(tplan)(*(torch.from_numpy(q),) * 3)
    assert str(got.value) == str(want.value)
    for kw in (dict(window=4), dict(q_offset=2), dict(causal=False)):
        with pytest.raises(ValueError) as want:
            make_sharded_zigzag_attention(jmesh)(*(jnp.asarray(q),) * 3,
                                                 **kw)
        with pytest.raises(ValueError) as got:
            t_zigzag(tplan)(*(torch.from_numpy(q),) * 3, **kw)
        assert str(got.value) == str(want.value)
    kq = np.zeros((1, 2, 6, 8), np.int8)
    ks = np.ones((1, 2, 6), np.float32)
    with pytest.raises(ValueError) as want:
        make_sharded_sp_decode(_jmesh(dict(sp=2)))(
            jnp.asarray(q[:, :, :1]), jnp.asarray(kq), jnp.asarray(kq), 3,
            k_scale=jnp.asarray(ks))
    with pytest.raises(ValueError) as got:
        t_decode(TM.MeshPlan(TM.make_mesh(sp=2, devices=[0, 1])))(
            torch.from_numpy(q[:, :, :1]), torch.from_numpy(kq),
            torch.from_numpy(kq), 3, k_scale=torch.from_numpy(ks))
    assert str(got.value) == str(want.value)
