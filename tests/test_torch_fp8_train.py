"""fp8 training in the PyTorch port (models/fp8.py's training half, its
``llama._mm`` dispatch, ``make_train_step(fp8=True)`` and the bridge) vs
the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.

Tolerances, and why:
- ``fp8_matmul``: the casts ``qx``, ``qw`` and ``qg``, the scales and
  every next history are byte-equal (the same f32 arithmetic in the same
  order; torch's CPU casts to e4m3fn and e5m2 after the clip round as
  XLA's do). y, dx and dw differ only in the order of the f32 sums of the
  products: 1e-6 of the largest |reference| value in f32, and one bf16
  rounding (2^-8 of it) where the outputs are bf16.
- One train step from the same state: the loss within 1e-6 relative, the
  histories within 1e-5 relative (amaxes of activations and gradients
  that differ by f32 rounding).
- Four lockstep train steps: f32 activations that differ by ~1e-7 move a
  value near an e4m3 rounding edge one fp8 step (~6%), and from step 2 on
  the two runs take slightly different fp8 roundings. The losses then
  agree within 5e-3 relative, the master weights within 4 · lr of each
  other (AdamW moves each element by about lr a step whatever its
  gradient's size, so a rounding that flips a near-zero gradient's sign
  costs up to 2 · lr a step), and the histories within 25% relative of
  the largest value in each (an amax follows one element). On this file's
  seed the four policies and grad_accum 2 stay within 1.7e-7, 1.12 · lr
  and 8.5e-6; weights from seed 0 on the same batches reached 2.2e-3,
  3.6 · lr and 15.4%, which the bounds cover. Step 1, from zero
  histories (every scale 1.0), is held at the one-step tolerances.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import fp8 as JF
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import train as T
from kubeflow_tpu.parallel.mesh import MeshPlan, make_mesh
from kubeflow_tpu_torch.models import fp8 as TF
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import train as TT
from kubeflow_tpu_torch.models.bridge import params_from_jax, params_to_numpy
from kubeflow_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    flatten_state,
)

LR = 3e-4  # make_optimizer's default, which both train steps use
HISTORIES = ("x_hist", "w_hist", "g_hist")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tiny(dtype=jnp.float32, tdtype=torch.float32):
    return (dataclasses.replace(L.LLAMA_CONFIGS["tiny"], dtype=dtype),
            dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=tdtype))


def _wrapped_pair(seed=0):
    """JAX's fp8-wrapped f32 tiny tree (numpy leaves) and the port's
    ``Llama`` over the same bytes."""
    jcfg, tcfg = _tiny()
    tree = jax.tree.map(np.asarray, JF.wrap_params_fp8(
        L.init_params(jcfg, jax.random.PRNGKey(seed))))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


def _hists(rng, scale_x=3.0, scale_w=0.5, scale_g=2.0, history=16):
    return {name: (np.abs(rng.normal(size=history)) * s).astype(np.float32)
            for name, s in zip(HISTORIES, (scale_x, scale_w, scale_g))}


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
    return np.asarray(t).reshape(-1).view(np.uint8)


# -- fp8_matmul ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("primed", [False, True], ids=["zero", "primed"])
def test_fp8_matmul_matches_jax(dtype, primed):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32) * 2.0
    w = rng.normal(size=(64, 48)).astype(np.float32) * 0.2
    g = rng.normal(size=(2, 24, 48)).astype(np.float32) * 0.01
    hists = _hists(rng) if primed else {
        k: np.zeros(16, np.float32) for k in HISTORIES}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw, jg = (jnp.asarray(a).astype(jdt) for a in (x, w, g))
    tx, tw, tg = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
    y, res = JF._fp8_fwd(jx, jw, {k: jnp.asarray(v) for k, v in hists.items()})
    dx, dw, meta_next = JF._fp8_bwd(res, jg)
    jqg = JF._cast(jg, JF._scale_from(jnp.asarray(hists["g_hist"]),
                                      JF.E5M2_MAX),
                   jnp.float8_e5m2, JF.E5M2_MAX)
    th = {k: torch.from_numpy(v) for k, v in hists.items()}
    ty, qx, qw, sx, sw, nx, nw = TF._fp8_forward(tx, tw, th["x_hist"],
                                                 th["w_hist"])
    tdx, tdw, qg, ng = TF._fp8_backward(tg, qx, qw, sx, sw, th["g_hist"],
                                        tdt, tdt)
    for got, want in ((qx, res[0]), (qw, res[1]), (qg, jqg), (sx, res[2]),
                      (sw, res[3]), (nx, meta_next["x_hist"]),
                      (nw, meta_next["w_hist"]), (ng, meta_next["g_hist"])):
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    for got, want in ((ty, y), (tdx, dx), (tdw, dw)):
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * np.abs(want).max())


def test_autograd_carries_the_next_meta_and_leaves_the_history():
    """Through ``Fp8Matmul``: x and w get dx and dw, each history's
    gradient is its next value, and the histories themselves are not
    changed by the backward."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32) * 3)
    w = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    meta = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in _hists(rng).items()}
    before = {k: v.detach().clone() for k, v in meta.items()}
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    TF.fp8_matmul(xr, wr, meta).backward(g)
    _, qx, qw, sx, sw, nx, nw = TF._fp8_forward(x, w, before["x_hist"],
                                               before["w_hist"])
    dx, dw, _, ng = TF._fp8_backward(g, qx, qw, sx, sw, before["g_hist"],
                                     torch.float32, torch.float32)
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw)
    for name, want in (("x_hist", nx), ("w_hist", nw), ("g_hist", ng)):
        assert torch.equal(meta[name].grad, want)
        assert torch.equal(meta[name].detach(), before[name])
    assert float(meta["x_hist"].grad[0]) == float(x.abs().max())
    assert torch.equal(meta["x_hist"].grad[1:], before["x_hist"][:-1])


def test_a_gradient_under_e5m2_at_scale_one_flushes_as_in_jax():
    """From an empty history g's scale is 1.0, so a gradient below e5m2's
    least subnormal (2^-16) casts to 0 and dx and dw are exactly 0 in
    both frameworks, while the next g history still records max|g|. (On
    llama-3-8b's first step this zeroes the gradient into every
    projection whose output gradient comes through another's dx.)"""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    g = (rng.normal(size=(8, 16)) * 1e-6).astype(np.float32)
    zeros = np.zeros(16, np.float32)
    _, res = JF._fp8_fwd(jnp.asarray(x), jnp.asarray(w),
                         {k: jnp.asarray(zeros) for k in HISTORIES})
    jdx, jdw, jnext = JF._fp8_bwd(res, jnp.asarray(g))
    z = torch.from_numpy(zeros)
    _, qx, qw, sx, sw, _, _ = TF._fp8_forward(torch.from_numpy(x),
                                              torch.from_numpy(w), z, z)
    dx, dw, qg, ng = TF._fp8_backward(torch.from_numpy(g), qx, qw, sx, sw,
                                      z, torch.float32, torch.float32)
    assert not qg.float().any() and not dx.any() and not dw.any()
    assert not np.asarray(jdx).any() and not np.asarray(jdw).any()
    assert float(ng[0]) == float(np.abs(g).max()) == float(jnext["g_hist"][0])


def test_first_step_scale_is_one_not_inf():
    x, w = torch.ones((2, 8)), torch.ones((8, 4))
    y = TF.fp8_matmul(x, w, TF.init_meta(device="cpu"))
    assert torch.equal(y, torch.full((2, 4), 8.0))


def test_overflow_saturates_not_nan():
    """A history far below the data maps the data past e4m3's range: the
    cast clips to ±448 instead of producing NaN, as JAX's does."""
    x = np.array([[1e6, -1e6, 3.0, 0.5]], np.float32)
    w = np.eye(4, dtype=np.float32)
    hist = np.zeros(16, np.float32)
    hist[0] = 1.0
    meta = {k: hist for k in HISTORIES}
    ty, qx, *_ = TF._fp8_forward(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(hist), torch.from_numpy(hist))
    jy, res = JF._fp8_fwd(jnp.asarray(x), jnp.asarray(w),
                          {k: jnp.asarray(v) for k, v in meta.items()})
    assert torch.isfinite(ty).all()
    assert qx.float().abs().max() == TF.E4M3_MAX
    np.testing.assert_array_equal(_bytes(qx), _bytes(res[0]))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_the_card_product_takes_scaled_mm_shapes_or_raises():
    """The card path of ``fp8_product`` on meta tensors (shapes only):
    row-major × column-major operands reach ``torch._scaled_mm`` and count
    a launch; K or N off a multiple of 16, or e5m2 × e5m2, raise instead
    of falling back to the plain version."""
    e4, e5 = torch.float8_e4m3fn, torch.float8_e5m2

    def meta(shape, dtype=e4):
        return torch.empty(shape, dtype=dtype, device="meta")

    before = TF.fp8_product.launches
    for a, b in ((meta((2048, 4096)), meta((4096, 1024))),
                 (meta((2048, 1024), e5), meta((4096, 1024)).t()),
                 (meta((2048, 4096)).t(), meta((2048, 1024), e5))):
        out = TF.fp8_product(a, b)
        assert out.shape == (a.shape[0], b.shape[1])
        assert out.dtype == torch.float32
    assert TF.fp8_product.launches == before + 3
    for a, b, match in ((meta((8, 40)), meta((40, 16)), "multiples of 16"),
                        (meta((8, 32)), meta((32, 24)), "multiples of 16"),
                        (meta((8, 32), e5), meta((32, 16), e5), "e5m2 x e5m2"),
                        (meta((2, 8, 32)), meta((32, 16)), r"\(M, K\)")):
        with pytest.raises(ValueError, match=match):
            TF.fp8_product(a, b)
    assert TF.fp8_product.launches == before + 3


def test_dots_policy_saves_the_fp8_products():
    """JAX's ``dots_with_no_batch_dims_saveable`` saves the fp8 dot; on the
    card that dot is ``aten._scaled_mm``, which "dots" must keep too."""
    from torch.utils.checkpoint import CheckpointPolicy

    for op in (torch.ops.aten.mm.default, torch.ops.aten._scaled_mm.default):
        assert TL._save_dots(None, op) == CheckpointPolicy.MUST_SAVE
    assert (TL._save_dots(None, torch.ops.aten.bmm.default)
            == CheckpointPolicy.PREFER_RECOMPUTE)


# -- the wrapped tree ---------------------------------------------------------


def test_wrap_unwrap_roundtrip_shares_the_masters():
    _, tcfg = _tiny()
    params = TL.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    wrapped = TF.wrap_params_fp8(params)
    assert TF.has_fp8_params(wrapped) and not TF.has_fp8_params(params)
    for i, layer in enumerate(wrapped.layers):
        for t in TF._LAYER_TARGETS:
            w = getattr(layer, t)
            assert isinstance(w, TF.Fp8Weight)
            assert w.hp is getattr(params.layers[i], t)
            assert all(torch.equal(h, torch.zeros(16)) for h in
                       w.meta().values())
        assert layer.attn_norm is params.layers[i].attn_norm
    assert wrapped.embed is params.embed and wrapped.lm_head is params.lm_head
    plain = TF.unwrap_params_fp8(wrapped)
    assert not TF.has_fp8_params(plain)
    assert dict(plain.named_parameters()).keys() == dict(
        params.named_parameters()).keys()
    assert all(a is b for a, b in zip(plain.parameters(), params.parameters()))


def test_init_meta_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.init_meta()
    meta = TF.init_meta(4, device="cpu")
    assert sorted(meta) == sorted(HISTORIES)
    assert all(m.dtype == torch.float32 and m.shape == (4,)
               for m in meta.values())


def test_partition_labels_match_jax():
    """Every history is "fp8_meta" and every other leaf "default", in the
    same count as JAX's labels once the stacked layer axis is unstacked."""
    _, tcfg, tree, tp = _wrapped_pair()
    jl = jax.tree.leaves(JF.fp8_partition_labels(tree))
    labels = TF.fp8_partition_labels(tp)
    n = tcfg.n_layers
    assert (sum(v == "fp8_meta" for v in labels.values())
            == n * jl.count("fp8_meta") == n * 21)
    assert all(labels[f"layers.{i}.{t}.{h}"] == "fp8_meta"
               for i in range(n) for t in TF._LAYER_TARGETS
               for h in HISTORIES)
    assert all(v == "default" for k, v in labels.items()
               if k.rsplit(".", 1)[-1] not in HISTORIES)


def test_bridge_carries_a_wrapped_tree_both_ways():
    jcfg, tcfg, tree, tp = _wrapped_pair(seed=2)
    rng = np.random.default_rng(0)
    for t in ("wq", "w_down"):  # histories of a trained state
        for h in HISTORIES:
            tree["layers"][t]["fp8"][h] = np.abs(rng.normal(
                size=(tcfg.n_layers, 16))).astype(np.float32)
    tp = params_from_jax(tree, tcfg, device="cpu")
    back = params_to_numpy(tp, like=tree)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert torch.equal(tp.layers[1].wq.x_hist,
                       torch.from_numpy(tree["layers"]["wq"]["fp8"]["x_hist"][1]))
    bad = jax.tree.map(lambda a: a, tree)
    del bad["layers"]["wk"]["fp8"]["g_hist"]
    with pytest.raises(ValueError, match="an fp8 leaf holds hp and fp8"):
        params_from_jax(bad, tcfg, device="cpu")


def test_flag_and_tree_mismatch_raise_with_jax_message():
    jcfg, tcfg, tree, tp = _wrapped_pair()
    plan = MeshPlan(make_mesh(devices=jax.devices()[:1]))
    plain_tree = JF.unwrap_params_fp8(tree)
    plain_tp = TF.unwrap_params_fp8(tp)
    for flag, jp, port in ((True, plain_tree, plain_tp), (False, tree, tp)):
        jinit, _ = T.make_train_step(jcfg, plan, fp8=flag)
        tinit, _ = TT.make_train_step(tcfg, fp8=flag)
        with pytest.raises(ValueError) as want:
            jinit(jax.tree.map(jnp.asarray, jp))
        with pytest.raises(ValueError) as got:
            tinit(port)
        assert str(got.value) == str(want.value)
        assert "wrap_params_fp8 AND pass fp8=True" in str(got.value)


# -- make_train_step(fp8=True) ------------------------------------------------


def _jax_step(jcfg, tree, **kw):
    plan = MeshPlan(make_mesh(devices=jax.devices()[:1]))
    init, step = T.make_train_step(jcfg, plan, fp8=True, **kw)
    return T.shard_state(plan, init(jax.tree.map(jnp.asarray, tree))), step


def _compare(jstate, tstate):
    """(max |master diff|, max history diff over its largest value)."""
    jt = jax.tree.map(np.asarray, jstate["params"])
    tt = params_to_numpy(tstate["params"], like=jt)
    masters = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(JF.unwrap_params_fp8(jt)),
        jax.tree.leaves(JF.unwrap_params_fp8(tt))))
    hist = max(float(np.abs(j - p).max() / np.abs(j).max())
               for t in TF._LAYER_TARGETS for h in HISTORIES
               for j, p in [(jt["layers"][t]["fp8"][h],
                             tt["layers"][t]["fp8"][h])])
    return masters, hist


@pytest.mark.parametrize("remat,grad_accum", [
    ("full", 1), ("dots", 1), ("none", 1), ("full", 2)])
def test_train_steps_match_jax(remat, grad_accum):
    """Four steps of both frameworks' ``make_train_step(fp8=True)`` from
    the same wrapped weights on the same batches, the chunked loss with a
    tail (15 positions in chunks of 6)."""
    jcfg, tcfg, tree, tp = _wrapped_pair(seed=4)
    kw = dict(grad_accum=grad_accum, loss_chunk=6, remat=remat)
    jstate, jstep = _jax_step(jcfg, tree, **kw)
    tinit, tstep = TT.make_train_step(tcfg, fp8=True, **kw)
    tstate = tinit(tp)
    for i in range(4):
        toks = _tokens((4, 16), seed=10 + i)
        jstate, jloss = jstep(jstate, jnp.asarray(toks))
        tstate, tloss = tstep(tstate, torch.from_numpy(toks))
        masters, hist = _compare(jstate, tstate)
        first = i == 0
        assert tloss.item() == pytest.approx(
            float(jloss), rel=1e-6 if first else 5e-3), i
        assert masters <= (2e-7 if first else 4 * LR), (i, masters)
        assert hist <= (1e-5 if first else 0.25), (i, hist)
    assert int(tstate["step"]) == int(jstate["step"]) == 4
    # The masters keep their dtype; every history holds 4 observations.
    for layer in tstate["params"].layers:
        w = layer.wq
        assert w.hp.dtype == torch.float32 and w.hp.grad is None
        assert all(int((h != 0).sum()) == 4 and h.grad is None
                   for h in w.meta().values())


def test_one_step_from_primed_histories_matches_jax():
    """One step of each from the same trained-looking state (non-zero
    histories, so every scale is a delayed one), fresh optimizers."""
    jcfg, tcfg, tree, _ = _wrapped_pair(seed=5)
    rng = np.random.default_rng(1)
    for t in TF._LAYER_TARGETS:
        for h, s in zip(HISTORIES, (4.0, 0.3, 0.05)):
            tree["layers"][t]["fp8"][h] = (np.abs(rng.normal(
                size=(jcfg.n_layers, 16))) * s).astype(np.float32)
    tp = params_from_jax(tree, tcfg, device="cpu")
    jstate, jstep = _jax_step(jcfg, tree, loss_chunk=6)
    tinit, tstep = TT.make_train_step(tcfg, fp8=True, loss_chunk=6)
    tstate = tinit(tp)
    toks = _tokens((2, 16), seed=3)
    jstate, jloss = jstep(jstate, jnp.asarray(toks))
    tstate, tloss = tstep(tstate, torch.from_numpy(toks))
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-6)
    masters, hist = _compare(jstate, tstate)
    assert masters <= 2 * LR and hist <= 1e-5, (masters, hist)


def test_adamw_and_the_clip_see_only_the_masters():
    """The optimizer holds every master and no history; a clip norm
    tiny enough to bind takes the global norm over the masters' grads
    only, and the histories land on their next values exactly."""
    _, tcfg = _tiny()
    params = TF.wrap_params_fp8(
        TL.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    opt = TT.make_optimizer(clip_norm=1e-3)
    init, step = TT.make_train_step(tcfg, optimizer=opt, fp8=True,
                                    loss_chunk=0)
    state = init(params)
    held = {id(p) for g in state["opt_state"].param_groups
            for p in g["params"]}
    labels = TF.fp8_partition_labels(params)
    named = dict(params.named_parameters())
    assert held == {id(named[n]) for n, v in labels.items() if v == "default"}
    toks = torch.from_numpy(_tokens((2, 8), seed=0))
    # What the step will compute: grads of the step's starting state.
    loss = TT.causal_lm_loss(params, tcfg, toks)
    loss.backward()
    norm = TT.global_norm([named[n].grad for n, v in labels.items()
                           if v == "default"])
    nexts = {n: named[n].grad.clone() for n, v in labels.items()
             if v == "fp8_meta"}
    params.zero_grad(set_to_none=True)
    seen = []
    real = TT.global_norm
    TT.global_norm = lambda ts: seen.append(len(ts)) or real(ts)
    try:
        state, _ = step(state, toks)
    finally:
        TT.global_norm = real
    assert seen == [len(held)] and float(norm) > 1e-3
    for n, want in nexts.items():
        assert torch.equal(named[n].detach(), want), n


def test_fp8_loss_tracks_bf16():
    """JAX's own bound (tests/test_fp8.py): after 5 steps on one batch the
    fp8 loss has fallen and is within 0.15 of the bf16 run's."""
    cfg = TL.LLAMA_CONFIGS["tiny"]
    toks = torch.from_numpy(_tokens((4, 64), seed=1))

    def run(fp8):
        params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if fp8:
            params = TF.wrap_params_fp8(params)
        init, step = TT.make_train_step(cfg, fp8=fp8, loss_chunk=32)
        state = init(params)
        losses = [float(step(state, toks)[1]) for _ in range(5)]
        return losses, state

    losses8, state = run(True)
    losses16, _ = run(False)
    assert losses8[-1] < losses8[0]
    assert abs(losses8[-1] - losses16[-1]) < 0.15
    wq = state["params"].layers[0].wq
    assert wq.hp.dtype == torch.bfloat16
    assert float(wq.x_hist.detach().max()) > 0
    assert float(wq.g_hist.detach().max()) > 0


def test_fp8_train_state_checkpoint_round_trip(tmp_path):
    """save → restore_latest carries an fp8 train state (masters,
    histories, AdamW moments, step) byte for byte into a fresh one."""
    _, tcfg, _, tp = _wrapped_pair(seed=6)
    init, step = TT.make_train_step(tcfg, fp8=True, loss_chunk=6)
    state = init(tp)
    for i in range(2):
        state, _ = step(state, torch.from_numpy(_tokens((2, 16), seed=i)))
    assert CheckpointManager(tmp_path).save(2, state)
    _, _, _, fresh = _wrapped_pair(seed=7)
    other = init(fresh)
    other, at = CheckpointManager(tmp_path).restore_latest(other)
    assert at == 2
    saved, restored = flatten_state(state), flatten_state(other)
    assert [p for p, _ in saved] == [p for p, _ in restored]
    assert any(".x_hist']" in p for p, _ in saved)
    for (path, a), (_, b) in zip(saved, restored):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(_bytes(a), _bytes(b), err_msg=path)
