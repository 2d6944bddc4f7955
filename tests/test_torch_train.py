"""PyTorch port of models/train.py vs the JAX reference.

f32 ``tiny``, ``tiny-gqa`` and a gemma-2b-shaped ``gemma-tiny`` (head
dim 256, GELU, (1 + w) norms, scaled and tied embeddings, cut to a small
width, depth, ffn and vocab) with JAX's weights brought over through
``models/bridge.py``, tokens from a numpy seed, everything on the CPU
(the port's attention through the plain versions of the flash forward and
backward). Tolerances: the losses 1e-5; gradients 1e-4 of the largest
|reference| value (the sums run in another order); the schedule and the
AdamW updates 1e-6 (f32 arithmetic of one formula); train-step losses
over four steps 1e-4 relative (the updates compound the rounding).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import train as T
from kubeflow_tpu.parallel.mesh import MeshPlan, make_mesh
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import train as TT
from kubeflow_tpu_torch.parallel import mesh as TM
from kubeflow_tpu_torch.models.bridge import params_from_jax


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# gemma-2b's published config with only its sizes cut: head_dim_override
# 256, GELU, norm_add_unit, embed_scale and tie_embeddings stay.
GEMMA_TINY = dict(vocab_size=256, dim=128, n_layers=2, n_heads=2,
                  n_kv_heads=1, ffn_hidden=256, max_seq_len=256)


def _model(name, seed=0):
    if name == "gemma-tiny":
        jcfg = dataclasses.replace(L.LLAMA_CONFIGS["gemma-2b"],
                                   dtype=jnp.float32, **GEMMA_TINY)
        tcfg = dataclasses.replace(TL.LLAMA_CONFIGS["gemma-2b"],
                                   dtype=torch.float32, **GEMMA_TINY)
    else:
        jcfg = dataclasses.replace(L.LLAMA_CONFIGS[name], dtype=jnp.float32)
        tcfg = dataclasses.replace(TL.LLAMA_CONFIGS[name],
                                   dtype=torch.float32)
    tree = jax.tree.map(np.asarray, L.init_params(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(
        tree, tcfg, device="cpu")


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


def _grad_tree(model: TL.Llama) -> dict:
    """The port's grads in the JAX tree's layout (layer leaves stacked); a
    tied config has no ``lm_head`` leaf, as the JAX tree has none."""
    out = {n: getattr(model, n).grad.numpy() for n in ("embed", "final_norm",
                                                        "lm_head")
           if getattr(model, n) is not None}
    out["layers"] = {
        name: np.stack([getattr(layer, name).grad.numpy()
                        for layer in model.layers])
        for name in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                     "w_gate", "w_up", "w_down")
    }
    return out


class TestLosses:
    @pytest.mark.parametrize("name", ["tiny", "tiny-gqa"])
    def test_losses_match(self, name):
        jcfg, tcfg, jp, tp = _model(name)
        toks = _tokens((2, 24), jcfg.vocab_size)
        tt = torch.from_numpy(toks)
        with torch.no_grad():
            np.testing.assert_allclose(
                TT.per_token_nll(tp, tcfg, tt).numpy(),
                np.asarray(T.per_token_nll(jp, jcfg, jnp.asarray(toks))),
                rtol=1e-5, atol=1e-5)
            ref = float(T.causal_lm_loss(jp, jcfg, jnp.asarray(toks)))
            assert TT.causal_lm_loss(tp, tcfg, tt).item() == pytest.approx(
                ref, rel=1e-5)
            # 23 positions in chunks of 5: four chunks and a tail of 3.
            chunked = TT.chunked_causal_lm_loss(tp, tcfg, tt, chunk=5)
        jchunked = float(T.chunked_causal_lm_loss(jp, jcfg, jnp.asarray(toks),
                                                  chunk=5))
        assert chunked.item() == pytest.approx(jchunked, rel=1e-5)
        assert chunked.item() == pytest.approx(ref, rel=1e-5)

    def test_chunked_loss_refusals(self):
        _, tcfg, _, tp = _model("tiny")
        with pytest.raises(ValueError, match=">= 2 tokens"):
            TT.chunked_causal_lm_loss(tp, tcfg, torch.zeros((1, 1), dtype=torch.long))
        with pytest.raises(ValueError, match="chunk must be positive"):
            TT.chunked_causal_lm_loss(tp, tcfg, torch.zeros((1, 4), dtype=torch.long),
                                      chunk=0)
        with pytest.raises(ValueError, match="unknown remat"):
            TL.forward_hidden(tp, tcfg, torch.zeros((1, 4), dtype=torch.long),
                              remat="some")

    def test_perplexity_matches(self):
        jcfg, tcfg, jp, tp = _model("tiny-gqa")
        batches = [_tokens((2, 12), jcfg.vocab_size, seed=s) for s in (1, 2)]
        ref = T.evaluate_perplexity(jp, jcfg, [jnp.asarray(b) for b in batches])
        got = TT.evaluate_perplexity(tp, tcfg,
                                     [torch.from_numpy(b) for b in batches])
        assert got["tokens"] == ref["tokens"] == 44
        assert got["nll"] == pytest.approx(ref["nll"], rel=1e-5)
        assert got["perplexity"] == pytest.approx(ref["perplexity"], rel=1e-5)


@pytest.mark.parametrize("name,remat", [
    ("tiny", "full"), ("tiny-gqa", "full"), ("tiny-gqa", "dots"),
    ("tiny-gqa", "none"), ("gemma-tiny", "full"),
])
def test_chunked_loss_grads_match_jax_grad(name, remat):
    jcfg, tcfg, jp, tp = _model(name, seed=1)
    toks = _tokens((2, 20), jcfg.vocab_size, seed=3)
    jloss = jax.jit(lambda p, t: T.chunked_causal_lm_loss(
        p, jcfg, t, chunk=6, remat=remat))
    jval, jgrads = jax.value_and_grad(jloss)(jp, jnp.asarray(toks))
    tp.requires_grad_(True)
    loss = TT.chunked_causal_lm_loss(tp, tcfg, torch.from_numpy(toks), chunk=6,
                                     remat=remat)
    loss.backward()
    assert loss.item() == pytest.approx(float(jval), rel=1e-5)
    got = _grad_tree(tp)
    ref = jax.tree.map(np.asarray, jgrads)
    assert set(got) == set(ref)
    if tcfg.tie_embeddings:
        assert tcfg.head_dim == 256 and "lm_head" not in got
    for key in set(got) - {"layers"}:
        scale = np.abs(ref[key]).max()
        assert np.abs(got[key] - ref[key]).max() <= 1e-4 * scale, key
    for key, g in got["layers"].items():
        r = ref["layers"][key]
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max(), key


class TestOptimizer:
    @pytest.mark.parametrize("kw", [
        dict(warmup_steps=3),                    # warmup only: then constant
        dict(warmup_steps=2, decay_steps=4),     # warmup then cosine
        dict(decay_steps=5, end_lr_ratio=0.2),   # cosine only
    ])
    def test_schedule_matches_optax(self, kw):
        """With weight decay 0 and a gradient of ones, each optax update is
        −lr·1/(1 + 1e-8): the updates read back JAX's schedule."""
        opt = T.make_optimizer(lr=1e-2, weight_decay=0.0, **kw)
        params = {"w": jnp.zeros((1,), jnp.float32)}
        state = opt.init(params)
        grads = {"w": jnp.ones((1,), jnp.float32)}
        sched = TT.make_optimizer(lr=1e-2, weight_decay=0.0, **kw).schedule
        for n in range(9):
            updates, state = opt.update(grads, state, params)
            lr = -float(updates["w"][0]) * (1 + 1e-8)
            assert sched(n) == pytest.approx(lr, rel=1e-6, abs=1e-9), n

    def test_adamw_with_clip_matches_optax(self):
        """Three updates (the first at lr 0 under warmup) with gradients
        whose global norm is far above ``clip_norm``."""
        jcfg, tcfg, jp, tp = _model("tiny-gqa", seed=2)
        kw = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, decay_steps=4,
                  clip_norm=0.5)
        jopt = T.make_optimizer(**kw)
        jstate = jopt.init(jp)
        topt_spec = TT.make_optimizer(**kw)
        tp.requires_grad_(True)
        topt = topt_spec.init(tp)
        rng = np.random.default_rng(5)
        for n in range(3):
            grads = jax.tree.map(
                lambda x: rng.normal(size=x.shape).astype(np.float32), jp)
            updates, jstate = jopt.update(
                jax.tree.map(jnp.asarray, grads), jstate, jp)
            jp = jax.tree.map(lambda p, u: p + u, jp, updates)
            ported = params_from_jax(grads, tcfg, device="cpu")
            for p, g in zip(tp.parameters(), ported.parameters()):
                p.grad = g.detach().clone()
            topt_spec.update(topt, n)
        ref = jax.tree.map(np.asarray, jp)
        for name in ("embed", "lm_head", "final_norm"):
            np.testing.assert_allclose(getattr(tp, name).detach().numpy(),
                                       ref[name], rtol=1e-6, atol=1e-6)
        for name in ("wq", "wk", "w_down", "attn_norm"):
            got = np.stack([getattr(layer, name).detach().numpy()
                            for layer in tp.layers])
            np.testing.assert_allclose(got, ref["layers"][name], rtol=1e-6,
                                       atol=1e-6)


def test_train_steps_match_jax_with_grad_accum():
    """Four steps of each framework's make_train_step from the same
    weights and batches, grad_accum=2 (strided microbatches), the chunked
    loss with a tail (15 positions in chunks of 6)."""
    jcfg, tcfg, jp, tp = _model("tiny-gqa", seed=4)
    plan = MeshPlan(make_mesh(devices=jax.devices()[:1]))
    jinit, jstep = T.make_train_step(jcfg, plan, grad_accum=2, loss_chunk=6)
    jstate = T.shard_state(plan, jinit(jp))
    tinit, tstep = TT.make_train_step(tcfg, grad_accum=2, loss_chunk=6)
    tstate = tinit(tp)
    for i in range(4):
        toks = _tokens((4, 16), jcfg.vocab_size, seed=10 + i)
        jstate, jloss = jstep(jstate, jnp.asarray(toks))
        tstate, tloss = tstep(tstate, torch.from_numpy(toks))
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-4), i
    assert int(tstate["step"]) == int(jstate["step"]) == 4


def test_make_train_step_refusals():
    cfg = TL.LLAMA_CONFIGS["tiny"]
    with pytest.raises(ValueError, match="unknown sp_impl"):
        TT.make_train_step(cfg, sp_impl="rings")
    # Sequence-parallel attention (ROADMAP item 13) is ported: on an sp
    # mesh each sp_impl builds (tests/test_torch_sp_train.py trains through
    # them), sp_impl is ignored without sp as in JAX, and use_ring_sp
    # needs a mesh to run over.
    with pytest.raises(ValueError, match="needs a MeshPlan"):
        TT.make_train_step(cfg, use_ring_sp=True)
    _, step = TT.make_train_step(cfg, sp_impl="ulysses")
    assert step.attn_impl == "auto"
    sp = TM.MeshPlan(TM.make_mesh(sp=2, devices=[0, 1]))
    for impl in ("ring", "ulysses", "zigzag"):
        _, step = TT.make_train_step(cfg, plan=sp, sp_impl=impl)
        assert callable(step.attn_impl) and step.plan is sp
    # Sharded training (ROADMAP item 12) takes a MeshPlan; anything else
    # that is not a device is a caller's error.
    with pytest.raises(TypeError, match="MeshPlan"):
        TT.make_train_step(cfg, plan=object())
    _, step = TT.make_train_step(cfg, plan=TM.MeshPlan(TM.make_mesh()))
    assert step.plan is not None and step.plan.n_batch == 1
    init_state, _ = TT.make_train_step(cfg, plan="cpu")
    state = init_state(TL.init_params(cfg, device="cpu"))
    assert all(p.requires_grad for p in state["params"].parameters())
    assert int(state["step"]) == 0
    moments = state["opt_state"].state
    assert len(moments) == len(list(state["params"].parameters()))
    assert all(set(s) == {"step", "exp_avg", "exp_avg_sq"}
               for s in moments.values())


def test_serving_weights_stay_frozen():
    """The default init records no graph: serving is untouched."""
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    params = TL.init_params(cfg, device="cpu")
    assert not any(p.requires_grad for p in params.parameters())
    logits = TL.forward(params, cfg, torch.zeros((1, 4), dtype=torch.long))
    assert logits.grad_fn is None and math.isfinite(logits.sum().item())
