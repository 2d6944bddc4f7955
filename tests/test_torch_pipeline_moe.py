"""Pipeline and expert parallelism: the port's GPipe schedule
(``parallel/pipeline.py``) and Mixtral-style MoE (``models/moe.py``) vs
the JAX package's, the port over gloo ranks, JAX on a mesh of the same
shape over its forced CPU devices in this process.

The port runs as a group of 2 gloo processes (pp = 2, then ep = 2) and
one of 4 (dp = 2 × ep = 2), ``tests/torch_sp_worker.py``, spawned at once
for the module. Weights are JAX's f32 ``tiny`` llama and ``tiny-moe``
(``init_params(cfg, PRNGKey(0))``) through the bridge; batches are (4,
16) tokens drawn with numpy from a seed.

What is held:

- the pipelined forward's logits (pp = 2, n_micro 2) within 1e-5 of
  JAX's ``pipeline_forward`` on every rank;
- ``make_pipeline_train_step``: step 1's loss within rel 1e-5 of JAX's
  loss over the pipelined forward, each rank's stage gradients and the
  replicated leaves' within 1e-4 of the slice of JAX's staged gradients,
  the grad norm within rel 1e-5, and 3 steps' losses within rel 1e-4 of
  JAX's jitted step;
- ``moe_ffn`` (layer 0) in f32 at ep = 1 (in this process) and ep = 2:
  the output within 1e-5, the aux loss within rel 1e-5, and the
  gradients of sum(out · w) + aux (the input, the router, attention's
  untouched leaves, each rank's experts) within 1e-5 of ``jax.grad``;
- the MoE ``forward``'s logits within 1e-5 and its aux within rel 1e-5,
  at ep = 1 and 2;
- ``make_moe_train_step`` at ep = 2 and dp = 2 × ep = 2: step 1's loss
  (aux included) within rel 1e-5, every gradient piece within 1e-4, the
  grad norm within rel 1e-5, and 3 steps' losses within rel 1e-4 of
  JAX's jitted step.

In this process: the layer staging helpers invert each other, and the
bridge carries the MoE tree byte for byte.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import moe as JMo
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu.parallel import pipeline as JP
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import moe as TMo
from kubeflow_tpu_torch.models.bridge import moe_from_jax, params_from_jax
from kubeflow_tpu_torch.parallel import pipeline as TP
from tests.torch_sp_harness import assemble, collect, launch

N_MICRO = 2
STEPS = 3
MOE_MESHES = {2: {"ep2": dict(ep=2)}, 4: {"dp2ep2": dict(dp=2, ep=2)}}


def _cfgs():
    return (dataclasses.replace(L.LLAMA_CONFIGS["tiny"], dtype=jnp.float32),
            dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32))


def _moe_cfgs():
    return (dataclasses.replace(JMo.MOE_CONFIGS["tiny-moe"],
                                dtype=jnp.float32),
            dataclasses.replace(TMo.MOE_CONFIGS["tiny-moe"],
                                dtype=torch.float32))


def _tokens(shape, seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp-moe")
    jcfg, tcfg = _cfgs()
    mjcfg, mtcfg = _moe_cfgs()
    tree = jax.tree.map(np.asarray, L.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    moe_tree = jax.tree.map(np.asarray, JMo.init_params(
        mjcfg, jax.random.PRNGKey(0)))
    weights, moe_weights = tmp / "weights.pt", tmp / "moe.pt"
    torch.save(params_from_jax(tree, tcfg, device="cpu").state_dict(),
               weights)
    torch.save(moe_from_jax(moe_tree, mtcfg, device="cpu").state_dict(),
               moe_weights)
    rng = np.random.default_rng(7)
    batches = [_tokens((4, 16), 50 + i, 256) for i in range(STEPS)]
    moe_batches = [_tokens((4, 16), 60 + i, 512) for i in range(STEPS)]
    x = rng.standard_normal((2, 8, mjcfg.dim)).astype(np.float32)
    w = rng.standard_normal((2, 8, mjcfg.dim)).astype(np.float32)
    inputs = {"batches": [torch.from_numpy(b).long() for b in batches],
              "moe_batches": [torch.from_numpy(b).long()
                              for b in moe_batches],
              "moe_x": torch.from_numpy(x), "moe_w": torch.from_numpy(w)}
    common = dict(model="tiny", weights=str(weights),
                  moe_weights=str(moe_weights), n_micro=N_MICRO,
                  pipeline_axes=dict(pp=2))
    two = launch(tmp, "w2", 2, ["pipeline", "moe"], inputs,
                 moe_meshes=MOE_MESHES[2], **common)
    four = launch(tmp, "w4", 4, ["moe"], inputs, moe_meshes=MOE_MESHES[4],
                  **common)
    return {"tree": tree, "moe_tree": moe_tree, "batches": batches,
            "moe_batches": moe_batches, "x": x, "w": w,
            "ranks": {2: collect(*two), 4: collect(*four)}}


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return JM.make_mesh(**axes, devices=jax.devices()[:n])


# ---------------------------------------------------------------------------
# Pipeline


def _staged(ref):
    params = jax.tree.map(jnp.asarray, ref["tree"])
    return {**params, "layers": JP.split_layers_into_stages(
        params["layers"], 2)}


def _jax_pipeline_loss(cfg, mesh, tokens):
    def loss(params):
        logits = JP.pipeline_forward(params, cfg, tokens, mesh, N_MICRO)
        logprobs = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logprobs, tokens[:, 1:, None],
                                   axis=-1)[..., 0]
        return jnp.mean(nll)
    return loss


def test_pipeline_forward_matches_jax(ref):
    jcfg, _ = _cfgs()
    mesh = _jmesh(dict(pp=2))
    want = np.asarray(JP.pipeline_forward(
        JP.shard_pipeline_params(_staged(ref), mesh), jcfg,
        jnp.asarray(ref["batches"][0]), mesh, N_MICRO))
    for r in ref["ranks"][2]:
        np.testing.assert_allclose(r["pipeline"]["logits"].numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def test_pipeline_train_step_matches_jax(ref):
    jcfg, _ = _cfgs()
    mesh = _jmesh(dict(pp=2))
    staged = _staged(ref)
    tokens = jnp.asarray(ref["batches"][0])
    loss1, grads = jax.jit(jax.value_and_grad(
        _jax_pipeline_loss(jcfg, mesh, tokens)))(staged)
    grads = jax.tree.map(np.asarray, grads)
    init, step = JP.make_pipeline_train_step(jcfg, mesh, N_MICRO)
    state = init(JP.shard_pipeline_params(staged, mesh))
    want = []
    for toks in ref["batches"]:
        state, loss = step(state, jnp.asarray(toks))
        want.append(float(loss))
    for r in ref["ranks"][2]:
        rec = r["pipeline"]
        stage = rec["stage"][0]
        assert rec["loss"] == pytest.approx(float(loss1), rel=1e-5)
        assert rec["norm"] == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-5)
        for i, (g, w) in enumerate(zip(rec["losses"], want)):
            assert g == pytest.approx(w, rel=1e-4), (i, rec["losses"], want)
        for name, g in rec["grads"].items():
            parts = name.split(".")
            if parts[0] == "layers":
                ref_g = grads["layers"][parts[2]][stage][int(parts[1])]
            else:
                ref_g = grads[parts[0]]
            np.testing.assert_allclose(g.numpy(), ref_g, rtol=0, atol=1e-4,
                                       err_msg=f"rank {r['rank']} {name}")


def test_stage_helpers_invert_each_other():
    _, tcfg = _cfgs()
    model = TL.Llama(dataclasses.replace(tcfg, n_layers=6), "meta")
    staged = TP.split_layers_into_stages(model.layers, 3)
    assert [len(s) for s in staged] == [2, 2, 2]
    assert TP.merge_stages_into_layers(staged) == list(model.layers)
    with pytest.raises(ValueError) as want:
        JP.split_layers_into_stages({"w": np.zeros((6, 2))}, 4)
    with pytest.raises(ValueError) as got:
        TP.split_layers_into_stages(model.layers, 4)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# MoE


def _jax_ffn(ref):
    mjcfg, _ = _moe_cfgs()
    params = jax.tree.map(jnp.asarray, ref["moe_tree"])
    layer0 = jax.tree.map(lambda a: a[0], params["layers"])
    x, w = jnp.asarray(ref["x"]), jnp.asarray(ref["w"])

    def loss(layer, x):
        out, aux = JMo.moe_ffn(layer, mjcfg, x)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (out, aux)), (g_layer, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(layer0, x)
    return (np.asarray(out), float(aux), np.asarray(dx),
            jax.tree.map(np.asarray, g_layer))


def _check_ffn(got_out, got_aux, got_dx, got_grads, want):
    out, aux, dx, g_layer = want
    np.testing.assert_allclose(got_out, out, rtol=1e-5, atol=1e-5)
    assert got_aux == pytest.approx(aux, rel=1e-5)
    np.testing.assert_allclose(got_dx, dx, rtol=1e-5, atol=1e-5)
    for name, g in got_grads.items():
        np.testing.assert_allclose(g, g_layer[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_moe_ffn_matches_jax_on_one_rank(ref):
    _, mtcfg = _moe_cfgs()
    model = moe_from_jax(ref["moe_tree"], mtcfg, device="cpu")
    model.requires_grad_(True)
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    out, aux = TMo.moe_ffn(model.layers[0], mtcfg, x)
    (torch.sum(out * torch.from_numpy(ref["w"])) + aux).backward()
    _check_ffn(out.detach().numpy(), float(aux.detach()), x.grad.numpy(),
               {n: p.grad.numpy() for n, p in
                model.layers[0].named_parameters() if p.grad is not None},
               _jax_ffn(ref))


def test_moe_ffn_matches_jax_under_ep(ref):
    want = _jax_ffn(ref)
    recs = [r["moe"]["ep2"]["ffn"] for r in ref["ranks"][2]]
    grads = {}
    for name in recs[0]["grads"]:
        grads[name] = assemble(
            [(r["grads"][name]["index"], r["grads"][name]["data"].numpy())
             for r in recs], want[3][name].shape)
    for rec in recs:
        _check_ffn(rec["out"].numpy(), rec["aux"], rec["dx"].numpy(), grads,
                   want)


def test_moe_forward_matches_jax(ref):
    mjcfg, mtcfg = _moe_cfgs()
    tokens = ref["batches"][0]
    logits, aux = JMo.forward(jax.tree.map(jnp.asarray, ref["moe_tree"]),
                              mjcfg, jnp.asarray(tokens))
    model = moe_from_jax(ref["moe_tree"], mtcfg, device="cpu")
    with torch.no_grad():
        got = [TMo.forward(model, mtcfg, torch.from_numpy(tokens).long())]
    got += [(r["moe"]["ep2"]["forward"]["logits"],
             r["moe"]["ep2"]["forward"]["aux"]) for r in ref["ranks"][2]]
    for g_logits, g_aux in got:
        np.testing.assert_allclose(np.asarray(g_logits), np.asarray(logits),
                                   rtol=1e-5, atol=1e-5)
        assert float(g_aux) == pytest.approx(float(aux), rel=1e-5)


def _jax_moe_leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][int(parts[1])]
    return tree[parts[0]]


@pytest.mark.parametrize("world,mesh", [(2, "ep2"), (4, "dp2ep2")])
def test_moe_train_step_matches_jax(ref, world, mesh):
    mjcfg, _ = _moe_cfgs()
    tokens = jnp.asarray(ref["moe_batches"][0])
    params = jax.tree.map(jnp.asarray, ref["moe_tree"])

    def loss(p):
        logits, aux = JMo.forward(p, mjcfg, tokens)
        logprobs = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(logprobs, tokens[:, 1:, None],
                                   axis=-1)[..., 0]
        return jnp.mean(nll) + mjcfg.aux_loss_coef * aux

    loss1, grads = jax.jit(jax.value_and_grad(loss))(params)
    grads = jax.tree.map(np.asarray, grads)
    plan = JM.MeshPlan(_jmesh(MOE_MESHES[world][mesh]))
    init, step, shard = JMo.make_moe_train_step(mjcfg, plan)
    state = shard(init(params))
    want = []
    for toks in ref["moe_batches"]:
        state, l_ = step(state, jnp.asarray(toks))
        want.append(float(l_))
    recs = [r["moe"][mesh] for r in ref["ranks"][world]]
    for rec in recs:
        assert rec["loss"] == pytest.approx(float(loss1), rel=1e-5)
        assert rec["norm"] == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-5)
        for i, (g, w) in enumerate(zip(rec["losses"], want)):
            assert g == pytest.approx(w, rel=1e-4), (i, rec["losses"], want)
    for name in recs[0]["grads"]:
        ref_g = _jax_moe_leaf(grads, name)
        got = assemble([(r["grads"][name]["index"],
                         r["grads"][name]["data"].numpy()) for r in recs],
                       ref_g.shape)
        np.testing.assert_allclose(got, ref_g, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_bridge_carries_the_moe_tree(ref):
    _, mtcfg = _moe_cfgs()
    model = moe_from_jax(ref["moe_tree"], mtcfg, device="cpu")
    layers = ref["moe_tree"]["layers"]
    assert model.layers[1].router.dtype == torch.float32
    for name, stacked in layers.items():
        for i, layer in enumerate(model.layers):
            assert np.array_equal(getattr(layer, name).detach().numpy(),
                                  stacked[i]), (name, i)
    bad = {**ref["moe_tree"], "extra": np.zeros(1)}
    with pytest.raises(ValueError, match="extra"):
        moe_from_jax(bad, mtcfg, device="cpu")
