"""Sequence-parallel training: the port's ``make_train_step`` under an sp
axis (ring, Ulysses, zigzag) and ``make_lora_train_step`` under sp over
gloo ranks vs the JAX package's on a mesh of the same shape over its
forced CPU devices.

The JAX reference runs in this process; the port runs as a group of 2
gloo processes (sp = 2) and one of 4 (dp = 2 × sp = 2 and sp = 2 × tp =
2), ``tests/torch_sp_worker.py``, spawned at once for the module. The
weights are JAX's f32 ``tiny`` (``init_params(cfg, PRNGKey(0))``) through
the bridge; the global batch is (4, 16) tokens drawn with numpy from a
seed. Every rank takes its rows and its positions of the global batch.

What is held, for each case:

- step 1's loss within rel 1e-5 of JAX's loss under its own sharded
  attention (``jax.value_and_grad`` of the loss the JAX step runs), and
  every gradient piece within 1e-4 of the same slice of JAX's, put
  together over the ranks (replicas equal); the global grad norm within
  rel 1e-5 of optax's ``global_norm``;
- the losses of 3 steps of the port within rel 1e-4 of JAX's jitted
  sharded step's;
- the chunked loss with a tail (8 positions a rank in chunks of 5; the
  last rank drops one) under remat "full", and the dense loss under
  remat "dots";
- a batch handed to each rank as its piece (``device_put_global`` of its
  rows and positions, dp = 2 × sp = 2): the last target comes from the
  next sp rank (``MeshPlan.seq_piece``'s ``ppermute``), the same numbers;
- LoRA (sp = 2; JAX's dense "auto" attention under GSPMD, the port's
  K/V gathered over sp): each of 3 steps' loss within rel 1e-4 and the
  adapters after within 1e-4.

In this process: ``sp_impl`` is validated on every mesh and accepted
and ignored without sp, as in JAX.
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
from kubeflow_tpu.models import lora as JLo
from kubeflow_tpu.models import train as T
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu.parallel.ring_attention import make_sharded_ring_attention
from kubeflow_tpu.parallel.ulysses import make_sharded_ulysses_attention
from kubeflow_tpu.parallel.zigzag_attention import (
    make_sharded_zigzag_attention,
)
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import train as TT
from kubeflow_tpu_torch.models.bridge import lora_from_jax, params_from_jax
from kubeflow_tpu_torch.parallel import mesh as TM
from tests.torch_sp_harness import assemble, collect, launch

MODEL = "tiny"
BATCH = (4, 16)
STEPS = 3
LORA_TARGETS = ("wq", "wv", "w_down")
JAX_IMPLS = {"ring": make_sharded_ring_attention,
             "ulysses": make_sharded_ulysses_attention,
             "zigzag": make_sharded_zigzag_attention}


def _train(axes, impl, chunk=5, remat="full", piece=False):
    return dict(axes=axes, impl=impl, chunk=chunk, remat=remat, piece=piece)


CASES = {
    2: {"sp2-ring": _train(dict(sp=2), "ring"),
        "sp2-ulysses": _train(dict(sp=2), "ulysses"),
        "sp2-zigzag": _train(dict(sp=2), "zigzag"),
        "sp2-ring-dense-dots": _train(dict(sp=2), "ring", chunk=0,
                                      remat="dots")},
    4: {"dp2sp2-ring": _train(dict(dp=2, sp=2), "ring"),
        "dp2sp2-ring-pieces": _train(dict(dp=2, sp=2), "ring", piece=True),
        "sp2tp2-ulysses": _train(dict(sp=2, tp=2), "ulysses"),
        "sp2tp2-zigzag": _train(dict(sp=2, tp=2), "zigzag")},
}
LORA_MESHES = {2: {"sp2": dict(sp=2)}, 4: {}}


def _cfgs():
    return (dataclasses.replace(L.LLAMA_CONFIGS[MODEL], dtype=jnp.float32),
            dataclasses.replace(TL.LLAMA_CONFIGS[MODEL], dtype=torch.float32))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp-train")
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, L.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    weights = tmp / "weights.pt"
    torch.save(params_from_jax(tree, tcfg, device="cpu").state_dict(),
               weights)
    lcfg = JLo.LoraConfig(rank=4, targets=LORA_TARGETS)
    adapters = jax.tree.map(np.asarray, JLo.init_lora_params(
        jcfg, lcfg, jax.random.PRNGKey(1)))
    batches = [_tokens(BATCH, 40 + i) for i in range(STEPS)]
    inputs = {"batches": [torch.from_numpy(b).long() for b in batches],
              "adapters": lora_from_jax(adapters, device="cpu")}
    started = {world: launch(
        tmp, f"w{world}", world,
        ["train"] + (["lora"] if LORA_MESHES[world] else []), inputs,
        model=MODEL, weights=str(weights), train_cases=CASES[world],
        lora_meshes=LORA_MESHES[world], lora_targets=list(LORA_TARGETS))
        for world in (2, 4)}
    return {"tree": tree, "adapters": adapters, "lcfg": lcfg,
            "batches": batches,
            "ranks": {w: collect(*run) for w, run in started.items()}}


def _jplan(axes):
    n = int(np.prod(list(axes.values())))
    return JM.MeshPlan(JM.make_mesh(**axes, devices=jax.devices()[:n]))


def _jax_case(ref, case):
    """JAX's step-1 loss and grads under the case's sharded attention, and
    its jitted sharded step's losses over the batches."""
    jcfg, _ = _cfgs()
    plan = _jplan(case["axes"])
    impl = JAX_IMPLS[case["impl"]](plan.mesh)
    params = jax.tree.map(jnp.asarray, ref["tree"])
    tokens = jnp.asarray(ref["batches"][0])

    def loss(p):
        if case["chunk"]:
            return T.chunked_causal_lm_loss(p, jcfg, tokens, impl,
                                            chunk=case["chunk"],
                                            remat=case["remat"])
        return T.causal_lm_loss(p, jcfg, tokens, impl)

    loss1, grads = jax.jit(jax.value_and_grad(loss))(params)
    init, step = T.make_train_step(jcfg, plan, sp_impl=case["impl"],
                                   loss_chunk=case["chunk"],
                                   remat=case["remat"])
    state = T.shard_state(plan, init(params))
    losses = []
    for toks in ref["batches"]:
        state, l_ = step(state, jnp.asarray(toks))
        losses.append(float(l_))
    return float(loss1), jax.tree.map(np.asarray, grads), losses


def _jax_leaf(tree, name):
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][int(parts[1])]
    return tree[parts[0]]


@pytest.mark.parametrize("world,name", [
    (w, n) for w in (2, 4) for n in CASES[w]])
def test_sp_train_step_matches_jax(ref, world, name):
    case = CASES[world][name]
    loss1, grads, losses = _jax_case(ref, case)
    recs = [r["train"][name] for r in ref["ranks"][world]]
    for rec in recs:
        assert rec["loss"] == pytest.approx(loss1, rel=1e-5)
        assert rec["norm"] == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-5)
        assert rec["losses"] == recs[0]["losses"]
    for i, (g, w) in enumerate(zip(recs[0]["losses"], losses)):
        assert g == pytest.approx(w, rel=1e-4), (i, recs[0]["losses"],
                                                 losses)
    for pname in recs[0]["grads"]:
        want = _jax_leaf(grads, pname)
        got = assemble([(r["grads"][pname]["index"],
                         r["grads"][pname]["data"].numpy()) for r in recs],
                       want.shape)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=pname)


def test_lora_under_sp_matches_jax(ref):
    jcfg, _ = _cfgs()
    plan = _jplan(dict(sp=2))
    init, step = JLo.make_lora_train_step(jcfg, ref["lcfg"], plan=plan,
                                          learning_rate=1e-2)
    state = init(jax.tree.map(jnp.asarray, ref["adapters"]))
    base = plan.shard_params(jax.tree.map(jnp.asarray, ref["tree"]))
    want = []
    for toks in ref["batches"]:
        state, loss = step(state, base, jnp.asarray(toks))
        want.append(float(loss))
    for r in ref["ranks"][2]:
        got = r["lora"]["sp2"]
        for i, (g, w) in enumerate(zip(got["losses"], want)):
            assert g == pytest.approx(w, rel=1e-4), i
        for t in LORA_TARGETS:
            for side in ("a", "b"):
                np.testing.assert_allclose(
                    got["adapters"][t][side].numpy(),
                    np.asarray(state["lora"][t][side]), rtol=0, atol=1e-4)


def test_sp_impl_is_validated_and_ignored_without_sp():
    """JAX validates ``sp_impl`` on every mesh and ignores it without an
    sp axis; so does the port (a one-rank plan attends as "auto")."""
    cfg = TL.LLAMA_CONFIGS["tiny"]
    for impl in ("ring", "ulysses", "zigzag"):
        _, step = TT.make_train_step(cfg, plan=TM.MeshPlan(TM.make_mesh()),
                                     sp_impl=impl)
        assert step.attn_impl == "auto"
    with pytest.raises(ValueError, match="unknown sp_impl"):
        TT.make_train_step(cfg, plan=TM.MeshPlan(TM.make_mesh()),
                           sp_impl="rings")


@pytest.mark.parametrize("impl", ["ring", "ulysses", "zigzag"])
def test_train_sharded_takes_each_sp_impl_as_jax_does(capsys, tmp_path,
                                                      impl):
    """``examples/train_sharded --sp-impl`` passes the choice to
    ``make_train_step`` as JAX's example does: its fsdp mesh has no sp
    axis, so each choice trains the same step; a name outside the three
    is refused by the flag's choices."""
    from kubeflow_tpu_torch.examples import train_sharded

    train_sharded.main(["--device", "cpu", "--steps", "1", "--seq", "16",
                        "--batch", "2", "--sp-impl", impl,
                        "--ckpt-dir", str(tmp_path)])
    assert "step 1: loss 5.9520" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        train_sharded.main(["--device", "cpu", "--sp-impl", "rings"])
