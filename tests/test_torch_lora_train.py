"""LoRA finetuning in the PyTorch port (models/lora.py's train step, the
differentiable merge and examples/finetune_lora.py) vs the JAX package,
on the CPU.

JAX's weights and adapters come over through ``models/bridge.py``; tokens
are drawn with numpy from a seed. Tolerances: the identity at
initialisation is exact (b = 0 adds an exact 0 to every weight); eight
lockstep steps on f32 ``tiny`` hold each loss to 1e-4 relative (f32 sums
in another order: measured ≤ 2.6e-7) and the adapters after them to 1e-4
absolute, 1% of the lr of 1e-2 (AdamW moves an element whose gradient is
near 0 by an amount that turns on the gradient's last bits: measured
6.3e-5 on one element of 1024, ≤ 8e-6 elsewhere); the bf16-base run
checks only what JAX's own test checks (the loss falls, the base is
untouched, b moves).
"""

from __future__ import annotations

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import convert as JC
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import lora as JLo
from kubeflow_tpu_torch.examples import finetune_lora
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import lora as TLo
from kubeflow_tpu_torch.models import train as TT
from kubeflow_tpu_torch.models.bridge import lora_from_jax, params_from_jax
from kubeflow_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    flatten_state,
)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(dtype="float32", seed=0):
    jcfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny"],
                               dtype=jnp.dtype(dtype))
    tcfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"],
                               dtype=getattr(torch, dtype))
    tree = jax.tree.map(np.asarray, L.init_params(jcfg,
                                                  jax.random.PRNGKey(seed)))
    return jcfg, tcfg, tree, params_from_jax(tree, tcfg, device="cpu")


def _jax_lora(jcfg, lcfg, seed=1, dtype=None):
    return jax.tree.map(np.asarray, JLo.init_lora_params(
        jcfg, lcfg, jax.random.PRNGKey(seed), dtype=dtype))


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


def _lcfgs(rank=4, targets=("wq", "wv")):
    return (JLo.LoraConfig(rank=rank, targets=targets),
            TLo.LoraConfig(rank=rank, targets=targets))


def test_identity_at_init():
    """b = 0: the differentiable merge gives the base model's loss and
    logits bit for bit."""
    jcfg, tcfg, tree, tp = _pair()
    jl, tl = _lcfgs(targets=TLo._ADAPTABLE)
    lora = lora_from_jax(_jax_lora(jcfg, jl), device="cpu")
    for t in lora.values():
        t["a"].requires_grad_(True)
        t["b"].requires_grad_(True)
    toks = torch.from_numpy(_tokens((2, 16), seed=0))
    merged = TLo.merge_lora_differentiable(tp, lora, tl)
    assert torch.equal(TT.causal_lm_loss(merged, tcfg, toks).detach(),
                       TT.causal_lm_loss(tp, tcfg, toks))
    assert torch.equal(TL.forward(merged, tcfg, toks).detach(),
                       TL.forward(tp, tcfg, toks))
    assert merged.layers[0].wq.grad_fn is not None
    assert not merged.layers[0].attn_norm.requires_grad


def test_unknown_target_error_matches_jax():
    jcfg, tcfg = L.LLAMA_CONFIGS["tiny"], TL.LLAMA_CONFIGS["tiny"]
    with pytest.raises(ValueError) as want:
        JLo.init_lora_params(jcfg, JLo.LoraConfig(targets=("wq", "lm_head")),
                             jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as got:
        TLo.init_lora_params(tcfg, TLo.LoraConfig(targets=("wq", "lm_head")),
                             device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["llama-2-7b", "llama-3-8b"])
@pytest.mark.parametrize("rank,targets", [(8, ("wq", "wv")),
                                          (16, TLo._ADAPTABLE)])
def test_lora_param_count_matches_jax(name, rank, targets):
    got = TLo.lora_param_count(TL.LLAMA_CONFIGS[name],
                               TLo.LoraConfig(rank=rank, targets=targets))
    want = JLo.lora_param_count(L.LLAMA_CONFIGS[name],
                                JLo.LoraConfig(rank=rank, targets=targets))
    assert got == want
    if rank == 8:
        assert got < TL.LLAMA_CONFIGS[name].param_count() * 0.002


@pytest.mark.parametrize("targets", [("wq", "wv"), ("wk", "wo", "w_down")])
def test_train_steps_match_jax(targets):
    """Eight steps of both frameworks' ``make_lora_train_step`` from the
    same base and adapters (JAX's init: b = 0) on the same batches."""
    jcfg, tcfg, tree, tp = _pair(seed=3)
    jl, tl = _lcfgs(targets=targets)
    adapters = _jax_lora(jcfg, jl)
    jinit, jstep = JLo.make_lora_train_step(jcfg, jl, learning_rate=1e-2)
    tinit, tstep = TLo.make_lora_train_step(tcfg, tl, learning_rate=1e-2)
    jstate = jinit(jax.tree.map(jnp.asarray, adapters))
    tstate = tinit(lora_from_jax(adapters, device="cpu"))
    jbase = jax.tree.map(jnp.asarray, tree)
    for i in range(8):
        toks = _tokens((4, 32), seed=20 + i)
        jstate, jloss = jstep(jstate, jbase, jnp.asarray(toks))
        tstate, tloss = tstep(tstate, tp, torch.from_numpy(toks))
        assert tloss.item() == pytest.approx(float(jloss), rel=1e-4), i
    assert int(tstate["step"]) == int(jstate["step"]) == 8
    for t in targets:
        for side in ("a", "b"):
            np.testing.assert_allclose(
                tstate["lora"][t][side].detach().numpy(),
                np.asarray(jstate["lora"][t][side]), rtol=0, atol=1e-4)
    assert float(tstate["lora"][targets[0]]["b"].detach().abs().max()) > 0


def test_bf16_base_with_f32_adapters_trains_and_freezes_the_base():
    """JAX's tests/test_finetune_quant.py case on the port: tiny bf16 base,
    f32 adapters, lr 1e-2, 8 steps on one batch."""
    cfg = TL.LLAMA_CONFIGS["tiny"]
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lcfg = TLo.LoraConfig(rank=4, targets=("wq", "wv"))
    lora = TLo.init_lora_params(cfg, lcfg, torch.Generator().manual_seed(1),
                                dtype=torch.float32, device="cpu")
    init_state, step = TLo.make_lora_train_step(cfg, lcfg,
                                                learning_rate=1e-2)
    state = init_state(lora)
    toks = torch.from_numpy(_tokens((4, 32), seed=2))
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    losses = [float(step(state, params, toks)[1]) for _ in range(8)]
    assert losses[-1] < losses[0]
    for n, p in params.named_parameters():
        assert torch.equal(p.view(torch.int16), before[n].view(torch.int16)), n
        assert p.grad is None and not p.requires_grad
    assert float(state["lora"]["wq"]["b"].detach().abs().max()) > 0
    assert state["lora"]["wq"]["a"].dtype == torch.float32


def test_a_base_that_requires_grad_gets_none():
    """Even a base left trainable by an earlier ``make_train_step`` gets no
    gradient: it enters the merge detached."""
    cfg = TL.LLAMA_CONFIGS["tiny"]
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params.requires_grad_(True)
    lcfg = TLo.LoraConfig(rank=2)
    init_state, step = TLo.make_lora_train_step(cfg, lcfg)
    state = init_state(TLo.init_lora_params(
        cfg, lcfg, torch.Generator().manual_seed(1), device="cpu"))
    step(state, params, torch.from_numpy(_tokens((2, 8), seed=0)))
    assert all(p.grad is None for p in params.parameters())
    assert all(t.grad is None for t in TT.tensor_leaves(state["lora"]))
    assert len(state["opt_state"].param_groups[0]["params"]) == 4


def test_plan_other_than_a_device_is_refused():
    """A plan is None, a device or a MeshPlan (sharded finetuning, ROADMAP
    item 12, and under an sp axis, item 13: tests/test_torch_sp_train.py
    trains through it); anything else is refused."""
    from kubeflow_tpu_torch.parallel import mesh as TM

    cfg, lcfg = TL.LLAMA_CONFIGS["tiny"], TLo.LoraConfig()
    with pytest.raises(TypeError, match="MeshPlan"):
        TLo.make_lora_train_step(cfg, lcfg, plan=object())
    for plan in (None, "cpu", torch.device("cpu"),
                 TM.MeshPlan(TM.make_mesh()),
                 TM.MeshPlan(TM.make_mesh(sp=2, devices=[0, 1]))):
        TLo.make_lora_train_step(cfg, lcfg, plan=plan)


def test_a_quantized_base_is_refused_as_jax_fails():
    """JAX's merge_lora fails on a quantized tree (``'dict' object has no
    attribute 'astype'``); the port refuses it by name."""
    from kubeflow_tpu_torch.models.quant import quantize_params

    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lcfg = TLo.LoraConfig(rank=2)
    init_state, step = TLo.make_lora_train_step(cfg, lcfg)
    state = init_state(TLo.init_lora_params(cfg, lcfg, device="cpu"))
    with pytest.raises(ValueError, match="needs dense weights"):
        step(state, quantize_params(params),
             torch.from_numpy(_tokens((1, 8), seed=0)))


def test_lora_state_checkpoint_round_trip(tmp_path):
    """save → restore_latest carries a LoRA state (adapters, AdamW
    moments, step) byte for byte into a fresh one."""
    cfg = TL.LLAMA_CONFIGS["tiny"]
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lcfg = TLo.LoraConfig(rank=4)
    init_state, step = TLo.make_lora_train_step(cfg, lcfg,
                                                learning_rate=1e-2)
    state = init_state(TLo.init_lora_params(
        cfg, lcfg, torch.Generator().manual_seed(1), device="cpu"))
    for i in range(2):
        state, _ = step(state, params, torch.from_numpy(_tokens((2, 8), i)))
    assert CheckpointManager(tmp_path).save(2, state)
    other = init_state(TLo.init_lora_params(
        cfg, lcfg, torch.Generator().manual_seed(9), device="cpu"))
    other, at = CheckpointManager(tmp_path).restore_latest(other)
    assert at == 2
    saved, restored = flatten_state(state), flatten_state(other)
    assert [p for p, _ in saved] == [p for p, _ in restored]
    assert "['lora']['wq']['b']" in [p for p, _ in saved]
    for (path, a), (_, b) in zip(saved, restored):
        assert a.dtype == b.dtype
        assert torch.equal(a.detach().reshape(-1).view(torch.uint8),
                           b.detach().reshape(-1).view(torch.uint8)), path


# -- examples/finetune_lora.py ------------------------------------------------


def _root_example_lines() -> list[str]:
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "finetune_lora.py"),
         "--steps", "2"], capture_output=True, text=True, timeout=600,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)}, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def _shape_of(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "N", line)


def test_finetune_lora_exports_the_root_examples_keys(tmp_path, capsys):
    """``--device cpu --steps 2 --export``: the same printed lines as the
    root example (numbers aside) and an .npz with the keys, shapes and f32
    dtype the root example writes (JAX's ``params_to_hf_state_dict`` of
    tiny)."""
    out = tmp_path / "merged.npz"
    finetune_lora.main(["--device", "cpu", "--steps", "2", "--export",
                        str(out)])
    lines = capsys.readouterr().out.splitlines()
    want_lines = _root_example_lines()
    assert [_shape_of(x) for x in lines[:3]] == [
        _shape_of(x) for x in want_lines[:3]]
    assert lines[0] == want_lines[0]
    assert lines[-1] == f"merged HF state dict → {out}"
    cfg = L.LLAMA_CONFIGS["tiny"]
    want = JC.params_to_hf_state_dict(cfg, L.init_params(
        cfg, jax.random.PRNGKey(0)))
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == np.float32, k


def test_finetune_lora_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune_lora.main(["--steps", "1"])


def test_finetune_lora_from_a_checkpoint(tmp_path, capsys):
    """``--checkpoint`` loads an HF checkpoint written in ``tmp_path``; the
    export holds its weights with only q_proj and v_proj moved."""
    from test_torch_serve_checkpoint import save_tiny_checkpoint

    from kubeflow_tpu_torch.models.convert import load_hf_checkpoint

    ckpt = save_tiny_checkpoint(tmp_path / "ckpt", tokenizer=False)
    out = tmp_path / "merged.npz"
    finetune_lora.main(["--device", "cpu", "--checkpoint", str(ckpt),
                        "--steps", "2", "--lr", "1e-2", "--export", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("base 0.4M params frozen; training ")
    _, base = load_hf_checkpoint(ckpt, device="cpu")
    from kubeflow_tpu_torch.models.convert import params_to_hf_state_dict

    want = params_to_hf_state_dict(base.cfg, base)
    got = np.load(out)
    assert sorted(got.files) == sorted(want)
    moved = sorted(k for k in want
                   if not np.array_equal(got[k], want[k].float().numpy()))
    assert moved and all(re.search(r"\.(q_proj|v_proj)\.weight$", k)
                         for k in moved), moved
