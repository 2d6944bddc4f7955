"""One rank of a gloo group for the sequence-, pipeline- and expert-parallel
tests (tests/test_torch_sp_attention.py, test_torch_sp_train.py,
test_torch_pipeline_moe.py, test_torch_sp_serving.py).

Run as ``python tests/torch_sp_worker.py SPEC.json RANK``: joins a gloo
group of ``spec["world"]`` ranks on ``spec["port"]``, runs the scenarios
the spec names (every rank the same calls, in lockstep) on the inputs the
pytest process saved (``spec["inputs"]``, a ``torch.save`` of tensors) and
writes what it saw to ``spec["out"].<rank>.pt``: each rank's pieces, with
their shard index where the piece is a slice. Imports torch and the port
only: the JAX reference runs in the pytest process.
"""

from __future__ import annotations

import dataclasses
import faulthandler
import importlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch.data.loader import device_put_global  # noqa: E402
from kubeflow_tpu_torch.models import llama as TL  # noqa: E402
from kubeflow_tpu_torch.models import lora as TLo  # noqa: E402
from kubeflow_tpu_torch.models import moe as TMo  # noqa: E402
from kubeflow_tpu_torch.models import train as TT  # noqa: E402
from kubeflow_tpu_torch.models.continuous import (  # noqa: E402
    ContinuousBatcher,
)
from kubeflow_tpu_torch.models.serving import GenerationConfig  # noqa: E402
from kubeflow_tpu_torch.parallel import pipeline as TP  # noqa: E402
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    BATCH_AXES,
    MeshPlan,
    Placement,
    make_mesh,
    placement_of,
)
from kubeflow_tpu_torch.parallel.ring_attention import (  # noqa: E402
    make_sharded_ring_attention,
    make_sharded_sp_decode,
)
from kubeflow_tpu_torch.parallel.ulysses import (  # noqa: E402
    make_sharded_ulysses_attention,
)
from kubeflow_tpu_torch.parallel.zigzag_attention import (  # noqa: E402
    make_sharded_zigzag_attention,
)

RING = importlib.import_module("kubeflow_tpu_torch.parallel.ring_attention")
MAKERS = {"ring": make_sharded_ring_attention,
          "ulysses": make_sharded_ulysses_attention,
          "zigzag": make_sharded_zigzag_attention}
# Activations (B, H, S, D): batch over (dp, fsdp), heads over tp, sequence
# over sp; a key mask (B, S) and a cache's scales (B, Hkv, S) alike.
ACT = (BATCH_AXES, "tp", "sp", None)
ROWS = (BATCH_AXES, "sp")
REPLICATED_Q = (BATCH_AXES, "tp", None, None)


def _plan(axes: dict) -> MeshPlan:
    return MeshPlan(make_mesh(**axes))


def _local(plan, spec, t):
    if t is None:
        return None
    return Placement(plan.mesh, spec, tuple(t.shape)).slice(t).clone()


def _index(plan, spec, shape) -> list:
    return [list(p) for p in Placement(plan.mesh, spec, tuple(shape)).index()]


def _grad_piece(p: torch.Tensor) -> dict:
    """A parameter's gradient with the index of its piece."""
    pl = placement_of(p)
    index = ([[0, n] for n in p.shape] if pl is None
             else [list(r) for r in pl.index()])
    return {"index": index, "data": p.grad.detach().clone()}


def _grads(params) -> dict:
    return {name: _grad_piece(p) for name, p in params.named_parameters()
            if p.grad is not None}


def _model(spec):
    cfg = dataclasses.replace(TL.LLAMA_CONFIGS[spec["model"]],
                              dtype=torch.float32)
    model = TL.Llama(cfg, "cpu")
    model.load_state_dict(torch.load(spec["weights"]))
    return cfg, model


def scenario_attention(spec, inputs) -> dict:
    """Each case's sharded attention on this rank's piece: its output and
    the gradients of sum(out · w) with respect to its q, k and v."""
    a = inputs["attn"]
    out = {}
    for case in spec["attention_cases"]:
        plan = _plan(case["axes"])
        q, k, v, w = (_local(plan, ACT, a[n]).requires_grad_(n != "w")
                      for n in ("q", "k", "v", "w"))
        mask = _local(plan, ROWS, a["mask"]) if case["mask"] else None
        kw = dict(causal=case["causal"], q_offset=case["q_offset"],
                  window=case["window"], kv_mask=mask)
        if case["kind"] == "zigzag":
            kw = {}
        saved = RING._RING_BLOCK
        RING._RING_BLOCK = case.get("block") or saved
        try:
            o = MAKERS[case["kind"]](plan)(q, k, v, **kw)
            torch.sum(o * w).backward()
        finally:
            RING._RING_BLOCK = saved
        out[case["name"]] = {
            "index": _index(plan, ACT, a["q"].shape), "out": o.detach(),
            "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return out


def scenario_decode(spec, inputs) -> dict:
    """Each case's split-KV decode over this rank's cache shard: the merged
    output (replicated over sp)."""
    d = inputs["decode"]
    out = {}
    for case in spec["decode_cases"]:
        plan = _plan(case["axes"])
        q = _local(plan, REPLICATED_Q, d["q"][:, :, :case["sq"]])
        names = ("kq", "vq") if case["int8"] else ("k", "v")
        k, v = (_local(plan, ACT, d[n]) for n in names)
        scales = {}
        if case["int8"]:
            scales = {"k_scale": _local(plan, ROWS[:1] + ("tp", "sp"),
                                        d["ks"]),
                      "v_scale": _local(plan, ROWS[:1] + ("tp", "sp"),
                                        d["vs"])}
        mask = _local(plan, ROWS, d["mask"]) if case["mask"] else None
        pos = torch.tensor(case["pos"])
        o = make_sharded_sp_decode(plan)(
            q, k, v, pos, window=case["window"], kv_mask=mask,
            per_batch=case["per_batch"], **scales)
        whole = d["q"][:, :, :case["sq"]].shape
        out[case["name"]] = {"index": _index(plan, REPLICATED_Q, whole),
                             "out": o}
    return out


def _steps(step, state, batches) -> list:
    losses = []
    for toks in batches:
        state, loss = step(state, toks)
        losses.append(float(loss))
    return losses


def scenario_train(spec, inputs) -> dict:
    """``make_train_step`` under each (mesh, sp_impl): step 1's loss, its
    gradients (pieces) and global norm, then the losses of the steps."""
    out = {}
    for name, case in spec["train_cases"].items():
        batches = inputs["batches"]
        plan = _plan(case["axes"])
        cfg, model = _model(spec)
        init, step = TT.make_train_step(cfg, plan, sp_impl=case["impl"],
                                        loss_chunk=case["chunk"],
                                        remat=case["remat"])
        state = TT.shard_state(plan, init(model))
        if case["piece"]:
            # This rank's rows and positions only, as a loader hands them.
            batches = [device_put_global(plan.local_batch(b).numpy(),
                                         plan.mesh, plan.batch_spec[:2],
                                         device="cpu")
                       for b in inputs["batches"]]
        loss = step.loss_and_grads(state, batches[0])
        rec = {"loss": float(loss), "grads": _grads(state["params"]),
               "norm": float(step.grad_norm(state))}
        step.apply(state)
        rec["losses"] = [rec["loss"]] + _steps(step, state, batches[1:])
        out[name] = rec
    return out


def scenario_lora(spec, inputs) -> dict:
    """``make_lora_train_step(plan=)`` under each LoRA mesh: each step's
    loss and the adapters after."""
    out = {}
    lcfg = TLo.LoraConfig(rank=4, targets=tuple(spec["lora_targets"]))
    for name, axes in spec["lora_meshes"].items():
        plan = _plan(axes)
        cfg, model = _model(spec)
        base = plan.shard_params(model)
        adapters = {t: {s: v.clone() for s, v in ab.items()}
                    for t, ab in inputs["adapters"].items()}
        init, step = TLo.make_lora_train_step(cfg, lcfg, plan=plan,
                                              learning_rate=1e-2)
        state = init(adapters)
        losses = []
        for toks in inputs["batches"]:
            state, loss = step(state, base, toks)
            losses.append(float(loss))
        out[name] = {"losses": losses, "adapters": {
            t: {s: v.detach().clone() for s, v in ab.items()}
            for t, ab in state["lora"].items()}}
    return out


def scenario_pipeline(spec, inputs) -> dict:
    """The pipelined forward's logits, then ``make_pipeline_train_step``:
    step 1's loss, gradients (this rank's stage, the replicated leaves)
    and norm, and the losses of the steps."""
    plan = _plan(spec["pipeline_axes"])
    cfg, model = _model(spec)
    params = TP.shard_pipeline_params(model, plan)
    batches = inputs["batches"]
    with torch.no_grad():
        logits = TP.pipeline_forward(params, cfg, batches[0], plan,
                                     spec["n_micro"])
    init, step = TP.make_pipeline_train_step(cfg, plan, spec["n_micro"])
    state = init(params)
    loss = step.loss_and_grads(state, batches[0])
    rec = {"logits": logits, "loss": float(loss),
           "stage": list(params.stage), "norm": float(step.grad_norm(state)),
           "grads": {n: p.grad.detach().clone()
                     for n, p in params.named_parameters()}}
    step.apply(state)
    rec["losses"] = [rec["loss"]] + _steps(step, state, batches[1:])
    return rec


def _moe(spec):
    cfg = dataclasses.replace(TMo.MOE_CONFIGS["tiny-moe"],
                              dtype=torch.float32)
    model = TMo.MoE(cfg, "cpu")
    model.load_state_dict(torch.load(spec["moe_weights"]))
    return cfg, model


def scenario_moe(spec, inputs) -> dict:
    """Under each MoE mesh: layer 0's ``moe_ffn`` on the saved input (its
    output, aux and the gradients of sum(out · w) + aux), the forward's
    logits and aux, then ``make_moe_train_step``'s step 1 (loss, grads,
    norm) and the losses of the steps."""
    out = {}
    for name, axes in spec["moe_meshes"].items():
        plan = _plan(axes)
        cfg, model = _moe(spec)
        TMo.shard_moe_params(plan, model)
        model.requires_grad_(True)
        x = inputs["moe_x"].clone().requires_grad_(True)
        o, aux = TMo.moe_ffn(model.layers[0], cfg, x, plan)
        (torch.sum(o * inputs["moe_w"]) + aux).backward()
        rec = {"ffn": {"out": o.detach(), "aux": float(aux.detach()),
                       "dx": x.grad,
                       "grads": _grads(model.layers[0])}}
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            logits, aux = TMo.forward(model, cfg, inputs["batches"][0], plan)
        rec["forward"] = {"logits": logits, "aux": float(aux)}
        cfg, model = _moe(spec)
        init, step, shard = TMo.make_moe_train_step(cfg, plan)
        state = shard(init(model))
        loss = step.loss_and_grads(state, inputs["moe_batches"][0])
        rec["loss"] = float(loss)
        rec["grads"] = _grads(state["params"])
        rec["norm"] = float(step.grad_norm(state))
        step.apply(state)
        rec["losses"] = [rec["loss"]] + _steps(step, state,
                                               inputs["moe_batches"][1:])
        out[name] = rec
    return out


def scenario_serve(spec, inputs) -> dict:
    """``ContinuousBatcher`` under each serving case (mesh, kv_bits): each
    request's tokens and logprobs."""
    out = {}
    for name, case in spec["serve_cases"].items():
        plan = _plan(case["axes"])
        cfg, model = _model(spec)
        cb = ContinuousBatcher(
            plan.shard_params(model), cfg,
            gen=GenerationConfig(max_new_tokens=case["max_new"], eos_id=-1),
            slots=case["slots"], cache_len=case["cache_len"],
            prompt_bucket=case["bucket"], kv_bits=case["kv_bits"],
            plan=plan, device="cpu")
        rids = [cb.submit(p) for p in inputs["prompts"]]
        toks = cb.run()
        lps = cb.run_logprobs()
        out[name] = {"tokens": [toks[r] for r in rids],
                     "logprobs": [lps[r] for r in rids],
                     "cache_shape": list(cb.cache["k"].shape)}
    return out


SCENARIOS = {"attention": scenario_attention, "decode": scenario_decode,
             "train": scenario_train, "lora": scenario_lora,
             "pipeline": scenario_pipeline, "moe": scenario_moe,
             "serve": scenario_serve}


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=spec["world"])
    inputs = torch.load(spec["inputs"])
    out = {"rank": rank}
    for name in spec["scenarios"]:
        out[name] = SCENARIOS[name](spec, inputs)
    torch.save(out, f"{spec['out']}.{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
