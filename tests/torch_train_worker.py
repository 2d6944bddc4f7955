"""One rank of a sharded-training group for tests/test_torch_sharded_train.py
and tests/test_torch_checkpoint_shards.py.

Run as ``python tests/torch_train_worker.py SPEC.json RANK``: joins a gloo
group of ``spec["world"]`` ranks on ``spec["port"]``, runs the scenarios
the spec names (every rank the same calls, in lockstep) and writes what
it saw to ``spec["out"].<rank>.json``. Imports torch and the port only:
the JAX reference runs in the pytest process. Tensors go back as base64
of their raw bytes with their shard index.
"""

from __future__ import annotations

import base64
import dataclasses
import faulthandler
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch.data.loader import (  # noqa: E402
    device_put_global,
    sharded_loader,
)
from kubeflow_tpu_torch.models import fp8 as TF  # noqa: E402
from kubeflow_tpu_torch.models import llama as TL  # noqa: E402
from kubeflow_tpu_torch.models import lora as TLo  # noqa: E402
from kubeflow_tpu_torch.models import train as TT  # noqa: E402
from kubeflow_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshPlan,
    make_mesh,
    placement_of,
)
from kubeflow_tpu_torch.runtime.checkpoint import (  # noqa: E402
    CheckpointManager,
    flatten_state,
)


def b64(t: torch.Tensor) -> str:
    return base64.b64encode(
        t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
        .tobytes()).decode()


def piece(t: torch.Tensor) -> dict:
    pl = placement_of(t)
    index = ([[0, n] for n in t.shape] if pl is None
             else [list(p) for p in pl.index()])
    return {"index": index, "shape": list(t.shape), "data": b64(t)}


def _cfg(spec):
    return dataclasses.replace(TL.LLAMA_CONFIGS[spec["model"]],
                               dtype=torch.float32)


def _model(spec, key: str = "weights", fp8: bool = False):
    """The whole f32 model the pytest process bridged from JAX."""
    model = TL.Llama(_cfg(spec), "cpu")
    if fp8:
        model = TF.wrap_params_fp8(model)
    model.load_state_dict(torch.load(spec[key]))
    return model


def _plan(axes: dict) -> MeshPlan:
    return MeshPlan(make_mesh(**axes))


def _pieces(params, opt=None) -> dict:
    out = {name: piece(p) for name, p in params.named_parameters()}
    if opt is not None:
        for name, p in params.named_parameters():
            for key in ("exp_avg", "exp_avg_sq"):
                if p in opt.state:
                    out[f"{name}/{key}"] = piece(opt.state[p][key])
    return out


def _steps(step, state, batches) -> list:
    losses = []
    for toks in batches:
        state, loss = step(state, torch.tensor(toks))
        losses.append(float(loss))
    return losses


def scenario_train(spec) -> dict:
    """``make_train_step`` + ``shard_state`` on each mesh and variant:
    the pieces after ``shard_state``, each step's loss, the pieces after
    the steps, and the placement records."""
    out = {}
    for mesh_key, axes in spec["meshes"].items():
        plan = _plan(axes)
        for name, var in spec["variants"].items():
            init, step = TT.make_train_step(
                _cfg(spec), plan, optimizer=TT.make_optimizer(
                    clip_norm=var["clip"]),
                grad_accum=var["grad_accum"], loss_chunk=var["chunk"],
                remat=var["remat"])
            state = TT.shard_state(plan, init(_model(spec)))
            rec = {}
            if name == spec["pieces_of"]:
                rec["sharded"] = _pieces(state["params"], state["opt_state"])
            rec["losses"] = _steps(step, state, spec["batches"])
            rec["after"] = _pieces(state["params"])
            out[f"{mesh_key}/{name}"] = rec
    return out


def scenario_norm(spec) -> dict:
    """The global grad norm of step 1 on each mesh (``TrainStep``'s
    parts), beside its loss."""
    out = {}
    for mesh_key, axes in spec["meshes"].items():
        plan = _plan(axes)
        init, step = TT.make_train_step(_cfg(spec), plan, loss_chunk=8)
        state = TT.shard_state(plan, init(_model(spec)))
        loss = step.loss_and_grads(state, torch.tensor(spec["batches"][0]))
        out[mesh_key] = [float(loss), float(step.grad_norm(state))]
    return out


def scenario_fp8(spec) -> dict:
    """``make_train_step(fp8=True)`` on each fp8 mesh: each step's loss,
    the masters and histories after."""
    out = {}
    for mesh_key in spec["fp8_meshes"]:
        plan = _plan(spec["meshes"][mesh_key])
        init, step = TT.make_train_step(_cfg(spec), plan, fp8=True,
                                        loss_chunk=6, remat="full")
        state = TT.shard_state(plan, init(_model(spec, "fp8_weights",
                                                 fp8=True)))
        losses = _steps(step, state, spec["batches"])
        out[mesh_key] = {"losses": losses,
                         "after": _pieces(state["params"])}
    return out


def scenario_lora(spec) -> dict:
    """``make_lora_train_step(plan=)`` over the shard of the base on each
    LoRA mesh: each step's loss and the adapters after (whole)."""
    out = {}
    lcfg = TLo.LoraConfig(rank=4, targets=tuple(spec["lora_targets"]))
    for mesh_key in spec["lora_meshes"]:
        plan = _plan(spec["meshes"][mesh_key])
        base = plan.shard_params(_model(spec))
        adapters = {t: {s: v.clone() for s, v in ab.items()}
                    for t, ab in torch.load(spec["adapters"]).items()}
        init, step = TLo.make_lora_train_step(_cfg(spec), lcfg, plan=plan,
                                              learning_rate=1e-2)
        state = init(adapters)
        losses = []
        for toks in spec["lora_batches"]:
            state, loss = step(state, base, torch.tensor(toks))
            losses.append(float(loss))
        out[mesh_key] = {"losses": losses, "adapters": {
            t: {s: b64(v) for s, v in ab.items()}
            for t, ab in state["lora"].items()}}
    return out


def scenario_loader(spec) -> dict:
    """Each mesh's rows through ``sharded_loader`` and
    ``device_put_global``, two batches."""
    out = {}
    for mesh_key, axes in spec["meshes"].items():
        plan = _plan(axes)
        rows = []
        with sharded_loader(spec["corpus"], spec["global_batch"],
                            spec["seq"], seed=spec["seed"],
                            mesh=plan.mesh) as loader:
            for _ in range(2):
                t = device_put_global(loader.next(), plan.mesh,
                                      plan.batch_spec[:2], device="cpu")
                rows.append({"rows": t.tolist(),
                             "index": [list(p) for p in
                                       placement_of(t).index()],
                             "global_shape": list(
                                 placement_of(t).global_shape)})
        out[mesh_key] = rows
    return out


def _digests(state) -> dict:
    """{leaf path: its bytes} of this rank's state (its pieces)."""
    return {path: b64(t) for path, t in flatten_state(state)}


def scenario_checkpoint(spec) -> dict:
    """A sharded state trained ``spec["ckpt_steps"]`` steps, saved (each
    rank into its ``proc<k>/`` root), restored into a fresh sharded
    template, and trained on; beside it the same run uninterrupted.
    Also the restore of the JAX-written step (``spec["jax_dir"]``) and
    the refusals (a step missing a rank's commit, a changed mesh)."""
    out = {}
    axes = spec["ckpt_mesh"]
    plan = _plan(axes)
    rank, world = dist.get_rank(), dist.get_world_size()
    init, step = TT.make_train_step(_cfg(spec), plan, loss_chunk=8)

    def fresh(key="weights"):
        return TT.shard_state(plan, init(_model(spec, key)))

    batches = spec["batches"]
    k = spec["ckpt_steps"]
    # Uninterrupted.
    state = fresh()
    whole = _steps(step, state, batches)
    # Interrupted at k, saved, restored into another init, resumed.
    state = fresh()
    first = _steps(step, state, batches[:k])
    mgr = CheckpointManager(spec["ckpt_dir"], process_index=rank,
                            process_count=world)
    if not mgr.save(k, state, metadata={"start_batch": k}):
        raise RuntimeError(f"rank {rank}: the save of step {k} failed")
    dist.barrier()  # every rank's root committed before any restores
    out["saved"] = _digests(state)
    template = fresh("other_weights")
    restored, at = CheckpointManager(
        spec["ckpt_dir"], process_index=rank,
        process_count=world).restore_latest(template)
    out["restored_step"] = at
    out["restored"] = _digests(restored)
    rest = _steps(step, restored, batches[k:])
    out["losses"] = {"whole": whole, "resumed": first + rest}
    # A JAX-written per-process shard step into this rank's template.
    if spec.get("jax_dir"):
        template = fresh("other_weights")
        _, at = CheckpointManager(spec["jax_dir"], process_index=rank,
                                  process_count=world).restore_latest(
            template)
        out["jax_step"] = at
        out["jax_restored"] = _pieces(template["params"],
                                      template["opt_state"])
    # A step one rank never committed is no checkpoint: rank 0 saves
    # step k + 5 alone.
    if rank == 0 and not mgr.save(k + 5, state):
        raise RuntimeError(f"the save of step {k + 5} failed")
    dist.barrier()
    again = CheckpointManager(spec["ckpt_dir"], process_index=rank,
                              process_count=world)
    out["latest_after_lone_save"] = again.latest_step()
    # A changed mesh: the pieces this rank would need were never saved.
    other = _plan(spec["other_mesh"])
    init2, _ = TT.make_train_step(_cfg(spec), other, loss_chunk=8)
    changed = TT.shard_state(other, init2(_model(spec)))
    try:
        again.restore_latest(changed)
        out["changed_mesh"] = None
    except ValueError as err:
        out["changed_mesh"] = str(err)
    return out


SCENARIOS = {"train": scenario_train, "norm": scenario_norm,
             "fp8": scenario_fp8, "lora": scenario_lora,
             "loader": scenario_loader, "checkpoint": scenario_checkpoint}


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=spec["world"])
    out = {"rank": rank}
    for name in spec["scenarios"]:
        out[name] = SCENARIOS[name](spec)
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
