"""One rank of a tensor-parallel group for tests/test_torch_tp_serving.py.

Run as ``python tests/torch_tp_worker.py SPEC.json RANK``: joins a gloo
group of ``spec["world"]`` ranks on ``spec["port"]``, runs the scenarios
the spec names on the port's engines (every rank the same calls, in
lockstep) and writes what it saw to ``spec["out"].<rank>.json``. Imports
torch and the port only: the JAX reference runs in the pytest process.
The ``serve`` scenario serves a replica over HTTP from rank 0 through
``TPReplica`` (the other ranks ``follow``) until ``spec["stop"]`` exists;
``mesh`` runs the engines under dp and fsdp meshes
(tests/test_torch_mesh_serving.py).
"""

from __future__ import annotations

import base64
import dataclasses
import faulthandler
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from kubeflow_tpu_torch.models import llama as TL  # noqa: E402
from kubeflow_tpu_torch.models import tp_serving as TT  # noqa: E402
from kubeflow_tpu_torch.models.continuous import (  # noqa: E402
    ContinuousBatcher,
)
from kubeflow_tpu_torch.models.lora import LoraConfig  # noqa: E402
from kubeflow_tpu_torch.models.multilora import (  # noqa: E402
    MultiLoraPagedBatcher,
)
from kubeflow_tpu_torch.models.paged import PagedBatcher  # noqa: E402
from kubeflow_tpu_torch.models.serving import GenerationConfig  # noqa: E402
from kubeflow_tpu_torch.models.speculative import (  # noqa: E402
    SpeculativeContinuousBatcher,
    SpeculativePagedBatcher,
    truncated_draft,
)

BS = 8


def _model(spec, name: str, dtype: str, plan=None):
    """The bridged weights, cut to this rank's shard under a plan (the
    engines take a shard and never cut one)."""
    cfg = dataclasses.replace(
        TL.LLAMA_CONFIGS[name],
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    model = TL.Llama(cfg, "cpu")
    model.load_state_dict(torch.load(spec["weights"][f"{name}-{dtype}"]))
    return cfg, model if plan is None else plan.shard_params(model)


def _gen(n):
    return GenerationConfig(max_new_tokens=n, eos_id=-1)


def _run(engine, prompts, **kw):
    rids = [engine.submit(p, **kw) for p in prompts]
    out = engine.run()
    # The speculative engines verify argmaxes and keep no logprobs.
    lps = getattr(engine, "run_logprobs", dict)()
    return [out[r] for r in rids], [lps.get(r, []) for r in rids]


def _ragged(spec, plan, name="tiny", dtype="bf16", **kw):
    cfg, params = _model(spec, name, dtype, plan)
    return PagedBatcher(params, cfg, gen=_gen(spec["max_new"]), slots=2,
                        num_blocks=24, block_size=BS, prompt_bucket=16,
                        ragged=True, plan=plan, device="cpu", **kw)


def _legacy(spec, plan, kv_bits=0, dtype="bf16"):
    cfg, params = _model(spec, "tiny", dtype, plan)
    return PagedBatcher(params, cfg, gen=_gen(8), slots=2, num_blocks=32,
                        block_size=BS, prompt_bucket=32, prefix_cache=True,
                        kv_bits=kv_bits, plan=plan, device="cpu")


def _b64_blocks(engine, blocks):
    rows = engine._block_rows(blocks)  # a collective under a plan
    out = []
    for j in range(len(blocks)):
        ent = {}
        for name, r in rows.items():
            r = r[:, j].contiguous()
            if r.dtype == torch.bfloat16:
                r = r.view(torch.int16)
            ent[name] = base64.b64encode(r.numpy().tobytes()).decode()
        out.append(ent)
    return out


def scenario_tokens(spec, plan):
    """The token-exact scenarios of the JAX suite's TestTokenExact."""
    prompts = spec["prompts"]
    out = {}
    out["ragged"] = _run(_ragged(spec, plan), prompts)[0]
    out["chunks"] = _run(_ragged(spec, plan, token_budget=4), prompts)[0]
    out["int8"] = _run(_ragged(spec, plan, kv_bits=8), prompts)[0]
    cfg, params = _model(spec, "tiny", "bf16", plan)
    out["alternating"] = _run(PagedBatcher(
        params, cfg, gen=_gen(spec["max_new"]), slots=2, num_blocks=24,
        block_size=BS, prompt_bucket=16, plan=plan, device="cpu"),
        prompts)[0]
    cfg, params = _model(spec, "tiny", "bf16", plan)
    out["continuous"] = _run(ContinuousBatcher(
        params, cfg, gen=_gen(spec["max_new"]), slots=2, cache_len=64,
        prompt_bucket=16, plan=plan, device="cpu"), prompts)[0]
    # Speculative verify rows with a truncated draft (rejection fires).
    cfg, params = _model(spec, "tiny", "bf16", plan)
    dparams, dcfg = truncated_draft(params, cfg, 1)
    sb = SpeculativePagedBatcher(
        params, cfg, dparams, dcfg, gen=_gen(spec["max_new"]), slots=2,
        num_blocks=40, block_size=BS, prompt_bucket=16, k_spec=3,
        ragged=True, token_budget=16, plan=plan, device="cpu")
    out["spec"] = _run(sb, prompts)[0]
    out["spec_acceptance"] = sb.acceptance_rate
    cfg, params = _model(spec, "tiny", "bf16", plan)
    dparams, dcfg = truncated_draft(params, cfg, 1)
    out["spec_continuous"] = _run(SpeculativeContinuousBatcher(
        params, cfg, dparams, dcfg, gen=_gen(spec["max_new"]), slots=2,
        cache_len=64, prompt_bucket=16, k_spec=3, plan=plan,
        device="cpu"), prompts)[0]
    # LoRA rows: the whole adapters on every rank, sliced per projection.
    cfg, params = _model(spec, "tiny", "bf16", plan)
    stacked = torch.load(spec["adapters"])
    mb = MultiLoraPagedBatcher(
        params, cfg, stacked, LoraConfig(rank=4, targets=tuple(stacked)),
        adapter_names=["a0"], gen=_gen(spec["max_new"]), slots=2,
        num_blocks=24, block_size=BS, prompt_bucket=16, ragged=True,
        plan=plan, device="cpu")
    rids = [mb.submit(p, adapter=t)
            for p, t in zip(spec["lora_prompts"], spec["lora_tags"])]
    res = mb.run()
    out["lora"] = [res[r] for r in rids]
    # The per-rank pool (one rank's bytes) and the whole one's.
    eng = _ragged(spec, plan)
    out["pool_bytes"] = {k: v.numel() * v.element_size()
                         for k, v in eng.pool.items()}
    out["pool_shape"] = {k: list(v.shape) for k, v in eng.pool.items()}
    out["mesh_axes"] = eng.mesh_axes
    return out


def scenario_f32(spec, plan):
    """One forward's logits and the engines' logprobs on f32 copies."""
    out = {}
    for name in spec["f32_models"]:
        cfg, params = _model(spec, name, "f32", plan)
        with torch.no_grad():
            logits = TL.forward(params, cfg, torch.tensor([spec["long"]]))
        out[f"{name}/logits"] = logits[0].tolist()
        toks, lps = _run(_ragged(spec, plan, name=name, dtype="f32"),
                         spec["prompts"])
        out[f"{name}/ragged"] = [toks, lps]
        cfg, params = _model(spec, name, "f32", plan)
        toks, lps = _run(PagedBatcher(
            params, cfg, gen=_gen(spec["max_new"]), slots=2, num_blocks=24,
            block_size=BS, prompt_bucket=16, plan=plan, device="cpu"),
            spec["prompts"])
        out[f"{name}/alternating"] = [toks, lps]
    return out


def scenario_handoff(spec, plan):
    """Imports into a tp replica (byte-exact, then decoded), the same
    blocks exported again, and a payload cut by the replica's own
    prefill."""
    out = {}
    for kv_bits, payload in spec["payloads"].items():
        b = _legacy(spec, plan, kv_bits=int(kv_bits))
        rid = b.import_blocks(payload, max_new_tokens=8)
        slot = next(i for i, r in enumerate(b._by_slot)
                    if r is not None and r.rid == rid)
        blocks = list(b._by_slot[slot].blocks)
        res = {"rows": _b64_blocks(b, blocks)}
        b._deliver_imported()
        again = b.export_blocks(rid)
        res["reexport"] = [blk.get("data") for blk in again["blocks"]]
        res["leaves"] = again["leaves"]
        res["tokens"] = b.run()[rid]
        res["imports"] = b.kv_imports
        res["local_shape"] = list(b.pool["k"].shape)
        out[kv_bits] = res
    a = _legacy(spec, plan)
    got = {}
    a.on_token = lambda r, tok: got.setdefault(r, a.export_blocks(r))
    rid = a.submit(spec["prompt"], max_new_tokens=1)
    a.run()
    out["prefill_payload"] = got[rid]
    out["exports"] = a.kv_exports
    # A chain imported from a one-rank peer re-exports byte for byte.
    c = _legacy(spec, plan)
    c.import_chain(spec["chain"], spec["chain_tokens"])
    again = c.export_chain(spec["chain_keys"])
    out["chain"] = [blk["data"] for blk in again["blocks"]]
    out["chain_bytes"] = c.chain_block_bytes()
    return out


def _mesh_plan(axes: dict):
    from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    return MeshPlan(make_mesh(**axes))


def scenario_mesh(spec, _plan):
    """f32 ``tiny-gqa`` on the engines under each of ``spec["meshes"]``
    (dp and fsdp beside tp): tokens and logprobs, the rank's weight bytes,
    the shard the bridge's numpy tree cuts against the model's own cut,
    and an HF checkpoint loaded under the plan against its whole load."""
    from kubeflow_tpu_torch.models import bridge
    from kubeflow_tpu_torch.models.convert import load_hf_checkpoint
    from kubeflow_tpu_torch.parallel.mesh import placement_of

    prompts, name, out = spec["prompts"], "tiny-gqa", {}
    for axes in spec["meshes"]:
        plan = _mesh_plan(axes)
        res = {"mesh_axes": plan.axes}
        cfg, params = _model(spec, name, "f32", plan)
        res["weight_bytes"] = sum(p.numel() * p.element_size()
                                  for p in params.parameters())
        res["ragged"] = _run(_ragged(spec, plan, name=name, dtype="f32"),
                             prompts)
        res["chunks"] = _run(_ragged(spec, plan, name=name, dtype="f32",
                                     token_budget=4), prompts)
        cfg, params = _model(spec, name, "f32", plan)
        eng = PagedBatcher(
            params, cfg, gen=_gen(spec["max_new"]), slots=2,
            num_blocks=24, block_size=BS, prompt_bucket=16, plan=plan,
            device="cpu")
        res["alternating"] = _run(eng, prompts)
        res["engine_mesh"] = eng.mesh_axes
        res["pool_shape"] = {k: list(v.shape) for k, v in eng.pool.items()}
        cfg, params = _model(spec, name, "f32", plan)
        res["continuous"] = _run(ContinuousBatcher(
            params, cfg, gen=_gen(spec["max_new"]), slots=2, cache_len=64,
            prompt_bucket=16, plan=plan, device="cpu"), prompts)
        cfg, params = _model(spec, name, "f32", plan)
        dparams, dcfg = truncated_draft(params, cfg, 1)
        res["spec"] = _run(SpeculativePagedBatcher(
            params, cfg, dparams, dcfg, gen=_gen(spec["max_new"]), slots=2,
            num_blocks=40, block_size=BS, prompt_bucket=16, k_spec=3,
            ragged=True, token_budget=16, plan=plan, device="cpu"),
            prompts)[0]
        # The bridge's numpy tree cut by the plan = the model's own cut.
        cfg, whole = _model(spec, name, "f32")
        tree = bridge.params_to_numpy(whole)
        cut = dict(_model(spec, name, "f32", plan)[1].named_parameters())
        res["tree_cut"] = all(
            torch.equal(p, cut[n]) and placement_of(p).global_shape
            == placement_of(cut[n]).global_shape
            for n, p in plan.shard_params(tree, cfg,
                                          device="cpu").named_parameters())
        # An HF checkpoint under the plan: each leaf the whole load's
        # slice, and no leaf held whole where the plan cuts it.
        _, full = load_hf_checkpoint(spec["hf"], dtype=torch.float32,
                                     device="cpu")
        _, mine = load_hf_checkpoint(spec["hf"], dtype=torch.float32,
                                     device="cpu", plan=plan)
        full = dict(full.named_parameters())
        res["hf_leaves"] = {
            n: [torch.equal(p, placement_of(p).slice(full[n])),
                list(p.shape), list(full[n].shape)]
            for n, p in mine.named_parameters()}
        out["x".join(f"{k}{v}" for k, v in axes.items())] = res
    return out


def scenario_serve(spec, plan):
    """A prefix-cache replica served from rank 0 through TPReplica (under
    ``spec["mesh"]`` when given, else the tp plan)."""
    from kubeflow_tpu_torch.models.server import InferenceServer

    if spec.get("mesh"):
        plan = _mesh_plan(spec["mesh"])
    engine = _legacy(spec, plan, dtype=spec.get("serve_dtype", "bf16"))
    if not TT.leads(plan):
        TT.follow(engine, plan)
        return {}
    replica = TT.TPReplica(engine, plan)
    srv = InferenceServer(replica, port=0, drain_s=0.5).start()
    with open(spec["out"] + ".port", "w") as f:
        f.write(str(srv.port))
    while not os.path.exists(spec["stop"]):
        time.sleep(0.05)
    srv.stop()
    replica.close()
    return {"served": True}


SCENARIOS = {"tokens": scenario_tokens, "f32": scenario_f32,
             "handoff": scenario_handoff, "serve": scenario_serve,
             "mesh": scenario_mesh}


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    # A native abort (SIGABRT) names the Python frame it came from in the
    # stderr the test prints.
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=spec["world"])
    plan = TT.serving_plan(spec["world"])
    out = {"rank": rank}
    for name in spec["scenarios"]:
        out[name] = SCENARIOS[name](spec, plan)
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(out, f)
    # Every rank has finished its last collective before any tears down.
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
