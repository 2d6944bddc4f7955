"""Sharded training: the port over gloo ranks vs JAX's ``make_train_step``
+ ``shard_state`` on a mesh of the same shape over its forced CPU devices.

The JAX reference runs in this process (``make_mesh(..., devices=
jax.devices()[:n])``, the 8 CPU devices conftest forces). The port runs
as a group of 2 gloo processes (meshes fsdp=2, dp=2 and tp=2) and one of
4 (fsdp=2 × tp=2), ``tests/torch_train_worker.py``, each spawned once for
the module, both at once; every rank runs every scenario and returns
JSON. The weights are JAX's f32 ``tiny-gqa`` (``init_params(cfg,
PRNGKey(0))``) through the bridge; the global batch is (4, 16) tokens
drawn with numpy from a seed.

What is held, on every mesh:

- each rank's pieces of every parameter and Adam moment after
  ``shard_state`` are byte-equal to the addressable shard of JAX's array
  for the device at the same mesh coordinate;
- each of 3 steps' loss within rel 1e-4 of JAX's sharded step (the
  precedent of ``test_train_steps_match_jax``), under remat "full" with
  ``clip_norm`` and the chunked loss with a tail (15 positions in chunks
  of 8), and under remat "dots" with ``grad_accum=2`` and the dense loss;
  every rank reports the same losses;
- the pieces after the 3 steps, put together by their indices, within
  1e-5 abs of the port's own unsharded run;
- step 1's global grad norm within rel 1e-5 of the unsharded one's;
- fp8 (fsdp=2, tp=2): each step's loss against JAX's sharded fp8 step,
  rel 1e-4 at step 1 and 5e-3 after (the single-device fp8 test's bound
  past step 1: an fp8 cast moves with the sums' order), the masters
  within 2 · lr a step (an fp8 gradient's sign moves with the sums'
  order too: JAX's own unsharded and fsdp=2 masters part by 3.1 · lr
  after 3 steps);
- LoRA (fsdp=2, tp=2): each step's loss within rel 1e-4 of JAX's
  ``make_lora_train_step(plan=)`` and the adapters within 1e-4;
- the loader: each rank's rows through ``sharded_loader(mesh=)`` and
  ``device_put_global`` are its rows of JAX's global batch (the
  per-process loaders of its batch coordinates, assembled by JAX's
  ``device_put_global``), and tp peers hold the same rows.

In this process: the port's ``batch_spec``, ``logits_spec`` and
``param_shardings`` specs are JAX's, ``batch_sharding`` gives JAX's rows,
and the serving engines take a dp or fsdp mesh (ROADMAP item 12 (b)).
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.data import loader as JD
from kubeflow_tpu.models import fp8 as JF
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import lora as JLo
from kubeflow_tpu.models import train as T
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu_torch.data.loader import write_token_file
from kubeflow_tpu_torch.models import fp8 as TF
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import train as TT
from kubeflow_tpu_torch.models.bridge import lora_from_jax, params_from_jax
from kubeflow_tpu_torch.parallel import mesh as TM

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_train_worker.py"
MODEL = "tiny-gqa"
MESHES = {"fsdp2": dict(fsdp=2), "dp2": dict(dp=2), "tp2": dict(tp=2),
          "fsdp2tp2": dict(fsdp=2, tp=2)}
WORLD = {"fsdp2": 2, "dp2": 2, "tp2": 2, "fsdp2tp2": 4}
VARIANTS = {
    "full-clip-chunked": dict(remat="full", grad_accum=1, clip=0.5, chunk=8),
    "dots-accum-dense": dict(remat="dots", grad_accum=2, clip=0.0, chunk=0),
}
FP8_MESHES = ("fsdp2", "tp2")
LORA_MESHES = ("fsdp2", "tp2")
LORA_TARGETS = ("wq", "wv", "w_down")
BATCH = (4, 16)
STEPS = 3
LR = 3e-4  # make_optimizer's default
SPAWN_TIMEOUT = 600


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


def _cfgs():
    return (dataclasses.replace(L.LLAMA_CONFIGS[MODEL], dtype=jnp.float32),
            dataclasses.replace(TL.LLAMA_CONFIGS[MODEL], dtype=torch.float32))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's weights (plain and fp8-wrapped), adapters, batches and a
    corpus, and the files the ranks read them from."""
    tmp = tmp_path_factory.mktemp("sharded")
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, L.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    weights = tmp / "weights.pt"
    torch.save(params_from_jax(tree, tcfg, device="cpu").state_dict(),
               weights)
    fp8_tree = jax.tree.map(np.asarray, JF.wrap_params_fp8(
        jax.tree.map(jnp.asarray, tree)))
    fp8_weights = tmp / "fp8.pt"
    torch.save(params_from_jax(fp8_tree, tcfg, device="cpu").state_dict(),
               fp8_weights)
    lcfg = JLo.LoraConfig(rank=4, targets=LORA_TARGETS)
    adapters = jax.tree.map(np.asarray, JLo.init_lora_params(
        jcfg, lcfg, jax.random.PRNGKey(1)))
    adapters_path = tmp / "adapters.pt"
    torch.save(lora_from_jax(adapters, device="cpu"), adapters_path)
    corpus = write_token_file(
        tmp / "corpus.bin",
        np.random.default_rng(5).integers(0, 256, 4096).astype(np.uint32))
    return {"tmp": tmp, "tree": tree, "fp8_tree": fp8_tree,
            "adapters": adapters, "lcfg": lcfg,
            "batches": [_tokens(BATCH, 10 + i) for i in range(STEPS)],
            "lora_batches": [_tokens((4, 12), 30 + i) for i in range(STEPS)],
            "corpus": str(corpus),
            "spec": {"model": MODEL, "weights": str(weights),
                     "fp8_weights": str(fp8_weights),
                     "adapters": str(adapters_path),
                     "corpus": str(corpus), "global_batch": 4, "seq": 16,
                     "seed": 3}}


def _launch(ref, world, scenarios, meshes):
    spec = {**ref["spec"], "world": world, "port": _free_port(),
            "scenarios": scenarios,
            "meshes": {k: MESHES[k] for k in meshes},
            "variants": VARIANTS, "pieces_of": "full-clip-chunked",
            "batches": [b.tolist() for b in ref["batches"]],
            "lora_batches": [b.tolist() for b in ref["lora_batches"]],
            "fp8_meshes": [m for m in FP8_MESHES if m in meshes],
            "lora_meshes": [m for m in LORA_MESHES if m in meshes],
            "lora_targets": list(LORA_TARGETS),
            "out": str(ref["tmp"] / f"out-{world}")}
    path = Path(spec["out"] + ".spec.json")
    path.write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(path), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)]
    return spec, procs


def _collect(spec, procs):
    errs = []
    try:
        for proc in procs:
            errs.append(proc.communicate(timeout=SPAWN_TIMEOUT)[1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    return [json.loads(Path(f"{spec['out']}.{r}.json").read_text())
            for r in range(spec["world"])]


@pytest.fixture(scope="module")
def ranks(ref):
    """{world: [each rank's record]}: the 2-rank and the 4-rank group,
    run at once."""
    two = _launch(ref, 2, ["train", "norm", "fp8", "lora", "loader"],
                  ["fsdp2", "dp2", "tp2"])
    four = _launch(ref, 4, ["train", "norm", "loader"], ["fsdp2tp2"])
    return {2: _collect(*two), 4: _collect(*four)}


# ---------------------------------------------------------------------------
# The JAX reference


def _jplan(mesh):
    n = WORLD[mesh]
    return JM.MeshPlan(JM.make_mesh(**MESHES[mesh],
                                    devices=jax.devices()[:n]))


def _adam(opt_state):
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    state = next(x for x in leaves if hasattr(x, "mu"))
    return state.mu, state.nu


def _jax_train(ref, mesh, var):
    jcfg, _ = _cfgs()
    plan = _jplan(mesh)
    init, step = T.make_train_step(
        jcfg, plan, optimizer=T.make_optimizer(clip_norm=var["clip"]),
        grad_accum=var["grad_accum"], loss_chunk=var["chunk"],
        remat=var["remat"])
    state = T.shard_state(plan, init(jax.tree.map(jnp.asarray, ref["tree"])))
    # Copied out now: the jitted step donates the state.
    sharded = jax.tree.map(
        lambda a: {s.device: np.asarray(s.data) for s in a.addressable_shards},
        state)
    losses = []
    for toks in ref["batches"]:
        state, loss = step(state, jnp.asarray(toks))
        losses.append(float(loss))
    return plan, sharded, losses


_JAX: dict = {}


def _jax(ref, mesh, name):
    key = (mesh, name)
    if key not in _JAX:
        _JAX[key] = _jax_train(ref, mesh, VARIANTS[name])
    return _JAX[key]


def _port_unsharded(ref, var, batches=None):
    _, tcfg = _cfgs()
    init, step = TT.make_train_step(
        tcfg, optimizer=TT.make_optimizer(clip_norm=var["clip"]),
        grad_accum=var["grad_accum"], loss_chunk=var["chunk"],
        remat=var["remat"])
    state = init(params_from_jax(ref["tree"], tcfg, device="cpu"))
    losses = []
    for toks in batches or ref["batches"]:
        state, loss = step(state, torch.from_numpy(toks))
        losses.append(float(loss))
    return state, losses


def _decode(rec) -> np.ndarray:
    raw = base64.b64decode(rec["data"])
    return np.frombuffer(raw, np.float32).reshape(rec["shape"])


def _jax_leaf(tree, name: str):
    """JAX's stacked leaf for the port's per-layer ``name`` and the layer
    it holds (None for a top-level leaf)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]], int(parts[1])
    return tree[parts[0]], None


def _device_shard(arr, device) -> np.ndarray:
    """The shard of ``arr`` on ``device`` (``arr`` a jax.Array, or the
    {device: numpy} copy ``_jax_train`` takes)."""
    if isinstance(arr, dict):
        return arr[device]
    return np.asarray(next(s.data for s in arr.addressable_shards
                           if s.device == device))


def _assembled(records: list, name: str) -> np.ndarray:
    """One leaf put together from the ranks' pieces by their indices."""
    pieces = [r[name] for r in records]
    shape = [max(p["index"][d][1] for p in pieces)
             for d in range(len(pieces[0]["index"]))]
    out = np.full(shape, np.nan, np.float32)
    for p in pieces:
        out[tuple(slice(a, b) for a, b in p["index"])] = _decode(p)
    assert not np.isnan(out).any(), name
    return out


# ---------------------------------------------------------------------------
# Train steps


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_state_pieces_are_jax_shards(ref, ranks, mesh):
    plan, jstate, _ = _jax(ref, mesh, "full-clip-chunked")
    mu, nu = _adam(jstate["opt_state"])
    devices = plan.mesh.devices.reshape(-1)
    trees = {"": jstate["params"], "/exp_avg": mu, "/exp_avg_sq": nu}
    for rank, rec in enumerate(ranks[WORLD[mesh]]):
        pieces = rec["train"][f"{mesh}/full-clip-chunked"]["sharded"]
        n_params = len(list(TL.Llama(_cfgs()[1], "meta").parameters()))
        assert len(pieces) == 3 * n_params
        for key, got in pieces.items():
            name, _, moment = key.partition("/")
            arr, layer = _jax_leaf(trees["/" + moment if moment else ""],
                                   name)
            want = _device_shard(arr, devices[rank])
            want = want if layer is None else want[layer]
            assert got["shape"] == list(want.shape), (rank, key)
            assert base64.b64decode(got["data"]) == np.ascontiguousarray(
                want).tobytes(), (rank, key)


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_steps_match_jax(ref, ranks, mesh, name):
    _, _, want = _jax(ref, mesh, name)
    got = [r["train"][f"{mesh}/{name}"]["losses"] for r in ranks[WORLD[mesh]]]
    assert all(g == got[0] for g in got), got
    for i, (g, w) in enumerate(zip(got[0], want)):
        assert g == pytest.approx(w, rel=1e-4), (i, got[0], want)


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_params_match_the_unsharded_port(ref, ranks, mesh, name):
    state, losses = _port_unsharded(ref, VARIANTS[name])
    records = [r["train"][f"{mesh}/{name}"]["after"]
               for r in ranks[WORLD[mesh]]]
    for pname, p in state["params"].named_parameters():
        got = _assembled(records, pname)
        np.testing.assert_allclose(got, p.detach().numpy(), rtol=0,
                                   atol=1e-5, err_msg=pname)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_step_one_grad_norm_is_the_global_norm(ref, ranks, mesh):
    _, tcfg = _cfgs()
    init, step = TT.make_train_step(tcfg, loss_chunk=8)
    state = init(params_from_jax(ref["tree"], tcfg, device="cpu"))
    loss = step.loss_and_grads(state, torch.from_numpy(ref["batches"][0]))
    want = float(step.grad_norm(state))
    for r in ranks[WORLD[mesh]]:
        got_loss, got_norm = r["norm"][mesh]
        assert got_loss == pytest.approx(float(loss), rel=1e-5)
        assert got_norm == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# fp8 and LoRA under a plan


@pytest.mark.parametrize("mesh", FP8_MESHES)
def test_fp8_train_steps_match_jax(ref, ranks, mesh):
    jcfg, _ = _cfgs()
    plan = _jplan(mesh)
    init, step = T.make_train_step(jcfg, plan, fp8=True, loss_chunk=6,
                                   remat="full")
    state = T.shard_state(plan, init(jax.tree.map(jnp.asarray,
                                                  ref["fp8_tree"])))
    want = []
    for toks in ref["batches"]:
        state, loss = step(state, jnp.asarray(toks))
        want.append(float(loss))
    got = [r["fp8"][mesh]["losses"] for r in ranks[WORLD[mesh]]]
    assert all(g == got[0] for g in got), got
    for i, (g, w) in enumerate(zip(got[0], want)):
        assert g == pytest.approx(w, rel=1e-4 if i == 0 else 5e-3), i
    jt = jax.tree.map(np.asarray, state["params"])
    records = [r["fp8"][mesh]["after"] for r in ranks[WORLD[mesh]]]
    for name in records[0]:
        if not name.endswith(".hp"):
            continue
        layer, target = name.split(".")[1], name.split(".")[2]
        want_hp = jt["layers"][target]["hp"][int(layer)]
        got_hp = _assembled(records, name)
        # An element whose fp8 gradient flips sign with the sums' order
        # takes an Adam update of the other sign: up to 2 · lr a step.
        # JAX's own unsharded and fsdp=2 runs part by 3.1 · lr here.
        assert float(np.abs(got_hp - want_hp).max()) <= 2 * LR * STEPS, name
    # Every rank holds the same histories: each amax is the mesh's.
    for name in records[0]:
        if name.endswith(TF._META):
            assert all(r[name]["data"] == records[0][name]["data"]
                       for r in records), name


@pytest.mark.parametrize("mesh", LORA_MESHES)
def test_lora_train_steps_match_jax(ref, ranks, mesh):
    jcfg, _ = _cfgs()
    plan = _jplan(mesh)
    init, step = JLo.make_lora_train_step(jcfg, ref["lcfg"], plan=plan,
                                          learning_rate=1e-2)
    state = init(jax.tree.map(jnp.asarray, ref["adapters"]))
    base = plan.shard_params(jax.tree.map(jnp.asarray, ref["tree"]))
    want = []
    for toks in ref["lora_batches"]:
        state, loss = step(state, base, jnp.asarray(toks))
        want.append(float(loss))
    for r in ranks[WORLD[mesh]]:
        got = r["lora"][mesh]
        for i, (g, w) in enumerate(zip(got["losses"], want)):
            assert g == pytest.approx(w, rel=1e-4), i
        for t in LORA_TARGETS:
            for side in ("a", "b"):
                arr = np.asarray(state["lora"][t][side])
                got_arr = np.frombuffer(base64.b64decode(
                    got["adapters"][t][side]), np.float32).reshape(arr.shape)
                np.testing.assert_allclose(got_arr, arr, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The loader


@pytest.mark.parametrize("mesh", list(MESHES))
def test_device_put_global_holds_jax_rows(ref, ranks, mesh):
    spec = ref["spec"]
    jplan = _jplan(mesh)
    n = jplan.mesh.shape["dp"] * jplan.mesh.shape["fsdp"]
    loaders = [JD.sharded_loader(ref["corpus"], spec["global_batch"],
                                 spec["seq"], seed=spec["seed"],
                                 process_id=k, num_processes=n,
                                 force_python=True) for k in range(n)]
    devices = jplan.mesh.devices.reshape(-1)
    for batch in range(2):
        whole = np.concatenate([ld.next() for ld in loaders])
        arr = JD.device_put_global(whole, jplan.mesh,
                                   jax.sharding.PartitionSpec(("dp", "fsdp"),
                                                              "sp"))
        for rank, r in enumerate(ranks[WORLD[mesh]]):
            got = r["loader"][mesh][batch]
            want = _device_shard(arr, devices[rank])
            assert got["rows"] == want.tolist(), (rank, batch)
            assert got["global_shape"] == [spec["global_batch"], spec["seq"]]
            lo, hi = got["index"][0]
            assert np.array_equal(whole[lo:hi], want)
    if mesh in ("tp2", "fsdp2tp2"):
        recs = ranks[WORLD[mesh]]
        for rank in range(0, len(recs), 2):  # tp peers: consecutive ranks
            assert (recs[rank]["loader"][mesh]
                    == recs[rank + 1]["loader"][mesh])


# ---------------------------------------------------------------------------
# The plan's specs and placements, in this process


def test_activation_specs_and_param_shardings_are_jax_specs():
    jplan = JM.MeshPlan(JM.make_mesh(fsdp=2, tp=2,
                                     devices=jax.devices()[:4]))
    tplan = TM.MeshPlan(TM.make_mesh(fsdp=2, tp=2, devices=[0, 1, 2, 3]))
    assert tplan.batch_spec == tuple(jplan.batch_spec)
    assert tplan.logits_spec == tuple(jplan.logits_spec)
    jcfg, tcfg = _cfgs()
    tree = L.init_params(jcfg, jax.random.PRNGKey(0))
    jspecs = jax.tree_util.tree_map_with_path(
        lambda path, v: tuple(jplan.param_spec(
            tuple(str(p.key) for p in path), v.ndim)), tree)
    port = TL.Llama(tcfg, "meta")
    for name, pl in tplan.param_shardings(port).items():
        arr, layer = _jax_leaf(jspecs, name)
        want = arr if layer is None else arr[1:]
        assert pl.spec == tuple(want) or (pl.spec == () and not any(want)), \
            name
        assert pl.global_shape == tuple(dict(port.named_parameters())[
            name].shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharding_gives_each_rank_jax_rows(mesh):
    jplan = _jplan(mesh)
    tplan = TM.MeshPlan(TM.make_mesh(**MESHES[mesh],
                                     devices=list(range(WORLD[mesh]))))
    shape = (8, 16)
    index = jplan.batch_sharding().addressable_devices_indices_map(shape)
    for rank, device in enumerate(jplan.mesh.devices.reshape(-1)):
        want = index[device][0].indices(shape[0])[:2]
        assert tplan.batch_sharding(shape).index(rank)[0] == want


def test_placement_replicas_count_the_ranks_holding_each_piece():
    plan = TM.MeshPlan(TM.make_mesh(dp=2, fsdp=2, tp=2,
                                    devices=list(range(8))))
    for name, shape in (("layers.0.wq", (128, 256)),
                        ("layers.0.attn_norm", (128,)),
                        ("layers.0.bq", (256,))):
        pl = plan.placement(name, shape)
        holders = collections.Counter(pl.index(rank) for rank in range(8))
        # Every distinct piece, each held by ``replicas`` ranks.
        assert len(holders) == math.prod(shape) // math.prod(
            pl.local_shape), name
        assert set(holders.values()) == {pl.replicas}, name


def test_serving_still_refuses_a_dp_or_fsdp_mesh():
    """Serving under a dp or fsdp mesh works (once refused, ROADMAP item
    12 (b)): a dp=2 replica's rank holds the whole weights and serves the
    one-rank engine's tokens with ``/stats``' mesh ``{"dp": 2}``; an
    fsdp=2 rank's shard holds half of each leaf fsdp cuts and is taken,
    whole weights are refused naming fsdp. (Serving through the fsdp
    gathers runs on gloo ranks: tests/test_torch_mesh_serving.py.)"""
    from kubeflow_tpu_torch.models.paged import PagedBatcher
    from kubeflow_tpu_torch.models.serving import GenerationConfig

    _, tcfg = _cfgs()
    whole = TL.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompts = [[5, 9, 17], [3, 41, 90, 7]]

    def serve(params, plan=None):
        eng = PagedBatcher(params, tcfg, gen=GenerationConfig(
            max_new_tokens=4, eos_id=-1), slots=2, num_blocks=24,
            block_size=8, prompt_bucket=16, ragged=True, plan=plan,
            device="cpu")
        rids = [eng.submit(p) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids], eng.mesh_axes

    dp = TM.MeshPlan(TM.make_mesh(dp=2, devices=[0, 1]))
    shard = TL.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                           plan=dp)
    dp.check_shard(shard)
    assert all(torch.equal(a, b) for a, b in zip(whole.parameters(),
                                                 shard.parameters()))
    assert serve(shard, dp) == (serve(whole)[0], {"dp": 2})

    fsdp = TM.MeshPlan(TM.make_mesh(fsdp=2, devices=[0, 1]))
    with pytest.raises(ValueError, match="fsdp=1"):
        fsdp.check_shard(dp.shard_params(TL.init_params(
            tcfg, torch.Generator().manual_seed(0), "cpu")))
    with pytest.raises(ValueError, match="whole weights"):
        fsdp.check_shard(whole)
    shard = TL.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                           plan=fsdp)
    fsdp.check_shard(shard)
    assert tuple(shard.embed.shape) == (tcfg.vocab_size, tcfg.dim // 2)
    assert tuple(shard.layers[0].wq.shape) == (
        tcfg.dim // 2, tcfg.n_heads * tcfg.head_dim)
    assert torch.equal(shard.layers[0].wq, whole.layers[0].wq[:tcfg.dim // 2])
