"""Sharded checkpoint leaves in JAX's shard format, both ways, and the
sharded ``train_sharded`` example resuming.

The port runs as a group of 4 gloo processes on a dp=2 × fsdp=2 mesh
(``tests/torch_train_worker.py``'s ``checkpoint`` scenario): f32
``tiny-gqa`` from JAX's weights, sharded by ``shard_state``, trained 2
steps, saved (each rank into its ``proc<k>/`` root), restored into a
sharded template made from other weights, and trained on; beside it the
same run uninterrupted. The JAX reference runs in this process.

What is held:

- every root passes JAX's ``_load_validated`` and holds its rank's piece
  of each sharded leaf, the bytes the rank held; the pieces of all the
  roots, placed by their ``index``, cover each leaf, every element as
  many times as ranks hold it;
- the port's entries for each leaf equal what JAX's ``_snapshot_leaf``
  and ``_write_step_inner`` write for the same leaf and spec from the
  same process (index, global_shape, dtype, shape, size, crc32 and the
  bytes);
- JAX's managers restore the port's step at every process, each finding
  in its own root every piece its device needs (the replicated norms
  too);
- a step JAX's managers wrote, each process its own pieces (a
  ``jax.Array`` viewed as one process sees it, as
  ``tests/test_checkpoint.py``'s ``_FakeGlobalArray``), restores into the
  port's sharded template, every piece its slice of JAX's array;
- the resumed run's losses equal the uninterrupted run's, with zero
  divergence, and every restored leaf is byte-equal to the saved one;
- a step one rank never committed is not restorable, and a template of
  another mesh (fsdp=2 × tp=2) raises JAX's ValueError ("no saved shard
  for index ...");
- in this process, a template that mixes whole and sharded leaves
  against a two-process step restores where the root holds what it
  needs, and raises ValueError, quarantining nothing, where it does not.

Last, ``examples/train_sharded`` as 2 gloo processes with ``--device
cpu`` (identity from the env contract, a corpus through
``sharded_loader`` and ``device_put_global``), run for 2 steps and again
for 4, resumes at step 2 and gives the losses of an uninterrupted 4-step
run.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu.runtime import checkpoint as J
from kubeflow_tpu_torch.data.loader import write_token_file
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import train as TT
from kubeflow_tpu_torch.models.bridge import params_from_jax
from kubeflow_tpu_torch.parallel import mesh as TM
from kubeflow_tpu_torch.runtime import checkpoint as P
from kubeflow_tpu_torch.runtime.checkpoint import flatten_state

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_train_worker.py"
MODEL = "tiny-gqa"
WORLD = 4
CKPT_MESH = dict(dp=2, fsdp=2)
OTHER_MESH = dict(fsdp=2, tp=2)
CKPT_STEPS = 2
STEPS = 4
SPAWN_TIMEOUT = 600


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tcfg():
    return dataclasses.replace(TL.LLAMA_CONFIGS[MODEL], dtype=torch.float32)


class _ProcessView:
    """A jax.Array as process ``devices`` sees it: only their shards are
    addressable, and it cannot be gathered (tests/test_checkpoint.py's
    ``_FakeGlobalArray``, restricted to one process)."""

    is_fully_addressable = False

    def __init__(self, arr, devices):
        self._arr = arr
        self._devices = set(devices)
        self.shape = arr.shape
        self.dtype = arr.dtype

    @property
    def addressable_shards(self):
        return [s for s in self._arr.addressable_shards
                if s.device in self._devices]

    def __array__(self, *args, **kwargs):
        raise RuntimeError("np.asarray on a non-addressable jax.Array")


class _ProcessSharding:
    """A ``NamedSharding`` as the process of one device sees it: only that
    device is addressable."""

    def __init__(self, sharding, device):
        self._sharding = sharding
        self._device = device

    def addressable_devices_indices_map(self, shape):
        return {d: index for d, index in
                self._sharding.devices_indices_map(tuple(shape)).items()
                if d == self._device}


class _ProcessLeaf:
    """A template leaf of JAX's restore carrying a process's sharding."""

    def __init__(self, sharding):
        self.sharding = sharding


def _keys(path: str) -> list:
    """The dict keys of a leaf path as the port (and JAX's keystr) write
    it: ``['opt_state'][3]['exp_avg']`` → ['opt_state', 3, 'exp_avg']."""
    return [name if name else int(num) for name, num in
            re.findall(r"\['([^']*)'\]|\[(\d+)\]", path)]


def _nest(leaves: dict) -> dict:
    tree: dict = {}
    for path, value in leaves.items():
        *head, last = _keys(path)
        node = tree
        for key in head:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


def _port_template():
    """The port's whole state of the mesh's model (its paths and global
    shapes) and each leaf's spec: the parameter's, for a moment too."""
    tcfg = _tcfg()
    init, _ = TT.make_train_step(tcfg)
    state = init(TL.Llama(tcfg, "cpu"))
    plan = TM.MeshPlan(TM.make_mesh(**CKPT_MESH, devices=list(range(WORLD))))
    specs = {}
    names = {id(p): n for n, p in state["params"].named_parameters()}
    for path, t in flatten_state(state):
        keys = _keys(path)
        if keys[0] == "params":
            specs[path] = plan.param_spec(tuple(keys[1].split(".")), t.dim())
        elif keys[0] == "opt_state" and t.dim():
            p = state["opt_state"].param_groups[0]["params"][keys[1]]
            specs[path] = plan.param_spec(tuple(names[id(p)].split(".")),
                                          t.dim())
        else:
            specs[path] = None  # a scalar: whole in every root
    return state, specs


def _jmesh():
    return JM.make_mesh(**CKPT_MESH, devices=jax.devices()[:WORLD])


def _jax_write(root: Path, values: dict, specs: dict) -> None:
    """``values`` (path → global numpy) saved by JAX's managers as 4
    processes, each its own device's pieces."""
    mesh = _jmesh()
    devices = mesh.devices.reshape(-1)
    arrays = {path: jax.device_put(v, NamedSharding(
        mesh, PartitionSpec(*specs[path]))) for path, v in values.items()
        if specs[path] is not None}
    for k in range(WORLD):
        leaves = {path: (_ProcessView(arrays[path], [devices[k]])
                         if path in arrays else values[path])
                  for path in values}
        mgr = J.CheckpointManager(root, process_index=k, process_count=WORLD)
        assert mgr.save(1, _nest(leaves))
        mgr.close()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckshards")
    tcfg = _tcfg()
    jcfg = dataclasses.replace(L.LLAMA_CONFIGS[MODEL], dtype=np.float32)
    paths = {}
    for key, seed in (("weights", 0), ("other_weights", 7)):
        tree = jax.tree.map(np.asarray, L.init_params(
            jcfg, jax.random.PRNGKey(seed)))
        paths[key] = tmp / f"{key}.pt"
        torch.save(params_from_jax(tree, tcfg, device="cpu").state_dict(),
                   paths[key])
    state, specs = _port_template()
    rng = np.random.default_rng(11)
    values = {path: (rng.normal(size=tuple(t.shape)).astype(np.float32)
                     if t.dim() else np.asarray(t.numpy()))
              for path, t in flatten_state(state)}
    _jax_write(tmp / "jax", values, specs)
    batches = [np.random.default_rng(40 + i).integers(
        0, 256, size=(4, 16)).tolist() for i in range(STEPS)]
    spec = {"world": WORLD, "port": _free_port(), "model": MODEL,
            "scenarios": ["checkpoint"], "weights": str(paths["weights"]),
            "other_weights": str(paths["other_weights"]),
            "ckpt_mesh": CKPT_MESH, "other_mesh": OTHER_MESH,
            "ckpt_steps": CKPT_STEPS, "batches": batches,
            "ckpt_dir": str(tmp / "port"), "jax_dir": str(tmp / "jax"),
            "out": str(tmp / "out")}
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(spec_path), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(WORLD)]
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
    ranks = [json.loads(Path(f"{spec['out']}.{r}.json").read_text())
             ["checkpoint"] for r in range(WORLD)]
    return {"tmp": tmp, "ranks": ranks, "values": values, "specs": specs,
            "state": state}


def _entries(root: Path, k: int, step: int) -> list:
    manifest = root / f"proc{k}" / str(step) / J.MANIFEST_NAME
    return json.loads(manifest.read_text())["files"]


def _plan():
    return TM.MeshPlan(TM.make_mesh(**CKPT_MESH, devices=list(range(WORLD))))


def test_each_root_passes_jax_validation_and_the_pieces_cover_each_leaf(run):
    root = run["tmp"] / "port"
    ranks = run["ranks"]
    roots = [dict(J._load_validated(root / f"proc{k}" / str(CKPT_STEPS))[0])
             for k in range(WORLD)]
    plan = _plan()
    for path, t in flatten_state(run["state"]):
        spec = run["specs"][path]
        if spec is None:
            continue  # whole, in every root
        pl = TM.Placement(plan.mesh, spec, tuple(t.shape))
        covered = np.zeros(tuple(t.shape), np.int32)
        for k in range(WORLD):
            # The one piece rank k held, in its bytes.
            [(index, arr)] = roots[k][path]["shards"]
            assert index == pl.index(k), (path, k)
            assert arr.tobytes() == base64.b64decode(
                ranks[k]["saved"][path]), (path, k)
            covered[tuple(slice(a, b) for a, b in index)] += 1
        assert (covered == pl.replicas).all(), path


def test_entries_are_what_jax_writes_for_the_same_leaf(run, tmp_path):
    """JAX's managers save each leaf, placed by the same spec, from the
    same processes: the port's entries are JAX's, piece for piece."""
    root = run["tmp"] / "port"
    plan = _plan()
    mesh = _jmesh()
    devices = mesh.devices.reshape(-1)
    port = {k: {e["path"]: e for e in _entries(root, k, CKPT_STEPS)
                if "shard" in e} for k in range(WORLD)}
    for path, t in flatten_state(run["state"]):
        spec = run["specs"][path]
        if spec is None:
            continue
        global_shape = tuple(t.shape)
        pl = TM.Placement(plan.mesh, spec, global_shape)
        value = np.zeros(global_shape, np.float32)
        for k in range(WORLD):
            held = np.frombuffer(base64.b64decode(run["ranks"][k]["saved"][
                path]), np.float32).reshape(pl.local_shape)
            value[tuple(slice(a, b) for a, b in pl.index(k))] = held
        arr = jax.device_put(value, NamedSharding(mesh, PartitionSpec(
            *spec)))
        for k in range(WORLD):
            jroot = tmp_path / path.replace("'", "").replace("[", "_") \
                .replace("]", "") / str(k)
            mgr = J.CheckpointManager(jroot, process_index=k,
                                      process_count=WORLD)
            assert mgr.save(CKPT_STEPS, _nest(
                {path: _ProcessView(arr, [devices[k]])}))
            mgr.close()
            [want] = _entries(jroot, k, CKPT_STEPS)
            got = port[k][path]
            drop = ("name",)
            assert {a: b for a, b in got.items() if a not in drop} == {
                a: b for a, b in want.items() if a not in drop}, (path, k)
            assert (root / f"proc{k}" / str(CKPT_STEPS) / got["name"]
                    ).read_bytes() == (jroot / f"proc{k}" / str(CKPT_STEPS)
                                       / want["name"]).read_bytes()


def test_jax_restores_the_port_step_at_every_process(run, monkeypatch):
    """JAX's manager at process k reads proc<k>/ alone; its template's
    leaves carry the sharding as process k sees it, in the order the port
    wrote them (an ``OrderedDict`` tree, whose keystr paths are the
    port's). The assembly onto devices is stubbed to hand back the pieces
    JAX's restore found."""
    monkeypatch.setattr(jax, "make_array_from_single_device_arrays",
                        lambda shape, sharding, arrays: [
                            np.asarray(a) for a in arrays])
    root = run["tmp"] / "port"
    mesh = _jmesh()
    devices = mesh.devices.reshape(-1)
    for k in range(WORLD):
        template: OrderedDict = OrderedDict()
        for path, t in flatten_state(run["state"]):
            *head, last = _keys(path)
            node = template
            for key in head:
                node = node.setdefault(key, OrderedDict())
            spec = run["specs"][path]
            node[last] = (np.zeros(tuple(t.shape), t.numpy().dtype)
                          if spec is None else _ProcessLeaf(_ProcessSharding(
                              NamedSharding(mesh, PartitionSpec(*spec)),
                              devices[k])))
        restored, at = J.CheckpointManager(
            root, process_index=k, process_count=WORLD).restore_latest(
            template)
        assert at == CKPT_STEPS, k
        for path in run["specs"]:
            value = restored
            for key in _keys(path):
                value = value[key]
            if isinstance(value, list):
                [value] = value  # the one device's piece
            assert np.ascontiguousarray(value).tobytes() == base64.b64decode(
                run["ranks"][k]["saved"][path]), (path, k)
    assert not list(root.rglob("corrupt-*"))


def test_a_jax_written_shard_step_restores_into_the_port_template(run):
    plan = _plan()
    shapes = {path: tuple(t.shape) for path, t in flatten_state(run["state"])}
    names = {f"['params']['{n}']": n for n, _ in
             run["state"]["params"].named_parameters()}
    for k, rec in enumerate(run["ranks"]):
        assert rec["jax_step"] == 1
        got = rec["jax_restored"]
        for path, name in names.items():
            pl = TM.Placement(plan.mesh, run["specs"][path], shapes[path])
            want = run["values"][path][tuple(
                slice(a, b) for a, b in pl.index(k))]
            data = np.frombuffer(base64.b64decode(got[name]["data"]),
                                 np.float32).reshape(got[name]["shape"])
            np.testing.assert_array_equal(data, want, err_msg=f"{k} {name}")


def test_a_resumed_sharded_run_has_zero_divergence(run):
    for rec in run["ranks"]:
        assert rec["restored_step"] == CKPT_STEPS
        assert rec["restored"] == rec["saved"]
        assert rec["losses"]["resumed"] == rec["losses"]["whole"]
    assert all(rec["losses"] == run["ranks"][0]["losses"]
               for rec in run["ranks"])


def test_a_step_a_rank_never_committed_is_not_restorable(run):
    assert [rec["latest_after_lone_save"] for rec in run["ranks"]] == [
        CKPT_STEPS] * WORLD
    assert (run["tmp"] / "port" / "proc0" / str(CKPT_STEPS + 5)).exists()


def test_a_changed_mesh_raises_jax_valueerror_and_quarantines_nothing(run):
    for rec in run["ranks"]:
        msg = rec["changed_mesh"]
        assert msg is not None and "no saved shard for index" in msg
        assert "sharding or process topology changed since the save?" in msg
    assert not list((run["tmp"] / "port").rglob("corrupt-*"))


def _train_sharded(tmp: Path, ckpt: Path, steps: int, corpus: str) -> list:
    """``examples/train_sharded`` as 2 gloo processes over the env
    contract; each rank's stdout lines."""
    port = _free_port()
    procs = []
    for k in range(2):
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": "2", "TPU_WORKER_ID": str(k)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.examples.train_sharded",
             "--config", "tiny", "--steps", str(steps), "--batch", "3",
             "--seq", "16", "--ckpt-dir", str(ckpt), "--data", corpus,
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=SPAWN_TIMEOUT))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-4000:]
    return [out.splitlines() for out, _ in outs]


def test_train_sharded_resumes_on_two_gloo_ranks(tmp_path):
    corpus = str(write_token_file(
        tmp_path / "corpus.bin",
        np.random.default_rng(3).integers(0, 256, 8192).astype(np.uint32)))
    first = _train_sharded(tmp_path, tmp_path / "a", 2, corpus)
    again = _train_sharded(tmp_path, tmp_path / "a", 4, corpus)
    whole = _train_sharded(tmp_path, tmp_path / "b", 4, corpus)
    for rank in range(2):
        assert "batch rounded up to 4 (multiple of 2 ranks)" in first[rank]
        assert "resumed from step 2 (preemption recovery)" in again[rank]
        losses = [x for x in first[rank] + again[rank]
                  if x.startswith("step ")]
        assert losses == [x for x in whole[rank] if x.startswith("step ")]
        assert len(losses) == 4
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "proc0", "proc1"]


def test_a_mixed_template_restores_or_raises_valueerror(tmp_path):
    """Two processes' roots written from this process: the mesh's grid
    puts this process at coordinate k (``devices`` [0, 1] or [1, 0]).
    Leaf "a" is saved whole, "b" as fsdp pieces."""
    a = torch.arange(4, dtype=torch.float32)
    b = torch.arange(16, dtype=torch.float32).reshape(8, 2)

    def placed(value, k, spec=("fsdp",)):
        mesh = TM.make_mesh(fsdp=2, devices=[0, 1] if k == 0 else [1, 0])
        pl = TM.Placement(mesh, spec, tuple(value.shape))
        return TM.place(pl.slice(value).clone(), pl)

    for k in range(2):
        assert P.CheckpointManager(tmp_path, process_index=k,
                                   process_count=2).save(
            1, {"a": a.clone(), "b": placed(b, k)})
    mgr = P.CheckpointManager(tmp_path, process_index=1, process_count=2)
    # Each leaf where the root holds it: "a" whole or sliced to a piece.
    restored, at = mgr.restore_latest({"a": placed(torch.zeros(4), 1),
                                       "b": placed(torch.zeros(8, 2), 1)})
    assert at == 1
    assert torch.equal(restored["a"], a[2:])
    assert torch.equal(restored["b"], b[4:])
    bad = {
        "do not cover the whole array": {"a": torch.zeros(4),
                                         "b": torch.zeros(8, 2)},
        "no saved shard for index": {"a": torch.zeros(4), "b": placed(
            torch.zeros(8, 2), 1, spec=(None,))},
        "does not match a checkpoint leaf": {"a": torch.zeros(4),
                                             "c": placed(torch.zeros(8, 2),
                                                         1)},
        "does not match checkpoint leaf": {"a": torch.zeros(5),
                                           "b": placed(torch.zeros(8, 2),
                                                       1)},
    }
    for msg, template in bad.items():
        with pytest.raises(ValueError, match=msg):
            mgr.restore_latest(template)
    assert not list(tmp_path.rglob("corrupt-*"))
