"""The port's per-process checkpoint roots, its manifests and its spans
against the JAX package's.

``tests/test_checkpoint.py``'s multi-process cases (a step needs every
process's commit; a quarantine on one process drops the step for all; the
identity comes from the webhook's env) run on both packages in lockstep.
Steps written by one package at process (0, 2) and (1, 2) are read by the
other's managers at the same identities; the same state saved by both
gives byte-equal manifests and data files; the spans carry the
reference's names and attributes through the port's tracing. A step of
leaves sharded over processes (JAX's shard format) written by JAX is
restored by the port into a whole template (its root's shards cover the
leaf, as JAX's dense assembly asks) and left where it is; a ``DTensor``
handed to a one-process manager raises as JAX's multi-host guard does,
and a two-process manager writes its piece in JAX's shard format.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.observability import tracing as JT
from kubeflow_tpu.runtime import checkpoint as J
from kubeflow_tpu_torch.observability import tracing as PT
from kubeflow_tpu_torch.runtime import checkpoint as P

PACKAGES = {"jax": (J, lambda a: a.copy()),
            "port": (P, lambda a: torch.from_numpy(a.copy()))}


def _tree(package: str, **arrays) -> dict:
    leaf = PACKAGES[package][1]
    return {k: leaf(np.asarray(v)) for k, v in arrays.items()}


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.numpy()
    return np.asarray(value)


def _mgrs(package: str, root: Path, count: int = 2, **kw) -> list:
    ck = PACKAGES[package][0]
    return [ck.CheckpointManager(root, process_index=k, process_count=count,
                                 **kw) for k in range(count)]


def _lockstep(scenario, tmp_path) -> list:
    got = [scenario(package, tmp_path / package) for package in PACKAGES]
    assert got[1] == got[0]
    return got[1]


def test_step_requires_every_process_commit(tmp_path):
    def scenario(package, root):
        m0, m1 = _mgrs(package, root)
        obs = [m0.save(1, _tree(package, w=np.arange(4.0))),
               m1.save(1, _tree(package, w=np.arange(4.0))),
               m0.save(2, _tree(package, w=np.ones(4))),
               m0.latest_step(), m1.latest_step()]
        for mgr in (m0, m1):
            restored, at = mgr.restore_latest(_tree(package, w=np.zeros(4)))
            obs += [at, _numpy(restored["w"]).tolist()]
        obs.append(sorted(str(p.relative_to(root)) for p in root.rglob("*")
                          if p.is_dir()))
        return obs

    obs = _lockstep(scenario, tmp_path)
    assert obs[:9] == [True, True, True, 1, 1, 1, [0, 1, 2, 3], 1,
                       [0, 1, 2, 3]]
    assert obs[9] == ["proc0", "proc0/1", "proc0/2", "proc1", "proc1/1"]


def test_quarantine_breaks_the_global_commit(tmp_path):
    def scenario(package, root):
        m0, m1 = _mgrs(package, root)
        for s in (1, 2):
            for mgr in (m0, m1):
                assert mgr.save(s, _tree(package, w=np.full(4, float(s))),
                                force=True)
        victim = next((root / "proc0" / "2").glob("*.bin"))
        blob = bytearray(victim.read_bytes())
        blob[0] ^= 0xFF
        victim.write_bytes(bytes(blob))
        obs = []
        for mgr in (m0, m1):
            restored, at = mgr.restore_latest(_tree(package, w=np.zeros(4)))
            obs += [at, _numpy(restored["w"]).tolist()]
        return obs + [sorted(p.name.split("-")[0] for p in
                             (root / "proc0").iterdir()),
                      m0.latest_step(), m1.latest_step()]

    assert _lockstep(scenario, tmp_path) == [
        1, [1.0] * 4, 1, [1.0] * 4, ["1", "corrupt"], 1, 1]


def test_process_identity_from_webhook_env(tmp_path):
    def scenario(package, root):
        env = {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "h0,h1"}
        ckpt = PACKAGES[package][0].CheckpointManager(root, env=env)
        obs = [(ckpt.process_index, ckpt.process_count),
               ckpt.save(1, _tree(package, w=np.zeros(2))),
               (root / "proc1" / "1" / "manifest.json").exists(),
               ckpt.latest_step()]
        peer = PACKAGES[package][0].CheckpointManager(
            root, env={**env, "TPU_WORKER_ID": "0"})
        obs += [peer.save(1, _tree(package, w=np.zeros(2))),
                ckpt.latest_step(), peer.latest_step()]
        return obs

    assert _lockstep(scenario, tmp_path) == [(1, 2), True, True, None, True,
                                             1, 1]


def test_process_identity_out_of_range_raises(tmp_path):
    for ck in (J, P):
        with pytest.raises(ValueError, match=r"process_index 2 not in \[0, 2\)"):
            ck.CheckpointManager(tmp_path / ck.__name__, process_index=2,
                                 process_count=2)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_two_process_step_is_read_by_the_other_package(tmp_path, writer,
                                                       reader):
    rng = np.random.default_rng(11)
    values = [{"w": rng.normal(size=(3, 5)).astype(np.float32),
               "n": np.int64(k + 40)} for k in range(2)]
    for k, mgr in enumerate(_mgrs(writer, tmp_path)):
        assert mgr.save(6, _tree(writer, **values[k]),
                        metadata={"start_batch": 6})
    # One process only at step 7: not a step of the slice.
    _mgrs(writer, tmp_path)[0].save(7, _tree(writer, **values[0]))
    for k, mgr in enumerate(_mgrs(reader, tmp_path)):
        assert mgr.latest_step() == 6
        restored, at = mgr.restore_latest(
            _tree(reader, w=np.zeros((3, 5), np.float32), n=np.int64(0)))
        assert at == 6 and mgr.restored_metadata == {"start_batch": 6}
        assert P.resume_start_batch(mgr, at) == 6
        np.testing.assert_array_equal(_numpy(restored["w"]), values[k]["w"])
        assert int(_numpy(restored["n"])) == 40 + k
        manifest = json.loads((tmp_path / f"proc{k}" / "6" /
                               "manifest.json").read_text())
        assert manifest["process"] == {"index": k, "count": 2}


@pytest.mark.parametrize("count", [1, 2])
def test_same_state_gives_byte_equal_manifests_and_files(tmp_path, count):
    """No field differs: paths, dtype names, shapes, sizes, CRC32s, the
    metadata and the process block are the same bytes."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    b16 = rng.normal(size=(7,)).astype(ml_dtypes.bfloat16)
    ints = rng.integers(-5, 5, size=(2, 2, 3)).astype(np.int32)
    jax_state = {"params": {"w": w, "b16": b16}, "ints": ints,
                 "step": np.int64(12), "scale": np.float32(0.5)}
    port_state = {"params": {"w": torch.from_numpy(w.copy()),
                             "b16": torch.from_numpy(
                                 b16.view(np.int16).copy()).view(
                                     torch.bfloat16)},
                  "ints": torch.from_numpy(ints.copy()),
                  "step": torch.tensor(12, dtype=torch.int64),
                  "scale": torch.tensor(0.5, dtype=torch.float32)}
    meta = {"start_batch": 12, "note": "same"}
    for package, state in (("jax", jax_state), ("port", port_state)):
        for mgr in _mgrs(package, tmp_path / package, count=count):
            assert mgr.save(12, state, metadata=meta)
    for k in range(count):
        sub = Path(f"proc{k}") if count > 1 else Path()
        dirs = [tmp_path / package / sub / "12" for package in PACKAGES]
        files = [{p.name: p.read_bytes() for p in sorted(d.iterdir())}
                 for d in dirs]
        assert files[0] == files[1]
        manifest = json.loads(files[1]["manifest.json"])
        assert [f["dtype"] for f in manifest["files"]] == [
            "int32", "bfloat16", "float32", "float32", "int64"]
        assert manifest["process"] == {"index": k, "count": count}


@pytest.fixture()
def exporters():
    jexp, pexp = JT.InMemoryExporter(), PT.InMemoryExporter()
    JT.set_tracer_provider(JT.TracerProvider(exporter=jexp))
    PT.set_tracer_provider(PT.TracerProvider(exporter=pexp))
    yield jexp, pexp
    JT.set_tracer_provider(JT.TracerProvider())
    PT.set_tracer_provider(PT.TracerProvider())


def _spans(exporter) -> list:
    return [(s.name, dict(s.attributes)) for s in exporter.spans]


def test_spans_carry_the_references_names_and_attributes(tmp_path, exporters):
    def scenario(package, root):
        ck = PACKAGES[package][0]
        mgr = ck.CheckpointManager(root, save_interval_steps=10)
        mgr.save(1, _tree(package, w=np.zeros(3)))
        mgr.save(2, _tree(package, w=np.ones(3)))
        mgr.emergency_save(grace_s=20)
        mgr.emergency_save()
        mgr.restore_latest(_tree(package, w=np.zeros(3)))
        ck.CheckpointManager(root / "empty").restore_latest(
            _tree(package, w=np.zeros(3)))

    for (package, _), exporter in zip(PACKAGES.items(), exporters):
        scenario(package, tmp_path / package)
    want = _spans(exporters[0])
    assert _spans(exporters[1]) == want
    assert want == [
        ("checkpoint.write", {"step": 1, "committed": True}),
        ("checkpoint.write", {"step": 2, "committed": True}),
        ("checkpoint.emergency_save", {"grace_s": 20, "committed": True}),
        ("checkpoint.emergency_save", {"committed": False}),
        ("checkpoint.restore", {"restored_step": 2}),
        ("checkpoint.restore", {"restored_step": None}),
    ]
    # The emergency save's write is a child of its span.
    emergency = exporters[1].by_name("checkpoint.emergency_save")[0]
    writes = exporters[1].by_name("checkpoint.write")
    assert writes[1].parent_id == emergency.span_id


class _FakeGlobalArray:
    """A jax.Array spanning non-addressable devices, as one process sees
    it (as in tests/test_checkpoint.py)."""

    is_fully_addressable = False

    def __init__(self, arr):
        self._arr = arr
        self.shape = arr.shape
        self.dtype = arr.dtype

    @property
    def addressable_shards(self):
        return self._arr.addressable_shards

    def __array__(self, *args, **kwargs):
        raise RuntimeError("np.asarray on a non-addressable jax.Array")


def test_sharded_step_is_refused_and_left_in_place(tmp_path):
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("x",))
    data = np.arange(64, dtype=np.float32).reshape(8, 8)
    arr = jax.device_put(data, NamedSharding(mesh, PartitionSpec("x", None)))
    state = {"step": np.int64(3), "w": _FakeGlobalArray(arr)}
    for mgr in _mgrs("jax", tmp_path):
        assert mgr.save(1, state)
    before = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*"))
    for mgr in _mgrs("port", tmp_path):
        assert mgr.latest_step() == 1
        restored, at = mgr.restore_latest(_tree(
            "port", step=np.int64(0), w=np.zeros((8, 8), np.float32)))
        assert at == 1
        np.testing.assert_array_equal(restored["w"].numpy(), data)
        assert int(restored["step"]) == 3
    after = sorted(str(p.relative_to(tmp_path)) for p in tmp_path.rglob("*"))
    assert after == before
    assert not [p for p in tmp_path.rglob("corrupt-*")]
    restored, at = _mgrs("jax", tmp_path)[0].restore_latest(
        {"step": np.int64(0), "w": np.zeros_like(data)})
    assert at == 1
    np.testing.assert_array_equal(restored["w"], data)


def test_dtensor_leaf_raises_as_the_multi_host_guard_does(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        leaf = distribute_tensor(torch.arange(8.0), mesh, [Shard(0)])
        with pytest.raises(RuntimeError, match="process_count"):
            P.CheckpointManager(tmp_path / "one").save(1, {"w": leaf})
        mgr = P.CheckpointManager(tmp_path / "two", process_index=0,
                                  process_count=2)
        assert mgr.save(1, {"w": leaf})
        manifest = json.loads(
            (tmp_path / "two" / "proc0" / "1" / "manifest.json").read_text())
        [entry] = manifest["files"]
        assert entry["name"] == "00000.s0.bin"
        assert entry["shard"] == {"index": [[0, 8]], "global_shape": [8]}
        assert P.CheckpointManager(tmp_path / "one").latest_step() is None
    finally:
        dist.destroy_process_group()
