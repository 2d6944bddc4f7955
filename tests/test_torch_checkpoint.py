"""The port's checkpoint manager: its commit and restore rules, exact
resume of a tiny trainer, and the on-disk format shared with the JAX
package's manager (each reads a step directory the other wrote)."""

from __future__ import annotations

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.runtime import checkpoint as J
from kubeflow_tpu_torch.models.train import make_tiny_trainer
from kubeflow_tpu_torch.runtime import checkpoint as P


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((3, 4), generator=g),
        "nested": {"b": torch.randn((5,), generator=g).to(torch.bfloat16),
                   "scalar": torch.randn((), generator=g).to(torch.bfloat16)},
        "step": torch.tensor(seed, dtype=torch.int64),
    }


def _equal(a: dict, b: dict) -> bool:
    return all(pa == pb and ta.dtype == tb.dtype and torch.equal(ta, tb)
               for (pa, ta), (pb, tb) in zip(P.flatten_state(a),
                                              P.flatten_state(b)))


def test_round_trip_restores_into_the_template_in_place(tmp_path):
    mgr = P.CheckpointManager(tmp_path)
    saved = _state(1)
    assert mgr.save(7, saved, metadata={"start_batch": 7})
    template = _state(2)
    leaf = template["nested"]["b"]
    restored, step = P.CheckpointManager(tmp_path).restore_latest(template)
    assert step == 7 and restored is template
    assert template["nested"]["b"] is leaf  # written in place
    assert _equal(template, saved)
    manifest = json.loads((tmp_path / "7" / P.MANIFEST_NAME).read_text())
    assert manifest["format"] == 1 and manifest["metadata"] == {"start_batch": 7}
    assert [f["path"] for f in manifest["files"]] == [
        "['nested']['b']", "['nested']['scalar']", "['step']", "['w']"]
    assert [f["dtype"] for f in manifest["files"]] == [
        "bfloat16", "bfloat16", "int64", "float32"]


def test_interval_first_save_and_pruning(tmp_path):
    mgr = P.CheckpointManager(tmp_path, max_to_keep=2, save_interval_steps=3)
    state = _state(0)
    # The first call always commits, whatever the interval.
    assert [mgr.save(s, state) for s in (1, 2, 3, 4)] == [True, False, True,
                                                          False]
    assert mgr.save(5, state, force=True)
    assert mgr.save(6, state)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["5", "6"]
    assert mgr.latest_step() == 6


def test_async_save_snapshots_before_returning(tmp_path):
    mgr = P.CheckpointManager(tmp_path, async_save=True)
    state = _state(3)
    want = {"w": state["w"].clone()}
    assert mgr.save(1, {"w": state["w"]})
    state["w"].add_(1.0)  # the caller goes on updating in place
    mgr.close()
    template = {"w": torch.zeros((3, 4))}
    _, step = P.CheckpointManager(tmp_path).restore_latest(template)
    assert step == 1 and torch.equal(template["w"], want["w"])


def test_corrupt_byte_is_quarantined_and_restore_falls_back(tmp_path):
    mgr = P.CheckpointManager(tmp_path)
    mgr.save(1, _state(1), metadata={"start_batch": 1})
    mgr.save(2, _state(2), metadata={"start_batch": 2})
    victim = max((tmp_path / "2").glob("*.bin"), key=lambda p: p.stat().st_size)
    data = bytearray(victim.read_bytes())
    data[0] ^= 0xFF
    victim.write_bytes(bytes(data))
    fresh = P.CheckpointManager(tmp_path)
    template = _state(9)
    _, step = fresh.restore_latest(template)
    assert step == 1 and _equal(template, _state(1))
    assert fresh.restored_metadata == {"start_batch": 1}
    assert P.resume_start_batch(fresh, step) == 1
    assert [p.name.startswith("corrupt-2-") for p in tmp_path.iterdir()
            if not p.name.isdigit()] == [True]
    # Nothing left that validates: the template comes back untouched.
    (tmp_path / "1" / P.MANIFEST_NAME).write_text("{")
    untouched = _state(9)
    assert P.CheckpointManager(tmp_path).restore_latest(untouched)[1] is None
    assert _equal(untouched, _state(9))


def test_wrong_template_raises_and_quarantines_nothing(tmp_path):
    P.CheckpointManager(tmp_path).save(1, _state(1))
    with pytest.raises(ValueError, match="does not match"):
        P.CheckpointManager(tmp_path).restore_latest(
            {**_state(1), "w": torch.zeros((4, 3))})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1"]


def test_save_failure_is_contained(tmp_path):
    class FullDisk(P.CheckpointIO):
        def write_file(self, path, data):
            raise OSError(28, "No space left on device")

    P.CheckpointManager(tmp_path).save(1, _state(1))
    mgr = P.CheckpointManager(tmp_path, io=FullDisk())
    assert not mgr.save(2, _state(2))
    assert mgr.save_failures == 1 and isinstance(mgr.last_save_error, OSError)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1"]


def test_interrupted_tiny_trainer_resumes_the_exact_loss_curve(tmp_path):
    step_fn, fresh_state, batches = make_tiny_trainer(steps=4, device="cpu")
    _, full = P.train_with_checkpointing(
        step_fn, fresh_state(0), batches,
        P.CheckpointManager(tmp_path / "full"))
    ckpt = P.CheckpointManager(tmp_path / "cut", save_interval_steps=2)
    _, first = P.train_with_checkpointing(step_fn, fresh_state(0), batches[:2],
                                          ckpt)
    # A fresh process: other weights, restored from the committed step 2.
    resumed = P.CheckpointManager(tmp_path / "cut", save_interval_steps=2)
    state, at = resumed.restore_latest(fresh_state(7))
    assert at == 2 and int(state["step"]) == 2
    start = P.resume_start_batch(resumed, at)
    _, rest = P.train_with_checkpointing(step_fn, state, batches[start:],
                                         resumed, start_step=at)
    curve = [float(x) for x in first + rest]
    assert curve == [float(x) for x in full]
    assert len(set(curve)) == 4


def test_jax_manager_reads_the_ports_step(tmp_path):
    saved = _state(4)
    P.CheckpointManager(tmp_path).save(3, saved)
    step_dir = tmp_path / "3"
    arrays, _ = J._load_validated(step_dir)
    assert [a.dtype.name for _, a in arrays] == ["bfloat16", "bfloat16",
                                                 "int64", "float32"]
    template = {"w": np.zeros((3, 4), np.float32),
                "nested": {"b": np.zeros((5,), ml_dtypes.bfloat16),
                           "scalar": np.zeros((), ml_dtypes.bfloat16)},
                "step": np.zeros((), np.int64)}
    mgr = J.CheckpointManager(tmp_path, process_index=0, process_count=1)
    restored, step = mgr.restore_latest(template)
    assert step == 3
    np.testing.assert_array_equal(restored["w"], saved["w"].numpy())
    got_b = restored["nested"]["b"].view(np.uint16)
    want_b = saved["nested"]["b"].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got_b, want_b)
    assert int(restored["step"]) == 4


def test_port_manager_reads_the_jax_step(tmp_path):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(ml_dtypes.bfloat16)
    J.CheckpointManager(tmp_path, process_index=0, process_count=1).save(
        6, {"w": w, "b": b}, metadata={"start_batch": 6})
    template = {"w": torch.zeros((3, 4)),
                "b": torch.zeros((5,), dtype=torch.bfloat16)}
    mgr = P.CheckpointManager(tmp_path)
    _, step = mgr.restore_latest(template)
    assert step == 6 and mgr.restored_metadata == {"start_batch": 6}
    np.testing.assert_array_equal(template["w"].numpy(), w)
    np.testing.assert_array_equal(
        template["b"].view(torch.int16).numpy().view(np.uint16),
        b.view(np.uint16))
