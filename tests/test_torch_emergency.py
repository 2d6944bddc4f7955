"""The port's emergency save and SIGTERM handler in lockstep with the JAX
package's.

Each case of ``tests/test_checkpoint.py``'s durability suite (the pending
snapshot, the SIGTERM handler's commit, chain, skip and uninstall, the
grace budget, the injected clock, a step's inherited age, a contained
save failure, the train loop's flush, the async worker's survival and
restart, the held queue mutex, a SIGKILLed child) runs once on each
package's ``CheckpointManager`` and ``install_preemption_handler``, with
the same fake clock and the JAX package's ``Metrics``. ``scenario(side,
root)`` returns what it observed (return values, committed steps, counter
values, restored values, manifests); the two lists must be equal, and the
port's must hold what the reference test asserts. The signal cases
restore the previous handler in a ``finally``, as the reference's do.
"""

from __future__ import annotations

import importlib
import json
import os
import queue as queue_mod
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu.metrics import Metrics
from kubeflow_tpu.runtime import checkpoint as J
from kubeflow_tpu_torch.runtime import checkpoint as P

JB = importlib.import_module("kubeflow_tpu.runtime.bootstrap")
PB = importlib.import_module("kubeflow_tpu_torch.runtime.bootstrap")
ROOT = Path(__file__).resolve().parent.parent


class Side:
    """One package: its checkpoint module, its handler, and how a numpy
    value becomes one of its leaves and back."""

    def __init__(self, name, ck, boot, leaf):
        self.name, self.ck, self.boot, self._leaf = name, ck, boot, leaf

    def tree(self, **arrays) -> dict:
        return {k: self._leaf(np.asarray(v)) for k, v in arrays.items()}

    def leaf(self, value):
        return self._leaf(np.asarray(value))

    @staticmethod
    def numpy(value) -> np.ndarray:
        if isinstance(value, torch.Tensor):
            return value.detach().cpu().numpy()
        return np.asarray(value)

    def mgr(self, root: Path, **kw):
        return self.ck.CheckpointManager(root / self.name, **kw)


JAX = Side("jax", J, JB, lambda a: a.copy())
PORT = Side("port", P, PB, lambda a: torch.from_numpy(a.copy()))


def _counter(counter) -> float:
    for metric in counter.collect():
        for sample in metric.samples:
            if sample.name.endswith("_total"):
                return sample.value
    return 0.0


def _committed(directory: Path) -> list:
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.name.isdigit() and (p / "manifest.json").exists())


def _manifests(directory: Path) -> dict:
    return {s: (directory / str(s) / "manifest.json").read_bytes()
            for s in _committed(directory)}


class _FakeClock:
    """Injectable monotonic clock: advances only when the test says so."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def lockstep(scenario, tmp_path) -> list:
    """Run ``scenario`` on both packages; their observations must be equal.
    Returns the port's."""
    got = [scenario(side, tmp_path) for side in (JAX, PORT)]
    assert got[1] == got[0]
    return got[1]


def test_save_interval_skips_but_records_pending(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, save_interval_steps=2)
        obs = [ckpt.save(1, side.tree(w=np.zeros(4))),
               ckpt.save(2, side.tree(w=np.ones(4))),
               ckpt.save(3, side.tree(w=np.full(4, 3.0))),
               ckpt.save(4, side.tree(w=np.full(4, 4.0))),
               ckpt.latest_step(),
               ckpt.save(5, side.tree(w=np.full(4, 5.0))),
               ckpt.emergency_save(), ckpt.latest_step(),
               ckpt.emergency_save()]
        return obs + [_manifests(root / side.name)]

    obs = lockstep(scenario, tmp_path)
    assert obs[:9] == [True, True, False, True, 4, False, True, 5, False]


def test_pending_snapshot_is_a_copy_of_the_state(tmp_path):
    """The port updates its state in place: the pending snapshot must be
    the values at ``save``, not the live tensors after it."""
    ckpt = P.CheckpointManager(tmp_path, save_interval_steps=100)
    state = {"w": torch.zeros(4)}
    assert ckpt.save(1, state)
    state["w"].add_(2.0)
    assert not ckpt.save(2, state)
    state["w"].add_(1.0)  # the next step, after the interval skipped 2
    assert ckpt.emergency_save()
    template = {"w": torch.zeros(4)}
    _, step = P.CheckpointManager(tmp_path).restore_latest(template)
    assert step == 2 and torch.equal(template["w"], torch.full((4,), 2.0))


def test_sigterm_emergency_save_commits_then_skips_fresh(tmp_path):
    def scenario(side, root):
        m = Metrics()
        ckpt = side.mgr(root, save_interval_steps=100, metrics=m)
        obs = [ckpt.save(1, side.tree(w=np.arange(16.0)))]
        latest = np.arange(16.0) * 2
        obs.append(ckpt.save(2, side.tree(w=latest)))
        received = []
        prev = signal.signal(signal.SIGTERM, lambda s, f: received.append(s))
        try:
            uninstall = side.boot.install_preemption_handler(
                ckpt, env={"TPU_CHECKPOINT_GRACE_S": "60"})
            signal.raise_signal(signal.SIGTERM)
            obs += [ckpt.latest_step(), _counter(m.checkpoint_emergency_total),
                    list(received)]
            restored, at = ckpt.restore_latest(side.tree(w=np.zeros(16)))
            obs += [at, side.numpy(restored["w"]).tolist()]
            signal.raise_signal(signal.SIGTERM)  # fresh save exists: skip
            obs += [_counter(m.checkpoint_emergency_total), list(received)]
            uninstall()
            signal.raise_signal(signal.SIGTERM)  # handler restored
            obs += [list(received), _counter(m.checkpoint_emergency_total)]
        finally:
            signal.signal(signal.SIGTERM, prev)
        return obs + [_manifests(root / side.name)]

    t = signal.SIGTERM
    obs = lockstep(scenario, tmp_path)
    assert obs[:11] == [True, False, 2, 1.0, [t], 2,
                        (np.arange(16.0) * 2).tolist(), 1.0, [t, t],
                        [t, t, t], 1.0]


def test_sig_ign_is_honoured(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, save_interval_steps=100)
        obs = [ckpt.save(1, side.tree(w=np.zeros(2))),
               ckpt.save(2, side.tree(w=np.ones(2)))]
        prev = signal.signal(signal.SIGTERM, signal.SIG_IGN)
        try:
            uninstall = side.boot.install_preemption_handler(
                ckpt, env={"TPU_CHECKPOINT_GRACE_S": "30"})
            signal.raise_signal(signal.SIGTERM)  # saved, and still alive
            obs.append(ckpt.latest_step())
            uninstall()
            obs.append(signal.getsignal(signal.SIGTERM) is signal.SIG_IGN)
        finally:
            signal.signal(signal.SIGTERM, prev)
        return obs

    assert lockstep(scenario, tmp_path) == [True, False, 2, True]


_DFL_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
package, directory = sys.argv[2], sys.argv[3]
if package == "port":
    import torch
    from kubeflow_tpu_torch.runtime import install_preemption_handler
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    leaf = lambda a: torch.from_numpy(a)
else:
    from kubeflow_tpu.runtime.bootstrap import install_preemption_handler
    from kubeflow_tpu.runtime.checkpoint import CheckpointManager
    leaf = lambda a: a
ckpt = CheckpointManager(directory, save_interval_steps=100, async_save=True)
install_preemption_handler(ckpt)
for step in (1, 2, 3):
    ckpt.save(step, {"w": leaf(np.full(8, float(step)))},
              metadata={"start_batch": step})
print("saved 3", flush=True)
import signal
signal.raise_signal(signal.SIGTERM)
print("survived", flush=True)
"""


def test_sigterm_with_default_disposition_saves_then_dies(tmp_path):
    """The card phase's shape on the CPU: a child with the default SIGTERM
    disposition saves step 1 asynchronously, leaves 2 and 3 pending, and on
    SIGTERM commits step 3 and then dies of the signal."""
    results = {}
    for side in (JAX, PORT):
        directory = tmp_path / side.name
        proc = subprocess.run(
            [sys.executable, "-c", _DFL_CHILD, str(ROOT), side.name,
             str(directory)],
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "TPU_CHECKPOINT_GRACE_S": "60"})
        assert "saved 3" in proc.stdout, proc.stderr
        template = side.tree(w=np.zeros(8))
        mgr = side.mgr(tmp_path)
        restored, at = mgr.restore_latest(template)
        results[side.name] = (
            proc.returncode, "survived" in proc.stdout, _committed(directory),
            at, side.numpy(restored["w"]).tolist(), mgr.restored_metadata,
            _manifests(directory))
    assert results["port"] == results["jax"]
    assert results["port"][:6] == (-signal.SIGTERM, False, [1, 3], 3,
                                   [3.0] * 8, {"start_batch": 3})


def test_emergency_save_skips_when_budget_too_small(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, save_interval_steps=100)
        obs = [ckpt.save(1, side.tree(w=np.zeros(4)))]
        ckpt._last_save_duration = 999.0
        obs += [ckpt.save(2, side.tree(w=np.ones(4))),
                ckpt.emergency_save(grace_s=1.0), ckpt.latest_step()]
        return obs

    assert lockstep(scenario, tmp_path) == [True, False, False, 1]


def test_emergency_save_with_nothing_pending(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root)
        return [ckpt.emergency_save(grace_s=5.0), ckpt.emergency_save(),
                ckpt.latest_step()]

    assert lockstep(scenario, tmp_path) == [False, False, None]


def test_injected_clock_is_the_single_time_source(tmp_path):
    def scenario(side, root):
        clk = _FakeClock()
        ckpt = side.mgr(root, clock=clk)
        obs = [ckpt.last_commit_age(), ckpt.save(1, side.tree(w=np.zeros(4))),
               ckpt.last_commit_age()]
        clk.advance(12.5)
        obs += [ckpt.last_commit_age(), ckpt._last_save_duration]
        clk.advance(-100.0)
        return obs + [ckpt.last_commit_age()]

    assert lockstep(scenario, tmp_path) == [float("inf"), True, 0.0, 12.5,
                                            0.0, 0.0]


def test_emergency_budget_counts_on_injected_clock(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, save_interval_steps=100, clock=_FakeClock())
        return [ckpt.save(1, side.tree(w=np.zeros(4))),
                ckpt.save(2, side.tree(w=np.ones(4))),
                ckpt.emergency_save(grace_s=0.001), ckpt.latest_step()]

    assert lockstep(scenario, tmp_path) == [True, False, True, 2]


def test_inherited_step_age_is_unknown_until_restore(tmp_path):
    def scenario(side, root):
        first = side.mgr(root)
        obs = [first.save(1, side.tree(w=np.arange(4.0)))]
        clk = _FakeClock(1000.0)
        second = side.mgr(root, clock=clk)
        obs += [second.latest_step(), second.last_commit_age()]
        _, step = second.restore_latest(side.tree(w=np.zeros(4)))
        obs += [step, second.last_commit_age()]
        clk.advance(3.0)
        return obs + [second.last_commit_age()]

    assert lockstep(scenario, tmp_path) == [True, 1, float("inf"), 1, 0.0,
                                            3.0]


def test_save_failure_is_contained_and_recovers(tmp_path):
    import errno

    def scenario(side, root):
        class FullDiskIO(side.ck.CheckpointIO):
            full = False

            def write_file(self, path, data):
                if self.full:
                    raise OSError(errno.ENOSPC, "No space left on device")
                super().write_file(path, data)

        io = FullDiskIO()
        ckpt = side.mgr(root, io=io)
        obs = [ckpt.save(1, side.tree(w=np.zeros(8)))]
        io.full = True
        obs += [ckpt.save(2, side.tree(w=np.ones(8))), ckpt.save_failures,
                type(ckpt.last_save_error).__name__, ckpt.latest_step(),
                sorted(p.name for p in (root / side.name).iterdir())]
        io.full = False
        obs += [ckpt.save(3, side.tree(w=np.full(8, 3.0))),
                ckpt.latest_step()]
        return obs + [_manifests(root / side.name)]

    obs = lockstep(scenario, tmp_path)
    assert obs[:8] == [True, False, 1, "OSError", 1, ["1"], True, 3]


class Boom(RuntimeError):
    pass


def test_train_loop_flushes_async_saves_on_exception(tmp_path):
    def scenario(side, root):
        def step_fn(state, batch):
            if batch == "boom":
                raise Boom()
            return state + 1, np.float32(batch)

        ckpt = side.mgr(root, async_save=True)
        with pytest.raises(Boom):
            side.ck.train_with_checkpointing(
                step_fn, side.leaf(np.int64(0)), [1.0, "boom", 3.0], ckpt)
        obs = [ckpt.latest_step(), _manifests(root / side.name)]
        ckpt.close()
        return obs

    assert lockstep(scenario, tmp_path)[0] == 1


def test_train_loop_tolerates_empty_batches(tmp_path):
    def scenario(side, root):
        def step_fn(state, batch):  # pragma: no cover - never called
            raise AssertionError("no batches, no steps")

        state, losses = side.ck.train_with_checkpointing(
            step_fn, 5, [], side.mgr(root))
        return [state, losses]

    assert lockstep(scenario, tmp_path) == [5, []]


def test_async_worker_survives_unserializable_metadata(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, async_save=True)
        obs = [ckpt.save(1, side.tree(w=np.zeros(4)),
                         metadata={"bad": object()}),
               ckpt.wait(timeout=30), ckpt.save_failures,
               type(ckpt.last_save_error).__name__, ckpt.latest_step(),
               ckpt.save(2, side.tree(w=np.ones(4))), ckpt.wait(timeout=30),
               ckpt.latest_step()]
        ckpt.close()
        # The poisoned step's staging dir stays, as SIGKILL would leave it.
        return obs + [sorted(p.name.rsplit("-", 1)[0]
                             for p in (root / side.name).iterdir())]

    obs = lockstep(scenario, tmp_path)
    assert obs == [True, True, 1, "TypeError", None, True, True, 2,
                   [".tmp-1-" + str(os.getpid()), "2"]]


def _dead_thread():
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    return t


def test_ensure_worker_restarts_dead_worker(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, async_save=True)
        obs = [ckpt.save(1, side.tree(w=np.zeros(4))), ckpt.wait(timeout=30)]
        ckpt.close()
        ckpt._worker = _dead_thread()
        obs += [ckpt.save(2, side.tree(w=np.ones(4))), ckpt.wait(timeout=30),
                ckpt.latest_step()]
        ckpt.close()
        return obs

    assert lockstep(scenario, tmp_path) == [True, True, True, True, 2]


def test_wait_reports_dead_worker_instead_of_hanging(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, async_save=True)
        obs = [ckpt.save(1, side.tree(w=np.zeros(4))), ckpt.wait(timeout=30)]
        ckpt.close()
        ckpt._queue = queue_mod.Queue()
        ckpt._queue.put((2, [("['w']", side.leaf(np.ones(4)))], {}))
        ckpt._worker = _dead_thread()
        t0 = time.monotonic()
        obs += [ckpt.wait(timeout=30), ckpt.wait()]
        obs.append(time.monotonic() - t0 < 5.0)
        ckpt.close()
        return obs

    assert lockstep(scenario, tmp_path) == [True, True, False, False, True]


def test_emergency_save_survives_held_queue_mutex(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, async_save=True, save_interval_steps=100)
        obs = [ckpt.save(1, side.tree(w=np.zeros(4))), ckpt.wait(timeout=30),
               ckpt.save(2, side.tree(w=np.ones(4)))]
        t0 = time.monotonic()
        with ckpt._queue.mutex:  # what an interrupted put() looks like
            obs.append(ckpt.emergency_save(grace_s=4.0))
        obs += [time.monotonic() - t0 < 4.0, ckpt.latest_step()]
        ckpt.close()
        return obs

    assert lockstep(scenario, tmp_path) == [True, True, False, True, True, 2]


def test_sigterm_handler_defers_save_to_thread(tmp_path):
    def scenario(side, root):
        ckpt = side.mgr(root, async_save=True, save_interval_steps=100)
        obs = [ckpt.save(1, side.tree(w=np.zeros(4))), ckpt.wait(timeout=30),
               ckpt.save(2, side.tree(w=np.full(4, 2.0)))]
        received = []
        prev = signal.signal(signal.SIGTERM, lambda s, f: received.append(s))
        try:
            uninstall = side.boot.install_preemption_handler(
                ckpt, env={"TPU_CHECKPOINT_GRACE_S": "4"})
            with ckpt._queue.mutex:
                signal.raise_signal(signal.SIGTERM)
            obs += [list(received), ckpt.latest_step()]
            uninstall()
        finally:
            signal.signal(signal.SIGTERM, prev)
        ckpt.close()
        return obs

    assert lockstep(scenario, tmp_path) == [True, True, False,
                                            [signal.SIGTERM], 2]


_SIGKILL_CHILD = """
import sys, time
sys.path.insert(0, sys.argv[2])
import torch
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointIO, CheckpointManager

class SlowIO(CheckpointIO):
    def write_file(self, path, data):
        time.sleep(0.05)
        super().write_file(path, data)

mgr = CheckpointManager(
    sys.argv[1], io=SlowIO(), async_save=True, max_to_keep=100
)
step = 0
while True:
    step += 1
    state = {
        "b": torch.full((8,), step * 0.5, dtype=torch.float64),
        "w": torch.full((32, 32), float(step), dtype=torch.float64),
    }
    mgr.save(step, state)
    time.sleep(0.01)
"""


@pytest.mark.skipif(os.name != "posix", reason="needs SIGKILL")
def test_sigkill_during_async_save_leaves_valid_latest(tmp_path):
    """A port child checkpointing asynchronously is SIGKILLed mid-stream:
    every committed step validates under both packages' validators, and
    both managers restore the same consistent state."""
    ckpt_dir = tmp_path / "sigkill"
    child = subprocess.Popen(
        [sys.executable, "-c", _SIGKILL_CHILD, str(ckpt_dir), str(ROOT)],
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if ckpt_dir.exists() and len(_committed(ckpt_dir)) >= 2:
                break
            if child.poll() is not None:
                raise AssertionError(
                    f"child died early (rc={child.returncode})")
            time.sleep(0.01)
        else:
            raise AssertionError("child never committed 2 checkpoints")
        time.sleep(0.02)  # land the kill mid-write of a later step
    finally:
        child.kill()
        child.wait()

    committed = _committed(ckpt_dir)
    assert committed
    for step in committed:
        J._load_validated(ckpt_dir / str(step))
        P._load_validated(ckpt_dir / str(step))

    got = {}
    for side in (JAX, PORT):
        m = Metrics()
        mgr = side.ck.CheckpointManager(ckpt_dir, max_to_keep=100, metrics=m)
        restored, at = mgr.restore_latest(
            side.tree(b=np.zeros(8), w=np.zeros((32, 32))))
        got[side.name] = (at, _counter(m.checkpoint_corrupt_total),
                          side.numpy(restored["w"]).tolist(),
                          side.numpy(restored["b"]).tolist())
    assert got["port"] == got["jax"]
    at = got["port"][0]
    assert at == committed[-1] and got["port"][1] == 0
    assert got["port"][2] == np.full((32, 32), float(at)).tolist()
    assert got["port"][3] == np.full((8,), at * 0.5).tolist()


def test_emergency_span_and_metrics_hooks(tmp_path):
    """``checkpoint_save_seconds`` observes each commit's clock seconds;
    the emergency save counts on ``checkpoint_emergency_total``."""
    def scenario(side, root):
        m = Metrics()
        clk = _FakeClock()

        class TimedIO(side.ck.CheckpointIO):
            def write_file(self, path, data):
                clk.advance(0.25)
                super().write_file(path, data)

        ckpt = side.mgr(root, save_interval_steps=10, metrics=m, clock=clk,
                        io=TimedIO())
        ckpt.save(1, side.tree(a=np.zeros(2), b=np.ones(3)))
        ckpt.save(2, side.tree(a=np.ones(2), b=np.zeros(3)))
        obs = [ckpt._last_save_duration, ckpt.emergency_save(grace_s=10),
               ckpt._last_save_duration,
               _counter(m.checkpoint_emergency_total)]
        hist = [s.value for metric in m.checkpoint_save_seconds.collect()
                for s in metric.samples if s.name.endswith(("_sum", "_count"))]
        return obs + [hist]

    assert lockstep(scenario, tmp_path) == [0.75, True, 0.75, 1.0,
                                            [2.0, 1.5]]


def test_manifest_of_the_emergency_save_is_jaxs(tmp_path):
    """The same pending state flushed by both packages' emergency saves
    gives byte-equal manifests and data files."""
    def scenario(side, root):
        ckpt = side.mgr(root, save_interval_steps=100)
        ckpt.save(1, side.tree(w=np.arange(6, dtype=np.float32).reshape(2, 3),
                               n=np.int64(7)))
        ckpt.save(4, side.tree(w=np.ones((2, 3), np.float32),
                               n=np.int64(9)),
                  metadata={"start_batch": 4})
        assert ckpt.emergency_save(grace_s=30)
        step_dir = root / side.name / "4"
        return [json.loads((step_dir / "manifest.json").read_text()),
                {p.name: p.read_bytes() for p in sorted(step_dir.iterdir())}]

    manifest, _ = lockstep(scenario, tmp_path)
    assert manifest["metadata"] == {"start_batch": 4}
    assert manifest["process"] == {"index": 0, "count": 1}
