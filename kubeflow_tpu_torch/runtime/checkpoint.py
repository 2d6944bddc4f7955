"""Crash-safe checkpointing of a torch training state.

The counterpart of ``kubeflow_tpu/runtime/checkpoint.py`` for whole
leaves, on the same on-disk format, so either package's manager validates
and reads a step directory the other wrote:

- **Atomic commit.** Each step is written into a ``.tmp-*`` staging dir:
  one ``NNNNN.bin`` per leaf (its raw bytes) and, last, ``manifest.json``
  (``format`` 1, the step, the caller's metadata, the writing process's
  index and count, and per file its leaf path, dtype name, shape, size
  and CRC32). Every file is fsynced, then the staging dir, then
  ``CheckpointIO.commit`` renames it to ``<step>/`` (the one rename) and
  fsyncs the parent. A process killed mid-save leaves a ``.tmp-*`` dir
  that restore never looks at.
- **Validated restore with quarantine.** ``restore_latest`` walks
  committed steps newest first, re-verifies each file's size and CRC32,
  moves a step that fails aside as ``corrupt-<step>-*`` (counted by
  ``checkpoint_corrupt_total``) and falls back to the next newest.
- **Deadline-bounded emergency save.** ``save`` records every state it
  is handed as a host snapshot, interval-skipped or not;
  ``emergency_save`` (the SIGTERM path, ``runtime.bootstrap.
  install_preemption_handler``) writes the newest one synchronously
  inside a grace budget, and skips when it is already committed or when
  the last save's duration exceeds what is left of the budget. Every
  duration and freshness figure reads the injected ``clock``.
- **Exact resume.** ``train_with_checkpointing`` records the loader cursor
  (``{"start_batch": step}``) in each save's metadata;
  ``resume_start_batch`` reads it back for
  ``data.loader.sharded_loader(start_batch=...)``.
- **One root per process.** With ``process_count > 1`` each process
  commits into ``<dir>/proc<k>/`` (identity from ``process_index``/
  ``process_count``, else the webhook's env contract through
  ``runtime.bootstrap.runtime_from_env``), and ``latest_step`` /
  ``restore_latest`` consider only steps that every process committed.

Spans ``checkpoint.write`` (``step``, ``committed``),
``checkpoint.emergency_save`` (``grace_s``, ``committed``) and
``checkpoint.restore`` (``restored_step``) go through the port's
``observability/tracing.py``; the metric hooks (``checkpoint_save_seconds``,
``checkpoint_corrupt_total``, ``checkpoint_emergency_total``) are read off
``metrics`` by name, so any bundle with those attributes works.

A state is a tree of dicts (keys in sorted order, as JAX flattens them),
``nn.Module``s (their ``state_dict()`` order), optimizers (their
parameters in ``param_groups`` order, each one's state keys sorted) and
tensors. Leaf paths are written as JAX's ``keystr`` writes them
(``['params']['layers.0.wq']``, ``['opt_state'][3]['exp_avg']``). A bf16
leaf is stored as its raw 16-bit words under the dtype name
``"bfloat16"`` (through ``tensor.view(torch.uint8)``: numpy has no bf16).
``restore_latest`` copies each leaf INTO the template's tensor, one file
at a time, so a large state is never held twice: pass a state of the same
structure (a fresh ``init_state``) and it comes back filled.

**Sharded leaves, in JAX's shard format.** A leaf laid out over several
processes (a tensor with a ``parallel/mesh.py`` ``Placement`` over a mesh
of more than one rank, or a ``DTensor``) is never gathered: each process
writes its own piece into its ``proc<k>/`` root as ``NNNNN.sJ.bin``, its
manifest entry carrying ``"shard": {"index": [[start, stop], ...],
"global_shape": [...]}``, as JAX writes a process's addressable shards.
JAX deduplicates pieces by index among one process's devices; a port
process drives one device, so it writes the one piece it holds, and
every rank that holds a replica (along dp, along tp for a leaf tp does
not cut, every rank for a replicated leaf such as a norm) writes its
own copy. So each root holds everything its process needs, and JAX's
manager restores a step the port wrote at every process, as the port
restores JAX's. Restore reads this process's root only: it copies each
piece a sharded template leaf needs into its local tensor, one file at
a time, and a piece the root lacks raises JAX's ValueError ("no saved
shard for index ... sharding or process topology changed since the
save?"). A whole template leaf takes a leaf this root saved as shards
when its shards cover the array, as JAX's dense assembly does. A leaf
on a mesh of one rank is whole.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.observability import tracing
from kubeflow_tpu_torch.parallel.mesh import placement_of

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1
# Staging dirs start with "." so ``<step>``.isdigit() scans never see them;
# quarantine keeps the step number visible but breaks the match the same way.
_TMP_PREFIX = ".tmp-"
CORRUPT_PREFIX = "corrupt-"
# An emergency save must never block forever: with no grace budget given,
# draining in-flight async saves is still bounded by this.
_DEFAULT_EMERGENCY_DRAIN_S = 30.0


class CorruptCheckpointError(Exception):
    """A committed step directory failed manifest validation."""


def process_identity_from_env(env: Optional[dict] = None) -> tuple:
    """(process_index, process_count) from the webhook's env contract, via
    the parser ``bootstrap`` uses. Touches no device and no process
    group, so constructing a manager never does.

    The port drives one card a process, so on a host of several cards the
    pod's env names the host, not the rank: every card's process would
    read the same ``proc<host>/`` root. There it raises ValueError; pass
    the rank ``bootstrap`` returned (``process_index=rt.rank,
    process_count=rt.world_size``)."""
    from kubeflow_tpu_torch.runtime.bootstrap import runtime_from_env

    rt = runtime_from_env(env)
    if rt.cards_per_host > 1:
        raise ValueError(
            f"this host has {rt.cards_per_host} cards and the port drives "
            "one a process, so the env alone does not say which rank this "
            "is: construct the CheckpointManager with process_index="
            "rt.rank, process_count=rt.world_size of bootstrap(local_rank"
            "=...)")
    return rt.process_id, rt.num_workers


class CheckpointIO:
    """The file-IO seam of the commit protocol. Durability ordering: file
    bytes fsynced → manifest fsynced → staging dir fsynced → rename →
    parent dir fsynced."""

    def write_file(self, path: Path, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def fsync_dir(self, path: Path) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def commit(self, staged: Path, final: Path) -> None:
        """Atomically publish ``staged`` as ``final``: the one place this
        module renames."""
        self.fsync_dir(staged)
        os.replace(staged, final)
        self.fsync_dir(final.parent)


# -- the state tree ----------------------------------------------------------


def flatten_state(state: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """[(path, tensor), ...] in the order stated in the module docstring.
    The tensors are the state's own (views of parameters, the optimizer's
    live moments), so writing into them writes the state."""
    if isinstance(state, torch.Tensor):
        return [(prefix, state)]
    if isinstance(state, dict):
        return [leaf for key in sorted(state)
                for leaf in flatten_state(state[key], f"{prefix}['{key}']")]
    if isinstance(state, nn.Module):
        return [(f"{prefix}['{name}']", t)
                for name, t in state.state_dict(keep_vars=True).items()]
    if isinstance(state, torch.optim.Optimizer):
        params = [p for group in state.param_groups for p in group["params"]]
        return [(f"{prefix}[{i}]['{key}']", state.state[p][key])
                for i, p in enumerate(params)
                for key in sorted(state.state.get(p, {}))]
    raise TypeError(f"{prefix or 'state'}: cannot checkpoint a "
                    f"{type(state).__name__}")


def _shard_of(t: torch.Tensor) -> Optional[tuple]:
    """(global shape, this process's index, the piece) of a leaf laid out
    over several processes; None for a whole leaf. A ``Placement`` over a
    mesh of one rank is whole; a ``DTensor`` always spans processes (its
    piece by its mesh coordinate)."""
    pl = placement_of(t)
    if pl is not None:
        if not pl.spans_processes:
            return None
        return pl.global_shape, pl.index(), t
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:
        return None
    if not isinstance(t, DTensor):
        return None
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    index = tuple((int(o), int(o) + int(n)) for o, n in zip(offset, shape))
    return tuple(t.shape), index, t.to_local()


def _snapshot_leaf(t: torch.Tensor, shard: Optional[tuple]):
    """A host copy of a whole leaf; for a sharded one, JAX's payload of a
    process's shards: ``{"global_shape", "shards": [(index, copy)]}``."""
    if shard is None:
        return t.detach().to("cpu", copy=True)
    global_shape, index, piece = shard
    return {"global_shape": global_shape,
            "shards": [(index, piece.detach().to("cpu", copy=True))]}


def _leaf_bytes(t: torch.Tensor) -> tuple[str, bytes]:
    """(dtype name, raw bytes) of a CPU tensor."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.reshape(-1).view(torch.uint8).numpy().tobytes()
    arr = t.numpy()
    return arr.dtype.name, arr.tobytes()


def _leaf_from_bytes(data: bytes, dtype: str, shape: list) -> torch.Tensor:
    """A CPU tensor from a manifest entry's bytes; CorruptCheckpointError
    when the name is unknown or the size does not fit the shape."""
    try:
        if dtype == "bfloat16":
            flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
            return flat.view(torch.bfloat16).reshape(shape)
        arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    except (TypeError, ValueError, RuntimeError) as err:
        raise CorruptCheckpointError(f"{dtype} {shape}: {err}") from err
    return torch.from_numpy(arr.copy())


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty((), dtype=t.dtype).numpy().dtype.name


# -- the manager -------------------------------------------------------------


class CheckpointManager:
    """Durable checkpoint policy: atomic saves, validated restores.

    - ``save(step, state)`` copies the state to host memory (so the caller
      may go on updating it in place), records that snapshot as the
      pending one, honours ``save_interval_steps`` (returns whether a save
      happened; the first call always commits, so a short run is never
      checkpoint-less) and keeps ``max_to_keep`` checkpoints. With
      ``async_save=True`` a worker thread writes the snapshot; ``wait()``
      joins it.
    - Save failures with an ``OSError`` (disk full, quota) are contained:
      the staging dir is removed, ``save_failures``/``last_save_error``
      record it, and the previous committed step stays valid.
    - ``emergency_save(grace_s)`` is the preemption path: one synchronous
      save of the pending snapshot, skipped when already committed or when
      it cannot finish inside the grace budget.
    - ``restore_latest(template)`` copies the newest step that validates
      into ``template``'s tensors and returns ``(template, step)``, or
      ``(template, None)`` when no step validates.
    - Several processes: each owns ``<directory>/proc<k>/``; saves and
      quarantines touch only its own root, while ``latest_step`` and
      ``restore_latest`` consider only steps present in every process's
      root.
    """

    def __init__(
        self,
        directory: str | Path,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
        async_save: bool = False,
        metrics: Any = None,
        io: Optional[CheckpointIO] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        env: Optional[dict] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        # Every budget and freshness figure reads THIS clock (monotonic by
        # default): preemptions coincide with wall-clock steps on the host,
        # and a backwards jump mid-grace would start a save SIGKILL tears.
        self._clock = clock or time.monotonic
        self.directory = Path(directory).absolute()
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.io = io or CheckpointIO()
        self.metrics = metrics
        if process_index is None or process_count is None:
            env_index, env_count = process_identity_from_env(env)
            process_index = env_index if process_index is None else process_index
            process_count = env_count if process_count is None else process_count
        self.directory.mkdir(parents=True, exist_ok=True)
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {self.process_index} not in "
                             f"[0, {self.process_count})")
        self._root = (self.directory if self.process_count == 1
                      else self.directory / f"proc{self.process_index}")
        self._root.mkdir(parents=True, exist_ok=True)
        # Metadata dict of the step restore_latest() last returned.
        self.restored_metadata: dict = {}
        self.last_save_error: Optional[BaseException] = None
        self.save_failures = 0
        # _lock serializes whole checkpoint writes (the emergency path
        # takes it with a timeout). _seq_lock guards the staging-name
        # counter and the save-outcome state, always taken after _lock and
        # never around I/O.
        self._lock = threading.RLock()
        self._seq_lock = threading.Lock()
        self._seq = 0
        self._last_saved_step: Optional[int] = None  # interval gate
        self._last_committed_step: Optional[int] = self.latest_step()
        self._last_save_duration: Optional[float] = None
        # Clock instant of the last commit (or validating restore) THIS
        # process made; None for a step inherited from disk, whose age the
        # clock cannot vouch for (last_commit_age() says +inf).
        self._last_commit_at: Optional[float] = None
        # Newest (step, host snapshot, metadata) handed to save(),
        # committed or not: what emergency_save flushes.
        self._pending: Optional[tuple] = None
        self._async = bool(async_save)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, force: bool = False,
             metadata: Optional[dict] = None) -> bool:
        """Persist ``state`` as ``step`` per policy; returns whether a save
        was enqueued (async) or durably committed (sync). Every call copies
        the leaves to host memory and records the copy for
        ``emergency_save``, even one the interval skips: the state is
        updated in place, so a reference to the live tensors would flush a
        state torn by the next optimizer step."""
        step = int(step)
        meta = dict(metadata or {})
        leaves = [(path, t, _shard_of(t)) for path, t in flatten_state(state)]
        spanning = [path for path, _, shard in leaves if shard is not None]
        if spanning and self.process_count == 1:
            raise RuntimeError(
                f"state leaf {spanning[0]} is sharded over other "
                "processes, but this CheckpointManager believes it is the "
                "only process. Construct it with process_index=rank, "
                "process_count=world size (the webhook's env contract fills "
                "these automatically in notebook pods) so that every host "
                "saves its own shards instead of attempting a cross-host "
                "gather.")
        snapshot = [(path, _snapshot_leaf(t, shard))
                    for path, t, shard in leaves]
        # The newest state, even when the interval skips it: an emergency
        # save flushes what training last produced.
        self._pending = (step, snapshot, meta)
        if (not force and self._last_saved_step is not None
                and step % self.save_interval_steps != 0):
            return False
        self._last_saved_step = step
        if self._async:
            self._ensure_worker()
            self._queue.put((step, snapshot, meta))
            return True
        with self._lock:
            return self._write_step(step, snapshot, meta)

    def emergency_save(self, grace_s: Optional[float] = None) -> bool:
        """One final synchronous save inside a termination grace budget,
        traced as ``checkpoint.emergency_save``."""
        with tracing.get_tracer("checkpoint").start_span(
            "checkpoint.emergency_save",
            **({"grace_s": grace_s} if grace_s is not None else {}),
        ) as span:
            ok = self._emergency_save(grace_s)
            span.set_attribute("committed", ok)
            return ok

    def _emergency_save(self, grace_s: Optional[float] = None) -> bool:
        """Returns True only if a new step was durably committed. Skips
        when nothing is newer than the last committed step, or when
        ``grace_s`` minus the time spent draining in-flight saves is
        smaller than the last save's duration.

        Every blocking step is time-bounded (the drain of async saves, the
        write lock): this runs on the exit path, possibly while the thread
        the signal interrupted holds the queue mutex or the write lock.
        The pending snapshot supersedes anything still queued, so giving up
        on the drain loses nothing. Nothing here touches a device: the
        snapshot is host memory."""
        t0 = self._clock()
        if grace_s is None:
            drain_timeout = _DEFAULT_EMERGENCY_DRAIN_S
        else:
            reserve = (self._last_save_duration or 0.0) + 1.0
            drain_timeout = max(
                0.0, min(float(grace_s) - reserve, float(grace_s) / 2))
        if not self.wait(timeout=drain_timeout):
            log.error("emergency save: pending async saves did not drain "
                      "within %.1fs; writing the newest snapshot anyway",
                      drain_timeout)
        pending = self._pending
        if pending is None:
            log.info("emergency save: no state has been handed to save()")
            return False
        step, snapshot, meta = pending
        if self._last_committed_step == step:
            log.info("emergency save: step %d already durably committed; "
                     "skipping", step)
            return False
        if grace_s is not None:
            remaining = float(grace_s) - (self._clock() - t0)
            estimate = self._last_save_duration
            if remaining <= 0 or (estimate is not None
                                  and estimate > remaining):
                log.error(
                    "emergency save: skipping step %d — estimated save "
                    "duration %s exceeds remaining grace budget %.2fs", step,
                    f"{estimate:.2f}s" if estimate is not None else "unknown",
                    max(0.0, remaining))
                return False
            lock_timeout = max(0.0, float(grace_s) - (self._clock() - t0))
        else:
            lock_timeout = _DEFAULT_EMERGENCY_DRAIN_S
        locked = self._lock.acquire(timeout=lock_timeout)
        if not locked:
            # The holder is frozen (likely the thread this signal
            # interrupted). Writing anyway is safe: staging names are
            # uniquified under _seq_lock.
            log.error("emergency save: write lock not acquired within "
                      "%.1fs; writing without it", lock_timeout)
        try:
            ok = self._write_step(step, snapshot, meta)
        finally:
            if locked:
                self._lock.release()
        if ok:
            self._last_saved_step = step
            counter = getattr(self.metrics, "checkpoint_emergency_total", None)
            if counter is not None:
                counter.inc()
            log.warning("emergency save: committed step %d in %.2fs", step,
                        self._clock() - t0)
        return ok

    def _write_step(self, step: int, snapshot: list, meta: dict) -> bool:
        with tracing.get_tracer("checkpoint").start_span(
            "checkpoint.write", step=step,
        ) as span:
            ok = self._write_step_inner(step, snapshot, meta)
            span.set_attribute("committed", ok)
            return ok

    def _write_step_inner(self, step: int, snapshot: list,
                          meta: dict) -> bool:
        """The atomic commit protocol; returns whether ``step`` committed.
        An OSError is contained and its staging dir removed; anything else
        propagates and leaves the staging dir, invisible to restore."""
        t0 = self._clock()
        final = self._root / str(step)
        with self._seq_lock:
            self._seq += 1
            staged = self._root / (
                f"{_TMP_PREFIX}{step}-{os.getpid()}-{self._seq}")
        try:
            if staged.exists():
                shutil.rmtree(staged)
            staged.mkdir(parents=True)
            files = []
            for i, (path, t) in enumerate(snapshot):
                if isinstance(t, dict):  # this process's pieces
                    pieces = [(f"{i:05d}.s{j}.bin", arr, {
                        "index": [list(p) for p in index],
                        "global_shape": list(t["global_shape"])})
                        for j, (index, arr) in enumerate(t["shards"])]
                else:
                    pieces = [(f"{i:05d}.bin", t, None)]
                for name, arr, shard in pieces:
                    dtype, data = _leaf_bytes(arr)
                    self.io.write_file(staged / name, data)
                    entry = {"name": name, "path": path, "dtype": dtype,
                             "shape": list(arr.shape), "size": len(data),
                             "crc32": zlib.crc32(data) & 0xFFFFFFFF}
                    if shard is not None:
                        entry["shard"] = shard
                    files.append(entry)
            manifest = {"format": MANIFEST_FORMAT, "step": step,
                        "metadata": meta,
                        "process": {"index": self.process_index,
                                    "count": self.process_count},
                        "files": files}
            # Written last: its presence certifies every data file above.
            self.io.write_file(staged / MANIFEST_NAME,
                               json.dumps(manifest, sort_keys=True).encode())
            if final.exists():  # re-saving a step
                shutil.rmtree(final)
            self.io.commit(staged, final)
        except OSError as err:
            with self._seq_lock:
                self.last_save_error = err
                self.save_failures += 1
            log.error("checkpoint save of step %d failed: %s", step, err)
            shutil.rmtree(staged, ignore_errors=True)
            return False
        duration = self._clock() - t0
        with self._seq_lock:
            self._last_save_duration = duration
            self._last_committed_step = step
            self._last_commit_at = self._clock()
        hist = getattr(self.metrics, "checkpoint_save_seconds", None)
        if hist is not None:
            hist.observe(duration)
        log.info("checkpoint step %d committed in %.3fs", step, duration)
        self._prune()
        return True

    def _prune(self) -> None:
        for s in self._local_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._root / str(s), ignore_errors=True)

    # -- async worker --------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is not None and not self._worker.is_alive():
            log.error("checkpoint worker thread died; restarting it")
            self._worker = None
        if self._worker is None:
            if self._queue is None:
                self._queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._drain, name="checkpoint-save", daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, snapshot, meta = item
                try:
                    with self._lock:
                        self._write_step(step, snapshot, meta)
                except BaseException as err:
                    # _write_step contains OSError itself; anything else
                    # (unserializable metadata, MemoryError) must not kill
                    # the worker and wedge every later wait() — record it,
                    # keep draining.
                    with self._seq_lock:
                        self.last_save_error = err
                        self.save_failures += 1
                    log.exception("async checkpoint save of step %d failed",
                                  step)
            finally:
                self._queue.task_done()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued async save has committed or failed;
        returns whether the queue fully drained (False at once when the
        worker died with saves queued). A ``timeout`` bounds the wait,
        the acquisition of the queue's lock included, so a caller on the
        signal path (which may have interrupted a thread inside the
        queue's mutex) cannot deadlock."""
        q = self._queue
        if q is None:
            return True
        worker = self._worker
        if worker is not None and not worker.is_alive() and q.unfinished_tasks:
            log.error("checkpoint worker thread is dead with %d saves queued",
                      q.unfinished_tasks)
            return False
        if timeout is None:
            q.join()
            return True
        deadline = self._clock() + timeout
        if not q.all_tasks_done.acquire(timeout=timeout):
            return False
        try:
            while q.unfinished_tasks:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    return False
                q.all_tasks_done.wait(remaining)
            return True
        finally:
            q.all_tasks_done.release()

    def close(self) -> None:
        self.wait()
        if self._worker is not None:
            if self._worker.is_alive():
                self._queue.put(None)
            self._worker.join()
            self._worker = None
            self._queue = None

    # -- restore -------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """Newest restorable step: a manifest in this process's root and
        in every other process's (validated only at restore)."""
        steps = self._committed_steps()
        return steps[-1] if steps else None

    def last_commit_age(self) -> float:
        """Seconds on the injected clock since THIS process last committed
        (or restored) a step; +inf when it has not, since a step inherited
        on disk has only wall-time mtimes."""
        with self._seq_lock:
            last = self._last_commit_at
        if last is None:
            return float("inf")
        return max(0.0, self._clock() - last)

    def _local_steps(self) -> list:
        return sorted(
            int(p.name) for p in self._root.iterdir()
            if p.is_dir() and p.name.isdigit() and (p / MANIFEST_NAME).exists()
        )

    def _committed_steps(self) -> list:
        """Locally committed steps that every peer root holds too: a step
        a dead host never committed is not a checkpoint."""
        steps = self._local_steps()
        if self.process_count == 1:
            return steps
        return [s for s in steps if self._peers_committed(s)]

    def _peers_committed(self, step: int) -> bool:
        return all(
            (self.directory / f"proc{j}" / str(step) / MANIFEST_NAME).exists()
            for j in range(self.process_count) if j != self.process_index)

    def restore_latest(self, template: Any) -> tuple:
        """(template, step): the newest step that validates (and that every
        process committed), copied into ``template``'s tensors, or
        (template, None) untouched. Steps failing validation are
        quarantined as ``corrupt-<step>-*`` (never deleted) and the walk
        falls back to the next newest. A template of another structure,
        or a sharded leaf whose piece this root does not hold (another
        mesh, another process count), raises ValueError and quarantines
        nothing. The restored step's metadata lands in
        ``self.restored_metadata``. Traced as ``checkpoint.restore``."""
        with tracing.get_tracer("checkpoint").start_span(
            "checkpoint.restore",
        ) as span:
            state, step = self._restore_latest(template)
            span.set_attribute("restored_step", step)
            return state, step

    def _restore_latest(self, template: Any) -> tuple:
        self.restored_metadata = {}
        candidates = sorted(
            (int(p.name) for p in self._root.iterdir()
             if p.is_dir() and p.name.isdigit()),
            reverse=True,
        )
        leaves = flatten_state(template)
        for step in candidates:
            if self.process_count > 1 and not self._peers_committed(step):
                continue
            step_dir = self._root / str(step)
            try:
                entries, meta = _load_validated(step_dir)
                _copy_into(_match_template(leaves, entries, step_dir),
                           step_dir)
            except CorruptCheckpointError as err:
                self._quarantine(step_dir, step, err)
                continue
            self.restored_metadata = meta
            with self._seq_lock:
                self._last_committed_step = step
                # A restore just validated these bytes: as fresh as a
                # commit made now.
                self._last_commit_at = self._clock()
            return template, step
        return template, None

    def _quarantine(self, step_dir: Path, step: int,
                    err: CorruptCheckpointError) -> None:
        while True:
            with self._seq_lock:
                self._seq += 1
                dest = self._root / f"{CORRUPT_PREFIX}{step}-{self._seq}"
            if not dest.exists():
                break
        log.error("checkpoint step %d failed validation (%s); quarantined "
                  "as %s", step, err, dest.name)
        self.io.commit(step_dir, dest)
        counter = getattr(self.metrics, "checkpoint_corrupt_total", None)
        if counter is not None:
            counter.inc()


def _read_checked(step_dir: Path, entry: dict) -> bytes:
    try:
        data = (step_dir / entry["name"]).read_bytes()
    except OSError as err:
        raise CorruptCheckpointError(
            f"{entry['name']} unreadable: {err}") from err
    if len(data) != entry["size"]:
        raise CorruptCheckpointError(
            f"{entry['name']}: size {len(data)} != manifest {entry['size']}")
    if (zlib.crc32(data) & 0xFFFFFFFF) != entry["crc32"]:
        raise CorruptCheckpointError(f"{entry['name']}: CRC32 mismatch")
    return data


def _read_manifest(step_dir: Path) -> dict:
    manifest_path = step_dir / MANIFEST_NAME
    if not manifest_path.exists():
        raise CorruptCheckpointError("manifest missing")
    try:
        manifest = json.loads(manifest_path.read_text())
    except (OSError, ValueError) as err:
        raise CorruptCheckpointError(f"manifest unreadable: {err}") from err
    if manifest.get("format") != MANIFEST_FORMAT:
        raise CorruptCheckpointError(
            f"unknown manifest format {manifest.get('format')!r}")
    return manifest


def _load_validated(step_dir: Path) -> tuple[list, dict]:
    """(manifest file entries, metadata) of a committed step, every file's
    size, CRC32, dtype and shape verified — one file in memory at a time.
    Raises CorruptCheckpointError on any mismatch: a checkpoint is valid
    entirely or not at all. A shard entry is one process's piece of a
    leaf (JAX's format), validated as any file."""
    manifest = _read_manifest(step_dir)
    entries = manifest.get("files", [])
    for entry in entries:
        _leaf_from_bytes(_read_checked(step_dir, entry), entry["dtype"],
                         entry["shape"])
    return entries, dict(manifest.get("metadata", {}))


def _index(shard: dict) -> tuple:
    return tuple((int(a), int(b)) for a, b in shard["index"])


def _match_template(leaves: list, entries: list, step_dir: Path) -> list:
    """What to copy into each template tensor: ``[(tensor, [(entry, the
    tensor's region, the file's region)])]``, one file a piece. A
    template of another structure is the caller's error, not corruption:
    ValueError, before any copy, as is a sharded template leaf whose piece
    this root did not save, or a whole one its shards do not cover."""
    whole = {e["path"]: e for e in entries if "shard" not in e}
    shards: dict = {}
    for e in entries:
        if "shard" in e:
            shards.setdefault(e["path"], {})[_index(e["shard"])] = e
    saved = list(dict.fromkeys(e["path"] for e in entries))
    if len(leaves) != len(saved):
        raise ValueError(
            f"template has {len(leaves)} leaves but checkpoint "
            f"{step_dir.name} stored {len(saved)} — restoring into a "
            "different model/optimizer structure?")
    copies = []
    for path, t in leaves:
        # By path: a step another package wrote may order its leaves
        # otherwise (JAX sorts a dict's keys; a module keeps its own).
        if path not in whole and path not in shards:
            raise ValueError(
                f"template leaf {path} does not match a checkpoint leaf "
                f"in {step_dir.name} (stored: {saved[:4]}...)")
        shard = _shard_of(t)
        dest = t if shard is None else shard[2]
        global_shape = tuple(t.shape) if shard is None else shard[0]
        some = whole.get(path) or next(iter(shards[path].values()))
        shape = some["shard"]["global_shape"] if "shard" in some \
            else some["shape"]
        if (list(global_shape) != list(shape)
                or _dtype_name(dest) != some["dtype"]):
            raise ValueError(
                f"template leaf {path} {list(global_shape)} "
                f"{_dtype_name(dest)} does not match checkpoint leaf "
                f"{some['path']} {shape} {some['dtype']} in {step_dir.name}")
        want = (tuple((0, n) for n in global_shape) if shard is None
                else shard[1])
        local = tuple(slice(None) for _ in global_shape)
        if path in whole:
            region = tuple(slice(a, b) for a, b in want)
            copies.append((dest, [(whole[path], local, region)]))
        elif shard is not None:
            found = shards[path].get(want)
            if found is None:
                raise ValueError(
                    f"checkpoint {step_dir.name} leaf {path}: no saved "
                    f"shard for index {want} — sharding or process "
                    "topology changed since the save?")
            copies.append((dest, [(found, local, local)]))
        else:
            # A whole template leaf from this root's shards (JAX's dense
            # assembly): they must cover the array.
            seen = torch.zeros(global_shape, dtype=torch.bool)
            pieces = []
            for index, e in shards[path].items():
                region = tuple(slice(a, b) for a, b in index)
                seen[region] = True
                pieces.append((e, region, local))
            if not bool(seen.all()):
                raise ValueError(
                    f"checkpoint {step_dir.name} leaf {path}: this "
                    "process's shards do not cover the whole array; "
                    "restore into a template carrying the original "
                    "sharding")
            copies.append((dest, pieces))
    return copies


@torch.no_grad()
def _copy_into(copies: list, step_dir: Path) -> None:
    """Copy each validated file into its template tensor's region, one
    file at a time. The files are read again (so only one is in host
    memory at once) and re-checked: a file that changed since validation
    raises CorruptCheckpointError, and the walk's fallback overwrites
    every leaf."""
    for dest, pieces in copies:
        for entry, region, source in pieces:
            data = _read_checked(step_dir, entry)
            value = _leaf_from_bytes(data, entry["dtype"], entry["shape"])
            dest[region].copy_(value[source])


# -- training loop -----------------------------------------------------------


def resume_start_batch(ckpt: CheckpointManager, restored_step=None) -> int:
    """The loader cursor to hand ``sharded_loader(start_batch=...)`` after
    ``restore_latest``: the ``start_batch`` the restored step's save
    recorded, else the restored step itself (one batch per step)."""
    value = ckpt.restored_metadata.get("start_batch")
    if value is not None:
        return int(value)
    return int(restored_step or 0)


def train_with_checkpointing(step_fn, state: Any, batches,
                             ckpt: CheckpointManager,
                             start_step: int = 0) -> tuple:
    """Drive ``state, loss = step_fn(state, batch)`` over ``batches``,
    checkpointing per the manager's policy. Returns (state, losses).

    Resumable exactly: each save carries ``{"start_batch": step}``; feed
    ``resume_start_batch(ckpt, at)`` to ``sharded_loader(start_batch=...)``
    and pass ``start_step=at``. ``ckpt.wait()`` runs in a finally, so an
    exception mid-loop does not strand enqueued async saves."""
    losses = []
    step = start_step
    try:
        for batch in batches:
            state, loss = step_fn(state, batch)
            losses.append(loss)
            step += 1
            ckpt.save(step, state, metadata={"start_batch": step})
    finally:
        ckpt.wait()
    if losses and getattr(losses[-1], "is_cuda", False):
        torch.cuda.synchronize(losses[-1].device)
    return state, losses
