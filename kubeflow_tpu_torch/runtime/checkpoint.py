"""Crash-safe checkpointing of a torch training state on one process.

The single-process subset of ``kubeflow_tpu/runtime/checkpoint.py``, on
the same on-disk format, so either package's manager validates and reads
a step directory the other wrote:

- **Atomic commit.** Each step is written into a ``.tmp-*`` staging dir:
  one ``NNNNN.bin`` per leaf (its raw bytes) and, last, ``manifest.json``
  (``format`` 1, the step, the caller's metadata, and per file its leaf
  path, dtype name, shape, size and CRC32). Every file is fsynced, then
  the staging dir, then ``CheckpointIO.commit`` renames it to ``<step>/``
  (the one rename) and fsyncs the parent. A process killed mid-save
  leaves a ``.tmp-*`` dir that restore never looks at.
- **Validated restore with quarantine.** ``restore_latest`` walks
  committed steps newest first, re-verifies each file's size and CRC32,
  moves a step that fails aside as ``corrupt-<step>-*`` and falls back to
  the next newest.
- **Exact resume.** ``train_with_checkpointing`` records the loader cursor
  (``{"start_batch": step}``) in each save's metadata;
  ``resume_start_batch`` reads it back for
  ``data.loader.sharded_loader(start_batch=...)``.

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

Not ported (ROADMAP queue 1 item 14): the emergency save and its SIGTERM
handler, multi-process ``proc<k>/`` roots and sharded leaves, and the
tracing spans and metrics hooks.
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
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1
# Staging dirs start with "." so ``<step>``.isdigit() scans never see them;
# quarantine keeps the step number visible but breaks the match the same way.
_TMP_PREFIX = ".tmp-"
CORRUPT_PREFIX = "corrupt-"


class CorruptCheckpointError(Exception):
    """A committed step directory failed manifest validation."""


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
    """Durable checkpoint policy on one process: atomic saves, validated
    restores.

    - ``save(step, state)`` honors ``save_interval_steps`` (returns whether
      a save happened; the first call always commits, so a short run is
      never checkpoint-less) and keeps ``max_to_keep`` checkpoints. With
      ``async_save=True`` the state is copied to host memory before
      ``save`` returns and written by a worker thread; ``wait()`` joins it.
    - Save failures with an ``OSError`` (disk full, quota) are contained:
      the staging dir is removed, ``save_failures``/``last_save_error``
      record it, and the previous committed step stays valid.
    - ``restore_latest(template)`` copies the newest step that validates
      into ``template``'s tensors and returns ``(template, step)``, or
      ``(template, None)`` when no step validates.
    """

    def __init__(self, directory: str | Path, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = False,
                 io: Optional[CheckpointIO] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max(1, int(max_to_keep))
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.io = io or CheckpointIO()
        # Metadata dict of the step restore_latest() last returned.
        self.restored_metadata: dict = {}
        self.last_save_error: Optional[BaseException] = None
        self.save_failures = 0
        # _lock serializes whole checkpoint writes; _seq_lock guards the
        # staging-name counter and the save-outcome state, always taken
        # after _lock and never around I/O.
        self._lock = threading.RLock()
        self._seq_lock = threading.Lock()
        self._seq = 0
        self._last_saved_step: Optional[int] = None  # interval gate
        self._last_committed_step: Optional[int] = self.latest_step()
        self._async = bool(async_save)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, force: bool = False,
             metadata: Optional[dict] = None) -> bool:
        """Persist ``state`` as ``step`` per policy; returns whether a save
        was enqueued (async) or durably committed (sync). The leaves are
        copied to host memory before this returns, so the caller may go
        on updating the state in place."""
        step = int(step)
        if (not force and self._last_saved_step is not None
                and step % self.save_interval_steps != 0):
            return False
        meta = dict(metadata or {})
        snapshot = [(path, t.detach().to("cpu", copy=True))
                    for path, t in flatten_state(state)]
        self._last_saved_step = step
        if self._async:
            self._ensure_worker()
            self._queue.put((step, snapshot, meta))
            return True
        with self._lock:
            return self._write_step(step, snapshot, meta)

    def _write_step(self, step: int, snapshot: list, meta: dict) -> bool:
        """The atomic commit protocol; returns whether ``step`` committed.
        An OSError is contained and its staging dir removed; anything else
        propagates and leaves the staging dir, invisible to restore."""
        t0 = time.monotonic()
        final = self.directory / str(step)
        with self._seq_lock:
            self._seq += 1
            staged = self.directory / (
                f"{_TMP_PREFIX}{step}-{os.getpid()}-{self._seq}")
        try:
            if staged.exists():
                shutil.rmtree(staged)
            staged.mkdir(parents=True)
            files = []
            for i, (path, t) in enumerate(snapshot):
                name = f"{i:05d}.bin"
                dtype, data = _leaf_bytes(t)
                self.io.write_file(staged / name, data)
                files.append({"name": name, "path": path, "dtype": dtype,
                              "shape": list(t.shape), "size": len(data),
                              "crc32": zlib.crc32(data) & 0xFFFFFFFF})
            manifest = {"format": MANIFEST_FORMAT, "step": step,
                        "metadata": meta,
                        "process": {"index": 0, "count": 1}, "files": files}
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
        with self._seq_lock:
            self._last_committed_step = step
        log.info("checkpoint step %d committed in %.3fs", step,
                 time.monotonic() - t0)
        self._prune()
        return True

    def _prune(self) -> None:
        for s in self._local_steps()[: -self.max_to_keep]:
            shutil.rmtree(self.directory / str(s), ignore_errors=True)

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
                except Exception as err:
                    # _write_step contains OSError itself; anything else
                    # (unserializable metadata) must not kill the worker and
                    # wedge every later wait() — record it, keep draining.
                    with self._seq_lock:
                        self.last_save_error = err
                        self.save_failures += 1
                    log.exception("async checkpoint save of step %d failed",
                                  step)
            finally:
                self._queue.task_done()

    def wait(self) -> bool:
        """Block until every enqueued async save has committed or failed;
        returns False only when the worker died with saves queued."""
        q = self._queue
        if q is None:
            return True
        worker = self._worker
        if worker is not None and not worker.is_alive() and q.unfinished_tasks:
            log.error("checkpoint worker thread is dead with %d saves queued",
                      q.unfinished_tasks)
            return False
        q.join()
        return True

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
        """Newest step with a manifest (validated only at restore)."""
        steps = self._local_steps()
        return steps[-1] if steps else None

    def _local_steps(self) -> list:
        return sorted(
            int(p.name) for p in self.directory.iterdir()
            if p.is_dir() and p.name.isdigit() and (p / MANIFEST_NAME).exists()
        )

    def restore_latest(self, template: Any) -> tuple:
        """(template, step): the newest step that validates, copied into
        ``template``'s tensors, or (template, None) untouched. Steps failing
        validation are quarantined as ``corrupt-<step>-*`` (never deleted)
        and the walk falls back to the next newest. A template of another
        structure raises ValueError and quarantines nothing. The restored
        step's metadata lands in ``self.restored_metadata``."""
        self.restored_metadata = {}
        candidates = sorted(
            (int(p.name) for p in self.directory.iterdir()
             if p.is_dir() and p.name.isdigit()),
            reverse=True,
        )
        leaves = flatten_state(template)
        for step in candidates:
            step_dir = self.directory / str(step)
            try:
                entries, meta = _load_validated(step_dir)
                _check_template(leaves, entries, step_dir)
                _copy_into(leaves, entries, step_dir)
            except CorruptCheckpointError as err:
                self._quarantine(step_dir, step, err)
                continue
            self.restored_metadata = meta
            with self._seq_lock:
                self._last_committed_step = step
            return template, step
        return template, None

    def _quarantine(self, step_dir: Path, step: int,
                    err: CorruptCheckpointError) -> None:
        while True:
            with self._seq_lock:
                self._seq += 1
                dest = self.directory / f"{CORRUPT_PREFIX}{step}-{self._seq}"
            if not dest.exists():
                break
        log.error("checkpoint step %d failed validation (%s); quarantined "
                  "as %s", step, err, dest.name)
        self.io.commit(step_dir, dest)


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


def _load_validated(step_dir: Path) -> tuple[list, dict]:
    """(manifest file entries, metadata) of a committed step, every file's
    size, CRC32, dtype and shape verified — one file in memory at a time.
    Raises CorruptCheckpointError on any mismatch: a checkpoint is valid
    entirely or not at all."""
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
    entries = manifest.get("files", [])
    for entry in entries:
        if "shard" in entry:
            raise CorruptCheckpointError(
                f"{entry['name']}: a multi-process shard; this manager reads "
                "single-process steps only")
        _leaf_from_bytes(_read_checked(step_dir, entry), entry["dtype"],
                         entry["shape"])
    return entries, dict(manifest.get("metadata", {}))


def _check_template(leaves: list, entries: list, step_dir: Path) -> None:
    """A template of another structure is the caller's error, not
    corruption: ValueError."""
    if len(leaves) != len(entries):
        raise ValueError(
            f"template has {len(leaves)} leaves but checkpoint "
            f"{step_dir.name} stored {len(entries)} — restoring into a "
            "different model/optimizer structure?")
    for (path, t), entry in zip(leaves, entries):
        if (path != entry["path"] or list(t.shape) != entry["shape"]
                or _dtype_name(t) != entry["dtype"]):
            raise ValueError(
                f"template leaf {path} {list(t.shape)} {_dtype_name(t)} does "
                f"not match checkpoint leaf {entry['path']} {entry['shape']} "
                f"{entry['dtype']} in {step_dir.name}")


@torch.no_grad()
def _copy_into(leaves: list, entries: list, step_dir: Path) -> None:
    """Copy each validated file into its template tensor, one at a time.
    The files are read again (so only one is in host memory at once) and
    re-checked: a file that changed since validation raises
    CorruptCheckpointError, and the walk's fallback overwrites every leaf."""
    for (_, t), entry in zip(leaves, entries):
        value = _leaf_from_bytes(_read_checked(step_dir, entry),
                                 entry["dtype"], entry["shape"])
        t.copy_(value)


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
    if losses and losses[-1].is_cuda:
        torch.cuda.synchronize(losses[-1].device)
    return state, losses
