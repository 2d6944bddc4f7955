"""Profiling helpers over ``torch.profiler``.

Counterpart of ``kubeflow_tpu/observability/profiling.py``: capture a
trace around a few steps, write it where a notebook can open it, and label
steps so the trace shows model steps instead of anonymous kernels.

    from kubeflow_tpu_torch.observability.profiling import trace
    with trace("/home/jovyan/profiles", "train"):
        for _ in range(3):
            loss = step(batch)
    # → open /home/jovyan/profiles/train/trace.json in Perfetto or
    #   chrome://tracing

The trace holds the host's operators and, where a card is present, every
CUDA kernel and copy of the process (CUPTI traces the whole process, so a
capture started on one thread sees kernels launched by any other).
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir, name: str = "trace") -> Iterator[pathlib.Path]:
    """Capture CPU and (with a card) CUDA activity for the enclosed block;
    writes a Chrome trace to ``log_dir/name/trace.json``. Yields the
    directory."""
    path = pathlib.Path(log_dir) / name
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(str(path / TRACE_FILE))


@contextlib.contextmanager
def step_annotation(name: str, step: Optional[int] = None) -> Iterator[None]:
    """Label the enclosed work in the trace (``record_function``; a step
    number is appended as ``name#step``)."""
    with torch.profiler.record_function(
            name if step is None else f"{name}#{step}"):
        yield


def _sync(value) -> None:
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


def timed_steps(step_fn, state, batches, sync_every: int = 1):
    """Drive ``state, loss = step_fn(state, batch)`` and return (state,
    per-step wall seconds). On a CUDA device the card is synchronized
    every ``sync_every`` steps, so the times measure the card's work and
    not the launches; the first entry includes any warm-up by design
    (report it apart or drop it)."""
    times = []
    loss = None
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        with step_annotation("train_step", step=i):
            state, loss = step_fn(state, batch)
        if (i + 1) % sync_every == 0:
            _sync(loss)
        times.append(time.perf_counter() - t0)
    if loss is not None and times:
        # Steps since the last sync may still run: charge their device
        # time to the last entry, so sum(times) covers all the work.
        t0 = time.perf_counter()
        _sync(loss)
        times[-1] += time.perf_counter() - t0
    return state, times
