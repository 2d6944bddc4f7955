"""The port's tracing, flight recorder and profiler wrapper against the JAX
package's, on the CPU.

The same inputs go through both: traceparent headers and trace ids made
from a seed, step durations fed in lockstep, injected clocks and trace
functions. Everything compared is exact (strings, verdicts, counters and
snapshots); the profiler only has to write a trace that holds the
annotated step.
"""

from __future__ import annotations

import contextlib
import json
import random
import threading
import time

import pytest
import torch

from kubeflow_tpu.observability import flight as JF
from kubeflow_tpu.observability import tracing as JT
from kubeflow_tpu_torch.observability import flight as TF
from kubeflow_tpu_torch.observability import profiling as TP
from kubeflow_tpu_torch.observability import tracing as TT


def _headers() -> list:
    rng = random.Random(0)
    hexes = [f"{rng.getrandbits(128):032x}" for _ in range(8)]
    spans = [f"{rng.getrandbits(64):016x}" for _ in range(8)]
    out = [f"00-{t}-{s}-{f}" for t, s, f in zip(hexes, spans,
                                                 ["01", "00"] * 4)]
    out += [
        None, "", "garbage", f"00-{hexes[0]}-{spans[0]}",
        f"01-{hexes[0]}-{spans[0]}-01", f"00-{'0' * 32}-{spans[0]}-01",
        f"00-{hexes[0]}-{'0' * 16}-01", f"  00-{hexes[1].upper()}-"
        f"{spans[1].upper()}-03  ", f"00-{hexes[2][:-1]}g-{spans[2]}-01",
        f"00-{hexes[3]}-{spans[3]}-ff",
    ]
    return out


@pytest.mark.parametrize("header", _headers())
def test_parse_traceparent_equals_jax(header):
    assert TT.parse_traceparent(header) == JT.parse_traceparent(header)


def test_format_traceparent_equals_jax():
    for cls_j, cls_t in ((JT.Span, TT.Span), (JT._NoopSpan, TT._NoopSpan)):
        for tid, sid in (("ab" * 16, "cd" * 8), ("", "")):
            assert TT.format_traceparent(cls_t(name="s", trace_id=tid,
                                               span_id=sid)) == \
                JT.format_traceparent(cls_j(name="s", trace_id=tid,
                                            span_id=sid))


def test_deterministic_sample_equals_jax():
    rng = random.Random(1)
    ids = [f"{rng.getrandbits(128):032x}" for _ in range(500)]
    for rate in (-1.0, 0.0, 0.001, 0.1, 0.25, 0.5, 0.9, 1.0, 2.0):
        assert [TT.deterministic_sample(t, rate) for t in ids] == \
            [JT.deterministic_sample(t, rate) for t in ids]


def test_span_tree_and_to_dict_keys_equal_jax():
    def run(mod):
        exp = mod.InMemoryExporter()
        mod.set_tracer_provider(mod.TracerProvider(exp))
        try:
            tracer = mod.get_tracer("t")
            with tracer.start_span("root", traceparent=f"00-{'ab' * 16}-"
                                   f"{'cd' * 8}-01", a=1) as root:
                cross = tracer.begin_span("cross", parent=root, b=2)
                with tracer.start_span("child") as child:
                    child.add_event("e", {"x": 1})
                cross.end()
                cross.end()  # idempotent
            with pytest.raises(ValueError):
                with tracer.start_span("failing"):
                    raise ValueError("boom")
        finally:
            mod.set_tracer_provider(mod.TracerProvider())
        by_id = {s.span_id: s.name for s in exp.spans}
        return [(s.name, by_id.get(s.parent_id, s.parent_id),
                 s.trace_id == "ab" * 16, len(s.trace_id),
                 sorted(s.attributes), [e["name"] for e in s.events],
                 s.status, s.status_message, sorted(s.to_dict()))
                for s in exp.spans]

    assert run(TT) == run(JT)


def test_noop_provider_and_ring_equal_jax():
    for mod in (JT, TT):
        assert not mod.enabled()
        assert mod.get_tracer("x").start_span("s") is mod._NOOP_SPAN
        assert mod.trace_ring() is None
        ring = mod.RingBufferExporter(capacity=2)
        for i in range(3):
            ring.export(mod.Span(name=f"s{i}"))
        assert [s["name"] for s in ring.snapshot()] == ["s1", "s2"]


@pytest.mark.parametrize("env", [
    {}, {"KUBEFLOW_TPU_TRACE_RING": "7"},
    {"KUBEFLOW_TPU_TRACE_SAMPLE": "0.5"},
    {"KUBEFLOW_TPU_TRACE_RING": "x"}, {"KUBEFLOW_TPU_TRACE_SAMPLE": "x"},
    {"KUBEFLOW_TPU_TRACE_EXPORT": "spans.jsonl",
     "KUBEFLOW_TPU_TRACE_RING": "3"},
])
def test_configure_from_env_equals_jax(monkeypatch, tmp_path, env):
    for name in ("KUBEFLOW_TPU_TRACE_RING", "KUBEFLOW_TPU_TRACE_SAMPLE",
                 "KUBEFLOW_TPU_TRACE_EXPORT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        if name == "KUBEFLOW_TPU_TRACE_EXPORT":
            value = str(tmp_path / value)
        monkeypatch.setenv(name, value)

    def run(mod):
        try:
            installed = mod.configure_from_env()
        except ValueError as err:
            return ("error", str(err))
        try:
            ring = mod.trace_ring()
            again = mod.configure_from_env()  # never replaces a provider
            with mod.get_tracer("t").start_span("s"):
                pass
            return (installed, again, None if ring is None else ring.capacity,
                    mod._provider.sample_rate,
                    [type(e).__name__ for e in mod._provider.exporters])
        finally:
            mod.set_tracer_provider(mod.TracerProvider())

    assert run(TT) == run(JT)
    if "KUBEFLOW_TPU_TRACE_EXPORT" in env:
        lines = (tmp_path / "spans.jsonl").read_text().splitlines()
        assert len(lines) == 2 and all(json.loads(x)["name"] == "s"
                                       for x in lines)


def _durations() -> list:
    rng = random.Random(2)
    out = [rng.uniform(0.9, 1.1) for _ in range(40)]
    out[20] = 50.0   # a stall once the window is warm
    out[5] = 50.0    # too early to count
    out += [rng.uniform(0.9, 1.1) for _ in range(300)]  # the window wraps
    out[300] = 30.0
    return out


def test_flight_recorder_in_lockstep_with_jax():
    now = [100.0]
    jf = JF.FlightRecorder(window=64, clock=lambda: now[0])
    tf = TF.FlightRecorder(window=64, clock=lambda: now[0])
    seen_j, seen_t = [], []
    jf.on_stall, tf.on_stall = seen_j.append, seen_t.append
    for i, d in enumerate(_durations()):
        now[0] += d
        fill = None if i % 3 else i / 400
        assert tf.record_step(d, fill) == jf.record_step(d, fill)
        assert tf.snapshot() == jf.snapshot()
    assert seen_t == seen_j and len(seen_t) == 2
    assert TF.FlightRecorder(window=1, min_samples=0).snapshot() == \
        JF.FlightRecorder(window=1, min_samples=0).snapshot()


def test_stall_profiler_counters_equal_jax(tmp_path):
    def run(mod):
        now = [0.0]
        traced = []

        @contextlib.contextmanager
        def trace_fn(log_dir, name):
            traced.append(name)
            if name == "stall-002":
                raise RuntimeError("profiler busy")
            yield log_dir / name

        prof = mod.StallProfiler(tmp_path, cooldown_s=10.0,
                                 duration_s=0.001, clock=lambda: now[0],
                                 trace_fn=trace_fn)
        out = []
        for t, wait in ((0.0, True), (1.0, True), (11.0, True),
                        (12.0, False), (30.0, True)):
            now[0] = t
            out.append(prof.on_stall({"step": t}))
            if wait:
                deadline = time.monotonic() + 10
                while prof._active and time.monotonic() < deadline:
                    time.sleep(0.001)
        summary = prof.summary()
        for c in prof.captures:
            c["path"] = c["path"].replace(str(tmp_path), "<dir>")
        return out, traced, summary, prof.captures

    t_out, j_out = run(TF), run(JF)
    assert t_out[0] == j_out[0] and t_out[1] == j_out[1]
    assert t_out[3] == j_out[3]
    summary_t, summary_j = t_out[2], j_out[2]
    summary_t["last"]["path"] = summary_j["last"]["path"] = None
    assert summary_t == summary_j
    assert summary_t["captures"] == 2 and summary_t["skipped"] == 2
    assert summary_t["last_error"] == "RuntimeError: profiler busy"


@pytest.mark.parametrize("env", [
    {}, {"KUBEFLOW_TPU_STALL_PROFILE_DIR": "  "},
    {"KUBEFLOW_TPU_STALL_PROFILE_DIR": "D"},
    {"KUBEFLOW_TPU_STALL_PROFILE_DIR": "D",
     "KUBEFLOW_TPU_STALL_PROFILE_COOLDOWN_S": "0",
     "KUBEFLOW_TPU_STALL_PROFILE_SECONDS": "0.5"},
    {"KUBEFLOW_TPU_STALL_PROFILE_DIR": "D",
     "KUBEFLOW_TPU_STALL_PROFILE_COOLDOWN_S": "-1"},
    {"KUBEFLOW_TPU_STALL_PROFILE_DIR": "D",
     "KUBEFLOW_TPU_STALL_PROFILE_COOLDOWN_S": "soon"},
    {"KUBEFLOW_TPU_STALL_PROFILE_DIR": "D",
     "KUBEFLOW_TPU_STALL_PROFILE_SECONDS": "0"},
])
def test_stall_profiler_from_env_equals_jax(monkeypatch, tmp_path, env):
    for name in ("KUBEFLOW_TPU_STALL_PROFILE_DIR",
                 "KUBEFLOW_TPU_STALL_PROFILE_COOLDOWN_S",
                 "KUBEFLOW_TPU_STALL_PROFILE_SECONDS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, str(tmp_path / value)
                           if value == "D" else value)

    def run(mod):
        try:
            prof = mod.stall_profiler_from_env()
        except ValueError as err:
            return ("error", str(err))
        return prof and (str(prof.log_dir), prof.cooldown_s, prof.duration_s)

    assert run(TF) == run(JF)


def test_stall_profiler_defaults_to_the_torch_profiler(tmp_path):
    """No ``trace_fn``: the capture runs ``profiling.trace`` and writes a
    Chrome trace under ``stall-001``."""
    prof = TF.StallProfiler(tmp_path, duration_s=0.01)
    assert prof.on_stall({"step": 1})
    deadline = time.monotonic() + 60
    while prof._active and time.monotonic() < deadline:
        time.sleep(0.01)
    summary = prof.summary()
    assert summary["captures"] == 1, summary
    assert (tmp_path / "stall-001" / TP.TRACE_FILE).is_file()


def test_profiling_trace_writes_the_annotated_steps(tmp_path):
    def step(state, batch):
        new = state + (batch @ batch.T).sum()
        return new, new

    with TP.trace(tmp_path, "t1") as path:
        state, times = TP.timed_steps(step, torch.zeros(()),
                                      [torch.ones(8, 8)] * 3)
        # Work on another thread is captured as well.
        worker = threading.Thread(
            target=lambda: (torch.ones(16, 16) @ torch.ones(16, 16)))
        worker.start()
        worker.join()
    assert path == tmp_path / "t1"
    assert len(times) == 3 and all(t >= 0 for t in times)
    assert float(state) == 3 * 8 * 8 * 8
    events = json.loads((path / TP.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train_step#0", "train_step#1", "train_step#2"} <= names
    assert any("mm" in (n or "") for n in names)
