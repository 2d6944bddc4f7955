"""Request tracing: spans, the W3C traceparent header, exporters.

The port's own copy of ``kubeflow_tpu/observability/tracing.py`` (the
port imports nothing of the JAX package, not even its JAX-free modules),
with the same names, wire format and sampling rule, so a port replica
joins a trace that a gateway or a JAX replica started and the other way
round:

- ``Span`` carries ``trace_id``/``span_id``/``parent_id`` (W3C hex) and is
  both a context manager and manually endable via ``.end()``;
- ``Tracer.start_span`` parents onto the contextvar-tracked current span
  and installs the new span as current until it ends;
  ``Tracer.begin_span`` does not install it, for spans that start in one
  thread and end in another (the server's ``queue_wait``);
- ``format_traceparent`` / ``parse_traceparent``: the
  ``00-<trace_id>-<span_id>-<flags>`` header of an HTTP hop;
- sampling is a pure function of the trace id (``deterministic_sample``),
  so every hop of one request reaches the same verdict;
- exporters: ``InMemoryExporter`` (tests), ``RingBufferExporter``
  (bounded; backs ``/debug/traces``), ``JSONLExporter`` (a file).

The default provider records nothing; ``configure_from_env`` installs a
recording one only when a ``KUBEFLOW_TPU_TRACE_*`` variable is set, and
never replaces a recording provider already installed.
"""

from __future__ import annotations

import contextvars
import json
import os
import re
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

# The port's own copies of the env contract names (the JAX package's
# webhook/tpu_env.py): setting any of them switches the process from the
# no-op provider to a recording one.
KUBEFLOW_TPU_TRACE_EXPORT = "KUBEFLOW_TPU_TRACE_EXPORT"
KUBEFLOW_TPU_TRACE_SAMPLE = "KUBEFLOW_TPU_TRACE_SAMPLE"
KUBEFLOW_TPU_TRACE_RING = "KUBEFLOW_TPU_TRACE_RING"


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def format_traceparent(span: "Span") -> str:
    """W3C traceparent for ``span``; empty string for the no-op span (no
    identity to propagate)."""
    if not span.trace_id:
        return ""
    flags = "00" if isinstance(span, _NoopSpan) else "01"
    return f"00-{span.trace_id}-{span.span_id}-{flags}"


def parse_traceparent(header: Optional[str]):
    """Parse a W3C traceparent header.

    Returns ``(trace_id, parent_span_id, sampled)`` or None for a missing /
    malformed header (malformed headers are dropped, not propagated — the
    receiver starts a fresh trace, per the W3C spec's restart rule).
    """
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 0x01)


def deterministic_sample(trace_id: str, rate: float) -> bool:
    """Head-sampling decision as a pure function of the trace id: every
    component of a distributed trace reaches the same verdict with no
    coordination (the gateway's decision rides the traceparent flags, but a
    replica hit directly still agrees)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return int(trace_id[:8], 16) < rate * 0x1_0000_0000


@dataclass
class Span:
    name: str
    attributes: dict = field(default_factory=dict)
    events: list = field(default_factory=list)
    parent: Optional["Span"] = None
    start_time: float = 0.0
    end_time: float = 0.0
    status: str = "OK"  # OK | ERROR
    status_message: str = ""
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""  # parent span id, incl. remote (traceparent) parents
    _provider: Optional["TracerProvider"] = field(
        default=None, repr=False, compare=False
    )
    _token: Optional[contextvars.Token] = field(
        default=None, repr=False, compare=False
    )
    _ended: bool = field(default=False, repr=False, compare=False)

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: Optional[dict] = None) -> None:
        self.events.append({"name": name, "attributes": attributes or {}})

    def record_error(self, err: Exception) -> None:
        self.status = "ERROR"
        self.status_message = str(err)

    def end(self) -> None:
        """Idempotent; safe from a different thread than the starter (the
        context slot is then restored by value rather than by token)."""
        if self._ended:
            return
        self._ended = True
        self.end_time = time.time()
        self._restore_context()
        if self._provider is not None:
            self._provider._export(self)

    def _restore_context(self) -> None:
        if self._token is None:
            return
        token, self._token = self._token, None
        try:
            _current.reset(token)
        except ValueError:
            # Token minted in another context (cross-thread end): fall back
            # to re-pointing at the parent.
            _current.set(self.parent)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if isinstance(exc, Exception):
            self.record_error(exc)
        self.end()
        return False

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_time - self.start_time)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "status": self.status,
            "status_message": self.status_message,
            "attributes": self.attributes,
            "events": self.events,
        }


class _NoopSpan(Span):
    """Recording methods are no-ops; attribute writes go nowhere. Unsampled
    spans are fresh _NoopSpan instances that still carry a trace id, so
    propagation (traceparent, X-Request-Id) survives the sampling decision."""

    def set_attribute(self, key: str, value) -> None:
        pass

    def add_event(self, name: str, attributes: Optional[dict] = None) -> None:
        pass

    def record_error(self, err: Exception) -> None:
        pass

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self._restore_context()


_NOOP_SPAN = _NoopSpan(name="noop")

# Current-span context, per thread and task: the serving path traces from
# HTTP handler threads and the engine drive thread at once.
_current: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "kubeflow_tpu_torch_current_span", default=None
)


def current_span() -> Span:
    """This thread's (context's) active span. Never None: callers get the
    no-op singleton when nothing is active, so instrumentation sites can
    add events/attributes unconditionally."""
    return _current.get() or _NOOP_SPAN


class InMemoryExporter:
    """Collects ended spans (for tests)."""

    def __init__(self):
        self.spans: list[Span] = []

    def export(self, span: Span) -> None:
        self.spans.append(span)

    def by_name(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def reset(self) -> None:
        self.spans.clear()


class RingBufferExporter:
    """Bounded in-memory ring of the most recent finished spans; backs the
    serving components' ``/debug/traces`` endpoint. Eviction is oldest-first
    at ``capacity`` spans."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._spans: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._spans]

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


class JSONLExporter:
    """Appends one JSON object per finished span to ``path``. Writes are
    lock-serialized and the file is opened per export, so concurrent handler
    threads and late process exit never interleave or truncate records."""

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), sort_keys=True, default=str)
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")


class Tracer:
    def __init__(self, name: str, provider: "TracerProvider"):
        self.name = name
        self.provider = provider

    @property
    def exporter(self):
        return self.provider.exporter

    def start_span(
        self,
        name: str,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
        **attributes,
    ) -> Span:
        """Create a span, install it as the contextvar-current span, and
        return it. The result is a context manager (``with ... as span:``)
        AND manually endable (``span.end()``); ``with`` is the norm."""
        return self._make(name, parent, traceparent, attributes, install=True)

    def begin_span(
        self,
        name: str,
        parent: Optional[Span] = None,
        traceparent: Optional[str] = None,
        **attributes,
    ) -> Span:
        """Like start_span but does NOT become the contextvar-current span:
        for spans handed across threads (started here, ``.end()``-ed
        elsewhere), where installing into this thread's context would leak."""
        return self._make(name, parent, traceparent, attributes, install=False)

    def _make(self, name, parent, traceparent, attributes, install) -> Span:
        if not self.provider.recording:
            return _NOOP_SPAN
        if parent is None:
            parent = _current.get()
        remote = parse_traceparent(traceparent) if parent is None else None
        if parent is not None:
            trace_id = parent.trace_id or new_trace_id()
            parent_id = parent.span_id
            sampled = not isinstance(parent, _NoopSpan)
        elif remote is not None:
            trace_id, parent_id, sampled = remote
            sampled = sampled and deterministic_sample(
                trace_id, self.provider.sample_rate
            )
        else:
            trace_id = new_trace_id()
            parent_id = ""
            sampled = deterministic_sample(trace_id, self.provider.sample_rate)
        cls = Span if sampled else _NoopSpan
        span = cls(
            name=name,
            attributes=dict(attributes),
            parent=parent if isinstance(parent, Span) else None,
            start_time=time.time(),
            trace_id=trace_id,
            span_id=new_span_id(),
            parent_id=parent_id,
            _provider=self.provider if sampled else None,
        )
        if install:
            span._token = _current.set(span)
        return span


class TracerProvider:
    """Global provider; the default exports nowhere (OTel's no-op global).

    ``TracerProvider(exporter)`` keeps the original single-exporter calling
    convention; ``exporters=[...]`` fans each finished span out to several
    (ring buffer + JSONL file in the env-configured production shape).
    """

    def __init__(
        self,
        exporter=None,
        *,
        exporters=None,
        sample_rate: float = 1.0,
    ):
        self.exporters = ([exporter] if exporter is not None else []) + list(
            exporters or []
        )
        self.sample_rate = float(sample_rate)

    @property
    def exporter(self):
        return self.exporters[0] if self.exporters else None

    @property
    def recording(self) -> bool:
        return bool(self.exporters)

    def _export(self, span: Span) -> None:
        for exp in self.exporters:
            exp.export(span)

    def ring(self) -> Optional[RingBufferExporter]:
        for exp in self.exporters:
            if isinstance(exp, RingBufferExporter):
                return exp
        return None

    def get_tracer(self, name: str) -> Tracer:
        return Tracer(name, self)


_provider = TracerProvider()


def set_tracer_provider(provider: TracerProvider) -> None:
    global _provider
    _provider = provider


def get_tracer(name: str) -> Tracer:
    """Always reads the *current* global provider, so a provider
    installed after import is picked up."""
    return _provider.get_tracer(name)


def enabled() -> bool:
    """Cheap guard for per-step instrumentation: False under the default
    no-op provider, so the hot engine loop skips span construction."""
    return _provider.recording


def trace_ring() -> Optional[RingBufferExporter]:
    """The installed provider's ring buffer (``/debug/traces`` source)."""
    return _provider.ring()


def configure_from_env() -> bool:
    """Install a recording provider from ``KUBEFLOW_TPU_TRACE_*`` env.

    No-op (returns False) when none of the variables are set OR a recording
    provider is already installed — serving entrypoints call this from
    their constructors, and it must never clobber a provider a test (or an
    earlier component in the same process) installed.
    """
    export_path = os.environ.get(KUBEFLOW_TPU_TRACE_EXPORT, "")
    sample = os.environ.get(KUBEFLOW_TPU_TRACE_SAMPLE, "")
    ring = os.environ.get(KUBEFLOW_TPU_TRACE_RING, "")
    if not (export_path or sample or ring):
        return False
    if _provider.recording:
        return False
    try:
        capacity = int(ring) if ring else 512
    except ValueError as err:
        raise ValueError(f"{KUBEFLOW_TPU_TRACE_RING}={ring!r}: {err}") from err
    try:
        rate = float(sample) if sample else 1.0
    except ValueError as err:
        raise ValueError(
            f"{KUBEFLOW_TPU_TRACE_SAMPLE}={sample!r}: {err}"
        ) from err
    exporters: list = [RingBufferExporter(capacity)]
    if export_path:
        exporters.append(JSONLExporter(export_path))
    set_tracer_provider(
        TracerProvider(exporters=exporters, sample_rate=rate)
    )
    return True
