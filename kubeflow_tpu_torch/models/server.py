"""HTTP inference server over the port's batching engine.

Counterpart of the core of ``kubeflow_tpu/models/server.py``: a stdlib
ThreadingHTTPServer in front of ONE engine thread. Handler threads
``submit()`` under the engine lock and block on (or stream from) a
per-request queue; the engine thread loops admit → step while work
exists, sleeping on a condition variable when idle. Per-token delivery
rides the engine's ``on_token``/``on_retire``/``on_abort``/``on_admit``
hooks.

Endpoints, with the JAX server's request fields and response shapes:
- ``POST /v1/completions`` — ``prompt`` (token ids, or a string with a
  ``tokenizer``), ``max_tokens``, ``temperature``, ``n`` (1..64),
  ``stop``, ``logit_bias``, ``logprobs`` (400 from a speculative engine,
  whose rounds verify argmaxes), ``deadline_s``, ``model`` (the served
  name or, on a multi-LoRA engine, an adapter's: ``resolve_adapter``
  routes it; an unknown name is 400), ``stream`` (``text/event-stream`` lines
  ``data: {"id", "token"}`` ending ``data: [DONE]``, an error event first
  on abort), and ``kv_import`` (an exported KV payload: the request is
  installed from it without a prefill, ``n`` 1 only);
- ``POST /kv/prefill`` — the prefill tier's hop: the prompt is prefilled,
  one token sampled, and the paged-KV payload cut at first-token time
  (``skip_keys`` names chain blocks to send as stubs);
- ``POST /kv/probe`` (how many leading chain ``keys`` this replica holds,
  swap tier included, with the byte advisory), ``POST /kv/chain`` (export
  the held prefix of ``keys`` from the prefix cache) and ``POST
  /kv/chain/import`` (register a chain ``payload`` against the request's
  ``tokens``): the fleet's peer prefix tier;
- ``GET /healthz`` (503 once the engine thread died or a drain started),
  ``GET /v1/models`` (the served name, then each adapter's), ``GET
  /stats`` (the engine, latency and ``tier_role`` keys and, where the
  engine has them, the ``prefix_cache``, ``kv_swap``, ``kv_handoff``,
  ``speculative`` and ``lora_cache`` blocks, under the JAX server's
  names; ``engine_step_stalls`` and ``flight``, the flight recorder's
  window, with ``stall_profiles`` where stall capture is armed), ``GET
  /debug/traces`` (the finished spans of the trace ring).

A speculative engine is a wrapper around an inner batcher (``_engine``):
the server drives the inner one and reads the wrapper's ``spec_stats``.
A tensor-parallel replica is served on its rank 0 through
``models/tp_serving.TPReplica``, which mirrors every engine call that
changes state to the other ranks; ``/stats`` then carries ``mesh`` (the
replica's axes, absent on one rank), and a prefill-tier request is marked
for export (``mark_kv_export``) so that every rank cuts the payload's
head gather at the same token.

Request lifecycle: ``max_queue_depth`` sheds with 429 + Retry-After
without taking the engine lock (an import with no free slot or blocks
sheds too); ``max_body_bytes`` caps Content-Length (413), and
``max_kv_body_bytes`` the bodies that carry a KV payload (``kv_import``,
``/kv/chain/import``: by default the gateway's 64 MiB transfer ceiling,
so a decode-tier replica admits every payload a gateway sends); per-request deadlines retire the slot at the next
step (504 with partial tokens); a client that disconnects cancels its
requests; ``stop()`` drains for ``drain_s`` (503 to new submits) and then
aborts stragglers; an engine failure aborts every waiting request and
turns /healthz red. The ``/kv/*`` hops answer with the JAX server's codes:
400 for a bad body or payload, 409 for a stub whose chain is gone (or an
engine that cannot export), 413, 429 and 503.

Observability, as the JAX server has it:
- tracing (``observability/tracing.py``, on when a ``KUBEFLOW_TPU_TRACE_*``
  variable is set or a test installs a provider): every POST runs in a
  ``server.request`` root span that joins an incoming ``traceparent``;
  each request gets a ``queue_wait`` span (submit to batcher pickup), a
  ``prefill`` span (pickup to first token; ``kv_import`` for an imported
  payload) and a ``first_decode`` span (the fused tail to the token), all
  children of the root, and the root a ``first_token`` event with the
  TTFT; the engine's ``drive_once`` adds an ``engine.step`` span each
  quantum. Responses carry ``X-Request-Id``: the caller's, else the
  trace id;
- the flight recorder (``observability/flight.py``), always on, fed by
  ``drive_once``; ``KUBEFLOW_TPU_STALL_PROFILE_DIR`` arms a profile
  capture on a stall (``StallProfiler``);
- ``metrics=``: a bundle whose attributes the server mirrors into with
  ``.inc()`` and ``.set()`` only, at the JAX server's sites and under its
  attribute names (``serving_requests_shed_total``,
  ``engine_step_stall_total``, ``serving_prefix_cache_hits_total``, ...),
  so the JAX package's Prometheus ``Metrics`` bundle plugs in as it is.
  The port imports no metrics library.
"""

from __future__ import annotations

import collections
import json
import math
import os
import queue
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kubeflow_tpu_torch.api.annotations import (
    SERVING_ENV_NAME as KUBEFLOW_TPU_SERVING_PORT,
)
from kubeflow_tpu_torch.observability import tracing
from kubeflow_tpu_torch.observability.flight import (
    FlightRecorder,
    stall_profiler_from_env,
)

# The port's own copies of the env contract names it reads (the JAX
# package's webhook/tpu_env.py); the serving port's is imported above.
KUBEFLOW_TPU_SERVING_RAGGED = "KUBEFLOW_TPU_SERVING_RAGGED"
KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET = "KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET"
KUBEFLOW_TPU_KV_BITS = "KUBEFLOW_TPU_KV_BITS"
KUBEFLOW_TPU_HBM_FRACTION = "KUBEFLOW_TPU_HBM_FRACTION"
KUBEFLOW_TPU_KV_SWAP_BYTES = "KUBEFLOW_TPU_KV_SWAP_BYTES"
KUBEFLOW_TPU_SPEC_DRAFT_LEN = "KUBEFLOW_TPU_SPEC_DRAFT_LEN"
KUBEFLOW_TPU_SPEC_ADAPTIVE = "KUBEFLOW_TPU_SPEC_ADAPTIVE"
KUBEFLOW_TPU_SERVING_TP = "KUBEFLOW_TPU_SERVING_TP"
KUBEFLOW_TPU_LORA_CACHE_SLOTS = "KUBEFLOW_TPU_LORA_CACHE_SLOTS"
KUBEFLOW_TPU_GATEWAY_TIER_ROLE = "KUBEFLOW_TPU_GATEWAY_TIER_ROLE"


def _percentiles(window) -> dict:
    """{p50, p95} by nearest rank over one sort of the window."""
    if not window:
        return {"p50": None, "p95": None}
    xs = sorted(window)
    n = len(xs)

    def rank(q):
        return round(xs[min(n - 1, max(0, -(-q * n // 100) - 1))], 4)

    return {"p50": rank(50), "p95": rank(95)}


class _Final:
    """Success sentinel with the AUTHORITATIVE final tokens (a stop match
    truncates tokens the stream already delivered), the chosen-token
    logprobs and the finish reason ("stop" or "length")."""

    def __init__(self, tokens: list, logprobs: list,
                 finish_reason: str = "stop"):
        self.tokens = tokens
        self.logprobs = logprobs
        self.finish_reason = finish_reason


class _Abort:
    """Queue sentinel for a request that did NOT complete (engine death,
    shutdown, deadline, cancellation)."""

    def __init__(self, reason: str):
        self.reason = reason


class EngineFailedError(RuntimeError):
    """The engine thread is dead; submits are refused (503)."""


class OverloadedError(RuntimeError):
    """The pending queue is at max_queue_depth: shed (429)."""


class DrainingError(RuntimeError):
    """The server is draining: new submits are refused (503)."""


class BodyTooLarge(ValueError):
    def __init__(self, length: int, limit: int):
        super().__init__(
            f"request body {length} bytes exceeds the {limit}-byte limit"
        )
        self.length = length
        self.limit = limit


def _client_gone(conn) -> bool:
    """True when the peer closed its end: the socket selects readable but
    a MSG_PEEK read returns EOF or errors."""
    try:
        r, _, _ = select.select([conn], [], [], 0)
        if not r:
            return False
        return conn.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError):
        return True


# The gateway's default KUBEFLOW_TPU_KV_TRANSFER_MAX_BYTES: the largest
# serialized KV payload it sends, and so what a replica admits in one.
KV_TRANSFER_MAX_BYTES = 64 << 20


def _read_body(handler, limit: int) -> bytes:
    """Refuse a Content-Length past ``limit`` BEFORE reading a byte."""
    length = int(handler.headers.get("Content-Length", 0))
    if length < 0:
        raise ValueError(f"invalid Content-Length {length}")
    if length > limit:
        raise BodyTooLarge(length, limit)
    return handler.rfile.read(length)


def serving_port_from_env(default: int = 8000) -> int:
    """KUBEFLOW_TPU_SERVING_PORT (a port in 1024..65535), else
    ``default``. Raises on garbage."""
    value = os.environ.get(KUBEFLOW_TPU_SERVING_PORT, "").strip()
    if not value:
        return default
    try:
        port = int(value)
    except ValueError:
        port = 0
    if not 1024 <= port <= 65535:
        raise ValueError(
            f"{KUBEFLOW_TPU_SERVING_PORT}={value!r}: want a port in "
            "1024..65535"
        )
    return port


def ragged_from_env() -> tuple[bool, Optional[int]]:
    """(ragged, token_budget) from KUBEFLOW_TPU_SERVING_RAGGED and
    KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET; None budget = the engine default.
    Raises on garbage."""
    raw = os.environ.get(KUBEFLOW_TPU_SERVING_RAGGED, "").strip().lower()
    if raw not in ("", "0", "1", "true", "false"):
        raise ValueError(
            f"{KUBEFLOW_TPU_SERVING_RAGGED}={raw!r}: want 0/1/true/false"
        )
    ragged = raw in ("1", "true")
    budget: Optional[int] = None
    raw_b = os.environ.get(KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET, "").strip()
    if raw_b:
        try:
            budget = int(raw_b)
        except ValueError:
            budget = 0
        if budget <= 0:
            raise ValueError(
                f"{KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET}={raw_b!r}: want a "
                "positive integer"
            )
    return ragged, budget


def kv_pool_from_env() -> dict:
    """The ``kv_bits`` / ``hbm_fraction`` / ``swap_bytes`` keywords for
    PagedBatcher from KUBEFLOW_TPU_KV_BITS, KUBEFLOW_TPU_HBM_FRACTION and
    KUBEFLOW_TPU_KV_SWAP_BYTES; an unset variable leaves its keyword out
    (the engine default). Raises on garbage."""
    kw: dict = {}
    raw = os.environ.get(KUBEFLOW_TPU_KV_BITS, "").strip()
    if raw:
        if raw not in ("0", "8"):
            raise ValueError(
                f"{KUBEFLOW_TPU_KV_BITS}={raw!r}: want 0 (bf16) or 8 "
                "(int8 values + bf16 scales)"
            )
        kw["kv_bits"] = int(raw)
    raw = os.environ.get(KUBEFLOW_TPU_HBM_FRACTION, "").strip()
    if raw:
        try:
            fraction = float(raw)
        except ValueError:
            fraction = 0.0
        if not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"{KUBEFLOW_TPU_HBM_FRACTION}={raw!r}: want a float in "
                "(0, 1]"
            )
        kw["hbm_fraction"] = fraction
    raw = os.environ.get(KUBEFLOW_TPU_KV_SWAP_BYTES, "").strip()
    if raw:
        try:
            swap = int(raw)
        except ValueError:
            swap = -1
        if swap < 0:
            raise ValueError(
                f"{KUBEFLOW_TPU_KV_SWAP_BYTES}={raw!r}: want a "
                "non-negative byte count"
            )
        kw["swap_bytes"] = swap
    return kw


def spec_from_env() -> tuple[int, bool]:
    """(draft_len, adaptive) from KUBEFLOW_TPU_SPEC_DRAFT_LEN and
    KUBEFLOW_TPU_SPEC_ADAPTIVE; draft_len 0 means speculation off. Raises
    on garbage, and on ADAPTIVE=1 without a draft length."""
    draft_len = 0
    raw = os.environ.get(KUBEFLOW_TPU_SPEC_DRAFT_LEN, "").strip()
    if raw:
        try:
            draft_len = int(raw)
        except ValueError:
            draft_len = -1
        if draft_len < 0:
            raise ValueError(
                f"{KUBEFLOW_TPU_SPEC_DRAFT_LEN}={raw!r}: want a "
                "non-negative draft length (0 disables speculation)"
            )
    raw = os.environ.get(KUBEFLOW_TPU_SPEC_ADAPTIVE, "").strip().lower()
    if raw not in ("", "0", "1", "true", "false"):
        raise ValueError(
            f"{KUBEFLOW_TPU_SPEC_ADAPTIVE}={raw!r}: want 0/1/true/false"
        )
    adaptive = raw in ("1", "true")
    if adaptive and not draft_len:
        raise ValueError(
            f"{KUBEFLOW_TPU_SPEC_ADAPTIVE}=1 without "
            f"{KUBEFLOW_TPU_SPEC_DRAFT_LEN}: the adaptive range is "
            "[1, draft_len], so a draft length must be set"
        )
    return draft_len, adaptive


def serving_tp_from_env() -> int:
    """The tensor-parallel degree from KUBEFLOW_TPU_SERVING_TP; unset is 1
    (one card). Raises on garbage."""
    raw = os.environ.get(KUBEFLOW_TPU_SERVING_TP, "").strip()
    if not raw:
        return 1
    try:
        tp = int(raw)
    except ValueError:
        tp = 0
    if tp < 1:
        raise ValueError(
            f"{KUBEFLOW_TPU_SERVING_TP}={raw!r}: want an integer >= 1 "
            "(1 keeps the single-chip engine)"
        )
    return tp


def lora_cache_from_env() -> int:
    """The hot-adapter cache slots of a multi-LoRA engine from
    KUBEFLOW_TPU_LORA_CACHE_SLOTS; unset is 0 (residency uncapped). Raises
    on garbage."""
    raw = os.environ.get(KUBEFLOW_TPU_LORA_CACHE_SLOTS, "").strip()
    if not raw:
        return 0
    try:
        slots = int(raw)
    except ValueError:
        slots = -1
    if slots < 0:
        raise ValueError(
            f"{KUBEFLOW_TPU_LORA_CACHE_SLOTS}={raw!r}: want a "
            "non-negative slot count (0 leaves residency uncapped)"
        )
    return slots


def tier_role_from_env() -> str:
    """The disaggregated-serving role this replica advertises on /stats,
    from KUBEFLOW_TPU_GATEWAY_TIER_ROLE (unset is "fused"). Raises on
    garbage."""
    raw = os.environ.get(KUBEFLOW_TPU_GATEWAY_TIER_ROLE, "").strip().lower()
    if raw not in ("", "fused", "prefill", "decode"):
        raise ValueError(
            f"{KUBEFLOW_TPU_GATEWAY_TIER_ROLE}={raw!r}: want "
            "fused/prefill/decode"
        )
    return raw or "fused"


def _logit_bias_field(req: dict) -> Optional[dict]:
    logit_bias = req.get("logit_bias")
    if logit_bias is not None and not isinstance(logit_bias, dict):
        raise ValueError(
            "logit_bias must be an object mapping token ids to biases"
        )
    return logit_bias


def _deadline_field(req: dict) -> Optional[float]:
    deadline_s = req.get("deadline_s")
    if deadline_s is not None and (
        isinstance(deadline_s, bool)
        or not isinstance(deadline_s, (int, float))
        or not math.isfinite(deadline_s)
        or deadline_s <= 0
    ):
        raise ValueError(
            f"deadline_s must be a finite number > 0, got {deadline_s!r}"
        )
    return deadline_s


def _chain_keys_field(req: dict, name: str) -> list[bytes]:
    """A request's list of hex chain keys, decoded; ValueError when it is
    not a list of hex strings."""
    keys = req.get(name) or []
    if not isinstance(keys, list) or not all(
            isinstance(k, str) for k in keys):
        raise ValueError(f"{name} must be a list of hex strings")
    return [bytes.fromhex(k) for k in keys]


class InferenceServer:
    """HTTP front-end driving one batching engine on a background thread.

    >>> srv = InferenceServer(engine, port=0).start()   # 0 = ephemeral
    >>> # POST http://127.0.0.1:{srv.port}/v1/completions
    >>> srv.stop()
    """

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 tokenizer=None, model_name: str = "kubeflow-tpu",
                 max_queue_depth: int = 64,
                 max_body_bytes: int = 4 << 20,
                 max_kv_body_bytes: int = KV_TRANSFER_MAX_BYTES,
                 default_deadline_s: Optional[float] = None,
                 max_deadline_s: Optional[float] = None,
                 drain_s: float = 5.0,
                 metrics=None,
                 tier_role: str = "fused"):
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{max_queue_depth}")
        if tier_role not in ("fused", "prefill", "decode"):
            raise ValueError(
                f"tier_role must be fused/prefill/decode, got {tier_role!r}"
            )
        # Advisory: the engine serves whatever arrives; tier membership
        # is the gateway's routing decision.
        self.tier_role = tier_role
        # Env-gated tracing: a no-op unless KUBEFLOW_TPU_TRACE_* is set,
        # and never replaces a provider a test already installed.
        tracing.configure_from_env()
        self.max_queue_depth = max_queue_depth
        self.max_body_bytes = max_body_bytes
        self.max_kv_body_bytes = max_kv_body_bytes
        self.default_deadline_s = default_deadline_s
        self.max_deadline_s = max_deadline_s
        self.drain_s = drain_s
        # Optional metrics bundle: /stats' counters mirrored with .inc()
        # and .set() on its attributes.
        self.metrics = metrics
        # A speculative engine wraps an inner batcher (``_engine``) that
        # owns the queue, slots and drive loop: hooks and the loop target
        # it. The wrapper owns the acceptance stats.
        self.engine = getattr(engine, "_engine", engine)
        self._spec = engine if hasattr(engine, "spec_stats") else None
        if model_name in getattr(self.engine, "adapter_names", ()):
            # The "model == model_name → base" shortcut in _submit would
            # make that adapter unreachable.
            raise ValueError(
                f"model_name {model_name!r} collides with an adapter "
                "name — requests for the adapter would be routed to the "
                "base model"
            )
        self.tokenizer = tokenizer
        self.model_name = model_name
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: dict[int, queue.Queue] = {}
        self._shutdown = False
        self._draining = False
        self._stopped = False
        self._served = 0
        self._engine_error: Optional[str] = None
        # The shed counter has its OWN lock: the shed fast path must not
        # wait on the engine lock, held for whole engine steps.
        self._shed = 0
        self._shed_lock = threading.Lock()
        self._cancelled = 0
        self._deadline_expired = 0
        self._drain_duration: Optional[float] = None
        self._drain_started: Optional[float] = None
        # Per-request stamps and sliding windows for /stats, read and
        # written under the engine lock.
        self._submit_ts: dict[int, float] = {}
        self._first_ts: dict[int, float] = {}
        self._last_tok_ts: dict[int, float] = {}
        self._ttft = collections.deque(maxlen=256)
        self._e2e = collections.deque(maxlen=256)
        self._queue_wait = collections.deque(maxlen=256)
        self._itl = collections.deque(maxlen=256)
        self._tokens_out = 0
        self._started_at = None
        # Pending KV exports (the prefill tier): rid → {"skip", "payload",
        # "error"}, registered at submit under the engine lock and filled
        # by _on_token at the first token, the one moment the slot still
        # holds the prompt's blocks and the sampled token is known.
        self._kv_exports: dict[int, dict] = {}
        # Metric counters only go up: the engine's monotonic tallies are
        # mirrored by delta from the last values mirrored.
        self._prefix_mirrored = (0, 0, 0)
        self._swap_mirrored = (0, 0, 0)
        self._spec_mirrored = (0, 0)
        self._lora_mirrored = (0, 0, 0)
        self._stalls_mirrored = 0
        # Per-request spans: rid → {"root", "queue_wait" or "prefill"}.
        # queue_wait starts at submit (handler thread) and ends at pickup
        # (engine thread, _on_admit); prefill ends at the first token.
        # Mutated under the engine lock.
        self._req_spans: dict[int, dict] = {}
        # The flight recorder, always on, on the engine's clock (tests
        # drive stalls with a fake one); stall capture only when the env
        # names a directory, its hook called outside the recorder's lock.
        self.flight = FlightRecorder(
            clock=getattr(self.engine, "_clock", None))
        self._stall_profiler = stall_profiler_from_env()
        if self._stall_profiler is not None:
            self.flight.on_stall = self._stall_profiler.on_stall
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._engine_thread = threading.Thread(
            target=self._drive, name="inference-engine", daemon=True
        )
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="inference-http",
            daemon=True,
        )
        self.engine.on_token = self._on_token
        self.engine.on_retire = self._on_retire
        self.engine.on_abort = self._on_abort
        self.engine.on_admit = self._on_admit
        self.engine.flight = self.flight

    # -- engine side (all under self._lock) --------------------------------

    def _on_admit(self, rid: int) -> None:
        """Batcher pickup (engine thread): queue_wait ends and prefill
        begins, so TTFT splits into queue_wait + prefill + first_decode."""
        t0 = self._submit_ts.get(rid)
        if t0 is not None:
            self._queue_wait.append(time.monotonic() - t0)
        spans = self._req_spans.get(rid)
        if spans is None:
            return
        qs = spans.pop("queue_wait", None)
        if qs is not None:
            qs.end()
        spans["prefill"] = tracing.get_tracer("server").begin_span(
            "prefill", parent=spans.get("root"), rid=rid)

    def _end_request_spans(self, rid: int, error: str = "") -> None:
        """End a request's open child spans (the root is the handler's);
        an abort's reason marks them as errors."""
        spans = self._req_spans.pop(rid, None)
        for name, span in (spans or {}).items():
            if name == "root" or span is None:
                continue
            if error:
                span.record_error(RuntimeError(error))
            span.end()

    def _on_token(self, rid: int, token: int) -> None:
        exp = self._kv_exports.get(rid)
        if exp is not None and exp["payload"] is None and exp["error"] is None:
            # The prefill-tier request retires right after this token
            # (max_new_tokens=1); its chains stay registered here.
            try:
                exp["payload"] = self.engine.export_blocks(
                    rid, skip_keys=exp["skip"])
            except Exception as err:  # answered as the hop's failure
                exp["error"] = str(err)
        self._tokens_out += 1
        if rid in self._submit_ts:
            now = time.monotonic()
            prev = self._last_tok_ts.get(rid)
            if prev is not None:
                self._itl.append(now - prev)
            self._last_tok_ts[rid] = now
            if rid not in self._first_ts:
                self._first_ts[rid] = now
                self._ttft.append(now - self._submit_ts[rid])
                self._first_token_spans(rid, now - self._submit_ts[rid])
        q = self._queues.get(rid)
        if q is not None:
            q.put(token)

    def _first_token_spans(self, rid: int, ttft: float) -> None:
        spans = self._req_spans.get(rid)
        if spans is None:
            return
        ps = spans.pop("prefill", None)
        root = spans.get("root")
        if ps is not None:
            ps.end()
            # The first token is sampled in the dispatch that completes
            # the prefill, so first_decode is the (near-zero) tail from
            # the prefill's end to the token's delivery: the three spans
            # sum to the submit → first-token wall clock.
            fd = tracing.get_tracer("server").begin_span(
                "first_decode", parent=root, rid=rid, fused=True)
            fd.start_time = ps.end_time
            fd.end()
        if root is not None:
            root.add_event("first_token", {"rid": rid,
                                           "ttft_s": round(ttft, 6)})

    def _forget(self, rid: int) -> Optional[float]:
        self._first_ts.pop(rid, None)
        self._last_tok_ts.pop(rid, None)
        return self._submit_ts.pop(rid, None)

    def _on_retire(self, rid: int, tokens: list,
                   logprobs: list, finish_reason: str = "stop") -> None:
        self._served += 1
        t0 = self._forget(rid)
        if t0 is not None:
            self._e2e.append(time.monotonic() - t0)
        self._end_request_spans(rid)
        q = self._queues.get(rid)
        if q is not None:
            q.put(_Final(list(tokens), list(logprobs), finish_reason))

    def _on_abort(self, rid: int, tokens: list, reason: str) -> None:
        if reason == "deadline":
            self._deadline_expired += 1
            self._inc("serving_deadline_expired_total")
        else:
            self._cancelled += 1
            self._inc("serving_requests_cancelled_total")
        self._forget(rid)
        self._end_request_spans(rid, error=reason)
        q = self._queues.get(rid)
        if q is not None:
            q.put(_Abort(reason))

    def _drive(self) -> None:
        while True:
            with self._work:
                while not self._shutdown and not self.engine._pending():
                    self._work.wait(timeout=0.5)
                if self._shutdown:
                    return
                # Admit + one step under the lock: handler threads only
                # touch the engine between steps.
                try:
                    # Timed inside: feeds the flight recorder and the
                    # engine.step span.
                    self.engine.drive_once()
                    self._mirror_metrics()
                except Exception as err:  # device OOM, a failed launch, ...
                    # The engine is in an unknown state: abort every
                    # waiting request, flip /healthz red, stop driving.
                    self._engine_error = f"{type(err).__name__}: {err}"
                    abort = _Abort(self._engine_error)
                    for q in self._queues.values():
                        q.put(abort)
                    return
            # Python's lock is not fair: re-taken at once, it would starve
            # the handlers waiting on it (/healthz, /stats, a cancel) until
            # the batch drained. Giving up the thread here lets one in
            # between two quanta.
            time.sleep(0)

    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            getattr(self.metrics, name).inc()

    def _mirror_metrics(self) -> None:
        """After each quantum: the engine's tallies into the metrics
        bundle, counters by delta (engine thread, under the lock)."""
        m, eng = self.metrics, self.engine
        if m is None:
            return
        stalls = self.flight.stalls
        m.engine_step_stall_total.inc(stalls - self._stalls_mirrored)
        self._stalls_mirrored = stalls
        if getattr(eng, "ragged", False) and hasattr(eng, "ragged_fill"):
            m.serving_ragged_batch_fill.set(eng.ragged_fill)
        if getattr(eng, "_prefix_cache_enabled", False):
            now = (eng.prefix_hits, eng.prefix_misses, eng.prefix_evictions)
            for name, v, was in zip(("hits", "misses", "evictions"), now,
                                    self._prefix_mirrored):
                getattr(m, f"serving_prefix_cache_{name}_total").inc(v - was)
            self._prefix_mirrored = now
            m.serving_prefix_cached_blocks.set(eng.prefix_cached_blocks)
        if getattr(eng, "swap_bytes_limit", 0):
            now = (eng.kv_swap_out, eng.kv_swap_in,
                   eng.kv_swap_restored_tokens)
            for name, v, was in zip(("out", "in", "restored_tokens"), now,
                                    self._swap_mirrored):
                getattr(m, f"serving_kv_swap_{name}_total").inc(v - was)
            self._swap_mirrored = now
            m.serving_kv_swap_bytes.set(eng.swap_bytes_used)
        if self._spec is not None:
            st = self._spec.spec_stats()
            now = (st["accepted"], st["rounds"])
            m.serving_spec_accept_total.inc(now[0] - self._spec_mirrored[0])
            m.serving_spec_rounds_total.inc(now[1] - self._spec_mirrored[1])
            self._spec_mirrored = now
        lc_fn = getattr(eng, "lora_cache_stats", None)
        lc = lc_fn() if lc_fn is not None else None
        if lc is not None:
            now = (lc["hits"], lc["misses"], lc["evictions"])
            for name, v, was in zip(("hits", "misses", "evictions"), now,
                                    self._lora_mirrored):
                getattr(m, f"serving_lora_cache_{name}_total").inc(v - was)
            self._lora_mirrored = now

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "InferenceServer":
        self._started_at = time.monotonic()
        self._engine_thread.start()
        self._http_thread.start()
        return self

    def stop(self) -> None:
        """Graceful drain, then hard stop: new submits get 503 and /healthz
        goes unready at once; in-flight work gets up to ``drain_s`` to
        finish; stragglers are aborted and both threads stop. Idempotent."""
        with self._work:
            if self._stopped:
                return
            self._draining = True
            if self._drain_started is None:
                self._drain_started = time.monotonic()
            drain_started = self._drain_started
            self._work.notify_all()
        deadline = drain_started + self.drain_s
        while time.monotonic() < deadline:
            with self._lock:
                idle = (not self._queues and not self.engine._pending()) \
                    or self._engine_error is not None
            if idle:
                break
            time.sleep(min(0.05, self.drain_s))
        with self._work:
            if self._stopped:
                return
            self._stopped = True
            self._shutdown = True
            self._work.notify_all()
            abort = _Abort("server shutdown before generation finished")
            for q in self._queues.values():
                q.put(abort)
            self._drain_duration = time.monotonic() - drain_started
            if self.metrics is not None:
                self.metrics.serving_drain_seconds.set(self._drain_duration)
        if self._http_thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._engine_thread.is_alive():
            self._engine_thread.join(timeout=10)

    # -- HTTP side ---------------------------------------------------------

    def _decode_stop(self, stop):
        """OpenAI "stop": string(s) (needs a tokenizer), or token-native: a
        list of ints (one sequence) / a list of lists."""
        if stop is None:
            return None
        if isinstance(stop, str):
            stop = [stop]
        if not isinstance(stop, list) or not stop:
            raise ValueError("stop must be a string or a non-empty list")
        if all(isinstance(s, str) for s in stop):
            if self.tokenizer is None:
                raise ValueError(
                    "string stop sequences need a tokenizer; send token "
                    "id lists"
                )
            return [
                list(self.tokenizer(s, add_special_tokens=False)["input_ids"])
                for s in stop
            ]
        if all(isinstance(t, int) and not isinstance(t, bool) for t in stop):
            return [list(stop)]
        if all(
            isinstance(s, list) and s
            and all(isinstance(t, int) and not isinstance(t, bool) for t in s)
            for s in stop
        ):
            return [list(s) for s in stop]
        raise ValueError(
            "stop must be string(s), a token-id list, or a list of "
            "token-id lists"
        )

    def _shed_check(self) -> None:
        """Admission control WITHOUT the engine lock (held for whole
        steps): a full queue answers 429 at once. The counter is exact
        under its own lock."""
        if self._draining or self._shutdown:
            raise DrainingError("server is draining; retry elsewhere")
        if self._engine_error is not None:
            raise EngineFailedError(self._engine_error)
        if len(self.engine._queue) >= self.max_queue_depth:
            with self._shed_lock:
                self._shed += 1
            self._inc("serving_requests_shed_total")
            raise OverloadedError(
                f"pending queue is full ({self.max_queue_depth} deep)"
            )

    def _resolve_deadline(self, deadline_s) -> Optional[float]:
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if deadline_s is not None and self.max_deadline_s is not None:
            deadline_s = min(float(deadline_s), self.max_deadline_s)
        return deadline_s

    def _submit(self, prompt: list[int], max_tokens: Optional[int],
                model: Optional[str] = None,
                temperature: Optional[float] = None,
                stop=None, logit_bias=None,
                deadline_s: Optional[float] = None,
                kv_export=None,  # skip-key set: cut a KV payload
                ) -> tuple[int, queue.Queue]:
        self._shed_check()
        q: queue.Queue = queue.Queue()
        deadline_s = self._resolve_deadline(deadline_s)
        with self._work:
            if self._engine_error is not None:
                raise EngineFailedError(self._engine_error)
            if self._draining or self._shutdown:
                raise DrainingError("server is draining; retry elsewhere")
            route = {}
            if model is not None and model != self.model_name:
                # Multi-LoRA routing: the request's "model" names the
                # adapter; resolve_adapter raises ValueError (400) for an
                # unknown one. The served name is the base model.
                if not hasattr(self.engine, "resolve_adapter"):
                    raise ValueError(
                        f"unknown model {model!r} (this server serves "
                        f"{self.model_name!r})"
                    )
                route = {"adapter": model}
            rid = self.engine.submit(prompt, max_new_tokens=max_tokens,
                                     temperature=temperature, stop=stop,
                                     logit_bias=logit_bias,
                                     deadline_s=deadline_s, **route)
            if kv_export is not None:
                # Same lock hold as the submit: on_token cannot fire for
                # this rid before the registry entry exists.
                self._kv_exports[rid] = {
                    "skip": kv_export, "payload": None, "error": None,
                }
                # A tensor-parallel replica's export is a collective: its
                # other ranks must cut it at the same token, so they are
                # told now (models/tp_serving.TPReplica).
                mark = getattr(self.engine, "mark_kv_export", None)
                if mark is not None:
                    mark(rid, kv_export)
            self._queues[rid] = q
            self._submit_ts[rid] = time.monotonic()
            if tracing.enabled():
                # Handler thread: the root span is this thread's current
                # one. queue_wait ends in the ENGINE thread, so it is not
                # installed as this thread's current span.
                root = tracing.current_span()
                self._req_spans[rid] = {
                    "root": root,
                    "queue_wait": tracing.get_tracer("server").begin_span(
                        "queue_wait", parent=root, rid=rid,
                        queue_depth=len(self.engine._queue)),
                }
            if self.metrics is not None:
                self.metrics.serving_queue_depth.set(len(self.engine._queue))
            self._work.notify_all()
        return rid, q

    def _submit_import(self, payload: dict, max_tokens: Optional[int],
                       temperature: Optional[float] = None,
                       stop=None, logit_bias=None,
                       deadline_s: Optional[float] = None,
                       ) -> tuple[int, queue.Queue]:
        """Decode-tier admission: install an exported KV payload straight
        into a slot (no prefill, no queue). A refusal for want of a slot
        or blocks sheds (429), as a full queue does."""
        self._shed_check()
        q: queue.Queue = queue.Queue()
        deadline_s = self._resolve_deadline(deadline_s)
        with self._work:
            if self._engine_error is not None:
                raise EngineFailedError(self._engine_error)
            if self._draining or self._shutdown:
                raise DrainingError("server is draining; retry elsewhere")
            if not hasattr(self.engine, "import_blocks"):
                raise ValueError(
                    "this replica's engine cannot import KV payloads "
                    "(paged engines only)"
                )
            rid = self.engine.import_blocks(
                payload, max_new_tokens=max_tokens,
                temperature=temperature, stop=stop,
                logit_bias=logit_bias, deadline_s=deadline_s,
            )
            if rid is None:
                with self._shed_lock:
                    self._shed += 1
                self._inc("serving_requests_shed_total")
                raise OverloadedError(
                    "no free slot/blocks for KV import; retry elsewhere"
                )
            self._queues[rid] = q
            self._submit_ts[rid] = time.monotonic()
            if tracing.enabled():
                # No queue: the import itself stands in the prefill slot,
                # ended at the first token.
                root = tracing.current_span()
                self._req_spans[rid] = {
                    "root": root,
                    "prefill": tracing.get_tracer("server").begin_span(
                        "kv_import", parent=root, rid=rid,
                        blocks=len(payload.get("blocks") or [])),
                }
            self._work.notify_all()
        return rid, q

    def _cancel(self, rid: int, reason: str = "client disconnected") -> None:
        """Disconnect path: queued requests abort at once, slotted ones
        retire within one engine step. Idempotent."""
        with self._work:
            if self._engine_error is None and not self._stopped:
                self.engine.cancel(rid, reason)
            self._work.notify_all()

    def _finish(self, rid: int) -> None:
        with self._lock:
            self._queues.pop(rid, None)
            self._kv_exports.pop(rid, None)
            # Aborted requests never retire: reap their stamps here.
            self._forget(rid)
            self._end_request_spans(rid)

    def _decode_prompt(self, prompt) -> list[int]:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "text prompt needs a tokenizer; send token ids"
                )
            return list(self.tokenizer(prompt)["input_ids"])
        if (isinstance(prompt, list)
                and all(isinstance(t, int) for t in prompt)):
            return prompt
        raise ValueError("prompt must be a string or a list of token ids")

    def _text(self, tokens: list[int]) -> Optional[str]:
        if self.tokenizer is None:
            return None
        return self.tokenizer.decode(tokens)

    def stats(self) -> dict:
        """The /stats payload."""
        eng = self.engine
        with self._lock:
            active = sum(r is not None for r in eng._by_slot)
            depth = len(eng._queue)
            # Mid-admission work is in neither queue nor slot: one
            # chunked admission, or any number of ragged prompt cursors.
            admitting = int(getattr(eng, "_admitting", None) is not None) \
                + len(getattr(eng, "_ragged_admit", {}))
            pool = None
            if getattr(eng, "num_blocks", None):
                pool = {"num_blocks": eng.num_blocks,
                        "source": getattr(eng, "pool_source", "config")}
            # A tensor-parallel replica spans a mesh; absent (not null)
            # for one-rank engines, so their /stats are unchanged.
            mesh = getattr(eng, "mesh_axes", None)
            rag = None
            # Engines that count their fused dispatches (the ragged
            # PagedBatcher) report them; the ragged ContinuousBatcher
            # keeps no such counters (JAX's server reads them anyway and
            # fails its /stats there).
            if getattr(eng, "ragged", False) and hasattr(eng, "ragged_steps"):
                steps = eng.ragged_steps
                rag = {
                    "batch_fill": round(eng.ragged_fill, 4),
                    "steps": steps,
                    "tokens": eng.ragged_tokens,
                    "tokens_per_step": round(
                        eng.ragged_tokens / steps, 2
                    ) if steps else 0.0,
                }
            pc = None
            if getattr(eng, "_prefix_cache_enabled", False):
                hits, misses = eng.prefix_hits, eng.prefix_misses
                pc = {
                    "hits": hits,
                    "misses": misses,
                    "evictions": eng.prefix_evictions,
                    "cached_blocks": eng.prefix_cached_blocks,
                    "hit_ratio": round(hits / (hits + misses), 4)
                    if hits + misses else 0.0,
                }
            kv = None
            if hasattr(eng, "import_blocks"):
                kv = {
                    "exports": eng.kv_exports,
                    "imports": eng.kv_imports,
                    "import_blocks_reused": eng.kv_import_blocks_reused,
                    "import_blocks_written": eng.kv_import_blocks_written,
                    "chain_exports": eng.kv_chain_exports,
                    "chain_imports": eng.kv_chain_imports,
                }
            swap = None
            if getattr(eng, "swap_bytes_limit", 0):
                swap = {
                    "swap_out": eng.kv_swap_out,
                    "swap_in": eng.kv_swap_in,
                    "restored_tokens": eng.kv_swap_restored_tokens,
                    "swap_bytes": eng.swap_bytes_used,
                    "swap_blocks": eng.swap_blocks,
                    "swap_bytes_limit": eng.swap_bytes_limit,
                }
            # The speculative wrapper's counters and the hot-adapter
            # cache's (None when its residency is uncapped).
            spec = self._spec.spec_stats() if self._spec is not None else None
            lc_fn = getattr(eng, "lora_cache_stats", None)
            lora = lc_fn() if lc_fn is not None else None
            ttft, e2e = list(self._ttft), list(self._e2e)
            queue_wait, itl = list(self._queue_wait), list(self._itl)
            tokens_out = self._tokens_out
            cancelled = self._cancelled
            deadline_expired = self._deadline_expired
        with self._shed_lock:
            shed = self._shed
        fl = self.flight.snapshot()
        if self._stall_profiler is not None:
            fl["stall_profiles"] = self._stall_profiler.summary()
        up = (time.monotonic() - self._started_at
              if self._started_at is not None else 0.0)
        return {
            "active_slots": active,
            "queued": depth,
            "admitting": admitting,
            "slots": eng.slots,
            "served": self._served,
            "tokens_generated": tokens_out,
            "tokens_per_sec_lifetime": round(tokens_out / up, 2)
            if up > 0 else 0.0,
            "ttft_s": _percentiles(ttft),
            "e2e_latency_s": _percentiles(e2e),
            "queue_wait_s": _percentiles(queue_wait),
            "inter_token_s": _percentiles(itl),
            "requests_shed": shed,
            "requests_cancelled": cancelled,
            "deadline_expired": deadline_expired,
            "max_queue_depth": self.max_queue_depth,
            "draining": self._draining,
            "drain_duration_s": self._drain_duration,
            "tier_role": self.tier_role,
            **({"kv_handoff": kv} if kv is not None else {}),
            **({"kv_swap": swap} if swap is not None else {}),
            **({"kv_pool": pool} if pool is not None else {}),
            **({"mesh": mesh} if mesh is not None else {}),
            **({"ragged": rag} if rag is not None else {}),
            **({"speculative": spec} if spec is not None else {}),
            **({"lora_cache": lora} if lora is not None else {}),
            **({"prefix_cache": pc} if pc is not None else {}),
            "engine_step_stalls": fl["stalls"],
            "flight": fl,
        }

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # One request per connection: an idle keep-alive connection
            # would pin a handler thread with no read timeout.
            protocol_version = "HTTP/1.1"

            # Correlation id of a POST's responses (X-Request-Id, and a
            # truncated stream's error event): the caller's, else the
            # trace id, else a fresh id.
            _req_id = None

            def log_message(self, *args):  # quiet by default
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                if self._req_id:
                    self.send_header("X-Request-Id", self._req_id)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def _retry_after_close(self, error: str,
                                   retry_after: int = 1) -> None:
                body = json.dumps({"error": error}).encode()
                self.send_header("Retry-After", str(retry_after))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    if server._engine_error is not None:
                        self._json(503, {"status": "engine failed",
                                         "error": server._engine_error})
                    elif server._draining:
                        self._json(503, {"status": "draining"})
                    else:
                        self._json(200, {"status": "ok"})
                elif self.path == "/v1/models":
                    ids = [server.model_name] + list(
                        getattr(server.engine, "adapter_names", []))
                    self._json(200, {
                        "object": "list",
                        "data": [{"id": i, "object": "model"} for i in ids],
                    })
                elif self.path == "/stats":
                    self._json(200, server.stats())
                elif self.path == "/debug/traces":
                    ring = tracing.trace_ring()
                    self._json(200, {
                        "traces": ring.snapshot() if ring else [],
                    })
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                route = {
                    "/v1/completions": self._completions,
                    "/kv/prefill": self._kv_prefill,
                    "/kv/probe": self._kv_probe,
                    "/kv/chain": self._kv_chain,
                    "/kv/chain/import": self._kv_chain_import,
                }.get(self.path)
                if route is None:
                    self._json(404, {"error": "not found"})
                    return
                # The replica's root span joins the caller's trace (a
                # gateway hop's traceparent), so one export holds the
                # gateway → server → engine chain; /kv/* hops join too.
                with tracing.get_tracer("server").start_span(
                        "server.request",
                        traceparent=self.headers.get("traceparent")) as span:
                    self._req_id = (self.headers.get("x-request-id")
                                    or span.trace_id
                                    or tracing.new_trace_id())
                    route(span)

            def _kv_body(self, parse, limit=None):
                """Read and parse a /kv/* body (at most ``limit`` bytes,
                ``max_body_bytes`` by default): ``parse(req)`` returns
                what the hop needs. Answers 413 or 400 itself and returns
                None then."""
                try:
                    body = _read_body(self, limit or server.max_body_bytes)
                    return parse(json.loads(body or b"{}"))
                except BodyTooLarge as err:
                    self._json(413, {"error": str(err)})
                except (ValueError, json.JSONDecodeError) as err:
                    self._json(400, {"error": str(err)})
                return None

            def _kv_probe(self, span):
                """How many leading blocks of the chain ``keys`` (hex, in
                chain order) this replica holds, swap-resident ones
                included (an import promotes them), with the wire bytes a
                block costs. Nothing is pinned: an eviction may race the
                import, which then answers 409."""
                raw = self._kv_body(lambda req: _chain_keys_field(req, "keys"))
                if raw is None:
                    return
                matched = 0
                block_bytes = 0
                eng = server.engine
                with server._lock:
                    if getattr(eng, "_prefix_cache_enabled", False):
                        for k in raw:
                            if (k not in eng._prefix_entries
                                    and not eng.swap_contains(k)):
                                break
                            matched += 1
                    if hasattr(eng, "chain_block_bytes"):
                        block_bytes = int(eng.chain_block_bytes())
                span.set_attribute("kv_probe_matched", matched)
                self._json(200, {
                    "matched": matched,
                    "block_bytes": block_bytes,
                    "payload_bytes": matched * block_bytes,
                })

            def _kv_chain(self, span):
                """Export the longest held prefix of ``keys`` straight
                from the prefix cache (swap-resident links promoted
                first); the chains stay registered here."""
                raw = self._kv_body(lambda req: _chain_keys_field(req, "keys"))
                if raw is None:
                    return
                export = getattr(server.engine, "export_chain", None)
                if export is None or not raw:
                    self._json(200, {"matched": 0, "payload": None})
                    return
                try:
                    with server._lock:
                        payload = export(raw)
                except RuntimeError as err:
                    self._json(409, {"error": str(err)})
                    return
                matched = len(payload["blocks"]) if payload else 0
                span.set_attribute("kv_chain_blocks", matched)
                self._json(200, {"matched": matched, "payload": payload})

            def _kv_chain_import(self, span):
                """Validate and register an exported chain against the
                request's own prompt ``tokens``; a bad payload is a 400
                (the fetcher falls back to a local prefill)."""
                def parse(req):
                    tokens = req.get("tokens")
                    if not (isinstance(tokens, list) and tokens and all(
                            isinstance(t, int) and not isinstance(t, bool)
                            for t in tokens)):
                        raise ValueError(
                            "tokens must be a non-empty list of ints")
                    return tokens, req.get("payload")

                parsed = self._kv_body(parse, server.max_kv_body_bytes)
                if parsed is None:
                    return
                tokens, payload = parsed
                imp = getattr(server.engine, "import_chain", None)
                if imp is None:
                    self._json(409, {
                        "error": "this replica's engine cannot import "
                                 "cache chains"
                    })
                    return
                try:
                    with server._lock:
                        registered = imp(payload, tokens)
                except ValueError as err:
                    self._json(400, {"error": str(err)})
                    return
                span.set_attribute("kv_chain_registered", registered)
                self._json(200, {"registered": registered})

            def _kv_prefill(self, span):
                """The prefill tier's hop: prefill the prompt, sample ONE
                token, and cut the KV payload at that first token. The
                request retires at once (its chains stay registered
                here); a request that finishes at its first token (EOS, a
                one-token stop) needs no decode hop."""
                try:
                    body = _read_body(self, server.max_body_bytes)
                except BodyTooLarge as err:
                    self._json(413, {"error": str(err)})
                    return
                except ValueError as err:
                    self._json(400, {"error": str(err)})
                    return
                try:
                    req = json.loads(body or b"{}")
                    prompt = server._decode_prompt(req.get("prompt"))
                    skip = req.get("skip_keys") or []
                    if not isinstance(skip, list) or not all(
                            isinstance(k, str) for k in skip):
                        raise ValueError(
                            "skip_keys must be a list of hex strings")
                    temperature = req.get("temperature")
                    stop = server._decode_stop(req.get("stop"))
                    logit_bias = _logit_bias_field(req)
                    deadline_s = _deadline_field(req)
                    if not hasattr(server.engine, "export_blocks"):
                        raise ValueError(
                            "this replica's engine cannot export KV "
                            "payloads (prefix_cache paged engines only)"
                        )
                except (ValueError, TypeError, json.JSONDecodeError) as err:
                    self._json(400, {"error": str(err)})
                    return
                span.set_attribute("prompt_tokens", len(prompt))
                span.set_attribute("kv_prefill", True)
                try:
                    rid, q = server._submit(
                        prompt, 1, req.get("model"), temperature, stop,
                        logit_bias, deadline_s, kv_export=frozenset(skip),
                    )
                except OverloadedError as err:
                    self.send_response(429)
                    self._retry_after_close(str(err))
                    return
                except DrainingError as err:
                    self.send_response(503)
                    self._retry_after_close(str(err))
                    return
                except EngineFailedError as err:
                    self._json(503, {"error": str(err)})
                    return
                except ValueError as err:
                    self._json(400, {"error": str(err)})
                    return
                # The registry entry outlives _finish's pop: take the
                # reference now, read it once the final item lands.
                exp = server._kv_exports.get(rid)
                try:
                    tokens: list = []
                    while True:
                        try:
                            item = q.get(timeout=0.25)
                        except queue.Empty:
                            if _client_gone(self.connection):
                                server._cancel(rid)
                                return
                            continue
                        if isinstance(item, (_Final, _Abort)):
                            break
                        tokens.append(item)
                    if isinstance(item, _Abort):
                        code = 504 if item.reason == "deadline" else 500
                        self._json(code, {"error": item.reason,
                                          "partial_tokens": tokens})
                        return
                    if exp is not None and exp["error"] is not None:
                        self._json(500, {"error": exp["error"]})
                        return
                    self._json(200, {
                        "id": f"cmpl-{rid}",
                        "payload": exp["payload"] if exp else None,
                        "finished": {
                            "tokens": item.tokens,
                            "logprobs": item.logprobs,
                            "finish_reason": item.finish_reason,
                        },
                    })
                finally:
                    server._finish(rid)

            def _completions(self, span):
                plain, kv = server.max_body_bytes, server.max_kv_body_bytes
                req = None
                try:
                    body = _read_body(self, max(plain, kv))
                    if len(body) > min(plain, kv):
                        # A body that carries a KV payload has its own cap.
                        try:
                            req = json.loads(body)
                            carries = (isinstance(req, dict) and
                                       req.get("kv_import") is not None)
                        except ValueError:
                            carries = False
                        limit = kv if carries else plain
                        if len(body) > limit:
                            raise BodyTooLarge(len(body), limit)
                except BodyTooLarge as err:
                    self._json(413, {"error": str(err)})
                    return
                except ValueError as err:
                    self._json(400, {"error": str(err)})
                    return
                try:
                    if req is None:
                        req = json.loads(body or b"{}")
                    kv_import = req.get("kv_import")
                    if kv_import is not None and not isinstance(
                            kv_import, dict):
                        raise ValueError(
                            "kv_import must be an exported KV payload "
                            "object"
                        )
                    if kv_import is not None:
                        # The payload carries the prompt (usage counts).
                        prompt = [
                            int(t) for t in kv_import.get("tokens") or []
                        ]
                    else:
                        prompt = server._decode_prompt(req.get("prompt"))
                    max_tokens = req.get("max_tokens")
                    if max_tokens is not None and (
                        not isinstance(max_tokens, int)
                        or isinstance(max_tokens, bool)
                    ):
                        raise ValueError(
                            f"max_tokens must be an integer, got "
                            f"{max_tokens!r}"
                        )
                    # temperature is validated by the engine's submit().
                    temperature = req.get("temperature")
                    n = req.get("n", 1)
                    if not isinstance(n, int) or isinstance(n, bool) or (
                        not 1 <= n <= 64
                    ):
                        raise ValueError(
                            f"n must be an integer in [1, 64], got {n!r}"
                        )
                    stop = server._decode_stop(req.get("stop"))
                    logit_bias = _logit_bias_field(req)
                    deadline_s = _deadline_field(req)
                    stream = bool(req.get("stream", False))
                    if stream and n > 1:
                        raise ValueError("stream does not support n > 1")
                    want_logprobs = bool(req.get("logprobs", False))
                    if want_logprobs and stream:
                        raise ValueError("stream does not support logprobs")
                    if want_logprobs and not getattr(
                        server.engine, "supports_logprobs", False
                    ):
                        raise ValueError(
                            "this engine does not compute logprobs "
                            "(speculative serving verifies argmax rounds)"
                        )
                    if kv_import is not None and n != 1:
                        raise ValueError("kv_import does not support n > 1")
                except (ValueError, TypeError, json.JSONDecodeError) as err:
                    self._json(400, {"error": str(err)})
                    return
                span.set_attribute("stream", stream)
                span.set_attribute("n", n)
                span.set_attribute("prompt_tokens", len(prompt))
                subs = []
                try:
                    try:
                        if kv_import is not None:
                            subs.append(server._submit_import(
                                kv_import, max_tokens, temperature, stop,
                                logit_bias, deadline_s,
                            ))
                        for _ in range(n if kv_import is None else 0):
                            subs.append(server._submit(
                                prompt, max_tokens, req.get("model"),
                                temperature, stop, logit_bias, deadline_s,
                            ))
                    except OverloadedError as err:
                        # Already-submitted sibling choices are dead work.
                        for rid, _ in subs:
                            server._cancel(rid, "sibling choice shed")
                        self.send_response(429)
                        self._retry_after_close(str(err))
                        return
                    except DrainingError as err:
                        for rid, _ in subs:
                            server._cancel(rid, "sibling choice refused")
                        self.send_response(503)
                        self._retry_after_close(str(err))
                        return
                    except EngineFailedError as err:
                        self._json(503, {"error": str(err)})
                        return
                    except ValueError as err:  # over-bucket prompt etc.
                        for rid, _ in subs:
                            server._cancel(rid, "sibling choice refused")
                        self._json(400, {"error": str(err)})
                        return
                    except KeyError as err:
                        # A stub whose chain is no longer cached here:
                        # resend with full data, or route fused.
                        self._json(409, {"error": str(err)})
                        return
                    if stream:
                        self._stream(*subs[0])
                    else:
                        self._complete(subs, len(prompt), want_logprobs)
                finally:
                    for rid, _ in subs:
                        server._finish(rid)

            def _complete(self, subs, prompt_len, want_logprobs=False):
                choices = []
                for idx, (rid, q) in enumerate(subs):
                    tokens = []
                    while True:
                        try:
                            # The timed get doubles as a disconnect poll.
                            item = q.get(timeout=0.25)
                        except queue.Empty:
                            if _client_gone(self.connection):
                                for r, _ in subs:
                                    server._cancel(r)
                                return  # nobody to answer
                            continue
                        if isinstance(item, (_Final, _Abort)):
                            break
                        tokens.append(item)
                    logprobs = []
                    finish_reason = "stop"
                    if isinstance(item, _Final):
                        tokens = item.tokens
                        logprobs = item.logprobs
                        finish_reason = item.finish_reason
                    server._finish(rid)
                    if isinstance(item, _Abort):
                        code = 504 if item.reason == "deadline" else 500
                        self._json(code, {"error": item.reason,
                                          "partial_tokens": tokens})
                        return
                    choice = {"index": idx, "tokens": tokens,
                              "finish_reason": finish_reason}
                    if want_logprobs:
                        choice["logprobs"] = {
                            "tokens": tokens,
                            "token_logprobs": logprobs,
                        }
                    text = server._text(tokens)
                    if text is not None:
                        choice["text"] = text
                    choices.append(choice)
                total = sum(len(c["tokens"]) for c in choices)
                self._json(200, {
                    "id": f"cmpl-{subs[0][0]}",
                    "object": "text_completion",
                    "model": server.model_name,
                    "choices": choices,
                    "usage": {
                        "prompt_tokens": prompt_len,
                        "completion_tokens": total,
                        "total_tokens": prompt_len + total,
                    },
                })

            def _stream(self, rid, q):
                try:
                    self.send_response(200)
                    if self._req_id:
                        self.send_header("X-Request-Id", self._req_id)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    while True:
                        item = q.get()
                        # Peek for the client's FIN before each write: a
                        # write into a dead socket fails only later.
                        if _client_gone(self.connection):
                            server._cancel(rid)
                            return
                        if isinstance(item, (_Final, _Abort)):
                            server._finish(rid)
                            if isinstance(item, _Abort):
                                # The request id joins a truncated stream
                                # to the trace export.
                                self.wfile.write(
                                    b"data: " + json.dumps(
                                        {"error": item.reason,
                                         "request_id": self._req_id}
                                    ).encode() + b"\n\n"
                                )
                            self.wfile.write(b"data: [DONE]\n\n")
                            self.wfile.flush()
                            return
                        payload = {"id": f"cmpl-{rid}", "token": item}
                        text = server._text([item])
                        if text is not None:
                            payload["text"] = text
                        self.wfile.write(
                            b"data: " + json.dumps(payload).encode()
                            + b"\n\n"
                        )
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    server._cancel(rid)

        return Handler
