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
  ``stop``, ``logit_bias``, ``logprobs``, ``deadline_s``, ``model`` (the
  served name only), ``stream`` (``text/event-stream`` lines
  ``data: {"id", "token"}`` ending ``data: [DONE]``, an error event first
  on abort);
- ``GET /healthz`` (503 once the engine thread died or a drain started),
  ``GET /v1/models``, ``GET /stats`` (the engine and latency keys below,
  under the JAX server's names).

Request lifecycle: ``max_queue_depth`` sheds with 429 + Retry-After
without taking the engine lock; ``max_body_bytes`` caps Content-Length
(413); per-request deadlines retire the slot at the next step (504 with
partial tokens); a client that disconnects cancels its requests;
``stop()`` drains for ``drain_s`` (503 to new submits) and then aborts
stragglers; an engine failure aborts every waiting request and turns
/healthz red.

Not here yet: tracing spans, the flight recorder, Prometheus mirroring,
the ``/kv/*`` handoff endpoints, LoRA routing and speculative stats.
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

# The port's own copies of the env contract names it reads (the JAX
# package's api/annotations.py and webhook/tpu_env.py).
KUBEFLOW_TPU_SERVING_PORT = "KUBEFLOW_TPU_SERVING_PORT"
KUBEFLOW_TPU_SERVING_RAGGED = "KUBEFLOW_TPU_SERVING_RAGGED"
KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET = "KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET"
KUBEFLOW_TPU_KV_BITS = "KUBEFLOW_TPU_KV_BITS"


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
    """The ``kv_bits`` keyword for PagedBatcher from KUBEFLOW_TPU_KV_BITS
    (unset keeps the engine default). Raises on garbage."""
    kw: dict = {}
    raw = os.environ.get(KUBEFLOW_TPU_KV_BITS, "").strip()
    if raw:
        if raw not in ("0", "8"):
            raise ValueError(
                f"{KUBEFLOW_TPU_KV_BITS}={raw!r}: want 0 (bf16) or 8 "
                "(int8 values + bf16 scales)"
            )
        kw["kv_bits"] = int(raw)
    return kw


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
                 default_deadline_s: Optional[float] = None,
                 max_deadline_s: Optional[float] = None,
                 drain_s: float = 5.0):
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, got "
                             f"{max_queue_depth}")
        self.max_queue_depth = max_queue_depth
        self.max_body_bytes = max_body_bytes
        self.default_deadline_s = default_deadline_s
        self.max_deadline_s = max_deadline_s
        self.drain_s = drain_s
        self.engine = engine
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
        engine.on_token = self._on_token
        engine.on_retire = self._on_retire
        engine.on_abort = self._on_abort
        engine.on_admit = self._on_admit

    # -- engine side (all under self._lock) --------------------------------

    def _on_admit(self, rid: int) -> None:
        t0 = self._submit_ts.get(rid)
        if t0 is not None:
            self._queue_wait.append(time.monotonic() - t0)

    def _on_token(self, rid: int, token: int) -> None:
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
        q = self._queues.get(rid)
        if q is not None:
            q.put(token)

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
        q = self._queues.get(rid)
        if q is not None:
            q.put(_Final(list(tokens), list(logprobs), finish_reason))

    def _on_abort(self, rid: int, tokens: list, reason: str) -> None:
        if reason == "deadline":
            self._deadline_expired += 1
        else:
            self._cancelled += 1
        self._forget(rid)
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
                    self.engine.drive_once()
                except Exception as err:  # device OOM, a failed launch, ...
                    # The engine is in an unknown state: abort every
                    # waiting request, flip /healthz red, stop driving.
                    self._engine_error = f"{type(err).__name__}: {err}"
                    abort = _Abort(self._engine_error)
                    for q in self._queues.values():
                        q.put(abort)
                    return

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
                ) -> tuple[int, queue.Queue]:
        self._shed_check()
        q: queue.Queue = queue.Queue()
        deadline_s = self._resolve_deadline(deadline_s)
        with self._work:
            if self._engine_error is not None:
                raise EngineFailedError(self._engine_error)
            if self._draining or self._shutdown:
                raise DrainingError("server is draining; retry elsewhere")
            if model is not None and model != self.model_name:
                raise ValueError(
                    f"unknown model {model!r} (this server serves "
                    f"{self.model_name!r})"
                )
            rid = self.engine.submit(prompt, max_new_tokens=max_tokens,
                                     temperature=temperature, stop=stop,
                                     logit_bias=logit_bias,
                                     deadline_s=deadline_s)
            self._queues[rid] = q
            self._submit_ts[rid] = time.monotonic()
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
            # Aborted requests never retire: reap their stamps here.
            self._forget(rid)

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
            ttft, e2e = list(self._ttft), list(self._e2e)
            queue_wait, itl = list(self._queue_wait), list(self._itl)
            tokens_out = self._tokens_out
            cancelled = self._cancelled
            deadline_expired = self._deadline_expired
        with self._shed_lock:
            shed = self._shed
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
            **({"kv_pool": pool} if pool is not None else {}),
            **({"ragged": rag} if rag is not None else {}),
        }

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # One request per connection: an idle keep-alive connection
            # would pin a handler thread with no read timeout.
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet by default
                pass

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
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
                    self._json(200, {
                        "object": "list",
                        "data": [{"id": server.model_name,
                                  "object": "model"}],
                    })
                elif self.path == "/stats":
                    self._json(200, server.stats())
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/completions":
                    self._json(404, {"error": "not found"})
                    return
                self._completions()

            def _completions(self):
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
                    logit_bias = req.get("logit_bias")
                    if logit_bias is not None and not isinstance(
                        logit_bias, dict
                    ):
                        raise ValueError(
                            "logit_bias must be an object mapping token "
                            "ids to biases"
                        )
                    deadline_s = req.get("deadline_s")
                    if deadline_s is not None and (
                        isinstance(deadline_s, bool)
                        or not isinstance(deadline_s, (int, float))
                        or not math.isfinite(deadline_s)
                        or deadline_s <= 0
                    ):
                        raise ValueError(
                            f"deadline_s must be a finite number > 0, "
                            f"got {deadline_s!r}"
                        )
                    stream = bool(req.get("stream", False))
                    if stream and n > 1:
                        raise ValueError("stream does not support n > 1")
                    want_logprobs = bool(req.get("logprobs", False))
                    if want_logprobs and stream:
                        raise ValueError("stream does not support logprobs")
                except (ValueError, TypeError, json.JSONDecodeError) as err:
                    self._json(400, {"error": str(err)})
                    return
                subs = []
                try:
                    try:
                        for _ in range(n):
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
                                self.wfile.write(
                                    b"data: " + json.dumps(
                                        {"error": item.reason}
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
