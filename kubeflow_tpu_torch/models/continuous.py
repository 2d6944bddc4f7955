"""Request lifecycle shared by the batching engines.

Counterpart of the host-side half of ``kubeflow_tpu/models/continuous.py``
— ``_Request``, ``_AdmissionCursor`` and ``_BatcherBase`` — kept as the
port's own copy (the JAX module imports JAX at module level). It owns the
request queue and ids, submit validation, cancel and deadlines, the drive
loop, the ``on_token``/``on_retire``/``on_abort``/``on_admit`` hooks and
per-token retirement (EOS, stop sequences, budget). Subclasses provide
``_admit_free_slots``, ``_step`` and ``_release_slot``.

Not here yet: ``ContinuousBatcher`` (the dense-cache engine) and the
tracing span and flight-recorder sample around ``drive_once``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.models.serving import GenerationConfig


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: list[int]
    tokens: list[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    # Per-request cap (None = the engine-wide gen.max_new_tokens); admits
    # clamp to the engine-wide value, which sizes the block tables.
    max_new: Optional[int] = None
    # Per-request sampling temperature (None = gen.temperature; 0 = greedy
    # for this row). top_k/top_p stay engine-wide.
    temperature: Optional[float] = None
    # Stop sequences (token-id tuples); on a suffix match the request
    # retires with the sequence EXCLUDED from its output (OpenAI).
    stop: tuple = ()
    # Chosen-token log-probabilities, aligned with ``tokens``.
    logprobs: list = dataclasses.field(default_factory=list)
    # {token_id: bias} added to the row's logits before sampling.
    logit_bias: Optional[dict] = None
    # Paged engine: physical block ids this request holds, in position
    # order.
    blocks: list[int] = dataclasses.field(default_factory=list)
    # Absolute monotonic deadline (None = none); an expired request
    # retires through the abort path at its next emitted token.
    deadline: Optional[float] = None


class _AdmissionCursor:
    """Prompt-prefill cursor for one in-flight admission: the next
    position of the left-padded prompt to prefill. The ragged scheduler
    takes variable-width pieces under its token budget."""

    def __init__(self, mask_row, bucket: int) -> None:
        self.bucket = int(bucket)
        row = np.asarray(mask_row).reshape(-1)[: self.bucket]
        # Left-padding puts all pads FIRST: start at the first real token
        # (pure-pad pieces would be masked work).
        self.pos = int(np.argmax(row)) if row.any() else 0

    @property
    def done(self) -> bool:
        return self.pos >= self.bucket

    def take(self, width: int) -> tuple[int, int]:
        """Claim the next up-to-``width`` positions: returns (start, n)
        and advances the cursor past them."""
        start = self.pos
        n = min(int(width), self.bucket - start)
        self.pos = start + n
        return start, n


class _BatcherBase:
    """Host-side scaffolding of the batching engines: request queue/ids,
    submit validation, the drive loop, and per-token retirement.
    Subclasses set ``cfg`` and ``device`` and provide
    ``_admit_free_slots``, ``_step`` and ``_release_slot``."""

    def _init_base(self, gen: GenerationConfig, slots: int,
                   prompt_bucket: int) -> None:
        self.gen = gen
        self.slots = slots
        self.prompt_bucket = prompt_bucket
        # Per-slot effective temperature, uploaded with each step.
        self.temps = np.full((slots,), gen.temperature, np.float32)
        # Per-slot logit-bias rows on the device, allocated on the first
        # biased request (None keeps the step bias-free).
        self._bias = None
        self._queue: list[_Request] = []
        self._by_slot: list[Optional[_Request]] = [None] * slots
        self._results: dict[int, list[int]] = {}
        self._result_logprobs: dict[int, list[float]] = {}
        # rid → abort reason for requests retired WITHOUT completing.
        self._aborted: dict[int, str] = {}
        self._next_rid = 0
        # Serving-frontend hooks (models/server.py), called under the
        # frontend's engine lock: on_token(rid, token) per emitted token;
        # on_retire(rid, tokens, logprobs, finish_reason) on completion
        # (completed requests are then delivered, not accumulated);
        # on_abort(rid, tokens, reason) on cancel/deadline; on_admit(rid)
        # when a queued request is popped for admission.
        self.on_token = None
        self.on_retire = None
        self.on_abort = None
        self.on_admit = None
        # What the most recent drive quantum did (fill ratio, decode/
        # prefill row split), stamped by the engine's step.
        self.last_step: dict = {}
        # rid → reason for requests cancelled while holding a slot or
        # mid-admission: retired at the next step. Mutated only under the
        # frontend's engine lock.
        self._cancelled: dict[int, str] = {}
        # Injectable time source (tests drive deadlines with a fake clock).
        self._clock = time.monotonic

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               stop: Optional[Sequence[Sequence[int]]] = None,
               logit_bias: Optional[dict] = None,
               deadline_s: Optional[float] = None) -> int:
        req = self._build_request(
            prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            stop=stop, logit_bias=logit_bias, deadline_s=deadline_s,
        )
        self._queue.append(req)
        return req.rid

    def _build_request(self, prompt: Sequence[int],
                       max_new_tokens: Optional[int] = None,
                       temperature: Optional[float] = None,
                       stop: Optional[Sequence[Sequence[int]]] = None,
                       logit_bias: Optional[dict] = None,
                       deadline_s: Optional[float] = None) -> _Request:
        """Validate client-supplied sampling fields and mint a _Request
        with a fresh rid."""
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.prompt_bucket:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds bucket "
                f"{self.prompt_bucket} (raise prompt_bucket)"
            )
        if max_new_tokens is not None and max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be > 0, got {max_new_tokens}")
        if temperature is not None and (
            not isinstance(temperature, (int, float))
            or isinstance(temperature, bool)
            or not math.isfinite(temperature) or temperature < 0
        ):
            # isfinite: JSON's NaN/Infinity parse as floats and pass a
            # bare `< 0` check.
            raise ValueError(
                f"temperature must be a finite number >= 0, got "
                f"{temperature!r}"
            )
        stop_seqs: tuple = ()
        if stop:
            stop_seqs = tuple(tuple(int(t) for t in seq) for seq in stop)
            if (not all(stop_seqs) or len(stop_seqs) > 8
                    or any(len(s) > 64 for s in stop_seqs)):
                # Bounded: the suffix compare runs per emitted token under
                # the engine lock.
                raise ValueError(
                    "stop must be 1..8 non-empty token-id sequences of "
                    "at most 64 tokens each"
                )
        bias = None
        if logit_bias:
            bias = {}
            for tok, b in logit_bias.items():
                tok = int(tok)
                if not 0 <= tok < self.cfg.vocab_size:
                    raise ValueError(
                        f"logit_bias token {tok} outside vocab "
                        f"[0, {self.cfg.vocab_size})"
                    )
                b = float(b)
                if not math.isfinite(b):
                    raise ValueError(f"logit_bias value {b!r} not finite")
                # OpenAI clamps to ±100 (±100 effectively forces/bans).
                bias[tok] = max(-100.0, min(100.0, b))
        if deadline_s is not None and (
            not isinstance(deadline_s, (int, float))
            or isinstance(deadline_s, bool)
            or not math.isfinite(deadline_s) or deadline_s <= 0
        ):
            raise ValueError(
                f"deadline_s must be a finite number > 0, got "
                f"{deadline_s!r}"
            )
        rid = self._next_rid
        self._next_rid += 1
        return _Request(
            rid, list(prompt), max_new=max_new_tokens,
            temperature=None if temperature is None else float(temperature),
            stop=stop_seqs, logit_bias=bias,
            deadline=None if deadline_s is None
            else self._clock() + float(deadline_s),
        )

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Retire ``rid`` without completing it. A queued request aborts
        immediately; one holding a slot or mid-admission is marked and
        retired within one engine step. Call under the lock that
        serializes the drive loop. False when the rid is unknown or
        already retired."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                self._deliver_abort(req, reason)
                return True
        for a in getattr(self, "_ragged_admit", {}).values():
            if a["req"].rid == rid:
                self._cancelled[rid] = reason
                return True
        for req in self._by_slot:
            if req is not None and req.rid == rid:
                self._cancelled[rid] = reason
                return True
        return False

    def _deliver_abort(self, req: _Request, reason: str) -> None:
        if self.on_abort is not None:
            self.on_abort(req.rid, req.tokens, reason)
        else:
            # Drive-to-completion callers still get the partial output;
            # run_aborted() names the reason.
            self._results[req.rid] = req.tokens
            self._result_logprobs[req.rid] = req.logprobs
            self._aborted[req.rid] = reason

    def _abort_slot(self, slot: int, reason: str) -> None:
        req = self._by_slot[slot]
        self._deliver_abort(req, reason)
        self._release_slot(slot)

    def run_aborted(self) -> dict[int, str]:
        """{rid: reason} for requests the most recent run() aborted."""
        return getattr(self, "_last_aborted", {})

    def _initial_budget(self, req: _Request) -> int:
        """Per-request budget at admit time, clamped to the engine-wide
        max (the block tables are sized for gen.max_new_tokens)."""
        if req.max_new is None:
            return self.gen.max_new_tokens
        return min(req.max_new, self.gen.max_new_tokens)

    def _install_bias(self, slot: int, req: _Request):
        """Write the slot's logit-bias row (zeros for unbiased requests,
        so a stale row never leaks) into the device-resident (slots, V)
        array; returns the row, or None for an unbiased request."""
        if req.logit_bias is None and self._bias is None:
            return None
        if self._bias is None:
            self._bias = torch.zeros((self.slots, self.cfg.vocab_size),
                                     dtype=torch.float32, device=self.device)
        row = np.zeros((self.cfg.vocab_size,), np.float32)
        for tok, b in (req.logit_bias or {}).items():
            row[tok] = b
        row = torch.from_numpy(row).to(self.device)
        self._bias[slot] = row
        return row if req.logit_bias else None

    def _pending(self) -> bool:
        """Work exists: queued, decoding, or mid-admission."""
        return (
            bool(self._queue)
            or any(r is not None for r in self._by_slot)
            or bool(getattr(self, "_ragged_admit", {}))
        )

    def _pop_queue(self) -> _Request:
        """THE queue→admission transition: on_admit fires exactly once per
        request at batcher pickup."""
        req = self._queue.pop(0)
        if self.on_admit is not None:
            self.on_admit(req.rid)
        return req

    def drive_once(self) -> None:
        """One drive quantum (admit + step), shared by run() and the
        serving frontend's engine thread."""
        self.last_step = {}
        self._admit_free_slots()
        self._step()

    def run(self) -> dict[int, list[int]]:
        """Drive until queue and slots drain; returns {rid: tokens}."""
        while self._pending():
            self.drive_once()
        out, self._results = self._results, {}
        self._last_logprobs, self._result_logprobs = (
            self._result_logprobs, {}
        )
        self._last_aborted, self._aborted = self._aborted, {}
        return out

    def run_logprobs(self) -> dict[int, list[float]]:
        """Chosen-token logprobs for the most recent run(), {rid: [lp]}."""
        return getattr(self, "_last_logprobs", {})

    def _note_token(self, slot: int, token: int,
                    logprob: Optional[float] = None) -> None:
        """Record a sampled token; retire on cancel/deadline (abort), EOS,
        a stop-sequence match or an exhausted budget; otherwise feed it
        back as the slot's next input."""
        req = self._by_slot[slot]
        if req is None:
            return
        # Retire-before-emit: a cancelled or expired request must not hold
        # its slot another step, nor read as a completion.
        reason = self._cancelled.pop(req.rid, None)
        if reason is None and req.deadline is not None \
                and self._clock() >= req.deadline:
            reason = "deadline"
        if reason is not None:
            self._abort_slot(slot, reason)
            return
        req.budget -= 1
        if token == self.gen.eos_id:
            self._retire(slot)
            return
        req.tokens.append(token)
        if logprob is not None:
            req.logprobs.append(logprob)
        if self.on_token is not None:
            self.on_token(req.rid, token)
        for seq in req.stop:
            if (len(req.tokens) >= len(seq)
                    and tuple(req.tokens[-len(seq):]) == seq):
                # OpenAI semantics: the stop sequence is excluded.
                del req.tokens[-len(seq):]
                del req.logprobs[len(req.tokens):]
                self._retire(slot)
                return
        if req.budget <= 0:
            # Budget exhaustion is truncation: finish_reason "length".
            self._retire(slot, finish_reason="length")
            return
        self.tokens[slot, 0] = token

    def _retire(self, slot: int, finish_reason: str = "stop") -> None:
        req = self._by_slot[slot]
        if self.on_retire is not None:
            self.on_retire(req.rid, req.tokens, req.logprobs, finish_reason)
        else:
            self._results[req.rid] = req.tokens
            self._result_logprobs[req.rid] = req.logprobs
        self._release_slot(slot)
