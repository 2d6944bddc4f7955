"""Continuous batching over a dense per-slot cache, and the request
lifecycle shared by the batching engines.

Counterpart of ``kubeflow_tpu/models/continuous.py``. ``_Request``,
``_AdmissionCursor`` and ``_BatcherBase`` own the request queue and ids,
submit validation, cancel and deadlines, the drive loop, the
``on_token``/``on_retire``/``on_abort``/``on_admit`` hooks and per-token
retirement (EOS, stop sequences, budget); subclasses provide
``_admit_free_slots``, ``_step`` and ``_release_slot``.

``ContinuousBatcher`` keeps a fixed pool of B cache SLOTS stepping
together in one stacked cache ``(L, B, Hkv, cache_len, D)``; a finished
request frees its slot and the next queued prompt is admitted at once.
Admission is one-shot (``_admit_slot``: a flash prefill straight into the
slot's rows), chunked (``admit_chunk``: ``_admit_chunk`` pieces into a
1-row cache with a decode step between pieces, then ``_install_rows``), or
ragged (``ragged=True``: the pieces ride ``_cb_ragged_step`` beside the
decode rows). Each decode step (``_cb_step``) runs every slot at its own
position; with ``attn_kernel`` it attends through
``ops/paged_attention.py``'s ``dense_decode_attention`` (the CUDA kernel
on the card, reading each slot's filled prefix only), else through
``_gqa_decode_attention``. The engine methods look the step functions up
in this module at each call. Caches and the validity mask are updated IN
PLACE on the device; positions, tokens and temperatures are host numpy,
uploaded once per step; the per-step readback is the (B,) next tokens and
their logprobs.

``drive_once`` (admit + step) is timed on the engine's clock and fed to
an attached flight recorder (``observability/flight.py``); with a
recording tracer installed it runs inside an ``engine.step`` span that
carries ``last_step``. Each step ends in the readback of its sampled
tokens, so the host's time covers the card's work too.

``plan=`` (a MeshPlan of tp, fsdp and dp, ``models/tp_serving.py``)
makes the engine one rank of a sharded replica: the weights are this
rank's shard (``MeshPlan.shard_params``; fsdp's pieces gathered where the
forward uses them), the cache holds the rank's kv heads,
``(L, B, Hkv/tp, C, D)``, and every rank runs the same calls in lockstep
(the step replicated over dp and fsdp, as JAX's).
What differs from JAX there: JAX refuses ``attn_kernel=True`` with a plan
and defaults it off (its Pallas call is single-device under GSPMD); a
rank's cache here is its own, so the dense kernel keeps its one-card
default (on, on the card) and accepts True under a pure-tp plan.

Under an sp axis (with or without tp) the cache is cut over the
sequence: a rank holds ``cache_len / sp`` consecutive positions of every
slot, ``(L, B, Hkv/tp, C/sp, D)``, and its columns of the validity mask.
A one-shot admission prefills the whole prompt on every rank (the flash
kernel on the card) into a 1-row cache of the bucket and keeps the rows
of the positions the rank owns; a decode step writes each slot's token
on the rank that owns its position only, and attends through
``parallel/ring_attention.py``'s ``sp_decode_attention`` (each rank its
shard, merged over sp by one pmax and two psums), never the dense decode
kernel, as in JAX. Chunked and ragged admission are refused under any
plan.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    _chunk_decode_scan,
    _decode_chunk_batch_impl,
    _kv_quantize,
    _plain_attend,
    _prefill_impl,
    init_kv_cache,
    rope_frequencies,
    sample_logits,
    sample_logits_per_row,
)
from kubeflow_tpu_torch.models.serving import GenerationConfig, left_pad
from kubeflow_tpu_torch.observability import tracing
from kubeflow_tpu_torch.ops.paged_attention import dense_decode_attention


# ---------------------------------------------------------------------------
# Step functions (JAX's jitted programs)


@torch.no_grad()
def _admit_slot(params: Llama, cfg: LlamaConfig,
                tokens: torch.Tensor,                 # (1, Lb) left-padded
                prompt_mask: Optional[torch.Tensor],  # (1, Lb) bool or None
                cache: dict,                          # (L, B, Hkv, C, D)
                kv_mask: torch.Tensor,                # (B, C) bool
                slot: int,
                attn_impl: str = "auto",
                sp_start: Optional[int] = None) -> torch.Tensor:
    """Prefill one prompt into ``slot``; returns its first logits (V,).

    The prefill writes straight into the slot's rows of the stacked cache
    (a ``[:, slot:slot+1]`` view, in place) and sets the slot's kv_mask
    row, where JAX prefills a 1-row temp cache and copies all C columns
    in. Columns past the bucket keep the previous occupant's values; no
    query sees them (``k_pos <= pos``, and the kernel's ``k_pos <
    seq_len``) before the slot's own decode overwrites them. ``attn_impl``
    goes to the prefill's ``flash_attention``.

    ``sp_start``: the cache is this rank's piece of a cache cut over sp,
    from that global position on; the prompt is prefilled whole into a
    1-row cache of the bucket and the rank keeps the positions it owns
    (its mask columns past them stay True, as the whole row's do)."""
    lb = tokens.shape[1]
    if sp_start is None:
        rows = {name: leaf[:, slot:slot + 1] for name, leaf in cache.items()}
        logits, _ = _prefill_impl(params, cfg, tokens, rows,
                                  kv_mask=prompt_mask, attn_impl=attn_impl)
        kv_mask[slot] = True
        if prompt_mask is not None:
            kv_mask[slot, :lb] = prompt_mask[0]
        return logits[0]
    # A cache cut over sp: the whole prompt into a 1-row cache of the
    # bucket, then the positions this rank owns into the slot.
    c_local = kv_mask.shape[1]
    temp = {name: torch.zeros((leaf.shape[0], 1, leaf.shape[2], lb,
                               *leaf.shape[4:]), dtype=leaf.dtype,
                              device=leaf.device)
            for name, leaf in cache.items()}
    logits, _ = _prefill_impl(params, cfg, tokens, temp, kv_mask=prompt_mask,
                              attn_impl=attn_impl)
    lo, hi = sp_start, min(sp_start + c_local, lb)
    for name, leaf in cache.items():
        if hi > lo:
            leaf[:, slot, :, :hi - lo] = temp[name][:, 0, :, lo:hi]
    kv_mask[slot] = True
    if prompt_mask is not None and hi > lo:
        kv_mask[slot, :hi - lo] = prompt_mask[0, lo:hi]
    return logits[0]


def _admit_chunk(params: Llama, cfg: LlamaConfig, tok_chunk: torch.Tensor,
                 temp: dict, pos: torch.Tensor, kv_mask: torch.Tensor):
    """One admission piece: decode a (1, CS) prompt chunk into the 1-row
    temp cache at ``pos`` (chunk-causal, pads fenced by the full kv_mask
    row); returns (last-position logits (V,), the temp cache)."""
    logits, temp = _decode_chunk_batch_impl(params, cfg, tok_chunk, temp, pos,
                                            kv_mask=kv_mask)
    return logits[0, -1], temp


def _install_rows(temp: dict, cache: dict, kv_mask: torch.Tensor,
                  row: torch.Tensor, slot: int) -> None:
    """Copy a finished 1-row temp cache and its (1, C) validity row into
    ``slot`` of the stacked cache and mask, in place (JAX's
    ``_install_temp_cache``)."""
    for name, leaf in cache.items():
        leaf[:, slot] = temp[name][:, 0]
    kv_mask[slot] = row[0]


@torch.no_grad()
def _cb_step(params: Llama, cfg: LlamaConfig,
             tokens: torch.Tensor,      # (B, 1) current input token per slot
             cache: dict,               # updated in place
             positions: torch.Tensor,   # (B,) write position per slot
             kv_mask: torch.Tensor,     # (B, C)
             generator: torch.Generator,
             temps: torch.Tensor,       # (B,) per-slot temperature
             top_k: int, top_p: float,
             bias: Optional[torch.Tensor] = None,  # (B, V) per-slot bias
             attn_kernel: int = 0,      # > 0: the dense kernel, its chunk
             decode_attn=None,          # the sp split-KV decode, or None
             sp_start: int = 0,         # first position of the sp piece
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step across every slot at its own position; returns
    (next token, its logprob) per slot. ``attn_kernel`` > 0 attends a bf16
    cache through ``dense_decode_attention`` with that block size (each
    slot's filled prefix only); otherwise, and for int8 caches, through
    ``_gqa_decode_attention`` with the scales folded in. An idle slot
    (all-False kv_mask row) attends nothing and its row is discarded.

    The token is written at its slot's position with one indexed write per
    leaf, never clipped: the constructor's ``prompt_bucket +
    max_new_tokens <= cache_len`` keeps every decode position below C.

    ``decode_attn``: the sequence-parallel split-KV decode
    (``make_sharded_sp_decode``) over a cache cut along the sequence,
    ``sp_start`` the first global position this rank's piece holds: a
    slot's token is written only where its position falls in the piece.
    """
    positions = positions.long()
    cos, sin = rope_frequencies(cfg, positions)  # (B, half)
    rows = torch.arange(positions.shape[0], device=positions.device)
    local, pick = positions, slice(None)
    if decode_attn is not None:
        # The slots whose position falls in this rank's piece.
        local = positions - sp_start
        owned = (local >= 0) & (local < next(iter(cache.values())).shape[3])
        rows, local = rows[owned], local[owned]
        pick = rows

    def store(cache_l, k, v):  # k, v (B, Hkv, 1, D)
        news = {"k": k, "v": v}
        if "k_scale" in cache_l:
            (news["k"], news["k_scale"]), (news["v"], news["v_scale"]) = (
                _kv_quantize(k), _kv_quantize(v))
        for name, new in news.items():
            cache_l[name][rows, :, local] = new[pick, :, 0]

    if decode_attn is not None:
        def attend(q, cache_l):
            return decode_attn(
                q, cache_l["k"], cache_l["v"], positions,
                window=cfg.sliding_window, kv_mask=kv_mask, per_batch=True,
                k_scale=cache_l.get("k_scale"), v_scale=cache_l.get("v_scale"))
    elif attn_kernel and "k_scale" not in cache:
        seq_lens = (positions + 1).int()

        def attend(q, cache_l):
            return dense_decode_attention(
                q[:, :, 0, :], cache_l["k"], cache_l["v"], kv_mask, seq_lens,
                block_size=attn_kernel,
            )[:, :, None, :]
    else:
        attend = _plain_attend(cfg, positions, kv_mask, per_batch=True)
    logits, _ = _chunk_decode_scan(params, cfg, tokens, cache, cos[:, None],
                                   sin[:, None], store, attend)
    return _sample_rows(logits[:, 0], generator, temps, top_k, top_p, bias)


def _sample_rows(logits, generator, temps, top_k, top_p, bias):
    """Per-row sampling of (B, V) logits (biased first); returns (tokens,
    chosen-token logprobs under the biased, temperature-free
    distribution)."""
    if bias is not None:
        logits = logits + bias
    nxt = sample_logits_per_row(logits, generator, temps, top_k, top_p)
    lp = torch.gather(torch.log_softmax(logits, dim=-1), 1, nxt[:, None])[:, 0]
    return nxt, lp


@torch.no_grad()
def _cb_ragged_step(params: Llama, cfg: LlamaConfig,
                    tokens: torch.Tensor,     # (B, K) per-slot chunk
                    cache: dict,              # updated in place
                    positions: torch.Tensor,  # (B,) chunk start per slot
                    kv_mask: torch.Tensor,    # (B, C)
                    cols: torch.Tensor,       # (B,) last-real column per row
                    generator: torch.Generator,
                    temps: torch.Tensor, top_k: int, top_p: float,
                    bias: Optional[torch.Tensor] = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused mixed prefill/decode dispatch: every row is a K-token
    chunk written at its own position (decode rows: one real token plus
    pads, invisible until real tokens overwrite them; the admitting row:
    its next prompt chunk), chunk-causal inside each row. Each row samples
    at its own last-real column, so a completing admission's first token
    comes out of the dispatch that finished its prefill."""
    logits, _ = _decode_chunk_batch_impl(params, cfg, tokens, cache,
                                         positions, kv_mask=kv_mask)
    row_logits = logits[torch.arange(logits.shape[0], device=logits.device),
                        cols.long()]
    return _sample_rows(row_logits, generator, temps, top_k, top_p, bias)


# ---------------------------------------------------------------------------
# Host-side engines


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
    # Paged engine: the blocks of ``blocks`` held through a cache
    # (refcounted, freed by the last holder), not owned.
    shared: frozenset = frozenset()
    # Absolute monotonic deadline (None = none); an expired request
    # retires through the abort path at its next emitted token.
    deadline: Optional[float] = None
    # Multi-LoRA engines: the adapter's stacked row (None = the base
    # model). It travels with the request through preemption and salts
    # the prefix chain key, so KV never crosses adapters.
    adapter_id: Optional[int] = None


class _AdmissionCursor:
    """Prompt-prefill cursor for one in-flight admission: the next
    position of the left-padded prompt to prefill. ``align`` keeps piece
    starts on chunk boundaries (chunked admission dispatches fixed-width
    pieces); the ragged schedulers take variable-width pieces (align=1)."""

    def __init__(self, mask_row, bucket: int, align: int = 1) -> None:
        self.bucket = int(bucket)
        row = np.asarray(mask_row).reshape(-1)[: self.bucket]
        # Left-padding puts all pads FIRST: start at the aligned piece
        # holding the first real token (pure-pad pieces would be masked
        # work).
        first_real = int(np.argmax(row)) if row.any() else 0
        self.pos = (first_real // align) * align

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

    # The steps report each sampled token's logprob (the speculative
    # engines, whose rounds verify argmaxes, do not).
    supports_logprobs = True

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
        # Optional observability.flight.FlightRecorder, attached by the
        # serving frontend: drive_once feeds it every quantum's time.
        self.flight = None
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
        admitting = getattr(self, "_admitting", None)
        if admitting is not None and admitting["req"].rid == rid:
            self._cancelled[rid] = reason
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
            or getattr(self, "_admitting", None) is not None
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
        """One drive quantum (admit + step), timed: shared by run() and
        the serving frontend's engine thread. Feeds the attached flight
        recorder and, only when a recording tracer is installed, wraps
        the quantum in an ``engine.step`` span carrying ``last_step``."""
        span = None
        if tracing.enabled():
            span = tracing.get_tracer("engine").start_span("engine.step")
        t0 = self._clock()
        self.last_step = {}
        try:
            self._admit_free_slots()
            self._step()
        except Exception as err:
            if span is not None:
                span.record_error(err)
            raise
        finally:
            # Every engine's _step and _step_ragged end in the readback
            # of the sampled tokens (``nxt.cpu()``), which waits for the
            # card: dt covers the card's work, not just the launches.
            # Taking that readback out of the step (ROADMAP item 15) must
            # move this timing to a card event.
            dt = self._clock() - t0
            stalled = False
            if self.flight is not None:
                stalled = self.flight.record_step(
                    dt, self.last_step.get("fill"))
                if stalled:
                    self.last_step["stalled"] = True
            if span is not None:
                for k, v in self.last_step.items():
                    span.set_attribute(k, v)
                span.set_attribute("duration_s", round(dt, 6))
                if stalled:
                    span.add_event("stall", {"duration_s": round(dt, 6)})
                span.end()

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

    def _post_admit(self, slot: int, padded, prompt_mask) -> None:
        """Hook for subclasses that keep a SECOND cache in lockstep (the
        speculative batchers prefill their draft cache here)."""

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """Host numpy → the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _retire(self, slot: int, finish_reason: str = "stop") -> None:
        req = self._by_slot[slot]
        if self.on_retire is not None:
            self.on_retire(req.rid, req.tokens, req.logprobs, finish_reason)
        else:
            self._results[req.rid] = req.tokens
            self._result_logprobs[req.rid] = req.logprobs
        self._release_slot(slot)


def _kernel_block_size(cache_len: int) -> int:
    """The ``block_size`` the engine hands the dense kernel: the largest
    power of two in [16, 512] dividing ``cache_len`` (JAX's rule), or
    ``cache_len`` itself when none does. JAX turns its kernel off there (a
    TPU tiling limit); the CUDA kernel walks 64-key tiles with tail masking
    for any C, so it stays on, and ``block_size`` only has to divide C."""
    return next((cand for cand in (512, 256, 128, 64, 32, 16)
                 if cache_len % cand == 0), cache_len)


class ContinuousBatcher(_BatcherBase):
    """Fixed-slot continuous-batching server over a dense per-slot cache.

    >>> cb = ContinuousBatcher(params, cfg, slots=4, cache_len=256)
    >>> ids = [cb.submit(p) for p in prompts]
    >>> results = cb.run()           # {rid: tokens}, EOS-truncated

    ``device`` is the card unless ``"cpu"`` is passed; ``params`` must
    live there. ``attn_kernel`` picks the decode attention: None turns the
    CUDA dense kernel on for a bf16 cache on the card with no ``kv_bits``,
    no sliding window and not ``ragged`` (JAX's default under the TPU
    backend), and off on the CPU; True on the CPU, or for a model that is
    not bf16, raises; False on the card
    runs ``_gqa_decode_attention`` (for comparing the two). The kernel runs
    at any ``cache_len``, with the block size of ``_kernel_block_size``.
    One-shot admissions prefill through
    ``flash_attention(impl="auto")``. Sampled rows draw from ``generator``
    (a seeded ``torch.Generator`` on the device; seed 0 when None), where
    JAX takes a key. ``plan=`` makes the engine one rank of a
    tensor-parallel and/or sequence-parallel replica (``params`` must be
    the rank's shard, ``MeshPlan.check_shard``; under sp the cache is cut
    over the sequence and ``cache_len`` must divide by sp); ``admit_chunk``
    is refused with it.
    """

    def __init__(
        self,
        params: Llama,
        cfg: LlamaConfig,
        gen: Optional[GenerationConfig] = None,
        slots: int = 8,
        cache_len: int = 1024,
        prompt_bucket: int = 64,
        generator: Optional[torch.Generator] = None,
        plan=None,
        kv_bits: int = 0,  # 8 → int8 KV storage (halved cache bytes)
        attn_kernel: Optional[bool] = None,  # CUDA length-bounded decode
        admit_chunk: Optional[int] = None,  # interleave admission pieces
        ragged: bool = False,  # fuse admission chunk + decodes per step
        device=None,
    ):
        self.gen = gen or GenerationConfig()
        # Chunked admission: a long prompt's prefill runs in admit_chunk-
        # token pieces with a DECODE STEP between pieces, so in-flight
        # neighbors' inter-token latency stops paying for whole admissions.
        # One admission in flight at a time.
        if admit_chunk is not None:
            if admit_chunk <= 0 or prompt_bucket % admit_chunk:
                raise ValueError(
                    f"admit_chunk {admit_chunk} must be a positive "
                    f"divisor-multiple of prompt_bucket {prompt_bucket}"
                )
            if plan is not None:
                raise ValueError(
                    "admit_chunk does not compose with plan= yet — "
                    "drop one of the two"
                )
        self._admit_chunk = admit_chunk
        self._admitting: Optional[dict] = None
        # Ragged mode: admission chunks and decode tokens FUSE into one
        # (B, admit_chunk) chunk-causal dispatch per step.
        if ragged:
            if admit_chunk is None:
                raise ValueError(
                    "ragged=True needs admit_chunk= (the fused step's "
                    "chunk width)"
                )
            if kv_bits:
                raise ValueError(
                    "ragged=True does not compose with kv_bits — "
                    "drop one of the two"
                )
            if attn_kernel:
                raise ValueError(
                    "ragged=True does not compose with attn_kernel=True "
                    "(the fused chunk step is XLA) — drop one of the two"
                )
        self.ragged = ragged
        sp = 1 if plan is None else plan.sp
        # Explicit True with an unsupported composition is a reasoned
        # rejection, never a silent fallback.
        if attn_kernel:
            if sp > 1:
                # Under sp the decode is the split-KV merge, as in JAX.
                raise ValueError(
                    "attn_kernel=True does not compose with plan= (the "
                    "dense kernel is single-device) — drop one of the two"
                )
            if kv_bits:
                raise ValueError(
                    "attn_kernel=True does not compose with kv_bits (the "
                    "kernel reads bf16 caches) — drop one of the two"
                )
            if cfg.sliding_window:
                raise ValueError(
                    "attn_kernel=True does not support sliding-window "
                    "configs — drop attn_kernel for this model"
                )
        self.device = resolve_device(device)
        if attn_kernel and self.device.type != "cuda":
            raise ValueError(
                "attn_kernel=True needs the CUDA card; on device='cpu' the "
                "engine runs the plain attention (leave attn_kernel unset)"
            )
        if attn_kernel and cfg.dtype != torch.bfloat16:
            raise ValueError(
                f"attn_kernel=True needs a bf16 cache (the CUDA kernel reads "
                f"bf16 only); this model's dtype is {cfg.dtype} — drop "
                "attn_kernel"
            )
        if attn_kernel is None:
            attn_kernel = (
                self.device.type == "cuda" and not kv_bits
                and not cfg.sliding_window and not ragged
                and cfg.dtype == torch.bfloat16 and sp == 1
            )
        self._attn_kernel = _kernel_block_size(cache_len) if attn_kernel else 0
        if prompt_bucket + self.gen.max_new_tokens > cache_len:
            raise ValueError(
                f"cache_len {cache_len} too small for prompt_bucket "
                f"{prompt_bucket} + max_new_tokens {self.gen.max_new_tokens}"
            )
        kv_cfg = cfg
        self._decode_attn, self._sp_start = None, None
        if plan is not None:
            if sp > 1 and cache_len % sp:
                raise ValueError(
                    f"cache_len {cache_len} not divisible by sp={sp}"
                )
            if sp > 1:
                from kubeflow_tpu_torch.parallel.ring_attention import (
                    make_sharded_sp_decode,
                )

                self._decode_attn = make_sharded_sp_decode(plan)
                self._sp_start = plan.sp_index * (cache_len // sp)
            # The cache's kv-head rule first, before any weight is cut.
            plan.check_kv_heads(cfg.n_kv_heads)
            plan.check_shard(params)
            kv_cfg = plan.shard_config(cfg)
        if params.device != self.device:
            raise ValueError(
                f"params live on {params.device}, the engine on "
                f"{self.device}; build them with the same device"
            )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator lives on {generator.device}, the engine on "
                f"{self.device}"
            )
        self.params = params
        self.cfg = cfg
        self.plan = plan
        # /stats "mesh": None on one rank, so its stats stay as they were.
        self.mesh_axes = plan.axes if plan is not None else None
        self.cache_len = cache_len
        self.generator = generator
        self.kv_bits = kv_bits
        # Under sp: this rank's cache_len / sp positions of every slot.
        self.cache = init_kv_cache(kv_cfg, slots, cache_len // sp,
                                   kv_bits=kv_bits, device=self.device)
        self.kv_mask = torch.zeros((slots, cache_len // sp), dtype=torch.bool,
                                   device=self.device)
        # Host-side state, uploaded once per step.
        self.positions = np.zeros((slots,), np.int32)
        self.tokens = np.full((slots, 1), self.gen.pad_id, np.int32)
        self._init_base(self.gen, slots, prompt_bucket)

    # -- admission ---------------------------------------------------------

    def _admit_free_slots(self) -> None:
        if self.ragged:
            self._stage_ragged_admission()
            return
        if self._admit_chunk:
            self._admit_one_chunk()
            return
        for slot in range(self.slots):
            if self._by_slot[slot] is not None or not self._queue:
                continue
            req = self._pop_queue()
            padded, mask = left_pad([req.prompt], self.gen.pad_id,
                                    self.prompt_bucket)
            prompt_mask = None if mask.all() else self._up(mask)
            padded = self._up(padded)
            logits = self._prefill_into_slot(slot, req, padded, prompt_mask)
            self._install_admitted(slot, req, padded, prompt_mask, logits)

    def _admit_one_chunk(self) -> None:
        """Advance chunked admission by ONE piece (the drive loop runs a
        decode step between calls — that interleaving is the feature)."""
        a = self._admitting
        if a is None:
            slot = next((i for i in range(self.slots)
                         if self._by_slot[i] is None), None)
            if slot is None or not self._queue:
                return
            req = self._pop_queue()
            padded, mask = left_pad([req.prompt], self.gen.pad_id,
                                    self.prompt_bucket)
            row = np.ones((1, self.cache_len), bool)
            row[:, :self.prompt_bucket] = mask
            a = self._admitting = {
                "slot": slot,
                "req": req,
                "padded": padded,
                "prompt_mask": None if mask.all() else self._up(mask),
                "row": self._up(row),
                "temp": init_kv_cache(self.cfg, 1, self.cache_len,
                                      kv_bits=self.kv_bits,
                                      device=self.device),
                "cursor": _AdmissionCursor(mask[0], self.prompt_bucket,
                                           align=self._admit_chunk),
                "logits": None,
            }
        cs = self._admit_chunk
        start, _ = a["cursor"].take(cs)
        a["logits"], a["temp"] = _admit_chunk(
            self.params, self.cfg, self._up(a["padded"][:, start:start + cs]),
            a["temp"], self._up(np.asarray([start], np.int32)), a["row"],
        )
        if a["cursor"].done:
            _install_rows(a["temp"], self.cache, self.kv_mask, a["row"],
                          a["slot"])
            self._install_admitted(a["slot"], a["req"], self._up(a["padded"]),
                                   a["prompt_mask"], a["logits"])
            self._admitting = None

    def _stage_ragged_admission(self) -> None:
        """Stage (not dispatch) the next admission: its prefill chunks ride
        the fused step, so staging claims the slot and installs the row's
        validity mask, temperature and bias — sampling state must be live
        BEFORE the completing chunk's dispatch samples the first token."""
        if self._admitting is not None or not self._queue:
            return
        slot = next((i for i in range(self.slots)
                     if self._by_slot[i] is None), None)
        if slot is None:
            return
        req = self._pop_queue()
        padded, mask = left_pad([req.prompt], self.gen.pad_id,
                                self.prompt_bucket)
        row = np.ones((self.cache_len,), bool)
        row[:self.prompt_bucket] = mask[0]
        # The row goes live before the positions are written; what lies
        # under it is reachable only by this slot's own chunk-causal
        # queries, which never look past their own chunk.
        self.kv_mask[slot] = self._up(row)
        self.temps[slot] = (self.gen.temperature if req.temperature is None
                            else req.temperature)
        self._install_bias(slot, req)
        self._admitting = {
            "slot": slot,
            "req": req,
            "padded": padded,
            "prompt_mask": None if mask.all() else self._up(mask),
            "cursor": _AdmissionCursor(mask[0], self.prompt_bucket,
                                       align=self._admit_chunk),
        }

    def _install_admitted(self, slot: int, req: _Request, padded,
                          prompt_mask, logits: torch.Tensor) -> None:
        """Admission tail shared by one-shot and chunked admission: the
        _post_admit hook, first-token sampling (request temperature, bias,
        logprob) and slot bookkeeping."""
        self._post_admit(slot, padded, prompt_mask)
        temp = (self.gen.temperature if req.temperature is None
                else req.temperature)
        bias_row = self._install_bias(slot, req)
        if bias_row is not None:
            logits = logits + bias_row
        first = int(sample_logits(logits[None], self.generator, temp,
                                  self.gen.top_k, self.gen.top_p)[0])
        first_lp = float(torch.log_softmax(logits.float(), dim=-1)[first])
        self.positions[slot] = self.prompt_bucket
        self.temps[slot] = temp
        self._by_slot[slot] = req
        req.budget = self._initial_budget(req)
        self._note_token(slot, first, first_lp)

    def _prefill_into_slot(self, slot: int, req: _Request, padded,
                           prompt_mask) -> torch.Tensor:
        """The engine's half of a one-shot admission: prefill ``padded``
        into ``slot`` and return the first logits. The multi-LoRA engine
        overrides it (an adapted prefill); everything around it (padding,
        the _post_admit hook, sampling, budget) stays in the one loop."""
        del req
        return _admit_slot(self.params, self.cfg, padded, prompt_mask,
                           self.cache, self.kv_mask, slot,
                           sp_start=self._sp_start)

    def _release_slot(self, slot: int) -> None:
        self._by_slot[slot] = None
        # Invalidate the slot so stale cache rows are never attended before
        # the next admission overwrites them; position 0 keeps an idle
        # slot's kernel walk to one tile (JAX leaves the stale position).
        self.kv_mask[slot] = False
        self.positions[slot] = 0

    # -- decode ------------------------------------------------------------

    def _step(self) -> None:
        if self.ragged:
            self._step_ragged()
            return
        active = [i for i, r in enumerate(self._by_slot) if r is not None]
        if not active:
            return
        self.last_step = {
            "decode_rows": len(active),
            "prefill_rows": 0,
            "fill": len(active) / self.slots,
        }
        nxt, lps = _cb_step(
            self.params, self.cfg, self._up(self.tokens), self.cache,
            self._up(self.positions), self.kv_mask, self.generator,
            self._up(self.temps), self.gen.top_k, self.gen.top_p,
            bias=self._bias, attn_kernel=self._attn_kernel,
            decode_attn=self._decode_attn, sp_start=self._sp_start or 0,
        )
        # The emitted token will occupy the next cache index of its slot.
        for slot in active:
            self.positions[slot] += 1
        host_next = nxt.cpu().numpy()  # the one per-step readback
        host_lps = lps.cpu().numpy()
        for slot in active:
            self._note_token(slot, int(host_next[slot]),
                             float(host_lps[slot]))

    def _step_ragged(self) -> None:
        """One fused mixed prefill/decode step: every active slot's decode
        token plus the in-flight admission's next prompt chunk go out as
        ONE (B, admit_chunk) chunk-causal dispatch."""
        a = self._admitting
        active = [i for i, r in enumerate(self._by_slot) if r is not None]
        if not active and a is None:
            return
        cs = self._admit_chunk
        tokens = np.full((self.slots, cs), self.gen.pad_id, np.int32)
        positions = np.zeros((self.slots,), np.int32)
        cols = np.zeros((self.slots,), np.int32)
        for slot in active:
            tokens[slot, 0] = self.tokens[slot, 0]
            positions[slot] = self.positions[slot]
        admit_done = False
        if a is not None:
            start, n = a["cursor"].take(cs)
            tokens[a["slot"], :n] = a["padded"][0, start:start + n]
            positions[a["slot"]] = start
            cols[a["slot"]] = n - 1
            admit_done = a["cursor"].done
        prefill_rows = 0 if a is None else 1
        self.last_step = {
            "decode_rows": len(active),
            "prefill_rows": prefill_rows,
            "fill": (len(active) + prefill_rows) / self.slots,
        }
        nxt, lps = _cb_ragged_step(
            self.params, self.cfg, self._up(tokens), self.cache,
            self._up(positions), self.kv_mask, self._up(cols),
            self.generator, self._up(self.temps), self.gen.top_k,
            self.gen.top_p, bias=self._bias,
        )
        host_next = nxt.cpu().numpy()
        host_lps = lps.cpu().numpy()
        for slot in active:
            self.positions[slot] += 1
        for slot in active:
            self._note_token(slot, int(host_next[slot]),
                             float(host_lps[slot]))
        if a is not None and admit_done:
            # The completing chunk's dispatch already sampled the first
            # token (its row's last-real column).
            slot, req = a["slot"], a["req"]
            self._post_admit(slot, self._up(a["padded"]), a["prompt_mask"])
            self.positions[slot] = self.prompt_bucket
            self._by_slot[slot] = req
            req.budget = self._initial_budget(req)
            self._admitting = None
            self._note_token(slot, int(host_next[slot]),
                             float(host_lps[slot]))
