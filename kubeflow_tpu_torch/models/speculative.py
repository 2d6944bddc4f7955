"""Greedy speculative decoding: a small draft model proposes, the target
verifies k tokens per step in ONE forward, batched.

Counterpart of ``kubeflow_tpu/models/speculative.py``. Decode is bound by
reading the TARGET's weights; a verify reads them once per k proposed
tokens instead of once per token. Greedy acceptance makes the output the
target's greedy decoding (tie-tolerant across chunk shapes, as every
cross-shape greedy comparison here), so speculation is a latency change,
never a quality trade.

Per round:
- the draft proposes d_1..d_k from its own cache, k + 1 decode steps (the
  last one lands d_k in the draft cache; ``_draft_propose``);
- the target runs one chunked forward over [prev_token, d_1..d_k] at each
  row's offset (``_target_verify``; ``paged._paged_verify`` through the
  block tables; ``paged._paged_ragged_verify`` as spans of the fused
  ragged dispatch);
- per row, ``_apply_spec_round`` accepts the longest prefix where the
  target's argmax matches the proposal, emits the target's own next
  token as the correction, and advances the row's pointer by accepted + 1.

The serving engines wrap the port's ``ContinuousBatcher`` and
``PagedBatcher`` (``SpeculativeContinuousBatcher``,
``SpeculativePagedBatcher``): a subclass of the inner engine whose
``_post_admit`` prefills the DENSE draft cache (``continuous._admit_slot``,
the flash kernel on the card), whose ``_release_slot`` clears the draft's
mask row, and whose ``_step`` is the speculative round. The paged engine
runs three modes: alternating (a (B, k+1) verify on the gathered view),
ragged (verify spans inside the fused dispatch through the ragged kernel,
with the rejected cells rolled back byte for byte from a snapshot taken
before the dispatch, and the trailing blocks freed) and ragged adaptive
(the draft length moves within 1..k_spec with the acceptance rate).

Draft and target attend their dense caches with the plain attention, as
JAX's ``_decode_chunk_batch_impl`` does; the acceptance walk runs on the
host over two readbacks a round (predictions and proposals), and
``torch.argmax``, like ``jnp.argmax``, takes the first maximum.

Under ``plan=`` (``models/tp_serving.py``) both engines are one rank of a
tensor-parallel replica: the target and the draft must both be the
rank's shards under the same plan (``truncated_draft`` of a shard is
one; the draft's kv heads must divide by tp too), the draft's dense cache
holding the rank's kv heads. The acceptance walk sees the
gathered argmaxes, the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.models import continuous as _continuous
from kubeflow_tpu_torch.models import paged as _paged
from kubeflow_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    _decode_chunk_batch_impl,
    _prefill_impl,
    init_kv_cache,
)
from kubeflow_tpu_torch.models.quant import _set
from kubeflow_tpu_torch.models.serving import GenerationConfig


@torch.no_grad()
def _draft_propose(params: Llama, cfg: LlamaConfig, token: torch.Tensor,
                   kv_cache: dict, positions: torch.Tensor, k_spec: int,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draft k_spec greedy tokens autoregressively from ``token`` (B, 1)
    at per-row ``positions`` (B,); the cache is written in place.
    ``kv_mask`` (B, C) marks valid cache slots (serving: left pads are
    False).

    Runs k_spec + 1 decode steps: each step WRITES its input token's K/V,
    so the extra step lands d_k in the draft cache: on a fully accepted
    round the next round continues from position + k_spec + 1, and a
    missing d_k would degrade later proposals unseen. Returns the
    proposals (B, k_spec)."""
    tok, pos = token, positions.long()
    sampled = []
    for _ in range(k_spec + 1):
        logits, _ = _decode_chunk_batch_impl(params, cfg, tok, kv_cache, pos,
                                             kv_mask=kv_mask)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        sampled.append(tok[:, 0])
        pos = pos + 1
    return torch.stack(sampled[:k_spec], dim=1)


@torch.no_grad()
def _target_verify(params: Llama, cfg: LlamaConfig, chunk: torch.Tensor,
                   kv_cache: dict, positions: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The target's argmax (B, K) over a (B, K) chunk at per-row offsets;
    the cache is written in place."""
    logits, _ = _decode_chunk_batch_impl(params, cfg, chunk, kv_cache,
                                         positions, kv_mask=kv_mask)
    return torch.argmax(logits, dim=-1)


def speculative_generate(
    target_params: Llama,
    target_cfg: LlamaConfig,
    draft_params: Llama,
    draft_cfg: LlamaConfig,
    prompt: torch.Tensor,  # (B, S)
    steps: int,
    cache_len: int,
    k_spec: int = 4,
) -> tuple[torch.Tensor, dict]:
    """Greedy speculative decoding. Returns (tokens (B, steps) int32,
    stats): the tokens of target-only greedy decoding of each row, and
    the acceptance rate that decides the speedup.

    Rows that reach ``steps`` keep riding the fixed-shape rounds with a
    clamped parked pointer, so their caches' tails hold dead chunk
    writes: callers continuing generation must re-prefill."""
    b, s_prompt = prompt.shape
    # Every round needs headroom for a full k_spec chunk, the last one
    # too; enforcing it up front keeps the (B, steps) output contract.
    needed = s_prompt + steps + k_spec
    if cache_len < needed:
        raise ValueError(
            f"cache_len {cache_len} < prompt ({s_prompt}) + steps "
            f"({steps}) + k_spec ({k_spec}) = {needed}"
        )
    dev = prompt.device
    t_cache = init_kv_cache(target_cfg, b, cache_len, device=dev)
    d_cache = init_kv_cache(draft_cfg, b, cache_len, device=dev)
    t_logits, _ = _prefill_impl(target_params, target_cfg, prompt, t_cache)
    _prefill_impl(draft_params, draft_cfg, prompt, d_cache)
    last_np = torch.argmax(t_logits, dim=-1).cpu().numpy()  # (B,)

    out: list[list[int]] = [[int(t)] for t in last_np]
    pos = np.full((b,), s_prompt, np.int64)  # per-row cache pointer
    proposed_total = accepted_total = 0
    while any(len(o) < steps for o in out):
        # Frozen rows (output complete) still ride the round with parked
        # pointers; a surplus acceptance can park one where the k_spec + 1
        # chunk would run past the cache. Clamp explicitly so the dead
        # write stays inside, at the cache's end.
        positions = torch.from_numpy(
            np.minimum(pos, cache_len - (k_spec + 1))).to(dev)
        last = torch.from_numpy(last_np.astype(np.int64))[:, None].to(dev)
        proposals = _draft_propose(draft_params, draft_cfg, last, d_cache,
                                   positions, k_spec)
        # The chunk is k + 1 wide so EVERY proposal is acceptable: pred i
        # is the target's next token after ...[last, d_1..d_i].
        chunk = torch.cat([last, proposals], dim=1)
        preds_np = _target_verify(target_params, target_cfg, chunk, t_cache,
                                  positions).cpu().numpy()
        props_np = proposals.cpu().numpy()
        for row in range(b):
            if len(out[row]) >= steps:
                continue  # frozen row: pointer parked, output complete
            n_accept = 0
            while (n_accept < k_spec
                   and preds_np[row, n_accept] == props_np[row, n_accept]):
                n_accept += 1
            # The accepted proposals, then the target's own correction
            # (all k accepted: its free token at pos + k).
            emitted = list(props_np[row, :n_accept]) + [
                int(preds_np[row, n_accept])]
            out[row].extend(int(t) for t in emitted)
            proposed_total += k_spec
            accepted_total += n_accept
            pos[row] += n_accept + 1  # rewound past any rejected slots
            last_np[row] = (out[row][-1] if len(out[row]) < steps
                            else out[row][steps - 1])
    stats = {
        "proposed": proposed_total,
        "accepted": accepted_total,
        "acceptance_rate": (accepted_total / proposed_total
                            if proposed_total else 0.0),
    }
    return torch.tensor([o[:steps] for o in out], dtype=torch.int32,
                        device=dev), stats


def _apply_spec_round(outer, engine, active, preds_np, props_np,
                      k_spec=None) -> dict:
    """Accept, emit, rewind and count for one SERVING round: the one home
    of the per-slot acceptance walk, the retired-mid-round guard and the
    stats, shared by the continuous and paged engines. ``outer`` carries
    k_spec and the counters, ``engine`` is the inner batcher. ``k_spec``
    overrides the round's draft length (adaptive ragged rounds propose
    outer.k_cur). Returns {slot: n_accept}, for the paged rollback."""
    k = outer.k_spec if k_spec is None else k_spec
    outer.rounds += 1
    accepts: dict[int, int] = {}
    for slot in active:
        n_accept = 0
        while n_accept < k and preds_np[slot, n_accept] == props_np[slot,
                                                                    n_accept]:
            n_accept += 1
        emitted = list(props_np[slot, :n_accept]) + [
            int(preds_np[slot, n_accept])]
        consumed = 0
        for tok in emitted:
            if engine._by_slot[slot] is None:
                break  # retired mid-round (EOS, budget): drop the rest
            engine._note_token(slot, int(tok))
            consumed += 1
        # Rewind past any rejected slots: entries beyond the pointer are
        # causally invisible and overwritten next round. A retired slot's
        # position resets at its next admission.
        engine.positions[slot] += n_accept + 1
        # Count only what the request consumed: a slot that retired
        # mid-round discards its tail proposals, which would skew the
        # reported rate low near retirements.
        if consumed == len(emitted):
            outer.proposed += k
            outer.accepted += n_accept
        else:
            outer.proposed += consumed
            outer.accepted += min(consumed, n_accept)
        accepts[slot] = n_accept
    return accepts


class _SpecServingBase:
    """What the speculative serving engines share: the greedy-only guard,
    the inner-engine subclass whose hooks keep the dense draft cache in
    lockstep, the draft state, the delegated public surface and the
    counters ``_apply_spec_round`` updates."""

    @staticmethod
    def _require_greedy(gen) -> None:
        # Both greedy spellings pass: temperature 0.0 and None.
        if gen.temperature is not None and gen.temperature != 0.0:
            raise ValueError(
                "speculative serving is greedy-only (temperature must be 0: "
                "acceptance compares argmaxes, sampling would break the "
                "exactness guarantee)"
            )

    def _make_inner(self, engine_cls):
        """Subclass of the inner engine wired to this wrapper: admissions
        prefill the draft, releases clear its mask row, and the step IS
        the speculative round."""
        outer = self

        class _Inner(engine_cls):
            supports_logprobs = False  # verified tokens are argmax rounds

            def submit(self, prompt, max_new_tokens=None, temperature=None,
                       logit_bias=None, **kw):
                # A sampled request would be served greedy without a word:
                # refused where the engine-wide guard lives.
                if temperature:
                    raise ValueError(
                        "speculative serving is greedy-only; per-request "
                        f"temperature {temperature} is not supported"
                    )
                if logit_bias:
                    raise ValueError(
                        "speculative serving does not support logit_bias "
                        "(verification compares UNbiased argmaxes)"
                    )
                return super().submit(prompt, max_new_tokens=max_new_tokens,
                                      **kw)

            def _post_admit(self, slot, padded, prompt_mask):
                outer._admit_draft(slot, padded, prompt_mask)

            def _release_slot(self, slot):
                super()._release_slot(slot)
                outer.draft_kv_mask[slot] = False

            def _step(self):
                outer._spec_step()

        return _Inner

    def _init_draft(self, draft_params, draft_cfg, slots, draft_len,
                    k_spec, kv_bits, plan=None) -> None:
        device = self._engine.device
        if draft_params.device != device:
            raise ValueError(
                f"draft params live on {draft_params.device}, the engine "
                f"on {device}; build them with the same device"
            )
        kv_cfg = draft_cfg
        if plan is not None:
            # The draft rides the same mesh: its cache's kv-head rule
            # first (its head count can differ from the target's), then
            # its weights must be the rank's shard too.
            plan.check_kv_heads(draft_cfg.n_kv_heads)
            plan.check_shard(draft_params)
            kv_cfg = plan.shard_config(draft_cfg)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.k_spec = k_spec
        self.draft_cache = init_kv_cache(kv_cfg, slots, draft_len,
                                         kv_bits=kv_bits, device=device)
        self.draft_kv_mask = torch.zeros((slots, draft_len), dtype=torch.bool,
                                         device=device)
        self.proposed = 0
        self.accepted = 0
        self.rounds = 0
        # Adaptive ragged rounds move k_cur within 1..k_spec; every other
        # mode proposes the full k_spec.
        self.k_cur = k_spec
        self._accept_ema = None  # EMA of the per-round acceptance

    # -- public surface (delegated) ----------------------------------------

    def submit(self, prompt, max_new_tokens=None, temperature=None,
               stop=None, logit_bias=None, deadline_s=None) -> int:
        # The inner engine owns the greedy-only refusals, so library and
        # HTTP callers get the same ValueError.
        return self._engine.submit(prompt, max_new_tokens=max_new_tokens,
                                   temperature=temperature, stop=stop,
                                   logit_bias=logit_bias,
                                   deadline_s=deadline_s)

    def run(self) -> dict:
        return self._engine.run()

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def spec_stats(self) -> dict:
        """The /stats "speculative" block."""
        return {
            "rounds": self.rounds,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": self.acceptance_rate,
            "draft_len": self.k_cur,
        }

    # -- internals ---------------------------------------------------------

    def _adapt_draft_len(self, n_proposed: int, n_accepted: int) -> None:
        """Acceptance-adaptive draft length (EMA-smoothed): a draft that
        keeps being rejected wastes verify rows of the shared ragged
        budget, so k_cur shrinks toward 1; sustained acceptance grows it
        back toward k_spec."""
        if not n_proposed:
            return
        r = n_accepted / n_proposed
        self._accept_ema = (r if self._accept_ema is None
                            else 0.8 * self._accept_ema + 0.2 * r)
        if self._accept_ema >= 0.8 and self.k_cur < self.k_spec:
            self.k_cur += 1
        elif self._accept_ema < 0.4 and self.k_cur > 1:
            self.k_cur -= 1

    def _admit_draft(self, slot, padded, prompt_mask) -> None:
        # Looked up in its module at each call (a counting stand-in sees
        # the draft primes).
        _continuous._admit_slot(self.draft_params, self.draft_cfg, padded,
                                prompt_mask, self.draft_cache,
                                self.draft_kv_mask, slot)

    def _propose(self, k: int) -> torch.Tensor:
        """The draft's (B, k) proposals from every slot's last token at
        its pointer; returns them with the (B, 1) inputs concatenated in
        front: the verify chunk."""
        eng = self._engine
        last = eng._up(eng.tokens).long()
        proposals = _draft_propose(self.draft_params, self.draft_cfg, last,
                                   self.draft_cache, eng._up(eng.positions),
                                   k, kv_mask=self.draft_kv_mask)
        return torch.cat([last, proposals], dim=1)


class SpeculativeContinuousBatcher(_SpecServingBase):
    """Continuous batching with speculative decoding as the STEP: every
    round, the draft proposes k tokens per slot and the target verifies
    them in one (B, k+1) forward at per-slot offsets, over the fixed-slot
    engine's caches. Greedy only. ``device`` and ``generator`` go to the
    inner ``ContinuousBatcher``; its admissions prefill through the flash
    kernel on the card, the verify and the draft attend plainly.

    >>> sb = SpeculativeContinuousBatcher(params, cfg, dparams, dcfg,
    ...                                   slots=4, cache_len=256)
    >>> rids = [sb.submit(p) for p in prompts]
    >>> results = sb.run()                  # {rid: tokens}
    >>> sb.acceptance_rate
    """

    def __init__(
        self,
        params: Llama,
        target_cfg: LlamaConfig,
        draft_params: Llama,
        draft_cfg: LlamaConfig,
        gen: Optional[GenerationConfig] = None,
        slots: int = 8,
        cache_len: int = 1024,
        prompt_bucket: int = 64,
        generator: Optional[torch.Generator] = None,
        k_spec: int = 4,
        plan=None,
        kv_bits: int = 0,  # 8 → int8 KV for BOTH target and draft caches
        device=None,
    ):
        gen = gen or GenerationConfig()
        self._require_greedy(gen)
        if plan is not None and plan.mesh.shape.get("sp", 1) > 1:
            raise ValueError(
                "SpeculativeContinuousBatcher does not support sp-sharded "
                "meshes: draft-propose and target-verify run the chunked "
                "decode (K>1 tokens per step), which has no split-KV sp "
                "merge; use tp (and dp/fsdp) axes, or ContinuousBatcher "
                "for sp-sharded caches"
            )
        # A round writes up to k_spec + 1 slots past the pointer before
        # rewinding; the cache needs that headroom past the nominal span.
        if prompt_bucket + gen.max_new_tokens + k_spec + 1 > cache_len:
            raise ValueError(
                f"cache_len {cache_len} too small for prompt_bucket "
                f"{prompt_bucket} + max_new_tokens {gen.max_new_tokens} + "
                f"k_spec {k_spec} + 1 speculative headroom"
            )
        self._engine = self._cb = self._make_inner(
            _continuous.ContinuousBatcher)(
            params, target_cfg, gen=gen, slots=slots, cache_len=cache_len,
            prompt_bucket=prompt_bucket, generator=generator, plan=plan,
            kv_bits=kv_bits, device=device,
        )
        self._init_draft(draft_params, draft_cfg, slots, cache_len, k_spec,
                         kv_bits, plan)

    def _spec_step(self) -> None:
        cb = self._cb
        active = [i for i, r in enumerate(cb._by_slot) if r is not None]
        if not active:
            return
        chunk = self._propose(self.k_spec)
        preds = _target_verify(cb.params, cb.cfg, chunk, cb.cache,
                               cb._up(cb.positions), kv_mask=cb.kv_mask)
        _apply_spec_round(self, cb, active, preds.cpu().numpy(),
                          chunk[:, 1:].cpu().numpy())


class SpeculativePagedBatcher(_SpecServingBase):
    """Speculative decoding over the PAGED block pool: the draft proposes
    k tokens per slot from a dense side cache (the draft is small: paging
    it would save little), and the target verifies them THROUGH the block
    tables, so memory stays pool-sized while throughput multiplies by the
    acceptance rate.

    ``ragged=False``: each round is a (B, k+1) ``_paged_verify`` on the
    gathered view. ``ragged=True``: each decoding slot's (1 + k) verify
    span rides the fused dispatch with the admission chunks
    (``_spec_step_ragged``), attended by the ragged kernel on the card;
    ``adaptive`` moves the span length within 1..k_spec. ``kv_bits=8``
    makes the pool and the draft cache int8. ``device``, ``generator`` and
    ``attn_kernel`` go to the inner ``PagedBatcher``.

    >>> sb = SpeculativePagedBatcher(params, cfg, dparams, dcfg,
    ...                              slots=4, num_blocks=64, ragged=True)
    >>> rids = [sb.submit(p) for p in prompts]
    >>> results = sb.run()
    >>> sb.spec_stats()
    """

    def __init__(
        self,
        params: Llama,
        target_cfg: LlamaConfig,
        draft_params: Llama,
        draft_cfg: LlamaConfig,
        gen: Optional[GenerationConfig] = None,
        slots: int = 4,
        num_blocks: int = 64,
        block_size: int = 16,
        prompt_bucket: int = 64,
        generator: Optional[torch.Generator] = None,
        k_spec: int = 4,
        plan=None,
        kv_bits: int = 0,  # 8 → int8 pool AND draft cache
        headroom_tokens: int = 0,  # extra table span beyond k_spec + 1
        prompt_cache: bool = False,  # share identical prompts' TARGET blocks
        prefix_cache: bool = False,  # share common-prefix TARGET blocks
        admit_chunk=None,  # prefix-admission piece width
        ragged: bool = False,  # speculation as a ragged scheduling mode
        token_budget=None,  # ragged: verify + prefill rows per dispatch
        adaptive: bool = False,  # ragged: acceptance-adaptive draft length
        attn_kernel=None,
        device=None,
    ):
        gen = gen or GenerationConfig()
        self._require_greedy(gen)
        if adaptive and not ragged:
            raise ValueError(
                "adaptive=True requires ragged=True: the fixed-slot "
                "verify program bakes k_spec in as a static shape; only "
                "ragged rounds can vary the span length per step"
            )
        if ragged:
            # Every decoding slot contributes 1 + k_spec verify rows; the
            # budget must hold a full-house round.
            if token_budget is None:
                token_budget = max(512, slots * (k_spec + 1))
            if token_budget < slots * (k_spec + 1):
                raise ValueError(
                    f"token_budget {token_budget} < slots*(k_spec+1) = "
                    f"{slots * (k_spec + 1)}: every decoding slot "
                    "contributes 1+k_spec verify rows per ragged step"
                )
        self.adaptive = bool(adaptive)
        self._engine = self._pb = self._make_inner(_paged.PagedBatcher)(
            params, target_cfg, gen=gen, slots=slots, num_blocks=num_blocks,
            block_size=block_size, prompt_bucket=prompt_bucket,
            generator=generator, kv_bits=kv_bits,
            # A round writes up to k_spec + 1 slots past the pointer; the
            # caller's headroom comes on top.
            headroom_tokens=k_spec + 1 + headroom_tokens,
            # A hit skips only the TARGET prefill; the draft re-prefills
            # through _post_admit.
            prompt_cache=prompt_cache, prefix_cache=prefix_cache,
            admit_chunk=admit_chunk, ragged=ragged,
            token_budget=token_budget, attn_kernel=attn_kernel,
            plan=plan, device=device,
        )
        # A dense draft cache over the pool's logical window.
        self._init_draft(draft_params, draft_cfg, slots,
                         self._pb.max_blocks * block_size, k_spec, kv_bits,
                         plan)

    @property
    def free_blocks(self) -> int:
        return self._pb.free_blocks

    def _spec_step(self) -> None:
        if self._pb.ragged:
            self._spec_step_ragged()
            return
        pb = self._pb
        # Blocks for the whole verify chunk first (may preempt; returns
        # the active set after it).
        active = pb._ensure_step_blocks(span=self.k_spec + 1)
        if not active:
            return
        chunk = self._propose(self.k_spec)
        preds = _paged._paged_verify(
            pb.params, pb.cfg, chunk, pb.pool, pb._up(pb.tables),
            pb._up(pb.positions), pb.kv_mask, pb.block_size,
        )
        _apply_spec_round(self, pb, active, preds.cpu().numpy(),
                          chunk[:, 1:].cpu().numpy())

    def _spec_step_ragged(self) -> None:
        """One round as a RAGGED scheduling mode: each decoding slot
        contributes a (1 + k) verify span, its last token and the draft's
        k proposals, to the SAME fused dispatch that carries admission
        chunks; the span's rows land in the paged blocks through the
        tables like decode rows (span causality is the attention's
        position bound).

        Rollback: the (1 + k) cells each span will write are copied
        BEFORE the dispatch; after the acceptance walk the rejected
        suffix's cells are written back byte for byte and the trailing
        blocks the rewound pointer no longer covers are freed, so the pool
        ends every round as if the accepted tokens had been decoded one at
        a time."""
        pb = self._pb
        pb._expire_ragged_admissions()
        k = self.k_cur if self.adaptive else self.k_spec
        active = pb._ensure_step_blocks(span=k + 1)
        if not active and not pb._ragged_admit:
            return
        props_np = None
        if active:
            props_np = self._propose(k)[:, 1:].cpu().numpy()
        spans = {
            slot: ([int(pb.tokens[slot, 0])]
                   + [int(t) for t in props_np[slot]],
                   int(pb.positions[slot]))
            for slot in active
        }
        (tokens, tok_pos, tok_seq, seq_starts, seq_lens, kv_lens,
         last_rows, rows, completing) = pb._assemble_ragged(spans)
        if rows == 0:
            return
        # The cells every span will write, [slot-major, offset-minor]:
        # span i's offset j at index i * (k + 1) + j.
        cell_blks: list[int] = []
        cell_offs: list[int] = []
        for slot in active:
            req = pb._by_slot[slot]
            p0 = int(pb.positions[slot])
            for j in range(k + 1):
                cell_blks.append(req.blocks[(p0 + j) // pb.block_size])
                cell_offs.append((p0 + j) % pb.block_size)
        snap = (_paged._gather_cells(pb.pool, cell_blks, cell_offs)
                if cell_blks else None)
        width = pb._dispatch_width(rows)
        up = pb._up
        preds = _paged._paged_ragged_verify(
            pb.params, pb.cfg, up(tokens[:width]), pb.pool, up(pb.tables),
            pb.kv_mask, up(tok_pos[:width]), up(tok_seq[:width]), rows,
            up(seq_starts), up(seq_lens), up(kv_lens), pb.block_size,
            attn_kernel=pb.attn_kernel, adapters=pb._ragged_adapters(),
        )
        pb._stamp_ragged(rows, decode_rows=(k + 1) * len(active))
        host_preds = preds.cpu().numpy()
        if active:
            # Per-slot verdicts, indexed by SLOT as the fixed-slot path,
            # so _apply_spec_round is shared as it is.
            preds_mat = np.zeros((pb.slots, k + 1), host_preds.dtype)
            for slot in active:
                s0 = int(seq_starts[slot])
                preds_mat[slot] = host_preds[s0:s0 + k + 1]
            p_before, a_before = self.proposed, self.accepted
            accepts = _apply_spec_round(self, pb, active, preds_mat,
                                        props_np, k_spec=k)
            # Roll the rejected suffix back in one indexed write a leaf.
            # A restore into a block a retired slot already freed is
            # harmless: the block is rewritten before anything reads it.
            idx = [j for i, slot in enumerate(active)
                   for j in range(i * (k + 1) + accepts[slot] + 1,
                                  (i + 1) * (k + 1))]
            if idx:
                at = torch.as_tensor(idx, dtype=torch.long,
                                     device=pb.device)
                _paged._restore_cells(
                    pb.pool, {name: leaf[at] for name, leaf in snap.items()},
                    [cell_blks[j] for j in idx],
                    [cell_offs[j] for j in idx])
            # Free the trailing blocks the rewound pointer no longer
            # covers: each live slot keeps exactly the blocks the
            # never-speculated path would hold.
            for slot in active:
                req = pb._by_slot[slot]
                if req is None:
                    continue  # retired mid-round: its blocks are freed
                keep = (int(pb.positions[slot]) - 1) // pb.block_size + 1
                while len(req.blocks) > max(keep, 1):
                    blk = req.blocks.pop()
                    pb.tables[slot, len(req.blocks)] = 0
                    pb._free.append(blk)
            if self.adaptive:
                self._adapt_draft_len(self.proposed - p_before,
                                      self.accepted - a_before)
        # Admissions whose last chunk rode this dispatch: the first token
        # is the argmax at the span's last row (no logprob).
        pb._complete_ragged_admissions(
            completing,
            {s: int(host_preds[int(last_rows[s])]) for s in completing},
            {},
        )


def truncated_draft(params: Llama, cfg: LlamaConfig,
                    n_layers: int) -> tuple[Llama, LlamaConfig]:
    """A zero-training draft from the TARGET's own weights: its first
    ``n_layers`` layers (the same ``LlamaLayer`` modules, quantized
    projections and their checked kernel plans included), with the
    embedding, final norm and lm head shared, not copied, and the
    target's tp shard record. Returns (draft_params, draft_cfg) for any
    spec engine."""
    if not 1 <= n_layers < cfg.n_layers:
        raise ValueError(
            f"draft n_layers must be in 1..{cfg.n_layers - 1}, "
            f"got {n_layers}"
        )
    dcfg = dataclasses.replace(cfg, n_layers=n_layers)
    draft = Llama(dcfg, device="meta")
    draft.layers = nn.ModuleList(params.layers[:n_layers])
    for name in ("embed", "final_norm", "lm_head"):
        w = getattr(params, name)
        if w is not None:
            _set(draft, name, w)
    # A tp shard's draft is the same shard (its leaves are the target's).
    draft.shard = params.shard
    return draft, dcfg
