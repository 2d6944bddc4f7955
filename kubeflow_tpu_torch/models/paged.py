"""Paged KV cache serving: the block-pool engine, ragged and alternating.

Counterpart of ``kubeflow_tpu/models/paged.py``. The cache is carved into
fixed-size BLOCKS shared by all slots through per-slot block TABLES: a
request holds exactly the blocks its tokens occupy, blocks return to the
pool at retirement, and when the pool runs dry the YOUNGEST active request
is preempted and re-queued as a continuation prompt.

Two schedules, as in JAX:

- ``ragged=True``: every engine step is ONE fused dispatch over a
  flattened mixed batch (``_step_ragged``): each decoding slot contributes
  its next token, each admitting slot its next prompt chunk under the
  token budget, padded to a power-of-two width. ``_paged_ragged_step``
  scatters each token's K/V into its (block, offset), attends through
  ``ops/ragged_attention.py`` and samples each slot's span at its last
  row, so a completing admission's first token comes out of the same
  dispatch.
- ``ragged=False`` (the constructor's default, and what the server runs
  when ``KUBEFLOW_TPU_SERVING_RAGGED`` is unset or 0): admission and
  decode alternate. Each admission is a ``(1, Lb)`` prefill dispatch
  (``_paged_admit``) through ``ops/attention.py``'s flash forward, which
  writes the prompt's K/V into its blocks; each decode step
  (``_paged_step``) runs every slot's next token, attending through
  ``ops/paged_attention.py``'s paged decode for a bf16 pool with
  ``attn_kernel``, else through the gathered view and
  ``_gqa_decode_attention`` (int8 pools, sliding-window configs, and the
  CPU).

Each kernel's wrapper launches the CUDA kernel on the card and runs its
plain version on the CPU. Sliding-window configs keep every attention on
the gathered view, where the window bound lives (``attn_kernel`` defaults
off for them and refuses True), on both engines.

Two opt-in prompt-reuse tiers of the alternating engine, as in JAX:
``prompt_cache=True`` shares identical padded prompts' blocks and first
logits; ``prefix_cache=True`` admits position-0-ANCHORED (token i at
position i) and shares common prefixes block by block through a chain
hash (``_chain_key``), prefilling only the unmatched tail through the
tables (``_paged_prefix_admit``, in ``admit_chunk`` pieces, on the
gathered view: a chunk of more than one row never reaches the decode
kernel). ``swap_bytes`` > 0 demotes evicted prefix leaves to host memory
(LRU within the byte budget) and promotes them back on a chain hit.
``export_blocks``/``import_blocks`` carry a live request's prompt KV
between replicas (disaggregated serving) and
``export_chain``/``import_chain`` a cached chain (the fleet's peer prefix
tier), in the JAX package's version-1 wire format byte for byte: leaf
dtypes under JAX's names, each block's ``(L, Hkv, BS[, D])`` rows as
base64 of C-order bytes (bf16 through a 16-bit integer view).

The pool keeps the JAX package's stacked layout, ``(L, NB, Hkv, BS, D)``
per leaf (plus ``(L, NB, Hkv, BS)`` bf16 scale leaves for ``kv_bits=8``),
because it is the wire format. PyTorch has no buffer donation, so the
steps, swap promotion and imports update the pool IN PLACE instead of
returning a new one; a block they write is always a freshly taken one,
never one a running request holds. Block tables, positions and the
allocator are host numpy and plain Python between steps; block 0 is the
null block, never allocated.

Speculation and adapters hook in as in JAX: ``_paged_ragged_verify`` is the
ragged dispatch with an argmax head over every row (the speculative verify
spans of ``models/speculative.py``), ``_paged_verify`` the alternating
engine's (B, k+1) verify through the tables, ``_gather_cells`` and
``_restore_cells`` the snapshot and rollback of a verify's rejected cells,
``headroom_tokens`` the table span a round writes past the pointer, and
``_post_admit`` primes a lockstep draft cache at every admission that
prefills (one-shot, prompt-cache hit, prefix-cached, a completed ragged
admission). ``_ragged_adapters`` (None here, ``models/multilora.py``
overrides it) puts each slot's LoRA deltas into every ragged dispatch;
an adapter salts a request's chain keys and rides its KV payloads.

Sharded replicas (``plan=``, a ``parallel/mesh.py`` MeshPlan of tp,
fsdp and dp; ``models/tp_serving.py``): every rank of the replica runs
this engine in lockstep on its own shard, the step replicated over dp
and fsdp as JAX's is. The weights are cut by the caller
(``init_params(plan=)``, ``load_hf_checkpoint(plan=)`` or
``MeshPlan.shard_params``; fsdp's pieces gathered where the forward uses
them), the pool holds the rank's kv heads,
``(L, NB, Hkv/tp, BS, D)``, and the forward sums and gathers over the tp
group (``models/llama.py``). The host state (allocator, tables, chain
keys, generator) is the same on every rank, because the inputs and the
gathered logits are. The wire stays the 1-rank one: ``export_blocks``
and ``export_chain`` all-gather the heads of the blocks they ship (a
collective: every rank calls them together), ``import_blocks`` and
``import_chain`` keep each rank's head slice of the payload, and the swap
tier keeps each rank's own rows while counting the gathered bytes against
``swap_bytes``, as JAX's ``np.asarray`` of a sharded leaf does, so its
evictions are JAX's. ``_kv_block_bytes`` and ``pool_blocks_from_hbm``
take ``tp`` and size from per-shard headroom.

What differs from JAX under a plan: JAX refuses ``attn_kernel=True`` with
``plan=`` and defaults it off (a Pallas call under GSPMD would gather the
pool). A rank's tensors here are its own, so the kernels run over the
rank's heads as on one card: ``attn_kernel`` keeps its one-card default
(on, on the card) and accepts True.
"""

from __future__ import annotations

import base64
import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.continuous import (
    _AdmissionCursor,
    _BatcherBase,
    _Request,
    _sample_rows,
)
from kubeflow_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    _embed,
    _gqa_decode_attention,
    _kv_cache_leaves,
    _kv_quantize,
    _lm_head_logits,
    _merge_heads,
    _mlp,
    _mm,
    _norm,
    _prefill_impl,
    _qkv,
    _split_heads,
    _tp_sum,
    apply_rope,
    rope_frequencies,
    sample_logits,
)
from kubeflow_tpu_torch.models.serving import GenerationConfig, left_pad
from kubeflow_tpu_torch.ops.paged_attention import paged_decode_attention
from kubeflow_tpu_torch.ops.ragged_attention import (
    ragged_attention_reference,
    ragged_paged_attention,
)


def init_block_pool(cfg: LlamaConfig, num_blocks: int, block_size: int,
                    kv_bits: int = 0, device=None) -> dict:
    """k/v block pools, (L, NB, Hkv, BS, D); ``kv_bits=8`` stores int8
    values plus (L, NB, Hkv, BS) bf16 scale leaves."""
    shape = (cfg.n_layers, num_blocks, cfg.n_kv_heads, block_size,
             cfg.head_dim)
    return _kv_cache_leaves(shape, cfg.dtype, kv_bits, device)


def _kv_block_bytes(cfg: LlamaConfig, block_size: int, kv_bits: int = 0,
                    tp: int = 1) -> int:
    """Raw bytes ONE pool block occupies across every leaf (k + v, plus
    the bf16 scale leaves under kv_bits=8). ``tp`` > 1 gives the cost on
    one rank of a head-sharded pool: n_kv_heads/tp heads' rows."""
    if tp < 1 or cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must be >= 1 and divide n_kv_heads={cfg.n_kv_heads}"
        )
    rows = cfg.n_layers * (cfg.n_kv_heads // tp) * block_size
    if kv_bits == 8:
        # int8 values + one bf16 scale per (layer, head, offset) row.
        return 2 * rows * cfg.head_dim + 2 * rows * 2
    return 2 * rows * cfg.head_dim * 2  # bf16


def pool_blocks_from_hbm(
    cfg: LlamaConfig,
    block_size: int,
    kv_bits: int = 0,
    *,
    fraction: float = 0.5,
    fallback: int = 64,
    device=None,
    with_source: bool = False,
    tp: int = 1,
):
    """Size a block pool from the card's free memory: spend ``fraction``
    of it (free device memory plus what PyTorch's caching allocator holds
    unused) on KV blocks. A CPU device has no such number and returns
    ``fallback``. ``with_source`` returns ``(blocks, source)``, source
    ``"hbm"`` or ``"fallback"`` — the /stats pool-sizing record. ``tp``
    > 1 sizes off the rank's own headroom: a head-sharded pool costs each
    rank 1/tp of a block, so the same free memory holds tp× the blocks."""
    def _ret(blocks: int, source: str):
        return (blocks, source) if with_source else blocks

    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction!r}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        return _ret(fallback, "fallback")
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    budget = int(free * fraction)
    per_block = _kv_block_bytes(cfg, block_size, kv_bits, tp=tp)
    if budget <= 0:
        return _ret(fallback, "fallback")
    # Block 0 is the null block; 2 is the smallest pool with a usable one.
    return _ret(max(2, budget // per_block), "hbm")


def _scatter_chunk(pool_l: dict, k: torch.Tensor, v: torch.Tensor,
                   blks: torch.Tensor, offs: torch.Tensor) -> None:
    """Scatter a (B, Hkv, K, D) chunk into (block, offset) per token, IN
    PLACE: one indexed write per leaf for the whole chunk,
    ``pool[blks, :, offs] = rows`` (numpy's advanced-index semantics put
    the (B·K,) token axis first), where JAX unrolls one write per chunk
    column. A chunk's live tokens own distinct cells (requests own
    disjoint blocks, a chunk's positions differ), so the order of writes
    is immaterial; only the ragged step's tail pads share a cell, in the
    null block. Scale leaves present → quantize on write (int8 KV)."""
    news = {"k": k, "v": v}
    if "k_scale" in pool_l:
        (news["k"], news["k_scale"]), (news["v"], news["v_scale"]) = (
            _kv_quantize(k), _kv_quantize(v))
    bi, oi = blks.reshape(-1), offs.reshape(-1)
    for name, new in news.items():
        # (B, Hkv, K[, D]) → (B·K, Hkv[, D]), token-major as bi and oi.
        rows = new.transpose(1, 2).reshape(-1, *new.shape[1:2],
                                           *new.shape[3:])
        pool_l[name][bi, :, oi] = rows


def _chunk_coords(cfg: LlamaConfig, tables: torch.Tensor,
                  posmat: torch.Tensor, block_size: int):
    """Per-token (cos, sin, blks, offs) for a (B, K) chunk at absolute
    positions ``posmat`` through ``tables`` (B, MAXB)."""
    b, k_len = posmat.shape
    cos, sin = rope_frequencies(cfg, posmat.reshape(-1))
    cos = cos.reshape(b, k_len, -1)
    sin = sin.reshape(b, k_len, -1)
    blks = torch.gather(tables, 1, posmat // block_size)
    offs = posmat % block_size
    return cos, sin, blks, offs


def _gathered_view(pool_l: torch.Tensor, tables: torch.Tensor,
                   n_kv_heads: int, block_size: int,
                   head_dim: int) -> torch.Tensor:
    """(NB, Hkv, BS[, D])[tables] → the logical per-slot view
    (B, Hkv, MAXB·BS[, D]); value leaves and (one rank lower) int8 scale
    leaves alike."""
    b, maxb = tables.shape
    g = pool_l[tables.long()]
    perm = (0, 2, 1, 3) + ((4,) if g.dim() == 5 else ())
    shape = (b, n_kv_heads, maxb * block_size)
    if g.dim() == 5:
        shape += (head_dim,)
    return g.permute(perm).reshape(shape)


@torch.no_grad()
def _paged_admit(params: Llama, cfg: LlamaConfig,
                 tokens: torch.Tensor,            # (1, Lb) left-padded prompt
                 pool: dict,                      # updated in place
                 prompt_mask: Optional[torch.Tensor],  # (1, Lb) or None
                 blocks: torch.Tensor,            # (Lb // BS,) the slot's blocks
                 block_size: int,
                 attn_impl: str = "auto") -> torch.Tensor:
    """Prefill one prompt into its allocated blocks; returns its first
    logits (V,). The prefill fills a temporary (1, Lb) cache in the pool's
    storage format (int8 + scales when the pool has them); its K/V then go
    straight into the stacked pool IN PLACE, one indexed write per leaf
    over all layers, where JAX copies block by block into a new pool.
    ``attn_impl`` goes to the prefill's ``flash_attention``."""
    lb = tokens.shape[1]
    # The pool's own kv-head count: a tp rank's is n_kv_heads / tp.
    temp = _kv_cache_leaves(
        (cfg.n_layers, 1, pool["k"].shape[2], lb, cfg.head_dim), cfg.dtype,
        8 if "k_scale" in pool else 0, tokens.device)
    logits, temp = _prefill_impl(params, cfg, tokens, temp,
                                 kv_mask=prompt_mask, attn_impl=attn_impl)
    nblk = lb // block_size
    blocks = blocks.long()
    for name, buf in pool.items():
        t = temp[name][:, 0]  # (L, Hkv, Lb[, D])
        t = t.reshape(t.shape[0], t.shape[1], nblk, block_size,
                      *t.shape[3:]).transpose(1, 2)  # (L, nblk, Hkv, BS[, D])
        buf[:, blocks] = t
    return logits[0]


@torch.no_grad()
def _paged_step(
    params: Llama,
    cfg: LlamaConfig,
    tokens: torch.Tensor,      # (B, 1)
    pool: dict,                # updated in place
    tables: torch.Tensor,      # (B, MAXB)
    positions: torch.Tensor,   # (B,)
    kv_mask: torch.Tensor,     # (B, MAXB * BS)
    generator: torch.Generator,
    block_size: int,
    temps: torch.Tensor,       # (B,) per-slot sampling temperature
    top_k: int,
    top_p: float,
    bias: Optional[torch.Tensor] = None,  # (B, V) per-slot logit bias
    attn_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step across every slot, reading and writing through the
    tables; returns (next token, its logprob) per slot. Idle slots carry
    table row 0 (the null block), position 0 and an all-False kv_mask:
    their writes land in the null block and their rows are discarded."""
    positions = positions.long()
    cos, sin, blks, offs = _chunk_coords(cfg, tables.long(),
                                         positions[:, None], block_size)
    x = _paged_chunk_scan(
        params, cfg, tokens, pool, tables, kv_mask, cos, sin, blks, offs,
        positions, block_size, attn_kernel=attn_kernel,
    )
    logits = _lm_head_logits(_norm(x[:, 0], params.final_norm, cfg), params)
    return _sample_rows(logits, generator, temps, top_k, top_p, bias)


def _paged_chunk_scan(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                      pool: dict, tables, kv_mask, cos, sin, blks, offs,
                      attn_positions, block_size: int,
                      attn_kernel: bool = False,
                      ragged: Optional[tuple] = None,
                      adapters: Optional[tuple] = None) -> torch.Tensor:
    """The layer loop of a paged step: per layer, scatter the batch's
    (B, K) chunk of K/V into the pool (in place) BEFORE attention reads
    it, then attend through ``tables`` at ``attn_positions``.

    ``ragged = (seq_starts, seq_lens, kv_lens, seq_tables, seq_mask)``:
    the per-SEQUENCE metadata of a flattened mixed batch (K = 1, the
    ``tables``/``kv_mask`` per token), attended by the ragged kernel's
    wrapper with ``attn_kernel``, else by its plain version. Without it,
    ``attn_kernel`` reads the pool through ``tables`` with the paged
    decode kernel's wrapper (bf16 pools only: the constructor keeps it off
    for int8 pools, and the wrapper raises on one). The kernels take one
    row a slot and no window, as in JAX: a chunk of K > 1 rows (a prefix
    admission) and a sliding-window config go through the gathered view
    and ``_gqa_decode_attention`` whatever ``attn_kernel`` says, and so
    does everything without it.

    ``adapters = (stacked, ids (S,), scaling, route)`` (``_row_adapters``)
    adds each row's slot's LoRA deltas to the projections inside this one
    body, gathered one layer at a time (``multilora._gather_adapters``),
    so every caller (ragged decode, admission chunks, verify spans) is
    adapter-correct without a second forward. Returns the hidden states
    (B, K, dim)."""
    if adapters is not None:
        # Lazy: multilora subclasses PagedBatcher, so the module-level
        # import runs multilora → paged.
        from kubeflow_tpu_torch.models.multilora import (
            _adapted_mlp,
            _adapted_qkv,
            _delta,
            _gather_adapters,
        )

        stacked, ids, scaling, route = adapters
    x = _embed(params, cfg, tokens)
    use_kernel = (
        attn_kernel and tokens.shape[1] == 1 and not cfg.sliding_window
        and (ragged is not None or "k_scale" not in pool)
    )

    def gathered(leaf):
        return _gathered_view(leaf, tables, leaf.shape[1], block_size,
                              cfg.head_dim)

    for li, layer in enumerate(params.layers):
        pool_l = {name: leaf[li] for name, leaf in pool.items()}
        sel = (None if adapters is None
               else _gather_adapters(stacked, ids, li))
        h = _norm(x, layer.attn_norm, cfg)
        if sel is None:
            hq, hk, hv = _qkv(h, layer)
        else:
            hq, hk, hv = _adapted_qkv(h, layer, sel, scaling, route)
        q = apply_rope(_split_heads(hq, cfg.head_dim), cos, sin,
                       per_batch=True)
        k = apply_rope(_split_heads(hk, cfg.head_dim), cos, sin,
                       per_batch=True)
        v = _split_heads(hv, cfg.head_dim)
        _scatter_chunk(pool_l, k, v, blks, offs)
        if ragged is not None and not cfg.sliding_window:
            # The plain ragged attention has no window: a windowed config
            # takes the per-token gathered view below, as JAX's does.
            seq_starts, seq_lens, kv_lens, seq_tables, seq_mask = ragged
            attend = (ragged_paged_attention if use_kernel
                      else ragged_attention_reference)
            attn = attend(
                q[:, :, 0, :], pool_l["k"], pool_l["v"], seq_tables, seq_mask,
                seq_starts, seq_lens, kv_lens, block_size,
                k_scale_pool=pool_l.get("k_scale"),
                v_scale_pool=pool_l.get("v_scale"),
            )[:, :, None, :]
        elif use_kernel:
            attn = paged_decode_attention(
                q[:, :, 0, :], pool_l["k"], pool_l["v"], tables, kv_mask,
                attn_positions + 1, block_size,
            )[:, :, None, :]
        else:
            attn = _gqa_decode_attention(
                q, gathered(pool_l["k"]), gathered(pool_l["v"]),
                attn_positions, window=cfg.sliding_window, kv_mask=kv_mask,
                per_batch=True,
                k_scale=(gathered(pool_l["k_scale"])
                         if "k_scale" in pool_l else None),
                v_scale=(gathered(pool_l["v_scale"])
                         if "v_scale" in pool_l else None),
            )
        merged = _merge_heads(attn)
        o = _mm(merged, layer.wo)
        if sel is not None and "wo" in sel:
            o = o + _delta(merged, sel, "wo", scaling, route)
        x = x + _tp_sum(o, layer)
        h = _norm(x, layer.mlp_norm, cfg)
        x = x + (_mlp(layer, h, cfg) if sel is None
                 else _adapted_mlp(layer, h, cfg, sel, scaling, route))
    return x


def _row_adapters(adapters: Optional[tuple],
                  tok_seq: torch.Tensor) -> Optional[tuple]:
    """Per-SLOT adapter spec (stacked, ids (S,), scaling) → the chunk
    body's (stacked, ids, scaling, route), ``route`` sending each
    flattened row to its owning slot's pair (``multilora._slot_route``).
    None passes through (the base-only body)."""
    if adapters is None:
        return None
    from kubeflow_tpu_torch.models.multilora import _slot_route

    stacked, ids, scaling = adapters
    return stacked, ids.long(), scaling, _slot_route(stacked, ids, tok_seq)


def _ragged_hidden(params: Llama, cfg: LlamaConfig, tokens, pool, tables,
                   kv_mask, tok_pos, tok_seq, n_tokens: int, seq_starts,
                   seq_lens, kv_lens, block_size: int, attn_kernel: bool,
                   adapters) -> torch.Tensor:
    """The body of a ragged dispatch, shared by the sampling step and the
    verify: (T, 1, dim) hidden states, the pool written in place."""
    tok_seq = tok_seq.long()
    posmat = tok_pos.long()[:, None]
    tok_tables = tables.long()[tok_seq]
    cos, sin, blks, offs = _chunk_coords(cfg, tok_tables, posmat, block_size)
    # Tail pads carry tok_seq 0: force their scatter target to the null
    # block, or they would overwrite slot 0's live KV.
    tok_valid = torch.arange(tokens.shape[0], device=tokens.device) < n_tokens
    blks = torch.where(tok_valid[:, None], blks, 0)
    # The per-token view (each row its slot's table and mask, at its own
    # position) is what a sliding-window config attends through.
    return _paged_chunk_scan(
        params, cfg, tokens, pool, tok_tables, kv_mask[tok_seq], cos, sin,
        blks, offs, posmat, block_size, attn_kernel=attn_kernel,
        ragged=(seq_starts, seq_lens, kv_lens, tables, kv_mask),
        adapters=_row_adapters(adapters, tok_seq),
    )


@torch.no_grad()
def _paged_ragged_step(
    params: Llama,
    cfg: LlamaConfig,
    tokens: torch.Tensor,      # (T, 1) flattened mixed batch, tail-padded
    pool: dict,                # updated in place
    tables: torch.Tensor,      # (S, MAXB) per-SLOT block tables
    kv_mask: torch.Tensor,     # (S, MAXB * BS) per-slot validity
    tok_pos: torch.Tensor,     # (T,) absolute kv position per token
    tok_seq: torch.Tensor,     # (T,) owning slot per token (pads: 0)
    n_tokens: int,             # real rows; pads sit at the tail
    seq_starts: torch.Tensor,  # (S,) first row of each slot's span
    seq_lens: torch.Tensor,    # (S,) rows this step (0 = not participating)
    kv_lens: torch.Tensor,     # (S,) kv length INCLUDING this step's span
    last_rows: torch.Tensor,   # (S,) row of each slot's LAST token (0 if idle)
    generator: torch.Generator,
    block_size: int,
    temps: torch.Tensor,       # (S,) per-slot sampling temperature
    top_k: int,
    top_p: float,
    bias: Optional[torch.Tensor] = None,  # (S, V) per-slot logit bias
    attn_kernel: bool = False,
    adapters: Optional[tuple] = None,  # (stacked, ids (S,), scaling)
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE fused dispatch for a mixed decode/prefill batch. Every token
    scatters at its own (block, offset) and attends its slot's view at its
    own absolute position, so chunk causality and cross-chunk isolation
    fall out of the masking rule. Returns per-SLOT (next_token, chosen
    logprob) sampled at each span's last row; rows of mid-prefill or idle
    slots are sampled too and discarded by the scheduler. ``adapters``:
    every row rides its owning slot's LoRA adapter (multi-LoRA over the
    ragged dispatch; admission chunks included)."""
    x = _ragged_hidden(params, cfg, tokens, pool, tables, kv_mask, tok_pos,
                       tok_seq, n_tokens, seq_starts, seq_lens, kv_lens,
                       block_size, attn_kernel, adapters)
    # Logits only at each slot's last row: the lm head runs S wide.
    xs = x[last_rows.long(), 0]  # (S, dim)
    logits = _lm_head_logits(_norm(xs, params.final_norm, cfg), params)
    return _sample_rows(logits, generator, temps, top_k, top_p, bias)


@torch.no_grad()
def _paged_ragged_verify(
    params: Llama,
    cfg: LlamaConfig,
    tokens: torch.Tensor,      # (T, 1) flattened mixed batch, tail-padded
    pool: dict,                # updated in place
    tables: torch.Tensor,      # (S, MAXB)
    kv_mask: torch.Tensor,     # (S, MAXB * BS)
    tok_pos: torch.Tensor,     # (T,)
    tok_seq: torch.Tensor,     # (T,)
    n_tokens: int,
    seq_starts: torch.Tensor,  # (S,)
    seq_lens: torch.Tensor,    # (S,)
    kv_lens: torch.Tensor,     # (S,)
    block_size: int,
    attn_kernel: bool = False,
    adapters: Optional[tuple] = None,  # (stacked, ids (S,), scaling)
) -> torch.Tensor:
    """The ragged dispatch with a T-wide ARGMAX head: speculation as a
    scheduling mode of the fused step. The rows are laid out as for
    ``_paged_ragged_step``; a speculating slot's (1 + k) verify span
    [last, d_1..d_k] has at row j the target's prediction after ...[last,
    d_1..d_j], so the head runs at EVERY row (an admission-completing
    span's first token is its last row's argmax). Span causality is the
    attention's position bound: row j of a span sees k_pos <= kv_len -
    seq_len + j. Returns the per-row argmax (T,), the first maximum on
    ties as ``jnp.argmax``."""
    x = _ragged_hidden(params, cfg, tokens, pool, tables, kv_mask, tok_pos,
                       tok_seq, n_tokens, seq_starts, seq_lens, kv_lens,
                       block_size, attn_kernel, adapters)
    logits = _lm_head_logits(_norm(x[:, 0], params.final_norm, cfg), params)
    return torch.argmax(logits, dim=-1)


def _gather_cells(pool: dict, blks, offs) -> dict:
    """Snapshot the pool cells addressed by parallel (block, offset)
    lists, the read half of speculative rollback: a COPY (advanced
    indexing) that later in-place writes cannot alias. Value leaves
    (L, NB, Hkv, BS, D) gather to (N, L, Hkv, D), int8 scale leaves (one
    rank lower) to (N, L, Hkv): the indexed axes, split by a slice, move
    to the front."""
    dev = next(iter(pool.values())).device
    bi = torch.as_tensor(blks, dtype=torch.long, device=dev)
    oi = torch.as_tensor(offs, dtype=torch.long, device=dev)
    return {name: leaf[:, bi, :, oi] for name, leaf in pool.items()}


def _restore_cells(pool: dict, snap: dict, blks, offs) -> None:
    """Write a ``_gather_cells`` snapshot back IN PLACE, every leaf (int8
    scales too), the unwind half of rollback: a rejected cell returns to
    its exact pre-dispatch bytes."""
    dev = next(iter(pool.values())).device
    bi = torch.as_tensor(blks, dtype=torch.long, device=dev)
    oi = torch.as_tensor(offs, dtype=torch.long, device=dev)
    for name, leaf in pool.items():
        leaf[:, bi, :, oi] = snap[name]


@torch.no_grad()
def _paged_verify(
    params: Llama,
    cfg: LlamaConfig,
    chunk: torch.Tensor,       # (B, K): [last, d_1..d_{K-1}] per row
    pool: dict,                # updated in place
    tables: torch.Tensor,      # (B, MAXB)
    positions: torch.Tensor,   # (B,) per-row write offsets
    kv_mask: torch.Tensor,     # (B, MAXB * BS)
    block_size: int,
) -> torch.Tensor:
    """Target verification through the BLOCK POOL: decode a (B, K) chunk
    at per-row offsets (row b's token j writes block tables[b, (p_b + j)
    // BS], offset (p_b + j) % BS, and query j attends logical slots <=
    p_b + j) on the gathered view (a chunk of K > 1 rows never reaches
    the decode kernel, as in JAX). Returns the argmax predictions (B,
    K)."""
    positions = positions.long()
    k_len = chunk.shape[1]
    posmat = positions[:, None] + torch.arange(k_len, device=chunk.device)
    tables = tables.long()
    cos, sin, blks, offs = _chunk_coords(cfg, tables, posmat, block_size)
    x = _paged_chunk_scan(params, cfg, chunk, pool, tables, kv_mask, cos,
                          sin, blks, offs, posmat, block_size)
    logits = _lm_head_logits(_norm(x, params.final_norm, cfg), params)
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def _paged_prefix_admit(
    params: Llama,
    cfg: LlamaConfig,
    chunk: torch.Tensor,     # (1, Kp) tail tokens, right-padded
    pool: dict,              # updated in place
    table: torch.Tensor,     # (1, MAXB) the slot's table, prefix filled
    pos0: int,               # first tail position (a block multiple)
    kv_mask: torch.Tensor,   # (1, MAXB * BS)
    last_idx: int,           # the last REAL token's index in the chunk
    block_size: int,
) -> torch.Tensor:
    """Tail prefill THROUGH the block table (prefix-cached admission):
    the (1, Kp) chunk is decoded at positions ``pos0..pos0+Kp-1`` and
    attends the shared prefix blocks through the table, chunk-causal, on
    the gathered view. Right-padding needs no mask: pads sit at FUTURE
    positions, invisible to every real row, and decode overwrites each
    before any query reaches it. Returns the logits (V,) at
    ``last_idx``."""
    posmat = pos0 + torch.arange(chunk.shape[1], device=chunk.device)[None, :]
    table = table.long()
    cos, sin, blks, offs = _chunk_coords(cfg, table, posmat, block_size)
    x = _paged_chunk_scan(params, cfg, chunk, pool, table, kv_mask, cos, sin,
                          blks, offs, posmat, block_size)
    x_last = _norm(x[0, last_idx], params.final_norm, cfg)
    return _lm_head_logits(x_last[None], params)[0]


# The wire format's leaf dtypes, under the JAX package's names, with the
# numpy type that carries each one's bytes (numpy has no bf16: a 16-bit
# integer view carries it bit for bit).
_WIRE_DTYPES = {
    torch.bfloat16: ("bfloat16", np.int16),
    torch.float32: ("float32", np.float32),
    torch.int8: ("int8", np.int8),
}
_CARRIERS = {torch.bfloat16: torch.int16}


def _wire_dtype(leaf: torch.Tensor) -> str:
    return _WIRE_DTYPES[leaf.dtype][0]


def _rows_b64(rows: torch.Tensor) -> str:
    """One block's (L, Hkv, BS[, D]) rows → base64 of their C-order
    bytes."""
    rows = rows.contiguous()
    rows = rows.view(_CARRIERS.get(rows.dtype, rows.dtype))
    return base64.b64encode(rows.numpy().tobytes()).decode("ascii")


def _rows_from_b64(data: str, dtype: torch.dtype, shape: tuple) -> np.ndarray:
    """Inverse of ``_rows_b64``: the block's rows as a numpy array of the
    leaf's carrier type."""
    carrier = _WIRE_DTYPES[dtype][1]
    return np.frombuffer(base64.b64decode(data), dtype=carrier).reshape(shape)


def _carried_to_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Carrier-typed numpy rows → a CPU tensor of the leaf's dtype."""
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t.view(dtype) if dtype in _CARRIERS else t


class PagedBatcher(_BatcherBase):
    """Continuous batching over a shared block pool.

    >>> pb = PagedBatcher(params, cfg, slots=4, num_blocks=32, block_size=16)
    >>> ids = [pb.submit(p) for p in prompts]
    >>> results = pb.run()          # {rid: tokens}, EOS-truncated

    ``ragged=False`` (default) alternates prefill admissions with decode
    steps; ``ragged=True`` fuses both into one dispatch per step. ``device``
    is the card unless ``"cpu"`` is passed; ``params`` must live there.
    ``attn_kernel`` picks the decode attention: None runs the CUDA kernel
    on the card (the ragged kernel, or for ``ragged=False`` the paged
    decode kernel, which reads bf16 pools only, so it defaults off for
    ``kv_bits=8``; both default off for sliding-window configs) and the
    plain attention on the CPU; True on the CPU raises, as do True with
    ``kv_bits`` and no ``ragged`` and True with a sliding window; False on
    the card runs the plain attention (for comparing the two). Admission
    prefills always go through ``flash_attention(impl="auto")``; prefix-
    cached admissions through the gathered view. ``prompt_cache``,
    ``prefix_cache`` (with ``admit_chunk``) and ``swap_bytes`` keep the
    JAX semantics and messages. Sampled rows draw from ``generator`` (a
    seeded ``torch.Generator`` on the device; seed 0 when None), so they
    cannot match JAX's draws bit for bit. ``headroom_tokens`` widens the
    block tables by that many positions (the speculative engines' verify
    writes past the pointer). ``plan`` (a pure-``tp`` MeshPlan) makes this
    engine one rank of a tensor-parallel replica: ``params`` must be the
    rank's shard (``MeshPlan.check_shard``), and the pool holds the rank's
    kv heads; every rank must make the same calls.
    """

    def __init__(
        self,
        params: Llama,
        cfg: LlamaConfig,
        gen: Optional[GenerationConfig] = None,
        slots: int = 4,
        num_blocks: int = 64,
        block_size: int = 16,
        prompt_bucket: int = 64,
        generator: Optional[torch.Generator] = None,
        plan=None,
        kv_bits: int = 0,  # 8 → int8 block pool (halved KV bytes)
        prompt_cache: bool = False,  # share identical prompts' blocks
        prefix_cache: bool = False,  # share common PREFIXES block by block
        admit_chunk: Optional[int] = None,  # prefix-admission piece width
        attn_kernel: Optional[bool] = None,  # CUDA attention kernels
        ragged: bool = False,  # fused mixed prefill/decode batches
        token_budget: Optional[int] = None,  # ragged rows per step
        hbm_fraction: Optional[float] = None,  # size pool from device memory
        swap_bytes: int = 0,  # host-RAM swap tier for cold prefix chains
        headroom_tokens: int = 0,  # extra table span (speculative rounds)
        device=None,
    ):
        self.gen = gen or GenerationConfig()
        self.device = resolve_device(device)
        if attn_kernel and kv_bits and not ragged:
            raise ValueError(
                "attn_kernel=True does not compose with kv_bits on the "
                "per-token decode kernel (it reads bf16 pools; an int8 "
                "pool would silently run the gathered path) — the RAGGED "
                "kernel dequantizes int8 pools: add ragged=True or drop "
                "one of the two"
            )
        if attn_kernel and cfg.sliding_window:
            raise ValueError(
                "attn_kernel=True does not support sliding-window "
                "configs (the window bound lives in the gathered path) "
                "— drop attn_kernel for this model"
            )
        if attn_kernel and self.device.type != "cuda":
            raise ValueError(
                "attn_kernel=True needs the CUDA card; on device='cpu' the "
                "engine runs the plain attention (leave attn_kernel unset)"
            )
        self.attn_kernel = (
            self.device.type == "cuda" and (not kv_bits or ragged)
            and not cfg.sliding_window
            if attn_kernel is None else bool(attn_kernel)
        )
        if params.device != self.device:
            raise ValueError(
                f"params live on {params.device}, the engine on "
                f"{self.device}; build them with the same device"
            )
        if prompt_bucket % block_size:
            raise ValueError(
                f"prompt_bucket {prompt_bucket} must be a multiple of "
                f"block_size {block_size}"
            )
        if admit_chunk is None:
            # ~256 tokens, rounded up to a block multiple so the default
            # is valid for any block_size (it only matters on the
            # prefix_cache admission path).
            admit_chunk = max(block_size, -(-256 // block_size) * block_size)
        elif prefix_cache and (admit_chunk % block_size or admit_chunk <= 0):
            raise ValueError(
                f"admit_chunk {admit_chunk} must be a positive multiple "
                f"of block_size {block_size}"
            )
        if prompt_cache and prefix_cache:
            raise ValueError(
                "prompt_cache and prefix_cache are mutually exclusive: "
                "prefix_cache subsumes whole-prompt sharing (identical "
                "prompts share all their full blocks) under the "
                "position-0-anchored layout"
            )
        if ragged:
            if prompt_cache or prefix_cache:
                raise ValueError(
                    "ragged=True does not compose with prompt_cache/"
                    "prefix_cache yet — the sharing tiers admit through "
                    "their own prefill programs; drop one of the two"
                )
            if token_budget is None:
                token_budget = 512
            if token_budget < slots:
                raise ValueError(
                    f"token_budget {token_budget} < slots {slots}: every "
                    "decoding slot needs one row per step"
                )
        self.ragged = bool(ragged)
        self.token_budget = int(token_budget) if ragged else 0
        self._ragged_admit: dict[int, dict] = {}
        # Batch-fill observability (/stats "ragged"): fraction of the last
        # step's budget carrying real tokens, plus lifetime counters.
        self.ragged_fill = 0.0
        self.ragged_steps = 0
        self.ragged_tokens = 0
        kv_cfg = cfg
        if plan is not None:
            # A paged pool shards by BLOCK ownership, not by contiguous
            # sequence ranges: there is no sequence axis to split.
            if plan.mesh.shape.get("sp", 1) > 1:
                raise ValueError(
                    "PagedBatcher does not support sp-sharded meshes; "
                    "the block pool has no contiguous sequence axis to "
                    "shard (use ContinuousBatcher for sp)"
                )
            # The pool's kv-head rule first, before any weight is cut.
            plan.check_kv_heads(cfg.n_kv_heads)
            plan.check_shard(params)
            kv_cfg = plan.shard_config(cfg)
        self.plan = plan
        # /stats "mesh": the replica's non-trivial axes; None on one rank,
        # so the one-rank stats stay as they were.
        self.mesh_axes = plan.axes if plan is not None else None
        self._tp = plan.tp if plan is not None else 1
        self._tp_rank = plan.tp_rank if plan is not None else 0
        self._tp_group = plan.tp_group if plan is not None else None
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.block_size = block_size
        if hbm_fraction is not None:
            num_blocks, self.pool_source = pool_blocks_from_hbm(
                cfg, block_size, kv_bits, fraction=hbm_fraction,
                fallback=num_blocks, device=self.device, with_source=True,
                tp=self._tp,
            )
        else:
            self.pool_source = "config"
        self.num_blocks = num_blocks
        self.prompt_bucket = prompt_bucket
        # Capacity (in blocks) one request can ever hold: +1 because a
        # preempted continuation re-admits at a block-aligned padded
        # length, which can overhang the nominal span by one block.
        # ``headroom_tokens``: a speculative round writes up to k_spec + 1
        # positions past the pointer before rewinding; the tables must
        # span those too.
        self.max_blocks = (
            prompt_bucket + self.gen.max_new_tokens + headroom_tokens
            + block_size - 1
        ) // block_size + 1
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator lives on {generator.device}, the engine on "
                f"{self.device}"
            )
        self.generator = generator
        self.pool = init_block_pool(kv_cfg, num_blocks, block_size,
                                    kv_bits=kv_bits, device=self.device)
        self.kv_mask = torch.zeros((slots, self.max_blocks * block_size),
                                   dtype=torch.bool, device=self.device)
        self.tables = np.zeros((slots, self.max_blocks), np.int32)
        self.positions = np.zeros((slots,), np.int32)
        self.tokens = np.full((slots, 1), self.gen.pad_id, np.int32)
        # Block 0 is the NULL block, never allocated: inactive slots keep
        # tables=0/positions=0, so their ignored writes land there.
        self._free = list(range(1, num_blocks))
        # Prompt cache: identical PADDED prompts share their prompt blocks
        # and first logits. Decode writes only land at positions >= the
        # (block-aligned) bucket, so shared blocks are never written.
        # Entries are evicted before the allocator preempts.
        self._prompt_cache_enabled = prompt_cache
        self._prompt_cache: dict = {}  # (padded, mask) bytes -> entry
        self._shared_refs: dict = {}  # block -> cache hold + active users
        # Prefix cache: position-0-anchored admission makes a common
        # prefix occupy identical blocks at identical positions across
        # prompts of any length, so full prompt blocks are content-
        # addressed by the chain hash and shared. The block of the LAST
        # prompt token is never registered (decode writes it, and a
        # full-chain hit would leave no tail to take logits from). Only
        # chain LEAVES are evictable.
        self._prefix_cache_enabled = prefix_cache
        self._prefix_entries: dict = {}  # chain key -> block/parent/children
        # Counted over registrable prompt blocks at committed admissions
        # (a hit is a block whose prefill was skipped).
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_evictions = 0
        self.admit_chunk = admit_chunk
        # Host-RAM swap tier: a demoted prefix leaf's rows are copied to
        # host tensors under the same chain key, within a byte budget
        # with LRU demotion; a chain walk that misses the pool but hits
        # here promotes the block back (a prefix hit: its prefill is
        # skipped). The parent key rides along so promotion can refuse a
        # chain that no longer matches.
        if swap_bytes < 0:
            raise ValueError(f"swap_bytes must be >= 0, got {swap_bytes}")
        self.swap_bytes_limit = int(swap_bytes)
        self._swap: "OrderedDict[bytes, dict]" = OrderedDict()
        self.swap_bytes_used = 0
        self.kv_swap_out = 0
        self.kv_swap_in = 0
        self.kv_swap_restored_tokens = 0
        # KV handoff (disaggregated serving): lifetime counters, plus the
        # imported requests' first tokens, delivered at the next
        # admission pass (after the serving frontend has registered the
        # request).
        self.kv_exports = 0
        self.kv_imports = 0
        self.kv_import_blocks_reused = 0
        self.kv_import_blocks_written = 0
        self._kv_pending_first: list[tuple] = []
        # Peer prefix tier: cache-chain export/import counters.
        self.kv_chain_exports = 0
        self.kv_chain_imports = 0
        self.kv_chain_blocks_sent = 0
        self.kv_chain_blocks_written = 0
        self._init_base(self.gen, slots, prompt_bucket)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    # -- allocator ---------------------------------------------------------

    def _take_blocks(self, n: int, preempt: bool = True) -> Optional[list[int]]:
        """n blocks off the free list. Idle cached blocks yield first
        (``_evict_cached``). Then, with ``preempt`` (the DECODE path: a
        running request needs its next block), the youngest active request
        is evicted until the pool can supply n; the ADMISSION path passes
        preempt=False and waits for retirements instead (evicting a
        running request to admit a queued one thrashes). None when the
        pool cannot supply n under the given policy."""
        while len(self._free) < n:
            if self._evict_cached():
                continue
            if not preempt:
                return None
            victim = self._youngest_active()
            if victim is None:
                return None
            self._preempt(victim)
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def _evict_cached(self) -> bool:
        """Free one cache-held block set, whichever cache is on."""
        if self._prompt_cache_enabled:
            return self._evict_cached_prompt()
        if self._prefix_cache_enabled:
            return self._evict_prefix_leaf()
        return False

    def _evict_prefix_leaf(self) -> bool:
        """Drop one prefix-chain LEAF no active request references
        (refcount 1, the cache's own hold), returning its block. Leaf-only:
        matching walks parent to child, so an evicted middle link would
        orphan its tail. Insertion order is the LRU order (hits re-append
        their chain). With a swap budget the leaf is demoted to host
        memory first."""
        for key, ent in self._prefix_entries.items():
            if (ent["children"] == 0
                    and self._shared_refs.get(ent["block"], 0) == 1):
                if self.swap_bytes_limit:
                    self._swap_out(key, ent)
                del self._prefix_entries[key]
                del self._shared_refs[ent["block"]]
                self._free.append(ent["block"])
                if ent["parent"] is not None:
                    self._prefix_entries[ent["parent"]]["children"] -= 1
                self.prefix_evictions += 1
                return True
        return False

    def _evict_cached_prompt(self) -> bool:
        """Drop one cached prompt no active request references (every
        block at refcount 1), returning its blocks. Insertion order is the
        LRU order (hits move their entry to the end)."""
        for key, entry in self._prompt_cache.items():
            if all(self._shared_refs.get(b, 0) == 1 for b in entry["blocks"]):
                del self._prompt_cache[key]
                for b in entry["blocks"]:
                    del self._shared_refs[b]
                    self._free.append(b)
                return True
        return False

    def _reserve_take(self, need: int) -> Optional[list[int]]:
        """Watermark-guarded admission allocation: keep one free block per
        RUNNING request on top of the admit cost, so admission never grabs
        the blocks running slots need at their next boundary. Cached
        blocks yield first; never preempts; None = stall."""
        reserve = sum(1 for r in self._by_slot if r is not None)
        while len(self._free) < need + reserve and self._evict_cached():
            pass
        if len(self._free) < need + reserve:
            return None
        return self._take_blocks(need, preempt=False)

    # -- host-RAM swap tier ------------------------------------------------

    def _swap_out(self, key: bytes, ent: dict) -> None:
        """Demote one prefix leaf's block to host memory: a copy of every
        pool leaf's rows for the block, keyed by its chain key, within
        ``swap_bytes_limit`` (LRU eviction inside the tier; a block over
        the whole budget is plainly evicted)."""
        leaves = {name: leaf[:, ent["block"]].to("cpu", copy=True)
                  for name, leaf in self.pool.items()}
        # Each rank keeps its own heads' rows; the budget counts the
        # gathered block, as JAX's np.asarray of a sharded leaf does.
        nbytes = self._tp * sum(t.numel() * t.element_size()
                                for t in leaves.values())
        if nbytes > self.swap_bytes_limit:
            return
        old = self._swap.pop(key, None)
        if old is not None:
            self.swap_bytes_used -= old["bytes"]
        self._swap[key] = {
            "leaves": leaves, "parent": ent["parent"], "bytes": nbytes,
        }
        self.swap_bytes_used += nbytes
        self.kv_swap_out += 1
        while self.swap_bytes_used > self.swap_bytes_limit:
            _, victim = self._swap.popitem(last=False)  # LRU
            self.swap_bytes_used -= victim["bytes"]

    def _swap_promote(self, key: bytes, parent: Optional[bytes]):
        """Promote a swap-resident block back into a freshly taken pool
        block and re-register it on the prefix chain (cache hold,
        refcount 1). Returns the new ``_prefix_entries`` record, or None
        when the key is not swap-resident, its recorded parent differs
        from the caller's chain walk, or the pool cannot spare a block
        under the admission watermark (all three are a miss)."""
        entry = self._swap.get(key)
        if entry is None or entry["parent"] != parent:
            return None
        blocks = self._reserve_take(1)
        if blocks is None:
            return None
        (blk,) = blocks
        for name, host in entry["leaves"].items():
            self.pool[name][:, blk] = host.to(self.device)
        del self._swap[key]
        self.swap_bytes_used -= entry["bytes"]
        ent = {"block": blk, "parent": parent, "children": 0}
        self._prefix_entries[key] = ent
        if parent is not None:
            self._prefix_entries[parent]["children"] += 1
        self._shared_refs[blk] = 1
        self.kv_swap_in += 1
        self.kv_swap_restored_tokens += self.block_size
        return ent

    def swap_contains(self, key: bytes) -> bool:
        """True when a chain key's block sits in the host-RAM tier (the
        /kv/probe advisory: restorable without a prefill)."""
        return key in self._swap

    @property
    def swap_blocks(self) -> int:
        """Blocks parked in the host-RAM swap tier."""
        return len(self._swap)

    @property
    def prefix_cached_blocks(self) -> int:
        """Blocks registered on warm prefix chains."""
        return len(self._prefix_entries)

    @staticmethod
    def _chain_key(parent: Optional[bytes], tokens,
                   adapter: Optional[int] = None) -> bytes:
        """Content address of one full block given its prefix chain:
        ``sha1(parent ‖ int32 tokens)`` from the ``b"root"`` root (an
        adapter salts the root), byte for byte the JAX package's."""
        if parent is None:
            parent = (b"root" if adapter is None
                      else b"root|adapter:%d" % int(adapter))
        h = hashlib.sha1(parent)
        h.update(np.asarray(tokens, np.int32).tobytes())
        return h.digest()

    def _youngest_active(self) -> Optional[int]:
        slots = [
            (req.rid, slot)
            for slot, req in enumerate(self._by_slot)
            if req is not None
        ]
        # Mid-prefill admissions hold their full bucket of blocks: they
        # must be preemptable too.
        slots += [
            (a["req"].rid, slot) for slot, a in self._ragged_admit.items()
        ]
        return max(slots)[1] if slots else None

    def _preempt(self, slot: int) -> None:
        """Free the slot and re-queue prompt+generated as a continuation at
        the queue FRONT (greedy continuations are identical after
        re-prefill)."""
        if slot in self._ragged_admit:
            # Mid-prefill: nothing sampled yet, the request re-queues as
            # it was (its partial KV goes with the blocks).
            req = self._ragged_admit.pop(slot)["req"]
            self._clear_slot_storage(slot, req)
        else:
            req = self._by_slot[slot]
            self._release_slot(slot)
        cont = _Request(req.rid, req.prompt, req.tokens, max_new=req.max_new,
                        temperature=req.temperature, stop=req.stop,
                        logit_bias=req.logit_bias,
                        logprobs=req.logprobs, deadline=req.deadline,
                        adapter_id=req.adapter_id)
        self._queue.insert(0, cont)

    def _clear_slot_storage(self, slot: int, req: _Request) -> None:
        """Return a request's blocks (a shared one only when its last
        holder lets go) and fence the slot's state — shared by normal
        release and mid-prefill teardown."""
        for blk in req.blocks:
            if blk in req.shared:
                self._shared_refs[blk] -= 1
                if self._shared_refs[blk] == 0:
                    # The cache entry went already; the last user frees.
                    del self._shared_refs[blk]
                    self._free.append(blk)
            else:
                self._free.append(blk)
        req.blocks = []
        req.shared = frozenset()
        self.kv_mask[slot] = False
        self.tables[slot] = 0  # dead writes go to the null block
        self.positions[slot] = 0

    def _release_slot(self, slot: int) -> None:
        req = self._by_slot[slot]
        self._clear_slot_storage(slot, req)
        self._by_slot[slot] = None

    # -- KV handoff (disaggregated prefill and decode tiers) ---------------

    def _wire_shape(self, leaf: torch.Tensor) -> tuple:
        """One block's rows on the wire, (L, Hkv, BS[, D]): every kv head,
        whatever this rank holds."""
        return (leaf.shape[0], leaf.shape[2] * self._tp, *leaf.shape[3:])

    def _leaf_specs(self) -> dict:
        return {
            name: {"dtype": _wire_dtype(leaf),
                   "shape": list(self._wire_shape(leaf))}
            for name, leaf in self.pool.items()
        }

    def _block_rows(self, blk_ids: list[int]) -> dict:
        """One gather per leaf of the given blocks' rows, on the host:
        {name: (L, n, Hkv, BS[, D])}. Under a tp plan the ranks' heads are
        all-gathered first: a collective, so every rank calls this
        together."""
        idx = torch.as_tensor(blk_ids, dtype=torch.long, device=self.device)
        out = {}
        for name, leaf in self.pool.items():
            rows = leaf[:, idx]
            if self._tp_group is not None:
                parts = [torch.empty_like(rows) for _ in range(self._tp)]
                torch.distributed.all_gather(parts, rows.contiguous(),
                                             group=self._tp_group)
                rows = torch.cat(parts, dim=2)
            out[name] = rows.cpu()
        return out

    def _own_heads(self, rows: np.ndarray, axis: int) -> np.ndarray:
        """This rank's kv heads of wire rows whose head axis is ``axis``."""
        if self._tp == 1:
            return rows
        n = rows.shape[axis] // self._tp
        index = [slice(None)] * rows.ndim
        index[axis] = slice(self._tp_rank * n, (self._tp_rank + 1) * n)
        return np.ascontiguousarray(rows[tuple(index)])

    def _check_payload(self, payload, what: str) -> dict:
        """The envelope checks import_blocks and import_chain share;
        returns {leaf name: one block's row shape}."""
        if not isinstance(payload, dict) or payload.get("version") != 1:
            raise ValueError(f"{what}: missing or unsupported version")
        if int(payload.get("block_size", -1)) != self.block_size:
            raise ValueError(
                f"{what} block_size {payload.get('block_size')!r} != "
                f"engine block_size {self.block_size}"
            )
        kv_bits = 8 if "k_scale" in self.pool else 0
        if int(payload.get("kv_bits", -1)) != kv_bits:
            raise ValueError(
                f"{what} kv_bits {payload.get('kv_bits')!r} does not "
                f"match this pool's storage format (kv_bits={kv_bits})"
            )
        leaves = payload.get("leaves") or {}
        if set(leaves) != set(self.pool):
            raise ValueError(f"{what} leaves do not match this pool")
        shapes: dict[str, tuple] = {}
        for name, spec in leaves.items():
            leaf = self.pool[name]
            want = self._wire_shape(leaf)
            if (tuple(spec.get("shape") or ()) != want
                    or spec.get("dtype") != _wire_dtype(leaf)):
                raise ValueError(
                    f"{what} leaf {name!r}: shape/dtype "
                    f"{spec.get('shape')}/{spec.get('dtype')} != local "
                    f"{list(want)}/{_wire_dtype(leaf)}"
                )
            shapes[name] = want
        return shapes

    def export_blocks(self, rid: int, skip_keys=()) -> dict:
        """Serialize a live request's prompt-KV blocks for a cross-replica
        handoff, at FIRST-token time: positions[slot] still equals the
        prompt's KV length and the sampled token's KV is unwritten, so the
        payload is the prefill state a decode replica needs plus the
        pending first token. Full blocks are chain-keyed as prefix
        admission keys them; a key in ``skip_keys`` (hex) ships as a stub
        without data (the suffix-only transfer to a replica that holds the
        chain). The tail block always ships. Requires prefix_cache=True:
        the anchored layout is the wire format."""
        if not self._prefix_cache_enabled:
            raise RuntimeError(
                "export_blocks requires prefix_cache=True (the anchored "
                "admission layout is the transfer wire format)"
            )
        slot = next((i for i, r in enumerate(self._by_slot)
                     if r is not None and r.rid == rid), None)
        if slot is None:
            raise KeyError(
                f"rid {rid} holds no slot — export at first-token time, "
                "while the request is still installed"
            )
        req = self._by_slot[slot]
        if not req.tokens:
            raise RuntimeError(
                "export_blocks before the first sampled token: the "
                "pending token is part of the payload"
            )
        bs = self.block_size
        lng = int(self.positions[slot])  # prompt KV length
        nblocks = -(-lng // bs)
        kv_tokens = (req.prompt + req.tokens)[:lng]
        registrable = (lng - 1) // bs  # nblocks - 1: exactly one tail
        skip = {k if isinstance(k, str) else bytes(k).hex()
                for k in skip_keys}
        keys: list[str] = []
        parent: Optional[bytes] = None
        for j in range(registrable):
            parent = self._chain_key(parent, kv_tokens[j * bs:(j + 1) * bs],
                                     adapter=req.adapter_id)
            keys.append(parent.hex())
        send = [j for j in range(nblocks)
                if j >= registrable or keys[j] not in skip]
        leaf_rows = self._block_rows([req.blocks[j] for j in send])
        at = {j: i for i, j in enumerate(send)}
        blocks = []
        for j in range(nblocks):
            ent: dict = {"key": keys[j] if j < registrable else None}
            i = at.get(j)
            if i is not None:
                ent["data"] = {name: _rows_b64(rows[:, i])
                               for name, rows in leaf_rows.items()}
            blocks.append(ent)
        self.kv_exports += 1
        return {
            "version": 1,
            "block_size": bs,
            "kv_bits": 8 if "k_scale" in self.pool else 0,
            "adapter": req.adapter_id,
            "tokens": [int(t) for t in kv_tokens],
            "pending_token": int(req.tokens[-1]),
            "pending_logprob": (
                float(req.logprobs[-1]) if req.logprobs else None
            ),
            "leaves": self._leaf_specs(),
            "blocks": blocks,
        }

    def import_blocks(self, payload: dict,
                      max_new_tokens: Optional[int] = None,
                      temperature: Optional[float] = None,
                      stop=None, logit_bias: Optional[dict] = None,
                      deadline_s: Optional[float] = None) -> Optional[int]:
        """Admit a request DIRECTLY into a free slot from an exported KV
        payload, skipping its prefill. Chain keys are recomputed here and
        checked against the payload (a mismatch means the two replicas'
        hashing diverged: refused). With prefix_cache on, the longest
        locally cached chain (swap tier included) is reused and only the
        rest is written; a stub past it raises KeyError (the suffix-only
        transfer raced an eviction). A slot mid-admission is never taken.

        Returns the new rid, or None when no slot or blocks are free under
        the admission watermark. The pending first token is delivered
        through the normal retirement path at the next drive quantum."""
        shapes = self._check_payload(payload, "kv payload")
        tokens = [int(t) for t in payload.get("tokens") or []]
        bs = self.block_size
        lng = len(tokens)
        nblocks = -(-lng // bs)
        entries = payload.get("blocks") or []
        if lng == 0 or len(entries) != nblocks:
            raise ValueError(
                f"kv payload carries {len(entries)} blocks for a "
                f"{lng}-token prompt (want {nblocks})"
            )
        adapter = payload.get("adapter")
        if adapter is not None and (
                not isinstance(adapter, int) or isinstance(adapter, bool)):
            raise ValueError(
                f"kv payload adapter must be an int or null, "
                f"got {adapter!r}"
            )
        # Validation and the rid, through _build_request.
        req = self._build_request(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            stop=stop, logit_bias=logit_bias, deadline_s=deadline_s,
        )
        req.adapter_id = adapter
        slot = next((i for i, r in enumerate(self._by_slot)
                     if r is None and i not in self._ragged_admit), None)
        if slot is None:
            return None
        registrable = (lng - 1) // bs
        keys: list[bytes] = []
        parent: Optional[bytes] = None
        for j in range(registrable):
            parent = self._chain_key(parent, tokens[j * bs:(j + 1) * bs],
                                     adapter=adapter)
            sent = entries[j].get("key")
            if sent is not None and sent != parent.hex():
                raise ValueError(
                    f"kv payload chain-key mismatch at block {j}: the "
                    "exporting replica's chain hashing diverged from ours"
                )
            keys.append(parent)
        # Longest local chain (none without prefix_cache: every block is
        # written). Matched blocks are pinned as the walk advances:
        # promotion allocates under the watermark and may evict unpinned
        # leaves.
        m = 0
        shared_blocks: list[int] = []
        if self._prefix_cache_enabled:
            walk_parent: Optional[bytes] = None
            for j in range(registrable):
                ent = self._prefix_entries.get(keys[j])
                if ent is None and self._swap:
                    ent = self._swap_promote(keys[j], walk_parent)
                if ent is None:
                    break
                shared_blocks.append(ent["block"])
                self._shared_refs[ent["block"]] += 1
                m += 1
                walk_parent = keys[j]
        bad = next((j for j in range(nblocks)
                    if j >= m and "data" not in entries[j]), None)
        if bad is not None:
            for blk in shared_blocks:  # un-pin; promoted blocks stay warm
                self._shared_refs[blk] -= 1
            raise KeyError(
                f"kv payload block {bad} is a stub but its chain is "
                "not cached here (suffix-only transfer raced an "
                "eviction) — resend with full block data"
            )
        for k in keys[:m]:  # a hit refreshes recency
            self._prefix_entries[k] = self._prefix_entries.pop(k)
        need = nblocks - m
        blocks = self._reserve_take(need)
        if blocks is None:
            for blk in shared_blocks:
                self._shared_refs[blk] -= 1
            return None
        all_blocks = shared_blocks + blocks
        # One indexed write per leaf of the shipped blocks (at least the
        # tail), into blocks just taken off the free list.
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for name, leaf in self.pool.items():
            stacked = np.stack(
                [_rows_from_b64(entries[j]["data"][name], leaf.dtype,
                                shapes[name])
                 for j in range(m, nblocks)], axis=1)
            leaf[:, idx] = _carried_to_tensor(
                self._own_heads(stacked, 2), leaf.dtype).to(self.device)
        # Register the imported FULL blocks on the chain (cache hold +
        # this request's, as prefix admission does).
        if self._prefix_cache_enabled:
            chain_parent = keys[m - 1] if m else None
            for j in range(m, registrable):
                self._prefix_entries[keys[j]] = {
                    "block": all_blocks[j], "parent": chain_parent,
                    "children": 0,
                }
                if chain_parent is not None:
                    self._prefix_entries[chain_parent]["children"] += 1
                self._shared_refs[all_blocks[j]] = 2
                chain_parent = keys[j]
            req.shared = frozenset(all_blocks[:registrable])
            self.prefix_hits += m
            self.prefix_misses += registrable - m
        # Install as a DECODING slot, as anchored admission leaves one:
        # decode continues at lng.
        req.blocks = all_blocks
        self.tables[slot] = 0
        self.tables[slot, :nblocks] = all_blocks
        self.positions[slot] = lng
        self.kv_mask[slot] = True
        self.temps[slot] = (self.gen.temperature if req.temperature is None
                            else req.temperature)
        self._install_bias(slot, req)
        req.budget = self._initial_budget(req)
        self._by_slot[slot] = req
        self.kv_imports += 1
        self.kv_import_blocks_reused += m
        self.kv_import_blocks_written += need
        self._kv_pending_first.append((
            slot, req.rid, int(payload["pending_token"]),
            payload.get("pending_logprob"),
        ))
        return req.rid

    def _deliver_imported(self) -> None:
        """Feed imported requests' pending first tokens through the normal
        retirement path (EOS, stop, budget and cancel apply as to any
        token). Runs at the top of every admission pass."""
        while self._kv_pending_first:
            slot, rid, token, lp = self._kv_pending_first.pop(0)
            req = self._by_slot[slot]
            if req is None or req.rid != rid:
                continue  # preempted or cancelled before delivery
            self._note_token(slot, token, lp)

    # -- peer prefix tier ----------------------------------------------------

    def chain_block_bytes(self) -> int:
        """Wire bytes ONE full block costs in a chain payload: base64 of
        every leaf's rows plus a small envelope (the /kv/probe advisory)."""
        raw = self._tp * sum(leaf.numel() * leaf.element_size()
                             // leaf.shape[1] for leaf in self.pool.values())
        return 4 * ((raw + 2) // 3) + 96

    def export_chain(self, keys) -> Optional[dict]:
        """Serialize the longest held prefix of a chain-key walk straight
        from the prefix cache (swap-resident links promoted first); no
        request is involved. The version-1 wire format without the live
        request's fields; None when not even the first key is held."""
        if not self._prefix_cache_enabled:
            raise RuntimeError(
                "export_chain requires prefix_cache=True (the chain "
                "registry is the export source)"
            )
        raw = [k if isinstance(k, bytes) else bytes.fromhex(k) for k in keys]
        ents: list[tuple] = []
        parent: Optional[bytes] = None
        for key in raw:
            ent = self._prefix_entries.get(key)
            if ent is None and self._swap:
                ent = self._swap_promote(key, parent)
            if ent is None:
                break
            ents.append((key, ent))
            parent = key
        if not ents:
            return None
        leaf_rows = self._block_rows([e["block"] for _, e in ents])
        blocks = [
            {"key": key.hex(),
             "data": {name: _rows_b64(rows[:, i])
                      for name, rows in leaf_rows.items()}}
            for i, (key, _) in enumerate(ents)
        ]
        for key, _ in ents:  # an export is a hit: refresh recency
            self._prefix_entries[key] = self._prefix_entries.pop(key)
        self.kv_chain_exports += 1
        self.kv_chain_blocks_sent += len(blocks)
        return {
            "version": 1,
            "block_size": self.block_size,
            "kv_bits": 8 if "k_scale" in self.pool else 0,
            "adapter": None,
            "leaves": self._leaf_specs(),
            "blocks": blocks,
        }

    def import_chain(self, payload: dict, tokens) -> int:
        """Register an exported cache chain into this engine's prefix
        cache without installing a request (the peer-fetch import). Keys
        are recomputed from the fetching request's own tokens and checked
        block by block; skew or a mismatch raises ValueError. Best effort
        under the admission watermark: the walk stops at the first block
        the pool cannot spare. Returns how many leading chain keys are now
        resident."""
        if not self._prefix_cache_enabled:
            raise ValueError(
                "import_chain requires prefix_cache=True (there is no "
                "chain registry to import into)"
            )
        shapes = self._check_payload(payload, "kv chain payload")
        toks = [int(t) for t in tokens]
        bs = self.block_size
        registrable = max(0, (len(toks) - 1) // bs)
        entries = payload.get("blocks") or []
        if not entries or len(entries) > registrable:
            raise ValueError(
                f"kv chain payload carries {len(entries)} blocks for a "
                f"prompt with {registrable} registrable blocks"
            )
        keys: list[bytes] = []
        parent: Optional[bytes] = None
        for j in range(len(entries)):
            parent = self._chain_key(parent, toks[j * bs:(j + 1) * bs])
            if entries[j].get("key") != parent.hex():
                raise ValueError(
                    f"kv chain payload chain-key mismatch at block {j}: "
                    "the exporting peer's chain diverged from this "
                    "prompt's"
                )
            if "data" not in entries[j]:
                raise ValueError(
                    f"kv chain payload block {j} is a stub — chain "
                    "exports always carry full block data"
                )
            keys.append(parent)
        # Pin each link as the walk advances: _reserve_take may evict
        # unreferenced leaves, and the block registered one step ago is
        # such a leaf until its child links in.
        resident = 0
        written = 0
        pinned: list[int] = []
        chain_parent: Optional[bytes] = None
        try:
            for j, key in enumerate(keys):
                ent = self._prefix_entries.get(key)
                if ent is None and self._swap:
                    ent = self._swap_promote(key, chain_parent)
                if ent is None:
                    take = self._reserve_take(1)
                    if take is None:
                        break  # pool pressure: keep what landed
                    (blk,) = take
                    for name, leaf in self.pool.items():
                        row = _rows_from_b64(entries[j]["data"][name],
                                             leaf.dtype, shapes[name])
                        leaf[:, blk] = _carried_to_tensor(
                            self._own_heads(row, 1),
                            leaf.dtype).to(self.device)
                    ent = {"block": blk, "parent": chain_parent,
                           "children": 0}
                    self._prefix_entries[key] = ent
                    if chain_parent is not None:
                        self._prefix_entries[chain_parent]["children"] += 1
                    self._shared_refs[blk] = 1
                    written += 1
                else:
                    # Reuse refreshes recency, like any chain hit.
                    self._prefix_entries[key] = self._prefix_entries.pop(key)
                self._shared_refs[ent["block"]] += 1
                pinned.append(ent["block"])
                resident += 1
                chain_parent = key
        finally:
            for blk in pinned:
                self._shared_refs[blk] -= 1
        self.kv_chain_imports += 1
        self.kv_chain_blocks_written += written
        return resident

    # -- scheduling --------------------------------------------------------

    def _admit_free_slots(self) -> None:
        if self._kv_pending_first:
            self._deliver_imported()
        if self.ragged:
            self._admit_free_slots_ragged()
            return
        if self._prefix_cache_enabled:
            self._admit_free_slots_prefix()
            return
        for slot in range(self.slots):
            if self._by_slot[slot] is not None:
                continue
            if not self._queue:
                return
            # Admission never preempts; decode-path eviction may push a
            # continuation to the queue front, so the head is re-read.
            head = self._queue[0]
            effective = head.prompt + head.tokens
            # Block-aligned bucket: prompt_bucket, or larger for a
            # preempted continuation that outgrew it.
            bucket = max(
                self.prompt_bucket,
                -(-len(effective) // self.block_size) * self.block_size,
            )
            # A prompt-cache hit (pure prompts only: a continuation's
            # tokens are request-unique) reuses the shared blocks and the
            # cached first logits: no allocation, no prefill. The key
            # carries the validity MASK too: a prompt led by pad_id pads
            # to the same bytes as the one without that token.
            padded = mask = cache_key = cache_hit = None
            if self._prompt_cache_enabled and not head.tokens:
                padded, mask = left_pad([effective], self.gen.pad_id, bucket)
                cache_key = (padded.tobytes(), mask.tobytes())
                cache_hit = self._prompt_cache.get(cache_key)
            if cache_hit is not None:
                # Move to the end: eviction scans insertion order.
                self._prompt_cache[cache_key] = self._prompt_cache.pop(
                    cache_key)
                blocks = list(cache_hit["blocks"])
            else:
                need = bucket // self.block_size
                blocks = self._reserve_take(need)
                if blocks is None:
                    if not any(r is not None for r in self._by_slot):
                        raise RuntimeError(
                            f"block pool too small: {need} blocks needed "
                            f"for a {len(effective)}-token prompt, pool has "
                            f"{self.num_blocks - 1} usable; raise num_blocks"
                        )
                    return  # pool busy; retry after in-flight slots retire
            req = self._pop_queue()
            if padded is None:
                padded, mask = left_pad([effective], self.gen.pad_id, bucket)
            shared: frozenset = frozenset()
            prompt_mask = None if mask.all() else self._up(mask)
            padded_dev = self._up(padded)
            if cache_hit is not None:
                for blk in blocks:
                    self._shared_refs[blk] += 1
                logits = cache_hit["logits"]
                shared = frozenset(blocks)
            else:
                logits = _paged_admit(
                    self.params, self.cfg, padded_dev, self.pool,
                    prompt_mask, self._up(np.asarray(blocks, np.int32)),
                    self.block_size,
                )
                if cache_key is not None:
                    # One hold for the cache, one for this request.
                    self._prompt_cache[cache_key] = {
                        "blocks": list(blocks), "logits": logits,
                    }
                    for blk in blocks:
                        self._shared_refs[blk] = (
                            self._shared_refs.get(blk, 0) + 2)
                    shared = frozenset(blocks)
            self.tables[slot] = 0  # stale entries never alias freed blocks
            self.tables[slot, :len(blocks)] = blocks
            self.positions[slot] = bucket
            # The mask carries PADDING only: True past the prompt, where
            # the positional bound hides not-yet-written positions.
            row = np.ones((self.max_blocks * self.block_size,), bool)
            row[:bucket] = mask[0]
            self.kv_mask[slot] = self._up(row)
            self._finish_admit(slot, _Request(
                req.rid, req.prompt, list(req.tokens), blocks=blocks,
                shared=shared, max_new=req.max_new,
                temperature=req.temperature, stop=req.stop,
                logit_bias=req.logit_bias, logprobs=req.logprobs,
                deadline=req.deadline, adapter_id=req.adapter_id,
            ), logits, padded_dev, prompt_mask)

    def _admit_free_slots_prefix(self) -> None:
        """Admission under the position-0-anchored layout (prefix_cache):
        match the longest cached chain (promoting swap-resident links),
        allocate only the tail, prefill the tail THROUGH the table in
        ``admit_chunk`` pieces, register the new full blocks. No padding:
        token i sits at position i, decode continues at the prompt's
        length, and the kv_mask row is all True. An admitted request keeps
        its deadline (JAX's rebuild drops it)."""
        bs = self.block_size
        for slot in range(self.slots):
            if self._by_slot[slot] is not None:
                continue
            if not self._queue:
                return
            head = self._queue[0]
            effective = head.prompt + head.tokens
            lng = len(effective)
            nblocks = -(-lng // bs)
            # Longest cached chain over FULL blocks, short of the last
            # token's block (kept mutable and recomputed).
            registrable = (lng - 1) // bs
            keys: list[bytes] = []
            shared_blocks: list[int] = []
            parent: Optional[bytes] = None
            for j in range(registrable):
                key = self._chain_key(parent, effective[j * bs:(j + 1) * bs],
                                      adapter=head.adapter_id)
                ent = self._prefix_entries.get(key)
                if ent is None and self._swap:
                    # A pool miss, the swap tier next: a promoted block
                    # is a hit (its prefill is skipped either way).
                    ent = self._swap_promote(key, parent)
                if ent is None:
                    break
                keys.append(key)
                shared_blocks.append(ent["block"])
                # Pin now: a promotion later in this walk allocates under
                # the watermark and may evict unpinned leaves.
                self._shared_refs[ent["block"]] += 1
                parent = key
            m = len(shared_blocks)
            for key in keys:  # a hit refreshes recency
                self._prefix_entries[key] = self._prefix_entries.pop(key)
            need = nblocks - m
            blocks = self._reserve_take(need)
            if blocks is None:
                for blk in shared_blocks:  # un-pin; admission stalled
                    self._shared_refs[blk] -= 1
                if not any(r is not None for r in self._by_slot):
                    raise RuntimeError(
                        f"block pool too small: {need} blocks needed for "
                        f"a {lng}-token prompt ({m} matched cached), pool "
                        f"has {self.num_blocks - 1} usable; raise "
                        "num_blocks"
                    )
                return  # pool busy; retry after in-flight slots retire
            req = self._pop_queue()
            # Counted once allocation committed: a stalled walk re-walks.
            self.prefix_hits += m
            self.prefix_misses += registrable - m
            all_blocks = shared_blocks + blocks
            self.tables[slot] = 0  # stale entries never alias freed blocks
            self.tables[slot, :len(all_blocks)] = all_blocks
            self.positions[slot] = lng
            self.kv_mask[slot] = True
            # The tail, right-padded to the owned blocks' span: every pad
            # write lands at a future position inside an owned block.
            start = m * bs
            padded_len = (nblocks - m) * bs
            chunk = np.full((1, padded_len), self.gen.pad_id, np.int32)
            chunk[0, :lng - start] = effective[start:]
            table = self._up(self.tables[slot:slot + 1])
            full = torch.ones((1, self.max_blocks * bs), dtype=torch.bool,
                              device=self.device)
            # Fixed-width pieces of admit_chunk (the last one shorter):
            # only the final piece, which holds the last real token,
            # keeps its logits.
            off = 0
            while off < padded_len:
                width = min(self.admit_chunk, padded_len - off)
                last_idx = min(max(lng - 1 - start - off, 0), width - 1)
                logits = _paged_prefix_admit(
                    self.params, self.cfg, self._up(chunk[:, off:off + width]),
                    self.pool, table, start + off, full, last_idx, bs,
                )
                off += width
            # Register the NEW full blocks on the chain: cache hold plus
            # this request's.
            for j in range(m, registrable):
                key = self._chain_key(parent, effective[j * bs:(j + 1) * bs],
                                      adapter=req.adapter_id)
                self._prefix_entries[key] = {
                    "block": all_blocks[j], "parent": parent, "children": 0,
                }
                if parent is not None:
                    self._prefix_entries[parent]["children"] += 1
                self._shared_refs[all_blocks[j]] = 2
                parent = key
            # A lockstep draft primes anchored too: the whole prompt at
            # positions 0..L-1, pads after it and no mask (they sit at
            # future positions, as the tail chunk's pads do).
            dpad = np.full((1, max(self.prompt_bucket, nblocks * bs)),
                           self.gen.pad_id, np.int32)
            dpad[0, :lng] = effective
            self._finish_admit(slot, _Request(
                req.rid, req.prompt, list(req.tokens), blocks=all_blocks,
                shared=frozenset(all_blocks[:registrable]),
                max_new=req.max_new, temperature=req.temperature,
                stop=req.stop, logit_bias=req.logit_bias,
                logprobs=req.logprobs, deadline=req.deadline,
                adapter_id=req.adapter_id,
            ), logits, self._up(dpad), None)

    def _finish_admit(self, slot: int, req: _Request, logits: torch.Tensor,
                      draft_tokens: torch.Tensor,
                      draft_mask: Optional[torch.Tensor]) -> None:
        """Admission tail: sample the first token off the admission
        logits, install the request, prime any lockstep draft cache
        (``_post_admit`` with the padded prompt and its mask), and feed
        the token through retirement."""
        temp = (self.gen.temperature if req.temperature is None
                else req.temperature)
        bias_row = self._install_bias(slot, req)
        if bias_row is not None:
            logits = logits + bias_row
        first = int(sample_logits(logits[None], self.generator, temp,
                                  self.gen.top_k, self.gen.top_p)[0])
        first_lp = float(torch.log_softmax(logits.float(), dim=-1)[first])
        req.budget = self._initial_budget(req) - len(req.tokens)
        self.temps[slot] = temp
        self._by_slot[slot] = req
        self._post_admit(slot, draft_tokens, draft_mask)
        self._note_token(slot, first, first_lp)

    def _admit_free_slots_ragged(self) -> None:
        """Admission ALLOCATES only — blocks, table row, validity mask,
        sampling state and a prompt cursor. The prefill rides the next
        dispatches as chunk rows under the token budget."""
        for slot in range(self.slots):
            if (self._by_slot[slot] is not None
                    or slot in self._ragged_admit):
                continue
            if not self._queue:
                return
            head = self._queue[0]
            effective = head.prompt + head.tokens
            bucket = max(
                self.prompt_bucket,
                -(-len(effective) // self.block_size) * self.block_size,
            )
            need = bucket // self.block_size
            blocks = self._reserve_take(need)
            if blocks is None:
                if (not any(r is not None for r in self._by_slot)
                        and not self._ragged_admit):
                    raise RuntimeError(
                        f"block pool too small: {need} blocks needed for "
                        f"a {len(effective)}-token prompt, pool has "
                        f"{self.num_blocks - 1} usable; raise num_blocks"
                    )
                return  # pool busy; retry after in-flight slots retire
            req = self._pop_queue()
            padded, mask = left_pad([effective], self.gen.pad_id, bucket)
            self.tables[slot] = 0  # stale entries never alias freed blocks
            self.tables[slot, :len(blocks)] = blocks
            # Decode continues at the bucket once installed; the cursor
            # (not ``positions``) tracks mid-prefill progress.
            self.positions[slot] = bucket
            # The mask carries PADDING only: True past the prompt, where
            # the positional bound hides not-yet-written positions.
            row = np.ones((self.max_blocks * self.block_size,), bool)
            row[:bucket] = mask[0]
            self.kv_mask[slot] = torch.from_numpy(row).to(self.device)
            installed = _Request(
                req.rid, req.prompt, list(req.tokens), blocks=blocks,
                max_new=req.max_new, temperature=req.temperature,
                stop=req.stop, logit_bias=req.logit_bias,
                logprobs=req.logprobs, deadline=req.deadline,
                adapter_id=req.adapter_id,
            )
            # Sampling state goes live NOW: the chunk that completes this
            # prefill samples the first token inside its own dispatch.
            self.temps[slot] = (self.gen.temperature
                                if req.temperature is None
                                else req.temperature)
            self._install_bias(slot, installed)
            self._ragged_admit[slot] = {
                "req": installed,
                "padded": padded,
                "prompt_mask": None if mask.all() else self._up(mask),
                "cursor": _AdmissionCursor(mask[0], bucket),
            }

    def _ensure_step_blocks(self, span: int = 1) -> list[int]:
        """Every active slot whose next ``span`` writes reach an
        unallocated block gets one before the step dispatches. Preemption
        inside _take_blocks may evict slots (a needing one included); loop
        until stable."""
        while True:
            active = [i for i, r in enumerate(self._by_slot) if r is not None]
            needing = [
                s for s in active
                if (int(self.positions[s]) + span - 1) // self.block_size
                >= len(self._by_slot[s].blocks)
            ]
            if not needing:
                return active
            blocks = self._take_blocks(len(needing))
            if blocks is None:
                raise RuntimeError(
                    "block pool exhausted with a single active request; "
                    "raise num_blocks"
                )
            for s, blk in zip(needing, blocks):
                req = self._by_slot[s]
                if req is None:  # evicted by the preemption above
                    self._free.append(blk)
                    continue
                self.tables[s, len(req.blocks)] = blk
                req.blocks.append(blk)

    def _step(self) -> None:
        if self.ragged:
            self._step_ragged()
            return
        active = self._ensure_step_blocks()
        if not active:
            return
        self.last_step = {
            "decode_rows": len(active),
            "prefill_rows": 0,
            "fill": len(active) / self.slots,
        }
        nxt, lps = _paged_step(
            self.params, self.cfg, self._up(self.tokens), self.pool,
            self._up(self.tables), self._up(self.positions), self.kv_mask,
            self.generator, self.block_size, self._up(self.temps),
            self.gen.top_k, self.gen.top_p, bias=self._bias,
            attn_kernel=self.attn_kernel,
        )
        for slot in active:
            self.positions[slot] += 1
        host_next = nxt.cpu().numpy()
        host_lps = lps.cpu().numpy()
        for slot in active:
            self._note_token(slot, int(host_next[slot]),
                             float(host_lps[slot]))

    def _expire_ragged_admissions(self) -> None:
        """Cancelled or deadline-expired MID-PREFILL admissions retire
        before the step assembles: a dead request must not spend budget."""
        for slot, a in list(self._ragged_admit.items()):
            req = a["req"]
            reason = self._cancelled.pop(req.rid, None)
            if reason is None and req.deadline is not None \
                    and self._clock() >= req.deadline:
                reason = "deadline"
            if reason is not None:
                del self._ragged_admit[slot]
                self._clear_slot_storage(slot, req)
                self._deliver_abort(req, reason)

    def _assemble_ragged(self, spans: dict):
        """Lay out ONE flattened mixed batch under the token budget: every
        decode span in ``spans`` (slot → (token_list, pos0)) first, in slot
        order (seq_starts stays non-decreasing), then each admitting
        slot's next prompt chunk rides whatever budget is left.

        Returns (tokens, tok_pos, tok_seq, seq_starts, seq_lens, kv_lens,
        last_rows, rows, completing)."""
        tb = self.token_budget
        tokens = np.full((tb, 1), self.gen.pad_id, np.int32)
        tok_pos = np.zeros((tb,), np.int32)
        tok_seq = np.zeros((tb,), np.int32)
        seq_starts = np.zeros((self.slots,), np.int32)
        seq_lens = np.zeros((self.slots,), np.int32)
        kv_lens = np.zeros((self.slots,), np.int32)
        last_rows = np.zeros((self.slots,), np.int32)
        budget = tb - sum(len(toks) for toks, _ in spans.values())
        rows = 0
        completing: list[int] = []
        for slot in range(self.slots):
            span = spans.get(slot)
            if span is not None:
                toks, pos0 = span
                n = len(toks)
                tokens[rows:rows + n, 0] = toks
                tok_pos[rows:rows + n] = np.arange(pos0, pos0 + n)
                tok_seq[rows:rows + n] = slot
                seq_starts[slot] = rows
                seq_lens[slot] = n
                kv_lens[slot] = pos0 + n
                last_rows[slot] = rows + n - 1
                rows += n
            elif slot in self._ragged_admit and budget > 0:
                a = self._ragged_admit[slot]
                start, n = a["cursor"].take(budget)
                if n == 0:
                    continue
                budget -= n
                tokens[rows:rows + n, 0] = a["padded"][0, start:start + n]
                tok_pos[rows:rows + n] = np.arange(start, start + n)
                tok_seq[rows:rows + n] = slot
                seq_starts[slot] = rows
                seq_lens[slot] = n
                kv_lens[slot] = start + n
                last_rows[slot] = rows + n - 1
                rows += n
                if a["cursor"].done:
                    completing.append(slot)
        return (tokens, tok_pos, tok_seq, seq_starts, seq_lens, kv_lens,
                last_rows, rows, completing)

    def _dispatch_width(self, rows: int) -> int:
        """The smallest power-of-two bucket that holds the assembled rows
        (floor 8, cap token_budget): a mostly-decode step does not pay a
        full-budget dispatch."""
        width = 8
        while width < rows:
            width *= 2
        return min(width, self.token_budget)

    def _stamp_ragged(self, rows: int, decode_rows: int) -> None:
        """Per-dispatch observability: lifetime ragged counters + the
        drive quantum's last_step record."""
        self.ragged_steps += 1
        self.ragged_tokens += rows
        self.ragged_fill = rows / self.token_budget
        self.last_step = {
            "decode_rows": decode_rows,
            "prefill_rows": rows - decode_rows,
            "fill": self.ragged_fill,
        }

    def _complete_ragged_admissions(self, completing, first_tok: dict,
                                    first_lp: dict) -> None:
        """Install admissions whose last prompt chunk just dispatched; the
        SAME dispatch produced each one's first token (``first_lp`` has no
        entry on an argmax-only verify dispatch). A lockstep draft cache
        primes here (``_post_admit``)."""
        for slot in completing:
            a = self._ragged_admit.pop(slot)
            req = a["req"]
            req.budget = self._initial_budget(req) - len(req.tokens)
            self._by_slot[slot] = req
            self._post_admit(slot, self._up(a["padded"]), a["prompt_mask"])
            self._note_token(slot, first_tok[slot], first_lp.get(slot))

    def _ragged_adapters(self) -> Optional[tuple]:
        """Per-slot adapter spec (stacked, ids (S,), scaling) for the
        fused dispatches, or None (the base-only body).
        ``MultiLoraPagedBatcher`` overrides it; every scheduling mode
        (decode, admission chunks, verify spans) goes through this one
        hook, so they cannot disagree about a slot's adapter."""
        return None

    def _step_ragged(self) -> None:
        """One fused mixed prefill/decode dispatch: every decoding slot's
        next token plus admission chunks under the token budget, sampled
        at each span's last row."""
        self._expire_ragged_admissions()
        active = self._ensure_step_blocks()
        if not active and not self._ragged_admit:
            return
        spans = {
            slot: ([int(self.tokens[slot, 0])], int(self.positions[slot]))
            for slot in active
        }
        (tokens, tok_pos, tok_seq, seq_starts, seq_lens, kv_lens,
         last_rows, rows, completing) = self._assemble_ragged(spans)
        if rows == 0:
            return
        width = self._dispatch_width(rows)
        up = self._up
        nxt, lps = _paged_ragged_step(
            self.params, self.cfg, up(tokens[:width]), self.pool,
            up(self.tables), self.kv_mask, up(tok_pos[:width]),
            up(tok_seq[:width]), rows, up(seq_starts), up(seq_lens),
            up(kv_lens), up(last_rows), self.generator, self.block_size,
            up(self.temps), self.gen.top_k, self.gen.top_p, bias=self._bias,
            attn_kernel=self.attn_kernel, adapters=self._ragged_adapters(),
        )
        self._stamp_ragged(rows, decode_rows=len(active))
        host_next = nxt.cpu().numpy()
        host_lps = lps.cpu().numpy()
        for slot in active:
            self.positions[slot] += 1
        for slot in active:
            self._note_token(slot, int(host_next[slot]),
                             float(host_lps[slot]))
        self._complete_ragged_admissions(
            completing,
            {s: int(host_next[s]) for s in completing},
            {s: float(host_lps[s]) for s in completing},
        )
