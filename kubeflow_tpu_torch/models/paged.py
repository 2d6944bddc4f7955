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
  ``_gqa_decode_attention`` (int8 pools, and the CPU).

Each kernel's wrapper launches the CUDA kernel on the card and runs its
plain version on the CPU.

The pool keeps the JAX package's stacked layout, ``(L, NB, Hkv, BS, D)``
per leaf (plus ``(L, NB, Hkv, BS)`` bf16 scale leaves for ``kv_bits=8``),
because it is the wire format later engines export. PyTorch has no buffer
donation, so the steps update the pool IN PLACE instead of returning a
new one. Block tables, positions and the allocator are host numpy and
plain Python between steps; block 0 is the null block, never allocated.

Not ported yet: the prompt and prefix caches, the host-RAM swap tier, KV
export/import, tensor-parallel plans, adapters and sliding-window
configs. Each raises ``NotImplementedError``.
"""

from __future__ import annotations

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
    apply_rope,
    init_kv_cache,
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


def _kv_block_bytes(cfg: LlamaConfig, block_size: int, kv_bits: int = 0) -> int:
    """Raw bytes ONE pool block occupies across every leaf (k + v, plus
    the bf16 scale leaves under kv_bits=8)."""
    rows = cfg.n_layers * cfg.n_kv_heads * block_size
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
):
    """Size a block pool from the card's free memory: spend ``fraction``
    of it (free device memory plus what PyTorch's caching allocator holds
    unused) on KV blocks. A CPU device has no such number and returns
    ``fallback``. ``with_source`` returns ``(blocks, source)``, source
    ``"hbm"`` or ``"fallback"`` — the /stats pool-sizing record."""
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
    per_block = _kv_block_bytes(cfg, block_size, kv_bits)
    if budget <= 0:
        return _ret(fallback, "fallback")
    # Block 0 is the null block; 2 is the smallest pool with a usable one.
    return _ret(max(2, budget // per_block), "hbm")


def _scatter_chunk(pool_l: dict, k: torch.Tensor, v: torch.Tensor,
                   blks: torch.Tensor, offs: torch.Tensor) -> None:
    """Scatter a (B, Hkv, K, D) chunk into (block, offset) per token, IN
    PLACE. ``pool[bj, :, oj] = k[:, :, j]`` keeps numpy's advanced-index
    semantics (the (B,) index axes come first). Requests own disjoint
    blocks, so live rows never collide. Scale leaves present → quantize
    on write (int8 KV)."""
    if "k_scale" in pool_l:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        for j in range(blks.shape[1]):
            bj, oj = blks[:, j], offs[:, j]
            pool_l["k"][bj, :, oj] = kq[:, :, j]
            pool_l["v"][bj, :, oj] = vq[:, :, j]
            pool_l["k_scale"][bj, :, oj] = ks[:, :, j]
            pool_l["v_scale"][bj, :, oj] = vs[:, :, j]
    else:
        for j in range(blks.shape[1]):
            bj, oj = blks[:, j], offs[:, j]
            pool_l["k"][bj, :, oj] = k[:, :, j]
            pool_l["v"][bj, :, oj] = v[:, :, j]


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
    temp = init_kv_cache(cfg, 1, lb, kv_bits=8 if "k_scale" in pool else 0,
                         device=tokens.device)
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
                      ragged: Optional[tuple] = None) -> torch.Tensor:
    """The layer loop of a paged step: per layer, scatter the batch's K/V
    into the pool (in place) BEFORE attention reads it, then attend.

    ``ragged = (seq_starts, seq_lens, kv_lens, tables, kv_mask)``: the
    per-SEQUENCE metadata of a flattened mixed batch, attended by the
    ragged kernel's wrapper with ``attn_kernel``, else its plain version
    (``tables``/``kv_mask``/``attn_positions`` are then unused). Without
    it, one token per slot: ``attn_kernel`` reads the pool through
    ``tables`` with the paged decode kernel's wrapper (bf16 pools only:
    the constructor keeps it off for int8 pools, and the wrapper raises on
    one); otherwise the gathered view goes through
    ``_gqa_decode_attention``. Returns the hidden states (B, 1, dim)."""
    x = _embed(params, cfg, tokens)

    def gathered(leaf):
        return _gathered_view(leaf, tables, cfg.n_kv_heads, block_size,
                              cfg.head_dim)

    for li, layer in enumerate(params.layers):
        pool_l = {name: leaf[li] for name, leaf in pool.items()}
        h = _norm(x, layer.attn_norm, cfg)
        hq, hk, hv = _qkv(h, layer)
        q = apply_rope(_split_heads(hq, cfg.n_heads), cos, sin, per_batch=True)
        k = apply_rope(_split_heads(hk, cfg.n_kv_heads), cos, sin,
                       per_batch=True)
        v = _split_heads(hv, cfg.n_kv_heads)
        _scatter_chunk(pool_l, k, v, blks, offs)
        if ragged is not None:
            seq_starts, seq_lens, kv_lens, seq_tables, seq_mask = ragged
            attend = (ragged_paged_attention if attn_kernel
                      else ragged_attention_reference)
            attn = attend(
                q[:, :, 0, :], pool_l["k"], pool_l["v"], seq_tables, seq_mask,
                seq_starts, seq_lens, kv_lens, block_size,
                k_scale_pool=pool_l.get("k_scale"),
                v_scale_pool=pool_l.get("v_scale"),
            )[:, :, None, :]
        elif attn_kernel:
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
        x = x + _mm(_merge_heads(attn), layer.wo)
        h = _norm(x, layer.mlp_norm, cfg)
        x = x + _mlp(layer, h, cfg)
    return x


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """ONE fused dispatch for a mixed decode/prefill batch. Every token
    scatters at its own (block, offset) and attends its slot's view at its
    own absolute position, so chunk causality and cross-chunk isolation
    fall out of the masking rule. Returns per-SLOT (next_token, chosen
    logprob) sampled at each span's last row; rows of mid-prefill or idle
    slots are sampled too and discarded by the scheduler."""
    tok_seq = tok_seq.long()
    posmat = tok_pos.long()[:, None]
    tok_tables = tables.long()[tok_seq]
    cos, sin, blks, offs = _chunk_coords(cfg, tok_tables, posmat, block_size)
    # Tail pads carry tok_seq 0: force their scatter target to the null
    # block, or they would overwrite slot 0's live KV.
    tok_valid = torch.arange(tokens.shape[0], device=tokens.device) < n_tokens
    blks = torch.where(tok_valid[:, None], blks, 0)
    x = _paged_chunk_scan(
        params, cfg, tokens, pool, None, None, cos, sin, blks, offs, None,
        block_size, attn_kernel=attn_kernel,
        ragged=(seq_starts, seq_lens, kv_lens, tables, kv_mask),
    )
    # Logits only at each slot's last row: the lm head runs S wide.
    xs = x[last_rows.long(), 0]  # (S, dim)
    logits = _lm_head_logits(_norm(xs, params.final_norm, cfg), params)
    return _sample_rows(logits, generator, temps, top_k, top_p, bias)


def _not_ported(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (it comes with {where})"
    )


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
    ``kv_bits=8``) and the plain attention on the CPU; True on the CPU
    raises, as does True with ``kv_bits`` and no ``ragged``; False on the
    card runs the plain attention (for comparing the two). Admission
    prefills always go through ``flash_attention(impl="auto")``. Sampled
    rows draw from ``generator`` (a seeded ``torch.Generator`` on the
    device; seed 0 when None), so they cannot match JAX's draws bit for
    bit.
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
        prompt_cache: bool = False,
        prefix_cache: bool = False,
        attn_kernel: Optional[bool] = None,  # CUDA ragged attention kernel
        ragged: bool = False,  # fused mixed prefill/decode batches
        token_budget: Optional[int] = None,  # ragged rows per step
        hbm_fraction: Optional[float] = None,  # size pool from device memory
        swap_bytes: int = 0,
        device=None,
    ):
        self.gen = gen or GenerationConfig()
        if plan is not None:
            raise _not_ported("plan= (tensor-parallel serving)",
                              "tensor-parallel replicas")
        if prompt_cache or prefix_cache:
            raise _not_ported("prompt_cache/prefix_cache",
                              "the rest of the paged engine")
        if swap_bytes:
            raise _not_ported("swap_bytes (the host-RAM swap tier)",
                              "the rest of the paged engine")
        if cfg.sliding_window:
            raise _not_ported("sliding-window attention",
                              "the rest of the paged engine")
        self.device = resolve_device(device)
        if attn_kernel and kv_bits and not ragged:
            raise ValueError(
                "attn_kernel=True does not compose with kv_bits on the "
                "per-token decode kernel (it reads bf16 pools; an int8 "
                "pool would silently run the gathered path) — the RAGGED "
                "kernel dequantizes int8 pools: add ragged=True or drop "
                "one of the two"
            )
        if attn_kernel and self.device.type != "cuda":
            raise ValueError(
                "attn_kernel=True needs the CUDA card; on device='cpu' the "
                "engine runs the plain attention (leave attn_kernel unset)"
            )
        self.attn_kernel = (
            self.device.type == "cuda" and (not kv_bits or ragged)
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
        if ragged:
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
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.block_size = block_size
        if hbm_fraction is not None:
            num_blocks, self.pool_source = pool_blocks_from_hbm(
                cfg, block_size, kv_bits, fraction=hbm_fraction,
                fallback=num_blocks, device=self.device, with_source=True,
            )
        else:
            self.pool_source = "config"
        self.num_blocks = num_blocks
        self.prompt_bucket = prompt_bucket
        # Capacity (in blocks) one request can ever hold: +1 because a
        # preempted continuation re-admits at a block-aligned padded
        # length, which can overhang the nominal span by one block.
        self.max_blocks = (
            prompt_bucket + self.gen.max_new_tokens + block_size - 1
        ) // block_size + 1
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator lives on {generator.device}, the engine on "
                f"{self.device}"
            )
        self.generator = generator
        self.pool = init_block_pool(cfg, num_blocks, block_size,
                                    kv_bits=kv_bits, device=self.device)
        self.kv_mask = torch.zeros((slots, self.max_blocks * block_size),
                                   dtype=torch.bool, device=self.device)
        self.tables = np.zeros((slots, self.max_blocks), np.int32)
        self.positions = np.zeros((slots,), np.int32)
        self.tokens = np.full((slots, 1), self.gen.pad_id, np.int32)
        # Block 0 is the NULL block, never allocated: inactive slots keep
        # tables=0/positions=0, so their ignored writes land there.
        self._free = list(range(1, num_blocks))
        self._init_base(self.gen, slots, prompt_bucket)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    # -- allocator ---------------------------------------------------------

    def _take_blocks(self, n: int, preempt: bool = True) -> Optional[list[int]]:
        """n blocks off the free list. With ``preempt`` (the DECODE path:
        a running request needs its next block) the youngest active
        request is evicted until the pool can supply n; the ADMISSION path
        passes preempt=False and waits for retirements instead (evicting a
        running request to admit a queued one thrashes). None when the
        pool cannot supply n under the given policy."""
        while len(self._free) < n:
            if not preempt:
                return None
            victim = self._youngest_active()
            if victim is None:
                return None
            self._preempt(victim)
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def _reserve_take(self, need: int) -> Optional[list[int]]:
        """Watermark-guarded admission allocation: keep one free block per
        RUNNING request on top of the admit cost, so admission never grabs
        the blocks running slots need at their next boundary. Never
        preempts; None = stall."""
        reserve = sum(1 for r in self._by_slot if r is not None)
        if len(self._free) < need + reserve:
            return None
        return self._take_blocks(need, preempt=False)

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
                        logprobs=req.logprobs, deadline=req.deadline)
        self._queue.insert(0, cont)

    def _clear_slot_storage(self, slot: int, req: _Request) -> None:
        """Return a request's blocks and fence the slot's state — shared
        by normal release and mid-prefill teardown."""
        self._free.extend(req.blocks)
        req.blocks = []
        self.kv_mask[slot] = False
        self.tables[slot] = 0  # dead writes go to the null block
        self.positions[slot] = 0

    def _release_slot(self, slot: int) -> None:
        req = self._by_slot[slot]
        self._clear_slot_storage(slot, req)
        self._by_slot[slot] = None

    # -- scheduling --------------------------------------------------------

    def _admit_free_slots(self) -> None:
        if self.ragged:
            self._admit_free_slots_ragged()
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
            need = bucket // self.block_size
            blocks = self._reserve_take(need)
            if blocks is None:
                if not any(r is not None for r in self._by_slot):
                    raise RuntimeError(
                        f"block pool too small: {need} blocks needed for "
                        f"a {len(effective)}-token prompt, pool has "
                        f"{self.num_blocks - 1} usable; raise num_blocks"
                    )
                return  # pool busy; retry after in-flight slots retire
            req = self._pop_queue()
            padded, mask = left_pad([effective], self.gen.pad_id, bucket)
            prompt_mask = None if mask.all() else self._up(mask)
            logits = _paged_admit(
                self.params, self.cfg, self._up(padded), self.pool,
                prompt_mask, self._up(np.asarray(blocks, np.int32)),
                self.block_size,
            )
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
                max_new=req.max_new, temperature=req.temperature,
                stop=req.stop, logit_bias=req.logit_bias,
                logprobs=req.logprobs, deadline=req.deadline,
            ), logits)

    def _finish_admit(self, slot: int, req: _Request,
                      logits: torch.Tensor) -> None:
        """Admission tail: sample the first token off the admission
        logits, install the request, and feed the token through
        retirement."""
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
        SAME dispatch produced each one's first token."""
        for slot in completing:
            a = self._ragged_admit.pop(slot)
            req = a["req"]
            req.budget = self._initial_budget(req) - len(req.tokens)
            self._by_slot[slot] = req
            self._note_token(slot, first_tok[slot], first_lp.get(slot))

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
            attn_kernel=self.attn_kernel,
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
