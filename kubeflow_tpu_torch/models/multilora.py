"""Multi-LoRA serving: one base model, many adapters, chosen per request.

Counterpart of ``kubeflow_tpu/models/multilora.py``. The adapters are
STACKED on a leading adapter axis (``stack_adapters``: per target ``a``
(N+1, L, in, r) and ``b`` (N+1, L, r, out), a zero "base" row last) and
every request carries an adapter id, so one step serves a batch whose
rows use different adapters:

- per layer, each slot's pair is GATHERED by id (``_gather_adapters``:
  (S, in, r) and (S, r, out), one layer at a time, never per row) and the
  delta rides the base product: y = x@W + (x@a)@b · scaling, accumulated
  in f32 and cast back to x's dtype (``_delta``);
- the base row is the zero row, so base and adapted rows share every op;
- admission prefills THROUGH the adapted body (a base-only prefill would
  hand the adapter a cache it never produced).

``MultiLoraBatcher`` is the dense-cache engine (``_ml_step``, ``_ml_admit``,
plain attention as in JAX); ``MultiLoraPagedBatcher`` the ragged paged
engine, whose every fused dispatch carries the deltas of each row's slot
(``PagedBatcher._ragged_adapters``). There the T flattened rows of S slots
take their deltas through ``route``: h (T, in) times the S slots' ``a``
side by side (in, S·r), each row keeping only its own slot's r columns
(the others multiplied by exact zeros), times the S ``b``s stacked
(S·r, out): the function JAX's per-row gather computes, without a (T, in,
r) gather.

Correctness contract, as in JAX: a row under adapter i emits the tokens a
plain engine over ``merge_lora(params, adapter_i)`` emits, and a base row
the base engine's.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from kubeflow_tpu_torch.models.continuous import (
    ContinuousBatcher,
    _sample_rows,
)
from kubeflow_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    _cache_store_rows,
    _embed,
    _gqa_decode_attention,
    _lm_head_logits,
    _merge_heads,
    _mlp,
    _mm,
    _norm,
    _qkv,
    _split_heads,
    _tp_sum,
    apply_rope,
    rope_frequencies,
)
from kubeflow_tpu_torch.models.lora import LoraConfig
from kubeflow_tpu_torch.models.paged import PagedBatcher


def stack_adapters(adapters: Sequence[dict], cfg: LlamaConfig,
                   lcfg: LoraConfig) -> dict:
    """[adapter tree, ...] → stacked tree with a zero "base" row LAST: per
    target, {"a": (N+1, L, in, r), "b": (N+1, L, r, out)}. Requests with
    no adapter index the zero row, so their delta vanishes without a
    branch."""
    del cfg, lcfg  # the shapes come from the adapters, checked alike
    if not adapters:
        raise ValueError("need at least one adapter (else use "
                         "ContinuousBatcher)")
    want = set(adapters[0])
    for i, ad in enumerate(adapters[1:], 1):
        if set(ad) != want:
            # A silently dropped target would break the merge_lora parity
            # with no error.
            raise ValueError(
                f"adapter {i} targets {sorted(ad)} != adapter 0 targets "
                f"{sorted(want)}: all adapters must share one LoraConfig"
            )
    out = {}
    for target in adapters[0]:
        for ad in adapters:
            if ad[target]["a"].shape != adapters[0][target]["a"].shape:
                raise ValueError(
                    f"adapter shape mismatch on {target}: all adapters "
                    "must share one LoraConfig"
                )
        out[target] = {
            side: torch.stack([ad[target][side] for ad in adapters]
                              + [torch.zeros_like(adapters[0][target][side])])
            for side in ("a", "b")
        }
    return out


def _delta(h: torch.Tensor, sel: dict, target: str, scaling: float,
           route: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LoRA delta of ``target`` for h (B, K, in), f32 accumulation as in
    merge_lora, cast back to h's dtype. ``sel[target]`` holds a (S, in, r)
    and b (S, r, out). Without ``route`` row b of h is slot b (S == B);
    with it (the ragged layout: K == 1, S slots over B flattened rows),
    ``route`` (B, S·r) is 1 where a column belongs to the row's slot, else
    0."""
    a, b = sel[target]["a"], sel[target]["b"]
    if route is None:
        lo = torch.bmm(h.float(), a.float())
        return (torch.bmm(lo, b.float()) * scaling).to(h.dtype)
    s, d_in, r = a.shape
    a_cat = a.float().permute(1, 0, 2).reshape(d_in, s * r)
    lo = (h[:, 0].float() @ a_cat) * route
    out = lo @ b.float().reshape(s * r, -1)
    return (out * scaling).to(h.dtype)[:, None]


def _adapted_qkv(h, layer, sel, scaling, route=None):
    q, k, v = _qkv(h, layer)
    if "wq" in sel:
        q = q + _delta(h, sel, "wq", scaling, route)
    if "wk" in sel:
        k = k + _delta(h, sel, "wk", scaling, route)
    if "wv" in sel:
        v = v + _delta(h, sel, "wv", scaling, route)
    return q, k, v


def _adapted_mlp(layer, x, cfg, sel, scaling, route=None):
    if not (set(sel) & {"w_gate", "w_up", "w_down"}):
        return _mlp(layer, x, cfg)
    pre = _mm(x, layer.w_gate)
    if "w_gate" in sel:
        pre = pre + _delta(x, sel, "w_gate", scaling, route)
    pre = pre.float()
    gate = (F.gelu(pre, approximate="tanh") if cfg.act == "gelu"
            else F.silu(pre))
    up = _mm(x, layer.w_up)
    if "w_up" in sel:
        up = up + _delta(x, sel, "w_up", scaling, route)
    hidden = (gate * up.float()).to(x.dtype)
    out = _mm(hidden, layer.w_down)
    if "w_down" in sel:
        out = out + _delta(hidden, sel, "w_down", scaling, route)
    return _tp_sum(out, layer)


def _gather_adapters(stacked: dict, ids: torch.Tensor, layer: int) -> dict:
    """Layer ``layer``'s adapter pairs of each slot: {"t": {"a": (S, in,
    r), "b": (S, r, out)}}, ``ids`` (S,) the stacked rows."""
    return {t: {side: ab[side][ids, layer] for side in ("a", "b")}
            for t, ab in stacked.items()}


def _slot_route(stacked: dict, ids: torch.Tensor,
                row_slot: torch.Tensor) -> torch.Tensor:
    """(T, S·r) f32: 1 where column j belongs to row t's slot (``row_slot``
    (T,)), the ``route`` of ``_delta`` over the ragged layout."""
    rank = next(iter(stacked.values()))["a"].shape[-1]
    col_slot = torch.arange(ids.shape[0], device=ids.device
                            ).repeat_interleave(rank)
    return (row_slot.long()[:, None] == col_slot[None, :]).float()


def _adapted_layer(layer, cfg, x, sel, scaling, cos, sin, positions,
                   kv_mask, cache_l, store, per_batch):
    """One layer of the adapted decode step and the adapted prefill (JAX's
    ``_scan_body``): ONE body, so the two cannot drift. ``per_batch`` is
    explicit: the step's (B,) positions and the prefill's (sq,) ones are
    both rank 1 but mean different things to rope and the mask."""
    h = _norm(x, layer.attn_norm, cfg)
    hq, hk, hv = _adapted_qkv(h, layer, sel, scaling)
    q = apply_rope(_split_heads(hq, cfg.head_dim), cos, sin,
                   per_batch=per_batch)
    k = apply_rope(_split_heads(hk, cfg.head_dim), cos, sin,
                   per_batch=per_batch)
    v = _split_heads(hv, cfg.head_dim)
    store(cache_l, k, v)
    attn = _gqa_decode_attention(
        q, cache_l["k"], cache_l["v"], positions, window=cfg.sliding_window,
        kv_mask=kv_mask, per_batch=per_batch,
    )
    merged = _merge_heads(attn)
    o = _mm(merged, layer.wo)
    if "wo" in sel:
        o = o + _delta(merged, sel, "wo", scaling)
    x = x + _tp_sum(o, layer)
    h = _norm(x, layer.mlp_norm, cfg)
    return x + _adapted_mlp(layer, h, cfg, sel, scaling)


@torch.no_grad()
def _ml_step(params: Llama, stacked: dict, ids: torch.Tensor,
             tokens: torch.Tensor, cache: dict, positions: torch.Tensor,
             kv_mask: torch.Tensor, generator: torch.Generator,
             temps: torch.Tensor, bias: Optional[torch.Tensor],
             cfg: LlamaConfig, scaling: float, top_k: int, top_p: float):
    """One decode step across every slot, each under its own adapter
    (``ids`` (B,)); the cache is written in place. Returns (next token,
    its logprob) per slot."""
    positions = positions.long()
    ids = ids.long()
    x = _embed(params, cfg, tokens)
    cos, sin = rope_frequencies(cfg, positions)

    def store(cache_l, k, v):
        _cache_store_rows(cache_l, k, v, positions)

    for li, layer in enumerate(params.layers):
        cache_l = {name: leaf[li] for name, leaf in cache.items()}
        x = _adapted_layer(layer, cfg, x, _gather_adapters(stacked, ids, li),
                           scaling, cos, sin, positions, kv_mask, cache_l,
                           store, per_batch=True)
    logits = _lm_head_logits(_norm(x[:, 0], params.final_norm, cfg), params)
    return _sample_rows(logits, generator, temps, top_k, top_p, bias)


@torch.no_grad()
def _ml_admit(params: Llama, stacked: dict, aid: int, tokens: torch.Tensor,
              prompt_mask: Optional[torch.Tensor], cache: dict,
              kv_mask: torch.Tensor, slot: int, cfg: LlamaConfig,
              scaling: float) -> torch.Tensor:
    """Prefill one prompt THROUGH its adapter into ``slot`` (in place) and
    return its first logits (V,): ``continuous._admit_slot`` with the
    adapted body. Its columns past the bucket keep the previous
    occupant's values, as ``_admit_slot``'s do: the positional bound
    hides them until the slot's own decode overwrites them."""
    cache_len = cache["k"].shape[3]
    lb = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    pos = torch.arange(lb, device=tokens.device)
    cos, sin = rope_frequencies(cfg, pos)
    ids = torch.tensor([aid], dtype=torch.long, device=tokens.device)
    mask = (prompt_mask if prompt_mask is not None
            else torch.ones((1, lb), dtype=torch.bool, device=tokens.device))
    # kv_mask spans the FULL cache width; keys past lb are fenced by the
    # positional bound (k_pos <= pos, at most lb - 1).
    row = torch.ones((1, cache_len), dtype=torch.bool, device=tokens.device)
    row[:, :lb] = mask

    def store(cache_l, k, v):
        cache_l["k"][:, :, :lb] = k
        cache_l["v"][:, :, :lb] = v

    for li, layer in enumerate(params.layers):
        cache_l = {name: leaf[li, slot:slot + 1]
                   for name, leaf in cache.items()}
        x = _adapted_layer(layer, cfg, x, _gather_adapters(stacked, ids, li),
                           scaling, cos, sin, pos, row, cache_l, store,
                           per_batch=False)
    kv_mask[slot] = row[0]
    logits = _lm_head_logits(_norm(x[:, -1], params.final_norm, cfg), params)
    return logits[0]


class _AdapterHotCache:
    """Bounded per-replica hot-adapter LRU: every replica holds the base
    weights, but only ``slots`` adapters stay "hot" at once. The stacked
    adapters already sit in device memory, so the cache's job is
    OBSERVABILITY plus an honest miss cost: ``load_s`` stands for the
    host→device upload a cold adapter costs (paid through ``sleep``,
    injectable for tests), and hits/misses/evictions feed ``/stats``. The
    base row is exempt."""

    def __init__(self, slots: int, load_s: float = 0.0, sleep=time.sleep):
        if slots < 1:
            raise ValueError(f"lora cache slots must be >= 1, got {slots}")
        self.slots = int(slots)
        self.load_s = float(load_s)
        self._sleep = sleep
        self._lru: dict[int, None] = {}  # insertion-ordered residency set
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def touch(self, aid: int) -> None:
        if aid in self._lru:
            self._lru.pop(aid)
            self._lru[aid] = None  # re-insert = move to the MRU end
            self.hits += 1
            return
        self.misses += 1
        if len(self._lru) >= self.slots:
            self._lru.pop(next(iter(self._lru)))  # the LRU end
            self.evictions += 1
        self._lru[aid] = None
        if self.load_s:
            self._sleep(self.load_s)  # the simulated adapter upload

    def stats(self) -> dict:
        return {
            "slots": self.slots,
            "resident": len(self._lru),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }


class _AdapterRegistry:
    """Adapter bookkeeping shared by the two multi-LoRA engines: the
    stacked weights, name → row resolution and the optional hot-adapter
    cache. Requests carry None for base and 0..n-1 for adapters; the
    stacked zero row ``n_adapters`` is a gather detail, never a
    request-visible id."""

    def _init_adapters(self, stacked: dict, lcfg: LoraConfig,
                       adapter_names: Optional[Sequence[str]],
                       lora_cache_slots: int = 0,
                       lora_load_s: float = 0.0) -> None:
        first = next(iter(stacked.values()))["a"]
        self.n_adapters = first.shape[0] - 1  # the last row is base
        self.stacked = stacked
        self.scaling = lcfg.scaling
        names = list(adapter_names) if adapter_names is not None else [
            str(i) for i in range(self.n_adapters)
        ]
        if len(names) != self.n_adapters:
            raise ValueError(
                f"{len(names)} adapter_names for {self.n_adapters} adapters"
            )
        self.adapter_names = names
        self._adapter_cache = (
            _AdapterHotCache(lora_cache_slots, lora_load_s)
            if lora_cache_slots else None
        )

    def resolve_adapter(self, adapter) -> int:
        """Name | index | None → stacked row id (None = the base row).
        Only str and int pass: a float would truncate to a DIFFERENT
        adapter and a list or bool is a client bug, so both are a
        ValueError (400 over HTTP)."""
        if adapter is None:
            return self.n_adapters
        if isinstance(adapter, str):
            try:
                return self.adapter_names.index(adapter)
            except ValueError:
                raise ValueError(
                    f"unknown adapter {adapter!r} "
                    f"(serving: {', '.join(self.adapter_names)} + base)"
                ) from None
        if not isinstance(adapter, int) or isinstance(adapter, bool):
            raise ValueError(
                f"adapter must be a name, an integer index, or None — "
                f"got {type(adapter).__name__} {adapter!r}"
            )
        if not 0 <= adapter < self.n_adapters:
            raise ValueError(
                f"adapter index {adapter} out of range "
                f"[0, {self.n_adapters})"
            )
        return adapter

    def _touch_adapter(self, aid: int) -> None:
        """Count the hot-cache access of a non-base adapter, on the
        SUBMITTING thread: a simulated upload stall lands on the request
        path, never inside the engine's drive loop."""
        if self._adapter_cache is not None and aid != self.n_adapters:
            self._adapter_cache.touch(aid)

    def lora_cache_stats(self) -> Optional[dict]:
        """The /stats "lora_cache" block, or None when uncapped."""
        if self._adapter_cache is None:
            return None
        return self._adapter_cache.stats()

    def _submit_adapted(self, prompt, adapter, **kw) -> int:
        aid = self.resolve_adapter(adapter)
        self._touch_adapter(aid)
        rid = super().submit(prompt, **kw)
        # None = base wherever a request travels (chain keys, payloads);
        # the zero-row index exists only at gather time.
        self._queue[-1].adapter_id = None if aid == self.n_adapters else aid
        return rid


class MultiLoraBatcher(_AdapterRegistry, ContinuousBatcher):
    """Fixed-slot continuous batching with a per-request LoRA adapter.

    >>> stacked = stack_adapters([ad_math, ad_code], cfg, lcfg)
    >>> mb = MultiLoraBatcher(params, cfg, stacked, lcfg,
    ...                       adapter_names=["math", "code"])
    >>> mb.submit(p1, adapter="math"); mb.submit(p2, adapter="code")
    >>> mb.submit(p3)                  # base model, same batch
    >>> results = mb.run()

    Its steps and admissions attend with the plain attention, as JAX's.
    """

    def __init__(self, params, cfg, stacked: dict, lcfg: LoraConfig,
                 adapter_names: Optional[Sequence[str]] = None,
                 lora_cache_slots: int = 0, lora_load_s: float = 0.0,
                 **kw):
        for unsupported in ("plan", "kv_bits", "attn_kernel",
                            "admit_chunk"):
            if kw.get(unsupported):
                raise ValueError(
                    f"MultiLoraBatcher does not support {unsupported}= yet"
                )
        kw["attn_kernel"] = False
        super().__init__(params, cfg, **kw)
        self._init_adapters(stacked, lcfg, adapter_names,
                            lora_cache_slots, lora_load_s)
        self._slot_adapter = np.full((self.slots,), self.n_adapters,
                                     np.int64)  # the base row

    def submit(self, prompt, max_new_tokens=None, adapter=None,
               temperature=None, stop=None, logit_bias=None,
               deadline_s=None) -> int:
        return self._submit_adapted(
            prompt, adapter, max_new_tokens=max_new_tokens,
            temperature=temperature, stop=stop, logit_bias=logit_bias,
            deadline_s=deadline_s)

    def _prefill_into_slot(self, slot, req, padded, prompt_mask):
        """The adapter-aware half of admission; the shared loop (padding,
        _post_admit, sampling, budget) lives in ContinuousBatcher."""
        aid = (self.n_adapters if req.adapter_id is None
               else req.adapter_id)
        logits = _ml_admit(self.params, self.stacked, aid, padded,
                           prompt_mask, self.cache, self.kv_mask, slot,
                           self.cfg, self.scaling)
        self._slot_adapter[slot] = aid
        return logits

    def _step(self) -> None:
        active = [i for i, r in enumerate(self._by_slot) if r is not None]
        if not active:
            return
        nxt, lps = _ml_step(
            self.params, self.stacked, self._up(self._slot_adapter),
            self._up(self.tokens), self.cache, self._up(self.positions),
            self.kv_mask, self.generator, self._up(self.temps), self._bias,
            self.cfg, self.scaling, self.gen.top_k, self.gen.top_p,
        )
        for slot in active:
            self.positions[slot] += 1
        host_next = nxt.cpu().numpy()
        host_lps = lps.cpu().numpy()
        for slot in active:
            self._note_token(slot, int(host_next[slot]),
                             float(host_lps[slot]))


class MultiLoraPagedBatcher(_AdapterRegistry, PagedBatcher):
    """Per-request LoRA on the PAGED RAGGED engine: the deltas ride every
    row of the fused dispatch (decode rows, admission chunk rows and
    speculative verify spans alike) through the ``_ragged_adapters``
    hook, so one dispatch serves a mixed-adapter, mixed-phase batch. The
    adapter id salts the prefix chain key (``_chain_key``), so exported
    KV blocks never cross adapters; int8 pools and the ragged attention
    kernel compose unchanged (the delta touches projections, never the
    cache format).

    Ragged only, as in JAX: the alternating path admits through base-only
    prefill programs, which would hand an adapter a cache it never
    produced.

    >>> mb = MultiLoraPagedBatcher(params, cfg, stacked, lcfg,
    ...                            adapter_names=["math", "code"],
    ...                            ragged=True, lora_cache_slots=16)
    >>> mb.submit(p1, adapter="math"); mb.submit(p2)   # adapter + base
    >>> results = mb.run()
    >>> mb.lora_cache_stats()   # {"hits": ..., "evictions": ...}

    ``plan=`` composes, as in JAX: the base weights are the rank's shard
    (``MeshPlan.check_shard``), and each rank's dispatch reads its slice
    of the whole adapters (``MeshPlan.shard_adapters``).
    """

    def __init__(self, params, cfg, stacked: dict, lcfg: LoraConfig,
                 adapter_names: Optional[Sequence[str]] = None,
                 lora_cache_slots: int = 0, lora_load_s: float = 0.0,
                 **kw):
        if not kw.get("ragged"):
            raise ValueError(
                "MultiLoraPagedBatcher requires ragged=True: adapter "
                "deltas are applied per-row inside the fused ragged "
                "dispatch; the legacy alternating path admits through "
                "base-only prefill programs"
            )
        for unsupported in ("prompt_cache", "prefix_cache"):
            if kw.get(unsupported):
                raise ValueError(
                    f"MultiLoraPagedBatcher does not support "
                    f"{unsupported}= yet"
                )
        super().__init__(params, cfg, **kw)
        self._init_adapters(stacked, lcfg, adapter_names,
                            lora_cache_slots, lora_load_s)
        self._dispatch_stacked = (
            stacked if self.plan is None
            else self.plan.shard_adapters(stacked))

    def submit(self, prompt, max_new_tokens=None, adapter=None,
               temperature=None, stop=None, logit_bias=None,
               deadline_s=None) -> int:
        return self._submit_adapted(
            prompt, adapter, max_new_tokens=max_new_tokens,
            temperature=temperature, stop=stop, logit_bias=logit_bias,
            deadline_s=deadline_s)

    def _ragged_adapters(self):
        """(stacked, ids (S,), scaling) for this step's dispatch: each
        slot, decoding or mid-admission, maps to its request's adapter
        (None → the zero base row), so prefill chunks run through the
        adapted body their decode rows will."""
        ids = np.full((self.slots,), self.n_adapters, np.int64)
        for slot, req in enumerate(self._by_slot):
            if req is not None and req.adapter_id is not None:
                ids[slot] = req.adapter_id
        for slot, a in self._ragged_admit.items():
            aid = a["req"].adapter_id
            if aid is not None:
                ids[slot] = aid
        return self._dispatch_stacked, self._up(ids), self.scaling
