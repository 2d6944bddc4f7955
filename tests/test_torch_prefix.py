"""PyTorch port of the paged engine's sharing tiers vs JAX ``PagedBatcher``.

The scenarios of tests/test_paged.py ``TestPromptCache``,
``TestPrefixCache`` and ``TestHostSwap`` run on the port's alternating
engine and on JAX's (``attn_kernel=False``) in lockstep, one
``drive_once`` at a time, from the same weights (JAX ``init_params``
through the bridge) and the same prompts. On f32 ``tiny-gqa`` every
quantum must emit the same tokens (logprobs within 1e-4), and the cache
and swap counters (``prefix_hits``/``_misses``/``_evictions``,
``kv_swap_out``/``_in``, ``kv_swap_restored_tokens``,
``swap_bytes_used``) and ``free_blocks`` must be equal after every
quantum; f32 pools (``kv_bits`` 0) and int8 pools (``kv_bits`` 8) both,
and bf16 pools on bf16 ``tiny`` with pinned prompts.

Also: JAX's constructor refusals with JAX's texts; the prefix engine
keeps an admitted request's deadline where JAX's rebuild drops it;
``_paged_chunk_scan`` never sends a chunk of more than one row to the
decode kernel; sliding-window configs on the alternating and ragged
engines, in lockstep with JAX.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from tests.test_torch_paged import _models, _prompts

COUNTERS = ("prefix_hits", "prefix_misses", "prefix_evictions",
            "kv_swap_out", "kv_swap_in", "kv_swap_restored_tokens",
            "swap_bytes_used", "free_blocks")
PREFIX = [5, 9, 17, 33, 41, 2, 77, 13]  # one block at BS 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def f32_gqa():
    return _models("tiny-gqa", "f32")


@pytest.fixture(scope="module")
def bf16_tiny():
    return _models("tiny", "bf16")


def _pair(models, max_new=6, eos_id=-1, **kw):
    jcfg, tcfg, jparams, tparams = models
    kw = {"slots": 2, "num_blocks": 32, "block_size": 8,
          "prompt_bucket": 16, **kw}
    jpb = JP.PagedBatcher(jparams, jcfg, gen=JGen(max_new_tokens=max_new,
                                                  eos_id=eos_id),
                          attn_kernel=False, **kw)
    tpb = TP.PagedBatcher(tparams, tcfg, gen=TGen(max_new_tokens=max_new,
                                                  eos_id=eos_id),
                          device="cpu", **kw)
    return jpb, tpb


def _same_counters(jpb, tpb, where=""):
    for name in COUNTERS:
        assert getattr(tpb, name) == getattr(jpb, name), (name, where)


def _lockstep(jpb, tpb, prompts, atol=1e-4):
    """Submit ``prompts`` to both engines and drive them one quantum at a
    time: every quantum emits the same (rid, token) events and leaves the
    same counters. Returns the run() views, equal on both."""
    events = ([], [])
    for eng, ev in zip((jpb, tpb), events):
        eng.on_token = lambda rid, tok, ev=ev: ev.append((rid, tok))
        for p in prompts:
            eng.submit(p)
    step = 0
    while jpb._pending() or tpb._pending():
        n0 = [len(e) for e in events]
        jpb.drive_once()
        tpb.drive_once()
        assert events[0][n0[0]:] == events[1][n0[1]:], f"step {step}"
        _same_counters(jpb, tpb, f"step {step}")
        step += 1
    for eng in (jpb, tpb):
        eng.on_token = None
    jout, tout = jpb.run(), tpb.run()
    assert jout == tout
    for rid in jout:
        np.testing.assert_allclose(tpb.run_logprobs()[rid],
                                   jpb.run_logprobs()[rid], atol=atol)
    return tout


def _recording(monkeypatch, name):
    """Record the chunk width of every call of ``<module>.<name>`` in
    both packages: {"jax": [...], "port": [...]}."""
    widths = {"jax": [], "port": []}
    for mod, key in ((JP, "jax"), (TP, "port")):
        real = getattr(mod, name)

        def rec(params, cfg, chunk, *rest, real=real, key=key, **kw):
            widths[key].append(int(chunk.shape[1]))
            return real(params, cfg, chunk, *rest, **kw)

        monkeypatch.setattr(mod, name, rec)
    return widths


def _block_rows(pb, blk):
    """One block's rows of every pool leaf as numpy bytes-comparable
    arrays (bf16 through its 16-bit view)."""
    out = {}
    for name, leaf in pb.pool.items():
        if isinstance(leaf, torch.Tensor):
            rows = leaf[:, blk].contiguous()
            if rows.dtype == torch.bfloat16:
                rows = rows.view(torch.int16)
            out[name] = rows.numpy()
        else:
            out[name] = np.asarray(leaf[:, blk])
    return out


# -- the prompt cache -------------------------------------------------------


class TestPromptCache:
    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_identical_prompts_share_blocks_and_tokens(self, f32_gqa,
                                                       kv_bits):
        jpb, tpb = _pair(f32_gqa, prompt_cache=True, kv_bits=kv_bits)
        out = _lockstep(jpb, tpb, [[5, 9, 17, 33]] * 4)
        assert len(set(map(tuple, out.values()))) == 1
        assert tpb.free_blocks == jpb.free_blocks == 31 - 2
        (entry,) = tpb._prompt_cache.values()
        assert all(tpb._shared_refs[b] == 1 for b in entry["blocks"])

    def test_hit_skips_prefill(self, f32_gqa, monkeypatch):
        widths = _recording(monkeypatch, "_paged_admit")
        jpb, tpb = _pair(f32_gqa, prompt_cache=True, slots=1)
        _lockstep(jpb, tpb, [[5, 9, 17], [5, 9, 17]])
        assert widths["port"] == widths["jax"] == [16]

    def test_eviction_under_pressure(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, prompt_cache=True, num_blocks=10, slots=1)
        out = _lockstep(jpb, tpb, [[3 + i, 41, 90] for i in range(4)])
        assert all(len(t) == 6 for t in out.values())
        assert len(tpb._prompt_cache) == len(jpb._prompt_cache)

    def test_shared_blocks_survive_user_release(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, prompt_cache=True, slots=1)
        first = _lockstep(jpb, tpb, [[7, 3, 11, 2]])
        second = _lockstep(jpb, tpb, [[7, 3, 11, 2]])
        assert list(first.values()) == list(second.values())

    def test_pad_id_leading_token_does_not_collide(self, f32_gqa):
        pad = TGen().pad_id
        jpb, tpb = _pair(f32_gqa, prompt_cache=True, slots=1)
        _lockstep(jpb, tpb, [[pad, 5, 9], [5, 9], [pad, 5, 9], [5, 9]])
        assert len(tpb._prompt_cache) == len(jpb._prompt_cache) == 2

    def test_continuations_bypass_cache(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 8, prompt_cache=True, num_blocks=10)
        out = _lockstep(jpb, tpb, [[3 + i, 41, 90, 7] for i in range(3)])
        assert all(len(t) == 8 for t in out.values())


# -- the prefix cache -------------------------------------------------------


class TestPrefixCache:
    def test_anchored_layout(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=3)
        out = _lockstep(jpb, tpb, _prompts(5, seed=1))
        assert all(len(t) == 6 for t in out.values())

    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_common_prefix_shares_blocks_across_lengths(
            self, f32_gqa, monkeypatch, kv_bits):
        widths = _recording(monkeypatch, "_paged_prefix_admit")
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         kv_bits=kv_bits)
        _lockstep(jpb, tpb, [PREFIX + [3, 8], PREFIX + [60, 4, 29, 7, 90]])
        assert widths["port"] == widths["jax"] == [16, 8]
        assert (tpb.prefix_hits, tpb.prefix_misses) == (1, 1)

    def test_chain_hash_rejects_same_block_different_prefix(
            self, f32_gqa, monkeypatch):
        widths = _recording(monkeypatch, "_paged_prefix_admit")
        second = [7, 7, 7, 7, 6, 6, 6, 6]
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         prompt_bucket=24)
        _lockstep(jpb, tpb, [[1] * 8 + second + [5], [2] * 8 + second + [5]])
        assert widths["port"] == widths["jax"] == [24, 24]

    def test_identical_prompts_share_all_full_blocks(self, f32_gqa):
        prompt = [5, 9, 17, 33, 41, 2, 77, 13, 8, 1, 22, 4, 19, 3, 55, 6,
                  31]
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         prompt_bucket=24)
        first = _lockstep(jpb, tpb, [prompt])
        second = _lockstep(jpb, tpb, [prompt])
        assert list(first.values()) == list(second.values())
        assert tpb.prefix_cached_blocks == jpb.prefix_cached_blocks == 2

    def test_cache_survives_user_release_and_refcounts(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, prefix_cache=True)
        _lockstep(jpb, tpb, [PREFIX + [3, 8]])
        (entry,) = tpb._prefix_entries.values()
        assert tpb._shared_refs[entry["block"]] == 1
        assert tpb.free_blocks == jpb.free_blocks == 31 - 1

    def test_eviction_is_leaf_first(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         prompt_bucket=32)
        _lockstep(jpb, tpb, [list(range(3, 27)) + [2]])
        assert list(tpb._prefix_entries) == list(jpb._prefix_entries)
        assert tpb._evict_prefix_leaf() and jpb._evict_prefix_leaf()
        assert list(tpb._prefix_entries) == list(jpb._prefix_entries)
        assert [e["children"] for e in tpb._prefix_entries.values()] == \
            [e["children"] for e in jpb._prefix_entries.values()] == [1, 0]
        _same_counters(jpb, tpb)

    def test_preempted_continuation_rehits_prefix(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 8, prefix_cache=True, slots=3,
                         num_blocks=10)
        out = _lockstep(jpb, tpb, _prompts(4, seed=11))
        assert all(len(t) == 8 for t in out.values())

    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_long_prompt_admits_in_fixed_pieces(self, f32_gqa, monkeypatch,
                                                kv_bits):
        widths = _recording(monkeypatch, "_paged_prefix_admit")
        prompt = [t % 200 + 3 for t in range(40)]
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         prompt_bucket=48, admit_chunk=16, kv_bits=kv_bits)
        _lockstep(jpb, tpb, [prompt])
        _lockstep(jpb, tpb, [prompt[:32] + [9, 9, 9]])
        assert widths["port"] == widths["jax"] == [16, 16, 8, 8]

    def test_bf16_pool_on_pinned_prompts(self, bf16_tiny):
        """bf16 pools on bf16 ``tiny``: the shared prefix's hit stream and
        every counter as JAX's, on pinned prompts."""
        jpb, tpb = _pair(bf16_tiny, prefix_cache=True, slots=1)
        _lockstep(jpb, tpb, [PREFIX + [3, 8], PREFIX + [60, 4, 29]],
                  atol=5e-2)
        assert tpb.pool["k"].dtype == torch.bfloat16
        assert tpb.prefix_hits == 1


def test_constructor_messages_are_jax_s(f32_gqa):
    """Each refusal raises JAX's exception type with JAX's text."""
    jcfg, tcfg, jparams, tparams = f32_gqa
    kw = dict(slots=1, num_blocks=16, block_size=8, prompt_bucket=16)
    window = dict(cfg_window=8)
    for bad in ({"prompt_cache": True, "prefix_cache": True},
                {"prefix_cache": True, "admit_chunk": 12},
                {"prefix_cache": True, "admit_chunk": -8},
                {"ragged": True, "prefix_cache": True},
                {"ragged": True, "prompt_cache": True},
                {"swap_bytes": -1},
                {"attn_kernel": True, **window}):
        bad = dict(bad)
        jc, tc = jcfg, tcfg
        if bad.pop("cfg_window", None):
            jc = dataclasses.replace(jcfg, sliding_window=8)
            tc = dataclasses.replace(tcfg, sliding_window=8)
        with pytest.raises(ValueError) as jerr:
            JP.PagedBatcher(jparams, jc, **bad, **kw)
        with pytest.raises(ValueError) as terr:
            TP.PagedBatcher(tparams, tc, device="cpu", **bad, **kw)
        assert str(terr.value) == str(jerr.value), bad
    for block_size in (8, 96):
        for prefix in (False, True):
            args = dict(slots=1, num_blocks=6, block_size=block_size,
                        prompt_bucket=96, prefix_cache=prefix)
            assert (TP.PagedBatcher(tparams, tcfg, device="cpu",
                                    **args).admit_chunk
                    == JP.PagedBatcher(jparams, jcfg, **args).admit_chunk)


# -- the host-RAM swap tier -------------------------------------------------


SWAP_PROMPT = PREFIX + [3, 8]  # one registrable block


class TestHostSwap:
    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_demote_restore_byte_exact(self, f32_gqa, kv_bits):
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1, num_blocks=16,
                         swap_bytes=1 << 22, kv_bits=kv_bits)
        first = _lockstep(jpb, tpb, [SWAP_PROMPT])
        ((key, ent),) = tpb._prefix_entries.items()
        assert list(jpb._prefix_entries) == [key]
        before = _block_rows(tpb, ent["block"])
        assert tpb._evict_prefix_leaf() and jpb._evict_prefix_leaf()
        _same_counters(jpb, tpb)
        assert tpb.swap_contains(key) and tpb.swap_blocks == 1
        assert tpb.swap_bytes_used == sum(a.nbytes for a in before.values())
        second = _lockstep(jpb, tpb, [SWAP_PROMPT])
        assert list(first.values()) == list(second.values())
        assert tpb.kv_swap_in == 1
        assert tpb.kv_swap_restored_tokens == tpb.block_size
        ((key2, ent2),) = tpb._prefix_entries.items()
        assert key2 == key and not tpb.swap_contains(key)
        after = _block_rows(tpb, ent2["block"])
        for name in before:
            np.testing.assert_array_equal(before[name], after[name])

    def test_lru_order_under_byte_budget(self, f32_gqa):
        probe = _pair(f32_gqa, prefix_cache=True)[1]
        block_bytes = sum(a.nbytes for a in _block_rows(probe, 0).values())
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         prompt_bucket=32, swap_bytes=2 * block_bytes)
        _lockstep(jpb, tpb, [list(range(3, 27)) + [2]])
        demoted = []
        for _ in range(3):
            keys = set(tpb._prefix_entries)
            assert tpb._evict_prefix_leaf() and jpb._evict_prefix_leaf()
            demoted.extend(keys - set(tpb._prefix_entries))
            _same_counters(jpb, tpb)
        assert tpb.kv_swap_out == 3
        assert [tpb.swap_contains(k) for k in demoted] == \
            [jpb.swap_contains(k) for k in demoted] == [False, True, True]
        assert tpb.swap_bytes_used == 2 * block_bytes

    def test_single_block_over_budget_is_plain_eviction(self, f32_gqa):
        probe = _pair(f32_gqa, prefix_cache=True)[1]
        block_bytes = sum(a.nbytes for a in _block_rows(probe, 0).values())
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         swap_bytes=block_bytes - 1)
        _lockstep(jpb, tpb, [SWAP_PROMPT])
        assert tpb._evict_prefix_leaf() and jpb._evict_prefix_leaf()
        _same_counters(jpb, tpb)
        assert tpb.swap_blocks == 0 and tpb.kv_swap_out == 0

    def test_mismatched_chain_refused(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         swap_bytes=1 << 22)
        _lockstep(jpb, tpb, [SWAP_PROMPT])
        ((key, _),) = tpb._prefix_entries.items()
        for pb in (jpb, tpb):
            assert pb._evict_prefix_leaf()
            assert pb._swap_promote(key, b"not-the-parent") is None
            assert pb._swap_promote(b"unknown-key", None) is None
            assert pb.swap_contains(key)
        _same_counters(jpb, tpb)

    def test_different_first_block_does_not_promote(self, f32_gqa):
        second = [7, 7, 7, 7, 6, 6, 6, 6]
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         prompt_bucket=24, swap_bytes=1 << 22)
        _lockstep(jpb, tpb, [[1] * 8 + second + [5]])
        for pb in (jpb, tpb):
            while pb._evict_prefix_leaf():
                pass
            assert pb.swap_blocks == 2
        _lockstep(jpb, tpb, [[2] * 8 + second + [5]])
        assert tpb.kv_swap_in == 0

    def test_pressure_demotes_and_a_return_promotes(self, f32_gqa):
        """No direct eviction: a pool too small for two prefixes demotes
        the first one's leaves under admission pressure, and serving it
        again promotes them, with every counter as JAX's at every
        quantum."""
        a = list(range(3, 27)) + [2]
        b = list(range(100, 124)) + [2]
        jpb, tpb = _pair(f32_gqa, prefix_cache=True, slots=1,
                         num_blocks=7, prompt_bucket=32, swap_bytes=1 << 22)
        _lockstep(jpb, tpb, [a])
        _lockstep(jpb, tpb, [b])
        assert tpb.kv_swap_out > 0
        _lockstep(jpb, tpb, [a])
        assert tpb.kv_swap_in > 0
        assert tpb.kv_swap_restored_tokens == 8 * tpb.kv_swap_in


# -- the reference fault on the prefix path -----------------------------------


def test_prefix_engine_retires_an_admitted_request_at_its_deadline(f32_gqa):
    """The port's prefix-cached engine keeps an admitted request's
    deadline: past it on the injected clock, the request retires with
    reason "deadline" at its next token. The reference rebuilds the
    admitted request without it (``kubeflow_tpu/models/paged.py:2029-2036``),
    so there the same request runs to its budget."""
    jpb, tpb = _pair(f32_gqa, 8, prefix_cache=True)
    results = []
    for eng in (jpb, tpb):
        now = [100.0]
        eng._clock = lambda now=now: now[0]
        aborted = []
        eng.on_abort = lambda rid, toks, reason, a=aborted: a.append(
            (rid, len(toks), reason))
        emitted = []
        eng.on_token = lambda rid, tok, e=emitted: e.append(tok)
        rid = eng.submit(PREFIX + [3, 8], deadline_s=5.0)
        eng.drive_once()
        eng.drive_once()
        assert eng._by_slot[0] is not None and eng._by_slot[0].rid == rid
        before = len(emitted)
        now[0] += 10.0
        while eng._pending():
            eng.drive_once()
        results.append((rid, aborted, eng.run(), before, len(emitted)))
    (jrid, jab, jout, _, jn), (trid, tab, tout, before, tn) = results
    assert jab == [] and len(jout[jrid]) == jn == 8
    assert 0 < before < 8 and tn == before
    assert tab == [(trid, before, "deadline")]
    assert trid not in tout


# -- the decode kernel takes one row a slot -------------------------------------


def _chunk_case(tcfg, tparams, k_rows):
    """One slot's (1, k_rows) chunk at positions 16.. over a 3-block
    table whose first 16 positions hold random K/V."""
    g = torch.Generator().manual_seed(0)
    pool = TP.init_block_pool(tcfg, 8, 8, device="cpu")
    for leaf in pool.values():
        leaf.copy_(torch.randn(leaf.shape, generator=g, dtype=leaf.dtype))
    table = torch.tensor([[1, 2, 3]], dtype=torch.long)
    pos = 16 + torch.arange(k_rows)[None, :]
    cos, sin, blks, offs = TP._chunk_coords(tcfg, table, pos, 8)
    tokens = torch.randint(3, 200, (1, k_rows), generator=g)
    kv_mask = torch.ones((1, 24), dtype=torch.bool)
    return (tparams, tcfg, tokens, pool, table, kv_mask, cos, sin, blks,
            offs, pos if k_rows > 1 else pos[:, 0], 8)


def test_a_two_row_chunk_never_reaches_the_decode_kernel(f32_gqa,
                                                         monkeypatch):
    """With ``attn_kernel=True`` a (1, 2) chunk (a prefix admission's
    piece) takes the gathered path, and equals ``attn_kernel=False``; a
    one-row step does reach the kernel's wrapper."""
    _, tcfg, _, tparams = f32_gqa
    calls = []
    real = TP.paged_decode_attention

    def kernel(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(TP, "paged_decode_attention", kernel)
    args = _chunk_case(tcfg, tparams, 2)
    with_kernel = TP._paged_chunk_scan(*args, attn_kernel=True)
    assert calls == []
    plain = TP._paged_chunk_scan(*_chunk_case(tcfg, tparams, 2))
    torch.testing.assert_close(with_kernel, plain, rtol=0, atol=0)
    TP._paged_chunk_scan(*_chunk_case(tcfg, tparams, 1), attn_kernel=True)
    assert len(calls) == tcfg.n_layers


# -- sliding-window configs ---------------------------------------------------


@pytest.fixture(scope="module")
def f32_window():
    jcfg, tcfg, jparams, tparams = _models("tiny-gqa", "f32")
    return (dataclasses.replace(jcfg, sliding_window=8),
            dataclasses.replace(tcfg, sliding_window=8), jparams, tparams)


@pytest.mark.parametrize("ragged", [False, True])
def test_sliding_window_engines(f32_window, ragged):
    """``sliding_window=8`` with prompts past the window: the alternating
    engine (flash prefill with the window, gathered decode) and the
    ragged engine (the per-token gathered view, not the window-less plain
    ragged attention) in lockstep with JAX."""
    kw = {"ragged": True, "token_budget": 12} if ragged else {}
    jpb, tpb = _pair(f32_window, 8, slots=2, num_blocks=24, **kw)
    assert tpb.attn_kernel is False
    out = _lockstep(jpb, tpb, _prompts(4, seed=3, lo=10, hi=16))
    assert all(len(t) == 8 for t in out.values())


def test_sliding_window_changes_the_tokens(f32_window, f32_gqa):
    """The window is live at these lengths: the same prompts without it
    decode other tokens."""
    prompts = _prompts(4, seed=3, lo=10, hi=16)
    outs = []
    for models in (f32_window, f32_gqa):
        _, tpb = _pair(models, 8, slots=2, num_blocks=24)
        rids = [tpb.submit(p) for p in prompts]
        res = tpb.run()
        outs.append([res[r] for r in rids])
    assert outs[0] != outs[1]
