"""PyTorch port of the paged engines vs JAX ``PagedBatcher``.

Both engines get the same weights (JAX ``init_params`` through the
bridge) and the same numpy prompts, and are driven in lockstep, one
``drive_once`` at a time, in the scheduler regimes of
tests/test_ragged_attention.py: decode-first budget split, starved budget,
the first token arriving in the dispatch that completes its prefill,
preemption mid-batch, mid-prefill cancel, and ``kv_bits=8``. On f32
``tiny-gqa`` every step must emit the same tokens (logprobs within 1e-4).
The JAX engine runs its gathered attention (``attn_kernel=False``), the
port its plain ragged attention: the same rule, other sums. On bf16
``tiny`` greedy tokens are compared on pinned prompts; where a bf16
near-tie forks them, the port's tokens are held to greedy consistency
against JAX ``forward`` instead, and the test says so.

The alternating engine (``ragged=False``) is driven the same way against
JAX ``PagedBatcher(ragged=False, attn_kernel=False)`` in the regimes of
tests/test_paged.py: mixed lengths, a pool smaller than the slots' worst
case, preemption and resume at a continuation bucket above
``prompt_bucket``, early EOS, cancel, and ``kv_bits=8``. On the CPU its
prefill runs the plain flash attention and its decode the gathered
``_gqa_decode_attention``, as JAX's does there.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models.bridge import params_from_jax
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.ops import attention as TA
from kubeflow_tpu_torch.ops import paged_attention as TPA
from kubeflow_tpu_torch.ops import ragged_attention as TRA
from kubeflow_tpu_torch.parallel import mesh as TM


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(name, dtype):
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jcfg = dataclasses.replace(L.LLAMA_CONFIGS[name], dtype=jd)
    tcfg = dataclasses.replace(TL.LLAMA_CONFIGS[name], dtype=td)
    jparams = L.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def f32_gqa():
    return _models("tiny-gqa", "f32")


@pytest.fixture(scope="module")
def bf16_tiny():
    return _models("tiny", "bf16")


def _prompts(n, seed, lo=4, hi=16, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def _pair(models, max_new, ragged=True, eos_id=-1, **kw):
    jcfg, tcfg, jparams, tparams = models
    jpb = JP.PagedBatcher(jparams, jcfg, gen=JGen(max_new_tokens=max_new,
                                                  eos_id=eos_id),
                          attn_kernel=False, ragged=ragged, **kw)
    tpb = TP.PagedBatcher(tparams, tcfg, gen=TGen(max_new_tokens=max_new,
                                                  eos_id=eos_id),
                          ragged=ragged, device="cpu", **kw)
    return jpb, tpb


def _lockstep(jpb, tpb, prompts, between=None):
    """Drive both engines one quantum at a time; every quantum must emit
    the same (rid, token) events. Returns the two engines' run() views."""
    events = ([], [])
    for eng, ev in zip((jpb, tpb), events):
        eng.on_token = lambda rid, tok, ev=ev: ev.append((rid, tok))
        for p in prompts:
            eng.submit(p)
    step = 0
    while jpb._pending() or tpb._pending():
        if between is not None:
            between(step, jpb, tpb)
        n0 = [len(e) for e in events]
        jpb.drive_once()
        tpb.drive_once()
        assert events[0][n0[0]:] == events[1][n0[1]:], f"step {step}"
        assert jpb.last_step == tpb.last_step, f"step {step}"
        step += 1
    jout, tout = jpb.run(), tpb.run()
    assert jout == tout
    for rid in jout:
        np.testing.assert_allclose(tpb.run_logprobs()[rid],
                                   jpb.run_logprobs()[rid], atol=1e-4)
    return jout, tout


class TestF32Parity:
    def test_decode_first_budget_split(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 6, slots=3, num_blocks=24, block_size=8,
                         prompt_bucket=16, token_budget=12)
        out, _ = _lockstep(jpb, tpb, _prompts(6, seed=1))
        assert all(len(t) == 6 for t in out.values())
        assert tpb.ragged_steps == jpb.ragged_steps
        assert tpb.ragged_tokens == jpb.ragged_tokens

    def test_starved_budget(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 4, slots=2, num_blocks=24, block_size=8,
                         prompt_bucket=16, token_budget=2)
        _lockstep(jpb, tpb, _prompts(4, seed=2))

    def test_first_token_in_the_completing_dispatch(self, f32_gqa):
        """A short prompt's prefill and its first token share ONE
        dispatch: after the first quantum the request already holds a
        token, on both engines."""
        jpb, tpb = _pair(f32_gqa, 3, slots=1, num_blocks=16, block_size=8,
                         prompt_bucket=16, token_budget=16)

        def first_step(step, jpb, tpb):
            if step == 1:
                for eng in (jpb, tpb):
                    assert len(eng._by_slot[0].tokens) == 1
                    assert not eng._ragged_admit

        _lockstep(jpb, tpb, [[5, 9, 17, 33, 41]], between=first_step)

    def test_preemption_mid_batch(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 10, slots=3, num_blocks=10, block_size=8,
                         prompt_bucket=16, token_budget=24)
        _lockstep(jpb, tpb, _prompts(4, seed=11))
        assert tpb.free_blocks == jpb.free_blocks == 9  # block 0 is null

    def test_mid_prefill_cancel_frees_blocks(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 6, slots=2, num_blocks=16, block_size=8,
                         prompt_bucket=16, token_budget=4)

        def cancel_first(step, jpb, tpb):
            if step == 1:
                for eng in (jpb, tpb):
                    assert eng._ragged_admit  # partial prefill in flight
                    assert eng.cancel(0)

        _lockstep(jpb, tpb, _prompts(2, seed=3, lo=12), between=cancel_first)
        assert tpb.run_aborted() == jpb.run_aborted() == {0: "cancelled"}
        assert tpb.free_blocks == jpb.free_blocks == 15

    def test_int8_pool(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 6, slots=3, num_blocks=24, block_size=8,
                         prompt_bucket=16, token_budget=12, kv_bits=8)
        _lockstep(jpb, tpb, _prompts(5, seed=4))
        for name in ("k", "v", "k_scale", "v_scale"):
            assert tpb.pool[name].dtype == {
                "k": torch.int8, "v": torch.int8}.get(name, torch.bfloat16)


def test_bf16_greedy_tokens_on_pinned_prompts(bf16_tiny):
    """bf16 rounds at other places in the two frameworks. Tokens agree on
    these prompts; where a near-tie forks them, every port token must
    still be within 0.02 of the argmax of JAX ``forward`` on the port's
    own sequence (greedy consistency, as in tests/test_continuous.py)."""
    jcfg, tcfg, jparams, tparams = bf16_tiny
    prompts = [[5, 9, 17, 33], [7, 1, 200, 3, 99, 45, 12], [250, 4, 4, 4, 8]]
    jpb, tpb = _pair(bf16_tiny, 8, slots=2, num_blocks=16, block_size=8,
                     prompt_bucket=16, token_budget=16)
    jids = [jpb.submit(p) for p in prompts]
    tids = [tpb.submit(p) for p in prompts]
    jout, tout = jpb.run(), tpb.run()
    for p, jr, tr in zip(prompts, jids, tids):
        if jout[jr] == tout[tr]:
            continue
        logits = L.forward(jparams, jcfg, jnp.asarray([p + tout[tr]]))[0]
        for i, tok in enumerate(tout[tr]):
            row = logits[len(p) - 1 + i]
            gap = float(row.max() - row[tok])
            assert gap < 0.02, f"token {i} ({tok}) off the greedy path by {gap}"


def test_sizing_helpers_match(f32_gqa):
    for name in ("tiny", "tiny-gqa", "llama-3-8b", "gemma-2b"):
        for bits in (0, 8):
            for bs in (8, 16):
                assert TP._kv_block_bytes(TL.LLAMA_CONFIGS[name], bs, bits) == \
                    JP._kv_block_bytes(L.LLAMA_CONFIGS[name], bs, bits)
    jpb, tpb = _pair(f32_gqa, 7, slots=3, num_blocks=24, block_size=8,
                     prompt_bucket=16, token_budget=40)
    assert tpb.max_blocks == jpb.max_blocks
    assert tuple(tpb.kv_mask.shape) == jpb.kv_mask.shape
    for rows in (0, 1, 7, 8, 9, 17, 33, 40):
        assert tpb._dispatch_width(rows) == jpb._dispatch_width(rows)
    assert TP.pool_blocks_from_hbm(TL.LLAMA_CONFIGS["tiny"], 16, fallback=9,
                                   device="cpu", with_source=True) == (9, "fallback")


def test_cpu_engine_never_calls_the_kernel(f32_gqa, monkeypatch):
    def no_kernel(*a, **kw):
        raise AssertionError("the CPU engine must not reach the kernel")

    monkeypatch.setattr(TP, "ragged_paged_attention", no_kernel)
    monkeypatch.setattr(TRA, "_library", no_kernel)
    before = TRA.ragged_paged_attention.launches
    _, tpb = _pair(f32_gqa, 3, slots=2, num_blocks=16, block_size=8,
                   prompt_bucket=16, token_budget=8)
    assert tpb.attn_kernel is False
    rid = tpb.submit([5, 9, 17])
    assert len(tpb.run()[rid]) == 3
    assert TRA.ragged_paged_attention.launches == before


def test_constructor_refusals(f32_gqa):
    """The ragged engine refuses the sharing tiers with JAX's ValueError
    and text; a tp plan constructs on both engines (item 11, ported) and
    an sp-sharded one is refused with JAX's text; swap_bytes and
    sliding-window configs construct, the window with its kernel off."""
    jcfg, tcfg, jparams, tparams = f32_gqa
    jkw = dict(slots=2, num_blocks=16, block_size=8, prompt_bucket=16)
    kw = dict(jkw, device="cpu")
    with pytest.raises(ValueError, match="attn_kernel"):
        TP.PagedBatcher(tparams, tcfg, ragged=True, attn_kernel=True, **kw)
    for bad in ({"ragged": True, "prefix_cache": True},
                {"ragged": True, "prompt_cache": True}):
        with pytest.raises(ValueError) as jerr:
            JP.PagedBatcher(jparams, jcfg, **bad, **jkw)
        with pytest.raises(ValueError) as terr:
            TP.PagedBatcher(tparams, tcfg, **bad, **kw)
        assert str(terr.value) == str(jerr.value)
    for ragged in (False, True):
        one = TM.MeshPlan(TM.make_mesh())
        planned = TP.PagedBatcher(one.shard_params(copy.deepcopy(tparams)),
                                  tcfg, ragged=ragged, plan=one, **kw)
        assert planned.mesh_axes == {"tp": 1}
        with pytest.raises(ValueError) as jerr:
            JP.PagedBatcher(jparams, jcfg, ragged=ragged, plan=JM.MeshPlan(
                JM.make_mesh(sp=2, devices=jax.devices()[:2])), **jkw)
        with pytest.raises(ValueError) as terr:
            TP.PagedBatcher(tparams, tcfg, ragged=ragged, plan=TM.MeshPlan(
                TM.make_mesh(sp=2, devices=[0, 1])), **kw)
        assert str(terr.value) == str(jerr.value)
    assert TP.PagedBatcher(tparams, tcfg, ragged=True, swap_bytes=1024,
                           **kw).swap_bytes_limit == 1024
    win = TP.PagedBatcher(tparams, dataclasses.replace(tcfg, sliding_window=8),
                          ragged=True, **kw)
    assert win.attn_kernel is False
    with pytest.raises(ValueError, match="token_budget"):
        TP.PagedBatcher(tparams, tcfg, ragged=True, token_budget=1, **kw)
    with pytest.raises(ValueError, match="prompt_bucket"):
        TP.PagedBatcher(tparams, tcfg, ragged=True,
                        **dict(kw, prompt_bucket=12))


class TestAlternatingF32Parity:
    """``ragged=False``: prefill admissions alternate with decode steps."""

    def test_mixed_lengths(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 6, ragged=False, slots=3, num_blocks=24,
                         block_size=8, prompt_bucket=16)
        out, _ = _lockstep(jpb, tpb, _prompts(5, seed=1))
        assert all(len(t) == 6 for t in out.values())
        assert tpb.free_blocks == jpb.free_blocks == 23

    def test_pool_smaller_than_slots_worst_case(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 8, ragged=False, slots=3, num_blocks=6,
                         block_size=8, prompt_bucket=16)
        out, _ = _lockstep(jpb, tpb, _prompts(4, seed=11))
        assert all(len(t) == 8 for t in out.values())

    def test_preemption_resumes_at_a_larger_bucket(self, f32_gqa,
                                                   monkeypatch):
        """A 4-block pool cannot hold two requests' 3-block spans: the
        youngest is preempted at its third block and re-admits as a
        continuation whose bucket (16) passes prompt_bucket (8)."""
        buckets = []
        real_admit = TP._paged_admit

        def counting(params, cfg, tokens, *a, **kw):
            buckets.append(tokens.shape[1])
            return real_admit(params, cfg, tokens, *a, **kw)

        monkeypatch.setattr(TP, "_paged_admit", counting)
        jpb, tpb = _pair(f32_gqa, 12, ragged=False, slots=2, num_blocks=5,
                         block_size=8, prompt_bucket=8)
        out, _ = _lockstep(jpb, tpb, _prompts(2, seed=7, lo=5, hi=7))
        assert all(len(t) == 12 for t in out.values())
        assert len(buckets) > 2 and max(buckets) > 8, buckets
        assert tpb.free_blocks == jpb.free_blocks == 4

    def test_early_eos_frees_blocks(self, f32_gqa):
        _, tpb = _pair(f32_gqa, 16, ragged=False, slots=1, num_blocks=8,
                       block_size=8, prompt_bucket=16)
        rid = tpb.submit([5, 9, 17])
        first = tpb.run()[rid][0]
        jpb, tpb = _pair(f32_gqa, 16, ragged=False, eos_id=first, slots=1,
                         num_blocks=8, block_size=8, prompt_bucket=16)
        out, _ = _lockstep(jpb, tpb, [[5, 9, 17]])
        assert list(out.values()) == [[]]
        assert tpb.free_blocks == jpb.free_blocks == 7

    def test_cancel_frees_blocks(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 8, ragged=False, slots=2, num_blocks=16,
                         block_size=8, prompt_bucket=16)

        def cancel_first(step, jpb, tpb):
            if step == 2:
                for eng in (jpb, tpb):
                    assert eng._by_slot[0] is not None
                    assert eng.cancel(0)

        _lockstep(jpb, tpb, _prompts(3, seed=3), between=cancel_first)
        assert tpb.run_aborted() == jpb.run_aborted() == {0: "cancelled"}
        assert tpb.free_blocks == jpb.free_blocks == 15

    def test_int8_pool(self, f32_gqa):
        jpb, tpb = _pair(f32_gqa, 6, ragged=False, slots=3, num_blocks=24,
                         block_size=8, prompt_bucket=16, kv_bits=8)
        _lockstep(jpb, tpb, _prompts(5, seed=4))
        assert tpb.attn_kernel is False
        assert tpb.pool["k"].dtype == torch.int8


def test_alternating_cpu_engine_never_calls_a_kernel(f32_gqa, monkeypatch):
    def no_kernel(*a, **kw):
        raise AssertionError("the CPU engine must not reach a kernel")

    for mod in (TA, TPA, TRA):
        monkeypatch.setattr(mod, "_library", no_kernel)
    before = (TA.flash_attention_fwd.launches,
              TPA.paged_decode_attention.launches)
    _, tpb = _pair(f32_gqa, 3, ragged=False, slots=2, num_blocks=16,
                   block_size=8, prompt_bucket=16)
    assert tpb.attn_kernel is False
    rids = [tpb.submit(p) for p in ([5, 9, 17], [4, 4])]
    out = tpb.run()
    assert [len(out[r]) for r in rids] == [3, 3]
    assert (TA.flash_attention_fwd.launches,
            TPA.paged_decode_attention.launches) == before


def test_alternating_engine_constructs(f32_gqa):
    """``ragged=False`` is the constructor's default, as in JAX."""
    _, tcfg, _, tparams = f32_gqa
    kw = dict(slots=2, num_blocks=16, block_size=8, prompt_bucket=16,
              device="cpu")
    pb = TP.PagedBatcher(tparams, tcfg, **kw)
    assert pb.ragged is False and pb.token_budget == 0
    assert pb.attn_kernel is False
    with pytest.raises(ValueError, match="kv_bits"):
        TP.PagedBatcher(tparams, tcfg, attn_kernel=True, kv_bits=8, **kw)
    with pytest.raises(ValueError, match="attn_kernel"):
        TP.PagedBatcher(tparams, tcfg, attn_kernel=True, **kw)
    assert TP.PagedBatcher(tparams, tcfg, prompt_cache=True,
                           **kw)._prompt_cache_enabled
    # A tp plan constructs (item 11): its pool holds this rank's heads.
    one = TM.MeshPlan(TM.make_mesh())
    planned = TP.PagedBatcher(one.shard_params(copy.deepcopy(tparams)),
                              tcfg, plan=one, **kw)
    assert planned.ragged is False and planned.mesh_axes == {"tp": 1}
    assert planned.pool["k"].shape == pb.pool["k"].shape
