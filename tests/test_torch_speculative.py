"""PyTorch port of speculative decoding vs the JAX package's.

Both sides get the same weights (JAX ``init_params`` through the bridge):
f32 ``tiny`` as the target and a foreign 1-layer draft (other widths,
other weights: ``PRNGKey(7)``), as tests/test_speculative.py draws them.

- ``speculative_generate``: the same tokens and stats as JAX's, the
  frozen-row case at the minimum ``cache_len`` included, and a self-draft
  accepts everything.
- The serving engines run in lockstep with JAX's, one drive quantum at a
  time: every quantum emits the same (rid, token) events and leaves the
  same ``spec_stats()`` (rounds, proposed, accepted, draft_len) and, on
  the paged engines, the same ``free_blocks``. ``SpeculativeContinuousBatcher``;
  ``SpeculativePagedBatcher`` alternating (with the prompt and prefix
  caches), ragged and ragged adaptive; pools in the model's dtype and
  int8; a verify chunk wider than a block.
- Rollback: after a round with rejections every rejected cell is byte
  for byte its state before the dispatch (int8 scales included), and
  after ``run()`` every block is back.
- The greedy guard (both spellings pass; sampling, a per-request
  temperature and ``logit_bias`` are refused with JAX's messages),
  ``truncated_draft``'s bounds and its sharing of the target's modules
  (quantized ones included), and the entry points: ``serve_http`` with
  KUBEFLOW_TPU_SPEC_DRAFT_LEN serves over HTTP (a ``speculative`` block
  on /stats, 400 for ``logprobs``), ``serve_batched --speculative``.
"""

from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import speculative as JS
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models import server as TSV
from kubeflow_tpu_torch.models import speculative as TS
from kubeflow_tpu_torch.models.bridge import params_from_jax
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from tests.test_torch_paged import _models

DRAFT = dict(vocab_size=256, dim=64, n_layers=1, n_heads=2, n_kv_heads=2,
             ffn_hidden=128, max_seq_len=256)
PROMPTS = [[5, 9, 17, 33], [7, 3, 11], [8, 44, 91, 7, 2], [19, 4, 4, 60, 1,
                                                           22, 9]]
STATS = ("rounds", "proposed", "accepted", "draft_len")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def target():
    return _models("tiny", "f32")


@pytest.fixture(scope="module")
def draft():
    jcfg = L.LlamaConfig(**DRAFT, dtype=jnp.float32)
    tcfg = TL.LlamaConfig(**DRAFT, dtype=torch.float32)
    jparams = L.init_params(jcfg, jax.random.PRNGKey(7))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


# -- speculative_generate ----------------------------------------------------


@pytest.mark.parametrize("b,s_prompt,steps,cache_len,k_spec,seed", [
    (1, 8, 24, 64, 4, 1),
    (4, 8, 20, 64, 4, 5),
    (2, 5, 12, 48, 1, 2),
    (2, 5, 12, 48, 6, 2),
    # The frozen-row clamp at the exact minimum cache_len.
    (3, 8, 12, 8 + 12 + 4, 4, 3),
])
def test_speculative_generate_matches_jax(target, draft, b, s_prompt, steps,
                                          cache_len, k_spec, seed):
    jcfg, tcfg, jparams, tparams = target
    djcfg, dtcfg, djparams, dtparams = draft
    prompt = np.random.default_rng(seed).integers(
        0, 256, size=(b, s_prompt)).astype(np.int32)
    jout, jstats = JS.speculative_generate(
        jparams, jcfg, djparams, djcfg, jnp.asarray(prompt), steps=steps,
        cache_len=cache_len, k_spec=k_spec)
    tout, tstats = TS.speculative_generate(
        tparams, tcfg, dtparams, dtcfg, torch.from_numpy(prompt),
        steps=steps, cache_len=cache_len, k_spec=k_spec)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tstats == jstats
    assert tout.shape == (b, steps) and tout.dtype == torch.int32


def test_speculative_generate_self_draft_accepts_everything(target):
    jcfg, tcfg, jparams, tparams = target
    prompt = np.random.default_rng(6).integers(0, 256, size=(3, 6))
    tout, stats = TS.speculative_generate(
        tparams, tcfg, tparams, tcfg, torch.from_numpy(prompt), steps=12,
        cache_len=48, k_spec=4)
    assert stats["acceptance_rate"] == 1.0
    ref = L.generate(jparams, jcfg, jnp.asarray(prompt), steps=12,
                     cache_len=48)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(ref))


def test_speculative_generate_refuses_a_short_cache(target, draft):
    _, tcfg, _, tparams = target
    _, dtcfg, _, dtparams = draft
    with pytest.raises(ValueError, match=r"cache_len 23 < prompt \(8\)"):
        TS.speculative_generate(tparams, tcfg, dtparams, dtcfg,
                                torch.zeros((1, 8), dtype=torch.long),
                                steps=12, cache_len=23, k_spec=4)


# -- the serving engines in lockstep ------------------------------------------


def _spec_pair(target, draft, kind, max_new=6, eos_id=-1, **kw):
    """JAX's and the port's spec engine of ``kind`` on the same weights;
    ``draft`` None makes the target its own draft (every proposal
    accepted, so a draft cache left unprimed on any admission path shows
    in the counters)."""
    jcfg, tcfg, jparams, tparams = target
    djcfg, dtcfg, djparams, dtparams = draft or target
    jgen = JGen(max_new_tokens=max_new, eos_id=eos_id)
    tgen = TGen(max_new_tokens=max_new, eos_id=eos_id)
    if kind == "continuous":
        kw = {"slots": 2, "cache_len": 64, "prompt_bucket": 16,
              "k_spec": 3, **kw}
        return (JS.SpeculativeContinuousBatcher(
                    jparams, jcfg, djparams, djcfg, gen=jgen, **kw),
                TS.SpeculativeContinuousBatcher(
                    tparams, tcfg, dtparams, dtcfg, gen=tgen, device="cpu",
                    **kw))
    kw = {"slots": 2, "num_blocks": 40, "block_size": 8, "prompt_bucket": 16,
          "k_spec": 3, **kw}
    if kw.get("ragged"):
        kw.setdefault("token_budget", 16)
    return (JS.SpeculativePagedBatcher(jparams, jcfg, djparams, djcfg,
                                       gen=jgen, attn_kernel=False, **kw),
            TS.SpeculativePagedBatcher(tparams, tcfg, dtparams, dtcfg,
                                       gen=tgen, device="cpu", **kw))


def _lockstep(jsb, tsb, prompts, paged=True):
    """Submit ``prompts`` to both wrappers and drive their inner engines
    one quantum at a time: every quantum emits the same (rid, token)
    events and leaves the same spec_stats() (and free_blocks). Returns
    the port's {rid: tokens}."""
    events = ([], [])
    engines = (jsb._engine, tsb._engine)
    for sb, eng, ev in zip((jsb, tsb), engines, events):
        eng.on_token = lambda rid, tok, ev=ev: ev.append((rid, int(tok)))
        for p in prompts:
            sb.submit(p)
    step = 0
    while engines[0]._pending() or engines[1]._pending():
        n0 = [len(e) for e in events]
        for eng in engines:
            eng.drive_once()
        assert events[0][n0[0]:] == events[1][n0[1]:], f"quantum {step}"
        js, ts = jsb.spec_stats(), tsb.spec_stats()
        assert {k: ts[k] for k in STATS} == {k: js[k] for k in STATS}, step
        assert ts["acceptance_rate"] == pytest.approx(js["acceptance_rate"])
        if paged:
            assert tsb.free_blocks == jsb.free_blocks, f"quantum {step}"
        step += 1
    for eng in engines:
        eng.on_token = None
    jout, tout = jsb.run(), tsb.run()
    assert jout == tout
    return tout


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_continuous_engine_in_lockstep(target, draft, kv_bits):
    jsb, tsb = _spec_pair(target, draft, "continuous", kv_bits=kv_bits)
    if kv_bits:
        assert tsb.draft_cache["k"].dtype == torch.int8
        assert tsb._cb.cache["k"].dtype == torch.int8
    out = _lockstep(jsb, tsb, PROMPTS, paged=False)
    assert all(len(t) == 6 for t in out.values())
    assert tsb.rounds > 0 and tsb.accepted < tsb.proposed


@pytest.mark.parametrize("kind,kw", [
    ("continuous", {}),
    ("paged", {}),
    ("paged", {"prompt_cache": True}),
    ("paged", {"prefix_cache": True, "admit_chunk": 8}),
    ("paged", {"ragged": True}),
    ("paged", {"ragged": True, "kv_bits": 8}),
], ids=["continuous", "alternating", "alternating-prompt-cache",
        "alternating-prefix-cache", "ragged", "ragged-int8"])
def test_self_draft_in_lockstep_primes_every_admission(target, kind, kw):
    """The target as its own draft, in lockstep with JAX: every admission
    path (one-shot, prompt-cache hit, prefix-cached, a completed ragged
    admission) primes the draft cache, or the acceptance counters part
    from JAX's."""
    jsb, tsb = _spec_pair(target, None, kind, **kw)
    prompts = PROMPTS + PROMPTS[:2] if "cache" in str(kw) else PROMPTS
    _lockstep(jsb, tsb, prompts, paged=kind == "paged")
    assert tsb.rounds > 0 and tsb.accepted > 0.9 * tsb.proposed


PAGED_CASES = {
    "alternating": {},
    "alternating-int8": {"kv_bits": 8},
    "alternating-prompt-cache": {"prompt_cache": True},
    "alternating-prefix-cache": {"prefix_cache": True, "admit_chunk": 8},
    "alternating-chunk-over-a-block": {"block_size": 4, "k_spec": 4,
                                       "num_blocks": 80},
    "ragged": {"ragged": True},
    "ragged-int8": {"ragged": True, "kv_bits": 8},
    "ragged-chunk-over-a-block": {"ragged": True, "block_size": 4,
                                  "k_spec": 4, "num_blocks": 80,
                                  "token_budget": 16},
    "ragged-adaptive": {"ragged": True, "k_spec": 4, "token_budget": 20,
                        "adaptive": True},
    "ragged-adaptive-int8": {"ragged": True, "k_spec": 4, "token_budget": 20,
                             "adaptive": True, "kv_bits": 8},
}


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_engine_in_lockstep(target, draft, case):
    kw = PAGED_CASES[case]
    max_new = 8 if kw.get("adaptive") else 6
    jsb, tsb = _spec_pair(target, draft, "paged", max_new=max_new, **kw)
    prompts = PROMPTS + PROMPTS[:2] if "cache" in case else PROMPTS
    out = _lockstep(jsb, tsb, prompts)
    assert all(len(t) == max_new for t in out.values())
    assert tsb.rounds > 0 and tsb.accepted < tsb.proposed
    assert tsb.free_blocks == tsb._pb.num_blocks - 1 - (
        tsb._pb.prefix_cached_blocks + sum(
            len(e["blocks"]) for e in tsb._pb._prompt_cache.values()))
    if kw.get("adaptive"):
        assert 1 <= tsb.k_cur < 4  # a mostly wrong draft shrank the span
    if kw.get("kv_bits"):
        assert tsb.draft_cache["k"].dtype == torch.int8


def test_ragged_engine_with_eos_retires_mid_round(target, draft):
    """An EOS inside an accepted run retires the slot mid-round: the rest
    of the round's tokens are dropped and counted as JAX counts them."""
    # An EOS id that this model emits: the first token of a plain run.
    plain = TP.PagedBatcher(target[3], target[1],
                            gen=TGen(max_new_tokens=10, eos_id=-1),
                            slots=2, num_blocks=40, block_size=8,
                            prompt_bucket=16, ragged=True, token_budget=16,
                            device="cpu")
    rids = [plain.submit(p) for p in PROMPTS]
    res = plain.run()
    eos = res[rids[0]][3]
    jsb, tsb = _spec_pair(target, draft, "paged", ragged=True, max_new=10,
                          eos_id=eos)
    out = _lockstep(jsb, tsb, PROMPTS)
    assert any(len(t) < 10 for t in out.values())


# -- rollback -----------------------------------------------------------------


def _leaf_bytes(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.contiguous()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.view(torch.int16)
    return leaf.numpy().copy()


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_gather_cells_copies_with_the_indexed_axes_first(target, kv_bits):
    _, tcfg, _, _ = target
    pool = TP.init_block_pool(tcfg, 6, 4, kv_bits=kv_bits, device="cpu")
    for leaf in pool.values():
        leaf.copy_(torch.randint(-50, 50, leaf.shape).to(leaf.dtype))
    snap = TP._gather_cells(pool, [1, 5, 3], [0, 3, 2])
    assert snap["k"].shape == (3, tcfg.n_layers, tcfg.n_kv_heads,
                               tcfg.head_dim)
    if kv_bits:
        assert snap["k_scale"].shape == (3, tcfg.n_layers, tcfg.n_kv_heads)
    np.testing.assert_array_equal(snap["v"][1].numpy(),
                                  pool["v"][:, 5, :, 3].numpy())
    before = {n: _leaf_bytes(v) for n, v in snap.items()}
    for leaf in pool.values():
        leaf.zero_()  # an in-place write must not reach the snapshot
    for name, leaf in snap.items():
        np.testing.assert_array_equal(_leaf_bytes(leaf), before[name])
    TP._restore_cells(pool, snap, [1, 5, 3], [0, 3, 2])
    np.testing.assert_array_equal(_leaf_bytes(pool["v"][:, 5, :, 3]),
                                  before["v"][1])
    assert int(pool["k"][:, 2].abs().sum()) == 0


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_rejected_cells_restore_their_bytes(target, draft, kv_bits,
                                            monkeypatch):
    """One ragged round with rejections: every cell of a rejected suffix
    is byte for byte its state before the dispatch (scales too), and no
    cell outside the committed prefix (and the null block) changed."""
    _, tsb = _spec_pair(target, draft, "paged", ragged=True, max_new=8,
                        kv_bits=kv_bits)
    pb = tsb._pb
    tsb.submit(PROMPTS[0])
    pb._admit_free_slots()
    while all(r is None for r in pb._by_slot):
        pb._step()  # the admission's chunks
    slot, req = next((i, r) for i, r in enumerate(pb._by_slot)
                     if r is not None)
    seen = {}
    real = TP._gather_cells

    def spy(pool, blks, offs):
        seen["cells"] = list(zip(blks, offs))
        return real(pool, blks, offs)

    monkeypatch.setattr(TP, "_gather_cells", spy)
    before = {name: _leaf_bytes(leaf) for name, leaf in pb.pool.items()}
    pos0 = int(pb.positions[slot])
    accepted0 = tsb.accepted
    pb._step()  # one speculative round: verify, walk, rollback
    pos1 = int(pb.positions[slot])
    n_accept = tsb.accepted - accepted0
    assert n_accept < tsb.k_spec, "the round had no rejection"
    assert pos1 == pos0 + n_accept + 1
    rejected = seen["cells"][n_accept + 1:]
    assert rejected
    committed = {(req.blocks[p // pb.block_size], p % pb.block_size)
                 for p in range(pos0, pos1)}
    committed |= {(0, o) for o in range(pb.block_size)}
    for name, leaf in pb.pool.items():
        now = _leaf_bytes(leaf)
        for blk, off in rejected:
            np.testing.assert_array_equal(now[:, blk, :, off],
                                          before[name][:, blk, :, off])
        diff = now != before[name]
        axes = tuple(i for i in range(diff.ndim) if i not in (1, 3))
        changed = {(int(b), int(o))
                   for b, o in np.argwhere(diff.any(axis=axes))}
        assert changed <= committed, (name, changed - committed)


def test_run_with_rejections_returns_every_block(target, draft):
    _, tsb = _spec_pair(target, draft, "paged", ragged=True, max_new=10)
    for p in PROMPTS:
        tsb.submit(p)
    tsb.run()
    assert tsb.acceptance_rate < 1.0
    assert tsb.free_blocks == 39


def test_self_draft_accepts_everything(target):
    _, tcfg, _, tparams = target
    gen = TGen(max_new_tokens=6, eos_id=-1)
    sb = TS.SpeculativePagedBatcher(
        tparams, tcfg, tparams, tcfg, gen=gen, slots=2, num_blocks=40,
        block_size=8, prompt_bucket=16, k_spec=3, ragged=True,
        token_budget=16, device="cpu")
    plain = TP.PagedBatcher(tparams, tcfg, gen=gen, slots=2, num_blocks=40,
                            block_size=8, prompt_bucket=16, ragged=True,
                            token_budget=16, device="cpu")
    rids = [sb.submit(p) for p in PROMPTS[:2]]
    prids = [plain.submit(p) for p in PROMPTS[:2]]
    got, want = sb.run(), plain.run()
    assert [got[r] for r in rids] == [want[r] for r in prids]
    assert sb.acceptance_rate == 1.0


# -- guards, refusals, the draft -----------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, None])
def test_both_greedy_spellings_are_accepted(target, draft, temperature):
    _, tcfg, _, tparams = target
    _, dtcfg, _, dtparams = draft
    gen = TGen(max_new_tokens=4, eos_id=-1, temperature=temperature)
    TS.SpeculativePagedBatcher(tparams, tcfg, dtparams, dtcfg, gen=gen,
                               num_blocks=40, device="cpu")
    TS.SpeculativeContinuousBatcher(tparams, tcfg, dtparams, dtcfg, gen=gen,
                                    cache_len=64, prompt_bucket=16,
                                    device="cpu")


def _jax_error(fn):
    with pytest.raises((ValueError, NotImplementedError)) as err:
        fn()
    return str(err.value)


def test_refusals_carry_the_jax_messages(target, draft):
    jcfg, tcfg, jparams, tparams = target
    djcfg, dtcfg, djparams, dtparams = draft
    cases = [
        (dict(gen=("temperature", 0.8)), {}),
        ({}, {"adaptive": True}),
        ({}, {"ragged": True, "slots": 4, "k_spec": 3, "token_budget": 15}),
    ]
    for gen_kw, kw in cases:
        jgen = JGen(max_new_tokens=4, **dict([gen_kw["gen"]])
                    if gen_kw else {})
        tgen = TGen(max_new_tokens=4, **dict([gen_kw["gen"]])
                    if gen_kw else {})
        want = _jax_error(lambda: JS.SpeculativePagedBatcher(
            jparams, jcfg, djparams, djcfg, gen=jgen, num_blocks=40, **kw))
        got = _jax_error(lambda: TS.SpeculativePagedBatcher(
            tparams, tcfg, dtparams, dtcfg, gen=tgen, num_blocks=40,
            device="cpu", **kw))
        assert got == want
    want = _jax_error(lambda: JS.SpeculativeContinuousBatcher(
        jparams, jcfg, djparams, djcfg, gen=JGen(max_new_tokens=46),
        cache_len=64, prompt_bucket=16))
    got = _jax_error(lambda: TS.SpeculativeContinuousBatcher(
        tparams, tcfg, dtparams, dtcfg, gen=TGen(max_new_tokens=46),
        cache_len=64, prompt_bucket=16, device="cpu"))
    assert got == want
    # plan= is ported (tests/test_torch_tp_serving.py serves through it);
    # an sp-sharded mesh keeps JAX's refusal and text on both engines.
    import copy

    from kubeflow_tpu.parallel import mesh as JM
    from kubeflow_tpu_torch.parallel import mesh as TM

    jplan = JM.MeshPlan(JM.make_mesh(sp=2, devices=jax.devices()[:2]))
    tplan = TM.MeshPlan(TM.make_mesh(sp=2, devices=[0, 1]))
    want = _jax_error(lambda: JS.SpeculativeContinuousBatcher(
        jparams, jcfg, djparams, djcfg, gen=JGen(max_new_tokens=4),
        cache_len=64, prompt_bucket=16, plan=jplan))
    got = _jax_error(lambda: TS.SpeculativeContinuousBatcher(
        tparams, tcfg, dtparams, dtcfg, gen=TGen(max_new_tokens=4),
        cache_len=64, prompt_bucket=16, plan=tplan, device="cpu"))
    assert got == want
    want = _jax_error(lambda: JS.SpeculativePagedBatcher(
        jparams, jcfg, djparams, djcfg, gen=JGen(max_new_tokens=4),
        num_blocks=40, plan=jplan))
    got = _jax_error(lambda: TS.SpeculativePagedBatcher(
        tparams, tcfg, dtparams, dtcfg, gen=TGen(max_new_tokens=4),
        num_blocks=40, plan=tplan, device="cpu"))
    assert got == want
    one = TM.MeshPlan(TM.make_mesh(tp=1))
    sb = TS.SpeculativePagedBatcher(
        one.shard_params(copy.deepcopy(tparams)), tcfg,
        one.shard_params(copy.deepcopy(dtparams)), dtcfg,
        gen=TGen(max_new_tokens=4), num_blocks=40, plan=one, device="cpu")
    assert sb._engine.mesh_axes == {"tp": 1}


def test_per_request_sampling_and_bias_are_refused(target, draft):
    jsb, tsb = _spec_pair(target, draft, "paged", ragged=True)
    for kw in ({"temperature": 0.7}, {"logit_bias": {3: 5.0}}):
        with pytest.raises(ValueError) as jerr:
            jsb.submit(PROMPTS[0], **kw)
        with pytest.raises(ValueError) as terr:
            tsb.submit(PROMPTS[0], **kw)
        assert str(terr.value) == str(jerr.value)


def test_truncated_draft_bounds_and_sharing(target):
    jcfg, tcfg, jparams, tparams = target
    for n in (0, tcfg.n_layers):
        with pytest.raises(ValueError) as jerr:
            JS.truncated_draft(jparams, jcfg, n)
        with pytest.raises(ValueError) as terr:
            TS.truncated_draft(tparams, tcfg, n)
        assert str(terr.value) == str(jerr.value)
    dparams, dcfg = TS.truncated_draft(tparams, tcfg, 1)
    assert dcfg == dataclasses.replace(tcfg, n_layers=1)
    assert len(dparams.layers) == 1
    assert dparams.layers[0] is tparams.layers[0]
    assert dparams.embed is tparams.embed
    assert dparams.final_norm is tparams.final_norm
    assert dparams.lm_head is tparams.lm_head


def test_truncated_draft_shares_quantized_weights(target):
    from kubeflow_tpu_torch.models.quant import quantize_params

    _, tcfg, _, tparams = target
    qparams = quantize_params(tparams)
    dparams, _ = TS.truncated_draft(qparams, tcfg, 1)
    assert dparams.layers[0].wq is qparams.layers[0].wq
    assert dparams.lm_head is qparams.lm_head
    x = torch.randn(2, 1, tcfg.dim)
    a = TL._mm(x, dparams.layers[0].wq)
    np.testing.assert_array_equal(a.numpy(),
                                  TL._mm(x, qparams.layers[0].wq).numpy())


# -- entry points -------------------------------------------------------------


SPEC_ENV = {"KUBEFLOW_TPU_SPEC_DRAFT_LEN": "2",
            "KUBEFLOW_TPU_SERVING_RAGGED": "1"}


class _Served(Exception):
    pass


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("adaptive", [False, True])
def test_serve_http_serves_speculation(monkeypatch, adaptive):
    """serve_http with KUBEFLOW_TPU_SPEC_DRAFT_LEN builds the ragged
    speculative engine over a truncated draft and serves it: a completion,
    a ``speculative`` block on /stats, and 400 for ``logprobs``."""
    from kubeflow_tpu_torch.examples import serve_http
    from tests.test_torch_server import SERVING_KNOBS

    for var in SERVING_KNOBS:
        monkeypatch.delenv(var, raising=False)
    for var, value in SPEC_ENV.items():
        monkeypatch.setenv(var, value)
    if adaptive:
        monkeypatch.setenv("KUBEFLOW_TPU_SPEC_ADAPTIVE", "1")

    class Probe(TSV.InferenceServer):
        def start(self):
            super().start()
            try:
                out = _post(self.port, {"prompt": PROMPTS[0],
                                        "max_tokens": 4})
                with pytest.raises(urllib.error.HTTPError) as err:
                    _post(self.port, {"prompt": PROMPTS[0],
                                      "logprobs": True})
                stats = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/stats",
                    timeout=30).read())
            finally:
                self.stop()
            raise _Served(self, out, err.value.code,
                          json.loads(err.value.read()), stats)

    monkeypatch.setattr(TSV, "InferenceServer", Probe)
    with pytest.raises(_Served) as info:
        serve_http.main(["--config", "tiny", "--device", "cpu", "--port",
                         "0", "--paged", "--num-blocks", "64", "--slots",
                         "2", "--prompt-bucket", "16",
                         "--max-new-tokens", "8"])
    srv, out, code, body, stats = info.value.args
    assert len(out["choices"][0]["tokens"]) == 4
    assert code == 400 and "does not compute logprobs" in body["error"]
    spec = stats["speculative"]
    assert spec["rounds"] > 0 and spec["proposed"] > 0
    assert spec["draft_len"] <= 2
    assert srv._spec.adaptive is adaptive
    assert srv._spec.k_spec == 2 and srv.engine.ragged
    assert srv._spec.draft_cfg.n_layers == max(
        1, TL.LLAMA_CONFIGS["tiny"].n_layers // 4)


@pytest.mark.parametrize("env,message", [
    ({"KUBEFLOW_TPU_KV_SWAP_BYTES": "1048576"}, "HBM sizing / swap-tier"),
    ({"KUBEFLOW_TPU_HBM_FRACTION": "0.5"}, "HBM sizing / swap-tier"),
])
def test_serve_http_speculation_refuses_pool_knobs(monkeypatch, env,
                                                   message):
    from kubeflow_tpu_torch.examples import serve_http
    from tests.test_torch_server import SERVING_KNOBS

    for var in SERVING_KNOBS:
        monkeypatch.delenv(var, raising=False)
    for var, value in {**SPEC_ENV, **env}.items():
        monkeypatch.setenv(var, value)
    with pytest.raises(SystemExit, match=message):
        serve_http.main(["--config", "tiny", "--device", "cpu", "--port",
                         "0", "--paged"])


@pytest.mark.parametrize("extra", [[], ["--paged"], ["--paged", "--kv8"]])
def test_serve_batched_speculative_runs(capsys, extra):
    from kubeflow_tpu_torch.examples import serve_batched

    serve_batched.main(["--device", "cpu", "--config", "tiny",
                        "--speculative", "1", "--max-new-tokens", "6",
                        *extra])
    out = capsys.readouterr().out
    kind = "paged" if "--paged" in extra else "continuous"
    assert f"speculative (1-layer draft, {kind}): acceptance" in out
    assert out.count(" tokens: ") == 3
