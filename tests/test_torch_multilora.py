"""PyTorch port of LoRA serving vs the JAX package's.

On f32 ``tiny`` with ``LoraConfig(rank=4)`` on all seven targets: JAX
draws the adapters (``init_lora_params`` plus noise on both factors, as
tests/test_multilora.py's ``_adapter`` does: a zero ``b`` would make every
parity pass vacuously) and the bridge brings them over byte for byte.

- ``models/lora.py``: ``merge_lora`` within 1e-5 of JAX's, the
  parameter count, the init's shapes and refusal.
- ``models/bridge.py``: one adapter and a stacked tree both ways, byte for
  byte (bf16 too).
- ``models/multilora.py``: ``stack_adapters`` byte-equal to JAX's (and its
  three errors), ``_delta`` within 1e-5 of JAX's, per slot and through the
  ragged route; ``resolve_adapter``'s errors with JAX's texts; the two
  engines' refusals; ``_AdapterHotCache``'s LRU and counters.
- The engines in lockstep with JAX's, one drive quantum at a time, on a
  mixed batch of two adapters and base: ``MultiLoraBatcher`` and the
  ragged ``MultiLoraPagedBatcher`` (pools in the model dtype and int8):
  the same tokens every quantum, logprobs within 1e-4; and each row's
  tokens equal to a plain engine over ``merge_lora(params, its adapter)``.
- An adapter KV payload crosses both ways: salted chain keys, the
  ``adapter`` field, equal tokens.
- Over HTTP: ``model`` routing (an unknown name is 400 with JAX's text),
  ``/v1/models``, the collision error, the ``lora_cache`` block of
  ``/stats``.
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
from kubeflow_tpu.models import lora as JL
from kubeflow_tpu.models import multilora as JM
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu_torch.models import continuous as TC
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import lora as TLo
from kubeflow_tpu_torch.models import multilora as TM
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models import server as TS
from kubeflow_tpu_torch.models.bridge import (
    lora_from_jax,
    lora_to_numpy,
    params_to_numpy,
    stacked_from_jax,
)
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from tests.test_torch_paged import _models
from tests.torch_kv_race import wait_for_pool_writes

ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
LCFG = dict(rank=4, targets=ALL)
NAMES = ["a0", "a1"]
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14], [21, 5, 6],
           [40, 41, 42, 43, 44, 45]]
TAGS = ["a0", "a1", None, "a1", "a0"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_steps_wait_for_pool_writes(monkeypatch):
    """The reference engine's step races its own pool writes
    (tests/torch_kv_race.py): each waits for them first."""
    wait_for_pool_writes(monkeypatch)


def _adapter(jcfg, seed):
    """JAX's ``_adapter`` draw: the init plus 0.05-scaled noise."""
    ad = JL.init_lora_params(jcfg, JL.LoraConfig(**LCFG),
                             jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 100), x.shape, x.dtype), ad)


@pytest.fixture(scope="module")
def world():
    """(jcfg, tcfg, jparams, tparams, JAX adapters, port adapters, JAX
    stack, port stack)."""
    jcfg, tcfg, jparams, tparams = _models("tiny", "f32")
    jads = [_adapter(jcfg, 1), _adapter(jcfg, 5)]
    tads = [lora_from_jax(jax.tree.map(np.asarray, ad), device="cpu")
            for ad in jads]
    jstack = JM.stack_adapters(jads, jcfg, JL.LoraConfig(**LCFG))
    tstack = TM.stack_adapters(tads, tcfg, TLo.LoraConfig(**LCFG))
    return jcfg, tcfg, jparams, tparams, jads, tads, jstack, tstack


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- lora.py and the bridge ---------------------------------------------------


def test_merge_lora_matches_jax(world):
    jcfg, tcfg, jparams, tparams, jads, tads, _, _ = world
    jm = JL.merge_lora(jparams, jads[0], JL.LoraConfig(**LCFG))
    tm = TLo.merge_lora(tparams, tads[0], TLo.LoraConfig(**LCFG))
    got = params_to_numpy(tm)
    for name in ALL:
        np.testing.assert_allclose(got["layers"][name],
                                   np.asarray(jm["layers"][name]),
                                   rtol=1e-5, atol=1e-5)
    # Untouched weights are shared, not copied.
    assert tm.embed is tparams.embed
    assert tm.layers[0].attn_norm is tparams.layers[0].attn_norm
    assert tm.layers[0].wq is not tparams.layers[0].wq


def test_lora_init_count_and_refusal(world):
    jcfg, tcfg = world[:2]
    for lcfg in (dict(LCFG), dict(rank=8, targets=("wq", "w_down"))):
        jl, tl = JL.LoraConfig(**lcfg), TLo.LoraConfig(**lcfg)
        assert TLo.lora_param_count(tcfg, tl) == JL.lora_param_count(jcfg, jl)
        assert tl.scaling == jl.scaling
        ad = TLo.init_lora_params(tcfg, tl, torch.Generator().manual_seed(3),
                                  device="cpu")
        jad = JL.init_lora_params(jcfg, jl, jax.random.PRNGKey(3))
        for t in jl.targets:
            for side in ("a", "b"):
                assert tuple(ad[t][side].shape) == jad[t][side].shape
            assert not ad[t]["b"].any()
    bad = dict(rank=4, targets=("wq", "embed"))
    with pytest.raises(ValueError) as jerr:
        JL.init_lora_params(jcfg, JL.LoraConfig(**bad), jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as terr:
        TLo.init_lora_params(tcfg, TLo.LoraConfig(**bad), device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adapter_trees_cross_the_bridge_byte_for_byte(dtype):
    jcfg = dataclasses.replace(
        L.LLAMA_CONFIGS["tiny"],
        dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tcfg = dataclasses.replace(
        TL.LLAMA_CONFIGS["tiny"],
        dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    jads = [_np(_adapter(jcfg, s)) for s in (1, 2)]
    tads = [lora_from_jax(ad, device="cpu") for ad in jads]
    for jad, tad in zip(jads, tads):
        back = lora_to_numpy(tad, like=jad)
        for t in ALL:
            for side in ("a", "b"):
                assert back[t][side].dtype == jad[t][side].dtype
                assert back[t][side].tobytes() == jad[t][side].tobytes()
    jstack = _np(JM.stack_adapters([_adapter(jcfg, s) for s in (1, 2)],
                                   jcfg, JL.LoraConfig(**LCFG)))
    tstack = TM.stack_adapters(tads, tcfg, TLo.LoraConfig(**LCFG))
    for tree in (tstack, stacked_from_jax(jstack, device="cpu")):
        back = lora_to_numpy(tree, like=jstack)
        for t in ALL:
            for side in ("a", "b"):
                assert back[t][side].shape == jstack[t][side].shape
                assert back[t][side].tobytes() == jstack[t][side].tobytes()
    with pytest.raises(ValueError, match="4"):
        stacked_from_jax(jads[0], device="cpu")
    with pytest.raises(ValueError, match="a and b"):
        lora_from_jax({"wq": {"a": jads[0]["wq"]["a"]}}, device="cpu")


def test_stack_adapters_errors_are_jax_s(world):
    jcfg, tcfg, _, _, jads, tads, _, _ = world
    narrow = dict(rank=4, targets=("wq",))
    jn = JL.init_lora_params(jcfg, JL.LoraConfig(**narrow),
                             jax.random.PRNGKey(9))
    tn = lora_from_jax(_np(jn), device="cpu")
    other = dict(rank=8, targets=ALL)
    jo = JL.init_lora_params(jcfg, JL.LoraConfig(**other),
                             jax.random.PRNGKey(9))
    to = lora_from_jax(_np(jo), device="cpu")
    for jl, tl in (([], []), ([jads[0], jn], [tads[0], tn]),
                   ([jn, jads[0]], [tn, tads[0]]),
                   ([jads[0], jo], [tads[0], to])):
        with pytest.raises(ValueError) as jerr:
            JM.stack_adapters(jl, jcfg, JL.LoraConfig(**LCFG))
        with pytest.raises(ValueError) as terr:
            TM.stack_adapters(tl, tcfg, TLo.LoraConfig(**LCFG))
        assert str(terr.value) == str(jerr.value)


# -- the delta ----------------------------------------------------------------


def test_delta_matches_jax_per_slot_and_through_the_route(world):
    jcfg, tcfg, _, _, _, _, jstack, tstack = world
    rng = np.random.default_rng(0)
    ids = np.array([1, 2, 0], np.int32)  # a1, base, a0
    layer = 1
    jsel = {t: {s: JM._gather_adapters(jstack, jnp.asarray(ids))[t][s][layer]
                for s in ("a", "b")} for t in ALL}
    tsel = TM._gather_adapters(tstack, torch.from_numpy(ids).long(), layer)
    for t in ALL:
        d_in = tsel[t]["a"].shape[1]
        h = rng.standard_normal((3, 5, d_in)).astype(np.float32)
        want = np.asarray(JM._delta(jnp.asarray(h), jsel, t, 4.0))
        got = TM._delta(torch.from_numpy(h), tsel, t, 4.0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # The ragged layout: T rows of the three slots, one token each,
        # against JAX's per-row gather of the same slots.
        row_slot = np.array([0, 0, 1, 2, 2, 2, 1, 0], np.int64)
        hr = rng.standard_normal((8, 1, d_in)).astype(np.float32)
        jrow = {t: {s: jsel[t][s][row_slot] for s in ("a", "b")}}
        want = np.asarray(JM._delta(jnp.asarray(hr), jrow, t, 4.0))
        route = TM._slot_route(tstack, torch.from_numpy(ids).long(),
                               torch.from_numpy(row_slot))
        got = TM._delta(torch.from_numpy(hr), tsel, t, 4.0, route).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not got[row_slot == 1].any()  # the base row adds zeros


# -- the registry ---------------------------------------------------------------


def _dense_pair(world, max_new=6, **kw):
    jcfg, tcfg, jparams, tparams, _, _, jstack, tstack = world
    kw = {"slots": 2, "cache_len": 128, "prompt_bucket": 16, **kw}
    return (JM.MultiLoraBatcher(jparams, jcfg, jstack, JL.LoraConfig(**LCFG),
                                adapter_names=NAMES,
                                gen=JGen(max_new_tokens=max_new), **kw),
            TM.MultiLoraBatcher(tparams, tcfg, tstack, TLo.LoraConfig(**LCFG),
                                adapter_names=NAMES,
                                gen=TGen(max_new_tokens=max_new),
                                device="cpu", **kw))


def _paged_pair(world, max_new=6, kv_bits=0, **kw):
    jcfg, tcfg, jparams, tparams, _, _, jstack, tstack = world
    kw = {"slots": 2, "num_blocks": 40, "block_size": 8, "prompt_bucket": 16,
          "ragged": True, "token_budget": 16, "kv_bits": kv_bits, **kw}
    return (JM.MultiLoraPagedBatcher(
                jparams, jcfg, jstack, JL.LoraConfig(**LCFG),
                adapter_names=NAMES, gen=JGen(max_new_tokens=max_new),
                attn_kernel=False, **kw),
            TM.MultiLoraPagedBatcher(
                tparams, tcfg, tstack, TLo.LoraConfig(**LCFG),
                adapter_names=NAMES, gen=TGen(max_new_tokens=max_new),
                device="cpu", **kw))


def test_resolve_adapter_errors_are_jax_s(world):
    jmb, tmb = _dense_pair(world)
    for ok in ("a1", 0, None):
        assert tmb.resolve_adapter(ok) == jmb.resolve_adapter(ok)
    for bad in ("nope", 5, -1, 1.7, True, ["a0"], {"name": "a0"}):
        with pytest.raises(ValueError) as jerr:
            jmb.resolve_adapter(bad)
        with pytest.raises(ValueError) as terr:
            tmb.resolve_adapter(bad)
        assert str(terr.value) == str(jerr.value)
    jcfg, tcfg, jparams, tparams, _, _, jstack, tstack = world
    with pytest.raises(ValueError) as jerr:
        JM.MultiLoraBatcher(jparams, jcfg, jstack, JL.LoraConfig(**LCFG),
                            adapter_names=["only-one"])
    with pytest.raises(ValueError) as terr:
        TM.MultiLoraBatcher(tparams, tcfg, tstack, TLo.LoraConfig(**LCFG),
                            adapter_names=["only-one"], device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    {"kv_bits": 8}, {"attn_kernel": True}, {"admit_chunk": 8},
    {"plan": object()}])
def test_dense_engine_refusals_are_jax_s(world, kw):
    jcfg, tcfg, jparams, tparams, _, _, jstack, tstack = world
    with pytest.raises(ValueError) as jerr:
        JM.MultiLoraBatcher(jparams, jcfg, jstack, JL.LoraConfig(**LCFG),
                            **kw)
    with pytest.raises(ValueError) as terr:
        TM.MultiLoraBatcher(tparams, tcfg, tstack, TLo.LoraConfig(**LCFG),
                            device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    {}, {"ragged": True, "prompt_cache": True},
    {"ragged": True, "prefix_cache": True}])
def test_paged_engine_refusals_are_jax_s(world, kw):
    jcfg, tcfg, jparams, tparams, _, _, jstack, tstack = world
    with pytest.raises(ValueError) as jerr:
        JM.MultiLoraPagedBatcher(jparams, jcfg, jstack,
                                 JL.LoraConfig(**LCFG), num_blocks=40, **kw)
    with pytest.raises(ValueError) as terr:
        TM.MultiLoraPagedBatcher(tparams, tcfg, tstack,
                                 TLo.LoraConfig(**LCFG), num_blocks=40,
                                 device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_hot_cache_lru_counters_and_load_cost():
    naps = []
    c = TM._AdapterHotCache(2, load_s=0.25, sleep=naps.append)
    c.touch(0)
    c.touch(1)
    assert c.stats() == {"slots": 2, "resident": 2, "hits": 0,
                         "misses": 2, "evictions": 0}
    c.touch(0)  # a hit: 0 becomes the MRU
    c.touch(2)  # full: evicts 1, the LRU
    c.touch(0)
    st = c.stats()
    assert st["hits"] == 2 and st["misses"] == 3
    assert st["evictions"] == 1 and st["resident"] == 2
    c.touch(1)  # reloading the evicted one is a miss
    assert c.stats()["misses"] == 4
    assert naps == [0.25] * 4  # one simulated upload a miss
    j = JM._AdapterHotCache(2)
    for aid in (0, 1, 0, 2, 0, 1):
        j.touch(aid)
    assert j.stats() == c.stats()
    with pytest.raises(ValueError, match="slots"):
        TM._AdapterHotCache(0)


# -- the engines ----------------------------------------------------------------


def _lockstep(jeng, teng, prompts, tags):
    events = ([], [])
    for eng, ev in zip((jeng, teng), events):
        eng.on_token = lambda rid, tok, ev=ev: ev.append((rid, int(tok)))
        for p, t in zip(prompts, tags):
            eng.submit(p, adapter=t)
    step = 0
    while jeng._pending() or teng._pending():
        n0 = [len(e) for e in events]
        jeng.drive_once()
        teng.drive_once()
        assert events[0][n0[0]:] == events[1][n0[1]:], f"quantum {step}"
        step += 1
    for eng in (jeng, teng):
        eng.on_token = None
    jout, tout = jeng.run(), teng.run()
    assert jout == tout
    for rid in jout:
        np.testing.assert_allclose(teng.run_logprobs()[rid],
                                   jeng.run_logprobs()[rid], atol=1e-4)
    return tout


def test_dense_engine_in_lockstep_with_jax(world):
    jmb, tmb = _dense_pair(world)
    _lockstep(jmb, tmb, PROMPTS, TAGS)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_paged_engine_in_lockstep_with_jax(world, kv_bits):
    jmb, tmb = _paged_pair(world, kv_bits=kv_bits)
    _lockstep(jmb, tmb, PROMPTS, TAGS)
    assert tmb.free_blocks == jmb.free_blocks == 39


def _plain_reference(world, adapter, prompts, paged):
    """A plain port engine over merge_lora(params, adapter) (base when
    None): each row's contract."""
    _, tcfg, _, tparams, _, tads, _, _ = world
    params = (tparams if adapter is None else TLo.merge_lora(
        tparams, tads[NAMES.index(adapter)], TLo.LoraConfig(**LCFG)))
    gen = TGen(max_new_tokens=6)
    if paged:
        eng = TP.PagedBatcher(params, tcfg, gen=gen, slots=2, num_blocks=40,
                              block_size=8, prompt_bucket=16, ragged=True,
                              token_budget=16, device="cpu")
    else:
        eng = TC.ContinuousBatcher(params, tcfg, gen=gen, slots=2,
                                   cache_len=128, prompt_bucket=16,
                                   device="cpu")
    rids = [eng.submit(p) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("paged", [False, True])
def test_each_row_matches_a_plain_engine_over_its_merged_adapter(world,
                                                                  paged):
    _, tmb = _paged_pair(world) if paged else _dense_pair(world)
    rids = [tmb.submit(p, adapter=t) for p, t in zip(PROMPTS, TAGS)]
    out = tmb.run()
    for rid, p, t in zip(rids, PROMPTS, TAGS):
        assert out[rid] == _plain_reference(world, t, [p], paged)[0]
    # The three models differ on one prompt: the deltas are not vacuous.
    outs = {str(_plain_reference(world, t, [PROMPTS[0]], paged)[0])
            for t in ("a0", "a1", None)}
    assert len(outs) == 3


def test_paged_hot_cache_counts_the_churn(world):
    _, tmb = _paged_pair(world, lora_cache_slots=1)
    for p, t in zip(PROMPTS[:3], ["a0", "a1", "a0"]):
        tmb.submit(p, adapter=t)
    tmb.run()
    assert tmb.lora_cache_stats() == {"slots": 1, "resident": 1, "hits": 0,
                                      "misses": 3, "evictions": 2}
    _, uncapped = _paged_pair(world)
    assert uncapped.lora_cache_stats() is None


# -- KV payloads with an adapter ------------------------------------------------


def _prefix_engine(world, framework):
    jcfg, tcfg, jparams, tparams = world[:4]
    kw = dict(slots=2, num_blocks=16, prompt_bucket=32, block_size=8,
              prefix_cache=True)
    if framework == "jax":
        return JP.PagedBatcher(jparams, jcfg, gen=JGen(max_new_tokens=8,
                                                       eos_id=-1),
                               attn_kernel=False, **kw)
    return TP.PagedBatcher(tparams, tcfg, gen=TGen(max_new_tokens=8,
                                                   eos_id=-1),
                           device="cpu", **kw)


def _export_with_adapter(engine, prompt, adapter):
    out = {}
    engine.on_token = lambda rid, tok: out.setdefault(
        rid, engine.export_blocks(rid))
    rid = engine.submit(prompt, max_new_tokens=1)
    engine._queue[-1].adapter_id = adapter
    engine.run()
    engine.on_token = None
    return out[rid]


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_adapter_payload_crosses_both_ways(world, src, dst):
    prompt = list(range(1, 21))  # 2 registrable blocks at BS 8
    payload = _export_with_adapter(_prefix_engine(world, src), prompt, 1)
    assert payload["adapter"] == 1
    salted = TP.PagedBatcher._chain_key(None, prompt[:8], adapter=1)
    assert payload["blocks"][0]["key"] == salted.hex()
    assert salted != TP.PagedBatcher._chain_key(None, prompt[:8])
    outs = []
    for framework in (src, dst):
        eng = _prefix_engine(world, framework)
        rid = eng.import_blocks(payload, max_new_tokens=6)
        outs.append(eng.run()[rid])
        # The imported chain is registered under the salted keys.
        assert salted in eng._prefix_entries
    assert outs[0] == outs[1]
    # An exported request keeps its adapter across a re-export.
    eng = _prefix_engine(world, dst)
    out = {}
    eng.on_token = lambda rid, tok: out.setdefault(rid, eng.export_blocks(rid))
    eng.import_blocks(payload, max_new_tokens=1)
    eng.run()
    (re_export,) = out.values()
    assert re_export["adapter"] == 1
    assert [b["key"] for b in re_export["blocks"]] == [
        b["key"] for b in payload["blocks"]]


# -- HTTP -----------------------------------------------------------------------


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("paged", [False, True])
def test_http_routes_the_model_field(world, paged):
    _, tmb = (_paged_pair(world, lora_cache_slots=2) if paged
              else _dense_pair(world, lora_cache_slots=2))
    srv = TS.InferenceServer(tmb, port=0, model_name="tiny").start()
    try:
        p = PROMPTS[0]
        for model, adapter in (("a0", "a0"), ("a1", "a1"), ("tiny", None),
                               (None, None)):
            body = {"prompt": p} if model is None else {"prompt": p,
                                                        "model": model}
            got = _post(srv.port, body)["choices"][0]["tokens"]
            assert got == _plain_reference(world, adapter, [p], paged)[0]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.port, {"prompt": p, "model": "nope"})
        assert err.value.code == 400
        assert json.loads(err.value.read())["error"] == (
            "unknown adapter 'nope' (serving: a0, a1 + base)")
        models = _get(srv.port, "/v1/models")
        assert [m["id"] for m in models["data"]] == ["tiny", "a0", "a1"]
        assert _get(srv.port, "/stats")["lora_cache"] == {
            "slots": 2, "resident": 2, "hits": 0, "misses": 2,
            "evictions": 0}
        _post(srv.port, {"prompt": p, "model": "a0"})  # a hit; base is none
        assert _get(srv.port, "/stats")["lora_cache"]["hits"] == 1
    finally:
        srv.stop()


def test_http_base_server_refuses_another_model(world):
    _, tcfg, _, tparams = world[:4]
    eng = TP.PagedBatcher(tparams, tcfg, gen=TGen(max_new_tokens=4),
                          slots=2, num_blocks=40, block_size=8,
                          prompt_bucket=16, device="cpu")
    srv = TS.InferenceServer(eng, port=0, model_name="tiny").start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(srv.port, {"prompt": PROMPTS[0], "model": "a0"})
        assert err.value.code == 400
        assert "lora_cache" not in _get(srv.port, "/stats")
        assert [m["id"] for m in _get(srv.port, "/v1/models")["data"]] == [
            "tiny"]
    finally:
        srv.stop()


def test_server_refuses_a_model_name_that_collides(world):
    from kubeflow_tpu.models import server as JS

    jcfg, tcfg, jparams, tparams, _, _, jstack, tstack = world
    jmb = JM.MultiLoraBatcher(jparams, jcfg, jstack, JL.LoraConfig(**LCFG),
                              adapter_names=["kubeflow-tpu", "a1"],
                              gen=JGen(max_new_tokens=4), slots=2,
                              cache_len=64, prompt_bucket=16)
    tmb = TM.MultiLoraBatcher(tparams, tcfg, tstack, TLo.LoraConfig(**LCFG),
                              adapter_names=["kubeflow-tpu", "a1"],
                              gen=TGen(max_new_tokens=4), slots=2,
                              cache_len=64, prompt_bucket=16, device="cpu")
    with pytest.raises(ValueError) as jerr:
        JS.InferenceServer(jmb, port=0)
    with pytest.raises(ValueError) as terr:
        TS.InferenceServer(tmb, port=0)
    assert str(terr.value) == str(jerr.value)
    assert "collides" in str(terr.value)
