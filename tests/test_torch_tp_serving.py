"""Tensor-parallel serving replicas: the port over gloo ranks vs JAX's
``plan=`` on its forced CPU devices.

The JAX reference runs in this process through its normal ``plan=`` path
(``serving_plan(tp)`` over the 8 CPU devices conftest forces). The port
runs as a replica of 2 or 4 gloo processes (``tests/torch_tp_worker.py``):
one spawned group per degree runs every scenario of that degree and
returns JSON, so the suite pays for a few process starts, not one per
test. The weights are JAX's ``init_params(cfg, PRNGKey(0))`` through the
bridge, saved once as a state dict each rank loads.

What is held, mirroring tests/test_tp_serving.py's classes:

- ``TestValidation``: ``validate_serving_tp``, ``serving_plan``,
  ``replica_device_groups``, ``make_mesh``, ``MeshPlan.axes`` and
  ``param_spec`` give JAX's results and error texts;
- ``TestKvBlockBytes``: the per-shard block cost, and its refusals;
- ``TestPoolSharding``: each rank's pool holds 1/tp of the one-rank pool's
  bytes (and JAX's per-device shard bytes); the HBM sizing divides the
  per-block cost;
- ``TestTokenExact``: bf16 ``tiny`` at ``MAX_NEW`` 4 on JAX's pinned
  ``PROMPTS``, the port's tp=N tokens against JAX's tp=N on the ragged
  engine, prefill chunks under a budget of 4, an int8 pool, the
  alternating and continuous engines, speculative verify rows on both
  speculative engines, and LoRA rows on ``MultiLoraPagedBatcher``; every
  rank emits the same tokens. Where the port's psum order forks a bf16
  near-tie, the port's tokens are held to greedy consistency instead
  (each within ``NEAR_TIE`` of the argmax of JAX's one-device
  ``forward`` on the port's own sequence) and ``_tokens_match`` records
  which case it was. On f32 copies of ``tiny`` and ``tiny-gqa``, one
  forward's logits at tp within 1e-5 of JAX's tp forward and of the
  port's one-rank forward, and the ragged and alternating engines' tokens
  equal to JAX's tp=N with logprobs within 1e-4;
- ``TestDisaggHandoffThroughTP``: a JAX payload imported into a tp=2
  replica re-materializes byte for byte (gathered over the ranks),
  decodes to JAX's one-device stream and exports again byte for byte; a
  payload cut by the replica's own prefill decodes on JAX's one-device
  engine to a greedy-consistent stream (JAX's own test of that handoff
  fails on the reference, ROADMAP queue 3); a peer chain re-exports byte
  for byte;
- ``TestStatsMesh``: ``/stats`` has ``mesh: {"tp": 2}`` on the replica
  and no ``mesh`` on one rank;
- ``TestGatewayWithMeshReplica``: JAX's ``ServingGateway`` streams
  through a port tp=2 replica (served from rank 0 through ``TPReplica``)
  the one-device stream, and a peer chain fetch into the replica lands;
- ``serve_http`` with ``KUBEFLOW_TPU_SERVING_TP=2 --device cpu`` serves
  the one-rank tokens, reports its mesh, and SIGTERM stops every rank.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import continuous as JC
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models import speculative as JS
from kubeflow_tpu.models import tp_serving as JT
from kubeflow_tpu.models.gateway import ServingGateway, prompt_chain_keys
from kubeflow_tpu.models.lora import LoraConfig as JLoraConfig
from kubeflow_tpu.models.lora import init_lora_params, merge_lora
from kubeflow_tpu.models.multilora import MultiLoraPagedBatcher as JMLP
from kubeflow_tpu.models.multilora import stack_adapters
from kubeflow_tpu.models.server import InferenceServer as JServer
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models import server as TS
from kubeflow_tpu_torch.models import tp_serving as TT
from kubeflow_tpu_torch.models.bridge import params_from_jax, stacked_from_jax
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.parallel import mesh as TM

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_tp_worker.py"
BS = 8
# JAX's pinned parity regime (tests/test_tp_serving.py).
PROMPTS = [[5, 9, 17], [3, 41, 90, 7], [11] * 9]
MAX_NEW = 4
LORA_PROMPTS = [[5, 9, 17], [3, 41, 90, 7], [12] * 9]
LORA_TAGS = ["a0", None, "a0"]
PROMPT = [5, 9, 17, 33, 2, 11, 44, 3, 8, 21]  # 10 tokens: 2 blocks
CHAIN = list(range(1, 21))  # 20 tokens: 2 registrable blocks
LONG = [5, 9, 17, 33, 2, 11, 44, 3, 8, 21, 7, 250, 1, 99]
# A bf16 near-tie: a forked token's logit lies this close to its row's
# argmax under JAX's one-device forward (tiny's logits are ~1.6, their
# bf16 step ~0.008: a few steps of psum-order noise).
NEAR_TIE = 0.02
SPAWN_TIMEOUT = 600


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_params(name, dtype):
    cfg = dataclasses.replace(L.LLAMA_CONFIGS[name], dtype=dtype)
    return cfg, L.init_params(cfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's weights (bf16 tiny, f32 tiny and tiny-gqa) and LoRA adapter,
    and the files the ranks load them from."""
    tmp = tmp_path_factory.mktemp("tp")
    models, weights = {}, {}
    for name, dtype, tdtype, tag in (
            ("tiny", jnp.bfloat16, torch.bfloat16, "bf16"),
            ("tiny", jnp.float32, torch.float32, "f32"),
            ("tiny-gqa", jnp.float32, torch.float32, "f32")):
        cfg, params = _jax_params(name, dtype)
        models[f"{name}-{tag}"] = (cfg, params)
        tcfg = dataclasses.replace(TL.LLAMA_CONFIGS[name], dtype=tdtype)
        port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                               device="cpu")
        path = tmp / f"{name}-{tag}.pt"
        torch.save(port.state_dict(), path)
        weights[f"{name}-{tag}"] = str(path)
    cfg, params = models["tiny-bf16"]
    lcfg = JLoraConfig(rank=4, targets=("wq", "wv", "w_down"))
    ad = init_lora_params(cfg, lcfg, jax.random.PRNGKey(1))
    ad = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(
            jax.random.PRNGKey(101), x.shape, x.dtype), ad)
    stacked = stack_adapters([ad], cfg, lcfg)
    adapters = tmp / "adapters.pt"
    torch.save(stacked_from_jax(jax.tree.map(np.asarray, stacked),
                                device="cpu"), adapters)
    return {"tmp": tmp, "models": models, "weights": weights,
            "lcfg": lcfg, "adapter": ad, "stacked": stacked,
            "adapters": str(adapters)}


def _spec(ref, world, scenarios, **extra):
    tmp = ref["tmp"]
    out = tmp / f"out-{world}-{'-'.join(scenarios)}"
    return {"world": world, "port": _free_port(), "scenarios": scenarios,
            "weights": ref["weights"], "adapters": ref["adapters"],
            "prompts": PROMPTS, "max_new": MAX_NEW,
            "lora_prompts": LORA_PROMPTS, "lora_tags": LORA_TAGS,
            "prompt": PROMPT, "long": LONG, "out": str(out), **extra}


def _launch(spec):
    path = Path(spec["out"] + ".spec.json")
    path.write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(path), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(spec["world"])]


def _collect(spec, procs):
    errs = []
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=SPAWN_TIMEOUT)
            errs.append(err)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    return [json.loads(Path(f"{spec['out']}.{r}.json").read_text())
            for r in range(spec["world"])]


def _group(ref, world, scenarios, **extra):
    spec = _spec(ref, world, scenarios, **extra)
    return _collect(spec, _launch(spec))


def _jax_payload(ref, kv_bits):
    """JAX's one-device prefill-tier payload of PROMPT."""
    e = _legacy(ref, kv_bits=kv_bits)
    got = {}
    e.on_token = lambda rid, tok: got.setdefault(rid, e.export_blocks(rid))
    rid = e.submit(PROMPT, max_new_tokens=1)
    e.run()
    return got[rid]


def _jax_chain(ref):
    peer = _legacy(ref)
    rid = peer.submit(CHAIN, max_new_tokens=2)
    peer.run()
    del rid
    keys = prompt_chain_keys(CHAIN, BS)
    return peer.export_chain(keys), [k.hex() for k in keys]


@pytest.fixture(scope="module")
def tp2(ref):
    chain, keys = _jax_chain(ref)
    return _group(ref, 2, ["tokens", "f32", "handoff"],
                  f32_models=["tiny", "tiny-gqa"],
                  payloads={str(b): _jax_payload(ref, b) for b in (0, 8)},
                  chain=chain, chain_tokens=CHAIN, chain_keys=keys)


@pytest.fixture(scope="module")
def tp4(ref):
    return _group(ref, 4, ["tokens", "f32"], f32_models=["tiny"])


@pytest.fixture(scope="module")
def groups(tp2, tp4):
    return {2: tp2, 4: tp4}


# ---------------------------------------------------------------------------
# The JAX reference


def _gen(n):
    return JGen(max_new_tokens=n, eos_id=-1)


def _run(engine, prompts, **kw):
    rids = [engine.submit(p, **kw) for p in prompts]
    out = engine.run()
    # The speculative engines verify argmaxes and keep no logprobs.
    lps = getattr(engine, "run_logprobs", dict)()
    return [out[r] for r in rids], [lps.get(r, []) for r in rids]


def _jax_ragged(ref, plan=None, key="tiny-bf16", **kw):
    cfg, params = ref["models"][key]
    return JP.PagedBatcher(params, cfg, gen=_gen(MAX_NEW), slots=2,
                           num_blocks=24, block_size=BS, prompt_bucket=16,
                           ragged=True, attn_kernel=False, plan=plan, **kw)


def _legacy(ref, plan=None, kv_bits=0):
    cfg, params = ref["models"]["tiny-bf16"]
    return JP.PagedBatcher(params, cfg, gen=_gen(8), slots=2, num_blocks=32,
                           block_size=BS, prompt_bucket=32,
                           prefix_cache=True, kv_bits=kv_bits, plan=plan)


def _jax_tokens(ref, scenario, tp):
    """JAX's tp=N tokens for one scenario of ``scenario_tokens``."""
    cfg, params = ref["models"]["tiny-bf16"]
    plan = JT.serving_plan(tp, cfg=cfg)
    if scenario == "ragged":
        return _run(_jax_ragged(ref, plan), PROMPTS)[0]
    if scenario == "chunks":
        return _run(_jax_ragged(ref, plan, token_budget=4), PROMPTS)[0]
    if scenario == "int8":
        return _run(_jax_ragged(ref, plan, kv_bits=8), PROMPTS)[0]
    if scenario == "alternating":
        return _run(JP.PagedBatcher(
            params, cfg, gen=_gen(MAX_NEW), slots=2, num_blocks=24,
            block_size=BS, prompt_bucket=16, plan=plan), PROMPTS)[0]
    if scenario == "continuous":
        return _run(JC.ContinuousBatcher(
            params, cfg, gen=_gen(MAX_NEW), slots=2, cache_len=64,
            prompt_bucket=16, plan=plan), PROMPTS)[0]
    dparams, dcfg = JS.truncated_draft(params, cfg, 1)
    if scenario == "spec":
        return _run(JS.SpeculativePagedBatcher(
            params, cfg, dparams, dcfg, gen=_gen(MAX_NEW), slots=2,
            num_blocks=40, block_size=BS, prompt_bucket=16, k_spec=3,
            ragged=True, token_budget=16, plan=plan), PROMPTS)[0]
    if scenario == "spec_continuous":
        return _run(JS.SpeculativeContinuousBatcher(
            params, cfg, dparams, dcfg, gen=_gen(MAX_NEW), slots=2,
            cache_len=64, prompt_bucket=16, k_spec=3, plan=plan),
            PROMPTS)[0]
    assert scenario == "lora"
    ml = JMLP(params, cfg, ref["stacked"], ref["lcfg"], adapter_names=["a0"],
              gen=_gen(MAX_NEW), slots=2, num_blocks=24, block_size=BS,
              prompt_bucket=16, ragged=True, plan=plan)
    rids = [ml.submit(p, adapter=t) for p, t in zip(LORA_PROMPTS, LORA_TAGS)]
    out = ml.run()
    return [out[r] for r in rids]


def _tokens_match(jax_toks, port_toks, prompts, params, cfg,
                  adapter=None, lcfg=None) -> list:
    """Equal tokens, or (a bf16 near-tie forked by the psum order) every
    port token within NEAR_TIE of the argmax of JAX's one-device forward
    on the port's own sequence. Returns the fallback's prompt indices."""
    fell_back = []
    for i, (p, want, got) in enumerate(zip(prompts, jax_toks, port_toks)):
        assert len(got) == len(want)
        if got == want:
            continue
        fell_back.append(i)
        use = params if adapter is None or adapter[i] is None else \
            merge_lora(params, adapter[i], lcfg)
        logits = L.forward(use, cfg, jnp.asarray([p + got]))[0]
        for j, tok in enumerate(got):
            row = logits[len(p) - 1 + j]
            gap = float(row.max() - row[tok])
            assert gap < NEAR_TIE, (i, j, tok, gap)
    return fell_back


# ---------------------------------------------------------------------------


class TestValidation:
    """Fail-fast startup validation and the mesh: JAX's results and
    texts."""

    @pytest.mark.parametrize("tp,n_devices", [
        (1, None), (2, None), (4, None), (3, None), (0, None), (4, 2),
        (-1, None), (8, 8)])
    def test_validate_serving_tp_matches_jax(self, tp, n_devices):
        for name in ("tiny", "tiny-gqa", "llama-3-8b"):
            try:
                want = JT.validate_serving_tp(L.LLAMA_CONFIGS[name], tp,
                                              n_devices=n_devices)
            except ValueError as err:
                with pytest.raises(ValueError) as got:
                    TT.validate_serving_tp(TL.LLAMA_CONFIGS[name], tp,
                                           n_devices=n_devices)
                assert str(got.value) == str(err)
                continue
            assert TT.validate_serving_tp(
                TL.LLAMA_CONFIGS[name], tp, n_devices=n_devices) == want

    def test_tp1_plan_is_none(self):
        assert TT.serving_plan(1, cfg=TL.LLAMA_CONFIGS["tiny"]) is None
        assert JT.serving_plan(1, cfg=L.LLAMA_CONFIGS["tiny"]) is None

    def test_plan_needs_enough_devices(self):
        for devices in ([0, 1], [0]):
            with pytest.raises(ValueError) as want:
                JT.serving_plan(4, devices=jax.devices()[:len(devices)])
            with pytest.raises(ValueError) as got:
                TT.serving_plan(4, devices=devices)
            assert str(got.value) == str(want.value)
            with pytest.raises(ValueError) as want:
                JT.serving_plan(4, devices=jax.devices()[:len(devices)],
                                cfg=L.LLAMA_CONFIGS["tiny"])
            with pytest.raises(ValueError) as got:
                TT.serving_plan(4, devices=devices,
                                cfg=TL.LLAMA_CONFIGS["tiny"])
            assert str(got.value) == str(want.value)
        # One process, no group: the world is one rank.
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            TT.serving_plan(2)

    def test_replica_device_groups_match_jax(self):
        devs = list(range(8))
        for tp in (1, 2, 3, 4, 8):
            want = JT.replica_device_groups(tp, devices=jax.devices()[:8])
            got = TT.replica_device_groups(tp, devices=devs)
            assert [len(g) for g in got] == [len(g) for g in want]
            assert [d for g in got for d in g] == [
                jax.devices().index(d) for g in want for d in g]
        with pytest.raises(ValueError) as want:
            JT.replica_device_groups(0)
        with pytest.raises(ValueError) as got:
            TT.replica_device_groups(0)
        assert str(got.value) == str(want.value)
        # The default pool is this host's cards: none here.
        assert TT.replica_device_groups(1) == []

    @pytest.mark.parametrize("axes", [
        dict(tp=8), dict(dp=2, tp=4), dict(dp=2, fsdp=2, tp=2),
        dict(sp=2, tp=4), dict(pp=2, ep=2, tp=2), dict(tp=3),
        dict(dp=16)], ids=repr)
    def test_make_mesh_matches_jax(self, axes):
        try:
            want = JM.make_mesh(**axes, devices=jax.devices()[:8])
        except ValueError as err:
            with pytest.raises(ValueError) as got:
                TM.make_mesh(**axes, devices=list(range(8)))
            assert str(got.value) == str(err)
            return
        got = TM.make_mesh(**axes, devices=list(range(8)))
        assert got.shape == dict(want.shape)
        assert got.axis_names == tuple(want.axis_names)
        assert got.ranks.shape == want.devices.shape
        assert got.ranks.reshape(-1).tolist() == [
            jax.devices().index(d) for d in want.devices.reshape(-1)]
        assert TM.MeshPlan(got).axes == JM.MeshPlan(want).axes

    def test_degenerate_plan_axes(self):
        assert TM.MeshPlan(TM.make_mesh()).axes == JM.MeshPlan(
            JM.make_mesh(devices=jax.devices()[:1])).axes == {"tp": 1}

    def test_param_spec_follows_jax_rule(self, ref):
        """JAX's spec of each stacked leaf, less the layer axis, is the
        port's of the per-layer leaf; fp8 histories replicate."""
        cfg, params = ref["models"]["tiny-f32"]
        jplan = JM.MeshPlan(JM.make_mesh(tp=2, devices=jax.devices()[:2]))
        tplan = TM.MeshPlan(TM.make_mesh(tp=2, devices=[0, 1]))
        for name, leaf in params.items():
            if name == "layers":
                continue
            want = tuple(jplan.param_spec((name,), leaf.ndim))
            assert tplan.param_spec((name,), leaf.ndim) == want
        for name, leaf in params["layers"].items():
            want = tuple(jplan.param_spec(("layers", name), leaf.ndim))[1:]
            got = tplan.param_spec(("layers", "0", name), leaf.ndim - 1)
            assert got == tuple(want) or (got == () and not any(want)), name
        for path in (("layers", "wq", "fp8", "x_hist"),
                     ("layers", "wo", "fp8", "g_hist")):
            assert tplan.param_spec(path, 2) == () == tuple(
                jplan.param_spec(path, 2))
        # The qkv biases go with their columns (JAX replicates them and
        # GSPMD slices the add).
        assert tplan.param_spec(("layers", "0", "bq"), 1) == ("tp",)

    def test_env_knob_parses_and_fails_fast(self, monkeypatch):
        from kubeflow_tpu.models.server import serving_tp_from_env

        for value in (None, "4", " 2 ", "zero", "0", "-1", "1.5"):
            if value is None:
                monkeypatch.delenv(TS.KUBEFLOW_TPU_SERVING_TP, raising=False)
            else:
                monkeypatch.setenv(TS.KUBEFLOW_TPU_SERVING_TP, value)
            try:
                want = serving_tp_from_env()
            except ValueError as err:
                with pytest.raises(ValueError) as got:
                    TS.serving_tp_from_env()
                assert str(got.value) == str(err)
                continue
            assert TS.serving_tp_from_env() == want


class TestKvBlockBytes:
    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_per_shard_cost_matches_jax(self, kv_bits):
        for name in ("tiny", "llama-3-8b", "gemma-2b"):
            for tp in (1, 2, 4, 8):
                try:
                    want = JP._kv_block_bytes(L.LLAMA_CONFIGS[name], BS,
                                              kv_bits, tp=tp)
                except ValueError as err:
                    with pytest.raises(ValueError) as got:
                        TP._kv_block_bytes(TL.LLAMA_CONFIGS[name], BS,
                                           kv_bits, tp=tp)
                    assert str(got.value) == str(err)
                    continue
                got = TP._kv_block_bytes(TL.LLAMA_CONFIGS[name], BS, kv_bits,
                                         tp=tp)
                assert got == want
                assert got * tp == TP._kv_block_bytes(
                    TL.LLAMA_CONFIGS[name], BS, kv_bits)

    def test_bad_degrees_rejected(self):
        for tp in (0, 3):
            with pytest.raises(ValueError) as want:
                JP._kv_block_bytes(L.LLAMA_CONFIGS["tiny"], BS, tp=tp)
            with pytest.raises(ValueError) as got:
                TP._kv_block_bytes(TL.LLAMA_CONFIGS["tiny"], BS, tp=tp)
            assert str(got.value) == str(want.value)


class TestPoolSharding:
    @pytest.mark.parametrize("tp", [2, 4])
    def test_per_rank_pool_bytes_drop_by_tp_degree(self, ref, groups, tp):
        """Each rank's head-sharded pool holds 1/tp of every leaf of the
        one-rank pool, as each JAX device's shard does."""
        single = TP.PagedBatcher(
            params_from_jax(jax.tree.map(np.asarray,
                                         ref["models"]["tiny-bf16"][1]),
                            TL.LLAMA_CONFIGS["tiny"], device="cpu"),
            TL.LLAMA_CONFIGS["tiny"], gen=TGen(max_new_tokens=MAX_NEW,
                                               eos_id=-1),
            slots=2, num_blocks=24, block_size=BS, prompt_bucket=16,
            ragged=True, device="cpu")
        jeng = _jax_ragged(ref, JT.serving_plan(
            tp, cfg=ref["models"]["tiny-bf16"][0]))
        for out in groups[tp]:
            got = out["tokens"]
            assert got["mesh_axes"] == {"tp": tp}
            for name, leaf in single.pool.items():
                whole = leaf.numel() * leaf.element_size()
                assert got["pool_bytes"][name] * tp == whole, name
                assert got["pool_shape"][name][2] == leaf.shape[2] // tp
                shard = jeng.pool[name].addressable_shards[0].data.nbytes
                assert got["pool_bytes"][name] == shard, name

    def test_shard_kv_cache_slices_kv_heads_with_jax_rule(self):
        """A whole cache or pool cut to a rank's kv heads (axis 2, int8
        scale leaves alike); a degree that would split a head raises
        JAX's text first."""
        cfg = L.LLAMA_CONFIGS["tiny"]
        jcache = JP.init_block_pool(cfg, 4, BS, kv_bits=8)
        cache = TP.init_block_pool(TL.LLAMA_CONFIGS["tiny"], 4, BS,
                                   kv_bits=8, device="cpu")
        for name, leaf in cache.items():
            leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
        plan = TM.MeshPlan(TM.make_mesh(tp=2, devices=[0, 1]))
        got = plan.shard_kv_cache(cache)
        for name, leaf in cache.items():
            assert torch.equal(got[name], leaf[:, :, :2]), name
        with pytest.raises(ValueError) as want:
            JM.MeshPlan(JM.make_mesh(tp=3, devices=jax.devices()[:3])) \
                .shard_kv_cache(jcache)
        with pytest.raises(ValueError) as err:
            TM.MeshPlan(TM.make_mesh(tp=3, devices=[0, 1, 2])) \
                .shard_kv_cache(cache)
        assert str(err.value) == str(want.value)

    def test_pool_blocks_from_hbm_sizes_off_per_rank_headroom(
            self, monkeypatch):
        """The same free card memory holds tp× the blocks: the per-block
        cost divides, not the budget."""
        monkeypatch.setattr(TP, "resolve_device",
                            lambda d: torch.device("cuda", 0))
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda d: (1 << 31, 1 << 32))
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 0)
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 0)
        cfg = TL.LLAMA_CONFIGS["tiny"]
        one = TP.pool_blocks_from_hbm(cfg, BS)
        four = TP.pool_blocks_from_hbm(cfg, BS, tp=4)
        assert four == 4 * one  # a power-of-two budget: exact


SCENARIOS = ["ragged", "chunks", "int8", "alternating", "continuous", "spec",
             "spec_continuous", "lora"]


class TestTokenExact:
    """A tp=N replica emits JAX's tp=N stream, in every scheduling mode;
    every rank emits the same."""

    @pytest.mark.parametrize("tp", [2, 4])
    @pytest.mark.parametrize("scenario", SCENARIOS)
    def test_tokens_match_jax_tp(self, ref, groups, tp, scenario):
        outs = groups[tp]
        got = outs[0]["tokens"][scenario]
        assert all(o["tokens"][scenario] == got for o in outs[1:])
        want = _jax_tokens(ref, scenario, tp)
        cfg, params = ref["models"]["tiny-bf16"]
        lora = scenario == "lora"
        prompts = LORA_PROMPTS if lora else PROMPTS
        adapters = ([ref["adapter"] if t else None for t in LORA_TAGS]
                    if lora else None)
        fell_back = _tokens_match(want, got, prompts, params, cfg,
                                  adapter=adapters, lcfg=ref["lcfg"])
        # At most one prompt of three may sit on a near-tie.
        assert len(fell_back) <= 1, fell_back
        if scenario == "spec":
            assert 0.0 <= outs[0]["tokens"]["spec_acceptance"] <= 1.0

    @pytest.mark.parametrize("tp,name", [(2, "tiny"), (2, "tiny-gqa"),
                                         (4, "tiny")])
    def test_f32_forward_logits(self, ref, groups, tp, name):
        cfg, params = ref["models"][f"{name}-f32"]
        toks = jnp.asarray([LONG])
        jplan = JT.serving_plan(tp, cfg=cfg)
        want = np.asarray(L.forward(jplan.shard_params(params), cfg, toks)[0])
        tcfg = dataclasses.replace(TL.LLAMA_CONFIGS[name],
                                   dtype=torch.float32)
        one = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                              device="cpu")
        with torch.no_grad():
            single = TL.forward(one, tcfg, torch.tensor([LONG]))[0].numpy()
        for out in groups[tp]:
            got = np.asarray(out["f32"][f"{name}/logits"])
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            np.testing.assert_allclose(got, single, atol=1e-5, rtol=0)

    @pytest.mark.parametrize("tp,name", [(2, "tiny"), (2, "tiny-gqa"),
                                         (4, "tiny")])
    @pytest.mark.parametrize("engine", ["ragged", "alternating"])
    def test_f32_engine_tokens_and_logprobs(self, ref, groups, tp, name,
                                            engine):
        cfg, params = ref["models"][f"{name}-f32"]
        plan = JT.serving_plan(tp, cfg=cfg)
        if engine == "ragged":
            jeng = _jax_ragged(ref, plan, key=f"{name}-f32")
        else:
            jeng = JP.PagedBatcher(params, cfg, gen=_gen(MAX_NEW), slots=2,
                                   num_blocks=24, block_size=BS,
                                   prompt_bucket=16, plan=plan)
        want, want_lps = _run(jeng, PROMPTS)
        got, got_lps = groups[tp][0]["f32"][f"{name}/{engine}"]
        assert got == want
        for a, b in zip(got_lps, want_lps):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


class TestDisaggHandoffThroughTP:
    """The wire format is the one-rank one: a replica's heads are gathered
    on export and sliced on import."""

    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_import_into_tp_replica_byte_exact(self, ref, tp2, kv_bits):
        payload = _jax_payload(ref, kv_bits)
        for out in tp2:
            got = out["handoff"][str(kv_bits)]
            for j, ent in enumerate(payload["blocks"]):
                for name, b64 in ent["data"].items():
                    assert got["rows"][j][name] == b64, (kv_bits, j, name)
            assert got["imports"] == 1
            assert got["local_shape"][2] == 2  # 4 kv heads over 2 ranks
        # The decode against JAX's tp=2 replica fed the same payload (its
        # own test holds that to the one-device fused stream).
        cfg, params = ref["models"]["tiny-bf16"]
        c = _legacy(ref, JT.serving_plan(2, cfg=cfg), kv_bits=kv_bits)
        r = c.import_blocks(payload, max_new_tokens=8)
        got = [out["handoff"][str(kv_bits)]["tokens"] for out in tp2]
        assert got[0] == got[1]
        fell_back = _tokens_match([c.run()[r]], got[:1], [PROMPT], params,
                                  cfg)
        assert fell_back in ([], [0])

    @pytest.mark.parametrize("kv_bits", [0, 8])
    def test_export_from_tp_replica_byte_equal(self, ref, tp2, kv_bits):
        """Imported rows export again from the head-sharded pool byte for
        byte, in the one-rank envelope."""
        payload = _jax_payload(ref, kv_bits)
        got = tp2[0]["handoff"][str(kv_bits)]
        assert got["reexport"] == [b["data"] for b in payload["blocks"]]
        assert got["leaves"] == payload["leaves"]

    def test_prefill_on_tp_replica_greedy_consistent(self, ref, tp2):
        """The replica's own prefill exports; JAX's one-device tier
        imports and decodes. JAX's own test of this handoff fails on the
        reference (its tp prefill KV differs by bf16 steps, and the stream
        forks), so the decoded stream is held to greedy consistency."""
        payload = tp2[0]["handoff"]["prefill_payload"]
        assert tp2[0]["handoff"]["exports"] == 1
        assert payload == tp2[1]["handoff"]["prefill_payload"]
        assert payload["leaves"] == _jax_payload(ref, 0)["leaves"]
        b = _legacy(ref)
        rid = b.import_blocks(payload, max_new_tokens=8)
        toks = b.run()[rid]
        cfg, params = ref["models"]["tiny-bf16"]
        _tokens_match([toks], [toks], [PROMPT], params, cfg)
        logits = L.forward(params, cfg, jnp.asarray([PROMPT + toks]))[0]
        for j, tok in enumerate(toks):
            row = logits[len(PROMPT) - 1 + j]
            assert float(row.max() - row[tok]) < NEAR_TIE, (j, tok)

    def test_kv_prefill_over_http_cuts_the_same_payload(self, tp2, replica):
        """``/kv/prefill`` on a replica served from rank 0: the export runs
        inside the on_token hook of a mirrored step, and the request was
        marked (``mark_kv_export``) so that the other rank gathers its
        heads at the same token. The payload is the one every rank cut in
        lockstep from the same prefill."""
        conn = http.client.HTTPConnection(*replica, timeout=120)
        conn.request("POST", "/kv/prefill",
                     json.dumps({"prompt": PROMPT}).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, body
        assert body["payload"] == tp2[0]["handoff"]["prefill_payload"]
        assert _get(*replica, "/stats")["kv_handoff"]["exports"] == 1

    def test_peer_chain_reexports_byte_exact(self, ref, tp2):
        chain, _ = _jax_chain(ref)
        want = [b["data"] for b in chain["blocks"]]
        for out in tp2:
            assert out["handoff"]["chain"] == want
        # The probe advisory counts the wire (gathered) block.
        assert tp2[0]["handoff"]["chain_bytes"] == \
            _one_rank_legacy(ref).chain_block_bytes()


def _one_rank_legacy(ref):
    cfg = TL.LLAMA_CONFIGS["tiny"]
    params = params_from_jax(jax.tree.map(np.asarray,
                                          ref["models"]["tiny-bf16"][1]),
                             cfg, device="cpu")
    return TP.PagedBatcher(params, cfg, gen=TGen(max_new_tokens=8,
                                                 eos_id=-1),
                           slots=2, num_blocks=32, block_size=BS,
                           prompt_bucket=32, prefix_cache=True, device="cpu")


# ---------------------------------------------------------------------------
# A replica served over HTTP from rank 0 (TPReplica + follow).


@pytest.fixture(scope="module")
def replica(ref):
    spec = _spec(ref, 2, ["serve"])
    spec["stop"] = spec["out"] + ".stop"
    procs = _launch(spec)
    port_file = Path(spec["out"] + ".port")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not port_file.exists():
        if any(p.poll() is not None for p in procs):
            break
        assert time.monotonic() < deadline, "replica never came up"
        time.sleep(0.05)
    ok = port_file.exists()
    try:
        yield ("127.0.0.1", int(port_file.read_text())) if ok else None
    finally:
        Path(spec["stop"]).touch()
        outs = _collect(spec, procs)
        assert outs[0]["serve"] == {"served": True}
    assert ok


def _get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("GET", path)
    body = json.loads(conn.getresponse().read())
    conn.close()
    return body


def _stream(host, port, prompt, max_tokens=6, timeout=120):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request(
        "POST", "/v1/completions",
        json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                    "stream": True}).encode(),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    toks, done = [], False
    while True:
        line = resp.fp.readline()
        if not line:
            break
        if line == b"data: [DONE]\n":
            done = True
            break
        if line.startswith(b"data:"):
            body = json.loads(line[5:])
            assert "error" not in body, body
            toks.append(body["token"])
    conn.close()
    assert done, "stream ended without [DONE]"
    return toks


def _reference(ref, prompt, max_tokens):
    e = _legacy(ref)
    rid = e.submit(prompt, max_new_tokens=max_tokens)
    return e.run()[rid]


class TestStatsMesh:
    def test_mesh_block_present_only_for_mesh_replicas(self, ref, replica):
        stats = _get(*replica, "/stats")
        assert stats["mesh"] == {"tp": 2}
        assert "kv_pool" in stats
        srv = TS.InferenceServer(_one_rank_legacy(ref), port=0,
                                 drain_s=0.5).start()
        try:
            assert "mesh" not in _get(srv.host, srv.port, "/stats")
        finally:
            srv.stop()


class TestGatewayWithMeshReplica:
    def test_gateway_streams_through_tp_replica_unchanged(self, ref,
                                                          replica):
        gw = ServingGateway([f"{replica[0]}:{replica[1]}"], port=0,
                            block_size=BS, health_interval_s=30.0).start()
        gw.probe_once()
        try:
            prompt = [5] + list(range(2, 21))
            toks = _stream(gw.host, gw.port, prompt)
            cfg, params = ref["models"]["tiny-bf16"]
            _tokens_match([_reference(ref, prompt, 6)], [toks], [prompt],
                          params, cfg)
            assert all(rep["healthy"]
                       for rep in gw.stats()["replicas"].values())
        finally:
            gw.stop()

    def test_peer_chain_fetch_into_tp_replica(self, ref, replica):
        """The fleet KV tier through a mesh: the replica imports a JAX
        one-device peer's /kv/chain payload instead of re-prefilling, and
        the chain re-exports from its head-sharded pool byte for byte."""
        before = _get(*replica, "/stats")["kv_handoff"]
        peer = JServer(_legacy(ref), port=0, drain_s=0.5).start()
        eps = [f"{replica[0]}:{replica[1]}", f"{peer.host}:{peer.port}"]
        gw = ServingGateway(eps, port=0, block_size=BS,
                            health_interval_s=30.0, kv_peer_fanout=2).start()
        gw.probe_once()
        try:
            prompt = None
            # A suffix no other test of this replica sent.
            for nonce in range(3, 250):
                cand = [nonce] + list(range(30, 49))
                # The router learns a prompt's chain at its first key: the
                # request's own key is the second call's.
                gw._route_key(cand)
                routed = gw._candidates(gw._route_key(cand))
                if routed and routed[0] == eps[0]:
                    prompt = cand
                    break
            assert prompt is not None, "no prompt routed to the replica"
            conn = http.client.HTTPConnection(peer.host, peer.port,
                                              timeout=60)
            conn.request(
                "POST", "/v1/completions",
                json.dumps({"prompt": prompt, "max_tokens": 2}).encode(),
                {"Content-Type": "application/json"})
            assert conn.getresponse().status == 200
            conn.close()
            toks = _stream(gw.host, gw.port, prompt)
            cfg, params = ref["models"]["tiny-bf16"]
            _tokens_match([_reference(ref, prompt, 6)], [toks], [prompt],
                          params, cfg)
            stats = gw.stats()
            assert stats["kv_peer_fetches"] == 1
            assert stats["kv_peer_fetch_failures"] == 0
            after = _get(*replica, "/stats")["kv_handoff"]
            assert after["chain_imports"] == before["chain_imports"] + 1
            keys = [k.hex() for k in prompt_chain_keys(prompt, BS)]
            conn = http.client.HTTPConnection(*replica, timeout=60)
            conn.request("POST", "/kv/chain",
                         json.dumps({"keys": keys}).encode(),
                         {"Content-Type": "application/json"})
            from_tp = json.loads(conn.getresponse().read())["payload"]
            conn.close()
            from_peer = peer.engine.export_chain(
                prompt_chain_keys(prompt, BS))
            assert [b["data"] for b in from_tp["blocks"]] \
                == [b["data"] for b in from_peer["blocks"]]
        finally:
            gw.stop()
            peer.stop()


# ---------------------------------------------------------------------------
# The entry point


def _post(port, prompt, max_tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt": prompt,
                             "max_tokens": max_tokens}).encode(),
                 {"Content-Type": "application/json"})
    body = json.loads(conn.getresponse().read())
    conn.close()
    return body["choices"][0]["tokens"]


def _serve_http(tp, extra=()):
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           TS.KUBEFLOW_TPU_SERVING_TP: str(tp)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.examples.serve_http",
         "--device", "cpu", "--config", "tiny", "--port", "0", "--paged",
         "--num-blocks", "64", "--prompt-bucket", "16", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines = []
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("serving "):
            port = int(line.split("http://127.0.0.1:")[1].split()[0])
            return proc, port, lines
    proc.kill()
    raise AssertionError(f"serve_http never served: {lines} "
                         f"{proc.stderr.read()[-2000:]}")


def _children(pid: int) -> list:
    out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(pid)],
                         capture_output=True, text=True).stdout
    return [int(p) for p in out.split()]


def test_serve_http_tp2_serves_the_one_rank_tokens_and_stops_every_rank():
    prompts = [[5, 9, 17, 33], [3, 41, 90, 7, 8]]
    one, port, _ = _serve_http(1)
    try:
        want = [_post(port, p, 4) for p in prompts]
    finally:
        one.send_signal(signal.SIGTERM)
        one.communicate(timeout=60)
    proc, port, lines = _serve_http(2)
    try:
        assert any(line.startswith("tensor-parallel replica: tp=2")
                   for line in lines), lines
        followers = _children(proc.pid)
        assert len(followers) == 1
        got = [_post(port, p, 4) for p in prompts]
        assert _get("127.0.0.1", port, "/stats")["mesh"] == {"tp": 2}
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)
    # The same random init (seed 0) on one rank: where the psum order
    # forks a bf16 tie (prompt 0's third token ties to the bit under this
    # init), the replica's tokens are held to greedy consistency.
    cfg = TL.LLAMA_CONFIGS["tiny"]
    model = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    forked = 0
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        forked += 1
        with torch.no_grad():
            logits = TL.forward(model, cfg, torch.tensor([p + a]))[0]
        for j, tok in enumerate(a):
            row = logits[len(p) - 1 + j]
            assert float(row.max() - row[tok]) < NEAR_TIE, (p, j, tok)
    assert forked <= 1
    assert proc.returncode == 0
    for pid in followers:
        assert not Path(f"/proc/{pid}").exists() or \
            "zombie" in Path(f"/proc/{pid}/status").read_text().lower()


def test_serve_http_refuses_a_degree_the_model_or_host_cannot_take():
    env = {**os.environ, TS.KUBEFLOW_TPU_SERVING_TP: "3"}
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.examples.serve_http",
         "--device", "cpu", "--config", "tiny"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    with pytest.raises(ValueError) as want:
        JT.validate_serving_tp(L.LLAMA_CONFIGS["tiny"], 3)
    assert str(want.value) in out.stderr


class TestQuantizedWeightsUnderAPlan:
    """JAX cannot shard quantized weights (``device_put`` of the
    ``(L, 1, out)`` scale of wo); the port refuses them with ValueError
    before any weight is placed."""

    def test_jax_raises_on_the_same_tree(self, ref):
        from kubeflow_tpu.models.quant import quantize_params

        cfg, params = ref["models"]["tiny-bf16"]
        with pytest.raises(ValueError):
            JP.PagedBatcher(quantize_params(params), cfg, gen=_gen(4),
                            slots=2, num_blocks=8, block_size=BS,
                            prompt_bucket=16,
                            plan=JT.serving_plan(2, cfg=cfg))

    @pytest.mark.parametrize("bits", [8, 4, "fp8"])
    def test_port_refuses_before_placing_a_weight(self, bits):
        from kubeflow_tpu_torch.models.quant import quantize_params

        cfg = TL.LLAMA_CONFIGS["tiny"]
        params = quantize_params(
            TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
            bits=bits, **({"group": 32} if bits == 4 else {}))
        before = {n: p.clone() for n, p in params.state_dict().items()}
        plan = TM.MeshPlan(TM.make_mesh(tp=2, devices=[0, 1]))
        with pytest.raises(ValueError, match="cannot be sharded"):
            plan.shard_params(params)
        with pytest.raises(ValueError, match="cannot be sharded"):
            TP.PagedBatcher(params, cfg, slots=2, num_blocks=8,
                            block_size=BS, prompt_bucket=16, plan=plan,
                            device="cpu")
        after = params.state_dict()
        assert set(after) == set(before)
        assert all(torch.equal(after[n], before[n]) for n in before)


@pytest.mark.parametrize("argv", [[], ["--paged"],
                                  ["--speculative", "1", "--paged"]],
                         ids=["continuous", "paged", "speculative"])
def test_serve_batched_tp2_matches_one_rank(argv):
    """``serve_batched --tp 2`` on the CPU runs one gloo replica of two
    processes through the continuous, paged and speculative paths and
    prints the one-rank run's tokens (tiny, seed 0: no near-tie forks
    these three prompts' six tokens)."""
    def run(extra):
        out = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.examples.serve_batched",
             "--device", "cpu", "--max-new-tokens", "6", *argv, *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_TIMEOUT,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr[-3000:]
        return [line for line in out.stdout.splitlines()
                if line.startswith("[")]

    one = run([])
    assert len(one) == 3
    assert run(["--tp", "2"]) == one


def test_shard_params_of_the_bridge_tree_matches_the_module(ref):
    """``shard_params`` on the bridge's numpy tree (JAX's stacked layout)
    builds the same rank-0 shard as on a ``Llama``, leaf for leaf, with
    the whole config and the shard record; the module's is sharded in
    place."""
    cfg, params = ref["models"]["tiny-f32"]
    tcfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    tree = jax.tree.map(np.asarray, params)
    plan = TM.MeshPlan(TM.make_mesh(tp=2, devices=[0, 1]))
    whole = params_from_jax(tree, tcfg, device="cpu")
    wq = whole.layers[0].wq.clone()
    from_module = plan.shard_params(whole)
    from_tree = plan.shard_params(tree, cfg=tcfg, device="cpu")
    assert from_module is whole and from_tree.cfg == tcfg
    assert torch.equal(whole.layers[0].wq, wq[:, :64])
    got = dict(from_tree.named_parameters())
    for name, p in from_module.named_parameters():
        assert torch.equal(got[name], p), name
    assert from_tree.shard.vocab_local == from_module.shard.vocab_local \
        == cfg.vocab_size // 2
    init = TL.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                          plan=plan)
    sharded = plan.shard_params(
        TL.init_params(tcfg, torch.Generator().manual_seed(0), "cpu"))
    assert all(torch.equal(a, b) for a, b in zip(init.parameters(),
                                                 sharded.parameters()))


@pytest.mark.parametrize("engine", ["paged", "continuous", "draft"])
def test_engines_take_a_shard_and_never_cut_the_callers_model(engine):
    """Under a plan an engine takes the rank's shard (``init_params(plan=)``,
    ``load_hf_checkpoint(plan=)`` or ``MeshPlan.shard_params``). Whole
    weights, a speculative engine's whole draft included, raise a
    ValueError naming those three, and the caller's model is left whole."""
    from kubeflow_tpu_torch.models import continuous as TCo
    from kubeflow_tpu_torch.models import speculative as TSp

    cfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny"], dtype=torch.float32)
    plan = TM.MeshPlan(TM.make_mesh())
    whole = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wq = whole.layers[0].wq.clone()
    kw = dict(gen=_gen(4), slots=2, prompt_bucket=16, plan=plan,
              device="cpu")
    with pytest.raises(ValueError, match="shard_params") as err:
        if engine == "paged":
            TP.PagedBatcher(whole, cfg, num_blocks=16, block_size=BS, **kw)
        elif engine == "continuous":
            TCo.ContinuousBatcher(whole, cfg, cache_len=64, **kw)
        else:
            shard = TL.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu", plan=plan)
            dcfg = dataclasses.replace(cfg, n_layers=1)
            TSp.SpeculativePagedBatcher(shard, cfg, whole, dcfg,
                                        num_blocks=40, **kw)
    assert "got whole weights" in str(err.value)
    assert whole.shard is None and torch.equal(whole.layers[0].wq, wq)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("family", ["llama-gqa", "qwen2"])
def test_load_hf_checkpoint_under_a_plan_reads_the_rank_shard(
        tmp_path, monkeypatch, family, rank):
    """``load_hf_checkpoint(plan=)`` cuts each tensor to the rank's slice
    as it reads it: leaf for leaf the ``shard_params`` of the whole load
    (f32 and bf16 alike bit-equal), with the whole config and the shard
    record, for either rank of tp=2 (qwen2: the qkv biases too)."""
    import transformers

    from kubeflow_tpu_torch.models import convert as TCv

    extra = (dict(num_key_value_heads=2) if family == "llama-gqa" else
             dict(num_key_value_heads=2, use_sliding_window=False,
                  tie_word_embeddings=False))
    cls = "Llama" if family == "llama-gqa" else "Qwen2"
    hf_cfg = getattr(transformers, f"{cls}Config")(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=128, **extra)
    torch.manual_seed(0)
    model = getattr(transformers, f"{cls}ForCausalLM")(hf_cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("_proj.bias"):
                p.copy_(torch.randn_like(p))
    model.save_pretrained(tmp_path, safe_serialization=True)
    plan = TM.MeshPlan(TM.make_mesh(tp=2, devices=[0, 1]))
    # This process plays the rank asked for in a world of two.
    monkeypatch.setattr(TM, "_world", lambda: (2, rank))
    cfg, got = TCv.load_hf_checkpoint(tmp_path, device="cpu", plan=plan)
    _, whole = TCv.load_hf_checkpoint(tmp_path, device="cpu")
    want = plan.shard_params(whole)
    assert got.cfg == cfg == want.cfg and got.shard.size == 2
    assert got.shard.vocab_lo == rank * 128 == want.shard.vocab_lo
    assert got.layers[0].wq.shape == (64, 32)
    wanted = dict(want.named_parameters())
    for name, p in got.named_parameters():
        assert p.shape == wanted[name].shape, name
        assert torch.equal(p, wanted[name]), name


def test_serve_batched_tp2_serves_a_checkpoint_from_its_shards(tmp_path):
    """``serve_batched --checkpoint D --tp 2`` loads each rank's shard of
    the checkpoint as it reads it (``load_hf_checkpoint(plan=)``) and
    prints the one-rank run's tokens on the paged engine (this bf16
    checkpoint, three prompts, six tokens each: no near-tie forks)."""
    from tests.test_torch_serve_checkpoint import save_tiny_checkpoint

    ckpt = save_tiny_checkpoint(tmp_path / "ckpt", tokenizer=False)

    def run(extra):
        out = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.examples.serve_batched",
             "--device", "cpu", "--checkpoint", str(ckpt), "--paged",
             "--max-new-tokens", "6", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=SPAWN_TIMEOUT,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
        assert out.returncode == 0, out.stderr[-3000:]
        return [line for line in out.stdout.splitlines()
                if line.startswith("[")]

    one = run([])
    assert len(one) == 3
    assert run(["--tp", "2"]) == one
