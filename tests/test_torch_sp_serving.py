"""Sequence-parallel serving: the port's ``ContinuousBatcher`` under an sp
plan (its cache cut over the sequence, the split-KV decode) over gloo
ranks vs the JAX package's under a plan of the same mesh over its forced
CPU devices, and ``serve_batched --sp 2`` vs JAX's entry point.

The port runs as a group of 2 gloo processes (sp = 2) and one of 4 (sp =
2 × tp = 2), ``tests/torch_sp_worker.py``, spawned at once for the
module; every rank makes the same engine calls. Weights are JAX's f32
``tiny-gqa`` (4 q / 2 kv heads) through the bridge; 3 prompts of 5..13
tokens are served by 2 slots (the third admitted when a slot frees), 12
new tokens each, over a cache of 32 positions (16 a rank), the
model-dtype cache and an int8 one (``kv_bits=8``).

What is held: every rank's tokens equal JAX's and its logprobs are
within 1e-4, and a rank's cache holds its half of the sequence (and
under tp its kv head). ``serve_batched --checkpoint D --sp 2`` prints the
token lines JAX's ``examples/serve_batched.py --checkpoint D --sp 2``
prints (f32 weights), and the refusals keep JAX's messages.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import continuous as JC
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu_torch.models import continuous as TC
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models.bridge import params_from_jax
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from kubeflow_tpu_torch.parallel import mesh as TM
from tests.torch_sp_harness import ROOT, SPAWN_TIMEOUT, collect, launch

MAX_NEW, SLOTS, CACHE_LEN, BUCKET = 12, 2, 32, 16


def _serve(axes, kv_bits):
    return dict(axes=axes, kv_bits=kv_bits, max_new=MAX_NEW, slots=SLOTS,
                cache_len=CACHE_LEN, bucket=BUCKET)


CASES = {
    2: {"sp2": _serve(dict(sp=2), 0), "sp2-int8": _serve(dict(sp=2), 8)},
    4: {"sp2tp2": _serve(dict(sp=2, tp=2), 0),
        "sp2tp2-int8": _serve(dict(sp=2, tp=2), 8)},
}


def _cfgs():
    return (dataclasses.replace(L.LLAMA_CONFIGS["tiny-gqa"],
                                dtype=jnp.float32),
            dataclasses.replace(TL.LLAMA_CONFIGS["tiny-gqa"],
                                dtype=torch.float32))


def _prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(3, 256, size=n).tolist() for n in (5, 9, 13)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp-serving")
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, L.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))
    weights = tmp / "weights.pt"
    torch.save(params_from_jax(tree, tcfg, device="cpu").state_dict(),
               weights)
    started = {world: launch(tmp, f"w{world}", world, ["serve"],
                             {"prompts": _prompts()}, model="tiny-gqa",
                             weights=str(weights), serve_cases=CASES[world])
               for world in (2, 4)}
    return {"tree": tree,
            "ranks": {w: collect(*run) for w, run in started.items()}}


@pytest.mark.parametrize("world,name", [
    (w, n) for w in (2, 4) for n in CASES[w]])
def test_sp_continuous_batcher_matches_jax(ref, world, name):
    case = CASES[world][name]
    jcfg, _ = _cfgs()
    n = int(np.prod(list(case["axes"].values())))
    plan = JM.MeshPlan(JM.make_mesh(**case["axes"],
                                    devices=jax.devices()[:n]))
    jcb = JC.ContinuousBatcher(
        jax.tree.map(jnp.asarray, ref["tree"]), jcfg,
        gen=JGen(max_new_tokens=MAX_NEW, eos_id=-1), slots=SLOTS,
        cache_len=CACHE_LEN, prompt_bucket=BUCKET, plan=plan,
        kv_bits=case["kv_bits"])
    rids = [jcb.submit(p) for p in _prompts()]
    toks, lps = jcb.run(), jcb.run_logprobs()
    tp = case["axes"].get("tp", 1)
    for r in ref["ranks"][world]:
        got = r["serve"][name]
        assert got["tokens"] == [toks[i] for i in rids], r["rank"]
        for g, i in zip(got["logprobs"], rids):
            np.testing.assert_allclose(g, lps[i], rtol=0, atol=1e-4)
        assert got["cache_shape"] == [jcfg.n_layers, SLOTS,
                                      jcfg.n_kv_heads // tp,
                                      CACHE_LEN // 2, jcfg.head_dim]


def test_sp_constructor_refusals_keep_the_jax_messages():
    """``cache_len`` must divide by sp, with JAX's message; the dense
    decode kernel does not run under sp (explicit ``attn_kernel=True`` is
    JAX's plan refusal), and chunked admission is refused under any plan,
    as JAX refuses it."""
    jcfg, tcfg = _cfgs()
    jparams = L.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    jplan = JM.MeshPlan(JM.make_mesh(sp=2, devices=jax.devices()[:2]))
    tplan = TM.MeshPlan(TM.make_mesh(sp=2, devices=[0, 1]))
    kw = dict(slots=2, cache_len=33, prompt_bucket=16)
    with pytest.raises(ValueError) as want:
        JC.ContinuousBatcher(jparams, jcfg, gen=JGen(max_new_tokens=8),
                             plan=jplan, **kw)
    with pytest.raises(ValueError) as got:
        TC.ContinuousBatcher(tplan.shard_params(copy.deepcopy(tparams)),
                             tcfg, gen=TGen(max_new_tokens=8), plan=tplan,
                             device="cpu", **kw)
    assert str(got.value) == str(want.value)
    kw["cache_len"] = 32
    for extra in (dict(attn_kernel=True), dict(admit_chunk=8)):
        with pytest.raises(ValueError) as want:
            JC.ContinuousBatcher(jparams, jcfg, gen=JGen(max_new_tokens=8),
                                 plan=jplan, **kw, **extra)
        with pytest.raises(ValueError) as got:
            TC.ContinuousBatcher(
                tplan.shard_params(copy.deepcopy(tparams)), tcfg,
                gen=TGen(max_new_tokens=8), plan=tplan, device="cpu", **kw,
                **extra)
        assert str(got.value) == str(want.value)


def test_serve_batched_sp2_prints_what_jax_prints(monkeypatch, capsys,
                                                  tmp_path):
    """``serve_batched --checkpoint D --sp 2`` on the CPU (a gloo replica of
    two processes, the cache length rounded to a multiple of sp) prints
    JAX's token lines for the same checkpoint (f32, JAX's loader patched
    to keep it f32, as tests/test_torch_serve_checkpoint.py does)."""
    from tests.test_torch_serve_checkpoint import (
        _f32_loaders,
        _jax_example,
        save_tiny_checkpoint,
    )

    ckpt = save_tiny_checkpoint(tmp_path / "ckpt", tokenizer=False)
    _f32_loaders(monkeypatch)
    monkeypatch.delenv("KUBEFLOW_TPU_QUANT", raising=False)
    args = ["--checkpoint", str(ckpt), "--max-new-tokens", "6", "--sp", "2"]
    monkeypatch.setattr(sys, "argv", ["serve_batched.py"] + args)
    _jax_example("serve_batched").main()
    want = [re.sub(r"np\.int\d+\((-?\d+)\)", r"\1", x)
            for x in capsys.readouterr().out.splitlines()]
    env = {k: v for k, v in os.environ.items() if k != "KUBEFLOW_TPU_QUANT"}
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.examples.serve_batched",
         "--device", "cpu", *args], cwd=ROOT, capture_output=True, text=True,
        timeout=SPAWN_TIMEOUT, env={**env, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = out.stdout.splitlines()
    assert "sharded serving: tp=1 sp=2 over 2 devices" in got
    assert [x for x in got if x.startswith("[")] == [
        x for x in want if x.startswith("[")]
    assert len([x for x in got if x.startswith("[")]) == 3


def test_shard_kv_cache_cuts_the_sequence_over_sp_with_jax_rule():
    """``shard_kv_cache(seq_over_sp=True)``: this rank's kv heads (axis 2,
    over tp) and positions (axis 3, over sp) of a dense cache, int8 scale
    leaves alike, as JAX places rank 0's device shard."""
    jcfg, tcfg = _cfgs()
    jcache = L.init_kv_cache(jcfg, 2, 32, kv_bits=8)
    cache = TL.init_kv_cache(tcfg, 2, 32, kv_bits=8, device="cpu")
    for name, leaf in cache.items():
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    jplan = JM.MeshPlan(JM.make_mesh(sp=2, tp=2, devices=jax.devices()[:4]))
    placed = jplan.shard_kv_cache(jcache, seq_over_sp=True)
    got = TM.MeshPlan(TM.make_mesh(sp=2, tp=2, devices=[0, 1, 2, 3])) \
        .shard_kv_cache(cache, seq_over_sp=True)
    for name, leaf in cache.items():
        shard = next(s for s in placed[name].addressable_shards
                     if s.device == jax.devices()[0])
        assert torch.equal(got[name], leaf[shard.index]), name
        assert tuple(got[name].shape[2:4]) == (1, 16), name
