"""Serving under a dp or fsdp mesh: the port over gloo ranks vs JAX's
engines under the same ``MeshPlan`` on its forced CPU devices.

JAX takes such a mesh through GSPMD: the weights are cut over fsdp (and
tp) and gathered at use, the pool is cut over tp alone, and the step is
replicated over dp and fsdp (its engines never place their batch with
``batch_sharding``). The port does the same on a replica of gloo ranks:
every rank runs the engine on its shard, and the forward gathers each
fsdp-cut leaf where it is used.

The JAX reference runs in this process (``make_mesh(..., devices=
jax.devices()[:n])``, the 8 CPU devices conftest forces). The port runs
as one group of 2 gloo processes (meshes fsdp=2 and dp=2) and one of 4
(dp=2 x tp=2), both at once, through ``tests/torch_tp_worker.py``'s
``mesh`` scenario. The weights are JAX's f32 ``tiny-gqa``
(``init_params(cfg, PRNGKey(0))``) through the bridge.

What is held, on every mesh:

- the ragged engine (whole prompts, and chunks under a budget of 4), the
  alternating engine and the continuous engine give JAX's tokens under
  the same mesh, with logprobs within 1e-4, on every rank; the ragged
  speculative engine gives JAX's tokens;
- the engine's ``mesh_axes`` (``/stats``' ``mesh`` block) is the plan's
  axes, and its pool holds the tp rank's kv heads, whole over dp and
  fsdp;
- a rank's weight bytes are its pieces' under JAX's ``param_spec`` (an
  fsdp=2 rank holds half of each leaf fsdp cuts);
- the bridge's numpy tree cut by ``MeshPlan.shard_params`` is the model's
  own cut, leaf for leaf;
- ``load_hf_checkpoint(plan=)`` gives each leaf the whole load's slice.

And an fsdp=2 or a dp=2 replica served from its first rank through
``TPReplica`` behind the port's own gateway streams JAX's one-device
tokens, and its ``/stats`` reports the mesh (``{"fsdp": 2}``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
import urllib.request
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
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu.parallel import mesh as JM
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models.bridge import params_from_jax
from kubeflow_tpu_torch.models.convert import params_to_hf_state_dict
from kubeflow_tpu_torch.models.gateway import ServingGateway
from kubeflow_tpu_torch.parallel import mesh as TM
from tests.test_torch_tp_serving import _collect, _free_port, _launch

BS = 8
PROMPTS = [[5, 9, 17], [3, 41, 90, 7], [11] * 9]
MAX_NEW = 4
MODEL = "tiny-gqa"
MESHES = {2: [{"fsdp": 2}, {"dp": 2}], 4: [{"dp": 2, "tp": 2}]}
ALL = [m for ms in MESHES.values() for m in ms]
SERVE_PROMPTS = [[5, 9, 17, 33, 2, 11, 44, 3, 8, 21], [3, 41, 90, 7]]


def _tag(axes: dict) -> str:
    return "x".join(f"{k}{v}" for k, v in axes.items())


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write_hf(cfg, model, path: Path) -> None:
    """An HF llama checkpoint of ``model`` in two safetensors shards."""
    from safetensors.torch import save_file

    path.mkdir()
    sd = {k: v.contiguous()
          for k, v in params_to_hf_state_dict(cfg, model).items()}
    keys = sorted(sd)
    for i, part in enumerate((keys[:len(keys) // 2],
                              keys[len(keys) // 2:])):
        save_file({k: sd[k] for k in part},
                  path / f"model-0000{i + 1}-of-00002.safetensors")
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.dim, "intermediate_size": cfg.ffn_hidden,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len,
        "tie_word_embeddings": False}))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's f32 ``tiny-gqa`` and ``tiny``, the state dicts the ranks
    load, and an HF checkpoint of ``tiny-gqa``."""
    tmp = tmp_path_factory.mktemp("mesh")
    models, weights = {}, {}
    for name in (MODEL, "tiny"):
        cfg = dataclasses.replace(L.LLAMA_CONFIGS[name], dtype=jnp.float32)
        params = L.init_params(cfg, jax.random.PRNGKey(0))
        tcfg = dataclasses.replace(TL.LLAMA_CONFIGS[name],
                                   dtype=torch.float32)
        port = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                               device="cpu")
        weights[f"{name}-f32"] = str(tmp / f"{name}.pt")
        torch.save(port.state_dict(), weights[f"{name}-f32"])
        models[name] = (cfg, params, tcfg, port)
    _write_hf(models[MODEL][2], models[MODEL][3], tmp / "hf")
    return {"tmp": tmp, "models": models, "weights": weights,
            "hf": str(tmp / "hf")}


def _spec(ref, world, scenarios, **extra):
    out = ref["tmp"] / f"out-{world}-{'-'.join(scenarios)}"
    return {"world": world, "port": _free_port(), "scenarios": scenarios,
            "weights": ref["weights"], "prompts": PROMPTS,
            "max_new": MAX_NEW, "out": str(out), "hf": ref["hf"], **extra}


@pytest.fixture(scope="module")
def ranks(ref):
    """{mesh tag: [each rank's ``mesh`` scenario output]}: both groups
    spawned at once."""
    specs = [_spec(ref, world, ["mesh"], meshes=meshes)
             for world, meshes in MESHES.items()]
    procs = [_launch(spec) for spec in specs]
    out = {}
    for spec, group in zip(specs, procs):
        for rank in _collect(spec, group):
            for tag, res in rank["mesh"].items():
                out.setdefault(tag, []).append(res)
    return out


# ---------------------------------------------------------------------------
# The JAX reference


def _gen(n):
    return JGen(max_new_tokens=n, eos_id=-1)


def _run(engine, prompts):
    rids = [engine.submit(p) for p in prompts]
    out = engine.run()
    lps = getattr(engine, "run_logprobs", dict)()
    return [out[r] for r in rids], [lps.get(r, []) for r in rids]


def _jax_plan(axes: dict):
    n = math.prod(axes.values())
    return JM.MeshPlan(JM.make_mesh(**axes, devices=jax.devices()[:n]))


def _jax_engine(ref, axes, engine):
    cfg, params, _, _ = ref["models"][MODEL]
    plan = _jax_plan(axes)
    if engine in ("ragged", "chunks"):
        return JP.PagedBatcher(
            params, cfg, gen=_gen(MAX_NEW), slots=2, num_blocks=24,
            block_size=BS, prompt_bucket=16, ragged=True, attn_kernel=False,
            plan=plan, **({"token_budget": 4} if engine == "chunks" else {}))
    if engine == "alternating":
        return JP.PagedBatcher(
            params, cfg, gen=_gen(MAX_NEW), slots=2, num_blocks=24,
            block_size=BS, prompt_bucket=16, attn_kernel=False, plan=plan)
    if engine == "continuous":
        return JC.ContinuousBatcher(
            params, cfg, gen=_gen(MAX_NEW), slots=2, cache_len=64,
            prompt_bucket=16, plan=plan)
    assert engine == "spec"
    dparams, dcfg = JS.truncated_draft(params, cfg, 1)
    return JS.SpeculativePagedBatcher(
        params, cfg, dparams, dcfg, gen=_gen(MAX_NEW), slots=2,
        num_blocks=40, block_size=BS, prompt_bucket=16, k_spec=3,
        ragged=True, token_budget=16, plan=plan)


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", ALL, ids=_tag)
@pytest.mark.parametrize("engine",
                         ["ragged", "chunks", "alternating", "continuous"])
def test_engine_tokens_and_logprobs_match_jax_under_the_mesh(ref, ranks,
                                                             axes, engine):
    want, want_lps = _run(_jax_engine(ref, axes, engine), PROMPTS)
    for rank in ranks[_tag(axes)]:
        got, got_lps = rank[engine]
        assert got == want
        for a, b in zip(got_lps, want_lps):
            np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("axes", ALL, ids=_tag)
def test_speculative_engine_tokens_match_jax_under_the_mesh(ref, ranks,
                                                            axes):
    want = _run(_jax_engine(ref, axes, "spec"), PROMPTS)[0]
    for rank in ranks[_tag(axes)]:
        assert rank["spec"] == want


@pytest.mark.parametrize("axes", ALL, ids=_tag)
def test_stats_mesh_and_the_pool_whole_over_dp_and_fsdp(ref, ranks, axes):
    cfg = ref["models"][MODEL][2]
    jax_eng = _jax_engine(ref, axes, "alternating")
    tp = axes.get("tp", 1)
    for rank in ranks[_tag(axes)]:
        assert rank["mesh_axes"] == rank["engine_mesh"] == axes
        assert rank["engine_mesh"] == jax_eng.mesh_axes
        shape = rank["pool_shape"]["k"]
        assert shape[2] == cfg.n_kv_heads // tp
        # JAX's per-device shard of the pool: cut over tp alone.
        jshard = jax_eng.pool["k"].addressable_shards[0].data.shape
        assert shape[1:] == list(jshard)[1:]


@pytest.mark.parametrize("axes", ALL, ids=_tag)
def test_a_rank_holds_its_pieces_of_the_weights(ref, ranks, axes):
    """An fsdp=2 rank holds half of every leaf fsdp cuts; a dp rank the
    whole model; the pieces are JAX's ``param_spec`` shards."""
    _, jparams, tcfg, port = ref["models"][MODEL]
    n = math.prod(axes.values())
    plan = TM.MeshPlan(TM.make_mesh(**axes, devices=list(range(n))))
    jplan = _jax_plan(axes)
    want = 0
    for name, p in port.named_parameters():
        pl = plan.placement(name, tuple(p.shape))
        want += math.prod(pl.local_shape) * p.element_size()
    # JAX's first device holds the same bytes of the stacked tree.
    placed = jplan.shard_params(jparams)
    jax_bytes = sum(leaf.addressable_shards[0].data.nbytes
                    for leaf in jax.tree.leaves(placed))
    whole = sum(p.numel() * p.element_size() for p in port.parameters())
    for rank in ranks[_tag(axes)]:
        assert rank["weight_bytes"] == want == jax_bytes
    if axes.get("fsdp"):
        norms = sum(p.numel() * p.element_size()
                    for name, p in port.named_parameters()
                    if "norm" in name)
        assert want == (whole - norms) // 2 + norms
    if axes == {"dp": 2}:
        assert want == whole


@pytest.mark.parametrize("axes", ALL, ids=_tag)
def test_the_numpy_tree_cut_is_the_model_cut(ranks, axes):
    for rank in ranks[_tag(axes)]:
        assert rank["tree_cut"] is True


@pytest.mark.parametrize("axes", ALL, ids=_tag)
def test_hf_checkpoint_under_the_plan_leaf_by_leaf(ref, ranks, axes):
    tcfg = ref["models"][MODEL][2]
    for rank in ranks[_tag(axes)]:
        leaves = rank["hf_leaves"]
        assert len(leaves) == len(dict(ref["models"][MODEL][3]
                                       .named_parameters()))
        assert all(same for same, _, _ in leaves.values()), leaves
        local, whole = leaves["embed"][1:]
        assert whole == [tcfg.vocab_size, tcfg.dim]
        assert local == [tcfg.vocab_size // axes.get("tp", 1),
                         tcfg.dim // axes.get("fsdp", 1)]
        local, whole = leaves["layers.0.w_down"][1:]
        assert local == [whole[0] // axes.get("tp", 1),
                         whole[1] // axes.get("fsdp", 1)]


def _post(gw, body):
    req = urllib.request.Request(
        f"http://{gw.host}:{gw.port}/v1/completions",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read().decode()
    if not body.get("stream"):
        return json.loads(raw)["choices"][0]["tokens"]
    events = [line[6:] for line in raw.splitlines()
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e)["token"] for e in events[:-1]]


@pytest.mark.parametrize("axis", ["fsdp", "dp"])
def test_mesh_replica_serves_behind_the_port_gateway(ref, axis):
    """An fsdp=2 or dp=2 replica of f32 ``tiny`` (the prefix-cache
    engine), served from its first rank through ``TPReplica`` while the
    other follows, behind the port's ``ServingGateway``: blocking and
    streamed tokens equal JAX's one-device engine's, and ``/stats``
    reports the mesh."""
    cfg, params, _, _ = ref["models"]["tiny"]
    jeng = JP.PagedBatcher(params, cfg, gen=_gen(8), slots=2,
                           num_blocks=32, block_size=BS, prompt_bucket=32,
                           prefix_cache=True)
    want = _run(jeng, SERVE_PROMPTS)[0]
    spec = _spec(ref, 2, ["serve"], mesh={axis: 2}, serve_dtype="f32",
                 out=str(ref["tmp"] / f"out-serve-{axis}"),
                 stop=str(ref["tmp"] / f"stop-{axis}"))
    procs = _launch(spec)
    port_file = Path(spec["out"] + ".port")
    gw = None
    try:
        deadline = time.monotonic() + 300
        while not port_file.exists():
            assert time.monotonic() < deadline, "the replica never came up"
            assert all(p.poll() is None for p in procs), [
                p.communicate()[1][-2000:] for p in procs]
            time.sleep(0.1)
        time.sleep(0.1)  # the port number's write has landed
        ep = f"127.0.0.1:{port_file.read_text().strip()}"
        gw = ServingGateway([ep], port=0, block_size=BS,
                            health_interval_s=0.2).start()
        got = [_post(gw, {"prompt": p, "max_tokens": 8, "stream": stream})
               for p in SERVE_PROMPTS for stream in (False, True)]
        assert got[0::2] == got[1::2] == want
        with urllib.request.urlopen(f"http://{ep}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["mesh"] == {axis: 2}
        gw.probe_once()
        assert gw.stats()["replicas"][ep]["healthy"] is True
    finally:
        if gw is not None:
            gw.stop()
        Path(spec["stop"]).write_text("")
        outs = _collect(spec, procs)
    assert outs[0]["serve"] == {"served": True}
    assert outs[1]["serve"] == {}
