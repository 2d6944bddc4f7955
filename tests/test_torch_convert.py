"""The port's Hugging Face loader (``models/convert.py``) against the JAX
package's, on the CPU.

The same tiny ``transformers`` models (seeded) go through both loaders.
Tolerances: configs equal field for field (the dtype apart); loaded
leaves bit-equal, f32 and bf16, through ``bridge.params_to_numpy``;
logits against ``transformers`` at the JAX test's own tolerance (2e-4
llama, 3e-4 mistral, gemma and qwen2) and against JAX's forward at 1e-5;
exports byte-equal; error messages equal as text. The loader also runs in
a subprocess that cannot import ``safetensors``, ``transformers`` or
``ml_dtypes``, as on a machine without them.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import transformers

from kubeflow_tpu.models import convert as JC
from kubeflow_tpu.models import llama as L
from kubeflow_tpu_torch.models import convert as TC
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models.bridge import params_to_numpy

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128, rope_theta=10000.0,
            attn_implementation="eager")

# Every family tests/test_convert.py covers: (name, config class, model
# class, extra config fields, the JAX test's logits tolerance).
FAMILIES = [
    ("llama-mha", "LlamaConfig", "LlamaForCausalLM",
     dict(num_key_value_heads=4), 2e-4),
    ("llama-gqa", "LlamaConfig", "LlamaForCausalLM",
     dict(num_key_value_heads=2), 2e-4),
    ("llama-tied", "LlamaConfig", "LlamaForCausalLM",
     dict(num_key_value_heads=4, tie_word_embeddings=True), 2e-4),
    ("llama3-rope", "LlamaConfig", "LlamaForCausalLM",
     dict(num_key_value_heads=2, max_position_embeddings=256,
          rope_scaling={"rope_type": "llama3", "factor": 4.0,
                        "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                        "original_max_position_embeddings": 64}), 3e-4),
    ("mistral", "MistralConfig", "MistralForCausalLM",
     dict(num_key_value_heads=2, sliding_window=8), 3e-4),
    ("gemma", "GemmaConfig", "GemmaForCausalLM",
     dict(num_key_value_heads=1, head_dim=32,
          hidden_activation="gelu_pytorch_tanh"), 3e-4),
    ("qwen2", "Qwen2Config", "Qwen2ForCausalLM",
     dict(num_key_value_heads=2, use_sliding_window=False,
          tie_word_embeddings=False), 3e-4),
]
FAMILY_IDS = [f[0] for f in FAMILIES]


def _hf(family):
    _, cfg_cls, model_cls, extra, _ = family
    hf_cfg = getattr(transformers, cfg_cls)(**{**BASE, **extra})
    torch.manual_seed(0)
    model = getattr(transformers, model_cls)(hf_cfg).eval()
    if family[0] == "qwen2":
        # HF starts biases at zero; real checkpoints do not.
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("_proj.bias"):
                    p.copy_(torch.randn_like(p) * 0.5)
    return hf_cfg, model


def _state(hf_cfg, model) -> dict:
    sd = dict(model.state_dict())
    if getattr(hf_cfg, "tie_word_embeddings", False):
        sd.pop("lm_head.weight", None)  # what save_pretrained does
    return sd


def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.pop("dtype")
    return out


def _jax_tree(params) -> dict:
    return jax.tree.map(np.asarray, params)


def _assert_same_leaves(tmodel, jtree) -> None:
    """Every leaf bit-equal, bf16 compared as its 16-bit words."""
    got = params_to_numpy(tmodel, like=jtree)
    flat = [(k, got[k], jtree[k]) for k in jtree if k != "layers"]
    flat += [(f"layers/{k}", got["layers"][k], v)
             for k, v in jtree["layers"].items()]
    assert set(got) == set(jtree)
    assert set(got["layers"]) == set(jtree["layers"])
    for name, a, b in flat:
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


CONFIG_DICTS = [
    {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
     "num_hidden_layers": 32, "num_attention_heads": 32,
     "num_key_value_heads": 8, "intermediate_size": 14336,
     "rope_theta": 500000.0, "max_position_embeddings": 8192,
     "rms_norm_eps": 1e-5, "tie_word_embeddings": False},
    {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
     "num_hidden_layers": 2, "num_attention_heads": 4,
     "intermediate_size": 128, "rope_scaling": {
         "type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
         "high_freq_factor": 4.0,
         "original_max_position_embeddings": 8192}},
    {"model_type": "llama", "vocab_size": 256, "hidden_size": 64,
     "num_hidden_layers": 2, "num_attention_heads": 4,
     "intermediate_size": 128, "rope_scaling": {"rope_type": "default"}},
    {"model_type": "qwen2", "vocab_size": 64, "hidden_size": 64,
     "num_hidden_layers": 4, "num_attention_heads": 4,
     "intermediate_size": 128, "sliding_window": 512,
     "use_sliding_window": True, "max_window_layers": 4},
    {"model_type": "qwen2", "vocab_size": 64, "hidden_size": 64,
     "num_hidden_layers": 4, "num_attention_heads": 4,
     "intermediate_size": 128, "sliding_window": 512,
     "use_sliding_window": True, "max_window_layers": 0},
    {"model_type": "qwen2", "vocab_size": 64, "hidden_size": 64,
     "num_hidden_layers": 4, "num_attention_heads": 4,
     "intermediate_size": 128, "sliding_window": 512},
    {"model_type": None, "vocab_size": 64, "hidden_size": 64,
     "num_hidden_layers": 1, "num_attention_heads": 2,
     "intermediate_size": 128, "hidden_act": "gelu"},
]


@pytest.mark.parametrize("family", FAMILIES, ids=FAMILY_IDS)
def test_config_from_hf_equals_jax_per_family(family):
    hf_cfg, _ = _hf(family)
    assert _fields(TC.config_from_hf(hf_cfg)) == _fields(
        JC.config_from_hf(hf_cfg))
    # config.json form: the same mapping from the dict.
    as_dict = hf_cfg.to_dict()
    assert _fields(TC.config_from_hf(as_dict)) == _fields(
        JC.config_from_hf(as_dict))
    assert TC.config_from_hf(as_dict).dtype == torch.bfloat16


@pytest.mark.parametrize("raw", CONFIG_DICTS, ids=range(len(CONFIG_DICTS)))
def test_config_from_hf_equals_jax_on_config_json(raw):
    assert _fields(TC.config_from_hf(raw)) == _fields(JC.config_from_hf(raw))


@pytest.mark.parametrize("raw", [
    {"model_type": "phi3", "num_attention_heads": 4, "hidden_size": 64},
    {"vocab_size": 256, "hidden_size": 64, "num_hidden_layers": 2,
     "num_attention_heads": 4, "intermediate_size": 128,
     "rope_scaling": {"rope_type": "yarn", "factor": 2.0}},
    {"model_type": "qwen2", "vocab_size": 64, "hidden_size": 64,
     "num_hidden_layers": 4, "num_attention_heads": 4,
     "intermediate_size": 128, "sliding_window": 512,
     "use_sliding_window": True, "max_window_layers": 2},
], ids=["model_type", "rope_scaling", "qwen2_window_split"])
def test_config_errors_equal_jax(raw):
    with pytest.raises(NotImplementedError) as jerr:
        JC.config_from_hf(raw)
    with pytest.raises(NotImplementedError) as terr:
        TC.config_from_hf(raw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("family", FAMILIES, ids=FAMILY_IDS)
def test_params_equal_jax_leaf_for_leaf(family):
    hf_cfg, model = _hf(family)
    sd = _state(hf_cfg, model)
    jtree = _jax_tree(JC.params_from_hf_state_dict(
        JC.config_from_hf(hf_cfg), sd, np.float32))
    tmodel = TC.params_from_hf_state_dict(TC.config_from_hf(hf_cfg), sd,
                                          torch.float32, device="cpu")
    assert tmodel.cfg.dtype == torch.float32
    assert (tmodel.lm_head is None) is bool(hf_cfg.tie_word_embeddings)
    _assert_same_leaves(tmodel, jtree)


@pytest.mark.parametrize("family", FAMILIES, ids=FAMILY_IDS)
def test_forward_matches_transformers_and_jax(family):
    hf_cfg, model = _hf(family)
    sd = _state(hf_cfg, model)
    tmodel = TC.params_from_hf_state_dict(TC.config_from_hf(hf_cfg), sd,
                                          torch.float32, device="cpu")
    jcfg = L.LlamaConfig(**{**JC.config_from_hf(hf_cfg).__dict__,
                            "dtype": np.float32})
    jparams = JC.params_from_hf_state_dict(jcfg, sd, np.float32)
    # Past the window and the rope-scaling regime where a family has one.
    seq = 96 if family[0] == "llama3-rope" else 32
    tokens = np.random.default_rng(3).integers(0, 256, (1, seq)).astype(
        np.int32)
    with torch.no_grad():
        ref = model(torch.from_numpy(tokens).long()).logits.numpy()
        ours = TL.forward(tmodel, tmodel.cfg,
                          torch.from_numpy(tokens).long()).numpy()
    tol = family[4]
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        ours, np.asarray(L.forward(jparams, jcfg, tokens)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES, ids=FAMILY_IDS)
def test_export_round_trips_byte_for_byte(family):
    hf_cfg, model = _hf(family)
    sd = _state(hf_cfg, model)
    cfg = TC.config_from_hf(hf_cfg)
    tmodel = TC.params_from_hf_state_dict(cfg, sd, torch.float32,
                                          device="cpu")
    exported = TC.params_to_hf_state_dict(tmodel.cfg, tmodel)
    # HF's names and layout: the source state dict, byte for byte.
    assert set(exported) == set(sd)
    for key, value in exported.items():
        assert value.shape == sd[key].shape, key
        assert value.contiguous().numpy().tobytes() == \
            sd[key].numpy().tobytes(), key
    # JAX's export of its own load holds the same values.
    jcfg = JC.config_from_hf(hf_cfg)
    jexp = JC.params_to_hf_state_dict(
        jcfg, JC.params_from_hf_state_dict(jcfg, sd, np.float32))
    assert set(jexp) == set(exported)
    for key, value in jexp.items():
        assert value.tobytes() == exported[key].contiguous().numpy().tobytes()
    # And back: the same model, leaf for leaf.
    again = TC.params_from_hf_state_dict(tmodel.cfg, exported, device="cpu")
    for (n, a), (_, b) in zip(tmodel.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_bf16_model_round_trips_and_loads_unprefixed_keys():
    hf_cfg, model = _hf(FAMILIES[1])
    cfg = TC.config_from_hf(hf_cfg)
    tmodel = TC.params_from_hf_state_dict(cfg, model.state_dict(),
                                          device="cpu")
    assert tmodel.embed.dtype == torch.bfloat16
    exported = TC.params_to_hf_state_dict(cfg, tmodel)
    assert all(v.dtype == torch.bfloat16 for v in exported.values())
    # The "model." prefix rule: keys without it load the same model.
    bare = {k.removeprefix("model."): v for k, v in exported.items()}
    again = TC.params_from_hf_state_dict(cfg, bare, device="cpu")
    for (n, a), (_, b) in zip(tmodel.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n


def test_missing_tensor_error_equals_jax():
    hf_cfg, model = _hf(FAMILIES[0])
    sd = dict(model.state_dict())
    del sd["model.layers.1.mlp.up_proj.weight"]
    del sd["model.norm.weight"]
    with pytest.raises(KeyError) as jerr:
        JC.params_from_hf_state_dict(JC.config_from_hf(hf_cfg), sd)
    with pytest.raises(KeyError) as terr:
        TC.params_from_hf_state_dict(TC.config_from_hf(hf_cfg), sd,
                                     device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "model.layers.1.mlp.up_proj.weight" in str(terr.value)


def test_wrong_shape_and_quantized_export_raise():
    hf_cfg, model = _hf(FAMILIES[1])
    cfg = TC.config_from_hf(hf_cfg)
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.k_proj.weight"] = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="k_proj.weight: got shape"):
        TC.params_from_hf_state_dict(cfg, sd, device="cpu")
    from kubeflow_tpu_torch.models.quant import quantize_params

    tmodel = TC.params_from_hf_state_dict(cfg, model.state_dict(),
                                          device="cpu")
    with pytest.raises(TypeError, match="no HF layout"):
        TC.params_to_hf_state_dict(cfg, quantize_params(tmodel))


def _save(tmp_path, family, dtype, shard_kb=60):
    hf_cfg, model = _hf(family)
    model.to(dtype).save_pretrained(tmp_path, safe_serialization=True,
                                    max_shard_size=f"{shard_kb}KB")
    shards = sorted(tmp_path.glob("*.safetensors"))
    assert len(shards) > 1, shards
    return hf_cfg


@pytest.mark.parametrize("stored,load_as", [
    (torch.float32, torch.float32), (torch.float32, None),
    (torch.bfloat16, None), (torch.bfloat16, torch.float32),
    (torch.float16, None),
], ids=["f32-f32", "f32-bf16", "bf16-bf16", "bf16-f32", "f16-bf16"])
@pytest.mark.parametrize("family", [FAMILIES[1], FAMILIES[2], FAMILIES[6]],
                         ids=["gqa", "tied", "qwen2"])
def test_load_checkpoint_equals_jax(tmp_path, family, stored, load_as):
    _save(tmp_path, family, stored)
    jdt = {None: None, torch.float32: np.float32}[load_as]
    jcfg, jparams = JC.load_hf_checkpoint(tmp_path, dtype=jdt)
    tcfg, tmodel = TC.load_hf_checkpoint(tmp_path, dtype=load_as,
                                         device="cpu")
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.dtype == (load_as or torch.bfloat16) == tmodel.cfg.dtype
    _assert_same_leaves(tmodel, _jax_tree(jparams))


def test_load_errors_equal_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(CONFIG_DICTS[0]))
    with pytest.raises(FileNotFoundError) as jerr:
        JC.load_hf_checkpoint(tmp_path)
    with pytest.raises(FileNotFoundError) as terr:
        TC.load_hf_checkpoint(tmp_path, device="cpu")
    assert str(terr.value) == str(jerr.value)
    # A missing tensor: the same KeyError text as JAX's.
    ckpt = tmp_path / "ckpt"
    _save(ckpt, FAMILIES[1], torch.float32)
    shard = sorted(ckpt.glob("*.safetensors"))[-1]
    from safetensors.numpy import load_file, save_file

    tensors = load_file(str(shard))
    gone = sorted(tensors)[0]
    save_file({k: v for k, v in tensors.items() if k != gone}, str(shard),
              metadata={"format": "pt"})
    with pytest.raises(KeyError) as jerr:
        JC.load_hf_checkpoint(ckpt)
    with pytest.raises(KeyError) as terr:
        TC.load_hf_checkpoint(ckpt, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_load_names_an_unsupported_dtype(tmp_path):
    _save(tmp_path, FAMILIES[1], torch.float32)
    shard = sorted(tmp_path.glob("*.safetensors"))[0]
    from safetensors.numpy import load_file, save_file

    tensors = load_file(str(shard))
    key = sorted(tensors)[0]
    tensors[key] = tensors[key].astype(np.float64)
    save_file(tensors, str(shard), metadata={"format": "pt"})
    with pytest.raises(ValueError, match=f"{key}' has dtype 'F64'"):
        TC.load_hf_checkpoint(tmp_path, device="cpu")


_BLOCKED_LOAD = r"""
import importlib.abc, sys
BLOCKED = ("safetensors", "transformers", "ml_dtypes", "jax", "jaxlib",
           "kubeflow_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import numpy as np
from kubeflow_tpu_torch.models.bridge import params_to_numpy
from kubeflow_tpu_torch.models.convert import load_hf_checkpoint
cfg, model = load_hf_checkpoint(sys.argv[2], device="cpu")
tree = params_to_numpy(model)
flat = {k: v for k, v in tree.items() if k != "layers"}
flat.update({"layers/" + k: v for k, v in tree["layers"].items()})
np.savez(sys.argv[3], **flat)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
"""


def test_load_runs_without_safetensors_transformers_or_ml_dtypes(tmp_path):
    ckpt = tmp_path / "ckpt"
    _save(ckpt, FAMILIES[1], torch.bfloat16)
    out = tmp_path / "leaves.npz"
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_LOAD, str(ROOT), str(ckpt),
         str(out)], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    _, jparams = JC.load_hf_checkpoint(ckpt)
    jtree = _jax_tree(jparams)
    got = np.load(out)
    want = {k: v for k, v in jtree.items() if k != "layers"}
    want.update({f"layers/{k}": v for k, v in jtree["layers"].items()})
    assert set(got.files) == set(want)
    for key, value in want.items():
        # bf16 leaves come back as their uint16 words.
        assert got[key].dtype == np.uint16, key
        assert got[key].tobytes() == value.tobytes(), key
