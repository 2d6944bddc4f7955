"""Weight bridge: JAX init_params tree → numpy → torch ``Llama`` → numpy.

Every leaf must come back byte-equal, bf16 included (bf16 crosses as raw
16-bit words, never through a float conversion), and the torch tensors
must hold exactly the JAX values.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models.bridge import params_from_jax, params_to_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _configs(name, **kw):
    return (dataclasses.replace(L.LLAMA_CONFIGS[name], **kw),
            dataclasses.replace(TL.LLAMA_CONFIGS[name], **kw))


@pytest.mark.parametrize("name,kw", [
    ("tiny", {}),
    ("tiny-gqa", {}),
    ("tiny", {"attn_bias": True}),
    ("tiny-gqa", {"tie_embeddings": True}),
])
def test_round_trip_is_byte_equal(name, kw):
    jcfg, tcfg = _configs(name, **kw)
    tree = jax.tree.map(np.asarray, L.init_params(jcfg, jax.random.PRNGKey(3)))
    model = params_from_jax(tree, tcfg, device="cpu")
    assert isinstance(model, TL.Llama) and len(model.layers) == jcfg.n_layers
    back = params_to_numpy(model, like=tree)
    flat, treedef = jax.tree.flatten(tree)
    back_flat, back_def = jax.tree.flatten(back)
    assert treedef == back_def
    for a, b in zip(flat, back_flat):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # The torch side holds the same values, layer by layer, (in, out).
    wq = model.layers[1].wq
    assert wq.dtype == torch.bfloat16 and not wq.requires_grad
    np.testing.assert_array_equal(
        wq.float().numpy(), tree["layers"]["wq"][1].astype(np.float32))


def test_unstacked_bf16_words_without_a_template():
    jcfg, tcfg = _configs("tiny")
    tree = jax.tree.map(np.asarray, L.init_params(jcfg, jax.random.PRNGKey(0)))
    back = params_to_numpy(params_from_jax(tree, tcfg, device="cpu"))
    assert back["embed"].dtype == np.uint16
    assert back["embed"].tobytes() == tree["embed"].tobytes()


def test_mismatched_trees_raise():
    jcfg, tcfg = _configs("tiny")
    tree = jax.tree.map(np.asarray, L.init_params(jcfg, jax.random.PRNGKey(0)))
    bad = dict(tree, layers=dict(tree["layers"], wq=tree["layers"]["wq"][:, :, :8]))
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax({k: v for k, v in tree.items() if k != "lm_head"},
                        tcfg, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        params_from_jax(dict(tree, extra=tree["embed"]), tcfg, device="cpu")
