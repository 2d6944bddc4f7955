"""PyTorch port of ``batch_generate`` vs the JAX reference.

Greedy generation over a ragged batch on f32 ``tiny-gqa`` (left padding,
the static full-cache kv_mask, per-row EOS): the port's tokens must equal
JAX's, including rows that stop at an EOS taken from a probe run, a
uniform-length batch (no mask), an int8 cache and a ``pad_to`` bucket.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import serving as JS
from kubeflow_tpu_torch.models import llama as TL
from kubeflow_tpu_torch.models import serving as TS
from kubeflow_tpu_torch.models.bridge import params_from_jax

PROMPTS = [[5, 9, 17, 33], [7, 1, 200, 3, 99, 45, 12], [250, 4]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def f32_gqa():
    jcfg = dataclasses.replace(L.LLAMA_CONFIGS["tiny-gqa"], dtype=jnp.float32)
    tcfg = dataclasses.replace(TL.LLAMA_CONFIGS["tiny-gqa"],
                               dtype=torch.float32)
    jparams = L.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _both(models, prompts, **kw):
    jcfg, tcfg, jparams, tparams = models
    gen = kw.pop("gen")
    ref = JS.batch_generate(jparams, jcfg, prompts,
                            gen=JS.GenerationConfig(**gen), **kw)
    out = TS.batch_generate(tparams, tcfg, prompts,
                            gen=TS.GenerationConfig(**gen), **kw)
    return [[int(t) for t in row] for row in ref], out


@pytest.mark.parametrize("kw", [
    {},
    {"pad_to": 16},
    {"kv_bits": 8},
])
def test_ragged_batch_matches(f32_gqa, kw):
    ref, out = _both(f32_gqa, PROMPTS, gen=dict(max_new_tokens=8, eos_id=-1),
                     **kw)
    assert out == ref
    assert [len(r) for r in out] == [8, 8, 8]


def test_uniform_batch_without_mask(f32_gqa):
    ref, out = _both(f32_gqa, [[5, 9, 17], [8, 8, 8]],
                     gen=dict(max_new_tokens=6, eos_id=-1))
    assert out == ref


def test_eos_truncates_each_row(f32_gqa):
    """An EOS taken from row 1's third token stops row 1 there (and any
    other row that emits it); lengths come from the done flags."""
    _, probe = _both(f32_gqa, PROMPTS, gen=dict(max_new_tokens=8, eos_id=-1))
    eos = probe[1][2]
    ref, out = _both(f32_gqa, PROMPTS, gen=dict(max_new_tokens=8, eos_id=eos))
    assert out == ref
    assert out[1] == probe[1][:2]
    assert all(eos not in row for row in out)
