"""Batched generation, and the serving configuration and prompt padding
shared by the engines.

Counterpart of ``kubeflow_tpu/models/serving.py``. Variable-length prompts
are LEFT-padded to one bucket: every prompt then ends at the same index
(the decode write position stays one scalar), pads are fenced by a static
full-cache validity mask, and RoPE's shift-equivariance makes the
per-prompt pad offset cancel in q·k. ``batch_generate`` runs its steps as
a Python loop where JAX runs one jitted scan; a row that has emitted EOS
emits pad from then on, and lengths count the ``done`` flags, never
``pad_id`` (a model may emit token 0).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch.models.llama import (
    _decode_impl,
    _prefill_impl,
    init_kv_cache,
    sample_logits,
)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = 2  # llama tokenizer </s>
    pad_id: int = 0


def left_pad(
    prompts: Sequence[Sequence[int]], pad_id: int, length: Optional[int] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Ragged token lists → (tokens (B, L) int32, mask (B, L) bool)."""
    if not prompts:
        raise ValueError("empty prompt batch")
    longest = max(len(p) for p in prompts)
    length = longest if length is None else length
    if length < longest:
        raise ValueError(f"length {length} < longest prompt {longest}")
    batch = len(prompts)
    tokens = np.full((batch, length), pad_id, np.int32)
    mask = np.zeros((batch, length), bool)
    for i, prompt in enumerate(prompts):
        if len(prompt) == 0:
            raise ValueError(f"prompt {i} is empty")
        tokens[i, length - len(prompt):] = np.asarray(prompt, np.int32)
        mask[i, length - len(prompt):] = True
    return tokens, mask


@torch.no_grad()
def _batch_generate_fused(params, cfg, tokens: torch.Tensor,
                          prompt_mask: Optional[torch.Tensor],
                          generator: torch.Generator, steps: int,
                          cache_len: int, temperature: float, top_k: int,
                          top_p: float, eos_id: int, pad_id: int,
                          kv_bits: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(generated (B, steps), lengths (B,)) for a left-padded batch."""
    b, s_prompt = tokens.shape
    kv_cache = init_kv_cache(cfg, b, cache_len, kv_bits=kv_bits,
                             device=tokens.device)
    # Static full-cache mask: pad slots False forever, every slot from the
    # prompt end onward True (causality hides not-yet-written slots).
    kv_mask = None if prompt_mask is None else torch.cat(
        [prompt_mask, torch.ones((b, cache_len - s_prompt), dtype=torch.bool,
                                 device=tokens.device)], dim=1)
    logits, kv_cache = _prefill_impl(params, cfg, tokens, kv_cache,
                                     kv_mask=prompt_mask)
    nxt = sample_logits(logits, generator, temperature, top_k, top_p)
    done = nxt == eos_id
    tok = torch.where(done, pad_id, nxt)[:, None]
    toks, dones = [], []
    for i in range(steps):
        # Emit the carried token WITH its done-before flag.
        toks.append(tok[:, 0])
        dones.append(done)
        if i + 1 == steps:
            break  # the last emitted token is never decoded
        logits, kv_cache = _decode_impl(params, cfg, tok, kv_cache,
                                        s_prompt + i, kv_mask=kv_mask)
        nxt = sample_logits(logits, generator, temperature, top_k, top_p)
        done = done | (nxt == eos_id)
        tok = torch.where(done, pad_id, nxt)[:, None]
    out = torch.stack(toks, dim=1) if toks else tokens.new_zeros((b, 0))
    lengths = (torch.sum(~torch.stack(dones, dim=1), dim=1) if dones
               else tokens.new_zeros((b,)))
    return out, lengths


def batch_generate(params, cfg, prompts: Sequence[Sequence[int]],
                   gen: Optional[GenerationConfig] = None,
                   generator: Optional[torch.Generator] = None,
                   pad_to: Optional[int] = None,
                   kv_bits: int = 0) -> list[list[int]]:
    """Generate completions for a ragged batch of prompts on the device of
    ``params``; one token list per prompt, truncated at (and excluding)
    EOS. ``pad_to`` buckets the prompt length; ``kv_bits=8`` stores the KV
    cache as int8. Sampled rows draw from ``generator`` (seed 0 when None)
    where JAX takes a key."""
    gen = gen or GenerationConfig()
    dev = params.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tokens, np_mask = left_pad(prompts, gen.pad_id, pad_to)
    # A uniform-length bucket drops the all-True mask, as in JAX.
    mask = None if np_mask.all() else torch.from_numpy(np_mask).to(dev)
    out, lengths = _batch_generate_fused(
        params, cfg, torch.from_numpy(tokens).to(dev), mask, generator,
        steps=gen.max_new_tokens, cache_len=tokens.shape[1] + gen.max_new_tokens,
        temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
        eos_id=gen.eos_id, pad_id=gen.pad_id, kv_bits=kv_bits,
    )
    out = out.cpu().numpy()
    lengths = lengths.cpu().numpy()
    return [[int(t) for t in row[:n]] for row, n in zip(out, lengths)]
