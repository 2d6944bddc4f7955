"""Serving configuration and prompt padding shared by the engines.

Counterpart of the host-side half of ``kubeflow_tpu/models/serving.py``
(``GenerationConfig`` and ``left_pad``), kept as the port's own copy.
Variable-length prompts are LEFT-padded to one bucket: every prompt then
ends at the same index, pads are fenced by a validity mask, and RoPE's
shift-equivariance makes the per-prompt pad offset cancel in q·k.
``batch_generate`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


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
