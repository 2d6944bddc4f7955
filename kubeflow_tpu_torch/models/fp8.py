"""fp8 weight-only serving for the Llama family: the serving half of
``kubeflow_tpu/models/fp8.py``.

``quantize_weight_fp8`` stores a projection as e4m3
(``torch.float8_e4m3fn``) with a per-output-channel f32 scale that maps
each channel's amax to ``E4M3_MAX``: the same ``q``/``s`` layout as int8,
so ``models/quant.py``'s products and ``dequantize_weight`` serve it
unchanged, with the same 2× fewer weight bytes. The values agree byte for
byte with the JAX function's.

The training half (delayed-scaling metas, ``fp8_matmul`` and its custom
gradient, the param wrappers and their optimizer labels) is not ported
yet: ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.models.quant import QuantizedWeight, _scale

E4M3_MAX = 448.0      # largest finite float8_e4m3fn
E5M2_MAX = 57344.0    # largest finite float8_e5m2


def quantize_weight_fp8(w: torch.Tensor, axis: int) -> QuantizedWeight:
    """Per-output-channel e4m3: scale = max(amax, 1e-8) / E4M3_MAX over the
    contraction ``axis``; values clipped to ±E4M3_MAX, then cast (round to
    nearest even)."""
    wf = w.float()
    scale = _scale(torch.amax(torch.abs(wf), dim=axis, keepdim=True),
                   E4M3_MAX)
    q = torch.clamp(wf / scale, -E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return QuantizedWeight(q, scale, "fp8", axis, w.shape)
