"""fp8 training and serving for the Llama family: the port of
``kubeflow_tpu/models/fp8.py``.

Two independent capabilities, on the IEEE-754 fp8 formats torch ships
(``torch.float8_e4m3fn`` for values, ``torch.float8_e5m2`` for gradients):

- **fp8 training** (TransformerEngine-style delayed scaling): master
  weights stay in the model dtype and AdamW sees only them, but every
  targeted product runs with fp8 operands: forward operands in e4m3,
  gradients in e5m2. Each weight carries per-tensor amax histories
  (``init_meta``); the scale used at step N comes from the maxima seen at
  steps < N, and the amax seen at step N is recorded for step N+1.

  ``wrap_params_fp8`` puts an ``Fp8Weight`` (the master ``hp`` and the
  histories ``x_hist``, ``w_hist``, ``g_hist``, all parameters) in place
  of each targeted projection; ``llama._mm`` sends it to ``fp8_matmul``.
  As in JAX ("overwrite with gradient"), each history's gradient IS its
  next value: ``Fp8Matmul``'s backward returns the histories recorded in
  the forward (saved as residuals, so under remat they come from the pass
  whose residuals the backward reads) and the gradient's. The histories
  are never changed during the backward, so every microbatch of a step
  scales from the step's starting histories. ``models/train.py`` keeps
  them out of AdamW and the clip (``fp8_partition_labels``) and replaces
  each by its gradient as optax's ``apply_updates`` lands on it,
  ``h + (next - h)`` in f32 (``fp8_meta_replace``).

  The arithmetic is JAX's, op for op and in f32: the scale is a true
  division (``fmax / amax``, never a reciprocal times fmax), the cast
  clips to the format's range before it rounds (e4m3fn has no inf), the
  products accumulate in f32 and are then divided by the product of their
  two scales. The casts agree with JAX's byte for byte. Each product has
  a plain version (the fp8 operands upcast to f32, then ``torch.matmul``),
  which a CPU tensor runs; on the card it is ``torch._scaled_mm`` with
  unit scales, an f32 output and exact accumulation, followed by JAX's
  division and cast, so only the order of the sums differs from JAX. A
  shape ``_scaled_mm`` cannot take raises: there is no fallback.

  The lm head stays out of fp8, as in JAX (``_LAYER_TARGETS``).

- **fp8 weight-only serving**: ``quantize_weight_fp8`` stores a
  projection as e4m3 with a per-output-channel f32 scale that maps each
  channel's amax to ``E4M3_MAX``: the same ``q``/``s`` layout as int8, so
  ``models/quant.py``'s products and ``dequantize_weight`` serve it
  unchanged. The values agree byte for byte with the JAX function's.
"""

from __future__ import annotations

import torch
from torch import nn

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.quant import QuantizedWeight, _scale, _set

E4M3_MAX = 448.0      # largest finite float8_e4m3fn
E5M2_MAX = 57344.0    # largest finite float8_e5m2

# Product targets: the layer projections. The lm head is left out, as in
# JAX: logits are the classic fp8 casualty, and the head is read once a
# token (against once a layer).
_LAYER_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

_HISTORY = 16  # amax history window (TransformerEngine's default order)
_META = ("x_hist", "w_hist", "g_hist")


def init_meta(history: int = _HISTORY, device=None) -> dict:
    """Fresh per-weight fp8 metadata: amax histories of the forward
    activation (x), the weight (w) and the backward gradient (g), f32
    zeros on ``device`` (the card unless ``"cpu"`` is asked for). Zeros
    mean "nothing observed yet": scale 1.0 on the first step."""
    dev = resolve_device(device)
    return {name: torch.zeros((history,), dtype=torch.float32, device=dev)
            for name in _META}


def _scale_from(hist: torch.Tensor, fmax: float,
                margin: float = 1.0) -> torch.Tensor:
    """Delayed scale: the largest recently observed amax mapped to the
    format's max (over ``margin`` headroom); an all-zero history scales by
    1.0 rather than inf. A true f32 division, as JAX's."""
    amax = torch.amax(hist)
    den = margin * amax
    return torch.where(amax > 0.0, torch.full_like(den, fmax) / den,
                       torch.ones_like(den))


def _record(hist: torch.Tensor, x: torch.Tensor, group=None) -> torch.Tensor:
    """The history rolled by one with ``max|x|`` (in f32) at its front: a
    new tensor, the history left as it was. With a ``group`` (a plan's
    mesh) the maximum is over every rank's piece of ``x``: the amax of
    the global tensor, as JAX's ``max`` over a sharded array."""
    amax = torch.amax(torch.abs(x)).float().reshape(1)
    if group is not None:
        torch.distributed.all_reduce(amax, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
    return torch.cat([amax, hist[:-1]])


def _cast(x: torch.Tensor, scale: torch.Tensor, dtype,
          fmax: float) -> torch.Tensor:
    """Scale into the representable range and saturate-cast: the clip
    matters, e4m3fn has no inf and an overflow would be NaN."""
    return torch.clamp(x.float() * scale, -fmax, fmax).to(dtype)


def fp8_product_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D fp8 operands, accumulated in f32: both upcast to f32
    (exact), then ``torch.matmul``."""
    return torch.matmul(a.float(), b.float())


def fp8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D fp8 operands (M, K) × (K, N) → f32 (M, N).

    A CPU tensor runs ``fp8_product_reference``. On the card it is
    ``torch._scaled_mm`` with unit scales, an f32 output and
    ``use_fast_accum=False``; ``a`` is passed row-major and ``b``
    column-major (copied where they are not). Raises on what
    ``_scaled_mm`` does not take (K or N not a multiple of 16, e5m2 ×
    e5m2); there is no fallback. ``fp8_product.launches`` counts the
    ``_scaled_mm`` calls."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"fp8_product takes (M, K) x (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.device.type == "cpu":
        return fp8_product_reference(a, b)
    k, n = b.shape
    if k % 16 or n % 16:
        raise ValueError(f"_scaled_mm needs K and N to be multiples of 16, "
                         f"got K {k}, N {n}")
    if a.dtype == b.dtype == torch.float8_e5m2:
        raise ValueError("_scaled_mm does not take e5m2 x e5m2")
    one = torch.ones((), dtype=torch.float32, device=a.device)
    out = torch._scaled_mm(a.contiguous(), b.t().contiguous().t(),
                           scale_a=one, scale_b=one, out_dtype=torch.float32,
                           use_fast_accum=False)
    fp8_product.launches += 1
    return out


fp8_product.launches = 0


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with ``a`` (..., K) folded to 2-D for ``fp8_product``."""
    out = fp8_product(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _fp8_forward(x: torch.Tensor, w: torch.Tensor, x_hist: torch.Tensor,
                 w_hist: torch.Tensor, group=None):
    """JAX's ``_fp8_fwd``: (y, qx, qw, sx, sw, next x_hist, next w_hist)."""
    sx = _scale_from(x_hist, E4M3_MAX)
    sw = _scale_from(w_hist, E4M3_MAX)
    qx = _cast(x, sx, torch.float8_e4m3fn, E4M3_MAX)
    qw = _cast(w, sw, torch.float8_e4m3fn, E4M3_MAX)
    # f32 accumulation, then both operand scales undone in the epilogue.
    y = (_matmul(qx, qw) / (sx * sw)).to(x.dtype)
    return (y, qx, qw, sx, sw, _record(x_hist, x, group),
            _record(w_hist, w, group))


def _fp8_backward(g: torch.Tensor, qx: torch.Tensor, qw: torch.Tensor,
                  sx: torch.Tensor, sw: torch.Tensor, g_hist: torch.Tensor,
                  x_dtype, w_dtype, group=None):
    """JAX's ``_fp8_bwd``: (dx, dw, qg, next g_hist); dx = qg @ qwᵀ and
    dw = qx₂ᵀ @ qg₂, each accumulated in f32 and divided by its scales."""
    sg = _scale_from(g_hist, E5M2_MAX)
    qg = _cast(g, sg, torch.float8_e5m2, E5M2_MAX)
    dx = (_matmul(qg, qw.t()) / (sg * sw)).to(x_dtype)
    qg2 = qg.reshape(-1, qg.shape[-1])
    qx2 = qx.reshape(-1, qx.shape[-1])
    dw = (fp8_product(qx2.t(), qg2) / (sx * sg)).to(w_dtype)
    return dx, dw, qg, _record(g_hist, g, group)


class Fp8Matmul(torch.autograd.Function):
    """``x @ w`` with fp8 operands and delayed scaling. The gradient of
    each history is its next value (overwrite with gradient)."""

    @staticmethod
    def forward(ctx, x, w, x_hist, w_hist, g_hist, group=None):
        y, qx, qw, sx, sw, next_x, next_w = _fp8_forward(
            x, w, x_hist, w_hist, group)
        ctx.save_for_backward(qx, qw, sx, sw, next_x, next_w, g_hist)
        ctx.dtypes = (x.dtype, w.dtype)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw, next_x, next_w, g_hist = ctx.saved_tensors
        dx, dw, _, next_g = _fp8_backward(g, qx, qw, sx, sw, g_hist,
                                          *ctx.dtypes, ctx.group)
        return dx, dw, next_x, next_w, next_g, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, meta: dict,
               group=None) -> torch.Tensor:
    """``x @ w`` with fp8 operands and delayed scaling. x: (..., K), w:
    (K, N), meta: ``init_meta()``'s dict. Differentiable in x and w; each
    history's gradient is its next value (``models/train.py`` replaces the
    history by it). Under a plan, ``group`` is the mesh's: each amax is
    then the maximum over every rank's piece (x and g split over the
    batch and tp, w over tp), so every rank records the same histories."""
    return Fp8Matmul.apply(x, w, *(meta[name] for name in _META), group)


class Fp8Weight(nn.Module):
    """A projection trained with fp8 products: the master weight ``hp``
    (``(in, out)``, the model dtype) and its amax histories, all
    parameters. JAX's ``{"hp": w, "fp8": init_meta()}``."""

    def __init__(self, hp: nn.Parameter, meta: dict) -> None:
        super().__init__()
        self.hp = hp
        for name in _META:
            self.register_parameter(name, nn.Parameter(
                meta[name], requires_grad=hp.requires_grad))

    def meta(self) -> dict:
        return {name: getattr(self, name) for name in _META}


def _rebuilt(params, replace):
    """A new ``Llama`` sharing every parameter of ``params``; each layer
    projection ``w`` named ``t`` becomes ``replace(t, w)`` where that is
    not None, and stays ``w`` (shared) where it is."""
    out = type(params)(params.cfg, device="meta")
    for name, p in params.named_parameters():
        parts = name.split(".")
        if not (parts[0] == "layers" and parts[2] in _LAYER_TARGETS):
            _set(out, name, p)
    for i, layer in enumerate(params.layers):
        for t in _LAYER_TARGETS:
            w = getattr(layer, t)
            new = replace(t, w)
            _set(out.layers[i], t, w if new is None else new)
    return out


def wrap_params_fp8(params, targets=_LAYER_TARGETS,
                    history: int = _HISTORY):
    """A model whose targeted projections are ``Fp8Weight``s over the same
    master parameters (shared, not copied), each layer with histories of
    its own; everything else (embeddings, norms, lm head, biases) shared
    as it is."""
    def wrap(name, w):
        if name not in targets or isinstance(w, Fp8Weight):
            return None
        if isinstance(w, QuantizedWeight):
            raise ValueError(f"{name} is quantized: fp8 training wraps "
                             "dense master weights")
        return Fp8Weight(w, init_meta(history, w.device))
    return _rebuilt(params, wrap)


def unwrap_params_fp8(params):
    """fp8-training model → a plain model over the same master weights
    (e.g. for checkpoint export or switching to inference)."""
    return _rebuilt(params, lambda name, w: w.hp
                    if isinstance(w, Fp8Weight) else None)


def has_fp8_params(params) -> bool:
    return any(isinstance(m, Fp8Weight) for m in params.modules())


def fp8_partition_labels(params) -> dict:
    """{parameter name: label}: "fp8_meta" for every history of an
    ``Fp8Weight``, "default" elsewhere (JAX's labels for
    ``optax.multi_transform``)."""
    metas = {f"{owner}.{name}" for owner, mod in params.named_modules()
             if isinstance(mod, Fp8Weight) for name in _META}
    return {name: "fp8_meta" if name in metas else "default"
            for name, _ in params.named_parameters()}


@torch.no_grad()
def fp8_meta_replace(params) -> None:
    """Replace each history by its gradient, its next value, as optax lands
    on it: ``h + (next - h)`` in f32 (``fp8_meta_replace``'s update is
    ``next - h``, ``apply_updates`` adds it). In place."""
    labels = fp8_partition_labels(params)
    for name, h in params.named_parameters():
        if labels[name] == "fp8_meta":
            h.add_(h.grad - h)


def quantize_weight_fp8(w: torch.Tensor, axis: int) -> QuantizedWeight:
    """Per-output-channel e4m3: scale = max(amax, 1e-8) / E4M3_MAX over the
    contraction ``axis``; values clipped to ±E4M3_MAX, then cast (round to
    nearest even)."""
    wf = w.float()
    scale = _scale(torch.amax(torch.abs(wf), dim=axis, keepdim=True),
                   E4M3_MAX)
    q = torch.clamp(wf / scale, -E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
    return QuantizedWeight(q, scale, "fp8", axis, w.shape)
