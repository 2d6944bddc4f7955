"""Device mesh + sharding plan over ``torch.distributed`` ranks.

Counterpart of ``kubeflow_tpu/parallel/mesh.py``. The JAX mesh is a grid
of devices that ONE process drives, and GSPMD inserts the collectives a
``PartitionSpec`` implies. PyTorch has no GSPMD: here a mesh is a grid of
process-group RANKS, one device each, and the code that runs on a rank
holds only its own shard and calls the collectives itself
(``models/llama.py``: one ``all_reduce`` after ``wo`` and one after
``w_down``, a masked embedding lookup plus ``all_reduce``, and an
``all_gather`` of the vocab-split head's logits).

Axes keep JAX's names and order, ``(dp, fsdp, ep, pp, sp, tp)``:

- ``dp``  — data parallel (batch dim; gradients all-reduced over dp)
- ``fsdp``— fully-sharded data parallel (params sharded, all-gathered for
            use)
- ``ep``  — expert parallel (MoE expert dim)
- ``pp``  — pipeline parallel (layer stages)
- ``sp``  — sequence/context parallel
- ``tp``  — tensor parallel (attention heads / MLP hidden / vocab)

``make_mesh`` builds the rank grid and one subgroup per non-trivial axis
(the world group itself where an axis spans every rank), plus one over the
batch axes ``(dp, fsdp)`` and one over every axis. ``MeshPlan`` carries
the sharding rule of ``param_spec`` and applies it:

- ``shard_params`` cuts a full ``Llama`` (or the bridge's numpy tree) to
  this rank's shard leaf by leaf, over ``tp`` and ``fsdp``; every leaf it
  cuts carries a ``Placement``;
- ``shard_kv_cache`` cuts a KV cache or block pool by kv head;
- ``batch_spec``, ``logits_spec``, ``param_shardings`` (a ``Placement`` a
  parameter) and ``batch_sharding`` (the ``Placement`` of a global batch,
  whose ``index()`` holds this rank's rows) keep JAX's names.

A ``Placement`` is the port's ``NamedSharding`` bound to one array: the
mesh, the spec (an axis name, a tuple of names or None a dim, as a
``PartitionSpec``) and the global shape. A sharded leaf is a plain tensor
holding this rank's slice with its ``Placement`` beside it, as the
attribute ``placement`` (``place``, ``placement_of``): what
``models/llama.py`` gathers and what ``runtime/checkpoint.py`` writes in
JAX's shard format.

What differs from JAX:
- ``devices`` are ranks; a rank's device is whatever it was started on
  (``cuda:<local rank>``, one card each, or the CPU under gloo).
- ``shard_params`` shards a ``Llama`` IN PLACE, replacing each leaf's data
  by its slice as it goes, so the peak extra memory is one leaf, never a
  second model; the caller's module becomes the shard. The engines never
  shard: under a plan they take a shard (``check_shard``), cut once by
  the caller. The qkv biases (qwen2) are sliced with their projections'
  columns, where JAX replicates them and GSPMD slices the add.
- Serving takes every axis JAX's engines take, as GSPMD runs them: tp
  cuts the heads, the MLP hidden and the vocab; fsdp cuts the weights'
  dim axis, gathered where each leaf is used (``models/llama.py``
  ``_whole``); the step itself is replicated over dp and fsdp (JAX's
  engines never place their batch with ``batch_sharding``), so every rank
  of a replica computes the same batch, and a pool or cache is cut over
  tp alone (and over sp, below). Under sp only the continuous engine
  serves (its cache cut over the sequence,
  ``shard_kv_cache(seq_over_sp=True)``); the paged and speculative
  engines raise JAX's ``ValueError``s. Training
  takes every axis: dp, fsdp and tp cut the Llama leaves (``param_spec``);
  sp cuts the batch's sequence (``batch_spec``, ``local_batch``) and
  leaves every leaf whole; pp and ep cut the pipeline's stages and the
  experts (``parallel/pipeline.py``, ``models/moe.py``'s
  ``moe_param_spec``), through the same ``Placement``.
- Quantized weights are refused (``ValueError``) before any leaf is
  touched: JAX's ``device_put`` cannot shard them either (the ``(L, 1,
  out)`` scale of ``wo`` does not divide over ``tp``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch import nn

AXES = ("dp", "fsdp", "ep", "pp", "sp", "tp")
# The axes a batch is split over, dp major (JAX's ``("dp", "fsdp")``).
BATCH_AXES = ("dp", "fsdp")
# The axes a sequence-parallel step's gradients are summed over: the batch
# axes and sp (each sp rank's loss covers its positions), and the same
# less fsdp for a leaf fsdp cuts (its backward reduce-scattered over fsdp).
SP_GRAD_AXES = ("dp", "fsdp", "sp")
SP_FSDP_GRAD_AXES = ("dp", "sp")
# Axis combinations that get a group of their own beside each axis: the
# batch axes (the gradient sums), every axis (the mesh-wide reductions:
# the clip's global norm, fp8's amax) and the sums of sp training.
_GROUPED = (BATCH_AXES, AXES, SP_GRAD_AXES, SP_FSDP_GRAD_AXES)


def _world() -> tuple[int, int]:
    """(world size, this rank): (1, 0) when no process group is up."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _axes_of(entry) -> tuple:
    """The mesh axes one dim of a spec names: None, a name or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks with named axes, and this rank's subgroup along
    each axis that needs one (absent for an axis of size 1 short of the
    whole world), keyed by the axis name, and over the batch axes and
    every axis, keyed by the tuple of names."""

    ranks: np.ndarray  # int grid, one axis per name
    axis_names: tuple
    groups: dict

    @property
    def shape(self) -> dict:
        """{axis: size} in axis order, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coordinate(self, axis: str, rank: Optional[int] = None) -> int:
        """``rank``'s (default: this rank's) index along ``axis``."""
        if rank is None:
            rank = _world()[1]
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in this mesh")
        return int(where[0][self.axis_names.index(axis)])

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or a tuple; an
        axis the mesh lacks counts 1)."""
        shape = self.shape
        return math.prod(shape.get(a, 1) for a in _axes_of(axes))

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """``rank``'s index over ``axes`` taken together, the first one
        major, as a PartitionSpec's tuple entry splits a dim."""
        k = 0
        for a in _axes_of(axes):
            if a in self.shape:
                k = k * self.shape[a] + self.coordinate(a, rank)
        return k

    def group(self, axes):
        """This rank's group along ``axes`` (a name or a tuple of names),
        None where it needs none."""
        key = _axes_of(axes)
        return self.groups.get(key[0] if len(key) == 1 else key)


def _mesh_over(ranks: list, names: tuple, sizes: tuple) -> Mesh:
    """The rank grid of ``sizes`` over ``ranks`` and its axis subgroups.
    Every rank of the world must call this with the same arguments:
    ``torch.distributed.new_group`` is collective over the world. With no
    process group up it is the grid alone (a description, as a JAX mesh
    over devices this process does not drive)."""
    grid = np.asarray(ranks, dtype=np.int64).reshape(sizes)
    world, rank = _world()
    groups: dict = {}
    made: dict = {}
    up = world > 1 or (torch.distributed.is_available()
                       and torch.distributed.is_initialized())
    combos = [(name,) for name in names] + [
        combo for combo in _GROUPED if set(combo) <= set(names)]
    for combo in combos:
        # Every line of the grid along these axes is one group; all ranks
        # create all of them, in the same order. A line that spans the
        # whole world is the world group (of one rank, too, when a group
        # is up: its collectives then run over that backend); any other
        # line of one rank needs none. A line already made is reused.
        idx = [names.index(a) for a in combo]
        n = math.prod(sizes[i] for i in idx)
        lines = np.moveaxis(grid, idx, list(range(-len(idx), 0))
                            ).reshape(-1, n)
        for line in lines:
            members = [int(r) for r in line]
            if up and sorted(members) == list(range(world)):
                group = torch.distributed.group.WORLD
            elif n == 1 or not up:
                continue  # no group needed, or none to make one in
            else:
                if tuple(members) not in made:
                    made[tuple(members)] = torch.distributed.new_group(
                        ranks=members)
                group = made[tuple(members)]
            if rank in members:
                groups[combo[0] if len(combo) == 1 else combo] = group
    return Mesh(grid, tuple(names), groups)


def make_mesh(
    dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1,
    pp: int = 1, ep: int = 1,
    devices: Optional[list] = None,
) -> Mesh:
    """Build a Mesh with the canonical axis order (dp, fsdp, ep, pp, sp, tp)
    over ``devices`` (ranks; default every rank of the process group, or
    the one process when none is up). tp is innermost, so a tp group is
    consecutive ranks: consecutive cards of one host."""
    if devices is None:
        devices = list(range(_world()[0]))
    want = dp * fsdp * ep * pp * sp * tp
    if want != len(devices):
        raise ValueError(
            f"mesh dp={dp} fsdp={fsdp} ep={ep} pp={pp} sp={sp} tp={tp} "
            f"needs {want} devices, have {len(devices)}"
        )
    return _mesh_over(list(devices), AXES, (dp, fsdp, ep, pp, sp, tp))


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """Where an array's pieces live: the port's ``NamedSharding`` bound to
    the array's global shape. ``spec`` names, for each dim, the mesh axis
    (or tuple of axes, the first major) that splits it, or None; dims past
    its end are whole, as in a ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple
    global_shape: tuple

    def _dims(self) -> list:
        return [(n, _axes_of(self.spec[d]) if d < len(self.spec) else ())
                for d, n in enumerate(self.global_shape)]

    def index(self, rank: Optional[int] = None) -> tuple:
        """``rank``'s (default: this rank's) piece as ``((start, stop),
        ...)`` a dim, the form of a checkpoint's shard index."""
        out = []
        for n, axes in self._dims():
            size = self.mesh.axis_size(axes)
            if n % size:
                raise ValueError(
                    f"a dim of {n} does not divide over {axes} of size "
                    f"{size} (global shape {self.global_shape})")
            k = self.mesh.axis_index(axes, rank)
            out.append((k * (n // size), (k + 1) * (n // size)))
        return tuple(out)

    @property
    def local_shape(self) -> tuple:
        return tuple(b - a for a, b in self.index())

    @property
    def split_axes(self) -> tuple:
        """The axes of more than one rank that cut the array."""
        return tuple(a for _, axes in self._dims() for a in axes
                     if self.mesh.shape.get(a, 1) > 1)

    def split_dim(self, axis: str) -> Optional[int]:
        """The dim ``axis`` cuts, None when it cuts none (or is of one
        rank)."""
        if self.mesh.shape.get(axis, 1) == 1:
            return None
        return next((d for d, (_, axes) in enumerate(self._dims())
                     if axis in axes), None)

    @property
    def replicas(self) -> int:
        """How many ranks hold each piece."""
        return self.mesh.size // self.mesh.axis_size(self.split_axes)

    @property
    def spans_processes(self) -> bool:
        return self.mesh.size > 1

    def slice(self, value):
        """This rank's piece of the whole ``value`` (a tensor or numpy
        array of the global shape): ``value`` itself where the piece is
        all of it."""
        index = self.index()
        if all(a == 0 and b == n
               for (a, b), n in zip(index, self.global_shape)):
            return value
        return value[tuple(slice(a, b) for a, b in index)]


def place(t, placement: Placement):
    """Record ``placement`` beside the tensor ``t`` (its piece); returns
    ``t``."""
    t.placement = placement
    return t


def placement_of(t) -> Optional[Placement]:
    """The ``Placement`` recorded beside ``t``, None for a whole tensor."""
    return getattr(t, "placement", None)


_COL_LEAVES = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW_LEAVES = ("wo", "w_down")
_BIAS_LEAVES = ("bq", "bk", "bv")
# fp8 training's delayed-scaling histories (models/fp8.py), by leaf name:
# the port's path is ``layers.<i>.wq.x_hist`` where JAX's holds "fp8".
_FP8_META = ("x_hist", "w_hist", "g_hist")


@dataclasses.dataclass
class TPShard:
    """What a rank's ``Llama`` (and each of its layers) carries under a tp
    plan: the tp group, its degree, and the slice of the vocabulary its
    embedding rows cover."""

    group: object
    size: int
    vocab_lo: int
    vocab_local: int


@dataclasses.dataclass(frozen=True)
class SeqPiece:
    """Where a sequence-parallel rank's tokens sit in the global batch:
    the global position of its first column, the global sequence length,
    and the token after its last column a row (what its last target is:
    the next rank's first token), None on the last sp rank."""

    offset: int
    total: int
    nxt: Optional[torch.Tensor]


@dataclasses.dataclass
class MeshPlan:
    """A mesh plus the sharding rule the model stack agrees on."""

    mesh: Mesh

    @property
    def axes(self) -> dict:
        """Non-trivial mesh axes, ``{name: size}`` — the shape stamp /stats
        carries. ``{"tp": 1}`` for a degenerate all-ones mesh (a plan was
        requested, so the record must still say so)."""
        sizes = {
            name: int(size)
            for name, size in self.mesh.shape.items()
            if int(size) > 1
        }
        return sizes or {"tp": 1}

    @property
    def tp(self) -> int:
        return int(self.mesh.shape.get("tp", 1))

    @property
    def tp_rank(self) -> int:
        return self.mesh.coordinate("tp") if "tp" in self.mesh.shape else 0

    @property
    def tp_group(self):
        return self.mesh.group("tp")

    # -- activations -------------------------------------------------------
    @property
    def batch_spec(self) -> tuple:
        """Activations: batch over (dp, fsdp), sequence over sp."""
        return (BATCH_AXES, "sp", None)

    @property
    def logits_spec(self) -> tuple:
        return (BATCH_AXES, "sp", "tp")

    @property
    def n_batch(self) -> int:
        """How many pieces a batch is cut into: dp · fsdp."""
        return self.mesh.axis_size(BATCH_AXES)

    @property
    def batch_group(self):
        """The group over the batch axes: the ranks whose rows make one
        global batch (None for one rank short of the world)."""
        return self.mesh.group(BATCH_AXES)

    def batch_sharding(self, shape: tuple) -> Placement:
        """The ``Placement`` of a global batch of ``shape`` (``(B, S)``):
        its ``index()[0]`` is this rank's row range."""
        return Placement(self.mesh, self.batch_spec[:len(shape)],
                         tuple(shape))

    @property
    def sp(self) -> int:
        return int(self.mesh.shape.get("sp", 1))

    @property
    def sp_group(self):
        return self.mesh.group("sp")

    @property
    def sp_index(self) -> int:
        return self.mesh.coordinate("sp") if "sp" in self.mesh.shape else 0

    def local_batch(self, tokens):
        """This rank's piece of ``tokens``: the tensor itself when it is
        already a piece (``data.loader.device_put_global``), else its
        ``batch_sharding`` rows of the global batch, and under sp its
        positions of them."""
        if placement_of(tokens) is not None:
            return tokens
        return self.batch_sharding(tuple(tokens.shape)).slice(tokens)

    def seq_piece(self, tokens) -> Optional[SeqPiece]:
        """This rank's ``SeqPiece`` of the batch ``tokens`` (global, or
        this rank's piece from ``device_put_global``); None without sp.
        For a piece the next token comes from the next sp rank (a
        ``ppermute`` of the first column, which every sp rank joins)."""
        if self.sp == 1:
            return None
        from kubeflow_tpu_torch.parallel.collectives import ppermute

        pl = placement_of(tokens)
        if pl is None:
            pl = self.batch_sharding(tuple(tokens.shape))
            (r0, r1), (c0, c1) = pl.index()
            nxt = tokens[r0:r1, c1] if c1 < tokens.shape[1] else None
        else:
            (_, _), (c0, c1) = pl.index()
            last = self.sp_index == self.sp - 1
            got = ppermute(tokens[:, 0].contiguous(), self.sp_group,
                           [(i, i - 1) for i in range(1, self.sp)])
            nxt = None if last else got
        return SeqPiece(c0, pl.global_shape[1], nxt)

    # -- parameters --------------------------------------------------------
    def param_spec(self, path: tuple, value_ndim: int) -> tuple:
        """Sharding rule for a llama-family parameter by its path, as a
        tuple of axis names (None = unsharded) over the leaf as the port
        holds it (one layer, no stacked layer axis). tp shards the
        head/hidden output dimension and the vocab; fsdp the input
        dimension."""
        del value_ndim
        name = "/".join(str(p) for p in path)
        if "fp8" in path or str(path[-1]) in _FP8_META:
            # fp8 delayed-scaling histories: a few floats, replicated (the
            # projection match below must not see "wq" in "wq/x_hist").
            return ()
        if "embed" in name or "lm_head" in name:
            return ("tp", "fsdp")  # (vocab, dim)
        if any(k in name for k in _COL_LEAVES):
            return ("fsdp", "tp")  # (dim, out)
        if any(k in name for k in _ROW_LEAVES):
            return ("tp", "fsdp")  # (in, dim)
        if any(k in name for k in _BIAS_LEAVES):
            return ("tp",)  # the projection's out columns
        return ()  # norms replicated

    def placement(self, name: str, global_shape: tuple) -> Placement:
        """The ``Placement`` of the parameter at the dotted ``name``."""
        path = tuple(name.split("."))
        return Placement(self.mesh, self.param_spec(path, len(global_shape)),
                         tuple(global_shape))

    def param_shardings(self, params) -> dict:
        """{parameter name: ``Placement``} of a model, whole or sharded:
        JAX's NamedSharding tree."""
        return {name: self.placement(name, _global_shape(p))
                for name, p in params.named_parameters()}

    def _check_divides(self, cfg) -> None:
        tp = self.tp
        for what, n in (("n_kv_heads", cfg.n_kv_heads),
                        ("n_heads", cfg.n_heads),
                        ("ffn_hidden", cfg.ffn_hidden),
                        ("vocab_size", cfg.vocab_size)):
            if n % tp:
                raise ValueError(
                    f"tp={tp} must divide {what}={n} for sharded serving"
                )

    def shard_config(self, cfg):
        """The config of ONE rank's tp shard: heads, kv heads, MLP hidden
        and vocab over tp, the head dim pinned. What a rank's KV storage is
        allocated from; the forward keeps the full config."""
        self._check_divides(cfg)
        tp = self.tp
        return dataclasses.replace(
            cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
            ffn_hidden=cfg.ffn_hidden // tp,
            vocab_size=cfg.vocab_size // tp,
            head_dim_override=cfg.head_dim,
        )

    def mark(self, model) -> None:
        """Record this rank's tp shard on ``model`` and each of its layers:
        the forward reads the tp group there (``models/llama.py``)."""
        local = model.cfg.vocab_size // self.tp
        model.shard = TPShard(self.tp_group, self.tp, self.tp_rank * local,
                              local)
        for layer in model.layers:
            layer.shard = model.shard

    def shard_leaf(self, name: str, value, transposed: bool = False):
        """This rank's slice of one whole parameter leaf, by its name;
        ``transposed``: a 2-D ``value`` in the other layout (an HF
        projection's ``(out, in)``), cut along the same logical axes."""
        spec = self.param_spec((name,), value.ndim)
        return self._slice(value, spec[::-1] if transposed else spec)

    def _slice(self, value, spec: tuple, offset: int = 0):
        """This rank's slice of ``value`` (a tensor or numpy array) along
        every axis ``spec`` names (shifted by ``offset`` leading dims);
        the value itself when no axis of more than one rank cuts it."""
        return Placement(self.mesh, (None,) * offset + tuple(spec),
                         tuple(value.shape)).slice(value)

    def empty_shard(self, cfg, device):
        """A ``Llama`` of ``cfg`` whose every parameter is this rank's
        piece, uninitialised, on ``device``, with its ``Placement``: what
        ``llama.init_params(plan=)`` fills leaf by leaf."""
        from kubeflow_tpu_torch.models.llama import Llama
        from kubeflow_tpu_torch.models.quant import _set

        self._check_divides(cfg)
        model = Llama(cfg, "meta")
        for name, meta in list(model.named_parameters()):
            pl = self.placement(name, tuple(meta.shape))
            _set(model, name, place(nn.Parameter(
                torch.empty(pl.local_shape, dtype=meta.dtype, device=device),
                requires_grad=False), pl))
        self.mark(model)
        return model

    def cut(self, model) -> None:
        """Cut a whole ``Llama`` (fp8-training weights too) to this rank's
        shard IN PLACE, one leaf at a time: each parameter's data becomes
        its slice (a copy; the whole leaf goes with its last reference)
        and carries its ``Placement``. A parameter that already carries
        one is this plan's piece and stays."""
        self._check_divides(model.cfg)
        with torch.no_grad():
            for name, param in model.named_parameters():
                if placement_of(param) is not None:
                    continue
                pl = self.placement(name, tuple(param.shape))
                piece = pl.slice(param.data)
                if piece is not param.data:
                    param.data = piece.clone()
                del piece
                place(param, pl)
        self.mark(model)

    def shard_params(self, params, cfg=None, device=None):
        """This rank's shard of a full model. A ``Llama`` is sharded IN
        PLACE, leaf by leaf (``cut``), and returned. The bridge's numpy
        tree (JAX's stacked layout; ``cfg`` required) becomes a new
        ``Llama`` on ``device`` built from the tp slices alone (serving's
        path; tp and fsdp cut it alike). Quantized weights raise
        ValueError (``models/quant.refuse_sharding``) before any leaf is
        touched."""
        from kubeflow_tpu_torch.models import quant
        from kubeflow_tpu_torch.models.llama import Llama

        quant.refuse_sharding(params)
        if not isinstance(params, Llama):
            if cfg is None:
                raise ValueError("sharding a numpy tree needs its cfg")
            return self._shard_tree(params, cfg, device)
        shard = getattr(params, "shard", None)
        if shard is not None:
            if shard.size != self.tp:
                raise ValueError(
                    f"params are already sharded at tp={shard.size}, the "
                    f"plan is tp={self.tp}"
                )
            return params
        self.cut(params)
        return params

    def _shard_tree(self, tree: dict, cfg, device):
        """A ``Llama`` of this rank's slices of the bridge's numpy tree:
        each leaf is cut to its ``Placement`` on the host, so only the
        slices reach ``device``."""
        from kubeflow_tpu_torch.device import resolve_device
        from kubeflow_tpu_torch.models import bridge

        model = self.empty_shard(cfg, resolve_device(device))
        want = {name: p for name, p in model.named_parameters()}
        have = {name for name in tree if name != "layers"}
        have |= {f"layers.{i}.{name}"
                 for name, stacked in tree["layers"].items()
                 for i in range(len(stacked))}
        if have != set(want):
            raise ValueError(
                f"the tree's leaves do not match the config: missing "
                f"{sorted(set(want) - have)}, unexpected "
                f"{sorted(have - set(want))}")
        with torch.no_grad():
            for name, param in want.items():
                path = name.split(".")
                value = (tree[name] if len(path) == 1
                         else tree["layers"][path[2]][int(path[1])])
                if isinstance(value, dict):
                    raise ValueError(
                        f"{name}: a sharded serving tree takes plain "
                        "array leaves")
                pl = placement_of(param)
                if tuple(value.shape) != pl.global_shape:
                    raise ValueError(
                        f"{name}: got {tuple(value.shape)}, the config "
                        f"wants {pl.global_shape}")
                piece = bridge._to_torch(pl.slice(value))
                if piece.dtype != param.dtype:
                    raise ValueError(
                        f"{name}: got {piece.dtype}, the model wants "
                        f"{param.dtype}")
                param.copy_(piece)
        return model

    def shard_adapters(self, stacked: dict) -> dict:
        """This rank's view of a stacked LoRA tree ({target: {"a": (N+1,
        L, in, r), "b": (N+1, L, r, out)}}, ``models/multilora.py``): the
        adapters stay whole, and each rank slices what its projection
        needs, B's out columns where tp splits the weight's columns
        (wq/wk/wv/w_gate/w_up) and A's in rows where it splits its rows
        (wo/w_down, whose delta then rides the same all_reduce)."""
        out = {}
        for target, ab in stacked.items():
            spec = self.param_spec((target,), 2)
            side = "b" if spec.index("tp") == 1 else "a"
            out[target] = dict(ab)
            tp_only = tuple(a if a == "tp" else None for a in spec)
            out[target][side] = self._slice(ab[side], tp_only, offset=2)
        return out

    def check_shard(self, params) -> None:
        """Refuse weights that are not this plan's shard. An engine under
        a plan takes the rank's shard, cut once by its caller
        (``llama.init_params(plan=)``, ``convert.load_hf_checkpoint(plan=)``
        or ``shard_params``) over tp and fsdp, and never cuts the caller's
        model itself. Quantized weights raise first, as in
        ``shard_params``."""
        from kubeflow_tpu_torch.models import quant

        quant.refuse_sharding(params)
        shard = getattr(params, "shard", None)
        if shard is None or shard.size != self.tp:
            have = ("whole weights" if shard is None
                    else f"a tp={shard.size} shard")
            raise ValueError(
                f"a tp={self.tp} plan takes this rank's shard of the "
                f"weights, got {have}: build them with init_params(plan=) "
                "or load_hf_checkpoint(plan=), or cut them with "
                "MeshPlan.shard_params"
            )
        pl = placement_of(params.embed)
        fsdp = int(self.mesh.shape.get("fsdp", 1))
        have = 1 if pl is None else int(pl.mesh.shape.get("fsdp", 1))
        if have != fsdp or (pl is not None
                            and dict(pl.mesh.shape) != dict(self.mesh.shape)):
            raise ValueError(
                f"a plan of mesh {self.axes} takes this rank's shard of "
                f"the weights, got one cut over fsdp={have}"
                f"{'' if pl is None else f' on mesh {dict(pl.mesh.shape)}'}"
                ": cut them under this plan")

    def check_kv_heads(self, hkv: int) -> None:
        """The kv-head rule of a head-sharded cache: tp must divide the kv
        heads (a finer split would cut a head in half)."""
        if hkv % max(1, self.tp):
            raise ValueError(
                f"tp={self.tp} must divide n_kv_heads={hkv} for sharded "
                "serving"
            )

    def shard_kv_cache(self, cache: dict, seq_over_sp: bool = False) -> dict:
        """This rank's slice of a stacked KV cache or block pool: the
        kv-head axis (2) over tp, and the sequence axis (3) over sp when
        ``seq_over_sp`` (dense serving caches; a block pool's offset axis
        stays whole), int8 scale leaves (one rank lower, no head dim)
        alike. Raises when tp would split a kv head, the one home of that
        precondition, as in JAX."""
        self.check_kv_heads(next(iter(cache.values())).shape[2])
        spec = (None, None, "tp", "sp" if seq_over_sp else None)
        out = {}
        for name, leaf in cache.items():
            piece = self._slice(leaf, spec)
            out[name] = piece if piece is leaf else piece.clone()
        return out


def _global_shape(t) -> tuple:
    pl = placement_of(t)
    return tuple(t.shape) if pl is None else pl.global_shape
