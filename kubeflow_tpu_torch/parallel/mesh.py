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
(the world group itself where an axis spans every rank). ``MeshPlan``
carries the sharding rule of ``param_spec`` and applies its serving half:
``shard_params`` cuts a full ``Llama`` (or the bridge's numpy tree) to
this rank's ``tp`` shard leaf by leaf, and ``shard_kv_cache`` cuts a KV
cache or block pool by kv head.

What differs from JAX:
- ``devices`` are ranks; a rank's device is whatever it was started on
  (``cuda:<local rank>``, one card each, or the CPU under gloo).
- ``shard_params`` shards a ``Llama`` IN PLACE, replacing each leaf by its
  slice as it goes, so the peak extra memory is one leaf, never a second
  model; the caller's module becomes the shard. The engines never
  shard: under a plan they take a shard (``check_shard``), cut once by
  the caller. The qkv biases (qwen2)
  are sliced with their projections' columns, where JAX replicates them
  and GSPMD slices the add.
- Only ``tp`` is applied. ``fsdp``/``dp`` sharding, ``batch_spec``,
  ``logits_spec``, ``param_shardings`` and ``batch_sharding`` (GSPMD
  objects the serving engines do not need) come with sharded training,
  ROADMAP queue 1 item 12; ``sp`` with item 13.
- Quantized and fp8-training weights are refused (``ValueError``) before
  any leaf is touched: JAX's ``device_put`` cannot shard them either (the
  ``(L, 1, out)`` scale of ``wo`` does not divide over ``tp``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

AXES = ("dp", "fsdp", "ep", "pp", "sp", "tp")


def _world() -> tuple[int, int]:
    """(world size, this rank): (1, 0) when no process group is up."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(eq=False)
class Mesh:
    """A grid of ranks with named axes, and this rank's subgroup along
    each axis that needs one (absent for an axis of size 1 short of the
    whole world)."""

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

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        _, rank = _world()
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in this mesh")
        return int(where[0][self.axis_names.index(axis)])

    def group(self, axis: str):
        return self.groups.get(axis)


def _mesh_over(ranks: list, names: tuple, sizes: tuple) -> Mesh:
    """The rank grid of ``sizes`` over ``ranks`` and its axis subgroups.
    Every rank of the world must call this with the same arguments:
    ``torch.distributed.new_group`` is collective over the world. With no
    process group up it is the grid alone (a description, as a JAX mesh
    over devices this process does not drive)."""
    grid = np.asarray(ranks, dtype=np.int64).reshape(sizes)
    world, rank = _world()
    groups: dict = {}
    up = world > 1 or (torch.distributed.is_available()
                       and torch.distributed.is_initialized())
    for ax, name in enumerate(names):
        # Every line of the grid along this axis is one group; all ranks
        # create all of them, in the same order. An axis that spans the
        # whole world is the world group (of one rank, too, when a group
        # is up: its collectives then run over that backend); any other
        # axis of size 1 needs none.
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in lines:
            members = [int(r) for r in line]
            if up and sorted(members) == list(range(world)):
                group = torch.distributed.group.WORLD
            elif sizes[ax] == 1 or not up:
                continue  # no group needed, or none to make one in
            else:
                group = torch.distributed.new_group(ranks=members)
            if rank in members:
                groups[name] = group
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


_COL_LEAVES = ("wq", "wk", "wv", "w_gate", "w_up")
_ROW_LEAVES = ("wo", "w_down")
_BIAS_LEAVES = ("bq", "bk", "bv")


@dataclasses.dataclass
class TPShard:
    """What a rank's ``Llama`` (and each of its layers) carries under a tp
    plan: the tp group, its degree, and the slice of the vocabulary its
    embedding rows cover."""

    group: object
    size: int
    vocab_lo: int
    vocab_local: int


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

    # -- parameters --------------------------------------------------------
    def param_spec(self, path: tuple, value_ndim: int) -> tuple:
        """Sharding rule for a llama-family parameter by its path, as a
        tuple of axis names (None = unsharded) over the leaf as the port
        holds it (one layer, no stacked layer axis). tp shards the
        head/hidden output dimension and the vocab; fsdp the input
        dimension."""
        del value_ndim
        name = "/".join(str(p) for p in path)
        if "fp8" in path:
            # fp8 delayed-scaling histories: a few floats, replicated (the
            # projection match below must not see "wq" in "wq/fp8/...").
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

    def check_serving(self) -> None:
        """Refuse the axes serving does not shard yet."""
        if any(self.mesh.shape.get(ax, 1) > 1 for ax in ("dp", "fsdp")):
            raise NotImplementedError(
                f"mesh {self.axes}: dp/fsdp sharding is not ported to "
                "PyTorch yet (sharded training, ROADMAP queue 1 item 12)"
            )
        if any(self.mesh.shape.get(ax, 1) > 1 for ax in ("sp", "pp", "ep")):
            raise NotImplementedError(
                f"mesh {self.axes}: sp/pp/ep are not ported to PyTorch yet "
                "(ROADMAP queue 1 item 13)"
            )

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
        """The config of ONE rank's shard: heads, kv heads, MLP hidden and
        vocab over tp, the head dim pinned. What a rank's KV storage is
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
        """Record this rank's shard on ``model`` and each of its layers:
        the forward reads the tp group there (``models/llama.py``)."""
        local = model.cfg.vocab_size // self.tp
        model.shard = TPShard(self.tp_group, self.tp, self.tp_rank * local,
                              local)
        for layer in model.layers:
            layer.shard = model.shard

    def shard_leaf(self, name: str, value, transposed: bool = False):
        """This rank's slice of one whole parameter leaf, by its name;
        ``transposed``: a 2-D ``value`` in the other layout (an HF
        projection's ``(out, in)``), cut along the same logical axis."""
        spec = self.param_spec((name,), value.ndim)
        return self._slice(value, spec[::-1] if transposed else spec)

    def _slice(self, value, spec: tuple, offset: int = 0):
        """This rank's tp slice of ``value`` (a tensor or numpy array)
        along the axis ``spec`` names ``"tp"`` (shifted by ``offset``
        leading axes); the value itself when tp does not shard it."""
        if "tp" not in spec or self.tp == 1:
            return value
        axis = spec.index("tp") + offset
        n = value.shape[axis] // self.tp
        index = [slice(None)] * value.ndim
        index[axis] = slice(self.tp_rank * n, (self.tp_rank + 1) * n)
        return value[tuple(index)]

    def shard_params(self, params, cfg=None, device=None):
        """This rank's tp shard of a full model. A ``Llama`` is sharded IN
        PLACE, leaf by leaf (each full leaf is released as its slice
        replaces it), and returned. The bridge's numpy tree (JAX's stacked
        layout; ``cfg`` required) becomes a new ``Llama`` on ``device``
        built from the slices alone. Quantized weights raise ValueError
        (``models/quant.refuse_sharding``) before any leaf is touched."""
        from kubeflow_tpu_torch.models import quant
        from kubeflow_tpu_torch.models.llama import Llama

        self.check_serving()
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
        cfg = params.cfg
        self._check_divides(cfg)
        # A layer already sharded (one a truncated draft shares with its
        # sharded target) keeps its slices.
        owners = [params] + [layer for layer in params.layers
                             if layer.shard is None]
        with torch.no_grad():
            for owner in owners:
                for leaf, param in list(owner._parameters.items()):
                    if param is None:
                        continue
                    piece = self.shard_leaf(leaf, param.data)
                    if piece is param.data:  # replicated, or tp 1
                        continue
                    # The slice's copy replaces the full leaf, which goes
                    # with its last reference: at most one leaf extra.
                    setattr(owner, leaf, nn.Parameter(
                        piece.clone(), requires_grad=param.requires_grad))
                    del param, piece
        self.mark(params)
        return params

    def _shard_tree(self, tree: dict, cfg, device):
        from kubeflow_tpu_torch.models import bridge

        self._check_divides(cfg)
        local = {name: self.shard_leaf(name, value)
                 for name, value in tree.items() if name != "layers"}
        # Stacked layer leaves: the spec is over one layer, axis 0 is L.
        local["layers"] = {
            name: self._slice(value, self.param_spec(("layers", name),
                                                     value.ndim - 1),
                              offset=1)
            for name, value in tree["layers"].items()
        }
        model = bridge.params_from_jax(local, self.shard_config(cfg),
                                       device=device)
        model.cfg = cfg
        self.mark(model)
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
            out[target][side] = self._slice(ab[side], spec, offset=2)
        return out

    def check_shard(self, params) -> None:
        """Refuse weights that are not this plan's shard. An engine under
        a plan takes the rank's shard, cut once by its caller
        (``llama.init_params(plan=)``, ``convert.load_hf_checkpoint(
        plan=)`` or ``shard_params``), and never cuts the caller's model
        itself. Quantized weights raise first, as in ``shard_params``."""
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

    def check_kv_heads(self, hkv: int) -> None:
        """The kv-head rule of a head-sharded cache: tp must divide the kv
        heads (a finer split would cut a head in half)."""
        if hkv % max(1, self.tp):
            raise ValueError(
                f"tp={self.tp} must divide n_kv_heads={hkv} for sharded "
                "serving"
            )

    def shard_kv_cache(self, cache: dict) -> dict:
        """This rank's slice of a stacked KV cache or block pool: the
        kv-head axis (2) over tp, int8 scale leaves (one rank lower)
        alike. Raises when tp would split a kv head, the one home of that
        precondition, as in JAX. JAX's ``seq_over_sp`` comes with the
        sequence-parallel caches (ROADMAP queue 1 item 13)."""
        tp = self.tp
        self.check_kv_heads(next(iter(cache.values())).shape[2])
        return {name: self._slice(leaf, (None, None, "tp")).clone()
                if tp > 1 else leaf for name, leaf in cache.items()}
