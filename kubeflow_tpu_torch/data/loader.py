"""Token batch loader: random (batch, seq) windows of a uint32 corpus.

Counterpart of ``kubeflow_tpu/data/loader.py``: the same file format
(flat little-endian uint32), the same xorshift64* stream and the same
O(log n) resume skip, so a stream is a pure function of (corpus, batch,
seq, seed, start_batch) and equals the JAX package's bit for bit, on
either path:

- native (the default): the port's own copy of the C++ prefetcher,
  ``csrc/host/dataloader.cpp``, built with ``g++`` into ``_build/`` at
  first use (``ops/_build.build_host``) and bound with ctypes. It mmaps
  the corpus and assembles batches on a producer thread into a queue of
  ``prefetch`` batches, so batch assembly overlaps the device's work.
- Python (``force_python=True``): the numpy sampler, on the calling
  thread.

``TokenLoader.native`` says which one runs. Where JAX differs: its loader
falls back to the Python path silently when the library does not build
or load, or ``dl_open`` fails; the port raises instead (a build failure
names the build log), and the Python path runs only when asked for.

Sharded training (``device_put_global``, ``sharded_loader``): JAX runs one
process a host over several devices, and a process's rows are its
devices' rows of the global batch. The port runs one process a device,
so a process's identity in the global batch is its BATCH COORDINATE: its
index over the mesh's batch axes (dp · fsdp) and their count. Ranks that
differ only along tp (or any axis that does not split the batch) are one
coordinate and read the same rows, as one JAX host's devices do.
``sharded_loader`` takes it from ``mesh`` when given, else from
``torch.distributed`` (every rank its own coordinate: a mesh of fsdp =
world), else 0 and 1.
"""

from __future__ import annotations

import ctypes
import weakref
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from kubeflow_tpu_torch.ops import _build

_MASK = (1 << 64) - 1
_SRC = _build.HOST_SRC / "dataloader.cpp"
# dl_abi_version() of the library: the arguments declared below.
_ABI_VERSION = 2
_libs: dict[Path, ctypes.CDLL] = {}


def _load_native() -> ctypes.CDLL:
    """The prefetcher's library, built on first use; raises if it does
    not build, load or match ``_ABI_VERSION``."""
    path = _build.build_host(_SRC)
    if path not in _libs:
        lib = ctypes.CDLL(str(path))
        lib.dl_abi_version.restype = ctypes.c_int
        lib.dl_abi_version.argtypes = []
        if lib.dl_abi_version() != _ABI_VERSION:
            raise RuntimeError(f"{path}: dl_abi_version "
                               f"{lib.dl_abi_version()} != {_ABI_VERSION}")
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_uint64, ctypes.c_int,
                                ctypes.c_uint64]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _libs[path] = lib
    return _libs[path]


def write_token_file(path: str | Path, tokens: np.ndarray) -> Path:
    """Persist a token corpus in the loader's format (flat uint32 LE)."""
    path = Path(path)
    np.asarray(tokens, dtype=np.uint32).tofile(path)
    return path


def _xorshift_matrix() -> np.ndarray:
    """The xorshift64 state transition (x^=x>>12; x^=x<<25; x^=x>>27) as
    a 64×64 GF(2) matrix acting on bit-column vectors (bit i = 2**i)."""
    m = np.eye(64, dtype=np.uint8)

    def shift_xor(mat, k):
        # x ^= x >> k (k > 0): bit j of the result has bit j+k mixed in;
        # x ^= x << k (k < 0): bit j has bit j-k mixed in.
        out = mat.copy()
        if k > 0:
            out[: 64 - k] ^= mat[k:]
        else:
            out[-k:] ^= mat[: 64 + k]
        return out

    for k in (12, -25, 27):
        m = shift_xor(m, k)
    return m


def _xorshift_skip(state: int, n: int) -> int:
    """Advance the xorshift64 state by ``n`` transitions in O(log n):
    square-and-multiply over the GF(2) transition matrix. Bit-identical to
    n sequential transitions."""
    if n <= 0:
        return state
    vec = np.array([(state >> i) & 1 for i in range(64)], dtype=np.uint8)
    m = _xorshift_matrix()
    while n:
        if n & 1:
            vec = (m @ vec) & 1
        m = (m @ m) & 1
        n >>= 1
    return int(sum(int(b) << i for i, b in enumerate(vec)))


class TokenLoader:
    """Iterator of (batch, seq) int32 arrays sampled from a token file:
    each row a window starting at ``xorshift64*() % (n_tokens - seq + 1)``.
    ``start_batch`` skips the batches a checkpointed run already consumed
    (the output multiply does not feed the state, so only the xorshift
    transition is advanced, by start_batch·batch steps). ``prefetch`` is
    the native queue's depth; ``force_python`` picks the numpy path."""

    def __init__(self, path: str | Path, batch: int, seq: int, seed: int = 1,
                 prefetch: int = 4, force_python: bool = False,
                 start_batch: int = 0):
        self.path = Path(path)
        if not self.path.exists():
            raise FileNotFoundError(self.path)
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self.batch = batch
        self.seq = seq
        n_tokens = self.path.stat().st_size // 4
        if n_tokens < seq:
            raise ValueError(f"corpus has {n_tokens} tokens < seq={seq}")
        self.n_tokens = n_tokens
        self._lib = self._handle = None
        self._tokens: Optional[np.memmap] = None
        if force_python:
            self._tokens = np.memmap(self.path, dtype=np.uint32, mode="r")
            rng = seed if seed else 0x9E3779B97F4A7C15
            self._rng = _xorshift_skip(rng, start_batch * batch)
            return
        lib = _load_native()
        handle = lib.dl_open(str(self.path).encode(), batch, seq, seed,
                             prefetch, start_batch)
        if not handle:
            raise RuntimeError(
                f"the native loader could not open {self.path} (batch "
                f"{batch}, seq {seq}, prefetch {prefetch})")
        self._lib, self._handle = lib, handle
        # Stops the producer thread and unmaps the corpus even if close()
        # is never called.
        self._finalizer = weakref.finalize(self, lib.dl_close, handle)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def _next_rand(self) -> int:
        x = self._rng
        x ^= (x >> 12)
        x = (x ^ (x << 25)) & _MASK
        x ^= (x >> 27)
        self._rng = x
        return (x * 0x2545F4914F6CDD1D) & _MASK

    def next(self) -> np.ndarray:
        if self._lib is not None:
            if not self._handle:
                raise ValueError("loader is closed")
            out = np.empty((self.batch, self.seq), np.int32)
            if self._lib.dl_next(self._handle, out.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int32))) != 0:
                raise RuntimeError("native loader failed")
            return out
        if self._tokens is None:
            raise ValueError("loader is closed")
        max_start = self.n_tokens - self.seq
        out = np.empty((self.batch, self.seq), np.int32)
        for b in range(self.batch):
            start = self._next_rand() % (max_start + 1)
            out[b] = self._tokens[start:start + self.seq].astype(np.int32)
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def batches(self, n: int) -> Iterator[np.ndarray]:
        for _ in range(n):
            yield self.next()

    def close(self) -> None:
        if self._handle:
            self._finalizer()  # dl_close, once
            self._handle = None
        self._tokens = None  # drops the memmap

    def __enter__(self) -> "TokenLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _process_identity(mesh=None) -> tuple[int, int]:
    """(batch coordinate, count of coordinates): this rank's index over
    ``mesh``'s batch axes and their size; without a mesh, the process
    group's (rank, world size), or (0, 1) with none up."""
    import torch.distributed as dist

    if mesh is not None:
        from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES

        return mesh.axis_index(BATCH_AXES), mesh.axis_size(BATCH_AXES)
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sharded_loader(path: str | Path, global_batch: int, seq: int,
                   seed: int = 1, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None,
                   start_batch: int = 0, mesh=None,
                   **kwargs) -> TokenLoader:
    """Per-process loader for multi-process training: each process loads
    ONLY its global_batch/num_processes rows, from a process-disjoint
    stream (the seed is splitmix-style mixed with the process id). The
    process id and count default to the batch coordinate of ``mesh``
    (``_process_identity``): tp peers read the same rows.

    ``start_batch`` is a GLOBAL batch index (``runtime.checkpoint.
    resume_start_batch`` after ``restore_latest``): every process's stream
    advances by the same count, so a resumed run replays nothing and
    skips nothing. ``kwargs`` go to ``TokenLoader`` (``prefetch``,
    ``force_python``)."""
    env_pid, env_num = _process_identity(mesh)
    pid = env_pid if process_id is None else process_id
    num = env_num if num_processes is None else num_processes
    if global_batch % num != 0:
        raise ValueError(
            f"global_batch {global_batch} not divisible by {num} processes"
        )
    mixed = (seed * 0x9E3779B97F4A7C15 + pid * 0xBF58476D1CE4E5B9) & _MASK
    # Keep the mixed seed nonzero (xorshift fixed point) and in int range.
    mixed = (mixed % ((1 << 63) - 1)) or 1
    return TokenLoader(path, global_batch // num, seq, seed=mixed,
                       start_batch=start_batch, **kwargs)


def device_put_global(local_batch: np.ndarray, mesh, spec, device=None):
    """This process's rows of the GLOBAL batch, as a tensor on ``device``
    (the card unless ``"cpu"`` is asked for) with the global batch's
    ``Placement`` over ``mesh`` and ``spec`` (e.g. ``MeshPlan.batch_spec``)
    beside it: the piece JAX's ``make_array_from_process_local_data``
    puts on this process's device. A rank is one device, so its local
    rows are its whole piece (``sharded_loader`` reads exactly them); the
    global shape is the local one times the axes of ``spec`` a dim.
    ``make_train_step``'s step takes the piece as it is."""
    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.parallel.mesh import Placement, place

    local = np.asarray(local_batch)
    spec = tuple(spec)
    global_shape = tuple(
        n * (mesh.axis_size(spec[d]) if d < len(spec) else 1)
        for d, n in enumerate(local.shape))
    placement = Placement(mesh, spec, global_shape)
    if placement.local_shape != local.shape:
        raise ValueError(
            f"local batch {local.shape} is not this rank's piece "
            f"{placement.local_shape} of {global_shape}")
    dev = resolve_device(device)
    return place(torch.from_numpy(local).to(dev), placement)
