"""In-notebook bootstrap of the port: its place in the slice, the
process group, and the SIGTERM emergency checkpoint.

The counterpart of ``kubeflow_tpu/runtime/bootstrap.py``. A notebook on a
GPU node starts with

    from kubeflow_tpu_torch.runtime import bootstrap, install_preemption_handler
    rt = bootstrap()                      # torch.distributed when multi-host
    ckpt = CheckpointManager(checkpoint_dir_from_env(), async_save=True,
                             process_index=rt.rank,
                             process_count=rt.world_size)
    install_preemption_handler(ckpt)      # SIGTERM → one final save

What differs from JAX:
- ``bootstrap`` takes ``device``: ``None`` is the card and raises without
  one; ``"cpu"`` runs on the CPU (``device.resolve_device``). On several
  hosts it calls ``torch.distributed.init_process_group`` over
  ``tcp://<JAX_COORDINATOR_ADDRESS>``: NCCL on the card, gloo on the
  CPU. A second call finds the group up and does not init again (torch
  raises on a second init).
- JAX drives all of a host's chips from one process; the port drives one
  card a process. ``JAX_NUM_PROCESSES`` still counts hosts, and
  ``TPU_CHIPS_PER_HOST_BOUNDS`` gives the cards a host
  (``SliceRuntime.cards_per_host``). On several hosts of several cards,
  each card's process passes ``bootstrap(local_rank=i)``: its rank is
  ``process_id × cards_per_host + i`` of ``num_workers × cards_per_host``
  and its card ``cuda:i``. Without ``local_rank`` there it raises.
  Otherwise the rank is ``process_id``.
- The device count is ``world size × local devices`` (or the local count
  on one process), or the world size when each rank has one card
  (``local_rank``), where JAX reads ``jax.device_count()``.
- There is no ``honor_jax_platforms_env``: torch has no platform setting
  to route; the device is what ``device`` names.
- ``SliceRuntime.mesh`` checks the axis sizes as JAX does and returns a
  ``parallel/mesh.py`` Mesh over the process group's ranks (one device
  each), its axes named and ordered as given, as JAX's are.
- ``maybe_start_profiler_server`` refuses a valid port: torch has no
  counterpart of ``jax.profiler.start_server``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
from typing import Optional

import torch

from kubeflow_tpu_torch.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.runtime import env as contract

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SliceRuntime:
    """Resolved view of this host's place in the slice (or multislice)."""

    worker_id: int  # slice-local worker id (TPU_WORKER_ID)
    num_workers: int  # processes across all slices
    worker_hostnames: list[str]
    coordinator_address: str  # "" on single-host slices
    accelerator_type: str
    topology: str
    slice_id: int = 0
    num_slices: int = 1
    hosts_per_slice: int = 1
    distributed_initialized: bool = False
    # Cards on one host: the product of TPU_CHIPS_PER_HOST_BOUNDS.
    cards_per_host: int = 1
    # The device ``bootstrap`` resolved; None until then.
    device: Optional[torch.device] = dataclasses.field(
        default=None, compare=False)
    # This process's card on its host when it drives one card of several
    # (``bootstrap(local_rank=)``); None when it is the host's only
    # process.
    local_rank: Optional[int] = dataclasses.field(
        default=None, compare=False)

    @property
    def is_multi_host(self) -> bool:
        return self.num_workers > 1

    @property
    def process_id(self) -> int:
        """Global process id (the torch.distributed rank): slices are laid
        out contiguously, so slice j's workers are [j*hosts, (j+1)*hosts)."""
        return self.slice_id * self.hosts_per_slice + self.worker_id

    @property
    def is_coordinator(self) -> bool:
        return self.slice_id == 0 and self.worker_id == 0

    @property
    def rank(self) -> int:
        """The torch.distributed rank: ``process_id``, or with one process
        a card, the host's ranks laid out contiguously
        (``process_id × cards_per_host + local_rank``)."""
        if self.local_rank is None:
            return self.process_id
        return self.process_id * self.cards_per_host + self.local_rank

    @property
    def world_size(self) -> int:
        """Ranks in the process group: a host's or a card's each."""
        if self.local_rank is None:
            return self.num_workers
        return self.num_workers * self.cards_per_host

    def mesh(self, **axis_sizes: int):
        """A mesh over the whole slice: ``axis_sizes`` must multiply to the
        global device count (a single -1 is inferred), as in JAX's
        ``rt.mesh``. Example: ``rt.mesh(dp=2, tp=8)`` on 16 cards. Every
        rank calls it together (the axis subgroups are collective)."""
        from kubeflow_tpu_torch.parallel.mesh import _mesh_over, _world

        total = global_device_count(self.device,
                                    one_per_rank=self.local_rank is not None)
        sizes = mesh_axes(axis_sizes, total)
        world = _world()[0]
        if world != total:
            raise ValueError(
                f"mesh {sizes}: the port drives one device per rank, and "
                f"this process group has {world} rank(s) for {total} "
                "devices; start one process per card"
            )
        return _mesh_over(list(range(world)), tuple(sizes),
                          tuple(sizes.values()))


def mesh_axes(axis_sizes: dict, total: int) -> dict:
    """{axis: size} with a single -1 inferred from ``total`` devices; the
    sizes must multiply to ``total``. ValueError as JAX words it."""
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        if total % known != 0:
            raise ValueError(
                f"cannot infer axis: {total} devices not divisible by {known}")
        sizes[sizes.index(-1)] = total // known
    prod = 1
    for s in sizes:
        prod *= s
    if prod != total:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} multiply to {prod}, "
            f"but the slice has {total} devices")
    return dict(zip(names, sizes))


def global_device_count(device: DeviceLike = None,
                        one_per_rank: bool = False) -> int:
    """Devices across the process group: the world size times this
    process's devices (the visible cards, or 1 for the CPU, or 1 when
    each rank drives one card), or this process's alone when no group is
    up."""
    dev = resolve_device(device)
    local = (torch.cuda.device_count()
             if dev.type == "cuda" and not one_per_rank else 1)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() * local
    return local


def runtime_from_env(env: Optional[dict] = None) -> SliceRuntime:
    """Parse the controller/webhook-injected environment into a
    SliceRuntime (multislice-aware: MEGASCALE_* + TPU_HOSTS_PER_SLICE).
    ``cards_per_host`` is the product of TPU_CHIPS_PER_HOST_BOUNDS, 1
    when it is unset. A value that is not an integer raises ValueError."""
    env = dict(os.environ) if env is None else env
    hostnames_raw = env.get(contract.TPU_WORKER_HOSTNAMES, "")
    hostnames = [h for h in hostnames_raw.split(",") if h]
    hosts_per_slice = int(
        env.get(contract.TPU_HOSTS_PER_SLICE) or str(max(1, len(hostnames))))
    num_slices = int(env.get(contract.MEGASCALE_NUM_SLICES, "1") or 1)
    num = int(
        env.get(contract.JAX_NUM_PROCESSES) or str(hosts_per_slice * num_slices))
    cards = 1
    for bound in (env.get(contract.TPU_CHIPS_PER_HOST_BOUNDS) or "1").split(","):
        cards *= int(bound)
    return SliceRuntime(
        worker_id=int(env.get(contract.TPU_WORKER_ID, "0") or 0),
        num_workers=num,
        worker_hostnames=hostnames,
        coordinator_address=env.get(contract.JAX_COORDINATOR_ADDRESS, ""),
        accelerator_type=env.get(contract.TPU_ACCELERATOR_TYPE, ""),
        topology=env.get(contract.TPU_TOPOLOGY, ""),
        slice_id=int(env.get(contract.MEGASCALE_SLICE_ID, "0") or 0),
        num_slices=num_slices,
        hosts_per_slice=hosts_per_slice,
        cards_per_host=cards,
    )


def bootstrap(
    env: Optional[dict] = None,
    expected_devices: Optional[int] = None,
    initialize_distributed: bool = True,
    device: DeviceLike = None,
    local_rank: Optional[int] = None,
) -> SliceRuntime:
    """Bring the slice up: ``torch.distributed`` over the coordinator when
    the group has several ranks, then sanity-check the device count.

    ``local_rank`` is this process's card on its host. The pod's env
    describes hosts, and the port drives one card a process, so on a host
    of several cards something must start a process a card and tell each
    its index: the notebook's own launcher, for example ``torchrun
    --nproc-per-node=<cards>`` (its ``LOCAL_RANK``) or one
    ``multiprocessing`` spawn a card, inside the one pod of the host.
    Neither the webhook nor the controller starts them. On several hosts
    of several cards ``local_rank`` is required: without it this raises
    ValueError rather than drive one card a host. With it the rank is
    ``process_id × cards_per_host + local_rank``, the world
    ``num_workers × cards_per_host`` and the device ``cuda:local_rank``
    (unless ``device`` names another). Without it, one process a host, as
    JAX runs.

    Idempotent per process; safe to re-run in a notebook cell."""
    rt = runtime_from_env(env)
    if local_rank is None and rt.is_multi_host and rt.cards_per_host > 1:
        raise ValueError(
            f"this pod's host has {rt.cards_per_host} cards "
            f"({contract.TPU_CHIPS_PER_HOST_BOUNDS}) in a slice of "
            f"{rt.num_workers} hosts, and the port drives one card a "
            "process: start one process a card and pass each its card as "
            f"bootstrap(local_rank=0..{rt.cards_per_host - 1})")
    if local_rank is not None:
        if not 0 <= local_rank < rt.cards_per_host:
            raise ValueError(
                f"local_rank={local_rank}: this pod's host has "
                f"{rt.cards_per_host} card(s), 0..{rt.cards_per_host - 1}")
        rt.local_rank = local_rank
        if device is None:
            device = torch.device("cuda", local_rank)
    dev = resolve_device(device)
    rt.device = dev
    if rt.world_size > 1 and initialize_distributed:
        dist = torch.distributed
        if not dist.is_initialized():
            if dev.type == "cuda" and rt.local_rank is not None:
                torch.cuda.set_device(dev)  # NCCL binds the current card
            dist.init_process_group(
                backend="nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{rt.coordinator_address}",
                world_size=rt.world_size,
                rank=rt.rank,
            )
        # Up now, or already up from an earlier run of the cell.
        rt.distributed_initialized = True
    if expected_devices is not None:
        actual = global_device_count(dev,
                                     one_per_rank=rt.local_rank is not None)
        if actual != expected_devices:
            raise RuntimeError(
                f"slice incomplete: expected {expected_devices} devices, "
                f"the process group sees {actual}. A host may be missing "
                "(check Notebook status.tpu.readyHosts) or "
                "torch.distributed did not reach every worker.")
    maybe_start_profiler_server(env)
    return rt


def maybe_start_profiler_server(env: Optional[dict] = None) -> Optional[int]:
    """None when KUBEFLOW_TPU_PROFILING_PORT is unset; ValueError when it
    is not a port in 1024..65535; NotImplementedError for a valid port,
    which JAX would serve through ``jax.profiler.start_server``."""
    env = dict(os.environ) if env is None else env
    value = env.get(contract.PROFILING_ENV_NAME, "")
    if not value:
        return None
    port = contract.parse_profiling_port(value)
    if port is None:
        raise ValueError(
            f"{contract.PROFILING_ENV_NAME}={value!r}: not a port in "
            "1024..65535")
    raise NotImplementedError(
        f"{contract.PROFILING_ENV_NAME}={port}: the PyTorch port has no "
        "profiler server (torch has no counterpart of "
        "jax.profiler.start_server); unset it and capture with "
        "torch.profiler in the notebook instead")


# -- preemption-grace emergency checkpointing --------------------------------
#
# The controller's escalation ladder (or node maintenance) kills a host with
# SIGTERM and waits terminationGracePeriodSeconds before SIGKILL. The
# webhook said how much of that window is ours (TPU_CHECKPOINT_GRACE_S) and
# where checkpoints live (KUBEFLOW_TPU_CHECKPOINT_DIR); the handler below
# spends the budget on ONE final synchronous save, or nothing when a fresh
# save already exists or could not finish in time.


def checkpoint_dir_from_env(env: Optional[dict] = None) -> Optional[str]:
    """The webhook-projected checkpoint directory, or None off-platform."""
    env = dict(os.environ) if env is None else env
    return env.get(contract.CHECKPOINT_DIR_ENV_NAME) or None


def checkpoint_grace_from_env(env: Optional[dict] = None) -> Optional[int]:
    """The emergency-save grace budget in seconds, or None when unset (a
    value admission would have denied is treated as unset, never honoured
    half-way)."""
    env = dict(os.environ) if env is None else env
    value = env.get(contract.CHECKPOINT_GRACE_ENV_NAME, "")
    return contract.parse_checkpoint_grace(value) if value else None


def install_preemption_handler(ckpt, env: Optional[dict] = None,
                               signum: Optional[int] = None):
    """Install a SIGTERM handler that runs ``ckpt.emergency_save`` with
    the webhook-injected grace budget, then chains to the previously
    installed disposition: a callable is called, ``SIG_DFL`` is restored
    and the signal raised again (the process dies of it), ``SIG_IGN`` is
    honoured (the process lives on).

    Returns an ``uninstall()`` callable restoring the previous handler.
    Must run on the main thread. The save runs on a thread of its own,
    which the handler joins for the grace plus 5 s: the signal may have
    interrupted the main thread inside ``queue.Queue.put``'s mutex, which
    a save in handler context would then deadlock on. The save does no
    CUDA work: the state it writes is the host snapshot ``save`` took."""
    import signal

    signum = signal.SIGTERM if signum is None else signum
    grace = checkpoint_grace_from_env(env)
    previous = signal.getsignal(signum)

    def handle(received_signum, frame):
        def run():
            try:
                ckpt.emergency_save(grace_s=grace)
            except Exception:
                # The exit path must keep exiting: a save bug cannot
                # swallow the termination signal.
                log.exception("emergency checkpoint save failed")

        saver = threading.Thread(
            target=run, name="emergency-checkpoint", daemon=True)
        saver.start()
        saver.join(None if grace is None else float(grace) + 5.0)
        if saver.is_alive():
            log.error("emergency checkpoint save still running past the "
                      "grace budget; proceeding with termination")
        if callable(previous):
            previous(received_signum, frame)
        elif previous is signal.SIG_DFL:
            signal.signal(received_signum, signal.SIG_DFL)
            signal.raise_signal(received_signum)
        # SIG_IGN: the process had opted out of dying on this signal.

    signal.signal(signum, handle)
    log.info("installed emergency-checkpoint handler (signal %d, grace %s)",
             signum, f"{grace}s" if grace is not None else "unbounded")

    def uninstall():
        if signal.getsignal(signum) is handle:
            signal.signal(signum, previous)

    return uninstall
