"""Sharded serving replicas: a replica is a MESH of ranks, not one card.

Counterpart of ``kubeflow_tpu/models/tp_serving.py``. The serving engines
(``PagedBatcher`` ragged and alternating, ``ContinuousBatcher``, both
speculative engines, ``MultiLoraPagedBatcher``) take a ``plan=`` MeshPlan
over tp, fsdp and dp: the weights are cut on the ``tp`` axis (attention
heads, MLP hidden, vocab) and on ``fsdp`` (their dim axis, gathered where
each leaf is used), the KV pool or cache holds the rank's kv heads (so a
rank's pool bytes drop by the tp degree), and the forward runs the two
``all_reduce`` s GSPMD inserts in JAX, after ``wo`` and after ``w_down``
(``models/llama.py``). As in JAX, the step is replicated over dp and fsdp:
every rank of those axes computes the same batch (JAX's engines never
place theirs with ``batch_sharding``). A replica of any such mesh gives
the one-rank engine's tokens.

What differs from JAX: the JAX replica is ONE process driving N devices.
The port's is N processes, one rank and one device each, in lockstep.
Every rank runs the same engine, its host bookkeeping included (the
allocator, block tables, chain keys, the sampling generator); the inputs
are the same everywhere and the logits are gathered to full width before
sampling, so every rank takes the same host decisions. The mesh's first
rank alone takes requests (``leads``): ``TPReplica`` is its facade over
the engine, and it mirrors each engine call that changes state
(``submit``, ``cancel``, ``drive_once``/``run``, the KV exports and
imports, ``mark_kv_export``) to every other rank of the mesh, over dp,
fsdp and tp alike, before running the call itself, with one
``broadcast_object_list`` a call over a gloo CONTROL group (gloo on the
CPU and on cards alike: host metadata, as vLLM keeps it). The other ranks
sit in ``follow(engine, plan)``, the loop that replays those calls. Tensor
collectives run on the plan's tp group: gloo on the CPU, NCCL where each
rank has a card. After each call the ranks compare how it ended (returned,
or the exception's type and text); a rank that ended otherwise breaks the
replica: rank 0 raises from then on and the follower exits. This is the
port's counterpart of JAX's single controller, not a new feature.

The engines' clock is the same on every rank too: a ``LockstepClock``
that reads rank 0's ``time.monotonic()`` as of the start of the mirrored
call, so a deadline expires at the same step everywhere (at most one
drive quantum after it would on one rank). The flight recorder, which
times the quanta, runs on rank 0's real clock in ``TPReplica``.

Hazard: any path on which rank 0 alone issues a tensor collective
deadlocks (rank 0 waits in the gather; the others wait for the next
call). ``export_blocks`` and ``export_chain`` gather heads, so they are
mirrored; the server's ``/kv/prefill`` cuts its payload inside the
``on_token`` hook, during a mirrored ``drive_once``, so it first marks
the request (``mark_kv_export``, mirrored) and every rank cuts the payload
at that request's first token. ``/stats`` and the other readers touch
local state only.

Fail-fast validation (``validate_serving_tp``, ``serving_plan``) keeps
JAX's messages; on the card the device count is
``torch.cuda.device_count()``, so a one-card host refuses tp=2.
``replica_device_groups`` carves a host's cards into tp-sized groups.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

import torch

from kubeflow_tpu_torch.parallel.mesh import MeshPlan, _world, make_mesh

# A follower can wait for the next call as long as the replica is idle.
_CONTROL_TIMEOUT = datetime.timedelta(days=365)


def validate_serving_tp(cfg, tp: int, n_devices: Optional[int] = None) -> int:
    """Fail-fast validation of a serving TP degree against a model config
    (and optionally the visible device count). Returns the degree. Raises
    ValueError with an operator-actionable message, before the replica
    takes traffic. The kv-head rule is the hard one (a finer-than-head
    split silently corrupts attention; ``MeshPlan.check_kv_heads`` checks
    it again where the pool is built)."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"serving tp degree must be >= 1, got {tp}")
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads}: the paged "
            "pool shards by kv head, and a finer split would cut a head "
            "in half"
        )
    if cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads}: query heads "
            "partition over the tp axis"
        )
    if n_devices is not None and tp > n_devices:
        raise ValueError(
            f"tp={tp} needs {tp} devices, have {n_devices}"
        )
    return tp


def serving_plan(tp: int, devices=None, cfg=None) -> Optional[MeshPlan]:
    """The one-replica serving mesh: a pure-tp MeshPlan over the first
    ``tp`` ranks of the process group (or the given rank list). tp=1
    returns None, the one-rank engine with no plan path, so callers can
    pass the result straight to ``plan=``. ``cfg`` opts into the model
    shape validation up front. Every rank calls it together."""
    tp = int(tp)
    if cfg is not None:
        validate_serving_tp(
            cfg, tp,
            n_devices=len(devices) if devices is not None else None,
        )
    if tp <= 1:
        return None
    pool = list(devices) if devices is not None else list(
        range(_world()[0]))
    if len(pool) < tp:
        raise ValueError(
            f"serving tp={tp} needs {tp} devices, have {len(pool)}"
        )
    return MeshPlan(make_mesh(tp=tp, devices=pool[:tp]))


def replica_device_groups(tp: int, devices=None) -> list:
    """Carve the visible cards into disjoint tp-sized replica groups: N
    cards host N // tp replicas, each one HTTP endpoint. Remainder cards
    (len % tp) are left out rather than forming a ragged replica. The
    default is this host's cards, ``cuda:0`` .. ``cuda:n-1``."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    pool = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [pool[i:i + tp] for i in range(0, len(pool) - tp + 1, tp)]


class LockstepClock:
    """The engines' clock on every rank of a replica: rank 0's monotonic
    time as of the start of the current mirrored call."""

    def __init__(self) -> None:
        self.now = time.monotonic()

    def __call__(self) -> float:
        return self.now


def leads(plan: MeshPlan) -> bool:
    """True on the replica's first rank, the one that answers over HTTP
    through ``TPReplica``; every other rank of the mesh, over dp, fsdp and
    tp alike, ``follow``s it."""
    return _world()[1] == int(plan.mesh.ranks.reshape(-1)[0])


def control_group(plan: MeshPlan):
    """The replica's gloo control group, over its ranks. Collective:
    rank 0's ``TPReplica`` and every ``follow`` create it together."""
    ranks = [int(r) for r in plan.mesh.ranks.reshape(-1)]
    return torch.distributed.new_group(ranks=ranks, backend="gloo",
                                       timeout=_CONTROL_TIMEOUT)


def _loop_engine(engine):
    """The engine that owns the queue, slots and drive loop: a speculative
    wrapper's inner batcher, else the engine itself."""
    return getattr(engine, "_engine", engine)


def _resolve(engine, path: tuple):
    for name in path:
        engine = getattr(engine, name)
    return engine


def _status(err: Optional[BaseException]) -> Optional[str]:
    return None if err is None else f"{type(err).__name__}: {err}"


class _ExportMarks:
    """The requests whose KV payload every rank cuts at their first token
    (the server's ``/kv/prefill``): on_token exports a marked request,
    and retirement or abort forgets a mark its token never came for."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.marks: dict = {}

    def on_token(self, rid: int):
        """The export of a marked ``rid`` as ("ok", payload) or ("err",
        exception); None for an unmarked one."""
        skip = self.marks.pop(rid, None)
        if skip is None:
            return None
        try:
            return "ok", self.engine.export_blocks(rid, skip_keys=skip)
        except Exception as err:  # rank 0 answers it as the hop's failure
            return "err", err

    def forget(self, rid: int) -> None:
        self.marks.pop(rid, None)


_MIRRORED = frozenset({
    "submit", "cancel", "drive_once", "run", "import_blocks",
    "export_blocks", "export_chain", "import_chain",
})
_HOOKS = ("on_token", "on_retire", "on_abort", "on_admit")


class _Channel:
    """One rank's end of a replica's control group, over one engine: the
    lockstep clock and export marks installed on the engine, and on rank
    0 the call lock and depth its facades share."""

    def __init__(self, engine, plan: MeshPlan) -> None:
        self.group = control_group(plan)
        self.src = int(plan.mesh.ranks.reshape(-1)[0])
        self.size = plan.mesh.size
        self.lock = threading.RLock()
        self.depth = 0
        self.broken: Optional[str] = None
        self.closed = False
        self.clock = LockstepClock()
        loop = _loop_engine(engine)
        loop._clock = self.clock
        self.marks = _ExportMarks(loop)
        self.exported: dict = {}

    def send(self, msg: tuple) -> None:
        torch.distributed.broadcast_object_list([msg], src=self.src,
                                                group=self.group)

    def recv(self) -> tuple:
        box = [None]
        torch.distributed.broadcast_object_list(box, src=self.src,
                                                group=self.group)
        return box[0]

    def agree(self, name: str, err: Optional[BaseException]) -> None:
        """Compare how the call ended on every rank; a difference breaks
        the replica."""
        ends = [None] * self.size
        torch.distributed.all_gather_object(ends, _status(err),
                                            group=self.group)
        if any(e != ends[0] for e in ends):
            self.broken = (f"tensor-parallel replica ranks diverged on "
                           f"{name}: {ends}")
            raise RuntimeError(self.broken) from err

    def call(self, target, path: tuple, name: str, args, kwargs):
        with self.lock:
            if self.broken is not None:
                raise RuntimeError(self.broken)
            if self.closed:
                raise RuntimeError("tensor-parallel replica is closed")
            method = getattr(_resolve(target, path), name)
            if self.depth:
                # Inside a mirrored call (a hook during drive_once): the
                # other ranks are at the same point of the same call.
                return method(*args, **kwargs)
            self.exported.clear()
            self.clock.now = time.monotonic()
            self.send(("call", path, name, args, kwargs, self.clock.now))
            self.depth += 1
            err = result = None
            try:
                result = method(*args, **kwargs)
            except Exception as e:
                err = e
            finally:
                self.depth -= 1
            self.agree(name, err)
            if err is not None:
                raise err
            return result


class TPReplica:
    """Rank 0's facade over a tensor-parallel replica's engine: reads go
    to the local engine; each call that changes engine state is mirrored
    to the other ranks (``follow``) first. Give it to ``InferenceServer``
    as the engine. ``close()`` releases the followers.

    >>> params = init_params(cfg, gen, device, plan=plan)  # the rank's
    >>> eng = PagedBatcher(params, cfg, plan=plan, ...)   # every rank
    >>> if leads(plan):
    ...     srv = InferenceServer(TPReplica(eng, plan), port=8000).start()
    ... else:
    ...     follow(eng, plan)
    """

    def __init__(self, engine, plan: MeshPlan, _channel=None,
                 _path: tuple = ()):
        object.__setattr__(self, "_target", engine)
        object.__setattr__(self, "_path", _path)
        object.__setattr__(self, "_hooks", {})
        object.__setattr__(self, "flight", None)
        # The flight recorder and the server time quanta on the real clock.
        object.__setattr__(self, "_clock", time.monotonic)
        object.__setattr__(self, "_ch", _channel or _Channel(engine, plan))
        object.__setattr__(self, "_plan", plan)

    def __getattr__(self, name):
        engine = _resolve(self._target, self._path)
        if name == "_engine" and hasattr(engine, "_engine"):
            # A speculative wrapper's inner batcher, mirrored as well.
            return TPReplica(self._target, self._plan, self._ch,
                             self._path + ("_engine",))
        if name in _MIRRORED:
            def mirrored(*args, **kwargs):
                return self._ch.call(self._target, self._path, name, args,
                                     kwargs)
            return mirrored
        return getattr(engine, name)

    def __setattr__(self, name, value):
        engine = _resolve(self._target, self._path)
        if name == "flight":
            object.__setattr__(self, "flight", value)
        elif name in _HOOKS:
            self._hooks[name] = value
            setattr(engine, name, self._hook(name))
        else:
            raise AttributeError(
                f"{name!r} cannot be set on a tensor-parallel replica: "
                "every rank's engine must stay the same"
            )

    def _hook(self, name):
        """The engine-side hook: the marks first (the same on every rank),
        then the caller's hook."""
        ch = self._ch

        def hook(rid, *rest):
            if name == "on_token":
                done = ch.marks.on_token(rid)
                if done is not None:
                    ch.exported[rid] = done
            elif name in ("on_retire", "on_abort"):
                ch.marks.forget(rid)
            user = self._hooks.get(name)
            if user is not None:
                user(rid, *rest)

        return hook

    def mark_kv_export(self, rid: int, skip_keys) -> None:
        """Have every rank cut ``rid``'s KV payload at its first token;
        rank 0's ``export_blocks`` inside that token's hook then returns
        it."""
        skip = list(skip_keys)
        ch = self._ch
        with ch.lock:
            if ch.broken is not None:
                raise RuntimeError(ch.broken)
            ch.send(("mark", rid, skip))
            ch.marks.marks[rid] = skip

    def export_blocks(self, rid: int, skip_keys=()):
        ch = self._ch
        with ch.lock:
            if ch.depth and rid in ch.exported:
                kind, value = ch.exported.pop(rid)
                if kind == "err":
                    raise value
                return value
        return ch.call(self._target, self._path, "export_blocks",
                       (rid,), {"skip_keys": skip_keys})

    def drive_once(self) -> None:
        """One mirrored drive quantum, timed on rank 0's real clock for
        the flight recorder (the engine's own clock is the lockstep one)."""
        t0 = time.monotonic()
        try:
            self._ch.call(self._target, self._path, "drive_once", (), {})
        finally:
            if self.flight is not None:
                engine = _resolve(self._target, self._path)
                if self.flight.record_step(time.monotonic() - t0,
                                           engine.last_step.get("fill")):
                    engine.last_step["stalled"] = True

    def close(self) -> None:
        """Release the followers (their ``follow`` returns). Idempotent."""
        ch = self._ch
        with ch.lock:
            if ch.closed:
                return
            ch.closed = True
            if ch.broken is None:
                ch.send(("stop",))


def follow(engine, plan: MeshPlan) -> None:
    """A follower rank's loop: replay rank 0's mirrored calls on this
    rank's engine until ``TPReplica.close()``. Returns then; raises when
    this rank's call ended otherwise than rank 0's (the replica is broken,
    and the process should exit)."""
    ch = _Channel(engine, plan)
    loop = _loop_engine(engine)
    loop.on_token = lambda rid, token: ch.marks.on_token(rid)
    loop.on_retire = lambda rid, *rest: ch.marks.forget(rid)
    loop.on_abort = lambda rid, *rest: ch.marks.forget(rid)
    while True:
        msg = ch.recv()
        if msg[0] == "stop":
            return
        if msg[0] == "mark":
            _, rid, skip = msg
            ch.marks.marks[rid] = skip
            continue
        _, path, name, args, kwargs, ch.clock.now = msg
        err = None
        try:
            getattr(_resolve(engine, path), name)(*args, **kwargs)
        except Exception as e:
            err = e
        ch.agree(name, err)


def spawn_followers(module: str, argv: list, tp: int) -> tuple[int, list]:
    """Rank 0's half of starting a replica from an entry point: a free
    rendezvous port and tp - 1 processes running ``python -m module
    *argv --tp-rank r --tp-port port`` (their stdout discarded, their
    stderr this process's). The caller stops them."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    # The followers import this package wherever they were started from.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--tp-rank", str(rank),
             "--tp-port", str(port)],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL, env=env)
        for rank in range(1, tp)
    ]
    return port, procs


def init_replica_rank(tp: int, rank: int, port: int, device) -> torch.device:
    """Join a replica's process group on ``127.0.0.1:port`` as ``rank``
    of ``tp``: on the card rank r drives ``cuda:r`` over NCCL, on the CPU
    every rank runs gloo. Returns the rank's device."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=tp,
        timeout=datetime.timedelta(minutes=10))
    return dev


def stop_followers(procs: list, timeout: float = 30.0) -> None:
    """Wait for the followers a closed replica released; terminate, then
    kill, what is still running after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    for proc in procs:
        try:
            proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
