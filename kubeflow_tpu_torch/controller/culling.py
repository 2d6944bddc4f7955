"""Idle-culling controller: slice-aware Jupyter activity tracking.

The port's own copy of ``kubeflow_tpu/controller/culling.py`` (reference
components/notebook-controller/controllers/culling_controller.go:87-218),
with the JAX package's two slice changes:

1. **Multi-host activity merge** — Jupyter runs on worker 0, but any host of
   the slice may be active (profile servers, distributed jobs). The prober
   fans out to every host of every slice and activity merges with a
   monotonic guard, so a busy worker 3 keeps the slice alive and clock
   skew can never move last-activity backwards.
2. **Atomic release** — culling sets the stop annotation once; the core
   reconciler scales the whole indexed StatefulSet to 0. Cards are
   reclaimed all-or-nothing; a cull can never leave a partial slice
   holding capacity.

Probing is behind the ``ActivityProber`` seam: ``JupyterHTTPProber``
here, the native fan-out prober in ``prober.py`` (``make_prober``), or a
test's fake. Where JAX's cull event says "released N TPU chips", the
port's says "released N GPU cards".
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import routing_service_name
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller.notebook import (
    headless_service_name,
    slice_sts_names,
)
from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict
from kubeflow_tpu_torch.k8s.errors import NotFoundError
from kubeflow_tpu_torch.k8s.events import EventRecorder
from kubeflow_tpu_torch.k8s.manager import Manager, Reconciler, Request, Result
from kubeflow_tpu_torch.metrics import Metrics

log = logging.getLogger(__name__)

TIME_FORMAT = "%Y-%m-%dT%H:%M:%SZ"


def _fmt(ts: float) -> str:
    return time.strftime(TIME_FORMAT, time.gmtime(ts))


def _parse(ts: str) -> Optional[float]:
    return obj_util.parse_timestamp(ts)


@dataclass
class CullerConfig:
    """Env knobs, names and defaults per the reference initGlobalVars
    (culling_controller.go:534-568)."""

    enable_culling: bool = False
    cull_idle_time_min: int = 1440  # 1 day, reference default
    idleness_check_period_min: int = 1
    cluster_domain: str = "cluster.local"
    dev_mode: bool = False

    @classmethod
    def from_env(cls, env: dict) -> "CullerConfig":
        return cls(
            enable_culling=env.get("ENABLE_CULLING", "false").lower() == "true",
            cull_idle_time_min=int(env.get("CULL_IDLE_TIME", "1440")),
            idleness_check_period_min=int(env.get("IDLENESS_CHECK_PERIOD", "1")),
            cluster_domain=env.get("CLUSTER_DOMAIN", "cluster.local"),
            dev_mode=env.get("DEV", "false").lower() == "true",
        )


@dataclass
class HostActivity:
    """Observed activity on one slice host."""

    host: str
    busy: bool = False
    last_activity: Optional[float] = None  # unix seconds
    reachable: bool = True


class ActivityProber(Protocol):
    def probe(self, nb: Notebook, hosts: list[str]) -> list[HostActivity]: ...


class JupyterHTTPProber:
    """Probes Jupyter's /api/kernels + /api/terminals on worker 0 and the
    activity endpoint on every other host (reference getNotebookApiKernels
    :277-322; DEV mode proxies via localhost as :253-257 does).

    Hosts are probed CONCURRENTLY under one per-slice deadline: serially, a
    16-host slice behind a partition pinned the culler reconcile for
    hosts × timeout (~80s); now the reconcile is bounded by
    ``slice_deadline_s`` no matter how many hosts stall. A host whose probe
    misses the deadline folds as unreachable — which the culler already
    treats as "never judge" — and ``fold_host_activity`` stays the single
    merge point shared with the native prober."""

    def __init__(
        self,
        timeout_s: float = 5.0,
        dev_proxy: Optional[str] = None,
        slice_deadline_s: float = 15.0,
        max_workers: int = 16,
    ):
        self.timeout_s = timeout_s
        self.dev_proxy = dev_proxy
        self.slice_deadline_s = slice_deadline_s
        self.max_workers = max_workers

    def probe(self, nb: Notebook, hosts: list[str]) -> list[HostActivity]:
        if not hosts:
            return []
        deadline = time.monotonic() + self.slice_deadline_s
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, min(len(hosts), self.max_workers)),
            thread_name_prefix="jupyter-probe",
        )
        try:
            futures = [
                pool.submit(self._probe_host, nb, host) for host in hosts
            ]
            out = []
            for host, fut in zip(hosts, futures):
                remaining = deadline - time.monotonic()
                try:
                    kernels, terminals = fut.result(
                        timeout=max(0.0, remaining)
                    )
                except concurrent.futures.TimeoutError:
                    fut.cancel()
                    kernels, terminals = None, None
                out.append(fold_host_activity(host, kernels, terminals))
            return out
        finally:
            # Never block the reconcile on stragglers: abandoned probes
            # finish (or time out) on daemon-ish pool threads.
            pool.shutdown(wait=False, cancel_futures=True)

    def _probe_host(self, nb: Notebook, host: str):
        base = (
            f"{self.dev_proxy}/notebook/{nb.namespace}/{nb.name}"
            if self.dev_proxy
            else f"http://{host}:8888/notebook/{nb.namespace}/{nb.name}"
        )
        kernels = self._get_json(f"{base}/api/kernels")
        # Dead host: don't burn a second timeout on terminals the fold
        # would ignore anyway.
        terminals = (
            self._get_json(f"{base}/api/terminals")
            if kernels is not None
            else None
        )
        return kernels, terminals

    def _get_json(self, url: str):
        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                return json.loads(resp.read().decode())
        except (urllib.error.URLError, OSError, ValueError):
            return None


def fold_host_activity(
    host: str,
    kernels: Optional[list],
    terminals: Optional[list],
) -> HostActivity:
    """Fold Jupyter kernel/terminal listings into one HostActivity.

    The single source of truth for the merge semantics (busy wins; last
    activity is the max across kernels AND terminals; ``kernels is None``
    means the host was unreachable) — shared by the Python and native
    probers so they cannot diverge.
    """
    activity = HostActivity(host=host)
    if kernels is None:
        activity.reachable = False
        return activity
    for kernel in kernels:
        if kernel.get("execution_state") == "busy":
            activity.busy = True
        ts = _parse_jupyter_time(kernel.get("last_activity", ""))
        if ts is not None:
            activity.last_activity = max(activity.last_activity or 0.0, ts)
    for term in terminals or []:
        ts = _parse_jupyter_time(term.get("last_activity", ""))
        if ts is not None:
            activity.last_activity = max(activity.last_activity or 0.0, ts)
    return activity


def _parse_jupyter_time(value: str) -> Optional[float]:
    """Jupyter emits e.g. 2026-07-29T12:00:00.123456Z."""
    if not value:
        return None
    value = value.split(".")[0].rstrip("Z") + "Z"
    return _parse(value)


class CullingReconciler(Reconciler):
    def __init__(
        self,
        client: Client,
        config: Optional[CullerConfig] = None,
        prober: Optional[ActivityProber] = None,
        metrics: Optional[Metrics] = None,
        recorder: Optional[EventRecorder] = None,
        clock: Optional[Callable[[], float]] = None,
        migration_trigger: Optional[Callable[[dict, str], None]] = None,
    ):
        self.client = client
        self.config = config or CullerConfig(enable_culling=True)
        self.prober = prober or JupyterHTTPProber()
        self.metrics = metrics or Metrics(client)
        self.recorder = recorder or EventRecorder(client, component="culler")
        self.clock = clock or time.time
        # Optional hook into runtime/migration.py: called with (notebook
        # object, "idle-cull") just before the stop annotation lands, so
        # an emergency save can start while the slice still exists. The
        # cull itself proceeds regardless — migration is an optimization,
        # never a gate on reclaiming idle cards.
        self.migration_trigger = migration_trigger

    def register(self, manager: Manager) -> None:
        manager.register(self, for_kind="Notebook", name="Culler")

    # ------------------------------------------------------------------
    def reconcile(self, req: Request) -> Result:
        if not self.config.enable_culling:
            return Result()
        try:
            obj = self.client.get("Notebook", req.name, req.namespace)
        except NotFoundError:
            return Result()
        if "deletionTimestamp" in obj["metadata"]:
            return Result()
        nb = Notebook(obj)
        now = self.clock()

        # Stopped → clear activity annotations, no requeue until resumed
        # (reference :105-118).
        if nb.stopped:
            self._remove_activity_annotations(nb)
            return Result()

        # Pod 0 gone → nothing to probe (reference :121-139).
        if not self.client.list(
            "Pod", nb.namespace, {ann.NOTEBOOK_NAME_LABEL: nb.name}
        ):
            self._remove_activity_annotations(nb)
            return Result(requeue_after=self._period_s())

        anns = obj.get("metadata", {}).get("annotations", {})
        if ann.LAST_ACTIVITY not in anns or ann.LAST_ACTIVITY_CHECK not in anns:
            self._init_activity_annotations(nb, now)
            return Result(requeue_after=self._period_s())

        last_check = _parse(anns.get(ann.LAST_ACTIVITY_CHECK, "")) or 0.0
        elapsed = now - last_check
        if elapsed < self._period_s():
            return Result(requeue_after=self._period_s() - elapsed)

        activities = self.prober.probe(nb, self._host_dns(nb))
        if activities and not any(a.reachable for a in activities):
            # Whole slice unobservable (partition, NetPol misconfig): never
            # cull blind — idle and unreachable are indistinguishable. The
            # reference bails the same way when the kernels endpoint errors
            # (getNotebookApiKernels :277-322 returns without updating).
            return Result(requeue_after=self._period_s())
        self._update_activity(nb, [a for a in activities if a.reachable], now)

        obj = self.client.get("Notebook", nb.name, nb.namespace)
        nb = Notebook(obj)
        last_activity = _parse(nb.annotations.get(ann.LAST_ACTIVITY, "")) or now
        if now - last_activity > self.config.cull_idle_time_min * 60:
            self._cull(nb, now, last_activity)
            return Result()
        return Result(requeue_after=self._period_s())

    # ------------------------------------------------------------------
    def _period_s(self) -> float:
        return self.config.idleness_check_period_min * 60.0

    def _host_dns(self, nb: Notebook) -> list[str]:
        try:
            gpu = nb.gpu
        except Exception:
            gpu = None
        if gpu is not None:
            try:
                topo = gpu.slice_topology()
            except Exception:
                topo = None
            slices = gpu.slice_count
            if topo is not None and (topo.hosts > 1 or slices > 1):
                # Every host of EVERY slice: activity anywhere (profiling
                # server, distributed worker) must block the cull.
                return [
                    host
                    for sts in slice_sts_names(nb.name, slices)
                    for host in topo.worker_hostnames(
                        sts,
                        headless_service_name(nb.name),
                        nb.namespace,
                        self.config.cluster_domain,
                    )
                ]
        # Single pod: route via the plain Service, as the reference does.
        return [
            f"{routing_service_name(nb.name)}.{nb.namespace}"
            f".svc.{self.config.cluster_domain}"
        ]

    def _update_activity(
        self, nb: Notebook, activities: list[HostActivity], now: float
    ) -> None:
        """Merge host activity with the monotonic guard (reference
        updateTimestampFromKernelsActivity :380-437 generalized to N hosts)."""
        busy = any(a.busy for a in activities)
        observed: Optional[float] = None
        for a in activities:
            if a.last_activity is not None:
                observed = max(observed or 0.0, a.last_activity)
        if busy:
            new_activity: Optional[float] = now
        else:
            new_activity = observed

        def write():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            anns = obj_util.annotations_of(fresh)
            if new_activity is not None:
                current = _parse(anns.get(ann.LAST_ACTIVITY, ""))
                # Monotonic: never move last-activity backwards.
                if current is None or new_activity > current:
                    anns[ann.LAST_ACTIVITY] = _fmt(new_activity)
            anns[ann.LAST_ACTIVITY_CHECK] = _fmt(now)
            self.client.update(fresh)

        retry_on_conflict(write)

    def _init_activity_annotations(self, nb: Notebook, now: float) -> None:
        def write():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            anns = obj_util.annotations_of(fresh)
            anns.setdefault(ann.LAST_ACTIVITY, _fmt(now))
            anns.setdefault(ann.LAST_ACTIVITY_CHECK, _fmt(now))
            self.client.update(fresh)

        retry_on_conflict(write)

    def _remove_activity_annotations(self, nb: Notebook) -> None:
        def write():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            removed = obj_util.remove_annotation(fresh, ann.LAST_ACTIVITY)
            removed |= obj_util.remove_annotation(fresh, ann.LAST_ACTIVITY_CHECK)
            if removed:
                self.client.update(fresh)

        retry_on_conflict(write)

    def _cull(self, nb: Notebook, now: float, last_activity: float) -> None:
        """Set the stop annotation → core reconciler scales slice to 0
        atomically (reference setStopAnnotation :484-500); the cards the
        slice held are counted in ``tpu_chips_reclaimed_total``."""
        cards = 0
        try:
            gpu = nb.gpu
            if gpu is not None:
                cards = gpu.slice_topology().chips
        except Exception:
            cards = 0

        if self.migration_trigger is not None:
            # Fire BEFORE the stop annotation: the save step needs the
            # slice pods alive. A hook crash must not block the cull.
            try:
                self.migration_trigger(nb.obj, "idle-cull")
            except Exception:
                log.exception(
                    "migration trigger (idle-cull) raised; culling anyway"
                )

        def write():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            anns = obj_util.annotations_of(fresh)
            if ann.STOP in anns:
                return
            anns[ann.STOP] = _fmt(now)
            self.client.update(fresh)

        retry_on_conflict(write)
        self.metrics.culling_total.inc()
        self.metrics.last_culling_timestamp.set(now)
        if cards:
            self.metrics.chips_reclaimed_total.inc(cards)
        idle_min = int((now - last_activity) / 60)
        self.recorder.eventf(
            nb.obj, "Normal", "NotebookCulled",
            f"Notebook idle for {idle_min}m "
            f"(> {self.config.cull_idle_time_min}m); "
            + (f"released {cards} GPU cards" if cards else "stopped"),
        )
