"""Fleet serving gateway: prefix-affinity routing over N port replicas.

The port's own copy of the JAX package's ``models/gateway.py``, with the
same names, routes, wire format and ring, so a port gateway fronts port
replicas (``kubeflow_tpu_torch/models/server.py``) exactly as the
reference fronts its own. It is stdlib and numpy: it runs in any process,
with or without a card, in front of replicas on the card.

- **prefix affinity:** the gateway walks a prompt through the same block
  chain hash the paged engine's prefix cache keys its blocks with
  (:func:`chain_key`), finds the longest chain prefix an earlier request
  shared, and hashes THAT key onto a virtual-node ring, so a repeated
  system prompt lands on the replica whose prefix cache is warm;
- **health and drain:** a probe loop GETs each replica's ``/healthz``; a
  draining or unreachable replica leaves the ring at once (its in-flight
  streams finish), and one that comes back re-enters it with minimal key
  movement;
- **bounded re-route:** a connect failure or a 503/429 answered before
  any byte was relayed walks to the next distinct ring node, at most
  ``reroute_budget`` alternates a request;
- **tenant-fair shed:** at the fleet's in-flight capacity, tenants above
  their fair share (``ceil(capacity / active_tenants)``) are shed with
  429 and Retry-After; a tenant under its share is never shed;
- **streaming passthrough:** SSE bytes are relayed as they arrive; the
  request's ``deadline_s`` is decremented by the gateway's queueing time,
  and a client disconnect closes the upstream connection, so the
  replica's own ``_client_gone`` peek cancels the request;
- **disaggregated tiers:** ``tier_mode="disagg"`` prefills on one tier
  and decodes on the other, moving the KV over the replicas' ``/kv/*``
  routes;
- **tracing:** the root span's traceparent goes upstream, so a replica's
  spans join the gateway's trace.

Elastic capacity comes through a ``replica_source`` with an
``acquire(now=)`` method. The reference's warm-slice source claims
through ``controller/slicepool.py``, which the port has not taken over
(ROADMAP item 18): ``scale_up`` with no source returns None, as the
reference's does, and ``gateway_from_env`` refuses to enable the
autoscaler without one.
"""

from __future__ import annotations

import bisect
import hashlib
import http.client
import itertools
import json
import math
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from kubeflow_tpu_torch.models.autoscaler import (
    KUBEFLOW_TPU_AUTOSCALE_ENABLE,
    FleetAutoscaler,
    autoscaler_from_env,
)
from kubeflow_tpu_torch.models.server import (
    KV_TRANSFER_MAX_BYTES,
    BodyTooLarge,
    _client_gone,
    _read_body,
)
from kubeflow_tpu_torch.observability import tracing
from kubeflow_tpu_torch.observability.signals import FleetTelemetry, TenantBuckets

AFFINITY_MODES = ("prefix", "random")


# The port's own copies of the env contract names this module reads
# (the JAX package's webhook/tpu_env.py), under the same names.
KUBEFLOW_TPU_GATEWAY_AFFINITY = "KUBEFLOW_TPU_GATEWAY_AFFINITY"
KUBEFLOW_TPU_GATEWAY_HASH_SEED = "KUBEFLOW_TPU_GATEWAY_HASH_SEED"
KUBEFLOW_TPU_GATEWAY_PORT = "KUBEFLOW_TPU_GATEWAY_PORT"
KUBEFLOW_TPU_GATEWAY_REPLICAS = "KUBEFLOW_TPU_GATEWAY_REPLICAS"
KUBEFLOW_TPU_GATEWAY_REROUTE_BUDGET = "KUBEFLOW_TPU_GATEWAY_REROUTE_BUDGET"
KUBEFLOW_TPU_GATEWAY_TIER_DECODE = "KUBEFLOW_TPU_GATEWAY_TIER_DECODE"
KUBEFLOW_TPU_GATEWAY_TIER_MODE = "KUBEFLOW_TPU_GATEWAY_TIER_MODE"
KUBEFLOW_TPU_GATEWAY_TIER_PREFILL = "KUBEFLOW_TPU_GATEWAY_TIER_PREFILL"
KUBEFLOW_TPU_KV_PEER_FANOUT = "KUBEFLOW_TPU_KV_PEER_FANOUT"
KUBEFLOW_TPU_KV_PEER_MAX_BYTES = "KUBEFLOW_TPU_KV_PEER_MAX_BYTES"
KUBEFLOW_TPU_KV_PEER_TIMEOUT_S = "KUBEFLOW_TPU_KV_PEER_TIMEOUT_S"
KUBEFLOW_TPU_KV_TRANSFER_MAX_BYTES = "KUBEFLOW_TPU_KV_TRANSFER_MAX_BYTES"
KUBEFLOW_TPU_KV_TRANSFER_TIMEOUT_S = "KUBEFLOW_TPU_KV_TRANSFER_TIMEOUT_S"


def chain_key(parent: Optional[bytes], tokens,
              adapter: Optional[int] = None) -> bytes:
    """Content address of one full prompt block given its prefix chain —
    byte-for-byte ``PagedBatcher._chain_key`` (tests assert the parity),
    duplicated here so routing never imports the engine. ``adapter``
    salts the ROOT (a LoRA adapter changes every K/V the same tokens
    produce, so chains fork at their first block); None keeps the legacy
    base-model root byte-for-byte."""
    if parent is None:
        parent = (b"root" if adapter is None
                  else b"root|adapter:%d" % int(adapter))
    h = hashlib.sha1(parent)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each node owns ``vnodes`` pseudo-random positions; a key routes to
    the first node position clockwise from its own hash. Join/leave
    moves only the keys in the joining/leaving node's arcs (~1/N of the
    space), which is the property the prefix cache needs: a replica
    joining must not reshuffle every tenant's warm prefix to a cold
    replica. ``seed`` perturbs every position so parallel fleets don't
    co-shard the same hot prefixes. Not thread-safe — callers lock.
    """

    def __init__(self, vnodes: int = 64, seed: int = 0):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self.seed = seed
        self._members: set = set()
        self._keys: list = []   # sorted vnode positions
        self._owners: list = []  # node owning _keys[i]

    def _pos(self, label) -> int:
        if isinstance(label, str):
            label = label.encode()
        h = hashlib.sha1(b"%d|" % self.seed + label).digest()
        return int.from_bytes(h[:8], "big")

    def _rebuild(self) -> None:
        pairs = sorted(
            (self._pos(f"{node}#{i}".encode()), node)
            for node in self._members
            for i in range(self.vnodes)
        )
        self._keys = [p for p, _ in pairs]
        self._owners = [n for _, n in pairs]

    def add(self, node: str) -> None:
        if node not in self._members:
            self._members.add(node)
            self._rebuild()

    def remove(self, node: str) -> None:
        if node in self._members:
            self._members.discard(node)
            self._rebuild()

    def nodes(self) -> frozenset:
        return frozenset(self._members)

    def __len__(self) -> int:
        return len(self._members)

    def lookup(self, key: bytes) -> Optional[str]:
        nodes = self.successors(key, 1)
        return nodes[0] if nodes else None

    def successors(self, key: bytes, limit: int) -> list:
        """Up to ``limit`` DISTINCT nodes clockwise from the key's
        position — the primary replica first, then the re-route walk."""
        if not self._keys or limit < 1:
            return []
        idx = bisect.bisect_right(self._keys, self._pos(key))
        out: list = []
        seen: set = set()
        for j in range(len(self._keys)):
            node = self._owners[(idx + j) % len(self._keys)]
            if node not in seen:
                seen.add(node)
                out.append(node)
                if len(out) >= limit:
                    break
        return out


class PrefixRouter:
    """Longest-shared-prefix routing keys over the block chain hash.

    Walks the prompt's full blocks through ``chain_key`` and returns the
    deepest chain key some earlier request already produced — all
    requests sharing that prefix compute the same key and co-locate on
    one replica, exactly where the paged engine's prefix chain is warm.
    A never-seen prefix routes by its FIRST block's key (deterministic,
    so the tenant's very next request converges); prompts shorter than
    one block hash whole. The seen-registry is a bounded LRU — stale
    entries only cost one extra cold route after re-learning.
    """

    def __init__(self, block_size: int = 16, max_entries: int = 65536):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.block_size = block_size
        self.max_entries = max_entries
        self._seen: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def route_key(self, prompt: list) -> bytes:
        bs = self.block_size
        keys: list = []
        parent: Optional[bytes] = None
        for j in range(len(prompt) // bs):
            parent = chain_key(parent, prompt[j * bs:(j + 1) * bs])
            keys.append(parent)
        if not keys:
            keys = [chain_key(None, prompt)]
        with self._lock:
            best = keys[0]
            for k in keys:
                if k not in self._seen:
                    # A chain's key is only ever registered together with
                    # its whole parent chain, so the first miss ends the
                    # longest shared prefix.
                    break
                best = k
            for k in keys:
                self._seen[k] = None
                self._seen.move_to_end(k)
            while len(self._seen) > self.max_entries:
                self._seen.popitem(last=False)
        return best


def prompt_chain_keys(prompt: list, block_size: int) -> list:
    """Chain keys of the prompt's REGISTRABLE full blocks — the first
    ``(len(prompt) - 1) // block_size`` blocks, excluding the tail block
    the decode path mutates. Byte-identical to the key walk
    ``PagedBatcher.export_blocks`` stamps into a KV payload, so the
    gateway can negotiate suffix-only transfers (/kv/probe) without
    importing the engine."""
    keys: list = []
    parent: Optional[bytes] = None
    for j in range((len(prompt) - 1) // block_size):
        parent = chain_key(
            parent, prompt[j * block_size:(j + 1) * block_size]
        )
        keys.append(parent)
    return keys


def _parse_endpoint(endpoint: str) -> tuple:
    """``host:port`` → (host, port), raising on garbage — a mistyped
    replica list must not silently route into nothing."""
    host, sep, port_s = endpoint.rpartition(":")
    if not sep or not host:
        raise ValueError(f"replica endpoint {endpoint!r}: want host:port")
    try:
        port = int(port_s)
    except ValueError:
        port = -1
    if not 1 <= port <= 65535:
        raise ValueError(f"replica endpoint {endpoint!r}: bad port")
    return host, port


class _Replica:
    __slots__ = ("endpoint", "host", "port", "healthy", "draining", "stats",
                 "role", "drain_pinned")

    def __init__(self, endpoint: str, role: str = "fused"):
        self.endpoint = endpoint
        self.host, self.port = _parse_endpoint(endpoint)
        self.healthy = True   # optimistic: routable until a probe says no
        self.draining = False
        # Gateway-side drain pin (autoscaler scale-down): the replica is
        # held out of the ring even while its healthz still says ok —
        # its own drain flips that shortly, but new streams must stop
        # routing here the moment the decision lands, not a probe later.
        self.drain_pinned = False
        self.stats: Optional[dict] = None  # last /stats scrape (subset)
        # Disaggregated tier membership: "fused" (default), "prefill", or
        # "decode" — from gateway config (tier lists) or the replica's
        # own /stats tier_role advertisement (config wins).
        self.role = role


class GatewayOverloadedError(RuntimeError):
    """The fleet is at capacity and this tenant is over its fair share."""


class ServingGateway:
    """HTTP gateway fronting N InferenceServer replicas (see module doc).

    >>> gw = ServingGateway(["127.0.0.1:8001", "127.0.0.1:8002"], port=0)
    >>> gw.start()
    >>> # POST http://{gw.host}:{gw.port}/v1/completions  (same API shape)
    >>> gw.stop()
    """

    def __init__(self, replicas=(), host: str = "127.0.0.1", port: int = 0,
                 affinity: str = "prefix", block_size: int = 16,
                 vnodes: int = 64, hash_seed: int = 0,
                 reroute_budget: int = 2,
                 health_interval_s: float = 0.5,
                 health_timeout_s: float = 2.0,
                 upstream_timeout_s: float = 120.0,
                 max_inflight: Optional[int] = None,
                 max_body_bytes: int = 4 << 20,
                 metrics=None, replica_source=None,
                 telemetry: Optional[FleetTelemetry] = None,
                 tenant_top_k: int = 8,
                 tier_mode: str = "fused",
                 tier_roles: Optional[dict] = None,
                 kv_transfer_timeout_s: float = 30.0,
                 kv_transfer_max_bytes: int = KV_TRANSFER_MAX_BYTES,
                 kv_peer_fanout: int = 0,
                 kv_peer_timeout_s: float = 5.0,
                 kv_peer_max_bytes: int = 64 << 20,
                 adapter_affinity: bool = True,
                 autoscaler_config=None,
                 autoscaler_provisioner=None):
        if affinity not in AFFINITY_MODES:
            raise ValueError(
                f"affinity must be one of {AFFINITY_MODES}, got {affinity!r}"
            )
        if reroute_budget < 0:
            raise ValueError(
                f"reroute_budget must be >= 0, got {reroute_budget}"
            )
        if tier_mode not in ("fused", "disagg"):
            raise ValueError(
                f"tier_mode must be 'fused' or 'disagg', got {tier_mode!r}"
            )
        if kv_transfer_timeout_s <= 0:
            raise ValueError(
                f"kv_transfer_timeout_s must be > 0, got "
                f"{kv_transfer_timeout_s}"
            )
        if kv_transfer_max_bytes < 1:
            raise ValueError(
                f"kv_transfer_max_bytes must be >= 1, got "
                f"{kv_transfer_max_bytes}"
            )
        if kv_peer_fanout < 0:
            raise ValueError(
                f"kv_peer_fanout must be >= 0, got {kv_peer_fanout}"
            )
        if kv_peer_timeout_s <= 0:
            raise ValueError(
                f"kv_peer_timeout_s must be > 0, got {kv_peer_timeout_s}"
            )
        if kv_peer_max_bytes < 1:
            raise ValueError(
                f"kv_peer_max_bytes must be >= 1, got {kv_peer_max_bytes}"
            )
        # Same opt-in as the replicas: KUBEFLOW_TPU_TRACE_* switches the
        # process-wide provider on; default stays the no-op tracer.
        tracing.configure_from_env()
        self.affinity = affinity
        # (prefix, adapter) affinity: fold the request's "model" field
        # into the route key so one adapter's tenants co-locate — each
        # replica's bounded hot-adapter cache then sees ~n_adapters/N
        # distinct adapters instead of all of them. False = the
        # adapter-oblivious baseline the loadtest measures against.
        self.adapter_affinity = bool(adapter_affinity)
        self.reroute_budget = reroute_budget
        # Disaggregated prefill/decode serving: in "disagg" mode a
        # streaming token-id request prefills on the prefill tier, ships
        # its paged-KV payload to the decode tier, and streams from
        # there; everything else (and every transfer failure, within the
        # re-route budget) falls back to the fused path below.
        self.tier_mode = tier_mode
        self._tier_roles = dict(tier_roles or {})
        self.kv_transfer_timeout_s = kv_transfer_timeout_s
        self.kv_transfer_max_bytes = kv_transfer_max_bytes
        self._kv_transfers = 0
        self._kv_transfer_failures = 0
        self._kv_transfer_bytes = 0
        self._kv_transfer_last_s = 0.0
        # Fleet KV tier (peer prefix fetch): read-through fetch of warm
        # prefix chains from bounded ring successors. kv_peer_fanout=0
        # (the default, and FANOUT unset in gateway_from_env) keeps the
        # tier fully inert: the hot path never computes chain keys for
        # it and never opens a peer socket.
        self.kv_peer_fanout = int(kv_peer_fanout)
        self.kv_peer_timeout_s = float(kv_peer_timeout_s)
        self.kv_peer_max_bytes = int(kv_peer_max_bytes)
        self._kv_peer_fetches = 0
        self._kv_peer_fetch_failures = 0
        self._kv_peer_bytes = 0
        self._kv_peer_fetch_last_s = 0.0
        self._kv_peer_fail_reasons: dict = {}
        self._kv_peer_quarantined = 0
        self._kv_peer_quarantine: list = []  # bounded: last 8 refusals
        self._kv_peer_single_flight_skips = 0
        self._kv_peer_negative_hits = 0
        # endpoint -> (monotonic deadline, consecutive failures): the
        # per-peer negative cache with exponential backoff.
        self._kv_peer_negative: dict = {}
        # chain tail keys (hex) with a fetch in flight: single-flight.
        self._kv_peer_inflight: set = set()
        self.health_interval_s = health_interval_s
        self.health_timeout_s = health_timeout_s
        self.upstream_timeout_s = upstream_timeout_s
        self.max_inflight = max_inflight
        self.max_body_bytes = max_body_bytes
        self.metrics = metrics
        self.replica_source = replica_source
        # Fleet telemetry plane (observability/signals.py): None unless a
        # FleetTelemetry is passed in or KUBEFLOW_TPU_SIGNALS_ENABLE opts
        # in — every feed below checks `is not None` first, so the
        # request hot path does zero telemetry work when disabled.
        self.telemetry = (
            telemetry if telemetry is not None
            else FleetTelemetry.from_env(metrics=metrics)
        )
        # The shed counter's tenant label stays bounded even when the
        # telemetry plane is off; share its buckets when it is on so the
        # Prometheus label and the per-tenant series always agree.
        self._tenant_buckets = (
            self.telemetry.tenants if self.telemetry is not None
            else TenantBuckets(tenant_top_k)
        )
        self._lock = threading.Lock()
        self._ring = HashRing(vnodes=vnodes, seed=hash_seed)
        self._router = PrefixRouter(block_size=block_size)
        self._spread = itertools.count()  # "random" arm: uniform, RNG-free
        self._replicas: dict = {}
        # Live-migration restore targets (pin_for_migration): excluded
        # from autoscaler scale-down victim selection until unpinned.
        self._migration_pins: set = set()
        # Tenant-fair admission state + the routing-report counters.
        self._inflight: dict = {}
        self._total_inflight = 0
        self._requests = 0
        self._reroutes = 0
        self._shed = 0
        self._failed = 0          # exhausted budget / mid-stream loss
        self._stopped = False
        self._started = False
        self._stop_evt = threading.Event()
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="gateway-http", daemon=True
        )
        self._health_thread = threading.Thread(
            target=self._health_loop, name="gateway-health", daemon=True
        )
        for ep in replicas:
            self.add_replica(ep)
        # Fleet autoscaler (models/autoscaler.py): same inert-by-default
        # stance as the telemetry plane — None unless a config is passed
        # or KUBEFLOW_TPU_AUTOSCALE_ENABLE opts in. Ticks ride probe
        # passes, so a disabled autoscaler costs literally nothing.
        scale_cfg = (autoscaler_config if autoscaler_config is not None
                     else autoscaler_from_env())
        self.autoscaler = (
            FleetAutoscaler(self, scale_cfg,
                            provisioner=autoscaler_provisioner,
                            metrics=metrics)
            if scale_cfg is not None else None
        )

    # -- fleet membership --------------------------------------------------

    def add_replica(self, endpoint: str) -> None:
        """Register a replica and route to it immediately (optimistic —
        the next probe pass demotes it if it is not actually healthy).
        Idempotent; loadtests and the chaos harness call this mid-run."""
        rep = _Replica(endpoint,
                       role=self._tier_roles.get(endpoint, "fused"))
        with self._lock:
            if endpoint not in self._replicas:
                self._replicas[endpoint] = rep
                self._ring.add(endpoint)
            self._mirror_ring_locked()

    def remove_replica(self, endpoint: str) -> None:
        with self._lock:
            self._replicas.pop(endpoint, None)
            self._ring.remove(endpoint)
            self._mirror_ring_locked()
        if self.telemetry is not None:
            # Drop the rebase state and scrape timestamp: a departed
            # replica's growing scrape age must not freeze the
            # autoscaler, and a re-add restarts its counter base.
            self.telemetry.forget_replica(endpoint)

    def begin_drain(self, endpoint: str) -> bool:
        """Autoscaler scale-down entry: pull the replica from the ring
        NOW and pin it out (in-flight streams keep flowing straight to
        it; new requests route elsewhere, before any probe runs). The
        pin survives probe passes until ``remove_replica``. Returns
        False for endpoints this gateway does not know."""
        with self._lock:
            rep = self._replicas.get(endpoint)
            if rep is None:
                return False
            rep.drain_pinned = True
            rep.draining = True
            rep.healthy = False
            if endpoint in self._ring.nodes():
                self._ring.remove(endpoint)
            self._mirror_ring_locked()
        return True

    def pin_for_migration(self, endpoint: str) -> bool:
        """Mark a replica as a live-migration restore target: the
        autoscaler must not pick it as a scale-down victim while a
        checkpoint is being rebuilt onto it (a drain mid-restore would
        release the very slice the migration is landing on). Idempotent;
        returns False for endpoints this gateway does not know."""
        with self._lock:
            if endpoint not in self._replicas:
                return False
            self._migration_pins.add(endpoint)
        return True

    def unpin_for_migration(self, endpoint: str) -> None:
        """Release the migration pin (flip done or migration fell back);
        the endpoint becomes an ordinary scale-down candidate again.
        Unknown endpoints are a no-op — the pin set is self-cleaning."""
        with self._lock:
            self._migration_pins.discard(endpoint)

    def migration_pinned(self) -> frozenset:
        """Endpoints currently pinned as migration restore targets."""
        with self._lock:
            # Pins for replicas that left the fleet entirely must not
            # accumulate: intersect with live membership on read.
            self._migration_pins &= set(self._replicas)
            return frozenset(self._migration_pins)

    def replica_endpoints(self) -> list:
        with self._lock:
            return sorted(self._replicas)

    def ring_nodes(self) -> frozenset:
        with self._lock:
            return self._ring.nodes()

    def scale_up(self, now: Optional[float] = None) -> Optional[str]:
        """One more slice from the warm pool via the replica source
        (None without one). Returns the pool name the claim came from;
        the caller registers the endpoint with ``add_replica`` once the
        replica's InferenceServer reports healthy."""
        if self.replica_source is None:
            return None
        return self.replica_source.acquire(now=now)

    def _mirror_ring_locked(self) -> None:
        if self.metrics is not None:
            self.metrics.gateway_replicas.set(len(self._ring))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingGateway":
        self._started = True
        self._http_thread.start()
        self._health_thread.start()
        return self

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self._stop_evt.set()
        if self._started:
            # shutdown() handshakes with serve_forever; on a never-
            # started gateway it would wait forever for a loop that
            # never ran, so only the socket is closed in that case.
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._started:
            self._health_thread.join(timeout=10)

    # -- health / scrape loop ----------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop_evt.wait(self.health_interval_s):
            self.probe_once()

    def probe_once(self) -> None:
        """One probe pass over every registered replica (public so tests
        and the chaos harness can force a pass instead of sleeping):
        healthz 200 → in the ring; draining/unreachable → out. In-ring
        replicas also get a /stats scrape for the routing report."""
        for rep in list(self._replicas.values()):
            state = self._probe(rep)
            with self._lock:
                if rep.endpoint not in self._replicas:
                    continue  # removed while we probed
                rep.healthy = state == "ok" and not rep.drain_pinned
                rep.draining = state == "draining" or rep.drain_pinned
                in_ring = rep.endpoint in self._ring.nodes()
                if rep.healthy and not in_ring:
                    self._ring.add(rep.endpoint)
                elif not rep.healthy and in_ring:
                    self._ring.remove(rep.endpoint)
                self._mirror_ring_locked()
            if rep.healthy:
                scraped = self._scrape_stats(rep)
                # _scrape_stats hands back the SAME object on a failed
                # scrape: only a genuinely fresh payload may feed the
                # telemetry plane, or a replica whose /stats endpoint
                # wedged would keep refreshing its scrape age and mask
                # the staleness the autoscaler freeze exists to catch.
                fresh = scraped is not rep.stats
                rep.stats = scraped
                if rep.endpoint not in self._tier_roles:
                    # Tier membership follows the replica's own /stats
                    # advertisement unless the gateway's config pinned it.
                    role = (rep.stats or {}).get("tier_role")
                    if role in ("fused", "prefill", "decode"):
                        rep.role = role
                if self.telemetry is not None and fresh:
                    self.telemetry.ingest_replica(rep.endpoint, rep.stats)
        if self.telemetry is not None:
            with self._lock:
                ring_size = len(self._ring)
            self.telemetry.ingest_ring(ring_size)
            # Burn rates ride the probe cadence: cheap dict math over the
            # signal rings, and the latch/metric/span emission lives in
            # the engine, not here.
            self.telemetry.evaluate_slo()
        if self.autoscaler is not None:
            # The control loop rides the same cadence, AFTER the scrape/
            # SLO pass so each tick sees this pass's fresh signals.
            self.autoscaler.tick()

    def _probe(self, rep: _Replica) -> str:
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.health_timeout_s
            )
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                body = resp.read()
            finally:
                conn.close()
        except OSError:
            return "down"
        if resp.status == 200:
            return "ok"
        try:
            status = json.loads(body).get("status", "")
        except (ValueError, AttributeError):
            status = ""
        return "draining" if status == "draining" else "down"

    def _scrape_stats(self, rep: _Replica) -> Optional[dict]:
        try:
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=self.health_timeout_s
            )
            try:
                conn.request("GET", "/stats")
                resp = conn.getresponse()
                body = resp.read()
            finally:
                conn.close()
            stats = json.loads(body)
        except (OSError, ValueError):
            return rep.stats  # keep the last good scrape
        keep = {k: stats.get(k) for k in
                ("active_slots", "queued", "slots", "served",
                 "requests_shed", "tokens_generated",
                 "engine_step_stalls")}
        # Optional sub-dicts the telemetry plane turns into per-replica
        # gauges (queue-wait/inter-token percentiles, ragged fill,
        # prefix hit ratio); absent on engines without the feature.
        keep["tier_role"] = stats.get("tier_role")
        for extra in ("prefix_cache", "queue_wait_s", "inter_token_s",
                      "ragged", "flight", "kv_handoff", "speculative",
                      "lora_cache"):
            if extra in stats:
                keep[extra] = stats[extra]
        return keep

    # -- admission (tenant-fair shed) --------------------------------------

    def _capacity_locked(self) -> int:
        if self.max_inflight is not None:
            return self.max_inflight
        # Heuristic fleet capacity: slots + a queue's worth per routable
        # replica, from the last scrape (default 16 when unscraped yet).
        cap = 0
        for ep in self._ring.nodes():
            rep = self._replicas.get(ep)
            slots = (rep.stats or {}).get("slots") if rep else None
            cap += 2 * int(slots) if slots else 16
        return max(cap, 1)

    def _admit(self, tenant: str) -> None:
        with self._lock:
            cap = self._capacity_locked()
            if self._total_inflight >= cap:
                active = len(self._inflight) + (
                    0 if tenant in self._inflight else 1
                )
                share = math.ceil(cap / max(active, 1))
                if self._inflight.get(tenant, 0) >= share:
                    # Over fair share while the fleet is saturated: shed.
                    # A tenant *under* its share is still admitted (the
                    # overshoot is bounded by one share per tenant), so a
                    # noisy neighbor can never starve a light one.
                    self._shed += 1
                    bucket = self._tenant_buckets.bucket(tenant)
                    if self.metrics is not None:
                        self.metrics.gateway_shed_total.labels(
                            tenant=bucket
                        ).inc()
                    if self.telemetry is not None:
                        self.telemetry.observe_shed(tenant)
                    raise GatewayOverloadedError(
                        f"fleet at capacity ({cap} in flight); tenant "
                        f"{tenant!r} is over its fair share ({share})"
                    )
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self._total_inflight += 1

    def _release(self, tenant: str) -> None:
        with self._lock:
            left = self._inflight.get(tenant, 0) - 1
            if left > 0:
                self._inflight[tenant] = left
            else:
                self._inflight.pop(tenant, None)
            self._total_inflight = max(0, self._total_inflight - 1)

    # -- routing -----------------------------------------------------------

    def _route_key(self, prompt, adapter=None) -> bytes:
        if self.affinity == "random":
            # Counter-hashed: uniform spread with zero RNG state, and the
            # ring seed still decorrelates parallel fleets.
            return next(self._spread).to_bytes(8, "big")
        if isinstance(prompt, list) and all(
            isinstance(t, int) and not isinstance(t, bool) for t in prompt
        ):
            key = self._router.route_key(prompt)
        else:
            # Text prompts (tokenizer lives replica-side): whole-string
            # affinity — identical notebooks still co-locate.
            key = hashlib.sha1(repr(prompt).encode()).digest()
        if self.adapter_affinity and adapter is not None:
            # Fold the adapter AFTER the prefix walk: same prefix + same
            # adapter co-locate (warm chain AND hot adapter), while a
            # different adapter lands elsewhere on the ring instead of
            # thrashing the first replica's bounded adapter cache.
            key = hashlib.sha1(
                b"adapter|" + repr(adapter).encode() + b"|" + key
            ).digest()
        return key

    def _candidates(self, key: bytes) -> list:
        with self._lock:
            return self._ring.successors(key, self.reroute_budget + 1)

    def _tier_candidates(self, role: str, key: bytes) -> list:
        """Ring-ordered healthy replicas of one tier role.

        The full successor walk keeps prefix affinity *within* the tier:
        the first decode replica after the key's ring position is stable
        for a given prompt prefix, so its chain cache warms exactly like
        a fused replica's would.
        """
        with self._lock:
            out = []
            for ep in self._ring.successors(key, len(self._ring)):
                rep = self._replicas.get(ep)
                if rep is None:
                    continue
                if (rep.role or "fused") == role:
                    out.append(ep)
                    if len(out) >= self.reroute_budget + 1:
                        break
            return out

    def _count_reroute(self) -> None:
        with self._lock:
            self._reroutes += 1
        if self.metrics is not None:
            self.metrics.gateway_reroutes_total.inc()
        if self.telemetry is not None:
            self.telemetry.observe_reroute()

    def _count_request(self) -> None:
        with self._lock:
            self._requests += 1
        if self.metrics is not None:
            self.metrics.gateway_requests_total.inc()

    def _count_failed(self) -> None:
        with self._lock:
            self._failed += 1

    def _count_kv_transfer(self, ok: bool, nbytes: int,
                           latency_s: float) -> None:
        with self._lock:
            if ok:
                self._kv_transfers += 1
                self._kv_transfer_bytes += nbytes
                self._kv_transfer_last_s = latency_s
            else:
                self._kv_transfer_failures += 1
        if self.metrics is not None:
            if ok:
                self.metrics.serving_kv_transfer_total.inc()
                self.metrics.serving_kv_transfer_bytes_total.inc(nbytes)
                self.metrics.serving_kv_transfer_latency_seconds.set(
                    latency_s
                )
            else:
                self.metrics.serving_kv_transfer_failures_total.inc()
        if self.telemetry is not None:
            self.telemetry.observe_kv_transfer(nbytes, latency_s, ok=ok)

    # -- fleet KV tier (peer prefix fetch) bookkeeping ---------------------

    def _count_kv_peer_fetch(self, ok: bool, nbytes: int, latency_s: float,
                             reason: Optional[str] = None) -> None:
        with self._lock:
            if ok:
                self._kv_peer_fetches += 1
                self._kv_peer_bytes += nbytes
                self._kv_peer_fetch_last_s = latency_s
            else:
                self._kv_peer_fetch_failures += 1
                if reason:
                    self._kv_peer_fail_reasons[reason] = (
                        self._kv_peer_fail_reasons.get(reason, 0) + 1
                    )
        if self.metrics is not None:
            if ok:
                self.metrics.serving_kv_peer_fetch_total.inc()
                self.metrics.serving_kv_peer_bytes_total.inc(nbytes)
                self.metrics.serving_kv_peer_fetch_latency_seconds.set(
                    latency_s
                )
            else:
                self.metrics.serving_kv_peer_fetch_failures_total.inc()
        if self.telemetry is not None:
            self.telemetry.observe_kv_peer_fetch(nbytes, latency_s, ok=ok)

    def _kv_peer_backoff(self, endpoint: str) -> None:
        """A dead/slow/refusing peer trips the negative cache with
        per-peer exponential backoff: the fetch ladder must never probe
        a corpse twice in a row, and a flapping peer earns a longer
        hold each consecutive failure."""
        with self._lock:
            _, fails = self._kv_peer_negative.get(endpoint, (0.0, 0))
            fails += 1
            hold = min(self.kv_peer_timeout_s * (2 ** (fails - 1)), 60.0)
            self._kv_peer_negative[endpoint] = (
                time.monotonic() + hold, fails
            )

    def _kv_peer_blocked(self, endpoint: str) -> bool:
        """True while the peer's negative-cache hold is live. An expired
        hold admits ONE fresh probe: success clears the entry, another
        failure doubles the hold."""
        with self._lock:
            entry = self._kv_peer_negative.get(endpoint)
            if entry is None:
                return False
            if time.monotonic() >= entry[0]:
                return False
            self._kv_peer_negative_hits += 1
            return True

    def _kv_peer_recovered(self, endpoint: str) -> None:
        with self._lock:
            self._kv_peer_negative.pop(endpoint, None)

    def _kv_peer_quarantine_payload(self, endpoint: str,
                                    error: str) -> None:
        """Import validation failure (geometry, chain-key, version):
        record the refusal so an operator can see WHICH peer ships
        incompatible payloads — the request itself just re-prefills."""
        with self._lock:
            self._kv_peer_quarantined += 1
            self._kv_peer_quarantine.append(
                {"endpoint": endpoint, "error": error[:200]}
            )
            del self._kv_peer_quarantine[:-8]

    def stats(self) -> dict:
        with self._lock:
            replicas = {
                ep: {
                    "in_ring": ep in self._ring.nodes(),
                    "healthy": rep.healthy,
                    "draining": rep.draining,
                    "role": rep.role,
                    **({"stats": rep.stats} if rep.stats else {}),
                }
                for ep, rep in sorted(self._replicas.items())
            }
            hits = misses = 0
            for rep in self._replicas.values():
                pc = (rep.stats or {}).get("prefix_cache") or {}
                hits += pc.get("hits", 0)
                misses += pc.get("misses", 0)
            out = {
                "affinity": self.affinity,
                "tier_mode": self.tier_mode,
                "ring_size": len(self._ring),
                "replicas": replicas,
                "requests": self._requests,
                "reroutes": self._reroutes,
                "shed": self._shed,
                "failed": self._failed,
                "kv_transfers": self._kv_transfers,
                "kv_transfer_failures": self._kv_transfer_failures,
                "kv_transfer_bytes": self._kv_transfer_bytes,
                "kv_transfer_latency_s": round(self._kv_transfer_last_s, 6),
                # Fleet KV tier (the surface of the
                # tpu_serving_kv_peer_* families) + the robustness
                # ladder's own scoreboard.
                "kv_peer_fetches": self._kv_peer_fetches,
                "kv_peer_fetch_failures": self._kv_peer_fetch_failures,
                "kv_peer_bytes": self._kv_peer_bytes,
                "kv_peer_fetch_latency_s": round(
                    self._kv_peer_fetch_last_s, 6
                ),
                "kv_peer": {
                    "enabled": bool(self.kv_peer_fanout),
                    "fanout": self.kv_peer_fanout,
                    "timeout_s": self.kv_peer_timeout_s,
                    "max_bytes": self.kv_peer_max_bytes,
                    "quarantined": self._kv_peer_quarantined,
                    "quarantine": list(self._kv_peer_quarantine),
                    "single_flight_skips":
                        self._kv_peer_single_flight_skips,
                    "negative_hits": self._kv_peer_negative_hits,
                    "negative_cached": sorted(
                        ep for ep, (until, _)
                        in self._kv_peer_negative.items()
                        if until > time.monotonic()
                    ),
                    "failure_reasons": dict(self._kv_peer_fail_reasons),
                },
                "inflight": dict(self._inflight),
                # The fleet-level prefix-cache view, aggregated from the
                # per-replica /stats scrapes (satellite: the gateway's
                # routing report).
                "fleet_prefix_cache": {
                    "hits": hits,
                    "misses": misses,
                    "hit_ratio": round(hits / (hits + misses), 4)
                    if hits + misses else 0.0,
                },
            }
        # Assembled OUTSIDE self._lock: the autoscaler's stats() takes
        # its own lock, and its tick thread nests the locks the other
        # way around (autoscaler lock → gateway.stats → self._lock).
        if (self.replica_source is not None
                and hasattr(self.replica_source, "stats")):
            out["warm_claims"] = self.replica_source.stats()
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.stats()
        return out

    # -- HTTP --------------------------------------------------------------

    def _handler_class(self):
        gw = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            # Correlation id for the request being handled: the trace id
            # (caller's traceparent, or this gateway's fresh root trace).
            # Echoed to the client (X-Request-Id, SSE error payloads) and
            # forwarded to the replica so every layer logs the same id.
            _req_id = None

            def log_message(self, *args):
                pass

            def _json(self, code: int, payload: dict,
                      retry_after: Optional[int] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                if self._req_id:
                    self.send_header("X-Request-Id", self._req_id)
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    self.wfile.write(body)
                except OSError:
                    pass  # client gone; nothing to tell it

            def do_GET(self):
                if self.path == "/healthz":
                    n = len(gw.ring_nodes())
                    if n > 0:
                        self._json(200, {"status": "ok", "replicas": n})
                    else:
                        self._json(503, {"status": "no healthy replicas"})
                elif self.path == "/stats":
                    self._json(200, gw.stats())
                elif self.path == "/debug/traces":
                    ring = tracing.trace_ring()
                    self._json(200, {
                        "traces": ring.snapshot() if ring else [],
                    })
                elif self.path == "/debug/signals":
                    tel = gw.telemetry
                    self._json(200, tel.snapshot() if tel is not None
                               else {"enabled": False})
                elif self.path == "/debug/slo":
                    tel = gw.telemetry
                    if tel is None:
                        self._json(200, {"enabled": False})
                    else:
                        self._json(200, {"enabled": True,
                                         **tel.evaluate_slo()})
                elif self.path == "/debug/autoscaler":
                    scaler = gw.autoscaler
                    self._json(200, scaler.debug() if scaler is not None
                               else {"enabled": False})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/v1/completions":
                    self._json(404, {"error": "not found"})
                    return
                arrival = time.monotonic()
                # Root span of the whole distributed trace (unless the
                # caller already carries a traceparent, in which case the
                # gateway joins it); the replica hop continues the same
                # trace via the headers _proxy injects.
                with tracing.get_tracer("gateway").start_span(
                    "gateway.request",
                    traceparent=self.headers.get("traceparent"),
                ) as span:
                    self._req_id = (
                        self.headers.get("x-request-id")
                        or span.trace_id
                        or tracing.new_trace_id()
                    )
                    self._completions(arrival, span)

            def _completions(self, arrival: float, span) -> None:
                try:
                    body = _read_body(self, gw.max_body_bytes)
                except BodyTooLarge as err:
                    self._json(413, {"error": str(err)})
                    return
                except ValueError as err:
                    self._json(400, {"error": str(err)})
                    return
                try:
                    req = json.loads(body or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("request body must be an object")
                except ValueError as err:
                    self._json(400, {"error": str(err)})
                    return
                tenant = str(
                    self.headers.get("x-tenant")
                    or req.get("user") or "anonymous"
                )
                span.set_attribute("tenant", tenant)
                try:
                    gw._admit(tenant)
                except GatewayOverloadedError as err:
                    span.add_event("tenant_shed", {"tenant": tenant})
                    span.record_error(err)
                    self._json(429, {"error": str(err)}, retry_after=1)
                    return
                try:
                    self._route(req, arrival, tenant)
                finally:
                    gw._release(tenant)

            def _route(self, req: dict, arrival: float,
                       tenant: str) -> None:
                key = gw._route_key(req.get("prompt"),
                                    adapter=req.get("model"))
                counted = False
                if gw.tier_mode == "disagg":
                    outcome = self._route_disagg(req, arrival, tenant,
                                                 key)
                    if outcome == "done":
                        return
                    # "fallback-counted": the disagg attempt already
                    # counted the request (prefill ran; only the decode
                    # hop failed) — the fused retry must not double it.
                    counted = outcome == "fallback-counted"
                candidates = gw._candidates(key)
                if gw.kv_peer_fanout and candidates:
                    # Fleet KV tier (fused): warm the affinity target's
                    # prefix cache from a ring peer before routing.
                    # Base-model chains only — chain keys carry a
                    # replica-local adapter salt the gateway cannot
                    # recompute. Advisory and exception-contained: any
                    # failure means a plain local prefill.
                    prompt = req.get("prompt")
                    if not req.get("model") and isinstance(
                        prompt, list
                    ) and prompt and all(
                        isinstance(t, int) and not isinstance(t, bool)
                        for t in prompt
                    ):
                        try:
                            self._kv_peer_fetch(prompt, key,
                                                candidates[0])
                        except Exception:
                            pass
                # The routing decision is its own span: affinity mode,
                # candidate walk, and every re-route attempt (as events)
                # in one place.
                with tracing.get_tracer("gateway").start_span(
                    "gateway.route", affinity=gw.affinity,
                    candidates=len(candidates),
                ) as span:
                    self._route_span(req, arrival, candidates, span,
                                     tenant, counted=counted)

            def _route_span(self, req: dict, arrival: float,
                            candidates: list, span,
                            tenant: str, counted: bool = False) -> None:
                if not candidates:
                    span.record_error(
                        RuntimeError("no healthy replicas")
                    )
                    if gw.telemetry is not None:
                        gw.telemetry.observe_request(tenant, ok=False)
                    self._json(503, {"error": "no healthy replicas"},
                               retry_after=1)
                    return
                if not counted:
                    gw._count_request()
                deadline_s = req.get("deadline_s")
                stream = bool(req.get("stream", False))
                last = None
                for i, endpoint in enumerate(candidates):
                    if i:
                        gw._count_reroute()
                        span.add_event("reroute", {
                            "attempt": i, "endpoint": endpoint,
                            "prior": f"{last[0]}: {last[1]}"
                            if last else "unreachable",
                        })
                    span.set_attribute("endpoint", endpoint)
                    fwd = dict(req)
                    if isinstance(deadline_s, (int, float)) and not \
                            isinstance(deadline_s, bool):
                        # The client's budget covers the WHOLE request:
                        # forward only what gateway time left of it.
                        remaining = deadline_s - (time.monotonic() - arrival)
                        if remaining <= 0:
                            if gw.telemetry is not None:
                                gw.telemetry.observe_request(
                                    tenant, ok=False
                                )
                            self._json(504, {
                                "error": "deadline expired at the gateway",
                                "partial_tokens": [],
                            })
                            return
                        fwd["deadline_s"] = remaining
                    outcome, last = self._proxy(endpoint, fwd, stream,
                                                arrival, tenant)
                    if outcome == "done":
                        return
                # Budget exhausted: every candidate refused or was down.
                gw._count_failed()
                if gw.telemetry is not None:
                    gw.telemetry.observe_request(tenant, ok=False)
                code, detail = last if last else (503, "replicas unreachable")
                span.record_error(RuntimeError(
                    f"re-route budget exhausted: {detail}"
                ))
                self._json(code if code in (429, 503) else 503,
                           {"error": f"fleet exhausted re-route budget "
                                     f"({gw.reroute_budget}): {detail}"},
                           retry_after=1)

            # -- disaggregated prefill/decode tiers -----------------------

            def _route_disagg(self, req: dict, arrival: float,
                              tenant: str, key: bytes) -> str:
                """One disaggregated attempt: probe the decode tier's
                prefix chains, prefill on the prefill tier (suffix-only
                export), hand the paged-KV payload to a decode replica.

                Returns "done" when a response reached the client,
                "fallback" to run the fused path untouched, or
                "fallback-counted" when the request was already counted
                (prefill ran, decode hop failed)."""
                prompt = req.get("prompt")
                if not (isinstance(prompt, list) and prompt and all(
                    isinstance(t, int) and not isinstance(t, bool)
                    for t in prompt
                )):
                    return "fallback"  # text prompts tokenize replica-side
                if not req.get("stream"):
                    # Non-stream responses assemble replica-side; the
                    # handoff's first-token boundary only pays off for
                    # streamed decode.
                    return "fallback"
                if req.get("n", 1) != 1 or req.get("logprobs"):
                    return "fallback"
                if "kv_import" in req:
                    return "fallback"  # already a decode-tier hop
                mt = req.get("max_tokens")
                if mt is not None and (
                    not isinstance(mt, int) or isinstance(mt, bool)
                    or mt < 1
                ):
                    return "fallback"  # let the fused path 400 it
                prefills = gw._tier_candidates("prefill", key)
                decodes = gw._tier_candidates("decode", key)
                if not prefills or not decodes:
                    return "fallback"
                deadline_s = req.get("deadline_s")

                def remaining():
                    if isinstance(deadline_s, (int, float)) and not \
                            isinstance(deadline_s, bool):
                        return deadline_s - (time.monotonic() - arrival)
                    return None

                with tracing.get_tracer("gateway").start_span(
                    "gateway.route", affinity=gw.affinity,
                    tier_mode="disagg",
                    prefill_candidates=len(prefills),
                    decode_candidates=len(decodes),
                ) as span:
                    return self._disagg_span(
                        req, arrival, tenant, prompt, prefills, decodes,
                        remaining, span, key,
                    )

            def _disagg_span(self, req: dict, arrival: float,
                             tenant: str, prompt: list, prefills: list,
                             decodes: list, remaining, span,
                             key: bytes) -> str:
                # Probe the affinity-preferred decode replica for cached
                # prefix chains so the prefill tier exports only suffix
                # blocks — the same chain keys PagedBatcher stamps.
                keys_hex = [
                    k.hex() for k in prompt_chain_keys(
                        prompt, gw._router.block_size
                    )
                ]
                probe = self._kv_probe_replica(decodes[0], keys_hex) \
                    if keys_hex else None
                matched = probe[0] if probe else 0
                if (gw.kv_peer_fanout and keys_hex
                        and not req.get("model")
                        and matched < len(keys_hex)):
                    # Fleet KV tier (disagg): before the prefill tier
                    # re-computes the missing prefix, try to pull it
                    # from a ring peer into the decode replica so the
                    # prefill export shrinks to suffix blocks. Advisory:
                    # any failure leaves `matched` as probed.
                    try:
                        registered = self._kv_peer_fetch(
                            prompt, key, decodes[0], held=matched
                        )
                        if registered:
                            matched = max(matched, min(
                                int(registered), len(keys_hex)
                            ))
                    except Exception as exc:
                        span.add_event("kv_peer_fetch_error",
                                       {"error": str(exc)})
                skip = keys_hex[:matched]
                span.set_attribute("prefix_blocks_skipped", len(skip))
                result = None
                for i, endpoint in enumerate(prefills):
                    if i:
                        gw._count_reroute()
                        span.add_event("reroute", {
                            "attempt": i, "endpoint": endpoint,
                            "tier": "prefill",
                        })
                    rem = remaining()
                    if rem is not None and rem <= 0:
                        gw._count_request()
                        if gw.telemetry is not None:
                            gw.telemetry.observe_request(tenant, ok=False)
                        self._json(504, {
                            "error": "deadline expired at the gateway",
                            "partial_tokens": [],
                        })
                        return "done"
                    result = self._kv_prefill_replica(
                        endpoint, req, skip, rem
                    )
                    if result is not None:
                        span.set_attribute("prefill_endpoint", endpoint)
                        break
                if result is None:
                    gw._count_kv_transfer(False, 0, 0.0)
                    span.add_event("disagg_fallback", {"stage": "prefill"})
                    return "fallback"
                payload = result.get("payload")
                fin = result.get("finished") or {}
                mt = req.get("max_tokens")
                need_decode = (
                    payload is not None
                    and fin.get("finish_reason") == "length"
                    and (mt is None or mt > 1)
                )
                if not need_decode:
                    # The prefill token was the whole generation (EOS,
                    # stop sequence, or max_tokens == 1): answer from
                    # the prefill result, no transfer needed.
                    gw._count_request()
                    self._synthesize(result.get("id"), fin, tenant,
                                     arrival)
                    return "done"
                fwd = {k: v for k, v in req.items() if k != "prompt"}
                fwd["kv_import"] = payload
                rem = remaining()
                if rem is not None:
                    if rem <= 0:
                        gw._count_request()
                        if gw.telemetry is not None:
                            gw.telemetry.observe_request(tenant, ok=False)
                        self._json(504, {
                            "error": "deadline expired at the gateway",
                            "partial_tokens": [],
                        })
                        return "done"
                    fwd["deadline_s"] = rem
                body = json.dumps(fwd).encode()
                if len(body) > gw.kv_transfer_max_bytes:
                    gw._count_kv_transfer(False, len(body), 0.0)
                    span.add_event("disagg_fallback", {
                        "stage": "payload_size", "bytes": len(body),
                    })
                    return "fallback"
                gw._count_request()
                # A suffix-only payload binds to the probed replica (its
                # chain cache holds the skipped blocks); a full payload
                # may walk the decode tier.
                targets = decodes[:1] if skip else decodes
                last = None
                for i, endpoint in enumerate(targets):
                    if i:
                        gw._count_reroute()
                        span.add_event("reroute", {
                            "attempt": i, "endpoint": endpoint,
                            "tier": "decode",
                        })
                    outcome, last = self._kv_decode_hop(
                        endpoint, fwd, body, arrival, tenant
                    )
                    if outcome == "done":
                        span.set_attribute("decode_endpoint", endpoint)
                        return "done"
                span.add_event("disagg_fallback", {
                    "stage": "decode",
                    "prior": f"{last[0]}: {last[1]}" if last
                    else "unreachable",
                })
                return "fallback-counted"

            def _kv_trace_headers(self) -> dict:
                """Every /kv/* hop carries the trace: traceparent joins
                the replica-side span to this request's trace, and
                X-Request-Id survives even with tracing off."""
                headers = {"Content-Type": "application/json"}
                tp = tracing.format_traceparent(tracing.current_span())
                if tp:
                    headers["traceparent"] = tp
                if self._req_id:
                    headers["X-Request-Id"] = self._req_id
                return headers

            def _kv_probe_replica(self, endpoint: str, keys_hex: list,
                                  timeout: Optional[float] = None):
                """How many consecutive prompt chain keys the replica
                already holds, plus its per-chain payload byte estimate:
                ``(matched, payload_bytes)``, or None when the replica
                was unreachable/refused (a peer fetcher negative-caches
                that; a plain miss is ``(0, 0)``). Advisory only (no
                pinning): a racing eviction surfaces at import time and
                the request falls back."""
                rep = gw._replicas.get(endpoint)
                if rep is None:
                    return None
                try:
                    conn = http.client.HTTPConnection(
                        rep.host, rep.port,
                        timeout=(timeout if timeout is not None
                                 else gw.health_timeout_s),
                    )
                    try:
                        conn.request(
                            "POST", "/kv/probe",
                            json.dumps({"keys": keys_hex}).encode(),
                            self._kv_trace_headers(),
                        )
                        resp = conn.getresponse()
                        body = resp.read()
                    finally:
                        conn.close()
                    if resp.status != 200:
                        return None
                    out = json.loads(body)
                    matched = max(0, int(out.get("matched", 0)))
                    pbytes = max(0, int(out.get("payload_bytes", 0)))
                    return matched, pbytes
                except (OSError, ValueError, http.client.HTTPException):
                    return None

            # -- fleet KV tier (peer prefix fetch) -------------------------

            def _kv_peer_fetch(self, prompt: list, key: bytes,
                               target: str, held=None):
                """Read-through peer fetch: probe up to kv_peer_fanout
                ring successors for the prompt's chain keys, pick the
                longest matching chain (swap-resident links included —
                the peer promotes before export), pull it under the
                per-hop deadline + whole-fetch budget, and push it into
                ``target``'s prefix cache. Wholly advisory: every
                failure mode returns None and the request re-prefills
                locally. Concurrent fetches for the same chain are
                single-flighted. Returns the number of leading chain
                keys resident on the target after a successful import."""
                keys_hex = [
                    k.hex() for k in prompt_chain_keys(
                        prompt, gw._router.block_size
                    )
                ]
                if not keys_hex:
                    return None
                # Whole-fetch budget: one per-hop deadline for the
                # target probe plus one per probed peer. The ladder
                # stops wherever the budget runs out.
                deadline = time.monotonic() + gw.kv_peer_timeout_s * (
                    gw.kv_peer_fanout + 1
                )
                tail = keys_hex[-1]
                with gw._lock:
                    if tail in gw._kv_peer_inflight:
                        gw._kv_peer_single_flight_skips += 1
                        return None
                    gw._kv_peer_inflight.add(tail)
                try:
                    with tracing.get_tracer("gateway").start_span(
                        "kv_peer_fetch", target=target,
                        chain_blocks=len(keys_hex),
                    ) as span:
                        return self._kv_peer_fetch_span(
                            keys_hex, prompt, key, target, held,
                            deadline, span,
                        )
                finally:
                    with gw._lock:
                        gw._kv_peer_inflight.discard(tail)

            def _kv_peer_fetch_span(self, keys_hex: list, prompt: list,
                                    key: bytes, target: str, held,
                                    deadline: float, span):
                def rem():
                    return deadline - time.monotonic()

                def hop_timeout():
                    return max(0.001, min(gw.kv_peer_timeout_s, rem()))

                if held is None:
                    probe = self._kv_probe_replica(
                        target, keys_hex, timeout=hop_timeout()
                    )
                    held = probe[0] if probe else 0
                span.set_attribute("target_matched", held)
                if held >= len(keys_hex):
                    span.set_attribute("outcome", "already-warm")
                    return None
                # Bounded ring walk: at most kv_peer_fanout successors
                # of the route key, skipping the target itself and any
                # negative-cached peer.
                with gw._lock:
                    walk = gw._ring.successors(key, len(gw._ring))
                peers = []
                for ep in walk:
                    if ep == target:
                        continue
                    peers.append(ep)
                    if len(peers) >= gw.kv_peer_fanout:
                        break
                best = None  # (endpoint, matched, payload_bytes)
                for ep in peers:
                    if rem() <= 0:
                        gw._count_kv_peer_fetch(
                            False, 0, 0.0, reason="budget_exhausted"
                        )
                        span.set_attribute("outcome", "budget-exhausted")
                        return None
                    if gw._kv_peer_blocked(ep):
                        span.add_event("peer_skipped", {
                            "endpoint": ep, "reason": "negative-cache",
                        })
                        continue
                    probe = self._kv_probe_replica(
                        ep, keys_hex, timeout=hop_timeout()
                    )
                    if probe is None:
                        gw._kv_peer_backoff(ep)
                        gw._count_kv_peer_fetch(
                            False, 0, 0.0, reason="dead_peer"
                        )
                        span.add_event("peer_dead", {"endpoint": ep})
                        continue
                    matched, pbytes = probe
                    if matched <= held:
                        continue
                    if best is None or matched > best[1]:
                        best = (ep, matched, pbytes)
                    if matched >= len(keys_hex):
                        break
                if best is None:
                    span.set_attribute("outcome", "no-peer-chain")
                    return None
                ep, matched, pbytes = best
                span.set_attribute("peer", ep)
                span.set_attribute("peer_matched", matched)
                if pbytes > gw.kv_peer_max_bytes:
                    # The probe's byte advisory: refuse BEFORE pulling.
                    gw._count_kv_peer_fetch(
                        False, pbytes, 0.0, reason="oversized"
                    )
                    span.set_attribute("outcome", "oversized")
                    return None
                if rem() <= 0:
                    gw._count_kv_peer_fetch(
                        False, 0, 0.0, reason="budget_exhausted"
                    )
                    span.set_attribute("outcome", "budget-exhausted")
                    return None
                t0 = time.monotonic()
                pulled = self._kv_chain_pull(
                    ep, keys_hex[:matched], hop_timeout()
                )
                if pulled is None:
                    # Transport failure mid-export: the peer died or
                    # tore the response — a corpse is not re-probed.
                    gw._kv_peer_backoff(ep)
                    gw._count_kv_peer_fetch(
                        False, 0, time.monotonic() - t0,
                        reason="fetch_failed",
                    )
                    span.set_attribute("outcome", "fetch-failed")
                    return None
                nbytes, chain = pulled
                if chain is None:
                    reason = ("oversized"
                              if nbytes > gw.kv_peer_max_bytes
                              else "chain_gone")
                    gw._count_kv_peer_fetch(
                        False, nbytes, time.monotonic() - t0,
                        reason=reason,
                    )
                    span.set_attribute("outcome", reason)
                    return None
                status, registered = self._kv_chain_push(
                    target, prompt, chain, hop_timeout()
                )
                if status != 200:
                    if status == 400:
                        # Validation refusal (geometry/chain-key/
                        # version): quarantine, never retry the payload.
                        gw._kv_peer_quarantine_payload(
                            ep, registered if isinstance(registered, str)
                            else "validation refused"
                        )
                        reason = "quarantined"
                    else:
                        reason = "import_failed"
                    gw._count_kv_peer_fetch(
                        False, nbytes, time.monotonic() - t0,
                        reason=reason,
                    )
                    span.set_attribute("outcome", reason)
                    return None
                gw._kv_peer_recovered(ep)
                gw._count_kv_peer_fetch(
                    True, nbytes, time.monotonic() - t0
                )
                span.set_attribute("outcome", "imported")
                span.set_attribute("registered", registered)
                return registered

            def _kv_chain_pull(self, endpoint: str, keys_hex: list,
                               timeout: float):
                """POST /kv/chain to the chosen peer. Returns
                ``(nbytes, payload_dict)`` — payload None when the body
                blew the byte cap or the peer no longer holds the chain
                — or None on transport failure (caller backs off)."""
                rep = gw._replicas.get(endpoint)
                if rep is None:
                    return None
                try:
                    conn = http.client.HTTPConnection(
                        rep.host, rep.port, timeout=timeout
                    )
                    try:
                        conn.request(
                            "POST", "/kv/chain",
                            json.dumps({"keys": keys_hex}).encode(),
                            self._kv_trace_headers(),
                        )
                        resp = conn.getresponse()
                        # Cap enforcement while reading: one byte past
                        # the cap is enough to refuse the payload.
                        body = resp.read(gw.kv_peer_max_bytes + 1)
                    finally:
                        conn.close()
                    if resp.status != 200:
                        return None
                    if len(body) > gw.kv_peer_max_bytes:
                        return len(body), None
                    out = json.loads(body)
                    payload = (out.get("payload")
                               if isinstance(out, dict) else None)
                    return len(body), (payload if isinstance(
                        payload, dict) else None)
                except (OSError, ValueError, http.client.HTTPException):
                    return None

            def _kv_chain_push(self, endpoint: str, prompt: list,
                               payload: dict, timeout: float):
                """POST /kv/chain/import to the target replica. Returns
                ``(status, registered_count)`` on an answered hop —
                status 400 carries the validation error string instead
                of a count — or ``(None, 0)`` on transport failure."""
                rep = gw._replicas.get(endpoint)
                if rep is None:
                    return None, 0
                body = json.dumps({
                    "tokens": [int(t) for t in prompt],
                    "payload": payload,
                }).encode()
                try:
                    conn = http.client.HTTPConnection(
                        rep.host, rep.port, timeout=timeout
                    )
                    try:
                        conn.request("POST", "/kv/chain/import", body,
                                     self._kv_trace_headers())
                        resp = conn.getresponse()
                        rbody = resp.read()
                    finally:
                        conn.close()
                    if resp.status != 200:
                        detail = ""
                        try:
                            detail = str(
                                json.loads(rbody).get("error", "")
                            )
                        except ValueError:
                            pass
                        return resp.status, detail
                    return 200, max(
                        0, int(json.loads(rbody).get("registered", 0))
                    )
                except (OSError, ValueError, http.client.HTTPException):
                    return None, 0

            def _kv_prefill_replica(self, endpoint: str, req: dict,
                                    skip: list, rem):
                """One prefill-tier attempt. Returns the parsed
                ``/kv/prefill`` result (payload + finished tokens) or
                None when this replica refused or was unreachable."""
                rep = gw._replicas.get(endpoint)
                if rep is None:
                    return None
                fwd = {"prompt": req["prompt"], "skip_keys": skip}
                for k in ("temperature", "stop", "logit_bias", "model"):
                    if k in req:
                        fwd[k] = req[k]
                if rem is not None:
                    fwd["deadline_s"] = rem
                timeout = gw.upstream_timeout_s
                if rem is not None:
                    timeout = min(timeout, rem + 5.0)
                headers = {"Content-Type": "application/json"}
                tp = tracing.format_traceparent(tracing.current_span())
                if tp:
                    headers["traceparent"] = tp
                if self._req_id:
                    headers["X-Request-Id"] = self._req_id
                try:
                    conn = http.client.HTTPConnection(
                        rep.host, rep.port, timeout=timeout
                    )
                    try:
                        conn.request("POST", "/kv/prefill",
                                     json.dumps(fwd).encode(), headers)
                        resp = conn.getresponse()
                        body = resp.read()
                    finally:
                        conn.close()
                    if resp.status != 200:
                        return None
                    out = json.loads(body)
                    if isinstance(out, dict) and "finished" in out:
                        return out
                    return None
                except (OSError, ValueError, http.client.HTTPException):
                    # HTTPException covers the pod-death-mid-response
                    # shapes (IncompleteRead, BadStatusLine) a plain
                    # connection error never raises.
                    return None

            def _kv_decode_hop(self, endpoint: str, fwd: dict,
                               body: bytes, arrival: float, tenant: str):
                """POST the block payload to one decode replica and relay
                its stream. The ``kv_transfer`` span covers request →
                response headers — the wire hop plus the replica-side
                import, i.e. the gap between the prefill tier's
                ``prefill`` span and the decode tier's ``first_decode``."""
                rep = gw._replicas.get(endpoint)
                if rep is None:
                    return "retry", (503, f"{endpoint} left the fleet")
                timeout = gw.kv_transfer_timeout_s
                deadline_s = fwd.get("deadline_s")
                if isinstance(deadline_s, (int, float)):
                    timeout = min(timeout, float(deadline_s) + 5.0)
                headers = {"Content-Type": "application/json"}
                tp = tracing.format_traceparent(tracing.current_span())
                if tp:
                    headers["traceparent"] = tp
                if self._req_id:
                    headers["X-Request-Id"] = self._req_id
                t0 = time.monotonic()
                try:
                    with tracing.get_tracer("gateway").start_span(
                        "kv_transfer", endpoint=endpoint,
                        transfer_bytes=len(body),
                    ) as tspan:
                        try:
                            conn = http.client.HTTPConnection(
                                rep.host, rep.port, timeout=timeout
                            )
                            conn.request("POST", "/v1/completions",
                                         body, headers)
                            resp = conn.getresponse()
                        except (OSError,
                                http.client.HTTPException) as err:
                            tspan.record_error(err)
                            raise
                except (OSError, http.client.HTTPException):
                    gw._count_kv_transfer(False, len(body),
                                          time.monotonic() - t0)
                    return "retry", (503, f"{endpoint} unreachable")
                latency = time.monotonic() - t0
                ctype = resp.getheader("Content-Type", "")
                if resp.status != 200 or "text/event-stream" not in ctype:
                    try:
                        detail = json.loads(resp.read()).get(
                            "error", "refused")
                    except (OSError, ValueError):
                        detail = "refused"
                    conn.close()
                    gw._count_kv_transfer(False, len(body), latency)
                    return "retry", (resp.status,
                                     f"{endpoint}: {detail}")
                gw._count_kv_transfer(True, len(body), latency)
                if conn.sock is not None:
                    # The transfer deadline bounded the hop; the stream
                    # phase reverts to the ordinary upstream timeout.
                    conn.sock.settimeout(gw.upstream_timeout_s)
                return self._relay_stream(conn, resp, arrival, tenant)

            def _synthesize(self, rid, fin: dict, tenant: str,
                            arrival: float) -> None:
                """Answer a stream request straight from the prefill
                result (generation finished at the first token): same SSE
                shape a replica emits, so clients can't tell."""
                try:
                    self.send_response(200)
                    if self._req_id:
                        self.send_header("X-Request-Id", self._req_id)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    for tok in fin.get("tokens") or []:
                        self.wfile.write(
                            b"data: " + json.dumps(
                                {"id": rid, "token": tok}
                            ).encode() + b"\n\n"
                        )
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except OSError:
                    pass  # client gone mid-synthesis
                if gw.telemetry is not None:
                    gw.telemetry.observe_request(
                        tenant, ok=True,
                        ttft_s=time.monotonic() - arrival,
                        e2e_s=time.monotonic() - arrival,
                    )

            def _proxy(self, endpoint: str, req: dict, stream: bool,
                       arrival: float, tenant: str):
                """One attempt against one replica. Returns
                ("done", None) when a response (or a terminal error) was
                relayed, ("retry", (code, detail)) when the replica
                refused before any byte reached the client."""
                rep = gw._replicas.get(endpoint)
                if rep is None:
                    return "retry", (503, f"{endpoint} left the fleet")
                deadline_s = req.get("deadline_s")
                timeout = gw.upstream_timeout_s
                if isinstance(deadline_s, (int, float)):
                    timeout = min(timeout, float(deadline_s) + 5.0)
                # Propagate the trace across the HTTP hop: the replica's
                # server.request span joins this trace via the W3C
                # traceparent header; X-Request-Id rides along even when
                # tracing is off so the correlation id survives end to
                # end regardless.
                headers = {"Content-Type": "application/json"}
                tp = tracing.format_traceparent(tracing.current_span())
                if tp:
                    headers["traceparent"] = tp
                if self._req_id:
                    headers["X-Request-Id"] = self._req_id
                try:
                    conn = http.client.HTTPConnection(
                        rep.host, rep.port, timeout=timeout
                    )
                    conn.request(
                        "POST", "/v1/completions",
                        json.dumps(req).encode(),
                        headers,
                    )
                    resp = conn.getresponse()
                except OSError:
                    return "retry", (503, f"{endpoint} unreachable")
                if resp.status in (429, 503):
                    # Replica-side shed/drain answered before we relayed
                    # anything: eligible for the bounded re-route walk.
                    try:
                        detail = json.loads(resp.read()).get(
                            "error", "refused")
                    except (OSError, ValueError):
                        detail = "refused"
                    conn.close()
                    return "retry", (resp.status, f"{endpoint}: {detail}")
                ctype = resp.getheader("Content-Type", "")
                try:
                    if not stream or "text/event-stream" not in ctype:
                        # Errors (400/504/...) answer JSON even for
                        # stream requests — relay them as JSON too.
                        body = resp.read()
                        conn.close()
                        self._json(resp.status, json.loads(body))
                        if gw.telemetry is not None:
                            # Non-stream responses have no first-token
                            # boundary: e2e only, so the ttft_s series
                            # stays purely relay-measured.
                            gw.telemetry.observe_request(
                                tenant, ok=resp.status == 200,
                                e2e_s=time.monotonic() - arrival,
                            )
                        return "done", None
                    return self._relay_stream(conn, resp, arrival, tenant)
                except (OSError, ValueError):
                    # Replica died mid-body before ANY byte was relayed
                    # client-side (non-stream read) — safe to re-route;
                    # generation is idempotent.
                    conn.close()
                    if not stream:
                        return "retry", (503, f"{endpoint} died mid-read")
                    return "done", None

            def _relay_stream(self, conn, resp, arrival: float,
                              tenant: str):
                """SSE passthrough: relay lines as they arrive, peek for
                the client's FIN before each write (closing the upstream
                connection is the cancellation signal the replica's own
                _client_gone converts into an engine-side cancel).

                This is also where the telemetry plane's latencies come
                from: TTFT = arrival → first relayed data line and the
                gaps between data lines, measured at the point the bytes
                leave for the client — the fleet numbers are what a
                client actually experienced through the gateway."""
                started = False
                finished = False
                ttft = None
                last_data = None
                gaps: list = []
                try:
                    while True:
                        line = resp.fp.readline()
                        if not line:
                            break
                        if _client_gone(self.connection):
                            conn.close()  # upstream FIN → replica cancels
                            if finished:
                                # [DONE] already relayed: this is normal
                                # client teardown, not a cancel — the
                                # request completed.
                                self._observe_stream(tenant, True, ttft,
                                                     gaps, arrival)
                            return "done", None
                        if not started:
                            self.send_response(resp.status)
                            if self._req_id:
                                self.send_header("X-Request-Id",
                                                 self._req_id)
                            self.send_header("Content-Type",
                                             "text/event-stream")
                            self.send_header("Cache-Control", "no-cache")
                            self.send_header("Connection", "close")
                            self.end_headers()
                            started = True
                        self.wfile.write(line)
                        if line == b"data: [DONE]\n":
                            finished = True
                        elif line.startswith(b"data:"):
                            now_t = time.monotonic()
                            if ttft is None:
                                ttft = now_t - arrival
                            elif last_data is not None:
                                gaps.append(now_t - last_data)
                            last_data = now_t
                        if line == b"\n":
                            self.wfile.flush()
                            if finished:
                                # Terminator relayed: the stream is
                                # complete. Don't wait for upstream EOF —
                                # a client that hangs up right after
                                # [DONE] would race _client_gone and
                                # lose the completed request.
                                break
                    conn.close()
                    if not started:
                        # EOF before the first event: nothing reached the
                        # client, so the re-route walk may continue.
                        return "retry", (503, "empty replica response")
                    if not finished:
                        # A killed replica's socket often closes with a
                        # clean FIN, not a reset: EOF after bytes flowed
                        # but before [DONE] is the same mid-stream loss.
                        self._observe_stream(tenant, False, ttft, gaps,
                                             arrival)
                        return self._stream_lost()
                    self._observe_stream(tenant, True, ttft, gaps, arrival)
                    return "done", None
                except (BrokenPipeError, ConnectionResetError):
                    conn.close()  # client hung up; cancel upstream
                    if finished:
                        # The hangup came after the terminator: complete.
                        self._observe_stream(tenant, True, ttft, gaps,
                                             arrival)
                    return "done", None
                except OSError:
                    conn.close()
                    if started:
                        self._observe_stream(tenant, False, ttft, gaps,
                                             arrival)
                        return self._stream_lost()
                    # Nothing reached the client: the re-route walk may
                    # continue (budget exhaustion counts the failure).
                    return "retry", (503, "replica died before first byte")

            def _observe_stream(self, tenant: str, ok: bool, ttft,
                                gaps: list, arrival: float) -> None:
                if gw.telemetry is not None:
                    gw.telemetry.observe_request(
                        tenant, ok=ok, ttft_s=ttft, inter_token=gaps,
                        e2e_s=time.monotonic() - arrival,
                    )

            def _stream_lost(self):
                """UPSTREAM loss mid-stream: bytes already reached the
                client, so a re-route would splice two generations —
                terminate the stream distinguishably instead."""
                gw._count_failed()
                try:
                    # The error event carries the request id (the only
                    # correlation handle left once headers are gone —
                    # the chaos harness asserts it survives a replica
                    # kill). json.dumps keeps insertion order, so the
                    # "replica lost mid-stream" detail stays greppable.
                    self.wfile.write(
                        b"data: " + json.dumps({
                            "error": "replica lost mid-stream",
                            "request_id": self._req_id,
                        }).encode() + b"\n\ndata: [DONE]\n\n"
                    )
                    self.wfile.flush()
                except OSError:
                    pass
                return "done", None

        return Handler


def gateway_from_env(metrics=None, replica_source=None) -> ServingGateway:
    """Build an (unstarted) gateway from the KUBEFLOW_TPU_GATEWAY_* env
    contract. Raises on garbage — a hand-set env var must not silently
    fall back to defaults.

    With ``KUBEFLOW_TPU_AUTOSCALE_ENABLE`` on, the autoscaler scales up
    through ``replica_source``. The reference builds its warm-slice source
    over ``controller/slicepool.py``, which the port has not taken over
    (ROADMAP item 18), so without a source passed in this raises instead
    of serving a fleet that cannot grow."""
    import os

    def _int(name: str, default: int, minimum: int) -> int:
        raw = os.environ.get(name, "").strip()
        if not raw:
            return default
        try:
            value = int(raw)
        except ValueError:
            value = minimum - 1
        if value < minimum:
            raise ValueError(
                f"{name}={raw!r}: want an integer >= {minimum}"
            )
        return value

    port = _int(KUBEFLOW_TPU_GATEWAY_PORT, 8080, 0)
    if port > 65535:
        raise ValueError(f"{KUBEFLOW_TPU_GATEWAY_PORT}={port}: want <= 65535")
    raw_replicas = os.environ.get(KUBEFLOW_TPU_GATEWAY_REPLICAS, "").strip()
    replicas = [r.strip() for r in raw_replicas.split(",") if r.strip()]
    for r in replicas:
        _parse_endpoint(r)  # fail loudly before serving into nothing
    affinity = os.environ.get(
        KUBEFLOW_TPU_GATEWAY_AFFINITY, "").strip().lower() or "prefix"
    if affinity not in AFFINITY_MODES:
        raise ValueError(
            f"{KUBEFLOW_TPU_GATEWAY_AFFINITY}={affinity!r}: want one of "
            f"{AFFINITY_MODES}"
        )
    raw_seed = os.environ.get(KUBEFLOW_TPU_GATEWAY_HASH_SEED, "").strip()
    try:
        seed = int(raw_seed) if raw_seed else 0
    except ValueError:
        raise ValueError(
            f"{KUBEFLOW_TPU_GATEWAY_HASH_SEED}={raw_seed!r}: want an integer"
        )
    budget = _int(KUBEFLOW_TPU_GATEWAY_REROUTE_BUDGET, 2, 0)
    tier_mode = os.environ.get(
        KUBEFLOW_TPU_GATEWAY_TIER_MODE, "").strip().lower() or "fused"
    if tier_mode not in ("fused", "disagg"):
        raise ValueError(
            f"{KUBEFLOW_TPU_GATEWAY_TIER_MODE}={tier_mode!r}: want "
            f"'fused' or 'disagg'"
        )
    tier_roles: dict = {}
    for env_name, role in ((KUBEFLOW_TPU_GATEWAY_TIER_PREFILL, "prefill"),
                           (KUBEFLOW_TPU_GATEWAY_TIER_DECODE, "decode")):
        raw = os.environ.get(env_name, "").strip()
        for ep in (r.strip() for r in raw.split(",") if r.strip()):
            _parse_endpoint(ep)
            if tier_roles.get(ep, role) != role:
                raise ValueError(
                    f"{env_name}: endpoint {ep!r} listed in both tiers"
                )
            tier_roles[ep] = role
            if ep not in replicas:
                replicas.append(ep)
    raw_timeout = os.environ.get(
        KUBEFLOW_TPU_KV_TRANSFER_TIMEOUT_S, "").strip()
    try:
        kv_timeout = float(raw_timeout) if raw_timeout else 30.0
    except ValueError:
        kv_timeout = 0.0
    if kv_timeout <= 0:
        raise ValueError(
            f"{KUBEFLOW_TPU_KV_TRANSFER_TIMEOUT_S}={raw_timeout!r}: "
            f"want a number > 0"
        )
    kv_max_bytes = _int(KUBEFLOW_TPU_KV_TRANSFER_MAX_BYTES,
                        KV_TRANSFER_MAX_BYTES, 1)
    # Peer tier: unset fanout keeps it fully inert (zero hot-path cost,
    # zero new sockets); a set value must be a sane bound.
    kv_peer_fanout = _int(KUBEFLOW_TPU_KV_PEER_FANOUT, 0, 1)
    raw_peer_timeout = os.environ.get(
        KUBEFLOW_TPU_KV_PEER_TIMEOUT_S, "").strip()
    try:
        kv_peer_timeout = float(raw_peer_timeout) if raw_peer_timeout \
            else 5.0
    except ValueError:
        kv_peer_timeout = 0.0
    if kv_peer_timeout <= 0:
        raise ValueError(
            f"{KUBEFLOW_TPU_KV_PEER_TIMEOUT_S}={raw_peer_timeout!r}: "
            f"want a number > 0"
        )
    kv_peer_max_bytes = _int(KUBEFLOW_TPU_KV_PEER_MAX_BYTES, 64 << 20, 1)
    if replica_source is None and autoscaler_from_env() is not None:
        raise ValueError(
            f"{KUBEFLOW_TPU_AUTOSCALE_ENABLE} is on but no replica_source was "
            f"given: the warm-slice replica source needs the port of "
            f"controller/slicepool.py (ROADMAP item 18)"
        )
    return ServingGateway(
        replicas=replicas, port=port, affinity=affinity, hash_seed=seed,
        reroute_budget=budget, metrics=metrics,
        replica_source=replica_source, tier_mode=tier_mode,
        tier_roles=tier_roles, kv_transfer_timeout_s=kv_timeout,
        kv_transfer_max_bytes=kv_max_bytes,
        kv_peer_fanout=kv_peer_fanout,
        kv_peer_timeout_s=kv_peer_timeout,
        kv_peer_max_bytes=kv_peer_max_bytes,
    )
