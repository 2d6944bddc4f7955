"""Prometheus metrics of the controller, the serving stack and the fleet.

The port's own copy of ``kubeflow_tpu/metrics/metrics.py`` over its own
registry (``registry.py``; the card's machine has no
``prometheus_client``). The bundle has the JAX package's families, HELP
strings, label names and bucket bounds, in its order, and the same
``STATS_PARITY`` table, so a scrape of either package reads the same
series and JAX's dashboards and alerts read the port:

- the reference set: ``notebook_create_total``,
  ``notebook_create_failed_total``, ``notebook_culling_total``,
  ``last_notebook_culling_timestamp_seconds`` and ``notebook_running``,
  recomputed from the StatefulSets on every scrape (``collect_running``);
- the slice, checkpoint, serving, gateway, KV, speculation, LoRA,
  autoscaler, migration and SLO families.

Family names stay JAX's: ``tpu_chips_in_use`` and
``tpu_chips_reclaimed_total`` count ``nvidia.com/gpu`` cards, and their
HELP strings say "GPU cards" where JAX's say "TPU chips", the one HELP
that differs.
"""

from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.metrics.registry import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

GPU_RESOURCE = "nvidia.com/gpu"

# Every serving/engine metric family must stay visible in the servers' JSON
# /stats payload so an operator tailing /stats and a dashboard scraping
# /metrics can never disagree about which observables exist.  The value is
# the /stats key the family surfaces under (a string literal of
# models/server.py or models/gateway.py). The JAX package's table, entry
# for entry.
STATS_PARITY = {
    "tpu_serving_requests_shed_total": "requests_shed",
    "tpu_serving_requests_cancelled_total": "requests_cancelled",
    "tpu_serving_deadline_expired_total": "deadline_expired",
    "tpu_serving_queue_depth": "queued",
    "tpu_serving_drain_seconds": "drain_duration_s",
    "tpu_serving_ragged_batch_fill": "batch_fill",
    "tpu_serving_prefix_cache_hits_total": "hits",
    "tpu_serving_prefix_cache_misses_total": "misses",
    "tpu_serving_prefix_cache_evictions_total": "evictions",
    "tpu_serving_prefix_cached_blocks": "cached_blocks",
    "tpu_engine_step_stall_total": "engine_step_stalls",
    "tpu_gateway_requests_total": "requests",
    "tpu_gateway_reroutes_total": "reroutes",
    "tpu_gateway_shed_total": "shed",
    "tpu_gateway_replicas": "ring_size",
    "tpu_serving_kv_transfer_total": "kv_transfers",
    "tpu_serving_kv_transfer_failures_total": "kv_transfer_failures",
    "tpu_serving_kv_transfer_bytes_total": "kv_transfer_bytes",
    "tpu_serving_kv_transfer_latency_seconds": "kv_transfer_latency_s",
    "tpu_serving_kv_peer_fetch_total": "kv_peer_fetches",
    "tpu_serving_kv_peer_fetch_failures_total": "kv_peer_fetch_failures",
    "tpu_serving_kv_peer_bytes_total": "kv_peer_bytes",
    "tpu_serving_kv_peer_fetch_latency_seconds": "kv_peer_fetch_latency_s",
    "tpu_serving_kv_swap_out_total": "swap_out",
    "tpu_serving_kv_swap_in_total": "swap_in",
    "tpu_serving_kv_swap_restored_tokens_total": "restored_tokens",
    "tpu_serving_kv_swap_bytes": "swap_bytes",
    "tpu_serving_spec_accept_total": "accepted",
    "tpu_serving_spec_rounds_total": "rounds",
    "tpu_serving_lora_cache_hits_total": "hits",
    "tpu_serving_lora_cache_misses_total": "misses",
    "tpu_serving_lora_cache_evictions_total": "evictions",
    "tpu_autoscaler_scale_up_total": "scale_ups",
    "tpu_autoscaler_scale_down_total": "scale_downs",
    "tpu_autoscaler_hold_total": "holds",
    "tpu_autoscaler_freeze_total": "freezes",
    "tpu_autoscaler_claim_attempts_total": "claim_attempts",
    "tpu_autoscaler_claim_failures_total": "claim_failures",
    "tpu_autoscaler_claim_latency_seconds": "claim_latency_s",
    "tpu_autoscaler_replicas": "tier_replicas",
    "tpu_migration_started_total": "migrations_started",
    "tpu_migration_completed_total": "migrations_completed",
    "tpu_migration_fallback_total": "migrations_fell_back",
    "tpu_migration_seconds": "migration_last_s",
}


class Metrics:
    """Per-manager metric bundle with an isolated registry (testable)."""

    def __init__(self, client: Optional[Client] = None):
        self.registry = CollectorRegistry()
        self.client = client
        self.create_total = Counter(
            "notebook_create_total",
            "Total times the controller created a notebook StatefulSet",
            registry=self.registry,
        )
        self.create_failed_total = Counter(
            "notebook_create_failed_total",
            "Total notebook StatefulSet creation failures",
            registry=self.registry,
        )
        self.culling_total = Counter(
            "notebook_culling_total",
            "Total notebooks culled for idleness",
            registry=self.registry,
        )
        self.last_culling_timestamp = Gauge(
            "last_notebook_culling_timestamp_seconds",
            "Unix time of the most recent culling",
            registry=self.registry,
        )
        # -- TPU-native additions ------------------------------------------
        self.slice_ready_seconds = Histogram(
            "tpu_slice_ready_seconds",
            "Seconds from Notebook creation to all slice hosts Ready",
            buckets=(5, 10, 20, 30, 45, 60, 90, 120, 180, 300, 600),
            registry=self.registry,
        )
        self.slice_preemptions_total = Counter(
            "tpu_slice_preemptions_total",
            "Slice host preemptions/evictions observed",
            registry=self.registry,
        )
        self.slice_recovery_seconds = Histogram(
            "tpu_slice_recovery_seconds",
            "Seconds from slice interruption to all hosts Ready again",
            buckets=(10, 30, 60, 120, 300, 600, 1200, 1800, 3600),
            registry=self.registry,
        )
        self.slice_recovery_escalations_total = Counter(
            "tpu_slice_recovery_escalations_total",
            "Recovery escalations (warm-pool claim or StatefulSet recreate)",
            registry=self.registry,
        )
        self.slice_recovery_failed_total = Counter(
            "tpu_slice_recovery_failed_total",
            "Interruptions that exhausted escalations and went terminal",
            registry=self.registry,
        )
        self.chips_reclaimed_total = Counter(
            "tpu_chips_reclaimed_total",
            "GPU cards released by culling or stop",
            registry=self.registry,
        )
        self.pool_claims_total = Counter(
            "tpu_slicepool_claims_total",
            "Warm slices claimed by notebook spawns",
            registry=self.registry,
        )
        self.pool_claim_misses_total = Counter(
            "tpu_slicepool_claim_misses_total",
            "TPU notebook spawns that found no matching warm slice",
            registry=self.registry,
        )
        self.pool_warm_ready = Gauge(
            "tpu_slicepool_warm_ready",
            "All-Ready warm placeholder slices per pool",
            ["pool"],
            registry=self.registry,
        )
        self.running = Gauge(
            "notebook_running",
            "Currently running notebooks (replicas > 0)",
            registry=self.registry,
        )
        self.tpu_chips_in_use = Gauge(
            "tpu_chips_in_use",
            "GPU cards currently held by running notebook slices",
            registry=self.registry,
        )
        self.prepull_nodes_covered = Gauge(
            "tpu_prepull_nodes_covered",
            "TPU nodes whose pre-pull pod Succeeded for the current image set",
            registry=self.registry,
        )
        self.prepull_nodes_target = Gauge(
            "tpu_prepull_nodes_target",
            "TPU nodes the image pre-puller is maintaining pods for",
            registry=self.registry,
        )
        # -- checkpoint durability (runtime/checkpoint.py) -----------------
        # Exposed from the notebook runtime when the manager is built with
        # metrics=; save duration feeds the emergency-save budget heuristic
        # (a save slower than the grace window is skipped, not torn).
        self.checkpoint_save_seconds = Histogram(
            "tpu_checkpoint_save_seconds",
            "Wall-clock duration of committed checkpoint saves",
            buckets=(0.1, 0.5, 1, 2, 5, 10, 20, 30, 60, 120, 300),
            registry=self.registry,
        )
        self.checkpoint_corrupt_total = Counter(
            "tpu_checkpoint_corrupt_total",
            "Checkpoint steps that failed manifest validation and were "
            "quarantined at restore",
            registry=self.registry,
        )
        self.checkpoint_emergency_total = Counter(
            "tpu_checkpoint_emergency_total",
            "Emergency (SIGTERM grace-window) checkpoint saves committed",
            registry=self.registry,
        )
        # -- serving request lifecycle (models/server.py) ------------------
        # The InferenceServer mirrors its /stats lifecycle counters here
        # when constructed with metrics=; shed/cancel/deadline rates are
        # the overload-protection observables the chaos experiments pin.
        self.serving_requests_shed_total = Counter(
            "tpu_serving_requests_shed_total",
            "Requests refused with 429 because the pending queue was full",
            registry=self.registry,
        )
        self.serving_requests_cancelled_total = Counter(
            "tpu_serving_requests_cancelled_total",
            "Requests cancelled before completing (client disconnects)",
            registry=self.registry,
        )
        self.serving_deadline_expired_total = Counter(
            "tpu_serving_deadline_expired_total",
            "Requests retired engine-side after their deadline expired",
            registry=self.registry,
        )
        self.serving_queue_depth = Gauge(
            "tpu_serving_queue_depth",
            "Pending (unslotted) inference requests",
            registry=self.registry,
        )
        self.serving_drain_seconds = Gauge(
            "tpu_serving_drain_seconds",
            "Duration of the most recent graceful drain",
            registry=self.registry,
        )
        self.serving_ragged_batch_fill = Gauge(
            "tpu_serving_ragged_batch_fill",
            "Fraction of the ragged engine's last-step token budget "
            "carrying real (decode or prefill-chunk) tokens",
            registry=self.registry,
        )
        # -- engine flight recorder (observability/flight.py) --------------
        # Mirrored from the recorder's stall ledger by the InferenceServer
        # drive loop (same delta pattern as the prefix-cache counters).
        self.engine_step_stall_total = Counter(
            "tpu_engine_step_stall_total",
            "Engine steps whose duration exceeded the flight recorder's "
            "stall threshold (k x rolling-median step time)",
            registry=self.registry,
        )
        # -- prefix cache (models/paged.py PagedBatcher(prefix_cache=True))
        # Mirrored from the engine's host-side counters by the
        # InferenceServer drive loop; the gateway scrapes the same numbers
        # from /stats for its routing report, so the fleet-level hit ratio
        # and the per-replica Prometheus view can never disagree.
        self.serving_prefix_cache_hits_total = Counter(
            "tpu_serving_prefix_cache_hits_total",
            "Prompt blocks admitted from the warm prefix-chain cache "
            "(prefill skipped for these blocks)",
            registry=self.registry,
        )
        self.serving_prefix_cache_misses_total = Counter(
            "tpu_serving_prefix_cache_misses_total",
            "Registrable prompt blocks that missed the prefix-chain cache "
            "and were prefetched cold",
            registry=self.registry,
        )
        self.serving_prefix_cache_evictions_total = Counter(
            "tpu_serving_prefix_cache_evictions_total",
            "Prefix-chain leaf blocks evicted to make room in the block "
            "pool",
            registry=self.registry,
        )
        self.serving_prefix_cached_blocks = Gauge(
            "tpu_serving_prefix_cached_blocks",
            "Blocks currently registered on warm prefix chains",
            registry=self.registry,
        )
        # -- fleet gateway (models/gateway.py ServingGateway) --------------
        self.gateway_requests_total = Counter(
            "tpu_gateway_requests_total",
            "Completion requests accepted and proxied to a replica",
            registry=self.registry,
        )
        self.gateway_reroutes_total = Counter(
            "tpu_gateway_reroutes_total",
            "Requests re-routed to the next ring node after a "
            "503/429/connect failure (bounded by the re-route budget)",
            registry=self.registry,
        )
        # The tenant label is bounded by the gateway's top-K + "other"
        # bucketing (signals.TenantBuckets), never raw tenant names.
        self.gateway_shed_total = Counter(
            "tpu_gateway_shed_total",
            "Requests shed by the gateway's tenant-fair admission when "
            "the whole fleet reported overload",
            ["tenant"],
            registry=self.registry,
        )
        self.gateway_replicas = Gauge(
            "tpu_gateway_replicas",
            "Replicas currently routable (present in the hash ring)",
            registry=self.registry,
        )
        # -- disaggregated serving (prefill→decode paged-KV handoff) ------
        self.serving_kv_transfer_total = Counter(
            "tpu_serving_kv_transfer_total",
            "Prefill→decode KV handoffs completed by the gateway",
            registry=self.registry,
        )
        self.serving_kv_transfer_failures_total = Counter(
            "tpu_serving_kv_transfer_failures_total",
            "KV handoffs that failed (prefill hop, transfer, or decode "
            "import) and fell back within the re-route budget",
            registry=self.registry,
        )
        self.serving_kv_transfer_bytes_total = Counter(
            "tpu_serving_kv_transfer_bytes_total",
            "Serialized KV payload bytes shipped prefill→decode",
            registry=self.registry,
        )
        self.serving_kv_transfer_latency_seconds = Gauge(
            "tpu_serving_kv_transfer_latency_seconds",
            "Duration of the most recent KV transfer hop (payload POST "
            "through decode-side import acknowledgement)",
            registry=self.registry,
        )
        # -- fleet KV tier (peer prefix fetch, models/gateway.py) ----------
        self.serving_kv_peer_fetch_total = Counter(
            "tpu_serving_kv_peer_fetch_total",
            "Peer prefix chains fetched from a ring successor and "
            "imported instead of re-prefilling",
            registry=self.registry,
        )
        self.serving_kv_peer_fetch_failures_total = Counter(
            "tpu_serving_kv_peer_fetch_failures_total",
            "Peer prefix fetches that degraded to local re-prefill "
            "(dead peer, budget, oversized, quarantine, import refusal)",
            registry=self.registry,
        )
        self.serving_kv_peer_bytes_total = Counter(
            "tpu_serving_kv_peer_bytes_total",
            "Serialized chain payload bytes pulled from peers",
            registry=self.registry,
        )
        self.serving_kv_peer_fetch_latency_seconds = Gauge(
            "tpu_serving_kv_peer_fetch_latency_seconds",
            "Duration of the most recent peer fetch (chain pull through "
            "target-side import acknowledgement)",
            registry=self.registry,
        )
        # -- HBM economy (host-RAM block swap, models/paged.py) ------------
        self.serving_kv_swap_out_total = Counter(
            "tpu_serving_kv_swap_out_total",
            "Prefix-chain blocks demoted from the device pool to the "
            "host-RAM swap tier instead of being evicted outright",
            registry=self.registry,
        )
        self.serving_kv_swap_in_total = Counter(
            "tpu_serving_kv_swap_in_total",
            "Swap-resident blocks promoted back into the device pool at "
            "admission or KV import (re-prefill skipped)",
            registry=self.registry,
        )
        self.serving_kv_swap_restored_tokens_total = Counter(
            "tpu_serving_kv_swap_restored_tokens_total",
            "Prompt tokens whose prefill was skipped by a swap restore",
            registry=self.registry,
        )
        self.serving_kv_swap_bytes = Gauge(
            "tpu_serving_kv_swap_bytes",
            "Host RAM currently held by the block-swap tier",
            registry=self.registry,
        )
        # -- speculative decoding (models/speculative.py spec engines) -----
        self.serving_spec_accept_total = Counter(
            "tpu_serving_spec_accept_total",
            "Draft proposals accepted by target verification (each one is "
            "a decode token that cost 1/k of a target forward)",
            registry=self.registry,
        )
        self.serving_spec_rounds_total = Counter(
            "tpu_serving_spec_rounds_total",
            "Speculative draft-verify rounds driven (one fused verify "
            "dispatch per round on the ragged engine)",
            registry=self.registry,
        )
        # -- multi-LoRA serving (models/multilora.py hot-adapter cache) ----
        self.serving_lora_cache_hits_total = Counter(
            "tpu_serving_lora_cache_hits_total",
            "Requests whose adapter was already hot in the replica's "
            "bounded adapter cache",
            registry=self.registry,
        )
        self.serving_lora_cache_misses_total = Counter(
            "tpu_serving_lora_cache_misses_total",
            "Requests that had to load a cold adapter (the cost "
            "(prefix, adapter) affinity routing exists to avoid)",
            registry=self.registry,
        )
        self.serving_lora_cache_evictions_total = Counter(
            "tpu_serving_lora_cache_evictions_total",
            "Adapters evicted from the bounded hot-adapter cache (LRU)",
            registry=self.registry,
        )
        # -- fleet autoscaler (models/autoscaler.py) -----------------------
        self.autoscaler_scale_up_total = Counter(
            "tpu_autoscaler_scale_up_total",
            "Warm-slice claims the autoscaler made on sustained "
            "up-pressure (successful scale-up actions)",
            registry=self.registry,
        )
        self.autoscaler_scale_down_total = Counter(
            "tpu_autoscaler_scale_down_total",
            "Drain-then-release scale-downs the autoscaler initiated on "
            "sustained ebb",
            registry=self.registry,
        )
        self.autoscaler_hold_total = Counter(
            "tpu_autoscaler_hold_total",
            "Desired scale actions suppressed by a guard (cooldown, "
            "rate limit, min/max bound, headroom, claim backoff)",
            registry=self.registry,
        )
        self.autoscaler_freeze_total = Counter(
            "tpu_autoscaler_freeze_total",
            "Freeze episodes: scaling halted on missing or stale "
            "telemetry instead of acting on garbage",
            registry=self.registry,
        )
        self.autoscaler_claim_attempts_total = Counter(
            "tpu_autoscaler_claim_attempts_total",
            "Warm-slice claim attempts issued by the autoscaler",
            registry=self.registry,
        )
        self.autoscaler_claim_failures_total = Counter(
            "tpu_autoscaler_claim_failures_total",
            "Claim attempts that returned nothing (warm pool empty or "
            "claim error) — each starts a jittered backoff",
            registry=self.registry,
        )
        self.autoscaler_claim_latency_seconds = Gauge(
            "tpu_autoscaler_claim_latency_seconds",
            "Wall-clock latency of the most recent warm-slice claim",
            registry=self.registry,
        )
        self.autoscaler_replicas = Gauge(
            "tpu_autoscaler_replicas",
            "In-ring replicas per serving tier as the autoscaler last "
            "counted them",
            ["tier"],
            registry=self.registry,
        )
        # -- live slice migration (runtime/migration.py) -------------------
        self.migration_started_total = Counter(
            "tpu_migration_started_total",
            "Proactive migrations started (preemption notice, idle-cull, "
            "or operator trigger)",
            registry=self.registry,
        )
        self.migration_completed_total = Counter(
            "tpu_migration_completed_total",
            "Migrations that completed all four steps (save, claim, "
            "restore, flip) within their budgets",
            registry=self.registry,
        )
        self.migration_fallback_total = Counter(
            "tpu_migration_fallback_total",
            "Migrations that blew a step budget or hit a step failure and "
            "degraded to the reactive recovery ladder",
            registry=self.registry,
        )
        self.migration_seconds = Gauge(
            "tpu_migration_seconds",
            "Wall-clock duration of the most recent migration attempt "
            "(completed or fallen back)",
            registry=self.registry,
        )
        # -- SLO burn-rate engine (observability/slo.py) -------------------
        # Deliberately outside STATS_PARITY: these are the telemetry
        # plane's own output, surfaced as JSON under /debug/slo rather
        # than the servers' /stats contract.
        self.slo_burn_rate = Gauge(
            "tpu_slo_burn_rate",
            "Error-budget burn rate per SLO objective and window "
            "(1.0 = burning exactly the budget)",
            ["objective", "window"],
            registry=self.registry,
        )
        self.slo_breach_total = Counter(
            "tpu_slo_breach_total",
            "SLO breach alerts latched by the burn-rate engine",
            ["objective"],
            registry=self.registry,
        )

    def collect_running(self) -> None:
        """Recompute run-state gauges by listing StatefulSets, as the
        reference's custom Collector does on scrape (metrics.go:82-99):
        ``tpu_chips_in_use`` sums the ``nvidia.com/gpu`` limits."""
        if self.client is None:
            return
        running = 0
        chips = 0
        for sts in self.client.list("StatefulSet"):
            replicas = sts.get("spec", {}).get("replicas", 0)
            if replicas > 0:
                running += 1
                template = sts.get("spec", {}).get("template", {}).get("spec", {})
                for c in template.get("containers", []):
                    per_host = int(
                        c.get("resources", {}).get("limits", {}).get(GPU_RESOURCE, 0) or 0
                    )
                    chips += per_host * replicas
        self.running.set(running)
        self.tpu_chips_in_use.set(chips)

    def expose(self) -> bytes:
        """Prometheus text exposition (the /metrics endpoint body)."""
        self.collect_running()
        return generate_latest(self.registry)
