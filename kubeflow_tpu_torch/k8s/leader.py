"""Lease-based leader election.

The port's own copy of ``kubeflow_tpu/k8s/leader.py``.

The reference enables single-active-manager semantics via controller-runtime's
leader election (reference components/notebook-controller/main.go:87-94
``LeaderElection: enableLeaderElection, LeaderElectionID:
"kubeflow-notebook-controller"``; ODH main.go:241-242). controller-runtime
implements that on a coordination.k8s.io/v1 ``Lease``; this module implements
the same protocol against the Client interface so two Manager processes
never reconcile concurrently.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import AlreadyExistsError, ConflictError, NotFoundError

UPSTREAM_LEASE = "kubeflow-notebook-controller"
PLATFORM_LEASE = "odh-notebook-controller"


class LeaderElector:
    """Acquire/renew/release one named Lease.

    Protocol (matches client-go leaderelection resourcelock semantics):
    - acquire: create the Lease, or take it over once ``renewTime +
      leaseDurationSeconds`` has passed; stale-resourceVersion conflicts
      mean another candidate won the race.
    - renew: update ``renewTime`` while holding.
    - release: zero out ``holderIdentity`` so the next candidate acquires
      immediately instead of waiting out the lease.
    """

    def __init__(
        self,
        client: Client,
        lease_name: str,
        namespace: str,
        identity: str,
        lease_duration: float = 15.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.client = client
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity
        self.lease_duration = lease_duration
        self.clock = clock or time.time
        self.transitions = 0

    # -- helpers -----------------------------------------------------------

    def _new_lease(self) -> dict:
        now = self.clock()
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.lease_name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": int(self.lease_duration),
                "acquireTime": now,
                "renewTime": now,
                "leaseTransitions": self.transitions,
            },
        }

    def _expired(self, lease: dict) -> bool:
        spec = lease.get("spec", {})
        renew = spec.get("renewTime", 0.0)
        duration = spec.get("leaseDurationSeconds", self.lease_duration)
        return self.clock() >= renew + duration

    # -- protocol ----------------------------------------------------------

    def try_acquire(self) -> bool:
        """One acquire-or-renew attempt. Returns True iff we hold the lease."""
        try:
            lease = self.client.get("Lease", self.lease_name, self.namespace)
        except NotFoundError:
            try:
                self.client.create(self._new_lease())
                return True
            except (AlreadyExistsError, ConflictError):
                return False

        spec = lease.setdefault("spec", {})
        holder = spec.get("holderIdentity", "")
        if holder == self.identity:
            spec["renewTime"] = self.clock()
            try:
                self.client.update(lease)
                return True
            except (ConflictError, NotFoundError):
                return False
        if holder and not self._expired(lease):
            return False
        # Vacant or expired: take over.
        self.transitions = spec.get("leaseTransitions", 0) + 1
        spec.update(
            holderIdentity=self.identity,
            acquireTime=self.clock(),
            renewTime=self.clock(),
            leaseTransitions=self.transitions,
        )
        try:
            self.client.update(lease)
            return True
        except (ConflictError, NotFoundError):
            return False

    def is_leader(self) -> bool:
        try:
            lease = self.client.get("Lease", self.lease_name, self.namespace)
        except NotFoundError:
            return False
        spec = lease.get("spec", {})
        return spec.get("holderIdentity") == self.identity and not self._expired(lease)

    def release(self) -> None:
        """Graceful handoff on shutdown (client-go ReleaseOnCancel)."""
        try:
            lease = self.client.get("Lease", self.lease_name, self.namespace)
        except NotFoundError:
            return
        if lease.get("spec", {}).get("holderIdentity") != self.identity:
            return
        lease["spec"]["holderIdentity"] = ""
        lease["spec"]["renewTime"] = 0.0
        try:
            self.client.update(lease)
        except (ConflictError, NotFoundError):
            pass
