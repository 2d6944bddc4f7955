"""Cluster TLS security profile: fetch + change watcher.

The port's own copy of ``kubeflow_tpu/controller/tls.py``. Reference
parity: the ODH manager reads the cluster-wide TLS policy from the
OpenShift ``APIServer`` CR named ``cluster`` and configures its
webhook/metrics listeners from it, falling back to a hardened cipher list
when the CR is absent or unreadable (reference
components/odh-notebook-controller/main.go:71-78,183-234). A
``SecurityProfileWatcher`` then watches that CR and cancels the manager
context (restarts the pod) when the profile changes, because Go's TLS
config cannot be swapped live (main.go:344-367). Here the restart is an
``on_change`` callback.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.manager import Reconciler, Request, Result

# Mozilla "intermediate" profile — the reference's fallback cipher suite set
# (main.go:183-200 hardcodes this list when the APIServer CR can't be read).
INTERMEDIATE_CIPHERS = (
    "TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256",
    "TLS_ECDHE_RSA_WITH_AES_128_GCM_SHA256",
    "TLS_ECDHE_ECDSA_WITH_AES_256_GCM_SHA384",
    "TLS_ECDHE_RSA_WITH_AES_256_GCM_SHA384",
    "TLS_ECDHE_ECDSA_WITH_CHACHA20_POLY1305_SHA256",
    "TLS_ECDHE_RSA_WITH_CHACHA20_POLY1305_SHA256",
)
MODERN_CIPHERS = (
    "TLS_AES_128_GCM_SHA256",
    "TLS_AES_256_GCM_SHA384",
    "TLS_CHACHA20_POLY1305_SHA256",
)
OLD_CIPHERS = INTERMEDIATE_CIPHERS + (
    "TLS_ECDHE_ECDSA_WITH_AES_128_CBC_SHA256",
    "TLS_ECDHE_RSA_WITH_AES_128_CBC_SHA256",
    "TLS_RSA_WITH_AES_128_GCM_SHA256",
    "TLS_RSA_WITH_AES_256_GCM_SHA384",
)


@dataclass(frozen=True)
class TLSProfile:
    profile_type: str  # Old | Intermediate | Modern | Custom
    min_version: str
    ciphers: tuple[str, ...]


INTERMEDIATE = TLSProfile("Intermediate", "VersionTLS12", INTERMEDIATE_CIPHERS)
MODERN = TLSProfile("Modern", "VersionTLS13", MODERN_CIPHERS)
OLD = TLSProfile("Old", "VersionTLS10", OLD_CIPHERS)

_BY_TYPE = {"Old": OLD, "Intermediate": INTERMEDIATE, "Modern": MODERN}


def fetch_tls_profile(client: Client) -> TLSProfile:
    """Read spec.tlsSecurityProfile off the cluster APIServer CR.

    Absent CR, absent profile, or any read error falls back to the hardened
    Intermediate profile — the reference logs and continues rather than
    crash-looping on a missing OpenShift API (main.go:201-210).
    """
    try:
        apiserver = client.get("APIServer", "cluster")
    except Exception:
        return INTERMEDIATE
    profile = apiserver.get("spec", {}).get("tlsSecurityProfile") or {}
    ptype = profile.get("type", "")
    if ptype == "Custom":
        custom = profile.get("custom") or {}
        ciphers = tuple(custom.get("ciphers") or INTERMEDIATE_CIPHERS)
        min_version = custom.get("minTLSVersion", "VersionTLS12")
        return TLSProfile("Custom", min_version, ciphers)
    return _BY_TYPE.get(ptype, INTERMEDIATE)


class SecurityProfileWatcher(Reconciler):
    """Restart-on-TLS-change semantics (reference main.go:344-367).

    Registered against the APIServer kind; when the effective profile
    differs from the one the manager booted with, invokes ``on_change``
    exactly once (the reference cancels the root context, letting the
    kubelet restart the pod with the new profile).
    """

    def __init__(
        self,
        client: Client,
        boot_profile: TLSProfile,
        on_change: Callable[[TLSProfile], None],
    ):
        self.client = client
        self.boot_profile = boot_profile
        self.on_change = on_change
        self.fired = False

    def register(self, manager) -> None:
        manager.register(self, for_kind="APIServer", name="TLSProfileWatcher")

    def reconcile(self, req: Request) -> Result:
        if self.fired:
            return Result()
        current = fetch_tls_profile(self.client)
        if current != self.boot_profile:
            self.fired = True
            self.on_change(current)
        return Result()
