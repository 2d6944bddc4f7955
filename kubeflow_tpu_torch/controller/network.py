"""NetworkPolicies: notebook ingress lockdown + intra-slice data plane.

The port's own copy of ``kubeflow_tpu/controller/network.py``, a rebuild
of reference components/odh-notebook-controller/controllers/
notebook_network.go (:132-174 ``{name}-ctrl-np`` allowing 8888 only from
the controller namespace; :177-211 ``{name}-kube-rbac-proxy-np`` allowing
8443 from anywhere) plus the slice addition: an intra-slice policy so the
host pods of a multi-host slice reach each other over the
torch.distributed rendezvous and NCCL's bootstrap and socket transports.
Without it, a default-deny namespace would wedge
``torch.distributed.init_process_group`` while 8888 still works.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import NOTEBOOK_PORT, RBAC_PROXY_PORT
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller import reconcilehelper as helper
from kubeflow_tpu_torch.k8s.client import Client


def ctrl_np_name(name: str) -> str:
    return f"{name}-ctrl-np"


def proxy_np_name(name: str) -> str:
    return f"{name}-kube-rbac-proxy-np"


def slice_np_name(name: str) -> str:
    return f"{name}-slice-np"


def new_ctrl_policy(
    nb: Notebook, controller_namespace: str, gateway_namespace: str
) -> dict:
    """Allow 8888 from the controller namespace (culler probes) AND the
    gateway namespace — plain-mode HTTPRoutes terminate at the gateway pods,
    whose connections to 8888 must not be dropped by the lockdown."""
    peers = [
        {
            "namespaceSelector": {
                "matchLabels": {"kubernetes.io/metadata.name": controller_namespace}
            }
        }
    ]
    if gateway_namespace and gateway_namespace != controller_namespace:
        peers.append(
            {
                "namespaceSelector": {
                    "matchLabels": {"kubernetes.io/metadata.name": gateway_namespace}
                }
            }
        )
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {
            "name": ctrl_np_name(nb.name),
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
        },
        "spec": {
            "podSelector": {"matchLabels": {"statefulset": nb.name}},
            "policyTypes": ["Ingress"],
            "ingress": [
                {
                    "from": peers,
                    "ports": [
                        {"protocol": "TCP", "port": p}
                        for p in _allowed_ports(nb)
                    ],
                }
            ],
        },
    }


def _allowed_ports(nb: Notebook) -> list[int]:
    """8888 always; the profiling-port annotation opens the profiler
    server to the same peers (it connects through a port-forward or the
    gateway); the serving-port annotation opens the HTTP inference
    endpoint."""
    ports = [NOTEBOOK_PORT]
    for key in (ann.TPU_PROFILING_PORT, ann.TPU_SERVING_PORT):
        port = ann.parse_profiling_port(nb.annotations.get(key))
        if port is not None:
            ports.append(port)
    return ports


def new_proxy_policy(nb: Notebook) -> dict:
    """8443 open to all (the rbac proxy IS the auth boundary)."""
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {
            "name": proxy_np_name(nb.name),
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
        },
        "spec": {
            "podSelector": {"matchLabels": {"statefulset": nb.name}},
            "policyTypes": ["Ingress"],
            "ingress": [{"ports": [{"protocol": "TCP", "port": RBAC_PROXY_PORT}]}],
        },
    }


def new_slice_policy(nb: Notebook) -> dict:
    """Slice addition: slice pods talk to each other on every port. The
    torch.distributed rendezvous listens on 8476, but NCCL's bootstrap
    and socket transports and the per-host profiling servers use
    ephemeral ports, so the peer-selector is the gate, not the port
    list."""
    peer = {"podSelector": {"matchLabels": {"statefulset": nb.name}}}
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {
            "name": slice_np_name(nb.name),
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
        },
        "spec": {
            "podSelector": {"matchLabels": {"statefulset": nb.name}},
            "policyTypes": ["Ingress"],
            "ingress": [{"from": [peer]}],
        },
    }


def reconcile_network_policies(
    client: Client, nb: Notebook, controller_namespace: str,
    gateway_namespace: str = "",
) -> None:
    """Reference ReconcileAllNetworkPolicies (notebook_network.go:44)."""
    helper.reconcile_child(
        client, nb.obj,
        new_ctrl_policy(nb, controller_namespace, gateway_namespace),
    )
    helper.reconcile_child(client, nb.obj, new_proxy_policy(nb))
    multi_host = False
    if nb.gpu is not None:
        try:
            multi_host = nb.gpu.slice_topology().hosts > 1
        except Exception:
            multi_host = False
    if multi_host:
        helper.reconcile_child(client, nb.obj, new_slice_policy(nb))
