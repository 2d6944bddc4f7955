"""The port's managers over the wire, on the CPU: the production wiring of
``tests/test_serve_e2e.py``.

Both managers are assembled by the same ``build()`` their ``main()``
uses, over the port's ``RealClient``s talking to the port's
``EnvtestServer`` (one H100 node of the catalog), each driven by
``serve()`` on a ``RealClock``; admission reaches the port's
``WebhookServer`` over HTTPS (a self-signed cert from the ``openssl``
CLI) through ``add_remote_webhook``; a ``FakeKubelet`` runs over its own
``RealClient``. The namespace's ``default`` ServiceAccount carries an
``imagePullSecrets`` entry, as a token controller would mint it: the
platform reconciler releases the reconciliation lock only then (JAX's
stack creates none, so its own test of this waits out its 30 s).

- a ``spec.gpu`` Notebook is admitted with the lock and the GPU env,
  becomes one Running pod with ``nvidia.com/gpu`` "1" and
  ``status.gpu`` Healthy, the platform's route and policies appear, a
  topology edit is denied over HTTPS, and the deletion drains the pod
  and the platform's objects;
- ``python -m kubeflow_tpu_torch.cmd.notebook_manager`` and
  ``python -m kubeflow_tpu_torch.cmd.platform_manager`` as processes
  against the port's server: probes answer, the notebook manager
  reconciles, the platform manager's plain webhook listener answers an
  AdmissionReview, and SIGTERM ends each with 0.

Every wait is bounded by its own deadline.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from kubeflow_tpu_torch import k8s
from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.cmd import notebook_manager, platform_manager
from kubeflow_tpu_torch.gpu import topology
from kubeflow_tpu_torch.k8s.errors import WebhookDeniedError
from kubeflow_tpu_torch.k8s.serve import serve
from kubeflow_tpu_torch.webhook.server import (
    MUTATE_PATH,
    VALIDATE_PATH,
    WebhookServer,
)
from tests.test_torch_webhook_server import make_certs

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = topology.slice_from_spec("h100", "1")
STEP_TIMEOUT = 20.0


def gpu_notebook(name="wb", namespace="ns"):
    return {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
            "metadata": {"name": name, "namespace": namespace},
            "spec": {"template": {"spec": {"containers": [
                {"name": name, "image": "notebook:latest"}]}},
                "gpu": {"accelerator": "h100", "topology": "1"}}}


def _cluster():
    cluster = k8s.FakeCluster()
    k8s.add_gpu_node_pool(cluster, CARD.gke_accelerator_label,
                          CARD.topology_str, hosts=1,
                          cards_per_host=CARD.chips_per_host)
    cluster.create({"apiVersion": "v1", "kind": "ServiceAccount",
                    "metadata": {"name": "default", "namespace": "ns"},
                    "imagePullSecrets": [{"name": "default-dockercfg"}]})
    return cluster


class _Shim:
    """A bundle for ``serve()`` around the kubelet's manager."""

    def __init__(self, manager):
        self.manager = manager

    def tick(self, seconds: float) -> int:
        return self.manager.tick(seconds)


def _wait_for(fn, timeout=STEP_TIMEOUT, desc="condition"):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = fn()
            if last:
                return last
        except Exception as err:  # noqa: PERF203 - a poll loop
            last = err
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {desc} (last: {last!r})")


@pytest.fixture
def stack(tmp_path):
    cluster = _cluster()
    server = k8s.EnvtestServer(cluster).start()
    clients = []

    def new_client():
        clients.append(k8s.RealClient(server.client_config()))
        return clients[-1]

    ca_file = make_certs(str(tmp_path))
    platform = platform_manager.build(
        new_client(), env={"K8S_NAMESPACE": "opendatahub"},
        argv=["--kube-rbac-proxy-image", "proxy:v1"], clock=k8s.RealClock())
    webhook_server = WebhookServer(
        mutating_handler=platform.mutating_webhook.handle,
        validating_handler=platform.validating_webhook.handle,
        cert_dir=str(tmp_path), tls_profile=platform.tls_profile)
    webhook_server.start()
    base = f"https://127.0.0.1:{webhook_server.port}"
    server.add_remote_webhook("Notebook", mutate_url=base + MUTATE_PATH,
                              validate_url=base + VALIDATE_PATH,
                              ca_file=ca_file)
    core = notebook_manager.build(new_client(), env={},
                                  clock=k8s.RealClock())
    kubelet_client = new_client()
    kubelet_manager = k8s.Manager(kubelet_client, clock=k8s.RealClock())
    k8s.FakeKubelet(kubelet_client).register(kubelet_manager)
    stop = threading.Event()
    threads = [threading.Thread(target=serve, args=(b, c, stop),
                                kwargs={"max_idle_wait": 0.2}, daemon=True)
               for b, c in ((platform, clients[0]), (core, clients[1]),
                            (_Shim(kubelet_manager), kubelet_client))]
    for t in threads:
        t.start()
    s = type("Stack", (), {})()
    s.server, s.cluster, s.core, s.platform = server, cluster, core, platform
    s.webhook_server, s.user = webhook_server, new_client()
    yield s
    stop.set()
    for t in threads:
        t.join(timeout=5)
    webhook_server.stop()
    for c in clients:
        c.stop()
    server.stop()
    assert not any(t.is_alive() for t in threads)


def test_gpu_notebook_becomes_a_running_pod_over_the_wire(stack):
    t0 = time.monotonic()
    created = stack.user.create(gpu_notebook())
    assert created["metadata"]["annotations"][ann.STOP] == (
        ann.RECONCILIATION_LOCK_VALUE)
    env = {e["name"]: e.get("value")
           for e in created["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["TPU_ACCELERATOR_TYPE"] == "h100-80gb-1"
    assert env["TPU_CHIPS_PER_HOST_BOUNDS"] == "1,1,1"

    def healthy():
        obj = stack.user.get("Notebook", "wb", "ns")
        return obj if obj.get("status", {}).get("gpu", {}).get(
            "sliceHealth") == "Healthy" else None

    obj = _wait_for(healthy, desc="status.gpu Healthy")
    assert obj["status"]["gpu"]["readyHosts"] == 1
    assert ann.STOP not in obj["metadata"].get("annotations", {})
    assert time.monotonic() - t0 < STEP_TIMEOUT
    (pod,) = stack.user.list("Pod", "ns", {"notebook-name": "wb"})
    (container,) = pod["spec"]["containers"]
    assert container["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert pod["status"]["phase"] == "Running"
    _wait_for(lambda: stack.user.exists("HTTPRoute", "nb-ns-wb",
                                        "opendatahub"), desc="HTTPRoute")
    _wait_for(lambda: stack.user.exists("NetworkPolicy", "wb-ctrl-np", "ns"),
              desc="NetworkPolicy")

    fresh = stack.user.get("Notebook", "wb", "ns")
    fresh["spec"]["gpu"]["topology"] = "2"
    with pytest.raises(WebhookDeniedError, match="spec.gpu cannot change"):
        stack.user.update(fresh)

    stack.user.delete("Notebook", "wb", "ns")
    _wait_for(lambda: not stack.user.exists("Notebook", "wb", "ns"),
              desc="the Notebook's deletion")
    _wait_for(lambda: stack.user.list("Pod", "ns") == [], desc="pods gone")
    _wait_for(lambda: not stack.user.list("HTTPRoute")
              and not stack.user.list("NetworkPolicy", "ns"),
              desc="the platform's objects gone")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kubeconfig(tmp_path, port) -> str:
    path = tmp_path / "kubeconfig"
    path.write_text(f"""
apiVersion: v1
kind: Config
current-context: envtest
contexts:
- name: envtest
  context: {{cluster: envtest, user: dev}}
clusters:
- name: envtest
  cluster: {{server: "http://127.0.0.1:{port}"}}
users:
- name: dev
  user: {{}}
""")
    return str(path)


def _get(url, timeout=2):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


@pytest.mark.parametrize("manager", ["notebook_manager", "platform_manager"])
def test_manager_entrypoint_subprocess(tmp_path, manager):
    """``python -m kubeflow_tpu_torch.cmd.<manager>``, the container's
    entrypoint, serves its probes, does its work and exits 0 on
    SIGTERM."""
    server = k8s.EnvtestServer(_cluster()).start()
    probe, metrics, hook = _free_port(), _free_port(), _free_port()
    argv = ["--probe-addr", f"127.0.0.1:{probe}",
            "--metrics-addr", f"127.0.0.1:{metrics}"]
    if manager == "platform_manager":
        argv += ["--kube-rbac-proxy-image", "proxy:v1",
                 "--webhook-port", str(hook)]
    env = {**os.environ, "KUBECONFIG": _kubeconfig(tmp_path, server.port),
           "KUBERNETES_SERVICE_HOST": "", "PYTHONPATH": REPO_ROOT,
           "K8S_NAMESPACE": "opendatahub"}
    proc = subprocess.Popen(
        [sys.executable, "-m", f"kubeflow_tpu_torch.cmd.{manager}", *argv],
        env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        _wait_for(lambda: _get(f"http://127.0.0.1:{probe}/healthz",
                               1)[0] == 200, timeout=30, desc="healthz")
        # readyz carries the serve loop's watchdog, which is unready until
        # the first drain cycle; main() starts that loop only after the
        # webhook and metrics listeners, so ready means all three serve.
        code, body = _wait_for(
            lambda: _get(f"http://127.0.0.1:{probe}/readyz", 1),
            timeout=30, desc="readyz")
        assert code == 200 and json.loads(body)["readyz"] == "ok"
        user = k8s.RealClient(server.client_config())
        if manager == "notebook_manager":
            user.create(gpu_notebook("subp"))
            _wait_for(lambda: user.exists("StatefulSet", "subp", "ns"),
                      desc="the subprocess's reconcile")
            assert b"notebook_create_total" in _get(
                f"http://127.0.0.1:{metrics}/metrics")[1]
        else:
            review = {"apiVersion": "admission.k8s.io/v1",
                      "kind": "AdmissionReview",
                      "request": {"uid": "u", "operation": "CREATE",
                                  "object": gpu_notebook()}}
            req = urllib.request.Request(
                f"http://127.0.0.1:{hook}{MUTATE_PATH}",
                data=json.dumps(review).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5) as resp:
                out = json.loads(resp.read())["response"]
            assert out["allowed"] and out["patchType"] == "JSONPatch"
            assert _get(f"http://127.0.0.1:{metrics}/metrics")[0] == 200
        user.stop()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out = proc.stdout.read().decode(errors="replace")
        server.stop()
        if proc.returncode not in (0, -signal.SIGKILL):
            raise AssertionError(f"{manager} exited {proc.returncode}:\n{out}")
