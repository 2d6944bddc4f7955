"""The port's admission webhooks against the JAX package's, on the CPU.

Each scenario of ``tests/test_webhook.py`` runs on a JAX cluster and on
the port's (``tests/torch_controller_env.py`` with ``webhooks=True``:
each side's own ``NotebookMutatingWebhook`` and
``NotebookValidatingWebhook`` as its admission, ``v5e`` 4x4 against
``h100`` 32, four hosts each). After the scenario every object, every
Event and the two metrics expositions are equal after
``tests/torch_gpu_swap.swap_cluster``; a scenario on another shape
compares its Notebook after ``swap`` with that shape's two slices. A
denial must be a ``WebhookDeniedError`` on both sides with the same text
after ``swap_text`` (``spec.tpu`` → ``spec.gpu``, the spec's repr, and the
catalog's refusal of the spec, which ``tests/test_torch_gpu_outputs.py``
holds to JAX's wording). The JAX test's own assertions hold on both
sides. Beside them: ``diff.first_difference`` and the mounts, called
directly on both packages.
"""

from __future__ import annotations

import copy

import pytest

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.api import names as JN
from kubeflow_tpu.api.notebook import Notebook as JNotebook
from kubeflow_tpu.api.notebook import TPUSpec
from kubeflow_tpu.k8s import objects as JO
from kubeflow_tpu.tpu import topology as JT
from kubeflow_tpu.webhook import diff as JD
from kubeflow_tpu.webhook import mounts as JMo
from kubeflow_tpu_torch.api import annotations as PA
from kubeflow_tpu_torch.api import names as PN
from kubeflow_tpu_torch.api.notebook import GPUSpec
from kubeflow_tpu_torch.api.notebook import Notebook as PNotebook
from kubeflow_tpu_torch.gpu import topology as PT
from kubeflow_tpu_torch.k8s import errors as PE
from kubeflow_tpu_torch.k8s import fake as PF
from kubeflow_tpu_torch.webhook import diff as PD
from kubeflow_tpu_torch.webhook import gpu_env as PG
from kubeflow_tpu_torch.webhook import mounts as PMo
from tests.test_torch_controller_loop import (  # noqa: F401 (autouse)
    _fixed_condition_clock,
)
from tests.torch_controller_env import JSHAPE, PSHAPE, compare, make_side
from tests.torch_controller_env import notebook as _notebook
from tests.torch_gpu_swap import swap, swap_text

# (JAX, port) shapes of equal host counts.
ONE_HOST = (("v5e", "2x2"), ("h100", "8"))
EIGHT_HOSTS = (("v5e", "4x8"), ("h100", "64"))
BAD = (("v5e", "3x4"), ("h100", "12"))
JA_ELYRA, JA_RUNTIME = JN.ELYRA_SECRET_NAME, JN.RUNTIME_IMAGES_CONFIGMAP
assert (PN.ELYRA_SECRET_NAME, PN.RUNTIME_IMAGES_CONFIGMAP, PA.STOP) == (
    JA_ELYRA, JA_RUNTIME, JA.STOP)
CA_CM = {"apiVersion": "v1", "kind": "ConfigMap",
         "metadata": {"name": "workbench-trusted-ca-bundle",
                      "namespace": "ns"},
         "data": {"ca-bundle.crt": "PEMPEM"}}


def tpu_nb(m, shape=(JSHAPE, PSHAPE), **kw):
    return _notebook(m, image="jax-notebook:latest", shape=shape, **kw)


def cpu_nb(m, **kw):
    return _notebook(m, device=False, image="jupyter-minimal:latest", **kw)


def pair(**kw):
    """A JAX side and a port side with their webhooks."""
    return (make_side(True, webhooks=True, **kw),
            make_side(False, webhooks=True, **kw))


def both(fn, j, p):
    """``fn(side)`` on each side; returns the two results."""
    return fn(j), fn(p)


def env_var(container, name):
    for e in container.get("env", []):
        if e.get("name") == name:
            return e
    return None


def primary(m, name="nb"):
    view = JNotebook if m.jax else PNotebook
    nb = view(m.c.get("Notebook", name, "ns"))
    return nb, nb.primary_container()


def release(m, name="nb"):
    nb = m.c.get("Notebook", name, "ns")
    JO.remove_annotation(nb, JA.STOP)
    m.c.update(nb)


def denial(m, fn):
    """The text of the WebhookDeniedError ``fn()`` raises on side ``m``."""
    err = m.E.WebhookDeniedError
    with pytest.raises(err) as info:
        fn()
    return str(info.value)


def same_denial(j, p, fn, match=None, shape=(JSHAPE, PSHAPE),
                messages=None):
    """Both sides deny ``fn(side)`` alike; ``messages`` maps a JAX text
    inside the denial to the port's."""
    jt, pt = both(lambda m: denial(m, lambda: fn(m)), j, p)
    want = swap_text(jt, _spec(shape[0], True), _spec(shape[1], False))
    for old, new in (messages or {}).items():
        want = want.replace(old, new)
    assert pt == want
    if match:
        assert match in jt and match in pt
    return pt


def _spec(shape, jax):
    return TPUSpec(*shape) if jax else GPUSpec(*shape)


def same_notebook(j, p, shape=(JSHAPE, PSHAPE), name="nb"):
    jnb, pnb = (m.c.get("Notebook", name, "ns") for m in (j, p))
    jtopo = JT.slice_from_spec(*shape[0])
    ptopo = PT.slice_from_spec(*shape[1])
    want = swap(jnb, jtopo, ptopo)
    want["spec"].pop("tpu", None)
    got = copy.deepcopy(pnb)
    got["spec"].pop("gpu", None)
    assert got == want


# -- reconciliation lock ---------------------------------------------------------


def test_create_injects_lock():
    j, p = pair()
    both(lambda m: m.c.create(cpu_nb(m)), j, p)
    for m in (j, p):
        nb = m.c.get("Notebook", "nb", "ns")
        assert nb["metadata"]["annotations"][JA.STOP] == (
            JA.RECONCILIATION_LOCK_VALUE)
    compare(j, p)


def test_lock_keeps_slice_down_until_released():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m))
        m.mgr.run_until_idle()
        assert m.c.get("StatefulSet", "nb", "ns")["spec"]["replicas"] == 0
    compare(j, p)
    for m in (j, p):
        release(m)
        m.mgr.run_until_idle()
        assert m.c.get("StatefulSet", "nb", "ns")["spec"]["replicas"] == 4
    compare(j, p)


def test_user_stop_annotation_not_overwritten():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={JA.STOP: "2026-01-01T00:00:00Z"}))
        assert m.c.get("Notebook", "nb", "ns")["metadata"]["annotations"][
            JA.STOP] == "2026-01-01T00:00:00Z"
    compare(j, p)


# -- the device env --------------------------------------------------------------


def test_multi_host_env_block():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m))
        _, c = primary(m)
        assert env_var(c, "TPU_WORKER_ID")["valueFrom"]["fieldRef"][
            "fieldPath"] == "metadata.labels['apps.kubernetes.io/pod-index']"
        hostnames = env_var(c, "TPU_WORKER_HOSTNAMES")["value"].split(",")
        assert len(hostnames) == 4
        assert hostnames[0] == "nb-0.nb-hosts.ns.svc.cluster.local"
        assert env_var(c, "JAX_COORDINATOR_ADDRESS")["value"] == (
            "nb-0.nb-hosts.ns.svc.cluster.local:8476")
        assert env_var(c, "JAX_NUM_PROCESSES")["value"] == "4"
    for m, want in ((j, ("v5litepod-16", "4x4", "2,2,1")),
                    (p, ("h100-80gb-32", "32", "8,1,1"))):
        _, c = primary(m)
        assert (env_var(c, "TPU_ACCELERATOR_TYPE")["value"],
                env_var(c, "TPU_TOPOLOGY")["value"],
                env_var(c, "TPU_CHIPS_PER_HOST_BOUNDS")["value"]) == want
        assert m.c.get("Notebook", "nb", "ns")["metadata"]["annotations"][
            JA.TPU_RESOLVED_TOPOLOGY] == f"{want[0]}/{want[1]}"
    compare(j, p)


def test_single_host_no_coordinator():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, shape=ONE_HOST))
        _, c = primary(m)
        assert env_var(c, "JAX_COORDINATOR_ADDRESS") is None
        assert env_var(c, "TPU_WORKER_HOSTNAMES")["value"].count(",") == 0
    same_notebook(j, p, ONE_HOST)


def test_cpu_notebook_untouched():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m))
        assert env_var(primary(m)[1], "TPU_WORKER_ID") is None
    compare(j, p)


# -- the annotation projections --------------------------------------------------


@pytest.mark.parametrize("value,want", [("int8", "int8"), ("fp8", "fp8"),
                                        ("int4", "int4"), ("bf16", None)])
def test_quantization_annotation_projects_env(value, want):
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={JA.TPU_QUANTIZATION: value}))
        got = env_var(primary(m)[1], JA.QUANT_ENV_NAME)
        assert (got and got["value"]) == want or (got is None and not want)
    compare(j, p)


def test_quantization_removal_drops_env():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={JA.TPU_QUANTIZATION: "int4"}))
        nb = m.c.get("Notebook", "nb", "ns")
        del nb["metadata"]["annotations"][JA.TPU_QUANTIZATION]
        m.c.update(nb)
        assert env_var(primary(m)[1], JA.QUANT_ENV_NAME) is None
    compare(j, p)


def test_quantization_unknown_value_denied():
    j, p = pair()
    same_denial(j, p, lambda m: m.c.create(
        tpu_nb(m, annotations={JA.TPU_QUANTIZATION: "fp4"})),
        match="unknown value")
    compare(j, p)


def test_profiling_annotation_projects_env_and_status_address():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={JA.TPU_PROFILING_PORT: "9012"}))
        m.mgr.run_until_idle()
        assert env_var(primary(m)[1], JA.PROFILING_ENV_NAME)["value"] == (
            "9012")
        assert m.c.get("Notebook", "nb", "ns")["status"][m.key][
            "profilingServer"] == "nb-0.nb-hosts.ns.svc.cluster.local:9012"
    compare(j, p)


@pytest.mark.parametrize("annotation,port", [
    (JA.TPU_PROFILING_PORT, 9012), (JA.TPU_SERVING_PORT, 8200)])
def test_port_annotation_opens_the_network_policy(annotation, port):
    j, p = pair(platform=True)
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={annotation: str(port)}))
        m.mgr.run_until_idle()
        np_obj = m.c.get("NetworkPolicy", "nb-ctrl-np", "ns")
        ports = [q["port"] for rule in np_obj["spec"]["ingress"]
                 for q in rule["ports"]]
        assert 8888 in ports and port in ports
    compare(j, p)


def test_serving_port_projects_env_and_status():
    j, p = pair(platform=True)
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={JA.TPU_SERVING_PORT: "8200"}))
        m.mgr.run_until_idle()
        assert env_var(primary(m)[1], JA.SERVING_ENV_NAME)["value"] == "8200"
        assert m.c.get("Notebook", "nb", "ns")["status"][m.key][
            "servingEndpoint"] == "nb-0.nb-hosts.ns.svc.cluster.local:8200"
    compare(j, p)


@pytest.mark.parametrize("annotations,match", [
    ({JA.TPU_PROFILING_PORT: "80"}, "not a port"),
    ({JA.TPU_PROFILING_PORT: "notaport"}, "not a port"),
    ({JA.TPU_PROFILING_PORT: "70000"}, "not a port"),
    ({JA.TPU_PROFILING_PORT: "8888"}, "already used in-pod"),
    ({JA.TPU_PROFILING_PORT: "8443"}, "already used in-pod"),
    ({JA.TPU_PROFILING_PORT: "8476"}, "already used in-pod"),
    ({JA.TPU_PROFILING_PORT: "8081"}, "already used in-pod"),
    ({JA.TPU_SERVING_PORT: "80"}, "not a port"),
    ({JA.TPU_SERVING_PORT: "8888"}, "already used in-pod"),
    ({JA.TPU_SERVING_PORT: "9100", JA.TPU_PROFILING_PORT: "9100"},
     "same port"),
])
def test_port_annotation_denied(annotations, match):
    j, p = pair()
    same_denial(j, p, lambda m: m.c.create(
        tpu_nb(m, annotations=annotations)), match=match)
    for m in (j, p):
        assert not m.c.exists("Notebook", "nb", "ns")


def test_serving_port_removal_drops_env():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={JA.TPU_SERVING_PORT: "8200"}))
        nb = m.c.get("Notebook", "nb", "ns")
        del nb["metadata"]["annotations"][JA.TPU_SERVING_PORT]
        m.c.update(nb)
        assert env_var(primary(m)[1], JA.SERVING_ENV_NAME) is None
    compare(j, p)


# -- image resolution ------------------------------------------------------------


def _imagestream(m):
    m.c.create({
        "apiVersion": "image.openshift.io/v1", "kind": "ImageStream",
        "metadata": {"name": "jupyter-ds", "namespace": "opendatahub"},
        "spec": {"tags": [{"name": "2026.1", "from": {"name": "spec-img"}}]},
        "status": {"tags": [{"tag": "2026.1", "items": [
            {"dockerImageReference": "registry/ds@sha256:abc"}]}]}})


@pytest.mark.parametrize("selection,image", [
    ("jupyter-ds:2026.1", "registry/ds@sha256:abc"),
    ("nope:1", "jupyter-minimal:latest")])
def test_image_resolution(selection, image):
    j, p = pair()
    for m in (j, p):
        _imagestream(m)
        m.c.create(cpu_nb(m, annotations={JA.LAST_IMAGE_SELECTION:
                                          selection}))
        assert primary(m)[1]["image"] == image
    compare(j, p)


# -- the auth sidecar ------------------------------------------------------------


def test_sidecar_injected_with_defaults():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={JA.INJECT_AUTH: "true"}))
        nb, _ = primary(m)
        sidecar = next(c for c in nb.containers
                       if c["name"] == "kube-rbac-proxy")
        assert sidecar["resources"]["requests"]["cpu"] == "100m"
        assert nb.pod_spec["serviceAccountName"] == "nb-auth-proxy"
        assert {"kube-rbac-proxy-config", "kube-rbac-proxy-tls"} <= {
            v["name"] for v in nb.pod_spec["volumes"]}
    compare(j, p)


def test_sidecar_resource_annotations_override():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={
            JA.INJECT_AUTH: "true", JA.AUTH_SIDECAR_CPU_REQUEST: "250m",
            JA.AUTH_SIDECAR_MEMORY_LIMIT: "128Mi"}))
        nb, _ = primary(m)
        sidecar = next(c for c in nb.containers
                       if c["name"] == "kube-rbac-proxy")
        assert sidecar["resources"]["requests"]["cpu"] == "250m"
        assert sidecar["resources"]["limits"]["memory"] == "128Mi"
    compare(j, p)


def test_invalid_sidecar_resource_denied():
    j, p = pair()
    same_denial(j, p, lambda m: m.c.create(cpu_nb(m, annotations={
        JA.INJECT_AUTH: "true", JA.AUTH_SIDECAR_CPU_REQUEST: "lots-please"})))
    compare(j, p)


def test_sidecar_removed_when_auth_disabled():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={JA.INJECT_AUTH: "true"}))
        nb = m.c.get("Notebook", "nb", "ns")
        del nb["metadata"]["annotations"][JA.INJECT_AUTH]
        m.c.update(nb)
        nb, _ = primary(m)
        assert all(c["name"] != "kube-rbac-proxy" for c in nb.containers)
    compare(j, p)


# -- update blocking -------------------------------------------------------------


def _running(m):
    m.c.create(tpu_nb(m))
    release(m)
    m.mgr.run_until_idle()
    return m.c.get("Notebook", "nb", "ns")


def test_webhook_drift_reverted_on_running_notebook():
    j, p = pair()
    pending = []
    for m in (j, p):
        nb = _running(m)
        image_before = (JNotebook if m.jax else PNotebook)(
            nb).primary_container()["image"]
        m.c.create(copy.deepcopy(CA_CM))
        nb = m.c.get("Notebook", "nb", "ns")
        JO.set_annotation(nb, "touch", "1")
        m.c.update(nb)
        fresh, c = primary(m)
        assert env_var(c, "SSL_CERT_FILE") is None
        assert c["image"] == image_before
        pending.append(fresh.annotations[JA.UPDATE_PENDING])
    assert pending[0] == pending[1]
    assert "trusted-ca" in pending[1] or "env" in pending[1]
    compare(j, p)


def test_user_template_change_allowed_while_running():
    j, p = pair()
    for m in (j, p):
        nb = _running(m)
        nb["spec"]["template"]["spec"]["containers"][0]["image"] = (
            "jax-notebook:v2")
        m.c.update(nb)
        fresh, c = primary(m)
        assert c["image"] == "jax-notebook:v2"
        assert JA.UPDATE_PENDING not in fresh.annotations
    compare(j, p)


def test_mutations_land_on_stopped_notebook():
    j, p = pair()
    for m in (j, p):
        m.c.create(copy.deepcopy(CA_CM))
        m.c.create(tpu_nb(m))  # created with the lock: stopped
        nb = m.c.get("Notebook", "nb", "ns")
        JO.set_annotation(nb, "touch", "1")
        m.c.update(nb)
        fresh, c = primary(m)
        assert env_var(c, "SSL_CERT_FILE") is not None
        assert JA.UPDATE_PENDING not in fresh.annotations
    compare(j, p)


# -- the validating webhook ------------------------------------------------------


def test_invalid_topology_denied_at_create():
    j, p = pair()
    refusals = []
    for topology in (JT, PT):
        with pytest.raises(topology.InvalidTopologyError) as err:
            topology.slice_from_spec(*BAD[topology is PT])
        refusals.append(str(err.value))
    text = same_denial(j, p, lambda m: m.c.create(tpu_nb(m, shape=BAD)),
                       match="invalid spec.", messages=dict([refusals]))
    assert text == f"invalid spec.gpu: {refusals[1]}"
    for m in (j, p):
        assert not m.c.exists("Notebook", "nb", "ns")


@pytest.mark.parametrize("gpu,match", [
    ({"accelerator": "h100", "topology": "1", "runtimeVersion": "v2"},
     "runtimeVersion"),
    ({"accelerator": "a100", "topology": "1"}, "unknown GPU accelerator")])
def test_a_gpu_spec_that_does_not_resolve_is_denied(gpu, match):
    """What ``Notebook.gpu`` itself refuses is denied too, where
    ``mutate_gpu_notebook`` raises: the mutating webhook skips it."""
    p = make_side(False, webhooks=True)
    obj = cpu_nb(p)
    obj["spec"]["gpu"] = gpu
    with pytest.raises(PE.WebhookDeniedError, match="invalid spec.gpu: .*"
                       + match):
        p.c.create(obj)
    nb = PNotebook(copy.deepcopy(obj))
    hook = p.webhook.handle(PF.AdmissionRequest("CREATE", nb.obj))
    assert hook["metadata"]["annotations"][JA.STOP]
    assert env_var(PNotebook(hook).primary_container(), "TPU_WORKER_ID") is None
    with pytest.raises(ValueError, match=match):
        PG.mutate_gpu_notebook(copy.deepcopy(obj))


def test_topology_change_denied_while_running():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m))
        release(m)
    compare(j, p)

    def edit(m):
        nb = m.c.get("Notebook", "nb", "ns")
        nb["spec"][m.key]["topology"] = EIGHT_HOSTS[0 if m.jax else 1][1]
        m.c.update(nb)

    jt, pt = both(lambda m: denial(m, lambda: edit(m)), j, p)
    want = swap_text(jt, TPUSpec(*JSHAPE), GPUSpec(*PSHAPE)).replace(
        repr(TPUSpec(*EIGHT_HOSTS[0])), repr(GPUSpec(*EIGHT_HOSTS[1])))
    assert pt == want and "cannot change" in pt
    assert pt.startswith("spec.gpu cannot change while the notebook is "
                         "running: changing GPUSpec(accelerator='h100', "
                         "topology='32'")
    compare(j, p)


def test_topology_change_allowed_when_stopped():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m))  # the lock: stopped
        nb = m.c.get("Notebook", "nb", "ns")
        nb["spec"][m.key]["topology"] = EIGHT_HOSTS[0 if m.jax else 1][1]
        m.c.update(nb)
    same_notebook(j, p, EIGHT_HOSTS)


def test_mlflow_annotation_removal_denied_while_running():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={JA.MLFLOW_INSTANCE: "tracking"}))
        release(m)

    def remove(m):
        nb = m.c.get("Notebook", "nb", "ns")
        del nb["metadata"]["annotations"][JA.MLFLOW_INSTANCE]
        m.c.update(nb)

    same_denial(j, p, remove, match="cannot be removed")
    compare(j, p)


# -- MLflow, the cluster proxy, Feast --------------------------------------------


def test_mlflow_env_injected():
    j, p = pair(webhook_config={"mlflow_enabled": True,
                                "gateway_url": "https://gw.example"})
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={JA.MLFLOW_INSTANCE:
                                          "team-tracking"}))
        c = primary(m)[1]
        assert env_var(c, "MLFLOW_TRACKING_URI")["value"] == (
            "https://gw.example/mlflow/team-tracking")
        assert env_var(c, "MLFLOW_K8S_INTEGRATION")["value"] == "true"
    compare(j, p)


def test_mlflow_uri_from_the_gateway_and_removal():
    """No GATEWAY_URL: the tracking URI comes from the Gateway's listener
    hostname; removing the annotation from a stopped notebook removes
    the env."""
    j, p = pair(webhook_config={"mlflow_enabled": True})
    for m in (j, p):
        m.c.create({"apiVersion": "gateway.networking.k8s.io/v1",
                    "kind": "Gateway",
                    "metadata": {"name": "data-science-gateway",
                                 "namespace": "openshift-ingress"},
                    "spec": {"listeners": [{"hostname": "gw.host"}]}})
        m.c.create(cpu_nb(m, annotations={JA.MLFLOW_INSTANCE: "t"}))
        assert env_var(primary(m)[1], "MLFLOW_TRACKING_URI")["value"] == (
            "https://gw.host/mlflow/t")
        nb = m.c.get("Notebook", "nb", "ns")
        del nb["metadata"]["annotations"][JA.MLFLOW_INSTANCE]
        m.c.update(nb)
        assert env_var(primary(m)[1], "MLFLOW_TRACKING_URI") is None
    compare(j, p)


def test_cluster_proxy_env():
    j, p = pair(webhook_config={"inject_cluster_proxy_env": True})
    for m in (j, p):
        m.c.create({"apiVersion": "config.openshift.io/v1", "kind": "Proxy",
                    "metadata": {"name": "cluster"},
                    "spec": {"httpProxy": "http://proxy:3128",
                             "noProxy": ".cluster.local"}})
        m.c.create(cpu_nb(m))
        c = primary(m)[1]
        assert env_var(c, "HTTP_PROXY")["value"] == "http://proxy:3128"
        assert env_var(c, "NO_PROXY")["value"] == ".cluster.local"
    compare(j, p)


def test_feast_label_gated_mount_and_unmount():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, labels={JA.FEAST_INTEGRATION_LABEL: "true"}))
        nb, c = primary(m)
        assert any(v["name"] == "feast-config" for v in nb.pod_spec["volumes"])
        assert any(x["name"] == "feast-config" for x in c["volumeMounts"])
    compare(j, p)
    for m in (j, p):
        fresh = m.c.get("Notebook", "nb", "ns")
        fresh["metadata"]["labels"][JA.FEAST_INTEGRATION_LABEL] = "false"
        m.c.update(fresh)
        nb, _ = primary(m)
        assert all(v["name"] != "feast-config"
                   for v in nb.pod_spec.get("volumes", []))
    compare(j, p)


def test_elyra_secret_and_runtime_images_mounted():
    """With ``set_pipeline_secret`` the Elyra secret mounts once it
    exists; the runtime-images ConfigMap mounts without a switch."""
    j, p = pair(webhook_config={"set_pipeline_secret": True})
    for m in (j, p):
        m.c.create({"apiVersion": "v1", "kind": "Secret",
                    "metadata": {"name": JA_ELYRA, "namespace": "ns"}})
        m.c.create({"apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"name": JA_RUNTIME, "namespace": "ns"}})
        m.c.create(cpu_nb(m))
        nb, _ = primary(m)
        assert {"elyra-dsp-config", "runtime-images"} <= {
            v["name"] for v in nb.pod_spec["volumes"]}
    compare(j, p)


# -- review regressions ----------------------------------------------------------


def test_shrinking_topology_drops_multihost_env():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m))  # the lock: stopped
        nb = m.c.get("Notebook", "nb", "ns")
        nb["spec"][m.key]["topology"] = ONE_HOST[0 if m.jax else 1][1]
        m.c.update(nb)
        c = primary(m)[1]
        assert env_var(c, "JAX_COORDINATOR_ADDRESS") is None
        assert env_var(c, "JAX_NUM_PROCESSES") is None
    assert env_var(primary(p)[1], "TPU_TOPOLOGY")["value"] == "8"
    same_notebook(j, p, ONE_HOST)


def test_auth_flip_on_running_notebook_rolls_out():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={JA.INJECT_AUTH: "true"}))
        release(m)
        m.mgr.run_until_idle()
        nb = m.c.get("Notebook", "nb", "ns")
        del nb["metadata"]["annotations"][JA.INJECT_AUTH]
        m.c.update(nb)
        fresh, _ = primary(m)
        assert all(c["name"] != "kube-rbac-proxy" for c in fresh.containers)
        assert JA.UPDATE_PENDING not in fresh.annotations
        assert "serviceAccountName" not in fresh.pod_spec
    compare(j, p)


# -- the checkpoint projections --------------------------------------------------


def test_grace_annotation_projects_env_and_sizes_termination():
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={JA.TPU_CHECKPOINT_GRACE: "60"}))
        m.mgr.run_until_idle()
        nb, c = primary(m)
        assert env_var(c, JA.CHECKPOINT_GRACE_ENV_NAME)["value"] == "60"
        assert nb.pod_spec["terminationGracePeriodSeconds"] == (
            60 + PG.CHECKPOINT_FLUSH_MARGIN_S)
    compare(j, p)


@pytest.mark.parametrize("annotations,want_dir", [
    ({}, JA.DEFAULT_CHECKPOINT_DIR),
    ({JA.TPU_CHECKPOINT_DIR: "/data/ckpt "}, "/data/ckpt")])
def test_checkpoint_dir_default_and_override(annotations, want_dir):
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations=annotations))
        m.mgr.run_until_idle()
        nb, c = primary(m)
        assert env_var(c, JA.CHECKPOINT_DIR_ENV_NAME)["value"] == want_dir
        assert env_var(c, JA.CHECKPOINT_GRACE_ENV_NAME) is None
        assert "terminationGracePeriodSeconds" not in nb.pod_spec
    compare(j, p)


@pytest.mark.parametrize("bad", ["0", "-5", "3601", "soon", ""])
def test_invalid_grace_treated_as_absent(bad):
    j, p = pair()
    for m in (j, p):
        m.c.create(tpu_nb(m, annotations={JA.TPU_CHECKPOINT_GRACE: bad}))
        m.mgr.run_until_idle()
        nb, c = primary(m)
        assert env_var(c, JA.CHECKPOINT_GRACE_ENV_NAME) is None
        assert "terminationGracePeriodSeconds" not in nb.pod_spec
    compare(j, p)


def test_cpu_notebook_gets_no_checkpoint_env():
    j, p = pair()
    for m in (j, p):
        m.c.create(cpu_nb(m, annotations={JA.TPU_CHECKPOINT_GRACE: "60"}))
        c = primary(m)[1]
        assert env_var(c, JA.CHECKPOINT_DIR_ENV_NAME) is None
        assert env_var(c, JA.CHECKPOINT_GRACE_ENV_NAME) is None
    compare(j, p)


# -- the tracer spans ------------------------------------------------------------


def test_the_two_spans_match_jaxs():
    from kubeflow_tpu.observability import tracing as JTr
    from kubeflow_tpu_torch.observability import tracing as PTr

    out = []
    for jax, tr in ((True, JTr), (False, PTr)):
        exporter = tr.InMemoryExporter()
        tr.set_tracer_provider(tr.TracerProvider(exporter))
        try:
            m = make_side(jax, webhooks=True)
            m.c.create(tpu_nb(m))
            nb = m.c.get("Notebook", "nb", "ns")
            JO.set_annotation(nb, "touch", "1")
            m.c.update(nb)
        finally:
            tr.set_tracer_provider(tr.TracerProvider())
        out.append([(s.name, s.attributes) for s in exporter.spans])
    assert out[0] == out[1]
    assert [name for name, _ in out[1]] == [
        "mutate-notebook", "maybe-restart-running-notebook",
        "mutate-notebook"]


# -- diff and the mounts, called directly ----------------------------------------


@pytest.mark.parametrize("a,b", [
    ({"x": 1}, {"x": 1}),
    ({"x": 1}, {"x": 2}),
    ({"x": 1}, {"y": 1}),
    ({"x": [1, 2]}, {"x": [1, 2, 3]}),
    ({"x": [{"a": 1}]}, {"x": [{"a": "1"}]}),
    ({"x": {"deep": ["v" * 100]}}, {"x": {"deep": ["w" * 100]}}),
    ([], {}),
    ({"a/b": None}, {"a/b": 0}),
])
def test_first_difference_equals_jaxs(a, b):
    assert PD.first_difference(a, b) == JD.first_difference(a, b)
    assert PD._short("v" * 100) == JD._short("v" * 100)


@pytest.mark.parametrize("step", ["ca", "ca-empty", "ca-gone", "runtime",
                                  "elyra", "feast", "feast-off"])
def test_mounts_equal_jaxs(step):
    out = []
    for jax in (True, False):
        m = make_side(jax)
        mounts, view = (JMo, JNotebook) if jax else (PMo, PNotebook)
        obj = tpu_nb(m, labels={JA.FEAST_INTEGRATION_LABEL: "true"})
        nb = view(obj)
        if step.startswith("ca"):
            cm = copy.deepcopy(CA_CM)
            if step == "ca-empty":
                cm["data"] = {}
            m.c.create(cm)
            changed = [mounts.check_and_mount_ca_bundle(nb, m.c)]
            if step == "ca-gone":
                m.c.delete("ConfigMap", cm["metadata"]["name"], "ns")
                changed.append(mounts.check_and_mount_ca_bundle(nb, m.c))
        elif step == "runtime":
            changed = [mounts.mount_runtime_images(nb, m.c)]
            m.c.create({"apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": JA_RUNTIME, "namespace": "ns"}})
            changed.append(mounts.mount_runtime_images(nb, m.c))
            changed.append(mounts.mount_runtime_images(nb, m.c))
        elif step == "elyra":
            m.c.create({"apiVersion": "v1", "kind": "Secret",
                        "metadata": {"name": JA_ELYRA, "namespace": "ns"}})
            changed = [mounts.mount_elyra_secret(nb, m.c),
                       mounts.mount_elyra_secret(nb, m.c)]
        else:
            changed = [mounts.sync_feast_mount(nb)]
            if step == "feast-off":
                obj["metadata"]["labels"][JA.FEAST_INTEGRATION_LABEL] = "no"
                changed.append(mounts.sync_feast_mount(nb))
        spec = obj["spec"].pop("tpu" if jax else "gpu")
        assert spec
        out.append((changed, obj))
    assert out[1] == out[0]
