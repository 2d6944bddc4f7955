"""The port's platform reconciler against the JAX package's, on the CPU.

Each scenario of ``tests/test_platform.py`` runs on a JAX cluster and on
the port's (``tests/torch_controller_env.py`` with the platform: ``v5e``
4x4 against ``h100`` 32, four hosts each, on separate ``FakeClock``s, and
each side's admission hook doing the reconciliation lock and the
kube-rbac-proxy sidecar through its own ``auth_sidecar``). After every
step every object, every Event and the two metrics expositions are equal
after ``tests/torch_gpu_swap.swap_cluster``, and at the end the JAX
test's own assertions hold on both sides:

- lifecycle: the finalizer, the lock released (the slice starts), held
  until the pod ServiceAccount's pull secret is minted, and a user's stop
  annotation never taken for the lock;
- routing: the HTTPRoute in the central namespace, the per-namespace
  ReferenceGrant, a deleted route recreated;
- auth mode: the bundle, and its cleanup when auth is switched off;
- network policies: the three of a multi-host slice, no slice policy for
  a CPU notebook, the gateway namespace admitted;
- deletion: the routes, the grant (kept while another notebook lives),
  the auth binding and a legacy OAuthClient go, then the finalizer;
- the CA bundle from its sources with PEM validation (the webhook's
  mount of it is ROADMAP item 19), runtime images, the Elyra secret from
  a DSPA (its S3 credentials decoded), pipeline RBAC, MLflow's requeue
  until its ClusterRole exists, the proxy Service's drift repaired, and
  the config's namespace in the routes.

Beside them, held to JAX's: a one-host GPU slice gets no intra-slice
policy and a multi-host one does, whatever its slice count;
``fetch_tls_profile`` on every profile type, with no ``APIServer`` and on
a read error; ``SecurityProfileWatcher`` firing once on a change;
``parse_sidecar_resources``, ``inject_kube_rbac_proxy`` and
``remove_kube_rbac_proxy``; and the configs from the env.
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import json

import pytest

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.api import names as JN
from kubeflow_tpu.api.notebook import Notebook as JNotebook
from kubeflow_tpu.api.notebook import TPUSpec, new_notebook
from kubeflow_tpu.controller import network as JNet
from kubeflow_tpu.controller import platform as JPl
from kubeflow_tpu.controller import routes as JR
from kubeflow_tpu.controller import tls as JTls
from kubeflow_tpu.k8s import fake as JF
from kubeflow_tpu.k8s import manager as JM
from kubeflow_tpu.webhook import auth_sidecar as JAs
from kubeflow_tpu_torch.api import annotations as PA
from kubeflow_tpu_torch.api import names as PN
from kubeflow_tpu_torch.api.notebook import GPUSpec
from kubeflow_tpu_torch.api.notebook import Notebook as PNotebook
from kubeflow_tpu_torch.controller import network as PNet
from kubeflow_tpu_torch.controller import platform as PPl
from kubeflow_tpu_torch.controller import routes as PR
from kubeflow_tpu_torch.controller import tls as PTls
from kubeflow_tpu_torch.k8s import fake as PF
from kubeflow_tpu_torch.k8s import manager as PM
from kubeflow_tpu_torch.webhook import auth_sidecar as PAs
from tests.test_torch_controller_loop import (  # noqa: F401 (autouse)
    _fixed_condition_clock,
)
from tests.torch_controller_env import lockstep, make_side, notebook

CENTRAL = "opendatahub"
FINALIZER = JPl.FINALIZER
assert PPl.FINALIZER == FINALIZER
PEM = "-----BEGIN CERTIFICATE-----\nMIIBBB==\n-----END CERTIFICATE-----"
AUTH = {JA.INJECT_AUTH: "true"}


def _sts_replicas(m):
    return m.c.get("StatefulSet", "nb", "ns")["spec"]["replicas"]


def _nb(m, name="nb"):
    return m.c.get("Notebook", name, "ns")


def _create(m, **kw):
    m.c.create(notebook(m, **kw))
    m.mgr.run_until_idle()


def _touch(m, key, value):
    nb = _nb(m)
    if value is None:
        del nb["metadata"]["annotations"][key]
    else:
        nb["metadata"]["annotations"][key] = value
    m.c.update(nb)
    m.mgr.run_until_idle()


def _backend(m):
    route = m.c.get("HTTPRoute", "nb-ns-nb", CENTRAL)
    return route["spec"]["rules"][0]["backendRefs"][0]


# -- lifecycle -------------------------------------------------------------------


def lock_released(m):
    _create(m)
    yield "created"


def check_lock_released(m):
    nb = _nb(m)
    assert FINALIZER in nb["metadata"]["finalizers"]
    assert JA.STOP not in nb["metadata"].get("annotations", {})
    assert _sts_replicas(m) == 4
    assert nb["status"][m.key]["sliceHealth"] == "Healthy"


def pull_secret_wait(m):
    _create(m)
    nb = _nb(m)
    assert nb["metadata"]["annotations"][JA.STOP] == (
        JA.RECONCILIATION_LOCK_VALUE)
    assert _sts_replicas(m) == 0
    yield "held"
    m.c.create({"apiVersion": "v1", "kind": "ServiceAccount",
                "metadata": {"name": "default", "namespace": "ns"},
                "imagePullSecrets": [{"name": "default-dockercfg"}]})
    m.mgr.tick(3.0)
    yield "minted"


def check_pull_secret_wait(m):
    assert JA.STOP not in _nb(m)["metadata"].get("annotations", {})
    assert _sts_replicas(m) == 4
    assert [e for e in m.c.list("Event", "ns")
            if e["reason"] == "WaitingForPullSecret"]


def user_stop(m):
    _create(m)
    yield "created"
    _touch(m, JA.STOP, "2026-07-29T10:00:00Z")
    yield "stopped"


def check_user_stop(m):
    assert _nb(m)["metadata"]["annotations"][JA.STOP] == (
        "2026-07-29T10:00:00Z")
    assert _sts_replicas(m) == 0


# -- routing ---------------------------------------------------------------------


def cpu_created(m):
    _create(m, device=False, image="jupyter-minimal:latest")
    yield "created"


def check_route(m):
    route = m.c.get("HTTPRoute", "nb-ns-nb", CENTRAL)
    rule = route["spec"]["rules"][0]
    assert rule["matches"][0]["path"]["value"] == "/notebook/ns/nb"
    assert rule["backendRefs"][0] == {"name": "nb", "namespace": "ns",
                                      "port": 80}
    assert route["spec"]["parentRefs"][0]["name"] == "data-science-gateway"


def check_grant(m):
    grant = m.c.get("ReferenceGrant", "notebook-httproute-access", "ns")
    assert grant["spec"]["from"][0]["namespace"] == CENTRAL
    assert grant["spec"]["to"][0]["kind"] == "Service"


def route_recreated(m):
    _create(m, device=False)
    yield "created"
    m.c.delete("HTTPRoute", "nb-ns-nb", CENTRAL)
    m.mgr.run_until_idle()
    yield "recreated"


def check_route_recreated(m):
    assert m.c.exists("HTTPRoute", "nb-ns-nb", CENTRAL)


# -- auth mode -------------------------------------------------------------------


def auth_bundle(m):
    _create(m, device=False, annotations=AUTH)
    yield "created"


def check_auth_bundle(m):
    assert m.c.exists("ServiceAccount", "nb-auth-proxy", "ns")
    svc = m.c.get("Service", "nb-kube-rbac-proxy", "ns")
    assert svc["metadata"]["annotations"][
        "service.beta.openshift.io/serving-cert-secret-name"] == "nb-tls"
    cm = m.c.get("ConfigMap", "nb-kube-rbac-proxy-config", "ns")
    attrs = json.loads(cm["data"]["config-file.yaml"])["authorization"][
        "resourceAttributes"]
    assert (attrs["resource"], attrs["name"]) == ("notebooks", "nb")
    crb = m.c.get("ClusterRoleBinding", "ns-nb-auth-delegator")
    assert crb["roleRef"]["name"] == "system:auth-delegator"
    assert _backend(m)["port"] == 8443
    # The admission hook's sidecar, on the pod template too.
    spec = _nb(m)["spec"]["template"]["spec"]
    assert spec["serviceAccountName"] == "nb-auth-proxy"
    assert [c["name"] for c in spec["containers"]] == ["nb",
                                                       "kube-rbac-proxy"]


def auth_switch_off(m):
    _create(m, device=False, annotations=AUTH)
    yield "auth"
    _touch(m, JA.INJECT_AUTH, None)
    yield "plain"


def check_auth_switch_off(m):
    assert not m.c.exists("ServiceAccount", "nb-auth-proxy", "ns")
    assert not m.c.exists("Service", "nb-kube-rbac-proxy", "ns")
    assert not m.c.exists("ClusterRoleBinding", "ns-nb-auth-delegator")
    assert _backend(m)["port"] == 80
    spec = _nb(m)["spec"]["template"]["spec"]
    assert "serviceAccountName" not in spec
    assert [c["name"] for c in spec["containers"]] == ["nb"]


def proxy_service_drift(m):
    _create(m, device=False, annotations=AUTH)
    yield "created"
    m.c.delete("Service", "nb-kube-rbac-proxy", "ns")
    m.mgr.run_until_idle()
    yield "repaired"


def check_proxy_service_drift(m):
    assert m.c.exists("Service", "nb-kube-rbac-proxy", "ns")


# -- network policies ------------------------------------------------------------


def check_slice_policies(m):
    ctrl = m.c.get("NetworkPolicy", "nb-ctrl-np", "ns")
    ingress = ctrl["spec"]["ingress"][0]
    assert ingress["ports"][0]["port"] == 8888
    assert ingress["from"][0]["namespaceSelector"]["matchLabels"][
        "kubernetes.io/metadata.name"] == CENTRAL
    assert m.c.exists("NetworkPolicy", "nb-kube-rbac-proxy-np", "ns")
    peer = m.c.get("NetworkPolicy", "nb-slice-np", "ns")["spec"][
        "ingress"][0]["from"][0]
    assert peer["podSelector"]["matchLabels"]["statefulset"] == "nb"


def check_no_slice_policy(m):
    assert not m.c.exists("NetworkPolicy", "nb-slice-np", "ns")


def check_gateway_namespace(m):
    np_obj = m.c.get("NetworkPolicy", "nb-ctrl-np", "ns")
    selectors = [p["namespaceSelector"]["matchLabels"][
        "kubernetes.io/metadata.name"]
        for p in np_obj["spec"]["ingress"][0]["from"]]
    assert CENTRAL in selectors and "openshift-ingress" in selectors


# -- deletion --------------------------------------------------------------------


def full_cleanup(m):
    _create(m, device=False, annotations=AUTH)
    m.c.create({"apiVersion": "oauth.openshift.io/v1", "kind": "OAuthClient",
                "metadata": {"name": "nb-ns-oauth-client"}})
    yield "created"
    m.c.delete("Notebook", "nb", "ns")
    m.mgr.run_until_idle()
    yield "deleted"


def check_full_cleanup(m):
    assert not m.c.exists("Notebook", "nb", "ns")
    assert not m.c.exists("HTTPRoute", "nb-ns-nb", CENTRAL)
    assert not m.c.exists("ReferenceGrant", "notebook-httproute-access", "ns")
    assert not m.c.exists("ClusterRoleBinding", "ns-nb-auth-delegator")
    assert not m.c.exists("OAuthClient", "nb-ns-oauth-client")


def grant_kept(m):
    _create(m, name="nb-a", device=False)
    _create(m, name="nb-b", device=False)
    yield "created"
    m.c.delete("Notebook", "nb-a", "ns")
    m.mgr.run_until_idle()
    assert m.c.exists("ReferenceGrant", "notebook-httproute-access", "ns")
    yield "first deleted"
    m.c.delete("Notebook", "nb-b", "ns")
    m.mgr.run_until_idle()
    yield "last deleted"


def check_grant_gone(m):
    assert not m.c.exists("ReferenceGrant", "notebook-httproute-access", "ns")


# -- integrations ----------------------------------------------------------------


def ca_bundle(m):
    m.c.create({"apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": "odh-trusted-ca-bundle",
                             "namespace": CENTRAL},
                "data": {"ca-bundle.crt": PEM + "\ngarbage-not-pem"}})
    _create(m, device=False)
    yield "created"


def check_ca_bundle(m):
    cm = m.c.get("ConfigMap", "workbench-trusted-ca-bundle", "ns")
    assert PEM in cm["data"]["ca-bundle.crt"]
    assert "garbage" not in cm["data"]["ca-bundle.crt"]


def _imagestream(m, name="datascience-runtime", display=True):
    meta = {"name": name, "namespace": CENTRAL,
            "labels": {"opendatahub.io/runtime-image": "true"}}
    if display:
        meta["annotations"] = {
            "opendatahub.io/runtime-image-name": "Data Science 2026a"}
    m.c.create({"apiVersion": "image.openshift.io/v1", "kind": "ImageStream",
                "metadata": meta,
                "status": {"tags": [{"tag": "latest", "items": [
                    {"dockerImageReference": "reg/rt@sha256:1"}]}]}})


def runtime_images(m):
    _imagestream(m)
    _create(m, device=False)
    yield "created"


def check_runtime_images(m):
    cm = m.c.get("ConfigMap", "pipeline-runtime-images", "ns")
    key = "data-science-2026a.json"
    assert json.loads(cm["data"][key])["metadata"]["image_name"] == (
        "reg/rt@sha256:1")


def runtime_images_gone(m):
    _imagestream(m, name="rt", display=False)
    _create(m, device=False)
    assert m.c.exists("ConfigMap", "pipeline-runtime-images", "ns")
    yield "synced"
    m.c.delete("ImageStream", "rt", CENTRAL)
    _touch(m, "touch", "1")
    yield "gone"


def check_runtime_images_gone(m):
    assert not m.c.exists("ConfigMap", "pipeline-runtime-images", "ns")


def _dspa(m, access=b"ak", secret=b"sk", bucket="pipelines"):
    m.c.create({
        "apiVersion": "datasciencepipelinesapplications.opendatahub.io/v1",
        "kind": "DataSciencePipelinesApplication",
        "metadata": {"name": "dspa", "namespace": "ns"},
        "spec": {"objectStorage": {"externalStorage": {
            "host": "s3.example", "bucket": bucket,
            "s3CredentialsSecret": {"secretName": "s3-creds"}}}}})
    m.c.create({"apiVersion": "v1", "kind": "Secret",
                "metadata": {"name": "s3-creds", "namespace": "ns"},
                "data": {"AWS_ACCESS_KEY_ID": base64.b64encode(
                    access).decode(),
                    "AWS_SECRET_ACCESS_KEY": base64.b64encode(
                        secret).decode()}})


def elyra(m):
    _dspa(m)
    _create(m, device=False)
    yield "created"


def check_elyra(m):
    secret = m.c.get("Secret", "ds-pipeline-config", "ns")
    config = json.loads(secret["stringData"]["odh_dsp.json"])
    assert config["metadata"]["cos_bucket"] == "pipelines"
    assert config["schema_name"] == "kfp"
    owner = secret["metadata"]["ownerReferences"][0]
    assert owner["kind"] == "DataSciencePipelinesApplication"


def elyra_credentials(m):
    _dspa(m, b"my-access-key", b"my-secret", "b")
    _create(m, device=False)
    yield "created"


def check_elyra_credentials(m):
    secret = m.c.get("Secret", "ds-pipeline-config", "ns")
    config = json.loads(secret["stringData"]["odh_dsp.json"])
    assert config["metadata"]["cos_username"] == "my-access-key"
    assert config["metadata"]["cos_password"] == "my-secret"


def pipeline_rbac(m):
    m.c.create({"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
                "metadata": {"name": "ds-pipeline-user-access-dspa",
                             "namespace": "ns"}})
    _create(m, device=False)
    yield "created"


def check_pipeline_rbac(m):
    rb = m.c.get("RoleBinding", "elyra-pipelines-nb", "ns")
    assert rb["roleRef"]["name"] == "ds-pipeline-user-access-dspa"


def mlflow(m):
    _create(m, device=False, annotations={JA.MLFLOW_INSTANCE: "tracking"})
    assert not m.c.exists("RoleBinding", "mlflow-nb", "ns")
    assert m.mgr.next_requeue_in() is not None
    yield "waiting"
    m.c.create({"apiVersion": "rbac.authorization.k8s.io/v1",
                "kind": "ClusterRole",
                "metadata": {"name": "mlflow-operator-mlflow-integration"}})
    m.mgr.tick(31.0)
    yield "bound"


def check_mlflow(m):
    assert m.c.exists("RoleBinding", "mlflow-nb", "ns")


def check_config_namespace(m):
    assert m.c.exists("HTTPRoute", "nb-ns-nb", "my-ctrl")
    grant = m.c.get("ReferenceGrant", "notebook-httproute-access", "ns")
    assert grant["spec"]["from"][0]["namespace"] == "my-ctrl"


def device_created(m):
    _create(m)
    yield "created"


# name: (scenario, check, side keywords)
SCENARIOS = {
    "finalizer-and-lock-released": (lock_released, check_lock_released, {}),
    "lock-held-until-pull-secret": (pull_secret_wait, check_pull_secret_wait,
                                    {"sa_pull_secrets": False}),
    "user-stop-survives": (user_stop, check_user_stop, {}),
    "httproute-central-namespace": (cpu_created, check_route, {}),
    "reference-grant-per-namespace": (cpu_created, check_grant, {}),
    "route-recreated": (route_recreated, check_route_recreated, {}),
    "auth-bundle": (auth_bundle, check_auth_bundle, {}),
    "auth-switched-off": (auth_switch_off, check_auth_switch_off, {}),
    "slice-policies-multi-host": (device_created, check_slice_policies, {}),
    "no-slice-policy-cpu": (cpu_created, check_no_slice_policy, {}),
    "full-cleanup-on-delete": (full_cleanup, check_full_cleanup, {}),
    "grant-kept-while-another-lives": (grant_kept, check_grant_gone, {}),
    "ca-bundle-pem-validated": (ca_bundle, check_ca_bundle, {}),
    "runtime-images-synced": (runtime_images, check_runtime_images, {}),
    "elyra-secret-from-dspa": (elyra, check_elyra,
                               {"platform_config": {
                                   "set_pipeline_secret": True}}),
    "pipeline-rbac": (pipeline_rbac, check_pipeline_rbac,
                      {"platform_config": {"set_pipeline_rbac": True}}),
    "mlflow-requeues-for-role": (mlflow, check_mlflow,
                                 {"platform_config": {
                                     "mlflow_enabled": True}}),
    "proxy-service-drift-repaired": (proxy_service_drift,
                                     check_proxy_service_drift, {}),
    "config-namespace-in-routes": (cpu_created, check_config_namespace,
                                   {"platform_config": {
                                       "controller_namespace": "my-ctrl"}}),
    "elyra-decodes-credentials": (elyra_credentials,
                                  check_elyra_credentials,
                                  {"platform_config": {
                                      "set_pipeline_secret": True}}),
    "runtime-images-removed": (runtime_images_gone,
                               check_runtime_images_gone, {}),
    "ctrl-policy-admits-gateway": (cpu_created, check_gateway_namespace, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_platform_equals_jax_step_by_step(name):
    scenario, check, kw = SCENARIOS[name]
    lockstep(make_side(True, platform=True, **kw),
             make_side(False, platform=True, **kw), scenario, check,
             what=name)


# -- the intra-slice policy by host count ----------------------------------------


@pytest.mark.parametrize("tpu,gpu,policy", [
    (("v5e", "2x2", 1), ("h100", "4", 1), False),
    (("v5e", "2x2", 2), ("h100", "8", 2), False),
    (("v5e", "4x4", 1), ("h100", "32", 1), True),
    (("v5e", "4x4", 2), ("h100-mega", "32", 2), True),
], ids=["one-host", "one-host-multislice", "four-hosts", "four-hosts-ms"])
def test_slice_policy_follows_the_host_count(tpu, gpu, policy):
    out = []
    for jax, (acc, topo, slices), F, net in (
            (True, tpu, JF, JNet), (False, gpu, PF, PNet)):
        obj = new_notebook("nb", "ns", tpu=TPUSpec(acc, topo,
                                                   slice_count=slices))
        if not jax:
            del obj["spec"]["tpu"]
            obj["spec"]["gpu"] = GPUSpec(acc, topo,
                                         slice_count=slices).to_dict()
        c = F.FakeCluster()
        c.create(obj)
        view = (JNotebook if jax else PNotebook)(c.get("Notebook", "nb",
                                                       "ns"))
        net.reconcile_network_policies(c, view, CENTRAL, "openshift-ingress")
        out.append({k: v for k, v in c._objects.items()
                    if k[0] == "NetworkPolicy"})
    assert out[1] == out[0]
    assert (("NetworkPolicy", "ns", "nb-slice-np") in out[1]) == policy


# -- TLS profile -----------------------------------------------------------------


def _profile_fields(p):
    return (p.profile_type, p.min_version, p.ciphers)


class _Broken:
    def get(self, *a, **kw):
        raise RuntimeError("apiserver down")


@pytest.mark.parametrize("profile", [
    None, {}, {"type": "Old"}, {"type": "Intermediate"}, {"type": "Modern"},
    {"type": "Custom", "custom": {"ciphers": ["A", "B"],
                                  "minTLSVersion": "VersionTLS13"}},
    {"type": "Custom"}, {"type": "Nonsense"}, "broken",
], ids=["no-apiserver", "empty", "old", "intermediate", "modern", "custom",
        "custom-defaults", "unknown", "read-error"])
def test_fetch_tls_profile_equals_jax(profile):
    got = []
    for F, tls in ((JF, JTls), (PF, PTls)):
        c = F.FakeCluster()
        if profile == "broken":
            c = _Broken()
        elif profile is not None:
            c.create({"apiVersion": "config.openshift.io/v1",
                      "kind": "APIServer", "metadata": {"name": "cluster"},
                      "spec": {"tlsSecurityProfile": profile}})
        got.append(_profile_fields(tls.fetch_tls_profile(c)))
    assert got[1] == got[0]
    if profile in (None, "broken", {}):
        assert got[1][0] == "Intermediate"


def test_security_profile_watcher_fires_once_as_jax():
    seen = []
    for F, M, tls in ((JF, JM, JTls), (PF, PM, PTls)):
        c = F.FakeCluster()
        mgr = M.Manager(c, clock=M.FakeClock())
        fired = []
        boot = tls.fetch_tls_profile(c)
        tls.SecurityProfileWatcher(c, boot, lambda p, fired=fired: fired.append(
            _profile_fields(p))).register(mgr)
        trail = []
        for ptype in ("Intermediate", "Modern", "Old"):
            spec = {"tlsSecurityProfile": {"type": ptype}}
            if c.exists("APIServer", "cluster"):
                obj = c.get("APIServer", "cluster")
                obj["spec"] = spec
                c.update(obj)
            else:
                c.create({"apiVersion": "config.openshift.io/v1",
                          "kind": "APIServer",
                          "metadata": {"name": "cluster"}, "spec": spec})
            mgr.run_until_idle()
            trail.append(list(fired))
        seen.append((_profile_fields(boot), trail))
    assert seen[1] == seen[0]
    assert seen[1][1] == [[], [seen[1][1][1][0]], [seen[1][1][1][0]]]
    assert seen[1][1][1][0][0] == "Modern"


# -- the auth sidecar ------------------------------------------------------------


SIDECAR_CASES = {
    "fresh": ({}, None),
    "overrides": ({JA.AUTH_SIDECAR_CPU_REQUEST: "50m",
                   JA.AUTH_SIDECAR_MEMORY_LIMIT: "128Mi"}, None),
    "already-injected": ({}, "inject"),
    "bad-quantity": ({JA.AUTH_SIDECAR_CPU_LIMIT: "lots"}, None),
}


@pytest.mark.parametrize("case", list(SIDECAR_CASES))
def test_auth_sidecar_equals_jax(case):
    annotations, before = SIDECAR_CASES[case]
    out = []
    for view, mod in ((JNotebook, JAs), (PNotebook, PAs)):
        obj = new_notebook("nb", "ns", annotations=dict(annotations))
        nb = view(obj)
        trail = []
        try:
            if before == "inject":
                mod.inject_kube_rbac_proxy(nb, "proxy:old")
            trail.append(mod.parse_sidecar_resources(nb))
            trail.append(mod.inject_kube_rbac_proxy(nb, "proxy:1"))
            trail.append(copy.deepcopy(obj))
            trail.append(mod.inject_kube_rbac_proxy(nb, "proxy:1"))
            trail.append(mod.remove_kube_rbac_proxy(nb))
            trail.append(copy.deepcopy(obj))
            trail.append(mod.remove_kube_rbac_proxy(nb))
        except ValueError as err:
            assert type(err).__name__ == "InvalidSidecarResources"
            trail.append(str(err))
        out.append(trail)
    assert out[1] == out[0]
    assert (len(out[1]) == 1) == (case == "bad-quantity")
    for fn in ("service_account_name", "rbac_config_map_name",
               "tls_secret_name"):
        assert getattr(PAs, fn)("nb") == getattr(JAs, fn)("nb")


# -- configs and names -----------------------------------------------------------


@pytest.mark.parametrize("env", [
    {}, {"K8S_NAMESPACE": "ctrl", "SET_PIPELINE_RBAC": "TRUE",
         "SET_PIPELINE_SECRET": "true", "MLFLOW_ENABLED": "True",
         "GATEWAY_URL": "https://gw.example", "NOTEBOOK_GATEWAY_NAME": "g",
         "NOTEBOOK_GATEWAY_NAMESPACE": "gns"}])
def test_configs_and_names_equal_jax(env):
    assert dataclasses.asdict(PPl.PlatformConfig.from_env(env)) == (
        dataclasses.asdict(JPl.PlatformConfig.from_env(env)))
    assert dataclasses.asdict(PR.RouteConfig.from_env(env)) == (
        dataclasses.asdict(JR.RouteConfig.from_env(env)))
    long_name = "n" * 60
    for name in ("nb", long_name):
        assert PN.proxy_service_name(name) == JN.proxy_service_name(name)
    for key in ("CA_BUNDLE_CONFIGMAP", "RUNTIME_IMAGES_CONFIGMAP",
                "ELYRA_SECRET_NAME", "MANAGED_BY_LABEL", "MANAGED_BY_VALUE",
                "RBAC_PROXY_PORT"):
        assert getattr(PN, key) == getattr(JN, key), key
    for key in ("RECONCILIATION_LOCK_VALUE", "PLATFORM_CLEANUP_FINALIZER",
                "INJECT_AUTH", "INJECT_OAUTH_LEGACY", "PREPULL_LABEL",
                "AUTH_SIDECAR_CPU_REQUEST", "AUTH_SIDECAR_CPU_LIMIT",
                "AUTH_SIDECAR_MEMORY_REQUEST", "AUTH_SIDECAR_MEMORY_LIMIT",
                "RUNTIME_IMAGE_LABEL", "RUNTIME_IMAGE_NAME",
                "MLFLOW_INSTANCE", "FEAST_INTEGRATION_LABEL",
                "ODH_DASHBOARD_LABEL", "LAST_IMAGE_SELECTION",
                "WORKBENCH_IMAGE_NAMESPACE", "TPU_MIGRATE_NOW"):
        assert getattr(PA, key) == getattr(JA, key), key
    assert sorted(PA.RESERVED_POD_PORTS) == sorted(JA.RESERVED_POD_PORTS)
    obj = {"metadata": {"annotations": {
        JA.STOP: JA.RECONCILIATION_LOCK_VALUE}}}
    assert PNotebook(obj).lock_held and JNotebook(obj).lock_held
    obj["metadata"]["annotations"][JA.STOP] = "2026-01-01T00:00:00Z"
    assert not PNotebook(obj).lock_held and not JNotebook(obj).lock_held
