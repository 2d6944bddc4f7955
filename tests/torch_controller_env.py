"""Two controller environments, the JAX package's and the port's, built
alike for the parity tests of the slice-health, pre-pull and platform
reconcilers.

``make_side`` is ``tests/harness.make_env`` for either package, over a
node pool of equal hosts: ``v5e`` 4x4 (4 hosts of 4 chips) on the JAX
side, ``h100`` 32 (4 hosts of 8 cards) on the port's. It registers, as
``make_env`` does and in its order, a token controller that mints the
ServiceAccounts' pull secrets, the ``NotebookReconciler``, the
``SlicePoolReconciler``, the ``SliceHealthReconciler``, the
``PlatformReconciler`` where asked, then the ``FakeKubelet``. With
``webhooks``, each side's admission is its package's own
``NotebookMutatingWebhook`` (with ``webhook_config``) and
``NotebookValidatingWebhook``, as ``make_env(webhooks=True)`` registers
them. Without them, where the platform is asked for, each side's
Notebook admission hook does two steps of the mutating webhook: the
reconciliation lock on create, and the kube-rbac-proxy sidecar injected
or removed by ``auth_sidecar``.

``compare`` holds the port's cluster to the JAX one after
``swap_cluster``, with the extra replacements this slice states
(``SLICE_STRINGS``: the catalog's names and the pool's labels), and the
two metrics expositions to each other.
"""

from __future__ import annotations

import copy
import types

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.api import slicepool as JSp
from kubeflow_tpu.api.notebook import Notebook as JNotebook
from kubeflow_tpu.api.notebook import TPUSpec, new_notebook
from kubeflow_tpu.controller import notebook as JC
from kubeflow_tpu.controller import platform as JPl
from kubeflow_tpu.controller import preemption as JPr
from kubeflow_tpu.controller import prepull as JPp
from kubeflow_tpu.controller import slicepool as JS
from kubeflow_tpu.k8s import errors as JE
from kubeflow_tpu.k8s import fake as JF
from kubeflow_tpu.k8s import fixtures as JX
from kubeflow_tpu.k8s import manager as JM
from kubeflow_tpu.metrics import metrics as JMm
from kubeflow_tpu.tpu import topology as JT
from kubeflow_tpu.webhook import auth_sidecar as JAs
from kubeflow_tpu.webhook import mutating as JMw
from kubeflow_tpu.webhook import validating as JVw
from kubeflow_tpu_torch.api import slicepool as PSp
from kubeflow_tpu_torch.api.notebook import GPUSpec
from kubeflow_tpu_torch.api.notebook import Notebook as PNotebook
from kubeflow_tpu_torch.controller import notebook as PC
from kubeflow_tpu_torch.controller import platform as PPl
from kubeflow_tpu_torch.controller import preemption as PPr
from kubeflow_tpu_torch.controller import prepull as PPp
from kubeflow_tpu_torch.controller import slicepool as PS
from kubeflow_tpu_torch.gpu import topology as PT
from kubeflow_tpu_torch.k8s import errors as PE
from kubeflow_tpu_torch.k8s import fake as PF
from kubeflow_tpu_torch.k8s import fixtures as PX
from kubeflow_tpu_torch.k8s import manager as PM
from kubeflow_tpu_torch.metrics import metrics as PMm
from kubeflow_tpu_torch.webhook import auth_sidecar as PAs
from kubeflow_tpu_torch.webhook import mutating as PMw
from kubeflow_tpu_torch.webhook import validating as PVw
from tests.test_torch_controller_loop import _samples
from tests.torch_gpu_swap import swap_cluster

JSHAPE, PSHAPE = ("v5e", "4x4"), ("h100", "32")
PROXY_IMAGE = "kube-rbac-proxy:test"
JTOPO, PTOPO = JT.slice_from_spec(*JSHAPE), PT.slice_from_spec(*PSHAPE)
# JAX's harness pool label for v5e.
JPOOL_LABEL = "tpu-v5-lite-podslice"


def nodes_map(hosts: int) -> dict:
    return {f"tpu-node-{JTOPO.topology_str}-{i}":
            f"gpu-node-{PTOPO.topology_str}-{i}" for i in range(hosts)}


# The SlicePool's labels and the warm placeholder's names carry the
# catalog's names of the shape.
SLICE_STRINGS = {JTOPO.accelerator.name: PTOPO.accelerator.name,
                 JTOPO.topology_str: PTOPO.topology_str,
                 JTOPO.accelerator_type: PTOPO.accelerator_type}


class TokenController:
    """The token controller of ``tests/harness.py`` for either package:
    mints an image-pull secret onto every ServiceAccount without one."""

    def __init__(self, client, errors, manager_mod):
        self.client, self.errors, self.M = client, errors, manager_mod

    def register(self, manager) -> None:
        manager.register(self, for_kind="ServiceAccount",
                         name="TokenController")

    def reconcile(self, req):
        try:
            sa = self.client.get("ServiceAccount", req.name, req.namespace)
        except self.errors.NotFoundError:
            return self.M.Result()
        if not sa.get("imagePullSecrets"):
            sa["imagePullSecrets"] = [{"name": f"{req.name}-dockercfg"}]
            self.client.update(sa)
        return self.M.Result()


def make_side(jax: bool, node_hosts: int = 4, platform: bool = False,
              platform_config: dict = None, recovery_config: dict = None,
              sa_pull_secrets: bool = True, slice_health: bool = True,
              migration_trigger=None, webhooks: bool = False,
              webhook_config: dict = None):
    """One side's environment; ``platform_config``, ``recovery_config``
    and ``webhook_config`` are keyword dicts of the configs."""
    m = types.SimpleNamespace(jax=jax, key="tpu" if jax else "gpu")
    m.F, m.M, m.X, m.Mm, m.C, m.S, m.Pr, m.Pl, m.Pp, m.E, m.Sp = (
        (JF, JM, JX, JMm, JC, JS, JPr, JPl, JPp, JE, JSp) if jax else
        (PF, PM, PX, PMm, PC, PS, PPr, PPl, PPp, PE, PSp))
    m.clock = m.M.FakeClock()
    m.c = m.F.FakeCluster(clock=m.clock)
    m.mgr = m.M.Manager(m.c, clock=m.clock)
    m.metrics = m.Mm.Metrics(m.c)
    m.kubelet = m.X.FakeKubelet(m.c)
    m.X.add_cpu_node(m.c, "cpu-node-0")
    if jax:
        m.X.add_tpu_node_pool(m.c, JPOOL_LABEL, JTOPO.topology_str,
                              hosts=node_hosts,
                              chips_per_host=JTOPO.chips_per_host)
    else:
        m.X.add_gpu_node_pool(m.c, PTOPO.gke_accelerator_label,
                              PTOPO.topology_str, hosts=node_hosts,
                              cards_per_host=PTOPO.chips_per_host)
    if sa_pull_secrets:
        m.c.create({"apiVersion": "v1", "kind": "ServiceAccount",
                    "metadata": {"name": "default", "namespace": "ns"},
                    "imagePullSecrets": [{"name": "default-dockercfg"}]})
        TokenController(m.c, m.E, m.M).register(m.mgr)
    m.C.NotebookReconciler(m.c, m.C.ControllerConfig(), metrics=m.metrics,
                           clock=m.clock).register(m.mgr)
    m.S.SlicePoolReconciler(m.c, metrics=m.metrics, clock=m.clock).register(
        m.mgr)
    if slice_health:
        m.Pr.SliceHealthReconciler(
            m.c, metrics=m.metrics, clock=m.clock,
            config=m.Pr.RecoveryConfig(**(recovery_config or {})),
            migration_trigger=migration_trigger).register(m.mgr)
    if platform:
        if not webhooks:
            _admission(m)
        m.Pl.PlatformReconciler(
            m.c, m.Pl.PlatformConfig(**(platform_config or {}))).register(
            m.mgr)
    m.kubelet.register(m.mgr)
    if webhooks:
        mw, vw = (JMw, JVw) if jax else (PMw, PVw)
        m.webhook = mw.NotebookMutatingWebhook(
            m.c, mw.WebhookConfig(**(webhook_config or {})))
        m.webhook.register(m.c)
        vw.NotebookValidatingWebhook(m.c).register(m.c)
    return m


def _admission(m) -> None:
    sidecar, view = (JAs, JNotebook) if m.jax else (PAs, PNotebook)

    def hook(req):
        nb = view(req.object)
        if req.operation == "CREATE" and JA.STOP not in nb.annotations:
            nb.annotations[JA.STOP] = JA.RECONCILIATION_LOCK_VALUE
        if nb.annotations.get(JA.INJECT_AUTH) == "true":
            sidecar.inject_kube_rbac_proxy(nb, PROXY_IMAGE)
        else:
            sidecar.remove_kube_rbac_proxy(nb)
        return req.object

    m.c.register_mutating_webhook("Notebook", hook)


def notebook(m, name: str = "nb", device=True,
             image: str = "notebook:latest", annotations: dict = None,
             labels: dict = None, shape=(JSHAPE, PSHAPE)) -> dict:
    """``tests/harness.tpu_notebook`` (``device``) or ``cpu_notebook`` in
    namespace "ns", with ``spec.gpu`` on the port's side; ``shape`` is
    the (JAX, port) pair of (accelerator, topology)."""
    obj = new_notebook(name, "ns", image=image,
                       tpu=TPUSpec(*shape[0]) if device else None,
                       annotations=dict(annotations or {}),
                       labels=dict(labels or {}))
    if device and not m.jax:
        del obj["spec"]["tpu"]
        obj["spec"]["gpu"] = GPUSpec(*shape[1]).to_dict()
    return obj


def slicepool(m) -> dict:
    """A SlicePool "pool" in "ns" of one warm slice of the notebook's
    shape."""
    return (JSp.new_slicepool("pool", "ns", TPUSpec(*JSHAPE)) if m.jax
            else PSp.new_slicepool("pool", "ns", GPUSpec(*PSHAPE)))


def strip(objects: dict) -> dict:
    """The objects without the device blocks the test writes itself
    (``spec.tpu`` on one side, ``spec.gpu`` on the other) on Notebooks
    and SlicePools."""
    out = copy.deepcopy(objects)
    for (kind, _, _), obj in out.items():
        if kind in ("Notebook", "SlicePool"):
            obj.get("spec", {}).pop("tpu", None)
            obj.get("spec", {}).pop("gpu", None)
    return out


def compare(j, p, hosts: int = 4, what=None) -> dict:
    """The port's cluster equals the JAX one after the replacements, the
    uid counters and watch logs agree, and so do the two expositions.
    Returns the port's metric samples."""
    want = swap_cluster(strip(j.c._objects), JTOPO, PTOPO, nodes_map(hosts),
                        SLICE_STRINGS)
    got = strip(p.c._objects)
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for key in want:
        assert got[key] == want[key], (what, key)
    assert (p.c._uid, len(p.c.events)) == (j.c._uid, len(j.c.events)), what
    jm, pm = _samples(j, False), _samples(p, True)
    chips, cards = float(jm.pop("tpu_chips_in_use")), float(
        pm.pop("tpu_chips_in_use"))
    assert cards == chips / JTOPO.chips_per_host * PTOPO.chips_per_host
    reclaimed = "tpu_chips_reclaimed_total"
    jr, pr = float(jm.pop(reclaimed)), float(pm.pop(reclaimed))
    assert pr == jr / JTOPO.chips * PTOPO.chips, what
    assert pm == jm, what
    return pm


def both(fn, j, p):
    """``fn`` on each side, the JAX one first; then no reconcile errors."""
    for m in (j, p):
        fn(m)
        assert not m.mgr.reconcile_errors, m.mgr.reconcile_errors


def lockstep(j, p, scenario, check, hosts: int = 4, what=None) -> None:
    """Drive ``scenario(side)``, a generator that yields a label after
    each step, on both sides in turn; compare after every step; then run
    ``check`` on each side."""
    steps = [scenario(j), scenario(p)]
    while True:
        seen = [next(s, None) for s in steps]
        assert seen[0] == seen[1], seen
        for m in (j, p):
            assert not m.mgr.reconcile_errors, m.mgr.reconcile_errors
        compare(j, p, hosts, what=(what, seen[0]))
        if seen[0] is None:
            break
    for m in (j, p):
        check(m)
