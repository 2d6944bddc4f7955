"""The port's ``RealClient`` against the port's ``EnvtestServer``, on the
CPU: the cases of ``tests/test_real_client.py``. Every CRUD, admission and
watch case runs three ways, to show the two packages speak one REST
dialect: the port's client against the port's server, the port's client
against JAX's server, and JAX's client against the port's server. Beside
them: the REST paths and query strings equal JAX's for every kind, the
Status errors each status code maps to, bearer tokens, the read deadline,
resume without a reseed, the relist on 410, an apiserver restart, the
kubeconfig and in-cluster configs, and the one stated difference of the
port's server (no CRD schema).
"""

from __future__ import annotations

import json
import socket
import time
import types

import pytest

from kubeflow_tpu.api.notebook import TPUSpec, new_notebook
from kubeflow_tpu.k8s import envtest as JEv
from kubeflow_tpu.k8s import errors as JE
from kubeflow_tpu.k8s import fake as JF
from kubeflow_tpu.k8s import real as JR
from kubeflow_tpu.k8s import rest as JRest
from kubeflow_tpu_torch.k8s import envtest as PEv
from kubeflow_tpu_torch.k8s import errors as PE
from kubeflow_tpu_torch.k8s import fake as PF
from kubeflow_tpu_torch.k8s import real as PR
from kubeflow_tpu_torch.k8s import rest as PRest

# (client package, server package).
WAYS = {"port-port": (False, False), "port-jax": (False, True),
        "jax-port": (True, False)}


def _pkg(jax):
    return types.SimpleNamespace(
        Ev=JEv if jax else PEv, E=JE if jax else PE, F=JF if jax else PF,
        R=JR if jax else PR, Rest=JRest if jax else PRest)


@pytest.fixture(params=list(WAYS), ids=list(WAYS))
def way(request):
    client_jax, server_jax = WAYS[request.param]
    srv = _pkg(server_jax).Ev.EnvtestServer().start()
    made = []

    def new_client(cfg=None):
        c = _pkg(client_jax).R.RealClient(cfg or srv.client_config())
        made.append(c)
        return c

    w = types.SimpleNamespace(server=srv, new_client=new_client,
                              E=_pkg(client_jax).E, S=_pkg(server_jax))
    w.client = new_client()
    yield w
    for c in made:
        c.stop()
    srv.stop()


def _cm(name="c1", ns="ns", data=None, labels=None):
    obj = {"apiVersion": "v1", "kind": "ConfigMap",
           "metadata": {"name": name, "namespace": ns},
           "data": data or {"k": "v"}}
    if labels:
        obj["metadata"]["labels"] = labels
    return obj


# -- REST paths ------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(JRest.KINDS))
def test_rest_paths_equal_jaxs(kind):
    assert vars(PRest.KINDS[kind]) == vars(JRest.KINDS[kind])
    for ns in ("", "team a"):
        for fn in ("collection_path",):
            assert getattr(PRest, fn)(kind, ns) == getattr(JRest, fn)(kind, ns)
        for fn in ("object_path", "status_path"):
            assert getattr(PRest, fn)(kind, "n/1", ns) == getattr(JRest, fn)(
                kind, "n/1", ns)
    assert PRest.info_for(kind).api_version == JRest.info_for(
        kind).api_version


def test_rest_table_and_queries_equal_jaxs():
    assert sorted(PRest.KINDS) == sorted(JRest.KINDS)
    assert PRest.collection_path("Pod", "ns") == "/api/v1/namespaces/ns/pods"
    assert PRest.collection_path("Node") == "/api/v1/nodes"
    assert PRest.collection_path("Notebook", "u") == (
        "/apis/kubeflow.org/v1beta1/namespaces/u/notebooks")
    for kw in ({}, {"label_selector": {"a": "1", "b": "2"}},
               {"watch": True, "resource_version": "5",
                "allow_bookmarks": True, "timeout_seconds": 240},
               {"field_selector": {"spec.nodeName": "n"}, "watch": True},
               {"resource_version": "3"}):
        assert PRest.list_query(**kw) == JRest.list_query(**kw)
    assert PRest.list_query(label_selector={"a": "1", "b": "2"}) == (
        "?labelSelector=a%3D1%2Cb%3D2")
    with pytest.raises(PRest.UnknownKindError, match="kubeflow_tpu_torch"):
        PRest.collection_path("Gadget")


@pytest.mark.parametrize("status,body", [
    (404, b'{"message": "gone"}'),
    (409, b'{"reason": "AlreadyExists", "message": "dup"}'),
    (409, b'{"reason": "Conflict", "message": "stale"}'),
    (422, b'{"message": "bad"}'), (400, b"not json"),
    (403, b'{"message": "admission webhook denied the request: no"}'),
    (403, b'{"message": "forbidden"}'), (500, b"")])
def test_status_errors_equal_jaxs(status, body):
    jerr, perr = JR._error_for(status, body), PR._error_for(status, body)
    assert type(perr).__name__ == type(jerr).__name__
    assert (str(perr), perr.code) == (str(jerr), jerr.code)


# -- CRUD, three ways ------------------------------------------------------------


def test_create_get_roundtrip(way):
    created = way.client.create(_cm())
    assert created["metadata"]["uid"]
    got = way.client.get("ConfigMap", "c1", "ns")
    assert got["data"] == {"k": "v"} and got["kind"] == "ConfigMap"


def test_get_missing_raises_notfound(way):
    with pytest.raises(way.E.NotFoundError):
        way.client.get("ConfigMap", "nope", "ns")


def test_create_duplicate_raises_already_exists(way):
    way.client.create(_cm())
    with pytest.raises(way.E.AlreadyExistsError):
        way.client.create(_cm())


def test_list_with_label_selector(way):
    way.client.create(_cm("a", labels={"app": "x"}))
    way.client.create(_cm("b", labels={"app": "y"}))
    names = [o["metadata"]["name"]
             for o in way.client.list("ConfigMap", "ns", {"app": "x"})]
    assert names == ["a"]
    assert all(o["kind"] == "ConfigMap"
               for o in way.client.list("ConfigMap", "ns"))


def test_stale_update_conflicts(way):
    created = way.client.create(_cm())
    fresh = way.client.get("ConfigMap", "c1", "ns")
    fresh["data"] = {"k": "v2"}
    way.client.update(fresh)
    created["data"] = {"k": "v3"}
    with pytest.raises(way.E.ConflictError):
        way.client.update(created)


def test_status_subresource_is_isolated(way):
    way.client.create(new_notebook("nb", "u", image="img"))
    stored = way.client.get("Notebook", "nb", "u")
    stored["status"] = {"readyReplicas": 3}
    way.client.update_status(stored)
    stored = way.client.get("Notebook", "nb", "u")
    stored["spec"]["template"]["spec"]["containers"][0]["image"] = "img2"
    stored["status"] = {}
    way.client.update(stored)
    assert way.client.get("Notebook", "nb", "u")["status"][
        "readyReplicas"] == 3


def test_merge_patch(way):
    way.client.create(_cm())
    way.client.patch("ConfigMap", "c1", "ns", {"data": {"extra": "1"}})
    assert way.client.get("ConfigMap", "c1", "ns")["data"] == {
        "k": "v", "extra": "1"}


def test_delete(way):
    way.client.create(_cm())
    way.client.delete("ConfigMap", "c1", "ns")
    assert not way.client.exists("ConfigMap", "c1", "ns")
    with pytest.raises(way.E.NotFoundError):
        way.client.delete("ConfigMap", "c1", "ns")


def test_cluster_scoped_kind(way):
    way.client.create({"apiVersion": "v1", "kind": "Namespace",
                       "metadata": {"name": "team-a"}})
    assert [n["metadata"]["name"]
            for n in way.client.list("Namespace")] == ["team-a"]


def test_webhook_denial_maps_to_typed_error(way):
    def deny(req):
        raise way.S.E.WebhookDeniedError("nope: policy")

    way.server.cluster.register_validating_webhook("ConfigMap", deny)
    with pytest.raises(way.E.WebhookDeniedError, match="policy"):
        way.client.create(_cm())


def test_remote_admission_patches_and_denies(way):
    """``add_remote_webhook``: an AdmissionReview server's patch lands
    on the stored object; its denial and an unreachable server deny."""
    from kubeflow_tpu_torch.webhook.server import WebhookServer

    def mutate(req):
        req.object.setdefault("data", {})["added"] = "by-webhook"
        return req.object

    def validate(req):
        if req.object["metadata"]["name"] == "bad":
            raise PE.WebhookDeniedError("bad name")

    hook = WebhookServer(mutate, validate)
    hook.start()
    try:
        base = f"http://127.0.0.1:{hook.port}"
        way.server.add_remote_webhook(
            "ConfigMap", mutate_url=base + "/mutate-notebook-v1",
            validate_url=base + "/validate-notebook-v1")
        assert way.client.create(_cm())["data"]["added"] == "by-webhook"
        way.client.patch("ConfigMap", "c1", "ns", {"data": {"k": "w"}})
        assert way.client.get("ConfigMap", "c1", "ns")["data"] == {
            "k": "w", "added": "by-webhook"}
        with pytest.raises(way.E.WebhookDeniedError, match="bad name"):
            way.client.create(_cm("bad"))
    finally:
        hook.stop()
    with pytest.raises(way.E.WebhookDeniedError, match="webhook call failed"):
        way.client.create(_cm("c2"))


def test_bearer_token_required_when_configured():
    for client_jax, server_jax in WAYS.values():
        srv = _pkg(server_jax).Ev.EnvtestServer(token="sekrit").start()
        R = _pkg(client_jax).R
        good = R.RealClient(srv.client_config())
        bad_cfg = srv.client_config()
        bad_cfg.token = "wrong"
        bad = R.RealClient(bad_cfg)
        try:
            good.create(_cm())
            with pytest.raises(Exception) as err:
                bad.get("ConfigMap", "c1", "ns")
            assert getattr(err.value, "code", None) == 401
        finally:
            good.stop()
            bad.stop()
            srv.stop()


# -- watches ---------------------------------------------------------------------


def _drain_all(client, cursor, settle=0.3):
    out = []
    while client.wait_for_events(cursor, timeout=settle):
        events, cursor = client.drain_events(cursor)
        out.extend(events)
    return out, cursor


def test_list_seed_then_live_events(way):
    with way.server.lock:
        way.server.cluster.create(_cm("pre"))
    way.client.start_watches(["ConfigMap"])
    assert way.client.wait_for_events(0, timeout=5)
    events, cursor = way.client.drain_events(0)
    assert [(e.type, e.name) for e in events] == [("ADDED", "pre")]
    writer = way.new_client()
    writer.create(_cm("live"))
    seen = []
    live = writer.get("ConfigMap", "live", "ns")
    live["data"] = {"k": "v2"}
    writer.update(live)
    writer.delete("ConfigMap", "live", "ns")
    deadline = time.monotonic() + 10
    while len(seen) < 3 and time.monotonic() < deadline:
        if way.client.wait_for_events(cursor, timeout=1):
            events, cursor = way.client.drain_events(cursor)
            seen += [(e.type, e.name) for e in events]
    assert seen == [("ADDED", "live"), ("MODIFIED", "live"),
                    ("DELETED", "live")]


def test_reconnect_resumes_without_reseed(way):
    with way.server.lock:
        way.server.cluster.create(_cm("pre1"))
        way.server.cluster.create(_cm("pre2"))
    way.client.start_watches(["ConfigMap"])
    events, cursor = _drain_all(way.client, 0)
    assert sorted(e.name for e in events) == ["pre1", "pre2"]
    way.client._watchers[0]._conn.close()
    way.new_client().create(_cm("post"))
    assert way.client.wait_for_events(cursor, timeout=10)
    events, cursor = _drain_all(way.client, cursor)
    assert [(e.type, e.name) for e in events] == [("ADDED", "post")]


def test_410_gone_triggers_relist(way):
    with way.server.lock:
        way.server.cluster.create(_cm("keeper"))
    way.client.start_watches(["ConfigMap"])
    events, cursor = _drain_all(way.client, 0)
    assert [e.name for e in events] == ["keeper"]
    way.client._watchers[0]._conn.close()
    with way.server.lock:
        way.server.cluster.create(_cm("during-outage"))
        way.server.cluster.compact_events(0)
    assert way.client.wait_for_events(cursor, timeout=10)
    events, cursor = _drain_all(way.client, cursor)
    assert sorted(e.name for e in events if e.type == "ADDED") == [
        "during-outage", "keeper"]


def test_compaction_past_an_open_stream_sends_410_in_band():
    """The port's server: a log compacted past a live watch ends the
    stream with an ERROR frame of code 410."""
    srv = PEv.EnvtestServer(max_event_log=0).start()
    try:
        with srv.lock:
            srv.cluster.create(_cm("a"))
        conn = srv.client_config().make_connection(timeout=10)
        conn.request("GET", PRest.collection_path("ConfigMap") + (
            PRest.list_query(watch=True, resource_version="0")))
        resp = conn.getresponse()
        assert resp.status == 200
        first = json.loads(resp.readline())
        assert (first["type"], first["object"]["metadata"]["name"]) == (
            "ADDED", "a")
        with srv.lock:
            srv.cluster.create(_cm("b"))
            srv.cluster.compact_events(0)
            srv.event_cond.notify_all()
        frames = [json.loads(x) for x in resp.read().splitlines() if x]
        assert frames == [{"type": "ERROR", "object": {
            "kind": "Status", "code": 410, "reason": "Expired",
            "message": "too old resource version"}}]
        conn.close()
    finally:
        srv.stop()


def test_watch_requests_carry_timeout_seconds():
    assert PR._Watcher.WATCH_TIMEOUT_SECONDS == JR._Watcher.WATCH_TIMEOUT_SECONDS
    assert (PR._Watcher.SOCKET_DEADLINE_SLACK,
            PR._Watcher.MAX_RESUME_FAILURES, PR._Watcher.RELIST_BACKOFF) == (
        JR._Watcher.SOCKET_DEADLINE_SLACK, JR._Watcher.MAX_RESUME_FAILURES,
        JR._Watcher.RELIST_BACKOFF)


def test_half_open_socket_bounded_by_read_deadline(monkeypatch):
    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(1)
    host, port = silent.getsockname()
    monkeypatch.setattr(PR._Watcher, "WATCH_TIMEOUT_SECONDS", 1)
    monkeypatch.setattr(PR._Watcher, "SOCKET_DEADLINE_SLACK", 0.5)
    client = PR.RealClient(PR.ClusterConfig(host=host, port=port,
                                            scheme="http"))
    watcher = PR._Watcher(client, "ConfigMap", "")
    t0 = time.monotonic()
    with pytest.raises(Exception):
        watcher._watch_from("1")
    assert time.monotonic() - t0 < 5
    client.stop()
    silent.close()


def test_apiserver_restart_recovers():
    srv = PEv.EnvtestServer().start()
    host, port, cluster = srv.host, srv.port, srv.cluster
    with srv.lock:
        cluster.create(_cm("existing"))
    client = PR.RealClient(srv.client_config())
    client.start_watches(["ConfigMap"])
    assert client.wait_for_events(0, timeout=5)
    _, cursor = client.drain_events(0)
    srv.stop()
    time.sleep(0.3)
    srv2 = PEv.EnvtestServer(cluster=cluster, host=host, port=port).start()
    try:
        with srv2.lock:
            cluster.create(_cm("after-restart"))
        assert client.wait_for_events(cursor, timeout=15)
        events, _ = client.drain_events(cursor)
        assert "after-restart" in [e.name for e in events]
    finally:
        client.stop()
        srv2.stop()


# -- the stated difference: no CRD schema ----------------------------------------


def test_the_port_server_stores_a_gpu_notebook_jaxs_refuses():
    nb = new_notebook("nb", "u", image="img",
                      tpu=TPUSpec(accelerator="v5e", topology="4x4"))
    del nb["spec"]["tpu"]
    nb["spec"]["gpu"] = {"accelerator": "h100", "topology": "8"}
    jsrv = JEv.EnvtestServer().start()
    try:
        client = PR.RealClient(jsrv.client_config())
        with pytest.raises(PE.InvalidError):
            client.create(nb)
        client.stop()
    finally:
        jsrv.stop()
    psrv = PEv.EnvtestServer().start()
    try:
        client = PR.RealClient(psrv.client_config())
        created = client.create(nb)
        assert created["spec"]["gpu"] == {"accelerator": "h100",
                                          "topology": "8"}
        client.stop()
    finally:
        psrv.stop()
    assert not hasattr(psrv, "schemas")


# -- configs ---------------------------------------------------------------------


def test_from_kubeconfig_http(tmp_path):
    srv = PEv.EnvtestServer().start()
    try:
        kubeconfig = tmp_path / "config"
        kubeconfig.write_text(f"""
apiVersion: v1
kind: Config
current-context: envtest
contexts:
- name: envtest
  context: {{cluster: envtest, user: dev, namespace: team-a}}
clusters:
- name: envtest
  cluster: {{server: "http://{srv.host}:{srv.port}"}}
users:
- name: dev
  user: {{token: ""}}
""")
        cfg = PR.ClusterConfig.from_kubeconfig(str(kubeconfig))
        assert (cfg.host, cfg.port, cfg.scheme, cfg.namespace) == (
            srv.host, srv.port, "http", "team-a")
        assert vars(cfg) == vars(JR.ClusterConfig.from_kubeconfig(
            str(kubeconfig)))
        c = PR.RealClient(cfg)
        c.create(_cm())
        assert c.exists("ConfigMap", "c1", "ns")
        c.stop()
        env = {"KUBECONFIG": str(kubeconfig), "HOME": str(tmp_path)}
        assert vars(PR.ClusterConfig.from_env(env)) == vars(cfg)
    finally:
        srv.stop()


def test_in_cluster_config_and_token_rotation(tmp_path):
    sa = tmp_path / "sa"
    sa.mkdir()
    (sa / "token").write_text("tok123")
    (sa / "namespace").write_text("kubeflow")
    env = {"KUBERNETES_SERVICE_HOST": "10.0.0.1"}
    cfg = PR.ClusterConfig.in_cluster(env=env, sa_dir=str(sa))
    assert vars(cfg) == vars(JR.ClusterConfig.in_cluster(env=env,
                                                         sa_dir=str(sa)))
    assert (cfg.host, cfg.port, cfg.namespace, cfg.bearer_token()) == (
        "10.0.0.1", 443, "kubeflow", "tok123")
    (sa / "token").write_text("rotated")
    assert cfg.bearer_token() == "rotated"
    with pytest.raises(PR.ConfigError):
        PR.ClusterConfig.in_cluster(env={}, sa_dir=str(sa))


def test_from_env_no_config_raises(tmp_path):
    with pytest.raises(PR.ConfigError):
        PR.ClusterConfig.from_env(env={"HOME": str(tmp_path)})
