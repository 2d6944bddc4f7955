"""The port's AdmissionReview server against the JAX package's, on the CPU.

- ``json_patch`` gives the same RFC 6902 ops as JAX's for the same pairs
  (seeded random documents, byte for byte), and ``apply_json_patch`` of
  them reproduces the new document on both sides;
- ``handle_admission_review`` of each side's own webhooks: the response
  bodies are byte-equal for a CPU notebook and equal after
  ``tests/torch_gpu_swap.swap`` of the JAX patch's values for a GPU
  one; a denial, a handler's exception (fail closed, 500) and a no-op
  update alike;
- the HTTP server on both paths, 404 elsewhere, 400 on a bad body and
  413 past ``MAX_ADMISSION_BODY_BYTES``, on both servers;
- the TLS listener with a self-signed cert made by the ``openssl`` CLI:
  no certs fail closed, the Modern profile refuses a TLS 1.2 client,
  the Intermediate profile's IANA names map to the same OpenSSL cipher
  list as JAX's, and ``poll_certs`` reloads a rotated cert.
"""

from __future__ import annotations

import base64
import copy
import http.client
import json
import os
import random
import socket
import ssl
import subprocess
import time

import pytest

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.controller import tls as JTls
from kubeflow_tpu.tpu import topology as JT
from kubeflow_tpu.webhook import server as JS
from kubeflow_tpu_torch.controller import tls as PTls
from kubeflow_tpu_torch.gpu import topology as PT
from kubeflow_tpu_torch.webhook import server as PS
from tests.torch_controller_env import JSHAPE, PSHAPE, make_side, notebook
from tests.torch_gpu_swap import swap

JTOPO, PTOPO = JT.slice_from_spec(*JSHAPE), PT.slice_from_spec(*PSHAPE)
RESOLVED = "/metadata/annotations/" + JA.TPU_RESOLVED_TOPOLOGY.replace(
    "~", "~0").replace("/", "~1")


def make_certs(cert_dir, cn="webhook.opendatahub.svc") -> str:
    """A self-signed serving cert by the openssl CLI; returns its path
    (the CA of a self-signed cert is the cert)."""
    cert = os.path.join(cert_dir, "tls.crt")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048",
         "-keyout", os.path.join(cert_dir, "tls.key"), "-out", cert,
         "-days", "1", "-nodes", "-subj", f"/CN={cn}",
         "-addext", "subjectAltName=IP:127.0.0.1,DNS:localhost"],
        check=True, capture_output=True)
    return cert


def _review(obj, operation="CREATE", old=None, uid="uid-1"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": operation, "object": obj,
                        "oldObject": old}}


def _sides():
    """A JAX and a port side with their webhooks (their clusters hold the
    ``default`` ServiceAccount and the node pool)."""
    return [make_side(jax, webhooks=True) for jax in (True, False)]


def _handlers(m):
    from kubeflow_tpu.webhook.validating import NotebookValidatingWebhook as J
    from kubeflow_tpu_torch.webhook.validating import (
        NotebookValidatingWebhook as P)

    return m.webhook.handle, (J if m.jax else P)(m.c).handle


def _ops(review):
    return json.loads(base64.b64decode(review["response"]["patch"]))


def _swapped_ops(ops):
    """The JAX patch's ops with ``swap`` applied to each op's value (the
    resolved-topology annotation is a plain string value there)."""
    out = []
    for op in ops:
        op = copy.deepcopy(op)
        if op["path"] == RESOLVED:
            op["value"] = f"{PTOPO.accelerator_type}/{PTOPO.topology_str}"
        elif "value" in op:
            op["value"] = swap({"v": op["value"]}, JTOPO, PTOPO)["v"]
        out.append(op)
    return out


# -- json_patch ------------------------------------------------------------------


def _random_doc(rng, depth=0):
    kind = rng.randrange(6 if depth < 3 else 3)
    if kind == 0:
        return rng.choice([None, True, 0, 1.5, "a", "b/c", "~d"])
    if kind == 1:
        return rng.randrange(4)
    if kind == 2:
        return rng.choice(["x", "y", ""])
    if kind in (3, 4):
        keys = rng.sample(["a", "b", "c/d", "e~f", "g"], rng.randrange(4))
        return {k: _random_doc(rng, depth + 1) for k in keys}
    return [_random_doc(rng, depth + 1) for _ in range(rng.randrange(4))]


def _mutate(rng, doc):
    if isinstance(doc, dict) and doc and rng.random() < 0.8:
        doc = dict(doc)
        key = rng.choice(sorted(doc))
        roll = rng.random()
        if roll < 0.3:
            del doc[key]
        elif roll < 0.5:
            doc["new/" + key] = _random_doc(rng, 2)
        else:
            doc[key] = _mutate(rng, doc[key])
        return doc
    if isinstance(doc, list) and rng.random() < 0.8:
        doc = list(doc)
        roll = rng.random()
        if roll < 0.3 and doc:
            doc.pop(rng.randrange(len(doc)))
        elif roll < 0.6:
            doc.append(_random_doc(rng, 2))
        elif doc:
            i = rng.randrange(len(doc))
            doc[i] = _mutate(rng, doc[i])
        return doc
    return _random_doc(rng, 1)


@pytest.mark.parametrize("seed", range(4))
def test_json_patch_ops_equal_jaxs(seed):
    rng = random.Random(seed)
    for _ in range(100):
        old = {"root": _random_doc(rng)}
        new = _mutate(rng, copy.deepcopy(old))
        ops = PS.json_patch(old, new)
        assert json.dumps(ops) == json.dumps(JS.json_patch(old, new))
        assert PS.apply_json_patch(old, ops) == new
        assert JS.apply_json_patch(old, ops) == new
    assert PS.json_patch({"a": 1}, {"a": 1}) == []
    assert PS.apply_json_patch({"a": 1}, [
        {"op": "replace", "path": "", "value": [2]}]) == [2]


# -- AdmissionReview -------------------------------------------------------------


@pytest.mark.parametrize("annotations", [
    {}, {JA.INJECT_AUTH: "true"}, {JA.TPU_QUANTIZATION: "int8"}])
def test_cpu_notebook_review_bodies_are_byte_equal(annotations):
    bodies = []
    for m in _sides():
        mutate, validate = _handlers(m)
        obj = notebook(m, device=False, annotations=annotations)
        mod = JS if m.jax else PS
        bodies.append([
            json.dumps(mod.handle_admission_review(_review(obj), mutate, None)),
            json.dumps(mod.handle_admission_review(_review(obj), None,
                                                   validate))])
    assert bodies[1] == bodies[0]
    patch = _ops(json.loads(bodies[1][0]))
    assert all(op["path"] != "" for op in patch)


def test_gpu_notebook_review_equals_jaxs_after_the_swap():
    out = []
    for m in _sides():
        mutate, _ = _handlers(m)
        obj = notebook(m, annotations={JA.TPU_CHECKPOINT_GRACE: "120"})
        review = (JS if m.jax else PS).handle_admission_review(
            _review(obj), mutate, None)
        ops = _ops(review)
        patched = (JS if m.jax else PS).apply_json_patch(obj, ops)
        assert patched["metadata"]["annotations"][JA.STOP] == (
            JA.RECONCILIATION_LOCK_VALUE)
        out.append((review, ops))
    (jreview, jops), (preview, pops) = out
    assert pops == _swapped_ops(jops)
    rest = {k: v for k, v in preview["response"].items() if k != "patch"}
    assert rest == {k: v for k, v in jreview["response"].items()
                    if k != "patch"}
    assert {"uid": "uid-1", "allowed": True, "patchType": "JSONPatch"} == rest


def test_denial_and_failure_responses_are_byte_equal():
    bodies = []
    for m in _sides():
        mod = JS if m.jax else PS
        mutate, validate = _handlers(m)
        old = notebook(m)
        old["status"] = {"readyReplicas": 4}
        new = copy.deepcopy(old)
        new["metadata"].setdefault("annotations", {})[
            JA.TPU_PROFILING_PORT] = "80"

        def broken(req):
            raise RuntimeError("boom")

        bodies.append([json.dumps(mod.handle_admission_review(
            _review(new, "UPDATE", old), None, validate)),
            json.dumps(mod.handle_admission_review(
                _review(new), broken, None))])
    assert bodies[1] == bodies[0]
    denied, failed = (json.loads(b)["response"] for b in bodies[1])
    assert not denied["allowed"] and denied["status"]["code"] == 403
    assert failed == {"uid": "uid-1", "allowed": False,
                      "status": {"code": 500, "message": "webhook error: boom"}}


def test_running_topology_change_denied_in_review():
    texts = []
    for m in _sides():
        mod = JS if m.jax else PS
        _, validate = _handlers(m)
        old = notebook(m)
        new = copy.deepcopy(old)
        new["spec"][m.key]["topology"] = "2x4" if m.jax else "16"
        resp = mod.handle_admission_review(
            _review(new, "UPDATE", old), None, validate)["response"]
        assert not resp["allowed"] and resp["status"]["code"] == 403
        texts.append(resp["status"]["message"])
    assert texts[1].startswith("spec.gpu cannot change while the notebook "
                               "is running")
    assert texts[0].startswith("spec.tpu cannot change")


def test_noop_mutation_returns_no_patch():
    for m in _sides():
        mod = JS if m.jax else PS
        mutate, _ = _handlers(m)
        obj = notebook(m)
        first = mod.handle_admission_review(_review(obj), mutate, None)
        mutated = mod.apply_json_patch(obj, _ops(first))
        second = mod.handle_admission_review(
            _review(mutated, "UPDATE", mutated), mutate, None)
        assert "patch" not in second["response"], second["response"]


# -- the HTTP server -------------------------------------------------------------


def _post(port, path, body: bytes, headers=None, tls=None):
    conn = (http.client.HTTPSConnection("127.0.0.1", port, context=tls,
                                        timeout=10) if tls else
            http.client.HTTPConnection("127.0.0.1", port, timeout=10))
    try:
        conn.request("POST", path, body=body, headers=headers or {
            "Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_round_trip_both_paths_equals_jaxs():
    got = []
    for m in _sides():
        mod = JS if m.jax else PS
        mutate, validate = _handlers(m)
        server = mod.WebhookServer(mutate, validate)
        server.start()
        try:
            assert not server.tls_enabled and server.cert_reloads == 0
            assert not server.poll_certs()
            body = json.dumps(_review(notebook(m, device=False))).encode()
            got.append([
                _post(server.port, mod.MUTATE_PATH, body),
                _post(server.port, mod.VALIDATE_PATH, body),
                _post(server.port, "/nope", body)[0],
                _post(server.port, mod.MUTATE_PATH, b"{not json")[0],
                _post(server.port, mod.MUTATE_PATH, b"", {
                    "Content-Length": str(mod.MAX_ADMISSION_BODY_BYTES + 1)
                })[0],
            ])
        finally:
            server.stop()
    assert got[1] == got[0]
    (mcode, mbody), (vcode, vbody), nope, bad, big = got[1]
    assert (mcode, vcode, nope, bad, big) == (200, 200, 404, 400, 413)
    assert json.loads(mbody)["response"]["patch"]
    assert json.loads(vbody)["response"]["allowed"]
    assert (PS.MUTATE_PATH, PS.VALIDATE_PATH, PS.MAX_ADMISSION_BODY_BYTES) == (
        JS.MUTATE_PATH, JS.VALIDATE_PATH, JS.MAX_ADMISSION_BODY_BYTES)


# -- TLS -------------------------------------------------------------------------


def test_server_fails_closed_without_certs(tmp_path):
    with pytest.raises(PS.CertError, match="serving certs not found"):
        PS.WebhookServer(cert_dir=str(tmp_path))
    (tmp_path / "tls.crt").write_text("garbage")
    (tmp_path / "tls.key").write_text("garbage")
    with pytest.raises(PS.CertError, match="cannot load serving certs"):
        PS.make_ssl_context(str(tmp_path))


def test_profile_ciphers_equal_jaxs(tmp_path):
    make_certs(str(tmp_path))
    assert PS._IANA_TO_OPENSSL == JS._IANA_TO_OPENSSL
    for jprof, pprof in ((JTls.INTERMEDIATE, PTls.INTERMEDIATE),
                         (JTls.MODERN, PTls.MODERN), (None, None)):
        jctx = JS.make_ssl_context(str(tmp_path), jprof)
        pctx = PS.make_ssl_context(str(tmp_path), pprof)
        assert pctx.minimum_version == jctx.minimum_version
        assert [c["name"] for c in pctx.get_ciphers()] == [
            c["name"] for c in jctx.get_ciphers()]


def _client(maximum=None):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    if maximum is not None:
        ctx.maximum_version = maximum
    return ctx


def test_tls_listener_applies_the_profile_and_reloads(tmp_path):
    make_certs(str(tmp_path), cn="first")
    m = make_side(False, webhooks=True)
    mutate, validate = _handlers(m)
    server = PS.WebhookServer(mutate, validate, cert_dir=str(tmp_path),
                              tls_profile=PTls.MODERN)
    server.start()
    try:
        assert server.tls_enabled
        with pytest.raises(ssl.SSLError):
            with socket.create_connection(("127.0.0.1", server.port), 5) as s:
                with _client(ssl.TLSVersion.TLSv1_2).wrap_socket(s):
                    pass
        with socket.create_connection(("127.0.0.1", server.port), 5) as s:
            with _client().wrap_socket(s) as conn:
                assert conn.version() == "TLSv1.3"
        body = json.dumps(_review(notebook(m))).encode()
        code, out = _post(server.port, PS.MUTATE_PATH, body, tls=_client())
        assert code == 200 and json.loads(out)["response"]["allowed"]
        # A rotated cert: the next handshake sees the new one.
        assert not server.poll_certs()
        time.sleep(0.05)
        ca = make_certs(str(tmp_path), cn="second")
        assert server.poll_certs() and server.cert_reloads == 1
        verify = ssl.create_default_context(cafile=ca)
        verify.check_hostname = False
        code, _ = _post(server.port, PS.VALIDATE_PATH, body, tls=verify)
        assert code == 200
    finally:
        server.stop()
