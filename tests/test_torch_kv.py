"""KV handoff and the peer chain across the two frameworks.

The port's ``PagedBatcher.export_blocks``/``import_blocks`` and
``export_chain``/``import_chain`` speak the JAX package's version-1 wire
format, so a payload cut by one framework is decoded by the other. On
f32 ``tiny-gqa`` (``kv_bits`` 0 and 8):

- chain keys equal the digests pinned in tests/test_kv_handoff.py;
- the JAX engine exports, the port imports and decodes, and the result
  equals the JAX engine's own fused run (tokens equal, logprobs within
  1e-4); the other way round too; on the alternating and the ragged port
  engine;
- both engines' exports of one prompt agree exactly in every envelope
  field and in each block's key; their data within 1e-5 (int8: values
  within one step, scales within one bf16 step);
- a payload imported and exported again before any step comes back byte
  for byte (on bf16 ``tiny`` too, through the 16-bit view);
- suffix-only transfer, a full pool or no free slot, JAX's validation
  errors (same exception types and texts), the swap tier under a stub;
- the peer chain's primitives, and chains registering across frameworks;
- over HTTP: a JAX server's ``/kv/prefill`` payload streamed by a port
  server through ``kv_import`` equals the JAX server's fused stream, and
  the other way round; the port's ``/kv/probe``, ``/kv/chain``,
  ``/kv/chain/import`` and ``/stats`` blocks answer as JAX's do, status
  codes included.
"""

from __future__ import annotations

import base64
import copy
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import paged as JP
from kubeflow_tpu.models import server as JS
from kubeflow_tpu.models.gateway import chain_key, prompt_chain_keys
from kubeflow_tpu.models.serving import GenerationConfig as JGen
from kubeflow_tpu_torch.models import paged as TP
from kubeflow_tpu_torch.models import server as TS
from kubeflow_tpu_torch.models.serving import GenerationConfig as TGen
from tests.test_torch_paged import _models
from tests.torch_kv_race import wait_for_pool_writes

BS = 8
PROMPT = [5, 9, 17, 33, 2, 11, 44, 3, 8, 21]  # 10 tokens: 2 blocks
LONG = list(range(1, 21))  # 20 tokens: 2 registrable blocks
TIMEOUT = 60


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _jax_steps_wait_for_pool_writes(monkeypatch):
    """The reference engine's step races its own pool writes
    (tests/torch_kv_race.py): each waits for them first."""
    wait_for_pool_writes(monkeypatch)


@pytest.fixture(scope="module")
def f32_gqa():
    return _models("tiny-gqa", "f32")


@pytest.fixture(scope="module")
def bf16_tiny():
    return _models("tiny", "bf16")


def _jax(models, kv_bits=0, max_new=8, prefix_cache=True, **kw):
    jcfg, _, jparams, _ = models
    kw = {"slots": 2, "num_blocks": 16, "prompt_bucket": 32, **kw}
    return JP.PagedBatcher(
        jparams, jcfg, gen=JGen(max_new_tokens=max_new, eos_id=-1),
        block_size=BS, prefix_cache=prefix_cache, kv_bits=kv_bits,
        attn_kernel=False, **kw)


def _port(models, kv_bits=0, max_new=8, prefix_cache=True, **kw):
    _, tcfg, _, tparams = models
    kw = {"slots": 2, "num_blocks": 16, "prompt_bucket": 32, **kw}
    return TP.PagedBatcher(
        tparams, tcfg, gen=TGen(max_new_tokens=max_new, eos_id=-1),
        block_size=BS, prefix_cache=prefix_cache, kv_bits=kv_bits,
        device="cpu", **kw)


ENGINES = {"jax": _jax, "port": _port}


def _prefill_payload(engine, prompt, skip_keys=()):
    """Serve ``prompt`` as a prefill-tier request (max_new_tokens=1) and
    export at its first token, where the server's on_token hook does."""
    out = {}
    engine.on_token = lambda rid, tok: out.setdefault(
        rid, engine.export_blocks(rid, skip_keys=skip_keys))
    rid = engine.submit(prompt, max_new_tokens=1)
    engine.run()
    engine.on_token = None
    return out[rid]


def _fused(engine, prompt, max_new=8):
    rid = engine.submit(prompt, max_new_tokens=max_new)
    out = engine.run()[rid]
    return out, engine.run_logprobs()[rid]


def _decode_import(engine, payload, max_new=8):
    rid = engine.import_blocks(payload, max_new_tokens=max_new)
    assert rid is not None
    out = engine.run()[rid]
    return out, engine.run_logprobs()[rid]


def _rows(payload, j, name, dtype):
    return np.frombuffer(base64.b64decode(payload["blocks"][j]["data"][name]),
                         dtype=dtype)


def _envelope(payload):
    """Every field but the block data: the part two frameworks' exports
    of one prompt agree on exactly."""
    env = {k: v for k, v in payload.items()
           if k not in ("blocks", "pending_logprob")}
    env["keys"] = [b["key"] for b in payload["blocks"]]
    env["shipped"] = ["data" in b for b in payload["blocks"]]
    return env


def test_chain_keys_equal_the_pinned_digests():
    prompt = list(range(1, 20))
    k0 = TP.PagedBatcher._chain_key(None, prompt[:BS])
    k1 = TP.PagedBatcher._chain_key(k0, prompt[BS:2 * BS])
    assert [k0.hex(), k1.hex()] == [
        "11e25c6a60ac62686eb6e65c3ae15d0c19e1a458",
        "5cad69e653e820a10b9e816d2cdd6a92f1069b42",
    ]
    assert [k0, k1] == prompt_chain_keys(prompt, BS)
    for adapter in (None, 3):
        assert (TP.PagedBatcher._chain_key(None, prompt[:BS], adapter)
                == JP.PagedBatcher._chain_key(None, prompt[:BS], adapter)
                == chain_key(None, prompt[:BS], adapter))


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("exporter,importer,ragged", [
    ("jax", "port", False), ("jax", "port", True), ("port", "jax", False),
])
def test_handoff_across_frameworks(f32_gqa, kv_bits, exporter, importer,
                                   ragged):
    """One framework's prefill payload, decoded by the other framework's
    engine (the port's ragged one too), equals the exporting framework's
    own fused run."""
    payload = _prefill_payload(ENGINES[exporter](f32_gqa, kv_bits), LONG)
    assert payload["kv_bits"] == kv_bits
    kw = {"ragged": True, "prefix_cache": False} if ragged else {}
    dec = ENGINES[importer](f32_gqa, kv_bits, **kw)
    got, got_lp = _decode_import(dec, payload)
    want, want_lp = _fused(ENGINES[exporter](f32_gqa, kv_bits), LONG)
    assert got == want and len(got) == 8
    np.testing.assert_allclose(got_lp, want_lp, atol=1e-4)
    assert dec.kv_imports == 1
    assert dec.kv_import_blocks_written == 3


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_exports_of_one_prompt_agree(f32_gqa, kv_bits):
    jpay = _prefill_payload(_jax(f32_gqa, kv_bits), LONG)
    tpay = _prefill_payload(_port(f32_gqa, kv_bits), LONG)
    assert _envelope(tpay) == _envelope(jpay)
    assert tpay["leaves"] == jpay["leaves"]
    assert tpay["pending_logprob"] == pytest.approx(jpay["pending_logprob"],
                                                    abs=1e-4)
    for j in range(len(jpay["blocks"])):
        if kv_bits == 0:
            for name in ("k", "v"):
                np.testing.assert_allclose(
                    _rows(tpay, j, name, np.float32),
                    _rows(jpay, j, name, np.float32), atol=1e-5)
            continue
        for name in ("k", "v"):
            diff = (_rows(tpay, j, name, np.int8).astype(int)
                    - _rows(jpay, j, name, np.int8).astype(int))
            assert np.abs(diff).max() <= 1, (j, name)
        for name in ("k_scale", "v_scale"):
            t = torch.from_numpy(_rows(tpay, j, name, np.int16).copy())
            r = torch.from_numpy(_rows(jpay, j, name, np.int16).copy())
            t, r = t.view(torch.bfloat16).float(), r.view(torch.bfloat16).float()
            # One bf16 step of the scale at most.
            assert torch.all((t - r).abs() <= r.abs() * 2.0 ** -7 + 1e-5)


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_import_then_export_round_trips(f32_gqa, kv_bits, first, second):
    """``first``'s payload imported by ``second`` and exported again once
    its pending token is delivered, before any step, is the same payload
    byte for byte."""
    payload = _prefill_payload(ENGINES[first](f32_gqa, kv_bits), LONG)
    dec = ENGINES[second](f32_gqa, kv_bits)
    rid = dec.import_blocks(copy.deepcopy(payload), max_new_tokens=8)
    dec._deliver_imported()
    assert dec.export_blocks(rid) == payload


def test_bf16_payload_round_trips_and_decodes(bf16_tiny):
    """bf16 pools ship through a 16-bit view: JAX's bytes land in the
    port's pool and come back equal. The port decodes the pinned prompt
    from them; bf16 rounds at other places in the two frameworks, and a
    near-tie forks this prompt from JAX's fused tokens after 6 tokens, so
    (as in tests/test_torch_paged.py) every port token must be within 0.02
    of the argmax of JAX ``forward`` on the port's own sequence."""
    payload = _prefill_payload(_jax(bf16_tiny), PROMPT)
    assert {s["dtype"] for s in payload["leaves"].values()} == {"bfloat16"}
    dec = _port(bf16_tiny)
    rid = dec.import_blocks(copy.deepcopy(payload), max_new_tokens=8)
    slot = next(i for i, r in enumerate(dec._by_slot)
                if r is not None and r.rid == rid)
    for j, ent in enumerate(payload["blocks"]):
        for name, b64 in ent["data"].items():
            rows = dec.pool[name][:, dec._by_slot[slot].blocks[j]]
            assert (rows.contiguous().view(torch.int16).numpy().tobytes()
                    == base64.b64decode(b64))
    dec._deliver_imported()
    assert dec.export_blocks(rid) == payload
    got = dec.run()[rid]
    want = _fused(_jax(bf16_tiny), PROMPT)[0]
    assert got[:6] == want[:6] and len(got) == 8
    jcfg, _, jparams, _ = bf16_tiny
    logits = L.forward(jparams, jcfg, jnp.asarray([PROMPT + got]))[0]
    for i, tok in enumerate(got):
        row = logits[len(PROMPT) - 1 + i]
        gap = float(row.max() - row[tok])
        assert gap < 0.02, f"token {i} ({tok}) off the greedy path by {gap}"
    tpay = _prefill_payload(_port(bf16_tiny), PROMPT)
    assert _envelope(tpay) == _envelope(payload)


@pytest.mark.parametrize("exporter,importer", [("jax", "port"),
                                               ("port", "jax")])
def test_suffix_only_transfer(f32_gqa, exporter, importer):
    """A decode replica that holds the prefix chain gets stubs for it and
    reuses its cached blocks, token-exact against a fused run."""
    skip = [k.hex() for k in prompt_chain_keys(PROMPT, BS)]
    dec = ENGINES[importer](f32_gqa)
    _fused(dec, PROMPT)  # warms the decode side's chain
    payload = _prefill_payload(ENGINES[exporter](f32_gqa), PROMPT,
                               skip_keys=skip)
    assert ["data" not in e for e in payload["blocks"]] == [True, False]
    got, _ = _decode_import(dec, payload)
    assert (dec.kv_import_blocks_reused, dec.kv_import_blocks_written) == \
        (1, 1)
    assert got == _fused(ENGINES[exporter](f32_gqa), PROMPT)[0]


def test_import_returns_none_without_a_slot_or_blocks(f32_gqa):
    payload = _prefill_payload(_jax(f32_gqa), PROMPT)
    results = []
    for make in (_jax, _port):
        busy = make(f32_gqa, slots=1, max_new=32)
        busy.submit([1, 2, 3])
        busy.drive_once()
        small = make(f32_gqa, num_blocks=2)
        results.append((busy.import_blocks(payload, max_new_tokens=4),
                        small.import_blocks(payload, max_new_tokens=4),
                        small.free_blocks, busy._next_rid))
    assert results[1] == results[0] == (None, None, 1, 2)


def test_import_never_takes_a_slot_mid_ragged_admission(f32_gqa):
    """A ragged engine's only slot, mid-prefill of its admission, is not
    free for an import, on either framework."""
    payload = _prefill_payload(_jax(f32_gqa), PROMPT)
    results = []
    for make in (_jax, _port):
        eng = make(f32_gqa, slots=1, ragged=True, prefix_cache=False,
                   token_budget=4)
        eng.submit(LONG)
        eng.drive_once()  # 20 prompt tokens at 4 rows a step
        assert eng._ragged_admit and eng._by_slot == [None]
        results.append(eng.import_blocks(payload, max_new_tokens=4))
    assert results == [None, None]


def _validation_cases(payload):
    tampered = json.loads(json.dumps(payload))
    tampered["blocks"][0]["key"] = "00" * 20
    stub = json.loads(json.dumps(payload))
    del stub["blocks"][0]["data"]
    short = json.loads(json.dumps(payload))
    del short["blocks"][-1]
    return [{**payload, "version": 2}, {**payload, "block_size": 16},
            {**payload, "kv_bits": 8}, tampered, stub, short,
            {**payload, "leaves": {"k": payload["leaves"]["k"]}},
            {**payload, "adapter": "x"}]


def test_import_validation_is_jax_s(f32_gqa):
    """Each of JAX's validation errors: the same exception type and text
    from the port."""
    payload = _prefill_payload(_jax(f32_gqa), PROMPT)
    for bad in _validation_cases(payload):
        with pytest.raises((ValueError, KeyError)) as jerr:
            _jax(f32_gqa).import_blocks(bad)
        with pytest.raises((ValueError, KeyError)) as terr:
            _port(f32_gqa).import_blocks(bad)
        assert type(terr.value) is type(jerr.value)
        assert str(terr.value) == str(jerr.value)


def test_export_requires_prefix_cache_and_a_live_slot(f32_gqa):
    for make in (_jax, _port):
        plain = make(f32_gqa, prefix_cache=False)
        rid = plain.submit(PROMPT, max_new_tokens=1)
        plain.run()
        with pytest.raises(RuntimeError, match="prefix_cache"):
            plain.export_blocks(rid)
        cached = make(f32_gqa)
        rid = cached.submit(PROMPT, max_new_tokens=1)
        cached.run()
        with pytest.raises(KeyError, match="holds no slot"):
            cached.export_blocks(rid)


def test_import_promotes_a_swap_resident_stub(f32_gqa):
    skip = [k.hex() for k in prompt_chain_keys(PROMPT, BS)]
    dec = _port(f32_gqa, swap_bytes=1 << 22)
    _fused(dec, PROMPT)
    while dec._evict_prefix_leaf():
        pass
    (key,) = prompt_chain_keys(PROMPT, BS)
    assert dec.swap_contains(key) and not dec._prefix_entries
    payload = _prefill_payload(_jax(f32_gqa), PROMPT, skip_keys=skip)
    got, _ = _decode_import(dec, payload)
    assert dec.kv_swap_in == 1 and not dec.swap_contains(key)
    assert dec.kv_import_blocks_reused == 1
    assert got == _fused(_jax(f32_gqa), PROMPT)[0]
    empty = _port(f32_gqa, swap_bytes=1 << 22)
    with pytest.raises(KeyError, match="stub"):
        empty.import_blocks(payload)


# -- the peer chain -----------------------------------------------------------


def _warm(engine, prompt):
    engine.submit(prompt, max_new_tokens=1)
    engine.run()
    return engine


class TestChainPrimitives:
    def test_roundtrip_registers_and_hits(self, f32_gqa):
        keys = prompt_chain_keys(LONG, BS)
        a = _warm(_port(f32_gqa), LONG)
        payload = a.export_chain(keys)
        assert a.kv_chain_exports == 1 and a.kv_chain_blocks_sent == 2
        assert all("data" in e for e in payload["blocks"])
        b = _port(f32_gqa)
        assert b.import_chain(payload, LONG) == 2
        assert (b.kv_chain_imports, b.kv_chain_blocks_written) == (1, 2)
        got = _fused(b, LONG, 6)[0]
        assert b.prefix_hits == 2
        assert got == _fused(_port(f32_gqa), LONG, 6)[0]

    def test_export_partial_and_empty(self, f32_gqa):
        keys = prompt_chain_keys(LONG, BS)
        a = _warm(_port(f32_gqa), LONG)
        assert len(a.export_chain([keys[0], b"\x00" * 20])["blocks"]) == 1
        assert a.export_chain([b"\x00" * 20]) is None
        assert _port(f32_gqa).export_chain(keys) is None

    def test_import_validates(self, f32_gqa):
        payload = _warm(_jax(f32_gqa), LONG).export_chain(
            prompt_chain_keys(LONG, BS))
        tampered = json.loads(json.dumps(payload))
        tampered["blocks"][0]["key"] = "00" * 20
        stub = json.loads(json.dumps(payload))
        del stub["blocks"][1]["data"]
        for bad, tokens in (({**payload, "version": 2}, LONG),
                            ({**payload, "block_size": 16}, LONG),
                            ({**payload, "kv_bits": 8}, LONG),
                            (tampered, LONG), (stub, LONG),
                            (payload, LONG[:9])):
            with pytest.raises(ValueError) as jerr:
                _jax(f32_gqa).import_chain(bad, tokens)
            b = _port(f32_gqa)
            with pytest.raises(ValueError) as terr:
                b.import_chain(bad, tokens)
            assert str(terr.value) == str(jerr.value)
            assert b.kv_chain_imports == 0

    def test_requires_prefix_cache(self, f32_gqa):
        plain = _port(f32_gqa, prefix_cache=False)
        with pytest.raises(RuntimeError, match="prefix_cache"):
            plain.export_chain([b"\x00" * 20])
        with pytest.raises(ValueError, match="prefix_cache"):
            plain.import_chain({"version": 1}, list(range(20)))

    @pytest.mark.parametrize("kv_bits", [0, 8])
    @pytest.mark.parametrize("exporter,importer", [("jax", "port"),
                                                   ("port", "jax")])
    def test_chain_registers_across_frameworks(self, f32_gqa, kv_bits,
                                               exporter, importer):
        keys = prompt_chain_keys(LONG, BS)
        payload = _warm(ENGINES[exporter](f32_gqa, kv_bits),
                        LONG).export_chain(keys)
        b = ENGINES[importer](f32_gqa, kv_bits)
        assert b.import_chain(payload, LONG) == 2
        got = _fused(b, LONG, 6)
        assert b.prefix_hits == 2
        want = _fused(ENGINES[exporter](f32_gqa, kv_bits), LONG, 6)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], atol=1e-4)
        # Both exporters' chains agree but for the data's last bits.
        other = _warm(ENGINES[importer](f32_gqa, kv_bits),
                      LONG).export_chain(keys)
        assert _envelope(other) == _envelope(payload)


# -- HTTP ---------------------------------------------------------------------


def _request(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _stream(port, body):
    code, raw = _request(port, "/v1/completions", {**body, "stream": True})
    assert code == 200, raw
    events = [ln[6:] for ln in raw.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    out = [json.loads(e) for e in events[:-1]]
    assert all("token" in e for e in out), out
    return [e["token"] for e in out]


SERVERS = {
    "jax": lambda engine, **kw: JS.InferenceServer(
        engine, port=0, **{"drain_s": 0.5, **kw}),
    "port": lambda engine, **kw: TS.InferenceServer(
        engine, port=0, **{"drain_s": 0.5, **kw}),
}


@pytest.mark.parametrize("prefill,decode", [("jax", "port"),
                                            ("port", "jax")])
def test_disaggregated_handoff_over_http(f32_gqa, prefill, decode):
    """The prefill tier's ``/kv/prefill`` payload, streamed by the other
    framework's server through ``kv_import``, equals the prefill
    framework's fused stream."""
    p_srv = SERVERS[prefill](ENGINES[prefill](f32_gqa),
                             tier_role="prefill").start()
    d_srv = SERVERS[decode](ENGINES[decode](f32_gqa),
                            tier_role="decode").start()
    f_srv = SERVERS[prefill](ENGINES[prefill](f32_gqa)).start()
    try:
        code, raw = _request(p_srv.port, "/kv/prefill", {"prompt": LONG})
        assert code == 200, raw
        hop = json.loads(raw)
        assert hop["finished"]["finish_reason"] == "length"
        assert hop["finished"]["tokens"] == [hop["payload"]["pending_token"]]
        got = _stream(d_srv.port, {"kv_import": hop["payload"],
                                   "max_tokens": 6})
        assert got == _stream(f_srv.port, {"prompt": LONG, "max_tokens": 6})
        assert len(got) == 6
        for srv, role in ((p_srv, "prefill"), (d_srv, "decode")):
            stats = json.loads(_request(srv.port, "/stats")[1])
            assert stats["tier_role"] == role
        d_stats = json.loads(_request(d_srv.port, "/stats")[1])
        assert d_stats["kv_handoff"]["imports"] == 1
    finally:
        for srv in (p_srv, d_srv, f_srv):
            srv.stop()


def _kv_surface(port, payload):
    """The same requests against one server: (status, body) of each, and
    its /stats blocks."""
    keys = [k.hex() for k in prompt_chain_keys(LONG, BS)]
    out = [_request(port, "/v1/completions",
                    {"prompt": LONG, "max_tokens": 2})[0]]
    for path, body in (
            ("/kv/probe", {"keys": keys + ["00" * 20]}),
            ("/kv/probe", {"keys": "nope"}),
            ("/kv/probe", {"keys": ["zz"]}),
            ("/kv/chain", {"keys": keys}),
            ("/kv/chain", {"keys": []}),
            ("/kv/chain", {"keys": [1]}),
            ("/kv/chain/import", {"tokens": LONG, "payload": payload}),
            ("/kv/chain/import", {"tokens": [], "payload": payload}),
            ("/kv/chain/import", {"tokens": LONG[:9], "payload": payload}),
            ("/kv/chain/import", {"tokens": LONG, "payload": None}),
            ("/kv/prefill", {"prompt": LONG, "skip_keys": "x"}),
            ("/v1/completions", {"kv_import": [1]}),
            ("/v1/completions", {"kv_import": {**payload, "version": 9}}),
            ("/kv/nowhere", {})):
        code, raw = _request(port, path, body)
        reply = json.loads(raw)
        if path == "/kv/chain" and code == 200 and reply["payload"]:
            reply["payload"] = _envelope(reply["payload"])
        out.append((path, code, sorted(reply) if code != 200 else reply))
    stats = json.loads(_request(port, "/stats")[1])
    return out, {k: stats.get(k) for k in ("tier_role", "prefix_cache",
                                           "kv_swap", "kv_handoff")}


def test_kv_surface_answers_as_jax_s(f32_gqa):
    payload = _warm(_jax(f32_gqa), LONG).export_chain(
        prompt_chain_keys(LONG, BS))
    seen = {}
    for name in ("jax", "port"):
        srv = SERVERS[name](ENGINES[name](f32_gqa, swap_bytes=1 << 22),
                            tier_role="prefill").start()
        try:
            seen[name] = _kv_surface(srv.port, payload)
        finally:
            srv.stop()
    assert seen["port"][0] == seen["jax"][0]
    assert seen["port"][1] == seen["jax"][1]
    assert seen["port"][1]["prefix_cache"]["misses"] == 2
    assert seen["port"][1]["kv_swap"]["swap_bytes_limit"] == 1 << 22
    assert seen["port"][1]["kv_handoff"]["chain_exports"] == 1


def test_oversized_kv_body_is_413(f32_gqa):
    """A KV payload past the cap is refused with 413 on both routes that
    take one. JAX's server has one cap, ``max_body_bytes``; the port caps
    KV payloads by ``max_kv_body_bytes``."""
    payload = _prefill_payload(_jax(f32_gqa), LONG)
    size = len(json.dumps({"kv_import": payload}))
    cap = {"jax": "max_body_bytes", "port": "max_kv_body_bytes"}
    codes = []
    for name in ("jax", "port"):
        srv = SERVERS[name](ENGINES[name](f32_gqa),
                            **{cap[name]: size // 2}).start()
        try:
            codes.append([_request(srv.port, path, body)[0]
                          for path, body in (
                              ("/v1/completions", {"kv_import": payload}),
                              ("/kv/chain/import",
                               {"tokens": LONG, "payload": payload}))])
        finally:
            srv.stop()
    assert codes[1] == codes[0] == [413, 413]


def test_a_kv_payload_has_its_own_body_cap(f32_gqa):
    """The port's plain cap (``max_body_bytes``) does not bound a KV
    payload: a decode-tier replica admits what the gateway sends, up to
    ``max_kv_body_bytes`` (the gateway's transfer ceiling by default),
    and decodes it as a fused server does. A body of the same size with
    no payload is still refused with 413, as is a payload past its cap."""
    payload = _prefill_payload(_port(f32_gqa), LONG)
    body = {"kv_import": payload, "max_tokens": 4}
    size = len(json.dumps(body))
    srv = SERVERS["port"](_port(f32_gqa), max_body_bytes=size // 2).start()
    assert srv.max_kv_body_bytes == TS.KV_TRANSFER_MAX_BYTES == 64 << 20
    fused = SERVERS["port"](_port(f32_gqa)).start()
    tight = SERVERS["port"](_port(f32_gqa), max_body_bytes=size // 2,
                            max_kv_body_bytes=size - 1).start()
    try:
        code, raw = _request(srv.port, "/v1/completions", body)
        assert code == 200, raw
        got = json.loads(raw)["choices"][0]["tokens"]
        want = json.loads(_request(fused.port, "/v1/completions",
                                   {"prompt": LONG, "max_tokens": 4})[1])
        assert got == want["choices"][0]["tokens"]
        chain = _warm(_port(f32_gqa), LONG).export_chain(
            prompt_chain_keys(LONG, BS))
        chain_body = {"tokens": LONG, "payload": chain}
        assert len(json.dumps(chain_body)) > size // 2
        code, raw = _request(srv.port, "/kv/chain/import", chain_body)
        assert code == 200, raw
        padding = {"prompt": LONG, "max_tokens": 4, "pad": "x" * size}
        assert _request(srv.port, "/v1/completions", padding)[0] == 413
        assert _request(tight.port, "/v1/completions", body)[0] == 413
    finally:
        for s in (srv, fused, tight):
            s.stop()


def _status_codes(name, models, payload, stub):
    """409, 429 and 503 from one server whose engine this test drives
    itself (only the HTTP thread runs)."""
    engine = ENGINES[name](models, slots=1, max_new=32)
    srv = SERVERS[name](engine, drain_s=0.0)
    srv._http_thread.start()
    try:
        codes = [_request(srv.port, "/v1/completions",
                          {"kv_import": stub})[0]]
        engine.submit([1, 2, 3])
        engine.drive_once()  # the only slot is taken
        codes.append(_request(srv.port, "/v1/completions",
                              {"kv_import": payload})[0])
        srv._draining = True
        codes += [_request(srv.port, path, body)[0] for path, body in (
            ("/v1/completions", {"kv_import": payload}),
            ("/kv/prefill", {"prompt": LONG}))]
    finally:
        # stop() joins the engine thread: give it one that has ended.
        srv._engine_thread = threading.Thread(target=lambda: None)
        srv._engine_thread.start()
        srv.stop()
    plain = SERVERS[name](ENGINES[name](models, prefix_cache=False)).start()
    try:
        codes.append(_request(plain.port, "/kv/chain",
                              {"keys": ["00" * 20]})[0])
    finally:
        plain.stop()
    return codes


def test_kv_status_codes_are_jax_s(f32_gqa):
    payload = _prefill_payload(_jax(f32_gqa), LONG)
    stub = json.loads(json.dumps(payload))
    del stub["blocks"][0]["data"]
    codes = {name: _status_codes(name, f32_gqa, payload, stub)
             for name in ("jax", "port")}
    assert codes["port"] == codes["jax"] == [409, 429, 503, 503, 409]


@pytest.mark.parametrize("raw", ["", "prefill", "DECODE", "fused", "bogus"])
def test_tier_role_from_env_is_jax_s(monkeypatch, raw):
    monkeypatch.setenv("KUBEFLOW_TPU_GATEWAY_TIER_ROLE", raw)
    if raw == "bogus":
        with pytest.raises(ValueError) as jerr:
            JS.tier_role_from_env()
        with pytest.raises(ValueError) as terr:
            TS.tier_role_from_env()
        assert str(terr.value) == str(jerr.value)
    else:
        assert TS.tier_role_from_env() == JS.tier_role_from_env()


def test_tier_role_argument_is_checked(f32_gqa):
    with pytest.raises(ValueError, match="tier_role"):
        TS.InferenceServer(_port(f32_gqa), port=0, tier_role="router")
