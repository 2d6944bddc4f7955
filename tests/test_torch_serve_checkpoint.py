"""Serving a Hugging Face checkpoint through the port's entry points, on
the CPU, against the JAX entry points.

The checkpoint is a tiny seeded ``transformers`` Llama saved in f32 (two
shards) with a ``tokenizers`` WordLevel tokenizer built here and saved
beside it (no download): ``w3`` .. ``w255`` are ids 3..255, ``</s>`` is
2. Both frameworks load it in f32 (their loaders are patched to pass the
dtype), so the comparison holds the path, not bf16 rounding: the same
greedy text, exactly. The port's ``serve_http --checkpoint --device cpu``
also runs as a process: traced, drained by SIGTERM, and without
``transformers`` (the "no tokenizer" notice, token ids only).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import transformers

from kubeflow_tpu.models import convert as JC
from kubeflow_tpu.models import llama as L
from kubeflow_tpu.models import server as JS
from kubeflow_tpu_torch.models import convert as TC
from kubeflow_tpu_torch.models import server as TS

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def save_tiny_checkpoint(path: Path, tokenizer: bool = True) -> Path:
    """A seeded 2-layer Llama (vocab 256, dim 128, GQA 4/2) in f32, in two
    safetensors shards, and (by default) its WordLevel tokenizer."""
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, bos_token_id=1, eos_token_id=2)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size="600KB")
    if tokenizer:
        from tokenizers import Tokenizer, models, pre_tokenizers

        vocab = {"[UNK]": 0, "<s>": 1, "</s>": 2}
        vocab.update({f"w{i}": i for i in range(3, 256)})
        tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
        tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
        transformers.PreTrainedTokenizerFast(
            tokenizer_object=tok, unk_token="[UNK]", bos_token="<s>",
            eos_token="</s>").save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return save_tiny_checkpoint(tmp_path_factory.mktemp("ckpt"))


def _f32_loaders(monkeypatch):
    real_j, real_t = JC.load_hf_checkpoint, TC.load_hf_checkpoint

    def jax_f32(path, dtype=None):
        # JAX's loader keeps the config's bf16 whatever dtype it loads
        # (its engines then mix f32 weights with a bf16 cache); the port's
        # returns the loaded dtype in the config.
        cfg, params = real_j(path, np.float32)
        return L.LlamaConfig(**{**cfg.__dict__, "dtype": np.float32}), params

    monkeypatch.setattr(JC, "load_hf_checkpoint", jax_f32)
    monkeypatch.setattr(TC, "load_hf_checkpoint",
                        lambda path, dtype=None, device=None, plan=None:
                        real_t(path, torch.float32, device, plan))


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Built(Exception):
    pass


def _capture(engine, **kw):
    raise _Built(engine, kw)


def _post(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("paged", [False, True], ids=["continuous", "paged"])
def test_serve_http_checkpoint_gives_jax_s_text(monkeypatch, ckpt, paged):
    """Both ``serve_http --checkpoint`` entry points build their engine,
    tokenizer and served name from the checkpoint; behind their own
    servers a text prompt comes back as the same text."""
    from kubeflow_tpu_torch.examples import serve_http

    _f32_loaders(monkeypatch)
    monkeypatch.delenv("KUBEFLOW_TPU_SERVING_RAGGED", raising=False)
    monkeypatch.setattr(JS, "InferenceServer", _capture)
    monkeypatch.setattr(TS, "InferenceServer", _capture)
    args = ["--checkpoint", str(ckpt), "--port", "0", "--slots", "2",
            "--max-new-tokens", "6"] + (["--paged", "--num-blocks", "32"]
                                        if paged else ["--cache-len", "128"])
    monkeypatch.setattr(sys, "argv", ["serve_http.py"] + args)
    with pytest.raises(_Built) as jbuilt:
        _jax_example("serve_http").main()
    with pytest.raises(_Built) as tbuilt:
        serve_http.main(args + ["--device", "cpu"])
    monkeypatch.undo()
    texts = []
    for mod, (engine, kw) in ((JS, jbuilt.value.args),
                              (TS, tbuilt.value.args)):
        assert kw["model_name"] == str(ckpt)
        assert kw["tokenizer"] is not None
        srv = mod.InferenceServer(engine, port=0, **{
            k: kw[k] for k in ("tokenizer", "model_name")}).start()
        try:
            out = _post(srv.port, {"prompt": "w5 w9 w17 w33 w41",
                                   "max_tokens": 6})
            assert _get(srv.port, "/v1/models")["data"][0]["id"] == str(ckpt)
        finally:
            srv.stop()
        choice = out["choices"][0]
        texts.append((choice["tokens"], choice["text"]))
    assert texts[1] == texts[0]
    assert texts[0][1] == " ".join(f"w{t}" for t in texts[0][0])


_RUN_SERVE_HTTP = r"""
import importlib.abc, runpy, sys
BLOCKED = tuple(sys.argv[2].split(",")) if sys.argv[2] else ()

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
sys.argv = ["serve_http"] + sys.argv[3:]
runpy.run_module("kubeflow_tpu_torch.examples.serve_http",
                 run_name="__main__")
"""


def start_serve_http(args, blocked=(), env=None):
    """The port's ``serve_http`` as a process; returns (process, port,
    the lines it printed before serving)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_SERVE_HTTP, str(ROOT), ",".join(blocked)]
        + list(args), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT, env={**os.environ, **(env or {})})
    lines = []
    for line in proc.stdout:
        lines.append(line.rstrip())
        if line.startswith("serving "):
            return proc, int(line.split("http://")[1].split()[0]
                             .rsplit(":", 1)[1]), lines
    proc.wait(timeout=TIMEOUT)
    raise AssertionError("serve_http exited: " + "\n".join(lines))


@pytest.mark.parametrize("blocked", [(), ("transformers",)],
                         ids=["tokenizer", "no-transformers"])
def test_serve_http_checkpoint_process_traces_and_drains(ckpt, tmp_path,
                                                         blocked):
    proc, port, lines = start_serve_http(
        ["--checkpoint", str(ckpt), "--device", "cpu", "--port", "0",
         "--paged", "--slots", "2", "--num-blocks", "32",
         "--max-new-tokens", "4"], blocked=blocked,
        env={"KUBEFLOW_TPU_SERVING_RAGGED": "1",
             "KUBEFLOW_TPU_TRACE_RING": "64",
             "KUBEFLOW_TPU_STALL_PROFILE_DIR": str(tmp_path)})
    try:
        tid = "12" * 16
        out = _post(port, {"prompt": [5, 9, 17], "max_tokens": 4},
                    headers={"traceparent": f"00-{tid}-{'34' * 8}-01"})
        choice = out["choices"][0]
        assert len(choice["tokens"]) == 4
        assert ("text" in choice) is not blocked
        if blocked:
            assert any(x.startswith("no tokenizer (") and
                       x.endswith("); serving token ids only")
                       for x in lines), lines
        traces = _get(port, "/debug/traces")["traces"]
        names = {t["name"] for t in traces if t["trace_id"] == tid}
        assert {"server.request", "queue_wait", "prefill",
                "first_decode"} <= names
        assert any(t["name"] == "engine.step" for t in traces)
        stats = _get(port, "/stats")
        assert stats["flight"]["steps"] > 0
        assert stats["flight"]["stall_profiles"]["captures"] == 0
        assert stats["engine_step_stalls"] == 0
    finally:
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, rest


def test_serve_http_checkpoint_needs_a_card_unless_asked(monkeypatch, ckpt):
    from kubeflow_tpu_torch.examples import serve_batched, serve_http

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: serve_http.main(["--checkpoint", str(ckpt), "--port", "0"]),
        lambda: serve_batched.main(["--checkpoint", str(ckpt)]),
        lambda: TC.load_hf_checkpoint(ckpt),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("argv", [
    [],
    ["--prompt", "w5 w9 w17", "--prompt", "w200 w3"],
    ["--paged", "--prompt", "w7 w7 w8"],
    ["--kv8", "--prompt", "w11 w12"],
], ids=["token-ids", "prompts", "paged", "kv8"])
def test_serve_batched_serves_a_checkpoint(monkeypatch, capsys, ckpt, argv):
    """``--checkpoint`` (and ``--prompt`` through its tokenizer): the
    port's ``serve_batched`` prints what JAX's prints."""
    from kubeflow_tpu_torch.examples import serve_batched

    _f32_loaders(monkeypatch)
    monkeypatch.delenv("KUBEFLOW_TPU_QUANT", raising=False)
    args = ["--checkpoint", str(ckpt), "--max-new-tokens", "5"] + argv
    monkeypatch.setattr(sys, "argv", ["serve_batched.py"] + args)
    _jax_example("serve_batched").main()
    want = capsys.readouterr().out.splitlines()
    serve_batched.main(["--device", "cpu"] + args)
    got = capsys.readouterr().out.splitlines()
    lines = [x for x in got if x.startswith("[")]
    # JAX's token lines print numpy scalars (``np.int32(240)``).
    assert lines == [re.sub(r"np\.int\d+\((-?\d+)\)", r"\1", x)
                     for x in want if x.startswith("[")]
    n = argv.count("--prompt") or 3
    assert [x.split("]")[0] for x in lines] == [f"[{i}" for i in range(n)]
    if "--prompt" in argv:
        assert all(x.split("] ", 1)[1].startswith("w") for x in lines)


def test_serve_batched_prompt_refusals(monkeypatch, tmp_path):
    from kubeflow_tpu_torch.examples import serve_batched

    with pytest.raises(SystemExit) as info:
        serve_batched.main(["--device", "cpu", "--prompt", "w5"])
    assert str(info.value) == ("--prompt needs --checkpoint: text prompts "
                               "go through the checkpoint's tokenizer")
    bare = save_tiny_checkpoint(tmp_path / "bare", tokenizer=False)
    with pytest.raises(SystemExit) as info:
        serve_batched.main(["--device", "cpu", "--checkpoint", str(bare),
                            "--prompt", "w5"])
    assert str(info.value).startswith(
        "--prompt given but tokenizer load failed: ")
