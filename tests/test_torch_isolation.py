"""The port stands alone: no JAX, no JAX package, no quiet CPU fallback.

``kubeflow_tpu_torch`` and ``chip_smoke.py`` import nothing from ``jax``,
``jaxlib``, ``ml_dtypes`` or ``kubeflow_tpu`` (not even its JAX-free
modules), nor ``safetensors`` or ``prometheus_client`` (the port reads
checkpoints itself and mirrors metrics into a bundle the caller passes);
``transformers`` is imported only for an optional tokenizer, inside a
function. The port's native token loader is built from the port's own
source into ``kubeflow_tpu_torch/_build/``, never loaded from the JAX
package's ``native/``. The port's entry points refuse to run without a
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "kubeflow_tpu", "safetensors",
             "prometheus_client")
# Never imported when the port is: the tokenizer's package is loaded only
# by an entry point given a checkpoint.
NOT_AT_IMPORT = FORBIDDEN + ("transformers",)


def _port_files() -> list[Path]:
    files = sorted((ROOT / "kubeflow_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_no_forbidden_import_anywhere_in_the_port():
    files = _port_files()
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files for name in _imports(f)
        if any(name == m or name.startswith(m + ".") for m in FORBIDDEN)
    ]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import kubeflow_tpu_torch.models.paged, "
        "kubeflow_tpu_torch.models.continuous, "
        "kubeflow_tpu_torch.models.serving, "
        "kubeflow_tpu_torch.models.server, kubeflow_tpu_torch.models.bridge, "
        "kubeflow_tpu_torch.examples.serve_http, kubeflow_tpu_torch.ops._build, "
        "kubeflow_tpu_torch.ops.attention, kubeflow_tpu_torch.ops.paged_attention, "
        "kubeflow_tpu_torch.models.train, kubeflow_tpu_torch.data.loader, "
        "kubeflow_tpu_torch.runtime.checkpoint, kubeflow_tpu_torch.examples.train, "
        "kubeflow_tpu_torch.models.quant, kubeflow_tpu_torch.models.fp8, "
        "kubeflow_tpu_torch.ops.quant_matmul, "
        "kubeflow_tpu_torch.examples.serve_batched, "
        "kubeflow_tpu_torch.models.convert, "
        "kubeflow_tpu_torch.observability.tracing, "
        "kubeflow_tpu_torch.observability.flight, "
        "kubeflow_tpu_torch.observability.profiling, "
        "kubeflow_tpu_torch.models.lora, "
        "kubeflow_tpu_torch.examples.finetune_lora\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_AT_IMPORT!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.examples import (
        finetune_lora,
        serve_batched,
        serve_http,
    )
    from kubeflow_tpu_torch.examples import train as train_example
    from kubeflow_tpu_torch.models import convert as TC
    from kubeflow_tpu_torch.models import llama as TL
    from kubeflow_tpu_torch.models.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.models.paged import PagedBatcher
    from kubeflow_tpu_torch.models.train import make_tiny_trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TL.LLAMA_CONFIGS["tiny"]
    params = TL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for call in (
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: TL.init_params(cfg),
        lambda: PagedBatcher(params, cfg, slots=2, num_blocks=16,
                             block_size=8, prompt_bucket=16, ragged=True),
        lambda: PagedBatcher(params, cfg, slots=2, num_blocks=16,
                             block_size=8, prompt_bucket=16),
        lambda: ContinuousBatcher(params, cfg, slots=2, cache_len=256,
                                  prompt_bucket=16),
        lambda: serve_http.main(["--config", "tiny", "--port", "0"]),
        lambda: serve_http.main(["--config", "tiny", "--port", "0",
                                 "--paged"]),
        lambda: serve_http.main(["--config", "tiny", "--port", "0",
                                 "--int8"]),
        lambda: serve_batched.main(["--config", "tiny"]),
        lambda: serve_batched.main(["--config", "tiny", "--int8",
                                    "--paged"]),
        lambda: train_example.main(["--config", "tiny", "--steps", "1"]),
        lambda: train_example.main(["--config", "tiny", "--steps", "1",
                                    "--fp8"]),
        lambda: finetune_lora.main(["--steps", "1"]),
        lambda: make_tiny_trainer(),
        lambda: TC.params_from_hf_state_dict(
            cfg, TC.params_to_hf_state_dict(cfg, params)),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # Asked for by name, the CPU works.
    pb = PagedBatcher(params, cfg, slots=2, num_blocks=16, block_size=8,
                      prompt_bucket=16, ragged=True, device="cpu")
    assert pb.device.type == "cpu" and pb.attn_kernel is False


def test_the_native_loader_maps_nothing_of_the_jax_package(tmp_path):
    """A process that opens the port's native TokenLoader maps the port's
    own library from ``_build/`` and no file under ``native/``, and the
    port's sources name no path of the JAX package's ``native/``."""
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(bytes(range(256)) * 16)
    code = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from kubeflow_tpu_torch.data.loader import TokenLoader\n"
        "with TokenLoader(sys.argv[2], 2, 8) as loader:\n"
        "    assert loader.native\n"
        "    loader.next()\n"
        "    print(open('/proc/self/maps').read())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT),
                           str(corpus)], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    mapped = {line.split()[-1] for line in proc.stdout.splitlines()
              if line.count(" ") >= 5 and "/" in line}
    build = ROOT / "kubeflow_tpu_torch" / "_build"
    assert any(m.startswith(str(build) + "/libdataloader-") for m in mapped)
    assert not [m for m in mapped if m.startswith(str(ROOT / "native"))]
    for f in _port_files():
        text = f.read_text()
        assert "libkftpu_dataloader" not in text, f
        assert '/ "native"' not in text and "native/lib" not in text, f


def test_the_gpu_node_outputs_are_scanned_and_load_no_jax():
    """The GPU-node outputs (``api/``, ``gpu/``, ``webhook/``,
    ``controller/``) are in the scan above, and importing them loads
    nothing of JAX or the JAX package, whose same-named JAX-free modules
    (``api/names.py``, ``api/annotations.py``, ``tpu/topology.py``) they
    copy."""
    scanned = {f.parent.name for f in _port_files()
               if f.parent.parent.name == "kubeflow_tpu_torch"}
    assert {"api", "gpu", "webhook", "controller"} <= scanned
    code = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import kubeflow_tpu_torch.api.names, "
        "kubeflow_tpu_torch.api.annotations, "
        "kubeflow_tpu_torch.api.notebook, kubeflow_tpu_torch.gpu, "
        "kubeflow_tpu_torch.webhook.gpu_env, "
        "kubeflow_tpu_torch.controller.notebook, "
        "kubeflow_tpu_torch.examples.train_sharded\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_AT_IMPORT!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def test_the_fleet_modules_are_scanned_and_load_no_jax():
    """The fleet (``models/gateway.py``, ``models/autoscaler.py``,
    ``observability/signals.py`` and ``slo.py``) is in the scan above,
    and importing it, or building a gateway with its telemetry plane and
    autoscaler, loads nothing of JAX or the JAX package, whose same-named
    JAX-free modules it copies."""
    scanned = {str(f.relative_to(ROOT)) for f in _port_files()}
    for rel in ("models/gateway.py", "models/autoscaler.py",
                "observability/signals.py", "observability/slo.py"):
        assert f"kubeflow_tpu_torch/{rel}" in scanned, rel
    code = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from kubeflow_tpu_torch.models.gateway import ServingGateway\n"
        "from kubeflow_tpu_torch.models.autoscaler import AutoscalerConfig\n"
        "from kubeflow_tpu_torch.observability.signals import "
        "FleetTelemetry\n"
        "gw = ServingGateway([], port=0, telemetry=FleetTelemetry(),\n"
        "                    autoscaler_config=AutoscalerConfig())\n"
        "gw.probe_once()\n"
        "assert gw.autoscaler is not None and gw.scale_up() is None\n"
        "gw.stop()\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_AT_IMPORT!r}]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def test_the_cluster_layer_is_scanned_and_loads_no_jax():
    """The cluster client layer (``k8s/``), the metrics registry
    (``metrics/``) and the controller loop are in the scan above, and a
    process that imports them, scrapes a ``Metrics`` bundle and builds
    the native prober loads nothing of JAX, the JAX package or
    ``prometheus_client`` (which the card's machine does not have), and
    maps the prober's library from the port's ``_build/``, never the JAX
    package's ``native/libkftpu_prober.so``."""
    scanned = {f.parent.name for f in _port_files()
               if f.parent.parent.name == "kubeflow_tpu_torch"}
    assert {"k8s", "metrics", "controller"} <= scanned
    code = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import kubeflow_tpu_torch.k8s, kubeflow_tpu_torch.metrics.server\n"
        "import kubeflow_tpu_torch.controller.culling, "
        "kubeflow_tpu_torch.controller.slicepool, "
        "kubeflow_tpu_torch.models.gateway\n"
        "from kubeflow_tpu_torch.k8s import FakeCluster\n"
        "from kubeflow_tpu_torch.metrics import Metrics\n"
        "from kubeflow_tpu_torch.controller.prober import make_prober, "
        "NativeFanoutProber\n"
        "assert b'notebook_running' in Metrics(FakeCluster()).expose()\n"
        "assert isinstance(make_prober(), NativeFanoutProber)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{NOT_AT_IMPORT!r}]\n"
        "assert not bad, bad\n"
        "print(open('/proc/self/maps').read())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    mapped = {line.split()[-1] for line in proc.stdout.splitlines()
              if line.count(" ") >= 5 and "/" in line}
    build = ROOT / "kubeflow_tpu_torch" / "_build"
    assert any(m.startswith(str(build) + "/libprober-") for m in mapped)
    assert not [m for m in mapped if m.startswith(str(ROOT / "native"))]
    for f in _port_files():
        assert "libkftpu_prober" not in f.read_text(), f
