"""The port stands alone: no JAX, no JAX package, no quiet CPU fallback.

``kubeflow_tpu_torch`` and ``chip_smoke.py`` import nothing from ``jax``,
``jaxlib``, ``ml_dtypes`` or ``kubeflow_tpu`` (not even its JAX-free
modules), and the port's entry points refuse to run without a card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "kubeflow_tpu")


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
        "kubeflow_tpu_torch.examples.serve_batched\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'kubeflow_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_to_run_on_cpu_unasked(monkeypatch):
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.examples import serve_batched, serve_http
    from kubeflow_tpu_torch.examples import train as train_example
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
        lambda: make_tiny_trainer(),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # Asked for by name, the CPU works.
    pb = PagedBatcher(params, cfg, slots=2, num_blocks=16, block_size=8,
                      prompt_bucket=16, ragged=True, device="cpu")
    assert pb.device.type == "cpu" and pb.attn_kernel is False
