"""Build the port's CUDA kernel with ``nvcc`` and load it with ctypes.

``csrc/ragged_attention.cu`` has a plain C interface and compiles into a
shared library under ``kubeflow_tpu_torch/_build/`` (which ``.gitignore``
lists), named by a hash of its source and flags, so an edited source never
loads a stale library. Nothing is built at import time: the first
``load()`` builds, later ones reuse the file.

Builds of one checkout serialize on ``_build/build.lock`` (an advisory
``flock``, released when its file is closed or its process ends).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "ragged_attention.cu"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the port's CUDA kernel needs the CUDA toolkit"
    )


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest}.so"


def log_path() -> Path:
    """The compiler's output of the last build (``-Xptxas -v`` register,
    shared-memory and spill lines)."""
    return library_path().with_suffix(".log")


def build() -> Optional[float]:
    """Compile the source if its library is missing. Returns the seconds
    ``nvcc`` took, or None when the library was already built; raises with
    the compiler's output if the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path()
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return None
        tmp = out.with_name(out.name + f".tmp{os.getpid()}")
        t0 = time.monotonic()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log_path().write_text(proc.stdout)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"kernel build failed (nvcc exit {proc.returncode}):\n"
                + proc.stdout
            )
        os.replace(tmp, out)
        return time.monotonic() - t0


def load() -> ctypes.CDLL:
    """The built library, building it first if needed."""
    global _loaded
    if _loaded is None:
        build()
        _loaded = ctypes.CDLL(str(library_path()))
    return _loaded
