"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` has a plain C interface and compiles into a shared
library of its own under ``kubeflow_tpu_torch/_build/`` (which
``.gitignore`` lists), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source never loads a stale
library. Nothing is built at import time: the first ``load(name)`` builds
every missing library, one ``nvcc`` per source, all started together;
later loads reuse the files.

Builds of one checkout serialize on ``_build/build.lock`` (an advisory
``flock``, released when its file is closed or its process ends).
"""

from __future__ import annotations

import concurrent.futures
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
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """{name: path} of every kernel source, ``name`` being its stem."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the port's CUDA kernels need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update(sources()[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output of ``name``'s last build (``-Xptxas -v``
    register, shared-memory and spill lines)."""
    return library_path(name).with_suffix(".log")


def build() -> dict[str, Optional[float]]:
    """Compile every source whose library is missing, one ``nvcc`` process
    each, all at once. Returns {name: seconds that source's ``nvcc`` took,
    or None when it was already built}; raises with the compiler's output
    if any build fails."""
    names = list(sources())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)

    def nvcc(name: str):
        out_path = library_path(name)
        tmp = out_path.with_name(out_path.name + f".tmp{os.getpid()}")
        t0 = time.monotonic()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(sources()[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log_path(name).write_text(proc.stdout)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"kernel build of {name} failed (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out_path)
        return time.monotonic() - t0

    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if not library_path(n).exists()]
        took: dict[str, Optional[float]] = dict.fromkeys(names)
        if todo:
            # Threads only wait on the nvcc processes, which run at once;
            # the first failure raises once every build has ended.
            with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
                took.update(zip(todo, pool.map(nvcc, todo)))
        return took


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building every missing
    library first. Each library exports ``kftt_error_string(code)``."""
    if name not in _loaded:
        if name not in sources():
            raise ValueError(f"no kernel source csrc/{name}.cu")
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kftt_error_string.argtypes = [ctypes.c_int]
        lib.kftt_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]
