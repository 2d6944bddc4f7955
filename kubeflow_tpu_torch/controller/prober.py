"""Native concurrent slice-activity prober binding.

The port's own copy of ``kubeflow_tpu/controller/prober.py``. The C++
prober, ``csrc/host/prober.cpp`` (a copy of the JAX package's
``native/prober.cpp``), is built with ``g++`` into ``_build/`` at first
use (``ops/_build.build_host``) and bound with ctypes behind the
``ActivityProber`` protocol the culler uses. Probing the hosts one after
another costs O(hosts × timeout) when they are unreachable; the native
prober issues every GET at once, so a verdict on a slice of any size
costs one timeout.

``make_prober()`` returns the native prober, and in DEV mode (a localhost
proxy) the Python ``JupyterHTTPProber``, as the JAX package's does. Where
JAX's falls back quietly to the Python prober when its library is
missing, the port's raises: a failed build names its log.
"""

from __future__ import annotations

import ctypes
import json
from typing import Optional

from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller.culling import (
    HostActivity,
    JupyterHTTPProber,
    fold_host_activity,
)
from kubeflow_tpu_torch.ops import _build

_SRC = _build.HOST_SRC / "prober.cpp"
# Kernel/terminal lists are a few hundred bytes each; 64 KiB leaves two
# orders of magnitude of headroom without allocating megabytes per cycle.
_BODY_CAP = 64 << 10
_libs: dict = {}


def load_lib() -> ctypes.CDLL:
    """The prober's library, built on first use; raises if it does not
    build (naming the build log) or load."""
    path = _build.build_host(_SRC)
    if path not in _libs:
        lib = ctypes.CDLL(str(path))
        lib.pr_probe.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.pr_probe.restype = ctypes.c_int
        _libs[path] = lib
    return _libs[path]


class NativeFanoutProber:
    """ActivityProber using the C++ concurrent prober.

    Probes ``/api/kernels`` and ``/api/terminals`` on every host in one
    concurrent batch (2 URLs per host), then folds responses into
    per-host ``HostActivity`` exactly like the Python prober does.
    """

    def __init__(
        self,
        timeout_s: float = 5.0,
        lib: Optional[ctypes.CDLL] = None,
        port: int = 8888,
    ):
        self.timeout_s = timeout_s
        self.port = port
        self._lib = lib if lib is not None else load_lib()

    def probe(self, nb: Notebook, hosts: list[str]) -> list[HostActivity]:
        urls: list[str] = []
        for host in hosts:
            base = f"http://{host}:{self.port}/notebook/{nb.namespace}/{nb.name}"
            urls.append(f"{base}/api/kernels")
            urls.append(f"{base}/api/terminals")
        statuses, bodies = self._raw_probe(urls)

        out: list[HostActivity] = []
        for i, host in enumerate(hosts):
            kernels = _decode(statuses[2 * i], bodies[2 * i])
            if kernels is _TRUNCATED:
                # The kernel list overflowed _BODY_CAP — hundreds of
                # kernels means the server is plainly in use. Mark busy
                # (refreshes last-activity upstream) rather than
                # unreachable: an "unobservable" verdict would trip the
                # never-cull-blind rule and hold the slice forever.
                out.append(HostActivity(host=host, busy=True))
                continue
            terminals = _decode(statuses[2 * i + 1], bodies[2 * i + 1])
            if terminals is _TRUNCATED:
                terminals = None
            out.append(fold_host_activity(host, kernels, terminals))
        return out

    def _raw_probe(self, urls: list[str]) -> tuple[list[int], list[bytes]]:
        n = len(urls)
        if n == 0:
            return [], []
        c_urls = (ctypes.c_char_p * n)(*[u.encode() for u in urls])
        bodies = ctypes.create_string_buffer(n * _BODY_CAP)
        statuses = (ctypes.c_int * n)()
        rc = self._lib.pr_probe(
            c_urls,
            n,
            int(self.timeout_s * 1000),
            bodies,
            _BODY_CAP,
            statuses,
        )
        if rc != 0:
            raise RuntimeError(f"pr_probe returned {rc}")
        # string_at with no length stops at the first NUL, so only the
        # actual response bytes are copied out — not n × _BODY_CAP.
        base = ctypes.addressof(bodies)
        out_bodies = [
            ctypes.string_at(base + i * _BODY_CAP) for i in range(n)
        ]
        return list(statuses), out_bodies


# Sentinel: HTTP 200 but the body filled _BODY_CAP and won't parse — the
# response was cut mid-JSON, which is a "very long kernel list", not an
# unreachable host.
_TRUNCATED = object()


def _decode(status: int, body: bytes):
    if status != 200:
        return None
    try:
        parsed = json.loads(body.decode())
    except (ValueError, UnicodeDecodeError):
        if len(body) >= _BODY_CAP - 1:
            return _TRUNCATED
        return None
    return parsed if isinstance(parsed, list) else None


def make_prober(timeout_s: float = 5.0, dev_proxy: Optional[str] = None):
    """Production factory: the native fan-out prober, built at first use
    (a failed build raises); the Python prober in DEV mode only, which
    reaches every host through the localhost proxy (reference
    culling_controller.go:253-257)."""
    if dev_proxy is None:
        return NativeFanoutProber(timeout_s=timeout_s)
    return JupyterHTTPProber(timeout_s=timeout_s, dev_proxy=dev_proxy)
