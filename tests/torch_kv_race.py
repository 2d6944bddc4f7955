"""The reference engine's step race, which the KV handoff tests guard.

``kubeflow_tpu/models/paged.py`` ``PagedBatcher._step`` hands
``jnp.array(self.positions)`` to its jitted step and advances
``self.positions`` in place at once after the dispatch. On JAX's CPU
backend ``jnp.array`` of a 64-byte-aligned host array can alias it and copy
only when the device reaches the copy; while an import's pool writes are
still queued, the step then reads the advanced positions and the tokens
fork. Whether ``self.positions`` is so aligned differs from engine to
engine, so the fork shows in some processes and never in others.

Run from the repository root::

    python tests/torch_kv_race.py [RUNS] [PROCESSES]

It first shows the aliasing alone (an aligned host array written after
``jnp.array``, the device kept busy), then runs the two cross-framework
handoffs of tests/test_torch_kv.py that the JAX engine decodes, RUNS times
in each of PROCESSES concurrent processes, once as the engine is and once
under ``wait_for_pool_writes`` (the guard of every test that decodes an
import on the reference engine), and prints how many runs forked and at
which index.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for_pool_writes(monkeypatch=None) -> None:
    """Make every reference ``PagedBatcher._step`` (ragged and alternating)
    first wait for the engine's pending pool and mask writes. What a step
    computes is unchanged; only the race goes. With ``monkeypatch`` the
    change is undone after the test."""
    import jax

    from kubeflow_tpu.models import paged as JP

    step = JP.PagedBatcher._step

    def synced(self):
        jax.block_until_ready((self.pool, self.kv_mask))
        step(self)

    if monkeypatch is None:
        JP.PagedBatcher._step = synced
    else:
        monkeypatch.setattr(JP.PagedBatcher, "_step", synced)


def _aliasing(n: int = 50) -> int:
    """Of ``n`` calls, how many ``jnp.array`` copies of a 64-byte-aligned
    host array saw a write made to the host array after the call."""
    import jax.numpy as jnp
    import numpy as np

    busy = jnp.ones((2000, 2000))
    seen = 0
    for _ in range(n):
        _ = busy @ busy
        raw = np.zeros(4 + 16, np.int32)
        off = (-raw.ctypes.data % 64) // 4
        host = raw[off:off + 4]
        copy = jnp.array(host)
        host += 1
        seen += int(copy[0]) == 1
    return seen


def _child(mode: str, runs: int) -> dict:
    import torch

    from kubeflow_tpu.models.gateway import prompt_chain_keys
    from tests.test_torch_kv import (BS, LONG, PROMPT, _decode_import, _fused,
                                     _jax, _models, _port, _prefill_payload)

    torch.set_num_threads(1)
    if mode == "guarded":
        wait_for_pool_writes()
    models = _models("tiny-gqa", "f32")
    out = {}
    # test_handoff_across_frameworks[port-jax-False-8]
    want = _fused(_port(models, 8), LONG)[0]
    payload = _prefill_payload(_port(models, 8), LONG)
    forks = []
    for _ in range(runs):
        got, _ = _decode_import(_jax(models, 8), payload)
        if got != want:
            forks.append(next(i for i, (a, b) in enumerate(zip(got, want))
                              if a != b))
    out["handoff"] = forks
    # test_suffix_only_transfer[port-jax]
    skip = [k.hex() for k in prompt_chain_keys(PROMPT, BS)]
    want = _fused(_port(models), PROMPT)[0]
    payload = _prefill_payload(_port(models), PROMPT, skip_keys=skip)
    forks = []
    for _ in range(runs):
        dec = _jax(models)
        _fused(dec, PROMPT)
        got, _ = _decode_import(dec, payload)
        if got != want:
            forks.append(next(i for i, (a, b) in enumerate(zip(got, want))
                              if a != b))
    out["suffix"] = forks
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        import jax

        jax.config.update("jax_platforms", "cpu")
        print(json.dumps(_child(sys.argv[2], int(sys.argv[3]))))
        return 0
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    procs = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(f"jax {jax.__version__}: jnp.array of an aligned host array saw a "
          f"later host write in {_aliasing()} of 50 calls")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    for mode in ("as-is", "guarded"):
        children = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", mode,
             str(runs)], cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
            for _ in range(procs)]
        results = [json.loads(c.communicate()[0].strip().splitlines()[-1])
                   for c in children]
        for case in ("handoff", "suffix"):
            forks = [i for r in results for i in r[case]]
            print(f"{mode:8s} {case:8s}: {len(forks)} of {runs * procs} runs "
                  f"forked, at index {sorted(set(forks))}, "
                  f"{sum(1 for r in results if r[case])} of {procs} "
                  f"processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
