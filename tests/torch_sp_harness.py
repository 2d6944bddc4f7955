"""Spawning the gloo groups of ``tests/torch_sp_worker.py`` for the
sequence-, pipeline- and expert-parallel tests, and putting their pieces
back together. Not a test module: the test files import it."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_sp_worker.py"
SPAWN_TIMEOUT = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(tmp: Path, tag: str, world: int, scenarios: list, inputs: dict,
           **spec) -> tuple:
    """Save ``inputs`` and start ``world`` ranks running ``scenarios``;
    returns what ``collect`` takes."""
    inputs_path = tmp / f"{tag}-inputs.pt"
    torch.save(inputs, inputs_path)
    spec = {**spec, "world": world, "port": free_port(),
            "scenarios": scenarios, "inputs": str(inputs_path),
            "out": str(tmp / f"{tag}-out")}
    path = tmp / f"{tag}-spec.json"
    path.write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(path), str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)]
    return spec, procs


def collect(spec: dict, procs: list) -> list:
    """Each rank's record, after every rank exited 0."""
    errs = []
    try:
        for proc in procs:
            errs.append(proc.communicate(timeout=SPAWN_TIMEOUT)[1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
    return [torch.load(f"{spec['out']}.{r}.pt")
            for r in range(spec["world"])]


def assemble(pieces: list, shape: tuple) -> np.ndarray:
    """The whole array from ``(index, data)`` pieces; every element must
    be covered, and pieces that overlap must agree exactly."""
    out = np.full(shape, np.nan, dtype=np.float64)
    for index, data in pieces:
        region = tuple(slice(a, b) for a, b in index)
        data = np.asarray(data, dtype=np.float64)
        held = out[region]
        seen = ~np.isnan(held)
        assert np.array_equal(held[seen], data[seen]), "replicas differ"
        out[region] = data
    assert not np.isnan(out).any(), "a piece is missing"
    return out


def region(array: np.ndarray, index) -> np.ndarray:
    return np.asarray(array)[tuple(slice(a, b) for a, b in index)]
