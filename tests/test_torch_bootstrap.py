"""The port's bootstrap and env contract against the JAX package's.

``runtime_from_env`` field by field over the envs of the JAX package's own
tests (a 4-host slice, a multislice host, slice 0's coordinator, a single
slice) plus empty and garbage values; the checkpoint parsers and every env
name against ``kubeflow_tpu.api.annotations`` and
``kubeflow_tpu.webhook.tpu_env``; the mesh's axis arithmetic and its
errors against JAX's ``rt.mesh`` over 8 CPU devices; the device-count
mismatch; the profiler refusal; and two gloo processes brought up by
``bootstrap(device="cpu")`` with the ranks the env gives them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubeflow_tpu.api import annotations as ann
from kubeflow_tpu.webhook import tpu_env
from kubeflow_tpu_torch.runtime import env as PE

# The packages' ``runtime.bootstrap`` attribute is the function, so the
# modules are looked up by name.
JB = importlib.import_module("kubeflow_tpu.runtime.bootstrap")
PB = importlib.import_module("kubeflow_tpu_torch.runtime.bootstrap")

ROOT = Path(__file__).resolve().parent.parent

ENVS = {
    "four-hosts": {
        "TPU_WORKER_ID": "2",
        "TPU_WORKER_HOSTNAMES": "nb-0.h,nb-1.h,nb-2.h,nb-3.h",
        "JAX_COORDINATOR_ADDRESS": "nb-0.h:8476",
        "JAX_NUM_PROCESSES": "4",
        "TPU_ACCELERATOR_TYPE": "v5litepod-16",
        "TPU_TOPOLOGY": "4x4",
    },
    "multislice-host": {
        "TPU_WORKER_ID": "2",
        "TPU_HOSTS_PER_SLICE": "4",
        "MEGASCALE_SLICE_ID": "1",
        "MEGASCALE_NUM_SLICES": "2",
        "JAX_NUM_PROCESSES": "8",
        "TPU_WORKER_HOSTNAMES": "a,b,c,d",
        "JAX_COORDINATOR_ADDRESS": "ms-0.ms-hosts.u.svc.cluster.local:8476",
    },
    "slice0-coordinator": {
        "TPU_WORKER_ID": "0",
        "TPU_HOSTS_PER_SLICE": "4",
        "MEGASCALE_SLICE_ID": "0",
        "MEGASCALE_NUM_SLICES": "2",
    },
    "single-slice": {
        "TPU_WORKER_ID": "1",
        "TPU_WORKER_HOSTNAMES": "a,b,c,d",
        "JAX_NUM_PROCESSES": "4",
    },
    "empty": {},
    "empty-values": {"TPU_WORKER_ID": "", "JAX_NUM_PROCESSES": "",
                     "MEGASCALE_NUM_SLICES": "", "TPU_HOSTS_PER_SLICE": "",
                     "MEGASCALE_SLICE_ID": "", "TPU_WORKER_HOSTNAMES": ","},
    "one-host": {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "solo"},
}
GARBAGE = [
    {"TPU_WORKER_ID": "x"},
    {"JAX_NUM_PROCESSES": "two"},
    {"TPU_HOSTS_PER_SLICE": "1.5"},
    {"MEGASCALE_NUM_SLICES": "²"},
    {"MEGASCALE_SLICE_ID": " "},
]


def _fields(rt) -> dict:
    """The JAX SliceRuntime's fields and properties, read off ``rt``."""
    names = [f.name for f in dataclasses.fields(JB.SliceRuntime)]
    out = {name: getattr(rt, name) for name in names}
    out.update(is_multi_host=rt.is_multi_host, process_id=rt.process_id,
               is_coordinator=rt.is_coordinator)
    return out


@pytest.mark.parametrize("name", sorted(ENVS))
def test_runtime_from_env_field_by_field(name):
    env = ENVS[name]
    assert _fields(PB.runtime_from_env(env)) == _fields(
        JB.runtime_from_env(env))


def test_runtime_from_env_known_values():
    rt = PB.runtime_from_env(ENVS["multislice-host"])
    assert (rt.worker_id, rt.process_id, rt.num_workers, rt.num_slices) == (
        2, 6, 8, 2)
    assert not rt.is_coordinator and rt.is_multi_host
    assert PB.runtime_from_env(ENVS["slice0-coordinator"]).is_coordinator


@pytest.mark.parametrize("env", GARBAGE, ids=lambda e: next(iter(e)))
def test_runtime_from_env_garbage_raises_as_jax_does(env):
    with pytest.raises(ValueError) as jax_err:
        JB.runtime_from_env(env)
    with pytest.raises(ValueError) as port_err:
        PB.runtime_from_env(env)
    assert str(port_err.value) == str(jax_err.value)


def test_runtime_from_env_reads_os_environ(monkeypatch):
    for key, value in ENVS["four-hosts"].items():
        monkeypatch.setenv(key, value)
    assert _fields(PB.runtime_from_env()) == _fields(JB.runtime_from_env())


NAMES = ["TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "TPU_ACCELERATOR_TYPE",
         "TPU_TOPOLOGY", "TPU_HOSTS_PER_SLICE", "JAX_COORDINATOR_ADDRESS",
         "JAX_NUM_PROCESSES", "MEGASCALE_NUM_SLICES", "MEGASCALE_SLICE_ID",
         "KUBEFLOW_TPU_MIGRATE_ENABLE", "KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S",
         "KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S",
         "KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S",
         "KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S",
         "KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S"]
ANNOTATION_NAMES = ["PROFILING_ENV_NAME", "CHECKPOINT_GRACE_ENV_NAME",
                    "CHECKPOINT_DIR_ENV_NAME"]


def test_env_names_are_the_contracts():
    for name in NAMES:
        assert getattr(PE, name) == getattr(tpu_env, name), name
    for name in ANNOTATION_NAMES:
        assert getattr(PE, name) == getattr(ann, name), name


PARSER_INPUTS = ["²", " 60 ", 0, 3601, 80, 65536, "65535", "1024", "1023",
                 "3600", 3600, 1, "1", "-5", "60.0", 60.0, "abc", "", None,
                 " ", "9012", "0x400", "１２３４"]


@pytest.mark.parametrize("value", PARSER_INPUTS, ids=repr)
def test_parsers_match_the_annotations(value):
    assert PE.parse_profiling_port(value) == ann.parse_profiling_port(value)
    assert PE.parse_checkpoint_grace(value) == ann.parse_checkpoint_grace(
        value)


@pytest.mark.parametrize("value", ["60", " 60 ", "0", "3601", "²", "", "7"],
                         ids=repr)
def test_checkpoint_env_readers_match(value):
    env = {"TPU_CHECKPOINT_GRACE_S": value,
           "KUBEFLOW_TPU_CHECKPOINT_DIR": value}
    assert PB.checkpoint_grace_from_env(env) == JB.checkpoint_grace_from_env(
        env)
    assert PB.checkpoint_dir_from_env(env) == JB.checkpoint_dir_from_env(env)
    assert PB.checkpoint_grace_from_env({}) is JB.checkpoint_grace_from_env(
        {}) is None
    assert PB.checkpoint_dir_from_env({}) is JB.checkpoint_dir_from_env(
        {}) is None


MESH_CASES = [dict(dp=-1, tp=2), dict(dp=8), dict(dp=2, tp=4),
              dict(dp=2, fsdp=2, tp=2), dict(dp=-1), dict(x=1, y=-1),
              dict(dp=-1, tp=-1), dict(dp=-1, tp=3), dict(dp=2, tp=2),
              dict(dp=16)]


@pytest.mark.parametrize("axes", MESH_CASES, ids=repr)
def test_mesh_axis_arithmetic_and_errors_match_jax(axes):
    import jax

    total = jax.device_count()
    assert total == 8
    rt = JB.runtime_from_env({})
    try:
        want = dict(rt.mesh(**axes).shape)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            PB.mesh_axes(axes, total)
        assert str(got.value) == str(err)
        return
    assert PB.mesh_axes(axes, total) == want


def test_mesh_checks_the_axes_then_refuses_naming_item_11():
    """Item 11 ported the mesh: ``rt.mesh`` checks the axes as JAX's does
    and returns a mesh over the process group's ranks, axes named and
    ordered as given (one CPU process: one rank)."""
    rt = PB.bootstrap(env={}, device="cpu")
    assert rt.device == torch.device("cpu")
    mesh = rt.mesh(dp=-1)
    assert mesh.shape == {"dp": 1} and mesh.ranks.tolist() == [0]
    assert rt.mesh(x=1, y=-1).axis_names == ("x", "y")
    with pytest.raises(ValueError, match="multiply to 2"):
        rt.mesh(dp=2)


def test_single_host_bootstrap_starts_no_group():
    want = JB.bootstrap(env={"TPU_WORKER_ID": "0"})
    rt = PB.bootstrap(env={"TPU_WORKER_ID": "0"}, device="cpu")
    assert _fields(rt) == _fields(want)
    assert not rt.is_multi_host and not rt.distributed_initialized
    assert not torch.distributed.is_initialized()
    assert PB.bootstrap(env={}, device="cpu", expected_devices=1).num_workers == 1


def test_device_count_mismatch_message():
    with pytest.raises(RuntimeError) as jax_err:
        JB.bootstrap(env={}, expected_devices=16)
    with pytest.raises(RuntimeError) as port_err:
        PB.bootstrap(env={}, expected_devices=16, device="cpu")
    prefix = "slice incomplete: expected 16 devices, "
    assert str(jax_err.value).startswith(prefix)
    assert str(port_err.value).startswith(prefix + "the process group sees 1.")
    assert "readyHosts" in str(port_err.value)


def test_bootstrap_without_a_card_names_the_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.bootstrap(env={})


def test_profiler_port_refusal():
    assert PB.maybe_start_profiler_server({}) is None
    assert JB.maybe_start_profiler_server({}) is None
    for bad in ("80", "²", "65536", "port"):
        env = {"KUBEFLOW_TPU_PROFILING_PORT": bad}
        with pytest.raises(ValueError) as jax_err:
            JB.maybe_start_profiler_server(env)
        with pytest.raises(ValueError) as port_err:
            PB.maybe_start_profiler_server(env)
        assert str(port_err.value) == str(jax_err.value)
        assert "not a port in 1024..65535" in str(port_err.value)
    env = {"KUBEFLOW_TPU_PROFILING_PORT": " 9012 "}
    with pytest.raises(NotImplementedError,
                       match="KUBEFLOW_TPU_PROFILING_PORT=9012"):
        PB.maybe_start_profiler_server(env)
    with pytest.raises(NotImplementedError, match="profiler server"):
        PB.bootstrap(env=env, device="cpu")


_RANK = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from kubeflow_tpu_torch.runtime import bootstrap
env = json.loads(sys.argv[2])
rt = bootstrap(env=env, device="cpu", expected_devices=2)
ones = torch.ones(3)
dist.all_reduce(ones)
again = bootstrap(env=env, device="cpu")
print(json.dumps({
    "rank": dist.get_rank(), "world": dist.get_world_size(),
    "process_id": rt.process_id, "initialized": rt.distributed_initialized,
    "again": again.distributed_initialized, "sum": ones.tolist(),
    "backend": dist.get_backend()}), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_come_up_with_their_ranks():
    port = _free_port()
    procs = []
    for worker in (0, 1):
        env = {"TPU_WORKER_ID": str(worker), "JAX_NUM_PROCESSES": "2",
               "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "TPU_WORKER_HOSTNAMES": "h0,h1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, str(ROOT), json.dumps(env)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "OMP_NUM_THREADS": "1"}))
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=120)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for worker, got in enumerate(outs):
        assert got == {"rank": worker, "world": 2, "process_id": worker,
                       "initialized": True, "again": True,
                       "sum": [2.0, 2.0, 2.0], "backend": "gloo"}
