"""Sharded training with checkpoint/resume: the preemption-recovery loop.

    # one process a card; each reads its identity from the env contract
    JAX_COORDINATOR_ADDRESS=host0:29500 JAX_NUM_PROCESSES=2 TPU_WORKER_ID=0 \\
        python -m kubeflow_tpu_torch.examples.train_sharded --ckpt-dir DIR &
    JAX_COORDINATOR_ADDRESS=host0:29500 JAX_NUM_PROCESSES=2 TPU_WORKER_ID=1 \\
        python -m kubeflow_tpu_torch.examples.train_sharded --ckpt-dir DIR

The PyTorch counterpart of ``examples/train_sharded.py``, with its flags
and flow: bootstrap the slice (``runtime.bootstrap``: NCCL over the
coordinator on cards, gloo with ``--device cpu``; a process group already
up is used as it is), build a mesh with every rank on fsdp, shard the
train state, restore the newest checkpoint every process committed, and
train with a checkpoint every 2 steps, each process into its
``proc<k>/`` root. After a preemption the same command resumes. The
batch is rounded up to a multiple of the ranks. Tokens are synthetic,
drawn from a ``torch.Generator`` seeded by the step (a resumed run
continues the stream), or with ``--data`` a uint32 corpus
(``data.loader.write_token_file`` format) read through ``sharded_loader``
at the checkpoint's cursor and placed by ``device_put_global``. Weights
are a random init from seed 0, drawn leaf by leaf and cut to each rank's
shard; ``--fp8`` wraps them for fp8 training. Each process runs on
``cuda:<rank mod the host's cards>`` unless ``--device cpu``. In a pod of
several cards on several hosts, start one process a card, each with
``--local-rank i``: ``bootstrap(local_rank=i)`` gives it rank
``TPU_WORKER_ID × cards + i`` and ``cuda:i``.
"""

from __future__ import annotations

import argparse
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--sp-impl", default="ring",
                    choices=["ring", "ulysses", "zigzag"],
                    help="passed to make_train_step, as the JAX example "
                         "does: the fsdp mesh built here has no sp axis, so "
                         "it is validated and selects nothing")
    ap.add_argument("--data", default=None,
                    help="uint32 token corpus (data.loader.write_token_file "
                         "format); omitted = synthetic random tokens")
    ap.add_argument("--fp8", action="store_true",
                    help="train with fp8 matmul operands (delayed "
                         "scaling; bf16 master weights — models/fp8.py)")
    ap.add_argument("--device", default=None,
                    help="default: this rank's CUDA card; 'cpu' to run on "
                         "the CPU over gloo")
    ap.add_argument("--local-rank", type=int, default=None,
                    help="this process's card on its host, when a process "
                         "is started for each card (runtime.bootstrap's "
                         "local_rank)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from kubeflow_tpu_torch.data.loader import (
        device_put_global,
        sharded_loader,
    )
    from kubeflow_tpu_torch.models import llama as L
    from kubeflow_tpu_torch.models.fp8 import wrap_params_fp8
    from kubeflow_tpu_torch.models.train import make_train_step, shard_state
    from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh
    from kubeflow_tpu_torch.runtime import bootstrap, runtime_from_env
    from kubeflow_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        resume_start_batch,
    )

    device = args.device
    if (device is None and args.local_rank is None
            and torch.cuda.is_available()):
        # One process a card: the rank's card on this host.
        device = f"cuda:{runtime_from_env().process_id % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(device))
    rt = bootstrap(device=device, local_rank=args.local_rank)
    dev = rt.device
    dist = torch.distributed
    up = dist.is_initialized()
    n = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    print(f"slice up: {n} ranks, rank {rank} on {dev}", flush=True)

    # Every rank on fsdp; the batch rounded up to a multiple of the ranks
    # (fsdp splits the batch too).
    plan = MeshPlan(make_mesh(fsdp=n))
    if args.batch % n:
        args.batch = ((args.batch + n - 1) // n) * n
        print(f"batch rounded up to {args.batch} (multiple of {n} ranks)",
              flush=True)
    cfg = L.LLAMA_CONFIGS[args.config]
    init_state, step = make_train_step(cfg, plan, sp_impl=args.sp_impl,
                                       fp8=args.fp8)
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev, plan=plan)
    if args.fp8:
        params = wrap_params_fp8(params)
    state = shard_state(plan, init_state(params))

    ckpt_dir = [args.ckpt_dir or (tempfile.mkdtemp(prefix="kftt-ckpt-")
                                  if rank == 0 else None)]
    if up:  # every rank saves under rank 0's directory
        dist.broadcast_object_list(ckpt_dir, src=0)
    ckpt = CheckpointManager(ckpt_dir[0], save_interval_steps=2,
                             process_index=rank, process_count=n)
    state, resumed = ckpt.restore_latest(state)
    start = resumed or 0
    if resumed:
        print(f"resumed from step {resumed} (preemption recovery)",
              flush=True)

    loader = None
    if args.data:
        # The resumed run must not re-read the batches the lost run used;
        # each rank reads its batch coordinate's rows.
        loader = sharded_loader(args.data, args.batch, args.seq,
                                start_batch=resume_start_batch(ckpt, resumed),
                                mesh=plan.mesh)
    try:
        for i in range(start, args.steps):
            if loader is not None:
                tokens = device_put_global(
                    np.remainder(loader.next(), cfg.vocab_size), plan.mesh,
                    plan.batch_spec[:2], device=dev)
            else:
                # Seeded by the step: a resumed run continues the stream;
                # each rank takes its rows of the global batch.
                gen = torch.Generator().manual_seed(i)
                tokens = torch.randint(0, cfg.vocab_size,
                                       (args.batch, args.seq),
                                       generator=gen).to(dev)
            state, loss = step(state, tokens)
            ckpt.save(i + 1, state, metadata={"start_batch": i + 1})
            print(f"step {i + 1}: loss {float(loss):.4f}", flush=True)
    finally:
        if loader is not None:
            loader.close()
        ckpt.close()
    print(f"done; checkpoints in {ckpt_dir[0]}", flush=True)


if __name__ == "__main__":
    main()
