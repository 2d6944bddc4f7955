"""Train a Llama-family model on one device with checkpoint/resume.

    python -m kubeflow_tpu_torch.examples.train --config llama-3-8b \\
        --steps 8 --batch 1 --seq 2048 --ckpt-dir /mnt/checkpoints

The PyTorch counterpart of ``examples/train_sharded.py`` on one card: init
→ ``restore_latest`` (a rerun after a preemption resumes from the newest
valid checkpoint) → train, saving every 2 steps → ``wait``. Tokens are
synthetic, drawn from a ``torch.Generator`` seeded by the step, so a
resumed run continues the stream instead of replaying it; or, with
``--data``, windows of a uint32 corpus (``data.loader.write_token_file``
format) through ``sharded_loader`` resumed at the checkpoint's cursor.
Weights are a random init from seed 0; ``--fp8`` wraps them for fp8
training (``models/fp8.py``: bf16 masters, fp8 product operands with
delayed scaling). Runs on the card unless ``--device cpu``.
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
    ap.add_argument("--data", default=None,
                    help="uint32 token corpus (data.loader.write_token_file "
                         "format); omitted = synthetic random tokens")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--loss-chunk", type=int, default=512,
                    help="lm-head/cross-entropy chunk; 0 = the dense loss")
    ap.add_argument("--fp8", action="store_true",
                    help="train with fp8 matmul operands (delayed "
                         "scaling; bf16 master weights — models/fp8.py). "
                         "Numerics identical everywhere; the matmul-rate "
                         "win engages where the MXU has fp8 lanes")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from kubeflow_tpu_torch.data.loader import sharded_loader
    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models import llama as L
    from kubeflow_tpu_torch.models.fp8 import wrap_params_fp8
    from kubeflow_tpu_torch.models.train import make_train_step
    from kubeflow_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        resume_start_batch,
    )

    dev = resolve_device(args.device)
    cfg = L.LLAMA_CONFIGS[args.config]
    init_state, step = make_train_step(cfg, remat=args.remat,
                                       loss_chunk=args.loss_chunk,
                                       fp8=args.fp8)
    params = L.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if args.fp8:
        params = wrap_params_fp8(params)
    state = init_state(params)
    print(f"{cfg.param_count():,} params on {dev}", flush=True)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="kftt-ckpt-")
    ckpt = CheckpointManager(ckpt_dir, save_interval_steps=2)
    state, resumed = ckpt.restore_latest(state)
    start = resumed or 0
    if resumed:
        print(f"resumed from step {resumed}", flush=True)

    loader = None
    if args.data:
        # The resumed run must not re-read the batches the lost run used.
        loader = sharded_loader(args.data, args.batch, args.seq,
                                start_batch=resume_start_batch(ckpt, resumed))
    try:
        for i in range(start, args.steps):
            if loader is not None:
                tokens = torch.from_numpy(
                    np.remainder(loader.next(), cfg.vocab_size)).to(dev)
            else:
                # Seeded by the step: a resumed run continues the stream.
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
    print(f"done; checkpoints in {ckpt_dir}", flush=True)


if __name__ == "__main__":
    main()
