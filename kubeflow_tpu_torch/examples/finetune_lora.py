"""LoRA fine-tune a Llama-family model on one device, then export merged
weights.

    python -m kubeflow_tpu_torch.examples.finetune_lora --config llama-3-8b \\
        --steps 8 --export merged.npz

The PyTorch counterpart of ``examples/finetune_lora.py``: with
``--checkpoint`` it loads a Hugging Face checkpoint directory
(``models/convert.load_hf_checkpoint``), else a random init of
``--config`` from seed 0. Only the rank-``--rank`` adapters on wq and wv
train (``models/lora.make_lora_train_step``), on batches of (4, 64)
random tokens; ``--export`` writes the merged model as an HF state dict
(``params_to_hf_state_dict``, f32 numpy arrays as JAX's) into an
``.npz``. The printed lines are the JAX example's. Runs on the card
unless ``--device cpu``; the random draws come from torch generators, so
the numbers are not JAX's.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--export", default=None,
                    help="write merged HF state dict (.npz)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models import llama as L
    from kubeflow_tpu_torch.models.convert import (
        load_hf_checkpoint,
        params_to_hf_state_dict,
    )
    from kubeflow_tpu_torch.models.lora import (
        LoraConfig,
        init_lora_params,
        lora_param_count,
        make_lora_train_step,
        merge_lora,
    )

    dev = resolve_device(args.device)
    if args.checkpoint:
        cfg, params = load_hf_checkpoint(args.checkpoint, device=dev)
    else:
        cfg = L.LLAMA_CONFIGS[args.config]
        params = L.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)

    lcfg = LoraConfig(rank=args.rank)
    lora = init_lora_params(cfg, lcfg,
                            torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    print(
        f"base {cfg.param_count()/1e6:.1f}M params frozen; "
        f"training {lora_param_count(cfg, lcfg)/1e3:.1f}K adapter params",
        flush=True,
    )

    init_state, step = make_lora_train_step(cfg, lcfg, learning_rate=args.lr)
    state = init_state(lora)
    gen = torch.Generator().manual_seed(2)
    for i in range(args.steps):
        tokens = torch.randint(0, cfg.vocab_size, (4, 64),
                               generator=gen).to(dev)
        state, loss = step(state, params, tokens)
        print(f"step {i + 1}: loss {float(loss):.4f}", flush=True)

    merged = merge_lora(params, state["lora"], lcfg)
    if args.export:
        sd = {k: v.float().cpu().numpy()
              for k, v in params_to_hf_state_dict(cfg, merged).items()}
        np.savez(args.export, **sd)
        print(f"merged HF state dict → {args.export}", flush=True)


if __name__ == "__main__":
    main()
