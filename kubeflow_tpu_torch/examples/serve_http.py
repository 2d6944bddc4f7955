"""Serve a Llama-family model over HTTP with the port's engines.

    python -m kubeflow_tpu_torch.examples.serve_http --config llama-3-8b &
    curl -s localhost:8000/v1/completions \
      -d '{"prompt": [1, 2, 3, 4], "max_tokens": 8}'
    curl -s localhost:8000/stats

The PyTorch counterpart of ``examples/serve_http.py``, with the engine
chosen as the JAX entry point chooses it. Without ``--paged`` it serves
``ContinuousBatcher`` (a dense per-slot cache of ``--cache-len``
positions, default 1024: a flash prefill per admission, or
``--admit-chunk``-token pieces between decode steps; each decode step
through the dense decode kernel). ``--paged`` serves ``PagedBatcher``:
KUBEFLOW_TPU_SERVING_RAGGED=1 the ragged engine, unset or 0 the
alternating one, with KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET and
KUBEFLOW_TPU_KV_BITS as in JAX. KUBEFLOW_TPU_SERVING_PORT applies to
both. Weights are a random init from ``--seed`` on the card (``--device
cpu`` serves on the CPU); the model serves token ids.
"""

from __future__ import annotations

import argparse
import signal
import threading


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=None,
                    help="default: KUBEFLOW_TPU_SERVING_PORT, else 8000")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=1024)
    ap.add_argument("--prompt-bucket", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--admit-chunk", type=int, default=None,
                    help="(continuous engine) admit prompts in N-token "
                         "pieces with decode steps between them")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged block-pool engine")
    ap.add_argument("--num-blocks", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-queue-depth", type=int, default=64,
                    help="pending requests past this shed with 429")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline (504 on expiry)")
    ap.add_argument("--drain-s", type=float, default=5.0,
                    help="SIGTERM drain budget before stragglers abort")
    args = ap.parse_args(argv)
    if args.paged and args.admit_chunk:
        raise SystemExit("--admit-chunk is a continuous-engine feature; "
                         "drop it or drop --paged")

    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models import llama as L
    from kubeflow_tpu_torch.models.continuous import ContinuousBatcher
    from kubeflow_tpu_torch.models.paged import PagedBatcher
    from kubeflow_tpu_torch.models.server import (
        InferenceServer,
        kv_pool_from_env,
        ragged_from_env,
        serving_port_from_env,
    )
    from kubeflow_tpu_torch.models.serving import GenerationConfig

    try:
        if args.port is None:
            args.port = serving_port_from_env()
        if args.paged:
            ragged, token_budget = ragged_from_env()
            kv_kw = kv_pool_from_env()
    except ValueError as err:
        raise SystemExit(str(err))
    device = resolve_device(args.device)
    cfg = L.LLAMA_CONFIGS[args.config]
    params = L.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device
    )
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature)
    if args.paged:
        engine = PagedBatcher(
            params, cfg, gen=gen, slots=args.slots,
            num_blocks=args.num_blocks, block_size=args.block_size,
            prompt_bucket=args.prompt_bucket, ragged=ragged,
            token_budget=token_budget, device=device, **kv_kw,
        )
        kind = f"{'ragged' if ragged else 'alternating'} paged"
    else:
        engine = ContinuousBatcher(
            params, cfg, gen=gen, slots=args.slots, cache_len=args.cache_len,
            prompt_bucket=args.prompt_bucket, admit_chunk=args.admit_chunk,
            device=device,
        )
        kind = "continuous"
    srv = InferenceServer(engine, host=args.host, port=args.port,
                          model_name=args.config,
                          max_queue_depth=args.max_queue_depth,
                          default_deadline_s=args.deadline_s,
                          drain_s=args.drain_s).start()
    print(f"serving {args.config} on http://{srv.host}:{srv.port} "
          f"({kind}, {args.slots} slots, {device})", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    srv.stop()


if __name__ == "__main__":
    main()
