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
alternating one, with KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET,
KUBEFLOW_TPU_KV_BITS and KUBEFLOW_TPU_HBM_FRACTION as in JAX.
KUBEFLOW_TPU_SERVING_PORT applies to both. KUBEFLOW_TPU_KV_SWAP_BYTES > 0
gives the paged engine a host-RAM swap tier of that many bytes and turns
its prefix cache on, as in JAX (a swap tier holds demoted prefix leaves);
on the ragged engine the engine refuses that pair with the JAX message.
Under ``--paged`` KUBEFLOW_TPU_SPEC_DRAFT_LEN = k > 0 serves
``SpeculativePagedBatcher(ragged=True)`` with ``k_spec`` k, a draft of the
target's first ``n_layers // 4`` layers (``truncated_draft``) and
KUBEFLOW_TPU_SPEC_ADAPTIVE's acceptance-adaptive draft length, as in JAX:
it needs KUBEFLOW_TPU_SERVING_RAGGED=1 and takes KUBEFLOW_TPU_KV_BITS but
not KUBEFLOW_TPU_HBM_FRACTION or _KV_SWAP_BYTES (each exits with the JAX
message). Its server answers a ``logprobs`` request with 400.
Weights are a random init from
``--seed`` on the card (``--device cpu`` serves on the CPU); the model
serves token ids. ``--int8`` quantizes the projections and the lm head to
int8 (``models/quant.py``, releasing each bf16 source as its copy lands),
as the JAX entry point does; like it, this entry point does not read
KUBEFLOW_TPU_QUANT (``serve_batched`` does).

Every serving knob the JAX entry point reads is honored or refused here,
before any weight is made: garbage in any of them exits with the JAX
message, and a knob asking for what the port lacks exits naming the
ROADMAP queue-1 item that brings it: KUBEFLOW_TPU_SERVING_TP > 1 (item
11). KUBEFLOW_TPU_LORA_CACHE_SLOTS is parsed under ``--paged`` and, when
nonzero, only noted, as in JAX: it sizes multi-LoRA engines
(``models/multilora.py``), which this example does not build (it serves
one base model; adapters are served by building
``MultiLoraPagedBatcher`` behind ``InferenceServer``, whose requests pick
an adapter by ``model``).
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional


def _refuse_tp() -> None:
    """KUBEFLOW_TPU_SERVING_TP: garbage exits with the JAX message, and a
    degree above 1 exits, the port serving one card only."""
    from kubeflow_tpu_torch.models.server import (
        KUBEFLOW_TPU_SERVING_TP,
        serving_tp_from_env,
    )

    try:
        tp = serving_tp_from_env()
    except ValueError as err:
        raise SystemExit(str(err))
    if tp > 1:
        raise SystemExit(
            f"{KUBEFLOW_TPU_SERVING_TP}={tp}: tensor-parallel serving "
            "replicas are not ported to PyTorch yet (ROADMAP queue 1 item "
            "11); unset it or set it to 1")


def _paged_knobs() -> tuple[bool, Optional[int], dict, int, bool]:
    """The ``--paged`` engine's env knobs in the JAX entry point's order:
    (ragged, token_budget, the kv-pool keywords, the speculative draft
    length (0: none), adaptive). Exits on garbage and on a combination
    JAX refuses; prints the JAX notice for a nonzero
    KUBEFLOW_TPU_LORA_CACHE_SLOTS."""
    from kubeflow_tpu_torch.models.server import (
        KUBEFLOW_TPU_SERVING_RAGGED,
        KUBEFLOW_TPU_SPEC_DRAFT_LEN,
        kv_pool_from_env,
        lora_cache_from_env,
        ragged_from_env,
        spec_from_env,
    )

    try:
        lora_cache_slots = lora_cache_from_env()
        if lora_cache_slots:
            print(f"lora cache slots={lora_cache_slots} (no adapters "
                  "registered by this example; knob applies to "
                  "multi-LoRA engines)", flush=True)
        kv_kw = kv_pool_from_env()
        ragged, token_budget = ragged_from_env()
        draft_len, adaptive = spec_from_env()
    except ValueError as err:
        raise SystemExit(str(err))
    if draft_len > 0:
        # Speculation is a scheduling mode of the ragged engine: each slot
        # contributes (1 + draft_len) verify rows to the fused dispatch.
        if not ragged:
            raise SystemExit(
                f"{KUBEFLOW_TPU_SPEC_DRAFT_LEN} needs the ragged engine "
                f"(set {KUBEFLOW_TPU_SERVING_RAGGED}=1)")
        if set(kv_kw) - {"kv_bits"}:
            raise SystemExit(
                "speculative serving supports KUBEFLOW_TPU_KV_BITS "
                "but not the HBM sizing / swap-tier knobs; unset "
                "KUBEFLOW_TPU_HBM_FRACTION / _KV_SWAP_BYTES")
    return ragged, token_budget, kv_kw, draft_len, adaptive


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
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only quantization of the projections "
                         "and the lm head")
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
        serving_port_from_env,
    )
    from kubeflow_tpu_torch.models.serving import GenerationConfig

    try:
        if args.port is None:
            args.port = serving_port_from_env()
    except ValueError as err:
        raise SystemExit(str(err))
    _refuse_tp()
    if args.paged:
        ragged, token_budget, kv_kw, draft_len, adaptive = _paged_knobs()
    device = resolve_device(args.device)
    cfg = L.LLAMA_CONFIGS[args.config]
    params = L.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device
    )
    if args.int8:
        from kubeflow_tpu_torch.models.quant import quantize_params

        params = quantize_params(params, free_source=True)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature)
    if args.paged and draft_len:
        from kubeflow_tpu_torch.models.speculative import (
            SpeculativePagedBatcher,
            truncated_draft,
        )

        d_params, d_cfg = truncated_draft(params, cfg,
                                          max(1, cfg.n_layers // 4))
        engine = SpeculativePagedBatcher(
            params, cfg, d_params, d_cfg, gen=gen, slots=args.slots,
            num_blocks=args.num_blocks, block_size=args.block_size,
            prompt_bucket=args.prompt_bucket, k_spec=draft_len,
            adaptive=adaptive, ragged=True, token_budget=token_budget,
            kv_bits=kv_kw.get("kv_bits", 0), device=device,
        )
        kind = (f"ragged paged, speculative k={draft_len} over a "
                f"{d_cfg.n_layers}-layer draft"
                f"{', adaptive' if adaptive else ''}")
    elif args.paged:
        engine = PagedBatcher(
            params, cfg, gen=gen, slots=args.slots,
            num_blocks=args.num_blocks, block_size=args.block_size,
            prompt_bucket=args.prompt_bucket, ragged=ragged,
            token_budget=token_budget,
            prefix_cache=kv_kw.get("swap_bytes", 0) > 0,
            device=device, **kv_kw,
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
          f"({kind}, {args.slots} slots, {device}"
          f"{', int8 weights' if args.int8 else ''})", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    srv.stop()


if __name__ == "__main__":
    main()
