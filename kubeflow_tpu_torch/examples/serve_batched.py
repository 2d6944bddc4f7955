"""Batched generation service loop: quantize, bucket, generate.

    python -m kubeflow_tpu_torch.examples.serve_batched --config tiny --int8

The PyTorch counterpart of ``examples/serve_batched.py``. Weights are a
random init from ``--seed`` on the card (``--device cpu`` runs on the
CPU), or ``--checkpoint DIR`` loads a Hugging Face checkpoint
(``models/convert.py``) with its tokenizer where ``transformers`` is
installed. ``--prompt TEXT`` (repeatable) sends text prompts through that
tokenizer, ending at its EOS, and prints the decoded text; it needs
``--checkpoint``, and a checkpoint whose tokenizer does not load exits
with the JAX message. Without ``--prompt``, three prompts of raw token
ids (5, 11 and 8 tokens, drawn with numpy from seed 0) are generated with
``batch_generate``, or with ``--paged``
through ``PagedBatcher`` (the alternating engine, 16-token blocks,
``--num-blocks`` of them). ``--int8``, ``--int4`` and
``--fp8`` quantize the projections and the lm head (``models/quant.py``;
at most one of them); with none given, KUBEFLOW_TPU_QUANT (the notebook's
``tpu-quantization`` annotation, as the webhook projects it) decides.
int4 groups 128 contraction values, as the JAX entry point does; a config
whose projections that group cannot split (the ``tiny`` ones, 128 wide)
exits with the JAX message. ``--kv8`` stores the KV cache as int8.
``--prompt-cache`` (identical prompts share their blocks) and
``--prefix-cache`` (common prefixes share blocks, only the tail is
prefilled) reach the ``--paged`` engine, at most one of them, as in JAX.
``--speculative N`` (greedy only) decodes through a draft of the model's
first N layers (``truncated_draft``): ``SpeculativePagedBatcher`` under
``--paged`` (the alternating engine, with the caches above), else
``SpeculativeContinuousBatcher`` (k_spec 4, a cache of bucket +
max_new_tokens + 5 positions), and prints the acceptance rate.

``--tp N`` runs the continuous, paged and speculative paths as one
tensor-parallel replica (``models/tp_serving.py``): this process starts
N - 1 more (this entry point again, with ``--tp-rank``/``--tp-port``),
each on ``cuda:<rank>`` over NCCL or, with ``--device cpu``, all over
gloo; every rank draws the weights whole, leaf by leaf, keeps its shard
and makes the same engine calls, and rank 0 prints. Without ``--paged``
or ``--speculative`` it serves ``ContinuousBatcher`` over a cache of
bucket + max_new_tokens positions, as the JAX entry point's plan path
does. Quantized weights under ``--tp`` exit (a tp plan cannot shard
them, nor can JAX's).

What the port lacks is refused before any weight is made, naming the
ROADMAP queue-1 item that brings it: ``--sp`` above 1 (item 13).
"""

from __future__ import annotations

import argparse
import sys


def _refusals(args) -> None:
    """Exit on every flag that asks for what the port lacks."""
    if args.sp > 1:
        raise SystemExit(
            "--sp: sequence-parallel KV shards are not ported to PyTorch "
            "yet (ROADMAP queue 1 item 13); drop it")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int4", action="store_true",
                    help="group-wise int4 weights (~4x fewer weight bytes)")
    ap.add_argument("--fp8", action="store_true",
                    help="e4m3 weight-only (2x fewer weight bytes)")
    ap.add_argument("--kv8", action="store_true",
                    help="int8 KV cache (halves per-token cache reads)")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged block-pool KV cache")
    ap.add_argument("--speculative", type=int, default=0, metavar="N")
    ap.add_argument("--num-blocks", type=int, default=64,
                    help="block-pool size for --paged (16-token blocks)")
    ap.add_argument("--prompt-cache", action="store_true",
                    help="(--paged) share identical prompts' KV blocks "
                         "and skip their re-prefill")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="(--paged) position-0-anchored admission: share "
                         "common PREFIX blocks across different-length "
                         "prompts, prefill only the unmatched tail")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prompt", action="append", default=None,
                    help="text prompt (needs --checkpoint's tokenizer); "
                         "repeatable")
    # A tensor-parallel run's other ranks: started by rank 0 only.
    ap.add_argument("--tp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if sum((args.int8, args.int4, args.fp8)) > 1:
        raise SystemExit("--int8/--int4/--fp8 are mutually exclusive")
    if args.prompt_cache and args.prefix_cache:
        raise SystemExit("--prompt-cache and --prefix-cache are mutually "
                         "exclusive (prefix subsumes identical prompts)")
    _refusals(args)
    if args.prompt and not args.checkpoint:
        # The JAX entry point serves its random token ids instead.
        raise SystemExit("--prompt needs --checkpoint: text prompts go "
                         "through the checkpoint's tokenizer")

    import torch

    from kubeflow_tpu_torch.device import resolve_device
    from kubeflow_tpu_torch.models import llama as L
    from kubeflow_tpu_torch.models import tp_serving
    from kubeflow_tpu_torch.models.quant import quant_bits_from_env

    # CLI flags win; otherwise the notebook runtime option applies.
    try:
        bits = ("fp8" if args.fp8 else 4 if args.int4 else 8 if args.int8
                else quant_bits_from_env())
    except ValueError as err:
        raise SystemExit(str(err))
    if args.tp > 1 and bits:
        raise SystemExit(
            "--tp: quantized weights cannot be sharded by a tp plan; "
            "drop the quantization (flag or KUBEFLOW_TPU_QUANT) or --tp")
    device = resolve_device(args.device)
    plan, rank, followers = None, 0, []
    if args.tp > 1:
        if not args.checkpoint:
            try:
                tp_serving.validate_serving_tp(
                    L.LLAMA_CONFIGS[args.config], args.tp,
                    n_devices=(torch.cuda.device_count()
                               if device.type == "cuda" else None))
            except ValueError as err:
                raise SystemExit(str(err))
        if args.tp_rank is None:
            args.tp_port, followers = tp_serving.spawn_followers(
                "kubeflow_tpu_torch.examples.serve_batched", argv, args.tp)
        else:
            rank = args.tp_rank
        device = tp_serving.init_replica_rank(args.tp, rank, args.tp_port,
                                              args.device)
        plan = tp_serving.serving_plan(args.tp)
    try:
        _generate(args, bits, device, plan, rank)
    finally:
        if plan is not None:
            torch.distributed.destroy_process_group()
        tp_serving.stop_followers(followers)


def _generate(args, bits, device, plan, rank) -> None:
    """Weights (this rank's shard under a plan), the engine, the run; rank
    0 prints."""
    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import llama as L
    from kubeflow_tpu_torch.models.quant import quantize_params
    from kubeflow_tpu_torch.models.serving import (
        GenerationConfig,
        batch_generate,
    )

    say = print if rank == 0 else (lambda *a, **kw: None)
    tokenizer = None
    if args.checkpoint:
        from kubeflow_tpu_torch.models.convert import load_hf_checkpoint

        cfg, params = load_hf_checkpoint(args.checkpoint, device=device,
                                         plan=plan)
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(args.checkpoint)
        except Exception as err:
            if args.prompt:
                raise SystemExit(
                    f"--prompt given but tokenizer load failed: {err}")
            say(f"# tokenizer unavailable ({err}); serving token IDs")
    else:
        cfg = L.LLAMA_CONFIGS[args.config]
        params = L.init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            device, plan=plan)
    if bits:
        try:
            params = quantize_params(params, free_source=True, bits=bits)
        except ValueError as err:
            raise SystemExit(str(err))
        label = bits if bits == "fp8" else f"int{bits}"
        say(f"{label} weight-only quantization applied", flush=True)
    kv_bits = 8 if args.kv8 else 0

    if args.prompt:
        prompts = [list(tokenizer(p)["input_ids"]) for p in args.prompt]
        eos = tokenizer.eos_token_id
        eos = -1 if eos is None else eos
    else:
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, size=n)]
                   for n in (5, 11, 8)]
        eos = 2
    gen = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature,
        top_p=0.95 if args.temperature else 1.0,
        eos_id=eos,
    )
    if args.speculative:
        from kubeflow_tpu_torch.models.speculative import (
            SpeculativeContinuousBatcher,
            SpeculativePagedBatcher,
            truncated_draft,
        )

        if args.temperature:
            raise SystemExit("--speculative is greedy-only (temperature 0)")
        try:
            dparams, dcfg = truncated_draft(params, cfg, args.speculative)
        except ValueError as err:
            raise SystemExit(str(err))
        bucket = 16 * ((max(len(p) for p in prompts) + 15) // 16)
        if args.paged:
            sb = SpeculativePagedBatcher(
                params, cfg, dparams, dcfg, gen=gen,
                slots=min(4, len(prompts)), num_blocks=args.num_blocks,
                block_size=16, prompt_bucket=bucket, kv_bits=kv_bits,
                prompt_cache=args.prompt_cache,
                prefix_cache=args.prefix_cache, plan=plan, device=device,
            )
        else:
            k_spec = 4
            sb = SpeculativeContinuousBatcher(
                params, cfg, dparams, dcfg, gen=gen,
                slots=min(4, len(prompts)),
                cache_len=bucket + gen.max_new_tokens + k_spec + 1,
                prompt_bucket=bucket, k_spec=k_spec, kv_bits=kv_bits,
                plan=plan, device=device,
            )
        rids = [sb.submit(p) for p in prompts]
        results = sb.run()
        outs = [results[r] for r in rids]
        say(f"speculative ({args.speculative}-layer draft, "
              f"{'paged' if args.paged else 'continuous'}): acceptance "
              f"{sb.acceptance_rate:.2f}")
    elif args.paged:
        from kubeflow_tpu_torch.models.paged import PagedBatcher

        bucket = 16 * ((max(len(p) for p in prompts) + 15) // 16)
        pb = PagedBatcher(
            params, cfg, gen=gen, slots=min(4, len(prompts)),
            num_blocks=args.num_blocks, block_size=16, prompt_bucket=bucket,
            kv_bits=kv_bits, prompt_cache=args.prompt_cache,
            prefix_cache=args.prefix_cache, plan=plan, device=device,
        )
        rids = [pb.submit(p) for p in prompts]
        results = pb.run()
        outs = [results[r] for r in rids]
        say(f"paged: {pb.free_blocks}/{args.num_blocks - 1} blocks free "
            "after run")
    elif plan is not None:
        # The plan path without --paged: continuous batching over a
        # head-sharded dense cache, as the JAX entry point's.
        from kubeflow_tpu_torch.models.continuous import ContinuousBatcher

        bucket = 16 * ((max(len(p) for p in prompts) + 15) // 16)
        cb = ContinuousBatcher(
            params, cfg, gen=gen, slots=min(4, len(prompts)),
            cache_len=bucket + gen.max_new_tokens, prompt_bucket=bucket,
            kv_bits=kv_bits, plan=plan, device=device,
        )
        rids = [cb.submit(p) for p in prompts]
        results = cb.run()
        outs = [results[r] for r in rids]
        say(f"tensor-parallel continuous batching: tp={plan.tp}")
    else:
        outs = batch_generate(params, cfg, prompts, gen, kv_bits=kv_bits)
    for i, out in enumerate(outs):
        if args.prompt:
            say(f"[{i}] {tokenizer.decode(out)}")
        else:
            say(f"[{i}] {len(out)} tokens: {out[:16]}"
                f"{'...' if len(out) > 16 else ''}")


if __name__ == "__main__":
    main()
