#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The port serves ``llama-3-8b`` at full width and depth (random weights
from a seed) behind ``InferenceServer`` on its main paths, each run with
every kernel's launch count set to 0 just before it and read just after:

- the ragged engine, ``PagedBatcher(ragged=True)``, whose every step runs
  ``kubeflow_tpu_torch/csrc/ragged_attention.cu`` in each layer;
- the alternating engine, ``PagedBatcher(ragged=False)`` (what the server
  runs when ``KUBEFLOW_TPU_SERVING_RAGGED`` is unset), whose admissions
  prefill through ``csrc/flash_attention.cu`` and whose decode steps run
  ``csrc/paged_attention.cu``, each once per layer;
- the continuous engine, ``ContinuousBatcher`` over a dense bf16 cache of
  1024 positions per slot (what ``serve_http`` runs without ``--paged``),
  whose admissions prefill through ``csrc/flash_attention.cu`` and whose
  decode steps run the dense decode kernel of ``csrc/paged_attention.cu``,
  each once per layer;
- quantized weights: ``models/quant.py``'s ``quantize_params`` (int8,
  int4, fp8) on the same model, served by the ragged engine under each
  scheme and by the continuous engine under int8 (what ``serve_http
  --int8`` serves), whose decode steps run every projection and the lm
  head through ``csrc/quant_matmul.cu`` (7 × n_layers + 1 launches a
  step) and whose wider products (admissions) through the wide path;
- the rest of the paged engine on the alternating engine: the prefix
  cache (its tails prefill on the gathered view, its decode steps run
  ``csrc/paged_attention.cu``), the prompt cache (a miss prefills through
  ``csrc/flash_attention.cu``), the host-RAM swap tier, and KV payloads
  handed to an alternating and a ragged engine (whose decode runs the
  paged and the ragged kernel), in process and over ``/kv/*``;
- speculation and multi-LoRA: ``SpeculativePagedBatcher(ragged=True)``
  over a draft of the model's first 8 layers (``serve_http``'s cut), whose
  every verify dispatch runs ``csrc/ragged_attention.cu`` in each layer
  at spans of 5 rows a slot and whose draft primes prefill through
  ``csrc/flash_attention.cu``; the alternating and continuous spec
  engines; ``MultiLoraPagedBatcher`` serving two adapters and base in one
  ragged batch, and both behind the server;
- a Hugging Face checkpoint of the served weights (``models/convert.py``'s
  ``load_hf_checkpoint``) served by ``examples/serve_http.py --checkpoint``
  over the ragged engine (``csrc/ragged_attention.cu``) and the continuous
  one (``csrc/flash_attention.cu``, the dense decode kernel), with the
  server's tracing, flight recorder, stall capture and metrics mirroring;
- training, ``models/train.py``'s ``make_train_step`` (remat "full", loss
  chunk 512, AdamW) at B 1, S 2048, of ``llama-3-8b`` (head dim 128) and
  then ``gemma-2b`` (head dim 256), whose every step runs the flash
  forward kernel twice per layer (forward and the remat recompute) and
  the dQ and dK/dV kernels of ``csrc/flash_attention_bwd.cu`` once each
  (dK/dV: the per-q-head kernel and its group sum, one wrapper call);
- finetuning ``llama-3-8b`` at B 1, S 2048 on batches from the native
  ``TokenLoader``: ``models/lora.py``'s ``make_lora_train_step`` (rank 8 on
  wq and wv, the base frozen) and ``make_train_step(fp8=True)`` over the
  same masters (``models/fp8.py``: every projection's products with fp8
  operands through ``torch._scaled_mm``), each step running the same
  three flash kernels as training, and ``examples/finetune_lora.py`` as a
  user runs it;
- resuming after a preemption (``runtime/``): a child process, started
  from the env of the single-card H100 pod the port's controller loop
  makes for its notebook (``k8s/``, ``webhook/gpu_env.py``,
  ``controller/notebook.py``), trains ``gemma-2b`` on the card (the same
  three flash kernels a step) under ``bootstrap`` and
  ``install_preemption_handler``; the loop's culler (``controller/
  culling.py``, its native prober built here) stops the idle notebook,
  the reconciler scales it to 0, and the child is sent SIGTERM and
  emergency-saves its newest step; the step is restored on the card
  through ``MigrationOrchestrator`` and trained from;
- sharded training (``models/train.py`` under a ``MeshPlan``):
  ``gemma-2b`` at fsdp=2 and ``llama-3-8b`` at tp=2, each as two gloo
  ranks on the one card, every step the same three flash kernels a layer
  over a rank's rows or heads, the fsdp state saved and restored in
  JAX's shard format, and ``examples/train_sharded.py`` as a user runs
  it;
- sequence, pipeline and expert parallelism, each as two gloo ranks on
  the one card: ``gemma-2b`` trained under sp=2 with ring, Ulysses (its
  local attention the flash forward and backward kernels) and zigzag
  attention and under pp=2 (the GPipe schedule, each stage's layers
  running the same three kernels), a Mixtral-style MoE at full width
  under ep=2, and ``llama-3-8b`` served by ``ContinuousBatcher`` over a
  cache cut along the sequence (admissions through the flash kernel, the
  split-KV decode plain, as in JAX);
- the fleet: the port's gateway in front of two ``serve_http`` replica
  processes of ``llama-3-8b`` on the card (the alternating engine with
  the prefix cache: the flash kernel on admissions, the paged decode
  kernel in each step), fused and disaggregated over ``/kv/*``, with an
  autoscaler's scale-down; and serving under a dp or fsdp mesh, each as
  two gloo ranks on the one card (the ragged, flash and paged decode
  kernels a layer, the fsdp-cut weights gathered at use).

Phases, in order; any failure raises and the script exits non-zero:

1. card — needs ``torch.cuda.is_available()`` and drives one card (the
   first visible one); prints the card's ``nvidia-smi`` name and power
   limit; turns TF32 off;
2. build — compiles every ``csrc/*.cu`` with ``nvcc``, one process per
   source, all at once, and prints ptxas's register / shared-memory /
   spill lines for each;
3. kernel vs plain — each kernel's wrapper against its plain PyTorch
   version (kept in f32) on the same inputs, held to three gates: max abs
   error <= 2e-2; element by element
   ``|out - ref| <= 2^-7 · (|ref| + ref_abs)``, where ``ref_abs`` is the
   plain version over ``|v|`` (the size of the weighted sum before any
   cancellation); for each row and q head ``‖out - ref‖ <= 2^-6 · ‖ref‖``
   over the head dim. Ragged attention: the span layouts of the CPU suite
   and one main-path shape, then tiles over several of the kernel's runs
   of keys (a causal bound at a run boundary and one key either side, a
   masked span longer than a run, an idle slot with a stale kv_len beside
   split slots, one row over 8192 keys, 8 rows over 512..4096 keys,
   32-token q-tiles, head dims 64 and 256, and the speculative verify
   spans: 8 slots × 5 rows over 8..564 keys and over 512..4096 keys at
   the engine's 64-row width; GQA group 1 at llama-2-7b's and gemma-7b's
   heads and group 8 at gemma-2b's, over several runs and over
   512..4096 keys), bf16 and int8 pools, on owned rows; unowned rows
   exactly 0; each case run twice, its output equal bit for bit. Flash forward: the CPU suite's cases, the main-path
   prefill (Hq 32, Hkv 8, Sq = Sk = 512, D 128, causal, left padding), a
   shape past the TPU's 4 MB whole-K/V line (Sq = Sk = 16384), window
   cases, a 528-row continuation, head dims 64 and 256 and GQA groups of 1
   and 8; lse within 1e-3 where a row sees a key, and <= -1e29 with O = 0
   where it sees none; each case run twice, its O and lse equal bit for
   bit. Paged decode: the CPU
   suite's layouts and the main-path decode (8 slots, lengths 8..576),
   an idle slot and a stale length. Dense decode: the CPU suite's layouts
   and the main-path decode (8 slots, C 1024, lengths 8..576), a mask with
   a hole, an idle slot (all-False row, exactly 0) and a slot at
   seq_len == C. Both decode kernels also: lengths at a boundary of
   their runs of keys and one either side, a masked span longer than a
   run, an idle slot and a stale length beside slots over several runs,
   head dims 64 and 256, gemma-2b's heads (group 8) and GQA group 1 at
   llama-2-7b's and gemma-7b's heads over several runs, and at
   llama-3-8b's heads 8 slots of 512..4096 keys and one of 8192; each
   case run twice, its output equal bit for bit. Flash backward (dQ,
   dK/dV) on the forward kernel's O and lse, against its plain f32
   version: the CPU suite's cases (among them
   a group of 8 q heads per kv head with a q_offset, and a group of 1
   with left-padded keys), the training shape (Hq 32, Hkv 8, S 2048,
   D 128, causal), a window with a q_offset, a left-padded mask, rows
   that see no key and head dim 64, and at head dim 256 gemma-2b's
   training shape (Hq 8, Hkv 1, S 2048, causal), its heads with a
   q_offset, a left-padded mask with a window and rows that see no key;
   each of dq, dk and dv held to
   ``BWD_GATES`` (max error over max |ref| and a per-(row, head) norm
   gate, both 2^-6, derived where they are defined), with dq exactly 0 on
   rows that see no key and dk, dv exactly 0 on keys no row sees; and
   each case run twice, its dq, dk and dv equal bit for bit.
   quant_matmul: llama-3-8b's weight shapes (wq/wo, wk/wv, w_gate/w_up,
   w_down, the lm head) and two odd ones (N 1040, V 1000), each under
   int8, int4 (group 128) and fp8, at 1, 8 and 16 rows, against the
   plain version on the card (cuBLAS with f32 reductions), held to
   ``QUANT_GATES`` (element by element 2^-7 of |ref| plus the
   cancellation-free product, per row 2^-8); each call twice, bit-equal;
   one traced call a weight and scheme must be one launch of the kernel
   with ``kernel_ctas``' CTAs and no other kernel (no cast, no copy);
4. timing — CUDA events at the main-path shapes (L2 flushed between
   launches; the median of each run of launches): each kernel, its plain
   version, and one library call (a
   yardstick the port never calls: ``scaled_dot_product_attention`` over
   a per-slot batched view, with ``enable_gqa`` for the flash and decode
   kernels), beside the least time the card could take (bytes over 3.35
   TB/s, FLOPs of the visible pairs over 989 TFLOP/s); ragged attention
   at the shapes the ragged engine runs (``RAGGED_TIMED``: an admission
   step of 512 rows, the width-8 decode step, 8 slots of 512..4096 keys,
   one slot of 8192, a 512-row chunk over 4096 keys, the spec engine's
   verify round of 8 × 5 rows over 8..564 and over 512..4096 keys; int8
   at the first two and the verify rounds), each with the CTAs and kernels its call launched (read from a
   profiler trace and checked: one launch of the split grid), against
   the decode SDPA yardstick where every sequence has one row; both decode
   kernels at the main-path decode, 8 slots of 512..4096 keys and one
   slot of 8192, each with the CTAs and kernels its call launched (read
   from profiler traces) and SDPA by its own dispatch, the keys cut to
   the live prefix where that is the whole visibility (else the
   visibility as a mask), the backend that ran named from its kernels;
   the paged kernel's main-path keys also gathered into a dense cache
   and timed through the dense kernel; the flash forward at the
   main-path prefill, a 528-row continuation, the training shape and
   S 16384, against SDPA with ``is_causal`` wherever that states the
   case's visibility (square, causal, q_offset 0, no window, no mask),
   else with the visibility as a boolean mask, and with the CTAs its
   launch ran, read from a profiler trace; the backward kernels
   at llama-3-8b's and gemma-2b's training shapes, each alone (dQ, dK/dV
   and the SDPA backward in three rounds taken in turns, with the CTAs
   each launch ran), and together with delta and padding beside one SDPA
   backward (flash backend with ``enable_gqa`` where it takes the shape;
   dq, dk and dv in one call); quant_matmul at 8 rows for each weight
   shape and scheme, beside its bound (q, s, x and the output over 3.35
   TB/s), its plain version and ``torch.matmul`` on the bf16 weight of
   the same shape (what the bf16 engine runs), and at 512 rows the wide
   path beside ``torch.matmul`` on the bf16 weight;
5. engines — 16 prompts of 8..500 tokens, 64 new tokens each: the ragged
   engine with a bf16 and an int8 pool, where launches must equal
   ``ragged_steps × n_layers``; the alternating engine with a bf16 pool,
   where flash launches must equal ``_paged_admit`` calls × n_layers and
   decode launches ``_paged_step`` calls × n_layers (calls counted here,
   by wrapping the two functions); the continuous engine (8 slots, cache
   1024, bucket 512), where flash launches must equal ``_admit_slot``
   calls × n_layers and dense decode launches ``_cb_step`` calls ×
   n_layers. 4 prompts are then served again with the kernels and with
   plain attention (``attn_kernel=False``, and for the alternating and
   continuous engines' prefill ``impl="xla"``) and compared (tokens equal,
   or a fork after the first token with chosen-token logprobs before it
   within 2e-2); the continuous engine serves them once more with chunked
   admission (``admit_chunk=128``), compared to one-shot admission by the
   same rule; last, 8 prompts are served once more, 16 new tokens each,
   under ``torch.profiler``, and that one run's trace gives the card's busy
   time, idle share and time by kernel. Then the quantized engines
   (``quant_engine_phase``) on the same 16 prompts: launches must equal
   (7 × n_layers + 1) for each step of at most 16 rows plus one lm-head
   launch for each wider step (ragged), or for each decode step plus one
   for each admission (continuous), and wide-path products 7 × n_layers
   for each wider step or admission; 4 prompts are served again with
   every quantized product through its plain version and compared as
   above; 8 prompts traced again (16 new tokens each), the wide path's
   products on a stream
   of their own, for the card's busy time, idle share, quant_matmul's
   seconds and the wide path's kernels' seconds: together the weight
   products (each trace read from its chrome trace);
6. HTTP — 4 concurrent ``/v1/completions`` (2 streamed) against the
   server over each bf16 engine; streamed tokens must equal the blocking
   response for the same prompt; then ``/stats`` and a clean stop. The
   server mirrors into the port's ``Metrics`` bundle
   (``metrics/metrics.py``, its own registry): after the stop,
   ``/metrics`` is scraped from a ``MetricsServer`` and every
   ``STATS_PARITY`` family the server mirrors (``SERVER_FAMILIES``: shed,
   cancelled, deadline, drain, batch fill, stalls, prefix cache, swap,
   speculation, LoRA) must equal its ``/stats`` value, or read 0 where
   ``/stats`` has no such block;
7. prefix and handoff — the rest of the paged engine on the same model,
   alternating engines of 8 slots, block 16, bucket 512, 64 new tokens:
   the prefix cache over a pool that evicts nothing (512 blocks) serves
   16 prompts sharing a 384-token prefix (tails of 8..116 tokens): 360
   prefix hits, paged decode launches equal to ``_paged_step`` calls ×
   n_layers and no flash launch (the tails prefill on the gathered
   view), tokens held to the engine without a cache by phase 5's rule;
   the prompt cache serves 8 identical prompts with one prefill (n_layers
   flash launches) and 7 hits; a one-slot pool of 40 usable blocks with a
   host tier of 32 blocks (64 MiB) serves a prefix, a second one (which
   demotes the first one's leaves) and the first again: blocks promoted,
   16 restored tokens each, each promoted block byte-equal to its
   snapshot before demotion, tokens held to the first round's; engine A
   exports 4 prompts (200..500 tokens) at their first token, and an
   alternating engine B, then a ragged one, imports them (every shipped
   block byte-equal to the payload in B's pool), decodes them (paged
   decode, or ragged, launches as in phase 5; no prefill) and is held to
   A's fused run; over HTTP a ``tier_role="prefill"`` server's
   ``/kv/prefill`` payload streamed by a decode server through
   ``kv_import`` (its body cap raised to fit) equals a fused server's
   blocking response, ``/kv/probe`` counts the warmed prefix,
   ``/kv/chain`` → ``/kv/chain/import`` registers it on a cold server
   (whose completion then hits it), and ``/stats`` carries the
   ``prefix_cache``, ``kv_swap`` and ``kv_handoff`` blocks; each of the
   four servers mirrors into a ``Metrics`` bundle of its own, held to its
   ``/stats`` as in phase 6 after the stop. Smoke numbers,
   not a benchmark's, beside the card line: cold and prefix-hit admission
   seconds (median of 5), export and import seconds and MB of the
   500-token payload, swap-out and swap-in µs a block (medians);
8. speculation and multi-LoRA — on the same model, a draft of its first
   8 layers (``truncated_draft``, sharing its modules): the ragged
   ``SpeculativePagedBatcher`` (k_spec 4, phase 5's engine and 16 prompts)
   over a bf16 and an int8 pool, where ragged launches must equal verify
   dispatches × n_layers and flash launches draft primes × 8 (no other
   attention kernel), the free blocks must come back, and the tokens are
   held to phase 5's plain ragged run by its near-tie rule (equal, or at
   the first fork the two tokens' logprobs under a plain forward of the
   common prefix within 2e-2); one round with rejections, whose every
   rejected cell (int8 scales too) must be its snapshot's bytes; a
   self-draft (the target as its own draft) on 4 prompts accepting at
   least 0.9, each rejection a near-tie; the alternating and the continuous spec engines (as
   ``serve_batched --speculative`` builds the latter) on 4 prompts, no
   decode kernel, flash launches = prefills' layers; then
   ``MultiLoraPagedBatcher`` (a hot cache of one slot) serving two rank-16
   adapters on all seven targets (drawn from the seed, each delta ~3% of
   its projection's output) and base over 12 prompts in one batch:
   launches as phase 5, the cache's churn, peak memory, each adapter's
   rows held to a plain engine over ``merge_lora`` (one merged copy at a
   time) and base rows to phase 5's run by the near-tie rule (a fork's
   forward over the merged model; logprobs before it within 2e-2); over
   HTTP, each adapter and base at once, blocking and then streamed
   (streamed = blocking; two-token prompts keep each round at one
   dispatch width), an unknown ``model`` 400, ``/v1/models`` listing all
   three, and over the spec engine ``/stats``' ``speculative`` block and
   a 400 for ``logprobs``. Smoke numbers beside the card line: acceptance,
   rounds, the 16 prompts' wall against the plain engine's, the verify
   dispatch widths;
9. checkpoint and observability — phases 5-8's engines are freed and the
   served weights (llama-3-8b, 16.06 GB of bf16) written as a Hugging Face
   checkpoint by ``write_hf_checkpoint`` (``params_to_hf_state_dict``:
   HF's names and layout, ``config.json``, 4 safetensors shards and their
   index) into a temporary directory, removed at the end;
   ``load_hf_checkpoint(dir, device="cuda")`` must give every leaf bit for
   bit, with the host's resident memory growing by less than a quarter of
   the checkpoint and 64 MB (the load streams). Then ``python -m
   kubeflow_tpu_torch.examples.serve_http --checkpoint DIR --paged`` as a
   process with phase 6's ragged engine flags, KUBEFLOW_TPU_SERVING_RAGGED
   =1, KUBEFLOW_TPU_TRACE_RING=512 and KUBEFLOW_TPU_STALL_PROFILE_DIR:
   once ``/healthz`` answers, phase 6's 4 requests (2 streamed), each
   under a ``traceparent`` of its own, must give phase 6's ragged tokens
   (cut at serve_http's end of sequence, 2); ``/debug/traces`` must hold
   under each sent trace the ``server.request`` span (a child of the
   sender's), and ``queue_wait``, ``prefill`` and ``first_decode`` under
   it, summing to the request's TTFT within 10%, and ``engine.step``
   spans as roots; ``/stats`` its flight recorder (steps = the engine's
   ragged steps) and ``engine_step_stalls``; SIGTERM must drain it to
   exit 0. The same without ``--paged`` (the continuous engine) on the 2
   blocking requests, held to phase 6's continuous tokens. Both are sent
   token ids (the checkpoint holds no tokenizer). Last, in process, the ragged
   engine behind ``InferenceServer`` with stall capture armed and a
   recording metrics bundle serves phase 5's 16 prompts; after 16 steps
   one step sleeps (20 × the median step, at least 0.5 s): one stall
   counted, one capture whose trace holds the ragged kernel, ragged
   launches = steps × n_layers, and the bundle reads what ``/stats``
   reads. Smoke numbers beside the card line: write and load seconds and
   GB/s, the host's resident growth, the seconds to ``/healthz``, TTFT
   from the span sums beside ``/stats``' ``ttft_s``;
10. train — the serving model is freed, then llama-3-8b and
   after it gemma-2b, each at full width and depth, train from random
   bf16 weights on batches of a
   numpy corpus through the port's ``TokenLoader``: step 1's loss and
   grads with the kernels against plain attention (``impl="xla"``): loss
   and global grad norm within 2e-2 relative; layer 0's and the last
   layer's wq grads at cosine >= 0.99 with the backward kernels under the
   plain forward, and with every kernel wherever plain attention nudged
   by one bf16 rounding of its output stays inside that cosine (llama-3-8b
   does; gemma-2b's random-weight wq grads do not, so there the
   all-kernels cosine is printed beside the nudge's); then 3 optimizer
   steps, each with
   exactly 2 × n_layers flash forward, n_layers dQ and n_layers dK/dV
   launches, after which the loss on step 1's batch must be finite and
   below step 1's. Peak memory and tokens/s are printed as a smoke run's,
   not a benchmark's. Last, once, a ``tiny`` bf16 trainer state on the card
   goes through save → ``restore_latest`` and must come back byte-equal;
11. finetune — (a) fp8 products at llama-3-8b's shapes, 2048 rows through
   wq (4096²), w_gate (4096×14336) and w_down (14336×4096): the card's
   e4m3 casts of x and w and e5m2 cast of g equal the CPU's byte for
   byte; the forward (e4m3 × e4m3), dx (e5m2 × e4m3) and dw (e4m3 ×
   e5m2) through ``fp8_product`` (``_scaled_mm``, unit scales, f32 out)
   with JAX's epilogue (divide by the two scales, cast to bf16) held to
   GATES against the plain version (the fp8 operands upcast, f32
   ``torch.matmul``); each timed (median of 20, L2 flushed) beside
   ``_scaled_mm`` alone on operands already in its layouts, bf16
   ``torch.matmul`` at the same shape, the product's own amax, cast and
   epilogue passes, and its bound (FLOPs over 1979 TFLOP/s, dense fp8, or
   bytes over 3.35 TB/s). (c) llama-3-8b at full width and depth, random
   bf16 weights from the seed, 3 batches of (1, 2048) from the native
   ``TokenLoader``: rank-8 bf16 adapters on wq and wv, lr 1e-3; at b = 0
   the adapted loss equals the base loss bit for bit; step 1's b grads
   with the kernels at cosine >= 0.99 against plain attention; 3 steps,
   each 2 × n_layers flash, n_layers dQ and dK/dV launches and no fp8
   product; every base weight byte-equal after, the adapters moved, the
   loss on step 1's batch lower. (b) The same masters wrapped for fp8
   (remat "full", loss chunk 512, AdamW): step 1's loss within 0.15 of
   the bf16 model's on the same batch (JAX's bound); 3 steps, each 2 ×
   n_layers flash, n_layers dQ and dK/dV and 4 × 7 × n_layers
   ``_scaled_mm`` launches; after step k every history holds k
   observations (the x and w ones non-zero; a g one is 0 where e5m2 at
   the delayed scale flushed the whole gradient, as JAX's arithmetic
   does, and the count is printed); the masters stay bf16; the loss
   falls. Then
   ``examples/finetune_lora.main`` with no ``--device`` over a 2-layer
   model at head dim 64 (the tiny configs' 32 is not a head dim the
   kernels take) written as an HF checkpoint, 2 steps and ``--export``:
   launches 2 × 2 × 2 flash, 4 dQ, 4 dK/dV; the export holds the
   checkpoint's keys and shapes with only q_proj and v_proj moved. Peak
   memory and step walls print as a smoke run's;
12. resume — gemma-2b at full width cut to 4 of its 18 layers
   (``RESUME_LAYERS``; its checks do not depend on depth). MemAvailable
   and the free disk must each hold 2.5 × its train state (~5.8 GB: bf16
   params and two bf16 AdamW moments).
   The child's pod comes from the port's controller loop first
   (``resume_pod``): a Notebook with ``spec.gpu: {accelerator: h100,
   topology: "1"}`` and the checkpoint grace (120 s) and directory
   annotations is created in a ``FakeCluster`` on a ``FakeClock`` whose
   Notebook mutating hook is ``mutate_gpu_notebook``, over one node of
   the card's catalog entry (``add_gpu_node_pool``), with ``FakeKubelet``,
   ``NotebookReconciler`` and ``CullingReconciler`` under one
   ``Manager`` and one ``Metrics`` bundle; the pod the kubelet made must
   have ``nvidia.com/gpu`` "1" in limits and requests, the nodeSelector
   the h100 label, the toleration ``nvidia.com/gpu``,
   terminationGracePeriodSeconds 150, and be Running, and the Notebook's
   ``status.gpu`` must read 1 ready host, "Healthy". On the card, the
   card's ``total_memory`` must be at least 0.95 of the catalog entry's
   80 GiB.
   A child (``python -c`` on ``resume_child``, its env the parent's with
   that pod's container env over it, the downward API's pod index filled
   in from its index label) calls ``bootstrap(expected_devices=<the rendered nvidia.com/gpu
   limit>)``, makes a ``CheckpointManager``
   in ``checkpoint_dir_from_env()`` (interval 100, async, keep 2),
   ``install_preemption_handler`` and trains the cut gemma-2b (B 1, S
   2048, remat "full", AdamW, TokenLoader batches) 3 steps,
   each followed by ``save``: step 1 commits on the worker thread, 2 and
   3 are pending only. After each ``save`` it prints the step's wall, the
   ``save`` call's wall (the host copy), the step's launches (2 × 4
   flash, 4 dQ, 4 dK/dV) and every leaf's digest on the card (the sum
   of its bytes, and of each byte times its position mod 2^31 − 1), then
   waits in ``signal.pause()``. With the child running,
   ``notebook_create_total`` must read 1, ``tpu_slice_ready_seconds`` a
   count of 1 and ``collect_running`` 1 card; then (``cull_pod``) a
   loopback stub of Jupyter's ``/api/kernels`` and ``/api/terminals``
   reports an idle kernel, the loop's clock moves past the culler's idle
   time (``RESUME_IDLE_MIN``), the culler probes it through its DEV proxy
   and sets the stop annotation, the reconciler scales the StatefulSet
   to 0 and the kubelet deletes the pod: ``notebook_culling_total`` and
   ``tpu_chips_reclaimed_total`` must read 1 and ``collect_running`` 0
   cards, in one HTTP scrape of a ``MetricsServer``; the native prober
   (``csrc/host/prober.cpp``, built with g++ here) probes the stub and
   must fold to the Python prober's ``HostActivity``. The phase turns
   that scale-to-0 into the child's SIGTERM: it must die of it (-15)
   within the grace + 5 s and under the pod's
   terminationGracePeriodSeconds, its log naming the emergency commit of
   step 3;
   steps 1 and 3 are on disk and step 3's manifest holds the cursor. The
   parent restores on the card into ``fresh_state(7)`` through a
   ``MigrationOrchestrator(MigrationConfig(fresh_within_s=0))`` whose
   save step finds nothing newer (restore budget 600 s); every leaf's
   digest must equal the child's step 3, and a leaf
   may equal the fresh state's only where both inits agree (under 1% of
   the bytes); ``resume_start_batch`` gives 3; one step from the restored
   state on the loader's 4th batch launches 2 × 4 flash, 4 dQ and 4
   dK/dV kernels with a finite loss. It prints the emergency save's
   seconds and GB/s, each ``save``'s snapshot seconds, the restore's
   seconds split into validation and copy, SIGTERM to exit, and the
   migration's step durations;
13. tp — tensor-parallel replicas (``models/tp_serving.py``). First one
   launch each of the ragged, flash, paged decode and dense decode
   kernels at a tp=2 rank's shapes of llama-3-8b (16 q, 4 kv heads),
   held to their plain
   versions by phase 3's gates. (a) Degree 2 on the one card: two child
   processes (``python -c`` on ``tp_child``), each one rank of a gloo
   group of 2 it builds itself, both on ``cuda:0`` — this phase's own
   configuration (one card holds both ranks; gloo stages the CUDA
   tensors through the host), not a fallback. Each draws llama-3-8b from
   the seed leaf by leaf and keeps its shard (16 of 32 q heads, 4 of 8 kv
   heads, 7168 of 14336 hidden, half the vocab), then serves 8 of phase
   5's prompts (every other one), 32 new tokens, on the ragged bf16
   engine (8 slots, budget 512) and 4 of them on the alternating and the
   continuous engines, with ``plan=``: per rank, ragged launches = ragged
   steps × 32, flash = admissions × 32, paged (alternating) or dense
   (continuous) decode = decode steps × 32; both ranks emit
   the same tokens, held to phase 5's (its first 32) by phase 8's
   near-tie rule, a fork's gap from a tp forward of the common prefix
   with plain attention. (b) Degree 1 over NCCL in this process: an
   explicit ``MeshPlan(make_mesh(tp=1))`` on a world-1 NCCL group (the
   backend of real multi-card replicas; its collectives are the
   identity) and the ragged engine on phase 5's 16 prompts give phase 5's
   tokens and logprobs bit for bit, launches = steps × 32, with the host
   seconds in the functions that call the collectives. It prints each
   rank's peak memory, the phase's seconds split into spawn, init and
   serve, and tokens/s at degree 2 and 1 beside phase 5's;
14. train_sharded — sharded training (``models/train.py`` under a
   ``MeshPlan``, ``parallel/collectives.py``). (0) One launch each of the
   flash forward, dQ and dK/dV at a tp=2 rank's training shape of
   llama-3-8b (B 1, S 2048, 16 q / 4 kv heads, D 128), held to their
   plain versions by phase 3's gates. (a) fsdp=2 gemma-2b at full width
   cut to 6 of its 18 layers (``TS_FSDP_LAYERS``, the cut that pays for
   phase 16) as two gloo children on ``cuda:0`` (phase 13's one-card
   configuration): before spawning, this process runs one unsharded
   step 1 on the same weights and global batch (B 2, S 2048: each rank's
   row from ``sharded_loader`` through ``device_put_global``) and frees
   it; each rank draws its shard from the seed (``init_params(plan=)``),
   shards AdamW (``shard_state``: half the state a rank), and trains 2
   steps (remat "full", loss chunk 512), step 1's loss and global grad
   norm within 2e-2 relative of the unsharded step's, each step 2 × 6
   flash, 6 dQ and 6 dK/dV launches a rank, the loss on step 1's
   batch lower after; then both ranks save into their ``proc<k>/`` roots
   (JAX's shard format; MemAvailable and the free disk must hold 2.5 ×
   the state), restore into a fresh sharded state from another seed
   with every leaf's digest equal, and train one step more (the roots
   are removed after). (b) tp=2 llama-3-8b, two gloo children again, on
   phase 10's weights and step-1 batch: step 1's loss and grad norm
   within 2e-2 of phase 10's (recorded there), 2 steps of 2 × 32 flash,
   32 dQ and 32 dK/dV launches a rank. (c) ``examples/train_sharded.main``
   as one rank over a world-1 NCCL group: phase 11's 2-layer head-dim-64
   model for 2 steps with ``--ckpt-dir`` and ``--data``, then again,
   resuming at step 2. It prints each rank's peak memory, step walls,
   bytes, calls and host seconds in the collectives a step, the save and
   restore seconds and GB/s a rank, and the phase's seconds split into
   reference, spawn, init, train and checkpoint;
15. sp_pp_ep — sequence, pipeline and expert parallelism
   (``parallel/ring_attention.py``, ``ulysses.py``,
   ``zigzag_attention.py``, ``pipeline.py``, ``models/moe.py``). (0) One
   launch each of the flash forward, dQ and dK/dV at an Ulysses rank's
   training shape of gemma-2b under sp=2 (B 2, 4 q / 4 kv heads after
   the K/V broadcast: group 1, S 2048, D 256), held to their plain
   versions by phase 3's gates. Then this process runs (c)'s unsharded
   step 1 (mixtral-8x7b at full width — dim 4096, ffn 14336, 8 experts,
   top-2 — cut to 2 of its 32 layers, random weights from the seed, B 1,
   S 2048) and frees it, and spawns two gloo children on ``cuda:0``
   once (phase 13's one-card configuration), which run in turn, freeing
   each part's memory: (a) phase 14 (a)'s cut gemma-2b under sp=2,
   each rank the whole state and 1024 of the 2048 positions of phase 14
   (a)'s batch: step 1 under each of ``ring``, ``ulysses`` and
   ``zigzag``, its loss and global grad norm within 2e-2 relative of
   phase 14 (a)'s unsharded step 1 (recorded there); Ulysses launches 2 ×
   6 flash, 6 dQ and 6 dK/dV a rank, ring and zigzag none (plain, as
   JAX's); (b) the same model and batch under pp=2 (3 layers a stage,
   n_micro 2, remat "full", the dense loss over full logits): step 1's
   loss and grad norm within 2e-2 of the same reference, 2 × 6 flash, 6
   dQ and 6 dK/dV a rank (bubbles skipped); (c) the cut mixtral-8x7b
   under ep=2, 4 of the 8 experts a rank: step 1's loss (the aux term
   included) and grad norm within 2e-2 of this process's, 2 flash, 2 dQ
   and 2 dK/dV a rank; (d) llama-3-8b at full width and depth served by
   ``ContinuousBatcher`` under sp=2 (each rank the whole weights and 512
   of every slot's 1024 positions, bucket 512): phase 5's 4 continuous
   prompts, 32 new tokens each, held to phase 5's continuous tokens (its
   first 32) by the near-tie rule; flash launches = admissions × 32 a
   rank, no decode kernel (the split-KV decode is plain, as JAX's). Both
   ranks agree on every loss, launch count and token. It prints each
   part's peak memory a rank, the step walls, and the collective calls,
   bytes and host seconds a step, with the port's own host staging of
   gloo's point-to-point and all-to-all transfers.
16. fleet_mesh — (a) the fleet (``models/gateway.py``,
   ``models/autoscaler.py``, ``observability/signals.py``): two
   ``serve_http`` replica processes of llama-3-8b at full width and depth
   (random weights from the seed, each its own copy on the one card),
   the alternating paged engine with the prefix cache (the ragged engine
   refuses the prefix cache, as JAX's does) and a pool of 1024 blocks of
   16 each, sized explicitly so that both fit, and the port's
   ``ServingGateway`` in front of them in this process. Four prompts that
   share a 256-token system prompt and two that do not, 16 new tokens
   each, one at a time: first to one replica directly, then through the
   gateway, every prompt blocking and then every prompt streamed, held
   to the direct tokens by phase 5's near-tie rule (the weights drawn
   here only to judge a fork); on the first pass the shared-prefix
   prompts after the first land on one replica, whose
   ``/stats`` prefix cache counts at least two prompts' worth of hits;
   one trace runs from the gateway's ``gateway.request`` through
   ``gateway.route`` to the replica's ``server.request`` and ``prefill``
   (its ``/debug/traces``). Then ``tier_mode="disagg"`` (the first
   replica the prefill tier, the second the decode tier): each prompt
   streamed, its tokens held to the fused streams by the same rule,
   every handoff over ``/kv/*`` made, its bytes and seconds printed.
   Last, a stream through each replica (64 new tokens), and a
   ``FleetAutoscaler`` whose provisioner this script defines
   (``SmokeProvisioner``) drains one: it leaves the ring at once, a
   request sent then goes to the other, its stream runs to its end, and
   it is released (SIGTERM) once idle. (b) llama-3-8b at full width cut
   to 4 of its 32 layers, served by the ragged and the alternating
   engine under fsdp=2 and then dp=2 as two gloo children on ``cuda:0``
   (phase 13's one-card configuration; the step replicated over the
   mesh, as JAX's, each fsdp-cut leaf gathered where it is used): 2 of
   phase 5's prompts, 4 new tokens each, held to the unsharded engines'
   on the same cut model (run here first) by the near-tie rule, with
   ragged launches = steps × 4, flash = admissions × 4 and decode =
   steps × 4 a rank, the pool whole over both axes; an fsdp=2 rank holds
   under 0.55 of the model's weight bytes, a dp=2 rank all of them. It
   prints each rank's weight bytes and peak memory, the step walls, the
   bytes gathered and the host seconds in collectives a step, and the
   kernels launched a rank.

It prints a ``{"fp8_products": ...}`` line (a library call, not a kernel
of the port), a ``{"resume": ...}`` line (phase 12's numbers), a
``{"tp": ...}`` line (phase 13's numbers), a ``{"train_sharded": ...}``
line (phase 14's numbers), a ``{"sp_pp_ep": ...}`` line (phase 15's
numbers), a ``{"fleet_mesh": ...}`` line (phase 16's numbers), a
``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import http.server
import io
import json
import math
import os
import secrets
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
from torch.nn import functional as F

from kubeflow_tpu_torch.api import annotations as ann_mod
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller import culling as culling_mod
from kubeflow_tpu_torch.controller import notebook as controller_mod
from kubeflow_tpu_torch.controller import prober as prober_mod
from kubeflow_tpu_torch.data.loader import (
    TokenLoader,
    device_put_global,
    sharded_loader,
    write_token_file,
)
from kubeflow_tpu_torch.examples import finetune_lora as finetune_example
from kubeflow_tpu_torch.models import continuous as cont_mod
from kubeflow_tpu_torch.models import convert as convert_mod
from kubeflow_tpu_torch.models import fp8 as fp8_mod
from kubeflow_tpu_torch.models import gateway as gateway_mod
from kubeflow_tpu_torch.models import llama as L
from kubeflow_tpu_torch.models import lora as lora_mod
from kubeflow_tpu_torch.models import moe as moe_mod
from kubeflow_tpu_torch.models import paged as paged_mod
from kubeflow_tpu_torch.models import quant as quant_mod
from kubeflow_tpu_torch.models import speculative as spec_mod
from kubeflow_tpu_torch.models.continuous import ContinuousBatcher
from kubeflow_tpu_torch.models.fp8 import quantize_weight_fp8
from kubeflow_tpu_torch.models.llama import _kv_quantize
from kubeflow_tpu_torch.models.lora import LoraConfig, merge_lora
from kubeflow_tpu_torch.models.multilora import (
    MultiLoraPagedBatcher,
    stack_adapters,
)
from kubeflow_tpu_torch.models.paged import PagedBatcher
from kubeflow_tpu_torch.models.server import InferenceServer
from kubeflow_tpu_torch.models import train as train_mod
from kubeflow_tpu_torch.models.autoscaler import AutoscalerConfig
from kubeflow_tpu_torch.models.serving import GenerationConfig
from kubeflow_tpu_torch.models.speculative import (
    SpeculativeContinuousBatcher,
    SpeculativePagedBatcher,
    truncated_draft,
)
from kubeflow_tpu_torch.models.tp_serving import serving_plan
from kubeflow_tpu_torch.parallel import collectives as collectives_mod
from kubeflow_tpu_torch.parallel import pipeline as pipeline_mod
from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from kubeflow_tpu_torch.observability import profiling as profiling_mod
from kubeflow_tpu_torch.observability import tracing as tracing_mod
from kubeflow_tpu_torch.observability.signals import FleetTelemetry
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import attention as attn_mod
from kubeflow_tpu_torch.ops import paged_attention as decode_mod
from kubeflow_tpu_torch.ops import quant_matmul as qmm_mod
from kubeflow_tpu_torch.ops import ragged_attention as ragged_mod
from kubeflow_tpu_torch.ops.attention import (
    NEG_INF,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
)
from kubeflow_tpu_torch.ops.paged_attention import (
    dense_decode_attention,
    dense_decode_reference,
    paged_decode_attention,
    paged_decode_reference,
)
from kubeflow_tpu_torch.ops.quant_matmul import (
    quant_matmul,
    quant_matmul_reference,
    quant_matmul_wide,
)
from kubeflow_tpu_torch.ops.ragged_attention import (
    ragged_attention_reference,
    ragged_paged_attention,
)
from kubeflow_tpu_torch.runtime import checkpoint as ckpt_mod
from kubeflow_tpu_torch.runtime.checkpoint import (
    CheckpointManager,
    flatten_state,
    resume_start_batch,
)
from kubeflow_tpu_torch.runtime.migration import (
    MigrationConfig,
    MigrationOrchestrator,
)
from kubeflow_tpu_torch.webhook import gpu_env
from kubeflow_tpu_torch import k8s as k8s_mod
from kubeflow_tpu_torch.gpu import topology as gpu_topology
from kubeflow_tpu_torch.metrics.metrics import STATS_PARITY, Metrics
from kubeflow_tpu_torch.metrics.server import MetricsServer

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
TOL = 2e-2
# Kernel vs plain: the limit of each error _errors measures. "rel" is twice
# the bf16 rounding bound; "row_rel" four times bf16's 2^-8.
GATES = {"abs": TOL, "rel": 2.0 ** -7, "row_rel": 2.0 ** -6}
SEED = 0
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Kernel cases


def _case(spans, *, hq, hkv, d, bs, maxb, nb, t, seed, all_true=False,
          hole=None):
    """Random bf16 q/pools and the metadata for [(seq_len, kv_len)];
    ``hole`` = (sequence, lo, hi) masks that sequence's keys lo..hi-1."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    q = torch.randn((t, hq, d), generator=g, device=dev).to(torch.bfloat16)
    kp = torch.randn((nb, hkv, bs, d), generator=g, device=dev).to(torch.bfloat16)
    vp = torch.randn((nb, hkv, bs, d), generator=g, device=dev).to(torch.bfloat16)
    s = len(spans)
    tables = torch.randperm(nb - 1, generator=g, device=dev)[: s * maxb]
    tables = (tables + 1).reshape(s, maxb).to(torch.int32)
    starts, lens, kvls, row = [], [], [], 0
    for n, kvl in spans:
        starts.append(row)
        lens.append(n)
        kvls.append(kvl)
        row += n
    check(row <= t, f"spans need {row} rows > {t}")
    kvl_t = torch.tensor(kvls, dtype=torch.int32, device=dev)
    if all_true:
        kv_mask = torch.ones((s, maxb * bs), dtype=torch.bool, device=dev)
    else:
        kv_mask = torch.arange(maxb * bs, device=dev)[None, :] < kvl_t[:, None]
    if hole is not None:
        row, lo, hi = hole
        kv_mask[row, lo:hi] = False
    return dict(
        q=q, k_pool=kp, v_pool=vp, tables=tables, kv_mask=kv_mask,
        seq_starts=torch.tensor(starts, dtype=torch.int32, device=dev),
        seq_lens=torch.tensor(lens, dtype=torch.int32, device=dev),
        kv_lens=kvl_t, block_size=bs,
    )


def _quantized(case):
    out = dict(case)
    out["k_pool"], out["k_scale_pool"] = _kv_quantize(case["k_pool"])
    out["v_pool"], out["v_scale_pool"] = _kv_quantize(case["v_pool"])
    return out


def _owned(case) -> torch.Tensor:
    t = case["q"].shape[0]
    owned = torch.zeros(t, dtype=torch.bool, device=DEVICE)
    for s0, n in zip(case["seq_starts"].tolist(), case["seq_lens"].tolist()):
        owned[s0:s0 + n] = True
    return owned


# The span layouts of the CPU suite (tests/test_torch_ragged_attention.py).
SMALL = dict(hq=8, hkv=4, d=128, bs=16, maxb=6, nb=32, t=24)
SMALL_LAYOUTS = [
    ([(1, 17), (1, 40), (1, 96)], 16, False),   # decode-only
    ([(8, 8), (12, 12), (4, 20)], 16, False),   # prefill-only chunks
    ([(1, 33), (10, 10), (1, 5)], 16, False),   # mixed decode + prefill
    ([(1, 64), (1, 96), (6, 22)], 16, False),   # mixed, longer histories
    ([(5, 30), (1, 1), (0, 0)], 16, False),     # single-token tail + idle
    ([(1, 33), (20, 20), (1, 5)], 8, False),    # chunk spans 3 q-tiles
    ([(3, 19), (9, 41), (12, 12)], 4, False),   # every span spills a tile
    ([(5, 21), (7, 39), (1, 64)], 4, False),    # spill rows of a partial tile
    ([(1, 25), (7, 18), (1, 90)], 16, True),    # all-True mask
]
# Main-path shape: llama-3-8b heads, 8 slots, 512 rows mixing 4 decode
# rows and 4 prefill chunks, kv lengths up to 640.
MAIN = dict(hq=32, hkv=8, d=128, bs=16, maxb=40, nb=8 * 40 + 1, t=512)
MAIN_SPANS = [(1, 640), (200, 200), (1, 300), (150, 430), (1, 129),
              (100, 100), (1, 17), (58, 640)]


def _errors(out, case, owned) -> dict:
    """The kernel's error against the plain version on the same values
    kept in f32 (the error is the kernel's own, not a second bf16
    rounding), over owned rows, each to be held to its entry in GATES:

    - ``abs``: max |out − ref|;
    - ``rel``: max |out − ref| / (|ref| + ref_abs), element by element,
      ``ref_abs`` being the plain version over ``|v|``. The kernel's only
      roundings are to bf16, of each probability (int8: of probability ×
      V scale) before P·V and of the output, each at most 2^-8 relative
      (bf16 keeps 8 significant bits), so a right kernel stays within
      2^-8 · (|ref| + ref_abs) even where the weighted sum cancels;
    - ``row_rel``: max over (row, q head) of ‖out − ref‖ / ‖ref‖ over the
      head dim. Independent roundings shrink like the weighted sum itself
      as a row attends more keys, so this stays near 2^-8 on long rows,
      where ``rel``'s bound, set by ``ref_abs``, is loose."""
    plain = {**case, "q": case["q"].float()}
    ref = ragged_attention_reference(**plain)[owned]
    ref_abs = ragged_attention_reference(
        **{**plain, "v_pool": case["v_pool"].abs()})[owned]
    return _diff_errors(out.float()[owned], ref, ref_abs)


def _diff_errors(out, ref, ref_abs) -> dict:
    """The GATES errors of ``out`` against ``ref`` (both f32, the head dim
    last), ``ref_abs`` being the plain version over ``|v|``."""
    diff = (out - ref).abs()
    rel = diff / (ref.abs() + ref_abs).clamp_min(1e-30)
    row_rel = (torch.linalg.vector_norm(diff, dim=-1)
               / torch.linalg.vector_norm(ref, dim=-1).clamp_min(1e-30))
    return {"abs": float(diff.max()), "rel": float(rel.max()),
            "row_rel": float(row_rel.max())}


def _gate(name: str, errs: dict, worst: dict) -> None:
    """Hold each of ``errs`` to its GATES limit; keep the worst."""
    for gate, limit in GATES.items():
        check(math.isfinite(errs[gate]) and errs[gate] <= limit,
              f"{name}: kernel vs plain {gate} error {errs[gate]} > {limit}")
        worst[gate] = max(worst.get(gate, 0.0), errs[gate])


# The engine's decode lengths (8 slots, 8..576 keys) and long histories
# (8 slots, 512..4096 keys), shared by the ragged and decode cases.
DEC_MAIN_LENS = [int(x) for x in np.linspace(8, 576, 8)]
LONG_LENS = [int(x) for x in np.linspace(512, 4096, 8)]
# Tiles whose keys span several of the kernel's runs (ragged_splits: 2 to
# 6 runs of 192 to 512 keys at these shapes): up to 7 sequences of up to
# 96 rows over a 1024-key span; 16 q heads a kv head for 32-token q-tiles
# of 128 rows; llama-3-8b's heads over long spans with one row a slot.
RAG_SPLIT = dict(hq=8, hkv=4, d=128, bs=16, maxb=64, nb=7 * 64 + 1, t=96)
RAG_QT32 = dict(hq=16, hkv=4, d=128, bs=16, maxb=64, nb=3 * 64 + 1, t=96)
RAG_DECODE = dict(hq=32, hkv=8, d=128, bs=16, maxb=37, nb=8 * 37 + 1, t=8)
RAG_LONG = dict(hq=32, hkv=8, d=128, bs=16, maxb=256, nb=8 * 256 + 1, t=8)
RAG_SINGLE = dict(hq=32, hkv=8, d=128, bs=16, maxb=512, nb=512 + 1, t=8)
RAG_CHUNK = dict(hq=32, hkv=8, d=128, bs=16, maxb=256, nb=256 + 1, t=512)
# Speculative verify spans (k_spec 4: 1 + 4 rows a slot, 5 of a 16-row
# q-tile, each row bounded by k_pos <= kv_len − 5 + j): the ragged spec
# engine's full-house round of 8 slots over 8..564 keys, and 8 slots of
# 512..4096 keys, both at the dispatch width the engine pads 40 rows to.
SPEC_K = 4
VERIFY_LENS = [int(x) for x in np.linspace(8, 564, 8)]
VERIFY_SPANS = [(SPEC_K + 1, n) for n in VERIFY_LENS]
VERIFY_LONG_SPANS = [(SPEC_K + 1, n) for n in LONG_LENS]
RAG_VERIFY = dict(hq=32, hkv=8, d=128, bs=16, maxb=37, nb=8 * 37 + 1, t=64)
RAG_VERIFY_LONG = dict(hq=32, hkv=8, d=128, bs=16, maxb=256, nb=8 * 256 + 1,
                       t=64)
# GQA group 1 at llama-2-7b's heads (32/32, D 128) and gemma-7b's (16/16,
# D 256); group 8 at gemma-2b's (8/1, D 256).
RAG_G1 = dict(hq=32, hkv=32, d=128, bs=16, maxb=40, nb=8 * 40 + 1, t=128)
G1_SPANS = [(1, 640), (40, 40), (1, 300), (30, 430), (1, 129), (20, 100),
            (1, 17), (20, 600)]
RAG_G1_D256 = dict(hq=16, hkv=16, d=256, bs=16, maxb=64, nb=4 * 64 + 1, t=64)
RAG_G8 = dict(hq=8, hkv=1, d=256, bs=16, maxb=64, nb=5 * 64 + 1, t=96)
RAG_G8_LONG = dict(hq=8, hkv=1, d=256, bs=16, maxb=256, nb=8 * 256 + 1, t=8)
# Phase 3's ragged cases: (spans, shape, options, q_tile, name, seed). The
# CPU suite's layouts, the other head dims and 32-token q-tiles, the
# main-path shape; then the split design's edges: decode rows and
# one-tile prefill chunks whose causal bound falls at a run boundary (512
# keys) and one key either side, and a 40-row chunk near the span's end;
# a masked span longer than a run, so that a whole run sees no key;
# an idle slot with a stale kv_len past the span beside split slots; one
# row over 8192 keys (7 unowned rows) and 8 rows over 512..4096 keys;
# 32-token q-tiles (128 rows a CTA) and head dims 64 and 256 over several
# runs.
RAGGED_CASES = [
    (spans, SMALL, {"all_true": all_true}, q_tile, f"small#{i}", i)
    for i, (spans, q_tile, all_true) in enumerate(SMALL_LAYOUTS)
] + [
    (SMALL_LAYOUTS[i][0], {**SMALL, "d": d}, {}, 16, f"d{d}#{i}", 50 + i)
    for i, d in ((2, 64), (3, 256))
] + [
    (MAIN_SPANS, MAIN, {}, 16, "main", 100),
    (MAIN_SPANS, MAIN, {}, 32, "main-qt32", 101),
    ([(1, 511), (1, 512), (1, 513), (16, 511), (16, 512), (16, 513),
      (40, 1000)], RAG_SPLIT, {}, 16, "split-bounds", 150),
    ([(1, 700), (30, 900)], RAG_SPLIT, {"hole": (0, 60, 600)}, 16,
     "masked-run", 151),
    ([(1, 300), (0, 10_000), (1, 700), (20, 700)], RAG_SPLIT, {}, 16,
     "idle-stale-split", 152),
    ([(1, 8192)], RAG_SINGLE, {}, 16, "single-8192", 153),
    ([(1, n) for n in LONG_LENS], RAG_LONG, {}, 16, "long-4096", 154),
    ([(70, 900), (1, 513), (20, 130)], RAG_QT32, {}, 32, "split-qt32", 155),
    ([(1, 700), (30, 900), (1, 513)], {**RAG_SPLIT, "d": 64}, {}, 16,
     "split-d64", 156),
    ([(1, 700), (30, 900), (1, 513)], {**RAG_SPLIT, "d": 256}, {}, 16,
     "split-d256", 157),
    (VERIFY_SPANS, RAG_VERIFY, {}, 16, "verify-spans", 158),
    (VERIFY_LONG_SPANS, RAG_VERIFY_LONG, {}, 16, "verify-spans-4096", 159),
    # GQA groups the ragged engine serves beside llama-3-8b's 4: one q head
    # a kv head (llama-2-7b, gemma-7b) and 8 over one (gemma-2b), decode
    # rows and chunks over several runs of keys, and gemma-2b's heads over
    # 8 slots of 512..4096 keys.
    (G1_SPANS, RAG_G1, {}, 16, "gqa1-llama-2-7b", 160),
    ([(1, 1000), (40, 40), (1, 513), (16, 512)], RAG_G1_D256, {}, 16,
     "gqa1-gemma-7b", 161),
    ([(1, 1000), (40, 40), (1, 513), (30, 700), (1, 17)], RAG_G8, {}, 16,
     "gqa8-gemma-2b", 162),
    ([(1, n) for n in LONG_LENS], RAG_G8_LONG, {}, 16, "gqa8-long-4096", 163),
]


def check_ragged_repeat(first, again, name: str) -> None:
    """Ragged attention twice on the same inputs must give the same bits:
    each output is written once, by one thread, and the merge of a tile's
    runs adds them in run order, whichever run finished last."""
    check(_same_bits(first, again),
          f"{name}: the output differs between two runs on the same inputs")


def kernel_vs_plain():
    """Phase 3, ragged attention: every RAGGED_CASES case, bf16 and int8,
    each run twice and its output equal bit for bit; returns {variant:
    {gate: the worst error}}."""
    worst = {v: dict.fromkeys(GATES, 0.0) for v in ("bf16", "int8")}
    for spans, shape, opts, q_tile, name, seed in RAGGED_CASES:
        base = _case(spans, seed=seed, **shape, **opts)
        for variant in ("bf16", "int8"):
            case = base if variant == "bf16" else _quantized(base)
            out = ragged_paged_attention(**case, q_tile=q_tile)
            check_ragged_repeat(
                out, ragged_paged_attention(**case, q_tile=q_tile),
                f"{name} {variant}")
            torch.cuda.synchronize()
            owned = _owned(case)
            errs = _errors(out, case, owned)
            torch.cuda.synchronize()
            unowned_zero = bool((out[~owned] == 0).all())
            log(f"  {name:16s} {variant}: " + " ".join(
                f"max_{k}_err={v:.3e}" for k, v in errs.items())
                + f" unowned_rows_zero={unowned_zero} repeat_bit_equal=True")
            _gate(f"{name} {variant}", errs, worst[variant])
            check(unowned_zero, f"{name} {variant}: unowned rows not 0")
        del base
    return worst


# Flash forward cases. The CPU suite's (tests/test_torch_flash_attention.py):
# (b, h, hkv, sq, sk, causal, q_offset, window, left pads per batch row).
FLASH_SMALL = [
    (1, 2, 2, 384, 384, True, 0, 0, None),
    (1, 8, 2, 256, 256, True, 0, 0, None),
    (2, 4, 2, 384, 384, True, 0, 0, (100, 300)),
    (1, 2, 2, 256, 384, True, 128, 150, None),
    (1, 2, 1, 256, 384, False, 0, 0, None),
]
# The main-path prefill: one 512-token bucket, llama-3-8b heads, a prompt
# of 312 tokens left-padded by 200.
FLASH_MAIN = (1, 32, 8, 512, 512, True, 0, 0, (200,))
FLASH_CASES = [(c, 128, f"small#{i}") for i, c in enumerate(FLASH_SMALL)] + [
    (FLASH_MAIN, 128, "main-prefill"),
    # A continuation re-admitted at 528 rows (a multiple of 16, not 128).
    ((1, 32, 8, 528, 528, True, 0, 0, (17,)), 128, "continuation-528"),
    # The training forward (and its remat recompute), 64 launches a step.
    ((1, 32, 8, 2048, 2048, True, 0, 0, None), 128, "train-2048"),
    # Past the TPU's whole-K/V line (2·Sk·D·2 B > 4 MB): its streamed kernel.
    ((1, 32, 8, 16384, 16384, True, 0, 0, None), 128, "long-16384"),
    ((1, 32, 8, 1024, 1024, True, 0, 256, (64,)), 128, "window-256"),
    ((2, 8, 2, 300, 700, True, 400, 333, (0, 250)), 128, "window-q-offset"),
    ((1, 8, 2, 200, 200, True, 0, 0, (30,)), 64, "d64"),
    ((1, 8, 2, 200, 200, True, 0, 0, (30,)), 256, "d256"),
    # GQA groups of 1 and 8 (the cases above have groups 1, 2 and 4).
    ((1, 8, 8, 320, 320, True, 0, 0, (45,)), 128, "group-1"),
    ((2, 16, 2, 260, 452, True, 192, 0, None), 128, "group-8"),
    # gemma-2b's training forward: 8 q heads over 1 kv head, head dim 256.
    ((1, 8, 1, 2048, 2048, True, 0, 0, None), 256, "gemma-2b-2048"),
]
LSE_TOL = 1e-3
FLASH_DESIGN = (
    "wgmma, one warpgroup per (64-row q tile, q head, batch row), q tile "
    "slowest and the last first; a producer warp copies Q once and 64-key "
    "K/V tiles into two stages with TMA (128-byte swizzle) on mbarriers; "
    "S = Q·Kᵀ SS m64n64k16, P from registers into O += P·V RS with V "
    "MN-major")


def _flash_case(shape, d, seed):
    b, h, hkv, sq, sk, causal, q_offset, window, pads = shape
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*size):
        return torch.randn(size, generator=g, device=DEVICE).to(torch.bfloat16)

    kv_mask = None
    if pads is not None:
        kv_mask = (torch.arange(sk, device=DEVICE)[None, :]
                   >= torch.tensor(pads, device=DEVICE)[:, None])
    return dict(q=randn(b, h, sq, d), k=randn(b, hkv, sk, d),
                v=randn(b, hkv, sk, d), causal=causal, q_offset=q_offset,
                window=window, kv_mask=kv_mask)


def _flash_errors(out, lse, case) -> dict:
    """GATES errors of O against the plain version kept in f32, plus
    ``lse``: the worst |lse − ref| over rows that see a key, and whether
    every row that sees none has O = 0 and lse <= -1e29."""
    plain = {**case, **{n: case[n].float() for n in ("q", "k", "v")}}
    ref, ref_lse = flash_attention_reference(**plain)
    ref_abs, _ = flash_attention_reference(**{**plain, "v": plain["v"].abs()})
    errs = _diff_errors(out.float(), ref, ref_abs)
    has = ref_lse > NEG_INF / 2
    errs["lse"] = float((lse - ref_lse).abs()[has].max()) if has.any() else 0.0
    errs["keyless_rows_ok"] = bool((lse[~has] <= -1e29).all()
                                   and (out[~has] == 0).all())
    return errs


def check_fwd_repeat(first, again, name: str) -> None:
    """The forward twice on the same inputs must give O and lse equal bit
    for bit: every value is written once, by one thread, and no sum
    depends on timing (no atomics)."""
    for t, a, b in zip(("O", "lse"), first, again):
        check(_same_bits(a, b),
              f"flash {name}: {t} differs between two runs on the same inputs")


def flash_vs_plain():
    """Phase 3, flash forward; returns {gate: the worst error}. Each case
    also runs twice: O and lse must repeat bit for bit."""
    worst: dict = {}
    for i, (shape, d, name) in enumerate(FLASH_CASES):
        case = _flash_case(shape, d, seed=200 + i)
        out, lse = flash_attention_fwd(**case)
        check_fwd_repeat((out, lse), flash_attention_fwd(**case), name)
        torch.cuda.synchronize()
        errs = _flash_errors(out, lse, case)
        torch.cuda.synchronize()
        log(f"  flash {name:17s}: " + " ".join(
            f"max_{k}_err={v:.3e}" for k, v in errs.items()
            if k != "keyless_rows_ok")
            + f" keyless_rows_ok={errs['keyless_rows_ok']}"
            " repeat_bit_equal=True")
        _gate(f"flash {name}", errs, worst)
        check(errs["lse"] <= LSE_TOL,
              f"flash {name}: lse error {errs['lse']} > {LSE_TOL}")
        worst["lse"] = max(worst.get("lse", 0.0), errs["lse"])
        check(errs["keyless_rows_ok"],
              f"flash {name}: a row with no visible key is not 0 / NEG_INF")
        del case, out, lse
    return worst


# Flash backward cases: the forward's (b, h, hkv, sq, sk, causal,
# q_offset, window, left pads) and head dim. The CPU suite's
# (tests/test_torch_flash_backward.py: the first three, group 8 and group 1
# with a mask), the training shape (llama-3-8b heads, S 2048, causal), a
# window with a q_offset, a left-padded mask whose first 150 rows see no
# key, and head dim 64; then head dim 256: gemma-2b's training shape (8 q
# heads over 1 kv head, S 2048, causal), its heads with a q_offset, a
# left-padded mask with a window, and rows that see no key.
BWD_TRAIN = (1, 32, 8, 2048, 2048, True, 0, 0, None)
BWD_GEMMA = (1, 8, 1, 2048, 2048, True, 0, 0, None)
BWD_CASES = [
    ((1, 4, 2, 256, 384, True, 128, 120, None), 128, "gqa-window-q-offset"),
    ((2, 4, 2, 384, 384, True, 0, 0, (100, 300)), 128, "kv-mask-left-pad"),
    ((1, 4, 1, 256, 384, False, 0, 0, None), 128, "non-causal-gqa"),
    ((1, 16, 2, 192, 256, True, 64, 0, None), 128, "group-8"),
    ((2, 4, 4, 200, 200, False, 0, 0, (37, 90)), 128, "group-1-mask"),
    (BWD_TRAIN, 128, "train-2048"),
    ((2, 8, 2, 300, 700, True, 400, 333, (0, 250)), 128, "window-q-offset"),
    ((1, 8, 2, 200, 200, True, 0, 0, (150,)), 128, "keyless-rows"),
    ((1, 8, 2, 200, 200, True, 0, 0, (30,)), 64, "d64"),
    (BWD_GEMMA, 256, "gemma-2b-2048"),
    ((1, 8, 1, 300, 576, True, 276, 0, None), 256, "d256-q-offset"),
    ((2, 8, 1, 384, 384, True, 0, 200, (100, 300)), 256, "d256-mask-window"),
    ((1, 8, 2, 200, 200, True, 0, 0, (150,)), 256, "d256-keyless-rows"),
]
# Backward gates, each of dq, dk and dv against the plain version on the
# same inputs kept in f32. The kernels round two operands to bf16 once
# each, P (for dV) and dS (for dQ and dK), each by at most 2^-9 relative,
# and round their output to bf16 (2^-9). Independent roundings add in
# quadrature over a row's terms, so a row's relative error stays near
# 2^-8; both limits are four times that:
# - "max_scaled": max |out − ref| / max |ref| over the whole tensor;
# - "row_rel": max over (row, head) of ‖out − ref‖ / ‖ref‖ over the head
#   dim, the denominator floored at 2^-8 of the tensor's largest row norm:
#   a row whose sum cancels (the first causal row: dP = delta, so dS and
#   dq are 0 up to f32 accumulation order) is measured against that.
BWD_GATES = {"max_scaled": 2.0 ** -6, "row_rel": 2.0 ** -6}
BWD_ROW_FLOOR = 2.0 ** -8


def _bwd_case(shape, d, seed):
    """A flash case, its O and lse from the forward kernel, and a random
    bf16 dO: the backward's inputs exactly as training hands them over."""
    case = _flash_case(shape, d, seed)
    out, lse = flash_attention_fwd(**case)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    dout = torch.randn(out.shape, generator=g, device=DEVICE).to(torch.bfloat16)
    return {**case, "out": out, "lse": lse, "dout": dout}


def _bwd_zero_sets(case):
    """((B, H, Sq) rows that see no key, (B, Hkv, Sk) keys no row sees)."""
    b, h = case["q"].shape[:2]
    hkv = case["k"].shape[1]
    vis = torch.stack([_flash_visible(case, i) for i in range(b)])
    keyless = (~vis.any(-1))[:, None].expand(b, h, -1)
    unseen = (~vis.any(1))[:, None].expand(b, hkv, -1)
    return keyless, unseen


def _bwd_errors(grads, case) -> dict:
    """{dq|dk|dv: {max_scaled, row_rel, abs}} of the kernels' grads against
    the plain version on the same values in f32, and ``zeros_ok``: every
    row that sees no key has dq exactly 0 and every key no row sees has dk
    and dv exactly 0."""
    plain = {**case, **{n: case[n].float()
                        for n in ("q", "k", "v", "out", "dout")}}
    refs = flash_attention_bwd_reference(**plain)
    errs: dict = {}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        diff = (got.float() - ref).abs()
        rows = torch.linalg.vector_norm(ref, dim=-1)
        floor = BWD_ROW_FLOOR * float(rows.max())
        errs[name] = {
            "max_scaled": float(diff.max() / ref.abs().max().clamp_min(1e-30)),
            "row_rel": float((torch.linalg.vector_norm(diff, dim=-1)
                              / rows.clamp_min(max(floor, 1e-30))).max()),
            "abs": float(diff.max()),
        }
    keyless, unseen = _bwd_zero_sets(case)
    dq, dk, dv = grads
    errs["zeros_ok"] = bool((dq[keyless] == 0).all() and (dk[unseen] == 0).all()
                            and (dv[unseen] == 0).all())
    return errs


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def check_bwd_repeat(grads, again, name: str) -> None:
    """The backward twice on the same inputs must give dq, dk and dv equal
    bit for bit: each value is written once, by one thread (dK and dV's
    group summed in one order), and no sum depends on timing."""
    for t, first, second in zip(("dq", "dk", "dv"), grads, again):
        check(_same_bits(first, second),
              f"flash bwd {name}: {t} differs between two runs on the same "
              "inputs")


def flash_bwd_vs_plain():
    """Phase 3, flash backward (kernels 6 and 7): returns {dq|dk|dv: {gate:
    the worst error, "abs": the worst absolute error}}. Each case also runs
    twice: dq, dk and dv must repeat bit for bit."""
    worst = {n: dict.fromkeys(list(BWD_GATES) + ["abs"], 0.0)
             for n in ("dq", "dk", "dv")}
    for i, (shape, d, name) in enumerate(BWD_CASES):
        case = _bwd_case(shape, d, seed=800 + i)
        grads = flash_attention_bwd(**case)
        check_bwd_repeat(grads, flash_attention_bwd(**case), name)
        torch.cuda.synchronize()
        errs = _bwd_errors(grads, case)
        torch.cuda.synchronize()
        log(f"  flash bwd {name:19s}: " + " ".join(
            f"{t}_{k}={v:.3e}" for t in ("dq", "dk", "dv")
            for k, v in errs[t].items()) + f" zeros_ok={errs['zeros_ok']}"
            " repeat_bit_equal=True")
        for t in ("dq", "dk", "dv"):
            for gate, limit in BWD_GATES.items():
                err = errs[t][gate]
                check(math.isfinite(err) and err <= limit,
                      f"flash bwd {name} {t}: {gate} error {err} > {limit}")
            for k in worst[t]:
                worst[t][k] = max(worst[t][k], errs[t][k])
        check(errs["zeros_ok"], f"flash bwd {name}: a row that sees no key or "
                                "a key no row sees has a nonzero gradient")
        del case, grads
    return worst


# Paged decode cases. The CPU suite's layouts
# (tests/test_torch_paged_attention.py), then the main-path decode:
# llama-3-8b heads, 8 slots, block 16, the engine's 37-block tables,
# lengths 8..576 with a quarter of each history left padding.
DEC_SMALL = dict(hq=8, hkv=4, d=128, bs=16, maxb=6, nb=32)
DEC_MAIN = dict(hq=32, hkv=8, d=128, bs=16, maxb=37, nb=8 * 37 + 1)
# Six slots over a 1024-key span, and llama-3-8b's heads over long spans.
DEC_SPLIT = dict(hq=8, hkv=4, d=128, bs=16, maxb=64, nb=6 * 64 + 1)
SPLIT_LENS = [255, 256, 257, 511, 512, 513]
DEC_LONG = dict(hq=32, hkv=8, d=128, bs=16, maxb=256, nb=8 * 256 + 1)
DEC_SINGLE = dict(hq=32, hkv=8, d=128, bs=16, maxb=512, nb=512 + 1)
DEC_CASES = [
    ([17, 40, 96], DEC_SMALL, {}, "partial-tails"),
    ([1, 33, 96], DEC_SMALL, {"all_true": True}, "all-true"),
    ([60, 60, 60], DEC_SMALL, {"holes": True}, "holes"),
    ([30, 50, 90], {**DEC_SMALL, "hkv": 2}, {}, "gqa-4"),
    # An idle slot (table row 0, position 0, all-False mask) and a stale
    # length past MAXB·BS beside live ones.
    ([1, 10_000, 45], DEC_SMALL, {"idle": (0,)}, "idle-stale"),
    (DEC_MAIN_LENS, DEC_MAIN, {"pad_frac": 0.25}, "main-decode"),
    ([17, 40, 96], {**DEC_SMALL, "d": 64}, {}, "d64"),
    ([17, 40, 96], {**DEC_SMALL, "d": 256}, {}, "d256"),
    # Slots whose histories span several of the kernel's runs of keys
    # (decode_splits: 64, 128, 256 or 512 keys): lengths at 256 and 512
    # keys, a run boundary for each, and one key either side; a
    # masked span longer than a run, so that a whole run sees no key; an
    # idle slot and a stale length beside split slots; head dims 64 and
    # 256, and gemma-2b's heads (8 q, 1 kv, D 256).
    (SPLIT_LENS, DEC_SPLIT, {}, "split-bounds"),
    ([700, 900], DEC_SPLIT, {"hole": (0, 60, 600)}, "masked-run"),
    ([300, 1, 10_000, 700], DEC_SPLIT, {"idle": (1,)}, "idle-stale-split"),
    ([100, 300, 513, 1024], {**DEC_SPLIT, "d": 64}, {"pad_frac": 0.25},
     "split-d64"),
    ([100, 300, 513, 1024], {**DEC_SPLIT, "d": 256}, {"pad_frac": 0.25},
     "split-d256"),
    ([129, 700, 1000], {**DEC_SPLIT, "hq": 8, "hkv": 1, "d": 256}, {},
     "split-gemma"),
    # Long histories at llama-3-8b's heads: 8 slots of 512..4096 keys, a
    # quarter of each left padding, and one slot of 8192.
    (LONG_LENS, DEC_LONG, {"pad_frac": 0.25}, "long-4096"),
    ([8192], DEC_SINGLE, {}, "single-8192"),
    # GQA group 1: llama-2-7b's heads (32/32, D 128) and gemma-7b's (16/16,
    # D 256), over one and several runs of keys.
    ([129, 700, 1000, 40], {**DEC_SPLIT, "hq": 32, "hkv": 32},
     {"pad_frac": 0.25}, "gqa1-llama-2-7b"),
    ([100, 513, 1024], {**DEC_SPLIT, "hq": 16, "hkv": 16, "d": 256}, {},
     "gqa1-gemma-7b"),
]


def _decode_case(seq_lens, *, hq, hkv, d, bs, maxb, nb, seed, all_true=False,
                 holes=False, hole=None, idle=(), pad_frac=0.0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = len(seq_lens)

    def randn(*size):
        return torch.randn(size, generator=g, device=DEVICE).to(torch.bfloat16)

    tables = torch.randperm(nb - 1, generator=g, device=DEVICE)[: b * maxb]
    tables = (tables + 1).reshape(b, maxb).to(torch.int32)
    seq = torch.tensor(seq_lens, dtype=torch.int32, device=DEVICE)
    k_pos = torch.arange(maxb * bs, device=DEVICE)[None, :]
    if all_true:
        kv_mask = torch.ones((b, maxb * bs), dtype=torch.bool, device=DEVICE)
    else:
        pads = (seq.float() * pad_frac).long()[:, None]
        kv_mask = (k_pos < seq[:, None]) & (k_pos >= pads)
    if holes:
        kv_mask[0, 5:9] = False
        kv_mask[1, 16:32] = False  # a wholly masked block
    if hole is not None:
        row, lo, hi = hole
        kv_mask[row, lo:hi] = False
    for i in idle:
        tables[i] = 0
        seq[i] = 1
        kv_mask[i] = False
    return dict(q=randn(b, hq, d), k_pool=randn(nb, hkv, bs, d),
                v_pool=randn(nb, hkv, bs, d), tables=tables, kv_mask=kv_mask,
                seq_lens=seq, block_size=bs)


def check_decode_repeat(first, again, name: str) -> None:
    """A decode kernel twice on the same inputs must give the same bits:
    each output is written once, by one thread, and the merge of a slot's
    runs adds them in split order, whichever run finished last."""
    check(_same_bits(first, again),
          f"{name}: the output differs between two runs on the same inputs")


def _decode_vs_plain(label, cases, make_case, kernel, reference, kv_names):
    """Phase 3 for a decode kernel: each case through ``kernel`` and
    through ``reference`` on the same values in f32 (``kv_names`` the two
    K/V inputs); idle rows must be exactly 0, and a second run of the
    kernel must repeat the first bit for bit. Returns {gate: the worst
    error}."""
    k_name, v_name = kv_names
    worst: dict = {}
    for i, (lens, shape, opts, name, seed) in enumerate(cases):
        case = make_case(lens, seed=seed, **shape, **opts)
        out = kernel(**case)
        check_decode_repeat(out, kernel(**case), f"{label} {name}")
        torch.cuda.synchronize()
        plain = {**case, **{n: case[n].float() for n in ("q", k_name, v_name)}}
        ref = reference(**plain)
        ref_abs = reference(**{**plain, v_name: plain[v_name].abs()})
        errs = _diff_errors(out.float(), ref, ref_abs)
        finite = bool(torch.isfinite(out).all())
        idle_zero = all(bool((out[j] == 0).all()) for j in opts.get("idle", ()))
        log(f"  {label} {name:16s}: " + " ".join(
            f"max_{k}_err={v:.3e}" for k, v in errs.items())
            + f" finite={finite} idle_rows_zero={idle_zero}"
            " repeat_bit_equal=True")
        _gate(f"{label} {name}", errs, worst)
        check(finite and idle_zero, f"{label} {name}: non-finite output or "
                                    "an idle row not exactly 0")
    return worst


def decode_vs_plain():
    """Phase 3, paged decode; returns {gate: the worst error}."""
    return _decode_vs_plain(
        "decode", [c + (300 + i,) for i, c in enumerate(DEC_CASES)],
        _decode_case, paged_decode_attention, paged_decode_reference,
        ("k_pool", "v_pool"))


# Dense decode cases. The CPU suite's layouts
# (tests/test_torch_dense_decode.py), then the main-path decode: llama-3-8b
# heads, 8 slots, the engine's cache of 1024 positions, lengths 8..576 with
# a quarter of each history left padding and the mask True past it, as the
# engine keeps it (the positional bound hides the rest).
DENSE_SMALL = dict(hq=8, hkv=4, d=128, c=256)
DENSE_MAIN = dict(hq=32, hkv=8, d=128, c=1024)
DENSE_SPLIT = dict(hq=8, hkv=4, d=128, c=1024)
DENSE_LONG = dict(hq=32, hkv=8, d=128, c=4096)
DENSE_SINGLE = dict(hq=32, hkv=8, d=128, c=8192)
DENSE_CASES = [
    ([1, 100, 256], DENSE_SMALL, {"hole": (1, 10, 20)}, "hole"),
    ([17, 65, 130], DENSE_SMALL, {}, "partial-blocks"),
    ([40, 90, 200], DENSE_SMALL, {"pad_frac": 0.5}, "left-padding"),
    ([30, 50, 90], {**DENSE_SMALL, "hkv": 2}, {}, "gqa-4"),
    ([1, 256, 77], DENSE_SMALL, {"idle": (0,)}, "idle-and-full"),
    (DEC_MAIN_LENS, DENSE_MAIN, {"pad_frac": 0.25}, "main-decode"),
    (DEC_MAIN_LENS, DENSE_MAIN, {"pad_frac": 0.25, "hole": (5, 300, 364)},
     "main-hole"),
    ([1] + DEC_MAIN_LENS[1:], DENSE_MAIN, {"pad_frac": 0.25, "idle": (0,)},
     "main-idle"),
    ([1024] + DEC_MAIN_LENS[1:], DENSE_MAIN, {"pad_frac": 0.25},
     "main-full"),
    ([17, 65, 130], {**DENSE_SMALL, "d": 64}, {}, "d64"),
    ([17, 65, 130], {**DENSE_SMALL, "d": 256}, {}, "d256"),
    # Slots over several runs, as DEC_CASES; the stale length is past C.
    (SPLIT_LENS, DENSE_SPLIT, {}, "split-bounds"),
    ([700, 900], DENSE_SPLIT, {"hole": (0, 60, 600)}, "masked-run"),
    ([300, 1, 10_000, 700], DENSE_SPLIT, {"idle": (1,)}, "idle-stale-split"),
    ([100, 300, 513, 1024], {**DENSE_SPLIT, "d": 64}, {"pad_frac": 0.25},
     "split-d64"),
    ([100, 300, 513, 1024], {**DENSE_SPLIT, "d": 256}, {"pad_frac": 0.25},
     "split-d256"),
    ([129, 700, 1000], {**DENSE_SPLIT, "hq": 8, "hkv": 1, "d": 256}, {},
     "split-gemma"),
    (LONG_LENS, DENSE_LONG, {"pad_frac": 0.25}, "long-4096"),
    ([8192], DENSE_SINGLE, {}, "single-8192"),
    # GQA group 1, as DEC_CASES.
    ([129, 700, 1000, 40], {**DENSE_SPLIT, "hq": 32, "hkv": 32},
     {"pad_frac": 0.25}, "gqa1-llama-2-7b"),
    ([100, 513, 1024], {**DENSE_SPLIT, "hq": 16, "hkv": 16, "d": 256}, {},
     "gqa1-gemma-7b"),
]


def _dense_case(seq_lens, *, hq, hkv, d, c, seed, hole=None, idle=(),
                pad_frac=0.0):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = len(seq_lens)

    def randn(*size):
        return torch.randn(size, generator=g, device=DEVICE).to(torch.bfloat16)

    seq = torch.tensor(seq_lens, dtype=torch.int32, device=DEVICE)
    pads = (seq.float() * pad_frac).long()[:, None]
    kv_mask = torch.arange(c, device=DEVICE)[None, :] >= pads
    if hole is not None:
        row, lo, hi = hole
        kv_mask[row, lo:hi] = False
    for i in idle:
        seq[i] = 1
        kv_mask[i] = False
    return dict(q=randn(b, hq, d), k_cache=randn(b, hkv, c, d),
                v_cache=randn(b, hkv, c, d), kv_mask=kv_mask, seq_lens=seq,
                block_size=256)


def dense_vs_plain():
    """Phase 3, dense decode; returns {gate: the worst error}."""
    return _decode_vs_plain(
        "dense", [c + (600 + i,) for i, c in enumerate(DENSE_CASES)],
        _dense_case, dense_decode_attention, dense_decode_reference,
        ("k_cache", "v_cache"))


# ---------------------------------------------------------------------------
# Timing


def _spin_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call by CUDA events, the 50 MB L2 flushed
    before each (the engine finds each layer's pool cold). A spin kernel
    queued ahead of each call keeps the card busy, for three times as long
    as the host takes to queue the call, so the events time the card's
    work and not the host's Python."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int((3 * host_ms + 1.0) * _spin_cycles_per_ms())
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(case) -> tuple[float, str, dict]:
    """Least time for this case's work: each input byte read once (live
    K/V blocks, their scales, q, metadata) and the output written once,
    over HBM bandwidth; 4·Σ rows·visible keys·Hq·D FLOPs over the bf16
    peak. Visible keys follow this run's mask and positions."""
    q = case["q"]
    t, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    quant = case.get("k_scale_pool") is not None
    elem = 1 if quant else 2
    mask = case["kv_mask"].cpu().numpy()
    starts = case["seq_starts"].tolist()
    lens = case["seq_lens"].tolist()
    kvls = case["kv_lens"].tolist()
    live_blocks = 0
    visible = 0
    for s, (s0, n, kvl) in enumerate(zip(starts, lens, kvls)):
        if n == 0:
            continue
        live_blocks += -(-kvl // bs)
        cum = np.cumsum(mask[s])
        for j in range(n):
            visible += int(cum[kvl - n + j])
    kv_bytes = live_blocks * hkv * bs * d * elem * 2
    if quant:
        kv_bytes += live_blocks * hkv * bs * 2 * 2
    meta = sum(case[k].numel() * case[k].element_size()
               for k in ("tables", "kv_mask", "seq_starts", "seq_lens",
                         "kv_lens"))
    nbytes = kv_bytes + 2 * t * hq * d * 2 + meta
    flops = 4 * visible * hq * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS_PER_S * 1e3
    bound = max(t_bytes, t_flops)
    return bound, ("bytes" if t_bytes >= t_flops else "operations"), {
        "bytes": nbytes, "flops": flops}


def _library_call(case):
    """One SDPA call over a per-slot batched view: slot s's query rows,
    padded to the longest span, against its own MAXB·BS gathered keys, with
    the same validity rule as a boolean mask. The gather (and int8
    dequant) is set-up, untimed. Checks once that the call computes the
    kernel's function on the owned rows."""
    q, tables, mask = case["q"], case["tables"].long(), case["kv_mask"]
    _, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    s, maxb = tables.shape
    length = maxb * bs
    spans = list(zip(case["seq_starts"].tolist(), case["seq_lens"].tolist(),
                     case["kv_lens"].tolist()))
    rows = max(n for _, n, _ in spans)

    def dense(pool, scale):
        g = pool[tables]  # (S, MAXB, Hkv, BS, D)
        if scale is not None:
            g = (g.float() * scale[tables].float()[..., None]).to(q.dtype)
        g = g.permute(0, 2, 1, 3, 4).reshape(s, hkv, length, d)
        return g.repeat_interleave(hq // hkv, dim=1)  # q head i → i // G

    k = dense(case["k_pool"], case.get("k_scale_pool"))
    v = dense(case["v_pool"], case.get("v_scale_pool"))
    qd = torch.zeros((s, hq, rows, d), dtype=q.dtype, device=DEVICE)
    allowed = torch.zeros((s, 1, rows, length), dtype=torch.bool,
                          device=DEVICE)
    k_pos = torch.arange(length, device=DEVICE)
    for si, (s0, n, kvl) in enumerate(spans):
        qd[si, :, :n] = q[s0:s0 + n].transpose(0, 1)
        last = kvl - n + torch.arange(n, device=DEVICE)
        allowed[si, 0, :n] = mask[si][None, :] & (k_pos[None, :]
                                                  <= last[:, None])

    def call():
        return F.scaled_dot_product_attention(qd, k, v, attn_mask=allowed)

    out = call()
    ref = ragged_attention_reference(**{**case, "q": q.float()})
    for si, (s0, n, _) in enumerate(spans):
        err = float((out[si, :, :n].transpose(0, 1).float()
                     - ref[s0:s0 + n]).abs().max()) if n else 0.0
        check(err <= TOL, f"library yardstick differs from the plain "
                          f"version by {err} on slot {si}")
    return call


RAGGED_DESIGN = (
    "compact tile grid (ragged_tiles: min(T, (T + S·(q_tile − 1)) / q_tile) "
    "q-tiles, each CTA finding its sequence and tile by a warp's prefix sum "
    "of the tiles a sequence owns, on the card); grid (run, kv head, "
    "tile), each CTA one run of its tile's keys up to the tile's causal "
    "bound (ragged_splits: a multiple of 64 keys, at most 32 runs a tile "
    "and 132 CTAs a call, one wave at one CTA an SM) for all q_tile·G "
    "rows of the kv head's group, "
    "8 warps on mma.sync m16n8k16 in 64-key tiles through two cp.async "
    "stages; runs past the tile's keys exit at once; a tile over several "
    "runs: f32 partials to scratch, the last run by an atomic ticket "
    "merges them in run order (one launch a call)")
# Phase 4's ragged shapes, llama-3-8b heads and block 16: (name, spans,
# shape, seed, variants). An admission step (4 decode rows and 4 prefill
# chunks in a 512-row dispatch, kv lengths up to 640); the width-8 decode
# step, one row a slot over 8..576 keys, which most of the engine's steps
# are; long notebook sessions (8 slots of 512..4096 keys); one stream of
# 8192 keys at the width-8 dispatch (7 unowned rows); a long prompt's
# continuation chunk (512 rows at positions 3584..4095 of 4096 keys). int8
# pools at the two shapes the int8 engine runs.
RAGGED_TIMED = (
    ("main-mixed", MAIN_SPANS, MAIN, 100, ("bf16", "int8")),
    ("ragged-decode", [(1, n) for n in DEC_MAIN_LENS], RAG_DECODE, 510,
     ("bf16", "int8")),
    ("ragged-long-4096", [(1, n) for n in LONG_LENS], RAG_LONG, 511,
     ("bf16",)),
    ("ragged-single-8192", [(1, 8192)], RAG_SINGLE, 512, ("bf16",)),
    ("ragged-chunk-4096", [(512, 4096)], RAG_CHUNK, 513, ("bf16",)),
    ("ragged-verify", VERIFY_SPANS, RAG_VERIFY, 514, ("bf16", "int8")),
    ("ragged-verify-4096", VERIFY_LONG_SPANS, RAG_VERIFY_LONG, 515,
     ("bf16", "int8")),
)
RAGGED_ROW_KEYS = ("ms", "plain_ms", "library_ms", "library_backend",
                   "bound_ms", "bound_by", "ctas", "launches_per_call",
                   "kernels_per_call")


def _ragged_ctas(case) -> int:
    """The CTAs one call launches at the wrapper's q_tile of 16, which the
    engine runs: ragged_tiles · Hkv · nsplit of ragged_splits, from the
    case's shapes."""
    q_tile = 16
    t = case["q"].shape[0]
    s, maxb = case["tables"].shape
    hkv, bs = case["k_pool"].shape[1:3]
    _, nsplit = ragged_mod.ragged_splits(t, s, maxb * bs, hkv, q_tile)
    return ragged_mod.ragged_tiles(t, s, q_tile) * hkv * nsplit


def _ragged_library_call(case):
    """(call, backend name). Where every sequence has one row (the decode
    shapes), the decode yardstick: one SDPA call, query length 1, over each
    slot's gathered keys, cut to the live prefix where that is the whole
    visibility, else with the visibility as a mask (int8 pools dequantized
    to bf16 first, untimed). Otherwise ``_library_call``'s per-slot
    batched view with the visibility as a mask."""
    if set(case["seq_lens"].tolist()) != {1}:
        call = _library_call(case)
        return call, _sdpa_backend(call)
    pools = {}
    for name in ("k_pool", "v_pool"):
        pool, scale = case[name], case.get(name.replace("_", "_scale_"))
        if scale is not None:
            pool = (pool.float() * scale.float()[..., None]).to(torch.bfloat16)
        pools[name] = pool
    return _decode_library_call(dict(
        q=case["q"][case["seq_starts"].long()], **pools,
        tables=case["tables"], kv_mask=case["kv_mask"],
        seq_lens=case["kv_lens"], block_size=case["block_size"]))


def _timing_ragged(label, case) -> dict:
    """Phase 4 for ragged attention at one case: the kernel, the CTAs and
    kernels its call launched (read from one retried trace and checked:
    one launch of ``_ragged_ctas`` CTAs), its plain version, the library
    call and the bound."""
    saved = ragged_paged_attention.launches
    kernel_ms = _time_ms(lambda: ragged_paged_attention(**case))
    grids, records = _launch_grids(lambda: ragged_paged_attention(**case),
                                   {"ctas": "ragged_kernel"})
    ragged_paged_attention.launches = saved  # timing is no main path
    ctas = sum(math.prod(g) for g in grids["ctas"])
    # One launch of the kernel; the one other kernel a call may run is the
    # zero fill of the output's unowned rows (torch.zeros_like).
    per_call = len(grids["ctas"])
    others = [ev.get("name", "") for ev in records
              if "ragged_kernel" not in ev.get("name", "")]
    check(per_call == 1 and len(others) <= 1
          and all("fill" in name.lower() for name in others),
          f"{label}: one call launched {per_call} ragged kernels and "
          f"{[name[:60] for name in others]}")
    expected = _ragged_ctas(case)
    check(ctas == expected, f"{label}: {ctas} CTAs launched, not the "
                            f"{expected} of ragged_tiles · Hkv · nsplit")
    plain_ms = _time_ms(lambda: ragged_attention_reference(**case))
    call, backend = _ragged_library_call(case)
    library_ms = _time_ms(call)
    bound_ms, bound_by, work = _bound(case)
    log(f"  {label}: kernel {kernel_ms:.4f} ms ({ctas} CTAs, {per_call} "
        f"launch a call, {len(records)} kernels with the output's zero "
        f"fill), plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms (SDPA {backend}), bound {bound_ms:.4f} ms "
        f"({bound_by}; {work['bytes']} B, {work['flops']} FLOP)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_backend=backend, bound_ms=bound_ms,
                bound_by=bound_by, ctas=ctas, launches_per_call=per_call,
                kernels_per_call=len(records), **work)


def timing():
    """Phase 4, ragged attention: {shape name: {variant: row}} at every
    RAGGED_TIMED shape."""
    rows = {}
    for name, spans, shape, seed, variants in RAGGED_TIMED:
        base = _case(spans, seed=seed, **shape)
        rows[name] = {
            variant: _timing_ragged(
                f"{name} {variant}",
                base if variant == "bf16" else _quantized(base))
            for variant in variants}
        del base
        # The plain version's gathered keys at the chunk shape take ~17 GB.
        torch.cuda.empty_cache()
    return rows


def _bound_of(nbytes: int, flops: int) -> tuple[float, str, dict]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_flops), (
        "bytes" if t_bytes >= t_flops else "operations"), {
        "bytes": nbytes, "flops": flops}


def _flash_visible(case, b: int) -> torch.Tensor:
    """(Sq, Sk) bool: the keys each query row of batch row ``b`` sees."""
    sq, sk = case["q"].shape[2], case["k"].shape[2]
    q_pos = torch.arange(sq, device=DEVICE)[:, None] + case["q_offset"]
    k_pos = torch.arange(sk, device=DEVICE)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=DEVICE)
    if case["causal"]:
        vis = vis & (k_pos <= q_pos)
    if case["window"]:
        vis = vis & (k_pos > q_pos - case["window"])
    if case["kv_mask"] is not None:
        vis = vis & case["kv_mask"][b][None, :]
    return vis


def _flash_bound(case):
    """Least time: q, k, v and the mask read once, O and lse written once,
    over HBM bandwidth; 4·D FLOPs for each visible (row, key) pair of each
    q head (this run's causal bound, window and mask) over the bf16 peak."""
    q, k = case["q"], case["k"]
    b, h, sq, d = q.shape
    pairs = sum(int(_flash_visible(case, i).sum()) for i in range(b)) * h
    nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * sq
    if case["kv_mask"] is not None:
        nbytes += case["kv_mask"].numel()
    return _bound_of(nbytes, 4 * pairs * d)


def _sdpa_is_causal(case) -> bool:
    """Whether SDPA's ``is_causal`` states this case's visibility: square,
    causal, q_offset 0, no window and no mask. Such a case is timed with
    it, which lets SDPA take its flash backend; any other passes the
    visibility as a boolean mask."""
    return (case["q"].shape[2] == case["k"].shape[2] and bool(case["causal"])
            and case["q_offset"] == 0 and not case["window"]
            and case["kv_mask"] is None)


def _flash_library_call(case):
    """One SDPA call with ``enable_gqa``: ``is_causal`` where
    ``_sdpa_is_causal`` allows it, else the visibility as a boolean mask;
    checked once against the plain version on rows that see a key (SDPA
    gives NaN on rows that see none)."""
    q, k, v = case["q"], case["k"], case["v"]
    b = q.shape[0]
    is_causal = _sdpa_is_causal(case)
    allowed = (None if is_causal else
               torch.stack([_flash_visible(case, i) for i in range(b)])[:, None])

    def call():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed,
                                              is_causal=is_causal,
                                              enable_gqa=True)

    out = call()
    ref, ref_lse = flash_attention_reference(
        **{**case, **{n: case[n].float() for n in ("q", "k", "v")}})
    has = ref_lse > NEG_INF / 2
    err = float((out.float() - ref).abs()[has].max())
    check(err <= TOL, f"flash library yardstick differs from the plain "
                      f"version by {err}")
    return call


FLASH_TIMED = (("main-prefill", 20), ("continuation-528", 20),
               ("train-2048", 20), ("long-16384", 5))


def timing_flash():
    """Phase 4, flash forward: the main-path prefill, a 528-row
    continuation, the training shape (64 launches a train step) and the
    long shape (its plain version timed once: it takes seconds), each
    beside its plain version and one SDPA call
    (``is_causal`` where ``_sdpa_is_causal`` allows it). Each case also
    reports the CTAs its launch ran, read from a profiler trace."""
    rows = {}
    by_name = {name: (shape, d) for shape, d, name in FLASH_CASES}
    for name, iters in FLASH_TIMED:
        case = _flash_case(*by_name[name], seed=400)
        saved = flash_attention_fwd.launches
        kernel_ms = _time_ms(lambda: flash_attention_fwd(**case), iters=iters)
        ctas = _launched_ctas(lambda: flash_attention_fwd(**case),
                              {"ctas": "flash_fwd_kernel"})["ctas"]
        flash_attention_fwd.launches = saved  # timing is no main path
        # The plain version at S 16384 takes seconds a call: one timed.
        long = name == "long-16384"
        plain_ms = _time_ms(lambda: flash_attention_reference(**case),
                            **({"iters": 1, "warmup": 0} if long else {}))
        library_ms = _time_ms(_flash_library_call(case), iters=iters)
        bound_ms, bound_by, work = _flash_bound(case)
        rows[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, ctas=ctas,
                          library_is_causal=_sdpa_is_causal(case), **work)
        log(f"  flash {name}: kernel {kernel_ms:.4f} ms ({ctas} CTAs), plain "
            f"{plain_ms:.4f} ms, "
            f"library {library_ms:.4f} ms"
            f"{' (is_causal)' if _sdpa_is_causal(case) else ''}, bound "
            f"{bound_ms:.4f} ms ({bound_by}; {work['bytes']} B, "
            f"{work['flops']} FLOP)")
        del case
    return rows


def _bwd_bounds(case) -> dict:
    """Least time of each backward kernel at this case, with the bytes
    and FLOPs of the visible (row, key) pairs of each q head: dQ does 6·D
    FLOPs a pair (S, dP, dS·K) and moves q, dO, k, v, lse, delta and dq;
    dK/dV does 8·D (S, dP, Pᵀ·dO, dSᵀ·Q) and moves q, dO, k, v, lse,
    delta, dk and dv, each once."""
    q, k = case["q"], case["k"]
    b, h, sq, d = q.shape
    pairs = sum(int(_flash_visible(case, i).sum()) for i in range(b)) * h
    q_bytes, kv_bytes, row_bytes = 2 * q.numel(), 2 * k.numel(), 4 * b * h * sq
    mask = case["kv_mask"].numel() if case["kv_mask"] is not None else 0
    return {
        "dq": _bound_of(3 * q_bytes + 2 * kv_bytes + 2 * row_bytes + mask,
                        6 * pairs * d),
        "dkv": _bound_of(2 * q_bytes + 4 * kv_bytes + 2 * row_bytes + mask,
                         8 * pairs * d),
    }


def _sdpa_backward_call(case):
    """One SDPA backward over the same work: causal, dq, dk and dv in one
    call, on the flash backend only: with ``enable_gqa``, or where that is
    refused, over K/V repeated to the q heads (the repeat is set-up,
    untimed, and its grads are summed back over each group for the check).
    Raises if the flash backend refuses both, so that the yardstick never
    quietly becomes a slower backend. Checked once against the plain
    version. Returns (call, backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, dout = (case[n].detach() for n in ("q", "k", "v", "dout"))
    group = q.shape[1] // k.shape[1]
    qg = q.clone().requires_grad_()
    for backend, repeat in (("flash, enable_gqa", False),
                            ("flash, K/V repeated", True)):
        kg, vg = ((x.repeat_interleave(group, dim=1) if repeat else x.clone())
                  .detach().requires_grad_() for x in (k, v))
        try:
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                out = F.scaled_dot_product_attention(
                    qg, kg, vg, is_causal=True, enable_gqa=not repeat)
            break
        except RuntimeError as err:
            log(f"  SDPA flash backend refused {backend} ({str(err)[:80]})")
    else:
        raise AssertionError("SDPA's flash backend refused the backward")
    log(f"  SDPA backward yardstick: {backend}")

    def call():
        return torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True)

    grads = list(call())
    if grads[1].shape[1] != k.shape[1]:
        grads[1:] = [g.float().unflatten(1, (k.shape[1], group)).sum(2)
                     for g in grads[1:]]
    errs = _bwd_errors(grads, case)
    for t in ("dq", "dk", "dv"):
        check(errs[t]["max_scaled"] <= BWD_GATES["max_scaled"],
              f"SDPA backward yardstick differs from the plain version: "
              f"{t} {errs[t]}")
    return call, backend


BWD_ROUNDS = 3
BWD_DQ_DESIGN = (
    "wgmma, one warpgroup per (64-row q tile, q head, batch row), q tile "
    "slowest and the last first; a producer warp copies Q and dO once and "
    "64-key K/V tiles into two stages with TMA (128-byte swizzle) on "
    "mbarriers; S = Q·Kᵀ and dP = dO·Vᵀ SS m64n64k16 (two 32-key halves "
    "of m64n32 at D 256), dS from registers into dQ += dS·K RS with K "
    "MN-major")
BWD_DKV_DESIGN = (
    "wgmma, one warpgroup per (64-key tile, q head, batch row; at D 256 "
    "also per 128-column half, recomputing Sᵀ and dPᵀ), key tile slowest; "
    "f32 shares of dK/dV, then the group sum")
# What the kernels line reports of each backward kernel at a timed shape.
BWD_ROW_KEYS = ("ms", "ms_rounds", "spread", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "bwd_total_ms", "library_backend",
                "library_rounds_ms", "library_spread", "ctas")
# The backward's timed shapes: llama-3-8b's training attention (32 launches
# of each kernel a step) and gemma-2b's (18 a step).
BWD_TIMED = (("train-2048", BWD_TRAIN, 128), ("gemma-2b-2048", BWD_GEMMA, 256))


def _spread(rounds) -> float:
    return (max(rounds) - min(rounds)) / float(np.median(rounds))


def _timing_flash_bwd_case(shape, d) -> dict:
    """{"dq" | "dkv": row} at one shape: each kernel alone on prepared
    inputs, dQ, dK/dV and the SDPA backward in BWD_ROUNDS rounds taken in
    turns (each the median of its rounds, with its spread (max − min) /
    median), the whole wrapper (delta, padding and both kernels) and the
    plain version, beside each kernel's bound and the CTAs of each launch
    read from profiler grids."""
    case = _bwd_case(shape, d, seed=900)
    *inputs, ints = attn_mod._bwd_inputs(
        **{n: case[n] for n in ("q", "k", "v", "out", "lse", "dout",
                                "causal", "q_offset", "window", "kv_mask")})
    dq, dk, dv = (torch.empty_like(case[n]) for n in ("q", "k", "v"))
    call, backend = _sdpa_backward_call(case)
    saved = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    rounds = {"dq": [], "dkv": [], "library": []}
    for _ in range(BWD_ROUNDS):
        rounds["dq"].append(_time_ms(lambda: flash_bwd_dq(*inputs, dq, ints)))
        rounds["dkv"].append(_time_ms(lambda: flash_bwd_dkv(*inputs, dk, dv,
                                                            ints)))
        rounds["library"].append(_time_ms(call))
    total_ms = _time_ms(lambda: flash_attention_bwd(**case))
    ctas = {"dq": _launched_ctas(lambda: flash_bwd_dq(*inputs, dq, ints),
                                 {"ctas": "flash_bwd_dq_kernel"}),
            "dkv": _launched_ctas(lambda: flash_bwd_dkv(*inputs, dk, dv, ints), {
                "ctas": "flash_bwd_dkv_kernel",
                "group_sum_ctas": "flash_bwd_group_sum_kernel"})}
    flash_bwd_dq.launches, flash_bwd_dkv.launches = saved  # no main path
    plain_ms = _time_ms(lambda: flash_attention_bwd_reference(**case),
                        iters=5)
    med = {k: float(np.median(r)) for k, r in rounds.items()}
    bounds = _bwd_bounds(case)
    rows = {}
    for name in ("dq", "dkv"):
        bound_ms, bound_by, work = bounds[name]
        rows[name] = dict(ms=med[name], ms_rounds=rounds[name],
                          spread=_spread(rounds[name]), plain_ms=plain_ms,
                          library_ms=med["library"], bound_ms=bound_ms,
                          bound_by=bound_by, bwd_total_ms=total_ms,
                          library_backend=backend,
                          library_rounds_ms=rounds["library"],
                          library_spread=_spread(rounds["library"]),
                          **ctas[name], **work)
        log(f"  flash bwd {name}: kernel {med[name]:.4f} ms (rounds "
            f"{[round(x, 4) for x in rounds[name]]}, spread "
            f"{_spread(rounds[name]):.3%}; {ctas[name]['ctas']} CTAs), bound "
            f"{bound_ms:.4f} ms ({bound_by}; {work['bytes']} B, "
            f"{work['flops']} FLOP)")
    log(f"  flash bwd dkv's group sum launched "
        f"{ctas['dkv']['group_sum_ctas']} CTAs (profiler grids)")
    log(f"  SDPA backward rounds: "
        f"{[round(x, 4) for x in rounds['library']]} ms, median "
        f"{med['library']:.4f} ms, spread {_spread(rounds['library']):.3%}")
    log(f"  flash bwd: kernels 6 + 7 with delta and padding {total_ms:.4f} ms,"
        f" plain {plain_ms:.4f} ms, SDPA backward ({backend}) "
        f"{med['library']:.4f} ms")
    del case, inputs
    return rows


def timing_flash_bwd() -> dict:
    """Phase 4, flash backward: {shape name: {"dq" | "dkv": row}} for the
    BWD_TIMED shapes."""
    rows = {}
    for name, shape, d in BWD_TIMED:
        log(f"  flash bwd at {name} (D {d}):")
        rows[name] = _timing_flash_bwd_case(shape, d)
    return rows


def _decode_visible(case) -> torch.Tensor:
    """(B, MAXB·BS) or (B, C) bool: the keys each slot's query sees."""
    k_pos = torch.arange(case["kv_mask"].shape[1], device=DEVICE)
    return case["kv_mask"] & (k_pos[None, :] < case["seq_lens"].long()[:, None])


def _decode_bound(case):
    """Least time: the K and V rows of each slot's visible keys (kv_mask ∧
    k_pos < seq_len), the table entries and mask bytes of its live prefix,
    q and seq_lens read once, the output written once, over HBM bandwidth;
    4·D FLOPs per visible (slot, key) pair of each q head over the bf16
    peak."""
    q, tables = case["q"], case["tables"]
    b, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    maxb = tables.shape[1]
    prefix = [min(n, maxb * bs) for n in case["seq_lens"].tolist()]
    blocks = sum(-(-n // bs) for n in prefix)
    keys = int(_decode_visible(case).sum())
    nbytes = (keys * hkv * d * 2 * 2 + blocks * tables.element_size()
              + sum(prefix) + 2 * q.numel() * 2
              + case["seq_lens"].numel() * 4)
    return _bound_of(nbytes, 4 * keys * hq * d)


def _live_prefix(case):
    """n where every slot's visible keys are exactly its first n (no
    padding, no hole, one length for all), else None."""
    vis = _decode_visible(case)
    n = int(vis[0].sum())
    k_pos = torch.arange(vis.shape[1], device=DEVICE)
    return n if bool((vis == (k_pos < n)[None, :]).all()) else None


# SDPA's backends, by a substring of the kernels each launches.
SDPA_BACKENDS = (("cudnn", "cuDNN"), ("flash", "flash"), ("fmha", "efficient"))


def _sdpa_decode_call(q, k, v, allowed, reference):
    """One SDPA call, query length 1, with ``enable_gqa``, as PyTorch's own
    dispatch runs it; ``allowed`` is None where the keys are cut to the
    live prefix (so that a fused backend can take it), else the
    visibility as a boolean mask. Checked once against ``reference``; the
    backend that ran is named from the kernels of one traced call (math
    when none is a fused backend's). Returns (call, backend name)."""
    qd = q[:, :, None, :]

    def call():
        return F.scaled_dot_product_attention(qd, k, v, attn_mask=allowed,
                                              enable_gqa=True)

    err = float((call()[:, :, 0].float() - reference.float()).abs().max())
    check(err <= TOL, f"decode library yardstick differs from the plain "
                      f"version by {err}")
    return call, _sdpa_backend(call)


def _sdpa_backend(call) -> str:
    """The SDPA backend ``call`` runs, named from the kernels of one traced
    call (math when none is a fused backend's); a trace that holds no
    kernel is taken again, up to three times."""
    for _ in range(3):  # a trace now and then drops its kernel records
        records = _kernel_records(call)
        if records:
            break
    check(bool(records), "3 traces hold no kernel of the SDPA yardstick")
    names = " ".join(ev.get("name", "") for ev in records).lower()
    return next((label for needle, label in SDPA_BACKENDS
                 if needle in names), "math")


def _decode_library_call(case):
    """One SDPA call over the per-slot gathered view (gather untimed):
    over the live prefix alone where ``_live_prefix`` finds one, else with
    the visibility as a boolean mask. Returns (call, backend name)."""
    q, tables = case["q"], case["tables"].long()
    b, hq, d = q.shape
    _, hkv, bs, _ = case["k_pool"].shape
    length = tables.shape[1] * bs
    n = _live_prefix(case)

    def dense(pool):
        g = pool[tables].permute(0, 2, 1, 3, 4).reshape(b, hkv, length, d)
        return g if n is None else g[:, :, :n].contiguous()

    allowed = None if n is not None else _decode_visible(case)[:, None, None]
    return _sdpa_decode_call(
        q, dense(case["k_pool"]), dense(case["v_pool"]), allowed,
        paged_decode_reference(**{**case, "q": q.float()}))


def _dense_bound(case):
    """Least time: the K and V rows of each slot's visible keys (kv_mask ∧
    k_pos < seq_len), the mask bytes of its live prefix (its first
    min(seq_len, C) columns), q and seq_lens read once, the output written
    once, over HBM bandwidth; 4·D FLOPs per visible (slot, key) pair of
    each q head over the bf16 peak."""
    q = case["q"]
    b, hq, d = q.shape
    _, hkv, c, _ = case["k_cache"].shape
    prefix = sum(min(n, c) for n in case["seq_lens"].tolist())
    keys = int(_decode_visible(case).sum())
    nbytes = (keys * hkv * d * 2 * 2 + prefix + 2 * q.numel() * 2
              + case["seq_lens"].numel() * 4)
    return _bound_of(nbytes, 4 * keys * hq * d)


def _dense_library_call(case):
    """One SDPA call over ``cache[:, :, :n]``: n the live prefix where
    ``_live_prefix`` finds one (no mask), else the longest live prefix
    with the visibility as a boolean mask. Returns (call, backend name)."""
    q = case["q"]
    n = _live_prefix(case)
    max_len = n if n is not None else min(int(case["seq_lens"].max()),
                                          case["k_cache"].shape[2])
    allowed = (None if n is not None else
               _decode_visible(case)[:, None, None, :max_len])
    return _sdpa_decode_call(
        q, case["k_cache"][:, :, :max_len], case["v_cache"][:, :, :max_len],
        allowed, dense_decode_reference(**{**case, "q": q.float()}))


DECODE_DESIGN = (
    "one body for both kernels, mma.sync m16n8k16; grid (split, kv head, "
    "slot), each CTA one run of 64..512 keys of one slot (decode_splits: "
    "at most 32 runs a slot and 1024 CTAs a call) for the kv head's G q "
    "rows, in 64-key tiles through two cp.async stages; runs past the "
    "slot's live keys exit at once; paged: the run's table entries loaded "
    "beside seq_len; a slot over several runs: f32 partials to scratch, "
    "the last run by an atomic ticket merges them in split order (one "
    "launch a call)")
# The decode kernels' timed shapes, each built for the paged and the dense
# kernel: the engine's main-path decode (llama-3-8b heads, 8 slots, lengths
# 8..576, a quarter of each left padding; paged MAXB 37, dense C 1024), 8
# slots of 512..4096 keys (MAXB 256, C 4096) and one slot of 8192 (MAXB
# 512, C 8192).
DECODE_TIMED = (
    ("main-decode",
     lambda: _decode_case(DEC_MAIN_LENS, seed=500, pad_frac=0.25, **DEC_MAIN),
     lambda: _dense_case(DEC_MAIN_LENS, seed=700, pad_frac=0.25,
                         **DENSE_MAIN)),
    ("long-4096",
     lambda: _decode_case(LONG_LENS, seed=501, pad_frac=0.25, **DEC_LONG),
     lambda: _dense_case(LONG_LENS, seed=701, pad_frac=0.25, **DENSE_LONG)),
    ("single-8192",
     lambda: _decode_case([8192], seed=502, **DEC_SINGLE),
     lambda: _dense_case([8192], seed=702, **DENSE_SINGLE)),
)
DECODE_ROW_KEYS = ("ms", "plain_ms", "library_ms", "library_backend",
                   "bound_ms", "bound_by", "ctas")


# Idle seconds a short trace spends before and after its call. The
# profiler keeps only the card's records that fall inside its window, on
# the host's clock; a kernel's start, brought to that clock, can land
# before its own launch call's, so a kernel launched at once after the
# window opens was now and then dropped, by every retry in a row.
TRACE_MARGIN_S = 0.02
# Seconds between a trace that missed its kernel and the next try.
RETRACE_PAUSE_S = 0.5


def _kernel_records(fn) -> list:
    """The kernel records of one traced run of ``fn`` (card activity
    only), the call ``TRACE_MARGIN_S`` inside the window at each end."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    return _profiled_kernels(prof)


# The card's records in a chrome trace: kernels, copies and fills.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _profiled_device_events(prof) -> list:
    """The card's records (name, ``ts`` and ``dur`` in µs, ``args``) of a
    finished ``torch.profiler`` run, from its chrome trace: kernels,
    copies and fills. (``prof.events()`` holds the same, but building it
    costs ~17 s of host time a traced rerun of ~70 steps, PERF.md §6, PR
    18.)"""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [ev for ev in events if ev.get("cat") in DEVICE_CATS]


def _profiled_kernels(prof) -> list:
    """The kernel records (name, ``dur`` in µs, ``args.grid``) of a
    finished ``torch.profiler`` run, from its chrome trace."""
    return [ev for ev in _profiled_device_events(prof)
            if ev.get("cat") == "kernel"]


def _timing_decode(label, case, kernel, reference, library_call, bound,
                   needle):
    """Phase 4 for a decode kernel at one case: the kernel, the CTAs and
    kernels its call launched (read from profiler traces), its plain
    version, the library call and the bound."""
    saved = kernel.launches
    kernel_ms = _time_ms(lambda: kernel(**case))
    grids, records = _launch_grids(lambda: kernel(**case), {"ctas": needle})
    kernel.launches = saved  # timing is no main path
    ctas = sum(math.prod(g) for g in grids["ctas"])
    per_call = len(records)
    check(per_call == 1, f"{label}: one call launched {per_call} kernels "
                         f"({[ev.get('name', '')[:40] for ev in records]})")
    b, span = case["kv_mask"].shape
    hkv = case["k_pool" if "k_pool" in case else "k_cache"].shape[1]
    split, nsplit = decode_mod.decode_splits(span, b, hkv)
    check(ctas == b * hkv * nsplit,
          f"{label}: {ctas} CTAs launched, not {b}·{hkv}·{nsplit} for "
          f"decode_splits' {nsplit} runs of {split} keys")
    plain_ms = _time_ms(lambda: reference(**case))
    call, backend = library_call(case)
    library_ms = _time_ms(call)
    bound_ms, bound_by, work = bound(case)
    log(f"  {label}: kernel {kernel_ms:.4f} ms ({ctas} CTAs: {nsplit} runs "
        f"of {split} keys a slot, {per_call} launch a call), plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (SDPA {backend}), "
        f"bound {bound_ms:.4f} ms ({bound_by}; {work['bytes']} B, "
        f"{work['flops']} FLOP)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_backend=backend, bound_ms=bound_ms,
                bound_by=bound_by, ctas=ctas, split=split,
                launches_per_call=per_call, **work)


def timing_decode():
    """Phase 4, paged decode: {shape name: row} at every DECODE_TIMED
    shape; main-decode also times the dense kernel on the same keys
    gathered into contiguous caches (``dense_on_gathered_ms``), which
    leaves the table walk as the two kernels' only difference."""
    rows = {}
    for name, make, _ in DECODE_TIMED:
        case = make()
        rows[name] = _timing_decode(
            f"decode {name}", case, paged_decode_attention,
            paged_decode_reference, _decode_library_call, _decode_bound,
            "paged_decode_kernel")
        if name == "main-decode":
            rows[name]["dense_on_gathered_ms"] = _dense_on_gathered_ms(case)
        del case
    return rows


def _dense_on_gathered_ms(case) -> float:
    """The dense kernel's time on a paged case's keys gathered into
    (B, Hkv, MAXB·BS, D) caches, with its mask and lengths."""
    tables = case["tables"].long()
    b, _, d = case["q"].shape
    _, hkv, bs, _ = case["k_pool"].shape

    def dense(pool):
        return (pool[tables].permute(0, 2, 1, 3, 4)
                .reshape(b, hkv, tables.shape[1] * bs, d).contiguous())

    gathered = dict(q=case["q"], k_cache=dense(case["k_pool"]),
                    v_cache=dense(case["v_pool"]), kv_mask=case["kv_mask"],
                    seq_lens=case["seq_lens"], block_size=bs)
    saved = dense_decode_attention.launches
    ms = _time_ms(lambda: dense_decode_attention(**gathered))
    dense_decode_attention.launches = saved
    log(f"  dense kernel on the gathered main-decode keys: {ms:.4f} ms")
    return ms


def timing_dense():
    """Phase 4, dense decode: {shape name: row} at every DECODE_TIMED
    shape."""
    rows = {}
    for name, _, make in DECODE_TIMED:
        case = make()
        rows[name] = _timing_decode(
            f"dense {name}", case, dense_decode_attention,
            dense_decode_reference, _dense_library_call, _dense_bound,
            "dense_decode_kernel")
        del case
    return rows


# ---------------------------------------------------------------------------
# Quantized weights: the quant_matmul kernel


# llama-3-8b's weights as the kernel reads them: (name, rows, cols, head).
# A layer weight is (K, N) = (rows, cols); the lm head is (V, K). Then a
# layer weight whose N = 1040 is not a multiple of the 128-channel tile,
# and a head whose V = 1000 is not a multiple of a CTA's 128 rows.
QUANT_SHAPES = (
    ("wq-wo", 4096, 4096, False),
    ("wk-wv", 4096, 1024, False),
    ("w_gate-w_up", 4096, 14336, False),
    ("w_down", 14336, 4096, False),
    ("lm_head", 128256, 4096, True),
    ("odd-1040", 4096, 1040, False),
    ("odd-head-1000", 1000, 4096, True),
)
QUANT_SCHEMES = ("int8", "int4", "fp8")
QUANT_ROWS = (1, 8, qmm_mod.MAX_ROWS)
QUANT_GROUP = 128  # the int4 group, quantize_params' default
# Kernel vs plain, both rounding at the same points (bf16 product, then the
# scale; or the bf16 int4 operand) and differing only in the order of
# their f32 sums: a value moves by at most one bf16 rounding where the two
# sums fall either side of a rounding boundary. "rel": element by element
# |out − ref| <= 2^-7 · (|ref| + ref_abs), twice the bf16 rounding bound,
# ref_abs the product of |x| and |W| (the sum before any cancellation);
# "row_rel": per row ‖out − ref‖ <= 2^-8 · ‖ref‖, the bf16 rounding bound
# itself (few values of a row move at all).
QUANT_GATES = {"rel": 2.0 ** -7, "row_rel": 2.0 ** -8}
QUANT_DESIGN = (
    "mma.sync m16n8k16 with the weight as the A operand (16 channels a "
    "tile) and x^T as B (one or two 8-row tiles, M <= 16); the A fragment "
    "built in registers from 16-byte loads (int4: 8 bytes, 16 values) by "
    "exact bit operations, x staged in shared memory; layer weights (K, N): "
    "CTAs of 8 warps over 128 channels, the warps splitting the k-steps and "
    "adding their partials in warp order, the contraction split over CTAs "
    "where the tiles leave SMs idle (kn_plan, one wave), split partials "
    "merged by a ticket in split order; the head (V, K): a warp per 16-row "
    "tile over the whole contraction, 4 loads a row in flight")


def _quant_source(name, rows, cols, head, seed):
    """The bf16 weight of a QUANT_SHAPES entry: N(0, 1/K) from the seed."""
    k = cols if head else rows
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return (torch.randn(rows, cols, generator=g, device=DEVICE)
            * (1.0 / math.sqrt(k))).to(torch.bfloat16)


def _quantize_one(w, scheme, head):
    axis = 1 if head else 0
    if scheme == "int8":
        return quant_mod.quantize_weight(w, axis)
    if scheme == "fp8":
        return quantize_weight_fp8(w, axis)
    return quant_mod.quantize_weight_int4(w, axis, group=QUANT_GROUP)


def _quant_x(m, k, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return torch.randn(m, k, generator=g, device=DEVICE).to(torch.bfloat16)


def _quant_errors(out, ref, x, w, head) -> dict:
    deq = quant_mod.dequantize_weight(w, torch.float32).abs()
    ref_abs = x.float().abs() @ (deq.T if head else deq)
    diff = (out.float() - ref.float()).abs()
    reff = ref.float()
    row = (torch.linalg.vector_norm(diff, dim=-1)
           / torch.linalg.vector_norm(reff, dim=-1).clamp_min(1e-30))
    return {"abs": float(diff.max()),
            "rel": float((diff / (reff.abs() + ref_abs)
                          .clamp_min(1e-30)).max()),
            "row_rel": float(row.max())}


def check_quant_repeat(first, again, name: str) -> None:
    check(_same_bits(first, again),
          f"{name}: quant_matmul repeats differ in bits")


@contextlib.contextmanager
def _f32_reductions():
    """cuBLAS's bf16 products with f32 reductions only (no bf16 split-K
    partials): the plain version's sums as exact as the kernel's."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved


def quant_vs_plain():
    """Phase 3, quant_matmul: every QUANT_SHAPES weight under each scheme
    at M in QUANT_ROWS, against the plain version on the same inputs, at
    QUANT_GATES; each call run twice, bit-equal; and one traced call per
    weight and scheme at M = 8 that must be one launch of the kernel with
    kernel_ctas' CTAs and nothing else (no cast, no copy). Returns the
    worst of each error."""
    saved = quant_matmul.launches
    worst = dict.fromkeys(("abs", "rel", "row_rel"), 0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with _f32_reductions():
        for i, (name, rows, cols, head) in enumerate(QUANT_SHAPES):
            k, n = (cols, rows) if head else (rows, cols)
            src = _quant_source(name, rows, cols, head, SEED + 900 + i)
            for scheme in QUANT_SCHEMES:
                w = _quantize_one(src, scheme, head)
                for m in QUANT_ROWS:
                    x = _quant_x(m, k, SEED + 950 + m)
                    out = quant_matmul(x, w.q, w.s, scheme, head)
                    again = quant_matmul(x, w.q, w.s, scheme, head)
                    ref = quant_matmul_reference(x, w.q, w.s, scheme, head)
                    torch.cuda.synchronize()
                    label = f"{name} {scheme} M={m}"
                    check_quant_repeat(out, again, label)
                    errs = _quant_errors(out, ref, x, w, head)
                    for gate, limit in QUANT_GATES.items():
                        check(errs[gate] <= limit,
                              f"{label}: {gate} error {errs[gate]:.3e} > "
                              f"{limit:.3e}")
                    for key in worst:
                        worst[key] = max(worst[key], errs[key])
                x = _quant_x(8, k, SEED + 958)
                grids, records = _launch_grids(
                    lambda: quant_matmul(x, w.q, w.s, scheme, head),
                    {"ctas": "quant_mm_"})
                names = [ev.get("name", "")[:48] for ev in records]
                check(len(records) == 1,
                      f"{name} {scheme}: one call launched {names}")
                ctas = math.prod(grids["ctas"][0])
                want = qmm_mod.kernel_ctas(k, n, head, sms)
                check(ctas == want, f"{name} {scheme}: {ctas} CTAs, "
                                    f"kernel_ctas says {want}")
                del w
            log(f"  quant_matmul {name} ({rows}x{cols}"
                f"{', head' if head else ''}): int8, int4, fp8 at M "
                f"{QUANT_ROWS} within {QUANT_GATES}, repeats bit-equal, one "
                f"launch of {qmm_mod.kernel_ctas(k, n, head, sms)} CTAs a "
                f"call; worst so far {json.dumps(worst)}")
            del src
    quant_matmul.launches = saved  # comparisons are no main path
    torch.cuda.empty_cache()
    return worst


def _quant_bound(w, m, k, n, head) -> tuple[float, str, dict]:
    """Each input read once (q, s, x) and the output written once (bf16,
    the head f32), over HBM bandwidth; 2·M·K·N FLOPs over the bf16 peak."""
    nbytes = (w.q.numel() * w.q.element_size() + w.s.numel() * 4
              + m * k * 2 + m * n * (4 if head else 2))
    return _bound_of(nbytes, 2 * m * k * n)


def _host_us(fn, calls: int = 1000) -> float:
    """The host's microseconds a call of ``fn``, over ``calls`` calls queued
    back to back (the card runs behind; the queue is synchronized after
    the clock stops)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took / calls * 1e6


# The row counts phase 4 times: the decode width of every engine's steps,
# and a 512-row admission, which goes to the wide path.
QUANT_M = 8
QUANT_WIDE_M = 512
QUANT_ROW_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                  "wide_512_ms", "library_512_ms", "bound_512_ms", "ctas",
                  "host_us", "library_host_us")


def timing_quant():
    """Phase 4, quant_matmul at M = 8 for each QUANT_SHAPES weight (the odd
    shapes left out) and scheme: the kernel, its plain version (the wide
    path's expression), the library yardstick (``torch.matmul`` on the
    bf16 weight of the same shape: what the bf16 engine runs) and the
    bound; at M = 512 the wide path, the yardstick and the bound. Returns
    {shape: {scheme: row}}."""
    saved = quant_matmul.launches, quant_matmul_wide.calls
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out: dict = {}
    for i, (name, rows, cols, head) in enumerate(QUANT_SHAPES):
        if name.startswith("odd"):
            continue
        k, n = (cols, rows) if head else (rows, cols)
        src = _quant_source(name, rows, cols, head, SEED + 900 + i)
        x = _quant_x(QUANT_M, k, SEED + 960)
        xw = _quant_x(QUANT_WIDE_M, k, SEED + 961)
        lib = (lambda a: a @ src.T) if head else (lambda a: a @ src)
        library_ms = _time_ms(lambda: lib(x))
        library_512_ms = _time_ms(lambda: lib(xw))
        rows_out[name] = {}
        for scheme in QUANT_SCHEMES:
            w = _quantize_one(src, scheme, head)
            # The model's path: the kernel, with the weight's checked plan.
            ms = _time_ms(lambda: quant_mod.matmul(x, w))
            plain_ms = _time_ms(
                lambda: quant_matmul_reference(x, w.q, w.s, scheme, head))
            wide_ms = _time_ms(
                lambda: quant_matmul_wide(xw, w.q, w.s, scheme, head))
            bound_ms, bound_by, work = _quant_bound(w, QUANT_M, k, n, head)
            bound_512, by_512, _ = _quant_bound(w, QUANT_WIDE_M, k, n, head)
            # What an engine's step pays on the host a product: the
            # model's path (models/quant.matmul) beside bf16's ``x @ w``.
            host = (_host_us(lambda: quant_mod.matmul(x, w)),
                    _host_us(lambda: lib(x)))
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       host_us=host[0], library_host_us=host[1],
                       bound_ms=bound_ms, bound_by=bound_by,
                       wide_512_ms=wide_ms, library_512_ms=library_512_ms,
                       bound_512_ms=bound_512, bound_512_by=by_512,
                       ctas=qmm_mod.kernel_ctas(k, n, head, sms),
                       bytes=work["bytes"])
            rows_out[name][scheme] = row
            log(f"  quant_matmul {name} {scheme} M={QUANT_M}: kernel "
                f"{ms:.4f} ms ({row['ctas']} CTAs), plain {plain_ms:.4f}, "
                f"bf16 torch.matmul {library_ms:.4f}, bound {bound_ms:.4f} "
                f"({bound_by}, {work['bytes']} B); M={QUANT_WIDE_M}: wide "
                f"path {wide_ms:.4f}, bf16 torch.matmul {library_512_ms:.4f}, "
                f"bound {bound_512:.4f} ({by_512}); host {host[0]:.1f} µs a "
                f"call, bf16 {host[1]:.1f}")
            del w
        del src, x, xw
    quant_matmul.launches, quant_matmul_wide.calls = saved
    torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# Engines


def _zero_counts() -> None:
    for wrapper in (ragged_paged_attention, flash_attention_fwd,
                    paged_decode_attention, dense_decode_attention,
                    flash_bwd_dq, flash_bwd_dkv, quant_matmul):
        wrapper.launches = 0
    quant_matmul_wide.calls = 0
    fp8_mod.fp8_product.launches = 0


def _counts() -> dict:
    return {"ragged": ragged_paged_attention.launches,
            "flash": flash_attention_fwd.launches,
            "decode": paged_decode_attention.launches,
            "dense": dense_decode_attention.launches,
            "bwd_dq": flash_bwd_dq.launches,
            "bwd_dkv": flash_bwd_dkv.launches,
            "quant": quant_matmul.launches,
            "wide": quant_matmul_wide.calls,
            "fp8": fp8_mod.fp8_product.launches}


def _prompts(cfg, n: int, lo: int, hi: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    lengths = np.linspace(lo, hi, n).astype(int)
    return [rng.integers(3, cfg.vocab_size, size=int(m)).tolist()
            for m in lengths]


# New tokens a request in phase 5's traced reruns (its untraced runs take
# 64): the profiler's cost grows with the steps it records.
TRACE_NEW = 16


def _engine(params, cfg, kv_bits: int, attn_kernel=None, ragged=True,
            max_new=64):
    return PagedBatcher(
        params, cfg, gen=GenerationConfig(max_new_tokens=max_new, eos_id=-1),
        slots=8, num_blocks=8 * 37 + 24, block_size=16, prompt_bucket=512,
        ragged=ragged, token_budget=512 if ragged else None,
        kv_bits=kv_bits, attn_kernel=attn_kernel, device=DEVICE,
    )


def _cont_engine(params, cfg, attn_kernel=None, admit_chunk=None,
                 plan=None, max_new=64):
    return ContinuousBatcher(
        params, cfg, gen=GenerationConfig(max_new_tokens=max_new, eos_id=-1),
        slots=8, cache_len=1024, prompt_bucket=512, attn_kernel=attn_kernel,
        admit_chunk=admit_chunk, plan=plan, device=DEVICE,
    )


@contextlib.contextmanager
def _counting_calls(module, *names):
    """Count the calls of ``module.<name>`` for each name while inside;
    yields {name: calls}. The engines look these functions up in their
    module at each call, so the wrappers see every one."""
    calls = dict.fromkeys(names, 0)
    real = {n: getattr(module, n) for n in names}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(module, name, real[name])


@contextlib.contextmanager
def _plain_prefill(module, name):
    """An engine's admissions (``module.<name>``) with ``impl="xla"``: the
    plain flash attention on the card."""
    real = getattr(module, name)
    setattr(module, name, functools.partial(real, attn_impl="xla"))
    try:
        yield
    finally:
        setattr(module, name, real)


def _serve(engine, prompts):
    rids = [engine.submit(p) for p in prompts]
    out = engine.run()
    lps = engine.run_logprobs()
    return [out[r] for r in rids], [lps[r] for r in rids]


def _check_outputs(cfg, toks, lps) -> None:
    for tk, lp in zip(toks, lps):
        check(len(tk) == 64 and len(lp) == 64, "a request stopped early")
        check(all(0 <= x < cfg.vocab_size for x in tk), "token off vocab")
        check(all(math.isfinite(x) and x <= 1e-4 for x in lp),
              "non-finite or positive logprob")


def _compare(kern, plain) -> dict:
    """Tokens equal, or a fork after the first token with the chosen-token
    logprobs before it within TOL. Returns per prompt the fork position
    (-1: none), the largest logprob gap before it, and the two engines'
    chosen-token logprobs at the fork (close values mean a near-tie)."""
    report = []
    for (kt, kl), (pt, pl) in zip(zip(*kern), zip(*plain)):
        fork = next((i for i, (a, b) in enumerate(zip(kt, pt)) if a != b),
                    -1)
        check(fork != 0, "kernel and plain engines disagree on the first "
                         "token")
        upto = len(kt) if fork < 0 else fork
        diff = max((abs(a - b) for a, b in zip(kl[:upto], pl[:upto])),
                   default=0.0)
        check(diff <= TOL, f"chosen-token logprobs differ by {diff} before "
                           f"the fork at {fork}")
        report.append({"fork": fork, "max_logprob_diff": diff,
                       "at_fork": None if fork < 0 else [kl[fork], pl[fork]]})
    return report


def engine_phase(params, cfg, runs=None):
    """Phase 5, the ragged engine: returns ({variant: launches}, the bf16
    engine). ``runs``, where given, keeps each variant's (tokens,
    logprobs, wall) under ("ragged", kv_bits, prompts) for phase 8."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    launches, engines = {}, {}
    for variant, bits in (("bf16", 0), ("int8", 8)):
        engine = _engine(params, cfg, bits)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
        launches[variant] = counts["ragged"]
        steps = engine.ragged_steps
        check(steps > 0, "the engine ran no step")
        check(launches[variant] == steps * cfg.n_layers,
              f"{variant}: {launches[variant]} kernel launches for {steps} "
              f"ragged steps × {cfg.n_layers} layers")
        check(counts["flash"] == counts["decode"] == counts["dense"] == 0,
              f"{variant}: the ragged engine launched {counts}")
        _check_outputs(cfg, toks, lps)
        if runs is not None:
            runs[("ragged", bits, len(prompts))] = (toks, lps, wall)
        n_tok = sum(len(tk) for tk in toks)
        peak = torch.cuda.max_memory_allocated()
        log(f"  ragged {variant}: {steps} steps, {engine.ragged_tokens} rows,"
            f" {n_tok} tokens out, {wall:.3f} s wall, {launches[variant]} "
            f"kernel launches, peak {peak / 2**30:.2f} GiB")
        # Kernel vs plain attention on the same 4 prompts and schedule.
        sub = prompts[::4]
        t0 = time.monotonic()
        kern = _serve(_engine(params, cfg, bits), sub)
        plain = _serve(_engine(params, cfg, bits, attn_kernel=False), sub)
        report = _compare(kern, plain)
        log(f"  ragged {variant}: kernel vs plain engine on 4 prompts "
            f"(fork -1 = tokens equal; {time.monotonic() - t0:.2f} s): "
            f"{json.dumps(report)}")
        t0 = time.monotonic()
        traced = _engine(params, cfg, bits, max_new=TRACE_NEW)
        trace = _trace(traced, prompts[::2], {"attention": "ragged_kernel"})
        trace["steps"] = traced.ragged_steps
        log(f"  ragged {variant}: traced rerun of 8 prompts, {TRACE_NEW} "
            "new tokens each "
            f"({time.monotonic() - t0:.2f} s): {json.dumps(trace)}")
        engines[variant] = engine
    return launches, engines["bf16"]


def alternating_phase(params, cfg, runs=None):
    """Phase 5, the alternating engine with a bf16 pool: returns
    ({"flash": launches, "decode": launches}, the engine). ``runs``, where
    given, keeps the 4-prompt kernel run under "alternating"."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    engine = _engine(params, cfg, 0, ragged=False)
    check(engine.attn_kernel, "the alternating engine's decode kernel is off")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting_calls(paged_mod, "_paged_admit", "_paged_step") as calls:
        _zero_counts()
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
    admits, steps = calls["_paged_admit"], calls["_paged_step"]
    check(admits > 0 and steps > 0, "the engine ran no admission or step")
    check(counts["flash"] == admits * cfg.n_layers,
          f"{counts['flash']} flash launches for {admits} admissions × "
          f"{cfg.n_layers} layers")
    check(counts["decode"] == steps * cfg.n_layers,
          f"{counts['decode']} decode launches for {steps} steps × "
          f"{cfg.n_layers} layers")
    check(counts["ragged"] == counts["dense"] == 0,
          f"the alternating engine launched {counts}")
    _check_outputs(cfg, toks, lps)
    n_tok = sum(len(tk) for tk in toks)
    peak = torch.cuda.max_memory_allocated()
    log(f"  alternating bf16: {admits} admissions, {steps} decode steps, "
        f"{n_tok} tokens out, {wall:.3f} s wall, {counts['flash']} flash and "
        f"{counts['decode']} decode launches, peak {peak / 2**30:.2f} GiB")
    sub = prompts[::4]
    t0 = time.monotonic()
    kern = _serve(_engine(params, cfg, 0, ragged=False), sub)
    if runs is not None:
        runs["alternating"] = kern
    with _plain_prefill(paged_mod, "_paged_admit"):
        plain = _serve(_engine(params, cfg, 0, ragged=False,
                               attn_kernel=False), sub)
    report = _compare(kern, plain)
    log(f"  alternating bf16: kernels vs plain engine on 4 prompts "
        f"(fork -1 = tokens equal; {time.monotonic() - t0:.2f} s): "
        f"{json.dumps(report)}")
    t0 = time.monotonic()
    with _counting_calls(paged_mod, "_paged_admit", "_paged_step") as calls:
        trace = _trace(_engine(params, cfg, 0, ragged=False,
                               max_new=TRACE_NEW), prompts[::2],
                       {"flash": "flash_fwd_kernel",
                        "decode": "paged_decode_kernel"})
    trace["admissions"] = calls["_paged_admit"]
    trace["steps"] = calls["_paged_step"]
    log(f"  alternating bf16: traced rerun of 8 prompts, {TRACE_NEW} new "
        "tokens each "
        f"({time.monotonic() - t0:.2f} s): {json.dumps(trace)}")
    return {"flash": counts["flash"], "decode": counts["decode"]}, engine


def continuous_phase(params, cfg, runs=None):
    """Phase 5, the continuous engine with a bf16 cache of 1024 positions
    per slot: returns ({"flash": launches, "dense": launches}, the
    engine). ``runs``, where given, keeps the 4-prompt kernel run under
    "continuous"."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    engine = _cont_engine(params, cfg)
    check(engine._attn_kernel == 512,
          f"the continuous engine's dense kernel is off "
          f"(block size {engine._attn_kernel})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _counting_calls(cont_mod, "_admit_slot", "_cb_step") as calls:
        _zero_counts()
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
    admits, steps = calls["_admit_slot"], calls["_cb_step"]
    check(admits > 0 and steps > 0, "the engine ran no admission or step")
    check(counts["flash"] == admits * cfg.n_layers,
          f"{counts['flash']} flash launches for {admits} admissions × "
          f"{cfg.n_layers} layers")
    check(counts["dense"] == steps * cfg.n_layers,
          f"{counts['dense']} dense decode launches for {steps} steps × "
          f"{cfg.n_layers} layers")
    check(counts["ragged"] == counts["decode"] == 0,
          f"the continuous engine launched {counts}")
    _check_outputs(cfg, toks, lps)
    n_tok = sum(len(tk) for tk in toks)
    peak = torch.cuda.max_memory_allocated()
    log(f"  continuous bf16: {admits} admissions, {steps} decode steps, "
        f"{n_tok} tokens out, {wall:.3f} s wall, {counts['flash']} flash and "
        f"{counts['dense']} dense decode launches, peak "
        f"{peak / 2**30:.2f} GiB")
    sub = prompts[::4]
    t0 = time.monotonic()
    kern = _serve(_cont_engine(params, cfg), sub)
    if runs is not None:
        runs["continuous"] = kern
    with _plain_prefill(cont_mod, "_admit_slot"):
        plain = _serve(_cont_engine(params, cfg, attn_kernel=False), sub)
    report = _compare(kern, plain)
    log(f"  continuous bf16: kernels vs plain engine on 4 prompts "
        f"(fork -1 = tokens equal; {time.monotonic() - t0:.2f} s): "
        f"{json.dumps(report)}")
    t0 = time.monotonic()
    chunked = _serve(_cont_engine(params, cfg, admit_chunk=128), sub)
    report = _compare(kern, chunked)
    log(f"  continuous bf16: one-shot vs admit_chunk=128 on 4 prompts "
        f"(fork -1 = tokens equal; {time.monotonic() - t0:.2f} s): "
        f"{json.dumps(report)}")
    t0 = time.monotonic()
    with _counting_calls(cont_mod, "_admit_slot", "_cb_step") as calls:
        trace = _trace(_cont_engine(params, cfg, max_new=TRACE_NEW),
                       prompts[::2],
                       {"flash": "flash_fwd_kernel",
                        "decode": "dense_decode_kernel"})
    trace["admissions"] = calls["_admit_slot"]
    trace["steps"] = calls["_cb_step"]
    log(f"  continuous bf16: traced rerun of 8 prompts, {TRACE_NEW} new "
        "tokens each "
        f"({time.monotonic() - t0:.2f} s): {json.dumps(trace)}")
    return {"flash": counts["flash"], "dense": counts["dense"]}, engine


# The quantized engines phase 5 serves: the ragged engine under each
# scheme, and under int8 the continuous engine (what ``serve_http --int8``
# serves).
QUANT_ENGINES = ((8, ("ragged", "continuous")), (4, ("ragged",)),
                 ("fp8", ("ragged",)))


def _quant_label(bits) -> str:
    return "fp8" if bits == "fp8" else f"int{bits}"


@contextlib.contextmanager
def _plain_quant():
    """Every quantized product of the model through its plain version on
    the card (``quant_matmul_reference``), kernel and wide path alike."""
    real = L.quant_matmul

    def plain(x, w):
        return quant_matmul_reference(x, w.q, w.s, w.scheme, w.axis == 1)

    L.quant_matmul = plain
    try:
        yield
    finally:
        L.quant_matmul = real


@contextlib.contextmanager
def _recording(module, name, record):
    """Append ``record(*args, **kwargs)`` to a list for each call of
    ``module.<name>`` while inside; yields the list."""
    seen = []
    real = getattr(module, name)

    def call(*args, **kwargs):
        seen.append(record(*args, **kwargs))
        return real(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _expected_quant_calls(kind, widths, admits, steps, n_layers) -> dict:
    """The quant_matmul launches and wide-path calls a run must make: each
    forward pass runs 7 products a layer at its width (the kernel up to
    MAX_ROWS rows, the wide path above) and one lm-head product at the
    rows it samples (a slot each, or the one row an admission samples),
    always on the kernel. ``widths``: the ragged steps' dispatch widths;
    the continuous engine's admissions are 512 rows and its steps 8."""
    per = 7 * n_layers
    if kind == "ragged":
        narrow = sum(w <= qmm_mod.MAX_ROWS for w in widths)
        return {"quant": (per + 1) * narrow + (len(widths) - narrow),
                "wide": per * (len(widths) - narrow)}
    return {"quant": (per + 1) * steps + admits, "wide": per * admits}


@contextlib.contextmanager
def _wide_on_side():
    """While inside, every wide-path product runs on a stream of its own,
    ordered against the engine's stream both ways (so the card's work
    keeps its order); yields [the wide-path calls made]."""
    real = quant_mod.quant_matmul_wide
    side: list = []
    calls = [0]

    def on_side(*args, **kwargs):
        if not side:
            side.append(torch.cuda.Stream())
        main = torch.cuda.current_stream()
        side[0].wait_stream(main)
        with torch.cuda.stream(side[0]):
            out = real(*args, **kwargs)
        main.wait_stream(side[0])
        out.record_stream(main)
        calls[0] += 1
        return out

    quant_mod.quant_matmul_wide = on_side
    try:
        yield calls
    finally:
        quant_mod.quant_matmul_wide = real


def _wide_seconds(records, calls: int) -> float:
    """The card's seconds in the kernels of ``records`` on streams other
    than the one most kernels ran on: the wide path's, run under
    ``_wide_on_side`` with ``calls`` wide-path calls (none of them and
    calls made, or the reverse, fails)."""
    streams = collections.Counter(ev.get("args", {}).get("stream")
                                  for ev in records)
    engine_stream = streams.most_common(1)[0][0]
    wide = [ev for ev in records
            if ev.get("args", {}).get("stream") != engine_stream]
    check(bool(wide) == bool(calls),
          f"{calls} wide-path calls, {len(wide)} kernels off the "
          "engine's stream")
    return sum(ev.get("dur", 0) for ev in wide) / 1e6


def _quant_engine(qparams, cfg, kind, label, prompts) -> dict:
    """Phase 5, one quantized engine: the main-path run with its launch
    arithmetic checked, kernel vs plain products on 4 prompts, and the
    traced reruns. Returns its record."""
    if kind == "ragged":
        def make(**kw):
            return _engine(qparams, cfg, 0, **kw)
        watch = (paged_mod, "_paged_ragged_step",
                 lambda params, cfg_, tokens, *a, **k: tokens.shape[0])
        attention = {"attention": "ragged_kernel"}
    else:
        def make(**kw):
            return _cont_engine(qparams, cfg, **kw)
        watch = (cont_mod, "_admit_slot", lambda *a, **k: None)
        attention = {"flash": "flash_fwd_kernel",
                     "decode": "dense_decode_kernel"}
    engine = make()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _recording(*watch) as seen, \
            _counting_calls(cont_mod, "_cb_step") as calls:
        _zero_counts()
        t0 = time.monotonic()
        toks, lps = _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = _counts()
    n = cfg.n_layers
    if kind == "ragged":
        steps, admits = engine.ragged_steps, 0
        check(len(seen) == steps > 0, f"{len(seen)} ragged steps recorded, "
                                      f"the engine counts {steps}")
        check(counts["ragged"] == steps * n,
              f"{counts['ragged']} ragged launches for {steps} steps")
        want = _expected_quant_calls(kind, seen, 0, steps, n)
    else:
        steps, admits = calls["_cb_step"], len(seen)
        check(admits > 0 and steps > 0, "the engine ran no admission or step")
        check(counts["flash"] == admits * n and counts["dense"] == steps * n,
              f"{label} continuous: attention launches {counts} for "
              f"{admits} admissions and {steps} steps")
        want = _expected_quant_calls(kind, (), admits, steps, n)
    got = {"quant": counts["quant"], "wide": counts["wide"]}
    check(got == want, f"{kind} {label}: quantized products {got}, the "
                       f"steps ask for {want}")
    _check_outputs(cfg, toks, lps)
    peak = torch.cuda.max_memory_allocated()
    widths = ({str(w): seen.count(w) for w in sorted(set(seen))}
              if kind == "ragged" else None)
    log(f"  {kind} {label}: {steps} steps, {admits} admissions, "
        f"{sum(len(t) for t in toks)} tokens out, {wall:.3f} s wall, "
        f"{got['quant']} quant_matmul launches and {got['wide']} wide-path "
        f"products (steps by width: {widths}), weights "
        f"{quant_mod.quantized_bytes(qparams) / 2**30:.2f} GiB, peak "
        f"{peak / 2**30:.2f} GiB")
    sub = prompts[::4]
    t0 = time.monotonic()
    kern = _serve(make(), sub)
    with _plain_quant():
        plain = _serve(make(), sub)
    report = _compare(kern, plain)
    log(f"  {kind} {label}: kernel vs plain products on 4 prompts "
        f"(fork -1 = tokens equal; {time.monotonic() - t0:.2f} s): "
        f"{json.dumps(report)}")
    t0 = time.monotonic()
    trace = _trace(make(max_new=TRACE_NEW), prompts[::2],
                   {"quant": "quant_mm_", **attention}, wide=True)
    trace["weight_products_s"] = trace["quant_s"] + trace["wide_path_s"]
    log(f"  {kind} {label}: traced rerun of 8 prompts, {TRACE_NEW} new "
        "tokens each "
        f"({time.monotonic() - t0:.2f} s): {json.dumps(trace)}")
    return {"launches": got["quant"], "wide_calls": got["wide"],
            "steps": steps, "admissions": admits, "wall_s": wall,
            "peak_gib": peak / 2**30, "widths": widths,
            "weight_bytes": quant_mod.quantized_bytes(qparams),
            "compare": report, "trace": trace}


def quant_engine_phase(params, cfg) -> dict:
    """Phase 5, quantized weights: for each QUANT_ENGINES scheme, the
    projections and the lm head of ``params`` (kept in bf16 for the phases
    after) quantized on the card, each engine served by ``_quant_engine``,
    then the quantized model freed. Returns {engine label: record}."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    rows = {}
    for bits, kinds in QUANT_ENGINES:
        t0 = time.monotonic()
        qparams = quant_mod.quantize_params(params, bits=bits)
        torch.cuda.synchronize()
        label = _quant_label(bits)
        log(f"  quantized to {label} in {time.monotonic() - t0:.2f} s")
        for kind in kinds:
            rows[f"{kind}-{label}"] = _quant_engine(qparams, cfg, kind,
                                                    label, prompts)
        del qparams
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _busy_seconds(intervals) -> float:
    """Length of the union of [start, end) intervals (us), in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def _trace(engine, prompts, kernels: dict, wide: bool = False) -> dict:
    """Serve the prompts under ``torch.profiler`` (card activity only) and
    read that one run: its wall seconds, the card's busy seconds (the
    union of kernel intervals), the idle share 1 − busy/wall, each of
    ``kernels``' ({label: name substring}) device seconds and share of
    busy time, and its [launches, device seconds] by launch grid (the
    grid tells a step's dispatch width), and the six largest kernels'
    device seconds. With ``wide`` the wide path's products run on a
    stream of their own (``_wide_on_side``) and its device seconds and
    calls join the record. The
    profiler's own cost on the host stretches this run's wall, so its
    idle share is an upper bound for an untraced run."""
    from torch.profiler import ProfilerActivity, profile

    with contextlib.ExitStack() as stack:
        calls = stack.enter_context(_wide_on_side()) if wide else None
        prof = stack.enter_context(profile(
            activities=[ProfilerActivity.CUDA]))
        t0 = time.monotonic()
        _serve(engine, prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name: dict[str, float] = {}
    intervals = []
    device = _profiled_device_events(prof)
    for ev in device:
        dur = ev.get("dur", 0)
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + dur / 1e6
        intervals.append((ev["ts"], ev["ts"] + dur))
    busy = _busy_seconds(intervals)
    check(busy > 0, "the trace holds no kernel on the card")
    out = {"wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall}
    records = [ev for ev in device if ev.get("cat") == "kernel"]
    if wide:
        out["wide_path_s"] = _wide_seconds(records, calls[0])
        out["wide_path_calls"] = calls[0]
    for label, needle in kernels.items():
        seconds = sum(v for k, v in by_name.items() if needle in k)
        check(seconds > 0, f"the trace holds no {needle} on the card")
        out[f"{label}_s"] = seconds
        out[f"{label}_share_of_busy"] = seconds / busy
        by_grid: dict[str, list] = {}
        for ev in records:
            if needle in ev.get("name", ""):
                grid = "x".join(map(str, ev.get("args", {}).get("grid") or []))
                row = by_grid.setdefault(grid, [0, 0.0])
                row[0] += 1
                row[1] += ev.get("dur", 0) / 1e6
        out[f"{label}_by_grid"] = dict(sorted(by_grid.items(),
                                              key=lambda kv: -kv[1][1]))
    # The dense matrix products' kernels (cuBLAS names them nvjet, gemm
    # or xmma): a bf16 engine's weight products, a quantized engine's
    # wide path.
    out["gemm_s"] = sum(v for k, v in by_name.items()
                        if any(t in k for t in ("nvjet", "gemm", "xmma")))
    # NCCL's kernels (a sharded model's collectives; none elsewhere).
    out["nccl_s"] = sum(v for k, v in by_name.items() if "nccl" in k.lower())
    out["nccl_launches"] = sum(1 for ev in records
                               if "nccl" in ev.get("name", "").lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out["top_kernels_s"] = [[k[:60], v] for k, v in top]
    return out


def _launch_grids(fn, kernels: dict) -> tuple[dict, list]:
    """Run ``fn`` once under ``torch.profiler`` (card activity only) and
    read from the trace's kernel records the launch grid of each of
    ``kernels``' ({label: name substring}) launches: ({label: [grid,
    ...]}, every kernel record of the trace). The profiler now and then
    drops a kernel's record from a trace: ``fn`` is then traced again, up
    to three times."""
    tries = 3
    for attempt in range(tries):
        events = _kernel_records(fn)
        grids = {label: [ev.get("args", {}).get("grid") for ev in events
                         if needle in ev.get("name", "")]
                 for label, needle in kernels.items()}
        if all(g and all(g) for g in grids.values()):
            break
        log(f"  trace {attempt + 1} of {tries} holds no "
            f"{' or '.join(kernels.values())} launch with its grid")
        time.sleep(RETRACE_PAUSE_S)
    for label, needle in kernels.items():
        check(grids[label] and all(grids[label]),
              f"{tries} traces hold no {needle} launch with its grid")
    return grids, events


def _launched_ctas(fn, kernels: dict) -> dict:
    """The CTAs, the product of the launch grid, that each of ``kernels``'
    ({label: name substring}) kernels launched in one traced run of
    ``fn`` (``_launch_grids``)."""
    grids, _ = _launch_grids(fn, kernels)
    return {label: sum(math.prod(g) for g in grids[label])
            for label in kernels}


# ---------------------------------------------------------------------------
# HTTP


def _post(port: int, body: dict, timeout: float = 300.0, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read().decode()
    if not body.get("stream"):
        return json.loads(raw)["choices"][0]["tokens"]
    events = [line[len("data: "):] for line in raw.splitlines()
              if line.startswith("data: ")]
    check(events and events[-1] == "[DONE]", "stream did not end with [DONE]")
    out = [json.loads(e) for e in events[:-1]]
    check(all("token" in e for e in out), f"stream carried an error: {out}")
    return [e["token"] for e in out]


HTTP_PROMPTS = ((128000, 9906), (128000, 791))

# The /stats path of each STATS_PARITY family a serving replica mirrors
# into its metrics bundle (the gateway's kv_transfer and kv_peer families
# aside). The queue-depth gauge is left out: the server sets it at each
# submission, while /stats reads the queue as it stands.
SERVER_FAMILIES = {
    "tpu_serving_requests_shed_total": ("requests_shed",),
    "tpu_serving_requests_cancelled_total": ("requests_cancelled",),
    "tpu_serving_deadline_expired_total": ("deadline_expired",),
    "tpu_serving_drain_seconds": ("drain_duration_s",),
    "tpu_serving_ragged_batch_fill": ("ragged", "batch_fill"),
    "tpu_engine_step_stall_total": ("engine_step_stalls",),
    "tpu_serving_prefix_cache_hits_total": ("prefix_cache", "hits"),
    "tpu_serving_prefix_cache_misses_total": ("prefix_cache", "misses"),
    "tpu_serving_prefix_cache_evictions_total": ("prefix_cache",
                                                 "evictions"),
    "tpu_serving_prefix_cached_blocks": ("prefix_cache", "cached_blocks"),
    "tpu_serving_kv_swap_out_total": ("kv_swap", "swap_out"),
    "tpu_serving_kv_swap_in_total": ("kv_swap", "swap_in"),
    "tpu_serving_kv_swap_restored_tokens_total": ("kv_swap",
                                                  "restored_tokens"),
    "tpu_serving_kv_swap_bytes": ("kv_swap", "swap_bytes"),
    "tpu_serving_spec_accept_total": ("speculative", "accepted"),
    "tpu_serving_spec_rounds_total": ("speculative", "rounds"),
    "tpu_serving_lora_cache_hits_total": ("lora_cache", "hits"),
    "tpu_serving_lora_cache_misses_total": ("lora_cache", "misses"),
    "tpu_serving_lora_cache_evictions_total": ("lora_cache", "evictions"),
}


def check_metrics_mirror(srv, metrics, label: str) -> dict:
    """After ``srv.stop()``: scrape ``metrics`` over HTTP from a
    ``MetricsServer`` and hold every family of ``SERVER_FAMILIES`` to the
    server's /stats: equal where /stats has the value (the batch fill at
    /stats' 4 decimals), 0 where /stats has no such block. Returns
    {family: value} of the families /stats has."""
    ms = MetricsServer(metrics, port=0)
    ms.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{ms.port}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
    finally:
        ms.stop()
    stats = srv.stats()
    seen = {}
    for family, path in SERVER_FAMILIES.items():
        check(STATS_PARITY.get(family) == path[-1],
              f"{family} is not STATS_PARITY's {path[-1]}")
        got = _sample(text, family)
        node = stats
        for key in path:
            node = node.get(key) if isinstance(node, dict) else None
        if node is None:
            check(got == 0.0, f"{label}: {family} {got} with no /stats "
                              f"{'.'.join(path)}")
            continue
        if family == "tpu_serving_ragged_batch_fill":
            got = round(got, 4)
        check(got == float(node), f"{label}: /metrics {family} {got} != "
                                  f"/stats {'.'.join(path)} {node}")
        seen[family] = got
    return seen


def http_phase(engine, label: str) -> dict:
    """Phase 6: 2 prompts × (blocking, streamed), all 4 at once. On the
    ragged engine two-token prompts keep every dispatch at the 8-row
    floor; on the alternating and continuous ones every admission is one
    (1, 512) prefill and every step runs all 8 slots: either way a
    streamed copy and a blocking copy run at one width and must agree
    token for token. The server mirrors into a port ``Metrics`` bundle;
    after its stop, ``/metrics`` is scraped and each mirrored
    ``STATS_PARITY`` family held to ``/stats``. Returns {prompt: tokens}
    (phase 9 is held to it)."""
    metrics = Metrics()
    srv = InferenceServer(engine, port=0, model_name="llama-3-8b",
                          metrics=metrics, drain_s=30.0).start()
    try:
        bodies = [{"prompt": list(p), "max_tokens": 16, "stream": stream}
                  for p in HTTP_PROMPTS for stream in (False, True)]
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            results = list(pool.map(lambda b: _post(srv.port, b), bodies))
        for i in range(0, 4, 2):
            check(len(results[i]) == 16, "blocking response length")
            check(results[i] == results[i + 1],
                  f"streamed {results[i + 1]} != blocking {results[i]}")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
        check(stats["served"] == 4, f"/stats served {stats['served']} != 4")
        log(f"  {label}: 4 completions ok; /stats: served={stats['served']} "
            f"tokens_generated={stats['tokens_generated']} "
            f"ttft_s={stats['ttft_s']} ragged={stats.get('ragged')}")
    finally:
        srv.stop()
    mirrored = check_metrics_mirror(srv, metrics, label)
    log(f"  {label}: /metrics equals /stats on {len(mirrored)} mirrored "
        f"families: {json.dumps(mirrored)}")
    return {p: results[2 * i] for i, p in enumerate(HTTP_PROMPTS)}


# ---------------------------------------------------------------------------
# Prefix and handoff


PREFIX_LEN = 384  # the shared prefix: 24 blocks of 16
PREFIX_BLOCKS = 512  # llama-3-8b: 1 GiB, a pool that evicts nothing here
SWAP_BLOCKS = 32  # the host tier: 64 MiB of llama-3-8b blocks
HANDOFF_LENS = (200, 300, 400, 500)
ADMIT_ROUNDS = 5


def _prefix_engine(params, cfg, **kw):
    """The alternating engine of this phase (8 slots, block 16, bucket
    512, 64 new tokens) with ``kw`` on top: the caches, a ragged tier."""
    kw = {"slots": 8, "num_blocks": PREFIX_BLOCKS, "prompt_bucket": 512,
          **kw}
    return PagedBatcher(
        params, cfg, gen=GenerationConfig(max_new_tokens=64, eos_id=-1),
        block_size=16, device=DEVICE, **kw)


def _synced_seconds(fn, *args, **kwargs):
    """(fn's result, its seconds between two synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _shared_prefix_prompts(cfg, n: int, seed: int) -> list[list[int]]:
    """``n`` prompts: one PREFIX_LEN-token prefix, then distinct tails of
    8..116 tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, cfg.vocab_size, size=PREFIX_LEN).tolist()
    return [prefix + rng.integers(3, cfg.vocab_size, size=int(t)).tolist()
            for t in np.linspace(8, 116, n).astype(int)]


def _block_bytes(engine, blk: int) -> dict:
    """Every pool leaf's rows of one block, as bytes (bf16 through its
    16-bit view, as the wire carries it)."""
    out = {}
    for name, leaf in engine.pool.items():
        rows = leaf[:, blk].contiguous().cpu()
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)
        out[name] = rows.numpy().tobytes()
    return out


def check_imported_bytes(engine, rid: int, payload: dict) -> int:
    """Every block the payload ships equals, byte for byte, what
    ``import_blocks`` left in ``engine``'s pool; returns the blocks
    checked."""
    req = next(r for r in engine._by_slot if r is not None and r.rid == rid)
    checked = 0
    for j, ent in enumerate(payload["blocks"]):
        if "data" not in ent:
            continue
        got = _block_bytes(engine, req.blocks[j])
        for name, b64 in ent["data"].items():
            check(got[name] == base64.b64decode(b64),
                  f"imported block {j}'s {name} rows differ from the payload")
        checked += 1
    return checked


def _chain_keys(prompt, block_size: int = 16) -> list[str]:
    keys, parent = [], None
    for j in range((len(prompt) - 1) // block_size):
        parent = PagedBatcher._chain_key(
            parent, prompt[j * block_size:(j + 1) * block_size])
        keys.append(parent.hex())
    return keys


def _admission_seconds(engine, prompt) -> float:
    """One admission pass over a one-token request of ``prompt``: its
    prefill (or its cache hit), first token and retirement."""
    engine.submit(prompt, max_new_tokens=1)
    _, seconds = _synced_seconds(engine._admit_free_slots)
    check(not engine._pending(), "a one-token request outlived admission")
    engine.run()
    return seconds


def _prefix_cache_part(params, cfg) -> dict:
    """16 prompts sharing a 384-token prefix through the prefix cache:
    hits, launches, tokens against the engine without a cache; then the
    cold and hit admission seconds."""
    prompts = _shared_prefix_prompts(cfg, 16, SEED + 1)
    engine = _prefix_engine(params, cfg, prefix_cache=True)
    with _counting_calls(paged_mod, "_paged_step",
                         "_paged_prefix_admit") as calls:
        _zero_counts()
        (toks, lps), wall = _synced_seconds(_serve, engine, prompts)
        counts = _counts()
    want = (len(prompts) - 1) * (PREFIX_LEN // 16)
    check(engine.prefix_hits == want,
          f"{engine.prefix_hits} prefix hits, want {want}")
    check(engine.prefix_evictions == 0, "the prefix pool evicted")
    steps = calls["_paged_step"]
    check(steps > 0 and counts["decode"] == steps * cfg.n_layers,
          f"{counts['decode']} decode launches for {steps} steps × "
          f"{cfg.n_layers} layers")
    check(counts["flash"] == counts["ragged"] == counts["dense"] == 0,
          f"the prefix engine launched {counts}")
    _check_outputs(cfg, toks, lps)
    report = _compare((toks, lps), _serve(_prefix_engine(params, cfg),
                                          prompts))
    log(f"  prefix cache: {engine.prefix_hits} hits, "
        f"{engine.prefix_misses} misses, {calls['_paged_prefix_admit']} "
        f"tail prefills, {steps} decode steps, {counts['decode']} decode "
        f"launches, {wall:.3f} s wall; vs no cache (fork -1 = tokens "
        f"equal): {json.dumps(report)}")
    rng = np.random.default_rng(SEED + 2)
    timing = _prefix_engine(params, cfg, prefix_cache=True)
    cold, hit = [], []
    for _ in range(ADMIT_ROUNDS):
        prefix = rng.integers(3, cfg.vocab_size, size=PREFIX_LEN).tolist()
        tails = rng.integers(3, cfg.vocab_size, size=(2, 64)).tolist()
        cold.append(_admission_seconds(timing, prefix + tails[0]))
        hit.append(_admission_seconds(timing, prefix + tails[1]))
    check(timing.prefix_hits == ADMIT_ROUNDS * (PREFIX_LEN // 16),
          f"the timed admissions hit {timing.prefix_hits} blocks")
    return {"prefix_hits": engine.prefix_hits,
            "decode_launches": counts["decode"],
            "cold_admit_s": float(np.median(cold)),
            "hit_admit_s": float(np.median(hit))}


def _prompt_cache_part(params, cfg) -> dict:
    """8 identical prompts through the prompt cache: one prefill, 7 hits,
    tokens against the engine without a cache."""
    prompt = _prompts(cfg, 1, 300, 300, SEED + 3)[0]
    engine = _prefix_engine(params, cfg, prompt_cache=True)
    with _counting_calls(paged_mod, "_paged_admit", "_paged_step") as calls:
        _zero_counts()
        toks, lps = _serve(engine, [prompt] * 8)
        counts = _counts()
    admits = calls["_paged_admit"]
    check(admits == 1, f"{admits} prefills of 8 identical prompts")
    check(counts["flash"] == cfg.n_layers,
          f"{counts['flash']} flash launches for one prefill")
    check(counts["decode"] == calls["_paged_step"] * cfg.n_layers,
          f"{counts['decode']} decode launches for "
          f"{calls['_paged_step']} steps")
    check(len(engine._prompt_cache) == 1 and all(t == toks[0] for t in toks),
          "the 8 cached prompts decoded apart")
    _check_outputs(cfg, toks, lps)
    report = _compare(([toks[0]], [lps[0]]),
                      _serve(_prefix_engine(params, cfg), [prompt]))
    log(f"  prompt cache: 8 identical prompts, {admits} prefill, "
        f"{8 - admits} hits, {counts['flash']} flash launches; vs no cache "
        f"(fork -1 = tokens equal): {json.dumps(report)}")
    return {"prompt_cache_hits": 8 - admits, "flash_launches": counts["flash"]}


def _swap_part(params, cfg) -> dict:
    """A one-slot pool too small for two 384-token prefixes, with a host
    tier of SWAP_BLOCKS blocks: serving the second demotes the first
    one's leaves, serving the first again promotes them byte-exact."""
    block = paged_mod._kv_block_bytes(cfg, 16)
    rng = np.random.default_rng(SEED + 4)
    a, b = (rng.integers(3, cfg.vocab_size, size=PREFIX_LEN + 8).tolist()
            for _ in range(2))
    # 25 blocks hold a prompt, 29 its decode: 40 usable blocks cannot
    # keep a's 24 cached blocks and serve b.
    engine = _prefix_engine(params, cfg, slots=1, num_blocks=41,
                            prefix_cache=True,
                            swap_bytes=SWAP_BLOCKS * block)
    seconds = {"out": [], "in": []}
    swap_out, swap_promote = engine._swap_out, engine._swap_promote

    def timed_out(*args):
        _, dt = _synced_seconds(swap_out, *args)
        seconds["out"].append(dt)

    def timed_in(*args):
        n_out = len(seconds["out"])
        ent, dt = _synced_seconds(swap_promote, *args)
        if ent is not None:  # less the demotions its allocation made
            seconds["in"].append(dt - sum(seconds["out"][n_out:]))
        return ent

    engine._swap_out, engine._swap_promote = timed_out, timed_in
    first = _serve(engine, [a])
    snapshot = {key: _block_bytes(engine, ent["block"])
                for key, ent in engine._prefix_entries.items()}
    _serve(engine, [b])
    demoted = [key for key in snapshot if engine.swap_contains(key)]
    check(demoted, "serving the second prefix demoted none of the first's")
    again = _serve(engine, [a])
    check(engine.kv_swap_in > 0, "serving the first prefix again promoted "
                                 "nothing")
    check(engine.kv_swap_restored_tokens == 16 * engine.kv_swap_in,
          f"{engine.kv_swap_restored_tokens} restored tokens for "
          f"{engine.kv_swap_in} promotions")
    promoted = [key for key in demoted if key in engine._prefix_entries]
    check(len(promoted) == engine.kv_swap_in,
          f"{len(promoted)} of the first prefix's demoted blocks are back, "
          f"{engine.kv_swap_in} promoted")
    for key in promoted:
        check(_block_bytes(engine, engine._prefix_entries[key]["block"])
              == snapshot[key], "a promoted block's bytes differ from their "
                                "snapshot before demotion")
    _check_outputs(cfg, *again)
    report = _compare(first, again)
    log(f"  swap: {engine.kv_swap_out} blocks out, {engine.kv_swap_in} in "
        f"({engine.kv_swap_restored_tokens} tokens), {len(promoted)} "
        f"promoted blocks byte-equal; round 3 vs round 1 (fork -1 = tokens "
        f"equal): {json.dumps(report)}")
    return {"swap_out": engine.kv_swap_out, "swap_in": engine.kv_swap_in,
            "swap_out_us_per_block": float(np.median(seconds["out"])) * 1e6,
            "swap_in_us_per_block": float(np.median(seconds["in"])) * 1e6}


def _handoff_part(params, cfg) -> dict:
    """Engine A (the prefill tier) exports 4 prompts at their first token;
    an alternating engine B and then a ragged one import and decode them,
    held to A's fused run."""
    prompts = [_prompts(cfg, 1, n, n, SEED + 10 + i)[0]
               for i, n in enumerate(HANDOFF_LENS)]
    a = _prefix_engine(params, cfg, prefix_cache=True)
    payloads, export_s = {}, {}

    def export(rid, token):
        if rid not in payloads:
            payloads[rid], export_s[rid] = _synced_seconds(a.export_blocks,
                                                           rid)

    a.on_token = export
    rids = [a.submit(p, max_new_tokens=1) for p in prompts]
    a.run()
    payloads = [payloads[r] for r in rids]
    fused = _serve(_prefix_engine(params, cfg, prefix_cache=True), prompts)
    out = {"export_s": export_s[rids[-1]],
           "payload_mb": len(json.dumps(payloads[-1])) / 1e6}
    for kind in ("alternating", "ragged"):
        ragged = kind == "ragged"
        b = _prefix_engine(params, cfg, prefix_cache=not ragged,
                           ragged=ragged,
                           token_budget=512 if ragged else None)
        bids, import_s, checked = [], [], 0
        for payload in payloads:
            rid, dt = _synced_seconds(b.import_blocks, payload)
            check(rid is not None, f"{kind}: the import found no slot")
            checked += check_imported_bytes(b, rid, payload)
            bids.append(rid)
            import_s.append(dt)
        with _counting_calls(paged_mod, "_paged_step") as calls:
            _zero_counts()
            res = b.run()
            lps = b.run_logprobs()
            counts = _counts()
        got = ([res[r] for r in bids], [lps[r] for r in bids])
        _check_outputs(cfg, *got)
        report = _compare(fused, got)
        if ragged:
            launched, want = counts["ragged"], b.ragged_steps * cfg.n_layers
            others = (counts["decode"], counts["flash"], counts["dense"])
        else:
            launched = counts["decode"]
            want = calls["_paged_step"] * cfg.n_layers
            others = (counts["ragged"], counts["flash"], counts["dense"])
        check(launched > 0 and launched == want,
              f"{kind}: {launched} attention launches, want {want}")
        check(others == (0, 0, 0), f"{kind}: the import tier launched "
                                   f"{counts}")
        log(f"  handoff to {kind}: 4 payloads, {checked} blocks byte-equal, "
            f"{launched} kernel launches; vs A's fused run (fork -1 = "
            f"tokens equal): {json.dumps(report)}")
        out[f"{kind}_launches"] = launched
        if not ragged:
            out["import_s"] = import_s[-1]
    return out


def _post_json(port: int, path: str, body: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get_json(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return json.loads(resp.read())


def _kv_http_part(params, cfg) -> None:
    """A prefill-tier server's /kv/prefill payload streamed by a decode
    server through ``kv_import`` (its KV body cap raised to fit) equals a
    fused server's blocking response; /kv/probe counts the warmed prefix,
    /kv/chain → /kv/chain/import registers it on a cold server, and
    /stats carries the prefix_cache, kv_swap and kv_handoff blocks."""
    prompt = _prompts(cfg, 1, 500, 500, SEED + 20)[0]
    keys = _chain_keys(prompt)
    cap = 256 << 20
    swap = SWAP_BLOCKS * paged_mod._kv_block_bytes(cfg, 16)
    bundles = {name: Metrics() for name in ("prefill", "decode", "fused",
                                            "cold")}
    servers = {
        name: InferenceServer(
            _prefix_engine(params, cfg, num_blocks=128, **kw), port=0,
            model_name="llama-3-8b", drain_s=30.0, max_kv_body_bytes=cap,
            tier_role=role, metrics=bundles[name]).start()
        for name, role, kw in (
            ("prefill", "prefill", {"prefix_cache": True,
                                    "swap_bytes": swap}),
            ("decode", "decode", {}),
            ("fused", "fused", {"prefix_cache": True}),
            ("cold", "fused", {"prefix_cache": True}))}
    port = {name: srv.port for name, srv in servers.items()}
    try:
        hop = _post_json(port["prefill"], "/kv/prefill", {"prompt": prompt})
        check(hop["finished"]["tokens"] == [hop["payload"]["pending_token"]],
              "the prefill hop's token is not its payload's pending token")
        streamed = _post(port["decode"], {"kv_import": hop["payload"],
                                          "max_tokens": 16, "stream": True})
        blocking = _post(port["fused"], {"prompt": prompt, "max_tokens": 16})
        check(len(blocking) == 16 and streamed == blocking,
              f"kv_import stream {streamed} != fused {blocking}")
        probe = _post_json(port["prefill"], "/kv/probe", {"keys": keys})
        check(probe["matched"] == len(keys),
              f"/kv/probe matched {probe['matched']} of {len(keys)}")
        chain = _post_json(port["prefill"], "/kv/chain", {"keys": keys})
        check(chain["matched"] == len(keys), "/kv/chain fell short")
        reg = _post_json(port["cold"], "/kv/chain/import",
                         {"tokens": prompt, "payload": chain["payload"]})
        check(reg["registered"] == len(keys),
              f"/kv/chain/import registered {reg['registered']}")
        _post(port["cold"], {"prompt": prompt, "max_tokens": 4})
        cold = _get_json(port["cold"], "/stats")["prefix_cache"]
        check(cold["hits"] == len(keys),
              f"the cold server's completion hit {cold['hits']} blocks")
        stats = _get_json(port["prefill"], "/stats")
        missing = [k for k in ("prefix_cache", "kv_swap", "kv_handoff")
                   if k not in stats]
        check(not missing and stats["tier_role"] == "prefill",
              f"/stats lacks {missing}")
        check(stats["kv_handoff"]["exports"] == 1
              and stats["kv_handoff"]["chain_exports"] == 1,
              f"/stats kv_handoff {stats['kv_handoff']}")
        log(f"  HTTP: /kv/prefill payload streamed through kv_import = the "
            f"fused response; /kv/probe matched {probe['matched']}; "
            f"/kv/chain/import registered {reg['registered']}; /stats "
            f"prefix_cache={stats['prefix_cache']} "
            f"kv_handoff={stats['kv_handoff']}")
    finally:
        for srv in servers.values():
            srv.stop()
    mirrored = {name: check_metrics_mirror(srv, bundles[name], name)
                for name, srv in servers.items()}
    check(mirrored["cold"]["tpu_serving_prefix_cache_hits_total"]
          == len(keys) and "tpu_serving_kv_swap_out_total"
          in mirrored["prefill"], f"mirrored families {mirrored}")
    log(f"  HTTP: /metrics equals /stats on "
        f"{sum(map(len, mirrored.values()))} mirrored families over the "
        f"four servers: {json.dumps(mirrored)}")


def prefix_phase(params, cfg, card: str) -> dict:
    """Phase 7: the prefix and prompt caches, the swap tier, the KV
    handoff in process and over HTTP, on the serving model. Returns the
    launch counts and smoke numbers; the phase's engines are freed on
    return."""
    out = {**_prefix_cache_part(params, cfg),
           **_prompt_cache_part(params, cfg),
           **_swap_part(params, cfg),
           **_handoff_part(params, cfg)}
    _kv_http_part(params, cfg)
    numbers = {k: out[k] for k in (
        "cold_admit_s", "hit_admit_s", "export_s", "import_s", "payload_mb",
        "swap_out_us_per_block", "swap_in_us_per_block")}
    log(f"  smoke numbers (a 500-token payload; not a benchmark) on {card}: "
        f"{json.dumps(numbers)}")
    return out


# ---------------------------------------------------------------------------
# Speculation and multi-LoRA


DRAFT_LAYERS = 8  # serve_http's draft of llama-3-8b: n_layers // 4
SELF_DRAFT_MIN = 0.9  # a self-draft's acceptance: only bf16 near-ties reject
LORA_RANK = 16
# Each adapter's delta, over its projection's output (ratio of the two
# standard deviations for unit-scale inputs).
LORA_DELTA = 0.03
LORA_NAMES = ("a0", "a1")


def _spec_engine(params, cfg, dparams, dcfg, kv_bits=0, ragged=True):
    """The paged engine of phase 5 (8 slots, block 16, bucket 512, 64 new
    tokens) as ``SpeculativePagedBatcher`` with k_spec SPEC_K."""
    return SpeculativePagedBatcher(
        params, cfg, dparams, dcfg,
        gen=GenerationConfig(max_new_tokens=64, eos_id=-1), slots=8,
        num_blocks=8 * 37 + 24, block_size=16, prompt_bucket=512,
        k_spec=SPEC_K, kv_bits=kv_bits, ragged=ragged,
        token_budget=512 if ragged else None, device=DEVICE)


def _serve_tokens(engine, prompts) -> list:
    """Serve ``prompts`` on an engine that keeps no logprobs; their tokens
    in order."""
    rids = [engine.submit(p) for p in prompts]
    out = engine.run()
    return [out[r] for r in rids]


def _check_spec_outputs(cfg, toks) -> None:
    for tk in toks:
        check(len(tk) == 64, "a request stopped early")
        check(all(0 <= x < cfg.vocab_size for x in tk), "token off vocab")


@contextlib.contextmanager
def _counting_layers(module, *names):
    """Count the calls of ``module.<name>`` for each name while inside and
    the model layers they ran (their config, the second argument):
    yields {"calls": n, "layers": Σ n_layers}."""
    seen = {"calls": 0, "layers": 0}
    real = {n: getattr(module, n) for n in names}

    def counted(name):
        def call(params, cfg, *args, **kwargs):
            seen["calls"] += 1
            seen["layers"] += cfg.n_layers
            return real[name](params, cfg, *args, **kwargs)
        return call

    for name in names:
        setattr(module, name, counted(name))
    try:
        yield seen
    finally:
        for name in names:
            setattr(module, name, real[name])


def _expected_spec_counts(kind: str, dispatches: int, prefill_layers: int,
                          n_layers: int) -> dict:
    """The attention launches a speculative run must make. Every prefill
    (a draft prime, and on the alternating and continuous engines the
    target's admissions) is one flash launch a layer: ``prefill_layers``
    is the layers of all of them. The ragged engine's verify dispatches
    run the ragged kernel once a layer, and nothing else attends with a
    kernel (the draft's steps and the other engines' verifies attend on
    the gathered view or the dense cache, plain)."""
    return {"ragged": dispatches * n_layers if kind == "ragged" else 0,
            "flash": prefill_layers, "decode": 0, "dense": 0}


def _plain_forward_logprobs(params, cfg, tokens) -> torch.Tensor:
    """log_softmax of the plain forward's next-token logits after
    ``tokens``, in f32."""
    with torch.no_grad():
        x = L.forward_hidden(params, cfg, torch.tensor(
            [tokens], dtype=torch.long, device=DEVICE), attn_impl="xla")
        return torch.log_softmax(L._lm_head_logits(x[:, -1], params),
                                 dim=-1)[0]


def _near_tie_gap(params, cfg, context, a: int, b: int) -> float:
    """|logprob(a) − logprob(b)| of the next token after ``context`` under
    one plain forward of ``params``, held to TOL: two choices that close
    are a bf16 near-tie, which any rounding may decide either way."""
    lp = _plain_forward_logprobs(params, cfg, context)
    gap = abs(float(lp[a] - lp[b]))
    check(gap <= TOL, f"tokens {a} and {b} after {len(context)} tokens are "
                      f"no near-tie: logprobs {gap} apart under a plain "
                      "forward")
    return gap


def _compare_greedy(params, cfg, prompts, got, plain, got_lps=None) -> list:
    """Tokens of an engine (``got``, with their logprobs ``got_lps`` where
    it keeps them) held to a plain engine's over the model ``params``
    (``plain`` = (tokens, logprobs)) by phase 5's rule for bf16
    near-ties: tokens equal, or at their first fork the two choices are a
    near-tie (``_near_tie_gap``), and where both keep logprobs, the
    chosen tokens' logprobs before the fork within TOL. A first-token
    fork passes as any other: with bf16 logits, ties are common at random
    weights. Returns per prompt the fork (-1: none), the gap there and
    the largest logprob difference before it."""
    report = []
    for i, (prompt, gt, pt) in enumerate(zip(prompts, got, plain[0])):
        fork = next((j for j, (a, b) in enumerate(zip(gt, pt)) if a != b),
                    -1)
        upto = len(gt) if fork < 0 else fork
        diff = None
        if got_lps is not None:
            diff = max((abs(a - b) for a, b in zip(got_lps[i][:upto],
                                                   plain[1][i][:upto])),
                       default=0.0)
            check(diff <= TOL, f"chosen-token logprobs differ by {diff} "
                               f"before the fork at {fork}")
        gap = (None if fork < 0 else _near_tie_gap(
            params, cfg, prompt + pt[:fork], gt[fork], pt[fork]))
        report.append({"fork": fork, "gap": gap, "max_logprob_diff": diff})
    return report


@contextlib.contextmanager
def _rejections():
    """While inside, record each speculative round's first rejected
    proposal of every slot: (context, the draft's token, the target's),
    the context being the request's prompt and tokens so far and the
    round's accepted proposals. Yields the list."""
    seen = []
    real = spec_mod._apply_spec_round

    def walk(outer, engine, active, preds, props, k_spec=None):
        k = outer.k_spec if k_spec is None else k_spec
        for slot in active:
            n = 0
            while n < k and preds[slot, n] == props[slot, n]:
                n += 1
            if n < k:
                req = engine._by_slot[slot]
                seen.append((req.prompt + req.tokens
                             + [int(t) for t in props[slot, :n]],
                             int(props[slot, n]), int(preds[slot, n])))
        return real(outer, engine, active, preds, props, k_spec=k_spec)

    spec_mod._apply_spec_round = walk
    try:
        yield seen
    finally:
        spec_mod._apply_spec_round = real


def check_rollback_round(sb, prompt) -> int:
    """Serve ``prompt`` alone on a ragged speculative engine up to a round
    that rejects a proposal: after it, each rejected cell of every pool
    leaf (int8 scales too) must be, byte for byte, its snapshot from
    before the dispatch. Returns the cells checked."""
    pb = sb._pb
    snaps = []
    real = paged_mod._gather_cells

    def spy(pool, blks, offs):
        snap = real(pool, blks, offs)
        snaps.append((snap, list(blks), list(offs)))
        return snap

    paged_mod._gather_cells = spy
    try:
        sb.submit(prompt)
        while pb._pending():
            snaps.clear()
            slot = next((i for i, r in enumerate(pb._by_slot)
                         if r is not None), None)
            pos0 = None if slot is None else int(pb.positions[slot])
            pb.drive_once()
            if not snaps or slot is None or pb._by_slot[slot] is None:
                continue
            snap, blks, offs = snaps[0]
            kept = int(pb.positions[slot]) - pos0
            if kept == len(blks):
                continue  # every proposal accepted
            now = real(pb.pool, blks, offs)
            for name, rows in snap.items():
                check(_same_bits(now[name][kept:], rows[kept:]),
                      f"a rejected cell's {name} differs from its snapshot")
            sb.run()
            return len(blks) - kept
    finally:
        paged_mod._gather_cells = real
    raise AssertionError("no round rejected a proposal")


def _spec_ragged_part(params, cfg, dparams, dcfg, runs) -> dict:
    """The ragged speculative engine over a bf16 and an int8 pool on phase
    5's 16 prompts, held to the plain ragged engine; a rollback round; a
    self-draft on 4 prompts."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    out = {}
    for variant, bits in (("bf16", 0), ("int8", 8)):
        engine = _spec_engine(params, cfg, dparams, dcfg, bits)
        start = engine.free_blocks
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _counting_layers(cont_mod, "_admit_slot") as primes, \
                _recording(paged_mod, "_paged_ragged_verify",
                           lambda p, c, tokens, *a, **k: tokens.shape[0]
                           ) as widths:
            _zero_counts()
            toks, wall = _synced_seconds(_serve_tokens, engine, prompts)
            counts = _counts()
        steps = engine._pb.ragged_steps
        want = _expected_spec_counts("ragged", steps, primes["layers"],
                                     cfg.n_layers)
        check(steps == len(widths) > 0, f"{steps} ragged steps, "
                                        f"{len(widths)} verify dispatches")
        check({k: counts[k] for k in want} == want,
              f"{variant}: launches {counts}, want {want}")
        check(primes["calls"] >= len(prompts) and
              primes["layers"] == primes["calls"] * DRAFT_LAYERS,
              f"{primes} draft primes for {len(prompts)} admissions")
        check(engine.free_blocks == start,
              f"{engine.free_blocks} free blocks after the run, {start} "
              "before")
        _check_spec_outputs(cfg, toks)
        plain = _plain_ragged(params, cfg, bits, prompts, runs)
        report = _compare_greedy(params, cfg, prompts, toks, plain[:2])
        rolled = check_rollback_round(
            _spec_engine(params, cfg, dparams, dcfg, bits), prompts[3])
        stats = engine.spec_stats()
        peak = torch.cuda.max_memory_allocated()
        log(f"  speculative ragged {variant}: {steps} verify dispatches "
            f"({counts['ragged']} ragged launches), {primes['calls']} "
            f"draft primes ({counts['flash']} flash launches), "
            f"{json.dumps(stats)}, free blocks back to {start}, "
            f"{rolled} rejected cells byte-equal after a rollback, "
            f"peak {peak / 2**30:.2f} GiB; vs the plain ragged engine "
            f"(fork -1 = tokens equal): {json.dumps(report)}")
        out[variant] = {
            "launches": counts["ragged"], "flash_launches": counts["flash"],
            "acceptance_rate": stats["acceptance_rate"],
            "rounds": stats["rounds"], "wall_s": wall, "plain_wall_s":
            plain[2], "widths": dict(collections.Counter(widths))}
    sub = prompts[::4]
    plain = _plain_ragged(params, cfg, 0, prompts, runs)
    engine = _spec_engine(params, cfg, params, cfg)
    with _rejections() as rejected:
        toks = _serve_tokens(engine, sub)
    report = _compare_greedy(params, cfg, sub, toks,
                             (plain[0][::4], plain[1][::4]))
    rate = engine.acceptance_rate
    check(rate >= SELF_DRAFT_MIN,
          f"a self-draft accepted {rate} of its proposals")
    # Only bf16 near-ties may reject a self-draft's proposal.
    gaps = [_near_tie_gap(params, cfg, *r) for r in rejected]
    log(f"  self-draft (the target as its own draft) on 4 prompts: "
        f"acceptance {rate}, {len(gaps)} rejections, each a near-tie "
        f"(largest gap {max(gaps, default=0.0)}); vs the plain ragged "
        f"engine: {json.dumps(report)}")
    out["self_draft_acceptance"] = rate
    return out


def _plain_ragged(params, cfg, bits, prompts, runs):
    """(tokens, logprobs, wall) of the plain ragged engine on ``prompts``:
    phase 5's run where ``runs`` holds it, else a run now (kept there)."""
    key = ("ragged", bits, len(prompts))
    if key not in runs:
        (toks, lps), wall = _synced_seconds(_serve,
                                            _engine(params, cfg, bits),
                                            prompts)
        runs[key] = (toks, lps, wall)
    return runs[key]


def _spec_other_part(params, cfg, dparams, dcfg, runs) -> dict:
    """The alternating speculative engine and the continuous one (as
    ``serve_batched --speculative`` builds it) on 4 prompts each, held to
    the plain alternating and continuous engines."""
    prompts = _prompts(cfg, 16, 8, 500, SEED)[::4]
    out = {}
    bucket = 16 * ((max(len(p) for p in prompts) + 15) // 16)
    gen = GenerationConfig(max_new_tokens=64, eos_id=-1)
    for kind in ("alternating", "continuous"):
        if kind == "alternating":
            engine = _spec_engine(params, cfg, dparams, dcfg, ragged=False)
            plain = runs.get(kind) or _serve(
                _engine(params, cfg, 0, ragged=False), prompts)
        else:
            engine = SpeculativeContinuousBatcher(
                params, cfg, dparams, dcfg, gen=gen, slots=len(prompts),
                cache_len=bucket + gen.max_new_tokens + SPEC_K + 1,
                prompt_bucket=bucket, k_spec=SPEC_K, device=DEVICE)
            plain = runs.get(kind) or _serve(_cont_engine(params, cfg),
                                             prompts)
        with _counting_layers(paged_mod, "_paged_admit") as admits, \
                _counting_layers(cont_mod, "_admit_slot") as slot_admits:
            _zero_counts()
            toks = _serve_tokens(engine, prompts)
            counts = _counts()
        prefill = admits["layers"] + slot_admits["layers"]
        want = _expected_spec_counts(kind, 0, prefill, cfg.n_layers)
        check({k: counts[k] for k in want} == want,
              f"{kind}: launches {counts}, want {want}")
        _check_spec_outputs(cfg, toks)
        report = _compare_greedy(params, cfg, prompts, toks, plain)
        stats = engine.spec_stats()
        log(f"  speculative {kind}: {counts['flash']} flash launches "
            f"({admits['calls'] + slot_admits['calls']} prefills), no "
            f"decode kernel, {json.dumps(stats)}; vs the plain {kind} "
            f"engine (fork -1 = tokens equal): {json.dumps(report)}")
        out[kind] = {"flash_launches": counts["flash"],
                     "acceptance_rate": stats["acceptance_rate"]}
    return out


def _draw_adapter(cfg, lcfg, seed: int) -> dict:
    """A rank-r adapter on every target of ``lcfg`` from ``seed``: a ~
    N(0, 1/in), as the base weights are drawn, and b ~ N(0, LORA_DELTA² /
    (r · scaling²)), so that each delta x@a@b · scaling is LORA_DELTA of
    its projection's output x@W, in standard deviation."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {}
    for target in lcfg.targets:
        d_in, d_out = lora_mod._target_shapes(cfg)[target]
        a = torch.randn((cfg.n_layers, d_in, lcfg.rank), generator=gen,
                        device=DEVICE) / math.sqrt(d_in)
        b = torch.randn((cfg.n_layers, lcfg.rank, d_out), generator=gen,
                        device=DEVICE) * (LORA_DELTA / math.sqrt(lcfg.rank)
                                          / lcfg.scaling)
        out[target] = {"a": a.to(cfg.dtype), "b": b.to(cfg.dtype)}
    return out


def _lora_engine(params, cfg, stacked, lcfg, **kw):
    return MultiLoraPagedBatcher(
        params, cfg, stacked, lcfg, adapter_names=list(LORA_NAMES),
        gen=GenerationConfig(max_new_tokens=64, eos_id=-1), slots=8,
        num_blocks=8 * 37 + 24, block_size=16, prompt_bucket=512,
        ragged=True, token_budget=512, device=DEVICE, **kw)


def _lora_part(params, cfg, runs):
    """``MultiLoraPagedBatcher`` (hot cache of one slot) serving 2 adapters
    and base over 12 of phase 5's prompts in one batch: launches, the hot
    cache's churn, peak memory; each adapter's rows held to the plain
    ragged engine over ``merge_lora`` (one merged copy at a time), base
    rows to phase 5's run. Returns (numbers, the engine's stacked
    adapters and config)."""
    lcfg = LoraConfig(rank=LORA_RANK, alpha=float(LORA_RANK),
                      targets=lora_mod._ADAPTABLE)
    adapters = [_draw_adapter(cfg, lcfg, SEED + 30 + i)
                for i in range(len(LORA_NAMES))]
    stacked = stack_adapters(adapters, cfg, lcfg)
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    tags = [(*LORA_NAMES, None)[i % 3] for i in range(12)]
    engine = _lora_engine(params, cfg, stacked, lcfg, lora_cache_slots=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rids = [engine.submit(p, adapter=t) for p, t in zip(prompts, tags)]
    res, wall = _synced_seconds(engine.run)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    toks = [res[r] for r in rids]
    lps = [engine.run_logprobs()[r] for r in rids]
    steps = engine.ragged_steps
    check(steps > 0 and counts["ragged"] == steps * cfg.n_layers,
          f"{counts['ragged']} ragged launches for {steps} steps")
    check(counts["flash"] == counts["decode"] == counts["dense"] == 0,
          f"the multi-LoRA engine launched {counts}")
    _check_outputs(cfg, toks, lps)
    cache = engine.lora_cache_stats()
    check(cache["misses"] >= 2 and cache["evictions"] >= 1,
          f"the one-slot hot cache saw no churn: {cache}")
    reports = {}
    plain = _plain_ragged(params, cfg, 0, prompts, runs)
    for name in (*LORA_NAMES, None):
        idx = [i for i, t in enumerate(tags) if t == name]
        sub = [prompts[i] for i in idx]
        if name is None:
            ref = params
            want = ([plain[0][i] for i in idx], [plain[1][i] for i in idx])
        else:
            ref = merge_lora(params, adapters[LORA_NAMES.index(name)], lcfg)
            want = _serve(_engine(ref, cfg, 0), sub)
        reports[name or "base"] = _compare_greedy(
            ref, cfg, sub, [toks[i] for i in idx], want,
            got_lps=[lps[i] for i in idx])
        del ref  # one merged copy at a time
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  multi-LoRA: 2 adapters (rank {LORA_RANK}, 7 targets) + base, "
        f"12 prompts, {steps} steps, {counts['ragged']} ragged launches, "
        f"{wall:.3f} s wall, hot cache {json.dumps(cache)}, peak "
        f"{peak / 2**30:.2f} GiB; each tag vs a plain ragged engine over "
        f"its merged weights (fork -1 = tokens equal): "
        f"{json.dumps(reports)}")
    return {"launches": counts["ragged"], "wall_s": wall,
            "peak_gib": peak / 2**30, "lora_cache": cache}, (stacked, lcfg)


def _spec_lora_http_part(params, cfg, dparams, dcfg, stacked, lcfg) -> None:
    """Over the multi-LoRA engine, 3 concurrent requests, one for each
    adapter and base, blocking, then the same 3 streamed: streamed =
    blocking; an unknown ``model`` is 400 and /v1/models lists all three.
    Two-token prompts keep every dispatch of a round at the 8-row floor
    (6 rows at most), as phase 6's do, so both copies run at one width: a
    16-row dispatch takes other GEMM kernels, whose rounding may decide a
    bf16 near-tie otherwise. Over the ragged speculative engine, /stats
    carries ``speculative`` and ``logprobs`` is 400."""
    srv = InferenceServer(_lora_engine(params, cfg, stacked, lcfg,
                                       lora_cache_slots=1), port=0,
                          model_name="llama-3-8b", drain_s=30.0).start()
    try:
        models = ("llama-3-8b", *LORA_NAMES)
        prompt, other = _prompts(cfg, 2, 2, 2, SEED + 40)
        results = {}
        for stream in (False, True):
            bodies = [{"prompt": prompt, "max_tokens": 16, "stream": stream,
                       "model": m} for m in models]
            with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
                results[stream] = list(pool.map(
                    lambda b: _post(srv.port, b), bodies))
        for m, blocking, streamed in zip(models, results[False],
                                         results[True]):
            check(len(blocking) == 16 and streamed == blocking,
                  f"{m}: streamed {streamed} != blocking {blocking}")
        try:
            _post(srv.port, {"prompt": prompt, "model": "nope"})
            check(False, "an unknown model was served")
        except urllib.error.HTTPError as err:
            check(err.code == 400, f"an unknown model got {err.code}")
        listed = [m["id"] for m in _get_json(srv.port, "/v1/models")["data"]]
        check(listed == list(models), f"/v1/models lists {listed}")
        lora = _get_json(srv.port, "/stats")["lora_cache"]
    finally:
        srv.stop()
    srv = InferenceServer(_spec_engine(params, cfg, dparams, dcfg), port=0,
                          model_name="llama-3-8b", drain_s=30.0).start()
    try:
        tokens = _post(srv.port, {"prompt": other, "max_tokens": 16})
        check(len(tokens) == 16, "speculative blocking response length")
        try:
            _post(srv.port, {"prompt": other, "logprobs": True})
            check(False, "a speculative engine answered logprobs")
        except urllib.error.HTTPError as err:
            check(err.code == 400, f"logprobs got {err.code}")
        spec = _get_json(srv.port, "/stats").get("speculative")
        check(spec is not None and spec["rounds"] > 0,
              f"/stats speculative: {spec}")
    finally:
        srv.stop()
    log(f"  HTTP: 3 models at once, streamed = blocking, unknown model 400, "
        f"/v1/models {listed}, lora_cache {json.dumps(lora)}; speculative "
        f"/stats {json.dumps(spec)}, logprobs 400")


def spec_lora_phase(params, cfg, card: str, runs=None) -> dict:
    """Phase 8: speculation (the ragged engine over bf16 and int8 pools,
    the alternating and continuous engines) and multi-LoRA on the serving
    model, with a draft of its first DRAFT_LAYERS layers, held to phase
    5's plain runs (``runs``, as ``engine_phase`` and the others keep
    them; what is missing runs here). Returns the launch counts and smoke
    numbers; its engines are freed on return."""
    runs = {} if runs is None else runs
    dparams, dcfg = truncated_draft(params, cfg, DRAFT_LAYERS)
    ragged = _spec_ragged_part(params, cfg, dparams, dcfg, runs)
    other = _spec_other_part(params, cfg, dparams, dcfg, runs)
    lora, (stacked, lcfg) = _lora_part(params, cfg, runs)
    _spec_lora_http_part(params, cfg, dparams, dcfg, stacked, lcfg)
    numbers = {
        **{f"{v}_{k}": ragged[v][k] for v in ("bf16", "int8") for k in (
            "acceptance_rate", "rounds", "wall_s", "plain_wall_s",
            "widths")},
        "self_draft_acceptance": ragged["self_draft_acceptance"],
        **{f"{kind}_acceptance_rate": other[kind]["acceptance_rate"]
           for kind in other},
        "lora_wall_s": lora["wall_s"], "lora_peak_gib": lora["peak_gib"]}
    log(f"  smoke numbers (not a benchmark) on {card}: "
        f"{json.dumps(numbers)}")
    return {"ragged": ragged, "other": other, "lora": lora}


# ---------------------------------------------------------------------------
# Checkpoint and observability


CKPT_SHARDS = 4  # as the published Llama-3-8B checkpoint is cut
_ST_DTYPES = {torch.bfloat16: "BF16", torch.float32: "F32",
              torch.float16: "F16"}
_HF_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
              torch.float16: "float16"}
# serve_http's flags and env for phase 6's engines (``_engine`` and
# ``_cont_engine``): the same slots, pool, bucket, token budget and
# new-token cap, so the process serves phase 6's tokens.
SERVE_PAGED = ["--paged", "--slots", "8", "--num-blocks", str(8 * 37 + 24),
               "--block-size", "16", "--prompt-bucket", "512",
               "--max-new-tokens", "64"]
SERVE_CONT = ["--slots", "8", "--cache-len", "1024", "--prompt-bucket",
              "512", "--max-new-tokens", "64"]
SERVE_ENV = {"KUBEFLOW_TPU_RAGGED_TOKEN_BUDGET": "512",
             "KUBEFLOW_TPU_TRACE_RING": "512"}
SERVE_DEVICE: list = []  # the card; a CPU rehearsal passes --device cpu
SERVE_EOS = 2  # serve_http's end of sequence; phase 6's engines have none
SERVE_TIMEOUT = 600.0
RSS_SLACK = 64 << 20  # the process's own allocations during a load
STALL_AFTER = 16  # normal steps before the delayed one: min_samples
STALL_SECONDS = "1"  # the stall capture's length
REQUEST_SPANS = ("first_decode", "prefill", "queue_wait", "server.request")


def hf_config_json(cfg) -> dict:
    """The ``config.json`` of a Llama checkpoint of ``cfg``."""
    out = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.ffn_hidden, "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_seq_len,
        "rms_norm_eps": cfg.norm_eps, "hidden_act": "silu",
        "head_dim": cfg.head_dim, "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": _HF_DTYPES[cfg.dtype],
    }
    if cfg.rope_scaling is not None:
        out["rope_scaling"] = {"rope_type": "llama3",
                               **dataclasses.asdict(cfg.rope_scaling)}
    return out


def _hf_order(key: str) -> tuple:
    """HF's order of a state dict: the embedding, the layers in turn, the
    final norm, the head."""
    parts = key.split(".")
    if "layers" in parts:
        return (1, int(parts[parts.index("layers") + 1]))
    return (0, 0) if "embed_tokens" in key else (2, int("lm_head" in key))


def write_hf_checkpoint(params, cfg, path: str,
                        shards: int = CKPT_SHARDS) -> dict:
    """Write ``params`` as a Hugging Face checkpoint under ``path``:
    ``config.json``, ``shards`` safetensors files of about equal bytes
    (HF's names, order and ``(out, in)`` layout, every tensor in the model
    dtype) and their index ``model.safetensors.index.json``. The format:
    an 8-byte little-endian header length, a JSON header padded to 8
    bytes (each tensor's dtype, shape and data offsets), the raw bytes.
    Tensors come to the host one at a time. Returns {"bytes", "shards",
    "tensors"}."""
    sd = convert_mod.params_to_hf_state_dict(cfg, params)
    keys = sorted(sd, key=_hf_order)
    size = {k: sd[k].numel() * sd[k].element_size() for k in keys}
    total = sum(size.values())
    groups, cur, acc = [], [], 0
    for i, k in enumerate(keys):
        cur.append(k)
        acc += size[k]
        # Cut at each quarter of the bytes, or where every shard left
        # needs one of the tensors left.
        left = shards - 1 - len(groups)
        if left and (acc >= total * (len(groups) + 1) / shards
                     or len(keys) - 1 - i == left):
            groups.append(cur)
            cur = []
    groups.append(cur)
    weight_map = {}
    for i, group in enumerate(groups):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        header, offset = {"__metadata__": {"format": "pt"}}, 0
        for k in group:
            header[k] = {"dtype": _ST_DTYPES[sd[k].dtype],
                         "shape": list(sd[k].shape),
                         "data_offsets": [offset, offset + size[k]]}
            offset += size[k]
            weight_map[k] = name
        raw = json.dumps(header, separators=(",", ":")).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(path, name), "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for k in group:
                host = sd[k].contiguous().cpu()
                f.write(host.view(torch.uint8).numpy())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_json(cfg), f, indent=2)
    return {"bytes": total, "shards": shards, "tensors": len(keys)}


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def _peak_rss():
    """Sample this process's resident bytes every 5 ms while inside;
    yields {"base", "peak"}, filled in on the way out."""
    out = {"base": _rss_bytes(), "peak": 0}
    stop = threading.Event()

    def sample():
        while True:
            out["peak"] = max(out["peak"], _rss_bytes())
            if stop.wait(0.005):
                return

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        yield out
    finally:
        stop.set()
        sampler.join()
        out["peak"] = max(out["peak"], _rss_bytes())


def _cfg_fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out.pop("dtype")
    return out


def _load_part(params, cfg, ckpt: str, nbytes: int) -> dict:
    """``load_hf_checkpoint`` onto the card: every leaf bit-equal to the
    served model's, the host's resident bytes well under the
    checkpoint's."""
    gc.collect()
    t0 = time.monotonic()
    with _peak_rss() as rss:
        lcfg, loaded = convert_mod.load_hf_checkpoint(ckpt, device=DEVICE)
        torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    check(_cfg_fields(lcfg) == _cfg_fields(cfg) and lcfg.dtype == cfg.dtype,
          f"the checkpoint's config {lcfg} is not the served one {cfg}")
    mine, theirs = list(params.named_parameters()), list(
        loaded.named_parameters())
    check([n for n, _ in mine] == [n for n, _ in theirs],
          "the loaded model has other leaves")
    differ = [n for (n, a), (_, b) in zip(mine, theirs)
              if a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a.view(torch.uint8), b.view(torch.uint8))]
    check(not differ, f"{len(differ)} leaves differ from the served "
                      f"model's, first {differ[:3]}")
    growth = rss["peak"] - rss["base"]
    # A load onto the host keeps the model there; the rest is staging.
    staged = growth - (nbytes if torch.device(DEVICE).type == "cpu" else 0)
    check(staged < nbytes / 4 + RSS_SLACK,
          f"the load grew the host's resident memory by {growth / 1e9:.2f} "
          f"GB for a {nbytes / 1e9:.2f} GB checkpoint: it did not stream")
    del loaded, theirs
    gc.collect()
    torch.cuda.empty_cache()
    return {"load_s": load_s, "load_gb_per_s": nbytes / load_s / 1e9,
            "rss_base_gb": rss["base"] / 1e9,
            "rss_peak_gb": rss["peak"] / 1e9, "rss_growth_gb": growth / 1e9,
            "leaves": len(mine)}


def _start_serve_http(source: list, flags: list, env: dict):
    """``serve_http`` over ``source`` (``--checkpoint <dir>``, or a config
    and a seed) as a process, from this checkout: returns (the process,
    its port, its output lines so far, the seconds from start to a healthy
    /healthz). A reader thread keeps its output drained."""
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.examples.serve_http",
         *source, "--port", "0", "--drain-s", "30", *flags,
         *SERVE_DEVICE],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **env})
    lines, serving = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("serving "):
                serving.set()
        serving.set()

    threading.Thread(target=read, daemon=True).start()
    try:
        serving.wait(SERVE_TIMEOUT)
        ready = [x for x in lines if x.startswith("serving ")]
        check(bool(ready), "serve_http did not come up: "
                           + "\n".join(lines[-30:]))
        port = int(ready[0].split("http://")[1].split()[0].rsplit(":", 1)[1])
        deadline = time.monotonic() + SERVE_TIMEOUT
        while True:
            try:
                if _get_json(port, "/healthz") == {"status": "ok"}:
                    break
            except (OSError, ValueError):
                pass
            check(time.monotonic() < deadline and proc.poll() is None,
                  "serve_http never answered /healthz: "
                  + "\n".join(lines[-30:]))
            time.sleep(0.05)
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    return proc, port, lines, time.monotonic() - t0


def _stop_serve_http(proc, lines) -> None:
    """SIGTERM: the server drains and the process exits 0."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    check(proc.returncode == 0, f"serve_http exited {proc.returncode} on "
                                "SIGTERM: " + "\n".join(lines[-30:]))


def _eos_cut(tokens: list, eos: int) -> list:
    return tokens[:tokens.index(eos)] if eos in tokens else tokens


def check_request_traces(traces: list, sent: dict) -> dict:
    """Each sent trace ({trace id: the sender's span id}) holds the root
    ``server.request`` span, a child of the sender's, and ``queue_wait``,
    ``prefill`` and ``first_decode``, children of the root, whose
    durations sum to the root's ``first_token`` TTFT within 10% (or 5
    ms); every ``engine.step`` span is a root of its own, as JAX's.
    Returns {trace id: (span sum s, TTFT s)}."""
    out = {}
    for tid, parent in sent.items():
        mine = [t for t in traces if t["trace_id"] == tid]
        check(sorted(t["name"] for t in mine) == list(REQUEST_SPANS),
              f"trace {tid} holds {sorted(t['name'] for t in mine)}")
        by = {t["name"]: t for t in mine}
        root = by["server.request"]
        check(root["parent_id"] == parent,
              f"server.request of {tid} hangs off {root['parent_id']}")
        for name in ("queue_wait", "prefill", "first_decode"):
            check(by[name]["parent_id"] == root["span_id"],
                  f"{name} of {tid} is not a child of server.request")
        (evt,) = [e for e in root["events"] if e["name"] == "first_token"]
        ttft = evt["attributes"]["ttft_s"]
        span_sum = sum(by[n]["end_time"] - by[n]["start_time"]
                       for n in ("queue_wait", "prefill", "first_decode"))
        check(abs(span_sum - ttft) <= max(0.10 * ttft, 0.005),
              f"{tid}: the spans sum to {span_sum} s, TTFT was {ttft} s")
        out[tid] = (span_sum, ttft)
    steps = [t for t in traces if t["name"] == "engine.step"]
    check(bool(steps) and all(t["parent_id"] == "" for t in steps),
          "engine.step spans missing or not roots")
    return out


def _serve_checkpoint(ckpt: str, flags: list, env: dict, want: dict,
                      streamed: bool) -> dict:
    """``serve_http --checkpoint`` over ``flags``: phase 6's prompts
    (each blocking and, with ``streamed``, streamed too; all at once), each
    under a trace of its own. Tokens are held to ``want`` (phase 6's,
    {prompt: tokens}, cut at serve_http's end of sequence), the spans to
    ``check_request_traces``; then ``/stats`` and a SIGTERM drain."""
    proc, port, lines, up_s = _start_serve_http(["--checkpoint", ckpt],
                                                flags, env)
    # The checkpoint holds no tokenizer: serve_http says so (or, where a
    # transformers version makes one up, serves with it); the requests
    # below send token ids either way.
    log("  serve_http printed: " + " | ".join(x[:160] for x in lines))
    try:
        bodies = [{"prompt": list(p), "max_tokens": 16, "stream": stream}
                  for p in HTTP_PROMPTS
                  for stream in ((False, True) if streamed else (False,))]
        heads = [(secrets.token_hex(16), secrets.token_hex(8))
                 for _ in bodies]
        with concurrent.futures.ThreadPoolExecutor(len(bodies)) as pool:
            results = list(pool.map(
                lambda bh: _post(port, bh[0], headers={
                    "traceparent": f"00-{bh[1][0]}-{bh[1][1]}-01"}),
                zip(bodies, heads)))
        for body, got in zip(bodies, results):
            exp = _eos_cut(want[tuple(body["prompt"])], SERVE_EOS)
            check(got == exp, f"serve_http --checkpoint gave {got} for "
                              f"{body}, phase 6 {exp}")
        sent = dict(heads)
        deadline = time.monotonic() + 60
        while True:  # a root span ends just after its response
            traces = _get_json(port, "/debug/traces")["traces"]
            done = {t["trace_id"] for t in traces
                    if t["name"] == "server.request"}
            if set(sent) <= done or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        spans = check_request_traces(traces, sent)
        stats = _get_json(port, "/stats")
    finally:
        _stop_serve_http(proc, lines)
    check(stats["served"] == len(bodies), f"/stats served {stats['served']}")
    flight = stats["flight"]
    check("engine_step_stalls" in stats and flight["steps"] > 0,
          "/stats has no flight recorder")
    if "ragged" in stats:
        check(flight["steps"] == stats["ragged"]["steps"],
              f"flight steps {flight['steps']} != engine steps "
              f"{stats['ragged']['steps']}")
    if "KUBEFLOW_TPU_STALL_PROFILE_DIR" in env:
        check("stall_profiles" in flight, "stall capture is not armed")
    sums = [s for s, _ in spans.values()]
    p95 = stats["ttft_s"]["p95"]
    check(abs(max(sums) - p95) <= max(0.10 * p95, 0.005),
          f"the longest span sum {max(sums)} s against /stats' TTFT p95 "
          f"{p95} s")
    return {"healthz_s": up_s, "ttft_span_sum_s": sorted(sums),
            "ttft_span_gap_max": max(abs(a - b) / b
                                     for a, b in spans.values()),
            "ttft_s": stats["ttft_s"], "flight_steps": flight["steps"],
            "engine_step_stalls": stats["engine_step_stalls"]}


class _Recorded:
    """One metric as the server writes it: ``.inc()`` adds, ``.set()``
    replaces."""

    def __init__(self):
        self.value = 0.0

    def inc(self, by: float = 1.0) -> None:
        self.value += by

    def set(self, value: float) -> None:
        self.value = value


class RecordingMetrics:
    """A metrics bundle whose attributes are ``_Recorded`` metrics, made
    on first use (the server only calls ``.inc()`` and ``.set()``)."""

    def __getattr__(self, name: str) -> _Recorded:
        if name.startswith("__"):
            raise AttributeError(name)
        metric = self.__dict__[name] = _Recorded()
        return metric


def _stall_part(params, cfg, profiles: str) -> dict:
    """The ragged engine behind an in-process server with stall capture
    armed (``KUBEFLOW_TPU_STALL_PROFILE_DIR``) and a recording metrics
    bundle: after STALL_AFTER normal steps one step sleeps 20 × the median
    step (at least 0.5 s), the recorder counts a stall, and the capture's
    trace holds the ragged kernel. Launches as phase 5's rule; the
    bundle reads what /stats reads."""
    engine = _engine(params, cfg, 0)
    metrics = RecordingMetrics()
    env = {"KUBEFLOW_TPU_STALL_PROFILE_DIR": profiles,
           "KUBEFLOW_TPU_STALL_PROFILE_SECONDS": STALL_SECONDS}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        srv = InferenceServer(engine, port=0, model_name="llama-3-8b",
                              metrics=metrics, drain_s=30.0)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(srv._stall_profiler is not None, "stall capture is not armed")
    real_step, calls, delay = engine._step, [0], {}

    def step():
        # Inside drive_once's timed quantum.
        calls[0] += 1
        if calls[0] == STALL_AFTER + 1:
            median = srv.flight.snapshot()["step_s"]["p50"]
            delay["s"] = max(0.5, 20 * median)
            time.sleep(delay["s"])
        real_step()

    engine._step = step
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    srv.start()
    try:
        _zero_counts()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            toks = list(pool.map(lambda p: _post(
                srv.port, {"prompt": p, "max_tokens": 64}), prompts))
        counts = _counts()
        deadline = time.monotonic() + 120
        while srv.stats()["flight"]["stall_profiles"]["captures"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        srv.stop()
    stats = srv.stats()
    flight = stats["flight"]
    check(len(toks) == 16 and all(len(t) == 64 for t in toks),
          "a request stopped early")
    steps = engine.ragged_steps
    check(counts["ragged"] == steps * cfg.n_layers,
          f"{counts['ragged']} ragged launches for {steps} steps × "
          f"{cfg.n_layers} layers")
    check(counts["flash"] == counts["decode"] == counts["dense"] == 0,
          f"the ragged engine launched {counts}")
    check(calls[0] > STALL_AFTER and flight["steps"] == steps,
          f"{calls[0]} steps run, the recorder saw {flight['steps']}, the "
          f"engine {steps}")
    check(stats["engine_step_stalls"] >= 1 and flight["last_stall"]
          is not None, "the delayed step was not counted as a stall")
    prof = flight["stall_profiles"]
    check(prof["captures"] == 1 and prof["last_error"] is None,
          f"stall capture: {prof}")
    path = os.path.join(prof["last"]["path"], profiling_mod.TRACE_FILE)
    with open(path) as f:
        kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    ragged_in_trace = sum("ragged_kernel" in k for k in kernels)
    check(ragged_in_trace > 0, f"the stall trace holds {len(kernels)} "
                               "kernels, none of them the ragged kernel")
    mirrored = {
        "engine_step_stall_total": (metrics.engine_step_stall_total.value,
                                    stats["engine_step_stalls"]),
        "serving_ragged_batch_fill": (
            round(metrics.serving_ragged_batch_fill.value, 4),
            stats["ragged"]["batch_fill"]),
        "serving_requests_shed_total": (
            metrics.serving_requests_shed_total.value,
            stats["requests_shed"]),
        "serving_drain_seconds": (metrics.serving_drain_seconds.value,
                                  stats["drain_duration_s"]),
    }
    check(all(a == b for a, b in mirrored.values()),
          f"the metrics bundle disagrees with /stats: {mirrored}")
    return {"launches": counts["ragged"], "steps": steps,
            "delay_s": delay["s"], "stalls": stats["engine_step_stalls"],
            "last_stall": flight["last_stall"],
            "trace_kernels": len(kernels),
            "trace_ragged_kernels": ragged_in_trace,
            "metrics": {k: a for k, (a, _) in mirrored.items()}}


def checkpoint_phase(params, cfg, card: str, http_tokens: dict) -> dict:
    """Phase 9: the served weights written as a 4-shard HF checkpoint and
    loaded back bit-equal; ``serve_http --checkpoint`` over it (ragged,
    then continuous) held to phase 6's tokens (``http_tokens``: {engine:
    {prompt: tokens}}) with its spans and /stats; the stall capture in
    process. Everything it writes goes under a temporary directory,
    removed at the end."""
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        ckpt = os.path.join(tmp, "llama")
        os.makedirs(ckpt)
        nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
        free = shutil.disk_usage(tmp).free
        check(free > 1.1 * nbytes, f"{tmp} has {free / 1e9:.2f} GB free, "
                                   f"the checkpoint needs {nbytes / 1e9:.2f}")
        t0 = time.monotonic()
        written = write_hf_checkpoint(params, cfg, ckpt)
        write_s = time.monotonic() - t0
        check(written["bytes"] == nbytes, "the shards hold other bytes")
        log(f"  wrote {written['tensors']} tensors, {nbytes / 1e9:.2f} GB in "
            f"{written['shards']} shards in {write_s:.2f} s")
        loaded = _load_part(params, cfg, ckpt, nbytes)
        log(f"  loaded bit-equal: {json.dumps(loaded)}")
        profiles = os.path.join(tmp, "profiles")
        ragged = _serve_checkpoint(
            ckpt, SERVE_PAGED, {**SERVE_ENV, "KUBEFLOW_TPU_SERVING_RAGGED": "1",
                                "KUBEFLOW_TPU_STALL_PROFILE_DIR": profiles},
            http_tokens["ragged"], streamed=True)
        log(f"  serve_http --checkpoint --paged (ragged): {json.dumps(ragged)}")
        cont = _serve_checkpoint(ckpt, SERVE_CONT, SERVE_ENV,
                                 http_tokens["continuous"], streamed=False)
        log(f"  serve_http --checkpoint (continuous): {json.dumps(cont)}")
        stall = _stall_part(params, cfg, os.path.join(tmp, "stall"))
        log(f"  stall capture in process: {json.dumps(stall)}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers = {"write_s": write_s, "write_gb_per_s": nbytes / write_s / 1e9,
               "load_s": loaded["load_s"],
               "load_gb_per_s": loaded["load_gb_per_s"],
               "load_rss_growth_gb": loaded["rss_growth_gb"],
               "healthz_s": {"ragged": ragged["healthz_s"],
                             "continuous": cont["healthz_s"]},
               "ttft_span_sum_s": {"ragged": ragged["ttft_span_sum_s"],
                                   "continuous": cont["ttft_span_sum_s"]},
               "ttft_span_gap_max": max(ragged["ttft_span_gap_max"],
                                        cont["ttft_span_gap_max"]),
               "stats_ttft_s": {"ragged": ragged["ttft_s"],
                                "continuous": cont["ttft_s"]}}
    log(f"  smoke numbers (not a benchmark) on {card}: {json.dumps(numbers)}")
    return {"numbers": numbers, "stall": stall, "ragged": ragged,
            "continuous": cont}


# ---------------------------------------------------------------------------
# Train


TRAIN_SEQ = 2048
TRAIN_STEPS = 3
LOSS_CHUNK = 512
# Step 1's loss and grads with the kernels against the same with plain
# attention (impl="xla"): bf16 weights and activations, the two paths
# rounding attention's output and grads at other places.
TRAIN_TOL = {"loss_rel": 2e-2, "grad_norm_rel": 2e-2, "wq_cos": 0.99}
# The all-kernels wq cosine of each layer must reach TRAIN_TOL's, or where
# plain attention with its output nudged by one bf16 rounding
# (``_nudged_fwd``) falls below that itself, the nudge's cosine less this
# margin. A correct bf16 forward rounds less than the nudge moves: on
# gemma-2b at random init the kernels and SDPA both read 0.951 / 0.923 and
# the nudge 0.930 / 0.895, two draws of the nudge 0.003 apart (PERF.md §6).
# On llama-3-8b the nudge reads 0.9997, so its gate stays at 0.99.
WQ_NUDGE_MARGIN = 0.005


def _wq_cos_floor(cos_nudged) -> list[float]:
    """Each layer's least all-kernels wq cosine, from the nudge's."""
    return [min(TRAIN_TOL["wq_cos"], c - WQ_NUDGE_MARGIN) for c in cos_nudged]


def _train_corpus(tmp: str, vocab: int) -> str:
    """A uint32 corpus written with numpy from the seed: 1 Mi tokens over
    the first 1000 ids, so a few steps can lower the loss."""
    rng = np.random.default_rng(SEED)
    return str(write_token_file(os.path.join(tmp, "corpus.bin"),
                                rng.integers(0, min(vocab, 1000), 1 << 20)))


@contextlib.contextmanager
def _attention(fwd=None, bwd=None):
    """Route ``FlashAttention``'s forward and/or backward through other
    functions of the wrappers' arguments for the duration (impl "auto"
    only)."""
    saved = attn_mod.flash_attention_fwd, attn_mod.flash_attention_bwd
    attn_mod.flash_attention_fwd = fwd or saved[0]
    attn_mod.flash_attention_bwd = bwd or saved[1]
    try:
        yield
    finally:
        attn_mod.flash_attention_fwd, attn_mod.flash_attention_bwd = saved


def _nudged_fwd(gen):
    """The plain forward with each output value moved by a random
    2^-9 · N(0, 1) of itself (the size of one bf16 rounding) before it is
    rounded: what any correct bf16 forward may differ from it by."""
    def fwd(q, k, v, causal=True, q_offset=0, window=0, kv_mask=None):
        out, lse = flash_attention_reference(
            q.float(), k.float(), v.float(), causal, q_offset, window, kv_mask)
        noise = torch.randn(out.shape, generator=gen, device=out.device)
        return (out * (1 + 2.0 ** -9 * noise)).to(q.dtype), lse
    return fwd


def _loss_and_grads(params, cfg, tokens, impl: str):
    """Step 1's chunked loss and grads through ``impl`` attention: (loss,
    global grad norm, layer 0's and the last layer's wq grads in f32)."""
    params.zero_grad(set_to_none=True)
    loss = train_mod.chunked_causal_lm_loss(
        params, cfg, tokens, attn_impl=impl, chunk=LOSS_CHUNK, remat="full")
    loss.backward()
    norm = train_mod.global_norm([p.grad for p in params.parameters()])
    wq = [params.layers[i].wq.grad.float().clone() for i in (0, -1)]
    out = (float(loss.detach()), float(norm), wq)
    params.zero_grad(set_to_none=True)
    return out


def _wq_cos(a, b) -> list[float]:
    return [float(F.cosine_similarity(x.flatten(), y.flatten(), dim=0))
            for x, y in zip(a[2], b[2])]


def train_phase(cfg):
    """Phase 7: ``cfg`` at full width, random bf16 weights from the seed,
    B 1, S 2048, remat "full", loss chunk 512, AdamW, tokens from the
    port's TokenLoader. Step 1's loss and grads with the kernels against
    plain attention: the wq grads of the backward kernels under the plain
    forward at TRAIN_TOL's cosine, those of all the kernels at
    ``_wq_cos_floor`` of the nudge's, loss and grad norm within TRAIN_TOL.
    Then TRAIN_STEPS optimizer steps, each launching the
    flash forward 2 × n_layers times (forward and the remat recompute) and
    each backward kernel n_layers times; the loss on step 1's batch after
    them must be below step 1's. Returns {kernel: launches in those
    steps}."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        with TokenLoader(_train_corpus(tmp, cfg.vocab_size), 1, TRAIN_SEQ,
                         seed=SEED + 1) as loader:
            batches = [torch.from_numpy(loader.next()).to(DEVICE)
                       for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    log(f"  init {cfg.param_count() / 1e9:.2f}B params and "
        f"{TRAIN_STEPS} batches of (1, {TRAIN_SEQ}) in "
        f"{time.monotonic() - t0:.2f} s")

    params.requires_grad_(True)
    plain = _loss_and_grads(params, cfg, batches[0], "xla")
    with _attention(fwd=flash_attention_reference):
        bwd_only = _loss_and_grads(params, cfg, batches[0], "auto")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    with _attention(fwd=_nudged_fwd(gen), bwd=flash_attention_bwd_reference):
        nudged = _loss_and_grads(params, cfg, batches[0], "auto")
    _zero_counts()
    kern = _loss_and_grads(params, cfg, batches[0], "auto")
    torch.cuda.synchronize()
    counts = _counts()
    n = cfg.n_layers
    check((counts["flash"], counts["bwd_dq"], counts["bwd_dkv"])
          == (2 * n, n, n), f"step 1 with the kernels launched {counts}")
    loss_rel = abs(kern[0] - plain[0]) / abs(plain[0])
    norm_rel = abs(kern[1] - plain[1]) / plain[1]
    cos, cos_bwd, cos_nudged = (_wq_cos(x, plain)
                                for x in (kern, bwd_only, nudged))
    cos_floor = _wq_cos_floor(cos_nudged)
    log(f"  step 1, kernels vs plain attention: loss {kern[0]:.6f} vs "
        f"{plain[0]:.6f} (rel {loss_rel:.3e}), grad norm {kern[1]:.6f} vs "
        f"{plain[1]:.6f} (rel {norm_rel:.3e}), wq grad cosine layer 0 "
        f"{cos[0]:.6f}, layer {n - 1} {cos[1]:.6f}; the backward kernels "
        f"under the plain forward {cos_bwd[0]:.6f}, {cos_bwd[1]:.6f}; plain "
        f"attention nudged by one bf16 rounding {cos_nudged[0]:.6f}, "
        f"{cos_nudged[1]:.6f}, so the kernels' cosine is held at "
        f"{cos_floor[0]:.6f}, {cos_floor[1]:.6f}")
    check(all(math.isfinite(x) for x in (kern[0], kern[1], plain[0], plain[1])),
          "non-finite step-1 loss or grad norm")
    check(min(cos_bwd) >= TRAIN_TOL["wq_cos"],
          f"wq grad cosine of the backward kernels {cos_bwd}")
    check(all(c >= f for c, f in zip(cos, cos_floor)),
          f"wq grad cosine of all the kernels {cos} below {cos_floor}")
    check(loss_rel <= TRAIN_TOL["loss_rel"], f"step-1 loss rel {loss_rel}")
    check(norm_rel <= TRAIN_TOL["grad_norm_rel"], f"grad norm rel {norm_rel}")
    STEP_ONE[cfg] = {"loss": kern[0], "grad_norm": kern[1]}
    del plain, kern, bwd_only, nudged

    init_state, step_fn = train_mod.make_train_step(
        cfg, remat="full", loss_chunk=LOSS_CHUNK)
    state = init_state(params)
    losses, walls = [], []
    launched = dict.fromkeys(("flash", "bwd_dq", "bwd_dkv"), 0)
    _zero_counts()
    for i, tokens in enumerate(batches):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, loss = step_fn(state, tokens)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        losses.append(float(loss))
        after = _counts()
        step = {k: after[k] - before[k] for k in launched}
        check(step == {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n},
              f"train step {i + 1} launched {step}")
        check(after["ragged"] == after["decode"] == after["dense"] == 0,
              f"the train step launched a serving kernel: {after}")
    launched = {k: _counts()[k] for k in launched}
    with torch.no_grad():
        after_loss = float(train_mod.chunked_causal_lm_loss(
            state["params"], cfg, batches[0], chunk=LOSS_CHUNK))
    peak = torch.cuda.max_memory_allocated()
    log(f"  train steps: losses {losses}, then {after_loss:.6f} on step 1's "
        f"batch; launches {launched} in {TRAIN_STEPS} steps")
    check(all(math.isfinite(x) for x in losses + [after_loss]),
          "a non-finite training loss")
    check(after_loss < losses[0],
          f"the loss did not fall: {after_loss} after vs {losses[0]}")
    step_s = min(walls)
    log(f"  train smoke run, not a benchmark: peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated), step walls "
        f"{[round(w, 4) for w in walls]} s, {TRAIN_SEQ / step_s:.1f} tokens/s "
        f"at the fastest step")
    del state, params, batches
    gc.collect()
    torch.cuda.empty_cache()
    return launched


# The models phase 7 trains, one after the other: llama-3-8b (head dim 128)
# and gemma-2b (head dim 256, 8 q heads over 1 kv head, tied embeddings).
TRAIN_MODELS = ("llama-3-8b", "gemma-2b")


def train_phases(cfgs: dict) -> dict:
    """Phase 7: ``train_phase`` for each {name: config}, each model freed
    before the next is made, then one checkpoint round trip. Returns
    {name: launches}."""
    launched = {}
    for name, cfg in cfgs.items():
        log(f"  {name}: full width and depth, random weights")
        launched[name] = train_phase(cfg)
    checkpoint_round_trip()
    return launched


def checkpoint_round_trip() -> None:
    """A ``tiny`` bf16 trainer state on the card, every leaf filled with
    random values, saved and restored into another fresh state: every
    tensor must come back byte-equal."""
    _, fresh_state, _ = train_mod.make_tiny_trainer(steps=1, device=DEVICE)
    state = fresh_state(0)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    with torch.no_grad():
        for _, leaf in flatten_state(state):
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=g,
                                       device=DEVICE).to(leaf.device))
    state["step"] += 5
    with tempfile.TemporaryDirectory() as tmp:
        check(CheckpointManager(tmp).save(5, state), "checkpoint save failed")
        other = fresh_state(1)
        _, step = CheckpointManager(tmp).restore_latest(other)
    check(step == 5, f"restore_latest returned step {step}")
    saved, restored = flatten_state(state), flatten_state(other)
    same = all(
        pa == pb and a.dtype == b.dtype and a.device == b.device
        and torch.equal(a.reshape(-1).view(torch.uint8),
                        b.reshape(-1).view(torch.uint8))
        for (pa, a), (pb, b) in zip(saved, restored))
    check(same and len(saved) == len(restored),
          "a restored leaf differs from the saved one")
    log(f"  checkpoint round trip of a tiny bf16 trainer state: "
        f"{len(saved)} leaves byte-equal")


# ---------------------------------------------------------------------------
# Finetune

FT_MODEL = "llama-3-8b"
# Phase 11's fp8 products: 2048 rows (B 1 × S 2048) through llama-3-8b's
# wq (4096²), w_gate (4096×14336) and w_down (14336×4096).
FP8_ROWS = 2048
FP8_SHAPES = (("wq", 4096, 4096), ("w_gate", 4096, 14336),
              ("w_down", 14336, 4096))
FP8_FLOPS_PER_S = 1979e12  # H100 SXM dense fp8
FP8_ROW_KEYS = ("ms", "scaled_mm_ms", "bf16_ms", "passes_ms", "bound_ms",
                "bound_by")
# JAX's own bound on an fp8 loss against bf16's (tests/test_fp8.py).
FP8_BF16_LOSS_TOL = 0.15
FT_LORA = dict(rank=8, targets=("wq", "wv"))
FT_LORA_LR = 1e-3
# examples/finetune_lora.py's run on the card: a 2-layer Llama at head dim
# 64 (the tiny configs' 32 is not a head dim the flash kernels take) as an
# HF checkpoint, 2 steps of (4, 64) tokens.
FT_EXAMPLE_CFG = dataclasses.replace(
    L.LLAMA_CONFIGS["tiny"], dim=256, n_heads=4, n_kv_heads=2,
    ffn_hidden=512)
FT_EXAMPLE_STEPS = 2


def _fp8_operands(k: int, n: int, seed: int) -> dict:
    """A product's bf16 x (rows, k), w (k, n) and g (rows, n) from the
    seed, their delayed scales taken from histories that hold each
    tensor's amax, and the card's casts."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((FP8_ROWS, k), generator=g, device=DEVICE).to(
        torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=DEVICE)
         / math.sqrt(k)).to(torch.bfloat16)
    dy = (torch.randn((FP8_ROWS, n), generator=g, device=DEVICE)
          * 1e-3).to(torch.bfloat16)
    zeros = torch.zeros(16, dtype=torch.float32, device=DEVICE)
    s = {name: fp8_mod._scale_from(fp8_mod._record(zeros, t), fmax)
         for name, t, fmax in (("x", x, fp8_mod.E4M3_MAX),
                               ("w", w, fp8_mod.E4M3_MAX),
                               ("g", dy, fp8_mod.E5M2_MAX))}
    q = {"x": fp8_mod._cast(x, s["x"], torch.float8_e4m3fn,
                            fp8_mod.E4M3_MAX),
         "w": fp8_mod._cast(w, s["w"], torch.float8_e4m3fn,
                            fp8_mod.E4M3_MAX),
         "g": fp8_mod._cast(dy, s["g"], torch.float8_e5m2,
                            fp8_mod.E5M2_MAX)}
    return {"x": x, "w": w, "g": dy, "s": s, "q": q}


def _fp8_products(ops) -> dict:
    """{product: (a, b, scale of a, scale of b)} of one weight: the
    forward qx @ qw, dx = qg @ qwᵀ and dw = qxᵀ @ qg, as ``Fp8Matmul``
    hands them to ``fp8_product``."""
    q, s = ops["q"], ops["s"]
    return {"forward": (q["x"], q["w"], s["x"], s["w"]),
            "dx": (q["g"], q["w"].t(), s["g"], s["w"]),
            "dw": (q["x"].t(), q["g"], s["x"], s["g"])}


def _fp8_passes(ops, product: str):
    """A product's own passes beside the product, as ``Fp8Matmul`` runs
    them: the forward's two scales, two casts and two amax records and its
    epilogue (divide, cast to bf16); dx's scale, cast and record of g and
    its epilogue; dw's epilogue (it reuses qx and qg)."""
    x, w, dy, s = ops["x"], ops["w"], ops["g"], ops["s"]
    hist = torch.zeros(16, dtype=torch.float32, device=DEVICE)
    k, n = w.shape
    shape = {"forward": (FP8_ROWS, n), "dx": (FP8_ROWS, k), "dw": (k, n)}
    out = torch.empty(shape[product], dtype=torch.float32, device=DEVICE)

    def forward():
        for t in (x, w):
            fp8_mod._cast(t, fp8_mod._scale_from(hist, fp8_mod.E4M3_MAX),
                          torch.float8_e4m3fn, fp8_mod.E4M3_MAX)
            fp8_mod._record(hist, t)
        (out / (s["x"] * s["w"])).to(torch.bfloat16)

    def dx():
        fp8_mod._cast(dy, fp8_mod._scale_from(hist, fp8_mod.E5M2_MAX),
                      torch.float8_e5m2, fp8_mod.E5M2_MAX)
        fp8_mod._record(hist, dy)
        (out / (s["g"] * s["w"])).to(torch.bfloat16)

    def dw():
        (out / (s["x"] * s["g"])).to(torch.bfloat16)

    return {"forward": forward, "dx": dx, "dw": dw}[product]


def fp8_products_phase(card: str) -> dict:
    """Phase 11 (a): for each FP8_SHAPES weight, the card's e4m3 casts of x
    and w and e5m2 cast of g must equal the CPU's byte for byte; each
    product (forward e4m3 × e4m3, dx e5m2 × e4m3, dw e4m3 × e5m2) through
    ``fp8_product`` (``_scaled_mm``) with JAX's epilogue is held to GATES
    against the plain version; each is timed beside ``_scaled_mm`` alone
    on operands already in its layouts, bf16 ``torch.matmul`` at the same
    shape, its own amax-and-cast passes and its bound. Returns {shape:
    {product: row}}."""
    saved = fp8_mod.fp8_product.launches
    rows: dict = {}
    worst: dict = {}
    one = torch.ones((), dtype=torch.float32, device=DEVICE)
    for i, (name, k, n) in enumerate(FP8_SHAPES):
        ops = _fp8_operands(k, n, SEED + 1100 + i)
        for t, fmt, fmax in (("x", torch.float8_e4m3fn, fp8_mod.E4M3_MAX),
                             ("w", torch.float8_e4m3fn, fp8_mod.E4M3_MAX),
                             ("g", torch.float8_e5m2, fp8_mod.E5M2_MAX)):
            host = fp8_mod._cast(ops[t].cpu(), ops["s"][t].cpu(), fmt, fmax)
            check(_same_bits(ops["q"][t].cpu(), host),
                  f"fp8 {name}: the card's {fmt} cast of {t} differs from "
                  "the CPU's")
        rows[name] = {}
        for product, (a, b, sa, sb) in _fp8_products(ops).items():
            scale = sa * sb
            got = (fp8_mod.fp8_product(a, b) / scale).to(torch.bfloat16)
            ref = fp8_mod.fp8_product_reference(a, b) / scale
            ref_abs = (a.float().abs() @ b.float().abs()) / scale
            errs = _diff_errors(got.float(), ref, ref_abs)
            _gate(f"fp8 {name} {product}", errs, worst)
            # _scaled_mm alone, its operands already laid out as it takes
            # them (row-major a, column-major b).
            a_row, b_col = a.contiguous(), b.t().contiguous().t()
            ms = _time_ms(lambda: fp8_mod.fp8_product(a, b))
            mm_ms = _time_ms(lambda: torch._scaled_mm(
                a_row, b_col, scale_a=one, scale_b=one,
                out_dtype=torch.float32, use_fast_accum=False))
            a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
            bf16_ms = _time_ms(lambda: torch.matmul(a16, b16))
            passes_ms = _time_ms(_fp8_passes(ops, product))
            m_, k_ = a.shape
            n_ = b.shape[1]
            nbytes = m_ * k_ + k_ * n_ + 4 * m_ * n_
            flops = 2 * m_ * k_ * n_
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_flops = flops / FP8_FLOPS_PER_S * 1e3
            row = dict(ms=ms, scaled_mm_ms=mm_ms, bf16_ms=bf16_ms,
                       passes_ms=passes_ms, bound_ms=max(t_bytes, t_flops),
                       bound_by="bytes" if t_bytes >= t_flops
                       else "operations", shape=[m_, k_, n_],
                       dtypes=[str(a.dtype), str(b.dtype)], **errs)
            rows[name][product] = row
            log(f"  fp8 {name} {product} ({m_}x{k_} @ {k_}x{n_}, "
                f"{row['dtypes'][0]} x {row['dtypes'][1]}): fp8_product "
                f"{ms:.4f} ms, _scaled_mm alone {mm_ms:.4f}, bf16 "
                f"torch.matmul {bf16_ms:.4f}, amax-and-cast passes "
                f"{passes_ms:.4f}, bound {row['bound_ms']:.4f} "
                f"({row['bound_by']}); errors {errs}")
            del a16, b16, a_row, b_col
        del ops
    fp8_mod.fp8_product.launches = saved
    torch.cuda.empty_cache()
    log(f"  fp8 products on {card}: casts byte-equal to the CPU's, worst "
        f"errors {worst}")
    return rows


def _fp8_weights(params) -> list:
    return [m for m in params.modules() if isinstance(m, fp8_mod.Fp8Weight)]


def _check_history_fill(params, k: int) -> dict:
    """After step k every history holds k observations and zeros after
    them; every x and w observation is non-zero (an amax of activations
    or of a weight). A g observation is 0 where the whole gradient was:
    JAX's arithmetic casts g to e5m2 at its delayed scale, 1.0 from an
    empty history, which flushes a gradient under e5m2's least subnormal
    (2^-16) to 0, and every layer below it then sees a zero gradient.
    Returns {history: its zero observations}."""
    zeros = {}
    for name in ("x_hist", "w_hist", "g_hist"):
        hists = torch.stack([getattr(w, name).detach()
                             for w in _fp8_weights(params)])
        check(not bool((hists[:, k:] != 0).any()),
              f"after step {k} a {name} holds more than {k} observations")
        zeros[name] = int((hists[:, :k] == 0).sum())
    check(zeros["x_hist"] == zeros["w_hist"] == 0,
          f"after step {k} the histories hold zero observations: {zeros}")
    return zeros


def _step_counts(before: dict, after: dict) -> dict:
    return {key: after[key] - before[key] for key in after}


def _lora_b_grads(params, cfg, lora, lcfg, tokens, impl: str) -> list:
    """Step 1's dense loss through ``impl`` attention and the b grads of
    each target at layers 0 and last, in f32."""
    for t in train_mod.tensor_leaves(lora):
        t.grad = None
    merged = lora_mod.merge_lora_differentiable(params, lora, lcfg)
    loss = train_mod.causal_lm_loss(merged, cfg, tokens, attn_impl=impl)
    loss.backward()
    del merged
    out = [lora[t]["b"].grad[i].float().clone()
           for t in lcfg.targets for i in (0, -1)]
    for t in train_mod.tensor_leaves(lora):
        t.grad = None
    return out


def lora_finetune_part(params, cfg, batches) -> dict:
    """Phase 11 (c): rank-8 bf16 adapters on wq and wv over the frozen
    model, lr 1e-3. At b = 0 the adapted loss equals the base loss bit for
    bit; step 1's b grads with the kernels hold phase 10's wq cosine
    against plain attention; 3 steps each launch 2n flash, n dQ and n
    dK/dV kernels and no fp8 product; every base weight stays byte-equal,
    the adapters move and the loss on step 1's batch falls. Returns
    {kernel: launches in those steps}."""
    n = cfg.n_layers
    lcfg = LoraConfig(**FT_LORA)
    lora = lora_mod.init_lora_params(
        cfg, lcfg, torch.Generator(device=DEVICE).manual_seed(SEED + 3),
        dtype=torch.bfloat16, device=DEVICE)
    # A copy of every base weight on the card, for the byte check after.
    frozen = {name: p.detach().clone() for name, p in params.named_parameters()}
    copy_gib = sum(t.numel() * t.element_size()
                   for t in frozen.values()) / 2**30
    with torch.no_grad():
        base = train_mod.causal_lm_loss(params, cfg, batches[0])
        adapted = train_mod.causal_lm_loss(
            lora_mod.merge_lora_differentiable(params, lora, lcfg), cfg,
            batches[0])
    check(_same_bits(base, adapted), f"at b = 0 the adapted loss "
          f"{float(adapted)!r} differs from the base loss {float(base)!r}")
    init_state, step_fn = lora_mod.make_lora_train_step(
        cfg, lcfg, learning_rate=FT_LORA_LR)
    state = init_state(lora)
    plain = _lora_b_grads(params, cfg, lora, lcfg, batches[0], "xla")
    _zero_counts()
    kern = _lora_b_grads(params, cfg, lora, lcfg, batches[0], "auto")
    counts = _counts()
    check((counts["flash"], counts["bwd_dq"], counts["bwd_dkv"])
          == (2 * n, n, n), f"LoRA step 1's grads launched {counts}")
    cos = [float(F.cosine_similarity(a.flatten(), b.flatten(), dim=0))
           for a, b in zip(kern, plain)]
    log(f"  LoRA: loss at b = 0 {float(base):.6f}, bit-equal to the base "
        f"model's; step 1's b grad cosine, kernels vs plain attention "
        f"(wq, wv at layers 0 and {n - 1}): {[round(c, 6) for c in cos]}")
    check(min(cos) >= TRAIN_TOL["wq_cos"], f"LoRA b grad cosine {cos}")
    del plain, kern
    losses, walls = [], []
    _zero_counts()
    for i, tokens in enumerate(batches):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, loss = step_fn(state, params, tokens)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        losses.append(float(loss))
        step = _step_counts(before, _counts())
        check((step["flash"], step["bwd_dq"], step["bwd_dkv"], step["fp8"])
              == (2 * n, n, n, 0), f"LoRA step {i + 1} launched {step}")
    launched = {k: _counts()[k] for k in ("flash", "bwd_dq", "bwd_dkv")}
    with torch.no_grad():
        after = float(train_mod.causal_lm_loss(
            lora_mod.merge_lora_differentiable(params, state["lora"], lcfg),
            cfg, batches[0]))
    peak = torch.cuda.max_memory_allocated()
    moved = all(bool((ab["b"] != 0).any()) for ab in state["lora"].values())
    same = all(_same_bits(p.detach(), frozen[name])
               and p.grad is None and not p.requires_grad
               for name, p in params.named_parameters())
    log(f"  LoRA steps: losses {losses}, then {after:.6f} on step 1's "
        f"batch; launches {launched}; base byte-equal {same}, adapters "
        f"moved {moved}; smoke run, not a benchmark: peak memory "
        f"{peak / 2**30:.2f} GiB (with the base's {copy_gib:.2f} GiB copy "
        f"for the byte check), step walls {[round(w, 4) for w in walls]} s")
    check(same, "a base weight changed or holds a grad")
    check(moved, "an adapter's b did not move")
    check(all(math.isfinite(x) for x in losses + [after]),
          "a non-finite LoRA loss")
    check(after < losses[0], f"the LoRA loss did not fall: {after} after "
          f"vs {losses[0]}")
    del state, lora, frozen
    return {"launches": launched, "losses": losses, "after": after,
            "peak_gib": peak / 2**30, "copy_gib": copy_gib, "walls": walls}


def fp8_train_part(params, cfg, batches) -> dict:
    """Phase 11 (b): the same masters wrapped for fp8 (``wrap_params_fp8``),
    remat "full", loss chunk 512, AdamW. Step 1's fp8 loss within
    FP8_BF16_LOSS_TOL of the bf16 model's loss on the same batch; 3 steps
    each launching 2n flash, n dQ, n dK/dV and 4 × 7 × n ``_scaled_mm``
    (the forward, its remat recompute, dx and dw of every projection);
    after step k every history holds k observations (``_check_history_fill``);
    the masters stay bf16; the loss on step 1's batch falls. Returns the
    numbers."""
    n = cfg.n_layers
    with torch.no_grad():
        bf16_loss = float(train_mod.chunked_causal_lm_loss(
            params, cfg, batches[0], chunk=LOSS_CHUNK))
    wrapped = fp8_mod.wrap_params_fp8(params)
    init_state, step_fn = train_mod.make_train_step(
        cfg, remat="full", loss_chunk=LOSS_CHUNK, fp8=True)
    state = init_state(wrapped)
    losses, walls, zeros = [], [], []
    _zero_counts()
    for i, tokens in enumerate(batches):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, loss = step_fn(state, tokens)
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        losses.append(float(loss))
        step = _step_counts(before, _counts())
        want = {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n, "fp8": 4 * 7 * n}
        check({k: step[k] for k in want} == want,
              f"fp8 train step {i + 1} launched {step}")
        check(step["ragged"] == step["decode"] == step["dense"]
              == step["quant"] == 0, f"fp8 step {i + 1} launched {step}")
        zeros.append(_check_history_fill(state["params"], i + 1)["g_hist"])
    launched = {k: _counts()[k] for k in ("flash", "bwd_dq", "bwd_dkv",
                                          "fp8")}
    peak = torch.cuda.max_memory_allocated()
    masters = {p.dtype for p in fp8_mod.unwrap_params_fp8(
        state["params"]).parameters()}
    with torch.no_grad():
        after = float(train_mod.chunked_causal_lm_loss(
            state["params"], cfg, batches[0], chunk=LOSS_CHUNK))
    log(f"  fp8 train: step 1's loss {losses[0]:.6f} beside the bf16 "
        f"model's {bf16_loss:.6f} on the same batch (|d| "
        f"{abs(losses[0] - bf16_loss):.6f}); losses {losses}, then "
        f"{after:.6f} on step 1's batch; launches {launched} in "
        f"{len(batches)} steps; masters {sorted(map(str, masters))}; zero g "
        f"observations of the {7 * n} projections after each step {zeros} "
        f"(flushed gradients); smoke "
        f"run, not a benchmark: peak memory {peak / 2**30:.2f} GiB, step "
        f"walls {[round(w, 4) for w in walls]} s")
    check(abs(losses[0] - bf16_loss) < FP8_BF16_LOSS_TOL,
          f"fp8 step 1's loss {losses[0]} vs bf16 {bf16_loss}")
    check(masters == {torch.bfloat16}, f"masters {masters}")
    check(all(math.isfinite(x) for x in losses + [after]),
          "a non-finite fp8 loss")
    check(after < losses[0], f"the fp8 loss did not fall: {after} after vs "
          f"{losses[0]}")
    del state, wrapped
    return {"launches": launched, "losses": losses, "bf16_loss": bf16_loss,
            "after": after, "peak_gib": peak / 2**30, "walls": walls,
            "zero_g_observations": zeros}


def finetune_example_part() -> dict:
    """``examples/finetune_lora.main`` on the card with no ``--device``:
    FT_EXAMPLE_CFG's random weights as an HF checkpoint, 2 steps,
    ``--export``. Each step launches 2 × 2 flash and 2 dQ and dK/dV
    kernels; the export holds the checkpoint's keys and shapes, and only
    q_proj and v_proj moved."""
    cfg = FT_EXAMPLE_CFG
    n = cfg.n_layers * FT_EXAMPLE_STEPS
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED + 4), DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        write_hf_checkpoint(params, cfg, ckpt, shards=1)
        out = os.path.join(tmp, "merged.npz")
        _zero_counts()
        finetune_example.main(["--checkpoint", ckpt, "--steps",
                               str(FT_EXAMPLE_STEPS), "--export", out,
                               *SERVE_DEVICE])
        counts = _counts()
        got = np.load(out)
        want = {k: v.float().cpu().numpy() for k, v in
                convert_mod.params_to_hf_state_dict(cfg, params).items()}
        check(sorted(got.files) == sorted(want), "the export's keys differ "
              "from the checkpoint's")
        moved = sorted(k for k in want if not np.array_equal(got[k], want[k]))
        check(all(got[k].shape == v.shape and got[k].dtype == np.float32
                  for k, v in want.items()), "an exported shape or dtype")
        check(bool(moved) and all(k.endswith(("q_proj.weight",
                                              "v_proj.weight"))
                                  for k in moved), f"moved: {moved}")
    check((counts["flash"], counts["bwd_dq"], counts["bwd_dkv"])
          == (2 * n, n, n), f"finetune_lora launched {counts}")
    log(f"  examples/finetune_lora on the card: {len(want)} tensors "
        f"exported, {len(moved)} moved (q_proj, v_proj); launches {counts}")
    return {k: counts[k] for k in ("flash", "bwd_dq", "bwd_dkv")}


def finetune_phase(card: str) -> dict:
    """Phase 11: the fp8 products, then llama-3-8b at full width and depth
    (random bf16 weights from the seed) on 3 batches of (1, 2048) from the
    native TokenLoader: the LoRA finetune over the frozen model, then the
    same masters wrapped for fp8 training, then ``finetune_lora`` as a
    user runs it."""
    products = fp8_products_phase(card)
    cfg = L.LLAMA_CONFIGS[FT_MODEL]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        with TokenLoader(_train_corpus(tmp, cfg.vocab_size), 1, TRAIN_SEQ,
                         seed=SEED + 2) as loader:
            check(loader.native, "the TokenLoader runs its Python path")
            batches = [torch.from_numpy(loader.next()).to(DEVICE)
                       for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    log(f"  {FT_MODEL}: init and {TRAIN_STEPS} batches of (1, {TRAIN_SEQ}) "
        f"from the native TokenLoader in {time.monotonic() - t0:.2f} s")
    lora = lora_finetune_part(params, cfg, batches)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fp8 = fp8_train_part(params, cfg, batches)
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    example = finetune_example_part()
    return {"products": products, "lora": lora, "fp8": fp8,
            "example": example}


# ---------------------------------------------------------------------------
# Resume

RESUME_MODEL = "gemma-2b"
# gemma-2b cut from 18 layers to 4: the checks (the emergency save on
# SIGTERM, every digest equal after the restore, training on) do not
# depend on depth, and the state's host copies, writes and reads scale
# with it.
RESUME_LAYERS = 4
RESUME_STEPS = 3
RESUME_GRACE_S = 120
# The parent restores into a state made from another seed, so that equal
# digests can come only from the checkpoint's bytes.
RESUME_FRESH_SEED = 7
# The host holds the pending snapshot beside the async queue's copy (and,
# while the next one is made, a third); the disk holds two steps.
RESUME_HEADROOM = 2.5
RESUME_CHILD_TIMEOUT = 900.0
# The restore of a 15 GB state reads every file twice (validation, then
# the copy), so its budget is larger than MigrationConfig's default 60 s.
RESUME_RESTORE_BUDGET_S = 600.0
# The child runs from the env of the pod the port renders for a notebook
# on one H100 card.
RESUME_POD = {"name": "resume", "namespace": "smoke",
              "gpu": {"accelerator": "h100", "topology": "1"}}
# The culler's idle time (CULL_IDLE_TIME, minutes) in phase 12's loop; its
# FakeClock is advanced past it once the child has saved its last step.
RESUME_IDLE_MIN = 10
# The card's memory against the catalog entry's HBM: at least this share.
CARD_MEMORY_SHARE = 0.95
RESUME_TAG = "resume-child "
# The per-leaf digest: the sum of the leaf's bytes, and the sum of each
# byte times its position modulo a prime, modulo the prime; computed where
# the leaf lies, DIGEST_CHUNK bytes at a time.
DIGEST_PRIME = 2_147_483_647
DIGEST_CHUNK = 1 << 26
# The child: ``python -c`` on this, from the checkout's root, with the
# corpus, the model, its depth, S, the loss chunk, the steps, the device
# ("" for the card) and the devices bootstrap expects.
RESUME_CHILD_CODE = ("import sys, chip_smoke; "
                     "sys.exit(chip_smoke.resume_child(sys.argv[1:]))")


@torch.no_grad()
def leaf_digest(t: torch.Tensor) -> list[int]:
    """[Σ bytes, Σ byte · (position mod P) mod P] over ``t``'s raw bytes."""
    data = t.detach().contiguous().reshape(-1).view(torch.uint8)
    total = torch.zeros((), dtype=torch.int64, device=data.device)
    weighted = torch.zeros((), dtype=torch.int64, device=data.device)
    for start in range(0, data.numel(), DIGEST_CHUNK):
        chunk = data[start:start + DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(start, start + chunk.numel(), dtype=torch.int64,
                           device=data.device) % DIGEST_PRIME
        total += chunk.sum()
        weighted = (weighted + (chunk * pos % DIGEST_PRIME).sum()
                    ) % DIGEST_PRIME
    return [int(total), int(weighted)]


def state_digests(state) -> dict:
    """{leaf path: leaf_digest} of a train state."""
    return {path: leaf_digest(t) for path, t in flatten_state(state)}


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def resume_child_args(argv: list) -> dict:
    """The child's arguments: corpus, model, its depth (layers), seq, loss
    chunk, steps, the device ("" for the card, as a user's call passes
    none) and the devices ``bootstrap`` expects (the pod's rendered
    ``nvidia.com/gpu`` limit)."""
    if len(argv) != 8:
        raise SystemExit("usage: resume_child CORPUS MODEL LAYERS SEQ "
                         f"LOSS_CHUNK STEPS DEVICE EXPECTED_DEVICES, got {argv}")
    corpus, model, layers, seq, chunk, steps, device, expected = argv
    if model not in L.LLAMA_CONFIGS:
        raise SystemExit(f"unknown model {model!r}")
    try:
        layers, seq, chunk, steps, expected = (
            int(layers), int(seq), int(chunk), int(steps), int(expected))
    except ValueError:
        raise SystemExit("LAYERS, SEQ, LOSS_CHUNK, STEPS and "
                         f"EXPECTED_DEVICES must be integers: {argv}")
    if layers < 1 or seq < 2 or chunk < 0 or steps < 1 or expected < 1:
        raise SystemExit("bad LAYERS, SEQ, LOSS_CHUNK, STEPS or "
                         f"EXPECTED_DEVICES in {argv}")
    return {"corpus": corpus, "model": model, "layers": layers, "seq": seq,
            "loss_chunk": chunk, "steps": steps, "device": device or None,
            "expected_devices": expected}


def resume_config(model: str, layers: int):
    """``model``'s config cut to ``layers`` layers."""
    return dataclasses.replace(L.LLAMA_CONFIGS[model], n_layers=layers)


def _child_print(event: str, **fields) -> None:
    print(RESUME_TAG + json.dumps({"event": event, **fields}), flush=True)


def child_record(line: str):
    """The record of a child's output line, or None for any other line."""
    if not line.startswith(RESUME_TAG):
        return None
    return json.loads(line[len(RESUME_TAG):])


def resume_child(argv: list) -> int:
    """Phase 12's child, as a notebook user trains: ``bootstrap``, a
    ``CheckpointManager`` in ``checkpoint_dir_from_env()`` (interval 100,
    async, keep 2), ``install_preemption_handler``, then each step's
    ``save``: step 1 commits on the worker thread, later steps are only
    pending. After each ``save`` returns it prints the step's wall, the
    ``save`` call's wall (the host copy), the step's kernel launches and
    every leaf's digest, computed on the card; then it waits in
    ``signal.pause()`` for SIGTERM, whose handler commits the newest step
    and ends the process with the signal."""
    import logging

    from kubeflow_tpu_torch.runtime import (
        bootstrap,
        checkpoint_dir_from_env,
        install_preemption_handler,
    )

    args = resume_child_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s %(levelname)s %(message)s")
    rt = bootstrap(expected_devices=args["expected_devices"],
                   device=args["device"])
    dev = rt.device
    ckpt = CheckpointManager(checkpoint_dir_from_env(),
                             save_interval_steps=100, async_save=True,
                             max_to_keep=2)
    install_preemption_handler(ckpt)
    cfg = resume_config(args["model"], args["layers"])
    params = L.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           dev)
    init_state, step_fn = train_mod.make_train_step(
        cfg, remat="full", loss_chunk=args["loss_chunk"])
    state = init_state(params)
    _child_print("init", device=str(dev), digests=state_digests(state))
    with TokenLoader(args["corpus"], 1, args["seq"], seed=SEED + 1) as loader:
        batches = [torch.from_numpy(loader.next()).to(dev)
                   for _ in range(args["steps"])]
    for step, tokens in enumerate(batches, start=1):
        before = _counts()
        _sync(dev)
        t0 = time.monotonic()
        state, loss = step_fn(state, tokens)
        _sync(dev)
        step_s = time.monotonic() - t0
        launches = _step_counts(before, _counts())
        t0 = time.monotonic()
        enqueued = ckpt.save(step, state, metadata={"start_batch": step})
        save_s = time.monotonic() - t0
        _child_print("saved", step=step, loss=float(loss), step_s=step_s,
                     save_s=save_s, enqueued=enqueued, launches=launches,
                     digests=state_digests(state))
    signal.pause()
    return 1  # only when SIGTERM's disposition let the process live


def _state_nbytes(state) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten_state(state))


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


class _JupyterStub:
    """A loopback stand-in for the notebook's Jupyter server: GET
    ``.../api/kernels`` and ``.../api/terminals`` return ``kernels`` and
    ``terminals`` as JSON (404 while they are None)."""

    def __init__(self):
        self.kernels = self.terminals = None
        self.requests = 0
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                stub.requests += 1
                payload = (stub.kernels if self.path.endswith("/api/kernels")
                           else stub.terminals
                           if self.path.endswith("/api/terminals") else None)
                body = b"" if payload is None else json.dumps(
                    payload).encode()
                self.send_response(404 if payload is None else 200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self._thread.join(timeout=10)


def resume_pod(ckpt_dir: str) -> dict:
    """The pod the port's controller loop makes for phase 12's notebook:
    ``RESUME_POD`` on one h100 card with the checkpoint grace and
    directory annotations, created in a ``FakeCluster`` (on a
    ``FakeClock``) whose Notebook mutating hook is ``mutate_gpu_notebook``,
    over one node of the card's catalog entry (``add_gpu_node_pool``),
    with ``FakeKubelet``, ``NotebookReconciler`` and ``CullingReconciler``
    (its Python prober through the DEV proxy, a loopback Jupyter stub)
    under one ``Manager`` and one ``Metrics`` bundle. Checks the pod the
    kubelet made: the card resource, the nodeSelector, the toleration,
    the grace period, one replica, Ready; and the Notebook's
    ``status.gpu`` Healthy with 1 ready host. Returns {"env": pod 0's
    container env with its pod index filled in, "expected_devices": the
    nvidia.com/gpu limit, "termination_grace_s", "accelerator": the
    catalog entry, "render_s": Notebook create to Healthy, "loop": the
    loop's objects}."""
    name, ns = RESUME_POD["name"], RESUME_POD["namespace"]
    card = gpu_topology.slice_from_spec("h100", "1")
    clock = k8s_mod.FakeClock()
    cluster = k8s_mod.FakeCluster(clock=clock)
    cluster.register_mutating_webhook(
        "Notebook", lambda req: gpu_env.mutate_gpu_notebook(req.object))
    mgr = k8s_mod.Manager(cluster, clock=clock)
    k8s_mod.FakeKubelet(cluster).register(mgr)
    k8s_mod.add_gpu_node_pool(
        cluster, card.gke_accelerator_label, card.topology_str, hosts=1,
        cards_per_host=card.accelerator.chips_per_host)
    metrics = Metrics(cluster)
    controller_mod.NotebookReconciler(cluster, metrics=metrics,
                                      clock=clock).register(mgr)
    stub = _JupyterStub()
    proxy = f"http://127.0.0.1:{stub.port}"
    culler = culling_mod.CullingReconciler(
        cluster, config=culling_mod.CullerConfig(
            enable_culling=True, cull_idle_time_min=RESUME_IDLE_MIN,
            dev_mode=True),
        prober=prober_mod.make_prober(timeout_s=5.0, dev_proxy=proxy),
        metrics=metrics, clock=clock)
    culler.register(mgr)
    loop = {"cluster": cluster, "clock": clock, "manager": mgr,
            "metrics": metrics, "culler": culler, "stub": stub,
            "proxy": proxy, "name": name, "namespace": ns}
    try:
        obj = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
               "metadata": {"name": name, "namespace": ns,
                            "annotations": {
                                ann_mod.TPU_CHECKPOINT_GRACE:
                                    str(RESUME_GRACE_S),
                                ann_mod.TPU_CHECKPOINT_DIR: ckpt_dir}},
               "spec": {"template": {"spec": {"containers": [
                   {"name": name, "image": "notebook"}]}},
                   "gpu": dict(RESUME_POD["gpu"])}}
        t0 = time.monotonic()
        cluster.create(obj)
        mgr.run_until_idle()
        render_s = time.monotonic() - t0
        check(not mgr.reconcile_errors, f"the loop: {mgr.reconcile_errors}")
        sts = cluster.get("StatefulSet", name, ns)
        pods = cluster.list("Pod", ns)
        check(len(pods) == 1, f"the loop made {len(pods)} pods")
        (pod,) = pods
        spec = pod["spec"]
        (container,) = spec["containers"]
        res = container["resources"]
        gpu = controller_mod.GPU_RESOURCE
        check(res["limits"].get(gpu) == res["requests"].get(gpu) == "1",
              f"the pod's {gpu} resources: {res}")
        check(spec["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"},
            f"the pod's nodeSelector: {spec['nodeSelector']}")
        check(spec["tolerations"] == [{"key": gpu, "operator": "Exists",
                                       "effect": "NoSchedule"}],
              f"the pod's tolerations: {spec['tolerations']}")
        grace = spec["terminationGracePeriodSeconds"]
        check(grace == RESUME_GRACE_S + gpu_env.CHECKPOINT_FLUSH_MARGIN_S,
              f"terminationGracePeriodSeconds {grace}")
        check(sts["spec"]["replicas"] == 1,
              f"replicas {sts['spec']['replicas']}")
        check(pod["status"].get("phase") == "Running"
              and spec.get("nodeName"), f"the pod: {pod['status']}")
        status = cluster.get("Notebook", name, ns)["status"]["gpu"]
        check(status["readyHosts"] == 1 and status["sliceHealth"]
              == "Healthy", f"the Notebook's status.gpu: {status}")
        index = int(pod["metadata"]["labels"][gpu_env.POD_INDEX_LABEL])
        env = gpu_env.pod_env(container, index)
        check(env["TPU_WORKER_ID"] == "0"
              and env[ann_mod.CHECKPOINT_GRACE_ENV_NAME] == str(RESUME_GRACE_S)
              and env[ann_mod.CHECKPOINT_DIR_ENV_NAME] == ckpt_dir
              and "JAX_COORDINATOR_ADDRESS" not in env,
              f"the pod's env: {env}")
    except BaseException:
        stub.stop()
        raise
    topo = Notebook(cluster.get("Notebook", name, ns)).gpu.slice_topology()
    return {"env": env, "expected_devices": int(res["limits"][gpu]),
            "termination_grace_s": grace, "accelerator": topo.accelerator,
            "render_s": render_s, "loop": loop}


def _sample(text: str, name: str) -> float:
    """The value of the unlabelled sample ``name`` in an exposition."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"no sample {name} in the exposition")


def cull_pod(loop: dict) -> dict:
    """With the child running: the loop's metrics and status, then the
    cull. The Jupyter stub reports one idle kernel (and no terminal), the
    clock moves past the idle time, the culler probes through the DEV
    proxy and sets the stop annotation, and the reconciler scales the
    StatefulSet to 0 (the kubelet deletes the pod): what the phase turns
    into the child's SIGTERM. Checks the counters, scrapes the whole
    exposition once over HTTP from a ``MetricsServer``, and probes the
    stub with the native prober (built with g++ here) against the Python
    one. Returns the loop's numbers, "stopped_at" the monotonic time the
    stop annotation landed."""
    t_host = time.monotonic()
    cluster, mgr, metrics = loop["cluster"], loop["manager"], loop["metrics"]
    name, ns, clock = loop["name"], loop["namespace"], loop["clock"]
    reg = metrics.registry
    metrics.collect_running()
    check(reg.get_sample_value("notebook_create_total") == 1.0
          and reg.get_sample_value("tpu_slice_ready_seconds_count") == 1.0,
          "notebook_create_total / tpu_slice_ready_seconds: "
          f"{reg.get_sample_value('notebook_create_total')}, "
          f"{reg.get_sample_value('tpu_slice_ready_seconds_count')}")
    check(reg.get_sample_value("tpu_chips_in_use") == 1.0
          and reg.get_sample_value("notebook_running") == 1.0,
          f"collect_running counts {reg.get_sample_value('tpu_chips_in_use')}"
          " cards")
    idle_at = time.strftime("%Y-%m-%dT%H:%M:%S.000000Z",
                            time.gmtime(clock.now() - 3600))
    stub = loop["stub"]
    stub.kernels = [{"id": "k0", "execution_state": "idle",
                     "last_activity": idle_at}]
    stub.terminals = []
    culler, marks, probe_s = loop["culler"], {}, []
    real_probe, real_cull = culler.prober.probe, culler._cull

    def probe(nb, hosts):
        t0 = time.monotonic()
        try:
            return real_probe(nb, hosts)
        finally:
            probe_s.append(time.monotonic() - t0)

    def cull(*args):
        real_cull(*args)
        marks["stopped_at"] = time.monotonic()

    culler.prober.probe, culler._cull = probe, cull
    try:
        mgr.tick(RESUME_IDLE_MIN * 60 + 61)
    finally:
        culler.prober.probe, culler._cull = real_probe, real_cull
    check(not mgr.reconcile_errors, f"the loop: {mgr.reconcile_errors}")
    nb = cluster.get("Notebook", name, ns)
    check(ann_mod.STOP in nb["metadata"].get("annotations", {}),
          "the culler set no stop annotation")
    check(len(probe_s) == 1 and stub.requests == 2,
          f"{len(probe_s)} probes, {stub.requests} stub requests")
    sts = cluster.get("StatefulSet", name, ns)
    check(sts["spec"]["replicas"] == 0 and not cluster.list("Pod", ns),
          f"after the cull: replicas {sts['spec']['replicas']}, "
          f"{len(cluster.list('Pod', ns))} pods")
    check(nb["status"]["gpu"]["sliceHealth"] == "Stopped",
          f"status.gpu after the cull: {nb['status']['gpu']}")
    srv = MetricsServer(metrics, port=0)
    srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
            ctype = resp.headers["Content-Type"]
    finally:
        srv.stop()
    got = {k: _sample(text, k) for k in (
        "notebook_culling_total", "tpu_chips_reclaimed_total",
        "tpu_chips_in_use", "notebook_running", "notebook_create_total",
        "tpu_slice_ready_seconds_count")}
    check(got == {"notebook_culling_total": 1.0,
                  "tpu_chips_reclaimed_total": 1.0, "tpu_chips_in_use": 0.0,
                  "notebook_running": 0.0, "notebook_create_total": 1.0,
                  "tpu_slice_ready_seconds_count": 1.0}
          and ctype.startswith("text/plain; version=0.0.4"),
          f"the scraped exposition: {got}, {ctype}")
    host_s = time.monotonic() - t_host
    t0 = time.monotonic()
    prober_mod.load_lib()
    build_s = time.monotonic() - t0
    nbv = Notebook(nb)
    native = prober_mod.NativeFanoutProber(timeout_s=5.0, port=stub.port)
    python = culling_mod.JupyterHTTPProber(timeout_s=5.0,
                                           dev_proxy=loop["proxy"])
    t0 = time.monotonic()
    got_native = [dataclasses.asdict(a)
                  for a in native.probe(nbv, ["127.0.0.1"])]
    native_s = time.monotonic() - t0
    got_python = [dataclasses.asdict(a)
                  for a in python.probe(nbv, ["127.0.0.1"])]
    check(got_native == got_python and got_native[0]["reachable"]
          and not got_native[0]["busy"]
          and got_native[0]["last_activity"] is not None,
          f"native prober {got_native} != Python prober {got_python}")
    return {"probe_s": probe_s[0], "host_s": host_s,
            "prober_build_s": build_s, "native_probe_s": native_s,
            "stopped_at": marks["stopped_at"], "scrape_bytes": len(text),
            "activity": got_native[0]}


def _run_resume_child(corpus: str, pod: dict, cfg_name: str,
                      on_saved=None) -> dict:
    """Start the child from the rendered pod's env, wait for its last
    "saved" record, call ``on_saved()`` (with the child alive; its result
    is returned as "on_saved"), send SIGTERM and wait for its death:
    {"records", "log", "returncode", "exit_s", "exited_at", "on_saved"}."""
    device = "" if DEVICE == "cuda" else DEVICE
    proc = subprocess.Popen(
        [sys.executable, "-c", RESUME_CHILD_CODE, corpus, cfg_name,
         str(RESUME_LAYERS), str(TRAIN_SEQ), str(LOSS_CHUNK),
         str(RESUME_STEPS), device, str(pod["expected_devices"])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **pod["env"]})
    records, log_lines, last = [], [], threading.Event()

    def read_out():
        for line in proc.stdout:
            rec = child_record(line.rstrip("\n"))
            if rec is not None:
                records.append(rec)
                if rec["event"] == "saved" and rec["step"] == RESUME_STEPS:
                    last.set()
        last.set()

    def read_err():
        for line in proc.stderr:
            log_lines.append(line.rstrip("\n"))

    readers = [threading.Thread(target=f, daemon=True)
               for f in (read_out, read_err)]
    for r in readers:
        r.start()
    try:
        last.wait(RESUME_CHILD_TIMEOUT)
        check(bool(records) and records[-1]["event"] == "saved"
              and records[-1]["step"] == RESUME_STEPS and proc.poll() is None,
              f"the child did not report step {RESUME_STEPS} (rc "
              f"{proc.poll()}): " + "\n".join(log_lines[-30:]))
        saved_out = on_saved() if on_saved is not None else None
        check(proc.poll() is None, "the child died before its SIGTERM")
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=RESUME_GRACE_S + 5)
        except subprocess.TimeoutExpired:
            check(False, "the child outlived SIGTERM by the grace + 5 s: "
                  + "\n".join(log_lines[-30:]))
        exited_at = time.monotonic()
        exit_s = exited_at - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for r in readers:
            r.join(timeout=30)
    return {"records": records, "log": log_lines,
            "returncode": proc.returncode, "exit_s": exit_s,
            "exited_at": exited_at, "on_saved": saved_out}


def logged_seconds(lines: list, prefix: str) -> float:
    """The seconds of the last log line holding ``prefix`` and ending in
    "in <seconds>s"."""
    hits = [x for x in lines if prefix in x]
    check(bool(hits), f"the child's log has no {prefix!r}")
    return float(hits[-1].rsplit(" in ", 1)[1].rstrip("s"))


@contextlib.contextmanager
def _timed(module, name: str, seconds: dict):
    """Sum the wall seconds of ``module.name``'s calls into
    ``seconds[name]`` for the duration."""
    real = getattr(module, name)
    seconds[name] = 0.0

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        try:
            return real(*args, **kwargs)
        finally:
            seconds[name] += time.monotonic() - t0

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, real)


def _check_child(child: dict, n: int) -> tuple:
    """The child's records: one "init", a "saved" for every step, each
    with its step's launches (2n flash, n dQ, n dK/dV on the card; none
    on the CPU, where the wrappers run their plain versions) and a finite
    loss, only step 1's save enqueued; death by SIGTERM. Returns (init,
    {step: saved record})."""
    recs = child["records"]
    init = [r for r in recs if r["event"] == "init"]
    saved = {r["step"]: r for r in recs if r["event"] == "saved"}
    check(len(init) == 1 and sorted(saved) == list(
        range(1, RESUME_STEPS + 1)), f"child records {len(recs)}")
    check(child["returncode"] == -signal.SIGTERM,
          f"the child exited {child['returncode']}, not by SIGTERM: "
          + "\n".join(child["log"][-30:]))
    want = ({"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n} if DEVICE == "cuda"
            else {"flash": 0, "bwd_dq": 0, "bwd_dkv": 0})
    for step, rec in saved.items():
        got = {k: rec["launches"][k] for k in want}
        check(got == want, f"the child's step {step} launched "
                           f"{rec['launches']}")
        check(math.isfinite(rec["loss"]), f"child loss {rec['loss']}")
        check(rec["enqueued"] == (step == 1),
              f"the child's save {step} returned {rec['enqueued']}")
    return init[0], saved


def resume_phase(cfg_name: str = RESUME_MODEL) -> dict:
    """Phase 12: a child trains ``cfg_name`` at full width, cut to
    ``RESUME_LAYERS`` layers, on the
    card (B 1, S 2048, remat "full", AdamW, TokenLoader batches) with the
    emergency-save handler installed, and is sent SIGTERM after its last
    ``save``: it must die of the signal within the grace + 5 s, after
    committing its newest step. The parent then restores that step on the
    card into a state from another seed through a ``MigrationOrchestrator``
    (its save step finds nothing newer), holds every leaf's digest to the
    child's, reads the loader cursor back and trains one step from it,
    counting its launches. The child's env and its ``expected_devices``
    come from the pod the port's controller loop makes for the notebook
    (``resume_pod``); the loop's culler stops the notebook once the child
    has saved (``cull_pod``), and the scale-to-0 it causes becomes the
    child's SIGTERM. Its SIGTERM-to-exit seconds, and the stop
    annotation's, must stay under the pod's
    terminationGracePeriodSeconds, and on the card the card's memory must
    hold ``CARD_MEMORY_SHARE`` of the catalog entry's HBM. Returns the
    phase's numbers."""
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = resume_config(cfg_name, RESUME_LAYERS)
    n = cfg.n_layers
    init_state, step_fn = train_mod.make_train_step(
        cfg, remat="full", loss_chunk=LOSS_CHUNK)
    tmp = tempfile.mkdtemp(prefix="resume-")
    pod = None
    try:
        # The params and two AdamW moments like them; scalars aside.
        est = 3 * cfg.param_count() * torch.empty(
            (), dtype=cfg.dtype).element_size()
        mem, disk = _mem_available(), shutil.disk_usage(tmp).free
        log(f"  {cfg_name}: train state ~{est / 1e9:.2f} GB; host "
            f"MemAvailable {mem / 1e9:.2f} GB, free disk {disk / 1e9:.2f} GB "
            f"under {tmp}")
        check(mem >= RESUME_HEADROOM * est and disk >= RESUME_HEADROOM * est,
              f"phase 12 needs {RESUME_HEADROOM}x the state ({est / 1e9:.2f} "
              f"GB) in host memory and on disk: MemAvailable "
              f"{mem / 1e9:.2f} GB, free disk {disk / 1e9:.2f} GB")
        corpus = _train_corpus(tmp, cfg.vocab_size)
        ckpt_dir = os.path.join(tmp, "ckpt")
        pod = resume_pod(ckpt_dir)
        acc = pod["accelerator"]
        card = {"catalog": acc.name, "hbm_gib_per_chip": acc.hbm_gib_per_chip}
        if DEVICE == "cuda":
            props = torch.cuda.get_device_properties(0)
            card.update(name=props.name,
                        total_memory_gib=props.total_memory / 2**30)
            log(f"  card {props.name}: {props.total_memory} bytes "
                f"({card['total_memory_gib']:.2f} GiB) beside {acc.name}'s "
                f"{acc.hbm_gib_per_chip} GiB in the catalog")
            check(props.total_memory
                  >= CARD_MEMORY_SHARE * acc.hbm_gib_per_chip * 2**30,
                  f"the card's {props.total_memory} bytes are under "
                  f"{CARD_MEMORY_SHARE} of {acc.name}'s "
                  f"{acc.hbm_gib_per_chip} GiB")
        log(f"  the child's pod: {pod['expected_devices']} nvidia.com/gpu, "
            f"terminationGracePeriodSeconds {pod['termination_grace_s']}, "
            f"{len(pod['env'])} env entries; the controller loop took it "
            f"from the Notebook's create to Healthy in "
            f"{pod['render_s']:.4f} s")
        child = _run_resume_child(corpus, pod, cfg_name,
                                  on_saved=lambda: cull_pod(pod["loop"]))
        init, saved = _check_child(child, n)
        check(child["exit_s"] < pod["termination_grace_s"],
              f"SIGTERM to exit {child['exit_s']:.3f} s, over the pod's "
              f"terminationGracePeriodSeconds {pod['termination_grace_s']}")
        culled = child["on_saved"]
        stop_to_exit = child["exited_at"] - culled["stopped_at"]
        check(stop_to_exit < pod["termination_grace_s"],
              f"stop annotation to exit {stop_to_exit:.3f} s, over the pod's "
              f"terminationGracePeriodSeconds {pod['termination_grace_s']}")
        log(f"  the loop: culled after {RESUME_IDLE_MIN} idle minutes on its "
            f"clock, the culler's probe {culled['probe_s']:.4f} s through "
            f"the DEV proxy, the stop annotation to the child's exit "
            f"{stop_to_exit:.3f} s; the loop's host work "
            f"{pod['render_s'] + culled['host_s']:.4f} s; the native prober "
            f"built in {culled['prober_build_s']:.3f} s and probed the stub "
            f"in {culled['native_probe_s']:.4f} s, folding to "
            f"{culled['activity']} as the Python prober does; /metrics "
            f"scraped once ({culled['scrape_bytes']} bytes)")
        emergency_s = logged_seconds(
            child["log"], f"emergency save: committed step {RESUME_STEPS}")
        first_s = logged_seconds(child["log"], "checkpoint step 1 committed")
        # The emergency save's write alone, without its drain of step 1.
        write_s = logged_seconds(
            child["log"], f"checkpoint step {RESUME_STEPS} committed")

        mgr = CheckpointManager(ckpt_dir, max_to_keep=2)
        on_disk = sorted(int(p) for p in os.listdir(ckpt_dir) if p.isdigit())
        check(mgr.latest_step() == RESUME_STEPS
              and on_disk == [1, RESUME_STEPS], f"committed steps {on_disk}")
        with open(os.path.join(ckpt_dir, str(RESUME_STEPS),
                               ckpt_mod.MANIFEST_NAME)) as f:
            manifest = json.load(f)
        nbytes = sum(e["size"] for e in manifest["files"])
        check(manifest["step"] == RESUME_STEPS
              and manifest["metadata"] == {"start_batch": RESUME_STEPS}
              and manifest["process"] == {"index": 0, "count": 1}
              and [e["path"] for e in manifest["files"]]
              == list(saved[RESUME_STEPS]["digests"]),
              "the emergency step's manifest")

        params = L.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(
                RESUME_FRESH_SEED), DEVICE)
        state = init_state(params)
        check(_state_nbytes(state) == nbytes,
              f"{nbytes} bytes on disk, {_state_nbytes(state)} in a state")
        fresh = state_digests(state)
        seconds, fallbacks = {}, []

        def restore_fn(deadline):
            t0 = time.monotonic()
            with _timed(ckpt_mod, "_load_validated", seconds), \
                    _timed(ckpt_mod, "_copy_into", seconds):
                _, at = mgr.restore_latest(state)
            _sync(DEVICE)
            seconds["restore"] = time.monotonic() - t0
            return {"step": at, "start_batch": resume_start_batch(mgr, at)}

        orch = MigrationOrchestrator(
            MigrationConfig(fresh_within_s=0.0,
                            restore_budget_s=RESUME_RESTORE_BUDGET_S),
            checkpoint=mgr, claim_fn=lambda claimant, deadline: "card-0",
            restore_fn=restore_fn, flip_fn=lambda deadline: True,
            fallback_fn=lambda step, reason: fallbacks.append((step, reason)))
        report = orch.migrate("preemption-notice")
        check(report.completed and not fallbacks,
              f"migration fell back: {report}")
        check(report.steps["save"]["detail"]
              == f"nothing newer than committed step {RESUME_STEPS}",
              f"save step: {report.steps['save']}")
        check((report.restored_step, report.start_batch)
              == (RESUME_STEPS, RESUME_STEPS), f"restored {report}")
        check(resume_start_batch(mgr, report.restored_step) == RESUME_STEPS,
              "resume_start_batch")

        restored = state_digests(state)
        child3, child0 = saved[RESUME_STEPS]["digests"], init["digests"]
        check(restored == child3, f"restored leaves differ from the child's "
              f"step {RESUME_STEPS}: "
              f"{[p for p in child3 if restored.get(p) != child3[p]][:5]}")
        # A leaf may equal the fresh state's only where every seed inits it
        # alike and training left it (norm scales whose updates bf16
        # rounds away).
        same = [p for p in child3 if child3[p] == fresh[p]]
        check(all(child0[p] == fresh[p] for p in same),
              f"leaves equal to the fresh state's without a reason: {same}")
        sizes = {e["path"]: e["size"] for e in manifest["files"]}
        same_share = sum(sizes[p] for p in same) / nbytes
        check(same_share < 0.01, f"{same_share:.3%} of the bytes equal the "
              "fresh state's")

        with TokenLoader(corpus, 1, TRAIN_SEQ, seed=SEED + 1,
                         start_batch=report.start_batch) as loader:
            tokens = torch.from_numpy(loader.next()).to(DEVICE)
        _zero_counts()
        _sync(DEVICE)
        t0 = time.monotonic()
        state, loss = step_fn(state, tokens)
        _sync(DEVICE)
        step_s = time.monotonic() - t0
        counts = _counts()
        launched = {k: counts[k] for k in ("flash", "bwd_dq", "bwd_dkv")}
        check(launched == {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n},
              f"the resumed step launched {counts}")
        check(math.isfinite(float(loss)), f"the resumed step's loss {loss}")
        check(int(state["step"]) == RESUME_STEPS + 1,
              f"the state's step after resuming: {int(state['step'])}")

        gb = nbytes / 1e9
        numbers = {
            "model": cfg_name, "layers": n, "state_gb": gb,
            "grace_s": RESUME_GRACE_S,
            "emergency_save_s": emergency_s,
            "emergency_save_gb_per_s": gb / emergency_s,
            "emergency_write_s": write_s,
            "first_commit_s": first_s,
            "snapshot_s": [saved[s]["save_s"] for s in sorted(saved)],
            "child_step_s": [saved[s]["step_s"] for s in sorted(saved)],
            "sigterm_to_exit_s": child["exit_s"],
            "restore_s": seconds["restore"],
            "restore_validate_s": seconds["_load_validated"],
            "restore_copy_s": seconds["_copy_into"],
            "restore_gb_per_s": gb / seconds["restore"],
            "migration_s": {k: v.get("duration_s")
                            for k, v in report.steps.items()},
            "migration_total_s": report.duration_s,
            "leaves": len(child3), "leaves_equal_at_init": len(same),
            "resumed_loss": float(loss), "resumed_step_s": step_s,
            "launches": launched,
            "child_launches": {s: {k: saved[s]["launches"][k]
                                   for k in launched}
                               for s in sorted(saved)},
            "pod": {"expected_devices": pod["expected_devices"],
                    "termination_grace_s": pod["termination_grace_s"],
                    "render_s": pod["render_s"], "card": card},
            "loop": {"render_to_ready_s": pod["render_s"],
                     "cull_probe_s": culled["probe_s"],
                     "stop_to_exit_s": stop_to_exit,
                     "prober_build_s": culled["prober_build_s"],
                     "native_probe_s": culled["native_probe_s"],
                     "host_s": pod["render_s"] + culled["host_s"]},
        }
        log(f"  child: step walls "
            f"{[round(x, 4) for x in numbers['child_step_s']]} s, save() "
            f"(the host copy) {[round(x, 4) for x in numbers['snapshot_s']]}"
            f" s; step 1 committed asynchronously in {first_s:.3f} s")
        log(f"  SIGTERM → exit {child['exit_s']:.3f} s (grace "
            f"{RESUME_GRACE_S} s, exit code {child['returncode']}); "
            f"emergency save of step {RESUME_STEPS}: {gb:.2f} GB in "
            f"{emergency_s:.3f} s, {gb / emergency_s:.3f} GB/s, its drain "
            f"of step 1's write included; the write alone {write_s:.3f} s, "
            f"{gb / write_s:.3f} GB/s")
        log(f"  restore on the card: {seconds['restore']:.3f} s "
            f"({gb / seconds['restore']:.3f} GB/s), validation "
            f"{seconds['_load_validated']:.3f} s, copy "
            f"{seconds['_copy_into']:.3f} s; migration steps (s) "
            f"{json.dumps(numbers['migration_s'])}, total "
            f"{report.duration_s:.3f}")
        log(f"  {len(child3)} leaves' digests equal the child's step "
            f"{RESUME_STEPS}; {len(same)} equal the fresh state's too (alike "
            f"at init for every seed, {same_share:.4%} of the bytes); "
            f"resume_start_batch {report.start_batch}; the resumed step's "
            f"loss {float(loss):.6f} in {step_s:.3f} s, launches {launched}")
        numbers["phase_s"] = time.monotonic() - t_phase
        log(f"  phase 12: {numbers['phase_s']:.2f} s")
        del state, params
        return numbers
    finally:
        if pod is not None:
            pod["loop"]["stub"].stop()
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 13: tensor-parallel replicas

TP_DEGREE = 2
TP_MODEL = "llama-3-8b"
TP_DTYPE = None  # the model's own (bf16); the CPU rehearsal runs float32
TP_NEW = 32  # new tokens a request at degree 2 (phase 5's first 32)
TP_CHILD_TIMEOUT = 600.0
TP_TAG = "tp-child "
TP_CHILD_CODE = ("import sys, chip_smoke; "
                 "sys.exit(chip_smoke.tp_child(sys.argv[1:]))")


def tp_rank_shapes_vs_plain() -> dict:
    """One launch of each attention kernel a tp=2 rank of llama-3-8b runs
    (16 q heads over 4 kv heads) on the ragged, alternating and continuous
    engines, at the main-path shapes, held to its plain version by phase
    3's gates (each twice, bit-equal). Returns {kernel: {gate: error}}."""
    rank = {"hq": 32 // TP_DEGREE, "hkv": 8 // TP_DEGREE}
    out: dict = {"ragged": {}, "flash": {}}
    case = _case(MAIN_SPANS, seed=170, **{**MAIN, **rank})
    got = ragged_paged_attention(**case, q_tile=16)
    check_ragged_repeat(got, ragged_paged_attention(**case, q_tile=16),
                        "tp-rank main")
    owned = _owned(case)
    _gate("tp-rank ragged main", _errors(got, case, owned), out["ragged"])
    check(bool((got[~owned] == 0).all()), "tp-rank ragged: unowned rows "
                                          "not 0")
    fcase = _flash_case((1, rank["hq"], rank["hkv"], 512, 512, True, 0, 0,
                         (200,)), 128, seed=171)
    o, lse = flash_attention_fwd(**fcase)
    check_fwd_repeat((o, lse), flash_attention_fwd(**fcase), "tp-rank")
    errs = _flash_errors(o, lse, fcase)
    _gate("tp-rank flash main-prefill", errs, out["flash"])
    check(errs["lse"] <= LSE_TOL and errs["keyless_rows_ok"],
          f"tp-rank flash: lse error {errs['lse']} or a keyless row")
    out["flash"]["lse"] = errs["lse"]
    out["decode"] = _decode_vs_plain(
        "tp-rank decode", [(DEC_MAIN_LENS, {**DEC_MAIN, **rank}, {},
                            "main-decode", 172)],
        _decode_case, paged_decode_attention, paged_decode_reference,
        ("k_pool", "v_pool"))
    out["dense"] = _decode_vs_plain(
        "tp-rank dense", [(DEC_MAIN_LENS, {**DENSE_MAIN, **rank},
                           {"pad_frac": 0.25}, "main-decode", 173)],
        _dense_case, dense_decode_attention, dense_decode_reference,
        ("k_cache", "v_cache"))
    log(f"  kernels at a tp={TP_DEGREE} rank's shapes (16 q / 4 kv heads): "
        f"{json.dumps(out)}")
    return out


def _tp_engine(params, cfg, plan, ragged: bool, max_new: int):
    """Phase 5's ragged (``ragged``) or alternating paged engine."""
    return PagedBatcher(
        params, cfg, gen=GenerationConfig(max_new_tokens=max_new, eos_id=-1),
        slots=8, num_blocks=8 * 37 + 24, block_size=16, prompt_bucket=512,
        ragged=ragged, token_budget=512 if ragged else None, plan=plan,
        device=DEVICE,
    )


def _tp_config(name: str, dtype):
    cfg = L.LLAMA_CONFIGS[name]
    return cfg if dtype is None else dataclasses.replace(
        cfg, dtype=getattr(torch, dtype))


def _cut_config(name: str, dtype, layers=None):
    """``_tp_config`` cut to its first ``layers`` layers (None: whole)."""
    cfg = _tp_config(name, dtype)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _launches_a_call(cfg) -> int:
    """Kernel launches a forward makes: one a layer on the card; none on
    the CPU, where the wrappers run their plain versions."""
    return cfg.n_layers if torch.device(DEVICE).type == "cuda" else 0


def tp_child(argv: list) -> int:
    """One rank of phase 13 (a): joins the gloo group of ``TP_DEGREE`` on
    the spec's device (``cuda:0`` on the card), draws its shard of the
    spec's model from the seed, serves the ragged, alternating and
    continuous engines with ``plan=``, holds their tokens to phase 5's by
    the near-tie rule
    (the tp forwards are collectives: both ranks make them), and prints
    one ``tp-child {json}`` record."""
    global DEVICE
    spec = json.loads(open(argv[0]).read())
    rank = int(argv[1])
    started = time.time()
    DEVICE = spec["device"]
    on_card = torch.device(DEVICE).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    if on_card:
        torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=TP_DEGREE)
    plan = serving_plan(TP_DEGREE)
    cfg = _tp_config(spec["model"], spec["dtype"])
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
        plan=plan)
    _sync(DEVICE)
    weights = torch.cuda.memory_allocated() if on_card else 0
    inited = time.time()
    rec = {"rank": rank, "started": started, "inited": inited,
           "weights_gib": weights / 2**30,
           "wq_shape": list(params.layers[0].wq.shape),
           "w_down_shape": list(params.layers[0].w_down.shape)}
    # (kind, prompts, the module and its admission and step functions)
    kinds = (("ragged", "prompts", paged_mod, "_paged_admit", "_paged_step"),
             ("alternating", "alt_prompts", paged_mod, "_paged_admit",
              "_paged_step"),
             ("continuous", "alt_prompts", cont_mod, "_admit_slot",
              "_cb_step"))
    for kind, key, module, admit, step in kinds:
        prompts = spec[key]
        if kind == "continuous":
            engine = _cont_engine(params, cfg, plan=plan, max_new=TP_NEW)
            check(engine._attn_kernel == 512 or not on_card,
                  f"continuous: the dense kernel is off under a plan "
                  f"(block size {engine._attn_kernel})")
            heads = engine.cache["k"].shape[2]
        else:
            engine = _tp_engine(params, cfg, plan, kind == "ragged", TP_NEW)
            check(engine.attn_kernel or not on_card,
                  f"{kind}: the kernels are off under a plan")
            heads = engine.pool["k"].shape[2]
        check(heads == cfg.n_kv_heads // TP_DEGREE,
              f"{kind}: the rank's KV holds {heads} kv heads")
        per = _launches_a_call(cfg)
        with _counting_calls(module, admit, step) as calls:
            _sync(DEVICE)
            _zero_counts()
            t0 = time.monotonic()
            toks, lps = _serve(engine, prompts)
            _sync(DEVICE)
            wall = time.monotonic() - t0
            counts = _counts()
        admits, steps = calls[admit], calls[step]
        if kind == "ragged":
            steps = engine.ragged_steps
            check(steps > 0 and counts["ragged"] == steps * per,
                  f"rank {rank}: {counts['ragged']} ragged launches for "
                  f"{steps} steps × {cfg.n_layers} layers")
            check(counts["flash"] == counts["decode"] == counts["dense"]
                  == 0, f"rank {rank}: the ragged engine launched {counts}")
        else:
            # One flash prefill a layer an admission, and one decode kernel
            # a layer a step: paged decode here, dense on the continuous.
            decode = "dense" if kind == "continuous" else "decode"
            others = {"ragged", "decode", "dense"} - {decode}
            check(admits > 0 and steps > 0
                  and counts["flash"] == admits * per
                  and counts[decode] == steps * per
                  and all(counts[k] == 0 for k in others),
                  f"rank {rank}, {kind}: {counts} for {admits} admissions "
                  f"and {steps} steps × {cfg.n_layers} layers")
        ref = spec["ref"][kind]
        plain = ([t[:TP_NEW] for t in ref[0]], [lp[:TP_NEW] for lp in ref[1]])
        report = _compare_greedy(params, cfg, prompts, toks, plain, lps)
        rec[kind] = {"tokens": toks, "wall_s": wall, "counts": counts,
                     "admissions": admits, "decode_steps": steps,
                     "tokens_out": sum(len(t) for t in toks),
                     "forks": report}
        del engine
    rec["served"] = time.time()
    rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if on_card else 0.0)
    print(TP_TAG + json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _tp_degree_two(p5: dict, prompts: list) -> dict:
    """Phase 13 (a): the two children, their records checked against
    each other; returns the per-rank numbers."""
    spec = {"port": _free_port(), "device": DEVICE, "model": TP_MODEL,
            "dtype": TP_DTYPE,
            "prompts": prompts[::2],
            "alt_prompts": prompts[::4],
            "ref": {"ragged": [[t for t in p5["ragged"][0][::2]],
                               [lp for lp in p5["ragged"][1][::2]]],
                    "alternating": [p5["alternating"][0],
                                    p5["alternating"][1]],
                    "continuous": [p5["continuous"][0],
                                   p5["continuous"][1]]}}
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(spec, f)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", TP_CHILD_CODE, f.name, str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for rank in range(TP_DEGREE)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=TP_CHILD_TIMEOUT))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        os.unlink(f.name)
    done = time.time()
    recs = []
    for proc, (out, err) in zip(procs, outs):
        check(proc.returncode == 0, f"tp child exited {proc.returncode}: "
                                    + err[-6000:])
        recs.append(next(json.loads(line[len(TP_TAG):])
                         for line in out.splitlines()
                         if line.startswith(TP_TAG)))
    for kind in ("ragged", "alternating", "continuous"):
        check(recs[0][kind]["tokens"] == recs[1][kind]["tokens"],
              f"{kind}: the two ranks emitted different tokens")
        check(recs[0][kind]["counts"] == recs[1][kind]["counts"],
              f"{kind}: the two ranks launched different counts")
    wall = recs[0]["ragged"]["wall_s"]
    numbers = {
        "seconds": {"spawn": max(r["started"] for r in recs) - t0,
                    "init": max(r["inited"] - r["started"] for r in recs),
                    "serve": max(r["served"] - r["inited"] for r in recs),
                    "total": done - t0},
        "peak_gib": [r["peak_gib"] for r in recs],
        "weights_gib": [r["weights_gib"] for r in recs],
        "wq_shape": recs[0]["wq_shape"],
        "w_down_shape": recs[0]["w_down_shape"],
        "launches": {"ragged": [r["ragged"]["counts"]["ragged"]
                                for r in recs],
                     "flash": [r["alternating"]["counts"]["flash"]
                               for r in recs],
                     "decode": [r["alternating"]["counts"]["decode"]
                                for r in recs],
                     "continuous_flash": [
                         r["continuous"]["counts"]["flash"] for r in recs],
                     "dense": [r["continuous"]["counts"]["dense"]
                               for r in recs]},
        "ragged_steps": recs[0]["ragged"]["decode_steps"],
        "admissions": recs[0]["alternating"]["admissions"],
        "decode_steps": recs[0]["alternating"]["decode_steps"],
        "continuous_admissions": recs[0]["continuous"]["admissions"],
        "continuous_steps": recs[0]["continuous"]["decode_steps"],
        "tokens_per_s": recs[0]["ragged"]["tokens_out"] / wall,
        "alternating_tokens_per_s": (
            recs[0]["alternating"]["tokens_out"]
            / recs[0]["alternating"]["wall_s"]),
        "continuous_tokens_per_s": (
            recs[0]["continuous"]["tokens_out"]
            / recs[0]["continuous"]["wall_s"]),
        "forks": {k: recs[0][k]["forks"]
                  for k in ("ragged", "alternating", "continuous")},
    }
    log(f"  degree {TP_DEGREE} on one card (gloo, both ranks on cuda:0): "
        f"{json.dumps(numbers)}")
    return numbers


# The functions of a sharded forward that call a collective (one
# ``all_reduce`` after wo and after w_down, the embedding's, the head's
# ``all_gather``), timed where the engines call them: ``models/paged.py``
# imports them by name.
TP_COLLECTIVE_CALLS = ("_tp_sum", "_embed", "_lm_head_logits")


@contextlib.contextmanager
def _host_timed(modules, names):
    """Calls and host seconds of each ``<module>.<name>`` while inside, in
    every module of ``modules`` that holds it; yields {name: [calls,
    seconds]}. A call's host seconds are what it costs the host to queue
    its work (and any wait a collective makes it take), not the card's
    time for that work."""
    seen = {name: [0, 0.0] for name in names}
    patched = []

    def timed(name, real):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                seen[name][0] += 1
                seen[name][1] += time.perf_counter() - t0
        return call

    for module in modules:
        for name in names:
            real = getattr(module, name, None)
            if real is not None:
                setattr(module, name, timed(name, real))
                patched.append((module, name, real))
    try:
        yield seen
    finally:
        for module, name, real in patched:
            setattr(module, name, real)


def _tp_degree_one(p5: dict, prompts: list) -> dict:
    """Phase 13 (b): a tp=1 plan over a world-1 NCCL group in this process;
    phase 5's ragged bf16 run again, bit for bit, with the host seconds
    of the functions that call the collectives. (The plan's cost, from a
    rerun with the plan lifted and two traced reruns, is in PERF.md §6.)"""
    cfg = _tp_config(TP_MODEL, TP_DTYPE)
    on_card = torch.device(DEVICE).type == "cuda"
    # NCCL on the card; the CPU rehearsal of this phase has only gloo.
    torch.distributed.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        plan = MeshPlan(make_mesh(tp=1))
        check(plan.tp_group is not None, "a tp=1 plan over a world-1 group "
                                         "has no tp group")
        params = L.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
            plan=plan)
        engine = _tp_engine(params, cfg, plan, True, 64)
        with _host_timed((L, paged_mod), TP_COLLECTIVE_CALLS) as host:
            _sync(DEVICE)
            _zero_counts()
            t0 = time.monotonic()
            toks, lps = _serve(engine, prompts)
            _sync(DEVICE)
            wall = time.monotonic() - t0
            counts = _counts()
        steps = engine.ragged_steps
        check(counts["ragged"] == steps * _launches_a_call(cfg),
              f"tp=1: {counts['ragged']} launches for {steps} steps")
        check(toks == p5["ragged"][0], "tp=1: tokens differ from phase 5's")
        check(lps == p5["ragged"][1], "tp=1: logprobs differ from phase 5's "
                                      "bit for bit")
        numbers = {"backend": torch.distributed.get_backend(),
                   "launches": counts["ragged"], "steps": steps,
                   "wall_s": wall,
                   "tokens_per_s": sum(len(t) for t in toks) / wall,
                   "bit_equal_to_phase_5": True,
                   "host_s": {k: {"calls": n, "seconds": sec,
                                  "ms_a_call": 1e3 * sec / max(n, 1)}
                              for k, (n, sec) in host.items()}}
        del engine
    finally:
        torch.distributed.destroy_process_group()
    log(f"  degree 1 over NCCL: {json.dumps(numbers)}")
    return numbers


def tp_phase(p5: dict) -> dict:
    """Phase 13. ``p5`` holds phase 5's ragged bf16 run of 16 prompts,
    (tokens, logprobs, wall), and its alternating and continuous kernel
    runs of 4, (tokens, logprobs)."""
    cfg = L.LLAMA_CONFIGS[TP_MODEL]
    prompts = _prompts(cfg, 16, 8, 500, SEED)
    kernels = tp_rank_shapes_vs_plain()
    two = _tp_degree_two(p5, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    one = _tp_degree_one(p5, prompts)
    p5_rate = (sum(len(t) for t in p5["ragged"][0]) / p5["ragged"][2])
    return {"kernels": kernels, "degree_2": two, "degree_1": one,
            "phase_5_tokens_per_s": p5_rate}


# ---------------------------------------------------------------------------
# Phase 14: sharded training over torch.distributed

TS_DEGREE = 2
TS_FSDP_MODEL = "gemma-2b"
# (a) and phase 15's sp and pp steps run gemma-2b cut to this many of its
# 18 layers (the depth cut that pays for phase 16; the widths are whole).
TS_FSDP_LAYERS = 6
TS_TP_MODEL = "llama-3-8b"
TS_FSDP_STEPS = 2
TS_TP_STEPS = 2
TS_GLOBAL_BATCH = 2  # (a): one row a rank
# Step 1's loss and global grad norm against the unsharded step's: bf16
# sums in another order (phase 10's gate).
TS_TOL = {"loss_rel": 2e-2, "grad_norm_rel": 2e-2}
# A tp=2 rank's attention at llama-3-8b's training shape: 16 q over 4 kv
# heads, B 1, S 2048, D 128.
TS_RANK_SHAPE = (1, 32 // TS_DEGREE, 8 // TS_DEGREE, TRAIN_SEQ, TRAIN_SEQ,
                 True, 0, 0, None)
TS_CHILD_TIMEOUT = 900.0
TS_TAG = "ts-child "
TS_CHILD_CODE = ("import sys, chip_smoke; "
                 "sys.exit(chip_smoke.ts_child(sys.argv[1:]))")
# The host holds each rank's save snapshot (half the state) and the disk
# the whole state: both must hold this many times the whole state.
TS_HEADROOM = 2.5
# (c): examples/train_sharded over phase 11's 2-layer head-dim-64 model,
# registered under this name for the run.
TS_EXAMPLE_NAME = "smoke-2l-d64"
TS_EXAMPLE_STEPS = 2
# The collectives a sharded step calls, metered in each child.
TS_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter_tensor")
# Phase 10's step-1 loss and global grad norm with the kernels, by config:
# what phase 14 (b) is held to.
STEP_ONE: dict = {}


def ts_rank_shapes_vs_plain() -> dict:
    """Phase 14 (0): one launch each of the flash forward, dQ and dK/dV at
    a tp=2 rank's training shape of llama-3-8b (16 q / 4 kv heads, B 1, S
    2048, D 128), held to their plain versions by phase 3's gates (each
    twice, bit-equal). Returns {"flash": {gate: error}, "dq"|"dk"|"dv":
    {gate: error}}."""
    case = _bwd_case(TS_RANK_SHAPE, 128, seed=1400)
    fwd = {k: case[k] for k in ("q", "k", "v", "causal", "q_offset",
                                "window", "kv_mask")}
    check_fwd_repeat((case["out"], case["lse"]), flash_attention_fwd(**fwd),
                     "ts-rank")
    out = {"flash": {}}
    errs = _flash_errors(case["out"], case["lse"], fwd)
    _gate("ts-rank flash train-2048", errs, out["flash"])
    check(errs["lse"] <= LSE_TOL and errs["keyless_rows_ok"],
          f"ts-rank flash: lse error {errs['lse']} or a keyless row")
    out["flash"]["lse"] = errs["lse"]
    grads = flash_attention_bwd(**case)
    check_bwd_repeat(grads, flash_attention_bwd(**case), "ts-rank")
    berrs = _bwd_errors(grads, case)
    for t in ("dq", "dk", "dv"):
        for gate, limit in BWD_GATES.items():
            err = berrs[t][gate]
            check(math.isfinite(err) and err <= limit,
                  f"ts-rank bwd {t}: {gate} error {err} > {limit}")
        out[t] = berrs[t]
    check(berrs["zeros_ok"], "ts-rank bwd: a zero gradient is not zero")
    log(f"  kernels at a tp={TS_DEGREE} rank's training shape (16 q / 4 kv "
        f"heads, S {TRAIN_SEQ}): {json.dumps(out)}")
    return out


@contextlib.contextmanager
def _collective_meter(names=TS_COLLECTIVES):
    """Calls, bytes and host seconds of the ``torch.distributed``
    collectives ``names`` while inside; yields {"calls", "bytes",
    "seconds"}. An all_reduce moves its tensor's bytes, an all_gather the
    bytes it gathers, a reduce-scatter and an all-to-all their input's, a
    ``batch_isend_irecv`` the bytes it sends. A call's host seconds
    include any wait the collective makes it take."""
    dist = torch.distributed
    seen = {"calls": 0, "bytes": 0, "seconds": 0.0}
    real = {name: getattr(dist, name) for name in names}

    def metered(name):
        def call(*args, **kwargs):
            first = args[0]
            if name == "all_gather":
                nbytes = sum(t.numel() * t.element_size() for t in first)
            elif name in ("reduce_scatter_tensor", "all_to_all_single"):
                nbytes = args[1].numel() * args[1].element_size()
            elif name == "batch_isend_irecv":
                nbytes = sum(op.tensor.numel() * op.tensor.element_size()
                             for op in first if op.op is dist.isend)
            else:
                nbytes = first.numel() * first.element_size()
            t0 = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                seen["calls"] += 1
                seen["bytes"] += nbytes
                seen["seconds"] += time.perf_counter() - t0
        return call

    for name in names:
        setattr(dist, name, metered(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def _ts_print(event: str, **fields) -> None:
    print(TS_TAG + json.dumps({"event": event, **fields}), flush=True)


def _global_mean(value: torch.Tensor, plan) -> float:
    """The mean over the batch axes of a rank's local mean."""
    value = value.detach().clone()
    if plan.batch_group is not None:
        torch.distributed.all_reduce(value, group=plan.batch_group)
    return float(value) / plan.n_batch


def _ts_batches(spec, plan, n: int) -> list:
    """(a): n batches of this rank's rows through ``sharded_loader`` and
    ``device_put_global``; (b): phase 10's batches (the whole global
    batch: tp ranks share it)."""
    if spec["mode"] == "fsdp":
        with sharded_loader(spec["corpus"], TS_GLOBAL_BATCH, spec["seq"],
                            seed=SEED + 3, mesh=plan.mesh) as loader:
            return [device_put_global(loader.next(), plan.mesh,
                                      plan.batch_spec[:2], device=DEVICE)
                    for _ in range(n)]
    with TokenLoader(spec["corpus"], 1, spec["seq"], seed=SEED + 1) as loader:
        return [torch.from_numpy(loader.next()).to(DEVICE) for _ in range(n)]


def ts_child(argv: list) -> int:
    """One rank of phase 14 (a) or (b): joins the gloo group of
    ``TS_DEGREE`` on the spec's device (``cuda:0`` on the card), draws its
    shard of the spec's model from the seed (``init_params(plan=)``),
    shards the AdamW state (``shard_state``) and trains, holding step 1's
    loss and global grad norm to the spec's unsharded reference and every
    step's launches to 2 × n_layers flash, n_layers dQ and n_layers
    dK/dV. (a) then evaluates step 1's batch, saves the state into its
    ``proc<k>/`` root, restores it into a fresh sharded state from another
    seed (every leaf's digest equal) and trains one step more. Prints
    ``ts-child`` records; the last one, "done", carries the numbers."""
    global DEVICE
    spec = json.loads(open(argv[0]).read())
    rank = int(argv[1])
    started = time.time()
    DEVICE = spec["device"]
    on_card = torch.device(DEVICE).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    if on_card:
        torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=TS_DEGREE)
    axes = {"fsdp": TS_DEGREE} if spec["mode"] == "fsdp" else {
        "tp": TS_DEGREE}
    plan = MeshPlan(make_mesh(**axes))
    cfg = _cut_config(spec["model"], spec["dtype"], spec.get("layers"))
    n = cfg.n_layers
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
        plan=plan)
    init_state, step_fn = train_mod.make_train_step(
        cfg, plan, remat="full", loss_chunk=spec["loss_chunk"])
    state = train_mod.shard_state(plan, init_state(params))
    batches = _ts_batches(spec, plan, spec["steps"] + 1)
    _sync(DEVICE)
    state_bytes = _state_nbytes(state)
    inited = time.time()
    rec = {"rank": rank, "mode": spec["mode"], "state_bytes": state_bytes,
           "wq_shape": list(params.layers[0].wq.shape),
           "embed_shape": list(params.embed.shape)}
    del params  # the state holds it; (a)'s restore frees the state
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses, walls, launches, metered = [], [], [], []
    _zero_counts()
    for i, tokens in enumerate(batches[:spec["steps"]]):
        before = _counts()
        _sync(DEVICE)
        with _collective_meter() as seen:
            t0 = time.monotonic()
            loss = step_fn.loss_and_grads(state, tokens)
            if i == 0:
                rec["step1"] = {"loss": float(loss),
                                "grad_norm": float(step_fn.grad_norm(state))}
            step_fn.apply(state)
            _sync(DEVICE)
            walls.append(time.monotonic() - t0)
        losses.append(float(loss))
        metered.append(dict(seen))
        got = _step_counts(before, _counts())
        launches.append({k: got[k] for k in ("flash", "bwd_dq", "bwd_dkv")})
        per = n if on_card else 0
        check(launches[-1] == {"flash": 2 * per, "bwd_dq": per,
                               "bwd_dkv": per},
              f"rank {rank}: step {i + 1} launched {got}")
        check(got["ragged"] == got["decode"] == got["dense"] == 0,
              f"rank {rank}: the train step launched a serving kernel")
        _ts_print("step", rank=rank, step=i + 1, loss=losses[-1],
                  wall_s=walls[-1])
    ref = spec["ref"]
    for key in ("loss", "grad_norm"):
        rel = abs(rec["step1"][key] - ref[key]) / abs(ref[key])
        rec["step1"][f"{key}_rel"] = rel
        check(rel <= TS_TOL[f"{key}_rel"],
              f"rank {rank}: step 1's {key} {rec['step1'][key]} vs the "
              f"unsharded {ref[key]} (rel {rel:.3e})")
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    rec.update(losses=losses, step_s=walls, launches=launches,
               collectives=metered)
    if spec["mode"] == "fsdp":
        with torch.no_grad():
            after = _global_mean(train_mod.chunked_causal_lm_loss(
                state["params"], cfg, plan.local_batch(batches[0]),
                chunk=spec["loss_chunk"]), plan)
        check(after < losses[0], f"rank {rank}: the loss on step 1's batch "
              f"did not fall: {after} after vs {losses[0]}")
        rec["after_loss"] = after
        rec.update(_ts_checkpoint(spec, plan, cfg, state, init_state,
                                  step_fn, batches[-1], rank))
    rec["trained"] = time.time()
    rec["started"], rec["inited"] = started, inited
    rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                       if on_card else 0.0)
    _ts_print("done", **rec)
    torch.distributed.destroy_process_group()
    return 0


def _ts_checkpoint(spec, plan, cfg, state, init_state, step_fn, tokens,
                   rank) -> dict:
    """(a)'s checkpoint: both ranks save into their ``proc<k>/`` roots,
    each writing all it holds, the state is freed, a fresh sharded state from another seed restores
    the step (every leaf's digest equal to the saved one) and trains one
    step more with a finite loss."""
    step = int(state["step"])
    digests = state_digests(state)
    mgr = CheckpointManager(spec["ckpt_dir"], process_index=rank,
                            process_count=TS_DEGREE)
    _sync(DEVICE)
    t0 = time.monotonic()
    check(mgr.save(step, state, metadata={"start_batch": step}),
          f"rank {rank}: the save of step {step} failed")
    save_s = time.monotonic() - t0
    mgr.close()
    del mgr  # its pending host snapshot with it
    written = sum(
        os.path.getsize(os.path.join(root, name))
        for root, _, names in os.walk(os.path.join(
            spec["ckpt_dir"], f"proc{rank}")) for name in names
        if name.endswith(".bin"))
    # Each rank writes every piece it holds (JAX's per-process rule), so
    # its root alone restores it, under JAX's manager too.
    check(written == _state_nbytes(state),
          f"rank {rank}: wrote {written} bytes of the "
          f"{_state_nbytes(state)} it holds")
    state.clear()
    gc.collect()
    _sync(DEVICE)
    torch.distributed.barrier()  # every root committed before a restore
    fresh = train_mod.shard_state(plan, init_state(L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(RESUME_FRESH_SEED),
        DEVICE, plan=plan)))
    _sync(DEVICE)
    t0 = time.monotonic()
    _, at = CheckpointManager(spec["ckpt_dir"], process_index=rank,
                              process_count=TS_DEGREE).restore_latest(fresh)
    _sync(DEVICE)
    restore_s = time.monotonic() - t0
    check(at == step, f"rank {rank}: restored step {at}, saved {step}")
    restored = state_digests(fresh)
    check(restored == digests, f"rank {rank}: restored leaves differ: "
          f"{[p for p in digests if restored.get(p) != digests[p]][:5]}")
    before = _counts()
    _, loss = step_fn(fresh, tokens)
    got = _step_counts(before, _counts())
    check(math.isfinite(float(loss)),
          f"rank {rank}: the step after the restore: loss {float(loss)}")
    gb = _state_nbytes(fresh) / 1e9
    return {"save_s": save_s, "restore_s": restore_s, "written_gb":
            written / 1e9, "state_gb": gb,
            "save_gb_per_s": written / 1e9 / save_s,
            "restore_gb_per_s": gb / restore_s, "leaves": len(digests),
            "resumed_loss": float(loss),
            "resumed_launches": {k: got[k] for k in ("flash", "bwd_dq",
                                                     "bwd_dkv")}}


def ts_global_batch(corpus: str) -> torch.Tensor:
    """(a)'s global batch: each rank's row from ``sharded_loader``,
    stacked in rank order, on the device."""
    rows = [sharded_loader(corpus, TS_GLOBAL_BATCH, TRAIN_SEQ, seed=SEED + 3,
                           process_id=k, num_processes=TS_DEGREE)
            for k in range(TS_DEGREE)]
    try:
        return torch.from_numpy(np.concatenate(
            [ld.next() for ld in rows])).to(DEVICE)
    finally:
        for ld in rows:
            ld.close()


def _ts_reference(cfg, tokens) -> dict:
    """The unsharded step 1 on the same weights and global batch: its
    loss and global grad norm with the kernels (phase 10's
    ``_loss_and_grads``); the model is freed after."""
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    params.requires_grad_(True)
    loss, norm, _ = _loss_and_grads(params, cfg, tokens, "auto")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"loss": loss, "grad_norm": norm}


def _run_ts_children(spec: dict) -> tuple:
    """Both ranks of (a) or (b) as ``python -c`` children; their "done"
    records, and the seconds from the spawn to the last one's start."""
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(spec, f)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", TS_CHILD_CODE, f.name, str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for rank in range(TS_DEGREE)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=TS_CHILD_TIMEOUT))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        os.unlink(f.name)
    recs = []
    for proc, (out, err) in zip(procs, outs):
        check(proc.returncode == 0, f"{spec['mode']} child exited "
              f"{proc.returncode}: " + err[-6000:])
        done = [json.loads(line[len(TS_TAG):]) for line in out.splitlines()
                if line.startswith(TS_TAG)]
        recs.append(next(r for r in done if r["event"] == "done"))
    return recs, t0


def _ts_part(spec: dict, ref_s: float) -> dict:
    """Spawn (a) or (b), check the ranks against each other and return
    the part's numbers."""
    recs, t0 = _run_ts_children(spec)
    done = time.time()
    for key in ("losses", "launches", "step1"):
        check(recs[0][key] == recs[1][key],
              f"{spec['mode']}: the ranks' {key} differ: {recs[0][key]} vs "
              f"{recs[1][key]}")
    out = {
        "model": spec["model"], "layers": spec.get("layers"),
        "mesh": spec["mode"],
        "seconds": {"reference": ref_s,
                    "spawn": max(r["started"] for r in recs) - t0,
                    "init": max(r["inited"] - r["started"] for r in recs),
                    "train": max(r["trained"] - r["inited"] for r in recs),
                    "total": done - t0},
        "step1": recs[0]["step1"], "reference": spec["ref"],
        "losses": recs[0]["losses"], "launches": recs[0]["launches"],
        "step_s": [r["step_s"] for r in recs],
        "peak_gib": [r["peak_gib"] for r in recs],
        "state_gb": [r["state_bytes"] / 1e9 for r in recs],
        "collective_bytes_per_step": [c["bytes"] for c in
                                      recs[0]["collectives"]],
        "collective_calls_per_step": [c["calls"] for c in
                                      recs[0]["collectives"]],
        "collective_host_s_per_step": [[c["seconds"] for c in
                                        r["collectives"]] for r in recs],
        "wq_shape": recs[0]["wq_shape"], "embed_shape": recs[0]["embed_shape"],
    }
    if spec["mode"] == "fsdp":
        for key in ("save_s", "restore_s", "written_gb", "save_gb_per_s",
                    "restore_gb_per_s", "resumed_loss", "resumed_launches",
                    "after_loss", "leaves"):
            out[key] = [r[key] for r in recs]
        out["seconds"]["checkpoint"] = max(r["save_s"] + r["restore_s"]
                                           for r in recs)
    log(f"  {spec['mode']}={TS_DEGREE} {spec['model']}: "
        f"{json.dumps(out)}")
    return out


def _ts_example(corpus: str) -> dict:
    """(c): ``examples/train_sharded.main`` as one rank over a world-1
    NCCL group (on the CPU rehearsal, gloo): FT_EXAMPLE_CFG, 2 steps with
    ``--ckpt-dir`` and ``--data``, then again to 3 steps, which must
    resume at step 2. Returns the launches of the first run."""
    from kubeflow_tpu_torch.examples import train_sharded as example

    on_card = torch.device(DEVICE).type == "cuda"
    torch.distributed.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    L.LLAMA_CONFIGS[TS_EXAMPLE_NAME] = FT_EXAMPLE_CFG
    tmp = tempfile.mkdtemp(prefix="train-sharded-")
    try:
        flags = ["--config", TS_EXAMPLE_NAME, "--batch", "4", "--seq", "64",
                 "--ckpt-dir", tmp, "--data", corpus,
                 *([] if on_card else ["--device", DEVICE])]
        runs = []
        for steps in (TS_EXAMPLE_STEPS, TS_EXAMPLE_STEPS + 1):
            out = io.StringIO()
            _zero_counts()
            with contextlib.redirect_stdout(out):
                example.main(["--steps", str(steps), *flags])
            runs.append((out.getvalue().splitlines(), _counts()))
        backend = torch.distributed.get_backend()
    finally:
        del L.LLAMA_CONFIGS[TS_EXAMPLE_NAME]
        shutil.rmtree(tmp, ignore_errors=True)
        torch.distributed.destroy_process_group()
    (first, counts), (again, counts2) = runs
    n = FT_EXAMPLE_CFG.n_layers * (TS_EXAMPLE_STEPS if on_card else 0)
    launched = {k: counts[k] for k in ("flash", "bwd_dq", "bwd_dkv")}
    check(launched == {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n},
          f"train_sharded launched {counts}")
    check(f"resumed from step {TS_EXAMPLE_STEPS} (preemption recovery)"
          in again, f"train_sharded did not resume: {again}")
    steps = [x for x in first + again if x.startswith("step ")]
    check(len(steps) == TS_EXAMPLE_STEPS + 1, f"train_sharded: {steps}")
    log(f"  examples/train_sharded over a world-1 {backend} group: "
        f"{steps}; launches {launched}")
    return {"backend": backend, "launches": launched, "steps": steps}


def train_sharded_phase() -> dict:
    """Phase 14: the rank-shape kernels, then (a) fsdp=2 gemma-2b and (b)
    tp=2 llama-3-8b, each as two gloo ranks on the one card after an
    unsharded reference, then (c) examples/train_sharded over a world-1
    NCCL group. Returns the phase's numbers."""
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    kernels = ts_rank_shapes_vs_plain()
    tmp = tempfile.mkdtemp(prefix="ts-")
    try:
        # (a): the disk and the host must hold the state's save.
        layers = min(TS_FSDP_LAYERS,
                     _tp_config(TS_FSDP_MODEL, TP_DTYPE).n_layers)
        cfg = _cut_config(TS_FSDP_MODEL, TP_DTYPE, layers)
        est = 3 * cfg.param_count() * torch.empty(
            (), dtype=cfg.dtype).element_size()
        mem, disk = _mem_available(), shutil.disk_usage(tmp).free
        log(f"  {TS_FSDP_MODEL}: train state ~{est / 1e9:.2f} GB; host "
            f"MemAvailable {mem / 1e9:.2f} GB, free disk {disk / 1e9:.2f} GB "
            f"under {tmp}")
        check(mem >= TS_HEADROOM * est and disk >= TS_HEADROOM * est,
              f"phase 14 needs {TS_HEADROOM}x the state ({est / 1e9:.2f} GB)"
              f" in host memory and on disk: MemAvailable {mem / 1e9:.2f} "
              f"GB, free disk {disk / 1e9:.2f} GB")
        corpus = _train_corpus(tmp, cfg.vocab_size)
        t0 = time.monotonic()
        tokens = ts_global_batch(corpus)
        ref = _ts_reference(cfg, tokens)
        # Phase 15 (a) and (b) are held to this step 1 on this batch.
        SP_REFERENCE.update(model=TS_FSDP_MODEL, layers=layers,
                            tokens=tokens.cpu(), ref=ref)
        del tokens
        base = {"port": 0, "device": DEVICE, "dtype": TP_DTYPE,
                "corpus": corpus, "loss_chunk": LOSS_CHUNK,
                "seq": TRAIN_SEQ}
        fsdp = _ts_part({**base, "port": _free_port(), "mode": "fsdp",
                         "model": TS_FSDP_MODEL, "layers": layers,
                         "steps": TS_FSDP_STEPS,
                         "ref": ref, "ckpt_dir": os.path.join(tmp, "ckpt")},
                        time.monotonic() - t0)
        shutil.rmtree(os.path.join(tmp, "ckpt"), ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        # (b): phase 10's llama-3-8b step 1, recorded there.
        tcfg = _tp_config(TS_TP_MODEL, TP_DTYPE)
        tp = _ts_part({**base, "port": _free_port(), "mode": "tp",
                       "model": TS_TP_MODEL, "steps": TS_TP_STEPS,
                       "ref": STEP_ONE[tcfg]}, 0.0)
        example = _ts_example(corpus)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers = {"kernels": kernels, "fsdp": fsdp, "tp": tp,
               "example": example,
               "seconds": time.monotonic() - t_phase}
    return numbers


# ---------------------------------------------------------------------------
# Phase 15: sequence, pipeline and expert parallelism

SPP_DEGREE = 2
SPP_IMPLS = ("ring", "ulysses", "zigzag")
SPP_N_MICRO = 2
SPP_MOE_MODEL = "mixtral-8x7b"
SPP_MOE_LAYERS = 2  # of mixtral-8x7b's 32: the depth cut
SPP_MOE_BATCH = (1, TRAIN_SEQ)
SPP_SERVE_NEW = 32  # new tokens a request (phase 5's first 32)
# Step 1's loss and global grad norm against the unsharded step's: bf16
# sums in another order (phase 10's gate).
SPP_TOL = {"loss_rel": 2e-2, "grad_norm_rel": 2e-2}
# An Ulysses rank's attention at gemma-2b's training shape under sp=2:
# B 2, half of the 8 q heads after the K/V broadcast (4 q / 4 kv heads,
# group 1), the whole S 2048, D 256.
SPP_RANK_SHAPE = (2, 4, 4, TRAIN_SEQ, TRAIN_SEQ, True, 0, 0, None)
SPP_RANK_D = 256
SPP_CHILD_TIMEOUT = 900.0
SPP_TAG = "spp-child "
SPP_CHILD_CODE = ("import sys, chip_smoke; "
                  "sys.exit(chip_smoke.spp_child(sys.argv[1:]))")
# The collectives a step of phase 15 calls, metered in each child: phase
# 14's and the ring's, the pipeline's and Ulysses' transfers.
SPP_COLLECTIVES = TS_COLLECTIVES + ("batch_isend_irecv", "all_to_all_single")
SPP_PARTS = ("sp", "pp", "ep", "serve")
# Phase 14 (a)'s model, global batch and unsharded step 1 (loss, global
# grad norm), recorded there: what phase 15 (a) and (b) are held to.
SP_REFERENCE: dict = {}


def spp_rank_shapes_vs_plain() -> dict:
    """Phase 15 (0): one launch each of the flash forward, dQ and dK/dV at
    an Ulysses rank's training shape of gemma-2b under sp=2 (B 2, 4 q / 4
    kv heads after the broadcast, S 2048, D 256), held to their plain
    versions by phase 3's gates (each twice, bit-equal)."""
    case = _bwd_case(SPP_RANK_SHAPE, SPP_RANK_D, seed=1500)
    fwd = {k: case[k] for k in ("q", "k", "v", "causal", "q_offset",
                                "window", "kv_mask")}
    check_fwd_repeat((case["out"], case["lse"]), flash_attention_fwd(**fwd),
                     "spp-rank")
    out = {"flash": {}}
    errs = _flash_errors(case["out"], case["lse"], fwd)
    _gate("spp-rank flash", errs, out["flash"])
    check(errs["lse"] <= LSE_TOL and errs["keyless_rows_ok"],
          f"spp-rank flash: lse error {errs['lse']} or a keyless row")
    out["flash"]["lse"] = errs["lse"]
    grads = flash_attention_bwd(**case)
    check_bwd_repeat(grads, flash_attention_bwd(**case), "spp-rank")
    berrs = _bwd_errors(grads, case)
    for t in ("dq", "dk", "dv"):
        for gate, limit in BWD_GATES.items():
            err = berrs[t][gate]
            check(math.isfinite(err) and err <= limit,
                  f"spp-rank bwd {t}: {gate} error {err} > {limit}")
        out[t] = berrs[t]
    check(berrs["zeros_ok"], "spp-rank bwd: a zero gradient is not zero")
    log(f"  kernels at an Ulysses rank's shape (B 2, 4 q / 4 kv heads, S "
        f"{SPP_RANK_SHAPE[3]}, D {SPP_RANK_D}): {json.dumps(out)}")
    return out


def _spp_print(event: str, **fields) -> None:
    print(SPP_TAG + json.dumps({"event": event, **fields}), flush=True)


def _moe_config(name: str, layers: int, dtype):
    cfg = dataclasses.replace(moe_mod.MOE_CONFIGS[name], n_layers=layers)
    return cfg if dtype is None else dataclasses.replace(
        cfg, dtype=getattr(torch, dtype))


def _metered(fn):
    """``fn()`` with its wall, kernel launches, collectives (calls, bytes,
    host seconds) and the port's own host staging of them:
    (result, {"wall_s", "launches", "collectives", "staged"}, all counts)."""
    before, staged = _counts(), dict(collectives_mod.HOST_STAGING)
    _sync(DEVICE)
    with _collective_meter(SPP_COLLECTIVES) as seen:
        t0 = time.monotonic()
        out = fn()
        _sync(DEVICE)
        wall = time.monotonic() - t0
    got = _step_counts(before, _counts())
    return out, {
        "wall_s": wall,
        "launches": {k: got[k] for k in ("flash", "bwd_dq", "bwd_dkv")},
        "collectives": dict(seen),
        "staged": {k: collectives_mod.HOST_STAGING[k] - staged[k]
                   for k in staged}}, got


def _check_launches(got: dict, want: dict, what: str) -> None:
    check({k: got[k] for k in want} == want
          and got["ragged"] == got["decode"] == got["dense"] == 0,
          f"{what} launched {got}, want {want}")


def _check_step_one(rec: dict, ref: dict, what: str) -> None:
    for key in ("loss", "grad_norm"):
        rel = abs(rec[key] - ref[key]) / abs(ref[key])
        rec[f"{key}_rel"] = rel
        check(rel <= SPP_TOL[f"{key}_rel"],
              f"{what}: step 1's {key} {rec[key]} vs the unsharded "
              f"{ref[key]} (rel {rel:.3e})")


def _spp_sp(spec: dict, rank: int) -> dict:
    """(a): the whole state a rank, this rank's 1024 of the 2048 positions
    of phase 14 (a)'s batch; step 1 under each sp_impl (Ulysses through
    the flash kernels, ring and zigzag plain, as JAX's)."""
    plan = MeshPlan(make_mesh(sp=SPP_DEGREE))
    cfg = _cut_config(spec["sp_model"], spec["dtype"], spec["sp_layers"])
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    tokens = torch.tensor(spec["sp_tokens"], device=DEVICE)
    per = cfg.n_layers if torch.device(DEVICE).type == "cuda" else 0
    out, state = {}, None
    for impl in SPP_IMPLS:
        init_state, step_fn = train_mod.make_train_step(
            cfg, plan, sp_impl=impl, remat="full",
            loss_chunk=spec["loss_chunk"])
        if state is None:
            state = train_mod.shard_state(plan, init_state(params))
        (loss, norm), rec, got = _metered(lambda: (
            step_fn.loss_and_grads(state, tokens), step_fn.grad_norm(state)))
        n = per if impl == "ulysses" else 0
        _check_launches(got, {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n},
                        f"rank {rank} sp {impl}")
        rec.update(loss=float(loss), grad_norm=float(norm))
        _check_step_one(rec, spec["sp_ref"], f"rank {rank} sp {impl}")
        out[impl] = rec
    return {"impls": out, "local_seq": tokens.shape[1] // SPP_DEGREE}


def _spp_pp(spec: dict, rank: int) -> dict:
    """(b): the same model and batch at pp=2, this rank's half of the
    layers, n_micro 2, remat "full"; step 1's loss and grad norm."""
    plan = MeshPlan(make_mesh(pp=SPP_DEGREE))
    cfg = _cut_config(spec["sp_model"], spec["dtype"], spec["sp_layers"])
    params = pipeline_mod.shard_pipeline_params(L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE), plan)
    tokens = torch.tensor(spec["sp_tokens"], device=DEVICE)
    init_state, step_fn = pipeline_mod.make_pipeline_train_step(
        cfg, plan, SPP_N_MICRO, remat="full")
    state = init_state(params)
    (loss, norm), rec, got = _metered(lambda: (
        step_fn.loss_and_grads(state, tokens), step_fn.grad_norm(state)))
    # Each of the rank's layers runs once a microbatch, twice with the
    # remat recompute; bubbles are skipped.
    n = (len(params.layers) * SPP_N_MICRO
         if torch.device(DEVICE).type == "cuda" else 0)
    _check_launches(got, {"flash": 2 * n, "bwd_dq": n, "bwd_dkv": n},
                    f"rank {rank} pp")
    rec.update(loss=float(loss), grad_norm=float(norm),
               stage=list(params.stage), stage_layers=len(params.layers))
    _check_step_one(rec, spec["sp_ref"], f"rank {rank} pp")
    return rec


def _spp_ep(spec: dict, rank: int) -> dict:
    """(c): the MoE model at ep=2, this rank's half of the experts drawn
    from the seed; step 1's loss (aux included) and grad norm."""
    plan = MeshPlan(make_mesh(ep=SPP_DEGREE))
    cfg = _moe_config(spec["moe_model"], spec["moe_layers"], spec["dtype"])
    params = moe_mod.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
        plan=plan)
    init_state, step_fn, shard = moe_mod.make_moe_train_step(cfg, plan)
    state = shard(init_state(params))
    tokens = torch.tensor(spec["moe_tokens"], device=DEVICE)
    (loss, norm), rec, got = _metered(lambda: (
        step_fn.loss_and_grads(state, tokens), step_fn.grad_norm(state)))
    n = cfg.n_layers if torch.device(DEVICE).type == "cuda" else 0
    _check_launches(got, {"flash": n, "bwd_dq": n, "bwd_dkv": n},
                    f"rank {rank} ep")
    rec.update(loss=float(loss), grad_norm=float(norm),
               experts=params.layers[0].w_gate.shape[0],
               state_gb=_state_nbytes(state) / 1e9)
    _check_step_one(rec, spec["moe_ref"], f"rank {rank} ep")
    return rec


def _spp_serve(spec: dict, rank: int) -> dict:
    """(d): the continuous engine at sp=2 over phase 5's cache and bucket,
    the whole weights a rank from the seed, this rank's 512 of every
    slot's 1024 positions; phase 5's continuous prompts, their tokens held
    to phase 5's by the near-tie rule."""
    plan = MeshPlan(make_mesh(sp=SPP_DEGREE))
    cfg = _tp_config(spec["serve_model"], spec["dtype"])
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
        plan=plan)
    engine = _cont_engine(params, cfg, plan=plan, max_new=SPP_SERVE_NEW)
    check(engine._attn_kernel == 0, "sp serving: the dense kernel is on")
    cache_shape = list(engine.cache["k"].shape)
    prompts = spec["prompts"]

    def serve():
        with _counting_calls(cont_mod, "_admit_slot", "_cb_step") as calls:
            toks, lps = _serve(engine, prompts)
        return toks, lps, dict(calls)

    (toks, lps, calls), rec, got = _metered(serve)
    per = _launches_a_call(cfg)
    admits, steps = calls["_admit_slot"], calls["_cb_step"]
    check(admits == len(prompts) and steps > 0
          and got["flash"] == admits * per
          and got["ragged"] == got["decode"] == got["dense"] == 0,
          f"rank {rank} sp serving: {got} for {admits} admissions and "
          f"{steps} steps")
    ref = spec["serve_ref"]
    plain = ([t[:SPP_SERVE_NEW] for t in ref[0]],
             [lp[:SPP_SERVE_NEW] for lp in ref[1]])
    rec.update(tokens=toks, forks=_compare_greedy(params, cfg, prompts, toks,
                                                  plain, lps),
               admissions=admits, decode_steps=steps,
               flash_launches=got["flash"], cache_shape=cache_shape,
               tokens_out=sum(len(t) for t in toks))
    return rec


def spp_child(argv: list) -> int:
    """One rank of phase 15: joins the gloo group of ``SPP_DEGREE`` on the
    spec's device (``cuda:0`` on the card) and runs the spec's parts in
    turn, (a) sp training, (b) pp, (c) ep, (d) sp serving, freeing each
    part's memory before the next; prints a ``spp-child`` record a part
    (its numbers, wall and peak memory) and a last one, "done"."""
    global DEVICE
    spec = json.loads(open(argv[0]).read())
    rank = int(argv[1])
    DEVICE = spec["device"]
    on_card = torch.device(DEVICE).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    if on_card:
        torch.cuda.set_device(0)
    started = time.time()
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=SPP_DEGREE)
    parts = {"sp": _spp_sp, "pp": _spp_pp, "ep": _spp_ep,
             "serve": _spp_serve}
    for part in spec["parts"]:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        rec = parts[part](spec, rank)
        gc.collect()
        rec["seconds"] = time.monotonic() - t0
        rec["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if on_card else 0.0)
        if on_card:
            torch.cuda.empty_cache()
        _spp_print(part, rank=rank, **rec)
    _spp_print("done", rank=rank, started=started, ended=time.time())
    torch.distributed.destroy_process_group()
    return 0


def _moe_reference(cfg, tokens) -> dict:
    """(c)'s unsharded step 1 here, on the same weights and batch: its
    loss (aux included) and global grad norm; the model is freed after."""
    params = moe_mod.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    init_state, step_fn, _ = moe_mod.make_moe_train_step(cfg)
    state = init_state(params)
    loss = step_fn.loss_and_grads(state, tokens)
    out = {"loss": float(loss), "grad_norm": float(step_fn.grad_norm(state))}
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _run_spp_children(spec: dict) -> tuple:
    """Both ranks as ``python -c`` children; {part: [each rank's record]}
    and the seconds from the spawn to the last child's end."""
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(spec, f)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SPP_CHILD_CODE, f.name, str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for rank in range(SPP_DEGREE)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=SPP_CHILD_TIMEOUT))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        os.unlink(f.name)
    by_part = {}
    for proc, (out, err) in zip(procs, outs):
        check(proc.returncode == 0, f"spp child exited {proc.returncode}: "
                                    + err[-6000:])
        for line in out.splitlines():
            if line.startswith(SPP_TAG):
                rec = json.loads(line[len(SPP_TAG):])
                by_part.setdefault(rec.pop("event"), []).append(rec)
    check(sorted(by_part) == sorted(list(spec["parts"]) + ["done"])
          and all(len(v) == SPP_DEGREE for v in by_part.values()),
          f"spp children's records: {sorted(by_part)}")
    return by_part, time.time() - t0


def _per_rank(recs: list, key: str) -> list:
    return [r[key] for r in sorted(recs, key=lambda r: r["rank"])]


def sp_pp_ep_phase(p5: dict) -> dict:
    """Phase 15. ``p5`` holds phase 5's continuous run of 4 prompts,
    (tokens, logprobs); ``SP_REFERENCE`` phase 14 (a)'s batch and
    unsharded step 1. The rank-shape kernels, (c)'s unsharded reference,
    then two gloo children on the one card for (a)-(d). Returns the
    phase's numbers."""
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    kernels = spp_rank_shapes_vs_plain()
    check(bool(SP_REFERENCE), "phase 14 (a) recorded no reference")
    moe_cfg = _moe_config(SPP_MOE_MODEL, SPP_MOE_LAYERS, TP_DTYPE)
    moe_tokens = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, moe_cfg.vocab_size, SPP_MOE_BATCH)).to(DEVICE)
    t0 = time.monotonic()
    moe_ref = _moe_reference(moe_cfg, moe_tokens)
    moe_ref_s = time.monotonic() - t0
    serve_cfg = _tp_config(TP_MODEL, TP_DTYPE)
    spec = {"port": _free_port(), "device": DEVICE, "dtype": TP_DTYPE,
            "parts": list(SPP_PARTS), "loss_chunk": LOSS_CHUNK,
            "sp_model": SP_REFERENCE["model"],
            "sp_layers": SP_REFERENCE.get("layers"),
            "sp_tokens": SP_REFERENCE["tokens"].tolist(),
            "sp_ref": SP_REFERENCE["ref"],
            "moe_model": SPP_MOE_MODEL, "moe_layers": SPP_MOE_LAYERS,
            "moe_tokens": moe_tokens.tolist(), "moe_ref": moe_ref,
            "serve_model": TP_MODEL,
            "prompts": _prompts(serve_cfg, 16, 8, 500, SEED)[::4],
            "serve_ref": [p5["continuous"][0], p5["continuous"][1]]}
    by_part, children_s = _run_spp_children(spec)
    sp, pp, ep, serve = (by_part[k] for k in SPP_PARTS)
    for impl in SPP_IMPLS:
        check(sp[0]["impls"][impl]["loss"] == sp[1]["impls"][impl]["loss"]
              and sp[0]["impls"][impl]["launches"]
              == sp[1]["impls"][impl]["launches"],
              f"sp {impl}: the ranks differ")
    check(pp[0]["loss"] == pp[1]["loss"], "pp: the ranks' losses differ")
    check(ep[0]["loss"] == ep[1]["loss"], "ep: the ranks' losses differ")
    check(serve[0]["tokens"] == serve[1]["tokens"],
          "sp serving: the ranks emitted different tokens")

    def step_numbers(recs):
        return {k: _per_rank(recs, k) for k in (
            "loss", "grad_norm", "loss_rel", "grad_norm_rel", "wall_s",
            "launches", "collectives", "staged")}

    numbers = {
        "kernels": kernels,
        "sp": {"model": SP_REFERENCE["model"],
               "layers": SP_REFERENCE.get("layers"), "reference":
               SP_REFERENCE["ref"], "local_seq": sp[0]["local_seq"],
               "impls": {impl: step_numbers([r["impls"][impl] | {
                   "rank": r["rank"]} for r in sp]) for impl in SPP_IMPLS},
               "peak_gib": _per_rank(sp, "peak_gib"),
               "seconds": _per_rank(sp, "seconds")},
        "pp": {"model": SP_REFERENCE["model"],
               "layers": SP_REFERENCE.get("layers"), "n_micro": SPP_N_MICRO,
               "stage_layers": _per_rank(pp, "stage_layers"),
               **step_numbers(pp), "peak_gib": _per_rank(pp, "peak_gib"),
               "seconds": _per_rank(pp, "seconds")},
        "ep": {"model": SPP_MOE_MODEL, "layers": SPP_MOE_LAYERS,
               "reference": moe_ref, "reference_s": moe_ref_s,
               "experts_per_rank": _per_rank(ep, "experts"),
               "state_gb": _per_rank(ep, "state_gb"), **step_numbers(ep),
               "peak_gib": _per_rank(ep, "peak_gib"),
               "seconds": _per_rank(ep, "seconds")},
        "serve": {"model": TP_MODEL, "cache_shape": serve[0]["cache_shape"],
                  "admissions": serve[0]["admissions"],
                  "decode_steps": serve[0]["decode_steps"],
                  "flash_launches": _per_rank(serve, "flash_launches"),
                  "tokens_per_s": serve[0]["tokens_out"]
                  / serve[0]["wall_s"],
                  "forks": serve[0]["forks"],
                  "wall_s": _per_rank(serve, "wall_s"),
                  "collectives": _per_rank(serve, "collectives"),
                  "staged": _per_rank(serve, "staged"),
                  "peak_gib": _per_rank(serve, "peak_gib"),
                  "seconds": _per_rank(serve, "seconds")},
        "children_s": children_s,
        "seconds": time.monotonic() - t_phase,
    }
    log(f"  sp/pp/ep on one card (gloo, both ranks on cuda:0): "
        f"{json.dumps(numbers)}")
    return numbers


# ---------------------------------------------------------------------------
# Phase 16: the fleet, and serving under a dp or fsdp mesh

FLEET_MODEL = "llama-3-8b"
FLEET_SYSTEM = 256  # the shared system prompt, in tokens
FLEET_NEW = 16  # new tokens a request
FLEET_OTHER = (96, 300)  # the lengths of the two prompts that share none
FLEET_STREAM_NEW = 64  # the streams in flight through the scale-down
FLEET_BLOCK = 16
# Each replica's pool, sized explicitly: 1024 blocks of 16 tokens, 2 GiB
# of llama-3-8b's bf16 KV. A pool sized by HBM fraction would take the
# card from the other replica.
FLEET_FLAGS = ["--paged", "--slots", "4", "--num-blocks", "1024",
               "--block-size", str(FLEET_BLOCK), "--prompt-bucket", "512",
               "--max-new-tokens", "64"]
# The alternating paged engine with the prefix cache (which serve_http
# turns on with the host swap tier; the ragged engine refuses the prefix
# cache, as JAX's does), and the trace ring behind /debug/traces.
FLEET_ENV = {"KUBEFLOW_TPU_KV_SWAP_BYTES": str(256 << 20),
             "KUBEFLOW_TPU_TRACE_RING": "4096"}
FLEET_TIMEOUT = 300.0

MESH_MODEL = "llama-3-8b"
MESH_LAYERS = 4  # of llama-3-8b's 32: the depth cut
MESH_DTYPE = None  # the model's own (bf16); the CPU rehearsal runs float32
MESH_NEW = 4  # new tokens a request
MESH_DEGREE = 2
MESH_AXES = ({"fsdp": MESH_DEGREE}, {"dp": MESH_DEGREE})
MESH_CHILD_TIMEOUT = 600.0
MESH_TAG = "mesh-child "
MESH_CHILD_CODE = ("import sys, chip_smoke; "
                   "sys.exit(chip_smoke.mesh_child(sys.argv[1:]))")


def _fleet_prompts(cfg) -> tuple:
    """(shared, other): four prompts that open with one system prompt of
    FLEET_SYSTEM tokens, and two that share nothing."""
    rng = np.random.default_rng(SEED + 16)
    system = rng.integers(3, cfg.vocab_size, FLEET_SYSTEM).tolist()
    shared = [system + rng.integers(3, cfg.vocab_size, 24 + 8 * i).tolist()
              for i in range(4)]
    other = [rng.integers(3, cfg.vocab_size, n).tolist()
             for n in FLEET_OTHER]
    return shared, other


def _gw_post(gw, body: dict, timeout: float = 300.0) -> tuple:
    """(the gateway's request id, the tokens) of one completion through
    ``gw``, blocking or streamed."""
    req = urllib.request.Request(
        f"http://{gw.host}:{gw.port}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read().decode()
        rid = resp.headers["X-Request-Id"]
    if not body.get("stream"):
        return rid, json.loads(raw)["choices"][0]["tokens"]
    events = [line[len("data: "):] for line in raw.splitlines()
              if line.startswith("data: ")]
    check(events and events[-1] == "[DONE]",
          f"a stream through the gateway did not end with [DONE]: {raw}")
    out = [json.loads(e) for e in events[:-1]]
    check(all("token" in e for e in out), f"stream carried an error: {out}")
    return rid, [e["token"] for e in out]


def _spans_of(exporter, rid: str, name: str) -> list:
    """The spans ``name`` of trace ``rid``, once its root has ended."""
    deadline = time.monotonic() + 30
    while not any(s.trace_id == rid and s.name == "gateway.request"
                  for s in exporter.spans):
        check(time.monotonic() < deadline, f"trace {rid} never ended")
        time.sleep(0.01)
    return [s for s in exporter.spans if s.trace_id == rid and s.name == name]


def _span_of(exporter, rid: str, name: str):
    """The one span ``name`` of trace ``rid``, once it has ended."""
    got = _spans_of(exporter, rid, name)
    check(len(got) == 1, f"trace {rid} holds {len(got)} {name} spans: "
                         f"{[(s.attributes, s.events) for s in got]}")
    return got[0]


class _FleetModel:
    """The replicas' weights in this process, drawn from the seed only
    when a fork must be judged a near-tie (``_compare_greedy``)."""

    def __init__(self, cfg):
        self.cfg, self.params = cfg, None

    def compare(self, prompts, got, want) -> list:
        forks = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                      -1) for g, w in zip(got, want)]
        check(all(len(g) == len(w) or f >= 0
                  for g, w, f in zip(got, want, forks)),
              f"token counts differ without a fork: {got} vs {want}")
        if all(f < 0 for f in forks):
            return [{"fork": -1, "gap": None, "max_logprob_diff": None}
                    for _ in forks]
        if self.params is None:
            self.params = L.init_params(self.cfg, torch.Generator(
                device=DEVICE).manual_seed(SEED), DEVICE)
        return _compare_greedy(self.params, self.cfg, prompts, got,
                               (want, None))


class SmokeProvisioner:
    """The autoscaler's provisioner over this phase's replica processes
    (the duck-typed contract of ``models/autoscaler.py``): no scale-up; a
    drain leaves the replica serving what it holds; it is drained once its
    ``/stats`` shows no active slot and nothing queued; a release sends
    the process SIGTERM, which the server answers with its own drain."""

    def __init__(self, procs: dict):
        self.procs = procs  # endpoint -> (process, output lines)
        self.calls: list = []

    def scale_up(self, tier, now=None):
        self.calls.append(("scale_up", tier))
        return None

    def drain(self, endpoint: str) -> None:
        self.calls.append(("drain", endpoint))

    def drained(self, endpoint: str) -> bool:
        stats = _get_json(int(endpoint.rsplit(":", 1)[1]), "/stats")
        return not (stats.get("active_slots") or stats.get("queued"))

    def release(self, endpoint: str) -> None:
        self.calls.append(("release", endpoint))
        proc, lines = self.procs.pop(endpoint)
        _stop_serve_http(proc, lines)


def _fleet_routes(gw, exporter, rids) -> list:
    return [_span_of(exporter, rid, "gateway.route").attributes.get(
        "endpoint") for rid in rids]


def _fleet_fused(gw, exporter, eps, model, prompts, direct) -> dict:
    """(a) fused: every prompt blocking and streamed through the gateway,
    one at a time, held to the replica served directly; the shared-prefix
    prompts on one replica, whose prefix cache counts the hit; one trace
    from the gateway's root span to the replica's prefill span."""
    before = {ep: _get_json(int(ep.rsplit(":", 1)[1]), "/stats")
              ["prefix_cache"]["hits"] for ep in eps}
    # Every prompt blocking, then every prompt streamed.
    out, rids = {}, {}
    for stream in (False, True):
        for p in prompts:
            rid, toks = _gw_post(gw, {"prompt": p, "max_tokens": FLEET_NEW,
                                      "stream": stream})
            out.setdefault(stream, []).append(toks)
            rids.setdefault(stream, []).append(rid)
    forks = {"blocking": model.compare(prompts, out[False], direct),
             "streamed": model.compare(prompts, out[True], direct)}
    routes = {("streamed" if k else "blocking"): _fleet_routes(gw, exporter, v)
              for k, v in rids.items()}
    # The shared-prefix prompts on their first pass: the first routes by
    # its own chain, every later one by the shared prefix's, onto one
    # replica. (A prompt seen before routes by its own deepest chain.)
    home = set(routes["blocking"][1:4])
    check(len(home) == 1,
          f"the shared-prefix prompts went to {routes['blocking'][:4]}")
    (home,) = home
    after = {ep: _get_json(int(ep.rsplit(":", 1)[1]), "/stats")
             ["prefix_cache"]["hits"] for ep in eps}
    hits = {ep: after[ep] - before[ep] for ep in eps}
    check(hits[home] >= 2 * FLEET_SYSTEM // FLEET_BLOCK,
          f"the shared prefix's replica counted {hits[home]} prefix hits")
    # One trace: gateway.request -> gateway.route -> (traceparent) the
    # replica's server.request -> prefill.
    rid = rids[False][2]
    root = _span_of(exporter, rid, "gateway.request")
    route = _span_of(exporter, rid, "gateway.route")
    check(route.parent_id == root.span_id and root.parent_id in ("", None),
          "gateway.route is not a child of the root gateway.request")
    port = int(routes["blocking"][2].rsplit(":", 1)[1])
    deadline = time.monotonic() + 60
    while True:
        mine = {t["name"]: t for t in _get_json(port, "/debug/traces")
                ["traces"] if t["trace_id"] == rid}
        if "server.request" in mine or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    check("server.request" in mine and "prefill" in mine,
          f"the replica's trace {rid} holds {sorted(mine)}")
    check(mine["server.request"]["parent_id"] == route.span_id
          and mine["prefill"]["parent_id"]
          == mine["server.request"]["span_id"],
          "the replica's spans do not hang off the gateway's route")
    return {"tokens": out[False] + out[True], "streams": out[True],
            "forks": forks, "routes": routes,
            "prefix_hits": hits, "home": home,
            "trace": [root.name, route.name, "server.request", "prefill"]}


def _fleet_disagg(eps, exporter, model, prompts, fused_streams) -> dict:
    """(a) disagg: the first replica the prefill tier, the second the
    decode tier; each prompt streamed, its tokens held to the fused
    route's; the handoff's bytes and seconds."""
    gw = gateway_mod.ServingGateway(
        eps, port=0, block_size=FLEET_BLOCK, health_interval_s=0.5,
        tier_mode="disagg",
        tier_roles={eps[0]: "prefill", eps[1]: "decode"}).start()
    try:
        got, per = [], []
        for p in prompts:
            before = gw.stats()
            rid, toks = _gw_post(gw, {"prompt": p, "max_tokens": FLEET_NEW,
                                      "stream": True})
            got.append(toks)
            after = gw.stats()
            per.append({"bytes": after["kv_transfer_bytes"]
                        - before["kv_transfer_bytes"],
                        "seconds": after["kv_transfer_latency_s"],
                        "prompt_tokens": len(p),
                        "fallbacks": [
                            e.get("attributes")
                            for route in _spans_of(exporter, rid,
                                                   "gateway.route")
                            for e in route.events
                            if e["name"] == "disagg_fallback"]})
        stats = gw.stats()
    finally:
        gw.stop()
    check(stats["kv_transfers"] == len(prompts)
          and stats["kv_transfer_failures"] == 0,
          f"disagg handoffs: {stats['kv_transfers']} of {len(prompts)}, "
          f"{stats['kv_transfer_failures']} failed: {per}")
    forks = model.compare(prompts, got, fused_streams)
    return {"forks": forks, "handoffs": per,
            "kv_transfer_bytes": stats["kv_transfer_bytes"]}


def _fleet_scale_down(eps, procs, exporter, cfg) -> dict:
    """(a) scale-down: a stream through each replica, then one
    ``FleetAutoscaler`` decision drains the least-loaded replica through
    ``SmokeProvisioner``: it leaves the ring at once, a request sent then
    lands on the other, the stream on it runs to its end, and it is
    released (SIGTERM) once idle."""
    provisioner = SmokeProvisioner(procs)
    gw = gateway_mod.ServingGateway(
        eps, port=0, block_size=FLEET_BLOCK, health_interval_s=3600.0,
        telemetry=FleetTelemetry(),
        autoscaler_config=AutoscalerConfig(
            min_replicas=1, max_replicas=2, down_consecutive=2,
            down_cooldown_s=0.0, stale_after_s=120.0, drain_budget_s=120.0),
        autoscaler_provisioner=provisioner).start()
    try:
        # One prompt routed to each replica, found on the gateway's ring.
        rng = np.random.default_rng(SEED + 17)
        placed = {}
        for _ in range(64):
            p = rng.integers(3, cfg.vocab_size, 64).tolist()
            placed.setdefault(gw._candidates(gw._route_key(p))[0], p)
            if len(placed) == len(eps):
                break
        check(set(placed) == set(eps), f"no prompt routes to each of {eps}")
        streams = {}

        def stream(ep):
            streams[ep] = _gw_post(gw, {"prompt": placed[ep], "stream": True,
                                        "max_tokens": FLEET_STREAM_NEW})[1]

        threads = [threading.Thread(target=stream, args=(ep,), daemon=True)
                   for ep in eps]
        # The first tick, before the streams: the ebb's first quiet tick,
        # so that the one after them decides.
        gw.probe_once()
        t_streams = time.monotonic()
        for t in threads:
            t.start()
        deadline = time.monotonic() + FLEET_TIMEOUT
        while sum(gw.stats()["inflight"].values()) < len(eps):
            check(time.monotonic() < deadline, "the streams never started")
            time.sleep(0.01)
        decisions, victim, during = [], None, None
        while victim is None or victim in provisioner.procs:
            check(time.monotonic() < deadline,
                  f"no scale-down and release: {decisions}")
            gw.probe_once()
            new = [d for d in gw.autoscaler.debug()["decisions"]
                   if d not in decisions]
            decisions += new
            for d in new:
                if d["action"] == "scale_down":
                    victim = d["endpoint"]
                    check(victim not in gw.ring_nodes(),
                          "the drained replica is still in the ring")
                    check(victim in {ep for ep, t in zip(eps, threads)
                                     if t.is_alive()},
                          f"the drained replica carried no stream "
                          f"{time.monotonic() - t_streams:.3f} s after "
                          f"the streams started: {decisions}")
                    # A request sent now routes to the other replica.
                    rid, _ = _gw_post(gw, {"prompt": placed[victim],
                                           "max_tokens": 2})
                    during = gw.stats()["replicas"]
                    during["routed_to"] = _span_of(
                        exporter, rid, "gateway.route").attributes.get(
                            "endpoint")
            if victim is not None:
                time.sleep(0.1)  # the drain: poll until it is released
        for t in threads:
            t.join(FLEET_TIMEOUT)
        check(all(len(streams.get(ep, ())) == FLEET_STREAM_NEW
                  or SERVE_EOS in streams.get(ep, ()) for ep in eps),
              f"a stream was cut: {[len(s) for s in streams.values()]}")
        check([d["action"] for d in decisions
               if d["action"] in ("scale_down", "release")]
              == ["scale_down", "release"],
              f"the autoscaler decided {decisions}")
        check(provisioner.calls == [("drain", victim), ("release", victim)],
              f"the provisioner was called {provisioner.calls}")
        survivor = next(ep for ep in eps if ep != victim)
        check(gw.ring_nodes() == frozenset({survivor})
              and victim not in gw.stats()["replicas"],
              f"the ring after the release: {sorted(gw.ring_nodes())}")
        check(during is not None and during[survivor]["in_ring"]
              and not during[victim]["in_ring"]
              and during["routed_to"] == survivor,
              f"replicas while draining: {during}")
    finally:
        gw.stop()
    return {"victim": victim, "survivor": survivor,
            "decisions": [{k: d[k] for k in ("action", "endpoint", "reasons")
                           if k in d} for d in decisions],
            "stream_tokens": {ep: len(s) for ep, s in streams.items()}}


def fleet_part(card: str) -> dict:
    """Phase 16 (a): two ``serve_http`` replicas of the model, the port's
    ``ServingGateway`` in front of them in this process."""
    cfg = _tp_config(FLEET_MODEL, None)
    shared, other = _fleet_prompts(cfg)
    prompts = shared + other
    source = ["--config", FLEET_MODEL, "--seed", str(SEED)]
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        started = list(pool.map(
            lambda _: _start_serve_http(source, FLEET_FLAGS, FLEET_ENV),
            range(2)))
    procs = {f"127.0.0.1:{port}": (proc, lines)
             for proc, port, lines, _ in started}
    eps = sorted(procs)
    up_s = time.monotonic() - t0
    exporter = tracing_mod.InMemoryExporter()
    tracing_mod.set_tracer_provider(tracing_mod.TracerProvider(exporter))
    model = _FleetModel(cfg)
    try:
        # The reference: each prompt sent to the first replica directly.
        direct = [_post(int(eps[0].rsplit(":", 1)[1]),
                        {"prompt": p, "max_tokens": FLEET_NEW})
                  for p in prompts]
        gw = gateway_mod.ServingGateway(
            eps, port=0, block_size=FLEET_BLOCK,
            health_interval_s=0.5).start()
        try:
            t1 = time.monotonic()
            fused = _fleet_fused(gw, exporter, eps, model, prompts, direct)
            fused_s = time.monotonic() - t1
        finally:
            gw.stop()
        t1 = time.monotonic()
        disagg = _fleet_disagg(eps, exporter, model, prompts,
                               fused["streams"])
        disagg_s = time.monotonic() - t1
        t1 = time.monotonic()
        down = _fleet_scale_down(eps, procs, exporter, cfg)
        down_s = time.monotonic() - t1
        # The survivor's engine steps (its flight recorder's): each
        # admission ran the flash kernel and each decode step the paged
        # decode kernel once a layer, in its own process, where no count
        # of ours reaches.
        fused["survivor_steps"] = {
            ep: _get_json(int(ep.rsplit(":", 1)[1]), "/stats")["flight"]
            ["steps"] for ep in procs}
    finally:
        tracing_mod.set_tracer_provider(tracing_mod.TracerProvider())
        for proc, lines in procs.values():
            _stop_serve_http(proc, lines)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    numbers = {"replicas_up_s": up_s,
               "healthz_s": [s for _, _, _, s in started],
               "fused": {k: fused[k] for k in ("forks", "routes",
                                                "prefix_hits", "home",
                                                "trace",
                                                "survivor_steps")},
               "disagg": disagg, "scale_down": down,
               "seconds": {"fused": fused_s, "disagg": disagg_s,
                           "scale_down": down_s}}
    log(f"  fleet on {card}: {json.dumps(numbers)}")
    return numbers


def _mesh_config(spec: dict):
    return _cut_config(spec["model"], spec["dtype"], spec["layers"])


def mesh_child(argv: list) -> int:
    """One rank of phase 16 (b): joins the gloo group of ``MESH_DEGREE``
    on the spec's device (``cuda:0`` on the card) and, under each of the
    spec's meshes in turn, draws its shard of the cut model from the seed
    (``init_params(plan=)``: half of each leaf fsdp cuts, everything at
    dp), serves the ragged and the alternating engine with ``plan=`` (the
    step replicated over the mesh, as JAX's), holds their tokens to the
    unsharded engines' by the near-tie rule and their launches to the
    steps, and prints one ``mesh-child {json}`` record."""
    global DEVICE
    spec = json.loads(open(argv[0]).read())
    rank = int(argv[1])
    started = time.time()
    DEVICE = spec["device"]
    on_card = torch.device(DEVICE).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    if on_card:
        torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=MESH_DEGREE)
    cfg = _mesh_config(spec)
    per = _launches_a_call(cfg)
    rec = {"rank": rank, "started": started}
    for axes in spec["meshes"]:
        tag = "x".join(f"{k}{v}" for k, v in axes.items())
        plan = MeshPlan(make_mesh(**axes))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        params = L.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE,
            plan=plan)
        _sync(DEVICE)
        out = {"weight_bytes": sum(p.numel() * p.element_size()
                                   for p in params.parameters()),
               "embed_shape": list(params.embed.shape),
               "wq_shape": list(params.layers[0].wq.shape)}
        for kind in ("ragged", "alternating"):
            engine = _tp_engine(params, cfg, plan, kind == "ragged",
                                spec["new"])
            check(engine.mesh_axes == axes,
                  f"{tag} {kind}: /stats mesh {engine.mesh_axes}")
            check(engine.pool["k"].shape[2] == cfg.n_kv_heads,
                  f"{tag} {kind}: the pool is cut over dp or fsdp")
            with _counting_calls(paged_mod, "_paged_admit",
                                 "_paged_step") as calls, \
                    _collective_meter(("all_gather", "all_reduce")) as seen:
                _sync(DEVICE)
                _zero_counts()
                t0 = time.monotonic()
                toks, lps = _serve(engine, spec["prompts"])
                _sync(DEVICE)
                wall = time.monotonic() - t0
                counts = _counts()
            if kind == "ragged":
                forwards = engine.ragged_steps
                check(forwards > 0 and counts["ragged"] == forwards * per
                      and counts["flash"] == counts["decode"] == 0,
                      f"rank {rank}, {tag} ragged: {counts} for {forwards} "
                      f"steps × {cfg.n_layers} layers")
            else:
                admits, steps = calls["_paged_admit"], calls["_paged_step"]
                forwards = admits + steps
                check(admits > 0 and steps > 0
                      and counts["flash"] == admits * per
                      and counts["decode"] == steps * per
                      and counts["ragged"] == 0,
                      f"rank {rank}, {tag} alternating: {counts} for "
                      f"{admits} admissions and {steps} steps × "
                      f"{cfg.n_layers} layers")
            report = _compare_greedy(params, cfg, spec["prompts"], toks,
                                     spec["ref"][kind], lps)
            out[kind] = {"tokens": toks, "forks": report, "wall_s": wall,
                         "forwards": forwards,
                         "step_s": wall / forwards,
                         "gathered_bytes_per_step": seen["bytes"] / forwards,
                         "collective_calls_per_step":
                             seen["calls"] / forwards,
                         "collective_host_s_per_step":
                             seen["seconds"] / forwards,
                         "launches": {k: counts[k] for k in
                                      ("ragged", "flash", "decode")}}
            del engine
        out["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if on_card else 0.0)
        rec[tag] = out
        del params
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    rec["served"] = time.time()
    print(MESH_TAG + json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def mesh_part() -> dict:
    """Phase 16 (b): the unsharded engines on the cut model in this
    process, then the two children under each mesh."""
    spec = {"port": _free_port(), "device": DEVICE, "model": MESH_MODEL,
            "layers": MESH_LAYERS, "dtype": MESH_DTYPE, "new": MESH_NEW,
            "meshes": list(MESH_AXES)}
    cfg = _mesh_config(spec)
    prompts = _prompts(cfg, 16, 8, 500, SEED)[::8]
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    ref = {}
    for kind in ("ragged", "alternating"):
        ref[kind] = _serve(_tp_engine(params, cfg, None, kind == "ragged",
                                      MESH_NEW), prompts)
    whole_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    spec.update(prompts=prompts, ref=ref)
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(spec, f)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_CHILD_CODE, f.name, str(rank)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
        for rank in range(MESH_DEGREE)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=MESH_CHILD_TIMEOUT))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        os.unlink(f.name)
    done = time.time()
    recs = []
    for proc, (out, err) in zip(procs, outs):
        check(proc.returncode == 0, f"mesh child exited {proc.returncode}: "
                                    + err[-6000:])
        recs.append(next(json.loads(line[len(MESH_TAG):])
                         for line in out.splitlines()
                         if line.startswith(MESH_TAG)))
    numbers = {"model": MESH_MODEL, "layers": MESH_LAYERS,
               "whole_weight_bytes": whole_bytes,
               "seconds": {"total": done - t0,
                           "spawn": max(r["started"] for r in recs) - t0}}
    for axes in MESH_AXES:
        tag = "x".join(f"{k}{v}" for k, v in axes.items())
        for kind in ("ragged", "alternating"):
            check(recs[0][tag][kind]["tokens"] == recs[1][tag][kind]["tokens"],
                  f"{tag} {kind}: the two ranks emitted different tokens")
            check(recs[0][tag][kind]["launches"]
                  == recs[1][tag][kind]["launches"],
                  f"{tag} {kind}: the two ranks launched different counts")
        want = whole_bytes if "dp" in axes else None
        for r in recs:
            if want is not None:
                check(r[tag]["weight_bytes"] == want,
                      f"{tag}: a rank holds {r[tag]['weight_bytes']} bytes "
                      f"of weights, the model {want}")
            else:
                check(r[tag]["weight_bytes"] < 0.55 * whole_bytes,
                      f"{tag}: a rank holds {r[tag]['weight_bytes']} bytes "
                      f"of weights, the model {whole_bytes}")
        numbers[tag] = {
            "weight_bytes": [r[tag]["weight_bytes"] for r in recs],
            "peak_gib": [r[tag]["peak_gib"] for r in recs],
            "embed_shape": recs[0][tag]["embed_shape"],
            "wq_shape": recs[0][tag]["wq_shape"],
            **{kind: {k: recs[0][tag][kind][k] for k in (
                "forks", "wall_s", "forwards", "step_s",
                "gathered_bytes_per_step", "collective_calls_per_step",
                "launches")} | {"collective_host_s_per_step": [
                    r[tag][kind]["collective_host_s_per_step"]
                    for r in recs]}
               for kind in ("ragged", "alternating")}}
    log(f"  dp and fsdp at degree {MESH_DEGREE} on one card (gloo, both "
        f"ranks on cuda:0), {MESH_MODEL} at {MESH_LAYERS} layers: "
        f"{json.dumps(numbers)}")
    return numbers


def fleet_mesh_phase(card: str) -> dict:
    """Phase 16: (a) the fleet, then (b) dp and fsdp."""
    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    fleet = fleet_part(card)
    t0 = time.monotonic()
    mesh = mesh_part()
    return {"fleet": fleet, "mesh": mesh,
            "seconds": {"fleet": t0 - t_phase,
                        "mesh": time.monotonic() - t0,
                        "total": time.monotonic() - t_phase}}


def main() -> int:
    # One card, the first visible one, set before CUDA starts: the process
    # drives and counts one card however many the host has.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card_id = "0" if visible is None else visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card_id
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    phases = {}

    log("[1/16] card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", card_id, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    phases["card"] = time.monotonic() - t_start

    log("[2/16] build")
    t0 = time.monotonic()
    seconds = _build.build()
    for name, took in seconds.items():
        for line in _build.log_path(name).read_text().splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
        log(f"  {name}: library already built" if took is None
            else f"  {name}: nvcc took {took:.2f} s")
    phases["build"] = time.monotonic() - t0

    log("[3/16] kernel vs plain")
    t0 = time.monotonic()
    errors = kernel_vs_plain()
    flash_errors = flash_vs_plain()
    decode_errors = decode_vs_plain()
    dense_errors = dense_vs_plain()
    bwd_errors = flash_bwd_vs_plain()
    quant_errors = quant_vs_plain()
    phases["kernel_vs_plain"] = time.monotonic() - t0

    log("[4/16] timing at the main-path shapes")
    t0 = time.monotonic()
    times = timing()
    flash_times = timing_flash()
    decode_times = timing_decode()
    dense_times = timing_dense()
    bwd_times = timing_flash_bwd()
    quant_times = timing_quant()
    phases["timing"] = time.monotonic() - t0

    log("[5/16] engines: llama-3-8b, full width and depth, random weights")
    t0 = time.monotonic()
    cfg = L.LLAMA_CONFIGS["llama-3-8b"]
    params = L.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    torch.cuda.synchronize()
    log(f"  init {cfg.param_count() / 1e9:.2f}B params in "
        f"{time.monotonic() - t0:.2f} s")
    runs = {}  # phase 5's plain runs, which phase 8 is held to
    launches, engine = engine_phase(params, cfg, runs)
    alt_launches, alt_engine = alternating_phase(params, cfg, runs)
    cont_launches, cont_engine = continuous_phase(params, cfg, runs)
    quant_rows = quant_engine_phase(params, cfg)
    phases["engine"] = time.monotonic() - t0

    log("[6/16] HTTP")
    t0 = time.monotonic()
    http_tokens = {"ragged": http_phase(engine, "ragged")}
    http_phase(alt_engine, "alternating")
    http_tokens["continuous"] = http_phase(cont_engine, "continuous")
    phases["http"] = time.monotonic() - t0

    log("[7/16] prefix and handoff")
    t0 = time.monotonic()
    prefix = prefix_phase(params, cfg, card)
    phases["prefix"] = time.monotonic() - t0

    log("[8/16] speculation and multi-LoRA")
    t0 = time.monotonic()
    spec = spec_lora_phase(params, cfg, card, runs)
    # Phase 13 holds its tokens to phase 5's.
    p5 = {"ragged": runs[("ragged", 0, 16)],
          "alternating": runs["alternating"],
          "continuous": runs["continuous"]}
    del runs
    phases["spec_lora"] = time.monotonic() - t0

    log("[9/16] checkpoint and observability")
    t0 = time.monotonic()
    # Phases 5-8's engines and pools go first; the served weights stay.
    del engine, alt_engine, cont_engine
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = checkpoint_phase(params, cfg, card, http_tokens)
    phases["checkpoint"] = time.monotonic() - t0

    log(f"[10/16] train: {', '.join(TRAIN_MODELS)}")
    t0 = time.monotonic()
    # The serving model goes first: training needs ~66 GB.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
        "after the serving phases")
    trained = train_phases({name: L.LLAMA_CONFIGS[name]
                            for name in TRAIN_MODELS})
    train_launches = trained["llama-3-8b"]
    phases["train"] = time.monotonic() - t0

    log(f"[11/16] finetune: fp8 products, then {FT_MODEL}'s LoRA finetune "
        "and fp8 training, then examples/finetune_lora")
    t0 = time.monotonic()
    finetune = finetune_phase(card)
    phases["finetune"] = time.monotonic() - t0

    log(f"[12/16] resume: SIGTERM to a child training {RESUME_MODEL} "
        f"({RESUME_LAYERS} layers), then its emergency checkpoint restored "
        "on the card")
    t0 = time.monotonic()
    resume = resume_phase()
    phases["resume"] = time.monotonic() - t0

    log(f"[13/16] tp: degree {TP_DEGREE} on the one card over gloo, then "
        "degree 1 over NCCL")
    t0 = time.monotonic()
    tp = tp_phase(p5)
    phases["tp"] = time.monotonic() - t0

    log(f"[14/16] train_sharded: fsdp={TS_DEGREE} {TS_FSDP_MODEL} "
        f"({TS_FSDP_LAYERS} layers) and "
        f"tp={TS_DEGREE} {TS_TP_MODEL} as gloo ranks on the one card, then "
        "examples/train_sharded over NCCL")
    t0 = time.monotonic()
    sharded = train_sharded_phase()
    phases["train_sharded"] = time.monotonic() - t0

    log(f"[15/16] sp_pp_ep: {SP_REFERENCE['model']} "
        f"({SP_REFERENCE.get('layers')} layers) at sp={SPP_DEGREE} "
        f"(ring, Ulysses, zigzag) and pp={SPP_DEGREE}, {SPP_MOE_MODEL} "
        f"({SPP_MOE_LAYERS} layers) at ep={SPP_DEGREE}, {TP_MODEL} served "
        f"at sp={SPP_DEGREE}, as gloo ranks on the one card")
    t0 = time.monotonic()
    spp = sp_pp_ep_phase(p5)
    phases["sp_pp_ep"] = time.monotonic() - t0

    log(f"[16/16] fleet_mesh: the port's gateway in front of two serve_http "
        f"replicas of {FLEET_MODEL} (fused, disagg, a scale-down), then "
        f"{MESH_MODEL} ({MESH_LAYERS} layers) served at "
        f"{', '.join(f'{k}={v}' for a in MESH_AXES for k, v in a.items())} "
        "as gloo ranks on the one card")
    t0 = time.monotonic()
    fleet_mesh = fleet_mesh_phase(card)
    phases["fleet_mesh"] = time.monotonic() - t0

    def entry(name, source, replaces, launched, errs, timed, **extra):
        return {
            "name": name, **extra, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched,
            "max_abs_err": errs["abs"], "max_rel_err": errs["rel"],
            "max_row_rel_err": errs["row_rel"],
            **{k: timed[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        }

    kernels = [
        entry("ragged_paged_attention",
              "kubeflow_tpu_torch/csrc/ragged_attention.cu",
              "kubeflow_tpu/ops/ragged_attention.py:330", launches[variant],
              errors[variant], times["main-mixed"][variant], variant=variant,
              design=RAGGED_DESIGN,
              library_backend=times["main-mixed"][variant]["library_backend"],
              launches_per_call={k: times[k][variant]["launches_per_call"]
                                 for k in times if variant in times[k]},
              ctas={k: times[k][variant]["ctas"]
                    for k in times if variant in times[k]},
              **{k.replace("-", "_"): {f: times[k][variant][f]
                                       for f in RAGGED_ROW_KEYS}
                 for k in times if k != "main-mixed" and variant in times[k]})
        for variant in ("bf16", "int8")
    ] + [
        entry("flash_attention", "kubeflow_tpu_torch/csrc/flash_attention.cu",
              "kubeflow_tpu/ops/attention.py:301", alt_launches["flash"],
              flash_errors, flash_times["main-prefill"],
              also_replaces="kubeflow_tpu/ops/attention.py:547",
              launches_continuous=cont_launches["flash"],
              launches_train=train_launches["flash"],
              launches_train_gemma_2b=trained["gemma-2b"]["flash"],
              launches_finetune_lora=finetune["lora"]["launches"]["flash"],
              launches_fp8_train=finetune["fp8"]["launches"]["flash"],
              launches_finetune_example=finetune["example"]["flash"],
              launches_resume=resume["launches"]["flash"],
              launches_resume_child={
                  step: got["flash"]
                  for step, got in resume["child_launches"].items()},
              max_lse_err=flash_errors["lse"],
              design=FLASH_DESIGN, ctas=flash_times["main-prefill"]["ctas"],
              **{name.replace("-", "_"): {k: flash_times[name][k] for k in (
                  "ms", "plain_ms", "library_ms", "library_is_causal",
                  "bound_ms", "bound_by", "ctas")}
                 for name, _ in FLASH_TIMED if name != "main-prefill"}),
    ] + [
        entry(name, "kubeflow_tpu_torch/csrc/paged_attention.cu", replaces,
              launched, errs, timed["main-decode"], design=DECODE_DESIGN,
              **{k: timed["main-decode"][k] for k in timed["main-decode"]
                 if k in ("launches_per_call", "library_backend",
                          "dense_on_gathered_ms")},
              ctas={k: timed[k]["ctas"] for k, _, _ in DECODE_TIMED},
              split={k: timed[k]["split"] for k, _, _ in DECODE_TIMED},
              **{k.replace("-", "_"): {f: timed[k][f]
                                       for f in DECODE_ROW_KEYS}
                 for k, _, _ in DECODE_TIMED if k != "main-decode"})
        for name, replaces, launched, errs, timed in (
            ("paged_decode_attention",
             "kubeflow_tpu/ops/paged_attention.py:233",
             alt_launches["decode"], decode_errors, decode_times),
            ("dense_decode_attention",
             "kubeflow_tpu/ops/paged_attention.py:298",
             cont_launches["dense"], dense_errors, dense_times))
    ] + [
        {"name": name, "route": "cuda",
         "source": "kubeflow_tpu_torch/csrc/flash_attention_bwd.cu",
         "replaces": replaces, "launches": train_launches[count],
         "launches_gemma_2b": trained["gemma-2b"][count],
         "launches_finetune_lora": finetune["lora"]["launches"][count],
         "launches_fp8_train": finetune["fp8"]["launches"][count],
         "launches_finetune_example": finetune["example"][count],
         "launches_resume": resume["launches"][count],
         "launches_resume_child": {
             step: got[count]
             for step, got in resume["child_launches"].items()},
         "max_abs_err": max(bwd_errors[t]["abs"] for t in grads),
         **{f"max_{gate}_err": max(bwd_errors[t][gate] for t in grads)
            for gate in BWD_GATES},
         **{k: bwd_times["train-2048"][key][k] for k in BWD_ROW_KEYS},
         "gemma_2b_2048": {k: bwd_times["gemma-2b-2048"][key][k]
                           for k in BWD_ROW_KEYS},
         "head_dims": [64, 128, 256],
         "plain_and_library_cover": "dq, dk and dv in one call", **extra}
        for name, replaces, count, key, grads, extra in (
            ("flash_attention_bwd_dq", "kubeflow_tpu/ops/attention.py:772",
             "bwd_dq", "dq", ("dq",), {"design": BWD_DQ_DESIGN}),
            ("flash_attention_bwd_dkv", "kubeflow_tpu/ops/attention.py:841",
             "bwd_dkv", "dkv", ("dk", "dv"), {
                 "design": BWD_DKV_DESIGN,
                 "group_sum": "flash_bwd_group_sum_kernel: the G q-head "
                              "shares of each kv head added in the order "
                              "g = 0..G-1; dk, dv bit-equal on repeats",
                 "group_sum_ctas":
                     bwd_times["train-2048"]["dkv"]["group_sum_ctas"]}))
    ]
    kernels.append({
        "name": "quant_matmul", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "kubeflow_tpu/models/llama.py:191",
        "pallas": None,
        "replaces_note": "no Pallas kernel: _mm (:191) and _lm_head_logits "
                         "(:213) leave the dequantization to XLA's fusion",
        "launches": quant_rows["ragged-int8"]["launches"],
        "launches_by_engine": {k: v["launches"] for k, v in quant_rows.items()},
        "wide_calls_by_engine": {k: v["wide_calls"]
                                 for k, v in quant_rows.items()},
        "max_abs_err": quant_errors["abs"],
        "max_rel_err": quant_errors["rel"],
        "max_row_rel_err": quant_errors["row_rel"],
        **{k: quant_times["wq-wo"]["int8"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "library": "torch.matmul on the bf16 weight of the same shape",
        "timed_at": "wq-wo int8, M 8; every shape and scheme in shapes",
        "max_rows": qmm_mod.MAX_ROWS, "design": QUANT_DESIGN,
        "shapes": {name: {scheme: {k: row[k] for k in QUANT_ROW_KEYS}
                          for scheme, row in by_scheme.items()}
                   for name, by_scheme in quant_times.items()},
        "engines": {k: {"weight_products_s":
                        v["trace"]["weight_products_s"],
                        "quant_s": v["trace"]["quant_s"],
                        "wide_path_s": v["trace"]["wide_path_s"],
                        "busy_s": v["trace"]["busy_s"],
                        "idle_share": v["trace"]["idle_share"]}
                    for k, v in quant_rows.items()},
    })
    # Phase 7's runs, each counted from 0 just before it.
    for k in kernels:
        if k["name"] == "paged_decode_attention":
            k["launches_prefix_cache"] = prefix["decode_launches"]
            k["launches_handoff"] = prefix["alternating_launches"]
        elif k["name"] == "flash_attention":
            k["launches_prompt_cache"] = prefix["flash_launches"]
        elif k["name"] == "ragged_paged_attention" and k["variant"] == "bf16":
            k["launches_handoff"] = prefix["ragged_launches"]
            # Phase 9's in-process server, counted from 0 just before it.
            k["launches_stall_capture"] = ckpt["stall"]["launches"]
    # Phase 8's runs, each counted from 0 just before it.
    for k in kernels:
        if k["name"] == "ragged_paged_attention":
            k["launches_speculative"] = spec["ragged"][k["variant"]][
                "launches"]
            if k["variant"] == "bf16":
                k["launches_multilora"] = spec["lora"]["launches"]
        elif k["name"] == "flash_attention":
            k["launches_speculative_draft"] = spec["ragged"]["bf16"][
                "flash_launches"]
            k["launches_speculative_alternating"] = spec["other"][
                "alternating"]["flash_launches"]
            k["launches_speculative_continuous"] = spec["other"][
                "continuous"]["flash_launches"]
    # Phase 13's runs, each rank's counts from 0 just before its engine.
    for k in kernels:
        key = {"ragged_paged_attention": "ragged",
               "flash_attention": "flash",
               "paged_decode_attention": "decode",
               "dense_decode_attention": "dense"}.get(k["name"])
        if key is None or k.get("variant") == "int8":
            continue
        k["launches_tp2_per_rank"] = tp["degree_2"]["launches"][key]
        k["tp_rank_max_abs_err"] = tp["kernels"][key]["abs"]
        if key == "flash":
            k["launches_tp2_per_rank_continuous"] = tp["degree_2"][
                "launches"]["continuous_flash"]
        if key == "ragged":
            k["launches_tp1_nccl"] = tp["degree_1"]["launches"]
    # Phase 14's runs, each rank's counts from 0 just before its steps.
    for k in kernels:
        key = {"flash_attention": "flash",
               "flash_attention_bwd_dq": "bwd_dq",
               "flash_attention_bwd_dkv": "bwd_dkv"}.get(k["name"])
        if key is None:
            continue
        for part in ("fsdp", "tp"):
            k[f"launches_train_sharded_{part}_per_rank"] = [
                step[key] for step in sharded[part]["launches"]]
        k["launches_train_sharded_example"] = sharded["example"][
            "launches"][key]
        k["ts_rank_max_abs_err"] = max(
            sharded["kernels"][t]["abs"] for t in {
                "flash": ("flash",), "bwd_dq": ("dq",),
                "bwd_dkv": ("dk", "dv")}[key])
    # Phase 15's runs, each rank's counts from 0 just before its step or
    # its serving run.
    for k in kernels:
        key = {"flash_attention": "flash",
               "flash_attention_bwd_dq": "bwd_dq",
               "flash_attention_bwd_dkv": "bwd_dkv"}.get(k["name"])
        if key is None:
            continue
        k["launches_sp_pp_ep_per_rank"] = {
            **{f"sp_{impl}": [c[key] for c in spp["sp"]["impls"][impl][
                "launches"]] for impl in SPP_IMPLS},
            "pp": [c[key] for c in spp["pp"]["launches"]],
            "ep": [c[key] for c in spp["ep"]["launches"]]}
        if key == "flash":
            k["launches_sp_pp_ep_per_rank"]["serve"] = spp["serve"][
                "flash_launches"]
        k["sp_rank_max_abs_err"] = max(
            spp["kernels"][t]["abs"] for t in {
                "flash": ("flash",), "bwd_dq": ("dq",),
                "bwd_dkv": ("dk", "dv")}[key])
    # Phase 16 (b)'s runs, each rank's counts from 0 just before its
    # engine, under each mesh.
    for k in kernels:
        key = {"ragged_paged_attention": "ragged",
               "flash_attention": "flash",
               "paged_decode_attention": "decode"}.get(k["name"])
        if key is None or k.get("variant") == "int8":
            continue
        k["launches_mesh_per_rank"] = {
            tag: fleet_mesh["mesh"][tag][
                "ragged" if key == "ragged" else "alternating"]["launches"][
                    key]
            for tag in ("x".join(f"{a}{n}" for a, n in axes.items())
                        for axes in MESH_AXES)}
    phases["total"] = time.monotonic() - t_start
    log(f"phases (s): {json.dumps({k: round(v, 2) for k, v in phases.items()})}")
    # The fp8 products are torch._scaled_mm, a library call that stands
    # where JAX has plain dots (kubeflow_tpu/models/fp8.py:108-111,
    # :131-139), not a kernel of the port: their own line.
    print(json.dumps({"fp8_products": {
        "route": "torch._scaled_mm", "source":
            "kubeflow_tpu_torch/models/fp8.py", "launches_fp8_train":
            finetune["fp8"]["launches"]["fp8"], "rows": FP8_ROWS,
            "shapes": finetune["products"]}}))
    print(json.dumps({"resume": resume}))
    print(json.dumps({"tp": tp}))
    print(json.dumps({"train_sharded": sharded}))
    print(json.dumps({"sp_pp_ep": spp}))
    print(json.dumps({"fleet_mesh": fleet_mesh}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
