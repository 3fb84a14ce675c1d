#!/usr/bin/env python3
"""Smoke of the PyTorch/CUDA port (``bluefog_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py`` (add
``--profile`` for a ``torch.profiler`` breakdown of one decode call, of
one training step, with K1's and K2's device time and share, of one
MoE decode call, of one MoE training step with K1, K2, K4's forward
and K4's backward, and of one ResNet-50 bench call by operator class).

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: the card's name and power limit, torch and CUDA
   versions, and the builds of ``csrc/flash_decode.cu``,
   ``csrc/flash_attention.cu`` and ``csrc/grouped_ffn.cu`` by nvcc (one
   process each, in parallel), while phases 14, 15 and 20, which launch
   none of these kernels, run on the card;
2. flash decode (K3) against its plain PyTorch version on the card at
   full-width shapes (S in {1, 8}, 16 q heads over 16 or 4 kv heads,
   head_dim 64, max_len 1024, block_k 128, T in {1, 4}; f32, bf16, int8
   and e4m3 pages, with and without a prefix row, plus padded lanes on
   the trash row).  Tolerance: max abs error 1e-4 with f32 q (same
   stored values, f32 accumulation, only the summation order differs);
   with bf16 q one bf16 ulp of each output (rtol 8e-3) plus 1e-5 of f32
   noise before the rounding.  The kernel, its plain version and SDPA
   are timed cold (``_device_ms``: L2 flushed before each call, as each
   layer's call finds its pages in the engine), the kernel and SDPA also
   warm (``warm_ms``); the kernels line carries the f32 and the int8
   main-path cases (8 lanes, 16 kv heads); then head_dim 256 (the widest
   bucket) beside 64 on that shape with f32 and int8 pages, at the f32
   tolerance, timed cold with their bounds (a ``head_dim_case`` line);
2b. K3's chunk form at the serving fast path's shapes, every lane read
   through a 256-token prefix row: the speculative verify (8 lanes, T 5,
   272-448 keys), the chunked prefill's remainder buckets (1 lane, T 64,
   256 and 512: up to 8 tiles of 64 query rows in one launch) with f32
   and int8 pages, and 16 q heads over 4 kv heads at T 32 (128 rows).
   One launch a call, f32 atol 1e-4, reruns bit-identical; cold and warm
   ms beside the plain version, the bound (bytes at the verify,
   operations past a few hundred rows) and SDPA (``chunk_case`` lines);
3. the serving path at full width (the non-smoke shape of
   tools/serve_bench.py: vocab 32768, d_model 1024, 16 heads, 8 layers,
   random weights from seed 0) through ``ServeEngine`` and
   ``Scheduler.drain()``: 16 greedy requests with raw KV pages and 8 with
   int8 pages.  Every request must complete, the kernel's launch count
   over the drain must equal layers x decode steps, and the first four
   requests replayed with decode attention forced to the plain version
   must give the same tokens (or diverge only at a near tie of the
   reference logits, top-2 gap < 1e-3);
13 (run after phase 3, on its model). the serving fast path at full
   width: ``ServeEngine(pp=2)`` with ``spec_decode=4``, ``spec_stages=1``
   (a 4-layer draft) and 4 prefix pages of 128 tokens, 16 greedy
   requests of one seeded 256-token system prompt plus a seeded suffix
   of 16-128 tokens, 64 new tokens each.  Every request completes; one
   seal and 15 prefix hits; K3's launches by form equal the path's
   formula (rows: rounds x k x draft layers; chunk: (rounds + chunk
   prefills) x layers); the streams equal a plain drain of the same
   prompts (no spec, no prefix pages, 4 steps a call) up to phase 3's
   near-tie rule; 4 requests replayed with both K3 entry points forced
   to their plain versions give the same streams and launch nothing.
   The ``serve_fast`` line: tokens/s, TTFT and prefill time by prefix
   hit and cold, rounds, drafted and accepted tokens (random weights:
   the acceptance rate says nothing of a trained model), K3 launches by
   form, the cache's bytes, and the plain drain's numbers beside;
3c (run after phase 13). the carved serving engine at phase 3's widths
   (vocab 32768, d_model 1024, 16 heads, 8 layers) at dp 2 x pp 2 x tp 2
   (the JAX serving fixture's carving), the JAX ``init_lm_params`` tree
   loaded by ``params_from_jax(tree, cfg, m=m)``, replica 1's weights
   redrawn on the card from another seed: phase 3's buckets (8 slots a
   replica, max_len 1024, 4 steps a call, f32 pages) and its 16 greedy
   requests of 32-512 prompt tokens and 64 new, spread over the two
   replicas by the scheduler.  Every request completes; K3 launches
   layers x decode steps (one launch a layer-step covers both replicas'
   lanes and both tp peers' heads); each replica's streams equal a
   carving-1 engine on that replica's joined weights
   (``ServingParams.replica``) up to phase 3's near-tie rule, and the
   first 4 requests replayed with K3 forced to its plain version too.
   The ``serve_carved`` line: tokens/s, mean TTFT, decode ms per fused
   step, requests per replica, K3 launches; a ``kernel_case`` of K3 at
   the carved decode shape (16 lanes over 18 cache rows, 16 kv heads:
   one launch's real arguments, captured from a decode call at the full
   bucket) timed cold and warm beside its plain version, bound and SDPA;
4. flash attention K1 (``flash_fwd``) and K2 (``flash_bwd_dkdv`` +
   ``flash_bwd_dq``) against their plain versions: B in {1, 4}, T 2048,
   16 q heads over 16 or 4 kv heads, head_dim 64 and 128, causal and not,
   f32 and bf16 inputs, plus global offsets (one case with every row
   masked) and a 512-token window.  Both sides accumulate in f32 from the
   same values (the kernels' products are 3xTF32 on the tensor cores, f32
   accurate) and only the order differs: the normalized output o/l atol
   1e-4, l rtol 1e-4, m atol 1e-5 with -inf exactly where the plain
   version has it, dq/dk/dv atol 1e-4 x max|plain| per tensor (dk/dv sum
   over up to 2048 G rows).  Yardsticks: SDPA forward for K1, SDPA's
   backward alone on a kept graph for K2 (forward + backward beside it);
   the bound at the 3xTF32 rate (f32) or the bf16 rate, with the f32
   CUDA-core bound of earlier versions beside it;
5. ring attention over 4 stacked ranks (B 1, 4096 tokens per rank, 16 q
   heads over 16 or 4 kv heads, causal, and a 2048-token window), forward
   and backward through the kernels against the same ring over the plain
   block functions (and the forward against the plain online-softmax
   ring), at the tolerances of phase 4; then the zigzag layout at the
   same shapes (no window): K1 and K2 launched exactly n + 1 times a call
   each, against the same ring over the plain block functions and the
   contiguous ring on the un-permuted sequence, forward and grads;
4b. K1/K2 at head_dim 8 (the wrappers zero-pad it to the built 64), 64,
   128 and 256 (the widest built instance) against their plain versions
   at phase 4's tolerances, timed side by side with their bounds at the
   trainer's shape (B 4, T 2048, 16 heads, causal, f32);
6. the decentralized trainer at full width (tools/lm_bench.py's
   non-smoke shape: vocab 32768, d_model 1024, 16 heads, seq 2048, batch
   4, micro 4, 2 layers, dp 4 ranks stacked on the card, Exp2 gossip,
   delayed AWC, Adam 5e-3, random weights from seed 0): 1 warm-up and 4
   timed steps.  K1 and K2 must each launch dp x micro x layers x steps
   times, the mean loss must fall, and the gossip combine must equal
   ``W (x) I`` on one leaf.  A replay of 2 steps from the same init and
   batch with attention forced to the plain version must agree: step-1
   losses rtol 1e-5, step-1 gradients atol 1e-4 x max|g|, step-2 losses
   rtol 1e-3 (Adam's first updates are +-lr wherever |g| >> eps, so
   rounding noise in g can flip a sign only where g ~ 0);
9-10 (run after phase 6). the composed trainer at full width at
   lm_bench's default carving dp 2 x pp 2 x tp 2 (layers 4, micro 8) and
   at dp 2 x tp 2 x sp 2 (Ulysses, layers 2, micro 4): vocab 32768,
   d_model 1024, 16 heads, seq 2048, batch 4, delayed AWC, Adam 5e-3,
   seed 0; 1 warm-up and 3 timed steps.  K1 and K2 must each launch dp x
   (micro + pp - 1) x layers / pp times a step (every live stage, tp and
   sp peer of a GPipe tick folded into one launch), the mean loss must
   fall, and step 1 replayed with attention through the plain versions
   must agree: losses rtol 1e-5, every peer's gradients atol 1e-4 x
   max|g|.  Peak device memory over the 4 steps (a copy of the initial
   params is kept on the card for the replay);
11 (run after phases 9-10). the long-context trainer at full width:
   ``RingTransformerLM`` at lm_bench's widths (vocab 32768, d_model 1024,
   16 heads, 2 layers, rope, f32; 92.3 M parameters) over 8 stacked
   sequence ranks, 16,384 tokens (2,048 a rank), batch 1, through
   ``tools/long_context.py``'s step on its copy task (lag 8), Adam 3e-3,
   seed 0, three ways: the contiguous ring, the zigzag ring and Ulysses;
   1 warm-up and 3 timed steps each.  K1 and K2 must each launch layers x
   n (n + 1) / 2 = 72, layers x (n + 1) = 18 and layers = 2 times a
   step, the loss must fall, the zigzag's step-1 loss must equal the
   contiguous one's (rtol 1e-5; same init, tokens permuted by
   ``zigzag_order``), both the loss the step returned (the mean of
   per-rank means) and the loss over every target token, and step 1
   replayed with attention through the
   plain versions (called one batch row at a time) must agree: loss rtol
   1e-5, every parameter's gradient atol 1e-4 x max|g|.  s/step,
   tokens/s, model FLOP/s and peak memory per layout; under
   ``--profile`` K1+K2's share of device time;
7. the grouped expert FFN K4 (``grouped_ffn``) against its plain version
   (gather + einsum) on inputs laid out by the dropless dispatch itself:
   D 1024, F 4096, 8 experts unless noted; the decode shapes (16 rows at
   tile 2: 12 tiles; 1 lane: 5 tiles), the prefill shapes (1024 rows at
   tile 8: 135 tiles; 512 rows: 71 tiles), 32, 48, 56 and 64 rows an
   expert at tile 8 (200, 328, 392 and 456 rows: the routes'
   crossover),
   tiles 1, 4 and 16, every row on one expert, bf16 operands, and D 96
   / F 200.  Tolerance: f32 max abs error 1e-4 x
   max|plain| (both accumulate in f32, only the order differs); bf16 one
   bf16 ulp of each output (rtol 8e-3) on top of that.  Each case also
   runs both forward routes forced (``expert_rows`` and
   ``forward_gemm``), each held to the same tolerance and timed cold
   beside the route ``ffn_route`` picks (the threshold's evidence).  The
   library yardstick is cuBLAS: ``torch.bmm``, gelu, ``torch.bmm`` over the live
   tiles and their weights gathered beforehand (the port never calls
   it).  Timed cold and warm as
   in phase 2; the f32 bound is at the 3xTF32 rate (the CUDA-core f32
   bound of earlier versions beside it as ``bound_ms_simt``);
8. MoE serving at full width (tools/serve_bench.py's non-smoke widths
   with ``--serve-moe 8x2``: vocab 32768, d_model 1024, 16 heads, 8
   layers, 8 experts of F 4096, top-2, dropless, group tile 8; 637 M
   parameters from seed 0) through ``ServeEngine`` and
   ``Scheduler.drain()`` with phase 3's buckets: 16 greedy requests of
   32-512 prompt tokens and 64 new tokens, raw pages, auto decode tile
   (2).  Every request must complete; K4 must launch layers x (prefills +
   decode steps) times and K3 layers x decode steps; each K4 forward must
   take the route its shapes pick (``forward_gemm`` from an even share of
   52 rows an expert, the prefills of longer prompts), as in 8b, the
   carved path and the MoE estate (a ``k4_routes`` line each; the
   trainers: every K4 forward on ``forward_gemm``); the first four
   requests replayed with K4 forced to its plain version must give the
   same tokens, or diverge only at a near tie: a top-2 logit gap below
   1e-3 at the first divergent token, or a router whose k-th and
   (k+1)-th probabilities lie within 1e-5 at some layer and position up
   to it;
8b. the MoE serving fast path on phase 8's model: pp 1, ``spec_decode=2``
   (the draft: every layer with the expert-mean dense FFN), prefix pages
   as in phase 13, 8 requests of 32 new tokens; phase 13's gates, with
   K4 launched layers x (rounds + chunk prefills + seals) times and
   phase 8's near-tie rule (router ties too) against the plain MoE
   drain;
8c. the carved MoE engine: phase 8's model at dp 2 x tp 2 x ep 2 (each
   owner 4 experts cut F / 2 by its tp peer; the JAX ``init_moe_params``
   tree through ``moe_params_from_jax(tree, cfg, m=m)``, replica 1
   redrawn from another seed), phase 8's 16 greedy requests.  Every
   request completes; K4 launches layers x (prefills + decode steps)
   (one call a decode layer-step for every replica, tp peer and ep owner,
   the decode tile ``decode_tile(ep x 8 x 2, 4)``), K3 layers x decode
   steps; ``moe_load()`` has one entry per replica; each replica's
   streams equal a carving-1 engine on its joined experts, and 4 requests
   replayed with K4 forced to its per-expert plain version give the same
   streams, both up to phase 8's near-tie rule (router ties included).
   The ``serve_moe_carved`` line: tokens/s, mean TTFT, decode ms per
   step, K4 and K3 launches, the trash tiles of one decode call's K4
   call; ``kernel_case`` lines of K3 and of K4 at the carved decode
   shapes (K4: one call over 8 owners' buffers of 32 rows, half of them
   trash tiles marked -1), beside their plain versions, bounds and
   library yardsticks;
12a (run after phase 8). K4's backward (``backward_plan_cuda``, then
   ``grouped_ffn_dgrad_cuda`` + ``grouped_ffn_wgrad_cuda`` under
   ``GroupedFFN``, f32) against the per-expert plain version under
   autograd: the MoE trainer's steady tick (65,536 rows over 32 folded
   experts, D 1024, F 2048), the serving prefill shape (135 tiles of 8,
   8 experts, F 4096), hostile routing (every row on one expert but 3 on
   another, the rest empty) and Zipf-skewed routing at the steady tick's
   shape (seeded weights k^-1.2: a trained router is uneven).  dxt, dw1,
   dw2 within 1e-4 x max|plain| (f32-accurate 3xTF32 products summed in
   another order, the weight gradients over up to 65k rows of one
   expert); two runs bit identical; experts without rows exactly 0; the
   device plan equal to its plain version, list by list.  Timed cold and
   warm beside the bound (8 rows D F operations at the 3xTF32 rate), the
   plain version's backward and the per-expert cuBLAS yardstick
   (``torch.matmul`` over each expert's rows, bounds read beforehand),
   with the dgrad, the wgrad and the plan timed apart and the plan's item
   counts.  The build (phase 1) prints ptxas's registers and spills for
   the backward's kernels (the plan, the f32 and bf16 GEMMs in their
   three modes, the part sum for f32 and bf16: 9) and fails on any
   spill in them.  Then the bf16 cases (``grouped_ffn_backward_bf16_
   phase``: the bf16 GEMM on bf16 operands and the forward's f32 ``s``):
   the steady tick, hostile routing, Zipf-skewed routing, two
   expert-parallel owners' buffers half trash tiles, and forced wgrad
   splits, each against the bf16 plain version with the kernels'
   rounding points (per expert, on the same ``s``) and against an f64
   evaluation on the card: dxt, dw1, dw2 within one bf16 ulp of their
   max |plain| and no farther from f64 than the plain version plus half
   such an ulp; two runs bit-identical; experts without rows and trash
   rows of dxt exactly 0.  Timed cold and warm beside the bound at the
   bf16 rate, the plain version and the per-expert cuBLAS bf16
   yardstick; every bf16 case's forward (the route its shape picks)
   against the per-expert plain version at phase 7's bf16 tolerance.  At
   the steady tick, f32 and bf16, the trainer's forward (``s`` kept) on
   both routes in the same run, each against the per-expert plain
   version (1e-4 x max|plain|, plus 8e-3 x |plain| in bf16) and rerun for
   identical bits, timed cold and warm beside the bound (f32 at the
   3xTF32 rate; bf16 the up-projection at the bf16 rate and the
   down-projection, f32 u times the bf16 weight, at a third of it: u
   split into three bf16 parts), the plain version and per-expert cuBLAS
   on the same function (f32 products, TF32 off; bf16 operands widened,
   their up-projection with TF32 on, exact for them), with cuBLAS on
   bf16 operands (u rounded to bf16) as a lower-precision yardstick
   beside it.  The build (phase 1) also prints ptxas's report of the four
   forward_gemm kernels and fails on any spill in them;
12b. MoE training at full width: ``MoELMConfig(vocab=32768,
   d_model=1024, heads=16, layers=4, seq_len=2048, micro=4, batch=4,
   num_experts=8, top_k=2, dispatch="dropless", group_tile=8)`` at dp 2
   x pp 2 x tp 2, Exp2 gossip, delayed AWC, Adam 5e-3, seed 0 (micro 4,
   not lm_bench's 8, is the one cut); 1 warm-up and 3 timed steps.  K1,
   K2, K4's forward, dgrad and wgrad must each launch dp x (micro + pp -
   1) x layers / pp times a step (the plan once with each dgrad: the
   forward launches it on its ``forward_gemm`` route, which every K4
   forward of the step must take at 65,536 rows a call, and the backward
   takes it), the loss must fall, the probe must
   report dropped_fraction 0, usage summing to 1 and finite values.
   Step 1 replayed through the plain versions (plain K1/K2, the
   per-expert K4): the router calls' top-k may flip only at near ties
   (each replica's first flip at a k-th to (k+1)-th probability gap
   below 1e-5; later flips are counted), and on any flip the replay
   takes the kernel run's routing; loss rtol 1e-5; every gradient within
   the larger of 1e-4 x max|g| and twice its one-ulp floor (the kernel
   path's own step-1 gradient with the embedding table moved by one ulp,
   measured in the same run: at these widths f32 rounding alone moves
   the gradients by ~2e-4 x max|g|, see PERF.md).  s/step, tokens/s,
   model FLOP/s and peak memory; the K4 operand copies of step 1;
12c. MoE training at ep 2: phase 12b's config at dp 2 x ep 2 (4 stacked
   peers: each ep peer holds 2 of the 4 batch rows and 4 of the 8
   experts; every tp/ep peer of a tick in one dispatch and one K4 call,
   each owner's buffer sized for 16,384 rows of which ~8,192 are real,
   the rest trash tiles that K4 skips) and its ep-1 twin at dp 2, seed 0,
   Exp2 gossip, delayed AWC, Adam 5e-3; 1 warm-up and 1 timed step each
   (3 timed before phases 18-19 came, 2 before phase 21: the cuts keep
   the script's time).
   K1, K2, K4's forward, plan, dgrad and wgrad must each launch dp x
   micro x layers = 32 times a step in both runs; the loss must fall and
   the probe drop none; step 1's loss must equal the twin's (rtol 1e-5),
   its non-expert gradients be equal on every ep peer, and every leaf
   (experts joined over the ep peers) equal the twin's within 12b's rule
   (the larger of 1e-4 x max|g| and twice the one-ulp floor of the ep-2
   run, measured in the same run with the embedding moved one ulp up and
   one down, each leaf's larger change; routing may flip only at near ties:
   each replica's first flip at a gap below the larger of 1e-5 and
   twice how far a one-ulp move of the embedding moves that router
   call's probabilities, the gap the flip crosses (a change of the
   chosen set or only of its order); on any flip the twin is taken
   again on the ep-2 run's routing);
   the probe's usage at the init must equal the twin's (1e-4); step 1
   replayed through the plain versions (plain K1/K2, the per-expert K4)
   under 12b's rules.  s/step, tokens/s, model FLOP/s and peak memory of
   both runs; K4's forward and backward device ms per step of both (one
   more step under torch.profiler); the trash tiles of one K4 call and
   that call timed cold with them marked against clamped onto a real
   expert (the evidence that K4 spends no time on them);
12d. capacity dispatch (capacity factor 1.25) and expert choice at dp 2
   x ep 2, phase 12b's widths, 1 warm-up and 1 timed step each (2 timed
   before phase 21 came): K1/K2
   launch dp x micro x layers times a step and K4 never; the loss falls;
   step 1 replayed through plain K1/K2 has the same loss (rtol 1e-5;
   flips only at near ties by 12c's rule, then the routing forced); capacity: dropped_fraction in [0,
   1); expert choice: usage exactly 1/E, aux 0, coverage in (0, 1].
   s/step, tokens/s and peak memory;
12e. MoE training in bf16: phase 12b's model, carving and optimizer with
   every parameter, gradient and Adam moment in bf16 (``init_moe_train_
   params(dtype=torch.bfloat16)``), at lm_bench's micro 8 (12b's f32 cut
   to 4 is not needed: bf16 halves the activations), 1 warm-up and 1
   timed step (2 before phase 22).  Launches by 12b's formula (every K4
   forward on ``forward_gemm``), every leaf still bf16, the
   loss falls, the probe drops none (usage sums to 1 within 2^-6).  Step
   1 replayed through the plain versions: flips only at near ties by
   12c's rule against the probabilities' change under a one-bf16-ulp
   move of the embedding (then the routing forced), the loss within 2
   bf16 ulps of the kernel run's, each gradient leaf within one bf16 ulp
   of its max |g| or twice that move's change.  s/step, tokens/s, model
   FLOP/s against 989 TFLOP/s, peak memory, and one more step under
   torch.profiler for the kernels' device ms and the busy share (a
   ``moe_train_bf16`` line);
14. the ResNet-50 gossip benchmark (``tools/bench.py``, bench.py's path;
   no K1-K4 on it: their launch counts stay 0 over the phase).  14a: the
   step-1 loss, logits and gradients of bench.py's loss for ResNet-50 at
   full width (224 x 224, 1000 classes, seeded weights with every
   BatchNorm scale and bias drawn, 4 distinct seeded images and
   labels), on the card and on the CPU in bf16 and f32, and on the CPU
   in float64 as the reference (cuDNN's TF32 off for the f32 runs
   only): the card's f32 error against the reference within 1e-4 x
   max|g| a leaf (logits 1e-4 x max|logits|, loss rtol 1e-5) or twice
   the CPU f32 run's own, no leaf all zero; each bf16 gap (card against
   CPU) at most twice the card's own bf16-against-f32 gap; both f32
   runs replay the reference's ReLU masks and max-pool picks, each
   element that left the reference's side a near tie and such elements
   few (the gates of ``bluefog_tpu_torch/tools/resnet_parity.py``; a
   ``resnet_parity`` line).
   14b: the bench's card defaults at 1
   rank (batch 64, 5 steps a call, 1 warm-up and 2 timed calls, the
   tool's 10 cut to make room for phase 21): the
   loss finite and falling (a ``bench`` line; ``--profile`` adds
   ``profile_resnet`` lines: one call's device time by operator class and
   the busy share, with the port's BatchNorm and with PyTorch's fused
   batch norm in its place as a yardstick, and their bench runs in a
   ``resnet_bn_yardstick`` line).  14c: 4 stacked ranks over weighted
   Exp2 at batch 16 a rank: every rank's parameters equal within 1e-5 x
   max|param| (same data, same start), the loss falls (a
   ``bench_ranks4`` line);
15. the strategy benchmark (``bluefog_tpu_torch/examples/benchmark.py``,
   the port of ``examples/benchmark.py``; no K1-K4 on it: their launch
   counts stay 0 over the phase).  15a: seeded f32 buffers [8, 2^20]
   (rows 1e-3 to 1e4 in magnitude, an all-zero row, a subnormal row)
   encoded for bf16, int8, int8@256, fp8 and fp8@64 on the card and on
   the CPU: payloads, scales and decodes bit-identical, the subnormal
   row's scale alone free, the quantizers storing zeros for it (a
   ``codec_parity`` line).  15b: the example's ``--model mlp`` at 8
   ranks, seeded rank-varying data, 3 steps (5 before phase 21) of each of
   15 variants
   (neighbor_allreduce AWC / ATC / dynamic / bf16 / int8 wire,
   gradient_allreduce, allreduce, empty, hierarchical, win_put,
   pull_get, push_sum, choco, zero_allreduce, powersgd) on the card
   (TF32 off) and on the CPU: each leaf within 1e-5 x max|leaf| or twice
   the CPU f32 run's distance from a CPU float64 run, push-sum's weights
   summing to n within 1e-6 x n, zero_allreduce = gradient_allreduce
   within 1e-6 x max|param|, the gradient-averaging strategies' ranks
   bit-equal (a ``strategy_parity`` line; the gates of
   ``bluefog_tpu_torch/tools/strategy_parity.py``).  15c: the example at
   its defaults (ResNet-50, 224 x 224, 1000 classes, batch 32 a rank,
   SGD 0.01 momentum 0.9, 8 stacked ranks on weighted Exp2), 1 warm-up
   and 3 timed steps for the default variant and 1 for the 14 others
   (10 and 3 before phase 21):
   the loss finite and falling, every rank's parameters equal within
   1e-5 x max|param| (same start, same data); one
   ``benchmark_strategy`` line a variant (img/s, s/step, peak memory,
   the bytes a rank puts on the wire a step from the schedule tables
   and the codecs' widths);
16. the train->serve estate (``bluefog_tpu_torch/tools/serve_bench.py``,
   the port of the JAX grader): 16a dense, 16b ``--serve-moe 8x2@2``, at
   the tool's full widths (vocab 32768, d_model 1024, 16 heads, 4
   layers, seq 128) with ``--train-dp 2 --serve-dp 2 --pp 2
   --refresh-every 2 --traffic-trace flash-crowd``: 16 requests drained
   while 6 Adam steps train beside them (K1/K2, and K4 with its backward
   in 16b), the refresher pulling mid-traffic, then 24 steps of bursty
   traffic with the top replica parked.  Gates: every request done, none
   failed; >= 2 pulls, staleness 0 after each; the served tensors equal
   the training mean at their offsets (1e-6 of each tensor's largest
   magnitude); the KV cache written in place; the parked replica grown
   back, recovery within 2 x steps, the scale file = live replicas x
   ranks a replica; K1/K2/K3 (and K4, its plan, dgrad and wgrad) launch
   over the drain and the trace phase exactly as ``estate_phase``'s
   formulas say; the drain's 16 prompts drained again with K3 and with
   K3's plain version on the last pulled weights give the same streams
   up to near ties; each kernel held against its plain version on one
   launch's copied inputs from this path (K1/K2 from the trainer, K3
   from the replay's widest decode call, K4 from the engine and K4 with
   its backward from the trainer, on the gradient that reached it).
   One ``serve_estate`` / ``serve_estate_moe`` line each (tokens/s while
   training, per-token p50/p99, TTFT p50/p99, decode MFU, staleness,
   pulls, s per train step, peak memory, launches, the trace row, the
   MoE dense-twin tokens/s, the card and its power limit);
17. the MoE examples (``bluefog_tpu_torch/examples``): ``llm_3d`` at its
   defaults (dp 2 x pp 2 x tp 2, 100 steps) and with ``--tp 1 --ep 2
   --experts 4 --steps 40``, ``moe`` and ``moe --top2``, ``moe_lm`` (8
   stacked ranks, ring attention through K1/K2 at head dim 16), each
   through its ``main``, which asserts its own end condition: K1/K2
   launches equal the path's count (llm_3d dp x (micro + pp - 1) x
   layers / pp x steps, moe_lm 36 visible ring blocks a step, moe none)
   and K4 none (an ``examples_moe`` line);
18. the pipeline schedules (``parallel/pipeline.py``, no K1-K4): (a)
   ``examples/pipeline_lm`` at the JAX example's defaults but 50 steps
   (100 before phase 21) in each mode (GPipe, ``--remat``, ``--interleaved
   2 --micro 4``, ``--hetero``),
   each through its ``main``, which asserts that the loss fell (first and
   last loss, seconds); (b) the example's decoder block at lm_bench's
   widths (d_model 1024, 16 heads, seq 2048, batch 2, 4 stages, 8
   microbatches, f32, weights from seed 0): one step each of GPipe,
   GPipe + remat, 1F1B on the same weights and batch, and the interleaved
   schedule (V 2, micro 4, its own 8 blocks), with s a step and the peak
   of ``torch.cuda.max_memory_allocated`` (reset before each).  Gates:
   1F1B's gradients equal GPipe's and the interleaved ones the
   sequential composition's within 1e-4 x max|g| a leaf, and 1F1B's peak
   memory lies below GPipe's without remat (a ``pipelines`` line).
   (b) runs first and alone, each schedule warmed by one untimed step;
   (a) runs after it, beside phase 19's processes;
19. the multi-process world (``tools/world_check.py``, no K1-K4): (a) a
   child process with torchrun's variables at WORLD_SIZE=1 runs every op
   of the check (gossip under bf16 / fp8 / int8@4 / fp8@4, Exp2 gossip,
   neighbor_allgather, ragged_neighbor_allgather, pair_gossip, allreduce,
   allgather, ragged_allgather, broadcast, hierarchical gossip, windows,
   5 ZeRO-1 steps, GPipe with gradients, 1F1B, interleaved, a stage
   list) on CUDA tensors over NCCL, 8 stacked rows, every result equal
   bit for bit to the same calls in the one-process context on the card;
   (b) two gloo processes x 4 rows on the machine's CPU run the same
   checks, equal bit for bit to one CPU process (the sums through the
   group within 1e-6), and the gossip step under ``set_round_parallel``
   and the ZeRO-1 steps move their rows in the counted number of
   ``batch_isend_irecv`` calls.  NCCL refuses two ranks on one device,
   so no NCCL move between two processes runs here: (a) is a bootstrap
   check (NCCL init on ``cuda:LOCAL_RANK`` and the in-process paths),
   and the crossing rows are shown by (b) (a ``world`` line); the checks
   include the named windows and async window gossip.  K1-K4 launch
   counts read over phases 18-19 must be 0.
20. the optimizer core's rest (no K1-K4), TF32 off, 8 stacked ranks:
   (a) exact diffusion, gradient tracking, push-DIGing, async window
   gossip at K 0 and at K 2 with rank 3 at pace 3, ZeRO with
   hierarchical gossip, and the stateful step with neighbor and
   allreduce state sync, 2 steps each (5 before phase 21) on
   strategy_bench's MLP (512 ->
   1024 -> 512 -> 10) with rank-varying data: each leaf within 1e-5 x
   max|leaf| of a CPU float64 run or twice the CPU f32 run's distance
   from it, the async mass summing to n within 1e-6 x n, and the named
   windows on the card equal to the CPU bit for bit (a
   ``strategy_parity_rest`` line); (b) ``tools/strategy_bench.py`` at its
   defaults (``strategy_bench``); (c) ``tools/gossip_bench.py`` at its
   defaults and ``--train-step`` (``gossip_bench``); (d)
   ``decentralized_optimization`` at its defaults, which asserts that
   every method converges; (e) ResNet-50 (224 x 224, 1000 classes, 8
   ranks x 16) with its BatchNorm statistics as ``net_state`` of
   ``make_stateful_train_step`` under async gossip (K 2, rank 3 at pace
   3), neighbor state sync and the probe every call, 1 warm-up and 3
   timed steps: finite loss and statistics, the mass n (a
   ``stateful_resnet`` line).  K1-K4 launch counts over phase 20 must be
   0.
21. the host runtime (a ``host_runtime`` line a leg), through lm_bench's
   dense trainer at its full width (vocab 32768, d_model 1024, 16 heads,
   2 layers, seq 2048, micro 4, batch 4, f32, dp 4, Exp2 gossip, delayed
   AWC, Adam): the native helpers loaded, the loader's batches through
   pinned buffers equal to its host batches, and the native row gather
   timed against numpy's at the examples' batches; (a) ``tools/lm_bench``
   under ``throttle:from=2,until=99,t=0.2,rank=2`` and under a throttle
   of twice the step (``--flight-dir``; 3 and 3 timed steps, 6 and 3
   before phase 22; the
   unthrottled step from the other ranks' entries): rank 2 the slowest,
   tools/postmortem.py's skew
   within 25 % of the throttle from step 2, the second throttle blamed,
   K1/K2 on one captured launch against their plain versions; (b)
   ``nan:step=3,rank=1`` under ``guard_step``: rolled back in place, the
   state after 5 calls equal to 4 unfaulted steps; (c) gossip_bench's
   [8, 2^20] buffer: a chaos kill, ``mark_rank_dead``, monotone
   contraction, a chaos join with a warmup ramp (no kernel); (d)
   ``checkpoint.save`` resumed into a fresh trainer, which saves again
   through ``AsyncSaver`` during its next steps, that checkpoint resumed
   into a third: each equal to the uninterrupted run bit for bit; (e)
   ``BLUEFOG_TIMELINE``
   (native writer, device trace, tools/timeline_merge.py) and the
   watchdog's timeout naming the last flight event; (f) the mnist,
   resnet (resumed once) and elastic_restart examples at their defaults.
   K1/K2 launch counts are each run's formula, and the kernels line sums
   the counts read after each run; no K3/K4.

22. the launcher, the elastic world and the fleet view (an ``elastic``
   line a leg): (a) the dense trainer at lm_bench's full width (phase
   21's config) at dp 4 with ``BLUEFOG_FLEET_EVERY=1`` (the probe every
   step) and ``/fleet`` served on an ephemeral port, 2 steps, then
   ``resilience.regrow_world(6, state)`` with the whole train state as
   one tree (params, both Adam moments, the delayed carry), 1 step on a
   dp-6 trainer written from the carried state, ``commit_regrow``, a
   regrowth back to 4 (a size already seen), 1 step and a commit: the
   survivors' rows of every tensor bit for bit with the old world's
   state, the joiners' rows within 1e-6 of their donors' mean, the first
   dp-6 step bit for bit with a fresh dp-6 trainer's from the carried
   state, no kernel built or loaded during either regrowth
   (``ops/_build.py``'s counts), the port's ``fleet_top --once --url``
   as a subprocess after a dp-4 and after the dp-6 step (every rank's
   row, 4 then 6, flooded by diameter probes; the fleet's mean step time
   the per-rank mean), the probe's ms armed and disarmed, each protocol
   phase's seconds, the bytes carried and the peak memory, K1/K2 on a
   captured launch against their plain versions; (b) at (a)'s final
   state, ``kill_coordinator`` then a 3 s ``hang_reinit`` (under
   ``BLUEFOG_REGROW_TIMEOUT=2.0``) each abort and reinstall the old
   world, and the next step equals bit for bit a step from the state
   before them; (c) ``regrow_drill`` (with and without ``--chaos``) and
   ``preempt_bench`` on ``preempt_trace``'s ``mass`` trace at their
   defaults on CUDA tensors (0 fresh builds); (d) ``bfrun-torch`` (``python
   -m bluefog_tpu_torch.run.launcher``): ``-np 1 --flight-dir`` over
   lm_bench at full width (a one-process NCCL world, K1/K2 counted in
   the child by the formula), ``-np 1 --restart-limit 1`` over
   ``examples/elastic_restart`` with a planted chaos kill (respawned
   with ``BLUEFOG_RESTART_COUNT=1``, exit 0), and ``--interactive -np
   1`` (one worker on the card runs a cell that forms the world and
   prints the card's name); all three start before phase 17 and run
   beside phases 17-21 (the ``elastic_children_overlap`` line names the
   phases each ran beside).  K1/K2
   launch counts are each run's formula; no K3/K4.

23. the autotuner (``autotune``, ``autotune_bench`` and
   ``carving_tuner`` lines): (a) ``autotune(params=ResNet-50's {"params",
   "bs"} tree, trials=3)`` over 8 stacked ranks, the full default space,
   banked into a temporary directory, then twice at ``trials=0`` on it:
   no probe fails, the trialled keys read ``banked``, the two documents
   are byte-identical; (b) the plan through ``tools/bench.py --plan`` on
   ResNet-50 over 8 ranks x 16 (img/s beside ``plan_id``), and a plan for
   4 ranks refused; (c) ``tune_carving`` at lm_bench's dense widths
   (micro cut to 4) over every carving with pp, tp, sp <= 2 (plus the
   dp-1 and 16-chip rejections) and at phase 12b's MoE config over
   ``tests/test_moe.py``'s list, both dispatch schemes: each carving's
   one real step with its DCN / ICI bytes, DCN dtypes, seconds and peak
   memory; K1/K2 (and K4 with its backward on the dropless runs)
   launched by the formula a carving and held against their plain
   versions on one captured launch each.

24. the trace's compute / comm split, the step sweep and the notebooks
   (``overlap``, ``step_sweep`` and ``notebooks`` lines, each with the
   card's name and power limit): (a) ``tools/lm_bench`` at its default
   carving dp 2 x pp 2 x tp 2 and full width (4 layers, micro 8, batch 4,
   seq 2048; delayed AWC, Adam) with its trace on, ``--iters 3
   --steps-per-call 1 --no-sweep``: ``ok``, no kernel build after the
   warm-up, K1/K2 launched ``dp x (micro + pp - 1) x layers / pp`` = 36
   times a step (180 over the 5 steps), an ``overlap`` block with comm
   above 0 whose top exposed ops name ``bluefog::psum`` and the gossip's
   ``bluefog::neighbor_allreduce``, busy within wall, and K1/K2 held
   against their plain versions on one captured launch; (b)
   ``tools/step_sweep`` on ResNet-50 at ``--ranks 4 --batch 16 --sweep
   1,5 --iters 2 --trace``: both rows, the dispatch amortization, and the
   trace's analysis with the gossip's comm above 0; no K1-K4; (c) the
   two notebooks' code cells in order on the card, their asserts
   included.  The legs of 21a and 22d pass ``--no-trace``.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate
# f32-accurate products on the tensor cores: 3xTF32 (big/small split,
# three TF32 MMAs per product) at a third of the dense TF32 rate
TF32_FLOPS = 495e12           # H100 SXM dense TF32 tensor-core rate
TF32X3_FLOPS = TF32_FLOPS / 3
K4_ROUTES = ("expert_rows", "forward_gemm")   # K4's forward routes

H, DH, L, BK = 16, 64, 1024, 128
DEV = "cuda"


def _cuda_ms(fn, iters=20, warmup=3):
    """Warm time of K1/K2: ``iters`` calls back to back between two events
    (their milliseconds hide the host's launches)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_FLUSH = {}
FLUSH_BYTES = 256 << 20       # > the H100's 50 MB L2
HOLD_CYCLES = 1 << 21         # ~1 ms of device spin while the host enqueues


def _device_ms(fn, cold, iters=20, warmup=3):
    """Device time of one call, mean over ``iters``: before each call,
    outside the timed interval, the device spins while the host enqueues
    the call, so the two events around it see no host time.  ``cold``
    also writes a 256 MB buffer first (L2 holds 50 MB), as each layer's
    call finds its pages and weights in the engine; warm calls find in L2
    what the previous call left there."""
    if cold and "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                    device=DEV)
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            _FLUSH["buf"].fill_(1)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def _pages(rng, rows, Hkv, store, kv, dh=DH):
    """One layer's pages on the card: raw f32/bf16 or quantized."""
    cl = {}
    for name in ("k", "v"):
        x = torch.from_numpy(rng.normal(size=(rows, Hkv, L, dh)).astype(
            np.float32)).to(DEV)
        if store == "f32":
            cl[name] = x
        elif store == "bf16":
            cl[name] = x.bfloat16()
        else:
            cl[name], sc = kv.quantize_rows(x, store)
            cl[name + "_scale"] = sc.contiguous()
    return cl


def _bound_ms(lens, T, Hkv, G, page_item, q_item, quantized, S, dh=DH):
    """Least time for the work: every needed K/V row read once (plus its
    scales), q read and the output written once, against the larger of
    the memory and the f32 arithmetic bound."""
    keys = sum(int(n) + T for n in lens)
    nbytes = keys * Hkv * dh * 2 * page_item
    if quantized:
        nbytes += keys * Hkv * 2 * 4
    nbytes += 2 * S * T * H * dh * q_item + 4 * S * 4
    scored = sum((int(n) + t + 1) for n in lens for t in range(T))
    flops = scored * H * dh * 4                       # q.k and p.v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _sdpa_yardstick(kv, q, cl, slots_t, lens_t, pre, want):
    """K3's library yardstick: one SDPA call over pages gathered through
    the slot and prefix tables, dequantized and head-expanded beforehand,
    with the causal-offset mask (query t of lane s sees keys up to
    lens[s] + t).  Returns the call and its max abs error against the
    plain version's output ``want``."""
    import torch.nn.functional as F
    S, T, Hq, _ = q.shape
    G = Hq // cl["k"].shape[1]
    ks, vs = kv._gather_pages(cl, slots_t, pre.get("prefix_slots"),
                              pre.get("prefix_lens"))
    kh = ks.to(q.dtype).repeat_interleave(G, dim=1)          # [S, H, L, Dh]
    vh = vs.to(q.dtype).repeat_interleave(G, dim=1)
    qh = q.transpose(1, 2)                                   # [S, H, T, Dh]
    qpos = lens_t[:, None] + torch.arange(T, device=q.device)[None]
    mask = (torch.arange(L, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]                    # [S, 1, T, L]

    def lib_call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    lib_err = float((lib_call().transpose(1, 2).float() - want.float())
                    .abs().max())
    return lib_call, lib_err


def kernel_phase(fd, kv):
    """Phase 2: every case once; returns the rows of the main-path cases
    (8 lanes, 16 kv heads, f32 q; f32 and int8 pages)."""
    rng = np.random.default_rng(1)
    cases = []
    for S in (1, 8):
        for Hkv in (16, 4):
            for T in (1, 4):
                for store, qdt in (("f32", torch.float32),
                                   ("bf16", torch.float32),
                                   ("bf16", torch.bfloat16),
                                   ("int8", torch.float32),
                                   ("fp8", torch.float32)):
                    for prefix in (False, True):
                        cases.append((S, Hkv, T, store, qdt, prefix, False))
    cases.append((8, 16, 1, "f32", torch.float32, False, True))
    main = {}
    for S, Hkv, T, store, qdt, prefix, trash in cases:
        G = H // Hkv
        rows = S + 2                          # S slots, a prefix row, trash
        cl = _pages(rng, rows, Hkv, store, kv)
        if S == 1:
            lens = np.array([(2 * L) // 3])
        else:
            lens = np.linspace(0, L - T, S).astype(np.int64)
        slots = np.arange(S)
        if trash:                              # padded bucket lanes
            slots[5:], lens[5:] = rows - 1, 0
        plens = (lens // 2) // BK * BK if prefix else None
        dev = DEV
        slots_t = torch.tensor(slots, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        pre = {}
        if prefix:
            pre = dict(prefix_slots=torch.full((S,), S, dtype=torch.int32,
                                               device=dev),
                       prefix_lens=torch.tensor(plens, dtype=torch.int32,
                                                device=dev))
        q = torch.from_numpy(rng.normal(size=(S, T, H, DH)).astype(
            np.float32)).to(DEV, qdt)

        def kern():
            return fd.flash_attend_chunk(q, cl, slots_t, lens_t,
                                         block_k=BK, **pre)

        def plain():
            return kv.attend_chunk(q, cl, slots_t, lens_t, **pre)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if qdt == torch.float32:
            ok, tol = err <= 1e-4, "atol 1e-4"
        else:
            lim = 8e-3 * want.float().abs() + 1e-5
            ok, tol = bool((diff <= lim).all()), "rtol 8e-3 + 1e-5"
        if not (ok and torch.isfinite(got.float()).all()):
            raise AssertionError(
                f"flash decode disagrees with its plain version: S={S} "
                f"Hkv={Hkv} T={T} store={store} q={qdt} prefix={prefix} "
                f"trash={trash}: max abs err {err} ({tol})")
        lib_call, lib_err = _sdpa_yardstick(kv, q, cl, slots_t, lens_t, pre,
                                            want)
        ms, warm_ms = _device_ms(kern, True), _device_ms(kern, False)
        plain_ms = _device_ms(plain, True)
        lib_ms = _device_ms(lib_call, True)
        lib_warm_ms = _device_ms(lib_call, False)
        bound, bound_by = _bound_ms(
            lens, T, Hkv, G, cl["k"].element_size(), q.element_size(),
            "k_scale" in cl, S)
        row = dict(S=S, Hkv=Hkv, T=T, store=store, q=str(qdt)[6:],
                   prefix=prefix, trash=trash,
                   splits=fd.split_plan(S, Hkv, L)[0], max_abs_err=err,
                   ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
                   library_warm_ms=lib_warm_ms, library_err=lib_err)
        print("kernel_case " + json.dumps(row), flush=True)
        if (S, Hkv, T, qdt, prefix, trash) == \
                (8, 16, 1, torch.float32, False, False) \
                and store in ("f32", "int8"):
            main[store] = row
    return main["f32"], main["int8"]


def decode_head_dim_phase(fd, kv):
    """Phase 2 (head dims): K3 at head_dim 256 (its widest bucket) beside
    64 on the main-path shape (8 lanes, 16 kv heads, T 1, f32 q) with f32
    and int8 pages, against the plain version at phase 2's tolerance,
    timed cold with their bounds; returns the Dh-256 rows."""
    rng = np.random.default_rng(12)
    S, Hkv, T = 8, 16, 1
    lens = np.linspace(0, L - T, S).astype(np.int64)
    slots_t = torch.arange(S, dtype=torch.int32, device=DEV)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    rows, out = [], {}
    for store in ("f32", "int8"):
        for dh in (64, 256):
            cl = _pages(rng, S + 1, Hkv, store, kv, dh)
            q = torch.from_numpy(rng.normal(size=(S, T, H, dh)).astype(
                np.float32)).to(DEV)

            def kern():
                return fd.flash_attend_chunk(q, cl, slots_t, lens_t,
                                             block_k=BK)

            def plain():
                return kv.attend_chunk(q, cl, slots_t, lens_t)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not (err <= 1e-4 and bool(torch.isfinite(got).all())):
                raise AssertionError(f"flash decode at head_dim {dh} "
                                     f"({store} pages) disagrees with its "
                                     f"plain version: {err} (atol 1e-4)")
            bound, bound_by = _bound_ms(lens, T, Hkv, H // Hkv,
                                        cl["k"].element_size(), 4,
                                        "k_scale" in cl, S, dh)
            row = dict(store=store, Dh=dh, max_abs_err=err,
                       ms=_device_ms(kern, True),
                       warm_ms=_device_ms(kern, False),
                       plain_ms=_device_ms(plain, True, iters=5, warmup=1),
                       bound_ms=bound, bound_by=bound_by)
            rows.append(row)
            if dh == 256:
                out[store] = row
    print("head_dim_case " + json.dumps({
        "kernel": "flash_decode", "S": S, "Hkv": Hkv, "H": H, "T": T,
        "L": L, "cases": rows, "device": torch.cuda.get_device_name(0)}),
        flush=True)
    return out


PREFIX = 256                  # phase 2b / 13: the sealed system prompt


def chunk_phase(fd, kv):
    """Phase 2b: K3's chunk form at the serving fast path's shapes, every
    lane attached to a 256-token prefix row: the verify (8 lanes, T 5,
    lengths 272-448), the chunked prefill's remainder buckets (1 lane, T
    64 / 256 / 512) with f32 and int8 pages, and one GQA case past one
    64-row tile (16 q heads over 4 kv heads, T 32: 128 rows).  One launch
    a call, f32 atol 1e-4 against the plain version, two reruns bit
    identical; timed cold and warm beside the plain version, the bound
    and the SDPA yardstick.  Returns the f32 rows by case (T5 ... T512)."""
    rng = np.random.default_rng(21)
    verify_lens = np.linspace(PREFIX + 16, PREFIX + 192, 8).astype(np.int64)
    cases = [("T5", 8, 16, 5, verify_lens, store) for store in ("f32",
                                                                 "int8")]
    cases += [(f"T{T}", 1, 16, T, np.array([PREFIX]), store)
              for T in (64, 256, 512) for store in ("f32", "int8")]
    cases.append(("T32_gqa4", 1, 4, 32, np.array([PREFIX]), "f32"))
    out = {}
    for tag, S, Hkv, T, lens, store in cases:
        G = H // Hkv
        cl = _pages(rng, S + 2, Hkv, store, kv)   # S slots, a prefix, trash
        slots_t = torch.arange(S, dtype=torch.int32, device=DEV)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
        pre = dict(prefix_slots=torch.full((S,), S, dtype=torch.int32,
                                           device=DEV),
                   prefix_lens=torch.full((S,), PREFIX, dtype=torch.int32,
                                          device=DEV))
        q = torch.from_numpy(rng.normal(size=(S, T, H, DH)).astype(
            np.float32)).to(DEV)

        def kern():
            return fd.flash_attend_chunk(q, cl, slots_t, lens_t,
                                         block_k=BK, **pre)

        def plain():
            return kv.attend_chunk(q, cl, slots_t, lens_t, **pre)

        before = fd.flash_decode_cuda.launches
        got, want = kern(), plain()
        torch.cuda.synchronize()
        launched = fd.flash_decode_cuda.launches - before
        err = float((got - want).abs().max())
        same = all(torch.equal(kern(), got) for _ in range(2))
        if not (err <= 1e-4 and launched == 1 and same
                and bool(torch.isfinite(got).all())):
            raise AssertionError(
                f"flash decode chunk case {tag} ({store} pages): max abs "
                f"err {err} (atol 1e-4), {launched} launches (want 1), "
                f"reruns bit-identical: {same}")
        lib_call, lib_err = _sdpa_yardstick(kv, q, cl, slots_t, lens_t, pre,
                                            want)
        tiles = fd.row_tiles(T * G)
        bound, bound_by = _bound_ms(lens, T, Hkv, G, cl["k"].element_size(),
                                    4, "k_scale" in cl, S)
        row = dict(case=tag, S=S, Hkv=Hkv, T=T, rows=T * G, tiles=tiles,
                   store=store, lens=lens.tolist(), prefix=PREFIX,
                   splits=fd.split_plan(S, Hkv, L, tiles)[0],
                   max_abs_err=err, ms=_device_ms(kern, True),
                   warm_ms=_device_ms(kern, False),
                   plain_ms=_device_ms(plain, True, iters=5, warmup=1),
                   bound_ms=bound, bound_by=bound_by,
                   library_ms=_device_ms(lib_call, True),
                   library_warm_ms=_device_ms(lib_call, False),
                   library_err=lib_err)
        print("chunk_case " + json.dumps(row), flush=True)
        if store == "f32":
            out[tag] = row
    return out


def _top2_gap(model, tokens):
    with torch.inference_mode():
        lg = model(torch.tensor([tokens], device=DEV))[0, -1].float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def _plain_decode_attention(kv):
    """K3's two entry points as their plain versions (the wrappers'
    signatures, ``block_k`` unused): ``(rows, chunk)``."""
    def rows(q, kl, vl, slots, lengths, scale=None, *, k_scale=None,
             v_scale=None, prefix_slots=None, prefix_lens=None, block_k=128):
        return kv.attend_rows(q, kl, vl, slots, lengths, scale,
                              k_scale=k_scale, v_scale=v_scale,
                              prefix_slots=prefix_slots,
                              prefix_lens=prefix_lens)

    def chunk(q, cl, slots, lengths, scale=None, *, prefix_slots=None,
              prefix_lens=None, block_k=128):
        return kv.attend_chunk(q, cl, slots, lengths, scale,
                               prefix_slots=prefix_slots,
                               prefix_lens=prefix_lens)
    return rows, chunk


def _stream_gate(name, model, got, want, layers_mod=None, top_k=None):
    """Requests ``got`` must generate what ``want`` generated, request by
    request, or first diverge at a near tie of the cache-free forward: a
    top-2 logit gap below 1e-3, or (``layers_mod`` given, MoE) a router
    whose k-th and (k+1)-th probabilities lie within 1e-5 at some layer
    and position up to there.  Returns the divergences."""
    diverged = []
    for r_a, r_b in zip(got, want):
        if r_a.generated == r_b.generated:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r_a.generated,
                                                  r_b.generated)) if a != b)
        seq = r_a.prompt + r_a.generated[:i]
        d = {"request": r_a.id, "position": i,
             "top2_gap": _top2_gap(model, seq)}
        if layers_mod is not None:
            d["router_gap"] = _router_tie(model, layers_mod, seq, top_k)
        diverged.append(d)
        if d["top2_gap"] >= 1e-3 and d.get("router_gap", 1.0) >= 1e-5:
            raise AssertionError(f"{name}: streams diverge at request "
                                 f"{r_a.id} token {i}: {d}")
    return diverged


def serve_phase(fd, kv, name, model, cfg, kv_dtype, n_req, max_new):
    """Phase 3: one full-width drain, its launch count, and the replay."""
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    scfg = ServeConfig(slots=8, max_len=1024, batch_buckets=(1, 2, 4, 8),
                       prefill_buckets=(64, 256, 512),
                       decode_steps_per_call=4, decode_kernel="pallas",
                       decode_block_k=BK, kv_dtype=kv_dtype)
    engine = ServeEngine(cfg, model, scfg, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, n_req)]
    sched = Scheduler(engine)
    fd.flash_decode_cuda.launches = 0
    t0 = time.monotonic()
    for p in prompts:
        sched.submit(p, max_new_tokens=max_new)
    sched.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fd.flash_decode_cuda.launches
    reqs = sorted(sched.completed, key=lambda r: r.id)
    if len(reqs) != n_req or any(len(r.generated) != max_new for r in reqs):
        raise AssertionError(f"{name}: {len(reqs)}/{n_req} requests done")
    if launches != cfg.layers * sched.decode_steps or launches == 0:
        raise AssertionError(
            f"{name}: flash decode launched {launches} times, want layers "
            f"{cfg.layers} x decode steps {sched.decode_steps}")
    # the engine's first token of request 0 against the dense forward
    gap0 = _top2_gap(model, prompts[0])
    with torch.inference_mode():
        ref0 = int(torch.argmax(model(torch.tensor(
            [prompts[0]], device=DEV))[0, -1]))
    if reqs[0].generated[0] != ref0 and gap0 >= 1e-3:
        raise AssertionError(f"{name}: first token {reqs[0].generated[0]} "
                             f"!= dense forward's {ref0}")
    # replay the first 4 with decode attention forced to the plain version
    plain_rows, _ = _plain_decode_attention(kv)
    with mock.patch.object(fd, "flash_attend_rows", plain_rows):
        replay = Scheduler(engine)
        for p in prompts[:4]:
            replay.submit(p, max_new_tokens=max_new)
        before = fd.flash_decode_cuda.launches
        replay.drain()
        if fd.flash_decode_cuda.launches != before:
            raise AssertionError("replay launched the kernel")
    diverged = _stream_gate(name, model, reqs[:4], sorted(
        replay.completed, key=lambda r: r.id))
    tokens = sum(len(r.generated) for r in reqs)
    summary = {
        "run": name, "kv_dtype": kv_dtype, "requests": n_req,
        "max_new_tokens": max_new, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "mean_ttft_s": float(np.mean([r.ttft for r in reqs])),
        "decode_calls": sched.decode_calls,
        "decode_steps": sched.decode_steps,
        "decode_ms_per_step": 1e3 * sched.decode_seconds
        / sched.decode_steps,
        "decode_ms_per_token": 1e3 * sched.decode_seconds
        / (tokens - n_req),
        "kernel_launches": launches, "replay_diverged": diverged,
        "device": torch.cuda.get_device_name(0),
    }
    print("serve " + json.dumps(summary), flush=True)
    return engine, launches


def fast_serve_phase(fd, kv, name, model, cfg, smi, *, pp, spec, n_req,
                     max_new, gf=None, layers_mod=None):
    """Phases 13 (dense) and 8b (MoE, ``gf`` / ``layers_mod`` given): the
    serving fast path at full width, ``ServeEngine(pp=pp)`` with
    ``spec_decode=spec`` (draft: the first of ``pp`` stages) and 4 prefix
    pages of 128 tokens, over ``n_req`` greedy requests that share one
    seeded 256-token system prompt (own suffixes of 16-128 tokens).
    Gates: every request completes; one seal and ``n_req - 1`` prefix
    hits; K3's launches by form equal what the path must launch (rows:
    rounds x k x draft layers; chunk: (rounds + chunk prefills) x
    layers), and for MoE K4's (layers x (rounds + chunk prefills +
    seals)); the streams equal a plain drain of the same prompts (no
    spec, no prefix pages, 4 steps a call) up to near ties; for the dense
    cell, 4 requests replayed with both K3 entry points forced to their
    plain versions give the same streams and launch nothing.  Returns the
    summary."""
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    from bluefog_tpu_torch.utils import metrics as _metrics
    base = dict(slots=8, max_len=1024, batch_buckets=(1, 2, 4, 8),
                prefill_buckets=(64, 256, 512), decode_kernel="pallas",
                decode_block_k=BK)
    if gf is not None:
        base.update(moe_experts=cfg.num_experts, moe_top_k=cfg.top_k)
    engine = ServeEngine(cfg, model, ServeConfig(
        spec_decode=spec, spec_stages=1, prefix_pages=4,
        prefix_page_tokens=128, **base), pp=pp, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    rng = np.random.default_rng(13)
    system = rng.integers(0, cfg.vocab, PREFIX).tolist()
    prompts = [system + rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, 129, n_req)]

    def drain(eng, batch):
        sched = Scheduler(eng)
        t0 = time.monotonic()
        for p in batch:
            sched.submit(p, max_new_tokens=max_new)
        sched.drain()
        torch.cuda.synchronize()
        return sched, time.monotonic() - t0

    form = {"rows": 0, "chunk": 0}

    def counting(key, fn):
        def call(*a, **kw):
            before = fd.flash_decode_cuda.launches
            out = fn(*a, **kw)
            form[key] += fd.flash_decode_cuda.launches - before
            return out
        return call

    counted = ("bluefog_serve_prefix_hits_total",
               "bluefog_serve_spec_drafted_total",
               "bluefog_serve_spec_accepted_total")
    c0 = {n: _metrics.counter(n).total() for n in counted}
    fd.flash_decode_cuda.launches = 0
    with contextlib.ExitStack() as stack:
        if gf is not None:
            gf.grouped_ffn_cuda.launches = 0
            gf.grouped_ffn_cuda.gemm_launches = 0
            routed = stack.enter_context(_k4_route_tally(gf))
        stack.enter_context(mock.patch.object(
            fd, "flash_attend_rows", counting("rows", fd.flash_attend_rows)))
        stack.enter_context(mock.patch.object(
            fd, "flash_attend_chunk",
            counting("chunk", fd.flash_attend_chunk)))
        sched, wall = drain(engine, prompts)
    if gf is not None:
        _gate_k4_routes(name, gf, routed)
    hits, drafted, accepted = (int(_metrics.counter(n).total() - c0[n])
                               for n in counted)
    k3 = fd.flash_decode_cuda.launches
    k4 = gf.grouped_ffn_cuda.launches if gf is not None else None
    reqs = sorted(sched.completed, key=lambda r: r.id)
    if len(reqs) != n_req or any(len(r.generated) != max_new for r in reqs):
        raise AssertionError(f"{name}: {len(reqs)}/{n_req} requests done")
    chunks = sum(r.prefix_row >= 0 for r in reqs)
    seals = chunks - sum(r.prefix_hit for r in reqs)
    if (seals, hits, chunks) != (1, n_req - 1, n_req):
        raise AssertionError(f"{name}: {seals} seals, {hits} prefix hits, "
                             f"{chunks} chunk prefills; want 1, "
                             f"{n_req - 1}, {n_req}")
    rounds, layers, dl = sched.decode_calls, cfg.layers, engine.draft.layers
    want = {"rows": rounds * spec * dl, "chunk": (rounds + chunks) * layers}
    if form != want or k3 != sum(want.values()):
        raise AssertionError(
            f"{name}: K3 launched {form} ({k3} in all), want rows = rounds "
            f"{rounds} x k {spec} x draft layers {dl}, chunk = (rounds + "
            f"chunk prefills {chunks}) x layers {layers}: {want}")
    if gf is not None and k4 != layers * (rounds + chunks + seals):
        raise AssertionError(f"{name}: K4 launched {k4} times, want layers "
                             f"x (rounds + chunk prefills + seals)")
    plain = ServeEngine(cfg, model, ServeConfig(decode_steps_per_call=4,
                                                **base), device=DEV)
    plain.warmup()
    psched, plain_wall = drain(plain, prompts)
    del plain
    preqs = sorted(psched.completed, key=lambda r: r.id)
    diverged = _stream_gate(name, model, reqs, preqs, layers_mod,
                            getattr(cfg, "top_k", None))
    replay_div = None
    if gf is None:
        rows_fn, chunk_fn = _plain_decode_attention(kv)
        with mock.patch.object(fd, "flash_attend_rows", rows_fn), \
                mock.patch.object(fd, "flash_attend_chunk", chunk_fn):
            before = fd.flash_decode_cuda.launches
            replay, _ = drain(engine, prompts[:4])
            if fd.flash_decode_cuda.launches != before:
                raise AssertionError(f"{name}: the plain replay launched K3")
        replay_div = _stream_gate(
            name + " replay", model, reqs[:4],
            sorted(replay.completed, key=lambda r: r.id))
    tokens = sum(len(r.generated) for r in reqs)

    def mean(xs):
        return float(np.mean(xs)) if xs else None
    hit = [r for r in reqs if r.prefix_hit]
    cold = [r for r in reqs if not r.prefix_hit]
    summary = {
        "run": name, "pp": pp, "draft_layers": dl, "layers": layers,
        "spec_decode": spec, "prefix_pages": 4, "prefix_page_tokens": 128,
        "requests": n_req, "max_new_tokens": max_new, "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "mean_ttft_hit_s": mean([r.ttft for r in hit]),
        "mean_ttft_cold_s": mean([r.ttft for r in cold]),
        "mean_prefill_hit_s": mean([r.first_token_at - r.admitted_at
                                    for r in hit]),
        "mean_prefill_cold_s": mean([r.first_token_at - r.admitted_at
                                     for r in cold]),
        "decode_calls": rounds, "decode_seconds": sched.decode_seconds,
        "drafted": drafted,
        "accepted": accepted,
        "acceptance_rate": accepted / max(drafted, 1),
        "prefix_hits": hits, "seals": seals, "chunk_prefills": chunks,
        "k3_launches": dict(form, total=k3),
        "k3_formula": "rows = rounds x k x draft layers; chunk = (rounds + "
                      "chunk prefills) x layers",
        "k4_launches": k4,
        "kv_cache_bytes": engine.cache_cfg.bytes(),
        "kv_bytes_per_token": engine.cache_cfg.bytes_per_token(),
        "plain": {"tokens_per_s": tokens / plain_wall,
                  "wall_s": plain_wall,
                  "mean_ttft_s": mean([r.ttft for r in preqs]),
                  "mean_prefill_s": mean([r.first_token_at - r.admitted_at
                                          for r in preqs]),
                  "decode_calls": psched.decode_calls},
        "stream_diverged": diverged, "replay_diverged": replay_div,
        "weights": "random (seed 0): the acceptance rate says nothing of "
                   "a trained model",
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    }
    print("serve_fast " + json.dumps(summary), flush=True)
    del engine
    torch.cuda.empty_cache()
    return summary


def _redraw_replica(params, r, seed):
    """Replica ``r``'s every weight drawn anew on the card (N(0, 0.1), the
    init's scale, from ``seed``): the replicas serve different models, so
    a lane that read another replica's weights or cache rows would show."""
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    with torch.no_grad():
        for _, t in params.tensors():
            t[r].normal_(0.0, 0.1, generator=g)


def _capture(store, key, fn):
    """``fn`` passing through, its first call's arguments kept."""
    def call(*a, **kw):
        store.setdefault(key, (a, kw))
        return fn(*a, **kw)
    return call


def _carved_k3_case(fd, kv, args, kw):
    """K3 at the carved decode shape, on one launch's captured arguments:
    against its plain version (atol 1e-4), timed cold and warm, its plain
    version, its bound and SDPA over pre-gathered pages."""
    q, kl, vl, slots, lens = args
    pre = {k: kw[k] for k in ("prefix_slots", "prefix_lens")
           if kw.get(k) is not None}
    scales = {k: kw[k] for k in ("k_scale", "v_scale")
              if kw.get(k) is not None}

    def kern():
        return fd.flash_attend_rows(q, kl, vl, slots, lens,
                                    block_k=kw["block_k"], **scales, **pre)

    def plain():
        return kv.attend_rows(q, kl, vl, slots, lens, **scales, **pre)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (err <= 1e-4 and bool(torch.isfinite(got).all())):
        raise AssertionError(f"flash decode at the carved decode shape "
                             f"disagrees with its plain version: {err}")
    S, Hq, dh = q.shape
    Hkv = kl.shape[1]
    cl = {"k": kl, "v": vl, **scales}
    lib_call, lib_err = _sdpa_yardstick(kv, q[:, None], cl, slots, lens,
                                        pre, want[:, None])
    bound, bound_by = _bound_ms(lens.cpu().numpy(), 1, Hkv, Hq // Hkv,
                                kl.element_size(), q.element_size(),
                                bool(scales), S, dh)
    row = dict(case="carved_decode", S=S, Hkv=Hkv, rows=kl.shape[0],
               T=1, store=str(kl.dtype)[6:],
               splits=fd.split_plan(S, Hkv, L)[0], max_abs_err=err,
               ms=_device_ms(kern, True), warm_ms=_device_ms(kern, False),
               plain_ms=_device_ms(plain, True), bound_ms=bound,
               bound_by=bound_by, library_ms=_device_ms(lib_call, True),
               library_warm_ms=_device_ms(lib_call, False),
               library_err=lib_err)
    print("kernel_case " + json.dumps(row), flush=True)
    return row


def _carved_k4_case(gf, args, kw):
    """K4 at the carved decode shape, on one call's captured arguments
    (every owner's buffer, trash tiles marked -1, the stacked-peer
    weights): against its plain version (1e-4 x max|plain|), timed cold
    and warm, its plain version, its bound and the cuBLAS yardstick over
    the live tiles' weights gathered beforehand."""
    import torch.nn.functional as F
    xt, eid, w1, w2 = args
    rows = kw.get("rows")

    def kern():
        return gf.grouped_ffn(xt, eid, w1, w2, rows=rows)

    def plain():
        return gf.grouped_ffn_plain(xt, eid, w1, w2)

    before = gf.grouped_ffn_cuda.launches
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if gf.grouped_ffn_cuda.launches != before + 1:
        raise AssertionError("grouped_ffn at the carved decode shape: the "
                             "kernel did not launch")
    diff = (got - want).abs()
    err, top = float(diff.max()), float(want.abs().max())
    trash = eid < 0
    if not (err <= 1e-4 * top and bool(torch.isfinite(got).all())
            and bool((got[trash] == 0).all())):
        raise AssertionError(f"grouped_ffn at the carved decode shape "
                             f"disagrees with its plain version: {err} "
                             f"(1e-4 x max|plain| = {1e-4 * top})")
    live = ~trash
    D, Fd = w1.shape[-2], w1.shape[-1]
    idx, xl = eid[live].long(), xt[live]
    w1g = w1.reshape(-1, D, Fd)[idx]
    w2g = w2.reshape(-1, Fd, D)[idx]

    def lib():
        return torch.bmm(F.gelu(torch.bmm(xl, w1g), approximate="tanh"),
                         w2g)

    bound, bound_by = _k4_bound(xt, eid, w1)
    G, tile, _ = xt.shape
    row = dict(case="carved_decode", G=G, tile=tile, D=D, F=Fd,
               owners=w1.shape[0], experts_per_owner=w1.shape[1],
               trash_tiles=int(trash.sum()), rows_hint=rows,
               experts_named=int(torch.unique(eid[live]).numel()),
               max_abs_err=err, max_abs_plain=top,
               ms=_device_ms(kern, True), warm_ms=_device_ms(kern, False),
               plain_ms=_device_ms(plain, True, iters=5, warmup=1),
               bound_ms=bound, bound_by=bound_by,
               library_ms=_device_ms(lib, True),
               library_warm_ms=_device_ms(lib, False),
               library="cuBLAS torch.bmm + gelu + torch.bmm over "
                       "pre-gathered weights")
    print("kernel_case " + json.dumps(row), flush=True)
    del w1g, w2g
    return row


def carved_serve_phase(fd, kv, smi, gf=None, layers_mod=None,
                       profile=False):
    """Phases 3c (dense, dp 2 x pp 2 x tp 2) and 8c (MoE, ``gf`` given:
    dp 2 x tp 2 x ep 2): one drain of the carved engine at full width,
    its launch counts, each replica against the carving-1 engine on its
    joined weights, the plain-kernel replay, and the carved decode
    shapes' kernel cases.  Returns ``(summary, k3_row, k4_row)``."""
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    moe = gf is not None
    name = "serve_moe_carved" if moe else "serve_carved"
    t0 = time.monotonic()
    if moe:
        cfg = moe_model.MoELMConfig(
            vocab=32768, d_model=1024, heads=16, layers=8, ffn_mult=4,
            num_experts=8, top_k=2, dispatch="dropless", group_tile=8)
        m = compose.compose_parallelism(2, 1, 2, 1, 2, num_experts=8,
                                        device=DEV)
        params = moe_model.moe_params_from_jax(
            moe_model.init_moe_train_params(cfg, m, seed=0), cfg, m=m)
        extra = dict(moe_experts=8, moe_top_k=2, moe_ep=2)
    else:
        cfg = compose.LMConfig(vocab=32768, d_model=1024, heads=16,
                               layers=8, ffn_mult=4)
        m = compose.compose_parallelism(2, 2, 2, device=DEV)
        params = compose.params_from_jax(
            compose.init_lm_train_params(cfg, m, seed=0), cfg, m=m)
        extra = {}
    torch.cuda.empty_cache()
    _redraw_replica(params, 1, seed=1)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    scfg = dict(slots=8, max_len=1024, batch_buckets=(1, 2, 4, 8),
                prefill_buckets=(64, 256, 512), decode_steps_per_call=4,
                decode_kernel="pallas", decode_block_k=BK, **extra)
    engine = ServeEngine(cfg, params, ServeConfig(**scfg), device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    n_req, max_new = 16, 64
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, n_req)]
    sched = Scheduler(engine)
    fd.flash_decode_cuda.launches = 0
    t0 = time.monotonic()
    with contextlib.ExitStack() as stack:
        if moe:
            gf.grouped_ffn_cuda.launches = 0
            gf.grouped_ffn_cuda.gemm_launches = 0
            routed = stack.enter_context(_k4_route_tally(gf))
        for p in prompts:
            sched.submit(p, max_new_tokens=max_new)
        sched.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    k3 = fd.flash_decode_cuda.launches
    k4 = gf.grouped_ffn_cuda.launches if moe else None
    if moe:
        _gate_k4_routes(name, gf, routed)
    reqs = sorted(sched.completed, key=lambda r: r.id)
    if len(reqs) != n_req or any(len(r.generated) != max_new for r in reqs):
        raise AssertionError(f"{name}: {len(reqs)}/{n_req} requests done")
    steps = sched.decode_steps
    if k3 != cfg.layers * steps or k3 == 0:
        raise AssertionError(f"{name}: flash decode launched {k3} times, "
                             f"want layers {cfg.layers} x decode steps "
                             f"{steps} (one launch for both replicas and "
                             "tp peers)")
    if moe and k4 != cfg.layers * (n_req + steps):
        raise AssertionError(f"{name}: grouped_ffn launched {k4} times, "
                             f"want layers {cfg.layers} x (prefills "
                             f"{n_req} + decode steps {steps})")
    per = [[r for r in reqs if r.replica == i] for i in range(m.dp)]
    if not all(per):
        raise AssertionError(f"{name}: a replica served no request")
    load = engine.moe_load() if moe else None
    if moe and len(load) != m.dp:
        raise AssertionError(f"{name}: moe_load() has {len(load)} entries, "
                             f"want one per replica ({m.dp})")
    # the carved decode shapes' kernel cases, on one decode call's own
    # arguments at the full bucket (every lane live, lengths spread)
    S = scfg["batch_buckets"][-1]
    lanes = np.tile(np.arange(S, dtype=np.int32), (m.dp, 1))
    lens = np.tile(np.linspace(32, 900, S).astype(np.int32), (m.dp, 1))
    seen = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            fd, "flash_attend_rows", _capture(seen, "k3",
                                              fd.flash_attend_rows)))
        if moe:
            stack.enter_context(mock.patch.object(
                gf, "grouped_ffn", _capture(seen, "k4", gf.grouped_ffn)))
        engine.decode(np.zeros((m.dp, S), np.int32), lanes, lens)
    torch.cuda.synchronize()
    k3_row = _carved_k3_case(fd, kv, *seen["k3"])
    k4_row = _carved_k4_case(gf, *seen["k4"]) if moe else None
    del seen
    if profile:
        profile_phase(engine, "profile_" + name,
                      shares=("expert_rows", "forward_gemm",
                              "flash_decode") if moe
                      else ("flash_decode",))
    # each replica against the carving of size 1 on its joined weights
    models, diverged = [], {}
    top_k = cfg.top_k if moe else None
    one_cfg = ServeConfig(**dict(scfg, moe_ep=1) if moe else scfg)
    for i in range(m.dp):
        joined = params.replica(i)
        one = ServeEngine(cfg, joined, one_cfg, device=DEV)
        one.warmup()
        ref = Scheduler(one)
        for r in per[i]:
            ref.submit(r.prompt, max_new_tokens=max_new)
        ref.drain()
        want = sorted(ref.completed, key=lambda r: r.id)
        diverged[i] = _stream_gate(f"{name} replica {i}", joined, per[i],
                                   want, layers_mod, top_k)
        models.append(joined)
        del one, ref
        torch.cuda.empty_cache()
    # the first 4 replayed with the kernel forced to its plain version
    if moe:
        patch = mock.patch.object(gf, "grouped_ffn",
                                  gf.grouped_ffn_plain_by_expert)
        count = gf.grouped_ffn_cuda
    else:
        patch = mock.patch.object(fd, "flash_attend_rows",
                                  _plain_decode_attention(kv)[0])
        count = fd.flash_decode_cuda
    with patch:
        replay = Scheduler(engine)
        for p in prompts[:4]:
            replay.submit(p, max_new_tokens=max_new)
        before = count.launches
        replay.drain()
        if count.launches != before:
            raise AssertionError(f"{name}: the plain replay launched the "
                                 "kernel")
    replay_div = []
    for a, b in zip(reqs[:4], sorted(replay.completed, key=lambda r: r.id)):
        if a.replica != b.replica:
            raise AssertionError(f"{name}: the replay admitted request "
                                 f"{a.id} to replica {b.replica}, not "
                                 f"{a.replica}")
        replay_div += _stream_gate(f"{name} replay", models[a.replica],
                                   [a], [b], layers_mod, top_k)
    tokens = sum(len(r.generated) for r in reqs)
    cc = engine.cache_cfg
    summary = {
        "run": name, "dp": m.dp, "pp": m.pp, "tp": m.tp, "ep": m.ep,
        "requests": n_req, "max_new_tokens": max_new, "tokens": tokens,
        "wall_s": wall, "tokens_per_s": tokens / wall,
        "mean_ttft_s": float(np.mean([r.ttft for r in reqs])),
        "decode_calls": sched.decode_calls, "decode_steps": steps,
        "decode_ms_per_step": 1e3 * sched.decode_seconds / steps,
        "decode_ms_per_token": 1e3 * sched.decode_seconds
        / (tokens - n_req),
        "requests_per_replica": [len(p) for p in per],
        "k3_launches": k3, "k4_launches": k4,
        "k3_formula": "layers x decode steps",
        "k4_formula": "layers x (prefills + decode steps)" if moe else None,
        "decode_tile": engine._moe_tile if moe else None,
        "trash_tiles_per_decode_call": k4_row["trash_tiles"] if moe
        else None,
        "tiles_per_decode_call": k4_row["G"] if moe else None,
        "moe_load_replicas": len(load) if moe else None,
        "kv_cache_bytes": cc.bytes() * m.dp * m.tp, "init_s": init_s,
        "stream_diverged": diverged, "replay_diverged": replay_div,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
    }
    print(f"{name} " + json.dumps(summary), flush=True)
    del engine, params, models
    torch.cuda.empty_cache()
    return summary, k3_row, k4_row


def profile_phase(engine, tag="profile", shares=()):
    """One fused decode call at the full batch bucket: its wall time
    unprofiled (mean of 3), then its device time by kernel under
    torch.profiler (kernel events only: the CPU ops that launch them carry
    the same device time), the device's busy share of the call, and the
    share of device time of each kernel whose name holds one of
    ``shares``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    S, R = engine.scfg.batch_buckets[-1], engine.replicas
    lens = np.tile(np.linspace(32, 900, S).astype(np.int32), (R, 1))
    toks = np.zeros((R, S), np.int32)
    slots = np.tile(np.arange(S, dtype=np.int32), (R, 1))
    engine.decode(toks, slots, lens)
    t0 = time.monotonic()
    for _ in range(3):
        engine.decode(toks, slots, lens)
    wall_ms = 1e3 * (time.monotonic() - t0) / 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.decode(toks, slots, lens)
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:12]:
        print(f"{tag} " + json.dumps({"kernel": key[:90], "calls": count,
                                      "device_us": dt,
                                      "share": dt / total_us}))
    print(f"{tag} " + json.dumps({
        "steps": engine.scfg.decode_steps_per_call, "lanes": S,
        "replicas": R,
        "decode_call_wall_ms": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "kernel_shares": {name: sum(r[0] for r in rows if name in r[1])
                          / total_us for name in shares},
        "device": torch.cuda.get_device_name(0)}), flush=True)


# -- phases 4-6: flash attention, ring attention, the trainer ------------

def _visible_pairs(Tq, Tk, q_offset, k_offset, causal, window):
    """(query, key) pairs the masks keep: the work K1/K2 must do."""
    if not causal:
        return Tq * Tk
    d0 = q_offset + np.arange(Tq) - k_offset        # key j visible iff
    hi = np.minimum(d0, Tk - 1)                      # 0 <= d0 - j < window
    lo = np.maximum(d0 - window + 1, 0) if window else np.zeros_like(d0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attn_bound(B, Tq, Tk, H, Hkv, D, item, pairs, backward, rate=None):
    """Least time: inputs read once and outputs written once against the
    operations (2 FLOP per multiply-add; K1 has 2 products per visible
    pair, K2 5) at the rate of f32-accurate products on the tensor cores
    (3xTF32), or the bf16 tensor-core rate for bf16 inputs (the same exact
    products); ``rate`` overrides it."""
    q_b, kv_b, rows = B * Tq * H * D, B * Tk * Hkv * D, B * Tq * H
    if backward:       # q, k, v, do (f32), lse, delta -> dq, dk, dv (f32)
        nbytes = (q_b + 2 * kv_b) * item + q_b * 4 + 2 * rows * 4 \
            + (q_b + 2 * kv_b) * 4
        flops = 10.0 * B * H * pairs * D
    else:              # q, k, v -> o, l, m (f32)
        nbytes = (q_b + 2 * kv_b) * item + q_b * 4 + 2 * rows * 4
        flops = 4.0 * B * H * pairs * D
    rate = rate or (BF16_FLOPS if item == 2 else TF32X3_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _grad_err(got, want):
    """max |got - want| and whether it is within 1e-4 x max|want|."""
    err = float((got - want).abs().max())
    return err, err <= 1e-4 * float(want.abs().max()) + 1e-6


def _check_partial(got, want, o_scale=1.0, m_scale=1.0):
    """Phase-4 forward tolerances (``o_scale`` / ``m_scale`` times the
    atol of o/l and of m, for inputs far from unit scale); returns the max
    abs error of o/l."""
    (o, l, m), (wo, wl, wm) = got, want
    if not torch.equal(torch.isneginf(m), torch.isneginf(wm)):
        raise AssertionError("flash_fwd: m is -inf on other rows than the "
                             "plain version's")
    fin = ~torch.isneginf(wm)
    zero = torch.zeros_like(m)
    m_err = float((torch.where(fin, m, zero) - torch.where(fin, wm, zero))
                  .abs().max())
    l_ok = bool(((l - wl).abs() <= 1e-4 * wl.abs()).all())
    den = torch.where(wl == 0, torch.ones_like(wl), wl)[..., None]
    o_err = float((o / den - wo / den).abs().max())
    if not (o_err <= 1e-4 * o_scale and l_ok and m_err <= 1e-5 * m_scale
            and bool(torch.isfinite(o).all())):
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"o/l err {o_err} (atol {1e-4 * o_scale}), l "
                             f"within rtol 1e-4: {l_ok}, m err {m_err} "
                             f"(atol {1e-5 * m_scale})")
    return o_err


def attention_phase(fa):
    """Phase 4: K1 and K2 against their plain versions; returns the rows
    of the trainer's shape (B 4, T 2048, 16 heads, head_dim 64, causal,
    f32)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    T = 2048
    cases = [(B, Hkv, D, causal, dt, 0, 0, 0)
             for B in (1, 4) for Hkv in (16, 4) for D in (64, 128)
             for causal in (True, False)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(4, 16, 64, True, torch.float32, 2048, 0, 0),
              (4, 16, 64, True, torch.float32, 2048, 4096, 0),
              (4, 16, 64, True, torch.float32, 0, 0, 512)]
    main = None
    for B, Hkv, D, causal, dt, qoff, koff, window in cases:
        def t(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(DEV)
        q, k, v = (t(B, T, H, D).to(dt), t(B, T, Hkv, D).to(dt),
                   t(B, T, Hkv, D).to(dt))
        do = t(B, T, H, D)
        kw = dict(causal=causal, scale=D ** -0.5, window=window)
        want = fa.attention_block_partial_plain(q, k, v, qoff, koff, **kw)
        fwd_err = _check_partial(
            fa.attention_block_partial(q, k, v, qoff, koff, **kw), want)
        wo, wl, wm = want
        den = torch.where(wl == 0, torch.ones_like(wl), wl)
        out = wo / den[..., None]
        lse = torch.where(wl == 0, torch.full_like(wl, float("-inf")),
                          wm + torch.log(den))
        delta = (do * out).sum(-1)
        del want, wo, out
        got = fa.attention_block_backward(q, k, v, do, lse, delta, qoff,
                                          koff, **kw)
        wgrads = fa.attention_block_backward_plain(q, k, v, do, lse, delta,
                                                   qoff, koff, **kw)
        bwd_err = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), got, wgrads):
            err, ok = _grad_err(a, b)
            bwd_err = max(bwd_err, err)
            if not ok:
                raise AssertionError(
                    f"flash_bwd {name} disagrees with its plain version: "
                    f"max abs err {err} > 1e-4 x max|plain| "
                    f"{float(b.abs().max())}")
        del got, wgrads
        torch.cuda.synchronize()
        fwd_ms = _cuda_ms(lambda: fa.attention_block_partial(
            q, k, v, qoff, koff, **kw), iters=10, warmup=2)
        fwd_plain = _cuda_ms(lambda: fa.attention_block_partial_plain(
            q, k, v, qoff, koff, **kw), iters=3, warmup=1)
        bwd_ms = _cuda_ms(lambda: fa.attention_block_backward(
            q, k, v, do, lse, delta, qoff, koff, **kw), iters=5, warmup=1)
        bwd_plain = _cuda_ms(lambda: fa.attention_block_backward_plain(
            q, k, v, do, lse, delta, qoff, koff, **kw), iters=3, warmup=1)
        # the library yardstick: SDPA on [B, H, T, D] with the same mask
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa = dict(scale=D ** -0.5, enable_gqa=Hkv != H)
        if causal and (qoff, koff, window) == (0, 0, 0):
            sdpa["is_causal"] = True
        elif causal:
            sdpa["attn_mask"] = fa._keep(T, T, qoff, koff, window, DEV)
        doh = do.to(dt).transpose(1, 2)

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qh, kh, vh, **sdpa)

        def lib_fwd_bwd():
            F.scaled_dot_product_attention(qh, kh, vh, **sdpa).backward(doh)

        kept = F.scaled_dot_product_attention(qh, kh, vh, **sdpa)

        def lib_bwd():                     # the backward alone, graph kept
            torch.autograd.grad(kept, (qh, kh, vh), doh, retain_graph=True)

        lib_fwd_ms = _cuda_ms(lib_fwd, iters=5, warmup=1)
        lib_bwd_ms = _cuda_ms(lib_bwd, iters=5, warmup=1)
        lib_fwd_bwd_ms = _cuda_ms(lib_fwd_bwd, iters=5, warmup=1)
        del qh, kh, vh, kept
        pairs = _visible_pairs(T, T, qoff, koff, causal, window)
        item = q.element_size()
        fb, fby = _attn_bound(B, T, T, H, Hkv, D, item, pairs, False)
        bb, bby = _attn_bound(B, T, T, H, Hkv, D, item, pairs, True)
        row = dict(B=B, T=T, Hkv=Hkv, D=D, causal=causal,
                   dtype=str(dt)[6:], q_offset=qoff, k_offset=koff,
                   window=window, fwd=dict(
                       max_abs_err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain,
                       bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
                       library="SDPA forward"),
                   bwd=dict(max_abs_err=bwd_err, ms=bwd_ms,
                            plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
                            library_ms=lib_bwd_ms,
                            library="SDPA backward on a kept graph",
                            library_fwd_bwd_ms=lib_fwd_bwd_ms))
        if item == 4:       # the yardstick of PR 2-3: f32 on the CUDA cores
            row["fwd"]["bound_ms_simt"] = _attn_bound(
                B, T, T, H, Hkv, D, item, pairs, False, F32_FLOPS)[0]
            row["bwd"]["bound_ms_simt"] = _attn_bound(
                B, T, T, H, Hkv, D, item, pairs, True, F32_FLOPS)[0]
        print("kernel_case " + json.dumps(row), flush=True)
        if (B, Hkv, D, causal, dt, qoff, koff, window) == \
                (4, 16, 64, True, torch.float32, 0, 0, 0):
            main = row
    return main


def head_dim_phase(fa):
    """Phase 4b: K1/K2 at head_dim 8 (zero-padded to the built 64 by the
    wrappers), 64, 128 and 256 (the widest built instance: 32-row tiles,
    two column halves) on the trainer's shape (B 4, T 2048, 16 heads,
    causal, f32), checked against the plain versions at phase 4's
    tolerances and timed side by side with their bounds: the cost of the
    padding and of the D-256 shape.  Returns the D-256 row."""
    rng = np.random.default_rng(9)
    B, T = 4, 2048
    rows = {}
    for D in (8, 64, 128, 256):
        q, k, v, do = (torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(
            np.float32)).to(DEV) for _ in range(4))
        kw = dict(causal=True, scale=D ** -0.5)
        want = fa.attention_block_partial_plain(q, k, v, 0, 0, **kw)
        fwd_err = _check_partial(fa.attention_block_partial(q, k, v, 0, 0,
                                                            **kw), want)
        wo, wl, wm = want
        lse = wm + torch.log(wl)
        delta = (do * wo / wl[..., None]).sum(-1)
        del want, wo
        got = fa.attention_block_backward(q, k, v, do, lse, delta, 0, 0,
                                          **kw)
        wgrads = fa.attention_block_backward_plain(q, k, v, do, lse, delta,
                                                   0, 0, **kw)
        bwd_err = 0.0
        for a, b in zip(got, wgrads):
            err, ok = _grad_err(a, b)
            bwd_err = max(bwd_err, err)
            if not ok:
                raise AssertionError(f"flash_bwd at head_dim {D} disagrees "
                                     f"with its plain version: {err}")
        del got, wgrads
        torch.cuda.synchronize()
        pairs = _visible_pairs(T, T, 0, 0, True, 0)
        fb, fby = _attn_bound(B, T, T, H, H, D, 4, pairs, False)
        bb, bby = _attn_bound(B, T, T, H, H, D, 4, pairs, True)
        rows[D] = dict(
            D=D, fwd_err=fwd_err, bwd_err=bwd_err,
            fwd_ms=_cuda_ms(lambda: fa.attention_block_partial(
                q, k, v, 0, 0, **kw), iters=10, warmup=2),
            bwd_ms=_cuda_ms(lambda: fa.attention_block_backward(
                q, k, v, do, lse, delta, 0, 0, **kw), iters=5, warmup=1),
            fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
            bwd_bound_by=bby)
        if D == 256:
            rows[D]["fwd_plain_ms"] = _cuda_ms(
                lambda: fa.attention_block_partial_plain(q, k, v, 0, 0,
                                                         **kw),
                iters=2, warmup=1)
            rows[D]["bwd_plain_ms"] = _cuda_ms(
                lambda: fa.attention_block_backward_plain(
                    q, k, v, do, lse, delta, 0, 0, **kw), iters=2, warmup=1)
        del q, k, v, do, lse, delta
        torch.cuda.empty_cache()
    print("head_dim_case " + json.dumps({
        "kernel": "flash_fwd/flash_bwd", "B": B, "T": T, "H": H,
        "causal": True, "cases": list(rows.values()),
        "fwd_ratio_d8_over_d64": rows[8]["fwd_ms"] / rows[64]["fwd_ms"],
        "bwd_ratio_d8_over_d64": rows[8]["bwd_ms"] / rows[64]["bwd_ms"],
        "fwd_ratio_d256_over_d128": rows[256]["fwd_ms"]
        / rows[128]["fwd_ms"],
        "bwd_ratio_d256_over_d128": rows[256]["bwd_ms"]
        / rows[128]["bwd_ms"],
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return rows[256]


def ring_phase(fa, ring):
    """Phase 5: the stacked ring through the kernels against the ring
    over the plain block functions."""
    rng = np.random.default_rng(3)
    n, B, Tl, D = 4, 1, 4096, 64
    for Hkv, window in ((16, None), (4, None), (16, 2048)):
        def t(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(DEV)
        q, k, v = t(n, B, Tl, H, D), t(n, B, Tl, Hkv, D), t(n, B, Tl, Hkv, D)
        g = t(n, B, Tl, H, D)

        def run():
            xs = [x.clone().requires_grad_() for x in (q, k, v)]
            out = ring.ring_attention(*xs, causal=True, window=window)
            return (out.detach(),) + torch.autograd.grad(out, xs, g)

        before = (fa.fwd_launches, fa.bwd_launches)
        t0 = time.monotonic()
        got = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        launches = (fa.fwd_launches - before[0], fa.bwd_launches - before[1])
        with mock.patch.object(fa, "attention_block_partial",
                               fa.attention_block_partial_plain), \
                mock.patch.object(fa, "attention_block_backward",
                                  fa.attention_block_backward_plain):
            want = run()
        if (fa.fwd_launches, fa.bwd_launches) != \
                (before[0] + launches[0], before[1] + launches[1]):
            raise AssertionError("the plain ring launched a kernel")
        with torch.no_grad():
            dense = ring._plain_ring_attention(q, k, v, True, D ** -0.5,
                                               window or 0)
        out_err = float((got[0] - want[0]).abs().max())
        dense_err = float((got[0] - dense).abs().max())
        errs = [_grad_err(a, b) for a, b in zip(got[1:], want[1:])]
        if out_err > 1e-4 or dense_err > 1e-4 or not all(
                ok for _, ok in errs) or launches[0] == 0:
            raise AssertionError(
                f"ring attention (Hkv={Hkv}, window={window}) disagrees: "
                f"out err {out_err} / {dense_err}, grad errs {errs}, "
                f"launches {launches}")
        print("ring_case " + json.dumps({
            "n": n, "B": B, "block_len": Tl, "Hkv": Hkv, "window": window,
            "out_err": out_err, "out_err_vs_online_softmax": dense_err,
            "grad_errs": [e for e, _ in errs], "fwd_launches": launches[0],
            "bwd_launches": launches[1], "fwd_bwd_wall_ms": ms}),
            flush=True)


def _plain_by_row(fn):
    """``fn`` (a K1/K2 plain version) called on one batch row at a time:
    the same function (rows are independent), with a fraction of the
    dense score tensors' memory."""
    def call(q, k, v, *rest, **kw):
        outs = [fn(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                   *(r[b:b + 1] if torch.is_tensor(r) else r for r in rest),
                   **kw) for b in range(q.shape[0])]
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return call


def _plain_attention():
    """A context in which K1/K2 run their plain versions (row by row)."""
    from contextlib import ExitStack
    from bluefog_tpu_torch.ops import flash_attention as fa
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        fa, "attention_block_partial",
        _plain_by_row(fa.attention_block_partial_plain)))
    stack.enter_context(mock.patch.object(
        fa, "attention_block_backward",
        _plain_by_row(fa.attention_block_backward_plain)))
    return stack


def zigzag_phase(fa, ring):
    """Phase 5 (zigzag): the zigzag ring through the kernels at phase 5's
    shapes, K1 and K2 launched exactly n + 1 times a call each, against
    the same ring over the plain block functions and against the
    contiguous ring through the kernels on the un-permuted sequence
    (forward and q/k/v grads), at phase 4's tolerances; the contiguous
    ring's launches beside it."""
    rng = np.random.default_rng(4)
    n, B, Tl, D = 4, 1, 4096, 64
    T = n * Tl
    inv = ring.zigzag_inverse(n, T)
    for Hkv in (16, 4):
        def t(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(DEV)
        q, k, v = t(n, B, Tl, H, D), t(n, B, Tl, Hkv, D), t(n, B, Tl, Hkv, D)
        g = t(n, B, Tl, H, D)

        def run(layout, *xs_g):
            xs = [x.clone().requires_grad_() for x in xs_g[:3]]
            out = ring.ring_attention(*xs, causal=True, layout=layout)
            return (out.detach(),) + torch.autograd.grad(out, xs, xs_g[3])

        def unzig(x):                      # zigzag stack -> contiguous stack
            flat = x.transpose(0, 1).reshape((B, T) + tuple(x.shape[3:]))
            return flat[:, torch.as_tensor(inv, device=DEV)].reshape(
                (B, n, Tl) + tuple(x.shape[3:])).transpose(0, 1).contiguous()

        before = (fa.fwd_launches, fa.bwd_launches)
        t0 = time.monotonic()
        got = run("zigzag", q, k, v, g)
        torch.cuda.synchronize()
        ms = 1e3 * (time.monotonic() - t0)
        launches = (fa.fwd_launches - before[0], fa.bwd_launches - before[1])
        if launches != (n + 1, n + 1):
            raise AssertionError(f"zigzag ring launched K1/K2 {launches} "
                                 f"times, want n + 1 = {n + 1} each")
        mid = (fa.fwd_launches, fa.bwd_launches)
        with _plain_attention():
            want = run("zigzag", q, k, v, g)
        if (fa.fwd_launches, fa.bwd_launches) != mid:
            raise AssertionError("the plain zigzag ring launched a kernel")
        contig = run("contiguous", *(unzig(x) for x in (q, k, v, g)))
        c_launches = (fa.fwd_launches - mid[0], fa.bwd_launches - mid[1])
        out_err = float((got[0] - want[0]).abs().max())
        contig_err = float((unzig(got[0]) - contig[0]).abs().max())
        errs = [_grad_err(a, b) for a, b in zip(got[1:], want[1:])]
        c_errs = [_grad_err(unzig(a), b) for a, b in zip(got[1:], contig[1:])]
        if out_err > 1e-4 or contig_err > 1e-4 or not all(
                ok for _, ok in errs + c_errs):
            raise AssertionError(
                f"zigzag ring (Hkv={Hkv}) disagrees: out err {out_err} / "
                f"{contig_err} (plain ring / contiguous ring), grad errs "
                f"{errs} / {c_errs}")
        print("ring_case " + json.dumps({
            "layout": "zigzag", "n": n, "B": B, "block_len": Tl, "Hkv": Hkv,
            "out_err": out_err, "out_err_vs_contiguous": contig_err,
            "grad_errs": [e for e, _ in errs],
            "grad_errs_vs_contiguous": [e for e, _ in c_errs],
            "fwd_launches": launches[0], "bwd_launches": launches[1],
            "contiguous_launches": list(c_launches),
            "fwd_bwd_wall_ms": ms}), flush=True)
        del q, k, v, g, got, want, contig
        torch.cuda.empty_cache()


def _spread(params):
    """Largest |x_r - mean_r x| over the leaves: how far the ranks sit
    from their consensus."""
    from bluefog_tpu_torch.fusion import tree_flatten
    return max(float((x - x.mean(0, keepdim=True)).abs().max())
               for x in tree_flatten(params)[0])


def train_phase(fa, smi):
    """Phase 6: the full-width trainer, its launch counts, the combine
    check and the plain-attention replay."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.ops import collectives as coll
    from bluefog_tpu_torch.parallel import compose
    cfg = compose.LMConfig(vocab=32768, d_model=1024, heads=16, layers=2,
                           seq_len=2048, micro=4, batch=4)
    m = compose.compose_parallelism(4, device=DEV)
    grad_fn = compose.make_lm_grad_fn(cfg, m, use_pallas=True)
    recorded = []

    def recording(params, toks):
        loss, grads = grad_fn(params, toks)
        if record[0]:
            recorded.append(grads)
        return loss, grads

    record = [True]
    step, strategy = compose.make_train_step(m, recording, bfopt.adam(5e-3),
                                             delayed=True)
    init = compose.init_lm_train_params(cfg, m, seed=0)
    toks = compose.make_lm_batch(cfg, m, seed=0)
    params = {g: {k: v.clone() for k, v in d.items()}
              for g, d in init.items()}
    state = bfopt.init_distributed(strategy, params)
    torch.cuda.synchronize()

    # -- the main path: counts at 0, 1 warm-up + 4 timed steps, counts read
    fa.fwd_launches = fa.bwd_launches = 0
    losses = []
    params, state, loss = step(params, state, toks)
    losses.append(loss.tolist())
    record[0] = False
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(4):
        params, state, loss = step(params, state, toks)
        losses.append(loss.tolist())
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / 4
    launches = (fa.fwd_launches, fa.bwd_launches)
    want = m.dp * cfg.micro * cfg.layers * 5
    if launches != (want, want):
        raise AssertionError(f"trainer launched flash_fwd/flash_bwd "
                             f"{launches} times, want dp x micro x layers x "
                             f"steps = {want} each")
    mean = [float(np.mean(x)) for x in losses]
    if not (np.isfinite(mean).all() and mean[-1] < mean[0]):
        raise AssertionError(f"trainer loss did not fall: {mean}")
    leaf = params["blocks"]["wo"]
    mixed = coll.neighbor_allreduce(leaf, m.schedule)
    W = torch.as_tensor(m.effective_mixing(), dtype=torch.float64,
                        device=DEV)
    ref = torch.einsum("sd,s...->d...", W, leaf.double()).float()
    mix_err = float((mixed - ref).abs().max())
    if mix_err > 1e-5 * float(leaf.abs().max()):
        raise AssertionError(f"gossip combine != (W (x) I) x: err {mix_err}")
    spread = _spread(params)
    del params, state, mixed, ref

    # -- replay: 2 steps from the same init and batch, plain attention
    kernel_grads = recorded[:]
    recorded.clear()
    record[0] = True
    params = init
    state = bfopt.init_distributed(strategy, params)
    replay = []
    with mock.patch.object(fa, "attention_block_partial",
                           fa.attention_block_partial_plain), \
            mock.patch.object(fa, "attention_block_backward",
                              fa.attention_block_backward_plain):
        for _ in range(2):
            params, state, loss = step(params, state, toks)
            replay.append(loss.tolist())
            record[0] = False
    if (fa.fwd_launches, fa.bwd_launches) != launches:
        raise AssertionError("the plain replay launched a kernel")
    l1, r1 = np.array(losses[0]), np.array(replay[0])
    l2, r2 = np.array(losses[1]), np.array(replay[1])
    if not (np.allclose(r1, l1, rtol=1e-5, atol=0)
            and np.allclose(r2, l2, rtol=1e-3, atol=0)):
        raise AssertionError(f"plain replay losses {replay} != kernel "
                             f"losses {losses[:2]}")
    from bluefog_tpu_torch.fusion import tree_flatten
    grad_err = 0.0
    for gk, gp in zip(kernel_grads, recorded):
        for a, b in zip(tree_flatten(gk)[0], tree_flatten(gp)[0]):
            err, ok = _grad_err(a, b)
            grad_err = max(grad_err, err / float(b.abs().max()))
            if not ok:
                raise AssertionError(f"step-1 gradient of the plain replay "
                                     f"differs: {err} > 1e-4 max|g|")
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    summary = {
        "dp": m.dp, "n_params_per_rank": cfg.n_params,
        "per_step_s": per_step, "tokens_per_s": tokens / per_step,
        "model_flops_per_s": tokens / per_step * cfg.flops_per_token(),
        "losses_mean": mean, "loss_rank_spread": [max(x) - min(x)
                                                   for x in losses],
        "param_rank_spread": spread, "combine_err": mix_err,
        "replay_losses": replay, "step1_grad_rel_err": grad_err,
        "flash_fwd_launches": launches[0],
        "flash_bwd_launches": launches[1],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("train " + json.dumps(summary), flush=True)
    return launches, step, strategy, init, toks


def compose_phase(fa, smi, dp, pp, tp, sp, tag):
    """Phases 9-10: the composed trainer at full width (tools/lm_bench.py's
    non-smoke shape at this carving: layers 2 x pp, micro 4 x pp), its
    launch counts, falling loss, peak memory, and step 1 replayed with
    attention through the K1/K2 plain versions."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.fusion import tree_flatten
    from bluefog_tpu_torch.parallel import compose
    cfg = compose.LMConfig(vocab=32768, d_model=1024, heads=16,
                           layers=2 * pp, seq_len=2048, micro=4 * pp,
                           batch=4)
    m = compose.compose_parallelism(dp, pp, tp, sp, device=DEV)
    grad_fn = compose.make_lm_grad_fn(cfg, m, use_pallas=True)
    recorded, record = [], [True]

    def recording(params, toks):
        loss, grads = grad_fn(params, toks)
        if record[0]:                 # kept on the host: the peak stays
            recorded.append((loss, [g.cpu() for g in   # the path's own
                                    tree_flatten(grads)[0]]))
        return loss, grads

    step, strategy = compose.make_train_step(m, recording, bfopt.adam(5e-3),
                                             delayed=True)
    init = compose.init_lm_train_params(cfg, m, seed=0)
    toks = compose.make_lm_batch(cfg, m, seed=0)
    params = {g: {k: v.clone() for k, v in d.items()}
              for g, d in init.items()}
    state = bfopt.init_distributed(strategy, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts at 0, 1 warm-up + 3 timed steps, counts read
    steps = 4
    fa.fwd_launches = fa.bwd_launches = 0
    losses = []
    params, state, loss = step(params, state, toks)
    losses.append(loss.tolist())
    record[0] = False
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps - 1):
        params, state, loss = step(params, state, toks)
        losses.append(loss.tolist())
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / (steps - 1)
    launches = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # per replica, one launch per GPipe tick and layer of a stage: every
    # live stage, tp and sp peer of the tick is folded into it
    want = m.dp * (cfg.micro + m.pp - 1) * (cfg.layers // m.pp) * steps
    if launches != (want, want):
        raise AssertionError(
            f"{tag}: flash_fwd/flash_bwd launched {launches} times, want "
            f"dp x (micro + pp - 1) x layers / pp x steps = {want} each")
    mean = [float(np.mean(x)) for x in losses]
    if not (np.isfinite(mean).all() and mean[-1] < mean[0]):
        raise AssertionError(f"{tag}: loss did not fall: {mean}")
    del params, state

    # -- replay step 1 from the same init with the plain attention
    kernel_rec = recorded[:]
    recorded.clear()
    record[0] = True
    state = bfopt.init_distributed(strategy, init)
    with mock.patch.object(fa, "attention_block_partial",
                           fa.attention_block_partial_plain), \
            mock.patch.object(fa, "attention_block_backward",
                              fa.attention_block_backward_plain):
        _, state, replay = step(init, state, toks)
    record[0] = False
    if (fa.fwd_launches, fa.bwd_launches) != launches:
        raise AssertionError(f"{tag}: the plain replay launched a kernel")
    if not np.allclose(replay.tolist(), losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"{tag}: plain replay loss {replay.tolist()} "
                             f"!= kernel loss {losses[0]}")
    grad_err = 0.0
    for (_, gk), (_, gp) in zip(kernel_rec, recorded):
        for a, b in zip(gk, gp):
            err, ok = _grad_err(a.to(DEV), b.to(DEV))
            grad_err = max(grad_err, err / max(float(b.abs().max()), 1e-30))
            if not ok:
                raise AssertionError(f"{tag}: step-1 gradient of the plain "
                                     f"replay differs: {err} > 1e-4 max|g|")
    del state, kernel_rec, recorded[:]
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    summary = {
        "mesh": m.describe(), "n_params": cfg.n_params,
        "config": {"layers": cfg.layers, "micro": cfg.micro,
                   "batch": cfg.batch, "seq": cfg.seq_len},
        "timed_steps": steps - 1, "per_step_s": per_step,
        "tokens_per_step": tokens, "tokens_per_s": tokens / per_step,
        "model_flops_per_s": tokens / per_step * cfg.flops_per_token(),
        "losses_mean": mean, "replay_loss": replay.tolist(),
        "step1_grad_rel_err": grad_err,
        "flash_fwd_launches": launches[0],
        "flash_bwd_launches": launches[1],
        "launch_formula": "dp x (micro + pp - 1) x layers / pp x steps",
        "peak_mem_gb": peak,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(f"{tag} " + json.dumps(summary), flush=True)
    return launches, step, strategy, init, toks


def profile_train(step, strategy, init, toks, tag="profile_train"):
    """One full-width train step under torch.profiler: device time by
    kernel and the device's busy share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bluefog_tpu_torch import optimizers as bfopt
    params = init
    state = bfopt.init_distributed(strategy, params)
    params, state, _ = step(params, state, toks)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, _ = step(params, state, toks)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0)
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:15]:
        print(f"{tag} " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))
    names = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
             "flash_bwd_dq_kernel")
    print(f"{tag} " + json.dumps({
        "step_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "kernel_device_ms": {n: sum(r[0] for r in rows if n in r[1]) / 1e3
                             for n in names},
        "kernel_shares": {n: sum(r[0] for r in rows if n in r[1]) / total_us
                          for n in names},
        "device": torch.cuda.get_device_name(0)}), flush=True)


# -- phase 11: the long-context trainer ---------------------------------

LC_RANKS, LC_SEQ, LC_LAYERS = 8, 16384, 2


def long_context_phase(fa, smi, sp_mode, layout, profile=False):
    """Phase 11: ``RingTransformerLM`` at lm_bench's widths (vocab 32768,
    d_model 1024, 16 heads, 2 layers, rope, f32) over 8 stacked sequence
    ranks, 16,384 tokens (2,048 a rank), batch 1, through
    ``tools/long_context.py``'s step on its copy task (lag 8), Adam 3e-3,
    seed 0: 1 warm-up and 3 timed steps.  K1 and K2 must each launch
    layers x (n (n + 1) / 2 | n + 1 | 1) times a step (contiguous ring,
    zigzag ring, Ulysses), the loss must fall, and step 1 replayed with
    attention through the plain versions (row by row) must agree: loss
    rtol 1e-5, every parameter's gradient atol 1e-4 x max|g|.  Returns
    the launches, the init's loss over every target token (through the
    kernels) and the summary."""
    from bluefog_tpu_torch.models.transformer import (RingTransformerLM,
                                                      lm_loss)
    from bluefog_tpu_torch.ops.ring import zigzag_order
    from bluefog_tpu_torch.tools import long_context as lc
    n, T, Tl = LC_RANKS, LC_SEQ, LC_SEQ // LC_RANKS
    zig = layout == "zigzag"
    model = RingTransformerLM(
        vocab_size=32768, num_layers=LC_LAYERS, num_heads=16, d_model=1024,
        max_seq_len=T, axis="rank", dtype=torch.float32, sp_mode=sp_mode,
        sp_layout=layout, rope=True,
        use_pallas=True).reset_parameters(0).to(DEV)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    pos = lc.rank_positions(n, Tl, zig, DEV)
    step = lc.make_step(model, opt, pos)
    order = zigzag_order(n, T) if zig else np.arange(T)
    seq, tgts = lc.copy_batch(np.random.default_rng(0), T, 8, 32768, order)
    toks, tgts = lc.stack_ranks(seq, n, DEV), lc.stack_ranks(tgts, n, DEV)
    # the loss over every target token at the init, through the kernels:
    # unlike the mean over ranks of the per-rank means, it does not depend
    # on which rank holds the masked first targets
    counts = (tgts >= 0).reshape(n, -1).sum(1).double()
    with torch.no_grad():
        per_rank0 = lm_loss(model(toks, positions=pos), tgts).double()
    token_loss = float((per_rank0 * counts).sum() / counts.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts at 0, 1 warm-up + 3 timed steps, counts read
    steps = 4
    fa.fwd_launches = fa.bwd_launches = 0
    losses = [float(step(toks, tgts))]
    grads1 = {k: p.grad.detach().clone()
              for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps - 1):
        losses.append(float(step(toks, tgts)))
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / (steps - 1)
    launches = (fa.fwd_launches, fa.bwd_launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_call = {"contiguous": n * (n + 1) // 2, "zigzag": n + 1}
    want = LC_LAYERS * (per_call[layout] if sp_mode == "ring" else 1)
    tag = f"long_context_{layout if sp_mode == 'ring' else sp_mode}"
    if launches != (want * steps, want * steps):
        raise AssertionError(f"{tag}: K1/K2 launched {launches} times in "
                             f"{steps} steps, want {want} each a step")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: loss did not fall: {losses}")
    if profile:
        profile_long_context(step, toks, tgts, "profile_" + tag)

    # -- replay step 1 from the same init with the plain attention
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(init[k])
    del init, opt
    model.zero_grad(set_to_none=True)
    before = (fa.fwd_launches, fa.bwd_launches)
    with _plain_attention():
        per_rank = lm_loss(model(toks, positions=pos), tgts)
        per_rank.sum().backward()
    replay = float(per_rank.detach().mean())
    if (fa.fwd_launches, fa.bwd_launches) != before:
        raise AssertionError(f"{tag}: the plain replay launched a kernel")
    if not np.isclose(replay, losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"{tag}: plain replay loss {replay} != kernel "
                             f"loss {losses[0]}")
    grad_err = 0.0
    for k, p in model.named_parameters():
        err, ok = _grad_err(grads1[k], p.grad)
        grad_err = max(grad_err, err / max(float(p.grad.abs().max()),
                                           1e-30))
        if not ok:
            raise AssertionError(f"{tag}: step-1 gradient of {k} in the "
                                 f"plain replay differs: {err} > 1e-4 "
                                 "max|g|")
    summary = {
        "sp_mode": sp_mode, "layout": layout, "ranks": n, "seq": T,
        "tokens_per_rank": Tl, "batch": 1, "layers": LC_LAYERS,
        "n_params": model.n_params, "timed_steps": steps - 1,
        "per_step_s": per_step, "tokens_per_s": T / per_step,
        "model_flops_per_s": T / per_step * model.flops_per_token(T),
        "losses": losses, "step1_token_mean_loss": token_loss,
        "replay_loss": replay,
        "step1_grad_rel_err": grad_err,
        "flash_fwd_launches": launches[0],
        "flash_bwd_launches": launches[1],
        "launches_per_step": want, "peak_mem_gb": peak,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(f"{tag} " + json.dumps(summary), flush=True)
    del model, grads1
    torch.cuda.empty_cache()
    return launches, token_loss, summary


def profile_long_context(step, toks, tgts, tag):
    """One long-context step under torch.profiler: the device's busy
    share of it and K1+K2's share of device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(toks, tgts)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0)
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:10]:
        print(f"{tag} " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))
    names = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
             "flash_bwd_dq_kernel")
    k12 = sum(r[0] for r in rows if any(nm in r[1] for nm in names))
    print(f"{tag} " + json.dumps({
        "step_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms,
        "k1_k2_device_ms": k12 / 1e3, "k1_k2_share": k12 / total_us,
        "device": torch.cuda.get_device_name(0)}), flush=True)


# -- phases 7-8: the grouped expert FFN and MoE serving -------------------

def _randn(rng, *shape, scale=1.0):
    """N(0, scale^2) f32 drawn on the device by a generator seeded from
    ``rng`` (on the host, numpy took ~2 s for each 64M values)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(int(rng.integers(1 << 62)))
    return torch.randn(shape, generator=gen, device=DEV) * scale


def _k4_inputs(rng, rows, E, D, F, tile, dtype, hostile, ids=None):
    """K4's operands as the dropless dispatch lays them out: ``rows``
    random rows routed at random (or all to the last expert, or by
    ``ids``), sorted and padded into tiles, plus expert weights at the
    model's init scale."""
    from bluefog_tpu_torch.parallel.expert import dropless_dispatch
    x = _randn(rng, rows, D)
    if ids is None:
        ids = np.full(rows, E - 1) if hostile else rng.integers(0, E, rows)
    seen = {}

    def capture(_, xt, tile_eid):
        seen["xt"], seen["eid"] = xt, tile_eid
        return xt

    dropless_dispatch(x, torch.tensor(ids, device=DEV), capture, None, E,
                      tile)

    def w(*shape):
        return _randn(rng, *shape, scale=0.1).to(dtype)

    return (seen["xt"].to(dtype).contiguous(), seen["eid"], w(E, D, F),
            w(E, F, D))


def _k4_bound(xt, eid, w1, rate=None):
    """Least time: the weights of every distinct expert the live tiles
    name read once, their rows of xt read and the whole output written
    once, against 4 G_live tile D F operations (trash tiles, id -1, need
    none) at the rate of f32-accurate products on the tensor cores
    (3xTF32); for bf16 operands the up-projection at the bf16 rate and
    the down-projection, the f32 u (kept f32, as the TPU kernel keeps it)
    times the bf16 weight, at a third of the bf16 rate: the fastest
    f32-accurate form the card has for it splits u into three bf16
    parts (24 significant bits) times the exact weight, three exact bf16
    products (989 / 3 TFLOP/s, above the 495 / 2 of two TF32 products).
    ``rate`` sets one rate for both (the CUDA-core f32 bound of earlier
    versions)."""
    G, tile, D = xt.shape
    Fd, item = w1.shape[-1], xt.element_size()
    live = eid[eid >= 0]
    experts, g_live = int(torch.unique(live).numel()), int(live.numel())
    nbytes = experts * 2 * D * Fd * item + (g_live + G) * tile * D * item \
        + 4 * G
    half = 2.0 * g_live * tile * D * Fd      # one product's operations
    if rate:
        t_ops = 2 * half / rate
    elif item == 2:
        t_ops = half / BF16_FLOPS + half / (BF16_FLOPS / 3)
    else:
        t_ops = 2 * half / TF32X3_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def grouped_ffn_phase(gf):
    """Phase 7: K4 against its plain version, both forward routes timed
    at each shape; returns the rows by case."""
    import torch.nn.functional as F
    rng = np.random.default_rng(7)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("decode_8_lanes", 16, 1024, 4096, 2, f32, False),
             ("decode_1_lane", 2, 1024, 4096, 2, f32, False),
             ("prefill_512", 1024, 1024, 4096, 8, f32, False),
             ("prefill_256", 512, 1024, 4096, 8, f32, False),
             # 32-64 rows an expert (the routes' crossover)
             ("rows_32", 200, 1024, 4096, 8, f32, False),
             ("rows_48", 328, 1024, 4096, 8, f32, False),
             ("rows_56", 392, 1024, 4096, 8, f32, False),
             ("rows_64", 456, 1024, 4096, 8, f32, False),
             ("tile_1", 16, 1024, 4096, 1, f32, False),
             ("tile_4", 16, 1024, 4096, 4, f32, False),
             ("tile_16", 64, 1024, 4096, 16, f32, False),
             ("hostile", 16, 1024, 4096, 2, f32, True),
             ("decode_8_lanes_bf16", 16, 1024, 4096, 2, bf16, False),
             ("prefill_512_bf16", 1024, 1024, 4096, 8, bf16, False),
             ("prefill_256_bf16", 512, 1024, 4096, 8, bf16, False),
             ("rows_32_bf16", 200, 1024, 4096, 8, bf16, False),
             ("rows_48_bf16", 328, 1024, 4096, 8, bf16, False),
             ("rows_56_bf16", 392, 1024, 4096, 8, bf16, False),
             ("rows_64_bf16", 456, 1024, 4096, 8, bf16, False),
             ("ragged_D96_F200", 16, 96, 200, 2, f32, False)]
    rows_out = {}
    for name, rows, D, Fd, tile, dt, hostile in cases:
        xt, eid, w1, w2 = _k4_inputs(rng, rows, 8, D, Fd, tile, dt, hostile)
        before = gf.grouped_ffn_cuda.launches
        got = gf.grouped_ffn(xt, eid, w1, w2)
        want = gf.grouped_ffn_plain(xt, eid, w1, w2)
        torch.cuda.synchronize()
        if gf.grouped_ffn_cuda.launches != before + 1:
            raise AssertionError(f"grouped_ffn {name}: the kernel did not "
                                 "launch")
        diff = (got.float() - want.float()).abs()
        err, top = float(diff.max()), float(want.float().abs().max())
        lim = 1e-4 * top
        if dt == bf16:
            lim = lim + 8e-3 * want.float().abs()
        if not (bool((diff <= lim).all())
                and bool(torch.isfinite(got.float()).all())
                and got.dtype == dt and got.shape == xt.shape):
            raise AssertionError(
                f"grouped_ffn disagrees with its plain version: {name} "
                f"G={xt.shape[0]} tile={tile}: max abs err {err} "
                f"(1e-4 x max|plain| = {1e-4 * top}"
                f"{' + rtol 8e-3' if dt == bf16 else ''})")
        # both routes forced at this shape (the threshold's evidence),
        # each held to the same tolerance
        routes = {}
        for route in K4_ROUTES:
            def forced(route=route):
                return gf._forward_cuda(*gf._padded(xt, eid, w1, w2),
                                        keep_s=False, route=route)[0]
            r_diff = (forced()[..., :D].float() - want.float()).abs()
            if not bool((r_diff <= lim).all()):
                raise AssertionError(f"grouped_ffn {name}: the {route} "
                                     f"route disagrees with the plain "
                                     f"version: {float(r_diff.max())}")
            routes[route] = {"max_abs_err": float(r_diff.max()),
                             "ms": _device_ms(forced, True)}
        live = eid >= 0                   # trash tiles (id -1) need nothing
        idx, xl = eid[live].long(), xt[live]
        w1g, w2g = w1[idx], w2[idx]                       # cuBLAS yardstick
        G = xt.shape[0]

        def lib():
            u = F.gelu(torch.bmm(xl, w1g), approximate="tanh")
            return torch.bmm(u, w2g)

        def kern():
            return gf.grouped_ffn(xt, eid, w1, w2)

        ms, warm_ms = _device_ms(kern, True), _device_ms(kern, False)
        plain_ms = _device_ms(lambda: gf.grouped_ffn_plain(xt, eid, w1, w2),
                              True, iters=5, warmup=1)
        lib_ms, lib_warm_ms = _device_ms(lib, True), _device_ms(lib, False)
        del w1g, w2g
        bound, bound_by = _k4_bound(xt, eid, w1)
        simt = _k4_bound(xt, eid, w1, rate=F32_FLOPS)[0] \
            if dt == f32 else None
        row = dict(case=name, G=G, tile=tile, D=D, F=Fd, dtype=str(dt)[6:],
                   plan=list(gf.ffn_plan(G, tile, 8, D, Fd)),
                   route=gf.ffn_route(G, tile, 8), routes=routes,
                   experts_named=int(torch.unique(eid[live]).numel()),
                   max_abs_err=err, max_abs_plain=top, ms=ms,
                   warm_ms=warm_ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, bound_ms_simt=simt, library_ms=lib_ms,
                   library_warm_ms=lib_warm_ms,
                   library="cuBLAS torch.bmm + gelu + torch.bmm over "
                           "pre-gathered weights")
        print("kernel_case " + json.dumps(row), flush=True)
        rows_out[name] = row
        del xt, w1, w2, got, want
    torch.cuda.empty_cache()
    return rows_out


def _router_tie(model, layers_mod, tokens, k):
    """Smallest gap between the k-th and (k+1)-th router probability over
    every layer and position of the cache-free forward over ``tokens``."""
    gaps = []
    orig = layers_mod.router_topk

    def recording(x, wr, *, top_k):
        out = orig(x, wr, top_k=top_k)
        srt = torch.sort(out[1], dim=-1, descending=True).values
        gaps.append(float((srt[:, k - 1] - srt[:, k]).min()))
        return out

    with mock.patch.object(layers_mod, "router_topk", recording), \
            torch.inference_mode():
        model(torch.tensor([tokens], device=DEV))
    return min(gaps)


def moe_serve_phase(fd, gf, layers_mod, smi):
    """Phase 8: the MoE drain at full width, its launch counts, and the
    replay with K4 forced to its plain version."""
    from bluefog_tpu_torch.moe.model import MoELMConfig, init_moe_params
    from bluefog_tpu_torch.serve import Scheduler, ServeConfig, ServeEngine
    cfg = MoELMConfig(vocab=32768, d_model=1024, heads=16, layers=8,
                      ffn_mult=4, num_experts=8, top_k=2,
                      dispatch="dropless", group_tile=8)
    t0 = time.monotonic()
    model = init_moe_params(cfg, seed=0, device=DEV)
    init_s = time.monotonic() - t0
    scfg = ServeConfig(slots=8, max_len=1024, batch_buckets=(1, 2, 4, 8),
                       prefill_buckets=(64, 256, 512),
                       decode_steps_per_call=4, decode_kernel="pallas",
                       decode_block_k=BK, moe_experts=8, moe_top_k=2)
    engine = ServeEngine(cfg, model, scfg, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    n_req, max_new = 16, 64
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(32, 513, n_req)]
    sched = Scheduler(engine)
    fd.flash_decode_cuda.launches = gf.grouped_ffn_cuda.launches = 0
    gf.grouped_ffn_cuda.gemm_launches = 0
    t0 = time.monotonic()
    with _k4_route_tally(gf) as routed:
        for p in prompts:
            sched.submit(p, max_new_tokens=max_new)
        sched.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    k3, k4 = fd.flash_decode_cuda.launches, gf.grouped_ffn_cuda.launches
    _gate_k4_routes("moe_serve", gf, routed)
    reqs = sorted(sched.completed, key=lambda r: r.id)
    if len(reqs) != n_req or any(len(r.generated) != max_new for r in reqs):
        raise AssertionError(f"moe: {len(reqs)}/{n_req} requests done")
    if k4 != cfg.layers * (n_req + sched.decode_steps) or k4 == 0:
        raise AssertionError(
            f"moe: grouped_ffn launched {k4} times, want layers "
            f"{cfg.layers} x (prefills {n_req} + decode steps "
            f"{sched.decode_steps})")
    if k3 != cfg.layers * sched.decode_steps:
        raise AssertionError(f"moe: flash decode launched {k3} times, want "
                             f"layers x decode steps")
    load = engine.moe_load()[0]
    # the engine's first token of request 0 against the cache-free forward
    gap0 = _top2_gap(model, prompts[0])
    with torch.inference_mode():
        ref0 = int(torch.argmax(model(torch.tensor(
            [prompts[0]], device=DEV))[0, -1]))
    if reqs[0].generated[0] != ref0 and gap0 >= 1e-3:
        raise AssertionError(f"moe: first token {reqs[0].generated[0]} != "
                             f"the forward's {ref0}")
    # replay the first 4 with K4 forced to its plain version
    with mock.patch.object(gf, "grouped_ffn", gf.grouped_ffn_plain):
        replay = Scheduler(engine)
        for p in prompts[:4]:
            replay.submit(p, max_new_tokens=max_new)
        before = gf.grouped_ffn_cuda.launches
        replay.drain()
        if gf.grouped_ffn_cuda.launches != before:
            raise AssertionError("the plain-K4 replay launched the kernel")
    diverged = _stream_gate("moe", model, reqs[:4], sorted(
        replay.completed, key=lambda r: r.id), layers_mod, cfg.top_k)
    tokens = sum(len(r.generated) for r in reqs)
    print("serve " + json.dumps({
        "run": "moe", "kv_dtype": "raw", "requests": n_req,
        "max_new_tokens": max_new, "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "mean_ttft_s": float(np.mean([r.ttft for r in reqs])),
        "decode_calls": sched.decode_calls,
        "decode_steps": sched.decode_steps,
        "decode_ms_per_step": 1e3 * sched.decode_seconds
        / sched.decode_steps,
        "decode_ms_per_token": 1e3 * sched.decode_seconds
        / (tokens - n_req),
        "decode_tile": engine._moe_tile, "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params, "init_s": init_s,
        "grouped_ffn_launches": k4, "flash_decode_launches": k3,
        "last_call_expert_fractions": load["fractions"].tolist(),
        "last_call_router_entropy": load["entropy"],
        "replay_diverged": diverged,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
        flush=True)
    return engine, k4, k3, model, cfg


# -- phase 12: K4's backward and MoE training ----------------------------

def _k4_bwd_bound(rows, E, D, F):
    """Least time of K4's backward on ``rows`` routed rows: 8 rows D F
    operations (dgrad's two products, wgrad's two) at the 3xTF32 rate,
    or the bytes (xt, g, s and the weights read once; dxt and the weight
    gradients written once)."""
    flops = 8.0 * rows * D * F
    nbytes = 4 * (3 * rows * D + rows * F + 4 * E * D * F)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / TF32X3_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _by_expert_yardstick(xt, eid, w1, w2, s, g):
    """The per-expert cuBLAS yardstick of K4's backward: ``torch.matmul``
    over each expert's contiguous rows (the run bounds read on the host
    beforehand, as a per-expert loop must), gelu' and gelu between (on
    the f32 ``s``, rounded back to the operands' type); trash tiles (id
    -1) get zero rows of dxt and no product."""
    import torch.nn.functional as F
    tile = xt.shape[1]
    x2, g2, s2 = (t.reshape(-1, t.shape[-1]) for t in (xt, g, s))
    runs = [(e, g0 * tile, g1 * tile) for e, g0, g1 in _runs(eid)]

    def run():
        dxt = torch.zeros_like(x2)
        dw1, dw2 = torch.zeros_like(w1), torch.zeros_like(w2)
        for e, r0, r1 in runs:
            gs, ss, xs = g2[r0:r1], s2[r0:r1], x2[r0:r1]
            ds = torch.ops.aten.gelu_backward(
                torch.matmul(gs, w2[e].t()).to(ss.dtype), ss,
                approximate="tanh").to(xs.dtype)
            dxt[r0:r1] = torch.matmul(ds, w1[e].t())
            dw1[e] += torch.matmul(xs.t(), ds)
            dw2[e] += torch.matmul(
                F.gelu(ss, approximate="tanh").to(gs.dtype).t(), gs)
        return dxt, dw1, dw2

    return run


def _zipf_ids(rng, rows, E, exponent=1.2):
    """Expert ids of ``rows`` rows drawn with Zipf-like weights k^-exponent
    over a random order of the ``E`` experts (a trained router is
    uneven)."""
    w = 1.0 / np.arange(1, E + 1) ** exponent
    return rng.permutation(E)[rng.choice(E, rows, p=w / w.sum())]


def _plan_row(lists, plan, D, Fd):
    """The device plan's item counts (``lists`` read back by
    ``unpack_plan``: for the report only)."""
    tiles = -(-D // 128) * -(-Fd // 128)
    blocks, parts = len(lists["row_blocks"]), len(lists["parts"])
    return {"runs": len(lists["runs"]), "row_blocks": blocks,
            "dgrad_items": [blocks * -(-Fd // 128), blocks * -(-D // 128)],
            "wgrad_parts": parts, "wgrad_items": parts * tiles,
            "part_sums": len(lists["part_sums"]),
            "scratch_slots": int(lists["slots"]),
            "scratch_slots_sized": plan.slots}


def grouped_ffn_backward_phase(gf):
    """Phase 12a: K4's backward (the plan, dgrad and wgrad kernels, f32)
    against the per-expert plain version under autograd at the MoE
    trainer's steady tick, the serving prefill shape, hostile routing and
    Zipf-skewed routing at the steady tick's shape: dxt, dw1, dw2 within
    1e-4 x max|plain| (f32-accurate 3xTF32 products summed in another
    order, the weight gradients over up to 65k rows of one expert), two
    runs bit-identical, experts without rows exactly 0, the device plan
    equal to its plain version.  Times cold and warm beside the bound, the
    plain version's backward and the per-expert cuBLAS yardstick, the
    dgrad, wgrad and plan apart.  Returns the rows by case."""
    rng = np.random.default_rng(12)
    hostile = np.full(4096, 5)
    hostile[:3] = 2                  # one expert with fewer rows than a tile
    cases = [("steady_tick", 65536, 32, 1024, 2048, None),
             ("prefill_512", 1024, 8, 1024, 4096, None),
             ("hostile", 4096, 8, 1024, 4096, hostile),
             ("skewed", 65536, 32, 1024, 2048,
              _zipf_ids(np.random.default_rng(1212), 65536, 32))]
    rows_out = {}
    for name, rows, E, D, Fd, ids in cases:
        xt, eid, w1, w2 = _k4_inputs(rng, rows, E, D, Fd, 8, torch.float32,
                                     False, ids)
        g = _randn(rng, *xt.shape)

        def grads(fn):
            x, a, b = (t.detach().requires_grad_() for t in (xt, w1, w2))
            out = fn(x, eid, a, b)
            return (out.detach(),) + torch.autograd.grad(out, (x, a, b), g)

        before = (gf.grouped_ffn_dgrad_cuda.launches,
                  gf.grouped_ffn_wgrad_cuda.launches,
                  gf.backward_plan_cuda.launches)
        got = grads(gf.grouped_ffn)
        again = grads(gf.grouped_ffn)
        torch.cuda.synchronize()
        if (gf.grouped_ffn_dgrad_cuda.launches - before[0],
                gf.grouped_ffn_wgrad_cuda.launches - before[1],
                gf.backward_plan_cuda.launches - before[2]) != (2, 2, 2):
            raise AssertionError(f"grouped_ffn backward {name}: the plan/"
                                 "dgrad/wgrad kernels did not launch once "
                                 "a backward")
        identical = all(torch.equal(p, q) for p, q in zip(got, again))
        del again
        want = grads(gf.grouped_ffn_plain_by_expert)
        errs = {}
        for key, a, b in zip(("out", "dxt", "dw1", "dw2"), got, want):
            err, top = float((a - b).abs().max()), float(b.abs().max())
            errs[key] = err / top
            if not (err <= 1e-4 * top and bool(torch.isfinite(a).all())):
                raise AssertionError(
                    f"grouped_ffn backward disagrees with the per-expert "
                    f"plain version: {name} {key}: max abs err {err} > "
                    f"1e-4 x max|plain| = {1e-4 * top}")
        if not identical:
            raise AssertionError(f"grouped_ffn backward {name}: two runs "
                                 "differ")
        named = set(eid.tolist())
        empty = [e for e in range(E) if e not in named]
        if empty and (bool(got[2][empty].any())
                      or bool(got[3][empty].any())):
            raise AssertionError(f"grouped_ffn backward {name}: an expert "
                                 "without rows got a nonzero gradient")
        err = max(float((a - b).abs().max())
                  for a, b in zip(got[1:], want[1:]))
        del got, want
        s = gf._forward_cuda(xt, eid, w1, w2, keep_s=True)[1]
        plan = gf.backward_plan_cuda(eid, 8, E, D, Fd)
        plain_plan = gf.backward_plan_plain(eid, 8, E, D, Fd)
        lists = gf.unpack_plan(plan)
        if any(lists[k].shape != v.shape for k, v in plain_plan.items()):
            raise AssertionError(f"grouped_ffn backward {name}: the device "
                                 "plan's lists differ in length from its "
                                 "plain version's")
        plan_err = max(float((lists[k] - v.cpu()).abs().max())
                       if v.numel() else 0.0 for k, v in plain_plan.items())
        if plan_err != 0:
            raise AssertionError(f"grouped_ffn backward {name}: the device "
                                 f"plan differs from its plain version by "
                                 f"up to {plan_err}")
        dxt, ds, u = gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, plan)

        def kern():
            pl = gf.backward_plan_cuda(eid, 8, E, D, Fd)
            dx, d_s, uu = gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, pl)
            return dx, gf.grouped_ffn_wgrad_cuda(xt, d_s, uu, g, eid, E,
                                                 plan=pl)

        x, a, b = (t.detach().requires_grad_() for t in (xt, w1, w2))
        ref_out = gf.grouped_ffn_plain_by_expert(x, eid, a, b)

        def plain():
            return torch.autograd.grad(ref_out, (x, a, b), g,
                                       retain_graph=True)

        ms, warm_ms = _device_ms(kern, True, iters=5, warmup=1), \
            _device_ms(kern, False, iters=5, warmup=1)
        dgrad_ms = _device_ms(
            lambda: gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, plan), True,
            iters=5, warmup=1)
        wgrad_ms = _device_ms(
            lambda: gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid, E,
                                              plan=plan), True, iters=5,
            warmup=1)
        plan_ms = _device_ms(lambda: gf.backward_plan_cuda(eid, 8, E, D, Fd),
                             True, iters=5, warmup=1)
        plan_plain_ms = _device_ms(
            lambda: gf.backward_plan_plain(eid, 8, E, D, Fd), True, iters=3,
            warmup=1)
        plain_ms = _device_ms(plain, True, iters=3, warmup=1)
        lib = _by_expert_yardstick(xt, eid, w1, w2, s, g)
        lib_ms, lib_warm_ms = _device_ms(lib, True, iters=5, warmup=1), \
            _device_ms(lib, False, iters=5, warmup=1)
        bound, bound_by = _k4_bwd_bound(rows, E, D, Fd)
        G = xt.shape[0]
        # the plan's least time: tile_eid read once, and written once what
        # this routing's plan holds: the header's 7 counts and flags, each
        # expert's rows, run pointers (E + 1) and cursor, the runs by tile
        # and by expert, the row blocks, the parts and the part sums
        plan_words = (7 + 3 * E + 1 + 4 * len(lists["runs"])
                      + 3 * len(lists["row_blocks"]) + 4 * len(lists["parts"])
                      + 3 * len(lists["part_sums"]))
        plan_bytes = 4 * (G + plan_words)
        row = dict(case=name, rows=rows, G=G, tile=8, E=E, D=D, F=Fd,
                   experts_named=len(named),
                   largest_expert_rows=int(lists["expert_rows"].max()),
                   plan=_plan_row(lists, plan, D, Fd),
                   plan_max_abs_err=plan_err,
                   max_abs_err=err, rel_err=errs, ms=ms, warm_ms=warm_ms,
                   dgrad_ms=dgrad_ms, wgrad_ms=wgrad_ms, plan_ms=plan_ms,
                   plan_plain_ms=plan_plain_ms,
                   plan_bound_ms=1e3 * plan_bytes / HBM_BYTES_PER_S,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   library_ms=lib_ms, library_warm_ms=lib_warm_ms,
                   library="cuBLAS torch.matmul per expert over its "
                           "contiguous rows (bounds read beforehand), "
                           "gelu' and gelu between",
                   plain="autograd backward of grouped_ffn_plain_by_expert "
                         "on a kept graph",
                   forward_route=gf.ffn_route(G, 8, E))
        if name == "steady_tick":        # the trainer's forward, s kept
            row["forward"] = _k4_forward_row(gf, xt, eid, w1, w2)
        print("kernel_case " + json.dumps(row), flush=True)
        rows_out[name] = row
        del xt, w1, w2, g, s, ref_out, x, a, b, dxt, ds, u, plan
        torch.cuda.empty_cache()
    return rows_out


def _k4_bwd_bound_bf16(rows, E, D, F):
    """Least time of K4's bf16 backward on ``rows`` routed rows: 8 rows D
    F operations at the bf16 rate, or the bytes (xt and g in bf16 and the
    f32 ``s`` read once, the bf16 weights read once; dxt and the bf16
    weight gradients written once)."""
    flops = 8.0 * rows * D * F
    nbytes = 2 * 3 * rows * D + 4 * rows * F + 2 * 4 * E * D * F
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _runs(eid):
    """``(expert, first row tile, end tile)`` of each run of one live
    expert's tiles (read on the host)."""
    ids, out, g0 = eid.tolist(), [], 0
    while g0 < len(ids):
        g1 = g0
        while g1 < len(ids) and ids[g1] == ids[g0]:
            g1 += 1
        if ids[g0] >= 0:
            out.append((ids[g0], g0, g1))
        g0 = g1
    return out


def _s_by_expert(xt, eid, w1, dtype):
    """The pre-activation ``xt @ w1[e]`` in ``dtype`` by run of one
    expert's tiles (zeros on trash tiles)."""
    G, tile, D = xt.shape
    s = torch.zeros((G, tile, w1.shape[-1]), dtype=dtype, device=xt.device)
    for e, g0, g1 in _runs(eid):
        s[g0:g1] = torch.matmul(xt[g0:g1].to(dtype), w1[e].to(dtype))
    return s


def _k4_forward_yardstick(xt, eid, w1, w2, tf32_up=False):
    """K4's forward as cuBLAS products per run of one expert's tiles (the
    runs read beforehand), gelu between, in the operands' type, TF32 off;
    ``tf32_up`` allows TF32 in the up-projection alone (exact on bf16
    values widened to f32: products exact, sums f32)."""
    import torch.nn.functional as F
    runs = _runs(eid)
    flags = torch.backends.cuda.matmul

    def run():
        out = torch.zeros_like(xt)
        kept = flags.allow_tf32
        try:
            for e, g0, g1 in runs:
                flags.allow_tf32 = tf32_up
                s = torch.matmul(xt[g0:g1], w1[e])
                flags.allow_tf32 = False
                out[g0:g1] = torch.matmul(F.gelu(s, approximate="tanh"),
                                          w2[e])
        finally:
            flags.allow_tf32 = kept
        return out

    return run


def _k4_forward_row(gf, xt, eid, w1, w2):
    """The trainer's forward (``s`` kept) on both routes at one shape:
    each held against ``grouped_ffn_plain_by_expert`` (1e-4 x max|plain|,
    plus 8e-3 x |plain| in bf16: one bf16 ulp of the output), rerun for
    identical bits, timed cold and warm, beside the bound, the plain
    version and per-expert cuBLAS on the same function (f32 products,
    TF32 off, u in f32; bf16 operands widened first, their up-projection
    with TF32 on, which is exact for them); in bf16 also cuBLAS on the
    bf16 operands, which rounds u to bf16 (a lower-precision yardstick,
    not the same function).  ``ms`` and the error are the route the
    shapes pick."""
    G, tile, D = xt.shape
    E, Fd = w1.shape[0], w1.shape[-1]
    bf = xt.dtype == torch.bfloat16
    ref = gf.grouped_ffn_plain_by_expert(xt, eid, w1, w2).float()
    lim = 1e-4 * float(ref.abs().max()) + (8e-3 * ref.abs() if bf else 0)
    row = {"route": gf.ffn_route(G, tile, E),
           "tol": "1e-4 x max|plain|" + (" + 8e-3 x |plain|" if bf else "")}
    for route in K4_ROUTES:
        def fwd(route=route):
            return gf._forward_cuda(xt, eid, w1, w2, keep_s=True,
                                    route=route)
        out, again = fwd()[0], fwd()[0]
        diff = (out.float() - ref).abs()
        if not (bool((diff <= lim).all()) and torch.equal(out, again)):
            raise AssertionError(f"grouped_ffn forward {xt.dtype} route "
                                 f"{route}: max abs err {float(diff.max())}"
                                 f", reruns identical "
                                 f"{torch.equal(out, again)}")
        del out, again
        row[route] = {"max_abs_err": float(diff.max()),
                      "ms": _device_ms(fwd, True, iters=5, warmup=1),
                      "warm_ms": _device_ms(fwd, False, iters=5, warmup=1)}
        del diff
    row.update({k: row[row["route"]][k]
                for k in ("max_abs_err", "ms", "warm_ms")})
    wide = [t.float() for t in (xt, w1, w2)] if bf else (xt, w1, w2)
    row["library_ms"] = _device_ms(_k4_forward_yardstick(
        wide[0], eid, wide[1], wide[2], tf32_up=bf), True, iters=5,
        warmup=1)
    row["library"] = ("cuBLAS f32 torch.matmul per expert, gelu between, "
                      + ("bf16 operands widened to f32, the up-projection "
                         "with TF32 on (exact for them), the "
                         "down-projection on the f32 u with TF32 off"
                         if bf else "TF32 off"))
    if bf:
        row["library_bf16_u_ms"] = _device_ms(_k4_forward_yardstick(
            xt, eid, w1, w2), True, iters=5, warmup=1)
        row["library_bf16_u"] = ("cuBLAS bf16 torch.matmul per expert, u "
                                 "rounded to bf16: a lower-precision "
                                 "yardstick")
    del wide, ref
    row["plain_ms"] = _device_ms(lambda: gf.grouped_ffn_plain_by_expert(
        xt, eid, w1, w2), True, iters=3, warmup=1)
    row["bound_ms"], row["bound_by"] = _k4_bound(xt, eid, w1)
    torch.cuda.empty_cache()
    return row


def _ulp_bf16(x):
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def grouped_ffn_backward_bf16_phase(gf):
    """Phase 12a, bf16: K4's bf16 backward (the plan, then the dgrad and
    wgrad on backward_gemm16) at the MoE trainer's steady tick (65,536
    rows, 32 folded experts, F 2048), hostile routing, Zipf-skewed
    routing, two expert-parallel owners' trash tiles and forced wgrad
    splits, each against the bf16 plain version with the same rounding
    points (per expert, on the same f32 ``s``) and an f64 evaluation on
    the card: dxt, dw1, dw2 within one bf16 ulp of their max |plain|
    (the f32 sums run in other orders before the same roundings), and no
    farther from f64 than the plain version plus half such an ulp; two
    runs bit-identical, experts without rows exactly 0, trash rows of dxt
    0.  Times (cold and warm) beside the bound at the bf16 rate, the
    plain version and the per-expert cuBLAS bf16 yardstick.  At the
    steady tick the trainer's forward (``s`` kept) is timed too.  Returns
    the rows by case."""
    rng = np.random.default_rng(1216)
    bf = torch.bfloat16
    hostile = np.full(4096, 5)
    hostile[:3] = 2
    trash = np.concatenate([np.sort(rng.integers(0, 16, 2048)),
                            np.full(2048, -1),
                            np.sort(rng.integers(16, 32, 2048)),
                            np.full(2048, -1)])
    cases = [("steady_tick", 65536, 32, 1024, 2048, None, 0),
             ("hostile", 4096, 8, 1024, 4096, hostile, 0),
             ("skewed", 65536, 32, 1024, 2048,
              _zipf_ids(np.random.default_rng(1212), 65536, 32), 0),
             ("trash_tiles", 32768, 32, 1024, 2048, trash, 0),
             ("forced_splits", 16384, 8, 1024, 2048, None, 3)]
    rows_out = {}
    for name, rows, E, D, Fd, ids, splits in cases:
        if name == "trash_tiles":        # two owners' buffers, as folded
            eid = torch.tensor(ids, dtype=torch.int32, device=DEV)
            xt = (_randn(rng, len(ids), 8, D)
                  * (eid >= 0)[:, None, None]).to(bf)
            w1, w2 = (_randn(rng, *shape, scale=0.1).to(bf)
                      for shape in ((E, D, Fd), (E, Fd, D)))
        else:
            xt, eid, w1, w2 = _k4_inputs(rng, rows, E, D, Fd, 8, bf, False,
                                         ids)
        live = eid >= 0
        g = (_randn(rng, *xt.shape) * live[:, None, None]).to(bf)
        out, s, _ = gf._forward_cuda(xt, eid, w1, w2, keep_s=True)
        ref = gf.grouped_ffn_plain_by_expert(xt, eid, w1, w2).float()
        fwd_err = float((out.float() - ref).abs().max())
        if not bool(((out.float() - ref).abs() <= 1e-4 * float(
                ref.abs().max()) + 8e-3 * ref.abs()).all()):
            raise AssertionError(f"grouped_ffn bf16 forward {name} (route "
                                 f"{gf.ffn_route(xt.shape[0], 8, E)})"
                                 f" disagrees with its plain version: "
                                 f"{fwd_err}")
        del out, ref

        def kern():
            pl = gf.backward_plan_cuda(eid, 8, E, D, Fd, splits)
            dx, d_s, uu = gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, pl)
            return (dx,) + gf.grouped_ffn_wgrad_cuda(xt, d_s, uu, g, eid, E,
                                                     plan=pl)

        counters = (gf.backward_plan_cuda, gf.grouped_ffn_dgrad_cuda,
                    gf.grouped_ffn_wgrad_cuda)
        before = [c.launches for c in counters]
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if [c.launches - b for c, b in zip(counters, before)] != [2] * 3:
            raise AssertionError(f"grouped_ffn backward bf16 {name}: the "
                                 "plan/dgrad/wgrad kernels did not launch "
                                 "once a backward")
        identical = all(torch.equal(p, q) for p, q in zip(got, again))
        del again
        s_plain = _s_by_expert(xt, eid, w1, torch.float32)
        want = gf.grouped_ffn_backward_plain_by_expert(xt, eid, w1, w2,
                                                       s_plain, g)
        x64, g64, a64, b64 = (t.double() for t in (xt, g, w1, w2))
        f64 = gf.grouped_ffn_backward_plain_by_expert(
            x64, eid, a64, b64, _s_by_expert(x64, eid, a64, torch.float64),
            g64)
        del x64, g64, a64, b64, s_plain
        errs, bad = {}, []
        for key, a, b, c in zip(("dxt", "dw1", "dw2"), got, want, f64):
            top = float(b.float().abs().max())
            one = _ulp_bf16(top)
            e_plain = float((a.double() - b.double()).abs().max())
            k64 = float((a.double() - c).abs().max())
            p64 = float((b.double() - c).abs().max())
            errs[key] = {"max_abs_plain": top, "bf16_ulp": one,
                         "vs_plain": e_plain, "kernel_vs_f64": k64,
                         "plain_vs_f64": p64}
            if not (e_plain <= one and k64 <= p64 + one / 2
                    and a.dtype == bf and bool(torch.isfinite(a).all())):
                bad.append((key, errs[key]))
        if bad or not identical:
            raise AssertionError(f"grouped_ffn backward bf16 {name}: "
                                 f"{bad}; bit-identical reruns "
                                 f"{identical}")
        named = set(eid[live].tolist())
        empty = [e for e in range(E) if e not in named]
        if empty and (bool(got[1][empty].any())
                      or bool(got[2][empty].any())):
            raise AssertionError(f"grouped_ffn backward bf16 {name}: an "
                                 "expert without rows got a gradient")
        if bool(got[0][~live].any()):
            raise AssertionError(f"grouped_ffn backward bf16 {name}: a "
                                 "trash tile got nonzero dxt rows")
        del got, want, f64
        plan = gf.backward_plan_cuda(eid, 8, E, D, Fd, splits)
        dxt, ds, u = gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, plan)
        ms, warm_ms = _device_ms(kern, True, iters=5, warmup=1), \
            _device_ms(kern, False, iters=5, warmup=1)
        dgrad_ms = _device_ms(
            lambda: gf.grouped_ffn_dgrad_cuda(g, eid, w1, w2, s, plan), True,
            iters=5, warmup=1)
        wgrad_ms = _device_ms(
            lambda: gf.grouped_ffn_wgrad_cuda(xt, ds, u, g, eid, E,
                                              plan=plan), True, iters=5,
            warmup=1)
        plain_ms = _device_ms(
            lambda: gf.grouped_ffn_backward_plain_by_expert(
                xt, eid, w1, w2, s, g), True, iters=3, warmup=1)
        lib = _by_expert_yardstick(xt, eid, w1, w2, s, g)
        lib_ms, lib_warm_ms = _device_ms(lib, True, iters=5, warmup=1), \
            _device_ms(lib, False, iters=5, warmup=1)
        bound, bound_by = _k4_bwd_bound_bf16(rows, E, D, Fd)
        row = dict(case=name, dtype="bfloat16", rows=rows,
                   G=xt.shape[0], tile=8, E=E, D=D, F=Fd, splits=splits,
                   experts_named=len(named),
                   max_abs_err=max(v["vs_plain"] for v in errs.values()),
                   errors=errs, ms=ms, warm_ms=warm_ms, dgrad_ms=dgrad_ms,
                   wgrad_ms=wgrad_ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=bound_by, library_ms=lib_ms,
                   library_warm_ms=lib_warm_ms,
                   library="cuBLAS bf16 torch.matmul per expert over its "
                           "contiguous rows (bounds read beforehand), "
                           "gelu' and gelu between on the f32 s",
                   plain="grouped_ffn_backward_plain_by_expert (bf16 "
                         "rounding points, f32 products)")
        row.update(forward_route=gf.ffn_route(xt.shape[0], 8, E),
                   forward_max_abs_err=fwd_err)
        if name == "steady_tick":        # the trainer's forward, s kept
            row["forward"] = _k4_forward_row(gf, xt, eid, w1, w2)
        print("kernel_case " + json.dumps(row), flush=True)
        rows_out[name] = row
        del xt, w1, w2, g, s, dxt, ds, u, plan
        torch.cuda.empty_cache()
    return rows_out


def _tie_gaps(probs, k):
    """Each row's gaps, from its probabilities sorted in descending order:
    ``(k-th - (k+1)-th``, the gap a change of the chosen set crosses, and
    the least gap between neighbours among the first k, the one a change
    of their order crosses; inf where there is none), on the host."""
    srt = torch.sort(probs, dim=-1, descending=True).values
    nxt = srt[..., min(k, srt.shape[-1] - 1)]
    order = (srt[..., :k - 1] - srt[..., 1:k]).amin(-1) if k > 1 \
        else torch.full_like(nxt, float("inf"))
    return (srt[..., k - 1] - nxt).detach().cpu(), order.detach().cpu()


class _Routing:
    """Records every ``router_topk`` call's top-k ids and its tie gaps
    (:func:`_tie_gaps`, on the host), or forces the ids of a recorded run
    onto a replay (gates taken from the replay's own probabilities at
    those ids); either way it keeps each call's probabilities."""

    def __init__(self, layers_mod):
        self.mod, self.orig = layers_mod, layers_mod.router_topk
        self.calls, self.probs, self.force, self.i = [], [], None, 0

    def __call__(self, x, wr, *, top_k):
        logits, probs, idx, gate = self.orig(x, wr, top_k=top_k)
        self.probs.append(probs.detach().cpu())
        if self.force is not None:
            idx = self.force[self.i].to(idx.device)
            gate = probs.gather(-1, idx)
            if top_k > 1:
                gate = gate / gate.sum(-1, keepdim=True)
            self.i += 1
            return logits, probs, idx, gate
        self.calls.append((idx.cpu(), _tie_gaps(probs, top_k)))
        return logits, probs, idx, gate


def moe_train_phase(fa, gf, layers_mod, smi, profile=False):
    """Phase 12b: MoE training at full width (lm_bench's widths, 8 experts
    top-2, dropless, group tile 8) at dp 2 x pp 2 x tp 2: launch counts,
    falling loss, the probe, peak memory, and step 1 replayed through the
    plain versions (plain K1/K2, the per-expert K4)."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.fusion import tree_flatten
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose
    cfg = moe_model.MoELMConfig(vocab=32768, d_model=1024, heads=16,
                                layers=4, seq_len=2048, micro=4, batch=4,
                                num_experts=8, top_k=2, dispatch="dropless",
                                group_tile=8)
    m = compose.compose_parallelism(2, 2, 2, 1, device=DEV,
                                    num_experts=cfg.num_experts,
                                    capacity_factor=cfg.capacity_factor)
    grad_fn = moe_model.make_moe_grad_fn(cfg, m)
    recorded, record = [], [True]

    def recording(params, toks):
        loss, grads = grad_fn(params, toks)
        if record[0]:                 # kept on the host: the peak stays
            recorded.append([g.cpu() for g in       # the path's own
                             tree_flatten(grads)[0]])
        return loss, grads

    step, strategy = compose.make_train_step(m, recording, bfopt.adam(5e-3),
                                             delayed=True)
    t0 = time.monotonic()
    init = moe_model.init_moe_train_params(cfg, m, seed=0)
    toks = moe_model.make_moe_batch(cfg, m, seed=0)
    init_s = time.monotonic() - t0
    params = {g: {k: v.clone() for k, v in d.items()}
              for g, d in init.items()}
    state = bfopt.init_distributed(strategy, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routing = _Routing(layers_mod)

    # -- the main path: counts at 0, 1 warm-up + 3 timed steps, counts read
    steps = 4
    _launch_counts(fa, gf, reset=True)
    losses = []
    # step 1 also counts the K4 operands that _aligned / _pad_widths copy
    # (none at these shapes: D 1024 and F / tp 2048 are multiples of 8, and
    # every peer's weight block starts on a 16-byte boundary)
    copies = {"aligned": 0, "padded": 0}
    aligned, pad = gf._aligned, gf._pad_widths

    def counted_aligned(t):
        copies["aligned"] += t.data_ptr() % 16 != 0
        return aligned(t)

    def counted_pad(xt, w1, w2):
        out = pad(xt, w1, w2)
        copies["padded"] += out[0] is not xt
        return out

    with mock.patch.object(layers_mod, "router_topk", routing), \
            mock.patch.object(gf, "_aligned", counted_aligned), \
            mock.patch.object(gf, "_pad_widths", counted_pad):
        params, state, loss = step(params, state, toks)
    losses.append(loss.tolist())
    record[0] = False
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps - 1):
        params, state, loss = step(params, state, toks)
        losses.append(loss.tolist())
    torch.cuda.synchronize()
    per_step = (time.monotonic() - t0) / (steps - 1)
    launches = _launch_counts(fa, gf)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # per replica, one launch of each per GPipe tick and layer of a stage:
    # every live stage, tp and sp peer of the tick is folded into it
    want = m.dp * (cfg.micro + m.pp - 1) * (cfg.layers // m.pp) * steps
    # every K4 forward on the forward_gemm route (65,536 rows over 32
    # folded experts a call), whose plan its backward takes: one plan a call
    if set(launches.values()) != {want}:
        raise AssertionError(
            f"moe_train: launches {launches}, want dp x (micro + pp - 1) x "
            f"layers / pp x steps = {want} each")
    mean = [float(np.mean(x)) for x in losses]
    if not (np.isfinite(mean).all() and mean[-1] < mean[0]):
        raise AssertionError(f"moe_train: loss did not fall: {mean}")
    health = moe_model.make_moe_probe(cfg, m)(params, toks)
    if not (health["dropped_fraction"] == 0.0
            and abs(sum(health["usage"]) - 1.0) < 1e-5
            and all(np.isfinite(v).all() for v in health.values())):
        raise AssertionError(f"moe_train: probe {health}")
    del params, state
    torch.cuda.empty_cache()
    kernel_rec = recorded[:]
    kernel_calls = routing.calls

    # -- the f32 noise floor of step 1's gradients: the kernel path on
    #    the kernel run's routing with the embedding table moved by one
    #    ulp; summed over ~32k tokens a replica, rounding-sized changes of
    #    each token's cotangent move these gradients by ~1e-4 of their
    #    largest entry, so the replay below is held to the larger of
    #    1e-4 x max|g| and twice this floor, leaf by leaf
    p1 = {g: {k: v.clone() for k, v in d.items()} for g, d in init.items()}
    p1["shared"]["embed"].mul_(1 + 2 ** -23)
    noise_router = _Routing(layers_mod)
    noise_router.force = [i for i, _ in kernel_calls]
    with mock.patch.object(layers_mod, "router_topk", noise_router):
        _, noise = bfopt.stacked_grads(grad_fn, p1, toks, m.slice_size)
    noise = [x.cpu() for x in tree_flatten(noise)[0]]
    del p1
    torch.cuda.empty_cache()

    # -- replay step 1 from the same init through the plain versions
    plain = (mock.patch.object(fa, "attention_block_partial",
                               fa.attention_block_partial_plain),
             mock.patch.object(fa, "attention_block_backward",
                               fa.attention_block_backward_plain),
             mock.patch.object(gf, "grouped_ffn",
                               gf.grouped_ffn_plain_by_expert))

    def replay(router):
        recorded.clear()
        record[0] = True
        p0 = {g: {k: v.clone() for k, v in d.items()}    # the step updates
              for g, d in init.items()}                  # params in place
        state = bfopt.init_distributed(strategy, p0)
        with plain[0], plain[1], plain[2], \
                mock.patch.object(layers_mod, "router_topk", router):
            _, _, loss = step(p0, state, toks)
        record[0] = False
        del p0, state
        return loss.tolist()

    before = _launch_counts(fa, gf)  # the probe's forward launched too
    replay_routing = _Routing(layers_mod)
    replay_loss = replay(replay_routing)
    if len(kernel_calls) != len(replay_routing.calls):
        raise AssertionError("moe_train: the replay routed another number "
                             "of times")
    # each replica's first router call with a flip must flip only at near
    # ties (rounding moves a probability by ~1e-7); later flips may follow
    # from that one through the layers and the attention, and are counted
    flips, first_gaps = 0, []
    per_replica = len(kernel_calls) // m.dp
    for r in range(m.dp):
        first = True
        for (ki, (kg, _)), (pi, _) in zip(
                kernel_calls[r * per_replica:(r + 1) * per_replica],
                replay_routing.calls[r * per_replica:(r + 1) * per_replica]):
            diff = (ki != pi).any(-1)
            flips += int(diff.sum())
            if first and bool(diff.any()):
                first_gaps.append(float(kg[diff].max()))
                first = False
    if first_gaps and max(first_gaps) >= 1e-5:
        raise AssertionError(f"moe_train: routing flips away from a near "
                             f"tie (k-th to (k+1)-th gap {max(first_gaps)})")
    forced = flips > 0
    if forced:                       # replay again on the kernel's routing
        replay_routing.force = [i for i, _ in kernel_calls]
        replay_loss = replay(replay_routing)
    if _launch_counts(fa, gf) != before:
        raise AssertionError("moe_train: the plain replay launched a kernel")
    if not np.allclose(replay_loss, losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"moe_train: plain replay loss {replay_loss} "
                             f"!= kernel loss {losses[0]}")
    names = [f"{g}/{k}" for g in sorted(init) for k in sorted(init[g])]
    grad_err, leaf_err, leaf_floor, bad = 0.0, {}, {}, []
    n = m.slice_size
    for r, (gk, gp) in enumerate(zip(kernel_rec, recorded)):
        for name, a, b, z in zip(names, gk, gp, noise):
            err, ok = _grad_err(a.to(DEV), b.to(DEV))
            floor = float((a - z[r * n:(r + 1) * n]).abs().max())
            top = max(float(b.abs().max()), 1e-30)
            grad_err = max(grad_err, err / top)
            leaf_err[name] = max(leaf_err.get(name, 0.0), err / top)
            leaf_floor[name] = max(leaf_floor.get(name, 0.0), floor / top)
            if not (ok or err <= 2 * floor):
                bad.append((r, name, err, floor, top))
    if bad:
        raise AssertionError(f"moe_train: step-1 gradients of the plain "
                             f"replay differ (replica, leaf, err, one-ulp "
                             f"floor, max|g|): {bad}; relative errors "
                             f"{leaf_err}, floors {leaf_floor}; routing "
                             f"flips {flips} (first gaps {first_gaps}, "
                             f"forced {forced})")
    del kernel_rec, recorded[:], noise
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    summary = {
        "mesh": m.describe(), "n_params": cfg.n_params,
        "n_active_params": cfg.n_active_params,
        "config": {"layers": cfg.layers, "micro": cfg.micro,
                   "batch": cfg.batch, "seq": cfg.seq_len,
                   "num_experts": cfg.num_experts, "top_k": cfg.top_k,
                   "group_tile": cfg.group_tile, "remat": False},
        "timed_steps": steps - 1, "per_step_s": per_step,
        "tokens_per_step": tokens, "tokens_per_s": tokens / per_step,
        "model_flops_per_s": tokens / per_step * cfg.flops_per_token(),
        "mfu_f32": tokens / per_step * cfg.flops_per_token() / F32_FLOPS,
        "losses_mean": mean, "replay_loss": replay_loss,
        "step1_grad_rel_err": grad_err, "step1_grad_rel_err_by_leaf": leaf_err,
        "step1_grad_one_ulp_floor_by_leaf": leaf_floor,
        "routing_flips": flips,
        "first_flip_tie_gaps": first_gaps, "replay_forced_routing": forced,
        "probe": health, "launches": launches,
        "k4_operand_copies_step1": copies,
        "launch_formula": "dp x (micro + pp - 1) x layers / pp x steps",
        "peak_mem_gb": peak, "init_s": init_s,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("moe_train " + json.dumps(summary), flush=True)
    if profile:
        profile_moe_train(step, strategy, init, toks)
    del step, strategy, init, toks
    torch.cuda.empty_cache()
    return launches, summary


def profile_moe_train(step, strategy, init, toks):
    """One MoE train step under torch.profiler: device busy over wall, and
    the device ms and share of K1, K2, K4's forward and its backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bluefog_tpu_torch import optimizers as bfopt
    state = bfopt.init_distributed(strategy, init)
    params, state, _ = step(init, state, toks)
    torch.cuda.synchronize()
    t0, counts = time.monotonic(), _plan_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, _ = step(params, state, toks)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.monotonic() - t0)
    plan_fwd = _plan_fwd(counts)
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:15]:
        print("profile_moe_train " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))

    def parts(key):
        if "flash_fwd" in key:
            return {"K1": 1.0}
        if "flash_bwd" in key:
            return {"K2": 1.0}
        return _k4_parts(key, plan_fwd)

    ms = {k: 0.0 for k in ("K1", "K2", "K4_forward", "K4_backward")}
    for dt, key, _ in rows:
        for kind, share in parts(key).items():
            ms[kind] += share * dt / 1e3
    print("profile_moe_train " + json.dumps({
        "step_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_ms, "kernel_device_ms": ms,
        "kernel_shares": {k: v * 1e3 / total_us for k, v in ms.items()},
        "device": torch.cuda.get_device_name(0)}), flush=True)
    del params, state


# -- phases 12c-12d: expert parallelism, capacity dispatch, expert choice --

def _moe_cfg(**kw):
    """Phase 12b's full-width MoE config (lm_bench's widths, 8 experts
    top-2, dropless, group tile 8, micro 4) with ``kw`` over it."""
    from bluefog_tpu_torch.moe import model as moe_model
    base = dict(vocab=32768, d_model=1024, heads=16, layers=4, seq_len=2048,
                micro=4, batch=4, num_experts=8, top_k=2, dispatch="dropless",
                group_tile=8)
    base.update(kw)
    return moe_model.MoELMConfig(**base)


def _launch_counts(fa, gf, reset=False):
    """The kernels' launch counts (set to 0 first with ``reset``): with
    K4's forward calls (``grouped_ffn``, either route) those on its
    ``forward_gemm`` route apart."""
    pairs = ((fa, "fwd_launches"), (fa, "bwd_launches"),
             (gf.grouped_ffn_cuda, "launches"),
             (gf.grouped_ffn_cuda, "gemm_launches"),
             (gf.grouped_ffn_dgrad_cuda, "launches"),
             (gf.grouped_ffn_wgrad_cuda, "launches"),
             (gf.backward_plan_cuda, "launches"))
    if reset:
        for obj, attr in pairs:
            setattr(obj, attr, 0)
    return dict(zip(("flash_fwd", "flash_bwd", "grouped_ffn",
                     "grouped_ffn_forward_gemm", "grouped_ffn_dgrad",
                     "grouped_ffn_wgrad", "grouped_ffn_backward_plan"),
                    (getattr(obj, attr) for obj, attr in pairs)))


K4_FORWARD_GEMM = {}      # serving path -> its K4 forwards on forward_gemm


@contextlib.contextmanager
def _k4_route_tally(gf):
    """K4's forwards on the card tallied by the route their shapes pick:
    ``gf.grouped_ffn`` wrapped, each CUDA call counted (``calls``) and,
    when ``ffn_route`` sends its shapes (G, tile, the experts, the
    live-row hint) to ``forward_gemm``, counted there too."""
    tally = {"calls": 0, "forward_gemm": 0}
    orig = gf.grouped_ffn

    def counting(xt, tile_eid, w1, w2, rows=None):
        if xt.is_cuda:
            tally["calls"] += 1
            tally["forward_gemm"] += gf.ffn_route(
                xt.shape[0], xt.shape[1], gf._experts(w1)[0],
                rows or 0) == "forward_gemm"
        return orig(xt, tile_eid, w1, w2, rows=rows)

    with mock.patch.object(gf, "grouped_ffn", counting):
        yield tally


def _gate_k4_routes(tag, gf, tally):
    """A serving path's K4 forwards on the routes their shapes pick: the
    forward calls and ``forward_gemm`` launches counted since the path set
    them to 0 equal :func:`_k4_route_tally`'s count of the calls and of
    those whose shapes take ``forward_gemm``; printed, and kept under
    ``tag`` for the kernels line."""
    got = {"calls": gf.grouped_ffn_cuda.launches,
           "forward_gemm": gf.grouped_ffn_cuda.gemm_launches}
    if got != tally:
        raise AssertionError(f"{tag}: K4 forwards {got}, want by their "
                             f"shapes {tally}")
    K4_FORWARD_GEMM[tag] = got["forward_gemm"]
    print("k4_routes " + json.dumps({
        "path": tag, **got,
        "expert_rows": got["calls"] - got["forward_gemm"]}), flush=True)
    return got["forward_gemm"]


class _ECRouting:
    """:class:`_Routing` for ``router_expert_choice``: records each call's
    picks and their tie gaps over the tokens (:func:`_tie_gaps` at C), or
    forces a recorded run's picks onto a replay (gates from the replay's
    own probabilities)."""

    def __init__(self, layers_mod):
        self.orig = layers_mod.router_expert_choice
        self.calls, self.probs, self.force, self.i = [], [], None, 0

    def __call__(self, x, wr, *, capacity):
        logits, probs, sel, gate = self.orig(x, wr, capacity=capacity)
        self.probs.append(probs.detach().cpu())
        pt = probs.transpose(-1, -2)
        if self.force is not None:
            sel = self.force[self.i].to(sel.device)
            self.i += 1
            return logits, probs, sel, pt.gather(-1, sel)
        self.calls.append((sel.cpu(), _tie_gaps(pt, capacity)))
        return logits, probs, sel, gate


def _prob_noise(a, b):
    """Per router call, the largest change of a routing probability
    between two runs' recorded calls (``_Routing.probs``)."""
    return [float((x - y).abs().max()) for x, y in zip(a, b)]


def _flips(kernel_calls, replay_calls, dp, tag, noise):
    """Routing flips between two runs' router calls: rows whose chosen
    set differs, or only its order.  Each replica's first call with a
    flip must flip at near ties only: the set's gap for a set change, the
    order's for an order change, below the larger of 1e-5 and twice
    ``noise[call]``, how far a one-ulp move of the embedding moves that
    call's probabilities (measured in the same run).  Returns ``(flips,
    first gaps)``."""
    if len(kernel_calls) != len(replay_calls):
        raise AssertionError(f"{tag}: the runs routed another number of "
                             f"times ({len(kernel_calls)} vs "
                             f"{len(replay_calls)})")
    flips, first_gaps, bad = 0, [], []
    per = len(kernel_calls) // dp
    for r in range(dp):
        first = True
        for c in range(r * per, (r + 1) * per):
            (ki, (gset, gorder)), pi = kernel_calls[c], replay_calls[c][0]
            pi = pi.reshape(ki.shape)
            diff = (ki != pi).any(-1)
            moved = (ki.sort(-1).values != pi.sort(-1).values).any(-1)
            flips += int(diff.sum())
            if first and bool(diff.any()):
                gap = float(torch.where(moved, gset, gorder)[diff].max())
                first_gaps.append(gap)
                if gap >= max(1e-5, 2 * noise[c]):
                    bad.append((c, gap, noise[c]))
                first = False
    if bad:
        raise AssertionError(f"{tag}: routing flips away from a near tie "
                             f"(call, gap, one-ulp probability noise): "
                             f"{bad}")
    return flips, first_gaps


class _MoERun:
    """One full-width MoE trainer on the card (the main path): the launch
    counts set to 0 just before its ``steps`` steps (the first untimed)
    and read just after, step 1's gradients kept on the host and its
    router calls recorded, the probe on the final params; then
    :meth:`grads` gives step-1 losses and gradients from the same init
    under other kernels, a forced routing or a moved embedding."""

    def __init__(self, fa, gf, layers_mod, cfg, m, steps, hooks=(),
                 dtype=torch.float32):
        from bluefog_tpu_torch import optimizers as bfopt
        from bluefog_tpu_torch.fusion import tree_flatten
        from bluefog_tpu_torch.moe import model as moe_model
        from bluefog_tpu_torch.parallel import compose
        self.fa, self.gf, self.mod = fa, gf, layers_mod
        self.cfg, self.m = cfg, m
        self.ec = cfg.router_mode == "expert_choice"
        self.grad_fn = moe_model.make_moe_grad_fn(cfg, m)
        recorded, record = [], [True]

        def recording(params, toks):
            loss, grads = self.grad_fn(params, toks)
            if record[0]:             # kept on the host
                recorded.append([g.cpu() for g in tree_flatten(grads)[0]])
            return loss, grads

        step, self.strategy = compose.make_train_step(
            m, recording, bfopt.adam(5e-3), delayed=True)
        self.step = step
        self.init = moe_model.init_moe_train_params(cfg, m, seed=0,
                                                    dtype=dtype)
        self.toks = moe_model.make_moe_batch(cfg, m, seed=0)
        self.names = [f"{g}/{k}" for g in sorted(self.init)
                      for k in sorted(self.init[g])]
        params = {g: {k: v.clone() for k, v in d.items()}
                  for g, d in self.init.items()}
        state = bfopt.init_distributed(self.strategy, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.routing = self._router()
        losses = []
        _launch_counts(fa, gf, reset=True)
        with self._route(self.routing):
            for hook in hooks:
                hook.__enter__()
            params, state, loss = step(params, state, self.toks)
            for hook in hooks:
                hook.__exit__(None, None, None)
        losses.append(loss.tolist())
        record[0] = False
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(steps - 1):
            params, state, loss = step(params, state, self.toks)
            losses.append(loss.tolist())
        torch.cuda.synchronize()
        self.per_step = (time.monotonic() - t0) / (steps - 1)
        self.launches = _launch_counts(fa, gf)
        self.peak = torch.cuda.max_memory_allocated() / 2 ** 30
        self.dtypes = sorted({str(x.dtype) for x in tree_flatten(params)[0]}
                             | {str(x.dtype) for x in recorded[0]})
        self.losses = losses
        self.mean = [float(np.mean(x)) for x in losses]
        self.health = moe_model.make_moe_probe(cfg, m)(params, self.toks)
        self.health_init = moe_model.make_moe_probe(cfg, m)(self.init,
                                                            self.toks)
        self.step1 = recorded[:]
        del params, state
        torch.cuda.empty_cache()

    def _router(self):
        return (_ECRouting if self.ec else _Routing)(self.mod)

    def _route(self, router):
        name = "router_expert_choice" if self.ec else "router_topk"
        return mock.patch.object(self.mod, name, router)

    def grads(self, router=None, plain=False, ulp=0):
        """Step 1 from the init: ``(losses [n], leaves per replica on the
        host)``; ``plain`` through plain K1/K2 and the per-expert K4,
        ``ulp`` (+1 or -1) with the embedding moved by one ulp of its type
        up or down."""
        from bluefog_tpu_torch import optimizers as bfopt
        from bluefog_tpu_torch.fusion import tree_flatten
        fa, gf = self.fa, self.gf
        p0 = {g: {k: v.clone() for k, v in d.items()}
              for g, d in self.init.items()}
        if ulp:
            embed = p0["shared"]["embed"]
            embed.mul_(1 + ulp * torch.finfo(embed.dtype).eps)
        patches = [self._route(router or self._router())]
        if plain:
            patches += [mock.patch.object(fa, "attention_block_partial",
                                          fa.attention_block_partial_plain),
                        mock.patch.object(fa, "attention_block_backward",
                                          fa.attention_block_backward_plain),
                        mock.patch.object(gf, "grouped_ffn",
                                          gf.grouped_ffn_plain_by_expert)]
        before = _launch_counts(fa, gf)
        for p in patches:
            p.__enter__()
        try:
            loss, grads = bfopt.stacked_grads(self.grad_fn, p0, self.toks,
                                              self.m.slice_size)
        finally:
            for p in reversed(patches):
                p.__exit__(None, None, None)
        if plain and _launch_counts(fa, gf) != before:
            raise AssertionError("the plain replay launched a kernel")
        n, k = self.m.dp, self.m.slice_size
        leaves = [g.cpu() for g in tree_flatten(grads)[0]]
        del p0, grads
        torch.cuda.empty_cache()
        per = [[x[r] if k == 1 else x[r * k:(r + 1) * k] for x in leaves]
               for r in range(n)]
        return loss.tolist(), per

    def replica_loss(self, losses):
        """Each replica's step loss (its peers all report it)."""
        return [float(x) for x in np.asarray(losses).reshape(
            self.m.dp, -1)[:, 0]]


def _grad_gate(tag, names, got, want, floor_of, join=None, rel=1e-4):
    """Every leaf of ``got`` (per replica) within the larger of ``rel`` x
    max|want| and twice its one-ulp floor ``floor_of(r, i)``; ``join``
    maps a leaf to ``want``'s layout.  Returns the relative errors and
    floors by leaf."""
    leaf_err, leaf_floor, bad = {}, {}, []
    for r, (gr, wr) in enumerate(zip(got, want)):
        for i, (name, a, b) in enumerate(zip(names, gr, wr)):
            if join is not None:
                a = join(name, a)
            a, b = a.reshape(b.shape).float(), b.float()
            err = float((a - b).abs().max())
            top = max(float(b.abs().max()), 1e-30)
            floor = floor_of(r, i)
            leaf_err[name] = max(leaf_err.get(name, 0.0), err / top)
            leaf_floor[name] = max(leaf_floor.get(name, 0.0), floor / top)
            if not (err <= rel * top + 1e-6 or err <= 2 * floor):
                bad.append((r, name, err, floor, top))
    if bad:
        raise AssertionError(f"{tag}: step-1 gradients differ (replica, "
                             f"leaf, err, one-ulp floor, max|g|): {bad}; "
                             f"relative {leaf_err}, floors {leaf_floor}")
    return leaf_err, leaf_floor


def _k4_parts(key, plan_fwd):
    """K4's parts of a profiled kernel by its name, each with its share of
    the kernel's time: the forward's routes (``expert_rows``,
    ``forward_gemm`` / ``forward_gemm16``), the backward
    (``backward_gemm*``, ``wgrad_parts_sum``), and ``backward_plan``
    split between them: ``plan_fwd`` is the share of the profiled step's
    plan launches that ``forward_gemm`` calls made (their backward then
    takes that plan), the rest the backward's own; {} for another
    kernel."""
    if "backward_plan" in key:
        return {"K4_forward": plan_fwd, "K4_backward": 1.0 - plan_fwd}
    if any(k in key for k in ("expert_rows", "forward_gemm")):
        return {"K4_forward": 1.0}
    if any(k in key for k in ("backward_gemm", "wgrad_parts_sum")):
        return {"K4_backward": 1.0}
    return {}


def _plan_counts():
    """``(forward_gemm calls, plan launches)`` so far: their changes over
    a profiled step give :func:`_k4_parts`'s ``plan_fwd``."""
    from bluefog_tpu_torch.ops import grouped_ffn as gf
    return gf.grouped_ffn_cuda.gemm_launches, gf.backward_plan_cuda.launches


def _plan_fwd(before):
    """The share of the plan launches since ``before`` (a
    :func:`_plan_counts`) that ``forward_gemm`` calls made."""
    gemm, plans = (a - b for a, b in zip(_plan_counts(), before))
    return gemm / plans if plans else 0.0


def _profile_k4(run):
    """One more step from the init under torch.profiler: the device ms of
    K4's forward, its backward and the trash tiles' zero writes, and the
    step's busy and wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bluefog_tpu_torch import optimizers as bfopt
    p0 = {g: {k: v.clone() for k, v in d.items()}
          for g, d in run.init.items()}
    state = bfopt.init_distributed(run.strategy, p0)
    p0, state, _ = run.step(p0, state, run.toks)
    torch.cuda.synchronize()
    t0, counts = time.monotonic(), _plan_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p0, state, _ = run.step(p0, state, run.toks)
        torch.cuda.synchronize()
    wall = 1e3 * (time.monotonic() - t0)
    plan_fwd = _plan_fwd(counts)
    ms = {"K4_forward": 0.0, "K4_backward": 0.0, "K4_trash_zeros": 0.0,
          "K1": 0.0, "K2": 0.0}
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt, key = ev.self_device_time_total / 1e3, ev.key
        busy += dt
        parts = ({"K4_trash_zeros": 1.0} if "zero_marked_tiles" in key
                 else _k4_parts(key, plan_fwd) or (
                     {"K1": 1.0} if "flash_fwd" in key
                     else {"K2": 1.0} if "flash_bwd" in key else {}))
        for kind, share in parts.items():
            ms[kind] += share * dt
    del p0, state
    torch.cuda.empty_cache()
    return dict(ms, busy_ms=busy, wall_ms=wall, busy_share=busy / wall)


def _trash_evidence(gf, cap):
    """One captured K4 call of the ep-2 run: its trash tiles, and the
    forward and forward + backward timed cold with them marked (the main
    path) against the same layout with them clamped onto each owner's
    last expert (tile_layout's own ids, which K4 would compute on)."""
    xt, eid, w1, w2, rows = (cap[k] for k in ("xt", "eid", "w1", "w2",
                                              "rows"))
    G, P, el = eid.numel(), w1.shape[0], w1.shape[1]
    owner = torch.arange(G, device=DEV) // (G // P)
    clamped = torch.where(eid < 0, owner * el + el - 1, eid).to(torch.int32)
    g = torch.randn_like(xt) * (eid >= 0)[:, None, None]
    trash = int((eid < 0).sum())

    def fwd_bwd(ids, hint):
        x, a, b = (z.detach().requires_grad_() for z in (xt, w1, w2))
        out = gf.grouped_ffn(x, ids, a, b, rows=hint)
        out.backward(g)

    t = {}
    for name, ids, hint in (("marked", eid, rows), ("clamped", clamped,
                                                     None)):
        t[name] = {
            "fwd_ms": _device_ms(lambda: gf.grouped_ffn_cuda(
                xt, ids, w1, w2, hint), cold=True, iters=5, warmup=1),
            "fwd_bwd_ms": _device_ms(lambda: fwd_bwd(ids, hint), cold=True,
                                     iters=5, warmup=1)}
        t[name]["bwd_ms"] = t[name]["fwd_bwd_ms"] - t[name]["fwd_ms"]
    return {"tiles_per_call": G, "trash_tiles_per_call": trash,
            "rows_per_call": G * xt.shape[1], "live_rows_hint": rows,
            "owners": P, "experts_per_owner": el, **t,
            "marked_over_clamped_fwd": t["marked"]["fwd_ms"]
            / t["clamped"]["fwd_ms"],
            "marked_over_clamped_bwd": t["marked"]["bwd_ms"]
            / t["clamped"]["bwd_ms"]}


def moe_ep_phase(fa, gf, layers_mod, smi):
    """Phase 12c: MoE training at ep 2 (dp 2 x ep 2) and its ep-1 twin (dp
    2) at phase 12b's widths: launch counts, the same step-1 loss and
    gradients as the twin (experts joined over the ep peers), a plain
    replay, the probe, K4's device ms per step and the trash tiles."""
    from bluefog_tpu_torch.parallel import compose
    cfg = _moe_cfg()
    steps = 2                 # 1 warm-up + 1 timed (see the docstring)
    out = {}
    cap = {}
    orig = gf.grouped_ffn

    def capturing(xt, eid, w1, w2, rows=None):
        if not cap:                   # the first K4 call of step 1
            cap.update(xt=xt.detach().clone(), eid=eid.clone(),
                       w1=w1.detach().clone(), w2=w2.detach().clone(),
                       rows=rows)
        return orig(xt, eid, w1, w2, rows=rows)

    def carve(ep):
        return compose.compose_parallelism(
            2, 1, 1, 1, ep, device=DEV, num_experts=cfg.num_experts,
            capacity_factor=cfg.capacity_factor)

    # -- the ep-2 run: the main path, then its one-ulp floor and replay
    m = carve(2)
    run = _MoERun(fa, gf, layers_mod, cfg, m, steps,
                  hooks=(mock.patch.object(gf, "grouped_ffn", capturing),))
    want = m.dp * cfg.micro * cfg.layers * steps
    if set(run.launches.values()) != {want}:
        raise AssertionError(f"moe_train_ep2: launches {run.launches}, "
                             f"want dp x micro x layers x steps = {want}")
    if not (np.isfinite(run.mean).all() and run.mean[-1] < run.mean[0]):
        raise AssertionError(f"moe_train_ep2: loss did not fall {run.mean}")
    if not (run.health["dropped_fraction"] == 0.0
            and abs(sum(run.health["usage"]) - 1.0) < 1e-5):
        raise AssertionError(f"moe_train_ep2: probe {run.health}")
    for r, leaves in enumerate(run.step1):      # non-expert grads: equal
        for name, g in zip(run.names, leaves):  # on every ep peer
            if not name.startswith("experts/") and not torch.equal(
                    g, g[:1].expand_as(g)):
                raise AssertionError(f"moe_train_ep2: {name} differs "
                                     f"over the ep peers of replica {r}")
    # the f32 noise floor of step 1, as in 12b, from the embedding moved
    # one ulp up and one down (each leaf's larger change: one direction
    # alone can sample a leaf's floor ~2x low at these widths), on the
    # kernel run's routing; and how far that moves the router's
    # probabilities
    kernel_calls = run.routing.calls
    floor, p_noise = None, None
    for step in (1, -1):
        forced = _Routing(layers_mod)
        forced.force = [i for i, _ in kernel_calls]
        _, noise = run.grads(forced, ulp=step)
        f = [[float((a - b).abs().max()) for a, b in zip(k, z)]
             for k, z in zip(run.step1, noise)]
        pn = _prob_noise(run.routing.probs, forced.probs)
        floor = f if floor is None else [
            [max(a, b) for a, b in zip(x, y)] for x, y in zip(floor, f)]
        p_noise = pn if p_noise is None else [
            max(a, b) for a, b in zip(p_noise, pn)]
        del noise
    replay_router = _Routing(layers_mod)
    replay_loss, replay = run.grads(replay_router, plain=True)
    flips, gaps = _flips(kernel_calls, replay_router.calls, m.dp,
                         "moe_train_ep2 replay", p_noise)
    if flips:                         # the replay on the kernel's routing
        forced.i = 0
        replay_loss, replay = run.grads(forced, plain=True)
    if not np.allclose(replay_loss, run.losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"moe_train_ep2: plain replay loss "
                             f"{replay_loss} != {run.losses[0]}")
    rep_err, rep_floor = _grad_gate(
        "moe_train_ep2 replay", run.names, replay, run.step1,
        lambda r, i: floor[r][i])
    del replay
    k4_ms = _profile_k4(run)
    evidence = _trash_evidence(gf, cap)
    cap.clear()
    ep2 = {"run": run, "calls": kernel_calls, "floor": floor,
           "replay": {"loss": replay_loss, "flips": flips,
                      "first_flip_tie_gaps": gaps, "forced": bool(flips),
                      "one_ulp_prob_noise_max": max(p_noise),
                      "grad_rel_err_by_leaf": rep_err,
                      "one_ulp_floor_by_leaf": rep_floor},
           "k4_ms": k4_ms}
    run.init = run.toks = None
    torch.cuda.empty_cache()

    # -- the ep-1 twin: same widths, data and init values
    m1 = carve(1)
    twin = _MoERun(fa, gf, layers_mod, cfg, m1, steps)
    if set(twin.launches.values()) != {want}:
        raise AssertionError(f"moe_train_ep2_twin: launches "
                             f"{twin.launches}, want {want} each")
    if not np.allclose(run.replica_loss(run.losses[0]),
                       twin.replica_loss(twin.losses[0]), rtol=1e-5,
                       atol=0):
        raise AssertionError(f"moe_train_ep2: step-1 loss "
                             f"{run.losses[0]} != the twin's "
                             f"{twin.losses[0]}")
    # the ep-2 run's routing on the twin's layout (ep peer e holds batch
    # rows e * B / 2 ..): flips only at near ties; on any, the twin's
    # gradient is taken again on the ep-2 run's routing
    tflips, tgaps = _flips(kernel_calls, twin.routing.calls, m.dp,
                           "moe_train_ep2 vs twin", p_noise)
    twin_step1 = twin.step1
    if tflips:
        to_twin = _Routing(layers_mod)
        to_twin.force = [i.reshape(t.shape) for (i, _), (t, _) in
                         zip(kernel_calls, twin.routing.calls)]
        _, twin_step1 = twin.grads(to_twin)
    usage_diff = max(abs(a - b) for a, b in zip(
        run.health_init["usage"], twin.health_init["usage"]))
    if usage_diff > 1e-4:
        raise AssertionError(f"moe_train_ep2: probe usage "
                             f"{run.health_init['usage']} != the twin's "
                             f"{twin.health_init['usage']}")

    def join(name, g):                # [ep, L, E / ep, ...] -> [L, E, ...]
        return torch.cat(list(g), 1) if name.startswith("experts/") \
            else g[0]

    twin_err, twin_floor = _grad_gate(
        "moe_train_ep2 vs twin", run.names, run.step1, twin_step1,
        lambda r, i: floor[r][i], join=join)
    twin_k4 = _profile_k4(twin)
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    for tag, r_, k4 in (("moe_train_ep2", run, k4_ms),
                        ("moe_train_ep2_twin", twin, twin_k4)):
        out[tag] = {
            "mesh": r_.m.describe(), "timed_steps": steps - 1,
            "per_step_s": r_.per_step, "tokens_per_step": tokens,
            "tokens_per_s": tokens / r_.per_step,
            "model_flops_per_s": tokens / r_.per_step
            * cfg.flops_per_token(),
            "peak_mem_gb": r_.peak, "losses_mean": r_.mean,
            "launches": r_.launches, "probe": r_.health,
            "k4_device_ms_per_step": k4,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    out["moe_train_ep2"].update(
        replay=ep2["replay"], step1_loss=run.replica_loss(run.losses[0]),
        twin_step1_loss=twin.replica_loss(twin.losses[0]),
        twin_routing_flips=tflips, twin_first_flip_tie_gaps=tgaps,
        twin_grad_rel_err_by_leaf=twin_err,
        one_ulp_floor_by_leaf=twin_floor, probe_usage_diff=usage_diff,
        trash_tiles=evidence,
        k4_fwd_over_twin=k4_ms["K4_forward"] / twin_k4["K4_forward"],
        k4_bwd_over_twin=k4_ms["K4_backward"] / twin_k4["K4_backward"],
        launch_formula="dp x micro x layers x steps (pp 1)")
    for tag, summ in out.items():
        print(tag + " " + json.dumps(summ), flush=True)
    del run, twin
    torch.cuda.empty_cache()
    return {tag: summ["launches"] for tag, summ in out.items()}, out


def moe_route_phase(fa, gf, layers_mod, smi, tag, **kw):
    """Phase 12d: capacity dispatch or expert choice at dp 2 x ep 2,
    phase 12b's widths: K1/K2 launch counts by the formula and no K4, a
    falling loss, step 1 replayed through plain K1/K2 (loss rtol 1e-5),
    and the routing health."""
    from bluefog_tpu_torch.parallel import compose
    cfg = _moe_cfg(**kw)
    m = compose.compose_parallelism(2, 1, 1, 1, 2, device=DEV,
                                    num_experts=cfg.num_experts,
                                    capacity_factor=cfg.capacity_factor)
    steps = 2                 # 1 warm-up + 1 timed (2 before phase 21)
    run = _MoERun(fa, gf, layers_mod, cfg, m, steps)
    want = m.dp * cfg.micro * cfg.layers * steps
    k1k2 = (run.launches["flash_fwd"], run.launches["flash_bwd"])
    k4 = [v for k, v in run.launches.items() if k.startswith("grouped")]
    if k1k2 != (want, want) or any(k4):
        raise AssertionError(f"{tag}: launches {run.launches}, want K1/K2 "
                             f"{want} each and no K4")
    if not (np.isfinite(run.mean).all() and run.mean[-1] < run.mean[0]):
        raise AssertionError(f"{tag}: loss did not fall {run.mean}")
    h = run.health
    if cfg.router_mode == "expert_choice":
        if not (h["usage"] == [1.0 / cfg.num_experts] * cfg.num_experts
                and h["aux_loss"] == 0.0 and 0.0 < h["ec_coverage"] <= 1.0):
            raise AssertionError(f"{tag}: probe {h}")
    elif not 0.0 <= h["dropped_fraction"] < 1.0:
        raise AssertionError(f"{tag}: probe {h}")
    kernel_calls = run.routing.calls
    ulp = run._router()
    ulp.force = [i for i, _ in kernel_calls]
    run.grads(ulp, ulp=1)
    p_noise = _prob_noise(run.routing.probs, ulp.probs)
    router = run._router()
    replay_loss, _ = run.grads(router, plain=True)
    flips, gaps = _flips(kernel_calls, router.calls, m.dp, tag + " replay",
                         p_noise)
    if flips:
        router = run._router()
        router.force = [i for i, _ in kernel_calls]
        replay_loss, _ = run.grads(router, plain=True)
    if not np.allclose(replay_loss, run.losses[0], rtol=1e-5, atol=0):
        raise AssertionError(f"{tag}: plain replay loss {replay_loss} != "
                             f"{run.losses[0]}")
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    summ = {"mesh": m.describe(), "dispatch": cfg.dispatch,
            "router_mode": cfg.router_mode,
            "capacity": cfg.capacity(m), "ec_capacity": cfg.ec_capacity(m),
            "timed_steps": steps - 1, "per_step_s": run.per_step,
            "tokens_per_step": tokens, "tokens_per_s": tokens / run.per_step,
            "model_flops_per_s": tokens / run.per_step
            * cfg.flops_per_token(),
            "peak_mem_gb": run.peak, "losses_mean": run.mean,
            "replay_loss": replay_loss, "routing_flips": flips,
            "first_flip_tie_gaps": gaps,
            "one_ulp_prob_noise_max": max(p_noise),
            "launches": run.launches,
            "probe": h, "launch_formula": "dp x micro x layers x steps",
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(tag + " " + json.dumps(summ), flush=True)
    del run
    torch.cuda.empty_cache()
    return summ["launches"], summ



def moe_train_bf16_phase(fa, gf, layers_mod, smi):
    """Phase 12e: phase 12b's model and carving in bf16 (lm_bench's
    widths, 8 experts top-2, dropless, tile 8, dp 2 x pp 2 x tp 2, Adam
    5e-3, params, gradients and Adam's moments in bf16) at lm_bench's
    micro 8 (it fits: 12b's f32 cut to 4 is not needed): K1/K2/K4/dgrad/wgrad/plan launches by 12b's formula,
    every leaf still bf16, a falling loss, the probe, tokens/s, model
    FLOP/s against the bf16 rate, peak memory; step 1 replayed through
    the plain versions (plain K1/K2, the per-expert K4 under autograd):
    routing flips only at near ties (against the probabilities' change
    under a one-bf16-ulp move of the embedding), the loss within 2 bf16
    ulps, each gradient leaf within one bf16 ulp of its max |g| or twice
    that one-ulp move's change; one profiled step for the kernels' device
    ms."""
    from bluefog_tpu_torch.parallel import compose
    tag = "moe_train_bf16"
    cfg = _moe_cfg(micro=8)
    m = compose.compose_parallelism(2, 2, 2, 1, device=DEV,
                                    num_experts=cfg.num_experts,
                                    capacity_factor=cfg.capacity_factor)
    steps = 2                 # 1 warm-up + 1 timed (2 before phase 22)
    run = _MoERun(fa, gf, layers_mod, cfg, m, steps, dtype=torch.bfloat16)
    want = m.dp * (cfg.micro + m.pp - 1) * (cfg.layers // m.pp) * steps
    if set(run.launches.values()) != {want}:    # every K4 forward too
        raise AssertionError(f"{tag}: launches {run.launches}, want dp x "
                             f"(micro + pp - 1) x layers / pp x steps = "
                             f"{want} each")
    if run.dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"{tag}: params or gradients left bf16: "
                             f"{run.dtypes}")
    if not (np.isfinite(run.mean).all() and run.mean[-1] < run.mean[0]):
        raise AssertionError(f"{tag}: loss did not fall {run.mean}")
    h = run.health
    if not (h["dropped_fraction"] == 0.0
            and abs(sum(h["usage"]) - 1.0) < 2 ** -6
            and all(np.isfinite(v).all() for v in h.values())):
        raise AssertionError(f"{tag}: probe {h}")
    kernel_calls = run.routing.calls
    forced = _Routing(layers_mod)
    forced.force = [i for i, _ in kernel_calls]
    ulp_loss, noise = run.grads(forced, ulp=1)
    floor = [[float((a.float() - b.float()).abs().max())
              for a, b in zip(k, z)] for k, z in zip(run.step1, noise)]
    p_noise = _prob_noise(run.routing.probs, forced.probs)
    del noise
    replay_router = _Routing(layers_mod)
    replay_loss, replay = run.grads(replay_router, plain=True)
    flips, gaps = _flips(kernel_calls, replay_router.calls, m.dp,
                         tag + " replay", p_noise)
    if flips:                         # the replay on the kernel's routing
        forced.i = 0
        replay_loss, replay = run.grads(forced, plain=True)
    top = max(abs(x) for x in run.losses[0])
    if not np.allclose(replay_loss, run.losses[0], rtol=0,
                       atol=2 * _ulp_bf16(top)):
        raise AssertionError(f"{tag}: plain replay loss {replay_loss} != "
                             f"{run.losses[0]} within 2 bf16 ulps")
    rep_err, rep_floor = _grad_gate(tag + " replay", run.names, replay,
                                    run.step1, lambda r, i: floor[r][i],
                                    rel=2 ** -7)
    del replay
    k_ms = _profile_k4(run)
    tokens = m.dp * cfg.micro * cfg.batch * cfg.seq_len
    flops = tokens / run.per_step * cfg.flops_per_token()
    summ = {
        "mesh": m.describe(), "dtype": "bfloat16",
        "n_params": cfg.n_params, "n_active_params": cfg.n_active_params,
        "config": {"layers": cfg.layers, "micro": cfg.micro,
                   "batch": cfg.batch, "seq": cfg.seq_len,
                   "num_experts": cfg.num_experts, "top_k": cfg.top_k,
                   "group_tile": cfg.group_tile, "remat": False},
        "timed_steps": steps - 1, "per_step_s": run.per_step,
        "tokens_per_step": tokens, "tokens_per_s": tokens / run.per_step,
        "model_flops_per_s": flops, "mfu_bf16": flops / BF16_FLOPS,
        "peak_mem_gb": run.peak, "losses_mean": run.mean,
        "replay_loss": replay_loss, "one_ulp_embed_loss": ulp_loss,
        "routing_flips": flips, "first_flip_tie_gaps": gaps,
        "replay_forced_routing": bool(flips),
        "one_ulp_prob_noise_max": max(p_noise),
        "step1_grad_rel_err_by_leaf": rep_err,
        "step1_grad_one_ulp_floor_by_leaf": rep_floor,
        "probe": h,
        "launches": run.launches,
        "launch_formula": "dp x (micro + pp - 1) x layers / pp x steps",
        "device_ms_one_step": k_ms,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print(tag + " " + json.dumps(summ), flush=True)
    del run
    torch.cuda.empty_cache()
    return summ["launches"], summ


def examples_phase(fa, gf, smi):
    """Phase 17: the MoE examples on the card at their defaults, and
    ``llm_3d --tp 1 --ep 2 --experts 4 --steps 40``, through their
    ``main``s (each asserts its own end condition): K1/K2 launches equal
    each path's count (llm_3d: dp x (micro + pp - 1) x layers / pp x
    steps; moe_lm's causal ring over 8 ranks: its 36 visible blocks a
    step; moe: none) and no K4 (llm_3d's MoE runs capacity dispatch,
    as in JAX)."""
    from bluefog_tpu_torch.examples import llm_3d, moe, moe_lm
    runs = [("llm_3d", llm_3d, [], 2 * (4 + 2 - 1) * 2 * 100),
            ("llm_3d_ep2", llm_3d, ["--tp", "1", "--ep", "2", "--experts",
                                    "4", "--steps", "40"],
             2 * (4 + 2 - 1) * 2 * 40),
            ("moe", moe, [], 0), ("moe_top2", moe, ["--top2"], 0),
            ("moe_lm", moe_lm, [], 8 * 9 // 2 * 80)]
    out = {}
    for name, mod, argv, want in runs:
        _launch_counts(fa, gf, reset=True)
        t0 = time.monotonic()
        if mod.main(argv) != 0:
            raise AssertionError(f"examples_moe: {name} failed")
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        n = _launch_counts(fa, gf)
        k4 = [v for k, v in n.items() if k.startswith("grouped")]
        if (n["flash_fwd"], n["flash_bwd"]) != (want, want) or any(k4):
            raise AssertionError(f"examples_moe: {name} launches {n}, want "
                                 f"K1/K2 {want} each and no K4")
        out[name] = {"argv": argv, "seconds": secs, "launches": n,
                     "k1_k2_want": want}
    print("examples_moe " + json.dumps({
        "runs": out, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi}), flush=True)
    return out

# -- phases 18-19: the pipeline schedules and the world ----------------

PIPE_WIDE = dict(S=4, M=8, B=2, T=2048, D=1024, H=16)


def _example_losses(mod, argv):
    """Run an example's ``main`` (its own end assertion included); its
    printed ``step i: loss x`` lines by step, and its last line."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if mod.main(argv) != 0:
            raise AssertionError(f"pipelines: {argv} failed")
    text = buf.getvalue()
    steps = {}
    for line in text.splitlines():
        if line.startswith("step "):
            head, loss = line.split(": loss ")
            steps[int(head[5:])] = float(loss.split()[0])
    return steps, text.strip().splitlines()[-1]


def _grad_gap(got, want):
    """max |got - want| over max |want|, per leaf."""
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp(min=1e-30))
            for k in want}


# 18a's steps a mode (the example's 100, cut to make room for phase 21)
PIPE_EXAMPLE_STEPS = ["--steps", "50"]


def pipeline_examples():
    """Phase 18a: ``pipeline_lm`` in each mode through its ``main``."""
    from bluefog_tpu_torch.examples import pipeline_lm as plm
    examples = {}
    for tag, argv in (("gpipe", []), ("remat", ["--remat"]),
                      ("interleaved", ["--interleaved", "2", "--micro",
                                       "4"]),
                      ("hetero", ["--hetero"])):
        argv = argv + PIPE_EXAMPLE_STEPS
        t0 = time.monotonic()
        steps, last = _example_losses(plm, argv + ["--device", DEV])
        torch.cuda.synchronize()
        first, final = steps[min(steps)], steps[max(steps)]
        if not final < first:
            raise AssertionError(f"pipelines: {tag} loss {first} -> {final}")
        examples[tag] = {"argv": argv, "first_loss": first,
                         "last_loss": final, "seconds":
                         time.monotonic() - t0, "last_line": last}
    return examples


def pipeline_wide():
    """Phase 18b: the example's block at lm_bench's widths, one timed
    step a schedule after one untimed step of each, and the gates."""
    from bluefog_tpu_torch.examples import pipeline_lm as plm
    from bluefog_tpu_torch.parallel import pipeline as pipe
    dev = torch.device(DEV)
    c = PIPE_WIDE
    S, M, B, T, D, H = c["S"], c["M"], c["B"], c["T"], c["D"], c["H"]
    gen = torch.Generator(device=dev).manual_seed(0)   # drawn on the card

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def blocks(n):
        return {"wqkv": randn(n, D, 3 * D, scale=0.02),
                "wo": randn(n, D, D, scale=0.02),
                "w1": randn(n, D, 4 * D, scale=0.02),
                "w2": randn(n, 4 * D, D, scale=0.02)}

    params = blocks(S)
    x, tgt = randn(M, B, T, D), randn(M, B, T, D)

    def block(p, h):
        return plm.block_fn(p, h, H)

    def mse(y, t):
        return ((y - t) ** 2).mean()

    def autograd_step(run, p):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        out = run(leaves)
        sum(mse(out[i], tgt[i]) for i in range(out.shape[0])).backward()
        return {k: v.grad for k, v in leaves.items()}

    def f1b_step(p):
        return pipe.pipeline_1f1b_grad(block, mse, p, x, tgt)[1]

    runs = {
        "gpipe": lambda: autograd_step(
            lambda q: pipe.pipeline_apply(block, q, x), params),
        "gpipe_remat": lambda: autograd_step(
            lambda q: pipe.pipeline_apply(block, q, x, remat=True), params),
        "1f1b": lambda: f1b_step(params)}
    wide = {}
    grads = {}
    for run in runs.values():        # warm-up: one untimed step each
        run()
    for tag, run in runs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        grads[tag] = run()
        torch.cuda.synchronize()
        wide[tag] = {"s_per_step": time.monotonic() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "base_bytes": base}
    wide["1f1b"]["grad_gap"] = _grad_gap(grads["1f1b"], grads["gpipe"])
    wide["gpipe_remat"]["grad_gap"] = _grad_gap(grads["gpipe_remat"],
                                                grads["gpipe"])
    del grads
    # interleaved: 8 blocks, chunk k of stage d = block k * S + d
    V, Mi = 2, 4
    full = blocks(V * S)
    chunked = {k: v.view((V, S) + tuple(v.shape[1:])).transpose(0, 1)
               for k, v in full.items()}
    xi, ti = x[:Mi], tgt[:Mi]

    def seq(p):
        h = xi
        for v in range(V * S):
            h = block({k: w[v:v + 1].expand((Mi,) + tuple(w.shape[1:]))
                       for k, w in p.items()}, h)
        return h

    def il_step(p):
        leaves = {k: w.detach().requires_grad_() for k, w in p.items()}
        out = pipe.pipeline_interleaved_apply(block, leaves, xi)
        sum(mse(out[i], ti[i]) for i in range(Mi)).backward()
        return {k: w.grad for k, w in leaves.items()}

    il_step(chunked)                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    g_il = il_step(chunked)
    torch.cuda.synchronize()
    wide["interleaved"] = {"s_per_step": time.monotonic() - t0,
                           "peak_bytes": torch.cuda.max_memory_allocated()}
    leaves = {k: w.detach().requires_grad_() for k, w in full.items()}
    out = seq(leaves)
    sum(mse(out[i], ti[i]) for i in range(Mi)).backward()
    g_seq = {k: w.grad.view((V, S) + tuple(w.shape[1:])).transpose(0, 1)
             for k, w in leaves.items()}
    wide["interleaved"]["grad_gap"] = _grad_gap(g_il, g_seq)
    del g_il, g_seq, leaves, out
    for tag in ("1f1b", "interleaved", "gpipe_remat"):
        if max(wide[tag]["grad_gap"].values()) > 1e-4:
            raise AssertionError(f"pipelines: {tag} gradients "
                                 f"{wide[tag]['grad_gap']}")
    if not wide["1f1b"]["peak_bytes"] < wide["gpipe"]["peak_bytes"]:
        raise AssertionError(f"pipelines: 1F1B's peak {wide['1f1b']} is not "
                             f"below GPipe's {wide['gpipe']}")
    torch.cuda.empty_cache()
    return wide


def world_launch(pool, scratch):
    """Phase 19's processes, started in ``pool``'s threads: the NCCL
    child (WORLD_SIZE=1, 8 rows on the card) and the gloo pair (2 x 4
    rows on the CPU).  They run while phase 18a runs in this process."""
    from bluefog_tpu_torch.tools import world_check as wc
    return (time.monotonic(),
            pool.submit(wc.spawn, 1, 8, os.path.join(scratch, "nccl1"),
                        device="cuda", timeout=240),
            pool.submit(wc.spawn, 2, 8, os.path.join(scratch, "gloo2"),
                        device="cpu", timeout=240))


def world_phase(smi, launched):
    """Phase 19: the world under the stacked ranks (no K1-K4): the
    processes :func:`world_launch` started, joined and held to the same
    calls in one process."""
    from bluefog_tpu_torch.tools import world_check as wc
    t0, nccl_f, gloo_f = launched
    ref = wc.reference(8, 8, device="cuda")
    cpu_ref = wc.reference(8, 4, device="cpu")
    nccl, gloo = nccl_f.result(), gloo_f.result()
    spawn_s = time.monotonic() - t0
    differ = sorted(k for k in ref if not torch.equal(nccl[k], ref[k]))
    if differ or set(nccl) != set(ref):
        raise AssertionError(f"world: NCCL world 1 differs from the "
                             f"one-process context on {differ}")
    through = ("allreduce", "allreduce_sum", "zero_loss_mean", "layout",
               "p2p_calls")
    differ = sorted(k for k in cpu_ref if k not in through
                    and not torch.equal(gloo[k], cpu_ref[k]))
    gaps = {k: float((gloo[k] - cpu_ref[k]).abs().max())
            for k in through[:3]}
    if differ or max(gaps.values()) > 1e-6:
        raise AssertionError(f"world: gloo 2 x 4 differs from one process "
                             f"on {differ} {gaps}")
    # batch_isend_irecv calls: the ring round by round, every round at
    # once (plain, int8@4), 5 ZeRO-1 steps (one reduce-scatter and one
    # all-gather each)
    from bluefog_tpu_torch import schedule, topology
    rounds = schedule.compile_topology(topology.RingGraph(8),
                                       True).num_rounds
    calls = gloo["p2p_calls"].tolist()
    if calls != [rounds, 1, 1, 10]:
        raise AssertionError(f"world: gloo p2p calls {calls}, want "
                             f"{[rounds, 1, 1, 10]}")
    doc = {"nccl_world1_bootstrap": {
               "checks": "NCCL init on cuda:LOCAL_RANK and the in-process "
                         "paths; no row crosses a process",
               "results": len(ref), "bit_equal": True, "rows": 8,
               "layout": nccl["layout"].tolist()},
           "gloo_cpu_2x4": {"results": len(cpu_ref),
                            "bit_equal": len(cpu_ref) - len(through),
                            "group_sum_gap": gaps, "p2p_calls": calls,
                            "device": "cpu"},
           "seconds_since_launch": spawn_s,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("world " + json.dumps(doc), flush=True)
    return doc

# -- phase 20: the optimizer core's rest (no K1-K4) ----------------------

RESNET_RANKS = 8              # 20e: ResNet-50 224 x 224, 1000 classes,
RESNET_BATCH = 16             # batch 16 a rank, 8 stacked ranks
RESNET_IMAGE = 224


def stateful_resnet_phase(smi):
    """20e: ResNet-50's BatchNorm statistics as ``net_state`` through
    ``make_stateful_train_step``: async window gossip (K 2, rank 3 at pace
    3), ``state_sync="neighbor"``, the probe every call; 1 warm-up and 3
    timed steps.  Gates: finite loss and statistics, the mass sums to
    n."""
    import torch.nn.functional as F
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch import topology as tu
    from bluefog_tpu_torch.fusion import tree_flatten, tree_map, \
        tree_unflatten
    from bluefog_tpu_torch.models import ResNet50
    from bluefog_tpu_torch.parallel import context
    from bluefog_tpu_torch.utils import metrics
    n, B = RESNET_RANKS, RESNET_BATCH
    context.init(size=n, device=DEV)
    try:
        topo = tu.ExponentialTwoGraph(n)
        context.set_topology(topo, is_weighted=True)
        model = ResNet50(num_classes=1000,
                         generator=torch.Generator().manual_seed(0))
        variables = tree_map(lambda t: t.to(DEV), model.variables())
        params = bfopt.replicate(variables["params"], n)
        stats = bfopt.replicate(variables["batch_stats"], n)
        gen = torch.Generator(device=DEV).manual_seed(0)
        images = torch.randn((n, B, RESNET_IMAGE, RESNET_IMAGE, 3),
                             generator=gen, device=DEV)
        labels = torch.randint(0, 1000, (n, B), generator=gen, device=DEV)
        strat = bfopt.async_window_gossip(
            bfopt.sgd(0.1, momentum=0.9), bfopt.push_schedule(topo, n),
            staleness_bound=2, pace=[3 if r == 3 else 1 for r in range(n)])

        def grad3(p, bs, batch):
            x, y = batch
            leaves, treedef = tree_flatten(p)
            ps = [t.detach().requires_grad_() for t in leaves]
            logits, upd = model.apply(
                {"params": tree_unflatten(treedef, ps), "batch_stats": bs},
                x, train=True)
            loss = F.cross_entropy(logits, y)
            grads = torch.autograd.grad(loss, ps)
            return (loss.detach(), tree_unflatten(treedef, list(grads)),
                    upd["batch_stats"])

        step = bfopt.make_stateful_train_step(
            grad3, strat, state_sync="neighbor", metrics_every_k=1)
        dstate = bfopt.init_distributed(strat, params)
        metrics.reset_metrics()
        params, stats, dstate, loss = step(params, stats, dstate,
                                           (images, labels))     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], [float(loss.mean())]
        depths = [int(dstate.comm_state.depth.max())]
        for _ in range(3):
            t0 = time.monotonic()
            params, stats, dstate, loss = step(params, stats, dstate,
                                               (images, labels))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            losses.append(float(loss.mean()))
            depths.append(int(dstate.comm_state.depth.max()))
        cs = dstate.comm_state
        mass = float(cs.p.double().sum() + cs.p_recv.double().sum())
        stats_finite = all(bool(torch.isfinite(t).all())
                           for t in tree_flatten(stats)[0])
        doc = {"model": "ResNet-50", "image_size": RESNET_IMAGE,
               "num_classes": 1000,
               "ranks": n, "batch_per_rank": B, "warmup": 1, "timed": 3,
               "strategy": "async_window_gossip K 2, rank 3 at pace 3, "
                           "sgd(0.1, momentum 0.9)",
               "state_sync": "neighbor", "metrics_every_k": 1,
               "s_per_step": times, "losses": losses,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "consensus_distance_max": metrics.gauge(
                   "bluefog_consensus_distance_max").value(),
               "consensus_distance_mean": metrics.gauge(
                   "bluefog_consensus_distance_mean").value(),
               "neighbor_disagreement_max": metrics.gauge(
                   "bluefog_neighbor_disagreement_max").value(),
               "staleness_depth_max": metrics.gauge(
                   "bluefog_async_staleness_steps").value(),
               "staleness_depth": cs.depth.cpu().tolist(),
               "staleness_depth_max_by_step": depths,
               "local_steps": cs.local_steps.cpu().tolist(),
               "mass_minus_n": mass - n, "bn_stats_finite": stats_finite,
               "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        print("stateful_resnet " + json.dumps(doc), flush=True)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"stateful_resnet: losses {losses}")
        if not stats_finite:
            raise AssertionError("stateful_resnet: a BatchNorm statistic "
                                 "is not finite")
        if not abs(mass - n) <= 1e-6 * n:
            raise AssertionError(f"stateful_resnet: the mass sums to {mass}")
        if doc["consensus_distance_max"] is None:
            raise AssertionError("stateful_resnet: the probe did not run")
        return doc
    finally:
        context.shutdown()
        torch.cuda.empty_cache()


REST_PARITY_STEPS = 2         # 20a's steps (5 before phase 21 came)


def core_rest_phase(fa, gf, fd, smi):
    """Phase 20 (no K1-K4): 20a the new strategies, the stateful step and
    the named windows on the card against the CPU; 20b
    ``tools/strategy_bench.py`` and 20c ``tools/gossip_bench.py`` at their
    defaults (20c then ``--train-step``); 20d ``decentralized_optimization``
    at its defaults through its ``main``; 20e ResNet-50's BatchNorm state
    through the stateful step.  TF32 off."""
    import io
    from bluefog_tpu_torch.examples import decentralized_optimization as dopt
    from bluefog_tpu_torch.tools import gossip_bench as gb
    from bluefog_tpu_torch.tools import strategy_bench as sb
    from bluefog_tpu_torch.tools import strategy_parity as sp
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}
    try:
        _launch_counts(fa, gf, reset=True)
        fd.flash_decode_cuda.launches = 0
        t0 = time.monotonic()
        parity = sp.rest_parity(DEV, steps=REST_PARITY_STEPS)
        windows = sp.window_parity(DEV)
        parity.update(windows=windows, nvidia_smi=smi)
        print("strategy_parity_rest " + json.dumps(sp.flat_summary(parity)),
              flush=True)
        sp.check_rest(parity)
        if windows["differ"]:
            raise AssertionError(f"named windows: the card differs from the "
                                 f"CPU on {windows['differ']}")
        seconds["parity"] = time.monotonic() - t0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            bench = sb.run(sb.parse([]))
        bench.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
        print("strategy_bench " + json.dumps(bench), flush=True)
        seconds["strategy_bench"] = time.monotonic() - t0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            gossip = gb.run(gb.parse(["--train-step"]))
        gossip.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
        print("gossip_bench " + json.dumps(gossip), flush=True)
        seconds["gossip_bench"] = time.monotonic() - t0
        t0 = time.monotonic()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if dopt.main([]) != 0:
                raise AssertionError("decentralized_optimization failed")
        lines = buf.getvalue().strip().splitlines()
        print("decentralized_optimization " + json.dumps({
            "lines": lines, "seconds": time.monotonic() - t0,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
            flush=True)
        seconds["decentralized_optimization"] = time.monotonic() - t0
        t0 = time.monotonic()
        resnet = stateful_resnet_phase(smi)
        seconds["stateful_resnet"] = time.monotonic() - t0
        launches = dict(_launch_counts(fa, gf),
                        flash_decode=fd.flash_decode_cuda.launches)
        print("phase_20_launches " + json.dumps(launches), flush=True)
        if any(launches.values()):
            raise AssertionError(f"phase 20 launched a kernel: {launches}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    return launches, seconds, resnet


# -- phase 21: the host runtime ---------------------------------------------

HR_DP = 4                     # lm_bench's dense trainer over 4 replicas
HR_T = 0.2                    # the throttle of 21a's first run (s a step)


def _hr_trainer(seed=0):
    """lm_bench's dense trainer at its full width (vocab 32768, d_model
    1024, 16 heads, 2 layers, seq 2048, micro 4, batch 4, f32) over dp 4
    stacked replicas: Exp2 gossip, delayed AWC, Adam at 5e-3, attention
    through K1/K2.  Returns (per-step K1 launches, step, params, state,
    tokens)."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.parallel import compose
    cfg = compose.LMConfig(vocab=32768, d_model=1024, heads=16, layers=2,
                           seq_len=2048, micro=4, batch=4)
    m = compose.compose_parallelism(HR_DP, device=DEV)
    step, strategy = compose.make_train_step(
        m, compose.make_lm_grad_fn(cfg, m, use_pallas=True),
        bfopt.adam(5e-3), delayed=True)
    params = compose.init_lm_train_params(cfg, m, seed=seed)
    state = bfopt.init_distributed(strategy, params)
    toks = compose.make_lm_batch(cfg, m, seed=seed)
    return m.dp * cfg.micro * cfg.layers, step, params, state, toks


def _hr_counts(fa, gf, tag, want):
    """The K1-K4 counts since the last reset: K1 and K2 ``want`` each,
    K4 and its backward none."""
    n = _launch_counts(fa, gf)
    if (n["flash_fwd"], n["flash_bwd"]) != (want, want) or any(
            v for k, v in n.items() if k not in ("flash_fwd", "flash_bwd")):
        raise AssertionError(f"{tag}: kernel launches {n}, want flash_fwd "
                             f"and flash_bwd {want} each and no K4")
    return n


def _hr_same(tag, got, want):
    """Every tensor of two trainers' outputs (params, optimizer state,
    delayed carry, loss): the count, and the largest difference."""
    from bluefog_tpu_torch.utils.snapshot import live_tensors
    a, b = live_tensors(got), live_tensors(want)
    if len(a) != len(b):
        raise AssertionError(f"{tag}: {len(a)} tensors against {len(b)}")
    return len(a), max(float((x.double() - y.double()).abs().max())
                       for x, y in zip(a, b))


def _hr_straggler(fa, gf, smi, scratch, seen):
    """21a: tools/lm_bench at its full width (dp 4, 2 warm-up steps, then
    3 timed steps (6 before phase 22) under
    ``throttle:from=2,until=99,t=0.2,rank=2``, and 3
    under a throttle of twice the others' step in that run, rounded up to
    0.1 s): the detector's rule (a rank over 2x the median) calls a rank
    a straggler only when its delay exceeds the others' whole step, which
    0.2 s does not at this width.  The unthrottled step is the other
    ranks' entry of each run's table (the host's wall time less the
    ledger's sleep).  Each run's K1/K2 counts are the formula's; rank 2's
    time is the table's largest; tools/postmortem.py, run as a subprocess
    on the flight bundle, finds the skew within 25 % of the throttle and
    the first chaos event at step 2 on rank 2; the second throttle is
    also blamed (``detected_ranks`` [2], postmortem's ``straggler_rank``
    2)."""
    import io
    from bluefog_tpu_torch.tools import lm_bench
    from bluefog_tpu_torch.utils import flight
    root = os.path.dirname(os.path.abspath(__file__))
    argv = ["--dp", str(HR_DP), "--pp", "1", "--tp", "1", "--layers", "2",
            "--micro", "4", "--steps-per-call", "1", "--no-sweep",
            "--no-trace"]
    per_step = HR_DP * 4 * 2
    rows = {}

    def run(tag, t, iters):
        extra = ["--iters", str(iters),
                 "--chaos", f"throttle:from=2,until=99,t={t},rank=2",
                 "--flight-dir", os.path.join(scratch, tag)]
        flight.reset()
        _launch_counts(fa, gf, reset=True)
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            doc = lm_bench.main(argv + extra)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        n = _hr_counts(fa, gf, f"21a {tag}", per_step * (2 + iters))
        if not doc["ok"]:
            raise AssertionError(f"21a {tag}: lm_bench not ok: "
                                 f"{doc['losses']}")
        table = doc["straggler"]["step_times_s"]
        row = {"per_step_s": doc["per_step_s"],
               "unthrottled_step_s": float(np.median(
                   [x for r, x in enumerate(table) if r != 2])),
               "losses": doc["losses"], "peak_mem_gb": doc["peak_mem_gb"],
               "seconds": seconds, "timed_steps": iters,
               "flash_launches": n["flash_fwd"]}
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "postmortem.py"),
             doc["flight_bundle"]], capture_output=True, text=True,
            timeout=300, cwd=root)
        if proc.returncode != 0:
            raise AssertionError(f"21a {tag}: postmortem failed: "
                                 f"{proc.stderr[-2000:]}")
        pm = json.loads(proc.stdout)
        with open(doc["flight_bundle"]) as f:
            chaos_ev = [e for e in json.load(f)["events"]
                        if e.get("kind") == "chaos"]
        row.update(throttle_s=t, step_times_s=table,
                   detected_ranks=doc["straggler"]["detected_ranks"],
                   postmortem_step_time=pm["step_time"],
                   chaos_onset_step=min(e["step"] for e in chaos_ev),
                   chaos_ranks=sorted({e["rank"] for e in chaos_ev}))
        if not (len(table) == HR_DP and max(table) == table[2]
                and sorted(table)[-2] < table[2]):
            raise AssertionError(f"21a {tag}: rank 2 is not the slowest: "
                                 f"{table}")
        skew = pm["step_time"]["skew_s"]
        if abs(skew - t) > 0.25 * t:
            raise AssertionError(f"21a {tag}: postmortem skew {skew} s is "
                                 f"not within 25 % of the throttle {t} s")
        if row["chaos_onset_step"] != 2 or row["chaos_ranks"] != [2]:
            raise AssertionError(f"21a {tag}: chaos events from step "
                                 f"{row['chaos_onset_step']} on ranks "
                                 f"{row['chaos_ranks']}, want 2 and [2]")
        return row

    with mock.patch.object(
            fa, "attention_block_partial",
            _capture_copy(seen, "k1", fa.attention_block_partial)), \
            mock.patch.object(
                fa, "attention_block_backward",
                _capture_copy(seen, "k2", fa.attention_block_backward)):
        rows["throttle_0.2"] = run("throttle_0.2", HR_T, 3)
        base = rows["throttle_0.2"]["unthrottled_step_s"]
        big = float(np.ceil(20 * base) / 10)
        rows["throttle_2x"] = run("throttle_2x", big, 3)
    blamed = rows["throttle_2x"]
    if blamed["detected_ranks"] != [2] or \
            blamed["postmortem_step_time"]["straggler_rank"] != 2:
        raise AssertionError(
            f"21a: a {big} s throttle on rank 2 (its step {base} s) was "
            f"not blamed: detected {blamed['detected_ranks']}, postmortem "
            f"{blamed['postmortem_step_time']}; {rows}")
    rows["kernels"] = _k12_checks("host_runtime", fa, seen)
    return rows


def _hr_guard(fa, gf, smi):
    """21b: ``nan:step=3,rank=1`` on the same trainer under
    ``guard_step(check_every_k=1, depth=2)``, 5 calls: call 3 is skipped
    and rolled back in place (one non-finite step, one rollback, rank 1's
    last bad step 3), every loss finite, and the state after the 5 calls
    equal to an unfaulted run of 4 steps from the same init (lm_bench
    feeds one batch every step): bit for bit, or, if it is not, within
    twice the distance between two unfaulted runs.  Also the guard's cost
    a step on this state: the finite check and the snapshot copy."""
    from bluefog_tpu_torch import diagnostics, resilience
    from bluefog_tpu_torch.parallel import context as bf
    from bluefog_tpu_torch.utils import chaos
    from bluefog_tpu_torch.utils.snapshot import live_tensors
    bf.init(size=HR_DP, device=DEV)
    try:
        per_step, step, params, state, toks = _hr_trainer()
        guard = resilience.guard_step(step, check_every_k=1, depth=2)
        chaos.install("nan:step=3,rank=1")
        _launch_counts(fa, gf, reset=True)
        losses = []
        t0 = time.monotonic()
        try:
            for _ in range(5):
                params, state, loss = guard(params, state, toks)
                losses.append(loss.tolist())
        finally:
            chaos.uninstall()
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = _hr_counts(fa, gf, "21b guarded", 5 * per_step)[
            "flash_fwd"]
        health = diagnostics.peer_health()
        if (guard.calls, guard.nonfinite_steps, guard.rollbacks) != (5, 1, 1) \
                or health["last_bad_step"] != {1: 3}:
            raise AssertionError(
                f"21b: calls {guard.calls}, non-finite steps "
                f"{guard.nonfinite_steps}, rollbacks {guard.rollbacks}, "
                f"health {health}; want 5, 1, 1 and rank 1 bad at call 3")
        if not np.isfinite(np.array(losses)).all():
            raise AssertionError(f"21b: a non-finite loss: {losses}")
        out = (params, state, loss)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        diagnostics.check_finite(out)
        check_s = time.monotonic() - t0
        t0 = time.monotonic()
        guard._snapshot(out)
        snapshot_s = time.monotonic() - t0
        snap_bytes = sum(t.numel() * t.element_size()
                         for t in live_tensors(out))

        def unfaulted():
            _, stp, p, s, tk = _hr_trainer()
            for _ in range(4):
                p, s, ls = stp(p, s, tk)
            return p, s, ls

        _launch_counts(fa, gf, reset=True)
        ref = unfaulted()
        torch.cuda.synchronize()
        launches += _hr_counts(fa, gf, "21b unfaulted", 4 * per_step)[
            "flash_fwd"]
        n_t, diff = _hr_same("21b", out, ref)
        floor = None
        if diff:
            _launch_counts(fa, gf, reset=True)
            again = unfaulted()
            torch.cuda.synchronize()
            launches += _hr_counts(fa, gf, "21b floor", 4 * per_step)[
                "flash_fwd"]
            floor = _hr_same("21b floor", again, ref)[1]
            del again
            if diff > 2 * floor:
                raise AssertionError(
                    f"21b: the rolled-back run differs from the unfaulted "
                    f"one by {diff}, over twice two unfaulted runs' {floor}")
        del ref, out, params, state, guard
    finally:
        bf.shutdown()
    return {"losses_mean": [float(np.mean(x)) for x in losses],
            "nonfinite_steps": 1, "rollbacks": 1, "tensors": n_t,
            "max_abs_diff_vs_unfaulted": diff,
            "bit_for_bit": diff == 0.0, "reproducibility_floor": floor,
            "guard_check_ms": check_s * 1e3,
            "guard_snapshot_ms": snapshot_s * 1e3,
            "snapshot_bytes": snap_bytes, "seconds_5_calls": seconds,
            "flash_launches": launches}


def _hr_heal(smi):
    """21c (no kernel): gossip_bench's [8, 2^20] f32 buffer over weighted
    Exp2, pure gossip (SGD at lr 0 under AWC): a chaos ``kill`` of rank 3
    at step 2, ``mark_rank_dead(3)``; then 8 steps on the healed schedule,
    the survivors' consensus distance falling monotonically to under 5 %;
    then a chaos ``join:step=1,rank=3,warmup=2`` (the neighbor-pull
    bootstrap from >= 2 live donors, admission at 1/3 of its weight), and
    6 steps with ``advance_membership`` each, all 8 contracting
    monotonically through the ramp (1/3 -> 2/3 -> 1)."""
    from bluefog_tpu_torch import diagnostics, resilience
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch import topology as tu
    from bluefog_tpu_torch.parallel import context as bf
    from bluefog_tpu_torch.utils import chaos, flight
    n = 8
    bf.init(size=n, device=DEV)
    resilience.reset()
    try:
        bf.set_topology(tu.ExponentialTwoGraph(n), is_weighted=True)
        g = torch.Generator().manual_seed(0)
        params = {"w": torch.randn(n, 1 << 20, generator=g).to(DEV)}
        batch = torch.zeros((n, 1), device=DEV)

        def zero_grad(p, b):
            return torch.zeros((), device=DEV), {"w": torch.zeros_like(
                p["w"])}

        def setup():
            strat = bfopt.adapt_with_combine(
                bfopt.sgd(0.0),
                bfopt.neighbor_communicator(bf.static_schedule()))
            return (bfopt.make_train_step(zero_grad, strat),
                    bfopt.init_distributed(strat, params))

        def dist(dead=()):
            return diagnostics.diagnose_consensus(
                params, dead_ranks=dead)["consensus_distance_max"]

        chaos.install("kill:step=2,rank=3")
        step, state = setup()
        try:
            params, state, _ = step(params, state, batch)
            step(params, state, batch)
            raise AssertionError("21c: the chaos kill of rank 3 did not fire")
        except chaos.RankKilled as e:
            killed = e.rank
        finally:
            chaos.uninstall()
        resilience.mark_rank_dead(killed)
        step, state = setup()
        t0 = time.monotonic()
        healed = [dist((3,))]
        for _ in range(8):
            params, state, _ = step(params, state, batch)
            healed.append(dist((3,)))
        heal_s = time.monotonic() - t0
        if not (all(b <= a * (1 + 1e-6) for a, b in zip(healed,
                                                         healed[1:]))
                and healed[-1] < 0.05 * healed[0]):
            raise AssertionError(f"21c: the survivors did not contract "
                                 f"monotonically: {healed}")
        chaos.install("join:step=1,rank=3,warmup=2")
        step, state = setup()
        try:
            params, state, _ = step(params, state, batch)
        finally:
            chaos.uninstall()
        boots = [e for e in flight.events()
                 if e["kind"] == "join" and e.get("name") == "bootstrap"]
        if (resilience.live_ranks() != tuple(range(n))
                or not boots or boots[-1]["rank"] != 3
                or len(boots[-1]["donors"]) < 2):
            raise AssertionError(f"21c: the join did not run: live "
                                 f"{resilience.live_ranks()}, {boots}")
        step, state = setup()
        joined, ramp = [dist()], []
        for _ in range(6):
            params, state, _ = step(params, state, batch)
            info = resilience.advance_membership()
            ramp.append(info["warming"].get(3, 1.0))
            if info["changed"]:
                step, state = setup()
            joined.append(dist())
        if not (all(b <= a * (1 + 1e-6) for a, b in zip(joined,
                                                         joined[1:]))
                and joined[-1] < joined[0]):
            raise AssertionError(f"21c: the joined ranks did not contract "
                                 f"monotonically: {joined}")
    finally:
        resilience.reset()
        bf.shutdown()
    return {"killed": killed, "healed_distance": healed,
            "heal_8_steps_s": heal_s, "joined_distance": joined,
            "warmup_ramp": ramp, "donors": boots[-1]["donors"]}


def _hr_checkpoint(fa, gf, smi):
    """21d: the trainer at full width, 2 steps, ``checkpoint.save``
    (``keep=1``), 2 more (the uninterrupted run).  A fresh trainer (seed
    1) restored from the checkpoint saves its state again through
    ``AsyncSaver``, whose write overlaps its next 2 steps: they equal the
    uninterrupted run; a third trainer restored from the asynchronous
    checkpoint and run 2 steps equals it too.  Equality: every tensor bit
    for bit.  The directories live under a temporary directory and are
    deleted (one at a time on disk)."""
    import shutil
    import tempfile
    from bluefog_tpu_torch import checkpoint as ckpt
    from bluefog_tpu_torch.parallel import context as bf
    tmp = tempfile.mkdtemp(prefix="bf_ckpt_")
    out = {}
    bf.init(size=HR_DP, device=DEV)
    try:
        _launch_counts(fa, gf, reset=True)
        per_step, step, params, state, toks = _hr_trainer()
        for _ in range(2):
            params, state, loss = step(params, state, toks)
        torch.cuda.synchronize()
        d = os.path.join(tmp, "sync")
        t0 = time.monotonic()
        path = ckpt.save(d, {"params": params, "state": state}, step=2,
                         keep=1)
        out["save_s"] = time.monotonic() - t0
        out["bytes_on_disk"] = sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        for _ in range(2):
            params, state, loss = step(params, state, toks)
        want = (params, state, loss)

        def restored(directory, tag):
            _, stp, p, s, _ = _hr_trainer(seed=1)     # a fresh trainer
            t0 = time.monotonic()
            tree, at = ckpt.restore_latest(
                directory, template={"params": p, "state": s})
            if at != 2:
                raise AssertionError(f"21d {tag}: restored step {at}")
            return stp, tree["params"], tree["state"], \
                time.monotonic() - t0

        def same(tag, got):
            n_t, diff = _hr_same(f"21d {tag}", got, want)
            if diff:
                raise AssertionError(f"21d {tag}: the resumed run differs "
                                     f"from the uninterrupted one by {diff}")
            return n_t

        stp, p, s, out["restore_s"] = restored(d, "sync")
        shutil.rmtree(d)
        d = os.path.join(tmp, "async")
        with ckpt.AsyncSaver() as saver:
            t0 = time.monotonic()
            saver.save(d, {"params": p, "state": s}, step=2)
            out["async_save_blocking_s"] = time.monotonic() - t0
            for _ in range(2):                  # overlaps the write
                p, s, ls = stp(p, s, toks)
            torch.cuda.synchronize()
            out["async_steps_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            saver.wait()
            out["async_wait_s"] = time.monotonic() - t0
        out["tensors"] = same("sync", (p, s, ls))
        del stp, p, s, ls
        stp, p, s, out["async_restore_s"] = restored(d, "async")
        for _ in range(2):
            p, s, ls = stp(p, s, toks)
        same("async", (p, s, ls))
        torch.cuda.synchronize()
        out["flash_launches"] = _hr_counts(fa, gf, "21d", 8 * per_step)[
            "flash_fwd"]
    finally:
        bf.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _hr_timeline(fa, gf, smi, scratch):
    """21e: ``BLUEFOG_TIMELINE`` armed at ``init`` over 2 steps of the
    trainer and three eager ops: the activities file (through the native
    writer) holds COMMUNICATE, ADAPT and GRADIENT spans and a span a
    neighbor_allreduce / allreduce / broadcast call, a ``torch.profiler``
    device trace with the kernels sits beside it, and
    tools/timeline_merge.py reads the file.  Then a ``hang`` fault on an
    eager op and a device spin of ~3 s behind it: the watchdog with a
    1 s timeout raises a TimeoutError naming the last flight event (the
    fault)."""
    from bluefog_tpu_torch import api
    from bluefog_tpu_torch.parallel import context as bf
    from bluefog_tpu_torch.utils import chaos
    from bluefog_tpu_torch.utils import metrics
    from bluefog_tpu_torch.utils import timeline as tl
    from bluefog_tpu_torch.utils import watchdog as wd
    root = os.path.dirname(os.path.abspath(__file__))
    prefix = os.path.join(scratch, "timeline", "host_runtime")
    os.environ[tl.ENV_VAR] = prefix
    try:
        bf.init(size=HR_DP, device=DEV)
    finally:
        del os.environ[tl.ENV_VAR]
    out = {}
    try:
        if not (tl.active() and tl.native_active()):
            raise AssertionError("21e: BLUEFOG_TIMELINE did not start the "
                                 "native timeline writer")
        _launch_counts(fa, gf, reset=True)
        per_step, step, params, state, toks = _hr_trainer()
        t0 = time.monotonic()
        for _ in range(2):
            params, state, loss = step(params, state, toks)
        x = torch.randn(HR_DP, 1 << 20, device=DEV)
        api.neighbor_allreduce(x)
        api.allreduce(x)
        api.broadcast(x, 0)
        torch.cuda.synchronize()
        out["traced_s"] = time.monotonic() - t0
        out["flash_launches"] = _hr_counts(fa, gf, "21e", 2 * per_step)[
            "flash_fwd"]
        del params, state, loss, step
    finally:
        bf.shutdown()
    path = prefix + ".activities.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    cats = {e["cat"] for e in events}
    if not ({"COMMUNICATE", "ADAPT", "GRADIENT"} <= names
            and {"neighbor_allreduce", "allreduce", "broadcast"} <= cats
            and all(e["ph"] == "X" and e["dur"] >= 0 for e in events)):
        raise AssertionError(f"21e: timeline spans {sorted(names)}, "
                             f"categories {sorted(cats)}")
    dev_path = tl.device_trace_path()
    with open(dev_path) as f:
        dev_events = json.load(f)["traceEvents"]
    kernels = [e for e in dev_events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if "flash" in e.get("name", "")]
    if not flash:
        raise AssertionError(f"21e: the device trace {dev_path} holds no "
                             f"K1/K2 kernel ({len(kernels)} kernels)")
    merged = os.path.join(scratch, "timeline", "merged.json")
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "timeline_merge.py"),
         merged, path], capture_output=True, text=True, timeout=120)
    with open(merged) as f:
        n_merged = len(json.load(f)["traceEvents"])
    if proc.returncode != 0 or n_merged != len(events) + 1:
        raise AssertionError(f"21e: timeline_merge: rc {proc.returncode}, "
                             f"{n_merged} events of {len(events)} + 1: "
                             f"{proc.stderr[-1000:]}")
    out.update(spans=len(events), span_names=sorted(names),
               device_trace_kernels=len(kernels),
               device_trace_flash_kernels=len(flash),
               device_trace_mb=os.path.getsize(dev_path) / 2 ** 20)

    bf.init(size=HR_DP, device=DEV)
    try:
        x = torch.randn(HR_DP, 1 << 20, device=DEV)
        chaos.install("hang:op=neighbor_allreduce,call=1,t=0.5")
        try:
            y = api.neighbor_allreduce(x)
        finally:
            chaos.uninstall()
        torch.cuda._sleep(6_000_000_000)        # ~3 s of a wedged kernel
        t0 = time.monotonic()
        try:
            wd.synchronize_with_watchdog(y, interval=0.25,
                                         name="host_runtime_wait",
                                         timeout=1.0)
            raise AssertionError("21e: the watchdog did not time out")
        except TimeoutError as e:
            msg = str(e)
        out["watchdog_raised_after_s"] = time.monotonic() - t0
        torch.cuda.synchronize()
        if "last event: hang:neighbor_allreduce" not in msg:
            raise AssertionError(f"21e: the watchdog's error does not name "
                                 f"the last flight event: {msg}")
        out["watchdog_message"] = msg
        out["watchdog_timeouts"] = metrics.counter(
            "bluefog_watchdog_timeouts_total").value(
                name="host_runtime_wait")
    finally:
        bf.shutdown()
    return out


def _hr_examples(fa, gf, smi, scratch):
    """21f (no kernel): examples/mnist at its defaults (3 epochs, 8 ranks,
    neighbor_allreduce; it asserts the last steps' loss below the
    first's), examples/resnet at its defaults (ResNet-18, 5 epochs) in two
    runs over one ``--checkpoint-dir``, 3 epochs then the resumed 2 (no
    epoch cut; it asserts finite losses), and examples/elastic_restart at
    its defaults (it asserts the 4-rank resume within 0.35 of the optimum
    and the re-seeded rank)."""
    import io
    from bluefog_tpu_torch.examples import elastic_restart, mnist, resnet
    ck = os.path.join(scratch, "resnet_ck")
    runs = {}
    for tag, mod, argv in (
            ("mnist", mnist, []),
            ("resnet18_epochs_0_3", resnet, ["--checkpoint-dir", ck,
                                             "--epochs", "3"]),
            ("resnet18_resumed_3_5", resnet, ["--checkpoint-dir", ck]),
            ("elastic_restart", elastic_restart, [])):
        _launch_counts(fa, gf, reset=True)
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        torch.cuda.synchronize()
        lines = buf.getvalue().strip().splitlines()
        runs[tag] = {"argv": argv, "seconds": time.monotonic() - t0,
                     "lines": lines}
        if rc != 0:
            raise AssertionError(f"21f {tag}: exit {rc}")
        _hr_counts(fa, gf, f"21f {tag}", 0)
    if runs["resnet18_resumed_3_5"]["lines"][0] != "resumed from epoch 3":
        raise AssertionError(f"21f: resnet did not resume: "
                             f"{runs['resnet18_resumed_3_5']['lines']}")
    return runs


def _hr_gather(native, reps=200):
    """The row gather at the examples' batches (8 ranks x 32 rows of
    mnist's 28x28x1 and resnet's 32x32x3 f32 images, and their int32
    labels): ``_native.gather_rows_native`` equal to numpy's ``a[idx]``,
    each timed on the host as the median of ``reps`` calls (us)."""
    rng = np.random.default_rng(0)
    out = {}
    for tag, shape in (("mnist_x", (6000, 28, 28, 1)),
                       ("mnist_y", (6000,)),
                       ("resnet_x", (2048, 32, 32, 3)),
                       ("resnet_y", (2048,))):
        a = (rng.normal(size=shape).astype(np.float32) if len(shape) > 1
             else rng.integers(0, 10, shape).astype(np.int32))
        idx = rng.permutation(shape[0])[:8 * 32].reshape(8, 32)
        if not np.array_equal(native.gather_rows_native(a, idx), a[idx]):
            raise AssertionError(f"phase 21: the native gather of {tag} "
                                 f"differs from numpy's")
        row = {}
        for name, fn in (("numpy", lambda: a[idx]),
                         ("native", lambda: native.gather_rows_native(
                             a, idx))):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            row[name] = float(np.median(ts)) * 1e6
        out[tag] = row
    return out


def host_runtime_phase(fa, gf, fd, smi):
    """Phase 21: the host runtime (chaos, healing and rollback,
    checkpoints, the data pipeline, the timeline and the watchdog, the
    mnist / resnet / elastic_restart examples) through the dense trainer
    at lm_bench's full width; a ``host_runtime`` line a leg.  Returns the
    K1/K2 launches of the phase's runs and each leg's seconds."""
    import shutil
    import tempfile
    from bluefog_tpu_torch import _native
    from bluefog_tpu_torch.data import ShardedLoader
    from bluefog_tpu_torch.parallel import context as bf
    scratch = tempfile.mkdtemp(prefix="bf_host_runtime_")
    seconds, seen = {}, {}

    def leg(name, fn, *args):
        t0 = time.monotonic()
        row = fn(*args)
        seconds[name] = time.monotonic() - t0
        print("host_runtime " + json.dumps(dict(
            leg=name, result=row, seconds=seconds[name],
            device=torch.cuda.get_device_name(0), nvidia_smi=smi)),
            flush=True)
        return row

    try:
        fd.flash_decode_cuda.launches = 0
        # the native helpers load here; the loader's batches through pinned
        # buffers and the side stream equal its host batches
        if not _native.available():
            raise AssertionError(f"phase 21: the native helpers did not "
                                 f"load: {_native.build_error()}")
        bf.init(size=HR_DP, device=DEV)
        try:
            rng = np.random.default_rng(0)
            arrays = [rng.normal(size=(4096, 28, 28, 1)).astype(np.float32),
                      rng.integers(0, 10, 4096).astype(np.int32)]
            loader = ShardedLoader(arrays, 32, seed=1)
            twin = ShardedLoader(arrays, 32, seed=1)
            t0 = time.monotonic()
            got = [tuple(t.clone() for t in b) for b in loader]
            torch.cuda.synchronize()
            loader_s = time.monotonic() - t0
            for b, h in zip(got, twin._host_batches()):
                if not all(t.is_cuda and np.array_equal(t.cpu().numpy(), a)
                           for t, a in zip(b, h)):
                    raise AssertionError("phase 21: a prefetched batch "
                                         "differs from its host batch")
        finally:
            bf.shutdown()
        native = {"library": _native.library_path(),
                  "loader_batches": len(got), "loader_epoch_s": loader_s,
                  "gather_us": _hr_gather(_native)}
        straggler = leg("21a_straggler", _hr_straggler, fa, gf, smi,
                        scratch, seen)
        guard = leg("21b_guard", _hr_guard, fa, gf, smi)
        leg("21c_heal", _hr_heal, smi)
        ckpt_row = leg("21d_checkpoint", _hr_checkpoint, fa, gf, smi)
        timeline = leg("21e_timeline_watchdog", _hr_timeline, fa, gf, smi,
                       scratch)
        leg("21f_examples", _hr_examples, fa, gf, smi, scratch)
        native["timeline_native"] = True        # 21e asserted it
        if fd.flash_decode_cuda.launches:
            raise AssertionError("phase 21 launched flash_decode")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    flash = (sum(straggler[k]["flash_launches"] for k in (
        "throttle_0.2", "throttle_2x"))
        + guard["flash_launches"] + ckpt_row["flash_launches"]
        + timeline["flash_launches"])
    print("host_runtime_native " + json.dumps(native), flush=True)
    return {"flash_fwd": flash, "flash_bwd": flash, "grouped_ffn": 0,
            "grouped_ffn_forward_gemm": 0, "grouped_ffn_dgrad": 0,
            "grouped_ffn_backward_plan": 0, "flash_decode": 0}, seconds


# -- phase 22: the launcher, the elastic world and the fleet view --------

EL_DP, EL_GROWN = 4, 6        # 22a: dp 4 -> 6 -> 4
EL_TIMEOUT = "2.0"            # 22b: BLUEFOG_REGROW_TIMEOUT of the hang
EL_HANG = 3.0                 # 22b: hang_reinit's seconds (> the timeout)


def _el_cfg():
    from bluefog_tpu_torch.parallel import compose
    return compose.LMConfig(vocab=32768, d_model=1024, heads=16, layers=2,
                            seq_len=2048, micro=4, batch=4)


def _el_trainer(cfg, m, tree=None, seed=0):
    """lm_bench's dense trainer on carving ``m`` (delayed AWC, Adam at
    5e-3, K1/K2, the probe every step): ``(step, tree, tokens)``.  With
    ``tree`` (a carried state in the snapshot's form) the params are its
    params and the whole state is written from it; else drawn from
    ``seed``."""
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.parallel import compose
    from bluefog_tpu_torch.utils.snapshot import restore_into
    step, strategy = compose.make_train_step(
        m, compose.make_lm_grad_fn(cfg, m, use_pallas=True),
        bfopt.adam(5e-3), delayed=True, metrics_every_k=1)
    if tree is None:
        params = compose.init_lm_train_params(cfg, m, seed=seed)
    else:
        params = _el_to(tree["params"], m.device)
    state = bfopt.init_distributed(strategy, params)
    live = {"params": params, "state": state}
    if tree is not None:
        live = restore_into(live, tree)
    return step, live, compose.make_lm_batch(cfg, m, seed=seed)


def _el_step(step, live, toks):
    p, s, loss = step(live["params"], live["state"], toks)
    return {"params": p, "state": s}, loss


def _el_tensors(tree):
    """A tree's tensors (optimizers as their per-parameter state lists,
    dataclasses as dicts of their fields) with dict keys in sorted order,
    so a live state and its carried snapshot line up (the joiner pull
    rebuilds dicts in key order)."""
    from bluefog_tpu_torch.utils.snapshot import live_tensors, unfold
    return live_tensors(unfold(tree))


def _el_rows(tag, got, want, old_n, new_n):
    """The survivors' rows of every tensor of ``got`` (a carried tree)
    equal, bit for bit, those of ``want`` (the old world's state the
    regrowth's host snapshot copied, untouched by it); the other tensors
    whole.  Returns the row tensors held."""
    a, b = _el_tensors(got), _el_tensors(want)
    if len(a) != len(b):
        raise AssertionError(f"{tag}: {len(a)} carried tensors against "
                             f"{len(b)}")
    keep, rows = min(old_n, new_n), 0
    for x, y in zip(a, b):
        if y.ndim and y.shape[0] == old_n:
            ok = x.shape[0] == new_n and torch.equal(x[:keep], y[:keep])
            rows += 1
        else:
            ok = torch.equal(x, y.to(x.device))
        if not ok:
            raise AssertionError(f"{tag}: a carried tensor {tuple(x.shape)}"
                                 f" differs from the old world's")
    return rows


def _el_same(tag, a, b):
    """Two trees' tensors (either may be a snapshot) bit for bit; returns
    their count."""
    x, y = _el_tensors(a), _el_tensors(b)
    if len(x) != len(y):
        raise AssertionError(f"{tag}: {len(x)} tensors against {len(y)}")
    for u, v in zip(x, y):
        if not torch.equal(u, v.to(u.device)):
            d = float((u.double() - v.to(u.device).double()).abs().max())
            raise AssertionError(f"{tag}: a tensor {tuple(u.shape)} "
                                 f"differs by {d}")
    return len(x)


def _el_to(tree, dev):
    """``tree``'s tensors copied onto ``dev``."""
    if isinstance(tree, dict):
        return {k: _el_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def _el_fleet(port, n):
    """One ``fleet_top --once --json`` frame over HTTP (the port's tool as
    a subprocess): every one of the ``n`` ranks' rows seen, and the
    fleet's mean step time the mean of its per-rank table."""
    # the tool's file run as a script: it needs nothing of the package
    # (standard library only), so the frame costs no torch import
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bluefog_tpu_torch", "tools", "fleet_top.py")
    proc = subprocess.run(
        [sys.executable, tool, "--url", f"http://127.0.0.1:{port}/fleet",
         "--once", "--json"], capture_output=True, text=True, timeout=60)
    if proc.returncode:
        raise AssertionError(f"fleet_top failed: {proc.stderr[-1500:]}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    st = doc["metrics"]["bluefog_step_time_ewma_s"]
    per = [st["per_rank"].get(str(r)) for r in range(n)]
    if doc["n"] != n or doc["seen_ranks"] != list(range(n)) or \
            None in per:
        raise AssertionError(f"fleet frame: n {doc['n']}, seen "
                             f"{doc['seen_ranks']}, step times {per}; "
                             f"want every one of {n} ranks")
    if not np.isclose(st["global"], float(np.mean(per)), rtol=1e-6):
        raise AssertionError(f"fleet mean step time {st['global']} != "
                             f"the per-rank mean {np.mean(per)}")
    return {"n": doc["n"], "round": doc["round"],
            "step_time_s": st["global"], "per_rank_step_time_s": per,
            "staleness_rounds_max": doc["staleness"]["rounds_max"]}


def _el_flood(diag, params):
    """Probes until every rank's row has flooded the armed view (the
    live graph's diameter)."""
    from bluefog_tpu_torch.parallel import context as bf
    from bluefog_tpu_torch.utils import fleetview
    for _ in range(fleetview._graph_diameter(bf.static_schedule(),
                                             frozenset())):
        diag.diagnose_consensus(params)


def _el_regrow(fa, gf, smi):
    """22a and 22b.  Returns their rows and the K1/K2 launches."""
    from bluefog_tpu_torch import diagnostics as diag
    from bluefog_tpu_torch import resilience as rz
    from bluefog_tpu_torch.ops import _build
    from bluefog_tpu_torch.parallel import context as bf
    from bluefog_tpu_torch.parallel import compose
    from bluefog_tpu_torch.utils import chaos, fleetview
    from bluefog_tpu_torch.utils import metrics as bfm
    from bluefog_tpu_torch.utils.snapshot import restore_into, snapshot
    cfg = _el_cfg()
    per_step = {n: n * cfg.micro * cfg.layers for n in (EL_DP, EL_GROWN)}
    out, seen, launches = {}, {}, 0
    laps, t_lap = {}, [time.monotonic()]

    def lap(name):                      # seconds of each stretch of 22a-b
        now = time.monotonic()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    os.environ["BLUEFOG_FLEET_EVERY"] = "1"
    bf.init(size=EL_DP, device=DEV)
    try:
        port = bfm.start_http_server(0)
        if fleetview.fleet_every() != 1:
            raise AssertionError("22a: BLUEFOG_FLEET_EVERY did not arm "
                                 "the fleet view at init")
        torch.cuda.reset_peak_memory_stats()
        _launch_counts(fa, gf, reset=True)
        with mock.patch.object(
                fa, "attention_block_partial",
                _capture_copy(seen, "k1", fa.attention_block_partial)), \
                mock.patch.object(
                    fa, "attention_block_backward",
                    _capture_copy(seen, "k2", fa.attention_block_backward)):
            m4 = compose.compose_parallelism(EL_DP, device=DEV)
            step4, live4, toks4 = _el_trainer(cfg, m4)
            lap("dp4_trainer")
            t0 = time.monotonic()
            for _ in range(2):
                live4, _ = _el_step(step4, live4, toks4)
            torch.cuda.synchronize()
            out["dp4_first_2_steps_s"] = time.monotonic() - t0
            _el_flood(diag, live4["params"])
            lap("dp4_steps")
            out["fleet_dp4"] = _el_fleet(port, EL_DP)
            lap("dp4_flood_and_fleet_top")
            # the probe's cost on this state, the fleet view armed and not
            probe = {}
            for arm in (True, False):
                if not arm:
                    fleetview.disarm()
                torch.cuda.synchronize()
                t0 = time.monotonic()
                for _ in range(3):
                    diag.diagnose_consensus(live4["params"])
                torch.cuda.synchronize()
                probe["armed" if arm else "disarmed"] = \
                    (time.monotonic() - t0) / 3 * 1e3
            fleetview.arm(every=1)          # armed again for the regrowth
            out["probe_ms"] = probe
            lap("probe_timing")
            state_bytes = sum(t.numel() * t.element_size()
                              for t in _el_tensors(live4))
            # -- regrow 4 -> 6 ------------------------------------------
            b0 = _build.build_counts()
            t0 = time.monotonic()
            grown, handle = rz.regrow_world(EL_GROWN, live4)
            out["regrow_4_6_s"] = time.monotonic() - t0
            builds = {"regrow_4_6": _delta(b0, _build.build_counts())}
            out["regrow_4_6_phases_s"] = {
                p["phase"]: p["elapsed_s"] for p in
                rz._regrow_flight_block()["phases"]}
            out["bytes_carried_4_6"] = handle.bytes_carried
            out["state_bytes_dp4"] = state_bytes
            if (bf.size(), handle.joiners) != (EL_GROWN, (4, 5)):
                raise AssertionError(f"22a: world {bf.size()}, joiners "
                                     f"{handle.joiners}")
            lap("regrow_4_6")
            out["survivor_tensors"] = _el_rows("22a survivors", grown,
                                               live4, EL_DP, EL_GROWN)
            out["joiner_pull_max_rel_err"] = _el_joiners(grown)
            lap("carry_checks")
            m6 = bf.get_compose()
            if (m6.dp, m6.slice_size) != (EL_GROWN, 1):
                raise AssertionError(f"22a: the carving after reinit is "
                                     f"{m6.describe()}")
            # the first step on the new world ...
            step6, live6, toks6 = _el_trainer(cfg, m6, tree=grown)
            lap("dp6_trainer")
            host_grown = snapshot(grown, pin=True)
            del grown
            lap("host_copy_of_carry")
            t0 = time.monotonic()
            live6, loss6 = _el_step(step6, live6, toks6)
            torch.cuda.synchronize()
            out["dp6_step_s"] = time.monotonic() - t0
            out["dp6_loss_mean"] = float(loss6.float().mean())
            _el_flood(diag, live6["params"])
            lap("dp6_step")
            out["fleet_dp6"] = _el_fleet(port, EL_GROWN)
            lap("dp6_flood_and_fleet_top")
            if not handle.commit():
                raise AssertionError("22a: nothing to commit")
            del step4, live4
            # ... equals a fresh dp-6 world's started from the carried state
            stepb, liveb, _ = _el_trainer(cfg, m6, tree=host_grown)
            del host_grown
            liveb, lossb = _el_step(stepb, liveb, toks6)
            torch.cuda.synchronize()
            out["fresh_world_tensors"] = _el_same(
                "22a first dp-6 step vs a fresh dp-6 world",
                (live6, loss6), (liveb, lossb))
            del stepb, liveb, lossb
            lap("fresh_dp6_world")
            # -- regrow 6 -> 4, a size already seen ----------------------
            b0 = _build.build_counts()
            t0 = time.monotonic()
            shrunk, handle = rz.regrow_world(EL_DP, live6)
            out["regrow_6_4_s"] = time.monotonic() - t0
            builds["regrow_6_4"] = _delta(b0, _build.build_counts())
            out["regrow_6_4_phases_s"] = {
                p["phase"]: p["elapsed_s"] for p in
                rz._regrow_flight_block()["phases"]}
            out["bytes_carried_6_4"] = handle.bytes_carried
            _el_rows("22a 6 -> 4 survivors", shrunk, live6, EL_GROWN, EL_DP)
            del step6, live6
            lap("regrow_6_4")
            m4 = bf.get_compose()
            step4, live4, toks4 = _el_trainer(cfg, m4, tree=shrunk)
            del shrunk
            live4, _ = _el_step(step4, live4, toks4)
            torch.cuda.synchronize()
            handle.commit()
            lap("dp4_again")
            out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            launches = _hr_counts(fa, gf, "22a", 2 * per_step[EL_DP]
                                  + 2 * per_step[EL_GROWN]
                                  + per_step[EL_DP])["flash_fwd"]
        out["builds"] = builds
        if any(v for d in builds.values() for v in d.values()):
            raise AssertionError(f"22a: kernels built or loaded during a "
                                 f"regrow: {builds}")
        out["kernels"] = _k12_checks("elastic", fa, seen)
        lap("k1_k2_checks")
        # -- 22b: the abort path at this state --------------------------
        _launch_counts(fa, gf, reset=True)
        before = snapshot(live4, pin=True)
        torch.cuda.synchronize()
        lap("abort_snapshot")
        aborts = {}
        for plan, env, phase in (
                ("kill_coordinator:step=1", None, "quiesce"),
                (f"hang_reinit:t={EL_HANG},p=1", EL_TIMEOUT, "reinit")):
            old = bf.get_context()
            chaos.install(plan)
            if env:
                os.environ["BLUEFOG_REGROW_TIMEOUT"] = env
            t0 = time.monotonic()
            try:
                rz.regrow_world(EL_GROWN, live4, retries=0)
                raise AssertionError(f"22b: {plan} did not abort")
            except rz.RegrowAborted as e:
                aborts[plan] = {"phase": e.phase, "rank": e.rank,
                                "seconds": time.monotonic() - t0}
                if e.phase != phase:
                    raise AssertionError(f"22b: {plan} aborted in phase "
                                         f"{e.phase}, want {phase}")
            finally:
                chaos.uninstall()
                os.environ.pop("BLUEFOG_REGROW_TIMEOUT", None)
            if bf.get_context() is not old or rz.regrow_pending() or \
                    bf.get_compose().dp != EL_DP:
                raise AssertionError(f"22b: {plan} left world "
                                     f"{bf.size()}")
        lap("aborts")
        live4, loss_a = _el_step(step4, live4, toks4)
        after = snapshot((live4, loss_a), pin=True)
        live4 = restore_into(live4, before)
        live4, loss_b = _el_step(step4, live4, toks4)
        torch.cuda.synchronize()
        out["abort_step_tensors"] = _el_same(
            "22b the step after two aborts vs a step with none",
            (live4, loss_b), after)
        out["aborts"] = aborts
        lap("abort_steps")
        out["seconds_by_stretch"] = laps
        launches += _hr_counts(fa, gf, "22b", 2 * per_step[EL_DP])[
            "flash_fwd"]
        del step4, live4, before, after
    finally:
        os.environ.pop("BLUEFOG_FLEET_EVERY", None)
        bfm.stop_http_server()
        fleetview.reset()
        rz.reset()
        bf.shutdown()
        torch.cuda.empty_cache()
    return out, launches


def _delta(a, b):
    return {k: b[k] - a[k] for k in a}


def _el_joiners(tree):
    """Each joiner's row of every pulled tensor against the plain mean of
    its donors' rows in f64 (joiner 5's donors include joiner 4, pulled
    first); the largest error relative to the row's scale."""
    from bluefog_tpu_torch import resilience as rz
    sched = rz._pristine["sched"]
    worst = 0.0
    for t in _el_tensors(tree):
        if not (t.is_floating_point() and t.ndim and
                t.shape[0] == EL_GROWN):
            continue
        for j in (4, 5):
            donors = [int(d) for d in sched.in_neighbors[j]]
            want = sum(t[d].double() for d in donors) / len(donors)
            scale = max(float(want.abs().max()), 1e-30)
            worst = max(worst, float((t[j].double() - want).abs().max())
                        / scale)
    if worst > 1e-6:
        raise AssertionError(f"22a: a joiner's row is {worst} (relative) "
                             "from its donors' mean")
    return worst


def _el_tools(smi, scratch):
    """22c: the tools at their JAX defaults on CUDA tensors (host bound,
    nothing cut): ``regrow_drill`` (4 -> 6) with and without
    ``--chaos kill_coordinator:step=1``, and ``preempt_bench`` replaying
    the ``mass`` trace ``preempt_trace`` writes at its defaults (8 ranks,
    4 zones).  Returns their lines' numbers."""
    import io
    from bluefog_tpu_torch.tools import (preempt_bench, preempt_trace,
                                         regrow_drill)
    out = {}
    for tag, argv in (("drill", []),
                      ("drill_chaos", ["--chaos",
                                       "kill_coordinator:step=1"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = regrow_drill.main(argv + ["--flight-dir",
                                           os.path.join(scratch, tag)])
        doc = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc or not doc["ok"] or doc["aborted"] != (tag == "drill_chaos"):
            raise AssertionError(f"22c {tag}: {doc}")
        out[tag] = {k: doc.get(k) for k in (
            "world_before", "world_after", "committed", "aborted",
            "abort_phase", "duration_s", "carry_lossless",
            "kernel_builds_during_regrow", "kernel_loads_during_regrow")}
    trace = os.path.join(scratch, "mass.json")
    with contextlib.redirect_stdout(io.StringIO()):
        if preempt_trace.main(["--pattern", "mass", "--out", trace]):
            raise AssertionError("22c: preempt_trace failed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = preempt_bench.main(["--trace", trace, "--flight-dir",
                                 os.path.join(scratch, "preempt")])
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc or not doc["ok"] or doc["warm_fresh_builds"] or \
            not doc["device"].startswith("cuda"):
        raise AssertionError(f"22c preempt_bench: {doc}")
    out["preempt_bench"] = {k: doc[k] for k in (
        "pattern", "world", "zones", "events", "goodput_fraction",
        "continuity_ok", "cold_regrow_s", "warm_regrow_s",
        "warm_fresh_builds", "victims_total", "preempt_events")}
    out["preempt_bench"]["fresh_builds_by_cycle"] = [
        (c["shrink_fresh_builds"], c["regrow_fresh_builds"])
        for c in doc["cycles"]]
    return out


_EL_LAUNCHER = [sys.executable, "-m", "bluefog_tpu_torch.run.launcher"]

# the lm_bench child: its K1/K2 counts and its process group, after the run
_EL_LM_CHILD = (
    "import json, sys\n"
    "import torch.distributed as dist\n"
    "from bluefog_tpu_torch.ops import flash_attention as fa\n"
    "from bluefog_tpu_torch.parallel import context as bf\n"
    "from bluefog_tpu_torch.tools import lm_bench\n"
    "bf.init(size=4)\n"
    "backend, world = dist.get_backend(), dist.get_world_size()\n"
    "doc = lm_bench.main(sys.argv[1:])\n"
    "print('lm_bench_child ' + json.dumps(dict(ok=doc['ok'], "
    "fwd=fa.fwd_launches, bwd=fa.bwd_launches, backend=backend, "
    "world=world, per_step_s=doc['per_step_s'], "
    "bundle=doc['flight_bundle'])))\n")


def _el_start_children(scratch):
    """22d's children that launch no K1-K4 (their output to files under
    ``scratch``): the interactive session
    (one worker on the card; its cell forms the world and prints the
    card's name) and ``examples/elastic_restart`` under
    ``--restart-limit 1`` with a planted kill in its first run
    (``BLUEFOG_CHAOS`` only while ``BLUEFOG_RESTART_COUNT`` is unset)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    cell = os.path.join(scratch, "cell.py")
    with open(cell, "w") as f:
        f.write("print(torch.cuda.get_device_name(), bf.size(), "
                "bf.get_context().world, bf.get_context().device)\n")
    wrapper = ("[ -n \"$BLUEFOG_RESTART_COUNT\" ] || "
               "export BLUEFOG_CHAOS=kill:step=40,rank=3; "
               f"exec {sys.executable} -m "
               "bluefog_tpu_torch.examples.elastic_restart")
    procs = {}
    for tag, argv, stdin in (
            ("interactive", ["--interactive", "-np", "1"], cell),
            ("restart", ["-np", "1", "--restart-limit", "1",
                         "--restart-backoff", "0.1", "--", "sh", "-c",
                         wrapper], None)):
        with open(os.path.join(scratch, tag + ".out"), "w") as out, \
                open(os.path.join(scratch, tag + ".err"), "w") as err, \
                open(stdin or os.devnull) as inp:
            procs[tag] = subprocess.Popen(
                _EL_LAUNCHER + argv, cwd=root, env=env, stdin=inp,
                stdout=out, stderr=err, text=True)
    return procs


def _el_join_children(procs, scratch):
    """Wait for 22d's background children and hold their results."""
    def read(tag):
        procs[tag].wait(timeout=300)
        with open(os.path.join(scratch, tag + ".out")) as a, \
                open(os.path.join(scratch, tag + ".err")) as b:
            return procs[tag].returncode, a.read(), b.read()

    out = {}
    rc, so, se = read("interactive")
    name = torch.cuda.get_device_name(0)
    if rc or "workers ready: ranks [0]" not in so or \
            f"{name} 1 1 cuda:0" not in so:
        raise AssertionError(f"22d interactive: rc {rc}, {so[-1500:]} "
                             f"{se[-1500:]}")
    out["interactive"] = [ln for ln in so.splitlines() if name in ln][0]
    rc, so, se = read("restart")
    if rc or "restarting rank 0 (attempt 1/1)" not in se or \
            "rank 0 exited with code" not in se or "all OK" not in so:
        raise AssertionError(f"22d restart: rc {rc}, {so[-1500:]} "
                             f"{se[-2000:]}")
    out["restart"] = {"rc": rc, "supervisor": [
        ln for ln in se.splitlines() if ln.startswith("bfrun-torch:")],
        "last_line": so.strip().splitlines()[-1]}
    return out


def _el_launch_lm(scratch):
    """22d: ``bfrun-torch -np 1 --flight-dir D`` over the port's lm_bench
    at full width (dp 4, pp 1, tp 1, 2 layers, micro 4; 2 warm-up steps
    and 1 timed, lm_bench's least), a one-process NCCL world, started in
    the background (~20 GB of the card)."""
    root = os.path.dirname(os.path.abspath(__file__))
    flight = os.path.join(scratch, "bfrun_flight")
    with open(os.path.join(scratch, "lm.out"), "w") as out, \
            open(os.path.join(scratch, "lm.err"), "w") as err:
        return subprocess.Popen(
            _EL_LAUNCHER + ["-np", "1", "--flight-dir", flight, "--",
                            sys.executable, "-c", _EL_LM_CHILD, "--dp", "4",
                            "--pp", "1", "--tp", "1", "--layers", "2",
                            "--micro", "4", "--iters", "1",
                            "--steps-per-call", "1", "--no-sweep",
                            "--no-trace", "--flight-dir", flight],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdin=subprocess.DEVNULL, stdout=out, stderr=err, text=True)


def _el_join_lm(proc, scratch):
    """The lm_bench child's result: its K1/K2 counts are the formula's,
    over NCCL at world 1, its bundle in the flight directory."""
    proc.wait(timeout=600)
    with open(os.path.join(scratch, "lm.out")) as a, \
            open(os.path.join(scratch, "lm.err")) as b:
        so, se = a.read(), b.read()
    lines = [ln for ln in so.splitlines() if ln.startswith("lm_bench_child ")]
    if proc.returncode or not lines:
        raise AssertionError(f"22d lm_bench: rc {proc.returncode}: "
                             f"{so[-1500:]} {se[-2500:]}")
    doc = json.loads(lines[-1][len("lm_bench_child "):])
    want = 3 * 4 * 4 * 2          # 3 steps x dp 4 x micro 4 x 2 layers
    if not doc["ok"] or (doc["fwd"], doc["bwd"]) != (want, want) or \
            (doc["backend"], doc["world"]) != ("nccl", 1) or \
            not os.path.exists(doc["bundle"]):
        raise AssertionError(f"22d lm_bench child: {doc}, want {want} "
                             "K1/K2 launches each over NCCL at world 1")
    return doc


def elastic_start():
    """22d's children, started before phase 17 so that they run beside
    phases 17-21 (none launches K1-K4 in this process; the lm_bench child
    needs ~20 GB of the card): the interactive session, the restart over
    ``examples/elastic_restart`` and the lm_bench child.  Returns them,
    their scratch directory and their clock (the start, and a thread a
    child that notes its end); any still running at exit is killed."""
    import atexit
    import tempfile
    import threading
    scratch = tempfile.mkdtemp(prefix="bf_elastic_")
    t_on = time.monotonic()
    procs = _el_start_children(scratch)
    procs["lm_bench"] = _el_launch_lm(scratch)
    ends = {}

    def note_end(tag, proc):
        proc.wait()
        ends[tag] = time.monotonic()

    waiters = [threading.Thread(target=note_end, args=item, daemon=True)
               for item in procs.items()]
    for w in waiters:
        w.start()

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return procs, scratch, (t_on, ends, waiters)


def _el_overlap(started, windows, t_start):
    """Which phases each of 22d's children ran beside: its start and end
    (seconds since the script's start) and the phases whose window
    ``(start, end)`` in ``windows`` meets them."""
    t_on, ends, waiters = started[2]
    for w in waiters:
        w.join(timeout=10)
    out = {}
    for tag, t_end in sorted(ends.items()):
        a, b = t_on - t_start, t_end - t_start
        out[tag] = {"start_s": a, "end_s": b, "beside": [
            name for name, (s, e) in windows.items() if s < b and e > a]}
    return out


def elastic_phase(fa, gf, fd, smi, started):
    """Phase 22: the launcher, the elastic world and the fleet view (an
    ``elastic`` line a leg), with 22d's children from
    :func:`elastic_start`.  Returns the K1/K2 launches of the phase's own
    runs (22a, 22b) and each leg's seconds."""
    import shutil
    procs, scratch, _ = started
    seconds = {}

    def leg(name, fn, *args):
        t0 = time.monotonic()
        row = fn(*args)
        seconds[name] = time.monotonic() - t0
        print("elastic " + json.dumps(dict(
            leg=name, result=row, seconds=seconds[name],
            device=torch.cuda.get_device_name(0), nvidia_smi=smi)),
            flush=True)
        return row

    try:
        fd.flash_decode_cuda.launches = 0
        row, launches = leg("22a_22b_regrow", _el_regrow, fa, gf, smi)
        _launch_counts(fa, gf, reset=True)
        leg("22c_tools", _el_tools, smi, scratch)
        _hr_counts(fa, gf, "22c", 0)
        leg("22d_children", _el_join_children, procs, scratch)
        leg("22d_lm_bench", _el_join_lm, procs["lm_bench"], scratch)
        if fd.flash_decode_cuda.launches:
            raise AssertionError("phase 22 launched flash_decode")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(scratch, ignore_errors=True)
    return {"flash_fwd": launches, "flash_bwd": launches, "grouped_ffn": 0,
            "grouped_ffn_forward_gemm": 0, "grouped_ffn_dgrad": 0,
            "grouped_ffn_backward_plan": 0, "flash_decode": 0}, seconds


# -- phase 14: the ResNet-50 gossip benchmark --------------------------

RESNET_IMAGES = 4             # 14a's batch
# 14b / 14c's timed calls (the tool's 10, cut to make room for phase 21)
RESNET_BENCH_ITERS = ["--iters", "2"]


def resnet_parity_phase(smi):
    """14a: ResNet-50 at full width on the card against the CPU, f32 and
    bf16, on one set of seeded weights with live BatchNorm scales, by
    ``tools/resnet_parity.py``'s gates (a CPU float64 run is the
    reference; both f32 runs replay its ReLU masks and max-pool picks)."""
    from bluefog_tpu_torch.models import ResNet50
    from bluefog_tpu_torch.tools import resnet_parity
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(
        size=(RESNET_IMAGES, 224, 224, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, RESNET_IMAGES))
    models = {name: ResNet50(num_classes=1000, dtype=dt,
                             generator=torch.Generator().manual_seed(0))
              for name, dt in (("f64", torch.float64),
                               ("f32", torch.float32),
                               ("bf16", torch.bfloat16))}
    variables = resnet_parity.live_variables(models["f32"], seed=0)
    assert len(resnet_parity.leaf_names(variables["params"])) == 161
    summary = dict(images=RESNET_IMAGES, image_size=224, classes=1000,
                   **resnet_parity.compare(models, variables, x, labels,
                                           DEV),
                   device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    print("resnet_parity " + json.dumps(summary), flush=True)
    resnet_parity.check(summary)
    return summary


def resnet_bench_phase(smi, tag, argv):
    """14b / 14c: ``tools/bench.py`` on the card; the loss finite and
    falling, every rank's parameters equal (same data, same start)."""
    from bluefog_tpu_torch.fusion import tree_flatten
    from bluefog_tpu_torch.parallel import context
    from bluefog_tpu_torch.tools import bench
    doc, b = bench.run(bench.parse(argv))
    spread = 0.0
    for leaf in tree_flatten(b.params)[0]:
        scale = float(leaf.abs().max())
        if scale:
            spread = max(spread, float((leaf - leaf[:1]).abs().max())
                         / scale)
    doc.update(param_rank_spread_rel=spread, nvidia_smi=smi)
    print(f"{tag} " + json.dumps(doc), flush=True)
    if not (np.isfinite(doc["loss_last"])
            and doc["loss_last"] < doc["loss_first"]):
        raise AssertionError(f"{tag}: the loss did not fall: "
                             f"{doc['loss_first']} -> {doc['loss_last']}")
    if spread > 1e-5:
        raise AssertionError(f"{tag}: the ranks' parameters differ by "
                             f"{spread} x max|param| (same data and start)")
    context.shutdown()
    del b
    torch.cuda.empty_cache()
    return doc


_OP_CLASSES = (
    ("conv_backward", ("aten::convolution_backward",)),
    ("conv_forward", ("aten::convolution",)),
    ("max_pool", ("aten::max_pool2d", "aten::max_pool2d_with_indices",
                  "aten::max_pool2d_with_indices_backward")),
    ("dtype_casts", ("aten::_to_copy",)),
    ("library_batch_norm", ("aten::native_batch_norm",
                            "aten::cudnn_batch_norm", "aten::_batch_norm",
                            "aten::batch_norm", "aten::var_mean")),
    ("gossip", ("bench.gossip",)),
    ("optimizer", ("bench.optimizer",)),
    ("bn_relu_residual_loss", ("bench.grad_fn",
                               "autograd::engine::evaluate_function")))


def _op_class(ev):
    names = []
    while ev is not None:
        names.append(ev.name)
        ev = ev.cpu_parent
    for cls, keys in _OP_CLASSES:
        if any(n in keys or any(n.startswith(k) for k in keys)
               for n in names):
            return cls
    return "other"


def profile_resnet(smi, ranks=1, batch=64, label="port"):
    """One bench call (5 steps, ``batch`` a rank) under torch.profiler: device time
    by operator class (the CPU op that launched each kernel, and its
    callers: convs forward / backward, max pool, dtype casts, the
    gossip, the optimizer, then the rest of forward and backward: the
    port's BatchNorm as eager ops, ReLU, residual adds and the loss;
    ``library_batch_norm`` holds PyTorch's batch-norm operators, which
    only :func:`resnet_bn_yardstick` runs), and the busy share: the
    device time over the wall time of the same call unprofiled (and
    profiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from bluefog_tpu_torch import optimizers as bfopt
    from bluefog_tpu_torch.parallel import context
    from bluefog_tpu_torch.tools import bench

    def labelled(fn, label):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped

    comm = bfopt.neighbor_communicator
    grad_fn = bench.make_grad_fn
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True      # as tools/bench.py runs
    with mock.patch.object(bfopt, "_apply",
                           labelled(bfopt._apply, "bench.optimizer")), \
            mock.patch.object(bfopt, "neighbor_communicator",
                              lambda *a, **kw: labelled(
                                  comm(*a, **kw), "bench.gossip")), \
            mock.patch.object(bench, "make_grad_fn",
                              lambda m: labelled(grad_fn(m),
                                                 "bench.grad_fn")):
        b = bench.build(ranks=ranks, batch=batch, steps_per_call=5,
                        image_size=224, num_classes=1000, device=DEV)
        params, state, loss = b.step(b.params, b.state, b.data)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, state, loss = b.step(params, state, b.data)
        torch.cuda.synchronize()
        wall_unprofiled_ms = 1e3 * (time.monotonic() - t0)
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, loss = b.step(params, state, b.data)
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    torch.backends.cudnn.benchmark = benchmark
    # kernels only: the ranges (ours, and the optimizer's own) show on
    # the device timeline too and would count their kernels twice
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not ev.key.startswith(("bench.", "Optimizer."))]
    total_us = sum(r[0] for r in rows)
    for dt, key, count in sorted(rows, reverse=True)[:12]:
        print("profile_resnet " + json.dumps({
            "kernel": key[:90], "calls": count, "device_us": dt,
            "share": dt / total_us}))
    by_class = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.self_device_time_total:
            cls = _op_class(ev)
            by_class[cls] = by_class.get(cls, 0.0) + \
                ev.self_device_time_total / 1e3
    print("profile_resnet " + json.dumps({
        "label": label, "ranks": ranks, "batch_per_rank": batch,
        "steps": 5,
        "call_wall_ms": wall_unprofiled_ms,
        "call_wall_ms_profiled": wall_ms, "device_busy_ms": total_us / 1e3,
        "busy_share": total_us / 1e3 / wall_unprofiled_ms,
        "busy_share_profiled": total_us / 1e3 / wall_ms,
        "device_ms_by_class": by_class,
        "unattributed_ms": total_us / 1e3 - sum(by_class.values()),
        "share_by_class": {k: v / (total_us / 1e3)
                           for k, v in by_class.items()},
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
        flush=True)
    context.shutdown()
    del b, params, state
    torch.cuda.empty_cache()


def _torch_batch_norm(self, x, train, updates=None):
    """``BatchNorm.forward`` through one ``F.batch_norm`` call (PyTorch's
    fused kernels; Welford statistics), the running statistics from one
    ``var_mean``: the yardstick of :func:`resnet_bn_yardstick`."""
    import torch.nn.functional as F
    from bluefog_tpu_torch.models.layers import nchw
    xf = x.float()
    if train and updates is not None:
        with torch.no_grad():
            var, mean = torch.var_mean(xf, (0, 1, 2), correction=0)
            updates[self.path] = {"mean": 0.9 * self.mean + 0.1 * mean,
                                  "var": 0.9 * self.var + 0.1 * var}
    running = (None, None) if train else (self.mean, self.var)
    return nchw(F.batch_norm, xf, *running, self.scale, self.bias,
                training=train, eps=self.epsilon)


def resnet_bn_yardstick(smi):
    """bench.py's case (1 rank x 64) with the port's ``BatchNorm`` (flax's
    formula as eager ops) and with :func:`_torch_batch_norm` in its place:
    each a bench run (5 timed calls) and a profiled call
    (:func:`profile_resnet`, labelled).  PyTorch's version is not the
    port's: it is what the library's fused batch norm costs (in the CPU
    tests its f32 error on ResNet34 in train mode is 2.7x flax's own,
    past their 2x floor, where flax's formula stays under it)."""
    from bluefog_tpu_torch.models import layers
    from bluefog_tpu_torch.parallel import context
    from bluefog_tpu_torch.tools import bench
    out = {}
    for name, fwd in (("port", layers.BatchNorm.forward),
                      ("torch_batch_norm", _torch_batch_norm)):
        with mock.patch.object(layers.BatchNorm, "forward", fwd):
            doc, b = bench.run(bench.parse(["--iters", "5"]))
            context.shutdown()
            del b
            torch.cuda.empty_cache()
            profile_resnet(smi, label=name)
        out[name] = {"img_per_s": doc["value"],
                     "per_step_s": doc["per_step_s"],
                     "loss_first": doc["loss_first"],
                     "loss_last": doc["loss_last"]}
    print("resnet_bn_yardstick " + json.dumps({
        "ranks": 1, "batch_per_rank": 64, "bench": out,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
        flush=True)


def resnet_phase(fa, gf, fd, smi, profile):
    """Phase 14: 14a parity, 14b bench.py's case, 14c four stacked ranks;
    K1-K4 launch nothing on this path."""
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    # the bench runs under torch's own TF32 defaults (14a's f32 pair
    # turns cuDNN's off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        _launch_counts(fa, gf, reset=True)
        fd.flash_decode_cuda.launches = 0
        parity = resnet_parity_phase(smi)
        bench1 = resnet_bench_phase(smi, "bench", RESNET_BENCH_ITERS)
        bench4 = resnet_bench_phase(smi, "bench_ranks4",
                                    ["--ranks", "4", "--batch", "16"]
                                    + RESNET_BENCH_ITERS)
        launches = dict(_launch_counts(fa, gf),
                        flash_decode=fd.flash_decode_cuda.launches)
        print("resnet_kernel_launches " + json.dumps(launches), flush=True)
        if any(launches.values()):
            raise AssertionError(f"the ResNet path launched {launches}")
        if profile:
            resnet_bn_yardstick(smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    return parity, bench1, bench4


# -- phase 15: the strategy benchmark --------------------------------

def strategy_bench_phase(smi, variant, iters):
    """15c: one variant of ``examples/benchmark.py`` at its defaults."""
    from bluefog_tpu_torch.examples import benchmark as ex
    from bluefog_tpu_torch.fusion import tree_flatten
    from bluefog_tpu_torch.parallel import context
    from bluefog_tpu_torch.tools import strategy_parity as sp
    args = ex.parse(sp.argv(variant, "--num-iters", str(iters)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = ex.run(args)
    leaves = tree_flatten(res["params"])[0]
    spread = 0.0
    for leaf in leaves:
        scale = float(leaf.abs().max())
        if scale:
            spread = max(spread, float((leaf - leaf[:1]).abs().max())
                         / scale)
    first = float(res["loss_first"].mean())
    last = float(res["loss_last"].mean())
    doc = {"variant": variant[0], "label": ex.label(args),
           "model": args.model, "ranks": args.ranks,
           "batch_per_rank": args.batch_size, "image_size": 224,
           "num_classes": 1000, "warmup": args.num_warmup, "iters": iters,
           "img_per_s": res["img_per_s"], "s_per_step": res["step_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "wire_bytes_per_rank_step": ex.wire_bytes_per_rank(
               args, res["params"], res["run"].schedules),
           "loss_first": first, "loss_last": last,
           "param_rank_spread_rel": spread,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("benchmark_strategy " + json.dumps(doc), flush=True)
    context.shutdown()
    del res, leaves
    torch.cuda.empty_cache()
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"{variant[0]}: the loss did not fall: "
                             f"{first} -> {last}")
    if spread > 1e-5:
        raise AssertionError(f"{variant[0]}: the ranks' parameters differ "
                             f"by {spread} x max|param| (same data, start)")
    return doc


# the depth of phase 15 (cut to make room for phase 21: parity
# 5 -> 3 steps, the example's timed iterations 10 / 3 -> 3 / 1)
STRATEGY_PARITY_STEPS = 3


def strategy_phase(fa, gf, fd, smi, default_iters=3, other_iters=1):
    """Phase 15: 15a codecs and 15b every strategy (card against CPU),
    15c the example at full width; K1-K4 launch nothing."""
    from bluefog_tpu_torch.tools import strategy_parity as sp
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _launch_counts(fa, gf, reset=True)
        fd.flash_decode_cuda.launches = 0
        t0 = time.monotonic()
        codecs = sp.codec_parity(DEV)
        print("codec_parity " + json.dumps(codecs), flush=True)
        sp.check_codecs(codecs)
        parity = sp.strategy_parity(DEV, steps=STRATEGY_PARITY_STEPS)
        parity["nvidia_smi"] = smi
        print("strategy_parity " + json.dumps(sp.flat_summary(parity)),
              flush=True)
        sp.check_strategies(parity)
        t_parity = time.monotonic() - t0
        # 15c under torch's own TF32 default for cuDNN, as phase 14
        torch.backends.cudnn.allow_tf32 = True
        docs = [strategy_bench_phase(
            smi, v, default_iters if v[0] == "awc" else other_iters)
            for v in sp.VARIANTS]
        launches = dict(_launch_counts(fa, gf),
                        flash_decode=fd.flash_decode_cuda.launches)
        print("strategy_kernel_launches " + json.dumps(launches),
              flush=True)
        if any(launches.values()):
            raise AssertionError(f"the strategy path launched {launches}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    return codecs, parity, docs, t_parity


def _clone_args(a, kw):
    """Detached copies of a call's tensor arguments (the rest as given)."""
    def c(x):
        return x.detach().clone() if torch.is_tensor(x) else x
    return tuple(c(x) for x in a), {k: c(v) for k, v in kw.items()}


def _capture_copy(store, key, fn, widest=False):
    """``fn`` passing through, a copy of its first call's arguments kept
    (``widest``: of the call whose first argument has the most rows), so
    a later in-place update cannot change them."""
    def call(*a, **kw):
        if key not in store or (widest and a[0].shape[0]
                                > store[key][0][0].shape[0]):
            store[key] = _clone_args(a, kw)
        return fn(*a, **kw)
    return call


def _capture_k4(store, fn):
    """``grouped_ffn`` passing through, copies kept of its first training
    call's arguments (under autograd: ``k4_train``, and the gradient that
    reaches that call's output: ``k4_train_g``) and of its first serving
    call's (``k4_serve``)."""
    def call(xt, eid, w1, w2, *a, **kw):
        train = torch.is_grad_enabled() and any(
            t.requires_grad for t in (xt, w1, w2))
        key = "k4_train" if train else "k4_serve"
        first = key not in store
        if first:
            store[key] = _clone_args((xt, eid, w1, w2) + a, kw)
        out = fn(xt, eid, w1, w2, *a, **kw)
        if first and train:
            def keep(g):
                store.setdefault("k4_train_g", g.detach().clone())
            out.register_hook(keep)
        return out
    return call


def _partial_f64(fa, q, k, v, q_offset=0, k_offset=0, *, causal=False,
                 scale=1.0, block_q=512, window=0):
    """K1's normalized output and row max evaluated in f64 (every row has
    a visible key on the estate's causal blocks at offset 0)."""
    G = q.shape[2] // k.shape[2]
    k, v = (x.double().repeat_interleave(G, dim=2) for x in (k, v))
    s = torch.einsum("bihd,bjhd->bihj", q.double() * scale, k)
    if causal:
        keep = fa._keep(q.shape[1], k.shape[1], int(q_offset),
                        int(k_offset), window, q.device)
        s = s.masked_fill(~keep[None, :, None, :], float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bihj,bjhd->bihd", p, v)
    return o / p.sum(dim=-1)[..., None], m


def _k12_checks(tag, fa, seen):
    """K1 and K2 held against their plain versions on one launch's
    captured inputs from a trainer (``seen["k1"]``, ``seen["k2"]``):
    phase 4's tolerances, K1's atols scaled by the trained inputs'
    magnitudes, both versions' distance from an f64 evaluation of K1
    printed beside (``<tag>_k1_accuracy``).  Returns the errors and
    shapes by kernel."""
    out = {}
    a, kw = seen["k1"]
    got = fa.attention_block_partial(*a, **kw)
    want = fa.attention_block_partial_plain(*a, **kw)
    # trained activations are far from unit scale: o/l's error scales
    # with |v| (a convex mix of v rows), m's with the score's own size;
    # both versions' distance from an f64 evaluation is kept beside
    wm = want[2]
    v_max = float(a[2].abs().max())
    m_max = float(wm[~torch.isneginf(wm)].abs().max())
    o64, m64 = _partial_f64(fa, *a, **kw)
    vs_f64 = {}
    for name, (o, l, m) in (("kernel", got), ("plain", want)):
        den = torch.where(l == 0, torch.ones_like(l), l)[..., None]
        vs_f64[name] = {"o": float((o / den - o64).abs().max()),
                        "m": float((m - m64).abs().max())}
    print(f"{tag}_k1_accuracy " + json.dumps(dict(
        q=list(a[0].shape), max_abs_v=v_max, max_abs_m=m_max,
        vs_f64=vs_f64)), flush=True)
    err = _check_partial(got, want, max(1.0, v_max), max(1.0, m_max))
    out["flash_fwd"] = {"q": list(a[0].shape), "max_abs_err": err,
                        "max_abs_v": v_max, "max_abs_m": m_max,
                        "vs_f64": vs_f64,
                        "tol": "o/l 1e-4 x max(1, max|v|) abs, l 1e-4 "
                               "rel, m 1e-5 x max(1, max|m|) abs"}
    a, kw = seen["k2"]
    got = fa.attention_block_backward(*a, **kw)
    want = fa.attention_block_backward_plain(*a, **kw)
    worst = 0.0
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        err, ok = _grad_err(x, y)
        worst = max(worst, err)
        if not ok:
            raise AssertionError(f"{tag}: the trainer's flash_bwd {name} "
                                 f"disagrees with its plain version: {err}")
    out["flash_bwd"] = {"q": list(a[0].shape), "max_abs_err": worst,
                        "tol": "1e-4 x max|plain| + 1e-6"}
    return out


def _estate_kernel_checks(tag, fa, fd, gf, kv, seen, moe):
    """Each kernel of the estate held against its plain version on one
    launch's captured inputs, at the shapes this path gives it: K1 and K2
    from the trainer (phase 4's tolerances, K1's atols scaled by the
    trained inputs' magnitudes), K3 from the replay's widest
    decode call (atol 1e-4), and in 16b K4 from the engine (1e-4 x
    max|plain|) and K4 with its backward from the trainer, on the
    gradient that reached that call (out, dxt, dw1, dw2 within 1e-4 x
    max|plain|, the per-expert plain version under autograd).  Returns
    the errors and shapes by kernel."""
    out = _k12_checks(tag, fa, seen)
    a, kw = seen["k3"]
    q, kl, vl, slots, lens = a
    pre = {k: kw[k] for k in ("prefix_slots", "prefix_lens", "k_scale",
                              "v_scale") if kw.get(k) is not None}
    got = fd.flash_attend_rows(q, kl, vl, slots, lens,
                               block_k=kw["block_k"], **pre)
    want = kv.attend_rows(q, kl, vl, slots, lens, **pre)
    err = float((got - want).abs().max())
    if not (err <= 1e-4 and bool(torch.isfinite(got).all())):
        raise AssertionError(f"{tag}: the replay's widest flash decode "
                             f"disagrees with its plain version: {err}")
    out["flash_decode"] = {"q": list(q.shape), "max_abs_err": err,
                           "tol": "1e-4 abs"}
    if not moe:
        return out
    a, kw = seen["k4_serve"]
    xt, eid = a[0], a[1]
    got = gf.grouped_ffn(*a, **kw)
    want = gf.grouped_ffn_plain(*a, **kw)
    err, top = float((got - want).abs().max()), float(want.abs().max())
    if not (err <= 1e-4 * top and bool(torch.isfinite(got).all())
            and bool((got[eid < 0] == 0).all())):
        raise AssertionError(f"{tag}: the engine's grouped_ffn disagrees "
                             f"with its plain version: {err} (1e-4 x "
                             f"max|plain| = {1e-4 * top})")
    out["grouped_ffn_serve"] = {"xt": list(xt.shape), "max_abs_err": err,
                                "tol": "1e-4 x max|plain|"}
    out.update(_k4_train_checks(tag, gf, seen))
    return out


def _k4_train_checks(tag, gf, seen):
    """K4 and its backward from a trainer held against the per-expert
    plain version under autograd, on the first training call's captured
    inputs and the gradient that reached its output (``seen["k4_train"]``,
    ``seen["k4_train_g"]``; out, dxt, dw1, dw2 within 1e-4 x max|plain|);
    the backward launches its plan, dgrad and wgrad once each."""
    out = {}
    if "k4_train_g" not in seen:
        raise AssertionError(f"{tag}: no gradient reached the trainer's "
                             "first grouped_ffn call")
    (xt, eid, w1, w2, *rest), kw = seen["k4_train"]
    g = seen["k4_train_g"]

    def run(fn):
        x, p, r = (t.detach().requires_grad_() for t in (xt, w1, w2))
        y = fn(x, eid, p, r, *rest, **kw)
        return (y.detach(),) + torch.autograd.grad(y, (x, p, r), g)
    before = (gf.grouped_ffn_dgrad_cuda.launches,
              gf.grouped_ffn_wgrad_cuda.launches,
              gf.backward_plan_cuda.launches)
    got = run(gf.grouped_ffn)
    if (gf.grouped_ffn_dgrad_cuda.launches - before[0],
            gf.grouped_ffn_wgrad_cuda.launches - before[1],
            gf.backward_plan_cuda.launches - before[2]) != (1, 1, 1):
        raise AssertionError(f"{tag}: the trainer's grouped_ffn backward "
                             "did not launch its plan, dgrad and wgrad "
                             "once each")
    want = run(gf.grouped_ffn_plain_by_expert)
    errs = {}
    for name, x, y in zip(("out", "dxt", "dw1", "dw2"), got, want):
        err, top = float((x - y).abs().max()), float(y.abs().max())
        errs[name] = err
        if not (err <= 1e-4 * top and bool(torch.isfinite(x).all())):
            raise AssertionError(
                f"{tag}: the trainer's grouped_ffn {name} disagrees with "
                f"the per-expert plain version: {err} (1e-4 x max|plain| "
                f"= {1e-4 * top})")
    out["grouped_ffn_train"] = {"xt": list(xt.shape),
                                "max_abs_err": errs["out"],
                                "tol": "1e-4 x max|plain|"}
    out["grouped_ffn_backward_train"] = {
        "xt": list(xt.shape),
        "max_abs_err": max(errs["dxt"], errs["dw1"], errs["dw2"]),
        "tol": "1e-4 x max|plain| for each of dxt, dw1, dw2"}
    return out


def estate_phase(fa, fd, gf, layers_mod, smi, moe):
    """Phase 16a (dense) / 16b (``--serve-moe 8x2@2``): the train->serve
    estate of ``tools/serve_bench.py`` at its full widths (vocab 32768,
    d_model 1024, 16 heads, 4 layers, seq 128), ``--train-dp 2
    --serve-dp 2 --pp 2`` (the JAX tool's Run line), slots 8, max_len 64,
    2 steps a call, 16 requests of 8 new tokens, 6 train steps with Adam
    at 5e-3, ``--refresh-every 2``, then ``--traffic-trace flash-crowd``
    (24 steps), through ``serve_bench.run``.

    Gates: the tool's ``ok`` (every request completes, none fails, the
    cache written in place, the trace phase grows the parked replica,
    recovers within 2 x steps and writes the scale file in ranks);
    ``pulls >= 2`` and staleness 0 after each pull; after the last pull
    every served tensor (MoE: the router and both expert tables too)
    equals the training replicas' mean at its slice offset to 1e-6 x the
    tensor's largest magnitude; the launches over the drain and over the
    trace phase equal the formulas (per train step K1 = K2 = train dp x
    (micro + pp - 1) x layers / pp, and MoE K4 / dgrad / wgrad / plan as
    many; K3 = layers x decode steps; the engine's K4 = layers x
    (prefills + decode steps)); the drain's prompts drained again with
    K3 and with K3's plain version on the last pulled weights (the same
    admissions, so the drain's decode buckets) give the same streams up
    to near ties; :func:`_estate_kernel_checks` on one launch of each
    kernel from this path.  Returns the summary and the phase's launches
    by kernel."""
    import contextlib
    import io
    from bluefog_tpu_torch.serve import Scheduler, refresh
    from bluefog_tpu_torch.serve import kv_cache as kv
    from bluefog_tpu_torch.tools import serve_bench
    tag = "serve_estate_moe" if moe else "serve_estate"
    argv = ["--train-dp", "2", "--serve-dp", "2", "--pp", "2",
            "--refresh-every", "2", "--traffic-trace", "flash-crowd"]
    if moe:
        argv += ["--serve-moe", "8x2@2"]
    pulled = {}
    orig_pull = refresh.WeightRefresher.pull

    def pull(self, train_params, train_step=None):
        pulled["tree"] = {g: {k: v.detach().clone() for k, v in
                              leaves.items()}
                          for g, leaves in train_params.items()}
        return orig_pull(self, train_params, train_step)

    out = io.StringIO()       # the tool's own JSON line: gated, summarized
    seen = {}                 # one launch's inputs of each kernel, copied
    fd.flash_decode_cuda.launches = 0
    _launch_counts(fa, gf, reset=True)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            refresh.WeightRefresher, "pull", pull))
        stack.enter_context(mock.patch.object(
            fa, "attention_block_partial",
            _capture_copy(seen, "k1", fa.attention_block_partial)))
        stack.enter_context(mock.patch.object(
            fa, "attention_block_backward",
            _capture_copy(seen, "k2", fa.attention_block_backward)))
        if moe:
            routed = stack.enter_context(_k4_route_tally(gf))
            stack.enter_context(mock.patch.object(
                gf, "grouped_ffn", _capture_k4(seen, gf.grouped_ffn)))
        stack.enter_context(contextlib.redirect_stdout(out))
        doc, st = serve_bench.run(argv)
    torch.cuda.synchronize()
    whole = dict(_launch_counts(fa, gf),
                 flash_decode=fd.flash_decode_cuda.launches)
    if moe:                   # the trainer's forwards and the engine's
        _gate_k4_routes(tag, gf, routed)
    if not doc["ok"]:
        raise AssertionError(f"{tag}: serve_bench not ok: requests "
                             f"{doc['requests']}, trace {doc['trace']}, "
                             f"invariants {doc['invariants']}, refresh "
                             f"{doc['refresh']}")
    ref = doc["refresh"]
    if ref["pulls"] < 2 or any(v != 0 for v in
                               ref["staleness_after_each_pull"]):
        raise AssertionError(f"{tag}: want >= 2 pulls, each leaving "
                             f"staleness 0: {ref}")
    trace = doc["trace"]
    if (trace["failed"] or trace["grow_step"] is None
            or trace["scale_file_target"]
            != trace["expected_world"]
            or trace["expected_world"] % trace["ranks_per_replica"]):
        raise AssertionError(f"{tag}: trace phase {trace}")

    # the served weights = the training replicas' mean at their offset
    eng, cfg, tm, sm = st["engine"], st["cfg"], st["train_m"], st["serve_m"]
    mean_tree = {}
    for g, leaves in pulled["tree"].items():
        mean_tree[g] = {}
        for k, t in leaves.items():
            mean = t.reshape((tm.dp, tm.slice_size) + t.shape[1:]).mean(0)
            mean_tree[g][k] = torch.cat([mean] * sm.dp)
    if moe:
        from bluefog_tpu_torch.moe.model import moe_params_from_jax as load
    else:
        from bluefog_tpu_torch.parallel.compose import params_from_jax \
            as load
    want = load(mean_tree, cfg, m=sm)
    weight_err, names = 0.0, set()
    for (name, got), (_, exp) in zip(eng.params.tensors(), want.tensors()):
        err = float((got - exp).abs().max() / exp.abs().max())
        weight_err = max(weight_err, err)
        names.add(name.split("[")[0])
        if err > 1e-6:
            raise AssertionError(f"{tag}: served {name} differs from the "
                                 f"training mean by {err} of its max")
    need = {"embed", "head", "wqkv", "wo"} | (
        {"wr", "w1e", "w2e"} if moe else {"w1", "w2"})
    if not need <= names:
        raise AssertionError(f"{tag}: compared {names}, want {need}")

    # the launch formulas, over the drain and the trace phase
    L, pp, mic = cfg.layers, 2, cfg.micro
    per_step = tm.dp * (mic + pp - 1) * (L // pp)
    gates = {}
    for part in ("drain", "trace"):
        got, ev = (doc["kernels"][part]["launches"],
                   doc["kernels"][part]["events"])
        want_n = {"flash_fwd": per_step * ev["train_steps"],
                  "flash_bwd": per_step * ev["train_steps"],
                  "flash_decode": L * ev["decode_steps"]}
        if moe:
            train_k4 = per_step * ev["train_steps"]
            want_n.update(
                grouped_ffn=train_k4 + L * (ev["prefills"]
                                            + ev["decode_steps"]),
                grouped_ffn_dgrad=train_k4, grouped_ffn_wgrad=train_k4,
                grouped_ffn_backward_plan=train_k4)
        bad = {k: (got[k], v) for k, v in want_n.items() if got[k] != v}
        if bad or not got["flash_decode"]:
            raise AssertionError(f"{tag} {part}: launches (got, want) "
                                 f"{bad}, events {ev}")
        gates[part] = {"launches": {k: got[k] for k in want_n},
                       "events": ev}
    zero = [k for k, v in whole.items()      # forward_gemm: by the shapes
            if not v and (moe or not k.startswith("grouped"))
            and k != "grouped_ffn_forward_gemm"]
    if zero:
        raise AssertionError(f"{tag}: kernels never launched: {zero}")

    # the drain's prompts again, K3 against its plain version: the same
    # admissions, so the same decode buckets as the drain
    prompts = [r.prompt for r in st["requests"]]
    max_new = doc["requests"]["max_new_tokens"]

    def drain():
        sched = Scheduler(eng)
        reqs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
        sched.drain()
        sched.close()
        return reqs
    before = fd.flash_decode_cuda.launches
    with mock.patch.object(fd, "flash_attend_rows", _capture_copy(
            seen, "k3", fd.flash_attend_rows, widest=True)):
        got = drain()
    if fd.flash_decode_cuda.launches == before:
        raise AssertionError(f"{tag}: the kernel replay launched no K3")
    before = fd.flash_decode_cuda.launches
    with serve_bench.plain_decode_attention():
        plain = drain()
    if fd.flash_decode_cuda.launches != before:
        raise AssertionError(f"{tag}: the plain replay launched K3")
    if any(a.replica != b.replica for a, b in zip(got, plain)):
        raise AssertionError(f"{tag}: the two replays admitted a request "
                             "to different replicas")
    diverged = []
    for r in sorted({q.replica for q in got}):
        model = eng.params.replica(r)
        pairs = [(a, b) for a, b in zip(got, plain) if a.replica == r]
        diverged += _stream_gate(
            f"{tag} replay", model, [a for a, _ in pairs],
            [b for _, b in pairs], layers_mod if moe else None,
            cfg.top_k if moe else None)
        del model
    kernel_checks = _estate_kernel_checks(tag, fa, fd, gf, kv, seen, moe)
    del seen

    lat, mfu = doc["latency"], doc["mfu"]
    summary = {
        "run": tag, "carving": "train dp 2 x pp 2, serve dp 2 x pp 2"
        + (" (x ep 2, 8 experts top-2)" if moe else ""),
        "tokens_per_s_while_training": doc["tokens_per_sec"],
        "per_token_p50_s": lat["per_token_p50_s"],
        "per_token_p99_s": lat["per_token_p99_s"],
        "ttft_p50_s": lat["ttft_p50_s"], "ttft_p99_s": lat["ttft_p99_s"],
        "decode_mfu": mfu["mfu"], "mfu_rate": mfu["peak_name"],
        "decode_flops_per_token": mfu["decode_flops_per_token"],
        "staleness_max_steps": ref["staleness_max_steps"],
        "staleness_final_steps": ref["staleness_final_steps"],
        "pulls": ref["pulls"], "train_s_per_step": doc["train"]["s_per_step"],
        "wall_s": doc["wall_s"],
        "peak_memory_gb": (doc["memory"]["peak_bytes"] or 0) / 1e9,
        "weights_vs_training_mean_rel_err": weight_err,
        "launches": {"phase": whole, **gates},
        "launch_formulas": "per train step K1 = K2 = train dp x (micro + pp "
                           "- 1) x layers / pp (MoE: K4, dgrad, wgrad, plan "
                           "as many); K3 = layers x decode steps; engine K4 "
                           "= layers x (prefills + decode steps)",
        "replay_diverged": diverged, "replay_requests": len(prompts),
        "kernel_checks": kernel_checks,
        "trace": {k: trace[k] for k in (
            "shape", "steps", "submitted", "completed", "failed", "requeued",
            "grow_step", "recovery_steps", "recovery_bound_steps",
            "scale_file_target", "expected_world", "ranks_per_replica",
            "ok")},
        "trace_scale_events": [(e["action"], e["step"], e["target_world"])
                               for e in trace["scale_events"]],
        "latency_breakdown": {k: (doc["latency_breakdown"] or {}).get(k)
                              for k in ("queue_mean_s", "prefill_mean_s",
                                        "decode_mean_s", "gap_mean_s")},
        "device": torch.cuda.get_device_name(0), "smi": smi}
    if moe:
        wire = doc["moe"]["wire"]
        if wire["dcn_bytes"] or not wire["ici"].get("all_to_all"):
            raise AssertionError(f"{tag}: the decode's wire proof {wire}")
        summary["moe_decode_wire"] = {k: wire[k] for k in (
            "ici", "dcn", "ici_bytes", "dcn_bytes", "ici_dtypes")}
        summary["tokens_per_s_moe_probe"] = doc["moe"]["tokens_per_sec_moe"]
        summary["tokens_per_s_dense_twin"] = \
            doc["moe"]["tokens_per_sec_dense_twin"]
    print(tag + " " + json.dumps(summary), flush=True)
    del st, eng, want, mean_tree, pulled
    torch.cuda.empty_cache()
    return summary, whole


AT_RANKS = 8                  # 23a-b: ResNet-50's tree over 8 stacked ranks
AT_TRIALS = 3                 # 23a: the battery's --trials auto
AT_BENCH = ["--ranks", "8", "--batch", "16", "--iters", "2"]   # 23b
AT_MICRO = 4                  # 23c dense: lm_bench's micro 8 cut to 12b's


class _StreamRng:
    """``np.random.default_rng(seed)`` for 23c's inits: ``normal`` hands
    out the next slice of one f32 standard-normal stream a seed, drawn on
    the card in chunks as the inits ask for more (numpy's f64 draw takes
    ~25 ns a sample on the host: ~9 s for each MoE carving at these
    widths); ``integers`` (the batches) is the real generator's."""
    streams = {}
    CHUNK = 1 << 26

    def __init__(self, seed=None):
        self.real, self.seed, self.at = _REAL_RNG(seed), seed, 0

    def normal(self, loc=0.0, scale=1.0, size=None):
        n = int(np.prod(size))
        stream, gen = self.streams.get(self.seed, (None, None))
        if gen is None:
            gen = torch.Generator(device=DEV).manual_seed(int(self.seed or 0))
            stream = np.empty(0, np.float32)
        if len(stream) < self.at + n:
            more = -(-(self.at + n - len(stream)) // self.CHUNK) * self.CHUNK
            stream = np.concatenate([stream, torch.randn(
                more, generator=gen, device=DEV).cpu().numpy()])
            stream.flags.writeable = False     # callers get views of it
        self.streams[self.seed] = (stream, gen)
        out = stream[self.at:self.at + n].reshape(size)
        self.at += n
        return out if (loc, scale) == (0.0, 1.0) else out * scale + loc

    def __getattr__(self, name):
        return getattr(self.real, name)


_REAL_RNG = np.random.default_rng


def _at_tree():
    """ResNet-50's ``{"params", "bs"}`` tree, the one ``tools/bench.py``
    trains (224 x 224, 1000 classes, seed 0)."""
    from bluefog_tpu_torch.models import ResNet50
    v = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0)).variables()
    return {"params": v["params"], "bs": v["batch_stats"]}


def _at_strategy(smi, scratch):
    """23a: ``autotune(params=ResNet-50's tree, trials=3)`` over 8 stacked
    ranks, the full default space, banked into ``scratch``; then twice
    at ``trials=0`` on that bank.  Gates: no probe failed (every
    rejection is a contract's); the trialled keys read ``banked`` in
    both repeats, which are byte-identical; the winner's bytes are its
    audit row's.  Returns the repeat's plan."""
    from bluefog_tpu_torch.autotune import autotune
    from bluefog_tpu_torch.fusion import tree_flatten
    from bluefog_tpu_torch.parallel import context
    tree = _at_tree()
    context.init(size=AT_RANKS, device=DEV)
    t0 = time.monotonic()
    first = autotune(params=tree, trials=AT_TRIALS, measured_dir=scratch)
    torch.cuda.synchronize()
    t_first = time.monotonic() - t0
    trialled = [e["key"] for e in first.doc["audit"]["scored"]
                if e["evidence"] == "trial"]
    t0 = time.monotonic()
    again = [autotune(params=tree, trials=0, measured_dir=scratch)
             for _ in range(2)]
    t_again = time.monotonic() - t0
    context.shutdown()
    doc = again[0].doc
    audit = doc["audit"]
    failed = [r for r in first.doc["audit"]["rejected"] + audit["rejected"]
              if r["reason"].startswith("probe failed")]
    if failed or len(trialled) != AT_TRIALS:
        raise AssertionError(f"23a: probes failed {failed[:3]} or trials "
                             f"{trialled} (want {AT_TRIALS})")
    ev = {e["key"]: e["evidence"] for e in audit["scored"]}
    if any(ev[k] != "banked" for k in trialled):
        raise AssertionError(f"23a: the trialled keys read "
                             f"{[ev[k] for k in trialled]}, want banked")
    if again[0].to_json() != again[1].to_json():
        raise AssertionError("23a: two trials=0 tunes differ")
    win = audit["scored"][0]
    if win["wire_bytes_per_step_per_chip"] != \
            doc["predicted"]["wire_bytes_per_step_per_chip"]:
        raise AssertionError("23a: the winner's bytes are not its row's")
    n_params = sum(x.numel() for x in tree_flatten(tree)[0])
    summary = {
        "ranks": AT_RANKS, "tree_leaves": len(tree_flatten(tree)[0]),
        "tree_params": n_params, "trials": AT_TRIALS,
        "considered": audit["considered"], "scored": len(audit["scored"]),
        "rejected": len(audit["rejected"]),
        "groups_probed": len({"|".join(e["key"].split("|")[:4])
                              for e in audit["scored"]}),
        "winner": doc["config"], "plan_id": doc["plan_id"],
        "winner_bytes_per_step_per_chip":
            doc["predicted"]["wire_bytes_per_step_per_chip"],
        "winner_step_s": doc["predicted"]["step_time_s"],
        "winner_evidence": doc["predicted"]["evidence"],
        "trials_s_per_step": {e["key"]: e["step_time_s"]
                              for e in first.doc["audit"]["scored"]
                              if e["evidence"] == "trial"},
        "trialled_analytic_s": _at_analytic(first, trialled),
        "repeat_identical": True, "seconds_first": t_first,
        "seconds_two_repeats": t_again,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("autotune " + json.dumps(summary), flush=True)
    return again[0], summary


def _at_analytic(plan, keys):
    """The analytic pseudo-seconds of the trialled keys (what the trials
    replaced), from their audit rows' bytes."""
    from bluefog_tpu_torch.autotune import cost_model as cm
    from bluefog_tpu_torch.autotune import enumerate_candidates
    n = plan.doc["n_chips"]
    cands = {c.key: c for c in enumerate_candidates(n)[0]}
    return {e["key"]: cm.predicted_step_time_s(
        cands[e["key"]], e["wire_bytes_per_step_per_chip"],
        cm.num_schedule_rounds(cands[e["key"]], n))
        for e in plan.doc["audit"]["scored"] if e["key"] in keys}


def _at_bench(plan, smi, scratch):
    """23b: ``plan.apply()`` through ``tools/bench.py --plan`` on ResNet-50
    over 8 ranks (the plan's fused-k steps a call, 2 timed calls): the
    artifact names the plan, the loss is finite; a plan tuned for 4
    ranks is refused with bench.py's text."""
    from bluefog_tpu_torch.autotune.plan import make_plan_doc
    from bluefog_tpu_torch.parallel import context
    from bluefog_tpu_torch.tools import bench
    path = plan.save(os.path.join(scratch, "plan.json"))
    t0 = time.monotonic()
    doc, b = bench.run(bench.parse(AT_BENCH + ["--plan", path]))
    seconds = time.monotonic() - t0
    context.shutdown()
    del b
    torch.cuda.empty_cache()
    if not (doc["plan_id"] == plan.plan_id
            and doc["config_source"] == "plan:" + plan.plan_id
            and doc["algorithm"] == plan.algorithm
            and doc["steps_per_call"] == plan.config["fused_k"]
            and np.isfinite(doc["loss_last"])):
        raise AssertionError(f"23b: the replay's artifact {doc}")
    four = make_plan_doc(
        config={"algorithm": "neighbor_cta",
                "topology": {"family": "exp2", "size": 4}, "wire": None,
                "weights": "recv", "fused_k": 1, "delayed": False,
                "concurrent": None},
        objective="step_time", n_chips=4, device_kind=doc["device"],
        predicted={}, audit={})
    p4 = os.path.join(scratch, "plan4.json")
    with open(p4, "w") as f:
        json.dump(four, f)
    try:
        bench.run(bench.parse(AT_BENCH + ["--plan", p4]))
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("23b: a plan for 4 ranks was not refused")
    finally:
        context.shutdown()
    if "re-tune on this mesh" not in refused:
        raise AssertionError(f"23b: the refusal reads {refused!r}")
    summary = {"plan_id": doc["plan_id"], "algorithm": doc["algorithm"],
               "config": plan.config, "img_per_s": doc["value"],
               "per_step_s": doc["per_step_s"],
               "steps_per_call": doc["steps_per_call"],
               "batch_per_rank": doc["batch_per_rank"],
               "ranks": doc["n_ranks"], "loss": [doc["loss_first"],
                                                 doc["loss_last"]],
               "peak_mem_gb": doc["peak_mem_gb"], "seconds": seconds,
               "refused_4_rank_plan": refused,
               "device": doc["device"], "nvidia_smi": smi}
    print("autotune_bench " + json.dumps(summary), flush=True)
    return summary


def _dense_carvings():
    """23c's dense list: every 8-chip carving with pp, tp, sp <= 2 and no
    expert axis, and (2, 2, 1, 1, 4) for the size rejection."""
    from bluefog_tpu_torch.autotune import enumerate_carvings
    acc, rej = enumerate_carvings(8, max_pp=2, max_tp=2, max_sp=2,
                                  max_ep=1)
    return [tuple(c) for c in acc] + [tuple(r["config"].values())
                                      for r in rej] + [(2, 2, 1, 1, 4)]


MOE_CARVINGS = [(2, 2, 1, 1, 2), (2, 2, 2, 1, 1), (4, 2, 1, 1, 1),
                (1, 2, 2, 2, 1), (2, 2, 1, 1, 4)]    # tests/test_moe.py:381


def _at_carving(fa, gf, smi):
    """23c: ``tune_carving`` at lm_bench's dense widths (vocab 32768,
    d_model 1024, 16 heads, 4 layers, seq 2048, batch 4; micro 4, not
    lm_bench's 8, as 12b's) over :func:`_dense_carvings`, then at phase
    12b's MoE config (lm_bench ``--moe``'s widths, 8 experts top-2, micro
    4) over JAX's list, both dispatch schemes.  Each carving's one real
    step: its DCN / ICI bytes, DCN dtypes, the step's seconds
    (synchronized), the carving's with its init, and peak memory.  Gates:
    the
    audited rejections are the contract's (dp 1, the size, no step
    failed); every scored carving's DCN bytes are positive and bf16; the
    winner is a dp-2 carving below every dp-4 one; K1/K2 launch dp x
    (micro + pp - 1) x layers / pp a carving (K4 and its backward as many
    on the dropless MoE runs, none on the capacity ones); K1/K2 and K4
    with its backward held against their plain versions on one captured
    launch each."""
    import dataclasses
    from bluefog_tpu_torch.autotune import cost_model as cm
    from bluefog_tpu_torch.autotune import tune_carving
    from bluefog_tpu_torch.fusion import tree_map
    from bluefog_tpu_torch.moe import model as moe_model
    from bluefog_tpu_torch.parallel import compose, context
    real = cm.carving_wire_bytes
    rows, at = {}, {}

    def timed(carve, cfg, **kw):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = _launch_counts(fa, gf)
        t0 = time.monotonic()
        stats = real(carve, cfg, **kw)
        torch.cuda.synchronize()
        after = _launch_counts(fa, gf)
        mode = getattr(cfg, "dispatch", None)
        rows[at["tag"] + ":" + carve.key + (
            "" if mode in (None, "capacity") else f"|disp={mode}")] = {
            "dcn_bytes": stats["dcn_bytes"], "ici_bytes": stats["ici_bytes"],
            "dcn_dtypes": stats["dcn_dtypes"],
            "ici": stats["ici"], "dcn": stats["dcn"],
            "step_s": at.pop("step_s"), "seconds": time.monotonic() - t0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: after[k] - before[k] for k in after}}
        return stats

    dense = compose.LMConfig(vocab=32768, d_model=1024, heads=16, layers=4,
                             seq_len=2048, micro=AT_MICRO, batch=4)
    moe = _moe_cfg()
    seen, plans, seconds = {}, {}, {}
    real_moe_init, kept = moe_model.init_moe_train_params, {}

    def moe_init(cfg, m, *a, **kw):
        """A carving's MoE params once for both dispatch schemes (their
        weights do not depend on it): a host copy is kept, and the second
        run gets it back on the card (the step updates its params in
        place; a copy on the card beside them took ~5.6 GB at dp 4)."""
        key = (m.dp, m.pp, m.tp, m.sp, m.ep, a, tuple(sorted(kw.items())))
        if key in kept:
            return tree_map(lambda t: t.to(m.device), kept[key])
        kept.clear()
        params = real_moe_init(cfg, m, *a, **kw)
        kept[key] = tree_map(lambda t: t.cpu(), params)
        return params

    real_step = compose.make_train_step

    def make_step(*a, **kw):
        """The carving's step, timed between synchronizations."""
        step, strategy = real_step(*a, **kw)

        def timed(*sa):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = step(*sa)
            torch.cuda.synchronize()
            at["step_s"] = time.monotonic() - t0
            return out
        return timed, strategy
    context.init(size=8, device=DEV)
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(cm, "carving_wire_bytes",
                                                  timed))
            stack.enter_context(mock.patch.object(np.random, "default_rng",
                                                  _StreamRng))
            stack.enter_context(mock.patch.object(
                moe_model, "init_moe_train_params", moe_init))
            stack.enter_context(mock.patch.object(
                compose, "make_train_step", make_step))
            stack.enter_context(mock.patch.object(
                fa, "attention_block_partial",
                _capture_copy(seen, "k1", fa.attention_block_partial)))
            stack.enter_context(mock.patch.object(
                fa, "attention_block_backward",
                _capture_copy(seen, "k2", fa.attention_block_backward)))
            stack.enter_context(mock.patch.object(
                gf, "grouped_ffn", _capture_k4(seen, gf.grouped_ffn)))
            for tag, cfg, carvings in (("dense", dense, _dense_carvings()),
                                       ("moe", moe, MOE_CARVINGS)):
                t0, at["tag"] = time.monotonic(), tag
                plans[tag] = tune_carving(cfg, wire="bf16",
                                          carvings=carvings)
                seconds[tag] = time.monotonic() - t0
    finally:
        context.shutdown()
        _StreamRng.streams.clear()
        kept.clear()
        torch.cuda.empty_cache()
    checks = _k12_checks("carving_tuner", fa, seen)
    checks.update(_k4_train_checks("carving_tuner", gf, seen))
    launches = {k: 0 for k in _launch_counts(fa, gf)}
    for key, row in rows.items():
        carve = dict(p.split("=") for p in key.split("|")[1:6])
        dp, pp = int(carve["dp"]), int(carve["pp"])
        cfg = moe if key.startswith("moe:") else dense
        n = dp * (cfg.micro + pp - 1) * (cfg.layers // pp)
        k4 = n if key.endswith("|disp=dropless") else 0
        want = {"flash_fwd": n, "flash_bwd": n, "grouped_ffn": k4,
                "grouped_ffn_forward_gemm": k4, "grouped_ffn_dgrad": k4,
                "grouped_ffn_wgrad": k4, "grouped_ffn_backward_plan": k4}
        if row["launches"] != want:
            raise AssertionError(f"23c {key}: launches {row['launches']}, "
                                 f"want {want}")
        for k, v in row["launches"].items():
            launches[k] += v
    for tag, plan in plans.items():
        rejected = {r["key"]: r["reason"] for r in plan["audit"]["rejected"]}
        want_rej = {"carve|dp=1|pp=2|tp=2|sp=2|ep=1":
                    "carving_no_gossip_axis",
                    "carve|dp=2|pp=2|tp=1|sp=1|ep=4":
                    "carving_size_mismatch"}
        if {k: v.split(":")[0] for k, v in rejected.items()} != want_rej:
            raise AssertionError(f"23c {tag}: rejections {rejected}")
        best = plan["best"]
        dp4 = [e["dcn_bytes"] for e in plan["audit"]["scored"]
               if "|dp=4|" in e["key"]]
        if not (best["config"]["dp"] == 2 and best["dcn_dtypes"] == ["bf16"]
                and all(d > best["dcn_bytes_per_step_per_chip"]
                        for d in dp4)
                and all(e["dcn_bytes"] > 0
                        for e in plan["audit"]["scored"])):
            raise AssertionError(f"23c {tag}: best {best}, dp-4 {dp4}")
    for key, row in rows.items():
        if row["dcn_dtypes"] != ["bf16"]:
            raise AssertionError(f"23c {key}: DCN dtypes {row['dcn_dtypes']}")
    summary = {
        "dense": {"config": dataclasses.asdict(dense),
                  "best": plans["dense"]["best"]},
        "moe": {"config": dataclasses.asdict(moe),
                "best": plans["moe"]["best"]},
        "rejected": {t: plans[t]["audit"]["rejected"] for t in plans},
        "carvings": rows, "seconds": seconds, "launches": launches,
        "kernel_checks": checks,
        "init": "weights from one f32 normal stream a seed (_StreamRng); "
                "a MoE carving's params once for both dispatch schemes",
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("carving_tuner " + json.dumps(summary), flush=True)
    return summary


def autotune_phase(fa, gf, smi):
    """Phase 23: the autotuner (23a strategy plans at ResNet-50's width,
    23b their replay through tools/bench.py, 23c carving plans at
    lm_bench's dense and MoE widths).  Returns (the launches by kernel,
    seconds by leg)."""
    import tempfile
    seconds = {}
    with tempfile.TemporaryDirectory() as scratch:
        t0 = time.monotonic()
        plan, _ = _at_strategy(smi, scratch)
        seconds["strategy"] = time.monotonic() - t0
        t0 = time.monotonic()
        _at_bench(plan, smi, scratch)
        seconds["bench"] = time.monotonic() - t0
    t0 = time.monotonic()
    carving = _at_carving(fa, gf, smi)
    seconds["carving"] = time.monotonic() - t0
    return carving["launches"], seconds


# -- phase 24: the trace's compute/comm split, step_sweep, the notebooks ---

# 24a: lm_bench at its default carving and width; 2 warm-up steps and 3
# timed, one step a call; K1/K2 launches dp x (micro + pp - 1) x layers /
# pp a step
OV_ARGV = ["--iters", "3", "--steps-per-call", "1", "--no-sweep"]
OV_LAUNCHES = 5 * 2 * (8 + 2 - 1) * 4 // 2
# 24b: the ResNet-50 sweep over 4 gossiping ranks
SW_ARGV = ["--ranks", "4", "--batch", "16", "--sweep", "1,5", "--iters",
           "2"]
NOTEBOOKS = ("interactive_helloworld", "resource_allocation")


def _ov_lm_bench(fa, gf, smi):
    """24a: lm_bench with its trace on; its gates, K1/K2 against their
    plain versions on one captured launch."""
    import io
    from bluefog_tpu_torch.tools import lm_bench
    seen = {}
    _launch_counts(fa, gf, reset=True)
    with mock.patch.object(
            fa, "attention_block_partial",
            _capture_copy(seen, "k1", fa.attention_block_partial)), \
            mock.patch.object(
                fa, "attention_block_backward",
                _capture_copy(seen, "k2", fa.attention_block_backward)), \
            contextlib.redirect_stdout(io.StringIO()):
        doc = lm_bench.main(OV_ARGV)
    torch.cuda.synchronize()
    n = _launch_counts(fa, gf)
    ov = doc["overlap"]
    if not doc["ok"] or ov is None:
        raise AssertionError(f"24a: lm_bench not ok: {doc.get('losses')} "
                             f"{doc['invariants']} "
                             f"{doc.get('overlap_error')}")
    if (n["flash_fwd"], n["flash_bwd"]) != (OV_LAUNCHES, OV_LAUNCHES):
        raise AssertionError(f"24a: K1/K2 launched {n}, want {OV_LAUNCHES} "
                             "each")
    names = [r["name"] for r in ov["top_exposed_comm_ops"]]
    if not (ov["comm_ms"] > 0 and "bluefog::psum" in names
            and "bluefog::neighbor_allreduce" in names
            and ov["busy_ms"] <= ov["wall_ms"]):
        raise AssertionError(f"24a: the overlap block {ov}")
    kernels = _k12_checks("lm_bench_overlap", fa, seen)
    row = {"mesh": doc["mesh"], "config": doc["config"],
           "per_step_s": doc["per_step_s"],
           "tokens_per_sec": doc["tokens_per_sec"],
           "peak_mem_gb": doc["peak_mem_gb"], "losses": doc["losses"],
           "overlap": ov, "invariants": doc["invariants"],
           "flash_launches": n["flash_fwd"], "kernels": kernels,
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("overlap " + json.dumps(row), flush=True)
    return n, row


def _ov_step_sweep(smi, scratch):
    """24b: step_sweep on ResNet-50 with the trace of its largest value."""
    import io
    from bluefog_tpu_torch.tools import step_sweep
    with contextlib.redirect_stdout(io.StringIO()):
        summary = step_sweep.main(SW_ARGV + [
            "--trace", os.path.join(scratch, "sweep_trace"),
            "--out", os.path.join(scratch, "sweep.json")])
    rep = summary["trace_analysis"]
    if len(summary["rows"]) != 2 or "partial" in summary or \
            not summary["dispatch_amortization"] > 0:
        raise AssertionError(f"24b: step_sweep {summary}")
    if not rep["ok"] or not rep["comm_ms"] > 0 or \
            "bluefog::neighbor_allreduce" not in [
                r["name"] for r in rep["top_exposed_comm_ops"]]:
        raise AssertionError(f"24b: the sweep's trace analysis {rep}")
    row = {"rows": summary["rows"],
           "dispatch_amortization": summary["dispatch_amortization"],
           "trace": {k: rep[k] for k in (
               "wall_ms", "busy_ms", "compute_ms", "comm_ms",
               "comm_exposed_ms", "overlap_fraction", "idle_ms",
               "top_exposed_comm_ops", "n_events", "device_tracks")},
           "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    print("step_sweep " + json.dumps(row), flush=True)
    return row


def _ov_notebooks(smi):
    """24c: each notebook's code cells in order on the card (its
    default device), the asserts included."""
    import io
    import bluefog_tpu_torch as bf
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name in NOTEBOOKS:
        path = os.path.join(root, "bluefog_tpu_torch", "examples",
                            f"{name}.ipynb")
        with open(path) as f:
            cells = [c for c in json.load(f)["cells"]
                     if c["cell_type"] == "code"]
        ns, text = {}, io.StringIO()
        t0 = time.monotonic()
        try:
            with contextlib.redirect_stdout(text):
                for i, c in enumerate(cells):
                    exec(compile("".join(c["source"]), f"{name}[{i}]",
                                 "exec"), ns)
        finally:
            bf.shutdown()
        if ns["device"] != "cuda":
            raise AssertionError(f"24c {name} ran on {ns['device']}")
        out[name] = {"cells": len(cells),
                     "last": text.getvalue().splitlines()[-3:],
                     "seconds": time.monotonic() - t0}
    if "OK: agents agreed" not in out["resource_allocation"]["last"][-1]:
        raise AssertionError(f"24c: {out}")
    print("notebooks " + json.dumps(dict(
        out, device=torch.cuda.get_device_name(0), nvidia_smi=smi)),
        flush=True)
    return out


def overlap_phase(fa, gf, fd, smi):
    """Phase 24: (a) lm_bench's overlap grading, (b) step_sweep, (c) the
    notebooks.  Returns (24a's launches by kernel, 24b-c's, seconds by
    leg)."""
    import tempfile
    seconds = {}
    fd.flash_decode_cuda.launches = 0
    t0 = time.monotonic()
    lm_n, _ = _ov_lm_bench(fa, gf, smi)
    lm_n["flash_decode"] = fd.flash_decode_cuda.launches
    seconds["lm_bench"] = time.monotonic() - t0
    torch.cuda.empty_cache()
    _launch_counts(fa, gf, reset=True)
    fd.flash_decode_cuda.launches = 0
    with tempfile.TemporaryDirectory() as scratch:
        t0 = time.monotonic()
        _ov_step_sweep(smi, scratch)
        seconds["step_sweep"] = time.monotonic() - t0
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    _ov_notebooks(smi)
    seconds["notebooks"] = time.monotonic() - t0
    rest = dict(_launch_counts(fa, gf),
                flash_decode=fd.flash_decode_cuda.launches)
    if any(rest.values()):
        raise AssertionError(f"24b-c launched a kernel: {rest}")
    return lm_n, rest, seconds


def _ptxas_functions(log, names):
    """ptxas's report (-Xptxas -v) for each entry function whose mangled
    name holds one of ``names``: registers, spill stores + loads, and any
    wgmma serialization warning."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur:
                out[cur] = {"spill_bytes": 0, "registers": None,
                            "warnings": []}
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur:
                out.setdefault(cur, {"spill_bytes": 0, "registers": None,
                                     "warnings": []})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
        if "wgmma" in line:
            out[cur]["warnings"].append(line.strip()[:200])
    return out


def _build_all(builders):
    """Build every kernel library at once: one nvcc process each, all
    started together; returns the wall seconds and each library's."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(build):
        t0 = time.monotonic()
        build()
        return time.monotonic() - t0

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builders)) as pool:
        each = [f.result() for f in [pool.submit(timed, b)
                                     for b in builders.values()]]
    return time.monotonic() - t0, dict(zip(builders, each))


_ROW_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def _kernel_row(name, source, replaces, launches, case):
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches}
    row.update({key: case[key] for key in _ROW_KEYS})
    if "warm_ms" in case:                  # K3/K4: ms is timed cold
        row["warm_ms"] = case["warm_ms"]
    return row


def _kernel_free_phases(fa, gf, fd, smi, profile):
    """Phases 14, 15 and 20, which launch no K1-K4 (each asserts it), run
    while the kernels build: their seconds, and phase 20's launch counts
    under ``rest_quiet``."""
    phase_s = {}
    # -- phase 14: the ResNet-50 gossip benchmark (no K1-K4) ------------
    t0 = time.monotonic()
    resnet_phase(fa, gf, fd, smi, profile)
    phase_s["resnet_bench"] = time.monotonic() - t0

    # -- phase 15: the strategy benchmark (no K1-K4) --------------------
    t0 = time.monotonic()
    _, _, _, phase_s["strategy_parity"] = strategy_phase(fa, gf, fd, smi)
    phase_s["strategy_bench"] = time.monotonic() - t0

    # -- phase 20: the optimizer core's rest (no K1-K4) -----------------
    t0 = time.monotonic()
    phase_s["rest_quiet"], rest_s, _ = core_rest_phase(fa, gf, fd, smi)
    phase_s.update({"core_rest_" + k: v for k, v in rest_s.items()})
    phase_s["core_rest"] = time.monotonic() - t0
    return phase_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one full-batch decode call and one "
                         "training step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from bluefog_tpu_torch.ops import _build
        from bluefog_tpu_torch.ops import flash_attention as fa
        from bluefog_tpu_torch.ops import flash_decode as fd
        from bluefog_tpu_torch.ops import grouped_ffn as gf
        from bluefog_tpu_torch.ops import ring
        from bluefog_tpu_torch.moe import layers as moe_layers
        from bluefog_tpu_torch.parallel.compose import LMConfig, \
            init_lm_params
        from bluefog_tpu_torch.serve import kv_cache as kv
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    # -- phase 1: environment and build --------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    # the kernels build (one nvcc a library, all started together) while
    # the phases that launch none of them (14, 15, 20) run on the card
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as build_pool:
        building = build_pool.submit(_build_all, {
            "flash_decode": fd.build, "flash_attention": fa.build,
            "grouped_ffn": gf.build})
        phase_s = _kernel_free_phases(fa, gf, fd, smi, args.profile)
        rest_quiet = phase_s.pop("rest_quiet")
        t0 = time.monotonic()
        build_s, lib_s = building.result()
        phase_s["build_wait"] = time.monotonic() - t0
    for lib in ("flash_decode", "flash_attention", "grouped_ffn"):
        for line in _build.build_log(lib).splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {lib} " + line.strip())
    bwd = _ptxas_functions(_build.build_log("grouped_ffn"),
                           ("backward_gemm", "backward_plan",
                            "wgrad_parts_sum"))
    print("ptxas_k4_backward " + json.dumps(bwd), flush=True)
    # the plan, backward_gemm (f32) and backward_gemm16 (bf16) in three
    # modes each, wgrad_parts_sum for f32 and bf16 outputs
    if len(bwd) != 9 or any(f["spill_bytes"] for f in bwd.values()):
        raise AssertionError(f"K4's backward kernels: want 9 built without "
                             f"spills, got {bwd}")
    # the forward_gemm route: forward_gemm up and down in f32, down on bf16
    # weights, forward_gemm16 up in bf16
    fwd = _ptxas_functions(_build.build_log("grouped_ffn"),
                           ("forward_gemm",))
    print("ptxas_k4_forward_gemm " + json.dumps(fwd), flush=True)
    if len(fwd) != 4 or any(f["spill_bytes"] for f in fwd.values()):
        raise AssertionError(f"K4's forward_gemm kernels: want 4 built "
                             f"without spills, got {fwd}")
    print("env " + json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "kernel_build_s": build_s,
        "library_build_s": lib_s}),
        flush=True)
    phase_s["build"] = build_s

    # -- phase 2: flash decode against its plain version ----------------
    t0 = time.monotonic()
    main_case, int8_case = kernel_phase(fd, kv)
    k3_256 = decode_head_dim_phase(fd, kv)
    phase_s["flash_decode_cases"] = time.monotonic() - t0

    # -- phase 2b: K3's chunk form (verify, chunked prefill, > 64 rows) --
    t0 = time.monotonic()
    k3_chunk = chunk_phase(fd, kv)
    phase_s["flash_decode_chunk_cases"] = time.monotonic() - t0

    # -- phase 3: the serving path at full width ------------------------
    t0 = time.monotonic()
    cfg = LMConfig(vocab=32768, d_model=1024, heads=16, layers=8,
                   ffn_mult=4)
    model = init_lm_params(cfg, seed=0, device=DEV)
    engine, launches = serve_phase(fd, kv, "raw", model, cfg, "raw", 16, 64)
    _, launches_int8 = serve_phase(fd, kv, "int8", model, cfg, "int8", 8,
                                   32)
    if args.profile:
        profile_phase(engine, shares=("flash_decode",))
    del engine
    torch.cuda.empty_cache()
    phase_s["serve"] = time.monotonic() - t0

    # -- phase 13: the serving fast path (spec decoding, prefix pages) ---
    t0 = time.monotonic()
    fast = fast_serve_phase(fd, kv, "serve_fast", model, cfg, smi, pp=2,
                            spec=4, n_req=16, max_new=64)
    del model
    torch.cuda.empty_cache()
    phase_s["serve_fast"] = time.monotonic() - t0

    # -- phase 3c: the carved engine (dp 2 x pp 2 x tp 2) ---------------
    t0 = time.monotonic()
    carved, k3_carved, _ = carved_serve_phase(fd, kv, smi,
                                              profile=args.profile)
    phase_s["serve_carved"] = time.monotonic() - t0

    # -- phase 4: flash attention K1/K2 against their plain versions ----
    t0 = time.monotonic()
    attn = attention_phase(fa)
    attn256 = head_dim_phase(fa)
    phase_s["flash_attention_cases"] = time.monotonic() - t0

    # -- phase 5: ring attention over stacked ranks ---------------------
    t0 = time.monotonic()
    ring_phase(fa, ring)
    zigzag_phase(fa, ring)
    phase_s["ring"] = time.monotonic() - t0

    # -- phase 6: the decentralized trainer at full width ---------------
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    (fwd_n, bwd_n), step, strategy, init, toks = train_phase(fa, smi)
    if args.profile:
        profile_train(step, strategy, init, toks)
    del step, strategy, init, toks
    torch.cuda.empty_cache()
    phase_s["train"] = time.monotonic() - t0

    # -- phases 9-10: the composed trainer (pp x tp; tp x Ulysses sp) ----
    compose_launches = {}
    for tag, carving in (("compose_pp2_tp2", (2, 2, 2, 1)),
                         ("compose_tp2_sp2", (2, 1, 2, 2))):
        t0 = time.monotonic()
        launches_c, step, strategy, init, toks = compose_phase(
            fa, smi, *carving, tag)
        compose_launches[tag] = launches_c
        if args.profile:
            profile_train(step, strategy, init, toks, "profile_" + tag)
        del step, strategy, init, toks
        torch.cuda.empty_cache()
        phase_s[tag] = time.monotonic() - t0

    # -- phase 11: the long-context trainer (ring contiguous / zigzag,
    #    Ulysses) over 8 stacked sequence ranks --------------------------
    lc_launches, lc_loss1, lc_rank_loss1 = {}, {}, {}
    for sp_mode, layout in (("ring", "contiguous"), ("ring", "zigzag"),
                            ("ulysses", "contiguous")):
        t0 = time.monotonic()
        launches_l, loss1, summ = long_context_phase(fa, smi, sp_mode,
                                                     layout, args.profile)
        tag = f"long_context_{layout if sp_mode == 'ring' else sp_mode}"
        lc_launches[tag], lc_loss1[tag] = launches_l, loss1
        lc_rank_loss1[tag] = summ["losses"][0]
        phase_s[tag] = time.monotonic() - t0
    # the same init, the permuted tokens: the step-1 loss must agree, both
    # the loss the timed step returned (the mean of per-rank means, which
    # weighs the rank holding the lag's masked targets apart) and the
    # loss over every target token (which does not depend on the layout)
    z, c = lc_loss1["long_context_zigzag"], lc_loss1["long_context_contiguous"]
    zr = lc_rank_loss1["long_context_zigzag"]
    cr = lc_rank_loss1["long_context_contiguous"]
    print("long_context_layouts " + json.dumps({
        "step1_token_mean_loss": lc_loss1,
        "step1_rank_mean_loss": lc_rank_loss1,
        "zigzag_vs_contiguous_rel": abs(z - c) / abs(c),
        "zigzag_vs_contiguous_step_rel": abs(zr - cr) / abs(cr)}),
        flush=True)
    for what, a, b in (("token-mean", z, c), ("step's own", zr, cr)):
        if not np.isclose(a, b, rtol=1e-5, atol=0):
            raise AssertionError(f"long context: the zigzag step-1 {what} "
                                 f"loss {a} != the contiguous one {b}")

    # -- phase 7: the grouped expert FFN K4 against its plain version ---
    t0 = time.monotonic()
    k4_cases = grouped_ffn_phase(gf)
    k4_decode, k4_prefill = k4_cases["decode_8_lanes"], \
        k4_cases["prefill_512"]
    phase_s["grouped_ffn_cases"] = time.monotonic() - t0

    # -- phase 8: MoE serving at full width -----------------------------
    t0 = time.monotonic()
    engine, k4_launches, k3_moe, moe_model, moe_cfg = moe_serve_phase(
        fd, gf, moe_layers, smi)
    if args.profile:
        profile_phase(engine, "profile_moe",
                      shares=("expert_rows", "forward_gemm",
                              "flash_decode"))
    del engine
    torch.cuda.empty_cache()
    phase_s["moe_serve"] = time.monotonic() - t0

    # -- phase 8b: the MoE serving fast path (expert-mean draft) --------
    t0 = time.monotonic()
    moe_fast = fast_serve_phase(fd, kv, "moe_serve_fast", moe_model,
                                moe_cfg, smi, pp=1, spec=2, n_req=8,
                                max_new=32, gf=gf, layers_mod=moe_layers)
    del moe_model
    torch.cuda.empty_cache()
    phase_s["moe_serve_fast"] = time.monotonic() - t0

    # -- phase 8c: the carved MoE engine (dp 2 x tp 2 x ep 2) ----------
    t0 = time.monotonic()
    moe_carved, k3_moe_carved, k4_carved = carved_serve_phase(
        fd, kv, smi, gf, moe_layers, profile=args.profile)
    phase_s["moe_serve_carved"] = time.monotonic() - t0

    # -- phase 12a: K4's backward against the per-expert plain version ---
    t0 = time.monotonic()
    k4_bwd = grouped_ffn_backward_phase(gf)
    phase_s["grouped_ffn_backward_cases"] = time.monotonic() - t0

    # -- phase 12a, bf16: K4's bf16 backward against its plain version --
    t0 = time.monotonic()
    k4_bwd16 = grouped_ffn_backward_bf16_phase(gf)
    phase_s["grouped_ffn_backward_bf16_cases"] = time.monotonic() - t0

    # -- phase 12b: MoE training at full width (dp 2 x pp 2 x tp 2) -----
    t0 = time.monotonic()
    moe_launches, _ = moe_train_phase(fa, gf, moe_layers, smi, args.profile)
    phase_s["moe_train"] = time.monotonic() - t0

    # -- phase 12e: the same MoE training in bf16 -------------------------
    t0 = time.monotonic()
    bf16_launches, _ = moe_train_bf16_phase(fa, gf, moe_layers, smi)
    phase_s["moe_train_bf16"] = time.monotonic() - t0

    # -- phase 12c: MoE training at ep 2 (dp 2 x ep 2) and its ep-1 twin --
    t0 = time.monotonic()
    ep_launches, ep_summ = moe_ep_phase(fa, gf, moe_layers, smi)
    phase_s["moe_train_ep2"] = time.monotonic() - t0

    # -- phase 12d: capacity dispatch and expert choice at dp 2 x ep 2 ---
    route_launches = {}
    for tag, kw in (("moe_train_capacity", {"dispatch": "capacity"}),
                    ("moe_train_expert_choice",
                     {"router_mode": "expert_choice"})):
        t0 = time.monotonic()
        route_launches[tag], _ = moe_route_phase(fa, gf, moe_layers, smi,
                                                 tag, **kw)
        phase_s[tag] = time.monotonic() - t0

    # -- phase 16: the train->serve estate (16a dense, 16b MoE) ----------
    estate = {}
    for tag, moe in (("serve_estate", False), ("serve_estate_moe", True)):
        t0 = time.monotonic()
        estate[tag] = estate_phase(fa, fd, gf, moe_layers, smi, moe)[1]
        phase_s[tag] = time.monotonic() - t0

    # 22d's children (the launcher's runs, no K1-K4 in this process)
    # start here and run beside phases 17-21
    started = elastic_start()
    windows = {}                 # phases 17-21: (start, end) since t_start

    def window(name, t0):
        windows[name] = (t0 - t_start, time.monotonic() - t_start)

    # -- phase 17: the MoE examples (llm_3d, moe, moe_lm) -----------------
    t0 = time.monotonic()
    ex_runs = examples_phase(fa, gf, smi)
    phase_s["examples_moe"] = time.monotonic() - t0
    window("examples_moe", t0)

    # -- phases 18-19: the pipeline schedules and the world (no K1-K4) ---
    _launch_counts(fa, gf, reset=True)
    fd.flash_decode_cuda.launches = 0
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    with tempfile.TemporaryDirectory() as scratch, \
            ThreadPoolExecutor(2) as pool:
        t0 = time.monotonic()
        wide = pipeline_wide()                   # 18b, alone
        phase_s["pipelines_wide"] = time.monotonic() - t0
        window("pipelines_wide", t0)
        t19 = time.monotonic()
        launched = world_launch(pool, scratch)   # 19's processes start
        t0 = time.monotonic()
        examples = pipeline_examples()           # 18a, beside them
        phase_s["pipelines_examples"] = time.monotonic() - t0
        window("pipelines_examples", t0)
        print("pipelines " + json.dumps({
            "examples": examples, "examples_beside_world": True,
            "wide": wide, "shape": PIPE_WIDE,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}),
            flush=True)
        t0 = time.monotonic()
        world_phase(smi, launched)
        phase_s["world_join"] = time.monotonic() - t0
        window("world", t19)
    quiet = dict(_launch_counts(fa, gf),
                 flash_decode=fd.flash_decode_cuda.launches)
    print("phases_18_19_launches " + json.dumps(quiet), flush=True)
    if any(quiet.values()):
        raise AssertionError(f"phases 18-19 launched a kernel: {quiet}")
    # -- phase 21: the host runtime (K1/K2 through the dense trainer) ----
    t0 = time.monotonic()
    hr_launches, hr_s = host_runtime_phase(fa, gf, fd, smi)
    phase_s.update({"host_runtime_" + k: v for k, v in hr_s.items()})
    phase_s["host_runtime"] = time.monotonic() - t0
    window("host_runtime", t0)
    # -- phase 22: the launcher, the elastic world and the fleet view ----
    t0 = time.monotonic()
    el_launches, el_s = elastic_phase(fa, gf, fd, smi, started)
    phase_s.update({"elastic_" + k: v for k, v in el_s.items()})
    phase_s["elastic"] = time.monotonic() - t0
    print("elastic_children_overlap " + json.dumps(
        _el_overlap(started, windows, t_start)), flush=True)
    # -- phase 23: the autotuner (K1/K2 and K4 in the carving steps) -----
    t0 = time.monotonic()
    _launch_counts(fa, gf, reset=True)
    at_launches, at_s = autotune_phase(fa, gf, smi)
    phase_s.update({"autotune_" + k: v for k, v in at_s.items()})
    phase_s["autotune"] = time.monotonic() - t0
    # -- phase 24: the trace's split, step_sweep, the notebooks ---------
    t0 = time.monotonic()
    ov_launches, ov_rest, ov_s = overlap_phase(fa, gf, fd, smi)
    phase_s.update({"overlap_" + k: v for k, v in ov_s.items()})
    phase_s["overlap"] = time.monotonic() - t0
    phase_s["total"] = time.monotonic() - t_start
    print("phases " + json.dumps(phase_s), flush=True)

    print(smi)
    decode = _kernel_row("flash_decode",
                         "bluefog_tpu_torch/csrc/flash_decode.cu",
                         "bluefog_tpu/ops/pallas_decode.py:136", launches,
                         main_case)
    decode["launches_int8_run"] = launches_int8
    decode["launches_by_path"] = {
        **{tag: n["flash_decode"] for tag, n in estate.items()},
        "serve": launches, "serve_int8": launches_int8,
        "serve_fast": fast["k3_launches"], "moe_serve": k3_moe,
        "moe_serve_fast": moe_fast["k3_launches"],
        "serve_carved": carved["k3_launches"],
        "moe_serve_carved": moe_carved["k3_launches"],
        "pipelines_and_world": quiet["flash_decode"],
        "optimizer_core_rest": rest_quiet["flash_decode"],
        "host_runtime": hr_launches["flash_decode"],
        "elastic": el_launches["flash_decode"],
        "lm_bench_overlap": ov_launches["flash_decode"],
        "step_sweep_and_notebooks": ov_rest["flash_decode"]}
    decode["carved_decode"] = {
        tag: {key: row[key] for key in _ROW_KEYS + (
            "warm_ms", "library_warm_ms", "S", "Hkv", "rows", "splits")}
        for tag, row in (("serve_carved", k3_carved),
                         ("moe_serve_carved", k3_moe_carved))}
    decode["chunk"] = {tag: {key: row[key] for key in _ROW_KEYS + (
        "warm_ms", "library_warm_ms", "rows", "tiles", "splits")}
        for tag, row in k3_chunk.items()}
    decode["int8"] = {key: int8_case[key]
                      for key in _ROW_KEYS + ("warm_ms",)}
    decode["head_dim_256"] = {store: {key: row[key] for key in (
        "max_abs_err", "ms", "warm_ms", "plain_ms", "bound_ms", "bound_by")}
        for store, row in k3_256.items()}
    src = "bluefog_tpu_torch/csrc/flash_attention.cu"
    main_c = compose_launches["compose_pp2_tp2"]
    paths = {"train_dp4": (fwd_n, bwd_n), **compose_launches,
             **{tag: (n["flash_fwd"], n["flash_bwd"])
                for tag, n in estate.items()},
             **lc_launches, **{tag: (n["flash_fwd"], n["flash_bwd"]) for
                               tag, n in (("moe_train", moe_launches),
                                          ("moe_train_bf16", bf16_launches),
                                          *ep_launches.items(),
                                          *route_launches.items())},
             **{"example_" + tag: (r["launches"]["flash_fwd"],
                                   r["launches"]["flash_bwd"])
                for tag, r in ex_runs.items()},
             "pipelines_and_world": (quiet["flash_fwd"], quiet["flash_bwd"]),
             "optimizer_core_rest": (rest_quiet["flash_fwd"],
                                     rest_quiet["flash_bwd"]),
             "host_runtime": (hr_launches["flash_fwd"],
                              hr_launches["flash_bwd"]),
             "elastic": (el_launches["flash_fwd"], el_launches["flash_bwd"]),
             "carving_tuner": (at_launches["flash_fwd"],
                               at_launches["flash_bwd"]),
             "lm_bench_overlap": (ov_launches["flash_fwd"],
                                  ov_launches["flash_bwd"]),
             "step_sweep_and_notebooks": (ov_rest["flash_fwd"],
                                          ov_rest["flash_bwd"])}
    bf16_keys = _ROW_KEYS + ("warm_ms", "dgrad_ms", "wgrad_ms", "rows",
                             "library_warm_ms")
    k4_ep = {tag: {"launches": n["grouped_ffn"],
                   "backward_launches": n["grouped_ffn_dgrad"],
                   **ep_summ[tag]["k4_device_ms_per_step"]}
             for tag, n in ep_launches.items()}
    print(json.dumps({"kernels": [
        decode,
        dict(_kernel_row("flash_fwd", src,
                         "bluefog_tpu/ops/pallas_attention.py:134",
                         main_c[0], attn["fwd"]),
             launches_by_path={k: v[0] for k, v in paths.items()},
             head_dim_256={"ms": attn256["fwd_ms"],
                           "max_abs_err": attn256["fwd_err"],
                           "plain_ms": attn256["fwd_plain_ms"],
                           "bound_ms": attn256["fwd_bound_ms"],
                           "bound_by": attn256["fwd_bound_by"]}),
        dict(_kernel_row("flash_bwd", src,
                         "bluefog_tpu/ops/pallas_attention.py:275",
                         main_c[1], attn["bwd"]),
             launches_by_path={k: v[1] for k, v in paths.items()},
             library_fwd_bwd_ms=attn["bwd"]["library_fwd_bwd_ms"],
             head_dim_256={"ms": attn256["bwd_ms"],
                           "max_abs_err": attn256["bwd_err"],
                           "plain_ms": attn256["bwd_plain_ms"],
                           "bound_ms": attn256["bwd_bound_ms"],
                           "bound_by": attn256["bwd_bound_by"]}),
        dict(_kernel_row("grouped_ffn",
                         "bluefog_tpu_torch/csrc/grouped_ffn.cu",
                         "bluefog_tpu/ops/pallas_moe.py:61", k4_launches,
                         k4_decode),
             bound_ms_simt=k4_decode["bound_ms_simt"],
             launches_moe_train=moe_launches["grouped_ffn"],
             routes={case: {"route": row["route"], **row["routes"]}
                     for case, row in k4_cases.items()},
             bf16_trainer_forward=dict(
                 k4_bwd16["steady_tick"]["forward"],
                 launches=bf16_launches["grouped_ffn"],
                 shape="phase 12a's bf16 steady tick (65,536 rows, 32 "
                       "folded experts, D 1024, F 2048), s kept"),
             launches_by_path={"moe_serve": k4_launches,
                               "moe_train_bf16": bf16_launches[
                                   "grouped_ffn"],
                               "moe_serve_fast": moe_fast["k4_launches"],
                               "moe_serve_carved": moe_carved["k4_launches"],
                               "moe_train": moe_launches["grouped_ffn"],
                               "serve_estate_moe":
                                   estate["serve_estate_moe"]["grouped_ffn"],
                               **{tag: n["grouped_ffn"] for tag, n in
                                  ep_launches.items()},
                               "pipelines_and_world": quiet["grouped_ffn"],
                               "optimizer_core_rest":
                                   rest_quiet["grouped_ffn"],
                               "host_runtime": hr_launches["grouped_ffn"],
                               "elastic": el_launches["grouped_ffn"],
                               "carving_tuner": at_launches["grouped_ffn"],
                               "lm_bench_overlap":
                                   ov_launches["grouped_ffn"],
                               "step_sweep_and_notebooks":
                                   ov_rest["grouped_ffn"]},
             moe_train_ep2=k4_ep,
             carved_decode={key: k4_carved[key] for key in _ROW_KEYS + (
                 "warm_ms", "library_warm_ms", "G", "tile", "owners",
                 "trash_tiles")},
             prefill={key: k4_prefill[key] for key in _ROW_KEYS + (
                 "warm_ms", "bound_ms_simt")}),
        dict(_kernel_row("grouped_ffn_forward_gemm",
                         "bluefog_tpu_torch/csrc/grouped_ffn.cu",
                         "bluefog_tpu/ops/pallas_moe.py:78",
                         moe_launches["grouped_ffn_forward_gemm"],
                         k4_bwd["steady_tick"]["forward"]),
             kernels="backward_plan (the routing plan, which the trained "
                     "call's backward takes), then forward_gemm (f32: up "
                     "with gelu, down; bf16: the down-projection on the "
                     "f32 u) / forward_gemm16 (bf16 up) + "
                     "zero_marked_tiles",
             shape="phase 12a's steady tick (65,536 rows, 32 folded "
                   "experts, D 1024, F 2048), s kept; the route for an "
                   "even share of at least 52 rows an expert",
             expert_rows_at_this_shape=k4_bwd["steady_tick"]["forward"][
                 "expert_rows"],
             bf16=dict(k4_bwd16["steady_tick"]["forward"],
                       launches=bf16_launches["grouped_ffn_forward_gemm"]),
             launches_by_path={
                 "moe_serve": K4_FORWARD_GEMM["moe_serve"],
                 "moe_train_bf16": bf16_launches["grouped_ffn_forward_gemm"],
                 "moe_serve_fast": K4_FORWARD_GEMM["moe_serve_fast"],
                 "moe_serve_carved": K4_FORWARD_GEMM["serve_moe_carved"],
                 "moe_train": moe_launches["grouped_ffn_forward_gemm"],
                 "serve_estate_moe": K4_FORWARD_GEMM["serve_estate_moe"],
                 **{tag: n["grouped_ffn_forward_gemm"] for tag, n in
                    ep_launches.items()},
                 **{tag: n["grouped_ffn_forward_gemm"] for tag, n in (
                     ("pipelines_and_world", quiet),
                     ("optimizer_core_rest", rest_quiet),
                     ("host_runtime", hr_launches),
                     ("elastic", el_launches),
                     ("carving_tuner", at_launches),
                     ("lm_bench_overlap", ov_launches),
                     ("step_sweep_and_notebooks", ov_rest))}}),
        dict(_kernel_row("grouped_ffn_backward",
                         "bluefog_tpu_torch/csrc/grouped_ffn.cu",
                         "bluefog_tpu/ops/pallas_moe.py:99",
                         moe_launches["grouped_ffn_dgrad"],
                         k4_bwd["steady_tick"]),
             kernels="backward_plan, then backward_gemm (wgmma: dgrad x 2, "
                     "wgrad x 2) + wgrad_parts_sum",
             wgrad_launches=moe_launches["grouped_ffn_wgrad"],
             bf16={case: dict({key: row[key] for key in bf16_keys},
                              launches=bf16_launches["grouped_ffn_dgrad"])
                   for case, row in k4_bwd16.items()},
             launches_by_path={"moe_train": moe_launches["grouped_ffn_dgrad"],
                               "moe_train_bf16":
                                   bf16_launches["grouped_ffn_dgrad"],
                               "serve_estate_moe": estate[
                                   "serve_estate_moe"]["grouped_ffn_dgrad"],
                               **{tag: n["grouped_ffn_dgrad"] for tag, n in
                                  ep_launches.items()},
                               "pipelines_and_world":
                                   quiet["grouped_ffn_dgrad"],
                               "optimizer_core_rest":
                                   rest_quiet["grouped_ffn_dgrad"],
                               "host_runtime":
                                   hr_launches["grouped_ffn_dgrad"],
                               "elastic": el_launches["grouped_ffn_dgrad"],
                               "carving_tuner":
                                   at_launches["grouped_ffn_dgrad"],
                               "lm_bench_overlap":
                                   ov_launches["grouped_ffn_dgrad"],
                               "step_sweep_and_notebooks":
                                   ov_rest["grouped_ffn_dgrad"]},
             moe_train_ep2=k4_ep,
             dgrad_ms=k4_bwd["steady_tick"]["dgrad_ms"],
             wgrad_ms=k4_bwd["steady_tick"]["wgrad_ms"],
             **{case: {key: k4_bwd[case][key] for key in _ROW_KEYS + (
                 "warm_ms", "dgrad_ms", "wgrad_ms")}
                for case in ("prefill_512", "hostile", "skewed")}),
        {"name": "grouped_ffn_backward_plan", "route": "cuda",
         "source": "bluefog_tpu_torch/csrc/grouped_ffn.cu",
         "replaces": "bluefog_tpu/ops/pallas_moe.py:99",
         "launches": moe_launches["grouped_ffn_backward_plan"],
         "launches_by_path": {
             "moe_train": moe_launches["grouped_ffn_backward_plan"],
             "moe_train_bf16": bf16_launches["grouped_ffn_backward_plan"],
             "serve_estate_moe":
                 estate["serve_estate_moe"]["grouped_ffn_backward_plan"],
             **{tag: n["grouped_ffn_backward_plan"] for tag, n in
                ep_launches.items()},
             "pipelines_and_world": quiet["grouped_ffn_backward_plan"],
             "optimizer_core_rest":
                 rest_quiet["grouped_ffn_backward_plan"],
             "host_runtime": hr_launches["grouped_ffn_backward_plan"],
             "elastic": el_launches["grouped_ffn_backward_plan"],
             "carving_tuner": at_launches["grouped_ffn_backward_plan"],
             "lm_bench_overlap": ov_launches["grouped_ffn_backward_plan"],
             "step_sweep_and_notebooks":
                 ov_rest["grouped_ffn_backward_plan"]},
         "max_abs_err": max(row["plan_max_abs_err"]
                            for row in k4_bwd.values()),
         "ms": k4_bwd["steady_tick"]["plan_ms"],
         "plain_ms": k4_bwd["steady_tick"]["plan_plain_ms"],
         "bound_ms": k4_bwd["steady_tick"]["plan_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "note": "integer lists, equal to the plain version's in every "
                 "phase 12a case"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
