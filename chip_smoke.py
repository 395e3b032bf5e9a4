#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``gemm_hls_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. device check: a CUDA device is required (there is no CPU path);
  2. build every kernel from ``gemm_hls_tpu_torch/csrc`` with nvcc (sm_90a,
     one nvcc per source, all at once), and list the kernels ptxas spilled
     registers in and those whose wgmma it serialised (warnings C7515 and
     C7518), the W8A8 and row-softmax engine kernels' registers, and the
     row-softmax engine source's nvcc seconds beside the slowest source's;
  3. kernel B1 (dense plus_times) against its plain PyTorch version on the
     card: bf16, fp16, fp32, int8 -> int32 and int32, four layouts, odd,
     unaligned and 1024-class shapes, bool or_and, autograd gradients;
  4. kernel B3 (semiring GEMM) against its plain version: every built-in
     semiring, f32 / bf16 / int32, unaligned shapes up to 2048, NaN and
     +-inf inputs, all -inf rows for log_plus;
  5. slice 1's main path at full size through ``tools.run``: bf16 8192^3
     and fp32 min_plus 4096^3, each checked against the plain version on
     the card and timed beside it, then host-oracle verification at 1024^3;
  6. kernel B1 with each epilogue, B2 (plain, per-column epilogue and
     row-softmax variants) and batched B3 against their plain versions:
     dtypes, four layouts, odd shapes, N not a multiple of 128, a 2-D
     operand broadcast over the batch, a batch above gridDim.z's 65535;
     then B2_ROUTE_CASES on both B2 routes (the wgmma engine and WMMA),
     the route checked each, every engine case again on WMMA through the
     route override, and 20 launches of one engine case with the same
     bits; then ROW_SOFTMAX_ROUTE_CASES on both row-softmax routes (the
     wgmma engine, ``csrc/row_softmax_wgmma.cu``, and ``row_softmax.cu``),
     the route checked each, every row summing to 1, every engine case
     again on ``row_softmax.cu`` through the route override, and 20
     launches of one engine case with the same bits;
  7. gradients of the batched, epilogue and fused_linear paths against
     plain autograd;
  8. slice 2's main path at full width, launch counts set to 0 before it
     and read after: the MLP trainer (``models.mlp.train_step``, 5 steps,
     fused and unfused) at dims (4096, 16384, 4096) with 8192 bf16 tokens
     and at (1024, 4096, 1024) with 2048 fp32 tokens, each held step by
     step against a plain PyTorch trainer, plus a checkpoint round trip;
     ``attention`` at (32, 1024, 128) bf16 (fused row softmax, its route
     checked: the engine) and at (8, 8192, 128) (rows past the fused
     bound: the unfused branch), its
     gradient at (8, 512, 64); batched ``matmul`` calls (four layouts,
     int8, fp32, broadcast, 4-D, min_plus), each B2 launch's route
     printed and checked (the engine for the aligned bf16 calls);
  9. times of B1's epilogue, B2 and B2's row softmax beside their plain
     versions at the main path's shapes (B2 at 64 x 512^3, 256 x 128^3 and
     attention's p . v on device time in turns beside its WMMA route and
     ``torch.bmm``; the row softmax at 32 x 1024^2 x 128 on device time in
     turns beside ``row_softmax.cu``, the plain version and the two-call
     compositions ``torch.softmax(torch.bmm(q, k^T)[.float()], -1)``, with
     its bound; ``attention`` (32, 1024, 128) beside its plain
     composition the same way), and of phase 8's batched calls beside the
     torch call that computes the same (not counted as launches);
 10. kernels B4 (diagonal) and B5 (hi/lo) against their plain versions:
     2, 3, 4 and 8 slices, stacked and split operands, scaled and
     unscaled, unaligned M, N and K, both flush periods of B5; then
     DIAG_ROUTE_CASES on both B4 routes (the wgmma engine and mma.sync), the
     route checked each, every engine case again on mma.sync, each equal to
     the plain version bit for bit, and 20 launches of one engine case with
     the same bits; OZAKI_ROUTE_CASES likewise for B5; the int32 bounds
     refuse on the card;
 11. slice 3's main path at full width, launch counts set to 0 before it
     and read after: ``matmul(precision="i8x2"|"i8x3"|"i8x4")`` at fp32
     8192^3 (B4, its route checked: the engine), K = 44000 and 2^17 + 128
     (B5), the i8x3 gradient at 4096^3 (B4 on the engine);
     ``ozaki_matmul_int8`` at f64 2048^3 and 8192^3 (B5) and
     ``ozaki_matmul`` at 2048^3 (B1); ``all_pairs_shortest_paths`` and
     ``widest_paths`` at n = 4096 (B3), ``transitive_closure`` at 8192 (B1
     int8 and bit-packed B3), ``pagerank`` at 8192 (B1); the five semiring
     gradients at 1024^3;
 12. times of B4 (i8x2/3/4 at 8192^3, both routes, fp32 ``torch.matmul``
     and ``matmul(precision=...)`` end to end, in turns on CUDA events) and
     B5 (8 slices at 2048^3 and 8192^3) beside their plain versions and the
     library product (``torch.matmul`` fp32 / float64), and of the
     end-to-end calls;
 13. the flash kernels (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``:
     TPU kernels B6-B12) against their plain versions: bf16, fp16, fp32; D
     16, 36, 40, 64, 128; unaligned S_q and S_kv, S_q = 1; full, causal,
     causal + window, the soft cap; kv_lengths (3-D and 4-D, staggered;
     with the cache slots past each length NaN in K and +inf in V), segment
     ids (packed, 4-D GQA), offsets (and a fully-future shard); GQA groups
     1, 4 and 8; 70000 heads (launched in chunks); lse; dq, dk, dv against
     the plain backward; fp32 gradients against float64 autograd of a
     dense reference; refusals; then FLASH_ROUTE_CASES on both forward
     routes (the wgmma engine and mma.sync), the route checked each, and
     20 launches of one engine case with the same bits; then
     FLASH_BWD_ROUTE_CASES (dq, dk and dv; every engine case also on
     mma.sync), the routes checked, rows that see no key exactly 0, and 20
     launches of each backward kernel on one engine case with the same
     bits;
 14. slice 4's main path at full width, launch counts set to 0 before it
     and read after: ``flash_attention`` at (32, 1024, 128) bf16 full and
     causal and causal (8, 8192, 128); GQA causal prefill at the serving
     configuration (B 4, S 1024, H_q 16, H_kv 4, D 128, 4-D layout);
     padded-cache decode, 64 sequences x 4096 slots, 8 steps each writing
     K / V at the sequence ends, through the 4-D decode fast path; one
     training step's gradient through ``flash_attention(causal=True)`` at
     (32, 1024, 128) bf16; each forward's route printed and checked
     against ``flash_route`` (the engine for the prefill shapes, mma.sync
     for decode), the gradient's against ``flash_bwd_route`` (the engine),
     then a torch.profiler breakdown of that gradient;
 15. times of the three flash kernels beside their plain versions, their
     bounds, the forward's other tensor-core route and
     ``scaled_dot_product_attention`` pinned to cuDNN and to
     FlashAttention-2 (its forward beside flash_fwd; its backward, which
     yields dq, dk and dv in one call, beside the sum of flash_bwd_dq and
     flash_bwd_dkv, on flash_bwd_dkv's entry of the kernels line), each
     kernel's other route, and the pair with its delta pass, all in turns
     on device time (``time_turns``); the forward's routes and the backward
     pair (both routes, with the delta pass, SDPA's backward) also at
     (8, 8192, 128) causal and the GQA prefill; and phase 14's end-to-end
     calls;
 16. the quantized and grouped kernels against their plain versions:
     ``dequant_gemm`` (B13: int8 / int4, per-channel / group-wise, M 1, 64,
     130, ragged N), ``w8a8_gemm`` (B14 / B15: both schedules as the JAX
     rule picks them, int_acc on and off, zero rows, the int8 activations
     equal to the plain quantize's), ``grouped_gemm`` (B16:
     tests/test_grouped.py's matrix, transpose_rhs, bf16 / fp16 / fp32, the
     zero tail exact), then DEQUANT_ROUTE_CASES on B13's routes (the wgmma
     engine, mma.sync, the CUDA cores; every engine case again on mma.sync),
     W8A8_ROUTE_CASES on both B14 / B15 routes (the wgmma engine and
     mma.sync: the three modes, group-wise and past the int32 bound, both
     N tiles; every engine case again on mma.sync, bitwise equal; the int8
     activations and scales equal to plain) and GROUPED_ROUTE_CASES on both
     B16 routes, the route checked each, and 20 launches of one engine case
     of each with the same bits;
 17. slice 5's main path, launch counts set to 0 before it and read after:
     the serving decoder block (examples/15_serving_decoder.py, the port's
     module gemm_hls_tpu_torch/models/serving.py) at
     experiments/serving_bench.py's width, every port call under
     ``torch.cuda.set_sync_debug_mode("error")``: prefill B 4 x S 1024
     (W8A8 projections, causal GQA flash, the MoE on B16) against the plain
     bf16 block with un-quantized weights at the example's quantization
     budget, once on B14 and once on B15, every W8A8 GEMM launch's route
     recorded and checked (the engine); 8 decode steps at 64 sequences x
     4096 slots (int4 g128 projections on B13, padded-cache flash, the MoE)
     against the plain step with the same int4 weights; the flash, B16 and
     B13 routes printed and checked (every decode projection's shape on the
     B13 engine);
 18. times of B13, B14, B15 and B16 at their serving shapes beside their
     bounds, plain versions and library calls (bf16 ``torch.matmul`` on the
     dequantized weights, ``torch._int_mm``, ``torch._grouped_mm``; B13 at
     the decode q and k / v projections on both routes, in turns on device
     time with host us a call; B14 and B15 at the prefill's q / o and k / v
     projections in turns on device time, the whole call on both routes,
     the quantize pass and the GEMM apart, beside ``torch._int_mm`` with
     row-major and column-major weights and bf16 ``torch.matmul``, with
     host us a call (``w8a8_times``); B16 in
     turns on device time with its other route, w2's dlhs too), and the
     serving prefill and decode step beside the plain composition, with a
     profile of each (the decode's B13 one engine launch a projection, no
     split-K pass);
 19. ``grouped_update`` (B17, the grouped GEMM's weight gradient) against
     its plain version: tests/test_grouped.py's matrix in bf16 / fp16 /
     fp32, NaN rows past the groups, routing past M, K and N off the
     tiles, empty groups exactly zero, two launches bitwise equal; then
     ``grouped_matmul``'s gradients (B16 and B17) against plain autograd,
     both ``transpose_rhs``, bf16 / fp32 and bf16 operands with an fp32
     config; then GROUPED_UPDATE_ROUTE_CASES on both B17 routes (the wgmma
     engine and mma.sync), the route checked each, every engine case again
     on mma.sync through the route override, and 20 launches of one engine
     case with the same bits;
 20. slice 6's main path, launch counts set to 0 before it and read after:
     MoE training (``models.moe.moe_train_step``) at
     experiments/serving_bench.py's MoE width (d 2048, d_ff 4096, 8 experts
     top-2, bf16, 4096 tokens), every port call under
     ``set_sync_debug_mode("error")``: the gradient against the plain
     per-expert autograd step, 5 steps with 3 B16 and 2 B17 launches each
     and each loss against the plain loss, a step with the aux loss and one
     with an explicit GemmConfig, an fp32 run at d 512 against the plain
     fp32 step; B16's route for the forward and w2's dlhs checked, and
     every B17 launch's (the engine);
 21. times of B17 at the step's two weight-gradient shapes and at w1's
     with 70% of the slots routed to one expert, on device time in turns
     beside its mma.sync route and ``torch._grouped_mm`` (or a per-expert
     ``torch.matmul`` loop), with its bound and plain version; the
     training step beside the plain step and its bound, and a
     torch.profiler breakdown of one step;
 22. ``ring_gemm`` (B18, the fused ring, both TPU bodies) against its plain
     schedule over RING_CASES: rings of 1-8 ranks living on the card, fp32
     / bf16 / int8 on each route (the wgmma engine, mma.sync, the CUDA
     cores; the route checked), block_k None / 64 / 128 and odd ones, tiles
     off the edges, a permuted rank-to-slot table, capped blocks per rank,
     ring buffers poisoned (NaN, 0x5A bytes); one engine case launched 20
     times and with block_k 64 and 320, the same bits each time;
 23. ``cannon_gemm`` (B19, fused Cannon) against its plain schedule over
     CANNON_CASES: p = 1-4, the three types on each route, the
     identity-skew case, bf16 outputs rounded per step;
 24. slice 7's main path, launch counts set to 0 before it and read after:
     ``ring_matmul`` at bf16 8192^3 over 4 ranks on the card (block_k None
     and 512) and ``cannon_matmul_fused`` at p = 2 against fp32
     ``torch.matmul``; then B18 (1, 4 and 8 ranks) and B19 times beside
     their bounds, plain schedules and bf16 ``torch.matmul`` of the
     product, and each launch's time stamps: the prologue, each step, when
     its sends were done, the longest flag wait;
 25. slice 16's main path, the out-of-memory GEMM staged from host memory
     and the tools of one card, each step timed and its launch counts set
     to 0 before it and read after: (a) ``tools.oversize`` at its defaults
     (32768^3 bf16 in 8192^3 host tiles, 64 panel jobs), its 8 spot checks
     against float64 host dot products, every panel's route (the engine),
     the rate with the staging, the host-to-device GB/s and bytes beside
     the CA law, and the same problem in turns (prefetch off, off, on),
     each bit-identical to the tool's run;
     (b) ``streamed_matmul`` min_plus at 8192^3 fp32 in 4096 tiles equal
     to the plain semiring on the card, and plus_times beside fp32
     ``torch.matmul``; (c) ``streamed_matmul_files`` on the same operands
     through the native tile IO, equal to (b)'s plus_times; (d)
     ``streamed_ozaki_matmul`` at 8192^3 float64, normwise error against
     float64 ``torch.matmul`` below 1e-13; (e) ``tools.selftest`` at full
     size, every check passing; (f) ``tools.profile`` of bf16 8192^3, then
     its CLI in a fresh process writing a Chrome trace that must hold the
     B1 engine kernel; (g) ``tools.print_specifications`` of the problem.
 26. slice 17's tuning tools (phases 1-25 run with no autotune cache file,
     so their route checks are the route rule's): (a) the engine's tile as
     an explicit config (``route_config("bfloat16")``) runs bf16 8192^3 on
     the engine and refuses an unaligned call; then each family tuned at
     one of the packaged seed's shapes into a temporary cache (the dense
     and batched routes, the flash forward and backward pair, B13's route
     and plan, W8A8's route and N tile, B16's route; every candidate's
     readings and the winner printed), the front door called with that
     cache on the winner's route or plan and held to the plain version
     (``tools.autotune.tolerance``), then with no cache file on the route
     rule's; (b) a sweep of a small grid, each configuration in its own
     process (ok, invalid_config, vmem_overflow, and a raising setup_code:
     crashed), its CSV merged with itself; (c) ``run_calibration`` into a
     temporary file, the measured bf16 rate beside the data-sheet peak; (d)
     the built library packaged, unpackaged into an empty directory, and
     loaded by a fresh process that cannot run nvcc; (e) with only the
     packaged seed, bf16 8192^3 ``matmul(a, b)`` takes the seed's route.
     (b) and (d) run beside (a), (c) and (e).
 27. slice 18: (a) every port example (examples/torch/, EXAMPLE_KERNELS)
     run in this process with ``--device cuda``, the launch counts set to 0
     before each, each required to launch its kernels; its seconds and
     printed lines shown; (b) the bias_gelu epilogue against its plain
     version on every B1 route and on B2's engine and WMMA
     (BIAS_GELU_ROUTE_CASES, BIAS_GELU_B2_CASES, the routes checked), and 20
     engine launches with the same bits; (c) the engine flash kernels
     (forward, dq, dk / dv) timed in turns in a fresh process at
     ATTN_MODEL_CASES' 50 shapes (phase 15's among them), each beside
     ``models/attn_model.py``'s prediction and the ratio, then the model
     refitted to this run's readings and its constants printed in
     ENGINE_CONSTANTS' form.
 28. slice 19's main path, the distributed CA-GEMMs on virtual ranks of
     the card (``[cuda] * 8``: one process drives every rank, the
     collectives are device-to-device copies), every launch count and the
     byte counter set to 0 before each call and read after, each rank's
     local kernel and its route checked: (a) bf16 8192^3 through
     ``summa_matmul`` on (2, 4) and (2, 2), ``cannon_matmul`` on (2, 2),
     ``matmul_25d`` on (2, 2, 2) and ``distributed_matmul("auto")``
     against bf16 ``torch.matmul`` (B1 on the engine once per rank, p
     times for Cannon), then timed in turns on CUDA events beside B18, B19
     and ``torch.matmul``; (e) the bytes each rank received equal to
     ``models/scaling_model.comm_volume_per_device`` (Cannon's shifts, its
     skew printed apart); (b) min_plus SUMMA at fp32 4096^3,
     ``distributed_matmul`` min_plus at 4097 x 4095 x 4093 with A
     transposed, APSP at n = 4096 through SUMMA, each equal to the
     single-card call (B3 once per rank per call); (c) the distributed
     Ozaki GEMMs at f64 8192^3 (int8, B5) and 2048^3 (bf16 slices, B1)
     against float64 ``torch.matmul``; (d) ``distributed_streamed_matmul``
     at fp32 16384^3 in 8192 tiles, SUMMA and 2.5D.
 29. slice 20's main path, training parallelism on virtual ranks of the
     card, every launch count, the byte counter and the kernel library's
     entry counts (``EntryLog``: an entry point names a kernel's route) set
     to 0 before each call and read after: (a) ``ring_flash_attention`` at
     B.H 16, S 32768, D 128 bf16 over 8 ranks, full, causal, zigzag, causal
     with window 4096 and GQA 16 / 4, each held to the single-card
     ``flash_mha`` on the same pre-scaled q, every forward launch on the
     engine (36 causal, 136 zigzag), the causal and zigzag gradients held to
     ``flash_mha_diff``'s, the bytes a rank received (forward (n - 1) 2
     |KV shard|, backward that plus n 2 |KV shard in fp32|); (b)
     ``ring_decode_attention`` over 4 ranks of a ragged 64-sequence x 4096
     cache (GQA 16 / 4, S_q 1 and 4, window none and 1024) against the
     single-card decode, one shard's call with lengths past both of its ends
     against the plain version on ``mma.sync``; (c) the sharded MLP step at
     (4096, 16384, 4096) x 8192 bf16 tokens on (dp 2, tp 4), 3 steps held to
     the unsharded ``train_step``, the tp / dp psum bytes; (d)
     ``moe_forward_ep`` on (dp 2, ep 4) and ``moe_forward_ep_a2a`` on ep 4
     (capacity_factor 4) at d 2048 / d_ff 4096 / 8 experts top-2, 4096
     tokens, output and gradients against ``moe_forward``, B16 / B17 on the
     engine, the psum and all_to_all bytes; (e) the GPipe pipeline, 4 stages
     of 4096 -> 16384 -> 4096 bf16, 8192 rows in 8 microbatches, against
     ``stages_forward`` and one train step against its autograd step, the
     ppermute bytes (T - 1) mb d 2 each way; each beside the single-card call
     on CUDA events in turns; then each path's device-busy share in a fresh
     process.  Phase 13's FLASH_ROUTE_CASES hold the forward's fp32 output
     (``out_dtype=torch.float32``) on both 16-bit routes.
 30. slice 21, every operand type of B1 - B3: WIDE_B1_CASES (float64 on
     dmma in four layouts, dense, pitched and odd-pitched operands, the
     tile checked each since slice 23: ``csrc/dmma_tma.cu`` where aligned,
     ``csrc/dmma_gemm.cu`` else; ragged K, every epilogue, broadcast and a
     batch past gridDim.z, +-inf / NaN; int16 and the unsigned ints on
     ``csrc/mxu_simt_int.cu``; int8's extremes on its tensor-core routes;
     the route checked each) and WIDE_B3_CASES (every semiring of each
     type's ``csrc/semiring_<type>.cu``, the extremes, odd K and pitches,
     batched) against the plain versions; then slice 21's main path,
     launch counts set to 0 before and read after: float64 ``matmul`` at
     8192^3 on dmma against the plain version and at 2048^3 in four layouts
     against numpy's float64 product (rtol 1e-9), batched float64 16 x
     1024^3 with bias_gelu and scale_bias, the float64 gradient at 4096^3,
     B3 at 4096^3 (min_plus float16 / int8 / uint8 / int16 / float64 /
     uint16 / int64, max_min uint32) bit for bit, B1 int16 / uint8 plus_times at 4096^3
     exact; each kernel timed beside its plain version and its bound,
     float64 ``torch.matmul`` beside dmma.
 31. slice 22, user-defined semirings and Python-callable epilogues, each
     compiled at first use into a functor of its own
     (``gemm_hls_tpu_torch/ops/codegen.py``): (a) the phase's generated
     libraries, built beside phase 2's library build, each one's nvcc
     seconds and registers; a second lookup builds nothing and a fresh
     process loads them all with no nvcc; then GEN_B3_CASES (user
     semirings on B3: four layouts, edge shapes, batched, a broadcast
     batch, K tails, NaN / +-inf) and GEN_EPILOGUE_CASES (callables on
     every B1 / B2 route, the route checked, relu(acc + b) equal to the
     registered bias_relu bit for bit) against the plain versions; then,
     counts set to 0 before and read after, the main path through the
     front door with no plain version run on the card: (b) B3 at fp32
     4096^3 with example 02's plus_max (rel 1e-3), a user max_plus (bit
     for bit the built-in's, exact), a user log semiring (rel 1e-3 to
     log_plus) and plus_max on int8 (exact); (c) silu(acc + b) at B1's
     epilogue shape, bf16 (8192 x 4096) . (4096 x 16384) on the engine,
     relu(acc + b) equal to bias_relu bit for bit on the engine, WMMA, the
     CUDA cores and dmma, a two-operand clamp, a batched (B2) call, int8
     K-major with an fp32 operand, and a callable's gradient at fp32
     2048^3 against plain autograd; (d) the generated kernels timed in
     turns beside the built-ins, their plain versions and bounds.
 32. slice 23, float64 at the card's FP64 rates: DMMA_TMA_CASES (B1 / B2
     float64 on ``csrc/dmma_tma.cu``, the TMA tile: four layouts, M and N off
     the tile, K 1 / 3 / 17 / 200, 1 x 1 x 1, a batch of 70000, broadcast,
     every epilogue, +-inf / NaN, float32 output; the tile checked each, as
     phase 30f's WIDE_B1_CASES now check theirs: their odd pitches on
     ``csrc/dmma_gemm.cu``) and F64_GATE_CASES (B3 float64 on its tile,
     every min / max semiring on slices holding +inf only, -inf only, both,
     NaN, and an infinity beside a zero, the form each slice ran counted
     against ``ops.vpu.num_gate``) against the plain versions, bit for bit
     for B3, and a user float64 semiring; then, counts set to 0 before and
     read after, the main path: (a) float64 ``matmul`` at 8192^3 on the TMA
     tile against the plain version, at 2048^3 in four layouts against
     numpy (rtol 1e-9), batched 16 x 1024^3 with bias_gelu and scale_bias,
     the gradient at 4096^3 (three TMA launches), a callable relu(acc + b)
     at 2048^3, and an unaligned 4097 x 4095 x 4093 product on the cp.async
     tile; (b) B3 min_plus float64 at 4096^3 and float64
     ``all_pairs_shortest_paths`` at n = 4096 on a sparse adjacency (+inf
     off the edges) against the plain squarings, exact, its slices on the
     Num form; then (c) the times in turns: B1 float64 on both tiles beside
     ``torch.matmul`` at 8192^3, 4096^3, 2048^3 and 16 x 1024^3, B3 float64
     under each semiring at 4096^3 beside its bound (min_plus also on
     +inf-holding operands), float64 APSP beside fp32 APSP.

Slice 3's checks: B4 equal to its plain version exactly (every int32
diagonal is exact and the fp32 combine runs in the same order), B5's
hi + lo within 1e-15 of the largest plain output; the tiers' normwise error
|C - AB| / (|a_i| |b_j|) against float64 ``torch.matmul`` on the card below
the JAX tests' bounds (i8x2 3e-4, i8x3 2e-6, i8x4 below i8x3 and under
2^-22 Frobenius), Ozaki below 1e-13 (int8) and 1e-14 (bf16); graph results
equal to plain Floyd-Warshall exactly (integer weights: every sum exact),
PageRank within 1e-5; gradients within 1e-5 (scaled) of plain autograd.

Tolerances (kernel vs plain version on the same inputs, on the card):
  exact for integer, bool and tropical results (min/max of identically
  rounded terms); relative 1e-4 for outputs summed in fp32 (both sum in
  fp32 in different orders over K <= 2048: about sqrt(K) * 2^-24 per
  element); relative 1e-2 where the output is rounded to bf16 (one bf16
  ulp is 2^-8 relative).  Outputs of mixed-sign operands (epilogues,
  softmax, attention, gradients) can cancel to near zero, so there the
  relative error is taken against |ref| + max|ref| ("scaled").  The
  trainers' losses: relative 1e-2 per step in bf16, 1e-3 in fp32.  The
  plain fp32 matmul runs without TF32.

Slice 4's checks: each flash kernel against its plain version on the same
card operands (relative 1e-2 scaled for bf16 / fp16 outputs, 1e-4 for
fp32; lse 1e-4, -inf on the same rows; outputs finite where stale cache
slots hold NaN / inf); the 4-D front door against the plain version on CPU
copies; fp32 gradients within 1e-4 (scaled) of float64 autograd.  The case
tables of phase 13 are also the card tests' (``tests/test_torch_kernels.py``).

Any mismatch or exception ends the run with a non-zero exit.  The last
three lines are the card's name and power limit, one JSON line on the
kernels (each with its launches on its slice's main path, its time, its
plain version's and the library call's where one exists, and its bound
from ``models/perf_model.py``), and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

F32_RTOL = 1e-4
BF16_RTOL = 1e-2
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
EPILOGUES = ["bias", "bias_relu", "bias_sigmoid", "bias_tanh", "col_scale",
             "scale_bias", "bias_gelu"]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def compare(torch, got, ref, rtol: float, what: str, scaled: bool = False):
    """Max abs and rel error of ``got`` against ``ref``; NaN and +-inf must
    sit at the same places.  ``scaled``: relative to |ref| + max|ref|.
    Raises on a mismatch."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                             f"{ref.shape}/{ref.dtype}")
    if not got.is_floating_point():
        bad = int((got != ref).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} elements differ (exact)")
        return 0.0, 0.0
    g, r = got.double(), ref.double()
    nan_r = torch.isnan(r)
    if not torch.equal(torch.isnan(g), nan_r):
        raise AssertionError(f"{what}: NaN positions differ")
    inf_r = torch.isinf(r)
    if not torch.equal(g[inf_r], r[inf_r]) or bool(torch.isinf(g[~inf_r]).any()):
        raise AssertionError(f"{what}: inf positions differ")
    fin = ~(nan_r | inf_r)
    if not bool(fin.any()):
        return 0.0, 0.0
    diff = (g[fin] - r[fin]).abs()
    scale = r[fin].abs() + (r[fin].abs().max() if scaled else 0.0)
    rel = diff / scale.clamp_min(1e-30)
    max_abs, max_rel = float(diff.max()), float(rel.max())
    if max_rel > rtol:
        raise AssertionError(f"{what}: max rel err {max_rel:.3e} > {rtol:g} "
                             f"(max abs {max_abs:.3e})")
    return max_abs, max_rel


def operands(torch, m, n, k, dtype, ta=False, tb=False, seed=5):
    """Seeded U(1,10) operands (int8: U{1..3} so int32 counts stay small)."""
    from gemm_hls_tpu_torch.utils.verify import make_operands
    hi = 3.0 if dtype == torch.int8 else 10.0
    draw = "int32" if not dtype.is_floating_point else "float32"
    a, b = make_operands(m, n, k, draw, seed=seed, high=hi,
                         transpose_a=ta, transpose_b=tb)
    return (torch.from_numpy(a).to("cuda", dtype),
            torch.from_numpy(b).to("cuda", dtype))


# B1's two tensor-core routes (``ops.mxu.mxu_route``), case tables of
# phases 3a and 6a that tests/test_torch_kernels.py parametrises too:
# (dtype, out dtype, ta, tb, M, N, K, pitched, epilogue, route).  pitched:
# each operand a view into rows of whole 16-byte units plus one unit, so
# M, N and K off every tile still reach the engine.  bf16 and fp16 in the
# four layouts (ragged through pitched views, and aligned contiguous),
# every output type, tiny shapes; int8 on the engine where both operands
# are K-major and on WMMA in the other layouts; rows whose pitch is not a
# whole 16-byte unit on WMMA.
B1_ROUTE_CASES = (
    [(dt, dt, ta, tb, 1000, 1030, 1100, True, None, "wgmma")
     for dt in ("bfloat16", "float16") for ta, tb in LAYOUTS]
    + [(dt, "float32", ta, tb, 264, 384, 512, False, None, "wgmma")
       for dt in ("bfloat16", "float16") for ta, tb in LAYOUTS]
    + [("bfloat16", "float16", False, False, 304, 520, 264, False, None, "wgmma"),
       ("float16", "bfloat16", True, True, 304, 520, 264, False, None, "wgmma"),
       ("bfloat16", "bfloat16", False, True, 1, 1, 1, True, None, "wgmma"),
       ("float16", "float32", True, False, 7, 13, 5, True, None, "wgmma"),
       ("int8", "int32", False, True, 1000, 1030, 1100, True, None, "wgmma"),
       ("int8", "int32", False, True, 257, 384, 512, False, None, "wgmma"),
       ("int8", "int32", True, True, 257, 384, 512, False, None, "wmma")]
    + [("int8", out, False, True, 300, 520, 272, False, None, "wgmma")
       for out in ("int8", "float32", "bfloat16", "float16")]
    + [("int8", "int32", ta, tb, 272, 384, 512, False, None, "wmma")
       for ta, tb in LAYOUTS if (ta, tb) != (False, True)]
    + [("bfloat16", "bfloat16", False, False, 64, 72, 100, False, None, "wmma"),
       ("float16", "float32", False, True, 65, 140, 131, False, None, "wmma"),
       ("bfloat16", "float32", False, False, 64, 130, 128, False, None, "wmma")]
)
# Each epilogue on the engine route: bf16 (bf16 operands) and fp16 (fp16
# operands) outputs, int8 inputs to fp32 (every kind) and to int32 (the
# exact kinds: sigmoid / tanh / gelu would flip a truncated int on a one-ulp
# difference next to an integer).
B1_EPILOGUE_ROUTE_CASES = (
    [("bfloat16", "bfloat16", False, False, 1000, 1030, 1100, True, ep, "wgmma")
     for ep in EPILOGUES]
    + [("float16", "float16", True, True, 304, 520, 264, False, ep, "wgmma") for ep in EPILOGUES]
    + [("int8", "float32", False, True, 300, 520, 272, False, ep, "wgmma") for ep in EPILOGUES]
    + [("int8", "int32", False, True, 300, 520, 272, False, ep, "wgmma")
       for ep in EPILOGUES if ep not in ("bias_sigmoid", "bias_tanh", "bias_gelu")]
)
# The race check of the engine route: B1_REPEAT_CASE launched B1_REPEATS
# times, the same bits each.
B1_REPEAT_CASE = ("bfloat16", "float32", False, False, 1000, 1030, 1100, True, None, "wgmma")
B1_REPEATS = 20
# B2's routes (``ops.mxu.mxu_route``, one rule with B1's), phase 6's case
# table that tests/test_torch_kernels.py parametrises too: (dtype, out
# dtype, ta, tb, batch, M, N, K, pitched, broadcast ("a" / "b": that
# operand 2-D), epilogue, route).  Each engine case runs again on WMMA
# through the route override.  The engine: bf16 and fp16 in the four
# layouts with M, N and K off the tiles (K 136 and 200: not whole 64-deep
# slabs) through pitched views, aligned contiguous operands to fp32, a
# broadcast 2-D a, a transposed 3-D a against a 2-D b (and the other two
# pairings), a batch of one, M = N = K = 1, attention's p . v at N = 128
# (half a tile), a batch past gridDim.z's 65535, every per-column
# epilogue, int8 -> int32 and int8 -> fp32 with an epilogue (both
# operands K-major).  WMMA: int8 in the other layouts, rows whose pitch is
# not a whole 16-byte unit.  fp32 on the CUDA cores.
B2_ROUTE_CASES = (
    [(dt, dt, ta, tb, 3, 200, 300, 136, True, None, None, "wgmma")
     for dt in ("bfloat16", "float16") for ta, tb in LAYOUTS]
    + [("bfloat16", "float32", ta, tb, 4, 256, 256, 512, False, None, None, "wgmma")
       for ta, tb in LAYOUTS]
    + [("bfloat16", "bfloat16", False, False, 5, 130, 264, 200, True, "a", None, "wgmma"),
       ("bfloat16", "float32", True, False, 5, 130, 264, 200, True, "b", None, "wgmma"),
       ("float16", "float16", True, True, 3, 72, 520, 136, False, "b", None, "wgmma"),
       ("bfloat16", "bfloat16", False, True, 3, 72, 520, 136, False, "a", None, "wgmma"),
       ("bfloat16", "bfloat16", False, False, 1, 300, 520, 264, False, None, None, "wgmma"),
       ("float16", "float32", True, False, 7, 1, 1, 1, True, None, None, "wgmma"),
       ("bfloat16", "bfloat16", False, False, 2, 1024, 128, 1024, False, None, None, "wgmma"),
       ("bfloat16", "float32", False, True, 70_000, 3, 8, 8, False, None, None, "wgmma")]
    + [("bfloat16", "bfloat16", False, True, 5, 300, 1030, 200, True, None, ep, "wgmma")
       for ep in EPILOGUES]
    + [("int8", "int32", False, True, 3, 257, 384, 272, False, None, None, "wgmma"),
       ("int8", "int32", False, True, 3, 200, 300, 136, True, None, None, "wgmma"),
       ("int8", "float32", False, True, 3, 200, 300, 272, False, None, "bias_relu", "wgmma"),
       ("int8", "int32", True, False, 3, 257, 384, 272, False, None, None, "wmma"),
       ("int8", "int32", False, False, 3, 257, 384, 272, False, None, None, "wmma"),
       ("bfloat16", "bfloat16", False, False, 3, 64, 72, 100, False, None, None, "wmma"),
       ("float16", "float32", True, True, 2, 65, 140, 131, False, None, None, "wmma"),
       ("float32", "float32", False, False, 3, 65, 140, 131, False, None, None, "simt")]
)
# The race check of B2's engine route.
B2_REPEAT_CASE = ("bfloat16", "float32", True, False, 16, 300, 520, 264, True, None, None, "wgmma")
B2_REPEATS = 20
# B2's row-softmax routes (``ops.mxu.row_softmax_route``), phase 6c's case
# table that tests/test_torch_kernels.py parametrises too: (dtype, out
# dtype, ta, tb, batch, M, N, K, pitched, broadcast, scale (A's values
# times it: scores large enough that exp underflows for most columns),
# route).  Each engine case runs again on row_softmax.cu through the route
# override.  The engine: bf16 and fp16 in the four layouts with M, N and K
# off the tiles through pitched views, every output type, K 256 (its
# limit), N = ROW_SOFTMAX_MAX_N, a broadcast 2-D a / b, a batch of one, a
# batch past gridDim's 65535, large scores.  row_softmax.cu: fp32, a row
# pitch that is not a whole 16-byte unit, K 320, rows of P of 258 bytes.
ROW_SOFTMAX_ROUTE_CASES = (
    [(dt, dt, ta, tb, 3, 200, 520, 136, True, None, 1, "wgmma")
     for dt in ("bfloat16", "float16") for ta, tb in LAYOUTS]
    + [("bfloat16", "float32", ta, tb, 2, 300, 1000, 72, True, None, 1, "wgmma")
       for ta, tb in LAYOUTS]
    + [("float16", "float32", False, True, 2, 130, 300, 256, True, None, 1, "wgmma"),
       ("bfloat16", "float16", True, True, 2, 64, 200, 40, True, None, 1, "wgmma"),
       ("float16", "bfloat16", False, False, 2, 17, 3200, 64, False, None, 1, "wgmma"),
       ("bfloat16", "bfloat16", False, True, 4, 100, 264, 128, False, "a", 1, "wgmma"),
       ("float16", "float16", True, False, 4, 100, 264, 128, True, "b", 1, "wgmma"),
       ("bfloat16", "bfloat16", False, True, 1, 1000, 1024, 128, False, None, 1, "wgmma"),
       ("bfloat16", "float32", False, True, 70_000, 3, 8, 8, False, None, 1, "wgmma"),
       ("bfloat16", "bfloat16", False, True, 2, 256, 1024, 128, False, None, 40, "wgmma"),
       ("float16", "float32", True, False, 2, 256, 1024, 128, False, None, 40, "wgmma"),
       ("float32", "float32", False, True, 3, 200, 520, 136, False, None, 1, "simt"),
       ("bfloat16", "bfloat16", False, False, 3, 64, 200, 100, False, None, 1, "wmma"),
       ("bfloat16", "float32", False, True, 2, 100, 264, 320, False, None, 1, "wmma"),
       ("float16", "float16", False, True, 2, 100, 129, 64, False, None, 1, "wmma")]
)
# The race check of the row softmax's engine route.
ROW_SOFTMAX_REPEAT_CASE = ("bfloat16", "float32", True, False, 16, 300, 1000, 200, True, None, 1,
                           "wgmma")
ROW_SOFTMAX_REPEATS = 20


def pitched(torch, gen, rows, cols, dtype, pitch, lead=()):
    """(*lead, rows, cols) on the card, U(-1, 1) or int8 in [-3, 3]; with
    ``pitch``, a view into rows of whole 16-byte units plus one unit."""
    per = 16 // dtype.itemsize
    width = (cols + per - 1) // per * per + per if pitch else cols
    shape = (*lead, rows, width)
    if dtype == torch.int8:
        x = torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dtype)
    else:
        x = signed(torch, shape, dtype, gen)
    return x[..., :cols]


def b1_route_case(torch, gen, case):
    """One B1_ROUTE_CASES / B1_EPILOGUE_ROUTE_CASES case against the plain
    version, the route checked; returns the largest abs error."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    dt, out, ta, tb, m, n, k, pitch, ep_name, route = case
    dtype, out_dtype = getattr(torch, dt), getattr(torch, out)
    a = pitched(torch, gen, *((k, m) if ta else (m, k)), dtype, pitch)
    b = pitched(torch, gen, *((n, k) if tb else (k, n)), dtype, pitch)
    ep = get_epilogue(ep_name) if ep_name else None
    floats = dtype.is_floating_point
    eps = [signed(torch, (n,), dtype if floats else torch.float32, gen) * (1 if floats else 20)
           for _ in range(ep.n_operands if ep else 0)]
    kw = dict(cfg=default_config(dtype, out_dtype=out), transpose_a=ta, transpose_b=tb,
              epilogue=ep)
    got = mxu.mxu_matmul(a, b, *eps, **kw)
    if mxu.mxu_matmul.last_route != route:
        raise AssertionError(f"B1 {case}: route {mxu.mxu_matmul.last_route}")
    rtol = (0.0 if not out_dtype.is_floating_point
            else F32_RTOL if out_dtype == torch.float32 else BF16_RTOL)
    return compare(torch, got, mxu.mxu_matmul_plain(a, b, *eps, **kw), rtol, f"B1 {case}",
                   scaled=True)[0]


def b1_repeats(torch, gen):
    """B1_REPEAT_CASE launched B1_REPEATS times on the same operands: every
    launch gives the first one's bits."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    dt, out, ta, tb, m, n, k, pitch, _, route = B1_REPEAT_CASE
    dtype = getattr(torch, dt)
    a = pitched(torch, gen, m, k, dtype, pitch)
    b = pitched(torch, gen, k, n, dtype, pitch)
    cfg = default_config(dtype, out_dtype=out)
    first = mxu.mxu_matmul(a, b, cfg=cfg)
    if mxu.mxu_matmul.last_route != route:
        raise AssertionError(f"B1 {B1_REPEAT_CASE}: route {mxu.mxu_matmul.last_route}")
    for i in range(B1_REPEATS - 1):
        if not torch.equal(first, mxu.mxu_matmul(a, b, cfg=cfg)):
            raise AssertionError(f"B1: launch {i + 2} of {B1_REPEAT_CASE} differs from the first")


def b2_route_operands(torch, gen, case):
    """(a, b, epilogue operands, keyword arguments) of a B2_ROUTE_CASES
    case, on the card."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    dt, out, ta, tb, bsz, m, n, k, pitch, bcast, ep_name, _ = case
    dtype = getattr(torch, dt)
    a = pitched(torch, gen, *((k, m) if ta else (m, k)), dtype, pitch,
                () if bcast == "a" else (bsz,))
    b = pitched(torch, gen, *((n, k) if tb else (k, n)), dtype, pitch,
                () if bcast == "b" else (bsz,))
    ep = get_epilogue(ep_name) if ep_name else None
    floats = dtype.is_floating_point
    eps = [signed(torch, (n,), dtype if floats else torch.float32, gen) * (1 if floats else 20)
           for _ in range(ep.n_operands if ep else 0)]
    return a, b, eps, dict(cfg=default_config(dtype, out_dtype=out), transpose_a=ta,
                           transpose_b=tb, epilogue=ep)


def b2_route_case(torch, gen, case, route=None):
    """One B2_ROUTE_CASES case on the route it names (or on ``route``, the
    override) against the plain version, the route checked; returns the
    largest abs error."""
    from gemm_hls_tpu_torch.ops import mxu
    a, b, eps, kw = b2_route_operands(torch, gen, case)
    got = mxu.mxu_matmul_batched(a, b, *eps, route=route, **kw)
    if mxu.mxu_matmul_batched.last_route != (route or case[-1]):
        raise AssertionError(f"B2 {case}: route {mxu.mxu_matmul_batched.last_route}")
    out_dtype = got.dtype
    rtol = (0.0 if not out_dtype.is_floating_point
            else F32_RTOL if out_dtype == torch.float32 else BF16_RTOL)
    return compare(torch, got, mxu.mxu_matmul_plain(a, b, *eps, **kw), rtol,
                   f"B2 {case} on {route or case[-1]}", scaled=True)[0]


def b2_repeats(torch, gen):
    """B2_REPEAT_CASE launched B2_REPEATS times on the same operands: every
    launch gives the first one's bits."""
    from gemm_hls_tpu_torch.ops import mxu
    a, b, _, kw = b2_route_operands(torch, gen, B2_REPEAT_CASE)
    first = mxu.mxu_matmul_batched(a, b, **kw)
    if mxu.mxu_matmul_batched.last_route != B2_REPEAT_CASE[-1]:
        raise AssertionError(f"B2 {B2_REPEAT_CASE}: route {mxu.mxu_matmul_batched.last_route}")
    for i in range(B2_REPEATS - 1):
        if not torch.equal(first, mxu.mxu_matmul_batched(a, b, **kw)):
            raise AssertionError(f"B2: launch {i + 2} of {B2_REPEAT_CASE} differs from the first")


def row_softmax_route_operands(torch, gen, case):
    """(a, b, keyword arguments) of a ROW_SOFTMAX_ROUTE_CASES case, on the
    card: B2_ROUTE_CASES' operands, A scaled in place (a pitched view stays
    one), the softmax epilogue."""
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    *head, scale, route = case
    a, b, _, kw = b2_route_operands(torch, gen, (*head, None, route))
    a.mul_(scale)
    kw["epilogue"] = get_epilogue("softmax")
    return a, b, kw


def row_softmax_route_case(torch, gen, case, route=None):
    """One ROW_SOFTMAX_ROUTE_CASES case on the route it names (or on
    ``route``, the override) against the plain version, the route checked,
    every row summing to 1 within 4 rtol; returns the largest abs error."""
    from gemm_hls_tpu_torch.ops import mxu
    a, b, kw = row_softmax_route_operands(torch, gen, case)
    got = mxu.mxu_matmul_batched(a, b, route=route, **kw)
    want = route or case[-1]
    if mxu.mxu_matmul_batched.row_softmax_route != want:
        raise AssertionError(f"B2 row-softmax {case}: route "
                             f"{mxu.mxu_matmul_batched.row_softmax_route}")
    rtol = F32_RTOL if got.dtype == torch.float32 else BF16_RTOL
    what = f"B2 row-softmax {case} on {want}"
    err = compare(torch, got, mxu.mxu_matmul_plain(a, b, **kw), rtol, what, scaled=True)[0]
    worst = float((got.double().sum(-1) - 1).abs().max())
    if not worst <= 4 * rtol:
        raise AssertionError(f"{what}: a row sums to 1 + {worst:.3e}")
    return err


def row_softmax_repeats(torch, gen):
    """ROW_SOFTMAX_REPEAT_CASE launched ROW_SOFTMAX_REPEATS times on the same
    operands: every launch gives the first one's bits."""
    from gemm_hls_tpu_torch.ops import mxu
    case = ROW_SOFTMAX_REPEAT_CASE
    a, b, kw = row_softmax_route_operands(torch, gen, case)
    first = mxu.mxu_matmul_batched(a, b, **kw)
    if mxu.mxu_matmul_batched.row_softmax_route != case[-1]:
        raise AssertionError(f"B2 row-softmax {case}: route "
                             f"{mxu.mxu_matmul_batched.row_softmax_route}")
    for i in range(ROW_SOFTMAX_REPEATS - 1):
        if not torch.equal(first, mxu.mxu_matmul_batched(a, b, **kw)):
            raise AssertionError(f"B2 row-softmax: launch {i + 2} of {case} differs from "
                                 f"the first")


def phase_b1(torch):
    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config, dtype_name
    from gemm_hls_tpu_torch.ops import mxu

    shapes = [(65, 140, 131), (1, 1, 1), (7, 13, 5), (33, 129, 130),
              (1024, 1024, 1024), (1000, 1030, 1100)]
    cases = [(torch.bfloat16, torch.bfloat16, BF16_RTOL),
             (torch.bfloat16, torch.float32, F32_RTOL),
             (torch.float16, torch.float32, F32_RTOL),
             (torch.float32, torch.float32, F32_RTOL),
             (torch.int8, torch.int32, 0.0),
             (torch.int32, torch.int32, 0.0)]
    worst = 0.0
    for dt, out_dt, rtol in cases:
        for ta in (False, True):
            for tb in (False, True):
                for m, n, k in shapes:
                    cfg = default_config(dt, out_dtype=dtype_name(out_dt))
                    a, b = operands(torch, m, n, k, dt, ta, tb)
                    got = mxu.mxu_matmul(a, b, cfg=cfg, transpose_a=ta,
                                         transpose_b=tb)
                    ref = mxu.mxu_matmul_plain(a, b, cfg=cfg, transpose_a=ta,
                                               transpose_b=tb)
                    torch.cuda.synchronize()
                    _, rel = compare(torch, got, ref, rtol,
                                     f"B1 {dt}->{out_dt} ta={ta} tb={tb} "
                                     f"{(m, n, k)}")
                    worst = max(worst, rel)
    log(f"phase 3a: B1 vs plain, {len(cases) * 4 * len(shapes)} cases: ok "
        f"(worst rel err {worst:.3e})")
    gen = torch.Generator(device="cuda").manual_seed(8)
    worst = max(b1_route_case(torch, gen, c) for c in B1_ROUTE_CASES)
    b1_repeats(torch, gen)
    log(f"phase 3a: B1 route cases, {len(B1_ROUTE_CASES)} (the wgmma engine: bf16 / fp16 "
        f"in four layouts, int8 K-major, ragged through pitched views, every output type; "
        f"WMMA: int8 in the other layouts, unaligned pitches): ok, route checked each "
        f"(worst abs err {worst:.3e}); {B1_REPEATS} engine launches, the same bits")

    # Bool or_and through B1 (int8 -> int32 counts): a sparse case, and an
    # all-true K=256 one whose count is a multiple of 256.
    gen = torch.Generator(device="cuda").manual_seed(7)
    for ta in (False, True):
        for tb in (False, True):
            m, n, k = 300, 257, 1025
            a = torch.rand((k, m) if ta else (m, k), generator=gen,
                           device="cuda") < 0.01
            b = torch.rand((n, k) if tb else (k, n), generator=gen,
                           device="cuda") < 0.01
            got = matmul(a, b, semiring="or_and", transpose_a=ta,
                         transpose_b=tb)
            ref = matmul(a, b, semiring="or_and", transpose_a=ta,
                         transpose_b=tb, backend="torch")
            compare(torch, got, ref, 0.0, f"or_and ta={ta} tb={tb}")
    ones = torch.ones((4, 256), dtype=torch.bool, device="cuda")
    got = matmul(ones, ones.T.contiguous(), semiring="or_and")
    if not bool(got.all()):
        raise AssertionError("or_and: all-true K=256 gave False")
    log("phase 3b: bool or_and via B1 vs plain, 4 layouts + K=256 count: ok")

    # Gradients: the backward is B1 again with flipped transpose flags.
    m, n, k = 1024, 1536, 2048
    for dt, rtol in ((torch.float32, F32_RTOL), (torch.bfloat16, BF16_RTOL)):
        for ta in (False, True):
            for tb in (False, True):
                a, b = operands(torch, m, n, k, dt, ta, tb, seed=11)
                g = operands(torch, m, n, 1, dt, seed=12)[1].expand(m, n) * 0.5
                grads = []
                for backend in (None, "torch"):
                    x = a.clone().requires_grad_()
                    y = b.clone().requires_grad_()
                    out = matmul(x, y, transpose_a=ta, transpose_b=tb,
                                 backend=backend)
                    out.backward(g)
                    grads.append((x.grad, y.grad))
                torch.cuda.synchronize()
                for name, got, ref in (("dA", grads[0][0], grads[1][0]),
                                       ("dB", grads[0][1], grads[1][1])):
                    compare(torch, got, ref, rtol,
                            f"grad {name} {dt} ta={ta} tb={tb}")
    log(f"phase 3c: B1 gradients vs plain autograd at {m}x{n}x{k}, "
        f"f32 + bf16, 4 layouts: ok")


def phase_b3(torch):
    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import vpu
    from gemm_hls_tpu_torch.ops.semiring import available_semirings, get_semiring

    exact = {"min_plus", "max_plus", "max_min", "min_max", "max_times"}
    shapes = [(65, 140, 131), (7, 13, 5), (1000, 1030, 1100),
              (2048, 2047, 2049)]
    n_cases = 0
    for name in available_semirings():
        if name == "or_and":
            continue
        sr = get_semiring(name)
        dts = [torch.float32, torch.bfloat16]
        if name != "log_plus":
            dts.append(torch.int32)
        for dt in dts:
            for (m, n, k), (ta, tb) in zip(shapes, [(False, False), (True, False),
                                                    (False, True), (True, True)]):
                cfg = default_config(dt, semiring=name)
                a, b = operands(torch, m, n, k, dt, ta, tb, seed=3)
                got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr, transpose_a=ta,
                                     transpose_b=tb)
                ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr,
                                           transpose_a=ta, transpose_b=tb)
                torch.cuda.synchronize()
                rtol = 0.0 if (name in exact or dt == torch.int32) else (
                    BF16_RTOL if dt == torch.bfloat16 else F32_RTOL)
                compare(torch, got, ref, rtol,
                        f"B3 {name} {dt} ta={ta} tb={tb} {(m, n, k)}")
                n_cases += 1
    log(f"phase 4a: B3 vs plain, {n_cases} semiring/dtype/shape cases: ok")

    # NaN and +-inf inputs: min/max semirings must propagate NaN (fminf
    # would drop it) and treat infinities exactly.
    m, n, k = 300, 257, 333
    for name in sorted(exact):
        sr = get_semiring(name)
        cfg = default_config(torch.float32, semiring=name)
        a, b = operands(torch, m, n, k, torch.float32, seed=4)
        a[3, 10] = float("nan")
        b[20, 7] = float("nan")
        a[5, :] = float("inf")
        b[:, 9] = float("-inf")
        a[100, 50] = float("-inf")
        got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr)
        ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr)
        compare(torch, got, ref, 0.0, f"B3 {name} NaN/inf")
    # log_plus: an all -inf row gives -inf (logaddexp(-inf, -inf) = -inf).
    sr = get_semiring("log_plus")
    cfg = default_config(torch.float32, semiring="log_plus")
    a, b = operands(torch, m, n, k, torch.float32, seed=6)
    a[7, :] = float("-inf")
    got = vpu.vpu_matmul(a, b, cfg=cfg, sr=sr)
    ref = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr)
    compare(torch, got, ref, F32_RTOL, "B3 log_plus -inf row")
    if not bool(torch.isneginf(got[7]).all()):
        raise AssertionError("log_plus: all -inf row is not -inf")
    # Bool or_and bit-packed on B3 (backend="vpu").
    gen = torch.Generator(device="cuda").manual_seed(9)
    for k in (1, 31, 33, 257, 2049):
        a = torch.rand((129, k), generator=gen, device="cuda") < 0.05
        b = torch.rand((k, 200), generator=gen, device="cuda") < 0.05
        got = matmul(a, b, semiring="or_and", backend="vpu")
        ref = matmul(a, b, semiring="or_and", backend="torch")
        compare(torch, got, ref, 0.0, f"B3 or_and bits K={k}")
    log("phase 4b: B3 NaN/+-inf, log_plus -inf rows, bit-packed or_and: ok")


def phase_main(torch):
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.tools import run

    runs = {
        "B1": ["8192", "8192", "8192", "--dtype", "bfloat16", "--verify",
               "off", "--baseline", "--iters", "20"],
        "B3": ["4096", "4096", "4096", "--dtype", "float32", "--semiring",
               "min_plus", "--verify", "off", "--baseline", "--iters", "5"],
    }
    mxu.mxu_matmul.launches = 0
    vpu.vpu_matmul.launches = 0
    results = {key: run.run(argv) for key, argv in runs.items()}
    launches = {"B1": mxu.mxu_matmul.launches, "B3": vpu.vpu_matmul.launches}
    log(f"phase 5a: main-path launch counts {launches}")
    for key, res in results.items():
        rtol = BF16_RTOL if key == "B1" else 0.0
        max_abs, max_rel = compare(torch, res["out"], res["plain_out"], rtol,
                                   f"main path {key} vs plain")
        if not res["ok"]:
            raise AssertionError(f"main path {key}: tools.run reported failure")
        out = res["out"]
        if not bool(torch.isfinite(out.float()).all()) or out.shape != (
                res["m"], res["n"]):
            raise AssertionError(f"main path {key}: bad output")
        res["max_abs_err"], res["max_rel_err"] = max_abs, max_rel
        log(f"phase 5b: {key} {res['m']}x{res['n']}x{res['k']} {res['dtype']} "
            f"{res['semiring']}"
            + (f" (route {mxu.mxu_matmul.last_route})" if key == "B1" else "")
            + f": {res['seconds'] * 1e3:.3f} ms "
            f"({res['gops']:.1f} GOp/s) vs plain "
            f"{res['plain_seconds'] * 1e3:.3f} ms ({res['plain_gops']:.1f} "
            f"GOp/s); max abs err {max_abs:.3e}, max rel {max_rel:.3e}")
    for key, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {key} was not launched on the main path")

    for argv in (["1024", "1024", "1024", "--dtype", "bfloat16"],
                 ["1024", "1024", "1024", "--dtype", "float32", "--semiring",
                  "min_plus"]):
        if run.main(argv + ["--iters", "3"]) != 0:
            raise AssertionError(f"tools.run {' '.join(argv)}: verification failed")
    log("phase 5c: tools.run host-oracle verification at 1024^3 (bf16, "
        "min_plus): ok")
    return results, launches


def time_turns(torch, fns, rounds=5, iters=20):
    """{name: device ms a call} of the zero-argument callables ``fns``, timed
    in turns: each round profiles ``iters`` calls of each in the same order
    (torch.profiler, the device time of every kernel a call launches), so a
    drift of the card's clock or of a neighbour's load falls on all of them
    alike, and a wrapper's host cost (tens of microseconds a call, more than
    a kernel of that size takes) does not count as the kernel's; the median
    of the rounds."""
    import statistics

    from torch.profiler import ProfilerActivity, profile
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            times[name].append(sum(us for _, us in device_kernels(prof)) / iters / 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def event_turns(torch, fns, rounds=3, iters=3):
    """{name: ms a call} of the zero-argument callables ``fns`` on CUDA
    events (``time_fn``), in turns: each round times every callable once,
    in the same order; the median of the rounds.  For millisecond kernels,
    whose wrapper's host cost is below their device time."""
    from gemm_hls_tpu_torch.utils.benchmark import time_fn
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_fn(fn, [()], iters=iters, warmup=1) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def signed(torch, shape, dtype, gen):
    """Seeded U(-1, 1) on the card, in ``dtype``."""
    return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1).to(dtype)


SLICE2_KERNELS = ("B1", "B1 epilogue", "B2", "B2 row-softmax", "B3")


def counters():
    from gemm_hls_tpu_torch.ops import mxu, slice_kernels, vpu
    return {"B1": mxu.mxu_matmul.launches,
            "B1 epilogue": mxu.mxu_matmul.epilogue_launches,
            "B2": mxu.mxu_matmul_batched.launches,
            "B2 row-softmax": mxu.mxu_matmul_batched.row_softmax_launches,
            "B3": vpu.vpu_matmul.launches,
            "B4": slice_kernels.fused_int8_fp32.launches,
            "B5": slice_kernels.fused_ozaki_int8.launches,
            # Slice 22's generated functors (counted in B1 epilogue / B2 / B3
            # too): user semirings on B3, callable epilogues on B1 / B2.
            "B3 generated": sum(vpu.vpu_matmul.generated_launches.values()),
            "B1 generated epilogue": sum(mxu.generated_launches.values())}


def reset_counters():
    from gemm_hls_tpu_torch.ops import mxu, slice_kernels, vpu
    mxu.mxu_matmul.launches = mxu.mxu_matmul.epilogue_launches = 0
    mxu.mxu_matmul_batched.launches = 0
    mxu.mxu_matmul_batched.row_softmax_launches = 0
    mxu.route_launches.clear()
    mxu.dmma_tile_launches.clear()
    vpu.vpu_matmul.launches = 0
    vpu.vpu_matmul.dtype_launches.clear()
    vpu.vpu_matmul.generated_launches.clear()
    mxu.generated_launches.clear()
    slice_kernels.fused_int8_fp32.launches = 0
    slice_kernels.fused_ozaki_int8.launches = 0


def phase_b2(torch):
    from gemm_hls_tpu_torch.config import ROW_SOFTMAX_MAX_N, default_config, dtype_name
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    from gemm_hls_tpu_torch.ops.semiring import get_semiring

    gen = torch.Generator(device="cuda").manual_seed(21)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    float_cases = [(bf16, bf16, BF16_RTOL), (bf16, f32, F32_RTOL),
                   (f16, f32, F32_RTOL), (f32, f32, F32_RTOL)]

    def cfg_of(dt, out):
        return default_config(dt, out_dtype=dtype_name(out))

    def operand(bsz, rows, cols, t, dt):
        shape = (cols, rows) if t else (rows, cols)
        return signed(torch, (bsz,) + shape if bsz else shape, dt, gen)

    n_cases = 0
    for dt, out, rtol in float_cases:
        for ta, tb in LAYOUTS:
            for name in EPILOGUES:
                ep = get_epilogue(name)
                for m, n, k in ((65, 140, 131), (1000, 1030, 1100)):
                    a, b = operand(0, m, k, ta, dt), operand(0, k, n, tb, dt)
                    eps = [signed(torch, (n,), bf16 if dt == bf16 else f32, gen)
                           for _ in range(ep.n_operands)]
                    kw = dict(cfg=cfg_of(dt, out), transpose_a=ta,
                              transpose_b=tb, epilogue=ep)
                    got = mxu.mxu_matmul(a, b, *eps, **kw)
                    ref = mxu.mxu_matmul_plain(a, b, *eps, **kw)
                    compare(torch, got, ref, rtol, f"B1 {name} {dt}->{out} "
                            f"ta={ta} tb={tb} {(m, n, k)}", scaled=True)
                    n_cases += 1
    # Integer inputs: the exact int32 accumulator widened to fp32 for the
    # epilogue.  An int32 output of sigmoid / tanh / gelu would flip on a one-ulp
    # difference next to an integer, so it takes the exact epilogues only.
    m, n, k = 1000, 1030, 1100
    for dt, out in ((torch.int8, torch.int32), (torch.int8, f32), (torch.int32, f32)):
        for ta, tb in LAYOUTS:
            for name in EPILOGUES:
                if out == torch.int32 and name in ("bias_sigmoid", "bias_tanh", "bias_gelu"):
                    continue
                ep = get_epilogue(name)
                a, b = (torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dt)
                        for shape in ((k, m) if ta else (m, k), (n, k) if tb else (k, n)))
                eps = [signed(torch, (n,), f32, gen) * 20 for _ in range(ep.n_operands)]
                kw = dict(cfg=cfg_of(dt, out), transpose_a=ta, transpose_b=tb,
                          epilogue=ep)
                compare(torch, mxu.mxu_matmul(a, b, *eps, **kw),
                        mxu.mxu_matmul_plain(a, b, *eps, **kw),
                        0.0 if out == torch.int32 else F32_RTOL,
                        f"B1 {name} {dt}->{out} ta={ta} tb={tb}", scaled=True)
                n_cases += 1
    for case in B1_EPILOGUE_ROUTE_CASES:
        b1_route_case(torch, gen, case)
    log(f"phase 6a: B1 with each epilogue vs plain, {n_cases} cases "
        f"(float and integer inputs) and {len(B1_EPILOGUE_ROUTE_CASES)} on the wgmma "
        f"engine: ok")

    n_cases = 0
    shapes = [(7, 33, 65, 17), (3, 130, 257, 77), (2, 1000, 1030, 1100)]
    for dt, out, rtol in float_cases + [(torch.int8, torch.int32, 0.0)]:
        for ta, tb in LAYOUTS:
            for bsz, m, n, k in shapes:
                for bcast in (None, "a", "b"):
                    if dt == torch.int8:
                        a = torch.randint(-3, 4, (bsz,) + ((k, m) if ta else (m, k)),
                                          generator=gen, device="cuda").to(dt)
                        b = torch.randint(-3, 4, (bsz,) + ((n, k) if tb else (k, n)),
                                          generator=gen, device="cuda").to(dt)
                    else:
                        a, b = operand(bsz, m, k, ta, dt), operand(bsz, k, n, tb, dt)
                    a = a[0] if bcast == "a" else a
                    b = b[0] if bcast == "b" else b
                    kw = dict(cfg=cfg_of(dt, out), transpose_a=ta, transpose_b=tb)
                    got = mxu.mxu_matmul_batched(a, b, **kw)
                    ref = mxu.mxu_matmul_plain(a, b, **kw)
                    compare(torch, got, ref, rtol, f"B2 {dt}->{out} ta={ta} "
                            f"tb={tb} {(bsz, m, n, k)} broadcast={bcast}",
                            scaled=True)
                    n_cases += 1
    for name in EPILOGUES:
        ep = get_epilogue(name)
        a, b = operand(5, 300, 200, False, bf16), operand(5, 200, 1030, True, bf16)
        eps = [signed(torch, (1030,), f32, gen) for _ in range(ep.n_operands)]
        kw = dict(cfg=cfg_of(bf16, bf16), transpose_b=True, epilogue=ep)
        compare(torch, mxu.mxu_matmul_batched(a, b, *eps, **kw),
                mxu.mxu_matmul_plain(a, b, *eps, **kw), BF16_RTOL,
                f"B2 {name}", scaled=True)
        n_cases += 1
    log(f"phase 6b: B2 (plain + per-column epilogue) vs plain, {n_cases} "
        f"cases: ok")
    worst = max(b2_route_case(torch, gen, c) for c in B2_ROUTE_CASES)
    engine = [c for c in B2_ROUTE_CASES if c[-1] == "wgmma"]
    worst_old = max(b2_route_case(torch, gen, c, "wmma") for c in engine)
    b2_repeats(torch, gen)
    routes = {}
    for case in B2_ROUTE_CASES:
        routes[case[-1]] = routes.get(case[-1], 0) + 1
    log(f"phase 6b: B2 route cases, {len(B2_ROUTE_CASES)} {routes} (the wgmma engine: bf16 / "
        f"fp16 in four layouts, ragged M / N / K, broadcast 2-D a / b, batch 1 and 70000, N = "
        f"128, every epilogue, K-major int8; WMMA: int8 in other layouts, unaligned pitches; "
        f"fp32), each on its route: ok (worst abs err {worst:.3e}); the {len(engine)} engine "
        f"cases again on WMMA: ok ({worst_old:.3e}); {B2_REPEATS} engine launches of "
        f"{B2_REPEAT_CASE[:8]}: the same bits")

    n_cases = 0
    softmax = get_epilogue("softmax")
    for dt, out, rtol in [(bf16, bf16, BF16_RTOL), (bf16, f32, F32_RTOL),
                          (f16, f16, BF16_RTOL), (f32, f32, F32_RTOL)]:
        for ta, tb in LAYOUTS:
            for bsz, m, n, k in ((3, 33, 129, 40), (2, 17, ROW_SOFTMAX_MAX_N, 64),
                                 (4, 1024, 1024, 128)):
                a = operand(bsz, m, k, ta, dt) * 4
                b = operand(bsz, k, n, tb, dt)
                kw = dict(cfg=cfg_of(dt, out), transpose_a=ta, transpose_b=tb,
                          epilogue=softmax)
                got = mxu.mxu_matmul_batched(a, b, **kw)
                compare(torch, got, mxu.mxu_matmul_plain(a, b, **kw), rtol,
                        f"B2 row-softmax {dt}->{out} ta={ta} tb={tb} "
                        f"{(bsz, m, n, k)}", scaled=True)
                n_cases += 1
    log(f"phase 6c: B2 row-softmax vs plain, {n_cases} cases (N up to "
        f"{ROW_SOFTMAX_MAX_N}): ok")
    worst = max(row_softmax_route_case(torch, gen, c) for c in ROW_SOFTMAX_ROUTE_CASES)
    engine = [c for c in ROW_SOFTMAX_ROUTE_CASES if c[-1] == "wgmma"]
    worst_old = max(row_softmax_route_case(torch, gen, c, "wmma") for c in engine)
    row_softmax_repeats(torch, gen)
    routes = {}
    for case in ROW_SOFTMAX_ROUTE_CASES:
        routes[case[-1]] = routes.get(case[-1], 0) + 1
    log(f"phase 6c: B2 row-softmax route cases, {len(ROW_SOFTMAX_ROUTE_CASES)} {routes} (the "
        f"wgmma engine: bf16 / fp16 in four layouts, every output type, ragged M / N / K, K 256, "
        f"N = {ROW_SOFTMAX_MAX_N}, broadcast 2-D a / b, batch 1 and 70000, large scores; "
        f"row_softmax.cu: fp32, an unaligned pitch, K 320, 258-byte rows of P), each on its "
        f"route: ok (worst abs err {worst:.3e}); the {len(engine)} engine cases again on "
        f"row_softmax.cu: ok ({worst_old:.3e}); {ROW_SOFTMAX_REPEATS} engine launches of "
        f"{ROW_SOFTMAX_REPEAT_CASE[:8]}: the same bits")

    bsz = 70_000  # above gridDim.z's 65535: launched in two chunks
    a = signed(torch, (bsz, 3, 5), f32, gen)
    b = signed(torch, (bsz, 5, 4), f32, gen)
    cfg = default_config(f32)
    compare(torch, mxu.mxu_matmul_batched(a, b, cfg=cfg),
            mxu.mxu_matmul_plain(a, b, cfg=cfg), F32_RTOL, "B2 batch 70000",
            scaled=True)
    compare(torch, mxu.mxu_matmul_batched(a, b, cfg=cfg, epilogue=softmax),
            mxu.mxu_matmul_plain(a, b, cfg=cfg, epilogue=softmax), F32_RTOL,
            "B2 row-softmax batch 70000", scaled=True)
    for name in ("min_plus", "log_plus"):
        sr, scfg = get_semiring(name), default_config(f32, semiring=name)
        compare(torch, vpu.vpu_matmul(a, b, cfg=scfg, sr=sr),
                vpu.vpu_matmul_plain(a, b, cfg=scfg, sr=sr),
                0.0 if name == "min_plus" else F32_RTOL, f"B3 {name} batch 70000",
                scaled=True)
    log("phase 6d: batch 70000 at 3x4x5 (B2, B2 row-softmax, B3): ok")

    n_cases = 0
    for name in ("min_plus", "max_plus", "max_min", "plus_absdiff", "log_plus"):
        for dt in (f32, bf16, torch.int32):
            if name == "log_plus" and dt == torch.int32:
                continue
            sr, scfg = get_semiring(name), default_config(dt, semiring=name)
            for bcast in (None, "a", "b"):
                a, b = operands(torch, 130, 257, 77, dt, seed=31)
                a = torch.stack([a, a + 1, a + 2])
                b = torch.stack([b, b + 3, b])
                a = a[1] if bcast == "a" else a
                b = b[2] if bcast == "b" else b
                got = vpu.vpu_matmul(a, b, cfg=scfg, sr=sr)
                exact = name in ("min_plus", "max_plus", "max_min") or dt == torch.int32
                compare(torch, got, vpu.vpu_matmul_plain(a, b, cfg=scfg, sr=sr),
                        0.0 if exact else (BF16_RTOL if dt == bf16 else F32_RTOL),
                        f"B3 batched {name} {dt} broadcast={bcast}", scaled=True)
                n_cases += 1
    log(f"phase 6e: batched B3 vs plain, {n_cases} cases: ok")


def grads(torch, fn, xs, gen):
    """Gradients of <fn(*xs), G> for a seeded cotangent G."""
    xs = [x.detach().clone().requires_grad_() for x in xs]
    out = fn(*xs)
    g = signed(torch, out.shape, out.dtype, gen)
    torch.autograd.backward(out, g)
    return [x.grad for x in xs]


def phase_grads(torch):
    from gemm_hls_tpu_torch import fused_linear, matmul

    f32 = torch.float32
    n_cases = 0
    for ta, tb in LAYOUTS:
        for bcast in (None, "a", "b"):
            gen = torch.Generator(device="cuda").manual_seed(41)
            a = signed(torch, (3,) + ((150, 200) if ta else (200, 150)), f32, gen)
            b = signed(torch, (3,) + ((300, 150) if tb else (150, 300)), f32, gen)
            a = a[0] if bcast == "a" else a
            b = b[0] if bcast == "b" else b
            got = grads(torch, lambda x, y: matmul(x, y, transpose_a=ta,
                                                   transpose_b=tb), (a, b),
                        torch.Generator(device="cuda").manual_seed(4))
            ref = grads(torch, lambda x, y: matmul(x, y, transpose_a=ta,
                                                   transpose_b=tb, backend="torch"),
                        (a, b), torch.Generator(device="cuda").manual_seed(4))
            for name, g, r in zip("ab", got, ref):
                compare(torch, g, r, F32_RTOL, f"batched grad d{name} ta={ta} "
                        f"tb={tb} broadcast={bcast}", scaled=True)
            n_cases += 1
    acts = {"identity": lambda p: p, "relu": torch.relu, "sigmoid": torch.sigmoid,
            "tanh": torch.tanh}
    for act, f in acts.items():
        for lead in ((), (3,)):
            gen = torch.Generator(device="cuda").manual_seed(43)
            x = signed(torch, lead + (256, 384), f32, gen)
            w = signed(torch, (384, 1030), f32, gen)
            b = signed(torch, (1030,), f32, gen)
            got = grads(torch, lambda *t: fused_linear(*t, act), (x, w, b),
                        torch.Generator(device="cuda").manual_seed(5))
            ref = grads(torch, lambda x_, w_, b_: f(x_ @ w_ + b_), (x, w, b),
                        torch.Generator(device="cuda").manual_seed(5))
            for name, g, r in zip(("x", "w", "b"), got, ref):
                compare(torch, g, r, F32_RTOL, f"fused_linear {act} lead={lead} "
                        f"d{name}", scaled=True)
            n_cases += 1
    gen = torch.Generator(device="cuda").manual_seed(47)
    a = signed(torch, (4, 100, 128), f32, gen)
    b = signed(torch, (4, 128, 300), f32, gen)
    bias = signed(torch, (300,), f32, gen)
    got = grads(torch, lambda x, y, z: matmul(x, y, epilogue="bias_tanh",
                                              epilogue_operands=(z,)),
                (a, b, bias), torch.Generator(device="cuda").manual_seed(6))
    ref = grads(torch, lambda x, y, z: torch.tanh(x @ y + z), (a, b, bias),
                torch.Generator(device="cuda").manual_seed(6))
    for name, g, r in zip(("a", "b", "bias"), got, ref):
        compare(torch, g, r, F32_RTOL, f"batched epilogue recompute d{name}",
                scaled=True)
    log(f"phase 7: gradients vs plain autograd (batched {4 * 3} layouts x "
        f"broadcasts, fused_linear {len(acts) * 2}, batched epilogue "
        f"recompute): ok")


def plain_mlp_step(torch, params, batch, lr):
    """The plain reference trainer step: x @ W + b, relu, mse_loss,
    autograd, SGD.  Used only to compare against the port's step."""
    leaves = [t.detach().requires_grad_() for wb in params for t in wb]
    h = batch[0]
    for i in range(0, len(leaves), 2):
        h = h @ leaves[i] + leaves[i + 1]
        if i + 2 < len(leaves):
            h = torch.relu(h)
    loss = torch.nn.functional.mse_loss(h, batch[1])
    gs = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = [p - lr * g for p, g in zip(leaves, gs)]
    return list(zip(new[::2], new[1::2])), loss.detach()


def run_trainer(torch, dims, tokens, dtype, fused, lr=0.1, steps=5):
    """(losses, step seconds) of the port's trainer and of the plain one,
    both from the same seeded parameters and batch."""
    from gemm_hls_tpu_torch.models import mlp

    out = {}
    for who in ("port", "plain"):
        params = mlp.init_params(torch.Generator(device="cuda").manual_seed(0),
                                 dims, dtype)
        batch = mlp.make_batch(torch.Generator(device="cuda").manual_seed(1),
                               tokens, dims[0], dims[-1], dtype)
        losses, secs = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if who == "port":
                params, loss = mlp.train_step(params, batch, lr=lr, fused=fused)
            else:
                params, loss = plain_mlp_step(torch, params, batch, lr)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        out[who] = (losses, secs, params)
    return out


def ops_in(torch, fn):
    """Names of the aten ops ``fn`` dispatches (its kernels' launches go
    through ctypes and show as none)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.__name__)
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def phase_slice2(torch):
    from gemm_hls_tpu_torch import attention, matmul
    from gemm_hls_tpu_torch.config import ROW_SOFTMAX_MAX_N
    from gemm_hls_tpu_torch.models import mlp
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    reset_counters()
    # 8a/8b: the trainer, fused and unfused, against the plain trainer.
    for key, dims, tokens, dtype, rtol in (
            ("bf16", (4096, 16384, 4096), 8192, torch.bfloat16, BF16_RTOL),
            ("fp32", (1024, 4096, 1024), 2048, torch.float32, 1e-3)):
        for fused in (True, False):
            ep_before = mxu.mxu_matmul.epilogue_launches
            run = run_trainer(torch, dims, tokens, dtype, fused)
            ep_launches = mxu.mxu_matmul.epilogue_launches - ep_before
            (losses, secs, params), (p_losses, p_secs, _) = run["port"], run["plain"]
            for i, (l, pl) in enumerate(zip(losses, p_losses)):
                if not (abs(l - pl) <= rtol * abs(pl)):
                    raise AssertionError(f"trainer {key} fused={fused} step {i}: "
                                         f"loss {l} vs plain {pl}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"trainer {key} fused={fused}: loss did "
                                     f"not decrease: {losses}")
            if fused != (ep_launches > 0):
                raise AssertionError(f"trainer {key} fused={fused}: {ep_launches} "
                                     f"B1 epilogue launches")
            step = statistics.median(secs[1:])
            log(f"phase 8a: trainer {key} dims {dims} x {tokens} tokens "
                f"fused={fused}: losses {[round(v, 4) for v in losses]} vs plain "
                f"{[round(v, 4) for v in p_losses]}; step {step * 1e3:.1f} ms "
                f"(plain {statistics.median(p_secs[1:]) * 1e3:.1f} ms); "
                f"B1 epilogue launches {ep_launches}")
        if key == "bf16":
            # No separate bias or activation pass in the fused forward.
            x = mlp.make_batch(torch.Generator(device="cuda").manual_seed(1), tokens,
                               dims[0], dims[-1], dtype)[0]
            pointwise = ("add", "relu", "threshold", "clamp", "maximum", "mul")
            with torch.no_grad():
                fused_ops = ops_in(torch, lambda: mlp.mlp_forward(params, x, fused=True))
                unfused_ops = ops_in(torch, lambda: mlp.mlp_forward(params, x))
            bad = [o for o in fused_ops if o.split(".")[0] in pointwise]
            if bad or not any(o.split(".")[0] in pointwise for o in unfused_ops):
                raise AssertionError(f"fused forward ran {bad}; unfused ran "
                                     f"{unfused_ops}")
            log(f"phase 8a: fused forward dispatched only {sorted(set(fused_ops))}; "
                f"the unfused one also {sorted(set(unfused_ops) - set(fused_ops))}")
            build = REPO / "gemm_hls_tpu_torch" / "build"
            build.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=build) as d:
                path = save_checkpoint(str(Path(d) / "mlp.npz"), params)
                back = load_checkpoint(path, like=params)
            if not all(torch.equal(u, v) for pu, pv in zip(params, back)
                       for u, v in zip(pu, pv)):
                raise AssertionError("checkpoint round trip changed the params")
            log("phase 8a: checkpoint round trip of the bf16 params: ok")

    # 8c/8d: fused-scores attention (its row softmax on the engine), and
    # rows past the fused bound.
    gen = torch.Generator(device="cuda").manual_seed(51)
    row_routes = {}
    for key, (bh, s, d) in (("attention", (32, 1024, 128)),
                            ("attention long", (8, 8192, 128))):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        before = mxu.mxu_matmul_batched.row_softmax_launches
        mxu.mxu_matmul_batched.row_softmax_route = None
        out = attention(q, k, v)
        fused = mxu.mxu_matmul_batched.row_softmax_launches - before
        if fused != (1 if s <= ROW_SOFTMAX_MAX_N else 0):
            raise AssertionError(f"{key}: {fused} row-softmax launches")
        if fused:
            row_routes[key] = mxu.mxu_matmul_batched.row_softmax_route
            if row_routes[key] != "wgmma":
                raise AssertionError(f"{key}: row softmax on {row_routes[key]}, the rule "
                                     f"gives wgmma")
        ref = plain_attention(torch, q, k, v)
        max_abs, max_rel = compare(torch, out, ref, BF16_RTOL, key, scaled=True)
        if out.shape != q.shape or not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"{key}: bad output")
        log(f"phase 8c: {key} ({bh}, {s}, {d}) bf16, "
            f"{f'fused row softmax on {row_routes[key]}' if fused else 'unfused branch'}: "
            f"max abs err {max_abs:.3e}, scaled rel {max_rel:.3e}")
        del q, k, v, out, ref
    # 8e: attention's gradient against plain autograd.
    gen = torch.Generator(device="cuda").manual_seed(53)
    qkv = [signed(torch, (8, 512, 64), torch.float32, gen) for _ in range(3)]
    got = grads(torch, attention, qkv, torch.Generator(device="cuda").manual_seed(7))
    ref = grads(torch, lambda q, k, v: torch.softmax(q @ k.transpose(1, 2) / 8.0, -1) @ v,
                qkv, torch.Generator(device="cuda").manual_seed(7))
    for name, g, r in zip("qkv", got, ref):
        compare(torch, g, r, F32_RTOL, f"attention grad d{name}", scaled=True)
    log("phase 8e: attention gradient at (8, 512, 64) fp32 vs plain autograd: ok")

    # 8f: batched GEMMs through the front door, each B2 launch's route
    # recorded: the aligned bf16 calls take the engine, int8 with a
    # row-major B WMMA, fp32 the CUDA cores.
    n_cases, routes = 0, {}

    def checked(what, want, fn, ref, rtol, scaled=True):
        before = mxu.mxu_matmul_batched.launches
        got = fn()
        if mxu.mxu_matmul_batched.launches > before:
            routes[what] = mxu.mxu_matmul_batched.last_route
            if routes[what] != want:
                raise AssertionError(f"{what}: B2 route {routes[what]}, the rule gives {want}")
        compare(torch, got, ref(), rtol, what, scaled=scaled)

    for bsz, sz in ((64, 512), (256, 128)):
        for ta, tb in LAYOUTS:
            a = signed(torch, (bsz, sz, sz), torch.bfloat16, gen)
            b = signed(torch, (bsz, sz, sz), torch.bfloat16, gen)
            kw = dict(transpose_a=ta, transpose_b=tb)
            checked(f"bf16 {bsz}x{sz}^3 ta={int(ta)} tb={int(tb)}", "wgmma",
                    lambda: matmul(a, b, **kw), lambda: matmul(a, b, backend="torch", **kw),
                    BF16_RTOL)
            n_cases += 1
    a8 = torch.randint(-100, 100, (64, 512, 512), generator=gen, device="cuda",
                       dtype=torch.int8)
    b8 = torch.randint(-100, 100, (64, 512, 512), generator=gen, device="cuda",
                       dtype=torch.int8)
    checked("int8 batched", "wmma", lambda: matmul(a8, b8, out_dtype="int32"),
            lambda: matmul(a8, b8, out_dtype="int32", backend="torch"), 0.0, scaled=False)
    a32, b32 = (signed(torch, (64, 512, 512), torch.float32, gen) for _ in range(2))
    checked("fp32 batched", "simt", lambda: matmul(a32, b32),
            lambda: matmul(a32, b32, backend="torch"), F32_RTOL)
    w = b32[0].to(torch.bfloat16)
    ab = a32.to(torch.bfloat16)
    for kw in (dict(transpose_a=True), dict()):  # broadcast 2-D b: B2, and one B1
        checked(f"broadcast 2-D b {kw}", "wgmma", lambda: matmul(ab, w, **kw),
                lambda: matmul(ab, w, backend="torch", **kw), BF16_RTOL)
    checked("broadcast 2-D a", "wgmma", lambda: matmul(w, ab),
            lambda: matmul(w, ab, backend="torch"), BF16_RTOL)
    a4 = ab.reshape(8, 8, 512, 512)
    checked("4-D leading dims", "wgmma", lambda: matmul(a4, a4),
            lambda: matmul(a4, a4, backend="torch"), BF16_RTOL)
    am, bm = (signed(torch, (16, 512, 512), torch.float32, gen) for _ in range(2))
    compare(torch, matmul(am, bm, semiring="min_plus"),
            matmul(am, bm, semiring="min_plus", backend="torch"), 0.0,
            "batched min_plus")
    n_cases += 7
    log(f"phase 8f: batched matmul vs plain, {n_cases} cases (64x512^3 and "
        f"256x128^3 bf16 four layouts, int8, fp32, broadcast, 4-D, min_plus): ok; "
        f"B2 routes {routes}")

    launches = {k: v for k, v in counters().items() if k in SLICE2_KERNELS}
    log(f"phase 8: main-path launch counts {launches}; row-softmax routes {row_routes}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice 2 "
                                 f"main path")
    return launches, row_routes


def plain_attention(torch, q, k, v):
    """The plain version of ``attention``: the plain row-softmax GEMM, then
    the plain batched GEMM, from the same rounded-scale q."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue

    cfg = default_config(q.dtype)
    qs = q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    p = mxu.mxu_matmul_plain(qs, k, cfg=cfg, transpose_b=True,
                             epilogue=get_epilogue("softmax"))
    return mxu.mxu_matmul_plain(p, v, cfg=cfg)


def b2_times(torch, gen):
    """B2 at 64 x 512^3, 256 x 128^3 and attention's p . v (32 x 1024 x
    1024 . 1024 x 128: N = 128, half the engine's 256-wide tile), bf16, on
    device time in turns: the route the rule gives, the other tensor-core
    route, the plain version and torch.bmm (launches here are comparisons,
    not the main path's)."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.models.perf_model import H100
    from gemm_hls_tpu_torch.ops import mxu

    bf16, cfg, out = torch.bfloat16, default_config(torch.bfloat16), {}
    for key, (bsz, m, n, k) in (("B2 64x512^3", (64, 512, 512, 512)),
                                ("B2 256x128^3", (256, 128, 128, 128)),
                                ("B2 p.v 32x1024x128x1024", (32, 1024, 128, 1024))):
        a = signed(torch, (bsz, m, k), bf16, gen)
        c = signed(torch, (bsz, k, n), bf16, gen)
        fns = {"kernel": lambda a=a, c=c: mxu.mxu_matmul_batched(a, c, cfg=cfg)}
        ref = mxu.mxu_matmul_plain(a, c, cfg=cfg)
        err = compare(torch, fns["kernel"](), ref, BF16_RTOL, key, scaled=True)[0]
        route = mxu.mxu_matmul_batched.last_route
        other = "wmma" if route == "wgmma" else "wgmma"
        fns[other] = lambda a=a, c=c, o=other: mxu.mxu_matmul_batched(a, c, cfg=cfg, route=o)
        compare(torch, fns[other](), ref, BF16_RTOL, f"{key} {other}", scaled=True)
        fns["plain"] = lambda a=a, c=c: mxu.mxu_matmul_plain(a, c, cfg=cfg)
        fns["library"] = lambda a=a, c=c: torch.bmm(a, c)
        compare(torch, fns["library"](), ref, BF16_RTOL, f"{key} torch.bmm", scaled=True)
        turns = time_turns(torch, fns)
        bound = H100.bound(2.0 * bsz * m * n * k, H100.peak_for("bfloat16"),
                           bsz * (m * k + k * n + m * n) * 2)
        out[key] = dict(ms=turns["kernel"], plain_ms=turns["plain"],
                        library_ms=turns["library"], max_abs_err=err, route=route,
                        other_route=other, other_ms=turns[other], bound=bound)
        log(f"phase 9: {key} bf16: {turns['kernel']:.4f} ms (route {route}; {other} "
            f"{turns[other]:.4f} ms) vs plain {turns['plain']:.4f} ms, torch.bmm "
            f"{turns['library']:.4f} ms (device time in turns), bound "
            f"{bound[0] * 1e3:.4f} ms ({bound[1]}); max abs err {err:.3e}")
        del a, c, ref
    return out


def row_softmax_times(torch, gen):
    """B2's row softmax at the attention scores' shape (32 x 1024^2 x 128
    bf16, k held (N, K)) on device time in turns: the route the rule gives
    (the engine), row_softmax.cu through the route override, the plain
    version, the fp32-softmax composition torch.softmax(torch.bmm(q, k^T)
    .float(), -1).to(bf16) and the fastest two-call one, torch.softmax(
    torch.bmm(q, k^T), -1) in bf16 (its scores rounded to bf16 before the
    softmax: looser numerics; no one PyTorch call computes the function);
    then ``attention`` (32, 1024, 128) beside its plain composition.
    Launches here are comparisons, not the main path's."""
    from gemm_hls_tpu_torch import attention
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.models.perf_model import H100
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue

    bf16, cfg, sm = torch.bfloat16, default_config(torch.bfloat16), get_epilogue("softmax")
    bsz, m, n, k = 32, 1024, 1024, 128
    q, kk, v = (torch.randn((bsz, s, k), generator=gen, device="cuda", dtype=bf16)
                for s in (m, n, n))
    kw = dict(cfg=cfg, transpose_b=True, epilogue=sm)
    ref = mxu.mxu_matmul_plain(q, kk, **kw)
    fns = {"kernel": lambda: mxu.mxu_matmul_batched(q, kk, **kw)}
    err = compare(torch, fns["kernel"](), ref, BF16_RTOL, "B2 row-softmax", scaled=True)[0]
    route = mxu.mxu_matmul_batched.row_softmax_route
    other = "wmma" if route == "wgmma" else "wgmma"
    fns[other] = lambda: mxu.mxu_matmul_batched(q, kk, route=other, **kw)
    compare(torch, fns[other](), ref, BF16_RTOL, f"B2 row-softmax {other}", scaled=True)
    fns["plain"] = lambda: mxu.mxu_matmul_plain(q, kk, **kw)
    # Both compositions round the scores to bf16 (torch.bmm's output), so
    # they are not held to the plain version's tolerance: their largest
    # difference from it is printed.
    fns["fp32 softmax of bmm"] = lambda: torch.softmax(
        torch.bmm(q, kk.transpose(1, 2)).float(), -1).to(bf16)
    fns["bf16 softmax of bmm"] = lambda: torch.softmax(torch.bmm(q, kk.transpose(1, 2)), -1)
    loose = {name: float((fns[name]().float() - ref.float()).abs().max())
             for name in ("fp32 softmax of bmm", "bf16 softmax of bmm")}
    turns = time_turns(torch, fns)
    # One pass of products; q, k and P, each once.
    bound = H100.bound(2.0 * bsz * m * n * k, H100.peak_for("bfloat16"),
                       (bsz * m * k + bsz * n * k + bsz * m * n) * 2)
    out = {"B2 row-softmax": dict(
        ms=turns["kernel"], plain_ms=turns["plain"], max_abs_err=err, route=route,
        other_route=other, other_ms=turns[other], bound=bound,
        fp32_softmax_of_bmm_ms=turns["fp32 softmax of bmm"],
        bf16_softmax_of_bmm_ms=turns["bf16 softmax of bmm"])}
    log(f"phase 9: B2 row-softmax {bsz}x{m}x{n}x{k} bf16: {turns['kernel']:.4f} ms (route "
        f"{route}; {other} {turns[other]:.4f} ms) vs plain {turns['plain']:.4f} ms; two "
        f"calls: torch.softmax(bmm).float() -> bf16 {turns['fp32 softmax of bmm']:.4f} ms, "
        f"torch.softmax(bmm) in bf16 {turns['bf16 softmax of bmm']:.4f} ms (device time in "
        f"turns; their max abs differences from plain {loose['fp32 softmax of bmm']:.3e} / "
        f"{loose['bf16 softmax of bmm']:.3e}); bound {bound[0] * 1e3:.4f} ms ({bound[1]}); "
        f"max abs err {err:.3e}")
    ref = plain_attention(torch, q, kk, v)
    fns = {"attention": lambda: attention(q, kk, v),
           "plain": lambda: plain_attention(torch, q, kk, v)}
    att_err = compare(torch, fns["attention"](), ref, BF16_RTOL, "attention", scaled=True)[0]
    turns = time_turns(torch, fns)
    out["attention (32, 1024, 128)"] = dict(ms=turns["attention"], plain_ms=turns["plain"],
                                            max_abs_err=att_err)
    log(f"phase 9: attention (32, 1024, 128) bf16: {turns['attention']:.4f} ms vs plain "
        f"{turns['plain']:.4f} ms (device time in turns); max abs err {att_err:.3e}")
    return out


def phase_times(torch):
    """Kernel vs plain times at the main path's shapes (launches here are
    comparisons, not the main path's)."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    gen = torch.Generator(device="cuda").manual_seed(61)
    bf16 = torch.bfloat16
    out = {}

    def entry(key, fn, plain, args, iters, rtol, extra=None, library=None):
        got, ref = fn(*args), plain(*args)
        max_abs, _ = compare(torch, got, ref, rtol, key, scaled=True)
        ms = time_fn(fn, [args], iters=iters) * 1e3
        plain_ms = time_fn(plain, [args], iters=iters) * 1e3
        out[key] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs)
        line = f"phase 9: {key}: {ms:.3f} ms vs plain {plain_ms:.3f} ms"
        for name, call in [x for x in (extra, library) if x]:
            e_ms = time_fn(call, [args], iters=iters) * 1e3
            line += f" ({name} {e_ms:.3f} ms)"
        if library:
            # The one PyTorch call computing the same function, held to the
            # plain version like the kernel.
            compare(torch, library[1](*args), ref, rtol, f"{key}: {library[0]}", scaled=True)
            out[key]["library_ms"] = e_ms
        log(line + f"; max abs err {max_abs:.3e}"
            + (f"; route {mxu.mxu_matmul.last_route}" if key.startswith("B1") else ""))

    # B1 with bias_relu at the trainer's first layer, beside cuBLASLt's fused
    # bias + ReLU epilogue.
    x = signed(torch, (8192, 4096), bf16, gen)
    w = signed(torch, (4096, 16384), bf16, gen) * 0.02
    b = signed(torch, (16384,), bf16, gen)
    ep, cfg = get_epilogue("bias_relu"), default_config(bf16)
    entry("B1 epilogue", lambda x_, w_, b_: mxu.mxu_matmul(x_, w_, b_, cfg=cfg, epilogue=ep),
          lambda x_, w_, b_: mxu.mxu_matmul_plain(x_, w_, b_, cfg=cfg, epilogue=ep),
          (x, w, b), 10, BF16_RTOL,
          ("torch.relu(x @ w + b) in bf16", lambda x_, w_, b_: torch.relu(x_ @ w_ + b_)),
          ("torch._addmm_activation(b, x, w)",
           lambda x_, w_, b_: torch._addmm_activation(b_, x_, w_)))
    del x, w, b
    out.update(b2_times(torch, gen))
    out.update(row_softmax_times(torch, gen))
    from gemm_hls_tpu_torch import matmul

    # Phase 8f's batched calls through the front door, beside the torch
    # call that computes the same thing (torch.bmm / torch.matmul; for int8
    # and min_plus, which cuBLAS does not take, the plain version).
    def tr(x, t):
        return x.transpose(-1, -2) if t else x

    for bsz, sz in ((64, 512), (256, 128)):
        a = signed(torch, (bsz, sz, sz), bf16, gen)
        c = signed(torch, (bsz, sz, sz), bf16, gen)
        for ta, tb in LAYOUTS:
            entry(f"matmul bf16 {bsz}x{sz}^3 ta={int(ta)} tb={int(tb)}",
                  lambda a_, c_, ta=ta, tb=tb: matmul(a_, c_, transpose_a=ta,
                                                      transpose_b=tb),
                  lambda a_, c_, ta=ta, tb=tb: torch.bmm(tr(a_, ta), tr(c_, tb)),
                  (a, c), 20, BF16_RTOL)
    a8, c8 = (torch.randint(-100, 100, (64, 512, 512), generator=gen,
                            device="cuda", dtype=torch.int8) for _ in range(2))
    entry("matmul int8->int32 64x512^3", lambda x, y: matmul(x, y, out_dtype="int32"),
          lambda x, y: matmul(x, y, out_dtype="int32", backend="torch"),
          (a8, c8), 20, 0.0)
    a32, c32 = (signed(torch, (64, 512, 512), torch.float32, gen) for _ in range(2))
    entry("matmul fp32 64x512^3", matmul, torch.bmm, (a32, c32), 10, F32_RTOL)
    ab, w = a32.to(bf16), c32[0].to(bf16)
    entry("matmul broadcast 2-D b (ta) 64x512^3",
          lambda x, y: matmul(x, y, transpose_a=True),
          lambda x, y: torch.matmul(x.transpose(1, 2), y), (ab, w), 20, BF16_RTOL)
    entry("matmul broadcast 2-D a 64x512^3", matmul, torch.matmul, (w, ab), 20,
          BF16_RTOL)
    a4 = ab.reshape(8, 8, 512, 512)
    entry("matmul 4-D 8x8x512^3", matmul, torch.matmul, (a4, a4), 20, BF16_RTOL)
    am, cm = (signed(torch, (16, 512, 512), torch.float32, gen) for _ in range(2))
    entry("matmul min_plus 16x512^3", lambda x, y: matmul(x, y, semiring="min_plus"),
          lambda x, y: matmul(x, y, semiring="min_plus", backend="torch"),
          (am, cm), 5, 0.0)
    return out


# ---------------------------------------------------------------------------
# Slice 3: the integer-slice kernels B4 / B5, the precision tiers, Ozaki,
# the graph applications and the semiring gradients
# ---------------------------------------------------------------------------

def int8_slices(torch, n, rows, cols, gen):
    return torch.randint(-127, 128, (n, rows, cols), generator=gen,
                         device="cuda", dtype=torch.int8)


# B5's two routes (``ops.slice_kernels.ozaki_route``), phase 10b's case
# table that tests/test_torch_kernels.py parametrises too: (n_slices,
# n_diags, block_k, (M, N, K), layout, route).  layout "kmajor": B's slices
# as (K, N) views of (N, K) storage; "pitched": both as views into rows of
# whole 16-byte units plus one (K off every slab on the engine);
# "rowmajor": B's slices row-major (K, N), transposed once by the wrapper.
# 1-8 slices, n_diags up to 9 (past 2 n - 1: diagonals without a pair),
# block_k 128, 256 and 2048 on the engine (one and several K blocks, a
# last block one deep), 64 and 192 on mma.sync, unaligned K.
OZAKI_ROUTE_CASES = (
    [(ns, min(ns + 1, 9), 2048, (257, 130, 1024), "kmajor", "wgmma") for ns in range(1, 9)]
    + [(8, 9, 128, (130, 260, 640), "kmajor", "wgmma"),
       (8, 8, 256, (1024, 1024, 2048), "kmajor", "wgmma"),
       (8, 9, 2048, (1024, 1024, 4096), "kmajor", "wgmma"),
       (6, 4, 256, (200, 300, 768), "kmajor", "wgmma"),
       (3, 9, 256, (64, 64, 512), "kmajor", "wgmma"),
       (4, 5, 256, (65, 140, 1000), "pitched", "wgmma"),
       (2, 3, 2048, (33, 129, 4097), "pitched", "wgmma"),
       (3, 4, 2048, (65, 140, 1024), "rowmajor", "wgmma"),
       (3, 4, 2048, (65, 140, 131), "kmajor", "mma.sync"),
       (8, 9, 64, (257, 130, 1024), "kmajor", "mma.sync"),
       (4, 5, 192, (100, 100, 512), "kmajor", "mma.sync")]
)
# The race check of the engine route.
OZAKI_REPEAT_CASE = (8, 9, 256, (300, 520, 1024), "kmajor", "wgmma")
OZAKI_REPEATS = 20


# B4's two routes (``ops.slice_kernels.diag_route``), phase 10a's case
# table that tests/test_torch_kernels.py parametrises too: (n_slices,
# n_diags, (M, N, K), layout, ulps, fill, route).  layout "stacked": (n, M,
# K) / (n, K, N) tensors, B row-major (the wrapper transposes it once);
# "split": tuples of per-slice tensors, B's slices (K, N) views of (N, K)
# storage; "kmajor": the stacked form of those views; "pitched": tuples of
# views into rows of whole 16-byte units plus one (K off every slab on the
# engine); "rowmajor": tuples, B's slices row-major.  fill "max": every A
# value 127 and every B value -127, K at the whole-K bound's last 16-byte
# multiple (each P_d at its largest).  The engine: 2, 3 and 4 slices,
# n_diags 1 and below n_slices, ragged M, N and K, K off the 128 slab, with
# and without ulps.  mma.sync: more than 4 diagonals, rows that are not
# whole 16-byte units.
DIAG_ROUTE_CASES = (
    [(ns, ns, (257, 130, 1024), layout, ulps, "rand", "wgmma")
     for ns, layout, ulps in ((2, "stacked", False), (3, "split", True), (4, "kmajor", True),
                              (3, "rowmajor", False), (4, "stacked", True))]
    + [(3, 2, (130, 260, 640), "kmajor", True, "rand", "wgmma"),
       (4, 3, (200, 300, 768), "split", False, "rand", "wgmma"),
       (4, 2, (64, 64, 512), "kmajor", True, "rand", "wgmma"),
       (2, 1, (100, 70, 256), "split", True, "rand", "wgmma"),
       (3, 3, (65, 140, 1000), "pitched", True, "rand", "wgmma"),
       (4, 4, (33, 129, 4000), "pitched", False, "rand", "wgmma"),
       (2, 2, (1, 1, 16), "split", True, "rand", "wgmma"),
       (3, 3, (1000, 1000, 2048), "kmajor", True, "rand", "wgmma"),
       (2, 2, (16, 128, 66560), "stacked", False, "max", "wgmma"),
       (3, 3, (8, 64, 44368), "stacked", True, "max", "wgmma"),
       (4, 4, (8, 64, 33280), "stacked", False, "max", "wgmma"),
       (8, 8, (100, 100, 512), "kmajor", True, "rand", "mma.sync"),
       (3, 5, (100, 100, 512), "split", False, "rand", "mma.sync"),
       (3, 3, (65, 140, 131), "kmajor", True, "rand", "mma.sync"),
       (2, 2, (65, 140, 1000), "rowmajor", False, "rand", "mma.sync")]
)
# Each engine case again on mma.sync (the route override).
DIAG_RUNS = ([(case, None) for case in DIAG_ROUTE_CASES]
             + [(case, "mma.sync") for case in DIAG_ROUTE_CASES if case[-1] == "wgmma"])
# The race check of the engine route.
DIAG_REPEAT_CASE = (3, 3, (300, 520, 1024), "kmajor", True, "rand", "wgmma")
DIAG_REPEATS = 20


def b4_route_operands(torch, gen, case):
    """(sa, sb, ulps) of a DIAG_ROUTE_CASES case, in its layout."""
    ns, _, (m, n, k), layout, scaled, fill, _ = case
    if fill == "max":
        sa = torch.full((ns, m, k), 127, dtype=torch.int8, device="cuda")
        sb = torch.full((ns, k, n), -127, dtype=torch.int8, device="cuda")
    else:
        kp = (k + 15) // 16 * 16 + 16 if layout == "pitched" else k
        sa = int8_slices(torch, ns, m, kp, gen)[:, :, :k]
        if layout in ("stacked", "rowmajor"):
            sb = int8_slices(torch, ns, k, n, gen)
        else:
            sb = int8_slices(torch, ns, n, kp, gen)[:, :, :k].transpose(1, 2)
    ulps = ()
    if scaled:
        ulps = tuple(torch.exp2(torch.randint(-9, 3, shape, generator=gen, device="cuda").float())
                     for shape in ((m, 1), (1, n)))
    if layout in ("stacked", "kmajor"):
        return sa, sb, ulps
    return tuple(sa), tuple(sb), ulps


def diag_route_case(torch, gen, case, route=None):
    """One B4 route case on its route (or ``route``, the override), checked,
    against the plain version: equal bit for bit."""
    from gemm_hls_tpu_torch.ops import slice_kernels as sk
    n_diags = case[1]
    sa, sb, ulps = b4_route_operands(torch, gen, case)
    got = sk.fused_int8_fp32(sa, sb, *ulps, n_diags=n_diags, route=route)
    if sk.fused_int8_fp32.last_route != (route or case[-1]):
        raise AssertionError(f"B4 {case}: route {sk.fused_int8_fp32.last_route}")
    ref = sk.fused_int8_fp32_plain(list(sa), list(sb), *ulps, n_diags=n_diags)
    if not torch.equal(got, ref):
        raise AssertionError(f"B4 {case} on {route or case[-1]}: {int((got != ref).sum())} "
                             f"elements differ from the plain version")


def diag_repeats(torch, gen):
    """DIAG_REPEAT_CASE launched DIAG_REPEATS times: the same bits each."""
    from gemm_hls_tpu_torch.ops import slice_kernels as sk
    sa, sb, ulps = b4_route_operands(torch, gen, DIAG_REPEAT_CASE)
    first = sk.fused_int8_fp32(sa, sb, *ulps, n_diags=DIAG_REPEAT_CASE[1])
    if sk.fused_int8_fp32.last_route != DIAG_REPEAT_CASE[-1]:
        raise AssertionError(f"B4 {DIAG_REPEAT_CASE}: route {sk.fused_int8_fp32.last_route}")
    for i in range(DIAG_REPEATS - 1):
        if not torch.equal(first, sk.fused_int8_fp32(sa, sb, *ulps, n_diags=DIAG_REPEAT_CASE[1])):
            raise AssertionError(f"B4: launch {i + 2} of {DIAG_REPEAT_CASE} differs from the first")


def b5_route_operands(torch, gen, case):
    """(stacked A slices (n, M, K), B slices (n, K, N)) of an
    OZAKI_ROUTE_CASES case."""
    ns, _, _, (m, n, k), layout, _ = case
    kp = (k + 15) // 16 * 16 + 16 if layout == "pitched" else k
    sa = int8_slices(torch, ns, m, kp, gen)[:, :, :k]
    if layout == "rowmajor":
        return sa, int8_slices(torch, ns, k, n, gen)
    return sa, int8_slices(torch, ns, n, kp, gen)[:, :, :k].transpose(1, 2)


def b5_route_case(torch, gen, case):
    """One B5 route case against the plain version: (hi + lo's error over
    the largest output, whether hi and lo are both bit-identical)."""
    from gemm_hls_tpu_torch.ops import slice_kernels as sk
    _, n_diags, block_k, _, _, route = case
    sa, sb = b5_route_operands(torch, gen, case)
    hi, lo = sk.fused_ozaki_int8(sa, sb, block_k=block_k, n_diags=n_diags)
    if sk.fused_ozaki_int8.last_route != route:
        raise AssertionError(f"B5 {case}: route {sk.fused_ozaki_int8.last_route}")
    rhi, rlo = sk.fused_ozaki_int8_plain(list(sa), list(sb), block_k=block_k, n_diags=n_diags)
    ref = rhi.double() + rlo.double()
    err = float((hi.double() + lo.double() - ref).abs().max()) / (float(ref.abs().max()) or 1.0)
    if err > 1e-15:
        raise AssertionError(f"B5 {case}: hi + lo off by {err:.3e} of the largest output")
    return err, bool(torch.equal(hi, rhi) and torch.equal(lo, rlo))


def b5_repeats(torch, gen):
    """OZAKI_REPEAT_CASE launched OZAKI_REPEATS times: the same bits each."""
    from gemm_hls_tpu_torch.ops import slice_kernels as sk
    _, n_diags, block_k, _, _, route = OZAKI_REPEAT_CASE
    sa, sb = b5_route_operands(torch, gen, OZAKI_REPEAT_CASE)
    first = sk.fused_ozaki_int8(sa, sb, block_k=block_k, n_diags=n_diags)
    if sk.fused_ozaki_int8.last_route != route:
        raise AssertionError(f"B5 {OZAKI_REPEAT_CASE}: route {sk.fused_ozaki_int8.last_route}")
    for i in range(OZAKI_REPEATS - 1):
        got = sk.fused_ozaki_int8(sa, sb, block_k=block_k, n_diags=n_diags)
        if not all(torch.equal(x, y) for x, y in zip(first, got)):
            raise AssertionError(f"B5: launch {i + 2} of {OZAKI_REPEAT_CASE} differs from the first")


def phase_b45(torch):
    """Kernels B4 and B5 against their plain versions on the card."""
    from gemm_hls_tpu_torch.ops import slice_kernels as sk

    gen = torch.Generator(device="cuda").manual_seed(71)
    shapes = [(1, 1, 1), (65, 140, 131), (33, 129, 4097), (257, 130, 1000),
              (1024, 1024, 2048)]
    n4 = n5 = exact5 = 0
    worst5 = 0.0
    for ns in (2, 3, 4, 8):
        for m, n, k in shapes:
            sa, sb = int8_slices(torch, ns, m, k, gen), int8_slices(torch, ns, k, n, gen)
            ua = torch.exp2(torch.randint(-9, 3, (m, 1), generator=gen,
                                          device="cuda").float())
            ub = torch.exp2(torch.randint(-9, 3, (1, n), generator=gen,
                                          device="cuda").float())
            # "kmajor": B's slices as (K, N) views of (N, K) storage, the
            # layout fp32_matmul_int8 hands the kernels (no transposed copy).
            sb_k = sb.transpose(1, 2).contiguous().transpose(1, 2)
            lists = (list(sa.unbind(0)), list(sb.unbind(0)))
            for form in ("stacked", "split", "kmajor"):
                xa, xb = {"stacked": (sa, sb), "split": (tuple(sa), tuple(sb)),
                          "kmajor": (tuple(sa), tuple(sb_k))}[form]
                for ulps in ((), (ua, ub)):
                    got = sk.fused_int8_fp32(xa, xb, *ulps)
                    ref = sk.fused_int8_fp32_plain(*lists, *ulps)
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"B4 {ns} slices {form} scaled={bool(ulps)} "
                            f"{(m, n, k)}: {int((got != ref).sum())} elements "
                            f"differ from the plain version")
                    n4 += 1
                for n_diags in (ns, ns + 1):
                    for block_k in (64, 2048):
                        hi, lo = sk.fused_ozaki_int8(xa, xb, block_k=block_k,
                                                     n_diags=n_diags)
                        rhi, rlo = sk.fused_ozaki_int8_plain(
                            *lists, block_k=block_k, n_diags=n_diags)
                        got = hi.double() + lo.double()
                        ref = rhi.double() + rlo.double()
                        scale = float(ref.abs().max()) or 1.0
                        err = float((got - ref).abs().max()) / scale
                        worst5 = max(worst5, err)
                        if err > 1e-15:
                            raise AssertionError(
                                f"B5 {ns} slices {form} n_diags={n_diags} "
                                f"block_k={block_k} {(m, n, k)}: hi + lo off "
                                f"by {err:.3e} of the largest output")
                        exact5 += int(torch.equal(hi, rhi) and torch.equal(lo, rlo))
                        n5 += 1
    log(f"phase 10a: B4 vs plain, {n4} cases (2, 3, 4, 8 slices; stacked, "
        f"split and K-major B; scaled and unscaled; unaligned M, N, K): all "
        f"exact")
    for case, route in DIAG_RUNS:
        diag_route_case(torch, gen, case, route)
    diag_repeats(torch, gen)
    routes = {}
    for case, route in DIAG_RUNS:
        routes[route or case[-1]] = routes.get(route or case[-1], 0) + 1
    log(f"phase 10a: B4 route cases, {len(DIAG_ROUTE_CASES)} ({len(DIAG_RUNS)} runs {routes}: "
        f"every engine case again on mma.sync; 2-4 slices, n_diags 1 and below n_slices, "
        f"the five layouts, ragged M / N / K, K off the slab and at the whole-K bound, with "
        f"and without ulps; more than 4 diagonals and unaligned rows on mma.sync), route "
        f"checked each: all equal to the plain version; {DIAG_REPEATS} engine launches, "
        f"the same bits")
    log(f"phase 10b: B5 vs plain, {n5} cases: worst |hi + lo - plain| "
        f"{worst5:.3e} of the largest output; hi and lo bit-identical in "
        f"{exact5} of {n5}")
    results = [b5_route_case(torch, gen, c) for c in OZAKI_ROUTE_CASES]
    b5_repeats(torch, gen)
    log(f"phase 10b: B5 route cases, {len(results)} (the wgmma engine: 1-8 slices, "
        f"n_diags up to 9, block_k 128 / 256 / 2048, K off the slab; mma.sync: block_k 64 "
        f"and 192, unaligned K): worst |hi + lo - plain| {max(r[0] for r in results):.3e} "
        f"of the largest output, route checked each; bit-identical in "
        f"{sum(r[1] for r in results)} of {len(results)}; {OZAKI_REPEATS} engine "
        f"launches, the same bits")
    for call, match in (
            (lambda: sk.fused_int8_fp32(int8_slices(torch, 3, 8, 44400, gen),
                                        int8_slices(torch, 3, 44400, 16, gen)),
             "whole-K"),
            (lambda: sk.fused_ozaki_int8(int8_slices(torch, 3, 8, 64, gen),
                                         int8_slices(torch, 3, 64, 16, gen),
                                         block_k=45056), "too large")):
        try:
            call()
        except ValueError as e:
            if match not in str(e):
                raise
        else:
            raise AssertionError(f"the {match!r} bound was not enforced")
    log("phase 10c: B4's whole-K and B5's block_k int32 bounds refuse on the card")


def normwise(torch, got, a, b):
    """(max normwise error |C - AB| / (|a_i| |b_j|), Frobenius relative
    error) of ``got`` against the float64 product on the card."""
    a64, b64 = a.double(), b.double()
    exp = a64 @ b64
    diff = got.double() - exp
    scale = torch.outer(a64.norm(dim=1), b64.norm(dim=0))
    out = (float((diff.abs() / scale).max()),
           float(diff.norm() / exp.norm()))
    del a64, b64, exp, diff, scale
    return out


def floyd_warshall(torch, d, plus, reduce):
    """n rank-1 relaxations d = reduce(d, plus(d[:, k], d[k, :])) in place."""
    for k in range(d.shape[0]):
        reduce(d, plus(d[:, k:k + 1], d[k:k + 1, :]), out=d)
    return d


def dense_semiring(torch, name, x, y):
    """A semiring as plain torch ops, for plain autograd: amin / amax share
    a tied cotangent equally, minimum / maximum split a tie 0.5 / 0.5,
    logsumexp gives the softmax weights."""
    x3, y3 = x[:, :, None], y[None, :, :]
    if name == "log_plus":
        return torch.logsumexp(x3 + y3, dim=1)
    if name == "max_min":
        return torch.minimum(x3, y3).amax(1)
    if name == "min_max":
        return torch.maximum(x3, y3).amin(1)
    return (x3 + y3).amin(1) if name == "min_plus" else (x3 + y3).amax(1)


TROPICAL_GRADS = ("min_plus", "max_plus", "log_plus", "max_min", "min_max")


def phase_slice3(torch):
    """Slice 3's main path at full width, launch counts set to 0 before it
    and read after."""
    import numpy as np

    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.models import graph
    from gemm_hls_tpu_torch.ops import ozaki, slice_kernels as sk
    from gemm_hls_tpu_torch.ops.int8_slices import fp32_matmul_int8

    def b45():
        return sk.fused_int8_fp32.launches, sk.fused_ozaki_int8.launches

    reset_counters()
    gen = torch.Generator(device="cuda").manual_seed(81)
    res = {}

    # 11a: the fp32 tiers at bench.py's fp32 headline shape.
    n = 8192
    a = torch.rand((n, n), generator=gen, device="cuda") * 10 - 5
    b = torch.rand((n, n), generator=gen, device="cuda") * 10 - 5
    errs = {}
    for p, bound in (("i8x2", 3e-4), ("i8x3", 2e-6), ("i8x4", 2e-6)):
        before = b45()
        out = matmul(a, b, precision=p)
        torch.cuda.synchronize()
        if b45() != (before[0] + 1, before[1]):
            raise AssertionError(f"{p} {n}^3: launches B4/B5 {before} -> {b45()}")
        main_route(sk.fused_int8_fp32, f"{p} {n}^3 B4", "wgmma")
        if out.shape != (n, n) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{p}: bad output")
        errs[p] = normwise(torch, out, a, b)
        del out
        if errs[p][0] >= bound:
            raise AssertionError(f"{p} {n}^3: normwise {errs[p][0]:.3e} >= {bound:g}")
        log(f"phase 11a: matmul precision={p} fp32 {n}^3 on B4 (route wgmma): normwise "
            f"{errs[p][0]:.3e} (bound {bound:g}), Frobenius rel {errs[p][1]:.3e}")
    if not (errs["i8x4"][0] < errs["i8x3"][0] and errs["i8x4"][1] < 2 ** -22):
        raise AssertionError(f"i8x4 not at the fp32 output floor: {errs}")
    res["i8x"] = errs

    # 11b: past B4's whole-K bound, the hi/lo kernel B5.
    for m, nn, k in ((16, 128, 44000), (8, 8, (1 << 17) + 128)):
        x = torch.rand((m, k), generator=gen, device="cuda") * 2 - 1
        y = torch.rand((k, nn), generator=gen, device="cuda") * 2 - 1
        before = b45()
        out = matmul(x, y, precision="i8x3")
        torch.cuda.synchronize()
        if b45() != (before[0], before[1] + 1):
            raise AssertionError(f"i8x3 K={k}: launches B4/B5 {before} -> {b45()}")
        err = normwise(torch, out, x, y)[0]
        if err >= 2e-6:
            raise AssertionError(f"i8x3 K={k}: normwise {err:.3e}")
        log(f"phase 11b: matmul precision=i8x3 ({m}, {nn}, K={k}) on B5: "
            f"normwise {err:.3e}")

    # 11c: the gradient of fp32_matmul_int8 at i8x3, against fp32 autograd.
    n = 4096
    x = (torch.rand((n, n), generator=gen, device="cuda") * 10 - 5).requires_grad_()
    y = (torch.rand((n, n), generator=gen, device="cuda") * 10 - 5).requires_grad_()
    g = torch.rand((n, n), generator=gen, device="cuda") * 2 - 1
    before = b45()
    fp32_matmul_int8(x, y, n_slices=3).backward(g)
    dx, dy = x.grad, y.grad
    if b45()[0] != before[0] + 3:
        raise AssertionError(f"i8x3 gradient: B4 launches {before} -> {b45()}")
    main_route(sk.fused_int8_fp32, "i8x3 gradient B4", "wgmma")
    x2, y2 = x.detach().clone().requires_grad_(), y.detach().clone().requires_grad_()
    (x2 @ y2).backward(g)
    for name, got, ref, ops in (("dA", dx, x2.grad, (g, y.detach().T)),
                                ("dB", dy, y2.grad, (x.detach().T, g))):
        exact = normwise(torch, got, *ops)[0]
        _, rel = compare(torch, got, ref, 1e-4, f"i8x3 gradient {name}", scaled=True)
        if exact >= 2e-6:
            raise AssertionError(f"i8x3 gradient {name}: normwise {exact:.3e}")
        log(f"phase 11c: fp32_matmul_int8 i8x3 {n}^3 gradient {name}: normwise "
            f"{exact:.3e} vs the float64 product; scaled rel {rel:.3e} vs fp32 "
            f"autograd")
    del x, y, g, dx, dy, x2, y2

    # 11d: the f64-class GEMMs (numpy in, numpy out).
    rng = np.random.default_rng(91)
    res["ozaki"] = {}
    for fn, n, bound in (("ozaki_matmul_int8", 2048, 1e-13),
                         ("ozaki_matmul_int8", 8192, 1e-13),
                         ("ozaki_matmul", 2048, 1e-14)):
        A = rng.uniform(-5, 5, (n, n))
        B = rng.uniform(-5, 5, (n, n))
        before, b1 = b45(), counters()["B1"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C = getattr(ozaki, fn)(A, B)
        secs = time.perf_counter() - t0
        launched = (b45()[1] - before[1] if fn == "ozaki_matmul_int8"
                    else counters()["B1"] - b1)
        if launched <= 0:
            raise AssertionError(f"{fn} {n}^3 launched no kernel")
        At, Bt = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
        err = normwise(torch, torch.from_numpy(C).cuda(), At, Bt)[0]
        del At, Bt
        if C.shape != (n, n) or err >= bound:
            raise AssertionError(f"{fn} {n}^3: normwise {err:.3e} >= {bound:g}")
        res["ozaki"][f"{fn} {n}^3"] = dict(seconds=secs, normwise=err)
        log(f"phase 11d: {fn} f64 {n}^3 ({launched} "
            f"{'B5' if fn == 'ozaki_matmul_int8' else 'B1'} launches): normwise "
            f"{err:.3e} (bound {bound:g}); call {secs * 1e3:.1f} ms, numpy in "
            f"and out")

    # 11e: the graph applications, integer-valued weights: every sum exact.
    inf = float("inf")
    n = 4096
    w = torch.randint(1, 10, (n, n), generator=gen, device="cuda").float()
    keep = torch.rand((n, n), generator=gen, device="cuda") < 4.0 / n
    adj = torch.where(keep, w, inf)
    b3 = counters()["B3"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = graph.all_pairs_shortest_paths(adj)
    torch.cuda.synchronize()
    res["apsp_s"] = time.perf_counter() - t0
    squarings = counters()["B3"] - b3
    d = adj.clone()
    d.fill_diagonal_(0.0)
    ref = floyd_warshall(torch, d, torch.add, torch.minimum)
    compare(torch, dist, ref, 0.0, "APSP 4096 vs Floyd-Warshall")
    log(f"phase 11e: all_pairs_shortest_paths n={n} ({squarings} min_plus B3 "
        f"launches, {res['apsp_s'] * 1e3:.1f} ms): equals Floyd-Warshall exactly "
        f"({int(torch.isfinite(dist).sum())} finite distances, longest "
        f"{float(dist[torch.isfinite(dist)].max()):.0f})")
    del dist, ref, d
    cap = torch.where(keep, w, 0.0)
    wide = graph.widest_paths(cap)
    d = cap.clone()
    d.fill_diagonal_(inf)
    compare(torch, wide, floyd_warshall(torch, d, torch.minimum, torch.maximum),
            0.0, "widest paths 4096 vs Floyd-Warshall")
    log(f"phase 11e: widest_paths n={n} (max_min on B3): equals the (max, min) "
        f"Floyd-Warshall exactly")
    del wide, d, cap, adj, w, keep

    n = 8192
    w = torch.randint(1, 10, (n, n), generator=gen, device="cuda").float()
    keep = torch.rand((n, n), generator=gen, device="cuda") < 1.5 / n
    d = torch.where(keep, w, inf)
    d.fill_diagonal_(0.0)
    reach = torch.isfinite(floyd_warshall(torch, d, torch.add, torch.minimum))
    del d, w
    for route, hook in (("B1 int8 counts", None),
                        ("bit-packed B3", lambda x, y: matmul(
                            x, y, semiring="or_and", backend="vpu"))):
        closure = graph.transitive_closure(keep, matmul_fn=hook)
        compare(torch, closure, reach, 0.0, f"closure 8192 ({route})")
        del closure
    log(f"phase 11e: transitive_closure n={n} bool, B1 int8 route and "
        f"bit-packed B3: equal isfinite(Floyd-Warshall) "
        f"({int(reach.sum())} of {n * n} pairs reachable)")
    del reach

    edges = keep | (torch.rand((n, n), generator=gen, device="cuda") < 0.001)
    edges[7] = False  # a dangling node
    rank = graph.pagerank(edges.float(), iters=50)
    out_deg = edges.sum(1, keepdim=True).clamp(min=1)
    tt = torch.where(edges, 1.0 / out_deg, 0.0).T.contiguous()
    dangling = (edges.sum(1) == 0).float()
    r = torch.full((n,), 1.0 / n, device="cuda")
    for _ in range(50):
        r = 0.85 * (tt @ r + (dangling * r).sum() / n) + 0.15 / n
    compare(torch, rank, r, 1e-5, "pagerank 8192")
    log(f"phase 11e: pagerank n={n}, 50 iterations (fp32 on B1): within 1e-5 "
        f"of a plain power iteration; sum {float(rank.sum()):.6f}")
    del edges, tt, keep

    # 11f: the semiring gradients at 1024^3 against plain autograd through
    # the dense form, 64 rows at a time (full K per row: ties share alike).
    n = 1024
    res["tropical_bwd_ms"] = {}
    for name in TROPICAL_GRADS:
        lo, hi = (-2.0, 2.0) if name == "log_plus" else (0.0, 100.0)
        a = torch.rand((n, n), generator=gen, device="cuda") * (hi - lo) + lo
        b = torch.rand((n, n), generator=gen, device="cuda") * (hi - lo) + lo
        g = torch.rand((n, n), generator=gen, device="cuda") * 2 - 1
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = matmul(x, y, semiring=name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.backward(g)
        torch.cuda.synchronize()
        res["tropical_bwd_ms"][name] = (time.perf_counter() - t0) * 1e3
        x2, y2 = a.clone().requires_grad_(), b.clone().requires_grad_()
        for r0 in range(0, n, 64):
            (dense_semiring(torch, name, x2[r0:r0 + 64], y2)
             * g[r0:r0 + 64]).sum().backward()
        for which, got, ref in (("dA", x.grad, x2.grad), ("dB", y.grad, y2.grad)):
            compare(torch, got, ref, 1e-5, f"{name} gradient {which}", scaled=True)
        log(f"phase 11f: {name} {n}^3 gradients (backward "
            f"{res['tropical_bwd_ms'][name]:.1f} ms) match plain autograd")
        del a, b, g, x, y, x2, y2, out

    launches = counters()
    log(f"phase 11: main-path launch counts {launches}")
    for name in ("B1", "B3", "B4", "B5"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice 3 "
                                 f"main path")
    return launches, res


def phase_times3(torch):
    """Times of B4 and B5 beside their plain versions and the library call
    computing the same product, and of slice 3's end-to-end calls (launches
    here are comparisons, not the main path's)."""
    import numpy as np

    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.ops import ozaki, slice_kernels as sk
    from gemm_hls_tpu_torch.ops.int8_slices import _quantize_slices
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    gen = torch.Generator(device="cuda").manual_seed(101)
    out = {}
    n = 8192
    a = torch.rand((n, n), generator=gen, device="cuda") * 10 - 5
    b = torch.rand((n, n), generator=gen, device="cuda") * 10 - 5
    for p in ("i8x2", "i8x3", "i8x4"):
        ns = int(p[-1])
        # B's slices K-contiguous, as fp32_matmul_int8 makes them.
        sa, ua = _quantize_slices(a, axis=1, n_slices=ns, stacked=False)
        sbt, ubt = _quantize_slices(b.T.contiguous(), axis=1, n_slices=ns,
                                    stacked=False)
        sb, ub = [s.T for s in sbt], ubt.T
        args = (tuple(sa), tuple(sb), ua, ub)
        ref = sk.fused_int8_fp32_plain(sa, sb, ua, ub)
        for route in ("wgmma", "mma.sync"):
            if not torch.equal(sk.fused_int8_fp32(*args, route=route), ref):
                raise AssertionError(f"B4 {p} {n}^3 on {route} differs from its plain version")
        del ref
        rule = sk.diag_route(ns, n, n, True)
        fns = {route: (lambda route=route: sk.fused_int8_fp32(*args, route=route))
               for route in ("wgmma", "mma.sync")}
        fns["library"] = lambda: torch.matmul(a, b)
        fns["matmul"] = lambda: matmul(a, b, precision=p)
        turns = event_turns(torch, fns)
        plain_ms = time_fn(lambda *t: sk.fused_int8_fp32_plain(sa, sb, ua, ub), [()],
                           iters=1, warmup=0, repeats=1) * 1e3
        other = "mma.sync" if rule == "wgmma" else "wgmma"
        out[f"B4 {p}"] = dict(ms=turns[rule], plain_ms=plain_ms, library_ms=turns["library"],
                              max_abs_err=0.0, matmul_ms=turns["matmul"], n_slices=ns,
                              route=rule, other_route=other, other_ms=turns[other])
        log(f"phase 12: B4 {p} fp32 {n}^3 on CUDA events, in turns: {turns[rule]:.3f} ms "
            f"(route {rule}; {other} {turns[other]:.3f} ms) vs plain {plain_ms:.3f} ms, "
            f"torch.matmul fp32 {turns['library']:.3f} ms; matmul(precision={p!r}) end to "
            f"end {turns['matmul']:.3f} ms")
        del sa, sb, sbt, args
    high = time_fn(lambda x, y: matmul(x, y, precision="high"), [(a, b)], iters=2) * 1e3
    out["matmul high 8192"] = high
    log(f"phase 12: matmul(precision='high') fp32 {n}^3 (B1, CUDA cores): "
        f"{high:.3f} ms")
    del a, b

    for n in (2048, 8192):
        sa = int8_slices(torch, 8, n, n, gen)
        sb = int8_slices(torch, 8, n, n, gen).transpose(1, 2)  # K-major B
        kw = dict(block_k=2048, n_diags=8)
        ms = time_fn(lambda x, y: sk.fused_ozaki_int8(x, y, **kw), [(sa, sb)],
                     iters=5 if n == 2048 else 2) * 1e3
        A = torch.rand((n, n), generator=gen, device="cuda", dtype=torch.float64)
        lib = time_fn(torch.matmul, [(A, A)], iters=5) * 1e3
        entry = dict(ms=ms, library_ms=lib)
        if n == 2048:
            hi, lo = sk.fused_ozaki_int8(sa, sb, **kw)
            rhi, rlo = sk.fused_ozaki_int8_plain(list(sa), list(sb), **kw)
            ref = rhi.double() + rlo.double()
            entry["max_abs_err"] = float((hi.double() + lo.double() - ref).abs().max())
            entry["plain_ms"] = time_fn(
                lambda: sk.fused_ozaki_int8_plain(list(sa), list(sb), **kw), [()],
                iters=1, warmup=0, repeats=1) * 1e3
            del hi, lo, rhi, rlo, ref
        out[f"B5 {n}"] = entry
        log(f"phase 12: B5 8 slices, 36 products, {n}^3 (route "
            f"{sk.fused_ozaki_int8.last_route}): {ms:.3f} ms"
            + (f" vs plain {entry['plain_ms']:.3f} ms" if "plain_ms" in entry else "")
            + f" (torch.matmul float64 {lib:.3f} ms)")
        del sa, sb, A

    rng = np.random.default_rng(103)
    A, B = rng.uniform(-5, 5, (2048, 2048)), rng.uniform(-5, 5, (2048, 2048))
    for fn in ("ozaki_matmul_int8", "ozaki_matmul"):
        secs = []
        for _ in range(3 if fn == "ozaki_matmul_int8" else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            getattr(ozaki, fn)(A, B)
            secs.append(time.perf_counter() - t0)
        out[f"{fn} 2048"] = statistics.median(secs) * 1e3
        log(f"phase 12: {fn} 2048^3 call, numpy in and out: "
            f"{out[f'{fn} 2048']:.1f} ms")
    return out


# ---------------------------------------------------------------------------
# Slice 4: flash attention, kernels flash_fwd, flash_bwd_dq, flash_bwd_dkv
# (TPU kernels B6-B12)
# ---------------------------------------------------------------------------

FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def flash_counters():
    from gemm_hls_tpu_torch.ops import flash
    return {"flash_fwd": flash.flash_mha.launches,
            "flash_bwd_dq": flash.flash_mha_bwd_dq.launches,
            "flash_bwd_dkv": flash.flash_mha_bwd_dkv.launches}


def reset_flash_counters():
    from gemm_hls_tpu_torch.ops import flash
    flash.flash_mha.launches = 0
    flash.flash_mha_bwd_dq.launches = 0
    flash.flash_mha_bwd_dkv.launches = 0


def flash_rtol(torch, dtype):
    return F32_RTOL if dtype == torch.float32 else BF16_RTOL


def flash_plain_fwd(torch, q, k, v, **kw):
    """The plain forward on the card, for 3-D or 4-D operands; (o in q's
    layout, lse (B, S_q))."""
    from gemm_hls_tpu_torch.ops import flash
    o, lse = flash.flash_fwd_plain(flash._pack(q), flash._pack(k),
                                   flash._pack(v), **kw)
    return flash._unpack(o, q), lse


# Phase 13's case tables, which tests/test_torch_kernels.py parametrises
# too (one table, two runners).  A kernel case is (dtype, heads, kv heads,
# S_q, S_kv, D, options); integer options are lists.  "nan_pad" fills the
# kv slots at or past each length with NaN (K) and +inf (V): a padded
# cache's stale slots, which no output may see.
_SEG = [0] * 90 + [1] * 120 + [2] * 90  # three packed segments of 300 rows
_DT = ("bfloat16", "float16", "float32")
FLASH_CASES = (
    # dtypes x head dims, full attention, unaligned S_q and S_kv (D = 36:
    # rows not 16-byte aligned, the element loader instead of cp.async).
    [(dt, 4, 4, 200, 333, d, {}) for dt in _DT for d in (16, 36, 40, 64, 128)]
    # causal, causal + window, the soft cap, S_q = 1, S_q < S_kv
    + [(dt, bh, bh, s_q, s_kv, d, kw)
       for dt, d in zip(_DT, (128, 64, 40))
       for bh, s_q, s_kv, kw in (
           (3, 333, 333, {"causal": True}),
           (3, 333, 333, {"causal": True, "window": 100}),
           (2, 150, 150, {"logit_cap": 5.0, "scale": 0.5}),
           (2, 150, 200, {"causal": True, "window": 70, "logit_cap": 3.0}),
           (6, 1, 517, {}),
           (2, 77, 300, {"causal": True}))]
    # More heads than the grid's 65535: every kernel launches in chunks.
    + [("bfloat16", 70000, 70000, 3, 5, 16, {})]
    # GQA groups 1, 4, 8 (MQA), causal, with the backward's group fold
    + [(dt, 8, bh_kv, s, s, d, {"causal": True}) for bh_kv in (8, 2, 1)
       for dt, s, d in (("bfloat16", 256, 128), ("float32", 96, 64))]
    # kv_lengths (3-D, staggered), plain and decode-anchored causal, with
    # and without stale slots
    + [(dt, 8, 4, 3, 700, d, {"kv_lengths": [700, 1, 333, 64],
                               "causal": causal, "nan_pad": pad})
       for dt, d in (("bfloat16", 128), ("float32", 64))
       for causal in (False, True) for pad in (False, True)]
    # segment ids, packed (causal training) and per GQA head
    + [case for dt in ("bfloat16", "float32") for case in (
        (dt, 2, 2, 300, 300, 64, {"causal": True, "q_seg": [_SEG] * 2,
                                  "kv_seg": [_SEG] * 2}),
        (dt, 4, 2, 300, 300, 128, {"q_seg": [_SEG] * 4, "kv_seg": [_SEG] * 2}))]
    # offsets: a later q shard against an earlier kv shard, with a window
    + [(dt, 2, 2, 200, 200, 64, {"causal": True, "window": 250,
                                 "offsets": [200, 0]})
       for dt in ("bfloat16", "float32")]
)
# The front door's 4-D layouts, each in bf16 and fp32 (read in place):
# GQA prefill, kv lengths per batch element (with stale slots), segment ids
# over GQA heads, the decode fast path.  shape: (batch, S_q, H_q, H_kv, D).
FLASH_4D = [
    {"shape": (2, 130, 8, 2, 64), "causal": True},
    {"shape": (3, 5, 4, 2, 128), "causal": True, "kv_lengths": [300, 17, 150],
     "s_kv": 300},
    {"shape": (3, 5, 4, 2, 64), "kv_lengths": [300, 17, 150], "s_kv": 300,
     "nan_pad": True},
    {"shape": (2, 120, 4, 2, 64), "seg": True},
    {"shape": (4, 1, 16, 4, 128), "causal": True,
     "kv_lengths": [1000, 1, 513, 999], "s_kv": 1000},
    {"shape": (4, 1, 16, 4, 128), "causal": True,
     "kv_lengths": [1000, 1, 513, 999], "s_kv": 1000, "nan_pad": True},
    {"shape": (2, 1, 8, 1, 64), "s_kv": 257},
]
# fp32 kernel gradients against float64 autograd: (heads, S, D, causal).
FLASH_GRAD_CASES = [(2, 70, 40, False), (3, 129, 64, True)]
FLASH_REFUSALS = ("head_dim", "interpret")
# The forward's two tensor-core routes (``ops.flash.flash_route``), phase
# 13's route table, which tests/test_torch_kernels.py parametrises too:
# (layout, dtype, batch, H_q, H_kv, S_q, S_kv, D, options, route).  "3d"
# packs batch x heads into (B, S, D) tensors, "4d" is (batch, S, H, D) read
# in place; kv_lengths are per packed kv head; "seg" gives every head
# _SEG's three packed segments (S = 300); "pitched" makes every row a view
# one element longer than D (not whole 16-byte units).  The engine: 3-D and
# 4-D, D 64 and 128, bf16 and fp16, S_q and S_kv off the 128-row tiles,
# causal, window, the soft cap, GQA 4 and 8, kv_lengths with NaN / inf
# stale slots inside the last live tile (both its halves) and a length of
# 1, segment ids, offsets (one a fully-future shard: o = 0, lse = -inf).
# mma.sync: D 40 and 96, 63 rows a head, decode's one row, rows that are
# not whole 16-byte units; fp32 on the CUDA cores.  "out_fp32" stores o in
# fp32 (``out_dtype=torch.float32``, ring attention's partials) on both
# 16-bit routes: held to the plain version and, rounded to the operand
# type, bit for bit to the 16-bit-output launch (lse too).
FLASH_ROUTE_CASES = (
    [("3d", dt, 2, 1, 1, 200, 333, d, {}, "wgmma")
     for dt, d in (("bfloat16", 128), ("float16", 64))]
    + [("3d", "bfloat16", 3, 1, 1, 333, 333, 64, {"causal": True}, "wgmma"),
       ("3d", "float16", 3, 1, 1, 333, 333, 128, {"causal": True, "window": 100}, "wgmma"),
       ("3d", "bfloat16", 2, 1, 1, 150, 200, 128, {"logit_cap": 5.0, "scale": 0.5}, "wgmma"),
       ("3d", "bfloat16", 2, 1, 1, 150, 200, 64,
        {"causal": True, "window": 70, "logit_cap": 3.0}, "wgmma"),
       ("3d", "bfloat16", 2, 1, 1, 64, 1000, 128, {"causal": True}, "wgmma")]
    # GQA 4 and 8 (MQA), causal
    + [(lay, "bfloat16", 1, 8, hkv, 256, 256, d, {"causal": True}, "wgmma")
       for lay, hkv, d in (("3d", 2, 128), ("3d", 1, 64), ("4d", 2, 64), ("4d", 1, 128))]
    # kv_lengths with stale NaN / inf slots, plain and decode-anchored causal
    + [("3d", "bfloat16", 1, 4, 2, 100, 300, 128,
        {"kv_lengths": [300, 77], "causal": causal, "nan_pad": True}, "wgmma")
       for causal in (False, True)]
    + [("4d", "float16", 3, 4, 2, 130, 400, 64,
        {"kv_lengths": [400, 1, 150, 399, 260, 129], "causal": True, "nan_pad": True},
        "wgmma")]
    # segment ids (packed causal training, GQA heads in the 4-D layout)
    + [("3d", "bfloat16", 2, 1, 1, 300, 300, 64, {"causal": True, "seg": True}, "wgmma"),
       ("4d", "bfloat16", 2, 4, 2, 300, 300, 128, {"seg": True}, "wgmma")]
    # offsets: a later q shard with a window; a fully-future shard
    + [("3d", "bfloat16", 2, 1, 1, 200, 200, 64,
        {"causal": True, "window": 250, "offsets": [200, 0]}, "wgmma"),
       ("3d", "float16", 2, 1, 1, 100, 100, 128, {"causal": True, "offsets": [0, 100]},
        "wgmma")]
    # the GQA prefill's heads and layout (phase 14b), and an fp16 4-D MQA
    + [("4d", "bfloat16", 2, 16, 4, 256, 256, 128, {"causal": True}, "wgmma"),
       ("4d", "float16", 1, 8, 1, 200, 333, 128, {}, "wgmma")]
    # the mma.sync tile and the CUDA cores
    + [("3d", "bfloat16", 2, 1, 1, 200, 333, d, {}, "mma.sync") for d in (40, 96)]
    + [("3d", "bfloat16", 2, 1, 1, 63, 300, 128, {"causal": True}, "mma.sync"),
       ("4d", "bfloat16", 4, 16, 4, 1, 1000, 128,
        {"causal": True, "kv_lengths": [1000, 1, 513, 999] * 4, "nan_pad": True}, "mma.sync"),
       ("3d", "bfloat16", 2, 1, 1, 200, 333, 128, {"pitched": True}, "mma.sync"),
       ("3d", "float32", 2, 1, 1, 200, 333, 64, {"causal": True}, "simt")]
    # fp32 o on the engine (the ring's shapes: offsets, GQA, causal, full) and
    # on mma.sync (decode's rows with lengths past both ends of a shard)
    + [("3d", "bfloat16", 2, 1, 1, 333, 333, 128, {"causal": True, "out_fp32": True}, "wgmma"),
       ("3d", "float16", 2, 1, 1, 200, 333, 64, {"out_fp32": True}, "wgmma"),
       ("4d", "bfloat16", 2, 16, 4, 256, 256, 128,
        {"causal": True, "window": 300, "offsets": [256, 0], "out_fp32": True}, "wgmma"),
       ("3d", "bfloat16", 1, 4, 2, 100, 300, 128,
        {"kv_lengths": [300, 77], "nan_pad": True, "out_fp32": True}, "wgmma"),
       ("3d", "bfloat16", 2, 1, 1, 200, 333, 40, {"causal": True, "out_fp32": True},
        "mma.sync"),
       ("4d", "bfloat16", 4, 16, 4, 4, 1000, 128,
        {"causal": True, "kv_lengths": [1000, -5, 513, 1400] * 4, "out_fp32": True},
        "mma.sync")]
)
# The race check of the engine route: FLASH_REPEAT_CASE launched
# FLASH_REPEATS times, the same bits each.
FLASH_REPEAT_CASE = ("4d", "bfloat16", 2, 16, 4, 256, 256, 128, {"causal": True}, "wgmma")
FLASH_REPEATS = 20
# The backward's routes (``ops.flash.flash_bwd_route``: dq by its S_q rows,
# dk / dv by S_kv), phase 13's backward route table, which
# tests/test_torch_kernels.py parametrises too; its cases are
# FLASH_ROUTE_CASES', and each names the route both kernels take.  Every
# engine case also runs on the mma.sync tile (the route override): both
# 16-bit routes on the same inputs.  The engine: bf16 and fp16, D 64 and
# 128, S_q and S_kv off the 128-row tiles (200 x 333, 333 x 333), full,
# causal, causal + window, the soft cap with a custom scale, S_q 64 against
# S_kv 1000, GQA 4 and 8 in the 3-D and 4-D layouts, segment ids, offsets
# (a later q shard with a window; a shard whose first 120 rows see no key;
# a fully-future shard: lse = -inf rows, dq / dk / dv exactly 0 there).
# dk / dv take items of 64 kv rows where the 128-row items fill at most one
# round of the SMs (every small case on an H100's 132), else 128-row items:
# the many-kv-head cases (200 and 138 items of 128 rows) hold the latter
# with a window and with segment ids.
# mma.sync: D 40 and 96, 63 rows, rows that are not whole 16-byte units;
# fp32 on the CUDA cores.
FLASH_BWD_ROUTE_CASES = (
    [("3d", dt, 2, 1, 1, s_q, 333, d, {}, "wgmma")
     for dt, d, s_q in (("bfloat16", 128, 200), ("float16", 64, 200), ("bfloat16", 64, 333),
                        ("float16", 128, 333))]
    + [("3d", "bfloat16", 3, 1, 1, 333, 333, 64, {"causal": True}, "wgmma"),
       ("3d", "float16", 3, 1, 1, 333, 333, 128, {"causal": True, "window": 100}, "wgmma"),
       ("3d", "bfloat16", 2, 1, 1, 150, 200, 128, {"logit_cap": 5.0, "scale": 0.5}, "wgmma"),
       ("3d", "float16", 2, 1, 1, 150, 200, 64,
        {"causal": True, "window": 70, "logit_cap": 3.0}, "wgmma"),
       ("3d", "bfloat16", 2, 1, 1, 64, 1000, 128, {"causal": True}, "wgmma"),
       ("3d", "float16", 2, 1, 1, 64, 1000, 64, {}, "wgmma")]
    # GQA 4 and 8 (MQA), 3-D and 4-D, and the GQA prefill's heads unaligned
    + [(lay, dt, 1, 8, hkv, 256, 256, d, {"causal": True}, "wgmma")
       for lay, dt, hkv, d in (("3d", "bfloat16", 2, 128), ("3d", "float16", 1, 64),
                               ("4d", "bfloat16", 2, 64), ("4d", "float16", 1, 128))]
    + [("4d", "bfloat16", 2, 16, 4, 200, 333, 128, {}, "wgmma")]
    # segment ids (packed causal training, GQA heads in the 4-D layout)
    + [("3d", "bfloat16", 2, 1, 1, 300, 300, 64, {"causal": True, "seg": True}, "wgmma"),
       ("4d", "float16", 2, 4, 2, 300, 300, 128, {"seg": True}, "wgmma")]
    # offsets
    + [("3d", "bfloat16", 2, 1, 1, 200, 200, 64,
        {"causal": True, "window": 250, "offsets": [200, 0]}, "wgmma"),
       ("3d", "bfloat16", 2, 1, 1, 200, 200, 128, {"causal": True, "offsets": [0, 120]},
        "wgmma"),
       ("3d", "float16", 2, 1, 1, 100, 100, 128, {"causal": True, "offsets": [0, 100]},
        "wgmma")]
    # many kv heads: dk / dv in items of 128 kv rows
    + [("3d", "bfloat16", 40, 1, 1, 200, 520, 128, {"causal": True, "window": 150}, "wgmma"),
       ("4d", "float16", 23, 4, 2, 300, 300, 64, {"seg": True}, "wgmma")]
    # the mma.sync tile and the CUDA cores
    + [("3d", "bfloat16", 2, 1, 1, 200, 333, d, {}, "mma.sync") for d in (40, 96)]
    + [("3d", "bfloat16", 2, 1, 1, 63, 63, 128, {"causal": True}, "mma.sync"),
       ("3d", "bfloat16", 2, 1, 1, 200, 333, 128, {"pitched": True}, "mma.sync"),
       ("3d", "float32", 2, 1, 1, 200, 333, 64, {"causal": True}, "simt")]
)
# The race check of the backward's engine route: each kernel launched
# FLASH_REPEATS times on FLASH_BWD_REPEAT_CASE, the same bits each.
FLASH_BWD_REPEAT_CASE = ("4d", "bfloat16", 2, 16, 4, 256, 256, 128, {"causal": True}, "wgmma")


def stale_slots(k, v, lens):
    """Fill the kv slots at or past each sequence's length with NaN (K) and
    +inf (V); sequence i is k[i] of a 3-D (B_kv, S, D) or a 4-D (batch, S,
    H, D) cache."""
    for i, n in enumerate(lens):
        k[i, n:] = float("nan")
        v[i, n:] = float("inf")


def flash_case(torch, gen, case):
    """One kernel case of FLASH_CASES against the plain versions on the
    card: o and lse of flash_fwd, then (unless kv lengths are given) dq of
    flash_bwd_dq and dk, dv of flash_bwd_dkv on the plain forward's o, lse
    and delta.  Returns the largest abs error."""
    from gemm_hls_tpu_torch.ops import flash

    dt, bh, bh_kv, s_q, s_kv, d, kw = case
    dtype, kw = getattr(torch, dt), dict(kw)
    q = signed(torch, (bh, s_q, d), dtype, gen)
    k = signed(torch, (bh_kv, s_kv, d), dtype, gen)
    v = signed(torch, (bh_kv, s_kv, d), dtype, gen)
    if kw.pop("nan_pad", False):
        stale_slots(k, v, kw["kv_lengths"])
    scale = kw.pop("scale", d ** -0.5)
    ints = [flash._ints(kw.pop(n, None), q.device)
            for n in ("kv_lengths", "q_seg", "kv_seg", "offsets")]
    rtol, what = flash_rtol(torch, dtype), f"flash {case}"
    o, lse = flash._forward(q, k, v, *ints, kw.get("causal", False),
                            kw.get("window"), kw.get("logit_cap"), scale, 512)
    ro, rlse = flash.flash_fwd_plain(q, k, v, *ints, scale=scale, **kw)
    err = compare(torch, o, ro, rtol, what + " o", scaled=True)[0]
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: non-finite output")
    compare(torch, lse, rlse, F32_RTOL, what + " lse", scaled=True)
    if ints[0] is not None:
        return err
    do = signed(torch, (bh, s_q, d), dtype, gen)
    delta = (do.float() * ro.float()).sum(-1)
    bargs = (q, k, v, do, rlse, delta, *ints[1:])
    bkw = dict(causal=kw.get("causal", False), window=kw.get("window"),
               logit_cap=kw.get("logit_cap"), scale=scale)
    dq = flash._backward(*bargs, block_q=512, which="dq", **bkw)
    dk, dv = flash._backward(*bargs, block_q=512, which="dkv", **bkw)
    rdq = flash.flash_bwd_dq_plain(*bargs, **bkw)
    rdk, rdv = flash.flash_bwd_dkv_plain(*bargs, **bkw)
    for name, g, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        err = max(err, compare(torch, g, r, rtol, f"{what} {name}", scaled=True)[0])
    return err


def flash_route_operands(torch, gen, case):
    """(q, k, v, the kernel's int arguments, scale, mask keywords) of one
    FLASH_ROUTE_CASES case, on the card."""
    from gemm_hls_tpu_torch.ops import flash

    layout, dt, nb, hq, hkv, s_q, s_kv, d, kw, _ = case
    dtype, kw = getattr(torch, dt), dict(kw)
    width = d + 1 if kw.pop("pitched", False) else d

    def make(s, h):
        shape = (nb * h, s, width) if layout == "3d" else (nb, s, h, width)
        return signed(torch, shape, dtype, gen)[..., :d]

    q, k, v = make(s_q, hq), make(s_kv, hkv), make(s_kv, hkv)
    if kw.pop("nan_pad", False):
        for i, n in enumerate(kw["kv_lengths"]):
            at = (i, slice(n, None)) if layout == "3d" else (i // hkv, slice(n, None), i % hkv)
            k[at] = float("nan")
            v[at] = float("inf")
    if kw.pop("seg", False):
        kw.update(q_seg=[_SEG] * (nb * hq), kv_seg=[_SEG] * (nb * hkv))
    if kw.pop("out_fp32", False):
        kw["out_dtype"] = torch.float32
    scale = kw.pop("scale", d ** -0.5)
    ints = [flash._ints(kw.pop(n, None), q.device)
            for n in ("kv_lengths", "q_seg", "kv_seg", "offsets")]
    return q, k, v, ints, scale, kw


def flash_route_forward(torch, q, k, v, ints, scale, kw):
    from gemm_hls_tpu_torch.ops import flash
    return flash._forward(q, k, v, *ints, kw.get("causal", False), kw.get("window"),
                          kw.get("logit_cap"), scale, 512, out_dtype=kw.get("out_dtype"))


def flash_route_case(torch, gen, case):
    """One FLASH_ROUTE_CASES case: the forward on the card (o and lse) on
    the route the case names against the plain version; returns the largest
    abs error."""
    from gemm_hls_tpu_torch.ops import flash

    q, k, v, ints, scale, kw = flash_route_operands(torch, gen, case)
    o, lse = flash_route_forward(torch, q, k, v, ints, scale, kw)
    if flash.flash_mha.last_route != case[-1]:
        raise AssertionError(f"flash {case}: route {flash.flash_mha.last_route}")
    ro, rlse = flash.flash_fwd_plain(flash._pack(q), flash._pack(k), flash._pack(v), *ints,
                                     scale=scale, **kw)
    what = f"flash route {case}"
    err = compare(torch, o, flash._unpack(ro, q), flash_rtol(torch, q.dtype), what + " o",
                  scaled=True)[0]
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{what}: non-finite output")
    compare(torch, lse, rlse, F32_RTOL, what + " lse", scaled=True)
    if kw.get("out_dtype") is not None:  # the same kernel arithmetic, another store
        o16, lse16 = flash_route_forward(torch, q, k, v, ints, scale,
                                         dict(kw, out_dtype=q.dtype))
        if not (torch.equal(o.to(q.dtype), o16) and torch.equal(lse, lse16)):
            raise AssertionError(f"{what}: the fp32 o rounded differs from the "
                                 f"{q.dtype} launch")
    return err


def flash_repeats(torch, gen):
    """FLASH_REPEAT_CASE launched FLASH_REPEATS times on the same operands:
    every launch gives the first one's bits (o and lse)."""
    from gemm_hls_tpu_torch.ops import flash

    q, k, v, ints, scale, kw = flash_route_operands(torch, gen, FLASH_REPEAT_CASE)
    first = flash_route_forward(torch, q, k, v, ints, scale, kw)
    if flash.flash_mha.last_route != FLASH_REPEAT_CASE[-1]:
        raise AssertionError(f"flash {FLASH_REPEAT_CASE}: route {flash.flash_mha.last_route}")
    for i in range(FLASH_REPEATS - 1):
        again = flash_route_forward(torch, q, k, v, ints, scale, kw)
        if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
            raise AssertionError(f"flash: launch {i + 2} of {FLASH_REPEAT_CASE} differs "
                                 f"from the first")


def flash_bwd_operands(torch, gen, case):
    """(q, k, v, dO in the case's layout, the plain forward's lse, delta,
    the int arguments, the mask keywords) of one FLASH_BWD_ROUTE_CASES case,
    on the card."""
    from gemm_hls_tpu_torch.ops import flash

    q, k, v, ints, scale, kw = flash_route_operands(torch, gen, case)
    do = signed(torch, q.shape, q.dtype, gen)
    ro, rlse = flash.flash_fwd_plain(flash._pack(q), flash._pack(k), flash._pack(v), *ints,
                                     scale=scale, **kw)
    delta = (flash._pack(do).float() * ro.float()).sum(-1)
    bkw = dict(causal=kw.get("causal", False), window=kw.get("window"),
               logit_cap=kw.get("logit_cap"), scale=scale)
    return q, k, v, do, rlse, delta, ints[1:], bkw


def flash_bwd_launch(torch, ops, which, route=None):
    """dq or (dk, dv) of flash_bwd_operands' ``ops`` on the card, on
    ``route`` (None: flash_bwd_route's)."""
    from gemm_hls_tpu_torch.ops import flash

    q, k, v, do, lse, delta, ints, bkw = ops
    return flash._backward(q, k, v, do, lse, delta, *ints, bkw["causal"], bkw["window"],
                           bkw["logit_cap"], bkw["scale"], 512, which, route=route)


def flash_bwd_route_case(torch, gen, case, route=None):
    """One FLASH_BWD_ROUTE_CASES case: dq, dk and dv on the card, on the
    case's route (or ``route``), against the plain versions; the rows whose
    lse is -inf (every key masked) have dq exactly 0, and a shard that sees
    no key has dk = dv = 0.  Returns the largest abs error."""
    from gemm_hls_tpu_torch.ops import flash

    ops = flash_bwd_operands(torch, gen, case)
    q, k, v, do, lse, delta, ints, bkw = ops
    want, what = route or case[-1], f"flash bwd {case} on {route or case[-1]}"
    dq = flash_bwd_launch(torch, ops, "dq", route)
    dk, dv = flash_bwd_launch(torch, ops, "dkv", route)
    for wrapper in (flash.flash_mha_bwd_dq, flash.flash_mha_bwd_dkv):
        if wrapper.last_route != want:
            raise AssertionError(f"{what}: {wrapper.__name__} took route {wrapper.last_route}")
    packed = [flash._pack(x) for x in (q, k, v, do)]
    rdq = flash.flash_bwd_dq_plain(*packed, lse, delta, *ints, **bkw)
    rdk, rdv = flash.flash_bwd_dkv_plain(*packed, lse, delta, *ints, **bkw)
    err, rtol = 0.0, flash_rtol(torch, q.dtype)
    for name, g, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        g = flash._pack(g)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite {name}")
        err = max(err, compare(torch, g, r, rtol, f"{what} {name}", scaled=True)[0])
    dead = torch.isneginf(lse)
    if bool(dead.any()) and bool(flash._pack(dq)[dead].abs().max() != 0):
        raise AssertionError(f"{what}: dq != 0 on rows that see no key")
    if bool(dead.all()) and bool(dk.abs().max() != 0 or dv.abs().max() != 0):
        raise AssertionError(f"{what}: dk / dv != 0 where no key is seen")
    return err


def flash_bwd_repeats(torch, gen):
    """FLASH_BWD_REPEAT_CASE's dq and dkv launched FLASH_REPEATS times each
    on the same operands: every launch gives the first one's bits."""
    from gemm_hls_tpu_torch.ops import flash

    ops = flash_bwd_operands(torch, gen, FLASH_BWD_REPEAT_CASE)
    for which, wrapper in (("dq", flash.flash_mha_bwd_dq), ("dkv", flash.flash_mha_bwd_dkv)):
        first = flash_bwd_launch(torch, ops, which)
        if wrapper.last_route != FLASH_BWD_REPEAT_CASE[-1]:
            raise AssertionError(f"flash bwd {which} repeats: route {wrapper.last_route}")
        first = first if which == "dkv" else (first,)
        for i in range(FLASH_REPEATS - 1):
            again = flash_bwd_launch(torch, ops, which)
            again = again if which == "dkv" else (again,)
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"flash bwd {which}: launch {i + 2} of "
                                     f"{FLASH_BWD_REPEAT_CASE} differs from the first")


def flash_4d_case(torch, gen, case, dt):
    """One FLASH_4D case in dtype ``dt``: the front door on the card (one
    flash_fwd launch) against the plain version on CPU copies."""
    from gemm_hls_tpu_torch import flash_attention
    from gemm_hls_tpu_torch.ops import flash

    dtype = getattr(torch, dt)
    nb, s_q, hq, hkv, d = case["shape"]
    s_kv = case.get("s_kv", s_q)
    q = signed(torch, (nb, s_q, hq, d), dtype, gen)
    k = signed(torch, (nb, s_kv, hkv, d), dtype, gen)
    v = signed(torch, (nb, s_kv, hkv, d), dtype, gen)
    if case.get("nan_pad"):
        stale_slots(k, v, case["kv_lengths"])
    kw = {x: case[x] for x in ("causal", "kv_lengths") if x in case}
    if case.get("seg"):
        sg = torch.zeros((nb, s_q), dtype=torch.int32)
        sg[:, s_q // 3:] = 1
        kw.update(q_segment_ids=sg, kv_segment_ids=sg)
    before = flash.flash_mha.launches
    got = flash_attention(q, k, v, **kw)
    if flash.flash_mha.launches != before + 1:
        raise AssertionError(f"4-D flash_attention {case}: no flash_fwd launch")
    ref = flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"4-D flash_attention {case} {dt}: non-finite output")
    return compare(torch, got.cpu(), ref, flash_rtol(torch, dtype),
                   f"4-D flash_attention {case} {dt}", scaled=True)[0]


def flash_future_shard(torch, gen, dt):
    """Offsets that put every kv row in the q shard's future: o = 0 and
    lse = -inf on every row."""
    from gemm_hls_tpu_torch.ops import flash
    q = signed(torch, (2, 100, 64), getattr(torch, dt), gen)
    o, lse = flash.flash_mha(q, q, q, offsets=[0, 100], causal=True,
                             save_lse=True)
    if bool(o.float().abs().max() != 0) or not bool(torch.isneginf(lse).all()):
        raise AssertionError(f"fully-future shard {dt}: o != 0 or lse != -inf")


def flash_grad_case(torch, gen, case):
    """fp32 kernel gradients (one dq and one dkv launch) against float64
    autograd of an independent dense reference."""
    from gemm_hls_tpu_torch import flash_attention
    from gemm_hls_tpu_torch.ops import flash

    bh, s, d, causal = case
    qkv = [signed(torch, (bh, s, d), torch.float32, gen) for _ in range(3)]
    before = (flash.flash_mha_bwd_dq.launches, flash.flash_mha_bwd_dkv.launches)
    got = grads(torch, lambda a, b, c: flash_attention(a, b, c, causal=causal),
                qkv, torch.Generator(device="cuda").manual_seed(9))
    if (flash.flash_mha_bwd_dq.launches,
            flash.flash_mha_bwd_dkv.launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"fp32 gradient {case}: backward kernels not launched")
    ref = grads(torch, lambda a, b, c: dense_attention(
                    torch, a, b, c, d ** -0.5, causal).float(),
                qkv, torch.Generator(device="cuda").manual_seed(9))
    for name, g, r in zip("qkv", got, ref):
        compare(torch, g, r, F32_RTOL, f"fp32 d{name} {case} vs float64 autograd",
                scaled=True)


def flash_refusal(torch, what):
    """What no kernel takes is refused on the card, never run another way."""
    from gemm_hls_tpu_torch import flash_attention
    x = torch.zeros((2, 16, 160 if what == "head_dim" else 64), device="cuda",
                    dtype=torch.bfloat16)
    try:
        flash_attention(x, x, x, interpret=what == "interpret")
    except NotImplementedError:
        return
    raise AssertionError(f"flash_attention took {what} on the card")


def dense_attention(torch, q, k, v, scale, causal=False):
    """Independent float64 reference for the gradcheck-style cases."""
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                     device=s.device).triu(1), float("-inf"))
    return torch.softmax(s, -1) @ v.double()


def phase_flash_kernels(torch):
    """Phase 13: each flash kernel against its plain version on the card,
    over the case tables above."""
    gen = torch.Generator(device="cuda").manual_seed(131)
    for case in FLASH_CASES:
        flash_case(torch, gen, case)
    for case in FLASH_4D:
        for dt in ("bfloat16", "float32"):
            flash_4d_case(torch, gen, case, dt)
    for dt in ("bfloat16", "float32"):
        flash_future_shard(torch, gen, dt)
    for case in FLASH_GRAD_CASES:
        flash_grad_case(torch, gen, case)
    for what in FLASH_REFUSALS:
        flash_refusal(torch, what)
    torch.cuda.synchronize()
    n = (len(FLASH_CASES) + 2 * len(FLASH_4D) + 2 + len(FLASH_GRAD_CASES)
         + len(FLASH_REFUSALS))
    log(f"phase 13: flash kernels vs plain, {n} cases (bf16 / fp16 / fp32, D "
        f"16-128, unaligned, S_q = 1, causal, window, cap, kv_lengths with and "
        f"without stale NaN / inf slots, segment ids, offsets, GQA 1/4/8, 4-D "
        f"layouts, decode fast path, fp32 grads vs float64 autograd, "
        f"refusals): ok")
    worst = max(flash_route_case(torch, gen, case) for case in FLASH_ROUTE_CASES)
    flash_repeats(torch, gen)
    torch.cuda.synchronize()
    routes = {}
    for case in FLASH_ROUTE_CASES:
        routes[case[-1]] = routes.get(case[-1], 0) + 1
    log(f"phase 13: flash_fwd route cases, {len(FLASH_ROUTE_CASES)} {routes} (3-D / 4-D, "
        f"D 64 / 128, GQA 1 / 4 / 8, causal, window, cap, kv_lengths with NaN / inf "
        f"stale slots, segment ids, offsets; D 40 / 96, 63 rows, decode, unaligned rows, "
        f"fp32), each on its route: ok (max abs err {worst:.3e}); {FLASH_REPEATS} "
        f"launches of {FLASH_REPEAT_CASE[:8]} on the engine: same bits")
    worst = {}
    for case in FLASH_BWD_ROUTE_CASES:
        worst[case[-1]] = max(worst.get(case[-1], 0.0), flash_bwd_route_case(torch, gen, case))
        if case[-1] == "wgmma":
            worst["mma.sync"] = max(worst.get("mma.sync", 0.0),
                                    flash_bwd_route_case(torch, gen, case, "mma.sync"))
    flash_bwd_repeats(torch, gen)
    torch.cuda.synchronize()
    n_wg = sum(c[-1] == "wgmma" for c in FLASH_BWD_ROUTE_CASES)
    log(f"phase 13: flash_bwd_dq / flash_bwd_dkv route cases, {len(FLASH_BWD_ROUTE_CASES)} "
        f"({n_wg} on the engine and again on mma.sync; D 64 / 128, bf16 / fp16, unaligned "
        f"S, causal, window, cap, S_q 64 x S_kv 1000, GQA 4 / 8 in 3-D / 4-D, segment ids, "
        f"offsets with lse = -inf rows; D 40 / 96, 63 rows, unaligned rows, fp32): ok, max "
        f"abs err by route {worst}; {FLASH_REPEATS} launches of each kernel on "
        f"{FLASH_BWD_REPEAT_CASE[:8]} on the engine: same bits")


def decode_cache(torch, gen, nb=64, slots=4096, hkv=4, d=128, steps=8):
    """The padded decode cache of experiments/serving_bench.py: (nb, slots,
    H_kv, D) bf16 K and V, per-sequence lengths drawn from
    [slots / 2, slots - steps - 1); the slots past each length are stale
    (NaN in K, +inf in V, as an unwritten cache may hold)."""
    import numpy as np
    kc = (torch.randn((nb, slots, hkv, d), generator=gen, device="cuda")
          * 0.3).to(torch.bfloat16)
    vc = (torch.randn((nb, slots, hkv, d), generator=gen, device="cuda")
          * 0.3).to(torch.bfloat16)
    rng = np.random.default_rng(161)
    lens = rng.integers(slots // 2, slots - steps - 1, nb)
    stale_slots(kc, vc, lens)
    return kc, vc, torch.as_tensor(lens, dtype=torch.int32, device="cuda")


def decode_step(torch, q, kn, vn, kc, vc, lens):
    """One decode step: write the new K / V at each sequence's end, then
    attend through the front door's decode fast path."""
    from gemm_hls_tpu_torch import flash_attention
    rows = torch.arange(kc.shape[0], device="cuda")
    kc[rows, lens.long()] = kn[:, 0]
    vc[rows, lens.long()] = vn[:, 0]
    lens += 1
    return flash_attention(q, kc, vc, causal=True, kv_lengths=lens)


def main_route(wrapper, what, want):
    """The route of ``wrapper``'s last launch on a main path, which must be
    ``want`` (the route rule's for that call)."""
    if wrapper.last_route != want:
        raise AssertionError(f"{what}: route {wrapper.last_route}, the rule gives {want}")
    return wrapper.last_route


def phase_slice4(torch):
    """Phase 14: slice 4's main path at full width, counts zeroed before."""
    from gemm_hls_tpu_torch import flash_attention
    from gemm_hls_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(141)
    bf16 = torch.bfloat16
    reset_flash_counters()
    res = {}
    # (32, 1024, 128) full and causal (bench.py:313), causal (8, 8192, 128)
    for key, (bh, s, d), causal in (("full 32x1024", (32, 1024, 128), False),
                                    ("causal 32x1024", (32, 1024, 128), True),
                                    ("causal 8x8192", (8, 8192, 128), True)):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=bf16) for _ in range(3))
        out = flash_attention(q, k, v, causal=causal)
        route = main_route(flash.flash_mha, key, "wgmma")
        ref = flash_plain_fwd(torch, q, k, v, causal=causal, scale=d ** -0.5)[0]
        err = compare(torch, out, ref, BF16_RTOL, key, scaled=True)
        res[key] = err[0]
        log(f"phase 14a: flash_attention {key} ({bh}, {s}, {d}) bf16 "
            f"{'causal' if causal else 'full'}: route {route}, max abs err {err[0]:.3e}, "
            f"scaled rel {err[1]:.3e}")
        del q, k, v, out, ref
    # GQA causal prefill at the serving configuration
    # (experiments/serving_bench.py:29-31), 4-D layout read in place.
    nb, s, hq, hkv, d = 4, 1024, 16, 4, 128
    q = torch.randn((nb, s, hq, d), generator=gen, device="cuda", dtype=bf16)
    k, v = (torch.randn((nb, s, hkv, d), generator=gen, device="cuda",
                        dtype=bf16) for _ in range(2))
    out = flash_attention(q, k, v, causal=True)
    route = main_route(flash.flash_mha, "GQA prefill", "wgmma")
    ref = flash_plain_fwd(torch, q, k, v, causal=True, scale=d ** -0.5)[0]
    err = compare(torch, out, ref, BF16_RTOL, "GQA prefill", scaled=True)
    res["gqa prefill"] = err[0]
    log(f"phase 14b: GQA causal prefill (B={nb}, S={s}, H_q={hq}, H_kv={hkv}, "
        f"D={d}) bf16, 4-D layout: route {route}, max abs err {err[0]:.3e}, scaled rel "
        f"{err[1]:.3e}")
    del q, k, v, out, ref
    # Padded-cache decode, 8 steps (experiments/serving_bench.py:150-161).
    kc, vc, lens = decode_cache(torch, gen)
    worst = 0.0
    for step in range(8):
        qd = torch.randn((64, 1, 16, 128), generator=gen, device="cuda", dtype=bf16)
        kn, vn = (torch.randn((64, 1, 4, 128), generator=gen, device="cuda",
                              dtype=bf16) for _ in range(2))
        out = decode_step(torch, qd, kn, vn, kc, vc, lens)
        if out.shape != qd.shape:
            raise AssertionError(f"decode step {step}: shape {out.shape}")
        ref = flash.flash_fwd_plain(
            qd.reshape(64 * 4, 4, 128), flash._pack(kc), flash._pack(vc),
            lens.repeat_interleave(4), scale=128 ** -0.5)[0]
        worst = max(worst, compare(torch, out.reshape(256, 4, 128), ref,
                                   BF16_RTOL, f"decode step {step}",
                                   scaled=True)[0])
    res["decode"] = worst
    route = main_route(flash.flash_mha, "decode", flash.flash_route(bf16, 128, 4, True))
    log(f"phase 14c: padded-cache decode, 64 sequences x 4096 slots, H_q 16, "
        f"H_kv 4, D 128, 8 steps through the 4-D decode fast path: route {route}, "
        f"lengths now {int(lens.min())}-{int(lens.max())}, max abs err {worst:.3e}")
    del kc, vc
    # One training step's gradient through flash_attention(causal=True).
    bh, s, d = 32, 1024, 128
    xs = [torch.randn((bh, s, d), generator=gen, device="cuda", dtype=bf16)
          .requires_grad_() for _ in range(3)]
    w = torch.randn((bh, s, d), generator=gen, device="cuda", dtype=bf16)
    (flash_attention(*xs, causal=True).float() * w.float()).sum().backward()
    q, k, v = (x.detach() for x in xs)
    ro, rlse = flash.flash_fwd_plain(q, k, v, causal=True, scale=d ** -0.5)
    delta = (w.float() * ro.float()).sum(-1)
    kw = dict(causal=True, scale=d ** -0.5)
    refs = (flash.flash_bwd_dq_plain(q, k, v, w, rlse, delta, **kw),
            *flash.flash_bwd_dkv_plain(q, k, v, w, rlse, delta, **kw))
    worst = 0.0
    for name, x, r in zip(("dq", "dk", "dv"), xs, refs):
        worst = max(worst, compare(torch, x.grad, r, BF16_RTOL,
                                   f"training d{name}", scaled=True)[0])
    res["train grad"] = worst
    routes = (main_route(flash.flash_mha_bwd_dq, "training dq", "wgmma"),
              main_route(flash.flash_mha_bwd_dkv, "training dk, dv", "wgmma"))
    log(f"phase 14d: training gradient through flash_attention(causal=True) "
        f"at ({bh}, {s}, {d}) bf16: routes dq {routes[0]}, dk / dv {routes[1]}; dq, dk, "
        f"dv max abs err {worst:.3e}")
    launches = flash_counters()
    log(f"phase 14: main-path launch counts {launches}")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice 4 "
                                 f"main path")
    # Where the training gradient's time goes: device busy share and kernels
    # by device time (torch.profiler over synchronised calls).
    busy, kernels = device_profile(torch, lambda: torch.autograd.grad(
        (flash_attention(*xs, causal=True) * w).sum(), xs), 5)
    res["train grad busy"] = busy
    res["train grad kernels"] = kernels
    log(f"phase 14e: profile of the training gradient at ({bh}, {s}, {d}) causal: device "
        f"busy {busy:.1%} of the window, {sum(us for _, us in kernels):.1f} us of kernels a "
        f"call: " + "; ".join(f"{name[:60]} {us:.1f} us" for name, us in kernels[:12]))
    return launches, res


def sdpa_backends(torch):
    """The SDPA backends the library yardstick is pinned to, in turn: cuDNN
    and FlashAttention-2, each where this PyTorch has it."""
    from torch.nn.attention import SDPBackend
    return [(name, getattr(SDPBackend, attr)) for name, attr in (
        ("cuDNN", "CUDNN_ATTENTION"), ("flash", "FLASH_ATTENTION")) if hasattr(SDPBackend, attr)]


def pinned_sdpa(torch, backend, q, k, v, causal):
    """scaled_dot_product_attention of 3-D (B, S, D) operands under one
    pinned backend (a yardstick, timed here and never called by the port)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    def run():
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  is_causal=causal)[0]
    return run


def sdpa_grads(torch, q, k, v, do, causal):
    """{"SDPA bwd <backend>": callable} of scaled_dot_product_attention's
    backward (dq, dk, dv in one autograd call) on (batch, H, S, D) operands,
    for each pinned backend that takes them (a yardstick, never called by
    the port)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    fns = {}
    for name, backend in sdpa_backends(torch):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        try:
            with sdpa_kernel([backend]):
                og = F.scaled_dot_product_attention(*xs, is_causal=causal)
            torch.autograd.grad(og, xs, do, retain_graph=True)
        except RuntimeError as exc:  # a backend that refuses these operands
            log(f"phase 15: SDPA {name} refused ({exc.__class__.__name__}: {str(exc)[:80]})")
            continue
        fns[f"SDPA bwd {name}"] = (lambda og=og, xs=xs:
                                   torch.autograd.grad(og, xs, do, retain_graph=True))
    return fns


def phase_times4(torch):
    """Phase 15: flash kernel times beside their plain versions, their
    bounds and scaled_dot_product_attention, and the end-to-end calls of
    phase 14 (launches here are comparisons, not the main path's).  The
    kernels, the forward's other route and SDPA under each pinned backend
    (forward, and backward through autograd) are timed in turns, one window
    each a round; the library time is the faster backend's."""
    from gemm_hls_tpu_torch import flash_attention
    from gemm_hls_tpu_torch.models.perf_model import H100, flash_bound
    from gemm_hls_tpu_torch.ops import flash
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    gen = torch.Generator(device="cuda").manual_seed(151)
    bf16 = torch.bfloat16
    out = {}
    backends = sdpa_backends(torch)

    def fwd(q, k, v, causal, route=None):
        return lambda: flash._forward(q, k, v, None, None, None, None, causal, None, None,
                                      q.shape[-1] ** -0.5, 512, route=route)[0]

    def bwd(bargs, which, route=None):
        return lambda: flash._backward(*bargs, which=which, route=route)

    def with_delta(bargs, o, do):
        """The pair with the delta pass before it (what the autograd
        Function runs, beside SDPA's backward, which computes its delta
        inside)."""
        def run():
            delta = flash._pack((do.float() * o.float()).sum(-1, keepdim=True))[..., 0]
            b = bargs[:5] + (delta,) + bargs[6:]
            return flash._backward(*b, which="dq"), flash._backward(*b, which="dkv")
        return run

    def library(q, k, v, causal):
        """{backend: callable} of SDPA's forward for each backend that takes
        these operands (its backward: ``sdpa_grads``)."""
        fns = {}
        for name, backend in backends:
            run = pinned_sdpa(torch, backend, q, k, v, causal)
            try:
                run()
                fns[name] = run
            except RuntimeError as exc:  # a backend that refuses these operands
                log(f"phase 15: SDPA {name} refused ({exc.__class__.__name__}: "
                    f"{str(exc)[:80]})")
        return fns

    for bh, s, d, causal in ((32, 1024, 128, True), (32, 1024, 128, False)):
        tag = "causal" if causal else "full"
        q, k, v, do = (torch.randn((bh, s, d), generator=gen, device="cuda",
                                   dtype=bf16) for _ in range(4))
        sc = d ** -0.5
        ro, rlse = flash.flash_fwd_plain(q, k, v, causal=causal, scale=sc)
        delta = (do.float() * ro.float()).sum(-1)
        bargs = (q, k, v, do, rlse, delta, None, None, None, causal, None, None, sc, 512)
        pkw = dict(causal=causal, scale=sc)
        kern = {"flash_fwd": fwd(q, k, v, causal),
                "flash_bwd_dq": bwd(bargs, "dq"),
                "flash_bwd_dkv": bwd(bargs, "dkv")}
        plain = {"flash_fwd": lambda: flash.flash_fwd_plain(q, k, v, **pkw)[0],
                 "flash_bwd_dq": lambda: flash.flash_bwd_dq_plain(q, k, v, do, rlse, delta, **pkw),
                 "flash_bwd_dkv": lambda: flash.flash_bwd_dkv_plain(q, k, v, do, rlse, delta,
                                                                    **pkw)}
        errs = {}
        for name in kern:
            got, ref = kern[name](), plain[name]()
            got, ref = (got, ref) if name != "flash_bwd_dkv" else (got[0], ref[0])
            errs[name] = compare(torch, got, ref, BF16_RTOL, f"timed {name}", scaled=True)[0]
        routes = {"flash_fwd": flash.flash_mha.last_route,
                  "flash_bwd_dq": flash.flash_mha_bwd_dq.last_route,
                  "flash_bwd_dkv": flash.flash_mha_bwd_dkv.last_route}
        old = "mma.sync"  # each kernel's other tensor-core route
        lib_f = library(q, k, v, causal)
        lib_b = sdpa_grads(torch, q[None], k[None], v[None], do[None], causal)
        turns = time_turns(torch, dict(
            kern, **{f"flash_fwd {old}": fwd(q, k, v, causal, old),
                     f"flash_bwd_dq {old}": bwd(bargs, "dq", old),
                     f"flash_bwd_dkv {old}": bwd(bargs, "dkv", old),
                     "pair + delta": with_delta(bargs, ro, do)},
            **{f"SDPA fwd {n}": f for n, f in lib_f.items()}, **lib_b))
        lib_b = [n[len("SDPA bwd "):] for n in lib_b]
        best_f = min(lib_f, key=lambda n: turns[f"SDPA fwd {n}"])
        best_b = min(lib_b, key=lambda n: turns[f"SDPA bwd {n}"])
        for name in kern:
            which = {"flash_fwd": "fwd", "flash_bwd_dq": "dq", "flash_bwd_dkv": "dkv"}[name]
            ms = turns[name]
            plain_ms = time_fn(plain[name], [()], iters=3, warmup=1) * 1e3
            bound = flash_bound(H100, bh, s, s, d, bf16, causal, which)
            entry = dict(ms=ms, plain_ms=plain_ms, max_abs_err=errs[name], bound=bound,
                         library_ms=None, route=routes[name], other_route=old,
                         other_ms=turns[f"{name} {old}"])
            if which == "fwd":
                entry.update(library_ms=turns[f"SDPA fwd {best_f}"], library=f"SDPA {best_f}")
            out[f"{name} {tag}"] = entry
            log(f"phase 15: {name} ({bh}, {s}, {d}) bf16 {tag}: {ms:.4f} ms"
                f" (route {routes[name]}; {old} {entry['other_ms']:.4f} ms)"
                + f" vs plain {plain_ms:.3f} ms, bound {bound[0] * 1e3:.4f} ms ({bound[1]}); "
                f"max abs err {errs[name]:.3e}"
                + ("; SDPA forward " + ", ".join(f"{n} {turns[f'SDPA fwd {n}']:.4f} ms"
                                                 for n in lib_f) if which == "fwd" else ""))
        # SDPA's backward yields dq, dk and dv in one call: it stands beside
        # the pair of kernels, on flash_bwd_dkv's entry, never beside dq alone.
        pair = out[f"flash_bwd_dq {tag}"]["ms"] + out[f"flash_bwd_dkv {tag}"]["ms"]
        out[f"flash_bwd_dkv {tag}"].update(library_ms=turns[f"SDPA bwd {best_b}"], pair_ms=pair,
                                           library=f"SDPA {best_b}",
                                           pair_delta_ms=turns["pair + delta"])
        log(f"phase 15: flash_bwd_dq + flash_bwd_dkv ({bh}, {s}, {d}) bf16 {tag}: "
            f"{pair:.4f} ms on the engine, "
            f"{turns[f'flash_bwd_dq {old}'] + turns[f'flash_bwd_dkv {old}']:.4f} ms on {old}; "
            f"with the delta pass {turns['pair + delta']:.4f} ms; vs SDPA backward (dq, dk, dv) "
            + ", ".join(f"{n} {turns[f'SDPA bwd {n}']:.4f} ms" for n in lib_b)
            + " (pinned backends, timed in turns)")
        del q, k, v, do

    # The forward's routes at the other main-path shapes, in turns with SDPA.
    for key, shape, causal in (("causal 8x8192", (8, 8192, 128), True),
                               ("GQA prefill 4x1024 H16/4", None, True)):
        if shape:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=bf16)
                       for _ in range(3))
            lib_f = library(q, k, v, causal)
        else:
            q = torch.randn((4, 1024, 16, 128), generator=gen, device="cuda", dtype=bf16)
            k, v = (torch.randn((4, 1024, 4, 128), generator=gen, device="cuda", dtype=bf16)
                    for _ in range(2))
            lib_f = {}
        fns = {r: fwd(q, k, v, causal, r) for r in ("wgmma", "mma.sync")}
        turns = time_turns(torch, dict(fns, **{f"SDPA fwd {n}": f for n, f in lib_f.items()}))
        out[f"flash_fwd {key}"] = turns
        log(f"phase 15: flash_fwd {key} bf16 causal, in turns: "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in turns.items()))
        del q, k, v
    out["bound causal 8x8192"] = flash_bound(H100, 8, 8192, 8192, 128, bf16, True)[0] * 1e3

    # The backward pair at the other main-path shapes, in turns: both routes,
    # the pair with its delta pass, SDPA's backward (on (batch, H, S, D)
    # copies; the GQA prefill's K and V expanded to the q heads, so SDPA's dk
    # and dv are per q head, not summed).
    for key, shape, causal in (("causal 8x8192", (8, 8192, 128), True),
                               ("GQA prefill 4x1024 H16/4", None, True)):
        if shape:
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda", dtype=bf16)
                           for _ in range(4))
            lib4 = [x[None] for x in (q, k, v, do)]
        else:
            q, do = (torch.randn((4, 1024, 16, 128), generator=gen, device="cuda", dtype=bf16)
                     for _ in range(2))
            k, v = (torch.randn((4, 1024, 4, 128), generator=gen, device="cuda", dtype=bf16)
                    for _ in range(2))
            lib4 = [x.permute(0, 2, 1, 3).repeat_interleave(16 // x.shape[2], 1).contiguous()
                    for x in (q, k, v, do)]
        sc = 128 ** -0.5
        o, lse = flash._forward(q, k, v, None, None, None, None, causal, None, None, sc, 512)
        delta = flash._pack((do.float() * o.float()).sum(-1, keepdim=True))[..., 0]
        bargs = (q, k, v, do, lse, delta, None, None, None, causal, None, None, sc, 512)
        fns = {f"{w} {r}": bwd(bargs, w, r) for r in ("wgmma", "mma.sync") for w in ("dq", "dkv")}
        fns["pair + delta"] = with_delta(bargs, o, do)
        for w in ("dq", "dkv"):
            got, ref = fns[f"{w} wgmma"](), fns[f"{w} mma.sync"]()
            if flash.flash_mha_bwd_dq.last_route != "mma.sync" and w == "dq":
                raise AssertionError(f"{key}: the route override was not taken")
            for g, r in zip(got if w == "dkv" else (got,), ref if w == "dkv" else (ref,)):
                compare(torch, g, r, BF16_RTOL, f"{key} {w} engine vs mma.sync", scaled=True)
        fns.update(sdpa_grads(torch, *lib4, causal))
        turns = time_turns(torch, fns)
        out[f"bwd pair {key}"] = turns
        log(f"phase 15: flash_bwd_dq + flash_bwd_dkv {key} bf16 causal, in turns: "
            f"pair {turns['dq wgmma'] + turns['dkv wgmma']:.4f} ms on the engine "
            f"(dq {turns['dq wgmma']:.4f}, dkv {turns['dkv wgmma']:.4f}), "
            f"{turns['dq mma.sync'] + turns['dkv mma.sync']:.4f} ms on mma.sync, with the "
            f"delta pass {turns['pair + delta']:.4f} ms; "
            + ", ".join(f"{n} {t:.4f} ms" for n, t in turns.items() if n.startswith("SDPA")))
        del q, k, v, do, o, lib4

    # End-to-end calls of phase 14 (front door, host clock after a sync is
    # the same as CUDA events here: each timed window ends in a sync).
    def e2e(key, fn, args, iters=10):
        out[key] = time_fn(fn, [args], iters=iters) * 1e3
        log(f"phase 15: end to end {key}: {out[key]:.4f} ms")

    for key, (bh, s, d), causal in (("full 32x1024", (32, 1024, 128), False),
                                    ("causal 32x1024", (32, 1024, 128), True),
                                    ("causal 8x8192", (8, 8192, 128), True)):
        q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda",
                               dtype=bf16) for _ in range(3))
        e2e(f"flash_attention {key}",
            lambda a, b, c, causal=causal: flash_attention(a, b, c, causal=causal),
            (q, k, v))
        del q, k, v
    q = torch.randn((4, 1024, 16, 128), generator=gen, device="cuda", dtype=bf16)
    k, v = (torch.randn((4, 1024, 4, 128), generator=gen, device="cuda",
                        dtype=bf16) for _ in range(2))
    e2e("GQA prefill 4x1024 H16/4", lambda a, b, c: flash_attention(a, b, c, causal=True),
        (q, k, v))
    del q, k, v
    kc, vc, lens = decode_cache(torch, gen)
    qd = torch.randn((64, 1, 16, 128), generator=gen, device="cuda", dtype=bf16)
    e2e("decode attention 64x4096 H16/4",
        lambda a: flash_attention(a, kc, vc, causal=True, kv_lengths=lens), (qd,),
        iters=20)
    mean_len = float(lens.float().mean())
    bound = flash_bound(H100, 256, 4, int(mean_len), 128, bf16, False, "fwd")
    out["bound decode"] = bound[0] * 1e3
    log(f"phase 15: decode attention bound at mean length {mean_len:.0f}: "
        f"{bound[0] * 1e3:.4f} ms ({bound[1]})")
    del kc, vc
    xs = [torch.randn((32, 1024, 128), generator=gen, device="cuda", dtype=bf16)
          .requires_grad_() for _ in range(3)]
    w = torch.randn((32, 1024, 128), generator=gen, device="cuda", dtype=bf16)

    def train_grad(a, b, c):
        return torch.autograd.grad((flash_attention(a, b, c, causal=True) * w).sum(),
                                   (a, b, c))
    e2e("training gradient causal 32x1024", train_grad, xs)
    return out


# ---------------------------------------------------------------------------
# Slice 5: the serving path -- the quantized GEMMs (B13-B15), the grouped
# GEMM (B16), the MoE FFN and the serving decoder block
# ---------------------------------------------------------------------------

def quant_counters():
    from gemm_hls_tpu_torch.ops import dequant, gmm
    return {"B13": dequant.dequant_matmul.launches,
            "B14": dequant.w8a8_matmul.fused_launches,
            "B15": dequant.w8a8_matmul.launches,
            "B16": gmm.grouped_mxu.launches}


def reset_quant_counters():
    from gemm_hls_tpu_torch.ops import dequant, gmm
    dequant.dequant_matmul.launches = 0
    dequant.w8a8_matmul.fused_launches = dequant.w8a8_matmul.launches = 0
    dequant.w8a8_matmul.routes = {}
    dequant.w8a8_matmul.last_route = None
    gmm.grouped_mxu.launches = 0


# Phase 16's case tables, which tests/test_torch_kernels.py parametrises
# too.  B13: (x dtype, bits, group (None: per-channel), M, N, K, block_k
# (None: the front door's)).  M 1, 64 (decode) and 130; N 1001 and 520
# (ragged: the byte-wise weight loads); one and several groups per K-block.
DEQUANT_CASES = (
    [(dt, bits, g, m, n, k, bk)
     for dt in ("bfloat16", "float32")
     for bits, g, bk in ((8, None, None), (8, 64, None), (4, 128, None),
                         (4, None, None), (8, 128, 128), (4, 64, 64))
     for m, n, k in ((1, 1001, 256), (64, 2048, 2048), (130, 520, 1024))]
    + [("float16", 4, 128, 64, 2048, 2048, None),
       ("float16", 8, None, 130, 1001, 512, None)]
    # Groups of 32, under the kernel's 64-deep K step: the int4 g32 decode
    # projections of examples/15_serving_decoder.py:53, and int8.
    + [("bfloat16", bits, 32, m, n, k, None)
       for bits in (4, 8) for m, n, k in ((1, 1001, 256), (64, 2048, 2048))]
)
# B13's routes (``ops.dequant.dequant_route``), phase 16's route table,
# which tests/test_torch_kernels.py parametrises too: (x dtype, bits, group
# (None: per-channel), M, N, K, output dtype (None: x's), route).  Each
# engine case runs again on mma.sync (the route override).  The engine:
# int8 and int4; per-channel, g32, g64, g128 and g256 (a step inside one
# group's half); M 1, 64, 130 and 256; N 512 and 2048, and 528 (off every N
# tile); per-channel int4 with K split across the halves (K 2048: the
# splits of a tile's cluster read x at p and p + K/2); K 96 and 384 (a
# partial step, three steps); fp16; fp32 outputs.  mma.sync: N 1001, a
# group that does not tile the 128-deep step (96), per-channel int8 at K
# 1000.  simt: fp32 x.
DEQUANT_ROUTE_CASES = (
    [("bfloat16", 4, 128, 64, n, 2048, None, "wgmma") for n in (2048, 512)]
    + [("bfloat16", 4, 32, 64, 2048, 2048, None, "wgmma"),
       ("bfloat16", 4, 64, 130, 512, 1024, None, "wgmma"),
       ("bfloat16", 4, 256, 64, 512, 2048, None, "wgmma"),
       ("bfloat16", 4, None, 64, 512, 2048, None, "wgmma"),
       ("bfloat16", 4, None, 1, 2048, 1024, "float32", "wgmma"),
       ("bfloat16", 4, 32, 1, 528, 96, None, "wgmma"),
       ("bfloat16", 8, None, 256, 512, 1024, None, "wgmma"),
       ("bfloat16", 8, 32, 1, 512, 2048, None, "wgmma"),
       ("bfloat16", 8, 64, 130, 2048, 512, "float32", "wgmma"),
       ("bfloat16", 8, 128, 256, 2048, 2048, None, "wgmma"),
       ("float16", 4, 128, 64, 2048, 2048, None, "wgmma"),
       ("float16", 4, 64, 256, 512, 384, None, "wgmma"),
       ("float16", 8, None, 130, 512, 1024, "float32", "wgmma"),
       ("bfloat16", 4, 128, 64, 1001, 2048, None, "mma.sync"),
       ("bfloat16", 8, 96, 64, 512, 960, None, "mma.sync"),
       ("bfloat16", 8, None, 64, 512, 1000, None, "mma.sync"),
       ("float32", 4, 128, 64, 512, 1024, None, "simt")]
)
DEQUANT_RUNS = ([(case, None) for case in DEQUANT_ROUTE_CASES]
                + [(case, "mma.sync") for case in DEQUANT_ROUTE_CASES if case[-1] == "wgmma"])
# The race check of the engine route: the decode q projection.
DEQUANT_REPEAT_CASE = DEQUANT_ROUTE_CASES[0]
DEQUANT_REPEATS = 20
# B14 / B15: (x dtype, group, M, N, K, fuse_quant asked, zero rows, out
# dtype, route the JAX rule gives).
W8A8_CASES = [
    ("bfloat16", None, 256, 512, 1024, True, False, "bfloat16", "B14"),
    ("bfloat16", 128, 200, 384, 512, True, True, "float32", "B14"),
    ("float32", None, 96, 256, 8192, True, True, "float32", "B14"),  # 2 K-blocks
    ("float16", None, 64, 256, 2048, True, False, "float16", "B14"),
    # a 1000-wide N tile is not a multiple of 128: the two-pass route
    ("float32", None, 130, 1000, 640, True, True, "float32", "B15"),
    ("bfloat16", None, 333, 256, 2048, False, True, "bfloat16", "B15"),  # int_acc
    ("float32", 64, 64, 200, 512, False, False, "float32", "B15"),  # per block
    # 127^2 K >= 2^31: per-block fp32 scaling, N ragged
    ("float32", None, 8, 130, 135168, False, False, "float32", "B15"),
]
# B14 / B15's routes (``ops.dequant.w8a8_route``), phase 16's route table,
# which tests/test_torch_kernels.py parametrises too: (x dtype, group
# (None: per-channel), M, N, K, block_k (None: the front door's), fuse_quant
# asked, zero rows, output dtype, route).  Each engine case runs again on
# mma.sync (the route override) and must give the same bits.  The engine:
# the three modes (fused with one scale block, as the prefill; int_acc;
# per_block group-wise and past the int32 bound), fused with 4 K-blocks
# and group-wise (bk 128), per_block group-wise at bk 256; bf16 / fp16 /
# fp32 x and outputs; M 1, 64, 130 and 2200 / 4864 (enough tiles for the
# 128-wide N tile on an H100); N 512, 2048, 784 (off both N tiles) and 144;
# K 1040 (a partial 128-deep step).  mma.sync: K off 16 bytes, N off 16
# bytes, per_block at bk 64 and bk 32 (the tile's 32-deep fold).
W8A8_ROUTE_CASES = (
    ("bfloat16", None, 2200, 2048, 1024, None, True, True, "bfloat16", "wgmma"),
    ("float32", None, 4864, 784, 512, None, False, True, "float32", "wgmma"),
    ("bfloat16", None, 130, 2048, 2048, None, True, True, "bfloat16", "wgmma"),
    ("bfloat16", None, 64, 512, 2048, None, False, False, "bfloat16", "wgmma"),
    ("float16", None, 1, 2048, 1024, None, True, False, "float16", "wgmma"),
    ("float32", None, 130, 784, 1024, None, False, True, "float32", "wgmma"),
    ("bfloat16", None, 64, 512, 1040, None, False, True, "float32", "wgmma"),
    ("bfloat16", None, 130, 784, 2048, 512, True, True, "bfloat16", "wgmma"),
    ("bfloat16", 128, 64, 512, 1024, None, True, False, "float32", "wgmma"),
    ("float16", 256, 130, 2048, 1024, None, False, True, "bfloat16", "wgmma"),
    ("float32", 128, 1, 784, 512, None, False, False, "float16", "wgmma"),
    ("float32", None, 8, 144, 135168, None, False, False, "float32", "wgmma"),
    ("bfloat16", None, 64, 512, 1000, None, False, False, "bfloat16", "mma.sync"),
    ("bfloat16", None, 130, 1000, 1024, None, False, True, "bfloat16", "mma.sync"),
    ("bfloat16", 64, 64, 512, 1024, None, False, False, "float32", "mma.sync"),
    ("float32", 32, 130, 256, 512, None, False, True, "float32", "mma.sync"),
)
# The race check of the engine route: a fused case on the 128-wide N tile.
W8A8_REPEAT_CASE = W8A8_ROUTE_CASES[0]
W8A8_REPEATS = 20
# B16: tests/test_grouped.py:40-48's (M, K, N, group sizes), each with and
# without transpose_rhs, in bf16, fp16 and fp32.
_GROUPED_SHAPES = [
    (64, 32, 48, [16, 16, 16, 16]), (100, 33, 48, [10, 0, 55, 35]),
    (100, 33, 48, [10, 7, 55, 8]), (7, 130, 129, [3, 3, 1]),
    (256, 64, 64, [256]), (50, 16, 16, [0, 0, 0, 0, 0]),
    (96, 24, 40, [1, 1, 1, 93]),
]
GROUPED_CASES = [(dt, m, k, n, gs, trb) for dt in _DT
                 for m, k, n, gs in _GROUPED_SHAPES for trb in (False, True)]
# B16's routes (``ops.gmm.grouped_route``), phase 16's route table, which
# tests/test_torch_kernels.py parametrises too: (dtype, M, K, N, group
# sizes, transpose_rhs, rows past the groups NaN, output dtype (None: the
# input's), route).  The engine, both transpose_rhs: empty groups, a group
# over several 128-row tiles, several groups in one tile, routing past M
# (clamped), NaN rows past the groups, K off the 64-deep slab and N off the
# 256-wide tile (N odd under transpose_rhs), fp32 outputs, fp16.  mma.sync:
# K (or N without transpose_rhs) not whole 16-byte units; fp32 on the CUDA
# cores.
GROUPED_ROUTE_CASES = (
    [(dt, 300, 128, 264, [100, 0, 150, 0], trb, False, None, "wgmma")
     for dt in ("bfloat16", "float16") for trb in (False, True)]
    + [(dt, m, k, n, gs, trb, nan, None, "wgmma") for trb in (False, True)
       for dt, m, k, n, gs, nan in (
           ("bfloat16", 1000, 256, 384, [700, 300], False),
           ("bfloat16", 128, 64, 256, [10, 20, 30, 5, 40, 23], True),
           ("bfloat16", 300, 136, 200, [200, 200], False),
           ("float16", 300, 136, 200, [7, 250, 0, 20], True),
           ("bfloat16", 200, 72, 136, [50, 0, 150], False))]
    + [("bfloat16", 256, 128, 256, [100, 0, 156], False, False, "float32", "wgmma"),
       ("float16", 256, 128, 256, [100, 0, 156], True, True, "float32", "wgmma"),
       ("bfloat16", 256, 64, 33, [100, 156], True, False, None, "wgmma")]
    + [("bfloat16", 256, 33, 64, [100, 156], trb, False, None, "mma.sync")
       for trb in (False, True)]
    + [("bfloat16", 256, 64, 33, [100, 156], False, True, None, "mma.sync"),
       ("float32", 256, 64, 64, [100, 156], False, True, None, "simt")]
)
# The race check of the engine route.
GROUPED_REPEAT_CASE = ("bfloat16", 1000, 256, 384, [700, 0, 300], False, False, None, "wgmma")
GROUPED_REPEATS = 20
# Phase 19's B17 table, which tests/test_torch_kernels.py parametrises too:
# (dtype, M, K, N, group sizes, output dtype (None: the input's), rows past
# the groups NaN in both operands).  _GROUPED_SHAPES in bf16 / fp16 / fp32
# (all groups empty included), then NaN rows past the groups, routing past
# M (clamped), K and N off the tiles (130 x 129 element loads; 136 x 200
# vector loads), long groups over several row chunks and tiles, an fp32
# output of bf16 operands.
GROUPED_UPDATE_CASES = (
    [(dt, m, k, n, gs, None, False) for dt in _DT for m, k, n, gs in _GROUPED_SHAPES]
    + [(dt, 96, 24, 40, [30, 0, 41], None, True) for dt in _DT]
    + [(dt, 100, 64, 72, [60, 70, 20], None, False) for dt in ("bfloat16", "float32")]
    + [(dt, 300, 130, 129, [100, 0, 150, 30], None, True) for dt in _DT]
    + [(dt, 300, 136, 200, [7, 250, 0, 40], None, False) for dt in ("bfloat16", "float32")]
    + [("bfloat16", 1000, 256, 384, [700, 300], None, False),
       ("float32", 1000, 256, 384, [1, 0, 999], None, False),
       ("bfloat16", 2048, 512, 1024, [512, 0, 300, 700, 1, 35, 200, 300], "float32",
        False)]
)
# B17's routes (``ops.gmm.grouped_update_route``), phase 19's route table,
# which tests/test_torch_kernels.py parametrises too: (dtype, M, K, N, group
# sizes, output dtype (None: the input's), rows past the groups NaN in both
# operands, route).  Each engine case runs again on mma.sync through the
# route override.  The engine: spans that start off a multiple of 64 and
# spans shorter than 64 (the last slab's lines past the span zeroed in both
# operands), empty groups (exactly zero), NaN rows past the groups, routing
# past M (clamped), K and N off the 128 x 256 tile, spans over several
# slabs and tiles, fp16, fp32 outputs, every group empty, one row.
# mma.sync: K or N not whole 16-byte units.  fp32 on the CUDA cores.
GROUPED_UPDATE_ROUTE_CASES = (
    [(dt, 600, 256, 512, [70, 0, 33, 200, 5, 100], None, True, "wgmma")
     for dt in ("bfloat16", "float16")]
    + [("bfloat16", 300, 128, 256, [10, 20, 0, 63, 1, 250], None, False, "wgmma"),
       ("bfloat16", 1000, 136, 264, [300, 0, 450, 130], None, True, "wgmma"),
       ("float16", 1000, 200, 72, [129, 64, 0, 500], "float32", True, "wgmma"),
       ("bfloat16", 2048, 512, 1024, [512, 0, 300, 700, 1, 35, 200, 300], "float32", False,
        "wgmma"),
       ("bfloat16", 256, 64, 64, [0, 0, 0], None, True, "wgmma"),
       ("float16", 1, 8, 8, [1], None, False, "wgmma"),
       ("bfloat16", 300, 130, 129, [100, 0, 150, 30], None, True, "mma.sync"),
       ("bfloat16", 300, 136, 100, [100, 0, 150, 30], None, False, "mma.sync"),
       ("float32", 300, 136, 200, [7, 250, 0, 40], None, True, "simt")]
)
# The race check of B17's engine route.
GROUPED_UPDATE_REPEAT_CASE = ("bfloat16", 2048, 512, 1024, [900, 0, 1000, 48], None, True,
                              "wgmma")
GROUPED_UPDATE_REPEATS = 20
# grouped_matmul's gradients on the card: (dtype, transpose_rhs, explicit
# GemmConfig()), the last two the mixed case (bf16 operands, fp32 output
# and cotangent).
GROUPED_GRAD_CASES = [(dt, trb, False) for dt in ("bfloat16", "float32")
                      for trb in (False, True)] + [
                          ("bfloat16", trb, True) for trb in (False, True)]


def quant_rtol(torch, dtype):
    return F32_RTOL if dtype == torch.float32 else BF16_RTOL


def _host(torch, t):
    return t.float().cpu().numpy()


def dequant_case(torch, gen, case):
    """One DEQUANT_CASES case: the front door on the card (one B13 launch)
    against the plain version on the same card operands.  Returns the
    largest abs error."""
    from gemm_hls_tpu_torch import GemmConfig, matmul_quantized, quantize_weights
    from gemm_hls_tpu_torch.ops import dequant

    dt, bits, g, m, n, k, bk = case
    dtype = getattr(torch, dt)
    w = torch.randn((k, n), generator=gen, device="cuda")
    wq, s = (torch.from_numpy(a).cuda()
             for a in quantize_weights(_host(torch, w), bits=bits, group_size=g))
    x = signed(torch, (m, k), dtype, gen)
    cfg = GemmConfig(block_k=bk) if bk else None
    before = dequant.dequant_matmul.launches
    got = matmul_quantized(x, wq, s, bits=bits, group_size=g, config=cfg)
    if dequant.dequant_matmul.launches != before + 1:
        raise AssertionError(f"B13 {case}: no launch")
    ref = dequant.dequant_matmul_plain(x, wq, s, bits=bits, group_size=g)
    return compare(torch, got, ref, quant_rtol(torch, dtype), f"B13 {case}",
                   scaled=True)[0]


def dequant_route_operands(torch, gen, case):
    from gemm_hls_tpu_torch import GemmConfig, quantize_weights
    dt, bits, g, m, n, k, out, _ = case
    w = torch.randn((k, n), generator=gen, device="cuda")
    wq, s = (torch.from_numpy(a).cuda()
             for a in quantize_weights(_host(torch, w), bits=bits, group_size=g))
    x = signed(torch, (m, k), getattr(torch, dt), gen)
    # block_k K: whole scale groups in one K-block (it decides no bit here).
    return x, wq, s, dict(cfg=GemmConfig(dtype=dt, block_k=k, out_dtype=out), bits=bits,
                          group_size=g)


def dequant_route_case(torch, gen, case, route=None):
    """One DEQUANT_ROUTE_CASES case on its route (or ``route``, the
    override), checked, against the plain version at quant_rtol.  Returns
    the largest abs error."""
    from gemm_hls_tpu_torch.ops import dequant
    x, wq, s, kw = dequant_route_operands(torch, gen, case)
    got = dequant.dequant_matmul(x, wq, s, route=route, **kw)
    if dequant.dequant_matmul.last_route != (route or case[-1]):
        raise AssertionError(f"B13 {case}: route {dequant.dequant_matmul.last_route}")
    ref = dequant.dequant_matmul_plain(x, wq, s, bits=kw["bits"], group_size=kw["group_size"],
                                       out_dtype=got.dtype)
    return compare(torch, got, ref, quant_rtol(torch, got.dtype),
                   f"B13 {case} on {route or case[-1]}", scaled=True)[0]


def dequant_repeats(torch, gen):
    """DEQUANT_REPEAT_CASE launched DEQUANT_REPEATS times: the same bits
    each (the cluster's sum runs in rank order, no atomics)."""
    from gemm_hls_tpu_torch.ops import dequant
    x, wq, s, kw = dequant_route_operands(torch, gen, DEQUANT_REPEAT_CASE)
    first = dequant.dequant_matmul(x, wq, s, **kw)
    if dequant.dequant_matmul.last_route != DEQUANT_REPEAT_CASE[-1]:
        raise AssertionError(f"B13 {DEQUANT_REPEAT_CASE}: route "
                             f"{dequant.dequant_matmul.last_route}")
    for i in range(DEQUANT_REPEATS - 1):
        if not torch.equal(first, dequant.dequant_matmul(x, wq, s, **kw)):
            raise AssertionError(f"B13: launch {i + 2} of {DEQUANT_REPEAT_CASE} differs from "
                                 f"the first")


def w8a8_case(torch, gen, case):
    """One W8A8_CASES case: the route the JAX rule gives (checked by the
    launch counters), its int8 activations equal to the plain quantize's,
    and its output against the plain version on the same card operands
    (the int32 products are exact on both sides; the fp32 scaling runs in
    the same order)."""
    from gemm_hls_tpu_torch import quantize_weights
    from gemm_hls_tpu_torch.ops import dequant, quant

    dt, g, m, n, k, fuse, zero_rows, out, route = case
    dtype, out_dtype = getattr(torch, dt), getattr(torch, out)
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    wq, s = (torch.from_numpy(a).cuda()
             for a in quantize_weights(_host(torch, w), bits=8, group_size=g))
    x = signed(torch, (m, k), dtype, gen) * 4
    x[:, : k // 2] *= 20
    if zero_rows:
        x[3] = 0
        x[m - 1] = 0
    cfg = quant.w8a8_resolve(m, n, k, g, out_dtype)
    before = dict(quant_counters())
    got = dequant.w8a8_matmul(x, wq, s, cfg=cfg, group_size=g, fuse_quant=fuse)
    after = quant_counters()
    ran = [key for key in ("B14", "B15") if after[key] == before[key] + 1]
    if ran != [route]:
        raise AssertionError(f"W8A8 {case}: launched {ran}, expected {route}")
    bk = min(cfg.block_k, k)
    fused = route == "B14"
    xq, _ = dequant._quantize_kernel(x, bk if fused else k, fused)
    if not torch.equal(xq, dequant._quantize_plain(x, bk if fused else k, fused)[0]):
        raise AssertionError(f"W8A8 {case}: int8 activations differ from plain")
    ref = dequant.w8a8_plain(x, wq, s, bk=bk, fused=fused, out_dtype=out_dtype)
    err = compare(torch, got, ref, quant_rtol(torch, out_dtype), f"W8A8 {case}",
                  scaled=True)[0]
    if zero_rows and bool(got[3].any()):
        raise AssertionError(f"W8A8 {case}: a zero row gave a non-zero output")
    return err


def w8a8_route_plan(case):
    """(config, fused, mode, block_k, route) of a W8A8_ROUTE_CASES case as
    the wrapper resolves them on the host (the JAX rule, then
    ``w8a8_route`` for 16-byte aligned operands)."""
    import torch

    from gemm_hls_tpu_torch import GemmConfig
    from gemm_hls_tpu_torch.ops import dequant, quant
    _, g, m, n, k, bk, fuse, _, out, _ = case
    cfg = quant.w8a8_resolve(m, n, k, g, getattr(torch, out),
                             GemmConfig(block_k=bk) if bk else None)
    fused, mode, bk = dequant.w8a8_schedule(m, n, k, cfg, k // (g or k), fuse)
    return cfg, fused, mode, bk, dequant.w8a8_route(n, k, bk, mode, True)


def w8a8_route_operands(torch, gen, case):
    from gemm_hls_tpu_torch import quantize_weights
    dt, g, m, n, k, _, fuse, zero_rows, _, _ = case
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    wq, s = (torch.from_numpy(a).cuda()
             for a in quantize_weights(_host(torch, w), bits=8, group_size=g))
    x = signed(torch, (m, k), getattr(torch, dt), gen) * 4
    x[:, : k // 2] *= 20
    if zero_rows:
        x[m // 2] = 0
        x[m - 1] = 0
    return x, wq, s, dict(cfg=w8a8_route_plan(case)[0], group_size=g, fuse_quant=fuse)


def w8a8_route_case(torch, gen, case):
    """One W8A8_ROUTE_CASES case on its route (checked): the int8
    activations and their scales equal to the plain quantize's, the output
    within quant_rtol of the plain version, zero rows exactly zero; an
    engine case again on mma.sync (the route override), bitwise equal.
    Returns the largest abs error."""
    from gemm_hls_tpu_torch.ops import dequant
    x, wq, s, kw = w8a8_route_operands(torch, gen, case)
    _, fused, _, bk, _ = w8a8_route_plan(case)
    got = dequant.w8a8_matmul(x, wq, s, **kw)
    if dequant.w8a8_matmul.last_route != case[-1]:
        raise AssertionError(f"W8A8 {case}: route {dequant.w8a8_matmul.last_route}")
    qb = bk if fused else x.shape[1]
    xq, sx = dequant._quantize_kernel(x, qb, fused)
    pq, psx = dequant._quantize_plain(x, qb, fused)
    if not (torch.equal(xq, pq) and torch.equal(sx.flatten(), psx.flatten())):
        raise AssertionError(f"W8A8 {case}: int8 activations or scales differ from plain")
    ref = dequant.w8a8_plain(x, wq, s, bk=bk, fused=fused, out_dtype=got.dtype)
    err = compare(torch, got, ref, quant_rtol(torch, got.dtype), f"W8A8 {case} on {case[-1]}",
                  scaled=True)[0]
    if case[7] and bool(got[[x.shape[0] // 2, -1]].any()):
        raise AssertionError(f"W8A8 {case}: a zero row gave a non-zero output")
    if case[-1] == "wgmma":
        other = dequant.w8a8_matmul(x, wq, s, route="mma.sync", **kw)
        if not torch.equal(got, other):
            raise AssertionError(f"W8A8 {case}: the engine and mma.sync differ by up to "
                                 f"{float((got.float() - other.float()).abs().max()):.3e}")
    return err


def w8a8_repeats(torch, gen):
    """W8A8_REPEAT_CASE launched W8A8_REPEATS times on the engine: the same
    bits each."""
    from gemm_hls_tpu_torch.ops import dequant
    x, wq, s, kw = w8a8_route_operands(torch, gen, W8A8_REPEAT_CASE)
    first = dequant.w8a8_matmul(x, wq, s, **kw)
    for i in range(W8A8_REPEATS - 1):
        again = dequant.w8a8_matmul(x, wq, s, **kw)
        if dequant.w8a8_matmul.last_route != "wgmma" or not torch.equal(first, again):
            raise AssertionError(f"W8A8: launch {i + 2} of {W8A8_REPEAT_CASE} differs from the "
                                 f"first (route {dequant.w8a8_matmul.last_route})")


def grouped_case(torch, gen, case):
    """One GROUPED_CASES case: ``grouped_matmul`` on the card (one B16
    launch) against the plain version; the rows past sum(group_sizes)
    exactly zero."""
    from gemm_hls_tpu_torch import grouped_matmul
    from gemm_hls_tpu_torch.ops import gmm

    dt, m, k, n, gs, trb = case
    dtype = getattr(torch, dt)
    lhs = signed(torch, (m, k), dtype, gen)
    rhs = signed(torch, (len(gs), n, k) if trb else (len(gs), k, n), dtype, gen)
    sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
    before = gmm.grouped_mxu.launches
    got = grouped_matmul(lhs, rhs, sizes, transpose_rhs=trb)
    if gmm.grouped_mxu.launches != before + 1:
        raise AssertionError(f"B16 {case}: no launch")
    ref = gmm.grouped_mxu_plain(lhs, rhs, sizes, transpose_rhs=trb)
    err = compare(torch, got, ref, quant_rtol(torch, dtype), f"B16 {case}",
                  scaled=True)[0]
    if bool(got[sum(gs):].any()):
        raise AssertionError(f"B16 {case}: rows past the groups are not zero")
    return err


def grouped_route_operands(torch, gen, case):
    dt, m, k, n, gs, trb, nan, out, _ = case
    dtype = getattr(torch, dt)
    lhs = signed(torch, (m, k), dtype, gen)
    rhs = signed(torch, (len(gs), n, k) if trb else (len(gs), k, n), dtype, gen)
    if nan:
        lhs[min(sum(gs), m):] = float("nan")
    sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
    return lhs, rhs, sizes, dict(transpose_rhs=trb, out_dtype=getattr(torch, out) if out else None)


def grouped_route_case(torch, gen, case):
    """One GROUPED_ROUTE_CASES case: ``grouped_mxu`` on the card, on the
    route the case names, against the plain version; the rows past the
    groups exactly zero, every output finite.  Returns the largest abs
    error."""
    from gemm_hls_tpu_torch.ops import gmm

    lhs, rhs, sizes, kw = grouped_route_operands(torch, gen, case)
    got = gmm.grouped_mxu(lhs, rhs, sizes, **kw)
    if gmm.grouped_mxu.last_route != case[-1]:
        raise AssertionError(f"B16 {case}: route {gmm.grouped_mxu.last_route}")
    ref = gmm.grouped_mxu_plain(lhs, rhs, sizes, **kw)
    err = compare(torch, got, ref, quant_rtol(torch, got.dtype), f"B16 route {case}",
                  scaled=True)[0]
    if bool(got[min(sum(case[4]), case[1]):].any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"B16 {case}: rows past the groups not zero, or not finite")
    return err


def grouped_repeats(torch, gen):
    """GROUPED_REPEAT_CASE launched GROUPED_REPEATS times on the same
    operands: every launch gives the first one's bits."""
    from gemm_hls_tpu_torch.ops import gmm

    lhs, rhs, sizes, kw = grouped_route_operands(torch, gen, GROUPED_REPEAT_CASE)
    first = gmm.grouped_mxu(lhs, rhs, sizes, **kw)
    if gmm.grouped_mxu.last_route != GROUPED_REPEAT_CASE[-1]:
        raise AssertionError(f"B16 {GROUPED_REPEAT_CASE}: route {gmm.grouped_mxu.last_route}")
    for i in range(GROUPED_REPEATS - 1):
        if not torch.equal(first, gmm.grouped_mxu(lhs, rhs, sizes, **kw)):
            raise AssertionError(f"B16: launch {i + 2} of {GROUPED_REPEAT_CASE} differs from "
                                 f"the first")


def phase_quant_kernels(torch):
    """Phase 16: B13, B14 / B15 and B16 against their plain versions on the
    card, over the case tables above.  Tolerances: relative 1e-4 (scaled by
    the largest output) for fp32 outputs, 1e-2 for bf16 / fp16 outputs
    (one ulp is 2^-8); the W8A8 int8 activations exactly; B16's zero tail
    exactly."""
    gen = torch.Generator(device="cuda").manual_seed(161)
    worst = {}
    for name, cases, fn in (("B13", DEQUANT_CASES, dequant_case),
                            ("B14/B15", W8A8_CASES, w8a8_case),
                            ("B16", GROUPED_CASES, grouped_case)):
        worst[name] = max(fn(torch, gen, c) for c in cases)
    torch.cuda.synchronize()
    log(f"phase 16: quantized and grouped kernels vs plain: B13 "
        f"{len(DEQUANT_CASES)} cases (int8 / int4, per-channel / group-wise, "
        f"M 1 / 64 / 130, ragged N), B14 / B15 {len(W8A8_CASES)} (routes, "
        f"int_acc on and off, zero rows), B16 {len(GROUPED_CASES)} "
        f"(tests/test_grouped.py's matrix, transpose_rhs, bf16 / fp16 / fp32): "
        f"ok (max abs err {', '.join(f'{k} {v:.3e}' for k, v in worst.items())})")
    worst = max(dequant_route_case(torch, gen, case, route) for case, route in DEQUANT_RUNS)
    dequant_repeats(torch, gen)
    torch.cuda.synchronize()
    routes = {}
    for case, route in DEQUANT_RUNS:
        routes[route or case[-1]] = routes.get(route or case[-1], 0) + 1
    log(f"phase 16: B13 route cases, {len(DEQUANT_ROUTE_CASES)} ({len(DEQUANT_RUNS)} runs "
        f"{routes}: every engine case again on mma.sync; int8 / int4, per-channel and g32 - "
        f"g256, M 1 - 256, N 512 / 528 / 2048, per-channel int4 split across the halves, "
        f"fp16, fp32 outputs; ragged N, a group off the step, fp32 x), route checked each: "
        f"ok (max abs err {worst:.3e}); {DEQUANT_REPEATS} launches of "
        f"{DEQUANT_REPEAT_CASE[:6]} on the engine: same bits")
    worst = max(w8a8_route_case(torch, gen, case) for case in W8A8_ROUTE_CASES)
    w8a8_repeats(torch, gen)
    torch.cuda.synchronize()
    routes = {}
    for case in W8A8_ROUTE_CASES:
        routes[case[-1]] = routes.get(case[-1], 0) + 1
    log(f"phase 16: B14 / B15 route cases, {len(W8A8_ROUTE_CASES)} {routes} (fused one and 4 "
        f"K-blocks, int_acc, per_block group-wise bk 128 / 256 and past the int32 bound; "
        f"bf16 / fp16 / fp32; M 1 - 4864, N 144 - 2048 and 784, K 1040; K or N off 16 bytes, "
        f"per_block bk 64 and 32), route checked each, int8 activations equal to plain, every "
        f"engine case bitwise equal on mma.sync: ok (max abs err {worst:.3e}); "
        f"{W8A8_REPEATS} launches of {W8A8_REPEAT_CASE[:5]} on the engine: same bits")
    worst = max(grouped_route_case(torch, gen, case) for case in GROUPED_ROUTE_CASES)
    grouped_repeats(torch, gen)
    torch.cuda.synchronize()
    routes = {}
    for case in GROUPED_ROUTE_CASES:
        routes[case[-1]] = routes.get(case[-1], 0) + 1
    log(f"phase 16: B16 route cases, {len(GROUPED_ROUTE_CASES)} {routes} (empty groups, a "
        f"group over several tiles, several groups in a tile, routing past M, NaN rows "
        f"past the groups, both transpose_rhs, K / N off the tiles, fp32 outputs; "
        f"unaligned K or N; fp32), each on its route: ok (max abs err {worst:.3e}); "
        f"{GROUPED_REPEATS} launches of {GROUPED_REPEAT_CASE[:6]} on the engine: same bits")


# The serving decoder block of examples/15_serving_decoder.py
# (gemm_hls_tpu_torch/models/serving.py) at
# experiments/serving_bench.py:28-31's width: d_model 2048, GQA 16 / 4
# heads of 128, MoE 8 experts top-2 with d_ff 4096, bf16; prefill B 4 x S
# 1024; decode 64 sequences over a 4096-slot padded cache, 8 steps.
SERVING = dict(batch=4, seq=1024, d_model=2048, h_q=16, h_kv=4, d_head=128,
               d_ff=4096, experts=8, top_k=2, dec_batch=64, slots=4096,
               steps=8, group=128)


def token_errors(torch, got, want):
    """Per-token max |got - want| over the largest |want|."""
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    return (g - w).abs().amax(-1) / w.abs().max()


def phase_slice5(torch):
    """Phase 17: the serving decoder block at full width, launch counts
    zeroed before it, every port call of the block under
    torch.cuda.set_sync_debug_mode("error") (a host synchronisation fails
    the run).

    Prefill against the plain bf16 block with the un-quantized weights at
    examples/15_serving_decoder.py's quantization budget: attention
    sublayer relative error < 0.05, median token error < 0.05, under 10% of
    tokens above 0.1 (routing flipped by the quantization), once through
    the fused W8A8 route (B14) and once through the two-pass route (B15).
    Decode against the plain step with the same int4 weights dequantized
    (bf16(q s), as the kernel expands them): per step, median token error
    < 1e-2 (2.5 bf16 ulps of the largest output: the two sides round their
    bf16 intermediates in other places) and under 5% of tokens above 2e-2 (bf16 rounding can flip a
    near-tie routing), every output finite, with the cache slots past each
    length NaN (K) / +inf (V) in the port's cache."""
    from gemm_hls_tpu_torch.models import serving
    from gemm_hls_tpu_torch.ops import dequant, flash, gmm
    c = SERVING
    dims = dict(h_q=c["h_q"], h_kv=c["h_kv"], d_head=c["d_head"])
    dense, q8, q4, dense4, moe, cfg = serving.serving_setup(SERVING)
    gen = torch.Generator(device="cuda").manual_seed(171)
    x = (torch.randn((c["batch"], c["seq"], c["d_model"]), generator=gen,
                     device="cuda") * 0.5).to(torch.bfloat16)
    reset_quant_counters()
    reset_flash_counters()
    res = {}
    want, want_attn = serving.prefill_plain(x, dense, moe, cfg, **dims)
    for route, fuse in (("B14", True), ("B15", False)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, y_attn, _, _ = serving.block_prefill(x, q8, moe, cfg, fuse_quant=fuse, **dims)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        routes = (main_route(flash.flash_mha, "prefill flash", "wgmma"),
                  main_route(gmm.grouped_mxu, "prefill MoE", "wgmma"))
        # Every W8A8 GEMM of the prefills so far (4 a prefill) on the engine.
        w8_routes = dict(dequant.w8a8_matmul.routes)
        if w8_routes != {"wgmma": 4 * (len(res) + 1)}:
            raise AssertionError(f"prefill {route}: W8A8 GEMM routes {w8_routes}")
        rel_attn = float((y_attn.float() - want_attn.float()).abs().max()
                         / want_attn.float().abs().max())
        tok = token_errors(torch, y, want)
        med, flipped = float(tok.median()), float((tok > 0.1).float().mean())
        finite = bool(torch.isfinite(y.float()).all())
        log(f"phase 17a: prefill B={c['batch']} S={c['seq']} d={c['d_model']} "
            f"({route} projections, W8A8 GEMM launches by route {w8_routes}, causal GQA "
            f"flash on route {routes[0]}, MoE on B16 "
            f"route {routes[1]}): attention sublayer rel err {rel_attn:.4f}, median token "
            f"err {med:.4f}, {flipped:.1%} tokens routing-flipped")
        if not (finite and rel_attn < 0.05 and med < 0.05 and flipped < 0.1):
            raise AssertionError(f"prefill {route}: outside the quantization budget")
        res[f"prefill {route}"] = dict(rel_attn=rel_attn, median=med, flipped=flipped)
        del y, y_attn
    del want, want_attn

    kc, vc, lens = decode_cache(torch, gen, nb=c["dec_batch"], slots=c["slots"],
                                hkv=c["h_kv"], d=c["d_head"], steps=c["steps"])
    live = (torch.arange(c["slots"], device="cuda")[None, :] < lens[:, None].long())
    rk, rv = (torch.where(live[..., None, None], t, 0) for t in (kc, vc))
    rlens = lens.clone()
    x_tok = (torch.randn((c["dec_batch"], c["d_model"]), generator=gen,
                         device="cuda") * 0.5).to(torch.bfloat16)
    worst_med, worst_flip = 0.0, 0.0
    for step in range(c["steps"]):
        want, rlens = serving.decode_plain(x_tok, rk, rv, rlens, dense4, moe,
                                           cfg, **dims)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, kc, vc, lens = serving.block_decode(x_tok, kc, vc, lens, q4, moe, cfg,
                                             group_size=c["group"], **dims)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"decode step {step}: non-finite output")
        tok = token_errors(torch, y, want)
        med, flipped = float(tok.median()), float((tok > 2e-2).float().mean())
        worst_med, worst_flip = max(worst_med, med), max(worst_flip, flipped)
        if not (med < 1e-2 and flipped < 0.05):
            raise AssertionError(f"decode step {step}: median token err {med:.2e}, "
                                 f"{flipped:.1%} tokens above 2e-2")
        x_tok = y
    if not torch.equal(lens, rlens):
        raise AssertionError("decode: lengths differ from the plain step's")
    res["decode"] = dict(median=worst_med, flipped=worst_flip)
    # Every decode projection's shape takes the engine (the rule is by shape:
    # q, k, v, o), and the last launch did.
    d, hd, kvh = c["d_model"], c["h_q"] * c["d_head"], c["h_kv"] * c["d_head"]
    proj = {name: dequant.dequant_route(torch.bfloat16, n, k, c["group"], True)
            for name, (k, n) in (("q", (d, hd)), ("k", (d, kvh)), ("v", (d, kvh)),
                                 ("o", (hd, d)))}
    if set(proj.values()) != {"wgmma"}:
        raise AssertionError(f"decode projections' B13 routes {proj}")
    b13_route = main_route(dequant.dequant_matmul, "decode B13", "wgmma")
    slots = c["dec_batch"] * c["top_k"]
    routes = (main_route(flash.flash_mha, "decode flash",
                         flash.flash_route(torch.bfloat16, c["d_head"], c["h_q"] // c["h_kv"],
                                           True)),
              main_route(gmm.grouped_mxu, "decode MoE", gmm.grouped_route(torch.bfloat16, True)))
    log(f"phase 17b: decode {c['steps']} steps, {c['dec_batch']} sequences x "
        f"{c['slots']} slots (int4 g{c['group']} projections on B13 route {b13_route}, "
        f"one launch each, padded-cache "
        f"flash on route {routes[0]}, MoE on B16 route {routes[1]} at {slots} slots), "
        f"stale slots NaN / inf: worst median token err "
        f"{worst_med:.2e}, worst {worst_flip:.1%} tokens above 2e-2; lengths now "
        f"{int(lens.min())}-{int(lens.max())}")
    launches = dict(quant_counters(), flash_fwd=flash.flash_mha.launches)
    log(f"phase 17: main-path launch counts {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice 5 "
                                 f"main path")
    return launches, res


def device_profile(torch, fn, iters):
    """torch.profiler over ``iters`` synchronised calls of ``fn`` after a
    warm-up: (device busy share of the host-clock window, [(kernel, device
    us per call), ...] largest first)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(key, us / iters) for key, us in device_kernels(prof)]
    kernels.sort(key=lambda kv: -kv[1])
    return sum(us for _, us in kernels) * iters / wall_us, kernels


def device_kernels(prof):
    """[(kernel, device us in the window)] of a torch.profiler window."""
    kernels = []
    for e in prof.key_averages():
        # Device-side events only: a CPU op (an autograd Function, a copy)
        # can carry its kernel's time too.
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            kernels.append((e.key, dev))
    return kernels


# B13's decode projections at SERVING's width (examples/15_serving_decoder.py:
# int4 g128, bf16, 64 sequences): q and o (64 x 2048 -> 2048), k and v
# (64 x 2048 -> 512).  (M, K, N).
B13_SHAPES = {"q": (64, 2048, 2048), "kv": (64, 2048, 512)}


def host_us(torch, fn, calls=200):
    """Host-clock microseconds a call of ``fn``, over ``calls`` back-to-back
    calls that end in one sync: the wrapper's host cost where it exceeds
    the kernel's device time, else the device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def b13_times(torch, rng):
    """B13 at B13_SHAPES: both routes' launches, the plain version and ``xd
    @ w_deq`` (bf16 torch.matmul on the dequantized weights, the
    yardstick) checked against the plain version, then device ms a call in
    turns (``time_turns``) and host us a call (``host_us``) of each.
    Returns {shape: {"ms": {...}, "host_us": {...}, "plain_ms", "bound",
    "route", "plan", "max_abs_err"}}."""
    from gemm_hls_tpu_torch import quantize_weights
    from gemm_hls_tpu_torch.models.perf_model import H100, dequant_bound
    from gemm_hls_tpu_torch.ops import dequant, quant
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    bf16, g = torch.bfloat16, SERVING["group"]
    gen = torch.Generator(device="cuda").manual_seed(183)
    out = {}
    for key, (m, k, n) in B13_SHAPES.items():
        w = rng.standard_normal((k, n)).astype("float32") / k ** 0.5
        wq, s = (torch.from_numpy(a).cuda() for a in quantize_weights(w, bits=4, group_size=g))
        x = (torch.randn((m, k), generator=gen, device="cuda") * 0.5).to(bf16)
        w_deq = dequant.dequant_matmul_plain(torch.eye(k, device="cuda", dtype=bf16), wq, s,
                                             bits=4, group_size=g)
        cfg = quant.dequant_config(m, n, k, bf16)
        fns = {r: (lambda r=r: dequant.dequant_matmul(x, wq, s, cfg=cfg, bits=4, group_size=g,
                                                      route=r)) for r in ("wgmma", "mma.sync")}
        fns["library"] = lambda: x @ w_deq
        ref = dequant.dequant_matmul_plain(x, wq, s, bits=4, group_size=g)
        err = max(compare(torch, fn(), ref, BF16_RTOL, f"timed B13 {key} {name}",
                          scaled=True)[0] for name, fn in fns.items())
        rule = dequant.dequant_route(bf16, n, k, g, True)
        turns = time_turns(torch, fns)
        host = {name: host_us(torch, fn) for name, fn in fns.items()}
        plain_ms = time_fn(lambda: dequant.dequant_matmul_plain(x, wq, s, bits=4, group_size=g),
                           [()], iters=10, warmup=1) * 1e3
        bound = dequant_bound(H100, m, n, k, 4, g, bf16, bf16)
        plan = dequant._engine_plan(x.device, m, n, k)
        out[key] = dict(ms=turns, host_us=host, plain_ms=plain_ms, bound=bound, route=rule,
                        plan=plan, max_abs_err=err)
        log(f"phase 18: B13 {key} projection {m}x{k}x{n} int4 g{g} bf16, device ms a call in "
            f"turns: " + ", ".join(f"{name} {ms:.4f}" for name, ms in turns.items())
            + "; host us a call: " + ", ".join(f"{name} {us:.1f}" for name, us in host.items())
            + f"; plain {plain_ms:.3f} ms, bound {bound[0] * 1e3:.4f} ms ({bound[1]}), the "
            f"rule's route {rule} (engine plan {plan[0]}x{plan[1]}); max abs err {err:.3e}")
    return out


# B14 / B15 at the prefill projections (B 4 x S 1024 tokens, d 2048): q and o
# (4096 x 2048 -> 2048), k and v (4096 x 2048 -> 512).  (M, K, N).
W8A8_SHAPES = {"q/o": (4096, 2048, 2048), "k/v": (4096, 2048, 512)}


def w8a8_times(torch, rng):
    """B14 and B15 at W8A8_SHAPES, per-channel int8 weights, bf16 x and y.
    Checked first: each call against the plain version, the GEMM alone and
    the mma.sync route bitwise equal to the call, and torch._int_mm's int32
    product of the per-row int8 x scaled as B15 scales it bitwise equal to
    B15.  Then device ms a call in turns (``time_turns``): each whole call
    (the quantize pass and the GEMM) on the rule's route and on mma.sync,
    its quantize pass alone, its GEMM alone on both routes; torch._int_mm
    with the weights row-major and column-major (made so once, outside the
    timing); bf16 torch.matmul of x and the unquantized weights.  Host us a
    call of each whole call.  Returns {"B14 q/o": {...}, ...}."""
    from gemm_hls_tpu_torch import quantize_weights
    from gemm_hls_tpu_torch.models.perf_model import H100, w8a8_bound
    from gemm_hls_tpu_torch.ops import dequant, quant
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(185)
    out = {}
    for shape, (m, k, n) in W8A8_SHAPES.items():
        w = rng.standard_normal((k, n)).astype("float32") / k ** 0.5
        wq, s = (torch.from_numpy(a).cuda() for a in quantize_weights(w, bits=8))
        w_bf16 = torch.from_numpy(w).cuda().to(bf16)
        wq_cm = wq.t().contiguous().t()
        x = (torch.randn((m, k), generator=gen, device="cuda") * 0.5).to(bf16)
        xq_pre, sx_pre = dequant.quantize_activations(x)
        p_int = torch._int_mm(xq_pre, wq)
        if not torch.equal(p_int, torch._int_mm(xq_pre, wq_cm)):
            raise AssertionError(f"W8A8 {shape}: torch._int_mm differs by weight layout")
        cfg = quant.w8a8_resolve(m, n, k, None, bf16)
        fns = {"_int_mm row-major": lambda: torch._int_mm(xq_pre, wq),
               "_int_mm col-major": lambda: torch._int_mm(xq_pre, wq_cm),
               "bf16 matmul": lambda: x @ w_bf16}
        info = {}
        for key, fuse in (("B14", True), ("B15", False)):
            fused, mode, bk = dequant.w8a8_schedule(m, n, k, cfg, 1, fuse)
            route = dequant.w8a8_route(n, k, bk, mode, True)
            qb = bk if fused else k
            xq, sx = dequant._quantize_kernel(x, qb, fused)
            y = torch.empty((m, n), dtype=bf16, device="cuda")
            ys = torch.empty_like(y)
            call = (lambda fuse=fuse, r=None: dequant.w8a8_matmul(x, wq, s, cfg=cfg,
                                                                  fuse_quant=fuse, route=r))
            fns[f"{key} call"] = call
            fns[f"{key} call mma.sync"] = lambda call=call: call(r="mma.sync")
            fns[f"{key} quantize"] = lambda qb=qb, fused=fused: dequant._quantize_kernel(x, qb, fused)
            for r, dst in ((route, y), ("mma.sync", ys)):
                fns[f"{key} gemm" + ("" if r == route else " mma.sync")] = (
                    lambda xq=xq, sx=sx, bk=bk, mode=mode, r=r, dst=dst: dequant._w8a8_launch(
                        xq, sx, wq, s, dst, bk=bk, mode=mode, route=r))
            got = call()
            ref = dequant.w8a8_plain(x, wq, s, bk=bk, fused=fused, out_dtype=bf16)
            err = compare(torch, got, ref, BF16_RTOL, f"timed {key} {shape}", scaled=True)[0]
            fns[f"{key} gemm"]()
            fns[f"{key} gemm mma.sync"]()
            if not (torch.equal(got, y) and torch.equal(got, ys)
                    and torch.equal(got, call(r="mma.sync"))):
                raise AssertionError(f"timed {key} {shape}: the GEMM alone or mma.sync differs")
            if mode == "int_acc" and not torch.equal(
                    got, ((p_int.float() * s[0]) * sx_pre).to(bf16)):
                raise AssertionError(f"timed {key} {shape}: torch._int_mm scaled as B15 differs")
            plain_ms = time_fn(lambda bk=bk, fused=fused: dequant.w8a8_plain(
                x, wq, s, bk=bk, fused=fused, out_dtype=bf16), [()], iters=3, warmup=1) * 1e3
            info[key] = dict(route=route, mode=mode, err=err, plain_ms=plain_ms,
                             plan=dequant.w8a8_engine_plan(m, n, k, bk, mode,
                                                           dequant.sm_count(x.device)))
        turns = time_turns(torch, fns)
        lib = {name: turns[f"_int_mm {name}"] for name in ("row-major", "col-major")}
        best = min(lib, key=lib.get)
        for key, i in info.items():
            host = {r: host_us(torch, lambda r=r, key=key: fns[f"{key} call"](
                r=None if r == i["route"] else r)) for r in (i["route"], "mma.sync")}
            out[f"{key} {shape}"] = dict(
                ms=turns[f"{key} call"], gemm_ms=turns[f"{key} gemm"],
                quantize_ms=turns[f"{key} quantize"], other_ms=turns[f"{key} call mma.sync"],
                other_gemm_ms=turns[f"{key} gemm mma.sync"], route=i["route"],
                other_route="mma.sync", mode=i["mode"], plan=i["plan"], host_us=host,
                plain_ms=i["plain_ms"], max_abs_err=i["err"], library_ms=lib[best],
                library=f"torch._int_mm, weights {best}", library_other_ms=lib[
                    "col-major" if best == "row-major" else "row-major"],
                bf16_matmul_ms=turns["bf16 matmul"],
                bound=w8a8_bound(H100, m, n, k, None, bf16, bf16))
            log(f"phase 18: {key} {shape} {m}x{k}x{n} bf16 ({i['mode']}, route {i['route']}, "
                f"N tile {i['plan']}), device ms a call in turns: call {turns[f'{key} call']:.4f} "
                f"= quantize {turns[f'{key} quantize']:.4f} + GEMM {turns[f'{key} gemm']:.4f}; "
                f"mma.sync call {turns[f'{key} call mma.sync']:.4f} (GEMM "
                f"{turns[f'{key} gemm mma.sync']:.4f}); torch._int_mm row-major "
                f"{lib['row-major']:.4f}, col-major {lib['col-major']:.4f}; bf16 torch.matmul "
                f"{turns['bf16 matmul']:.4f}; host us a call: "
                + ", ".join(f"{r} {us:.1f}" for r, us in host.items())
                + f"; plain {i['plain_ms']:.3f} ms, bound "
                f"{out[f'{key} {shape}']['bound'][0] * 1e3:.4f} ms; max abs err {i['err']:.3e}")
        del x, xq_pre, p_int, wq, wq_cm, w_bf16
    return out


def phase_times5(torch):
    """Phase 18: the new kernels at their serving shapes beside their
    bounds, plain versions and library yardsticks (timed here, never called
    by the port), and the serving block end to end beside the plain
    composition (launches here are comparisons, not the main path's)."""
    import numpy as np

    from gemm_hls_tpu_torch.models.perf_model import (H100, dequant_bound, flash_bound,
                                                      grouped_bound, w8a8_bound)
    from gemm_hls_tpu_torch.models import serving
    from gemm_hls_tpu_torch.ops import gmm
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    c = SERVING
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(181)
    rng = np.random.default_rng(181)
    out = {}

    d = c["d_model"]
    # B13 at the decode projections: its routes and xd @ w_deq in turns on
    # the device, and host us a call.
    b13 = b13_times(torch, rng)
    q = b13["q"]
    out["B13 decode 64x2048x2048 int4 g128"] = dict(
        ms=q["ms"][q["route"]], plain_ms=q["plain_ms"], library_ms=q["ms"]["library"],
        max_abs_err=q["max_abs_err"], bound=q["bound"], route=q["route"],
        other_route="mma.sync", other_ms=q["ms"]["mma.sync"], plan=q["plan"],
        host_us=q["host_us"], kv=dict(ms=b13["kv"]["ms"], host_us=b13["kv"]["host_us"],
                                      plan=b13["kv"]["plan"],
                                      bound_ms=b13["kv"]["bound"][0] * 1e3))
    # B14 / B15 at the prefill projections: both routes, the quantize pass and
    # the GEMM apart, torch._int_mm and bf16 torch.matmul in turns.
    out.update(w8a8_times(torch, rng))
    m = c["batch"] * c["seq"]
    # B16: the MoE w1 at 8192 routed slots (prefill) and 128 (decode), and
    # w2's dlhs (transpose_rhs) at 8192: the route the rule gives, the other
    # tensor-core route and torch._grouped_mm timed in turns.
    w1 = (torch.randn((c["experts"], d, c["d_ff"]), generator=gen, device="cuda")
          * d ** -0.5).to(bf16)
    w2 = (torch.randn((c["experts"], c["d_ff"], d), generator=gen, device="cuda")
          * c["d_ff"] ** -0.5).to(bf16)
    for key, slots, w, trb in (("B16 w1 prefill 8192 slots", m * c["top_k"], w1, False),
                               ("B16 w1 decode 128 slots", c["dec_batch"] * c["top_k"], w1,
                                False),
                               ("B16 w2 dlhs prefill 8192 slots", m * c["top_k"], w2, True)):
        ids = torch.randint(0, c["experts"], (slots,), generator=gen, device="cuda")
        sizes = torch.bincount(ids, minlength=c["experts"]).to(torch.int32)
        k_in, n_out = (w.shape[2], w.shape[1]) if trb else (w.shape[1], w.shape[2])
        lhs = (torch.randn((slots, k_in), generator=gen, device="cuda") * 0.5).to(bf16)
        ends = torch.cumsum(sizes, 0).to(torch.int32)
        fns = {"kernel": lambda lhs=lhs, sizes=sizes, w=w, trb=trb: gmm.grouped_mxu(
            lhs, w, sizes, transpose_rhs=trb)}
        ref = gmm.grouped_mxu_plain(lhs, w, sizes, transpose_rhs=trb)
        err = compare(torch, fns["kernel"](), ref, BF16_RTOL, f"timed {key}", scaled=True)[0]
        route = gmm.grouped_mxu.last_route
        other = "mma.sync" if route == "wgmma" else "wgmma"
        fns[other] = (lambda lhs=lhs, sizes=sizes, w=w, trb=trb: gmm._grouped_launch(
            lhs, w, sizes, slots, k_in, n_out, c["experts"], trb, bf16, other))
        compare(torch, fns[other](), ref, BF16_RTOL, f"timed {key} {other}", scaled=True)
        if hasattr(torch, "_grouped_mm"):
            wl = w.transpose(1, 2) if trb else w
            try:
                torch._grouped_mm(lhs, wl, offs=ends, out_dtype=bf16)
                fns["library"] = (lambda lhs=lhs, wl=wl, ends=ends:
                                  torch._grouped_mm(lhs, wl, offs=ends, out_dtype=bf16))
            except Exception as exc:  # the yardstick only: the port never calls it
                log(f"phase 18: torch._grouped_mm refused ({type(exc).__name__}: {exc})")
        turns = time_turns(torch, fns)
        plain_ms = time_fn(lambda lhs=lhs, sizes=sizes, w=w, trb=trb: gmm.grouped_mxu_plain(
            lhs, w, sizes, transpose_rhs=trb), [()], iters=3, warmup=1) * 1e3
        live = int((sizes > 0).sum())
        bound = grouped_bound(H100, slots, k_in, n_out, slots, live, bf16)
        out[key] = dict(ms=turns["kernel"], plain_ms=plain_ms, library_ms=turns.get("library"),
                        max_abs_err=err, bound=bound, route=route, other_route=other,
                        other_ms=turns[other])
        log(f"phase 18: {key}: {turns['kernel']:.4f} ms (route {route}; {other} "
            f"{turns[other]:.4f} ms) vs plain {plain_ms:.3f} ms, bound {bound[0] * 1e3:.4f} ms "
            f"({bound[1]}), torch._grouped_mm "
            + (f"{turns['library']:.4f} ms" if "library" in turns else "none")
            + f" (in turns); max abs err {err:.3e}")
        del lhs, ref
    del w1, w2

    # The serving block end to end (host clock around synchronised work is
    # the same as CUDA events here: each timed window ends in a sync).
    dims = dict(h_q=c["h_q"], h_kv=c["h_kv"], d_head=c["d_head"])
    dense, q8, q4, dense4, moe, cfg = serving.serving_setup(SERVING)
    x = (torch.randn((c["batch"], c["seq"], d), generator=gen, device="cuda")
         * 0.5).to(bf16)
    out["prefill ms"] = time_fn(lambda: serving.block_prefill(x, q8, moe, cfg, **dims)[0],
                                [()], iters=5) * 1e3
    out["prefill plain ms"] = time_fn(
        lambda: serving.prefill_plain(x, dense, moe, cfg, **dims)[0], [()],
        iters=5) * 1e3
    n_tok = c["batch"] * c["seq"]
    hd = c["h_q"] * c["d_head"]
    pbound = sum(b[0] for b in (
        w8a8_bound(H100, n_tok, hd, d, None, bf16, bf16),
        w8a8_bound(H100, n_tok, c["h_kv"] * c["d_head"], d, None, bf16, bf16),
        w8a8_bound(H100, n_tok, c["h_kv"] * c["d_head"], d, None, bf16, bf16),
        w8a8_bound(H100, n_tok, d, hd, None, bf16, bf16),
        flash_bound(H100, c["batch"] * c["h_q"], c["seq"], c["seq"], c["d_head"],
                    bf16, True),
        grouped_bound(H100, 2 * n_tok, d, c["d_ff"], 2 * n_tok, c["experts"], bf16),
        grouped_bound(H100, 2 * n_tok, c["d_ff"], d, 2 * n_tok, c["experts"], bf16)))
    out["prefill bound ms"] = pbound * 1e3
    log(f"phase 18: serving prefill B={c['batch']} S={c['seq']}: {out['prefill ms']:.3f} "
        f"ms vs plain composition (bf16 torch.matmul, SDPA, per-expert loop) "
        f"{out['prefill plain ms']:.3f} ms; bound {pbound * 1e3:.4f} ms")
    del x
    kc, vc, lens = decode_cache(torch, gen, nb=c["dec_batch"], slots=c["slots"],
                                hkv=c["h_kv"], d=c["d_head"], steps=c["steps"])
    live = (torch.arange(c["slots"], device="cuda")[None, :] < lens[:, None].long())
    rk, rv = (torch.where(live[..., None, None], t, 0) for t in (kc, vc))
    xt = (torch.randn((c["dec_batch"], d), generator=gen, device="cuda") * 0.5).to(bf16)
    out["decode us"] = time_fn(
        lambda: serving.block_decode(xt, kc, vc, lens, q4, moe, cfg, group_size=c["group"],
                               **dims)[0], [()], iters=20) * 1e6
    out["decode plain us"] = time_fn(
        lambda: serving.decode_plain(xt, rk, rv, lens, dense4, moe, cfg,
                                     **dims)[0], [()], iters=20) * 1e6
    mean_len = float(lens.float().mean())
    kvh = c["h_kv"] * c["d_head"]
    dbound = sum(b[0] for b in (
        flash_bound(H100, c["dec_batch"] * c["h_kv"], c["h_q"] // c["h_kv"],
                    int(mean_len), c["d_head"], bf16, False),
        dequant_bound(H100, c["dec_batch"], hd, d, 4, c["group"], bf16, bf16),
        dequant_bound(H100, c["dec_batch"], kvh, d, 4, c["group"], bf16, bf16),
        dequant_bound(H100, c["dec_batch"], kvh, d, 4, c["group"], bf16, bf16),
        dequant_bound(H100, c["dec_batch"], d, hd, 4, c["group"], bf16, bf16),
        grouped_bound(H100, 2 * c["dec_batch"], d, c["d_ff"], 2 * c["dec_batch"],
                      c["experts"], bf16),
        grouped_bound(H100, 2 * c["dec_batch"], c["d_ff"], d, 2 * c["dec_batch"],
                      c["experts"], bf16)))
    out["decode bound us"] = dbound * 1e6
    log(f"phase 18: serving decode step, {c['dec_batch']} sequences x {c['slots']} "
        f"slots: {out['decode us']:.1f} us vs plain composition "
        f"{out['decode plain us']:.1f} us; bound {dbound * 1e6:.1f} us (mean length "
        f"{mean_len:.0f})")
    # Where the block's time goes: device busy share and kernels by device
    # time (torch.profiler over synchronised calls).
    x = (torch.randn((c["batch"], c["seq"], d), generator=gen, device="cuda")
         * 0.5).to(bf16)
    for key, fn, iters in (
            ("decode step", lambda: serving.block_decode(xt, kc, vc, lens, q4, moe, cfg,
                                                   group_size=c["group"], **dims), 10),
            ("prefill", lambda: serving.block_prefill(x, q8, moe, cfg, **dims), 3)):
        busy, kernels = device_profile(torch, fn, iters)
        out[f"{key} busy"] = busy
        if key == "decode step" and (not any("dequant_wg_kernel" in name for name, _ in kernels)
                                     or any("dequant_reduce" in name for name, _ in kernels)):
            raise AssertionError("decode step: B13 is not one engine launch a projection")
        log(f"phase 18: profile {key}: device busy {busy:.1%} of the window; per call "
            + "; ".join(f"{name[:48]} {us:.1f} us" for name, us in kernels[:8]))
    return out


# ---------------------------------------------------------------------------
# Slice 6: MoE training -- the grouped GEMM's weight gradient (B17),
# grouped_matmul's backward and moe_train_step
# ---------------------------------------------------------------------------

def grouped_update_case(torch, gen, case):
    """One GROUPED_UPDATE_CASES case: ``grouped_update_mxu`` on the card (one
    B17 launch) against the plain version; the blocks of groups with no
    rows exactly zero.  Returns the largest abs error."""
    from gemm_hls_tpu_torch.ops import gmm

    dt, m, k, n, gs, out, nan_tail = case
    dtype = getattr(torch, dt)
    out_dtype = getattr(torch, out) if out else None
    lhs, g = signed(torch, (m, k), dtype, gen), signed(torch, (m, n), dtype, gen)
    if nan_tail:  # stale rows past the groups: no output may see them
        lhs[sum(gs):] = float("nan")
        g[sum(gs):] = float("nan")
    sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
    before = gmm.grouped_update_mxu.launches
    got = gmm.grouped_update_mxu(lhs, g, sizes, num_groups=len(gs), out_dtype=out_dtype)
    if gmm.grouped_update_mxu.launches != before + 1:
        raise AssertionError(f"B17 {case}: no launch")
    ref = gmm.grouped_update_mxu_plain(lhs, g, sizes, num_groups=len(gs),
                                       out_dtype=out_dtype)
    err = compare(torch, got, ref, quant_rtol(torch, got.dtype), f"B17 {case}",
                  scaled=True)[0]
    ends = gmm.group_ends(sizes, m).tolist()
    for grp, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)):
        if hi == lo and bool(got[grp].any()):
            raise AssertionError(f"B17 {case}: empty group {grp}'s block is not zero")
    return err


def grouped_update_repeats(torch, gen):
    """Two launches on the same operands give the same bits (no atomics)."""
    from gemm_hls_tpu_torch.ops import gmm
    lhs = signed(torch, (2048, 512), torch.bfloat16, gen)
    g = signed(torch, (2048, 1024), torch.bfloat16, gen)
    sizes = torch.tensor([900, 0, 1100, 48], dtype=torch.int32, device="cuda")
    first = gmm.grouped_update_mxu(lhs, g, sizes, num_groups=4)
    if not torch.equal(first, gmm.grouped_update_mxu(lhs, g, sizes, num_groups=4)):
        raise AssertionError("B17: two launches differ")


def grouped_update_route_operands(torch, gen, case):
    dt, m, k, n, gs, out, nan, _ = case
    dtype = getattr(torch, dt)
    lhs, g = signed(torch, (m, k), dtype, gen), signed(torch, (m, n), dtype, gen)
    if nan:  # stale rows past the groups: no output may see them
        lhs[min(sum(gs), m):] = float("nan")
        g[min(sum(gs), m):] = float("nan")
    sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
    return lhs, g, sizes, getattr(torch, out) if out else dtype


def grouped_update_route_case(torch, gen, case, route=None):
    """One GROUPED_UPDATE_ROUTE_CASES case on the route it names (or on
    ``route``, the override) against the plain version, the route checked;
    the blocks of groups with no rows exactly zero, every output finite.
    Returns the largest abs error."""
    from gemm_hls_tpu_torch.ops import gmm

    m, k, n, gs = case[1:5]
    lhs, g, sizes, out_dtype = grouped_update_route_operands(torch, gen, case)
    if route:
        got = gmm._update_launch(lhs, g, sizes, m, k, n, len(gs), out_dtype, route)
    else:
        got = gmm.grouped_update_mxu(lhs, g, sizes, num_groups=len(gs), out_dtype=out_dtype)
    if gmm.grouped_update_mxu.last_route != (route or case[-1]):
        raise AssertionError(f"B17 {case}: route {gmm.grouped_update_mxu.last_route}")
    ref = gmm.grouped_update_mxu_plain(lhs, g, sizes, num_groups=len(gs), out_dtype=out_dtype)
    err = compare(torch, got, ref, quant_rtol(torch, got.dtype),
                  f"B17 route {case} on {route or case[-1]}", scaled=True)[0]
    ends = gmm.group_ends(sizes, m).tolist()
    for grp, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)):
        if hi <= lo and bool(got[grp].any()):
            raise AssertionError(f"B17 {case}: empty group {grp}'s block is not zero")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"B17 {case}: an output is not finite")
    return err


def grouped_update_route_repeats(torch, gen):
    """GROUPED_UPDATE_REPEAT_CASE launched GROUPED_UPDATE_REPEATS times on
    the same operands: every launch gives the first one's bits."""
    from gemm_hls_tpu_torch.ops import gmm

    case = GROUPED_UPDATE_REPEAT_CASE
    lhs, g, sizes, out_dtype = grouped_update_route_operands(torch, gen, case)
    kw = dict(num_groups=len(case[4]), out_dtype=out_dtype)
    first = gmm.grouped_update_mxu(lhs, g, sizes, **kw)
    if gmm.grouped_update_mxu.last_route != case[-1]:
        raise AssertionError(f"B17 {case}: route {gmm.grouped_update_mxu.last_route}")
    for i in range(GROUPED_UPDATE_REPEATS - 1):
        if not torch.equal(first, gmm.grouped_update_mxu(lhs, g, sizes, **kw)):
            raise AssertionError(f"B17: launch {i + 2} of {case} differs from the first")


def grouped_grad_case(torch, gen, case):
    """One GROUPED_GRAD_CASES case: ``grouped_matmul``'s gradients on the
    card (B16 forward, B16 for dlhs, B17 for drhs) against plain autograd
    through ``grouped_mxu_plain`` with the same cotangent.  Returns the
    largest abs error."""
    from gemm_hls_tpu_torch import GemmConfig, grouped_matmul
    from gemm_hls_tpu_torch.ops import gmm

    dt, trb, mixed = case
    dtype = getattr(torch, dt)
    m, k, n, gs = 300, 72, 136, [100, 0, 150, 30]
    lhs = signed(torch, (m, k), dtype, gen).requires_grad_()
    rhs = signed(torch, (len(gs), n, k) if trb else (len(gs), k, n), dtype,
                 gen).requires_grad_()
    sizes = torch.tensor(gs, dtype=torch.int32, device="cuda")
    before = quant_counters()["B16"], gmm.grouped_update_mxu.launches
    out = grouped_matmul(lhs, rhs, sizes, GemmConfig() if mixed else None,
                         transpose_rhs=trb)
    cot = signed(torch, out.shape, out.dtype, gen)
    dl, dr = torch.autograd.grad(out, (lhs, rhs), cot)
    after = quant_counters()["B16"], gmm.grouped_update_mxu.launches
    if (after[0] - before[0], after[1] - before[1]) != (2, 1):
        raise AssertionError(f"grouped_matmul gradient {case}: launches "
                             f"B16 {after[0] - before[0]}, B17 {after[1] - before[1]}")
    pl, pr = (t.detach().clone().requires_grad_() for t in (lhs, rhs))
    pout = gmm.grouped_mxu_plain(pl, pr, sizes, transpose_rhs=trb, out_dtype=out.dtype)
    pdl, pdr = torch.autograd.grad(pout, (pl, pr), cot)
    errs = [compare(torch, got, ref, quant_rtol(torch, got.dtype),
                    f"grouped_matmul {name} {case}", scaled=True)[0]
            for name, got, ref in (("out", out.detach(), pout.detach()), ("dlhs", dl, pdl),
                                   ("drhs", dr, pdr))]
    if bool(dr[1].any()):
        raise AssertionError(f"grouped_matmul gradient {case}: the empty group's "
                             f"weight gradient is not zero")
    return max(errs)


def phase_grouped_update(torch):
    """Phase 19: B17 against its plain version on the card over
    GROUPED_UPDATE_CASES, two launches bitwise equal, and grouped_matmul's
    gradients against plain autograd over GROUPED_GRAD_CASES.  Tolerances:
    phase 16's (relative 1e-4 scaled by the largest output for fp32
    outputs, 1e-2 for bf16 / fp16)."""
    gen = torch.Generator(device="cuda").manual_seed(191)
    worst = max(grouped_update_case(torch, gen, c) for c in GROUPED_UPDATE_CASES)
    grouped_update_repeats(torch, gen)
    worst_grad = max(grouped_grad_case(torch, gen, c) for c in GROUPED_GRAD_CASES)
    torch.cuda.synchronize()
    log(f"phase 19: B17 vs plain, {len(GROUPED_UPDATE_CASES)} cases (tests/"
        f"test_grouped.py's matrix in bf16 / fp16 / fp32, NaN rows past the "
        f"groups, routing past M, K x N off the tiles, empty groups exactly zero): "
        f"ok (max abs err {worst:.3e}); two launches bitwise equal; "
        f"grouped_matmul gradients vs plain autograd, {len(GROUPED_GRAD_CASES)} cases "
        f"(transpose_rhs, bf16 / fp32, bf16 operands with an fp32 config): ok "
        f"(max abs err {worst_grad:.3e})")
    worst = max(grouped_update_route_case(torch, gen, c) for c in GROUPED_UPDATE_ROUTE_CASES)
    engine = [c for c in GROUPED_UPDATE_ROUTE_CASES if c[-1] == "wgmma"]
    worst_old = max(grouped_update_route_case(torch, gen, c, "mma.sync") for c in engine)
    grouped_update_route_repeats(torch, gen)
    torch.cuda.synchronize()
    routes = {}
    for case in GROUPED_UPDATE_ROUTE_CASES:
        routes[case[-1]] = routes.get(case[-1], 0) + 1
    log(f"phase 19: B17 route cases, {len(GROUPED_UPDATE_ROUTE_CASES)} {routes} (spans off "
        f"multiples of 64 and shorter than 64, empty groups exactly zero, NaN rows past the "
        f"groups, routing past M, K / N off the tiles, fp16, fp32 outputs; unaligned K or N; "
        f"fp32), each on its route: ok (max abs err {worst:.3e}); the {len(engine)} engine "
        f"cases again on mma.sync: ok ({worst_old:.3e}); {GROUPED_UPDATE_REPEATS} launches of "
        f"{GROUPED_UPDATE_REPEAT_CASE[:5]} on the engine: the same bits")


# Phase 20's training run at SERVING's MoE width: 4096 tokens (B 4 x S
# 1024, 8192 routed slots), a seeded target, 5 SGD steps.  lr 10 with the
# mean-square loss: at d_model 2048 (plain versions, d_ff 256) lr 1 rounds
# most bf16 weight updates away and lr 1000 diverges within 5 steps.  The
# fp32 run at a reduced width holds the kernels' fp32 routes to 1e-4.
TRAIN = dict(tokens=4096, steps=5, lr=10.0, aux_weight=0.01,
             fp32=dict(d_model=512, d_ff=1024, experts=8, tokens=2048))


def train_setup(torch, cfg, tokens, seed):
    """Seeded bf16 / fp32 MoE parameters on the card (a torch.Generator)
    and a batch: x ~ N(0, 1/4), target tanh(x . W_t), W_t ~ N(0, 1/d)."""
    from gemm_hls_tpu_torch.models.moe import init_moe_params
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_moe_params(gen, cfg)
    dt = getattr(torch, cfg.dtype)
    x = (torch.randn((tokens, cfg.d_model), generator=gen, device="cuda") * 0.5).to(dt)
    w_t = torch.randn((cfg.d_model, cfg.d_model), generator=gen,
                      device="cuda") * cfg.d_model ** -0.5
    return params, (x, torch.tanh(x.float() @ w_t).to(dt))


def moe_plain_loss(torch, params, batch, cfg, aux_weight=0.0):
    """The MoE loss in plain PyTorch: ``models/serving.py::moe_plain``
    (per-expert loop, torch.topk routing) and, with ``aux_weight``, the
    Switch aux loss from its own softmax and routing counts."""
    from gemm_hls_tpu_torch.models import serving
    x, y = batch
    loss = torch.mean((serving.moe_plain(params, x, cfg).float() - y.float()) ** 2)
    if aux_weight:
        logits = x.float() @ params["router"]
        ids = torch.topk(logits, cfg.top_k, dim=-1)[1]
        f = torch.bincount(ids.reshape(-1), minlength=cfg.num_experts).float()
        f = f / (x.shape[0] * cfg.top_k)
        loss = loss + aux_weight * cfg.num_experts * torch.sum(
            f * torch.softmax(logits, dim=-1).mean(0))
    return loss


def plain_grads(torch, params, batch, cfg, aux_weight=0.0):
    """(loss, {name: gradient}) of ``moe_plain_loss`` under plain autograd."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = moe_plain_loss(torch, leaves, batch, cfg, aux_weight)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def port_grads(torch, params, batch, cfg, aux_weight=0.0):
    """(loss, {name: gradient}): ``moe_loss`` through the kernels' autograd,
    the same composition ``moe_train_step`` runs."""
    from gemm_hls_tpu_torch.models.moe import moe_loss
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = moe_loss(leaves, batch, cfg, aux_weight)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def no_sync(torch, fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("error"): a host
    synchronisation inside it fails the run."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out


def grad_errors(torch, got, want):
    """max |got - want| / max |want| for each gradient."""
    return {k: float((got[k].float() - want[k].float()).abs().max()
                     / want[k].float().abs().max()) for k in want}


def phase_slice6(torch):
    """Phase 20: slice 6's main path, MoE training at SERVING's width
    (d_model 2048, d_ff 4096, 8 experts top-2, bf16, 4096 tokens), every
    port call under set_sync_debug_mode("error").

    (a) One gradient through ``moe_loss`` against the plain per-expert
    step's autograd from the same params: loss relative error < 1e-2, each
    gradient max |err| / max |ref| < 2e-2 (bf16 intermediates rounded in
    other places).  (b) Launch counts zeroed, then 5 ``moe_train_step``
    steps: exactly 3 B16 launches (two forward, w2's dlhs; w1's dlhs has no
    input that needs it) and 2 B17 launches (w1's and w2's drhs) each; each
    step's loss within 1e-2 of the plain loss on the same params; every
    parameter finite; the loss falls.  (c) One step with aux_weight 0.01
    and one with an explicit ``MoEConfig(gemm=GemmConfig())`` (fp32 hidden
    layers, both kernels' fp32 routes), each within 1e-2 of the plain loss.
    (d) An fp32 run at d 512, d_ff 1024, 2048 tokens: loss and gradients
    within 1e-4 of the plain fp32 step (IEEE fp32 on both sides, TF32 off).
    """
    import dataclasses

    from gemm_hls_tpu_torch import GemmConfig
    from gemm_hls_tpu_torch.models.moe import MoEConfig, moe_forward, moe_train_step
    from gemm_hls_tpu_torch.ops import gmm

    c, t = SERVING, TRAIN
    cfg = MoEConfig(d_model=c["d_model"], d_ff=c["d_ff"], num_experts=c["experts"],
                    top_k=c["top_k"], dtype="bfloat16")
    params, batch = train_setup(torch, cfg, t["tokens"], seed=201)

    def counts():
        return quant_counters()["B16"], gmm.grouped_update_mxu.launches

    # (a) gradients against the plain step.
    want_loss, want = plain_grads(torch, params, batch, cfg)
    no_sync(torch, lambda: moe_forward(params, batch[0], cfg))
    fwd_route = main_route(gmm.grouped_mxu, "train step forward", "wgmma")
    loss, got = no_sync(torch, lambda: port_grads(torch, params, batch, cfg))
    rel_loss = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    errs = grad_errors(torch, got, want)
    log(f"phase 20a: MoE gradient d={cfg.d_model} d_ff={cfg.d_ff} {cfg.num_experts} "
        f"experts top-{cfg.top_k} bf16, {t['tokens']} tokens, vs the plain per-expert "
        f"autograd step: loss rel err {rel_loss:.2e}, gradient max err / max ref "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not (rel_loss < 1e-2 and all(v < 2e-2 for v in errs.values())):
        raise AssertionError("MoE gradient outside its tolerance against the plain step")
    del got, want

    # (b) the main path: 5 training steps, launch counts zeroed first, the
    # route of every B17 launch recorded (both weight gradients: the rule
    # gives the engine).
    reset_quant_counters()
    gmm.grouped_update_mxu.launches = 0
    losses, worst, b17_routes = [], 0.0, []
    launch_b17 = gmm._update_launch

    def recorded(*args, **kw):
        out = launch_b17(*args, **kw)
        b17_routes.append(gmm.grouped_update_mxu.last_route)
        return out

    gmm._update_launch = recorded
    try:
        for step in range(t["steps"]):
            plain_loss = float(moe_plain_loss(torch, params, batch, cfg))
            before = counts()
            params, loss = no_sync(torch, lambda p=params: moe_train_step(
                p, batch, cfg, lr=t["lr"]))
            after = counts()
            if (after[0] - before[0], after[1] - before[1]) != (3, 2):
                raise AssertionError(f"train step {step}: B16 {after[0] - before[0]}, "
                                     f"B17 {after[1] - before[1]} launches (want 3, 2)")
            losses.append(float(loss))
            worst = max(worst, abs(losses[-1] - plain_loss) / abs(plain_loss))
            if not all(bool(torch.isfinite(p.float()).all()) for p in params.values()):
                raise AssertionError(f"train step {step}: a parameter is not finite")
    finally:
        gmm._update_launch = launch_b17
    launches = {"B16": counts()[0], "B17": counts()[1]}
    if len(b17_routes) != launches["B17"] or set(b17_routes) != {"wgmma"}:
        raise AssertionError(f"train steps: B17 routes {b17_routes}, the rule gives wgmma")
    # The step's last B16 launch is w2's dlhs (transpose_rhs flipped).
    dlhs_route = main_route(gmm.grouped_mxu, "train step dlhs", "wgmma")
    log(f"phase 20b: {t['steps']} moe_train_step steps (lr {t['lr']}): losses "
        + " ".join(f"{v:.6f}" for v in losses)
        + f"; worst rel err against the plain loss on the same params {worst:.2e}; "
        f"launch counts {launches} (3 B16 + 2 B17 a step); B16 route {fwd_route} "
        f"forward, {dlhs_route} for w2's dlhs; B17 routes {sorted(set(b17_routes))} "
        f"({len(b17_routes)} launches)")
    if not (worst < 1e-2 and losses[-1] < losses[0]):
        raise AssertionError("MoE training: loss off the plain step's or not falling")

    # (c) the Switch aux loss; an explicit GemmConfig (fp32 hidden layers).
    res = {}
    for key, step_cfg, aux in (
            ("aux_weight 0.01", cfg, t["aux_weight"]),
            ("gemm=GemmConfig()", dataclasses.replace(cfg, gemm=GemmConfig()), 0.0)):
        plain_loss = float(moe_plain_loss(torch, params, batch, cfg, aux))
        before = counts()
        new, loss = no_sync(torch, lambda c_=step_cfg, a=aux: moe_train_step(
            params, batch, c_, lr=t["lr"], aux_weight=a))
        after = counts()
        rel = abs(float(loss) - plain_loss) / abs(plain_loss)
        res[key] = rel
        if ((after[0] - before[0], after[1] - before[1]) != (3, 2) or rel >= 1e-2
                or not all(bool(torch.isfinite(p.float()).all()) for p in new.values())):
            raise AssertionError(f"train step with {key}: loss rel err {rel:.2e}, "
                                 f"launches {after[0] - before[0]} / {after[1] - before[1]}")
    log("phase 20c: one step each with " + ", ".join(
        f"{k} (loss rel err {v:.2e})" for k, v in res.items()) + ": ok")
    del params, batch, new

    # (d) fp32 at a reduced width against the plain fp32 step.
    f = t["fp32"]
    cfg32 = MoEConfig(d_model=f["d_model"], d_ff=f["d_ff"], num_experts=f["experts"],
                      top_k=c["top_k"], dtype="float32")
    p32, b32 = train_setup(torch, cfg32, f["tokens"], seed=203)
    want_loss, want = plain_grads(torch, p32, b32, cfg32)
    loss, got = no_sync(torch, lambda: port_grads(torch, p32, b32, cfg32))
    rel_loss = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    errs = grad_errors(torch, got, want)
    new, _ = no_sync(torch, lambda: moe_train_step(p32, b32, cfg32, lr=t["lr"]))
    log(f"phase 20d: fp32 MoE gradient d={f['d_model']} d_ff={f['d_ff']} "
        f"{f['tokens']} tokens vs the plain fp32 step: loss rel err {rel_loss:.2e}, "
        "gradient max err / max ref " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if not (rel_loss < 1e-4 and all(v < 1e-4 for v in errs.values())
            and all(bool(torch.isfinite(p).all()) for p in new.values())):
        raise AssertionError("fp32 MoE gradient outside 1e-4 of the plain step")
    log(f"phase 20: main-path launch counts {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice 6 main path")
    return launches, dict(losses=losses)


def phase_times6(torch):
    """Phase 21: B17 at the training step's two weight-gradient shapes
    beside its bound, its plain version and a library yardstick
    (``torch._grouped_mm``'s 2-D x 2-D form with offsets if this PyTorch
    takes it, else a per-expert ``torch.matmul`` loop; timed here, never
    called by the port); the MoE training step beside the plain per-expert
    autograd step and its bound; a torch.profiler breakdown of one step
    (launches here are comparisons, not the main path's)."""
    from gemm_hls_tpu_torch.models.moe import MoEConfig, moe_train_step
    from gemm_hls_tpu_torch.models.perf_model import H100, grouped_bound, grouped_update_bound
    from gemm_hls_tpu_torch.ops import gmm
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    c, t = SERVING, TRAIN
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(211)
    slots, d, ff, e = t["tokens"] * c["top_k"], c["d_model"], c["d_ff"], c["experts"]
    ids = torch.randint(0, e, (slots,), generator=gen, device="cuda")
    uniform = torch.bincount(ids, minlength=e).to(torch.int32)
    # A skewed routing: 70% of the slots to one expert, the rest spread.
    hot = int(0.7 * slots)
    skewed = torch.tensor([hot] + [(slots - hot) // (e - 1)] * (e - 2)
                          + [slots - hot - (slots - hot) // (e - 1) * (e - 2)],
                          dtype=torch.int32, device="cuda")
    out = {}
    for key, k, n, sizes in (("B17 w1 grad 8192 slots", d, ff, uniform),
                             ("B17 w2 grad 8192 slots", ff, d, uniform),
                             ("B17 w1 grad 8192 slots skewed 70%", d, ff, skewed)):
        ends = torch.cumsum(sizes, 0).to(torch.int32)
        host_ends = [0] + ends.tolist()
        lhs = (torch.randn((slots, k), generator=gen, device="cuda") * 0.5).to(bf16)
        g = (torch.randn((slots, n), generator=gen, device="cuda") * 1e-3).to(bf16)
        fns = {"kernel": lambda lhs=lhs, g=g, sizes=sizes: gmm.grouped_update_mxu(
            lhs, g, sizes, num_groups=e)}
        plain = lambda lhs=lhs, g=g, sizes=sizes: gmm.grouped_update_mxu_plain(  # noqa: E731
            lhs, g, sizes, num_groups=e)
        got, ref = fns["kernel"](), plain()
        err = compare(torch, got, ref, BF16_RTOL, f"timed {key}", scaled=True)[0]
        route = gmm.grouped_update_mxu.last_route
        other = "mma.sync" if route == "wgmma" else "wgmma"
        fns[other] = lambda lhs=lhs, g=g, sizes=sizes, o=other: gmm._update_launch(
            lhs, g, sizes, slots, k, n, e, bf16, o)
        compare(torch, fns[other](), ref, BF16_RTOL, f"timed {key} {other}", scaled=True)
        lib_name = "per-expert torch.matmul loop"
        fns["library"] = (lambda lhs=lhs, g=g, host_ends=host_ends: torch.stack(
            [lhs[a:b].T @ g[a:b] for a, b in zip(host_ends[:-1], host_ends[1:])]))
        if hasattr(torch, "_grouped_mm"):
            try:
                lib_out = torch._grouped_mm(lhs.t(), g, offs=ends, out_dtype=bf16)
                if tuple(lib_out.shape) != (e, k, n):
                    raise ValueError(f"shape {tuple(lib_out.shape)}")
                lib_name = "torch._grouped_mm"
                fns["library"] = (lambda lhs=lhs, g=g, ends=ends: torch._grouped_mm(
                    lhs.t(), g, offs=ends, out_dtype=bf16))
            except Exception as exc:  # the yardstick only: the port never calls it
                log(f"phase 21: torch._grouped_mm refused ({type(exc).__name__}: {exc})")
        compare(torch, fns["library"](), ref, BF16_RTOL, f"{key} {lib_name}", scaled=True)
        turns = time_turns(torch, fns)
        plain_ms = time_fn(plain, [()], iters=3, warmup=1) * 1e3
        bound = grouped_update_bound(H100, k, n, slots, e, bf16)
        out[key] = dict(ms=turns["kernel"], plain_ms=plain_ms, library_ms=turns["library"],
                        library=lib_name, max_abs_err=err, bound=bound, route=route,
                        other_route=other, other_ms=turns[other])
        log(f"phase 21: {key} ({slots} x {k}) x ({slots} x {n}) -> ({e}, {k}, {n}) bf16, "
            f"group sizes {sizes.tolist()}: {turns['kernel']:.4f} ms (route {route}; {other} "
            f"{turns[other]:.4f} ms) vs plain {plain_ms:.3f} ms, bound {bound[0] * 1e3:.4f} ms "
            f"({bound[1]}), {lib_name} {turns['library']:.4f} ms (device time in turns); "
            f"max abs err {err:.3e}")
        del lhs, g, got, ref, fns

    # The training step end to end (each timed window ends in a sync).
    cfg = MoEConfig(d_model=d, d_ff=ff, num_experts=e, top_k=c["top_k"], dtype="bfloat16")
    params, batch = train_setup(torch, cfg, t["tokens"], seed=213)

    def plain_step():
        loss, grads = plain_grads(torch, params, batch, cfg)
        with torch.no_grad():
            new = {k: (p - t["lr"] * grads[k].float()).to(p.dtype) for k, p in params.items()}
        return loss, *new.values()

    out["step ms"] = time_fn(lambda: moe_train_step(params, batch, cfg, lr=t["lr"])[1],
                             [()], iters=5) * 1e3
    out["step plain ms"] = time_fn(plain_step, [()], iters=3, warmup=1) * 1e3
    router = H100.bound(2 * 2.0 * t["tokens"] * d * e, H100.peak_for("float32"),
                        2 * t["tokens"] * d * 2)
    out["step bound ms"] = 1e3 * (
        router[0]
        + grouped_bound(H100, slots, d, ff, slots, e, bf16)[0]
        + grouped_bound(H100, slots, ff, d, slots, e, bf16)[0]
        + grouped_bound(H100, slots, d, ff, slots, e, bf16)[0]      # w2's dlhs
        + grouped_update_bound(H100, d, ff, slots, e, bf16)[0]
        + grouped_update_bound(H100, ff, d, slots, e, bf16)[0])
    log(f"phase 21: moe_train_step d={d} d_ff={ff} {e} experts top-{c['top_k']} bf16, "
        f"{t['tokens']} tokens: {out['step ms']:.3f} ms vs plain per-expert autograd "
        f"step {out['step plain ms']:.3f} ms; bound {out['step bound ms']:.4f} ms "
        f"(five grouped GEMMs and the router)")
    busy, kernels = device_profile(
        torch, lambda: moe_train_step(params, batch, cfg, lr=t["lr"]), 3)
    out["step busy"] = busy
    log(f"phase 21: profile train step: device busy {busy:.1%} of the window; per step "
        + "; ".join(f"{name[:48]} {us:.1f} us" for name, us in kernels[:10]))
    return out


# ---------------------------------------------------------------------------
# Slice 7: the fused distributed GEMMs -- the ring (B18) and Cannon (B19)
# as in-kernel signal / wait protocols, their ranks on one card
# ---------------------------------------------------------------------------

_DT7 = ("float32", "bfloat16", "int8")
# Phase 22's table, which tests/test_torch_kernels.py parametrises too:
# (ranks, dtype, M/n, N/n, K, block_k, permuted rank-to-slot table, blocks
# per rank cap (0: the occupancy's), output dtype).  Every ring size in the
# three types with M/n and N/n off the tiles; block_k 64 and 128 (the TPU's
# tiled body) and block_ks no K step of the kernel divides; odd ring sizes;
# permuted slots; three blocks a rank (one sender, two compute blocks
# walking many (step, tile) pairs each); bf16 and int32 outputs.  Routes
# (``ops.ring.ring_route``): bf16 and int8 with K bytes a multiple of 16 run
# the wgmma engine (most rows; ragged M and N off its 128 x 256 tile, K =
# 2048 for a long stage ring), bf16 K = 100 and int8 K = 72 the mma.sync
# tiles, fp32 the CUDA cores.
RING_CASES = (
    [(n, dt, 70, 136, 192, None, False, 0, "float32") for n in (1, 2, 4, 8) for dt in _DT7]
    + [(4, dt, 64, 128, 256, bk, False, 0, "float32") for dt in _DT7 for bk in (64, 128)]
    + [(2, "float32", 33, 40, 90, 30, False, 0, "float32"),
       (4, "bfloat16", 50, 72, 100, None, False, 0, "float32"),
       (3, "int8", 40, 50, 72, 24, False, 0, "float32"),
       (4, "bfloat16", 96, 160, 320, 64, True, 0, "float32"),
       (8, "float32", 40, 72, 128, None, True, 0, "float32"),
       (8, "int8", 64, 256, 128, 64, True, 0, "float32"),
       (8, "bfloat16", 200, 300, 320, None, False, 3, "float32"),
       (5, "float32", 130, 140, 96, 32, False, 3, "float32"),
       (4, "bfloat16", 128, 256, 512, None, False, 0, "bfloat16"),
       (2, "bfloat16", 256, 512, 2048, None, False, 0, "float32"),
       (3, "bfloat16", 129, 257, 136, None, True, 0, "bfloat16"),
       (4, "int8", 200, 520, 384, 128, False, 0, "float32"),
       (6, "int8", 130, 300, 256, None, False, 3, "int32"),
       (3, "int8", 40, 50, 72, None, False, 3, "int32")]
)
# The race check: one case (on the wgmma route) launched RING_REPEATS
# times, the same bits each, and again with each of RING_SAME_BITS_BLOCK_K
# (one kernel serves both TPU bodies: block_k must not change a bit).
RING_REPEAT_CASE = (8, "bfloat16", 200, 300, 320, None, True, 0, "float32")
RING_REPEATS = 20
RING_SAME_BITS_BLOCK_K = (64, 320)
# Phase 23's table: (p, dtype, M, N, K, "random" | "identity", blocks per
# rank cap, output dtype).  p = 1, 2, 3 in the three types with local
# blocks off the tiles (K/p of 33 and 100: the mma.sync tiles; 96 and 128:
# the wgmma engine); tests/test_pallas_cannon.py's identity-skew case (A
# of constant blocks times I must come back exactly, so a block landing at
# the wrong rank shows) at p = 2 and 3; capped grids (many (step, tile)
# pairs a block); p = 4, the largest rank table; bf16 outputs on every
# route at p = 2 and 3, where the running sum is rounded per step.
CANNON_CASES = (
    [(p, dt, m, n, k, "random", 0, "float32")
     for p, (m, n, k) in ((1, (70, 136, 96)), (2, (140, 272, 200)), (3, (201, 390, 99)))
     for dt in _DT7]
    + [(2, "float32", 16, 16, 16, "identity", 0, "float32"),
       (3, "float32", 24, 24, 24, "identity", 0, "float32"),
       (3, "bfloat16", 384, 510, 384, "random", 3, "float32"),
       (4, "int8", 256, 256, 256, "random", 0, "float32"),
       (2, "int8", 260, 520, 512, "random", 3, "int32"),
       (2, "bfloat16", 256, 1024, 512, "random", 0, "bfloat16"),
       (3, "bfloat16", 390, 780, 384, "random", 0, "bfloat16"),
       (2, "bfloat16", 140, 272, 200, "random", 3, "bfloat16"),
       (3, "float32", 201, 390, 99, "random", 0, "bfloat16"),
       (2, "int8", 256, 520, 256, "random", 0, "bfloat16")]
)


def dist_operands(torch, gen, shape_a, shape_b, dtype):
    """Seeded card operands: U(-1, 1) floats, int8 in [-100, 100]."""
    if dtype == torch.int8:
        return tuple(torch.randint(-100, 101, s, generator=gen, device="cuda",
                                   dtype=torch.int32).to(torch.int8) for s in (shape_a, shape_b))
    return signed(torch, shape_a, dtype, gen), signed(torch, shape_b, dtype, gen)


def poison(torch, t):
    """Fill a buffer the kernel must write before it reads: NaN for floats,
    0x5A bytes for integers (a read before the data arrives shows)."""
    return t.fill_(float("nan") if t.is_floating_point() else
                   (0x5A if t.element_size() == 1 else 0x5A5A5A5A))


def dist_rtol(torch, out_dtype, in_dtype):
    """Exact for int8 (int32 sums on both sides), else phase 16's."""
    return 0.0 if in_dtype == torch.int8 else quant_rtol(torch, out_dtype)


def ring_setup(torch, gen, case):
    """A RING_CASES case on the card: (A shards, B shards, scratch), rank r's
    blocks and buffers at slot slots[r] of stacked tensors, the ring
    buffers poisoned."""
    import random

    from gemm_hls_tpu_torch.ops import ring
    n, dt, ml, nl, k, bk, perm, _, _ = case
    dtype = getattr(torch, dt)
    a, b = dist_operands(torch, gen, (n * ml, k), (k, n * nl), dtype)
    slots = random.Random(n).sample(range(n), n) if perm else list(range(n))
    a_st = torch.empty((n, ml, k), dtype=dtype, device="cuda")
    b_st = torch.empty((n, k, nl), dtype=dtype, device="cuda")
    for r, s in enumerate(slots):
        a_st[s] = a[r * ml:(r + 1) * ml]
        b_st[s] = b[:, r * nl:(r + 1) * nl]
    one = ring.ring_scratch(1, k, nl, dtype, "cuda")
    comm = poison(torch, torch.empty((n, *one.comm[0].shape), dtype=dtype, device="cuda"))
    flags = torch.empty((n, one.flags[0].numel()), dtype=torch.int32, device="cuda")
    scratch = ring.RingScratch([comm[s] for s in slots], [flags[s] for s in slots])
    return [a_st[s] for s in slots], [b_st[s] for s in slots], scratch


def ring_case(torch, gen, case):
    """One RING_CASES case: ``ring_gemm`` (one B18 launch) against
    ``ring_gemm_plain`` on the same shards.  Returns the largest abs
    error."""
    from gemm_hls_tpu_torch.ops import ring
    n, dt, ml, nl, k, bk, perm, cap, out = case
    a_sh, b_sh, scratch = ring_setup(torch, gen, case)
    out_dtype = getattr(torch, out)
    before = ring.ring_gemm.launches
    got = ring.ring_gemm(a_sh, b_sh, out_dtype=out_dtype, block_k=bk, scratch=scratch,
                         max_blocks_per_rank=cap)
    if ring.ring_gemm.launches != before + 1:
        raise AssertionError(f"B18 {case}: no launch")
    if ring.ring_gemm.last_route != ring.ring_route(a_sh[0].dtype, k):
        raise AssertionError(f"B18 {case}: route {ring.ring_gemm.last_route}")
    ref = ring.ring_gemm_plain(a_sh, b_sh, out_dtype=out_dtype)
    return compare(torch, torch.cat(got), torch.cat(ref),
                   dist_rtol(torch, out_dtype, a_sh[0].dtype), f"B18 {case}", scaled=True)[0]


def ring_repeats(torch, gen):
    """RING_REPEAT_CASE launched RING_REPEATS times on the same shards and
    scratch, then once with each RING_SAME_BITS_BLOCK_K: every launch gives
    the first one's bits."""
    from gemm_hls_tpu_torch.ops import ring
    a_sh, b_sh, scratch = ring_setup(torch, gen, RING_REPEAT_CASE)
    first = torch.cat(ring.ring_gemm(a_sh, b_sh, scratch=scratch))
    if ring.ring_gemm.last_route != "wgmma":
        raise AssertionError(f"B18 {RING_REPEAT_CASE}: route {ring.ring_gemm.last_route}")
    for i in range(RING_REPEATS - 1):
        if not torch.equal(first, torch.cat(ring.ring_gemm(a_sh, b_sh, scratch=scratch))):
            raise AssertionError(f"B18: launch {i + 2} of {RING_REPEAT_CASE} differs "
                                 f"from the first")
    for bk in RING_SAME_BITS_BLOCK_K:
        got = torch.cat(ring.ring_gemm(a_sh, b_sh, block_k=bk, scratch=scratch))
        if not torch.equal(first, got):
            raise AssertionError(f"B18: block_k={bk} changes the bits of {RING_REPEAT_CASE}")


def cannon_case(torch, gen, case):
    """One CANNON_CASES case: ``cannon_gemm`` (one B19 launch) against
    ``cannon_gemm_plain``, buffers and sums poisoned; the identity-skew
    case must return A exactly.  Returns the largest abs error."""
    import numpy as np

    from gemm_hls_tpu_torch.ops import cannon, ring
    p, dt, m, n, k, kind, cap, out = case
    dtype, out_dtype = getattr(torch, dt), getattr(torch, out)
    if kind == "identity":
        ml = m // p
        a = torch.from_numpy(np.kron(np.arange(1, p * p + 1).reshape(p, p),
                                     np.ones((ml, ml)))).to("cuda", dtype)
        b = torch.eye(m, dtype=dtype, device="cuda")
    else:
        a, b = dist_operands(torch, gen, (m, k), (k, n), dtype)
    ab, bb = cannon.cannon_blocks(a, b, p)
    scratch = cannon.cannon_scratch(p, m // p, n // p, k // p, dtype, "cuda", out_dtype)
    for t in (*scratch.comm_a, *scratch.comm_b, *scratch.sums):
        poison(torch, t)
    before = cannon.cannon_gemm.launches
    got = cannon.cannon_gemm(ab, bb, p, out_dtype=out_dtype, scratch=scratch,
                             max_blocks_per_rank=cap)
    if cannon.cannon_gemm.launches != before + 1:
        raise AssertionError(f"B19 {case}: no launch")
    if cannon.cannon_gemm.last_route != ring.ring_route(dtype, k // p):
        raise AssertionError(f"B19 {case}: route {cannon.cannon_gemm.last_route}")
    ref = cannon.cannon_gemm_plain(ab, bb, p, out_dtype=out_dtype)
    err = compare(torch, torch.stack(got), torch.stack(ref), dist_rtol(torch, out_dtype, dtype),
                  f"B19 {case}", scaled=True)[0]
    if kind == "identity" and not torch.equal(cannon.assemble(got, p), a.float()):
        raise AssertionError(f"B19 {case}: A . I is not A (a block landed at the wrong rank)")
    return err


def phase_dist_kernels(torch):
    """Phases 22 and 23: B18 against its plain version over RING_CASES and
    the RING_REPEATS same-bits check; B19 against its plain version over
    CANNON_CASES.  Tolerances: exact for int8, phase 16's (relative 1e-4
    scaled by the largest output for fp32 outputs, 1e-2 for bf16) else."""
    from gemm_hls_tpu_torch.ops import ring
    gen = torch.Generator(device="cuda").manual_seed(221)
    worst = max(ring_case(torch, gen, c) for c in RING_CASES)
    ring_repeats(torch, gen)
    torch.cuda.synchronize()
    log(f"phase 22: B18 vs plain, {len(RING_CASES)} cases (rings of 1-8 ranks on one "
        f"card, fp32 / bf16 / int8, wgmma / mma.sync / CUDA-core routes, block_k None / 64 / "
        f"128 / 30 / 24, tiles off the edges, permuted slots, capped blocks, ring buffers "
        f"poisoned): ok (max abs err "
        f"{worst:.3e}); {RING_REPEATS} launches of {RING_REPEAT_CASE} and block_k "
        f"{RING_SAME_BITS_BLOCK_K} bitwise equal; "
        f"blocks per rank of the last launch (senders, compute) {ring.ring_gemm.last_split}")
    worst = max(cannon_case(torch, gen, c) for c in CANNON_CASES)
    torch.cuda.synchronize()
    log(f"phase 23: B19 vs plain, {len(CANNON_CASES)} cases (p = 1-4, fp32 / bf16 / int8, "
        f"all three routes, identity skew at p = 2 and 3, bf16 outputs rounded per step, "
        f"buffers and sums poisoned): ok (max abs err "
        f"{worst:.3e})")


# Phase 24: the headline size of the repo (bench.py's bf16 8192^3).
DIST = dict(size=8192, ring_ranks=4, block_ks=(None, 512), cannon_p=2, time_ranks=(1, 4, 8))


def phase_slice7(torch):
    """Phase 24 (main path): ``ring_matmul`` at bf16 8192^3 over 4 ranks on
    the card with block_k None and 512, ``cannon_matmul_fused`` at p = 2,
    launch counts set to 0 just before and read just after; each product's
    max |C - ref| / max |ref| against fp32 ``torch.matmul`` of the whole
    product (TF32 off) below 1e-4 (both sum exact bf16 products in fp32)."""
    from gemm_hls_tpu_torch.ops import cannon, ring
    from gemm_hls_tpu_torch.parallel import cannon_matmul_fused, make_mesh, ring_matmul

    s, n = DIST["size"], DIST["ring_ranks"]
    gen = torch.Generator(device="cuda").manual_seed(241)
    a, b = dist_operands(torch, gen, (s, s), (s, s), torch.bfloat16)
    ref = torch.matmul(a.float(), b.float())
    top = ref.abs().max()
    mesh = make_mesh((n,), ("x",), devices=[torch.device("cuda")] * n)
    errs = {}

    def check(key, c):
        if c.shape != (s, s) or not bool(torch.isfinite(c).all()):
            raise AssertionError(f"{key}: shape {tuple(c.shape)} or values not finite")
        errs[key] = float((c - ref).abs().max() / top)

    ring.ring_gemm.launches = cannon.cannon_gemm.launches = 0
    for bk in DIST["block_ks"]:
        check(f"ring_matmul {n} ranks block_k={bk}",
              torch.cat(ring_matmul(a, b, mesh, block_k=bk)))
    p = DIST["cannon_p"]
    check(f"cannon_matmul_fused p={p}", cannon_matmul_fused(a, b, p))
    torch.cuda.synchronize()
    launches = {"B18": ring.ring_gemm.launches, "B19": cannon.cannon_gemm.launches}
    log(f"phase 24: bf16 {s}^3 through the front doors, rel err against fp32 torch.matmul: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f"; launch counts {launches}")
    if not all(v < F32_RTOL for v in errs.values()):
        raise AssertionError("slice 7 main path outside 1e-4 of torch.matmul")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the slice 7 main path")
    return launches


def stamp_report(torch, stamps, ranks, steps):
    """Phase 24's breakdown of one stamped launch (``csrc/dist_tile.cuh``'s
    stamps): the prologue (launch start to staging / skew done, as each
    rank's compute block 0 saw it; the longest over the ranks), the mean
    step of rank 0's compute block 0, each step's sends' end after its
    compute start, and the longest time any compute block waited on a
    flag, all in ms."""
    from gemm_hls_tpu_torch.ops.ring import stamp_words
    st = stamps.view(ranks, stamp_words(steps)).cpu().tolist()
    head, begin, end, sent = 4, [], [], []
    r0 = st[0]
    for s in range(steps):
        begin.append(r0[head + s])
        end.append(r0[head + steps + s])
        if s + 1 < steps:
            sent.append((r0[head + 2 * steps + s] - r0[head + s]) / 1e6)
    out = {"prologue ms": max((r[1] - r[0]) / 1e6 for r in st),
           "mean step ms": sum(e - b for b, e in zip(begin, end)) / steps / 1e6,
           "steps ms": [(e - b) / 1e6 for b, e in zip(begin, end)],
           "sends done after step start ms": sent,
           "longest wait ms": max(r[2] for r in st) / 1e6,
           "launch to last step end ms": (end[-1] - r0[0]) / 1e6}
    return out


def phase_times7(torch):
    """Phase 24, times: B18 at bf16 8192^3 over 1 (the tile engine on the
    whole card, no ring), 4 and 8 ranks (block_k None and, at 4 ranks, 512)
    and B19 at p = 2, each beside its bound (``ring_bound`` /
    ``cannon_bound``), its plain schedule and bf16 ``torch.matmul`` of the
    whole product (the library call that computes the same function; timed
    here, never called by the port); the protocol's cost is the ring's time
    over torch.matmul's.  Then one stamped launch of the 4-rank ring and of
    Cannon: where the time goes (``stamp_report``).  Launches here are
    comparisons, not the main path's."""
    from gemm_hls_tpu_torch.models.perf_model import H100, cannon_bound, ring_bound
    from gemm_hls_tpu_torch.ops import cannon, ring
    from gemm_hls_tpu_torch.parallel import make_mesh
    from gemm_hls_tpu_torch.utils.benchmark import time_fn

    s, bf16 = DIST["size"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(243)
    a, b = dist_operands(torch, gen, (s, s), (s, s), bf16)
    lib_ms = time_fn(lambda: torch.matmul(a, b), [()], iters=20) * 1e3
    out = {"torch.matmul ms": lib_ms}
    runs = [(n, None) for n in DIST["time_ranks"]] + [(DIST["ring_ranks"], 512)]
    for n, bk in runs:
        mesh = make_mesh((n,), ("x",), devices=[torch.device("cuda")] * n)
        a_s, b_s = ring.shard_operands_ring(a, b, mesh)
        scratch = ring.ring_scratch(n, s, s // n, bf16, "cuda")
        fn = lambda a_s=a_s, b_s=b_s, sc=scratch, bk=bk: ring.ring_gemm(  # noqa: E731
            a_s, b_s, block_k=bk, scratch=sc)
        plain = lambda a_s=a_s, b_s=b_s: ring.ring_gemm_plain(a_s, b_s)  # noqa: E731
        err = compare(torch, torch.cat(fn()), torch.cat(plain()), F32_RTOL,
                      f"B18 {n} ranks block_k={bk}", scaled=True)[0]
        ms = time_fn(fn, [()], iters=5) * 1e3
        plain_ms = time_fn(plain, [()], iters=2, warmup=1) * 1e3
        bound = ring_bound(H100, s, s, s, n, bf16)
        key = f"B18 {n} ranks" + (f" block_k={bk}" if bk else "")
        out[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                        bound=bound, split=ring.ring_gemm.last_split,
                        route=ring.ring_gemm.last_route)
        log(f"phase 24: {key} bf16 {s}^3: {ms:.3f} ms ({ms / lib_ms:.2f}x torch.matmul's "
            f"{lib_ms:.3f} ms) vs plain schedule {plain_ms:.3f} ms, bound {bound[0] * 1e3:.4f} "
            f"ms ({bound[1]}); route {ring.ring_gemm.last_route}, blocks per rank "
            f"{ring.ring_gemm.last_split}; max abs err {err:.3e}")
        if bk is None:
            stamps = torch.zeros(n * ring.stamp_words(n), dtype=torch.int64, device="cuda")
            ring.ring_gemm(a_s, b_s, scratch=scratch, stamps=stamps)
            out[key]["stamps"] = stamp_report(torch, stamps, n, n)
            log(f"phase 24: {key} stamps: {json.dumps(out[key]['stamps'])}")
        del a_s, b_s, scratch
    p = DIST["cannon_p"]
    ab, bb = cannon.cannon_blocks(a, b, p)
    ab, bb = [t.contiguous() for t in ab], [t.contiguous() for t in bb]
    scratch = cannon.cannon_scratch(p, s // p, s // p, s // p, bf16, "cuda")
    fn = lambda: cannon.cannon_gemm(ab, bb, p, scratch=scratch)  # noqa: E731
    plain = lambda: cannon.cannon_gemm_plain(ab, bb, p)  # noqa: E731
    err = compare(torch, torch.stack(fn()), torch.stack(plain()), F32_RTOL,
                  f"B19 p={p}", scaled=True)[0]
    ms = time_fn(fn, [()], iters=5) * 1e3
    plain_ms = time_fn(plain, [()], iters=2, warmup=1) * 1e3
    bound = cannon_bound(H100, s, s, s, p, bf16)
    key = f"B19 p={p}"
    out[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err,
                    bound=bound, split=cannon.cannon_gemm.last_split,
                    route=cannon.cannon_gemm.last_route)
    log(f"phase 24: {key} bf16 {s}^3: {ms:.3f} ms ({ms / lib_ms:.2f}x torch.matmul's) "
        f"vs plain schedule {plain_ms:.3f} ms, bound {bound[0] * 1e3:.4f} ms ({bound[1]}); "
        f"route {cannon.cannon_gemm.last_route}, blocks per rank "
        f"{cannon.cannon_gemm.last_split}; max abs err {err:.3e}")
    stamps = torch.zeros(p * p * ring.stamp_words(p), dtype=torch.int64, device="cuda")
    cannon.cannon_gemm(ab, bb, p, scratch=scratch, stamps=stamps)
    out[key]["stamps"] = stamp_report(torch, stamps, p * p, p)
    log(f"phase 24: {key} stamps: {json.dumps(out[key]['stamps'])}")
    return out


# Slice 16: the host-staged GEMM's problem sizes (phase 25): the mid-size
# semiring, file and Ozaki runs, their host tile, and the profiled GEMM.
STAGED = dict(mid=8192, mid_tile=4096, profile=8192)


def every_counter():
    """The launch count of every kernel (B1-B19)."""
    from gemm_hls_tpu_torch.ops import cannon, gmm, ring
    out = dict(counters(), **flash_counters(), **quant_counters())
    out.update(B17=gmm.grouped_update_mxu.launches, B18=ring.ring_gemm.launches,
               B19=cannon.cannon_gemm.launches)
    return out


def reset_every_counter():
    from gemm_hls_tpu_torch.ops import cannon, gmm, ring
    reset_counters()
    reset_flash_counters()
    reset_quant_counters()
    gmm.grouped_update_mxu.launches = 0
    ring.ring_gemm.launches = cannon.cannon_gemm.launches = 0


def launched():
    """The kernels launched since the last reset, with their counts."""
    return {k: v for k, v in every_counter().items() if v}


def phase_slice16(torch):
    """Phase 25 (main path): slice 16's staged GEMMs and tools; returns
    each step's launches and readings.  Raises on any mismatch."""
    import collections
    import os

    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    from gemm_hls_tpu_torch.ops.vpu import vpu_matmul_plain
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.parallel import streamed_matmul, streamed_matmul_files
    from gemm_hls_tpu_torch.parallel.staging import streamed_ozaki_matmul
    from gemm_hls_tpu_torch.tools import oversize, print_specifications, profile, selftest
    from gemm_hls_tpu_torch.utils.tileio import MatrixFile, native_tileio_available

    out = {"launches": {}}

    def step(key, t0):
        torch.cuda.synchronize()
        out["launches"][key] = launched()
        out[f"{key} s"] = time.perf_counter() - t0
        return out[f"{key} s"]

    # (a) the reference tool at its defaults.
    reset_every_counter()
    t0 = time.perf_counter()
    res = oversize.run([])
    secs = step("a", t0)
    stats = res["stats"]
    if not res["ok"] or len(res["spots"]) != 8:
        raise AssertionError("phase 25a: oversize spot verification failed")
    if stats["routes"] != ["wgmma"] * stats["jobs"] or stats["jobs"] != 64:
        raise AssertionError(f"phase 25a: panel routes {stats['routes']}")
    if out["launches"]["a"] != {"B1": 64}:
        raise AssertionError(f"phase 25a: launches {out['launches']['a']}")
    worst = max(s["rel"] for s in res["spots"])
    log(f"phase 25a: tools.oversize 32768^3 bf16, tiles 8192: {secs:.3f} s "
        f"(fill {res['fill_seconds']:.3f} s, GEMM with staging {res['seconds']:.3f} s, "
        f"{res['gops'] / 1e3:.2f} TOp/s); host-to-device {stats['h2d_bytes']} bytes = "
        f"{stats['h2d_bytes'] / res['law_h2d_bytes']:.4f} x the CA law's "
        f"M*N*(K/tile_n + K/tile_m) words, {stats['h2d_bytes'] / res['seconds'] / 1e9:.2f} "
        f"GB/s over the GEMM; device-to-host {stats['d2h_bytes']} bytes; 8 spot checks "
        f"pass (worst rel {worst:.2e}); prefetch {stats['prefetch']}, {stats['slots']} "
        f"slots; launches {out['launches']['a']}\nphase 25a: panel routes "
        + " ".join(stats["routes"]))
    out["oversize"] = {"seconds": res["seconds"], "tops": res["gops"] / 1e3,
                       "h2d_bytes": stats["h2d_bytes"], "law_h2d_bytes": res["law_h2d_bytes"],
                       "h2d_gbs": stats["h2d_bytes"] / res["seconds"] / 1e9,
                       "worst_spot_rel": worst,
                       **{k: stats[k] for k in ("fill_s", "stage_wait_s", "drain_s")}}
    # The same problem with prefetch off and on again, in turns after the
    # tool's run (on, off, off, on), each bit-identical to the tool's.
    turns = []
    for i, prefetch in enumerate((False, False, True)):
        reset_every_counter()
        t0 = time.perf_counter()
        c2 = streamed_matmul(res["a"], res["b"], tile_m=8192, tile_n=8192, tile_k=8192,
                             prefetch=prefetch)
        secs = step(f"a turn {i + 1}", t0)
        if not torch.equal(c2, res["c"]):
            raise AssertionError(f"phase 25a: prefetch {prefetch} differs from the tool's run")
        del c2
        st = streamed_matmul.last_stats
        turns.append({"prefetch": prefetch, "seconds": secs,
                      **{k: st[k] for k in ("fill_s", "stage_wait_s", "drain_s")}})
    out["oversize"]["turns"] = turns
    log("phase 25a: the same problem in turns after the tool's run (prefetch on), each "
        "bit-identical to it: " + "; ".join(
            f"prefetch {'on' if t['prefetch'] else 'off'} {t['seconds']:.3f} s "
            f"({2.0 * 32768 ** 3 / t['seconds'] / 1e12:.2f} TOp/s; host fill {t['fill_s']:.3f} "
            f"s, compute thread waiting {t['stage_wait_s']:.3f} s, drain {t['drain_s']:.3f} s)"
            for t in turns)
        + f"; the tool's run: fill {stats['fill_s']:.3f} s, waiting {stats['stage_wait_s']:.3f}"
        f" s, drain {stats['drain_s']:.3f} s")
    del res

    # (b) min_plus and plus_times at 8192^3 fp32 in 4096 host tiles.
    n, t = STAGED["mid"], STAGED["mid_tile"]
    gen = torch.Generator(device="cuda").manual_seed(251)
    a_dev = torch.rand((n, n), generator=gen, device="cuda")
    b_dev = torch.rand((n, n), generator=gen, device="cuda")
    a, b = a_dev.cpu(), b_dev.cpu()
    reset_every_counter()
    t0 = time.perf_counter()
    tropical = streamed_matmul(a, b, semiring="min_plus", tile_m=t, tile_n=t, tile_k=t)
    secs = step("b min_plus", t0)
    routes = collections.Counter(streamed_matmul.last_stats["routes"])
    t0 = time.perf_counter()
    sr = get_semiring("min_plus")
    plain = vpu_matmul_plain(a_dev, b_dev, cfg=default_config("float32", semiring=sr.name),
                             sr=sr).cpu()
    plain_s = time.perf_counter() - t0
    if not torch.equal(tropical, plain):
        raise AssertionError("phase 25b: streamed min_plus differs from the plain semiring")
    log(f"phase 25b: streamed_matmul min_plus {n}^3 fp32, tiles {t}: {secs:.3f} s, equal "
        f"to the plain semiring on the card ({plain_s:.3f} s); panel routes {dict(routes)}, "
        f"launches {out['launches']['b min_plus']}")
    reset_every_counter()
    t0 = time.perf_counter()
    dense = streamed_matmul(a, b, tile_m=t, tile_n=t, tile_k=t)
    secs = step("b plus_times", t0)
    _, rel = compare(torch, dense, torch.matmul(a_dev, b_dev).cpu(), F32_RTOL,
                     "phase 25b streamed plus_times")
    log(f"phase 25b: streamed_matmul plus_times {n}^3 fp32, tiles {t}: {secs:.3f} s, max rel "
        f"err {rel:.2e} against fp32 torch.matmul; panel routes "
        f"{dict(collections.Counter(streamed_matmul.last_stats['routes']))}, launches "
        f"{out['launches']['b plus_times']}")
    out["min_plus_seconds"], out["plus_times_seconds"] = out["b min_plus s"], secs

    # (c) the same operands from files, through the native tile IO.
    if not native_tileio_available():
        raise AssertionError("phase 25c: native/libtileio.so did not build or load")
    with tempfile.TemporaryDirectory() as tmp:
        files = {name: MatrixFile(os.path.join(tmp, f"{name}.bin"), n, n, "float32",
                                  create=True) for name in "abc"}
        try:
            if not all(f.native for f in files.values()):
                raise AssertionError("phase 25c: a MatrixFile took the numpy.memmap path")
            files["a"].write_tile(0, 0, a.numpy())
            files["b"].write_tile(0, 0, b.numpy())
            reset_every_counter()
            t0 = time.perf_counter()
            streamed_matmul_files(files["a"], files["b"], files["c"], tile_m=t, tile_n=t,
                                  tile_k=t)
            secs = step("c", t0)
            from_file = torch.from_numpy(files["c"].read_tile(0, n, 0, n))
        finally:
            for f in files.values():
                f.close()
    if not torch.equal(from_file, dense):
        raise AssertionError("phase 25c: the files' product differs from the in-memory one")
    want = {"b min_plus": {"B3": 8}, "b plus_times": {"B1": 8}, "c": {"B1": 8}}
    for key, counts in want.items():
        if out["launches"][key] != counts:
            raise AssertionError(f"phase 25 {key}: launches {out['launches'][key]}, "
                                 f"want {counts}")
    log(f"phase 25c: streamed_matmul_files {n}^3 fp32 on the native tile IO, tiles {t}: "
        f"{secs:.3f} s, equal to 25b's in-memory plus_times; launches {out['launches']['c']}")
    del a_dev, b_dev, tropical, plain, dense, from_file

    # (d) f64-class Ozaki streamed at 8192^3.
    a64 = torch.rand((n, n), generator=gen, device="cuda", dtype=torch.float64) * 10 - 5
    b64 = torch.rand((n, n), generator=gen, device="cuda", dtype=torch.float64) * 10 - 5
    reset_every_counter()
    t0 = time.perf_counter()
    got = streamed_ozaki_matmul(a64.cpu().numpy(), b64.cpu().numpy())
    secs = step("d", t0)
    err, _ = normwise(torch, torch.from_numpy(got).cuda(), a64, b64)
    if not err < 1e-13:
        raise AssertionError(f"phase 25d: streamed Ozaki normwise {err:.2e} >= 1e-13")
    if out["launches"]["d"].get("B5") != 4:
        raise AssertionError(f"phase 25d: launches {out['launches']['d']}, want 4 of B5")
    out["ozaki_seconds"], out["ozaki_normwise"] = secs, err
    log(f"phase 25d: streamed_ozaki_matmul {n}^3 float64 (tiles 4096 x 4096 x 16384): "
        f"{secs:.3f} s, normwise {err:.2e} against float64 torch.matmul; launches "
        f"{out['launches']['d']}")
    del a64, b64, got

    # (e) the self-test battery at full size.
    reset_every_counter()
    t0 = time.perf_counter()
    if selftest.main([]) != 0:
        raise AssertionError("phase 25e: a self-test check failed")
    secs = step("e", t0)
    log(f"phase 25e: tools.selftest (1024^3): every check passes in {secs:.3f} s; launches "
        f"{out['launches']['e']}")

    # (f) the profiler on bf16 8192^3: in this process for the time against
    # the model (its B1 launches counted), then as a user runs it, in a fresh
    # process that writes a Chrome trace, whose kernel events are checked.
    m = STAGED["profile"]
    reset_every_counter()
    t0 = time.perf_counter()
    prof = profile.profile_matmul(m, m, m, dtype="bfloat16", iters=20)
    secs = step("f", t0)
    if prof["route"] != "wgmma":
        raise AssertionError(f"phase 25f: route {prof['route']}")
    out["profile"] = prof
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gemm_hls_tpu_torch.tools.profile", str(m), str(m), str(m),
             "--dtype", "bfloat16", "--iters", "20", "--trace-dir", tmp],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 25f: tools.profile exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        events = json.loads((Path(tmp) / "trace.json").read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    if not any("mxu_wg_kernel" in k for k in kernels):
        raise AssertionError(f"phase 25f: the trace's kernel events {kernels} hold no B1 "
                             "engine kernel")
    log(f"phase 25f: tools.profile bf16 {m}^3: {prof['measured_seconds'] * 1e3:.4f} ms "
        f"({prof['measured_gflops'] / 1e3:.1f} TFLOP/s, route {prof['route']}) against the "
        f"model's {prof['expected_seconds'] * 1e3:.4f} ms for blocks {prof['blocks']} "
        f"[{prof['bound']}-bound]: {prof['percent_of_expected']:.1f}% of expected, "
        f"{prof['percent_of_peak']:.1f}% of peak; {secs:.3f} s; launches "
        f"{out['launches']['f']}\nphase 25f: the CLI in a fresh process with --trace-dir "
        f"({cli_s:.3f} s): {len(events)} trace events, kernel events {kernels}; its output: "
        + " | ".join(proc.stdout.strip().splitlines()))

    # (g) the analytical model of the same problem.
    t0 = time.perf_counter()
    spec = print_specifications.main([str(m)] * 3 + ["--dtype", "bfloat16"])
    log(f"phase 25g: tools.print_specifications ({spec['chip']}): expected "
        f"{spec['expected_runtime_s'] * 1e3:.4f} ms, {time.perf_counter() - t0:.3f} s")
    if spec["chip"] != "h100":
        raise AssertionError(f"phase 25g: chip model {spec['chip']}")
    return out


# Slice 17 (phase 26): the tuning tools at one of the seed's shapes a
# family (gemm_hls_tpu_torch/data/autotune_seed.json), the sweep's grid and
# problem, the calibration probe's size.
TUNE = dict(dense=8192, batched=(64, 512), flash=(32, 1024, 128), dequant=(64, 2048, 2048, 128),
            w8a8=(4096, 2048, 2048), grouped=(8192, 2048, 4096, 8), rounds=3,
            sweep=1024, calibrate=2048)


def held(torch, got, ref, what):
    """The contract a tuned knob is held to, ``tools.autotune.tolerance``:
    exact for integers, rel 1e-3 normwise for fp32 outputs, 1e-2 normwise
    for 16-bit ones (one bf16 ulp of an element is 2^-8, so the whole result
    is held, not each element).  Returns the normwise error."""
    from gemm_hls_tpu_torch.tools.autotune import agreement, tolerance

    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {ref.shape}/{ref.dtype}")
    err = agreement(got, ref)
    if not err <= tolerance(got.dtype):
        raise AssertionError(f"{what}: normwise rel err {err:.3e} > {tolerance(got.dtype)}")
    return err


def tune_report(report):
    """One line a candidate: its knobs, status, readings (ms) and median."""
    out = []
    for r in report:
        knobs = {k: v for k, v in r["entry"].items() if k in ("route", "plan")}
        spread = (f"readings {[round(x, 4) for x in r['samples_ms']]} ms, median "
                  f"{r['ms']:.4f} ms ({r['gflops'] / 1e3:.1f} TFLOP/s), spread "
                  f"{(max(r['samples_ms']) / min(r['samples_ms']) - 1) * 100:.1f}%"
                  if "ms" in r else r.get("detail", ""))
        out.append(f"    {knobs}: {r['status']} {spread}")
    return "\n".join(out)


def phase_slice17(torch, seed):
    """Phase 26: slice 17's tuning tools, ``seed`` the packaged autotune seed;
    returns their readings.  Raises on any mismatch."""
    import os
    import tarfile

    from gemm_hls_tpu_torch import _build, matmul
    from gemm_hls_tpu_torch.config import default_config, route_config
    from gemm_hls_tpu_torch.models.perf_model import H100
    from gemm_hls_tpu_torch.ops import dequant, flash, gmm, mxu, quant
    from gemm_hls_tpu_torch.ops.attention import flash_attention
    from gemm_hls_tpu_torch.ops.grouped import grouped_matmul
    from gemm_hls_tpu_torch.tools import autotune, cache, calibrate, sweep

    out = {}
    rounds = TUNE["rounds"]
    tmp = Path(tempfile.mkdtemp(prefix="phase26_"))
    tuned = str(tmp / "autotune.json")
    none = str(tmp / "absent.json")
    gen = torch.Generator(device="cpu").manual_seed(26)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    def adopt(what, call, wrapper, want, ref, plan=None, want_plan=None):
        """The front door with the tuned cache (DEFAULT_CACHE, no seed) on
        the winner's route, held to the plain version; then with no cache
        file on the route rule's, ``rule``."""
        autotune.DEFAULT_CACHE, autotune.SEED_CACHE = tuned, none
        got = call()
        torch.cuda.synchronize()
        route = wrapper.last_route
        if route != want or (plan is not None and plan() != want_plan):
            raise AssertionError(f"phase 26a {what}: the front door took {route} "
                                 f"{plan() if plan else ''}, the winner is {want} "
                                 f"{want_plan if plan else ''}")
        err = held(torch, got if not isinstance(got, tuple) else got[0], ref, f"phase 26a {what}")
        autotune.DEFAULT_CACHE = none
        call()
        torch.cuda.synchronize()
        return route, err, wrapper.last_route

    # (b) and (d) run beside (a), (c) and (e): the sweep's children and the
    # fresh process spend their time starting up, on the host.
    # (d) the built library packaged, unpackaged into an empty directory, and
    # loaded by a fresh process that cannot run nvcc.
    t0 = time.perf_counter()
    built = _build.BUILD_DIR
    archive = tmp / "kernels.tar.gz"
    cache.package(str(archive))
    pack_s = time.perf_counter() - t0
    target = tmp / "unpacked"
    try:
        cache.unpackage(str(archive), str(target))
    finally:
        _build.BUILD_DIR = built
    with tarfile.open(archive) as tar:
        members = tar.getnames()
    code = (
        "import json, sys, time\n"
        "t0 = time.perf_counter()\n"
        "import torch\n"
        "from gemm_hls_tpu_torch import _build\n"
        "from gemm_hls_tpu_torch.config import route_config\n"
        "from gemm_hls_tpu_torch.ops import mxu\n"
        "from gemm_hls_tpu_torch.tools import cache\n"
        "cache.enable_persistent_cache(sys.argv[1])\n"
        "def no_nvcc():\n"
        "    raise RuntimeError('nvcc was called')\n"
        "_build._nvcc = no_nvcc\n"
        "t1 = time.perf_counter()\n"
        "_build.library()\n"
        "t2 = time.perf_counter()\n"
        "a = torch.randn(1024, 1024, device='cuda').bfloat16()\n"
        "c = mxu.mxu_matmul(a, a, cfg=route_config('bfloat16'))\n"
        "err = float((c.float() - (a.float() @ a.float())).norm() / (a.float() @ a.float()).norm())\n"
        "print(json.dumps(dict(load_s=t2 - t1, process_s=time.perf_counter() - t0, "
        "route=mxu.mxu_matmul.last_route, err=err, lib=str(_build.library_path()))))\n")
    env = dict(os.environ, PATH=os.pathsep.join(
        x for x in os.environ.get("PATH", "").split(os.pathsep) if "cuda" not in x))
    env.pop("CUDA_HOME", None)
    env.pop("CUDA_PATH", None)
    fresh = subprocess.Popen([sys.executable, "-c", code, str(target)], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # (b) a sweep of a small grid, each configuration in its own process:
    # the engine's tile, a tile no kernel is compiled for, one past the
    # shared memory, and a setup_code that raises.
    grid = (sweep.expand_grid(block_m=[128], block_n=[256], block_k=[64])
            + [dict(block_m=256, block_n=128, block_k=64),
               dict(block_m=512, block_n=512, block_k=128)])
    swept = {}

    def run_sweep(sz):
        t = time.perf_counter()
        try:
            res = sweep.sweep(grid, sz, sz, sz, base=default_config("bfloat16"),
                              isolation="process", workers=len(grid), timeout_s=300)
            res.append(sweep.run_one(default_config("bfloat16"), sz, sz, sz,
                                     isolation="process", timeout_s=300,
                                     setup_code="raise RuntimeError('injected by phase 26b')"))
            swept["res"] = res
        except Exception as exc:  # noqa: BLE001 - raised again in the phase's thread
            swept["exc"] = exc
        swept["s"] = time.perf_counter() - t

    sweeper = threading.Thread(target=run_sweep, args=(TUNE["sweep"],))
    sweeper.start()
    try:
        # (a) the engine's tile as an explicit config runs on the engine, and an
        # unaligned call with it raises (it cannot run there); then every family
        # tuned at one seed shape into a temporary cache, and adopted by its
        # front door.
        t0 = time.perf_counter()
        n = TUNE["dense"]
        autotune.DEFAULT_CACHE, autotune.SEED_CACHE = none, none
        a, b = rand(n, n), rand(n, n)
        ecfg = route_config("bfloat16")
        err = held(torch, matmul(a, b, config=ecfg), torch.matmul(a, b), "phase 26a engine config")
        if mxu.mxu_matmul.last_route != "wgmma":
            raise AssertionError(f"phase 26a: route_config's tile took {mxu.mxu_matmul.last_route}")
        pitched = rand(n, n + 1)[:, :n]  # rows of 8193 bf16: not whole 16-byte units
        try:
            matmul(pitched, b, config=ecfg)
        except ValueError as exc:
            refusal = str(exc)
        else:
            raise AssertionError("phase 26a: an unaligned call with the engine's tile ran")
        log(f"phase 26a: matmul(a, b, config=route_config('bfloat16')) bf16 {n}^3 on "
            f"{mxu.mxu_matmul.last_route} (normwise {err:.2e} to torch.matmul); with rows of "
            f"{n + 1} elements it raises: {refusal}")
        cfg = autotune.autotune(n, n, n, dtype="bfloat16", cache_path=tuned, rounds=rounds)
        win = autotune._MXU_ROUTE[cfg.route()]
        a, b = rand(n, n), rand(n, n)
        route, err, rule = adopt("dense", lambda: matmul(a, b), mxu.mxu_matmul, win,
                                 torch.matmul(a, b))
        if rule != mxu.mxu_route(torch.bfloat16, False, False, True):
            raise AssertionError(f"phase 26a dense: with no cache the route is {rule}")
        out["dense"] = dict(winner=win, route=route, no_cache_route=rule, err=err,
                            report=autotune.autotune.last_report)
        log(f"phase 26a: autotune bf16 {n}^3, {rounds} rounds in turns:\n"
            + tune_report(autotune.autotune.last_report)
            + f"\n  winner {win} (blocks {cfg.block_m}x{cfg.block_n}x{cfg.block_k}); matmul(a, b) "
              f"took {route} (normwise {err:.2e} to torch.matmul); with no cache file {rule}")

        bsz, s = TUNE["batched"]
        win = autotune.autotune_batched(bsz, s, s, s, cache_path=tuned, rounds=rounds)
        a, b = rand(bsz, s, s), rand(bsz, s, s)
        route, err, rule = adopt("batched", lambda: matmul(a, b), mxu.mxu_matmul_batched, win,
                                 torch.matmul(a, b))
        out["batched"] = dict(winner=win, route=route, no_cache_route=rule, err=err,
                              report=autotune.autotune_batched.last_report)
        log(f"phase 26a: autotune_batched {bsz} x {s}^3 bf16:\n"
            + tune_report(autotune.autotune_batched.last_report)
            + f"\n  winner {win}; matmul(a, b) took {route} (normwise {err:.2e}); with no "
              f"cache file {rule}")

        bh, sq, d = TUNE["flash"]
        fwd = autotune.autotune_flash(bh, sq, sq, d, causal=True, cache_path=tuned, rounds=rounds)
        fwd_report = autotune._tune_family.last_report
        ent = autotune.autotune_flash_bwd(bh, sq, sq, d, causal=True, cache_path=tuned,
                                          rounds=rounds)
        q, k, v = (rand(bh, sq, d, scale=0.3) for _ in range(3))
        ref = flash.flash_fwd_plain(q, k, v, causal=True, scale=d ** -0.5)[0]
        route, err, rule = adopt("flash", lambda: flash_attention(q, k, v, causal=True),
                                 flash.flash_mha, fwd["route"], ref)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        autotune.DEFAULT_CACHE, autotune.SEED_CACHE = tuned, none
        flash_attention(qg, kg, vg, causal=True).float().sum().backward()
        torch.cuda.synchronize()
        bwd = (flash.flash_mha_bwd_dq.last_route, flash.flash_mha_bwd_dkv.last_route)
        if bwd != (ent["bwd_route"],) * 2:
            raise AssertionError(f"phase 26a flash: the backward took {bwd}, the winner is "
                                 f"{ent['bwd_route']}")
        out["flash"] = dict(winner=fwd["route"], bwd_winner=ent["bwd_route"], route=route,
                            bwd_routes=bwd, no_cache_route=rule, err=err,
                            report=fwd_report, bwd_report=autotune.autotune_flash_bwd.last_report)
        log(f"phase 26a: autotune_flash ({bh}, {sq}, {d}) causal bf16, forward:\n"
            + tune_report(fwd_report) + "\n  backward pair (dq + dk / dv):\n"
            + tune_report(autotune.autotune_flash_bwd.last_report)
            + f"\n  winners {fwd['route']} / {ent['bwd_route']}; flash_attention took {route} "
              f"(normwise {err:.2e} to the plain version), its gradient {bwd}; with no cache "
              f"file {rule}")

        m, nn, kk, g = TUNE["dequant"]
        e = autotune.autotune_quant(m, nn, kk, mode="int4", group_size=g, cache_path=tuned,
                                    rounds=rounds)
        rep = autotune._tune_family.last_report
        w = torch.randn(kk, nn, generator=gen) / kk ** 0.5
        wq, sc = (torch.from_numpy(t).cuda() for t in quant.quantize_weights(w.numpy(), 4, g))
        x = rand(m, kk)
        want_plan = tuple(e["plan"]) if "plan" in e else None
        route, err, rule = adopt(
            "dequant4", lambda: quant.matmul_quantized(x, wq, sc, bits=4, group_size=g),
            dequant.dequant_matmul, e["route"],
            dequant.dequant_matmul_plain(x, wq, sc, bits=4, group_size=g, out_dtype=x.dtype),
            plan=lambda: dequant.dequant_matmul.last_plan, want_plan=want_plan)
        out["dequant4"] = dict(winner=e, route=route, no_cache_route=rule, err=err, report=rep)
        log(f"phase 26a: autotune_quant int4 g{g} ({m}, {nn}, {kk}) bf16:\n" + tune_report(rep)
            + f"\n  winner {e['route']} {e.get('plan', '')}; matmul_quantized took {route} "
              f"{want_plan or ''} (normwise {err:.2e}); with no cache file {rule} "
              f"{dequant.dequant_matmul.last_plan}")

        m, nn, kk = TUNE["w8a8"]
        e = autotune.autotune_quant(m, nn, kk, mode="w8a8", cache_path=tuned, rounds=rounds)
        rep = autotune._tune_family.last_report
        w = torch.randn(kk, nn, generator=gen) / kk ** 0.5
        wq, sc = (torch.from_numpy(t).cuda() for t in quant.quantize_weights(w.numpy(), 8))
        x = rand(m, kk)
        wcfg = quant.w8a8_resolve(m, nn, kk)
        fused, _, bk = dequant.w8a8_schedule(m, nn, kk, wcfg, 1, True)
        route, err, rule = adopt(
            "w8a8", lambda: quant.matmul_w8a8(x, wq, sc), dequant.w8a8_matmul, e["route"],
            dequant.w8a8_plain(x, wq, sc, bk=bk, fused=fused, out_dtype=torch.float32),
            plan=lambda: dequant.w8a8_matmul.last_plan, want_plan=e.get("plan"))
        out["w8a8"] = dict(winner=e, route=route, no_cache_route=rule, err=err, report=rep)
        log(f"phase 26a: autotune_quant w8a8 ({m}, {nn}, {kk}) bf16:\n" + tune_report(rep)
            + f"\n  winner {e['route']} {e.get('plan', '')}; matmul_w8a8 took {route} "
              f"(normwise {err:.2e}); with no cache file {rule} {dequant.w8a8_matmul.last_plan}")

        m, kk, nn, ng = TUNE["grouped"]
        e = autotune.autotune_grouped(m, kk, nn, ng, cache_path=tuned, rounds=rounds)
        rep = autotune._tune_family.last_report
        lhs, rhs = rand(m, kk), rand(ng, kk, nn, scale=kk ** -0.5)
        sizes = torch.full((ng,), m // ng, dtype=torch.int32, device="cuda")
        route, err, rule = adopt("grouped", lambda: grouped_matmul(lhs, rhs, sizes),
                                 gmm.grouped_mxu, e["route"], gmm.grouped_mxu_plain(lhs, rhs, sizes))
        out["grouped"] = dict(winner=e, route=route, no_cache_route=rule, err=err, report=rep)
        log(f"phase 26a: autotune_grouped ({m}, {kk}, {nn}, {ng}) bf16:\n" + tune_report(rep)
            + f"\n  winner {e['route']}; grouped_matmul took {route} (normwise {err:.2e}); "
              f"with no cache file {rule}")
        out["a s"] = time.perf_counter() - t0
        log(f"phase 26a: {out['a s']:.1f} s; the tuned cache: "
            + json.dumps(json.loads(Path(tuned).read_text())))

        # (c) the calibration into a temporary file.
        t0 = time.perf_counter()
        cal_path = str(tmp / "calibration.json")
        cal = calibrate.run_calibration(cache_path=cal_path, n_probe=TUNE["calibrate"],
                                        autotune_cache=str(tmp / "calibrate_autotune.json"),
                                        force=True)
        kind = torch.cuda.get_device_name(0).lower()
        if calibrate.load_calibration(kind, cal_path) != cal:
            raise AssertionError("phase 26c: the calibration did not persist")
        seeded = autotune._load(str(tmp / "calibrate_autotune.json"))
        out["calibration"] = dict(cal, seeded=seeded)
        out["c s"] = time.perf_counter() - t0
        log(f"phase 26c: run_calibration ({2 * TUNE['calibrate']}^3 bf16 on the engine): "
            f"measured_bf16_flops {cal['measured_bf16_flops'] / 1e12:.1f} TFLOP/s against "
            f"perf_model.H100.peak_flops['bfloat16'] {H100.peak_flops['bfloat16'] / 1e12:.0f} "
            f"({cal['measured_bf16_flops'] / H100.peak_flops['bfloat16'] * 100:.1f}%), "
            f"grid_step_overhead_s {cal['grid_step_overhead_s']}, card {cal['card']!r}; its "
            f"autotune seed {json.dumps(seeded)}; {out['c s']:.1f} s")

        # (e) the shipped seed adopted: no user cache, the packaged seed.
        autotune.DEFAULT_CACHE, autotune.SEED_CACHE = none, seed
        key = autotune._key("h100", "bfloat16", "plus_times", n, n, n)
        entry = autotune._load(seed).get(key)
        if entry is None:
            raise AssertionError(f"phase 26e: the seed has no {key}")
        a, b = rand(n, n), rand(n, n)
        got = matmul(a, b)
        torch.cuda.synchronize()
        if mxu.mxu_matmul.last_route != entry["route"]:
            raise AssertionError(f"phase 26e: matmul took {mxu.mxu_matmul.last_route}, the "
                                 f"seed names {entry['route']}")
        err = held(torch, got, torch.matmul(a, b), "phase 26e")
        out["seed"] = dict(key=key, entry=entry, route=mxu.mxu_matmul.last_route, err=err)
        log(f"phase 26e: with only the packaged seed, matmul(a, b) bf16 {n}^3 took "
            f"{mxu.mxu_matmul.last_route}, the seed's {key}: {json.dumps(entry)} (normwise "
            f"{err:.2e})")
    finally:
        sweeper.join()
        stdout, stderr = fresh.communicate(timeout=300)

    if "exc" in swept:
        raise swept["exc"]
    res = swept["res"]
    statuses = [r.status for r in res]
    if statuses != ["ok", "invalid_config", "vmem_overflow", "crashed"]:
        raise AssertionError(f"phase 26b: statuses {statuses}: "
                             + " | ".join(r.detail for r in res))
    csv_path = tmp / "sweep.csv"
    text = sweep.to_csv(res, str(csv_path))
    merged = sweep.merge_csvs([str(csv_path), str(csv_path)])
    if merged.count("\n") != text.count("\n"):
        raise AssertionError("phase 26b: the CSV merged with itself changed its rows")
    out["sweep"] = dict(statuses=statuses, gflops=res[0].gflops, seconds=res[0].seconds)
    log(f"phase 26b: sweep {TUNE['sweep']}^3 bf16, each configuration in its own process "
        f"({len(grid)} at once, then the crashing setup_code, beside 26a-e): statuses "
        f"{statuses} in {swept['s']:.1f} s; the engine tile {res[0].gflops / 1e3:.1f} "
        f"TFLOP/s verified (max rel {res[0].max_rel_err:.2e}); merged with itself "
        f"{merged.count(chr(10)) - 1} rows\n" + text.rstrip())

    if fresh.returncode != 0:
        raise AssertionError(f"phase 26d: the fresh process failed: {stderr[-2000:]}")
    loaded = json.loads(stdout.strip().splitlines()[-1])
    if not loaded["lib"].startswith(str(target)) or loaded["err"] > 1e-2:
        raise AssertionError(f"phase 26d: {loaded}")
    out["cache"] = dict(loaded, archive_mb=archive.stat().st_size / 1e6, package_s=pack_s,
                        members=members)
    log(f"phase 26d: package {members} ({archive.stat().st_size / 1e6:.1f} MB, "
        f"{pack_s:.1f} s), unpackaged into an empty directory; a fresh process without "
        f"nvcc (beside 26a-e) loaded it in {loaded['load_s']:.3f} s "
        f"({loaded['process_s']:.1f} s with imports and one B1 launch on "
        f"{loaded['route']}, normwise {loaded['err']:.2e})")
    autotune.DEFAULT_CACHE = none
    return out


# ---------------------------------------------------------------------------
# Slice 18: the port's examples on the card, the bias_gelu epilogue, and the
# flash-attention model (models/attn_model.py) against the engine kernels
# ---------------------------------------------------------------------------

# Phase 27c's shapes: (key, batch, S, H_q, H_kv, D, causal).  H_q None: a
# 3-D (batch, S, D) call, batch the heads; else the 4-D (batch, S, H, D)
# layout read in place (GQA).  Phase 15's shapes (the anchors) and, around
# them, 1-67 heads of 1024 rows (one to five rounds of the 132 SMs), S
# 256-16384 at a constant token count, D 64, GQA; full and causal each.
ATTN_MODEL_CASES = tuple(
    [(f"{m} {b}x1024", b, 1024, None, None, 128, m == "causal")
     for b in (4, 8, 16, 17, 24, 32, 33, 48, 64, 66, 67) for m in ("full", "causal")]
    + [(f"{m} {b}x{s}", b, s, None, None, 128, m == "causal")
       for b, s in ((128, 256), (64, 512), (16, 2048), (8, 4096), (4, 8192), (8, 8192),
                    (2, 8192), (1, 16384)) for m in ("full", "causal")]
    + [(f"{m} {b}x{s} D64", b, s, None, None, 64, m == "causal")
       for b, s in ((32, 1024), (64, 1024), (8, 8192), (16, 512)) for m in ("full", "causal")]
    + [(f"{m} GQA {b}x{s} H{hq}/{hkv}", b, s, hq, hkv, 128, m == "causal")
       for b, s, hq, hkv in ((4, 1024, 16, 4), (8, 2048, 32, 8)) for m in ("full", "causal")])


def attn_model_times(torch, cases, rounds=3, iters=10):
    """{key: {"fwd" | "dq" | "dkv": device ms a call}} of the engine flash
    kernels (``csrc/flash_wgmma.cu``, ``csrc/flash_bwd_wgmma.cu``) at
    ``cases``' shapes (``ATTN_MODEL_CASES``' form), bf16, the three kernels
    of a shape timed in turns (``time_turns``); every launch's route checked
    (the engine)."""
    from gemm_hls_tpu_torch.ops import flash
    gen = torch.Generator(device="cuda").manual_seed(271)
    bf16 = torch.bfloat16
    out = {}
    for key, batch, s, hq, hkv, d, causal in cases:
        def rand(shape):
            return torch.randn(shape, generator=gen, device="cuda", dtype=bf16)
        if hq is None:
            q, k, v, do = (rand((batch, s, d)) for _ in range(4))
        else:
            q, do = rand((batch, s, hq, d)), rand((batch, s, hq, d))
            k, v = rand((batch, s, hkv, d)), rand((batch, s, hkv, d))
        sc = d ** -0.5
        o, lse = flash._forward(q, k, v, None, None, None, None, causal, None, None, sc, 512)
        delta = flash._pack((do.float() * o.float()).sum(-1, keepdim=True))[..., 0]
        bargs = (q, k, v, do, lse, delta, None, None, None, causal, None, None, sc, 512)
        fns = {"fwd": lambda: flash._forward(q, k, v, None, None, None, None, causal, None,
                                             None, sc, 512)[0],
               "dq": lambda: flash._backward(*bargs, which="dq"),
               "dkv": lambda: flash._backward(*bargs, which="dkv")}
        out[key] = time_turns(torch, fns, rounds=rounds, iters=iters)
        routes = (flash.flash_mha.last_route, flash.flash_mha_bwd_dq.last_route,
                  flash.flash_mha_bwd_dkv.last_route)
        if set(routes) != {"wgmma"}:
            raise AssertionError(f"attention model shape {key}: routes {routes}")
        del q, k, v, do, o, lse, delta, bargs
    return out


# Phase 27c's model fit and ratios: the anchors (PERF.md section 6, phase
# 15's shapes), full-mask and causal; the GQA prefill is held out (the
# model's signature has no kv-head count).
ATTN_ANCHORS_FULL = ("full 32x1024", "full 32x1024 D64")
ATTN_ANCHORS_CAUSAL = ("causal 32x1024", "causal 8x8192")
ATTN_HELD_OUT = ("causal GQA 4x1024 H16/4",)

# Phase 27a: the kernels each port example (examples/torch/) must launch on
# the card, as every_counter() names them ("B14|B15": either).  02's
# built-in semirings run B3, its custom plus_max B3 through a generated
# functor (slice 22, ops/codegen.py).
EXAMPLE_KERNELS = {
    "01_basic_gemm.py": ("B1",),
    "02_semirings.py": ("B3", "B3 generated"),
    "03_graph_algorithms.py": ("B3",),
    "04_distributed.py": ("B1", "B3"),
    "05_f64_on_bf16.py": ("B1", "B5"),
    "06_training.py": ("B1",),
    "07_differentiable_semirings.py": ("B3",),
    "08_fused_distributed_kernels.py": ("B18", "B19"),
    "09_fp32_frontier.py": ("B1", "B4"),
    "10_transformer_block.py": ("B1 epilogue", "B2"),
    "11_attention_scores.py": ("B2", "B2 row-softmax"),
    "12_flash_attention.py": ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "B2"),
    "13_quantized_inference.py": ("B13", "B14|B15"),
    "14_moe.py": ("B16", "B17"),
    "15_serving_decoder.py": ("B13", "B14|B15", "B16", "flash_fwd"),
}

# Phase 27b: the bias_gelu epilogue on each of B1's routes (B1_ROUTE_CASES'
# form): the engine (bf16 through pitched views, K-major int8), WMMA (rows
# that are not whole 16-byte units, int8 in another layout), the CUDA cores
# (fp32); and on B2's engine (each case again on WMMA through the route
# override).
BIAS_GELU_ROUTE_CASES = (
    ("bfloat16", "bfloat16", False, False, 1000, 1030, 1100, True, "bias_gelu", "wgmma"),
    ("float16", "float32", True, True, 304, 520, 264, False, "bias_gelu", "wgmma"),
    ("int8", "float32", False, True, 300, 520, 272, False, "bias_gelu", "wgmma"),
    ("bfloat16", "float32", False, False, 65, 140, 131, False, "bias_gelu", "wmma"),
    ("int8", "float32", False, False, 300, 520, 272, False, "bias_gelu", "wmma"),
    ("float32", "float32", False, False, 65, 140, 131, False, "bias_gelu", "simt"),
)
BIAS_GELU_B2_CASES = (
    ("bfloat16", "bfloat16", False, True, 5, 300, 1030, 200, True, None, "bias_gelu", "wgmma"),
    ("bfloat16", "float32", True, False, 5, 130, 264, 200, True, "b", "bias_gelu", "wgmma"),
)
BIAS_GELU_REPEATS = 20


def phase_examples(torch):
    """Phase 27a: every port example (examples/torch/) run in this process
    with ``--device cuda``, every launch count set to 0 before each; each
    must launch the kernels EXAMPLE_KERNELS names.  Returns {example:
    (seconds, launches)}."""
    import contextlib
    import importlib.util
    import io
    paths = sorted((REPO / "examples" / "torch").glob("[0-9]*.py"))
    if {p.name for p in paths} != set(EXAMPLE_KERNELS):
        raise AssertionError(f"examples/torch/ holds {[p.name for p in paths]}, the table "
                             f"{sorted(EXAMPLE_KERNELS)}")
    out = {}
    for path in paths:
        spec = importlib.util.spec_from_file_location(f"port_example_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset_every_counter()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launched()
        missing = [k for k in EXAMPLE_KERNELS[path.name]
                   if not any(got.get(name) for name in k.split("|"))]
        log(f"phase 27a: {path.name} in {secs:.2f} s, launches {got}"
            + "".join(f"\n  | {line}" for line in printed.getvalue().splitlines()))
        if missing:
            raise AssertionError(f"{path.name} launched none of {missing} on the card")
        out[path.name] = (secs, got)
    return out


def phase_bias_gelu(torch):
    """Phase 27b: the bias_gelu epilogue against its plain version on every
    B1 route and on B2's (BIAS_GELU_ROUTE_CASES, BIAS_GELU_B2_CASES, the
    routes checked), and BIAS_GELU_REPEATS launches of the engine case with
    the same bits."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    gen = torch.Generator(device="cuda").manual_seed(272)
    worst = max(b1_route_case(torch, gen, c) for c in BIAS_GELU_ROUTE_CASES)
    for case in BIAS_GELU_B2_CASES:
        worst = max(worst, b2_route_case(torch, gen, case),
                    b2_route_case(torch, gen, case, route="wmma"))
    dt, out, ta, tb, m, n, k, pitch, name, route = BIAS_GELU_ROUTE_CASES[0]
    dtype = getattr(torch, dt)
    a = pitched(torch, gen, m, k, dtype, pitch)
    b = pitched(torch, gen, k, n, dtype, pitch)
    bias = signed(torch, (n,), dtype, gen)
    kw = dict(cfg=default_config(dtype, out_dtype=out), epilogue=get_epilogue(name))
    first = mxu.mxu_matmul(a, b, bias, **kw)
    if mxu.mxu_matmul.last_route != route:
        raise AssertionError(f"bias_gelu repeats: route {mxu.mxu_matmul.last_route}")
    for i in range(BIAS_GELU_REPEATS - 1):
        if not torch.equal(first, mxu.mxu_matmul(a, b, bias, **kw)):
            raise AssertionError(f"bias_gelu: launch {i + 2} differs from the first")
    log(f"phase 27b: bias_gelu vs plain on B1's routes "
        f"({sorted({c[-1] for c in BIAS_GELU_ROUTE_CASES})}, {len(BIAS_GELU_ROUTE_CASES)} "
        f"cases) and B2's ({len(BIAS_GELU_B2_CASES)} engine cases, each again on WMMA): ok "
        f"(worst abs err {worst:.3e}); {BIAS_GELU_REPEATS} engine launches: the same bits")


def phase_attn_model(torch):
    """Phase 27c: the engine flash kernels timed in turns at
    ATTN_MODEL_CASES' shapes, each beside ``models/attn_model.py``'s
    prediction and the ratio; then the model refitted to this run's readings
    (every 3-D shape; the GQA ones held out) and the fitted constants
    printed in the table's form.  Returns (times, ratios, fitted entry).

    The kernels are timed in a fresh process (the library already built):
    late in this long process torch.profiler's windows held only part of
    the kernels' device time (a third of it, then none), as phase 25f's
    in-process trace of tools.profile held no kernel."""
    from gemm_hls_tpu_torch.models import attn_model
    from gemm_hls_tpu_torch.models.perf_model import H100
    code = ("import json, sys, torch\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import chip_smoke as cs\n"
            "print(json.dumps(cs.attn_model_times(torch, cs.ATTN_MODEL_CASES)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"phase 27c: the timing process failed:\n{proc.stderr[-3000:]}")
    times = json.loads(proc.stdout.splitlines()[-1])
    empty = [(key, k) for key, t in times.items() for k, ms in t.items() if not ms > 0]
    if empty:
        raise AssertionError(f"phase 27c: no device time read for {empty}")
    readings, ratios = [], {}
    for key, batch, s, hq, hkv, d, causal in ATTN_MODEL_CASES:
        heads = batch * (hq or 1)
        ratios[key] = {}
        for k in ("fwd", "dq", "dkv"):
            pred = attn_model.predict_s(k, heads, s, d, causal, chip=H100) * 1e3
            ratios[key][k] = pred / times[key][k]
            if hq is None:
                readings.append((k, heads, s, d, causal, times[key][k] * 1e-3))
        log(f"phase 27c: {key}: " + ", ".join(
            f"{k} {times[key][k]:.4f} ms (model {ratios[key][k] * times[key][k]:.4f}, "
            f"x{ratios[key][k]:.3f})" for k in ("fwd", "dq", "dkv")))
    fit = attn_model.fit_constants(readings, H100)
    log(f"phase 27c: constants fitted to this run (ENGINE_CONSTANTS['h100'] form): "
        f"{json.dumps(fit)}")
    for group, keys in (("full-mask anchors", ATTN_ANCHORS_FULL),
                        ("causal anchors", ATTN_ANCHORS_CAUSAL),
                        ("held out", ATTN_HELD_OUT)):
        log(f"phase 27c: {group}: " + "; ".join(
            f"{key} " + " ".join(f"{k} x{ratios[key][k]:.3f}" for k in ("fwd", "dq", "dkv"))
            for key in keys))
    inside = all(0.85 < ratios[key][k] < 1.15 for key in ATTN_ANCHORS_FULL
                 for k in ("fwd", "dq", "dkv"))
    log(f"phase 27c: the table within +-15% at every full-mask anchor: {inside}")
    return times, ratios, fit


def phase_slice18(torch):
    """Phase 27: slice 18's examples, the bias_gelu epilogue and the
    attention model, each step timed."""
    t0 = time.perf_counter()
    examples = phase_examples(torch)
    t1 = time.perf_counter()
    phase_bias_gelu(torch)
    t2 = time.perf_counter()
    model = phase_attn_model(torch)
    log(f"phase 27: examples {t1 - t0:.1f} s, bias_gelu {t2 - t1:.1f} s, attention model "
        f"{time.perf_counter() - t2:.1f} s")
    return examples, model


# ---------------------------------------------------------------------------
# Slice 19: the distributed CA-GEMMs on virtual ranks of the card (phase 28)
# ---------------------------------------------------------------------------

# Phase 28's problem sizes: the dense front doors (28a, 28e), the semiring
# calls and APSP (28b), the Ozaki GEMMs (28c), the streamed GEMM and its
# host tile (28d).
DIST_CA = dict(dense=8192, semiring=4096, unaligned=(4097, 4095, 4093), apsp=4096,
               ozaki_int8=8192, ozaki=2048, streamed=16384, streamed_tile=8192)


def virtual_mesh(torch, shape):
    """A mesh of ``shape`` whose ranks all live on the card: (x, y), or
    (z, x, y) for three axes."""
    from gemm_hls_tpu_torch.parallel import make_mesh, mesh_25d
    n = 1
    for s in shape:
        n *= s
    ranks = [torch.device("cuda")] * n
    if len(shape) == 3:
        return mesh_25d(c=shape[0], devices=ranks)
    return make_mesh(shape, devices=ranks)


def ranks_launched(what, front, mesh, kernel, calls, route):
    """The kernels launched since the last reset must be ``kernel`` alone,
    once per rank per local GEMM (``calls`` each), every launch of the front
    door's last call on ``route`` as ``front.last_routes`` recorded it.
    Returns the launches."""
    got = launched()
    ranks = mesh.devices.size
    routes = front.last_routes
    if got != {kernel: ranks * calls}:
        raise AssertionError(f"{what}: launches {got}, want {kernel}: {ranks} ranks x {calls}")
    if len(routes) != ranks or any(set(r) != {route} for r in routes.values()):
        raise AssertionError(f"{what}: routes {routes}, want {route} on each of {ranks} ranks")
    return got


def phase_slice19(torch):
    """Phase 28 (main path): the distributed CA-GEMMs on virtual ranks of the
    card, each call with every launch count and the byte counter set to 0
    just before it and read just after.  (a) bf16 8192^3 through
    ``summa_matmul`` on (2, 4) and (2, 2), ``cannon_matmul`` on (2, 2),
    ``matmul_25d`` on (2, 2, 2) and ``distributed_matmul("auto")``, each held
    to bf16 ``torch.matmul`` of the whole product (relative 1e-2 scaled),
    B1 on the engine once per rank (Cannon: p per rank), then timed in turns
    on CUDA events beside B18 (4 ranks), B19 (p = 2) and ``torch.matmul``,
    and each profiled (device busy share, device time by kernel);
    (e) at those calls each rank's received bytes equal to
    ``models/scaling_model.comm_volume_per_device`` (Cannon's shifts; its
    skew printed apart; 2.5D's reduction in fp32); (b) fp32 min_plus SUMMA
    at 4096^3 on (2, 2), ``distributed_matmul`` at 4097 x 4095 x 4093 with A
    transposed, min_plus, on (2, 4), and APSP at n = 4096 through SUMMA
    min_plus on (2, 2), each equal to the single-card call, B3 once per rank
    per call; (c) ``ozaki_matmul_int8_distributed`` at 8192^3 float64 on
    (2, 2) (normwise < 1e-13, B5 once per rank) and
    ``ozaki_matmul_distributed`` at 2048^3 on (2, 4) (< 5e-14, B1 once per
    rank per slice pair) against float64 ``torch.matmul``; (d)
    ``distributed_streamed_matmul`` at fp32 16384^3 in 8192 tiles, SUMMA on
    (2, 2) and 2.5D on (2, 2, 2), against float64 ``torch.matmul`` on the
    card (max |C - ref| / max |ref| < 1e-4).  Returns {step: launches} and
    28a's times."""
    import functools

    import numpy as np

    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.models import graph
    from gemm_hls_tpu_torch.models.scaling_model import comm_volume_per_device
    from gemm_hls_tpu_torch.ops import cannon, ring
    from gemm_hls_tpu_torch.ops.ozaki import (
        ozaki_matmul_distributed, ozaki_matmul_int8_distributed, slice_plan,
    )
    from gemm_hls_tpu_torch.parallel import (
        cannon_matmul, distributed_matmul, distributed_streamed_matmul, make_mesh,
        matmul_25d, shard_operands_2d, shard_operands_25d, summa_matmul,
    )
    from gemm_hls_tpu_torch.parallel import sharding

    launches, steps = {}, {}

    def run(key, fn):
        reset_every_counter()
        sharding.reset_bytes()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[key] = time.perf_counter() - t0
        return out

    # --- 28a / 28e: the dense front doors at bf16 8192^3 -------------------
    s, bf16 = DIST_CA["dense"], torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(281)
    a, b = dist_operands(torch, gen, (s, s), (s, s), bf16)
    ref = torch.matmul(a, b)
    m24, m22, m222 = (virtual_mesh(torch, sh) for sh in ((2, 4), (2, 2), (2, 2, 2)))
    placed = {"m24": shard_operands_2d(a, b, m24), "m22": shard_operands_2d(a, b, m22),
              "m222": shard_operands_25d(a, b, m222)}
    dense = {
        "summa (2, 4)": (lambda: summa_matmul(*placed["m24"], m24), summa_matmul, m24, 1,
                         "summa", (2, 4)),
        "summa (2, 2)": (lambda: summa_matmul(*placed["m22"], m22), summa_matmul, m22, 1,
                         "summa", (2, 2)),
        "cannon (2, 2)": (lambda: cannon_matmul(*placed["m22"], m22), cannon_matmul, m22, 2,
                          "cannon", (2, 2)),
        "25d (2, 2, 2)": (lambda: matmul_25d(*placed["m222"], m222), matmul_25d, m222, 1,
                          "25d", (2, 2, 2)),
        "auto (2, 2)": (lambda: distributed_matmul(a, b, m22), cannon_matmul, m22, 2,
                        "cannon", (2, 2)),
    }
    comm = {}
    for key, (fn, front, mesh, calls, alg, shape) in dense.items():
        c = run(f"28a {key}", fn)
        launches[f"28a {key}"] = ranks_launched(key, front, mesh, "B1", calls, "wgmma")
        err = compare(torch, c.full(), ref, BF16_RTOL, f"28a {key}", scaled=True)[0]
        del c
        want = comm_volume_per_device(alg, s, s, s, shape, 2)
        tags = ["ppermute"] if alg == "cannon" else None
        got = sharding.bytes_received(mesh, tags)
        skew = sharding.bytes_received(mesh, ["skew"]) if alg == "cannon" else None
        comm[key] = dict(bytes_per_rank=got.reshape(-1).tolist(), model=want,
                         skew=None if skew is None else skew.reshape(-1).tolist())
        log(f"phase 28a: {key} bf16 {s}^3: {steps[f'28a {key}']:.3f} s host clock (first "
            f"call), B1 x{launches[f'28a {key}']['B1']} on wgmma, max abs err {err:.3e} vs bf16 "
            f"torch.matmul\nphase 28e: {key} bytes received per rank {comm[key]['bytes_per_rank']}"
            f" vs comm_volume_per_device {want}"
            + (f"; skew (not in the model) {comm[key]['skew']}" if skew is not None else ""))
        if not (got == want).all():
            raise AssertionError(f"28e {key}: bytes {got.tolist()} differ from the model's {want}")
    del ref
    ring_mesh = make_mesh((4,), ("x",), devices=[torch.device("cuda")] * 4)
    a_r, b_r = ring.shard_operands_ring(a, b, ring_mesh)
    ring_scratch = ring.ring_scratch(4, s, s // 4, bf16, "cuda")
    ab, bb = cannon.cannon_blocks(a, b, 2)
    ab, bb = [t.contiguous() for t in ab], [t.contiguous() for t in bb]
    cannon_scratch = cannon.cannon_scratch(2, s // 2, s // 2, s // 2, bf16, "cuda")
    # time_fn takes tensors: each rank's result tensor.
    fns = {key: lambda fn=v[0]: list(fn().shards.flat) for key, v in dense.items()}
    fns.update({"B18 ring 4 ranks": lambda: ring.ring_gemm(a_r, b_r, scratch=ring_scratch),
                "B19 fused Cannon p=2": lambda: cannon.cannon_gemm(ab, bb, 2,
                                                                   scratch=cannon_scratch),
                "torch.matmul": lambda: torch.matmul(a, b)})
    times = event_turns(torch, fns)
    log("phase 28a: bf16 8192^3 on CUDA events in turns (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    profiles = {}
    for key in dense:
        busy, kernels = device_profile(torch, fns[key], 3)
        profiles[key] = dict(busy=busy, kernels=kernels[:5])
        log(f"phase 28a: {key} profile: device busy {busy:.1%} of the host clock; by kernel "
            f"(us a call): " + "; ".join(f"{name[:60]} {us:.1f}" for name, us in kernels[:5]))
    del a, b, placed, a_r, b_r, ring_scratch, ab, bb, cannon_scratch, fns

    # --- 28b: the other semirings, exact ----------------------------------
    n4 = DIST_CA["semiring"]
    x, y = dist_operands(torch, gen, (n4, n4), (n4, n4), torch.float32)
    c = run("28b summa min_plus", lambda: summa_matmul(x, y, m22, semiring="min_plus"))
    launches["28b summa min_plus"] = ranks_launched("summa min_plus", summa_matmul, m22, "B3",
                                                    1, "semiring_gemm")
    compare(torch, c.full(), matmul(x, y, semiring="min_plus"), 0.0, "28b summa min_plus")
    m, n, k = DIST_CA["unaligned"]
    xt, yt = dist_operands(torch, gen, (k, m), (k, n), torch.float32)
    c = run("28b distributed_matmul", lambda: distributed_matmul(
        xt, yt, m24, semiring="min_plus", transpose_a=True))
    launches["28b distributed_matmul"] = ranks_launched(
        "distributed_matmul", summa_matmul, m24, "B3", 1, "semiring_gemm")
    if c.shape != (m, n) or tuple(c.spec) != ():
        raise AssertionError(f"28b distributed_matmul: {c.shape}, spec {c.spec}")
    compare(torch, c.full(), matmul(xt, yt, semiring="min_plus", transpose_a=True), 0.0,
            "28b distributed_matmul unaligned")
    del x, y, xt, yt, c
    na = DIST_CA["apsp"]
    w = torch.randint(1, 10, (na, na), generator=gen, device="cuda").float()
    adj = torch.where(torch.rand((na, na), generator=gen, device="cuda") < 0.002, w,
                      torch.full_like(w, float("inf")))
    dist = run("28b APSP", lambda: graph.all_pairs_shortest_paths(
        adj, matmul_fn=functools.partial(summa_matmul, mesh=m22, semiring="min_plus")))
    squarings = max(1, int(np.ceil(np.log2(na - 1))))
    launches["28b APSP"] = ranks_launched("APSP", summa_matmul, m22, "B3", squarings,
                                          "semiring_gemm")
    single = graph.all_pairs_shortest_paths(adj)
    compare(torch, dist.full(), single, 0.0, "28b APSP vs single-card APSP")
    reach = int(torch.isfinite(single).sum())
    del w, adj, dist, single
    log(f"phase 28b: summa min_plus fp32 {n4}^3 (2, 2) {steps['28b summa min_plus']:.3f} s; "
        f"distributed_matmul min_plus {m}x{n}x{k} A transposed (2, 4) "
        f"{steps['28b distributed_matmul']:.3f} s; APSP n={na} via SUMMA (2, 2), {squarings} "
        f"squarings, {reach} reachable pairs, {steps['28b APSP']:.3f} s: each equal to the "
        f"single-card call, B3 once per rank per call")

    # --- 28c: the Ozaki GEMMs against float64 torch.matmul ------------------
    rng = np.random.default_rng(283)
    n8 = DIST_CA["ozaki_int8"]
    a64, b64 = rng.uniform(-5, 5, (n8, n8)), rng.uniform(-5, 5, (n8, n8))
    got = run("28c ozaki int8", lambda: ozaki_matmul_int8_distributed(a64, b64, m22))
    launches["28c ozaki int8"] = launched()
    err8 = normwise(torch, torch.from_numpy(got).cuda(), torch.from_numpy(a64).cuda(),
                    torch.from_numpy(b64).cuda())[0]
    if launches["28c ozaki int8"] != {"B5": 4} or not err8 < 1e-13:
        raise AssertionError(f"28c int8 Ozaki: launches {launches['28c ozaki int8']}, "
                             f"normwise {err8:.3e}")
    n2 = DIST_CA["ozaki"]
    a64, b64 = rng.uniform(-5, 5, (n2, n2)), rng.uniform(-5, 5, (n2, n2))
    got = run("28c ozaki bf16", lambda: ozaki_matmul_distributed(a64, b64, m24))
    _, ns = slice_plan(n2)
    pairs = sum(1 for sd in range(ns + 1) for i in range(sd + 1) if i < ns and sd - i < ns)
    launches["28c ozaki bf16"] = ranks_launched("ozaki_matmul_distributed",
                                                ozaki_matmul_distributed, m24, "B1", pairs,
                                                "wgmma")
    errb = normwise(torch, torch.from_numpy(got).cuda(), torch.from_numpy(a64).cuda(),
                    torch.from_numpy(b64).cuda())[0]
    if not errb < 5e-14:
        raise AssertionError(f"28c Ozaki bf16 slices: normwise {errb:.3e}")
    del a64, b64, got
    log(f"phase 28c: ozaki_matmul_int8_distributed f64 {n8}^3 (2, 2): normwise {err8:.3e}, "
        f"B5 x4, {steps['28c ozaki int8']:.3f} s; ozaki_matmul_distributed f64 {n2}^3 (2, 4): "
        f"normwise {errb:.3e}, {pairs} slice pairs, B1 x{launches['28c ozaki bf16']['B1']}, "
        f"{steps['28c ozaki bf16']:.3f} s")

    # --- 28d: the streamed GEMM over the ranks ------------------------------
    ns_, tile = DIST_CA["streamed"], DIST_CA["streamed_tile"]
    ad, bd = dist_operands(torch, gen, (ns_, ns_), (ns_, ns_), torch.float32)
    ah, bh = ad.cpu(), bd.cpu()
    ref = torch.matmul(ad.double(), bd.double())
    del ad, bd
    jobs = (ns_ // tile) ** 3
    for key, mesh, alg in (("summa (2, 2)", m22, "summa"), ("25d (2, 2, 2)", m222, "25d")):
        step = f"28d streamed {key}"
        out = run(step, lambda mesh=mesh, alg=alg: distributed_streamed_matmul(
            ah, bh, mesh, tile_m=tile, tile_n=tile, tile_k=tile, algorithm=alg))
        launches[step] = launched()
        if launches[step] != {"B1": jobs * mesh.devices.size}:
            raise AssertionError(f"{step}: launches {launches[step]}, want B1 x "
                                 f"{jobs * mesh.devices.size}")
        # Every panel's product on every rank on B1's CUDA-core route (fp32).
        stats = distributed_streamed_matmul.last_stats
        if (stats["jobs"] != jobs or len(stats["routes"]) != jobs
                or any(len(r) != mesh.devices.size or any(v != ["simt"] for v in r.values())
                       for r in stats["routes"])):
            raise AssertionError(f"{step}: last_stats {stats['jobs']} jobs, routes "
                                 f"{stats['routes'][:2]}")
        rel = float((out.cuda().double() - ref).abs().max() / ref.abs().max())
        if out.shape != (ns_, ns_) or not rel < F32_RTOL:
            raise AssertionError(f"{step}: rel err {rel:.3e}")
        log(f"phase 28d: distributed_streamed_matmul {alg} fp32 {ns_}^3, tiles {tile} "
            f"({jobs} panel products) on {key}: {steps[step]:.3f} s, max |C - ref| / max |ref| "
            f"{rel:.3e} vs float64 torch.matmul, B1 x{launches[step]['B1']} on simt; staged "
            f"through {stats['slots']} pinned slots (prefetch {stats['prefetch']}), "
            f"{stats['h2d_bytes']} B host -> card, {stats['d2h_bytes']} B back, host fill "
            f"{stats['fill_s']:.3f} s, wait {stats['stage_wait_s']:.3f} s, drain "
            f"{stats['drain_s']:.3f} s")
        del out
    del ah, bh, ref
    log(f"phase 28: launches {launches}")
    return {"launches": launches, "times": times, "comm": comm, "steps": steps,
            "profiles": profiles}



# ---------------------------------------------------------------------------
# Slice 20: training parallelism on virtual ranks of the card (phase 29)
# ---------------------------------------------------------------------------

# Phase 29's sizes: (a) the ring at B.H 16, S 32768, D 128 over 8 ranks; (b)
# decode over 4 ranks of a 64-sequence cache of 4096 slots (16 q heads over 4
# kv heads); (c) the trainer's width on (dp 2, tp 4); (d) serving_bench's
# MoE width; (e) 4 stages of the trainer's block, 8 microbatches.
PAR = dict(ring=dict(heads=16, kv_heads=4, seq=32768, d=128, ranks=8, window=4096),
           decode=dict(seqs=64, slots=4096, q_heads=16, kv_heads=4, d=128, ranks=4,
                       window=1024, lengths=(4, 1000, 1024, 1025, 3000, 4096)),
           mlp=dict(dims=(4096, 16384, 4096), tokens=8192, mesh=(2, 4), steps=3, lr=0.1),
           moe=dict(d_model=2048, d_ff=4096, experts=8, top_k=2, tokens=4096, capacity=4.0),
           pipe=dict(stages=4, d_model=4096, d_ffn=16384, batch=8192, microbatches=8,
                     lr=0.1))
# Normwise |x - ref| / |ref| bounds against the single-card call: the ring's
# and decode's outputs within twice the flash kernels' known 0.9e-3-2.3e-3
# from plain (PERF.md section 7; P's bf16 rounding): each side rounds P
# against its own running max, a shard's or the whole row's, and its output
# to bf16 once; gradients and the sharded steps' bf16 results within bf16's
# 1e-2 (each ring step's dq, dk, dv leave the kernels rounded to bf16 before
# the fp32 sums; a psum adds bf16 partials).
PAR_FWD_TOL, PAR_BF16_TOL = 5e-3, 1e-2


class EntryLog:
    """Every call into the kernel library, counted by entry point, which
    names the kernel's route (``mxu_wgmma``, ``flash_wgmma``,
    ``flash_bwd_dq_wgmma``, ``grouped_wgmma``, ...): inside ``with
    EntryLog()`` every wrapper reaches the library through a counting proxy
    (they all call ``_build.library()`` at launch)."""

    def __init__(self):
        import collections
        self.calls = collections.Counter()

    def __enter__(self):
        from gemm_hls_tpu_torch import _build
        lib, calls = _build.library(), self.calls

        class Counting:
            def __getattr__(self, name):
                fn = getattr(lib, name)

                def counted(*args):
                    calls[name] += 1
                    return fn(*args)
                return counted

        proxy = Counting()
        self._build, self._library = _build, _build.library
        _build.library = lambda: proxy
        return self

    def __exit__(self, *exc):
        self._build.library = self._library
        return False


def par_step(torch, record, key, fn):
    """``fn()`` with every launch count, the byte counter and an EntryLog set
    to 0 just before it, read just after: record[key] holds its host seconds,
    launches, library entries and the bytes each rank received by tag."""
    from gemm_hls_tpu_torch.parallel import sharding
    reset_every_counter()
    sharding.reset_bytes()
    with EntryLog() as entries:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    record[key] = dict(seconds=secs, launches=launched(), entries=dict(entries.calls),
                       bytes={tag: dict(v) for tag, v in sharding.BYTES.items()})
    return out


def rel_norm(got, ref):
    got, ref = got.detach().double(), ref.detach().double()
    return float((got - ref).norm() / ref.norm())


def within(what, err, tol):
    if not err < tol:
        raise AssertionError(f"{what}: normwise {err:.3e} >= {tol:g}")
    return err


def expect(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: {got}, want {want}")


def rank_bytes(record, key, mesh, tag, want):
    """Each rank of ``mesh`` received ``want`` bytes under ``tag`` in
    record[key]'s run."""
    got = record[key]["bytes"].get(tag, {})
    expect(f"{key} {tag} bytes", {c: got.get(c, 0) for c in mesh.coords()},
           {c: want for c in mesh.coords()})
    return want


def cuda_mesh(shape, names):
    import torch
    from gemm_hls_tpu_torch.parallel import make_mesh
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, names, devices=[torch.device("cuda")] * n)


def ring_inputs(torch):
    c = PAR["ring"]
    gen = torch.Generator(device="cuda").manual_seed(291)
    full = [signed(torch, (c["heads"], c["seq"], c["d"]), torch.bfloat16, gen) for _ in range(3)]
    gqa = [signed(torch, (c["kv_heads"], c["seq"], c["d"]), torch.bfloat16, gen)
           for _ in range(2)]
    return full, gqa


def ring_launches(n, s_loc, causal=False, zigzag=False, window=None):
    """Flash calls of one ring, by the schedule's own rule: every (rank,
    shard) pair, causal the past and diagonal shards, with a window those
    not wholly older than every query's window; zigzag 3 + 2 (n - 1) a
    rank."""
    if zigzag:
        return n * (2 * n + 1)
    count = 0
    for my in range(n):
        for shard in range(n):
            if causal and shard > my:
                continue
            if window is not None and (shard + 1) * s_loc <= my * s_loc - window + 1:
                continue
            count += 1
    return count


def ring_rank_checks(torch, qs, k, v, mesh, window, my=5):
    """Rank ``my``'s step calls of the causal window ring at the main path's
    shape (S_loc rows, the window's offsets), held to the plain versions on
    the same inputs: at its two live steps (the diagonal shard and the one
    before it) the forward storing fp32 o, which rounded to bf16 must equal
    the bf16 launch bit for bit, and the backward pair fed the ring's global
    lse and a random dO.  Launches here are comparisons: they come after the
    counted run.  Returns the largest abs error of each output."""
    from gemm_hls_tpu_torch.ops import flash
    from gemm_hls_tpu_torch.parallel import P, device_put
    from gemm_hls_tpu_torch.parallel.ring_attention import _Plain
    n = mesh.shape["x"]
    s_loc = qs.shape[1] // n
    ring = _Plain(mesh, "x", True, window, None, None, None, None, 512, 2048, None)
    q_sh, k_sh, v_sh = (device_put(x, mesh, P(None, "x", None)).shards for x in (qs, k, v))
    with torch.no_grad():
        o, lse = ring.forward(q_sh, k_sh, v_sh)
    c = (my,)
    qc, lse_c = q_sh[c], lse[c][..., 0]
    do = signed(torch, qc.shape, qc.dtype, torch.Generator(device="cuda").manual_seed(298))
    delta = (do.float() * o[c].float()).sum(-1)
    rtol, errs = flash_rtol(torch, qc.dtype), {}
    for t in (0, 1):
        (_, _, causal, offsets, _), = ring._calls(c, t, s_loc, s_loc, qc.device)
        shard = ((my - t) % n,)
        kc, vc, what = k_sh[shard], v_sh[shard], f"29a rank {my} step {t}"
        kw = dict(causal=causal, window=window, scale=1.0)
        o32, l32 = flash.flash_mha(qc, kc, vc, offsets=offsets, save_lse=True,
                                   out_dtype=torch.float32, **kw)
        expect(f"{what} forward route", flash.flash_mha.last_route, "wgmma")
        o16, l16 = flash.flash_mha(qc, kc, vc, offsets=offsets, save_lse=True, **kw)
        if not (torch.equal(o32.to(qc.dtype), o16) and torch.equal(l32, l16)):
            raise AssertionError(f"{what}: the fp32 o rounded differs from the bf16 launch")
        ro, rl = flash.flash_fwd_plain(qc, kc, vc, None, None, None, offsets,
                                       out_dtype=torch.float32, **kw)
        errs[f"step {t} o"] = compare(torch, o32, ro, rtol, f"{what} o", scaled=True)[0]
        compare(torch, l32[..., 0], rl, F32_RTOL, f"{what} lse", scaled=True)
        args = (qc, kc, vc, do, lse_c, delta)
        got = [flash.flash_mha_bwd_dq(*args, offsets=offsets, **kw),
               *flash.flash_mha_bwd_dkv(*args, offsets=offsets, **kw)]
        expect(f"{what} backward routes", (flash.flash_mha_bwd_dq.last_route,
                                           flash.flash_mha_bwd_dkv.last_route),
               ("wgmma", "wgmma"))
        want = [flash.flash_bwd_dq_plain(*args, None, None, offsets, **kw),
                *flash.flash_bwd_dkv_plain(*args, None, None, offsets, **kw)]
        for name, g, r in zip(("dq", "dk", "dv"), got, want):
            errs[f"step {t} {name}"] = compare(torch, g, r, rtol, f"{what} {name}",
                                               scaled=True)[0]
    return errs


def phase_ring(torch, record, times):
    """Phase 29a: ring_flash_attention on 8 virtual ranks, each run held to
    the single-card flash_mha on the same pre-scaled q; one rank's step
    calls of the window ring held to the plain versions (ring_rank_checks);
    the causal and zigzag gradients to flash_mha_diff's."""
    from gemm_hls_tpu_torch.ops.flash import flash_mha, flash_mha_diff
    from gemm_hls_tpu_torch.parallel import ring_flash_attention
    from gemm_hls_tpu_torch.parallel.ring_attention import BWD_TAG, FWD_TAG
    c = PAR["ring"]
    n, s_loc, d = c["ranks"], c["seq"] // c["ranks"], c["d"]
    mesh = cuda_mesh((n,), ("x",))
    (q, k, v), (kg, vg) = ring_inputs(torch)
    sc = torch.tensor(d ** -0.5, dtype=torch.bfloat16, device="cuda")
    qs = q * sc  # the ring's pre-scaled q (JAX's (q * scale).astype(q.dtype))
    runs = {"full": (k, v, {}),
            "causal": (k, v, {"causal": True}),
            "zigzag causal": (k, v, {"causal": True, "zigzag": True}),
            f"causal window {c['window']}": (k, v, {"causal": True, "window": c["window"]}),
            f"GQA {c['heads']}/{c['kv_heads']} causal": (kg, vg, {"causal": True})}
    for name, (kk, vv, opts) in runs.items():
        key = f"29a {name}"
        o = par_step(torch, record, key, lambda: ring_flash_attention(q, kk, vv, mesh, **opts)
                     .full())
        single = {o2: opts[o2] for o2 in ("causal", "window") if o2 in opts}
        ref = flash_mha(qs, kk, vv, **single)
        err = within(key, rel_norm(o, ref), PAR_FWD_TOL)
        want = ring_launches(n, s_loc, opts.get("causal", False), opts.get("zigzag", False),
                             opts.get("window"))
        expect(f"{key} launches", record[key]["launches"], {"flash_fwd": want})
        expect(f"{key} routes", record[key]["entries"], {"flash_wgmma": want})
        shard = kk.shape[0] * s_loc * d * 2
        rank_bytes(record, key, mesh, FWD_TAG, (n - 1) * 2 * shard)
        record[key]["normwise"] = err
        times[key] = event_turns(torch, {
            "ring": lambda kk=kk, vv=vv, opts=opts: ring_flash_attention(
                q, kk, vv, mesh, **opts).shards.tolist(),
            "single-card flash_mha": lambda kk=kk, vv=vv, single=single: flash_mha(
                qs, kk, vv, **single)}, rounds=3, iters=1)
        log(f"phase 29a: ring {name} bf16 {c['heads']}x{c['seq']}x{d} over {n} ranks: normwise "
            f"{err:.3e} vs single-card flash_mha, flash_fwd x{want} on wgmma, "
            f"{(n - 1) * 2 * shard} B received a rank; {record[key]['seconds']:.3f} s first "
            f"call; in turns (ms): " + ", ".join(f"{a} {b:.3f}" for a, b in times[key].items()))
    del o, ref
    errs = ring_rank_checks(torch, qs, k, v, mesh, c["window"])
    record["29a rank steps"] = errs
    log(f"phase 29a: rank 5's calls of the window ring (S_loc {s_loc}, offsets) vs the plain "
        f"versions, fp32 o rounded equal to the bf16 launch; max abs err "
        + ", ".join(f"{a} {b:.3e}" for a, b in errs.items()))
    gen = torch.Generator(device="cuda").manual_seed(292)
    do = signed(torch, q.shape, torch.bfloat16, gen)
    for name, zz in (("causal", False), ("zigzag causal", True)):
        key = f"29a {name} gradient"
        xs = [t.detach().requires_grad_() for t in (q, k, v)]

        def ring_grads(xs=xs, zz=zz):
            o = ring_flash_attention(*xs, mesh, causal=True, zigzag=zz).full()
            return torch.autograd.grad(o, xs, do)

        def single_grads(xs=xs):
            o = flash_mha_diff(xs[0] * sc, xs[1], xs[2], causal=True)
            return torch.autograd.grad(o, xs, do)

        got = par_step(torch, record, key, ring_grads)
        want = single_grads()
        errs = [within(f"{key} {w}", rel_norm(a, b), PAR_BF16_TOL)
                for w, a, b in zip(("dq", "dk", "dv"), got, want)]
        m = ring_launches(n, s_loc, True, zz)
        expect(f"{key} launches", record[key]["launches"],
               {"flash_fwd": m, "flash_bwd_dq": m, "flash_bwd_dkv": m})
        expect(f"{key} routes", record[key]["entries"],
               {"flash_wgmma": m, "flash_bwd_dq_wgmma": m, "flash_bwd_dkv_wgmma": m})
        shard = c["heads"] * s_loc * d * 2
        rank_bytes(record, key, mesh, FWD_TAG, (n - 1) * 2 * shard)
        rank_bytes(record, key, mesh, BWD_TAG, (n - 1) * 2 * shard + n * 2 * 2 * shard)
        record[key]["normwise"] = errs
        times[key] = event_turns(torch, {"ring": ring_grads, "single-card flash_mha_diff":
                                         single_grads}, rounds=3, iters=1)
        log(f"phase 29a: ring {name} gradient: dq / dk / dv normwise "
            f"{' / '.join(f'{e:.3e}' for e in errs)} vs flash_mha_diff, flash_fwd / dq / dkv "
            f"x{m} each on wgmma, backward bytes a rank "
            f"{(n - 1) * 2 * shard + n * 4 * shard}; in turns (ms): "
            + ", ".join(f"{a} {b:.3f}" for a, b in times[key].items()))
        del got, want, xs


def phase_ring_decode(torch, record):
    """Phase 29b: ring_decode_attention over 4 ranks of a ragged 64-sequence
    cache (lengths leaving whole shards past the end), GQA, S_q 1 and 4, with
    and without a window, each held to the single-card flash_mha(kv_lengths,
    causal=True); then one shard's call with lengths past both ends of it
    against the plain version on the card (the mma.sync route)."""
    from gemm_hls_tpu_torch.ops import flash
    from gemm_hls_tpu_torch.parallel import ring_decode_attention
    from gemm_hls_tpu_torch.parallel.ring_attention import DECODE_TAG
    c = PAR["decode"]
    n, nb, d, slots = c["ranks"], c["seqs"], c["d"], c["slots"]
    b_kv, b_q, s_loc = nb * c["kv_heads"], nb * c["q_heads"], c["slots"] // c["ranks"]
    mesh = cuda_mesh((n,), ("x",))
    gen = torch.Generator(device="cuda").manual_seed(293)
    kc, vc = (signed(torch, (b_kv, slots, d), torch.bfloat16, gen) for _ in range(2))
    lens = torch.randint(4, slots + 1, (nb,), generator=gen, device="cuda")
    lens[:len(c["lengths"])] = torch.tensor(c["lengths"], device="cuda")
    kvl = lens.repeat_interleave(c["kv_heads"]).to(torch.int32)
    sc = torch.tensor(d ** -0.5, dtype=torch.bfloat16, device="cuda")
    for s_q in (1, 4):
        qd = signed(torch, (b_q, s_q, d), torch.bfloat16, gen)
        for window in (None, c["window"]):
            key = f"29b decode S_q {s_q} window {window}"
            o = par_step(torch, record, key, lambda: ring_decode_attention(
                qd, kc, vc, kvl, mesh, window=window).full())
            ref = flash.flash_mha(qd * sc, kc, vc, kv_lengths=kvl, causal=True, window=window)
            err = within(key, rel_norm(o, ref), PAR_FWD_TOL)
            expect(f"{key} launches", record[key]["launches"], {"flash_fwd": n})
            expect(f"{key} routes", record[key]["entries"], {"flash_fwd": n})
            rank_bytes(record, key, mesh, DECODE_TAG, (n - 1) * (b_q * s_q * d + b_q * s_q) * 4)
            record[key]["normwise"] = err
            log(f"phase 29b: {key}: normwise {err:.3e} vs single-card flash_mha, flash_fwd "
                f"x{n} on mma.sync, {record[key]['seconds'] * 1e3:.3f} ms first call")
    # Both ends of a shard: shard 2's lengths re-anchored, some <= 0, some > S_loc.
    qd = signed(torch, (b_q, 4, d), torch.bfloat16, gen)
    len_eff = (kvl - 2 * s_loc).to(torch.int32)
    if not (bool((len_eff <= 0).any()) and bool((len_eff > s_loc).any())):
        raise AssertionError("29b: the shard's lengths do not reach past both of its ends")
    ks, vs = kc[:, 2 * s_loc:3 * s_loc], vc[:, 2 * s_loc:3 * s_loc]
    o, lse = flash.flash_mha(qd, ks, vs, kv_lengths=len_eff, causal=True, save_lse=True,
                             out_dtype=torch.float32)
    expect("29b shard route", flash.flash_mha.last_route, "mma.sync")
    ro, rlse = flash.flash_fwd_plain(qd, ks, vs, len_eff, causal=True, out_dtype=torch.float32)
    err = compare(torch, o, ro, BF16_RTOL, "29b shard past both ends o", scaled=True)[0]
    compare(torch, lse[..., 0], rlse, F32_RTOL, "29b shard past both ends lse", scaled=True)
    log(f"phase 29b: one shard's call with lengths -> {int(len_eff.min())} .. "
        f"{int(len_eff.max())} (S_loc {s_loc}) on mma.sync vs the plain version: max abs err "
        f"{err:.3e}, lse -inf on the same {int(torch.isinf(rlse).sum())} rows")


def mlp_inputs(torch):
    from gemm_hls_tpu_torch.models import mlp
    c = PAR["mlp"]
    gen = torch.Generator(device="cuda").manual_seed(294)
    params = mlp.init_params(gen, c["dims"], torch.bfloat16)
    batch = mlp.make_batch(gen, c["tokens"], c["dims"][0], c["dims"][-1], torch.bfloat16)
    return params, batch


def phase_mlp_sharded(torch, record, times):
    """Phase 29c: the sharded MLP step (dp 2, tp 4) at the trainer's width,
    three steps, each loss and the params after them held to the unsharded
    train_step from the same weights; B1 on the engine; the tp and dp psum
    bytes each rank received."""
    from gemm_hls_tpu_torch.models import mlp
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.parallel import device_put
    c = PAR["mlp"]
    (din, dh, dout), dp, tp = c["dims"], c["mesh"][0], c["mesh"][1]
    mesh = cuda_mesh(c["mesh"], ("dp", "tp"))
    params, batch = mlp_inputs(torch)
    sharded = mlp.shard_params(params, mesh)
    sb = tuple(device_put(t, mesh, mlp.batch_sharding(mesh)) for t in batch)
    ref, losses = params, []
    for step in range(c["steps"]):
        key = f"29c step {step}"
        sharded, loss = par_step(torch, record, key,
                                 lambda p=sharded: mlp.train_step(p, sb, lr=c["lr"]))
        ref, ref_loss = mlp.train_step(ref, batch, lr=c["lr"])
        losses.append((float(loss), float(ref_loss)))
        if not abs(losses[-1][0] - losses[-1][1]) <= BF16_RTOL * abs(losses[-1][1]):
            raise AssertionError(f"{key}: loss {losses[-1]}")
        # A rank's forward: two bf16 GEMMs on the engine; its backward dW0,
        # dh and dW1 (x takes no gradient) in fp32, the cotangent's type
        # (ops/matmul.py::_mxu_bwd, JAX's dot), on B1's CUDA-core route.
        ranks = dp * tp
        expect(f"{key} launches", record[key]["launches"], {"B1": 5 * ranks})
        expect(f"{key} routes", record[key]["entries"],
               {"mxu_wgmma": 2 * ranks, "mxu_gemm": 3 * ranks})
        expect(f"{key} backward route", mxu.mxu_matmul.last_route, "simt")
        partial = c["tokens"] // dp * dout * 2
        rank_bytes(record, key, mesh, "tp_psum", 2 * (tp - 1) * partial // tp)
        rank_bytes(record, key, mesh, "tp_psum_bwd", 2 * (tp - 1) * partial // tp)
        over_dp = (din * dh // tp + dh // tp + dh // tp * dout) * 2
        rank_bytes(record, key, mesh, "grad_psum",
                   2 * (dp - 1) * over_dp // dp + 2 * (dp * tp - 1) * dout * 2 // (dp * tp))
    errs = []
    for (w, b), (rw, rb) in zip(sharded, ref):
        errs += [within("29c params", rel_norm(w.full(), rw), PAR_BF16_TOL),
                 within("29c params", rel_norm(b.full(), rb), PAR_BF16_TOL)]
    record["29c"] = dict(losses=losses, param_normwise=errs)
    times["29c"] = event_turns(torch, {
        "sharded step": lambda: mlp.train_step(sharded, sb, lr=c["lr"])[1],
        "single-card step": lambda: mlp.train_step(ref, batch, lr=c["lr"])[1]},
        rounds=3, iters=1)
    key = "29c step 0"
    log(f"phase 29c: sharded MLP step {c['dims']} x {c['tokens']} bf16 tokens on (dp {dp}, tp "
        f"{tp}): losses (sharded, single-card) {losses}, params normwise max {max(errs):.3e}; "
        f"B1 x{record[key]['launches'].get('B1')} a step (the forward's on wgmma, the "
        f"backward's fp32 on simt); bytes a rank: tp psum "
        f"{record[key]['bytes']['tp_psum'][(0, 0)]} each way, grad psum "
        f"{record[key]['bytes']['grad_psum'][(0, 0)]}; in turns (ms): "
        + ", ".join(f"{a} {b:.3f}" for a, b in times["29c"].items()))


def moe_inputs(torch):
    """MoE params and tokens at PAR's width; tokens whose 2nd and 3rd router
    logits lie within 1e-3 redrawn (a rank's router GEMM over its own rows
    may round an exact near-tie the other way, as the CPU tests' seeds
    assert none)."""
    from gemm_hls_tpu_torch.models.moe import MoEConfig, init_moe_params
    c = PAR["moe"]
    cfg = MoEConfig(d_model=c["d_model"], d_ff=c["d_ff"], num_experts=c["experts"],
                    top_k=c["top_k"], dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(295)
    params = init_moe_params(gen, cfg)
    x = signed(torch, (c["tokens"], c["d_model"]), torch.bfloat16, gen)
    for _ in range(10):
        logits = (x.double() @ params["router"].double()).sort(-1, descending=True)[0]
        close = (logits[:, c["top_k"] - 1] - logits[:, c["top_k"]]) < 1e-3
        if not bool(close.any()):
            break
        x[close] = signed(torch, (int(close.sum()), c["d_model"]), torch.bfloat16, gen)
    return cfg, params, x


def ep_rank_calls(torch, fn):
    """The first B16 forward, B16 dlhs and B17 call that ``fn()`` makes (the
    first rank's: in an EP form most of its slots sort into the zero tail),
    their operands copied as given, each then held to its plain version on
    them; the rows past the groups exactly zero.  Launches here are
    comparisons: they come after the counted run.  Returns, per call, (the
    largest abs error, the share of rows in the zero tail)."""
    from gemm_hls_tpu_torch.ops import gmm, grouped
    seen = {}

    def recorder(name, wrapped):
        def call(lhs, rhs, sizes, **kw):
            key = name if name == "B17" else ("B16 dlhs" if kw.get("transpose_rhs") else "B16")
            if key not in seen:
                seen[key] = (lhs.detach().clone(), rhs.detach().clone(), sizes.clone(), kw)
            return wrapped(lhs, rhs, sizes, **kw)
        return call

    saved = grouped.grouped_mxu, grouped.grouped_update_mxu
    grouped.grouped_mxu = recorder("B16", saved[0])
    grouped.grouped_update_mxu = recorder("B17", saved[1])
    try:
        fn()
    finally:
        grouped.grouped_mxu, grouped.grouped_update_mxu = saved
    expect("ep rank calls", sorted(seen), ["B16", "B16 dlhs", "B17"])
    out = {}
    for key, (lhs, rhs, sizes, kw) in seen.items():
        m, used = lhs.shape[0], int(gmm.group_ends(sizes, lhs.shape[0])[-1])
        if key == "B17":
            kw = dict(num_groups=kw["num_groups"], out_dtype=kw.get("out_dtype"))
            got = gmm.grouped_update_mxu(lhs, rhs, sizes, **kw)
            route, ref = gmm.grouped_update_mxu.last_route, gmm.grouped_update_mxu_plain(
                lhs, rhs, sizes, **kw)
        else:
            kw = dict(transpose_rhs=kw.get("transpose_rhs", False), out_dtype=kw.get("out_dtype"))
            got = gmm.grouped_mxu(lhs, rhs, sizes, **kw)
            route, ref = gmm.grouped_mxu.last_route, gmm.grouped_mxu_plain(lhs, rhs, sizes, **kw)
            if bool(got[used:].any()):
                raise AssertionError(f"ep {key}: rows past the groups are not zero")
        expect(f"ep {key} route", route, "wgmma")
        err = compare(torch, got, ref, quant_rtol(torch, got.dtype), f"ep {key}", scaled=True)[0]
        out[key] = (err, (m - used) / m)
    return out


def phase_moe_ep(torch, record, times):
    """Phase 29d: moe_forward_ep on (dp 2, ep 4) and moe_forward_ep_a2a on ep
    4 (capacity_factor 4: nothing drops), output and gradients held to the
    single-card moe_forward; B16 / B17 routes; the first rank's B16 forward,
    B16 dlhs and B17 calls held to their plain versions (ep_rank_calls); the
    psum and all_to_all bytes each rank received."""
    from gemm_hls_tpu_torch.models.moe import (
        a2a_capacity, moe_forward, moe_forward_ep, moe_forward_ep_a2a,
    )
    from gemm_hls_tpu_torch.parallel import Sharded
    c = PAR["moe"]
    cfg, params, x = moe_inputs(torch)
    w = signed(torch, x.shape, torch.float32, torch.Generator(device="cuda").manual_seed(296))
    m24, m4 = cuda_mesh((2, 4), ("dp", "ep")), cuda_mesh((4,), ("ep",))
    names = ("router", "w1", "w2")

    def grads(fn):
        p = {k: params[k].detach().requires_grad_() for k in names}
        xg = x.detach().requires_grad_()
        y = fn(p, xg)
        y = y.full() if isinstance(y, Sharded) else y
        return (y, *torch.autograd.grad((y.float() * w).sum(), [p[k] for k in names] + [xg]))

    want = grads(lambda p, xx: moe_forward(p, xx, cfg))
    d, ep = c["d_model"], 4
    cap = a2a_capacity(c["tokens"] // ep, c["top_k"], ep, c["capacity"])
    runs = {"ep psum (dp 2, ep 4)": (lambda p, xx: moe_forward_ep(p, xx, cfg, m24), m24),
            f"ep all_to_all (ep 4, capacity_factor {c['capacity']:g})":
                (lambda p, xx: moe_forward_ep_a2a(p, xx, cfg, m4,
                                                  capacity_factor=c["capacity"]), m4)}
    for name, (fn, mesh) in runs.items():
        key = f"29d {name}"
        got = par_step(torch, record, key, lambda fn=fn: grads(fn))
        errs = [within(f"{key} {what}", rel_norm(a, b), PAR_BF16_TOL)
                for what, a, b in zip(("y",) + names + ("x",), got, want)]
        got_l, ent = record[key]["launches"], record[key]["entries"]
        expect(f"{key} launches", set(got_l), {"B16", "B17"})
        expect(f"{key} routes", ent, {"grouped_wgmma": got_l.get("B16"),
                                      "grouped_update_wgmma": got_l.get("B17")})
        if "psum" in name:
            partial = c["tokens"] // 2 * d * 2
            rank_bytes(record, key, mesh, "ep_psum", 2 * (ep - 1) * partial // ep)
            rank_bytes(record, key, mesh, "ep_psum_bwd", 2 * (ep - 1) * partial // ep)
        else:
            rank_bytes(record, key, mesh, "all_to_all", (ep - 1) * cap * (2 * d * 2 + 4))
            rank_bytes(record, key, mesh, "all_to_all_bwd", (ep - 1) * cap * 2 * d * 2)
        record[key]["normwise"] = errs
        calls = ep_rank_calls(torch, lambda fn=fn: grads(fn))
        if not calls["B16"][1] > 0.5:
            raise AssertionError(f"{key}: the first rank's B16 call has only "
                                 f"{calls['B16'][1]:.0%} of its rows in the zero tail")
        record[key]["rank_calls"] = calls
        times[key] = event_turns(torch, {
            "ep": lambda fn=fn: fn(params, x).shards.tolist(),
            "single-card moe_forward": lambda: moe_forward(params, x, cfg)}, rounds=3, iters=3)
        log(f"phase 29d: {key[4:]} d {d} d_ff {c['d_ff']} {c['experts']} experts top-"
            f"{c['top_k']} bf16, {c['tokens']} tokens: y / router / w1 / w2 / x grads normwise "
            f"{' / '.join(f'{e:.3e}' for e in errs)} vs single-card moe_forward; launches "
            f"{got_l} on the engine; the first rank's calls vs the plain versions (max abs "
            f"err, zero-tail share): "
            + ", ".join(f"{a} {e:.3e} {z:.0%}" for a, (e, z) in calls.items())
            + "; bytes a rank "
            f"{ {t: v[next(iter(v))] for t, v in record[key]['bytes'].items()} }; forward in "
            f"turns (ms): " + ", ".join(f"{a} {b:.3f}" for a, b in times[key].items()))


def pipe_inputs(torch):
    from gemm_hls_tpu_torch.parallel import init_pipeline_params
    c = PAR["pipe"]
    gen = torch.Generator(device="cuda").manual_seed(297)
    params = init_pipeline_params(gen, c["stages"], c["d_model"], c["d_ffn"], torch.bfloat16)
    x, y = (signed(torch, (c["batch"], c["d_model"]), torch.bfloat16, gen) for _ in range(2))
    return params, x, y


def phase_pipeline(torch, record, times):
    """Phase 29e: pipeline_forward on 4 stages held to stages_forward, one
    pipeline_train_step to the autograd step of stages_forward, B1 on the
    engine, the ppermute bytes (T - 1) mb d 2 each way."""
    from gemm_hls_tpu_torch.parallel import (
        pipeline_forward, pipeline_train_step, shard_pipeline_params, stages_forward,
    )
    c = PAR["pipe"]
    p_, m, d = c["stages"], c["microbatches"], c["d_model"]
    mb, steps = c["batch"] // m, m + p_ - 1
    mesh = cuda_mesh((p_,), ("pp",))
    params, x, y = pipe_inputs(torch)
    sp = shard_pipeline_params(params, mesh)
    key = "29e forward"
    o = par_step(torch, record, key, lambda: pipeline_forward(sp, x, mesh, microbatches=m).full())
    err = within(key, rel_norm(o, stages_forward(params, x)), PAR_BF16_TOL)
    expect(f"{key} launches", record[key]["launches"], {"B1": 2 * p_ * m})
    expect(f"{key} routes", record[key]["entries"], {"mxu_wgmma": 2 * p_ * m})
    hops = (steps - 1) * mb * d * 2
    rank_bytes(record, key, mesh, "pipeline", hops)
    key = "29e train step"
    new, loss = par_step(torch, record, key, lambda: pipeline_train_step(
        sp, (x, y), mesh, microbatches=m, lr=c["lr"]))
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    ref_loss = torch.mean((stages_forward(leaves, x).float() - y.float()) ** 2)
    g = torch.autograd.grad(ref_loss, list(leaves.values()))
    ref_loss = ref_loss.detach()
    errs = [within(f"{key} {name}", rel_norm(new[name].full(), leaves[name].detach() - c["lr"] * gg),
                 PAR_BF16_TOL) for name, gg in zip(leaves, g)]
    if not abs(float(loss) - float(ref_loss)) <= BF16_RTOL * abs(float(ref_loss)):
        raise AssertionError(f"{key}: loss {float(loss)} vs {float(ref_loss)}")
    # Each stage application's two bf16 GEMMs on the engine, again in the
    # backward's recompute (remat); its backward's dW1, dW2, dh and (past
    # stage 0, whose input takes no gradient) dx in fp32 on B1's CUDA-core
    # route.
    b1 = record[key]["launches"].get("B1", 0)
    bwd = m * (4 * p_ - 1)
    expect(f"{key} launches", record[key]["launches"], {"B1": 4 * p_ * m + bwd})
    expect(f"{key} routes", record[key]["entries"],
           {"mxu_wgmma": 4 * p_ * m, "mxu_gemm": bwd})
    rank_bytes(record, key, mesh, "pipeline", hops)
    rank_bytes(record, key, mesh, "pipeline_bwd", hops)
    record["29e"] = dict(forward_normwise=err, param_normwise=errs,
                         loss=(float(loss), float(ref_loss)))
    times["29e"] = event_turns(torch, {
        "pipeline_forward": lambda: pipeline_forward(sp, x, mesh, microbatches=m).shards.tolist(),
        "stages_forward": lambda: stages_forward(params, x),
        "pipeline_train_step": lambda: pipeline_train_step(sp, (x, y), mesh, microbatches=m,
                                                           lr=c["lr"])[1]}, rounds=3, iters=1)
    log(f"phase 29e: pipeline {p_} stages of {d} -> {c['d_ffn']} -> {d} bf16, batch "
        f"{c['batch']} in {m} microbatches (T {steps}): forward normwise {err:.3e} vs "
        f"stages_forward, B1 x{2 * p_ * m} on wgmma; train step loss {float(loss):.6f} vs "
        f"{float(ref_loss):.6f}, params normwise max {max(errs):.3e}, B1 x{b1} ({4 * p_ * m} "
        f"on wgmma, {bwd} fp32 on simt); ppermute "
        f"{hops} B a rank each way; in turns (ms): "
        + ", ".join(f"{a} {b:.3f}" for a, b in times["29e"].items()))


def phase29_profiles(torch):
    """Device-busy share of one call of each phase-29 path (torch.profiler),
    run in a fresh process: late in a long one the profiler held only part
    of the kernels' device time (phase 27c)."""
    from gemm_hls_tpu_torch.models import mlp
    from gemm_hls_tpu_torch.models.moe import moe_forward_ep
    from gemm_hls_tpu_torch.parallel import (
        device_put, pipeline_train_step, ring_flash_attention, shard_pipeline_params,
    )
    (q, k, v), _ = ring_inputs(torch)
    ring_mesh = cuda_mesh((PAR["ring"]["ranks"],), ("x",))
    params, batch = mlp_inputs(torch)
    mesh = cuda_mesh(PAR["mlp"]["mesh"], ("dp", "tp"))
    sharded = mlp.shard_params(params, mesh)
    sb = tuple(device_put(t, mesh, mlp.batch_sharding(mesh)) for t in batch)
    cfg, moe_params, x = moe_inputs(torch)
    ep_mesh = cuda_mesh((2, 4), ("dp", "ep"))
    pp, px, py = pipe_inputs(torch)
    pmesh = cuda_mesh((PAR["pipe"]["stages"],), ("pp",))
    sp = shard_pipeline_params(pp, pmesh)
    fns = {"ring causal forward": lambda: ring_flash_attention(q, k, v, ring_mesh, causal=True),
           "sharded MLP step": lambda: mlp.train_step(sharded, sb, lr=0.1),
           "MoE ep psum forward": lambda: moe_forward_ep(moe_params, x, cfg, ep_mesh),
           "pipeline train step": lambda: pipeline_train_step(
               sp, (px, py), pmesh, microbatches=PAR["pipe"]["microbatches"], lr=0.1)}
    out = {}
    for name, fn in fns.items():
        busy, kernels = device_profile(torch, fn, 2)
        out[name] = dict(busy=busy, kernels=kernels[:4])
    return out


def phase_slice20(torch):
    """Phase 29 (main path): training parallelism on virtual ranks of the card
    (29a ring attention, 29b ring decode, 29c the sharded MLP step, 29d MoE
    expert parallelism, 29e the pipeline), every launch count, the byte
    counter and the library's entry counts set to 0 just before each call
    and read just after; then each path's device-busy share in a fresh
    process.  Returns (record, times, profiles)."""
    record, times, secs = {}, {}, {}
    for name, fn in (("29a", lambda: phase_ring(torch, record, times)),
                     ("29b", lambda: phase_ring_decode(torch, record)),
                     ("29c", lambda: phase_mlp_sharded(torch, record, times)),
                     ("29d", lambda: phase_moe_ep(torch, record, times)),
                     ("29e", lambda: phase_pipeline(torch, record, times))):
        t0 = time.perf_counter()
        fn()
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    code = ("import json, sys, torch\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import chip_smoke as cs\n"
            "print(json.dumps(cs.phase29_profiles(torch)))\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise AssertionError(f"phase 29 profiles: the process failed:\n{proc.stderr[-3000:]}")
    profiles = json.loads(proc.stdout.splitlines()[-1])
    secs["profiles"] = time.perf_counter() - t0
    for name, prof in profiles.items():
        log(f"phase 29: {name} profile: device busy {prof['busy']:.1%} of the host clock; by "
            f"kernel (us a call): " + "; ".join(f"{k[:60]} {us:.1f}" for k, us in prof["kernels"]))
    log("phase 29: seconds " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return record, times, profiles


# Slice 21: every operand type the reference's GEMM kernels take (phase
# 30).  The case tables tests/test_torch_kernels.py parametrises too.
WIDE_DTYPES = ("float64", "float16", "int8", "int16", "uint8", "uint16", "uint32", "int64")
# Each type's B3 instantiation, csrc/semiring_<suffix>.cu.
B3_SOURCES = {"float64": "f64", "float16": "f16", "int8": "i8", "int16": "i16", "uint8": "u8",
              "uint16": "u16", "uint32": "u32", "int64": "i64"}
# The semirings with a kernel functor, and those that take integers (the
# reference's log_plus takes floats only, as torch.logaddexp does).
B3_SEMIRINGS = ("plus_times", "min_plus", "max_plus", "max_min", "min_max", "max_times",
                "plus_absdiff", "plus_sqdiff", "log_plus")
EXACT_SEMIRINGS = ("min_plus", "max_plus", "max_min", "min_max", "max_times")


# B1 / B2 on the wide types: (dtype, out dtype, ta, tb, batch (None: B1),
# M, N, K, values, layout, broadcast ("a" / "b": that operand 2-D),
# epilogue, route).  values: "rand" (floats U(-1, 1), integers over their
# whole range: every sum wraps), "small" (integers in [-3, 3], [0, 3]
# unsigned), "edge" (the type's extremes, and floats' +-inf and NaN,
# sprinkled in).  layout: "dense", "pitched" (rows of whole 16-byte units
# plus one unit), "odd" (a view one element into rows one element longer:
# base and pitch off the 16-byte grid, so the float64 tile copies 8 bytes
# at a time).  float64 on csrc/dmma_gemm.cu: the four layouts on each
# layout of memory, M, N and K off the tile, K 1 / 3 / 17, a 1 x 1 x 1
# call, float32 output, a broadcast 2-D a / b, a batch past gridDim.z's
# 65535, every epilogue (B1 and B2), +-inf and NaN; int16 and the unsigned
# ints on csrc/mxu_simt_int.cu in the four layouts, odd and ragged shapes,
# int32 and own-type outputs, an epilogue to fp32, batched; int8's
# extremes on its tensor-core routes (the engine and WMMA).
WIDE_B1_CASES = (
    [("float64", "float64", ta, tb, None, 300, 520, 136, "rand", lay, None, None, "dmma")
     for ta, tb in LAYOUTS for lay in ("dense", "pitched", "odd")]
    + [("float64", "float64", ta, tb, 3, 130, 264, 67, "rand", "odd", None, None, "dmma")
       for ta, tb in LAYOUTS]
    + [("float64", "float64", False, False, None, 1, 1, 1, "rand", "dense", None, None, "dmma"),
       ("float64", "float64", True, False, None, 129, 7, 1, "rand", "odd", None, None, "dmma"),
       ("float64", "float64", False, True, None, 65, 200, 3, "rand", "dense", None, None, "dmma"),
       ("float64", "float64", True, True, None, 200, 129, 17, "rand", "pitched", None, None,
        "dmma"),
       ("float64", "float32", False, False, None, 300, 520, 136, "rand", "dense", None, None,
        "dmma"),
       ("float64", "float64", False, False, 5, 130, 264, 200, "rand", "pitched", "a", None,
        "dmma"),
       ("float64", "float64", True, True, 5, 130, 264, 200, "rand", "dense", "b", None, "dmma"),
       ("float64", "float64", False, True, 70_000, 3, 8, 8, "rand", "dense", None, None,
        "dmma"),
       ("float64", "float64", False, False, None, 64, 72, 100, "edge", "dense", None, None,
        "dmma")]
    + [("float64", "float64", False, False, None, 300, 520, 136, "rand", "dense", None, ep,
        "dmma") for ep in EPILOGUES]
    + [("float64", "float64", True, False, 3, 130, 264, 67, "rand", "odd", None, ep, "dmma")
       for ep in ("bias_gelu", "scale_bias")]
    + [(dt, dt, ta, tb, None, 130, 200, 67, "rand", "dense", None, None, "simt")
       for dt in ("int16", "uint8", "uint16", "uint32") for ta, tb in LAYOUTS]
    + [(dt, "int32", False, True, None, 77, 90, 33, "rand", "odd", None, None, "simt")
       for dt in ("int16", "uint8", "uint16", "uint32")]
    + [(dt, dt, True, False, None, 5, 3, 1, "edge", "dense", None, None, "simt")
       for dt in ("int16", "uint8", "uint16", "uint32")]
    + [(dt, "float32", False, False, None, 130, 200, 67, "small", "dense", None, "bias", "simt")
       for dt in ("int16", "uint8")]
    + [(dt, dt, False, True, 3, 64, 72, 17, "rand", "pitched", "b", None, "simt")
       for dt in ("int16", "uint8", "uint16", "uint32")]
    + [("int8", out, False, True, None, 300, 520, 272, "edge", "dense", None, None, "wgmma")
       for out in ("int32", "int8")]
    + [("int8", "int32", False, False, None, 130, 200, 33, "edge", "dense", None, None, "wmma")]
)
# B3 on the wide types: (dtype, semiring, out dtype, ta, tb, batch, M, N, K,
# values, layout, broadcast).  Every semiring the type takes at an odd
# shape with the sums wrapping, then the extremes (+-inf and NaN for the
# floats; uint32 above 2^31, int64 above 2^32) under the min / max
# semirings with both operands transposed and odd pitches, K 1 / 3 / 33
# (odd K for the 1- and 2-byte types), batched with a broadcast b, and
# wider outputs; "few" (floats): U(-1, 1) with one NaN and a +inf / -inf
# pair in the first K slice only, so float64's min / max semirings run
# their all-finite form (semiring_ops.cuh, kNum) on the later slices with
# NaN accumulators.
WIDE_B3_CASES = (
    [(dt, sr, dt, False, False, None, 130, 200, 67, "rand", "dense", None)
     for dt in WIDE_DTYPES for sr in B3_SEMIRINGS if sr != "log_plus" or dt in ("float64", "float16")]
    + [(dt, sr, dt, True, True, None, 77, 90, k, "edge", "odd", None)
       for dt in WIDE_DTYPES for sr, k in (("min_plus", 33), ("max_min", 3), ("max_plus", 1))]
    + [(dt, "min_max", dt, False, True, 3, 64, 72, 17, "rand", "pitched", "b")
       for dt in WIDE_DTYPES]
    + [("float16", "log_plus", "float16", True, False, None, 64, 72, 33, "edge", "dense", None),
       ("float64", "log_plus", "float64", True, False, None, 64, 72, 33, "edge", "dense", None),
       ("float16", "min_plus", "float32", False, False, None, 130, 200, 67, "rand", "dense", None),
       ("float64", "plus_sqdiff", "float32", False, False, None, 130, 200, 67, "rand", "dense",
        None),
       ("int8", "max_plus", "int32", False, False, None, 130, 200, 67, "edge", "dense", None),
       ("uint8", "plus_times", "int32", False, False, None, 130, 200, 67, "rand", "dense", None)]
    + [(dt, sr, dt, ta, False, None, 130, 200, 67, "few", "dense", None)
       for dt in ("float64", "float16") for sr in ("min_plus", "max_min", "max_times")
       for ta in (False, True)]
)


def wide_operand(torch, gen, rows, cols, dtype, values="rand", layout="dense", lead=()):
    """A (*lead, rows, cols) operand of ``dtype`` on the card (WIDE_B1_CASES'
    values and layout), drawn in int64 / float64 and cast once, so a type
    with few CUDA kernels (uint16, uint32) needs only the cast."""
    dev = "cuda"
    if layout == "pitched":
        per = 16 // dtype.itemsize
        width = (cols + per - 1) // per * per + per
    else:
        width = cols + (layout == "odd")
    shape = (*lead, rows, width)
    if dtype.is_floating_point:
        x = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 2 - 1
        specials = [float("inf"), float("-inf"), float("nan"), 0.0, -0.0]
    else:
        info = torch.iinfo(dtype)
        lo, hi = (-3, 4) if values == "small" else (info.min, info.max + 1)
        if dtype == torch.uint8 and values == "small":
            lo = 0
        if dtype == torch.int64 and values != "small":
            lo, hi = -2**40, 2**40  # above 2^32: wrapped to the low 32 bits at the load
        if dtype in (torch.uint16, torch.uint32) and values == "small":
            lo = 0
        x = torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int64)
        specials = sorted({info.min, info.max, 0, 1, info.max // 2 + 1, info.max // 2}
                          | ({-1} if info.min < 0 else set())
                          | ({2**32 + 5, -2**33 + 7, 2**31} if dtype == torch.int64 else set()))
    if values == "edge":
        pick = torch.randint(len(specials), shape, generator=gen, device=dev)
        vals = torch.tensor(specials, dtype=x.dtype, device=dev)[pick]
        x = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.08, vals, x)
    x = x.to(dtype)
    return x[..., 1:] if layout == "odd" else x[..., :cols]


def wide_rtol(torch, out_dtype, exact):
    """Kernel against plain: exact for integers and the min / max semirings;
    float64 sums 1e-9 (the reference's float64 tolerance,
    tests/test_matmul.py), fp32 1e-4 and 16-bit outputs 1e-2, scaled."""
    if exact or not out_dtype.is_floating_point:
        return 0.0
    return {torch.float64: 1e-9, torch.float32: F32_RTOL}.get(out_dtype, BF16_RTOL)


def wide_b1_operands(torch, gen, case):
    """(a, b, epilogue operands, keyword arguments) of a WIDE_B1_CASES case."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    dt, out, ta, tb, bsz, m, n, k, values, layout, bcast, ep_name, _ = case
    dtype = getattr(torch, dt)
    a = wide_operand(torch, gen, *((k, m) if ta else (m, k)), dtype, values, layout,
                     () if bsz is None or bcast == "a" else (bsz,))
    b = wide_operand(torch, gen, *((n, k) if tb else (k, n)), dtype, values, layout,
                     () if bsz is None or bcast == "b" else (bsz,))
    ep = get_epilogue(ep_name) if ep_name else None
    floats = dtype.is_floating_point
    eps = [signed(torch, (n,), dtype if floats else torch.float32, gen) * (1 if floats else 20)
           for _ in range(ep.n_operands if ep else 0)]
    return a, b, eps, dict(cfg=default_config(dtype, out_dtype=out), transpose_a=ta,
                           transpose_b=tb, epilogue=ep)


def aligned_case(case):
    """Whether a WIDE_B1_CASES-form case's operands, as ``wide_operand``
    makes them, have the 16-byte bases, row pitches and batch strides a TMA
    map describes: pitched rows always, dense rows of whole 16-byte units,
    odd-pitched views never."""
    dt, ta, tb, bsz, m, n, k, layout, bcast = (case[0], case[2], case[3], case[4], *case[5:8],
                                               case[9], case[10])
    if layout != "dense":
        return layout == "pitched"
    size = {"float64": 8, "float32": 4, "int64": 8, "uint32": 4, "int32": 4}.get(dt, 2)
    size = 1 if dt in ("int8", "uint8") else size
    rows = (m if ta else k, k if tb else n)
    ok = all(cols * size % 16 == 0 for cols in rows)
    if bsz is not None:  # each 3-D operand's batch stride
        elems = [(k * m, "a"), (n * k, "b")]
        ok = ok and all(e * size % 16 == 0 for e, w in elems if bcast != w)
    return ok


def wide_b1_case(torch, gen, case):
    """One WIDE_B1_CASES case on B1 (batch None) or B2 against the plain
    version, the route (and, for float64, the tile of ``ops.mxu.dmma_tile``)
    checked; returns the largest abs error."""
    from gemm_hls_tpu_torch.ops import mxu
    a, b, eps, kw = wide_b1_operands(torch, gen, case[:13])
    fn = mxu.mxu_matmul if case[4] is None else mxu.mxu_matmul_batched
    got = fn(a, b, *eps, **kw)
    if fn.last_route != case[12]:
        raise AssertionError(f"B1 / B2 {case}: route {fn.last_route}")
    tile = mxu.dmma_tile(aligned_case(case)) if case[12] == "dmma" else None
    if fn.last_dmma_tile != tile:
        raise AssertionError(f"B1 / B2 {case}: float64 tile {fn.last_dmma_tile}, not {tile}")
    rtol = wide_rtol(torch, got.dtype, False)
    return compare(torch, got, mxu.mxu_matmul_plain(a, b, *eps, **kw), rtol,
                   f"B1 / B2 {case}", scaled=True)[0]


def wide_b3_case(torch, gen, case):
    """One WIDE_B3_CASES case on B3 against the plain version; returns the
    largest abs error."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import vpu
    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    dt, sr, out, ta, tb, bsz, m, n, k, values, layout, bcast = case
    dtype = getattr(torch, dt)
    a = wide_operand(torch, gen, *((k, m) if ta else (m, k)), dtype, values, layout,
                     () if bsz is None or bcast == "a" else (bsz,))
    b = wide_operand(torch, gen, *((n, k) if tb else (k, n)), dtype, values, layout,
                     () if bsz is None or bcast == "b" else (bsz,))
    if values == "few":  # in the first K slice: NaN at (5, 3), inf + -inf at (9, 7)
        a_mk, b_kn = (a.transpose(-1, -2) if ta else a), (b.transpose(-1, -2) if tb else b)
        a_mk[..., 5, 3], a_mk[..., 9, 2] = float("nan"), float("inf")
        b_kn[..., 2, 7] = float("-inf")
    kw = dict(cfg=default_config(dtype, semiring=sr, out_dtype=out), sr=get_semiring(sr),
              transpose_a=ta, transpose_b=tb)
    got = vpu.vpu_matmul(a, b, **kw)
    rtol = wide_rtol(torch, got.dtype, sr in EXACT_SEMIRINGS)
    return compare(torch, got, vpu.vpu_matmul_plain(a, b, **kw), rtol, f"B3 {case}",
                   scaled=True)[0]


# The main path's shapes (phase 30): float64 at 8192^3 (and 2048^3 against
# the numpy oracle), batched 16 x 1024^3 with epilogues, the float64
# gradient at 4096^3, B3 at 4096^3 per new type (each type's
# semiring_<type>.cu), B1's integer CUDA-core route at 4096^3.
SLICE21 = dict(f64=8192, oracle=2048, batched=(16, 1024), grad=4096, b3=4096, b1_int=4096)
SLICE21_B3 = (("float16", "min_plus"), ("int8", "min_plus"), ("uint8", "min_plus"),
              ("int16", "min_plus"), ("float64", "min_plus"), ("uint32", "max_min"),
              ("uint16", "min_plus"), ("int64", "min_plus"))
SLICE21_B1_INT = ("int16", "uint8")


def phase_slice21(torch):
    """Phase 30: slice 21's kernels and main path.  (f) the case tables
    first (WIDE_B1_CASES, WIDE_B3_CASES: every wide type on B1 / B2 / B3
    against the plain versions, the edges); then, launch counts set to 0
    just before and read just after, the front door at the main path's
    shapes: (a) float64 ``matmul`` at 8192^3 on ``dmma`` against the plain
    version and, at 2048^3 in the four layouts, against numpy's float64
    product (rtol 1e-9); (b) batched float64 16 x 1024^3 with a
    ``bias_gelu`` and a ``scale_bias`` epilogue; (c) the float64 gradient at
    4096^3 against plain autograd; (d) B3 at 4096^3, min_plus in float16,
    int8, uint8, int16, float64, uint16 and int64 and max_min in uint32, bit
    for bit; (e)
    B1 int16 and uint8 plus_times at 4096^3, exact.  Then each kernel's time
    beside its plain version's and its bound, float64 ``torch.matmul``
    (cuBLAS DGEMM) beside B1's float64.  Returns the readings for the
    kernels line."""
    import numpy as np

    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.models.perf_model import H100
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    from gemm_hls_tpu_torch.ops.semiring import get_semiring

    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(21)
    worst = max(wide_b1_case(torch, gen, c) for c in WIDE_B1_CASES)
    routes = sorted({c[-1] for c in WIDE_B1_CASES})
    log(f"phase 30f: B1 / B2 wide-type cases, {len(WIDE_B1_CASES)} (float64 on dmma in four "
        f"layouts, dense / pitched / odd pitches, K 1 / 3 / 17, float32 out, broadcast, batch "
        f"70000, every epilogue, +-inf / NaN; int16 / uint8 / uint16 / uint32 on simt; int8 "
        f"-128 / 127 on its tensor-core routes), routes {routes} checked each: ok (worst abs "
        f"err {worst:.3e})")
    worst = max(wide_b3_case(torch, gen, c) for c in WIDE_B3_CASES)
    log(f"phase 30f: B3 wide-type cases, {len(WIDE_B3_CASES)} (every semiring of each of "
        f"{', '.join(WIDE_DTYPES)}; extremes, +-inf / NaN, uint32 above 2^31, int64 above "
        f"2^32, odd K and pitches, batched): ok (worst abs err {worst:.3e})")

    reset_counters()
    t0 = time.perf_counter()
    n = SLICE21["f64"]
    a = signed(torch, (n, n), torch.float64, gen)
    b = signed(torch, (n, n), torch.float64, gen)
    got = matmul(a, b)
    if mxu.mxu_matmul.last_route != "dmma":
        raise AssertionError(f"30a: float64 {n}^3 on {mxu.mxu_matmul.last_route}")
    tile30 = mxu.mxu_matmul.last_dmma_tile
    cfg64 = default_config(torch.float64)
    plain64 = mxu.mxu_matmul_plain(a, b, cfg=cfg64)
    err_a = compare(torch, got, plain64, 1e-9, f"30a float64 {n}^3", scaled=True)
    del got, plain64
    no = SLICE21["oracle"]
    oracle_err = {}
    for ta, tb in LAYOUTS:
        x = signed(torch, (no, no), torch.float64, gen)
        y = signed(torch, (no, no), torch.float64, gen)
        got = matmul(x, y, transpose_a=ta, transpose_b=tb)
        if mxu.mxu_matmul.last_route != "dmma":
            raise AssertionError(f"30a: float64 {no}^3 {ta, tb} on {mxu.mxu_matmul.last_route}")
        xn, yn = x.cpu().numpy(), y.cpu().numpy()
        want = torch.from_numpy((xn.T if ta else xn) @ (yn.T if tb else yn)).cuda()
        oracle_err[f"{'t' if ta else 'n'}{'t' if tb else 'n'}"] = compare(
            torch, got, want, 1e-9, f"30a float64 {no}^3 {ta, tb} vs numpy", scaled=True)[1]
    log(f"phase 30a: float64 {n}^3 on dmma vs plain: max abs err {err_a[0]:.3e}, scaled rel "
        f"{err_a[1]:.3e}; {no}^3 in four layouts vs numpy float64, scaled rel "
        + ", ".join(f"{k} {v:.3e}" for k, v in oracle_err.items()))

    bsz, nb = SLICE21["batched"]
    xb = signed(torch, (bsz, nb, nb), torch.float64, gen)
    yb = signed(torch, (bsz, nb, nb), torch.float64, gen)
    s_ = signed(torch, (nb,), torch.float64, gen)
    bias = signed(torch, (nb,), torch.float64, gen)
    batched_err = {}
    for ep, ops in (("bias_gelu", (bias,)), ("scale_bias", (s_, bias))):
        got = matmul(xb, yb, epilogue=ep, epilogue_operands=ops)
        if mxu.mxu_matmul_batched.last_route != "dmma":
            raise AssertionError(f"30b: {ep} on {mxu.mxu_matmul_batched.last_route}")
        want = mxu.mxu_matmul_plain(xb, yb, *ops, cfg=cfg64, epilogue=get_epilogue(ep))
        batched_err[ep] = compare(torch, got, want, 1e-9, f"30b {ep}", scaled=True)[0]
    log(f"phase 30b: batched float64 {bsz} x {nb}^3 with bias_gelu / scale_bias on dmma vs "
        f"plain: max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in batched_err.items()))

    ng = SLICE21["grad"]
    xg = signed(torch, (ng, ng), torch.float64, gen).requires_grad_()
    yg = signed(torch, (ng, ng), torch.float64, gen).requires_grad_()
    cot = signed(torch, (ng, ng), torch.float64, gen)
    before = mxu.route_launches["dmma", "float64"]
    matmul(xg, yg).backward(cot)
    if mxu.route_launches["dmma", "float64"] - before != 3:
        raise AssertionError("30c: the float64 gradient is not three dmma launches")
    xp, yp = xg.detach().clone().requires_grad_(), yg.detach().clone().requires_grad_()
    torch.matmul(xp, yp).backward(cot)
    grad_err = [compare(torch, g_, w_, 1e-9, f"30c d{nm}", scaled=True)[0]
                for nm, g_, w_ in (("a", xg.grad, xp.grad), ("b", yg.grad, yp.grad))]
    del xg, yg, xp, yp, cot
    log(f"phase 30c: float64 gradient {ng}^3 (forward and both backward GEMMs on dmma) vs "
        f"plain autograd: max abs err dA {grad_err[0]:.3e}, dB {grad_err[1]:.3e}")

    nb3 = SLICE21["b3"]
    b3_ops = {}
    for dt, sr in SLICE21_B3:
        dtype = getattr(torch, dt)
        x = wide_operand(torch, gen, nb3, nb3, dtype)
        y = wide_operand(torch, gen, nb3, nb3, dtype)
        got = matmul(x, y, semiring=sr)
        cfg = default_config(dtype, semiring=sr)
        want = vpu.vpu_matmul_plain(x, y, cfg=cfg, sr=get_semiring(sr))
        compare(torch, got, want, 0.0, f"30d {dt} {sr} {nb3}^3")
        b3_ops[dt, sr] = (x, y, cfg)
        del got, want
    log(f"phase 30d: B3 {nb3}^3 " + ", ".join(f"{sr} {dt}" for dt, sr in SLICE21_B3)
        + " vs plain: bit for bit")

    ni = SLICE21["b1_int"]
    b1_ops = {}
    for dt in SLICE21_B1_INT:
        dtype = getattr(torch, dt)
        x = wide_operand(torch, gen, ni, ni, dtype)
        y = wide_operand(torch, gen, ni, ni, dtype)
        got = matmul(x, y)
        if mxu.mxu_matmul.last_route != "simt":
            raise AssertionError(f"30e: {dt} on {mxu.mxu_matmul.last_route}")
        cfg = default_config(dtype)
        compare(torch, got, mxu.mxu_matmul_plain(x, y, cfg=cfg), 0.0, f"30e {dt} {ni}^3")
        b1_ops[dt] = (x, y, cfg)
        del got
    log(f"phase 30e: B1 plus_times {ni}^3 " + ", ".join(SLICE21_B1_INT)
        + " on simt (int32 accumulator, wrapping) vs plain: exact")
    launches = dict(counters(), routes=dict(mxu.route_launches),
                    b3_dtypes=dict(vpu.vpu_matmul.dtype_launches))
    log(f"phase 30: main-path launches {launches}")
    need = [("dmma", "float64")] + [("simt", dt) for dt in SLICE21_B1_INT]
    if any(not mxu.route_launches[key] for key in need) or any(
            not vpu.vpu_matmul.dtype_launches[dt] for dt, _ in SLICE21_B3):
        raise AssertionError(f"phase 30: a kernel of the path was not launched: {launches}")
    main_s = time.perf_counter() - t0

    # Times, in turns on CUDA events (launches here are comparisons).
    readings = {}
    e64 = 8
    t = event_turns(torch, {"kernel": lambda: mxu.mxu_matmul(a, b, cfg=cfg64),
                            "plain": lambda: mxu.mxu_matmul_plain(a, b, cfg=cfg64),
                            "library": lambda: torch.matmul(a, b)})
    readings["B1 float64"] = dict(
        ms=t["kernel"], plain_ms=t["plain"], library_ms=t["library"], max_abs_err=err_a[0],
        bound=H100.bound(2.0 * n ** 3, H100.peak_for("float64"), 3 * n * n * e64),
        oracle_2048_scaled_rel=oracle_err, batched_max_abs_err=batched_err,
        grad_max_abs_err=grad_err, tile=tile30)
    for (dt, sr), (x, y, cfg) in b3_ops.items():
        sem = get_semiring(sr)
        t = event_turns(torch, {"kernel": lambda: vpu.vpu_matmul(x, y, cfg=cfg, sr=sem)},
                        rounds=3, iters=2)
        t.update(event_turns(torch, {"plain": lambda: vpu.vpu_matmul_plain(x, y, cfg=cfg,
                                                                           sr=sem)},
                             rounds=1, iters=1))
        isz = x.element_size()
        readings[f"B3 {sr} {dt}"] = dict(
            ms=t["kernel"], plain_ms=t["plain"], library_ms=None, max_abs_err=0.0,
            bound=H100.bound(2.0 * nb3 ** 3, H100.vpu_ops_for(dt), 3 * nb3 * nb3 * isz))
    for dt, (x, y, cfg) in b1_ops.items():
        t = event_turns(torch, {"kernel": lambda: mxu.mxu_matmul(x, y, cfg=cfg),
                                "plain": lambda: mxu.mxu_matmul_plain(x, y, cfg=cfg)},
                        rounds=3, iters=2)
        isz = x.element_size()
        readings[f"B1 {dt}"] = dict(
            ms=t["kernel"], plain_ms=t["plain"], library_ms=None, max_abs_err=0.0,
            bound=H100.bound(2.0 * ni ** 3, H100.peak_for(dt), 3 * ni * ni * isz))
    for key, r in readings.items():
        bound_ms = r["bound"][0] * 1e3
        lib = f", library {r['library_ms']:.3f} ms" if r["library_ms"] else ""
        log(f"phase 30: {key}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{lib}, bound "
            f"{bound_ms:.3f} ms ({r['bound'][1]}), {bound_ms / r['ms']:.1%} of the bound")
    del a, b, b3_ops, b1_ops
    torch.cuda.empty_cache()
    log(f"phase 30: {time.perf_counter() - t_start:.1f} s (main path {main_s:.1f} s)")
    return {"launches": launches, "readings": readings}


# ---------------------------------------------------------------------------
# Slice 22: user-defined semirings and Python-callable epilogues on the card
# (phase 31), each compiled at first use into a functor of its own
# (gemm_hls_tpu_torch/ops/codegen.py)
# ---------------------------------------------------------------------------

_USER_SEMIRINGS = {}
_USER_EPILOGUES = {}


def user_semirings():
    """Phase 31's user-defined semirings, built once (every call reuses one
    lowering): example 02's plus_max, a max_plus and a log semiring that
    re-express built-ins, and an integer max_xor."""
    if not _USER_SEMIRINGS:
        import numpy as np
        import torch

        from gemm_hls_tpu_torch import Semiring
        inf = float("inf")
        _USER_SEMIRINGS.update(
            plus_max=Semiring("plus_max", torch.maximum, torch.add, 0, np.maximum, np.add),
            user_max_plus=Semiring("user_max_plus", torch.add, torch.maximum, -inf, np.add,
                                   np.maximum),
            user_log=Semiring("user_log", torch.add, torch.logaddexp, -inf, np.add,
                              np.logaddexp),
            max_xor=Semiring("max_xor", torch.bitwise_xor, torch.maximum, -inf,
                             np.bitwise_xor, np.maximum))
    return _USER_SEMIRINGS


def user_epilogues():
    """Phase 31's callable epilogues: name -> (callable, operand count)."""
    if not _USER_EPILOGUES:
        import torch
        import torch.nn.functional as F
        _USER_EPILOGUES.update(
            relu_bias=(lambda acc, b: torch.relu(acc + b), 1),
            silu_bias=(lambda acc, b: F.silu(acc + b), 1),
            clamp2=(lambda acc, lo, hi: torch.clamp(acc, lo, hi) * 0.5, 2),
            leaky=(lambda acc, b: torch.where(acc + b > 0, acc + b, 0.01 * (acc + b)), 1))
    return _USER_EPILOGUES


# B3 with a user semiring (phase 31's table, tests/test_torch_kernels.py
# parametrises it too): WIDE_B3_CASES' form, the semiring first: (semiring,
# dtype, out dtype, ta, tb, batch, M, N, K, values, layout, broadcast).
# The three float customs in four layouts; NaN / +-inf ("edge") under the
# min / max and the sum customs with odd pitches and K tails; batched, with
# a broadcast a or b; int8 and int32 inputs (sums and xors wrapping);
# 1 x 1 x 1 and M 1.  Five libraries: each (semiring, input type) is one.
GEN_B3_CASES = (
    [(sr, "float32", "float32", ta, tb, None, 130, 200, 67, "rand", "dense", None)
     for sr in ("plus_max", "user_max_plus", "user_log") for ta, tb in LAYOUTS]
    + [("user_max_plus", "float32", "float32", True, True, None, 77, 90, 33, "edge", "odd", None),
       ("plus_max", "float32", "float32", False, False, None, 77, 90, 33, "edge", "odd", None),
       ("user_log", "float32", "float32", True, False, None, 64, 72, 33, "edge", "dense", None),
       ("user_max_plus", "float32", "float32", False, True, 3, 64, 72, 17, "rand", "pitched",
        "b"),
       ("plus_max", "float32", "float32", True, False, 3, 64, 72, 17, "rand", "dense", "a"),
       ("user_log", "float32", "float32", False, False, 4, 64, 72, 17, "rand", "dense", None),
       ("plus_max", "int8", "int32", False, False, None, 130, 200, 67, "rand", "dense", None),
       ("plus_max", "int8", "int32", True, True, 3, 64, 72, 17, "edge", "odd", None),
       ("max_xor", "int32", "int32", True, False, None, 130, 200, 67, "rand", "odd", None),
       ("max_xor", "int32", "int32", False, False, None, 77, 90, 33, "edge", "dense", None),
       ("user_max_plus", "float32", "float32", False, False, None, 1, 1, 1, "rand", "dense",
        None),
       ("plus_max", "float32", "float32", False, False, None, 1, 300, 1, "rand", "dense", None)]
)
# Callable epilogues on B1 / B2 (phase 31's table, tests/test_torch_kernels.py
# parametrises it too): (epilogue, dtype, out dtype, ta, tb, batch (None:
# B1), M, N, K, layout, broadcast, route).  Operands: fp32 for integer
# inputs (as the registered epilogues take them), the input's own type
# else.  relu_bias on every route: the engine in two layouts through
# pitched views (ragged M, N, K), WMMA through rows that are not whole
# 16-byte units and odd bases (both B layouts), the CUDA cores, dmma in two
# layouts, int8 on the engine (K-major) and on WMMA; silu_bias, the
# two-operand clamp and the leaky ReLU (torch.where); B2 batched, with a
# broadcast 2-D operand.  A library is one (callable, route, input type,
# layout; the CUDA cores take any layout): twelve, seven of them the main
# path's.
GEN_EPILOGUE_CASES = (
    [("relu_bias", "bfloat16", "bfloat16", ta, tb, None, 1000, 1030, 1100, "pitched", None,
      "wgmma") for ta, tb in ((False, False), (True, True))]
    + [("relu_bias", "float64", "float64", ta, False, None, 130, 200, 67, lay, None, "dmma")
       for ta, lay in ((False, "dense"), (True, "odd"))]
    + [("relu_bias", "bfloat16", "float32", False, False, None, 250, 300, 100, "dense", None,
        "wmma"),
       ("relu_bias", "float16", "float16", True, True, None, 130, 264, 67, "odd", None, "wmma"),
       ("relu_bias", "float32", "float32", False, False, None, 130, 200, 67, "dense", None,
        "simt"),
       ("relu_bias", "float32", "float32", True, True, None, 130, 200, 67, "odd", None, "simt"),
       ("relu_bias", "int8", "float32", False, True, None, 300, 520, 272, "dense", None,
        "wgmma"),
       ("relu_bias", "int8", "float32", False, False, None, 300, 520, 272, "dense", None,
        "wmma"),
       ("silu_bias", "bfloat16", "bfloat16", False, False, None, 1000, 1030, 1100, "pitched",
        None, "wgmma"),
       ("silu_bias", "float32", "float32", True, False, None, 130, 200, 67, "dense", None,
        "simt"),
       ("clamp2", "bfloat16", "float32", False, False, None, 264, 384, 512, "dense", None,
        "wgmma"),
       ("leaky", "float32", "float32", False, True, None, 130, 200, 67, "dense", None, "simt"),
       ("relu_bias", "bfloat16", "bfloat16", False, False, 5, 300, 1030, 200, "pitched", None,
        "wgmma"),
       ("silu_bias", "bfloat16", "float32", False, False, 5, 130, 264, 200, "pitched", "a",
        "wgmma"),
       ("relu_bias", "float32", "float32", False, False, 3, 65, 140, 131, "dense", "a", "simt"),
       ("relu_bias", "float64", "float64", False, False, 3, 65, 140, 131, "dense", None, "dmma"),
       ("relu_bias", "bfloat16", "float32", False, False, 3, 64, 72, 100, "dense", None, "wmma")]
)

# The main path's shapes (phase 31): B3 at 4096^3 (B3's standing size,
# PERF.md section 6); B1's epilogue row, bf16 (8192 x 4096) . (4096 x
# 16384); relu(acc + b) on WMMA (bf16, A's rows 2008 bytes), the CUDA cores
# (fp32) and dmma (float64) at 2048^3; the clamp at bf16 4096^3; B2 16 x
# 1024^3; int8 K-major 4096^3; the gradient at fp32 2048^3.
SLICE22 = dict(b3=4096, ep=(8192, 16384, 4096), wmma=(2048, 2048, 1004), other=2048,
               clamp=4096, batched=(16, 1024), int8=4096, grad=2048)


def _gen_ep_operands(torch, gen, dtype, n, count):
    """``count`` (N,) epilogue operands: fp32 for integer inputs, the input
    type else; the clamp's as (lo, hi) with lo < hi."""
    odt = dtype if dtype.is_floating_point else torch.float32
    ops = [signed(torch, (n,), odt, gen) * (1 if dtype.is_floating_point else 20)
           for _ in range(count)]
    if count == 2:  # clamp2's bounds
        ops = [-(ops[0].abs() + 0.25), ops[1].abs() + 0.25]
    return ops


def gen_b3_case(torch, gen, case):
    """One GEN_B3_CASES case through the front door against the plain
    version; returns the largest abs error."""
    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import vpu
    name, dt, out, ta, tb, bsz, m, n, k, values, layout, bcast = case
    sr = user_semirings()[name]
    dtype = getattr(torch, dt)
    a = wide_operand(torch, gen, *((k, m) if ta else (m, k)), dtype, values, layout,
                     () if bsz is None or bcast == "a" else (bsz,))
    b = wide_operand(torch, gen, *((n, k) if tb else (k, n)), dtype, values, layout,
                     () if bsz is None or bcast == "b" else (bsz,))
    before = sum(vpu.vpu_matmul.generated_launches.values())
    got = front(lambda: matmul(a, b, semiring=sr, transpose_a=ta, transpose_b=tb,
                               out_dtype=out))
    if sum(vpu.vpu_matmul.generated_launches.values()) != before + 1:
        raise AssertionError(f"B3 generated {case}: not one generated launch")
    cfg = default_config(dtype, semiring=name, out_dtype=out)
    want = vpu.vpu_matmul_plain(a, b, cfg=cfg, sr=sr, transpose_a=ta, transpose_b=tb)
    exact = name in ("user_max_plus", "max_xor") or not dtype.is_floating_point
    rtol = 0.0 if exact else (BF16_RTOL if got.dtype == torch.bfloat16 else 1e-3)
    return compare(torch, got, want, rtol, f"B3 generated {case}", scaled=True)[0]


def gen_epilogue_operands(torch, gen, case):
    """(a, b, epilogue operands, callable) of a GEN_EPILOGUE_CASES case."""
    name, dt, out, ta, tb, bsz, m, n, k, layout, bcast, _ = case
    dtype = getattr(torch, dt)
    fn, count = user_epilogues()[name]
    a = wide_operand(torch, gen, *((k, m) if ta else (m, k)), dtype, "rand", layout,
                     () if bsz is None or bcast == "a" else (bsz,))
    b = wide_operand(torch, gen, *((n, k) if tb else (k, n)), dtype, "rand", layout,
                     () if bsz is None or bcast == "b" else (bsz,))
    return a, b, _gen_ep_operands(torch, gen, dtype, n, count), fn


def gen_epilogue_case(torch, gen, case):
    """One GEN_EPILOGUE_CASES case through the front door against the plain
    version, its route checked (and relu_bias against the registered
    bias_relu, bit for bit); returns the largest abs error."""
    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    name, dt, out, ta, tb, bsz, _, _, _, _, _, route = case
    a, b, eps, fn = gen_epilogue_operands(torch, gen, case)
    kw = dict(transpose_a=ta, transpose_b=tb, out_dtype=out)
    before = sum(mxu.generated_launches.values())
    got = front(lambda: matmul(a, b, epilogue=fn, epilogue_operands=eps, **kw))
    wrapper = mxu.mxu_matmul if a.ndim == b.ndim == 2 or (
        a.ndim == 3 and b.ndim == 2 and not ta) else mxu.mxu_matmul_batched
    if sum(mxu.generated_launches.values()) != before + 1 or wrapper.last_route != route:
        raise AssertionError(f"B1 / B2 generated {case}: route {wrapper.last_route}, "
                             f"generated {dict(mxu.generated_launches)}")
    cfg = default_config(getattr(torch, dt), out_dtype=out)
    want = mxu.mxu_matmul_plain(a, b, *(e.reshape(1, -1) for e in eps), cfg=cfg,
                                transpose_a=ta, transpose_b=tb, epilogue=get_epilogue(fn))
    err = compare(torch, got, want, wide_rtol(torch, got.dtype, False),
                  f"B1 / B2 generated {case}", scaled=True)[0]
    if name == "relu_bias":
        reg = matmul(a, b, epilogue="bias_relu", epilogue_operands=eps, **kw)
        if not torch.equal(got, reg):
            raise AssertionError(f"{case}: relu(acc + b) differs from bias_relu")
    return err


def plain_calls():
    """Plain-version runs of B1 / B2 and B3 on CUDA tensors so far."""
    from gemm_hls_tpu_torch.ops import mxu, vpu
    return mxu.mxu_matmul_plain.cuda_calls + vpu.vpu_matmul_plain.cuda_calls


def front(fn):
    """A front-door call, which must run no plain version on the card."""
    before = plain_calls()
    out = fn()
    if plain_calls() != before:
        raise AssertionError("a custom semiring or callable epilogue ran its plain "
                             "version on CUDA tensors")
    return out


def phase31_specs(torch):
    """(source, entry) of every generated library phases 31 and 32 run:
    their case tables' and main paths', as the front door derives them."""
    from gemm_hls_tpu_torch.ops import codegen, mxu, vpu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    b3 = {(c[0], c[1]) for c in GEN_B3_CASES} | {
        ("plus_max", "float32"), ("user_max_plus", "float32"), ("user_log", "float32"),
        ("plus_max", "int8"), ("user_max_plus", "float64")}
    # (callable, route, dtype, ta, tb, float64 tile): the tile as the route
    # rule picks it (the main path's 2048^3 float64 operands are aligned).
    eps = {(c[0], c[-1], c[1], c[3], c[4],
            mxu.dmma_tile(aligned_case((c[1], c[2], *c[3:9], "rand", *c[9:11])))
            if c[-1] == "dmma" else None) for c in GEN_EPILOGUE_CASES} | {
        ("silu_bias", "wgmma", "bfloat16", False, False, None),
        ("relu_bias", "wgmma", "bfloat16", False, False, None),
        ("relu_bias", "wmma", "bfloat16", False, False, None),
        ("relu_bias", "simt", "float32", False, False, None),
        ("relu_bias", "dmma", "float64", False, False, "tma"),
        ("clamp2", "wgmma", "bfloat16", False, False, None),
        ("relu_bias", "wgmma", "int8", False, True, None),
        ("silu_bias", "simt", "float32", False, False, None)}
    specs = {}
    for name, dt in sorted(b3):
        dtype = getattr(torch, dt)
        spec = codegen.semiring_spec(user_semirings()[name], dtype, vpu._KERNEL_DTYPES[dtype])
        specs[spec[0]] = spec
    for name, route, dt, ta, tb, tile in sorted(eps, key=str):
        dtype = getattr(torch, dt)
        fn, count = user_epilogues()[name]
        acc = {torch.float64: torch.float64}.get(dtype, torch.float32
                                                 if dtype.is_floating_point else torch.int32)
        odt = dtype if dtype.is_floating_point else torch.float32
        spec = codegen.epilogue_spec(fn, route, dtype, acc, [odt] * count, ta, tb,
                                     get_epilogue(fn).name, tile)
        specs[spec[0]] = spec
    return list(specs.values())


class GeneratedBuilds:
    """Phase 31's generated libraries built in a thread, started beside phase
    2's library build and waited for at its end, so they share its CPU time
    and no later phase's (``_build.generated_libraries``: one nvcc each, at
    most one a core at once)."""

    def __init__(self, torch):
        from gemm_hls_tpu_torch import _build
        self.specs = phase31_specs(torch)
        self.error, self.seconds = None, None
        self._thread = threading.Thread(target=self._run, args=(_build,), daemon=True)
        self._thread.start()

    def _run(self, build):
        t0 = time.perf_counter()
        try:
            build.generated_libraries(self.specs)
        except Exception as e:  # noqa: BLE001 (raised again by wait())
            self.error = e
        self.seconds = time.perf_counter() - t0

    def wait(self):
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.seconds


_LOAD_GENERATED = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from gemm_hls_tpu_torch import _build
def no_nvcc():
    raise RuntimeError("nvcc was called")
_build._nvcc = no_nvcc
specs = [tuple(s) for s in json.load(open(sys.argv[2]))]
fns = _build.generated_libraries(specs)
print(len(fns), _build.generated_builds)
"""


def phase_slice22(torch, builds):
    """Phase 31: slice 22's generated functors.  (a) the builds started at
    phase 2 (their seconds and registers), a second lookup and a fresh
    process that loads every library with no nvcc; the case tables; then,
    launch counts set to 0 just before and read just after, the main path
    through the front door with no plain version run on the card: (b) B3
    with user semirings at fp32 4096^3 and int8, (c) callable epilogues on
    every route, batched, int8, a gradient; then (d) the times.  Returns
    the readings for the kernels line."""
    import os

    from gemm_hls_tpu_torch import _build, matmul
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.models.perf_model import H100
    from gemm_hls_tpu_torch.ops import codegen, mxu, vpu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    from gemm_hls_tpu_torch.ops.semiring import get_semiring

    t_start = time.perf_counter()
    gen_s = builds.wait()
    rows = []
    for src, _ in builds.specs:
        log_path = _build.generated_path(src).with_suffix(".log")
        text = log_path.read_text() if log_path.exists() else ""
        head = text.splitlines()[0] if text else "(loaded, no build log)"
        regs = sorted({ln.split("Used ", 1)[1].split(",")[0] for ln in text.splitlines()
                       if "Used " in ln and "registers" in ln})
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln
                         and not ln.strip().endswith("0 bytes spill stores, 0 bytes spill loads")})
        kind = src.split("// Generated by gemm_hls_tpu_torch/ops/codegen.py: ", 1)[1]
        rows.append(f"{head[3:]} | {kind.splitlines()[0][:70]} | {', '.join(regs)}"
                    + (f" | spills {spills}" if spills else ""))
    before = _build.generated_builds
    t0 = time.perf_counter()
    _build.generated_libraries(builds.specs)
    lookup_s = time.perf_counter() - t0
    if _build.generated_builds != before:
        raise AssertionError("31a: a second lookup built a generated library")
    with tempfile.TemporaryDirectory() as tmp:
        spec_file = os.path.join(tmp, "specs.json")
        with open(spec_file, "w") as f:
            json.dump(builds.specs, f)
        child = subprocess.run([sys.executable, "-c", _LOAD_GENERATED, str(REPO), spec_file],
                               capture_output=True, text=True, timeout=300)
    if child.returncode or child.stdout.split() != [str(len(builds.specs)), "0"]:
        raise AssertionError(f"31a: a fresh process did not load the generated libraries "
                             f"without nvcc: {child.stdout} {child.stderr[-2000:]}")
    log(f"phase 31a: {len(builds.specs)} generated libraries in {gen_s:.1f} s beside phase 2's "
        f"build ({_build.generated_builds} built here); a second lookup {lookup_s * 1e3:.1f} ms, "
        f"no build; a fresh process loaded all {len(builds.specs)} with no nvcc. Each: nvcc "
        f"seconds | functor | registers" + "".join(f"\n  {r}" for r in rows))

    gen = torch.Generator(device="cuda").manual_seed(22)
    worst = max(gen_b3_case(torch, gen, c) for c in GEN_B3_CASES)
    log(f"phase 31a: B3 user-semiring cases, {len(GEN_B3_CASES)} (four layouts, NaN / +-inf, "
        f"odd pitches and K tails, batched and broadcast, bf16 / int8 / int32, 1 x 1 x 1): ok "
        f"(worst abs err {worst:.3e})")
    worst = max(gen_epilogue_case(torch, gen, c) for c in GEN_EPILOGUE_CASES)
    routes = sorted({c[-1] for c in GEN_EPILOGUE_CASES})
    log(f"phase 31a: B1 / B2 callable-epilogue cases, {len(GEN_EPILOGUE_CASES)}, routes "
        f"{routes} checked each, relu(acc + b) equal to bias_relu bit for bit: ok (worst abs "
        f"err {worst:.3e})")

    # ---- the main path ------------------------------------------------------
    reset_counters()
    t0 = time.perf_counter()
    srs = user_semirings()
    n = SLICE22["b3"]
    f32, bf16 = torch.float32, torch.bfloat16
    x = signed(torch, (n, n), f32, gen)
    y = signed(torch, (n, n), f32, gen)
    cfg_sr = {name: default_config(f32, semiring=name) for name in srs}
    b3 = {}
    got = front(lambda: matmul(x, y, semiring=srs["plus_max"]))
    b3["plus_max"] = compare(torch, got, vpu.vpu_matmul_plain(
        x, y, cfg=cfg_sr["plus_max"], sr=srs["plus_max"]), 1e-3, "31b plus_max", scaled=True)[0]
    got = front(lambda: matmul(x, y, semiring=srs["user_max_plus"]))
    if not torch.equal(got, matmul(x, y, semiring="max_plus")):
        raise AssertionError("31b: the user max_plus differs from the built-in")
    b3["user_max_plus"] = compare(torch, got, vpu.vpu_matmul_plain(
        x, y, cfg=cfg_sr["user_max_plus"], sr=srs["user_max_plus"]), 0.0, "31b max_plus")[0]
    got = front(lambda: matmul(x, y, semiring=srs["user_log"]))
    b3["user_log"] = compare(torch, got, matmul(x, y, semiring="log_plus"), 1e-3,
                             "31b user log vs log_plus", scaled=True)[0]
    x8 = wide_operand(torch, gen, n, n, torch.int8)
    y8 = wide_operand(torch, gen, n, n, torch.int8)
    got = front(lambda: matmul(x8, y8, semiring=srs["plus_max"]))
    cfg8 = default_config(torch.int8, semiring="plus_max")
    b3["plus_max int8"] = compare(torch, got, vpu.vpu_matmul_plain(
        x8, y8, cfg=cfg8, sr=srs["plus_max"]), 0.0, "31b plus_max int8")[0]
    del got
    log(f"phase 31b: B3 user semirings at {n}^3 vs plain: plus_max fp32 (rel 1e-3) max abs "
        f"{b3['plus_max']:.3e}; user max_plus bit for bit the built-in's and exact; user log "
        f"within 1e-3 of log_plus (max abs {b3['user_log']:.3e}); plus_max int8 exact")

    eps_fns = user_epilogues()
    relu, silu, clamp2 = (eps_fns[k][0] for k in ("relu_bias", "silu_bias", "clamp2"))
    m_e, n_e, k_e = SLICE22["ep"]
    xe = signed(torch, (m_e, k_e), bf16, gen)
    we = signed(torch, (k_e, n_e), bf16, gen) * 0.02
    be = signed(torch, (n_e,), bf16, gen)
    cfg_e = default_config(bf16)
    ep_err, routes = {}, {}

    def held(key, fn, want, rtol, route, bitwise=None):
        got = front(fn)
        wrapper = mxu.mxu_matmul if got.ndim == 2 else mxu.mxu_matmul_batched
        routes[key] = wrapper.last_route
        if routes[key] != route:
            raise AssertionError(f"31c {key}: route {routes[key]}, want {route}")
        ep_err[key] = compare(torch, got, want(), rtol, f"31c {key}", scaled=True)[0]
        if bitwise is not None and not torch.equal(got, bitwise()):
            raise AssertionError(f"31c {key}: differs from the registered bias_relu")

    def plain(a, b, *ops, cfg, fn, **kw):
        return mxu.mxu_matmul_plain(a, b, *(o.reshape(1, -1) for o in ops), cfg=cfg,
                                    epilogue=get_epilogue(fn), **kw)

    held("silu engine", lambda: matmul(xe, we, epilogue=silu, epilogue_operands=(be,)),
         lambda: plain(xe, we, be, cfg=cfg_e, fn=silu), BF16_RTOL, "wgmma")
    held("relu engine", lambda: matmul(xe, we, epilogue=relu, epilogue_operands=(be,)),
         lambda: plain(xe, we, be, cfg=cfg_e, fn=relu), BF16_RTOL, "wgmma",
         lambda: matmul(xe, we, epilogue="bias_relu", epilogue_operands=(be,)))
    mw, nw, kw_ = SLICE22["wmma"]
    xw = signed(torch, (mw, kw_), bf16, gen)  # 2008-byte rows: not 16-byte units
    ww = signed(torch, (kw_, nw), bf16, gen)
    bw = signed(torch, (nw,), f32, gen)
    held("relu wmma", lambda: matmul(xw, ww, epilogue=relu, epilogue_operands=(bw,)),
         lambda: plain(xw, ww, bw, cfg=cfg_e, fn=relu), BF16_RTOL, "wmma",
         lambda: matmul(xw, ww, epilogue="bias_relu", epilogue_operands=(bw,)))
    no = SLICE22["other"]
    xs_, ws_, bs_ = (signed(torch, s, f32, gen) for s in ((no, no), (no, no), (no,)))
    held("relu simt", lambda: matmul(xs_, ws_, epilogue=relu, epilogue_operands=(bs_,)),
         lambda: plain(xs_, ws_, bs_, cfg=default_config(f32), fn=relu), F32_RTOL, "simt",
         lambda: matmul(xs_, ws_, epilogue="bias_relu", epilogue_operands=(bs_,)))
    f64 = torch.float64
    xd, wd, bd = (signed(torch, s, f64, gen) for s in ((no, no), (no, no), (no,)))
    held("relu dmma", lambda: matmul(xd, wd, epilogue=relu, epilogue_operands=(bd,)),
         lambda: plain(xd, wd, bd, cfg=default_config(f64), fn=relu), 1e-9, "dmma",
         lambda: matmul(xd, wd, epilogue="bias_relu", epilogue_operands=(bd,)))
    nc = SLICE22["clamp"]
    xc, wc = signed(torch, (nc, nc), bf16, gen), signed(torch, (nc, nc), bf16, gen)
    lo, hi = _gen_ep_operands(torch, gen, f32, nc, 2)
    held("clamp2 engine", lambda: matmul(xc, wc, epilogue=clamp2, epilogue_operands=(lo, hi)),
         lambda: plain(xc, wc, lo, hi, cfg=cfg_e, fn=clamp2), BF16_RTOL, "wgmma")
    bsz, nb = SLICE22["batched"]
    xb, wb = signed(torch, (bsz, nb, nb), bf16, gen), signed(torch, (bsz, nb, nb), bf16, gen)
    bb = signed(torch, (nb,), bf16, gen)
    held("relu batched engine", lambda: matmul(xb, wb, epilogue=relu, epilogue_operands=(bb,)),
         lambda: plain(xb, wb, bb, cfg=cfg_e, fn=relu), BF16_RTOL, "wgmma",
         lambda: matmul(xb, wb, epilogue="bias_relu", epilogue_operands=(bb,)))
    ni = SLICE22["int8"]
    xi = wide_operand(torch, gen, ni, ni, torch.int8)
    wi = wide_operand(torch, gen, ni, ni, torch.int8)  # held (N, K): K-major
    bi = signed(torch, (ni,), f32, gen) * 1e4
    cfg_i = default_config(torch.int8, out_dtype="float32")
    held("relu int8 engine", lambda: matmul(xi, wi, transpose_b=True, out_dtype="float32",
                                            epilogue=relu, epilogue_operands=(bi,)),
         lambda: plain(xi, wi, bi, cfg=cfg_i, fn=relu, transpose_b=True), F32_RTOL, "wgmma",
         lambda: matmul(xi, wi, transpose_b=True, out_dtype="float32", epilogue="bias_relu",
                        epilogue_operands=(bi,)))
    ng = SLICE22["grad"]
    xg, wg_, bg = (signed(torch, s, f32, gen) for s in ((ng, ng), (ng, ng), (ng,)))
    cot = signed(torch, (ng, ng), f32, gen)
    leaves = [t.clone().requires_grad_() for t in (xg, wg_, bg)]
    front(lambda: matmul(leaves[0], leaves[1], epilogue=silu,
                         epilogue_operands=(leaves[2],)).backward(cot))
    routes["silu gradient"] = mxu.mxu_matmul.last_route  # the backward's last GEMM
    ref = [t.clone().requires_grad_() for t in (xg, wg_, bg)]
    torch.nn.functional.silu(torch.matmul(ref[0], ref[1]) + ref[2]).backward(cot)
    grad_err = [compare(torch, g_.grad, w_.grad, F32_RTOL, f"31c gradient d{nm}", scaled=True)[0]
                for nm, g_, w_ in zip(("x", "w", "b"), leaves, ref)]
    del leaves, ref, cot
    launches = dict(counters(), routes=dict(mxu.route_launches),
                    generated_epilogue=dict(mxu.generated_launches),
                    generated_b3=dict(vpu.vpu_matmul.generated_launches))
    main_s = time.perf_counter() - t0
    log(f"phase 31c: callable epilogues vs plain: " + "; ".join(
        f"{k} ({routes[k]}) {v:.3e}" for k, v in ep_err.items())
        + f"; relu(acc + b) bit for bit bias_relu on engine, WMMA, CUDA cores, dmma, batched "
          f"and int8; silu gradient at fp32 {ng}^3 (B1 on {routes['silu gradient']}) vs "
          f"plain autograd: max abs err dx {grad_err[0]:.3e}, dw {grad_err[1]:.3e}, "
          f"db {grad_err[2]:.3e}")
    log(f"phase 31: main-path launches {launches}; plain-version runs on the card inside the "
        f"front-door calls: 0")
    need = {("wgmma", "bfloat16"), ("wmma", "bfloat16"), ("simt", "float32"),
            ("dmma", "float64"), ("wgmma", "int8")}
    if any(not mxu.generated_launches[key] for key in need) or set(
            vpu.vpu_matmul.generated_launches) != {"float32", "int8"}:
        raise AssertionError(f"phase 31: a generated kernel of the path was not launched: "
                             f"{launches}")

    # ---- (d) times, in turns on CUDA events (comparison launches) ----------
    readings = {}
    sem = {k: get_semiring(k) for k in ("min_plus", "max_plus")}
    t = event_turns(torch, {
        "plus_max": lambda: vpu.vpu_matmul(x, y, cfg=cfg_sr["plus_max"], sr=srs["plus_max"]),
        "user_max_plus": lambda: vpu.vpu_matmul(x, y, cfg=cfg_sr["user_max_plus"],
                                                sr=srs["user_max_plus"]),
        "min_plus": lambda: vpu.vpu_matmul(x, y, cfg=default_config(f32, semiring="min_plus"),
                                           sr=sem["min_plus"]),
        "max_plus": lambda: vpu.vpu_matmul(x, y, cfg=default_config(f32, semiring="max_plus"),
                                           sr=sem["max_plus"])}, rounds=3, iters=2)
    t.update(event_turns(torch, {
        "plain": lambda: vpu.vpu_matmul_plain(x, y, cfg=cfg_sr["plus_max"], sr=srs["plus_max"]),
        "plain_max_plus": lambda: vpu.vpu_matmul_plain(x, y, cfg=cfg_sr["user_max_plus"],
                                                       sr=srs["user_max_plus"])},
        rounds=1, iters=1))
    readings["B3 generated"] = dict(
        ms=t["plus_max"], plain_ms=t["plain"], library_ms=None, max_abs_err=b3["plus_max"],
        bound=H100.bound(2.0 * n ** 3, H100.vpu_ops, 3 * n * n * 4),
        user_max_plus_ms=t["user_max_plus"], user_max_plus_plain_ms=t["plain_max_plus"],
        builtin_min_plus_ms=t["min_plus"], builtin_max_plus_ms=t["max_plus"],
        max_abs_err_by_semiring=b3)
    bias_relu = get_epilogue("bias_relu")

    def ep_bound(a, b, out_bytes, bias):
        """Inputs read once (A, B, the bias), the output written once."""
        (m_, k_), n_ = a.shape, b.shape[1]
        return H100.bound(2.0 * m_ * n_ * k_, H100.peak_for(a.dtype),
                          (m_ * k_ + k_ * n_) * a.element_size() + m_ * n_ * out_bytes
                          + n_ * bias.element_size())

    def gen_call(a, b, bias, fn, cfg):
        return mxu.mxu_matmul(a, b, bias, cfg=cfg, epilogue=get_epilogue(fn))

    t = event_turns(torch, {
        "silu": lambda: gen_call(xe, we, be, silu, cfg_e),
        "relu": lambda: gen_call(xe, we, be, relu, cfg_e),
        "bias_relu": lambda: mxu.mxu_matmul(xe, we, be, cfg=cfg_e, epilogue=bias_relu),
        "library": lambda: torch._addmm_activation(be, xe, we)}, rounds=3, iters=10)
    t.update(event_turns(torch, {
        "plain_silu": lambda: plain(xe, we, be, cfg=cfg_e, fn=silu),
        "plain_relu": lambda: plain(xe, we, be, cfg=cfg_e, fn=relu)}, rounds=1, iters=3))
    readings["B1 generated epilogue wgmma"] = dict(
        ms=t["silu"], plain_ms=t["plain_silu"], library_ms=None,
        max_abs_err=ep_err["silu engine"], bound=ep_bound(xe, we, 2, be),
        relu_ms=t["relu"], relu_plain_ms=t["plain_relu"], bias_relu_ms=t["bias_relu"],
        addmm_activation_relu_ms=t["library"], kernel_route="wgmma")
    for key, (a, b, bias, cfg, dt) in {
            "wmma": (xw, ww, bw, cfg_e, bf16), "simt": (xs_, ws_, bs_, default_config(f32), f32),
            "dmma": (xd, wd, bd, default_config(f64), f64)}.items():
        t = event_turns(torch, {
            "relu": lambda: gen_call(a, b, bias, relu, cfg),
            "bias_relu": lambda: mxu.mxu_matmul(a, b, bias, cfg=cfg, epilogue=bias_relu),
            "library": lambda: torch._addmm_activation(bias.to(dt), a, b)}, rounds=3, iters=5)
        t.update(event_turns(torch, {"plain": lambda: plain(a, b, bias, cfg=cfg, fn=relu)},
                             rounds=1, iters=2))
        readings[f"B1 generated epilogue {key}"] = dict(
            ms=t["relu"], plain_ms=t["plain"], library_ms=t["library"],
            max_abs_err=ep_err[f"relu {key}"], bound=ep_bound(a, b, a.element_size(), bias),
            bias_relu_ms=t["bias_relu"], kernel_route=key)
    for key, r in readings.items():
        bound_ms = r["bound"][0] * 1e3
        extra = ", ".join(f"{k} {v:.3f}" for k, v in r.items()
                          if k.endswith("_ms") and k not in ("ms", "plain_ms") and v)
        log(f"phase 31d: {key}: {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({r['bound'][1]}), {bound_ms / r['ms']:.1%} of the bound; "
            f"{extra}")
    del x, y, x8, y8, xe, we, xw, ww, xs_, ws_, xd, wd, xc, wc, xb, wb, xi, wi, xg, wg_
    torch.cuda.empty_cache()
    log(f"phase 31: {time.perf_counter() - t_start:.1f} s (main path {main_s:.1f} s); "
        f"{codegen.ITEM} runs on the card")
    return {"launches": launches, "readings": readings}


# ---------------------------------------------------------------------------
# Slice 23: float64 at the card's FP64 rates (phase 32): B1 / B2's TMA tile
# (csrc/dmma_tma.cu) and B3's float64 tile (csrc/simt_gemm.cuh)
# ---------------------------------------------------------------------------

# B1 / B2 float64 on the TMA tile: WIDE_B1_CASES' form, every case aligned
# (aligned_case), so the tile is "tma" (tests/test_torch_kernels.py and
# tests/test_torch_f64_tiles.py parametrise it too).  The four layouts,
# pitched (ragged M, N, K) and dense; K 1, 3, 17 and 200 (off the 16-deep
# slice); 1 x 1 x 1 (pitched); a batch of 70000; a broadcast 2-D a / b;
# every epilogue; bias_gelu and scale_bias batched with A transposed; +-inf
# and NaN; float32 output; several tiles a block (1000 x 1030 x 1100).
DMMA_TMA_CASES = (
    [("float64", "float64", ta, tb, None, 300, 520, 136, "rand", lay, None, None, "dmma")
     for ta, tb in LAYOUTS for lay in ("pitched", "dense")]
    + [("float64", "float64", ta, tb, None, 129, 257, k, "rand", "pitched", None, None, "dmma")
       for (ta, tb), k in zip(LAYOUTS, (1, 3, 17, 200))]
    + [("float64", "float64", False, False, None, 1, 1, 1, "rand", "pitched", None, None,
        "dmma"),
       ("float64", "float64", True, True, None, 1000, 1030, 1100, "rand", "pitched", None,
        None, "dmma"),
       ("float64", "float64", False, True, 70_000, 3, 8, 8, "rand", "dense", None, None, "dmma"),
       ("float64", "float64", False, False, 5, 130, 264, 200, "rand", "pitched", "a", None,
        "dmma"),
       ("float64", "float64", True, True, 5, 130, 264, 200, "rand", "pitched", "b", None,
        "dmma"),
       ("float64", "float64", False, False, None, 64, 72, 100, "edge", "dense", None, None,
        "dmma"),
       ("float64", "float32", True, False, None, 300, 520, 136, "rand", "dense", None, None,
        "dmma")]
    + [("float64", "float64", False, False, None, 300, 520, 136, "rand", "dense", None, ep,
        "dmma") for ep in EPILOGUES]
    + [("float64", "float64", True, False, 3, 130, 264, 66, "rand", "pitched", None, ep, "dmma")
       for ep in ("bias_gelu", "scale_bias")]
)
# B3 float64's Num gate: (semiring, fill).  fill: "pos_inf" (+inf in 3% of
# A and of B), "neg_inf" (-inf), "both" (+inf in A, -inf in B), "nan" (NaN
# in A), "inf_zero" (+inf in A, exact zeros in B); 3% of a block's 128 x 16
# slice is ~60 values, so every slice of every block holds them and takes
# the form ``ops.vpu.num_gate`` names for the whole operands.
F64_GATE_FILLS = ("pos_inf", "neg_inf", "both", "nan", "inf_zero")
F64_GATE_CASES = tuple((sr, fill) for sr in ("min_plus", "max_plus", "max_min", "min_max",
                                               "max_times") for fill in F64_GATE_FILLS)
F64_GATE_SHAPE = (256, 384, 320)  # M, N, K: 2 x 3 blocks, 20 full slices each
# The race check of the TMA tile: each (M, N, K, ta, tb) launched
# DMMA_TMA_REPEATS times, the same bits each and the first against plain
# (the stage release once let a refill overwrite fragments in flight).
DMMA_TMA_REPEAT_CASES = ((8192, 8192, 8192, False, False), (8192, 8192, 8192, False, True),
                         (4096, 4096, 4096, False, False), (4096, 4096, 4096, False, True),
                         (4096, 4096, 4096, True, False), (4096, 4096, 4096, True, True),
                         (3968, 4224, 4112, False, False))
DMMA_TMA_REPEATS = 100
# The main path's shapes (phase 32).
SLICE23 = dict(f64=8192, oracle=2048, batched=(16, 1024), grad=4096, ep=2048,
               unaligned=(4097, 4095, 4093), b3=4096, apsp=4096, times=(8192, 4096, 2048),
               log_plus=2048)


def f64_gate_operands(torch, gen, fill, m, n, k):
    """(a, b) of an F64_GATE_CASES fill: U(-1, 1) float64 with 3% of the
    values replaced."""
    a = torch.rand((m, k), generator=gen, device="cuda", dtype=torch.float64) * 2 - 1
    b = torch.rand((k, n), generator=gen, device="cuda", dtype=torch.float64) * 2 - 1
    inf, nan = float("inf"), float("nan")
    va, vb = {"pos_inf": (inf, inf), "neg_inf": (-inf, -inf), "both": (inf, -inf),
              "nan": (nan, None), "inf_zero": (inf, 0.0)}[fill]
    for x, v in ((a, va), (b, vb)):
        if v is not None:
            x[torch.rand(x.shape, generator=gen, device="cuda") < 0.03] = v
    return a, b


def f64_gate_case(torch, gen, case):
    """One F64_GATE_CASES case on B3 float64 against the plain version, bit
    for bit, and the slices' forms against ``num_gate``; returns the form
    that ran ("num" or "nan_keeping")."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import vpu
    from gemm_hls_tpu_torch.ops.semiring import get_semiring
    sr, fill = case
    m, n, k = F64_GATE_SHAPE
    a, b = f64_gate_operands(torch, gen, fill, m, n, k)
    kw = dict(cfg=default_config(torch.float64, semiring=sr), sr=get_semiring(sr))
    vpu.f64_slice_forms(reset=True)
    got = vpu.vpu_matmul(a, b, **kw)
    fast, slow = vpu.f64_slice_forms(reset=True)
    compare(torch, got, vpu.vpu_matmul_plain(a, b, **kw), 0.0, f"B3 float64 gate {case}")
    want = vpu.num_gate(sr, a, b)
    if (want and (slow or not fast)) or (not want and (fast or not slow)):
        raise AssertionError(f"B3 float64 gate {case}: slices {fast} Num / {slow} NaN-keeping, "
                             f"num_gate says {want}")
    return "num" if want else "nan_keeping"


def dmma_tma_repeats(torch, gen, repeats=DMMA_TMA_REPEATS):
    """DMMA_TMA_REPEAT_CASES on the TMA tile, ``repeats`` launches each: the
    same bits every launch, the first within rtol 1e-9 of the plain
    version."""
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.ops import mxu
    cfg = default_config(torch.float64)
    for m, n, k, ta, tb in DMMA_TMA_REPEAT_CASES:
        a = signed(torch, (k, m) if ta else (m, k), torch.float64, gen)
        b = signed(torch, (n, k) if tb else (k, n), torch.float64, gen)
        kw = dict(cfg=cfg, transpose_a=ta, transpose_b=tb)
        first = mxu.mxu_matmul(a, b, **kw)
        if mxu.mxu_matmul.last_dmma_tile != "tma":
            raise AssertionError(f"32f repeats {m, n, k, ta, tb}: tile {mxu.mxu_matmul.last_dmma_tile}")
        compare(torch, first, mxu.mxu_matmul_plain(a, b, **kw), 1e-9,
                f"32f repeats {m, n, k, ta, tb}", scaled=True)
        for i in range(repeats - 1):
            if not torch.equal(mxu.mxu_matmul(a, b, **kw), first):
                raise AssertionError(f"32f repeats {m, n, k, ta, tb}: launch {i + 2} differs")


def apsp_adjacency(torch, gen, n, dtype):
    """Phase 11e's sparse graph: integer weights 1-9 on ~4 edges a node,
    +inf off the edges (every path sum exact)."""
    w = torch.randint(1, 10, (n, n), generator=gen, device="cuda").to(dtype)
    keep = torch.rand((n, n), generator=gen, device="cuda") < 4.0 / n
    return torch.where(keep, w, torch.full_like(w, float("inf")))


def ptxas_report(log_text, fragment):
    """{entry function: its registers and spill line} of the library log's
    entries whose name contains ``fragment``."""
    out, entry = {}, None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else None
        elif entry and fragment in entry and ("registers" in ln or "spill" in ln):
            out.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def phase_slice23(torch, lib_log):
    """Phase 32: slice 23's float64 tiles.  The case tables first
    (DMMA_TMA_CASES, F64_GATE_CASES, a user float64 semiring); then, launch
    counts set to 0 just before and read just after, the main path through
    the front door: (a) B1 / B2 float64 on the TMA tile (8192^3, 2048^3 in
    four layouts against numpy, batched with epilogues, the gradient, a
    callable epilogue) and on the cp.async tile (an unaligned product); (b)
    B3 min_plus float64 at 4096^3 and float64 APSP at n = 4096; then (c)
    the times in turns.  Returns the readings for the kernels line."""
    import numpy as np

    from gemm_hls_tpu_torch import matmul
    from gemm_hls_tpu_torch.config import default_config
    from gemm_hls_tpu_torch.models import graph
    from gemm_hls_tpu_torch.models.perf_model import H100
    from gemm_hls_tpu_torch.ops import mxu, vpu
    from gemm_hls_tpu_torch.ops.epilogue import get_epilogue
    from gemm_hls_tpu_torch.ops.semiring import get_semiring

    t_start = time.perf_counter()
    f64 = torch.float64
    gen = torch.Generator(device="cuda").manual_seed(23)
    if not all(aligned_case(c) for c in DMMA_TMA_CASES):
        raise AssertionError("32f: a DMMA_TMA_CASES case is not aligned")
    worst = max(wide_b1_case(torch, gen, c) for c in DMMA_TMA_CASES)
    log(f"phase 32f: B1 / B2 float64 TMA-tile cases, {len(DMMA_TMA_CASES)} (four layouts, "
        f"ragged M / N / K, K 1 / 3 / 17 / 200, 1 x 1 x 1, batch 70000, broadcast, every "
        f"epilogue, +-inf / NaN, float32 out), route dmma and tile tma checked each: ok (worst "
        f"abs err {worst:.3e})")
    dmma_tma_repeats(torch, gen)
    log(f"phase 32f: the TMA tile's race check, {DMMA_TMA_REPEATS} launches each of "
        + ", ".join(f"{m}x{n}x{k} {'t' if ta else 'n'}{'t' if tb else 'n'}"
                    for m, n, k, ta, tb in DMMA_TMA_REPEAT_CASES)
        + ": the same bits, the first vs plain within 1e-9")
    forms = {c: f64_gate_case(torch, gen, c) for c in F64_GATE_CASES}
    log("phase 32f: B3 float64 gate cases, bit for bit vs plain, the form each slice ran "
        "counted and equal to num_gate's: "
        + ", ".join(f"{sr} {fill} {form}" for (sr, fill), form in forms.items()))
    user = user_semirings()["user_max_plus"]
    for fill in ("pos_inf", "nan"):
        a, b = f64_gate_operands(torch, gen, fill, *F64_GATE_SHAPE)
        before = vpu.vpu_matmul.generated_launches["float64"]
        got = matmul(a, b, semiring=user)
        if vpu.vpu_matmul.generated_launches["float64"] != before + 1:
            raise AssertionError("32f: the user float64 semiring was not one generated launch")
        compare(torch, got, vpu.vpu_matmul_plain(
            a, b, cfg=default_config(f64, semiring="max_plus"), sr=user), 0.0,
            f"32f user max_plus float64 {fill}")
    log("phase 32f: a user float64 max_plus (generated, launch_simt_f64) with +inf and with "
        "NaN operands vs plain: bit for bit")

    # ---- the main path ------------------------------------------------------
    reset_counters()
    vpu.f64_slice_forms(reset=True)
    t0 = time.perf_counter()
    cfg64 = default_config(f64)

    def on_tile(what, fn, tile, launches=1):
        before = mxu.dmma_tile_launches[tile]
        out = fn()
        if mxu.dmma_tile_launches[tile] - before != launches:
            raise AssertionError(f"32a {what}: not {launches} launch(es) on the {tile} tile "
                                 f"({dict(mxu.dmma_tile_launches)})")
        return out

    n = SLICE23["f64"]
    a, b = signed(torch, (n, n), f64, gen), signed(torch, (n, n), f64, gen)
    got = on_tile(f"{n}^3", lambda: matmul(a, b), "tma")
    err_a = compare(torch, got, mxu.mxu_matmul_plain(a, b, cfg=cfg64), 1e-9,
                    f"32a float64 {n}^3", scaled=True)
    del got
    no = SLICE23["oracle"]
    oracle = {}
    for ta, tb in LAYOUTS:
        x, y = signed(torch, (no, no), f64, gen), signed(torch, (no, no), f64, gen)
        got = on_tile(f"{no}^3 {ta, tb}", lambda: matmul(x, y, transpose_a=ta, transpose_b=tb),
                      "tma")
        xn, yn = x.cpu().numpy(), y.cpu().numpy()
        want = torch.from_numpy((xn.T if ta else xn) @ (yn.T if tb else yn)).cuda()
        oracle[f"{'t' if ta else 'n'}{'t' if tb else 'n'}"] = compare(
            torch, got, want, 1e-9, f"32a float64 {no}^3 {ta, tb} vs numpy", scaled=True)[1]
    bsz, nb = SLICE23["batched"]
    xb, yb = signed(torch, (bsz, nb, nb), f64, gen), signed(torch, (bsz, nb, nb), f64, gen)
    s_, bias = signed(torch, (nb,), f64, gen), signed(torch, (nb,), f64, gen)
    batched = {}
    for ep, ops in (("bias_gelu", (bias,)), ("scale_bias", (s_, bias))):
        got = on_tile(ep, lambda: matmul(xb, yb, epilogue=ep, epilogue_operands=ops), "tma")
        batched[ep] = compare(torch, got, mxu.mxu_matmul_plain(
            xb, yb, *ops, cfg=cfg64, epilogue=get_epilogue(ep)), 1e-9, f"32a {ep}",
            scaled=True)[0]
    ng = SLICE23["grad"]
    xg = signed(torch, (ng, ng), f64, gen).requires_grad_()
    yg = signed(torch, (ng, ng), f64, gen).requires_grad_()
    cot = signed(torch, (ng, ng), f64, gen)
    on_tile("gradient", lambda: matmul(xg, yg).backward(cot), "tma", launches=3)
    xp, yp = xg.detach().clone().requires_grad_(), yg.detach().clone().requires_grad_()
    torch.matmul(xp, yp).backward(cot)
    grad = [compare(torch, g_, w_, 1e-9, f"32a d{nm}", scaled=True)[0]
            for nm, g_, w_ in (("a", xg.grad, xp.grad), ("b", yg.grad, yp.grad))]
    del xg, yg, xp, yp, cot
    ne = SLICE23["ep"]
    relu = user_epilogues()["relu_bias"][0]
    xe, ye, be = (signed(torch, s, f64, gen) for s in ((ne, ne), (ne, ne), (ne,)))
    before = mxu.generated_launches["dmma", "float64"]
    got = on_tile("callable epilogue", lambda: matmul(xe, ye, epilogue=relu,
                                                      epilogue_operands=(be,)), "tma")
    if mxu.generated_launches["dmma", "float64"] != before + 1:
        raise AssertionError("32a: the callable float64 epilogue was not a generated launch")
    ep_err = compare(torch, got, mxu.mxu_matmul_plain(
        xe, ye, be.reshape(1, -1), cfg=cfg64, epilogue=get_epilogue(relu)), 1e-9,
        "32a relu(acc + b) float64", scaled=True)[0]
    mu, nu, ku = SLICE23["unaligned"]
    xu, yu = signed(torch, (mu, ku), f64, gen), signed(torch, (ku, nu), f64, gen)
    got = on_tile(f"{mu}x{nu}x{ku}", lambda: matmul(xu, yu), "cp_async")
    err_u = compare(torch, got, mxu.mxu_matmul_plain(xu, yu, cfg=cfg64), 1e-9,
                    f"32a float64 {mu}x{nu}x{ku}", scaled=True)[0]
    del got
    log(f"phase 32a: float64 {n}^3 on the TMA tile vs plain: max abs err {err_a[0]:.3e}, "
        f"scaled rel {err_a[1]:.3e}; {no}^3 in four layouts vs numpy, scaled rel "
        + ", ".join(f"{k} {v:.3e}" for k, v in oracle.items())
        + f"; batched {bsz} x {nb}^3 " + ", ".join(f"{k} {v:.3e}" for k, v in batched.items())
        + f"; gradient {ng}^3 (3 launches) dA {grad[0]:.3e}, dB {grad[1]:.3e}; relu(acc + b) "
        f"{ne}^3 {ep_err:.3e}; {mu} x {nu} x {ku} on the cp.async tile {err_u:.3e}")

    nb3 = SLICE23["b3"]
    sem = get_semiring("min_plus")
    cfg_mp = default_config(f64, semiring="min_plus")
    xm, ym = signed(torch, (nb3, nb3), f64, gen), signed(torch, (nb3, nb3), f64, gen)
    got = matmul(xm, ym, semiring="min_plus")
    b3_err = compare(torch, got, vpu.vpu_matmul_plain(xm, ym, cfg=cfg_mp, sr=sem), 0.0,
                     f"32b min_plus float64 {nb3}^3")[0]
    del got
    fin_forms = vpu.f64_slice_forms(reset=True)
    na = SLICE23["apsp"]
    adj = apsp_adjacency(torch, gen, na, f64)
    b3_before = vpu.vpu_matmul.dtype_launches["float64"]
    dist = graph.all_pairs_shortest_paths(adj)
    squarings = vpu.vpu_matmul.dtype_launches["float64"] - b3_before
    apsp_forms = vpu.f64_slice_forms(reset=True)
    want = graph.all_pairs_shortest_paths(
        adj, matmul_fn=lambda x, y: vpu.vpu_matmul_plain(x, y, cfg=cfg_mp, sr=sem))
    compare(torch, dist, want, 0.0, f"32b float64 APSP n={na}")
    del dist, want
    if fin_forms[1] or not fin_forms[0] or apsp_forms[1] or not apsp_forms[0]:
        raise AssertionError(f"32b: B3 float64 slices off the Num form: finite {fin_forms}, "
                             f"APSP {apsp_forms} (Num, NaN-keeping)")
    log(f"phase 32b: min_plus float64 {nb3}^3 vs plain bit for bit ({fin_forms[0]} slices, "
        f"all Num); float64 APSP n={na} ({squarings} B3 launches, +inf off ~4 edges a node) "
        f"vs the plain squarings: exact, {apsp_forms[0]} slices all on the Num form")
    launches = dict(counters(), routes=dict(mxu.route_launches),
                    tiles=dict(mxu.dmma_tile_launches),
                    b3_dtypes=dict(vpu.vpu_matmul.dtype_launches))
    log(f"phase 32: main-path launches {launches}")
    if (not mxu.dmma_tile_launches["tma"] or not mxu.dmma_tile_launches["cp_async"]
            or not vpu.vpu_matmul.dtype_launches["float64"]):
        raise AssertionError(f"phase 32: a kernel of the path was not launched: {launches}")
    main_s = time.perf_counter() - t0

    # ---- (c) times, in turns on CUDA events (comparison launches) ----------
    readings = {}
    e64 = 8
    for nt in SLICE23["times"]:
        x, y = (a, b) if nt == n else (signed(torch, (nt, nt), f64, gen),
                                       signed(torch, (nt, nt), f64, gen))
        t = event_turns(torch, {
            "tma": lambda: mxu.mxu_matmul(x, y, cfg=cfg64),
            "cp_async": lambda: mxu.mxu_matmul(x, y, cfg=cfg64, _dmma_tile="cp_async"),
            "library": lambda: torch.matmul(x, y)})
        readings[f"B1 {nt}^3"] = dict(t, bound=H100.bound(
            2.0 * nt ** 3, H100.peak_for("float64"), 3 * nt * nt * e64))
    t = event_turns(torch, {
        "tma": lambda: mxu.mxu_matmul_batched(xb, yb, cfg=cfg64),
        "cp_async": lambda: mxu.mxu_matmul_batched(xb, yb, cfg=cfg64, _dmma_tile="cp_async"),
        "library": lambda: torch.matmul(xb, yb)})
    readings[f"B2 {bsz}x{nb}^3"] = dict(t, bound=H100.bound(
        2.0 * bsz * nb ** 3, H100.peak_for("float64"), 3 * bsz * nb * nb * e64))
    t = event_turns(torch, {"cp_async": lambda: mxu.mxu_matmul(xu, yu, cfg=cfg64),
                            "library": lambda: torch.matmul(xu, yu)})
    readings[f"B1 {mu}x{nu}x{ku}"] = dict(t, bound=H100.bound(
        2.0 * mu * nu * ku, H100.peak_for("float64"), (mu * ku + ku * nu + mu * nu) * e64))
    plain_b1 = event_turns(torch, {"plain": lambda: mxu.mxu_matmul_plain(a, b, cfg=cfg64)},
                           rounds=1)["plain"]
    for key, r in readings.items():
        bound_ms = r["bound"][0] * 1e3
        log(f"phase 32c: B1 / B2 float64 {key}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in r.items() if k != "bound")
            + f"; bound {bound_ms:.3f} ms ({r['bound'][1]})"
            + (f", the TMA tile {bound_ms / r['tma']:.1%} of it, "
               f"{r['tma'] / r['library']:.3f}x torch.matmul" if "tma" in r else ""))
    del a, b, xb, yb, xu, yu

    b3 = {}
    half_inf = xm.clone()
    half_inf[torch.rand(xm.shape, generator=gen, device="cuda") < 0.5] = float("inf")
    for sr in B3_SEMIRINGS:
        nt = SLICE23["log_plus"] if sr == "log_plus" else nb3
        x, y = (xm, ym) if nt == nb3 else (xm[:nt, :nt], ym[:nt, :nt])
        cfg = default_config(f64, semiring=sr)
        srf = get_semiring(sr)
        fns = {"kernel": lambda: vpu.vpu_matmul(x, y, cfg=cfg, sr=srf)}
        if sr == "min_plus":
            fns["kernel +inf"] = lambda: vpu.vpu_matmul(half_inf, y, cfg=cfg, sr=srf)
        t = event_turns(torch, fns, rounds=3, iters=1 if sr == "log_plus" else 2)
        b3[sr] = dict(t, n=nt, bound=H100.bound(2.0 * nt ** 3, H100.vpu_ops_for("float64", sr),
                                                3 * nt * nt * e64))
    vpu.f64_slice_forms(reset=True)
    plain_b3 = event_turns(torch, {"plain": lambda: vpu.vpu_matmul_plain(
        xm, ym, cfg=cfg_mp, sr=sem)}, rounds=1, iters=1)["plain"]
    for sr, r in b3.items():
        bound_ms = r["bound"][0] * 1e3
        log(f"phase 32c: B3 float64 {sr} {r['n']}^3: {r['kernel']:.3f} ms"
            + (f" (A half +inf: {r['kernel +inf']:.3f} ms, "
               f"{r['kernel +inf'] / r['kernel']:.3f}x)" if "kernel +inf" in r else "")
            + f", bound {bound_ms:.3f} ms, {bound_ms / r['kernel']:.1%} of it")
    # A time under its bound means the bound counts work the function does
    # not need.
    over = [f"{key} {k}" for key, r in readings.items() for k in ("tma", "cp_async")
            if k in r and r[k] < r["bound"][0] * 1e3]
    over += [f"B3 {sr} {k}" for sr, r in b3.items() for k in ("kernel", "kernel +inf")
             if k in r and r[k] < r["bound"][0] * 1e3]
    if over:
        raise AssertionError(f"32c: faster than the bound: {over}")
    if b3["min_plus"]["kernel +inf"] > 1.2 * b3["min_plus"]["kernel"]:
        raise AssertionError("32c: min_plus float64 on +inf-holding operands past 1.2x finite")
    adj32 = adj.float()
    t = event_turns(torch, {"float64": lambda: graph.all_pairs_shortest_paths(adj),
                            "float32": lambda: graph.all_pairs_shortest_paths(adj32)},
                    rounds=3, iters=1)
    apsp = dict(float64_ms=t["float64"], float32_ms=t["float32"], squarings=squarings)
    log(f"phase 32c: APSP n={na}, CUDA events in turns: float64 {t['float64']:.3f} ms, "
        f"float32 {t['float32']:.3f} ms ({squarings} squarings each)")
    del xm, ym, half_inf, adj, adj32
    torch.cuda.empty_cache()

    ptxas = {**ptxas_report(lib_log, "dmma_tma_kernel"), **ptxas_report(lib_log, "simt_f64")}
    log(f"phase 32: {time.perf_counter() - t_start:.1f} s (main path {main_s:.1f} s)")
    return {"launches": launches, "b1": readings, "b3": b3, "apsp": apsp, "ptxas": ptxas,
            "plain_b1_ms": plain_b1, "plain_b3_ms": plain_b3, "b3_max_abs_err": b3_err,
            "b1_err": dict(max_abs_err=err_a[0], oracle_2048_scaled_rel=oracle,
                           batched_max_abs_err=batched, grad_max_abs_err=grad,
                           callable_epilogue_max_abs_err=ep_err, unaligned_max_abs_err=err_u),
            "forms": dict(finite=fin_forms, apsp=apsp_forms,
                          gate={f"{sr} {fill}": f for (sr, fill), f in forms.items()})}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if not (REPO / "gemm_hls_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no gemm_hls_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # Phases 1-25 run with no autotune cache file (their route checks are
    # the route rule's); phase 26 names its caches itself.
    from gemm_hls_tpu_torch.tools import autotune
    packaged_seed = autotune.SEED_CACHE
    no_cache = tempfile.mkdtemp(prefix="no_autotune_cache_")
    autotune.DEFAULT_CACHE = autotune.SEED_CACHE = str(Path(no_cache) / "absent.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1: device {kind} x{torch.cuda.device_count()} ({smi}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from gemm_hls_tpu_torch import _build
    t0 = time.perf_counter()
    # Phase 31's generated libraries build beside the library (phase 31a).
    builds = GeneratedBuilds(torch)
    lib_path = _build.build()
    _build.library()
    gen_s = builds.wait()
    spills, serialised, entry, w8_regs, rs_regs, nvcc_s = [], set(), "", [], [], {}
    lib_log = lib_path.with_suffix(".log").read_text()
    for ln in lib_log.splitlines():
        if ln.startswith("== ") and " s, rc " in ln:  # a source's compile seconds
            name, secs = ln[3:].split(": ", 1)
            nvcc_s[name] = float(secs.split(" s,")[0])
        elif "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "C7515" in ln or "C7518" in ln:  # ptxas serialised the function's wgmma
            serialised.add(ln.split("function '")[-1].rstrip("'"))
        elif "spill" in ln and not ln.strip().endswith(
                "0 bytes spill stores, 0 bytes spill loads"):
            spills.append(f"{entry}: {ln.strip()}")
        elif "w8a8_wg_kernel" in entry and "registers" in ln:
            w8_regs.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
        elif "row_softmax_wg_kernel" in entry and "registers" in ln:
            rs_regs.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
    slowest = max(nvcc_s, key=nvcc_s.get) if nvcc_s else None
    log(f"phase 2: built and loaded {lib_path.name} in "
        f"{time.perf_counter() - t0:.1f} s (phase 31's {len(builds.specs)} generated libraries "
        f"beside it, {gen_s:.1f} s); kernels with spills: {len(spills)}"
        + "".join(f"\n  {x}" for x in spills)
        + f"\nphase 2: kernels whose wgmma ptxas serialised (C7515, C7518): {len(serialised)}"
        + "".join(f"\n  {x}" for x in sorted(serialised))
        + "\nphase 2: the W8A8 engine kernel (csrc/w8a8_wgmma.cu), as ptxas reports it:"
        + "".join(f"\n  {x}" for x in w8_regs)
        + "\nphase 2: the row-softmax engine kernel (csrc/row_softmax_wgmma.cu), as ptxas "
          "reports it:" + "".join(f"\n  {x}" for x in rs_regs)
        + f"\nphase 2: nvcc seconds: row_softmax_wgmma.cu "
          f"{nvcc_s.get('row_softmax_wgmma.cu')}, the slowest {slowest} {nvcc_s.get(slowest)}"
        + "\nphase 2: the float64 tiles (csrc/dmma_tma.cu, nvcc "
          f"{nvcc_s.get('dmma_tma.cu')} s; csrc/semiring_f64.cu, nvcc "
          f"{nvcc_s.get('semiring_f64.cu')} s), as ptxas reports them:"
        + "".join(f"\n  {k}: {v}" for k, v in {
            **ptxas_report(lib_log, "dmma_tma_kernel"),
            **ptxas_report(lib_log, "simt_f64")}.items()))

    phase_b1(torch)
    phase_b3(torch)
    results, launches = phase_main(torch)
    phase_b2(torch)
    phase_grads(torch)
    launches2, row_routes = phase_slice2(torch)
    times = phase_times(torch)
    phase_b45(torch)
    launches3, res3 = phase_slice3(torch)
    times3 = phase_times3(torch)
    phase_flash_kernels(torch)
    launches4, _ = phase_slice4(torch)
    times4 = phase_times4(torch)
    phase_quant_kernels(torch)
    launches5, _ = phase_slice5(torch)
    times5 = phase_times5(torch)
    phase_grouped_update(torch)
    launches6, _ = phase_slice6(torch)
    times6 = phase_times6(torch)
    phase_dist_kernels(torch)
    launches7 = phase_slice7(torch)
    times7 = phase_times7(torch)
    staged = phase_slice16(torch)
    t0 = time.perf_counter()
    phase_slice17(torch, packaged_seed)
    log(f"phase 26: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_slice18(torch)
    log(f"phase 27: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dist19 = phase_slice19(torch)
    log(f"phase 28: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    par20, par20_times, par20_profiles = phase_slice20(torch)
    log(f"phase 29: {time.perf_counter() - t0:.1f} s")
    slice21 = phase_slice21(torch)
    slice22 = phase_slice22(torch, builds)
    t0 = time.perf_counter()
    slice23 = phase_slice23(torch, lib_log)
    log(f"phase 32: {time.perf_counter() - t0:.1f} s")

    from gemm_hls_tpu_torch.models.perf_model import H100, slice_gemm_bound

    def kernel(name, source, replaces, n, t, bound, library_ms):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bound[0] * 1e3,
                "bound_by": bound[1], "library_ms": library_ms}

    slice1 = {key: {"max_abs_err": r["max_abs_err"], "ms": r["seconds"] * 1e3,
                    "plain_ms": r["plain_seconds"] * 1e3}
              for key, r in results.items()}
    bf16, n8 = 2, 8192
    bounds = {
        # Inputs read once, outputs written once, at each kernel's timed shape.
        "B1": H100.bound(2.0 * n8 ** 3, H100.peak_for("bfloat16"), 3 * n8 * n8 * bf16),
        "B1 epilogue": H100.bound(2.0 * 8192 * 16384 * 4096, H100.peak_for("bfloat16"),
                                  (8192 * 4096 + 4096 * 16384 + 8192 * 16384
                                   + 16384) * bf16),
        "B2": times["B2 64x512^3"]["bound"],
        "B2 row-softmax": times["B2 row-softmax"]["bound"],
        "B3": H100.bound(2.0 * 4096 ** 3, H100.vpu_ops, 3 * 4096 * 4096 * 4),
        "B4": slice_gemm_bound(H100, n8, n8, n8, 3, 3),
        "B5": slice_gemm_bound(H100, 2048, 2048, 2048, 8, 8, n_outputs=2),
    }
    b4, b5 = times3["B4 i8x3"], times3["B5 2048"]
    b4_tiers = {p: {key: times3[f"B4 {p}"][key] for key in ("ms", "other_ms", "matmul_ms")}
                for p in ("i8x2", "i8x4")}
    kernels = [
        kernel("mxu_gemm (B1, dense plus_times)",
               "gemm_hls_tpu_torch/csrc/mxu_gemm.cu",
               "gemm_hls_tpu/ops/pallas_mxu.py:69", launches["B1"], slice1["B1"],
               bounds["B1"], slice1["B1"]["plain_ms"]),  # the plain version is torch.matmul
        kernel("mxu_gemm with epilogue (B1 fused bias + activation)",
               "gemm_hls_tpu_torch/csrc/mxu_gemm.cu",
               "gemm_hls_tpu/ops/pallas_mxu.py:103", launches2["B1 epilogue"],
               times["B1 epilogue"], bounds["B1 epilogue"],
               times["B1 epilogue"]["library_ms"]),
        kernel("mxu_gemm batched (B2, plain and per-column epilogue)",
               "gemm_hls_tpu_torch/csrc/mxu_wgmma.cuh",
               "gemm_hls_tpu/ops/pallas_mxu.py:143", launches2["B2"],
               times["B2 64x512^3"], bounds["B2"], times["B2 64x512^3"]["library_ms"]),
        kernel("mxu_gemm_row_softmax (B2, row-softmax epilogue)",
               "gemm_hls_tpu_torch/csrc/row_softmax.cu",
               "gemm_hls_tpu/ops/pallas_mxu.py:176", launches2["B2 row-softmax"],
               times["B2 row-softmax"], bounds["B2 row-softmax"], None),
        kernel("semiring_gemm (B3, generic semiring)",
               "gemm_hls_tpu_torch/csrc/semiring_gemm.cu",
               "gemm_hls_tpu/ops/pallas_vpu.py:56", launches["B3"], slice1["B3"],
               bounds["B3"], None),
        kernel("slice_gemm diagonal (B4, fp32 via int8 slices, i8x3 8192^3)",
               "gemm_hls_tpu_torch/csrc/int8_slices.cu",
               "gemm_hls_tpu/ops/pallas_ozaki.py:77", launches3["B4"], b4,
               bounds["B4"], b4["library_ms"]),
        kernel("slice_gemm hi/lo (B5, f64-class Ozaki, 8 slices 2048^3)",
               "gemm_hls_tpu_torch/csrc/int8_slices.cu",
               "gemm_hls_tpu/ops/pallas_ozaki.py:37", launches3["B5"], b5,
               bounds["B5"], b5["library_ms"]),
    ]
    # B4: the engine route the main path took (csrc/diag_wgmma.cu), the
    # mma.sync kernel in the same turns, and the other tiers.
    kernels[5].update(source="gemm_hls_tpu_torch/csrc/diag_wgmma.cu", kernel_route=b4["route"],
                      other_route=b4["other_route"], other_ms=b4["other_ms"],
                      matmul_ms=b4["matmul_ms"], tiers=b4_tiers,
                      library_note="library_ms is fp32 torch.matmul")
    # B2: the route the main path's aligned bf16 calls take (the engine),
    # the other one (csrc/mxu_gemm.cu's WMMA tile) in the same turns.
    t = times["B2 64x512^3"]
    kernels[2].update(kernel_route=t["route"], other_route=t["other_route"],
                      other_ms=t["other_ms"], library_note="library_ms is torch.bmm")
    # B2's row softmax: the route phase 8c's attention took (the engine,
    # csrc/row_softmax_wgmma.cu), row_softmax.cu in the same turns, and the
    # two-call compositions (no one PyTorch call computes it).
    t = times["B2 row-softmax"]
    kernels[3].update(source="gemm_hls_tpu_torch/csrc/row_softmax_wgmma.cu",
                      kernel_route=row_routes["attention"], other_route=t["other_route"],
                      other_ms=t["other_ms"],
                      fp32_softmax_of_bmm_ms=t["fp32_softmax_of_bmm_ms"],
                      bf16_softmax_of_bmm_ms=t["bf16_softmax_of_bmm_ms"],
                      library_note="no one PyTorch call: two-call compositions beside, "
                                   "torch.softmax(torch.bmm(q, k^T).float(), -1).to(bf16) "
                                   "and torch.softmax(torch.bmm(q, k^T), -1) in bf16")
    # Slice 4 at the causal training shape, (32, 1024, 128) bf16.
    for name, replaces in (
            ("flash_fwd", "gemm_hls_tpu/ops/pallas_flash.py:62,322,467"),
            ("flash_bwd_dq", "gemm_hls_tpu/ops/pallas_flash.py:1018,1166"),
            ("flash_bwd_dkv", "gemm_hls_tpu/ops/pallas_flash.py:1079,1229")):
        t = times4[f"{name} causal"]
        kernels.append(kernel(
            f"{name} (B6-B12 flash attention, causal 32x1024x128 bf16)",
            f"gemm_hls_tpu_torch/csrc/{name}.cu",
            replaces, launches4[name], t, t["bound"], t["library_ms"]))
        # The engine route (csrc/flash_wgmma.cu, csrc/flash_bwd_wgmma.cu) that
        # the main path took; other_ms is the mma.sync tile (flash_fwd.cu,
        # flash_bwd_dq.cu, flash_bwd_dkv.cu) in the same turns.
        kernels[-1].update(source="gemm_hls_tpu_torch/csrc/" + (
            "flash_wgmma.cu" if name == "flash_fwd" else "flash_bwd_wgmma.cu"),
            kernel_route=t["route"], other_route=t["other_route"], other_ms=t["other_ms"])
        if name == "flash_fwd":
            kernels[-1]["library_note"] = f"library_ms is {t['library']}"
        elif name == "flash_bwd_dq":
            kernels[-1]["library_note"] = ("SDPA's backward yields dq, dk and dv in one "
                                           "call: its time is on flash_bwd_dkv, beside "
                                           "the pair")
        elif name == "flash_bwd_dkv":
            kernels[-1].update(pair_ms=t["pair_ms"], pair_delta_ms=t["pair_delta_ms"])
            kernels[-1]["library_note"] = (f"library_ms is {t['library']}'s backward (dq, dk "
                                           "and dv in one call, its delta inside), beside "
                                           "pair_ms = flash_bwd_dq + flash_bwd_dkv and "
                                           "pair_delta_ms, the pair with its delta pass")
    # Slice 5 at the serving shapes.
    for key, name, source, replaces in (
            ("B13 decode 64x2048x2048 int4 g128",
             "dequant_gemm (B13, int4 g128 decode projection 64x2048x2048 bf16)",
             "dequant_wgmma.cu", "pallas_dequant.py:36"),
            ("B14 q/o",
             "w8a8_gemm fused (B14, prefill q / o projection 4096x2048x2048 bf16: quantize "
             "pass + GEMM)", "w8a8_wgmma.cu", "pallas_dequant.py:260"),
            ("B15 q/o",
             "w8a8_gemm two-pass (B15, prefill q / o projection 4096x2048x2048 bf16: quantize "
             "pass + GEMM)", "w8a8_wgmma.cu", "pallas_dequant.py:224"),
            ("B16 w1 prefill 8192 slots",
             "grouped_gemm (B16, MoE w1 8192 slots x 2048 -> 4096, 8 experts bf16)",
             "grouped_wgmma.cu", "pallas_grouped.py:151")):
        t = times5[key]
        kernels.append(kernel(name, f"gemm_hls_tpu_torch/csrc/{source}",
                              f"gemm_hls_tpu/ops/{replaces}", launches5[key[:3]], t,
                              t["bound"], t["library_ms"]))
        if "route" in t:  # B13, B16: the route the main path took, and the other one
            kernels[-1].update(kernel_route=t["route"], other_route=t["other_route"],
                               other_ms=t["other_ms"])
        if key.startswith("B13"):  # device time in turns, host us a call
            kernels[-1].update(plan=t["plan"], host_us=t["host_us"],
                               kv_64x2048x512=t["kv"],
                               library_note="library_ms is xd @ w_deq, bf16 torch.matmul on "
                                            "the dequantized weights")
        if key[:3] in ("B14", "B15"):  # device time in turns, both prefill shapes
            parts = ("gemm_ms", "quantize_ms", "other_gemm_ms", "plan", "mode", "host_us",
                     "library_other_ms", "bf16_matmul_ms")
            kv = times5[f"{key[:3]} k/v"]
            kernels[-1].update({f: t[f] for f in parts})
            kernels[-1]["kv_4096x2048x512"] = dict(
                {f: kv[f] for f in parts + ("ms", "other_ms", "library_ms", "library")},
                bound_ms=kv["bound"][0] * 1e3)
            kernels[-1]["library_note"] = (
                f"library_ms is {t['library']} on the per-row int8 x (the int32 product "
                "alone: no quantize, no scales); library_other_ms the other weight layout; "
                "bf16_matmul_ms bf16 torch.matmul of x and the unquantized weights; ms and "
                "other_ms the whole call (quantize pass + GEMM) on each route")
    # Slice 6 at the training step's w1 gradient shape: the route the main
    # path took (csrc/grouped_update_wgmma.cu), the other in the same turns,
    # and w2's gradient and a skewed routing beside.
    t = times6["B17 w1 grad 8192 slots"]
    kernels.append(kernel(
        "grouped_update (B17, MoE w1 weight gradient 8192 slots x 2048 x 4096, "
        "8 experts bf16)", "gemm_hls_tpu_torch/csrc/grouped_update_wgmma.cu",
        "gemm_hls_tpu/ops/pallas_grouped.py:300", launches6["B17"], t, t["bound"],
        t["library_ms"]))
    w2, skew = times6["B17 w2 grad 8192 slots"], times6["B17 w1 grad 8192 slots skewed 70%"]
    kernels[-1].update(kernel_route=t["route"], other_route=t["other_route"],
                       other_ms=t["other_ms"], w2_ms=w2["ms"], w2_library_ms=w2["library_ms"],
                       skewed_ms=skew["ms"], skewed_library_ms=skew["library_ms"])
    kernels[-1]["library_note"] = f"library_ms is {t['library']}"
    # Slice 7 at bf16 8192^3, the ranks on one card.
    for key, name, source, replaces in (
            (f"B18 {DIST['ring_ranks']} ranks",
             f"ring_gemm (B18 ring, both bodies, bf16 8192^3 over {DIST['ring_ranks']} ranks "
             "on one card)", "ring_gemm.cu", "pallas_ring.py:48,120"),
            (f"B19 p={DIST['cannon_p']}",
             f"cannon_gemm (B19 fused Cannon, bf16 8192^3 on a {DIST['cannon_p']}x"
             f"{DIST['cannon_p']} grid on one card)", "cannon_gemm.cu", "pallas_cannon.py:31")):
        t = times7[key]
        kernels.append(kernel(name, f"gemm_hls_tpu_torch/csrc/{source}",
                              f"gemm_hls_tpu/ops/{replaces}", launches7[key[:3]], t,
                              t["bound"], t["library_ms"]))
        kernels[-1]["library_note"] = "library_ms is bf16 torch.matmul of the whole product"
    # Slice 16's staged path (phase 25a-d): its launches of B1, B3 and B5,
    # and the oversize run's readings on B1.
    path = ("a", "b min_plus", "b plus_times", "c", "d")
    for idx, key in ((0, "B1"), (4, "B3"), (6, "B5")):
        kernels[idx]["staged_launches"] = sum(staged["launches"][p].get(key, 0) for p in path)
    kernels[0]["oversize_32768_bf16"] = staged["oversize"]
    # Slice 19's distributed CA-GEMMs (phase 28): each rank's local kernel.
    for idx, key in ((0, "B1"), (4, "B3"), (6, "B5")):
        kernels[idx]["distributed_launches"] = sum(
            got.get(key, 0) for got in dist19["launches"].values())
    kernels[0]["distributed_bf16_8192_ms"] = dist19["times"]
    # Slice 20's training parallelism (phase 29): each kernel's launches on
    # its runs, and each run's times in turns beside the single-card call.
    by_kernel = {"B1": "mxu_gemm (B1", "flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq",
                 "flash_bwd_dkv": "flash_bwd_dkv", "B16": "grouped_gemm", "B17": "grouped_update"}
    for key, prefix in by_kernel.items():
        entry = next(k for k in kernels if k["name"].startswith(prefix))
        entry["parallel_launches"] = sum(r["launches"].get(key, 0) for r in par20.values()
                                         if isinstance(r, dict) and "launches" in r)
    kernels[0]["parallel_times_ms"] = par20_times
    kernels[0]["parallel_busy"] = {k: v["busy"] for k, v in par20_profiles.items()}
    # Slice 21 (phase 30): the wide operand types, each kernel source with
    # its launches on phase 30's main path.
    r21, l21 = slice21["readings"], slice21["launches"]
    routes21, b3_dt = l21["routes"], l21["b3_dtypes"]
    # Since slice 23 phase 30's aligned float64 operands run on the TMA tile:
    # the entry is named after the tile that ran.
    tma30 = r21["B1 float64"]["tile"] == "tma"
    kernels.append(kernel(
        f"{'dmma_tma' if tma30 else 'dmma_gemm'} (B1 / B2 float64 on the FP64 tensor cores, "
        "phase 30's 8192^3)",
        "gemm_hls_tpu_torch/csrc/" + ("dmma_tma.cu" if tma30 else "dmma_gemm.cu"),
        "gemm_hls_tpu/ops/pallas_mxu.py:69,143",
        routes21.get(("dmma", "float64"), 0), r21["B1 float64"], r21["B1 float64"]["bound"],
        r21["B1 float64"]["library_ms"]))
    kernels[-1].update({k: r21["B1 float64"][k] for k in (
        "oracle_2048_scaled_rel", "batched_max_abs_err", "grad_max_abs_err", "tile")})
    kernels[-1]["library_note"] = "library_ms is float64 torch.matmul (cuBLAS DGEMM)"
    for dt in SLICE21_B1_INT:
        t = r21[f"B1 {dt}"]
        kernels.append(kernel(
            f"mxu_gemm CUDA-core route (B1 {dt} plus_times, int32 accumulator, 4096^3)",
            "gemm_hls_tpu_torch/csrc/mxu_simt_int.cu", "gemm_hls_tpu/ops/pallas_mxu.py:69",
            routes21.get(("simt", dt), 0), t, t["bound"], None))
    for dt, sr in SLICE21_B3:
        t = r21[f"B3 {sr} {dt}"]
        kernels.append(kernel(
            f"semiring_gemm (B3 {sr} {dt}, 4096^3)",
            f"gemm_hls_tpu_torch/csrc/semiring_{B3_SOURCES[dt]}.cu",
            "gemm_hls_tpu/ops/pallas_vpu.py:56",
            b3_dt.get(dt, 0), t, t["bound"], None))
    # Slice 22 (phase 31): the generated functors, each with its launches
    # on phase 31's main path; the library holds the generated text's tile.
    r22, l22 = slice22["readings"], slice22["launches"]
    t = r22["B3 generated"]
    kernels.append(kernel(
        "semiring_gemm generated (B3 with a user semiring: example 02's plus_max, fp32 4096^3)",
        "gemm_hls_tpu_torch/ops/codegen.py", "gemm_hls_tpu/ops/pallas_vpu.py:56",
        sum(l22["generated_b3"].values()), t, t["bound"], None))
    kernels[-1].update({k: t[k] for k in (
        "user_max_plus_ms", "user_max_plus_plain_ms", "builtin_min_plus_ms",
        "builtin_max_plus_ms", "max_abs_err_by_semiring")},
        tile="gemm_hls_tpu_torch/csrc/simt_gemm.cuh")
    # dmma's main-path shape is aligned: its library holds the TMA tile.
    tiles = {"wgmma": "mxu_wgmma.cuh", "wmma": "mxu_tc.cuh", "simt": "simt_gemm.cuh",
             "dmma": "dmma_tma.cuh"}
    shapes = {"wgmma": "silu(acc + b), bf16 8192x4096 . 4096x16384",
              "wmma": "relu(acc + b), bf16 2048x1004 . 1004x2048",
              "simt": "relu(acc + b), fp32 2048^3", "dmma": "relu(acc + b), float64 2048^3"}
    for route, what in shapes.items():
        t = r22[f"B1 generated epilogue {route}"]
        kernels.append(kernel(
            f"mxu_gemm generated epilogue (B1 with a Python callable, {what}, {route})",
            "gemm_hls_tpu_torch/ops/codegen.py", "gemm_hls_tpu/ops/pallas_mxu.py:103",
            sum(v for (r, _), v in l22["generated_epilogue"].items() if r == route), t,
            t["bound"], t["library_ms"]))
        kernels[-1].update({k: v for k, v in t.items() if k.endswith("_ms") and k not in (
            "ms", "plain_ms", "library_ms")}, kernel_route=route,
            tile=f"gemm_hls_tpu_torch/csrc/{tiles[route]}",
            library_note="library_ms is torch._addmm_activation (relu(b + x w)), "
                         "bias_relu_ms the registered bias_relu epilogue in the same turns")
    # Slice 23 (phase 32): the float64 tiles, each with its launches on
    # phase 32's main path, its time in turns beside the other tile and the
    # library call, and its ptxas report.
    r23, l23 = slice23["b1"], slice23["launches"]
    t = r23["B1 8192^3"]
    kernels.append(kernel(
        "dmma_tma (B1 / B2 float64, the TMA tile: TMA ring, producer thread, two consumer "
        "warpgroups on mma.sync m16n8k8 .f64, persistent blocks; 8192^3)",
        "gemm_hls_tpu_torch/csrc/dmma_tma.cu", "gemm_hls_tpu/ops/pallas_mxu.py:69,143",
        l23["tiles"].get("tma", 0),
        dict(ms=t["tma"], plain_ms=slice23["plain_b1_ms"], **slice23["b1_err"]),
        t["bound"], t["library"]))
    kernels[-1].update(
        slice23["b1_err"], cp_async_tile_ms=t["cp_async"],
        shapes_ms={k: {f: v for f, v in r.items() if f != "bound"} for k, r in r23.items()},
        ptxas={k: v for k, v in slice23["ptxas"].items() if "dmma_tma" in k},
        library_note="library_ms is float64 torch.matmul (cuBLAS DGEMM); cp_async_tile_ms the "
                     "cp.async tile (csrc/dmma_gemm.cu) on the same operands in the same turns")
    key = [k for k in r23 if "x" in k and "^3" not in k][0]
    t = r23[key]
    kernels.append(kernel(
        f"dmma_gemm cp.async tile (B1 / B2 float64 where no TMA map describes the operands; "
        f"{key[3:]})", "gemm_hls_tpu_torch/csrc/dmma_gemm.cu",
        "gemm_hls_tpu/ops/pallas_mxu.py:69,143", l23["tiles"].get("cp_async", 0),
        dict(ms=t["cp_async"], plain_ms=t["library"],
             max_abs_err=slice23["b1_err"]["unaligned_max_abs_err"]),
        t["bound"], t["library"]))
    kernels[-1]["library_note"] = "library_ms is float64 torch.matmul (cuBLAS DGEMM)"
    t = slice23["b3"]["min_plus"]
    kernels.append(kernel(
        "semiring_gemm float64 tile (B3 min_plus float64, cp.async ring, the Num form on "
        "slices no NaN can come from; 4096^3)", "gemm_hls_tpu_torch/csrc/semiring_f64.cu",
        "gemm_hls_tpu/ops/pallas_vpu.py:56", l23["b3_dtypes"].get("float64", 0),
        dict(ms=t["kernel"], plain_ms=slice23["plain_b3_ms"],
             max_abs_err=slice23["b3_max_abs_err"]), t["bound"],
        None))
    kernels[-1].update(
        tile="gemm_hls_tpu_torch/csrc/simt_gemm.cuh", plus_inf_ms=t["kernel +inf"],
        semirings_ms={sr: dict(ms=r["kernel"], n=r["n"], bound_ms=r["bound"][0] * 1e3)
                      for sr, r in slice23["b3"].items()},
        apsp_4096=slice23["apsp"], forms=slice23["forms"],
        ptxas={k: v for k, v in slice23["ptxas"].items() if "simt_f64" in k})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
