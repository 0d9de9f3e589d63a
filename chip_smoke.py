#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--earlier DIR]

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and runs the port's paths at full size: the main path
(generate an SPD matrix, pack it to GSE-SEM CSR, run the tag-specialized
SpMV, run stepped CG), the batched solve service (``SolverService`` ->
per-column stepped CG on the tag-specialized SpMM) and the SELL-C-sigma
layout through both (kernels B and C′ on a skewed operator).  Every phase prints
one line; any mismatch raises and the script exits non-zero.  There is no
CPU fallback: without a CUDA device, or without the rest of the
repository beside it, the script fails.  Phases 11-14 drive the LM
serving path of qwen3_4b (prefill and decode with GSE-SEM packed weights)
on kernels D, E and F; phases 15-18 stepped GMRES (the paper's second
solver, right-preconditioned) and preconditioned CG; phases 19-20
stepped iterative refinement, batched PCG and the preconditioned solve
service; phases 21-22 per-group precision (TagMap, the masked operands,
the adaptive driver and the mixed launch of kernels B32 and C′32); phase
23 telemetry, faults and checkpoints (the flight recorder, spans, the
metrics registry, fault injection, checkpoint and resume); phase 24 async
serving (the chunked drivers, continuous batching, the circuit breaker,
deadlines, warm starts and pack integrity); phase 25 the perf layer (the
card's roofline, the autotuner and its tune cache, the byte ledger,
timing); phases 26-27 the hybrid family (recurrentgemma_2b: RG-LRU
blocks on the lru_scan kernel, local-window attention on kernel F at hd
256, the 8-bit GSE-SEM KV cache); phases 28-29 the moe family
(qwen3_moe_235b_a22b, grok1_314b: routing, capacity dispatch and the
expert products beside kernels E and F); phases 30-31 the ssm family
(rwkv6_1p6b on the wkv6 kernel); phases 32-33 the encdec and vlm
families (seamless_m4t_large_v2: an encoder and cross-attention on F's
non-causal mode; internvl2_2b: the dense stack behind 256 patch
embeddings); phases 34-37 the train path (kernel F's backward, the train
step, AdamW, the token pipeline, remat and the train CLI's resume).
Every CPU
twin runs in one of three processes of its own (CpuTwins): the small
solves (and phase 30's rwkv twin and phase 32's encdec and vlm twins,
last) on one thread, in the order the phases need them, from before the
build; phase 35's train twin on two threads from before the build; the
LM twins of phases 12, 26 and 28 from after the build, on the cores the
rest leave.
A phase waits only for a twin that is not done yet.

Phases:
  1. build     -- nvcc time for every kernel source (all started at once,
                  beside phase 2's matrix generation).
  2. parity    -- on diag_rescale(random_spd(2^20, 8, seed=21), 8, 21)
                  (about 17.8M nonzeros): A32 (each row's real slots of
                  the 128-wide ELL) bitwise its plain version (every
                  padded slot, the same sum order), A64 bitwise (every row
                  in row blocks: the longest has 35 entries), tags 1-3;
                  the CG loop's dot (seq_dot) and update (fma_axpy)
                  bitwise on 2^20-long vectors.  Kernel C at nrhs = 4 (X
                  (n, nrhs)): C32 bitwise its plain version and at nrhs =
                  1 bitwise A32; A32 and C32 with x[0] = inf (C32: column
                  0) give the plain versions' values row for row (NaN in
                  every padded row);
                  C64 with tags [1, 2, 3, 1] and active [T, T, T, F]
                  bitwise its plain version, column j bitwise A64 at tag
                  j+1, every body of C64 the row plan holds launched (row
                  blocks); seq_dot_cols and fma_axpy_cols bitwise seq_dot
                  and fma_axpy per column.  The SELL-C-sigma pack of the same
                  matrix (every slice 128 wide, so the checks exercise the
                  row permutation): B32 bitwise A32 and B64 bitwise A64 at
                  tags 1-3; C′32 bitwise C32 at tags 1-3 and C′64 bitwise
                  C64 with tags [1, 2, 3, 1], active [T, T, T, F], nrhs 4.
  3. trajectory-- spd_rs8_2k solved on the GPU and on the CPU twin: equal
                  tag and switch_iters, iters within 3%, both converged.
                  The reference's schedule there is [120, 150] in 2791
                  iterations; the tests hold the CPU twin to it.
  4. main path -- launch counts zeroed; the f32 SpMV at tags 1-3 and
                  stepped CG (tol MAIN_TOL = 1e-5, MonitorParams(40, 60,
                  30), maxiter 20000, default guards) on the full-size
                  matrix (tol 1e-8 before PR 30: the cut that made room
                  for phases 34-37);
                  every kernel must have launched, and every body of A64
                  that the pack's row plan holds.
  5. service trajectory -- rs8_400_s3 (diag_rescale(random_spd(400, seed=3),
                  8, 3), three requests, slots=4) through SolverService on
                  the GPU: at maxiter 20000 the reports equal the
                  reference's numbers below; at maxiter 200 (the tag-3
                  retry) the GPU's reports and solutions equal the CPU
                  twin's bitwise.
  6. service   -- launch counts zeroed; the f32 SpMM at tags 1-3 on a
                  4-column block, then the full-size matrix registered in
                  SolverService(slots=4, maxiter=20000) and three requests
                  at MAIN_TOL flushed.  Request 0 (phase 4's b) must equal
                  phase 4's solo solve bitwise; all converge, health ok,
                  no retries, no errors; every kernel of the path must
                  have launched, and every body of C64 that the row plan
                  holds.
  7. sell parity -- skewed_spd(8192, seed=0) packed at k=8 (about 1.03M
                  nonzeros, SELL widths 128/256/8192; its uniform ELL still
                  fits, so A and C run beside B and C′; the x[0] = inf
                  check of phase 2 on its ELL, 8192 wide, where the full
                  rows have no padding): B32 against its
                  plain version (same tolerance, bitwise expected) and
                  bitwise A32; B64 bitwise A64 and its plain version; C′32
                  and C′64 likewise against C32 and C64 at nrhs 4 (C′64
                  with mixed tags); A64 bitwise its plain version; tags
                  1-3.  A64's and C64's three bodies (row blocks, warp
                  rows, the hubs' block chains) and B32's, C′32's and
                  C′64's two (the hubs' blocks, warp rows) must have
                  launched.
  8. sell trajectory -- sk512_rs8_s0 (diag_rescale(skewed_spd(512,
                  seed=0), 8, 0)) over its SELL pack: solve_cg on the GPU
                  and on the CPU twin (1498 iterations, tag 3, [210, 300];
                  x and relres bitwise); the layout="sell" service at
                  maxiter 20000 equals the reference's reports below, and
                  at maxiter 200 the GPU's reports and solutions equal the
                  CPU twin's bitwise.
  9. sell      -- diag_rescale(skewed_spd(262144, seed=5), 8, 5) (about
                  33.2M nonzeros, 4 dense hub rows; its uniform ELL would
                  need 6.9e10 slots).  First, uncounted, the SELL solve at
                  n = 32768 of the same construction must end as the
                  reference's does (STALL_REF: 1026 iterations, [60, 90],
                  relres and health "stalled" equal), and so must its
                  layout="sell" service (STALL_SERVE_REF: every request
                  converges after one tag-3 retry).  B64 bitwise A64 at
                  tags 1-3 and C′64 bitwise C64 (mixed tags) on it, C64
                  bitwise its plain version and, per column, A64, all
                  three of its bodies launched; then, launch counts
                  zeroed, B32 and C′32 at tags 1-3 against their plain
                  versions (rtol 2e-5 / atol 1e-4), stepped CG over the SELL pack (tol 1e-8,
                  maxiter 20000, default guards; it may stall, as the
                  reference does on this construction from n = 32768 on,
                  and then the service's tag-3 retry from its x is run
                  too), the CSR and SELL solves over 256 iterations bitwise
                  equal, then SolverService(slots=4, maxiter=20000,
                  layout="sell") with three requests: request 0 bitwise
                  the solo SELL solve (and retry), all converge, health
                  ok, no errors; every kernel of the path must have
                  launched, and every body of A64 (in the 256 CSR
                  iterations), of B32 and C′32 and of C′64 (in the
                  service) that the row plan and the SELL pack hold.
  11. lm kernels -- kernels D, E and F against their plain versions at
                  qwen3_4b's full-width shapes: D bitwise (f32 and bf16
                  out) on gse.pack packs shaped like wq (2560, 4096) and
                  w_down (9728, 2560), tags 1-3; E within rtol 1e-5 / atol
                  1e-4 at tags 1-3, x f32 and bf16, bitwise equal across
                  two calls, on every decode-step and prefill shape (wq,
                  wk/wv, wo, w_gate/w_up, w_down; runs of the two packs)
                  at M 1, 4 and 8 (the split-K GEMV) and M 2048 (the tiled
                  body, split TF32 on the tensor cores), on a ragged,
                  unaligned (300, 1001) at M 1, 4 and 8 and a ragged,
                  unaligned (1001, 999) at M 300 (the tiled body); E
                  at M 1, 4, 8 on bias-127 pack32 segments shaped like the
                  unembedding (2560, 151936), packed on the card, tags
                  1-2; F at B 4, H 32, KV 8, hd 128, causal, S = T = 2048
                  in f32 (the FFMA body, rtol/atol 2e-5) and bf16 (the
                  tensor-core body, 2e-2), S = T = 512 in bf16, and S = T
                  = 1000 at hd 64 and 128, causal and not, in bf16, and
                  on F's FFMA body at S = T = 1000: hd 16 (causal) and 72
                  (not) in f32, hd 72 (causal) in bf16.
  12. lm twin  -- qwen3_4b at full width cut to 2 layers, params from
                  lm_tree_np (numpy seed LM_SEED), compute_dtype float32
                  for dense and gse_serve at tags 1 and 2:
                  make_prefill_step over 128 tokens for 2 requests
                  (filling the KV cache), then 8 teacher-forced decode
                  steps, on the card and on its CPU twin (the linears
                  packed on the CPU, held bitwise to the card's pack by
                  tree_digest): logits within
                  LM_TOL and the greedy tokens equal, and the card's
                  digest (tokens, first 8 logits, max |logit| per step)
                  within LM_TOL of the reference's (LM_REF, printed by
                  tools/reference/lm_serve_ref.py).  Then the served
                  configuration, gse_serve tag 2 at bfloat16 (E's tiled
                  body on a bf16 x at M 256, E's GEMV, F's tensor-core
                  body): logits within BF16_TOL of the CPU twin's and of
                  the reference's bf16 digest, the greedy tokens equal to
                  both wherever the CPU twin's top-2 margin exceeds twice
                  the atol (the positions below it, and how many of them
                  differ, are printed).  Launch counts zeroed before each
                  variant: at f32 the card's E (GEMV and tiled) and F
                  (FFMA body) must have launched, at bf16 E (GEMV and
                  tiled) and F's tensor-core body.  A fifth variant,
                  kv8 (dense weights, kv_cache_gse at f32: the prompt's
                  keys and values packed to 8 bits by the prefill, the
                  decode steps over the decoded cache) is held to
                  LM_REF["kv8"] and the CPU twin as the bf16 variant is,
                  at KV8_TOL (rtol 0.005, atol 0.02): an f32 rounding
                  difference moves a cache entry by a whole 4-bit
                  mantissa step.
  13. lm full  -- launch counts zeroed; qwen3_4b at full width and depth
                  (36 layers), gse_serve tag 2, bf16, weights packed on the
                  card; B = 4, prefill 512 tokens, 32 greedy decode steps:
                  prefill seconds, ms per decode step, tree_bytes and the
                  rate it implies; finite logits; E's GEMV and tiled
                  bodies and F's tensor-core body must have launched.
                  One more prefill, uncounted, under torch.profiler: the
                  device's busy ms and E's tiled body's device ms.
  14. lm serve -- launch counts zeroed; repro_torch.launch.serve's main
                  (the smoke config) with --gse-tag 2 on the card: kernel D
                  must have launched (dequantize_tree), the decoded params
                  equal the CPU's bitwise, the tokens lie in the vocab.
  15. gmres trajectory -- gemv_rows_ref and gemv_cols_ref (with and
                  without the fused addend) bitwise their plain versions
                  at n = 2^20 and rows 1, 41, 81, and gemv_cols_sliced_ref
                  (the right-preconditioned cycle update y @ V[:rows] in
                  the order of XLA's loop fusion) at rows 30, 60 and 80;
                  givens_step (j 0, 1, 40,
                  79) and trsv_upper_ref (j 0, 1, 17, 40, 80) bitwise at
                  restart 80; then the example's case
                  (examples/solve_stepped_gmres.py: diag_rescale(
                  convection_diffusion_2d(32, beta=5), 3, 7), k=8, tol
                  1e-7, restart 80) and its right-Jacobi twin on the card
                  and on the CPU twin: the reference's iterations, switches
                  and tag (GMRES_REF), x and relres bitwise the twin's.
  16. gmres full -- diag_rescale(convection_diffusion_2d(1024, beta=5), 3,
                  7) (1,048,576 unknowns, about 5.2M nonzeros), right
                  Jacobi, GMRES(80) over a fixed budget of 800 inner
                  iterations (ten cycles; the basis alone is 680 MB).
                  Uncounted first: the first cycle's recursive residuals
                  never increase.  Then, launch counts zeroed, the solve:
                  no guard trip, a finite x, relres below 1, every kernel
                  of the path launched (the sliced update included) and
                  every body of A64 the row plan holds; ms per inner
                  iteration and launches per iteration printed.
  17. pcg trajectory -- quickstart section 4's system
                  (ill_conditioned_spd(32, 8 decades), tol 1e-10, the fast
                  monitor) with Jacobi, block-Jacobi and SPAI-0 on the card
                  and the CPU twin: the reference's numbers (PCG_REF), x
                  and relres bitwise the twin's, and the fused path
                  bitwise the generic one on the card.
  18. pcg full -- launch counts zeroed; PCG with make_jacobi on phase 4's
                  matrix (tol 1e-8, MonitorParams(40, 60, 30), maxiter
                  20000): converged, health ok, A64's bodies, seq_dot and
                  fma_axpy launched; iterations and ms per iteration beside
                  phase 4's plain CG.
  19. ir trajectory -- quickstart section 5's case (the system of phase 17,
                  Jacobi, b and a second draw b'; tol 1e-11, max_outer 10,
                  inner_tol 1e-4, inner_maxiter 4000): solve_ir with inner
                  PCG, CG, and right-Jacobi GMRES at restarts 30, 60 and
                  80 on the card gives the reference's outer and inner
                  counts and relres (IR_REF, printed by
                  tools/reference/ir_ref.py), x and relres bitwise the CPU
                  twin's (inner CG at a cut budget for the twin, IR_CG_CUT);
                  solve_ir_batched on [b, 2b, b', 0] likewise
                  (IR_BATCHED_REF).  solve_pcg_batched on [b, b', 0] with
                  Jacobi, block-Jacobi and SPAI-0: each column bitwise the
                  solo solve_pcg (column 0 PCG_REF's schedule), the fused
                  path bitwise the generic one.  SolverService(slots=4,
                  precond=...) for Jacobi and SPAI-0 on rs8_400_s3: at
                  maxiter 20000 and at maxiter 4 (every request takes the
                  tag-3 PCG retry) the reports equal the reference's
                  (PCG_SERVICE_REF), and at maxiter 4 the card's reports
                  and solutions equal the CPU twin's bitwise.  The
                  inner-CG row runs at the cut budget on the card too.
  20. ir full  -- launch counts zeroed; on phase 4's matrix and b
                  (MonitorParams(40, 60, 30)): solve_ir with inner Jacobi
                  PCG (tol 1e-10, inner_tol 1e-4, max_outer 10) converges
                  with health ok; solve_ir_batched on [b, b2, b3, 2b]
                  (phase 6's right-hand sides and twice phase 4's b):
                  column 0 bitwise the solo run, column 3 its relres and
                  twice its x; SolverService(slots=4, maxiter=20000,
                  precond="jacobi") takes phase 6's three requests: request
                  0 bitwise phase 18's solo PCG, all converge, no retries,
                  no errors.  Every body of A64 and C64 the row plan holds
                  launched, and seq_dot_cols and fma_axpy_cols; outer and
                  inner counts, seconds, and the inner iterations run
                  (whole chunks) against those needed printed.
  21. tagmap   -- per-group precision on the small cases: solve_adaptive
                  on ill_conditioned_spd(16, 8 decades) (explore, tol
                  2e-3), diag_rescale(skewed_spd(1024), 6, 11) (neumann,
                  1e-3) and diag_rescale(skewed_spd(65536, seed=5), 6, 11)
                  (neumann, 1e-3), b four unit spikes: iters,
                  true_relres, the map's tag counts and crc32, the
                  promotions, spmv_bytes, chunks and x's crc32 equal the
                  reference's (ADAPTIVE_REF, printed by
                  tools/reference/adaptive_ref.py), the two small rows
                  bitwise the CPU twin.  On poisson2d(10) a uniform map
                  is bitwise the int tag through CG fused and generic,
                  PCG, CG over SELL, batched CG at nrhs 1 and 4, batched
                  PCG and IR.  solve_cg(tags=tm) with the 65536 row's map
                  over its CSR and SELL packs: bitwise each other and
                  TAGMAP_CG_REF.  SolverService with tags 2, the uniform
                  tag-2 map and "adaptive": the reference's reports
                  (SERVICE_TAGS_REF), the int and uniform-map requests
                  equal.
  22. adaptive -- launch counts zeroed; solve_adaptive (neumann, tol 1e-3,
                  b four spikes) on diag_rescale(skewed_spd(262144,
                  seed=5), 3, 11) (phase 9's operator with its four hub
                  rows, about 33M nonzeros; at the 65536 row's 6 decades
                  the tag-1 operator loses 152,660 diagonals, PERF.md):
                  converged, the map not uniform with under half the
                  groups promoted, spmv_bytes below (iters + 1) *
                  bytes_touched(2) + bytes_touched(3), every A64 body of
                  the row plan launched, the hubs' block body included;
                  the planner's, masking's, solve's and true-residual
                  checks' seconds apart.  Then B32 and C′32 (nrhs 4) with
                  tag=TagMap over its masked SELL view, on the planned
                  map and on three maps whose bucket tags differ (2 1 2,
                  3 1 3, 3 2 3; each a mixed launch running both
                  bodies): bitwise the plain versions and, bucket for
                  bucket, the uniform launch at the bucket's tag; the
                  buckets' tags printed.
  23. telemetry -- inside obs.trace.capture: launch counts zeroed; phase
                  4's solve with flight=FlightParams(4096) run to
                  iteration MAIN_RESUME_AT = 960, its state saved
                  (checkpoint.ckpt),
                  restored onto the card by restore_latest_valid (the
                  tree's CRC32 unchanged) and resumed: x, iters, relres,
                  tag and switch_iters bitwise phase 4's, A64's and the
                  dot's launches phase 4's, the flight log consistent
                  with switches at [120, 150]; a second step with one
                  blob byte flipped is skipped.  Phase 16's GMRES with
                  flight on, bitwise phase 16.  The flight rings of
                  batched CG and Jacobi PCG on rs8_400_s3 and of
                  quickstart section 5's IR (inner PCG) bitwise the CPU
                  twin's.  corrupt_gsecsr on the full-size pack's head
                  and table (verify_gsecsr names each); corrupt_pack_cache
                  on its ELL cache (the next ell_pack_gsecsr repacks,
                  the registry's corrupt counter +1); the tag-fault
                  operator (indefinite, nan; fail_tag 1) on spd_rs8_2k
                  through solve_cg with guards and recovery: trips at
                  iteration 0, recovers, the CPU twin's numbers.  The
                  trace passes validate_jsonl with every solver span and
                  pack.build; the registry exposes the pack-cache and
                  service metrics.
  24. async serving -- part 1 (phase_serve_small, runnable alone):
                  AsyncSolveService under a fake clock (chunk_iters 32,
                  slots 4, queue_limit 4) on rs8_400_s3 and poisson2d(12)
                  on the card and on the CPU twin: three requests, the
                  third joining the running group after two pumps; a
                  queue_full burst; a tag-fault operator that trips the
                  breaker, sheds breaker_open and heals through the
                  half-open probe once lifted; a pack corrupted by
                  corrupt_gsecsr, detected and repacked; a stall hook that
                  expires a deadline (health "deadline", a finite x); a
                  warm-LRU hit (iters 0).  Every case holds, every report
                  equals the twin's field for field, every solution
                  bitwise, the repro_serve_* series equal, no error.  Part
                  2, launch counts zeroed: AsyncSolveService(slots=4,
                  maxiter=20000, chunk_iters=64) on phase 4's matrix,
                  phase 4's b alone for 2 pumps, then phase 6's second
                  right-hand side joins the running group: request 0
                  bitwise phase 4's solo solve (x, iters, switches,
                  relres), request 1 bitwise phase 6's request 1, both ok
                  with no retries and no errors; C64 launched once a
                  group iteration and once a column init (predicted from
                  the two solves' iterations before the run), every body
                  of its row plan; ms per group iteration, host seconds
                  outside the chunks, pumps and repro_serve_chunks_total.
                  Part 3: phase 20's solo refinement through IRChunks two
                  corrections a chunk, x and history bitwise phase 20's.
  25. perf     -- the perf layer (repro_torch.perf), the run's tune cache
                  in a temporary file.  a: the card's roof probed
                  (host_roofline(device="cuda"): a triad over three
                  256 MiB f64 arrays, an 8192 FP32 matmul with TF32 off)
                  and persisted (a second call probes nothing).  b:
                  get_or_tune sweeps the lanes of A32 (nrhs 1) and C32
                  (nrhs 4) on phase 2's operator at tag 1; every
                  candidate bitwise the default at tags 1-3, planned_spmv/
                  planned_spmm through the stored winner bitwise the
                  default; a second call and one after clear_memory hit
                  with no sweep and no launch; a flipped payload is
                  detected (corrupt 1) and re-swept.  c: the SELL sweep
                  of B32 (C, sigma, buckets) on phase 9's operator; every
                  candidate pack's B32 (tags 1-3) and C′32 bitwise the
                  default pack's; planned calls through the winner
                  bitwise.  d: the ledger's launch bytes (perf.ledger)
                  equal the integer arguments ops hands A32, C32, B32 and
                  C′32 at tags 1-3, recorded.  e: SolverService(layout=
                  "sell", tune=True) on sk512_rs8_s0 equals the
                  reference's service under the winning plan
                  (SELL_PLAN_SERVICE_REF) and is bitwise the untuned
                  handle; phase 9's 256 iterations over every candidate
                  pack bitwise the default pack's.  f: the decode
                  crossover: A32 at tag 3 against tag 1 on
                  random_spd(n, 8), n = 2^12 ... 2^20.  g: timing.measure
                  beside cuda_ms (printed).
  26. hybrid twin -- F with a window and at hd 256 (HYBRID_FLASH: the
                  tensor-core body at phase 27's shape, B 4, H 10, KV 1,
                  S 2560, window 2048, and the FFMA body at the twin's;
                  S 1000 with and without a window on both bodies, the
                  FFMA body on bf16, a window at hd 128 and 72) against
                  its plain version (rtol/atol 2e-5 f32, 2e-2 bf16), and
                  lru_scan bitwise its plain version at (2, 96, 2560) and
                  (4, 2560, 2560).  Then recurrentgemma_2b at full width
                  (d 2560, H 10, KV 1, hd 256, lru 2560, d_ff 7680, vocab
                  256000) cut to 3 layers (RG-LRU, RG-LRU, local
                  attention) and a window of 64, params from
                  hybrid_tree_np (the reference's list layout): a
                  96-token prompt for 2 requests (the ring wraps in
                  prefill) and 16 teacher-forced decode steps (and in
                  decode), dense, gse_serve tag 2 and kv_cache_gse at f32
                  and gse_serve tag 2 at bf16, on the card and on its CPU
                  twin: held as phase 12 holds its variants (kv8 at
                  KV8_TOL, bf16 at BF16_TOL), against the reference's
                  digest HYBRID_REF (printed by
                  tools/reference/hybrid_serve_ref.py); the numpy params
                  are drawn on a thread beside phases 11-14.  Launch counts
                  zeroed before each variant: at f32 E (GEMV and tiled),
                  F's windowed FFMA body and lru_scan must have launched,
                  at bf16 E, F's windowed tensor-core body and lru_scan.
  27. hybrid full -- launch counts zeroed; recurrentgemma_2b at full width
                  and depth (26 layers, window 2048), gse_serve tag 2,
                  bf16, weights packed on the card; B = 4, a 2560-token
                  prompt (past the window: F masks, the prefill fills a
                  wrapped ring), 32 greedy decode steps: init, prefill
                  seconds and tokens/s, ms per decode step, peak GB, the
                  launches of E, F and lru_scan by body; finite logits;
                  E's GEMV and tiled bodies, F's windowed tensor-core body
                  and lru_scan must have launched.
  28. moe twin -- F at the moe attention shapes (MOE_FLASH: B 4, S 512,
                  H 64 / KV 4 and H 48 / KV 8, hd 128, bf16) against its
                  plain version (rtol/atol 2e-2).  Then qwen3_moe_235b_a22b
                  at full width (d 4096, H 64 / KV 4, hd 128, qk-norm, 128
                  experts top-8, vocab 151936) cut to 2 layers and an
                  expert ff of 256, params from moe_tree_np (drawn on a
                  thread beside the earlier phases): a 64-token prompt
                  for 2 requests and 16 teacher-forced decode steps;
                  dense, gse_serve tag 2 and capacity_factor 0.5 (pairs
                  dropped at the prefill) at f32, gse_serve tag 2 at
                  bf16, on the card and on its CPU twin, the routes
                  recorded (moe.record_routes, route_digest): at f32 the
                  routes and drops equal the twin's and the reference's
                  and the logits are held as phase 12's; at bf16 the
                  route digests that differ are counted, then the card
                  and the twin replay the reference's expert ids
                  (replay_routes, MOE_REF_IDS) and their logits are held
                  to BF16_TOL at every position, against each other and
                  against MOE_REF (tools/reference/moe_serve_ref.py);
                  where a side's own top 8 differs from the replayed ids
                  the router logit gap is at most ROUTE_GAP_TOL.
                  grok1_314b's smoke config the same way against the CPU
                  (at bf16 both replay the CPU's own expert ids).
                  E (GEMV and tiled) and F (FFMA at f32, tensor cores at
                  bf16) must have launched.
  29. moe full -- (runs right after the build, while the card holds only
                  phase 2's operator) launch counts zeroed;
                  qwen3_moe_235b_a22b at full width
                  cut to 6 layers, then grok1_314b cut to 2, each
                  initialized on the card (T.init_params, f32 expert
                  stacks), gse_serve tag 2, bf16; B 4, a 512-token prompt
                  through make_prefill_step(state=), 32 (grok1: 8) greedy
                  steps: init, prefill and step times, peak GB, the pairs
                  dropped per layer at the prefill; then one decode
                  step's expert products of a qwen3_moe layer timed
                  against the bytes they read.
  30. rwkv twin -- wkv6 bitwise its plain version on the card at
                  WKV_SHAPES ((4, 2048, 32, 64), (2, 64, 32, 64) and two
                  ragged shapes), from a zero and a non-zero state.  Then rwkv6_1p6b at full
                  width (d 2048, ff 7168, 32 heads of 64, vocab 65536) cut
                  to 3 layers, params from rwkv_tree_np: a 64-token prompt
                  for 2 requests, 16 steps; dense and gse_serve tag 2 at
                  f32, gse_serve tag 2 at bf16, against the CPU twin and
                  RWKV_REF (tools/reference/rwkv_serve_ref.py), as phase
                  12's variants.
  31. rwkv full -- (right after phase 29) launch counts zeroed; rwkv6_1p6b
                  whole (24 layers),
                  gse_serve tag 2, bf16; B 4, a 2048-token prompt, 32
                  greedy steps, as phase 29.  Phase 30 ends with the
                  serve CLI at --gse-tag 2 on the three archs' smoke
                  configs (kernel D on the 4-D expert packs) and on
                  internvl2_2b's (text only, as the reference's CLI),
                  tokens equal to the CPU's.
  32. encdec/vlm twin -- F with causal=False against its plain version
                  (rtol/atol 2e-5 f32 on the FFMA body, 2e-2 bf16 on the
                  tensor-core body) at EV_FLASH: seamless's encoder (B 4,
                  S = T = 512, H = KV = 16, hd 64), its cross-attention (S
                  64 over T 512) and a ragged S 77 over T 300.  Then
                  seamless_m4t_large_v2 at full width cut to 2 encoder and
                  2 decoder layers (params from encdec_tree_np): 2
                  requests of 128 frames and a 64-token prompt, T.encode,
                  the prefill, 16 teacher-forced decode steps each
                  recomputing every layer's cross_kv; and internvl2_2b at
                  full width cut to 2 layers (lm_tree_np): 256 patches and
                  a 64-token prompt through the prefill (the caches filled
                  for all 320 positions), 16 steps.  Dense and gse_serve
                  tag 2 at f32, gse_serve tag 2 at bf16, on the card and
                  on the CPU twins (the small child), held as phase 12's
                  variants against the twins and ENCDEC_REF / VLM_REF
                  (tools/reference/encdec_serve_ref.py: the reference's
                  sinusoidal and _scan_encdec, then decode_step(...,
                  enc_out) teacher-forced; vlm_serve_ref.py: the
                  reference's forward over the whole teacher-forced
                  sequence).  E (GEMV and tiled) and F on both bodies must
                  have launched, and for seamless F's non-causal launches
                  on both bodies (noncausal_launches).
  33. encdec/vlm full -- (right after phase 31) launch counts zeroed;
                  seamless_m4t_large_v2 whole (24 + 24 layers) and
                  internvl2_2b whole (24 layers), each initialized on the
                  card, gse_serve tag 2, bf16, B 4: 512 frames and a
                  512-token prompt (seamless), 256 patches and 256 text
                  tokens (internvl2), 32 greedy steps: init, encode and
                  prefill seconds, ms per step, peak GB, E's and F's
                  launches by body (F's non-causal ones apart); finite
                  logits; then every seamless layer's cross_kv timed alone
                  against the step (ROADMAP queue 2 O20).
  34. train kernels -- F's backward (flash_attention_gqa_bwd, csrc/
                  flash_attn_bwd.cu) against autograd through F's plain
                  version at TRAIN_FLASH's shapes (qwen3_4b's training
                  shape B 4, S 2048, H 32, KV 8, hd 128 in bf16 and f32;
                  causal windows; seamless's encoder and cross shapes;
                  ragged S and S != T): dq, dk and dv within each case's
                  tolerance, the kernel's row statistic within 1e-3 of
                  the plain log-sum-exp, the backward bitwise when run
                  again, and F's forward with the statistic (grad mode)
                  bitwise its forward without it.
  35. train twin -- qwen3_4b at full width cut to 2 layers, f32 (TF32
                  off), 3 steps of make_train_step + AdamW at B 2, S 64
                  from lm_tree_np's params and the pipeline's batches,
                  under deterministic algorithms: loss, grad_norm and
                  three leaves after each update against the CPU twin
                  and TRAIN_REF (tools/reference/train_ref.py), within
                  TRAIN_TOL; F's forward twice a layer a step (remat) and
                  its backward once.
  36. train full -- qwen3_4b at full width cut to 8 layers, bf16, remat
                  "full", B 4, S 2048, 3 steps from launch.train.build:
                  finite loss and grad_norm, ms per step, peak GB, F's
                  launches per step; the same with remat off, its loss
                  and grad_norm bitwise equal.
  37. train CLI -- python -m repro_torch.launch.train on its smoke config
                  with checkpoints: uninterrupted, and killed by
                  --simulate-failure-at (exit 17) then resumed; the final
                  checkpoints' tree_crc32 equal.
  10. kernels  -- run last: CUDA-event times (minimum over repeats; one
                  call for a function whose first call takes ONE_CALL_MS) of
                  every kernel beside its plain version, its bound (HBM
                  bytes or operations) and one PyTorch library call
                  (torch.sparse CSR, torch.dot, torch.addcmul,
                  torch.linalg.vecdot, torch.matmul on the decoded f32
                  weight with TF32 off, scaled_dot_product_attention; none
                  for D); the SELL kernels and A64 on phase 9's operator,
                  D, E and F at phase 11's shapes with the launches of
                  phases 13 (E, F's tensor-core body), 12 (F's FFMA body)
                  and 14 (D); C64 also on phase 9's skewed CSR, with the
                  launch of its full-size check.  F's bf16 row at S =
                  2048 carries `earlier_ms`, the FFMA body's time on the
                  same inputs; C′32's rows carry both parts launched one
                  after the other (`two_launches_ms`), eight columns
                  (`nrhs8_ms`) and the copy of X its earlier op made
                  (`x_copy_ms`); A32's and C32's rows carry the sweep of
                  the lanes a row runs on (`lanes_ms`, each of
                  ELL_LANES; `lanes` the default) and, with `--earlier
                  DIR` (an earlier checkout, e.g. a `git archive` of the
                  parent commit unpacked under build/), that tree's time
                  on the same operator (`earlier_ms`, from
                  tools/time_ell_kernels.py run there in a process of its
                  own); A64's, B32's, C′32's, C64's and
                  C′64's rows carry their launches per body
                  (`body_launches`); A32's, A64's, C32's and C64's
                  rows take their bytes from perf.ledger.spmv_ledger
                  (checked against the arithmetic of before) and carry
                  `roofline_fraction` at phase 25's probed roof; E's tiled
                  rows are bound by the TF32 tensor cores (495 TFLOP/s
                  per TF32 term) and F's bf16 rows by the bf16 tensor
                  cores (989 TFLOP/s), with `fp32_bound_ms` beside.
                  The GMRES kernels are timed at phase 15's shapes
                  (their plain versions on the host, `plain_on`; the
                  sliced update at rows 80), the GEMVs beside torch.mv
                  and the back substitution beside
                  torch.linalg.solve_triangular, with phase 16's launches.
                  First a probe times a dependent FP64 add chain and FMA
                  chain from registers (vec_f64.chain_latency);
                  the f64 kernels held to the reference's summation order
                  (A64, B64, C64, C′64, seq_dot, seq_dot_cols) carry
                  `chain_bound_ms`: their longest chain times that
                  latency.  Then the width sweep: a synthetic GSE CSR
                  of 2^22 entries per row length (and of 8 rows at the
                  block lengths), every row on one body of A64 at a time
                  (the bodies B64 shares), each held bitwise to the plain
                  version at tags 1-3, then timed at tags 1 and 3: the
                  block body against the warp body at 512-65,536
                  entries, the row-block body against the warp body at
                  8-512; the crossovers set sparse/csr.py's
                  A64_WARP_LEN, A64_BLOCK_LEN and B64_BLOCK_WIDTH.
                  The mixed launch of B32 and C′32 on phase 22's operator
                  and its map 2 1 2 (`.mixed` rows, `replaces` the
                  reference's per-bucket dispatch) is bound by
                  sell.bytes_touched(tm) and carries the uniform launch at
                  the map's max tag (`uniform_max_tag_ms`,
                  `uniform_bytes`), the entry point ops.gse_spmv_sell
                  (gse_spmm_sell) over the masked view (`ops_ms`) and that
                  entry point on the planned map (`planned_map_ms`).
                  F at hd 256 with a window (phase 27's shape on the
                  tensor-core body, phase 26's on the FFMA body) is
                  bound by the pairs it keeps (4 hd sum_i min(i + 1, w)
                  operations per batch and head) and timed beside SDPA
                  with the same boolean mask; lru_scan at (4, 2560, 2560)
                  is bound by 12 B S W bytes (no library call).  F without
                  a mask at phase 32's three bf16 shapes is bound by 4 S T
                  hd operations per batch and head at 989 TFLOP/s, beside
                  SDPA, with phase 33's non-causal launches.  F's
                  backward at qwen3_4b's training shape (bf16, causal) is
                  bound by 10 S T hd / 2 operations per batch and head at
                  989 TFLOP/s (bf16 tensor cores; its FFMA body's FP32
                  bound as `fp32_bound_ms`), beside SDPA's backward
                  (is_causal, enable_gqa; warmed) and autograd through F's
                  plain version, with phase 36's launches.

The line before the last two is the ``{"kernels": [...]}`` JSON record,
the line before the last the card's name and power limit, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_FULL = 1 << 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP64_OPS_PER_S = 34e12         # H100 SXM FP64 outside the tensor cores
FP32_OPS_PER_S = 67e12         # H100 SXM FP32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12     # H100 SXM bf16 on the tensor cores, dense
TF32_TC_OPS_PER_S = 495e12     # H100 SXM TF32 on the tensor cores, dense
# Integer/float operations one decoded nonzero costs per tag (shifts, masks,
# converts, mantissa splice, two scale multiplies, sign, product, sum).
DECODE_OPS = {1: 10, 2: 12, 3: 15}
TAGS = (1, 2, 3)
NRHS = 4  # the solve service's default slot width
# A function whose first call takes this long is timed on that one call.
ONE_CALL_MS = 250.0

# The reference's SolverService on rs8_400_s3 (JAX on the CPU, x64;
# tests/test_torch_serve.py holds the port's CPU twin to the same reports):
# per request (iters, tag, switch_iters, health, retries, est_bytes), then
# the stats.
SERVICE_REF = {
    20000: ([(1632, 3, [120, 210], "ok", 0, 48919728),
             (1752, 3, [240, 270], "ok", 0, 55134798),
             (1727, 3, [240, 270], "ok", 0, 53096498)],
            dict(batches=1, requests=3, padded_cols=1,
                 modeled_bytes=157151024, retries=0, errors=0,
                 deadline_exceeded=0)),
    200: ([(400, 3, [120, -1], "stalled", 1, 12297493),
           (400, 3, [-1, -1], "stalled", 1, 12297493),
           (400, 3, [-1, -1], "stalled", 1, 12297493)],
          dict(batches=1, requests=3, padded_cols=1, modeled_bytes=36892480,
               retries=3, errors=0, deadline_exceeded=0)),
}

# The reference's SolverService with register(..., layout="sell") on
# sk512_rs8_s0 (diag_rescale(skewed_spd(512, seed=0), 8, 0), three requests
# b_j = A x_j, x_j = default_rng(j).normal(512), slots=4; JAX on the CPU,
# x64; tests/test_torch_sell_serve.py holds the port's CPU twin to the
# same reports), in SERVICE_REF's layout.
SELL_SERVICE_REF = {
    20000: ([(1498, 3, [210, 300], "ok", 0, 406957675),
             (1498, 3, [150, 180], "ok", 0, 406957675),
             (1678, 3, [120, 150], "ok", 0, 557737195)],
            dict(batches=1, requests=3, padded_cols=1,
                 modeled_bytes=1371652544, retries=0, errors=0,
                 deadline_exceeded=0)),
    200: ([(400, 3, [-1, -1], "stalled", 1, 121413973),
           (400, 3, [150, 180], "stalled", 1, 121413973),
           (400, 3, [120, 150], "stalled", 1, 121413973)],
          dict(batches=1, requests=3, padded_cols=1, modeled_bytes=364241920,
               retries=3, errors=0, deadline_exceeded=0)),
}
N_SKEW = 1 << 18

# The reference's stepped CG on diag_rescale(skewed_spd(32768, seed=5), 8, 5)
# packed at k=8 (tol 1e-8, MonitorParams(40, 60, 30), maxiter 20000, default
# guards, b = A x, x = default_rng(1).normal(32768)), printed by
# tools/reference/skewed_stall.py 32768 (JAX on the CPU, x64): iters,
# switch_iters, tag, relres, converged, health.  The smallest n at which the
# reference stalls on this construction; phase 9 holds the port's SELL solve
# to it before the full-size run, which stalls too.
N_STALL = 1 << 15
STALL_REF = (1026, [60, 90], 3, 0.10751075182831665, False, "stalled")
# The same, served (tools/reference/skewed_stall.py --serve 32768):
# SolverService(slots=4, layout="sell") with x from seeds 1, 2, 3; per
# request (iters, switch_iters, relres, converged, health, retries,
# trip_iter), then the stats.
STALL_SERVE_REF = (
    [(3551, [60, 90], 9.997327638185412e-09, True, "ok", 1, 1025),
     (3559, [60, 90], 9.774815279656397e-09, True, "ok", 1, 1023),
     (3671, [60, 90], 9.901405357959755e-09, True, "ok", 1, 1025)],
    dict(batches=1, requests=3, padded_cols=1, modeled_bytes=262872318816,
         retries=3, errors=0, deadline_exceeded=0))


def log(phase: str, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, reps: int, inner: int = 1) -> float:
    """Minimum over ``reps`` of the CUDA-event time of ``inner`` calls.
    The first call warms up; when it alone takes ONE_CALL_MS or more (the
    plain versions), its time is the measurement."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    if first >= ONE_CALL_MS:
        return first
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def host_spmv(csr, x):
    """b = A @ x on the host, rows summed in CSR order (deterministic)."""
    import numpy as np

    rows = csr.row_ids.cpu().numpy()
    prod = csr.val.cpu().numpy() * x[csr.col.cpu().numpy()]
    return np.bincount(rows, weights=prod, minlength=csr.shape[0])


def bitwise(a, b) -> bool:
    """Equal shapes and equal bits (f32, f64 or bf16), wherever the tensors
    lie."""
    import torch

    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    view = {torch.float64: torch.int64,
            torch.bfloat16: torch.int16}.get(a.dtype, torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(view), b.view(view))


def require_bitwise(name, got, want):
    if not bitwise(got, want):
        raise AssertionError(f"{name} is not bitwise equal to its reference")


def require_same_values(name, got, want):
    """Bitwise equal where ``want`` is finite, NaN where it is NaN and the
    same infinity where it is infinite."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    fin, nan, inf = torch.isfinite(want), torch.isnan(want), torch.isinf(want)
    if not (got.shape == want.shape and torch.equal(torch.isfinite(got), fin)
            and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[inf], want[inf])
            and bitwise(got[fin], want[fin])):
        raise AssertionError(f"{name} does not give its reference's values")


def ell_padding_nan(case, g, ell, x32, x32n, scales):
    """A32 and C32 with x[0] = inf (C32: column 0 of the (n, nrhs) X) give
    their plain versions' values row for row: the plain versions read every
    padded slot (0 * x[0] = NaN), the kernels read only real slots and add
    a padded slot's product once to each row that has padding."""
    import torch

    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops

    row_len = ops.ell_row_lengths(g)
    xa, xc = x32.clone(), x32n.clone()
    xa[0] = float("inf")
    xc[0, 0] = float("inf")
    padded = int((row_len < ell[0].shape[1]).sum())
    rows_nan = {}
    for t in TAGS:
        t1 = ell[2] if t >= 2 else None
        t2 = ell[3] if t == 3 else None
        a32 = K.gse_spmv_ell_f32(ell[0], ell[1], t1, t2, xa, scales[t],
                                 ei_bit=g.ei_bit, tag=t, row_len=row_len)
        require_same_values(f"{case}: A32 tag {t} with x[0] = inf", a32,
                            K.gse_spmv_ell_f32_plain(
                                ell[0], ell[1], t1, t2, xa, scales[t],
                                ei_bit=g.ei_bit, tag=t))
        c32 = C.gse_spmm_ell_f32(ell[0], ell[1], t1, t2, xc, scales[t],
                                 ei_bit=g.ei_bit, tag=t, row_len=row_len)
        require_same_values(f"{case}: C32 tag {t} with X[0, 0] = inf", c32,
                            C.gse_spmm_ell_f32_plain(
                                ell[0], ell[1], t1, t2, xc, scales[t],
                                ei_bit=g.ei_bit, tag=t))
        rows_nan[t] = [int(torch.isnan(a32).sum()),
                       int(torch.isnan(c32[:, 0]).sum()),
                       int(torch.isnan(c32[:, 1:]).sum())]
        if rows_nan[t][0] < padded or rows_nan[t][2]:
            raise AssertionError(f"{case}: x[0] = inf gave NaN in "
                                 f"{rows_nan[t]} rows, {padded} padded")
    log("parity", case=case, check="x[0] = inf", rows=g.shape[0],
        padded_rows=padded, nan_rows_a32_c32col0_c32rest=json.dumps(rows_nan),
        same_as_plain=True)


def plan_bodies(g) -> list:
    """The bodies of kernels A64 and C64 that the row plan of ``g`` runs."""
    from repro_torch.kernels.gse_spmv import A64_BODIES

    plan = g.row_plan
    parts = (plan.long_rows, plan.warp_rows, plan.row_blocks)
    return [b for b, t in zip(A64_BODIES, parts) if t.shape[0]]


def sell_bodies(sell) -> list:
    """The bodies of kernels B32, C′32 and C′64 (split at the pack's
    ``long_from``) that the SELL pack ``sell`` runs."""
    return [b for b, n in (("block", sell.perm.shape[0] - sell.long_from),
                           ("warp", sell.long_from)) if n]


def require_bodies(where, launched: dict, bodies):
    """Every body in ``bodies`` launched (``launched``: body_launches)."""
    missing = [b for b in bodies if launched[b] <= 0]
    if missing:
        raise AssertionError(f"{where}: bodies {missing} never launched "
                             f"({launched})")


def rs8_400_s3(device):
    from repro_torch.sparse import generators as G

    return G.diag_rescale(G.random_spd(400, seed=3, device=device), 8.0, 3)


def sk512_rs8_s0(device):
    from repro_torch.sparse import generators as G

    return G.diag_rescale(G.skewed_spd(512, seed=0, device=device), 8.0, 0)


def serve_small(where: str, maxiter: int, params, case=rs8_400_s3,
                layout="csr", precond=None, **register):
    """``case`` (rs8_400_s3 or sk512_rs8_s0) through the port's
    SolverService on ``where``: three requests b_j = A x_j,
    x_j = default_rng(j).normal(n), slots=4, the handle registered with
    ``precond`` (None, "jacobi" or "spai0") and ``register``'s other
    keywords."""
    import numpy as np
    import torch

    from repro_torch.launch.solver_serve import SolverService

    host = case("cpu")
    n = host.shape[0]
    svc = SolverService(slots=NRHS, params=params, maxiter=maxiter,
                        device=where)
    svc.register("op", case(where), k=8, layout=layout, precond=precond,
                 **register)
    ids = [svc.submit("op", torch.from_numpy(host_spmv(
        host, np.random.default_rng(j).normal(size=n))), tol=1e-8)
        for j in range(3)]
    t0 = time.perf_counter()
    reports = svc.flush()
    wall = time.perf_counter() - t0
    return svc, [reports[i] for i in ids], [svc.solution(i) for i in ids], wall


def report_key(r):
    return (r.iters, r.tag, r.switch_iters.tolist(), r.health, r.retries,
            r.est_bytes)


def report_fields(r) -> dict:
    """Every field of a SolveReport, comparable with ``==``."""
    d = dataclasses.asdict(r)
    d["switch_iters"] = r.switch_iters.tolist()
    return d


def sell_against_uniform(case, g, ell, sell, x32, x64, x32c, x64c, scales):
    """B and C′ over ``sell`` bitwise A and C over the same operator ``g``
    (uniform ELL ``ell``, CSR) at tags 1-3; C′64 with tags [1, 2, 3, 1] and
    active [T, T, T, F] at nrhs 4."""
    import torch

    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops
    from repro_torch.sparse.spmv import spmv_gse

    dev = x32.device
    segs = (g.rowptr, g.colpak, g.head, g.tail1, g.tail2, g.table)
    row_len = ops.ell_row_lengths(g)
    x32n = x32c.t().contiguous()
    for t in TAGS:
        t1 = ell[2] if t >= 2 else None
        t2 = ell[3] if t == 3 else None
        require_bitwise(f"{case}: B32 tag {t} against A32",
                        ops.gse_spmv_sell(sell, x32, tag=t),
                        K.gse_spmv_ell_f32(ell[0], ell[1], t1, t2, x32,
                                           scales[t], ei_bit=g.ei_bit, tag=t,
                                           row_len=row_len))
        require_bitwise(f"{case}: B64 tag {t} against A64",
                        spmv_gse(sell, x64, t), spmv_gse(g, x64, t))
        require_bitwise(f"{case}: C′32 tag {t} against C32",
                        ops.gse_spmm_sell(sell, x32c.t(), tag=t, device=dev),
                        C.gse_spmm_ell_f32(ell[0], ell[1], t1, t2, x32n,
                                           scales[t], ei_bit=g.ei_bit, tag=t,
                                           row_len=row_len, device=dev))
    tags = torch.tensor([1, 2, 3, 1], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    require_bitwise(
        f"{case}: C′64 against C64",
        C.gse_spmm_sell_f64(*sell.segments, sell.table, x64c, tags, active,
                            sell.bucket_table, sell.perm, sell.row_len,
                            rows=g.shape[0], ei_bit=g.ei_bit,
                            long_from=sell.long_from, device=dev),
        C.gse_spmm_csr_f64(*segs, x64c, tags, active, ei_bit=g.ei_bit,
                           plan=g.row_plan, device=dev))
    log("parity", case=case, layout="sell", widths=list(sell.widths),
        bucket_rows=list(sell.bucket_rows),
        b32_bitwise_a32=True, b64_bitwise_a64=True, c32_bitwise=True,
        c64_tags=[1, 2, 3, 1], c64_bitwise=True)


def phase_sell_parity():
    """Phase 7: B and C′ across width buckets, against their plain versions
    and against A and C on the uniform ELL of the same operator."""
    import numpy as np
    import torch

    from repro_torch.core.precision_table import TAG_BITS_USED
    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops, ref
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import ell_layout, pack_csr
    from repro_torch.sparse.spmv import spmv_gse

    dev = torch.device("cuda")
    K.reset_launch_counts()
    C.reset_launch_counts()
    t0 = time.perf_counter()
    g = pack_csr(G.skewed_spd(8192, seed=0, device=dev))
    sell = ops.sell_pack_gsecsr(g)
    ell = ops.ell_pack_gsecsr(g)
    torch.cuda.synchronize()
    log("sell_parity", case="skewed_spd(8192, seed=0)", nnz=g.nnz,
        widths=list(sell.widths), bucket_rows=list(sell.bucket_rows),
        sell_padding_ratio=sell.padding_ratio,
        ell_width=ell[0].shape[1], ell_padding_ratio=ell_layout(g).padding_ratio,
        pack_s=f"{time.perf_counter() - t0:.2f}")
    m, n = g.shape
    rng = np.random.default_rng(7)
    x32 = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    x64 = torch.from_numpy(rng.normal(size=n)).to(dev)
    x32c = torch.from_numpy(
        rng.normal(size=(NRHS, n)).astype(np.float32)).to(dev)
    x64c = torch.from_numpy(rng.normal(size=(NRHS, n))).to(dev)
    scales = {t: ref.make_scales(g.table, TAG_BITS_USED[t]) for t in TAGS}
    sell_against_uniform("skewed_spd(8192)", g, ell, sell, x32, x64, x32c,
                         x64c, scales)
    x32n = x32c.t().contiguous()  # C32 and C′32 read X as (n, nrhs)
    ell_padding_nan("skewed_spd(8192)", g, ell, x32, x32n, scales)
    lay = dict(buckets=sell.bucket_table, perm=sell.perm, rows=m,
               ei_bit=g.ei_bit)
    segs = sell.segments
    for t in TAGS:
        t1 = segs[2] if t >= 2 else None
        t2 = segs[3] if t == 3 else None
        got = K.gse_spmv_sell_f32(segs[0], segs[1], t1, t2, x32, scales[t],
                                  tag=t, long_from=sell.long_from, **lay)
        want = K.gse_spmv_sell_f32_plain(segs[0], segs[1], t1, t2, x32,
                                         scales[t], tag=t, **lay)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)
        got_c = C.gse_spmm_sell_f32(segs[0], segs[1], t1, t2, x32n,
                                    scales[t], tag=t, long_from=sell.long_from,
                                    device=dev, **lay)
        want_c = C.gse_spmm_sell_f32_plain(segs[0], segs[1], t1, t2, x32n,
                                           scales[t], tag=t, **lay)
        torch.testing.assert_close(got_c, want_c, rtol=2e-5, atol=1e-4)
        b64 = K.gse_spmv_sell_f64(*segs, g.table, x64, tag=t,
                                  row_len=sell.row_len,
                                  long_from=sell.long_from, **lay)
        require_bitwise(f"B64 tag {t} against its plain version", b64,
                        K.gse_spmv_sell_f64_plain(*segs, g.table, x64, tag=t,
                                                  row_len=sell.row_len, **lay))
        log("sell_parity", tag=t, b32_max_abs_err=float(
            (got - want).abs().max()), b32_tol="rtol 2e-5 atol 1e-4",
            b32_bitwise_plain=bitwise(got, want),
            c32_max_abs_err=float((got_c - want_c).abs().max()),
            c32_bitwise_plain=bitwise(got_c, want_c), b64_bitwise_plain=True)
    tags = torch.tensor([1, 2, 3, 1], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    lay64 = dict(buckets=sell.bucket_table, perm=sell.perm,
                 row_len=sell.row_len, rows=m, ei_bit=g.ei_bit)
    require_bitwise("C′64 against its plain version",
                    C.gse_spmm_sell_f64(*segs, g.table, x64c, tags, active,
                                        long_from=sell.long_from, device=dev,
                                        **lay64),
                    C.gse_spmm_sell_f64_plain(*segs, g.table, x64c, tags,
                                              active, **lay64))
    for t in TAGS:
        require_bitwise(f"A64 tag {t} against its plain version",
                        spmv_gse(g, x64, t),
                        K.gse_spmv_csr_f64_plain(
                            g.rowptr, g.colpak, g.head, g.tail1, g.tail2,
                            g.table, x64, ei_bit=g.ei_bit, tag=t))
    launched = {"A64": dict(K.gse_spmv_csr_f64.body_launches),
                "C64": dict(C.gse_spmm_csr_f64.body_launches),
                "B32": dict(K.gse_spmv_sell_f32.body_launches),
                "C′32": dict(C.gse_spmm_sell_f32.body_launches),
                "C′64": dict(C.gse_spmm_sell_f64.body_launches)}
    for name in ("A64", "C64"):
        require_bodies(f"phase 7: {name}", launched[name], plan_bodies(g))
    for name in ("B32", "C′32", "C′64"):
        require_bodies(f"phase 7: {name}", launched[name], sell_bodies(sell))
    log("sell_parity", kernel="gse_spmm_sell_f64", tags=[1, 2, 3, 1],
        active=[True, True, True, False], bitwise_plain=True,
        a64_bitwise_plain=True, body_launches=json.dumps(launched))


_SKEWED: dict = {}


def skewed_base(dev, last: bool = False):
    """``skewed_spd(N_SKEW, seed=5)`` on ``dev``, generated once for phases
    9 and 22 (each rescales it its own way); ``last`` drops the kept
    copy."""
    from repro_torch.sparse import generators as G

    base = _SKEWED.get(dev)
    if base is None:
        base = G.skewed_spd(N_SKEW, seed=5, device=dev)
        if not last:
            _SKEWED[dev] = base
    elif last:
        del _SKEWED[dev]
    return base


def sell_solo(where, params):
    """Phase 8's solo solve: sk512_rs8_s0 over its SELL pack on
    ``where``; returns the result and the seconds."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse.csr import pack_csr

    host = sk512_rs8_s0("cpu")
    b0 = torch.from_numpy(host_spmv(
        host, np.random.default_rng(0).normal(size=host.shape[0])))
    sell = ops.sell_pack_gsecsr(pack_csr(sk512_rs8_s0(where)))
    t0 = time.perf_counter()
    r = solve_cg(sell, b0.to(where), tol=1e-8, maxiter=20000, params=params)
    return r, time.perf_counter() - t0


def phase_sell_trajectory(params, twins=None):
    """Phase 8: sk512_rs8_s0 over its SELL pack, solo and served, on the
    GPU against the CPU twin and the reference's reports.  Returns the
    service's reports and solutions at maxiter 20000 (phase 25's untuned
    handle)."""
    rg, tg_s = sell_solo("cuda", params)
    (rc, tc_s), (reps_c, xs_c, wall_c) = twin_of(twins, "sell")
    log("sell_trajectory", case="sk512_rs8_s0", layout="sell",
        gpu_iters=int(rg.iters), cpu_iters=int(rc.iters), tag=int(rg.tag),
        switch_iters=rg.switch_iters.tolist(), relres=float(rg.relres),
        gpu_s=f"{tg_s:.2f}", cpu_s=f"{tc_s:.2f}")
    got = (int(rg.iters), int(rg.tag), rg.switch_iters.tolist())
    if got != (1498, 3, [210, 300]):
        raise AssertionError(f"sk512_rs8_s0 over SELL on the GPU: {got}")
    require_bitwise("sk512_rs8_s0 x against the CPU twin", rg.x, rc.x)
    require_bitwise("sk512_rs8_s0 relres against the CPU twin", rg.relres,
                    rc.relres)
    for maxiter in (20000, 200):
        svc_g, reps_g, xs_g, wall_g = serve_small(
            "cuda", maxiter, params, case=sk512_rs8_s0, layout="sell")
        want, want_stats = SELL_SERVICE_REF[maxiter]
        got = [report_key(r) for r in reps_g]
        if got != want or svc_g.stats != want_stats:
            raise AssertionError(f"sell service at maxiter {maxiter}: {got} "
                                 f"{svc_g.stats} != {want} {want_stats}")
        twin = {}
        if maxiter == 20000:
            untuned = (reps_g, xs_g)
        if maxiter == 200:  # the tag-3 retry: GPU == CPU twin, bit for bit
            for rg_, rc_, xg_, xc_ in zip(reps_g, reps_c, xs_g, xs_c):
                if report_fields(rg_) != report_fields(rc_):
                    raise AssertionError(f"GPU report {rg_} != CPU {rc_}")
                require_bitwise(f"sell service x of request {rg_.id}", xg_,
                                xc_)
            twin = dict(cpu_twin_bitwise=True, cpu_s=f"{wall_c:.2f}")
        log("sell_trajectory", case="sk512_rs8_s0", service_maxiter=maxiter,
            iters=[r.iters for r in reps_g],
            switch_iters=[r.switch_iters.tolist() for r in reps_g],
            health=[r.health for r in reps_g],
            est_bytes=[r.est_bytes for r in reps_g],
            stats=json.dumps(dict(svc_g.stats)), matches_reference=True,
            gpu_s=f"{wall_g:.2f}", **twin)
    return untuned


def sell_stall_witness(params):
    """Phase 9's first check: the port's SELL solve and SELL service on the
    GPU at n = 32768 end as the reference's do (STALL_REF, STALL_SERVE_REF),
    so the full-size stall and retry are the construction's and not the
    port's."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.robustness.guards import health_name
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    csr = G.diag_rescale(G.skewed_spd(N_STALL, seed=5, device="cuda"), 8.0, 5)
    b = torch.from_numpy(host_spmv(
        csr, np.random.default_rng(1).normal(size=N_STALL))).cuda()
    sell = ops.sell_pack_gsecsr(pack_csr(csr))
    t0 = time.perf_counter()
    r = solve_cg(sell, b, tol=1e-8, maxiter=20000, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (int(r.iters), r.switch_iters.tolist(), int(r.tag),
           float(r.relres), bool(r.converged), health_name(r.health))
    log("sell", witness=f"diag_rescale(skewed_spd({N_STALL}, seed=5), 8, 5)",
        iters=got[0], switch_iters=got[1], tag=got[2], relres=repr(got[3]),
        converged=got[4], health=got[5], reference=STALL_REF,
        wall_s=f"{wall:.2f}")
    if got != STALL_REF:
        raise AssertionError(f"SELL solve at n = {N_STALL}: {got} != the "
                             f"reference's {STALL_REF}")
    svc = SolverService(slots=NRHS, params=params, maxiter=20000,
                        device="cuda")
    svc.register("op", csr, k=8, layout="sell")
    ids = [svc.submit("op", torch.from_numpy(host_spmv(
        csr, np.random.default_rng(seed).normal(size=N_STALL))).cuda(),
        tol=1e-8) for seed in (1, 2, 3)]
    t0 = time.perf_counter()
    reports = svc.flush()
    wall = time.perf_counter() - t0
    got = [(r.iters, r.switch_iters.tolist(), r.relres, r.converged,
            r.health, r.retries, r.trip_iter) for r in
           (reports[i] for i in ids)]
    log("sell", witness="the same, served (layout=sell)",
        requests=got, stats=json.dumps(dict(svc.stats)),
        flush_s=f"{wall:.2f}")
    if (got, svc.stats) != STALL_SERVE_REF:
        raise AssertionError(f"SELL service at n = {N_STALL}: {got} "
                             f"{svc.stats} != the reference's "
                             f"{STALL_SERVE_REF}")


def phase_sell_full(params):
    """Phase 9: the SELL path at full size on the skewed operator, counted.
    Returns what phase 10 times."""
    import numpy as np
    import torch

    from repro_torch.core.precision_table import TAG_BITS_USED
    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops, ref
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.robustness.guards import health_name
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import ell_layout, pack_csr
    from repro_torch.sparse.spmv import spmv_gse

    sell_stall_witness(params)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    csr = G.diag_rescale(skewed_base(dev), 8.0, 5)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = pack_csr(csr)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sell = ops.sell_pack_gsecsr(g)
    torch.cuda.synchronize()
    sell_s = time.perf_counter() - t0
    lens = (g.rowptr[1:] - g.rowptr[:-1]).cpu().numpy()
    longest = int(lens.max())
    log("sell", case=f"diag_rescale(skewed_spd({N_SKEW}, seed=5), 8, 5)",
        nnz=g.nnz, longest_row=longest, widths=list(sell.widths),
        bucket_rows=list(sell.bucket_rows), slots=sell.slots,
        padding_ratio=sell.padding_ratio,
        uniform_ell_slots_not_allocated=ell_layout(g).slots,
        generate_s=f"{gen_s:.2f}", pack_csr_s=f"{pack_s:.2f}",
        sell_pack_s=f"{sell_s:.2f}")
    m, n = g.shape
    rng = np.random.default_rng(11)
    x32 = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
    x32c = torch.from_numpy(
        rng.normal(size=(NRHS, n)).astype(np.float32)).to(dev)
    x_true = np.random.default_rng(1).normal(size=n)
    b = torch.from_numpy(host_spmv(csr, x_true)).to(dev)
    bs = [b] + [torch.from_numpy(host_spmv(
        csr, np.random.default_rng(seed).normal(size=n))).to(dev)
        for seed in (2, 3)]
    scales = {t: ref.make_scales(g.table, TAG_BITS_USED[t]) for t in TAGS}
    # The warp rows of B64 and C′64 keep A64's and C64's chains over the
    # hub rows too (uncounted: before the path's run).
    x64 = torch.from_numpy(rng.normal(size=n)).to(dev)
    x64c = torch.from_numpy(rng.normal(size=(NRHS, n))).to(dev)
    for t in TAGS:
        require_bitwise(f"full size: B64 tag {t} against A64",
                        spmv_gse(sell, x64, t), spmv_gse(g, x64, t))
    mixed = torch.tensor([1, 2, 3, 1], dtype=torch.int32, device=dev)
    active = torch.tensor([True, True, True, False], device=dev)
    C.reset_launch_counts()
    csr_args = (g.rowptr, g.colpak, g.head, g.tail1, g.tail2, g.table)
    c64 = C.gse_spmm_csr_f64(*csr_args, x64c, mixed, active, ei_bit=g.ei_bit,
                             plan=g.row_plan, device=dev)
    c64_parity = {"launches": C.gse_spmm_csr_f64.launches,
                  "bodies": dict(C.gse_spmm_csr_f64.body_launches)}
    require_bodies("phase 9: C64 (full size)", c64_parity["bodies"],
                   plan_bodies(g))
    require_bitwise("full size: C′64 against C64",
                    C.gse_spmm_sell_f64(*sell.segments, g.table, x64c, mixed,
                                        active, sell.bucket_table, sell.perm,
                                        sell.row_len, rows=m, ei_bit=g.ei_bit,
                                        long_from=sell.long_from, device=dev),
                    c64)
    require_bitwise("full size: C64 against its plain version", c64,
                    C.gse_spmm_csr_f64_plain(*csr_args, x64c, mixed, active,
                                             ei_bit=g.ei_bit))
    for j in range(3):
        require_bitwise(f"full size: C64 column {j} against A64 at tag "
                        f"{j + 1}", c64[j],
                        K.gse_spmv_csr_f64(*csr_args, x64c[j], ei_bit=g.ei_bit,
                                           tag=j + 1, plan=g.row_plan))
    del c64
    log("sell", b64_bitwise_a64=True, c64_bitwise_c64=True,
        c64_bitwise_plain=True, c64_columns_bitwise_a64=True,
        c64_tags=[1, 2, 3, 1],
        c64_body_launches=json.dumps(c64_parity["bodies"]))
    torch.cuda.synchronize()
    for mod in (K, C, V):
        mod.reset_launch_counts()
    b32_launches, c32_launches, b32_err, c32_err = {}, {}, {}, {}
    segs = sell.segments
    for t in TAGS:
        before = K.gse_spmv_sell_f32.launches
        y = ops.gse_spmv_sell(sell, x32, tag=t)
        b32_launches[t] = K.gse_spmv_sell_f32.launches - before
        want = K.gse_spmv_sell_f32_plain(
            segs[0], segs[1], segs[2] if t >= 2 else None,
            segs[3] if t == 3 else None, x32, scales[t], sell.bucket_table,
            sell.perm, rows=m, ei_bit=g.ei_bit, tag=t)
        torch.testing.assert_close(y, want, rtol=2e-5, atol=1e-4)
        b32_err[t] = float((y - want).abs().max())
        before = C.gse_spmm_sell_f32.launches
        yc = ops.gse_spmm_sell(sell, x32c.t(), tag=t, device=dev)
        c32_launches[t] = C.gse_spmm_sell_f32.launches - before
        want_c = C.gse_spmm_sell_f32_plain(
            segs[0], segs[1], segs[2] if t >= 2 else None,
            segs[3] if t == 3 else None, x32c.t(), scales[t],
            sell.bucket_table, sell.perm, rows=m, ei_bit=g.ei_bit, tag=t)
        torch.testing.assert_close(yc, want_c, rtol=2e-5, atol=1e-4)
        c32_err[t] = float((yc - want_c).abs().max())
        log("sell", kernel="gse_spmv_sell_f32", tag=t,
            max_abs_err=b32_err[t], tol="rtol 2e-5 atol 1e-4",
            bitwise_plain=bitwise(y, want))
        log("sell", kernel="gse_spmm_sell_f32", tag=t, nrhs=NRHS,
            max_abs_err=c32_err[t], tol="rtol 2e-5 atol 1e-4",
            bitwise_plain=bitwise(yc, want_c))
        del want, want_c
    t0 = time.perf_counter()
    res = solve_cg(sell, b, tol=1e-8, maxiter=20000, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log("sell", solve="solve_cg(sell)", iters=int(res.iters),
        switch_iters=res.switch_iters.tolist(), tag=int(res.tag),
        relres=float(res.relres), converged=bool(res.converged),
        health=health_name(res.health), trip_iter=int(res.trip_iter),
        wall_s=f"{wall:.2f}",
        ms_per_iteration=f"{wall * 1e3 / max(int(res.iters), 1):.3f}")
    # The stepped solve may stall here: the reference stalls on the same
    # construction from n = 32768 on (1026 iterations, [60, 90], health
    # stalled); its service then converges every request with the tag-3
    # retry.  A breakdown, divergence or non-finite x is a failure.
    if health_name(res.health) not in ("ok", "stalled"):
        raise AssertionError(f"full-size SELL solve ended "
                             f"{health_name(res.health)}")
    if not bool(torch.isfinite(res.x).all()):
        raise AssertionError("full-size SELL solve returned a non-finite x")
    # What the service does with request 0: the batched column (the solo
    # solve), then, unless it converged, one tag-3 retry from its x.
    want0 = dict(iters=int(res.iters), relres=float(res.relres),
                 converged=bool(res.converged), tag=int(res.tag),
                 health=health_name(res.health), retries=0)
    x_want0 = res.x
    if not bool(res.converged):
        t0 = time.perf_counter()
        retry = solve_cg(sell, b, x0=res.x, tol=1e-8, maxiter=20000,
                         params=params, init_tag=3)
        torch.cuda.synchronize()
        retry_s = time.perf_counter() - t0
        want0 = dict(iters=int(res.iters) + int(retry.iters),
                     relres=float(retry.relres),
                     converged=bool(retry.converged), tag=int(retry.tag),
                     health=health_name(retry.health), retries=1)
        x_want0 = retry.x
        log("sell", solve="tag-3 retry from the solo x", iters=int(retry.iters),
            relres=float(retry.relres), converged=bool(retry.converged),
            health=health_name(retry.health), wall_s=f"{retry_s:.2f}",
            ms_per_iteration=f"{retry_s * 1e3 / max(int(retry.iters), 1):.3f}")
    a64_before = K.gse_spmv_csr_f64.launches
    t0 = time.perf_counter()
    short_csr = solve_cg(g, b, tol=1e-8, maxiter=256, params=params)
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    a64_launches = K.gse_spmv_csr_f64.launches - a64_before
    t0 = time.perf_counter()
    short_sell = solve_cg(sell, b, tol=1e-8, maxiter=256, params=params)
    torch.cuda.synchronize()
    sell256_s = time.perf_counter() - t0
    require_bitwise("256 SELL iterations against 256 CSR iterations",
                    short_sell.x, short_csr.x)
    if short_sell.switch_iters.tolist() != short_csr.switch_iters.tolist():
        raise AssertionError("SELL and CSR switch at different iterations")
    log("sell", check="256 iterations, CSR against SELL", x_bitwise=True,
        switch_iters=short_sell.switch_iters.tolist(),
        csr_ms_per_iteration=f"{csr_s * 1e3 / 256:.3f}",
        sell_ms_per_iteration=f"{sell256_s * 1e3 / 256:.3f}")
    t0 = time.perf_counter()
    svc = SolverService(slots=NRHS, params=params, maxiter=20000, device=dev)
    svc.register("skewed", csr, k=8, layout="sell")
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    ids = [svc.submit("skewed", bj, tol=1e-8) for bj in bs]
    t0 = time.perf_counter()
    reports = svc.flush()
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    reps = [reports[i] for i in ids]
    x_req0 = svc.solution(ids[0])
    counts = {
        "b32": b32_launches, "c32": c32_launches,
        "b64": K.gse_spmv_sell_f64.launches,
        "c64": C.gse_spmm_sell_f64.launches, "a64": a64_launches,
        "gse_spmv_csr_f64_bodies": dict(K.gse_spmv_csr_f64.body_launches),
        "gse_spmm_sell_f64_bodies": dict(C.gse_spmm_sell_f64.body_launches),
        "gse_spmv_sell_f32_bodies": dict(K.gse_spmv_sell_f32.body_launches),
        "gse_spmm_sell_f32_bodies": dict(C.gse_spmm_sell_f32.body_launches),
        "c64_parity": c64_parity,
        "seq_dot": V.seq_dot.launches,
        "seq_dot_cols": V.seq_dot_cols.launches}
    log("sell", service="layout=sell", rows=m, slots=NRHS,
        requests=len(reps), iters=[r.iters for r in reps],
        tag=[r.tag for r in reps],
        switch_iters=[r.switch_iters.tolist() for r in reps],
        health=[r.health for r in reps], retries=[r.retries for r in reps],
        relres=[r.relres for r in reps], est_bytes=[r.est_bytes for r in reps],
        stats=json.dumps(dict(svc.stats)), register_s=f"{register_s:.2f}",
        flush_s=f"{serve_wall:.2f}",
        b32_launches=sum(b32_launches.values()),
        b32_body_launches=json.dumps(counts["gse_spmv_sell_f32_bodies"]),
        c32_launches=sum(c32_launches.values()),
        c32_body_launches=json.dumps(counts["gse_spmm_sell_f32_bodies"]),
        b64_launches=counts["b64"],
        c64_launches=counts["c64"],
        c64_body_launches=json.dumps(counts["gse_spmm_sell_f64_bodies"]),
        a64_launches=counts["a64"],
        a64_body_launches=json.dumps(counts["gse_spmv_csr_f64_bodies"]))
    got0 = {k: getattr(reps[0], k) for k in want0}
    if got0 != want0 or reps[0].switch_iters.tolist() != \
            res.switch_iters.tolist():
        raise AssertionError(f"request 0 {reps[0]} != the solo solve {want0}")
    require_bitwise("request 0's x against the solo SELL solve", x_req0,
                    x_want0)
    for r in reps:
        if not r.converged or r.health != "ok":
            raise AssertionError(f"full-size SELL request {r.id}: {r}")
    if svc.stats["errors"] != 0:
        raise AssertionError(f"service errors: {svc.stats}")
    if min(counts["b64"], counts["c64"], counts["a64"],
           *b32_launches.values(), *c32_launches.values()) <= 0:
        raise AssertionError("a kernel of the SELL path never launched")
    require_bodies("phase 9: A64 (256 CSR iterations)",
                   counts["gse_spmv_csr_f64_bodies"], plan_bodies(g))
    require_bodies("phase 9: C′64 (the service)",
                   counts["gse_spmm_sell_f64_bodies"], sell_bodies(sell))
    require_bodies("phase 9: B32", counts["gse_spmv_sell_f32_bodies"],
                   sell_bodies(sell))
    require_bodies("phase 9: C′32", counts["gse_spmm_sell_f32_bodies"],
                   sell_bodies(sell))
    return dict(csr=csr, g=g, sell=sell, x32=x32, x32c=x32c, counts=counts,
                b32_err=b32_err, c32_err=c32_err, scales=scales,
                longest=longest, b=b, x256=short_sell.x)


def sell_entries(ctx, add_entry, chain_bound_ms):
    """Phase 10's entries for kernels B and C′ (and A64 and C64 on the
    CSR) on phase 9's operator; ``chain_bound_ms`` is the f64 kernels'
    chain bound there (the longest row's dependent adds).  A64, B32, C′32,
    C′64 and C64 carry their launches per body in phase 9's run
    (``body_launches``; C64's in its full-size check, its one launch
    there).  A64, B32, B64, C′32, C′64 and C64 also carry their time split
    by body: ``long_rows_ms`` (the long rows' blocks alone),
    ``other_rows_ms`` (every other row alone), and C′64 ``one_column_ms``
    (every row, one active column of four).  C′32 also carries
    ``two_launches_ms`` (the two parts launched one after the other),
    ``nrhs8_ms`` (eight columns, two passes) and ``x_copy_ms`` (the copy
    of X its earlier op made)."""
    import numpy as np
    import torch

    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ref
    from repro_torch.sparse.csr import RowPlan
    from repro_torch.sparse.spmv import decode_gsecsr

    g, sell, counts = ctx["g"], ctx["sell"], ctx["counts"]
    x32, x32c, scales = ctx["x32"], ctx["x32c"], ctx["scales"]
    dev = x32.device
    m, n = g.shape
    rng = np.random.default_rng(12)
    x64 = torch.from_numpy(rng.normal(size=n)).to(dev)
    x64c = torch.from_numpy(rng.normal(size=(NRHS, n))).to(dev)
    x32n = x32c.t().contiguous()
    x64n = x64c.t().contiguous()
    all_on = torch.ones(NRHS, dtype=torch.bool, device=dev)
    segs = sell.segments
    lay = dict(buckets=sell.bucket_table, perm=sell.perm, rows=m,
               ei_bit=g.ei_bit)
    lay64 = dict(lay, row_len=sell.row_len)
    long_from = sell.long_from
    csr_args = (g.rowptr, g.colpak, g.head, g.tail1, g.tail2, g.table)
    # The parts of the split: A64 under a plan holding only some rows,
    # B64 and C′64 with the other rows' perm set to -1 (skipped).
    plan, none = g.row_plan, g.row_plan.long_rows[:0]
    perm_long, perm_other = sell.perm.clone(), sell.perm.clone()
    perm_long[:long_from] = -1
    perm_other[long_from:] = -1
    parts = {"long_rows": (RowPlan(plan.long_rows, none, plan.row_blocks[:0],
                                   plan.rows), perm_long),
             "other_rows": (RowPlan(none, plan.warp_rows, plan.row_blocks,
                                    plan.rows), perm_other)}
    one_on = torch.zeros(NRHS, dtype=torch.bool, device=dev)
    one_on[0] = True
    src = "src/repro_torch/kernels/csrc/gse_sell.cu"
    spmv_src = "src/repro_torch/kernels/csrc/gse_spmv.cu"
    spmm_src = "src/repro_torch/kernels/csrc/gse_spmm.cu"
    bodies = {"gse_spmv_csr_f64.skewed": counts["gse_spmv_csr_f64_bodies"],
              "gse_spmv_sell_f32": counts["gse_spmv_sell_f32_bodies"],
              "gse_spmm_sell_f32": counts["gse_spmm_sell_f32_bodies"],
              "gse_spmm_sell_f64": counts["gse_spmm_sell_f64_bodies"],
              "gse_spmm_csr_f64.skewed": counts["c64_parity"]["bodies"]}
    x32n8 = torch.from_numpy(rng.normal(size=(n, 2 * NRHS)).astype(
        np.float32)).to(dev)
    for t in TAGS:
        t1 = segs[2] if t >= 2 else None
        t2 = segs[3] if t == 3 else None
        vals32 = ref.decode_csr_ref(g.colpak, g.head, g.tail1, g.tail2,
                                    g.table, g.ei_bit, t)
        vals64, cols = decode_gsecsr(g, t)
        lib32 = torch.sparse_csr_tensor(g.rowptr, cols.to(torch.int32), vals32,
                                        (m, n))
        lib64 = torch.sparse_csr_tensor(g.rowptr, cols.to(torch.int32), vals64,
                                        (m, n))
        tags_t = torch.full((NRHS,), t, dtype=torch.int32, device=dev)
        # The f64 builds repeat their plain versions' sums, so they are held
        # bitwise; their entries' max_abs_err is then 0.
        pairs = (
            ("B64", K.gse_spmv_sell_f64(*segs, g.table, x64, tag=t,
                                        long_from=long_from, **lay64),
             K.gse_spmv_sell_f64_plain(*segs, g.table, x64, tag=t, **lay64)),
            ("C′64", C.gse_spmm_sell_f64(*segs, g.table, x64c, tags_t, all_on,
                                         long_from=long_from, device=dev,
                                         **lay64),
             C.gse_spmm_sell_f64_plain(*segs, g.table, x64c, tags_t, all_on,
                                       **lay64)),
            ("A64 on the skewed CSR",
             K.gse_spmv_csr_f64(*csr_args, x64, ei_bit=g.ei_bit, tag=t,
                                plan=g.row_plan),
             K.gse_spmv_csr_f64_plain(*csr_args, x64, ei_bit=g.ei_bit,
                                      tag=t)),
            ("C64 on the skewed CSR",
             C.gse_spmm_csr_f64(*csr_args, x64c, tags_t, all_on,
                                ei_bit=g.ei_bit, plan=g.row_plan, device=dev),
             C.gse_spmm_csr_f64_plain(*csr_args, x64c, tags_t, all_on,
                                      ei_bit=g.ei_bit)))
        errs64 = {}
        for what, got, want in pairs:
            require_bitwise(f"full size: {what} tag {t} against its plain "
                            "version", got, want)
            errs64[what] = float((got - want).abs().max())
        del pairs
        split = {}
        for part, (plan_p, perm_p) in parts.items():
            lay_p = dict(lay64, perm=perm_p)
            for name, fn in (
                ("gse_spmv_csr_f64.skewed", lambda: K.gse_spmv_csr_f64(
                    *csr_args, x64, ei_bit=g.ei_bit, tag=t, plan=plan_p)),
                ("gse_spmm_csr_f64.skewed", lambda: C.gse_spmm_csr_f64(
                    *csr_args, x64c, tags_t, all_on, ei_bit=g.ei_bit,
                    plan=plan_p, device=dev)),
                ("gse_spmv_sell_f32", lambda: K.gse_spmv_sell_f32(
                    segs[0], segs[1], t1, t2, x32, scales[t], tag=t,
                    long_from=long_from, **dict(lay, perm=perm_p))),
                ("gse_spmm_sell_f32", lambda: C.gse_spmm_sell_f32(
                    segs[0], segs[1], t1, t2, x32n, scales[t], tag=t,
                    long_from=long_from, device=dev,
                    **dict(lay, perm=perm_p))),
                ("gse_spmv_sell_f64", lambda: K.gse_spmv_sell_f64(
                    *segs, g.table, x64, tag=t, long_from=long_from,
                    **lay_p)),
                ("gse_spmm_sell_f64", lambda: C.gse_spmm_sell_f64(
                    *segs, g.table, x64c, tags_t, all_on,
                    long_from=long_from, device=dev, **lay_p))):
                split.setdefault(name, {})[f"{part}_ms"] = cuda_ms(
                    fn, reps=5, inner=4)
        c32 = split["gse_spmm_sell_f32"]
        parts_c32 = [dict(lay, perm=perm_p) for _, perm_p in parts.values()]
        # The parts as two launches, one after the other, against the one
        # launch that runs both.
        c32["two_launches_ms"] = cuda_ms(lambda: [C.gse_spmm_sell_f32(
            segs[0], segs[1], t1, t2, x32n, scales[t], tag=t,
            long_from=long_from, device=dev, **lay_p) for lay_p in parts_c32],
            reps=5, inner=4)
        # Eight columns in two passes of four (the pass width).
        c32["nrhs8_ms"] = cuda_ms(lambda: C.gse_spmm_sell_f32(
            segs[0], segs[1], t1, t2, x32n8, scales[t], tag=t,
            long_from=long_from, device=dev, **lay), reps=5, inner=4)
        # The (nrhs, n) -> (n, nrhs) copy that the earlier op made, and
        # that an interleaved copy of X (C64's) would make.
        c32["x_copy_ms"] = cuda_ms(lambda: x32c.t().contiguous(), reps=5,
                                   inner=4)
        split["gse_spmm_sell_f64"]["one_column_ms"] = cuda_ms(
            lambda: C.gse_spmm_sell_f64(*segs, g.table, x64c, tags_t, one_on,
                                        long_from=long_from, device=dev,
                                        **lay64), reps=5, inner=4)
        b64_err, c64_err = errs64["B64"], errs64["C′64"]
        a64_err = errs64["A64 on the skewed CSR"]
        c64_csr_err = errs64["C64 on the skewed CSR"]
        c32_err = ctx["c32_err"][t]
        # B32 and C′32 read every padded slot (sell.bytes_touched); B64 and
        # C′64 read only each row's real slots, so their bound charges the
        # CSR's per-nonzero bytes, the exponent table and the bucket rows'
        # perm and row_len (plus the small bucket table).
        f64_bytes = (g.nnz * g.bytes_per_nnz(t) + g.table.numel() * 4
                     + sum(a.numel() * a.element_size() for a in
                           (sell.perm, sell.row_len, sell.bucket_table)))
        for (name, source, replaces, launch, plain, lib, nbytes, ncols,
             ops_rate, err, count) in (
            ("gse_spmv_sell_f32", src, "src/repro/kernels/gse_spmv.py:178",
             lambda: K.gse_spmv_sell_f32(segs[0], segs[1], t1, t2, x32,
                                         scales[t], tag=t,
                                         long_from=long_from, **lay),
             lambda: K.gse_spmv_sell_f32_plain(segs[0], segs[1], t1, t2, x32,
                                               scales[t], tag=t, **lay),
             lambda: torch.mv(lib32, x32),
             sell.bytes_touched(t) + (m + n) * 4, 1, FP32_OPS_PER_S,
             ctx["b32_err"][t], counts["b32"][t]),
            ("gse_spmv_sell_f64", src, "src/repro/kernels/gse_spmv.py:178",
             lambda: K.gse_spmv_sell_f64(*segs, g.table, x64, tag=t,
                                         long_from=long_from, **lay64),
             lambda: K.gse_spmv_sell_f64_plain(*segs, g.table, x64, tag=t,
                                               **lay64),
             lambda: torch.mv(lib64, x64),
             f64_bytes + (m + n) * 8, 1, FP64_OPS_PER_S, b64_err,
             counts["b64"]),
            ("gse_spmm_sell_f32", src, "src/repro/kernels/gse_spmm.py:155",
             lambda: C.gse_spmm_sell_f32(segs[0], segs[1], t1, t2, x32n,
                                         scales[t], tag=t, long_from=long_from,
                                         device=dev, **lay),
             lambda: C.gse_spmm_sell_f32_plain(segs[0], segs[1], t1, t2,
                                               x32n, scales[t], tag=t, **lay),
             lambda: torch.mm(lib32, x32n),
             sell.bytes_touched(t) + NRHS * (m + n) * 4, NRHS,
             FP32_OPS_PER_S, c32_err, counts["c32"][t]),
            ("gse_spmm_sell_f64", src, "src/repro/kernels/gse_spmm.py:155",
             lambda: C.gse_spmm_sell_f64(*segs, g.table, x64c, tags_t, all_on,
                                         long_from=long_from, device=dev,
                                         **lay64),
             lambda: C.gse_spmm_sell_f64_plain(*segs, g.table, x64c, tags_t,
                                               all_on, **lay64),
             lambda: torch.mm(lib64, x64n),
             f64_bytes + NRHS * (m + n) * 8, NRHS,
             FP64_OPS_PER_S, c64_err, counts["c64"]),
            ("gse_spmv_csr_f64.skewed", spmv_src,
             "src/repro/kernels/gse_spmv.py:160",
             lambda: K.gse_spmv_csr_f64(*csr_args, x64, ei_bit=g.ei_bit,
                                        tag=t, plan=g.row_plan),
             lambda: K.gse_spmv_csr_f64_plain(*csr_args, x64,
                                              ei_bit=g.ei_bit, tag=t),
             lambda: torch.mv(lib64, x64),
             g.bytes_touched(t) + (m + n) * 8, 1, FP64_OPS_PER_S, a64_err,
             counts["a64"]),
            ("gse_spmm_csr_f64.skewed", spmm_src,
             "src/repro/kernels/gse_spmm.py:137",
             lambda: C.gse_spmm_csr_f64(*csr_args, x64c, tags_t, all_on,
                                        ei_bit=g.ei_bit, plan=g.row_plan,
                                        device=dev),
             lambda: C.gse_spmm_csr_f64_plain(*csr_args, x64c, tags_t, all_on,
                                              ei_bit=g.ei_bit),
             lambda: torch.mm(lib64, x64n),
             g.bytes_touched(t) + NRHS * (m + n) * 8, NRHS, FP64_OPS_PER_S,
             c64_csr_err, counts["c64_parity"]["launches"]),
        ):
            # The decode once per nonzero, then a product and a sum per
            # column.
            nops = g.nnz * (DECODE_OPS[t] - 2 + 2 * ncols)
            extra = dict(tag=t, nrhs=ncols, launches=count, max_abs_err=err,
                         longest_row=ctx["longest"])
            if name.endswith("f64") or name.endswith("skewed"):
                extra["launches_all_tags"] = True  # the tag is chosen on device
                extra["chain_bound_ms"] = chain_bound_ms
            if name in bodies:
                extra["body_launches"] = bodies[name]
            extra.update(split.get(name, {}))
            add_entry(f"{name}.tag{t}", source, replaces, launch, plain, lib,
                      nbytes, nops / ops_rate * 1e3, plain_reps=1, reps=5,
                      inner=4, **extra)
        del lib32, lib64, vals32, vals64, cols


# Phase 10's width sweep: one synthetic operator per row length, each row
# run by one of A64's bodies (and B64's, which share them) at a time.
SWEEP_BLOCK = (512, 1024, 2048, 4096, 8192, 16384, 65536)  # block vs warp
SWEEP_SHORT = (8, 16, 32, 64, 128, 256, 512)  # row block vs warp
SWEEP_SLOTS = 1 << 22  # entries of each synthetic operator
SWEEP_FEW = 8  # rows of the few-row operators (a skewed operator's hubs)
SWEEP_TAGS = (1, 3)


def sweep_operator(length: int, seed: int, dev, rows: int | None = None):
    """A synthetic GSE-SEM CSR of ``rows`` (default ``SWEEP_SLOTS //
    length``) rows of ``length`` entries each, over 2^20 columns at k = 8:
    columns, exponent indices and segments drawn from numpy's
    ``default_rng(seed)``, the table's exponents near 1023.  Returns
    (rowptr, segments, table, x)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows = SWEEP_SLOTS // length if rows is None else rows
    n, ei_bit = N_FULL, 3
    nnz = rows * length
    colpak = (rng.integers(0, 1 << ei_bit, nnz, dtype=np.uint32)
              << np.uint32(32 - ei_bit)) | rng.integers(0, n, nnz,
                                                      dtype=np.uint32)
    segs = (colpak, rng.integers(0, 1 << 16, nnz, dtype=np.uint16),
            rng.integers(0, 1 << 16, nnz, dtype=np.uint16),
            rng.integers(0, 1 << 32, nnz, dtype=np.uint32))
    rowptr = np.arange(rows + 1, dtype=np.int32) * length
    table = rng.integers(1020, 1028, 1 << ei_bit, dtype=np.int32)

    def dev_t(a):
        return torch.from_numpy(a).to(dev)

    return (dev_t(rowptr), tuple(dev_t(a) for a in segs), dev_t(table),
            dev_t(rng.normal(size=n)))


def width_sweep(dev) -> dict:
    """Phase 10's width sweep: A64 with every row on one body, the block
    body against the warp body at SWEEP_BLOCK's lengths (on 2^22 entries,
    and on SWEEP_FEW rows, where a row's chain is the whole call) and the
    row-block body against the warp body at SWEEP_SHORT's, tags 1 and 3,
    each held bitwise to the plain version at tags 1-3 first.  Returns
    ``{(length, rows): {tag: {body: ms}}}`` and logs the crossovers."""
    from repro_torch.kernels import gse_spmv as K
    from repro_torch.sparse.csr import ROW_BLOCK_SLOTS, csr_row_plan

    never = 1 << 31
    plans = {"block": dict(warp_len=1, block_len=1),
             "warp": dict(warp_len=1, block_len=never),
             "row_block": dict(warp_len=ROW_BLOCK_SLOTS + 1, block_len=never)}
    out = {}
    cases = [(length, SWEEP_SLOTS // length) for length in
             sorted(set(SWEEP_BLOCK) | set(SWEEP_SHORT))]
    cases += [(length, SWEEP_FEW) for length in SWEEP_BLOCK]
    for length, rows in cases:
        rowptr, segs, table, x = sweep_operator(length, length, dev, rows)
        bodies = ["warp"] + (["block"] if length in SWEEP_BLOCK else []) + (
            ["row_block"] if length in SWEEP_SHORT and rows > SWEEP_FEW
            else [])
        res = out[length, rows] = {}
        for t in TAGS:
            want = K.gse_spmv_csr_f64_plain(rowptr, *segs, table, x,
                                            ei_bit=3, tag=t)
            res[t] = {}
            for body in bodies:
                plan = csr_row_plan(rowptr, **plans[body])

                def run():
                    return K.gse_spmv_csr_f64(rowptr, *segs, table, x,
                                              ei_bit=3, tag=t, plan=plan)

                require_bitwise(f"sweep: A64's {body} body at length "
                                f"{length}, {rows} rows, tag {t}", run(),
                                want)
                if t in SWEEP_TAGS:
                    res[t][body] = cuda_ms(run, reps=5, inner=4)
            log("sweep", length=length, rows=rows, tag=t, bitwise_plain=True,
                **{f"{b}_ms": f"{ms:.4f}" for b, ms in res[t].items()})
            del want

    def wins(lengths, rows, body):
        return [length for length in lengths
                if all(out[length, rows(length)][t][body] <
                       out[length, rows(length)][t]["warp"]
                       for t in SWEEP_TAGS)]

    # The shortest length from which the block beats the warp at every
    # longer length of the sweep, and the longest up to which the row block
    # does, at both tags.
    def block_from(rows):
        won = wins(SWEEP_BLOCK, rows, "block")
        return next((length for length in SWEEP_BLOCK
                     if all(m in won for m in SWEEP_BLOCK if m >= length)),
                    None)

    short_won = wins(SWEEP_SHORT, lambda length: SWEEP_SLOTS // length,
                     "row_block")
    log("sweep", block_beats_warp_from=block_from(
            lambda length: SWEEP_SLOTS // length),
        block_beats_warp_from_few_rows=block_from(lambda length: SWEEP_FEW),
        row_block_beats_warp_up_to=max(
            (length for length in SWEEP_SHORT
             if all(m in short_won for m in SWEEP_SHORT if m <= length)),
            default=None),
        slots=SWEEP_SLOTS, few_rows=SWEEP_FEW, tags=list(SWEEP_TAGS))
    return out


# --- the LM serving path (phases 11-14) -------------------------------------

# Phase 12: qwen3_4b at full width cut to two layers, at compute_dtype
# float32; prefill of PROMPT tokens for BATCH requests, then STEPS
# teacher-forced decode steps.  Phase 13: full width and depth, bf16.
LM_SEED = 0
LM_TWIN = dict(batch=2, prompt=128, steps=8, layers=2)
# Phase 12's variants, by LM_REF key: config fields over qwen3_4b at
# LM_TWIN's depth, compute dtype float32 unless named.  "tag2_bf16" is
# the served configuration (gse_serve tag 2 at bfloat16); "kv8" the dense
# weights over the 8-bit GSE-SEM KV cache.
LM_TWIN_VARIANTS = {"dense": {}, "tag1": dict(gse_serve=True, gse_tag=1),
                    "tag2": dict(gse_serve=True, gse_tag=2),
                    "tag2_bf16": dict(gse_serve=True, gse_tag=2,
                                      compute_dtype="bfloat16"),
                    "kv8": dict(kv_cache_gse=True)}
LM_FULL = dict(batch=4, prompt=512, steps=32)
# The card's logits against the CPU twin's and the reference's: absolute,
# on logits of magnitude up to about 5 (f32 sums in other orders).
LM_TOL = 1e-3
# At bfloat16, tests/test_torch_lm.py's tolerance: the reference rounds
# attention scores, probabilities and products to bf16 where the port's
# plain E and F keep f32, and F's tensor-core body rounds P to bf16.
BF16_TOL = dict(rtol=0.02, atol=0.075)
# A replayed bf16 route's largest gap (replay_routes: the router logits'
# difference between a token's own k-th pick and the least replayed one).
# The router logits are about N(0, 1); BF16_TOL's 2% on the MoE input
# moves one by ~0.02, so two that close can trade places.  A route that is
# wrong, not near a tie, lies ~1 below the k-th (the 8th of 128 at ~1.5
# against ~0 for a random expert).
ROUTE_GAP_TOL = 0.1
# The kv8 variants (f32, the 8-bit GSE-SEM KV cache): a cache entry keeps
# a 4-bit mantissa, so an f32 rounding difference in a key or value (the
# card's products against the CPU's or JAX's) can move it by a whole
# mantissa step, up to 1/8 of its value.  On an H100 (NVIDIA H100 80GB
# HBM3, 700 W) that moved qwen3_4b's logits by 0.0041 from the reference's
# digest and recurrentgemma's by 0.0062 from the CPU twin's, above LM_TOL;
# they are held as the bf16 variants are, at this tolerance.
KV8_TOL = dict(rtol=0.005, atol=0.02)
# Tolerances other than LM_TOL, by phase 12's and 26's variant names.
LOOSE_TOL = {("lm_twin", "tag2_bf16"): BF16_TOL, ("lm_twin", "kv8"): KV8_TOL,
             ("hybrid_twin", "tag2_bf16"): BF16_TOL,
             ("hybrid_twin", "kv8"): KV8_TOL,
             ("rwkv_twin", "tag2_bf16"): BF16_TOL,
             ("encdec_twin", "tag2_bf16"): BF16_TOL,
             ("vlm_twin", "tag2_bf16"): BF16_TOL}
# tools/reference/lm_serve_ref.py's output (JAX on the CPU): per variant,
# per step (prefill, then the decode steps), lm_digest's fields as
# (tokens, first 8 logits of request 0, max |logit|).
LM_REF = {
    "dense": [
        ([131283, 141201],
         [0.6140260100364685, 0.22942297160625458, -2.3157002925872803,
          -0.9319877624511719, -1.0760281085968018, 0.93455570936203,
          -0.09277591109275818, -0.232222318649292],
         4.509029388427734),
        ([38534, 90848],
         [-0.08564695715904236, 0.8748939633369446, 0.10210439562797546,
          -1.6415246725082397, -0.14159762859344482, 1.1604872941970825,
          0.713987410068512, 0.5854827165603638],
         4.827754497528076),
        ([112313, 97447],
         [-1.22428560256958, -0.5515567064285278, -1.8917090892791748,
          -0.5584970116615295, -0.8099294900894165, 1.017736792564392,
          -0.16913239657878876, -0.11812159419059753],
         4.4083662033081055),
        ([105671, 17205],
         [0.6857863664627075, 0.3848717212677002, -0.41713833808898926,
          0.03074115514755249, -0.7431170344352722, 1.3694920539855957,
          0.26461464166641235, 0.8312472105026245],
         4.90008544921875),
        ([130585, 80161],
         [-0.5687544941902161, 0.22065645456314087, -0.4186614155769348,
          0.06051984429359436, 0.05868735909461975, -0.699944257736206,
          -0.41816458106040955, 0.9992611408233643],
         5.005812168121338),
        ([150734, 60850],
         [-0.9694130420684814, 0.8833187222480774, -1.9348756074905396,
          -0.03756614774465561, 0.5601205825805664, -0.9123438596725464,
          1.153518557548523, 0.5283415913581848],
         5.042886734008789),
        ([131491, 60480],
         [-0.6420830488204956, 2.1190195083618164, -0.4501276910305023,
          0.9635499119758606, -0.4377095401287079, 0.46379509568214417,
          -0.1590016782283783, 1.3740025758743286],
         4.703145980834961),
        ([142955, 57384],
         [0.8058307766914368, 1.4751489162445068, -1.4047346115112305,
          -0.45781105756759644, -0.2010802924633026, 0.4220302104949951,
          -1.6885300874710083, 1.3970508575439453],
         4.629271507263184),
        ([34818, 11343],
         [0.6556758880615234, 1.044532060623169, -0.34388983249664307,
          -0.3113384246826172, -0.32961732149124146, 0.6975972652435303,
          0.694355309009552, 0.5642027854919434],
         4.999590873718262),
    ],
    "tag1": [
        ([131283, 141201],
         [0.6143577098846436, 0.22883537411689758, -2.316152334213257,
          -0.9329602718353271, -1.0758167505264282, 0.9341071248054504,
          -0.09270264208316803, -0.23233360052108765],
         4.507787704467773),
        ([38534, 90848],
         [-0.08601987361907959, 0.8748853206634521, 0.10173803567886353,
          -1.6412736177444458, -0.14149349927902222, 1.1593375205993652,
          0.7142355442047119, 0.5841876268386841],
         4.827369689941406),
        ([112313, 97447],
         [-1.2236084938049316, -0.5515425801277161, -1.8913944959640503,
          -0.5590773820877075, -0.8097529411315918, 1.0173861980438232,
          -0.16947093605995178, -0.11890685558319092],
         4.407251358032227),
        ([105671, 17205],
         [0.6860323548316956, 0.3847983479499817, -0.4172457456588745,
          0.030397474765777588, -0.7426289319992065, 1.3691399097442627,
          0.26547563076019287, 0.831211268901825],
         4.900050163269043),
        ([130585, 80161],
         [-0.5692732334136963, 0.21971173584461212, -0.4187389314174652,
          0.06069791316986084, 0.059089481830596924, -0.7001190185546875,
          -0.41760215163230896, 0.9995684027671814],
         5.005374431610107),
        ([150734, 60850],
         [-0.9695440530776978, 0.8830251693725586, -1.934117317199707,
          -0.03864137828350067, 0.5600253343582153, -0.9119307398796082,
          1.1532292366027832, 0.5274478793144226],
         5.04196834564209),
        ([131491, 60480],
         [-0.6422663927078247, 2.1186609268188477, -0.4502415060997009,
          0.9630018472671509, -0.43763768672943115, 0.46393585205078125,
          -0.15938395261764526, 1.3737517595291138],
         4.7019243240356445),
        ([142955, 57384],
         [0.8060187101364136, 1.4744882583618164, -1.4047126770019531,
          -0.45735645294189453, -0.20135177671909332, 0.42192697525024414,
          -1.6888437271118164, 1.3966671228408813],
         4.629016399383545),
        ([34818, 11343],
         [0.6552245616912842, 1.0442328453063965, -0.3439328074455261,
          -0.3115255832672119, -0.329776406288147, 0.697758674621582,
          0.6947284936904907, 0.5638863444328308],
         4.999532699584961),
    ],
    "tag2": [
        ([131283, 141201],
         [0.614025354385376, 0.22942236065864563, -2.315701961517334,
          -0.9319871664047241, -1.0760276317596436, 0.9345557689666748,
          -0.0927756130695343, -0.23222249746322632],
         4.509028911590576),
        ([38534, 90848],
         [-0.08564843237400055, 0.8748936653137207, 0.10210517048835754,
          -1.6415247917175293, -0.14159667491912842, 1.1604876518249512,
          0.7139875292778015, 0.5854817628860474],
         4.827755451202393),
        ([112313, 97447],
         [-1.2242846488952637, -0.5515553951263428, -1.8917081356048584,
          -0.5584968328475952, -0.8099294900894165, 1.0177364349365234,
          -0.16913267970085144, -0.1181207001209259],
         4.408365726470947),
        ([105671, 17205],
         [0.6857865452766418, 0.3848722279071808, -0.41713887453079224,
          0.030739784240722656, -0.7431177496910095, 1.3694911003112793,
          0.26461517810821533, 0.8312473297119141],
         4.900084495544434),
        ([130585, 80161],
         [-0.5687536001205444, 0.22065770626068115, -0.4186602234840393,
          0.060520708560943604, 0.05868843197822571, -0.6999448537826538,
          -0.4181642532348633, 0.9992604851722717],
         5.005814075469971),
        ([150734, 60850],
         [-0.9694140553474426, 0.8833186626434326, -1.934876799583435,
          -0.037567101418972015, 0.5601211190223694, -0.9123449325561523,
          1.1535193920135498, 0.5283421277999878],
         5.0428876876831055),
        ([131491, 60480],
         [-0.6420822143554688, 2.1190197467803955, -0.4501281976699829,
          0.9635509252548218, -0.43770989775657654, 0.4637937545776367,
          -0.15900227427482605, 1.374003529548645],
         4.703146457672119),
        ([142955, 57384],
         [0.8058305978775024, 1.475149154663086, -1.4047343730926514,
          -0.45781058073043823, -0.20108112692832947, 0.4220305383205414,
          -1.6885302066802979, 1.3970509767532349],
         4.629270553588867),
        ([34818, 11343],
         [0.6556769609451294, 1.0445311069488525, -0.34388983249664307,
          -0.31133726239204407, -0.3296181857585907, 0.697598397731781,
          0.6943557858467102, 0.5642030835151672],
         4.9995927810668945),
    ],
    "tag2_bf16": [
        ([131283, 141201],
         [0.6045197248458862, 0.24348855018615723, -2.325235605239868,
          -0.9490013122558594, -1.0704585313796997, 0.9315356016159058,
          -0.10582494735717773, -0.24826344847679138],
         4.532994270324707),
        ([38534, 90848],
         [-0.07547645270824432, 0.8691698908805847, 0.1296466886997223,
          -1.6543623208999634, -0.1497960090637207, 1.1529688835144043,
          0.7120586633682251, 0.5531372427940369],
         4.8315019607543945),
        ([112313, 97447],
         [-1.2029629945755005, -0.5452677607536316, -1.8975260257720947,
          -0.5690811276435852, -0.8306881189346313, 1.0150188207626343,
          -0.1643010675907135, -0.129415363073349],
         4.415778636932373),
        ([105671, 17205],
         [0.7041227221488953, 0.3962932229042053, -0.4302141070365906,
          0.025162875652313232, -0.7271292209625244, 1.3788906335830688,
          0.24877476692199707, 0.8546591997146606],
         4.914181709289551),
        ([130585, 80161],
         [-0.5736770629882812, 0.20117264986038208, -0.4072100818157196,
          0.05270028114318848, 0.06593945622444153, -0.7068548202514648,
          -0.4275321066379547, 0.9752110242843628],
         5.005084991455078),
        ([150734, 60850],
         [-0.947987973690033, 0.8781462907791138, -1.9366750717163086,
          -0.040864743292331696, 0.575913667678833, -0.8875852227210999,
          1.1435716152191162, 0.5210291743278503],
         5.06195592880249),
        ([131491, 60480],
         [-0.6275439262390137, 2.109684944152832, -0.44175422191619873,
          0.9869725704193115, -0.444014310836792, 0.4699774384498596,
          -0.15670859813690186, 1.3535219430923462],
         4.703441619873047),
        ([142955, 57384],
         [0.8119810819625854, 1.4757047891616821, -1.4065662622451782,
          -0.4451258182525635, -0.20686206221580505, 0.41859951615333557,
          -1.684121012687683, 1.3715152740478516],
         4.6296586990356445),
        ([70585, 11343],
         [0.6440043449401855, 1.0496108531951904, -0.36887866258621216,
          -0.35138314962387085, -0.3370366096496582, 0.6808407306671143,
          0.6986963152885437, 0.5779379606246948],
         4.994083404541016),
    ],
    "kv8": [
        ([131283, 141201],
         [0.6140260100364685, 0.22942297160625458, -2.3157002925872803,
          -0.9319877624511719, -1.0760281085968018, 0.93455570936203,
          -0.09277591109275818, -0.232222318649292],
         4.509029388427734),
        ([38534, 90848],
         [-0.2122415453195572, 0.8509112596511841, 0.12200069427490234,
          -1.6691354513168335, -0.16184401512145996, 1.1369267702102661,
          0.7151197791099548, 0.6021438837051392],
         4.824121475219727),
        ([112313, 97447],
         [-1.3347197771072388, -0.6035127639770508, -1.7260137796401978,
          -0.4811024069786072, -0.7960872650146484, 1.034529685974121,
          -0.24501635134220123, -0.16367104649543762],
         4.482665061950684),
        ([122560, 17205],
         [0.573375940322876, 0.31217846274375916, -0.25372299551963806,
          -0.09741932153701782, -0.7349177598953247, 1.3514982461929321,
          0.15269339084625244, 0.7527110576629639],
         5.055996894836426),
        ([139821, 80161],
         [-0.4798729717731476, 0.27105003595352173, -0.5582877397537231,
          -0.024600982666015625, 0.19045031070709229, -0.6964404582977295,
          -0.37610745429992676, 1.0887806415557861],
         5.102341651916504),
        ([150734, 60850],
         [-1.1155204772949219, 0.9126986861228943, -1.9730710983276367,
          -0.03965779393911362, 0.4756559133529663, -0.9741854667663574,
          0.9391064643859863, 0.39454901218414307],
         4.980589866638184),
        ([131491, 60480],
         [-0.5294634103775024, 2.1860694885253906, -0.38268980383872986,
          0.9667523503303528, -0.4262916147708893, 0.3711782693862915,
          -0.190675288438797, 1.3465888500213623],
         4.741854190826416),
        ([142955, 57384],
         [0.8574271202087402, 1.4903662204742432, -1.3105698823928833,
          -0.3717997670173645, -0.0963992178440094, 0.5019903182983398,
          -1.5088834762573242, 1.4670814275741577],
         4.67064094543457),
        ([34818, 11343],
         [0.6046876311302185, 1.0797302722930908, -0.29578083753585815,
          -0.20328016579151154, -0.35630521178245544, 0.7489110231399536,
          0.7361289262771606, 0.6044806838035583],
         4.977365493774414),
    ],
}
LM_LINEAR = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


_LM_TREES = {}


def lm_tree_np(cfg, seed: int) -> dict:
    """Params of a dense ``cfg`` in the reference's tree layout (stacked
    ``(L, ...)`` layer leaves) as numpy f32, drawn from
    ``default_rng(seed)`` in a fixed order: normal weights scaled by
    1/sqrt(fan-in), as the reference's init scales them, and unit norms.
    ``tools/reference/lm_serve_ref.py`` builds the reference's params from
    this same function.  The last two trees drawn are kept (phases 12
    and 35 draw the same one, phase 32 another between them; callers copy
    the arrays, as ``convert`` does)."""
    key = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.hd, cfg.d_ff, cfg.padded_vocab, cfg.qk_norm, seed)
    tree = _LM_TREES.get(key)
    if tree is None:
        tree = _lm_tree_draw(cfg, seed)
        while len(_LM_TREES) >= 2:
            _LM_TREES.pop(next(iter(_LM_TREES)))
        _LM_TREES[key] = tree
    return tree


def _lm_tree_draw(cfg, seed: int) -> dict:
    import math

    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(1.0 / math.sqrt(fan_in))
        return a

    n, d, h, kv = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, ff, vp = cfg.hd, cfg.d_ff, cfg.padded_vocab
    embed = {"table": normal((vp, d), d)}
    unembed = {"w": normal((d, vp), d)}
    attn = {"wq": normal((n, d, h * hd), d),
            "wk": normal((n, d, kv * hd), d),
            "wv": normal((n, d, kv * hd), d),
            "wo": normal((n, h * hd, d), h * hd)}
    if cfg.qk_norm:  # no draws: the other leaves are the same either way
        attn["q_norm"] = np.ones((n, hd), np.float32)
        attn["k_norm"] = np.ones((n, hd), np.float32)
    return {
        "embed": embed,
        "final_norm": {"scale": np.ones(d, np.float32)},
        "unembed": unembed,
        "layers": {
            "norm1": {"scale": np.ones((n, d), np.float32)},
            "attn": attn,
            "norm2": {"scale": np.ones((n, d), np.float32)},
            "mlp": {"w_gate": normal((n, d, ff), d),
                    "w_up": normal((n, d, ff), d),
                    "w_down": normal((n, ff, d), ff)},
        },
    }


def device_ms(fn, names) -> dict:
    """Run ``fn`` once under ``torch.profiler``: the device's busy ms
    ("busy") and the device ms of the kernels whose names contain each of
    ``names``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, getattr(e, "self_device_time_total", 0.0))
               for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    out = {"busy": sum(us for _, us in kernels) / 1e3}
    for name in names:
        out[name] = sum(us for key, us in kernels if name in key) / 1e3
    return out


def lm_tokens(cfg, seed: int, batch: int, length: int):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, length), dtype=np.int32)


def lm_digest(logits) -> list:
    """Per step (prefill, then each decode step): the greedy tokens, the
    first 8 logits of request 0 and the largest |logit|."""
    return [{"tokens": [int(t) for t in step.argmax(-1).tolist()],
             "first": [float(v) for v in step[0, :8].tolist()],
             "maxabs": float(abs(step).max())} for step in logits]


def lm_gse_params(params, cfg):
    """``params`` with every linear weight packed into ``gse_serve``
    segments on its device, one table per layer (``init_params``'s
    layout; a moe layer's expert stacks stay dense); the other leaves are
    shared."""
    import torch

    from repro_torch.models.modules import pack_linear_weight
    from repro_torch.tree import tree_map

    out = tree_map(lambda t: t, params)
    out["unembed"]["w"] = pack_linear_weight(params["unembed"]["w"], cfg)
    for group, name in LM_LINEAR:
        if group not in params["layers"]:  # a moe layer has no MLP
            continue
        w = params["layers"][group][name]
        per = [pack_linear_weight(w[i], cfg) for i in range(w.shape[0])]
        out["layers"][group][name] = {f: torch.stack([q[f] for q in per])
                                      for f in per[0]}
    return out


def lm_run(cfg, params, tokens, device, prompt: int, steps: int):
    """``make_prefill_step`` over the first ``prompt`` tokens (filling the
    decode state), then ``steps`` teacher-forced ``decode_step``s; returns
    the ``(steps + 1, B, V)`` logits on the host and the seconds taken."""
    import torch

    from repro_torch.models import stepfns, transformer as T

    toks = torch.from_numpy(tokens).to(device)
    t0 = time.perf_counter()
    state = T.decode_state_init(cfg, toks.shape[0], prompt + steps,
                                device=device)
    logits = [stepfns.make_prefill_step(cfg)(params, toks[:, :prompt],
                                             state=state)]
    for i in range(steps):
        lg, state = T.decode_step(cfg, params, state, toks[:, prompt + i],
                                  prompt + i)
        logits.append(lg)
    out = torch.stack(logits).float().cpu()
    return out, time.perf_counter() - t0


def pack_view(p, shape, offset: int = 0):
    """The segments of ``p``'s values ``offset .. offset + K * N`` as a
    ``(K, N)`` pack: any run of a pack is a pack under its table."""
    kk, n = shape

    def cut(t):
        return t.reshape(-1)[offset:offset + kk * n].view(kk, n)

    return dataclasses.replace(p, head=cut(p.head), tail1=cut(p.tail1),
                               tail2=cut(p.tail2))


# Phase 11's F cases: (label, B, S = T, H, KV, hd, causal, dtype name, tol).
LM_FLASH = (("phase11", 4, 2048, 32, 8, 128, True, "float32", 2e-5),
            ("phase11", 4, 2048, 32, 8, 128, True, "bfloat16", 2e-2),
            ("phase13", 4, 512, 32, 8, 128, True, "bfloat16", 2e-2),
            ("ragged", 2, 1000, 32, 8, 128, True, "bfloat16", 2e-2),
            ("ragged", 2, 1000, 32, 8, 128, False, "bfloat16", 2e-2),
            ("ragged", 2, 1000, 32, 8, 64, True, "bfloat16", 2e-2),
            ("ragged", 2, 1000, 32, 8, 64, False, "bfloat16", 2e-2),
            ("ragged", 2, 1000, 32, 8, 16, True, "float32", 2e-5),
            ("ragged", 2, 1000, 32, 8, 72, False, "float32", 2e-5),
            ("ragged", 2, 1000, 32, 8, 72, True, "bfloat16", 2e-2))


def phase_lm_kernels():
    """Phase 11: kernels D, E and F against their plain versions at
    qwen3_4b's full-width shapes; returns their inputs for phase 10."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import gse
    from repro_torch.core.precision_table import TAG_BITS_USED
    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_decode as D
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.kernels import ref
    from repro_torch.models.modules import pack_linear_weight, segment_read

    dev = torch.device("cuda")
    cfg = get_config("qwen3_4b")
    d, ff, h, kv, hd = cfg.d_model, cfg.d_ff, cfg.num_heads, \
        cfg.num_kv_heads, cfg.hd
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    packs = {"wq": gse.pack(rng.standard_normal((d, h * hd)) / math.sqrt(d),
                            8, device=dev),
             "w_down": gse.pack(rng.standard_normal((ff, d)) / math.sqrt(ff),
                                8, device=dev)}
    log("lm_kernels", host_pack_s=f"{time.perf_counter() - t0:.2f}",
        shapes={k: list(p.head.shape) for k, p in packs.items()})
    # Every (K, N) of a decode step and of prefill: wq's pack, and runs of
    # w_down's for the others; "ragged" and "ragged_tiled" start 6 bytes
    # in and have N % 8 != 0 (and K % 8 != 0), so E's GEMV and tiled
    # bodies take their scalar loads there.
    parent = {"wq": "wq", "wk/wv": "w_down", "wo": "w_down",
              "w_gate/w_up": "w_down", "w_down": "w_down",
              "ragged": "w_down", "ragged_tiled": "w_down"}
    mats = {"wq": packs["wq"],
            "wk/wv": pack_view(packs["w_down"], (d, kv * hd)),
            "wo": pack_view(packs["w_down"], (h * hd, d)),
            "w_gate/w_up": pack_view(packs["w_down"], (d, ff)),
            "w_down": packs["w_down"],
            "ragged": pack_view(packs["w_down"], (300, 1001), offset=3),
            "ragged_tiled": pack_view(packs["w_down"], (1001, 999),
                                      offset=3)}
    # Rows of x per shape: the decode steps' M (the GEMV) and prefill's
    # B * S = 2048 (the tiled body); M 300 on the ragged tiled shape.
    rows = {name: (1, 4, 8, LM_FULL["batch"] * LM_FULL["prompt"])
            for name in mats}
    rows["ragged"] = (1, 4, 8)
    rows["ragged_tiled"] = (300,)
    ctx = {"packs": packs, "mats": mats, "parent": parent, "x": {},
           "scales": {}, "err": {}, "dec": {}}
    for name, p in packs.items():
        for t in TAGS:
            sc = ctx["scales"][name, t] = ref.make_scales(
                p.table, TAG_BITS_USED[t] - p.ei_bit)
            segs = (p.head, p.tail1 if t >= 2 else None,
                    p.tail2 if t == 3 else None, sc)
            for out in (torch.float32, torch.bfloat16):
                got = D.gse_decode_dense(*segs, ei_bit=p.ei_bit, tag=t,
                                         out_dtype=out)
                want = D.gse_decode_dense_plain(*segs, ei_bit=p.ei_bit,
                                                tag=t, out_dtype=out)
                require_bitwise(f"D {name} tag {t} {out}", got, want)
            ctx["err"]["D", name, t] = float((got.float() - want.float())
                                             .abs().max())
    for name, p in mats.items():
        kk, n = p.head.shape
        ms = rows[name]
        for m in ms:
            ctx["x"][name, m] = torch.from_numpy(rng.standard_normal(
                (m, kk)).astype(np.float32)).to(dev)
        for t in TAGS:
            sc = ctx["scales"][parent[name], t]
            segs = (p.head, p.tail1 if t >= 2 else None,
                    p.tail2 if t == 3 else None, sc)
            if not name.startswith("ragged"):  # phase 10's yardstick
                ctx["dec"][name, t] = D.gse_decode_dense_plain(
                    *segs, ei_bit=p.ei_bit, tag=t)
            errs, used = {}, {}
            # x in f32 and in bf16: the model's compute dtype is bf16, so
            # its linears launch E's bf16-x instantiations.  M <= 8 runs
            # the split-K GEMV, M 2048 and 300 the tiled body; each twice:
            # the same bits.
            for m in ms:
                for xd in (torch.float32, torch.bfloat16):
                    x = ctx["x"][name, m].to(xd)
                    got = E.gse_matmul_dense(x, *segs, ei_bit=p.ei_bit,
                                             tag=t)
                    require_bitwise(f"E {name} M {m} tag {t} {xd}, two "
                                    "calls", E.gse_matmul_dense(
                                        x, *segs, ei_bit=p.ei_bit, tag=t),
                                    got)
                    want = E.gse_matmul_dense_plain(x, *segs,
                                                    ei_bit=p.ei_bit, tag=t)
                    torch.testing.assert_close(got, want, rtol=1e-5,
                                               atol=1e-4)
                    diff = (got - want).abs()
                    errs[m, xd] = ctx["err"]["E", name, m, t, xd] = float(
                        diff.max())
                    used[m, xd] = float((diff / (1e-4 + 1e-5 * want.abs()))
                                        .max())
            log("lm_kernels", weight=name, shape=[kk, n], tag=t,
                d_bitwise="f32 and bf16" if name in packs else None,
                e_gemv_plan_m4=(dataclasses.astuple(E.gemv_plan(4, kk, n))
                                if 4 in ms else None),
                e_max_abs_err={f"M={m} x {str(xd).split('.')[-1]}": e
                               for (m, xd), e in errs.items()},
                e_tol_used={f"M={m} x {str(xd).split('.')[-1]}": round(u, 4)
                            for (m, xd), u in used.items()},
                e_two_calls_bitwise=True, e_tol="rtol 1e-5 atol 1e-4")
    # The unembedding's f32-source segments at bias 127, packed on the card.
    gen = torch.Generator(device=dev).manual_seed(11)
    vals = torch.randn((d, cfg.padded_vocab), generator=gen, device=dev)
    vals /= math.sqrt(d)
    ctx["unembed_x"] = {m: torch.randn((m, d), generator=gen, device=dev)
                        for m in (1, 4, 8)}
    for t in (1, 2):
        cfg_t = dataclasses.replace(cfg, gse_serve=True, gse_tag=t)
        w = pack_linear_weight(vals, cfg_t)
        tag, ei, sc = segment_read(w, cfg_t)
        segs = (w["head"], w["tail1"] if tag >= 2 else None, None, sc)
        errs = {}
        for m, x in ctx["unembed_x"].items():
            for xd in (torch.float32, torch.bfloat16):
                got = E.gse_matmul_dense(x.to(xd), *segs, ei_bit=ei, tag=tag)
                require_bitwise(f"E unembed M {m} tag {t} {xd}, two calls",
                                E.gse_matmul_dense(x.to(xd), *segs,
                                                   ei_bit=ei, tag=tag), got)
                want = E.gse_matmul_dense_plain(x.to(xd), *segs, ei_bit=ei,
                                                tag=tag)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
                errs[f"M={m} x {str(xd).split('.')[-1]}"] = ctx["err"][
                    "E", "unembed", m, t, xd] = float((got - want).abs()
                                                      .max())
        ctx["unembed", t] = (segs, ei, D.gse_decode_dense_plain(
            *segs, ei_bit=ei, tag=tag))
        log("lm_kernels", weight="unembed (pack32, bias 127)",
            shape=list(w["head"].shape), tag=t, e_max_abs_err=errs,
            e_two_calls_bitwise=True, e_tol="rtol 1e-5 atol 1e-4")
    del vals
    for label, b, s, h_, kv_, hd_, causal, dt, tol in LM_FLASH:
        dt = getattr(torch, dt)
        q = torch.randn((b, s, h_, hd_), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kv_, hd_), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kv_, hd_), generator=gen, device=dev).to(dt)
        got = F.flash_attention_gqa(q, k, v, causal=causal)
        want = F.flash_attention_gqa_plain(q, k, v, causal=causal)
        diff = (got.float() - want.float()).abs()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        # The share of the tolerance used: |got - want| / (tol + tol |want|).
        used = float((diff / (tol + tol * want.float().abs())).max())
        err = ctx["err"]["F", label, dt] = float(diff.max())
        if label != "ragged":
            ctx["qkv", label, dt] = (q, k, v)
        log("lm_kernels", kernel="flash_attention_gqa", case=label,
            body=F.flash_body(dt, hd_), b=b, heads=h_, kv_heads=kv_, s=s,
            t=s, hd=hd_, causal=causal, dtype=str(dt), max_abs_err=err,
            tol=f"rtol {tol} atol {tol}", tol_used=f"{used:.3f}")
    return ctx


def lm_twin_config():
    """Phase 12's qwen3_4b: full width, LM_TWIN's depth, float32."""
    import torch

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen3_4b"),
                               num_layers=LM_TWIN["layers"],
                               compute_dtype=torch.float32)


def lm_variant(cfg0, kw):
    """``cfg0`` with one of LM_TWIN_VARIANTS' fields."""
    import torch

    kw = dict(kw, compute_dtype=getattr(
        torch, kw.get("compute_dtype", "float32")))
    return dataclasses.replace(cfg0, **kw)


def tree_digest(tree, memo=None) -> list:
    """Per leaf: its dtype, shape and the sum of its words (as signed
    integers of the leaf's width) weighted by position, wrapped to 64
    bits -- the same on any device for the same bits.  ``memo`` spares
    leaves that several trees share (it holds them, so no id is reused)."""
    import torch

    from repro_torch.tree import tree_leaves

    words_of = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}
    memo = {} if memo is None else memo
    out = []
    for leaf in tree_leaves(tree):
        if id(leaf) not in memo:
            words = leaf.contiguous().view(-1).view(
                words_of[leaf.element_size()])
            h = torch.zeros((), dtype=torch.int64, device=leaf.device)
            for s in range(0, words.numel(), 1 << 24):
                w = words[s:s + (1 << 24)].to(torch.int64)
                pos = torch.arange(s, s + w.numel(), dtype=torch.int64,
                                   device=w.device)
                h += (w * (pos * 2654435761 + 1)).sum()
            memo[id(leaf)] = (leaf, (str(leaf.dtype), tuple(leaf.shape),
                                     int(h)))
        out.append(memo[id(leaf)][1])
    return out


def lm_twin_cpu():
    """Phase 12's CPU twin, from the same numpy params as the card's run:
    per variant the logits, the seconds and the digest of the params it
    ran (the linears packed on the CPU)."""
    from repro_torch import convert

    tw = LM_TWIN
    cfg0 = lm_twin_config()
    dense = convert.params_from_repro(lm_tree_np(cfg0, LM_SEED), device="cpu")
    toks = lm_tokens(cfg0, LM_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    out, packed, memo = {}, {}, {}
    for name, kw in LM_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pc = dense
        if cfg.gse_serve:
            # pack_linear_weight's segments depend only on k and on
            # whether the tag keeps a third segment.
            key = (cfg.gse_k, cfg.gse_tag >= 3)
            if key not in packed:
                packed = {key: lm_gse_params(dense, cfg)}
            pc = packed[key]
        lc, sc = lm_run(cfg, pc, toks, "cpu", tw["prompt"], tw["steps"])
        out[name] = (lc, sc, tree_digest(pc, memo))
    return out


def phase_lm_twin(twins=None):
    """Phase 12: qwen3_4b at full width, two layers, on the card and as its
    CPU twin (from ``twins``) from the same numpy params, against each
    other and against the reference's digest (LM_REF): dense and
    gse_serve tags 1-2 at compute_dtype float32, and the served
    configuration, gse_serve tag 2 at bfloat16.  The params each variant
    ran must be the CPU twin's bit for bit (tree_digest).  Returns the
    launches per kernel body, summed over the f32 variants and (key
    "bf16") of the bf16 one."""
    import torch

    from repro_torch import convert
    from repro_torch.tree import tree_map

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E

    dev = torch.device("cuda")
    tw = LM_TWIN
    cfg0 = lm_twin_config()
    t0 = time.perf_counter()
    dense_gpu = tree_map(lambda t: t.to(dev), convert.params_from_repro(
        lm_tree_np(cfg0, LM_SEED), device="cpu"))
    toks = lm_tokens(cfg0, LM_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    log("lm_twin", layers=tw["layers"], d_model=cfg0.d_model,
        vocab=cfg0.vocab_size, batch=tw["batch"], prompt=tw["prompt"],
        steps=tw["steps"], params_s=f"{time.perf_counter() - t0:.2f}")
    card = {}
    for name, kw in LM_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pg = lm_gse_params(dense_gpu, cfg) if cfg.gse_serve else dense_gpu
        torch.cuda.synchronize()
        for mod in (E, F):
            mod.reset_launch_counts()
        lg, sg = lm_run(cfg, pg, toks, dev, tw["prompt"], tw["steps"])
        got = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
               .items()}
        got.update({"f_" + k: v for k, v in
                    F.flash_attention_gqa.body_launches.items()})
        card[name] = (lg, sg, got, tree_digest(pg))
        del pg
    del dense_gpu
    cpu = twin_of(twins, "lm")
    counts = {}
    for name, kw in LM_TWIN_VARIANTS.items():
        bf16 = lm_variant(cfg0, kw).compute_dtype == torch.bfloat16
        got = card[name][2]
        check_twin("lm_twin", name, card[name], cpu[name], LM_REF[name])
        if bf16:
            counts["bf16"] = got
            continue
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    # The card's launches (the CPU twin launches none): at f32, E at M = 2
    # and 256 and F on its FFMA body; at bf16, E's tiled body on a bf16 x
    # and F's tensor-core body.
    log("lm_twin", launches_f32=json.dumps({k: v for k, v in counts.items()
                                            if k != "bf16"}),
        launches_bf16=json.dumps(counts["bf16"]))
    if min(counts["e_gemv"], counts["e_tiled"], counts["f_ffma"]) <= 0:
        raise AssertionError(f"a kernel body of the f32 twin never "
                             f"launched: {counts}")
    if min(counts["bf16"][k] for k in ("e_gemv", "e_tiled", "f_mma")) <= 0:
        raise AssertionError(f"a kernel body of the bf16 twin never "
                             f"launched: {counts['bf16']}")
    return counts


def check_twin(phase, name, card, cpu, ref_rows):
    """One variant of an LM twin phase (12, 26): ``card`` = (logits,
    seconds, launches, params digest) of the card's run, ``cpu`` =
    (logits, seconds, params digest) of the CPU twin's, ``ref_rows`` the
    reference's digest rows (tokens, first 8 logits, max |logit|).  The
    params must be the CPU twin's bit for bit and the logits finite; the
    logits within LM_TOL of the twin's and of the reference's and the
    greedy tokens equal, or, for the variants LOOSE_TOL names,
    check_twin_loose at that tolerance."""
    import torch

    lg, sg, got, digest = card
    lc, sc, cpu_digest = cpu
    if digest != cpu_digest:
        raise AssertionError(f"{phase} {name}: the card's params are not the "
                             "CPU twin's bit for bit")
    dg = lm_digest(lg)
    ref = [dict(tokens=a, first=b, maxabs=c) for a, b, c in ref_rows]
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{phase} {name}: non-finite logits")
    loose = LOOSE_TOL.get((phase, name))
    if loose is not None:
        check_twin_loose(name, lg, lc, dg, ref, sg, sc, got, phase, loose)
        return
    twin_err = float((lg - lc).abs().max())
    ref_err = max(max(abs(a - b) for a, b in zip(x["first"], y["first"]))
                  for x, y in zip(dg, ref))
    ref_err = max(ref_err, max(abs(x["maxabs"] - y["maxabs"])
                               for x, y in zip(dg, ref)))
    tokens = [x["tokens"] for x in dg]
    log(phase, variant=name, gpu_s=f"{sg:.2f}", cpu_s=f"{sc:.2f}",
        twin_max_abs_err=twin_err, ref_max_abs_err=ref_err,
        tol=LM_TOL, logits_maxabs=dg[0]["maxabs"],
        tokens=json.dumps(tokens), launches=json.dumps(got),
        params_bitwise_cpu=True)
    if twin_err > LM_TOL or not torch.equal(lg.argmax(-1), lc.argmax(-1)):
        raise AssertionError(f"{phase} {name}: card and CPU twin differ by "
                             f"{twin_err} (tol {LM_TOL}) or in tokens")
    if ref_err > LM_TOL or tokens != [y["tokens"] for y in ref]:
        raise AssertionError(f"{phase} {name}: card differs from the "
                             f"reference by {ref_err} (tol {LM_TOL}) or in "
                             "tokens")


def check_twin_loose(name, lg, lc, dg, ref, sg, sc, launches,
                       phase="lm_twin", tol=BF16_TOL):
    """A twin phase's bf16 (or kv8) variant: the card's logits ``lg``
    within ``tol`` of the CPU twin's ``lc`` and of the reference's digest
    ``ref``, and the greedy tokens equal to both wherever the CPU twin's
    top-2 margin exceeds twice the atol (below it, the roundings may flip
    a token)."""
    import torch

    rtol, atol = tol["rtol"], tol["atol"]
    excess = ((lg - lc).abs() - (atol + rtol * lc.abs())).max()
    twin_err = float((lg - lc).abs().max())
    ref_excess, ref_err = -float("inf"), 0.0
    for x, y in zip(dg, ref):
        for a, b in list(zip(x["first"], y["first"])) + [(x["maxabs"],
                                                          y["maxabs"])]:
            ref_err = max(ref_err, abs(a - b))
            ref_excess = max(ref_excess, abs(a - b) - (atol + rtol * abs(b)))
    top2 = lc.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * atol
    tok_g, tok_c = lg.argmax(-1), lc.argmax(-1)
    tok_r = torch.tensor([y["tokens"] for y in ref])
    close = ~sure
    log(phase, variant=name, gpu_s=f"{sg:.2f}", cpu_s=f"{sc:.2f}",
        twin_max_abs_err=twin_err, ref_max_abs_err=ref_err,
        tol=f"rtol {rtol} atol {atol}",
        within_tol_twin=bool(excess <= 0), within_tol_ref=ref_excess <= 0,
        positions=int(sure.numel()),
        below_margin=int(close.sum()),
        below_margin_differ_cpu=int((close & (tok_g != tok_c)).sum()),
        below_margin_differ_ref=int((close & (tok_g != tok_r)).sum()),
        tokens_equal_cpu=bool(torch.equal(tok_g, tok_c)),
        tokens_equal_ref=bool(torch.equal(tok_g, tok_r)),
        tokens=json.dumps([x["tokens"] for x in dg]),
        launches=json.dumps(launches))
    if excess > 0:
        raise AssertionError(f"{phase} {name}: card and CPU twin differ by "
                             f"{twin_err}, beyond {tol}")
    if ref_excess > 0:
        raise AssertionError(f"{phase} {name}: card differs from the "
                             f"reference's digest by {ref_err}, beyond "
                             f"{tol}")
    if bool((sure & ((tok_g != tok_c) | (tok_g != tok_r))).any()):
        raise AssertionError(f"{phase} {name}: a greedy token differs where "
                             f"the CPU twin's margin exceeds {2 * atol}")


def phase_lm_full():
    """Phase 13: qwen3_4b at full width and depth under gse_serve tag 2,
    weights packed on the card; prefill then greedy decoding, counted."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_decode as D
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.models import stepfns, transformer as T
    from repro_torch.quant import gse_tensor as Q

    dev = torch.device("cuda")
    fu = LM_FULL
    cfg = dataclasses.replace(get_config("qwen3_4b"), gse_serve=True,
                              gse_tag=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = Q.tree_bytes(params, cfg.gse_tag)
    toks = torch.from_numpy(lm_tokens(cfg, LM_SEED + 2, fu["batch"],
                                      fu["prompt"])).to(dev)
    state = T.decode_state_init(cfg, fu["batch"], fu["prompt"] + fu["steps"],
                                device=dev)
    torch.cuda.synchronize()
    for mod in (D, E, F):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    logits = stepfns.make_prefill_step(cfg)(params, toks, state=state)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(fu["steps"]):
        logits, state = T.decode_step(cfg, params, state, tok,
                                      fu["prompt"] + i)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = {"gse_matmul_dense": E.gse_matmul_dense.launches,
              "flash_attention_gqa": F.flash_attention_gqa.launches}
    counts.update({"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
                   .items()})
    counts.update({"f_" + k: v for k, v in
                   F.flash_attention_gqa.body_launches.items()})
    step_ms = decode_s * 1e3 / fu["steps"]
    tokens = torch.stack(out, 1).tolist()
    # One more prefill (uncounted, untimed) under the profiler: the device
    # ms of E's tiled body and the device's busy ms.
    state = T.decode_state_init(cfg, fu["batch"], fu["prompt"] + fu["steps"],
                                device=dev)
    dev_ms = device_ms(lambda: stepfns.make_prefill_step(cfg)(
        params, toks, state=state), ("matmul_tc_kernel",))
    log("lm_full", layers=cfg.num_layers, gse_tag=cfg.gse_tag,
        batch=fu["batch"], prompt=fu["prompt"], steps=fu["steps"],
        init_s=f"{init_s:.2f}", prefill_s=f"{prefill_s:.3f}",
        prefill_tok_per_s=f"{fu['batch'] * fu['prompt'] / prefill_s:.0f}",
        prefill_busy_ms=f"{dev_ms['busy']:.1f}",
        prefill_e_tiled_ms=f"{dev_ms['matmul_tc_kernel']:.1f}",
        ms_per_decode_step=f"{step_ms:.3f}", tree_bytes=nbytes,
        tree_gb_per_s=f"{nbytes / (step_ms * 1e6):.1f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        e_launches=counts["gse_matmul_dense"], e_gemv=counts["e_gemv"],
        e_tiled=counts["e_tiled"], f_launches=counts["flash_attention_gqa"],
        f_mma=counts["f_mma"], d_launches=D.gse_decode_dense.launches)
    log("lm_full", tokens=json.dumps(tokens))
    if not bool(finite):
        raise AssertionError("full-depth serve: non-finite logits")
    if min(counts[k] for k in ("e_gemv", "e_tiled", "f_mma")) <= 0:
        raise AssertionError(f"a kernel of the serving path never launched: "
                             f"{counts}")
    del params, state
    torch.cuda.empty_cache()
    return counts


def phase_lm_serve_cli():
    """Phase 14: ``repro_torch.launch.serve``'s main path (the smoke
    config, as the reference's CLI always runs it) with --gse-tag 2 on the
    card, counted: kernel D decodes the quantized tree.  The decoded params
    must equal the CPU's bit for bit."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import gse_decode as D
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    torch.cuda.synchronize()
    D.reset_launch_counts()
    t0 = time.perf_counter()
    tokens = serve.main(["--gse-tag", "2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d_launches = D.gse_decode_dense.launches
    tokens_cpu = serve.main(["--gse-tag", "2", "--device", "cpu"])
    cfg = configs.get_config("qwen3_4b", smoke=True)
    trees = [serve.gse_params(T.init_params(
        cfg, torch.Generator().manual_seed(0), device=where), 2,
        log=lambda m: None) for where in ("cuda", "cpu")]
    leaves = list(zip(*(tree_leaves(t) for t in trees)))
    for a, b in leaves:
        require_bitwise("dequantized serve params, card against CPU", a, b)
    log("lm_serve_cli", gse_tag=2, wall_s=f"{wall:.2f}",
        d_launches=d_launches, params_bitwise_cpu=len(leaves),
        tokens_equal_cpu=tokens == tokens_cpu)
    flat = [t for step in tokens for t in step]
    if not flat or min(flat) < 0 or max(flat) >= cfg.vocab_size:
        raise AssertionError(f"serve CLI tokens out of range: {tokens}")
    if d_launches <= 0:
        raise AssertionError("serve CLI: kernel D never launched")
    return {"gse_decode_dense": d_launches}


def lm_entries(ctx, counts, twin_counts, add_entry):
    """Phase 10's entries for kernels D, E and F at phase 11's shapes.
    Launches: E's GEMV and tiled bodies and F's tensor-core body from
    phase 13, F's FFMA body from phase 12 (the f32 twin), D from 14."""
    import torch

    from repro_torch.core.precision_table import TAG_VALUE_BYTES
    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_decode as D
    from repro_torch.kernels import gse_matmul as E

    dense_src = "src/repro_torch/kernels/csrc/gse_dense.cu"
    p = ctx["packs"]["w_down"]
    n = p.head.numel()
    for t in TAGS:
        sc = ctx["scales"]["w_down", t]
        segs = (p.head, p.tail1 if t >= 2 else None,
                p.tail2 if t == 3 else None, sc)
        add_entry(f"gse_decode_dense.w_down.tag{t}", dense_src,
                  "src/repro/kernels/gse_decode.py:50",
                  lambda: D.gse_decode_dense(*segs, ei_bit=p.ei_bit, tag=t),
                  lambda: D.gse_decode_dense_plain(*segs, ei_bit=p.ei_bit,
                                                   tag=t), None,
                  n * (TAG_VALUE_BYTES[t] + 4) + p.table.numel() * 4,
                  n * DECODE_OPS[t] / FP32_OPS_PER_S * 1e3,
                  shape=list(p.head.shape), tag=t, out="f32",
                  launches=counts["gse_decode_dense"],
                  max_abs_err=ctx["err"]["D", "w_down", t])
    def matmul_entry(name, m, xd, t, segs, ei, w32, x32, n_table, err):
        kk, n = segs[0].shape
        x = x32.to(xd)
        gemv = m <= E.GEMV_M_MAX
        extra = {}
        ops = 2 * m * n * kk + kk * n * DECODE_OPS[t]
        op_ms = ops / FP32_OPS_PER_S * 1e3
        if not gemv:
            # Bound by the TF32 tensor cores, one pass per TF32 term (the
            # decode's FP32 operations run beside them); the FP32 bound is
            # what an FFMA body can reach.
            extra["tf32_terms"] = E.tiled_terms(xd)
            extra["fp32_bound_ms"] = op_ms
            op_ms = max(extra["tf32_terms"] * 2 * m * n * kk
                        / TF32_TC_OPS_PER_S,
                        kk * n * DECODE_OPS[t] / FP32_OPS_PER_S) * 1e3
        suffix = "" if xd == torch.float32 else ".xbf16"
        add_entry(f"gse_matmul_dense.{name}.M{m}.tag{t}{suffix}", dense_src,
                  "src/repro/kernels/gse_matmul.py:52",
                  lambda: E.gse_matmul_dense(x, *segs, ei_bit=ei, tag=t),
                  lambda: E.gse_matmul_dense_plain(x, *segs, ei_bit=ei,
                                                   tag=t),
                  lambda: torch.matmul(x32, w32),
                  kk * n * TAG_VALUE_BYTES[t] + n_table * 4
                  + m * kk * x.element_size() + m * n * 4, op_ms,
                  plain_reps=2, reps=5, inner=3, shape=[m, kk, n], tag=t,
                  x_dtype=str(xd).split(".")[-1],
                  body="gemv" if gemv else "tiled",
                  launches=counts["e_gemv" if gemv else "e_tiled"],
                  max_abs_err=err, **extra)

    # The GEMV (M 4): f32 x at every tag on wq and w_down, bf16 x (the
    # model's compute dtype: phase 13's instantiation) at phase 13's tag 2
    # on every decode-step shape.  The tiled body (M 2048): every prefill
    # shape at every tag, x in bf16 and in f32.  The library call
    # multiplies the f32 copy of x, made outside the timed call.
    linears = ("wq", "wk/wv", "wo", "w_gate/w_up", "w_down")
    prefill_m = LM_FULL["batch"] * LM_FULL["prompt"]
    cases = [(name, 4, torch.float32, t) for name in ("wq", "w_down")
             for t in TAGS]
    cases += [(name, 4, torch.bfloat16, 2) for name in linears]
    cases += [(name, prefill_m, xd, t) for name in linears for t in TAGS
              for xd in (torch.bfloat16, torch.float32)]
    for name, m, xd, t in cases:
        p = ctx["mats"][name]
        sc = ctx["scales"][ctx["parent"][name], t]
        segs = (p.head, p.tail1 if t >= 2 else None,
                p.tail2 if t == 3 else None, sc)
        matmul_entry(name.replace("/", "_"), m, xd, t, segs, p.ei_bit,
                     ctx["dec"][name, t], ctx["x"][name, m],
                     p.table.numel(), ctx["err"]["E", name, m, t, xd])
    x4 = ctx["unembed_x"][4]
    for xd, t in ((torch.float32, 1), (torch.float32, 2),
                  (torch.bfloat16, 2)):
        segs, ei, w32 = ctx["unembed", t]
        matmul_entry("unembed", 4, xd, t, segs, ei, w32, x4, 8,
                     ctx["err"]["E", "unembed", 4, t, xd])
    flash_src = "src/repro_torch/kernels/csrc/flash_attn.cu"
    for label, dt in (("phase11", torch.float32), ("phase11", torch.bfloat16),
                      ("phase13", torch.bfloat16)):
        q, k, v = ctx["qkv", label, dt]
        b, s, h, hd = q.shape
        g = h // k.shape[2]
        body = F.flash_body(dt, hd)
        # The library yardstick: SDPA over heads-first copies with K and V
        # repeated per group, made outside the timed call.
        ql, kl, vl = (q.transpose(1, 2).contiguous(),
                      k.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous(),
                      v.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous())
        flops = 4 * b * h * s * s * hd / 2  # causal: half the score matrix
        fp32_ms = flops / FP32_OPS_PER_S * 1e3
        extra = {}
        if body == "mma":
            # Bound by the bf16 tensor cores; the FP32 bound beside it is
            # what the FFMA body (the earlier design for bf16) can reach.
            extra["fp32_bound_ms"] = fp32_ms
            if label == "phase11":
                extra["earlier_ms"] = cuda_ms(
                    lambda: F.flash_attention_gqa(q, k, v, causal=True,
                                                  body="ffma"), reps=2)
                extra["earlier_design"] = ("flash_fwd_kernel (FFMA, "
                                           "register tiles) on bf16")
        add_entry(f"flash_attention_gqa.{str(dt).split('.')[-1]}.causal"
                  f"{'' if label == 'phase11' else '.s' + str(s)}",
                  flash_src, "src/repro/kernels/flash_attn.py:76",
                  lambda: F.flash_attention_gqa(q, k, v, causal=True),
                  lambda: F.flash_attention_gqa_plain(q, k, v, causal=True),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      ql, kl, vl, is_causal=True),
                  (q.numel() * 2 + k.numel() * 2) * q.element_size(),
                  flops / (BF16_TC_OPS_PER_S if body == "mma"
                           else FP32_OPS_PER_S) * 1e3,
                  plain_reps=2, reps=3, inner=2,
                  shape=[b, s, h, k.shape[2], hd], body=body,
                  launches=(counts["f_mma"] if body == "mma"
                            else twin_counts["f_ffma"]),
                  launches_from="phase 13" if body == "mma" else "phase 12",
                  max_abs_err=ctx["err"]["F", label, dt], **extra)


# --- the hybrid family: recurrentgemma_2b (phases 26-27) --------------------

# Phase 26: recurrentgemma_2b at full width cut to three layers (RG-LRU,
# RG-LRU, local attention) and a window of 64, so that a 96-token prompt
# and 16 teacher-forced decode steps wrap the ring in prefill and in
# decode.  Phase 27: full width and depth, bf16, a 2560-token prompt.
HYBRID_SEED = 0
HYBRID_TWIN = dict(batch=2, prompt=96, steps=16, layers=3, window=64)
HYBRID_TWIN_VARIANTS = {"dense": {}, "tag2": dict(gse_serve=True, gse_tag=2),
                        "kv8": dict(kv_cache_gse=True),
                        "tag2_bf16": dict(gse_serve=True, gse_tag=2,
                                          compute_dtype="bfloat16")}
HYBRID_FULL = dict(batch=4, prompt=2560, steps=32)
# F's cases at recurrentgemma's attention (H 10, KV 1, hd 256): (label,
# B, S = T, H, KV, hd, window, dtype name, tol, body or None for
# flash_body's).  "full" and "twin" are phases 27's and 26's shapes.
HYBRID_FLASH = (("full", 4, 2560, 10, 1, 256, 2048, "bfloat16", 2e-2, None),
                ("twin", 2, 96, 10, 1, 256, 64, "float32", 2e-5, None),
                ("ragged", 2, 1000, 10, 1, 256, 300, "bfloat16", 2e-2, None),
                ("ragged", 2, 1000, 10, 1, 256, 300, "float32", 2e-5, None),
                ("ragged", 2, 1000, 10, 1, 256, 300, "bfloat16", 2e-2,
                 "ffma"),
                ("ragged", 2, 1000, 10, 1, 256, 0, "bfloat16", 2e-2, None),
                ("ragged", 2, 1000, 10, 1, 256, 0, "float32", 2e-5, None),
                ("ragged", 2, 1000, 32, 8, 128, 257, "bfloat16", 2e-2, None),
                ("ragged", 2, 1000, 32, 8, 72, 100, "float32", 2e-5, None))
# lru_scan's shapes (B, S, W): phase 26's and phase 27's prefill.
LRU_SHAPES = ((2, 96, 2560), (4, 2560, 2560))
# tools/reference/hybrid_serve_ref.py's output (JAX on the CPU), as LM_REF.
HYBRID_REF = {
    "dense": [
        ([50632, 143826],
         [0.28274571895599365, -0.7582851648330688, 0.3984626829624176,
          -1.172687292098999, -1.0190027952194214, 2.5348613262176514,
          0.1964273303747177, 0.7424234747886658],
         4.7427778244018555),
        ([95824, 118237],
         [1.0331318378448486, -1.5367441177368164, -0.7402455806732178,
          0.5834293961524963, 0.9730863571166992, -0.24252605438232422,
          -0.07782137393951416, 0.5288021564483643],
         4.668034553527832),
        ([158321, 244691],
         [-0.8636420369148254, -0.46253249049186707, 0.19312512874603271,
          -0.044242918491363525, -0.5408675074577332, 0.4806329011917114,
          -0.01695092022418976, -0.9653375148773193],
         4.570062637329102),
        ([209116, 41148],
         [0.17128239572048187, 1.971815586090088, 2.4510321617126465,
          1.3790767192840576, -0.24855342507362366, 1.9677807092666626,
          1.1593953371047974, 0.2515562176704407],
         5.171428203582764),
        ([225789, 77649],
         [-0.062486082315444946, -0.004856012761592865, -0.6074924468994141,
          -0.8717195391654968, 0.12362025678157806, 0.11591118574142456,
          0.9840810298919678, 0.148395836353302],
         5.0057172775268555),
        ([229919, 212062],
         [0.5491836071014404, 0.9963923096656799, -0.6543084383010864,
          -0.04295775294303894, 0.09154125303030014, 2.025709629058838,
          -0.2778211534023285, -2.808372735977173],
         4.598168849945068),
        ([227934, 110242],
         [0.5435822010040283, -1.6920037269592285, 0.42898058891296387,
          -2.082371234893799, 0.8216201663017273, -1.2686153650283813,
          0.13468551635742188, 0.3594214618206024],
         4.857706069946289),
        ([131310, 23050],
         [0.7251827716827393, -1.0798001289367676, 0.1088067889213562,
          -0.954429566860199, 0.5201135873794556, -0.4998302459716797,
          0.14549562335014343, -0.5298415422439575],
         5.273178577423096),
        ([227966, 251038],
         [-0.6514402627944946, -0.6729986667633057, -0.5462712049484253,
          -0.5014348030090332, 0.05702521651983261, -0.6793959736824036,
          -0.6794344186782837, 0.30995020270347595],
         5.011477470397949),
        ([207784, 252455],
         [-1.022829294204712, 1.9084405899047852, -0.9425280094146729,
          -1.195221185684204, -1.574678897857666, -0.20315077900886536,
          -0.12347924709320068, 0.1513337343931198],
         5.0403337478637695),
        ([194257, 216892],
         [-0.4539588689804077, -1.0002875328063965, 0.2409517765045166,
          0.7453835010528564, -0.546315610408783, -0.44857102632522583,
          0.8118177056312561, -0.6795529723167419],
         4.9312615394592285),
        ([9407, 227516],
         [-0.35123610496520996, 0.45882850885391235, -1.608337640762329,
          -0.24311602115631104, -1.5366911888122559, -0.4792073667049408,
          -0.9246776103973389, 0.19999171793460846],
         4.81265926361084),
        ([11725, 52856],
         [0.7408668398857117, 1.2232489585876465, -0.7776480317115784,
          0.14199915528297424, 0.4751858711242676, 0.5048944354057312,
          -0.4605071246623993, 0.6455063223838806],
         5.197799205780029),
        ([45963, 74295],
         [-1.2761127948760986, 3.7020866870880127, -0.6137751936912537,
          -0.11907505989074707, 0.12561696767807007, 0.5225290060043335,
          -0.8299036026000977, 0.04946872591972351],
         4.784371376037598),
        ([1712, 159564],
         [0.4768807291984558, 1.054986596107483, 0.542972981929779,
          -1.3349865674972534, 0.364815890789032, -0.0800604373216629,
          -1.4226129055023193, -1.1133543252944946],
         5.278506278991699),
        ([187962, 235255],
         [-1.429362416267395, -1.2801051139831543, 0.191989004611969,
          1.144079327583313, 0.9750058650970459, 1.91669499874115,
          -1.2672860622406006, -0.9931514263153076],
         5.82230281829834),
        ([139610, 114598],
         [-0.5022677779197693, -0.18587270379066467, -0.0034998655319213867,
          1.9341777563095093, -0.08993276953697205, 0.039779067039489746,
          1.0824027061462402, 0.9733217358589172],
         4.800544261932373),
    ],
    "tag2": [
        ([50632, 143826],
         [0.28274524211883545, -0.7582857608795166, 0.3984624445438385,
          -1.172687292098999, -1.0190026760101318, 2.5348620414733887,
          0.19642749428749084, 0.7424232363700867],
         4.742777347564697),
        ([95824, 118237],
         [1.0331326723098755, -1.5367450714111328, -0.7402458190917969,
          0.5834294557571411, 0.9730849266052246, -0.2425263524055481,
          -0.07782116532325745, 0.5288012027740479],
         4.668034076690674),
        ([158321, 244691],
         [-0.8636418581008911, -0.462533175945282, 0.19312512874603271,
          -0.04424259066581726, -0.5408669710159302, 0.4806327521800995,
          -0.016950786113739014, -0.965336799621582],
         4.570062637329102),
        ([209116, 41148],
         [0.17128223180770874, 1.9718170166015625, 2.4510321617126465,
          1.3790769577026367, -0.24855363368988037, 1.9677808284759521,
          1.1593948602676392, 0.25155672430992126],
         5.171428680419922),
        ([225789, 77649],
         [-0.06248652935028076, -0.004855692386627197, -0.6074914336204529,
          -0.8717191815376282, 0.1236199140548706, 0.11591160297393799,
          0.9840810894966125, 0.14839524030685425],
         5.005718231201172),
        ([229919, 212062],
         [0.5491827726364136, 0.9963924288749695, -0.6543087363243103,
          -0.04295848309993744, 0.09154079109430313, 2.025710105895996,
          -0.2778201997280121, -2.8083722591400146],
         4.598170280456543),
        ([227934, 110242],
         [0.5435823798179626, -1.6920039653778076, 0.42898058891296387,
          -2.082371234893799, 0.8216217160224915, -1.268614649772644,
          0.1346851885318756, 0.35942140221595764],
         4.857706069946289),
        ([131310, 23050],
         [0.7251830101013184, -1.0798001289367676, 0.1088067889213562,
          -0.954429566860199, 0.5201132893562317, -0.4998297095298767,
          0.14549630880355835, -0.5298420190811157],
         5.273179531097412),
        ([227966, 251038],
         [-0.6514400839805603, -0.6729994416236877, -0.5462702512741089,
          -0.5014351606369019, 0.05702606588602066, -0.6793956160545349,
          -0.6794342994689941, 0.30994927883148193],
         5.011476516723633),
        ([207784, 252455],
         [-1.0228300094604492, 1.908440351486206, -0.9425278306007385,
          -1.195222020149231, -1.5746791362762451, -0.20315086841583252,
          -0.1234787106513977, 0.15133389830589294],
         5.0403337478637695),
        ([194257, 216892],
         [-0.45395931601524353, -1.0002880096435547, 0.24095016717910767,
          0.7453828454017639, -0.546316385269165, -0.4485705494880676,
          0.81181800365448, -0.6795520782470703],
         4.931260108947754),
        ([9407, 227516],
         [-0.35123640298843384, 0.45882856845855713, -1.6083372831344604,
          -0.24311715364456177, -1.5366902351379395, -0.4792071282863617,
          -0.9246771335601807, 0.19999194145202637],
         4.812659740447998),
        ([11725, 52856],
         [0.7408671379089355, 1.2232491970062256, -0.7776485681533813,
          0.14199867844581604, 0.4751855731010437, 0.5048934817314148,
          -0.460507333278656, 0.6455065608024597],
         5.197797775268555),
        ([45963, 74295],
         [-1.2761120796203613, 3.702085018157959, -0.6137755513191223,
          -0.11907550692558289, 0.12561669945716858, 0.5225277543067932,
          -0.8299026489257812, 0.049468062818050385],
         4.784371376037598),
        ([1712, 159564],
         [0.47688087821006775, 1.0549863576889038, 0.5429733991622925,
          -1.3349862098693848, 0.36481618881225586, -0.0800609141588211,
          -1.4226117134094238, -1.1133530139923096],
         5.278505325317383),
        ([187962, 235255],
         [-1.4293627738952637, -1.280105710029602, 0.19198855757713318,
          1.144079566001892, 0.9750053882598877, 1.9166951179504395,
          -1.267284870147705, -0.9931519031524658],
         5.822303295135498),
        ([139610, 114598],
         [-0.5022692680358887, -0.1858721375465393, -0.003498256206512451,
          1.9341776371002197, -0.08993179351091385, 0.039777860045433044,
          1.0824040174484253, 0.973321795463562],
         4.8005452156066895),
    ],
    "kv8": [
        ([50632, 143826],
         [0.28274571895599365, -0.7582851648330688, 0.3984626829624176,
          -1.172687292098999, -1.0190027952194214, 2.5348613262176514,
          0.1964273303747177, 0.7424234747886658],
         4.7427778244018555),
        ([95824, 118237],
         [1.0009534358978271, -1.5356097221374512, -0.7374943494796753,
          0.5880704522132874, 0.9735375642776489, -0.22333920001983643,
          -0.0517844557762146, 0.5375874638557434],
         4.6887526512146),
        ([158321, 244691],
         [-0.8755708932876587, -0.45201024413108826, 0.19674599170684814,
          -0.04916423559188843, -0.5226776003837585, 0.48975008726119995,
          0.007361084222793579, -0.9396297335624695],
         4.595360279083252),
        ([209116, 41148],
         [0.16597096621990204, 1.9648057222366333, 2.455333709716797,
          1.3822816610336304, -0.25037431716918945, 1.9667385816574097,
          1.1655066013336182, 0.2311193346977234],
         5.163272380828857),
        ([225789, 77649],
         [-0.04826289415359497, -0.027907870709896088, -0.5935583114624023,
          -0.8858397603034973, 0.133135586977005, 0.10197794437408447,
          0.976143479347229, 0.16332560777664185],
         4.988737106323242),
        ([229919, 212062],
         [0.5585367679595947, 0.9929618835449219, -0.6484074592590332,
          -0.0337703675031662, 0.0746198371052742, 2.030623435974121,
          -0.25867950916290283, -2.801922082901001],
         4.588611602783203),
        ([227934, 110242],
         [0.5531304478645325, -1.7070375680923462, 0.40316641330718994,
          -2.1054627895355225, 0.8387977480888367, -1.2693674564361572,
          0.11403541266918182, 0.34882229566574097],
         4.850584506988525),
        ([131310, 23050],
         [0.7561304569244385, -1.0632871389389038, 0.10231178998947144,
          -0.9446614980697632, 0.5375284552574158, -0.4840926229953766,
          0.1476159393787384, -0.5178927183151245],
         5.277675628662109),
        ([227966, 251038],
         [-0.6548862457275391, -0.6844700574874878, -0.5826826691627502,
          -0.49163156747817993, 0.06292347609996796, -0.6878299117088318,
          -0.674797773361206, 0.3335539698600769],
         4.998843193054199),
        ([207784, 252455],
         [-1.0383987426757812, 1.8865885734558105, -0.950169563293457,
          -1.1987278461456299, -1.5905609130859375, -0.224906325340271,
          -0.11802953481674194, 0.16567227244377136],
         5.031017780303955),
        ([194257, 216892],
         [-0.4620668590068817, -1.001729965209961, 0.2670325040817261,
          0.7444292902946472, -0.5380458235740662, -0.4312230944633484,
          0.8114206790924072, -0.6748656630516052],
         4.930404186248779),
        ([9407, 227516],
         [-0.33430972695350647, 0.46294882893562317, -1.5998830795288086,
          -0.25484490394592285, -1.5205539464950562, -0.49599677324295044,
          -0.9286446571350098, 0.2096344381570816],
         4.825393199920654),
        ([11725, 230023],
         [0.7416769862174988, 1.2479722499847412, -0.7758015394210815,
          0.14704114198684692, 0.48067620396614075, 0.5021200776100159,
          -0.4671664237976074, 0.6479200124740601],
         5.184406280517578),
        ([45963, 74295],
         [-1.2863103151321411, 3.696824312210083, -0.6172035336494446,
          -0.12673819065093994, 0.13506580889225006, 0.5174092054367065,
          -0.8066811561584473, 0.0396074503660202],
         4.801344871520996),
        ([1712, 159564],
         [0.49229174852371216, 1.0636476278305054, 0.5577529668807983,
          -1.3256666660308838, 0.37710338830947876, -0.0952020138502121,
          -1.3959298133850098, -1.1165590286254883],
         5.2624616622924805),
        ([187962, 235255],
         [-1.4329596757888794, -1.2689292430877686, 0.18470817804336548,
          1.1367614269256592, 1.0013405084609985, 1.8971775770187378,
          -1.2529512643814087, -0.971725583076477],
         5.810791969299316),
        ([139610, 114598],
         [-0.5089670419692993, -0.18019843101501465, -0.005025386810302734,
          1.9168349504470825, -0.10476624965667725, 0.029598459601402283,
          1.085267186164856, 0.9448419809341431],
         4.782228946685791),
    ],
    "tag2_bf16": [
        ([50632, 143826],
         [0.2937558889389038, -0.7451008558273315, 0.38536882400512695,
          -1.1696630716323853, -0.9916071891784668, 2.528402090072632,
          0.2008814960718155, 0.760151743888855],
         4.73141622543335),
        ([95824, 118237],
         [1.0100557804107666, -1.5226335525512695, -0.7521287202835083,
          0.6113237142562866, 0.9814609885215759, -0.2211572527885437,
          -0.07219487428665161, 0.5697264075279236],
         4.634812355041504),
        ([158321, 244691],
         [-0.8729888200759888, -0.453727126121521, 0.21073612570762634,
          -0.040278851985931396, -0.53033047914505, 0.49226731061935425,
          -0.03377757966518402, -0.9731864929199219],
         4.585854530334473),
        ([209116, 41148],
         [0.15923947095870972, 1.9736371040344238, 2.430014133453369,
          1.3567763566970825, -0.24118518829345703, 1.9923399686813354,
          1.158351182937622, 0.2527691721916199],
         5.160165786743164),
        ([225789, 77649],
         [-0.060457050800323486, -0.009477362036705017, -0.6190733909606934,
          -0.9201100468635559, 0.1388576626777649, 0.11756688356399536,
          0.9626071453094482, 0.1355552077293396],
         5.018430709838867),
        ([229919, 212062],
         [0.52438884973526, 1.023646354675293, -0.6575635671615601,
          -0.07538500428199768, 0.06380841881036758, 2.0003116130828857,
          -0.26021307706832886, -2.759345531463623],
         4.596857070922852),
        ([227934, 110242],
         [0.5198402404785156, -1.687333106994629, 0.4390987157821655,
          -2.100801944732666, 0.8015981316566467, -1.2869255542755127,
          0.1549367606639862, 0.37387341260910034],
         4.833934307098389),
        ([238755, 23050],
         [0.7320113182067871, -1.0788520574569702, 0.09169459342956543,
          -0.9686357975006104, 0.5044321417808533, -0.49844419956207275,
          0.20256337523460388, -0.507739782333374],
         5.298209190368652),
        ([227966, 251038],
         [-0.6222306489944458, -0.6455905437469482, -0.5308153033256531,
          -0.46798110008239746, 0.07322676479816437, -0.681128740310669,
          -0.6868345737457275, 0.2721518874168396],
         5.004153728485107),
        ([207784, 252455],
         [-1.0245360136032104, 1.932917833328247, -0.9508124589920044,
          -1.1964961290359497, -1.566356897354126, -0.21191900968551636,
          -0.1112433671951294, 0.194350928068161],
         5.028779983520508),
        ([194257, 216892],
         [-0.42814916372299194, -0.9911892414093018, 0.2508947253227234,
          0.7437872886657715, -0.534713864326477, -0.4534280002117157,
          0.8104645609855652, -0.7054545879364014],
         4.89747428894043),
        ([9407, 227516],
         [-0.33100342750549316, 0.48931577801704407, -1.6357555389404297,
          -0.25971996784210205, -1.5395160913467407, -0.4573158025741577,
          -0.9407814145088196, 0.1579037457704544],
         4.817679405212402),
        ([11725, 52856],
         [0.7295863628387451, 1.2252458333969116, -0.7670626640319824,
          0.10820767283439636, 0.4940032660961151, 0.4903487265110016,
          -0.4566386342048645, 0.6797598600387573],
         5.196090221405029),
        ([45963, 74295],
         [-1.2796441316604614, 3.69981050491333, -0.5842036008834839,
          -0.12219509482383728, 0.10207710415124893, 0.5241952538490295,
          -0.8185432553291321, 0.047888487577438354],
         4.820484161376953),
        ([1712, 159564],
         [0.48918449878692627, 1.0575549602508545, 0.5582596063613892,
          -1.3139601945877075, 0.3663536310195923, -0.06694741547107697,
          -1.443343162536621, -1.086045503616333],
         5.271584510803223),
        ([187962, 235255],
         [-1.3974227905273438, -1.2752070426940918, 0.18473148345947266,
          1.1424212455749512, 0.9893542528152466, 1.9085114002227783,
          -1.278686285018921, -0.9851995706558228],
         5.813760757446289),
        ([139610, 114598],
         [-0.514070451259613, -0.21351730823516846, -0.0028215646743774414,
          1.9347132444381714, -0.08368785679340363, 0.04264155030250549,
          1.0964384078979492, 0.9825593829154968],
         4.772028923034668),
    ],
}


def hybrid_twin_config():
    """Phase 26's recurrentgemma_2b: full width, HYBRID_TWIN's depth and
    window, float32."""
    import torch

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("recurrentgemma_2b"),
                               num_layers=HYBRID_TWIN["layers"],
                               local_window=HYBRID_TWIN["window"],
                               compute_dtype=torch.float32)


def hybrid_tree_np(cfg, seed: int) -> dict:
    """Params of a hybrid ``cfg`` in the reference's list layout (one tree
    per layer) as numpy f32, drawn from ``default_rng(seed)`` in a fixed
    order: normal weights scaled by 1/sqrt(fan-in) (the conv taps by 0.1),
    ``lam`` uniform in [2, 5), as the reference's init draws them, and
    unit norms.  ``tools/reference/hybrid_serve_ref.py`` builds the
    reference's params from this same function."""
    import math

    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return a

    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    ff, vp, w = cfg.d_ff, cfg.padded_vocab, cfg.lru_width or cfg.d_model
    attn = set(cfg.attn_layer_ids())
    layers = []
    for i in range(cfg.num_layers):
        lay = {"norm1": {"scale": np.ones(d, np.float32)}}
        if i in attn:
            lay["attn"] = {"wq": normal((d, h * hd), 1 / math.sqrt(d)),
                           "wk": normal((d, kv * hd), 1 / math.sqrt(d)),
                           "wv": normal((d, kv * hd), 1 / math.sqrt(d)),
                           "wo": normal((h * hd, d), 1 / math.sqrt(h * hd))}
        else:
            lay["rglru"] = {
                "w_in": normal((d, w), 1 / math.sqrt(d)),
                "w_gate_branch": normal((d, w), 1 / math.sqrt(d)),
                "conv": normal((4, w), 0.1),
                "wa": normal((w, w), 1 / math.sqrt(w)),
                "wx": normal((w, w), 1 / math.sqrt(w)),
                "lam": rng.uniform(2.0, 5.0, size=w).astype(np.float32),
                "w_out": normal((w, d), 1 / math.sqrt(w))}
        lay["norm2"] = {"scale": np.ones(d, np.float32)}
        lay["mlp"] = {"w_gate": normal((d, ff), 1 / math.sqrt(d)),
                      "w_up": normal((d, ff), 1 / math.sqrt(d)),
                      "w_down": normal((ff, d), 1 / math.sqrt(ff))}
        layers.append(lay)
    return {"embed": {"table": normal((vp, d), 1 / math.sqrt(d))},
            "final_norm": {"scale": np.ones(d, np.float32)},
            "unembed": {"w": normal((d, vp), 1 / math.sqrt(d))},
            "layers": layers}


def hybrid_gse_params(params, cfg):
    """``params`` (the list layout) with every linear weight packed into
    ``gse_serve`` segments on its device, one table per weight
    (``init_params``'s layout); the other leaves are shared."""
    from repro_torch.models.modules import pack_linear_weight
    from repro_torch.tree import tree_map

    out = tree_map(lambda t: t, params)
    out["unembed"]["w"] = pack_linear_weight(params["unembed"]["w"], cfg)
    for lay in out["layers"]:
        for group, name in LM_LINEAR:
            if name in lay.get(group, {}):
                lay[group][name] = pack_linear_weight(lay[group][name], cfg)
    return out


def hybrid_params_cpu():
    """Phase 26's dense params as CPU tensors: hybrid_tree_np (about 30 s
    of numpy on one core) through params_from_repro."""
    from repro_torch import convert

    return convert.params_from_repro(
        hybrid_tree_np(hybrid_twin_config(), HYBRID_SEED), device="cpu")


def hybrid_twin_cpu():
    """Phase 26's CPU twin, from the same numpy params as the card's run:
    per variant the logits, the seconds and the digest of the params it
    ran (the linears packed on the CPU)."""
    tw = HYBRID_TWIN
    cfg0 = hybrid_twin_config()
    dense = hybrid_params_cpu()
    toks = lm_tokens(cfg0, HYBRID_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    out, packed, memo = {}, None, {}
    for name, kw in HYBRID_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pc = dense
        if cfg.gse_serve:
            packed = packed or hybrid_gse_params(dense, cfg)
            pc = packed
        lc, sc = lm_run(cfg, pc, toks, "cpu", tw["prompt"], tw["steps"])
        out[name] = (lc, sc, tree_digest(pc, memo))
    return out


def flash_bound_ms(b, s, h, hd, window, rate) -> float:
    """F's operation bound: 4 hd operations per (query, key) pair it keeps,
    ``sum_i min(i + 1, window)`` pairs per (batch, head) (the causal
    triangle without a window)."""
    w = window or s
    pairs = sum(min(i + 1, w) for i in range(s))
    return 4 * hd * pairs * b * h / rate * 1e3


def phase_hybrid_kernels():
    """Phase 26, part 1: F with a window and at hd 256 on both bodies
    (HYBRID_FLASH) against its plain version, and lru_scan bitwise its
    plain version at LRU_SHAPES; returns their inputs for phase 10."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import lru_scan as L

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    ctx = {"err": {}, "qkv": {}, "lru": {}}
    for label, b, s, h, kv, hd, window, dt, tol, body in HYBRID_FLASH:
        dt = getattr(torch, dt)
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
        got = F.flash_attention_gqa(q, k, v, window=window, body=body)
        want = F.flash_attention_gqa_plain(q, k, v, window=window)
        diff = (got.float() - want.float()).abs()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        used = float((diff / (tol + tol * want.float().abs())).max())
        body = body or F.flash_body(dt, hd)
        ctx["err"]["F", label, dt, body, window] = float(diff.max())
        if label != "ragged":
            ctx["qkv"][label] = (q, k, v, window)
        log("hybrid_kernels", kernel="flash_attention_gqa", case=label,
            body=body, b=b, heads=h, kv_heads=kv, s=s, hd=hd, window=window,
            dtype=str(dt), max_abs_err=float(diff.max()),
            tol=f"rtol {tol} atol {tol}", tol_used=f"{used:.3f}")
        del q, k, v, got, want, diff
    rng = np.random.default_rng(26)
    for shape in LRU_SHAPES:
        a = torch.from_numpy(rng.uniform(0.5, 1.0, size=shape)
                             .astype(np.float32)).to(dev)
        bb = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                              ).to(dev)
        h0 = torch.from_numpy(rng.normal(size=(shape[0], shape[2]))
                              .astype(np.float32)).to(dev)
        h, last = L.lru_scan(a, bb, h0)
        hp, lastp = L.lru_scan_plain(a, bb, h0)
        require_bitwise(f"lru_scan {shape} against its plain version", h, hp)
        require_bitwise(f"lru_scan {shape} h_last", last, lastp)
        ctx["lru"][shape] = (a, bb, h0)
        log("hybrid_kernels", kernel="lru_scan", shape=list(shape),
            bitwise_plain=True, max_abs_err=0.0)
    return ctx


def phase_hybrid_twin(twins=None, params=None):
    """Phase 26, part 2: recurrentgemma_2b at full width, three layers and
    a window of 64, on the card and as its CPU twin (from ``twins``) from
    the same numpy params (``params``: a future of hybrid_params_cpu, made
    beside the earlier phases; made here when None), against each other
    and against the reference's digest (HYBRID_REF): dense, gse_serve tag
    2 and kv_cache_gse at float32, and gse_serve tag 2 at bfloat16.
    Returns the launches per kernel body, summed over the f32 variants
    and (key "bf16") of the bf16 one."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.kernels import lru_scan as L
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    tw = HYBRID_TWIN
    cfg0 = hybrid_twin_config()
    t0 = time.perf_counter()
    dense_cpu = params.result() if params is not None else \
        hybrid_params_cpu()
    dense_gpu = tree_map(lambda t: t.to(dev), dense_cpu)
    del dense_cpu
    toks = lm_tokens(cfg0, HYBRID_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    log("hybrid_twin", layers=tw["layers"], d_model=cfg0.d_model,
        heads=cfg0.num_heads, kv_heads=cfg0.num_kv_heads, hd=cfg0.hd,
        lru_width=cfg0.lru_width, d_ff=cfg0.d_ff, vocab=cfg0.vocab_size,
        window=cfg0.local_window, batch=tw["batch"], prompt=tw["prompt"],
        steps=tw["steps"], params_s=f"{time.perf_counter() - t0:.2f}")
    card, packed = {}, None
    for name, kw in HYBRID_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pg = dense_gpu
        if cfg.gse_serve:
            packed = packed or hybrid_gse_params(dense_gpu, cfg)
            pg = packed
        torch.cuda.synchronize()
        for mod in (E, F, L):
            mod.reset_launch_counts()
        lg, sg = lm_run(cfg, pg, toks, dev, tw["prompt"], tw["steps"])
        got = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
               .items()}
        got.update({"f_" + k: v for k, v in
                    F.flash_attention_gqa.body_launches.items()})
        got.update({"f_window_" + k: v for k, v in
                    F.flash_attention_gqa.window_launches.items()})
        got["lru_scan"] = L.lru_scan.launches
        card[name] = (lg, sg, got, tree_digest(pg))
    del dense_gpu, packed
    cpu = twin_of(twins, "hybrid")
    counts = {}
    for name, kw in HYBRID_TWIN_VARIANTS.items():
        bf16 = lm_variant(cfg0, kw).compute_dtype == torch.bfloat16
        got = card[name][2]
        check_twin("hybrid_twin", name, card[name], cpu[name],
                   HYBRID_REF[name])
        if bf16:
            counts["bf16"] = got
            continue
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
    # The card's launches: at f32 F's windowed FFMA body at hd 256, E at
    # M = 2 and 192 under gse_serve and lru_scan; at bf16 F's windowed
    # tensor-core body at hd 256.
    log("hybrid_twin", launches_f32=json.dumps(
        {k: v for k, v in counts.items() if k != "bf16"}),
        launches_bf16=json.dumps(counts["bf16"]))
    need = ("e_gemv", "e_tiled", "f_window_ffma", "lru_scan")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"a kernel body of the f32 hybrid twin never "
                             f"launched: {counts}")
    need = ("e_gemv", "e_tiled", "f_window_mma", "lru_scan")
    if min(counts["bf16"][k] for k in need) <= 0:
        raise AssertionError(f"a kernel body of the bf16 hybrid twin never "
                             f"launched: {counts['bf16']}")
    return counts


def phase_hybrid_full():
    """Phase 27: recurrentgemma_2b at full width and depth under gse_serve
    tag 2 at bf16, weights packed on the card; a prompt past the window,
    then greedy decoding, counted."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.kernels import lru_scan as L
    from repro_torch.models import stepfns, transformer as T
    from repro_torch.quant import gse_tensor as Q

    dev = torch.device("cuda")
    fu = HYBRID_FULL
    cfg = dataclasses.replace(get_config("recurrentgemma_2b"),
                              gse_serve=True, gse_tag=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the earlier phases' tensors
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        HYBRID_SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = Q.tree_bytes(params, cfg.gse_tag)
    toks = torch.from_numpy(lm_tokens(cfg, HYBRID_SEED + 2, fu["batch"],
                                      fu["prompt"])).to(dev)
    state = T.decode_state_init(cfg, fu["batch"], fu["prompt"] + fu["steps"],
                                device=dev)
    torch.cuda.synchronize()
    for mod in (E, F, L):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    logits = stepfns.make_prefill_step(cfg)(params, toks, state=state)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(fu["steps"]):
        logits, state = T.decode_step(cfg, params, state, tok,
                                      fu["prompt"] + i)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
              .items()}
    counts.update({"f_" + k: v for k, v in
                   F.flash_attention_gqa.body_launches.items()})
    counts.update({"f_window_" + k: v for k, v in
                   F.flash_attention_gqa.window_launches.items()})
    counts["lru_scan"] = L.lru_scan.launches
    step_ms = decode_s * 1e3 / fu["steps"]
    ring = state["layers"][cfg.attn_layer_ids()[0]]["k"].shape[1]
    log("hybrid_full", layers=cfg.num_layers,
        attn_layers=len(cfg.attn_layer_ids()), window=cfg.local_window,
        ring_slots=ring, gse_tag=cfg.gse_tag, dtype=str(cfg.compute_dtype),
        batch=fu["batch"], prompt=fu["prompt"], steps=fu["steps"],
        init_s=f"{init_s:.2f}", prefill_s=f"{prefill_s:.3f}",
        prefill_tok_per_s=f"{fu['batch'] * fu['prompt'] / prefill_s:.0f}",
        ms_per_decode_step=f"{step_ms:.3f}",
        decode_tok_per_s=f"{fu['batch'] * 1e3 / step_ms:.1f}",
        tree_bytes=nbytes,
        peak_gb=f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.2f}",
        launches=json.dumps(counts))
    log("hybrid_full", tokens=json.dumps(torch.stack(out, 1).tolist()))
    if not bool(finite):
        raise AssertionError("hybrid full-depth serve: non-finite logits")
    need = ("e_gemv", "e_tiled", "f_window_mma", "lru_scan")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"a kernel of the hybrid serving path never "
                             f"launched: {counts}")
    del params, state
    torch.cuda.empty_cache()
    return counts


def hybrid_entries(ctx, counts, twin_counts, add_entry):
    """Phase 10's rows for F at recurrentgemma's attention (hd 256, a
    window) and for lru_scan.  Launches: F's tensor-core body and lru_scan
    from phase 27, F's FFMA body from phase 26 (the f32 twin)."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import lru_scan as L

    flash_src = "src/repro_torch/kernels/csrc/flash_attn.cu"
    for label in ("full", "twin"):
        q, k, v, window = ctx["qkv"][label]
        b, s, h, hd = q.shape
        dt = q.dtype
        body = F.flash_body(dt, hd)
        g = h // k.shape[2]
        # The library yardstick: SDPA over heads-first copies with K and V
        # repeated per group and the same boolean mask, made outside the
        # timed call.
        ql, kl, vl = (q.transpose(1, 2).contiguous(),
                      k.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous(),
                      v.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous())
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        mask = (j <= i) & (j > i - window)
        rate = BF16_TC_OPS_PER_S if body == "mma" else FP32_OPS_PER_S
        extra = {}
        if body == "mma":
            extra["fp32_bound_ms"] = flash_bound_ms(b, s, h, hd, window,
                                                    FP32_OPS_PER_S)
        add_entry(f"flash_attention_gqa.{str(dt).split('.')[-1]}.hd{hd}"
                  f".window{window}.s{s}", flash_src,
                  "src/repro/kernels/flash_attn.py:76",
                  lambda: F.flash_attention_gqa(q, k, v, window=window),
                  lambda: F.flash_attention_gqa_plain(q, k, v, window=window),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      ql, kl, vl, attn_mask=mask),
                  (q.numel() * 2 + k.numel() * 2) * q.element_size(),
                  flash_bound_ms(b, s, h, hd, window, rate),
                  plain_reps=1 if label == "full" else 2, reps=3, inner=2,
                  shape=[b, s, h, k.shape[2], hd], window=window, body=body,
                  launches=(counts["f_window_mma"] if body == "mma"
                            else twin_counts["f_window_ffma"]),
                  launches_from="phase 27" if body == "mma" else "phase 26",
                  max_abs_err=ctx["err"]["F", label, dt, body, window],
                  **extra)
        del ql, kl, vl
    shape = LRU_SHAPES[-1]
    a, bb, h0 = ctx["lru"][shape]
    nb, s, w = shape
    add_entry("lru_scan", "src/repro_torch/kernels/csrc/lru_scan.cu",
              "src/repro/models/rglru.py:100 (associative_scan, no Pallas "
              "kernel)",
              lambda: L.lru_scan(a, bb, h0),
              lambda: L.lru_scan_plain(a, bb, h0), None,
              12 * nb * s * w, 2 * nb * s * w / FP32_OPS_PER_S * 1e3,
              plain_reps=1, reps=5, inner=2, shape=list(shape),
              launches=counts["lru_scan"], launches_from="phase 27",
              max_abs_err=0.0)


# --- the moe and ssm families (phases 28-31) ------------------------------

# Phase 28: qwen3_moe_235b_a22b at full width (d 4096, H 64 / KV 4 / hd
# 128, qk-norm, 128 experts top-8, vocab 151936) cut to two layers and an
# expert ff of 256 (from 1536) so the host holds the CPU twin's params;
# two requests of a 64-token prompt, 16 teacher-forced decode steps.
# "tag2_drops" also sets capacity_factor 0.5, so the prefill's capacity is
# the floor of 8 pairs an expert against 8 on average: more pairs are
# dropped than at the default 1.25 (which drops some too).
MOE_SEED = 0
MOE_TWIN = dict(batch=2, prompt=64, steps=16, layers=2, expert_ff=256)
MOE_TWIN_VARIANTS = {"dense": {},
                     "tag2_drops": dict(gse_serve=True, gse_tag=2,
                                        capacity_factor=0.5),
                     "tag2_bf16": dict(gse_serve=True, gse_tag=2,
                                       compute_dtype="bfloat16")}
# Phase 29: full width; qwen3_moe cut to 6 of 94 layers (f32 expert
# stacks: 9.66 GB a layer), grok1 to 2 of 64 (19.3 GB a layer).
MOE_FULL = {"qwen3_moe_235b_a22b": dict(layers=6, batch=4, prompt=512,
                                        steps=32),
            "grok1_314b": dict(layers=2, batch=4, prompt=512, steps=8)}
# F at the moe attention shapes: (arch, B, S, H, KV, hd): phase 29's
# prefill.
MOE_FLASH = (("qwen3_moe_235b_a22b", 4, 512, 64, 4, 128),
             ("grok1_314b", 4, 512, 48, 8, 128))
# tools/reference/moe_serve_ref.py's output (JAX on the CPU): per variant,
# per step, lm_digest's fields and the route digest (route_digest).
MOE_REF = {
    'dense': [
        ([72849, 143792], [-0.5549846887588501, 0.38110366463661194,
         -1.2837132215499878, -1.1295300722122192, 0.10903647541999817,
         -0.13757501542568207, -0.5037400722503662, -0.8933053016662598],
         5.260203838348389, [[4113897324, 4204957801], [2711537529,
         3772532523]]),
        ([7579, 128413], [0.643554151058197, 0.7396838665008545,
         -0.5333328247070312, -1.4337811470031738, -0.1915052831172943,
         0.044506460428237915, 0.3417765200138092, -0.5833737850189209],
         4.714756488800049, [[856460807, 3126053847], [717265070,
         2736270207]]),
        ([92074, 40064], [0.5849089026451111, 1.6344045400619507,
         0.0001779552549123764, -0.867948055267334, 0.35290759801864624,
         1.3261914253234863, 0.03641560673713684, -0.29132142663002014],
         5.189885139465332, [[896141796, 3068807240], [2420656568,
         521699914]]),
        ([3367, 118518], [0.638471245765686, 0.24160483479499817,
         -0.33068811893463135, -0.4692653715610504, 0.2925625443458557,
         1.5602779388427734, -0.5304183959960938, -1.3149383068084717],
         5.51070499420166, [[168705624, 3122342280], [3668438558, 964642715]]),
        ([115582, 62289], [0.09953658282756805, 0.21981143951416016,
         -0.8145215511322021, -0.4090338349342346, -0.45598727464675903,
         1.0123568773269653, 0.0551476925611496, -0.5393152832984924],
         4.51425313949585, [[4294788655, 1649912480], [922849524,
         2023113002]]),
        ([3367, 128413], [0.49321627616882324, 1.301030158996582,
         -0.09587281942367554, -0.9741561412811279, 0.22513626515865326,
         0.17638760805130005, -0.7834083437919617, -1.2159020900726318],
         4.673076152801514, [[640001148, 2908689974], [3068575948,
         3949464366]]),
        ([52796, 81346], [-0.07310079038143158, -0.5755606293678284,
         -1.5364092588424683, -0.7252005338668823, -0.2355046570301056,
         -0.005772411823272705, 0.3528476059436798, -0.12587812542915344],
         4.595286846160889, [[3928205092, 4058135657], [1237407074,
         3150951002]]),
        ([148956, 143792], [-0.6107665300369263, 1.033854365348816,
         -1.2336974143981934, -0.6442798376083374, -0.8761874437332153,
         0.681721568107605, -0.15421003103256226, -0.1443856656551361],
         4.686004161834717, [[1492011625, 3755486342], [1564007754,
         3173448117]]),
        ([10033, 66079], [0.6428629755973816, -0.8350423574447632,
         -1.8328827619552612, 0.8327939510345459, -0.975183367729187,
         -0.2344808429479599, -0.6341031789779663, -0.9903367757797241],
         4.70616340637207, [[1827913417, 3141446956], [1823535179,
         2316771824]]),
        ([84768, 55534], [1.4929193258285522, 0.9788857698440552,
         -1.5594550371170044, -1.524868130683899, -0.44922828674316406,
         0.3470468521118164, -0.9110338687896729, -0.15143010020256042],
         4.7850871086120605, [[455038931, 503916057], [2678761030,
         2394658638]]),
        ([92074, 128413], [1.2926702499389648, 0.5220051407814026,
         -0.9479805827140808, 0.21494245529174805, -0.9741777181625366,
         0.9842702150344849, 0.685082197189331, -1.2173242568969727],
         4.38983678817749, [[4176469144, 2428685385], [3617797801,
         3113035618]]),
        ([125165, 56885], [1.4757121801376343, -0.5768179893493652,
         -1.0053834915161133, 0.24901902675628662, -0.1702212691307068,
         -0.4235106110572815, -0.4842391312122345, -1.058012843132019],
         4.560692310333252, [[3266131310, 118062730], [635523156,
         2811017053]]),
        ([27259, 70294], [0.45575839281082153, 0.3957841396331787,
         -1.7757678031921387, 0.09532380849123001, 0.32895371317863464,
         0.6100082397460938, -0.36805328726768494, -0.45283424854278564],
         4.610324382781982, [[3223582536, 380393232], [1464360497,
         4252506698]]),
        ([76072, 70294], [0.26252174377441406, 0.16192704439163208,
         -0.6706266403198242, -0.3479729890823364, -0.18626031279563904,
         -1.3356114625930786, -0.15165945887565613, -0.880134105682373],
         4.684993743896484, [[1467501897, 599146602], [529561970,
         1275521824]]),
        ([92074, 114977], [0.9305054545402527, -0.9930357933044434,
         -1.0610549449920654, 0.5859928131103516, -0.8338172435760498,
         0.2883424758911133, 0.5364298820495605, -1.0552194118499756],
         5.06736421585083, [[950291956, 1010779297], [3068910929, 445224383]]),
        ([52796, 40264], [1.2394558191299438, 1.0178141593933105,
         -1.1907176971435547, 0.7244192957878113, -0.9755896329879761,
         0.5478988885879517, 1.4301800727844238, -0.5011102557182312],
         4.925798416137695, [[123780493, 2969778940], [2178625626,
         649374330]]),
        ([92074, 47701], [1.2283272743225098, 0.47154951095581055,
         -1.4622550010681152, -0.10741038620471954, -0.8963394165039062,
         0.40289685130119324, 0.21032455563545227, 0.2552017569541931],
         5.077579021453857, [[2411157677, 3911286774], [996972783,
         887355592]]),
    ],
    'tag2_drops': [
        ([72849, 143792], [-0.12246251106262207, 0.6110796928405762,
         -1.4689143896102905, -0.9542742967605591, 0.026057392358779907,
         0.29414111375808716, -0.8029292225837708, -0.7342826724052429],
         5.170915603637695, [[4113897324, 4204957801], [3935894010,
         1363029158]]),
        ([118479, 128413], [0.740718424320221, 0.918310284614563,
         -0.5362386107444763, -1.431419849395752, -0.3223456144332886,
         0.09438848495483398, 0.2924650311470032, -0.4584237337112427],
         5.010201454162598, [[856460807, 3126053847], [2411140103,
         2330067560]]),
        ([92074, 70294], [0.5356578230857849, 1.3595285415649414,
         -0.1965932846069336, -1.0276721715927124, 0.40354952216148376,
         1.2684459686279297, -0.0021722614765167236, -0.5829335451126099],
         5.1682209968566895, [[896141796, 3068807240], [1601846067,
         1943594376]]),
        ([3367, 58588], [0.38375166058540344, -0.0011496543884277344,
         -0.4511737823486328, -0.23885290324687958, 0.12208887934684753,
         1.5682907104492188, -0.5428429245948792, -1.2917627096176147],
         5.652839660644531, [[168705624, 3122342280], [3986687865,
         233410568]]),
        ([115582, 62289], [0.144457146525383, 0.5346131324768066,
         -1.073089361190796, -0.7937285900115967, -0.8246220350265503,
         1.191274881362915, 0.07150620222091675, -0.3154276907444],
         4.467638969421387, [[4294788655, 1649912480], [2994141963,
         1535743646]]),
        ([125900, 128413], [0.41747352480888367, 1.2847696542739868,
         -0.1831727921962738, -1.4322365522384644, 0.13727876543998718,
         0.26599186658859253, -0.8180826902389526, -1.1406269073486328],
         4.891800403594971, [[640001148, 2908689974], [2249599720,
         354192781]]),
        ([52796, 114977], [-0.19164158403873444, -0.5324585437774658,
         -1.5276182889938354, -0.6923192739486694, -0.1062123030424118,
         -0.07951688766479492, 0.307235985994339, -0.1769920140504837],
         4.594461917877197, [[3928205092, 4058135657], [1232587916,
         1278926844]]),
        ([108022, 143792], [-0.6373689770698547, 0.8250508308410645,
         -1.4113346338272095, -0.579010009765625, -0.8844456076622009,
         0.348075270652771, -0.07159319519996643, -0.13137198984622955],
         4.729921817779541, [[1492011625, 3755486342], [1865585272,
         4146825608]]),
        ([10033, 66079], [0.6256283521652222, -1.2736080884933472,
         -1.7693723440170288, 0.732082724571228, -1.0392110347747803,
         -0.3668173849582672, -0.48177284002304077, -1.1660429239273071],
         4.802757740020752, [[1827913417, 3141446956], [3795734900,
         672675448]]),
        ([84768, 55534], [1.2999584674835205, 0.8077991604804993,
         -1.6217849254608154, -1.6118911504745483, -0.11472609639167786,
         0.30798792839050293, -1.1552084684371948, -0.12027620524168015],
         4.703027248382568, [[455038931, 503916057], [1371949102, 342102274]]),
        ([92074, 128413], [1.097564697265625, 0.6031863689422607,
         -1.0983843803405762, 0.11625614762306213, -1.1015746593475342,
         1.0986316204071045, 0.5144177079200745, -1.251968502998352],
         4.44688606262207, [[4176469144, 2428685385], [167381927,
         4091283813]]),
        ([125165, 56885], [1.6356785297393799, -0.5745009183883667,
         -0.9249469041824341, -0.07481923699378967, -0.16667354106903076,
         -0.4056486189365387, -0.5841987133026123, -0.8999944925308228],
         4.674523830413818, [[3266131310, 118062730], [1749408693, 32702611]]),
        ([140004, 40064], [0.6614280343055725, 0.5538039803504944,
         -1.6847119331359863, -0.42918071150779724, 0.1446126103401184,
         0.7486038208007812, -0.5911819934844971, -0.23352786898612976],
         4.734269142150879, [[3223582536, 380393232], [195957822,
         2135012351]]),
        ([76072, 70294], [0.16795587539672852, -0.09598356485366821,
         -0.5827515125274658, -0.34358227252960205, -0.40004920959472656,
         -1.6696763038635254, -0.06724774837493896, -0.6181250810623169],
         4.652497291564941, [[1467501897, 599146602], [2656119127,
         3145105457]]),
        ([92074, 114977], [0.898042619228363, -0.9678638577461243,
         -1.0152419805526733, 0.2343212068080902, -0.8758034110069275,
         0.6040961146354675, 0.4343939423561096, -1.3998452425003052],
         5.183383464813232, [[950291956, 1010779297], [3861300126,
         3690973550]]),
        ([52796, 40264], [1.3346189260482788, 0.9242316484451294,
         -1.2028318643569946, 0.5428922772407532, -0.7395631074905396,
         0.7553785443305969, 1.4247640371322632, -0.5010208487510681],
         4.879655361175537, [[123780493, 2969778940], [3371401349,
         2496048663]]),
        ([92074, 47701], [1.3570891618728638, 0.03446340560913086,
         -1.6790893077850342, -0.08368901908397675, -0.7347949147224426,
         0.31104952096939087, -0.05312860757112503, 0.02951076626777649],
         4.937164306640625, [[2411157677, 3911286774], [2340349891,
         1457048137]]),
    ],
    'tag2_bf16': [
        ([72849, 143792], [-0.5401073694229126, 0.3924626111984253,
         -1.3016914129257202, -1.107738971710205, 0.09487760066986084,
         -0.13466113805770874, -0.5238803029060364, -0.8919861912727356],
         5.254668235778809, [[3821039952, 772252665], [668336998,
         1495934377]]),
        ([7579, 128413], [0.7418786287307739, 0.6620293259620667,
         -0.6563580632209778, -1.342419147491455, -0.19121134281158447,
         -0.05469966679811478, 0.3205533027648926, -0.5758650302886963],
         4.703514575958252, [[856460807, 3126053847], [715539682,
         2736270207]]),
        ([92074, 51758], [0.5979433655738831, 1.6332144737243652,
         -0.0014960765838623047, -0.8790841102600098, 0.3565283715724945,
         1.3163045644760132, -0.00611075758934021, -0.30549103021621704],
         5.15675163269043, [[896141796, 3068807240], [2102667446, 810072611]]),
        ([3367, 118518], [0.6444046497344971, 0.2301580309867859,
         -0.33420369029045105, -0.4807074964046478, 0.2549241781234741,
         1.545218825340271, -0.5441434383392334, -1.330696702003479],
         5.506861209869385, [[168705624, 3344476698], [2687655051,
         964642715]]),
        ([115582, 62289], [0.5747995972633362, 0.197435200214386,
         -0.8994855284690857, -0.6236493587493896, -0.731605589389801,
         1.8019696474075317, 0.17621228098869324, -0.928855299949646],
         4.5348615646362305, [[812779893, 1649912480], [3778574570,
         3421444061]]),
        ([3367, 128413], [0.4760948717594147, 1.34121572971344,
         -0.10489632189273834, -1.0091187953948975, 0.22170060873031616,
         0.13863909244537354, -0.8174423575401306, -1.1594901084899902],
         4.702786445617676, [[640001148, 2908689974], [1526549192,
         3949464366]]),
        ([52796, 81346], [-0.03241872787475586, -0.5631398558616638,
         -1.5301196575164795, -0.7364183664321899, -0.19505178928375244,
         -0.04153051972389221, 0.34699591994285583, -0.11187359690666199],
         4.580964088439941, [[3928205092, 3127769661], [1237407074,
         3150951002]]),
        ([108022, 143792], [-0.5837652683258057, 0.9976177215576172,
         -1.4483280181884766, -0.7422603964805603, -0.841588020324707,
         0.7419013977050781, -0.20410335063934326, -0.15153738856315613],
         4.649373531341553, [[1492011625, 3755486342], [119205216,
         2289186572]]),
        ([10033, 66079], [0.6287897825241089, -0.8003010749816895,
         -1.829946517944336, 0.8188170194625854, -0.9542113542556763,
         -0.21685338020324707, -0.6455909013748169, -0.9665178060531616],
         4.669661521911621, [[3184376991, 3234421125], [1823535179,
         435868249]]),
        ([84768, 55534], [1.5097378492355347, 0.9682307243347168,
         -1.5432450771331787, -1.518391489982605, -0.49154314398765564,
         0.3482435345649719, -0.9491668939590454, -0.11348342895507812],
         4.768244743347168, [[455038931, 503916057], [4160735580,
         1543188531]]),
        ([92074, 128413], [1.2161203622817993, 0.4385160505771637,
         -0.8584488034248352, 0.27847859263420105, -0.9719275236129761,
         0.903564453125, 0.6336000561714172, -1.2875763177871704],
         4.41469669342041, [[4176469144, 2428685385], [926373388,
         3113035618]]),
        ([125165, 56885], [1.5597648620605469, -0.6184097528457642,
         -0.9736014604568481, 0.18642058968544006, -0.27765363454818726,
         -0.5714110136032104, -0.3094962239265442, -0.94920814037323],
         4.768843650817871, [[1755643365, 118062730], [2001478460,
         4216956930]]),
        ([86416, 70294], [0.48215997219085693, 0.4125392436981201,
         -1.7912622690200806, 0.08197532594203949, 0.2884495258331299,
         0.5883229970932007, -0.38229987025260925, -0.42526474595069885],
         4.589367866516113, [[3223582536, 380393232], [1431898712,
         4252506698]]),
        ([128372, 70294], [0.25777366757392883, 0.18658232688903809,
         -0.4720221757888794, -0.41003069281578064, -0.08474940061569214,
         -1.3753340244293213, -0.19847312569618225, -0.8307411670684814],
         4.6538896560668945, [[3909569192, 599146602], [2925263218,
         2327539216]]),
        ([131974, 114977], [0.9529109597206116, -0.9903386235237122,
         -1.0919368267059326, 0.5758624076843262, -0.8499236106872559,
         0.3012758493423462, 0.5219261646270752, -1.0526429414749146],
         5.0236711502075195, [[950291956, 1010779297], [2897679884,
         3846154706]]),
        ([52796, 40264], [1.1250195503234863, 0.8119287490844727,
         -1.0379518270492554, 0.6816294193267822, -0.8668351769447327,
         0.3814968466758728, 1.188097357749939, -0.6442272663116455],
         4.9596452713012695, [[123780493, 167545810], [1177434313,
         649374330]]),
        ([92074, 47701], [1.2471085786819458, 0.4461267590522766,
         -1.473625898361206, -0.1947176456451416, -0.9207199811935425,
         0.39947861433029175, 0.14558061957359314, 0.2660539150238037],
         5.091961860656738, [[3489431461, 3911286774], [3804015320,
         887355592]]),
    ],
}
# tools/reference/moe_serve_ref.py's expert ids (its "ids", JAX on the
# CPU) for the bf16 variant, which phase 28 replays (replay_routes).
MOE_REF_IDS = {
    "tag2_bf16": (
        "aANDRSJMQVNMH0MsWkQHRUpSDkQBTi07THxaUg4qTkoHOEZKRHFMZkZETUw1GkIXGkx3Tn"
        "xEWiJmKTUOQE4HQ0YgXBVODX5pRkwPcVN3RE5EFXwJQ3EhJlhEFWweIWRpGlpvZCddfHFO"
        "fBkvB3h+aURGfENOSGYNFUROGmkcfiVdTm8Aa1pSMlpENBpGfGlOSl8HRlJLGkF8XhpYKg"
        "1EIQcjQjZfVlITRjtpaB5aXjRGXn9aNiAcHg1oRi58bU5eIFpeTmhCGBpIeFYgaSwtWnwV"
        "KV1DVQ1af1ogQyE2bVxaZjYNW09GSl4gT1o4B0FSBxkcKUFkAzZfB1ovRDZDYCZkCU5MDU"
        "YDTCEHZEhHCmwVBzhEDWhBWmhSREFqLEYHDUwgB2RtA2poUg4pQUYgDVggRBkhb3BkRFgg"
        "OEEhcw04CiBpOUEbSmU2X1I1OQdqTEonZUY5AzREByBfaiYxWkwpIBdtQ2UIaDlPIDZYXg"
        "dMISc5aHFSWiAHIShDaAFiQ0paWC1mJw1bOWVqI094DmUqSlQSNWJbRE9NUgcgWBkHbXdE"
        "ahMpZQd2Q3F+Sl53NEpaRBMnT3V7OWpfflIsVE4VIENMNFIcL18jZUwHKA1UalJmS35BXF"
        "8gUhdtIwo2Ukp4cEw5JiBqI0wNGFpvXwd3EzVNdThCIC9iXywZXgk9R05QcHsFK3BHK30A"
        "QikkQnUAO2onYgULYlMTQnMWS3dNQhYqfRpwQitzLUxwGksvC1sBdSxyYmUGe05XQhQkRx"
        "wXYmwWdkR1C0wcaDkvQz42cBgcTDcsYjUXBgFMR3g0L0dsHGIXC3BONDYGRx8sYjh1K1ks"
        "BTMcLGpwMkckYhh1NSssYjNEBiwtAXU0GDMGFwBSLREsQhwfcHUUTFJ2cDtODVJXBSxZNH"
        "BIOwIVV0RKUhwHLDQbe3BrHGw0A051DRRaXUx7LFdHdS0bAW4xC3UxGy0WeVRwNhw4e2UF"
        "MUNTXTIGLA56LHs2VxNlQwlEVzE2Q05KKzVrTlYxUC0LLSExBlkbRCwjH01MNB4xRngwax"
        "gtLAsRVy5OQVI2RGlSejUYVwYZTRgHcDMUHgZBa3dwHDgLLR4eVysGcFIXRy0ZF0oGFCNU"
        "MVJOSh4ANikZcCxHQwsYERxlexUxeFImazFsK1BKNxQGAUheHElGNnAsMEk+LRU6HU58Nh"
        "YUKQhOC1I2MTBbPk4LXjprLTJDHhg1RklweAc2RxxPEUYfEH0YQUtRRyg0EBcCSgQDFERJ"
        "MnAsC1RGPistNkEJfDU+FCseI0cyTnsXTkEtGB81CR46Th0YaGF1F15OSUNGCz4WQTJOWh"
        "1JGHAUSTMAaT40HkFKLEQUQjorHlRlPjI2FBwmUzcrSnpLVRxYJlM3RytiIjlHFFMAVWJT"
        "BEdYFF05OWJTRwBVFAE4UWJVUzA5R1NYATdiOSYcRwFVHDl/YlM5R2IWOBxYFBZoR3c5OC"
        "ZlAVhicxxdOBZHOV0yARxTYiZiH0dTORYQOXcaVxYmWGIWOSYKMF03HEdiFhEwSncMJhYf"
        "RzcaDHdiJh9YJxU5ciZNH2hmYicPWHIWOWYmG0czFmgnRwsfARBNH1UmJxYzARZVYndyOF"
        "1HKzBuXTktHzAWR10BVR86H2YnMEdycV86MBY3H3JVYnIWAR9HMHdYASZ3FnIAFQsmFkcB"
        "VTB3AGJHJh83VW4WJhEfN1VyZjoYNwEfVSYwRxZfOh9iJgEHN0ddSl4mMR9yRxYwJgc6N2"
        "YWclEBBSY9MF8WciZHMXFyJgVHFgFdNzAWckddLwEmJjBuRzNqeAFyMDddLyVfEhZiMAxy"
        "JlUBciYWJx8lB24mR3EwFkh4OBYwcnd4HycrMBZIKzd4JjMmMBZyKzpxERZyRwwHbiZYNz"
        "AWcR9yJ3gmYh86MBlydzdyMBZdIl5iXzA3FXJmcSY6OBZMdzAsJlUwd18RXQt4FnIwN3FV"
        "Xx8wFnJ3Zl1iSjdmcjBdFnheMCtycRA6Fn03MBZ6X2ZxaBZfJh9yYiABOjByFjcQBwtfB3"
        "hyMB9HLBZdcjAfd0Z4eTARB0x0VU4wVRgpfElfeUwsX1tVdgI3dHZOUUsCF1tjBBhbEQI8"
        "LVVbSzBALARYW2Z+Q3koVUBbLGI3YwIVWFt0PUA3AmMsY1ssSzAtPUlYFF4sQAg3S1hLPQ"
        "IQVVtjWEtfVSMIaURLY1tYPVYIX1gEY19LI3gIeVgYXwhbS0wVWDV4CEsfMEtYY1t4I0wX"
        "eF83I3QfcHxYI0t0c1U8X0x9I0t0CB95I0sQTF8VeXRLfUxKCDcjYiM1VWIXAhBLMUtMXl"
        "9ENVh4I0wNMARzGUsxFXUja2ZJcH14IzFMSggxeHNLH1gKSDFLI0wwVQh5dWNVS31bIzEj"
        "W0wxS2N9SDFbIx9LdHhrTH1LWDEfEGtMdHhLEHkxNltLMSMVCDAfMVtYTCN5C0gjTDF9JC"
        "wpdCMxHzZMNQhLWFsxFR9MCHQxTBUfWzd9LCMIdExVNWMxMUwfIzJLY1t0CHAxW0s3NTEj"
        "dH09SwhjMUwjCFsVNX0jCEwxWGNbSxB0TFhjMTdbTGMjMR9YGXBbIxlYMUtjZEtbMh1MMX"
        "R4fVUxS1tYTBBbI0x0WjFkMCN9FTFfakx0MVsQH1h0BEx0eBBYMSRbHxBMMUtRW3QjWFtM"
        "eH1LYzExNSNbSiRzdEwQI1t5Ah8xMWN0WyM1S3lbMUxLNUhVIyNMW0t9H3RYWzF0ECMYVU"
        "tff2YgFy9BWUY+RDJBHFlHMHJ0cUp+XSxbHzF0FUtKWCh+THZ3RBdlBhMwBAsuGS8wFh9x"
        "Xl8FJiNMS31bHzUxUlpid15tEwF6fRgyRxBObxZmXzA3YncHWxVYIzV9YyQpan9GaF8dE2"
        "V9BihBaDIgMDonB3QzNzhbeDEVVUofbkpfJ0NedkxJIwZlNiE+K2tdchYfZnFIK1sxNRAj"
        "TH1jRDkpX0wcegoYCys/LU4ufjoWdGZKd11fW0wjKTEQZAhDYi5fIDQXSUROSRx9QT5lXw"
        "dHOjB3J3JLGDF4WxB9QRw0Xz9UIDZOMkEGJRt9d34wXStxSnIHESMfMR10TCRKfkRMHC9k"
        "dU0tRgYZFGVwHnhfJgswSHIWZGNKZlhMYUJKTAdfEwoGLRdwGElEHkF3RyYfcThIFhExcF"
        "t0eBBMPDQxF2pDVG9lLRdZFDRLBkg6BxYreDAmd1tuZjFMdGNKJzYxdyEmHUotFxh/Bhsr"
        "KWY3MCtIFh9MEHRMMXgyH0tfDVoHaBVKWy14NkgGcFILFmleSDpmYit0WEt4MR8INWJUfj"
        "ESFxx2Ky0DHxdHTnh4MHdmcUhickt0MWNMeBAjXxlUYg0dfhc0GUQzMHNONjcwFiYQZitd"
        "W3QxI0tjGCJ3VH4TYiEoTFIlNk4XWjEfC3hfdBYQNXF0MVtnI30QNQ=="
    ),
}

# Phase 30: rwkv6_1p6b at full width (d 2048, ff 7168, vocab 65536, 32
# heads of 64) cut to three layers; two requests of a 64-token prompt, 16
# steps.  Phase 31: the whole model (24 layers), a 2048-token prompt.
RWKV_SEED = 0
RWKV_TWIN = dict(batch=2, prompt=64, steps=16, layers=3)
RWKV_TWIN_VARIANTS = {"dense": {}, "tag2": dict(gse_serve=True, gse_tag=2),
                      "tag2_bf16": dict(gse_serve=True, gse_tag=2,
                                        compute_dtype="bfloat16")}
RWKV_FULL = dict(batch=4, prompt=2048, steps=32)
# wkv6's shapes (B, S, H, N): phase 31's prefill and phase 30's, then
# ragged ones (a partial last chunk of steps; N below its block's width).
WKV_SHAPES = ((4, 2048, 32, 64), (2, 64, 32, 64), (1, 77, 3, 16),
              (2, 45, 2, 40))
# tools/reference/rwkv_serve_ref.py's output (JAX on the CPU), as LM_REF.
RWKV_REF = {
    'dense': [
        ([30921, 63488], [-0.23144644498825073, 0.9628686904907227,
         -0.5423518419265747, 0.625275731086731, 0.46391889452934265,
         -0.11972951889038086, 0.1990918517112732, 1.9490225315093994],
         4.641010761260986),
        ([32165, 31567], [1.821578025817871, 0.9594517946243286,
         -0.20952171087265015, -1.2689106464385986, 1.9981958866119385,
         -0.5242118239402771, 1.2745037078857422, 0.8259862065315247],
         4.784292697906494),
        ([8892, 41578], [0.35589009523391724, 0.4653151035308838,
         0.5821906328201294, -0.42806845903396606, -1.52805495262146,
         -1.2665631771087646, 0.7439504861831665, 2.722834587097168],
         4.603595733642578),
        ([6687, 37294], [0.2894449830055237, 0.5609356760978699,
         -0.8430083990097046, -0.4597196877002716, -0.688781201839447,
         -0.0762423649430275, 0.49653974175453186, 1.7740217447280884],
         4.643120765686035),
        ([28184, 35958], [0.5327107906341553, 0.409314900636673,
         -1.66075599193573, -1.4876608848571777, 1.7497992515563965,
         -1.6205596923828125, 0.8096519112586975, 0.8140638470649719],
         4.146695137023926),
        ([2460, 52347], [1.221136212348938, 2.2016913890838623,
         0.35567474365234375, -0.47077080607414246, 0.9592642784118652,
         -0.5365192890167236, -0.38022381067276, 1.2513755559921265],
         4.758448123931885),
        ([59534, 49296], [-0.5602054595947266, 1.3929393291473389,
         -0.10404059290885925, 0.6333270072937012, -0.7032851576805115,
         -1.2003281116485596, 1.0046849250793457, 1.3463134765625],
         4.465242385864258),
        ([17812, 14600], [-1.8203506469726562, 0.3377749025821686,
         0.8629947900772095, 0.7342548370361328, -1.7597689628601074,
         -0.1930641531944275, 0.018736541271209717, -0.3608980178833008],
         4.6394147872924805),
        ([884, 42541], [0.19531497359275818, 1.0049453973770142,
         2.6065733432769775, 1.5168352127075195, -0.9996159076690674,
         1.1107364892959595, -0.3992839455604553, 1.0694535970687866],
         4.587402820587158),
        ([45779, 14966], [0.5806832909584045, 3.2548818588256836,
         -0.5095479488372803, -0.2190396636724472, -0.74269038438797,
         1.5187339782714844, -0.08202403783798218, -0.5854350328445435],
         4.798650741577148),
        ([51342, 18127], [0.5428822040557861, 2.507938861846924,
         -0.6836529970169067, -0.6318686604499817, -0.14959843456745148,
         0.522004246711731, -0.9585305452346802, -0.8331575393676758],
         4.5237202644348145),
        ([7052, 26289], [0.543302595615387, 0.6654735803604126,
         0.3535904884338379, 0.31861674785614014, -0.617779552936554,
         1.6548914909362793, -0.5627545714378357, 1.7762773036956787],
         5.4401044845581055),
        ([38848, 1070], [1.4051756858825684, 1.1546151638031006,
         0.07125961780548096, -0.5727719068527222, -0.3245375454425812,
         0.84648197889328, -0.08730053901672363, 1.3219393491744995],
         4.541697025299072),
        ([60277, 12598], [1.7165539264678955, -0.43961048126220703,
         -0.005715906620025635, -1.4767473936080933, 1.459580659866333,
         -0.6451352834701538, -0.19073788821697235, 0.37304237484931946],
         4.49050235748291),
        ([36571, 53092], [-0.18497446179389954, 1.1440297365188599,
         -0.18795791268348694, -0.9120907187461853, 0.3600965142250061,
         -1.2723867893218994, -0.6980093717575073, 1.0061215162277222],
         4.118523597717285),
        ([7433, 44768], [0.3969001770019531, -0.14456751942634583,
         -0.3540341854095459, -1.0767909288406372, 1.4029791355133057,
         -0.45750442147254944, -0.32952046394348145, 2.3357129096984863],
         4.456151962280273),
        ([36839, 56417], [-0.6852049827575684, -0.09165112674236298,
         0.041147381067276, 0.0940205380320549, 0.12149682641029358,
         0.1500282883644104, -0.6029267311096191, 0.3245677649974823],
         4.416971206665039),
    ],
    'tag2': [
        ([30921, 63488], [-0.23144644498825073, 0.9628686904907227,
         -0.5423518419265747, 0.625275731086731, 0.46391889452934265,
         -0.11972951889038086, 0.1990918517112732, 1.9490225315093994],
         4.641010761260986),
        ([32165, 31567], [1.821578025817871, 0.9594517946243286,
         -0.20952171087265015, -1.2689106464385986, 1.9981958866119385,
         -0.5242118239402771, 1.2745037078857422, 0.8259862065315247],
         4.784292697906494),
        ([8892, 41578], [0.35589009523391724, 0.4653151035308838,
         0.5821906328201294, -0.42806845903396606, -1.52805495262146,
         -1.2665631771087646, 0.7439504861831665, 2.722834587097168],
         4.603595733642578),
        ([6687, 37294], [0.2894449830055237, 0.5609356760978699,
         -0.8430083990097046, -0.4597196877002716, -0.688781201839447,
         -0.0762423649430275, 0.49653974175453186, 1.7740217447280884],
         4.643120765686035),
        ([28184, 35958], [0.5327107906341553, 0.409314900636673,
         -1.66075599193573, -1.4876608848571777, 1.7497992515563965,
         -1.6205596923828125, 0.8096519112586975, 0.8140638470649719],
         4.146695137023926),
        ([2460, 52347], [1.221136212348938, 2.2016913890838623,
         0.35567474365234375, -0.47077080607414246, 0.9592642784118652,
         -0.5365192890167236, -0.38022381067276, 1.2513755559921265],
         4.758448123931885),
        ([59534, 49296], [-0.5602054595947266, 1.3929393291473389,
         -0.10404059290885925, 0.6333270072937012, -0.7032851576805115,
         -1.2003281116485596, 1.0046849250793457, 1.3463134765625],
         4.465242385864258),
        ([17812, 14600], [-1.8203506469726562, 0.3377749025821686,
         0.8629947900772095, 0.7342548370361328, -1.7597689628601074,
         -0.1930641531944275, 0.018736541271209717, -0.3608980178833008],
         4.6394147872924805),
        ([884, 42541], [0.19531497359275818, 1.0049453973770142,
         2.6065733432769775, 1.5168352127075195, -0.9996159076690674,
         1.1107364892959595, -0.3992839455604553, 1.0694535970687866],
         4.587402820587158),
        ([45779, 14966], [0.5806832909584045, 3.2548818588256836,
         -0.5095479488372803, -0.2190396636724472, -0.74269038438797,
         1.5187339782714844, -0.08202403783798218, -0.5854350328445435],
         4.798650741577148),
        ([51342, 18127], [0.5428822040557861, 2.507938861846924,
         -0.6836529970169067, -0.6318686604499817, -0.14959843456745148,
         0.522004246711731, -0.9585305452346802, -0.8331575393676758],
         4.5237202644348145),
        ([7052, 26289], [0.543302595615387, 0.6654735803604126,
         0.3535904884338379, 0.31861674785614014, -0.617779552936554,
         1.6548914909362793, -0.5627545714378357, 1.7762773036956787],
         5.4401044845581055),
        ([38848, 1070], [1.4051756858825684, 1.1546151638031006,
         0.07125961780548096, -0.5727719068527222, -0.3245375454425812,
         0.84648197889328, -0.08730053901672363, 1.3219393491744995],
         4.541697025299072),
        ([60277, 12598], [1.7165539264678955, -0.43961048126220703,
         -0.005715906620025635, -1.4767473936080933, 1.459580659866333,
         -0.6451352834701538, -0.19073788821697235, 0.37304237484931946],
         4.49050235748291),
        ([36571, 53092], [-0.18497446179389954, 1.1440297365188599,
         -0.18795791268348694, -0.9120907187461853, 0.3600965142250061,
         -1.2723867893218994, -0.6980093717575073, 1.0061215162277222],
         4.118523597717285),
        ([7433, 44768], [0.3969001770019531, -0.14456751942634583,
         -0.3540341854095459, -1.0767909288406372, 1.4029791355133057,
         -0.45750442147254944, -0.32952046394348145, 2.3357129096984863],
         4.456151962280273),
        ([36839, 56417], [-0.6852049827575684, -0.09165112674236298,
         0.041147381067276, 0.0940205380320549, 0.12149682641029358,
         0.1500282883644104, -0.6029267311096191, 0.3245677649974823],
         4.416971206665039),
    ],
    'tag2_bf16': [
        ([30921, 63488], [-0.18493251502513885, 1.003002405166626,
         -0.5164691805839539, 0.6223088502883911, 0.5100724697113037,
         -0.1326383352279663, 0.23300319910049438, 1.974677324295044],
         4.654474258422852),
        ([32165, 13132], [1.8315112590789795, 0.9814014434814453,
         -0.228563129901886, -1.269181251525879, 2.0035464763641357,
         -0.5156430006027222, 1.2888561487197876, 0.7927974462509155],
         4.7621355056762695),
        ([8892, 41578], [0.3751932382583618, 0.5218309164047241,
         0.639310359954834, -0.4666904807090759, -1.6054627895355225,
         -1.277347445487976, 0.7695540189743042, 2.7183845043182373],
         4.543407440185547),
        ([6687, 37294], [0.3412601053714752, 0.5500340461730957,
         -0.8647339940071106, -0.43054571747779846, -0.726951003074646,
         -0.10957616567611694, 0.5190017819404602, 1.8003878593444824],
         4.667027473449707),
        ([28184, 41885], [0.5654032826423645, 0.4411790072917938,
         -1.6493136882781982, -1.492159366607666, 1.7449960708618164,
         -1.6435362100601196, 0.8077999949455261, 0.8190850019454956],
         4.148651123046875),
        ([2460, 52347], [1.2186592817306519, 2.247140407562256,
         0.37307208776474, -0.4684516489505768, 0.9451637864112854,
         -0.5165732502937317, -0.3447474539279938, 1.292590856552124],
         4.731500148773193),
        ([59534, 49296], [-0.5508317351341248, 1.4316983222961426,
         -0.11359602212905884, 0.6347084641456604, -0.7034364342689514,
         -1.1949595212936401, 1.0269979238510132, 1.3298346996307373],
         4.479331016540527),
        ([17812, 14600], [-1.803584337234497, 0.3255951404571533,
         0.8421750068664551, 0.7435647249221802, -1.7480823993682861,
         -0.2147258222103119, 0.027941912412643433, -0.3749030828475952],
         4.639154434204102),
        ([884, 42541], [0.19819509983062744, 0.9484021663665771,
         2.5830581188201904, 1.5137274265289307, -1.014961838722229,
         1.0790901184082031, -0.3835170865058899, 1.041411280632019],
         4.617395877838135),
        ([27758, 14966], [0.5548219084739685, 3.2575531005859375,
         -0.5557040572166443, -0.25552648305892944, -0.7193335294723511,
         1.5110172033309937, -0.030708372592926025, -0.6175211668014526],
         4.763855457305908),
        ([51342, 18127], [0.5612160563468933, 2.5262813568115234,
         -0.6701016426086426, -0.5889241695404053, -0.13641169667243958,
         0.48728078603744507, -0.9663254022598267, -0.8627417087554932],
         4.538640975952148),
        ([7052, 26289], [0.5204450488090515, 0.6593767404556274,
         0.3881871700286865, 0.31046926975250244, -0.6126617789268494,
         1.6556332111358643, -0.5807003378868103, 1.764883041381836],
         5.431459426879883),
        ([38848, 1070], [1.3935399055480957, 1.1527137756347656,
         0.08703771233558655, -0.5890214443206787, -0.33230239152908325,
         0.8733053207397461, -0.08282772451639175, 1.3439857959747314],
         4.5188069343566895),
        ([60277, 12598], [1.7382545471191406, -0.4423831105232239,
         -0.032124340534210205, -1.5165483951568604, 1.4645507335662842,
         -0.6193141341209412, -0.22674807906150818, 0.3708333969116211],
         4.463666915893555),
        ([36571, 53092], [-0.18018020689487457, 1.1792373657226562,
         -0.19649738073349, -0.9000402688980103, 0.35133635997772217,
         -1.2754242420196533, -0.7094278931617737, 0.9763752818107605],
         4.125972270965576),
        ([7433, 44768], [0.39957988262176514, -0.15732571482658386,
         -0.36422836780548096, -1.0837969779968262, 1.3875163793563843,
         -0.45412999391555786, -0.3298155665397644, 2.332526683807373],
         4.411626815795898),
        ([36839, 56417], [-0.6731373071670532, -0.10610690712928772,
         0.04795563220977783, 0.08030843734741211, 0.09279145300388336,
         0.18284475803375244, -0.6249336004257202, 0.31048741936683655],
         4.433780670166016),
    ],
}


def moe_twin_config():
    """Phase 28's qwen3_moe_235b_a22b: full width, MOE_TWIN's depth and
    expert ff, float32."""
    import torch

    from repro_torch.configs import get_config

    ff = MOE_TWIN["expert_ff"]
    return dataclasses.replace(get_config("qwen3_moe_235b_a22b"),
                               num_layers=MOE_TWIN["layers"], d_ff=ff,
                               moe_d_ff=ff, compute_dtype=torch.float32)


def moe_tree_np(cfg, seed: int) -> dict:
    """Params of a moe ``cfg`` in the reference's stacked layout as numpy
    f32, drawn from ``default_rng(seed)`` in a fixed order: weights of
    variance 1/fan-in (the router and the expert stacks as the reference's
    ``moe_init`` scales them), unit norms.  They are uniform, not normal:
    the twin's 2.2G values take a third of a normal draw's host time (40 s
    on one core).  ``tools/reference/moe_serve_ref.py`` builds the
    reference's params from this same function."""
    import math

    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        a = rng.random(shape, dtype=np.float32)
        a -= np.float32(0.5)
        a *= np.float32(math.sqrt(12.0 / fan_in))
        return a

    n, d, h, kv = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, ff, e, vp = cfg.hd, cfg.expert_ff, cfg.num_experts, cfg.padded_vocab
    attn = {"wq": normal((n, d, h * hd), d),
            "wk": normal((n, d, kv * hd), d),
            "wv": normal((n, d, kv * hd), d),
            "wo": normal((n, h * hd, d), h * hd)}
    if cfg.qk_norm:
        attn["q_norm"] = np.ones((n, hd), np.float32)
        attn["k_norm"] = np.ones((n, hd), np.float32)
    return {
        "embed": {"table": normal((vp, d), d)},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "unembed": {"w": normal((d, vp), d)},
        "layers": {
            "norm1": {"scale": np.ones((n, d), np.float32)},
            "attn": attn,
            "norm2": {"scale": np.ones((n, d), np.float32)},
            "moe": {"router": normal((n, d, e), d),
                    "w_gate": normal((n, e, d, ff), d),
                    "w_up": normal((n, e, d, ff), d),
                    "w_down": normal((n, e, ff, d), ff)},
        },
    }


def moe_params_cpu():
    """Phase 28's dense params as CPU tensors."""
    from repro_torch import convert

    return convert.params_from_repro(
        moe_tree_np(moe_twin_config(), MOE_SEED), device="cpu")


def route_digest(records, batch: int, layers: int) -> list:
    """Per step (the prefill, then each decode step), per layer, per
    request: the crc32 of the int32 expert ids its tokens were routed to
    (``moe.record_routes``' entries, layers in order within a step)."""
    import zlib

    import numpy as np

    out = []
    for i in range(0, len(records), layers):
        out.append([[zlib.crc32(ids.tobytes()) for ids in
                     r["expert_ids"].numpy().astype(np.int32)
                     .reshape(batch, -1)] for r in records[i:i + layers]])
    return out


def encode_route_ids(ids) -> str:
    """Expert ids (a list of int arrays, one per moe_apply call in order:
    the prefill's layers, then each decode step's) as base64 of their
    uint8 values, in call order, row-major."""
    import base64

    import numpy as np

    flat = np.concatenate([np.asarray(e).reshape(-1) for e in ids])
    if flat.min() < 0 or flat.max() > 255:
        raise ValueError("expert ids beyond uint8")
    return base64.b64encode(flat.astype(np.uint8).tobytes()).decode()


def decode_route_ids(text: str, batch: int, prompt: int, steps: int,
                     layers: int, k: int) -> list:
    """encode_route_ids' inverse for a prefill of ``prompt`` tokens and
    ``steps`` decode steps: a list of int64 ``(T, k)`` arrays in call
    order (T = batch * prompt, then batch)."""
    import base64

    import numpy as np

    flat = np.frombuffer(base64.b64decode(text), np.uint8).astype(np.int64)
    sizes = [batch * prompt] * layers + [batch] * (layers * steps)
    if flat.size != k * sum(sizes):
        raise ValueError(f"{flat.size} route ids, expected {k * sum(sizes)}")
    cuts = np.cumsum([0] + [t * k for t in sizes])
    return [flat[a:b].reshape(-1, k) for a, b in zip(cuts[:-1], cuts[1:])]


@contextlib.contextmanager
def replay_routes(forced):
    """Within the block every ``moe_apply`` routes its tokens to the next
    of ``forced`` (``(T, k)`` expert id arrays, in call order) in place of
    its own top k; its gates are its own probabilities at those ids,
    renormalized over k.  Yields a list that gets, per call, the largest
    near-tie gap and the tokens whose own top-k set differs from the
    forced one.  The gap of a token is ``log p[its own k-th] - log
    min(p[forced ids])`` (its router logits' difference: 0 where the sets
    agree).  All of ``forced`` must be used."""
    import torch

    from repro_torch.models import moe as MOE

    own_route = MOE._route
    queue = list(forced)
    gaps: list = []

    def route(router, x, k):
        probs, _, own = own_route(router, x, k)
        if not queue:
            raise AssertionError("replay_routes: more moe_apply calls than "
                                 "forced routes")
        ids = torch.as_tensor(queue.pop(0), device=x.device)
        ids = ids.view(own.shape)
        g = probs.gather(-1, ids)
        gap = (torch.log(probs.gather(-1, own[..., -1:]))
               - torch.log(g.amin(-1, keepdim=True))).clamp_min(0)
        gaps.append((float(gap.max()), int((gap > 0).sum())))
        return probs, g / g.sum(dim=-1, keepdim=True), ids

    MOE._route = route
    try:
        yield gaps
    finally:
        MOE._route = own_route
    if queue:
        raise AssertionError(f"replay_routes: {len(queue)} forced routes "
                             "were not used")


def moe_run(cfg, params, tokens, device, prompt: int, steps: int,
            forced=None):
    """lm_run with the routes recorded: (logits, seconds, route digest, the
    pairs dropped per layer at the prefill, the expert ids per call).
    ``forced`` (expert ids per call): the run replays them
    (replay_routes) and returns its near-tie gaps as a sixth item."""
    from repro_torch.models import moe as MOE

    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(MOE.record_routes())
        gaps = (stack.enter_context(replay_routes(forced))
                if forced is not None else None)
        logits, sec = lm_run(cfg, params, tokens, device, prompt, steps)
    drops = [int((~r["keep"]).sum()) for r in rec[:cfg.num_layers]]
    out = (logits, sec, route_digest(rec, tokens.shape[0], cfg.num_layers),
           drops, [r["expert_ids"].numpy() for r in rec])
    return out if forced is None else out + (gaps,)


def moe_ref_ids(name: str, cfg) -> list:
    """The reference's expert ids for phase 28's variant ``name``
    (MOE_REF_IDS), per moe_apply call."""
    tw = MOE_TWIN
    return decode_route_ids(MOE_REF_IDS[name], tw["batch"], tw["prompt"],
                            tw["steps"], cfg.num_layers,
                            cfg.experts_per_token)


def moe_twin_cpu():
    """Phase 28's CPU twin, from the same numpy params as the card's run:
    per variant (logits, seconds, params digest, routes, drops, replay);
    replay: for a variant in MOE_REF_IDS, (logits, routes, drops, gaps)
    of a run that replays the reference's expert ids, else None."""
    tw = MOE_TWIN
    cfg0 = moe_twin_config()
    dense = moe_params_cpu()
    toks = lm_tokens(cfg0, MOE_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    out, packed, memo = {}, None, {}
    for name, kw in MOE_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pc = dense
        if cfg.gse_serve:
            packed = packed or lm_gse_params(dense, cfg)
            pc = packed
        lc, sc, routes, drops, _ = moe_run(cfg, pc, toks, "cpu",
                                           tw["prompt"], tw["steps"])
        replay = None
        if name in MOE_REF_IDS:
            lr, _, rr, dr, _, gaps = moe_run(cfg, pc, toks, "cpu",
                                             tw["prompt"], tw["steps"],
                                             moe_ref_ids(name, cfg))
            replay = (lr, rr, dr, gaps)
        out[name] = (lc, sc, tree_digest(packed_leaves(pc), memo), routes,
                     drops, replay)
    return out


def packed_leaves(tree) -> list:
    """The ``gse_serve`` segment dicts of ``tree``: the leaves the card and
    a CPU twin pack on their own.  Phase 28 digests only these; its dense
    leaves are the same numpy arrays on both sides (a copy to the card is
    exact), and digesting its 2.2G dense values took the CPU twin 28 s."""
    from repro_torch.models.modules import is_segments
    from repro_torch.tree import tree_leaves

    return [leaf for leaf in tree_leaves(tree, is_leaf=is_segments)
            if is_segments(leaf)]


def route_flips(routes, other, batch: int) -> int:
    """The (step, layer, request) route digests of ``routes`` that differ
    from ``other``'s."""
    return sum(m[b] != t[b] for ms, ts in zip(routes, other)
               for m, t in zip(ms, ts) for b in range(batch))


def check_moe_twin(phase, name, card, cpu, ref_rows, tol):
    """One variant of phase 28 (``ref_rows`` None: no reference digest).
    ``card`` = (logits, seconds, launches, params digest, routes, drops,
    replay), ``cpu`` = (logits, seconds, params digest, routes, drops,
    replay); replay = (logits, routes, drops, gaps) of a run that replays
    one source's expert ids (the reference's, or the CPU twin's where
    there is no reference) on both sides, or None.  The params must be the
    CPU twin's bit for bit.  At f32 (``tol`` None) the routes equal the
    CPU twin's and the reference's, and the logits are check_twin's.  At
    bf16 an ulp in a router input flips near ties (top-8 of 128: the
    port's attention keeps f32 where the reference rounds to bf16), and a
    flip anywhere in the prompt changes every later position, so the free
    runs' differing route digests are counted, and the replay runs carry
    the check: at every (step, request) position the card's logits are
    held to ``tol`` of the CPU twin's and of the reference's digest, and
    where a side's own top k differs from the replayed ids the gap
    (replay_routes) is at most ROUTE_GAP_TOL."""
    import torch

    lg, sg, got, digest, routes, drops, replay_g = card
    lc, sc, cpu_digest, cpu_routes, cpu_drops, replay_c = cpu
    batch = lg.shape[1]
    if digest != cpu_digest:
        raise AssertionError(f"{phase} {name}: the card's params are not the "
                             "CPU twin's bit for bit")
    if not bool(torch.isfinite(lg).all()):
        raise AssertionError(f"{phase} {name}: non-finite logits")
    ref = ref_rows or []
    ref_routes = [r[3] for r in ref]
    flips = {"cpu": route_flips(routes, cpu_routes, batch)}
    if ref:
        flips["ref"] = route_flips(routes, ref_routes, batch)
    if tol is None:
        if any(flips.values()) or drops != cpu_drops:
            raise AssertionError(f"{phase} {name}: f32 routes differ "
                                 f"(route digests differing {flips}, drops "
                                 f"{drops} against {cpu_drops})")
        if ref:
            check_twin(phase, name, (lg, sg, got, digest), (lc, sc, digest),
                       [r[:3] for r in ref])
        else:
            err = float((lg - lc).abs().max())
            log(phase, variant=name, twin_max_abs_err=err, tol=LM_TOL,
                launches=json.dumps(got), drops=json.dumps(drops))
            if err > LM_TOL or not torch.equal(lg.argmax(-1), lc.argmax(-1)):
                raise AssertionError(f"{phase} {name}: card and CPU twin "
                                     f"differ by {err} (tol {LM_TOL})")
        log(phase, variant=name, routes_equal_cpu=True,
            routes_equal_ref=bool(ref) or None, drops=json.dumps(drops))
        return
    if replay_g is None or replay_c is None:
        raise AssertionError(f"{phase} {name}: no replay run to hold bf16 to")
    lr, rr, dr, gaps_g = replay_g
    lcr, rcr, dcr, gaps_c = replay_c
    if rr != rcr or dr != dcr or (ref and rr != ref_routes):
        raise AssertionError(f"{phase} {name}: the replay runs did not "
                             "follow the replayed routes")
    if not bool(torch.isfinite(lr).all()):
        raise AssertionError(f"{phase} {name}: non-finite replay logits")
    rtol, atol = tol["rtol"], tol["atol"]
    excess = (lr - lcr).abs() - (atol + rtol * lcr.abs())
    twin_err = float((lr - lcr).abs().max())
    ref_err, ref_bad, ref_held = 0.0, 0, 0
    for x, y in zip(lm_digest(lr), ref):
        for a, b in list(zip(x["first"], y[1])) + [(x["maxabs"], y[2])]:
            ref_err = max(ref_err, abs(a - b))
            ref_bad += abs(a - b) > atol + rtol * abs(b)
        ref_held += 1
    if ref and ref_held != lr.shape[0]:
        raise AssertionError(f"{phase} {name}: {ref_held} reference steps "
                             f"for {lr.shape[0]} positions")
    gap = {"card": max(g for g, _ in gaps_g), "cpu": max(g for g, _ in gaps_c)}
    near = {"card": sum(n for _, n in gaps_g),
            "cpu": sum(n for _, n in gaps_c)}
    log(phase, variant=name, gpu_s=f"{sg:.2f}", cpu_s=f"{sc:.2f}",
        tol=f"rtol {rtol} atol {atol}", route_flips_free=json.dumps(flips),
        drops_free=json.dumps(drops), drops_free_cpu=json.dumps(cpu_drops),
        twin_max_abs_err_free=float((lg - lc).abs().max()),
        replayed="reference" if ref else "cpu twin",
        positions_held=int(lr.shape[0] * batch),
        replay_twin_max_abs_err=twin_err,
        replay_ref_max_abs_err=ref_err if ref else None,
        replay_ref_steps=ref_held if ref else None,
        replay_tokens_flipped_own_topk=json.dumps(near),
        replay_max_route_gap=json.dumps(gap), gap_tol=ROUTE_GAP_TOL,
        replay_tokens_equal_cpu=bool(torch.equal(lr.argmax(-1),
                                                 lcr.argmax(-1))),
        replay_drops=json.dumps(dr), launches=json.dumps(got))
    if max(gap.values()) > ROUTE_GAP_TOL:
        raise AssertionError(f"{phase} {name}: a replayed route is no near "
                             f"tie (router logit gap {gap}, tol "
                             f"{ROUTE_GAP_TOL})")
    if bool((excess > 0).any()) or ref_bad:
        raise AssertionError(f"{phase} {name}: replay logits beyond {tol} "
                             f"(twin {twin_err}, reference {ref_err}, "
                             f"{ref_bad} reference values)")


def moe_smoke_twin(dev):
    """Phase 28, grok1_314b: its smoke config (f32 and bf16, one variant
    with forced drops) on the card against the CPU from the same params:
    routes and drops equal at f32, logits within LM_TOL; at bf16 both
    sides replay the CPU's free run's expert ids and are held to BF16_TOL
    at every position (check_moe_twin)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    cfg0 = get_config("grok1_314b", smoke=True)
    params = T.init_params(cfg0, torch.Generator().manual_seed(MOE_SEED),
                           device="cpu")
    toks = lm_tokens(cfg0, MOE_SEED + 3, 2, 24 + 8)
    pg = tree_map(lambda t: t.to(dev), params)
    for name, kw in (("dense", {}), ("drops", dict(capacity_factor=0.25)),
                     ("bf16", dict(compute_dtype="bfloat16"))):
        cfg = lm_variant(cfg0, kw)
        lg, sg, rg, dg, _ = moe_run(cfg, pg, toks, dev, 24, 8)
        lc, sc, rc, dc, ids = moe_run(cfg, params, toks, "cpu", 24, 8)
        replay_g = replay_c = None
        if name == "bf16":
            replay_g, replay_c = (
                (r[0], r[2], r[3], r[5]) for r in
                (moe_run(cfg, pg, toks, dev, 24, 8, ids),
                 moe_run(cfg, params, toks, "cpu", 24, 8, ids)))
        check_moe_twin("moe_twin_grok1_smoke", name,
                       (lg, sg, {}, [], rg, dg, replay_g),
                       (lc, sc, [], rc, dc, replay_c), None,
                       BF16_TOL if name == "bf16" else None)
        if name == "drops" and min(dg) <= 0:
            raise AssertionError(f"grok1 smoke: no pair dropped ({dg})")


def phase_moe_twin(twins=None, params=None):
    """Phase 28: qwen3_moe_235b_a22b at full width (two layers, expert ff
    256) on the card and as its CPU twin from the same numpy params
    (``params``: a future of moe_params_cpu), against each other and
    against the reference's digest (MOE_REF): dense and gse_serve tag 2
    with forced drops at f32, gse_serve tag 2 at bf16 (held through a run
    that replays the reference's expert ids: check_moe_twin); then grok1's
    smoke config against its CPU twin.  Returns the launches per kernel
    body of the f32 variants and (key "bf16") of the bf16 one, counted
    over the runs that route on their own."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    tw = MOE_TWIN
    cfg0 = moe_twin_config()
    t0 = time.perf_counter()
    dense_cpu = params.result() if params is not None else moe_params_cpu()
    dense_gpu = tree_map(lambda t: t.to(dev), dense_cpu)
    del dense_cpu
    toks = lm_tokens(cfg0, MOE_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    log("moe_twin", arch=cfg0.name, layers=tw["layers"],
        d_model=cfg0.d_model, heads=cfg0.num_heads,
        kv_heads=cfg0.num_kv_heads, hd=cfg0.hd, experts=cfg0.num_experts,
        top_k=cfg0.experts_per_token, expert_ff=cfg0.expert_ff,
        vocab=cfg0.vocab_size, batch=tw["batch"], prompt=tw["prompt"],
        steps=tw["steps"], params_s=f"{time.perf_counter() - t0:.2f}")
    card, packed = {}, None
    for name, kw in MOE_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pg = dense_gpu
        if cfg.gse_serve:
            packed = packed or lm_gse_params(dense_gpu, cfg)
            pg = packed
        torch.cuda.synchronize()
        for mod in (E, F):
            mod.reset_launch_counts()
        lg, sg, routes, drops, _ = moe_run(cfg, pg, toks, dev,
                                           tw["prompt"], tw["steps"])
        got = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
               .items()}
        got.update({"f_" + k: v for k, v in
                    F.flash_attention_gqa.body_launches.items()})
        replay = None
        if name in MOE_REF_IDS:
            lr, _, rr, dr, _, gaps = moe_run(cfg, pg, toks, dev,
                                             tw["prompt"], tw["steps"],
                                             moe_ref_ids(name, cfg))
            replay = (lr, rr, dr, gaps)
        card[name] = (lg, sg, got, tree_digest(packed_leaves(pg)), routes,
                      drops, replay)
    del dense_gpu, packed
    cpu = twin_of(twins, "moe")
    counts = {}
    for name, kw in MOE_TWIN_VARIANTS.items():
        bf16 = lm_variant(cfg0, kw).compute_dtype == torch.bfloat16
        check_moe_twin("moe_twin", name, card[name], cpu[name],
                       MOE_REF.get(name), BF16_TOL if bf16 else None)
        if bf16:
            counts["bf16"] = card[name][2]
            continue
        for k, v in card[name][2].items():
            counts[k] = counts.get(k, 0) + v
    drops = card["tag2_drops"][5]
    if min(drops) <= 0 or min(a - b for a, b in
                              zip(drops, card["dense"][5])) <= 0:
        raise AssertionError(f"moe_twin tag2_drops: capacity factor 0.5 "
                             f"dropped no more pairs than the default "
                             f"({drops} against {card['dense'][5]})")
    log("moe_twin", launches_f32=json.dumps(
        {k: v for k, v in counts.items() if k != "bf16"}),
        launches_bf16=json.dumps(counts["bf16"]))
    if min(counts[k] for k in ("e_gemv", "e_tiled", "f_ffma")) <= 0:
        raise AssertionError(f"a kernel body of the f32 moe twin never "
                             f"launched: {counts}")
    if min(counts["bf16"][k] for k in ("e_gemv", "e_tiled", "f_mma")) <= 0:
        raise AssertionError(f"a kernel body of the bf16 moe twin never "
                             f"launched: {counts['bf16']}")
    moe_smoke_twin(dev)
    return counts


def phase_moe_kernels():
    """Phase 28, part 2: F at the moe attention shapes (MOE_FLASH, bf16 on
    the tensor-core body) against its plain version; returns the inputs
    for phase 10."""
    import torch

    from repro_torch.kernels import flash_attn as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    ctx = {"err": {}, "qkv": {}}
    for arch, b, s, h, kv, hd in MOE_FLASH:
        dt = torch.bfloat16
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
        got = F.flash_attention_gqa(q, k, v, causal=True)
        want = F.flash_attention_gqa_plain(q, k, v, causal=True)
        diff = (got.float() - want.float()).abs()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        ctx["err"][arch] = float(diff.max())
        ctx["qkv"][arch] = (q, k, v)
        log("moe_kernels", kernel="flash_attention_gqa", arch=arch,
            body=F.flash_body(dt, hd), b=b, s=s, heads=h, kv_heads=kv,
            hd=hd, dtype="bfloat16", max_abs_err=float(diff.max()),
            tol="rtol 0.02 atol 0.02")
        del got, want, diff
    return ctx


def serve_cli_archs(archs):
    """``repro_torch.launch.serve`` on ``archs`` (smoke configs) at
    --gse-tag 2 on the card, counted, against the CPU's tokens: kernel D
    decodes the quantized tree (the 4-D expert stacks included)."""
    import torch

    from repro_torch.kernels import gse_decode as D
    from repro_torch.launch import serve

    out = {}
    for arch in archs:
        torch.cuda.synchronize()
        D.reset_launch_counts()
        quiet = lambda msg: None  # noqa: E731
        t0 = time.perf_counter()
        args = serve.parser().parse_args(["--arch", arch, "--gse-tag", "2"])
        tokens = serve_main_quiet(serve, args, quiet)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = D.gse_decode_dense.launches
        args = serve.parser().parse_args(["--arch", arch, "--gse-tag", "2",
                                          "--device", "cpu"])
        tokens_cpu = serve_main_quiet(serve, args, quiet)
        log("serve_cli", arch=arch, gse_tag=2, wall_s=f"{wall:.2f}",
            d_launches=launches, tokens_equal_cpu=tokens == tokens_cpu)
        if launches <= 0:
            raise AssertionError(f"serve CLI {arch}: kernel D never "
                                 "launched")
        if tokens != tokens_cpu:
            raise AssertionError(f"serve CLI {arch}: the card's tokens are "
                                 f"not the CPU's: {tokens} {tokens_cpu}")
        out[arch] = launches
    return out


def serve_main_quiet(serve, args, log_fn):
    """``serve.main``'s path for parsed ``args`` with its log lines
    dropped: the served tokens."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device=args.device)
    if args.gse_tag:
        params = serve.gse_params(params, args.gse_tag, log_fn)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)
                            ).to(args.device)
    return serve.serve(cfg, params, prompts, args.gen, log_fn)


def serve_full(cfg, fu, seed, phase, need):
    """Phases 29 and 31: ``cfg`` initialized on the card with
    ``T.init_params``, a prompt of ``fu["prompt"]`` tokens through
    ``make_prefill_step(state=)``, then ``fu["steps"]`` greedy decode
    steps, counted; logs the times, the peak memory and (moe) the pairs
    dropped per layer at the prefill.  ``need``: launch counts that must
    be positive.  Returns the counts."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.kernels import wkv6 as K
    from repro_torch.models import moe as MOE
    from repro_torch.models import stepfns, transformer as T
    from repro_torch.quant import gse_tensor as Q

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the earlier phases' tensors
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - held
    nbytes = Q.tree_bytes(params, cfg.gse_tag)
    toks = torch.from_numpy(lm_tokens(cfg, seed + 2, fu["batch"],
                                      fu["prompt"])).to(dev)
    state = T.decode_state_init(cfg, fu["batch"], fu["prompt"] + fu["steps"],
                                device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (E, F, K):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    with MOE.record_routes() as rec:
        logits = stepfns.make_prefill_step(cfg)(params, toks, state=state)
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    drops = [int((~r["keep"]).sum()) for r in rec]
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(fu["steps"]):
        logits, state = T.decode_step(cfg, params, state, tok,
                                      fu["prompt"] + i)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
              .items()}
    counts.update({"f_" + k: v for k, v in
                   F.flash_attention_gqa.body_launches.items()})
    counts["wkv6"] = K.wkv6.launches
    step_ms = decode_s * 1e3 / fu["steps"]
    log(phase, arch=cfg.name, layers=cfg.num_layers, gse_tag=cfg.gse_tag,
        dtype=str(cfg.compute_dtype), batch=fu["batch"], prompt=fu["prompt"],
        steps=fu["steps"], init_s=f"{init_s:.2f}",
        prefill_s=f"{prefill_s:.3f}",
        prefill_tok_per_s=f"{fu['batch'] * fu['prompt'] / prefill_s:.0f}",
        ms_per_decode_step=f"{step_ms:.3f}",
        decode_tok_per_s=f"{fu['batch'] * 1e3 / step_ms:.1f}",
        tree_bytes=nbytes, init_peak_gb=f"{init_peak / 1e9:.2f}",
        serve_peak_gb=f"{(torch.cuda.max_memory_allocated() - held) / 1e9:.2f}",
        prefill_drops_per_layer=json.dumps(drops) if rec else None,
        launches=json.dumps(counts))
    log(phase, arch=cfg.name, tokens=json.dumps(torch.stack(out, 1).tolist()))
    if not bool(finite):
        raise AssertionError(f"{phase} {cfg.name}: non-finite logits")
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"{phase} {cfg.name}: a kernel of the serving "
                             f"path never launched: {counts}")
    del params, state, logits
    torch.cuda.empty_cache()
    return counts


def phase_moe_full():
    """Phase 29: qwen3_moe_235b_a22b (6 layers) and grok1_314b (2 layers)
    at full width under gse_serve tag 2 at bf16 (MOE_FULL), one after the
    other; then the expert products of one decode step of qwen3_moe
    timed against the bytes they read.  Returns the launches of each."""
    from repro_torch.configs import get_config

    out = {}
    for arch, fu in MOE_FULL.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=fu["layers"],
                                  gse_serve=True, gse_tag=2)
        out[arch] = serve_full(cfg, fu, MOE_SEED, "moe_full",
                               ("e_gemv", "e_tiled", "f_mma"))
    return out


def expert_decode_timing():
    """Phase 29, part 2: one decode step's expert products of a
    qwen3_moe_235b_a22b layer (4 requests: 128 experts x 8 slots, every
    expert's weights read, the reference computes all E x cap rows):
    ``moe._expert_ffn`` on f32 stacks (the casts to bf16 included) and on
    stacks already in bf16, against the bytes each must move."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE

    dev = torch.device("cuda")
    cfg = get_config("qwen3_moe_235b_a22b")
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.expert_ff
    cap = MOE._capacity(cfg, MOE_FULL[cfg.name]["batch"])
    gen = torch.Generator(device=dev).manual_seed(29)
    p = {name: torch.randn(shape, generator=gen, device=dev)
         for name, shape in (("w_gate", (e, d, ff)), ("w_up", (e, d, ff)),
                             ("w_down", (e, ff, d)))}
    pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
    xe = torch.randn((e, cap, d), generator=gen, device=dev).to(
        torch.bfloat16)
    w = 3 * e * d * ff
    f32_ms = cuda_ms(lambda: MOE._expert_ffn(p, xe, torch.bfloat16), reps=3)
    bf16_ms = cuda_ms(lambda: MOE._expert_ffn(pb, xe, torch.bfloat16),
                      reps=5)
    # f32 stacks: each weight read in f32, written and read again in bf16.
    f32_bytes, bf16_bytes = w * (4 + 2 + 2), w * 2
    out = dict(experts=e, cap=cap, d=d, ff=ff, f32_stacks_ms=f32_ms,
               f32_stacks_bytes=f32_bytes,
               f32_stacks_bound_ms=f32_bytes / HBM_BYTES_PER_S * 1e3,
               bf16_stacks_ms=bf16_ms, bf16_stacks_bytes=bf16_bytes,
               bf16_stacks_bound_ms=bf16_bytes / HBM_BYTES_PER_S * 1e3)
    log("moe_expert_decode", **{k: (f"{v:.4f}" if isinstance(v, float)
                                    else v) for k, v in out.items()})
    del p, pb, xe
    torch.cuda.empty_cache()
    return out


def rwkv_twin_config():
    """Phase 30's rwkv6_1p6b: full width, RWKV_TWIN's depth, float32."""
    import torch

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("rwkv6_1p6b"),
                               num_layers=RWKV_TWIN["layers"],
                               compute_dtype=torch.float32)


def rwkv_tree_np(cfg, seed: int) -> dict:
    """Params of an ssm ``cfg`` in the reference's stacked layout as numpy
    f32, drawn from ``default_rng(seed)`` in a fixed order: normal weights
    scaled as the reference's ``rwkv_time_init``/``rwkv_channel_init``
    scale them, ``w_base`` uniform in [-2, 0), the mixes 0.5, unit norms.
    ``tools/reference/rwkv_serve_ref.py`` builds the reference's params
    from this same function."""
    import math

    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        return a

    n, d, ff, vp = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hn = cfg.rwkv_head_dim
    half = np.full((n, d), 0.5, np.float32)
    time_mix = {"mix_r": half, "mix_k": half.copy(), "mix_v": half.copy(),
                "mix_w": half.copy()}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        time_mix[name] = normal((n, d, d), 1 / math.sqrt(d))
    time_mix["w_base"] = rng.uniform(-2.0, 0.0, size=(n, d)).astype(
        np.float32)
    time_mix["w_lora_a"] = normal((n, d, 64), 1 / math.sqrt(d))
    time_mix["w_lora_b"] = normal((n, 64, d), 1 / 8.0)
    time_mix["bonus_u"] = normal((n, d // hn, hn), 0.1)
    return {
        "embed": {"table": normal((vp, d), 1 / math.sqrt(d))},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "unembed": {"w": normal((d, vp), 1 / math.sqrt(d))},
        "layers": {
            "norm1": {"scale": np.ones((n, d), np.float32)},
            "time": time_mix,
            "norm2": {"scale": np.ones((n, d), np.float32)},
            "chan": {"mix_k": np.full((n, d), 0.5, np.float32),
                     "wk": normal((n, d, ff), 1 / math.sqrt(d)),
                     "wv": normal((n, ff, d), 1 / math.sqrt(ff)),
                     "wr": normal((n, d, d), 1 / math.sqrt(d))},
        },
    }


def rwkv_gse_params(params, cfg):
    """``params`` with the unembedding packed into ``gse_serve`` segments
    (the RWKV weights stay dense, as the reference's init draws them)."""
    from repro_torch.models.modules import pack_linear_weight
    from repro_torch.tree import tree_map

    out = tree_map(lambda t: t, params)
    out["unembed"]["w"] = pack_linear_weight(params["unembed"]["w"], cfg)
    return out


def rwkv_params_cpu():
    """Phase 30's dense params as CPU tensors."""
    from repro_torch import convert

    return convert.params_from_repro(
        rwkv_tree_np(rwkv_twin_config(), RWKV_SEED), device="cpu")


def rwkv_twin_cpu():
    """Phase 30's CPU twin: per variant the logits, the seconds and the
    params digest."""
    tw = RWKV_TWIN
    cfg0 = rwkv_twin_config()
    dense = rwkv_params_cpu()
    toks = lm_tokens(cfg0, RWKV_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    out, packed, memo = {}, None, {}
    for name, kw in RWKV_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pc = dense
        if cfg.gse_serve:
            packed = packed or rwkv_gse_params(dense, cfg)
            pc = packed
        lc, sc = lm_run(cfg, pc, toks, "cpu", tw["prompt"], tw["steps"])
        out[name] = (lc, sc, tree_digest(pc, memo))
    return out


def wkv_inputs(shape, seed, nonzero, dev):
    """wkv6's inputs at ``shape`` (B, S, H, N) on ``dev``: r, k, v normal,
    w uniform in [0.3, 1), u 0.1-normal, s0 normal or zero."""
    import torch

    b, s, h, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    w = 0.3 + 0.7 * torch.rand(shape, generator=gen, device=dev)
    u = 0.1 * torch.randn((h, n), generator=gen, device=dev)
    s0 = torch.randn((b, h, n, n), generator=gen, device=dev)
    return r, k, v, w, u, s0 if nonzero else torch.zeros_like(s0)


def phase_rwkv_kernels():
    """Phase 30, part 1: wkv6 bitwise its plain version on the card at
    WKV_SHAPES, from a zero and a non-zero state; returns the full
    shape's inputs and the plain version's seconds for phase 10."""
    import torch

    from repro_torch.kernels import wkv6 as K

    dev = torch.device("cuda")
    ctx = {}
    for shape in WKV_SHAPES:
        for nonzero in (False, True):
            args = wkv_inputs(shape, 30 + nonzero, nonzero, dev)
            out, st = K.wkv6(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            po, ps = K.wkv6_plain(*args)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            require_bitwise(f"wkv6 {shape} out against its plain version",
                            out, po)
            require_bitwise(f"wkv6 {shape} state against its plain version",
                            st, ps)
            log("rwkv_kernels", kernel="wkv6", shape=list(shape),
                nonzero_state=nonzero, bitwise_plain=True, max_abs_err=0.0,
                plain_s=f"{plain_s:.2f}",
                fused_addcmul=K._BOUND.get(("addcmul", "cuda")))
            if shape == WKV_SHAPES[0] and nonzero:
                ctx["args"], ctx["plain_s"] = args, plain_s
            del out, st, po, ps
    return ctx


def phase_rwkv_twin(twins=None, params=None):
    """Phase 30, part 2: rwkv6_1p6b at full width, three layers, on the
    card and as its CPU twin from the same numpy params (``params``: a
    future of rwkv_params_cpu), against each other and the reference's
    digest (RWKV_REF): dense and gse_serve tag 2 at f32, gse_serve tag 2
    at bf16.  Returns the launches."""
    import torch

    from repro_torch.kernels import gse_matmul as E
    from repro_torch.kernels import wkv6 as K
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    tw = RWKV_TWIN
    cfg0 = rwkv_twin_config()
    t0 = time.perf_counter()
    dense_cpu = params.result() if params is not None else \
        rwkv_params_cpu()
    dense_gpu = tree_map(lambda t: t.to(dev), dense_cpu)
    del dense_cpu
    toks = lm_tokens(cfg0, RWKV_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    log("rwkv_twin", layers=tw["layers"], d_model=cfg0.d_model,
        d_ff=cfg0.d_ff, heads=cfg0.d_model // cfg0.rwkv_head_dim,
        head_dim=cfg0.rwkv_head_dim, vocab=cfg0.vocab_size,
        batch=tw["batch"], prompt=tw["prompt"], steps=tw["steps"],
        params_s=f"{time.perf_counter() - t0:.2f}")
    card, packed = {}, None
    for name, kw in RWKV_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pg = dense_gpu
        if cfg.gse_serve:
            packed = packed or rwkv_gse_params(dense_gpu, cfg)
            pg = packed
        torch.cuda.synchronize()
        for mod in (E, K):
            mod.reset_launch_counts()
        lg, sg = lm_run(cfg, pg, toks, dev, tw["prompt"], tw["steps"])
        got = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
               .items()}
        got["wkv6"] = K.wkv6.launches
        card[name] = (lg, sg, got, tree_digest(pg))
    del dense_gpu, packed
    cpu = twin_of(twins, "rwkv")
    counts = {}
    for name in RWKV_TWIN_VARIANTS:
        check_twin("rwkv_twin", name, card[name], cpu[name], RWKV_REF[name])
        for k, v in card[name][2].items():
            counts[k] = counts.get(k, 0) + v
    log("rwkv_twin", launches=json.dumps(counts))
    if min(counts[k] for k in ("e_gemv", "wkv6")) <= 0:
        raise AssertionError(f"a kernel of the rwkv twin never launched: "
                             f"{counts}")
    return counts


def phase_rwkv_full():
    """Phase 31: rwkv6_1p6b whole (24 layers) under gse_serve tag 2 at
    bf16, a 2048-token prompt, 32 steps."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("rwkv6_1p6b"), gse_serve=True,
                              gse_tag=2)
    # Only the unembedding is packed, and the prefill multiplies its last
    # position only: E runs its GEMV, never the tiled body.
    return serve_full(cfg, RWKV_FULL, RWKV_SEED, "rwkv_full",
                      ("e_gemv", "wkv6"))


def moe_rwkv_entries(moe_ctx, moe_counts, rwkv_ctx, rwkv_counts, add_entry):
    """Phase 10's rows for F at the moe attention shapes (launches from
    phase 29's run of that arch) and for wkv6 (launches from phase 31)."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import wkv6 as K

    flash_src = "src/repro_torch/kernels/csrc/flash_attn.cu"
    for arch, b, s, h, kv, hd in MOE_FLASH:
        q, k, v = moe_ctx["qkv"][arch]
        g = h // kv
        ql, kl, vl = (q.transpose(1, 2).contiguous(),
                      k.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous(),
                      v.repeat_interleave(g, dim=2).transpose(1, 2)
                      .contiguous())
        flops = 4 * b * h * s * s * hd / 2
        add_entry(f"flash_attention_gqa.bfloat16.causal.{arch}",
                  flash_src, "src/repro/kernels/flash_attn.py:76",
                  lambda: F.flash_attention_gqa(q, k, v, causal=True),
                  lambda: F.flash_attention_gqa_plain(q, k, v, causal=True),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      ql, kl, vl, is_causal=True),
                  (q.numel() * 2 + k.numel() * 2) * q.element_size(),
                  flops / BF16_TC_OPS_PER_S * 1e3,
                  plain_reps=2, reps=5, inner=3, shape=[b, s, h, kv, hd],
                  body=F.flash_body(q.dtype, hd),
                  fp32_bound_ms=flops / FP32_OPS_PER_S * 1e3,
                  launches=moe_counts[arch]["f_mma"],
                  launches_from="phase 29", max_abs_err=moe_ctx["err"][arch])
        del ql, kl, vl
    r, k, v, w, u, s0 = rwkv_ctx["args"]
    bsz, s, h, n = r.shape
    nbytes = 4 * (5 * r.numel() + 2 * s0.numel() + u.numel())
    add_entry("wkv6", "src/repro_torch/kernels/csrc/wkv6.cu",
              "src/repro/models/rwkv.py:150 (lax.scan, no Pallas kernel)",
              lambda: K.wkv6(r, k, v, w, u, s0), None, None, nbytes,
              7 * bsz * s * h * n * n / FP32_OPS_PER_S * 1e3,
              reps=5, inner=2, shape=[bsz, s, h, n],
              plain_ms=rwkv_ctx["plain_s"] * 1e3,
              plain_from="phase 30 (one synchronized call, host clock)",
              launches=rwkv_counts["wkv6"], launches_from="phase 31",
              max_abs_err=0.0)


# --- the encdec and vlm families (phases 32-33) ---------------------------

# Phase 32: seamless_m4t_large_v2 at full width (d 1024, 16 heads of 64,
# ff 8192, GELU, vocab 256206) cut to 2 encoder and 2 decoder layers, two
# requests of 128 frames and a 64-token prompt, 16 teacher-forced decode
# steps; internvl2_2b at full width (d 2048, H 16 / KV 8, hd 128, ff 8192,
# vocab 92553) cut to 2 layers, two requests of 256 patches and 64 text
# tokens, 16 steps.  Frames and patches are standard normal, as the
# reference's data pipeline draws them.
ENCDEC_SEED = 0
ENCDEC_TWIN = dict(batch=2, frames=128, prompt=64, steps=16, layers=2)
VLM_SEED = 0
VLM_TWIN = dict(batch=2, patches=256, prompt=64, steps=16, layers=2)
# Phase 32's variants of both twins, by ENCDEC_REF / VLM_REF key.
EV_TWIN_VARIANTS = {"dense": {}, "tag2": dict(gse_serve=True, gse_tag=2),
                    "tag2_bf16": dict(gse_serve=True, gse_tag=2,
                                      compute_dtype="bfloat16")}
# Phase 33: both models whole, gse_serve tag 2 at bf16; seamless at the
# reference's 50/50 split of a 1024-position prefill budget
# (repro/launch/shapes.py:56-58), internvl2 with its 256 patches.
ENCDEC_FULL = dict(batch=4, frames=512, prompt=512, steps=32)
VLM_FULL = dict(batch=4, patches=256, prompt=256, steps=32)
# F's non-causal cases: (label, B, S, T, H, KV, hd): seamless's encoder
# (S = T), its cross-attention at the full cell (64 decoder queries of
# the twin's prompt over 512 frames) and a ragged S != T.
EV_FLASH = (("encoder", 4, 512, 512, 16, 16, 64),
            ("cross", 4, 64, 512, 16, 16, 64),
            ("ragged", 2, 77, 300, 16, 16, 64))
# tools/reference/encdec_serve_ref.py's and vlm_serve_ref.py's output
# (JAX 0.9.0 on the CPU): per variant, per step (the prompt's last
# position, then the decode steps), lm_digest's fields as (tokens, first
# 8 logits of request 0, max |logit|).
ENCDEC_REF = {
    "dense": [
        ([145145, 57435],
         [-0.2303829789161682, -0.5649142861366272, 0.4069576561450958,
          0.05807274580001831, 0.19695451855659485, 0.5187386870384216,
          1.5450007915496826, -0.7679505348205566],
         4.674875259399414),
        ([57435, 87773],
         [-0.543327808380127, -0.9649472236633301, 0.41138944029808044,
          -0.061871886253356934, 0.38044387102127075, 0.4866302013397217,
          1.6246554851531982, -0.5280464291572571],
         4.659073352813721),
        ([57435, 57435],
         [0.23170748353004456, -0.6796976923942566, 0.292117178440094,
          -0.2261430025100708, 0.28216999769210815, 0.557375431060791,
          1.3380074501037598, -1.107369303703308],
         4.817905902862549),
        ([145145, 57435],
         [-0.46152976155281067, -0.7008187770843506, 0.4138888716697693,
          -0.030931532382965088, 0.42705145478248596, 0.6366924047470093,
          1.5748114585876465, -0.8499006628990173],
         4.841366767883301),
        ([63344, 197486],
         [0.11260759830474854, -0.5926237106323242, 0.5939528942108154,
          0.11184117197990417, 0.23323510587215424, 0.25305241346359253,
          1.5160083770751953, -0.8010305762290955],
         4.720278739929199),
        ([63344, 57435],
         [-0.2062060534954071, -0.5464729070663452, 0.4980258047580719,
          -0.3869333863258362, 0.4027012884616852, 0.3309415578842163,
          1.6683361530303955, -0.8686895370483398],
         4.717931747436523),
        ([63344, 57435],
         [-0.033292949199676514, -0.657836377620697, 0.3767364025115967,
          -0.0990174412727356, 0.2342003881931305, 0.6849785447120667,
          1.3018888235092163, -0.751635730266571],
         4.808943748474121),
        ([63344, 197486],
         [-0.3107469975948334, -0.5425944924354553, 0.37298983335494995,
          -0.06744551658630371, 0.5291147232055664, 0.6813672184944153,
          1.5500080585479736, -0.7351117730140686],
         4.558588027954102),
        ([145145, 57435],
         [0.055866748094558716, -0.5636581182479858, 0.2151632010936737,
          -0.2795500159263611, 0.4297742545604706, 0.9387980699539185,
          1.6892836093902588, -0.4517762362957001],
         4.896973609924316),
        ([145145, 57435],
         [-0.1709168553352356, -0.6511212587356567, 0.3958488404750824,
          -0.16623157262802124, 0.38467496633529663, 0.405886709690094,
          1.3167872428894043, -0.7293776273727417],
         4.911936283111572),
        ([145145, 57435],
         [-0.14690521359443665, -0.45629560947418213, 0.24973705410957336,
          -0.16810500621795654, 0.24498561024665833, 0.7463778853416443,
          1.60627019405365, -0.9676947593688965],
         4.767870903015137),
        ([87213, 57435],
         [-0.6007128953933716, -0.8283066153526306, 0.21689200401306152,
          -0.15588945150375366, 0.1666789948940277, 0.3691880702972412,
          1.416177749633789, -0.8026508092880249],
         4.664279937744141),
        ([145145, 57435],
         [-0.4115179777145386, -0.8898230195045471, 0.1377716362476349,
          -0.34543561935424805, 0.19154690206050873, 0.6622738838195801,
          1.4867165088653564, -0.6537685394287109],
         4.912820816040039),
        ([63344, 87773],
         [-0.09812116622924805, -0.8666033148765564, 0.1422586739063263,
          -0.10005098581314087, 0.45724841952323914, 0.3671809434890747,
          1.5990444421768188, -0.5088608264923096],
         4.979177951812744),
        ([145145, 57435],
         [-0.28023257851600647, -0.40697187185287476, 0.3026825785636902,
          -0.11123061180114746, 0.4805009365081787, 0.5702435970306396,
          1.5305602550506592, -0.6439251899719238],
         4.759711265563965),
        ([57435, 57435],
         [-0.3778785467147827, -0.6936790943145752, 0.20646679401397705,
          -0.14059430360794067, 0.3074870705604553, 0.46007251739501953,
          1.5373409986495972, -0.8100203275680542],
         4.725212097167969),
        ([141092, 57435],
         [-0.2354840338230133, -0.6935240030288696, 0.30315476655960083,
          -0.28485602140426636, 0.4203277826309204, 0.7179087400436401,
          1.7435529232025146, -0.6580289602279663],
         4.902503490447998),
    ],
    "tag2": [
        ([145145, 57435],
         [-0.23038333654403687, -0.5649136900901794, 0.4069574475288391,
          0.05807363986968994, 0.19695493578910828, 0.5187381505966187,
          1.5450012683868408, -0.7679502964019775],
         4.674874782562256),
        ([57435, 87773],
         [-0.5433292388916016, -0.964945912361145, 0.41138914227485657,
          -0.06187206506729126, 0.38044288754463196, 0.48662930727005005,
          1.6246554851531982, -0.5280470848083496],
         4.659071445465088),
        ([57435, 57435],
         [0.23170778155326843, -0.6796972155570984, 0.29211804270744324,
          -0.22614246606826782, 0.28217074275016785, 0.5573768615722656,
          1.3380086421966553, -1.1073683500289917],
         4.817905426025391),
        ([145145, 57435],
         [-0.46152999997138977, -0.700817346572876, 0.4138883054256439,
          -0.030931830406188965, 0.4270510673522949, 0.6366921663284302,
          1.5748112201690674, -0.8499018549919128],
         4.841365814208984),
        ([63344, 197486],
         [0.11260759830474854, -0.5926231145858765, 0.5939524173736572,
          0.11184164881706238, 0.23323488235473633, 0.2530519366264343,
          1.5160086154937744, -0.801031231880188],
         4.720277309417725),
        ([63344, 57435],
         [-0.20620569586753845, -0.5464726090431213, 0.4980263113975525,
          -0.3869338035583496, 0.40270066261291504, 0.3309412896633148,
          1.6683356761932373, -0.8686888217926025],
         4.717931747436523),
        ([63344, 57435],
         [-0.0332925021648407, -0.6578366160392761, 0.3767358660697937,
          -0.09901678562164307, 0.2342015504837036, 0.6849790811538696,
          1.3018895387649536, -0.7516354918479919],
         4.808941841125488),
        ([63344, 197486],
         [-0.310746967792511, -0.5425940752029419, 0.3729904890060425,
          -0.06744557619094849, 0.5291150808334351, 0.681366503238678,
          1.5500081777572632, -0.7351119518280029],
         4.558587551116943),
        ([145145, 57435],
         [0.0558658242225647, -0.5636583566665649, 0.21516478061676025,
          -0.2795493006706238, 0.4297749698162079, 0.9387984275817871,
          1.6892837285995483, -0.4517763555049896],
         4.896975517272949),
        ([145145, 57435],
         [-0.17091643810272217, -0.6511217355728149, 0.3958497941493988,
          -0.16623073816299438, 0.38467520475387573, 0.40588679909706116,
          1.3167872428894043, -0.729377031326294],
         4.911935806274414),
        ([145145, 57435],
         [-0.14690497517585754, -0.4562954902648926, 0.2497374713420868,
          -0.16810452938079834, 0.2449844777584076, 0.7463768720626831,
          1.606269121170044, -0.9676949977874756],
         4.767871856689453),
        ([87213, 57435],
         [-0.6007116436958313, -0.8283059000968933, 0.21689167618751526,
          -0.155889630317688, 0.16667932271957397, 0.36918753385543823,
          1.4161789417266846, -0.8026511669158936],
         4.664280891418457),
        ([145145, 57435],
         [-0.4115186333656311, -0.8898226022720337, 0.13777151703834534,
          -0.34543511271476746, 0.19154757261276245, 0.6622748374938965,
          1.4867162704467773, -0.6537679433822632],
         4.912819862365723),
        ([63344, 87773],
         [-0.0981208086013794, -0.8666036128997803, 0.14225837588310242,
          -0.10005027055740356, 0.45724910497665405, 0.36718136072158813,
          1.5990445613861084, -0.50886070728302],
         4.979178428649902),
        ([145145, 57435],
         [-0.2802315354347229, -0.4069725275039673, 0.30268192291259766,
          -0.11123001575469971, 0.48050159215927124, 0.5702430605888367,
          1.5305612087249756, -0.6439247727394104],
         4.759711265563965),
        ([57435, 57435],
         [-0.37787824869155884, -0.693679928779602, 0.20646759867668152,
          -0.14059418439865112, 0.30748674273490906, 0.4600719213485718,
          1.5373420715332031, -0.810019850730896],
         4.725212574005127),
        ([141092, 57435],
         [-0.2354845106601715, -0.6935247778892517, 0.30315476655960083,
          -0.2848552465438843, 0.42032793164253235, 0.7179100513458252,
          1.7435520887374878, -0.6580294370651245],
         4.90250301361084),
    ],
    "tag2_bf16": [
        ([145145, 57435],
         [-0.22692999243736267, -0.5650274157524109, 0.4078206717967987,
          0.07063433527946472, 0.1959918588399887, 0.5206574201583862,
          1.5396292209625244, -0.7689437866210938],
         4.686429023742676),
        ([57435, 87773],
         [-0.5385918617248535, -0.96000736951828, 0.4088243246078491,
          -0.05078546702861786, 0.3810674250125885, 0.4915143847465515,
          1.6188688278198242, -0.5239042043685913],
         4.6579084396362305),
        ([57435, 57435],
         [0.23884251713752747, -0.6822072267532349, 0.3011292517185211,
          -0.2146514505147934, 0.283311128616333, 0.5657856464385986,
          1.3313825130462646, -1.109519362449646],
         4.806922912597656),
        ([145145, 57435],
         [-0.4492604732513428, -0.697832465171814, 0.41589927673339844,
          -0.02712780050933361, 0.4399395287036896, 0.6245522499084473,
          1.5622950792312622, -0.8474226593971252],
         4.849029064178467),
        ([63344, 197486],
         [0.12114132940769196, -0.5929242372512817, 0.6059461236000061,
          0.11273252964019775, 0.24052605032920837, 0.2628406882286072,
          1.5183017253875732, -0.804744303226471],
         4.713278293609619),
        ([63344, 57435],
         [-0.20681262016296387, -0.5506725311279297, 0.49731308221817017,
          -0.3787074089050293, 0.4080762267112732, 0.33978280425071716,
          1.66775381565094, -0.8644176721572876],
         4.727907180786133),
        ([63344, 57435],
         [-0.0299176424741745, -0.6612327694892883, 0.3696649372577667,
          -0.09797759354114532, 0.24320180714130402, 0.6894850134849548,
          1.3034863471984863, -0.7524639964103699],
         4.814774990081787),
        ([63344, 197486],
         [-0.31290921568870544, -0.5474790334701538, 0.36364609003067017,
          -0.05389314889907837, 0.5355316400527954, 0.6877352595329285,
          1.5510618686676025, -0.7278444766998291],
         4.566646099090576),
        ([145145, 57435],
         [0.0657849907875061, -0.5659763216972351, 0.21932484209537506,
          -0.2656322717666626, 0.4301351308822632, 0.9401465654373169,
          1.688977837562561, -0.4465711712837219],
         4.893865585327148),
        ([145145, 57435],
         [-0.16050118207931519, -0.6464283466339111, 0.4030507206916809,
          -0.15734395384788513, 0.39775270223617554, 0.40994489192962646,
          1.3167823553085327, -0.7440021634101868],
         4.915122032165527),
        ([145145, 57435],
         [-0.13049757480621338, -0.45500773191452026, 0.24305185675621033,
          -0.16199930012226105, 0.2520201802253723, 0.7423915266990662,
          1.6082799434661865, -0.962183952331543],
         4.757846355438232),
        ([87213, 57435],
         [-0.5976046323776245, -0.8300777673721313, 0.21710079908370972,
          -0.1550467610359192, 0.1652854084968567, 0.36901533603668213,
          1.416536808013916, -0.8084326386451721],
         4.651119232177734),
        ([145145, 57435],
         [-0.4090215861797333, -0.8867428302764893, 0.13355392217636108,
          -0.3327743411064148, 0.19836004078388214, 0.6730601787567139,
          1.4864256381988525, -0.6423094272613525],
         4.918923854827881),
        ([63344, 87773],
         [-0.0877273678779602, -0.8755220174789429, 0.14068937301635742,
          -0.09312494099140167, 0.4674077033996582, 0.3682008981704712,
          1.5961850881576538, -0.5055261850357056],
         4.985227584838867),
        ([145145, 57435],
         [-0.2791907787322998, -0.4148990511894226, 0.3013521432876587,
          -0.09828856587409973, 0.48685747385025024, 0.5725915431976318,
          1.5278000831604004, -0.6386657953262329],
         4.764135360717773),
        ([57435, 57435],
         [-0.3736189007759094, -0.689374566078186, 0.20015640556812286,
          -0.13099557161331177, 0.3154856562614441, 0.4536452889442444,
          1.549621343612671, -0.8157262206077576],
         4.718565940856934),
        ([141092, 57435],
         [-0.2244323492050171, -0.6991139650344849, 0.30568811297416687,
          -0.2766909599304199, 0.4242575764656067, 0.7181311845779419,
          1.7455761432647705, -0.658583402633667],
         4.909258842468262),
    ],
}
VLM_REF = {
    "dense": [
        ([57440, 1859],
         [-1.758371353149414, -0.6318517923355103, 0.2540406286716461,
          -1.2728021144866943, -0.9365660548210144, -1.5471713542938232,
          0.8297064304351807, -1.0209977626800537],
         5.506089210510254),
        ([63478, 80067],
         [-0.4157378673553467, -0.24569112062454224, -1.402124047279358,
          -0.7356704473495483, -0.974199652671814, -0.10065409541130066,
          0.6516137719154358, 1.225717306137085],
         4.528637886047363),
        ([87468, 12404],
         [-0.2940085530281067, 0.39399051666259766, 0.13006284832954407,
          -0.7007160186767578, 1.1712658405303955, -0.7208169102668762,
          0.2708381712436676, -0.06588643789291382],
         4.594902992248535),
        ([3592, 48354],
         [0.6186583638191223, 1.6555962562561035, 0.5804991722106934,
          1.1376739740371704, -0.19599974155426025, -0.17801401019096375,
          0.7566788196563721, -1.3702583312988281],
         4.558615207672119),
        ([25504, 63659],
         [-0.34591084718704224, 1.2993237972259521, 1.2419251203536987,
          -0.3748452961444855, -0.9894154071807861, -1.735792636871338,
          -0.7592374086380005, -0.7502540946006775],
         5.179904937744141),
        ([64025, 91356],
         [1.9616494178771973, -0.29407626390457153, 0.49203765392303467,
          -1.6769014596939087, 1.42166268825531, -1.50654935836792,
          -1.6332803964614868, -0.22471296787261963],
         4.687118053436279),
        ([43202, 179],
         [-1.5888720750808716, 0.5507030487060547, 0.6375433206558228,
          1.4719719886779785, 0.40485870838165283, 0.1607217788696289,
          0.612954318523407, 0.6638695597648621],
         4.758852481842041),
        ([92387, 432],
         [1.5502794981002808, 1.3090417385101318, -1.1569212675094604,
          0.682579517364502, -0.6078132390975952, -1.8875154256820679,
          0.8138689994812012, 0.8180441856384277],
         4.578082084655762),
        ([71409, 85169],
         [-1.2445508241653442, 0.8884714245796204, -0.48908424377441406,
          0.5225874781608582, 0.022224605083465576, -0.411588191986084,
          0.6473309993743896, 0.6462600827217102],
         4.274839401245117),
        ([80875, 11990],
         [-0.7717984914779663, -0.28902149200439453, -0.2397441267967224,
          -1.3163625001907349, 0.33658087253570557, 0.7286459803581238,
          0.6123003363609314, 0.8806142807006836],
         4.360042572021484),
        ([70746, 38533],
         [0.23279130458831787, -0.6130837202072144, -0.6147834062576294,
          -0.06903497874736786, -0.8924688100814819, -1.292907476425171,
          1.7295246124267578, 1.6871013641357422],
         4.5689520835876465),
        ([21779, 36075],
         [-0.7066975235939026, 0.9520242810249329, -0.5600389242172241,
          0.02102316915988922, -1.5526916980743408, -1.1977330446243286,
          1.3693503141403198, -1.0072612762451172],
         4.793268203735352),
        ([73752, 75350],
         [1.0548286437988281, -0.62736976146698, -0.01421530544757843,
          0.08271145820617676, -0.004217613488435745, 1.284722924232483,
          1.755358099937439, 0.6056947112083435],
         4.289740562438965),
        ([16157, 16875],
         [-1.248150110244751, -1.195378065109253, 0.07909578084945679,
          1.356903076171875, -0.8921041488647461, 0.8647692203521729,
          0.37209585309028625, 0.6668504476547241],
         4.978658676147461),
        ([51452, 92322],
         [-0.02831888198852539, -0.9673961400985718, 0.7646067142486572,
          -1.292982816696167, -0.8536267876625061, -0.8437491059303284,
          2.3516292572021484, -0.07936698198318481],
         4.55015230178833),
        ([64947, 20831],
         [-1.4251782894134521, 0.2534211277961731, 0.6539058089256287,
          0.7514166831970215, -1.9028146266937256, 1.0045859813690186,
          -0.08602628111839294, 1.1632356643676758],
         4.837944984436035),
        ([70609, 75550],
         [1.0317741632461548, -1.662367820739746, -1.754441499710083,
          -0.44084790349006653, 0.27260762453079224, 0.3776480257511139,
          0.5767899751663208, 0.3872600197792053],
         5.069161891937256),
    ],
    "tag2": [
        ([57440, 1859],
         [-1.7583709955215454, -0.6318521499633789, 0.2540402412414551,
          -1.2728030681610107, -0.9365662932395935, -1.5471720695495605,
          0.8297065496444702, -1.0209977626800537],
         5.506088733673096),
        ([63478, 80067],
         [-0.4157378673553467, -0.24569052457809448, -1.4021238088607788,
          -0.735672116279602, -0.9741994738578796, -0.10065369307994843,
          0.6516135334968567, 1.2257177829742432],
         4.528639793395996),
        ([87468, 12404],
         [-0.2940084636211395, 0.3939906358718872, 0.13006334006786346,
          -0.7007166147232056, 1.1712653636932373, -0.7208161354064941,
          0.27083826065063477, -0.06588566303253174],
         4.594902992248535),
        ([3592, 48354],
         [0.6186584234237671, 1.6555962562561035, 0.5804988145828247,
          1.137673258781433, -0.19600051641464233, -0.1780146062374115,
          0.7566785216331482, -1.3702588081359863],
         4.558614253997803),
        ([25504, 63659],
         [-0.3459104895591736, 1.2993242740631104, 1.24192476272583,
          -0.374845027923584, -0.98941570520401, -1.7357932329177856,
          -0.7592384815216064, -0.7502533793449402],
         5.179904937744141),
        ([64025, 91356],
         [1.9616491794586182, -0.2940751016139984, 0.4920385479927063,
          -1.676901936531067, 1.4216634035110474, -1.5065486431121826,
          -1.6332800388336182, -0.22471195459365845],
         4.687118053436279),
        ([43202, 179],
         [-1.5888721942901611, 0.5507034063339233, 0.6375430226325989,
          1.4719722270965576, 0.40485912561416626, 0.16072289645671844,
          0.6129541397094727, 0.6638702154159546],
         4.758851051330566),
        ([92387, 432],
         [1.550281047821045, 1.3090425729751587, -1.1569218635559082,
          0.6825792789459229, -0.6078132390975952, -1.8875157833099365,
          0.813868522644043, 0.818044126033783],
         4.578082084655762),
        ([71409, 85169],
         [-1.244550347328186, 0.8884708881378174, -0.4890840947628021,
          0.5225868225097656, 0.02222353219985962, -0.41158902645111084,
          0.6473309993743896, 0.6462608575820923],
         4.274838447570801),
        ([80875, 11990],
         [-0.7717985510826111, -0.2890225052833557, -0.2397444099187851,
          -1.316361665725708, 0.33658045530319214, 0.7286457419395447,
          0.6123015284538269, 0.8806148767471313],
         4.360043525695801),
        ([70746, 38533],
         [0.2327919602394104, -0.6130848526954651, -0.6147825717926025,
          -0.06903566420078278, -0.8924684524536133, -1.2929059267044067,
          1.72952401638031, 1.6871001720428467],
         4.568951606750488),
        ([21779, 36075],
         [-0.7066970467567444, 0.9520247578620911, -0.5600395202636719,
          0.021023079752922058, -1.552691102027893, -1.19773268699646,
          1.3693513870239258, -1.007261037826538],
         4.793266773223877),
        ([73752, 75350],
         [1.0548295974731445, -0.6273699402809143, -0.014215081930160522,
          0.08271211385726929, -0.004216574132442474, 1.2847223281860352,
          1.755359172821045, 0.6056948900222778],
         4.289741039276123),
        ([16157, 16875],
         [-1.2481498718261719, -1.1953763961791992, 0.07909619808197021,
          1.3569036722183228, -0.8921039700508118, 0.8647696375846863,
          0.3720959424972534, 0.6668494939804077],
         4.9786577224731445),
        ([51452, 92322],
         [-0.028318971395492554, -0.9673964977264404, 0.7646063566207886,
          -1.292982816696167, -0.853626012802124, -0.8437495827674866,
          2.3516297340393066, -0.07936716079711914],
         4.550152778625488),
        ([64947, 20831],
         [-1.4251785278320312, 0.25342032313346863, 0.6539061069488525,
          0.7514160871505737, -1.9028156995773315, 1.0045846700668335,
          -0.08602586388587952, 1.1632353067398071],
         4.837946891784668),
        ([70609, 75550],
         [1.0317734479904175, -1.6623687744140625, -1.7544424533843994,
          -0.44084784388542175, 0.27260780334472656, 0.37764832377433777,
          0.5767902731895447, 0.387259840965271],
         5.069162368774414),
    ],
    "tag2_bf16": [
        ([57440, 1859],
         [-1.7483086585998535, -0.6131460070610046, 0.24517026543617249,
          -1.275111198425293, -0.9300446510314941, -1.5588582754135132,
          0.8269565105438232, -1.0346007347106934],
         5.514208793640137),
        ([63478, 80067],
         [-0.3963627219200134, -0.23801065981388092, -1.3920835256576538,
          -0.7450331449508667, -0.9689167737960815, -0.11355021595954895,
          0.6528810262680054, 1.219651222229004],
         4.544737339019775),
        ([87468, 12404],
         [-0.2864997982978821, 0.3955110013484955, 0.12417984008789062,
          -0.6820834875106812, 1.1982110738754272, -0.738117516040802,
          0.237860769033432, -0.07724858820438385],
         4.584490776062012),
        ([3592, 48354],
         [0.5818746089935303, 1.6787322759628296, 0.5649808049201965,
          1.1252073049545288, -0.16620749235153198, -0.18623389303684235,
          0.7386801242828369, -1.3816754817962646],
         4.552156448364258),
        ([25504, 63659],
         [-0.3318805992603302, 1.2983347177505493, 1.2493987083435059,
          -0.36887139081954956, -0.9953083992004395, -1.7260781526565552,
          -0.7376068234443665, -0.7561291456222534],
         5.2002482414245605),
        ([64025, 91356],
         [1.970296025276184, -0.28164762258529663, 0.4958823323249817,
          -1.6697182655334473, 1.3708561658859253, -1.537726640701294,
          -1.633000373840332, -0.20724225044250488],
         4.673956871032715),
        ([43202, 47220],
         [-1.5889278650283813, 0.5569843649864197, 0.64067143201828,
          1.4681754112243652, 0.42678868770599365, 0.1586654931306839,
          0.610119104385376, 0.6476072669029236],
         4.794105052947998),
        ([92387, 432],
         [1.564155101776123, 1.2944965362548828, -1.1632286310195923,
          0.693429708480835, -0.6266530752182007, -1.8943120241165161,
          0.7984279990196228, 0.8090305328369141],
         4.581965923309326),
        ([71409, 85169],
         [-1.2441151142120361, 0.8772373199462891, -0.5013718008995056,
          0.5216677188873291, 0.03306889533996582, -0.3999362587928772,
          0.6637341380119324, 0.643700122833252],
         4.262365818023682),
        ([80875, 11990],
         [-0.7632055878639221, -0.2730373442173004, -0.2151670902967453,
          -1.3026634454727173, 0.33449554443359375, 0.7224559187889099,
          0.6082806587219238, 0.8712739944458008],
         4.36497163772583),
        ([70746, 38533],
         [0.22362637519836426, -0.6167502999305725, -0.6197070479393005,
          -0.05329515039920807, -0.9129000902175903, -1.3012886047363281,
          1.7156480550765991, 1.6971827745437622],
         4.554347991943359),
        ([21779, 36075],
         [-0.6741492748260498, 0.999583899974823, -0.5886942744255066,
          0.003955215215682983, -1.5614454746246338, -1.2240020036697388,
          1.3713834285736084, -1.0118452310562134],
         4.788599967956543),
        ([73752, 75350],
         [1.0736535787582397, -0.6311559677124023, 0.010284937918186188,
          0.08315353840589523, -0.022307664155960083, 1.27847421169281,
          1.7810521125793457, 0.6141876578330994],
         4.2689290046691895),
        ([16157, 16875],
         [-1.273711919784546, -1.1895993947982788, 0.1133400946855545,
          1.3549716472625732, -0.9129165410995483, 0.853611946105957,
          0.3689427971839905, 0.653290867805481],
         4.9758806228637695),
        ([51452, 92322],
         [-0.016978830099105835, -0.9787105917930603, 0.7971447110176086,
          -1.3267409801483154, -0.8577880859375, -0.8610545992851257,
          2.3621788024902344, -0.09542606770992279],
         4.534228324890137),
        ([64947, 20831],
         [-1.3907979726791382, 0.24788428843021393, 0.6552689671516418,
          0.7231197357177734, -1.8833918571472168, 1.0066921710968018,
          -0.09059023857116699, 1.1873903274536133],
         4.834137439727783),
        ([70609, 75550],
         [1.06103515625, -1.6755191087722778, -1.7624493837356567,
          -0.4457451105117798, 0.2925903797149658, 0.35420873761177063,
          0.5756018757820129, 0.4145965278148651],
         5.0640034675598145),
    ],
}


def ev_twin_config(arch: str):
    """Phase 32's seamless_m4t_large_v2 or internvl2_2b: full width,
    two layers (each stack), float32."""
    import torch

    from repro_torch.configs import get_config

    layers = (ENCDEC_TWIN if arch == "seamless_m4t_large_v2"
              else VLM_TWIN)["layers"]
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, num_layers=layers,
        encoder_layers=layers if cfg.family == "encdec" else 0,
        compute_dtype=torch.float32)


def encdec_tree_np(cfg, seed: int) -> dict:
    """Params of an encdec ``cfg`` in the reference's layout (stacked
    ``encoder`` and ``decoder`` leaves) as numpy f32, drawn from
    ``default_rng(seed)`` in a fixed order: normal weights scaled by
    1/sqrt(fan-in), as the reference's init scales them, and unit norms.
    ``tools/reference/encdec_serve_ref.py`` builds the reference's params
    from this same function."""
    import math

    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(1.0 / math.sqrt(fan_in))
        return a

    d, ff, vp = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hd = cfg.hd * cfg.num_heads
    kvd = cfg.hd * cfg.num_kv_heads

    def attn(n):
        return {"wq": normal((n, d, hd), d), "wk": normal((n, d, kvd), d),
                "wv": normal((n, d, kvd), d), "wo": normal((n, hd, d), hd)}

    def ones(n):
        return {"scale": np.ones((n, d), np.float32)}

    def mlp(n):
        return {"w_up": normal((n, d, ff), d), "w_down": normal((n, ff, d),
                                                                 ff)}

    ne, nd = cfg.encoder_layers, cfg.num_layers
    return {
        "embed": {"table": normal((vp, d), d)},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "unembed": {"w": normal((d, vp), d)},
        "encoder": {"norm1": ones(ne), "attn": attn(ne), "norm2": ones(ne),
                    "mlp": mlp(ne)},
        "decoder": {"norm1": ones(nd), "attn": attn(nd), "norm_x": ones(nd),
                    "xattn": attn(nd), "norm2": ones(nd), "mlp": mlp(nd)},
    }


def ev_inputs(cfg, seed: int, tw: dict):
    """A twin's or full cell's tokens (B, prompt + steps) and frames or
    patches (B, n, d), standard normal f32."""
    import numpy as np

    toks = lm_tokens(cfg, seed + 1, tw["batch"], tw["prompt"] + tw["steps"])
    n = tw["frames"] if cfg.family == "encdec" else tw["patches"]
    emb = np.random.default_rng(seed + 2).standard_normal(
        (tw["batch"], n, cfg.d_model), dtype=np.float32)
    return toks, emb


EV_LINEAR = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("xattn", "wq"), ("xattn", "wk"), ("xattn", "wv"),
             ("xattn", "wo"), ("mlp", "w_up"), ("mlp", "w_down"))


def ev_gse_params(params, cfg):
    """``params`` with every linear packed into ``gse_serve`` segments on
    its device, one table per layer (``init_params``'s layout): the vlm
    stack as ``lm_gse_params``, both encdec stacks likewise."""
    import torch

    from repro_torch.models.modules import pack_linear_weight
    from repro_torch.tree import tree_map

    if cfg.family != "encdec":
        return lm_gse_params(params, cfg)
    out = tree_map(lambda t: t, params)
    out["unembed"]["w"] = pack_linear_weight(params["unembed"]["w"], cfg)
    for stack in ("encoder", "decoder"):
        for group, name in EV_LINEAR:
            if group not in params[stack]:
                continue
            w = params[stack][group][name]
            per = [pack_linear_weight(w[i], cfg) for i in range(w.shape[0])]
            out[stack][group][name] = {f: torch.stack([q[f] for q in per])
                                       for f in per[0]}
    return out


def ev_params_cpu(arch: str):
    """Phase 32's dense params of ``arch`` as CPU tensors."""
    from repro_torch import convert

    cfg = ev_twin_config(arch)
    tree = (encdec_tree_np(cfg, ENCDEC_SEED) if cfg.family == "encdec"
            else lm_tree_np(cfg, VLM_SEED))
    return convert.params_from_repro(tree, device="cpu")


def ev_run(cfg, params, tokens, emb, device, prompt: int, steps: int):
    """The served path of an encdec or vlm model: ``T.encode`` of the
    frames (encdec), ``make_prefill_step(state=)`` over the patches
    (vlm) and the first ``prompt`` tokens, then ``steps`` teacher-forced
    decode steps; returns the ``(steps + 1, B, V)`` logits on the host,
    the seconds and (encdec) the encoder's output."""
    import torch

    from repro_torch.models import stepfns, transformer as T

    toks = torch.from_numpy(tokens).to(device)
    e = torch.from_numpy(emb).to(device)
    t0 = time.perf_counter()
    kw, enc_out, off = {}, None, 0
    if cfg.family == "encdec":
        enc_out = T.encode(cfg, params, e)
        kw["enc_out"] = enc_out
    else:
        kw["prefix_embeds"], off = e, e.shape[1]
    state = T.decode_state_init(cfg, toks.shape[0], off + prompt + steps,
                                device=device)
    logits = [stepfns.make_prefill_step(cfg)(params, toks[:, :prompt],
                                             state=state, **kw)]
    for i in range(steps):
        lg, state = T.decode_step(cfg, params, state, toks[:, prompt + i],
                                  off + prompt + i, enc_out=enc_out)
        logits.append(lg)
    out = torch.stack(logits).float().cpu()
    return out, time.perf_counter() - t0


def ev_twin_cpu(arch: str):
    """Phase 32's CPU twin of ``arch``: per variant the logits, the
    seconds and the params digest."""
    cfg0 = ev_twin_config(arch)
    enc = cfg0.family == "encdec"
    tw, seed = (ENCDEC_TWIN, ENCDEC_SEED) if enc else (VLM_TWIN, VLM_SEED)
    dense = ev_params_cpu(arch)
    toks, emb = ev_inputs(cfg0, seed, tw)
    out, packed, memo = {}, None, {}
    for name, kw in EV_TWIN_VARIANTS.items():
        cfg = lm_variant(cfg0, kw)
        pc = dense
        if cfg.gse_serve:
            packed = packed or ev_gse_params(dense, cfg)
            pc = packed
        lc, sc = ev_run(cfg, pc, toks, emb, "cpu", tw["prompt"], tw["steps"])
        out[name] = (lc, sc, tree_digest(pc, memo))
    return out


def phase_ev_kernels():
    """Phase 32, part 1: F without a mask (``causal=False``) against its
    plain version at EV_FLASH's shapes, f32 on the FFMA body and bf16 on
    the tensor-core body; returns the bf16 inputs and errors for phase
    10."""
    import torch

    from repro_torch.kernels import flash_attn as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    ctx = {"err": {}, "qkv": {}}
    for label, b, s, t, h, kv, hd in EV_FLASH:
        for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dt)
            k = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dt)
            v = torch.randn((b, t, kv, hd), generator=gen, device=dev).to(dt)
            got = F.flash_attention_gqa(q, k, v, causal=False)
            want = F.flash_attention_gqa_plain(q, k, v, causal=False)
            diff = (got.float() - want.float()).abs()
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            used = float((diff / (tol + tol * want.float().abs())).max())
            body = F.flash_body(dt, hd)
            ctx["err"][label, body] = float(diff.max())
            if dt == torch.bfloat16:
                ctx["qkv"][label] = (q, k, v)
            log("ev_kernels", kernel="flash_attention_gqa", case=label,
                causal=False, body=body, b=b, heads=h, kv_heads=kv, s=s, t=t,
                hd=hd, dtype=str(dt), max_abs_err=float(diff.max()),
                tol=f"rtol {tol} atol {tol}", tol_used=f"{used:.3f}")
            del got, want, diff
    return ctx


def phase_ev_twin(twins=None, params=None):
    """Phase 32, part 2: seamless_m4t_large_v2 and internvl2_2b at full
    width, two layers, on the card and as their CPU twins from the same
    numpy params (``params``: arch -> a future of ev_params_cpu), against
    each other and the reference's digests (ENCDEC_REF, VLM_REF): dense
    and gse_serve tag 2 at f32, gse_serve tag 2 at bf16.  F's non-causal
    launches (the encoder and the cross-attention prefill) must reach both
    bodies.  Returns the launches."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    counts = {}
    for arch, name_twin, refs in (
            ("seamless_m4t_large_v2", "encdec", ENCDEC_REF),
            ("internvl2_2b", "vlm", VLM_REF)):
        cfg0 = ev_twin_config(arch)
        enc = cfg0.family == "encdec"
        tw, seed = (ENCDEC_TWIN, ENCDEC_SEED) if enc else (VLM_TWIN,
                                                            VLM_SEED)
        t0 = time.perf_counter()
        dense_cpu = (params[arch].result() if params is not None
                     else ev_params_cpu(arch))
        dense_gpu = tree_map(lambda t: t.to(dev), dense_cpu)
        del dense_cpu
        toks, emb = ev_inputs(cfg0, seed, tw)
        log("ev_twin", arch=arch, layers=tw["layers"], d_model=cfg0.d_model,
            heads=cfg0.num_heads, kv_heads=cfg0.num_kv_heads, hd=cfg0.hd,
            d_ff=cfg0.d_ff, vocab=cfg0.vocab_size, batch=tw["batch"],
            frames_or_patches=emb.shape[1], prompt=tw["prompt"],
            steps=tw["steps"], params_s=f"{time.perf_counter() - t0:.2f}")
        card, packed = {}, None
        for name, kw in EV_TWIN_VARIANTS.items():
            cfg = lm_variant(cfg0, kw)
            pg = dense_gpu
            if cfg.gse_serve:
                packed = packed or ev_gse_params(dense_gpu, cfg)
                pg = packed
            torch.cuda.synchronize()
            for mod in (E, F):
                mod.reset_launch_counts()
            lg, sg = ev_run(cfg, pg, toks, emb, dev, tw["prompt"],
                            tw["steps"])
            got = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
                   .items()}
            got.update({"f_" + k: v for k, v in
                        F.flash_attention_gqa.body_launches.items()})
            got.update({"f_noncausal_" + k: v for k, v in
                        F.flash_attention_gqa.noncausal_launches.items()})
            card[name] = (lg, sg, got, tree_digest(pg))
        del dense_gpu, packed
        cpu = twin_of(twins, name_twin)
        per = {}
        for name in EV_TWIN_VARIANTS:
            check_twin(f"{name_twin}_twin", name, card[name], cpu[name],
                       refs[name])
            for k, v in card[name][2].items():
                per[k] = per.get(k, 0) + v
        log("ev_twin", arch=arch, launches=json.dumps(per))
        need = ["e_gemv", "e_tiled", "f_ffma", "f_mma"]
        if enc:
            need += ["f_noncausal_ffma", "f_noncausal_mma"]
        if min(per[k] for k in need) <= 0:
            raise AssertionError(f"ev_twin {arch}: a kernel body never "
                                 f"launched: {per}")
        counts[arch] = per
    return counts


def serve_full_ev(cfg, fu, seed, phase):
    """Phase 33: ``cfg`` (encdec or vlm) initialized on the card with
    ``T.init_params``, ``fu["batch"]`` requests of frames (``T.encode``)
    or patches and a ``fu["prompt"]``-token prompt through
    ``make_prefill_step(state=)``, then ``fu["steps"]`` greedy decode
    steps, counted; logs the times, the peak memory and the launches by
    body.  For encdec, the share of a decode step spent recomputing every
    layer's ``cross_kv`` from the encoder's output (timed alone after the
    run).  Returns the counts and (encdec) the cross_kv timing."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.models import attention as A
    from repro_torch.models import stepfns, transformer as T
    from repro_torch.quant import gse_tensor as Q

    dev = torch.device("cuda")
    enc = cfg.family == "encdec"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - held
    nbytes = Q.tree_bytes(params, cfg.gse_tag)
    toks, emb = ev_inputs(cfg, seed, dict(fu, steps=0))
    toks = torch.from_numpy(toks).to(dev)
    e = torch.from_numpy(emb).to(dev)
    off = 0 if enc else e.shape[1]
    state = T.decode_state_init(cfg, fu["batch"],
                                off + fu["prompt"] + fu["steps"], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (E, F):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    kw, enc_out = {}, None
    if enc:
        enc_out = T.encode(cfg, params, e)
        kw["enc_out"] = enc_out
    else:
        kw["prefix_embeds"] = e
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    encode_nc = F.flash_attention_gqa.noncausal_launches["mma"]
    t0 = time.perf_counter()
    logits = stepfns.make_prefill_step(cfg)(params, toks, state=state, **kw)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(fu["steps"]):
        logits, state = T.decode_step(cfg, params, state, tok,
                                      off + fu["prompt"] + i,
                                      enc_out=enc_out)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    counts = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
              .items()}
    counts.update({"f_" + k: v for k, v in
                   F.flash_attention_gqa.body_launches.items()})
    counts.update({"f_noncausal_" + k: v for k, v in
                   F.flash_attention_gqa.noncausal_launches.items()})
    counts["f_noncausal_mma_encode"] = encode_nc
    serve_peak = torch.cuda.max_memory_allocated() - held
    step_ms = decode_s * 1e3 / fu["steps"]
    xkv = {}
    if enc:
        # O20: every decode step recomputes each layer's cross_kv (two
        # (B T, d) x (d, d) products over the encoder's output).
        layers = T._layers(cfg, params, "decoder")

        def all_cross_kv():
            for p in layers:
                A.cross_kv(p["xattn"], enc_out, cfg)

        xkv_ms = cuda_ms(all_cross_kv, reps=3)
        xkv = dict(cross_kv_ms_per_step=f"{xkv_ms:.3f}",
                   cross_kv_share_of_step=f"{xkv_ms / step_ms:.3f}")
    log(phase, arch=cfg.name, layers=cfg.num_layers,
        encoder_layers=cfg.encoder_layers, gse_tag=cfg.gse_tag,
        dtype=str(cfg.compute_dtype), batch=fu["batch"],
        frames_or_patches=emb.shape[1], prompt=fu["prompt"],
        steps=fu["steps"], init_s=f"{init_s:.2f}",
        encode_s=f"{encode_s:.3f}", prefill_s=f"{prefill_s:.3f}",
        ms_per_decode_step=f"{step_ms:.3f}",
        decode_tok_per_s=f"{fu['batch'] * 1e3 / step_ms:.1f}",
        tree_bytes=nbytes, init_peak_gb=f"{init_peak / 1e9:.2f}",
        serve_peak_gb=f"{serve_peak / 1e9:.2f}", launches=json.dumps(counts),
        **xkv)
    log(phase, arch=cfg.name, tokens=json.dumps(torch.stack(out, 1).tolist()))
    if not bool(finite):
        raise AssertionError(f"{phase} {cfg.name}: non-finite logits")
    need = ["e_gemv", "e_tiled", "f_mma"] + (["f_noncausal_mma"] if enc
                                             else [])
    if min(counts[k] for k in need) <= 0:
        raise AssertionError(f"{phase} {cfg.name}: a kernel of the serving "
                             f"path never launched: {counts}")
    del params, state, logits, enc_out, e
    torch.cuda.empty_cache()
    return counts


def phase_ev_full():
    """Phase 33: seamless_m4t_large_v2 (24 + 24 layers) and internvl2_2b
    (24 layers) whole under gse_serve tag 2 at bf16 (ENCDEC_FULL,
    VLM_FULL).  Returns the launches of each."""
    from repro_torch.configs import get_config

    out = {}
    for arch, fu, seed in (("seamless_m4t_large_v2", ENCDEC_FULL,
                            ENCDEC_SEED),
                           ("internvl2_2b", VLM_FULL, VLM_SEED)):
        cfg = dataclasses.replace(get_config(arch), gse_serve=True,
                                  gse_tag=2)
        out[arch] = serve_full_ev(cfg, fu, seed, "ev_full")
    return out


def ev_entries(ctx, counts, add_entry):
    """Phase 10's rows for F without a mask at EV_FLASH's shapes (bf16,
    the tensor-core body), bound by 4 S T hd operations per (batch, head)
    at the bf16 tensor-core rate, beside SDPA on heads-first copies;
    launches from phase 33's seamless run: the encoder's at ``encode``
    (S = T = 512), the cross-attention's at the prefill (S 512 over T
    512), and for the ragged shape, on no path, their sum."""
    import torch

    from repro_torch.kernels import flash_attn as F

    flash_src = "src/repro_torch/kernels/csrc/flash_attn.cu"
    seamless = counts["seamless_m4t_large_v2"]
    launches = {"encoder": seamless["f_noncausal_mma_encode"],
                "cross": (seamless["f_noncausal_mma"]
                          - seamless["f_noncausal_mma_encode"]),
                "ragged": seamless["f_noncausal_mma"]}
    launched = {"encoder": "the encoder's", "cross": "the cross-attention "
                "prefill's", "ragged": "every non-causal launch"}
    for label, b, s, t, h, kv, hd in EV_FLASH:
        q, k, v = ctx["qkv"][label]
        ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops = 4 * b * h * s * t * hd
        add_entry(f"flash_attention_gqa.bfloat16.noncausal.{label}",
                  flash_src, "src/repro/kernels/flash_attn.py:76",
                  lambda: F.flash_attention_gqa(q, k, v, causal=False),
                  lambda: F.flash_attention_gqa_plain(q, k, v, causal=False),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      ql, kl, vl),
                  (2 * q.numel() + 2 * k.numel()) * q.element_size(),
                  flops / BF16_TC_OPS_PER_S * 1e3,
                  plain_reps=2, reps=5, inner=3, shape=[b, s, t, h, kv, hd],
                  causal=False, body=F.flash_body(q.dtype, hd),
                  fp32_bound_ms=flops / FP32_OPS_PER_S * 1e3,
                  launches=launches[label],
                  launches_from=f"phase 33 (seamless, {launched[label]})",
                  max_abs_err=ctx["err"][label, "mma"])
        del ql, kl, vl


# --- the train path: phases 34-37 ------------------------------------------
# Phase 35's train twin: qwen3_4b at full width cut to two layers, f32
# compute (TF32 off), from lm_tree_np's tree (LM_SEED) with zero moments,
# AdamW(lr, warmup 1, total steps), the pipeline's batches (seed 0).
TRAIN_TWIN = dict(batch=2, seq=64, steps=3, layers=2, lr=3e-4)
# The leaves whose first 8 values and max |value| the twin's digest holds
# after each update.
TRAIN_LEAVES = (("embed", "table"), ("layers", "attn", "wq"),
                ("layers", "mlp", "w_down"))
# The twin's loss and grad_norm against the CPU twin and TRAIN_REF
# (relative); a leaf's values within TRAIN_TOL relative plus 2 lr per step
# taken (Adam's step of a gradient near zero may take the other sign).
TRAIN_TOL = 1e-4
# Against TRAIN_REF after the first step: the reference clips with its own
# f32-chain gradient norm (13% low on this twin; the port sums in f64), and
# Adam's eps makes an update depend on the clip scale where |g| is small,
# so the params after the first update differ by up to lr in such
# elements and the next steps' loss and gradient norm by 2e-4 (step 1)
# and 1.2e-3 (step 2) on the CPU twin.
TRAIN_REF_LATER_TOL = 5e-3
# Phase 36: qwen3_4b at full width cut to 8 layers, bf16 compute,
# remat="full", from launch.train.build (params drawn on the card).
TRAIN_FULL = dict(layers=8, batch=4, seq=2048, steps=3)
# Phase 37: the train CLI on its default smoke config, killed after step
# fail_at and resumed, against an uninterrupted run.
TRAIN_CLI = dict(steps=6, every=2, fail_at=3)
# Phase 34: F's backward against autograd through its plain version:
# (label, b, s, t, h, kv, hd, causal, window, dtype, tol), tol on the
# largest error over max(1, the largest |gradient|); qwen3_4b's training
# shape, windows, seamless's encoder and cross shapes, ragged S and T.
TRAIN_FLASH = (
    ("qwen3_4b", 4, 2048, 2048, 32, 8, 128, True, 0, "bfloat16", 1e-2),
    ("qwen3_4b_f32", 4, 2048, 2048, 32, 8, 128, True, 0, "float32", 1e-4),
    ("window", 2, 1024, 1024, 8, 2, 64, True, 256, "bfloat16", 1e-2),
    ("window_f32", 2, 1024, 1024, 8, 2, 64, True, 256, "float32", 1e-4),
    ("encoder", 4, 512, 512, 16, 16, 64, False, 0, "bfloat16", 1e-2),
    ("encoder_f32", 4, 512, 512, 16, 16, 64, False, 0, "float32", 1e-4),
    ("cross", 4, 64, 512, 16, 16, 64, False, 0, "bfloat16", 1e-2),
    ("cross_f32", 4, 64, 512, 16, 16, 64, False, 0, "float32", 1e-4),
    ("ragged", 3, 777, 777, 12, 4, 96, True, 0, "bfloat16", 1e-2),
    ("ragged_f32", 3, 777, 777, 12, 4, 80, True, 0, "float32", 1e-4),
    ("ragged_cross", 2, 300, 451, 8, 2, 48, False, 0, "float32", 1e-4),
)
# tools/reference/train_ref.py's output (JAX 0.9.0 on the CPU): per step,
# train_row's fields, grad_norm the norm of the step's gradients summed in
# f64 (the port's optim.global_norm sums so); grad_norm_f32_vdot, the
# reference step's own metric (an f32 vdot per leaf, one sequential sum on
# XLA's CPU build), is 13% low here and is not compared.
TRAIN_REF = [{'loss': 12.584062576293945,
              'grad_norm': 25.977269766723367,
              'leaves': {'embed/table': {'first': [0.021788282319903374,
                                                   -0.027714639902114868,
                                                   -0.00873060803860426,
                                                   -0.015581810846924782,
                                                   0.011586403474211693,
                                                   -0.0011821402003988624,
                                                   0.0008797553600743413,
                                                   -0.0009325561113655567],
                                         'maxabs': 0.12321735918521881},
                         'layers/attn/wq': {'first': [-0.03639296069741249,
                                                      -0.0008929799660108984,
                                                      0.023095302283763885,
                                                      0.003453486133366823,
                                                      -0.018454089760780334,
                                                      0.04406781122088432,
                                                      0.010413548909127712,
                                                      -0.0015601518098264933],
                                            'maxabs': 0.10481730103492737},
                         'layers/mlp/w_down': {'first': [-0.012628881260752678,
                                                         0.00245414930395782,
                                                         0.015178355388343334,
                                                         0.009006066247820854,
                                                         -0.005190737079828978,
                                                         0.003987685311585665,
                                                         0.005799031350761652,
                                                         -0.0046863798052072525],
                                               'maxabs': 0.05848146602511406}},
              'grad_norm_f32_vdot': 22.483089447021484},
             {'loss': 11.470359802246094,
              'grad_norm': 29.87504452186174,
              'leaves': {'embed/table': {'first': [0.021669302135705948,
                                                   -0.027883417904376984,
                                                   -0.00901740975677967,
                                                   -0.015316675417125225,
                                                   0.011613041162490845,
                                                   -0.0008844928815960884,
                                                   0.0005947158788330853,
                                                   -0.001204724540002644],
                                         'maxabs': 0.12321366369724274},
                         'layers/attn/wq': {'first': [-0.03668442368507385,
                                                      -0.0011372406734153628,
                                                      0.023390524089336395,
                                                      0.0032868417911231518,
                                                      -0.0187256820499897,
                                                      0.04382216930389404,
                                                      0.010681499727070332,
                                                      -0.0018395355436950922],
                                            'maxabs': 0.10480248183012009},
                         'layers/mlp/w_down': {'first': [-0.01236327551305294,
                                                         0.002172270091250539,
                                                         0.015303075313568115,
                                                         0.008897732943296432,
                                                         -0.005314853508025408,
                                                         0.004259868990629911,
                                                         0.005723133683204651,
                                                         -0.004984348546713591],
                                               'maxabs': 0.05867669731378555}},
              'grad_norm_f32_vdot': 26.046724319458008},
             {'loss': 12.984763145446777,
              'grad_norm': 23.414666401056277,
              'leaves': {'embed/table': {'first': [0.02158096805214882,
                                                   -0.027951570227742195,
                                                   -0.009177926927804947,
                                                   -0.015163952484726906,
                                                   0.011685055680572987,
                                                   -0.0007906302926130593,
                                                   0.00045603016042150557,
                                                   -0.0013603788102045655],
                                         'maxabs': 0.12321162968873978},
                         'layers/attn/wq': {'first': [-0.036841630935668945,
                                                      -0.0011993624502792954,
                                                      0.023443827405571938,
                                                      0.0032461932860314846,
                                                      -0.018858088180422783,
                                                      0.04370449110865593,
                                                      0.010794788599014282,
                                                      -0.0017473769839853048],
                                            'maxabs': 0.10487665981054306},
                         'layers/mlp/w_down': {'first': [-0.012297194451093674,
                                                         0.0020260612946003675,
                                                         0.015334269031882286,
                                                         0.00897334236651659,
                                                         -0.005368628539144993,
                                                         0.0042647989466786385,
                                                         0.00563095835968852,
                                                         -0.005142253823578358],
                                               'maxabs': 0.05874556303024292}},
              'grad_norm_f32_vdot': 20.78228759765625}]


def train_twin_config():
    """Phase 35's config: qwen3_4b at full width, TRAIN_TWIN's layers,
    f32 compute (its remat="full" kept)."""
    import dataclasses

    import torch

    from repro_torch import configs

    return dataclasses.replace(configs.get_config("qwen3_4b"),
                               num_layers=TRAIN_TWIN["layers"],
                               compute_dtype=torch.float32)


def train_row(loss, gnorm, params, to_np) -> dict:
    """One step of the train digest: the loss, the grad_norm and the first
    8 values and the largest |value| of each of TRAIN_LEAVES of
    ``params`` (jax or torch arrays, brought to numpy by ``to_np``)."""
    row = {"loss": float(to_np(loss)), "grad_norm": float(to_np(gnorm)),
           "leaves": {}}
    for path in TRAIN_LEAVES:
        leaf = params
        for k in path:
            leaf = leaf[k]
        row["leaves"]["/".join(path)] = {
            "first": [float(v) for v in to_np(leaf.reshape(-1)[:8])],
            "maxabs": float(to_np(abs(leaf).max()))}
    return row


def train_twin_run(device):
    """Phase 35's three steps on ``device``: (the digest rows, F's forward
    and backward launches)."""
    import torch

    from repro_torch import convert
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attn as F
    from repro_torch.models import stepfns
    from repro_torch.optim import AdamW

    tw = TRAIN_TWIN
    cfg = train_twin_config()
    params = convert.params_from_repro(lm_tree_np(cfg, LM_SEED),
                                       device=device)
    opt = AdamW(lr=tw["lr"], warmup_steps=1, total_steps=tw["steps"])
    state = stepfns.TrainState(params, opt.init(params), torch.zeros(
        (), dtype=torch.int32, device=device))
    del params
    step = stepfns.make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=tw["seq"],
                                    global_batch=tw["batch"], seed=0),
                         device=device)
    to_np = lambda t: t.detach().cpu().numpy()  # noqa: E731
    F.reset_launch_counts()
    rows = []
    for i in range(tw["steps"]):
        state, m = step(state, pipe.batch_at(i))
        rows.append(train_row(m["loss"], m["grad_norm"], state.params,
                              to_np))
    counts = {"f_fwd": F.flash_attention_gqa.launches,
              "f_fwd_lse": dict(F.flash_attention_gqa.lse_launches),
              "f_bwd": F.flash_attention_gqa_bwd.launches}
    return rows, counts


class deterministic_algorithms:
    """``torch.use_deterministic_algorithms(True)`` for the train phases,
    off again after (the solver phases use ops without a deterministic
    CUDA implementation)."""

    def __enter__(self):
        from repro_torch.launch.train import deterministic

        deterministic("cuda")

    def __exit__(self, *exc):
        import torch

        torch.use_deterministic_algorithms(False)


def bwd_error(got, want) -> float:
    """The largest |got - want| over max(1, the largest |want|)."""
    w = want.float()
    return float((got.float() - w).abs().max()) / max(1.0,
                                                      float(w.abs().max()))


def phase_train_kernels():
    """Phase 34: F's backward (``flash_attention_gqa_bwd``) against
    autograd through F's plain version at TRAIN_FLASH's shapes: dq, dk and
    dv within each case's tolerance, the kernel's row statistic within
    1e-3 of the plain log-sum-exp, and F's forward with the statistic
    (grad mode) bitwise F's forward without it (the serve paths' launch).
    Returns the qwen3_4b case's inputs and errors for phase 10."""
    import torch

    from repro_torch.kernels import flash_attn as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(34)
    ctx = {"err": {}}
    for (label, b, s, t, h, kv, hd, causal, window, dt,
         tol) in TRAIN_FLASH:
        dt = getattr(torch, dt)
        q, k, v, dout = (
            torch.randn(shape, generator=gen, device=dev).to(dt)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd),
                          (b, s, h, hd)))
        with torch.no_grad():
            out_serve = F.flash_attention_gqa(q, k, v, causal=causal,
                                              window=window)
        qa, ka, va = (x.detach().requires_grad_(True) for x in (q, k, v))
        F.reset_launch_counts()
        out = F.flash_attention_gqa(qa, ka, va, causal=causal, window=window)
        lse = out.grad_fn.saved_tensors[4]
        if F.flash_attention_gqa.lse_launches[F.flash_body(dt, hd)] != 1:
            raise AssertionError(f"phase 34 {label}: the grad-mode forward "
                                 "did not write the row statistic")
        require_bitwise(f"phase 34 {label}: F's forward with the row "
                        "statistic against F's forward without it",
                        out.detach(), out_serve)
        got = torch.autograd.grad(out, (qa, ka, va), dout)
        if F.flash_attention_gqa_bwd.launches != 1:
            raise AssertionError(f"phase 34 {label}: the backward kernel "
                                 "did not launch")
        del out, qa, ka, va
        want = F.flash_attention_gqa_bwd_plain(q, k, v, dout, causal=causal,
                                               window=window)
        errs = [bwd_error(g_, w_) for g_, w_ in zip(got, want)]
        lse_err = float((lse - F.flash_lse_plain(
            q, k, causal=causal, window=window)).abs().max())
        if max(errs) > tol or lse_err > 1e-3:
            raise AssertionError(f"phase 34 {label}: dq/dk/dv errors "
                                 f"{errs} (tol {tol}), lse {lse_err}")
        again = F.flash_attention_gqa_bwd(q, k, v, out_serve, lse, dout,
                                          causal=causal, window=window)
        for g_, a_ in zip(got, again):
            require_bitwise(f"phase 34 {label}: the backward run twice", a_,
                            g_)
        ctx["err"][label] = max(float((g_.float() - w_.float()).abs().max())
                                for g_, w_ in zip(got, want))
        if label == "qwen3_4b":
            ctx["qwen3_4b"] = (q, k, v, out_serve, lse, dout)
        log("train_kernels", kernel="flash_attention_gqa_bwd", case=label,
            b=b, heads=h, kv_heads=kv, s=s, t=t, hd=hd, causal=causal,
            window=window, dtype=str(dt), forward_body=F.flash_body(dt, hd),
            dq_dk_dv_err=json.dumps([round(e, 9) for e in errs]),
            tol=f"{tol} of max(1, max |grad|)", lse_max_abs_err=lse_err,
            forward_lse_bitwise_no_lse=True, backward_bitwise_rerun=True)
        del got, want, again, lse
    return ctx


def check_train_rows(what, got, want, lr, later_tol=TRAIN_TOL):
    """``got`` against ``want`` (train_row digests): loss and grad_norm
    within TRAIN_TOL relative at the first step and ``later_tol`` after
    it; each leaf value within TRAIN_TOL relative plus 2 lr per step
    taken.  Returns the largest errors."""
    worst = {"loss": 0.0, "grad_norm": 0.0, "leaves": 0.0}
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "grad_norm"):
            rel = abs(g[key] - w[key]) / abs(w[key])
            worst[key] = max(worst[key], rel)
            if rel > (TRAIN_TOL if i == 0 else later_tol):
                raise AssertionError(f"{what} step {i}: {key} {g[key]} vs "
                                     f"{w[key]} (rel {rel:.3e})")
        atol = 2 * lr * (i + 1)
        for name, gl in g["leaves"].items():
            wl = w["leaves"][name]
            for a, b in zip(gl["first"] + [gl["maxabs"]],
                            wl["first"] + [wl["maxabs"]]):
                err = abs(a - b)
                worst["leaves"] = max(worst["leaves"], err)
                if err > atol + TRAIN_TOL * abs(b):
                    raise AssertionError(f"{what} step {i}: {name} {a} vs "
                                         f"{b} (atol {atol})")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} steps vs {len(want)}")
    return worst


def phase_train_twin(twins=None):
    """Phase 35: the train twin on the card against its CPU twin and the
    reference's TRAIN_REF (TRAIN_TOL; TF32 off), F's forward (with the row
    statistic, twice a layer under remat) and backward launched every
    layer of every step.  Returns the launches."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with deterministic_algorithms():
        rows, counts = train_twin_run("cuda")
    gpu_s = time.perf_counter() - t0
    cpu = twin_of(twins, "train")
    tw = TRAIN_TWIN
    worst_cpu = check_train_rows("train_twin (CPU twin)", rows, cpu,
                                 tw["lr"])
    worst_ref = check_train_rows("train_twin (TRAIN_REF)", rows, TRAIN_REF,
                                 tw["lr"], TRAIN_REF_LATER_TOL)
    n = tw["layers"] * tw["steps"]
    if counts["f_bwd"] != n or counts["f_fwd"] != 2 * n:
        raise AssertionError(f"train_twin: F launched {counts}, expected "
                             f"{2 * n} forwards and {n} backwards")
    log("train_twin", layers=tw["layers"], d_model=2560, vocab=151936,
        batch=tw["batch"], seq=tw["seq"], steps=tw["steps"],
        dtype="float32", gpu_s=f"{gpu_s:.2f}",
        loss=[r["loss"] for r in rows],
        grad_norm=[r["grad_norm"] for r in rows],
        worst_vs_cpu=json.dumps(worst_cpu), worst_vs_ref=json.dumps(worst_ref),
        tol=(f"rel {TRAIN_TOL} (TRAIN_REF after step 0: "
             f"{TRAIN_REF_LATER_TOL}), leaves + 2 lr per step"),
        launches=json.dumps(counts))
    return counts


def train_full_config(remat: str = "full"):
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_config("qwen3_4b"),
                               num_layers=TRAIN_FULL["layers"], remat=remat)


def train_full_run(remat: str, batches):
    """Phase 36's steps at ``remat``: per step (loss, grad_norm, ms), F's
    forward and backward launches, the peak GB."""
    import torch

    from repro_torch.kernels import flash_attn as F
    from repro_torch.launch import train as TR

    cfg = train_full_config(remat)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, step = TR.build(cfg, TRAIN_FULL["steps"], device="cuda")
    F.reset_launch_counts()
    out = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out.append((m["loss"].item(), m["grad_norm"].item(),
                    (time.perf_counter() - t0) * 1e3))
    counts = {"f_fwd": F.flash_attention_gqa.launches,
              "f_bwd": F.flash_attention_gqa_bwd.launches,
              "f_fwd_mma": F.flash_attention_gqa.body_launches["mma"]}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    torch.cuda.empty_cache()
    return out, counts, peak


def phase_train_full():
    """Phase 36: qwen3_4b at full width, TRAIN_FULL's layers, bf16 compute,
    remat="full", three steps from launch.train.build on the pipeline's
    batches (V 151936, B 4, S 2048): finite loss and grad_norm, F's forward
    twice a layer a step (the forward and its remat, on the tensor-core
    body) and its backward once; then the same with remat off, whose loss
    and grad_norm must be bitwise equal.  Returns the launches for phase
    10."""
    import math

    import torch

    from repro_torch.data import DataConfig, TokenPipeline

    fu = TRAIN_FULL
    cfg = train_full_config()
    t0 = time.perf_counter()
    with deterministic_algorithms():
        pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=fu["seq"],
                                        global_batch=fu["batch"], seed=0))
        batches = [pipe.batch_at(i) for i in range(fu["steps"])]
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        remat, counts, peak = train_full_run("full", batches)
        plain, counts_off, peak_off = train_full_run("none", batches)
    del batches
    n = fu["layers"] * fu["steps"]
    for (l1, g1, _), (l2, g2, _) in zip(remat, plain):
        if not (math.isfinite(l1) and math.isfinite(g1)):
            raise AssertionError(f"train_full: loss {l1} grad_norm {g1}")
        if (l1, g1) != (l2, g2):
            raise AssertionError(f"train_full: remat {l1!r} {g1!r} != no "
                                 f"remat {l2!r} {g2!r}")
    if (counts["f_fwd"], counts["f_bwd"], counts["f_fwd_mma"]) != (
            2 * n, n, 2 * n) or (counts_off["f_fwd"],
                                 counts_off["f_bwd"]) != (n, n):
        raise AssertionError(f"train_full: F launched {counts} (remat) and "
                             f"{counts_off} (none)")
    log("train_full", arch="qwen3_4b", layers=fu["layers"], d_model=2560,
        heads=32, kv_heads=8, hd=128, d_ff=9728, vocab=151936,
        batch=fu["batch"], seq=fu["seq"], steps=fu["steps"],
        dtype="bfloat16", remat="full", batches_s=f"{batch_s:.2f}",
        loss=[r[0] for r in remat], grad_norm=[r[1] for r in remat],
        ms_per_step=[round(r[2], 3) for r in remat],
        ms_per_step_no_remat=[round(r[2], 3) for r in plain],
        peak_gb=f"{peak:.2f}", peak_gb_no_remat=f"{peak_off:.2f}",
        f_fwd_per_step=counts["f_fwd"] // fu["steps"],
        f_bwd_per_step=counts["f_bwd"] // fu["steps"],
        remat_bitwise_no_remat=True)
    return dict(counts, steps=fu["steps"],
                ms_per_step=[r[2] for r in remat])


def phase_train_cli():
    """Phase 37: ``repro_torch.launch.train`` (its default smoke config)
    for TRAIN_CLI's steps with checkpoints: uninterrupted (its ``main``
    here), and in a process of its own killed by
    ``--simulate-failure-at`` (exit 17), then resumed here: the final
    checkpoints' ``tree_crc32`` equal.  ``main`` turns on deterministic
    algorithms; they are turned off again after."""
    import contextlib
    import io
    import tempfile

    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train as TR

    tc = TRAIN_CLI
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        def argv(where):
            return ["--smoke", "--steps", str(tc["steps"]), "--ckpt-dir",
                    str(Path(tmp, where)), "--ckpt-every", str(tc["every"])]

        def here(where):
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    TR.main(argv(where))
            finally:
                torch.use_deterministic_algorithms(False)
            return out.getvalue()

        here("whole")
        killed = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *argv("resumed"), "--simulate-failure-at", str(tc["fail_at"])],
            cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=300)
        if killed.returncode != 17:
            raise AssertionError(f"train_cli: the killed run exited "
                                 f"{killed.returncode}, not 17:\n"
                                 f"{killed.stdout}\n{killed.stderr}")
        resumed = here("resumed")
        if "resumed from step" not in resumed:
            raise AssertionError(f"train_cli: no resume:\n{resumed}")
        crcs = {}
        for where in ("whole", "resumed"):
            meta = Path(tmp, where, f"step_{tc['steps']:08d}", "meta.json")
            crcs[where] = json.loads(meta.read_text())["tree_crc32"]
        if crcs["whole"] != crcs["resumed"]:
            raise AssertionError(f"train_cli: tree_crc32 {crcs}")
        steps = {w: ckpt.list_steps(str(Path(tmp, w)))
                 for w in ("whole", "resumed")}
        resumed_from = resumed.split("resumed from step")[1].split()[0]
    log("train_cli", arch="granite_3_2b (smoke)", steps=tc["steps"],
        ckpt_every=tc["every"], failure_after_step=tc["fail_at"],
        killed_exit=17, resumed_from=int(resumed_from),
        checkpoints=json.dumps(steps), tree_crc32=crcs["whole"],
        tree_crc32_equal=True, device=torch.cuda.get_device_name(0),
        seconds=f"{time.perf_counter() - t0:.1f}")


def train_entries(ctx, counts, add_entry):
    """Phase 10's row for F's backward at qwen3_4b's training shape (bf16,
    causal), bound by 10 S T hd operations per (batch, head), halved when
    causal, at the bf16 tensor cores' rate (the inputs' type; the FP32
    rate of its FFMA body beside, as ``fp32_bound_ms``), beside SDPA's
    backward (``is_causal=True, enable_gqa=True``, heads-first copies,
    warmed) and autograd through F's plain version; launches from phase
    36's remat run."""
    import torch

    from repro_torch.kernels import flash_attn as F

    q, k, v, out, lse, dout = ctx["qwen3_4b"]
    b, s, h, hd = q.shape
    kv = k.shape[2]
    ql, kl, vl = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    ol = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True, enable_gqa=True)
    dl = dout.transpose(1, 2).contiguous()
    flops = 10 * b * h * s * s * hd // 2
    es = q.element_size()
    nbytes = (3 * q.numel() + 2 * k.numel()) * es + 4 * b * h * s \
        + (q.numel() + 2 * k.numel()) * es
    add_entry("flash_attention_gqa_bwd.bfloat16.causal.qwen3_4b",
              "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
              "src/repro/kernels/flash_attn.py:76",
              lambda: F.flash_attention_gqa_bwd(q, k, v, out, lse, dout),
              lambda: F.flash_attention_gqa_bwd_plain(q, k, v, dout),
              lambda: torch.autograd.grad(ol, (ql, kl, vl), dl,
                                          retain_graph=True),
              nbytes, flops / BF16_TC_OPS_PER_S * 1e3, plain_reps=1,
              reps=3, inner=2, shape=[b, s, s, h, kv, hd], causal=True,
              body="ffma", fp32_bound_ms=flops / FP32_OPS_PER_S * 1e3,
              launches=counts["f_bwd"],
              launches_from=(f"phase 36 (qwen3_4b, {TRAIN_FULL['layers']} "
                             f"layers, {counts['steps']} steps, remat)"),
              launches_per_step=counts["f_bwd"] // counts["steps"],
              f_fwd_launches_per_step=counts["f_fwd"] // counts["steps"],
              max_abs_err=ctx["err"]["qwen3_4b"])
    del ql, kl, vl, ol


# The example's stepped GMRES case (examples/solve_stepped_gmres.py) and its
# right-Jacobi twin: the reference's (iters, switch_iters, tag) on the CPU,
# which tests/test_torch_gmres.py holds the port's CPU twin to.
GMRES_PARAMS = dict(t=40, l=60, m=30, rsd_limit=0.5, reldec_limit=0.45)
GMRES_REF = {None: (4633, [89, 119], 3), "jacobi": (283, [119, 178], 3)}
GMRES_RESTART = 80
GMRES_FULL_ITERS = 800  # phase 16's fixed budget: ten restart cycles
# quickstart section 4's PCG cases (ill_conditioned_spd(32, 8 decades),
# tol 1e-10, the fast monitor): the reference's (iters, switch_iters, tag);
# tests/test_torch_pcg.py holds the CPU twin to them.
PCG_PARAMS = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
PCG_REF = {"jacobi": (115, [-1, -1], 1), "block_jacobi": (95, [-1, -1], 1),
           "spai0": (1107, [120, 135], 3)}


# quickstart section 5's refinement (the system of PCG_REF, Jacobi, b and
# the second draw b'; tools/reference/ir_ref.py, JAX on the CPU, x64):
# solve_ir's (outer_iters, inner_iters, relres) per inner solver -- the
# CG rows with PCG_PARAMS, the GMRES rows with the GMRES monitor's
# defaults -- and solve_ir_batched's per-column outer and inner counts
# and relres on [b, 2b, b', 0].  tests/test_torch_ir.py holds the CPU twin
# to them.
IR_KW = dict(tol=1e-11, max_outer=10, inner_tol=1e-4, inner_maxiter=4000)
IR_RUNS = {"pcg_jacobi": ("cg", True, 30), "cg": ("cg", False, 30),
           "gmres_jacobi_r30": ("gmres", True, 30),
           "gmres_jacobi_r60": ("gmres", True, 60),
           "gmres_jacobi_r80": ("gmres", True, 80)}
IR_REF = {"pcg_jacobi": (5, 296, 6.254406590631485e-14),
          "cg": (4, 10400, 1.4240524747206275e-13),
          "gmres_jacobi_r30": (5, 385, 9.012640712211029e-14),
          "gmres_jacobi_r60": (5, 289, 8.130422133075342e-14),
          "gmres_jacobi_r80": (5, 280, 7.253042026086966e-14)}
IR_BATCHED_REF = ([5, 5, 5, 0], [296, 296, 289, 0],
                  [6.254406590631485e-14, 6.254406590631485e-14,
                   3.8567116799096125e-14, 0.0])
# The inner-CG row's 10,400 inner iterations take about a minute on the
# host, so its CPU twin runs a cut budget (the card runs it too).
IR_CG_CUT = dict(inner_maxiter=500, max_outer=3)
# The reference's SolverService(slots=4) with register(precond=kind) on
# rs8_400_s3 (tools/reference/ir_ref.py), in SERVICE_REF's layout; at
# maxiter 4 every request takes the tag-3 PCG retry (Jacobi undoes the
# system's diagonal rescale: 7 and 32-35 iterations are enough).
PCG_SERVICE_REF = {
    ("jacobi", 20000): ([(7, 1, [-1, -1], "ok", 0, 128837)] * 3,
                        dict(batches=1, requests=3, padded_cols=1,
                             modeled_bytes=386512, retries=0, errors=0,
                             deadline_exceeded=0)),
    ("jacobi", 4): ([(8, 3, [-1, -1], "ok", 1, 243285)] * 3,
                    dict(batches=1, requests=3, padded_cols=1,
                         modeled_bytes=729856, retries=3, errors=0,
                         deadline_exceeded=0)),
    ("spai0", 20000): ([(34, 1, [-1, -1], "ok", 0, 637787),
                        (32, 1, [-1, -1], "ok", 0, 588971),
                        (35, 1, [-1, -1], "ok", 0, 680203)],
                       dict(batches=1, requests=3, padded_cols=1,
                            modeled_bytes=1906960, retries=0, errors=0,
                            deadline_exceeded=0)),
    ("spai0", 4): ([(8, 3, [-1, -1], "stalled", 1, 243285)] * 3,
                   dict(batches=1, requests=3, padded_cols=1,
                        modeled_bytes=729856, retries=3, errors=0,
                        deadline_exceeded=0)),
}
SLICED_ROWS = (30, 60, 80)  # the cycle update's rows phase 15 checks


def gmres_example(device):
    """The example's operator ``diag_rescale(convection_diffusion_2d(32,
    beta=5), 3, 7)`` on ``device`` and its b (the port's CSR SpMV on the
    host, as the tests make it)."""
    import numpy as np
    import torch

    from repro_torch.sparse import generators as G
    from repro_torch.sparse.spmv import spmv

    host = G.diag_rescale(G.convection_diffusion_2d(32, beta=5.0,
                                                    device="cpu"), 3.0, 7)
    b = spmv(host, torch.from_numpy(
        np.random.default_rng(7).normal(size=host.shape[0])))
    a = G.diag_rescale(G.convection_diffusion_2d(32, beta=5.0, device=device),
                       3.0, 7)
    return a, b.to(device)


def gmres_example_solve(where, pre):
    """Phase 15's solve: the example's case (right Jacobi when ``pre``)
    on ``where``; returns the result and the seconds."""
    from repro_torch.core.precision import MonitorParams
    from repro_torch.solvers import make_gse_operator, make_jacobi, solve_gmres
    from repro_torch.sparse.csr import pack_csr

    a, b = gmres_example(where)
    kw = dict(tol=1e-7, restart=GMRES_RESTART, maxiter=8000,
              params=MonitorParams(**GMRES_PARAMS))
    if pre:
        kw["precond"] = make_jacobi(a, k=8)
    t0 = time.perf_counter()
    r = solve_gmres(make_gse_operator(pack_csr(a, k=8)), b, **kw)
    return r, time.perf_counter() - t0


def phase_gmres_trajectory(twins=None):
    """Phase 15: the GMRES kernels against their plain versions, then the
    example's case and its right-Jacobi twin on the card and the CPU twin.
    Returns the operands phase 10 times the GEMVs on."""
    import numpy as np
    import torch

    from repro_torch.kernels import gmres_f64 as GF
    from repro_torch.kernels import vec_f64 as V

    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    rows_all = GMRES_RESTART + 1
    host = {"V": torch.from_numpy(rng.normal(size=(rows_all, N_FULL))),
            "w": torch.from_numpy(rng.normal(size=N_FULL)),
            "c": torch.from_numpy(rng.normal(size=rows_all)),
            "x": torch.from_numpy(rng.normal(size=N_FULL))}
    card = {k: v.to(dev) for k, v in host.items()}
    err = {"gemv_rows_ref": 0.0, "gemv_cols_ref": 0.0}
    for rows in (1, 41, rows_all):
        for name, got, want in (
                ("gemv_rows_ref", V.gemv_rows_ref(card["V"], card["w"], rows),
                 V.gemv_rows_ref_plain(host["V"], host["w"], rows)),
                ("gemv_cols_ref", V.gemv_cols_ref(card["c"], card["V"], rows),
                 V.gemv_cols_ref_plain(host["c"], host["V"], rows)),
                ("gemv_cols_ref", V.gemv_cols_ref(card["c"], card["V"], rows,
                                                  addend=card["x"]),
                 V.gemv_cols_ref_plain(host["c"], host["V"], rows,
                                       addend=host["x"]))):
            require_bitwise(f"{name} at rows {rows}, n {N_FULL} against its "
                            "plain version", got, want)
            err[name] = max(err[name], float((got.cpu() - want).abs().max()))
    log("gmres_trajectory", kernels="gemv_rows_ref gemv_cols_ref (+addend)",
        n=N_FULL, rows=[1, 41, rows_all], bitwise=True)
    err["gemv_cols_sliced_ref"] = 0.0
    for rows in SLICED_ROWS:
        got = V.gemv_cols_sliced_ref(card["c"], card["V"], rows)
        want = V.gemv_cols_sliced_ref_plain(host["c"], host["V"], rows)
        require_bitwise(f"gemv_cols_sliced_ref at rows {rows}, n {N_FULL} "
                        "against its plain version", got, want)
        err["gemv_cols_sliced_ref"] = max(err["gemv_cols_sliced_ref"], float(
            (got.cpu() - want).abs().max()))
    log("gmres_trajectory", kernel="gemv_cols_sliced_ref", n=N_FULL,
        rows=list(SLICED_ROWS), plan_steps=[len(V.sliced_plan(r))
                                            for r in SLICED_ROWS],
        bitwise=True)

    # The rotations and the back substitution at every cycle length.
    restart = GMRES_RESTART
    lsq = {}
    for j in (0, 1, 40, restart - 1):
        state = [torch.from_numpy(rng.normal(size=j + 1)),
                 torch.tensor(abs(rng.normal()), dtype=torch.float64),
                 torch.from_numpy(rng.normal(size=restart)),
                 torch.from_numpy(rng.normal(size=restart)),
                 torch.from_numpy(rng.normal(size=restart + 1)),
                 torch.from_numpy(rng.normal(size=(restart + 1, restart))),
                 torch.ones((), dtype=torch.float64)]
        on_card = [t.to(dev) for t in state]
        GF.givens_step(*on_card, torch.ones((), dtype=torch.bool, device=dev),
                       j)
        GF.givens_step_plain(*state, torch.tensor(True), j)
        for got, want in zip(on_card, state):
            require_bitwise(f"givens_step at j {j} against its plain version",
                            got, want)
        lsq["givens"] = [t.to(dev) for t in state]
    tri = torch.from_numpy(np.triu(rng.normal(size=(restart + 1, restart)))
                           + 3 * np.eye(restart + 1, restart))
    gvec = torch.from_numpy(rng.normal(size=restart + 1))
    for j in (0, 1, 17, 40, restart):
        require_bitwise(f"trsv_upper_ref at j {j} against its plain version",
                        GF.trsv_upper_ref(tri.to(dev), gvec.to(dev),
                                          torch.tensor(j, dtype=torch.int32,
                                                       device=dev)),
                        GF.trsv_upper_ref_plain(tri, gvec, j))
    lsq["tri"], lsq["g"] = tri.to(dev), gvec.to(dev)
    log("gmres_trajectory", kernels="givens_step trsv_upper_ref",
        restart=restart, j_givens=[0, 1, 40, restart - 1],
        j_trsv=[0, 1, 17, 40, restart], bitwise=True)

    cpu = twin_of(twins, "gmres")
    for pre in (None, "jacobi"):
        rg, tg_s = gmres_example_solve("cuda", pre)
        rc, tc_s = cpu[pre]
        got = (int(rg.iters), rg.switch_iters.tolist(), int(rg.tag))
        log("gmres_trajectory", case="example", precond=pre, gpu_iters=got[0],
            cpu_iters=int(rc.iters), switch_iters=got[1], tag=got[2],
            relres=float(rg.relres), converged=bool(rg.converged),
            gpu_s=f"{tg_s:.2f}", cpu_s=f"{tc_s:.2f}",
            gpu_ms_per_iteration=f"{tg_s * 1e3 / got[0]:.3f}")
        if got != GMRES_REF[pre]:
            raise AssertionError(f"GMRES example ({pre}) on the GPU: {got} != "
                                 f"{GMRES_REF[pre]}")
        if (int(rc.iters), rc.switch_iters.tolist(), int(rc.tag)) != got:
            raise AssertionError("GMRES: the GPU and the CPU twin disagree")
        require_bitwise(f"GMRES example ({pre}) x against the CPU twin",
                        rg.x, rc.x)
        require_bitwise(f"GMRES example ({pre}) relres against the CPU twin",
                        rg.relres, rc.relres)
        if not bool(rg.converged):
            raise AssertionError(f"GMRES example ({pre}) did not converge")
    return dict(card=card, host=host, err=err, lsq=lsq)


def phase_gmres_full():
    """Phase 16: stepped GMRES(80), right-Jacobi, on the example's
    construction at 2^20 unknowns, over a fixed budget of inner
    iterations; launch counts zeroed.  Returns the launches of its
    kernels and the solve (operator, b, preconditioner, params, result
    and seconds) that phase 23 repeats with the flight recorder."""
    import numpy as np
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.kernels import gmres_f64 as GF
    from repro_torch.kernels import gse_spmv as K
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.robustness.guards import health_name
    from repro_torch.solvers import gmres as T_gmres
    from repro_torch.solvers import make_gse_operator, make_jacobi, solve_gmres
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    a = G.diag_rescale(G.convection_diffusion_2d(1024, beta=5.0, device=dev),
                       3.0, 7)
    b = torch.from_numpy(host_spmv(a, np.random.default_rng(16).normal(
        size=a.shape[0]))).to(dev)
    g = pack_csr(a, k=8)
    m = make_jacobi(a, k=8)
    op = make_gse_operator(g)
    params = MonitorParams(**GMRES_PARAMS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # Uncounted: the first cycle's recursive residuals, all 80 in the
    # monitor's window, must never increase (Givens: |g[j+1]| <= |g[j]|).
    _, _, mon = T_gmres._solve_gmres(
        op, b, torch.zeros_like(b), torch.tensor(1e-7, dtype=torch.float64,
                                                 device=dev),
        GMRES_RESTART, GMRES_RESTART,
        MonitorParams(t=GMRES_RESTART, l=10_000, m=10_000), apply_m=m.apply)
    cycle = mon.hist.cpu()
    if int(mon.count) != GMRES_RESTART or bool((cycle[1:] > cycle[:-1]).any()):
        raise AssertionError("phase 16: the first cycle's recursive residual "
                             "increased")
    torch.cuda.synchronize()
    for mod in (K, V, GF):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_gmres(op, b, tol=1e-7, restart=GMRES_RESTART,
                      maxiter=GMRES_FULL_ITERS, params=params, precond=m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "gse_spmv_csr_f64": K.gse_spmv_csr_f64.launches,
        "gemv_rows_ref": V.gemv_rows_ref.launches,
        "gemv_cols_ref": V.gemv_cols_ref.launches,
        "gemv_cols_sliced_ref": V.gemv_cols_sliced_ref.launches,
        "givens_step": GF.givens_step.launches,
        "trsv_upper_ref": GF.trsv_upper_ref.launches,
        "seq_dot": V.seq_dot.launches}
    a64_bodies = dict(K.gse_spmv_csr_f64.body_launches)
    iters = int(res.iters)
    log("gmres_full", rows=g.shape[0], nnz=g.nnz, restart=GMRES_RESTART,
        precond="jacobi", iters=iters, switch_iters=res.switch_iters.tolist(),
        tag=int(res.tag), relres=float(res.relres),
        converged=bool(res.converged), health=health_name(res.health),
        trip_iter=int(res.trip_iter), first_cycle_last=float(cycle[-1]),
        setup_s=f"{setup_s:.2f}", wall_s=f"{wall:.2f}",
        ms_per_iteration=f"{wall * 1e3 / iters:.3f}",
        launches_per_iteration=f"{sum(launches.values()) / iters:.2f}",
        launches=json.dumps(launches), a64_body_launches=json.dumps(a64_bodies))
    if iters != GMRES_FULL_ITERS and not bool(res.converged):
        raise AssertionError(f"phase 16 ran {iters} of {GMRES_FULL_ITERS}")
    # Ten cycles at maxiter end "stalled" by the reference's rule for an
    # exhausted budget; no guard may have tripped.
    if int(res.trip_iter) != -1 or health_name(res.health) not in (
            "ok", "stalled"):
        raise AssertionError(f"phase 16 ended {health_name(res.health)}, "
                             f"trip at {int(res.trip_iter)}")
    # From x0 = 0 the relative residual starts at 1.
    if not (bool(torch.isfinite(res.x).all()) and 0.0 < float(res.relres) < 1):
        raise AssertionError(f"phase 16: relres {float(res.relres)!r}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the GMRES path never launched: "
                             f"{launches}")
    require_bodies("phase 16: A64", a64_bodies, plan_bodies(g))
    return launches, dict(op=op, b=b, m=m, params=params, res=res,
                          wall=wall)


def pcg_case(kind, device):
    """quickstart section 4's system on ``device``, its b (the port's CSR
    SpMV on the host) and ``kind``'s preconditioner."""
    import numpy as np
    import torch

    from repro_torch.solvers import precond as PC
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr
    from repro_torch.sparse.spmv import spmv

    host = G.ill_conditioned_spd(32, decades=8.0, seed=0, device="cpu")
    b = spmv(host, torch.from_numpy(
        np.random.default_rng(0).normal(size=host.shape[0])))
    a = G.ill_conditioned_spd(32, decades=8.0, seed=0, device=device)
    return pack_csr(a, k=8), getattr(PC, f"make_{kind}")(a, k=8), b.to(device)


def pcg_solve(kind, where):
    """Phase 17's solve: quickstart section 4's case with ``kind``'s
    preconditioner on ``where``; returns the result and the seconds."""
    from repro_torch.core.precision import MonitorParams
    from repro_torch.solvers import solve_pcg

    g, m, b = pcg_case(kind, where)
    t0 = time.perf_counter()
    r = solve_pcg(g, b, m, tol=1e-10, maxiter=5000,
                  params=MonitorParams(**PCG_PARAMS))
    return r, time.perf_counter() - t0


def phase_pcg_trajectory(twins=None):
    """Phase 17: PCG on quickstart section 4's cases, the card against the
    CPU twin, and the fused path against the generic one on the card."""
    from repro_torch.core.precision import MonitorParams
    from repro_torch.solvers import (make_gse_operator, make_precond_operator,
                                     solve_pcg)

    params = MonitorParams(**PCG_PARAMS)
    kw = dict(tol=1e-10, maxiter=5000, params=params)
    cpu = twin_of(twins, "pcg")
    for kind, want in PCG_REF.items():
        rg, tg_s = pcg_solve(kind, "cuda")
        rc, tc_s = cpu[kind]
        g, m, b = pcg_case(kind, "cuda")
        generic = solve_pcg(make_gse_operator(g), b, make_precond_operator(m),
                            **kw)
        got = (int(rg.iters), rg.switch_iters.tolist(), int(rg.tag))
        log("pcg_trajectory", case="illcond_32", precond=kind,
            iters=got[0], switch_iters=got[1], tag=got[2],
            relres=float(rg.relres), gpu_s=f"{tg_s:.2f}",
            cpu_s=f"{tc_s:.2f}", cpu_twin_bitwise=True,
            fused_bitwise_generic=True)
        if got != want:
            raise AssertionError(f"PCG {kind} on the GPU: {got} != {want}")
        if (int(rc.iters), rc.switch_iters.tolist(), int(rc.tag)) != got:
            raise AssertionError(f"PCG {kind}: the GPU and the CPU twin "
                                 "disagree")
        require_bitwise(f"PCG {kind} x against the CPU twin", rg.x, rc.x)
        require_bitwise(f"PCG {kind} relres against the CPU twin", rg.relres,
                        rc.relres)
        require_bitwise(f"PCG {kind}: fused x against the generic path",
                        rg.x, generic.x)
        if int(generic.iters) != got[0] or not bool(rg.converged):
            raise AssertionError(f"PCG {kind}: generic {int(generic.iters)} "
                                 f"iterations, converged {bool(rg.converged)}")


def phase_pcg_full(csr, g, b, params, cg_res, cg_wall):
    """Phase 18: stepped PCG with Jacobi on phase 4's matrix, launch counts
    zeroed, beside phase 4's plain CG.  Returns the solve."""
    import torch

    from repro_torch.kernels import gse_spmv as K
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.robustness.guards import health_name
    from repro_torch.solvers import make_jacobi, solve_pcg

    t0 = time.perf_counter()
    m = make_jacobi(csr, k=8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    for mod in (K, V):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_pcg(g, b, m, tol=1e-8, maxiter=20000, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gse_spmv_csr_f64": K.gse_spmv_csr_f64.launches,
                "seq_dot": V.seq_dot.launches,
                "fma_axpy": V.fma_axpy.launches}
    a64_bodies = dict(K.gse_spmv_csr_f64.body_launches)
    iters = int(res.iters)
    log("pcg_full", rows=g.shape[0], nnz=g.nnz, precond="jacobi", iters=iters,
        switch_iters=res.switch_iters.tolist(), tag=int(res.tag),
        relres=float(res.relres), converged=bool(res.converged),
        health=health_name(res.health), setup_s=f"{setup_s:.2f}",
        wall_s=f"{wall:.2f}", ms_per_iteration=f"{wall * 1e3 / iters:.3f}",
        cg_iters=int(cg_res.iters), cg_wall_s=f"{cg_wall:.2f}",
        cg_ms_per_iteration=f"{cg_wall * 1e3 / int(cg_res.iters):.3f}",
        launches=json.dumps(launches), a64_body_launches=json.dumps(a64_bodies))
    if not bool(res.converged) or health_name(res.health) != "ok":
        raise AssertionError(f"phase 18 ended {health_name(res.health)} with "
                             f"converged={bool(res.converged)}")
    if not bool(torch.isfinite(res.x).all()) or min(launches.values()) <= 0:
        raise AssertionError(f"phase 18: non-finite x or a kernel of the "
                             f"PCG path never launched: {launches}")
    require_bodies("phase 18: A64", a64_bodies, plan_bodies(g))
    return res


def ir_case(device):
    """quickstart section 5's case on ``device``: the packed system of
    phase 17, its Jacobi, b and the second draw b' (the port's CSR SpMV
    on the host)."""
    import numpy as np
    import torch

    from repro_torch.solvers import make_jacobi
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr
    from repro_torch.sparse.spmv import spmv

    host = G.ill_conditioned_spd(32, decades=8.0, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    bs = [spmv(host, torch.from_numpy(rng.normal(size=host.shape[0])))
          for _ in range(2)]
    a = G.ill_conditioned_spd(32, decades=8.0, seed=0, device=device)
    return pack_csr(a, k=8), make_jacobi(a, k=8), *(b.to(device) for b in bs)


def ir_solve(where, name):
    """Phase 19's refinement ``name`` (IR_RUNS) on ``where``; the inner-CG
    row at IR_CG_CUT's budget.  Returns the result and the seconds."""
    from repro_torch.core.precision import MonitorParams
    from repro_torch.solvers import solve_ir

    inner, pre, restart = IR_RUNS[name]
    cut = IR_CG_CUT if name == "cg" else {}
    g, m, b, _ = ir_case(where)
    t0 = time.perf_counter()
    r = solve_ir(g, b, inner=inner, precond=m if pre else None,
                 restart=restart,
                 params=MonitorParams(**PCG_PARAMS) if inner == "cg" else None,
                 **dict(IR_KW, **cut))
    return r, time.perf_counter() - t0


def ir_batched_solve(where):
    """Phase 19's solve_ir_batched on [b, 2b, b', 0] on ``where``;
    returns the result and the seconds."""
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.solvers import solve_ir_batched

    g, m, b, b2 = ir_case(where)
    block = torch.stack([b, 2 * b, b2, torch.zeros_like(b)], dim=1)
    t0 = time.perf_counter()
    r = solve_ir_batched(g, block, precond=m, params=MonitorParams(
        **PCG_PARAMS), device=where, **IR_KW)
    return r, time.perf_counter() - t0


def phase_ir_trajectory(params, twins=None):
    """Phase 19: iterative refinement, batched PCG and the preconditioned
    service on the small cases, the card against the reference's numbers
    and the CPU twin."""
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.solvers import (make_gse_operator, make_precond_operator,
                                     solve_pcg, solve_pcg_batched)

    fast = MonitorParams(**PCG_PARAMS)
    cpu = twin_of(twins, "ir")
    for name, want in IR_REF.items():
        # The inner-CG row (10,400 launch-bound inner iterations, ~19 s on
        # the card) runs at the twin's cut budget only, to leave phases
        # 21-22 room in the time limit; its full counts are IR_REF's.
        cut = IR_CG_CUT if name == "cg" else {}
        rg, tg_s = ir_solve("cuda", name)
        got = (rg.outer_iters, rg.inner_iters, rg.relres)
        if not cut and (got != want or not rg.converged or rg.health != 0):
            raise AssertionError(f"IR {name} on the GPU: {got} != {want}")
        rc, tc_s = cpu[name]
        if (rc.outer_iters, rc.inner_iters) != (rg.outer_iters,
                                                rg.inner_iters):
            raise AssertionError(f"IR {name}: the GPU and the CPU twin "
                                 "disagree")
        require_bitwise(f"IR {name} x against the CPU twin", rg.x, rc.x)
        if rg.relres != rc.relres:
            raise AssertionError(f"IR {name} relres {rg.relres!r} != the "
                                 f"twin's {rc.relres!r}")
        log("ir_trajectory", case="illcond_32", run=name, outer=got[0],
            inner=got[1], relres=got[2], matches_reference=not cut,
            gpu_s=f"{tg_s:.2f}", cpu_s=f"{tc_s:.2f}",
            cpu_twin=json.dumps(cut) if cut else "full", cpu_twin_bitwise=True)

    rg, tg_s = ir_batched_solve("cuda")
    rc, tc_s = cpu["batched"]
    got = (rg.outer_iters.tolist(), rg.inner_iters.tolist(),
           rg.relres.tolist())
    if got != IR_BATCHED_REF:
        raise AssertionError(f"solve_ir_batched on the GPU: {got} != "
                             f"{IR_BATCHED_REF}")
    require_bitwise("solve_ir_batched x against the CPU twin", rg.x, rc.x)
    if rg.relres.tolist() != rc.relres.tolist():
        raise AssertionError("solve_ir_batched: the GPU's relres is not the "
                             "CPU twin's")
    log("ir_trajectory", case="illcond_32", run="batched [b, 2b, b', 0]",
        outer=got[0], inner=got[1], relres=got[2], matches_reference=True,
        gpu_s=f"{tg_s:.2f}", cpu_s=f"{tc_s:.2f}", cpu_twin_bitwise=True)

    # Batched PCG on quickstart section 4's cases: column j the solo solve.
    kw = dict(tol=1e-10, maxiter=5000, params=fast)
    for kind, want in PCG_REF.items():
        g, m, b = pcg_case(kind, "cuda")
        _, _, _, b2 = ir_case("cuda")
        block = torch.stack([b, b2, torch.zeros_like(b)], dim=1)
        t0 = time.perf_counter()
        fused = solve_pcg_batched(g, block, m, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        generic = solve_pcg_batched(make_gse_operator(g), block,
                                    make_precond_operator(m), **kw)
        for j, bj in enumerate((b, b2)):
            solo = solve_pcg(g, bj, m, **kw)
            if j == 0 and (int(solo.iters), solo.switch_iters.tolist(),
                           int(solo.tag)) != want:
                raise AssertionError(f"solo PCG {kind}: not {want}")
            if (int(fused.iters[j]), fused.switch_iters[j].tolist()) != (
                    int(solo.iters), solo.switch_iters.tolist()):
                raise AssertionError(f"batched PCG {kind} column {j} is not "
                                     "the solo solve")
            require_bitwise(f"batched PCG {kind} column {j} x against the "
                            "solo solve", fused.x[:, j], solo.x)
            require_bitwise(f"batched PCG {kind} column {j} relres",
                            fused.relres[j], solo.relres)
        for name in ("iters", "switch_iters", "health"):
            if not torch.equal(getattr(fused, name), getattr(generic, name)):
                raise AssertionError(f"batched PCG {kind}: fused {name} is "
                                     "not the generic path's")
        require_bitwise(f"batched PCG {kind}: fused x against generic",
                        fused.x, generic.x)
        log("ir_trajectory", case="illcond_32", batched_pcg=kind,
            iters=fused.iters.tolist(),
            switch_iters=fused.switch_iters.tolist(),
            columns_bitwise_solo=True, fused_bitwise_generic=True,
            gpu_s=f"{wall:.2f}")

    # The preconditioned service; at maxiter 4 the tag-3 PCG retry.
    for (kind, maxiter), (want, want_stats) in PCG_SERVICE_REF.items():
        svc_g, reps_g, xs_g, wall_g = serve_small("cuda", maxiter, params,
                                                  precond=kind)
        got = [report_key(r) for r in reps_g]
        if got != want or svc_g.stats != want_stats:
            raise AssertionError(f"{kind} service at maxiter {maxiter}: "
                                 f"{got} {svc_g.stats} != {want} "
                                 f"{want_stats}")
        twin = {}
        if maxiter == 4:
            reps_c, xs_c, wall_c = cpu["service", kind]
            for rg_, rc_, xg_, xc_ in zip(reps_g, reps_c, xs_g, xs_c):
                if report_fields(rg_) != report_fields(rc_):
                    raise AssertionError(f"GPU report {rg_} != CPU {rc_}")
                require_bitwise(f"{kind} service x of request {rg_.id}", xg_,
                                xc_)
            twin = dict(cpu_twin_bitwise=True, cpu_s=f"{wall_c:.2f}")
        log("ir_trajectory", case="rs8_400_s3", service_precond=kind,
            maxiter=maxiter, iters=[r.iters for r in reps_g],
            health=[r.health for r in reps_g],
            retries=[r.retries for r in reps_g],
            est_bytes=[r.est_bytes for r in reps_g], matches_reference=True,
            gpu_s=f"{wall_g:.2f}", **twin)


def phase_ir_full(csr, g, b, bs_full, params, pcg_res):
    """Phase 20: iterative refinement, batched IR and the preconditioned
    service on phase 4's matrix, launch counts zeroed."""
    import numpy as np
    import torch

    from repro_torch.kernels import gse_spmm as C
    from repro_torch.kernels import gse_spmv as K
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.robustness.guards import DEFAULT_GUARDS, health_name
    from repro_torch.solvers import ir as T_ir
    from repro_torch.solvers import make_jacobi, solve_ir_batched
    from repro_torch.solvers.cg import CHUNK

    m = make_jacobi(csr, k=8)
    torch.cuda.synchronize()
    for mod in (K, C, V):
        mod.reset_launch_counts()
    kw = dict(tol=1e-10, max_outer=10, inner_tol=1e-4, inner_maxiter=2000,
              params=params)
    # solve_ir's loop, driven a correction at a time to read each inner
    # solve's iterations.
    t0 = time.perf_counter()
    st = T_ir._ir_setup(g, b, inner="cg", precond=m, restart=30,
                        guards=DEFAULT_GUARDS, flight=None, **kw)
    each = []
    while T_ir._ir_active(st):
        before = st["total_inner"]
        T_ir._ir_step(st)
        each.append(st["total_inner"] - before)
    res = T_ir._ir_result(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = sum(-(-k // CHUNK) * CHUNK for k in each)
    log("ir_full", rows=g.shape[0], nnz=g.nnz, run="solve_ir inner PCG "
        "(jacobi)", outer=res.outer_iters, inner=res.inner_iters,
        inner_each=each, inner_run=run, relres=res.relres,
        history=json.dumps(res.history.tolist()),
        health=health_name(res.health), wall_s=f"{wall:.2f}")
    if not res.converged or health_name(res.health) != "ok":
        raise AssertionError(f"phase 20: solve_ir ended "
                             f"{health_name(res.health)}, relres "
                             f"{res.relres!r}")

    block = torch.stack([b, bs_full[1], bs_full[2], 2 * b], dim=1)
    t0 = time.perf_counter()
    rb = solve_ir_batched(g, block, precond=m, **kw)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    log("ir_full", run="solve_ir_batched [b, b2, b3, 2b]",
        outer=rb.outer_iters.tolist(), inner=rb.inner_iters.tolist(),
        relres=rb.relres.tolist(), health=rb.health.tolist(),
        wall_s=f"{wall_b:.2f}")
    if (int(rb.outer_iters[0]), int(rb.inner_iters[0])) != (
            res.outer_iters, res.inner_iters) or rb.relres[0] != res.relres:
        raise AssertionError("phase 20: batched IR column 0 is not the solo "
                             "run")
    require_bitwise("phase 20: batched IR column 0 x against the solo run",
                    rb.x[:, 0], res.x)
    if rb.relres[3] != rb.relres[0]:
        raise AssertionError("phase 20: 2b's relres is not b's")
    require_bitwise("phase 20: 2b's x against twice b's", rb.x[:, 3],
                    2 * rb.x[:, 0])
    if not bool(np.all(rb.converged)):
        raise AssertionError(f"phase 20: batched IR health {rb.health}")

    t0 = time.perf_counter()
    svc = SolverService(slots=NRHS, params=params, maxiter=20000)
    svc.register("full", csr, k=8, precond="jacobi")
    ids = [svc.submit("full", bj, tol=1e-8) for bj in bs_full]
    reports = svc.flush()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    reps = [reports[i] for i in ids]
    x0 = svc.solution(ids[0])
    log("ir_full", run="SolverService precond=jacobi",
        iters=[r.iters for r in reps], health=[r.health for r in reps],
        retries=[r.retries for r in reps],
        est_bytes=[r.est_bytes for r in reps],
        stats=json.dumps(dict(svc.stats)),
        wall_s=f"{wall_s:.2f}")
    if (reps[0].iters, reps[0].switch_iters.tolist(), reps[0].tag) != (
            int(pcg_res.iters), pcg_res.switch_iters.tolist(),
            int(pcg_res.tag)) or reps[0].relres != float(pcg_res.relres):
        raise AssertionError(f"phase 20: request 0 {reps[0]} is not phase "
                             "18's solo PCG")
    require_bitwise("phase 20: request 0's x against phase 18's solo PCG",
                    x0, pcg_res.x)
    for r in reps:
        if not r.converged or r.health != "ok" or r.retries != 0:
            raise AssertionError(f"phase 20: request {r.id}: {r}")
    if svc.stats["errors"] != 0:
        raise AssertionError(f"phase 20: service errors {svc.stats}")

    launches = {"gse_spmv_csr_f64": K.gse_spmv_csr_f64.launches,
                "gse_spmm_csr_f64": C.gse_spmm_csr_f64.launches,
                "seq_dot": V.seq_dot.launches,
                "fma_axpy": V.fma_axpy.launches,
                "seq_dot_cols": V.seq_dot_cols.launches,
                "fma_axpy_cols": V.fma_axpy_cols.launches}
    log("ir_full", launches=json.dumps(launches),
        a64_body_launches=json.dumps(dict(K.gse_spmv_csr_f64.body_launches)),
        c64_body_launches=json.dumps(dict(C.gse_spmm_csr_f64.body_launches)))
    if min(launches.values()) <= 0:
        raise AssertionError(f"phase 20: a kernel of the IR path never "
                             f"launched: {launches}")
    require_bodies("phase 20: A64", K.gse_spmv_csr_f64.body_launches,
                   plan_bodies(g))
    require_bodies("phase 20: C64", C.gse_spmm_csr_f64.body_launches,
                   plan_bodies(g))
    return res, m


def plan_depth(plan) -> int:
    """The longest chain of dependent steps of a ``vec_f64.sliced_plan``
    (an FMA extends its accumulator's chain, an add joins two)."""
    from repro_torch.kernels import vec_f64 as V

    depth = [0] * V.SLICED_SLOTS
    for kind, a, b in plan:
        if kind == V.STEP_FMA:
            depth[a] += 1
        elif kind == V.STEP_ADD:
            depth[a] = max(depth[a], depth[b]) + 1
        else:
            depth[a] = 0
    return depth[0]


def gmres_entries(ctx, launches, add_entry, chain_ms):
    """Phase 10's rows for the GMRES kernels: the GEMVs at n = 2^20 and
    81 rows (phase 15's operands), the rotations at j = 79 and the back
    substitution at j = 80 of a restart-80 cycle; launches from phase 16."""
    import torch

    from repro_torch.kernels import gmres_f64 as GF
    from repro_torch.kernels import vec_f64 as V

    card, host, err, lsq = ctx["card"], ctx["host"], ctx["err"], ctx["lsq"]
    rows, n = card["V"].shape
    vec_src = "src/repro_torch/kernels/csrc/vec_f64.cu"
    gm_src = "src/repro_torch/kernels/csrc/gmres_f64.cu"
    basis = rows * n * 8
    add_entry("gemv_rows_ref", vec_src, "src/repro/solvers/gmres.py:147",
              lambda: V.gemv_rows_ref(card["V"], card["w"], rows),
              lambda: V.gemv_rows_ref_plain(host["V"], host["w"], rows),
              lambda: torch.mv(card["V"], card["w"]),
              basis + n * 8 + rows * 8,
              2 * rows * n / FP64_OPS_PER_S * 1e3, plain_reps=1, rows=rows,
              n=n, launches=launches["gemv_rows_ref"],
              max_abs_err=err["gemv_rows_ref"],
              chain_bound_ms=chain_ms(n // V.GEMV_LANES, "fma"),
              plain_on="host")
    add_entry("gemv_cols_ref", vec_src, "src/repro/solvers/gmres.py:148",
              lambda: V.gemv_cols_ref(card["c"], card["V"], rows),
              lambda: V.gemv_cols_ref_plain(host["c"], host["V"], rows),
              lambda: torch.mv(card["V"].t(), card["c"]),
              basis + rows * 8 + n * 8,
              2 * rows * n / FP64_OPS_PER_S * 1e3, plain_reps=1, rows=rows,
              n=n, launches=launches["gemv_cols_ref"],
              max_abs_err=err["gemv_cols_ref"],
              chain_bound_ms=chain_ms(rows, "fma"), plain_on="host")
    rows_s = GMRES_RESTART
    depth = plan_depth(V.sliced_plan(rows_s))
    add_entry("gemv_cols_sliced_ref", vec_src,
              "src/repro/solvers/gmres.py:220",
              lambda: V.gemv_cols_sliced_ref(card["c"], card["V"], rows_s),
              lambda: V.gemv_cols_sliced_ref_plain(host["c"], host["V"],
                                                   rows_s),
              lambda: torch.mv(card["V"][:rows_s].t(), card["c"][:rows_s]),
              rows_s * n * 8 + rows_s * 8 + n * 8,
              2 * rows_s * n / FP64_OPS_PER_S * 1e3, plain_reps=1,
              rows=rows_s, n=n, plan_steps=len(V.sliced_plan(rows_s)),
              launches=launches["gemv_cols_sliced_ref"],
              max_abs_err=err["gemv_cols_sliced_ref"],
              chain_bound_ms=chain_ms(depth, "fma"), chain_steps=depth,
              plain_on="host")
    restart = GMRES_RESTART
    j = restart - 1
    st = lsq["givens"]
    st_host = [t.cpu() for t in st]
    on = torch.ones((), dtype=torch.bool, device=st[0].device)
    add_entry("givens_step", gm_src, "src/repro/solvers/gmres.py:154",
              lambda: GF.givens_step(st[0][:j + 1].contiguous(), *st[1:], on, j),
              lambda: GF.givens_step_plain(st_host[0][:j + 1], *st_host[1:],
                                           torch.tensor(True), j),
              None, (2 * j + 4 * restart + 6) * 8,
              (6 * j + 20) / FP64_OPS_PER_S * 1e3, plain_reps=3, j=j,
              restart=restart, launches=launches["givens_step"],
              max_abs_err=0.0, chain_bound_ms=chain_ms(2 * j + 6, "fma"),
              plain_on="host")
    jt = torch.tensor(restart, dtype=torch.int32, device=lsq["tri"].device)
    tri_host, g_host = lsq["tri"].cpu(), lsq["g"].cpu()
    dense = torch.triu(lsq["tri"][:restart]).contiguous()
    add_entry("trsv_upper_ref", gm_src, "src/repro/solvers/gmres.py:219",
              lambda: GF.trsv_upper_ref(lsq["tri"], lsq["g"], jt),
              lambda: GF.trsv_upper_ref_plain(tri_host, g_host, restart),
              lambda: torch.linalg.solve_triangular(
                  dense, lsq["g"][:restart, None], upper=True),
              (restart * (restart + 1) // 2 + 2 * restart) * 8,
              restart * restart / FP64_OPS_PER_S * 1e3, plain_reps=3,
              restart=restart, j=restart,
              launches=launches["trsv_upper_ref"], max_abs_err=0.0,
              chain_bound_ms=chain_ms(sum(
                  restart - hi + 2 * (hi - lo)
                  for lo, hi in GF._trsm_blocks(restart)), "fma"),
              plain_on="host")


def ell_earlier(tree) -> dict:
    """A32's and C32's times in the checkout ``tree`` on phase 2's operator:
    tools/time_ell_kernels.py run there in a process of its own (it builds
    that tree's kernels into its own build directory)."""
    import torch

    torch.cuda.empty_cache()  # room for the other process's operator
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "time_ell_kernels.py"),
         "--tree", str(tree)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"time_ell_kernels.py on {tree} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    log("kernels", earlier_tree=tree, earlier=json.dumps(res))
    return res


# Phases 21-22: per-group precision.  The reference's numbers, printed by
# tools/reference/adaptive_ref.py (JAX on the CPU): solve_adaptive on three
# rows (b four unit spikes, spikes()), solve_cg with the third row's map,
# and SolverService with tags 2, the uniform tag-2 map and "adaptive".
ADAPTIVE_REF = {
    "illcond16": dict(iters=775, true_relres=0.001977506605066215,
                      counts={1: 16, 2: 16, 3: 0}, crc32=875809022,
                      promotions=[[771, 16]], spmv_bytes=6640100, chunks=9,
                      x_crc32=2128836402),
    "skewed1024": dict(iters=150, true_relres=0.0008890353209770497,
                       counts={1: 96, 2: 32, 3: 0}, crc32=3722713979,
                       promotions=[[0, 32]], spmv_bytes=132254620, chunks=2,
                       x_crc32=1913843695),
    "skewed65536": dict(iters=163, true_relres=0.0009814771908534562,
                        counts={1: 8179, 2: 13, 3: 0}, crc32=1685813607,
                        promotions=[[0, 13]], spmv_bytes=8404983064,
                        chunks=2, x_crc32=3524899944),
}
TAGMAP_CG_REF = dict(iters=238, relres=9.986606434730945e-05,
                     switch_iters=[-1, -1], x_crc32=1948789992)
SERVICE_TAGS_REF = dict(
    reports=[[33, 2.9570042859308644e-09, True, 2, 94314],
             [33, 2.9570042859308644e-09, True, 2, 94314],
             [33, 2.957004108704624e-09, True, 1, 114620]],
    stats={"batches": 2, "requests": 3, "padded_cols": 0,
           "modeled_bytes": 303248, "retries": 0, "errors": 0,
           "deadline_exceeded": 0},
    x_crc32=[1281899057, 1281899057, 1281899057])
# name: (matrix on a device, solve_adaptive keywords, run on the CPU twin)
ADAPTIVE_ROWS = {
    "illcond16": (lambda G, dev: G.ill_conditioned_spd(16, decades=8.0,
                                                       seed=0, device=dev),
                  dict(profile="explore", tol=2e-3, maxiter=4000), True),
    "skewed1024": (lambda G, dev: G.diag_rescale(
        G.skewed_spd(n=1024, device=dev), 6.0, 11),
        dict(profile="neumann", tol=1e-3, maxiter=1500), True),
    # The twin of this row would take ~110 s of host CG iterations; the
    # card is held to the reference's x digest instead.
    "skewed65536": (lambda G, dev: G.diag_rescale(
        G.skewed_spd(n=65536, seed=5, device=dev), 6.0, 11),
        dict(profile="neumann", tol=1e-3, maxiter=20000), False),
}
ADAPTIVE_TOL = 1e-3  # phase 22's tol (moved between the floors if uniform)
ADAPTIVE_DECADES = 3.0  # phase 22's diag_rescale decades (PERF.md)


def spikes(m: int, count: int = 4, seed: int = 7):
    """Four unit spikes at ``default_rng(seed).choice(m, count)``: the
    adaptive benchmark's right-hand side, exact on every device."""
    import numpy as np

    b = np.zeros(m)
    b[np.random.default_rng(seed).choice(m, count, replace=False)] = 1.0
    return b


def crc_f64(x) -> int:
    """crc32 of a tensor's f64 bytes (the reference script's digest)."""
    import zlib

    import numpy as np

    return zlib.crc32(np.ascontiguousarray(
        x.detach().cpu().numpy().astype(np.float64)).tobytes())


def adaptive_fields(r) -> dict:
    """The fields of an AdaptiveResult ADAPTIVE_REF records."""
    return dict(iters=int(r.iters), true_relres=float(r.true_relres),
                counts=r.tagmap.tag_counts(), crc32=int(r.tagmap.crc32),
                promotions=[[int(p.it), int(p.n_promoted)]
                            for p in r.promotions],
                spmv_bytes=int(r.spmv_bytes), chunks=int(r.chunks),
                x_crc32=crc_f64(r.x))


def phase_tagmap_trajectory():
    """Phase 21: the per-group precision axis on small cases, the card
    against the reference's numbers and the CPU twin."""
    import numpy as np
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.core.tagmap import TagMap
    from repro_torch.kernels import ops
    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.solvers import (make_gse_operator, make_jacobi,
                                     solve_adaptive, solve_cg,
                                     solve_cg_batched, solve_ir, solve_pcg,
                                     solve_pcg_batched)
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    dev = torch.device("cuda")
    maps = {}
    for name, (make, kw, twin) in ADAPTIVE_ROWS.items():
        out = {}
        for where in ("cuda", "cpu") if twin else ("cuda",):
            g = pack_csr(make(G, where), k=8)
            b = torch.from_numpy(spikes(g.shape[0])).to(where)
            t0 = time.perf_counter()
            r = solve_adaptive(g, b, **kw)
            out[where] = (r, time.perf_counter() - t0, g, b)
        r, wall, g, b = out["cuda"]
        got = adaptive_fields(r)
        if got != ADAPTIVE_REF[name] or not r.converged:
            raise AssertionError(f"solve_adaptive {name} on the GPU: {got} "
                                 f"!= {ADAPTIVE_REF[name]}")
        extra = {}
        if twin:
            rc, cpu_s, _, _ = out["cpu"]
            if adaptive_fields(rc) != got:
                raise AssertionError(f"solve_adaptive {name}: the CPU twin "
                                     "disagrees")
            require_bitwise(f"solve_adaptive {name} x against the CPU twin",
                            r.x, rc.x)
            extra = dict(cpu_twin_bitwise=True, cpu_s=f"{cpu_s:.2f}")
        log("tagmap", case=name, profile=kw["profile"], tol=kw["tol"],
            iters=got["iters"], true_relres=got["true_relres"],
            counts=json.dumps(got["counts"]), crc32=hex(got["crc32"]),
            promotions=got["promotions"], spmv_bytes=got["spmv_bytes"],
            chunks=got["chunks"], x_matches_reference_digest=True,
            matches_reference=True, gpu_s=f"{wall:.2f}", **extra)
        maps[name] = (r.tagmap, g, b)

    # Uniform maps are the int tag, bitwise, on the card.
    a = G.poisson2d(10, device=dev)
    g = pack_csr(a, k=8)
    m = g.shape[0]
    rng = np.random.default_rng(3)
    host = G.poisson2d(10, device="cpu")
    b = torch.from_numpy(host_spmv(host, rng.normal(size=m))).to(dev)
    block = torch.stack([torch.from_numpy(host_spmv(host, rng.normal(
        size=m))).to(dev) for _ in range(4)], dim=1)
    fast = MonitorParams(**PCG_PARAMS)
    kw = dict(tol=1e-8, maxiter=2000, params=fast)
    pre = make_jacobi(a, k=8)
    sell = ops.sell_pack_gsecsr(g)

    def uni(t):
        return TagMap.for_rows(m, t)

    checks = []
    for t in TAGS:
        want = solve_cg(g, b, init_tag=t, **kw)
        for axis in (t, uni(t)):
            checks.append((f"CG fused tag {t}", solve_cg(g, b, tags=axis,
                                                         **kw), want))
    op = make_gse_operator(g)
    checks.append(("CG generic", solve_cg(op, b, tags=uni(2), **kw),
                   solve_cg(op, b, init_tag=2, **kw)))
    want = solve_pcg(g, b, pre, init_tag=2, **kw)
    for axis in (2, uni(2)):
        checks.append(("PCG fused", solve_pcg(g, b, pre, tags=axis, **kw),
                       want))
    checks.append(("CG over SELL", solve_cg(sell, b, tags=uni(1), **kw),
                   solve_cg(sell, b, init_tag=1, **kw)))
    for nrhs in (1, 4):
        checks.append((f"batched CG nrhs {nrhs}",
                       solve_cg_batched(g, block[:, :nrhs], tags=uni(1),
                                        **kw),
                       solve_cg_batched(g, block[:, :nrhs], **kw)))
    checks.append(("batched PCG", solve_pcg_batched(g, block, pre,
                                                    tags=uni(2), **kw),
                   solve_pcg_batched(g, block, pre, tags=2, **kw)))
    ir_kw = dict(tol=1e-12, max_outer=6, inner_tol=1e-4, inner_maxiter=800,
                 params=fast)
    checks.append(("IR", solve_ir(g, b, tags=uni(1), **ir_kw),
                   solve_ir(g, b, **ir_kw)))
    for what, got, want in checks:
        require_bitwise(f"uniform map {what}", got.x, want.x)
        if hasattr(got, "inner_iters"):  # IR
            gi, wi = (got.inner_iters, got.outer_iters), (want.inner_iters,
                                                          want.outer_iters)
        else:
            gi, wi = got.iters.tolist(), want.iters.tolist()
        if gi != wi:
            raise AssertionError(f"uniform map {what}: iters {gi} != {wi}")
    log("tagmap", check="uniform map == int tag", case="poisson2d(10)",
        solves=len(checks), bitwise=True,
        runs=json.dumps([w for w, _, _ in checks]))

    # The 65536 row's map through solve_cg, over the CSR and the SELL pack.
    tm, g65, b65 = maps["skewed65536"]
    sell65 = ops.sell_pack_gsecsr(g65)
    runs = {}
    for lay, op in (("csr", g65), ("sell", sell65)):
        t0 = time.perf_counter()
        runs[lay] = solve_cg(op, b65, tags=tm, tol=1e-4, maxiter=400)
        torch.cuda.synchronize()
        runs[lay + "_s"] = time.perf_counter() - t0
    rc_, rs_ = runs["csr"], runs["sell"]
    got = dict(iters=int(rc_.iters), relres=float(rc_.relres),
               switch_iters=rc_.switch_iters.tolist(),
               x_crc32=crc_f64(rc_.x))
    if got != TAGMAP_CG_REF:
        raise AssertionError(f"solve_cg(tags=tm) on the GPU: {got} != "
                             f"{TAGMAP_CG_REF}")
    require_bitwise("solve_cg(tags=tm): SELL against CSR", rs_.x, rc_.x)
    log("tagmap", check="solve_cg(tags=tm), skewed65536's map",
        iters=got["iters"], relres=got["relres"], csr_sell_bitwise=True,
        matches_reference=True, csr_s=f"{runs['csr_s']:.2f}",
        sell_s=f"{runs['sell_s']:.2f}")
    del sell65, runs

    # The service's tags axis.
    b = torch.from_numpy(spikes(m)).to(dev)
    svc = SolverService(slots=2, maxiter=3000, device=dev)
    svc.register("p", a, k=8)
    ids = [svc.submit("p", b, tol=1e-8, tags=t)
           for t in (2, uni(2), "adaptive")]
    reps = svc.flush()
    got = dict(reports=[[reps[i].iters, reps[i].relres, reps[i].converged,
                         reps[i].tag, reps[i].est_bytes] for i in ids],
               stats=dict(svc.stats),
               x_crc32=[crc_f64(svc.solution(i)) for i in ids])
    if got != SERVICE_TAGS_REF:
        raise AssertionError(f"service tags on the GPU: {got} != "
                             f"{SERVICE_TAGS_REF}")
    log("tagmap", check="SolverService tags=2, uniform map, adaptive",
        reports=json.dumps(got["reports"]), stats=json.dumps(got["stats"]),
        int_equals_uniform_map=True, matches_reference=True)


def mixed_check(what, sell, tm, x32, x32n) -> dict:
    """``ops.gse_spmv_sell``/``gse_spmm_sell`` with ``tag=tm`` over
    ``masked_for_tagmap(sell, tm)`` (a mixed launch of B32 and C′32 when
    the buckets' tags differ, else the uniform launch): bitwise the plain
    versions and, bucket for bucket, the uniform launch at the bucket's
    tag over the same masked pack.  Returns the max abs errors and the
    two entry-point launches' counts (mixed, per body)."""
    import torch

    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops

    dev = x32.device
    m = sell.shape[0]
    masked = ops.masked_for_tagmap(sell, tm)
    btags = ops.sell_bucket_tags(sell, tm)
    K.reset_launch_counts()
    C.reset_launch_counts()
    y = ops.gse_spmv_sell(masked, x32, tag=tm)
    yc = ops.gse_spmm_sell(masked, x32n, tag=tm, device=dev)
    counts = dict(b32_mixed=K.gse_spmv_sell_f32.mixed_launches,
                  c32_mixed=C.gse_spmm_sell_f32.mixed_launches,
                  b32_bodies=dict(K.gse_spmv_sell_f32.body_launches),
                  c32_bodies=dict(C.gse_spmm_sell_f32.body_launches))
    scales = ops._scales_by_tag(sell.table)
    top = max(btags)
    segs = masked.segments
    lay = dict(rows=m, ei_bit=sell.ei_bit)
    want = K.gse_spmv_sell_f32_plain(
        segs[0], segs[1], segs[2] if top >= 2 else None,
        segs[3] if top == 3 else None, x32, scales, sell.bucket_table,
        sell.perm, tag=top, bucket_tags=btags, **lay)
    require_bitwise(f"{what}: B32 against its plain version", y, want)
    want_c = C.gse_spmm_sell_f32_plain(
        segs[0], segs[1], segs[2] if top >= 2 else None,
        segs[3] if top == 3 else None, x32n, scales, sell.bucket_table,
        sell.perm, tag=top, bucket_tags=btags, **lay)
    require_bitwise(f"{what}: C′32 against its plain version", yc, want_c)
    errs = (float((y - want).abs().max()), float((yc - want_c).abs().max()))
    del want, want_c
    perm = sell.perm.to(torch.int64)
    first = sell.bucket_table[:, 0].tolist() + [perm.shape[0]]
    for t in sorted(set(btags)):
        seg_t = (segs[0], segs[1], segs[2] if t >= 2 else None,
                 segs[3] if t == 3 else None)
        uy = K.gse_spmv_sell_f32(*seg_t, x32, scales[t - 1],
                                 sell.bucket_table, sell.perm, tag=t,
                                 long_from=sell.long_from, **lay)
        uc = C.gse_spmm_sell_f32(*seg_t, x32n, scales[t - 1],
                                 sell.bucket_table, sell.perm, tag=t,
                                 long_from=sell.long_from, device=dev, **lay)
        for i, bt_i in enumerate(btags):
            if bt_i != t:
                continue
            rows = perm[first[i]:first[i + 1]]
            rows = rows[rows >= 0]
            require_bitwise(f"{what}: B32 bucket {i} against the uniform "
                            f"launch at tag {t}", y[rows], uy[rows])
            require_bitwise(f"{what}: C′32 bucket {i} against the uniform "
                            f"launch at tag {t}", yc[rows], uc[rows])
    log("adaptive", check=f"B32 and C′32 with tag=TagMap on {what}",
        widths=list(sell.widths), bucket_rows=list(sell.bucket_rows),
        bucket_tags=list(btags),
        groups_by_tag=json.dumps(tm.tag_counts()),
        bytes_touched_map=sell.bytes_touched(tm),
        bytes_touched_max_tag=sell.bytes_touched(tm.max_tag),
        launches=json.dumps(counts), b32_bitwise_plain=True,
        c32_bitwise_plain=True, bitwise_uniform_per_bucket=True)
    return dict(errs=errs, **counts)


def bucket_maps(sell) -> dict:
    """Maps on phase 22's SELL view whose bucket tags differ, named by
    them.  Its buckets are the bulk, a middle bucket and the hub rows;
    the hub rows reach every column, so their bucket takes the map's max
    tag, and a group promoted in the bulk lifts the bulk.  ``far``, a bulk
    group no middle row touches (as a row or a column), at the high tag
    leaves the middle bucket at tag 1 ("212", "313"); ``far`` at 3 and a
    middle row's group at 2 give "323"."""
    import numpy as np
    import torch

    from repro_torch.core.tagmap import GROUP_SIZE, TagMap
    from repro_torch.sparse.csr import _col_of

    if sell.n_buckets != 3:
        raise AssertionError(f"phase 22's SELL view has buckets "
                             f"{sell.widths}, not bulk, middle and hubs")
    n = sell.shape[0]
    n_groups = -(-n // GROUP_SIZE)
    perm = sell.perm.to(torch.int64)
    tab = sell.bucket_table.tolist()
    first = [r[0] for r in tab] + [perm.shape[0]]

    def rows_of(b):
        r = perm[first[b]:first[b + 1]]
        return r[r >= 0]

    _, w, off = tab[1]
    cols = _col_of(sell.segments[0][off:off + (first[2] - first[1]) * w],
                   sell.ei_bit).clamp(max=n - 1)
    mid = rows_of(1)
    near = torch.zeros(n_groups, dtype=torch.bool, device=perm.device)
    near[torch.cat([mid, cols]) // GROUP_SIZE] = True
    hub = torch.zeros_like(near)
    hub[rows_of(2) // GROUP_SIZE] = True
    far = int(torch.nonzero(~near & ~hub)[0, 0])
    mid_g = mid // GROUP_SIZE
    mid_g = int(mid_g[~hub[mid_g]][0])
    maps = {}
    for name, promote in (("212", {far: 2}), ("313", {far: 3}),
                          ("323", {far: 3, mid_g: 2})):
        tags = np.ones(n_groups, np.uint8)
        for grp, t in promote.items():
            tags[grp] = t
        tm = TagMap(tags)
        if "".join(map(str, sell.bucket_tags(tm))) != name:
            raise AssertionError(f"map {name}: bucket tags "
                                 f"{sell.bucket_tags(tm)}")
        maps[name] = tm
    return maps


def phase_adaptive_full():
    """Phase 22: the adaptive driver at full size, counted, then B32 and
    C′32 with ``tag=TagMap`` on its SELL view: the planned map, and maps
    whose bucket tags differ (the mixed launches, the hub rows' block
    body included).  Returns what phase 10 times."""
    import numpy as np
    import torch

    from repro_torch.core import precision as P
    from repro_torch.kernels import gse_spmv as K, ops
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.solvers import solve_adaptive
    from repro_torch.solvers.adaptive import _abs_neumann_profile
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # Phase 9's construction, hub rows included, at ADAPTIVE_DECADES of
    # rescale (PERF.md: at the 65536 row's 6 decades the hubs' diagonals
    # take the top shared exponent, 152,660 diagonal heads decode to 0 at
    # tag 1 and the driver does not converge; tools/tag1_probe.py).
    csr = G.diag_rescale(skewed_base(dev, last=True), ADAPTIVE_DECADES, 11)
    g = pack_csr(csr)
    del csr
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    m = g.shape[0]
    b_host = spikes(m)
    b = torch.from_numpy(b_host).to(dev)
    bnorm = float(np.linalg.norm(b_host))
    # The floors the planner models for uniform tags 1 and 2, relative to
    # ||b||, from the neumann profile (uncounted; the host copy and the
    # decodes stay cached on the pack for the driver).
    t0 = time.perf_counter()
    sc = P.decode_error_scores(g, _abs_neumann_profile(g, b_host))
    floors = [float(np.sqrt(sc[k].sum())) / bnorm for k in (0, 1)]
    tol = ADAPTIVE_TOL
    if P.plan_tagmap(sc, 0.25 * tol * bnorm).is_uniform:
        tol = float(np.sqrt(floors[0] * floors[1])) / 0.25
    floors_s = time.perf_counter() - t0
    for mod in (K, V):
        mod.reset_launch_counts()
    stages = {}
    t0 = time.perf_counter()
    r = solve_adaptive(g, b, tol=tol, maxiter=20000, profile="neumann",
                       timings=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a64 = dict(K.gse_spmv_csr_f64.body_launches)
    counts = {"a64": K.gse_spmv_csr_f64.launches,
              "seq_dot": V.seq_dot.launches, "fma_axpy": V.fma_axpy.launches}
    tm = r.tagmap
    tc = tm.tag_counts()
    cheapest = (r.iters + 1) * g.bytes_touched(2) + g.bytes_touched(3)
    log("adaptive", case=f"diag_rescale(skewed_spd({N_SKEW}, seed=5), "
        f"{ADAPTIVE_DECADES:g}, 11)", nnz=g.nnz, tol=tol,
        planned_floor_tag1=floors[0],
        planned_floor_tag2=floors[1], iters=r.iters,
        true_relres=r.true_relres, converged=r.converged,
        groups_by_tag=json.dumps(tc), crc32=hex(tm.crc32),
        promotions=[[p.it, p.n_promoted] for p in r.promotions],
        chunks=r.chunks, spmv_bytes=r.spmv_bytes,
        cheapest_uniform_bytes=cheapest,
        bytes_share=f"{r.spmv_bytes / cheapest:.4f}",
        generate_pack_s=f"{gen_s:.2f}", floors_s=f"{floors_s:.2f}",
        plan_s=f"{stages.get('plan', 0.0):.2f}",
        mask_s=f"{stages.get('mask', 0.0):.2f}",
        solve_s=f"{stages.get('solve', 0.0):.2f}",
        true_residual_s=f"{stages.get('true_residual', 0.0):.2f}",
        wall_s=f"{wall:.2f}", a64_launches=counts["a64"],
        a64_body_launches=json.dumps(a64),
        seq_dot_launches=counts["seq_dot"],
        fma_axpy_launches=counts["fma_axpy"])
    if not (r.converged and r.true_relres <= tol):
        raise AssertionError(f"adaptive full size: not converged ({r})")
    if tm.is_uniform or tc[2] + tc[3] >= tm.n_groups / 2:
        raise AssertionError(f"adaptive full size: the map {tm} is uniform "
                             "or promotes half the groups")
    if not r.spmv_bytes < cheapest:
        raise AssertionError(f"adaptive full size: {r.spmv_bytes} bytes, "
                             f"not below the cheapest uniform {cheapest}")
    if min(counts.values()) <= 0:
        raise AssertionError("a kernel of the adaptive path never launched")
    if "block" not in plan_bodies(g):
        raise AssertionError("phase 22's operator has no hub rows: A64's "
                             "block body would not run")
    require_bodies("phase 22: A64", a64, plan_bodies(g))

    t0 = time.perf_counter()
    sell = ops.sell_pack_gsecsr(g)
    maps = {"planned": tm, **bucket_maps(sell)}
    for tm_i in maps.values():
        ops.masked_for_tagmap(sell, tm_i)
    torch.cuda.synchronize()
    sell_s = time.perf_counter() - t0
    rng = np.random.default_rng(22)
    x32 = torch.from_numpy(rng.normal(size=m).astype(np.float32)).to(dev)
    x32n = torch.from_numpy(rng.normal(size=(m, NRHS)).astype(
        np.float32)).to(dev)
    checks = {name: mixed_check(f"phase 22's SELL view, map {name}", sell,
                                tm_i, x32, x32n)
              for name, tm_i in maps.items()}
    for name, got in checks.items():
        if name == "planned":
            continue
        if got["b32_mixed"] != 1 or got["c32_mixed"] != 1:
            raise AssertionError(f"map {name}: the mixed launches did not "
                                 f"run ({got})")
        require_bodies(f"phase 22: mixed B32, map {name}", got["b32_bodies"],
                       sell_bodies(sell))
        require_bodies(f"phase 22: mixed C′32, map {name}",
                       got["c32_bodies"], sell_bodies(sell))
    log("adaptive", sell_pack_mask_s=f"{sell_s:.2f}",
        mixed_launches=json.dumps({k: [v["b32_mixed"], v["c32_mixed"]]
                                   for k, v in checks.items()}))
    return dict(g=g, sell=sell, maps=maps, checks=checks, x32=x32,
                x32n=x32n)


def mixed_entries(ctx, add_entry):
    """Phase 10's entries for the mixed launch of B32 and C′32 on phase
    22's operator and map "212" (buckets at 2, 1, 2): bound
    ``sell.bytes_touched(tm)`` plus the vectors, with the uniform launch at
    the map's max tag over the same masked pack beside it
    (``uniform_max_tag_ms``, its bytes ``uniform_bytes``), the entry point
    ``ops.gse_spmv_sell(masked, x, tag=tm)`` (``ops_ms``) and that entry
    point on the planned map (``planned_map_ms``)."""
    import torch

    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops, ref

    g, sell = ctx["g"], ctx["sell"]
    tm, planned = ctx["maps"]["212"], ctx["maps"]["planned"]
    check = ctx["checks"]["212"]
    x32, x32n = ctx["x32"], ctx["x32n"]
    dev = x32.device
    m, n = g.shape
    masked = ops.masked_for_tagmap(sell, tm)
    masked_planned = ops.masked_for_tagmap(sell, planned)
    btags = ops.sell_bucket_tags(sell, tm)
    top = max(btags)
    segs = masked.segments
    t1 = segs[2] if top >= 2 else None
    t2 = segs[3] if top == 3 else None
    scales = ops._scales_by_tag(sell.table)
    lay = dict(rows=m, ei_bit=g.ei_bit)
    kw = dict(tag=top, long_from=sell.long_from, **lay)
    # The library call: torch.sparse CSR over the per-entry decode (the
    # masked CSR at the map's max tag).
    gm = ops.masked_for_tagmap(g, tm)
    vals32 = ref.decode_csr_ref(gm.colpak, gm.head, gm.tail1, gm.tail2,
                                gm.table, gm.ei_bit, top)
    cols = (g.colpak.to(torch.int64) & ((1 << (32 - g.ei_bit)) - 1)).to(
        torch.int32)
    lib32 = torch.sparse_csr_tensor(g.rowptr, cols, vals32, (m, n))
    # Real entries per bucket tag (the decode's operations follow them).
    real = {t: 0 for t in TAGS}
    first = sell.bucket_table[:, 0].tolist() + [sell.perm.shape[0]]
    for i, t in enumerate(btags):
        real[t] += int(sell.row_len[first[i]:first[i + 1]].sum())
    src = "src/repro_torch/kernels/csrc/gse_sell.cu"
    for (name, launch, uniform, plain, lib, entry, entry_planned, ncols,
         err, count) in (
        ("gse_spmv_sell_f32.mixed",
         lambda: K.gse_spmv_sell_f32(segs[0], segs[1], t1, t2, x32, scales,
                                     sell.bucket_table, sell.perm,
                                     bucket_tags=btags, **kw),
         lambda: K.gse_spmv_sell_f32(segs[0], segs[1], t1, t2, x32,
                                     scales[top - 1], sell.bucket_table,
                                     sell.perm, **kw),
         lambda: K.gse_spmv_sell_f32_plain(segs[0], segs[1], t1, t2, x32,
                                           scales, sell.bucket_table,
                                           sell.perm, tag=top,
                                           bucket_tags=btags, **lay),
         lambda: torch.mv(lib32, x32),
         lambda: ops.gse_spmv_sell(masked, x32, tag=tm),
         lambda: ops.gse_spmv_sell(masked_planned, x32, tag=planned),
         1, check["errs"][0], check["b32_mixed"]),
        ("gse_spmm_sell_f32.mixed",
         lambda: C.gse_spmm_sell_f32(segs[0], segs[1], t1, t2, x32n, scales,
                                     sell.bucket_table, sell.perm,
                                     bucket_tags=btags, device=dev, **kw),
         lambda: C.gse_spmm_sell_f32(segs[0], segs[1], t1, t2, x32n,
                                     scales[top - 1], sell.bucket_table,
                                     sell.perm, device=dev, **kw),
         lambda: C.gse_spmm_sell_f32_plain(segs[0], segs[1], t1, t2, x32n,
                                           scales, sell.bucket_table,
                                           sell.perm, tag=top,
                                           bucket_tags=btags, **lay),
         lambda: torch.mm(lib32, x32n),
         lambda: ops.gse_spmm_sell(masked, x32n, tag=tm, device=dev),
         lambda: ops.gse_spmm_sell(masked_planned, x32n, tag=planned,
                                   device=dev),
         NRHS, check["errs"][1], check["c32_mixed"]),
    ):
        nops = sum(real[t] * (DECODE_OPS[t] - 2 + 2 * ncols) for t in TAGS)
        vec = ncols * (m + n) * 4
        add_entry(name, src, "src/repro/kernels/ops.py:306", launch, plain,
                  lib, sell.bytes_touched(tm) + vec,
                  nops / FP32_OPS_PER_S * 1e3, plain_reps=1, reps=5, inner=4,
                  tag="map", nrhs=ncols, launches=count, max_abs_err=err,
                  bucket_tags=list(btags), groups_by_tag=tm.tag_counts(),
                  uniform_max_tag_ms=cuda_ms(uniform, reps=5, inner=4),
                  uniform_bytes=sell.bytes_touched(top) + vec,
                  ops_ms=cuda_ms(entry, reps=5, inner=4),
                  planned_map_ms=cuda_ms(entry_planned, reps=5, inner=4),
                  planned_bucket_tags=list(ops.sell_bucket_tags(sell,
                                                                planned)))
    del lib32, vals32, cols


# Phase 23's tag-fault runs: spd_rs8_2k (phase 3's system) at this
# tolerance, so the CPU twin's recovered runs (about 950 iterations each)
# take seconds, not the minute the full 1e-8 solve would.
FAULT_TOL = 1e-5
FAULT_MODES = ("indefinite", "nan")
# The main path's monitor (main's ``params``), which phase 23's CPU twins
# rebuild in their own process.
MAIN_PARAMS = dict(t=40, l=60, m=30)
# The tolerance of phase 4's solve at 2^20 unknowns and of the phases held
# bitwise to it (6's service, 23's checkpointed solve, 24's join): 1e-8
# until PR 29, cut to 1e-5 to make room for the train phases 34-37 (the
# host-bound iterations run at ~12.3 ms each); every check stays.
MAIN_TOL = 1e-5
# Phase 23 checkpoints phase 4's solve at this iteration (1920 at 1e-8).
MAIN_RESUME_AT = 960
# The spans phase 23's trace must hold.
TELEMETRY_SPANS = ("solve.cg", "solve.gmres", "solve.cg_batched",
                   "solve.pcg_batched", "solve.ir", "pack.build")


def require_same_ring(what, got, want):
    """Two flight states (a ring or a stack of rings) bit for bit."""
    import torch

    for k in ("ibuf", "fbuf", "count"):
        a, b = got[k].cpu(), want[k].cpu()
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{what}: the flight ring's {k} differs "
                                 "from the CPU twin's")


def telemetry_resume(g, b, params, res4, wall4, counts4, tmp):
    """Phase 23, part 1: phase 4's solve with the flight recorder, through
    a checkpoint at iteration MAIN_RESUME_AT, bitwise phase 4's result."""
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import gse_spmv as K
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.obs import flight as OF
    from repro_torch.robustness.guards import DEFAULT_GUARDS
    from repro_torch.solvers import cg as T_cg

    dev = b.device
    args = (g, b, torch.zeros_like(b),
            torch.tensor(MAIN_TOL, dtype=torch.float64, device=dev), 20000,
            params)
    kw = dict(guards=DEFAULT_GUARDS, flight=OF.FlightParams(capacity=4096))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    V.reset_launch_counts()
    t0 = time.perf_counter()
    r1, _, state = T_cg._solve_cg_fused(*args, stop_at=MAIN_RESUME_AT,
                                        return_state=True, **kw)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    if int(r1.iters) != MAIN_RESUME_AT:
        raise AssertionError(f"phase 23: the first chunk ran {int(r1.iters)}")
    crc = ckpt.tree_crc32(state)
    t0 = time.perf_counter()
    ckpt.save(tmp, state, MAIN_RESUME_AT, extra={"phase": 23})
    save_s = time.perf_counter() - t0
    # ``like`` gives only the tree's structure, dtypes and device; the
    # values come from the disk.
    like = state
    del state, r1
    t0 = time.perf_counter()
    tree, step, extra, skipped = ckpt.restore_latest_valid(tmp, like=like,
                                                           device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like
    if (step, extra, skipped) != (MAIN_RESUME_AT, {"phase": 23}, []):
        raise AssertionError(f"phase 23: restored {step} {extra} {skipped}")
    if ckpt.tree_crc32(tree) != crc:
        raise AssertionError("phase 23: the restored tree's CRC32 differs")
    if tree["x"].device.type != "cuda":
        raise AssertionError("phase 23: the state was not restored to cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, _, final = T_cg._solve_cg_fused(*args, resume=tree,
                                         return_state=True, **kw)
    torch.cuda.synchronize()
    solve_s += time.perf_counter() - t0
    counts = dict(a64=K.gse_spmv_csr_f64.launches,
                  seq_dot=V.seq_dot.launches, fma_axpy=V.fma_axpy.launches)
    require_bitwise("phase 23: x through the checkpoint against phase 4",
                    res.x, res4.x)
    got = (int(res.iters), float(res.relres), int(res.tag),
           res.switch_iters.tolist())
    want = (int(res4.iters), float(res4.relres), int(res4.tag),
            res4.switch_iters.tolist())
    if got != want:
        raise AssertionError(f"phase 23: {got} != phase 4's {want}")
    if counts != counts4:
        raise AssertionError(f"phase 23: launches {counts} != phase 4's "
                             f"{counts4}")
    flog = OF.FlightLog.from_state(res.flight)
    OF.assert_consistent(flog, res)
    if (flog.switch_iters().tolist(), flog.recorded, flog.dropped) != (
            [120, 150], int(res.iters), 0):
        raise AssertionError(f"phase 23: flight {flog.summary()}")
    # A second step whose blob lost a bit: restore_latest_valid skips it.
    ckpt.save(tmp, final, int(res.iters))
    blob = Path(tmp) / f"step_{int(res.iters):08d}" / ckpt._BLOB
    raw = bytearray(blob.read_bytes())
    raw[len(raw) // 3] ^= 0x04
    blob.write_bytes(bytes(raw))
    _, step2, _, skipped2 = ckpt.restore_latest_valid(tmp, like=tree,
                                                      device=dev)
    if (step2, skipped2) != (MAIN_RESUME_AT, [int(res.iters)]):
        raise AssertionError(f"phase 23: the corrupt step was not skipped: "
                             f"{step2} {skipped2}")
    iters = int(res.iters)
    blob_mb = blob.stat().st_size / 2**20
    log("telemetry", part="checkpointed flight CG", rows=g.shape[0],
        iters=iters, switch_iters=res.switch_iters.tolist(),
        bitwise_phase4=True, tree_crc32=crc, blob_mb=f"{blob_mb:.1f}",
        save_s=f"{save_s:.2f}", restore_s=f"{restore_s:.2f}",
        solve_s=f"{solve_s:.2f}",
        ms_per_iteration=f"{solve_s * 1e3 / iters:.3f}",
        phase4_ms_per_iteration=f"{wall4 * 1e3 / iters:.3f}",
        flight=json.dumps(flog.summary()), launches=json.dumps(counts),
        launches_equal_phase4=True, corrupt_step_skipped=skipped2)
    return dict(ms=solve_s * 1e3 / iters, phase4_ms=wall4 * 1e3 / iters)


def twin_batched(where, pcg, params):
    """Batched CG (or Jacobi PCG) on rs8_400_s3's block [b0, b1, b2, 0]
    with a 2048-row flight ring per column, on ``where``; returns the
    result, the seconds and C64's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import gse_spmm as C
    from repro_torch.obs import flight as OF
    from repro_torch.solvers import (make_jacobi, solve_cg_batched,
                                     solve_pcg_batched)
    from repro_torch.sparse.csr import pack_csr

    host = rs8_400_s3("cpu")
    blk = torch.from_numpy(np.stack([host_spmv(host, np.random.default_rng(
        j).normal(size=400)) for j in range(3)] + [np.zeros(400)], axis=1))
    a = rs8_400_s3(where)
    kw = dict(tol=1e-8, maxiter=20000, params=params,
              flight=OF.FlightParams(capacity=2048), device=where)
    C.reset_launch_counts()
    t0 = time.perf_counter()
    if pcg:
        r = solve_pcg_batched(pack_csr(a, k=8), blk, make_jacobi(a, k=8),
                              **kw)
    else:
        r = solve_cg_batched(pack_csr(a, k=8), blk, **kw)
    return r, time.perf_counter() - t0, C.gse_spmm_csr_f64.launches


def twin_ir(where):
    """Quickstart section 5's refinement (inner Jacobi PCG) with a
    512-row flight ring a correction, on ``where``."""
    from repro_torch.core.precision import MonitorParams
    from repro_torch.obs import flight as OF
    from repro_torch.solvers import solve_ir

    g, m, b, _ = ir_case(where)
    t0 = time.perf_counter()
    r = solve_ir(g, b, precond=m, params=MonitorParams(**PCG_PARAMS),
                 flight=OF.FlightParams(capacity=512), **IR_KW)
    return r, time.perf_counter() - t0


def twin_fault(where, mode, params):
    """spd_rs8_2k through solve_cg (guards and recovery on) behind the
    tag-fault operator (``mode``, fail_tag 1), on ``where``."""
    import numpy as np
    import torch

    from repro_torch.robustness import faults as F
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    small = G.diag_rescale(G.random_spd(2000, seed=21, device="cpu"), 8.0, 21)
    bs = torch.from_numpy(host_spmv(small, np.random.default_rng(0).normal(
        size=2000)))
    gs = pack_csr(G.diag_rescale(G.random_spd(2000, seed=21, device=where),
                                 8.0, 21))
    t0 = time.perf_counter()
    r = solve_cg(F.make_tag_fault_operator(gs, mode=mode, fail_tag=1),
                 bs.to(where), tol=FAULT_TOL, maxiter=20000, params=params)
    return r, time.perf_counter() - t0


def telemetry_twins(params, cpu):
    """Phase 23, part 3: the flight rings of batched CG and Jacobi PCG on
    rs8_400_s3 and of quickstart section 5's IR, the card against the
    CPU twin's results ``cpu``."""
    from repro_torch.obs import flight as OF

    for name in ("cg_batched", "pcg_batched"):
        rg, sg, c64 = twin_batched("cuda", name == "pcg_batched", params)
        rc, sc = cpu[name]
        require_same_ring(f"phase 23 {name}", rg.flight, rc.flight)
        require_bitwise(f"phase 23 {name} x", rg.x, rc.x)
        if c64 <= 0:
            raise AssertionError(f"phase 23 {name}: C64 never launched")
        for j, col in enumerate(OF.split_batched(rg.flight)):
            flog = OF.FlightLog.from_state(col)
            if flog.recorded != int(rg.iters[j]) or (
                    j < 3 and flog.switch_iters().tolist()
                    != rg.switch_iters[j].tolist()):
                raise AssertionError(f"phase 23 {name} column {j}: "
                                     f"{flog.summary()}")
        log("telemetry", part=f"{name} rings against the CPU twin",
            case="rs8_400_s3", iters=rg.iters.tolist(),
            switch_iters=rg.switch_iters.tolist(), rings_bitwise=True,
            c64_launches=c64, gpu_s=f"{sg:.2f}", cpu_s=f"{sc:.2f}")
    rg, sg = twin_ir("cuda")
    rc, sc = cpu["ir"]
    if (rg.outer_iters, rg.inner_iters, rg.relres) != IR_REF["pcg_jacobi"]:
        raise AssertionError(f"phase 23 IR: {rg.outer_iters} "
                             f"{rg.inner_iters} {rg.relres!r}")
    if len(rg.flight) != len(rc.flight) or len(rg.flight) != rg.outer_iters:
        raise AssertionError("phase 23 IR: one ring a correction")
    for i, (fg, fc) in enumerate(zip(rg.flight, rc.flight)):
        require_same_ring(f"phase 23 IR correction {i}", fg, fc)
    require_bitwise("phase 23 IR x", rg.x, rc.x)
    log("telemetry", part="IR rings against the CPU twin",
        case="quickstart section 5, inner PCG", outer=rg.outer_iters,
        inner=rg.inner_iters,
        rows_per_correction=[int(f["count"]) for f in rg.flight],
        rings_bitwise=True, gpu_s=f"{sg:.2f}", cpu_s=f"{sc:.2f}")


def telemetry_faults(g, params, cpu):
    """Phase 23, part 4: fault injection on the card (the tag faults
    against the CPU twin's results ``cpu``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.obs import metrics as OM
    from repro_torch.robustness import faults as F
    from repro_torch.robustness.guards import HEALTH_OK, health_name

    t0 = time.perf_counter()
    ref = F.gsecsr_checksums(g)
    named = {}
    for target in ("head", "table"):
        bad = F.corrupt_gsecsr(g, target, seed=23)
        named[target] = F.verify_gsecsr(bad, ref)
        del bad
    if named != {"head": ["head"], "table": ["table"]} or F.verify_gsecsr(
            g, ref):
        raise AssertionError(f"phase 23: verify_gsecsr named {named}")
    seg_s = time.perf_counter() - t0

    key = ("ell", ops.LANE)
    clean = [t.clone() for t in g.__dict__["_pack_cache"][key][0]]
    before = dict(ops.PACK_STATS)
    t0 = time.perf_counter()
    if not F.corrupt_pack_cache(g, key=key, seed=23):
        raise AssertionError("phase 23: no ELL entry to corrupt")
    repacked = ops.ell_pack_gsecsr(g)
    torch.cuda.synchronize()
    repack_s = time.perf_counter() - t0
    after = dict(ops.PACK_STATS)
    if (after["corrupt"] - before["corrupt"], after["misses"]
            - before["misses"]) != (1, 1):
        raise AssertionError(f"phase 23: pack stats {before} -> {after}")
    line = [ln for ln in OM.REGISTRY.to_prometheus().splitlines()
            if ln.startswith('repro_pack_cache_events_total{event="corrupt"}')]
    if not line or int(line[0].split()[-1]) != after["corrupt"]:
        raise AssertionError(f"phase 23: the registry's corrupt counter "
                             f"{line}")
    for got, want in zip(repacked, clean):
        if not torch.equal(got, want):
            raise AssertionError("phase 23: the repacked ELL entry differs")
    del clean, repacked
    log("telemetry", part="pack faults", verify_named=json.dumps(named),
        segments_s=f"{seg_s:.2f}", ell_repacked=True,
        pack_stats=json.dumps(after), corrupt_counter=after["corrupt"],
        repack_s=f"{repack_s:.2f}")

    for mode in FAULT_MODES:
        rg, sg = twin_fault("cuda", mode, params)
        rc, sc = cpu[mode]
        got = (int(rg.iters), rg.switch_iters.tolist(), int(rg.tag),
               int(rg.trip_iter), int(rg.health), float(rg.relres))
        twin = (int(rc.iters), rc.switch_iters.tolist(), int(rc.tag),
                int(rc.trip_iter), int(rc.health), float(rc.relres))
        if got != twin:
            raise AssertionError(f"phase 23 {mode}: {got} != the CPU "
                                 f"twin's {twin}")
        require_bitwise(f"phase 23 {mode} x", rg.x, rc.x)
        if not (int(rg.trip_iter) == 0 and int(rg.health) == HEALTH_OK
                and bool(rg.converged) and int(rg.tag) >= 2):
            raise AssertionError(f"phase 23 {mode}: tripped at "
                                 f"{int(rg.trip_iter)}, ended "
                                 f"{health_name(rg.health)}")
        log("telemetry", part="tag fault", case="spd_rs8_2k", mode=mode,
            fail_tag=1, tol=FAULT_TOL, iters=got[0], switch_iters=got[1],
            tag=got[2], trip_iter=got[3], health=health_name(rg.health),
            recovered=True, cpu_twin_bitwise=True, gpu_s=f"{sg:.2f}",
            cpu_s=f"{sc:.2f}")


def phase_telemetry(g, b, params, res4, wall4, counts4, gmres_full, twins):
    """Phase 23: telemetry, faults and checkpoints, inside a trace
    capture whose JSONL is validated at the end; the CPU twins' results
    come from ``twins``."""
    import tempfile

    from repro_torch.obs import trace as OT

    with tempfile.TemporaryDirectory(prefix="phase23_") as tmp:
        trace = Path(tmp) / "trace.jsonl"
        cpu, cpu_wait = telemetry_card(
            g, b, params, res4, wall4, counts4, gmres_full, tmp, trace, twins)
        n = OT.validate_jsonl(str(trace))
        events = [json.loads(ln) for ln in trace.read_text().splitlines()]
    check_trace(n, events, cpu_wait)


def telemetry_card(g, b, params, res4, wall4, counts4, gmres_full, tmp,
                   trace, twins):
    """Phase 23's parts on the card, inside a trace capture; returns the
    CPU twins' results and the seconds waited for them."""
    import torch

    from repro_torch.obs import flight as OF
    from repro_torch.obs import trace as OT
    from repro_torch.robustness.guards import health_name
    from repro_torch.solvers import solve_gmres

    with OT.capture(str(trace)):
        t0 = time.perf_counter()
        cost = telemetry_resume(g, b, params, res4, wall4, counts4,
                                str(Path(tmp) / "ckpt"))
        t1 = time.perf_counter()
        gm = gmres_full
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = solve_gmres(gm["op"], gm["b"], tol=1e-7, restart=GMRES_RESTART,
                          maxiter=GMRES_FULL_ITERS, params=gm["params"],
                          precond=gm["m"], flight=OF.FlightParams())
        torch.cuda.synchronize()
        gwall = time.perf_counter() - t
        want = gm["res"]
        require_bitwise("phase 23 GMRES x against phase 16", res.x, want.x)
        got = (int(res.iters), float(res.relres), int(res.tag),
               res.switch_iters.tolist(), int(res.health))
        if got != (int(want.iters), float(want.relres), int(want.tag),
                   want.switch_iters.tolist(), int(want.health)):
            raise AssertionError(f"phase 23 GMRES: {got}")
        flog = OF.FlightLog.from_state(res.flight)
        OF.assert_consistent(flog, res)
        log("telemetry", part="flight GMRES", rows=gm["b"].shape[0],
            iters=got[0], health=health_name(res.health),
            bitwise_phase16=True, flight=json.dumps(flog.summary()),
            ms_per_iteration=f"{gwall * 1e3 / got[0]:.3f}",
            phase16_ms_per_iteration=f"{gm['wall'] * 1e3 / got[0]:.3f}")
        t2 = time.perf_counter()
        cpu = twins.get("telemetry")
        t3 = time.perf_counter()
        telemetry_twins(params, cpu)
        t4 = time.perf_counter()
        telemetry_faults(g, params, cpu)
        t5 = time.perf_counter()
    log("telemetry", part="seconds", checkpointed_cg_s=f"{t1 - t0:.1f}",
        gmres_s=f"{t2 - t1:.1f}", cpu_twins_wait_s=f"{t3 - t2:.1f}",
        twins_s=f"{t4 - t3:.1f}", faults_s=f"{t5 - t4:.1f}",
        recorder_ms_per_iteration=f"{cost['ms']:.3f}",
        phase4_ms_per_iteration=f"{cost['phase4_ms']:.3f}")
    return cpu, t3 - t2


def check_trace(n, events, cpu_wait):
    """Phase 23, part 5: the trace's spans (parents intact: the validator
    checked every id) and the registry's families."""
    from repro_torch.obs import metrics as OM

    names = {}
    for e in events:
        names[e["name"]] = names.get(e["name"], 0) + 1
    missing = [s for s in TELEMETRY_SPANS if s not in names]
    if missing:
        raise AssertionError(f"phase 23: the trace lacks {missing}: {names}")
    by_id = {e["id"]: e for e in events}
    nested = sum(1 for e in events if e["name"] == "solve.pcg"
                 and e["parent"] is not None
                 and by_id[e["parent"]]["name"] == "solve.ir")
    if nested == 0:
        raise AssertionError("phase 23: no solve.pcg span under solve.ir")
    text = OM.REGISTRY.to_prometheus()
    families = ("repro_pack_cache_events_total", "repro_serve_events_total",
                "repro_serve_queue_depth",
                "repro_serve_flush_latency_seconds",
                "repro_serve_request_bytes")
    lacking = [f for f in families if f"# TYPE {f} " not in text]
    if lacking:
        raise AssertionError(f"phase 23: the registry lacks {lacking}")
    log("telemetry", part="trace and registry", events=n,
        spans=json.dumps(names), pcg_spans_under_ir=nested,
        registry_lines=len(text.splitlines()), registry_families=len(
            [ln for ln in text.splitlines() if ln.startswith("# TYPE ")]),
        cpu_twins_wait_s=f"{cpu_wait:.1f}")


# --- phase 24: async serving -------------------------------------------------
SERVE_CHUNK = 32  # part 1's chunk_iters
SERVE_FULL_CHUNK = 64  # part 2's chunk_iters
# Part 2's pumps before request 1 joins: a join at 128 iterations keeps
# every check of a later one and runs fewer group iterations.
SERVE_FULL_PUMPS = 2


class FakeClock:
    """An injectable clock the scenario advances by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def async_fields(r) -> dict:
    """Every field of a SolveReport, relres as its bits, or "nan" (a NaN's
    payload is the card's or the host's own)."""
    d = report_fields(r)
    d["relres"] = ("nan" if r.relres != r.relres else
                   struct.unpack("<q", struct.pack("<d", r.relres))[0])
    return d


def serve_lines(svc) -> list:
    """The service's ``repro_serve_*`` series in the registry's text, its
    id replaced, without the flush-latency histogram (``perf_counter``)."""
    from repro_torch.obs import metrics as OM

    tag = f'service="{svc.service_id}"'
    return [ln.replace(tag, 'service="S"')
            for ln in OM.REGISTRY.to_prometheus().splitlines()
            if tag in ln and "flush_latency" not in ln]


def serve_scenario(where: str) -> dict:
    """Phase 24, part 1, on ``where``: AsyncSolveService under a fake
    clock (chunk_iters 32, slots 4, queue_limit 4) over rs8_400_s3 and
    poisson2d(12): three requests, the third joining the running group
    after two pumps; a queue_full burst; a tag-fault operator that trips
    the breaker, sheds breaker_open and heals through the half-open probe
    once lifted; a pack corrupted by corrupt_gsecsr, detected and
    repacked; a stall hook that expires a deadline; a warm-LRU hit.
    Returns the reports, solutions, scenario cases and counters."""
    import numpy as np
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.robustness import faults as F
    from repro_torch.serve import Accepted, AsyncSolveService, BreakerParams
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    clock = FakeClock()

    def stall(svc, key, group):  # the "slow" handle's chunks take 1 s
        if key[0] == "slow":
            clock.t += 1.0

    t0 = time.perf_counter()
    svc = AsyncSolveService(
        slots=NRHS, params=MonitorParams(**MAIN_PARAMS), maxiter=20000,
        chunk_iters=SERVE_CHUNK, queue_limit=4, clock=clock, seed=0,
        breaker=BreakerParams(fail_threshold=2, backoff_s=1.0, jitter=0.1),
        chunk_hook=stall, device=where)
    hosts = {"rs8": rs8_400_s3("cpu"), "p12": G.poisson2d(12, device="cpu")}
    svc.register("rs8", rs8_400_s3(where), k=8)
    for name in ("p12", "slow", "bad", "rot"):
        a = G.poisson2d(12, device=where)
        op = None
        if name == "bad":  # every tag fails: NaN products
            op = F.make_tag_fault_operator(pack_csr(a, k=8), mode="nan",
                                           fail_tag=3)
        svc.register(name, a, k=8, operator=op)

    def rhs(name, seed):
        host = hosts["rs8" if name == "rs8" else "p12"]
        return torch.from_numpy(host_spmv(host, np.random.default_rng(
            seed).normal(size=host.shape[0])))

    cases = {}
    first = [svc.submit("rs8", rhs("rs8", j)) for j in range(2)]
    svc.pump()
    svc.pump()
    joined = svc.submit("rs8", rhs("rs8", 2))
    svc.pump()
    widths = [g.chunks.nrhs for k, g in svc._groups.items() if k[0] == "rs8"]
    cases["join"] = widths == [3] and all(
        isinstance(r, Accepted) for r in first + [joined])
    burst = [svc.submit("p12", rhs("p12", 10 + j)) for j in range(5)]
    cases["queue_full"] = (
        [type(r).__name__ for r in burst] == ["Accepted"] * 4 + ["Shed"]
        and burst[4].reason == "queue_full")
    svc.run_until_idle()
    for seed in (20, 21):
        svc.submit("bad", rhs("bad", seed))
        svc.run_until_idle()
    br = svc._breaker("bad")
    opened = br.state == "open"
    shed = svc.submit("bad", rhs("bad", 22))
    cases["breaker_open"] = opened and type(shed).__name__ == "Shed" and \
        shed.reason == "breaker_open" and shed.retry_after_s > 0
    svc._operators.pop("bad")  # the operand heals
    clock.t += 2.0
    probe = svc.submit("bad", rhs("bad", 23))
    svc.run_until_idle()
    cases["healed"] = (isinstance(probe, Accepted)
                       and svc.reports[probe.id].converged
                       and svc.reports[probe.id].health == "ok"
                       and br.state == "closed"
                       and [s for s, _ in br.transitions]
                       == ["open", "half_open", "closed"])
    svc._ops["rot"].gse = F.corrupt_gsecsr(svc._ops["rot"].gse, "table",
                                           seed=3)
    rot = svc.submit("rot", rhs("rot", 30))
    svc.run_until_idle()
    cases["repacked"] = (dict(svc.pack_faults) == {"detected": 1,
                                                   "repacked": 1}
                         and svc.reports[rot.id].converged)
    slow = svc.submit("slow", rhs("slow", 31), tol=1e-12, deadline_s=0.5)
    svc.run_until_idle()
    rep = svc.reports[slow.id]
    x_slow = svc._solutions[slow.id]
    cases["deadline"] = (rep.health == "deadline" and rep.deadline_exceeded
                         and not rep.converged and rep.iters == SERVE_CHUNK
                         and bool(torch.isfinite(x_slow).all()))
    warm = svc.submit("p12", rhs("p12", 10))
    svc.run_until_idle()
    cases["warm_hit"] = (svc.warm["hit"] == 1
                         and svc.reports[warm.id].iters == 0
                         and svc.reports[warm.id].converged)
    if where == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ids = sorted(svc.reports)
    return dict(
        reports=[async_fields(svc.reports[i]) for i in ids],
        x={i: svc.solution(i).cpu() for i in ids if i in svc._solutions},
        cases=cases,
        counters=dict(stats=dict(svc.stats), sheds=dict(svc.sheds),
                      warm=dict(svc.warm), pack_faults=dict(svc.pack_faults),
                      chunks=svc.chunk_counter.value),
        lines=serve_lines(svc), wall=wall)


def phase_serve_small(twins=None):
    """Phase 24, part 1: the serve scenario on the card against its CPU
    twin (from ``twins``, or computed here when run alone)."""
    got = serve_scenario("cuda")
    want = twin_of(twins, "serve_async")
    bad = [k for k, v in got["cases"].items() if not v]
    if bad:
        raise AssertionError(f"phase 24: scenario cases failed: {bad}")
    if got["reports"] != want["reports"]:
        for g, w in zip(got["reports"], want["reports"]):
            if g != w:
                raise AssertionError(f"phase 24: report {g} != the CPU "
                                     f"twin's {w}")
        raise AssertionError("phase 24: the reports differ in number")
    if sorted(got["x"]) != sorted(want["x"]):
        raise AssertionError("phase 24: the solutions differ in number")
    for i, x in got["x"].items():
        require_bitwise(f"phase 24 request {i}'s x", x, want["x"][i])
    if got["counters"] != want["counters"] or got["lines"] != want["lines"]:
        raise AssertionError(f"phase 24: counters {got['counters']} != the "
                             f"CPU twin's {want['counters']}")
    if got["counters"]["stats"]["errors"] != 0:
        raise AssertionError(f"phase 24: errors {got['counters']}")
    log("serve_async", part="scenario against the CPU twin",
        cases=json.dumps(got["cases"]), requests=len(got["reports"]),
        reports_bitwise=True, solutions_bitwise=len(got["x"]),
        health=json.dumps([r["health"] for r in got["reports"]]),
        counters=json.dumps(got["counters"]), gpu_s=f"{got['wall']:.2f}",
        cpu_s=f"{want['wall']:.2f}")
    for ln in got["lines"]:
        if ln.startswith("repro_serve_") and "_bucket" not in ln:
            log("serve_async", series=ln.replace(" ", "="))


def phase_serve_full(csr, b, b1, params, res4, wall4, req1, x1, ms6):
    """Phase 24, part 2: AsyncSolveService(slots=4, maxiter=20000,
    chunk_iters=64) on phase 4's matrix, launch counts zeroed: phase 4's b
    alone for SERVE_FULL_PUMPS pumps, then phase 6's request 1 joins the
    running group.
    Request 0 must be bitwise phase 4's solo solve (``res4``), request 1
    phase 6's request 1 (``req1``, ``x1``); C64 launches once a group
    iteration and once a column init."""
    import torch

    from repro_torch.kernels import gse_spmm as C
    from repro_torch.kernels import gse_spmv as K
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.serve import AsyncSolveService
    from repro_torch.serve import chunked as SC
    from repro_torch.solvers.cg import CHUNK

    it0, it1 = int(res4.iters), int(req1.iters)
    joined_at = SERVE_FULL_PUMPS * SERVE_FULL_CHUNK
    # Each chunk runs whole CHUNK batches until every live column is done:
    # column 0 alone to the join, then the group until the last column's
    # batch ends; one C64 launch each, one more per column init.
    group_iters = joined_at + CHUNK * -(-max(it0 - joined_at, it1) // CHUNK)
    want_c64 = group_iters + 2
    log("serve_async", part="full-width service, predicted",
        request0_iters=it0, request1_iters=it1, joins_at=joined_at,
        group_iters=group_iters, c64_launches_expected=want_c64)
    t0 = time.perf_counter()
    svc = AsyncSolveService(slots=NRHS, params=params, maxiter=20000,
                            chunk_iters=SERVE_FULL_CHUNK)
    svc.register("full", csr, k=8)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    g = svc._ops["full"].gse
    for mod in (K, C, V):
        mod.reset_launch_counts()
    chunk_s = [0.0]
    run_chunk = SC.BatchedChunks.run_chunk

    def timed(self, k):  # device time of a chunk, syncs around it
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_chunk(self, k)
        torch.cuda.synchronize()
        chunk_s[0] += time.perf_counter() - t
        return out

    SC.BatchedChunks.run_chunk = timed
    try:
        t0 = time.perf_counter()
        r0 = svc.submit("full", b, tol=MAIN_TOL)
        for _ in range(SERVE_FULL_PUMPS):
            svc.pump()
        width = [grp.chunks.nrhs for grp in svc._groups.values()]
        r1 = svc.submit("full", b1, tol=MAIN_TOL)
        pumps = SERVE_FULL_PUMPS
        while svc._pending or svc._groups:
            svc.pump()
            pumps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        SC.BatchedChunks.run_chunk = run_chunk
    c64 = C.gse_spmm_csr_f64.launches
    c64_bodies = dict(C.gse_spmm_csr_f64.body_launches)
    cols = {"seq_dot_cols": V.seq_dot_cols.launches,
            "fma_axpy_cols": V.fma_axpy_cols.launches}
    reps = [svc.reports[r0.id], svc.reports[r1.id]]
    xs = [svc.solution(r0.id), svc.solution(r1.id)]
    log("serve_async", part="full-width service", rows=g.shape[0],
        nnz=g.nnz, chunk_iters=SERVE_FULL_CHUNK, width_before_join=width,
        iters=[r.iters for r in reps],
        switch_iters=[r.switch_iters.tolist() for r in reps],
        relres=[r.relres for r in reps], health=[r.health for r in reps],
        retries=[r.retries for r in reps],
        batch=[r.batch_size for r in reps], stats=json.dumps(dict(svc.stats)),
        pumps=pumps, chunks_total=svc.chunk_counter.value,
        c64_launches=c64, c64_body_launches=json.dumps(c64_bodies),
        seq_dot_cols_launches=cols["seq_dot_cols"],
        fma_axpy_cols_launches=cols["fma_axpy_cols"],
        register_s=f"{register_s:.2f}", wall_s=f"{wall:.2f}",
        chunks_s=f"{chunk_s[0]:.2f}",
        host_outside_chunks_s=f"{wall - chunk_s[0]:.2f}",
        ms_per_group_iteration=f"{chunk_s[0] * 1e3 / group_iters:.3f}",
        phase6_ms_per_iteration=ms6,
        solo_ms_per_iteration=f"{wall4 * 1e3 / it0:.3f}")
    if width != [1]:
        raise AssertionError(f"phase 24: the group before the join {width}")
    want0 = (it0, res4.switch_iters.tolist(), int(res4.tag),
             float(res4.relres))
    want1 = (it1, req1.switch_iters.tolist(), req1.tag, req1.relres)
    for r, want, x, wx, what in ((reps[0], want0, xs[0], res4.x,
                                  "phase 4's solo solve"),
                                 (reps[1], want1, xs[1], x1,
                                  "phase 6's request 1")):
        got = (r.iters, r.switch_iters.tolist(), r.tag, r.relres)
        if got != want:
            raise AssertionError(f"phase 24: request {r.id} {got} is not "
                                 f"{what} {want}")
        require_bitwise(f"phase 24: request {r.id}'s x against {what}", x,
                        wx)
        if not r.converged or r.health != "ok" or r.retries != 0:
            raise AssertionError(f"phase 24: request {r.id}: {r}")
    if svc.stats["errors"] != 0:
        raise AssertionError(f"phase 24: service errors {svc.stats}")
    if c64 != want_c64:
        raise AssertionError(f"phase 24: C64 launched {c64} times, "
                             f"predicted {want_c64}")
    if min(cols.values()) <= 0:
        raise AssertionError(f"phase 24: {cols}")
    require_bodies("phase 24: C64", c64_bodies, plan_bodies(g))


def phase_serve_ir(g, b, params, ir_res, m):
    """Phase 24, part 3: phase 20's solo refinement through IRChunks, two
    corrections a chunk: x and the history bitwise phase 20's."""
    import numpy as np
    import torch

    from repro_torch.robustness.guards import DEFAULT_GUARDS
    from repro_torch.serve import IRChunks

    t0 = time.perf_counter()
    drv = IRChunks(g, b, tol=1e-10, max_outer=10, inner="cg",
                   inner_tol=1e-4, inner_maxiter=2000, params=params,
                   precond=m, restart=30, guards=DEFAULT_GUARDS)
    while not drv.done:
        drv.run_chunk(2)
    res = drv.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log("serve_async", part="IRChunks k=2 against phase 20",
        chunks=drv.chunks, outer=res.outer_iters, inner=res.inner_iters,
        relres=res.relres, wall_s=f"{wall:.2f}")
    if (res.outer_iters, res.inner_iters, res.relres) != (
            ir_res.outer_iters, ir_res.inner_iters, ir_res.relres) or \
            not np.array_equal(res.history, ir_res.history):
        raise AssertionError(f"phase 24: IRChunks {res.outer_iters} "
                             f"{res.inner_iters} {res.relres!r} is not "
                             "phase 20's")
    require_bitwise("phase 24: IRChunks x against phase 20", res.x, ir_res.x)
    if drv.chunks != -(-ir_res.outer_iters // 2):
        raise AssertionError(f"phase 24: {drv.chunks} chunks")


# --- 25. the perf layer: roofline, tune cache, ledger, timing ----------------
# The assumed roof phase 10 prices its bounds with, beside the probed one.
ROOF_ASSUMED = dict(stream_gbps=HBM_BYTES_PER_S / 1e9,
                    peak_gflops=FP32_OPS_PER_S / 1e9)
# Part f: A32 at tag 3 against tag 1 on random_spd(n, 8) at these n (from
# 2^8: A32's device time at 2^12 is already past the ratio), then at 2^20
# on phase 2's operator (the same construction rescaled), and the ratio
# the crossover is read at.
CROSSOVER_N = (1 << 8, 1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18)
CROSSOVER_RATIO = 1.05
# Parts b and c time each candidate best of 20 (the reference's tuner: 3).
SWEEP_TIMING = dict(iters=20, warmup=2)
# The reference's SELL service on sk512_rs8_s0 (slots 4, maxiter 20000,
# MonitorParams(40, 60, 30), three requests) registered with each SELL
# plan the autotuner may pick, keyed c{C}_s{sigma}_{bucket}: per request
# (iters, tag, switch_iters, health, retries, est_bytes), then the stats
# (tools/reference/plan_service_ref.py; JAX on the CPU, x64).  Part e
# holds the tuned service to its winner's row.
SELL_PLAN_SERVICE_REF = {
    "c8_sNone_pow2": (
        [(1498, 3, [210, 300], "ok", 0, 406957675),
         (1498, 3, [150, 180], "ok", 0, 406957675),
         (1678, 3, [120, 150], "ok", 0, 557737195)],
        dict(batches=1, requests=3, padded_cols=1,
             modeled_bytes=1371652544, retries=0, errors=0,
             deadline_exceeded=0)),
    "c16_sNone_pow2": (
        [(1498, 3, [210, 300], "ok", 0, 418655851),
         (1498, 3, [150, 180], "ok", 0, 418655851),
         (1678, 3, [120, 150], "ok", 0, 573859051)],
        dict(batches=1, requests=3, padded_cols=1,
             modeled_bytes=1411170752, retries=0, errors=0,
             deadline_exceeded=0)),
    "c16_s64_pow2": (
        [(1498, 3, [210, 300], "ok", 0, 523939435),
         (1498, 3, [150, 180], "ok", 0, 523939435),
         (1678, 3, [120, 150], "ok", 0, 718955755)],
        dict(batches=1, requests=3, padded_cols=1,
             modeled_bytes=1766834624, retries=0, errors=0,
             deadline_exceeded=0)),
    "c8_s32_pow2": (
        [(1498, 3, [210, 300], "ok", 0, 471297643),
         (1498, 3, [150, 180], "ok", 0, 471297643),
         (1678, 3, [120, 150], "ok", 0, 646407403)],
        dict(batches=1, requests=3, padded_cols=1,
             modeled_bytes=1589002688, retries=0, errors=0,
             deadline_exceeded=0)),
    "c8_sNone_exact": (
        [(1498, 3, [210, 300], "ok", 0, 406957675),
         (1498, 3, [150, 180], "ok", 0, 406957675),
         (1678, 3, [120, 150], "ok", 0, 557737195)],
        dict(batches=1, requests=3, padded_cols=1,
             modeled_bytes=1371652544, retries=0, errors=0,
             deadline_exceeded=0)),
}


def sell_plan_name(plan) -> str:
    return f"c{plan.sell_c}_s{plan.sell_sigma}_{plan.sell_bucket}"


def queued_ms(fn, reps: int, inner: int, spacer) -> float:
    """Minimum over ``reps`` of the device ms of ``inner`` back-to-back
    calls of ``fn``, queued behind ``spacer`` (a few ms of device work), so
    that the host's time to launch them stays out of the reading."""
    import torch

    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        spacer()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def ell_sweep(g, ell, row_len, x32, x32n):
    """Part b: the A32 (nrhs 1) and C32 (nrhs 4) lanes sweeps on phase 2's
    operator at tag 1, every candidate bitwise the default at tags 1-3,
    then replay (a hit in memory, then from the file); then a corrupted
    entry (of a small operator's sweep) detected and healed."""
    import torch

    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops
    from repro_torch.perf import autotune, tunecache
    from repro_torch.perf.plan import DEFAULT_PLAN, resolve
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    out = {}
    for nrhs, x, kernel in ((1, x32, K.gse_spmv_ell_f32),
                            (NRHS, x32n, C.gse_spmm_ell_f32)):
        stats0 = dict(tunecache.TUNE_STATS)
        t0 = time.perf_counter()
        plan, payload, hit = autotune.get_or_tune(g, tag=1, layout="ell",
                                                  nrhs=nrhs, **SWEEP_TIMING)
        sweep_s = time.perf_counter() - t0
        if hit or tunecache.TUNE_STATS["sweeps"] != stats0["sweeps"] + 1:
            raise AssertionError(f"phase 25: the ELL nrhs {nrhs} sweep did "
                                 "not run once")

        def run(p, t, x=x):
            if nrhs == 1:
                return ops.gse_spmv_ell(ell, g.table, x, g.ei_bit, tag=t,
                                        plan=p, row_len=row_len)
            return ops.gse_spmm_ell(ell, g.table, x, g.ei_bit, tag=t,
                                    plan=p, row_len=row_len)

        for t in TAGS:
            want = run(DEFAULT_PLAN, t)
            for cand in autotune.candidates("ell"):
                require_bitwise(f"phase 25: {kernel.__name__} lanes "
                                f"{cand.lanes} tag {t} against the default",
                                run(cand, t), want)
        want = run(DEFAULT_PLAN, 1)
        if resolve(g, tag=1, layout="ell", nrhs=nrhs) != plan:
            raise AssertionError("phase 25: the tuned ELL plan does not "
                                 "resolve")
        got = (ops.planned_spmv(g, x, tag=1) if nrhs == 1
               else ops.planned_spmm(g, x, tag=1))
        require_bitwise(f"phase 25: planned nrhs {nrhs} through the tuned "
                        "plan against the default", got, want)
        # Replay: a hit in memory, then from the file; no sweep, no launch.
        torch.cuda.synchronize()
        launches = kernel.launches
        sweeps = tunecache.TUNE_STATS["sweeps"]
        replay = []
        for drop in (False, True):
            if drop:
                tunecache.clear_memory()
            p2, payload2, hit2 = autotune.get_or_tune(g, tag=1, layout="ell",
                                                      nrhs=nrhs)
            replay.append(hit2 and p2 == plan and payload2 == payload)
        torch.cuda.synchronize()
        if not all(replay) or tunecache.TUNE_STATS["sweeps"] != sweeps \
                or kernel.launches != launches:
            raise AssertionError(f"phase 25: ELL nrhs {nrhs} replay "
                                 f"{replay}, sweeps {sweeps} -> "
                                 f"{tunecache.TUNE_STATS['sweeps']}, "
                                 f"launches {launches} -> {kernel.launches}")
        out[nrhs] = payload
        log("perf", part="b", kernel=kernel.__name__, nrhs=nrhs,
            winner_lanes=plan.lanes, us=f"{payload['us']:.3f}",
            default_us=f"{payload['default_us']:.3f}",
            sweep_us=json.dumps({r["plan"]["lanes"]: round(r["us"], 3)
                                 for r in payload["sweep"]}),
            decode_bound=payload["decode_bound"],
            candidates_bitwise_default_tags_1_3=True,
            planned_bitwise_default=True, replay_hits=replay,
            replay_launches=kernel.launches - launches,
            sweep_s=f"{sweep_s:.2f}")
    # A flipped payload: detected, dropped and re-swept (on a small
    # operator: the full-size pack's checksum would cost seconds a fetch).
    small = pack_csr(G.random_spd(1 << 12, nnz_per_row=8, seed=3,
                                  device=g.device))
    autotune.get_or_tune(small, tag=1, layout="ell")
    path = Path(tunecache.cache_path())
    blob = json.loads(path.read_text())
    name = tunecache.device_name("cuda")
    key = next(k for k in blob["devices"][name]["plans"]
               if k.startswith("m4096r"))
    blob["devices"][name]["plans"][key]["payload"]["us"] = -1.0
    path.write_text(json.dumps(blob))
    tunecache.clear_memory()
    corrupt, sweeps = (tunecache.TUNE_STATS["corrupt"],
                       tunecache.TUNE_STATS["sweeps"])
    _, healed, hit = autotune.get_or_tune(small, tag=1, layout="ell")
    if (hit or tunecache.TUNE_STATS["corrupt"] != corrupt + 1
            or tunecache.TUNE_STATS["sweeps"] != sweeps + 1
            or not healed["us"] > 0):
        raise AssertionError("phase 25: the corrupted entry was not healed")
    log("perf", part="b", corrupted_entry=key, corrupt_detected=1,
        resweep=1, healed_us=f"{healed['us']:.3f}")
    return out


def sell_sweep(ctx):
    """Part c: the SELL sweep of B32 on phase 9's operator at tag 1: every
    candidate pack's B32 (tags 1-3) and C′32 (nrhs 4, tag 1) bitwise the
    default pack's; planned_spmv through the tuned cache entry and
    planned_spmm through the tuned plan bitwise the explicit default
    calls."""
    from repro_torch.kernels import ops
    from repro_torch.perf import autotune, tunecache
    from repro_torch.perf.plan import DEFAULT_PLAN, KernelPlan, resolve

    g, x32, x32n = ctx["g"], ctx["x32"], ctx["x32c"].t().contiguous()
    t0 = time.perf_counter()
    plan, payload, hit = autotune.get_or_tune(g, tag=1, layout="sell",
                                              **SWEEP_TIMING)
    sweep_s = time.perf_counter() - t0
    if hit:
        raise AssertionError("phase 25: the SELL sweep hit an empty cache")
    packs = {sell_plan_name(c): ops.sell_pack_gsecsr(g, plan=c)
             for c in autotune.candidates("sell")}
    default = packs[sell_plan_name(DEFAULT_PLAN)]
    want = {t: ops.gse_spmv_sell(default, x32, tag=t) for t in TAGS}
    want_c = ops.gse_spmm_sell(default, x32n, tag=1)
    for name, sell in packs.items():
        for t in TAGS:
            require_bitwise(f"phase 25: B32 over the {name} pack, tag {t}",
                            ops.gse_spmv_sell(sell, x32, tag=t), want[t])
        require_bitwise(f"phase 25: C′32 over the {name} pack",
                        ops.gse_spmm_sell(sell, x32n, tag=1), want_c)
    if resolve(g, tag=1, layout="sell") != plan:
        raise AssertionError("phase 25: the tuned SELL plan does not resolve")
    require_bitwise("phase 25: planned_spmv (SELL, tuned) against the "
                    "default", ops.planned_spmv(g, x32, tag=1,
                                                layout="sell"), want[1])
    require_bitwise("phase 25: planned_spmm (SELL, the tuned plan) against "
                    "the default", ops.planned_spmm(g, x32n, tag=1,
                                                    layout="sell", plan=plan),
                    want_c)
    log("perf", part="c", kernel="gse_spmv_sell_f32", nrhs=1,
        winner=sell_plan_name(plan), us=f"{payload['us']:.3f}",
        default_us=f"{payload['default_us']:.3f}",
        sweep_us=json.dumps({sell_plan_name(KernelPlan.from_dict(r["plan"])):
                             round(r["us"], 3) for r in payload["sweep"]}),
        slots=json.dumps({k: s.slots for k, s in packs.items()}),
        candidates_bitwise_default=True, planned_bitwise_default=True,
        sweeps=tunecache.TUNE_STATS["sweeps"], sweep_s=f"{sweep_s:.2f}")
    return plan, payload, packs


def ledger_check(g, ell, row_len, x32, x32n, packs9, x9, x9n):
    """Part d: for A32 and C32 on phase 2's ELL and B32 and C′32 on phase
    9's packs, at tags 1-3, the ledger's launch bytes equal the integer
    arguments ops hands the kernel, byte for byte."""
    from repro_torch.kernels import ops
    from repro_torch.perf import ledger

    rows = []
    cases = [("gse_spmv_ell_f32", g, lambda t: ops.gse_spmv_ell(
                  ell, g.table, x32, g.ei_bit, tag=t, row_len=row_len)),
             ("gse_spmm_ell_f32", g, lambda t: ops.gse_spmm_ell(
                 ell, g.table, x32n, g.ei_bit, tag=t, row_len=row_len))]
    for name, sell in packs9.items():
        cases += [(f"gse_spmv_sell_f32 {name}", sell,
                   lambda t, s=sell: ops.gse_spmv_sell(s, x9, tag=t)),
                  (f"gse_spmm_sell_f32 {name}", sell,
                   lambda t, s=sell: ops.gse_spmm_sell(s, x9n, tag=t))]
    for name, src, call in cases:
        for t in TAGS:
            rec = ledger.recorded_launch_bytes(call, t)
            want = (ledger.launch_segment_bytes(src, t),
                    ledger.launch_index_bytes(src))
            if (rec["segments"], rec["index"], rec["launches"]) != \
                    (*want, 1):
                raise AssertionError(f"phase 25: {name} tag {t} recorded "
                                     f"{rec} against the ledger's {want}")
            rows.append((name, t, rec["segments"], rec["index"]))
    log("perf", part="d", launches_checked=len(rows),
        ledger_equals_recorded_arguments=True,
        bytes=json.dumps({f"{n} tag{t}": s + i for n, t, s, i in rows[:6]}))
    return rows


def tuned_service(params, untuned, ctx, plan9, packs9):
    """Part e: SolverService(layout="sell", tune=True) on sk512_rs8_s0
    against the reference's service under the winning plan and bitwise the
    untuned handle (phase 8); then phase 9's 256-iteration check over the
    tuned plan's pack of phase 9's operator."""
    import torch

    from repro_torch.solvers.cg import solve_cg
    from repro_torch.perf import tunecache

    sweeps = tunecache.TUNE_STATS["sweeps"]
    svc, reps, xs, wall = serve_small("cuda", 20000, params,
                                      case=sk512_rs8_s0, layout="sell",
                                      tune=True)
    plan = svc._ops["op"].plan
    if plan is None or plan.source != "tuned" or \
            tunecache.TUNE_STATS["sweeps"] != sweeps + 1:
        raise AssertionError(f"phase 25: register(tune=True) gave {plan}")
    name = sell_plan_name(plan)
    want, want_stats = SELL_PLAN_SERVICE_REF[name]
    got = [list(report_key(r)) for r in reps]
    if got != [list(w) for w in want] or dict(svc.stats) != want_stats:
        raise AssertionError(f"phase 25: the tuned service ({name}): {got} "
                             f"{dict(svc.stats)} != {want} {want_stats}")
    # The trajectory is the untuned handle's, bit for bit.
    reps0, xs0 = untuned
    ref0, _ = SELL_SERVICE_REF[20000]
    if [report_key(r)[:5] for r in reps] != [tuple(w[:5]) for w in ref0]:
        raise AssertionError("phase 25: the tuned service left the untuned "
                             "trajectory")
    for r, r0, x, x0 in zip(reps, reps0, xs, xs0):
        if r.relres != r0.relres:
            raise AssertionError(f"phase 25: request {r.id} relres differs")
        require_bitwise(f"phase 25: tuned service x of request {r.id}", x,
                        x0)
    # Phase 9's 256 iterations over the tuned pack (over C=16's if the
    # default won), bitwise those over the default pack.
    s256 = {}
    name9 = sell_plan_name(plan9)
    for pname in [name9 if name9 != "c8_sNone_pow2" else "c16_sNone_pow2"]:
        sell = packs9[pname]
        t0 = time.perf_counter()
        res = solve_cg(sell, ctx["b"], tol=1e-8, maxiter=256, params=params)
        torch.cuda.synchronize()
        s256[pname] = round((time.perf_counter() - t0) * 1e3 / 256, 3)
        require_bitwise(f"phase 25: 256 iterations over the {pname} pack "
                        "against the default pack's", res.x, ctx["x256"])
    log("perf", part="e", case="sk512_rs8_s0", winner=name,
        iters=[r.iters for r in reps], est_bytes=[r.est_bytes for r in reps],
        stats=json.dumps(dict(svc.stats)), matches_reference_plan=True,
        x_bitwise_untuned=True, gpu_s=f"{wall:.2f}",
        skewed_pack=name9, x256_bitwise_default_pack=True,
        ms_per_iteration_256=json.dumps(s256))


def decode_crossover(g2, ell2, row_len2):
    """Part f: the nnz below which A32 at tag 3 takes no more than
    CROSSOVER_RATIO times its tag-1 time on random_spd(n, 8): A32's
    device time, launches queued behind a spacer (``queued_ms``).  The
    time a caller of the wrapper sees, the host's launch included
    (``cuda_ms``), is printed beside."""
    import torch

    from repro_torch.core.precision_table import TAG_BITS_USED
    from repro_torch.kernels import gse_spmv as K, ops, ref
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    dev = g2.device
    # About 2.7 ms of FP32 matmul: longer than the host takes to launch 20
    # calls of A32.
    sa = torch.ones(4096, 4096, device=dev)
    sc_out = torch.empty_like(sa)

    def spacer():
        torch.mm(sa, sa, out=sc_out)

    rows = []
    for n in CROSSOVER_N + (g2.shape[0],):
        if n == g2.shape[0]:
            g, ell, row_len = g2, ell2, row_len2
        else:
            g = pack_csr(G.random_spd(n, nnz_per_row=8, seed=n, device=dev))
            ell, row_len = ops.ell_pack_gsecsr(g), ops.ell_row_lengths(g)
        x = torch.ones(n, dtype=torch.float32, device=dev)
        sc = {t: ref.make_scales(g.table, TAG_BITS_USED[t]) for t in (1, 3)}

        def a32(t):
            return K.gse_spmv_ell_f32(
                ell[0], ell[1], ell[2] if t >= 2 else None,
                ell[3] if t == 3 else None, x, sc[t], ei_bit=g.ei_bit, tag=t,
                row_len=row_len)

        # The card idled while the host generated the operator: launch
        # until its clocks are up, then time the two tags in turns.
        for _ in range(200):
            a32(3)
        ms = {1: float("inf"), 3: float("inf")}
        wall = dict(ms)
        for _ in range(2):
            for t in (1, 3):
                ms[t] = min(ms[t], queued_ms(lambda t=t: a32(t), reps=5,
                                             inner=20, spacer=spacer))
                wall[t] = min(wall[t], cuda_ms(lambda t=t: a32(t), reps=5,
                                               inner=20))
        rows.append((n, g.nnz, ms[1], ms[3], ms[3] / ms[1]))
        log("perf", part="f", n=n, nnz=g.nnz, tag1_ms=f"{ms[1]:.5f}",
            tag3_ms=f"{ms[3]:.5f}", ratio=f"{ms[3] / ms[1]:.4f}",
            wall_tag1_ms=f"{wall[1]:.5f}", wall_tag3_ms=f"{wall[3]:.5f}",
            wall_ratio=f"{wall[3] / wall[1]:.4f}")
    # The crossover: the smallest operator from which on every ratio
    # exceeds CROSSOVER_RATIO (None if the largest does not).
    within = [i for i, r in enumerate(rows) if r[4] <= CROSSOVER_RATIO]
    first = within[-1] + 1 if within else 0
    crossover = rows[first][1] if first < len(rows) else None
    log("perf", part="f", crossover_nnz=crossover, ratio=CROSSOVER_RATIO,
        above_below_the_crossover=[r[1] for r in rows[:first]
                                   if r[4] > CROSSOVER_RATIO])
    return crossover, rows


def phase_perf(g, ell, row_len, x32, x32n, params, sell_ctx, untuned):
    """Phase 25: the perf layer on the card.  Returns the probed roof (for
    phase 10's roofline_fraction), the crossover and the sweeps."""
    from repro_torch.core.precision_table import TAG_BITS_USED
    from repro_torch.kernels import gse_spmv as K, ops, ref
    from repro_torch.perf import roofline, timing, tunecache

    t_start = time.perf_counter()
    tunecache.clear_memory()
    tunecache.reset()
    # a. the roof of this card, probed and persisted.
    t0 = time.perf_counter()
    roof = roofline.host_roofline(device="cuda", refresh=True)
    again = roofline.host_roofline(device="cuda")
    if not roof["probed"] or again["probed"] or any(
            again[k] != roof[k] for k in ("stream_gbps", "peak_gflops")):
        raise AssertionError(f"phase 25: the roof was not persisted: {roof} "
                             f"then {again}")
    log("perf", part="a", stream_gbps=f"{roof['stream_gbps']:.1f}",
        peak_gflops=f"{roof['peak_gflops']:.1f}",
        assumed_stream_gbps=ROOF_ASSUMED["stream_gbps"],
        assumed_peak_gflops=ROOF_ASSUMED["peak_gflops"],
        stream_n=roof["stream_n"], matmul_n=roof["matmul_n"],
        second_call_probed=again["probed"], device=roof["device"],
        seconds=f"{time.perf_counter() - t0:.2f}")
    t1 = time.perf_counter()
    ell_payloads = ell_sweep(g, ell, row_len, x32, x32n)
    t2 = time.perf_counter()
    plan9, sell_payload, packs9 = sell_sweep(sell_ctx)
    t3 = time.perf_counter()
    x9 = sell_ctx["x32"]
    ledger_check(g, ell, row_len, x32, x32n,
                 {"default": packs9["c8_sNone_pow2"],
                  "tuned": packs9[sell_plan_name(plan9)]},
                 x9, sell_ctx["x32c"].t().contiguous())
    t4 = time.perf_counter()
    tuned_service(params, untuned, sell_ctx, plan9, packs9)
    del packs9
    t5 = time.perf_counter()
    crossover, crossover_rows = decode_crossover(g, ell, row_len)
    t6 = time.perf_counter()
    # g. timing.measure beside cuda_ms on one call (printed, not a gate).
    sc = ref.make_scales(g.table, TAG_BITS_USED[1])
    a32 = lambda: K.gse_spmv_ell_f32(ell[0], ell[1], None, None, x32, sc,
                                     ei_bit=g.ei_bit, tag=1, row_len=row_len)
    _, sec = timing.measure(a32, iters=10, warmup=2)
    log("perf", part="g", kernel="gse_spmv_ell_f32", tag=1,
        timing_measure_ms=f"{sec * 1e3:.5f}",
        cuda_ms=f"{cuda_ms(a32, reps=10):.5f}")
    log("perf", seconds=f"{time.perf_counter() - t_start:.1f}",
        roof_s=f"{t1 - t_start:.1f}", ell_sweep_s=f"{t2 - t1:.1f}",
        sell_sweep_s=f"{t3 - t2:.1f}", ledger_s=f"{t4 - t3:.1f}",
        service_s=f"{t5 - t4:.1f}", crossover_s=f"{t6 - t5:.1f}",
        tune_stats=json.dumps(dict(tunecache.TUNE_STATS)),
        pack_stats=json.dumps(dict(ops.PACK_STATS)))
    return dict(roof=roof, crossover=crossover, crossover_rows=crossover_rows,
                ell=ell_payloads, sell=sell_payload)


# --- the CPU twins -----------------------------------------------------------
# The twins run in three processes of their own: the small solves on one
# core, in the order the phases need them, from before the build; phase
# 35's train twin on two cores from before the build; and phase 12's LM,
# phase 26's hybrid and phase 28's moe from after it.  A phase waits only
# if its twin is not done yet.
SMALL_TWINS = ("trajectory", "service", "sell", "gmres", "pcg", "ir",
               "telemetry", "serve_async", "rwkv", "encdec", "vlm")
LM_TWINS = ("lm", "hybrid", "moe")
# Phase 35's twin: three f32 train steps of a 1.59 B-weight model on the
# host (AdamW's passes over four copies of the weights dominate), in a
# process of its own on two threads from the start.
TRAIN_TWINS = ("train",)


def twin_trajectory(where, params):
    """Phase 3's solve: spd_rs8_2k through solve_cg on ``where``; returns
    the result and the seconds."""
    import numpy as np
    import torch

    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    small = G.diag_rescale(G.random_spd(2000, seed=21, device="cpu"), 8.0, 21)
    bs = torch.from_numpy(host_spmv(small, np.random.default_rng(0).normal(
        size=2000)))
    gs = pack_csr(G.diag_rescale(G.random_spd(2000, seed=21, device=where),
                                 8.0, 21))
    t0 = time.perf_counter()
    r = solve_cg(gs, bs.to(where), tol=1e-8, maxiter=20000, params=params)
    return r, time.perf_counter() - t0


def cpu_twin(name: str):
    """The CPU twin ``name``: what its phase holds the card's runs to."""
    from repro_torch.core.precision import MonitorParams

    params = MonitorParams(**MAIN_PARAMS)
    if name == "trajectory":
        return twin_trajectory("cpu", params)
    if name == "service":
        return serve_small("cpu", 200, params)[1:]
    if name == "sell":
        return (sell_solo("cpu", params),
                serve_small("cpu", 200, params, case=sk512_rs8_s0,
                            layout="sell")[1:])
    if name == "gmres":
        return {pre: gmres_example_solve("cpu", pre)
                for pre in (None, "jacobi")}
    if name == "pcg":
        return {kind: pcg_solve(kind, "cpu") for kind in PCG_REF}
    if name == "ir":
        out = {run: ir_solve("cpu", run) for run in IR_REF}
        out["batched"] = ir_batched_solve("cpu")
        for kind, maxiter in PCG_SERVICE_REF:
            if maxiter == 4:
                out["service", kind] = serve_small("cpu", maxiter, params,
                                                   precond=kind)[1:]
        return out
    if name == "telemetry":
        out = {run: twin_batched("cpu", run == "pcg_batched", params)[:2]
               for run in ("cg_batched", "pcg_batched")}
        out["ir"] = twin_ir("cpu")
        for mode in FAULT_MODES:
            out[mode] = twin_fault("cpu", mode, params)
        return out
    if name == "serve_async":
        return serve_scenario("cpu")
    if name == "lm":
        return lm_twin_cpu()
    if name == "hybrid":
        return hybrid_twin_cpu()
    if name == "moe":
        return moe_twin_cpu()
    if name == "rwkv":
        return rwkv_twin_cpu()
    if name == "encdec":
        return ev_twin_cpu("seamless_m4t_large_v2")
    if name == "vlm":
        return ev_twin_cpu("internvl2_2b")
    if name == "train":
        return train_twin_run("cpu")[0]
    raise KeyError(name)


def twin_of(twins, name: str):
    """The CPU twin ``name`` from ``twins`` (a CpuTwins), or computed here
    when ``twins`` is None (a phase run alone), each packed weight decoded
    once as in twin_worker."""
    if twins is not None:
        return twins.get(name)
    from repro_torch.kernels.gse_matmul import plain_memo

    with plain_memo():
        return cpu_twin(name)


def twin_worker(names: str, out: str, threads: int):
    """Compute the CPU twins ``names`` (comma-separated) in order on
    ``threads`` threads, each saved to ``out/<name>.pt`` when done (a
    failure's traceback to ``out/<name>.err``), the plain E's decoded
    weights kept within each (``gse_matmul.plain_memo``).  The process
    yields the host's cores to the card's launching thread (niceness
    10)."""
    import traceback

    import torch

    from repro_torch.kernels.gse_matmul import plain_memo

    os.nice(10)
    torch.set_num_threads(threads)
    for name in names.split(","):
        try:
            with plain_memo():  # each packed weight decoded once
                res = cpu_twin(name)
        except BaseException:
            Path(out, f"{name}.err").write_text(traceback.format_exc())
            raise
        tmp = Path(out, f"{name}.tmp")
        torch.save(res, tmp)
        os.replace(tmp, Path(out, f"{name}.pt"))


class CpuTwins:
    """The CPU twins' processes (CUDA hidden from them) and their results
    by name; ``waited`` holds the seconds each ``get`` waited."""

    def __init__(self, out: Path):
        self.out = out
        self.waited = {}
        self.procs = {}

    def start(self, names, threads: int):
        """Start a process computing the twins ``names`` in order."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="")
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                f"import chip_smoke; chip_smoke.twin_worker("
                f"{','.join(names)!r}, {str(self.out)!r}, {threads})")
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                                env=env)
        self.procs.update({name: proc for name in names})

    def get(self, name: str, timeout: float = 900.0):
        import torch

        t0 = time.perf_counter()
        path, proc = self.out / f"{name}.pt", self.procs[name]
        while not path.exists():
            if proc.poll() is not None and not path.exists():
                err = self.out / f"{name}.err"
                raise AssertionError(
                    f"the CPU twin {name!r} failed (exit {proc.returncode})"
                    + (":\n" + err.read_text() if err.exists() else ""))
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"the CPU twin {name!r} took over "
                                     f"{timeout:.0f} s more")
            time.sleep(0.05)
        self.waited[name] = time.perf_counter() - t0
        return torch.load(path, weights_only=False)

    def stop(self):
        for proc in set(self.procs.values()):
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def main() -> int:
    import argparse
    import tempfile

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, default=None,
                    help="an earlier checkout whose A32 and C32 phase 10 "
                         "times beside this tree's (earlier_ms)")
    opts = ap.parse_args()
    # Phases 35-37 train under torch.use_deterministic_algorithms, which
    # needs cuBLAS's fixed workspace, set before the first handle.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # A crash in native code prints the Python stack of every thread.
    faulthandler.enable()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs the port on a GPU only")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_twins_") as tmp:
        # The run's tune cache (phase 25): each run sweeps once, then
        # replays from this file.
        os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tmp, "tunecache.json"))
        twins = CpuTwins(Path(tmp))
        try:
            twins.start(SMALL_TWINS, 1)
            twins.start(TRAIN_TWINS, 2)
            return run(opts, twins)
        finally:
            twins.stop()


def run(opts, twins) -> int:
    """The phases in order, the CPU twins computed beside them by
    ``twins`` (a :class:`CpuTwins`)."""
    import numpy as np
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.kernels import _build, gse_spmv as K, ops, ref
    from repro_torch.kernels import gse_spmm as C
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.core.precision_table import TAG_BITS_USED
    from repro_torch.robustness.guards import health_name
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr
    from repro_torch.sparse.spmv import decode_gsecsr, spmv_gse

    dev = torch.device("cuda")
    params = MonitorParams(**MAIN_PARAMS)

    # 1. build, its nvcc processes beside phase 2's matrix generation -------
    from concurrent.futures import ThreadPoolExecutor

    t_start = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(_build.build_all)
        t0 = time.perf_counter()
        csr = G.diag_rescale(G.random_spd(N_FULL, nnz_per_row=8, seed=21,
                                          device=dev), 8.0, 21)
        g = pack_csr(csr)
        ell = ops.ell_pack_gsecsr(g)
        row_len = ops.ell_row_lengths(g)  # A32 and C32 read only these slots
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t0
        build.result()
    for name, info in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln]
        log("build", source=f"{name}.cu", nvcc_s=f"{info['seconds']:.2f}",
            ptxas=json.dumps(regs))
    log("build", total_s=f"{time.perf_counter() - t_start:.2f}")
    # Phase 12's and 26's twins are needed last: they start after the
    # build, on the cores the card's host thread, the small twins and the
    # host's own numpy work leave.
    twins.start(LM_TWINS, max(1, len(os.sched_getaffinity(0)) - 5))

    # 29, 31. the moe and ssm families at full width, first: the card holds
    # only phase 2's operator yet (qwen3_moe's init holds ~68 GB) -------
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 router, decay
    moe_counts = phase_moe_full()
    expert_decode_timing()
    t1 = time.perf_counter()
    rwkv_counts = phase_rwkv_full()
    t2 = time.perf_counter()
    # 33. the encdec and vlm families whole, after the moe init's 68 GB.
    ev_counts = phase_ev_full()
    log("moe_rwkv_full", moe_full_s=f"{t1 - t0:.1f}",
        rwkv_full_s=f"{t2 - t1:.1f}",
        ev_full_s=f"{time.perf_counter() - t2:.1f}",
        run_s=f"{time.perf_counter() - t_start:.1f}")

    # 2. kernel parity at full size ------------------------------------------
    log("parity", rows=g.shape[0], nnz=g.nnz, ell_width=ell[0].shape[1],
        real_slot_share=g.nnz / ell[0].numel(),
        generate_pack_s=f"{generate_s:.2f}", beside_the_build=True)
    rng = np.random.default_rng(0)
    x32 = torch.from_numpy(rng.normal(size=N_FULL).astype(np.float32)).to(dev)
    x64 = torch.from_numpy(rng.normal(size=N_FULL)).to(dev)
    scales = {t: ref.make_scales(g.table, TAG_BITS_USED[t]) for t in TAGS}
    a32_err, a64_err = {}, {}
    for t in TAGS:
        t1 = ell[2] if t >= 2 else None
        t2 = ell[3] if t == 3 else None
        got = K.gse_spmv_ell_f32(ell[0], ell[1], t1, t2, x32, scales[t],
                                 ei_bit=g.ei_bit, tag=t, row_len=row_len)
        want = K.gse_spmv_ell_f32_plain(ell[0], ell[1], t1, t2, x32,
                                        scales[t], ei_bit=g.ei_bit, tag=t)
        require_bitwise(f"A32 tag {t} against its plain version", got, want)
        a32_err[t] = float((got - want).abs().max())
        args = (g.rowptr, g.colpak, g.head, g.tail1, g.tail2, g.table, x64)
        got = K.gse_spmv_csr_f64(*args, ei_bit=g.ei_bit, tag=t,
                                 plan=g.row_plan)
        want = K.gse_spmv_csr_f64_plain(*args, ei_bit=g.ei_bit, tag=t)
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            bad = int((got.view(torch.int64) != want.view(torch.int64)).sum())
            raise AssertionError(f"A64 tag {t}: {bad} rows not bitwise equal")
        a64_err[t] = float((got - want).abs().max())
        log("parity", tag=t, a32_max_abs_err=a32_err[t], a32_bitwise=True,
            a64_bitwise=True)
    u64 = torch.from_numpy(rng.normal(size=N_FULL)).to(dev)
    alpha = torch.tensor(rng.normal(), dtype=torch.float64, device=dev)
    vec_err = {}
    for name, got, want in (
            ("seq_dot", V.seq_dot(u64, x64), V.seq_dot_plain(u64, x64)),
            ("fma_axpy", V.fma_axpy(alpha, u64, x64),
             V.fma_axpy_plain(alpha, u64, x64))):
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            raise AssertionError(f"{name} is not bitwise equal to its plain "
                                 f"version: {got.flatten()[:4]} vs "
                                 f"{want.flatten()[:4]}")
        vec_err[name] = float((got - want).abs().max())
        log("parity", kernel=name, n=N_FULL, bitwise=True)

    # Kernel C and the column-batched vector kernels, at the service's
    # slot width.
    x32c = torch.from_numpy(
        rng.normal(size=(NRHS, N_FULL)).astype(np.float32)).to(dev)
    x64c = torch.from_numpy(rng.normal(size=(NRHS, N_FULL))).to(dev)
    y64c = torch.from_numpy(rng.normal(size=(NRHS, N_FULL))).to(dev)
    x32n = x32c.t().contiguous()  # C32 and C′32 read X as (n, nrhs)
    c32_err = {}
    for t in TAGS:
        t1 = ell[2] if t >= 2 else None
        t2 = ell[3] if t == 3 else None
        got = C.gse_spmm_ell_f32(ell[0], ell[1], t1, t2, x32n, scales[t],
                                 ei_bit=g.ei_bit, tag=t, row_len=row_len)
        want = C.gse_spmm_ell_f32_plain(ell[0], ell[1], t1, t2, x32n,
                                        scales[t], ei_bit=g.ei_bit, tag=t)
        for j in range(NRHS):
            require_bitwise(f"C32 tag {t} column {j} against its plain "
                            "version", got[:, j], want[:, j])
        c32_err[t] = float((got - want).abs().max())
        one = C.gse_spmm_ell_f32(ell[0], ell[1], t1, t2, x32[:, None],
                                 scales[t], ei_bit=g.ei_bit, tag=t,
                                 row_len=row_len)
        a32 = K.gse_spmv_ell_f32(ell[0], ell[1], t1, t2, x32, scales[t],
                                 ei_bit=g.ei_bit, tag=t, row_len=row_len)
        require_bitwise(f"C32 tag {t} at nrhs=1 against A32", one[:, 0], a32)
        log("parity", kernel="gse_spmm_ell_f32", tag=t, nrhs=NRHS,
            max_abs_err=c32_err[t], bitwise_per_column=True,
            nrhs1_bitwise_a32=True)
    ell_padding_nan("main", g, ell, x32, x32n, scales)
    c64_tags = torch.tensor([1, 2, 3, 1], dtype=torch.int32, device=dev)
    c64_active = torch.tensor([True, True, True, False], device=dev)
    segs = (g.rowptr, g.colpak, g.head, g.tail1, g.tail2, g.table)
    C.reset_launch_counts()
    got = C.gse_spmm_csr_f64(*segs, x64c, c64_tags, c64_active,
                             ei_bit=g.ei_bit, plan=g.row_plan)
    require_bodies("phase 2: C64", C.gse_spmm_csr_f64.body_launches,
                   plan_bodies(g))
    want = C.gse_spmm_csr_f64_plain(*segs, x64c, c64_tags, c64_active,
                                    ei_bit=g.ei_bit)
    require_bitwise("C64 against its plain version", got, want)
    c64_err = float((got - want).abs().max())
    for j in range(3):
        require_bitwise(f"C64 column {j} against A64 at tag {j + 1}", got[j],
                        K.gse_spmv_csr_f64(*segs, x64c[j], ei_bit=g.ei_bit,
                                           tag=j + 1, plan=g.row_plan))
    if not bool((got[3] == 0).all()):
        raise AssertionError("C64 wrote an inactive column")
    log("parity", kernel="gse_spmm_csr_f64", tags=[1, 2, 3, 1],
        active=[True, True, True, False], bitwise=True,
        columns_bitwise_a64=True)
    cols_active = torch.tensor([True, True, True, False], device=dev)
    dots = V.seq_dot_cols(x64c, y64c, cols_active)
    for j in range(3):
        require_bitwise(f"seq_dot_cols column {j}", dots[j],
                        V.seq_dot(x64c[j], y64c[j]))
    alphas = torch.from_numpy(rng.normal(size=NRHS)).to(dev)
    axpy = V.fma_axpy_cols(alphas, x64c, y64c)
    for j in range(NRHS):
        require_bitwise(f"fma_axpy_cols column {j}", axpy[j],
                        V.fma_axpy(alphas[j], x64c[j], y64c[j]))
    vec_err["seq_dot_cols"] = float(
        (dots - V.seq_dot_cols_plain(x64c, y64c, cols_active)).abs().max())
    vec_err["fma_axpy_cols"] = float(
        (axpy - V.fma_axpy_cols_plain(alphas, x64c, y64c)).abs().max())
    log("parity", kernel="seq_dot_cols fma_axpy_cols", nrhs=NRHS, n=N_FULL,
        bitwise_per_column=True,
        max_abs_err_vs_plain=[vec_err["seq_dot_cols"],
                              vec_err["fma_axpy_cols"]])
    sell_main = ops.sell_pack_gsecsr(g)
    sell_against_uniform("main", g, ell, sell_main, x32, x64, x32c, x64c,
                         scales)
    del sell_main

    # 3. trajectory parity: GPU against the CPU twin --------------------------
    rg, tg_s = twin_trajectory("cuda", params)
    rc, tc_s = twins.get("trajectory")
    it_g, it_c = int(rg.iters), int(rc.iters)
    sw_g, sw_c = rg.switch_iters.tolist(), rc.switch_iters.tolist()
    log("trajectory", case="spd_rs8_2k", gpu_iters=it_g, cpu_iters=it_c,
        gpu_tag=int(rg.tag), cpu_tag=int(rc.tag), gpu_switch=sw_g,
        cpu_switch=sw_c, x_bitwise=bitwise(rg.x, rc.x), gpu_s=f"{tg_s:.2f}",
        cpu_s=f"{tc_s:.2f}", cpu_waited_s=f"{twins.waited['trajectory']:.2f}")
    if int(rg.tag) != int(rc.tag) or sw_g != sw_c:
        raise AssertionError("GPU and CPU twin disagree on tag/switch_iters")
    if abs(it_g - it_c) > 0.03 * it_c:
        raise AssertionError(f"iters differ by more than 3%: {it_g} vs {it_c}")
    if not (bool(rg.converged) and bool(rc.converged)):
        raise AssertionError("spd_rs8_2k did not converge on both devices")

    # 4. the main path, counted ------------------------------------------------
    x_true = np.random.default_rng(1).normal(size=N_FULL)
    b = torch.from_numpy(host_spmv(csr, x_true)).to(dev)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    V.reset_launch_counts()
    ell_main = ops.ell_pack_gsecsr(g)  # cache hit: CRC-verified, no repack
    a32_launches = {}
    for t in TAGS:
        before = K.gse_spmv_ell_f32.launches
        y = ops.gse_spmv_ell(ell_main, g.table, x32, g.ei_bit, tag=t,
                             row_len=ops.ell_row_lengths(g))
        a32_launches[t] = K.gse_spmv_ell_f32.launches - before
        if y.shape != (N_FULL,) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"gse_spmv_ell tag {t}: bad output")
    t0 = time.perf_counter()
    res = solve_cg(g, b, tol=MAIN_TOL, maxiter=20000, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a64_launches = K.gse_spmv_csr_f64.launches
    a64_body_launches = dict(K.gse_spmv_csr_f64.body_launches)
    vec_launches = {"seq_dot": V.seq_dot.launches,
                    "fma_axpy": V.fma_axpy.launches}
    true_rel = float(torch.linalg.norm(b - spmv_gse(g, res.x, 3))
                     / torch.linalg.norm(b))
    err = float(torch.linalg.norm(res.x - torch.from_numpy(x_true).to(dev))
                / np.linalg.norm(x_true))
    log("main", iters=int(res.iters), tag=int(res.tag),
        switch_iters=res.switch_iters.tolist(), converged=bool(res.converged),
        health=health_name(res.health), relres=float(res.relres),
        true_relres_tag3=true_rel, x_rel_err=err, wall_s=f"{wall:.2f}",
        a64_launches=a64_launches,
        a64_body_launches=json.dumps(a64_body_launches),
        a32_launches=sum(a32_launches.values()),
        seq_dot_launches=vec_launches["seq_dot"],
        fma_axpy_launches=vec_launches["fma_axpy"])
    if min(a64_launches, *a32_launches.values(), *vec_launches.values()) <= 0:
        raise AssertionError("a kernel of the main path never launched")
    require_bodies("phase 4: A64", a64_body_launches, plan_bodies(g))
    if res.x.shape != (N_FULL,) or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("full-size solve returned a non-finite x")
    # The recursive residual meets tol; the true one sits higher because
    # the tag is switched in place (Algorithm 3) and the recurrence keeps
    # the low-tag operator's error -- the reference shows the same gap
    # (3.4e-4 on spd_rs8_2k); final_correction=True is what closes it.
    if not bool(res.converged) or health_name(res.health) != "ok":
        raise AssertionError(f"full-size solve ended {health_name(res.health)}"
                             f" with converged={bool(res.converged)}")
    if not 0.0 <= true_rel < 1.0:
        raise AssertionError(f"true tag-3 residual {true_rel:.3e}")

    # 5. service trajectory: the reference's reports, GPU against CPU twin ----
    for maxiter in (20000, 200):
        svc_g, reps_g, xs_g, wall_g = serve_small("cuda", maxiter, params)
        want, want_stats = SERVICE_REF[maxiter]
        got = [report_key(r) for r in reps_g]
        if got != want or svc_g.stats != want_stats:
            raise AssertionError(f"service at maxiter {maxiter}: {got} "
                                 f"{svc_g.stats} != {want} {want_stats}")
        if [r.converged for r in reps_g] != [maxiter == 20000] * 3:
            raise AssertionError(f"service at maxiter {maxiter}: converged "
                                 f"{[r.converged for r in reps_g]}")
        twin = {}
        if maxiter == 200:  # the tag-3 retry: GPU == CPU twin, bit for bit
            reps_c, xs_c, wall_c = twins.get("service")
            for rg_, rc_, xg_, xc_ in zip(reps_g, reps_c, xs_g, xs_c):
                if report_fields(rg_) != report_fields(rc_):
                    raise AssertionError(f"GPU report {rg_} != CPU {rc_}")
                require_bitwise(f"service x of request {rg_.id}", xg_, xc_)
            twin = dict(cpu_twin_bitwise=True, cpu_s=f"{wall_c:.2f}")
        log("service_trajectory", case="rs8_400_s3", maxiter=maxiter,
            iters=[r.iters for r in reps_g],
            switch_iters=[r.switch_iters.tolist() for r in reps_g],
            health=[r.health for r in reps_g],
            retries=[r.retries for r in reps_g],
            est_bytes=[r.est_bytes for r in reps_g],
            stats=json.dumps(dict(svc_g.stats)), matches_reference=True,
            gpu_s=f"{wall_g:.2f}", **twin)

    # 6. the service path at full size, counted --------------------------------
    bs_full = [b] + [torch.from_numpy(host_spmv(
        csr, np.random.default_rng(seed).normal(size=N_FULL))).to(dev)
        for seed in (2, 3)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    C.reset_launch_counts()
    V.reset_launch_counts()
    c32_launches = {}
    for t in TAGS:
        before = C.gse_spmm_ell_f32.launches
        y = ops.gse_spmm_ell(ell_main, g.table, x32c.t(), g.ei_bit, tag=t,
                             row_len=ops.ell_row_lengths(g))
        c32_launches[t] = C.gse_spmm_ell_f32.launches - before
        if y.shape != (N_FULL, NRHS) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"gse_spmm_ell tag {t}: bad output")
    t0 = time.perf_counter()
    svc = SolverService(slots=NRHS, params=params, maxiter=20000)
    svc.register("full", csr, k=8)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t0
    ids = [svc.submit("full", bj, tol=MAIN_TOL) for bj in bs_full]
    t0 = time.perf_counter()
    reports = svc.flush()
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    c64_launches = C.gse_spmm_csr_f64.launches
    c64_body_launches = dict(C.gse_spmm_csr_f64.body_launches)
    cols_launches = {"seq_dot_cols": V.seq_dot_cols.launches,
                     "fma_axpy_cols": V.fma_axpy_cols.launches}
    reps = [reports[i] for i in ids]
    x_req0 = svc.solution(ids[0])
    x_req1 = svc.solution(ids[1])  # phase 24 joins this request
    loop_iters = max(r.iters for r in reps)
    ms6 = f"{serve_wall * 1e3 / loop_iters:.3f}"
    log("service", rows=N_FULL, slots=NRHS, requests=len(reps),
        iters=[r.iters for r in reps], tag=[r.tag for r in reps],
        switch_iters=[r.switch_iters.tolist() for r in reps],
        health=[r.health for r in reps], retries=[r.retries for r in reps],
        relres=[r.relres for r in reps], est_bytes=[r.est_bytes for r in reps],
        stats=json.dumps(dict(svc.stats)), register_s=f"{register_s:.2f}",
        wall_s=f"{serve_wall:.2f}",
        ms_per_iteration=ms6,
        solo_ms_per_iteration=f"{wall * 1e3 / int(res.iters):.3f}",
        c64_launches=c64_launches,
        c64_body_launches=json.dumps(c64_body_launches),
        c32_launches=sum(c32_launches.values()),
        seq_dot_cols_launches=cols_launches["seq_dot_cols"],
        fma_axpy_cols_launches=cols_launches["fma_axpy_cols"])
    solo = (int(res.iters), res.switch_iters.tolist(), int(res.tag))
    if (reps[0].iters, reps[0].switch_iters.tolist(), reps[0].tag) != solo:
        raise AssertionError(f"request 0 {reps[0]} != the solo solve {solo}")
    if reps[0].relres != float(res.relres):
        raise AssertionError(f"request 0 relres {reps[0].relres!r} != the "
                             f"solo solve's {float(res.relres)!r}")
    require_bitwise("request 0's x against the solo solve", x_req0, res.x)
    for r in reps:
        if not r.converged or r.health != "ok" or r.retries != 0:
            raise AssertionError(f"full-size request {r.id}: {r}")
    if svc.stats["errors"] != 0:
        raise AssertionError(f"service errors: {svc.stats}")
    if min(c64_launches, *c32_launches.values(),
           *cols_launches.values()) <= 0:
        raise AssertionError("a kernel of the service path never launched")
    require_bodies("phase 6: C64", c64_body_launches, plan_bodies(g))

    # 7-9. the SELL-C-sigma layout --------------------------------------------
    phase_sell_parity()
    untuned = phase_sell_trajectory(params, twins)
    sell_ctx = phase_sell_full(params)

    # 15-20. stepped GMRES, PCG and iterative refinement ------------------------
    t0 = time.perf_counter()
    gmres_ctx = phase_gmres_trajectory(twins)
    t1 = time.perf_counter()
    gmres_launches, gmres_full = phase_gmres_full()
    t2 = time.perf_counter()
    phase_pcg_trajectory(twins)
    t3 = time.perf_counter()
    pcg_res = phase_pcg_full(csr, g, b, params, res, wall)
    t4 = time.perf_counter()
    phase_ir_trajectory(params, twins)
    t5 = time.perf_counter()
    ir20 = phase_ir_full(csr, g, b, bs_full, params, pcg_res)
    t6 = time.perf_counter()
    log("solver_phases", gmres_trajectory_s=f"{t1 - t0:.1f}",
        gmres_full_s=f"{t2 - t1:.1f}", pcg_trajectory_s=f"{t3 - t2:.1f}",
        pcg_full_s=f"{t4 - t3:.1f}", ir_trajectory_s=f"{t5 - t4:.1f}",
        ir_full_s=f"{t6 - t5:.1f}")

    # 21-22. per-group precision ---------------------------------------------
    phase_tagmap_trajectory()
    t7 = time.perf_counter()
    adaptive_ctx = phase_adaptive_full()
    log("tagmap_phases", tagmap_trajectory_s=f"{t7 - t6:.1f}",
        adaptive_full_s=f"{time.perf_counter() - t7:.1f}")

    # 23. telemetry, faults and checkpoints ----------------------------------
    t8 = time.perf_counter()
    phase_telemetry(g, b, params, res, wall,
                    dict(a64=a64_launches, **vec_launches), gmres_full, twins)
    del gmres_full
    log("telemetry_phase", seconds=f"{time.perf_counter() - t8:.1f}")

    # 24. async serving --------------------------------------------------------
    t9 = time.perf_counter()
    phase_serve_small(twins)
    t10 = time.perf_counter()
    phase_serve_full(csr, b, bs_full[1], params, res, wall, reps[1], x_req1,
                     ms6)
    t11 = time.perf_counter()
    phase_serve_ir(g, b, params, *ir20)
    del ir20, x_req1
    log("serve_async_phase", part1_s=f"{t10 - t9:.1f}",
        part2_s=f"{t11 - t10:.1f}",
        part3_s=f"{time.perf_counter() - t11:.1f}",
        seconds=f"{time.perf_counter() - t9:.1f}")

    # 25. the perf layer: roofline, sweeps, replay, ledger, crossover -------
    perf = phase_perf(g, ell, row_len, x32, x32n, params, sell_ctx, untuned)
    del untuned

    # 11-14. the LM serving path ----------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain E: full f32
    torch.backends.cudnn.allow_tf32 = False
    # Phase 26's numpy params, made on a thread beside phases 11-14 (numpy
    # releases the GIL while it draws).
    params_pool = ThreadPoolExecutor(1)
    hybrid_params = params_pool.submit(hybrid_params_cpu)
    moe_params = params_pool.submit(moe_params_cpu)
    rwkv_params = params_pool.submit(rwkv_params_cpu)
    ev_params = {arch: params_pool.submit(ev_params_cpu, arch)
                 for arch in ("seamless_m4t_large_v2", "internvl2_2b")}
    t0 = time.perf_counter()
    lm_ctx = phase_lm_kernels()
    t1 = time.perf_counter()
    twin_counts = phase_lm_twin(twins)
    t2 = time.perf_counter()
    lm_counts = phase_lm_full()
    t3 = time.perf_counter()
    lm_counts.update(phase_lm_serve_cli())
    log("lm_phases", lm_kernels_s=f"{t1 - t0:.1f}", lm_twin_s=f"{t2 - t1:.1f}",
        lm_full_s=f"{t3 - t2:.1f}",
        lm_serve_s=f"{time.perf_counter() - t3:.1f}",
        run_s=f"{time.perf_counter() - t_start:.1f}")

    # 26-27. the hybrid family: recurrentgemma_2b --------------------------
    t0 = time.perf_counter()
    hybrid_ctx = phase_hybrid_kernels()
    t1 = time.perf_counter()
    hybrid_twin_counts = phase_hybrid_twin(twins, hybrid_params)
    del hybrid_params
    t2 = time.perf_counter()
    hybrid_counts = phase_hybrid_full()
    log("hybrid_phases", hybrid_kernels_s=f"{t1 - t0:.1f}",
        hybrid_twin_s=f"{t2 - t1:.1f}",
        hybrid_full_s=f"{time.perf_counter() - t2:.1f}",
        run_s=f"{time.perf_counter() - t_start:.1f}")

    # 28, 30. the moe and ssm families against their twins (29 and 31 ran
    # after the build) -----------------------------------------------------
    t0 = time.perf_counter()
    moe_ctx = phase_moe_kernels()
    moe_twin_counts = phase_moe_twin(twins, moe_params)
    del moe_params
    t1 = time.perf_counter()
    rwkv_ctx = phase_rwkv_kernels()
    rwkv_twin_counts = phase_rwkv_twin(twins, rwkv_params)
    del rwkv_params
    # 32. the encdec and vlm families against their twins -------------------
    t2 = time.perf_counter()
    ev_ctx = phase_ev_kernels()
    ev_twin_counts = phase_ev_twin(twins, ev_params)
    params_pool.shutdown()
    del ev_params
    t3 = time.perf_counter()
    cli_counts = serve_cli_archs(("qwen3_moe_235b_a22b", "grok1_314b",
                                  "rwkv6_1p6b", "internvl2_2b"))
    # 34-37. the train path -------------------------------------------------
    t4 = time.perf_counter()
    train_ctx = phase_train_kernels()
    t5 = time.perf_counter()
    train_twin_counts = phase_train_twin(twins)
    t6 = time.perf_counter()
    train_counts = phase_train_full()
    t7 = time.perf_counter()
    phase_train_cli()
    log("train_phases", train_kernels_s=f"{t5 - t4:.1f}",
        train_twin_s=f"{t6 - t5:.1f}", train_full_s=f"{t7 - t6:.1f}",
        train_cli_s=f"{time.perf_counter() - t7:.1f}",
        twin_launches=json.dumps(train_twin_counts),
        run_s=f"{time.perf_counter() - t_start:.1f}")
    log("moe_rwkv_phases", moe_twin_s=f"{t1 - t0:.1f}",
        rwkv_twin_s=f"{t2 - t1:.1f}", ev_twin_s=f"{t3 - t2:.1f}",
        serve_cli_s=f"{t4 - t3:.1f}",
        twin_launches=json.dumps({"moe": moe_twin_counts,
                                  "rwkv": rwkv_twin_counts,
                                  "ev": ev_twin_counts}),
        serve_cli_d_launches=json.dumps(cli_counts),
        run_s=f"{time.perf_counter() - t_start:.1f}")
    log("twins", waited_s=json.dumps({k: round(v, 2)
                                      for k, v in twins.waited.items()}))

    # 10. kernel times ---------------------------------------------------------
    from repro_torch.perf import ledger, roofline

    t_kernels = time.perf_counter()
    m, n = g.shape
    kernels = []
    # The chain bound of the f64 kernels held to the reference's order:
    # one dependent FP64 add (the rows) or FMA (the dots) per element of
    # the longest chain, at the latency this card shows for a chain from
    # registers.
    chain = {op: V.chain_latency(op) for op in ("add", "fma")}
    log("kernels", probe="dependent FP64 chain, one thread, 2^22 steps",
        dadd_ns=f"{chain['add']['ns']:.4f}",
        dadd_clocks=f"{chain['add']['clocks']:.3f}",
        dfma_ns=f"{chain['fma']['ns']:.4f}",
        dfma_clocks=f"{chain['fma']['clocks']:.3f}")
    longest_uniform = int((g.rowptr[1:] - g.rowptr[:-1]).max())
    t0 = time.perf_counter()
    width_sweep(dev)
    log("sweep", seconds=f"{time.perf_counter() - t0:.1f}")

    def chain_ms(steps: int, op: str) -> float:
        return steps * chain[op]["ns"] * 1e-6

    def add_entry(name, source, replaces, launch, plain, lib, nbytes, op_ms,
                  plain_reps=3, reps=10, inner=10, led=None, **extra):
        """One kernel's row; ``led`` (a ``perf.ledger.KernelLedger``) adds
        its roofline fraction at phase 25's probed roof."""
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        plain_ms = extra.pop("plain_ms", None)  # measured by its phase
        if lib is not None:  # the library's first call sets it up: untimed
            lib()
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "ms": cuda_ms(launch, reps=reps, inner=inner),
            "plain_ms": (cuda_ms(plain, reps=plain_reps)
                         if plain_ms is None else plain_ms),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": (cuda_ms(lib, reps=reps, inner=inner)
                           if lib is not None else None),
            "bytes": nbytes,
            **extra,
        }
        if led is not None:
            entry["roofline_fraction"] = roofline.fraction(
                led.flops, led.bytes, entry["ms"] / 1e3, perf["roof"])
        kernels.append(entry)
        log("kernels", name=name, ms=f"{entry['ms']:.4f}",
            plain_ms=f"{entry['plain_ms']:.3f}",
            bound_ms=f"{entry['bound_ms']:.4f}",
            library_ms=(f"{entry['library_ms']:.4f}"
                        if lib is not None else None))

    spmv_src = "src/repro_torch/kernels/csrc/gse_spmv.cu"
    spmm_src = "src/repro_torch/kernels/csrc/gse_spmm.cu"
    x64n = x64c.t().contiguous()  # an (n, nrhs) block for the library SpMM
    earlier = ell_earlier(opts.earlier) if opts.earlier else None
    all_on = torch.ones(NRHS, dtype=torch.bool, device=dev)
    for t in TAGS:
        t1 = ell[2] if t >= 2 else None
        t2 = ell[3] if t == 3 else None
        vals32 = ref.decode_csr_ref(g.colpak, g.head, g.tail1, g.tail2,
                                    g.table, g.ei_bit, t)
        vals64, cols = decode_gsecsr(g, t)
        lib32 = torch.sparse_csr_tensor(g.rowptr, cols.to(torch.int32), vals32,
                                        (m, n))
        lib64 = torch.sparse_csr_tensor(g.rowptr, cols.to(torch.int32), vals64,
                                        (m, n))
        args64 = (*segs, x64)
        tags_t = torch.full((NRHS,), t, dtype=torch.int32, device=dev)
        for (name, src, replaces, launch, plain, lib, xb, ncols, ops_rate,
             err_t, count) in (
            ("gse_spmv_ell_f32", spmv_src, "src/repro/kernels/gse_spmv.py:160",
             lambda lanes=K.ELL_LANES_DEFAULT: K.gse_spmv_ell_f32(
                 ell[0], ell[1], t1, t2, x32, scales[t], ei_bit=g.ei_bit,
                 tag=t, row_len=row_len, lanes=lanes),
             lambda: K.gse_spmv_ell_f32_plain(ell[0], ell[1], t1, t2, x32,
                                              scales[t], ei_bit=g.ei_bit,
                                              tag=t),
             lambda: torch.mv(lib32, x32), 4, 1, FP32_OPS_PER_S, a32_err[t],
             a32_launches[t]),
            ("gse_spmv_csr_f64", spmv_src, "src/repro/kernels/gse_spmv.py:160",
             lambda: K.gse_spmv_csr_f64(*args64, ei_bit=g.ei_bit, tag=t,
                                        plan=g.row_plan),
             lambda: K.gse_spmv_csr_f64_plain(*args64, ei_bit=g.ei_bit, tag=t),
             lambda: torch.mv(lib64, x64), 8, 1, FP64_OPS_PER_S, a64_err[t],
             a64_launches),
            ("gse_spmm_ell_f32", spmm_src, "src/repro/kernels/gse_spmm.py:137",
             lambda lanes=K.ELL_LANES_DEFAULT: C.gse_spmm_ell_f32(
                 ell[0], ell[1], t1, t2, x32n, scales[t], ei_bit=g.ei_bit,
                 tag=t, row_len=row_len, lanes=lanes),
             lambda: C.gse_spmm_ell_f32_plain(ell[0], ell[1], t1, t2, x32n,
                                              scales[t], ei_bit=g.ei_bit,
                                              tag=t),
             lambda: torch.mm(lib32, x32n), 4, NRHS, FP32_OPS_PER_S,
             c32_err[t], c32_launches[t]),
            ("gse_spmm_csr_f64", spmm_src, "src/repro/kernels/gse_spmm.py:137",
             lambda: C.gse_spmm_csr_f64(*segs, x64c, tags_t, all_on,
                                        ei_bit=g.ei_bit, plan=g.row_plan),
             lambda: C.gse_spmm_csr_f64_plain(*segs, x64c, tags_t, all_on,
                                              ei_bit=g.ei_bit),
             lambda: torch.mm(lib64, x64n), 8, NRHS, FP64_OPS_PER_S, c64_err,
             c64_launches),
        ):
            # The decode once per entry, then a product and a sum per column.
            nops = g.nnz * (DECODE_OPS[t] - 2 + 2 * ncols)
            extra = dict(tag=t, nrhs=ncols, launches=count, max_abs_err=err_t)
            if name.endswith("csr_f64"):
                extra["launches_all_tags"] = True  # the tag is chosen on device
                extra["chain_bound_ms"] = chain_ms(longest_uniform, "add")
                extra["longest_row"] = longest_uniform
            if name == "gse_spmv_csr_f64":
                extra["body_launches"] = a64_body_launches
            if name == "gse_spmm_csr_f64":
                extra["body_launches"] = c64_body_launches
            if name.endswith("ell_f32"):
                # The sweep of the lanes a row runs on (the default picked
                # from it), and the earlier tree's time on this operator.
                extra["lanes"] = K.ELL_LANES_DEFAULT
                extra["lanes_ms"] = {
                    lanes: cuda_ms(lambda lanes=lanes: launch(lanes),
                                   reps=10, inner=10)
                    for lanes in K.ELL_LANES}
                extra["real_slots_only"] = True
                if earlier is not None:  # the earlier tree's one run
                    extra["earlier_ms"] = next(iter(
                        earlier[name].values()))[str(t)]
                    extra["earlier_design"] = (
                        "every slot of the 128-wide row on a warp"
                        + (", X (nrhs, n)" if ncols > 1 else ""))
            # The ledger's bytes: today's arithmetic, checked.
            led = ledger.spmv_ledger(g, tag=t, nrhs=ncols, vec_dtype=(
                torch.float32 if xb == 4 else torch.float64))
            if led.bytes != g.bytes_touched(t) + ncols * (m + n) * xb:
                raise AssertionError(f"{name} tag {t}: the ledger's "
                                     f"{led.bytes} bytes")
            add_entry(f"{name}.tag{t}", src, replaces, launch, plain, lib,
                      led.bytes, nops / ops_rate * 1e3, led=led, **extra)
    vec_src = "src/repro_torch/kernels/csrc/vec_f64.cu"
    for name, launch, plain, lib, ncols, plain_reps, count in (
        ("seq_dot", lambda: V.seq_dot(u64, x64),
         lambda: V.seq_dot_plain(u64, x64), lambda: torch.dot(u64, x64), 1, 1,
         vec_launches["seq_dot"]),
        ("fma_axpy", lambda: V.fma_axpy(alpha, u64, x64),
         lambda: V.fma_axpy_plain(alpha, u64, x64),
         lambda: torch.addcmul(x64, alpha, u64), 1, 3,
         vec_launches["fma_axpy"]),
        ("seq_dot_cols", lambda: V.seq_dot_cols(x64c, y64c, all_on),
         lambda: V.seq_dot_cols_plain(x64c, y64c, all_on),
         lambda: torch.linalg.vecdot(x64c, y64c), NRHS, 1,
         cols_launches["seq_dot_cols"]),
        ("fma_axpy_cols", lambda: V.fma_axpy_cols(alphas, x64c, y64c),
         lambda: V.fma_axpy_cols_plain(alphas, x64c, y64c),
         lambda: torch.addcmul(y64c, alphas[:, None], x64c), NRHS, 3,
         cols_launches["fma_axpy_cols"]),
    ):
        dot = name.startswith("seq_dot")
        # A dot is one FMA chain per column (the columns side by side).
        extra = dict(chain_bound_ms=chain_ms(N_FULL, "fma")) if dot else {}
        add_entry(name, vec_src,
                  "src/repro/solvers/fused_cg.py:51" if dot
                  else "src/repro/solvers/fused_cg.py:53",
                  launch, plain, lib, (16 if dot else 24) * N_FULL * ncols,
                  2 * N_FULL * ncols / FP64_OPS_PER_S * 1e3,
                  plain_reps=plain_reps, nrhs=ncols, launches=count,
                  max_abs_err=vec_err[name], **extra)
    gmres_entries(gmres_ctx, gmres_launches, add_entry, chain_ms)
    sell_entries(sell_ctx, add_entry, chain_ms(sell_ctx["longest"], "add"))
    mixed_entries(adaptive_ctx, add_entry)
    lm_entries(lm_ctx, lm_counts, twin_counts, add_entry)
    hybrid_entries(hybrid_ctx, hybrid_counts, hybrid_twin_counts, add_entry)
    moe_rwkv_entries(moe_ctx, moe_counts, rwkv_ctx, rwkv_counts, add_entry)
    ev_entries(ev_ctx, ev_counts, add_entry)
    train_entries(train_ctx, train_counts, add_entry)
    log("kernels", seconds=f"{time.perf_counter() - t_kernels:.1f}",
        total_s=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
