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
solver, right-preconditioned) and preconditioned CG.

Phases:
  1. build     -- nvcc time for every kernel source (all started at once).
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
                  stepped CG (tol 1e-8, MonitorParams(40, 60, 30),
                  maxiter 20000, default guards) on the full-size matrix;
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
                  at tol 1e-8 flushed.  Request 0 (phase 4's b) must equal
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
                  steps, on the card and on its CPU twin: logits within
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
                  tiled) and F's tensor-core body.
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
                  at n = 2^20 and rows 1, 41, 81; givens_step (j 0, 1, 40,
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
                  of the path launched and every body of A64 the row plan
                  holds; ms per inner iteration and launches per
                  iteration printed.
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
  10. kernels  -- run last: CUDA-event times (minimum over repeats) of
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
                  (`body_launches`); E's tiled
                  rows are bound by the TF32 tensor cores (495 TFLOP/s
                  per TF32 term) and F's bf16 rows by the bf16 tensor
                  cores (989 TFLOP/s), with `fp32_bound_ms` beside.
                  The GMRES kernels are timed at phase 15's shapes
                  (their plain versions on the host, `plain_on`), the
                  GEMVs beside torch.mv and the back substitution beside
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

The line before the last two is the ``{"kernels": [...]}`` JSON record,
the line before the last the card's name and power limit, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
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
    """Minimum over ``reps`` of the CUDA-event time of ``inner`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
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
                layout="csr"):
    """``case`` (rs8_400_s3 or sk512_rs8_s0) through the port's
    SolverService on ``where``: three requests b_j = A x_j,
    x_j = default_rng(j).normal(n), slots=4."""
    import numpy as np
    import torch

    from repro_torch.launch.solver_serve import SolverService

    host = case("cpu")
    n = host.shape[0]
    svc = SolverService(slots=NRHS, params=params, maxiter=maxiter,
                        device=where)
    svc.register("op", case(where), k=8, layout=layout)
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


def phase_sell_trajectory(params):
    """Phase 8: sk512_rs8_s0 over its SELL pack, solo and served, on the
    GPU against the CPU twin and the reference's reports."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse.csr import pack_csr

    host = sk512_rs8_s0("cpu")
    b0 = torch.from_numpy(host_spmv(
        host, np.random.default_rng(0).normal(size=host.shape[0])))
    runs = {}
    for where in ("cuda", "cpu"):
        sell = ops.sell_pack_gsecsr(pack_csr(sk512_rs8_s0(where)))
        t0 = time.perf_counter()
        r = solve_cg(sell, b0.to(where), tol=1e-8, maxiter=20000,
                     params=params)
        runs[where] = (r, time.perf_counter() - t0)
    (rg, tg_s), (rc, tc_s) = runs["cuda"], runs["cpu"]
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
        if maxiter == 200:  # the tag-3 retry: GPU == CPU twin, bit for bit
            _, reps_c, xs_c, wall_c = serve_small(
                "cpu", maxiter, params, case=sk512_rs8_s0, layout="sell")
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
            stats=json.dumps(svc_g.stats), matches_reference=True,
            gpu_s=f"{wall_g:.2f}", **twin)


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
        requests=got, stats=json.dumps(svc.stats), flush_s=f"{wall:.2f}")
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
    csr = G.diag_rescale(G.skewed_spd(N_SKEW, seed=5, device=dev), 8.0, 5)
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
        stats=json.dumps(svc.stats), register_s=f"{register_s:.2f}",
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
                longest=longest)


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
# the served configuration (gse_serve tag 2 at bfloat16).
LM_TWIN_VARIANTS = {"dense": {}, "tag1": dict(gse_serve=True, gse_tag=1),
                    "tag2": dict(gse_serve=True, gse_tag=2),
                    "tag2_bf16": dict(gse_serve=True, gse_tag=2,
                                      compute_dtype="bfloat16")}
LM_FULL = dict(batch=4, prompt=512, steps=32)
# The card's logits against the CPU twin's and the reference's: absolute,
# on logits of magnitude up to about 5 (f32 sums in other orders).
LM_TOL = 1e-3
# At bfloat16, tests/test_torch_lm.py's tolerance: the reference rounds
# attention scores, probabilities and products to bf16 where the port's
# plain E and F keep f32, and F's tensor-core body rounds P to bf16.
BF16_TOL = dict(rtol=0.02, atol=0.075)
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
}
LM_LINEAR = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
             ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def lm_tree_np(cfg, seed: int) -> dict:
    """Params of a dense ``cfg`` in the reference's tree layout (stacked
    ``(L, ...)`` layer leaves) as numpy f32, drawn from
    ``default_rng(seed)`` in a fixed order: normal weights scaled by
    1/sqrt(fan-in), as the reference's init scales them, and unit norms.
    ``tools/reference/lm_serve_ref.py`` builds the reference's params from
    this same function."""
    import math

    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(1.0 / math.sqrt(fan_in))
        return a

    n, d, h, kv = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, ff, vp = cfg.hd, cfg.d_ff, cfg.padded_vocab
    return {
        "embed": {"table": normal((vp, d), d)},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "unembed": {"w": normal((d, vp), d)},
        "layers": {
            "norm1": {"scale": np.ones((n, d), np.float32)},
            "attn": {"wq": normal((n, d, h * hd), d),
                     "wk": normal((n, d, kv * hd), d),
                     "wv": normal((n, d, kv * hd), d),
                     "wo": normal((n, h * hd, d), h * hd),
                     "q_norm": np.ones((n, hd), np.float32),
                     "k_norm": np.ones((n, hd), np.float32)},
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
    layout); the other leaves are shared."""
    import torch

    from repro_torch.models.modules import pack_linear_weight
    from repro_torch.tree import tree_map

    out = tree_map(lambda t: t, params)
    out["unembed"]["w"] = pack_linear_weight(params["unembed"]["w"], cfg)
    for group, name in LM_LINEAR:
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


def phase_lm_twin():
    """Phase 12: qwen3_4b at full width, two layers, on the card and as its
    CPU twin from the same numpy params, against each other and against
    the reference's digest (LM_REF): dense and gse_serve tags 1-2 at
    compute_dtype float32, and the served configuration, gse_serve tag 2
    at bfloat16.  Returns the launches per kernel body, summed over the
    f32 variants and (key "bf16") of the bf16 one."""
    import torch

    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.tree import tree_map

    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_matmul as E

    dev = torch.device("cuda")
    tw = LM_TWIN
    cfg0 = dataclasses.replace(get_config("qwen3_4b"),
                               num_layers=tw["layers"],
                               compute_dtype=torch.float32)
    t0 = time.perf_counter()
    dense_cpu = convert.params_from_repro(lm_tree_np(cfg0, LM_SEED),
                                          device="cpu")
    dense_gpu = tree_map(lambda t: t.to(dev), dense_cpu)
    toks = lm_tokens(cfg0, LM_SEED + 1, tw["batch"],
                     tw["prompt"] + tw["steps"])
    log("lm_twin", layers=tw["layers"], d_model=cfg0.d_model,
        vocab=cfg0.vocab_size, batch=tw["batch"], prompt=tw["prompt"],
        steps=tw["steps"], params_s=f"{time.perf_counter() - t0:.2f}")
    counts = {}
    for name, kw in LM_TWIN_VARIANTS.items():
        kw = dict(kw, compute_dtype=getattr(
            torch, kw.get("compute_dtype", "float32")))
        bf16 = kw["compute_dtype"] == torch.bfloat16
        cfg = dataclasses.replace(cfg0, **kw)
        pg = lm_gse_params(dense_gpu, cfg) if cfg.gse_serve else dense_gpu
        pc = tree_map(lambda t: t.cpu(), pg) if cfg.gse_serve else dense_cpu
        torch.cuda.synchronize()
        for mod in (E, F):
            mod.reset_launch_counts()
        lg, sg = lm_run(cfg, pg, toks, dev, tw["prompt"], tw["steps"])
        got = {"e_" + k: v for k, v in E.gse_matmul_dense.body_launches
               .items()}
        got.update({"f_" + k: v for k, v in
                    F.flash_attention_gqa.body_launches.items()})
        lc, sc = lm_run(cfg, pc, toks, "cpu", tw["prompt"], tw["steps"])
        dg = lm_digest(lg)
        ref = [dict(tokens=a, first=b, maxabs=c) for a, b, c in LM_REF[name]]
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"lm_twin {name}: non-finite logits")
        if bf16:
            counts["bf16"] = got
            lm_twin_bf16_check(name, lg, lc, dg, ref, sg, sc, got)
            del pg, pc
            continue
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        twin_err = float((lg - lc).abs().max())
        ref_err = max(max(abs(a - b) for a, b in zip(x["first"], y["first"]))
                      for x, y in zip(dg, ref))
        ref_err = max(ref_err, max(abs(x["maxabs"] - y["maxabs"])
                                   for x, y in zip(dg, ref)))
        tokens = [x["tokens"] for x in dg]
        log("lm_twin", variant=name, gpu_s=f"{sg:.2f}", cpu_s=f"{sc:.2f}",
            twin_max_abs_err=twin_err, ref_max_abs_err=ref_err,
            tol=LM_TOL, logits_maxabs=dg[0]["maxabs"],
            tokens=json.dumps(tokens), launches=json.dumps(got))
        if twin_err > LM_TOL or not torch.equal(lg.argmax(-1), lc.argmax(-1)):
            raise AssertionError(f"lm_twin {name}: card and CPU twin differ "
                                 f"by {twin_err} (tol {LM_TOL}) or in tokens")
        if ref_err > LM_TOL or tokens != [y["tokens"] for y in ref]:
            raise AssertionError(f"lm_twin {name}: card differs from the "
                                 f"reference by {ref_err} (tol {LM_TOL}) or "
                                 "in tokens")
        del pg, pc
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


def lm_twin_bf16_check(name, lg, lc, dg, ref, sg, sc, launches):
    """Phase 12's bf16 variant: the card's logits ``lg`` within BF16_TOL
    of the CPU twin's ``lc`` and of the reference's digest ``ref``, and
    the greedy tokens equal to both wherever the CPU twin's top-2 margin
    exceeds twice the atol (below it, bf16 roundings may flip a token)."""
    import torch

    rtol, atol = BF16_TOL["rtol"], BF16_TOL["atol"]
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
    log("lm_twin", variant=name, gpu_s=f"{sg:.2f}", cpu_s=f"{sc:.2f}",
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
        raise AssertionError(f"lm_twin {name}: card and CPU twin differ by "
                             f"{twin_err}, beyond {BF16_TOL}")
    if ref_excess > 0:
        raise AssertionError(f"lm_twin {name}: card differs from the "
                             f"reference's digest by {ref_err}, beyond "
                             f"{BF16_TOL}")
    if bool((sure & ((tok_g != tok_c) | (tok_g != tok_r))).any()):
        raise AssertionError(f"lm_twin {name}: a greedy token differs where "
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


def phase_gmres_trajectory():
    """Phase 15: the GMRES kernels against their plain versions, then the
    example's case and its right-Jacobi twin on the card and the CPU twin.
    Returns the operands phase 10 times the GEMVs on."""
    import numpy as np
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.kernels import gmres_f64 as GF
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.solvers import make_gse_operator, make_jacobi, solve_gmres
    from repro_torch.sparse.csr import pack_csr

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

    params = MonitorParams(**GMRES_PARAMS)
    for pre in (None, "jacobi"):
        runs = {}
        for where in ("cuda", "cpu"):
            a, b = gmres_example(where)
            kw = dict(tol=1e-7, restart=restart, maxiter=8000, params=params)
            if pre:
                kw["precond"] = make_jacobi(a, k=8)
            t0 = time.perf_counter()
            r = solve_gmres(make_gse_operator(pack_csr(a, k=8)), b, **kw)
            runs[where] = (r, time.perf_counter() - t0)
        (rg, tg_s), (rc, tc_s) = runs["cuda"], runs["cpu"]
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
    kernels."""
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
    return launches


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


def phase_pcg_trajectory():
    """Phase 17: PCG on quickstart section 4's cases, the card against the
    CPU twin, and the fused path against the generic one on the card."""
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.solvers import (make_gse_operator, make_precond_operator,
                                     solve_pcg)

    params = MonitorParams(**PCG_PARAMS)
    kw = dict(tol=1e-10, maxiter=5000, params=params)
    for kind, want in PCG_REF.items():
        runs = {}
        for where in ("cuda", "cpu"):
            g, m, b = pcg_case(kind, where)
            t0 = time.perf_counter()
            runs[where] = (solve_pcg(g, b, m, **kw), time.perf_counter() - t0)
        (rg, tg_s), (rc, tc_s) = runs["cuda"], runs["cpu"]
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
    zeroed, beside phase 4's plain CG."""
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


def main() -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, default=None,
                    help="an earlier checkout whose A32 and C32 phase 10 "
                         "times beside this tree's (earlier_ms)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs the port on a GPU only")
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
    params = MonitorParams(t=40, l=60, m=30)

    # 1. build --------------------------------------------------------------
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    _build.build_all()
    for name, info in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln]
        log("build", source=f"{name}.cu", nvcc_s=f"{info['seconds']:.2f}",
            ptxas=json.dumps(regs))
    log("build", total_s=f"{time.perf_counter() - t0:.2f}")

    # 2. kernel parity at full size ------------------------------------------
    t0 = time.perf_counter()
    csr = G.diag_rescale(G.random_spd(N_FULL, nnz_per_row=8, seed=21,
                                      device=dev), 8.0, 21)
    g = pack_csr(csr)
    ell = ops.ell_pack_gsecsr(g)
    row_len = ops.ell_row_lengths(g)  # A32 and C32 read only these slots
    torch.cuda.synchronize()
    log("parity", rows=g.shape[0], nnz=g.nnz, ell_width=ell[0].shape[1],
        real_slot_share=g.nnz / ell[0].numel(),
        generate_pack_s=f"{time.perf_counter() - t0:.2f}")
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
    small = G.diag_rescale(G.random_spd(2000, seed=21, device="cpu"), 8.0, 21)
    xs = np.random.default_rng(0).normal(size=2000)
    bs = torch.from_numpy(host_spmv(small, xs))
    runs = {}
    for where in ("cuda", "cpu"):
        gs = pack_csr(G.diag_rescale(G.random_spd(2000, seed=21, device=where),
                                     8.0, 21))
        t0 = time.perf_counter()
        r = solve_cg(gs, bs.to(where), tol=1e-8, maxiter=20000, params=params)
        runs[where] = (r, time.perf_counter() - t0)
    (rg, tg_s), (rc, tc_s) = runs["cuda"], runs["cpu"]
    it_g, it_c = int(rg.iters), int(rc.iters)
    sw_g, sw_c = rg.switch_iters.tolist(), rc.switch_iters.tolist()
    log("trajectory", case="spd_rs8_2k", gpu_iters=it_g, cpu_iters=it_c,
        gpu_tag=int(rg.tag), cpu_tag=int(rc.tag), gpu_switch=sw_g,
        cpu_switch=sw_c, x_bitwise=bitwise(rg.x, rc.x), gpu_s=f"{tg_s:.2f}",
        cpu_s=f"{tc_s:.2f}")
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
    res = solve_cg(g, b, tol=1e-8, maxiter=20000, params=params)
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
            _, reps_c, xs_c, wall_c = serve_small("cpu", maxiter, params)
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
            stats=json.dumps(svc_g.stats), matches_reference=True,
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
    ids = [svc.submit("full", bj, tol=1e-8) for bj in bs_full]
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
    loop_iters = max(r.iters for r in reps)
    log("service", rows=N_FULL, slots=NRHS, requests=len(reps),
        iters=[r.iters for r in reps], tag=[r.tag for r in reps],
        switch_iters=[r.switch_iters.tolist() for r in reps],
        health=[r.health for r in reps], retries=[r.retries for r in reps],
        relres=[r.relres for r in reps], est_bytes=[r.est_bytes for r in reps],
        stats=json.dumps(svc.stats), register_s=f"{register_s:.2f}",
        wall_s=f"{serve_wall:.2f}",
        ms_per_iteration=f"{serve_wall * 1e3 / loop_iters:.3f}",
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
    phase_sell_trajectory(params)
    sell_ctx = phase_sell_full(params)

    # 15-18. stepped GMRES and PCG ---------------------------------------------
    t0 = time.perf_counter()
    gmres_ctx = phase_gmres_trajectory()
    t1 = time.perf_counter()
    gmres_launches = phase_gmres_full()
    t2 = time.perf_counter()
    phase_pcg_trajectory()
    t3 = time.perf_counter()
    phase_pcg_full(csr, g, b, params, res, wall)
    log("solver_phases", gmres_trajectory_s=f"{t1 - t0:.1f}",
        gmres_full_s=f"{t2 - t1:.1f}", pcg_trajectory_s=f"{t3 - t2:.1f}",
        pcg_full_s=f"{time.perf_counter() - t3:.1f}")

    # 11-14. the LM serving path ----------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain E: full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lm_ctx = phase_lm_kernels()
    t1 = time.perf_counter()
    twin_counts = phase_lm_twin()
    t2 = time.perf_counter()
    lm_counts = phase_lm_full()
    t3 = time.perf_counter()
    lm_counts.update(phase_lm_serve_cli())
    log("lm_phases", lm_kernels_s=f"{t1 - t0:.1f}", lm_twin_s=f"{t2 - t1:.1f}",
        lm_full_s=f"{t3 - t2:.1f}",
        lm_serve_s=f"{time.perf_counter() - t3:.1f}")

    # 10. kernel times ---------------------------------------------------------
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
                  plain_reps=3, reps=10, inner=10, **extra):
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "ms": cuda_ms(launch, reps=reps, inner=inner),
            "plain_ms": cuda_ms(plain, reps=plain_reps),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": (cuda_ms(lib, reps=reps, inner=inner)
                           if lib is not None else None),
            "bytes": nbytes,
            **extra,
        }
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
            add_entry(f"{name}.tag{t}", src, replaces, launch, plain, lib,
                      g.bytes_touched(t) + ncols * (m + n) * xb,
                      nops / ops_rate * 1e3, **extra)
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
    lm_entries(lm_ctx, lm_counts, twin_counts, add_entry)
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
