#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and runs the port's two paths at full size: the main path
(generate an SPD matrix, pack it to GSE-SEM CSR, run the tag-specialized
SpMV, run stepped CG) and the batched solve service (``SolverService`` ->
per-column stepped CG on the tag-specialized SpMM).  Every phase prints
one line; any mismatch raises and the script exits non-zero.  There is no
CPU fallback: without a CUDA device, or without the rest of the
repository beside it, the script fails.

Phases:
  1. build     -- nvcc time for every kernel source (all started at once).
  2. parity    -- on diag_rescale(random_spd(2^20, 8, seed=21), 8, 21)
                  (about 17.8M nonzeros): A32 against its plain version
                  within rtol 2e-5 / atol 1e-4 (the plain version repeats
                  the kernel's sum order, so it is expected bitwise), A64
                  bitwise, tags 1-3; the CG loop's dot (seq_dot) and
                  update (fma_axpy) bitwise on 2^20-long vectors.  Kernel
                  C at nrhs = 4: C32 against its plain version (same
                  tolerance, bitwise expected) and at nrhs = 1 bitwise A32;
                  C64 with tags [1, 2, 3, 1] and active [T, T, T, F]
                  bitwise its plain version, column j bitwise A64 at tag
                  j+1; seq_dot_cols and fma_axpy_cols bitwise seq_dot and
                  fma_axpy per column.
  3. trajectory-- spd_rs8_2k solved on the GPU and on the CPU twin: equal
                  tag and switch_iters, iters within 3%, both converged.
                  The reference's schedule there is [120, 150] in 2791
                  iterations; the tests hold the CPU twin to it.
  4. main path -- launch counts zeroed; the f32 SpMV at tags 1-3 and
                  stepped CG (tol 1e-8, MonitorParams(40, 60, 30),
                  maxiter 20000, default guards) on the full-size matrix;
                  every kernel must have launched.
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
                  have launched.
  7. kernels   -- CUDA-event times (minimum over repeats) of every kernel
                  beside its plain version, its bound (HBM bytes or
                  operations) and one PyTorch library call (torch.sparse
                  CSR, torch.dot, torch.addcmul, torch.linalg.vecdot).

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
    """Equal shapes and equal bits (f32 or f64), wherever the tensors lie."""
    import torch

    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    view = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(view), b.view(view))


def require_bitwise(name, got, want):
    if not bitwise(got, want):
        raise AssertionError(f"{name} is not bitwise equal to its reference")


def serve_small(where: str, maxiter: int, params):
    """rs8_400_s3 through the port's SolverService on ``where``: three
    requests b_j = A x_j, x_j = default_rng(j).normal(400), slots=4."""
    import numpy as np
    import torch

    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.sparse import generators as G

    host = G.diag_rescale(G.random_spd(400, seed=3, device="cpu"), 8.0, 3)
    svc = SolverService(slots=NRHS, params=params, maxiter=maxiter,
                        device=where)
    svc.register("op", G.diag_rescale(G.random_spd(400, seed=3, device=where),
                                      8.0, 3), k=8)
    ids = [svc.submit("op", torch.from_numpy(host_spmv(
        host, np.random.default_rng(j).normal(size=400))), tol=1e-8)
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


def main() -> int:
    import numpy as np
    import torch

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
    torch.cuda.synchronize()
    log("parity", rows=g.shape[0], nnz=g.nnz, ell_width=ell[0].shape[1],
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
                                 ei_bit=g.ei_bit, tag=t)
        want = K.gse_spmv_ell_f32_plain(ell[0], ell[1], t1, t2, x32,
                                        scales[t], ei_bit=g.ei_bit, tag=t)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)
        a32_err[t] = float((got - want).abs().max())
        a32_bitwise = torch.equal(got.view(torch.int32), want.view(torch.int32))
        args = (g.rowptr, g.colpak, g.head, g.tail1, g.tail2, g.table, x64)
        got = K.gse_spmv_csr_f64(*args, ei_bit=g.ei_bit, tag=t)
        want = K.gse_spmv_csr_f64_plain(*args, ei_bit=g.ei_bit, tag=t)
        if not torch.equal(got.view(torch.int64), want.view(torch.int64)):
            bad = int((got.view(torch.int64) != want.view(torch.int64)).sum())
            raise AssertionError(f"A64 tag {t}: {bad} rows not bitwise equal")
        a64_err[t] = float((got - want).abs().max())
        log("parity", tag=t, a32_max_abs_err=a32_err[t],
            a32_tol="rtol 2e-5 atol 1e-4", a32_bitwise=a32_bitwise,
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
    c32_err = {}
    for t in TAGS:
        t1 = ell[2] if t >= 2 else None
        t2 = ell[3] if t == 3 else None
        got = C.gse_spmm_ell_f32(ell[0], ell[1], t1, t2, x32c, scales[t],
                                 ei_bit=g.ei_bit, tag=t)
        want = C.gse_spmm_ell_f32_plain(ell[0], ell[1], t1, t2, x32c,
                                        scales[t], ei_bit=g.ei_bit, tag=t)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-4)
        c32_err[t] = float((got - want).abs().max())
        one = C.gse_spmm_ell_f32(ell[0], ell[1], t1, t2, x32[None], scales[t],
                                 ei_bit=g.ei_bit, tag=t)
        a32 = K.gse_spmv_ell_f32(ell[0], ell[1], t1, t2, x32, scales[t],
                                 ei_bit=g.ei_bit, tag=t)
        require_bitwise(f"C32 tag {t} at nrhs=1 against A32", one[:, 0], a32)
        log("parity", kernel="gse_spmm_ell_f32", tag=t, nrhs=NRHS,
            max_abs_err=c32_err[t], tol="rtol 2e-5 atol 1e-4",
            bitwise=bitwise(got, want), nrhs1_bitwise_a32=True)
    c64_tags = torch.tensor([1, 2, 3, 1], dtype=torch.int32, device=dev)
    c64_active = torch.tensor([True, True, True, False], device=dev)
    segs = (g.rowptr, g.colpak, g.head, g.tail1, g.tail2, g.table)
    got = C.gse_spmm_csr_f64(*segs, x64c, c64_tags, c64_active,
                             ei_bit=g.ei_bit)
    want = C.gse_spmm_csr_f64_plain(*segs, x64c, c64_tags, c64_active,
                                    ei_bit=g.ei_bit)
    require_bitwise("C64 against its plain version", got, want)
    c64_err = float((got - want).abs().max())
    for j in range(3):
        require_bitwise(f"C64 column {j} against A64 at tag {j + 1}", got[j],
                        K.gse_spmv_csr_f64(*segs, x64c[j], ei_bit=g.ei_bit,
                                           tag=j + 1))
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
        y = ops.gse_spmv_ell(ell_main, g.table, x32, g.ei_bit, tag=t)
        a32_launches[t] = K.gse_spmv_ell_f32.launches - before
        if y.shape != (N_FULL,) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"gse_spmv_ell tag {t}: bad output")
    t0 = time.perf_counter()
    res = solve_cg(g, b, tol=1e-8, maxiter=20000, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    a64_launches = K.gse_spmv_csr_f64.launches
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
        a64_launches=a64_launches, a32_launches=sum(a32_launches.values()),
        seq_dot_launches=vec_launches["seq_dot"],
        fma_axpy_launches=vec_launches["fma_axpy"])
    if min(a64_launches, *a32_launches.values(), *vec_launches.values()) <= 0:
        raise AssertionError("a kernel of the main path never launched")
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
        y = ops.gse_spmm_ell(ell_main, g.table, x32c.t(), g.ei_bit, tag=t)
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
        c64_launches=c64_launches, c32_launches=sum(c32_launches.values()),
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

    # 7. kernel times ----------------------------------------------------------
    m, n = g.shape
    kernels = []

    def add_entry(name, source, replaces, launch, plain, lib, nbytes, op_ms,
                  plain_reps=3, **extra):
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        entry = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "ms": cuda_ms(launch, reps=10, inner=10),
            "plain_ms": cuda_ms(plain, reps=plain_reps),
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": cuda_ms(lib, reps=10, inner=10),
            "bytes": nbytes,
            **extra,
        }
        kernels.append(entry)
        log("kernels", name=name, ms=f"{entry['ms']:.4f}",
            plain_ms=f"{entry['plain_ms']:.3f}",
            bound_ms=f"{entry['bound_ms']:.4f}",
            library_ms=f"{entry['library_ms']:.4f}")

    spmv_src = "src/repro_torch/kernels/csrc/gse_spmv.cu"
    spmm_src = "src/repro_torch/kernels/csrc/gse_spmm.cu"
    x32n = x32c.t().contiguous()  # (n, nrhs) blocks for the library SpMM
    x64n = x64c.t().contiguous()
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
             lambda: K.gse_spmv_ell_f32(ell[0], ell[1], t1, t2, x32, scales[t],
                                        ei_bit=g.ei_bit, tag=t),
             lambda: K.gse_spmv_ell_f32_plain(ell[0], ell[1], t1, t2, x32,
                                              scales[t], ei_bit=g.ei_bit,
                                              tag=t),
             lambda: torch.mv(lib32, x32), 4, 1, FP32_OPS_PER_S, a32_err[t],
             a32_launches[t]),
            ("gse_spmv_csr_f64", spmv_src, "src/repro/kernels/gse_spmv.py:160",
             lambda: K.gse_spmv_csr_f64(*args64, ei_bit=g.ei_bit, tag=t),
             lambda: K.gse_spmv_csr_f64_plain(*args64, ei_bit=g.ei_bit, tag=t),
             lambda: torch.mv(lib64, x64), 8, 1, FP64_OPS_PER_S, a64_err[t],
             a64_launches),
            ("gse_spmm_ell_f32", spmm_src, "src/repro/kernels/gse_spmm.py:137",
             lambda: C.gse_spmm_ell_f32(ell[0], ell[1], t1, t2, x32c,
                                        scales[t], ei_bit=g.ei_bit, tag=t),
             lambda: C.gse_spmm_ell_f32_plain(ell[0], ell[1], t1, t2, x32c,
                                              scales[t], ei_bit=g.ei_bit,
                                              tag=t),
             lambda: torch.mm(lib32, x32n), 4, NRHS, FP32_OPS_PER_S,
             c32_err[t], c32_launches[t]),
            ("gse_spmm_csr_f64", spmm_src, "src/repro/kernels/gse_spmm.py:137",
             lambda: C.gse_spmm_csr_f64(*segs, x64c, tags_t, all_on,
                                        ei_bit=g.ei_bit),
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
        add_entry(name, vec_src,
                  "src/repro/solvers/fused_cg.py:51" if dot
                  else "src/repro/solvers/fused_cg.py:53",
                  launch, plain, lib, (16 if dot else 24) * N_FULL * ncols,
                  2 * N_FULL * ncols / FP64_OPS_PER_S * 1e3,
                  plain_reps=plain_reps, nrhs=ncols, launches=count,
                  max_abs_err=vec_err[name])
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
