#!/usr/bin/env python3
"""Where the time of one stepped-CG iteration goes on the GPU.

    python3 tools/profile_torch_cg.py [--cell uniform|skewed] [--n N]
                                      [--iters 128] [--nrhs 1]

Builds one of the port's full-size chip_smoke operators: the uniform cell
(``diag_rescale(random_spd(n, 8, seed=21), 8, 21)`` in GSE-SEM CSR, n
2^20 by default) or the skewed cell (``diag_rescale(skewed_spd(n,
seed=5), 8, 5)`` in its SELL-C-sigma pack, n 2^18 by default).  It warms
the solver up, then runs ``solve_cg`` (``--nrhs 1``) or the batched
``solve_cg_batched`` over ``--nrhs`` right-hand sides (the solve
service's loop) for ``--iters`` iterations three ways:

* wall clock per iteration (host clock around a synchronized solve);
* ``torch.profiler`` over the same solve: device busy time per
  iteration, the device's idle share, kernel launches per iteration and
  the kernels with the most device time;
* the shares of the SpMV or SpMM (A64 ``gse_spmv_csr_f64``, C64
  ``gse_spmm_csr_f64``; over the SELL pack B64 and C′64) and of the CG
  dots (``seq_dot_f64``, one block per column) in the device time.

Prints one JSON object (last line) and writes the Chrome trace to
``build/profile_torch_cg[_skewed][_nrhs<k>].json``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=("uniform", "skewed"),
                    default="uniform")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--iters", type=int, default=128)
    ap.add_argument("--nrhs", type=int, default=1)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cg: needs a CUDA device")
    from repro_torch.core.precision import MonitorParams
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import sell_pack_gsecsr
    from repro_torch.solvers.batched import solve_cg_batched
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr
    from repro_torch.sparse.spmv import spmv_gse

    _build.build_all()
    skewed = args.cell == "skewed"
    n = args.n or (1 << 18 if skewed else 1 << 20)
    if skewed:
        g = sell_pack_gsecsr(pack_csr(G.diag_rescale(
            G.skewed_spd(n, seed=5, device="cuda"), 8.0, 5)))
    else:
        g = pack_csr(G.diag_rescale(G.random_spd(n, nnz_per_row=8, seed=21,
                                                 device="cuda"), 8.0, 21))
    cols = [spmv_gse(g, torch.from_numpy(np.random.default_rng(seed).normal(
        size=n)).cuda(), 3) for seed in range(1, args.nrhs + 1)]
    params = MonitorParams(t=40, l=60, m=30)

    def run():
        if args.nrhs == 1:
            res = solve_cg(g, cols[0], tol=1e-8, maxiter=args.iters,
                           params=params)
        else:
            res = solve_cg_batched(g, torch.stack(cols, dim=1), tol=1e-8,
                                   maxiter=args.iters, params=params)
        torch.cuda.synchronize()
        return res

    run()  # warm-up: kernel build, allocator, cuSPARSE-free first launches
    t0 = time.perf_counter()
    res = run()
    wall = time.perf_counter() - t0
    iters = int(res.iters.max())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    suffix = ("_skewed" if skewed else "") + (
        "" if args.nrhs == 1 else f"_nrhs{args.nrhs}")
    prof.export_chrome_trace(str(out_dir / f"profile_torch_cg{suffix}.json"))

    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            kernels.append((evt.key, dev_us, evt.count))
    kernels.sort(key=lambda k: -k[1])
    busy_us = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    spmv_us = sum(k[1] for k in kernels
                  if any(f"{op}_{lay}_f64" in k[0] for op in ("spmv", "spmm")
                         for lay in ("csr", "sell")))
    dot_us = sum(k[1] for k in kernels if "seq_dot_f64" in k[0])
    summary = {
        "cell": args.cell, "n": n, "nnz": g.nnz, "nrhs": args.nrhs,
        "iters": iters,
        "wall_ms_per_iter": wall / iters * 1e3,
        "device_busy_ms_per_iter": busy_us / iters / 1e3,
        "device_idle_share": 1.0 - (busy_us / 1e6) / wall,
        "kernel_launches_per_iter": launches / iters,
        "spmv_share_of_device_time": spmv_us / busy_us if busy_us else None,
        "seq_dot_share_of_device_time": dot_us / busy_us if busy_us else None,
        "top_kernels": [{"name": k[0][:80], "device_ms": k[1] / 1e3,
                         "count": k[2]} for k in kernels[:8]],
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0],
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
