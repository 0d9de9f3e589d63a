#!/usr/bin/env python3
"""Probe whether an operator's tag-1 read stays SPD: the diagonal heads
that decode to 0 at tag 1, uniform CG and Jacobi PCG at tags 1-3, and the
adaptive driver, on ``diag_rescale(skewed_spd(n, dense_rows=hubs,
seed=5), decades, seed)`` packed at each ``k``.

    python3 tools/tag1_probe.py [--n 262144] [--hubs 4] [--decades 6]
                                [--seed 11] [--k 8 16] [--device cuda]

The defaults are the construction ``chip_smoke.py`` phase 22 was first
given (the 65536 row of the adaptive runs at phase 9's size): its hub
rows' diagonals (~2^26) take the top shared exponent, and the heads of
the diagonals far below it decode to 0 at tag 1, so no map with a tag-1
majority is SPD.  b is four unit spikes (``chip_smoke.spikes``).  Each
result is one line of JSON.  About three minutes on an H100 at the
defaults.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import numpy as np
    import torch

    from repro_torch.core.precision import MonitorParams
    from repro_torch.kernels import ref
    from repro_torch.solvers import make_jacobi, solve_adaptive, solve_cg
    from repro_torch.solvers import solve_pcg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr
    from repro_torch.sparse.spmv import spmv_gse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--hubs", type=int, default=4)
    ap.add_argument("--decades", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--k", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--iters", type=int, default=300,
                    help="budget of the uniform solves")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    def out(**kv):
        print(json.dumps(kv), flush=True)

    dev = torch.device(args.device)
    if dev.type == "cuda":
        import subprocess

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        out(card=smi.stdout.strip())
    t0 = time.perf_counter()
    csr = G.diag_rescale(G.skewed_spd(args.n, dense_rows=args.hubs, seed=5,
                                      device=dev), args.decades, args.seed)
    b = np.zeros(args.n)
    b[np.random.default_rng(7).choice(args.n, 4, replace=False)] = 1.0
    b = torch.from_numpy(b).to(dev)
    bnorm = float(torch.linalg.norm(b))
    out(case=f"diag_rescale(skewed_spd({args.n}, dense_rows={args.hubs}, "
        f"seed=5), {args.decades}, {args.seed})",
        generate_s=round(time.perf_counter() - t0, 2))
    for k in args.k:
        g = pack_csr(csr, k=k)
        v1 = ref.decode_csr_ref(g.colpak, g.head, g.tail1, g.tail2, g.table,
                                g.ei_bit, 1)
        cols = g.colpak.to(torch.int64) & ((1 << (32 - g.ei_bit)) - 1)
        diag = g.row_ids.to(torch.int64) == cols
        out(k=k, nnz=g.nnz, table=g.table.tolist(),
            heads_zero_at_tag1=int((v1 == 0).sum()),
            diagonal_heads_zero_at_tag1=int(((v1 == 0) & diag).sum()))
        jac = make_jacobi(csr, k=k)
        for t in (1, 2, 3):
            params = MonitorParams(max_tag=t)
            for name, solve in (
                    ("cg", lambda: solve_cg(g, b, tol=1e-6,
                                            maxiter=args.iters, init_tag=t,
                                            params=params, guards=None)),
                    ("pcg_jacobi", lambda: solve_pcg(
                        g, b, jac, tol=1e-6, maxiter=args.iters, init_tag=t,
                        params=params, guards=None))):
                r = solve()
                true = float(torch.linalg.norm(b - spmv_gse(g, r.x, 3)))
                out(k=k, uniform_tag=t, solver=name, iters=int(r.iters),
                    relres=float(r.relres), true_relres=true / bnorm)
        t1 = time.perf_counter()
        r = solve_adaptive(g, b, tol=1e-3, maxiter=2000, profile="neumann")
        out(k=k, adaptive="neumann, tol 1e-3, maxiter 2000", iters=r.iters,
            true_relres=r.true_relres, converged=r.converged,
            groups_by_tag=r.tagmap.tag_counts(),
            promotions=[[p.it, p.n_promoted] for p in r.promotions],
            seconds=round(time.perf_counter() - t1, 2))
        del g, v1, jac
    return 0


if __name__ == "__main__":
    sys.exit(main())
