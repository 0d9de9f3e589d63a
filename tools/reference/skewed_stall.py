#!/usr/bin/env python3
"""Stepped CG on the skewed construction in the JAX reference, by size.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/skewed_stall.py 8192 32768
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/skewed_stall.py --serve 32768

For each n, ``diag_rescale(skewed_spd(n, seed=5), 8, 5)`` packed at k=8 is
solved with ``solve_cg`` (tol 1e-8, ``MonitorParams(40, 60, 30)``, maxiter
20000, default guards) for ``b = A x``, x from ``default_rng(1)``; with
``--serve`` the reference's ``SolverService(slots=4, layout="sell")``
serves x from seeds 1, 2 and 3 instead.  It prints iterations, the
switch schedule, relres, convergence and health: the reference's outcome
that ``chip_smoke.py`` phase 9 meets at n = 262144 on the port.  This
script runs the JAX package (it is not part of the port).
"""
import argparse

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision import MonitorParams  # noqa: E402
from repro.launch.solver_serve import SolverService  # noqa: E402
from repro.solvers.cg import solve_cg  # noqa: E402
from repro.sparse import csr, generators as G  # noqa: E402
from repro.sparse.spmv import spmv  # noqa: E402

PARAMS = MonitorParams(t=40, l=60, m=30)


def rhs(a, seed):
    return spmv(a, jnp.asarray(np.random.default_rng(seed).normal(
        size=a.shape[1])))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="+")
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args()
    for n in args.n:
        a = G.diag_rescale(G.skewed_spd(n, seed=5), 8.0, 5)
        if not args.serve:
            r = solve_cg(csr.pack_csr(a, k=8), rhs(a, 1), tol=1e-8,
                         maxiter=20000, params=PARAMS)
            print(f"n={n} iters={int(r.iters)} "
                  f"switch_iters={np.asarray(r.switch_iters).tolist()} "
                  f"tag={int(r.tag)} relres={float(r.relres)!r} "
                  f"converged={bool(r.converged)} health={int(r.health)}",
                  flush=True)
            continue
        svc = SolverService(slots=4, params=PARAMS, maxiter=20000)
        svc.register("op", a, k=8, layout="sell")
        ids = [svc.submit("op", rhs(a, s), tol=1e-8) for s in (1, 2, 3)]
        reports = svc.flush()
        for i in ids:
            r = reports[i]
            print(f"n={n} request={i} iters={r.iters} "
                  f"switch_iters={np.asarray(r.switch_iters).tolist()} "
                  f"relres={r.relres!r} converged={r.converged} "
                  f"health={r.health} retries={r.retries} "
                  f"trip_iter={r.trip_iter}", flush=True)
        print(f"n={n} stats={svc.stats}", flush=True)


if __name__ == "__main__":
    main()
