#!/usr/bin/env python3
"""The reference's iterative refinement and preconditioned solve service:
the numbers ``chip_smoke.py`` phase 19 holds the port to (``IR_REF``,
``IR_BATCHED_REF``, ``PCG_SERVICE_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/ir_ref.py

JAX on the CPU with x64.  Quickstart section 5's system,
``ill_conditioned_spd(32, decades=8, seed=0)`` packed with ``k=8``, its
Jacobi preconditioner ``make_jacobi(a, k=8)``, ``b = spmv(a, r)`` with
``r`` the first normal draw of ``default_rng(0)`` and ``b'`` the second:

* ``solve_ir`` (tol 1e-11, max_outer 10, inner_tol 1e-4, inner_maxiter
  4000) with inner PCG (Jacobi) and inner CG (both with
  ``MonitorParams(30, 30, 15, 0.5, 0.45)``), and with inner GMRES +
  Jacobi at restarts 30, 60 and 80 (the GMRES monitor's defaults):
  ``(outer_iters, inner_iters, relres)``;
* ``solve_ir_batched`` with Jacobi on the block ``[b, 2b, b', 0]``: the
  per-column outer and inner counts and relres;
* ``SolverService(slots=4)`` with ``register(..., precond=kind)`` for
  Jacobi and SPAI-0 on ``rs8_400_s3`` (``diag_rescale(random_spd(400,
  seed=3), 8, 3)``, three requests ``b_j = A x_j``, ``x_j =
  default_rng(j).normal(400)``, tol 1e-8, ``MonitorParams(40, 60, 30)``)
  at maxiter 20000 and 4: per request ``(iters, tag, switch_iters,
  health, retries, est_bytes)``, then the stats.  Jacobi undoes the
  system's diagonal rescale, so PCG converges in 7 (Jacobi) and 32-35
  (SPAI-0) iterations; maxiter 4 is what sends every request to the
  tag-3 PCG retry.

It prints one JSON line for each of the three records.  This script runs
the JAX package (it is not part of the port); about a minute.
"""
import json

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision import MonitorParams  # noqa: E402
from repro.launch.solver_serve import SolverService  # noqa: E402
from repro.solvers import make_jacobi, solve_ir, solve_ir_batched  # noqa: E402
from repro.sparse import generators as G  # noqa: E402
from repro.sparse.csr import pack_csr  # noqa: E402
from repro.sparse.spmv import spmv  # noqa: E402

FAST = MonitorParams(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
IR_KW = dict(tol=1e-11, max_outer=10, inner_tol=1e-4, inner_maxiter=4000)
# (inner, precond, restart, params) of each solve_ir row.
IR_RUNS = {"pcg_jacobi": ("cg", True, 30, FAST),
           "cg": ("cg", False, 30, FAST),
           "gmres_jacobi_r30": ("gmres", True, 30, None),
           "gmres_jacobi_r60": ("gmres", True, 60, None),
           "gmres_jacobi_r80": ("gmres", True, 80, None)}


def main():
    a = G.ill_conditioned_spd(32, decades=8.0, seed=0)
    g = pack_csr(a, k=8)
    m = make_jacobi(a, k=8)
    rng = np.random.default_rng(0)
    b = spmv(a, jnp.asarray(rng.normal(size=a.shape[1])))
    b2 = spmv(a, jnp.asarray(rng.normal(size=a.shape[1])))

    ir = {}
    for name, (inner, pre, restart, params) in IR_RUNS.items():
        res = solve_ir(g, b, inner=inner, precond=m if pre else None,
                       restart=restart, params=params, **IR_KW)
        ir[name] = [int(res.outer_iters), int(res.inner_iters),
                    float(res.relres), bool(res.converged), int(res.health)]
    print(json.dumps({"IR_REF": ir}), flush=True)

    block = jnp.stack([b, 2 * b, b2, jnp.zeros_like(b)], axis=1)
    res = solve_ir_batched(g, block, precond=m, params=FAST, **IR_KW)
    print(json.dumps({"IR_BATCHED_REF": [
        [int(v) for v in res.outer_iters], [int(v) for v in res.inner_iters],
        [float(v) for v in res.relres], [int(v) for v in res.health]]}),
        flush=True)

    rs8 = G.diag_rescale(G.random_spd(400, seed=3), 8.0, 3)
    bs = [spmv(rs8, jnp.asarray(np.random.default_rng(j).normal(size=400)))
          for j in range(3)]
    svc_ref = {}
    for kind in ("jacobi", "spai0"):
        svc_ref[kind] = {}
        for maxiter in (20000, 4):
            svc = SolverService(slots=4, params=MonitorParams(t=40, l=60,
                                                              m=30),
                                maxiter=maxiter)
            svc.register("op", rs8, k=8, precond=kind)
            ids = [svc.submit("op", bj, tol=1e-8) for bj in bs]
            reps = svc.flush()
            svc_ref[kind][maxiter] = (
                [(reps[i].iters, reps[i].tag,
                  np.asarray(reps[i].switch_iters).tolist(), reps[i].health,
                  reps[i].retries, reps[i].est_bytes) for i in ids],
                {k: int(v) for k, v in svc.stats.items()})
    print(json.dumps({"PCG_SERVICE_REF": svc_ref}), flush=True)


if __name__ == "__main__":
    main()
