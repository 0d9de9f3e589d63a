#!/usr/bin/env python3
"""The reference's per-group precision runs: the numbers ``chip_smoke.py``
phase 21 holds the port to (``ADAPTIVE_REF``, ``TAGMAP_CG_REF``,
``SERVICE_TAGS_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/adaptive_ref.py

JAX on the CPU with x64.  Each right-hand side ``b`` is four unit spikes
at ``default_rng(7).choice(m, 4, replace=False)`` (the adaptive
benchmark's ``_spike_rhs``), so it is exact on both sides.

* ``solve_adaptive(pack_csr(A, k=8), b, ...)`` on three rows:
  ``ill_conditioned_spd(16, decades=8, seed=0)`` (profile explore, tol
  2e-3, maxiter 4000), ``diag_rescale(skewed_spd(n=1024), 6, 11)``
  (neumann, 1e-3, 1500) and ``diag_rescale(skewed_spd(n=65536, seed=5),
  6, 11)`` (neumann, 1e-3, 20000): iters, true_relres, the map's tag
  counts and crc32, the promotions ``(it, n)``, spmv_bytes, chunks and the
  crc32 of ``x``'s f64 bytes;
* ``solve_cg(g, b, tags=tm, tol=1e-4, maxiter=400)`` with the third row's
  final map on its pack: iters, relres, switch_iters and the crc32 of x;
* ``SolverService(slots=2, maxiter=3000)`` on ``poisson2d(10)`` with
  three requests of the spike ``b`` at tol 1e-8, tags 2, the uniform
  tag-2 map and ``"adaptive"``: per request ``(iters, relres, converged,
  tag, est_bytes)``, the stats and the crc32 of each solution.

It prints one JSON line for each of the three records.  This script runs
the JAX package (it is not part of the port); about 20 s.
"""
import json
import zlib

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.tagmap import TagMap  # noqa: E402
from repro.launch.solver_serve import SolverService  # noqa: E402
from repro.solvers import solve_cg  # noqa: E402
from repro.solvers.adaptive import solve_adaptive  # noqa: E402
from repro.sparse import generators as G  # noqa: E402
from repro.sparse.csr import pack_csr  # noqa: E402

# name: (matrix, solve_adaptive keywords)
ROWS = {
    "illcond16": (lambda: G.ill_conditioned_spd(16, decades=8.0, seed=0),
                  dict(profile="explore", tol=2e-3, maxiter=4000)),
    "skewed1024": (lambda: G.diag_rescale(G.skewed_spd(n=1024), 6.0, 11),
                   dict(profile="neumann", tol=1e-3, maxiter=1500)),
    "skewed65536": (lambda: G.diag_rescale(G.skewed_spd(n=65536, seed=5),
                                           6.0, 11),
                    dict(profile="neumann", tol=1e-3, maxiter=20000)),
}


def spikes(m: int, count: int = 4, seed: int = 7) -> np.ndarray:
    b = np.zeros(m)
    b[np.random.default_rng(seed).choice(m, count, replace=False)] = 1.0
    return b


def crc(x) -> int:
    return zlib.crc32(np.ascontiguousarray(np.asarray(x, np.float64))
                      .tobytes())


def main():
    out, last = {}, None
    for name, (make, kw) in ROWS.items():
        g = pack_csr(make(), k=8)
        b = jnp.asarray(spikes(int(g.shape[0])))
        r = solve_adaptive(g, b, **kw)
        out[name] = dict(
            iters=int(r.iters), true_relres=float(r.true_relres),
            counts={int(t): int(c) for t, c in r.tagmap.tag_counts().items()},
            crc32=int(r.tagmap.crc32),
            promotions=[[int(p.it), int(p.n_promoted)]
                        for p in r.promotions],
            spmv_bytes=int(r.spmv_bytes), chunks=int(r.chunks),
            x_crc32=crc(r.x))
        last = (g, b, r.tagmap)
    print(json.dumps({"ADAPTIVE_REF": out}))

    g, b, tm = last
    r = solve_cg(g, b, tags=tm, tol=1e-4, maxiter=400)
    print(json.dumps({"TAGMAP_CG_REF": dict(
        iters=int(r.iters), relres=float(r.relres),
        switch_iters=np.asarray(r.switch_iters).tolist(),
        x_crc32=crc(r.x))}))

    a = G.poisson2d(10)
    m = int(a.shape[0])
    b = jnp.asarray(spikes(m))
    svc = SolverService(slots=2, maxiter=3000)
    svc.register("p", a, k=8)
    ids = [svc.submit("p", b, tol=1e-8, tags=t)
           for t in (2, TagMap.for_rows(m, 2), "adaptive")]
    reps = svc.flush()
    print(json.dumps({"SERVICE_TAGS_REF": dict(
        reports=[[reps[i].iters, reps[i].relres, reps[i].converged,
                  reps[i].tag, reps[i].est_bytes] for i in ids],
        stats={k: int(v) for k, v in svc.stats.items()},
        x_crc32=[crc(svc.solution(i)) for i in ids])}))


if __name__ == "__main__":
    main()
