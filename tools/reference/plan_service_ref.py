#!/usr/bin/env python3
"""The reference's SELL service under each launch plan the autotuner may
pick: the numbers ``chip_smoke.py``'s perf phase holds the tuned service
to (``SELL_PLAN_SERVICE_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/plan_service_ref.py

JAX on the CPU with x64.  ``SolverService(slots=4, maxiter=20000)`` with
``MonitorParams(40, 60, 30)`` on ``sk512_rs8_s0``
(``diag_rescale(skewed_spd(512, seed=0), 8, 0)``) registered with
``layout="sell"`` and ``plan=`` each of ``perf.autotune.candidates("sell")``
(the SELL pack's C, sigma and buckets), three requests ``b_j = A x_j``,
``x_j = default_rng(j).normal(512)``, tol 1e-8.  The trajectories do not
depend on the pack; the byte reports charge its padded slots.  It prints
one JSON object: for each plan, keyed ``c{C}_s{sigma}_{bucket}``, the
requests' ``(iters, tag, switch_iters, health, retries, est_bytes)`` and
the stats.  This script runs the JAX package (it is not part of the
port); about a minute.
"""
import json

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.precision import MonitorParams  # noqa: E402
from repro.launch.solver_serve import SolverService  # noqa: E402
from repro.perf import autotune  # noqa: E402
from repro.sparse import generators as G  # noqa: E402
from repro.sparse.spmv import spmv  # noqa: E402


def plan_name(plan) -> str:
    return f"c{plan.sell_c}_s{plan.sell_sigma}_{plan.sell_bucket}"


def main():
    a = G.diag_rescale(G.skewed_spd(512, seed=0), 8.0, 0)
    bs = [np.array(spmv(a, jnp.asarray(
        np.random.default_rng(j).normal(size=512)))) for j in range(3)]
    out = {}
    for plan in autotune.candidates("sell"):
        svc = SolverService(slots=4, params=MonitorParams(t=40, l=60, m=30),
                            maxiter=20000)
        svc.register("op", a, k=8, layout="sell", plan=plan)
        ids = [svc.submit("op", jnp.asarray(b), tol=1e-8) for b in bs]
        reps = svc.flush()
        out[plan_name(plan)] = (
            [(reps[i].iters, reps[i].tag,
              np.asarray(reps[i].switch_iters).tolist(), reps[i].health,
              reps[i].retries, reps[i].est_bytes) for i in ids],
            dict(svc.stats))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
