"""Restarted GMRES with stepped mixed precision (paper Alg. 3, Sec IV).

Port of ``repro/solvers/gmres.py``: ``GMRESResult``, ``_givens`` (:57),
``_solve_gmres`` (:78) and ``solve_gmres`` (:286), with right
preconditioning (``precond=``), guards, recovery, ``init_tag`` and
``final_correction``.

GMRES(restart) with iterated classical Gram-Schmidt (CGS2) and Givens
least squares.  The residual monitor sees ``|g[j+1]|`` every inner
iteration and steps the SpMV precision tag in place; the tag and the
residual window persist across restarts.

The loop state lives in tensors on the solve's device.  An inner
iteration's index ``j`` equals its step within the cycle while the
iteration is live, so the host indexes the basis by that step and the
device carries only whether the step is live (``active``: the reference's
inner-loop condition on the incoming state).  Every update is frozen by
``torch.where(active, new, old)`` -- the basis row, the monitor, the
switches and the guards -- or written by a kernel gated on ``active``, so
``iters`` is exactly the reference's.  The host syncs once per
:data:`CHUNK` inner iterations and once at each cycle's end, where ``x``
changes.

Every product rounds as XLA's CPU build of the reference: the CGS2 GEMVs
(``kernels.vec_f64.gemv_rows_ref``/``gemv_cols_ref``), the rotations and
the back substitution (``kernels.gmres_f64``), the norms
(``vec_f64.ref_norm_cols``).  So on the named cases the unpreconditioned
iterates are bitwise the reference's on the CPU, and the card's are
bitwise the CPU twin's.  One product differs: with a preconditioner the
reference's cycle update ``y @ V[:restart]`` becomes an XLA loop fusion
whose vectorized sum order depends on ``restart`` (ROADMAP queue 3); the
port keeps the column chain there, and the iterates agree to about 1e-10
relative, with the reference's iterations, tag and switches.

Not yet ported: the flight recorder (``flight=``, ROADMAP queue 1
item 12).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import precision as P
from repro_torch.kernels.gmres_f64 import givens, givens_step, trsv_upper_ref
from repro_torch.kernels.vec_f64 import (gemv_cols_ref, gemv_rows_ref,
                                         seq_dot)
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    HEALTH_OK,
    finalize_health,
    guard_init,
    guard_step,
    run_with_recovery,
)
from repro_torch.solvers.cg import (_finish_with_correction, _freeze, _norm,
                                    _normalize_b_x0, _record_switch,
                                    _restore_shape)

__all__ = ["GMRESResult", "solve_gmres", "CHUNK"]

# Inner iterations between two host syncs of the stepped loop.
CHUNK = 16


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor          # total inner iterations (matvecs in Arnoldi)
    relres: torch.Tensor
    tag: torch.Tensor
    switch_iters: torch.Tensor   # (2,) inner iteration of tag->2 / tag->3
    converged: torch.Tensor
    # Health code (robustness.guards.HEALTH_*) and the first guard-trip
    # inner iteration (-1: never).
    health: torch.Tensor = HEALTH_OK
    trip_iter: torch.Tensor = -1


def _givens(a: torch.Tensor, b: torch.Tensor):
    """The reference's ``_givens``: rotation ``(c, s, d)`` with ``d =
    hypot(a, b)``, overflow/underflow-safe (scaled by ``max(|a|, |b|)``),
    rounded as the jitted reference; f64 0-d tensors on the host."""
    return tuple(torch.tensor(v, dtype=torch.float64, device=a.device)
                 for v in givens(float(a), float(b)))


def _i32(v: int, dev) -> torch.Tensor:
    return torch.full((), v, dtype=torch.int32, device=dev)


def _solve_gmres(apply_a: Callable, b, x0, tol, restart: int, maxiter: int,
                 params: P.MonitorParams, init_tag: int = 1, apply_m=None,
                 guards: GuardParams | None = None):
    """One guarded stepped-GMRES run; returns ``(GMRESResult, ckpt,
    monitor)`` with ``ckpt`` the last cycle-end iterate the guard judged
    healthy and finite.

    ``apply_m`` (optional) right-preconditions: Arnoldi runs on
    ``A M^{-1}`` and each cycle's correction is mapped back through
    ``M^{-1}``.  Both apply at the monitor's current tag; the cycle's
    correction at the cycle's end tag."""
    dev, dtype = b.device, b.dtype
    n = b.shape[0]
    bnorm = _norm(b)
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    abstol = tol * bnorm

    mon = P.init(params, dtype=dtype, tag=init_tag, device=dev)
    relres = _norm(b - apply_a(x0, mon.tag)) / bnorm
    switches = torch.full((2,), -1, dtype=torch.int32, device=dev)
    gd = guard_init(relres) if guards is not None else None
    x = ckpt = x0
    it = 0

    def healthy():
        return gd["health"] == HEALTH_OK if gd is not None else True

    while it < maxiter and bool((relres > tol) & healthy()):
        it0 = it
        r = b - apply_a(x, mon.tag)
        beta = _norm(r)
        if gd is not None:
            # The recomputed restart residual is the one true residual per
            # cycle: a non-finite back substitution shows up here.
            gd = guard_step(gd, _i32(it0, dev), beta / bnorm, guards)
        if it0 > 0:  # the first cycle's beta precedes iteration 0
            mon = P.record(mon, beta / bnorm)
        V = torch.zeros(restart + 1, n, dtype=dtype, device=dev)
        V[0] = r / torch.where(beta == 0, 1.0, beta)
        H = torch.zeros(restart + 1, restart, dtype=dtype, device=dev)
        cs = torch.zeros(restart, dtype=dtype, device=dev)
        sn = torch.zeros(restart, dtype=dtype, device=dev)
        g = torch.zeros(restart + 1, dtype=dtype, device=dev)
        g[0] = beta
        resid = beta.clone()
        j = _i32(0, dev)

        for s in range(min(restart, maxiter - it0)):
            active = resid > abstol
            if gd is not None:
                active = active & healthy()
            if s % CHUNK == 0 and not bool(active):  # the sync per chunk
                break
            v = V[s] if apply_m is None else apply_m(V[s], mon.tag)
            w = apply_a(v, mon.tag)
            # CGS2: two passes of classical Gram-Schmidt against rows 0..s.
            h = torch.zeros(s + 1, dtype=dtype, device=dev)
            for _ in range(2):
                corr = gemv_rows_ref(V, w, s + 1)
                w = w - gemv_cols_ref(corr, V, s + 1)
                h = h + corr
            hj1 = _norm(w)
            V[s + 1] = torch.where(active, w / torch.where(hj1 == 0, 1.0, hj1),
                                   V[s + 1])
            givens_step(h, hj1, cs, sn, g, H, resid, active, s)
            rel = resid / bnorm
            mon1 = P.record(mon, rel)
            mon2 = P.update_tag(mon1, params)
            sw = _record_switch(switches, mon1, mon2, _i32(it0 + s, dev))
            if gd is not None:
                # Unhappy breakdown: the Krylov space closed (hj1 == 0) with
                # the residual still above tolerance.
                gd = _freeze(active, guard_step(
                    gd, _i32(it0 + s, dev), rel, guards,
                    breakdown=(hj1 == 0) & (resid > abstol),
                    finite_aux=(hj1,)), gd)
            mon = _freeze(active, mon2, mon)
            switches = torch.where(active, sw, switches)
            j = j + active.to(torch.int32)

        # Back substitution on the leading j x j triangle, then the update.
        y = trsv_upper_ref(H, g, j)
        if apply_m is None:
            x_new = gemv_cols_ref(y, V, restart, addend=x)
        else:  # x = x0 + M^{-1} (V y), right preconditioning
            x_new = x + apply_m(gemv_cols_ref(y, V, restart), mon.tag)
        it = it0 + int(j)  # the sync per cycle
        relres = resid / bnorm
        if gd is not None:
            fin = torch.isfinite(seq_dot(x_new, x_new))
            ckpt = torch.where((gd["health"] == HEALTH_OK) & fin, x_new, ckpt)
        x = x_new

    x_fin = torch.isfinite(seq_dot(x, x))
    conv = (relres <= tol) & x_fin
    health, trip = finalize_health(gd, conv, relres, x_finite=x_fin)
    res = GMRESResult(x=x, iters=_i32(it, dev), relres=relres, tag=mon.tag,
                      switch_iters=switches, converged=conv, health=health,
                      trip_iter=trip)
    return res, (ckpt if gd is not None else x), mon


def solve_gmres(
    apply_a: Callable,
    b,
    x0=None,
    tol: float = 1e-6,
    restart: int = 30,
    maxiter: int = 15000,
    params: P.MonitorParams | None = None,
    final_correction: bool = False,
    precond=None,
    guards: GuardParams | None = DEFAULT_GUARDS,
    recover: bool = True,
    init_tag: int = 1,
    flight=None,
) -> GMRESResult:
    """Restarted GMRES; ``apply_a(x, tag)`` (for example
    ``make_gse_operator(a)``) runs on ``b``'s device, and
    ``final_correction`` is as in :func:`repro_torch.solvers.cg.solve_cg`.

    ``precond`` (optional) right-preconditions the iteration: a
    preconditioner from :mod:`repro_torch.solvers.precond` or a callable
    ``apply_m(r, tag)``; it rides the monitor's tag schedule as the
    operator does.

    ``guards``/``recover``/``init_tag``: in-loop guardrails plus
    checkpoint-rollback tag-escalation recovery, as in ``solve_cg``; GMRES
    checkpoints at restart-cycle granularity (x changes only at cycle
    ends).  ``b``/``x0`` may be ``(n,)`` or ``(n, 1)``; the solution
    comes back in ``b``'s layout.
    """
    if flight is not None:
        raise NotImplementedError(
            "flight= is not ported yet (ROADMAP queue 1 item 12)")
    if not callable(apply_a):
        raise TypeError(f"solve_gmres takes an operator apply_a(x, tag); got "
                        f"{type(apply_a).__name__}")
    b, x0, orig_shape = _normalize_b_x0(b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if params is None:
        params = P.MonitorParams.for_gmres()
    apply_m = None
    if precond is not None:
        apply_m = precond if callable(precond) else precond.apply
    tol_ = torch.tensor(tol, dtype=b.dtype, device=b.device)

    def run(x_start, budget, tag):
        return _solve_gmres(apply_a, b, x_start, tol_, restart, budget,
                            params, init_tag=tag, apply_m=apply_m,
                            guards=guards)[:2]

    res = run_with_recovery(run, x0, maxiter, init_tag=init_tag,
                            recover=recover and guards is not None)
    if not final_correction:
        return _restore_shape(res, orig_shape)
    tag3 = torch.full((), 3, dtype=torch.int32, device=b.device)

    def apply3(v):
        return apply_a(v, tag3)

    def resume(xr, budget):
        return run(xr, budget, 3)[0]

    return _restore_shape(
        _finish_with_correction(res, b, tol, maxiter, apply3, resume),
        orig_shape,
    )
