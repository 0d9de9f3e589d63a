"""In-loop solver guardrails and tag-escalation recovery.

Port of ``repro/robustness/guards.py`` :56-294: the ``HEALTH_*`` codes,
``health_name``, ``GuardParams``/``DEFAULT_GUARDS``, ``guard_init``,
``guard_step``, ``finalize_health``, ``run_with_recovery`` and its
per-group twin ``run_with_recovery_map``, which raises only the groups of
a ``TagMap`` below the floor.

The guard runs beside the update and never inside it, so the update
arithmetic is identical with guards on or off.  Each iteration classifies
the new state into one of five health codes (tensors on the device, no
sync) and the loop condition adds ``health == OK``.  Recovery runs on
the host (:func:`run_with_recovery`): on a trip at tag < 3 it rolls back to
the last known-finite x, promotes the tag, records the promotion into
``switch_iters`` at the global iteration and resumes with the remaining
budget.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "HEALTH_OK",
    "HEALTH_BREAKDOWN",
    "HEALTH_DIVERGED",
    "HEALTH_NONFINITE",
    "HEALTH_STALLED",
    "HEALTH_NAMES",
    "health_name",
    "GuardParams",
    "DEFAULT_GUARDS",
    "guard_init",
    "guard_step",
    "finalize_health",
    "run_with_recovery",
    "run_with_recovery_map",
]

# Severity order: when several conditions fire in one iteration the
# largest diagnosable code wins (nonfinite > diverged/breakdown > stalled).
HEALTH_OK = 0
HEALTH_BREAKDOWN = 1   # p.Ap <= 0
HEALTH_DIVERGED = 2    # relres blew past div_factor * best-seen
HEALTH_NONFINITE = 3   # NaN/Inf in the residual recurrence
HEALTH_STALLED = 4     # no new best residual for stall_window iterations

HEALTH_NAMES = ("ok", "breakdown", "diverged", "nonfinite", "stalled")


def health_name(code) -> str:
    """Human-readable name for a health code (int or 0-d tensor)."""
    i = int(code)
    if 0 <= i < len(HEALTH_NAMES):
        return HEALTH_NAMES[i]
    return f"unknown({i})"


@dataclasses.dataclass(frozen=True)
class GuardParams:
    """Guard thresholds.

    ``div_factor``: trip DIVERGED when the recursive relative residual
    exceeds ``div_factor *`` the best residual seen so far (loose: CG
    residuals oscillate on ill-conditioned problems).

    ``stall_window``: trip STALLED after this many iterations without a
    new best residual; must comfortably exceed the monitor's window.
    """
    div_factor: float = 1e4
    stall_window: int = 1000


DEFAULT_GUARDS = GuardParams()


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    # A fill on the device: ``as_tensor`` of a host scalar would copy it
    # to the card and wait for the stream, once per constant per step.
    return torch.full((), v, dtype=torch.int32, device=like.device)


def guard_init(relres0: torch.Tensor) -> dict:
    """Guard state for a loop whose initial relative residual is
    ``relres0``; a non-finite initial residual trips at once (trip 0)."""
    finite = torch.isfinite(relres0)
    big = torch.finfo(relres0.dtype).max
    return {
        "health": torch.where(finite, _i32(HEALTH_OK, relres0),
                              _i32(HEALTH_NONFINITE, relres0)),
        "best": torch.where(finite, relres0, big),
        "best_it": _i32(0, relres0),
        "trip": torch.where(finite, _i32(-1, relres0), _i32(0, relres0)),
    }


def guard_step(g, it, relres, params: GuardParams, *, denom=None,
               breakdown=False, finite_aux=()) -> dict:
    """One guard update, evaluated after the iteration's arithmetic.

    ``it`` is the (0-based) iteration that just ran, ``relres`` its new
    recursive relative residual, ``denom`` the curvature ``p.Ap``.  Only
    the first trip is latched.
    """
    finite = torch.isfinite(relres)
    for a in finite_aux:
        finite = finite & torch.isfinite(a)
    ok = _i32(HEALTH_OK, relres)
    code = torch.where((it - g["best_it"]) >= params.stall_window,
                       _i32(HEALTH_STALLED, relres), ok)
    code = torch.where(relres > params.div_factor * g["best"],
                       _i32(HEALTH_DIVERGED, relres), code)
    bad = breakdown if isinstance(breakdown, torch.Tensor) else torch.full(
        (), bool(breakdown), device=relres.device)
    if denom is not None:
        bad = bad | (denom <= 0)
        finite = finite & torch.isfinite(denom)
    code = torch.where(bad, _i32(HEALTH_BREAKDOWN, relres), code)
    code = torch.where(finite, code, _i32(HEALTH_NONFINITE, relres))

    was_ok = g["health"] == HEALTH_OK
    improved = finite & (relres < g["best"])
    return {
        "health": torch.where(was_ok, code, g["health"]),
        "best": torch.where(improved, relres, g["best"]),
        "best_it": torch.where(improved, it, g["best_it"]),
        "trip": torch.where(was_ok & (code != HEALTH_OK), it, g["trip"]),
    }


def finalize_health(g, converged, relres, x_finite=True):
    """Map the end-of-loop state to the reported ``(health, trip_iter)``.

    Convergence overrides everything; an unconverged clean exit is maxiter
    exhaustion -> STALLED with ``trip = -1``.  ``g`` may be ``None``
    (guards disabled): the classification is then purely post-hoc.
    """
    ok_exit = torch.isfinite(relres) & torch.as_tensor(x_finite,
                                                       device=relres.device)
    base = torch.where(ok_exit, _i32(HEALTH_STALLED, relres),
                       _i32(HEALTH_NONFINITE, relres))
    trip = _i32(-1, relres)
    if g is not None:
        base = torch.where(g["health"] != HEALTH_OK, g["health"], base)
        trip = g["trip"]
    health = torch.where(converged, _i32(HEALTH_OK, relres), base)
    trip = torch.where(converged, _i32(-1, relres), trip)
    return health, trip


def run_with_recovery(run, x0, maxiter: int, init_tag: int = 1,
                      recover: bool = True, max_tag: int = 3):
    """Host-side tag escalation around a guarded solver run.

    ``run(x_start, budget, tag)`` executes the solver from ``x_start``
    with at most ``budget`` iterations, the monitor starting at ``tag``,
    and returns ``(res, ckpt)`` with ``ckpt`` the last known-finite
    iterate.  On a trip at tag < ``max_tag`` it restarts the run from
    ``ckpt`` at the next tag with the remaining budget and a fresh
    monitor; each escalation is written into ``switch_iters`` at its
    global iteration.  The merged result reports cumulative ``iters`` and
    the first global trip iteration.
    """
    res, ckpt = run(x0, maxiter, init_tag)
    if not recover:
        return res
    health = int(res.health)
    trip = int(res.trip_iter)
    if health == HEALTH_OK or trip < 0:
        return res

    total = int(res.iters)
    first_trip = trip
    sw = [int(s) for s in res.switch_iters.tolist()]
    tag = max(int(res.tag), init_tag)
    while health != HEALTH_OK and trip >= 0 and tag < max_tag:
        tag += 1
        if sw[tag - 2] < 0:
            sw[tag - 2] = total
        budget = max(maxiter - total, 1)
        res, ckpt = run(ckpt, budget, tag)
        inner_sw = res.switch_iters.tolist()
        for s in range(len(sw)):
            if inner_sw[s] >= 0 and sw[s] < 0:
                sw[s] = total + inner_sw[s]
        total += int(res.iters)
        health = int(res.health)
        trip = int(res.trip_iter)
        tag = max(int(res.tag), tag)
    dev = res.switch_iters.device
    return res._replace(
        iters=torch.tensor(total, dtype=torch.int32, device=dev),
        switch_iters=torch.tensor(sw, dtype=torch.int32, device=dev),
        trip_iter=torch.tensor(first_trip, dtype=torch.int32, device=dev),
    )


def run_with_recovery_map(run, x0, maxiter: int, tm, recover: bool = True):
    """Per-group twin of :func:`run_with_recovery`.

    ``run(x_start, budget, floor)`` executes the solver with the
    ``TagMap`` ``tm`` floored at ``floor`` (``TagMap.floored``: every group
    raised to at least the floor) and returns ``(res, ckpt)``.  A trip
    raises the floor one rung instead of the whole operator: only the
    groups below it promote.  The last rung (floor 3) is the uniform exact
    path.  Each escalation is written into ``switch_iters`` at its global
    iteration; the inner runs never step (their monitor is pinned at the
    map's max tag), so there is no inner switch to merge.
    """
    floor = tm.min_tag
    res, ckpt = run(x0, maxiter, floor)
    if not recover:
        return res
    health = int(res.health)
    trip = int(res.trip_iter)
    if health == HEALTH_OK or trip < 0:
        return res

    total = int(res.iters)
    first_trip = trip
    sw = [int(s) for s in res.switch_iters.tolist()]
    while health != HEALTH_OK and trip >= 0 and floor < 3:
        floor += 1
        if sw[floor - 2] < 0:
            sw[floor - 2] = total
        budget = max(maxiter - total, 1)
        res, ckpt = run(ckpt, budget, floor)
        total += int(res.iters)
        health = int(res.health)
        trip = int(res.trip_iter)
    dev = res.switch_iters.device
    return res._replace(
        iters=torch.tensor(total, dtype=torch.int32, device=dev),
        switch_iters=torch.tensor(sw, dtype=torch.int32, device=dev),
        trip_iter=torch.tensor(first_trip, dtype=torch.int32, device=dev),
    )
