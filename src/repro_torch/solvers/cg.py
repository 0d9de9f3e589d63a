"""Conjugate Gradient with stepped mixed precision (paper Alg. 3 + Sec IV).

Port of ``repro/solvers/cg.py``: ``CGResult``, ``_normalize_b_x0``,
``_record_switch`` (:295), ``_finish_with_correction`` (:593) and
``solve_cg`` (:853) with the fused path over a ``GSECSR`` or a SELL-C-sigma
``GSESellC`` (``_solve_cg_fused``, :310; the reference's :791/:825) and
the generic-callable path (``_solve_cg``, :214).  The two layouts give
bitwise the same trajectory.

The reference loop is a device ``while_loop`` that tests convergence
before every iteration.  Here the loop state -- x, r, p, the residual
norm, the iteration count, the monitor ring and tag, ``switches`` and
the guard state -- lives in tensors on the solve's device, and the body
runs in chunks of :data:`CHUNK` iterations.  Every iteration evaluates
the reference's loop condition on its incoming state and freezes every
update with ``torch.where(active, new, old)``, so iterations past the
exit are no-ops and ``iters`` is exactly the reference's.  The host syncs
once per chunk.  The SpMV kernel reads the monitor's tag from device
memory, so no sync picks a precision.  The tag is switched in place (no
restart, no residual recomputation), as in Algorithm 3.

Not yet ported (ROADMAP queue 1): the flight recorder (``flight=``),
per-group TagMaps and ``tags="adaptive"``, and sharded operands.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.core import precision as P
from repro_torch.kernels.vec_f64 import ref_norm_cols, seq_dot, sqrt_rn
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    HEALTH_OK,
    finalize_health,
    guard_init,
    guard_step,
    run_with_recovery,
)
from repro_torch.solvers.fused_cg import cg_update, fused_cg_step_g, gse_matvec
from repro_torch.sparse.csr import GSECSR, GSESellC

__all__ = ["CGResult", "solve_cg", "CHUNK"]

# Iterations run between two host syncs of the stepped loop.
CHUNK = 32


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor          # iterations executed
    relres: torch.Tensor         # final recursive relative residual
    tag: torch.Tensor            # final precision tag
    switch_iters: torch.Tensor   # (2,) iteration of tag->2 and tag->3 (-1: never)
    converged: torch.Tensor
    # Health code (robustness.guards.HEALTH_*) and the first iteration a
    # guard tripped (-1: never; >= 0 with health ok: tripped, recovered).
    health: torch.Tensor = HEALTH_OK
    trip_iter: torch.Tensor = -1


def _normalize_b_x0(b, x0, device=None):
    """Accept ``b``/``x0`` as ``(n,)`` or ``(n, 1)``; reject anything else.

    Returns ``(b_1d, x0_1d_or_None, orig_shape)``.  Mismatched shapes or
    dtypes between ``b`` and ``x0`` raise a ``ValueError`` up front.
    """
    b = torch.as_tensor(b, device=device)
    orig_shape = tuple(b.shape)
    if b.dim() == 2 and b.shape[1] == 1:
        b = b[:, 0]
    elif b.dim() != 1:
        raise ValueError(f"b must be (n,) or (n, 1); got {orig_shape}")
    b = b.contiguous()
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=b.device)
        x0_shape = tuple(x0.shape)
        if x0.dim() == 2 and x0.shape[1] == 1:
            x0 = x0[:, 0]
        elif x0.dim() != 1:
            raise ValueError(f"x0 must be (n,) or (n, 1); got {x0_shape}")
        if x0.shape[0] != b.shape[0]:
            raise ValueError(
                f"x0/b shape mismatch: x0 has {x0.shape[0]} rows, "
                f"b has {b.shape[0]}"
            )
        if x0.dtype != b.dtype:
            raise ValueError(f"x0/b dtype mismatch: {x0.dtype} vs {b.dtype}")
        x0 = x0.contiguous()
    return b, x0, orig_shape


def _norm(v):
    """The reference's ``jnp.linalg.norm(v)``, bit for bit."""
    return ref_norm_cols(v[None], device=v.device)[0]


def _restore_shape(res: CGResult, orig_shape) -> CGResult:
    if tuple(res.x.shape) != tuple(orig_shape):
        res = res._replace(x=res.x.reshape(orig_shape))
    return res


def _record_switch(switches, mon, mon2, it):
    """Log the iteration of a tag step-up into its slot (0: ->2, 1: ->3);
    the slot is written only when a step actually occurred."""
    stepped = mon2.tag > mon.tag
    slot = torch.clamp(mon.tag - 1, 0, 1)
    hit = stepped & (torch.arange(2, device=switches.device) == slot)
    return torch.where(hit, it + 1, switches)


def _freeze(active, new, old):
    """``torch.where(active, new, old)`` over a loop-state tree."""
    if isinstance(new, dict):
        return {k: _freeze(active, new[k], old[k]) for k in new}
    if isinstance(new, P.MonitorState):
        return P.MonitorState(*(_freeze(active, getattr(new, f), getattr(old, f))
                                for f in ("hist", "count", "tag")))
    return torch.where(active, new, old)


def _cg_loop(matvec: Callable, step: Callable, b, x0, tol, maxiter: int,
             params: P.MonitorParams, init_tag: int,
             guards: GuardParams | None):
    """The stepped CG loop shared by the fused and generic paths.

    ``matvec(v, tag)`` forms the initial residual; ``step(s)`` returns
    ``(x', r', p', rs', denom)`` for loop state ``s``.  Returns
    ``(CGResult, ckpt)``.
    """
    bnorm = _norm(b)
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)

    def relres(rs):
        return sqrt_rn(torch.abs(rs)) / bnorm

    mon = P.init(params, dtype=b.dtype, tag=init_tag, device=b.device)
    r0 = b - matvec(x0, mon.tag)
    state = dict(
        x=x0, r=r0, p=r0, rs=seq_dot(r0, r0),
        it=torch.zeros((), dtype=torch.int32, device=b.device),
        mon=mon,
        switches=torch.full((2,), -1, dtype=torch.int32, device=b.device),
    )
    if guards is not None:
        state["g"] = guard_init(relres(state["rs"]))
        state["ckpt"] = x0

    def cond(s):
        ok = (relres(s["rs"]) > tol) & (s["it"] < maxiter)
        if guards is not None:
            ok = ok & (s["g"]["health"] == HEALTH_OK)
        return ok

    def body(s):
        x, r, p, rs_new, denom = step(s)
        rel = relres(rs_new)
        mon = P.record(s["mon"], rel)
        mon2 = P.update_tag(mon, params)
        switches = _record_switch(s["switches"], mon, mon2, s["it"])
        out = dict(x=x, r=r, p=p, rs=rs_new, it=s["it"] + 1, mon=mon2,
                   switches=switches)
        if guards is not None:
            # After the update arithmetic, which is identical with guards
            # on or off; ckpt keeps the last state the guard judged healthy.
            g = guard_step(s["g"], s["it"], rel, guards, denom=denom)
            out["g"] = g
            out["ckpt"] = torch.where(g["health"] == HEALTH_OK, x, s["ckpt"])
        return out

    while bool(cond(state)):  # the one host sync per chunk
        for _ in range(CHUNK):
            state = _freeze(cond(state), body(state), state)

    rel = relres(state["rs"])
    conv = rel <= tol
    health, trip = finalize_health(state.get("g"), conv, rel)
    res = CGResult(x=state["x"], iters=state["it"], relres=rel,
                   tag=state["mon"].tag, switch_iters=state["switches"],
                   converged=conv, health=health, trip_iter=trip)
    return res, (state["ckpt"] if guards is not None else state["x"])


def _solve_cg_fused(a, b, x0, tol, maxiter, params, init_tag=1,
                    guards=None):
    """Fused-path CG over a ``GSECSR`` or ``GSESellC``: each iteration is one
    ``fused_cg_step_g`` (the curvature it returns feeds the guards)."""

    def step(s):
        return fused_cg_step_g(a, s["x"], s["r"], s["p"], s["rs"],
                               s["mon"].tag)

    return _cg_loop(lambda v, t: gse_matvec(a, v, t), step, b, x0, tol,
                    maxiter, params, init_tag, guards)


def _solve_cg(apply_a: Callable, b, x0, tol, maxiter, params, init_tag=1,
              guards=None):
    """Generic-operator CG: ``apply_a(v, tag)`` with the device tag."""

    def step(s):
        return cg_update(s["x"], s["r"], s["p"], s["rs"],
                         apply_a(s["p"], s["mon"].tag))

    return _cg_loop(apply_a, step, b, x0, tol, maxiter, params, init_tag,
                    guards)


def _finish_with_correction(res, b, tol, maxiter, apply3, resume):
    """Verify the true tag-3 residual and, when the recursive convergence
    was optimistic, resume at full precision (budget clamped to >= 1)."""
    bnorm = _norm(b)
    bnorm = torch.where(bnorm == 0, 1.0, bnorm)
    true_rel = _norm(b - apply3(res.x)) / bnorm
    if not (bool(res.converged) and float(true_rel) > tol):
        return res
    res2 = resume(res.x, max(maxiter - int(res.iters), 1))
    return CGResult(
        x=res2.x,
        iters=res.iters + res2.iters,
        relres=res2.relres,
        tag=res2.tag,
        switch_iters=res.switch_iters,
        converged=res2.converged,
        health=res2.health,
        trip_iter=torch.where(res2.trip_iter >= 0,
                              res2.trip_iter + res.iters, res.trip_iter),
    )


def solve_cg(
    apply_a: Union[Callable, GSECSR, GSESellC],
    b,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 5000,
    params: P.MonitorParams | None = None,
    final_correction: bool = False,
    guards: GuardParams | None = DEFAULT_GUARDS,
    recover: bool = True,
    init_tag: int = 1,
    flight=None,
    tags=None,
) -> CGResult:
    """CG for SPD systems with stepped mixed precision.

    Passing a ``GSECSR`` or a SELL-C-sigma ``GSESellC`` (from
    ``kernels.ops.sell_pack_gsecsr``) as ``apply_a`` selects the fused
    iteration path and runs on the operand's device (bitwise alike: the
    layouts differ only in what the kernels stream); a callable ``apply_a(x, tag)`` (for
    example ``make_gse_operator(a)``) runs on ``b``'s device.  The two
    paths give identical results.

    ``final_correction``: after convergence verify the tag-3 residual and
    resume at full precision until the true residual meets ``tol``.
    ``guards`` (default on; ``None`` turns them off) adds breakdown/
    divergence/non-finite/stall detection; with ``recover`` a trip at
    tag < 3 rolls back to the last finite checkpoint and escalates the
    tag.  ``init_tag`` (or an int ``tags``) starts the monitor above
    tag 1.  ``b``/``x0`` may be ``(n,)`` or ``(n, 1)``; the solution comes
    back in ``b``'s layout.
    """
    if flight is not None:
        raise NotImplementedError(
            "flight= is not ported yet (ROADMAP queue 1 item 12)")
    if tags is not None:
        if isinstance(tags, bool) or not isinstance(tags, int):
            raise NotImplementedError(
                f"tags= takes an int tag; {type(tags).__name__} (TagMap or "
                "'adaptive') is not ported yet (ROADMAP queue 1 item 11)")
        init_tag = tags
    fused = isinstance(apply_a, (GSECSR, GSESellC))
    if not fused and not callable(apply_a):
        raise NotImplementedError(
            f"solve_cg takes a GSECSR, a GSESellC or a callable; {type(apply_a).__name__} "
            "operands (sharded) are not ported yet (ROADMAP queue 1 item 15)")
    b, x0, orig_shape = _normalize_b_x0(b, x0,
                                        apply_a.device if fused else None)
    if x0 is None:
        x0 = torch.zeros_like(b)
    if params is None:
        params = P.MonitorParams.for_cg()
    tol_ = torch.tensor(tol, dtype=b.dtype, device=b.device)
    solve = _solve_cg_fused if fused else _solve_cg

    def run(x_start, budget, tag):
        return solve(apply_a, b, x_start, tol_, budget, params,
                     init_tag=tag, guards=guards)

    res = run_with_recovery(run, x0, maxiter, init_tag=init_tag,
                            recover=recover and guards is not None)
    if not final_correction:
        return _restore_shape(res, orig_shape)
    tag3 = torch.full((), 3, dtype=torch.int32, device=b.device)

    def apply3(v):
        return gse_matvec(apply_a, v, tag3) if fused else apply_a(v, tag3)

    def resume(xr, budget):
        return run(xr, budget, 3)[0]

    return _restore_shape(
        _finish_with_correction(res, b, tol, maxiter, apply3, resume),
        orig_shape,
    )
