"""Stepped mixed-precision iterative refinement (Carson-Khan shape).

Port of ``repro/solvers/ir.py``: ``IRResult`` (:54), ``solve_ir`` (:73),
``_ir_setup`` (:122), ``_ir_active`` (:172), ``_ir_step`` (:178) and
``_ir_result`` (:222).

Outer loop at full precision, inner solves at stepped low precision::

    repeat:
        r = b - A x          # tag-3 residual (the true residual)
        d ~= A^{-1} r        # stepped inner solve, starting at tag 1
        x = x + d            # full-precision correction

The outer residual reads the same packed operand at tag 3 (kernel A64,
or the callable at tag 3), so no second matrix copy is needed; the inner
solve (``solve_cg``, ``solve_pcg`` or ``solve_gmres``) reads it at
whatever tag its monitor has stepped to, and every correction starts its
monitor at tag 1 again.  The norms are the reference's
``jnp.linalg.norm`` bit for bit (``cg._norm``), so the outer history is
the reference's on the named cases.

The loop is split into ``_ir_setup``/``_ir_active``/``_ir_step``/
``_ir_result`` as in the reference: a chunked serve layer drives it one
correction at a time with the same arithmetic.

``tags`` (:100-110) threads to the inner CG/PCG solves: an int or a
uniform ``TagMap`` starts every correction's monitor there, a non-uniform
map runs each correction on the masked operand, and ``"adaptive"`` runs
each correction through ``solvers.adaptive.solve_adaptive``.  The outer
tag-3 residual always reads the unmasked operand, so the refinement
target stays the true operator.

``flight=`` (:64-67, :172, :207-209, :244) threads a ``FlightParams`` to
every inner solve and collects each correction's recorder state on
``IRResult.flight`` (the adaptive driver's results carry none).
``solve_ir`` runs its corrections inside the ``solve.ir`` span.

Not yet ported (ROADMAP queue 1 item 15): sharded operands, which raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch.core import precision as P
from repro_torch.kernels.vec_f64 import seq_dot
from repro_torch.obs import flight as OF
from repro_torch.obs import trace as OT
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    HEALTH_NONFINITE,
    HEALTH_OK,
    HEALTH_STALLED,
)
from repro_torch.solvers.cg import (_gsecsr_operator, _norm, _normalize_b_x0,
                                    solve_cg, solve_pcg)
from repro_torch.solvers.gmres import solve_gmres
from repro_torch.sparse.csr import GSECSR, GSESellC

__all__ = ["IRResult", "solve_ir"]


class IRResult(NamedTuple):
    x: torch.Tensor
    outer_iters: int          # correction steps taken
    inner_iters: int          # total inner-solver iterations
    relres: float             # final true (tag-3) relative residual
    converged: bool
    history: np.ndarray       # (outer_iters + 1,) outer residual trajectory
    # HEALTH_OK when converged; otherwise the failing inner solve's health
    # code, HEALTH_NONFINITE if the outer tag-3 residual went non-finite,
    # or HEALTH_STALLED on plain max_outer exhaustion.
    health: int = HEALTH_OK
    # The inner solves' flight-recorder states, one per correction in
    # outer-iteration order, when ``flight`` was requested.
    flight: object = None


def check_ir_options(apply_a, flight):
    """Refuse a ``flight=`` that is not a ``FlightParams`` and the
    operands not ported yet (shared with ``batched.solve_ir_batched``)."""
    OF.check_flight(flight)
    if not isinstance(apply_a, (GSECSR, GSESellC)) and not callable(apply_a):
        raise NotImplementedError(
            f"iterative refinement takes a GSECSR, a GSESellC or a callable; "
            f"{type(apply_a).__name__} operands (sharded) are not ported yet "
            "(ROADMAP queue 1 item 15)")


def solve_ir(
    apply_a: Union[Callable, GSECSR, GSESellC],
    b,
    tol: float = 1e-10,
    max_outer: int = 10,
    inner: str = "cg",
    inner_tol: float = 1e-4,
    inner_maxiter: int = 2000,
    params: P.MonitorParams | None = None,
    precond=None,
    restart: int = 30,
    guards: GuardParams | None = DEFAULT_GUARDS,
    flight=None,
    tags=None,
) -> IRResult:
    """Iterative refinement with a stepped inner solver.

    ``apply_a`` is a ``GSECSR`` or ``GSESellC`` (the inner CG then takes
    the fused path; the solve runs on the operand's device) or a callable
    ``apply_a(x, tag)`` (on ``b``'s device).  ``inner`` selects ``"cg"``
    or ``"gmres"``; ``precond`` (a :mod:`repro_torch.solvers.precond`
    object or callable) turns the inner solve into PCG or right-
    preconditioned GMRES(``restart``).  ``params`` parameterizes the inner
    residual monitor; each correction restarts it at tag 1.  ``tags``
    (inner CG only) threads to the inner solves: an int or a uniform
    ``TagMap`` starts their monitors there, a non-uniform map masks their
    operand, ``"adaptive"`` runs them through the adaptive driver; the
    outer tag-3 residual reads the unmasked operand.  ``guards`` thread
    into every inner solve; a non-finite correction is never folded into
    ``x`` and ``health`` names the failing stage.  ``flight`` (a
    ``FlightParams``) records every inner solve; ``IRResult.flight`` lists
    their states.  ``b`` is ``(n,)`` or ``(n, 1)``; ``x`` comes back in
    its layout.
    """
    if tags is not None and inner != "cg":
        raise ValueError("tags= requires inner='cg' (the GMRES inner "
                         "solve keeps the scalar tag axis)")
    st = _ir_setup(apply_a, b, tol=tol, max_outer=max_outer, inner=inner,
                   inner_tol=inner_tol, inner_maxiter=inner_maxiter,
                   params=params, precond=precond, restart=restart,
                   guards=guards, flight=flight, tags=tags)
    with OT.span("solve.ir", n=int(st["b"].shape[0]), tol=float(tol),
                 inner=inner):
        while _ir_active(st):
            _ir_step(st)
    return _ir_result(st)


def _ir_setup(apply_a, b, *, tol, max_outer, inner, inner_tol, inner_maxiter,
              params, precond, restart, guards, flight, tags=None) -> dict:
    """The host-side refinement state of ``solve_ir``: a dict advanced one
    correction at a time by ``_ir_step``; ``_ir_active`` is the loop
    condition and ``_ir_result`` makes the final ``IRResult``."""
    check_ir_options(apply_a, flight)
    if inner not in ("cg", "gmres"):
        raise ValueError(f"inner must be 'cg' or 'gmres', got {inner}")
    if params is None:
        params = (P.MonitorParams.for_cg() if inner == "cg"
                  else P.MonitorParams.for_gmres())
    gse_op = isinstance(apply_a, (GSECSR, GSESellC))
    apply_tagged = _gsecsr_operator(apply_a) if gse_op else apply_a
    b, _, orig_shape = _normalize_b_x0(b, None,
                                       apply_a.device if gse_op else None)

    def apply3(v):
        return apply_tagged(v, 3)

    bnorm = float(_norm(b))
    bnorm = bnorm if bnorm != 0 else 1.0
    x = torch.zeros_like(b)
    # One tag-3 residual per correction: the convergence check and the
    # next inner right-hand side.
    r = b - apply3(x)
    relres = float(_norm(r)) / bnorm
    return dict(
        apply_a=apply_a, apply_tagged=apply_tagged, apply3=apply3, b=b,
        orig_shape=orig_shape, bnorm=bnorm, tol=tol, max_outer=max_outer,
        inner=inner, inner_tol=inner_tol, inner_maxiter=inner_maxiter,
        params=params, precond=precond, restart=restart, guards=guards,
        flight=flight, tags=tags, x=x, r=r, d=None, relres=relres,
        history=[relres], total_inner=0, outer=0, inner_health=HEALTH_OK,
        stopped=False, flights=[] if flight is not None else None,
    )


def _ir_active(st: dict) -> bool:
    """True while another correction would run (``solve_ir``'s loop
    condition)."""
    return (not st["stopped"] and st["relres"] > st["tol"]
            and np.isfinite(st["relres"]) and st["outer"] < st["max_outer"])


def _ir_step(st: dict) -> dict:
    """One outer correction: the inner solve at stepped precision, the
    fold, the tag-3 residual.  ``stopped`` records the early exits (a
    non-finite correction, an inner solve that made no progress); ``d``
    keeps the last correction."""
    kw = dict(tol=st["inner_tol"], maxiter=st["inner_maxiter"],
              params=st["params"], guards=st["guards"], flight=st["flight"])
    if st["inner"] == "cg":
        if st["precond"] is not None:
            res = solve_pcg(st["apply_a"], st["r"], st["precond"],
                            tags=st["tags"], **kw)
        else:
            res = solve_cg(st["apply_a"], st["r"], tags=st["tags"], **kw)
    else:
        res = solve_gmres(st["apply_tagged"], st["r"],
                          restart=st["restart"], precond=st["precond"], **kw)
    st["inner_health"] = int(getattr(res, "health", HEALTH_OK))
    st["total_inner"] += int(res.iters)
    res_flight = getattr(res, "flight", None)  # adaptive results carry none
    if st["flights"] is not None and res_flight is not None:
        st["flights"].append(res_flight)
    st["d"] = res.x
    if not bool(torch.isfinite(seq_dot(res.x, res.x))):
        st["stopped"] = True  # never fold a non-finite correction into x
        return st
    st["x"] = st["x"] + res.x  # the full-precision correction
    st["outer"] += 1
    st["r"] = st["b"] - st["apply3"](st["x"])  # the one tag-3 read
    st["relres"] = float(_norm(st["r"])) / st["bnorm"]
    st["history"].append(st["relres"])
    if not bool(res.converged) and int(res.iters) == 0:
        st["stopped"] = True  # the inner solve made no progress
    return st


def _ir_result(st: dict) -> IRResult:
    """The final report of the host refinement state."""
    relres = st["relres"]
    converged = relres <= st["tol"]
    if converged:
        health = HEALTH_OK
    elif not np.isfinite(relres):
        health = HEALTH_NONFINITE
    elif st["inner_health"] != HEALTH_OK:
        health = st["inner_health"]
    else:
        health = HEALTH_STALLED
    return IRResult(
        x=st["x"].reshape(st["orig_shape"]),
        outer_iters=st["outer"],
        inner_iters=st["total_inner"],
        relres=relres,
        converged=converged,
        history=np.asarray(st["history"]),
        health=health,
        flight=st["flights"],
    )
