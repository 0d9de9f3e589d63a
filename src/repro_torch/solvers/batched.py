"""Batched multi-RHS stepped CG: per-column precision schedules over one
shared operand.

Port of ``repro/solvers/batched.py``: ``BatchedCGResult`` (:93),
``BatchedIRResult`` (:114), ``_normalize_block`` (:141),
``_batched_krylov_loop`` (:163), ``_solve_cg_batched_fused`` (:326),
``_solve_cg_batched`` (:354), ``solve_cg_batched`` (:383), the batched
PCG and IR (below), ``column_tags_at`` (:706) and ``batched_run_bytes``
(:727).

With ``nrhs`` right-hand sides one streaming pass over the packed matrix
serves every column (kernel C64, ``kernels.gse_spmm.gse_spmm_csr_f64``,
or over a SELL-C-sigma ``GSESellC`` kernel C′64, ``gse_spmm_sell_f64``),
so the matrix stream is charged once per iteration however wide the batch
is.  Each column carries its own residual monitor, tag schedule, switch
log and guard state, and stops on its own.

Column ``j`` runs exactly the operations of ``solve_cg`` on ``b[:, j]``
(the reference's contract, ``repro/solvers/batched.py:14-23``): C64's
column j is bitwise A64 at that column's tag, the column-batched dot and
updates (``kernels.vec_f64.seq_dot_cols``/``fma_axpy_cols``) are bitwise
the single-vector ones, and the monitor, ``_record_switch`` and the guards
run per column through the single-RHS functions, as the reference unrolls
them (a vectorised window sum could add in another order and move a
switch).

The loop keeps ``solvers/cg.py``'s design: the state of every column lives
on the device, the body runs in chunks of ``CHUNK`` iterations with one
host sync per chunk (``while any(active)``), and each column's update is
frozen with ``torch.where(active_j, new, old)``, where ``active_j`` is the
reference's ``col_active`` on the incoming state -- so ``iters[j]`` is
exactly the reference's.  The vectors are stored ``(nrhs, n)``, one
contiguous column per right-hand side; the public API takes and returns
``(n, nrhs)`` blocks, as the reference does.  An all-zero padding column
has ``||b||`` replaced by 1 and relres 0: it is never active and reports
0 iterations.

Batched PCG (``_solve_pcg_batched_fused`` :450, ``_solve_pcg_batched``
:479, ``solve_pcg_batched`` :509) runs the same loop with a column also
carrying ``z`` and ``rz = r.z``, in the reference's op order (:494-504);
the preconditioner applies per column at the column's device tag
(``apply_cols``: a gather of decoded diagonals, or kernel C64 on
block-Jacobi's inverse).  ``solve_ir_batched`` (:572) is iterative
refinement's outer loop over a block, its inner solves batched, and
``batched_run_bytes`` charges a preconditioner beside the matrix
(:727-748).

The ``tags=`` axis (``_batched_tag_axis``, :62-90): an int or a uniform
``TagMap`` starts every column's monitor at that tag; a non-uniform map
runs the masked operand (``kernels.ops.masked_for_tagmap``) for the whole
batch at the map's max tag, the monitor pinned there, as ``solve_cg``
does; ``"adaptive"`` is single-RHS and refused.

``flight=`` (``obs.flight``; the reference's :184-187, :211-212, :254-265
and :313-315) gives every column its own recorder ring, stacked along a
leading nrhs axis (``obs.flight.split_batched`` splits it): a row per
live iteration of the column (alpha, beta, ``p.Ap``, the guard's health),
gated on the column's ``active``.  ``solve_cg_batched`` and
``solve_pcg_batched`` run inside the ``solve.cg_batched``/
``solve.pcg_batched`` spans; ``BatchedIRResult.flight`` lists the
stacked rings of the corrections.

Not yet ported (ROADMAP queue 1 item 15): sharded operands.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import numpy as np
import torch

from repro_torch.core import precision as P
from repro_torch.core.gse import _np
from repro_torch.kernels.gse_spmm import gse_spmm_csr_f64, gse_spmm_sell_f64
from repro_torch.kernels.vec_f64 import (fma_axpy_cols, on_device,
                                         ref_norm_cols, seq_dot_cols, sqrt_rn)
from repro_torch.obs import flight as OF
from repro_torch.obs import trace as OT
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    HEALTH_NONFINITE,
    HEALTH_OK,
    HEALTH_STALLED,
    finalize_health,
    guard_init,
    guard_step,
)
from repro_torch.solvers.cg import (CHUNK, _freeze, _gsecsr_operator,
                                    _record_switch)
from repro_torch.solvers.ir import check_ir_options
from repro_torch.sparse.csr import GSECSR, GSESellC, iteration_stream_bytes

__all__ = ["BatchedCGResult", "BatchedIRResult", "solve_cg_batched",
           "solve_pcg_batched", "solve_ir_batched", "batched_run_bytes",
           "column_tags_at"]


class BatchedCGResult(NamedTuple):
    x: torch.Tensor             # (n, nrhs) solutions
    iters: torch.Tensor         # (nrhs,) iterations executed per column
    relres: torch.Tensor        # (nrhs,) final recursive relative residuals
    tag: torch.Tensor           # (nrhs,) final precision tag per column
    switch_iters: torch.Tensor  # (nrhs, 2) iteration of tag->2 / tag->3 (-1: never)
    converged: torch.Tensor     # (nrhs,) bool
    # Per-column health codes (robustness.guards.HEALTH_*) and first
    # guard-trip iteration (-1: never).  A tripped column freezes at once;
    # recovery is the serving layer's bounded tag-3 retry.
    health: torch.Tensor = HEALTH_OK
    trip_iter: torch.Tensor = -1
    # Stacked per-column flight-recorder states (leading nrhs axis; None
    # when recording is off): ``obs.flight.split_batched`` splits them.
    flight: object = None


def _normalize_block(b, x0, device):
    """Accept ``b``/``x0`` as ``(n,)`` or ``(n, nrhs)`` blocks on
    ``device``."""
    b = torch.as_tensor(b, device=device)
    if b.dim() == 1:
        b = b[:, None]
    if b.dim() != 2:
        raise ValueError(f"b must be (n,) or (n, nrhs); got {tuple(b.shape)}")
    if x0 is None:
        x0 = torch.zeros_like(b)
    else:
        x0 = torch.as_tensor(x0, device=device)
        if x0.dim() == 1:
            x0 = x0[:, None]
        if x0.shape != b.shape:
            raise ValueError(f"x0/b shape mismatch: {tuple(x0.shape)} vs "
                             f"{tuple(b.shape)}")
        if x0.dtype != b.dtype:
            raise ValueError(f"x0/b dtype mismatch: {x0.dtype} vs {b.dtype}")
    return b, x0


def _cg_update_cols(x, r, p, rs, ap, active, device, apply_z=None):
    """``solvers.fused_cg.cg_update`` (``pcg_update`` with ``apply_z``, the
    preconditioner on the block) on ``(nrhs, n)`` blocks, column j bitwise
    the single-RHS step.  Returns ``(x', r', p', rs', rr', denom)``: ``rs``
    drives the recurrence (``r.r``, or ``r.z`` with a preconditioner),
    ``rr = r.r`` feeds the monitor."""
    denom = seq_dot_cols(p, ap, active, device=device)
    alpha = rs / torch.where(denom == 0, 1.0, denom)
    x2 = fma_axpy_cols(alpha, p, x, device=device)
    r2 = fma_axpy_cols(-alpha, ap, r, device=device)
    if apply_z is None:
        z2 = r2
        rs2 = rr2 = seq_dot_cols(r2, r2, active, device=device)
    else:
        z2 = apply_z(r2)
        rs2 = seq_dot_cols(r2, z2, active, device=device)
        rr2 = seq_dot_cols(r2, r2, active, device=device)
    beta = rs2 / torch.where(rs == 0, 1.0, rs)
    p2 = fma_axpy_cols(beta, p, z2, device=device)
    return x2, r2, p2, rs2, rr2, denom


def _batched_krylov_loop(b, x0, tol, maxiter: int, params: P.MonitorParams,
                         init_tag: int, matvec: Callable,
                         guards: GuardParams | None, device,
                         apply_m: Callable | None = None, flight=None,
                         resume: dict | None = None, stop_at=None,
                         return_state: bool = False):
    """The batched stepped CG and PCG loop over ``(nrhs, n)`` blocks
    ``b``/``x0``.

    ``matvec(v, tags, active)`` returns ``A v`` for the ``(nrhs, n)`` block
    ``v``, column j at the device tag ``tags[j]`` (rows of inactive
    columns are ignored); ``apply_m(v, tags, active)`` (PCG) returns
    ``M^{-1} v`` the same way, and each column then also carries ``z`` and
    ``rz = r.z``.  ``flight`` (a ``FlightParams``) stacks a recorder ring
    per column.  Returns a :class:`BatchedCGResult`.

    The chunk hooks (the reference's :163-317): ``resume`` is a state this
    loop returned (the init is skipped; ``x0`` is then unused), ``stop_at``
    a per-column sequence of iteration bounds ANDed into each column's
    liveness (all 0: the init and no iteration), and ``return_state``
    returns ``(result, state)``.  The state stacks the columns: ``x``,
    ``r``, ``p`` as ``(nrhs, n)`` blocks, ``rs``, ``rr`` and ``it`` as
    ``(nrhs,)``, a per-column list ``cols`` (monitor, switches, guard) and
    the stacked ring ``fl``; :func:`take_cols` and :func:`cat_cols` select
    and join columns of it.  A bound is a pure extra exit condition, so a
    chunked run is bitwise the unchunked one, and a bounded call runs only
    the iterations left before its last live column's bound.
    """
    nrhs = b.shape[0]
    pcg = apply_m is not None
    every = torch.ones(nrhs, dtype=torch.bool, device=b.device)
    bn = ref_norm_cols(b, device=device)
    bnorms = torch.where(bn == 0, 1.0, bn)

    def relres(rr):
        return sqrt_rn(torch.abs(rr)) / bnorms

    if resume is not None:
        state = resume
    else:
        state = _batched_init(b, x0, params, init_tag, matvec, guards,
                              device, apply_m, flight, relres)
    bound = None
    if stop_at is not None:
        stop = [int(s) for s in stop_at]
        if len(stop) != nrhs:
            raise ValueError(f"stop_at has {len(stop)} bounds for {nrhs} "
                             "columns")
        bound = torch.tensor(stop, dtype=torch.int32, device=b.device)

    def col_active(s):
        alive = (relres(s["rr"]) > tol) & (s["it"] < maxiter)
        if bound is not None:
            alive = alive & (s["it"] < bound)
        if guards is not None:
            health = torch.stack([c["g"]["health"] for c in s["cols"]])
            alive = alive & (health == HEALTH_OK)
        return alive

    def body(s, act):
        tags = torch.stack([c["mon"].tag for c in s["cols"]])
        ap = matvec(s["p"], tags, act)
        apply_z = (lambda v: apply_m(v, tags, act)) if pcg else None
        x, r, p, rs, rr, denom = _cg_update_cols(
            s["x"], s["r"], s["p"], s["rs"], ap, act, device, apply_z)
        rel = relres(rr)
        cols = []
        for j, c in enumerate(s["cols"]):
            it = s["it"][j]
            mon1 = P.record(c["mon"], rel[j])
            mon2 = P.update_tag(mon1, params)
            new = dict(mon=mon2, sw=_record_switch(c["sw"], mon1, mon2, it))
            if guards is not None:
                # After the update arithmetic, which is identical with
                # guards on or off.  z.r < 0 breaks PCG's M-SPD contract.
                new["g"] = guard_step(
                    c["g"], it, rel[j], guards, denom=denom[j],
                    breakdown=(rs[j] < 0) if pcg else False,
                    finite_aux=(rs[j],) if pcg else ())
            cols.append(_freeze(act[j], new, c))
        live = act[:, None]
        out = dict(x=torch.where(live, x, s["x"]),
                   r=torch.where(live, r, s["r"]),
                   p=torch.where(live, p, s["p"]),
                   rs=torch.where(act, rs, s["rs"]),
                   rr=torch.where(act, rr, s["rr"]),
                   it=torch.where(act, s["it"] + 1, s["it"]),
                   cols=cols)
        if flight is not None:
            # Observation only: alpha and beta from the scalars the step
            # produced (the r.z recurrence under PCG, r.r under CG), a row
            # for each active column.
            out["fl"] = OF.flight_record(
                s["fl"], it=s["it"], relres=rel, tag=tags,
                health=(torch.stack([c["g"]["health"] for c in cols])
                        if guards is not None else None),
                a0=s["rs"] / torch.where(denom == 0, 1.0, denom),
                a1=rs / torch.where(s["rs"] == 0, 1.0, s["rs"]),
                a2=denom, active=act)
        return out

    act = col_active(state)
    while True:  # the one host sync per chunk
        if bound is None:
            if not bool(act.any()):
                break
            n = CHUNK
        else:
            row = torch.cat([act.to(torch.int64),
                             state["it"].to(torch.int64)]).tolist()
            live = [s - i for a, s, i in zip(row[:nrhs], stop, row[nrhs:])
                    if a]
            if not live:
                break
            left = max(live)  # iterations to the last live column's bound
            n = min(CHUNK, left)
        for _ in range(n):
            state = body(state, act)
            act = col_active(state)
        if bound is not None and n == left:
            break  # every live column has reached its bound: no sync

    rel = relres(state["rr"])
    cols = state["cols"]
    if guards is not None:
        xx = seq_dot_cols(state["x"], state["x"], every, device=device)
        x_finite = torch.isfinite(xx)
        per_col = [finalize_health(c["g"], rel[j] <= tol, rel[j],
                                   x_finite=x_finite[j])
                   for j, c in enumerate(cols)]
        health = torch.stack([h for h, _ in per_col])
        trip_iter = torch.stack([t for _, t in per_col])
        converged = (rel <= tol) & x_finite
    else:
        health = torch.full((nrhs,), HEALTH_OK, dtype=torch.int32,
                            device=b.device)
        trip_iter = torch.full((nrhs,), -1, dtype=torch.int32,
                               device=b.device)
        converged = rel <= tol
    res = BatchedCGResult(
        x=state["x"].t(),
        iters=state["it"],
        relres=rel,
        tag=torch.stack([c["mon"].tag for c in cols]),
        switch_iters=torch.stack([c["sw"] for c in cols]),
        converged=converged,
        health=health,
        trip_iter=trip_iter,
        flight=state.get("fl"),
    )
    return (res, state) if return_state else res


def _batched_init(b, x0, params, init_tag, matvec, guards, device, apply_m,
                  flight, relres) -> dict:
    """The loop state of a fresh batched run: every column's monitor, its
    initial residual (one operator application at the start tag), search
    direction and dots, as the reference's ``init_col`` makes them."""
    nrhs = b.shape[0]
    every = torch.ones(nrhs, dtype=torch.bool, device=b.device)
    mons = [P.init(params, dtype=b.dtype, tag=init_tag, device=b.device)
            for _ in range(nrhs)]
    tags0 = torch.stack([m.tag for m in mons])
    r0 = b - matvec(x0, tags0, every)
    if apply_m is not None:  # the reference's init_col: z0, r0.z0, r0.r0
        p0 = apply_m(r0, tags0, every)
        rs0 = seq_dot_cols(r0, p0, every, device=device)
    else:
        p0 = r0
    rr0 = seq_dot_cols(r0, r0, every, device=device)
    rel0 = relres(rr0)
    cols = []
    for j in range(nrhs):
        c = dict(mon=mons[j],
                 sw=torch.full((2,), -1, dtype=torch.int32, device=b.device))
        if guards is not None:
            c["g"] = guard_init(rel0[j])
        cols.append(c)
    state = dict(x=x0, r=r0, p=p0, rs=rs0 if apply_m is not None else rr0,
                 rr=rr0,
                 it=torch.zeros(nrhs, dtype=torch.int32, device=b.device),
                 cols=cols)
    if flight is not None:
        state["fl"] = OF.flight_init(flight, b.dtype, b.device, batch=nrhs)
    return state


_STACKED = ("x", "r", "p", "rs", "rr", "it")


def take_cols(state: dict, idx) -> dict:
    """The columns ``idx`` (a sequence of indices) of a batched loop state,
    in that order: exactly the state the loop would hold on those columns
    alone."""
    sel = torch.as_tensor(list(idx), dtype=torch.long,
                          device=state["x"].device)
    out = {k: state[k].index_select(0, sel) for k in _STACKED}
    out["cols"] = [state["cols"][j] for j in idx]
    if "fl" in state:
        out["fl"] = {k: v.index_select(0, sel) for k, v in state["fl"].items()}
    return out


def cat_cols(*states: dict) -> dict:
    """The batched loop states ``states`` side by side, their columns in
    order: exactly the state the loop would hold on all of them."""
    out = {k: torch.cat([s[k] for s in states]) for k in _STACKED}
    out["cols"] = [c for s in states for c in s["cols"]]
    if any("fl" in s for s in states):
        out["fl"] = {k: torch.cat([s["fl"][k] for s in states])
                     for k in states[0]["fl"]}
    return out


def _spmm(a, device) -> Callable:
    """The batched operator ``matvec(v, tags, active)`` over a ``GSECSR``
    (kernel C64) or a ``GSESellC`` (kernel C′64)."""

    def matvec(v, tags, active):
        if isinstance(a, GSESellC):
            return gse_spmm_sell_f64(*a.segments, a.table, v, tags, active,
                                     a.bucket_table, a.perm, a.row_len,
                                     rows=a.shape[0], ei_bit=a.ei_bit,
                                     long_from=a.long_from, device=device)
        return gse_spmm_csr_f64(a.rowptr, a.colpak, a.head, a.tail1, a.tail2,
                                a.table, v, tags, active, ei_bit=a.ei_bit,
                                plan=a.row_plan, device=device)

    return matvec


def _per_column(apply: Callable) -> Callable:
    """``apply(v, tag)`` on each column of a block at its device tag.  A
    frozen column's product is computed and discarded (the reference skips
    it behind ``lax.cond``; skipping here would need a sync)."""

    def cols(v, tags, active):
        del active
        return torch.stack([apply(v[j], tags[j]) for j in range(v.shape[0])])

    return cols


def _solve_cg_batched_fused(a, b, x0, tol, maxiter, params, init_tag=1,
                            guards=None, device="cuda", flight=None,
                            **hooks):
    """Fused path: one C64 (``GSECSR``) or C′64 (``GSESellC``) launch per
    iteration serves every column.  ``hooks``: ``resume``, ``stop_at`` and
    ``return_state`` of :func:`_batched_krylov_loop` (as in the three
    entries below)."""
    return _batched_krylov_loop(b, x0, tol, maxiter, params, init_tag,
                                _spmm(a, device), guards, device,
                                flight=flight, **hooks)


def _solve_cg_batched(apply_a: Callable, b, x0, tol, maxiter, params,
                      init_tag=1, guards=None, device="cuda", flight=None,
                      **hooks):
    """Generic path: ``apply_a(v, tag)`` on each column at its device
    tag."""
    return _batched_krylov_loop(b, x0, tol, maxiter, params, init_tag,
                                _per_column(apply_a), guards, device,
                                flight=flight, **hooks)


def _solve_pcg_batched_fused(a, m, b, x0, tol, maxiter, params, init_tag=1,
                             guards=None, device="cuda", flight=None,
                             **hooks):
    """Fused path: per iteration one C64/C′64 launch for the operator and
    the preconditioner's column apply (a gather of decoded diagonals, or
    C64 on block-Jacobi's inverse), every column at its own tag."""

    def apply_m(v, tags, active):
        return m.apply_cols(v, tags, active, device=device)

    return _batched_krylov_loop(b, x0, tol, maxiter, params, init_tag,
                                _spmm(a, device), guards, device,
                                apply_m=apply_m, flight=flight, **hooks)


def _solve_pcg_batched(apply_a: Callable, apply_m: Callable, b, x0, tol,
                       maxiter, params, init_tag=1, guards=None,
                       device="cuda", flight=None, **hooks):
    """Generic path: ``apply_a(v, tag)`` and ``apply_m(r, tag)`` on each
    column at its device tag."""
    return _batched_krylov_loop(b, x0, tol, maxiter, params, init_tag,
                                _per_column(apply_a), guards, device,
                                apply_m=_per_column(apply_m), flight=flight,
                                **hooks)


def _batched_tag_axis(tags, apply_a, m: int, params):
    """The batched ``tags=`` axis as ``(init_tag, apply_a, params)``: an
    int or a uniform map starts the monitors there on the operand itself
    (bitwise the int tag); a non-uniform map swaps in the masked operand,
    read at the map's max tag with the monitor pinned there.  There is no
    per-group recovery ladder in a batch: flagged columns go through the
    service's tag-3 retry."""
    if isinstance(tags, str):
        raise ValueError(
            "the batched solvers take an int tag or a TagMap; the "
            "'adaptive' driver is single-RHS (solvers.adaptive)")
    from repro_torch.solvers.cg import _normalize_tag_axis, _pin_params

    t, tm = _normalize_tag_axis(tags, apply_a, m)
    if tm is None:
        return (1 if t is None else t), apply_a, params
    from repro_torch.kernels.ops import masked_for_tagmap

    return tm.max_tag, masked_for_tagmap(apply_a, tm), _pin_params(
        params, tm.max_tag)


def _rows(b) -> int:
    """The row count of a right-hand side or block ``b``."""
    return int(b.shape[0])


def solve_cg_batched(
    apply_a: Union[Callable, GSECSR, GSESellC],
    b,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 5000,
    params: P.MonitorParams | None = None,
    guards: GuardParams | None = DEFAULT_GUARDS,
    flight=None,
    tags=None,
    *,
    device="cuda",
) -> BatchedCGResult:
    """Stepped CG over an ``(n, nrhs)`` right-hand-side block on ``device``.

    One shared operand, ``nrhs`` independent per-column precision
    schedules: each column carries its own residual monitor and steps its
    own tag, deactivating when it converges.  Column ``j`` is bitwise
    ``solve_cg(apply_a, b[:, j], ...)`` with the same parameters.

    Passing a ``GSECSR`` or a ``GSESellC`` (which must lie on ``device``)
    selects the fused path: one C64 (C′64) launch per iteration for the
    whole block.  A callable
    ``apply_a(x, tag)`` (e.g. ``make_gse_operator(a)``) is applied column
    by column.  The two paths give identical results.  ``guards`` attaches
    per-column breakdown/divergence/non-finite/stall detection; a tripped
    column freezes and reports its health code (no in-batch escalation).
    An int ``tags`` (or a uniform ``TagMap``) starts every column's
    monitor at that tag; a non-uniform map runs the masked operand at its
    max tag, the monitor pinned.  ``flight`` (a ``FlightParams``) gives each
    column a recorder ring (``BatchedCGResult.flight``, stacked).  ``b``
    and ``x0`` are ``(n,)`` or ``(n, nrhs)`` float64; the solution comes
    back ``(n, nrhs)``.
    """
    OF.check_flight(flight)
    if params is None:
        params = P.MonitorParams.for_cg()
    init_tag, apply_a, params = _batched_tag_axis(
        tags, apply_a, _rows(b), params)
    fused = isinstance(apply_a, (GSECSR, GSESellC))
    if not fused and not callable(apply_a):
        raise NotImplementedError(
            f"solve_cg_batched takes a GSECSR, a GSESellC or a callable; "
            f"{type(apply_a).__name__} operands (sharded) are not ported yet "
            "(ROADMAP queue 1 item 15)")
    if fused:
        on_device(device, operand=apply_a.table)
    b, x0 = _normalize_block(b, x0, device)
    if b.dtype != torch.float64:
        raise TypeError(f"b must be float64, got {b.dtype}")
    tol_ = torch.tensor(tol, dtype=b.dtype, device=b.device)
    solve = _solve_cg_batched_fused if fused else _solve_cg_batched
    with OT.span("solve.cg_batched", n=int(b.shape[0]),
                 nrhs=int(b.shape[1]), tol=float(tol)):
        return solve(apply_a, b.t().contiguous(), x0.t().contiguous(), tol_,
                     maxiter, params, init_tag=init_tag, guards=guards,
                     device=device, flight=flight)


def solve_pcg_batched(
    apply_a: Union[Callable, GSECSR, GSESellC],
    b,
    precond,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 5000,
    params: P.MonitorParams | None = None,
    guards: GuardParams | None = DEFAULT_GUARDS,
    flight=None,
    tags=None,
    *,
    device="cuda",
) -> BatchedCGResult:
    """Stepped preconditioned CG over an ``(n, nrhs)`` block on ``device``.

    The operator and the GSE-packed preconditioner both follow each
    column's own tag schedule; the stored segments of both are charged once
    per iteration however many columns ride along.  Column ``j`` is
    bitwise ``solve_pcg(apply_a, b[:, j], precond, ...)``.  A ``GSECSR``
    or ``GSESellC`` operand with a preconditioner object (from
    :mod:`repro_torch.solvers.precond`) selects the fused path; a callable
    operator or a callable ``precond(r, tag)`` the generic one; the two
    give identical results.  ``guards`` work as in
    :func:`solve_cg_batched` and also flag ``z.r < 0`` per column;
    ``tags`` and ``flight`` too (a non-uniform map's preconditioner runs at
    its max tag).
    """
    OF.check_flight(flight)
    if params is None:
        params = P.MonitorParams.for_cg()
    init_tag, apply_a, params = _batched_tag_axis(
        tags, apply_a, _rows(b), params)
    gse_op = isinstance(apply_a, (GSECSR, GSESellC))
    if not gse_op and not callable(apply_a):
        raise NotImplementedError(
            f"solve_pcg_batched takes a GSECSR, a GSESellC or a callable; "
            f"{type(apply_a).__name__} operands (sharded) are not ported yet "
            "(ROADMAP queue 1 item 15)")
    if gse_op:
        on_device(device, operand=apply_a.table)
    b, x0 = _normalize_block(b, x0, device)
    if b.dtype != torch.float64:
        raise TypeError(f"b must be float64, got {b.dtype}")
    tol_ = torch.tensor(tol, dtype=b.dtype, device=b.device)
    bt, x0t = b.t().contiguous(), x0.t().contiguous()
    with OT.span("solve.pcg_batched", n=int(b.shape[0]),
                 nrhs=int(b.shape[1]), tol=float(tol)):
        if gse_op and hasattr(precond, "apply_cols"):
            return _solve_pcg_batched_fused(
                apply_a, precond, bt, x0t, tol_, maxiter, params,
                init_tag=init_tag, guards=guards, device=device,
                flight=flight)
        apply_m = precond if callable(precond) else precond.apply
        op = _gsecsr_operator(apply_a) if gse_op else apply_a
        return _solve_pcg_batched(op, apply_m, bt, x0t, tol_, maxiter,
                                  params, init_tag=init_tag, guards=guards,
                                  device=device, flight=flight)


class BatchedIRResult(NamedTuple):
    x: torch.Tensor            # (n, nrhs)
    outer_iters: np.ndarray    # (nrhs,) correction steps per column
    inner_iters: np.ndarray    # (nrhs,) total inner iterations per column
    relres: np.ndarray         # (nrhs,) final true (tag-3) relative residuals
    converged: np.ndarray      # (nrhs,) bool
    history: list              # nrhs arrays of outer residual trajectories
    health: np.ndarray = None  # (nrhs,) health codes, as IRResult's
    # The stacked flight states of the inner batched solves, one per
    # correction (None when recording is off).
    flight: object = None


def solve_ir_batched(
    apply_a: Union[Callable, GSECSR, GSESellC],
    b,
    tol: float = 1e-10,
    max_outer: int = 10,
    inner_tol: float = 1e-4,
    inner_maxiter: int = 2000,
    params: P.MonitorParams | None = None,
    precond=None,
    guards: GuardParams | None = DEFAULT_GUARDS,
    flight=None,
    tags=None,
    *,
    device="cuda",
) -> BatchedIRResult:
    """Batched stepped iterative refinement: ``solve_ir``'s outer loop over
    an ``(n, nrhs)`` block on ``device``, the inner solves batched
    (:func:`solve_cg_batched`, or :func:`solve_pcg_batched` with
    ``precond``), every correction starting back at tag 1.  ``tags``
    threads to the inner batched solves only (an int or a uniform map
    starts their monitors there, a non-uniform map runs the masked
    operand); the outer tag-3 residual reads the unmasked operand.

    Each column refines until its true residual meets ``tol`` and then
    drops out: its inner right-hand side is zeroed, so it converges at
    inner iteration 0.  The tag-3 residuals are applied column by column
    (A64, or the callable at tag 3, as the reference stacks them) and
    each column's norm is ``solve_ir``'s, so an active column's
    trajectory is bitwise the single-RHS ``solve_ir``'s.  ``flight`` (a
    ``FlightParams``) collects each correction's stacked rings on
    ``BatchedIRResult.flight``.
    """
    check_ir_options(apply_a, flight)
    gse_op = isinstance(apply_a, (GSECSR, GSESellC))
    if gse_op:
        on_device(device, operand=apply_a.table)
    b, _ = _normalize_block(b, None, device)
    if params is None:
        params = P.MonitorParams.for_cg()
    apply_tagged = _gsecsr_operator(apply_a) if gse_op else apply_a
    bt = b.t().contiguous()  # (nrhs, n): one contiguous column a row
    nrhs = bt.shape[0]

    def residual(x):
        return bt - torch.stack([apply_tagged(x[j], 3) for j in range(nrhs)])

    def col_norms(block):  # each column's norm is solve_ir's, bitwise
        return ref_norm_cols(block, device=device).cpu().numpy()

    bnorms = col_norms(bt)
    bnorms = np.where(bnorms == 0, 1.0, bnorms)
    x = torch.zeros_like(bt)
    total_inner = np.zeros(nrhs, np.int64)
    outer = np.zeros(nrhs, np.int64)
    inner_health = np.zeros(nrhs, np.int64)
    r = residual(x)
    relres = col_norms(r) / bnorms
    history = [[float(v)] for v in relres]
    active = (relres > tol) & np.isfinite(relres) & (outer < max_outer)
    kw = dict(tol=inner_tol, maxiter=inner_maxiter, params=params,
              guards=guards, flight=flight, tags=tags, device=device)
    flights = [] if flight is not None else None
    while active.any():
        mask = torch.as_tensor(active, device=bt.device)
        # Converged columns drop out of the inner batch: a zero column
        # converges at inner iteration 0.
        r_in = torch.where(mask[:, None], r, 0.0).t()
        if precond is not None:
            res = solve_pcg_batched(apply_a, r_in, precond, **kw)
        else:
            res = solve_cg_batched(apply_a, r_in, **kw)
        if flights is not None:
            flights.append(res.flight)
        inner_health[active] = res.health.cpu().numpy()[active]
        # A non-finite correction column is never folded into x; that
        # column stops with its inner health code.
        col_fin = torch.isfinite(res.x).all(dim=0).cpu().numpy()
        take = torch.as_tensor(active & col_fin, device=bt.device)
        x = torch.where(take[:, None], x + res.x.t(), x)
        iters = res.iters.cpu().numpy()
        conv = res.converged.cpu().numpy()
        total_inner[active] += iters[active]
        outer[active & col_fin] += 1
        r = residual(x)
        relres = col_norms(r) / bnorms
        for j in range(nrhs):
            if active[j] and col_fin[j]:
                history[j].append(float(relres[j]))
        stalled = ~conv & (iters == 0)  # no progress, per column
        active = (active & (relres > tol) & np.isfinite(relres) & ~stalled
                  & col_fin & (outer < max_outer))
    converged = (relres <= tol) & np.isfinite(relres)
    health = np.where(
        converged, HEALTH_OK,
        np.where(~np.isfinite(relres), HEALTH_NONFINITE,
                 np.where(inner_health != HEALTH_OK, inner_health,
                          HEALTH_STALLED))).astype(np.int64)
    return BatchedIRResult(
        x=x.t(), outer_iters=outer, inner_iters=total_inner, relres=relres,
        converged=converged, history=[np.asarray(h) for h in history],
        health=health, flight=flights)


def column_tags_at(iters, switch_iters, it: int) -> np.ndarray:
    """Per-column tag at 0-based iteration ``it`` (0 for finished columns).

    Iterations ``[0, sw0)`` run at tag 1, ``[sw0, sw1)`` at tag 2,
    ``[sw1, iters)`` at tag 3; ``-1`` means the step never happened.
    """
    iters = _np(iters)
    sw = _np(switch_iters)
    nrhs = iters.shape[0]
    tags = np.zeros(nrhs, np.int64)
    for j in range(nrhs):
        if it >= iters[j]:
            continue  # column already converged: streams nothing
        t2 = sw[j, 0] if sw[j, 0] >= 0 else iters[j]
        t3 = sw[j, 1] if sw[j, 1] >= 0 else iters[j]
        tags[j] = 1 if it < t2 else (2 if it < t3 else 3)
    return tags


def batched_run_bytes(op, iters, switch_iters, precond=None) -> int:
    """Modeled HBM bytes a whole batched stepped run streams.

    Per iteration the matrix (and preconditioner) segments are charged
    once at the widest tag any active column runs, and every active column
    beyond the first charges its dense x/y stream
    (``iteration_stream_bytes(..., precond, nrhs=n_active)``).  Converged
    columns stream nothing.
    """
    iters = _np(iters)
    switch_iters = _np(switch_iters)
    total = 0
    for it in range(int(iters.max(initial=0))):
        tags = column_tags_at(iters, switch_iters, it)
        n_active = int((tags > 0).sum())
        if n_active == 0:
            continue
        total += iteration_stream_bytes(op, int(tags.max()), precond,
                                        nrhs=n_active)
    return total
