"""Batched multi-RHS stepped CG: per-column precision schedules over one
shared operand.

Port of ``repro/solvers/batched.py``: ``BatchedCGResult`` (:93),
``_normalize_block`` (:141), ``_batched_krylov_loop`` (:163),
``_solve_cg_batched_fused`` (:326), ``_solve_cg_batched`` (:354),
``solve_cg_batched`` (:383), ``column_tags_at`` (:706) and
``batched_run_bytes`` (:727) without a preconditioner.

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

Not yet ported (ROADMAP queue 1): ``solve_pcg_batched`` (item 6),
``solve_ir_batched`` (item 8), ``flight=`` (item 12), TagMap and
``"adaptive"`` tags (item 11), sharded operands (item 15) and the
preconditioner charge of ``batched_run_bytes`` (item 6).
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
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    HEALTH_OK,
    finalize_health,
    guard_init,
    guard_step,
)
from repro_torch.solvers.cg import CHUNK, _freeze, _record_switch
from repro_torch.sparse.csr import GSECSR, GSESellC, iteration_stream_bytes

__all__ = ["BatchedCGResult", "solve_cg_batched", "batched_run_bytes",
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


def _cg_update_cols(x, r, p, rr, ap, active, device):
    """``solvers.fused_cg.cg_update`` on ``(nrhs, n)`` blocks, column j
    bitwise the single-RHS step; returns ``(x', r', p', rr', denom)``."""
    denom = seq_dot_cols(p, ap, active, device=device)
    alpha = rr / torch.where(denom == 0, 1.0, denom)
    x2 = fma_axpy_cols(alpha, p, x, device=device)
    r2 = fma_axpy_cols(-alpha, ap, r, device=device)
    rr2 = seq_dot_cols(r2, r2, active, device=device)
    beta = rr2 / torch.where(rr == 0, 1.0, rr)
    p2 = fma_axpy_cols(beta, p, r2, device=device)
    return x2, r2, p2, rr2, denom


def _batched_krylov_loop(b, x0, tol, maxiter: int, params: P.MonitorParams,
                         init_tag: int, matvec: Callable,
                         guards: GuardParams | None, device):
    """The batched stepped CG loop over ``(nrhs, n)`` blocks ``b``/``x0``.

    ``matvec(v, tags, active)`` returns ``A v`` for the ``(nrhs, n)`` block
    ``v``, column j at the device tag ``tags[j]`` (rows of inactive
    columns are ignored).  Returns a :class:`BatchedCGResult`.
    """
    nrhs = b.shape[0]
    every = torch.ones(nrhs, dtype=torch.bool, device=b.device)
    bn = ref_norm_cols(b, device=device)
    bnorms = torch.where(bn == 0, 1.0, bn)

    def relres(rr):
        return sqrt_rn(torch.abs(rr)) / bnorms

    mons = [P.init(params, dtype=b.dtype, tag=init_tag, device=b.device)
            for _ in range(nrhs)]
    r0 = b - matvec(x0, torch.stack([m.tag for m in mons]), every)
    rr0 = seq_dot_cols(r0, r0, every, device=device)
    rel0 = relres(rr0)
    cols = []
    for j in range(nrhs):
        c = dict(mon=mons[j],
                 sw=torch.full((2,), -1, dtype=torch.int32, device=b.device))
        if guards is not None:
            c["g"] = guard_init(rel0[j])
        cols.append(c)
    state = dict(x=x0, r=r0, p=r0, rr=rr0,
                 it=torch.zeros(nrhs, dtype=torch.int32, device=b.device),
                 cols=cols)

    def col_active(s):
        alive = (relres(s["rr"]) > tol) & (s["it"] < maxiter)
        if guards is not None:
            health = torch.stack([c["g"]["health"] for c in s["cols"]])
            alive = alive & (health == HEALTH_OK)
        return alive

    def body(s, act):
        tags = torch.stack([c["mon"].tag for c in s["cols"]])
        ap = matvec(s["p"], tags, act)
        x, r, p, rr, denom = _cg_update_cols(s["x"], s["r"], s["p"], s["rr"],
                                             ap, act, device)
        rel = relres(rr)
        cols = []
        for j, c in enumerate(s["cols"]):
            it = s["it"][j]
            mon1 = P.record(c["mon"], rel[j])
            mon2 = P.update_tag(mon1, params)
            new = dict(mon=mon2, sw=_record_switch(c["sw"], mon1, mon2, it))
            if guards is not None:
                # After the update arithmetic, which is identical with
                # guards on or off.
                new["g"] = guard_step(c["g"], it, rel[j], guards,
                                      denom=denom[j])
            cols.append(_freeze(act[j], new, c))
        live = act[:, None]
        return dict(x=torch.where(live, x, s["x"]),
                    r=torch.where(live, r, s["r"]),
                    p=torch.where(live, p, s["p"]),
                    rr=torch.where(act, rr, s["rr"]),
                    it=torch.where(act, s["it"] + 1, s["it"]),
                    cols=cols)

    act = col_active(state)
    while bool(act.any()):  # the one host sync per chunk
        for _ in range(CHUNK):
            state = body(state, act)
            act = col_active(state)

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
    return BatchedCGResult(
        x=state["x"].t(),
        iters=state["it"],
        relres=rel,
        tag=torch.stack([c["mon"].tag for c in cols]),
        switch_iters=torch.stack([c["sw"] for c in cols]),
        converged=converged,
        health=health,
        trip_iter=trip_iter,
    )


def _solve_cg_batched_fused(a, b, x0, tol, maxiter, params, init_tag=1,
                            guards=None, device="cuda"):
    """Fused path: one C64 (``GSECSR``) or C′64 (``GSESellC``) launch per
    iteration serves every column."""

    def matvec(v, tags, active):
        if isinstance(a, GSESellC):
            return gse_spmm_sell_f64(*a.segments, a.table, v, tags, active,
                                     a.bucket_table, a.perm, a.row_len,
                                     rows=a.shape[0], ei_bit=a.ei_bit,
                                     long_from=a.long_from, device=device)
        return gse_spmm_csr_f64(a.rowptr, a.colpak, a.head, a.tail1, a.tail2,
                                a.table, v, tags, active, ei_bit=a.ei_bit,
                                plan=a.row_plan, device=device)

    return _batched_krylov_loop(b, x0, tol, maxiter, params, init_tag, matvec,
                                guards, device)


def _solve_cg_batched(apply_a: Callable, b, x0, tol, maxiter, params,
                      init_tag=1, guards=None, device="cuda"):
    """Generic path: ``apply_a(v, tag)`` on each column at its device tag.
    A frozen column's product is computed and discarded (the reference
    skips it behind ``lax.cond``; skipping here would need a sync)."""

    def matvec(v, tags, active):
        del active
        return torch.stack([apply_a(v[j], tags[j]) for j in range(v.shape[0])])

    return _batched_krylov_loop(b, x0, tol, maxiter, params, init_tag, matvec,
                                guards, device)


def _batched_init_tag(tags) -> int:
    """The int start tag of the batched ``tags=`` axis (``None`` -> 1)."""
    if tags is None:
        return 1
    if isinstance(tags, str):
        raise ValueError(
            "the batched solvers take an int tag or a TagMap; the "
            "'adaptive' schedule is single-RHS (repro.solvers.adaptive)")
    if isinstance(tags, bool) or not isinstance(tags, (int, np.integer)):
        raise NotImplementedError(
            f"tags= takes an int tag; {type(tags).__name__} (TagMap) is not "
            "ported yet (ROADMAP queue 1 item 11)")
    if int(tags) not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {int(tags)}")
    return int(tags)


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
    An int ``tags`` starts every column's monitor at that tag.  ``b`` and
    ``x0`` are ``(n,)`` or ``(n, nrhs)`` float64; the solution comes back
    ``(n, nrhs)``.
    """
    if flight is not None:
        raise NotImplementedError(
            "flight= is not ported yet (ROADMAP queue 1 item 12)")
    init_tag = _batched_init_tag(tags)
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
    if params is None:
        params = P.MonitorParams.for_cg()
    tol_ = torch.tensor(tol, dtype=b.dtype, device=b.device)
    solve = _solve_cg_batched_fused if fused else _solve_cg_batched
    return solve(apply_a, b.t().contiguous(), x0.t().contiguous(), tol_,
                 maxiter, params, init_tag=init_tag, guards=guards,
                 device=device)


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

    Per iteration the matrix segments are charged once at the widest tag
    any active column runs, and every active column beyond the first
    charges its dense x/y stream (``iteration_stream_bytes(...,
    nrhs=n_active)``).  Converged columns stream nothing.
    """
    if precond is not None:
        raise NotImplementedError(
            "the preconditioner charge is not ported yet (ROADMAP queue 1 "
            "item 6)")
    iters = _np(iters)
    switch_iters = _np(switch_iters)
    total = 0
    for it in range(int(iters.max(initial=0))):
        tags = column_tags_at(iters, switch_iters, it)
        n_active = int((tags > 0).sum())
        if n_active == 0:
            continue
        total += iteration_stream_bytes(op, int(tags.max()), nrhs=n_active)
    return total
