"""Chunked solver execution: bounded segments, bitwise trajectories.

Port of ``repro/serve/chunked.py``: ``SolveChunks`` (:74-185),
``BatchedChunks`` (:187-341) and ``IRChunks`` (:343-419).

The serving layer needs solves to be preemptible (deadline checks, fair
scheduling across requests), joinable (continuous batching) and
resumable (checkpoint and restore across faults).  All three reduce to
one primitive: run the solver loop for at most K more iterations and
hand back the raw loop state.  The loops take three hooks for it:

  * ``stop_at`` -- an extra iteration bound ANDed into the loop
    condition.  Conditions never touch the update arithmetic, so a
    chunked trajectory is bitwise the unchunked one by construction.
  * ``resume`` -- a previous chunk's loop state, carried verbatim
    (tensors on the operand's device; the init is skipped).
  * ``return_state`` -- return that raw state beside the result.

The drivers wrap those hooks per solver family:

  * :class:`SolveChunks` -- single-RHS CG/PCG, fused or generic
    (``solvers.cg``'s loop, kernel A64 on a ``GSECSR``).
  * :class:`BatchedChunks` -- the batched multi-RHS loop
    (``solvers.batched``, kernel C64 or C′64), plus ``join``/``drop``: a
    column added at a chunk boundary starts from the exact init a solo
    solve would run (the loop called with a bound of 0 on that column
    alone), and runs the exact per-column operations from there, so the
    columns already in flight are not perturbed.  The loop stacks its
    columns (``(nrhs, n)`` blocks and a per-column list); ``join`` and
    ``drop`` build the new state with ``batched.cat_cols``/``take_cols``,
    exactly the state the loop would hold on those columns.
  * :class:`IRChunks` -- iterative refinement a number of outer
    corrections at a time (``solvers.ir``'s ``_ir_*`` split: every line of
    per-correction arithmetic is ``solve_ir``'s).

Checkpoints: ``save_state``/``restore_state`` round-trip the loop state
through ``checkpoint.ckpt`` (CRC-stamped; a corrupt newest checkpoint
falls back to the previous good step, and the chunk in between re-runs,
which by the same contract reproduces the exact trajectory).  The drivers
run on their operand's device (a callable operand: ``b``'s).  Only the
single-device ``"exact"`` wire exists: a sharded operand or another wire
raises ``NotImplementedError`` (ROADMAP queue 1 item 15).
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint import ckpt as CK
from repro_torch.core import precision as P
from repro_torch.kernels.vec_f64 import seq_dot, sqrt_rn
from repro_torch.robustness.guards import (HEALTH_OK, GuardParams,
                                           finalize_health)
from repro_torch.solvers.batched import (
    _batched_tag_axis,
    _normalize_block,
    _solve_cg_batched,
    _solve_cg_batched_fused,
    _solve_pcg_batched,
    _solve_pcg_batched_fused,
    cat_cols,
    take_cols,
)
from repro_torch.solvers.cg import (
    _gsecsr_operator,
    _norm,
    _normalize_b_x0,
    _solve_cg,
    _solve_cg_fused,
    _solve_pcg,
    _solve_pcg_fused,
)
from repro_torch.solvers.ir import _ir_active, _ir_result, _ir_setup, _ir_step
from repro_torch.sparse.csr import GSECSR, GSESellC

__all__ = ["SolveChunks", "BatchedChunks", "IRChunks"]


def _check_operand(op, wire: str) -> bool:
    """Whether ``op`` is a packed operand (the fused paths); refuse the
    operands and wire formats not ported yet."""
    if wire != "exact":
        raise NotImplementedError(
            f"wire={wire!r}: the halo wire formats belong to the sharded "
            "path, not ported yet (ROADMAP queue 1 item 15)")
    fused = isinstance(op, (GSECSR, GSESellC))
    if not fused and not callable(op):
        raise NotImplementedError(
            f"the chunked drivers take a GSECSR, a GSESellC or a callable; "
            f"{type(op).__name__} operands (sharded) are not ported yet "
            "(ROADMAP queue 1 item 15)")
    return fused


class SolveChunks:
    """Single-RHS CG/PCG driven K iterations at a time.

    ``run_chunk(k)`` advances the solve by at most ``k`` iterations and
    returns the current ``CGResult`` snapshot; ``done`` is True when the
    unchunked loop would have exited (converged, budget exhausted, or a
    guard tripped).  The concatenation of chunks is bitwise one unchunked
    call with the same arguments (no recovery ladder: a tripped solve
    stops, as the reference's driver does).
    """

    def __init__(self, op, b, tol: float, maxiter: int,
                 params: P.MonitorParams,
                 guards: GuardParams | None = None,
                 x0=None, precond=None, wire: str = "exact",
                 init_tag: int = 1):
        fused = _check_operand(op, wire)
        self.b, x0, _ = _normalize_b_x0(b, x0, op.device if fused else None)
        self.device = self.b.device
        self.x0 = torch.zeros_like(self.b) if x0 is None else x0
        self.tol = torch.tensor(tol, dtype=self.b.dtype, device=self.device)
        self.maxiter = maxiter
        self.params = params
        self.guards = guards
        self.init_tag = init_tag
        args = (self.b, self.x0, self.tol, maxiter, params)
        kw0 = dict(init_tag=init_tag, guards=guards)
        if precond is None:
            entry = _solve_cg_fused if fused else _solve_cg
            self._call = lambda **kw: entry(op, *args, **kw0, **kw)
        elif fused and hasattr(precond, "apply_at"):
            self._call = lambda **kw: _solve_pcg_fused(op, precond, *args,
                                                       **kw0, **kw)
        else:
            apply_m = precond if callable(precond) else precond.apply
            apply_a = _gsecsr_operator(op) if fused else op
            self._call = lambda **kw: _solve_pcg(apply_a, apply_m, *args,
                                                 **kw0, **kw)
        self._state = None
        self.res = None
        self.ckpt = None
        self.chunks = 0

    def run_chunk(self, k: int):
        """Advance at most ``k`` iterations; returns the CGResult so far."""
        if self._state is None:
            res, ckpt, st = self._call(stop_at=int(k), return_state=True)
        else:
            res, ckpt, st = self._call(resume=self._state,
                                       stop_at=self.iters + int(k),
                                       return_state=True)
        self._state, self.res, self.ckpt = st, res, ckpt
        self.chunks += 1
        return res

    @property
    def iters(self) -> int:
        return 0 if self._state is None else int(self._state["it"])

    @property
    def done(self) -> bool:
        """True when the unchunked loop condition is false: another chunk
        would run no iteration."""
        if self.res is None:
            return False
        if bool(self.res.converged) or self.iters >= self.maxiter:
            return True
        if self.guards is not None and \
                int(self._state["g"]["health"]) != HEALTH_OK:
            return True
        return False

    # -- checkpoint and resume ----------------------------------------------

    def init_state(self):
        """An initialized loop state without iterating (``stop_at=0``):
        the template a restore fills."""
        return self._call(stop_at=0, return_state=True)[2]

    def save_state(self, path: str) -> str:
        """CRC-stamped checkpoint of the current loop state (one per chunk
        boundary; step = chunk index)."""
        if self._state is None:
            raise RuntimeError("no chunk has run yet; nothing to save")
        return CK.save(path, self._state, step=self.chunks,
                       extra={"iters": self.iters})

    def restore_state(self, path: str) -> list:
        """Resume from the newest valid checkpoint under ``path``, its
        tensors placed on the operand's device.

        Corrupt checkpoints are skipped and the previous good one is used:
        the skipped chunk re-runs from there, reproducing the exact
        trajectory.  Returns the corrupt steps passed over; raises
        ``FileNotFoundError`` when no valid checkpoint exists.
        """
        got = CK.restore_latest_valid(path, self.init_state(),
                                      device=self.device)
        if got is None:
            raise FileNotFoundError(f"no valid checkpoint under {path}")
        st, step, _, skipped = got
        self._state = st
        self.chunks = step
        return skipped


class BatchedChunks:
    """The batched multi-RHS loop driven K iterations at a time, with
    continuous batching: ``join`` adds a column at a chunk boundary (its
    init is exactly a solo solve's init, so its trajectory is a solo solve
    started then), ``drop`` removes one (the other columns' states are
    untouched).

    The bound is per column (columns join at different chunk counts, so
    each advances from its own iteration count).  ``b`` is ``(n,)`` or
    ``(n, nrhs)``; the state holds it as ``(nrhs, n)``.
    """

    def __init__(self, op, b, tol: float, maxiter: int,
                 params: P.MonitorParams,
                 guards: GuardParams | None = None,
                 x0=None, precond=None, wire: str = "exact",
                 init_tag: int = 1, tags=None):
        fused = _check_operand(op, wire)
        b, x0 = _normalize_block(b, x0, op.device if fused else None)
        if b.dtype != torch.float64:
            raise TypeError(f"b must be float64, got {b.dtype}")
        if tags is not None:
            # The batched precision axis resolves before chunking as in
            # solve_cg_batched: an int or uniform map overrides init_tag,
            # a non-uniform map swaps in the masked operand and pins the
            # monitor, so the chunked run is the unchunked tags= run.
            init_tag, op, params = _batched_tag_axis(
                tags, op, int(b.shape[0]), params)
            fused = isinstance(op, (GSECSR, GSESellC))
        self.device = b.device
        self.tol = torch.tensor(tol, dtype=b.dtype, device=self.device)
        self.maxiter = maxiter
        self.params = params
        self.guards = guards
        self.init_tag = init_tag
        kw0 = dict(init_tag=init_tag, guards=guards, device=self.device)
        if precond is None:
            entry = _solve_cg_batched_fused if fused else _solve_cg_batched
            self._call = lambda b_, x0_, **kw: entry(
                op, b_, x0_, self.tol, maxiter, params, **kw0, **kw)
        elif fused and hasattr(precond, "apply_cols"):
            self._call = lambda b_, x0_, **kw: _solve_pcg_batched_fused(
                op, precond, b_, x0_, self.tol, maxiter, params, **kw0, **kw)
        else:
            apply_m = precond if callable(precond) else precond.apply
            apply_a = _gsecsr_operator(op) if fused else op
            self._call = lambda b_, x0_, **kw: _solve_pcg_batched(
                apply_a, apply_m, b_, x0_, self.tol, maxiter, params, **kw0,
                **kw)
        # Every column initialized WITHOUT iterating (a bound of 0 each):
        # the call join makes, so first-wave and joined columns get the
        # same init.
        self.b = b.t().contiguous()  # (nrhs, n): a contiguous row a column
        self.res, self.state = self._call(
            self.b, x0.t().contiguous(), stop_at=[0] * self.b.shape[0],
            return_state=True)
        self._bn = self._bnorms(self.b)
        self._host = None
        self.chunks = 0

    @staticmethod
    def _bnorms(rows) -> torch.Tensor:
        """``||b_j||`` per column (``cg._norm``, the reference's norm bit
        for bit), 0 replaced by 1."""
        bn = torch.stack([_norm(v) for v in rows])
        return torch.where(bn == 0, 1.0, bn)

    @property
    def nrhs(self) -> int:
        return int(self.b.shape[0])

    def _summary(self) -> list:
        """``[relres, it, health]`` of every column on the host: one copy
        a boundary, shared by ``col_done`` and ``run_chunk``."""
        if self._host is None:
            s = self.state
            rows = [sqrt_rn(torch.abs(s["rr"])) / self._bn,
                    s["it"].to(torch.float64)]
            if self.guards is not None:
                rows.append(torch.stack(
                    [c["g"]["health"] for c in s["cols"]]).to(torch.float64))
            self._host = torch.stack(rows).tolist()
        return self._host

    def run_chunk(self, k: int):
        """Advance every column by at most ``k`` iterations (from each
        column's own count); returns the BatchedCGResult snapshot."""
        its = self._summary()[1]
        # x0 is unused under resume (the init is skipped).
        self.res, self.state = self._call(
            self.b, self.b, resume=self.state,
            stop_at=[int(i) + int(k) for i in its], return_state=True)
        self._host = None
        self.chunks += 1
        return self.res

    def join(self, b_new, x0=None) -> int:
        """Add one column at the current chunk boundary; returns its index.
        The column's state is the exact solo-solve init (one operator
        application at ``init_tag``), so from here on it runs the same
        operations as a solve submitted alone."""
        b1, x01 = _normalize_block(b_new, x0, self.device)
        b1 = b1.t().contiguous()
        _, st1 = self._call(b1, x01.t().contiguous(), stop_at=[0],
                            return_state=True)
        self.state = cat_cols(self.state, st1)
        self.b = torch.cat([self.b, b1])
        self._bn = torch.cat([self._bn, self._bnorms(b1)])
        self._host = None
        return self.nrhs - 1

    def drop(self, j: int) -> dict:
        """Remove column ``j`` (finished or expired), returning its final
        snapshot.  The other columns' states are untouched."""
        snap = self.col_snapshot(j)
        keep = [i for i in range(self.nrhs) if i != j]
        self.state = take_cols(self.state, keep)
        self.b = self.b[keep]
        self._bn = self._bn[keep]
        self._host = None
        return snap

    def col_snapshot(self, j: int) -> dict:
        """One column's current report fields and its last-healthy x
        (``ckpt``: the batched loop keeps none, so the current x, which
        is what a deadline expiry returns).

        Health comes from the column's own guard state, finalized as the
        batched result does, not from the cached batch result, which goes
        stale across joins and drops.
        """
        s = self.state
        c = s["cols"][j]
        x = s["x"][j].clone()  # not a view pinning the whole block
        rel = sqrt_rn(torch.abs(s["rr"][j])) / self._bn[j]
        relres = float(rel)
        finite = bool(torch.isfinite(seq_dot(x, x)))
        converged = relres <= float(self.tol) and finite
        g = c.get("g")
        h, t = finalize_health(
            g, torch.tensor(converged, device=self.device), rel,
            x_finite=finite)
        return dict(
            x=x,
            ckpt=c.get("ckpt", x),
            iters=int(s["it"][j]),
            relres=relres,
            tag=int(c["mon"].tag),
            switch_iters=c["sw"].cpu().numpy(),
            converged=converged,
            health=int(h),
            # The raw in-loop guard health: a column still iterating is
            # ok here though finalize_health would call it "stalled" (a
            # deadline expiry must not pass for a guard trip).
            guard_health=int(g["health"]) if g is not None else 0,
            trip_iter=int(t),
        )

    def col_done(self, j: int) -> bool:
        """Column ``j`` would run no further iteration."""
        row = [v[j] for v in self._summary()]
        if row[0] <= float(self.tol) or row[1] >= self.maxiter:
            return True
        return self.guards is not None and int(row[2]) != HEALTH_OK

    @property
    def done(self) -> bool:
        return all(self.col_done(j) for j in range(self.nrhs))


class IRChunks:
    """Iterative refinement driven K outer corrections at a time.

    Chunk boundaries fall between corrections, the natural restart point
    (each correction restarts the inner monitor anyway), so chunked IR
    shares every line of per-correction arithmetic with ``solve_ir`` and
    is bitwise it.
    """

    def __init__(self, op, b, tol: float = 1e-10, max_outer: int = 10,
                 inner: str = "cg", inner_tol: float = 1e-4,
                 inner_maxiter: int = 2000,
                 params: P.MonitorParams | None = None,
                 precond=None, restart: int = 30, wire: str = "exact",
                 guards: GuardParams | None = None, flight=None):
        _check_operand(op, wire)
        self.st = _ir_setup(op, b, tol=tol, max_outer=max_outer,
                            inner=inner, inner_tol=inner_tol,
                            inner_maxiter=inner_maxiter, params=params,
                            precond=precond, restart=restart, guards=guards,
                            flight=flight)
        self.chunks = 0

    def run_chunk(self, k: int):
        """Run at most ``k`` outer corrections; returns the IRResult so far
        (its ``converged``/``health`` reflect the current state)."""
        for _ in range(int(k)):
            if not _ir_active(self.st):
                break
            _ir_step(self.st)
        self.chunks += 1
        return _ir_result(self.st)

    @property
    def done(self) -> bool:
        return not _ir_active(self.st)

    @property
    def outer_iters(self) -> int:
        return self.st["outer"]

    def result(self):
        return _ir_result(self.st)

    # -- checkpoint and resume ----------------------------------------------

    # The IR state lives on the host (closures and scalars), so checkpoints
    # carry the tensors explicitly and the scalars in ``extra``.

    def save_state(self, path: str) -> str:
        st = self.st
        return CK.save(path, {"x": st["x"], "r": st["r"]}, step=self.chunks,
                       extra={
                           "outer": st["outer"],
                           "total_inner": st["total_inner"],
                           "relres": st["relres"],
                           "history": [float(h) for h in st["history"]],
                           "inner_health": st["inner_health"],
                           "stopped": st["stopped"],
                       })

    def restore_state(self, path: str) -> list:
        like = {"x": self.st["x"], "r": self.st["r"]}
        got = CK.restore_latest_valid(path, like, device=self.st["x"].device)
        if got is None:
            raise FileNotFoundError(f"no valid checkpoint under {path}")
        tree, step, extra, skipped = got
        self.st["x"] = tree["x"]
        self.st["r"] = tree["r"]
        self.st["outer"] = int(extra["outer"])
        self.st["total_inner"] = int(extra["total_inner"])
        self.st["relres"] = float(extra["relres"])
        self.st["history"] = [float(h) for h in extra["history"]]
        self.st["inner_health"] = int(extra["inner_health"])
        self.st["stopped"] = bool(extra["stopped"])
        self.chunks = step
        return skipped
