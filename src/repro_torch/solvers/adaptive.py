"""Adaptive per-group precision driver (``tags="adaptive"``).

Port of ``repro/solvers/adaptive.py``: ``Promotion``, ``AdaptiveResult``,
``_init_map``, ``_inv_diag``, ``_probe_jacobi``, ``_trim``,
``_abs_neumann_profile`` and ``solve_adaptive``.

The stepped monitor promotes the whole operator when convergence stalls;
this driver plans and keeps a per-group ``TagMap`` so only the row groups
that limit the attainable residual stream tail segments.  A tag-``t``
solve plateaus at a true residual ``||(A~_t - A) x*|| / ||b||``; the
planner (``core.precision.decode_error_scores``/``plan_tagmap``) bounds
each group's share of it column-wise and promotes the largest shares
until the modeled floor fits ``theta * tol * ||b||``.  Three profiles
give the solution-magnitude estimate it plans from: ``"explore"`` runs
uniform tag 1 and plans once from the live iterate when its recursive
residual first crosses ``beta * tol``; ``"neumann"`` plans up front from
a one-hop absolute Neumann series; ``"probe"`` from a billed
Jacobi-preconditioned tag-1 probe.  Every ``chunk`` iterations the host
measures the true tag-3 residual (billed), which is the stop test; a
recurrence that exhausts while the true residual misses ``tol`` replans
from the current iterate and restarts.

The segments run through ``solvers.cg``'s loop with its ``resume``,
``stop_at`` and ``return_state`` hooks, over the masked operand
(``kernels.ops.masked_for_tagmap``) at the map's max tag: kernel A64
over zeroed tails, bitwise the reference's masked decode.  The planner is
host numpy in the reference's order, the true residual and ``||b||`` the
reference's norm bit for bit (``cg._norm``), so ``iters``, the map, the
promotions, ``spmv_bytes`` and ``x`` are the reference's.  The planning
and the segments run inside the ``solve.adaptive`` span (``obs.trace``);
the result carries no flight recording, as the reference's does not.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import precision as P
from repro_torch.core.tagmap import GROUP_SIZE, TagMap, normalize_tags
from repro_torch.obs import trace as OT
from repro_torch.sparse.csr import GSECSR

__all__ = ["AdaptiveResult", "Promotion", "solve_adaptive"]


class Promotion(NamedTuple):
    """One promotion event in an adaptive solve."""

    it: int          # global iteration the promotion took effect at
    n_promoted: int  # groups whose tag changed
    min_tag: int     # new map's min tag
    max_tag: int     # new map's max tag
    crc32: int       # new map's cache-key token


class AdaptiveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: float        # final recursive relative residual
    true_relres: float   # final true tag-3 residual of the unmasked operand
    converged: bool      # true_relres <= tol
    tagmap: TagMap       # final per-group map
    promotions: tuple    # Promotion events, in order (it=0: an upfront plan)
    spmv_bytes: int      # blended matrix-stream bytes, whole solve
    chunks: int          # host chunks executed
    probe_iters: int = 0  # tag-1 probe iterations billed into spmv_bytes

    @property
    def tag(self) -> int:
        """The max active tag (``CGResult.tag``'s counterpart)."""
        return self.tagmap.max_tag


def _init_map(tags0, m: int, group_size: int) -> TagMap:
    """Seed map from the caller's ``tags0`` (int floor or map)."""
    norm = normalize_tags(tags0, m)
    if isinstance(norm, int):
        return TagMap.for_rows(m, norm, group_size)
    return norm


def _diag_mask(a: GSECSR):
    """``(rows, cols, rows == cols)`` of the entries, on the host."""
    rows = a.on_host().row_ids.numpy().astype(np.int64)
    cols = P.host_cols(a)
    return rows, cols, rows == cols


def _inv_diag(a: GSECSR) -> np.ndarray:
    """Inverse absolute diagonal from the packed tag-3 decode, on the
    host."""
    rows, _, dmask = _diag_mask(a)
    v3 = P.host_decode(a, 3)
    diag = np.zeros(int(a.shape[0]), np.float64)
    diag[rows[dmask]] = np.abs(v3[dmask])
    return np.where(diag > 0,
                    1.0 / np.maximum(diag, np.finfo(np.float64).tiny), 1.0)


def _probe_jacobi(a: GSECSR):
    """Diagonal preconditioner ``apply_m(r, tag)`` of the optional tag-1
    planning probe."""
    inv_j = torch.from_numpy(_inv_diag(a)).to(a.device)

    def apply_m(r, tag):
        return r * inv_j.to(r.dtype)

    return apply_m


def _trim(xh: np.ndarray, rel: float) -> np.ndarray:
    """Zero the components of a solution-profile estimate below its own
    error scale ``rel * rms(x)``: a CG iterate with true relative residual
    ``rel`` cannot tell them from zero."""
    if not np.isfinite(rel) or xh.size == 0:
        return xh
    rms = float(np.linalg.norm(xh)) / np.sqrt(xh.size)
    return np.where(xh > min(rel, 1.0) * rms, xh, 0.0)


def _abs_neumann_profile(a: GSECSR, b: np.ndarray, hops: int = 1) -> np.ndarray:
    """Solution-magnitude seed profile: the truncated absolute Neumann
    series ``sum_k (D^{-1}|offdiag|)^k D^{-1}|b|`` from the packed tag-3
    decode, on the host (no solve)."""
    rows, cols, dmask = _diag_mask(a)
    v3 = np.abs(P.host_decode(a, 3))
    m = int(a.shape[0])
    d = np.zeros(m, np.float64)
    d[rows[dmask]] = v3[dmask]
    d = np.where(d > 0, d, 1.0)
    x = np.abs(np.asarray(b, np.float64)).reshape(-1) / d
    acc = x.copy()
    off = np.where(dmask, 0.0, v3)
    for _ in range(hops):
        y = np.zeros(m, np.float64)
        np.add.at(y, rows, off * x[cols])
        x = y / d
        acc += x
    return acc


class _Stages:
    """``with stages(name):`` adds the wall seconds of the block to
    ``timings[name]``, the device synchronized at both ends; nothing when
    ``timings`` is ``None``."""

    def __init__(self, timings, device):
        self.timings, self.device, self.name = timings, device, None

    def __call__(self, name):
        self.name = name
        return self

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if self.timings is not None:
            self._sync()
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timings is not None:
            self._sync()
            self.timings[self.name] = (self.timings.get(self.name, 0.0)
                                       + time.perf_counter() - self.t0)
        return False


def solve_adaptive(
    a: GSECSR,
    b,
    precond=None,
    x0=None,
    tol: float = 1e-6,
    maxiter: int = 5000,
    params: P.MonitorParams | None = None,
    chunk: int | None = None,
    promote_frac: float = 0.1,
    tags0=None,
    group_size: int = GROUP_SIZE,
    profile: str = "explore",
    probe_iters: int = 0,
    theta: float = 0.25,
    beta: float = 2.0,
    timings: dict | None = None,
) -> AdaptiveResult:
    """Data-driven per-group precision CG/PCG on ``a``'s device.

    ``a`` must be a packed ``GSECSR`` (the floor model reads its flat
    segments).  ``precond`` selects PCG for the main solve: a
    ``solvers.precond`` object (fused path) or a callable ``apply_m(r,
    tag)``; the planning probe uses its own Jacobi.  ``profile`` is
    ``"explore"`` (default), ``"neumann"`` or ``"probe"`` (with
    ``probe_iters``); ``theta`` is the planner's headroom, ``beta`` the
    explore plan's trigger (``relres <= beta * tol``), ``tags0`` (a map or
    an int) seeds the map and skips profiling, ``chunk`` is the
    true-residual cadence in iterations (default ``min(params.m, 100,
    maxiter)``) and ``promote_frac`` the share of groups a forced replan
    promotes when its model already fits the budget.

    ``timings`` (a dict) receives the wall seconds of each stage, the
    device synchronized at its ends: ``"plan"`` (profiles, scores and
    plans), ``"mask"`` (the masked operands), ``"solve"`` (the chunks) and
    ``"true_residual"`` (the tag-3 checks).  The solve is the same either
    way.
    """
    from repro_torch.kernels.ops import masked_for_tagmap
    from repro_torch.solvers.cg import (_gsecsr_operator, _norm,
                                        _normalize_b_x0, _pin_params,
                                        _solve_cg_fused, _solve_pcg,
                                        _solve_pcg_fused)
    from repro_torch.solvers.fused_cg import gse_matvec

    if not isinstance(a, GSECSR):
        raise TypeError(
            "solve_adaptive needs a packed GSECSR operand (the floor "
            f"model reads its flat segments); got {type(a).__name__}")
    if profile not in ("explore", "neumann", "probe"):
        raise ValueError(f"unknown profile {profile!r}")
    b, x0, orig_shape = _normalize_b_x0(b, x0, a.device)
    x = torch.zeros_like(b) if x0 is None else x0
    if params is None:
        params = P.MonitorParams.for_cg()
    if chunk is None:
        # One tag-3 check costs about two iterations of the cheapest
        # stream; a cadence of 100 keeps it under ~2%.
        chunk = max(1, min(params.m, 100, maxiter))
    m = int(a.shape[0])
    # Each segment's recursive target: the quadrature complement of the
    # planned floor budget, so recurrence plus floor lands inside tol.
    seg_tol = tol * float(np.sqrt(max(1.0 - theta * theta, 0.25)))
    seg_tol_t = torch.tensor(seg_tol, dtype=b.dtype, device=b.device)
    bnorm = float(_norm(b))
    bnorm = 1.0 if bnorm == 0 else bnorm
    tag3 = torch.full((), 3, dtype=torch.int32, device=b.device)
    promotions: list[Promotion] = []
    bytes_ = 0
    probe_done = 0
    stage = _Stages(timings, a.device)

    def plan(xh, tags0=None):
        with stage("plan"):
            return P.plan_tagmap(P.decode_error_scores(a, xh, group_size),
                                 theta * tol * bnorm, tags0=tags0,
                                 group_size=group_size)

    def upfront(tm):
        promotions.append(Promotion(0, int((tm.tags > 1).sum()), tm.min_tag,
                                    tm.max_tag, tm.crc32))

    with OT.span("solve.adaptive", n=m, tol=float(tol), chunk=int(chunk)):
        planned = True  # an upfront plan or a seed disables the beta plan
        if tags0 is not None:
            tm = _init_map(tags0, m, group_size)
        elif profile == "neumann":
            with stage("plan"):
                xh = _abs_neumann_profile(a, b.cpu().numpy())
            tm = plan(xh)
            upfront(tm)
        elif profile == "probe":
            with stage("solve"):
                pr, _ = _solve_pcg(_gsecsr_operator(a), _probe_jacobi(a), b, x,
                                   torch.tensor(0.0, dtype=b.dtype,
                                                device=b.device),
                                   max(int(probe_iters), 1),
                                   _pin_params(params, 1), init_tag=1,
                                   guards=None)
            probe_done = int(pr.iters)
            bytes_ += (probe_done + 1) * a.bytes_touched(1)
            xh = np.abs(pr.x.cpu().numpy())
            if not np.isfinite(xh).all() or xh.max() == 0:
                xh = np.abs(b.cpu().numpy())
            else:
                xh = _trim(xh, float(pr.relres))
            tm = plan(xh)
            upfront(tm)
        else:
            tm = TagMap.for_rows(m, 1, group_size)
            planned = False

        hooks = dict(guards=None, return_state=True)
        if precond is None:
            def run_chunk(a_eff, x_start, state, stop, pinned, itag):
                return _solve_cg_fused(a_eff, b, x_start, seg_tol_t, maxiter,
                                       pinned, init_tag=itag, resume=state,
                                       stop_at=stop, **hooks)
        elif hasattr(precond, "apply_at"):
            def run_chunk(a_eff, x_start, state, stop, pinned, itag):
                return _solve_pcg_fused(a_eff, precond, b, x_start, seg_tol_t,
                                        maxiter, pinned, init_tag=itag,
                                        resume=state, stop_at=stop, **hooks)
        else:
            apply_m = precond if callable(precond) else precond.apply

            def run_chunk(a_eff, x_start, state, stop, pinned, itag):
                return _solve_pcg(_gsecsr_operator(a_eff), apply_m, b, x_start,
                                  seg_tol_t, maxiter, pinned, init_tag=itag,
                                  resume=state, stop_at=stop, **hooks)

        def true_relres(xv) -> float:
            with stage("true_residual"):
                return float(_norm(b - gse_matvec(a, xv, tag3)) / bnorm)

        def replan(tm, xv, rel, glob, force):
            """(Re)plan from the live iterate; ``force`` (the recurrence
            exhausted) escalates the worst open contributors even when the
            model says the map already fits."""
            with stage("plan"):
                sc = P.decode_error_scores(
                    a, _trim(np.abs(xv.cpu().numpy()), rel), group_size)
                tm2 = P.plan_tagmap(sc, theta * tol * bnorm, tags0=tm,
                                    group_size=group_size)
                if force and tm2 == tm:
                    tm2 = P.promote_groups(
                        tm, P.map_floor_contrib(sc, tm.tags),
                        frac=promote_frac)
            if tm2 != tm:
                promotions.append(Promotion(
                    glob, int((tm2.tags != tm.tags).sum()), tm2.min_tag,
                    tm2.max_tag, tm2.crc32))
            return tm2

        # ``res.iters`` counts from the start of the current segment (a
        # restart re-enters the init); ``seg_off`` holds the earlier segments,
        # so every reported and billed iteration is global.  Every chunk
        # boundary measures the true tag-3 residual (billed): the stop test,
        # the explore plan's trigger and the final verify.
        state = None
        seg_off = 0
        seg_it = 0
        chunks = 0
        exhausted = False
        demoted = False
        res = None
        tr = np.inf

        a_eff = a_tm = None
        while True:
            if a_tm is not tm:  # a new map: its masked operand (cached by crc)
                with stage("mask"):
                    a_eff, a_tm = masked_for_tagmap(a, tm), tm
            pinned = _pin_params(params, tm.max_tag)
            if state is None:
                bytes_ += a.bytes_touched(tm)  # fresh initial residual SpMV
            stop = min(seg_it + chunk, max(maxiter - seg_off, 1))
            with stage("solve"):
                res, _, state = run_chunk(a_eff, x, state, stop, pinned,
                                          tm.max_tag)
            chunks += 1
            new_seg_it = int(res.iters)
            bytes_ += (new_seg_it - seg_it) * a.bytes_touched(tm)
            glob = seg_off + new_seg_it
            relres = float(res.relres)
            tr = true_relres(res.x)
            bytes_ += a.bytes_touched(3)

            if tr <= tol or glob >= maxiter:
                break

            rec_done = np.isfinite(relres) and relres <= seg_tol
            plan_now = (not planned and np.isfinite(relres)
                        and relres <= beta * tol)

            if (planned and not demoted and not rec_done
                    and np.isfinite(relres) and tr > 3.0 * tol):
                # Demote pass (one adoption at most): an upfront plan came
                # from an approximate profile and may over-promote; re-plan
                # from the sharper live iterate and adopt a strictly cheaper
                # map.
                tmf = plan(_trim(np.abs(res.x.cpu().numpy()), tr))
                if (tmf != tm
                        and a.bytes_touched(tmf) < 0.93 * a.bytes_touched(tm)):
                    demoted = True
                    promotions.append(Promotion(
                        glob, int((tmf.tags != tm.tags).sum()),
                        tmf.min_tag, tmf.max_tag, tmf.crc32))
                    tm = tmf
                    x = res.x
                    state = None
                    seg_off = glob
                    seg_it = 0
                    continue

            if rec_done or plan_now or not np.isfinite(relres):
                tm2 = replan(tm, res.x, tr, glob, force=rec_done)
                planned = True
                if tm2 == tm:
                    if rec_done:
                        if exhausted:
                            break  # fully promoted and restarted once
                        exhausted = tm.min_tag == 3
                    else:
                        # The explore plan kept the uniform map: no operand
                        # change, the recurrence keeps running.
                        seg_it = new_seg_it
                        continue
                tm = tm2
                x = res.x
                state = None
                seg_off = glob
                seg_it = 0
                continue

            seg_it = new_seg_it

        res_x = res.x.reshape(orig_shape)
        return AdaptiveResult(
            x=res_x,
            iters=seg_off + int(res.iters),
            relres=float(res.relres),
            true_relres=float(tr) if np.isfinite(tr) else true_relres(res.x),
            converged=bool(np.isfinite(tr) and tr <= tol),
            tagmap=tm,
            promotions=tuple(promotions),
            spmv_bytes=int(bytes_),
            chunks=chunks,
            probe_iters=probe_done,
        )
