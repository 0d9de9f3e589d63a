"""Stepped mixed-precision controller (paper Section III.D, Eq. 3-6).

Port of ``repro/core/precision.py`` :43-160: ``MonitorParams`` (with
``for_cg``/``for_gmres``), ``MonitorState``, ``init``, ``record``,
``metrics`` and ``update_tag``; and the per-group planner of :165-298:
``group_sensitivity``, ``decode_error_scores``, ``map_floor_contrib``,
``plan_tagmap`` and ``promote_groups``.  The planner is host numpy with
the reference's ``np.maximum.at``/``np.add.at`` in its order: it takes an
argmax over float sums, so the scores must be bitwise the reference's or
the map differs.  It reads the pack's flat segments on the host
(``GSECSR.on_host``, copied once) and their f32 decodes at tags 1-3
(``kernels.ref.decode_csr_ref``, bitwise the reference's), kept on the
pack.

The state is a fixed-size ring buffer of recent residuals plus counters,
all tensors on the solve's device: every function here is branch-free
tensor arithmetic, so the stepped solver loop updates the tag on the
device without a host sync.

Metrics over the trailing window of ``t`` residuals:

  RSD     relative standard deviation of the window
  nDec    number of strict decreases resid[i] > resid[i+1]
  relDec  (resid[j-t] - resid[j-1]) / resid[j-t]

Switch-up conditions (any one fires => precision tag += 1):

  C1:  RSD > rsd_limit  and  nDec < ndec_limit
  C2:  nDec >= ndec_limit and relDec < reldec_limit
  C3:  nDec == 0
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.tagmap import GROUP_SIZE, TagMap
from repro_torch.kernels.vec_f64 import sqrt_rn
from repro_torch.sparse.csr import _map_cached

__all__ = ["MonitorParams", "MonitorState", "init", "record", "metrics",
           "update_tag", "group_sensitivity", "decode_error_scores",
           "map_floor_contrib", "plan_tagmap", "promote_groups"]


@dataclasses.dataclass(frozen=True)
class MonitorParams:
    """Static controller parameters (paper Section IV.D.1)."""

    t: int = 250              # trailing window length
    l: int = 3000             # iterations before first possible switch
    m: int = 500              # check cadence
    rsd_limit: float = 0.50
    reldec_limit: float = 0.45
    ndec_limit: int | None = None  # default: t // 2
    max_tag: int = 3

    @property
    def ndec(self) -> int:
        return self.t // 2 if self.ndec_limit is None else self.ndec_limit

    @classmethod
    def for_gmres(cls) -> "MonitorParams":
        return cls(t=300, l=9000, m=1500, rsd_limit=0.03, reldec_limit=0.08,
                   ndec_limit=80)

    @classmethod
    def for_cg(cls) -> "MonitorParams":
        return cls(t=250, l=3000, m=500, rsd_limit=0.50, reldec_limit=0.45,
                   ndec_limit=130)


@dataclasses.dataclass
class MonitorState:
    hist: torch.Tensor   # (t,) ring buffer of residuals
    count: torch.Tensor  # () int32 residuals recorded so far
    tag: torch.Tensor    # () int32 current precision tag (1..3)


def init(params: MonitorParams, dtype=torch.float64, tag: int = 1,
         device="cuda") -> MonitorState:
    return MonitorState(
        hist=torch.full((params.t,), float("inf"), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
        tag=torch.full((), tag, dtype=torch.int32, device=device),
    )


def record(state: MonitorState, resid: torch.Tensor) -> MonitorState:
    """Push one residual into the ring buffer.

    Non-finite residuals are clamped to ``finfo.max ** 0.25`` before
    entering the window: a NaN would otherwise make every metric NaN and
    silently disable switching, and the sentinel is small enough that the
    window mean and squared deviations cannot overflow.
    """
    t = state.hist.shape[0]
    idx = state.count % t
    r = resid.to(state.hist.dtype)
    big = torch.finfo(state.hist.dtype).max ** 0.25
    r = torch.where(torch.isfinite(r), r, big)
    slot = torch.arange(t, device=state.hist.device) == idx
    return MonitorState(
        hist=torch.where(slot, r, state.hist),
        count=state.count + 1,
        tag=state.tag,
    )


def _ordered(state: MonitorState) -> torch.Tensor:
    """Window ordered oldest -> newest (resid[j-t] ... resid[j-1])."""
    t = state.hist.shape[0]
    idx = (torch.arange(t, device=state.hist.device) + state.count % t) % t
    return state.hist[idx]


def metrics(state: MonitorState) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(RSD, nDec, relDec) over the trailing window (paper Eq. 3-6)."""
    w = _ordered(state)
    t = w.shape[0]
    avg = torch.sum(w) / t
    dev = w - avg
    rsd = sqrt_rn(torch.sum(dev * dev) / t) / torch.clamp(
        avg, min=torch.finfo(w.dtype).tiny
    )
    ndec = torch.sum((w[:-1] > w[1:]).to(torch.int32))
    reldec = (w[0] - w[-1]) / torch.where(w[0] == 0, 1.0, w[0])
    return rsd, ndec, reldec


def update_tag(state: MonitorState, params: MonitorParams) -> MonitorState:
    """Evaluate the switch conditions; returns state with (possibly) tag+1.

    Only acts when the window is full, ``count >= l`` and
    ``count % m == 0`` -- safe to call every iteration.
    """
    t = state.hist.shape[0]
    due = (
        (state.count >= params.l)
        & (state.count >= t)
        & (state.count % params.m == 0)
        & (state.tag < params.max_tag)
    )
    rsd, ndec, reldec = metrics(state)
    c1 = (rsd > params.rsd_limit) & (ndec < params.ndec)
    c2 = (ndec >= params.ndec) & (reldec < params.reldec_limit)
    c3 = ndec == 0
    step = due & (c1 | c2 | c3)
    new_tag = torch.where(step, state.tag + 1, state.tag)
    return MonitorState(hist=state.hist, count=state.count, tag=new_tag)


# -- per-group sensitivity and promotion ------------------------------------

def host_cols(g) -> np.ndarray:
    """The column of every entry of the ``GSECSR`` ``g``, int64 on the
    host, kept on the pack."""
    return _map_cached(g, ("host_cols",), lambda: (
        g.on_host().colpak.numpy()
        & np.uint32((1 << (32 - g.ei_bit)) - 1)).astype(np.int64))


def host_decode(g, tag: int) -> np.ndarray:
    """The f32 decode of every entry of ``g`` at ``tag``
    (``ref.decode_csr_ref`` on the host), as f64, kept on the pack."""
    from repro_torch.kernels import ref

    def build():
        h = g.on_host()
        return ref.decode_csr_ref(h.colpak, h.head, h.tail1, h.tail2,
                                  h.table, g.ei_bit,
                                  tag).numpy().astype(np.float64)

    return _map_cached(g, ("host_decode", tag), build)


def group_sensitivity(g, group_size: int = GROUP_SIZE) -> np.ndarray:
    """Per-row-group sensitivity scores from the packed magnitudes: the
    max head-only decoded ``|value|`` in each group of ``group_size`` rows
    (head mantissa times the shared-exponent scale, exact).  Returns an
    ``(n_groups,)`` f64 array aligned with ``TagMap.tags``."""
    h = g.on_host()
    head = h.head.numpy().astype(np.uint32)
    mant = (head & 0x7FFF).astype(np.float64)
    exp_idx = (h.colpak.numpy().astype(np.uint64)
               >> np.uint64(32 - g.ei_bit)).astype(np.int64)
    e_sh = h.table.numpy().astype(np.int64)[exp_idx] - 1023
    mag = np.ldexp(mant, e_sh - 15)  # |head-only decode|, exact
    groups = h.row_ids.numpy().astype(np.int64) // group_size
    n_groups = -(-int(g.shape[0]) // group_size)
    score = np.zeros(n_groups, np.float64)
    np.maximum.at(score, groups, mag)
    return score


def decode_error_scores(g, xhat, group_size: int = GROUP_SIZE) -> np.ndarray:
    """Per-group squared floor contributions at candidate tags 1 and 2.

    A tag-``t`` solve plateaus at a true residual ``||(A~_t - A) x*|| /
    ||b||``; promoting a column group to tag 3 zeroes its columns' share.
    Row 0 (tag 1) and row 1 (tag 2) of the ``(2, n_groups)`` result hold,
    per group ``g``, ``sum_{entries e: col(e) in g} ((v_t(e) - v3(e)) *
    xhat[col(e)])^2``; tag 3 contributes 0.  ``xhat`` is a per-row
    solution-magnitude proxy (``solvers.adaptive``'s profiles)."""
    xh = np.abs(np.asarray(xhat, np.float64)).reshape(-1)
    cols = host_cols(g)
    v3 = host_decode(g, 3)
    n_groups = -(-int(g.shape[0]) // group_size)
    gc = np.minimum(cols // group_size, n_groups - 1)
    scores = np.zeros((2, n_groups), np.float64)
    for k, t in enumerate((1, 2)):
        c = (host_decode(g, t) - v3) * xh[cols]
        np.add.at(scores[k], gc, c * c)
    return scores


def map_floor_contrib(scores: np.ndarray, tags: np.ndarray) -> np.ndarray:
    """Per-group floor contribution of a map under ``decode_error_scores``:
    ``scores[tag-1, g]`` for tags 1/2, exactly 0 for tag-3 groups."""
    tags = np.asarray(tags)
    cur = np.zeros(scores.shape[1], np.float64)
    for t in (1, 2):
        sel = tags == t
        cur[sel] = scores[t - 1][sel]
    return cur


def plan_tagmap(scores: np.ndarray, budget: float, tags0=None,
                group_size: int = GROUP_SIZE) -> TagMap:
    """Greedy budget descent over :func:`decode_error_scores`: from
    all-tag-1 (or ``tags0``), promote the group with the largest current
    floor contribution one rung until the predicted floor ``sqrt(sum_g
    contrib_g)`` fits ``budget`` (an absolute residual-norm budget).  The
    sum is recomputed from scratch every step, as the reference does."""
    G = np.asarray(scores, np.float64)
    ng = G.shape[1]
    if tags0 is None:
        tags = np.ones(ng, np.uint8)
    else:
        src = tags0.tags if isinstance(tags0, TagMap) else tags0
        tags = np.asarray(src, np.uint8).copy()
        if tags.shape[0] != ng:
            raise ValueError(f"{tags.shape[0]} seed tags for {ng} groups")
    b2 = float(budget) ** 2
    cur = map_floor_contrib(G, tags)
    while cur.sum() > b2:
        open_ = tags < 3
        if not open_.any():
            break
        idx = int(np.argmax(np.where(open_, cur, -np.inf)))
        tags[idx] += 1
        cur = map_floor_contrib(G, tags)
    return TagMap(tags, group_size)


def promote_groups(tm: TagMap, scores: np.ndarray, frac: float = 0.25,
                   step: int = 1) -> TagMap:
    """Promote the top-``frac`` highest-score groups below tag 3 (at least
    one if any is open), a new map: the per-group twin of
    :func:`update_tag`'s whole-operator step."""
    scores = np.asarray(scores, np.float64)
    if scores.shape[0] != tm.n_groups:
        raise ValueError(
            f"{scores.shape[0]} scores for {tm.n_groups} groups"
        )
    open_idx = np.nonzero(tm.tags < 3)[0]
    if open_idx.size == 0:
        return tm
    n = max(1, int(round(frac * tm.n_groups)))
    n = min(n, open_idx.size)
    top = open_idx[np.argsort(-scores[open_idx], kind="stable")[:n]]
    return tm.promoted(top, step=step)
