"""Stepped mixed-precision controller (paper Section III.D, Eq. 3-6).

Port of ``repro/core/precision.py`` :43-160: ``MonitorParams`` (with
``for_cg``/``for_gmres``), ``MonitorState``, ``init``, ``record``,
``metrics`` and ``update_tag``.  The per-group scoring functions arrive
with the TagMap port.

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

import torch

from repro_torch.kernels.vec_f64 import sqrt_rn

__all__ = ["MonitorParams", "MonitorState", "init", "record", "metrics",
           "update_tag"]


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
