"""Best-of-k timing, on the clock of the device the outputs lie on.

Port of ``repro/perf/timing.py``: ``measure``, ``measure_split`` and
``best_seconds`` with the reference's signatures and return values.  The
minimum of k runs is the estimator: every source of variance (the
scheduler, clocks, a neighbour on the host) only adds time.

The clock follows the outputs.  When ``fn`` returns a CUDA tensor, each
timed run lies between two CUDA events recorded on the current stream,
after a ``torch.cuda.synchronize()``, and is read once the end event has
completed.  Otherwise the host's ``time.perf_counter`` is read around the
call, with the card synchronized before each reading if CUDA is in use,
so no host clock is ever read around a launch still in flight.
"""
from __future__ import annotations

import time

import torch

__all__ = ["measure", "measure_split", "best_seconds"]


def _on_cuda(out) -> bool:
    """Does ``out`` (a tensor, or a tuple/list/dict of them) hold a CUDA
    tensor?"""
    if isinstance(out, torch.Tensor):
        return out.device.type == "cuda"
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    return False


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _host_seconds(fn, args, kwargs):
    _sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync()
    return out, time.perf_counter() - t0


def _event_seconds(fn, args, kwargs):
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args, **kwargs)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _best(fn, args, kwargs, iters: int, out):
    timer = _event_seconds if _on_cuda(out) else _host_seconds
    best = float("inf")
    for _ in range(iters):
        out, sec = timer(fn, args, kwargs)
        best = min(best, sec)
    return out, best


def measure(fn, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """Run ``fn(*args, **kwargs)`` ``warmup + iters`` times; return
    ``(last_output, best_seconds)``.  With ``warmup=0`` the first timed
    run, whose outputs' device is not known yet, is read on the host clock
    (synchronized on both sides)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args, **kwargs)
    if warmup > 0:
        return _best(fn, args, kwargs, iters, out)
    out, best = _host_seconds(fn, args, kwargs)
    if iters > 1:
        out, rest = _best(fn, args, kwargs, iters - 1, out)
        best = min(best, rest)
    return out, best


def measure_split(fn, *args, iters: int = 10, warmup: int = 2, **kwargs):
    """Like :func:`measure`, but the very first call is also timed alone,
    on the host clock with the card synchronized on both sides (it pays
    the kernels' build and first loads).

    Returns ``(last_output, first_seconds, best_seconds)``."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    out, first = _host_seconds(fn, args, kwargs)
    for _ in range(max(warmup - 1, 0)):
        out = fn(*args, **kwargs)
    out, best = _best(fn, args, kwargs, iters, out)
    return out, first, best


def best_seconds(fn, *args, iters: int = 10, warmup: int = 2,
                 **kwargs) -> float:
    """Best-of-k seconds only (drops the output)."""
    return measure(fn, *args, iters=iters, warmup=warmup, **kwargs)[1]
