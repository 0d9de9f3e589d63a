"""Launch-plan autotuner: sweep, pick, persist.

Port of ``repro/perf/autotune.py``.  Sweeps the port's own launch axes
per (shape class, tag, layout, nrhs) -- the lanes a row of A32 and C32
runs on (``"ell"``), and the SELL pack's C, sigma and width buckets of
B32 and C′32 (``"sell"``) -- times each candidate best-of-k
(``perf.timing``: CUDA events on the card), and persists the winner in
``perf.tunecache`` under the operand's device, so every later run (and
every ``perf.plan.resolve`` dispatch) reuses it with no re-sweep
(``TUNE_STATS['sweeps']`` stays flat).  The payload is the reference's:
``{plan, us, default_us, sweep, decode_bound}``.

The candidate lists lead with the default plan.  Every candidate computes
the same bits (a row's sum has one order whatever the lanes, C, sigma or
buckets), so the sweep trades time only.  A candidate that fails to build
or launch raises; only the reference's ``compatible_with_sell`` case is
skipped.  On the card each candidate launches its kernels; the plain
versions run only for CPU operands.

Decode-overhead crossover: below ``DECODE_BOUND_NNZ`` stored entries the
SpMV's time is launch- and latency-bound, so the tag ladder's byte
savings do not show in the time.  The constant is the card's own
(``chip_smoke.py`` phase 25 measures it on ``random_spd(n, 8)``); the
reference's 200,000 was measured on a CPU host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision_table import TAG_BITS_USED
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gse_spmv import ELL_LANES, ELL_LANES_DEFAULT
from repro_torch.obs import trace as OT
from repro_torch.perf import timing, tunecache
from repro_torch.perf.plan import (
    DEFAULT_PLAN,
    KernelPlan,
    plan_key,
    shape_class,
)

__all__ = ["candidates", "tune", "get_or_tune", "decode_bound",
           "DECODE_BOUND_NNZ"]

# The card's crossover (chip_smoke.py phase 25, part f): A32's device time
# at tag 3 is within 1.05x of tag 1's on random_spd(n, 8) up to n = 2^10
# (17,268 entries, 1.047x) and past it from n = 2^12 (69,506 entries,
# 1.055x; 1.28x from 2^18 on).  NVIDIA H100 80GB HBM3, 700.00 W.
DECODE_BOUND_NNZ = 69_506

# The reference's SELL candidates (its perf/autotune.py:69-76): C, sigma
# and bucket, each with the reference's blocks; the port's packer takes
# every one (C a multiple of 8).
_SELL_CANDIDATES = (
    DEFAULT_PLAN,
    KernelPlan(blocks=(16, 128), sell_c=16),
    KernelPlan(blocks=(16, 128), sell_c=16, sell_sigma=64),
    KernelPlan(blocks=(8, 128), sell_c=8, sell_sigma=32),
    KernelPlan(blocks=(8, 128), sell_bucket="exact"),
)


def decode_bound(a) -> bool:
    """True when ``a`` sits below the measured decode-overhead crossover
    (the format choice does not show in the time there)."""
    return int(a.nnz) < DECODE_BOUND_NNZ


def candidates(layout: str) -> tuple:
    """Candidate plans per layout; the default plan leads.

    ``"ell"`` sweeps the lanes a row of A32 and C32 runs on over
    ``ELL_LANES``; ``"sell"`` sweeps the reference's SELL C, sigma and
    bucket candidates.
    """
    if layout == "ell":
        return (DEFAULT_PLAN,) + tuple(
            KernelPlan(lanes=lanes) for lanes in ELL_LANES
            if lanes != ELL_LANES_DEFAULT)
    if layout == "sell":
        return _SELL_CANDIDATES
    raise ValueError(f"layout must be 'ell' or 'sell', got {layout!r}")


def _runner(a, x, tag: int, layout: str, plan: KernelPlan, packs: dict):
    """Pack with the candidate's layout parameters and return a thunk
    running the planned kernel.  Packing is left out of the time (a pack
    is made once for the life of the operator), and so is the ELL path's
    scale table (``gse_spmv_ell`` makes it on every call, a few dozen
    small launches that would time the host, not the launch plan): the
    thunk calls the tag-specialized dispatch ``ops.spmv_kernel_for`` /
    ``spmm_kernel_for`` as ``gse_spmv_ell`` / ``gse_spmm_ell`` do.
    ``packs`` holds the sweep's packs (and the ELL row lengths and
    scales) by layout parameters, so candidates that share one fetch it
    once."""
    if layout == "sell":
        key = ("sell", plan.sell_c, plan.sell_sigma, plan.lane,
               plan.sell_bucket)
        if key not in packs:
            packs[key] = ops.sell_pack_gsecsr(a, plan=plan)
        sell = packs[key]
        if not plan.compatible_with_sell(sell):
            return None
        if x.dim() == 1:
            return lambda: ops.gse_spmv_sell(sell, x, tag=tag,
                                             blocks=plan.blocks)
        return lambda: ops.gse_spmm_sell(sell, x, tag=tag,
                                         blocks=plan.blocks, device=a.device)
    key = ("ell", plan.lane)
    if key not in packs:
        packs[key] = ops.ell_pack_gsecsr(a, plan=plan)
    if ("scales", tag) not in packs:
        packs["row_len"] = ops.ell_row_lengths(a)
        packs["scales", tag] = ref.make_scales(a.table, TAG_BITS_USED[tag])
    operands = ops._ell_operands(packs[key], tag)
    row_len, scales = packs["row_len"], packs["scales", tag]
    if x.dim() == 1:
        call = ops.spmv_kernel_for(tag, a.ei_bit)
        return lambda: call(*operands, x, scales, row_len=row_len,
                            lanes=plan.lanes)
    call = ops.spmm_kernel_for(tag, a.ei_bit)
    return lambda: call(*operands, x, scales, row_len=row_len,
                        lanes=plan.lanes, device=a.device)


def tune(a, tag: int = 1, layout: str = "ell", nrhs: int = 1,
         iters: int = 3, warmup: int = 1) -> dict:
    """Sweep the candidates for ``a`` (a ``GSECSR``) at (tag, layout,
    nrhs) on ``a``'s device and persist the winner there.  Returns the
    stored payload: ``{plan, us, default_us, sweep, decode_bound}``."""
    key = plan_key(shape_class(a), tag, layout, nrhs)
    rng = np.random.default_rng(0)
    n = a.shape[1]
    x = torch.from_numpy(np.asarray(rng.normal(
        size=(n, nrhs) if nrhs > 1 else n), np.float32)).to(a.device)
    sweep, packs = [], {}
    best = None
    with OT.span("tune.sweep", key=key, layout=layout, tag=tag,
                 nrhs=nrhs) as attrs:
        for cand in candidates(layout):
            run = _runner(a, x, tag, layout, cand, packs)
            if run is None:
                continue
            _, sec = timing.measure(run, iters=iters, warmup=warmup)
            row = {"plan": cand.to_dict(), "us": sec * 1e6}
            sweep.append(row)
            if best is None or row["us"] < best[1]["us"]:
                best = (cand, row)
        attrs["candidates"] = len(sweep)
    tunecache.TUNE_STATS["sweeps"] += 1
    plan, row = best
    payload = {
        "plan": plan.to_dict(),
        "us": row["us"],
        "default_us": sweep[0]["us"],  # candidates() leads with the default
        "sweep": sweep,
        "decode_bound": decode_bound(a),
    }
    tunecache.store(key, payload, device=a.device)
    return payload


def get_or_tune(a, tag: int = 1, layout: str = "ell", nrhs: int = 1,
                **kwargs):
    """Tuned plan for ``a`` on its device, sweeping only on a cache miss.

    Returns ``(plan, payload, hit)``; on a hit the payload is the stored
    sweep report and no kernel runs."""
    key = plan_key(shape_class(a), tag, layout, nrhs)
    payload = tunecache.lookup(key, device=a.device)
    hit = payload is not None
    if not hit:
        payload = tune(a, tag=tag, layout=layout, nrhs=nrhs, **kwargs)
    plan = KernelPlan.from_dict(payload["plan"], source="tuned")
    return plan, payload, hit
