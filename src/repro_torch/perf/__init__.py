"""Performance layer: launch plans, the tune cache, timing, the byte
ledger, the roofline and the autotuner.

Port of ``repro/perf/__init__.py``, with its import layering, bottom-up:

  ``tunecache``  -- the persisted tuned-plan store, per device;
  ``plan``       -- :class:`KernelPlan` and the one ``resolve`` dispatcher
                    every SpMV/SpMM entry point of ``kernels.ops`` routes
                    through (imports tunecache);
  ``timing``     -- best-of-k timing: CUDA events on the card, the host
                    clock on the CPU;
  ``ledger``     -- per-kernel FLOP and byte ledger, checked against the
                    integer tensors ``kernels.ops`` hands to the kernels;
  ``roofline``   -- stream-bandwidth and FP32 peak probes of a device and
                    achieved-against-roofline fractions;
  ``autotune``   -- sweeps the port's launch axes (A32/C32 lanes, SELL C,
                    sigma and buckets) per operator class and persists the
                    winners (imports ``kernels.ops``: kept out of this
                    module's eager imports so ``kernels.ops`` can import
                    ``perf.plan`` without a cycle).
"""
from __future__ import annotations

from repro_torch.perf.plan import (  # noqa: F401
    DEFAULT_BLOCKS,
    DEFAULT_PLAN,
    KernelPlan,
    plan_key,
    resolve,
    shape_class,
)
from repro_torch.perf.tunecache import TUNE_STATS  # noqa: F401

__all__ = [
    "KernelPlan",
    "DEFAULT_PLAN",
    "DEFAULT_BLOCKS",
    "resolve",
    "plan_key",
    "shape_class",
    "TUNE_STATS",
]


def __getattr__(name):
    # autotune imports kernels.ops, which imports perf.plan: load the
    # heavier modules lazily so `import repro_torch.perf` stays cycle-free.
    if name in ("autotune", "ledger", "roofline", "timing", "tunecache",
                "plan"):
        import importlib

        return importlib.import_module(f"repro_torch.perf.{name}")
    raise AttributeError(
        f"module 'repro_torch.perf' has no attribute {name!r}")
