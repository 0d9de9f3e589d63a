"""The RG-LRU recurrence ``h_t = a_t * h_(t-1) + b_t``, hand-written for
Hopper.

Replaces no Pallas kernel: the reference's ``rglru_apply``
(``repro/models/rglru.py:94-100``) runs the recurrence as
``jax.lax.associative_scan`` over plain XLA, and no single torch call
computes it.  The port's prefill of the hybrid family runs it once per
RG-LRU layer.  The CUDA source is ``csrc/lru_scan.cu``: one thread per
(batch, channel), sequential in t, coalesced across channels; bound by
``12 * B * S * W`` bytes (a and b read once, h written once).

a and b are ``(B, S, W)`` f32 and h0 ``(B, W)`` f32; the result is ``(h,
h_last)``, h ``(B, S, W)`` and ``h_last = h[:, -1]`` ``(B, W)`` (h0 when S
is 0).  Each step rounds the product, then the sum (no fused
multiply-add), in the kernel and in :func:`lru_scan_plain` alike, so the
card is held to the plain version bit for bit.  The associative scan sums
in another order: the tests hold the plain version to it within rtol 1e-5
/ atol 1e-6.  :func:`lru_scan` launches the kernel for CUDA tensors (or
raises) and runs the plain version only for CPU tensors; it counts its
launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gse_spmv import _raise_on
from repro_torch.kernels.vec_f64 import on_device, refuse_grad

__all__ = ["lru_scan", "lru_scan_plain", "KERNELS", "reset_launch_counts"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_BOUND = {}


def _fn():
    fn = _BOUND.get("scan")
    if fn is None:
        fn = _build.load("lru_scan").lru_scan_f32
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
        _BOUND["scan"] = fn
    return fn


def _check(a, b, h0):
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                         a.shape[2]):
        raise ValueError(f"expected a, b (B, S, W) and h0 (B, W), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def lru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Plain version: one step at a time, the product rounded, then the
    sum."""
    _check(a, b, h0)
    h = torch.empty_like(a)
    hv = h0
    for t in range(a.shape[1]):
        hv = a[:, t] * hv + b[:, t]
        h[:, t] = hv
    return h, hv.clone()


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
             device="cuda"):
    """``h_t = a_t * h_(t-1) + b_t`` over the S axis of ``(B, S, W)`` f32
    a and b from ``h0`` ``(B, W)``; returns ``(h, h_last)``."""
    dev = on_device(device, a=a, b=b, h0=h0)
    refuse_grad("lru_scan", a=a, b=b, h0=h0)
    _check(a, b, h0)
    if dev.type == "cpu":
        return lru_scan_plain(a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"lru_scan runs on cuda or cpu, not {dev}")
    if a.device != b.device or a.device != h0.device:
        raise ValueError("a, b and h0 must share one device")
    a, b, h0 = a.contiguous(), b.contiguous(), h0.contiguous()
    bsz, s, w = a.shape
    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if s == 0:
        return h, h_last.copy_(h0)
    rc = _fn()(a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(),
               h_last.data_ptr(), bsz, s, w,
               torch.cuda.current_stream(a.device).cuda_stream)
    lru_scan.launches += 1
    _raise_on(rc, "lru_scan")
    return h, h_last


KERNELS = (lru_scan,)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
