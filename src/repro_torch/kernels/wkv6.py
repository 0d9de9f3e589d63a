"""The RWKV-6 time-mix recurrence, hand-written for Hopper.

Replaces no Pallas kernel: the reference's ``rwkv_time_apply``
(``repro/models/rwkv.py:136-151``) runs the recurrence as ``jax.lax.scan``
over plain XLA, and no single torch call computes it.  The port's
prefill and decode of the ssm family run it once per layer.  The CUDA
source is ``csrc/wkv6.cu``: one block per (batch, head), one thread per
state column; bound by the larger of ``4 * (5 B S H N + 2 B H N^2)``
bytes and ``7 B S H N^2`` operations (a product and three FMAs per state
entry and step).

r, k, v and w are ``(B, S, H, N)`` f32, u ``(H, N)`` f32 and s0 ``(B, H,
N, N)`` f32 (``S[b, h, n, m]``), N <= 64; the result is ``(out,
s_final)``, out ``(B, S, H, N)`` f32.  Each step computes, for every
state entry, the sequence XLA's CPU build of the reference's scan step
computes (checked bit for bit at N 8, 16, 32 and 64):

* ``kv = k_n * v_m`` rounded;
* ``t = fma(u_n, kv, S_nm)``;
* ``out_m``: ``acc = fma(r_n, t_nm, acc)`` over n ascending from 0.0;
* ``S'_nm = fma(w_n, S_nm, kv)``.

The kernel (``__fmul_rn``, ``__fmaf_rn``) and :func:`wkv6_plain` (torch,
vectorised over (b, h, m), looped over t and n) compute the same
sequence, so the card is held to the plain version bit for bit.
:func:`wkv6` launches the kernel for CUDA tensors (or raises) and runs
the plain version only for CPU tensors; it counts its launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gse_spmv import _raise_on
from repro_torch.kernels.vec_f64 import on_device, refuse_grad

__all__ = ["wkv6", "wkv6_plain", "fma_f32", "N_MAX", "KERNELS",
           "reset_launch_counts"]

N_MAX = 64
_P = ctypes.c_void_p
_I = ctypes.c_int
_BOUND = {}


def _fn():
    fn = _BOUND.get("wkv6")
    if fn is None:
        fn = _build.load("wkv6").wkv6_f32
        fn.argtypes = [_P] * 8 + [_I, _I, _I, _I, _P]
        fn.restype = ctypes.c_int
        _BOUND["wkv6"] = fn
    return fn


def _fma_exact(a, b, c):
    """``fma(a, b, c)`` of f32 tensors, rounded once, from f64 operations:
    the product is exact in f64, the sum is rounded to odd (Boldo and
    Melquiond: an exact two-sum, then the neighbour with an odd last bit
    where the sum was inexact and rounded to an even one), and the one
    rounding to f32 is then correct (53 >= 24 + 2 bits)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _addcmul_rounds_once(dev: torch.device) -> bool:
    """Whether ``torch.addcmul`` at f32 on ``dev`` rounds ``c + a * b``
    once (a fused multiply-add), checked against :func:`_fma_exact` on
    operands where the two roundings differ, in a vector body and in a
    scalar tail."""
    gen = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(4099, dtype=torch.float32, generator=gen).to(dev)
               for _ in range(3))
    fused = _fma_exact(a, b, c)
    if torch.equal(fused, c + a * b):
        return False  # the probe would not tell the two apart
    return (torch.equal(torch.addcmul(c, a, b), fused)
            and torch.equal(torch.addcmul(c[:7], a[:7], b[:7]), fused[:7]))


def fma_f32(dev: torch.device):
    """A callable ``f(a, b, c) = fma(a, b, c)`` of f32 tensors on ``dev``
    (broadcast), rounded once: ``torch.addcmul`` where torch fuses it on
    that device type (checked once per process), else :func:`_fma_exact`."""
    key = ("addcmul", dev.type)
    fused = _BOUND.get(key)
    if fused is None:
        fused = _BOUND[key] = _addcmul_rounds_once(dev)
    if fused:
        return lambda a, b, c: torch.addcmul(c, a, b)
    return _fma_exact


def _check(r, k, v, w, u, s0):
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, N), got {tuple(r.shape)}")
    b, _, h, n = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} must have r's shape {tuple(r.shape)}, "
                             f"got {tuple(t.shape)}")
    if u.shape != (h, n):
        raise ValueError(f"u must be (H, N) = {(h, n)}, got "
                         f"{tuple(u.shape)}")
    if s0.shape != (b, h, n, n):
        raise ValueError(f"s0 must be (B, H, N, N) = {(b, h, n, n)}, got "
                         f"{tuple(s0.shape)}")
    if n > N_MAX:
        raise ValueError(f"wkv6 takes head dims up to {N_MAX}, got {n}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def wkv6_plain(r, k, v, w, u, s0):
    """Plain version: the kernel's sequence in torch, vectorised over (b,
    h, m), looped over t and n, every FMA rounded once (:func:`fma_f32`)."""
    _check(r, k, v, w, u, s0)
    fma = fma_f32(r.device)
    bsz, s_len, h, n = r.shape
    out = torch.empty_like(r)
    st = s0.clone()
    uu = u[None, :, :, None]
    for t in range(s_len):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, N, N)
        tt = fma(uu, kv, st)
        rt = r[:, t]
        acc = torch.zeros((bsz, h, n), dtype=torch.float32, device=r.device)
        for i in range(n):
            acc = fma(rt[:, :, i, None], tt[:, :, i, :], acc)
        st = fma(w[:, t, :, :, None], st, kv)
        out[:, t] = acc
    return out, st


def wkv6(r, k, v, w, u, s0, device="cuda"):
    """The RWKV-6 recurrence over the S axis of ``(B, S, H, N)`` f32 r, k,
    v, w from the state s0 ``(B, H, N, N)``; returns ``(out, s_final)``."""
    dev = on_device(device, r=r, k=k, v=v, w=w, u=u, s0=s0)
    refuse_grad("wkv6", r=r, k=k, v=v, w=w, u=u, s0=s0)
    _check(r, k, v, w, u, s0)
    if dev.type == "cpu":
        return wkv6_plain(r, k, v, w, u, s0)
    if dev.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {dev}")
    if len({t.device for t in (r, k, v, w, u, s0)}) != 1:
        raise ValueError("r, k, v, w, u and s0 must share one device")
    bsz, s_len, h, n = r.shape
    out = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    if s_len == 0:
        return out, s_fin.copy_(s0)
    rc = _fn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_fin.data_ptr(),
               bsz, s_len, h, n,
               torch.cuda.current_stream(r.device).cuda_stream)
    wkv6.launches += 1
    _raise_on(rc, "wkv6")
    return out, s_fin


KERNELS = (wkv6,)


def reset_launch_counts():
    for kern in KERNELS:
        kern.launches = 0


reset_launch_counts()
