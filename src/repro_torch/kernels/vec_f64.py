"""The stepped CG loop's f64 vector operations, hand-written for Hopper.

The reference's CG step (``repro/solvers/fused_cg.py:51-57``,
``repro/solvers/cg.py:238,257-267``) runs through XLA's CPU backend, which
fuses a multiply into the add that consumes it.  ``jnp.vdot`` is one
chain in index order: the accumulator starts at ``a[0] * b[0]``, adds
``a[1..7] * b[1..7]`` as separately rounded products (the first tile of
XLA's GEMV emitter, where the product is not fused), then takes every
later element as one fused multiply-add.  ``x + alpha * p``,
``r - alpha * ap`` and ``r + beta * p`` are elementwise FMAs.  The stepped
schedule depends on that rounding: with a pairwise-tree dot and separately
rounded updates the monitor on ``spd_rs8_2k`` steps the tag at iterations
[180, 300] instead of the reference's [120, 150].  The two kernels of
``csrc/vec_f64.cu`` round as the reference does, so the port's iterates
are bitwise the reference's, on the card and on the CPU twin alike:

* :func:`seq_dot` -- ``a . b`` as that chain.  Bound by the chain's
  latency: one thread runs the n dependent steps.
* :func:`fma_axpy` -- ``fma(alpha, x, y)`` elementwise, ``alpha`` a device
  scalar.  Bound by HBM bytes.

The batched CG loop (``solvers/batched.py``, the reference's per-column
``jnp.vdot`` and updates in ``repro/solvers/batched.py:332-344``) keeps
its vectors as ``(nrhs, n)`` blocks, one contiguous column per
right-hand side, and runs the column-batched twins:

* :func:`seq_dot_cols` -- one chain per column, the chains side by side,
  each rounded exactly as :func:`seq_dot`; inactive columns are skipped.
* :func:`fma_axpy_cols` -- ``fma(alpha[j], x[j], y[j])`` per column.

Column j of either is bitwise the single-vector op on column j.

:func:`ref_norm_cols` is the reference's ``jnp.linalg.norm`` (the solvers'
``||b||``) as XLA's CPU build computes it, in torch operations around
those kernels, and :func:`sqrt_rn` a square root rounded as the
reference's.

Each single-vector wrapper launches its kernel for CUDA tensors (or
raises) and runs its plain version only for CPU tensors.  The column
wrappers take ``device=`` (default ``"cuda"``): they launch on the card
and run the plain version only when the caller asks for the CPU, and
raise for tensors elsewhere.  Each wrapper counts its launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["seq_dot", "seq_dot_plain", "fma_axpy", "fma_axpy_plain",
           "seq_dot_cols", "seq_dot_cols_plain", "fma_axpy_cols",
           "fma_axpy_cols_plain", "ref_norm_cols", "sqrt_rn", "KERNELS",
           "reset_launch_counts"]

_P = ctypes.c_void_p
_ARGTYPES = {
    "seq_dot_f64": [_P, _P, ctypes.c_longlong, _P, _P],
    "fma_axpy_f64": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "seq_dot_cols_f64": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P],
    "fma_axpy_cols_f64": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                          _P],
}
_BOUND = {}
_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's splitter for f64
_HEAD = 8  # leading elements of a dot added without fusion
_WINDOW = 32  # XLA's CPU tree-reduction window


def _fn(name: str):
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(_build.load("vec_f64"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def _libm_fma():
    fma = _BOUND.get("fma")
    if fma is None:
        fma = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").fma
        fma.argtypes = [ctypes.c_double] * 3
        fma.restype = ctypes.c_double
        _BOUND["fma"] = fma
    return fma


def _check(t: torch.Tensor, name: str, device, ndim: int):
    if t.dtype != torch.float64:
        raise TypeError(f"{name} must be torch.float64, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def on_device(device, **tensors) -> torch.device:
    """``torch.device(device)`` after checking that every tensor lies there
    (a device without an index matches any index of its type)."""
    dev = torch.device(device)
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    return dev


# --- the dot: one chain ------------------------------------------------------

def seq_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`seq_dot`, one element at a time on the host:
    ``acc = a[0] * b[0]``, ``acc = acc + a[i] * b[i]`` for ``i < 8``, then
    ``acc = fma(a[i], b[i], acc)``.  Torch has no fused multiply-add on the
    CPU, so the fused steps call the C library's correctly rounded ``fma``,
    which rounds as the card's ``__fma_rn`` does."""
    fma = _libm_fma()
    au, bv = a.tolist(), b.tolist()
    acc = au[0] * bv[0] if au else 0.0
    for i in range(1, min(len(au), _HEAD)):
        acc = acc + au[i] * bv[i]
    for i in range(_HEAD, len(au)):
        acc = fma(au[i], bv[i], acc)
    return torch.tensor(acc, dtype=torch.float64, device=a.device)


def seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` of two 1-d f64 tensors as a 0-d tensor on their device,
    rounded as the reference's ``jnp.vdot`` (0.0 for empty tensors)."""
    if a.device.type == "cpu":
        return seq_dot_plain(a, b)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"seq_dot runs on cuda or cpu, not {dev}")
    _check(a, "a", dev, 1)
    _check(b, "b", dev, 1)
    if a.shape != b.shape:
        raise ValueError(f"length mismatch: {a.shape[0]} vs {b.shape[0]}")
    out = torch.empty((), dtype=torch.float64, device=dev)
    rc = _fn("seq_dot_f64")(a.data_ptr(), b.data_ptr(), a.shape[0],
                            out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    seq_dot.launches += 1
    _raise_on(rc, "seq_dot_f64")
    return out


# --- the update: fma(alpha, x, y) -------------------------------------------

def _split(v):
    g = _SPLIT * v
    hi = g - (g - v)
    return hi, v - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma_axpy_plain(alpha: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fma_axpy`: ``fma(alpha, x, y)`` elementwise
    from f64 operations, after Boldo and Melquiond ("Emulation of FMA and
    correctly rounded sums", IEEE TC 2008): Dekker's exact product, an
    exact sum with ``y``, the two low parts added with rounding to odd,
    then one rounding to nearest.  Exact while the product's low part does
    not underflow (|alpha * x| above about 1e-290) and nothing overflows;
    elements whose emulation is not finite take ``y + alpha * x``."""
    ph = alpha * x
    ah, al = _split(alpha)
    xh, xl = _split(x)
    pl = ((ah * xh - ph) + ah * xl + al * xh) + al * xl
    th, tl = _two_sum(y, ph)
    v, e = _two_sum(tl, pl)
    even = (v.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.inf, -torch.inf).to(v.dtype)
    v = torch.where((e != 0) & even, torch.nextafter(v, toward), v)
    out = th + v
    return torch.where(torch.isfinite(out), out, y + ph)


def fma_axpy(alpha: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """``fma(alpha, x, y)`` of 1-d f64 tensors, rounded once, with
    ``alpha`` a 0-d f64 tensor on their device."""
    if x.device.type == "cpu":
        return fma_axpy_plain(alpha, x, y)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fma_axpy runs on cuda or cpu, not {dev}")
    _check(alpha.reshape(1), "alpha", dev, 1)
    _check(x, "x", dev, 1)
    _check(y, "y", dev, 1)
    if x.shape != y.shape:
        raise ValueError(f"length mismatch: {x.shape[0]} vs {y.shape[0]}")
    out = torch.empty_like(y)
    rc = _fn("fma_axpy_f64")(alpha.data_ptr(), x.data_ptr(), y.data_ptr(),
                             out.data_ptr(), x.shape[0],
                             torch.cuda.current_stream(dev).cuda_stream)
    fma_axpy.launches += 1
    _raise_on(rc, "fma_axpy_f64")
    return out


# --- the column-batched twins ----------------------------------------------

def _check_block(name, t, dev, nrhs=None, n=None):
    _check(t, name, dev, 2)
    if (nrhs, n) != (None, None) and tuple(t.shape) != (nrhs, n):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"({nrhs}, {n})")


def _active(active, nrhs: int, dev):
    if active is None:
        return torch.ones(nrhs, dtype=torch.bool, device=dev)
    if active.dtype != torch.bool or tuple(active.shape) != (nrhs,):
        raise ValueError(f"active must be a ({nrhs},) bool tensor, got "
                         f"{active.dtype} {tuple(active.shape)}")
    return active.contiguous()


def seq_dot_cols_plain(a: torch.Tensor, b: torch.Tensor,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`seq_dot_cols`: :func:`seq_dot_plain` on each
    active column, 0.0 for the others."""
    nrhs = a.shape[0]
    act = _active(active, nrhs, a.device).tolist()
    out = torch.zeros(nrhs, dtype=torch.float64, device=a.device)
    for j in range(nrhs):
        if act[j]:
            out[j] = seq_dot_plain(a[j], b[j])
    return out


def seq_dot_cols(a: torch.Tensor, b: torch.Tensor,
                 active: torch.Tensor | None = None, *,
                 device="cuda") -> torch.Tensor:
    """``(nrhs,)`` dots of the columns of two ``(nrhs, n)`` f64 blocks,
    column j rounded exactly as ``seq_dot(a[j], b[j])``.  ``active`` is an
    ``(nrhs,)`` bool tensor (default: every column); an inactive column is
    not read and gives 0.0."""
    dev = on_device(device, a=a, b=b, active=active)
    if dev.type == "cpu":
        return seq_dot_cols_plain(a, b, active)
    if dev.type != "cuda":
        raise ValueError(f"seq_dot_cols runs on cuda or cpu, not {dev}")
    dev = a.device
    _check_block("a", a, dev)
    nrhs, n = a.shape
    _check_block("b", b, dev, nrhs, n)
    act = _active(active, nrhs, dev)
    out = torch.empty(nrhs, dtype=torch.float64, device=dev)
    if nrhs == 0:
        return out
    rc = _fn("seq_dot_cols_f64")(a.data_ptr(), b.data_ptr(), n, nrhs,
                                 act.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    seq_dot_cols.launches += 1
    _raise_on(rc, "seq_dot_cols_f64")
    return out


def fma_axpy_cols_plain(alpha: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fma_axpy_cols`: :func:`fma_axpy_plain` with
    ``alpha`` broadcast down each column.  It is elementwise, so column j
    is bitwise ``fma_axpy_plain(alpha[j], x[j], y[j])``."""
    return fma_axpy_plain(alpha[:, None], x, y)


def fma_axpy_cols(alpha: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
                  device="cuda") -> torch.Tensor:
    """``fma(alpha[j], x[j], y[j])`` for the columns of ``(nrhs, n)`` f64
    blocks, each rounded once; ``alpha`` is an ``(nrhs,)`` f64 tensor on
    their device."""
    dev = on_device(device, alpha=alpha, x=x, y=y)
    if dev.type == "cpu":
        return fma_axpy_cols_plain(alpha, x, y)
    if dev.type != "cuda":
        raise ValueError(f"fma_axpy_cols runs on cuda or cpu, not {dev}")
    dev = x.device
    _check_block("x", x, dev)
    nrhs, n = x.shape
    _check_block("y", y, dev, nrhs, n)
    _check(alpha, "alpha", dev, 1)
    if alpha.shape[0] != nrhs:
        raise ValueError(f"alpha has {alpha.shape[0]} entries, x {nrhs} "
                         "columns")
    out = torch.empty_like(y)
    if nrhs == 0:
        return out
    rc = _fn("fma_axpy_cols_f64")(alpha.data_ptr(), x.data_ptr(),
                                  y.data_ptr(), out.data_ptr(), n, nrhs,
                                  torch.cuda.current_stream(dev).cuda_stream)
    fma_axpy_cols.launches += 1
    _raise_on(rc, "fma_axpy_cols_f64")
    return out


# --- the reference's norm ----------------------------------------------------

def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """IEEE square root, rounded to nearest, as the reference's ``jnp.sqrt``
    (XLA emits the hardware instruction).  CUDA's f64 ``sqrt`` is correctly
    rounded; torch's CPU kernel is not (an ulp off for about 1% of inputs),
    so on the CPU the root is numpy's."""
    if v.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(v.detach().numpy())))
    return torch.sqrt(v)


def ref_norm_cols(v: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """``(nrhs,)`` 2-norms of the columns of an ``(nrhs, n)`` f64 block,
    rounded as XLA's CPU build computes the reference's
    ``jnp.linalg.norm`` (``||b||`` in every solver).

    For n <= 32 XLA fuses the squares into the sum: one chain
    ``acc = fma(v[i], v[i], acc)`` from 0.0 (:func:`fma_axpy_cols`).  For
    n > 32 its tree-reduction rewrite rounds the squares, sums them in
    windows of 32 -- the input padded to a whole number of windows, the
    padding split evenly before and after, each window added in order from
    0.0 -- and reduces the window sums the same way until at most 32 are
    left, which it adds in order from 0.0.  The window sums are elementwise
    across windows and columns, so the card and the CPU give the same
    bits; an added +0.0 of padding leaves a sum of squares unchanged.
    """
    nrhs, n = v.shape
    if n <= _WINDOW:
        acc = torch.zeros(nrhs, 1, dtype=v.dtype, device=v.device)
        for i in range(n):
            acc = fma_axpy_cols(v[:, i].contiguous(),
                                v[:, i:i + 1].contiguous(), acc,
                                device=device)
        return sqrt_rn(acc[:, 0])
    s = v * v
    while s.shape[1] > _WINDOW:
        m = s.shape[1]
        w = -(-m // _WINDOW)
        pad = w * _WINDOW - m
        s = torch.nn.functional.pad(s, (pad // 2, pad - pad // 2))
        s = s.reshape(nrhs, w, _WINDOW)
        acc = torch.zeros(nrhs, w, dtype=v.dtype, device=v.device)
        for i in range(_WINDOW):
            acc = acc + s[:, :, i]
        s = acc
    acc = torch.zeros(nrhs, dtype=v.dtype, device=v.device)
    for i in range(s.shape[1]):
        acc = acc + s[:, i]
    return sqrt_rn(acc)


KERNELS = (seq_dot, fma_axpy, seq_dot_cols, fma_axpy_cols)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
