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

Stepped GMRES (``solvers/gmres.py``, the reference's CGS2 at
``repro/solvers/gmres.py:147-148`` and the cycle's update at :220) runs
two f64 GEMVs over its Krylov basis ``V`` (rows ``(restart + 1, n)``),
each rounded as XLA's CPU build of the jitted reference adds it (read
from its dumped IR and object code, on an AVX-512 host whose XLA emits
256-bit vectors, ``prefer-vector-width=256``):

* :func:`gemv_rows_ref` -- ``V[:rows] @ w``.  XLA's row-major GEMV keeps
  :data:`GEMV_LANES` = 4 partial sums per row: lane l takes the elements
  ``k = l (mod 4)`` of the first ``4 * (n // 4)``, each step one fused
  multiply-add from 0.0; the lanes then add as ``(l0 + l2) + (l1 + l3)``,
  and a scalar FMA chain over the ``n % 4`` trailing elements (0.0 when
  there are none) is added last.  Bound by the lane chains' latency:
  one block per row carries its four chains.
* :func:`gemv_cols_ref` -- ``c[:rows] @ V[:rows]`` (optionally ``+ x``).
  XLA's column-major GEMV runs one FMA chain per column down the rows, in
  row order, from 0.0 -- or from the addend ``x``, where the reference's
  ``x + y @ V`` fuses the add into the dot.  Without an addend and with
  ``n % 4 == 1``, the last column goes through XLA's scalar tail, which
  starts at ``c[0] * V[0]`` and adds rows 1-7 as separately rounded
  products before fusing, as :func:`seq_dot` does.  Bound by HBM bytes:
  one thread per column.

Both products keep the reference's rounding only where the reference
reads real data: ``rows`` is the count of live basis rows, and the
reference's extra all-zero rows can change the result only in the sign
of an exact zero.

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
           "fma_axpy_cols_plain", "gemv_rows_ref", "gemv_rows_ref_plain",
           "gemv_cols_ref", "gemv_cols_ref_plain", "fma_into",
           "GEMV_LANES", "ref_norm_cols", "sqrt_rn", "KERNELS",
           "reset_launch_counts", "chain_latency"]

_P = ctypes.c_void_p
_ARGTYPES = {
    "seq_dot_f64": [_P, _P, ctypes.c_longlong, _P, _P],
    "fma_axpy_f64": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "seq_dot_cols_f64": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P, _P],
    "fma_axpy_cols_f64": [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                          _P],
    "chain_probe_f64": [ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
                        ctypes.c_double, _P, _P],
    "gemv_rows_ref_f64": [_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P],
    "gemv_cols_ref_f64": [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P,
                          _P],
}
_BOUND = {}
_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's splitter for f64
_HEAD = 8  # leading elements of a dot added without fusion
_WINDOW = 32  # XLA's CPU tree-reduction window
GEMV_LANES = 4  # partial sums per row of XLA's CPU row-major f64 GEMV


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


# device argument -> (torch.device, test of a tensor's device)
_DEVICES: dict = {}


def _device_test(dev: torch.device):
    if dev.index is not None:
        return lambda t: t.device == dev
    if dev.type in ("cuda", "cpu"):  # the flags are cheaper than .device
        flag = f"is_{dev.type}"
        return lambda t: getattr(t, flag)
    return lambda t: t.device.type == dev.type


def on_device(device, **tensors) -> torch.device:
    """``torch.device(device)`` after checking that every tensor lies there
    (a device without an index matches any index of its type).  Every
    kernel wrapper calls it on every launch, so the device and its test
    are built once per distinct ``device`` argument."""
    hit = _DEVICES.get(device)
    if hit is None:
        dev = torch.device(device)
        hit = _DEVICES[device] = (dev, _device_test(dev))
    dev, test = hit
    for name, t in tensors.items():
        if t is not None and not test(t):
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


# --- the GMRES basis products ---------------------------------------------

def _addcmul_rounds_once() -> bool:
    """Whether ``Tensor.addcmul_`` on the CPU rounds ``c + a * b`` once, as
    a fused multiply-add: true where torch's CPU kernels are built with FMA
    contraction (checked against :func:`fma_axpy_plain`, which is exact,
    on operands where the two roundings differ, in the vector body and in
    the scalar tail)."""
    gen = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(4099, dtype=torch.float64, generator=gen)
               for _ in range(3))
    fused = fma_axpy_plain(a, b, c)
    if torch.equal(fused, c + a * b):
        return False  # the probe would not tell the two apart
    return (torch.equal(c.clone().addcmul_(a, b), fused)
            and torch.equal(c[:7].clone().addcmul_(a[:7], b[:7]), fused[:7]))


def fma_into(acc: torch.Tensor):
    """A callable ``f(a, b)`` that sets ``acc = fma(a, b, acc)`` in place
    (``a``, ``b`` broadcast), rounded once: ``acc.addcmul_`` for CPU
    tensors where the host's torch fuses it (checked once per process),
    else the exact emulation of :func:`fma_axpy_plain`."""
    fused = _BOUND.get("addcmul_fma")
    if fused is None:
        fused = _BOUND["addcmul_fma"] = _addcmul_rounds_once()
    if fused and acc.device.type == "cpu":
        return acc.addcmul_
    return lambda a, b: acc.copy_(fma_axpy_plain(a, b, acc))


def _check_rows(V, rows: int):
    if not 0 < rows <= V.shape[0]:
        raise ValueError(f"rows must be in [1, {V.shape[0]}], got {rows}")


def gemv_rows_ref_plain(V: torch.Tensor, w: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Plain version of :func:`gemv_rows_ref`: the four lane chains of
    every row stepped together, one fused step (:func:`fma_into`) per
    four elements, then the lane sum and the tail."""
    _check_rows(V, rows)
    n = V.shape[1]
    m = n - n % GEMV_LANES
    steps = V[:rows, :m].reshape(rows, m // GEMV_LANES, GEMV_LANES)
    steps = steps.transpose(0, 1).contiguous().unbind(0)
    acc = torch.zeros(rows, GEMV_LANES, dtype=V.dtype, device=V.device)
    step = fma_into(acc)
    for vk, wk in zip(steps, w[:m].reshape(-1, GEMV_LANES).unbind(0)):
        step(vk, wk)
    tail = torch.zeros(rows, dtype=V.dtype, device=V.device)
    step = fma_into(tail)
    for k in range(m, n):
        step(V[:rows, k], w[k])
    return ((acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])) + tail


def gemv_rows_ref(V: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """``V[:rows] @ w`` of a contiguous ``(R, n)`` f64 basis and an
    ``(n,)`` f64 vector, as a ``(rows,)`` tensor on their device, rounded
    as the reference's jitted ``V @ w``."""
    if V.device.type == "cpu":
        return gemv_rows_ref_plain(V, w, rows)
    dev = V.device
    if dev.type != "cuda":
        raise ValueError(f"gemv_rows_ref runs on cuda or cpu, not {dev}")
    _check(V, "V", dev, 2)
    _check(w, "w", dev, 1)
    _check_rows(V, rows)
    if w.shape[0] != V.shape[1]:
        raise ValueError(f"length mismatch: V has {V.shape[1]} columns, "
                         f"w {w.shape[0]} entries")
    out = torch.empty(rows, dtype=torch.float64, device=dev)
    rc = _fn("gemv_rows_ref_f64")(V.data_ptr(), w.data_ptr(), V.shape[1],
                                  rows, out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    gemv_rows_ref.launches += 1
    _raise_on(rc, "gemv_rows_ref_f64")
    return out


def gemv_cols_ref_plain(c: torch.Tensor, V: torch.Tensor, rows: int,
                        addend: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`gemv_cols_ref`: the column chains stepped
    together down the rows, one fused step (:func:`fma_into`) per row."""
    _check_rows(V, rows)
    n = V.shape[1]
    if addend is None:
        acc = torch.zeros(n, dtype=V.dtype, device=V.device)
    else:
        acc = addend.clone()
    step = fma_into(acc)
    for ci, vi in zip(c[:rows].unbind(0), V[:rows].unbind(0)):
        step(ci, vi)
    if n % GEMV_LANES == 1 and addend is None:  # XLA's scalar tail column
        col = V[:rows, n - 1]
        t = c[0] * col[0]
        for i in range(1, min(rows, _HEAD)):
            t = t + c[i] * col[i]
        step = fma_into(t)
        for i in range(_HEAD, rows):
            step(c[i], col[i])
        acc[n - 1] = t
    return acc


def gemv_cols_ref(c: torch.Tensor, V: torch.Tensor, rows: int,
                  addend: torch.Tensor | None = None) -> torch.Tensor:
    """``c[:rows] @ V[:rows]`` (plus ``addend``, fused as the reference's
    ``x + y @ V`` fuses it) of an f64 ``(>= rows,)`` vector and a
    contiguous ``(R, n)`` f64 basis, as an ``(n,)`` tensor on their device,
    rounded as the reference's jitted product."""
    if V.device.type == "cpu":
        return gemv_cols_ref_plain(c, V, rows, addend)
    dev = V.device
    if dev.type != "cuda":
        raise ValueError(f"gemv_cols_ref runs on cuda or cpu, not {dev}")
    _check(V, "V", dev, 2)
    _check(c, "c", dev, 1)
    _check_rows(V, rows)
    if c.shape[0] < rows:
        raise ValueError(f"c has {c.shape[0]} entries, rows is {rows}")
    n = V.shape[1]
    if addend is not None:
        _check(addend, "addend", dev, 1)
        if addend.shape[0] != n:
            raise ValueError(f"addend has {addend.shape[0]} entries, V {n} "
                             "columns")
    out = torch.empty(n, dtype=torch.float64, device=dev)
    rc = _fn("gemv_cols_ref_f64")(
        c.data_ptr(), V.data_ptr(),
        addend.data_ptr() if addend is not None else None, n, rows,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    gemv_cols_ref.launches += 1
    _raise_on(rc, "gemv_cols_ref_f64")
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


def chain_latency(op: str, n: int = 1 << 22, reps: int = 3) -> dict:
    """One dependent FP64 chain of ``n`` steps from registers on the card
    (one thread): ``op`` "add" (``__dadd_rn``, the f64 SpMV rows' chain)
    or "fma" (``__fma_rn``, ``seq_dot``'s).  Returns the fastest of
    ``reps`` runs as ``ns`` per step (CUDA events around one launch) and
    ``clocks`` per step (the SM's clock64).  A measurement, not a kernel
    of any path; there is no CPU version."""
    if op not in ("add", "fma"):
        raise ValueError(f"op must be 'add' or 'fma', got {op!r}")
    if n <= 0 or n % 8:
        raise ValueError(f"n must be a positive multiple of 8, got {n}")
    if not torch.cuda.is_available():
        raise RuntimeError("chain_latency measures the card: no CUDA device")
    out = torch.empty(2, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream()
    best = None
    for _ in range(reps + 1):  # the first run loads the module
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = _fn("chain_probe_f64")(0 if op == "add" else 1, n,
                                    0.999999999, 1e-3, out.data_ptr(),
                                    stream.cuda_stream)
        end.record()
        _raise_on(rc, "chain_probe_f64")
        end.synchronize()
        ns = start.elapsed_time(end) * 1e6 / n
        clocks = float(out[1]) / n
        if best is None or ns < best["ns"]:
            best = {"ns": ns, "clocks": clocks}
    return best


KERNELS = (seq_dot, fma_axpy, seq_dot_cols, fma_axpy_cols, gemv_rows_ref,
           gemv_cols_ref)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
