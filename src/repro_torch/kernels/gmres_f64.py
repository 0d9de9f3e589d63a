"""The stepped GMRES loop's small f64 kernels, hand-written for Hopper.

Restarted GMRES (``solvers/gmres.py``; the reference is
``repro/solvers/gmres.py``) keeps a small least-squares problem beside its
Krylov basis: the Hessenberg column of each inner iteration is rotated by
the earlier Givens rotations, a new rotation zeroes its subdiagonal, and
each restart cycle ends with a back substitution on the triangle.  The
reference runs both as XLA scalar code (the rotations) and a LAPACK call
(the solve); their rounding feeds every later cycle, so the two kernels of
``csrc/gmres_f64.cu`` round as the reference does on its CPU build:

* :func:`givens_step` -- one inner iteration's rotations
  (``gmres.py:154-170``).  XLA contracts ``cs*a + sn*b`` into
  ``fma(cs, a, sn*b)`` and ``-sn*a + cs*b`` into ``fma(cs, b, -(sn*a))``,
  rewrites ``(a/scale)/dn`` in ``_givens`` as ``a / (dn*scale)``, and
  forms the rotation's root as ``sqrt(fma(an, an, bn*bn))`` (read from the
  jitted reference's dumped HLO and object code).  One thread runs the
  O(restart) recurrence in place, gated by the iteration's device flag
  ``active``, so the loop never syncs to run it.
* :func:`trsv_upper_ref` -- the cycle's ``solve_triangular`` on the padded
  ``restart x restart`` triangle (``gmres.py:210-219``).  XLA's CPU build
  calls LAPACK's ``dtrsm`` from the BLAS SciPy ships (OpenBLAS, on an
  AVX-512 host its SkylakeX kernels), which solves in blocks of
  :data:`TRSM_BLOCK` = 16 rows from the bottom (a leftover block of each
  power of two below 16 first): each block first subtracts its product
  with the solved rows below (per row, one FMA chain from 0.0 in column
  order, subtracted once), then solves itself by multiplying with the
  reciprocal of the diagonal and updating the rows above with FMAs.  One
  thread runs it, a few microseconds once per cycle.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version, the same steps on Python floats with the C library's
correctly rounded ``fma``, only for CPU tensors.  Each counts its launches
in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vec_f64 import _check, _libm_fma, _raise_on

__all__ = ["givens", "givens_step", "givens_step_plain", "trsv_upper_ref",
           "trsv_upper_ref_plain", "TRSM_BLOCK", "KERNELS",
           "reset_launch_counts"]

TRSM_BLOCK = 16  # OpenBLAS's dtrsm unroll (DGEMM_UNROLL_M) on SkylakeX

_P = ctypes.c_void_p
_ARGTYPES = {
    "givens_step_f64": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                        ctypes.c_int, _P],
    "trsv_upper_ref_f64": [_P, _P, _P, ctypes.c_int, _P, _P],
}
_BOUND = {}


def _fn(name: str):
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(_build.load("gmres_f64"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


# --- the rotations -----------------------------------------------------------

def givens(a: float, b: float, fma=None):
    """The reference's ``_givens(a, b)`` on Python floats, as XLA's CPU
    build rounds it: ``(c, s, d)`` with ``d = hypot(a, b)`` computed from
    the operands scaled by ``max(|a|, |b|)`` (the identity rotation when
    that is zero or NaN)."""
    fma = fma or _libm_fma()
    m = a + b if (a != a or b != b) else max(abs(a), abs(b))
    safe = m > 0
    scale = m if safe else 1.0
    an = a / scale
    bn = b / scale
    d = _sqrt(fma(an, an, bn * bn)) * scale
    return (a / d, b / d, d) if safe else (1.0, 0.0, d)


def _sqrt(v: float) -> float:
    return math.sqrt(v) if v >= 0 else math.nan


def givens_step_plain(h, hj1, cs, sn, g, H, resid, active, j: int):
    """Plain version of :func:`givens_step`, in place on CPU tensors."""
    if not bool(active):
        return
    fma = _libm_fma()
    restart = cs.shape[0]
    col = h.tolist() + [0.0] * (restart + 1 - h.shape[0])
    col[j + 1] = float(hj1)
    csl, snl = cs.tolist(), sn.tolist()
    for i in range(j):
        a, b = col[i], col[i + 1]
        t1 = fma(csl[i], a, snl[i] * b)
        t2 = fma(csl[i], b, -(snl[i] * a))
        col[i] = t1 + 0.0 * a
        col[i + 1] = t2 + 0.0 * b
    for i in range(j, restart + 1):
        col[i] = col[i] + 0.0
    c, s, d = givens(col[j], col[j + 1], fma)
    col[j] = d
    col[j + 1] = 0.0
    gj = float(g[j])
    g1 = -s * gj
    cs[j] = c
    sn[j] = s
    g[j + 1] = g1
    g[j] = c * gj
    H[:, j] = torch.tensor(col, dtype=H.dtype)
    resid.fill_(abs(g1))


def givens_step(h, hj1, cs, sn, g, H, resid, active, j: int):
    """One inner iteration's least-squares update, in place and only where
    the 0-d bool ``active`` is true (nothing is written otherwise).

    ``h`` holds the Gram-Schmidt coefficients of basis vector ``j + 1``
    (at least ``j + 1`` entries), ``hj1`` its norm.  The Hessenberg column
    ``[h[:j+1], hj1, 0...]`` is rotated by rotations ``0..j-1`` (``cs``,
    ``sn``), rotation ``j`` is formed to zero its subdiagonal and stored,
    the column is written to ``H[:, j]``, ``g[j], g[j+1]`` are rotated and
    ``resid = |g[j+1]|``.  Shapes: ``cs, sn (restart,)``, ``g
    (restart + 1,)``, ``H (restart + 1, restart)`` row-major, ``resid``
    0-d; all f64."""
    if h.device.type == "cpu":
        return givens_step_plain(h, hj1, cs, sn, g, H, resid, active, j)
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"givens_step runs on cuda or cpu, not {dev}")
    restart = cs.shape[0]
    if not 0 <= j < restart or h.shape[0] < j + 1:
        raise ValueError(f"j={j} out of range for restart {restart} and "
                         f"{h.shape[0]} coefficients")
    for name, t, n in (("h", h, None), ("cs", cs, restart),
                       ("sn", sn, restart), ("g", g, restart + 1)):
        _check(t, name, dev, 1)
        if n is not None and t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")
    _check(H, "H", dev, 2)
    if tuple(H.shape) != (restart + 1, restart):
        raise ValueError(f"H has shape {tuple(H.shape)}, expected "
                         f"({restart + 1}, {restart})")
    _check(hj1.reshape(1), "hj1", dev, 1)
    _check(resid.reshape(1), "resid", dev, 1)
    if active.dtype != torch.bool or active.device != dev:
        raise ValueError("active must be a bool tensor on the card")
    rc = _fn("givens_step_f64")(h.data_ptr(), hj1.data_ptr(), cs.data_ptr(),
                                sn.data_ptr(), g.data_ptr(), H.data_ptr(),
                                resid.data_ptr(), active.data_ptr(), j,
                                restart,
                                torch.cuda.current_stream(dev).cuda_stream)
    givens_step.launches += 1
    _raise_on(rc, "givens_step_f64")


# --- the back substitution ---------------------------------------------------

def _trsm_blocks(n: int):
    """``(lo, hi)`` row blocks in OpenBLAS's solve order: the leftover
    blocks (each power of two below the unroll present in ``n``, smallest
    first) from the bottom, then whole blocks upwards."""
    blocks, top, i = [], n, 1
    while i < TRSM_BLOCK:
        if n % TRSM_BLOCK & i:
            blocks.append((top - i, top))
            top -= i
        i *= 2
    while top > 0:
        blocks.append((top - TRSM_BLOCK, top))
        top -= TRSM_BLOCK
    return blocks


def trsv_upper_ref_plain(H, g, j) -> torch.Tensor:
    """Plain version of :func:`trsv_upper_ref` on CPU tensors."""
    fma = _libm_fma()
    restart = H.shape[1]
    jj = int(j)
    R = [[0.0] * restart for _ in range(restart)]
    Hl = H.tolist()
    for i in range(restart):
        for k in range(restart):
            live = i < jj and k < jj
            R[i][k] = Hl[i][k] if live else (1.0 if i == k else 0.0)
        if R[i][i] == 0.0:
            R[i][i] = 1.0
    gl = g.tolist()
    b = [gl[i] if i < jj else 0.0 for i in range(restart)]
    y = [0.0] * restart
    for lo, hi in _trsm_blocks(restart):
        if hi < restart:  # subtract the product with the solved rows below
            for i in range(lo, hi):
                acc = 0.0
                for k in range(hi, restart):
                    acc = fma(R[i][k], y[k], acc)
                b[i] = b[i] - acc
        for k in range(hi - 1, lo - 1, -1):
            y[k] = b[k] * (1.0 / R[k][k])
            for i in range(lo, k):
                b[i] = fma(-y[k], R[i][k], b[i])
    return torch.tensor(y, dtype=torch.float64)


def trsv_upper_ref(H, g, j) -> torch.Tensor:
    """The reference's back substitution ``y = solve_triangular(Rm, gm)``
    for a cycle of ``j`` inner iterations: ``Rm`` is ``H[:restart,
    :restart]`` on its leading ``j x j`` block and the identity elsewhere
    (a zero diagonal entry replaced by 1), ``gm`` is ``g[:j]`` padded with
    zeros.  ``j`` is a 0-d int32 tensor on the device (or an int); the
    result is a ``(restart,)`` f64 tensor, rounded as the reference's
    LAPACK call."""
    if H.device.type == "cpu":
        return trsv_upper_ref_plain(H, g, j)
    dev = H.device
    if dev.type != "cuda":
        raise ValueError(f"trsv_upper_ref runs on cuda or cpu, not {dev}")
    _check(H, "H", dev, 2)
    _check(g, "g", dev, 1)
    restart = H.shape[1]
    if H.shape[0] != restart + 1 or g.shape[0] != restart + 1:
        raise ValueError(f"H {tuple(H.shape)} and g {tuple(g.shape)} do not "
                         f"fit restart {restart}")
    if not isinstance(j, torch.Tensor):
        j = torch.full((), int(j), dtype=torch.int32, device=dev)
    if j.dtype != torch.int32 or j.device != dev:
        raise ValueError("j must be an int32 tensor on the card")
    y = torch.empty(restart, dtype=torch.float64, device=dev)
    scratch = torch.empty(restart, dtype=torch.float64, device=dev)
    rc = _fn("trsv_upper_ref_f64")(H.data_ptr(), g.data_ptr(), j.data_ptr(),
                                   restart, y.data_ptr(),
                                   scratch.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    trsv_upper_ref.launches += 1
    _raise_on(rc, "trsv_upper_ref_f64")
    return y


KERNELS = (givens_step, trsv_upper_ref)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
