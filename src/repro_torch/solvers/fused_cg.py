"""Fused stepped-CG iteration over a GSE-SEM CSR or SELL-C-sigma operand.

Port of ``repro/solvers/fused_cg.py``: ``fused_cg_step``,
``fused_cg_step_g`` (:37-101) and ``gse_matvec`` (:169).

One CG iteration is one SpMV plus two dots, two axpys and one xpby.  The
reference picks one of three tag-specialized branches with
``lax.switch``; here the precision tag stays a device tensor and the
SpMV kernel (A64 over a ``GSECSR``, B64 over a ``GSESellC``; bitwise
alike) branches on it itself, so a step never syncs.  The
operations run in the order of the reference's ``_step_at_tag`` and
round as XLA rounds them there (``kernels.vec_f64``: FMA-chain dots and
FMA updates), so the iterates are bitwise the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.vec_f64 import fma_axpy, seq_dot
from repro_torch.sparse.spmv import spmv_gse

__all__ = ["cg_update", "fused_cg_step", "fused_cg_step_g", "gse_matvec"]


def cg_update(x, r, p, rs, ap):
    """The CG recurrence around one product ``ap = A @ p``, in the
    reference's order; returns ``(x', r', p', rs', denom)``.  The generic-
    operator loop of ``solvers.cg`` runs the same function."""
    denom = seq_dot(p, ap)
    alpha = rs / torch.where(denom == 0, 1.0, denom)
    x2 = fma_axpy(alpha, p, x)
    r2 = fma_axpy(-alpha, ap, r)
    rs2 = seq_dot(r2, r2)
    beta = rs2 / torch.where(rs == 0, 1.0, rs)
    p2 = fma_axpy(beta, p, r2)
    return x2, r2, p2, rs2, denom


def _step_at_tag(a, x, r, p, rs, tag, with_denom=False):
    """One CG iteration at the (device) precision ``tag``."""
    out = cg_update(x, r, p, rs, spmv_gse(a, p, tag))
    return out if with_denom else out[:4]


def fused_cg_step(a, x, r, p, rs, tag):
    """CG iteration with precision ``tag`` in {1, 2, 3} (int or device
    int32 tensor).  Returns ``(x', r', p', rs')`` with ``rs' = r'.r'``."""
    return _step_at_tag(a, x, r, p, rs, tag)


def fused_cg_step_g(a, x, r, p, rs, tag):
    """``fused_cg_step`` that also returns the curvature ``denom = p.Ap``
    the guards check for breakdown -- same operations, same order."""
    return _step_at_tag(a, x, r, p, rs, tag, with_denom=True)


def gse_matvec(a, x, tag):
    """Tag-dispatched ``A @ x`` over a ``GSECSR`` or ``GSESellC`` operand
    (initial residual, checks); ``spmv_gse`` dispatches on the layout."""
    return spmv_gse(a, x, tag)
