"""Linear-operator factories with precision-tag dispatch (paper Alg. 3).

Port of ``repro/solvers/operators.py``: ``make_gse_operator``,
``make_fixed_operator``, ``make_dense_operator`` (:56) and
``make_precond_operator`` (:64).  An operator is ``apply(x, tag) -> A @ x``
where ``tag`` is an int or a device int32 tensor in {1, 2, 3}; fixed-
format and dense baselines ignore the tag.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.vec_f64 import gemv_rows_ref
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.spmv import spmv, spmv_gse

__all__ = ["make_gse_operator", "make_fixed_operator", "make_dense_operator",
           "make_precond_operator"]


def make_gse_operator(a) -> Callable:
    """Three-precision f64 operator over one stored copy (the paper's
    A1/A2/A3); ``a`` is a ``GSECSR`` or a SELL-C-sigma ``GSESellC``, and
    the SpMV kernel picks the tag on the device."""

    def apply(x, tag):
        return spmv_gse(a, x, tag)

    return apply


def make_fixed_operator(a: CSR, store_dtype=torch.float64,
                        acc_dtype=torch.float64) -> Callable:
    """FP64/FP32/BF16/FP16 baseline: storage precision fixed, acc high."""

    def apply(x, tag):
        del tag
        return spmv(a, x, store_dtype=store_dtype, acc_dtype=acc_dtype)

    return apply


def make_dense_operator(mat: torch.Tensor) -> Callable:
    """A dense f64 ``(m, n)`` matrix as an operator: ``mat @ x``, rounded
    as the reference's jitted ``mat @ x`` (``vec_f64.gemv_rows_ref``)."""
    mat = mat.contiguous()

    def apply(x, tag):
        del tag
        return gemv_rows_ref(mat, x, mat.shape[0])

    return apply


def make_precond_operator(m) -> Callable:
    """``apply_m(r, tag) = M^{-1} r`` over a
    :mod:`repro_torch.solvers.precond` preconditioner -- the
    preconditioner-side twin of :func:`make_gse_operator` (one stored
    copy, three apply precisions, the tag read on the device)."""

    def apply(r, tag):
        return m.apply(r, tag)

    return apply
