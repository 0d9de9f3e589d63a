"""Linear-operator factories with precision-tag dispatch (paper Alg. 3).

Port of ``repro/solvers/operators.py``: ``make_gse_operator`` and
``make_fixed_operator``.  An operator is ``apply(x, tag) -> A @ x``
where ``tag`` is an int or a device int32 tensor in {1, 2, 3}; fixed-
format baselines ignore the tag.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sparse.csr import CSR
from repro_torch.sparse.spmv import spmv, spmv_gse

__all__ = ["make_gse_operator", "make_fixed_operator"]


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
