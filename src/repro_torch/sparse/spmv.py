"""SpMV operators (paper Section III.C.2): fixed-dtype baselines and the
three GSE-SEM tags.

Port of ``repro/sparse/spmv.py``: ``spmv`` (:32), ``_decode_gsecsr``
(:40), ``decode_gsecsr``, ``_sell_csr_segments`` (:81),
``decode_operand`` (:97), ``spmv_gse`` (:128, with its ``GSESellC``
branch :122/:147), ``spmv_ell`` (:156), and the multi-RHS twins ``spmm``
(:170, with ``_spmm_cast`` :164) and ``spmm_gse`` (:204, with its
``GSESellC`` branch :198/:220).  Values are stored at the target
precision and multiplied and summed in f64.

``spmv_gse`` is the f64 operator of the stepped solvers.  It runs the
hand-written CUDA kernel A64 (``kernels.gse_spmv.gse_spmv_csr_f64``) on
the card; for CPU tensors the kernel's plain version runs instead.  Both
sum each row sequentially in CSR order from 0.0, which is bitwise what
the reference ``_decode_gsecsr`` + ``segment_sum`` computes.
``spmm_gse`` runs kernel C64 (``kernels.gse_spmm.gse_spmm_csr_f64``) the
same way; its column j is bitwise ``spmv_gse`` on column j.  Over a
SELL-C-sigma ``GSESellC`` they run kernels B64 and C′64
(``gse_spmv_sell_f64``, ``gse_spmm_sell_f64``), which walk each row's
real slots in CSR order: bitwise the ``GSECSR`` result on the same
operator, as the reference's gather back to CSR order makes it.
"""
from __future__ import annotations

import torch

from repro_torch.core.gse import _pow2_exact
from repro_torch.sparse.csr import CSR, GSECSR, GSESellC

__all__ = ["spmv", "spmv_gse", "spmv_ell", "spmm", "spmm_gse",
           "decode_gsecsr", "decode_operand"]


def spmv(a: CSR, x: torch.Tensor, store_dtype=torch.float64,
         acc_dtype=torch.float64) -> torch.Tensor:
    """y = A @ x with values stored at ``store_dtype`` (paper's baselines)."""
    v = a.val.to(store_dtype).to(acc_dtype)  # storage round-trip
    prod = v * x.to(acc_dtype)[a.col.long()]
    y = torch.zeros(a.shape[0], dtype=acc_dtype, device=prod.device)
    return y.index_add_(0, a.row_ids.long(), prod)


def _decode_gsecsr(colpak, head, tail1, tail2, table, ei_bit: int, tag: int,
                   acc_dtype=torch.float64):
    """Decode GSE-SEM CSR values to ``acc_dtype`` (15-bit-head layout).

    Returns ``(values, columns)``.  The operation order is the
    reference's: the tag-3 mantissa is ``m_head*2^48 + tail1*2^32 +
    tail2`` left to right, and the scale is applied as two exact
    power-of-two factors.
    """
    shift = 32 - ei_bit
    cp = colpak.to(torch.int64)
    exp_idx = cp >> shift
    h = head.to(torch.int64)
    sign = (h >> 15) & 0x1
    m_head = (h & 0x7FFF).to(acc_dtype)
    if tag == 1:
        mant = m_head
        bits_used = 15
    elif tag == 2:
        mant = m_head * 65536.0 + tail1.to(torch.int64).to(acc_dtype)
        bits_used = 31
    elif tag == 3:
        mant = (
            m_head * float(2.0**48)
            + tail1.to(torch.int64).to(acc_dtype) * float(2.0**32)
            + tail2.to(torch.int64).to(acc_dtype)
        )
        bits_used = 63
    else:
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    e_sh = table.to(torch.int32)[exp_idx] - 1023
    pow_ = e_sh - bits_used
    half = torch.div(pow_, 2, rounding_mode="floor")
    sgn = 1.0 - 2.0 * sign.to(acc_dtype)
    val = sgn * ((mant * _pow2_exact(half, acc_dtype))
                 * _pow2_exact(pow_ - half, acc_dtype))
    return val, cp & ((1 << shift) - 1)


def decode_gsecsr(a: GSECSR, tag: int, acc_dtype=torch.float64):
    """(values, columns) decoded from a GSE-SEM CSR at precision ``tag``."""
    return _decode_gsecsr(a.colpak, a.head, a.tail1, a.tail2, a.table,
                          a.ei_bit, tag, acc_dtype)


def _sell_csr_segments(a: GSESellC):
    """CSR-order ``(colpak, head, tail1, tail2)`` gathered out of the flat
    SELL bucket arrays: bit for bit the ``GSECSR`` segments."""
    g = a.gather.to(torch.int64)
    return tuple(flat[g] for flat in a.segments)


def decode_operand(a, tag: int, acc_dtype=torch.float64):
    """CSR-order ``(values, columns)`` decode of a ``GSECSR`` or a packed
    ``GSESellC`` at precision ``tag``."""
    if isinstance(a, GSESellC):
        cp, hd, t1, t2 = _sell_csr_segments(a)
        return _decode_gsecsr(cp, hd, t1, t2, a.table, a.ei_bit, tag,
                              acc_dtype)
    if not isinstance(a, GSECSR):
        raise NotImplementedError(
            f"decode_operand takes a GSECSR or a GSESellC; "
            f"{type(a).__name__} operands (sharded) are not ported yet "
            "(ROADMAP queue 1 item 15)")
    return decode_gsecsr(a, tag, acc_dtype)


def spmv_gse(a, x: torch.Tensor, tag=1) -> torch.Tensor:
    """Paper Algorithm 2 (+tails): f64 GSE-SEM SpMV at precision ``tag``.

    ``a`` is a ``GSECSR`` (kernel A64) or a SELL-C-sigma ``GSESellC``
    (kernel B64); the two give the same bits and differ only in what the
    byte model charges (``a.bytes_touched(tag)``: nnz only for ``GSECSR``,
    actual padded slots for ``GSESellC``).  ``tag`` is an int or an int32
    tensor on ``a``'s device; the kernel reads a device tag itself, so the
    stepped solver loop passes its monitor's tag without a host sync.
    """
    # Imported here: the kernel module imports this one's decode.
    from repro_torch.kernels.gse_spmv import (gse_spmv_csr_f64,
                                              gse_spmv_sell_f64)

    if x.shape != (a.shape[1],):
        raise ValueError(f"x has shape {tuple(x.shape)}, the operand "
                         f"{a.shape[1]} columns")
    if isinstance(a, GSESellC):
        return gse_spmv_sell_f64(
            *a.segments, a.table, x, a.bucket_table, a.perm, a.row_len,
            rows=a.shape[0], ei_bit=a.ei_bit, tag=tag,
            long_from=a.long_from)
    return gse_spmv_csr_f64(a.rowptr, a.colpak, a.head, a.tail1, a.tail2,
                            a.table, x, ei_bit=a.ei_bit, tag=tag)


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             acc_dtype=torch.float64) -> torch.Tensor:
    """Padded-ELL SpMV over dense (rows, L) arrays."""
    prod = vals.to(acc_dtype) * x.to(acc_dtype)[cols.long()]
    return torch.sum(prod, dim=1)


def spmm(a: CSR, x: torch.Tensor, store_dtype=torch.float64,
         acc_dtype=torch.float64) -> torch.Tensor:
    """Y = A @ X for a dense ``(n, nrhs)`` block (fixed-format baselines):
    the value and colidx streams serve every column; column j is
    :func:`spmv` on column j (the same gather and row reduction)."""
    if x.dim() != 2:
        raise ValueError(f"spmm wants a (n, nrhs) block; got {tuple(x.shape)}")
    v = a.val.to(store_dtype).to(acc_dtype)  # storage round-trip
    prod = v[:, None] * x.to(acc_dtype)[a.col.long()]  # (nnz, nrhs)
    y = torch.zeros(a.shape[0], x.shape[1], dtype=acc_dtype,
                    device=prod.device)
    return y.index_add_(0, a.row_ids.long(), prod)


def spmm_gse(a, x: torch.Tensor, tag=1) -> torch.Tensor:
    """GSE-SEM SpMM at precision ``tag``: Y = A @ X, X dense ``(n, nrhs)``,
    in f64 on ``a``'s device.

    One decoded-value pass feeds every column, so the modeled matrix
    traffic is ``a.bytes_touched(tag)`` once per call however many
    right-hand sides ride along (``csr.iteration_stream_bytes(...,
    nrhs=)``).  ``tag`` is an int, an int32 tensor on ``a``'s device, or an
    ``(nrhs,)`` int32 tensor of per-column tags; column j is bitwise
    ``spmv_gse(a, x[:, j], tag_j)``.  ``a`` is a ``GSECSR`` (kernel C64) or
    a ``GSESellC`` (kernel C′64), bitwise alike.
    """
    from repro_torch.kernels.gse_spmm import (gse_spmm_csr_f64,
                                              gse_spmm_sell_f64)

    if not isinstance(a, (GSECSR, GSESellC)):
        raise NotImplementedError(
            f"spmm_gse takes a GSECSR or a GSESellC; {type(a).__name__} "
            "operands (sharded) are not ported yet (ROADMAP queue 1 item 15)")
    if x.dim() != 2:
        raise ValueError(f"spmm_gse wants a (n, nrhs) block; got "
                         f"{tuple(x.shape)}")
    if x.shape[0] != a.shape[1]:
        raise ValueError(f"x has {x.shape[0]} rows, the operand "
                         f"{a.shape[1]} columns")
    dev = a.device
    nrhs = x.shape[1]
    tags = torch.as_tensor(tag, dtype=torch.int32, device=dev)
    tags = tags.expand(nrhs).contiguous() if tags.dim() == 0 else tags
    active = torch.ones(nrhs, dtype=torch.bool, device=dev)
    xt = x.to(torch.float64).t().contiguous()
    if isinstance(a, GSESellC):
        return gse_spmm_sell_f64(*a.segments, a.table, xt, tags, active,
                                 a.bucket_table, a.perm, a.row_len,
                                 rows=a.shape[0], ei_bit=a.ei_bit,
                                 device=dev).t()
    y = gse_spmm_csr_f64(a.rowptr, a.colpak, a.head, a.tail1, a.tail2,
                         a.table, xt, tags, active, ei_bit=a.ei_bit,
                         device=dev)
    return y.t()
