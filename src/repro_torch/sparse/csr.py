"""Sparse matrix containers: CSR and GSE-SEM CSR.

Port of ``repro/sparse/csr.py``: ``CSR``, ``GSECSR``, ``from_coo``
(:346), ``pack_csr`` (:372), ``scatter_rows`` (:482), ``to_ell`` (:528),
the byte models ``bytes_per_nnz``/``bytes_touched``/``nbytes``,
``vector_stream_bytes`` and ``iteration_stream_bytes`` (int tags only;
the preconditioner and SELL/ELL-layout accounts arrive with PCG and
SELL).

Paper Section III.C.1: shared-exponent indices ride the top ``EI_BIT``
bits of the 32-bit column indices, so the SEM head keeps all 15 non-sign
bits as mantissa.  Packing runs on the host in numpy (bit-for-bit the
reference packer); the containers hold torch tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import gse, precision_table

__all__ = [
    "CSR",
    "GSECSR",
    "from_coo",
    "pack_csr",
    "to_ell",
    "scatter_rows",
    "iteration_stream_bytes",
    "vector_stream_bytes",
]


@dataclasses.dataclass
class CSR:
    rowptr: torch.Tensor   # (m+1,) int32
    col: torch.Tensor      # (nnz,) int32
    val: torch.Tensor      # (nnz,) float64
    row_ids: torch.Tensor  # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.val.device

    def bytes_per_nnz(self, store_dtype=torch.float64) -> int:
        """Modeled bytes streamed per nonzero by one SpMV: value + colidx."""
        return store_dtype.itemsize + 4

    def bytes_touched(self, store_dtype=torch.float64) -> int:
        """Modeled HBM bytes one SpMV touches in the matrix streams:
        value + colidx per nnz plus the rowptr stream (dense x/y traffic
        is format-independent and excluded)."""
        return self.nnz * self.bytes_per_nnz(store_dtype) + int(self.rowptr.numel()) * 4


@dataclasses.dataclass
class GSECSR:
    """CSR with GSE-SEM values; expIdx lives in the top bits of ``colpak``."""

    rowptr: torch.Tensor   # (m+1,) int32
    colpak: torch.Tensor   # (nnz,) uint32: [expIdx : EI_BIT][col : 32-EI_BIT]
    head: torch.Tensor     # (nnz,) uint16: sign(1) | mantissa(15)
    tail1: torch.Tensor    # (nnz,) uint16
    tail2: torch.Tensor    # (nnz,) uint32
    table: torch.Tensor    # (k,) int32 biased+1
    row_ids: torch.Tensor  # (nnz,) int32
    ei_bit: int
    shape: Tuple[int, int]

    @property
    def m_h(self) -> int:
        # colpak carries the index -> the head spends only the sign bit.
        return 15

    @property
    def width(self) -> int:
        return self.m_h + 48

    @property
    def nnz(self) -> int:
        return int(self.colpak.shape[0])

    @property
    def device(self) -> torch.device:
        return self.colpak.device

    def nbytes(self, tag: int) -> int:
        per = precision_table.TAG_VALUE_BYTES[tag]
        return self.nnz * per + int(self.table.numel()) * 4

    def bytes_per_nnz(self, tag: int) -> int:
        """Modeled bytes streamed per nonzero by a tag-``tag`` SpMV:
        2/4/8 value bytes + 4 packed-colidx bytes -> 6/8/12."""
        pt = precision_table
        return pt.TAG_VALUE_BYTES[tag] + pt.COLIDX_BYTES

    def bytes_touched(self, tag: int) -> int:
        """Modeled HBM bytes one tag-``tag`` SpMV touches in the matrix
        streams: per-nnz segments + rowptr + the shared-exponent table.
        Dense x/y traffic is format-independent and excluded."""
        fixed = int(self.rowptr.numel()) * 4 + int(self.table.numel()) * 4
        return self.nnz * self.bytes_per_nnz(tag) + fixed


def from_coo(rows, cols, vals, shape, device="cuda") -> CSR:
    """Build CSR from COO triplets (duplicates summed) on the host."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    m, n = shape
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    # Sum duplicates.
    uniq, idx = np.unique(key, return_index=True)
    sums = np.add.reduceat(vals, idx)
    rows = rows[idx]
    cols = cols[idx]
    rowptr = np.zeros(m + 1, np.int64)
    np.add.at(rowptr, rows + 1, 1)
    rowptr = np.cumsum(rowptr)
    return CSR(
        rowptr=torch.from_numpy(rowptr.astype(np.int32)).to(device),
        col=torch.from_numpy(cols.astype(np.int32)).to(device),
        val=torch.from_numpy(np.ascontiguousarray(sums)).to(device),
        row_ids=torch.from_numpy(rows.astype(np.int32)).to(device),
        shape=(int(m), int(n)),
    )


def pack_csr(a: CSR, k: int = 8) -> GSECSR:
    """CSR -> GSE-SEM CSR (paper Algorithm 1 + Section III.C.1), on the
    device of ``a``.

    The head's 15 non-sign bits are all mantissa: with expIdx in colpak
    the head-only precision gains ``EI_BIT`` bits over the dense layout.
    """
    vals = gse._np(a.val).astype(np.float64)
    table = gse.extract_shared_exponents(vals, k)
    ei = gse._ei_bit(k)
    head, tail1, tail2 = gse._pack_segments(vals, table, k)
    # Recover the full-width mantissa M (width (15-ei)+48) and expIdx.
    head = head.astype(np.uint64)
    m_h_dense = 15 - ei
    sign = (head >> np.uint64(15)) & np.uint64(1)
    exp_idx = (head >> np.uint64(m_h_dense)) & np.uint64((1 << ei) - 1)
    m_dense = (
        ((head & np.uint64((1 << m_h_dense) - 1)) << np.uint64(48))
        | (tail1.astype(np.uint64) << np.uint64(32))
        | tail2.astype(np.uint64)
    )
    # Widen to 15 + 48 = 63 bits: shift left by ei.
    m_wide = m_dense << np.uint64(ei)
    new_head = ((sign << np.uint64(15)) | (m_wide >> np.uint64(48))).astype(np.uint16)
    new_tail1 = ((m_wide >> np.uint64(32)) & np.uint64(0xFFFF)).astype(np.uint16)
    new_tail2 = (m_wide & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    col = gse._np(a.col).astype(np.uint32)
    shift = np.uint32(32 - ei)
    max_col = int(col.max()) if col.size else 0
    if max_col >= (1 << (32 - ei)):
        raise ValueError(
            f"column count {max_col} needs > {32 - ei} bits; "
            "use the value-array encoding variant (paper III.C.1)"
        )
    colpak = (exp_idx.astype(np.uint32) << shift) | col
    dev = a.device
    return GSECSR(
        rowptr=a.rowptr,
        colpak=torch.from_numpy(colpak).to(dev),
        head=torch.from_numpy(new_head).to(dev),
        tail1=torch.from_numpy(new_tail1).to(dev),
        tail2=torch.from_numpy(new_tail2).to(dev),
        table=torch.from_numpy(table.astype(np.int32)).to(dev),
        row_ids=a.row_ids,
        ei_bit=ei,
        shape=a.shape,
    )


def vector_stream_bytes(op, dtype=torch.float64) -> int:
    """Modeled HBM bytes one dense operand/result column streams: the x
    gather read plus the y write of a single SpMV at ``dtype``."""
    m, n = op.shape
    return (m + n) * dtype.itemsize


def iteration_stream_bytes(op, tag, nrhs: int = 1) -> int:
    """Modeled HBM bytes one stepped solver iteration streams at ``tag``.

    The operator's matrix streams (``op.bytes_touched``) are charged once
    per iteration; each right-hand-side column beyond the first charges
    its own dense x/y stream.  ``tag`` may also be a ``CSR`` store dtype.
    """
    if nrhs < 1:
        raise ValueError(f"nrhs must be >= 1, got {nrhs}")
    total = op.bytes_touched(tag)
    total += (nrhs - 1) * vector_stream_bytes(op)
    return total


def scatter_rows(rowptr, sources, width: int, row_subset=None):
    """Scatter CSR-ordered entry streams into zero-padded (rows, width)
    numpy arrays.

    ``sources`` is a sequence of ``(array, dtype)`` pairs sharing the CSR
    entry order; each comes back as its own padded array at the requested
    dtype (padding slots are zero).  ``row_subset`` selects and orders the
    rows to scatter; ``-1`` entries are empty padding rows.

    Returns ``(outs, csr_pos, dest)``: the CSR entry indices scattered and
    their flat slots in the padded array.
    """
    rowptr = np.asarray(gse._np(rowptr), np.int64)
    per_row = np.diff(rowptr)
    if row_subset is None:
        row_subset = np.arange(per_row.size)
    row_subset = np.asarray(row_subset, np.int64)
    valid = row_subset >= 0
    safe = np.where(valid, row_subset, 0)
    lens = np.where(valid, per_row[safe], 0)
    if lens.size and int(lens.max(initial=0)) > width:
        raise ValueError(
            f"row of {int(lens.max())} entries does not fit width {width}"
        )
    total = int(lens.sum())
    starts = np.where(valid, rowptr[safe], 0)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    csr_pos = np.repeat(starts, lens) + offs
    dest = np.repeat(np.arange(row_subset.size, dtype=np.int64) * width,
                     lens) + offs
    outs = []
    for src, dtype in sources:
        out = np.zeros(row_subset.size * width, dtype)
        out[dest] = gse._np(src)[csr_pos]
        outs.append(out.reshape(row_subset.size, width))
    return outs, csr_pos, dest


def to_ell(a: CSR, lane: int = 128):
    """CSR -> padded ELL numpy arrays ``(cols[m, L], vals[m, L], L)``, L
    rounded up to ``lane``; padded entries have col=0, val=0."""
    rowptr = np.asarray(gse._np(a.rowptr), np.int64)
    L = int(max(1, np.diff(rowptr).max(initial=0)))
    L = ((L + lane - 1) // lane) * lane
    (cols, vals), _, _ = scatter_rows(
        rowptr, [(a.col, np.int32), (a.val, np.float64)], L
    )
    return cols, vals, L
