"""GSE-packed preconditioners that ride the operator's tag schedule.

Port of ``repro/solvers/precond.py``: ``DiagGSEPrecond`` (Jacobi,
SPAI-0), ``BlockJacobiGSEPrecond``, ``make_jacobi``, ``make_spai0`` and
``make_block_jacobi``.  The entries of ``M^{-1}`` are packed once and
every apply reads them at the residual monitor's current tag:

* a diagonal ``M^{-1}`` is a dense ``GSEPacked`` vector.  An apply
  decodes it with ``core.gse.decode_jnp`` at f64 and multiplies once, as
  the reference does; the three decodes are made once per preconditioner
  and the device tag picks one row of them (``index_select``), so a
  stepped loop applies it without a host sync;
* block-Jacobi stores the block-diagonal inverse as a ``GSECSR`` and
  applies it through ``spmv_gse`` -- kernel A64, the operator's own SpMV.

The batched PCG loop applies a preconditioner to an ``(nrhs, n)`` block,
column j at its own device tag (``apply_cols``): the diagonal gathers one
decoded row per column, block-Jacobi runs kernel C64 (column j bitwise
A64 at that tag), so column j is bitwise ``apply_at(r[j], tags[j])``.

The host packers build the reference's arrays exactly: the same numpy
operations on the same CSR arrays.  Every preconditioner answers
``bytes_touched(tag)``, the modeled HBM bytes one apply streams, which
``sparse.csr.iteration_stream_bytes`` charges beside the operator's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gse
from repro_torch.kernels.gse_spmm import gse_spmm_csr_f64
from repro_torch.sparse.csr import CSR, GSECSR, from_coo, pack_csr
from repro_torch.sparse.spmv import spmv_gse

__all__ = [
    "DiagGSEPrecond",
    "BlockJacobiGSEPrecond",
    "make_jacobi",
    "make_spai0",
    "make_block_jacobi",
]


def _tag_index(tag, device) -> torch.Tensor:
    """``clip(tag - 1, 0, 2)`` as a one-entry int64 index on ``device``
    (``tag`` an int or a 0-d device tensor; no host sync)."""
    t = torch.as_tensor(tag, device=device)
    return torch.clamp(t.to(torch.int64) - 1, 0, 2).reshape(1)


@dataclasses.dataclass(eq=False)
class DiagGSEPrecond:
    """Diagonal ``M^{-1}`` stored as a dense GSE-SEM vector (one copy,
    three apply precisions)."""

    packed: gse.GSEPacked  # (n,) packed entries of M^{-1}'s diagonal
    kind: str              # "jacobi" | "spai0"

    def _decoded(self) -> torch.Tensor:
        """``(3, n)``: the diagonal decoded at tags 1, 2, 3 (made once)."""
        rows = self.__dict__.get("_rows")
        if rows is None:
            rows = self.__dict__["_rows"] = torch.stack([
                gse.decode_jnp(self.packed, t, torch.float64)
                for t in (1, 2, 3)])
        return rows

    def apply_at(self, r: torch.Tensor, tag) -> torch.Tensor:
        """``z = M^{-1} r`` at ``tag`` (an int or a 0-d device tensor):
        the decoded diagonal times ``r``, one rounding per entry."""
        rows = self._decoded()
        d = rows.index_select(0, _tag_index(tag, rows.device))[0]
        return d * r

    apply = apply_at

    def apply_cols(self, r: torch.Tensor, tags: torch.Tensor, active=None, *,
                   device="cuda") -> torch.Tensor:
        """``z[j] = M^{-1} r[j]`` at ``tags[j]`` for an ``(nrhs, n)`` block
        (``tags`` int32 on the block's device; ``active`` unused: the
        product is elementwise and the loop freezes inactive columns)."""
        del active, device
        rows = self._decoded()
        idx = torch.clamp(tags.to(torch.int64) - 1, 0, 2)
        return rows.index_select(0, idx) * r

    def nbytes(self, tag: int) -> int:
        return self.packed.nbytes(tag)

    def bytes_touched(self, tag: int) -> int:
        """Modeled HBM bytes one tag-``tag`` apply streams for the stored
        preconditioner (the dense r/z traffic is format-independent)."""
        return self.packed.nbytes(tag)


@dataclasses.dataclass(eq=False)
class BlockJacobiGSEPrecond:
    """Block-diagonal ``M^{-1}`` stored as a GSE-SEM CSR; applies through
    the operator's own tag-specialized SpMV (kernel A64)."""

    mat: GSECSR  # block-diagonal inverse, GSE-packed
    block: int

    kind = "block_jacobi"

    def apply_at(self, r: torch.Tensor, tag) -> torch.Tensor:
        """``z = M^{-1} r`` at ``tag`` (an int or a 0-d device tensor)."""
        return spmv_gse(self.mat, r, tag)

    apply = apply_at

    def apply_cols(self, r: torch.Tensor, tags: torch.Tensor, active=None, *,
                   device="cuda") -> torch.Tensor:
        """``z[j] = M^{-1} r[j]`` at ``tags[j]`` for an ``(nrhs, n)``
        block: one C64 launch over the stored inverse (an inactive column
        is not read and comes back 0)."""
        m = self.mat
        if active is None:
            active = torch.ones(r.shape[0], dtype=torch.bool, device=r.device)
        return gse_spmm_csr_f64(m.rowptr, m.colpak, m.head, m.tail1, m.tail2,
                                m.table, r, tags, active, ei_bit=m.ei_bit,
                                plan=m.row_plan, device=device)

    def nbytes(self, tag: int) -> int:
        return self.mat.nbytes(tag)

    def bytes_touched(self, tag: int) -> int:
        return self.mat.bytes_touched(tag)


def _csr_arrays(a: CSR):
    return (gse._np(a.row_ids), gse._np(a.col),
            gse._np(a.val).astype(np.float64))


def _csr_diag(a: CSR) -> np.ndarray:
    """Diagonal of a CSR (missing entries -> 0)."""
    rows, cols, vals = _csr_arrays(a)
    d = np.zeros(a.shape[0], np.float64)
    hit = rows == cols
    d[rows[hit]] = vals[hit]
    return d


def make_jacobi(a: CSR, k: int = 8) -> DiagGSEPrecond:
    """Jacobi: ``M^{-1} = diag(A)^{-1}``, packed once against ``k`` shared
    exponents on ``a``'s device.  Zero diagonal entries fall back to 1."""
    d = _csr_diag(a)
    d_inv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
    return DiagGSEPrecond(packed=gse.pack(d_inv, k, device=a.device),
                          kind="jacobi")


def make_spai0(a: CSR, k: int = 8) -> DiagGSEPrecond:
    """SPAI-0: the diagonal ``M`` minimizing ``||I - M A||_F`` --
    ``m_i = a_ii / ||A_{i,:}||^2``."""
    rows, _, vals = _csr_arrays(a)
    row_sq = np.zeros(a.shape[0], np.float64)
    np.add.at(row_sq, rows, vals * vals)
    d = _csr_diag(a)
    m = np.where(row_sq != 0, d / np.where(row_sq == 0, 1.0, row_sq), 1.0)
    m = np.where(m == 0, 1.0, m)
    return DiagGSEPrecond(packed=gse.pack(m, k, device=a.device),
                          kind="spai0")


def make_block_jacobi(a: CSR, block: int = 4,
                      k: int = 8) -> BlockJacobiGSEPrecond:
    """Block-Jacobi: invert each ``block x block`` diagonal block of A
    (``np.linalg.inv``) and pack the block-diagonal inverse as a
    ``GSECSR`` on ``a``'s device.

    The trailing partial block is padded with identity rows before the
    batched inverse, then the padding is dropped.  Blocks must be
    nonsingular (guaranteed for SPD or strictly diagonally dominant A).
    """
    n = a.shape[0]
    nb = (n + block - 1) // block
    rows, cols, vals = _csr_arrays(a)
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)

    dense = np.zeros((nb, block, block), np.float64)
    same = rows // block == cols // block
    br, bc, bv = rows[same], cols[same], vals[same]
    dense[br // block, br % block, bc % block] = bv
    pad = np.arange(nb * block)[n:]
    dense[pad // block, pad % block, pad % block] = 1.0

    inv = np.linalg.inv(dense)
    bi, ri, ci = np.meshgrid(
        np.arange(nb), np.arange(block), np.arange(block), indexing="ij"
    )
    out_r = (bi * block + ri).ravel()
    out_c = (bi * block + ci).ravel()
    out_v = inv.ravel()
    keep = (out_r < n) & (out_c < n) & (out_v != 0)
    m = from_coo(out_r[keep], out_c[keep], out_v[keep], (n, n),
                 device=a.device)
    return BlockJacobiGSEPrecond(mat=pack_csr(m, k), block=block)
