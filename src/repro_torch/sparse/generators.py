"""Synthetic sparse-matrix suite (SuiteSparse stand-in).

Port of ``repro/sparse/generators.py``, all of it.  The generators draw
from numpy ``default_rng`` exactly as the reference does, so the same
seed gives the same matrix bit for bit; the result is a :class:`CSR` of
torch tensors on ``device``.

  CG set (Table II left):  symmetric positive definite -- Poisson stencils,
      mass-like diagonal matrices, random SPD with controlled conditioning.
  GMRES set (Table II right): asymmetric -- convection-diffusion, circuit
      -like power-law, randomly perturbed stencils.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.gse import _np
from repro_torch.sparse.csr import CSR, from_coo

__all__ = [
    "poisson2d",
    "poisson3d",
    "convection_diffusion_2d",
    "random_spd",
    "circuit_like",
    "skewed_spd",
    "diag_rescale",
    "ill_conditioned_spd",
    "mass_diagonal",
    "cg_suite",
    "gmres_suite",
    "spmv_suite",
]


def poisson2d(n: int, device="cuda") -> CSR:
    """5-point Laplacian on an n x n grid (SPD, like af_shell/thermal2 role)."""
    N = n * n
    idx = np.arange(N).reshape(n, n)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v))

    add(idx, idx, 4.0)
    add(idx[1:, :], idx[:-1, :], -1.0)
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -1.0)
    add(idx[:, :-1], idx[:, 1:], -1.0)
    return from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (N, N), device=device,
    )


def poisson3d(n: int, device="cuda") -> CSR:
    """7-point Laplacian on an n^3 grid (SPD, bone010/Queen role)."""
    N = n ** 3
    idx = np.arange(N).reshape(n, n, n)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v))

    add(idx, idx, 6.0)
    for axis in range(3):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(1, None)
        sl_hi[axis] = slice(None, -1)
        add(idx[tuple(sl_lo)], idx[tuple(sl_hi)], -1.0)
        add(idx[tuple(sl_hi)], idx[tuple(sl_lo)], -1.0)
    return from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (N, N), device=device,
    )


def convection_diffusion_2d(n: int, beta: float = 20.0, device="cuda") -> CSR:
    """Upwind convection-diffusion (asymmetric; GMRES wang3/epb2 role)."""
    N = n * n
    h = 1.0 / (n + 1)
    idx = np.arange(N).reshape(n, n)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(np.asarray(r).ravel())
        cols.append(np.asarray(c).ravel())
        vals.append(np.broadcast_to(v, np.asarray(r).ravel().shape).copy())

    add(idx, idx, 4.0 + beta * h)
    add(idx[1:, :], idx[:-1, :], -(1.0 + beta * h))  # upwind
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -(1.0 + 0.5 * beta * h))
    add(idx[:, :-1], idx[:, 1:], -1.0)
    return from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (N, N), device=device,
    )


def random_spd(n: int, nnz_per_row: int = 8, cond_decades: float = 3.0,
               seed: int = 0, device="cuda") -> CSR:
    """Random SPD: A = B + B^T + shift*I with clustered-exponent values."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = rng.integers(0, n, size=n * nnz_per_row)
    # Clustered exponents: magnitudes 2^U with U from a few discrete bins.
    bins = rng.choice([-2, -1, 0, 1], size=n * nnz_per_row, p=[0.1, 0.2, 0.5, 0.2])
    vals = rng.uniform(1.0, 2.0, n * nnz_per_row) * np.exp2(bins)
    vals *= rng.choice([-1.0, 1.0], size=vals.shape)
    # Symmetrize + diagonal dominance (guarantees SPD).
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    shift = 4.0 * nnz_per_row * np.exp2(1)
    diag = np.full(n, shift) * np.exp2(
        rng.uniform(0, cond_decades, n)  # spread the diagonal exponents
    )
    v = np.concatenate([vals, vals, diag])
    return from_coo(r, c, v, (n, n), device=device)


def circuit_like(n: int, seed: int = 0, device="cuda") -> CSR:
    """Power-law degree, wildly varying conductances (adder_dcop role)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum((rng.pareto(1.5, n) + 1).astype(np.int64) * 2, 64)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, size=deg.sum())
    expo = rng.choice([-6, -3, 0, 0, 0, 3], size=deg.sum())
    vals = rng.uniform(1.0, 2.0, deg.sum()) * np.exp2(expo)
    vals *= rng.choice([-1.0, 1.0], size=vals.shape)
    r = np.concatenate([rows, np.arange(n)])
    c = np.concatenate([cols, np.arange(n)])
    v = np.concatenate([vals, np.full(n, 70.0)])  # dominant diagonal
    return from_coo(r, c, v, (n, n), device=device)


def skewed_spd(n: int = 2048, dense_rows: int = 4, base_halfwidth: int = 58,
               tail_scale: float = 3.0, seed: int = 0, device="cuda") -> CSR:
    """SPD with power-law row-length skew and a few dense rows (the
    uniform-ELL worst case): a symmetric periodic band with Pareto-tailed
    halfwidths, ``dense_rows`` hub rows/columns touching every column,
    clustered-exponent values and a strictly dominant diagonal."""
    rng = np.random.default_rng(seed)
    tail = np.minimum((rng.pareto(1.8, n) * tail_scale).astype(np.int64),
                      n // 2)
    h = np.minimum(base_halfwidth + tail, (n - 1) // 2)
    rows = np.repeat(np.arange(n), h)
    offs = np.arange(h.sum()) - np.repeat(np.cumsum(h) - h, h) + 1
    cols = (rows + offs) % n
    keep = offs <= h[cols]
    rows, cols = rows[keep], cols[keep]
    hubs = rng.choice(n, size=dense_rows, replace=False)
    hr = np.repeat(hubs, n)
    hc = np.tile(np.arange(n), dense_rows)
    keep = hr != hc
    rows = np.concatenate([rows, hr[keep]])
    cols = np.concatenate([cols, hc[keep]])
    bins = rng.choice([-2, -1, 0, 1], size=rows.size, p=[0.1, 0.2, 0.5, 0.2])
    vals = rng.uniform(1.0, 2.0, rows.size) * np.exp2(bins)
    vals *= rng.choice([-1.0, 1.0], size=vals.shape)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals])
    abssum = np.zeros(n)
    np.add.at(abssum, r, np.abs(v))
    diag = 2.0 * abssum + 1.0
    r = np.concatenate([r, np.arange(n)])
    c = np.concatenate([c, np.arange(n)])
    v = np.concatenate([v, diag])
    return from_coo(r, c, v, (n, n), device=device)


def diag_rescale(a: CSR, decades: float = 6.0, seed: int = 0) -> CSR:
    """Symmetric diagonal rescale D A D, D = 2^U(-d/2, d/2), on the device
    of ``a``.  SPD is preserved (congruence transform)."""
    rng = np.random.default_rng(seed)
    n = a.shape[0]
    d = np.exp2(rng.uniform(-decades / 2, decades / 2, n))
    rows = _np(a.row_ids)
    cols = _np(a.col)
    vals = _np(a.val) * d[rows] * d[cols]
    return from_coo(rows, cols, vals, a.shape, device=a.device)


def ill_conditioned_spd(n: int = 32, decades: float = 14.0, seed: int = 0,
                        device="cuda") -> CSR:
    """SPD with condition number >= 1e6: 2-D Poisson congruence-rescaled."""
    return diag_rescale(poisson2d(n, device=device), decades, seed)


def mass_diagonal(n: int, seed: int = 0, device="cuda") -> CSR:
    """Diagonal mass matrix (bcsstm24 role)."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.5, 4.0, n)
    i = np.arange(n)
    return from_coo(i, i, vals, (n, n), device=device)


def cg_suite(small: bool = True, device="cuda") -> Dict[str, CSR]:
    """SPD suite mirroring Table II (left).  small=True keeps CI fast.
    ``circuit_spd_4k`` is filled in by :func:`spmv_suite`, as in the
    reference."""
    s = 1 if small else 4
    d = device
    return {
        "mass_diag_3k": mass_diagonal(3562 // s, seed=1, device=d),
        "poisson2d_32": poisson2d(32 * s, device=d),
        "poisson2d_64": poisson2d(64 * s, device=d),
        "poisson3d_12": poisson3d(12 * s, device=d),
        "random_spd_5k": random_spd(5000 // s, seed=2, device=d),
        "random_spd_wide_2k": random_spd(2000 // s, cond_decades=6.0, seed=3,
                                         device=d),
        "spd_rs8_2k": diag_rescale(random_spd(2000 // s, seed=21, device=d),
                                   8.0, 21),
        "spd_overflow_2k": diag_rescale(
            random_spd(2000 // s, cond_decades=2.0, seed=22, device=d),
            24.0, 22),
        "circuit_spd_4k": None,
    }


def gmres_suite(small: bool = True, device="cuda") -> Dict[str, CSR]:
    """Asymmetric suite mirroring Table II (right)."""
    s = 1 if small else 4
    d = device
    return {
        "convdiff_32": convection_diffusion_2d(32 * s, device=d),
        "convdiff_48_b50": convection_diffusion_2d(48 * s, beta=50.0, device=d),
        "circuit_2k": circuit_like(1813 if small else 8000, seed=4, device=d),
        "circuit_5k": circuit_like(4960 if small else 20000, seed=5, device=d),
        "convdiff_64": convection_diffusion_2d(64 * s, beta=5.0, device=d),
        "convdiff_rs4_32": diag_rescale(
            convection_diffusion_2d(32 * s, beta=5.0, device=d), 4.0, 23),
        "circuit_rs12_2k": diag_rescale(
            circuit_like(2000 // s, seed=24, device=d), 24.0, 24),
    }


def _symmetrize(a: CSR) -> CSR:
    rows = _np(a.row_ids)
    col = _np(a.col)
    val = _np(a.val)
    r = np.concatenate([rows, col])
    c = np.concatenate([col, rows])
    v = np.concatenate([val, val]) * 0.5
    return from_coo(r, c, v, a.shape, device=a.device)


def spmv_suite(small: bool = True, device="cuda") -> Dict[str, CSR]:
    """Matrices for the SpMV-level experiments (Figs 4-6 role)."""
    cg = cg_suite(small, device=device)
    cg["circuit_spd_4k"] = _symmetrize(
        circuit_like(4000 if small else 16000, 6, device=device))
    out = dict(cg)
    out.update(gmres_suite(small, device=device))
    return out
