"""Iterative solvers with stepped mixed precision (paper Section III.D).

Ported: stepped CG (``solve_cg``) and its batched service loop
(``solvers.batched``); preconditioned CG (``solve_pcg``, ROADMAP queue 1
item 6) with the GSE-packed preconditioners of ``solvers.precond``; and
restarted stepped GMRES (``solve_gmres``, item 7), right-preconditioned
by the same objects.  Batched PCG and iterative refinement are items 6
and 8.
"""
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    health_name,
)
from repro_torch.solvers.cg import CGResult, solve_cg, solve_pcg
from repro_torch.solvers.fused_cg import (fused_cg_step, fused_pcg_step,
                                          gse_matvec)
from repro_torch.solvers.gmres import GMRESResult, solve_gmres
from repro_torch.solvers.operators import (
    make_dense_operator,
    make_fixed_operator,
    make_gse_operator,
    make_precond_operator,
)
from repro_torch.solvers.precond import (
    BlockJacobiGSEPrecond,
    DiagGSEPrecond,
    make_block_jacobi,
    make_jacobi,
    make_spai0,
)

__all__ = [
    "DEFAULT_GUARDS",
    "GuardParams",
    "health_name",
    "CGResult",
    "solve_cg",
    "solve_pcg",
    "fused_cg_step",
    "fused_pcg_step",
    "gse_matvec",
    "GMRESResult",
    "solve_gmres",
    "make_dense_operator",
    "make_fixed_operator",
    "make_gse_operator",
    "make_precond_operator",
    "BlockJacobiGSEPrecond",
    "DiagGSEPrecond",
    "make_block_jacobi",
    "make_jacobi",
    "make_spai0",
]
