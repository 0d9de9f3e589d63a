"""Iterative solvers with stepped mixed precision (paper Section III.D).

Ported: stepped CG (``solve_cg``) and its batched service loop
(``solvers.batched``); preconditioned CG, solo and batched (``solve_pcg``,
``solve_pcg_batched``, ROADMAP queue 1 item 6) with the GSE-packed
preconditioners of ``solvers.precond``; restarted stepped GMRES
(``solve_gmres``, item 7), right-preconditioned by the same objects; and
stepped iterative refinement over any of them (``solve_ir``,
``solve_ir_batched``, item 8); and the per-group precision axis (item
11): ``tags=`` a ``core.tagmap.TagMap`` on every CG-family solver, and the
adaptive driver ``solve_adaptive`` (``tags="adaptive"``).
"""
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    health_name,
)
from repro_torch.solvers.adaptive import (AdaptiveResult, Promotion,
                                          solve_adaptive)
from repro_torch.solvers.batched import (BatchedCGResult, BatchedIRResult,
                                         solve_cg_batched, solve_ir_batched,
                                         solve_pcg_batched)
from repro_torch.solvers.cg import CGResult, solve_cg, solve_pcg
from repro_torch.solvers.fused_cg import (fused_cg_step, fused_pcg_step,
                                          gse_matvec)
from repro_torch.solvers.gmres import GMRESResult, solve_gmres
from repro_torch.solvers.ir import IRResult, solve_ir
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
    "BatchedCGResult",
    "BatchedIRResult",
    "solve_cg_batched",
    "solve_pcg_batched",
    "solve_ir_batched",
    "IRResult",
    "solve_ir",
    "AdaptiveResult",
    "Promotion",
    "solve_adaptive",
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
