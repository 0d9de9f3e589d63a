"""The paper's own workload: stepped mixed-precision CG, PCG and GMRES on
synthetic sparse systems.

Port of ``repro/configs/paper_solver.py``: ``cg_setup``, ``gmres_setup``,
``pcg_setup`` and ``ir_setup``.  Not an LM config: these return solver
inputs, built on ``device``.
"""
from repro_torch.core.precision import MonitorParams
from repro_torch.sparse import generators

__all__ = ["cg_setup", "gmres_setup", "pcg_setup", "ir_setup"]


def cg_setup(name: str = "poisson2d_64", small: bool = True, device="cuda"):
    """``(a, params)``: a matrix of the CG suite and the CG monitor."""
    suite = generators.cg_suite(small, device=device)
    a = suite.get(name) or generators.poisson2d(64, device=device)
    return a, MonitorParams.for_cg()


def gmres_setup(name: str = "convdiff_32", small: bool = True,
                device="cuda"):
    """``(a, params)``: a matrix of the GMRES suite and the GMRES monitor."""
    suite = generators.gmres_suite(small, device=device)
    a = suite.get(name) or generators.convection_diffusion_2d(32,
                                                                device=device)
    return a, MonitorParams.for_gmres()


def pcg_setup(precond: str = "jacobi", n: int = 32, decades: float = 8.0,
              device="cuda"):
    """Preconditioned stepped-CG workload: the ill-conditioned SPD system
    where unpreconditioned stepped CG stalls but a GSE-packed diagonal or
    block preconditioner, applied at the monitor's current tag, restores
    stencil conditioning.

    Returns ``(a, m, params)``; solve with
    ``solve_pcg(pack_csr(a, 8), b, m, params=params)``.
    """
    from repro_torch.solvers.precond import (make_block_jacobi, make_jacobi,
                                             make_spai0)

    factory = {
        "jacobi": make_jacobi,
        "spai0": make_spai0,
        "block_jacobi": make_block_jacobi,
    }[precond]
    a = generators.ill_conditioned_spd(n, decades, device=device)
    return a, factory(a), MonitorParams.for_cg()


def ir_setup(n: int = 32, decades: float = 8.0, device="cuda"):
    """Stepped iterative-refinement workload (Carson-Khan shape): outer
    tag-3 residual and correction, inner stepped PCG.  Returns ``(a, m,
    params)``; solve with ``solve_ir(pack_csr(a, 8), b, precond=m,
    params=params)``."""
    from repro_torch.solvers.precond import make_jacobi

    a = generators.ill_conditioned_spd(n, decades, device=device)
    return a, make_jacobi(a), MonitorParams.for_cg()
