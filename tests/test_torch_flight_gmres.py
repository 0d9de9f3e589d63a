"""The flight recorder in the port's stepped GMRES on the named cases.

``examples/solve_stepped_gmres.py``'s case (``diag_rescale(
convection_diffusion_2d(32, beta=5), 3, 7)``, GMRES(80)): the plain
solve's 4633 iterations at [89, 119] through the default 1024-row ring
(the rows of the last cycles, the switches out of the window) and its
right-Jacobi twin's 283 iterations at [119, 178], every row kept.  The
ring is carried across restarts; each row holds the Givens magnitude
``d`` and the subdiagonal ``H[j+1, j]``.  Recorder-on is bitwise the
reference's solve and the ring the reference's, ``relres``, ``a0`` and
``a1`` bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.obs import flight as J_OF  # noqa: E402
from repro.solvers import make_gse_operator as j_gse  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers import solve_gmres as j_solve_gmres  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402,E501
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.obs import flight as T_OF  # noqa: E402
from repro_torch.solvers import (make_gse_operator, make_jacobi,  # noqa: E402
                                 solve_gmres)

EXAMPLE = dict(t=40, l=60, m=30, rsd_limit=0.5, reldec_limit=0.45)
COLS = ("it", "tag", "health", "relres", "a0", "a1", "a2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def example():
    a = J_gen.diag_rescale(J_gen.convection_diffusion_2d(32, beta=5.0), 3.0,
                           7)
    g = J_csr.pack_csr(a, k=8)
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device="cpu")
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device="cpu")
    b = np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(7).normal(size=a.shape[1]))))
    return dict(a=a, g=g, ta=ta, tg=tg, b=b)


@pytest.mark.parametrize("precond,want", [
    (False, (4633, [89, 119], 3609)),
    (True, (283, [119, 178], 0)),
])
def test_the_example_records_the_reference_ring(precond, want, example):
    s = example
    kw = dict(tol=1e-7, restart=80, maxiter=8000)
    jm = j_jacobi(s["a"], k=8) if precond else None
    tm = make_jacobi(s["ta"], k=8) if precond else None
    jr = j_solve_gmres(j_gse(s["g"]), jnp.asarray(s["b"]),
                       params=J_P.MonitorParams(**EXAMPLE), precond=jm,
                       flight=J_OF.DEFAULT_FLIGHT, **kw)
    tr = solve_gmres(make_gse_operator(s["tg"]), torch.from_numpy(s["b"]),
                     params=T_P.MonitorParams(**EXAMPLE), precond=tm,
                     flight=T_OF.DEFAULT_FLIGHT, **kw)
    lt = T_OF.FlightLog.from_state(tr.flight)
    lj = J_OF.FlightLog.from_state(jr.flight)
    assert (int(tr.iters), tr.switch_iters.tolist(), lt.dropped) == want
    np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
    assert float(tr.relres) == float(jr.relres)
    for c in COLS:
        np.testing.assert_array_equal(getattr(lt, c),
                                      np.asarray(getattr(lj, c)), err_msg=c)
    assert (lt.recorded, lt.dropped) == (lj.recorded, lj.dropped)
    T_OF.assert_consistent(lt, tr)
    assert (lt.a0 > 0).all() and (lt.a2 == 0).all()
    if not precond:
        assert not lt.switch_visible(3)  # the window starts at tag 3
