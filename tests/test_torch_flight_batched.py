"""The flight recorder in the port's batched solvers and iterative
refinement on the named cases.

``rs8_400_s3`` (``diag_rescale(random_spd(400, seed=3), 8, 3)``, the
block ``[b0, b1, b2, 0]`` with ``b_j = A x_j``): batched CG (1632, 1752
and 1727 iterations, each column switching on its own schedule) and
Jacobi PCG, one ring per column stacked on a leading axis; and quickstart
section 5's IR (``ill_conditioned_spd(32, 8 decades)``, inner Jacobi
PCG: 5 corrections, 296 inner iterations), solo and batched, a ring per
correction.  The rings are bitwise the reference's, recorder-on is
bitwise the reference's solve, and every column's ring is its own
iterations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.obs import flight as J_OF  # noqa: E402
from repro.solvers import batched as J_b  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers import solve_ir as j_solve_ir  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402,E501
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.obs import flight as T_OF  # noqa: E402
from repro_torch.solvers import (make_jacobi, solve_ir,  # noqa: E402
                                 solve_ir_batched)
from repro_torch.solvers import batched as T_b  # noqa: E402

CPU = "cpu"
QS = dict(t=40, l=60, m=30)
FAST = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
COLS = ("it", "tag", "health", "relres", "a0", "a1", "a2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(a):
    g = J_csr.pack_csr(a, k=8)
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device=CPU)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    return dict(a=a, g=g, ta=ta, tg=tg)


def _rhs(a, seed):
    return np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(seed).normal(size=a.shape[1]))))


def _same_rings(tfs, jfs):
    """Every column's (or correction's) ring is the reference's."""
    for k in ("ibuf", "fbuf", "count"):
        np.testing.assert_array_equal(np.asarray(tfs[k]),
                                      np.asarray(jfs[k]), err_msg=k)


@pytest.mark.parametrize("pcg", [False, True], ids=["cg", "pcg_jacobi"])
def test_rs8_400_s3_batched_rings(pcg):
    s = _system(J_gen.diag_rescale(J_gen.random_spd(400, seed=3), 8.0, 3))
    blk = np.stack([_rhs(s["a"], j) for j in range(3)] + [np.zeros(400)],
                   axis=1)
    kw = dict(tol=1e-8, maxiter=20000)
    if pcg:
        jr = J_b.solve_pcg_batched(s["g"], jnp.asarray(blk),
                                   j_jacobi(s["a"], k=8),
                                   params=J_P.MonitorParams(**QS),
                                   flight=J_OF.FlightParams(capacity=2048),
                                   **kw)
        tr = T_b.solve_pcg_batched(s["tg"], torch.from_numpy(blk),
                                   make_jacobi(s["ta"], k=8),
                                   params=T_P.MonitorParams(**QS),
                                   flight=T_OF.FlightParams(capacity=2048),
                                   device=CPU, **kw)
    else:
        jr = J_b.solve_cg_batched(s["g"], jnp.asarray(blk),
                                  params=J_P.MonitorParams(**QS),
                                  flight=J_OF.FlightParams(capacity=2048),
                                  **kw)
        tr = T_b.solve_cg_batched(s["tg"], torch.from_numpy(blk),
                                  params=T_P.MonitorParams(**QS),
                                  flight=T_OF.FlightParams(capacity=2048),
                                  device=CPU, **kw)
        assert tr.iters.tolist() == [1632, 1752, 1727, 0]
    assert tr.iters.tolist() == np.asarray(jr.iters).tolist()
    np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
    _same_rings(tr.flight, jr.flight)
    for j, col in enumerate(T_OF.split_batched(tr.flight)):
        log = T_OF.FlightLog.from_state(col)
        assert log.recorded == int(tr.iters[j]) and log.dropped == 0
        if j < 3:
            assert log.switch_iters().tolist() == tr.switch_iters[j].tolist()
            assert (log.health == 0).all()


@pytest.fixture(scope="module")
def quick():
    s = _system(J_gen.ill_conditioned_spd(32, decades=8.0, seed=0))
    rng = np.random.default_rng(0)
    s["b"] = np.array(j_spmv(s["a"], jnp.asarray(
        rng.normal(size=s["a"].shape[1]))))
    s["b2"] = np.array(j_spmv(s["a"], jnp.asarray(
        rng.normal(size=s["a"].shape[1]))))
    return s


IR_KW = dict(tol=1e-11, max_outer=10, inner_tol=1e-4, inner_maxiter=4000)


def test_section5_ir_records_every_correction(quick):
    q = quick
    jr = j_solve_ir(q["g"], jnp.asarray(q["b"]),
                    precond=j_jacobi(q["a"], k=8),
                    params=J_P.MonitorParams(**FAST),
                    flight=J_OF.FlightParams(capacity=512), **IR_KW)
    tr = solve_ir(q["tg"], torch.from_numpy(q["b"]),
                  precond=make_jacobi(q["ta"], k=8),
                  params=T_P.MonitorParams(**FAST),
                  flight=T_OF.FlightParams(capacity=512), **IR_KW)
    assert (tr.outer_iters, tr.inner_iters) == (jr.outer_iters,
                                                 jr.inner_iters) == (5, 296)
    np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
    assert len(tr.flight) == len(jr.flight) == 5
    for tfs, jfs in zip(tr.flight, jr.flight):
        _same_rings(tfs, jfs)
    assert sum(int(f["count"]) for f in tr.flight) == tr.inner_iters


def test_section5_batched_ir_records_every_correction(quick):
    q = quick
    blk = np.stack([q["b"], 2 * q["b"], q["b2"], np.zeros_like(q["b"])],
                   axis=1)
    jr = J_b.solve_ir_batched(q["g"], jnp.asarray(blk),
                              precond=j_jacobi(q["a"], k=8),
                              params=J_P.MonitorParams(**FAST),
                              flight=J_OF.FlightParams(capacity=512),
                              **IR_KW)
    tr = solve_ir_batched(q["tg"], torch.from_numpy(blk),
                          precond=make_jacobi(q["ta"], k=8),
                          params=T_P.MonitorParams(**FAST),
                          flight=T_OF.FlightParams(capacity=512),
                          device=CPU, **IR_KW)
    assert tr.inner_iters.tolist() == [296, 296, 289, 0]
    np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
    assert len(tr.flight) == len(jr.flight) == 5
    for tfs, jfs in zip(tr.flight, jr.flight):
        _same_rings(tfs, jfs)
    counts = np.sum([f["count"].numpy() for f in tr.flight], axis=0)
    assert counts.tolist() == tr.inner_iters.tolist()
