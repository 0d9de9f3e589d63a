"""The port's batched stepped CG against the JAX reference.

``rs8_400_s3`` -- ``diag_rescale(random_spd(400, seed=3), 8, 3)`` packed at
k=8, three right-hand sides ``b_j = A x_j`` with ``x_j =
default_rng(j).normal(400)`` and one all-zero column -- is solved once in
each package (module fixture).  Every column steps its tag on its own
schedule, so the case shows that the per-column monitor was ported: the
port's iterations, tags, switch iterations, health and solutions are the
reference's bit for bit, and column j is the port's solo ``solve_cg``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.solvers import batched as J_b  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402,E501
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.obs.flight import FlightParams  # noqa: E402
from repro_torch.solvers import batched as T_b  # noqa: E402
from repro_torch.solvers.cg import solve_cg  # noqa: E402
from repro_torch.solvers.operators import make_gse_operator  # noqa: E402
from repro_torch.solvers.precond import make_jacobi  # noqa: E402

QS = dict(t=40, l=60, m=30)
CPU = "cpu"
KW = dict(tol=1e-8, maxiter=20000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solver loops run thousands of tiny CPU ops: one intra-op thread
    is faster than a pool and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(v):
    return np.asarray(v, dtype=np.float64).view(np.uint64)


@pytest.fixture(scope="module")
def rs8():
    a = J_gen.diag_rescale(J_gen.random_spd(400, seed=3), 8.0, 3)
    g = J_csr.pack_csr(a, k=8)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    cols = [np.asarray(j_spmv(a, jnp.asarray(
        np.random.default_rng(j).normal(size=400)))) for j in range(3)]
    b = np.stack(cols + [np.zeros(400)], axis=1)
    rj = J_b.solve_cg_batched(g, jnp.asarray(b),
                              params=J_P.MonitorParams(**QS), **KW)
    rt = T_b.solve_cg_batched(tg, torch.from_numpy(b),
                              params=T_P.MonitorParams(**QS), device=CPU,
                              **KW)
    return dict(g=g, tg=tg, b=b, rj=rj, rt=rt)


def test_batched_cg_is_the_reference_bit_for_bit(rs8):
    rj, rt = rs8["rj"], rs8["rt"]
    assert rt.iters.tolist() == np.asarray(rj.iters).tolist() \
        == [1632, 1752, 1727, 0]
    assert rt.tag.tolist() == np.asarray(rj.tag).tolist() == [3, 3, 3, 1]
    assert rt.switch_iters.tolist() == np.asarray(rj.switch_iters).tolist() \
        == [[120, 210], [240, 270], [240, 270], [-1, -1]]
    assert rt.converged.tolist() == np.asarray(rj.converged).tolist() \
        == [True] * 4
    assert rt.health.tolist() == np.asarray(rj.health).tolist() == [0] * 4
    assert rt.trip_iter.tolist() == np.asarray(rj.trip_iter).tolist()
    assert rt.x.shape == (400, 4)
    assert np.array_equal(_bits(rt.x.numpy()), _bits(rj.x))
    assert np.array_equal(_bits(rt.relres.numpy()), _bits(rj.relres))


@pytest.mark.parametrize("j", [0, 1, 2])
def test_column_j_is_the_solo_solve(rs8, j):
    rt = rs8["rt"]
    solo = solve_cg(rs8["tg"], torch.from_numpy(rs8["b"][:, j]),
                    params=T_P.MonitorParams(**QS), **KW)
    assert int(solo.iters) == int(rt.iters[j])
    assert int(solo.tag) == int(rt.tag[j])
    assert solo.switch_iters.tolist() == rt.switch_iters[j].tolist()
    assert bool(solo.converged) and int(solo.health) == int(rt.health[j])
    assert torch.equal(solo.x, rt.x[:, j])
    assert torch.equal(solo.relres, rt.relres[j])


def test_zero_column_never_iterates(rs8):
    rt = rs8["rt"]
    assert int(rt.iters[3]) == 0 and float(rt.relres[3]) == 0.0
    assert bool((rt.x[:, 3] == 0).all()) and bool(rt.converged[3])
    assert rt.switch_iters[3].tolist() == [-1, -1] and int(rt.tag[3]) == 1


def test_fused_and_generic_paths_give_identical_results(rs8):
    kw = dict(tol=1e-8, maxiter=300, params=T_P.MonitorParams(**QS),
              device=CPU)
    b = torch.from_numpy(rs8["b"])
    fused = T_b.solve_cg_batched(rs8["tg"], b, **kw)
    generic = T_b.solve_cg_batched(make_gse_operator(rs8["tg"]), b, **kw)
    assert fused.switch_iters[0].tolist() == [120, 210]
    assert fused.flight is generic.flight is None  # the recorder is off
    for f in fused._fields[:-1]:
        assert torch.equal(getattr(fused, f), getattr(generic, f)), f
    off = T_b.solve_cg_batched(rs8["tg"], b, guards=None, **kw)
    for f in ("x", "iters", "relres", "tag", "switch_iters", "converged"):
        assert torch.equal(getattr(fused, f), getattr(off, f)), f


def test_byte_accounting_matches_reference(rs8):
    g, tg, rj, rt = rs8["g"], rs8["tg"], rs8["rj"], rs8["rt"]
    for it in (0, 119, 120, 209, 210, 1631, 1632, 1751, 1752):
        assert np.array_equal(
            T_b.column_tags_at(rt.iters, rt.switch_iters, it),
            J_b.column_tags_at(rj.iters, rj.switch_iters, it))
    total = T_b.batched_run_bytes(tg, rt.iters, rt.switch_iters)
    assert total == J_b.batched_run_bytes(g, rj.iters, rj.switch_iters)
    assert total == 157151024  # the service's modeled_bytes on this case


def test_bad_shapes_raise_value_error(rs8):
    tg = rs8["tg"]
    b = torch.from_numpy(rs8["b"])
    with pytest.raises(ValueError, match="b must be"):
        T_b.solve_cg_batched(tg, b[None], device=CPU)
    with pytest.raises(ValueError, match="shape mismatch"):
        T_b.solve_cg_batched(tg, b, x0=torch.zeros(400, 3,
                                                   dtype=torch.float64),
                             device=CPU)
    with pytest.raises(ValueError, match="dtype mismatch"):
        T_b.solve_cg_batched(tg, b, x0=torch.zeros(400, 4), device=CPU)
    with pytest.raises(ValueError, match="tag must be"):
        T_b.solve_cg_batched(tg, b, tags=4, device=CPU)
    with pytest.raises(ValueError, match="adaptive"):
        T_b.solve_cg_batched(tg, b, tags="adaptive", device=CPU)
    with pytest.raises(ValueError, match="expected cuda"):
        T_b.solve_cg_batched(tg, b)  # the operand lies on the CPU


def test_one_dimensional_b_and_int_tags(rs8):
    """A (n,) b is a one-column block; an int tag starts every monitor
    there, as the reference's ``tags=``."""
    g, tg, b = rs8["g"], rs8["tg"], rs8["b"][:, 0]
    kw = dict(tol=1e-8, maxiter=200)
    rt = T_b.solve_cg_batched(tg, torch.from_numpy(b), tags=2, device=CPU,
                              params=T_P.MonitorParams(**QS), **kw)
    rj = J_b.solve_cg_batched(g, jnp.asarray(b), tags=2,
                              params=J_P.MonitorParams(**QS), **kw)
    assert rt.x.shape == (400, 1)
    assert rt.iters.tolist() == np.asarray(rj.iters).tolist()
    assert rt.tag.tolist() == np.asarray(rj.tag).tolist()
    assert rt.switch_iters.tolist() == np.asarray(rj.switch_iters).tolist()
    assert np.array_equal(_bits(rt.x.numpy()), _bits(rj.x))


def test_unported_options_raise_not_implemented(rs8):
    tg = rs8["tg"]
    b = torch.from_numpy(rs8["b"])
    short = dict(maxiter=20, params=T_P.MonitorParams(**QS), device=CPU)
    off = T_b.solve_cg_batched(tg, b, **short)
    on = T_b.solve_cg_batched(tg, b, flight=FlightParams(capacity=8),
                              **short)
    assert torch.equal(on.x, off.x)
    assert on.flight["count"].tolist() == off.iters.tolist() == [20] * 3 + [0]
    with pytest.raises(TypeError, match="FlightParams"):
        T_b.solve_cg_batched(tg, b, flight=object(), device=CPU)
    with pytest.raises(TypeError, match="TagMap"):  # not a precision axis
        T_b.solve_cg_batched(tg, b, tags=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="item 15"):
        T_b.solve_cg_batched(object(), b, device=CPU)
    a = J_gen.diag_rescale(J_gen.random_spd(400, seed=3), 8.0, 3)
    m = make_jacobi(csr_from_repro(
        {n: np.asarray(getattr(a, n)) for n in
         ("rowptr", "col", "val", "row_ids")}, a.shape, device=CPU), k=8)
    off = T_b.solve_pcg_batched(tg, b, m, **short)
    on = T_b.solve_pcg_batched(tg, b, m, flight=FlightParams(capacity=8),
                               **short)
    assert torch.equal(on.x, off.x)
    assert on.flight["count"].tolist() == off.iters.tolist()
    with pytest.raises(TypeError, match="FlightParams"):
        T_b.solve_pcg_batched(tg, b, m, flight=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="item 15"):
        T_b.solve_ir_batched(object(), b, device=CPU)
