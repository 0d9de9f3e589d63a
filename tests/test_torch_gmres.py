"""The port's stepped GMRES against the JAX reference.

The port's loop keeps its state on the device, runs its inner iterations
in chunks with frozen updates past the exit, and rounds every product as
XLA's CPU build of the reference: the CGS2 GEMVs
(``vec_f64.gemv_rows_ref``/``gemv_cols_ref``), the rotations and the back
substitution (``kernels.gmres_f64``), and with a preconditioner the
cycle's update in the order of XLA's loop fusion of ``y @ V[:restart]``
(``vec_f64.gemv_cols_sliced_ref``).  So on these cases the port's
iterates are the reference's bit for bit, with or without right
preconditioning; the tests hold that, and the tolerances the port
promises (``x`` within 1e-4 relative, ``relres`` within 1e-6) beside it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy.linalg import blas  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.solvers import make_fixed_operator as j_fixed  # noqa: E402
from repro.solvers import make_gse_operator as j_gse  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers import solve_gmres as j_solve_gmres  # noqa: E402
from repro.solvers.gmres import _givens as j_givens  # noqa: E402
from repro.solvers.gmres import _solve_gmres as j_solve_gmres_raw  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.configs import paper_solver  # noqa: E402
from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.obs.flight import FlightParams  # noqa: E402
from repro_torch.kernels import gmres_f64 as GF  # noqa: E402
from repro_torch.kernels import vec_f64 as V  # noqa: E402
from repro_torch.robustness import guards as T_guards  # noqa: E402
from repro_torch.solvers import gmres as T_gmres  # noqa: E402
from repro_torch.solvers import (make_dense_operator,  # noqa: E402
                                 make_fixed_operator, make_gse_operator,
                                 make_jacobi, make_precond_operator,
                                 solve_gmres)

EXAMPLE = dict(t=40, l=60, m=30, rsd_limit=0.5, reldec_limit=0.45)
FAST = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: the stepped loops run thousands
    of tiny ops, which a thread pool shared with the other test workers
    only slows (about 25x with six workers of eight threads each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(a, g=None):
    """The port's CSR and GSECSR, converted from the reference's arrays."""
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device="cpu")
    if g is None:
        return ta, None
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device="cpu")
    return ta, tg


def _b(a, seed):
    return np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(seed).normal(size=a.shape[1]))))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same(rt, rj, bitwise=True):
    """The port's result against the reference's: equal iterations, tag,
    switches and health; x within 1e-4 and relres within 1e-6 relative
    (bitwise where the case promises it)."""
    assert int(rt.iters) == int(rj.iters)
    assert int(rt.tag) == int(rj.tag)
    assert rt.switch_iters.tolist() == np.asarray(rj.switch_iters).tolist()
    assert bool(rt.converged) == bool(rj.converged)
    assert int(rt.health) == int(rj.health)
    xj = np.asarray(rj.x)
    assert _rel(rt.x.numpy(), xj) <= 1e-4
    assert abs(float(rt.relres) - float(rj.relres)) <= 1e-6 * float(rj.relres)
    if bitwise:
        np.testing.assert_array_equal(rt.x.numpy(), xj)
        assert float(rt.relres) == float(rj.relres)


# --- the reference-order GEMVs -------------------------------------------

_rows_j = jax.jit(lambda v, w: v @ w)
_cols_j = jax.jit(lambda c, v: c @ v)
_cols_add_j = jax.jit(lambda x, c, v: x + c @ v)


def _basis(rows, n, seed):
    """An 81-row basis with ``rows`` live rows, zero below them, as the
    solver's V is within a cycle."""
    rng = np.random.default_rng(seed)
    v = np.zeros((81, n))
    v[:rows] = rng.normal(size=(rows, n))
    c = np.zeros(81)
    c[:rows] = rng.normal(size=rows)
    return v, rng.normal(size=n), c, rng.normal(size=n)


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("rows", [1, 2, 41, 81])
def test_gemv_rows_ref_plain_is_the_jitted_product(rows, n):
    v, w, _, _ = _basis(rows, n, seed=rows + n)
    want = np.asarray(_rows_j(v, w))[:rows]
    got = V.gemv_rows_ref(torch.from_numpy(v), torch.from_numpy(w), rows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("rows", [1, 2, 41, 81])
def test_gemv_cols_ref_plain_is_the_jitted_product(rows, n):
    v, _, c, x = _basis(rows, n, seed=7 * rows + n)
    vt, ct, xt = (torch.from_numpy(t) for t in (v, c, x))
    np.testing.assert_array_equal(V.gemv_cols_ref(ct, vt, rows).numpy(),
                                  np.asarray(_cols_j(c, v)))
    # x + y @ V: XLA fuses the add into the dot (the chain starts at x).
    np.testing.assert_array_equal(
        V.gemv_cols_ref(ct, vt, rows, addend=xt).numpy(),
        np.asarray(_cols_add_j(x, c, v)))


# Row counts of the cycle update: both sides of the boundaries of XLA's
# order (the vectorized reduction from 50 rows, its loop from 128, the
# unfused dot from 2048) and the port's restarts 20, 30, 60 and 80.
SLICED_ROWS = [1, 2, 16, 20, 30, 31, 40, 41, 47, 48, 49, 50, 51, 52, 54, 60,
               64, 66, 79, 80, 81, 100, 127, 128, 130, 143, 2047, 2048]


@pytest.mark.parametrize("n", [1024, 4099])
@pytest.mark.parametrize("rows", SLICED_ROWS)
def test_gemv_cols_sliced_ref_plain_is_the_jitted_sliced_product(rows, n):
    """The right-preconditioned update ``y @ V[:rows]`` on a ``(rows + 1,
    n)`` basis, values spread over 16 binades so that an order change
    shows."""
    rng = np.random.default_rng(rows * 7 + n)
    v = rng.normal(size=(rows + 1, n)) * np.exp2(
        rng.integers(-8, 8, size=(rows + 1, n)))
    y = rng.normal(size=rows)
    want = np.asarray(jax.jit(lambda y, v: y @ v[:rows])(y, v))
    got = V.gemv_cols_sliced_ref(torch.from_numpy(y), torch.from_numpy(v),
                                 rows)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [9, 17, 1025])
def test_gemv_cols_sliced_ref_short_and_odd_bases(n):
    """Bases off the four lanes and as short as the model holds (n >= 9
    from 50 rows on); shorter ones are refused there."""
    for rows in (3, 49, 50, 55, 80, 131):
        rng = np.random.default_rng(rows + n)
        v = rng.normal(size=(rows + 1, n))
        y = rng.normal(size=rows)
        want = np.asarray(jax.jit(lambda y, v: y @ v[:rows])(y, v))
        np.testing.assert_array_equal(
            V.gemv_cols_sliced_ref(torch.from_numpy(y), torch.from_numpy(v),
                                   rows).numpy(), want)
    with pytest.raises(ValueError, match="at least 9 columns"):
        V.gemv_cols_sliced_ref(torch.zeros(60, dtype=torch.float64),
                               torch.zeros(61, 8, dtype=torch.float64), 60)


def test_sliced_plan_reads_every_row_once():
    """Each plan takes every row once, sets an accumulator before it is
    read, and keeps to 16 accumulators."""
    for rows in range(1, 300):
        plan = V.sliced_plan(rows)
        fma_rows = sorted(b for kind, _, b in plan if kind == V.STEP_FMA)
        assert fma_rows == list(range(rows))
        live = set()
        for kind, a, b in plan:
            assert 0 <= a < V.SLICED_SLOTS
            if kind == V.STEP_SET:
                live.add(a)
            else:
                assert a in live and (kind != V.STEP_ADD or b in live)
    with pytest.raises(ValueError, match="rows"):
        V.sliced_plan(V.SLICED_FUSION_ROWS)


@pytest.mark.parametrize("n", [1023, 1025, 1027, 5])
def test_gemv_tails_are_the_jitted_products(n):
    """Lengths off the four lanes: the rows' scalar tail, the columns'
    scalar tail column (n % 4 == 1) and the fused addend."""
    for rows in (1, 9, 81):
        v, w, c, x = _basis(rows, n, seed=n + rows)
        vt, wt, ct, xt = (torch.from_numpy(t) for t in (v, w, c, x))
        np.testing.assert_array_equal(V.gemv_rows_ref(vt, wt, rows).numpy(),
                                      np.asarray(_rows_j(v, w))[:rows])
        np.testing.assert_array_equal(V.gemv_cols_ref(ct, vt, rows).numpy(),
                                      np.asarray(_cols_j(c, v)))
        np.testing.assert_array_equal(
            V.gemv_cols_ref(ct, vt, rows, addend=xt).numpy(),
            np.asarray(_cols_add_j(x, c, v)))


def test_gemv_refuses_bad_rows():
    v = torch.zeros(4, 8, dtype=torch.float64)
    for rows in (0, 5):
        with pytest.raises(ValueError, match="rows"):
            V.gemv_rows_ref(v, torch.zeros(8, dtype=torch.float64), rows)
        with pytest.raises(ValueError, match="rows"):
            V.gemv_cols_ref(torch.zeros(4, dtype=torch.float64), v, rows)


def test_fma_into_rounds_once():
    """The plain versions' fused step: one rounding of a * b + c, on the
    CPU (addcmul_ where torch fuses it) and through the emulation."""
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(rng.normal(size=1001)) for _ in range(3))
    want = V.fma_axpy_plain(a, b, c)
    acc = c.clone()
    V.fma_into(acc)(a, b)
    assert torch.equal(acc, want)
    assert not torch.equal(c + a * b, want)  # the two roundings differ here


# --- the rotations and the back substitution ---------------------------------

_givens_j = jax.jit(j_givens)


def test_givens_is_the_jitted_reference():
    rng = np.random.default_rng(5)
    vals = list(rng.normal(size=200) * np.exp2(rng.integers(-40, 40, 200)))
    vals += [0.0, -0.0, 1e-300, -1e-160, 1e160, 1e300, 3.0, -4.0]
    for a, b in zip(vals, vals[::-1] + vals[:0]):
        want = [float(t) for t in _givens_j(jnp.float64(a), jnp.float64(b))]
        got = [float(t) for t in T_gmres._givens(
            torch.tensor(a, dtype=torch.float64),
            torch.tensor(b, dtype=torch.float64))]
        assert np.array_equal(np.array(got), np.array(want)), (a, b)


def test_givens_zero_inputs():
    zero = torch.zeros((), dtype=torch.float64)
    c, s, d = (float(t) for t in T_gmres._givens(zero, zero))
    assert (c, s, d) == (1.0, 0.0, 0.0)


@pytest.mark.parametrize("restart", [80, 60, 20, 17, 4])
def test_trsv_upper_ref_is_the_reference_solve(restart):
    """The padded back substitution against the reference's
    solve_triangular (LAPACK dtrsm), for cycles of every length class."""
    rng = np.random.default_rng(restart)
    solve = jax.jit(lambda r, g: jax.scipy.linalg.solve_triangular(
        r, g, lower=False))
    for j in sorted({0, 1, restart // 2, restart - 1, restart}):
        H = np.triu(rng.normal(size=(restart + 1, restart)))
        H[np.arange(restart), np.arange(restart)] += 3.0
        g = rng.normal(size=restart + 1)
        live = np.arange(restart) < j
        Rm = np.where(live[:, None] & live[None, :], H[:restart], np.eye(restart))
        gm = np.where(live, g[:restart], 0.0)
        want = np.asarray(solve(Rm, gm))
        got = GF.trsv_upper_ref(torch.from_numpy(H), torch.from_numpy(g), j)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), blas.dtrsm(1.0, Rm, gm[:, None], side=0, lower=0,
                                    trans_a=0, diag=0)[:, 0])


def test_givens_step_rotates_in_place_only_when_active():
    rng = np.random.default_rng(9)
    restart, j = 12, 5
    state = [torch.from_numpy(rng.normal(size=j + 1)),
             torch.tensor(0.75, dtype=torch.float64),
             torch.from_numpy(rng.normal(size=restart)),
             torch.from_numpy(rng.normal(size=restart)),
             torch.from_numpy(rng.normal(size=restart + 1)),
             torch.zeros(restart + 1, restart, dtype=torch.float64),
             torch.tensor(1.0, dtype=torch.float64)]
    frozen = [t.clone() for t in state]
    GF.givens_step(*frozen, torch.tensor(False), j)
    assert all(torch.equal(a, b) for a, b in zip(frozen, state))
    GF.givens_step(*state, torch.tensor(True), j)
    H, g, cs, sn = state[5], state[4], state[2], state[3]
    assert float(H[j + 1, j]) == 0.0 and float(H[j, j]) > 0
    assert float(state[6]) == abs(float(g[j + 1]))
    assert abs(float(cs[j]) ** 2 + float(sn[j]) ** 2 - 1.0) < 1e-15


# --- stepped GMRES against the reference -------------------------------------

def _example(precond=False):
    a = J_gen.diag_rescale(J_gen.convection_diffusion_2d(32, beta=5.0), 3.0, 7)
    return a, J_csr.pack_csr(a, k=8), _b(a, 7)


def _run_both(a, g, b, *, precond=False, **kw):
    ta, tg = _port(a, g)
    jp = kw.pop("params")
    jkw = dict(kw, params=J_P.MonitorParams(**jp))
    tkw = dict(kw, params=T_P.MonitorParams(**jp))
    if precond:
        jkw["precond"] = j_jacobi(a, k=8)
        tkw["precond"] = make_jacobi(ta, k=8)
    if g is None:
        rj = j_solve_gmres(j_fixed(a), jnp.asarray(b), **jkw)
        rt = solve_gmres(make_fixed_operator(ta), torch.from_numpy(b), **tkw)
    else:
        rj = j_solve_gmres(j_gse(g), jnp.asarray(b), **jkw)
        rt = solve_gmres(make_gse_operator(tg), torch.from_numpy(b), **tkw)
    return rt, rj


@pytest.mark.parametrize("case", ["convdiff_32_b5", "convdiff_32",
                                  "convdiff_rs4_32"])
def test_gse_operator_matches_jax(case):
    """convection_diffusion_2d(32, beta=5) to convergence (286 iterations,
    [119, 178]); the suite's convdiff_32 (beta 20, it stalls) and
    convdiff_rs4_32 over a fixed budget that crosses both switches."""
    if case == "convdiff_32_b5":
        a = J_gen.convection_diffusion_2d(32, beta=5.0)
        maxiter, want = 8000, (286, [119, 178])
    else:
        a = J_gen.gmres_suite(True)[case]
        maxiter, want = 400, (400, [60, 119] if case == "convdiff_32"
                              else [119, 149])
    g = J_csr.pack_csr(a, k=8)
    rt, rj = _run_both(a, g, _b(a, 0), tol=1e-7, restart=80,
                       maxiter=maxiter, params=EXAMPLE)
    assert (int(rj.iters), np.asarray(rj.switch_iters).tolist()) == want
    _same(rt, rj)


def test_fixed_fp64_operator_matches_jax():
    a = J_gen.convection_diffusion_2d(16)
    rt, rj = _run_both(a, None, _b(a, 0), tol=1e-10, restart=60,
                       maxiter=3000, params=dict(t=300, l=9000, m=1500,
                                                 rsd_limit=0.03,
                                                 reldec_limit=0.08,
                                                 ndec_limit=80))
    assert int(rj.iters) == 236 and bool(rj.converged)
    _same(rt, rj)


def test_dense_operator_matches_jax():
    """make_dense_operator: ``mat @ x`` rounded as the reference's jitted
    product (the row GEMV), so a dense GMRES solve is bitwise too."""
    from repro.solvers import make_dense_operator as j_dense

    a = J_gen.convection_diffusion_2d(8, beta=5.0)
    dense = np.zeros(a.shape)
    dense[np.asarray(a.row_ids), np.asarray(a.col)] = np.asarray(a.val)
    b = dense @ np.random.default_rng(4).normal(size=a.shape[0])
    kw = dict(tol=1e-10, restart=20, maxiter=400)
    rj = j_solve_gmres(j_dense(jnp.asarray(dense)), jnp.asarray(b),
                       params=J_P.MonitorParams(**FAST), **kw)
    rt = solve_gmres(make_dense_operator(torch.from_numpy(dense)),
                     torch.from_numpy(b), params=T_P.MonitorParams(**FAST),
                     **kw)
    assert bool(rj.converged)
    _same(rt, rj)


def _row_scaled():
    """tests/test_precond.py's case: convection-diffusion, rows scaled by
    2^U(-4, 4); right-Jacobi restores the stencil's spectrum."""
    rng = np.random.default_rng(11)
    a0 = J_gen.convection_diffusion_2d(16, beta=10.0)
    d = np.exp2(rng.uniform(-4, 4, a0.shape[0]))
    rows = np.asarray(a0.row_ids)
    a = J_csr.from_coo(rows, np.asarray(a0.col), np.asarray(a0.val) * d[rows],
                       a0.shape)
    return a, J_csr.pack_csr(a, k=8), _b(a, 7)


def test_right_jacobi_matches_jax():
    a, g, b = _row_scaled()
    rt, rj = _run_both(a, g, b, precond=True, tol=1e-8, restart=60,
                       maxiter=6000, params=FAST)
    assert (int(rj.iters), np.asarray(rj.switch_iters).tolist()) == (
        234, [89, 104])
    # The cycle update y @ V[:60] in the order of XLA's loop fusion.
    _same(rt, rj)


def test_precond_callable_equals_the_object():
    a, g, b = _row_scaled()
    ta, tg = _port(a, g)
    m = make_jacobi(ta, k=8)
    kw = dict(tol=1e-8, restart=60, maxiter=6000,
              params=T_P.MonitorParams(**FAST))
    r_obj = solve_gmres(make_gse_operator(tg), torch.from_numpy(b), precond=m,
                        **kw)
    r_fn = solve_gmres(make_gse_operator(tg), torch.from_numpy(b),
                       precond=make_precond_operator(m), **kw)
    assert int(r_obj.iters) == int(r_fn.iters)
    assert torch.equal(r_obj.x, r_fn.x)


@pytest.mark.slow
def test_example_case_matches_jax_exactly():
    """examples/solve_stepped_gmres.py's GSE-SEM row: 4633 iterations,
    switches [89, 119], tag 3, bitwise; and its right-Jacobi twin."""
    a, g, b = _example()
    rt, rj = _run_both(a, g, b, tol=1e-7, restart=80, maxiter=8000,
                       params=EXAMPLE)
    assert (int(rj.iters), np.asarray(rj.switch_iters).tolist(),
            int(rj.tag)) == (4633, [89, 119], 3)
    _same(rt, rj)
    rt, rj = _run_both(a, g, b, precond=True, tol=1e-7, restart=80,
                       maxiter=8000, params=EXAMPLE)
    assert (int(rj.iters), np.asarray(rj.switch_iters).tolist()) == (
        283, [119, 178])
    _same(rt, rj)


def test_guards_on_and_off_give_the_same_iterates():
    a, g, b = _example()
    _, tg = _port(a, g)
    kw = dict(tol=1e-7, restart=80, maxiter=300,
              params=T_P.MonitorParams(**EXAMPLE))
    on = solve_gmres(make_gse_operator(tg), torch.from_numpy(b), **kw)
    off = solve_gmres(make_gse_operator(tg), torch.from_numpy(b), guards=None,
                      **kw)
    assert int(on.iters) == int(off.iters) == 300
    assert on.switch_iters.tolist() == off.switch_iters.tolist()
    assert torch.equal(on.x, off.x)
    assert float(on.relres) == float(off.relres)


def test_final_correction_matches_jax():
    """tests/test_solvers.py's case: pinned at tag 1 the recursive residual
    converges, the true one does not, and the correction resumes at tag 3
    with a budget of at least one iteration."""
    a = J_gen.diag_rescale(J_gen.convection_diffusion_2d(12, beta=5.0), 4.0, 6)
    g = J_csr.pack_csr(a, k=8)
    b = np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(6).normal(size=a.shape[1]))))
    params = dict(FAST, max_tag=1)
    rt1, rj1 = _run_both(a, g, b, tol=1e-8, restart=60, maxiter=4000,
                         params=params)
    _same(rt1, rj1)
    n = int(rj1.iters)
    rt2, rj2 = _run_both(a, g, b, tol=1e-8, restart=60, maxiter=n,
                         params=params, final_correction=True)
    assert int(rt2.iters) > n
    _same(rt2, rj2)


def test_monitor_records_the_restart_residual():
    """tests/test_solvers.py's case: one record per inner iteration plus one
    per restart after the first, the recorded restart residual equal to
    the reference's monitor window."""
    a = J_gen.convection_diffusion_2d(12)
    b = _b(a, 0)
    ta, _ = _port(a)
    jp = dict(t=16, l=10_000, m=10_000)
    _, jmon = j_solve_gmres_raw(
        j_fixed(a), jnp.asarray(b), jnp.zeros(b.shape[0]),
        jnp.asarray(1e-14), 4, 8, J_P.MonitorParams(**jp),
        return_monitor=True)
    bt = torch.from_numpy(b)
    res, _, mon = T_gmres._solve_gmres(
        make_fixed_operator(ta), bt, torch.zeros_like(bt),
        torch.tensor(1e-14, dtype=torch.float64), 4, 8,
        T_P.MonitorParams(**jp))
    assert int(res.iters) == 8
    assert int(mon.count) == int(jmon.count) == 9
    np.testing.assert_array_equal(mon.hist.numpy(), np.asarray(jmon.hist))
    res, _, mon = T_gmres._solve_gmres(
        make_fixed_operator(_port(J_gen.convection_diffusion_2d(8))[0]),
        torch.from_numpy(_b(J_gen.convection_diffusion_2d(8), 0)),
        torch.zeros(64, dtype=torch.float64),
        torch.tensor(1e-14, dtype=torch.float64), 80, 80,
        T_P.MonitorParams(**jp))
    assert int(mon.count) == int(res.iters)


def test_b_layouts_and_unported_options():
    a, g, b = _row_scaled()
    ta, tg = _port(a, g)
    op = make_gse_operator(tg)
    kw = dict(tol=1e-6, restart=20, maxiter=60,
              params=T_P.MonitorParams(**FAST))
    r1 = solve_gmres(op, torch.from_numpy(b), **kw)
    r2 = solve_gmres(op, torch.from_numpy(b)[:, None], **kw)
    assert tuple(r2.x.shape) == (b.shape[0], 1)
    assert torch.equal(r1.x, r2.x[:, 0])
    r3 = solve_gmres(op, torch.from_numpy(b),
                     flight=FlightParams(capacity=32), **kw)
    assert torch.equal(r3.x, r1.x)
    assert int(r3.flight["count"]) == int(r1.iters)
    with pytest.raises(TypeError, match="FlightParams"):
        solve_gmres(op, torch.from_numpy(b), flight=object(), **kw)
    with pytest.raises(TypeError, match="apply_a"):
        solve_gmres(tg, torch.from_numpy(b), **kw)
    assert T_guards.health_name(r1.health) in T_guards.HEALTH_NAMES


def test_gmres_setup_matches_the_reference():
    from repro.configs import paper_solver as J_ps

    ja, jparams = J_ps.gmres_setup("convdiff_rs4_32")
    ta, tparams = paper_solver.gmres_setup("convdiff_rs4_32", device="cpu")
    np.testing.assert_array_equal(ta.val.numpy(), np.asarray(ja.val))
    np.testing.assert_array_equal(ta.col.numpy(), np.asarray(ja.col))
    assert dataclass_fields(tparams) == dataclass_fields(jparams)
    ca, cparams = paper_solver.cg_setup("poisson2d_64", device="cpu")
    ja, jparams = J_ps.cg_setup("poisson2d_64")
    np.testing.assert_array_equal(ca.val.numpy(), np.asarray(ja.val))
    assert dataclass_fields(cparams) == dataclass_fields(jparams)


def dataclass_fields(p):
    return (p.t, p.l, p.m, p.rsd_limit, p.reldec_limit, p.ndec, p.max_tag)
