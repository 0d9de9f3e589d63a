"""The port's stepped iterative refinement against the JAX reference.

Quickstart section 5's system -- ``ill_conditioned_spd(32, 8 decades)``
packed at k=8, Jacobi at k=8, ``b = spmv(a, r)`` with ``r`` the first
normal draw of ``default_rng(0)`` and ``b'`` the second -- refined to
tol 1e-11 (max_outer 10, inner_tol 1e-4): with inner PCG (Jacobi), inner
CG (at a smaller inner budget, so that tier-1 stays short) and inner
right-Jacobi GMRES at restarts 30 and 80.  The outer and inner counts,
``relres``, the outer history and ``x`` are the reference's bit for bit
(tools/reference/ir_ref.py prints the reference's numbers), and so are
``solve_ir_batched``'s on ``[b, 2b, b', 0]``, column for column the solo
runs.  The stop rules (a non-finite correction, ``max_outer``, an inner
solve of no iterations) end as the reference's do, and no correction's
``r``, ``d`` or ``x`` holds a subnormal (XLA's CPU runtime flushes them;
the port does not).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers import solve_ir as j_solve_ir  # noqa: E402
from repro.solvers import solve_ir_batched as j_solve_ir_batched  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.configs import paper_solver  # noqa: E402
from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.obs.flight import FlightParams  # noqa: E402
from repro_torch.robustness import guards as T_guards  # noqa: E402
from repro_torch.solvers import ir as T_ir  # noqa: E402
from repro_torch.solvers import (make_gse_operator, make_jacobi,  # noqa: E402
                                 solve_ir, solve_ir_batched)

CPU = "cpu"
FAST = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
IR_KW = dict(tol=1e-11, max_outer=10, inner_tol=1e-4, inner_maxiter=4000)
# name: (inner, precond, restart, fast monitor, extra kwargs, the
# reference's (outer, inner, relres) from tools/reference/ir_ref.py or
# None where the budget is cut)
CASES = {
    "pcg_jacobi": ("cg", True, 30, True, {}, (5, 296, 6.254406590631485e-14)),
    "cg_short": ("cg", False, 30, True, dict(inner_maxiter=500, max_outer=3),
                 None),
    "gmres_jacobi_r30": ("gmres", True, 30, False, {},
                         (5, 385, 9.012640712211029e-14)),
    "gmres_jacobi_r80": ("gmres", True, 80, False, {},
                         (5, 280, 7.253042026086966e-14)),
}
TINY = np.finfo(np.float64).tiny


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: the stepped loops run thousands
    of tiny ops, which a thread pool shared with the other test workers
    only slows."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(v):
    return np.asarray(v, dtype=np.float64).view(np.uint64)


def _subnormals(v) -> int:
    v = np.abs(np.asarray(v))
    return int(((v != 0) & (v < TINY)).sum())


@pytest.fixture(scope="module")
def quick():
    a = J_gen.ill_conditioned_spd(32, decades=8.0, seed=0)
    g = J_csr.pack_csr(a, k=8)
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device=CPU)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    rng = np.random.default_rng(0)
    b = np.array(j_spmv(a, jnp.asarray(rng.normal(size=a.shape[1]))))
    b2 = np.array(j_spmv(a, jnp.asarray(rng.normal(size=a.shape[1]))))
    return dict(a=a, g=g, ta=ta, tg=tg, b=b, b2=b2, jm=j_jacobi(a, k=8),
                tm=make_jacobi(ta, k=8), port={})


def _kwargs(case, q, port: bool):
    inner, pre, restart, fast, extra, _ = CASES[case]
    P = T_P if port else J_P
    kw = dict(IR_KW, inner=inner, restart=restart, **extra)
    kw["params"] = P.MonitorParams(**FAST) if fast else None
    kw["precond"] = (q["tm"] if port else q["jm"]) if pre else None
    return kw


def _port_run(case, q):
    """The port's solve_ir on ``case``, driven a correction at a time
    through ``_ir_setup``/``_ir_step`` (as ``solve_ir`` is), counting the
    subnormals in every correction's r, d and x; run once per module."""
    if case not in q["port"]:
        kw = _kwargs(case, q, port=True)
        st = T_ir._ir_setup(q["tg"], torch.from_numpy(q["b"]), guards=
                            T_guards.DEFAULT_GUARDS, flight=None, **kw)
        scanned = 0
        while T_ir._ir_active(st):
            T_ir._ir_step(st)
            for name in ("r", "d", "x"):
                scanned += _subnormals(st[name].numpy())
        q["port"][case] = (T_ir._ir_result(st), scanned)
    return q["port"][case]


@pytest.mark.parametrize("case", list(CASES))
def test_solve_ir_matches_the_reference(case, quick):
    q = quick
    rj = j_solve_ir(q["g"], jnp.asarray(q["b"]), **_kwargs(case, q, False))
    rt, _ = _port_run(case, q)
    want = CASES[case][-1]
    if want is not None:
        assert (rj.outer_iters, rj.inner_iters, float(rj.relres)) == want
    assert (rt.outer_iters, rt.inner_iters) == (rj.outer_iters,
                                                rj.inner_iters)
    assert rt.relres == float(rj.relres)
    assert rt.converged == bool(rj.converged)
    assert rt.health == int(rj.health)
    assert np.array_equal(_bits(rt.history), _bits(rj.history))
    assert np.array_equal(_bits(rt.x.numpy()), _bits(rj.x))


def test_solve_ir_equals_the_driven_loop(quick):
    """solve_ir is the _ir_* loop; an operator callable gives the GSECSR's
    bits (the fused inner PCG against the generic one)."""
    q = quick
    kw = _kwargs("pcg_jacobi", q, port=True)
    want, _ = _port_run("pcg_jacobi", q)
    for op in (q["tg"], make_gse_operator(q["tg"])):
        got = solve_ir(op, torch.from_numpy(q["b"]), **kw)
        assert (got.outer_iters, got.inner_iters) == (want.outer_iters,
                                                      want.inner_iters)
        assert torch.equal(got.x, want.x) and got.relres == want.relres


def test_solve_ir_batched_matches_the_reference(quick):
    """[b, 2b, b', 0]: outer [5, 5, 5, 0], inner [296, 296, 289, 0]; each
    column is its solo run, and 2b gives b's relres and twice its x."""
    q = quick
    block = np.stack([q["b"], 2 * q["b"], q["b2"], np.zeros_like(q["b"])],
                     axis=1)
    kw = dict(IR_KW, params=None)
    rj = j_solve_ir_batched(q["g"], jnp.asarray(block), precond=q["jm"],
                            **dict(kw, params=J_P.MonitorParams(**FAST)))
    rt = solve_ir_batched(q["tg"], torch.from_numpy(block), precond=q["tm"],
                          device=CPU,
                          **dict(kw, params=T_P.MonitorParams(**FAST)))
    assert rt.outer_iters.tolist() == [5, 5, 5, 0]
    assert rt.inner_iters.tolist() == [296, 296, 289, 0]
    for name in ("outer_iters", "inner_iters", "converged", "health"):
        assert np.asarray(getattr(rt, name)).tolist() == \
            np.asarray(getattr(rj, name)).tolist(), name
    assert np.array_equal(_bits(rt.relres), _bits(rj.relres))
    assert np.array_equal(_bits(rt.x.numpy()), _bits(rj.x))
    for ht, hj in zip(rt.history, rj.history):
        assert np.array_equal(_bits(ht), _bits(hj))
    solo, _ = _port_run("pcg_jacobi", q)
    assert torch.equal(rt.x[:, 0], solo.x)
    assert rt.relres[0] == rt.relres[1] == solo.relres
    assert torch.equal(rt.x[:, 1], 2 * solo.x)
    solo2 = solve_ir(q["tg"], torch.from_numpy(q["b2"]), precond=q["tm"],
                     **dict(kw, params=T_P.MonitorParams(**FAST)))
    assert torch.equal(rt.x[:, 2], solo2.x)
    assert rt.relres[2] == solo2.relres


def test_ir_setup_matches_the_reference():
    from repro.configs import paper_solver as J_ps

    ja, jm, jp = J_ps.ir_setup()
    ta, tm, tp = paper_solver.ir_setup(device=CPU)
    np.testing.assert_array_equal(ta.val.numpy(), np.asarray(ja.val))
    np.testing.assert_array_equal(ta.col.numpy(), np.asarray(ja.col))
    for name in ("table", "head", "tail1", "tail2"):
        np.testing.assert_array_equal(np.asarray(getattr(tm.packed, name)),
                                      np.asarray(getattr(jm.packed, name)))
    assert tm.kind == jm.kind == "jacobi"
    assert (tp.t, tp.l, tp.m, tp.ndec) == (jp.t, jp.l, jp.m, jp.ndec)


# --- the stop rules --------------------------------------------------------------

def _both(q, **kw):
    params = kw.pop("params", FAST)
    rj = j_solve_ir(q["g"], jnp.asarray(q["b"]),
                    params=J_P.MonitorParams(**params),
                    **{k: v[0] if isinstance(v, tuple) else v
                       for k, v in kw.items()})
    rt = solve_ir(q["tg"], torch.from_numpy(q["b"]),
                  params=T_P.MonitorParams(**params),
                  **{k: v[1] if isinstance(v, tuple) else v
                     for k, v in kw.items()})
    for name in ("outer_iters", "inner_iters", "converged", "health"):
        assert getattr(rt, name) == getattr(rj, name), name
    assert rt.relres == float(rj.relres)
    assert np.array_equal(_bits(rt.x.numpy()), _bits(rj.x))
    return rt


def test_non_finite_correction_is_not_folded_in(quick):
    """An inner PCG whose preconditioner returns inf gives a non-finite
    correction: the loop stops before folding it, x stays 0."""
    q = quick
    inf_j = lambda r, tag: r * jnp.inf  # noqa: E731
    inf_t = lambda r, tag: r * torch.inf  # noqa: E731
    rt = _both(q, tol=1e-11, max_outer=10, inner_tol=1e-4, inner_maxiter=40,
               precond=(inf_j, inf_t), guards=None)
    assert rt.outer_iters == 0 and not bool(rt.x.any())
    assert not rt.converged and rt.history.tolist() == [1.0]


def test_max_outer_exhaustion_reports_stalled(quick):
    rt = _both(quick, tol=1e-11, max_outer=2, inner_tol=1e-4,
               inner_maxiter=4000, precond=(quick["jm"], quick["tm"]))
    assert rt.outer_iters == 2 and not rt.converged
    assert T_guards.health_name(rt.health) == "stalled"


def test_zero_iteration_inner_solve_stops_the_loop(quick):
    """inner_maxiter 0: the inner solve runs no iteration and does not
    converge, so one (zero) correction is folded in and the loop stops."""
    rt = _both(quick, tol=1e-11, max_outer=10, inner_tol=1e-4,
               inner_maxiter=0, precond=(quick["jm"], quick["tm"]))
    assert (rt.outer_iters, rt.inner_iters) == (1, 0)
    assert len(rt.history) == 2 and rt.history[1] == rt.history[0]


@pytest.mark.parametrize("case", list(CASES))
def test_no_correction_holds_a_subnormal(case, quick):
    """XLA's CPU runtime flushes subnormals to zero, the port does not:
    the named cases must not produce one in any correction's r, d or x
    (late corrections have right-hand sides near 1e-14 of ||b||)."""
    _, scanned = _port_run(case, quick)
    assert scanned == 0


def test_options_and_layouts(quick):
    q = quick
    b = torch.from_numpy(q["b"])
    kw = dict(tol=1e-11, max_outer=1, inner_maxiter=30,
              params=T_P.MonitorParams(**FAST))
    r1 = solve_ir(q["tg"], b, **kw)
    r2 = solve_ir(q["tg"], b[:, None], **kw)
    assert tuple(r2.x.shape) == (b.shape[0], 1)
    assert torch.equal(r1.x, r2.x[:, 0])
    r3 = solve_ir(q["tg"], b, tags=2, **kw)  # an int tag threads through
    assert r3.inner_iters == 30 and not torch.equal(r3.x, r1.x)
    rf = solve_ir(q["tg"], b, flight=FlightParams(capacity=16), **kw)
    assert torch.equal(rf.x, r1.x) and len(rf.flight) == r1.outer_iters == 1
    assert int(rf.flight[0]["count"]) == r1.inner_iters == 30
    with pytest.raises(TypeError, match="FlightParams"):
        solve_ir(q["tg"], b, flight=object())
    with pytest.raises(TypeError, match="TagMap"):  # not a precision axis
        solve_ir(q["tg"], b, tags=object())
    with pytest.raises(NotImplementedError, match="item 15"):
        solve_ir(object(), b)
    with pytest.raises(ValueError, match="inner"):
        solve_ir(q["tg"], b, inner="bicg")
    with pytest.raises(ValueError, match="tags= requires inner='cg'"):
        solve_ir(q["tg"], b, inner="gmres", tags=2)
    with pytest.raises(TypeError, match="TagMap"):
        solve_ir_batched(q["tg"], b, tags=object(), device=CPU)
