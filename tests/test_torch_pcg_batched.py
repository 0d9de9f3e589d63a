"""The port's batched stepped PCG and its preconditioned solve service
against the JAX reference.

Quickstart section 4's system (``ill_conditioned_spd(32, 8 decades)``,
tol 1e-10, the fast monitor) on the block ``[b, b', 0]`` with Jacobi,
block-Jacobi and SPAI-0: the port's iterations, tags, switches, health
and solutions are the reference's bit for bit, and column j is the port's
solo ``solve_pcg``.  The fused path (kernel C64 for the operator, the
preconditioner's column apply) equals the generic one, SELL equals CSR,
guards on equal guards off, and ``batched_run_bytes`` charges the
preconditioner as the reference does.  The service with ``precond=`` on
``rs8_400_s3`` gives the reference's reports, stats and solutions, with
and without the tag-3 PCG retry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.launch import solver_serve as J_s  # noqa: E402
from repro.solvers import batched as J_b  # noqa: E402
from repro.solvers import make_block_jacobi as j_block  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers import make_spai0 as j_spai0  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.launch import solver_serve as T_s  # noqa: E402
from repro_torch.solvers import batched as T_b  # noqa: E402
from repro_torch.solvers import (make_block_jacobi, make_gse_operator,  # noqa: E402
                                 make_jacobi, make_precond_operator,
                                 make_spai0, solve_pcg)

CPU = "cpu"
FAST = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
QS = dict(t=40, l=60, m=30)
KINDS = {"jacobi": (j_jacobi, make_jacobi),
         "block_jacobi": (j_block, make_block_jacobi),
         "spai0": (j_spai0, make_spai0)}
# quickstart section 4's solo schedules (tests/test_torch_pcg.py):
# column 0's (iters, switch_iters, tag).
SOLO = {"jacobi": (115, [-1, -1], 1), "block_jacobi": (95, [-1, -1], 1),
        "spai0": (1107, [120, 135], 3)}
KW = dict(tol=1e-10, maxiter=5000)


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


def _port(a, g):
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device=CPU)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    return ta, tg


def _rhs(a, seed):
    return np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(seed).normal(size=a.shape[1]))))


@pytest.fixture(scope="module")
def illcond():
    a = J_gen.ill_conditioned_spd(32, decades=8.0, seed=0)
    g = J_csr.pack_csr(a, k=8)
    ta, tg = _port(a, g)
    block = np.stack([_rhs(a, 0), _rhs(a, 1), np.zeros(a.shape[0])], axis=1)
    return a, g, ta, tg, block


def _same(rt, rj):
    """Every field of two batched results, bit for bit."""
    for name in ("iters", "tag", "switch_iters", "converged", "health",
                 "trip_iter"):
        assert np.asarray(getattr(rt, name)).tolist() == \
            np.asarray(getattr(rj, name)).tolist(), name
    assert np.array_equal(_bits(rt.relres.numpy()), _bits(rj.relres))
    assert np.array_equal(_bits(rt.x.numpy()), _bits(rj.x))


@pytest.mark.parametrize("kind", list(KINDS))
def test_batched_pcg_is_the_reference_and_the_solo_solve(kind, illcond):
    a, g, ta, tg, block = illcond
    params = dict(params=J_P.MonitorParams(**FAST), **KW)
    rj = J_b.solve_pcg_batched(g, jnp.asarray(block), KINDS[kind][0](a, k=8),
                               **params)
    m = KINDS[kind][1](ta, k=8)
    rt = T_b.solve_pcg_batched(tg, torch.from_numpy(block), m,
                               params=T_P.MonitorParams(**FAST), device=CPU,
                               **KW)
    _same(rt, rj)
    assert (int(rt.iters[0]), rt.switch_iters[0].tolist(),
            int(rt.tag[0])) == SOLO[kind]
    assert int(rt.iters[2]) == 0 and bool(rt.converged.all())
    solo = solve_pcg(tg, torch.from_numpy(block[:, 0]), m,
                     params=T_P.MonitorParams(**FAST), **KW)
    assert torch.equal(rt.x[:, 0], solo.x)
    assert float(rt.relres[0]) == float(solo.relres)
    assert rt.switch_iters[0].tolist() == solo.switch_iters.tolist()


@pytest.mark.parametrize("kind", list(KINDS))
def test_fused_path_equals_the_generic_path(kind, illcond):
    """C64 plus the preconditioner's column apply against the operator and
    preconditioner callables applied column by column, over a budget past
    SPAI-0's two switches."""
    _, _, ta, tg, block = illcond
    m = KINDS[kind][1](ta, k=8)
    kw = dict(tol=1e-10, maxiter=150, params=T_P.MonitorParams(**FAST),
              device=CPU)
    b = torch.from_numpy(block)
    fused = T_b.solve_pcg_batched(tg, b, m, **kw)
    generic = T_b.solve_pcg_batched(make_gse_operator(tg), b,
                                    make_precond_operator(m), **kw)
    _same(fused, generic)
    if kind == "spai0":
        assert fused.switch_iters[0].tolist() == [120, 135]


def test_apply_cols_is_apply_at_per_column(illcond):
    """Each preconditioner's column apply: column j bitwise apply_at at
    tags[j]."""
    _, _, ta, _, _ = illcond
    r = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 1024)))
    tags = torch.tensor([1, 2, 3, 2], dtype=torch.int32)
    for kind in KINDS:
        m = KINDS[kind][1](ta, k=8)
        z = m.apply_cols(r, tags, device=CPU)
        for j in range(4):
            assert torch.equal(z[j], m.apply_at(r[j], int(tags[j]))), kind


def test_sell_layout_equals_csr(illcond):
    _, _, ta, tg, block = illcond
    m = make_jacobi(ta, k=8)
    kw = dict(params=T_P.MonitorParams(**FAST), device=CPU, **KW)
    b = torch.from_numpy(block)
    r_csr = T_b.solve_pcg_batched(tg, b, m, **kw)
    r_sell = T_b.solve_pcg_batched(T_ops.sell_pack_gsecsr(tg), b, m, **kw)
    _same(r_sell, r_csr)


def test_guards_on_and_off_give_the_same_iterates(illcond):
    _, _, ta, tg, block = illcond
    m = make_block_jacobi(ta, k=8)
    kw = dict(params=T_P.MonitorParams(**FAST), device=CPU, **KW)
    b = torch.from_numpy(block)
    on = T_b.solve_pcg_batched(tg, b, m, **kw)
    off = T_b.solve_pcg_batched(tg, b, m, guards=None, **kw)
    assert on.iters.tolist() == off.iters.tolist()
    assert torch.equal(on.x, off.x) and torch.equal(on.relres, off.relres)


def test_indefinite_preconditioner_breaks_down_per_column(illcond):
    """A negative diagonal ``M^{-1}`` makes z.r < 0: the guard flags
    breakdown in every real column, as the reference's does, and the zero
    column stays ok."""
    a, g, ta, tg, block = illcond
    rows, cols, vals = (np.asarray(getattr(a, n))
                        for n in ("row_ids", "col", "val"))
    neg = np.zeros(a.shape[0])
    neg[rows[rows == cols]] = -1.0 / vals[rows == cols]
    kw = dict(tol=1e-10, maxiter=50)
    jneg, tneg = jnp.asarray(neg), torch.from_numpy(neg)
    rj = J_b.solve_pcg_batched(g, jnp.asarray(block),
                               lambda r, tag: jneg * r,
                               params=J_P.MonitorParams(**FAST), **kw)
    rt = T_b.solve_pcg_batched(tg, torch.from_numpy(block),
                               lambda r, tag: tneg * r,
                               params=T_P.MonitorParams(**FAST), device=CPU,
                               **kw)
    _same(rt, rj)
    assert rt.health.tolist() == [1, 1, 0]


@pytest.mark.parametrize("kind", list(KINDS))
def test_batched_run_bytes_charges_the_preconditioner(kind, illcond):
    a, g, ta, tg, _ = illcond
    jm, tm = KINDS[kind][0](a, k=8), KINDS[kind][1](ta, k=8)
    iters = [115, 95, 0, 40]
    sw = [[20, 60], [-1, -1], [-1, -1], [10, -1]]
    got = T_b.batched_run_bytes(tg, iters, sw, precond=tm)
    assert got == J_b.batched_run_bytes(g, np.asarray(iters), np.asarray(sw),
                                        precond=jm)
    assert got > T_b.batched_run_bytes(tg, iters, sw)


# --- the preconditioned solve service ------------------------------------------

def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d["switch_iters"] = np.asarray(report.switch_iters).tolist()
    d["relres"] = np.float64(report.relres).view(np.uint64)  # bit for bit
    return d


# tools/reference/ir_ref.py's PCG_SERVICE_REF: per request (iters, tag,
# health, retries, est_bytes).  Jacobi undoes rs8_400_s3's diagonal
# rescale, so maxiter 4 is what sends every request to the tag-3 retry.
SERVICE_REF = {
    ("jacobi", 20000): [(7, 1, "ok", 0, 128837)] * 3,
    ("jacobi", 4): [(8, 3, "ok", 1, 243285)] * 3,
    ("spai0", 20000): [(34, 1, "ok", 0, 637787), (32, 1, "ok", 0, 588971),
                       (35, 1, "ok", 0, 680203)],
    ("spai0", 4): [(8, 3, "stalled", 1, 243285)] * 3,
}


@pytest.mark.parametrize("kind,maxiter", list(SERVICE_REF))
def test_preconditioned_service_equals_the_reference(kind, maxiter):
    a = J_gen.diag_rescale(J_gen.random_spd(400, seed=3), 8.0, 3)
    ta, _ = _port(a, J_csr.pack_csr(a, k=8))
    js = J_s.SolverService(slots=4, params=J_P.MonitorParams(**QS),
                           maxiter=maxiter)
    ts = T_s.SolverService(slots=4, params=T_P.MonitorParams(**QS),
                           maxiter=maxiter, device=CPU)
    js.register("op", a, k=8, precond=kind)
    ts.register("op", ta, k=8, precond=kind)
    bs = [_rhs(a, j) for j in range(3)]
    jids = [js.submit("op", jnp.asarray(b), tol=1e-8) for b in bs]
    tids = [ts.submit("op", torch.from_numpy(b), tol=1e-8) for b in bs]
    jrep, trep = js.flush(), ts.flush()
    assert [(trep[t].iters, trep[t].tag, trep[t].health, trep[t].retries,
             trep[t].est_bytes) for t in tids] == SERVICE_REF[kind, maxiter]
    assert dict(ts.stats) == dict(js.stats)
    for ji, ti in zip(jids, tids):
        assert _fields(trep[ti]) == _fields(jrep[ji])
        assert np.array_equal(_bits(ts.solution(ti).numpy()),
                              _bits(js.solution(ji)))


def test_service_takes_a_ready_preconditioner_and_a_sell_handle():
    """A packed preconditioner object serves like its name, and a SELL
    handle like the CSR one (the byte shares differ by the padding)."""
    a = J_gen.poisson2d(10)
    ta, _ = _port(a, J_csr.pack_csr(a, k=8))
    runs = {}
    for name, kw in (("str", dict(precond="spai0")),
                     ("obj", dict(precond=make_spai0(ta, k=8))),
                     ("sell", dict(precond="spai0", layout="sell"))):
        svc = T_s.SolverService(slots=2, params=T_P.MonitorParams(**QS),
                                device=CPU)
        svc.register("op", ta, k=8, **kw)
        rid = svc.submit("op", torch.from_numpy(_rhs(a, 5)), tol=1e-9)
        runs[name] = (svc.flush()[rid], svc.solution(rid))
    assert _fields(runs["obj"][0]) == _fields(runs["str"][0])
    assert runs["sell"][0].iters == runs["str"][0].iters
    for name in ("obj", "sell"):
        assert torch.equal(runs[name][1], runs["str"][1])
    with pytest.raises(ValueError, match="unknown preconditioner"):
        T_s.SolverService(device=CPU).register("op", ta, precond="ilu")


def test_preconditioned_demo_runs_on_the_cpu(capsys):
    T_s.main(["--device", "cpu", "--requests", "3", "--slots", "2",
              "--n", "8", "--precond", "jacobi"])
    out = capsys.readouterr().out
    assert out.count("converged=True") == 3 and "health=ok" in out
