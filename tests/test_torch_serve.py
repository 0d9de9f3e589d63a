"""The port's solve service against the JAX reference's ``SolverService``.

On ``rs8_400_s3`` (``diag_rescale(random_spd(400, seed=3), 8, 3)``, three
requests ``b_j = A x_j``, ``x_j = default_rng(j).normal(400)``, slots=4)
every ``SolveReport`` field, the service ``stats`` and the solutions equal
the reference's: at maxiter 20000 (every request converges on its own
schedule) and at maxiter 200 (every request degrades and takes the
bounded tag-3 retry).  Intake validation, bucketing by tolerance and by
start tag, slot overflow and ``solution()`` follow the reference too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.launch import solver_serve as J_s  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.launch import solver_serve as T_s  # noqa: E402

QS = dict(t=40, l=60, m=30)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solver loops run thousands of tiny CPU ops: one intra-op thread
    is faster than a pool and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d["switch_iters"] = np.asarray(report.switch_iters).tolist()
    d["relres"] = np.float64(report.relres).view(np.uint64)  # bit for bit
    return d


def _port_csr(a):
    return csr_from_repro({n: np.asarray(getattr(a, n))
                           for n in ("rowptr", "col", "val", "row_ids")},
                          a.shape, device=CPU)


def _rhs(a, seed):
    return np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(seed).normal(size=a.shape[1]))))


def _both(a, maxiter, slots=4, params=QS, register=None):
    """A reference and a port service, ``a`` registered as ``"op"``."""
    js = J_s.SolverService(slots=slots, params=J_P.MonitorParams(**params),
                           maxiter=maxiter)
    ts = T_s.SolverService(slots=slots, params=T_P.MonitorParams(**params),
                           maxiter=maxiter, device=CPU)
    js.register("op", a, k=8, **(register or {}))
    ts.register("op", _port_csr(a), k=8, **(register or {}))
    return js, ts


def _assert_same(js, ts, jids, tids, jrep, trep):
    assert dict(ts.stats) == dict(js.stats)
    for ji, ti in zip(jids, tids):
        assert _fields(trep[ti]) == _fields(jrep[ji])
        xj = np.asarray(js.solution(ji))
        xt = ts.solution(ti).numpy()
        assert np.array_equal(xt.view(np.uint64), xj.view(np.uint64))


@pytest.fixture(scope="module")
def rs8():
    return J_gen.diag_rescale(J_gen.random_spd(400, seed=3), 8.0, 3)


@pytest.mark.parametrize("maxiter", [20000, 200])
def test_reports_and_stats_equal_the_reference(rs8, maxiter):
    js, ts = _both(rs8, maxiter)
    bs = [_rhs(rs8, j) for j in range(3)]
    jids = [js.submit("op", jnp.asarray(b), tol=1e-8) for b in bs]
    tids = [ts.submit("op", torch.from_numpy(b), tol=1e-8) for b in bs]
    assert ts.queue_depth.value == 3
    jrep, trep = js.flush(), ts.flush()
    assert ts.queue_depth.value == 0
    reps = [trep[t] for t in tids]
    if maxiter == 20000:
        assert [r.iters for r in reps] == [1632, 1752, 1727]
        assert [r.est_bytes for r in reps] == [48919728, 55134798, 53096498]
        assert [r.health for r in reps] == ["ok"] * 3
        assert ts.stats["modeled_bytes"] == 157151024
    else:
        assert [r.iters for r in reps] == [400] * 3
        assert [r.retries for r in reps] == [1] * 3
        assert [r.health for r in reps] == ["stalled"] * 3
        assert ts.stats["retries"] == 3
    _assert_same(js, ts, jids, tids, jrep, trep)


def test_submit_validation():
    a = J_gen.poisson2d(8)
    _, ts = _both(a, 20000)
    n = a.shape[0]
    with pytest.raises(KeyError, match="unknown handle"):
        ts.submit("nope", np.zeros(n))
    with pytest.raises(ValueError, match="b must be"):
        ts.submit("op", np.zeros(n + 1))
    with pytest.raises(ValueError, match="b must be"):
        ts.submit("op", np.zeros((n, 2)))
    with pytest.raises(ValueError, match="floating"):
        ts.submit("op", np.zeros(n, dtype=np.int64))
    bad = np.zeros(n)
    bad[3] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        ts.submit("op", bad)
    with pytest.raises(ValueError, match="non-finite"):
        ts.submit("op", np.zeros(n), x0=bad)
    with pytest.raises(ValueError, match="deadline_s"):
        ts.submit("op", np.zeros(n), deadline_s=0)
    # (n, 1) b and (n, 1) x0 are accepted.
    rid = ts.submit("op", _rhs(a, 0)[:, None], x0=np.zeros((n, 1)))
    assert rid in ts.flush()
    with pytest.raises(ValueError, match="x0 shape"):
        ts.submit("op", _rhs(a, 0), x0=np.zeros((n, 2)))
    with pytest.raises(ValueError, match="already registered"):
        ts.register("op", _port_csr(a))
    with pytest.raises(ValueError, match="unknown preconditioner"):
        ts.register("op2", _port_csr(a), precond="ilu")
    with pytest.raises(ValueError, match="slots"):
        T_s.SolverService(slots=0, device=CPU)
    with pytest.raises(ValueError, match="max_retries"):
        T_s.SolverService(max_retries=-1, device=CPU)
    with pytest.raises(ValueError, match="expected cuda"):
        T_s.SolverService().register("op", _port_csr(a))


@pytest.mark.parametrize("kw, item", [
    (dict(precond="jacobi", sharded=True), "item 15"),
    (dict(tags=2, sharded=True), "item 15"),
    (dict(sharded=True), "item 15"),
])
def test_unported_register_options_raise(kw, item):
    a = _port_csr(J_gen.poisson2d(8))
    svc = T_s.SolverService(device=CPU)
    with pytest.raises(NotImplementedError, match=item):
        svc.register("op", a, **kw)
    assert "op" not in svc._ops


@pytest.mark.parametrize("kw", [
    dict(plan="c16"),
    dict(tags="adaptive", plan="default"),
    dict(tune=True),
], ids=["plan", "adaptive-plan", "tune"])
def test_register_plan_and_tune_options(kw, tmp_path, monkeypatch):
    """``plan=`` and ``tune=True`` (launch plans, ported) register the
    handle with its plan kept on it; the reports and solutions are bitwise
    the untuned handle's."""
    from repro_torch.perf import tunecache
    from repro_torch.perf.plan import DEFAULT_PLAN, KernelPlan

    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc.json"))
    tunecache.clear_memory()
    plans = {"c16": KernelPlan(blocks=(16, 128), sell_c=16),
             "default": DEFAULT_PLAN}
    kw = dict(kw)
    if "plan" in kw:
        kw["plan"] = plans[kw["plan"]]
    a = J_gen.poisson2d(8)
    b = _rhs(a, 0)
    out = []
    try:
        untuned = {k: v for k, v in kw.items() if k not in ("plan", "tune")}
        for extra in (kw, untuned):
            svc = T_s.SolverService(slots=2, params=T_P.MonitorParams(**QS),
                                    maxiter=2000, device=CPU)
            svc.register("op", _port_csr(a), **extra)
            rid = svc.submit("op", torch.from_numpy(b), tol=1e-8)
            out.append((svc._ops["op"].plan, _fields(svc.flush()[rid]),
                        svc.solution(rid)))
    finally:
        tunecache.clear_memory()
    (plan, rep, x), (plan0, rep0, x0) = out
    assert plan0 is None and plan is not None
    if "plan" in kw:
        assert plan is kw["plan"]
    else:
        assert plan.source == "tuned" and tunecache.TUNE_STATS["sweeps"] > 0
    assert rep == rep0 and rep["converged"]
    assert torch.equal(x.view(torch.int64), x0.view(torch.int64))


def test_bucketing_by_tol_and_tag_and_slot_overflow():
    """Requests bucket by (handle, tol, start tag); a bucket wider than the
    slot width spills into another batch; all reports equal the
    reference's."""
    a = J_gen.poisson2d(12)
    js, ts = _both(a, 20000, slots=2, register=dict(tags=1))
    plan = [(0, 1e-8, None), (1, 1e-8, None), (2, 1e-8, None),
            (3, 1e-6, None), (4, 1e-8, 2)]
    jids = [js.submit("op", jnp.asarray(_rhs(a, s)), tol=tol, tags=tag)
            for s, tol, tag in plan]
    tids = [ts.submit("op", torch.from_numpy(_rhs(a, s)), tol=tol, tags=tag)
            for s, tol, tag in plan]
    jrep, trep = js.flush(), ts.flush()
    assert ts.stats["batches"] == 4  # 2 + 1 at 1e-8, 1 at 1e-6, 1 at tag 2
    assert ts.stats["padded_cols"] == 3
    assert [trep[t].batch_size for t in tids] == [2, 2, 1, 1, 1]
    assert trep[tids[3]].iters < trep[tids[0]].iters
    _assert_same(js, ts, jids, tids, jrep, trep)


def test_solution_pops_and_the_next_flush_forgets():
    a = J_gen.poisson2d(8)
    _, ts = _both(a, 20000)
    rid = ts.submit("op", _rhs(a, 1))
    assert ts.flush()[rid].converged
    x = ts.solution(rid)
    assert x.shape == (64,) and x.dtype == torch.float64
    with pytest.raises(KeyError, match="no flushed solution"):
        ts.solution(rid)
    rid2 = ts.submit("op", _rhs(a, 2))
    ts.flush()
    ts.flush()  # a flush clears what the previous one kept
    with pytest.raises(KeyError):
        ts.solution(rid2)


def test_demo_runs_on_the_cpu(capsys):
    T_s.main(["--device", "cpu", "--requests", "3", "--slots", "2",
              "--n", "8"])
    out = capsys.readouterr().out
    assert out.count("converged=True") == 3
    assert "served 3 requests in 2 batches" in out
