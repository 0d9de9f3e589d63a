"""The port's solve service over the SELL-C-sigma layout against the JAX
reference's ``SolverService.register(..., layout="sell")``.

On ``sk512_rs8_s0`` (``diag_rescale(skewed_spd(512, seed=0), 8, 0)``,
three requests ``b_j = A x_j``, ``x_j = default_rng(j).normal(512)``,
slots=4) every ``SolveReport`` field, the service ``stats`` and the
solutions equal the reference's: at maxiter 20000 (every request converges
on its own schedule; the byte reports charge the SELL pack's padded slots)
and at maxiter 200 (every request stalls and takes the bounded tag-3
retry over the SELL pack).  ``register`` rejects an unknown layout and
``sharded`` with ``"sell"`` as the reference does.
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
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.launch import solver_serve as T_s  # noqa: E402
from repro_torch.sparse.csr import GSESellC  # noqa: E402

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


@pytest.fixture(scope="module")
def sk512():
    return J_gen.diag_rescale(J_gen.skewed_spd(512, seed=0), 8.0, 0)


# The reference's reports at each maxiter (JAX on the CPU, x64): per
# request (iters, tag, switch_iters, health, retries, est_bytes), then the
# stats.
REF = {
    20000: ([(1498, 3, [210, 300], "ok", 0, 406957675),
             (1498, 3, [150, 180], "ok", 0, 406957675),
             (1678, 3, [120, 150], "ok", 0, 557737195)],
            dict(batches=1, requests=3, padded_cols=1,
                 modeled_bytes=1371652544, retries=0, errors=0,
                 deadline_exceeded=0)),
    200: ([(400, 3, [-1, -1], "stalled", 1, 121413973),
           (400, 3, [150, 180], "stalled", 1, 121413973),
           (400, 3, [120, 150], "stalled", 1, 121413973)],
          dict(batches=1, requests=3, padded_cols=1, modeled_bytes=364241920,
               retries=3, errors=0, deadline_exceeded=0)),
}


@pytest.mark.parametrize("maxiter", [20000, 200])
def test_sell_reports_and_stats_equal_the_reference(sk512, maxiter):
    js = J_s.SolverService(slots=4, params=J_P.MonitorParams(**QS),
                           maxiter=maxiter)
    ts = T_s.SolverService(slots=4, params=T_P.MonitorParams(**QS),
                           maxiter=maxiter, device=CPU)
    js.register("op", sk512, k=8, layout="sell")
    assert ts.register("op", _port_csr(sk512), k=8, layout="sell") == "op"
    assert isinstance(ts._ops["op"].gse, GSESellC)
    bs = [np.array(j_spmv(sk512, jnp.asarray(
        np.random.default_rng(j).normal(size=512)))) for j in range(3)]
    jids = [js.submit("op", jnp.asarray(b), tol=1e-8) for b in bs]
    tids = [ts.submit("op", torch.from_numpy(b), tol=1e-8) for b in bs]
    jrep, trep = js.flush(), ts.flush()
    want, want_stats = REF[maxiter]
    got = [(r.iters, r.tag, r.switch_iters.tolist(), r.health, r.retries,
            r.est_bytes) for r in (trep[t] for t in tids)]
    assert got == want
    assert ts.stats == want_stats
    assert [trep[t].converged for t in tids] == [maxiter == 20000] * 3
    assert dict(ts.stats) == dict(js.stats)
    for ji, ti in zip(jids, tids):
        assert _fields(trep[ti]) == _fields(jrep[ji])
        xj = np.asarray(js.solution(ji))
        xt = ts.solution(ti).numpy()
        assert np.array_equal(xt.view(np.uint64), xj.view(np.uint64))


def test_register_checks_the_layout():
    a = _port_csr(J_gen.poisson2d(8))
    svc = T_s.SolverService(device=CPU)
    with pytest.raises(ValueError, match="unknown layout"):
        svc.register("op", a, layout="ell")
    # The reference's order: sharded + sell is a ValueError before the
    # sharded handle's NotImplementedError.
    with pytest.raises(ValueError, match="single-device"):
        svc.register("op", a, layout="sell", sharded=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        svc.register("op", a, sharded=True)
    assert "op" not in svc._ops


def test_sell_handle_packs_once_and_reuses_the_pack():
    a = _port_csr(J_gen.poisson2d(8))
    svc = T_s.SolverService(device=CPU)
    stats = T_ops.PACK_STATS
    m0 = stats["misses"]
    svc.register("op", a, layout="sell")
    assert stats["misses"] - m0 == 1
    op = svc._ops["op"]
    h0 = stats["hits"]
    b = torch.ones(a.shape[0], dtype=torch.float64)
    svc.submit("op", b, tol=1e-8)
    reps = svc.flush()
    assert stats["misses"] - m0 == 1 and stats["hits"] == h0
    (rep,) = reps.values()
    assert rep.converged and rep.health == "ok"
    assert svc._ops["op"].gse is op.gse
