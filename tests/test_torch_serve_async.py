"""The port's ``AsyncSolveService`` against the JAX reference's, scenario
for scenario (``tests/test_serve.py``'s service cases), under a fake clock.

Each scenario drives a reference and a port service through the same
calls: every submission's answer (``Accepted``/``Shed`` and its fields),
every ``SolveReport`` field for field (relres bit for bit), every
solution bitwise, ``stats``, ``sheds``, ``warm`` and ``pack_faults`` and
the Prometheus text of the service's ``repro_serve_*`` series (all but the
flush-latency histogram, which reads ``perf_counter``) are the
reference's.  The scenarios: a ``queue_full`` shed; a tag-fault operator
that trips the breaker, sheds ``breaker_open``, re-opens on a failed
probe and heals through the half-open probe once the operator is lifted;
a deadline expiring mid-solve under a stall hook (flagged
``health="deadline"``, a finite x); warm-start LRU hits (``iters`` 0); a
corrupt pack detected and repacked; the dwell classes; continuous
batching: a request submitted after two pumps joins the running group,
and every request is bitwise its solo ``solve_cg``; and a
``tags="adaptive"`` request run at its admission boundary.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import serve as J_s  # noqa: E402
from repro.core import precision as J_P  # noqa: E402
from repro.obs import metrics as J_OM  # noqa: E402
from repro.robustness import faults as J_F  # noqa: E402
from repro.serve.service import _dwell_params as j_dwell  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch import serve as T_s  # noqa: E402
from repro_torch.convert import csr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.obs import metrics as T_OM  # noqa: E402
from repro_torch.robustness import faults as T_F  # noqa: E402
from repro_torch.robustness.guards import DEFAULT_GUARDS  # noqa: E402
from repro_torch.serve.service import _dwell_params as t_dwell  # noqa: E402
from repro_torch.solvers import solve_cg  # noqa: E402
from repro_torch.sparse.csr import pack_csr  # noqa: E402

CPU = "cpu"
PARAMS = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Clock:
    """Injectable fake clock: the tests advance time instead of sleeping."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _port_csr(a):
    return csr_from_repro({n: np.asarray(getattr(a, n))
                           for n in ("rowptr", "col", "val", "row_ids")},
                          a.shape, device=CPU)


def _rhs(a, seed):
    return np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(seed).normal(size=a.shape[1]))))


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d["switch_iters"] = np.asarray(report.switch_iters).tolist()
    d["relres"] = np.float64(report.relres).view(np.uint64)  # bit for bit
    return d


class Pair:
    """A reference and a port service driven through the same calls, each
    on its own fake clock; every answer is compared as it comes."""

    def __init__(self, hook=None, breaker=None, **kw):
        self.clocks = (_Clock(), _Clock())
        self.j = J_s.AsyncSolveService(
            params=J_P.MonitorParams(**PARAMS), clock=self.clocks[0],
            chunk_hook=hook(self.clocks[0]) if hook else None,
            breaker=J_s.BreakerParams(**breaker) if breaker else None, **kw)
        self.t = T_s.AsyncSolveService(
            params=T_P.MonitorParams(**PARAMS), clock=self.clocks[1],
            chunk_hook=hook(self.clocks[1]) if hook else None,
            breaker=T_s.BreakerParams(**breaker) if breaker else None,
            device=CPU, **kw)
        self.ops = {}

    def register(self, name, a, fault=None):
        """``a`` (a reference CSR) on both; ``fault`` a tag-fault mode
        served through the ``operator=`` override (every tag fails)."""
        jkw, tkw = {}, {}
        ta = _port_csr(a)
        if fault is not None:
            jkw["operator"] = J_F.make_tag_fault_operator(
                J_csr.pack_csr(a, k=8), mode=fault, fail_tag=3)
            tkw["operator"] = T_F.make_tag_fault_operator(
                pack_csr(ta, k=8), mode=fault, fail_tag=3)
        self.j.register(name, a, k=8, **jkw)
        self.t.register(name, ta, k=8, **tkw)
        self.ops[name] = (a, ta)

    def tick(self, dt=None, to=None):
        for c in self.clocks:
            c.t = to if to is not None else c.t + dt

    def submit(self, name, seed, **kw):
        b = _rhs(self.ops[name][0], seed)
        rj = self.j.submit(name, jnp.asarray(b), **kw)
        rt = self.t.submit(name, torch.from_numpy(b), **kw)
        assert type(rt).__name__ == type(rj).__name__
        assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
        return rt

    def pump(self):
        rj, rt = self.j.pump(), self.t.pump()
        self._same(rj, rt)
        return rt

    def run(self):
        rj, rt = self.j.run_until_idle(), self.t.run_until_idle()
        self._same(rj, rt)
        return rt

    @staticmethod
    def _same(rj, rt):
        assert sorted(rt) == sorted(rj)
        for i in rj:
            assert _fields(rt[i]) == _fields(rj[i]), i

    def solution(self, rid):
        """The port's solution, held bitwise to the reference's."""
        xj = np.asarray(self.j.solution(rid))
        xt = self.t.solution(rid)
        assert np.array_equal(xt.numpy().view(np.uint64), xj.view(np.uint64))
        return xt

    def check(self):
        """Counters, views and the registry's text equal the reference's."""
        for name in ("stats", "sheds", "warm", "pack_faults"):
            assert dict(getattr(self.t, name)) == dict(
                getattr(self.j, name)), name
        assert self._lines(T_OM, self.t) == self._lines(J_OM, self.j)
        for rid in sorted(set(self.j._solutions) | set(self.t._solutions)):
            self.solution(rid)

    @staticmethod
    def _lines(OM, svc):
        tag = f'service="{svc.service_id}"'
        return [ln.replace(tag, 'service="S"')
                for ln in OM.REGISTRY.to_prometheus().splitlines()
                if tag in ln and "flush_latency" not in ln]


def test_shed_queue_full():
    p = Pair(slots=2, queue_limit=2, chunk_iters=16)
    p.register("p", J_gen.poisson2d(8))
    r1, r2, r3 = (p.submit("p", s) for s in range(3))
    assert isinstance(r1, T_s.Accepted) and isinstance(r2, T_s.Accepted)
    assert isinstance(r3, T_s.Shed) and r3.reason == "queue_full"
    assert p.t.sheds["queue_full"] == 1
    reports = p.run()
    assert set(reports) == {r1.id, r2.id}
    assert all(r.converged and r.health == "ok" for r in reports.values())
    p.check()


def test_breaker_trips_sheds_and_heals_through_the_probe():
    """Two guard-tripped requests open the breaker; a submission sheds
    ``breaker_open`` with the retry hint; after the backoff the probe is
    admitted and fails (the operand is still faulty), re-opening it with
    the backoff doubled; with the operator lifted the next probe converges
    and closes it."""
    p = Pair(slots=2, chunk_iters=32, queue_limit=8, max_retries=0,
             breaker=dict(fail_threshold=2, backoff_s=1.0, jitter=0.0))
    p.register("bad", J_gen.poisson2d(8), fault="nan")
    for s in range(2):
        resp = p.submit("bad", s)
        assert isinstance(resp, T_s.Accepted)
        rep = p.run()[resp.id]
        assert not rep.converged and rep.health != "ok"
    assert p.t._breaker("bad").state == "open"
    shed = p.submit("bad", 9)
    assert isinstance(shed, T_s.Shed) and shed.reason == "breaker_open"
    assert shed.retry_after_s > 0 and p.t.sheds["breaker_open"] == 1
    p.tick(to=1.5)
    assert isinstance(p.submit("bad", 10), T_s.Accepted)
    p.run()
    assert p.t._breaker("bad").state == "open"
    assert p.t._breaker("bad").backoff == 2.0
    for svc in (p.j, p.t):
        svc._operators.pop("bad")  # the operand heals
    p.tick(to=4.0)
    probe = p.submit("bad", 11)
    assert isinstance(probe, T_s.Accepted)
    rep = p.run()[probe.id]
    assert rep.converged and rep.health == "ok"
    assert p.t._breaker("bad").state == "closed"
    assert p.t._breaker("bad").transitions == p.j._breaker("bad").transitions
    p.check()


def test_deadline_expiry_returns_a_flagged_iterate():
    def stall(clk):  # every chunk takes 1 s
        def hook(svc, key, group):
            clk.t += 1.0
        return hook

    p = Pair(hook=stall, slots=2, chunk_iters=4, maxiter=20000)
    p.register("p", J_gen.poisson2d(16))
    resp = p.submit("p", 0, tol=1e-12, deadline_s=0.5)
    rep = p.run()[resp.id]
    assert rep.deadline_exceeded and not rep.converged
    assert rep.health == "deadline" and rep.iters == 4
    x = p.solution(resp.id)
    assert bool(torch.isfinite(x).all())
    p.check()
    assert p.t.stats["deadline_exceeded"] == 1


def test_warm_start_lru_hits():
    p = Pair(slots=2, chunk_iters=32, warm_capacity=4)
    p.register("p", J_gen.poisson2d(12))
    p.submit("p", 0, tol=1e-8)
    p.run()
    assert p.t.warm["store"] == 1
    r2 = p.submit("p", 0, tol=1e-8)
    rep = p.run()[r2.id]
    assert p.t.warm["hit"] == 1
    assert rep.iters == 0 and rep.converged
    p.check()


def test_pack_corruption_detected_and_repacked():
    p = Pair(slots=2, chunk_iters=32)
    p.register("p", J_gen.poisson2d(8))
    p.j._ops["p"].gse = J_F.corrupt_gsecsr(p.j._ops["p"].gse, "table",
                                           seed=3)
    p.t._ops["p"].gse = T_F.corrupt_gsecsr(p.t._ops["p"].gse, "table",
                                           seed=3)
    resp = p.submit("p", 0, tol=1e-8)
    rep = p.run()[resp.id]
    assert dict(p.t.pack_faults) == {"detected": 1, "repacked": 1}
    assert rep.converged  # served off the repacked operand
    p.check()


def test_dwell_classes():
    for deadline in (None, 0.05, 0.2, 1.0, 4.99, 5.0, 30.0):
        jc, jp = j_dwell(J_P.MonitorParams(**PARAMS), deadline, 0.2, 5.0)
        tc, tp = t_dwell(T_P.MonitorParams(**PARAMS), deadline, 0.2, 5.0)
        assert tc == jc
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert [t_dwell(T_P.MonitorParams(**PARAMS), d, 0.2, 5.0)[0]
            for d in (0.05, 1.0, 30.0)] == ["tight", "normal", "loose"]


def test_continuous_batching_joins_a_running_group():
    """Two requests start a group; after two pumps a third joins it (and a
    fourth, on another deadline class, starts its own).  Every report and
    solution is the reference's, and every request's x is bitwise its solo
    ``solve_cg``."""
    a = J_gen.poisson2d(12)
    p = Pair(slots=4, chunk_iters=8, maxiter=20000)
    p.register("op", a)
    ids = [p.submit("op", s).id for s in range(2)]
    for _ in range(2):
        assert p.pump() == {}
    group = next(iter(p.t._groups.values()))
    assert group.chunks.nrhs == 2
    ids.append(p.submit("op", 2).id)
    ids.append(p.submit("op", 3, deadline_s=100.0).id)
    p.pump()
    assert group.chunks.nrhs == 3 and len(p.t._groups) == 2
    assert p.t.queue_wait.summary()["count"] == 4
    p.run()
    reps = {i: p.t.reports[i] for i in ids}
    assert all(r.converged and r.health == "ok" and r.retries == 0
               for r in reps.values())
    assert [reps[i].batch_size for i in ids[:3]] != [1, 1, 1]
    ta = p.ops["op"][1]
    for i, seed in zip(ids[:3], range(3)):
        solo = solve_cg(pack_csr(ta, k=8),
                        torch.from_numpy(_rhs(a, seed)), tol=1e-8,
                        maxiter=20000, params=T_P.MonitorParams(**PARAMS),
                        guards=DEFAULT_GUARDS)
        x = p.solution(i)
        assert np.array_equal(x.numpy().view(np.uint64),
                              solo.x.numpy().view(np.uint64))
        assert (reps[i].iters, reps[i].relres) == (int(solo.iters),
                                                   float(solo.relres))
        assert reps[i].switch_iters.tolist() == solo.switch_iters.tolist()
    assert p.t.chunk_counter.value == p.j.chunk_counter.value
    p.check()


def test_an_adaptive_request_runs_at_its_admission_boundary():
    """``tags="adaptive"`` runs the adaptive driver to completion when it is
    admitted, beside a chunked request, with the same bookkeeping."""
    p = Pair(slots=2, chunk_iters=8)
    p.register("p", J_gen.poisson2d(8))
    chunked = p.submit("p", 0, tol=1e-8)
    adaptive = p.submit("p", 1, tol=1e-3, tags="adaptive")
    first = p.pump()
    assert adaptive.id in first and chunked.id not in first
    assert first[adaptive.id].converged
    p.run()
    assert p.t.reports[chunked.id].converged
    p.check()
