"""The port's adaptive per-group precision driver and the service's
``tags=`` axis against the JAX reference.

``solve_adaptive`` on the two small rows of the reference's adaptive
runs -- ``ill_conditioned_spd(16, decades=8, seed=0)`` (tol 2e-3,
maxiter 4000) and ``diag_rescale(skewed_spd(n=1024), 6, 11)`` (tol 1e-3,
maxiter 1500), each with ``b`` four unit spikes at
``default_rng(7).choice(m, 4)`` -- at every profile (explore, neumann,
probe), with CG, fused PCG and a callable preconditioner: every field of
the result equals the reference's (iters, relres, true_relres, the map,
the promotions, spmv_bytes, chunks) and ``x`` is bitwise.  The default
rows hold the reference's published numbers
(tools/reference/adaptive_ref.py).  ``solve_cg(tags="adaptive")`` is the
driver.  ``SolverService`` with ``tags`` an int, a uniform map, a
non-uniform map and ``"adaptive"`` gives the reference's reports, stats
and solutions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import tagmap as J_tm  # noqa: E402
from repro.launch import solver_serve as J_s  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers.adaptive import solve_adaptive as j_adaptive  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402

from repro_torch.convert import csr_from_repro  # noqa: E402
from repro_torch.core import tagmap as T_tm  # noqa: E402
from repro_torch.launch import solver_serve as T_s  # noqa: E402
from repro_torch.solvers import adaptive as T_ad  # noqa: E402
from repro_torch.solvers import make_jacobi, solve_cg, solve_pcg  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402

CPU = "cpu"
# name: (matrix, keywords, the reference's (iters, true_relres, tag
# counts, map crc32, promotions, spmv_bytes, chunks) at the row's own
# profile, from tools/reference/adaptive_ref.py)
ROWS = {
    "illcond16": (lambda: J_gen.ill_conditioned_spd(16, decades=8.0, seed=0),
                  dict(tol=2e-3, maxiter=4000), "explore",
                  (775, 0.001977506605066215, {1: 16, 2: 16, 3: 0},
                   0x3433c8fe, [(771, 16)], 6640100, 9)),
    "skewed1024": (lambda: J_gen.diag_rescale(J_gen.skewed_spd(n=1024), 6.0,
                                              11),
                   dict(tol=1e-3, maxiter=1500), "neumann",
                   (150, 0.0008890353209770497, {1: 96, 2: 32, 3: 0},
                    0xdde41b7b, [(0, 32)], 132254620, 2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(v):
    return np.asarray(v, np.float64).view(np.uint64)


def _port_csr(a):
    return csr_from_repro({n: np.asarray(getattr(a, n))
                           for n in ("rowptr", "col", "val", "row_ids")},
                          a.shape, device=CPU)


def _spikes(m: int, count: int = 4, seed: int = 7) -> np.ndarray:
    b = np.zeros(m)
    b[np.random.default_rng(seed).choice(m, count, replace=False)] = 1.0
    return b


@pytest.fixture(scope="module")
def rows():
    out = {}
    for name, (make, _, _, _) in ROWS.items():
        a = make()
        ta = _port_csr(a)
        out[name] = dict(a=a, ta=ta, g=J_csr.pack_csr(a, k=8),
                         tg=T_csr.pack_csr(ta, k=8),
                         b=_spikes(int(a.shape[0])))
    return out


def _fields(r) -> dict:
    return dict(iters=int(r.iters), relres=_bits(r.relres).item(),
                true_relres=_bits(r.true_relres).item(),
                converged=bool(r.converged), crc32=r.tagmap.crc32,
                counts=r.tagmap.tag_counts(),
                promotions=[tuple(int(v) for v in p) for p in r.promotions],
                spmv_bytes=int(r.spmv_bytes), chunks=int(r.chunks),
                probe_iters=int(r.probe_iters), tag=r.tag)


def _run_both(s, kw, precond=None):
    jp = tp = None
    if precond == "jacobi":
        jp, tp = j_jacobi(s["a"], k=8), make_jacobi(s["ta"], k=8)
    elif precond == "callable":
        jm, tm = j_jacobi(s["a"], k=8), make_jacobi(s["ta"], k=8)
        jp, tp = (lambda r, t: jm.apply(r, t)), (lambda r, t: tm.apply(r, t))
    jr = j_adaptive(s["g"], jnp.asarray(s["b"]), precond=jp, **kw)
    tr = T_ad.solve_adaptive(s["tg"], torch.from_numpy(s["b"]), precond=tp,
                             **kw)
    return jr, tr


@pytest.mark.parametrize("profile", ["explore", "neumann", "probe"])
@pytest.mark.parametrize("row", list(ROWS))
def test_solve_adaptive_is_the_reference(row, profile, rows):
    _, kw, own, want = ROWS[row]
    kw = dict(kw, profile=profile)
    if profile == "probe":
        kw["probe_iters"] = 40
    jr, tr = _run_both(rows[row], kw)
    assert _fields(tr) == _fields(jr)
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))
    assert tr.converged
    if profile == own:
        it, rel, counts, crc, promos, nbytes, chunks = want
        assert (tr.iters, tr.true_relres, tr.tagmap.tag_counts(),
                tr.tagmap.crc32, [tuple(p[:2]) for p in tr.promotions],
                tr.spmv_bytes, tr.chunks) == (it, rel, counts, crc, promos,
                                              nbytes, chunks)
        assert not tr.tagmap.is_uniform


@pytest.mark.parametrize("precond", ["jacobi", "callable"])
def test_solve_adaptive_pcg_is_the_reference(precond, rows):
    jr, tr = _run_both(rows["skewed1024"],
                       dict(tol=1e-3, maxiter=1500, profile="neumann"),
                       precond=precond)
    assert _fields(tr) == _fields(jr)
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))


def test_solve_adaptive_seeds_and_chunks(rows):
    s = rows["skewed1024"]
    m = int(s["a"].shape[0])
    tags = np.ones(-(-m // 8), np.uint8)
    tags[::7] = 2
    for tj, tt, extra in ((2, 2, {}),
                          (J_tm.TagMap(tags), T_tm.TagMap(tags), {}),
                          (None, None, dict(chunk=37, theta=0.5))):
        kw = dict(tol=1e-3, maxiter=1500, **extra)
        jr = j_adaptive(s["g"], jnp.asarray(s["b"]), tags0=tj, **kw)
        timings = {}
        tr = T_ad.solve_adaptive(s["tg"], torch.from_numpy(s["b"]),
                                 tags0=tt, timings=timings, **kw)
        assert _fields(tr) == _fields(jr)
        np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))
        assert {"mask", "solve", "true_residual"} <= set(timings)


def test_tags_adaptive_routes_to_the_driver(rows):
    s = rows["illcond16"]
    b = torch.from_numpy(s["b"])
    via = solve_cg(s["tg"], b, tags="adaptive", tol=2e-3, maxiter=4000)
    direct = T_ad.solve_adaptive(s["tg"], b, tol=2e-3, maxiter=4000)
    assert _fields(via) == _fields(direct)
    assert torch.equal(via.x, direct.x)
    pre = make_jacobi(s["ta"], k=8)
    via = solve_pcg(s["tg"], b, pre, tags="adaptive", tol=2e-3, maxiter=400)
    direct = T_ad.solve_adaptive(s["tg"], b, precond=pre, tol=2e-3,
                                 maxiter=400)
    assert _fields(via) == _fields(direct)
    with pytest.raises(TypeError, match="GSECSR"):
        T_ad.solve_adaptive(make_jacobi, b)
    with pytest.raises(ValueError, match="profile"):
        T_ad.solve_adaptive(s["tg"], b, profile="guess")


def test_host_helpers_are_the_reference(rows):
    from repro.solvers import adaptive as J_ad

    for s in rows.values():
        np.testing.assert_array_equal(_bits(T_ad._inv_diag(s["tg"])),
                                      _bits(J_ad._inv_diag(s["g"])))
        np.testing.assert_array_equal(
            _bits(T_ad._abs_neumann_profile(s["tg"], s["b"])),
            _bits(J_ad._abs_neumann_profile(s["g"], s["b"])))
        xh = np.abs(np.random.default_rng(1).normal(size=s["b"].shape[0]))
        for rel in (1e-3, 0.5, 2.0, np.inf):
            np.testing.assert_array_equal(_bits(T_ad._trim(xh, rel)),
                                          _bits(J_ad._trim(xh, rel)))


# --- the service's tags axis -------------------------------------------------

def _report(r) -> dict:
    d = dataclasses.asdict(r)
    d["switch_iters"] = np.asarray(r.switch_iters).tolist()
    d["relres"] = _bits(r.relres).item()
    return d


@pytest.mark.parametrize("handle_tags", [None, 2])
def test_service_tags_axis_is_the_reference(handle_tags):
    a = J_gen.poisson2d(10)
    m = int(a.shape[0])
    b = _spikes(m)
    tags = np.ones(-(-m // 8), np.uint8)
    tags[::3] = 2
    js = J_s.SolverService(slots=2, maxiter=3000)
    ts = T_s.SolverService(slots=2, maxiter=3000, device=CPU)
    js.register("p", a, k=8, tags=handle_tags)
    ts.register("p", _port_csr(a), k=8, tags=handle_tags)
    axes = [(2, 2), (J_tm.TagMap.for_rows(m, 2), T_tm.TagMap.for_rows(m, 2)),
            (J_tm.TagMap(tags), T_tm.TagMap(tags)), ("adaptive", "adaptive"),
            (None, None)]
    jids = [js.submit("p", jnp.asarray(b), tol=1e-8, tags=j) for j, _ in axes]
    tids = [ts.submit("p", torch.from_numpy(b), tol=1e-8, tags=t)
            for _, t in axes]
    jrep, trep = js.flush(), ts.flush()
    assert dict(ts.stats) == {k: int(v) for k, v in js.stats.items()}
    for ji, ti in zip(jids, tids):
        assert _report(trep[ti]) == _report(jrep[ji])
        np.testing.assert_array_equal(_bits(ts.solution(ti).numpy()),
                                      _bits(js.solution(ji)))
    # The int tag and the uniform map share a bucket: the same reports.
    assert _report(trep[tids[0]])["iters"] == _report(trep[tids[1]])["iters"]
    assert trep[tids[3]].converged and trep[tids[2]].converged


def test_service_tags_refusals():
    a = _port_csr(J_gen.poisson2d(8))
    svc = T_s.SolverService(device=CPU)
    with pytest.raises(ValueError, match="single-device CSR"):
        svc.register("s", a, layout="sell", tags="adaptive")
    with pytest.raises(ValueError, match="'adaptive'"):
        svc.register("s", a, tags="frobnicate")
    with pytest.raises(ValueError, match="groups"):
        svc.register("s", a, tags=T_tm.TagMap.for_rows(8, 1))
    svc.register("s", a, layout="sell")
    with pytest.raises(ValueError, match="single-device CSR"):
        svc.submit("s", torch.ones(64, dtype=torch.float64), tags="adaptive")
    assert T_s._tags_token(T_tm.TagMap.for_rows(64, 1)) == (
        "map", T_tm.TagMap.for_rows(64, 1).crc32)
    assert T_s._tags_token(2) == 2
