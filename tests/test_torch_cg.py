"""The port's stepped CG against the JAX reference.

The port's loop keeps its state on the device and runs in chunks with
frozen updates past the exit, so ``iters`` follows the reference's loop
condition exactly.  Its dots and updates round as XLA rounds the
reference's (``kernels.vec_f64``), so on these cases the iterates are
the reference's; the tests hold the tolerances the port promises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.robustness import guards as J_guards  # noqa: E402
from repro.robustness.faults import make_tag_fault_operator  # noqa: E402
from repro.solvers import solve_cg as j_solve_cg  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import (csr_from_repro, gsecsr_from_repro,  # noqa: E402
                                 monitor_params_from_repro)
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.robustness import guards as T_guards  # noqa: E402
from repro_torch.solvers.cg import CHUNK, solve_cg  # noqa: E402
from repro_torch.solvers.operators import (make_fixed_operator,  # noqa: E402
                                           make_gse_operator)
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402
from repro_torch.sparse.spmv import spmv_gse  # noqa: E402

QS = dict(t=40, l=60, m=30)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: the stepped loops run thousands
    of tiny ops, which a thread pool shared with the other test workers
    only slows (about 25x with six workers of eight threads each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(gen, x_true, k=8):
    """(reference CSR, reference GSECSR, port GSECSR, b) with b = A x made
    by the reference's f64 spmv; the port's operand is converted from the
    reference's arrays, so both packages see one operand."""
    a = gen()
    g = J_csr.pack_csr(a, k=k)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device="cpu")
    b = np.array(j_spmv(a, jnp.asarray(x_true)))
    return a, g, tg, b


def _quickstart():
    rng = np.random.default_rng(0)  # the draws examples/quickstart.py makes
    rng.normal(size=4096)
    rng.integers(-2, 3, 4096)
    return _system(lambda: J_gen.random_spd(2000, seed=1),
                   rng.normal(size=2000))


def _rs8():
    return _system(lambda: J_gen.diag_rescale(J_gen.random_spd(2000, seed=21),
                                              8.0, 21),
                   np.random.default_rng(0).normal(size=2000))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_quickstart_case_matches_jax_exactly():
    _, g, tg, b = _quickstart()
    rj = j_solve_cg(g, jnp.asarray(b), tol=1e-8, maxiter=3000,
                    params=J_P.MonitorParams(**QS))
    rt = solve_cg(tg, torch.from_numpy(b), tol=1e-8, maxiter=3000,
                  params=T_P.MonitorParams(**QS))
    assert int(rt.iters) == int(rj.iters) == 25
    assert int(rt.tag) == int(rj.tag) == 1
    assert rt.switch_iters.tolist() == rj.switch_iters.tolist() == [-1, -1]
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.health) == int(rj.health) == T_guards.HEALTH_OK
    assert int(rt.trip_iter) == int(rj.trip_iter) == -1
    assert _rel(rt.x.numpy(), np.asarray(rj.x)) < 1e-12
    assert abs(float(rt.relres) / float(rj.relres) - 1) < 1e-6


def test_spd_rs8_2k_follows_the_reference_schedule():
    _, g, tg, b = _rs8()
    rj = j_solve_cg(g, jnp.asarray(b), tol=1e-8, maxiter=20000,
                    params=J_P.MonitorParams(**QS))
    rt = solve_cg(tg, torch.from_numpy(b), tol=1e-8, maxiter=20000,
                  params=T_P.MonitorParams(**QS))
    assert int(rj.iters) == 2791 and rj.switch_iters.tolist() == [120, 150]
    assert int(rt.tag) == int(rj.tag) == 3
    assert rt.switch_iters.tolist() == rj.switch_iters.tolist() == [120, 150]
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.health) == int(rj.health) == T_guards.HEALTH_OK
    assert abs(int(rt.iters) - int(rj.iters)) <= 0.03 * int(rj.iters)
    assert _rel(rt.x.numpy(), np.asarray(rj.x)) <= 1e-4


def test_guards_on_and_off_give_identical_results():
    _, _, tg, b = _rs8()
    kw = dict(tol=1e-8, maxiter=400, params=T_P.MonitorParams(**QS))
    on = solve_cg(tg, torch.from_numpy(b), **kw)
    off = solve_cg(tg, torch.from_numpy(b), guards=None, **kw)
    assert on.switch_iters.tolist() == off.switch_iters.tolist() == [120, 150]
    for f in ("x", "iters", "relres", "tag", "converged"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_fused_and_generic_paths_give_identical_results():
    _, _, tg, b = _rs8()
    kw = dict(tol=1e-8, maxiter=400, params=T_P.MonitorParams(**QS))
    fused = solve_cg(tg, torch.from_numpy(b), **kw)
    generic = solve_cg(make_gse_operator(tg), torch.from_numpy(b), **kw)
    for f in fused._fields:
        assert torch.equal(torch.as_tensor(getattr(fused, f)),
                           torch.as_tensor(getattr(generic, f))), f


@pytest.mark.parametrize("maxiter", [1, CHUNK - 1, CHUNK, CHUNK + 1])
def test_iters_follow_the_loop_condition_across_chunks(maxiter):
    _, g, tg, b = _rs8()
    rj = j_solve_cg(g, jnp.asarray(b), tol=1e-8, maxiter=maxiter,
                    params=J_P.MonitorParams(**QS), recover=False)
    rt = solve_cg(tg, torch.from_numpy(b), tol=1e-8, maxiter=maxiter,
                  params=T_P.MonitorParams(**QS), recover=False)
    assert int(rt.iters) == int(rj.iters) == maxiter
    assert not bool(rt.converged)
    assert int(rt.health) == int(rj.health) == T_guards.HEALTH_STALLED
    # The port rounds as the reference does, so the iterates are its own.
    assert np.array_equal(rt.x.numpy(), np.asarray(rj.x))


def test_tag_escalation_recovery_matches_reference():
    a = J_gen.poisson2d(24)
    g = J_csr.pack_csr(a)
    tg = T_csr.pack_csr(T_gen.poisson2d(24, device="cpu"))
    b = np.array(j_spmv(a, jnp.ones(a.shape[1])))
    fast = dict(t=30, l=30, m=15)
    base = make_gse_operator(tg)

    def bad(v, tag):  # the reference fault: indefinite at tag 1 only
        y = base(v, tag)
        return torch.where(torch.as_tensor(tag) <= 1, -y, y)

    rj = j_solve_cg(make_tag_fault_operator(g, mode="indefinite", fail_tag=1),
                    jnp.asarray(b), tol=1e-8, maxiter=2000,
                    params=J_P.MonitorParams(**fast))
    rt = solve_cg(bad, torch.from_numpy(b), tol=1e-8, maxiter=2000,
                  params=T_P.MonitorParams(**fast))
    assert int(rt.trip_iter) == int(rj.trip_iter) == 0
    assert rt.switch_iters.tolist() == rj.switch_iters.tolist()
    assert int(rt.tag) == int(rj.tag) and int(rt.tag) >= 2
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.health) == int(rj.health) == T_guards.HEALTH_OK
    assert abs(int(rt.iters) - int(rj.iters)) <= 0.03 * int(rj.iters)
    off = solve_cg(bad, torch.from_numpy(b), tol=1e-8, maxiter=2000,
                   params=T_P.MonitorParams(**fast), recover=False)
    assert int(off.health) == T_guards.HEALTH_BREAKDOWN
    assert int(off.iters) == 1 and int(off.trip_iter) == 0


def test_final_correction_reaches_the_true_residual_like_reference():
    _, g, tg, b = _quickstart()
    kw = dict(tol=1e-8, maxiter=3000, final_correction=True)
    rj = j_solve_cg(g, jnp.asarray(b), params=J_P.MonitorParams(**QS), **kw)
    rt = solve_cg(tg, torch.from_numpy(b), params=T_P.MonitorParams(**QS),
                  **kw)
    true = float(torch.linalg.norm(torch.from_numpy(b) - spmv_gse(tg, rt.x, 3))
                 / np.linalg.norm(b))
    assert true <= 1e-8
    assert int(rt.iters) > 25 and bool(rt.converged)
    assert abs(int(rt.iters) - int(rj.iters)) <= 0.03 * int(rj.iters)
    assert rt.switch_iters.tolist() == rj.switch_iters.tolist()


def _residual_stream(n, seed):
    """Residual histories that fire C1 (oscillating stall), C2 (slow
    decrease) and C3 (flat), with non-finite spikes for the clamp."""
    rng = np.random.default_rng(seed)
    osc = 1e-3 * np.exp(rng.normal(scale=1.2, size=n))
    slow = 1e-2 * 0.999 ** np.arange(n) * (1 + 1e-3 * rng.random(n))
    flat = np.full(n, 3e-4)
    out = np.concatenate([osc, slow, flat])
    out[[7, 150, 420]] = [np.nan, np.inf, np.nan]
    return out


@pytest.mark.parametrize("seed,params", enumerate([
    dict(t=20, l=40, m=10),
    dict(t=40, l=60, m=30, ndec_limit=25),
    dict(t=8, l=8, m=4, rsd_limit=0.1)]))
def test_monitor_matches_reference(seed, params):
    jp, tp = J_P.MonitorParams(**params), T_P.MonitorParams(**params)
    assert monitor_params_from_repro(jp) == tp
    js, ts = J_P.init(jp), T_P.init(tp, device="cpu")
    tags = []
    for r in _residual_stream(200, seed):
        js = J_P.update_tag(J_P.record(js, jnp.asarray(r)), jp)
        ts = T_P.update_tag(T_P.record(ts, torch.tensor(r)), tp)
        assert int(ts.tag) == int(js.tag)
        assert np.array_equal(ts.hist.numpy(), np.asarray(js.hist))
        jm, tm = J_P.metrics(js), T_P.metrics(ts)
        assert int(tm[1]) == int(jm[1])
        for j, t in ((jm[0], tm[0]), (jm[2], tm[2])):
            # torch.sum and XLA order the window sums differently.
            np.testing.assert_allclose(float(t), float(j), rtol=1e-12,
                                       atol=1e-12)
        tags.append(int(ts.tag))
    assert tags[-1] == 3 and tags[0] == 1  # the stream does step the tag


def test_guard_step_matches_reference():
    rng = np.random.default_rng(11)
    gp = dict(div_factor=50.0, stall_window=25)
    jg = J_guards.guard_init(jnp.asarray(0.5))
    tg = T_guards.guard_init(torch.tensor(0.5, dtype=torch.float64))
    rel = np.abs(rng.normal(size=300)) * np.geomspace(1, 1e-3, 300)
    rel[60:110] = 1.0              # stall
    rel[200] = 1e6                 # divergence
    rel[250] = np.nan
    denom = rng.normal(size=300) + 3.0
    denom[150] = -1.0              # breakdown
    for start in (0, 100, 180, 240):  # re-arm past each latched trip
        jg = J_guards.guard_init(jnp.asarray(0.5))
        tg = T_guards.guard_init(torch.tensor(0.5, dtype=torch.float64))
        for it in range(start, 300):
            jg = J_guards.guard_step(jg, jnp.int32(it), jnp.asarray(rel[it]),
                                     J_guards.GuardParams(**gp),
                                     denom=jnp.asarray(denom[it]))
            tg = T_guards.guard_step(tg, torch.tensor(it, dtype=torch.int32),
                                     torch.tensor(rel[it]),
                                     T_guards.GuardParams(**gp),
                                     denom=torch.tensor(denom[it]))
            for key in ("health", "best_it", "trip"):
                assert int(tg[key]) == int(jg[key]), (start, it, key)
            assert float(tg["best"]) == float(jg["best"])
    assert T_guards.health_name(T_guards.HEALTH_NONFINITE) == "nonfinite"
    assert T_guards.HEALTH_NAMES == J_guards.HEALTH_NAMES


def test_input_shapes_and_unported_options():
    _, _, tg, b = _quickstart()
    kw = dict(tol=1e-8, maxiter=3000, params=T_P.MonitorParams(**QS))
    col = solve_cg(tg, torch.from_numpy(b).reshape(-1, 1), **kw)
    flat = solve_cg(tg, torch.from_numpy(b), **kw)
    assert col.x.shape == (2000, 1)
    assert torch.equal(col.x[:, 0], flat.x)
    t3 = solve_cg(tg, torch.from_numpy(b), tags=3, **kw)
    assert int(t3.tag) == 3 and t3.switch_iters.tolist() == [-1, -1]
    with pytest.raises(ValueError, match="dtype"):
        solve_cg(tg, torch.from_numpy(b), x0=torch.zeros(2000), **kw)
    with pytest.raises(NotImplementedError, match="flight"):
        solve_cg(tg, torch.from_numpy(b), flight=object(), **kw)
    for tags in ("adaptive", object()):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            solve_cg(tg, torch.from_numpy(b), tags=tags, **kw)
    with pytest.raises(NotImplementedError, match="sharded"):
        solve_cg(object(), torch.from_numpy(b), **kw)


def test_fixed_operator_and_csr_conversion():
    a = J_gen.poisson2d(16)
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device="cpu")
    assert np.array_equal(ta.val.numpy(), np.asarray(a.val))
    b = np.array(j_spmv(a, jnp.ones(a.shape[1])))
    r = solve_cg(make_fixed_operator(ta), torch.from_numpy(b), tol=1e-10,
                 maxiter=500)
    assert bool(r.converged)
    np.testing.assert_allclose(r.x.numpy(), np.ones(a.shape[1]), rtol=1e-8)
    with pytest.raises(TypeError, match="colpak"):
        gsecsr_from_repro({"rowptr": np.zeros(2, np.int32),
                           "colpak": np.zeros(1, np.int64), "head": None,
                           "tail1": None, "tail2": None, "table": None,
                           "row_ids": None}, 3, (1, 1), device="cpu")


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_fused_cg_step_matches_reference(tag):
    from repro.solvers.fused_cg import fused_cg_step as j_step

    from repro_torch.solvers.fused_cg import fused_cg_step, fused_cg_step_g

    _, g, tg, b = _rs8()
    rng = np.random.default_rng(tag)
    x, p = rng.normal(size=2000), rng.normal(size=2000)
    r = b - np.asarray(j_spmv(J_gen.diag_rescale(
        J_gen.random_spd(2000, seed=21), 8.0, 21), jnp.asarray(x)))
    rs = float(r @ r)
    want = j_step(g, jnp.asarray(x), jnp.asarray(r), jnp.asarray(p),
                  jnp.asarray(rs), jnp.int32(tag))
    args = [torch.from_numpy(v) for v in (x, r, p)] + [
        torch.tensor(rs, dtype=torch.float64)]
    got = fused_cg_step(tg, *args, torch.tensor(tag, dtype=torch.int32))
    got_g = fused_cg_step_g(tg, *args, tag)
    for w, t, tt in zip(want, got, got_g):
        assert torch.equal(t, tt)
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * float(np.abs(w).max()))
