"""The port's chunked drivers, checkpoints and circuit breaker against the
JAX reference (``repro.serve``), run as ``tests/test_serve.py`` runs it.

On ``poisson2d(12)`` (b = A x, x from ``default_rng(seed)``) every chunked
run is bitwise the reference's driver and the port's unchunked solve: x,
iters, relres, tag and switch_iters.  ``SolveChunks`` at k = 1, 7 and 64
runs fused CG, generic CG and Jacobi PCG, under the reference test's
monitor and under one that switches tags at iterations 10 and 15 (chunk
boundaries straddle the switches); ``BatchedChunks`` at k = 7 runs three
columns over the CSR and the SELL pack, with and without a tag axis;
``join`` at iteration 20 gives both columns their solo solves and the
reference's snapshots, and ``drop`` leaves the other columns' states as
they were; ``IRChunks`` at k = 1 and 2 is ``solve_ir``.  Checkpoints
round-trip a chunk state and resume bitwise, a corrupt newest checkpoint
falls back to the previous one (``skipped`` as the reference's), and
``tree_crc32`` of a chunk state is the reference's number.  The breaker's
transition log, ``allow`` answers and ``retry_after`` under a fake clock
are the reference's at seeds 0-3.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import serve as J_s  # noqa: E402
from repro.checkpoint import ckpt as J_ck  # noqa: E402
from repro.core import precision as J_P  # noqa: E402
from repro.robustness.guards import DEFAULT_GUARDS as J_GUARDS  # noqa: E402
from repro.solvers import make_gse_operator as j_gse_op  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch import serve as T_s  # noqa: E402
from repro_torch.checkpoint import ckpt as T_ck  # noqa: E402
from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402,E501
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.kernels.ops import sell_pack_gsecsr  # noqa: E402
from repro_torch.robustness.guards import DEFAULT_GUARDS  # noqa: E402
from repro_torch.solvers import batched as T_b  # noqa: E402
from repro_torch.solvers import (make_gse_operator, make_jacobi,  # noqa: E402
                                 solve_cg, solve_cg_batched, solve_ir,
                                 solve_pcg)

CPU = "cpu"
# The reference test's monitor (no switch on poisson2d(12)), and one whose
# C2 fires at every due check: switches at iterations 10 and 15.
MONITORS = {"serve": dict(t=30, l=30, m=15, rsd_limit=0.5,
                          reldec_limit=0.45),
            "step": dict(t=10, l=10, m=5, rsd_limit=0.5, reldec_limit=2.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(v):
    return np.asarray(v, dtype=np.float64).view(np.uint64)


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module")
def sys12():
    a = J_gen.poisson2d(12)
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


def _params(name, lib):
    return (J_P if lib == "jax" else T_P).MonitorParams(**MONITORS[name])


def _run(driver, k, budget=2000):
    for _ in range(budget):
        driver.run_chunk(k)
        if driver.done:
            break
    assert driver.done
    return driver


def _operands(sys12, kind):
    """(reference operand, port operand, reference precond, port precond)."""
    if kind == "generic":
        return j_gse_op(sys12["g"]), make_gse_operator(sys12["tg"]), None, None
    if kind == "pcg":
        return (sys12["g"], sys12["tg"], j_jacobi(sys12["a"], k=8),
                make_jacobi(sys12["ta"], k=8))
    return sys12["g"], sys12["tg"], None, None


# --- SolveChunks ---------------------------------------------------------------

@pytest.mark.parametrize("monitor", sorted(MONITORS))
@pytest.mark.parametrize("kind", ["fused", "generic", "pcg"])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_solve_chunks_are_the_unchunked_solve(sys12, k, kind, monitor):
    jop, top, jm, tm = _operands(sys12, kind)
    b = _rhs(sys12["a"], 0)
    kw = dict(tol=1e-10, maxiter=2000, guards=DEFAULT_GUARDS)
    if tm is None:
        want = solve_cg(top, torch.from_numpy(b),
                        params=_params(monitor, "torch"), **kw)
    else:
        want = solve_pcg(top, torch.from_numpy(b), tm,
                         params=_params(monitor, "torch"), **kw)
    got = _run(T_s.SolveChunks(top, torch.from_numpy(b),
                               params=_params(monitor, "torch"), precond=tm,
                               **kw), k)
    kw["guards"] = J_GUARDS
    ref = _run(J_s.SolveChunks(jop, jnp.asarray(b),
                               params=_params(monitor, "jax"), precond=jm,
                               **kw), k)
    for res in (want, ref.res):
        _same(got.res.x, res.x)
        assert int(got.res.iters) == int(res.iters)
        assert float(got.res.relres) == float(res.relres)
        assert int(got.res.tag) == int(res.tag)
        assert got.res.switch_iters.tolist() == np.asarray(
            res.switch_iters).tolist()
    assert got.chunks == ref.chunks == -(-int(want.iters) // k)
    if monitor == "step":
        assert got.res.switch_iters.tolist() == [10, 15]


def test_solve_chunks_refuse_the_unported_wire_and_operands(sys12):
    b = torch.from_numpy(_rhs(sys12["a"], 0))
    kw = dict(tol=1e-8, maxiter=100, params=_params("serve", "torch"))
    with pytest.raises(NotImplementedError, match="item 15"):
        T_s.SolveChunks(sys12["tg"], b, wire="bf16", **kw)
    with pytest.raises(NotImplementedError, match="item 15"):
        T_s.BatchedChunks(object(), b, **kw)
    with pytest.raises(NotImplementedError, match="item 15"):
        T_s.IRChunks(object(), b)


# --- BatchedChunks ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["csr", "sell", "csr_tag2"])
def test_batched_chunks_are_the_unchunked_batched_solve(sys12, case):
    b = np.stack([_rhs(sys12["a"], s) for s in range(3)], axis=1)
    tags = 2 if case == "csr_tag2" else None
    top = sell_pack_gsecsr(sys12["tg"]) if case == "sell" else sys12["tg"]
    jop = sys12["g"]
    if case == "sell":
        from repro.kernels.ops import sell_pack_gsecsr as j_sell

        jop = j_sell(sys12["g"])
    kw = dict(tol=1e-8, maxiter=2000, guards=DEFAULT_GUARDS, tags=tags)
    want = solve_cg_batched(top, torch.from_numpy(b),
                            params=_params("step", "torch"), device=CPU,
                            **kw)
    got = _run(T_s.BatchedChunks(top, torch.from_numpy(b),
                                 params=_params("step", "torch"), **kw), 7)
    kw["guards"] = J_GUARDS
    ref = _run(J_s.BatchedChunks(jop, jnp.asarray(b),
                                 params=_params("step", "jax"), **kw), 7)
    for res in (want, ref.res):
        _same(got.res.x, res.x)
        for f in ("iters", "tag", "switch_iters", "health", "trip_iter",
                  "converged"):
            assert getattr(got.res, f).tolist() == np.asarray(
                getattr(res, f)).tolist(), f
        _same(got.res.relres, res.relres)
    assert got.chunks == ref.chunks
    for j in range(3):
        snap, jsnap = got.col_snapshot(j), ref.col_snapshot(j)
        _same(snap.pop("x"), jsnap.pop("x"))
        _same(snap.pop("ckpt"), jsnap.pop("ckpt"))
        assert snap.pop("switch_iters").tolist() == np.asarray(
            jsnap.pop("switch_iters")).tolist()
        assert snap == jsnap


def test_a_joined_column_is_its_solo_solve(sys12):
    """Column 1 joins 20 iterations into column 0's run: both columns are
    bitwise their solo solves and the reference driver's snapshots."""
    b0, b1 = _rhs(sys12["a"], 0), _rhs(sys12["a"], 1)
    kw = dict(tol=1e-8, maxiter=2000, guards=DEFAULT_GUARDS)
    solo = [solve_cg(sys12["tg"], torch.from_numpy(v),
                     params=_params("step", "torch"), **kw) for v in (b0, b1)]
    drv = T_s.BatchedChunks(sys12["tg"], torch.from_numpy(b0)[:, None],
                            params=_params("step", "torch"), **kw)
    kw["guards"] = J_GUARDS
    ref = J_s.BatchedChunks(sys12["g"], jnp.asarray(b0)[:, None],
                            params=_params("step", "jax"), **kw)
    for d, b_new in ((drv, torch.from_numpy(b1)), (ref, jnp.asarray(b1))):
        d.run_chunk(10)
        d.run_chunk(10)
        assert d.join(b_new) == 1
        _run(d, 10)
    assert drv.chunks == ref.chunks
    for j, s in enumerate(solo):
        snap, jsnap = drv.col_snapshot(j), ref.col_snapshot(j)
        _same(snap["x"], s.x)
        _same(snap["x"], jsnap["x"])
        assert snap["iters"] == int(s.iters) == jsnap["iters"]
        assert snap["relres"] == float(s.relres) == jsnap["relres"]
        assert snap["switch_iters"].tolist() == s.switch_iters.tolist() \
            == np.asarray(jsnap["switch_iters"]).tolist()
        assert (snap["tag"], snap["health"], snap["converged"]) == (
            int(s.tag), int(s.health), True)
    assert solo[1].switch_iters.tolist() == [10, 15]


def test_a_drop_leaves_the_other_columns_as_they_were(sys12):
    """Three columns; the middle one is dropped at iteration 14: the state
    left is the loop's state on columns 0 and 2 alone, and they finish
    bitwise their solo solves."""
    b = np.stack([_rhs(sys12["a"], s) for s in range(3)], axis=1)
    kw = dict(tol=1e-8, maxiter=2000, guards=DEFAULT_GUARDS,
              params=_params("step", "torch"))
    drv = T_s.BatchedChunks(sys12["tg"], torch.from_numpy(b), **kw)
    drv.run_chunk(14)
    before = T_b.take_cols(drv.state, [0, 2])
    snap = drv.drop(1)
    assert snap["iters"] == 14 and drv.nrhs == 2
    for key in ("x", "r", "p", "rs", "rr", "it"):
        assert torch.equal(drv.state[key], before[key]), key
    assert all(c is d for c, d in zip(drv.state["cols"], before["cols"]))
    cat = T_b.cat_cols(T_b.take_cols(drv.state, [0]),
                       T_b.take_cols(drv.state, [1]))
    for key in ("x", "r", "p", "rs", "rr", "it"):
        assert torch.equal(cat[key], drv.state[key]), key
    _run(drv, 14)
    for j, seed in ((0, 0), (1, 2)):
        s = solve_cg(sys12["tg"], torch.from_numpy(b[:, seed]), **kw)
        got = drv.col_snapshot(j)
        _same(got["x"], s.x)
        assert (got["iters"], got["relres"]) == (int(s.iters),
                                                 float(s.relres))


def test_a_zero_bound_runs_the_init_and_no_iteration(sys12):
    b = torch.from_numpy(np.stack([_rhs(sys12["a"], s) for s in range(2)]))
    tol = torch.tensor(1e-8, dtype=torch.float64)
    res, st = T_b._solve_cg_batched_fused(
        sys12["tg"], b, torch.zeros_like(b), tol, 2000,
        _params("serve", "torch"), guards=DEFAULT_GUARDS, device=CPU,
        stop_at=[0, 0], return_state=True)
    assert res.iters.tolist() == [0, 0]
    _same(st["r"], b)  # x0 = 0: r0 = b
    res2, st2 = T_b._solve_cg_batched_fused(
        sys12["tg"], b, b, tol, 2000, _params("serve", "torch"),
        guards=DEFAULT_GUARDS, device=CPU, resume=st, stop_at=[5, 3],
        return_state=True)
    assert res2.iters.tolist() == [5, 3]
    with pytest.raises(ValueError, match="bounds"):
        T_b._solve_cg_batched_fused(
            sys12["tg"], b, b, tol, 2000, _params("serve", "torch"),
            device=CPU, resume=st2, stop_at=[1])


# --- IRChunks ----------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_ir_chunks_are_solve_ir(k):
    a = J_gen.poisson2d(10)
    g = J_csr.pack_csr(a, k=8)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    b = _rhs(a, 3)
    kw = dict(tol=1e-11, max_outer=8, inner_tol=1e-4)
    want = solve_ir(tg, torch.from_numpy(b), params=_params("serve", "torch"),
                    guards=DEFAULT_GUARDS, **kw)
    drv = T_s.IRChunks(tg, torch.from_numpy(b),
                       params=_params("serve", "torch"),
                       guards=DEFAULT_GUARDS, **kw)
    ref = J_s.IRChunks(g, jnp.asarray(b), params=_params("serve", "jax"),
                       guards=J_GUARDS, **kw)
    for d in (drv, ref):
        while not d.done:
            d.run_chunk(k)
    assert drv.chunks == ref.chunks == -(-want.outer_iters // k)
    for res in (want, ref.result()):
        got = drv.result()
        _same(got.x, res.x)
        assert (got.outer_iters, got.inner_iters, got.relres) == (
            res.outer_iters, res.inner_iters, res.relres)
        _same(got.history, res.history)
        assert got.health == res.health


def test_ir_chunks_resume_from_a_checkpoint(tmp_path):
    a = J_gen.poisson2d(10)
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device=CPU)
    from repro_torch.sparse.csr import pack_csr

    tg = pack_csr(ta, k=8)
    b = torch.from_numpy(_rhs(a, 3))
    kw = dict(tol=1e-11, max_outer=8, inner_tol=1e-4,
              params=_params("serve", "torch"), guards=DEFAULT_GUARDS)
    want = solve_ir(tg, b, **kw)
    drv = T_s.IRChunks(tg, b, **kw)
    drv.run_chunk(2)
    drv.save_state(str(tmp_path))
    drv2 = T_s.IRChunks(tg, b, **kw)
    assert drv2.restore_state(str(tmp_path)) == [] and drv2.chunks == 1
    assert drv2.outer_iters == 2
    while not drv2.done:
        drv2.run_chunk(2)
    got = drv2.result()
    _same(got.x, want.x)
    assert (got.outer_iters, got.inner_iters, got.relres) == (
        want.outer_iters, want.inner_iters, want.relres)
    _same(got.history, want.history)


# --- checkpoints ---------------------------------------------------------------

def _chunked_pair(sys12, seed):
    """The port's and the reference's SolveChunks after two chunks of 8,
    each saved."""
    b = _rhs(sys12["a"], seed)
    kw = dict(tol=1e-8, maxiter=2000)
    drv = T_s.SolveChunks(sys12["tg"], torch.from_numpy(b),
                          params=_params("step", "torch"),
                          guards=DEFAULT_GUARDS, **kw)
    ref = J_s.SolveChunks(sys12["g"], jnp.asarray(b),
                          params=_params("step", "jax"), guards=J_GUARDS,
                          **kw)
    return b, drv, ref


def _fresh(sys12, b, lib):
    kw = dict(tol=1e-8, maxiter=2000)
    if lib == "torch":
        return T_s.SolveChunks(sys12["tg"], torch.from_numpy(b),
                               params=_params("step", "torch"),
                               guards=DEFAULT_GUARDS, **kw)
    return J_s.SolveChunks(sys12["g"], jnp.asarray(b),
                           params=_params("step", "jax"), guards=J_GUARDS,
                           **kw)


@pytest.mark.parametrize("corrupt", [False, True])
def test_a_checkpointed_solve_resumes_bitwise(sys12, tmp_path, corrupt):
    """Two chunks of 8 saved; a fresh driver restores the newest valid one
    and finishes with the unchunked trajectory.  A flipped byte in the
    newest blob falls back to step 1 (``skipped`` [2], the reference's),
    and the lost chunk re-runs."""
    b, drv, ref = _chunked_pair(sys12, 4)
    want = solve_cg(sys12["tg"], torch.from_numpy(b), tol=1e-8,
                    maxiter=2000, params=_params("step", "torch"),
                    guards=DEFAULT_GUARDS)
    paths = {"torch": str(tmp_path / "t"), "jax": str(tmp_path / "j")}
    for lib, d in (("torch", drv), ("jax", ref)):
        d.run_chunk(8)
        d.save_state(paths[lib])
        d.run_chunk(8)
        d.save_state(paths[lib])
    # The port's state is the reference's tree, plus ``rr`` (= ``rs``).
    shared = {k: drv._state[k] for k in ref._state}
    assert sorted(drv._state) == sorted(list(ref._state) + ["rr"])
    assert T_ck.tree_crc32(shared) == J_ck.tree_crc32(ref._state)
    if corrupt:
        for lib, blob in (("torch", "ckpt.bin.z"),
                          ("jax", "ckpt.msgpack.zst")):
            path = os.path.join(paths[lib], "step_00000002", blob)
            data = bytearray(open(path, "rb").read())
            data[len(data) // 2] ^= 0xFF
            open(path, "wb").write(bytes(data))
    skipped = {}
    for lib in ("torch", "jax"):
        d2 = _fresh(sys12, b, lib)
        skipped[lib] = d2.restore_state(paths[lib])
        assert d2.chunks == (1 if corrupt else 2)
        assert d2.iters == (8 if corrupt else 16)
        _run(d2, 8)
        if lib == "torch":
            got = d2.res
        else:
            jres = d2.res
    assert skipped["torch"] == skipped["jax"] == ([2] if corrupt else [])
    _same(got.x, want.x)
    _same(got.x, jres.x)
    assert int(got.iters) == int(want.iters) == int(jres.iters)
    assert got.switch_iters.tolist() == [10, 15]
    with pytest.raises(FileNotFoundError):
        _fresh(sys12, b, "torch").restore_state(str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nothing to save"):
        _fresh(sys12, b, "torch").save_state(str(tmp_path / "x"))


# --- the circuit breaker ---------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _breaker_walk(lib, seed):
    """One scripted sequence of calls; every answer logged."""
    mod = J_s if lib == "jax" else T_s
    clk = _Clock()
    br = mod.CircuitBreaker(mod.BreakerParams(fail_threshold=2,
                                              backoff_s=0.5, jitter=0.2,
                                              max_backoff_s=3.0),
                            clock=clk, seed=seed)
    log = []
    steps = ["allow", "fail", "allow", "fail", "allow", "retry", 0.3,
             "allow", "retry", 0.4, "allow", "allow", "fail", "retry", 1.2,
             "allow", "release", "allow", "fail", 2.5, "allow", "fail", 4.0,
             "allow", "fail", 8.0, "allow", "success", "allow", "fail",
             "fail", "retry"]
    for s in steps:
        if isinstance(s, float):
            clk.t += s
        elif s == "allow":
            log.append(("allow", br.allow(), br.state))
        elif s == "fail":
            br.record_failure()
        elif s == "success":
            br.record_success()
        elif s == "release":
            br.release()
        else:
            log.append(("retry", br.retry_after()))
        log.append((br.state, br.fails, br.backoff))
    return log, br.transitions


@pytest.mark.parametrize("seed", range(4))
def test_breaker_transitions_are_the_reference(seed):
    got, got_tr = _breaker_walk("torch", seed)
    want, want_tr = _breaker_walk("jax", seed)
    assert got == want
    assert got_tr == want_tr
    assert [s for s, _ in got_tr] == ["open", "half_open"] * 5 + [
        "closed", "open"]
    assert max(b for *_, b in got if isinstance(b, float)) == 3.0  # capped
