"""The port's preconditioners and stepped PCG against the JAX reference.

The preconditioners' host packers must build the reference's arrays
exactly, and their byte models the reference's numbers.  The PCG loop
runs the reference's op order (``fused_cg.pcg_update``) with the
reference-order dot and updates, so on these cases its iterates are the
reference's bit for bit; the tests hold that and the stated tolerance
(``x`` within 1e-4 relative) beside it.  The fused path equals the
generic one bitwise, and the SELL layout the CSR one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.solvers import make_block_jacobi as j_block  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers import make_spai0 as j_spai0  # noqa: E402
from repro.solvers import solve_pcg as j_solve_pcg  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.configs import paper_solver  # noqa: E402
from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.obs.flight import FlightParams  # noqa: E402
from repro_torch.solvers import (fused_pcg_step, make_block_jacobi,  # noqa: E402
                                 make_gse_operator, make_jacobi,
                                 make_precond_operator, make_spai0,
                                 solve_pcg)
from repro_torch.solvers.fused_cg import fused_pcg_step_g  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402

FAST = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
KINDS = {"jacobi": (j_jacobi, make_jacobi),
         "block_jacobi": (j_block, make_block_jacobi),
         "spai0": (j_spai0, make_spai0)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: the stepped loops run thousands
    of tiny ops, which a thread pool shared with the other test workers
    only slows (about 25x with six workers of eight threads each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(a, g):
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device="cpu")
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device="cpu")
    return ta, tg


def _b(a, seed):
    return np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(seed).normal(size=a.shape[1]))))


@pytest.fixture(scope="module")
def illcond():
    """quickstart section 4's system: ill_conditioned_spd(32, 8 decades)."""
    a = J_gen.ill_conditioned_spd(32, decades=8.0, seed=0)
    g = J_csr.pack_csr(a, k=8)
    ta, tg = _port(a, g)
    return a, g, ta, tg, _b(a, 0)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --- the preconditioners -------------------------------------------------------

def _arrays(m):
    if m.kind == "block_jacobi":
        x = m.mat
        names = ("rowptr", "colpak", "head", "tail1", "tail2", "table",
                 "row_ids")
    else:
        x = m.packed
        names = ("table", "head", "tail1", "tail2")
    return {n: np.asarray(getattr(x, n)) for n in names}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("case", ["illcond", "random_spd_257", "convdiff_16"])
def test_packed_arrays_and_bytes_equal_the_reference(kind, case):
    a = {"illcond": lambda: J_gen.ill_conditioned_spd(32, 8.0, seed=0),
         "random_spd_257": lambda: J_gen.random_spd(257, seed=4),
         "convdiff_16": lambda: J_gen.convection_diffusion_2d(16)}[case]()
    ta, _ = _port(a, J_csr.pack_csr(a, k=8))
    jm, tm = KINDS[kind][0](a, k=8), KINDS[kind][1](ta, k=8)
    want, got = _arrays(jm), _arrays(tm)
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=name)
    assert tm.kind == jm.kind
    for t in (1, 2, 3):
        assert tm.bytes_touched(t) == jm.bytes_touched(t)
        assert tm.nbytes(t) == jm.nbytes(t)


@pytest.mark.parametrize("kind", list(KINDS))
def test_apply_at_every_tag_equals_the_reference(kind, illcond):
    a, _, ta, _, _ = illcond
    jm, tm = KINDS[kind][0](a, k=8), KINDS[kind][1](ta, k=8)
    r = np.random.default_rng(1).normal(size=a.shape[0])
    rt = torch.from_numpy(r)
    for t in (1, 2, 3):
        want = np.asarray(jm.apply_at(jnp.asarray(r), t))
        np.testing.assert_array_equal(tm.apply_at(rt, t).numpy(), want)
        # The device tag, as the stepped loop passes it.
        dev_tag = torch.tensor(t, dtype=torch.int32)
        np.testing.assert_array_equal(tm.apply(rt, dev_tag).numpy(), want)
        np.testing.assert_array_equal(
            make_precond_operator(tm)(rt, dev_tag).numpy(), want)


@pytest.mark.parametrize("kind", list(KINDS))
def test_iteration_stream_bytes_charges_the_preconditioner(kind, illcond):
    a, g, ta, tg, _ = illcond
    jm, tm = KINDS[kind][0](a, k=8), KINDS[kind][1](ta, k=8)
    got = [T_csr.iteration_stream_bytes(tg, t, tm) for t in (1, 2, 3)]
    assert got == [J_csr.iteration_stream_bytes(g, t, jm) for t in (1, 2, 3)]
    if kind == "jacobi":
        assert got == [36164, 48196, 72260]
    assert (T_csr.iteration_stream_bytes(tg, 2, tm, nrhs=3)
            == J_csr.iteration_stream_bytes(g, 2, jm, nrhs=3))
    with pytest.raises(ValueError, match="GSE tag"):
        T_csr.iteration_stream_bytes(tg, torch.float32, tm)


# --- stepped PCG against the reference -----------------------------------------

@pytest.mark.parametrize("kind,want", [
    ("jacobi", (115, [-1, -1], 1)),
    ("block_jacobi", (95, [-1, -1], 1)),
    ("spai0", (1107, [120, 135], 3)),
])
def test_solve_pcg_matches_jax(kind, want, illcond):
    """quickstart section 4: tol 1e-10, the fast monitor."""
    a, g, ta, tg, b = illcond
    rj = j_solve_pcg(g, jnp.asarray(b), KINDS[kind][0](a, k=8), tol=1e-10,
                     maxiter=5000, params=J_P.MonitorParams(**FAST))
    rt = solve_pcg(tg, torch.from_numpy(b), KINDS[kind][1](ta, k=8),
                   tol=1e-10, maxiter=5000, params=T_P.MonitorParams(**FAST))
    got = (int(rt.iters), rt.switch_iters.tolist(), int(rt.tag))
    assert got == (int(rj.iters), np.asarray(rj.switch_iters).tolist(),
                   int(rj.tag)) == want
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.health) == int(rj.health) == 0
    assert _rel(rt.x.numpy(), np.asarray(rj.x)) <= 1e-4
    np.testing.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
    assert float(rt.relres) == float(rj.relres)


def test_fused_path_equals_the_generic_path(illcond):
    """A GSECSR with a preconditioner object (fused_pcg_step) against an
    operator callable with a preconditioner callable (the generic loop)."""
    _, _, ta, tg, b = illcond
    m = make_spai0(ta, k=8)
    # A budget past both switches of SPAI-0's schedule ([120, 135]).
    kw = dict(tol=1e-10, maxiter=300, params=T_P.MonitorParams(**FAST))
    fused = solve_pcg(tg, torch.from_numpy(b), m, **kw)
    generic = solve_pcg(make_gse_operator(tg), torch.from_numpy(b),
                        make_precond_operator(m), **kw)
    assert int(fused.iters) == int(generic.iters) == 300
    assert fused.switch_iters.tolist() == [120, 135]
    assert fused.switch_iters.tolist() == generic.switch_iters.tolist()
    assert torch.equal(fused.x, generic.x)
    assert float(fused.relres) == float(generic.relres)


def test_fused_step_is_the_reference_order(illcond):
    """One fused step at each tag: fused_pcg_step's five outputs equal
    fused_pcg_step_g's first five, and the step is deterministic."""
    _, _, ta, tg, b = illcond
    m = make_jacobi(ta, k=8)
    bt = torch.from_numpy(b)
    z = m.apply_at(bt, 1)
    rz = (bt * z).sum()
    for t in (1, 2, 3):
        out = fused_pcg_step(tg, m, torch.zeros_like(bt), bt, z, rz, t)
        out_g = fused_pcg_step_g(tg, m, torch.zeros_like(bt), bt, z, rz,
                                 torch.tensor(t, dtype=torch.int32))
        assert len(out) == 5 and len(out_g) == 6
        for u, v in zip(out, out_g):
            assert torch.equal(u, v)


def test_sell_layout_equals_csr():
    """tests/test_sell.py's case: PCG over the SELL pack is bitwise the CSR
    solve, and both are the reference's."""
    a = J_gen.ill_conditioned_spd(16, 8.0)
    g = J_csr.pack_csr(a, k=8)
    ta, tg = _port(a, g)
    ts = T_ops.sell_pack_gsecsr(tg)
    b = _b(a, 2)
    params = dict(t=30, l=30, m=15)
    kw = dict(tol=1e-8, maxiter=4000)
    r_csr = solve_pcg(tg, torch.from_numpy(b), make_jacobi(ta, k=8),
                      params=T_P.MonitorParams(**params), **kw)
    r_sell = solve_pcg(ts, torch.from_numpy(b), make_jacobi(ta, k=8),
                       params=T_P.MonitorParams(**params), **kw)
    rj = j_solve_pcg(J_ops.sell_pack_gsecsr(g), jnp.asarray(b),
                     j_jacobi(a, k=8), params=J_P.MonitorParams(**params),
                     **kw)
    assert int(r_sell.iters) == int(r_csr.iters) == int(rj.iters)
    assert torch.equal(r_sell.x, r_csr.x)
    np.testing.assert_array_equal(r_csr.x.numpy(), np.asarray(rj.x))


def test_guards_on_and_off_give_the_same_iterates(illcond):
    _, _, ta, tg, b = illcond
    m = make_block_jacobi(ta, k=8)
    kw = dict(tol=1e-10, maxiter=5000, params=T_P.MonitorParams(**FAST))
    on = solve_pcg(tg, torch.from_numpy(b), m, **kw)
    off = solve_pcg(tg, torch.from_numpy(b), m, guards=None, **kw)
    assert int(on.iters) == int(off.iters) == 95
    assert torch.equal(on.x, off.x)
    assert float(on.relres) == float(off.relres)


def test_final_correction_matches_jax(illcond):
    """Pinned at tag 1, the recursive residual converges and the true one
    does not; the correction resumes at tag 3 as the reference's does."""
    a, g, ta, tg, b = illcond
    params = dict(FAST, max_tag=1)
    out = {}
    for fc in (False, True):
        rj = j_solve_pcg(g, jnp.asarray(b), j_jacobi(a, k=8), tol=1e-10,
                         maxiter=5000, params=J_P.MonitorParams(**params),
                         final_correction=fc)
        rt = solve_pcg(tg, torch.from_numpy(b), make_jacobi(ta, k=8),
                       tol=1e-10, maxiter=5000,
                       params=T_P.MonitorParams(**params),
                       final_correction=fc)
        assert int(rt.iters) == int(rj.iters)
        assert rt.switch_iters.tolist() == np.asarray(rj.switch_iters).tolist()
        np.testing.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
        out[fc] = int(rt.iters)
    assert out[True] > out[False]


def test_unported_options_raise(illcond):
    _, _, ta, tg, b = illcond
    m = make_jacobi(ta, k=8)
    short = dict(tol=1e-8, maxiter=30, params=T_P.MonitorParams(**FAST))
    off = solve_pcg(tg, torch.from_numpy(b), m, **short)
    on = solve_pcg(tg, torch.from_numpy(b), m,
                   flight=FlightParams(capacity=8), **short)
    assert torch.equal(on.x, off.x) and int(on.flight["count"]) == 30
    with pytest.raises(TypeError, match="FlightParams"):
        solve_pcg(tg, torch.from_numpy(b), m, flight=object())
    with pytest.raises(ValueError, match="'adaptive'"):
        solve_pcg(tg, torch.from_numpy(b), m, tags="frobnicate")
    with pytest.raises(NotImplementedError, match="sharded"):
        solve_pcg(object(), torch.from_numpy(b), m)
    r2 = solve_pcg(tg, torch.from_numpy(b), m, tags=3, tol=1e-8,
                   params=T_P.MonitorParams(**FAST))
    r3 = solve_pcg(tg, torch.from_numpy(b), m, init_tag=3, tol=1e-8,
                   params=T_P.MonitorParams(**FAST))
    assert int(r2.tag) == 3 and torch.equal(r2.x, r3.x)


@pytest.mark.parametrize("kind", list(KINDS))
def test_pcg_setup_matches_the_reference(kind):
    from repro.configs import paper_solver as J_ps

    ja, jm, jp = J_ps.pcg_setup(kind)
    ta, tm, tp = paper_solver.pcg_setup(kind, device="cpu")
    np.testing.assert_array_equal(ta.val.numpy(), np.asarray(ja.val))
    for name, arr in _arrays(jm).items():
        np.testing.assert_array_equal(np.asarray(_arrays(tm)[name]), arr)
    assert (tp.t, tp.l, tp.m, tp.ndec) == (jp.t, jp.l, jp.m, jp.ndec)
