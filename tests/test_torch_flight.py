"""The flight recorder in the port's CG and PCG on the named cases.

The same numpy-seeded systems go through the reference and the port with
``flight=FlightParams(...)``: quickstart section 4's PCG cases
(``ill_conditioned_spd(32, 8 decades)``: Jacobi 115, block-Jacobi 95,
SPAI-0 1107 at [120, 135]) fused and generic, CSR and SELL, guards on
and off; CG over the generic operator and the SELL pack with guards off;
and a non-uniform ``TagMap`` CG and PCG.  Recorder-on is bitwise the
recorder-off solve, and the ring equals the reference's: ``it``, ``tag``
and ``health`` exactly, ``relres`` and ``a0``-``a2`` bitwise (the
trajectories are bitwise).  ``spd_rs8_2k`` (2791 iterations at [120,
150], every row kept) runs through checkpoints in
``test_torch_ckpt.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.core import tagmap as J_tm  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.obs import flight as J_OF  # noqa: E402
from repro.robustness.guards import DEFAULT_GUARDS as J_GUARDS  # noqa: E402
from repro.solvers import cg as J_cg  # noqa: E402
from repro.solvers import precond as J_pc  # noqa: E402
from repro.solvers.operators import make_gse_operator as j_gse  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402,E501
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.core import tagmap as T_tm  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.obs import flight as T_OF  # noqa: E402
from repro_torch.robustness.guards import DEFAULT_GUARDS  # noqa: E402
from repro_torch.solvers import cg as T_cg  # noqa: E402
from repro_torch.solvers import precond as T_pc  # noqa: E402
from repro_torch.solvers.operators import make_gse_operator  # noqa: E402

CPU = "cpu"
FAST = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
COLS = ("it", "tag", "health", "relres", "a0", "a1", "a2", "tag_min")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(a, x_true):
    g = J_csr.pack_csr(a, k=8)
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device=CPU)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    b = np.array(j_spmv(a, jnp.asarray(x_true)))
    return dict(a=a, g=g, ta=ta, tg=tg, b=b)


@pytest.fixture(scope="module")
def illcond():
    a = J_gen.ill_conditioned_spd(32, decades=8.0, seed=0)
    return _system(a, np.random.default_rng(0).normal(size=a.shape[1]))


def _same_ring(tfs, jfs):
    lt, lj = T_OF.FlightLog.from_state(tfs), J_OF.FlightLog.from_state(jfs)
    for c in COLS:
        np.testing.assert_array_equal(getattr(lt, c),
                                      np.asarray(getattr(lj, c)), err_msg=c)
    assert (lt.recorded, lt.dropped) == (lj.recorded, lj.dropped)
    return lt


PCG = {
    # name: (preconditioner, fused, sell, guards, iterations)
    "jacobi": ("jacobi", True, False, True, 115),
    "jacobi_generic": ("jacobi", False, False, False, 115),
    "jacobi_sell": ("jacobi", True, True, True, 115),
    "block_jacobi": ("block_jacobi", True, False, False, 95),
    "spai0": ("spai0", True, False, True, 1107),
}


@pytest.mark.parametrize("case", list(PCG))
def test_quickstart_pcg_cases_record_the_reference_ring(case, illcond):
    s = illcond
    kind, fused, sell, guards, iters = PCG[case]
    jm = getattr(J_pc, f"make_{kind}")(s["a"], k=8)
    tm = getattr(T_pc, f"make_{kind}")(s["ta"], k=8)
    jop, top = s["g"], s["tg"]
    if sell:
        jop, top = J_ops.sell_pack_gsecsr(jop), T_ops.sell_pack_gsecsr(top)
    if not fused:
        jm_, tm_ = jm, tm
        jm = lambda r, tag: jm_.apply(r, tag)  # noqa: E731
        tm = lambda r, tag: tm_.apply(r, tag)  # noqa: E731
    kw = dict(tol=1e-10, maxiter=5000)
    jr = J_cg.solve_pcg(jop, jnp.asarray(s["b"]), jm,
                        params=J_P.MonitorParams(**FAST),
                        guards=J_GUARDS if guards else None,
                        flight=J_OF.FlightParams(capacity=2048), **kw)
    tb = torch.from_numpy(s["b"])
    tkw = dict(kw, params=T_P.MonitorParams(**FAST),
               guards=DEFAULT_GUARDS if guards else None)
    on = T_cg.solve_pcg(top, tb, tm, flight=T_OF.FlightParams(capacity=2048),
                        **tkw)
    assert int(on.iters) == iters
    if iters < 1000:  # SPAI-0's recorder-off run is test_torch_pcg.py's
        off = T_cg.solve_pcg(top, tb, tm, **tkw)
        assert torch.equal(on.x, off.x)
        assert float(on.relres) == float(off.relres)
    np.testing.assert_array_equal(on.x.numpy(), np.asarray(jr.x))
    log = _same_ring(on.flight, jr.flight)
    T_OF.assert_consistent(log, on)
    assert log.switch_iters().tolist() == on.switch_iters.tolist()


def test_a_small_ring_keeps_the_newest_rows(illcond):
    """Jacobi's 115 rows through a 50-row ring: the last 50 rows, 65
    dropped, and the consistency checks still pass."""
    s = illcond
    kw = dict(tol=1e-10, maxiter=5000, params=T_P.MonitorParams(**FAST))
    m = T_pc.make_jacobi(s["ta"], k=8)
    tb = torch.from_numpy(s["b"])
    full = T_cg.solve_pcg(s["tg"], tb, m,
                          flight=T_OF.FlightParams(capacity=128), **kw)
    ring = T_cg.solve_pcg(s["tg"], tb, m,
                          flight=T_OF.FlightParams(capacity=50), **kw)
    lf = T_OF.FlightLog.from_state(full.flight)
    lr = T_OF.FlightLog.from_state(ring.flight)
    assert (lr.recorded, lr.dropped, len(lr)) == (115, 65, 50)
    for c in COLS:
        np.testing.assert_array_equal(getattr(lr, c), getattr(lf, c)[-50:])
    T_OF.assert_consistent(lr, ring)
    assert lr.summary()["last_it"] == 114


def test_generic_cg_and_a_sell_cg_without_guards(illcond):
    """CG over the generic operator with guards off on quickstart
    section 4's system (a fixed budget that crosses both switches) and
    over its SELL pack."""
    s = illcond
    kw = dict(tol=1e-12, maxiter=300, guards=None)
    for jop, top in ((j_gse(s["g"]), make_gse_operator(s["tg"])),
                     (J_ops.sell_pack_gsecsr(s["g"]),
                      T_ops.sell_pack_gsecsr(s["tg"]))):
        jr = J_cg.solve_cg(jop, jnp.asarray(s["b"]),
                           params=J_P.MonitorParams(**FAST),
                           flight=J_OF.FlightParams(capacity=512), **kw)
        tr = T_cg.solve_cg(top, torch.from_numpy(s["b"]),
                           params=T_P.MonitorParams(**FAST),
                           flight=T_OF.FlightParams(capacity=512), **kw)
        np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
        log = _same_ring(tr.flight, jr.flight)
        T_OF.assert_consistent(log, tr)
        assert log.recorded == 300 and log.switch_iters().tolist() == \
            tr.switch_iters.tolist() != [-1, -1]


@pytest.mark.parametrize("pcg", [False, True])
def test_a_non_uniform_tagmap_stamps_the_tag_pair(pcg, illcond):
    s = illcond
    ng = -(-int(s["a"].shape[0]) // J_tm.GROUP_SIZE)
    tags = np.random.default_rng(5).integers(1, 3, ng, dtype=np.uint8)
    tags[0], tags[-1] = 1, 2
    jm, tm = J_tm.TagMap(tags), T_tm.TagMap(tags)
    kw = dict(tol=1e-9, maxiter=400)
    jb, tb = jnp.asarray(s["b"]), torch.from_numpy(s["b"])
    if pcg:
        jr = J_cg.solve_pcg(s["g"], jb, J_pc.make_jacobi(s["a"], k=8),
                            tags=jm, params=J_P.MonitorParams(**FAST),
                            flight=J_OF.FlightParams(capacity=512), **kw)
        tr = T_cg.solve_pcg(s["tg"], tb, T_pc.make_jacobi(s["ta"], k=8),
                            tags=tm, params=T_P.MonitorParams(**FAST),
                            flight=T_OF.FlightParams(capacity=512), **kw)
    else:
        jr = J_cg.solve_cg(s["g"], jb, tags=jm,
                           params=J_P.MonitorParams(**FAST),
                           flight=J_OF.FlightParams(capacity=512), **kw)
        tr = T_cg.solve_cg(s["tg"], tb, tags=tm,
                           params=T_P.MonitorParams(**FAST),
                           flight=T_OF.FlightParams(capacity=512), **kw)
    np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
    log = _same_ring(tr.flight, jr.flight)
    assert set(np.asarray(tr.flight["ibuf"])[:log.recorded, 1]) == {
        T_OF.pack_tag_pair(1, 2)}
    assert (log.tag == 2).all() and (log.tag_min == 1).all()
