"""The port's per-group precision axis against the JAX reference.

``core.tagmap`` (``TagMap``, ``normalize_tags``): every method and the
crc32 equal the reference's on random maps.  The byte models
(``GSECSR.bytes_touched(tm)``, the ELL layout's, ``GSESellC.bucket_tags``
and ``bytes_touched(tm)``, ``iteration_stream_bytes(op, tm, precond)``)
give the reference's integers.  ``kernels.ops.masked_for_tagmap`` gives the
reference's masked arrays bit for bit (CSR and SELL), shares every other
array with the operand, decodes at the map's max tag to the per-entry
oracle of tests/test_tagmap.py and stays symmetric.  The planner
(``core.precision``) is bitwise the reference's.  ``run_with_recovery_map``
raises only the floor.  A uniform map is bitwise the int tag through CG
(fused and generic), PCG, the SELL layout, batched CG/PCG and IR; a
non-uniform map through CG and PCG (fused and generic, CSR and SELL),
the batched solvers and IR is bitwise the reference's ``x``, ``iters``
and ``switch_iters``.  The mixed launch of B32 and C′32 (plain versions)
meets the reference's per-bucket Pallas calls in interpret mode within
rtol 2e-5 / atol 1e-4 and is bitwise the uniform plain call of each
bucket at its tag.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.core import tagmap as J_tm  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels import ref as J_ref  # noqa: E402
from repro.robustness import guards as J_guards  # noqa: E402
from repro.solvers import batched as J_b  # noqa: E402
from repro.solvers import cg as J_cg  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers.ir import solve_ir as j_solve_ir  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.core import tagmap as T_tm  # noqa: E402
from repro_torch.kernels import gse_spmm as T_c  # noqa: E402
from repro_torch.kernels import gse_spmv as T_k  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402
from repro_torch.robustness import guards as T_guards  # noqa: E402
from repro_torch.solvers import batched as T_b  # noqa: E402
from repro_torch.solvers import cg as T_cg  # noqa: E402
from repro_torch.solvers import make_gse_operator, make_jacobi  # noqa: E402
from repro_torch.solvers.ir import solve_ir as t_solve_ir  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402

CPU = "cpu"
FAST = dict(t=30, l=30, m=15, rsd_limit=0.5, reldec_limit=0.45)
GS = T_tm.GROUP_SIZE


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64 if v.dtype == np.float64 else np.uint32)


def _port_csr(a):
    return csr_from_repro({n: np.asarray(getattr(a, n))
                           for n in ("rowptr", "col", "val", "row_ids")},
                          a.shape, device=CPU)


def _sys(a, seed=0):
    """Reference and port packs of ``a`` (k=8) and ``b = A r``."""
    g = J_csr.pack_csr(a, k=8)
    ta = _port_csr(a)
    tg = T_csr.pack_csr(ta, k=8)
    rng = np.random.default_rng(seed)
    b = np.array(j_spmv(a, jnp.asarray(rng.normal(size=a.shape[1]))))
    return dict(a=a, g=g, ta=ta, tg=tg, b=b, m=int(a.shape[0]))


@pytest.fixture(scope="module")
def poisson():
    return _sys(J_gen.poisson2d(10), seed=3)


@pytest.fixture(scope="module")
def skewed():
    """A skewed SPD whose SELL pack has several width buckets."""
    a = J_gen.diag_rescale(J_gen.skewed_spd(320, dense_rows=2,
                                            base_halfwidth=10,
                                            tail_scale=6.0, seed=1), 6.0, 2)
    return _sys(a, seed=4)


@pytest.fixture(scope="module")
def blocks():
    """The direct sum of ``poisson2d(10)`` and four unit diagonal rows
    (104 rows of at most 5 entries, the SELL bucket 128 wide, groups 0-12)
    and a dense diagonally dominant SPD block of 144 rows (the bucket 256
    wide, groups 13-30): no entry couples the two, so a map can give the
    buckets different tags."""
    p = J_gen.poisson2d(10)
    rng = np.random.default_rng(6)
    d = rng.uniform(-1.0, 1.0, (144, 144))
    d = d + d.T
    d[np.arange(144), np.arange(144)] = np.abs(d).sum(axis=1) + 1.0
    r, c = np.nonzero(d)
    one = np.arange(100, 104)
    rows = np.concatenate([np.asarray(p.row_ids), one, r + 104])
    cols = np.concatenate([np.asarray(p.col), one, c + 104])
    vals = np.concatenate([np.asarray(p.val), np.ones(4), d[r, c]])
    return _sys(J_csr.from_coo(rows, cols, vals, (248, 248)), seed=8)


def _block_map(lo, hi):
    """Groups of the sparse block at ``lo``, of the dense block at
    ``hi``."""
    tags = np.full(31, lo, np.uint8)
    tags[13:] = hi
    return J_tm.TagMap(tags), T_tm.TagMap(tags)


def _mixed(m, lo=1, hi=2, period=3, seed=None):
    """A non-uniform map of ``m`` rows (every ``period``-th group at ``hi``,
    or random tags with ``seed``), as the reference's and the port's."""
    ng = -(-m // GS)
    if seed is None:
        tags = np.full(ng, lo, np.uint8)
        tags[::period] = hi
    else:
        tags = np.random.default_rng(seed).integers(lo, hi + 1, ng,
                                                    dtype=np.uint8)
        tags[0], tags[-1] = lo, hi
    return J_tm.TagMap(tags), T_tm.TagMap(tags)


def _params(port: bool, **kw):
    return (T_P if port else J_P).MonitorParams(**dict(FAST, **kw))


# --- TagMap ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tagmap_methods_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    ng = int(rng.integers(1, 40))
    gs = int(rng.choice([1, 4, 8, 16]))
    tags = rng.integers(1, 4, ng, dtype=np.uint8)
    jm, tm = J_tm.TagMap(tags, gs), T_tm.TagMap(tags, gs)
    assert tm.crc32 == jm.crc32 and repr(tm) == repr(jm)
    assert (tm.n_groups, tm.is_uniform, tm.min_tag, tm.max_tag) == (
        jm.n_groups, jm.is_uniform, jm.min_tag, jm.max_tag)
    assert tm.tag_counts() == jm.tag_counts() and hash(tm) == hash(jm)
    m = ng * gs + int(rng.integers(0, 9))
    np.testing.assert_array_equal(tm.row_tags(m), jm.row_tags(m))
    rows = rng.integers(0, m, 50)
    cols = rng.integers(0, m, 50)
    np.testing.assert_array_equal(tm.entry_tags(rows), jm.entry_tags(rows))
    np.testing.assert_array_equal(tm.entry_tags(rows, cols),
                                  jm.entry_tags(rows, cols))
    et = T_csr.entry_tags_t(tm, torch.from_numpy(rows),
                            torch.from_numpy(cols))
    np.testing.assert_array_equal(et.numpy(), jm.entry_tags(rows, cols))
    idx = rng.integers(0, ng, 3)
    for f in (1, 2, 3):
        assert tm.floored(f).crc32 == jm.floored(f).crc32
    assert tm.floored(tm.min_tag) is tm
    assert tm.promoted(idx).crc32 == jm.promoted(idx).crc32
    assert tm.promoted(idx, step=2).crc32 == jm.promoted(idx, step=2).crc32
    assert tm.with_tags(idx, 3).crc32 == jm.with_tags(idx, 3).crc32
    assert T_tm.TagMap.for_rows(m, 2, gs).crc32 == J_tm.TagMap.for_rows(
        m, 2, gs).crc32
    assert tm == T_tm.TagMap(tags.copy(), gs)
    assert tm != tm.with_tags([0], 1 if tm.tags[0] == 3 else 3)
    assert tm != T_tm.TagMap(tags, gs + 1)
    with pytest.raises(AttributeError, match="immutable"):
        tm.tags = tags
    with pytest.raises(ValueError):
        tm.tags[0] = 1


def test_normalize_tags_matches_the_reference():
    m = 64
    jm, tm = _mixed(m)
    for v in (None, 1, 2, 3, np.int64(2)):
        assert T_tm.normalize_tags(v, m) == J_tm.normalize_tags(v, m)
    assert T_tm.normalize_tags(T_tm.TagMap.for_rows(m, 3), m) == 3
    assert T_tm.normalize_tags(tm, m) is tm
    for bad in (0, 4):
        with pytest.raises(ValueError):
            T_tm.normalize_tags(bad, m)
    with pytest.raises(ValueError, match="groups"):
        T_tm.normalize_tags(T_tm.TagMap.for_rows(8, 1), m)
    with pytest.raises(TypeError):
        T_tm.normalize_tags("2", m)
    with pytest.raises(ValueError):
        T_tm.TagMap([1, 4])
    with pytest.raises(ValueError):
        T_tm.TagMap([], 8)


# --- byte models -------------------------------------------------------------

@pytest.mark.parametrize("case", ["poisson", "skewed"])
@pytest.mark.parametrize("seed", [None, 5])
def test_byte_models_match_the_reference(case, seed, request):
    s = request.getfixturevalue(case)
    g, tg, m = s["g"], s["tg"], s["m"]
    jm, tm = _mixed(m, lo=1, hi=3, seed=seed)
    assert tg.bytes_touched(tm) == g.bytes_touched(jm)
    for t in (1, 2, 3):
        u = T_tm.TagMap.for_rows(m, t)
        assert tg.bytes_touched(u) == tg.bytes_touched(t) == g.bytes_touched(t)
    jl, tl = J_csr.ell_layout(g), T_csr.ell_layout(tg)
    assert tl.bytes_touched(tm) == jl.bytes_touched(jm)
    js, ts = J_ops.sell_pack_gsecsr(g), T_ops.sell_pack_gsecsr(tg)
    assert ts.bucket_tags(tm) == js.bucket_tags(jm)
    assert ts.bytes_touched(tm) == js.bytes_touched(jm)
    assert tg.bytes_touched(tm, layout=ts) == g.bytes_touched(jm, layout=js)
    jp, tp = j_jacobi(s["a"], k=8), make_jacobi(s["ta"], k=8)
    for nrhs in (1, 3):
        assert T_csr.iteration_stream_bytes(tg, tm, tp, nrhs=nrhs) == \
            J_csr.iteration_stream_bytes(g, jm, jp, nrhs=nrhs)
        assert T_csr.iteration_stream_bytes(ts, tm, nrhs=nrhs) == \
            J_csr.iteration_stream_bytes(js, jm, nrhs=nrhs)
    with pytest.raises(TypeError, match="int tag"):
        ts.bytes_per_nnz(tm)
    with pytest.raises(TypeError, match="int tag"):
        ts.bytes_touched(object())


# --- masked operands ---------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(1, 2), (1, 3), (2, 3)])
def test_masked_csr_is_the_reference_bitwise(lo, hi, skewed):
    g, tg = skewed["g"], skewed["tg"]
    jm, tm = _mixed(skewed["m"], lo=lo, hi=hi)
    jmask, tmask = J_ops.masked_for_tagmap(g, jm), T_ops.masked_for_tagmap(
        tg, tm)
    for name in ("colpak", "head", "tail1", "tail2", "table", "rowptr",
                 "row_ids"):
        want = np.asarray(getattr(jmask, name))
        got = getattr(tmask, name).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # Only the tails are new; the row plan rides along.
    for name in ("colpak", "head", "rowptr", "row_ids", "table"):
        assert getattr(tmask, name) is getattr(tg, name)
    assert tmask.row_plan is tg.row_plan
    # Cached under the map's crc32: a hit, and a promoted map a new view.
    assert T_ops.masked_for_tagmap(tg, tm) is tmask
    assert T_ops.masked_for_tagmap(tg, tm.promoted([1])) is not tmask


@pytest.mark.parametrize("case", ["skewed", "blocks"])
@pytest.mark.parametrize("lo,hi", [(1, 2), (1, 3), (2, 3)])
def test_masked_sell_is_the_reference_bitwise(lo, hi, case, request):
    s = request.getfixturevalue(case)
    js = J_ops.sell_pack_gsecsr(s["g"])
    ts = T_ops.sell_pack_gsecsr(s["tg"])
    assert len(ts.widths) >= 2
    jm, tm = _mixed(s["m"], lo=lo, hi=hi, seed=lo + hi)
    jmask, tmask = J_ops.masked_for_tagmap(js, jm), T_ops.masked_for_tagmap(
        ts, tm)
    for name in ("colpak", "head", "tail1", "tail2"):
        for got, want in zip(getattr(tmask, name), getattr(jmask, name)):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
    for i, name in enumerate(("tail1", "tail2")):
        flat = tmask.segments[2 + i]
        for view in getattr(tmask, name):  # the buckets view the flat tails
            assert view.untyped_storage().data_ptr() == \
                flat.untyped_storage().data_ptr()
    assert tmask.segments[0] is ts.segments[0]
    assert tmask.segments[1] is ts.segments[1]
    for name in ("bucket_table", "row_len", "perm", "gather"):
        assert getattr(tmask, name) is getattr(ts, name)
    assert tmask.long_from == ts.long_from
    assert T_ops.masked_for_tagmap(ts, tm) is tmask
    assert T_ops.sell_bucket_tags(ts, tm) == tuple(J_ops.sell_bucket_tags(
        js, jm))


@pytest.mark.parametrize("layout", ["csr", "sell"])
def test_a_corrupted_masked_view_is_rebuilt(layout, skewed):
    """The pack cache checks a masked view's own tails on every hit: a
    flipped bit is detected and the view rebuilt from the operand."""
    op = skewed["tg"] if layout == "csr" else T_ops.sell_pack_gsecsr(
        skewed["tg"])
    _, tm = _mixed(skewed["m"], lo=2, hi=3, seed=21)
    view = T_ops.masked_for_tagmap(op, tm)
    tail = view.tail2 if layout == "csr" else view.segments[3]
    good = tail.clone()
    nz = int(torch.nonzero(good.view(torch.int32))[0, 0])
    tail.view(torch.int32)[nz] ^= 1
    before = T_ops.PACK_STATS["corrupt"]
    again = T_ops.masked_for_tagmap(op, tm)
    assert T_ops.PACK_STATS["corrupt"] == before + 1 and again is not view
    fresh = again.tail2 if layout == "csr" else again.segments[3]
    assert torch.equal(fresh.view(torch.int32), good.view(torch.int32))


def _per_entry(tg, tm):
    """Every entry decoded at its own induced tag (the oracle of
    tests/test_tagmap.py, on the port's pack and decode)."""
    et = tg.entry_tags(tm).numpy()
    decs = {t: T_ref.decode_csr_ref(tg.colpak, tg.head, tg.tail1, tg.tail2,
                                    tg.table, tg.ei_bit, t).numpy()
            for t in (1, 2, 3)}
    out = np.zeros(et.shape[0], np.float32)
    for t in (1, 2, 3):
        out[et == t] = decs[t][et == t]
    return out


@pytest.mark.parametrize("lo,hi", [(1, 2), (1, 3), (2, 3)])
def test_masked_decode_is_the_per_entry_decode(lo, hi, poisson):
    tg, g = poisson["tg"], poisson["g"]
    jm, tm = _mixed(poisson["m"], lo=lo, hi=hi, seed=7)
    tmask = T_ops.masked_for_tagmap(tg, tm)
    got = T_ref.decode_csr_ref(tmask.colpak, tmask.head, tmask.tail1,
                               tmask.tail2, tmask.table, tmask.ei_bit,
                               tm.max_tag).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_per_entry(tg, tm)))
    jmask = J_ops.masked_for_tagmap(g, jm)
    want = np.asarray(J_ref.decode_csr_ref(
        jmask.colpak, jmask.head, jmask.tail1, jmask.tail2, jmask.table,
        jmask.ei_bit, jm.max_tag))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_masked_operand_stays_symmetric(poisson):
    tg, m = poisson["tg"], poisson["m"]
    _, tm = _mixed(m, lo=1, hi=3, period=2)
    tmask = T_ops.masked_for_tagmap(tg, tm)
    vals = T_ref.decode_csr_ref(tmask.colpak, tmask.head, tmask.tail1,
                                tmask.tail2, tmask.table, tmask.ei_bit,
                                3).numpy().astype(np.float64)
    cols = (tg.colpak.numpy() & np.uint32((1 << (32 - tg.ei_bit)) - 1))
    dense = np.zeros((m, m))
    dense[tg.row_ids.numpy(), cols.astype(np.int64)] = vals
    np.testing.assert_array_equal(dense, dense.T)


# --- the planner -------------------------------------------------------------

@pytest.mark.parametrize("case", ["poisson", "skewed"])
def test_planner_is_the_reference_bitwise(case, request):
    s = request.getfixturevalue(case)
    g, tg, m = s["g"], s["tg"], s["m"]
    np.testing.assert_array_equal(_bits(T_P.group_sensitivity(tg)),
                                  _bits(J_P.group_sensitivity(g)))
    xh = np.abs(np.random.default_rng(2).normal(size=m)) * np.exp2(
        np.random.default_rng(3).uniform(-8, 8, m))
    sc_t, sc_j = T_P.decode_error_scores(tg, xh), J_P.decode_error_scores(
        g, xh)
    np.testing.assert_array_equal(_bits(sc_t), _bits(sc_j))
    jm, tm = _mixed(m, lo=1, hi=3, seed=9)
    np.testing.assert_array_equal(
        _bits(T_P.map_floor_contrib(sc_t, tm.tags)),
        _bits(J_P.map_floor_contrib(sc_j, jm.tags)))
    floor1 = float(np.sqrt(sc_j[0].sum()))
    for frac in (0.05, 0.25, 0.9, 2.0):
        assert T_P.plan_tagmap(sc_t, floor1 * frac).crc32 == \
            J_P.plan_tagmap(sc_j, floor1 * frac).crc32
        assert T_P.plan_tagmap(sc_t, floor1 * frac, tags0=tm).crc32 == \
            J_P.plan_tagmap(sc_j, floor1 * frac, tags0=jm).crc32
    for frac in (0.1, 0.25):
        score = T_P.group_sensitivity(tg)
        assert T_P.promote_groups(tm, score, frac=frac).crc32 == \
            J_P.promote_groups(jm, score, frac=frac).crc32
    with pytest.raises(ValueError, match="scores"):
        T_P.promote_groups(tm, np.zeros(3))
    with pytest.raises(ValueError, match="seed tags"):
        T_P.plan_tagmap(sc_t, 1.0, tags0=np.ones(2, np.uint8))


def test_plan_promotes_only_the_limiting_groups():
    s = _sys(J_gen.diag_rescale(J_gen.poisson2d(8), decades=6.0, seed=3))
    scores = T_P.decode_error_scores(s["tg"], np.ones(s["m"]))
    floor1 = float(np.sqrt(scores[0].sum()))
    tm = T_P.plan_tagmap(scores, budget=floor1 / 4.0)
    promoted = np.nonzero(tm.tags > 1)[0]
    kept = np.nonzero(tm.tags == 1)[0]
    assert promoted.size > 0 and kept.size > 0
    assert scores[0][promoted].min() >= scores[0][kept].max()
    assert float(np.sqrt(T_P.map_floor_contrib(scores, tm.tags).sum())) \
        <= floor1 / 4.0
    assert T_P.plan_tagmap(scores, budget=floor1 * 2.0).is_uniform


# --- the per-group recovery ladder ---------------------------------------------

def _fake_ladder(mod, lib, healths):
    """A ``run(x, budget, floor)`` whose runs end with ``healths`` in
    turn (a trip at iteration 3 of each tripping run, 5 iterations each)
    and the floors it was asked for."""
    calls = []

    def run(x, budget, floor):
        h = healths[len(calls)]
        calls.append((floor, budget))
        res = mod.CGResult(
            x=x, iters=lib.asarray(5), relres=lib.asarray(0.5),
            tag=lib.asarray(floor), switch_iters=lib.asarray([-1, -1]),
            converged=lib.asarray(h == 0), health=lib.asarray(h),
            trip_iter=lib.asarray(3 if h else -1))
        return res, x

    return run, calls


@pytest.mark.parametrize("healths,min_tag", [((2, 0), 1), ((2, 2, 0), 1),
                                             ((3, 3, 3), 1), ((2, 0), 2),
                                             ((0,), 1)])
def test_run_with_recovery_map_raises_only_the_floor(healths, min_tag):
    tags = np.array([min_tag, 3, min_tag, 2], np.uint8)
    jrun, jcalls = _fake_ladder(J_cg, jnp, healths)
    trun, tcalls = _fake_ladder(T_cg, torch, healths)
    jr = J_guards.run_with_recovery_map(jrun, jnp.zeros(2), 40,
                                        J_tm.TagMap(tags))
    tr = T_guards.run_with_recovery_map(trun, torch.zeros(2), 40,
                                        T_tm.TagMap(tags))
    assert tcalls == jcalls
    assert int(tr.iters) == int(jr.iters)
    assert tr.switch_iters.tolist() == np.asarray(jr.switch_iters).tolist()
    assert int(tr.trip_iter) == int(jr.trip_iter)
    assert int(tr.health) == int(jr.health)
    assert tcalls[0][0] == min_tag
    run, calls = _fake_ladder(T_cg, torch, healths)
    first = T_guards.run_with_recovery_map(run, torch.zeros(2), 40,
                                           T_tm.TagMap(tags), recover=False)
    assert calls == [(min_tag, 40)] and int(first.health) == healths[0]


def test_a_tripping_map_solve_escalates_like_the_reference(skewed):
    """A guard that trips early (a divergence factor of 1.5 on an
    ill-conditioned operator) sends the map solve up the floor ladder: the
    port's escalations, iterations and x are the reference's."""
    from repro.robustness.guards import GuardParams as JG
    from repro_torch.robustness.guards import GuardParams as TG

    jm, tm = _mixed(skewed["m"], lo=1, hi=2)
    kw = dict(tol=1e-10, maxiter=300)
    jr = J_cg.solve_cg(skewed["g"], jnp.asarray(skewed["b"]), tags=jm,
                       params=_params(False), guards=JG(div_factor=1.5), **kw)
    tr = T_cg.solve_cg(skewed["tg"], torch.from_numpy(skewed["b"]), tags=tm,
                       params=_params(True), guards=TG(div_factor=1.5), **kw)
    assert int(jr.trip_iter) >= 0  # the case trips
    assert np.asarray(jr.switch_iters).min() >= 0  # and climbs two rungs
    assert int(tr.iters) == int(jr.iters)
    assert tr.switch_iters.tolist() == np.asarray(jr.switch_iters).tolist()
    assert int(tr.trip_iter) == int(jr.trip_iter)
    assert int(tr.health) == int(jr.health)
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))


# --- uniform maps are the int tag --------------------------------------------

@pytest.mark.parametrize("tag", [1, 2, 3])
def test_uniform_identity_cg_fused(tag, poisson):
    tg, b, m = poisson["tg"], torch.from_numpy(poisson["b"]), poisson["m"]
    kw = dict(tol=1e-8, maxiter=2000, params=_params(True))
    ref = T_cg.solve_cg(tg, b, init_tag=tag, **kw)
    jr = J_cg.solve_cg(poisson["g"], jnp.asarray(poisson["b"]),
                       init_tag=tag, tol=1e-8, maxiter=2000,
                       params=_params(False))
    np.testing.assert_array_equal(_bits(ref.x.numpy()), _bits(jr.x))
    for axis in (tag, T_tm.TagMap.for_rows(m, tag)):
        res = T_cg.solve_cg(tg, b, tags=axis, **kw)
        assert torch.equal(res.x, ref.x)
        assert int(res.iters) == int(ref.iters) and int(res.tag) == int(
            ref.tag)


def test_uniform_identity_cg_generic_pcg_sell(poisson):
    tg, b, m = poisson["tg"], torch.from_numpy(poisson["b"]), poisson["m"]
    kw = dict(tol=1e-8, maxiter=2000, params=_params(True))
    op = make_gse_operator(tg)
    ref = T_cg.solve_cg(op, b, init_tag=2, **kw)
    res = T_cg.solve_cg(op, b, tags=T_tm.TagMap.for_rows(m, 2), **kw)
    assert torch.equal(res.x, ref.x) and int(res.iters) == int(ref.iters)
    pre = make_jacobi(poisson["ta"], k=8)
    ref = T_cg.solve_pcg(tg, b, pre, init_tag=2, **kw)
    for axis in (2, T_tm.TagMap.for_rows(m, 2)):
        res = T_cg.solve_pcg(tg, b, pre, tags=axis, **kw)
        assert torch.equal(res.x, ref.x) and int(res.iters) == int(ref.iters)
    sell = T_ops.sell_pack_gsecsr(tg)
    ref = T_cg.solve_cg(sell, b, init_tag=1, **kw)
    res = T_cg.solve_cg(sell, b, tags=T_tm.TagMap.for_rows(m, 1), **kw)
    assert torch.equal(res.x, ref.x) and int(res.iters) == int(ref.iters)


@pytest.mark.parametrize("nrhs", [1, 4])
def test_uniform_identity_batched(nrhs, poisson):
    a, tg, m = poisson["a"], poisson["tg"], poisson["m"]
    rng = np.random.default_rng(4)
    b = torch.from_numpy(np.stack([np.array(j_spmv(a, jnp.asarray(
        rng.normal(size=m)))) for _ in range(nrhs)], axis=1))
    kw = dict(tol=1e-8, maxiter=2000, params=_params(True), device=CPU)
    ref = T_b.solve_cg_batched(tg, b, **kw)
    res = T_b.solve_cg_batched(tg, b, tags=T_tm.TagMap.for_rows(m, 1), **kw)
    assert torch.equal(res.x, ref.x)
    assert res.iters.tolist() == ref.iters.tolist()
    pre = make_jacobi(poisson["ta"], k=8)
    r2 = T_b.solve_pcg_batched(tg, b, pre, tags=2, **kw)
    rm = T_b.solve_pcg_batched(tg, b, pre, tags=T_tm.TagMap.for_rows(m, 2),
                               **kw)
    assert torch.equal(r2.x, rm.x) and r2.iters.tolist() == rm.iters.tolist()


def test_uniform_identity_ir(poisson):
    tg, b, m = poisson["tg"], torch.from_numpy(poisson["b"]), poisson["m"]
    kw = dict(tol=1e-12, max_outer=6, inner_tol=1e-4, inner_maxiter=800,
              params=_params(True))
    ref = t_solve_ir(tg, b, **kw)
    res = t_solve_ir(tg, b, tags=T_tm.TagMap.for_rows(m, 1), **kw)
    assert torch.equal(res.x, ref.x) and res.converged


# --- non-uniform maps against the reference ----------------------------------

def _jacobi_callable(pre):
    return lambda r, tag: pre.apply(r, tag)


SOLVES = ["cg_csr", "cg_sell", "pcg_fused", "pcg_generic", "cg_final"]


@pytest.mark.parametrize("kind", SOLVES)
def test_nonuniform_map_solve_is_the_reference(kind, skewed):
    s = skewed
    jm, tm = _mixed(s["m"], lo=1, hi=2, seed=11)
    jb, tb = jnp.asarray(s["b"]), torch.from_numpy(s["b"])
    kw = dict(tol=1e-9, maxiter=600)
    jop, top = s["g"], s["tg"]
    if kind == "cg_sell":
        jop, top = J_ops.sell_pack_gsecsr(jop), T_ops.sell_pack_gsecsr(top)
    if kind.startswith("pcg"):
        jp, tp = j_jacobi(s["a"], k=8), make_jacobi(s["ta"], k=8)
        if kind == "pcg_generic":
            jp, tp = _jacobi_callable(jp), _jacobi_callable(tp)
        jr = J_cg.solve_pcg(jop, jb, jp, tags=jm, params=_params(False), **kw)
        tr = T_cg.solve_pcg(top, tb, tp, tags=tm, params=_params(True), **kw)
    else:
        fc = kind == "cg_final"
        jr = J_cg.solve_cg(jop, jb, tags=jm, params=_params(False),
                           final_correction=fc, **kw)
        tr = T_cg.solve_cg(top, tb, tags=tm, params=_params(True),
                           final_correction=fc, **kw)
    assert int(tr.iters) == int(jr.iters) > 0
    assert int(tr.tag) == int(jr.tag) == tm.max_tag or kind == "cg_final"
    assert tr.switch_iters.tolist() == np.asarray(jr.switch_iters).tolist()
    assert float(tr.relres) == float(jr.relres)
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))


@pytest.mark.parametrize("kind", ["cg", "pcg", "cg_sell", "ir"])
def test_nonuniform_map_batched_is_the_reference(kind, skewed):
    s = skewed
    jm, tm = _mixed(s["m"], lo=1, hi=3, seed=12)
    rng = np.random.default_rng(5)
    b = np.stack([s["b"], 2 * s["b"], np.array(j_spmv(s["a"], jnp.asarray(
        rng.normal(size=s["m"]))))], axis=1)
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    if kind == "ir":
        kw = dict(tol=1e-11, max_outer=4, inner_tol=1e-5, inner_maxiter=400)
        jr = J_b.solve_ir_batched(s["g"], jb, params=_params(False), tags=jm,
                                  **kw)
        tr = T_b.solve_ir_batched(s["tg"], tb, params=_params(True), tags=tm,
                                  device=CPU, **kw)
        assert tr.outer_iters.tolist() == np.asarray(jr.outer_iters).tolist()
        assert tr.inner_iters.tolist() == np.asarray(jr.inner_iters).tolist()
        np.testing.assert_array_equal(_bits(tr.relres), _bits(jr.relres))
        np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))
        return
    kw = dict(tol=1e-9, maxiter=600)
    jop, top = s["g"], s["tg"]
    if kind == "cg_sell":
        jop, top = J_ops.sell_pack_gsecsr(jop), T_ops.sell_pack_gsecsr(top)
    if kind == "pcg":
        jr = J_b.solve_pcg_batched(jop, jb, j_jacobi(s["a"], k=8), tags=jm,
                                   params=_params(False), **kw)
        tr = T_b.solve_pcg_batched(top, tb, make_jacobi(s["ta"], k=8),
                                   tags=tm, params=_params(True), device=CPU,
                                   **kw)
    else:
        jr = J_b.solve_cg_batched(jop, jb, tags=jm, params=_params(False),
                                  **kw)
        tr = T_b.solve_cg_batched(top, tb, tags=tm, params=_params(True),
                                  device=CPU, **kw)
    assert tr.iters.tolist() == np.asarray(jr.iters).tolist()
    assert tr.tag.tolist() == np.asarray(jr.tag).tolist() == [3] * 3
    assert tr.switch_iters.tolist() == np.asarray(jr.switch_iters).tolist()
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))


def test_nonuniform_map_ir_is_the_reference(skewed):
    s = skewed
    jm, tm = _mixed(s["m"], lo=1, hi=2, seed=13)
    kw = dict(tol=1e-11, max_outer=4, inner_tol=1e-5, inner_maxiter=400)
    jr = j_solve_ir(s["g"], jnp.asarray(s["b"]), params=_params(False),
                    tags=jm, **kw)
    tr = t_solve_ir(s["tg"], torch.from_numpy(s["b"]), params=_params(True),
                    tags=tm, **kw)
    assert (tr.outer_iters, tr.inner_iters) == (jr.outer_iters,
                                                jr.inner_iters)
    assert tr.relres == float(jr.relres)
    np.testing.assert_array_equal(_bits(tr.history), _bits(jr.history))
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))


def test_the_map_axis_refusals(poisson):
    tg, b, m = poisson["tg"], torch.from_numpy(poisson["b"]), poisson["m"]
    _, tm = _mixed(m)
    with pytest.raises(ValueError, match="packed GSE operand"):
        T_cg.solve_cg(make_gse_operator(tg), b, tags=tm)
    with pytest.raises(ValueError, match="'adaptive'"):
        T_cg.solve_cg(tg, b, tags="frobnicate")
    with pytest.raises(ValueError, match="single-RHS"):
        T_b.solve_cg_batched(tg, b, tags="adaptive", device=CPU)
    with pytest.raises(ValueError, match="groups"):
        T_cg.solve_cg(tg, b, tags=T_tm.TagMap.for_rows(8, 1))
    with pytest.raises(TypeError, match="TagMap"):
        T_cg.solve_pcg(tg, b, make_jacobi(poisson["ta"], k=8),
                       tags=object())


# --- the chunking hooks ------------------------------------------------------

@pytest.mark.parametrize("stops", [(40,), (7, 64, 65), (100, 1000)])
def test_chunked_loop_resumes_bitwise(stops, skewed):
    """``stop_at`` chunks the loop (the last chunk cut to the iterations
    left) and ``resume`` continues it: bitwise the unchunked run."""
    tg, b = skewed["tg"], torch.from_numpy(skewed["b"])
    params = _params(True)
    tol = torch.tensor(1e-9, dtype=torch.float64)
    x0 = torch.zeros_like(b)
    full, _ = T_cg._solve_cg_fused(tg, b, x0, tol, 500, params)
    state = None
    for stop in stops:
        res, _, state = T_cg._solve_cg_fused(tg, b, x0, tol, 500, params,
                                             resume=state, stop_at=stop,
                                             return_state=True)
        assert int(res.iters) == min(stop, int(full.iters))
    res, _ = T_cg._solve_cg_fused(tg, b, x0, tol, 500, params, resume=state)
    assert int(res.iters) == int(full.iters)
    assert torch.equal(res.x, full.x)
    assert res.switch_iters.tolist() == full.switch_iters.tolist()


# --- kernels B32 and C′32: the mixed launch ------------------------------------

@pytest.mark.parametrize("lo,hi", [(1, 2), (1, 3), (2, 3), (3, 1), (2, 1)])
def test_mixed_b32_c32_plain_against_the_reference(lo, hi, blocks):
    s = blocks
    js = J_ops.sell_pack_gsecsr(s["g"])
    ts = T_ops.sell_pack_gsecsr(s["tg"])
    jm, tm = _block_map(lo, hi)
    btags = ts.bucket_tags(tm)
    assert ts.widths == (128, 256) and btags == (lo, hi)
    rng = np.random.default_rng(lo * 4 + hi)
    x = rng.normal(size=s["m"]).astype(np.float32)
    X = rng.normal(size=(s["m"], 3)).astype(np.float32)
    tmask = T_ops.masked_for_tagmap(ts, tm)
    y = T_ops.gse_spmv_sell(tmask, torch.from_numpy(x), tag=tm)
    Y = T_ops.gse_spmm_sell(tmask, torch.from_numpy(X), tag=tm, device=CPU)
    jmask = J_ops.masked_for_tagmap(js, jm)
    yj = np.asarray(J_ops.gse_spmv_sell(jmask, jnp.asarray(x), tag=jm))
    Yj = np.asarray(J_ops.gse_spmm_sell(jmask, jnp.asarray(X), tag=jm))
    np.testing.assert_allclose(y.numpy(), yj, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(Y.numpy(), Yj, rtol=2e-5, atol=1e-4)
    # Bucket for bucket the uniform plain call at the bucket's tag, over
    # the same masked pack.
    scales = T_ops._scales_by_tag(ts.table)
    segs = tmask.segments
    perm = ts.perm.numpy()
    rows0 = ts.bucket_table[:, 0].tolist() + [perm.shape[0]]
    for b, t in enumerate(btags):
        uni = T_k.gse_spmv_sell_f32_plain(
            segs[0], segs[1], segs[2] if t >= 2 else None,
            segs[3] if t == 3 else None, torch.from_numpy(x), scales[t - 1],
            ts.bucket_table, ts.perm, rows=ts.shape[0], ei_bit=ts.ei_bit,
            tag=t)
        uni_c = T_c.gse_spmm_sell_f32_plain(
            segs[0], segs[1], segs[2] if t >= 2 else None,
            segs[3] if t == 3 else None, torch.from_numpy(X), scales[t - 1],
            ts.bucket_table, ts.perm, rows=ts.shape[0], ei_bit=ts.ei_bit,
            tag=t)
        rows = perm[rows0[b]:rows0[b + 1]]
        rows = rows[rows >= 0]
        np.testing.assert_array_equal(_bits(y.numpy()[rows]),
                                      _bits(uni.numpy()[rows]))
        np.testing.assert_array_equal(_bits(Y.numpy()[rows]),
                                      _bits(uni_c.numpy()[rows]))


def test_mixed_launch_checks_its_bucket_tags(blocks):
    ts = T_ops.sell_pack_gsecsr(blocks["tg"])
    _, tm = _block_map(1, 3)
    btags = T_ops.sell_bucket_tags(ts, tm)
    scales = T_ops._scales_by_tag(ts.table)
    segs = T_ops.masked_for_tagmap(ts, tm).segments
    x = torch.zeros(ts.shape[1])
    kw = dict(rows=ts.shape[0], ei_bit=ts.ei_bit)
    assert btags == (1, 3)
    with pytest.raises(ValueError, match="reach tag"):
        T_k.gse_spmv_sell_f32(*segs, x, scales, ts.bucket_table, ts.perm,
                              tag=2, bucket_tags=(1, 1), **kw)
    with pytest.raises(ValueError, match="reach tag"):
        T_k.gse_spmv_sell_f32(*segs, x, scales, ts.bucket_table, ts.perm,
                              tag=2, bucket_tags=(1, 3), **kw)
    with pytest.raises(ValueError, match="reach tag"):
        T_k.gse_spmv_sell_f32(*segs, x, scales, ts.bucket_table, ts.perm,
                              tag=3, bucket_tags=(0, 0), **kw)
    with pytest.raises(TypeError, match="host sequence"):
        T_k.gse_spmv_sell_f32(*segs, x, scales, ts.bucket_table, ts.perm,
                              tag=3, bucket_tags=torch.tensor(btags), **kw)
    with pytest.raises(ValueError, match="buckets"):
        T_k.gse_spmv_sell_f32(*segs, x, scales, ts.bucket_table, ts.perm,
                              tag=3, bucket_tags=btags[:1], **kw)
    with pytest.raises(ValueError, match=r"\(3, k\)"):
        T_k.gse_spmv_sell_f32(*segs, x, scales[0], ts.bucket_table, ts.perm,
                              tag=3, bucket_tags=btags, **kw)


@pytest.mark.parametrize("t", [1, 2, 3])
def test_mixed_launch_with_one_tag_is_the_uniform_launch(t, blocks):
    """Buckets all at one tag run the uniform launch at that tag (on the
    tag's row of the (3, k) scales): bitwise the uniform call, for B32
    and C′32, and through ``gse_spmv_sell(tag=TagMap)``."""
    from repro_torch.core.tagmap import TagMap

    ts = T_ops.sell_pack_gsecsr(blocks["tg"])
    tm = TagMap([t] * int(np.ceil(ts.shape[0] / 8)))
    assert T_ops.sell_bucket_tags(ts, tm) == (t, t)
    scales = T_ops._scales_by_tag(ts.table)
    segs = ts.segments
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.normal(size=ts.shape[1]).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(ts.shape[1], 5)).astype(
        np.float32))
    kw = dict(rows=ts.shape[0], ei_bit=ts.ei_bit, tag=t)
    y = T_k.gse_spmv_sell_f32(*segs, x, scales, ts.bucket_table, ts.perm,
                              bucket_tags=(t, t), **kw)
    Y = T_c.gse_spmm_sell_f32(*segs, X, scales, ts.bucket_table, ts.perm,
                              bucket_tags=(t, t), device=CPU, **kw)
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(
        T_ops.gse_spmv_sell(ts, x, tag=t).numpy()))
    np.testing.assert_array_equal(_bits(Y.numpy()), _bits(
        T_ops.gse_spmm_sell(ts, X, tag=t, device=CPU).numpy()))
    np.testing.assert_array_equal(_bits(T_ops.gse_spmv_sell(
        T_ops.masked_for_tagmap(ts, tm), x, tag=tm).numpy()), _bits(
        y.numpy()))
