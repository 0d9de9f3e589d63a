"""The port's SELL-C-sigma layout (kernels B and C′) against the JAX
reference.

The pack: ``pack_sell`` / ``sell_pack_gsecsr`` give the reference's bucket
arrays, ``gather``, ``perm``, ``unperm``, widths and effective sigma bit
for bit on small skewed matrices, and the byte models (``bytes_touched``,
``padding_ratio``, ``ell_layout``, ``iteration_stream_bytes(layout=)``)
give the reference's figures.  The kernels, on the CPU through their plain
versions: B32 and C′32 against the Pallas SELL kernels in interpret mode
(rtol 2e-5 / atol 1e-4, the tolerances of tests/test_sell.py) and bitwise
against the port's A32 / C32 on the uniform ELL of the same operator; B64
and C′64 bitwise against the port's ``spmv_gse`` / ``spmm_gse`` on the
``GSECSR`` and against the reference's SELL ``spmv_gse`` / ``spmm_gse``.
chip_smoke.py holds the CUDA kernels to these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as J_ops  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse import spmv as J_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro  # noqa: E402
from repro_torch.core.precision_table import TAG_BITS_USED  # noqa: E402
from repro_torch.kernels import gse_spmm as T_c  # noqa: E402
from repro_torch.kernels import gse_spmv as T_k  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import spmv as T_spmv  # noqa: E402

CPU = "cpu"
SEGMENTS = ("colpak", "head", "tail1", "tail2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skewed_small(n=320, seed=0):
    """Small skewed SPD: power-law rows + dense hubs, several buckets (the
    reference's tests/test_sell.py case)."""
    return J_gen.skewed_spd(n, dense_rows=2, base_halfwidth=10,
                            tail_scale=6.0, seed=seed)


def _port_csr(a):
    return csr_from_repro({n: np.asarray(getattr(a, n))
                           for n in ("rowptr", "col", "val", "row_ids")},
                          a.shape, device=CPU)


def _pair(seed=0):
    a = _skewed_small(seed=seed)
    return J_csr.pack_csr(a, k=8), T_csr.pack_csr(_port_csr(a), k=8)


@pytest.fixture(scope="module")
def packs():
    jg, tg = _pair(seed=1)
    return jg, tg, J_ops.sell_pack_gsecsr(jg), T_ops.sell_pack_gsecsr(tg)


def _bits(v):
    v = np.asarray(v)
    return v.view(np.uint64 if v.dtype == np.float64 else np.uint32)


def _assert_same_pack(js, ts):
    assert ts.widths == js.widths
    assert ts.bucket_rows == js.bucket_rows
    assert (ts.c, ts.sigma, ts.lane, ts.ei_bit) == (js.c, js.sigma, js.lane,
                                                    js.ei_bit)
    for name in SEGMENTS:
        assert len(getattr(ts, name)) == len(getattr(js, name))
        for t, j in zip(getattr(ts, name), getattr(js, name)):
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype
            np.testing.assert_array_equal(t.numpy(), j)
    for name in ("gather", "perm", "unperm", "row_ids", "table"):
        j = np.asarray(getattr(js, name))
        assert getattr(ts, name).numpy().dtype == j.dtype
        np.testing.assert_array_equal(getattr(ts, name).numpy(), j)


@pytest.mark.parametrize("bucket", ["pow2", "exact"])
@pytest.mark.parametrize("sigma", [None, 16, 64])
def test_pack_sell_equals_the_reference(sigma, bucket):
    jg, tg = _pair(seed=3)
    js = J_csr.pack_sell(jg, sigma=sigma, bucket=bucket)
    ts = T_csr.pack_sell(tg, sigma=sigma, bucket=bucket)
    _assert_same_pack(js, ts)
    # The port-private arrays: flat segments the bucket arrays view, the
    # bucket table and each bucket row's real length.
    flat = ts.segments
    for i, name in enumerate(SEGMENTS):
        np.testing.assert_array_equal(
            flat[i].numpy(), np.concatenate(
                [np.asarray(b).reshape(-1) for b in getattr(js, name)]))
        for b in getattr(ts, name):
            assert b.untyped_storage().data_ptr() == \
                flat[i].untyped_storage().data_ptr()
    rows = np.cumsum([0] + list(js.bucket_rows[:-1]))
    offs = np.cumsum([0] + [r * w for r, w in zip(js.bucket_rows[:-1],
                                                  js.widths[:-1])])
    np.testing.assert_array_equal(ts.bucket_table.numpy(),
                                  np.stack([rows, js.widths, offs], axis=1))
    perm = np.asarray(js.perm)
    per_row = np.diff(np.asarray(jg.rowptr))
    np.testing.assert_array_equal(
        ts.row_len.numpy(), np.where(perm >= 0, per_row[np.maximum(perm, 0)],
                                     0))


@pytest.mark.parametrize("bucket", ["pow2", "exact"])
@pytest.mark.parametrize("sigma", [None, 16, 64])
def test_sell_pack_gsecsr_equals_the_reference(sigma, bucket):
    jg, tg = _pair(seed=4)
    _assert_same_pack(J_ops.sell_pack_gsecsr(jg, sigma=sigma, bucket=bucket),
                      T_ops.sell_pack_gsecsr(tg, sigma=sigma, bucket=bucket))


def test_sell_slices_equals_the_reference():
    jg, tg = _pair(seed=5)
    for kw in (dict(), dict(c=16, sigma=32), dict(lane=64, bucket="exact")):
        jo, jw, js = J_csr.sell_slices(jg.rowptr, **kw)
        to, tw, ts = T_csr.sell_slices(tg.rowptr, **kw)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tw, jw)
        assert ts == js
    with pytest.raises(ValueError, match="bucket"):
        T_csr.sell_slices(tg.rowptr, bucket="nope")
    with pytest.raises(ValueError, match=">= 1"):
        T_csr.sell_slices(tg.rowptr, c=0)


def test_byte_models_equal_the_reference(packs):
    jg, tg, js, ts = packs
    assert ts.slots == js.slots and ts.nnz == js.nnz
    assert ts.padding_ratio == js.padding_ratio
    jl, tl = J_csr.ell_layout(jg), T_csr.ell_layout(tg)
    assert (tl.rows, tl.width, tl.nnz, tl.table_entries) == (
        jl.rows, jl.width, jl.nnz, jl.table_entries)
    assert tl.slots == jl.slots and tl.padding_ratio == jl.padding_ratio
    assert ts.padding_ratio < tl.padding_ratio
    for tag in (1, 2, 3):
        assert ts.bytes_touched(tag) == js.bytes_touched(tag)
        assert ts.bytes_per_nnz(tag) == js.bytes_per_nnz(tag)
        assert tl.bytes_touched(tag) == jl.bytes_touched(tag)
        assert tg.bytes_touched(tag, layout=ts) == jg.bytes_touched(
            tag, layout=js)
        assert tg.bytes_touched(tag, layout=tl) == jg.bytes_touched(
            tag, layout=jl)
        for nrhs in (1, 4):
            for lay in ((js, ts), (jl, tl)):
                assert T_csr.iteration_stream_bytes(
                    tg, tag, nrhs=nrhs, layout=lay[1]) == \
                    J_csr.iteration_stream_bytes(jg, tag, nrhs=nrhs,
                                                 layout=lay[0])
            assert T_csr.iteration_stream_bytes(ts, tag, nrhs=nrhs) == \
                J_csr.iteration_stream_bytes(js, tag, nrhs=nrhs)


def test_tagmaps_and_plans_are_not_ported(packs):
    """Per-group maps are ported (tests/test_torch_tagmap.py): the bucket
    tags equal the reference's, and a tag that is neither an int nor a
    map is refused.  Launch plans are ported too (tests/test_torch_perf.py):
    explicit ``blocks=`` and ``plan=`` run the same launch bitwise, a grid
    tile that does not fit the pack is refused as the reference refuses
    it, and ``sell_pack_gsecsr(plan=)``, ``planned_spmv`` and
    ``planned_spmm`` give the reference's pack and the default's bits."""
    from repro.core.tagmap import TagMap as JMap
    from repro.perf.plan import KernelPlan as JPlan
    from repro_torch.core.tagmap import TagMap as TMap
    from repro_torch.perf.plan import KernelPlan as TPlan

    jg, tg, js, ts = packs
    tags = np.ones(-(-ts.shape[0] // 8), np.uint8)
    tags[::4] = 3
    assert ts.bucket_tags(TMap(tags)) == js.bucket_tags(JMap(tags))
    assert ts.bytes_touched(TMap(tags)) == js.bytes_touched(JMap(tags))
    with pytest.raises(TypeError, match="int tag"):
        ts.bytes_touched(object())
    with pytest.raises(TypeError, match="int tag"):
        T_ops.gse_spmv_sell(ts, torch.zeros(ts.shape[1]), tag=object())
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=ts.shape[1]).astype(np.float32))
    xc = torch.from_numpy(np.random.default_rng(4).normal(
        size=(ts.shape[1], 2)).astype(np.float32))
    want = T_ops.gse_spmv_sell(ts, x)
    want_c = T_ops.gse_spmm_sell(ts, xc, device=CPU)
    assert torch.equal(T_ops.gse_spmv_sell(ts, x, blocks=(8, 128)), want)
    assert torch.equal(T_ops.gse_spmm_sell(ts, xc, plan=TPlan(), device=CPU),
                       want_c)
    with pytest.raises(ValueError, match="multiple of the row block"):
        T_ops.gse_spmv_sell(ts, x, blocks=(16, 128))
    with pytest.raises(ValueError, match="lane block"):
        T_ops.gse_spmm_sell(ts, xc, plan=TPlan(blocks=(8, 256)), device=CPU)
    plan_t = TPlan(blocks=(16, 128), sell_c=16, sell_sigma=64)
    plan_j = JPlan(blocks=(16, 128), sell_c=16, sell_sigma=64)
    _assert_same_pack(J_ops.sell_pack_gsecsr(jg, plan=plan_j),
                      T_ops.sell_pack_gsecsr(tg, plan=plan_t))
    assert torch.equal(T_ops.planned_spmv(tg, x, layout="sell"), want)
    assert torch.equal(T_ops.planned_spmm(tg, xc, layout="sell",
                                          plan=plan_t, device=CPU), want_c)


def test_sell_buckets_hold_the_segments_each_tag_reads(packs):
    _, _, js, ts = packs
    for tag in (1, 2, 3):
        jb, tb = J_ops._sell_buckets(js, tag), T_ops._sell_buckets(ts, tag)
        assert len(tb) == len(jb) == ts.n_buckets
        for jt, tt in zip(jb, tb):
            assert len(tt) == len(jt) == 2 + (tag >= 2) + (tag == 3)
            for j, t in zip(jt, tt):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_c_must_be_a_multiple_of_8():
    _, tg = _pair()
    with pytest.raises(ValueError, match="multiple of 8"):
        T_csr.pack_sell(tg, c=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        T_ops.sell_pack_gsecsr(tg, c=4)


def test_pack_cache_hit_counts():
    _, tg = _pair(seed=6)
    stats = T_ops.PACK_STATS
    h0, m0 = stats["hits"], stats["misses"]
    s1 = T_ops.sell_pack_gsecsr(tg)
    s2 = T_ops.sell_pack_gsecsr(tg)
    assert s1 is s2
    assert (stats["hits"] - h0, stats["misses"] - m0) == (1, 1)
    s3 = T_ops.sell_pack_gsecsr(tg, sigma=16)  # another key: one more pack
    assert s3 is not s1
    assert (stats["hits"] - h0, stats["misses"] - m0) == (1, 2)
    assert T_ops.sell_pack_gsecsr(tg, c=8, sigma=None, lane=128,
                                  bucket="pow2") is s1
    assert (stats["hits"] - h0, stats["misses"] - m0) == (2, 2)
    # A corrupted bucket array is detected on the next hit and repacked.
    c0 = stats["corrupt"]
    s1.head[0].numpy()[0, 0] ^= 1
    s4 = T_ops.sell_pack_gsecsr(tg)
    assert stats["corrupt"] - c0 == 1 and s4 is not s1
    _assert_same_pack(J_ops.sell_pack_gsecsr(J_csr.pack_csr(
        _skewed_small(seed=6), k=8)), s4)


def _x(n, seed, nrhs=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n if nrhs is None else (n, nrhs)).astype(dtype)


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_b32_plain_matches_pallas_and_a32(packs, tag):
    jg, tg, js, ts = packs
    x = _x(ts.shape[1], 10 + tag, dtype=np.float32)
    want = np.asarray(J_ops.gse_spmv_sell(js, jnp.asarray(x), tag=tag))
    got = T_ops.gse_spmv_sell(ts, torch.from_numpy(x), tag=tag)
    assert got.dtype == torch.float32 and got.shape == (ts.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
    a32 = T_ops.gse_spmv_ell(T_ops.ell_pack_gsecsr(tg), tg.table,
                             torch.from_numpy(x), tg.ei_bit, tag=tag)
    assert torch.equal(got.view(torch.int32), a32.view(torch.int32))


@pytest.mark.parametrize("layout", ["transposed_view", "float64"])
def test_c32_takes_the_callers_n_by_nrhs_block(packs, layout):
    """C′32 reads X as the caller's ``(n, nrhs)`` block: a transposed view
    of an ``(nrhs, n)`` array, or an f64 block, through
    ``ops.gse_spmm_sell`` gives the reference's Y, and bitwise what a
    contiguous f32 copy gives."""
    jg, tg, js, ts = packs
    cols = _x(ts.shape[1], 40, 6, dtype=np.float32).T.copy()  # (nrhs, n)
    x = (torch.from_numpy(cols).t() if layout == "transposed_view"
         else torch.from_numpy(cols.T.astype(np.float64)))
    assert x.shape == (ts.shape[1], 6)
    want = np.asarray(J_ops.gse_spmm_sell(js, jnp.asarray(cols.T), tag=2))
    got = T_ops.gse_spmm_sell(ts, x, tag=2, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
    flat = T_ops.gse_spmm_sell(ts, torch.from_numpy(cols.T.copy()), tag=2,
                               device=CPU)
    assert torch.equal(got.view(torch.int32), flat.view(torch.int32))


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("nrhs", [1, 2, 5])
def test_c32_plain_matches_pallas_and_c32(packs, nrhs, tag):
    jg, tg, js, ts = packs
    x = _x(ts.shape[1], 20 + tag, nrhs, dtype=np.float32)
    want = np.asarray(J_ops.gse_spmm_sell(js, jnp.asarray(x), tag=tag))
    got = T_ops.gse_spmm_sell(ts, torch.from_numpy(x), tag=tag, device=CPU)
    assert got.shape == (ts.shape[0], nrhs)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
    c32 = T_ops.gse_spmm_ell(T_ops.ell_pack_gsecsr(tg), tg.table,
                             torch.from_numpy(x), tg.ei_bit, tag=tag,
                             device=CPU)
    assert torch.equal(got.view(torch.int32), c32.view(torch.int32))
    if nrhs == 1:
        b32 = T_ops.gse_spmv_sell(ts, torch.from_numpy(x[:, 0]), tag=tag)
        assert torch.equal(got[:, 0].view(torch.int32), b32.view(torch.int32))


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_b64_plain_is_bitwise_csr_and_reference(packs, tag):
    jg, tg, js, ts = packs
    x = _x(ts.shape[1], 30 + tag)
    got = T_spmv.spmv_gse(ts, torch.from_numpy(x), tag)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(
        _bits(got.numpy()), _bits(T_spmv.spmv_gse(tg, torch.from_numpy(x),
                                                  tag).numpy()))
    np.testing.assert_array_equal(
        _bits(got.numpy()), _bits(J_spmv.spmv_gse(js, jnp.asarray(x),
                                                  tag=tag)))
    # The device-tag form the CG loop passes gives the same bits.
    dev_tag = torch.tensor(tag, dtype=torch.int32)
    assert torch.equal(T_spmv.spmv_gse(ts, torch.from_numpy(x), dev_tag), got)


@pytest.mark.parametrize("nrhs", [1, 2, 5])
def test_c64_plain_is_bitwise_csr_and_reference(packs, nrhs):
    jg, tg, js, ts = packs
    x = _x(ts.shape[1], 40 + nrhs, nrhs)
    for tag in (1, 2, 3):
        got = T_spmv.spmm_gse(ts, torch.from_numpy(x), tag)
        assert got.shape == (ts.shape[0], nrhs)
        np.testing.assert_array_equal(
            _bits(got.numpy()),
            _bits(T_spmv.spmm_gse(tg, torch.from_numpy(x), tag).numpy()))
        np.testing.assert_array_equal(
            _bits(got.numpy()),
            _bits(J_spmv.spmm_gse(js, jnp.asarray(x), tag=tag)))
    # Per-column tags and active flags: column j is B64 at tags[j], inactive
    # columns are 0.0.
    tags = torch.tensor([1, 2, 3, 1, 3][:nrhs], dtype=torch.int32)
    active = torch.tensor([True, False, True, True, True][:nrhs])
    y = T_c.gse_spmm_sell_f64(*ts.segments, ts.table,
                              torch.from_numpy(x.T.copy()), tags, active,
                              ts.bucket_table, ts.perm, ts.row_len,
                              rows=ts.shape[0], ei_bit=ts.ei_bit, device=CPU)
    for j in range(nrhs):
        want = (T_spmv.spmv_gse(ts, torch.from_numpy(x[:, j]), int(tags[j]))
                if active[j] else torch.zeros(ts.shape[0],
                                              dtype=torch.float64))
        assert torch.equal(y[j].view(torch.int64), want.view(torch.int64))


def test_decode_operand_gathers_the_csr_segments(packs):
    jg, tg, js, ts = packs
    for name, seg in zip(SEGMENTS, T_spmv._sell_csr_segments(ts)):
        assert torch.equal(seg, getattr(tg, name))
    for tag in (1, 2, 3):
        vs, cs = T_spmv.decode_operand(ts, tag)
        vg, cg = T_spmv.decode_operand(tg, tag)
        jv, jc = J_spmv.decode_operand(js, tag)
        assert torch.equal(vs.view(torch.int64), vg.view(torch.int64))
        assert torch.equal(cs, cg)
        np.testing.assert_array_equal(_bits(vs.numpy()), _bits(jv))
        np.testing.assert_array_equal(cs.numpy(), np.asarray(jc))


def test_b32_nonfinite_x_pattern_matches_the_reference(packs):
    """Padded slots read column 0, as the reference SELL kernel's do: with
    x[0] = inf the non-finite rows are the reference's (not spmv_gse's)."""
    jg, tg, js, ts = packs
    x = _x(ts.shape[1], 50, dtype=np.float32)
    x[0] = np.inf
    for tag in (1, 3):
        want = np.asarray(J_ops.gse_spmv_sell(js, jnp.asarray(x), tag=tag))
        got = T_ops.gse_spmv_sell(ts, torch.from_numpy(x), tag=tag).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=1e-4)
        # B64 never reads padded slots: only rows that hold column 0 go
        # non-finite, as in spmv_gse.
        y64 = T_spmv.spmv_gse(ts, torch.from_numpy(x.astype(np.float64)),
                              tag).numpy()
        np.testing.assert_array_equal(
            np.isfinite(y64), np.isfinite(np.asarray(J_spmv.spmv_gse(
                jg, jnp.asarray(x.astype(np.float64)), tag=tag))))
        assert (~np.isfinite(y64)).sum() < (~np.isfinite(got)).sum()


def test_wrappers_raise_off_the_cpu_and_on_bad_shapes(packs):
    _, tg, _, ts = packs
    x = torch.zeros(ts.shape[1], dtype=torch.float32)
    scales = T_ref.make_scales(ts.table, TAG_BITS_USED[1])
    with pytest.raises(ValueError, match="expected cuda"):
        T_ops.gse_spmm_sell(ts, x[:, None])
    with pytest.raises(ValueError, match="block"):
        T_ops.gse_spmm_sell(ts, x, device=CPU)
    with pytest.raises(TypeError, match="segment arrays"):
        T_ops.sell_kernel_for(2, ts.ei_bit)(
            *ts.segments[:2], x, scales, buckets=ts.bucket_table,
            perm=ts.perm, rows=ts.shape[0])
    with pytest.raises(ValueError, match="tag must be"):
        T_k.gse_spmv_sell_f32(*ts.segments, x, scales, ts.bucket_table,
                              ts.perm, rows=ts.shape[0], ei_bit=ts.ei_bit,
                              tag=4)
    with pytest.raises(ValueError, match="x has shape"):
        T_spmv.spmv_gse(ts, torch.zeros(3, dtype=torch.float64), 1)
