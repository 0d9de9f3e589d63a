"""The port's SpMV layer against the JAX reference: the f64 decode and
``spmv_gse`` (bitwise), the f32 ELL kernel's plain version against the
Pallas kernel in interpret mode (rtol 2e-5 / atol 1e-4, the tolerances
of tests/test_spmv_pipeline.py), the ELL pack, the pack cache, and the
oracles of ``kernels/ref.py``.

On the CPU every kernel wrapper runs its plain PyTorch version; the CUDA
kernels are held to those plain versions on the card by chip_smoke.py.
"""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels import ref as J_ref  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse import spmv as J_spmv  # noqa: E402

from repro_torch.core.precision_table import TAG_BITS_USED  # noqa: E402
from repro_torch.kernels import gse_spmv as T_k  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402
from repro_torch.sparse import spmv as T_spmv  # noqa: E402

MATRICES = {
    "spd_rs8_2k": lambda m, d: m.diag_rescale(
        m.random_spd(2000, seed=21, **d), 8.0, 21),
    "circuit_rs12_1k": lambda m, d: m.diag_rescale(
        m.circuit_like(1000, seed=24, **d), 24.0, 24),
    "poisson2d_16": lambda m, d: m.poisson2d(16, **d),
}


def _pair(name, k):
    a = MATRICES[name](J_gen, {})
    ta = MATRICES[name](T_gen, {"device": "cpu"})
    return a, J_csr.pack_csr(a, k=k), ta, T_csr.pack_csr(ta, k=k)


def _bits(v):
    return np.asarray(v).view(np.uint64)


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_f64_decode_and_spmv_gse_bitwise(name, k, tag):
    a, g, ta, tg = _pair(name, k)
    x = np.random.default_rng(tag).normal(size=a.shape[1])
    vj, cj = J_spmv.decode_gsecsr(g, tag)
    vt, ct = T_spmv.decode_gsecsr(tg, tag)
    assert vt.dtype == torch.float64
    assert np.array_equal(_bits(vt.numpy()), _bits(vj))
    assert np.array_equal(ct.numpy(), np.asarray(cj))
    vo, _ = T_spmv.decode_operand(tg, tag)
    assert torch.equal(vo, vt)
    yj = J_spmv.spmv_gse(g, jnp.asarray(x), tag=tag)
    yt = T_spmv.spmv_gse(tg, torch.from_numpy(x), tag)
    assert np.array_equal(_bits(yt.numpy()), _bits(yj))
    # A device-tag tensor (the solver loop's form) gives the same bits.
    tt = torch.tensor(tag, dtype=torch.int32)
    assert torch.equal(T_spmv.spmv_gse(tg, torch.from_numpy(x), tt), yt)


def test_spmv_gse_tag_is_clipped_like_the_reference_switch():
    _, _, _, tg = _pair("poisson2d_16", 8)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=tg.shape[1]))
    for raw, eff in ((0, 1), (-3, 1), (4, 3), (9, 3)):
        got = T_spmv.spmv_gse(tg, x, torch.tensor(raw, dtype=torch.int32))
        assert torch.equal(got, T_spmv.spmv_gse(tg, x, eff))


def test_a64_plain_never_reads_padding_like_spmv_gse():
    """x[0] = inf: the CSR walk spreads it only to rows that hold column 0
    (as ``spmv_gse``); the ELL kernel multiplies padded slots by x[0] and
    spreads it everywhere (as the Pallas kernel)."""
    a = J_gen.poisson2d(8)
    g = J_csr.pack_csr(a)
    tg = T_csr.pack_csr(T_gen.poisson2d(8, device="cpu"))
    x = np.ones(64)
    x[0] = np.inf
    want = ~np.isfinite(np.asarray(J_spmv.spmv_gse(g, jnp.asarray(x), tag=1)))
    got = ~np.isfinite(T_spmv.spmv_gse(tg, torch.from_numpy(x), 1).numpy())
    assert np.array_equal(got, want) and got.sum() == 3
    ell_j = J_ops.ell_pack_gsecsr(g)
    yj = J_ops.gse_spmv_ell(ell_j, g.table, jnp.asarray(x, jnp.float32),
                            g.ei_bit, tag=1)
    yt = T_ops.gse_spmv_ell(T_ops.ell_pack_gsecsr(tg), tg.table,
                            torch.from_numpy(x).float(), tg.ei_bit, tag=1)
    assert np.array_equal(~np.isfinite(yt.numpy()),
                          ~np.isfinite(np.asarray(yj)))
    assert (~np.isfinite(yt.numpy())).sum() == 64


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("k", [2, 8])
def test_a32_plain_matches_pallas_kernel(k, tag):
    a = J_gen.random_spd(500, seed=10 * k + tag)
    g = J_csr.pack_csr(a, k=k)
    tg = T_csr.pack_csr(T_gen.random_spd(500, seed=10 * k + tag,
                                         device="cpu"), k=k)
    x = np.random.default_rng(tag).normal(size=a.shape[1]).astype(np.float32)
    want = J_ops.gse_spmv_ell(J_ops.ell_pack_gsecsr(g, lane=128), g.table,
                              jnp.asarray(x), g.ei_bit, tag=tag)
    got = T_ops.gse_spmv_ell(T_ops.ell_pack_gsecsr(tg), tg.table,
                             torch.from_numpy(x), tg.ei_bit, tag=tag)
    assert got.dtype == torch.float32 and got.shape == (500,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-4)


@pytest.mark.parametrize("lane", [128, 256])
def test_ell_pack_matches_reference(lane):
    _, g, _, tg = _pair("circuit_rs12_1k", 8)
    want = J_ops.ell_pack_gsecsr(g, lane=lane)
    got = T_ops.ell_pack_gsecsr(tg, lane=lane)
    for w, t, dt in zip(want, got, (torch.uint32, torch.uint16, torch.uint16,
                                    torch.uint32)):
        assert t.dtype == dt
        assert np.array_equal(t.numpy(), np.asarray(w))


def test_spmv_kernel_for_takes_only_the_tag_segments():
    for tag, names in ((1, ["colpak", "head", "x", "scales"]),
                       (2, ["colpak", "head", "tail1", "x", "scales"]),
                       (3, ["colpak", "head", "tail1", "tail2", "x",
                            "scales"])):
        fn = T_ops.spmv_kernel_for(tag, 3)
        # The segments and vectors, then the rows' real slot counts and
        # the lanes a row runs on (a launch plan's ``lanes``).
        assert list(inspect.signature(fn).parameters) == names + [
            "row_len", "lanes"]
    with pytest.raises(ValueError):
        T_ops.spmv_kernel_for(4, 3)


def _cache_trace(ops, cached_pack, holder_cls):
    """Counter deltas of one hit/miss/evict/corrupt sequence."""
    stats = ops.PACK_STATS
    before = {k: int(stats[k]) for k in ("hits", "misses", "evictions",
                                         "corrupt")}
    a = holder_cls()
    extra = 3
    for i in range(ops.PACK_CACHE_MAX + extra):
        cached_pack(a, ("key", i), lambda i=i: (np.arange(4) + i,))
    oldest = ("key", extra)
    cached_pack(a, oldest, lambda: pytest.fail("hit must not rebuild"))
    cached_pack(a, ("key", 999), lambda: (np.arange(4),))
    assert oldest in a._pack_cache and ("key", extra + 1) not in a._pack_cache
    assert ("key", 0) not in a._pack_cache
    assert len(a._pack_cache) == ops.PACK_CACHE_MAX
    # Corrupt the cached array in place: the next hit detects and repacks.
    entry, _ = a._pack_cache[oldest]
    entry[0][0] ^= 1
    rebuilt = cached_pack(a, oldest, lambda: (np.arange(4) + extra,))
    assert np.array_equal(rebuilt[0], np.arange(4) + extra)
    cached_pack(a, oldest, lambda: pytest.fail("repacked entry is healthy"))
    return {k: int(stats[k]) - before[k] for k in before}


def test_pack_cache_counters_behave_as_reference():
    class Holder:
        pass

    assert T_ops.PACK_CACHE_MAX == J_ops.PACK_CACHE_MAX == 8
    want = _cache_trace(J_ops, J_ops._cached_pack, Holder)
    got = _cache_trace(T_ops, T_ops._cached_pack, Holder)
    assert got == want == {"hits": 2, "misses": 13, "evictions": 4,
                           "corrupt": 1}


def test_ell_pack_is_memoized_and_crc_checked():
    _, _, _, tg = _pair("poisson2d_16", 8)
    m0, h0 = T_ops.PACK_STATS["misses"], T_ops.PACK_STATS["hits"]
    e1 = T_ops.ell_pack_gsecsr(tg)
    e2 = T_ops.ell_pack_gsecsr(tg)
    assert all(x is y for x, y in zip(e1, e2))
    assert T_ops.PACK_STATS["misses"] == m0 + 1
    assert T_ops.PACK_STATS["hits"] == h0 + 1
    c0 = T_ops.PACK_STATS["corrupt"]
    e2[1].view(torch.int16)[0, 0] += 1  # corrupt the cached head in place
    e3 = T_ops.ell_pack_gsecsr(tg)
    assert T_ops.PACK_STATS["corrupt"] == c0 + 1
    assert e3[1] is not e2[1]


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_ref_oracles_match_reference(tag):
    _, g, _, tg = _pair("spd_rs8_2k", 8)
    for bits in (TAG_BITS_USED[tag], TAG_BITS_USED[tag] - g.ei_bit):
        sj = J_ref.make_scales(g.table, bits)
        st = T_ref.make_scales(tg.table, bits)
        assert st.dtype == torch.float32
        assert np.array_equal(st.numpy(), np.asarray(sj))
    dj = J_ref.decode_csr_ref(g.colpak, g.head, g.tail1, g.tail2, g.table,
                              g.ei_bit, tag)
    dt = T_ref.decode_csr_ref(tg.colpak, tg.head, tg.tail1, tg.tail2,
                              tg.table, tg.ei_bit, tag)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=0)
    ell_j = J_ops.ell_pack_gsecsr(g)
    ell_t = T_ops.ell_pack_gsecsr(tg)
    x = np.random.default_rng(3).normal(size=g.shape[1]).astype(np.float32)
    yj = J_ref.spmv_ell_ref(*ell_j, g.table, jnp.asarray(x), g.ei_bit, tag)
    yt = T_ref.spmv_ell_ref(*ell_t, tg.table, torch.from_numpy(x), tg.ei_bit,
                            tag)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5,
                               atol=1e-4)


@pytest.mark.parametrize("store", ["f64", "f32", "bf16"])
def test_fixed_dtype_baselines_match_reference(store):
    a, _, ta, _ = _pair("spd_rs8_2k", 8)
    sj, st = {"f64": (jnp.float64, torch.float64),
              "f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[store]
    x = np.random.default_rng(5).normal(size=a.shape[1])
    yj = J_spmv.spmv(a, jnp.asarray(x), store_dtype=sj)
    yt = T_spmv.spmv(ta, torch.from_numpy(x), store_dtype=st)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12,
                               atol=1e-12)
    cols, vals, _ = T_csr.to_ell(ta)
    ye = T_spmv.spmv_ell(torch.from_numpy(cols), torch.from_numpy(vals),
                         torch.from_numpy(x))
    yje = J_spmv.spmv_ell(jnp.asarray(cols), jnp.asarray(vals),
                          jnp.asarray(x))
    np.testing.assert_allclose(ye.numpy(), np.asarray(yje), rtol=1e-12,
                               atol=1e-12)


def test_wrappers_launch_or_raise_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device never
    falls back to the plain version."""
    _, _, _, tg = _pair("poisson2d_16", 8)
    meta = {n: getattr(tg, n).to("meta") for n in
            ("rowptr", "colpak", "head", "tail1", "tail2", "table")}
    x = torch.zeros(tg.shape[1], dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        T_k.gse_spmv_csr_f64(meta["rowptr"], meta["colpak"], meta["head"],
                             meta["tail1"], meta["tail2"], meta["table"], x,
                             ei_bit=tg.ei_bit, tag=1)
    cp = torch.zeros((4, 128), dtype=torch.uint32, device="meta")
    hd = torch.zeros((4, 128), dtype=torch.uint16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        T_k.gse_spmv_ell_f32(cp, hd, None, None, x.float(),
                             torch.ones(8, device="meta"), ei_bit=3, tag=1)
    with pytest.raises(ValueError, match="tag must be"):
        T_k.gse_spmv_ell_f32(cp, hd, None, None, x.float(),
                             torch.ones(8, device="meta"), ei_bit=3, tag=0)
