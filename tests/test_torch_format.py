"""The port's GSE-SEM format against the JAX reference: generators, packer
tables and segments, byte models, and the dense pack/decode round trip.

Inputs come from the same numpy seeds on both sides; every comparison
here is bitwise (the host packers are numpy on both sides).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import gse as J_gse  # noqa: E402
from repro.core import precision_table as J_pt  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402

from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.core import precision_table as T_pt  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402

SUITES = ("cg_suite", "gmres_suite", "spmv_suite")


@functools.lru_cache(maxsize=None)
def _suite(name: str, side: str):
    if side == "jax":
        return getattr(J_gen, name)(small=True)
    return getattr(T_gen, name)(small=True, device="cpu")


_CG = ("mass_diag_3k", "poisson2d_32", "poisson2d_64", "poisson3d_12",
       "random_spd_5k", "random_spd_wide_2k", "spd_rs8_2k", "spd_overflow_2k")
_GMRES = ("convdiff_32", "convdiff_48_b50", "circuit_2k", "circuit_5k",
          "convdiff_64", "convdiff_rs4_32", "circuit_rs12_2k")
# Matrix names per suite, fixed here so collection builds no matrix;
# test_suite_keys_match_reference pins them to the reference suites.
KEYS = {"cg_suite": _CG, "gmres_suite": _GMRES,
        "spmv_suite": _CG + ("circuit_spd_4k",) + _GMRES}
CASES = [(suite, key) for suite in SUITES for key in KEYS[suite]]


@pytest.mark.parametrize("suite", SUITES)
def test_suite_keys_match_reference(suite):
    want = {k for k, v in _suite(suite, "jax").items() if v is not None}
    got = {k for k, v in _suite(suite, "torch").items() if v is not None}
    assert got == want == set(KEYS[suite])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("suite,key", CASES)
def test_pack_csr_bitwise_and_byte_model(suite, key):
    a = _suite(suite, "jax")[key]
    ta = _suite(suite, "torch")[key]
    assert ta.shape == a.shape
    for name in ("rowptr", "col", "row_ids"):
        assert np.array_equal(_np(getattr(ta, name)), _np(getattr(a, name))), name
    assert np.array_equal(_np(ta.val).view(np.uint64),
                          _np(a.val).view(np.uint64))

    g = J_csr.pack_csr(a, k=8)
    tg = T_csr.pack_csr(ta, k=8)
    assert tg.ei_bit == g.ei_bit and tg.shape == g.shape
    for name, dtype in (("colpak", torch.uint32), ("head", torch.uint16),
                        ("tail1", torch.uint16), ("tail2", torch.uint32),
                        ("table", torch.int32), ("rowptr", torch.int32),
                        ("row_ids", torch.int32)):
        t = getattr(tg, name)
        assert t.dtype == dtype, name
        assert np.array_equal(_np(t), _np(getattr(g, name))), name

    for tag in (1, 2, 3):
        assert tg.bytes_per_nnz(tag) == g.bytes_per_nnz(tag)
        assert tg.bytes_touched(tag) == g.bytes_touched(tag)
        assert tg.nbytes(tag) == g.nbytes(tag)
        for nrhs in (1, 3):
            assert (T_csr.iteration_stream_bytes(tg, tag, nrhs=nrhs)
                    == J_csr.iteration_stream_bytes(g, tag, nrhs=nrhs))
    assert T_csr.vector_stream_bytes(tg) == J_csr.vector_stream_bytes(g)
    for st, sj in ((torch.float64, jnp.float64), (torch.float32, jnp.float32),
                   (torch.bfloat16, jnp.bfloat16)):
        assert ta.bytes_touched(st) == a.bytes_touched(sj)
        assert T_csr.iteration_stream_bytes(ta, st) == \
            J_csr.iteration_stream_bytes(a, sj)


@pytest.mark.parametrize("k", [2, 5, 8, 16])
def test_dense_pack_decode_round_trip(k):
    rng = np.random.default_rng(0)
    vals = rng.normal(size=4096) * np.exp2(rng.integers(-2, 3, 4096))
    vals[::97] = 0.0
    p = J_gse.pack(vals, k=k)
    tp = T_gse.pack(vals, k=k, device="cpu")
    assert tp.ei_bit == p.ei_bit and tp.frac_bits == p.frac_bits
    assert tp.shape == p.shape
    for name in ("table", "head", "tail1", "tail2"):
        assert np.array_equal(_np(getattr(tp, name)), _np(getattr(p, name)))
    for tag in (1, 2, 3):
        assert tp.nbytes(tag) == p.nbytes(tag)
        assert tp.bytes_touched(tag) == p.bytes_touched(tag)
        got = T_gse.decode(tp, tag)
        want = J_gse.decode(p, tag)
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy().view(np.uint64),
                              np.asarray(want).view(np.uint64))
    rel = np.abs(T_gse.decode(tp, 3).numpy() - vals) / np.maximum(
        np.abs(vals), 1e-300)
    assert rel.max() < 2.0**-40


def test_pack_with_stale_table_saturates_like_reference():
    table = J_gse.extract_shared_exponents(np.array([1.0, 2.0, 0.5]), 4)
    vals = np.array([1.0, 3.0e9, -7.5, 1e-300])
    p = J_gse.pack_with_table(vals, table, 4)
    tp = T_gse.pack_with_table(vals, table, 4, device="cpu")
    for name in ("head", "tail1", "tail2"):
        assert np.array_equal(_np(getattr(tp, name)), _np(getattr(p, name)))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_pow2_exact_matches_reference(dtype):
    n = np.arange(-1200, 1200, 7, dtype=np.int32)
    td, jd = {"f64": (torch.float64, jnp.float64),
              "f32": (torch.float32, jnp.float32)}[dtype]
    got = T_gse._pow2_exact(torch.from_numpy(n), td).numpy()
    want = np.asarray(J_gse._pow2_exact(jnp.asarray(n), jd))
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_precision_table_matches_reference():
    for name in T_pt.__all__:
        if name == "tag_operand_names":
            for t in T_pt.TAGS:
                assert T_pt.tag_operand_names(t) == J_pt.tag_operand_names(t)
        else:
            assert getattr(T_pt, name) == getattr(J_pt, name), name
    assert [T_pt.SLOT_BYTES[t] for t in (1, 2, 3)] == [6, 8, 12]


def test_to_ell_and_scatter_rows_match_reference():
    a = J_gen.skewed_spd(256, seed=3)
    ta = T_gen.skewed_spd(256, seed=3, device="cpu")
    cols, vals, L = J_csr.to_ell(a, lane=128)
    tcols, tvals, tL = T_csr.to_ell(ta, lane=128)
    assert tL == L
    assert np.array_equal(tcols, cols) and np.array_equal(tvals, vals)
    subset = np.array([5, -1, 0, 17])
    want = J_csr.scatter_rows(a.rowptr, [(a.col, np.int32)], L, subset)
    got = T_csr.scatter_rows(ta.rowptr, [(ta.col, np.int32)], L, subset)
    for w, g in zip(want, got):
        if isinstance(w, list):
            assert all(np.array_equal(x, y) for x, y in zip(w, g))
        else:
            assert np.array_equal(w, g)


def test_from_coo_sums_duplicates_like_reference():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 30, 400)
    cols = rng.integers(0, 20, 400)
    vals = rng.normal(size=400)
    a = J_csr.from_coo(rows, cols, vals, (30, 20))
    ta = T_csr.from_coo(rows, cols, vals, (30, 20), device="cpu")
    for name in ("rowptr", "col", "row_ids"):
        assert np.array_equal(_np(getattr(ta, name)), _np(getattr(a, name)))
    assert np.array_equal(_np(ta.val), _np(a.val))


def test_pack_csr_rejects_wide_columns():
    ta = T_csr.from_coo([0], [(1 << 29) + 3], [1.0], (1, (1 << 29) + 4),
                        device="cpu")
    with pytest.raises(ValueError, match="needs >"):
        T_csr.pack_csr(ta, k=8)
