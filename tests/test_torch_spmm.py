"""The port's SpMM layer (kernel C) and column-batched vector kernels
against the JAX reference.

On the CPU every kernel wrapper runs its plain PyTorch version when the
caller asks for the CPU: C32's against the Pallas SpMM kernel in
interpret mode (rtol 2e-5 / atol 1e-4, the tolerances of
tests/test_spmm.py) and bitwise against A32's at nrhs = 1; C64's column j
bitwise against ``spmv_gse`` and the reference's ``spmm_gse``; the
column-batched dot and update bitwise against the jitted ``jnp.vdot`` and
``x + a * p`` per column; the port's norm bitwise against the jitted
``jnp.linalg.norm``.  chip_smoke.py holds the CUDA kernels to these plain
versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as J_ops  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse import spmv as J_spmv  # noqa: E402

from repro_torch.kernels import gse_spmm as T_c  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import vec_f64 as V  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402
from repro_torch.sparse import spmv as T_spmv  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solver loops run thousands of tiny CPU ops: one intra-op thread
    is faster than a pool and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(n=300, seed=7, k=8):
    a = J_gen.diag_rescale(J_gen.random_spd(n, seed=seed), 8.0, seed)
    ta = T_gen.diag_rescale(T_gen.random_spd(n, seed=seed, device=CPU), 8.0,
                            seed)
    return a, J_csr.pack_csr(a, k=k), ta, T_csr.pack_csr(ta, k=k)


def _bits(v):
    return np.asarray(v, dtype=np.float64).view(np.uint64)


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("nrhs", [1, 2, 5])
def test_c32_plain_matches_pallas_spmm(nrhs, tag):
    a = J_gen.random_spd(500, seed=10 + tag)
    g = J_csr.pack_csr(a, k=8)
    tg = T_csr.pack_csr(T_gen.random_spd(500, seed=10 + tag, device=CPU))
    x = np.random.default_rng(tag).normal(size=(500, nrhs)).astype(np.float32)
    want = J_ops.gse_spmm_ell(J_ops.ell_pack_gsecsr(g, lane=128), g.table,
                              jnp.asarray(x), g.ei_bit, tag=tag)
    got = T_ops.gse_spmm_ell(T_ops.ell_pack_gsecsr(tg), tg.table,
                             torch.from_numpy(x), tg.ei_bit, tag=tag,
                             device=CPU)
    assert got.dtype == torch.float32 and got.shape == (500, nrhs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=1e-4)


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_c32_at_one_column_is_bitwise_a32(tag):
    _, _, _, tg = _pair()
    ell = T_ops.ell_pack_gsecsr(tg)
    x = torch.from_numpy(
        np.random.default_rng(tag).normal(size=(300, 1)).astype(np.float32))
    y1 = T_ops.gse_spmm_ell(ell, tg.table, x, tg.ei_bit, tag=tag, device=CPU)
    yv = T_ops.gse_spmv_ell(ell, tg.table, x[:, 0], tg.ei_bit, tag=tag)
    assert torch.equal(y1[:, 0].view(torch.int32), yv.view(torch.int32))


def test_c64_plain_columns_are_spmv_gse_at_mixed_tags():
    a, g, _, tg = _pair()
    x = np.random.default_rng(1).normal(size=(5, 300))
    tags = [1, 2, 3, 2, 1]
    y = T_c.gse_spmm_csr_f64(
        tg.rowptr, tg.colpak, tg.head, tg.tail1, tg.tail2, tg.table,
        torch.from_numpy(x), torch.tensor(tags, dtype=torch.int32),
        torch.ones(5, dtype=torch.bool), ei_bit=tg.ei_bit, device=CPU)
    assert y.shape == (5, 300) and y.dtype == torch.float64
    for j, t in enumerate(tags):
        solo = T_spmv.spmv_gse(tg, torch.from_numpy(x[j]), t)
        assert np.array_equal(_bits(y[j].numpy()), _bits(solo.numpy()))
        ref = J_spmv.spmm_gse(g, jnp.asarray(x.T), tag=t)
        assert np.array_equal(_bits(y[j].numpy()), _bits(ref[:, j]))


def test_c64_skips_inactive_columns_and_clips_tags():
    _, _, _, tg = _pair()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 300)))
    segs = (tg.rowptr, tg.colpak, tg.head, tg.tail1, tg.tail2, tg.table)
    y = T_c.gse_spmm_csr_f64(*segs, x, torch.tensor([0, 9, 2, 3],
                                                   dtype=torch.int32),
                             torch.tensor([True, True, False, True]),
                             ei_bit=tg.ei_bit, device=CPU)
    assert torch.equal(y[0], T_spmv.spmv_gse(tg, x[0], 1))
    assert torch.equal(y[1], T_spmv.spmv_gse(tg, x[1], 3))
    assert bool((y[2] == 0).all())
    assert torch.equal(y[3], T_spmv.spmv_gse(tg, x[3], 3))


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_spmm_gse_matches_reference_bitwise(tag):
    a, g, _, tg = _pair(seed=11)
    x = np.random.default_rng(tag).normal(size=(300, 4))
    want = J_spmv.spmm_gse(g, jnp.asarray(x), tag=tag)
    got = T_spmv.spmm_gse(tg, torch.from_numpy(x), tag)
    assert got.shape == (300, 4)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    per_col = T_spmv.spmm_gse(tg, torch.from_numpy(x),
                              torch.tensor([tag] * 4, dtype=torch.int32))
    assert torch.equal(per_col, got)


@pytest.mark.parametrize("store", ["f64", "f32"])
def test_spmm_baseline_matches_reference(store):
    a, _, ta, _ = _pair()
    sj, st = {"f64": (jnp.float64, torch.float64),
              "f32": (jnp.float32, torch.float32)}[store]
    x = np.random.default_rng(5).normal(size=(300, 3))
    want = J_spmv.spmm(a, jnp.asarray(x), store_dtype=sj)
    got = T_spmv.spmm(ta, torch.from_numpy(x), store_dtype=st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    for j in range(3):
        assert torch.equal(got[:, j],
                           T_spmv.spmv(ta, torch.from_numpy(x[:, j]),
                                       store_dtype=st))


def test_spmm_rejects_bad_operands():
    _, _, ta, tg = _pair()
    with pytest.raises(ValueError, match="block"):
        T_spmv.spmm_gse(tg, torch.zeros(300, dtype=torch.float64))
    with pytest.raises(ValueError, match="rows"):
        T_spmv.spmm_gse(tg, torch.zeros(299, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="block"):
        T_spmv.spmm(ta, torch.zeros(300, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="item 15"):
        T_spmv.spmm_gse(object(), torch.zeros(300, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="block"):
        T_ops.gse_spmm_ell(T_ops.ell_pack_gsecsr(tg), tg.table,
                           torch.zeros(300), tg.ei_bit, device=CPU)


_vdot = jax.jit(jnp.vdot)
_axpy = jax.jit(lambda x, a, p: x + a * p)
_norm = jax.jit(jnp.linalg.norm)


@pytest.mark.parametrize("n", [1, 9, 37, 2001])
def test_seq_dot_cols_plain_is_jitted_vdot_per_column(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(4, n)) * np.exp(rng.normal(size=(4, n)))
    b = rng.normal(size=(4, n))
    active = torch.tensor([True, False, True, True])
    got = V.seq_dot_cols(torch.from_numpy(a), torch.from_numpy(b), active,
                         device=CPU)
    assert got.shape == (4,) and got.dtype == torch.float64
    for j in range(4):
        want = float(_vdot(jnp.asarray(a[j]), jnp.asarray(b[j]))) \
            if bool(active[j]) else 0.0
        assert _bits(got[j].item()) == _bits(want)
    every = V.seq_dot_cols(torch.from_numpy(a), torch.from_numpy(a),
                           device=CPU)
    for j in range(4):
        assert _bits(every[j].item()) == _bits(
            _vdot(jnp.asarray(a[j]), jnp.asarray(a[j])))


@pytest.mark.parametrize("n", [1, 37, 2001])
def test_fma_axpy_cols_plain_is_jitted_update_per_column(n):
    rng = np.random.default_rng(n + 1)
    x = rng.normal(size=(3, n))
    p = rng.normal(size=(3, n)) * np.exp(rng.normal(size=(3, n)))
    alpha = rng.normal(size=3)
    got = V.fma_axpy_cols(torch.from_numpy(alpha), torch.from_numpy(p),
                          torch.from_numpy(x), device=CPU)
    for j in range(3):
        want = _axpy(jnp.asarray(x[j]), alpha[j], jnp.asarray(p[j]))
        assert np.array_equal(_bits(got[j].numpy()), _bits(want))
        solo = V.fma_axpy(torch.tensor(alpha[j]), torch.from_numpy(p[j]),
                          torch.from_numpy(x[j]))
        assert torch.equal(got[j], solo)


@pytest.mark.parametrize("n", [1, 7, 32, 33, 400, 1025, 2000])
def test_ref_norm_cols_is_jitted_linalg_norm(n):
    rng = np.random.default_rng(n + 2)
    v = rng.normal(size=(5, n)) * np.exp(3 * rng.normal(size=(5, n)))
    got = V.ref_norm_cols(torch.from_numpy(v), device=CPU)
    for j in range(5):
        assert _bits(got[j].item()) == _bits(_norm(jnp.asarray(v[j])))


def test_column_wrappers_run_where_asked_and_count_no_cpu_launch():
    """The column wrappers default to the card: CPU tensors run the plain
    version only when the caller asks for the CPU, and never count a
    launch."""
    _, _, _, tg = _pair()
    x = torch.zeros(2, 300, dtype=torch.float64)
    segs = (tg.rowptr, tg.colpak, tg.head, tg.tail1, tg.tail2, tg.table)
    tags = torch.ones(2, dtype=torch.int32)
    on = torch.ones(2, dtype=torch.bool)
    T_c.reset_launch_counts()
    V.reset_launch_counts()
    with pytest.raises(ValueError, match="expected cuda"):
        T_c.gse_spmm_csr_f64(*segs, x, tags, on, ei_bit=tg.ei_bit)
    with pytest.raises(ValueError, match="expected cuda"):
        V.seq_dot_cols(x, x)
    with pytest.raises(ValueError, match="expected cuda"):
        V.fma_axpy_cols(torch.zeros(2, dtype=torch.float64), x, x)
    ell = T_ops.ell_pack_gsecsr(tg)
    with pytest.raises(ValueError, match="expected cuda"):
        T_ops.gse_spmm_ell(ell, tg.table, torch.zeros(300, 2), tg.ei_bit)
    T_c.gse_spmm_csr_f64(*segs, x, tags, on, ei_bit=tg.ei_bit, device=CPU)
    T_ops.gse_spmm_ell(ell, tg.table, torch.zeros(300, 2), tg.ei_bit,
                       device=CPU)
    V.seq_dot_cols(x, x, device=CPU)
    V.fma_axpy_cols(torch.zeros(2, dtype=torch.float64), x, x, device=CPU)
    assert all(k.launches == 0 for k in (*T_c.KERNELS, *V.KERNELS))
    meta = torch.zeros(2, 300, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        V.seq_dot_cols(meta, meta, device="meta")
