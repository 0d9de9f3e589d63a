"""Kernel E's tiled body and B64's long-row plan, as the CPU can check them.

E's tiled body (M > 8, prefill) multiplies on the TF32 tensor cores: each
decoded weight is split into two TF32 terms, ``hi = tf32(w)`` and ``lo =
tf32(w - hi)``, an f32 x into two as well (a bf16 x is exact in TF32),
and the MMA partial of every ``SUM_K`` rows of K joins an f32 sum with
round to nearest, in K order.  These tests hold the TF32 rounding (done
by bit operations in the kernel and in :func:`_tf32_round`) to a numpy
model of round-to-nearest, ties away from zero, and hold a torch
emulation of the body's arithmetic (:func:`_tiled_emulated`)
to the plain version and to the reference's Pallas kernel in interpret
mode, within E's tolerance (rtol 1e-5 / atol 1e-4).  B64 runs the rows of
its widest buckets with a block each (the pack's ``long_from``), whose one
adding thread takes each chunk of products in full, +0.0 past the row's
end; a numpy model of that chunked chain is bitwise the plain version.
``chip_smoke.py`` phases 7, 9 and 11 hold the CUDA bodies to the plain
versions on the card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gse as J_gse  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402

from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.core.precision_table import TAG_BITS_USED  # noqa: E402
from repro_torch.kernels import gse_matmul as T_e  # noqa: E402
from repro_torch.kernels import gse_spmv as T_k  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402
from repro_torch.kernels.gse_decode import gse_decode_dense_plain  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse.csr import pack_csr  # noqa: E402
from repro_torch.sparse.spmv import decode_gsecsr, spmv_gse  # noqa: E402

CPU = "cpu"
CHAIN_CHUNK = 1024  # block_chain_f64's products per chunk (gse_rows.cuh)


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to TF32 as the tiled body rounds it: the
    significand to 10 explicit bits, to nearest with ties away from zero,
    the 13 low bits cleared (finite values)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def _tiled_emulated(x, w, plan=None) -> torch.Tensor:
    """The tiled body's arithmetic on the CPU, for an ``(M, K)`` x (f32 or
    bf16) and a decoded ``(K, N)`` f32 w: w and an f32 x split into TF32
    terms (:func:`_tf32_round`), each ``SUM_K`` rows of K summed from
    their exact products (in f64: the card's MMAs add them in f32 with
    truncation, which a partial of a few products keeps near an ulp), the
    partial rounded to f32 and added into the split's f32 sum with round
    to nearest, in K order; then the splits of ``plan`` (default:
    ``tiled_plan``) added in order."""
    w = w.to(torch.float32)
    w_hi = _tf32_round(w)
    w_lo = _tf32_round(w - w_hi)
    x32 = x.to(torch.float32)
    if x.dtype == torch.bfloat16:
        terms = ((x32, w_lo), (x32, w_hi))
    else:
        x_hi = _tf32_round(x32)
        x_lo = _tf32_round(x32 - x_hi)
        terms = ((x_lo, w_hi), (x_hi, w_lo), (x_hi, w_hi))
    kk = w.shape[0]
    if plan is None:
        plan = T_e.tiled_plan(x.shape[0], kk, w.shape[1])
    y = None
    for s0, s1 in plan.ranges(kk):
        acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
        for k0 in range(s0, s1, T_e.SUM_K):
            ks = slice(k0, min(k0 + T_e.SUM_K, s1))
            part = sum(a[:, ks].double() @ b[ks].double() for a, b in terms)
            acc = acc + part.to(torch.float32)
        y = acc if y is None else y + acc
    return y


def _tf32_model(v: np.ndarray) -> np.ndarray:
    """f32 values rounded to 10 explicit significand bits, to nearest with
    ties away from zero, in f64 arithmetic (exact for these widths)."""
    v = v.astype(np.float64)
    mant, exp = np.frexp(v)  # v = mant * 2^exp, 0.5 <= |mant| < 1
    scaled = np.abs(mant) * 2.0 ** 11  # 11 significant bits left of the point
    rounded = np.floor(scaled + 0.5)  # halves go up: away from zero
    return (np.sign(v) * rounded * 2.0 ** (exp - 11)).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.0, 1e30])
def test_tf32_round_is_nearest_ties_away(scale):
    rng = np.random.default_rng(int(math.log10(scale)) + 40)
    v = (rng.standard_normal(4096) * scale).astype(np.float32)
    # Exact ties: 13 dropped bits of 1000000000000 (binary).
    bits = v.view(np.uint32)
    ties = ((bits[:512] & np.uint32(0xFFFFE000)) | np.uint32(0x1000))
    v = np.concatenate([v, ties.view(np.float32), [0.0, -0.0]]).astype(
        np.float32)
    got = _tf32_round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, _tf32_model(v))
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_term_split_is_exact_to_2_pow_minus_22(seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal(20000)
                          * 10.0 ** rng.uniform(-6, 6, 20000))
                         .astype(np.float32))
    hi = _tf32_round(w)
    lo = _tf32_round(w - hi)
    rest = (w.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0 ** -22 * w.double().abs()).all())
    # w - hi is exact in f32: the split loses nothing before lo's rounding.
    assert torch.equal((w - hi).double(), w.double() - hi.double())


def _pack_pair(kk, n, seed):
    vals = np.random.default_rng(seed).normal(size=(kk, n)) / math.sqrt(kk)
    return J_gse.pack(vals, 8), T_gse.pack(vals, 8, device=CPU)


@pytest.mark.parametrize("mkn", [(130, 200, 70), (37, 301, 45),
                                 (9, 1001, 33), (256, 64, 136)])
@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_tiled_emulation_matches_plain_and_the_pallas_kernel(mkn, tag,
                                                              xdtype):
    m, kk, n = mkn
    rng = np.random.default_rng(m + kk + n)
    x = torch.from_numpy(rng.normal(size=(m, kk)).astype(np.float32)).to(
        getattr(torch, xdtype))
    jp, tp = _pack_pair(kk, n, seed=n + tag)
    scales = T_ref.make_scales(tp.table, TAG_BITS_USED[tag] - tp.ei_bit)
    segs = (tp.head, tp.tail1 if tag >= 2 else None,
            tp.tail2 if tag == 3 else None, scales)
    w = gse_decode_dense_plain(*segs, ei_bit=tp.ei_bit, tag=tag)
    got = _tiled_emulated(x, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, _tiled_emulated(x, w))
    plain = T_e.gse_matmul_dense(x, *segs, ei_bit=tp.ei_bit, tag=tag,
                                 device=CPU)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-4)
    want = J_ops.gse_matmul(jnp.asarray(x.float().numpy()), jp, tag=tag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_tiled_emulation_keeps_more_than_one_tf32_term():
    """One TF32 term of w would miss E's tolerance at K = 9728 (w_down);
    the split keeps it (the reason for two terms)."""
    kk, n, m = 9728, 16, 16
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(kk, n)) / math.sqrt(kk))
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(m, kk)).astype(np.float32)).to(
        torch.bfloat16)
    exact = x.double() @ w.double()
    one_term = x.double() @ _tf32_round(w).double()
    two_terms = _tiled_emulated(x, w).double()
    tol = 1e-4 + 1e-5 * exact.abs()
    assert bool(((one_term - exact).abs() > tol).any())
    assert bool(((two_terms - exact).abs() <= tol / 10).all())


def _prefill_shapes():
    """(K, N) of every linear of a qwen3_4b layer."""
    return {"wq": (2560, 4096), "wk/wv": (2560, 1024), "wo": (4096, 2560),
            "w_gate/w_up": (2560, 9728), "w_down": (9728, 2560)}


def _check_splits(plan, k):
    ranges = list(plan.ranges(k))
    assert len(ranges) == plan.splits and ranges[0][0] == 0
    assert ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 < k1 for k0, k1 in ranges)
    if plan.splits > 1:
        assert plan.rows % T_e.SUM_K == 0 and plan.rows >= 4 * T_e.SUM_K


@pytest.mark.parametrize("name", sorted(_prefill_shapes()))
@pytest.mark.parametrize("m", [256, 2048])
def test_tiled_plan_fills_the_h100_on_qwen3_4b(name, m):
    k, n = _prefill_shapes()[name]
    plan = T_e.tiled_plan(m, k, n)
    _check_splits(plan, k)
    assert plan.tiles == math.ceil(m / 128) * math.ceil(n / 128)
    waves = math.ceil(plan.blocks / T_e.H100_SMS)
    fill = plan.blocks / (waves * T_e.H100_SMS)
    if m == 2048:
        # Split only where one split fills the waves poorly: the N = 2560
        # linears (wo, w_down: 320 tiles, 2.4 waves).
        assert fill >= T_e.TILED_FILL
        assert plan.splits == (2 if n == 2560 else 1)
    else:
        # The f32 twin's M 256: at most 152 tiles, so every linear splits.
        assert plan.splits > 1 and plan.blocks <= 5 * T_e.H100_SMS


@pytest.mark.parametrize("mkn", [(9, 100, 10), (300, 1001, 999),
                                 (4096, 256, 8), (17, 70000, 3)])
@pytest.mark.parametrize("sms", [132, 3])
def test_tiled_plan_covers_ragged_shapes(mkn, sms):
    m, k, n = mkn
    _check_splits(T_e.tiled_plan(m, k, n, sms), k)


def test_tiled_plan_rejects_gemv_rows_and_empty_shapes():
    for m, k, n in ((8, 10, 10), (9, 0, 10), (9, 10, 0)):
        with pytest.raises(ValueError):
            T_e.tiled_plan(m, k, n)


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_tiled_emulation_with_k_splits_matches_plain(tag):
    m, kk, n = 300, 1001, 99
    plan = T_e.tiled_plan(m, kk, n)
    assert plan.splits == 4
    rng = np.random.default_rng(tag)
    x = torch.from_numpy(rng.normal(size=(m, kk)).astype(np.float32)).to(
        torch.bfloat16)
    _, tp = _pack_pair(kk, n, seed=tag)
    scales = T_ref.make_scales(tp.table, TAG_BITS_USED[tag] - tp.ei_bit)
    segs = (tp.head, tp.tail1 if tag >= 2 else None,
            tp.tail2 if tag == 3 else None, scales)
    w = gse_decode_dense_plain(*segs, ei_bit=tp.ei_bit, tag=tag)
    got = _tiled_emulated(x, w, plan)
    one = _tiled_emulated(x, w, T_e.TiledPlan(plan.tiles, 1, kk))
    plain = T_e.gse_matmul_dense(x, *segs, ei_bit=tp.ei_bit, tag=tag,
                                 device=CPU)
    for y in (got, one):
        np.testing.assert_allclose(y.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_tiled_terms_by_x_dtype():
    assert T_e.tiled_terms(torch.bfloat16) == 2
    assert T_e.tiled_terms(torch.float32) == 3


def test_tiled_vector_loads_need_k_and_n_multiples_of_8_and_alignment():
    head = torch.zeros(4096, dtype=torch.uint16)
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    assert T_e.tiled_vec_ok(x, 16, head, None, None)
    assert not T_e.tiled_vec_ok(x, 12, head, None, None)  # N % 8
    assert not T_e.tiled_vec_ok(x[:, :60], 16, head, None, None)  # K % 8
    assert not T_e.tiled_vec_ok(x, 16, head[4:], None, None)  # 8 bytes in
    flat = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    assert not T_e.tiled_vec_ok(flat[4:4 + 256].view(4, 64), 16, head, None,
                                None)  # x 8 bytes in
    assert T_e.tiled_vec_ok(flat[8:8 + 256].view(4, 64), 16, head[8:],
                            head[16:], None)


# --- B64: the long-row plan ---------------------------------------------------

def test_sell_long_from_picks_the_widest_buckets():
    w = T_csr.B64_BLOCK_WIDTH  # 4096: chip_smoke.py's width sweep
    assert w == 4096
    assert T_csr.sell_long_from((128, 256, 262144), (259992, 2144, 8)) == \
        259992 + 2144
    assert T_csr.sell_long_from((128, 256), (30, 2)) == 32  # none is long
    assert T_csr.sell_long_from((w, 2 * w), (8, 8)) == 0  # all are
    assert T_csr.sell_long_from((128, w - 1), (8, 8)) == 16  # w is long
    assert T_csr.sell_long_from((128, w), (8, 8)) == 8
    assert T_csr.sell_long_from((2048, w), (8, 8)) == 8  # 2048 is not
    assert T_csr.sell_long_from((), ()) == 0


def test_sell_long_from_needs_ascending_widths():
    with pytest.raises(ValueError):
        T_csr.sell_long_from((256, 128), (8, 8))
    with pytest.raises(ValueError):
        T_csr.sell_long_from((128, 256), (8,))


@pytest.fixture(scope="module")
def skewed():
    """skewed_spd(8192, seed=0) at k = 8 and its SELL pack: eight rows of
    its 8192-wide bucket run a block each."""
    g = pack_csr(T_gen.skewed_spd(8192, seed=0, device=CPU))
    return g, T_ops.sell_pack_gsecsr(g)


def test_skewed_pack_runs_its_hub_rows_as_blocks(skewed):
    g, sell = skewed
    long_from = sell.long_from
    assert long_from == T_csr.sell_long_from(sell.widths, sell.bucket_rows)
    rows_pad = sell.perm.shape[0]
    assert sell.widths[-1] >= T_csr.B64_BLOCK_WIDTH > sell.widths[-2]
    assert rows_pad - long_from == sell.bucket_rows[-1] > 0
    lens = sell.row_len[long_from:]
    assert int(lens.max()) > CHAIN_CHUNK  # several chunks per hub row


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_chunked_block_chain_is_bitwise_the_plain_row_sum(skewed, tag):
    """block_chain_f64's order: products in slot order, each chunk of
    CHAIN_CHUNK added in full from 0.0 with +0.0 past the row's end; as a
    left fold in f64 (np.add.accumulate) it is bitwise the plain B64 and
    A64 on the hub rows."""
    g, sell = skewed
    x = torch.from_numpy(np.random.default_rng(tag).normal(size=8192))
    long_from = sell.long_from
    plain = T_k.gse_spmv_sell_f64(
        *sell.segments, g.table, x, sell.bucket_table, sell.perm,
        sell.row_len, rows=8192, ei_bit=g.ei_bit, tag=tag,
        long_from=long_from)
    a64 = spmv_gse(g, x, tag)
    rowptr = g.rowptr.numpy()
    vals, cols = decode_gsecsr(g, tag)
    prod = (vals * x[cols]).numpy()
    for r in range(long_from, sell.perm.shape[0]):
        dst = int(sell.perm[r])
        if dst < 0:
            continue
        p = prod[rowptr[dst]:rowptr[dst + 1]]
        pad = (-len(p)) % CHAIN_CHUNK
        chain = np.concatenate([[0.0], p, np.zeros(pad)])
        got = np.add.accumulate(chain)[-1]
        assert np.float64(got).tobytes() == plain[dst].numpy().tobytes()
        assert np.float64(got).tobytes() == a64[dst].numpy().tobytes()
