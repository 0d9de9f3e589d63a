"""The launch plans of kernels E and F, as the CPU can check them.

E's GEMV body (M <= 8) splits K across blocks; :func:`gemv_plan` picks
the grid and the kernel adds the splits in a fixed order inside one
launch.  These tests hold the plan to covering every weight exactly once
and to filling the H100 on qwen3_4b's decode-step shapes, and hold a
torch emulation of the kernel's sum order (rows within a warp, warps,
then splits) to the plain version and to the reference's Pallas kernel
in interpret mode, within E's tolerance (rtol 1e-5 / atol 1e-4).  F picks
its CUDA body from the dtype and head dim (:func:`flash_body`); its
tensor-core body rounds the probabilities to bf16 before ``p @ v``, and
a plain model of that rounding stays within F's bf16 tolerance (2e-2) of
the f32 softmax.  ``chip_smoke.py`` phase 11 holds the CUDA bodies
themselves to the plain versions on the card.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gse as J_gse  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels.flash_attn import flash_attention_pallas  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.core.precision_table import TAG_BITS_USED  # noqa: E402
from repro_torch.kernels import flash_attn as T_f  # noqa: E402
from repro_torch.kernels import gse_matmul as T_e  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402
from repro_torch.kernels.gse_decode import gse_decode_dense_plain  # noqa: E402

CPU = "cpu"
WARPS = 8  # the GEMV block's warps (csrc/gse_dense.cu kThreads / 32)


def _decode_shapes():
    """(K, N) of every linear of a qwen3_4b decode step, the unembedding
    included."""
    c = get_config("qwen3_4b")
    q, kv = c.num_heads * c.hd, c.num_kv_heads * c.hd
    return {"wq": (c.d_model, q), "wk/wv": (c.d_model, kv),
            "wo": (q, c.d_model), "w_gate/w_up": (c.d_model, c.d_ff),
            "w_down": (c.d_ff, c.d_model),
            "unembed": (c.d_model, c.padded_vocab)}


RAGGED = [(300, 1001), (37, 40), (5, 9), (1, 1), (7, 300), (1025, 257),
          (100, 100000)]


def _check_cover(plan, m, k, n):
    """The blocks' row ranges partition [0, k) in split order for every
    column tile, and the tiles partition [0, n)."""
    ranges = list(plan.ranges(k, n))
    assert len(ranges) == plan.blocks
    by_tile = {}
    for k0, k1, c0, c1 in ranges:
        assert 0 <= k0 < k1 <= k and 0 <= c0 < c1 <= n
        assert k1 - k0 <= T_e.gemv_rows_max(m) and c1 - c0 <= plan.cols
        by_tile.setdefault((c0, c1), []).append((k0, k1))
    cols = sorted(by_tile)
    assert cols[0][0] == 0 and cols[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    for rows in by_tile.values():
        assert rows[0][0] == 0 and rows[-1][1] == k
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("name", sorted(_decode_shapes()))
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_gemv_plan_fills_the_h100_on_qwen3_4b(name, m):
    k, n = _decode_shapes()[name]
    plan = T_e.gemv_plan(m, k, n)
    _check_cover(plan, m, k, n)
    assert plan.blocks >= 2 * T_e.H100_SMS
    if m <= 4 and name != "unembed":  # one wave of three blocks per SM
        assert plan.blocks <= 3 * T_e.H100_SMS
    assert plan.rows * (1 << (m - 1).bit_length()) <= T_e.GEMV_X_FLOATS


@pytest.mark.parametrize("kn", RAGGED)
@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_gemv_plan_covers_ragged_shapes_once(kn, sms, narrow, m):
    k, n = kn
    plan = T_e.gemv_plan(m, k, n, sms, narrow=narrow)
    assert plan.rw in ((1, 4) if narrow else (1,))
    _check_cover(plan, m, k, n)
    if k * n <= 1 << 22:  # small enough to count every weight
        seen = np.zeros((k, n), np.int8)
        for k0, k1, c0, c1 in plan.ranges(k, n):
            seen[k0:k1, c0:c1] += 1
        assert (seen == 1).all()
    # Balanced splits keep at least half the two blocks per SM that the
    # plan asks for, where K has the rows; K smaller than the split count
    # gives one row per split.
    assert 2 * plan.blocks >= min(2 * sms, plan.tiles * k)
    if k < math.ceil(2 * sms / plan.tiles):
        assert plan.rows == 1 and plan.splits == k


def test_gemv_plan_rejects_empty_shapes():
    for m, k, n in ((1, 0, 5), (1, 5, 0), (0, 5, 5), (9, 5, 5)):
        with pytest.raises(ValueError):
            T_e.gemv_plan(m, k, n)


def _fma32(acc, a, b):
    """f32 a * b + acc with one rounding of the f64 sum (the product of two
    f32 values is exact in f64): the kernel's FFMA, up to the rare double
    rounding."""
    return (acc.double() + a.double() * b.double()).float()


def gemv_split_k(x, w, plan):
    """The GEMV body's sum order on decoded W: per block, sub-warp i of
    ``8 * rw`` sums rows k0 + i, k0 + i + 8 rw, ... with FMAs, the
    sub-warps' sums are added in order, and the splits in split order."""
    m = x.shape[0]
    k, n = w.shape
    x32 = x.float()
    y = torch.empty(m, n, dtype=torch.float32)
    parts = {}
    for k0, k1, c0, c1 in plan.ranges(k, n):
        warps = []
        subs = WARPS * plan.rw
        for i in range(subs):
            acc = torch.zeros(m, c1 - c0)
            for r in range(k0 + i, k1, subs):
                acc = _fma32(acc, x32[:, r:r + 1], w[r:r + 1, c0:c1])
            warps.append(acc)
        s = warps[0]
        for acc in warps[1:]:
            s = s + acc
        parts.setdefault((c0, c1), []).append(s)
    for (c0, c1), splits in parts.items():
        s = splits[0]
        for p in splits[1:]:
            s = s + p
        y[:, c0:c1] = s
    return y


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("sms", [4, 40])
def test_split_k_order_matches_plain_and_the_pallas_kernel(m, tag, sms):
    # Four SMs: 256-column tiles, eight splits of 38 rows; forty: 64-column
    # tiles (rw 4), 38 splits of 8 rows.
    kk, n = 300, 70
    rng = np.random.default_rng(10 * m + tag)
    vals = rng.normal(size=(kk, n)) / math.sqrt(kk)
    x = rng.normal(size=(m, kk)).astype(np.float32)
    jp = J_gse.pack(vals, 8)
    tp = T_gse.pack(vals, 8, device=CPU)
    plan = T_e.gemv_plan(m, kk, n, sms)
    assert plan.splits > 1 and plan.rw == (1 if sms == 4 else 4)
    scales = T_ref.make_scales(tp.table, TAG_BITS_USED[tag] - tp.ei_bit)
    segs = (tp.head, tp.tail1 if tag >= 2 else None,
            tp.tail2 if tag == 3 else None, scales)
    w = gse_decode_dense_plain(*segs, ei_bit=tp.ei_bit, tag=tag)
    tx = torch.from_numpy(x)
    got = gemv_split_k(tx, w, plan)
    again = gemv_split_k(tx, w, plan)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    plain = T_e.gse_matmul_dense(tx, *segs, ei_bit=tp.ei_bit, tag=tag,
                                 device=CPU)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-4)
    want = J_ops.gse_matmul(jnp.asarray(x), jp, tag=tag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_vector_loads_need_aligned_segments_and_n_multiple_of_8():
    head = torch.zeros(64, dtype=torch.uint16)
    assert T_e._vec_ok(16, head, None, None)
    assert not T_e._vec_ok(12, head, None, None)
    assert not T_e._vec_ok(16, head, head[4:], None)  # 8 bytes in
    assert T_e._vec_ok(16, head[8:], head[16:], None)  # 16 bytes in


# --- F ----------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 96, 112, 128])
def test_flash_body_tensor_cores_for_bf16_at_multiples_of_16(hd):
    assert T_f.flash_body(torch.bfloat16, hd) == "mma"
    assert T_f.flash_body(torch.float32, hd) == "ffma"


@pytest.mark.parametrize("hd", [8, 24, 72, 100, 127])
def test_flash_body_ffma_for_other_head_dims(hd):
    assert T_f.flash_body(torch.bfloat16, hd) == "ffma"
    assert T_f.flash_body(torch.float32, hd) == "ffma"


def test_rows16_copies_only_unaligned_views():
    t = torch.arange(2 * 6 * 2 * 16, dtype=torch.float32).to(
        torch.bfloat16).reshape(2, 6, 2, 16)
    assert T_f._rows16(t) is t
    rows = t[:, 1:]  # 64 bytes in, strides of 8-element multiples
    assert T_f._rows16(rows) is rows
    view = t.reshape(-1)[4:4 + 2 * 5 * 2 * 16].reshape(2, 5, 2, 16)
    copy = T_f._rows16(view)
    assert copy is not view and copy.data_ptr() % 16 == 0
    assert torch.equal(copy, view)


def flash_bf16_p_plain(q, k, v, *, causal=True):
    """The tensor-core body's rounding on the plain version: f32 scores
    and softmax, the probabilities (unnormalized, against the row max)
    rounded to bf16 for ``p @ v``, the f32 sum of the unrounded ones as the
    denominator, the output in q's dtype."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) \
        * T_f._scale(hd)
    if causal:
        i = torch.arange(s)[:, None]
        j = torch.arange(t)[None, :]
        scores = scores.masked_fill(j > i, T_f.NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    pv = torch.einsum("bkgst,btkd->bskgd", p.to(torch.bfloat16).float(),
                      v.float())
    den = p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return (pv / den).reshape(b, s, h, hd).to(q.dtype)


@pytest.mark.parametrize("heads", [(4, 2), (4, 1)])
@pytest.mark.parametrize("hd", [16, 64])
def test_bf16_probabilities_stay_within_the_bf16_tolerance(heads, hd):
    h, kv = heads
    b, s = 2, 70
    rng = np.random.default_rng(h + kv + hd)
    q = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, s, kv, hd))
                             .astype(np.float32)) for _ in range(2))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    model = flash_bf16_p_plain(qb, kb, vb)
    assert model.dtype == torch.bfloat16
    f32 = T_f.flash_attention_gqa(qb.float(), kb.float(), vb.float(),
                                  causal=True, device=CPU)
    np.testing.assert_allclose(model.float().numpy(), f32.numpy(),
                               rtol=2e-2, atol=2e-2)
    plain = T_f.flash_attention_gqa(qb, kb, vb, causal=True, device=CPU)
    np.testing.assert_allclose(model.float().numpy(), plain.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    # The rounding is visible: the model is not the plain version.
    assert not torch.equal(model, plain)


# --- F's FFMA body: the tile walk --------------------------------------------

FLASH_CU = (Path(T_f.__file__).resolve().parent / "csrc" / "flash_attn.cu")


def _flash_constants() -> dict:
    """The FFMA body's namespace-level ``constexpr int kF*`` constants of
    ``csrc/flash_attn.cu``."""
    return {name: int(val) for name, val in re.findall(
        r"^constexpr int (kF\w+) = (\d+);", FLASH_CU.read_text(), re.M)}


FC = _flash_constants()


def _hdp(hd: int) -> int:
    """The padded head dim the FFMA body is compiled for."""
    return next(p for p in (16, 32, 64, 128) if hd <= p)


def _o_dims(hdp: int, tx: int) -> list:
    """The dims of O that thread column ``tx`` owns: kNv vectors of kVec,
    dim h * 16 * kVec + tx * kVec + e (``FTile``)."""
    vec = 4 if hdp >= 64 else hdp // 16
    return [h * 16 * vec + tx * vec + e for h in range(hdp // (16 * vec))
            for e in range(vec)]


def test_ffma_tile_constants():
    assert FC["kFThreads"] == (FC["kFBQ"] // FC["kFRows"]) * 16
    assert FC["kFBK"] == 16 * FC["kFKeys"]
    assert FC["kFBK"] % 4 == 0  # P V reads four keys at a time


@pytest.mark.parametrize("hdp", [16, 32, 64, 128])
def test_ffma_micro_tiles_cover_each_score_and_dim_once(hdp):
    """Thread (ty, tx) owns queries ty * 8 + ii, keys tx + 16 jj of S and
    the dims _o_dims(hdp, tx) of O: every score of a tile and every
    output of a query tile exactly once."""
    rows = FC["kFThreads"] // 16
    scores = np.zeros((FC["kFBQ"], FC["kFBK"]), int)
    out = np.zeros((FC["kFBQ"], hdp), int)
    for ty in range(rows):
        for tx in range(16):
            qs = [ty * FC["kFRows"] + ii for ii in range(FC["kFRows"])]
            for qi in qs:
                for jj in range(FC["kFKeys"]):
                    scores[qi, tx + 16 * jj] += 1
                for d in _o_dims(hdp, tx):
                    out[qi, d] += 1
    assert (scores == 1).all() and (out == 1).all()


def _half_warp_sum(v):
    """The FFMA body's row sum: each thread's keys added in order from 0.0,
    then the xor-shuffle tree over the 16 threads of a row (last dim)."""
    lanes = torch.arange(16)
    for off in (1, 2, 4, 8):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def ffma_walk(q, k, v, *, causal=True):
    """A torch emulation of F's FFMA body (``flash_fwd_kernel``): query
    tiles of kFBQ, key tiles of kFBK up to the diagonal when causal, a warp
    (16 queries) skipping a tile whose keys all lie above its queries, the
    masks on global indices (-1e30 above the diagonal, -inf past T, rows
    past S not written), the online softmax per tile with each row's sum
    in the body's order, hd zero-padded to its class.  The products' own
    sums run in torch's order."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    hdp, bq, bk = _hdp(hd), FC["kFBQ"], FC["kFBK"]
    scale = T_f._scale(hd)
    out = torch.empty(b, s, h, hd)
    pad = torch.nn.functional.pad
    for bi in range(b):
        for hi in range(h):
            kv = hi // (h // kvh)
            qf = pad(q[bi, :, hi].float(), (0, hdp - hd, 0, -s % bq))
            kf = pad(k[bi, :, kv].float(), (0, hdp - hd, 0, -t % bk))
            vf = pad(v[bi, :, kv].float(), (0, hdp - hd, 0, -t % bk))
            for q0 in range(0, s, bq):
                qi = torch.arange(q0, q0 + bq)
                m = torch.full((bq,), T_f.NEG_INF)
                l = torch.zeros(bq)
                acc = torch.zeros(bq, hdp)
                kv_end = min(t, q0 + bq) if causal else t
                for kv0 in range(0, kv_end, bk):
                    kj = torch.arange(kv0, kv0 + bk)
                    live = ~(causal & (kv0 > (qi // 16) * 16 + 15))
                    sc = (qf[q0:q0 + bq] @ kf[kv0:kv0 + bk].t()) * scale
                    sc = sc.masked_fill(causal & (kj[None] > qi[:, None]),
                                        T_f.NEG_INF)
                    sc = sc.masked_fill(kj[None] >= t, float("-inf"))
                    m_new = torch.maximum(m, sc.max(1).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[:, None])
                    # Thread tx holds keys tx + 16 jj: (rows, jj, tx).
                    per = p.reshape(bq, FC["kFKeys"], 16)
                    own = torch.zeros(bq, 16)
                    for jj in range(FC["kFKeys"]):
                        own = own + per[:, jj]
                    rs = _half_warp_sum(own)
                    m = torch.where(live, m_new, m)
                    l = torch.where(live, l * corr + rs, l)
                    acc = torch.where(live[:, None], acc * corr[:, None]
                                      + p @ vf[kv0:kv0 + bk], acc)
                rows = slice(q0, min(q0 + bq, s))
                n = rows.stop - rows.start
                o = acc[:n, :hd] / torch.clamp(l[:n], min=1e-30)[:, None]
                out[bi, rows, hi] = o
    return out.to(q.dtype)


FFMA_CASES = [(200, 200, 16, (4, 1), True), (200, 200, 16, (4, 4), False),
              (200, 200, 128, (4, 1), False), (200, 200, 128, (4, 4), True),
              (200, 200, 16, (4, 4), True), (200, 200, 128, (4, 1), True),
              (72, 200, 16, (4, 1), True), (150, 70, 128, (2, 2), False)]


@pytest.mark.parametrize("s, t, hd, heads, causal", FFMA_CASES)
def test_ffma_walk_matches_plain_and_the_pallas_kernel(s, t, hd, heads,
                                                       causal):
    """The FFMA body's walk, at hd 16 and 128, S and T not multiples of the
    tiles (masks past S and T), GQA 4:1 and 1:1, causal or not: within F's
    f32 tolerance (2e-5) of the plain version and of the reference's
    Pallas kernel in interpret mode (K and V repeated per group)."""
    h, kv = heads
    rng = np.random.default_rng(s + t + hd + h + kv)
    q = rng.normal(size=(1, s, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(1, t, kv, hd)).astype(np.float32)
            for _ in range(2))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    walk = ffma_walk(qt, kt, vt, causal=causal)
    plain = T_f.flash_attention_gqa(qt, kt, vt, causal=causal, device=CPU)
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    g = h // kv
    heads_first = (np.repeat(a, g, axis=2) if a is not q else a
                   for a in (q, k, v))
    qj, kj, vj = (jnp.asarray(a[0].transpose(1, 0, 2)) for a in heads_first)
    ref = flash_attention_pallas(qj, kj, vj, causal=causal,
                                 blocks=(math.gcd(s, 40), math.gcd(t, 40)))
    np.testing.assert_allclose(
        walk.numpy()[0], np.asarray(ref).transpose(1, 0, 2), rtol=2e-5,
        atol=2e-5)
