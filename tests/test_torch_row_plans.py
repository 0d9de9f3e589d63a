"""Kernel A64's row plan and the sum orders of the bodies of A64, C64,
C′64 and B32's long rows, as the CPU can check them.

A64 (``csrc/gse_spmv.cu``) runs each CSR row on one of three bodies, by
the pack's row plan (``GSECSR.row_plan``, ``sparse.csr.csr_row_plan``):
rows of at least ``A64_BLOCK_LEN`` entries a block each, whose one adding
thread takes the products in chunks of 1024 (+0.0 past the row's end);
rows of at least ``A64_WARP_LEN`` a warp each, in chunks of 32; the others
in row blocks of consecutive rows, staged in shared memory and added one
row per thread.  C′64 (``csrc/gse_sell.cu``) runs the SELL rows from the
pack's ``long_from`` on with a block each, four columns in chunks of 512,
and the others on a warp.  C64 (``csrc/gse_spmm.cu``) runs A64's plan on
C′64's two column bodies and row blocks of four columns staged 1024
slots at a time, each thread's chains carried across the chunks.  B32
(``csrc/gse_sell.cu``) runs the SELL rows from ``long_from`` on with a
block each whose 32 adding lanes keep A32's lane order over chunks of
2048 products.  These tests hold the plan to its contract (every row
once, on the body its length picks, row blocks within their budgets,
which are the kernel's; ``pack_csr`` and ``convert`` agree) and hold a
model of each body's order -- products staged by torch, each chain a
left fold (``np.add.accumulate``) -- bitwise to the plain versions and to
the reference (``spmv_gse``, ``spmm_gse``; B32 within the JAX tests'
tolerance of the Pallas SELL kernel in interpret mode).  Such a fold from
0.0, padded with +0.0, is the plain row sum for any chunking, so the
model cases alone could not fail; each is paired with planted faults
(chunks added out of order, a row block's thread on its neighbour's row,
columns crossed, lanes taking the wrong slots) that must break the
bitwise equality on the rows of the body they touch, and only there.
``chip_smoke.py`` phases 2, 7, 9 and 10 hold the CUDA bodies to the plain
versions on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as J_ops  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse import spmv as J_spmv  # noqa: E402

from repro_torch.convert import gsecsr_from_repro  # noqa: E402
from repro_torch.core.precision_table import TAG_BITS_USED  # noqa: E402
from repro_torch.kernels import gse_spmm as T_c  # noqa: E402
from repro_torch.kernels import gse_spmv as T_k  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402
from repro_torch.sparse.spmv import decode_gsecsr  # noqa: E402

CPU = "cpu"
ROWS_CUH = (Path(T_k.__file__).resolve().parent / "csrc" / "gse_rows.cuh")


def _cuda_constants() -> dict:
    """The namespace-level ``constexpr int`` constants of
    ``csrc/gse_rows.cuh`` (those at the start of a line), evaluated in
    order (integer arithmetic over the earlier ones)."""
    out = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 ROWS_CUH.read_text(), re.M):
        out[name] = int(eval(expr.replace("/", "//"), {}, dict(out)))
    return out


CUDA = _cuda_constants()
BLOCK_CHUNK = CUDA["kChainChunk"]
WARP_CHUNK = 32
COLS_CHUNK = CUDA["kColsChunk"]
GSECSR_FIELDS = ("rowptr", "colpak", "head", "tail1", "tail2", "table",
                 "row_ids")


def _lens(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


# Row pointers with the shapes the plan must handle.
ROWPTRS = {
    "empty_rows": lambda: _lens([0, 0, 5, 0, 3000, 0, 0, 17, 0, 1, 0, 0]),
    "all_empty": lambda: _lens([0] * 600),
    "one_dense_row": lambda: _lens([70000]),
    "power_law": lambda: _lens(np.minimum(np.random.default_rng(3).pareto(
        1.2, 5000) * 8, 9000).astype(np.int64)),
    "spd_rs8_2k": lambda: T_gen.diag_rescale(T_gen.random_spd(
        2000, seed=21, device=CPU), 8.0, 21).rowptr.numpy(),
    "skewed_8192": lambda: T_gen.skewed_spd(8192, seed=0,
                                            device=CPU).rowptr.numpy(),
}
THRESHOLDS = {"default": {}, "narrow": dict(warp_len=16, block_len=256),
              "no_warp": dict(warp_len=2049, block_len=2049)}


def _plan_rows_tensors(plan):
    return plan.long_rows, plan.warp_rows, plan.row_blocks


def _plan_rows(plan):
    return (plan.long_rows.numpy(), plan.warp_rows.numpy(),
            plan.row_blocks.numpy().reshape(-1, 2))


@pytest.mark.parametrize("limits", sorted(THRESHOLDS))
@pytest.mark.parametrize("case", sorted(ROWPTRS))
def test_every_row_runs_once_on_the_body_its_length_picks(case, limits):
    rowptr = ROWPTRS[case]()
    kw = THRESHOLDS[limits]
    warp_len = kw.get("warp_len", T_csr.A64_WARP_LEN)
    block_len = kw.get("block_len", T_csr.A64_BLOCK_LEN)
    long_rows, warp_rows, blocks = _plan_rows(
        T_csr.csr_row_plan(torch.from_numpy(rowptr), **kw))
    lens = np.diff(rowptr.astype(np.int64))
    in_blocks = np.concatenate([np.arange(r0, r1) for r0, r1 in blocks]
                               ) if len(blocks) else np.zeros(0, np.int64)
    every = np.concatenate([long_rows, warp_rows, in_blocks])
    assert np.array_equal(np.sort(every), np.arange(lens.size))
    assert np.array_equal(long_rows, np.flatnonzero(lens >= block_len))
    assert np.array_equal(warp_rows, np.flatnonzero(
        (lens >= warp_len) & (lens < block_len)))
    assert np.all(lens[in_blocks] < warp_len)
    assert T_csr.csr_row_plan(torch.from_numpy(rowptr), **kw).rows == \
        lens.size


def test_row_block_budgets_are_the_kernels():
    """The plan's row-block budgets are the shared memory and threads the
    kernel's row block has (gse_rows.cuh), and its chunk sizes are the
    ones the order models here use: C64's row block stages its run in two
    chunks, which fit the block chain's buffers of four columns, and its
    wrapper sizes the interleaved copy of X by the kernel's pass."""
    assert T_csr.ROW_BLOCK_SLOTS == CUDA["kRowBlockSlots"]
    assert T_csr.ROW_BLOCK_ROWS == CUDA["kRowBlockRows"]
    assert CUDA["kChainThreads"] == CUDA["kRowBlockRows"]
    assert T_csr.B64_BLOCK_WIDTH == 2 * T_csr.A64_BLOCK_LEN
    assert 2 * CUDA["kRowColsChunk"] == T_csr.ROW_BLOCK_SLOTS
    assert CUDA["kRowColsChunk"] <= 2 * CUDA["kColsStride"]
    assert T_c.C64_PASS == CUDA["kColsWarp"]


@pytest.mark.parametrize("limits", sorted(THRESHOLDS))
@pytest.mark.parametrize("case", sorted(ROWPTRS))
def test_row_blocks_keep_their_budgets(case, limits):
    rowptr = ROWPTRS[case]().astype(np.int64)
    *_, blocks = _plan_rows(T_csr.csr_row_plan(rowptr, **THRESHOLDS[limits]))
    if not len(blocks):
        return
    r0, r1 = blocks[:, 0], blocks[:, 1]
    assert np.all(r1 > r0)
    assert np.all(r1 - r0 <= T_csr.ROW_BLOCK_ROWS)
    assert np.all(rowptr[r1] - rowptr[r0] <= T_csr.ROW_BLOCK_SLOTS)
    assert np.all(r0[1:] >= r1[:-1])  # ascending, disjoint


def test_plan_is_on_the_rowptr_device_as_int32():
    plan = T_csr.csr_row_plan(torch.from_numpy(ROWPTRS["empty_rows"]()))
    for t in _plan_rows_tensors(plan):
        assert t.dtype == torch.int32 and t.device.type == CPU
    assert plan.row_blocks.dim() == 2 and plan.row_blocks.shape[1] == 2


@pytest.mark.parametrize("kw", [dict(warp_len=0), dict(warp_len=300,
                                                       block_len=200),
                                dict(warp_len=2050)])
def test_plan_rejects_thresholds_a_row_block_cannot_hold(kw):
    with pytest.raises(ValueError):
        T_csr.csr_row_plan(_lens([3, 4]), **kw)


@pytest.fixture(scope="module")
def operators():
    """spd_rs8_2k and skewed_spd(8192, seed=0) at k = 8: the reference's
    GSECSR and the port's ``pack_csr``."""
    out = {}
    for name, make in (
            ("spd_rs8_2k", lambda m, d: m.diag_rescale(
                m.random_spd(2000, seed=21, **d), 8.0, 21)),
            ("skewed_8192", lambda m, d: m.skewed_spd(8192, seed=0, **d))):
        jg = J_csr.pack_csr(make(J_gen, {}), k=8)
        out[name] = (jg, T_csr.pack_csr(make(T_gen, {"device": CPU}), k=8))
    return out


@pytest.mark.parametrize("name", ["spd_rs8_2k", "skewed_8192"])
def test_pack_csr_and_convert_give_the_same_plan(operators, name):
    jg, tg = operators[name]
    conv = gsecsr_from_repro({f: np.asarray(getattr(jg, f))
                              for f in GSECSR_FIELDS}, jg.ei_bit, jg.shape,
                             device=CPU)
    for a, b in zip(_plan_rows_tensors(conv.row_plan),
                    _plan_rows_tensors(tg.row_plan)):
        assert torch.equal(a, b)
    assert torch.equal(conv.rowptr, tg.rowptr)


def _fold(products, chunk: int) -> np.float64:
    """A chain from 0.0 over ``products`` padded with +0.0 to whole
    chunks, added one after another."""
    pad = (-len(products)) % chunk
    chain = np.concatenate([[0.0], products, np.zeros(pad)])
    return np.add.accumulate(chain)[-1]


def _misordered(products, chunk: int, fault: str) -> np.ndarray:
    """``products`` padded to whole chunks, in a planted wrong order:
    "chunks_reversed" adds the chunks last to first (a wrong buffer of the
    double buffer), "lanes_reversed" each chunk's slots last to first."""
    pad = np.concatenate([products, np.zeros((-len(products)) % chunk)])
    chunks = pad.reshape(-1, chunk)
    if fault == "chunks_reversed":
        return chunks[::-1].ravel()
    return chunks[:, ::-1].ravel()


def _a64_emulated(g, x, tag, plan, fault=None) -> np.ndarray:
    """A64's order under ``plan``: the products staged as the bodies stage
    them (torch), each row's chain a left fold.  ``fault`` plants a wrong
    order in one body (A64_FAULTS)."""
    vals, cols = decode_gsecsr(g, tag)
    prod = (vals * x[cols]).numpy()
    rowptr = g.rowptr.numpy().astype(np.int64)
    y = np.full(g.shape[0], np.nan)
    long_rows, warp_rows, blocks = _plan_rows(plan)
    for body, rows, chunk in (("block", long_rows, BLOCK_CHUNK),
                              ("warp", warp_rows, WARP_CHUNK)):
        for r in rows:
            row = prod[rowptr[r]:rowptr[r + 1]]
            if fault in A64_FAULTS and A64_FAULTS[fault] == body:
                row = _misordered(row, chunk, fault)
            y[r] = _fold(row, chunk)
    for r0, r1 in blocks:
        base = rowptr[r0]
        staged = prod[base:rowptr[r1]].copy()  # the block's shared memory
        for r in range(r0, r1):
            rr = min(r + 1, r1 - 1) if fault == "neighbour_row" else r
            y[r] = _fold(staged[rowptr[rr] - base:rowptr[rr + 1] - base], 1)
    return y


# A planted fault of each A64 body: the body it misorders.
A64_FAULTS = {"chunks_reversed": "block", "lanes_reversed": "warp",
              "neighbour_row": "row_block"}


@pytest.mark.parametrize("limits", ["default", "narrow"])
@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("name", ["spd_rs8_2k", "skewed_8192"])
def test_a64_order_is_bitwise_the_plain_version_and_reference(
        operators, name, tag, limits):
    jg, tg = operators[name]
    plan = T_csr.csr_row_plan(tg.rowptr, **THRESHOLDS[limits])
    x = np.random.default_rng(tag).normal(size=tg.shape[1])
    got = _a64_emulated(tg, torch.from_numpy(x), tag, plan)
    plain = T_k.gse_spmv_csr_f64(tg.rowptr, tg.colpak, tg.head, tg.tail1,
                                 tg.tail2, tg.table, torch.from_numpy(x),
                                 ei_bit=tg.ei_bit, tag=tag, plan=plan)
    ref = np.asarray(J_spmv.spmv_gse(jg, jnp.asarray(x), tag=tag))
    assert np.array_equal(got.view(np.uint64), plain.numpy().view(np.uint64))
    assert np.array_equal(got.view(np.uint64), ref.view(np.uint64))


@pytest.mark.parametrize("fault", sorted(A64_FAULTS))
def test_a64_order_model_sees_a_misordered_body(operators, fault):
    """On skewed_spd(8192) every body's rows hold products whose sum
    depends on the order, so each planted fault breaks the bitwise
    equality the model cases check, on its body's rows only."""
    _, tg = operators["skewed_8192"]
    plan = tg.row_plan
    x = torch.from_numpy(np.random.default_rng(3).normal(size=tg.shape[1]))
    plain = T_k.gse_spmv_csr_f64(tg.rowptr, tg.colpak, tg.head, tg.tail1,
                                 tg.tail2, tg.table, x, ei_bit=tg.ei_bit,
                                 tag=3, plan=plan).numpy().view(np.uint64)
    bad = _a64_emulated(tg, x, 3, plan, fault).view(np.uint64) != plain
    long_rows, warp_rows, blocks = _plan_rows(plan)
    rows = {"block": long_rows, "warp": warp_rows,
            "row_block": np.concatenate([np.arange(r0, r1)
                                         for r0, r1 in blocks])}
    own = rows[A64_FAULTS[fault]]
    assert bad[own].any()
    assert not np.delete(bad, own).any()


def test_skewed_plan_runs_every_body(operators):
    _, tg = operators["skewed_8192"]
    assert all(t.shape[0] > 0 for t in _plan_rows_tensors(tg.row_plan))


MIXED_TAGS = [1, 2, 3, 1]
MIXED_ACTIVE = [True, True, True, False]


def _cprime64_emulated(tg, sell, x, fault=None) -> np.ndarray:
    """C′64's order on the SELL pack: bucket rows from ``long_from`` on
    add each column in chunks of COLS_CHUNK (the block's four adding
    lanes), the others in chunks of 32 (the warp row); inactive columns
    are 0.0.  ``fault`` plants a wrong order (CPRIME64_FAULTS):
    "columns_crossed" has lane c of a long row's block add column c + 1's
    products."""
    m, n = tg.shape
    xt = torch.from_numpy(x)
    rowptr = tg.rowptr.numpy().astype(np.int64)
    perm = sell.perm.numpy()
    prods = np.zeros((4, tg.nnz))
    for j, (t, on) in enumerate(zip(MIXED_TAGS, MIXED_ACTIVE)):
        if on:
            vals, cols = decode_gsecsr(tg, t)
            prods[j] = (vals * xt[j][cols]).numpy()
    y = np.zeros((4, m))
    for r in range(perm.shape[0]):
        dst = perm[r]
        if dst < 0:
            continue
        long = r >= sell.long_from
        chunk = COLS_CHUNK if long else WARP_CHUNK
        for j, on in enumerate(MIXED_ACTIVE):
            if not on:
                continue
            src = (j + 1) % 4 if long and fault == "columns_crossed" else j
            row = prods[src, rowptr[dst]:rowptr[dst + 1]]
            if fault == "chunks_reversed" and long:
                row = _misordered(row, chunk, fault)
            y[j, dst] = _fold(row, chunk)
    return y


CPRIME64_FAULTS = ("chunks_reversed", "columns_crossed")


def _cprime64_plain(tg, sell, x):
    return T_c.gse_spmm_sell_f64(
        *sell.segments, sell.table, torch.from_numpy(x),
        torch.tensor(MIXED_TAGS, dtype=torch.int32),
        torch.tensor(MIXED_ACTIVE), sell.bucket_table, sell.perm,
        sell.row_len, rows=tg.shape[0], ei_bit=tg.ei_bit,
        long_from=sell.long_from, device=CPU).numpy()


@pytest.fixture(scope="module")
def skewed_sell(operators):
    _, tg = operators["skewed_8192"]
    sell = T_ops.sell_pack_gsecsr(tg)
    assert 0 < sell.long_from < sell.perm.shape[0]
    return sell


@pytest.mark.parametrize("seed", [0, 1])
def test_c64_column_chains_are_bitwise_the_plain_version_and_reference(
        operators, skewed_sell, seed):
    jg, tg = operators["skewed_8192"]
    x = np.random.default_rng(seed).normal(size=(4, tg.shape[1]))
    want = _cprime64_emulated(tg, skewed_sell, x)
    plain = _cprime64_plain(tg, skewed_sell, x)
    assert np.array_equal(want.view(np.uint64), plain.view(np.uint64))
    for j, t in enumerate(MIXED_TAGS[:3]):
        ref = np.asarray(J_spmv.spmv_gse(jg, jnp.asarray(x[j]), tag=t))
        assert np.array_equal(want[j].view(np.uint64), ref.view(np.uint64))
    assert np.all(want[3] == 0.0)


@pytest.mark.parametrize("fault", CPRIME64_FAULTS)
def test_c64_order_model_sees_a_misordered_block(operators, skewed_sell,
                                                 fault):
    """Each planted fault in the long rows' block breaks the bitwise
    equality of the active columns on the rows it reorders (for
    "chunks_reversed" those of more than one chunk), and on no other
    row."""
    _, tg = operators["skewed_8192"]
    x = np.random.default_rng(5).normal(size=(4, tg.shape[1]))
    bad = (_cprime64_emulated(tg, skewed_sell, x, fault).view(np.uint64)
           != _cprime64_plain(tg, skewed_sell, x).view(np.uint64))
    perm = skewed_sell.perm.numpy()
    rows = perm[skewed_sell.long_from:]
    rows = rows[rows >= 0]
    if fault == "chunks_reversed":
        rows = rows[np.diff(tg.rowptr.numpy())[rows] > COLS_CHUNK]
    assert rows.size and bad[:3][:, rows].all()
    assert not np.delete(bad, rows, axis=1).any()


# --- C64 on A64's row plan ---------------------------------------------------

ROW_COLS_CHUNK = CUDA["kRowColsChunk"]
LANES_CHUNK = CUDA["kLanesChunk"]
C64_ROW_FAULTS = ("rows_crossed", "columns_crossed", "chunks_reversed")


def _column_products(tg, x, tags, active) -> np.ndarray:
    """``(nrhs, nnz)`` products of column j at ``tags[j]`` (0.0 where the
    column is inactive), as the bodies stage them."""
    prods = np.zeros((len(tags), tg.nnz))
    for j, (t, on) in enumerate(zip(tags, active)):
        if on:
            vals, cols = decode_gsecsr(tg, t)
            prods[j] = (vals * torch.from_numpy(x[j])[cols]).numpy()
    return prods


def _c64_rows_emulated(tg, x, fault=None) -> np.ndarray:
    """C64's order under the pack's row plan, columns MIXED_TAGS /
    MIXED_ACTIVE: long rows each column in chunks of COLS_CHUNK (the block
    chain's four adding lanes), warp rows in chunks of 32, row blocks
    staged ROW_COLS_CHUNK slots at a time with each thread's chains
    carried from chunk to chunk.  ``fault`` plants a wrong order in the
    row blocks (C64_ROW_FAULTS): a thread on its neighbour's row, column c
    adding column c + 1's products, or a row's two chunks added second
    first."""
    prods = _column_products(tg, x, MIXED_TAGS, MIXED_ACTIVE)
    rowptr = tg.rowptr.numpy().astype(np.int64)
    y = np.full((4, tg.shape[0]), np.nan)
    long_rows, warp_rows, blocks = _plan_rows(tg.row_plan)
    for rows, chunk in ((long_rows, COLS_CHUNK), (warp_rows, WARP_CHUNK)):
        for r in rows:
            for j in range(4):
                y[j, r] = _fold(prods[j, rowptr[r]:rowptr[r + 1]], chunk)
    for r0, r1 in blocks:
        base = rowptr[r0]
        staged = prods[:, base:rowptr[r1]].copy()  # the block's chunks
        for r in range(r0, r1):
            rr = min(r + 1, r1 - 1) if fault == "rows_crossed" else r
            beg, end = rowptr[rr] - base, rowptr[rr + 1] - base
            for j in range(4):
                src = (j + 1) % 4 if fault == "columns_crossed" else j
                row = staged[src, beg:end]
                if fault == "chunks_reversed":
                    cut = max(ROW_COLS_CHUNK - beg, 0)
                    row = np.concatenate([row[cut:], row[:cut]])
                y[j, r] = _fold(row, 1)
    return y


def _c64_csr_plain(tg, x, plan=None):
    return T_c.gse_spmm_csr_f64(
        tg.rowptr, tg.colpak, tg.head, tg.tail1, tg.tail2, tg.table,
        torch.from_numpy(x), torch.tensor(MIXED_TAGS, dtype=torch.int32),
        torch.tensor(MIXED_ACTIVE), ei_bit=tg.ei_bit,
        plan=tg.row_plan if plan is None else plan, device=CPU).numpy()


def _row_block_rows(plan) -> np.ndarray:
    *_, blocks = _plan_rows(plan)
    return np.concatenate([np.arange(r0, r1) for r0, r1 in blocks])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["spd_rs8_2k", "skewed_8192"])
def test_c64_rows_order_is_bitwise_the_plain_version_and_reference(
        operators, name, seed):
    """C64's three bodies under the pack's row plan, mixed tags and an
    inactive column: bitwise the plain version, and per column bitwise
    the reference's ``spmm_gse`` at that column's tag."""
    jg, tg = operators[name]
    x = np.random.default_rng(seed).normal(size=(4, tg.shape[1]))
    want = _c64_rows_emulated(tg, x)
    plain = _c64_csr_plain(tg, x)
    assert np.array_equal(want.view(np.uint64), plain.view(np.uint64))
    for j, t in enumerate(MIXED_TAGS[:3]):
        ref = np.asarray(J_spmv.spmm_gse(jg, jnp.asarray(x[j][:, None]),
                                         tag=t))[:, 0]
        assert np.array_equal(want[j].view(np.uint64), ref.view(np.uint64))
    assert np.all(want[3] == 0.0)


@pytest.mark.parametrize("fault", C64_ROW_FAULTS)
@pytest.mark.parametrize("name", ["spd_rs8_2k", "skewed_8192"])
def test_c64_rows_order_model_sees_a_misordered_row_block(operators, name,
                                                          fault):
    """Each planted fault in the row blocks breaks the bitwise equality
    on the rows it reorders (for "chunks_reversed" the rows that span a
    block's two chunks) and on no other row."""
    _, tg = operators[name]
    x = np.random.default_rng(9).normal(size=(4, tg.shape[1]))
    bad = (_c64_rows_emulated(tg, x, fault).view(np.uint64)
           != _c64_csr_plain(tg, x).view(np.uint64)).any(axis=0)
    rows = _row_block_rows(tg.row_plan)
    if fault == "chunks_reversed":
        rowptr = tg.rowptr.numpy().astype(np.int64)
        *_, blocks = _plan_rows(tg.row_plan)
        base = np.repeat(rowptr[blocks[:, 0]], blocks[:, 1] - blocks[:, 0])
        rows = rows[(rowptr[rows] - base < ROW_COLS_CHUNK)
                    & (rowptr[rows + 1] - base > ROW_COLS_CHUNK)]
    assert rows.size and bad[rows].any()
    assert not np.delete(bad, rows).any()


@pytest.mark.parametrize("wrapper", ["gse_spmv_csr_f64", "gse_spmm_csr_f64"])
def test_csr_kernels_refuse_a_plan_for_another_row_count(operators,
                                                         wrapper):
    _, tg = operators["spd_rs8_2k"]
    other = T_csr.csr_row_plan(tg.rowptr[:-1])
    segs = (tg.rowptr, tg.colpak, tg.head, tg.tail1, tg.tail2, tg.table)
    with pytest.raises(ValueError, match="row plan is for"):
        if wrapper == "gse_spmv_csr_f64":
            T_k.gse_spmv_csr_f64(*segs, torch.zeros(tg.shape[1],
                                                    dtype=torch.float64),
                                 ei_bit=tg.ei_bit, tag=1, plan=other)
        else:
            T_c.gse_spmm_csr_f64(*segs, torch.zeros(2, tg.shape[1],
                                                    dtype=torch.float64),
                                 torch.ones(2, dtype=torch.int32),
                                 torch.ones(2, dtype=torch.bool),
                                 ei_bit=tg.ei_bit, plan=other, device=CPU)


# --- B32's long rows ---------------------------------------------------------

B32_FAULTS = ("chunks_reversed", "lanes_transposed")


def _f32_products(sell, x, scales, tag) -> list:
    """Each bucket's ``(rows_b, w_b)`` f32 products, padded slots
    included, in the order of ``gse_spmv_ell_f32_plain``'s decode; for an
    ``(n, nrhs)`` x, ``(rows_b, w_b, nrhs)``: each slot decoded once and
    multiplied by every column's x."""
    segs = sell.segments
    shift = 32 - sell.ei_bit
    out = []
    for _, rows, w, off in T_k.sell_rows(sell.bucket_table,
                                         sell.perm.shape[0]):
        def part(i):
            return segs[i][off:off + rows * w].view(rows, w).to(torch.int64)
        cp, h = part(0), part(1)
        sgn = 1.0 - 2.0 * ((h >> 15) & 0x1).to(torch.float32)
        mant = (h & 0x7FFF).to(torch.float32)
        if tag >= 2:
            mant = mant * 65536.0 + part(2).to(torch.float32)
        if tag == 3:
            mant = mant * float(2.0**32) + part(3).to(torch.float32)
        vals = sgn * mant * scales.reshape(-1)[cp >> shift]
        if x.dim() == 2:
            vals = vals[..., None]
        out.append((vals * x[cp & ((1 << shift) - 1)]).numpy())
    return out


def _lanes(products, chunk: int, fault=None):
    """32 lane chains over ``products`` padded with +0.0 to whole chunks
    (lane l adds slots l, l+32, ... from 0.0 in f32), then the warp's
    shuffle tree.  ``products`` is ``(len,)`` (one column, returns a
    scalar) or ``(len, nc)`` (C′32's block: each column's chains, returns
    ``(nc,)``).  ``fault`` (B32_FAULTS, C32_FAULTS) adds the chunks last to
    first, has lane l add slots l * chunk / 32, ... of a chunk one after
    another, or hands columns 0 and 1 each other's products in every
    second chunk (a producer staging a slot's columns out of place).  (A
    fault that permutes whole lanes alike at every level of the tree, as
    lane l on lane l + 1's slots does, leaves the sum's bits as they
    are.)"""
    cols = np.asarray(products, np.float32)
    one = cols.ndim == 1
    cols = cols.reshape(len(cols), -1)
    nc = cols.shape[1]
    pad = np.concatenate([cols, np.zeros(((-len(cols)) % chunk, nc),
                                         np.float32)])
    chunks = pad.reshape(-1, chunk, nc)
    if fault == "chunks_reversed":
        chunks = chunks[::-1]
    if fault == "lanes_transposed":
        chunks = chunks.reshape(-1, 32, chunk // 32, nc).transpose(0, 2, 1, 3)
    if fault == "columns_crossed":
        chunks = chunks.copy()
        chunks[1::2, :, :2] = chunks[1::2, :, 1::-1]
    lanes = chunks.reshape(-1, 32, nc)
    chain = np.concatenate([np.zeros((1, 32, nc), np.float32), lanes])
    acc = np.add.accumulate(chain, axis=0, dtype=np.float32)[-1]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:off] + acc[off:2 * off]
    return acc[0, 0] if one else acc[0]


def _b32_emulated(sell, x, scales, tag, fault=None) -> np.ndarray:
    """B32's order: bucket rows from ``long_from`` on in the block's
    chunks of LANES_CHUNK, the others as one warp (chunks of 32); ``fault``
    plants a wrong order in the long rows only."""
    perm = sell.perm.numpy()
    y = np.zeros(sell.shape[0], np.float32)
    r = 0
    for prods in _f32_products(sell, x, scales, tag):
        for row in prods:
            if perm[r] >= 0:
                long = r >= sell.long_from
                y[perm[r]] = _lanes(row, LANES_CHUNK if long else WARP_CHUNK,
                                    fault if long else None)
            r += 1
    return y


@pytest.fixture(scope="module")
def skewed_sell_ref(operators):
    jg, _ = operators["skewed_8192"]
    return J_ops.sell_pack_gsecsr(jg)


def _b32_case(tg, tag, seed=4):
    x = np.random.default_rng(seed).normal(size=tg.shape[1]).astype(
        np.float32)
    scales = T_ref.make_scales(tg.table, TAG_BITS_USED[tag])
    return x, scales


def _b32_plain(sell, x, scales, tag):
    segs = sell.segments
    return T_k.gse_spmv_sell_f32_plain(
        segs[0], segs[1], segs[2] if tag >= 2 else None,
        segs[3] if tag == 3 else None, torch.from_numpy(x), scales,
        sell.bucket_table, sell.perm, rows=sell.shape[0], ei_bit=sell.ei_bit,
        tag=tag).numpy()


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_b32_long_row_order_is_bitwise_the_plain_version(
        operators, skewed_sell, skewed_sell_ref, tag):
    """B32's block order on the bucket rows from ``long_from`` on (a
    bucket of 8192, at least B64_BLOCK_WIDTH): bitwise the plain version
    (A32's order), and within the JAX tests' tolerance of the reference's
    Pallas SELL kernel in interpret mode."""
    _, tg = operators["skewed_8192"]
    assert max(skewed_sell.widths) >= T_csr.B64_BLOCK_WIDTH
    x, scales = _b32_case(tg, tag)
    want = _b32_emulated(skewed_sell, torch.from_numpy(x), scales, tag)
    plain = _b32_plain(skewed_sell, x, scales, tag)
    assert np.array_equal(want.view(np.uint32), plain.view(np.uint32))
    ref = np.asarray(J_ops.gse_spmv_sell(skewed_sell_ref, jnp.asarray(x),
                                         tag=tag))
    np.testing.assert_allclose(want, ref, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("fault", B32_FAULTS)
def test_b32_order_model_sees_a_misordered_long_row(operators, skewed_sell,
                                                    fault):
    """Each planted fault in the long rows' block breaks the bitwise
    equality on some of those rows and on no other row."""
    _, tg = operators["skewed_8192"]
    x, scales = _b32_case(tg, 3, seed=6)
    bad = (_b32_emulated(skewed_sell, torch.from_numpy(x), scales, 3,
                         fault).view(np.uint32)
           != _b32_plain(skewed_sell, x, scales, 3).view(np.uint32))
    perm = skewed_sell.perm.numpy()
    rows = perm[skewed_sell.long_from:]
    rows = rows[rows >= 0]
    assert rows.size and bad[rows].any()
    assert not np.delete(bad, rows).any()


# --- C′32: B32's bodies for the columns of a pass ----------------------------

C32_FAULTS = ("columns_crossed", "chunks_reversed")
# Slots per chunk of C′32's long-row block: kLanesColsFloats f32 values, a
# slot's kColsWarp products side by side.
LANES_COLS_CHUNK = CUDA["kLanesColsFloats"] // CUDA["kColsWarp"]


def _c32_emulated(sell, x, scales, tag, fault=None) -> np.ndarray:
    """C′32's order on an ``(n, nrhs)`` x: bucket rows from ``long_from`` on
    in the block's chunks of LANES_COLS_CHUNK, each column on its own 32
    lane chains, the others as one warp (chunks of 32); ``fault`` plants a
    wrong order in the long rows only."""
    perm = sell.perm.numpy()
    y = np.zeros((sell.shape[0], x.shape[1]), np.float32)
    r = 0
    for prods in _f32_products(sell, x, scales, tag):
        for row in prods:
            if perm[r] >= 0:
                long = r >= sell.long_from
                y[perm[r]] = _lanes(row, LANES_COLS_CHUNK if long
                                    else WARP_CHUNK, fault if long else None)
            r += 1
    return y


def _c32_plain(sell, x, scales, tag):
    segs = sell.segments
    return T_c.gse_spmm_sell_f32_plain(
        segs[0], segs[1], segs[2] if tag >= 2 else None,
        segs[3] if tag == 3 else None, torch.from_numpy(x), scales,
        sell.bucket_table, sell.perm, rows=sell.shape[0], ei_bit=sell.ei_bit,
        tag=tag).numpy()


def _c32_case(tg, tag, nrhs, seed=8):
    x = np.random.default_rng(seed + nrhs).normal(
        size=(tg.shape[1], nrhs)).astype(np.float32)
    return x, T_ref.make_scales(tg.table, TAG_BITS_USED[tag])


def test_c32_long_row_chunk_holds_whole_lane_rounds():
    assert LANES_COLS_CHUNK % 32 == 0
    assert LANES_COLS_CHUNK * CUDA["kColsWarp"] == CUDA["kLanesColsFloats"]


@pytest.mark.parametrize("nrhs", [1, 3, 4, 9])
@pytest.mark.parametrize("tag", [1, 2, 3])
def test_c32_long_row_order_is_bitwise_the_plain_version(
        operators, skewed_sell, skewed_sell_ref, tag, nrhs):
    """C′32's order (the long rows' block per column, the other rows'
    warps): each column bitwise the plain version (A32's lane order), at
    nrhs 1 bitwise B32's model, and within the JAX tests' tolerance of the
    reference's Pallas SELL SpMM in interpret mode; nrhs 9 crosses a pass
    of four columns."""
    _, tg = operators["skewed_8192"]
    x, scales = _c32_case(tg, tag, nrhs)
    want = _c32_emulated(skewed_sell, torch.from_numpy(x), scales, tag)
    plain = _c32_plain(skewed_sell, x, scales, tag)
    assert np.array_equal(want.view(np.uint32), plain.view(np.uint32))
    if nrhs == 1:
        b32 = _b32_emulated(skewed_sell, torch.from_numpy(x[:, 0].copy()),
                            scales, tag)
        assert np.array_equal(want[:, 0].view(np.uint32), b32.view(np.uint32))
    ref = np.asarray(J_ops.gse_spmm_sell(skewed_sell_ref, jnp.asarray(x),
                                         tag=tag))
    np.testing.assert_allclose(want, ref, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("fault", C32_FAULTS)
def test_c32_order_model_sees_a_misordered_long_row(operators, skewed_sell,
                                                    fault):
    """Each planted fault in the long rows' block breaks the bitwise
    equality on some of those rows and on no other row."""
    _, tg = operators["skewed_8192"]
    x, scales = _c32_case(tg, 3, 4, seed=10)
    bad = (_c32_emulated(skewed_sell, torch.from_numpy(x), scales, 3,
                         fault).view(np.uint32)
           != _c32_plain(skewed_sell, x, scales, 3).view(np.uint32)).any(1)
    perm = skewed_sell.perm.numpy()
    rows = perm[skewed_sell.long_from:]
    rows = rows[rows >= 0]
    assert rows.size and bad[rows].any()
    assert not np.delete(bad, rows).any()
