"""Sparse matrix containers: CSR and GSE-SEM CSR.

Port of ``repro/sparse/csr.py``: ``CSR``, ``GSECSR`` (with
``bytes_touched(tag, layout=)`` :129), ``ELLLayout`` (:173),
``GSESellC`` (:218), ``from_coo`` (:346), ``pack_csr`` (:372),
``vector_stream_bytes``, ``iteration_stream_bytes`` (:433, with
``layout=``), ``scatter_rows`` (:482), ``to_ell`` (:528), ``ell_layout``
(:543), ``sell_slices`` (:558) and ``pack_sell`` (:610).  The byte
models take an int tag or a per-group ``core.tagmap.TagMap``
(``GSECSR.bytes_touched`` :141-154 charges each entry at its induced tag,
``ELLLayout`` :198-207 each row at its group's tag, ``GSESellC``
:295-328 each width bucket at ``bucket_tags``, the max induced tag of its
entries; ``iteration_stream_bytes`` :468-471 charges a preconditioner at
the map's max tag).  The induced entry tags are computed on the pack's
device (:func:`entry_tags_t`, integer work, bitwise
``TagMap.entry_tags``) and the counts a map gives are kept on the pack,
keyed by the map's ``crc32``.

Paper Section III.C.1: shared-exponent indices ride the top ``EI_BIT``
bits of the 32-bit column indices, so the SEM head keeps all 15 non-sign
bits as mantissa.  Packing runs on the host in numpy (bit-for-bit the
reference packer); the containers hold torch tensors on ``device``.
The port's own kernel plans ride the packs, built once at pack time:
``GSECSR.row_plan`` (:func:`csr_row_plan`, kernel A64's body per row)
and ``GSESellC.long_from`` (:func:`sell_long_from`, B64's and C′64's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import gse, precision_table
from repro_torch.core.tagmap import TagMap

__all__ = [
    "CSR",
    "GSECSR",
    "RowPlan",
    "csr_row_plan",
    "ELLLayout",
    "GSESellC",
    "from_coo",
    "pack_csr",
    "to_ell",
    "ell_layout",
    "sell_slices",
    "pack_sell",
    "scatter_rows",
    "iteration_stream_bytes",
    "vector_stream_bytes",
    "entry_tags_t",
]

_SLOT_BYTES = precision_table.SLOT_BYTES


def _int_tag(tag) -> int:
    """``tag`` as an int, where a per-group map has no meaning (a per-nnz
    rate); ``bytes_touched`` is what charges a ``TagMap``."""
    if isinstance(tag, bool) or not isinstance(tag, (int, np.integer)):
        raise TypeError(f"an int tag is needed here, got "
                        f"{type(tag).__name__}; bytes_touched(tm) charges a "
                        "TagMap")
    return int(tag)


def entry_tags_t(tm: TagMap, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """``tm.entry_tags(rows, cols)`` on the device of ``rows``: each
    entry's induced tag, the max of its row's and its column's group tags
    (int32; exact integer work, so bitwise the host's)."""
    tags = torch.from_numpy(tm.tags.astype(np.int32)).to(rows.device)
    last = tm.n_groups - 1
    gr = torch.clamp(rows.to(torch.int64) // tm.group_size, max=last)
    gc = torch.clamp(cols.to(torch.int64) // tm.group_size, max=last)
    return torch.maximum(tags[gr], tags[gc])


def _col_of(colpak: torch.Tensor, ei_bit: int) -> torch.Tensor:
    """The column field of packed ``colpak`` entries (uint32, or their
    int32 view), int64."""
    return colpak.to(torch.int64) & ((1 << (32 - ei_bit)) - 1)


def _map_cached(obj, key, build):
    """Memoize a map-derived value on ``obj`` under ``key`` (which holds
    the map's ``crc32``)."""
    cache = obj.__dict__.setdefault("_map_cache", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


@dataclasses.dataclass
class CSR:
    rowptr: torch.Tensor   # (m+1,) int32
    col: torch.Tensor      # (nnz,) int32
    val: torch.Tensor      # (nnz,) float64
    row_ids: torch.Tensor  # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.val.device

    def bytes_per_nnz(self, store_dtype=torch.float64) -> int:
        """Modeled bytes streamed per nonzero by one SpMV: value + colidx."""
        return store_dtype.itemsize + 4

    def bytes_touched(self, store_dtype=torch.float64) -> int:
        """Modeled HBM bytes one SpMV touches in the matrix streams:
        value + colidx per nnz plus the rowptr stream (dense x/y traffic
        is format-independent and excluded)."""
        return self.nnz * self.bytes_per_nnz(store_dtype) + int(self.rowptr.numel()) * 4


@dataclasses.dataclass
class RowPlan:
    """Which body of kernel A64 (``csrc/gse_spmv.cu``) runs each CSR row,
    by :func:`csr_row_plan`: every row is in exactly one of the three.

    ``long_rows`` -- rows of at least ``A64_BLOCK_LEN`` entries, a block
    each; ``warp_rows`` -- rows of ``A64_WARP_LEN`` up to that, a warp
    each; ``row_blocks`` -- ``(n_blocks, 2)`` ``[first row, end row)`` runs
    of consecutive shorter rows, at most ``ROW_BLOCK_ROWS`` rows and
    ``ROW_BLOCK_SLOTS`` entries a run, one block each.  All int32 on the
    operand's device.  ``rows`` is the row count of the CSR the plan was
    built for; A64 refuses a plan of another.  A plan that leaves rows out
    (``chip_smoke.py`` times the bodies apart that way) leaves their
    outputs unwritten: it is for timing only.
    """

    long_rows: torch.Tensor   # (n_long,) int32
    warp_rows: torch.Tensor   # (n_warp,) int32
    row_blocks: torch.Tensor  # (n_blocks, 2) int32
    rows: int


@dataclasses.dataclass
class GSECSR:
    """CSR with GSE-SEM values; expIdx lives in the top bits of ``colpak``.

    Port-private, derived at pack time: ``row_plan`` -- the
    :class:`RowPlan` kernel A64 launches by (:func:`csr_row_plan` of
    ``rowptr``); the reference has no counterpart.
    """

    rowptr: torch.Tensor   # (m+1,) int32
    colpak: torch.Tensor   # (nnz,) uint32: [expIdx : EI_BIT][col : 32-EI_BIT]
    head: torch.Tensor     # (nnz,) uint16: sign(1) | mantissa(15)
    tail1: torch.Tensor    # (nnz,) uint16
    tail2: torch.Tensor    # (nnz,) uint32
    table: torch.Tensor    # (k,) int32 biased+1
    row_ids: torch.Tensor  # (nnz,) int32
    ei_bit: int
    shape: Tuple[int, int]
    row_plan: RowPlan

    @property
    def m_h(self) -> int:
        # colpak carries the index -> the head spends only the sign bit.
        return 15

    @property
    def width(self) -> int:
        return self.m_h + 48

    @property
    def nnz(self) -> int:
        return int(self.colpak.shape[0])

    @property
    def device(self) -> torch.device:
        return self.colpak.device

    def nbytes(self, tag: int) -> int:
        per = precision_table.TAG_VALUE_BYTES[tag]
        return self.nnz * per + int(self.table.numel()) * 4

    def bytes_per_nnz(self, tag: int) -> int:
        """Modeled bytes streamed per nonzero by a tag-``tag`` SpMV:
        2/4/8 value bytes + 4 packed-colidx bytes -> 6/8/12."""
        pt = precision_table
        return pt.TAG_VALUE_BYTES[tag] + pt.COLIDX_BYTES

    def bytes_touched(self, tag, layout=None) -> int:
        """Modeled HBM bytes one tag-``tag`` SpMV touches in the matrix
        streams: per-nnz segments + rowptr + the shared-exponent table.
        Dense x/y traffic is format-independent and excluded.  A packed
        ``layout`` (``GSESellC`` or ``ELLLayout``) charges the padded
        slots that layout streams instead.  A ``TagMap`` charges each
        entry at its induced tag (what the masked operand holds); a
        uniform map gives the int tag's figure."""
        if layout is not None:
            return layout.bytes_touched(tag)
        fixed = int(self.rowptr.numel()) * 4 + int(self.table.numel()) * 4
        if isinstance(tag, TagMap):
            counts = self.entry_tag_counts(tag)
            return fixed + sum(counts[t] * self.bytes_per_nnz(t)
                               for t in (1, 2, 3))
        return self.nnz * self.bytes_per_nnz(_int_tag(tag)) + fixed

    def on_host(self) -> "GSECSR":
        """This pack with its arrays on the host (the pack itself on the
        CPU), copied once and kept on the pack: the host planner
        (``core.precision``) reads it."""
        if self.colpak.device.type == "cpu":
            return self
        return _map_cached(self, ("host",), lambda: dataclasses.replace(
            self, **{f: getattr(self, f).cpu() for f in (
                "rowptr", "colpak", "head", "tail1", "tail2", "table",
                "row_ids")}))

    def entry_tags(self, tm: TagMap) -> torch.Tensor:
        """Each entry's induced tag under ``tm`` (int32, CSR order, on the
        pack's device)."""
        return entry_tags_t(tm, self.row_ids, _col_of(self.colpak,
                                                      self.ei_bit))

    def entry_tag_counts(self, tm: TagMap) -> dict:
        """``{tag: entries}`` of the induced tags under ``tm``, kept on
        the pack under the map's crc32."""
        def build():
            c = torch.bincount(self.entry_tags(tm), minlength=4).tolist()
            return {t: int(c[t]) for t in (1, 2, 3)}

        return _map_cached(self, ("entry_tag_counts", tm.crc32,
                                  tm.group_size), build)


@dataclasses.dataclass(frozen=True)
class ELLLayout:
    """Padding descriptor of the uniform-ELL pack: every row padded to the
    longest row's lane-aligned width.  ``bytes_touched(tag)`` charges every
    padded slot (value segments + packed colidx) plus the shared-exponent
    table; ``padding_ratio`` is the wasted fraction."""

    rows: int           # padded row count
    width: int          # lane-aligned uniform row width L
    nnz: int            # real stored entries
    table_entries: int  # shared-exponent table length

    @property
    def slots(self) -> int:
        return self.rows * self.width

    @property
    def padding_ratio(self) -> float:
        """Fraction of streamed slots that are padding, in [0, 1)."""
        return 1.0 - self.nnz / max(self.slots, 1)

    def bytes_touched(self, tag) -> int:
        """A ``TagMap`` charges each row's padded slots at its group's tag
        (the row-side model, as the reference's)."""
        if isinstance(tag, TagMap):
            rt = tag.row_tags(self.rows)
            per = np.array([0] + [_SLOT_BYTES[t] for t in (1, 2, 3)],
                           np.int64)
            return (int(per[rt].sum()) * self.width
                    + self.table_entries * 4)
        return self.slots * _SLOT_BYTES[_int_tag(tag)] + self.table_entries * 4


@dataclasses.dataclass
class GSESellC:
    """Sliced-ELL (SELL-C-sigma) view of a :class:`GSECSR`.

    Rows are sorted by descending length inside windows of ``sigma`` rows,
    grouped into slices of ``c`` rows, and each slice is padded only to its
    own lane-aligned width; slices are binned by width into a few buckets,
    each stored as dense row-major ``(rows_b, w_b)`` segment arrays (the
    reference's arrays, bit for bit).  ``gather`` addresses every CSR-order
    entry inside the concatenated buckets, ``perm`` is the original row of
    each concatenated bucket row (-1: slice padding) and ``unperm`` its
    inverse.  Padded slots hold colpak 0 and head 0.

    Port-private, derived at pack time and not charged by the byte model:
    ``segments`` -- the flat ``(slots,)`` colpak/head/tail1/tail2 arrays the
    bucket tuples are views of, which one kernel launch walks for every
    bucket; ``bucket_table`` -- ``(n_buckets, 3)`` int64 rows ``[first
    bucket row, width, flat slot offset]``; ``row_len`` -- each bucket
    row's real entry count, ``rowptr``'s row lengths at ``perm`` (0 for
    padding rows), so the f64 kernels walk only real slots; ``long_from``
    -- :func:`sell_long_from` of the buckets, the first bucket row that
    kernels B64 and C′64 run with a block of its own.
    """

    colpak: tuple   # per-bucket (rows_b, w_b) uint32
    head: tuple     # per-bucket (rows_b, w_b) uint16
    tail1: tuple    # per-bucket (rows_b, w_b) uint16
    tail2: tuple    # per-bucket (rows_b, w_b) uint32
    gather: torch.Tensor   # (nnz,) int32
    perm: torch.Tensor     # (rows_padded,) int32, -1 for padding rows
    unperm: torch.Tensor   # (m,) int32
    row_ids: torch.Tensor  # (nnz,) int32
    table: torch.Tensor    # (k,) int32 biased+1
    widths: Tuple[int, ...]
    c: int
    sigma: int
    lane: int
    ei_bit: int
    shape: Tuple[int, int]
    segments: tuple            # flat (slots,) colpak, head, tail1, tail2
    bucket_table: torch.Tensor  # (n_buckets, 3) int64
    row_len: torch.Tensor      # (rows_padded,) int32
    long_from: int

    @property
    def nnz(self) -> int:
        return int(self.gather.shape[0])

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def n_buckets(self) -> int:
        return len(self.widths)

    @property
    def bucket_rows(self) -> Tuple[int, ...]:
        return tuple(int(cp.shape[0]) for cp in self.colpak)

    @property
    def slots(self) -> int:
        """Padded slots stored and streamed, across all buckets."""
        return sum(r * w for r, w in zip(self.bucket_rows, self.widths))

    @property
    def padding_ratio(self) -> float:
        """Fraction of streamed slots that are padding, in [0, 1)."""
        return 1.0 - self.nnz / max(self.slots, 1)

    def bytes_per_nnz(self, tag: int) -> float:
        """Effective bytes streamed per nonzero: padded slots amortized
        over the real entries."""
        return _SLOT_BYTES[_int_tag(tag)] * self.slots / max(self.nnz, 1)

    def bucket_tags(self, tm: TagMap) -> Tuple[int, ...]:
        """Each width bucket's max induced entry tag under ``tm`` (the
        max of its real entries' row and column group tags; 1 for a bucket
        without real entries): the tag kernels B32 and C′32 run the
        bucket at.  Kept on the pack under the map's crc32."""
        def build():
            gather = self.gather.to(torch.int64)
            # (the int32 view: CUDA has no gather for uint32)
            cp = self.segments[0].view(torch.int32)[gather]
            et = entry_tags_t(tm, self.row_ids, _col_of(cp, self.ei_bit))
            offs = self.bucket_table[:, 2].contiguous()
            bidx = torch.searchsorted(offs, gather, right=True) - 1
            tags = torch.ones(self.n_buckets, dtype=torch.int32,
                              device=et.device)
            tags = tags.scatter_reduce(0, bidx, et, reduce="amax")
            return tuple(int(t) for t in tags.tolist())

        return _map_cached(self, ("bucket_tags", tm.crc32, tm.group_size),
                           build)

    def bytes_touched(self, tag) -> int:
        """Modeled HBM bytes one tag-``tag`` SpMV streams through this
        layout: every padded slot's value segments + packed colidx, the
        output row permutation and the shared-exponent table.  A
        ``TagMap`` charges each bucket's slots at its
        :meth:`bucket_tags` tag, what the mixed launch of B32 and C′32
        streams."""
        fixed = int(self.perm.shape[0]) * 4 + int(self.table.numel()) * 4
        if isinstance(tag, TagMap):
            return fixed + sum(
                r * w * _SLOT_BYTES[t] for r, w, t in zip(
                    self.bucket_rows, self.widths, self.bucket_tags(tag)))
        return self.slots * _SLOT_BYTES[_int_tag(tag)] + fixed

    def arrays(self) -> tuple:
        """Every tensor of the pack once (the bucket arrays as views of
        ``segments``): what the pack cache checksums."""
        return (*self.colpak, *self.head, *self.tail1, *self.tail2,
                self.gather, self.perm, self.unperm, self.row_ids,
                self.table, self.bucket_table, self.row_len)


def from_coo(rows, cols, vals, shape, device="cuda") -> CSR:
    """Build CSR from COO triplets (duplicates summed) on the host."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    m, n = shape
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    # Sum duplicates.
    uniq, idx = np.unique(key, return_index=True)
    sums = np.add.reduceat(vals, idx)
    rows = rows[idx]
    cols = cols[idx]
    rowptr = np.zeros(m + 1, np.int64)
    np.add.at(rowptr, rows + 1, 1)
    rowptr = np.cumsum(rowptr)
    return CSR(
        rowptr=torch.from_numpy(rowptr.astype(np.int32)).to(device),
        col=torch.from_numpy(cols.astype(np.int32)).to(device),
        val=torch.from_numpy(np.ascontiguousarray(sums)).to(device),
        row_ids=torch.from_numpy(rows.astype(np.int32)).to(device),
        shape=(int(m), int(n)),
    )


def pack_csr(a: CSR, k: int = 8) -> GSECSR:
    """CSR -> GSE-SEM CSR (paper Algorithm 1 + Section III.C.1), on the
    device of ``a``.

    The head's 15 non-sign bits are all mantissa: with expIdx in colpak
    the head-only precision gains ``EI_BIT`` bits over the dense layout.
    """
    vals = gse._np(a.val).astype(np.float64)
    table = gse.extract_shared_exponents(vals, k)
    ei = gse._ei_bit(k)
    head, tail1, tail2 = gse._pack_segments(vals, table, k)
    # Recover the full-width mantissa M (width (15-ei)+48) and expIdx.
    head = head.astype(np.uint64)
    m_h_dense = 15 - ei
    sign = (head >> np.uint64(15)) & np.uint64(1)
    exp_idx = (head >> np.uint64(m_h_dense)) & np.uint64((1 << ei) - 1)
    m_dense = (
        ((head & np.uint64((1 << m_h_dense) - 1)) << np.uint64(48))
        | (tail1.astype(np.uint64) << np.uint64(32))
        | tail2.astype(np.uint64)
    )
    # Widen to 15 + 48 = 63 bits: shift left by ei.
    m_wide = m_dense << np.uint64(ei)
    new_head = ((sign << np.uint64(15)) | (m_wide >> np.uint64(48))).astype(np.uint16)
    new_tail1 = ((m_wide >> np.uint64(32)) & np.uint64(0xFFFF)).astype(np.uint16)
    new_tail2 = (m_wide & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    col = gse._np(a.col).astype(np.uint32)
    shift = np.uint32(32 - ei)
    max_col = int(col.max()) if col.size else 0
    if max_col >= (1 << (32 - ei)):
        raise ValueError(
            f"column count {max_col} needs > {32 - ei} bits; "
            "use the value-array encoding variant (paper III.C.1)"
        )
    colpak = (exp_idx.astype(np.uint32) << shift) | col
    dev = a.device
    return GSECSR(
        rowptr=a.rowptr,
        colpak=torch.from_numpy(colpak).to(dev),
        head=torch.from_numpy(new_head).to(dev),
        tail1=torch.from_numpy(new_tail1).to(dev),
        tail2=torch.from_numpy(new_tail2).to(dev),
        table=torch.from_numpy(table.astype(np.int32)).to(dev),
        row_ids=a.row_ids,
        ei_bit=ei,
        shape=a.shape,
        row_plan=csr_row_plan(a.rowptr),
    )


# Kernel A64's bodies by row length (csrc/gse_spmv.cu): rows of at least
# A64_BLOCK_LEN entries get a block each, rows of at least A64_WARP_LEN a
# warp each, the others run in row blocks.  A row block holds at most
# ROW_BLOCK_ROWS consecutive rows and ROW_BLOCK_SLOTS entries
# (csrc/gse_rows.cuh kRowBlockRows, kRowBlockSlots; tests/
# test_torch_row_plans.py holds them equal).  The lengths are
# chip_smoke.py's width sweep (phase 10; PERF.md): on 2^22 entries of rows
# of one length, the row blocks beat the warps up to 64 entries and lose
# from 128 on; the block loses by 9-29% at 1024, ties the warp at 2048
# (within 7% either way) and wins from 4096 on; on 8 rows, where a row's
# chain is the whole call, it is ahead from 2048 on.
A64_WARP_LEN = 128
A64_BLOCK_LEN = 2048
ROW_BLOCK_SLOTS = 2048
ROW_BLOCK_ROWS = 256


def csr_row_plan(rowptr, warp_len: int = None,
                 block_len: int = None) -> RowPlan:
    """The :class:`RowPlan` of the CSR rows ``rowptr`` on its device (host
    numpy, once per pack).  ``warp_len`` and ``block_len`` default to
    ``A64_WARP_LEN`` and ``A64_BLOCK_LEN``; rows shorter than ``warp_len``
    must fit a row block, so ``warp_len <= ROW_BLOCK_SLOTS + 1``.

    Row blocks: the short rows of one run between longer rows whose first
    entries share a window of ``ROW_BLOCK_SLOTS - longest + 1`` slots
    (``longest`` the longest short row) form a block, so its entries end
    within ``ROW_BLOCK_SLOTS`` of its first one; a block of more than
    ``ROW_BLOCK_ROWS`` rows is cut into several.
    """
    warp_len = A64_WARP_LEN if warp_len is None else int(warp_len)
    block_len = A64_BLOCK_LEN if block_len is None else int(block_len)
    if not 1 <= warp_len <= block_len or warp_len > ROW_BLOCK_SLOTS + 1:
        raise ValueError(f"need 1 <= warp_len {warp_len} <= block_len "
                         f"{block_len} and warp_len <= {ROW_BLOCK_SLOTS + 1}")
    rp = np.asarray(gse._np(rowptr), np.int64)
    lens = np.diff(rp)
    is_long = lens >= block_len
    is_warp = ~is_long & (lens >= warp_len)
    is_short = ~(is_long | is_warp)
    short = np.flatnonzero(is_short)
    blocks = np.zeros((0, 2), np.int64)
    if short.size:
        span = ROW_BLOCK_SLOTS - int(lens[short].max()) + 1
        run = np.cumsum(~is_short)[short]
        key = rp[short] // span
        brk = np.ones(short.size, bool)
        brk[1:] = (run[1:] != run[:-1]) | (key[1:] != key[:-1])
        starts = np.flatnonzero(brk)
        rank = np.arange(short.size) - starts[np.cumsum(brk) - 1]
        first = np.flatnonzero(rank % ROW_BLOCK_ROWS == 0)
        last = np.append(first[1:] - 1, short.size - 1)
        blocks = np.stack([short[first], short[last] + 1], axis=1)
    dev = rowptr.device if isinstance(rowptr, torch.Tensor) else "cpu"

    def i32(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)

    return RowPlan(long_rows=i32(np.flatnonzero(is_long)),
                   warp_rows=i32(np.flatnonzero(is_warp)),
                   row_blocks=i32(blocks), rows=int(lens.size))


def vector_stream_bytes(op, dtype=torch.float64) -> int:
    """Modeled HBM bytes one dense operand/result column streams: the x
    gather read plus the y write of a single SpMV at ``dtype``."""
    m, n = op.shape
    return (m + n) * dtype.itemsize


def iteration_stream_bytes(op, tag, precond=None, nrhs: int = 1,
                           layout=None) -> int:
    """Modeled HBM bytes one stepped solver iteration streams at ``tag``
    (an int or a ``TagMap``).

    The operator's matrix streams (``op.bytes_touched``) plus the
    preconditioner's stored streams at the same tag (both follow the
    monitor's schedule; ``precond.bytes_touched``), charged once per
    iteration; each right-hand-side column beyond the first charges its
    own dense x/y stream.  Without a preconditioner ``tag`` may also be a
    ``CSR`` store dtype; charging one needs a GSE tag in {1, 2, 3}.
    ``layout`` (a ``GSESellC`` or ``ELLLayout``) charges that layout's
    padded slots instead of nnz only; a ``GSESellC`` passed as ``op`` is
    already slot-honest.
    """
    if nrhs < 1:
        raise ValueError(f"nrhs must be >= 1, got {nrhs}")
    # A per-group map charges the preconditioner at the map's max tag: it
    # follows one scalar schedule, so this is the conservative account.
    ptag = tag.max_tag if isinstance(tag, TagMap) else tag
    if precond is not None and (isinstance(ptag, bool)
                                or ptag not in (1, 2, 3)):
        raise ValueError(f"preconditioner streams need a GSE tag in "
                         f"{{1, 2, 3}}, got {tag!r}")
    total = (layout if layout is not None else op).bytes_touched(tag)
    if precond is not None:
        total += precond.bytes_touched(ptag)
    total += (nrhs - 1) * vector_stream_bytes(op)
    return total


def scatter_rows(rowptr, sources, width: int, row_subset=None):
    """Scatter CSR-ordered entry streams into zero-padded (rows, width)
    numpy arrays.

    ``sources`` is a sequence of ``(array, dtype)`` pairs sharing the CSR
    entry order; each comes back as its own padded array at the requested
    dtype (padding slots are zero).  ``row_subset`` selects and orders the
    rows to scatter; ``-1`` entries are empty padding rows.

    Returns ``(outs, csr_pos, dest)``: the CSR entry indices scattered and
    their flat slots in the padded array.
    """
    rowptr = np.asarray(gse._np(rowptr), np.int64)
    per_row = np.diff(rowptr)
    if row_subset is None:
        row_subset = np.arange(per_row.size)
    row_subset = np.asarray(row_subset, np.int64)
    valid = row_subset >= 0
    safe = np.where(valid, row_subset, 0)
    lens = np.where(valid, per_row[safe], 0)
    if lens.size and int(lens.max(initial=0)) > width:
        raise ValueError(
            f"row of {int(lens.max())} entries does not fit width {width}"
        )
    total = int(lens.sum())
    starts = np.where(valid, rowptr[safe], 0)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    csr_pos = np.repeat(starts, lens) + offs
    dest = np.repeat(np.arange(row_subset.size, dtype=np.int64) * width,
                     lens) + offs
    outs = []
    for src, dtype in sources:
        out = np.zeros(row_subset.size * width, dtype)
        out[dest] = gse._np(src)[csr_pos]
        outs.append(out.reshape(row_subset.size, width))
    return outs, csr_pos, dest


def to_ell(a: CSR, lane: int = 128):
    """CSR -> padded ELL numpy arrays ``(cols[m, L], vals[m, L], L)``, L
    rounded up to ``lane``; padded entries have col=0, val=0."""
    rowptr = np.asarray(gse._np(a.rowptr), np.int64)
    L = int(max(1, np.diff(rowptr).max(initial=0)))
    L = ((L + lane - 1) // lane) * lane
    (cols, vals), _, _ = scatter_rows(
        rowptr, [(a.col, np.int32), (a.val, np.float64)], L
    )
    return cols, vals, L


def ell_layout(a, lane: int = 128) -> ELLLayout:
    """Padding descriptor of the uniform-ELL pack of ``a`` (a ``GSECSR``
    or ``CSR``): every row padded to the longest row's lane-aligned
    width."""
    per_row = np.diff(np.asarray(gse._np(a.rowptr), np.int64))
    L = int(max(1, per_row.max(initial=0)))
    L = ((L + lane - 1) // lane) * lane
    table = getattr(a, "table", None)
    return ELLLayout(rows=int(a.shape[0]), width=L, nnz=a.nnz,
                     table_entries=int(table.numel()) if table is not None
                     else 0)


def sell_slices(rowptr, c: int = 8, sigma: int | None = None,
                lane: int = 128, bucket: str = "pow2"):
    """Sigma-window sort + slice/bucket plan (host-side numpy).

    Rows are sorted by descending length inside windows of ``sigma`` rows
    (stable); consecutive runs of ``c`` sorted rows form slices.  Each
    slice's width is its longest row rounded up to ``lane`` (at least
    ``lane``); ``bucket="pow2"`` bins the widths into power-of-two lane
    multiples, ``"exact"`` keeps every distinct width.

    Returns ``(order, slice_bucket_w, sigma)``: the padded row order
    (length ``ceil(m/c)*c``, -1 marks padding rows), each slice's bucket
    width and the window actually sorted with (``None`` -> full sort,
    floor ``c``).
    """
    per_row = np.diff(np.asarray(gse._np(rowptr), np.int64))
    m = per_row.size
    if c < 1:
        raise ValueError(f"slice height c must be >= 1, got {c}")
    sigma = m if sigma is None else max(int(sigma), c)
    order = np.arange(m, dtype=np.int64)
    for w0 in range(0, m, sigma):
        win = order[w0:w0 + sigma]
        order[w0:w0 + sigma] = win[np.argsort(-per_row[win], kind="stable")]
    rows_pad = -(-max(m, 1) // c) * c
    order = np.concatenate([order, np.full(rows_pad - m, -1, np.int64)])
    lens = np.where(order >= 0, per_row[np.clip(order, 0, None)], 0)
    slice_max = lens.reshape(-1, c).max(axis=1)
    slice_w = np.maximum(-(-slice_max // lane) * lane, lane).astype(np.int64)
    if bucket == "pow2":
        bucket_w = lane * (
            2 ** np.ceil(np.log2(slice_w / lane)).astype(np.int64))
    elif bucket == "exact":
        bucket_w = slice_w
    else:
        raise ValueError(f"bucket must be 'pow2' or 'exact', got {bucket!r}")
    return order, bucket_w, sigma


# Bucket widths from which kernels B64 and C′64 (csrc/gse_sell.cu) give
# each row a block of its own.  The crossover is A64's (A64_BLOCK_LEN):
# a pow2 bucket of width 2 * A64_BLOCK_LEN holds rows of A64_BLOCK_LEN + 1
# to 2 * A64_BLOCK_LEN entries, where the width sweep's blocks tie the
# warps or win, and the one of width A64_BLOCK_LEN rows of half that up
# to it, where the warps win or tie.
B64_BLOCK_WIDTH = 2 * A64_BLOCK_LEN


def sell_long_from(widths, bucket_rows) -> int:
    """The first bucket row of the buckets at least ``B64_BLOCK_WIDTH``
    wide (the total of ``bucket_rows`` if none is): B64 and C′64 run the
    rows from there on with a block each.  ``widths`` ascend, as ``pack_sell``
    orders its buckets, so those rows are the last ones."""
    widths, bucket_rows = tuple(widths), tuple(bucket_rows)
    if len(widths) != len(bucket_rows) or list(widths) != sorted(widths):
        raise ValueError(f"widths {widths} must ascend, one per bucket of "
                         f"{bucket_rows}")
    return sum(r for w, r in zip(widths, bucket_rows)
               if w < B64_BLOCK_WIDTH)


def pack_sell(a: GSECSR, c: int = 8, sigma: int | None = None,
              lane: int = 128, bucket: str = "pow2") -> GSESellC:
    """GSE-SEM CSR -> SELL-C-sigma packed layout on ``a``'s device.

    ``c`` must be a multiple of 8 (the reference's sublane block).  The
    arrays are bit for bit the reference packer's.  Prefer
    ``kernels.ops.sell_pack_gsecsr``, which memoizes the pack on the
    operator instance.
    """
    if c % 8 != 0:
        raise ValueError(f"slice height c must be a multiple of 8, got {c}")
    m = a.shape[0]
    rowptr = np.asarray(gse._np(a.rowptr), np.int64)
    order, bucket_w, sigma_eff = sell_slices(rowptr, c=c, sigma=sigma,
                                             lane=lane, bucket=bucket)
    widths = tuple(int(w) for w in sorted(set(bucket_w.tolist())))
    names = ("colpak", "head", "tail1", "tail2")
    segs = [(getattr(a, n), d) for n, d in zip(
        names, (np.uint32, np.uint16, np.uint16, np.uint32))]
    gather = np.zeros(a.nnz, np.int64)
    perm_parts, flat_parts, table_rows = [], [], []
    row0 = flat_off = 0
    for w in widths:
        slice_ids = np.nonzero(bucket_w == w)[0]
        rows_sel = np.concatenate(
            [order[s * c:(s + 1) * c] for s in slice_ids]
        ) if slice_ids.size else np.zeros(0, np.int64)
        arrs, csr_pos, dest = scatter_rows(rowptr, segs, int(w), rows_sel)
        flat_parts.append([x.reshape(-1) for x in arrs])
        gather[csr_pos] = flat_off + dest
        perm_parts.append(rows_sel)
        table_rows.append((row0, int(w), flat_off))
        row0 += rows_sel.size
        flat_off += rows_sel.size * int(w)
    perm = (np.concatenate(perm_parts) if perm_parts
            else np.zeros(0, np.int64))
    unperm = np.zeros(m, np.int64)
    unperm[perm[perm >= 0]] = np.nonzero(perm >= 0)[0]
    row_len = np.where(perm >= 0, np.diff(rowptr)[np.maximum(perm, 0)], 0)
    dev = a.device
    flat = tuple(
        torch.from_numpy(np.concatenate([p[i] for p in flat_parts])
                         if flat_parts else np.zeros(0, d)).to(dev)
        for i, (_, d) in enumerate(segs))
    views = [[], [], [], []]
    for (r0, w, off), rows_b in zip(table_rows, map(len, perm_parts)):
        for i, f in enumerate(flat):
            views[i].append(f[off:off + rows_b * w].view(rows_b, w))

    def i32(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)

    return GSESellC(
        colpak=tuple(views[0]), head=tuple(views[1]),
        tail1=tuple(views[2]), tail2=tuple(views[3]),
        gather=i32(gather), perm=i32(perm), unperm=i32(unperm),
        row_ids=a.row_ids, table=a.table, widths=widths, c=c,
        sigma=int(sigma_eff), lane=lane, ei_bit=a.ei_bit, shape=a.shape,
        segments=flat,
        bucket_table=torch.tensor(table_rows, dtype=torch.int64,
                                  device=dev).reshape(-1, 3),
        row_len=i32(row_len),
        long_from=sell_long_from(widths, [len(p) for p in perm_parts]),
    )
