"""Public wrappers around the SpMV and SpMM kernels: ELL packing, the pack
cache and the tag-specialized dispatch.

Port of ``repro/kernels/ops.py``: ``_cached_pack`` (:72),
``ell_pack_gsecsr`` (:172; the port keeps each row's real slot count
beside it, :func:`ell_row_lengths`), ``sell_pack_gsecsr`` (:198),
``spmv_kernel_for`` (:349), ``spmm_kernel_for`` (:387), ``gse_spmm_ell``
(:427), ``sell_kernel_for`` (:535), ``sell_spmm_kernel_for`` (:558),
``_sell_buckets`` (:572), ``gse_spmv_sell`` (:613), ``gse_spmm_sell``
(:637), ``gse_spmv_ell`` (:660), ``planned_spmv`` (:458) and
``planned_spmm`` (:494); the dense kernels' wrappers ``gse_decode``
(:120, kernel D) and ``gse_matmul`` (:142, kernel E).  The reference pads
rows to its (8, 128) grid block; the CUDA kernels take any row count, so
only the lane width (128, the default plan's) is padded.

Launch plans (``perf.plan``): every SpMV/SpMM entry point resolves
explicit ``blocks=``, then ``plan=``, then (for an operand in hand) the
tuned cache, then ``DEFAULT_PLAN``, which launches today's kernels bit
for bit.  A plan's ``lanes`` picks the lanes a row of A32 and C32 runs on
(``lanes=`` wins over it), ``lane`` the ELL and SELL pack alignment, and
``sell_c``/``sell_sigma``/``sell_bucket`` the SELL pack.  ``blocks`` is
the reference's Pallas grid: it is checked as the reference checks it (a
SELL pack it cannot tile raises ValueError; a tuned plan falls back) and
chooses no launch, as ``block=``/``blocks=`` of kernels D and E do.
``PACK_STATS`` is a dict-shaped view over the
metrics registry's ``repro_pack_cache_events_total`` (``obs.metrics``),
and a cache miss's build runs inside a ``pack.build`` span.

Per-group precision (``masked_for_tagmap`` :250 with its SELL twin :222,
``sell_bucket_tags`` :291, and the map case of ``gse_spmv_sell`` and
``gse_spmm_sell``, :306-346): a ``TagMap`` is applied by zeroing each
entry's tail segments below its induced tag, on the pack's device with
integer ``torch.where`` (bitwise the reference's numpy masking); the
masked pack shares every array but ``tail1``/``tail2`` with the operand,
the port's kernel plans included, and is cached on the operand under
``("tagmap", crc32, group_size)``.  The reference runs one Pallas call
per SELL bucket at the bucket's tag (``_sell_mixed_cached``) over the
caller's (masked) pack; here one mixed launch of B32 (C′32) covers every
bucket, each at its ``sell_bucket_tags`` tag (a host tuple kept on the
pack; buckets all at one tag run the uniform launch).
"""
from __future__ import annotations

import dataclasses
import functools
import zlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.precision_table import TAG_BITS_USED
from repro_torch.kernels import ref
from repro_torch.core.gse import _F64_FRAC, GSEPacked
from repro_torch.core.precision_table import TAG_SEGMENTS
from repro_torch.kernels.gse_decode import gse_decode_dense
from repro_torch.kernels.gse_matmul import gse_matmul_dense
from repro_torch.kernels.gse_spmm import gse_spmm_ell_f32, gse_spmm_sell_f32
from repro_torch.kernels.gse_spmv import (ELL_LANES_DEFAULT, gse_spmv_ell_f32,
                                          gse_spmv_sell_f32)
from repro_torch.core.tagmap import TagMap
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.perf import plan as launch_plan
from repro_torch.perf.plan import KernelPlan
from repro_torch.sparse.csr import (GSECSR, GSESellC, _col_of, _int_tag,
                                    entry_tags_t, pack_sell, scatter_rows)

__all__ = ["gse_decode", "gse_matmul", "gse_spmv_ell", "gse_spmm_ell",
           "ell_pack_gsecsr", "ell_row_lengths", "sell_pack_gsecsr",
           "gse_spmv_sell", "gse_spmm_sell", "spmv_kernel_for",
           "spmm_kernel_for", "sell_kernel_for", "sell_spmm_kernel_for",
           "planned_spmv", "planned_spmm", "masked_for_tagmap",
           "sell_bucket_tags", "PACK_STATS", "PACK_CACHE_MAX", "LANE", "SELL_C",
           "SELL_SIGMA", "SELL_BUCKET"]

# Operand-pack cache accounting: ``hits``/``misses`` let callers assert
# that repeated solves re-pack nothing; ``evictions`` counts LRU drops and
# ``corrupt`` counts checksum-mismatch detect-and-repack events.  The
# counts live in the metrics registry; the dict-shaped view keeps every
# call site working.
PACK_STATS = OM.stats_view(
    "repro_pack_cache_events_total",
    ("hits", "misses", "evictions", "corrupt"),
    help="Operand pack-cache events by outcome.",
)

# Per-operator-instance LRU bound on cached packed layouts.
PACK_CACHE_MAX = 8

# The default launch plan's pack parameters: the ELL and SELL lane
# alignment, and SELL's slice height, sort window (None: a full sort) and
# width-bucket granularity.
LANE = launch_plan.DEFAULT_PLAN.lane
SELL_C = launch_plan.DEFAULT_PLAN.sell_c
SELL_SIGMA = launch_plan.DEFAULT_PLAN.sell_sigma
SELL_BUCKET = launch_plan.DEFAULT_PLAN.sell_bucket


def _sell_tag(tag) -> int:
    tag = _int_tag(tag)
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    return tag


def _leaves(entry):
    if getattr(entry, "__dict__", {}).get("_masked"):
        # A masked view (masked_for_tagmap) owns only its tails; the rest
        # is the operand's, checked under the operand's own key.
        entry = (entry.segments[2:] if isinstance(entry, GSESellC)
                 else (entry.tail1, entry.tail2))
    elif isinstance(entry, GSESellC):
        entry = entry.arrays()
    if isinstance(entry, (tuple, list)):
        for e in entry:
            yield from _leaves(e)
    else:
        yield entry


def _entry_checksum(entry) -> int:
    """CRC32 over every array leaf of a packed-operand entry, computed at
    build time and re-verified on every cache hit so a silently corrupted
    pack is rebuilt instead of feeding garbage segments to every solve."""
    ck = 0
    for leaf in _leaves(entry):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        ck = zlib.crc32(np.ascontiguousarray(leaf).tobytes(), ck)
    return ck


def _cached_pack(a, key, build):
    """Memoize a packed-operand build on the operator instance itself.

    Entries are ``(packed, crc32)`` in an LRU ``OrderedDict`` bounded by
    :data:`PACK_CACHE_MAX`; a hit re-verifies the checksum and a mismatch
    counts in ``PACK_STATS['corrupt']`` and triggers a repack.
    """
    cache = a.__dict__.setdefault("_pack_cache", OrderedDict())
    hit = key in cache
    if hit:
        entry, ck = cache[key]
        if _entry_checksum(entry) != ck:
            PACK_STATS["corrupt"] += 1
            hit = False  # detected corruption: fall through to repack
        else:
            PACK_STATS["hits"] += 1
            cache.move_to_end(key)
    if not hit:
        PACK_STATS["misses"] += 1
        with OT.span("pack.build", key=str(key)):
            entry = build()
        cache[key] = (entry, _entry_checksum(entry))
        cache.move_to_end(key)
        while len(cache) > PACK_CACHE_MAX:
            cache.popitem(last=False)
            PACK_STATS["evictions"] += 1
    return entry


_SEGMENT_DTYPES = (
    ("colpak", np.uint32),
    ("head", np.uint16),
    ("tail1", np.uint16),
    ("tail2", np.uint32),
)


def ell_pack_gsecsr(a: GSECSR, lane: int | None = None,
                    plan: KernelPlan | None = None):
    """GSE-SEM CSR -> padded uniform-ELL segment tensors for the SpMV
    kernel, on ``a``'s device.

    Returns ``(colpak, head, tail1, tail2)``, each (rows, L) with L the
    longest row rounded up to ``lane`` (explicit argument, then ``plan``,
    then the default 128).  Padded slots hold colpak=0 and head=0
    (mantissa 0 -> decodes to +0.0).  Memoized on the operator instance:
    repeat callers re-scatter nothing.
    """
    if lane is None:
        lane = (plan or launch_plan.DEFAULT_PLAN).lane

    def build():
        rowptr = np.asarray(a.rowptr.cpu().numpy(), np.int64)
        L = int(max(1, np.diff(rowptr).max(initial=0)))
        L = ((L + lane - 1) // lane) * lane
        outs, _, _ = scatter_rows(
            rowptr, [(getattr(a, n), d) for n, d in _SEGMENT_DTYPES], L
        )
        return tuple(torch.from_numpy(o).to(a.device) for o in outs)

    return _cached_pack(a, ("ell", lane), build)


def ell_row_lengths(a: GSECSR) -> torch.Tensor:
    """Each row's real slot count in ``ell_pack_gsecsr``'s arrays (at any
    lane width): ``diff(rowptr)`` as a (rows,) int32 tensor on ``a``'s
    device, the ``row_len=`` of kernels A32 and C32, which read no slot
    past it.  Memoized on the operator instance beside the pack."""
    return _cached_pack(
        a, ("ell_row_len",),
        lambda: (a.rowptr[1:] - a.rowptr[:-1]).to(torch.int32).contiguous())


def sell_pack_gsecsr(a: GSECSR, c: int | None = None,
                     sigma: int | None = None, lane: int | None = None,
                     bucket: str | None = None,
                     plan: KernelPlan | None = None) -> GSESellC:
    """GSE-SEM CSR -> SELL-C-sigma packed layout on ``a``'s device,
    memoized on the operator instance under ``("sell", c, sigma, lane,
    bucket)``.  Each parameter resolves explicit argument, then ``plan``,
    then the default plan (C=8, a full sort, lane 128, pow2 width
    buckets)."""
    base = plan or launch_plan.DEFAULT_PLAN
    c = base.sell_c if c is None else c
    sigma = base.sell_sigma if sigma is None else sigma
    lane = base.lane if lane is None else lane
    bucket = base.sell_bucket if bucket is None else bucket
    return _cached_pack(
        a, ("sell", c, sigma, lane, bucket),
        lambda: pack_sell(a, c=c, sigma=sigma, lane=lane, bucket=bucket))


def _masked_tails(tail1, tail2, et):
    """``tail1``/``tail2`` with the segments below each entry's induced
    tag ``et`` zeroed (integer ``torch.where`` on the signed views of the
    unsigned segments, so the bits are the reference's)."""
    t1 = torch.where(et >= 2, tail1.view(torch.int16),
                     0).view(torch.uint16)
    t2 = torch.where(et >= 3, tail2.view(torch.int32),
                     0).view(torch.uint32)
    return t1, t2


def _mark_masked(view):
    """Mark a masked view, so the pack cache checksums only its tails."""
    view.__dict__["_masked"] = True
    return view


def _masked_sell_for_tagmap(sell: GSESellC, tm: TagMap) -> GSESellC:
    """``GSESellC`` twin of :func:`masked_for_tagmap`: the flat tails
    masked slot by slot at the induced tag (max of the slot row's and its
    column's group tags; a padding slot's tails are already zero)."""

    def build():
        n = sell.shape[0]
        dev = sell.table.device
        cp, hd, t1, t2 = sell.segments
        widths = torch.zeros(sell.perm.shape[0], dtype=torch.int64,
                             device=dev)
        for r0, w in sell.bucket_table[:, :2].tolist():
            widths[r0:] = w  # buckets ascend by first row
        perm = sell.perm.to(torch.int64)
        rows = torch.repeat_interleave(perm, widths)
        # A padding row's slots take row n - 1's group; they hold zeros.
        rows = torch.where(rows >= 0, rows, n - 1)
        cols = torch.clamp(_col_of(cp, sell.ei_bit), max=n - 1)
        m1, m2 = _masked_tails(t1, t2, entry_tags_t(tm, rows, cols))
        views = ([], [])
        for (_, w, off), rows_b in zip(sell.bucket_table.tolist(),
                                       sell.bucket_rows):
            for flat, out in zip((m1, m2), views):
                out.append(flat[off:off + rows_b * w].view(rows_b, w))
        return _mark_masked(dataclasses.replace(
            sell, tail1=tuple(views[0]), tail2=tuple(views[1]),
            segments=(cp, hd, m1, m2)))

    return _cached_pack(sell, ("tagmap", tm.crc32, tm.group_size), build)


def masked_for_tagmap(a, tm: TagMap):
    """Per-group-precision view of ``a`` (a ``GSECSR`` or a ``GSESellC``):
    the tail segments below each entry's induced tag -- the max of its
    row's and its column's group tags, so a masked SPD operand stays
    exactly symmetric -- are zeroed.

    Decoding the masked operand at the map's max tag is bitwise decoding
    each entry at its own tag: a zeroed segment adds exactly 0 and the
    partial mantissa times the max tag's power-of-two scale is the lower
    tag's decode exactly.  So every kernel over the packed operand (A64,
    B64, C64, C′64, B32 and C′32) applies a map with no new body.  The
    view shares every array but ``tail1``/``tail2`` with ``a`` (the row
    plan and the SELL plans too) and is cached on ``a`` under the map's
    crc32, so a promoted map never hits a stale view."""
    if isinstance(a, GSESellC):
        return _masked_sell_for_tagmap(a, tm)

    def build():
        t1, t2 = _masked_tails(a.tail1, a.tail2, a.entry_tags(tm))
        return _mark_masked(dataclasses.replace(a, tail1=t1, tail2=t2))

    return _cached_pack(a, ("tagmap", tm.crc32, tm.group_size), build)


def sell_bucket_tags(sell: GSESellC, tm: TagMap) -> tuple:
    """Each width bucket's max induced tag under ``tm`` (``sell.bucket_tags``,
    kept on the pack under the map's crc32): the host tuple the mixed
    launch of B32 and C′32 takes as ``bucket_tags``.

    A bucket runs at its tag: an all-tag-1 bucket reads no tail, and an
    entry of a mixed bucket whose groups ask less carries zeroed tails
    (the operand must come from :func:`masked_for_tagmap`), so the bucket
    tag changes the bytes streamed, never the values."""
    return sell.bucket_tags(tm)


def _scales_by_tag(table) -> torch.Tensor:
    """The ``(3, k)`` f32 decode scales of tags 1-3, a row each."""
    return torch.stack([ref.make_scales(table, TAG_BITS_USED[t]).reshape(-1)
                        for t in (1, 2, 3)])


def _sell_scales(sell: GSESellC) -> torch.Tensor:
    """``_scales_by_tag(sell.table)``, made once per pack: its ~50 small
    launches would cost the host more than one SpMV takes on the card."""
    scales = sell.__dict__.get("_scales_by_tag")
    if scales is None:
        scales = sell.__dict__["_scales_by_tag"] = _scales_by_tag(sell.table)
    return scales


def spmv_kernel_for(tag: int, ei_bit: int, blocks=None):
    """Tag-specialized SpMV dispatch, cached per ``(tag, ei_bit,
    blocks)``: the returned callable takes exactly the operands ``tag``
    streams -- ``(colpak, head, x, scales)`` for tag 1, ``+ tail1`` for
    tag 2, ``+ tail2`` for tag 3 -- so the tag-1/-2 launches never touch
    the tail arrays, the rows' real slot counts as ``row_len=`` (required
    on the card, :func:`ell_row_lengths`) and the lanes a row runs on as
    ``lanes=``.  ``blocks`` (the reference's grid tile) chooses no launch:
    every ``blocks``, ``None`` included, gives the same callable."""
    return _spmv_kernel_cached(tag, ei_bit)


@functools.lru_cache(maxsize=None)
def _spmv_kernel_cached(tag: int, ei_bit: int):
    if tag == 1:
        def call(colpak, head, x, scales, *, row_len=None,
                 lanes=ELL_LANES_DEFAULT):
            return gse_spmv_ell_f32(colpak, head, None, None, x, scales,
                                    ei_bit=ei_bit, tag=1, row_len=row_len,
                                    lanes=lanes)
    elif tag == 2:
        def call(colpak, head, tail1, x, scales, *, row_len=None,
                 lanes=ELL_LANES_DEFAULT):
            return gse_spmv_ell_f32(colpak, head, tail1, None, x, scales,
                                    ei_bit=ei_bit, tag=2, row_len=row_len,
                                    lanes=lanes)
    elif tag == 3:
        def call(colpak, head, tail1, tail2, x, scales, *, row_len=None,
                 lanes=ELL_LANES_DEFAULT):
            return gse_spmv_ell_f32(colpak, head, tail1, tail2, x, scales,
                                    ei_bit=ei_bit, tag=3, row_len=row_len,
                                    lanes=lanes)
    else:
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    return call


def _ell_operands(ell, tag: int) -> list:
    """The ELL segments ``tag`` streams: ``colpak, head[, tail1[, tail2]]``."""
    colpak, head, t1, t2 = ell
    return [colpak, head] + [t1, t2][:len(TAG_SEGMENTS[tag])]


def gse_spmv_ell(ell, table, x: torch.Tensor, ei_bit: int, tag: int = 1,
                 blocks=None, plan: KernelPlan | None = None, *,
                 row_len=None, lanes: int | None = None) -> torch.Tensor:
    """y = A @ x (f32) from ELL-packed GSE-SEM segments (kernel A32).

    Only the segment arrays ``tag`` reads are passed, and of each row only
    its ``row_len`` real slots (required on the card: the operator's
    :func:`ell_row_lengths`) are streamed: ``GSECSR.bytes_touched(tag)``
    gives the modeled per-call matrix bytes (6/8/12 per nnz for tags 1/2/3
    vs 12 for FP64 CSR).  The launch resolves explicit ``blocks``, then
    ``plan``, then the default plan; the plan's ``lanes`` (unless
    ``lanes=`` is given) is the lanes a row runs on.
    """
    resolved = launch_plan.resolve(blocks=blocks, plan=plan)
    lanes = resolved.lanes if lanes is None else lanes
    scales = ref.make_scales(table, TAG_BITS_USED[tag])
    return spmv_kernel_for(tag, ei_bit)(
        *_ell_operands(ell, tag), x, scales, row_len=row_len, lanes=lanes)


def spmm_kernel_for(tag: int, ei_bit: int, blocks=None):
    """Tag-specialized SpMM dispatch, the multi-RHS twin of
    :func:`spmv_kernel_for`: the returned callable takes exactly the
    operands ``tag`` streams -- ``(colpak, head, x, scales)`` for tag 1,
    ``+ tail1`` for tag 2, ``+ tail2`` for tag 3 -- with ``x`` an
    ``(n, nrhs)`` row-major block, and the keywords ``row_len=`` (required
    on the card), ``lanes=`` and ``device=`` (default ``"cuda"``).  The
    segments are streamed once for every pass of four columns.
    ``blocks`` chooses no launch, as in :func:`spmv_kernel_for`."""
    return _spmm_kernel_cached(tag, ei_bit)


@functools.lru_cache(maxsize=None)
def _spmm_kernel_cached(tag: int, ei_bit: int):
    if tag == 1:
        def call(colpak, head, x, scales, *, row_len=None,
                 lanes=ELL_LANES_DEFAULT, device="cuda"):
            return gse_spmm_ell_f32(colpak, head, None, None, x, scales,
                                    ei_bit=ei_bit, tag=1, row_len=row_len,
                                    lanes=lanes, device=device)
    elif tag == 2:
        def call(colpak, head, tail1, x, scales, *, row_len=None,
                 lanes=ELL_LANES_DEFAULT, device="cuda"):
            return gse_spmm_ell_f32(colpak, head, tail1, None, x, scales,
                                    ei_bit=ei_bit, tag=2, row_len=row_len,
                                    lanes=lanes, device=device)
    elif tag == 3:
        def call(colpak, head, tail1, tail2, x, scales, *, row_len=None,
                 lanes=ELL_LANES_DEFAULT, device="cuda"):
            return gse_spmm_ell_f32(colpak, head, tail1, tail2, x, scales,
                                    ei_bit=ei_bit, tag=3, row_len=row_len,
                                    lanes=lanes, device=device)
    else:
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    return call


def gse_spmm_ell(ell, table, x: torch.Tensor, ei_bit: int, tag: int = 1,
                 blocks=None, plan: KernelPlan | None = None, *,
                 row_len=None, lanes: int | None = None,
                 device="cuda") -> torch.Tensor:
    """Y = A @ X (f32, ``(m, nrhs)``) from ELL-packed GSE-SEM segments
    (kernel C32), X a dense ``(n, nrhs)`` block as in the reference, read
    as it lies (a contiguous copy only if it is not row-major f32).

    Only the segment arrays ``tag`` reads are passed, and of each row only
    its ``row_len`` real slots (required on the card: the operator's
    :func:`ell_row_lengths`), streamed once for every pass of four
    columns: ``iteration_stream_bytes(a, tag, nrhs=nrhs)`` is the modeled
    traffic.  The launch resolves as :func:`gse_spmv_ell`'s does.
    """
    if x.dim() != 2:
        raise ValueError(f"gse_spmm_ell wants a (n, nrhs) block; got "
                         f"{tuple(x.shape)}")
    resolved = launch_plan.resolve(blocks=blocks, plan=plan)
    lanes = resolved.lanes if lanes is None else lanes
    scales = ref.make_scales(table, TAG_BITS_USED[tag])
    return spmm_kernel_for(tag, ei_bit)(
        *_ell_operands(ell, tag), x.to(torch.float32).contiguous(), scales,
        row_len=row_len, lanes=lanes, device=device)


def _sell_buckets(sell: GSESellC, tag: int):
    """Per-bucket operand tuples holding only the segments ``tag`` reads
    (``TAG_SEGMENTS`` is the one source of truth for the tail list)."""
    segs = (sell.colpak, sell.head) + tuple(
        getattr(sell, name) for name in TAG_SEGMENTS[tag])
    return tuple(zip(*segs))


@functools.lru_cache(maxsize=None)
def _sell_dispatch(kernel, tag: int, ei_bit: int):
    """Shared body of ``sell_kernel_for``/``sell_spmm_kernel_for``: the
    returned callable takes the tag's flat segments ``(colpak, head[,
    tail1[, tail2]])`` positionally, then ``x, scales`` and the layout
    keywords ``buckets``, ``perm``, ``rows`` (and the kernel's own)."""
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")

    def call(*args, **kw):
        segs, (x, scales) = args[:-2], args[-2:]
        if len(segs) != 2 + len(TAG_SEGMENTS[tag]):
            raise TypeError(f"tag {tag} takes {2 + len(TAG_SEGMENTS[tag])} "
                            f"segment arrays, got {len(segs)}")
        full = tuple(segs) + (None,) * (4 - len(segs))
        return kernel(*full, x, scales, ei_bit=ei_bit, tag=tag, **kw)

    return call


def sell_kernel_for(tag: int, ei_bit: int, blocks=None):
    """Tag-specialized SELL-C-sigma SpMV dispatch (kernel B32), the twin of
    :func:`spmv_kernel_for`: the callable takes exactly the flat segments
    ``tag`` streams -- ``(colpak, head)`` for tag 1, ``+ tail1`` for tag 2,
    ``+ tail2`` for tag 3 -- then ``x, scales`` and the keywords
    ``buckets``, ``perm``, ``rows`` (and, on the card, ``long_from``).  One
    launch covers every bucket.  ``blocks`` (the reference's grid tile)
    chooses no launch: every ``blocks``, ``None`` included, gives the same
    callable."""
    return _sell_dispatch(gse_spmv_sell_f32, tag, ei_bit)


def sell_spmm_kernel_for(tag: int, ei_bit: int, blocks=None):
    """Multi-RHS twin of :func:`sell_kernel_for` (kernel C′32): ``x`` is an
    ``(n, nrhs)`` row-major block, and the keywords ``long_from`` (on the
    card) and ``device=`` (default ``"cuda"``) follow the layout
    keywords; ``blocks`` chooses no launch."""
    return _sell_dispatch(gse_spmm_sell_f32, tag, ei_bit)


def _check_sell_blocks(sell: GSESellC, blocks) -> None:
    """The reference's check of a grid tile against a SELL pack (its
    ``ops.py:580``): the slice height must be a multiple of BM and every
    bucket width of BL.  The card's kernels have no such grid."""
    bm, bl = blocks
    if sell.c % bm != 0:
        raise ValueError(
            f"slice height {sell.c} must be a multiple of the row block "
            f"{bm} (bucket rows are not re-padded: that would desync the "
            "row permutation)")
    if any(w % bl != 0 for w in sell.widths):
        raise ValueError(
            f"bucket widths {sell.widths} must be multiples of the lane "
            f"block {bl}")


def _resolve_sell_blocks(sell: GSESellC, tag, nrhs: int, blocks,
                         plan: KernelPlan | None) -> None:
    """SELL launch-block resolution as the reference's, for its checks
    (the blocks choose no launch): explicit arguments are checked and
    raise; a tuned plan recorded for another pack (its C or widths do not
    tile this one) falls back to the default."""
    if blocks is not None or plan is not None:
        resolved = launch_plan.resolve(blocks=blocks, plan=plan)
    else:
        resolved = launch_plan.resolve(sell, tag=tag, layout="sell",
                                       nrhs=nrhs)
        if not resolved.compatible_with_sell(sell):
            resolved = launch_plan.DEFAULT_PLAN
    _check_sell_blocks(sell, resolved.blocks)


def _gse_sell_tagmap(sell: GSESellC, x, tm: TagMap, spmm: bool, device):
    """Shared map body of ``gse_spmv_sell``/``gse_spmm_sell``: each bucket
    of ``sell`` at its :func:`sell_bucket_tags` tag, in one launch (the
    uniform launch when every bucket has the same tag).  As in the
    reference, ``sell`` is the caller's pack: ``masked_for_tagmap(sell,
    tm)`` gives each entry its own tag; an unmasked pack runs each bucket
    at its bucket tag."""
    btags = sell_bucket_tags(sell, tm)
    top = max(btags)
    segs = sell.segments[:2 + len(TAG_SEGMENTS[top])]
    segs = tuple(segs) + (None,) * (4 - len(segs))
    kw = dict(rows=sell.shape[0], ei_bit=sell.ei_bit, tag=top,
              long_from=sell.long_from, bucket_tags=btags)
    scales = _sell_scales(sell)
    if spmm:
        return gse_spmm_sell_f32(*segs, x, scales, sell.bucket_table,
                                 sell.perm, device=device, **kw)
    return gse_spmv_sell_f32(*segs, x, scales, sell.bucket_table, sell.perm,
                             **kw)


def gse_spmv_sell(sell: GSESellC, x: torch.Tensor, tag=1,
                  blocks=None, plan: KernelPlan | None = None
                  ) -> torch.Tensor:
    """y = A @ x (f32) from a SELL-C-sigma packed operand (kernel B32).

    One launch streams each slice at its own lane-aligned width, so the
    modeled traffic is ``sell.bytes_touched(tag)``, the actual padded
    slots.  For finite x the result is bitwise :func:`gse_spmv_ell` on the
    same operator.  ``tag`` may be a ``TagMap``: one mixed launch then
    runs each bucket of ``sell`` -- ``masked_for_tagmap(sell, tag)``, as
    in the reference -- at its bucket tag.  ``blocks`` resolves explicit
    argument, then ``plan``, then the tuned cache, then the default, and is
    checked against the pack (:func:`_resolve_sell_blocks`); it chooses no
    launch.
    """
    _resolve_sell_blocks(sell, tag, 1, blocks, plan)
    if isinstance(tag, TagMap):
        return _gse_sell_tagmap(sell, x, tag, spmm=False, device=None)
    tag = _sell_tag(tag)
    scales = _sell_scales(sell)[tag - 1]
    segs = sell.segments[:2 + len(TAG_SEGMENTS[tag])]
    return sell_kernel_for(tag, sell.ei_bit)(
        *segs, x, scales, buckets=sell.bucket_table, perm=sell.perm,
        rows=sell.shape[0], long_from=sell.long_from)


def gse_spmm_sell(sell: GSESellC, x: torch.Tensor, tag=1,
                  blocks=None, plan: KernelPlan | None = None, *,
                  device="cuda") -> torch.Tensor:
    """Y = A @ X (f32, ``(m, nrhs)``) from a SELL-C-sigma packed operand
    (kernel C′32), X a dense ``(n, nrhs)`` block, read as it lies (a
    contiguous copy only if it is not row-major f32); each bucket's
    segments are streamed once for every pass of four columns.  Bitwise
    :func:`gse_spmm_ell` on the same operator for finite X.  ``tag`` may
    be a ``TagMap``, and ``blocks``/``plan`` resolve, as in
    :func:`gse_spmv_sell`."""
    if x.dim() != 2:
        raise ValueError(f"gse_spmm_sell wants a (n, nrhs) block; got "
                         f"{tuple(x.shape)}")
    _resolve_sell_blocks(sell, tag, x.shape[1], blocks, plan)
    if isinstance(tag, TagMap):
        return _gse_sell_tagmap(sell, x.to(torch.float32).contiguous(), tag,
                                spmm=True, device=device)
    tag = _sell_tag(tag)
    scales = _sell_scales(sell)[tag - 1]
    segs = sell.segments[:2 + len(TAG_SEGMENTS[tag])]
    return sell_spmm_kernel_for(tag, sell.ei_bit)(
        *segs, x.to(torch.float32).contiguous(), scales,
        buckets=sell.bucket_table, perm=sell.perm, rows=sell.shape[0],
        long_from=sell.long_from, device=device)


def planned_spmv(a: GSECSR, x: torch.Tensor, tag=1, layout: str = "ell",
                 plan: KernelPlan | None = None) -> torch.Tensor:
    """Operator-level SpMV with full launch-plan resolution.

    Resolves ``plan`` (explicit, then the tuned cache keyed on the
    operator's shape class and device, then the default), packs ``a`` with
    the plan's layout parameters (memoized, :func:`ell_pack_gsecsr` /
    :func:`sell_pack_gsecsr`) and runs A32 with the plan's ``lanes`` (and
    the rows' real slot counts) or B32.  The entry point the autotuner
    sweeps.

    ``tag`` may be a ``TagMap``: the operand goes through
    :func:`masked_for_tagmap` first; the ELL path decodes at the map's max
    tag, the SELL path runs each bucket at its bucket tag.
    """
    plan = launch_plan.resolve(a, tag=tag, layout=layout, nrhs=1,
                               plan=plan)
    if isinstance(tag, TagMap):
        a = masked_for_tagmap(a, tag)
        if layout == "ell":
            tag = tag.max_tag  # masked tails: the max-tag decode is the map
    if layout == "sell":
        sell = sell_pack_gsecsr(a, plan=plan)
        blocks = (plan.blocks if plan.compatible_with_sell(sell)
                  else launch_plan.DEFAULT_BLOCKS)
        return gse_spmv_sell(sell, x, tag=tag, blocks=blocks)
    if layout != "ell":
        raise ValueError(f"layout must be 'ell' or 'sell', got {layout!r}")
    ell = ell_pack_gsecsr(a, plan=plan)
    return gse_spmv_ell(ell, a.table, x, a.ei_bit, tag=tag,
                        blocks=plan.blocks, row_len=ell_row_lengths(a),
                        lanes=plan.lanes)


def planned_spmm(a: GSECSR, x: torch.Tensor, tag=1, layout: str = "ell",
                 plan: KernelPlan | None = None, *,
                 device="cuda") -> torch.Tensor:
    """Multi-RHS twin of :func:`planned_spmv` (X a dense ``(n, nrhs)``
    block) on kernels C32 and C′32."""
    nrhs = x.shape[1]
    plan = launch_plan.resolve(a, tag=tag, layout=layout, nrhs=nrhs,
                               plan=plan)
    if isinstance(tag, TagMap):
        a = masked_for_tagmap(a, tag)
        if layout == "ell":
            tag = tag.max_tag  # masked tails: the max-tag decode is the map
    if layout == "sell":
        sell = sell_pack_gsecsr(a, plan=plan)
        blocks = (plan.blocks if plan.compatible_with_sell(sell)
                  else launch_plan.DEFAULT_BLOCKS)
        return gse_spmm_sell(sell, x, tag=tag, blocks=blocks, device=device)
    if layout != "ell":
        raise ValueError(f"layout must be 'ell' or 'sell', got {layout!r}")
    ell = ell_pack_gsecsr(a, plan=plan)
    return gse_spmm_ell(ell, a.table, x, a.ei_bit, tag=tag,
                        blocks=plan.blocks, row_len=ell_row_lengths(a),
                        lanes=plan.lanes, device=device)


# --- the dense path: kernels D and E ---------------------------------------

def _dense_scales(packed: GSEPacked, tag: int):
    """The bias-1023 scale table of an f64-source dense pack at ``tag``.

    The reference's wrappers take only ``gse.pack`` packs: on a ``pack32``
    pack they fail reshaping its zero-length tail2, and their table
    assumes bias 1023; the port says so with a ValueError.  The model's
    bias-127 segments go to the kernels directly
    (``models/modules.py::linear``).
    """
    if packed.frac_bits != _F64_FRAC:
        raise ValueError("ops.gse_decode/gse_matmul take f64-source packs "
                         "(gse.pack); an f32-source pack (pack32) has no "
                         "tail2 and a bias-127 table")
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    return ref.make_scales(packed.table, TAG_BITS_USED[tag] - packed.ei_bit)


def _check_grid(blocks, dims: int, name: str) -> None:
    """Raise unless ``blocks`` is ``None`` or a grid tile of ``dims``
    positive ints, what the reference's ``gse_decode``/``gse_matmul`` pad
    to.  Kernels D and E keep their own designs: the tile chooses no
    launch."""
    if blocks is None:
        return
    try:
        tile = tuple(blocks)
    except TypeError:
        tile = ()
    if len(tile) != dims or not all(
            isinstance(b, (int, np.integer)) and not isinstance(b, bool)
            and b > 0 for b in tile):
        raise ValueError(f"{name} must be {dims} positive ints, got "
                         f"{blocks!r}")


def gse_decode(packed: GSEPacked, tag: int = 1, block=None,
               device="cuda") -> torch.Tensor:
    """Decode a dense 2-D (or 1-D) GSE-SEM tensor to f32 with kernel D.

    The reference pads to its (8, 128) grid block; the CUDA kernel takes
    any shape, so nothing is padded: ``block`` (the reference's tile, two
    positive ints) is checked and chooses no launch.
    """
    _check_grid(block, 2, "block")
    if packed.head.dim() not in (1, 2):
        raise ValueError(f"gse_decode takes a 1-D or 2-D pack, got shape "
                         f"{tuple(packed.head.shape)}")
    scales = _dense_scales(packed, tag)
    return gse_decode_dense(packed.head, packed.tail1, packed.tail2, scales,
                            ei_bit=packed.ei_bit, tag=tag, device=device)


def gse_matmul(x: torch.Tensor, packed: GSEPacked, tag: int = 1,
               blocks=None, device="cuda") -> torch.Tensor:
    """x @ decode(W) with the decode fused into kernel E.

    x: (M, K) f32 or bf16; packed: GSE-SEM weights of logical shape
    (K, N).  Returns (M, N) f32.  ``blocks`` (the reference's (BM, BN, BK)
    tile) is checked and chooses no launch: E picks its own body.
    """
    _check_grid(blocks, 3, "blocks")
    if packed.head.dim() != 2:
        raise ValueError(f"gse_matmul takes a 2-D pack, got shape "
                         f"{tuple(packed.head.shape)}")
    scales = _dense_scales(packed, tag)
    return gse_matmul_dense(x, packed.head, packed.tail1, packed.tail2,
                            scales, ei_bit=packed.ei_bit, tag=tag,
                            device=device)
