"""Kernel E: ``x @ decode(W)`` with W in GSE-SEM segments, hand-written for
Hopper.

Replaces the Pallas kernel ``gse_matmul_pallas`` of
``repro/kernels/gse_matmul.py`` (:52; body ``_matmul_body``,
``pallas_call`` :63), the LM serving hot spot: the weights stay packed in
device memory and each tile is decoded in shared memory, so the decoded
matrix never exists there.  The CUDA source is ``csrc/gse_dense.cu``,
shared with kernel D; the decode is D's, in the Pallas body's order.

X is ``(M, K)`` f32 or bf16, W ``(K, N)`` head-split segments with a (k,)
f32 scale table (bias 1023 for ``gse.pack`` packs, 127 for the model's
segments); Y is ``(M, N)`` f32 with the accuracy of an f32 product (the
oracle ``ref.matmul_ref`` is a full-f32 product).  Any M, N, K run
without padding.  Sums run in another order than ``torch.matmul``'s, so
the kernel is held to its plain version within the reference kernel
tests' tolerance (rtol 1e-5 / atol 1e-4).  Two bodies:

* M <= 8 (the decode steps, M = batch): the split-K GEMV, bound by the
  weight stream (2/4/8 bytes per weight at tags 1/2/3).  A block owns
  ``GEMV_COLS`` columns (64 on narrow matrices) and one K split;
  :func:`gemv_plan` picks the splits so that every decode-step shape
  launches at least two blocks per SM, in one wave where it can.  Each lane reads 16 bytes of each
  segment per row.  The K splits are added in split order inside the
  launch (the last block of a column tile sums them), so the result is
  the same bits on every call.  The wrapper owns the scratch: the splits'
  partial sums and one counter per column tile, kept per device and
  stream (:func:`_split_scratch`).  The 16-byte loads need every segment
  pointer 16-byte aligned and N % 8 == 0 (the model's stacked layers are
  views at an offset, so this is checked per call); otherwise the same
  kernel takes scalar loads.
* M > 8 (prefill, M = B * S): the split-TF32 tile on the tensor cores,
  bound by their operations.  128 x 128 output tiles; each K step of
  32 rows decodes a W tile once into shared memory, and the MMAs take
  every decoded weight as two TF32 terms (``hi = tf32(w)``, ``lo =
  tf32(w - hi)``), x in bf16 as one term (exact) and x in f32 as two
  (3xTF32).  The MMA partial of every ``SUM_K`` rows of K is added into
  the f32 sum with round to nearest, in K order
  (``tests/test_torch_lm_tiles.py`` repeats this arithmetic on the CPU).
  One block per SM runs, so where the output tiles would leave the last
  wave mostly empty (N = 2560 at M 2048: 320 tiles on 132 SMs),
  :func:`tiled_plan` splits K across blocks, and the last block of a tile
  adds the splits in order, in the same launch (the GEMV's scheme and
  scratch).  16-byte loads need K and N multiples of 8
  and x and every segment 16-byte aligned (:func:`tiled_vec_ok`);
  otherwise the same kernel takes scalar loads.

:func:`gse_matmul_dense` launches the kernel for CUDA tensors (or raises)
and runs :func:`gse_matmul_dense_plain` only for CPU tensors; it counts its
launches in its ``launches`` attribute and per body in ``body_launches``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels.gse_decode import (check_scales, check_segments,
                                            dense_fn, gse_decode_dense_plain)
from repro_torch.kernels.gse_spmv import _raise_on
from repro_torch.kernels.vec_f64 import on_device, refuse_grad

__all__ = ["gse_matmul_dense", "gse_matmul_dense_plain", "plain_memo",
           "gemv_plan", "GemvPlan", "KERNELS",
           "reset_launch_counts", "X_DTYPES", "GEMV_M_MAX", "GEMV_COLS",
           "GEMV_X_FLOATS", "GEMV_SPLITS", "gemv_rows_max", "TILE_M",
           "TILE_N", "SUM_K", "tiled_vec_ok", "tiled_terms", "tiled_plan",
           "TiledPlan"]

X_DTYPES = (torch.float32, torch.bfloat16)

# Weights decoded per pass of the plain version (columns of W at a time).
_CHUNK = 1 << 24

GEMV_M_MAX = 8         # rows of x up to which the GEMV body runs
GEMV_COLS = 256        # columns per block: 32 lanes x 8
GEMV_X_FLOATS = 8192   # a block's staged x: M (1, 2, 4, 8) x its K rows
GEMV_SPLITS = 8        # K splits above which the plan narrows the tiles
_GRID_Y_MAX = 65535
H100_SMS = 132
# The tiled body's block tile and the K rows per MMA partial: they must
# match kTcBM, kTcBN and kTcSumK in csrc/gse_dense.cu.
TILE_M, TILE_N, SUM_K = 128, 128, 64


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """The GEMV grid: ``tiles`` column tiles of ``GEMV_COLS // rw`` by
    ``splits`` K splits of ``rows`` rows (the last may hold fewer).  A
    block's warps load ``rw`` rows at a time, so it sums its rows as
    ``8 * rw`` sub-warps."""
    rw: int
    tiles: int
    splits: int
    rows: int

    @property
    def cols(self) -> int:
        return GEMV_COLS // self.rw

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def ranges(self, k: int, n: int):
        """Each block's ``(k0, k1, c0, c1)``: rows ``[k0, k1)`` of W and
        columns ``[c0, c1)``, splits in the order their sums are added."""
        for t in range(self.tiles):
            c0 = t * self.cols
            for s in range(self.splits):
                k0 = s * self.rows
                yield k0, min(k0 + self.rows, k), c0, min(c0 + self.cols, n)


def gemv_rows_max(m: int) -> int:
    """K rows a block can take at M = m: its x fills at most
    ``GEMV_X_FLOATS`` of shared memory, M rounded up to 1, 2, 4 or 8."""
    return GEMV_X_FLOATS // (1 << max(0, m - 1).bit_length())


def gemv_plan(m: int, k: int, n: int, sms: int = H100_SMS,
              narrow: bool = True) -> GemvPlan:
    """Split K so that the grid holds at least ``2 * sms`` blocks where K
    allows it (so just under three blocks per SM, which the kernel's
    registers allow at M <= 4: one wave), with at most
    :func:`gemv_rows_max` and at least one row per split and no empty
    split.  Tiles of 256 columns, or of 64 (``rw`` 4, only with
    ``narrow``: the vector loads) where 256 would need more than
    ``GEMV_SPLITS`` splits: the last block of a tile adds its splits, so
    fewer splits shorten the launch's tail.  ``m`` in 1..8, ``k``, ``n``
    > 0."""
    if not 0 < m <= GEMV_M_MAX or k <= 0 or n <= 0:
        raise ValueError(f"gemv_plan needs 0 < m <= {GEMV_M_MAX} and k, "
                         f"n > 0, got {m}, {k}, {n}")
    for rw in (1, 4) if narrow else (1,):
        tiles = math.ceil(n / (GEMV_COLS // rw))
        splits = max(math.ceil(2 * sms / tiles),
                     math.ceil(k / gemv_rows_max(m)))
        rows = math.ceil(k / min(splits, k))
        splits = math.ceil(k / rows)
        if splits <= GEMV_SPLITS:
            break
    if splits > _GRID_Y_MAX:
        raise ValueError(f"K = {k} needs {splits} splits of {rows} rows; "
                         f"the grid takes {_GRID_Y_MAX}")
    return GemvPlan(rw, tiles, splits, rows)


_plan = functools.lru_cache(maxsize=256)(gemv_plan)
_SMS: dict = {}


def _sm_count(dev) -> int:
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


# (device index, stream) -> (partial sums, tile counters), shared by the
# GEMV and tiled bodies: grown, never shrunk.  Launches on one stream run
# in order and each leaves its counters at zero, so the next one can
# reuse them.
_SCRATCH: dict = {}


def _split_scratch(dev, stream: int, parts: int, tiles: int):
    key = (dev.index, stream)
    part, count = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < parts:
        part = torch.empty(max(parts, 1), dtype=torch.float32, device=dev)
    if count is None or count.numel() < tiles:
        count = torch.zeros(tiles, dtype=torch.int32, device=dev)
    _SCRATCH[key] = (part, count)
    return part, count


def _vec_ok(n: int, *segs) -> bool:
    """The 16-byte loads' condition: N % 8 == 0 and every segment read
    16-byte aligned (row pitches then are too)."""
    return n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in segs
                              if t is not None)


def tiled_vec_ok(x: torch.Tensor, n: int, *segs) -> bool:
    """The tiled body's 16-byte loads: K and N multiples of 8 (so a load
    of 8 weights or of 4-8 x values is all in range or all out) and x and
    every segment read 16-byte aligned."""
    return (x.shape[1] % 8 == 0 and x.data_ptr() % 16 == 0
            and _vec_ok(n, *segs))


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """The tiled grid: ``tiles`` output tiles of ``TILE_M x TILE_N`` by
    ``splits`` K splits of ``rows`` rows (the last may hold fewer)."""
    tiles: int
    splits: int
    rows: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def ranges(self, k: int):
        """Each split's rows ``[k0, k1)`` of K, in the order their sums
        are added."""
        for s in range(self.splits):
            yield s * self.rows, min((s + 1) * self.rows, k)


TILED_SPLITS = 4      # K splits the tiled plan considers at most
# The share of its waves' block slots a grid must fill not to be split:
# each split writes and reads M x N partial sums (w_gate at four splits:
# 0.64 GB, about what a better-filled last wave would save).
TILED_FILL = 0.9


def tiled_plan(m: int, k: int, n: int, sms: int = H100_SMS) -> TiledPlan:
    """Split K only where one block per SM leaves the waves poorly filled
    (below ``TILED_FILL`` of their block slots): then the split count (up
    to ``TILED_SPLITS``) that fills them best, the fewest splits on a
    tie; each split at least ``4 * SUM_K`` rows, a multiple of ``SUM_K``,
    none empty.  ``m`` > 8, ``k``, ``n`` > 0."""
    if m <= GEMV_M_MAX or k <= 0 or n <= 0:
        raise ValueError(f"tiled_plan needs m > {GEMV_M_MAX} and k, n > 0, "
                         f"got {m}, {k}, {n}")
    tiles = math.ceil(m / TILE_M) * math.ceil(n / TILE_N)

    def fill(splits):
        blocks = tiles * splits
        return blocks / (math.ceil(blocks / sms) * sms)

    best = TiledPlan(tiles, 1, k)
    if fill(1) >= TILED_FILL:
        return best
    for splits in range(2, TILED_SPLITS + 1):
        rows = math.ceil(math.ceil(k / splits) / SUM_K) * SUM_K
        if rows < 4 * SUM_K or math.ceil(k / rows) != splits:
            continue
        if fill(splits) > fill(best.splits):
            best = TiledPlan(tiles, splits, rows)
    return best


_tiled_plan = functools.lru_cache(maxsize=256)(tiled_plan)


def tiled_terms(x_dtype) -> int:
    """TF32 products per multiply-add of the tiled body: x.hi + x.lo for a
    bf16 x (exact in TF32), and x_lo.hi besides for an f32 x."""
    return 2 if x_dtype == torch.bfloat16 else 3


# The plain version's decoded column blocks, per stored head tensor, while
# :func:`plain_memo` is on (None otherwise).
_MEMO = None


@contextlib.contextmanager
def plain_memo():
    """Within the block, :func:`gse_matmul_dense_plain` keeps each decoded
    column block of W (keyed by the head tensor that stores it, its view,
    version, tag and scales) and reuses it: the same products, each weight
    decoded once.  For a CPU twin that multiplies the same packed weights
    at every step; the memory goes when the block ends or the weights
    die."""
    global _MEMO
    outer, _MEMO = _MEMO, WeakIdKeyDictionary()
    try:
        yield
    finally:
        _MEMO = outer


def _decoded_block(head, tail1, tail2, scales, ei_bit, tag, cols):
    args = (head[:, cols], tail1[:, cols] if tag >= 2 else None,
            tail2[:, cols] if tag == 3 else None)
    if _MEMO is None:
        return gse_decode_dense_plain(*args, scales, ei_bit=ei_bit, tag=tag)
    base = head if head._base is None else head._base
    key = (head.storage_offset(), tuple(head.shape), head.stride(),
           head._version, cols.start, tag, ei_bit,
           tuple(scales.reshape(-1).tolist()))
    blocks = _MEMO.get(base)
    if blocks is None:
        blocks = _MEMO[base] = {}
    if key not in blocks:
        blocks[key] = gse_decode_dense_plain(*args, scales, ei_bit=ei_bit,
                                             tag=tag)
    return blocks[key]


def gse_matmul_dense_plain(x, head, tail1, tail2, scales, *, ei_bit: int,
                           tag: int) -> torch.Tensor:
    """Plain version of E: D's plain decode, then a full-f32
    ``torch.matmul``, W taken a block of columns at a time."""
    kk, n = head.shape
    x32 = x.to(torch.float32)
    y = torch.empty(x.shape[0], n, dtype=torch.float32, device=x.device)
    step = max(1, _CHUNK // max(kk, 1))
    for c0 in range(0, n, step):
        cols = slice(c0, c0 + step)
        w = _decoded_block(head, tail1, tail2, scales, ei_bit, tag, cols)
        y[:, cols] = torch.matmul(x32, w)
    return y


def gse_matmul_dense(x, head, tail1, tail2, scales, *, ei_bit: int, tag: int,
                     device="cuda") -> torch.Tensor:
    """Y = x @ decode(W) as ``(M, N)`` f32 from an ``(M, K)`` f32 or bf16 x
    and ``(K, N)`` segments at ``tag``.

    ``tail1``/``tail2`` may be ``None`` when ``tag`` does not read them.
    """
    if x.dtype not in X_DTYPES:
        raise TypeError(f"x must be f32 or bf16, got {x.dtype}")
    dev = on_device(device, x=x, head=head, scales=scales,
                    tail1=tail1 if tag >= 2 else None,
                    tail2=tail2 if tag == 3 else None)
    refuse_grad("gse_matmul_dense", x=x, scales=scales)
    if x.dim() != 2 or head.dim() != 2 or x.shape[1] != head.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ W {tuple(head.shape)}: "
                         "expected (M, K) @ (K, N)")
    if dev.type == "cpu":
        return gse_matmul_dense_plain(x, head, tail1, tail2, scales,
                                      ei_bit=ei_bit, tag=tag)
    if dev.type != "cuda":
        raise ValueError(f"gse_matmul_dense runs on cuda or cpu, not {dev}")
    dev = head.device
    check_segments(head, tail1, tail2, tag, dev)
    scales = check_scales(scales, dev)
    if x.device != dev or not x.is_contiguous():
        raise ValueError(f"x must be contiguous on {dev}")
    (m, kk), n = x.shape, head.shape[1]
    y = torch.empty(m, n, dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y
    if kk == 0:
        return y.zero_()
    t1 = tail1 if tag >= 2 else None
    t2 = tail2 if tag == 3 else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    if m <= GEMV_M_MAX:
        body = "gemv"
        vec = _vec_ok(n, head, t1, t2)
        plan = _plan(m, kk, n, _sm_count(dev), vec)
        part, count = _split_scratch(
            dev, stream, plan.splits * m * n if plan.splits > 1 else 0,
            plan.tiles)
        extra = (part.data_ptr(), count.data_ptr(), plan.rows, plan.splits,
                 plan.rw, int(vec))
    else:
        body = "tiled"
        plan = _tiled_plan(m, kk, n, _sm_count(dev))
        part = count = None
        if plan.splits > 1:
            part, count = (t.data_ptr() for t in _split_scratch(
                dev, stream, plan.splits * m * n, plan.tiles))
        extra = (part, count, plan.rows, plan.splits, 0,
                 int(tiled_vec_ok(x, n, head, t1, t2)))
    rc = dense_fn("gse_matmul_dense")(
        tag, int(x.dtype == torch.bfloat16), x.data_ptr(), head.data_ptr(),
        t1.data_ptr() if t1 is not None else None,
        t2.data_ptr() if t2 is not None else None, scales.data_ptr(),
        y.data_ptr(), m, kk, n, ei_bit, *extra, stream)
    gse_matmul_dense.launches += 1
    gse_matmul_dense.body_launches[body] += 1
    _raise_on(rc, "gse_matmul_dense")
    return y


KERNELS = (gse_matmul_dense,)


def reset_launch_counts():
    """Zero every wrapper's ``launches``; ``gse_matmul_dense`` also
    counts per body in ``body_launches`` ("gemv", "tiled")."""
    for k in KERNELS:
        k.launches = 0
    gse_matmul_dense.body_launches = {"gemv": 0, "tiled": 0}


reset_launch_counts()
