"""Kernels C and C′: the tag-specialized GSE-SEM SpMM, hand-written for
Hopper.

Replaces the Pallas kernel ``gse_spmm_call`` of
``repro/kernels/gse_spmm.py`` (:102; bodies ``_spmm_body_tag1/2/3``
:81-96, ``_accumulate`` :54, ``pallas_call`` :137).  The CUDA source is
``csrc/gse_spmm.cu``; it holds two builds:

* **C32** -- :func:`gse_spmm_ell_f32`: f32 decode and sums over the
  uniform-ELL arrays of ``ops.ell_pack_gsecsr`` and an ``(n, nrhs)``
  row-major f32 X (a slot's four columns in one 16-byte load), what the
  Pallas kernel computes; Y is ``(m, nrhs)``.  Each entry is decoded once
  for every column.  A32's walk per column: each row's real slots only
  (``row_len=``, required on the card) on a group of ``lanes`` lanes.
  Held to rtol 2e-5 / atol 1e-4 against the Pallas kernel; its plain
  version is A32's plain version column by column, and at nrhs = 1 the
  kernel is bitwise A32.
* **C64** -- :func:`gse_spmm_csr_f64`: f64 over the CSR rows, the operator
  of the batched stepped CG loop.  Column j runs at its own tag
  (``tags[j]``, a device int32) when ``active[j]`` (a device bool), so
  column j of Y is bitwise A64 at ``tags[j]`` on column j of X, and one
  launch per iteration streams the matrix once for a pass of four
  columns.  Y is ``(nrhs, m)``; inactive columns are 0.0.  It runs by
  A64's row plan (``plan=``, the pack's ``GSECSR.row_plan``), one launch
  for three bodies: long rows a block each (C′64's four adding lanes),
  rows in between a warp each (C′64's warp rows), and runs of short rows
  a block each, whose threads stage the run's products for the four
  columns in shared memory before each thread adds one row.  The launches
  per body are counted in ``body_launches``.

Kernel C′ replaces ``gse_spmm_sell_call`` (``repro/kernels/gse_spmm.py``
:155, C's ``pallas_call`` once per width bucket, then the ``unperm``
gather) over the SELL-C-sigma layout.  The CUDA source is
``csrc/gse_sell.cu``; one launch covers every bucket, the row bodies are
C's:

* **C′32** -- :func:`gse_spmm_sell_f32` (``ops.gse_spmm_sell``): B32's
  two bodies for a pass of four columns of an ``(n, nrhs)`` row-major X
  (a slot's columns in one sector): the rows from the pack's
  ``long_from`` on get a block each, whose producer warps stage each
  slot's four products side by side ahead of warp 0's 32 lanes, each lane
  adding four chains in A32's lane order; the other rows get a warp each.
  Per column bitwise C32, at nrhs = 1 bitwise B32.  Y is ``(m, nrhs)``.
  The launches per body are counted in ``body_launches`` ("block",
  "warp").  ``bucket_tags=`` makes the launch mixed, each bucket at its
  own tag, as B32's (``mixed_launches``).
* **C′64** -- :func:`gse_spmm_sell_f64` (``spmm_gse`` over a ``GSESellC``,
  the batched CG operator): B64's bodies for every column, with C64's
  per-column device tags and active flags; column j bitwise B64 at
  ``tags[j]``, and so C64.  Y is ``(nrhs, m)``.  The rows from the
  pack's ``long_from`` on get a block each, whose producer warps stage
  the four columns' products in shared memory ahead of four adding lanes,
  one a column; the other rows get a warp each.  The launches per body
  are counted in ``body_launches`` ("block", "warp").

All are bound by HBM bytes: ``bytes_touched(tag)`` of segments plus
``nrhs * (m + n)`` vector elements.  Each wrapper takes ``device=``
(default ``"cuda"``): it launches its kernel on the card, runs the plain
version only when the caller asks for the CPU, and raises for tensors
anywhere else.  Each counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gse_spmv import (A64_BODIES, ELL_LANES_DEFAULT,
                                          SELL_BODIES, _check, _check_ell,
                                          _check_lanes, _check_long_from,
                                          _check_sell, _raise_on,
                                          bucket_tag_vector, check_plan,
                                          check_row_len, count_bodies,
                                          csr_row_sums,
                                          gse_spmv_ell_f32_plain,
                                          gse_spmv_sell_f32_plain,
                                          resolve_bucket_tags, row_sums,
                                          sell_row_starts, sell_scatter)
from repro_torch.kernels.vec_f64 import on_device
from repro_torch.sparse.spmv import _decode_gsecsr

__all__ = ["gse_spmm_ell_f32", "gse_spmm_ell_f32_plain", "gse_spmm_csr_f64",
           "gse_spmm_csr_f64_plain", "gse_spmm_sell_f32",
           "gse_spmm_sell_f32_plain", "gse_spmm_sell_f64",
           "gse_spmm_sell_f64_plain", "KERNELS", "reset_launch_counts"]

_P = ctypes.c_void_p
_ARGTYPES = {
    "gse_spmm_ell_f32": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                         _P, _P, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, _P],
    "gse_spmm_csr_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P,
                         ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    "gse_spmm_sell_f32": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                          ctypes.c_int, _P, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P,
                          ctypes.c_int, _P],
    "gse_spmm_sell_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          ctypes.c_int, _P, _P, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
}
# Columns per pass of C64 and C′64 (csrc/gse_rows.cuh kColsWarp).
C64_PASS = 4
_SOURCE = {"gse_spmm_ell_f32": "gse_spmm", "gse_spmm_csr_f64": "gse_spmm",
           "gse_spmm_sell_f32": "gse_sell",
           "gse_spmm_sell_f64": "gse_sell"}
_BOUND = {}


def _fn(name: str):
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(_build.load(_SOURCE[name]), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


# --- C32: f32 ELL -----------------------------------------------------------

def gse_spmm_ell_f32_plain(colpak, head, tail1, tail2, x, scales, *,
                           ei_bit: int, tag: int) -> torch.Tensor:
    """Plain version of C32: A32's plain version on each column of the
    ``(n, nrhs)`` X, stacked to ``(m, nrhs)``."""
    cols = [gse_spmv_ell_f32_plain(colpak, head, tail1, tail2, x[:, j],
                                   scales, ei_bit=ei_bit, tag=tag)
            for j in range(x.shape[1])]
    if not cols:
        return torch.zeros(colpak.shape[0], 0, dtype=torch.float32,
                           device=colpak.device)
    return torch.stack(cols, dim=1)


def gse_spmm_ell_f32(colpak, head, tail1, tail2, x, scales, *, ei_bit: int,
                     tag: int, row_len=None, lanes: int = ELL_LANES_DEFAULT,
                     device="cuda") -> torch.Tensor:
    """Y = A @ X as ``(m, nrhs)`` f32 from ``(m, L)`` ELL segments at
    ``tag`` and an ``(n, nrhs)`` f32 X, row-major (as ``ops.gse_spmm_ell``'s
    caller holds it).

    ``tail1``/``tail2`` may be ``None`` when ``tag`` does not read them.
    ``scales`` is the (k,) or (1, k) f32 table ``ref.make_scales`` gives.
    ``row_len`` (required on the card; a count for another number of rows
    is refused on the CPU too) is each row's real slot count, an (m,)
    int32 tensor (``ops.ell_row_lengths``).  ``lanes`` (one of
    ``ELL_LANES``) is the lanes a row runs on.
    """
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    _check_lanes(lanes)
    check_row_len(row_len, colpak.shape[0], "gse_spmm_ell_f32")
    dev = on_device(device, colpak=colpak, head=head, x=x, scales=scales,
                    row_len=row_len, tail1=tail1 if tag >= 2 else None,
                    tail2=tail2 if tag == 3 else None)
    if dev.type == "cpu":
        return gse_spmm_ell_f32_plain(colpak, head, tail1, tail2, x, scales,
                                      ei_bit=ei_bit, tag=tag)
    if dev.type != "cuda":
        raise ValueError(f"gse_spmm_ell_f32 runs on cuda or cpu, not {dev}")
    dev = colpak.device
    rows, width = colpak.shape
    _check_ell(colpak, head, tail1, tail2, tag, dev)
    _check(x, "x", torch.float32, dev, 2)
    scales = scales.reshape(-1)
    _check(scales, "scales", torch.float32, dev, 1)
    check_row_len(row_len, rows, "gse_spmm_ell_f32", dev)
    nrhs = x.shape[1]
    y = torch.empty(rows, nrhs, dtype=torch.float32, device=dev)
    if rows == 0 or nrhs == 0:
        return y
    rc = _fn("gse_spmm_ell_f32")(
        tag, lanes, colpak.data_ptr(), head.data_ptr(),
        tail1.data_ptr() if tag >= 2 else None,
        tail2.data_ptr() if tag == 3 else None,
        x.data_ptr(), scales.data_ptr(), row_len.data_ptr(), y.data_ptr(),
        rows, width, nrhs, ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmm_ell_f32.launches += 1
    _raise_on(rc, "gse_spmm_ell_f32")
    return y


# --- C64: f64 CSR, the batched solver-loop operator -------------------------

def gse_spmm_csr_f64_plain(rowptr, colpak, head, tail1, tail2, table, x,
                           tags, active, *, ei_bit: int) -> torch.Tensor:
    """Plain version of C64: A64's plain version on each active column of
    the ``(nrhs, n)`` X at that column's tag; 0.0 for the others.

    The active columns that share a tag share one decode, and their row
    sums run side by side (``csr_row_sums``, elementwise across columns),
    so each column is bitwise ``gse_spmv_csr_f64_plain`` on it."""
    nrhs = x.shape[0]
    y = torch.zeros(nrhs, rowptr.shape[0] - 1, dtype=torch.float64,
                    device=x.device)
    by_tag = {}
    for j, (t, on) in enumerate(zip(tags.tolist(), active.tolist())):
        if on:
            by_tag.setdefault(min(max(int(t), 1), 3), []).append(j)
    for t, js in by_tag.items():
        val, col = _decode_gsecsr(colpak, head, tail1, tail2, table, ei_bit,
                                  t)
        prod = val[:, None] * x[js].to(torch.float64)[:, col].t()
        y[js] = csr_row_sums(rowptr, prod).t()
    return y


def gse_spmm_csr_f64(rowptr, colpak, head, tail1, tail2, table, x, tags,
                     active, *, ei_bit: int, plan=None,
                     device="cuda") -> torch.Tensor:
    """Y = A @ X as ``(nrhs, m)`` f64 over GSE-SEM CSR segments and an
    ``(nrhs, n)`` f64 X (columns contiguous).

    ``tags`` is an ``(nrhs,)`` int32 tensor (each clipped to [1, 3] as the
    reference's ``lax.switch`` clips it) and ``active`` an ``(nrhs,)``
    bool tensor, both on the operand's device, so the batched loop passes
    its monitors' tags and its live columns without a host sync.  All
    three segment arrays are passed because the tags are read on the
    device.  ``plan`` (required on the card) is the pack's
    ``GSECSR.row_plan``, a ``sparse.csr.RowPlan`` of these rows; a plan of
    another row count is refused on the CPU too.
    """
    check_plan(plan, rowptr.shape[0] - 1, "gse_spmm_csr_f64")
    dev = on_device(device, rowptr=rowptr, colpak=colpak, head=head,
                    tail1=tail1, tail2=tail2, table=table, x=x, tags=tags,
                    active=active)
    if dev.type == "cpu":
        return gse_spmm_csr_f64_plain(rowptr, colpak, head, tail1, tail2,
                                      table, x, tags, active, ei_bit=ei_bit)
    if dev.type != "cuda":
        raise ValueError(f"gse_spmm_csr_f64 runs on cuda or cpu, not {dev}")
    dev = colpak.device
    nnz = colpak.shape[0]
    _check(rowptr, "rowptr", torch.int32, dev, 1)
    for name, t, dt in (("colpak", colpak, torch.uint32),
                        ("head", head, torch.uint16),
                        ("tail1", tail1, torch.uint16),
                        ("tail2", tail2, torch.uint32)):
        _check(t, name, dt, dev, 1)
        if t.shape[0] != nnz:
            raise ValueError(f"{name} has {t.shape[0]} entries, colpak {nnz}")
    _check(table, "table", torch.int32, dev, 1)
    _check(x, "x", torch.float64, dev, 2)
    nrhs, n = x.shape
    _check(tags, "tags", torch.int32, dev, 1)
    _check(active, "active", torch.bool, dev, 1)
    if tags.shape[0] != nrhs or active.shape[0] != nrhs:
        raise ValueError(f"tags/active have {tags.shape[0]}/"
                         f"{active.shape[0]} entries, x {nrhs} columns")
    rows = rowptr.shape[0] - 1
    check_plan(plan, rows, "gse_spmm_csr_f64", dev)
    parts = (plan.long_rows, plan.warp_rows, plan.row_blocks)
    y = torch.empty(nrhs, rows, dtype=torch.float64, device=dev)
    if rows == 0 or nrhs == 0:
        return y
    counts = [t.shape[0] for t in parts]
    # The kernel's scratch: X interleaved, a pass's columns of each matrix
    # column side by side.
    passes = -(-nrhs // C64_PASS)
    xi = torch.empty(passes * n * C64_PASS, dtype=torch.float64, device=dev)
    rc = _fn("gse_spmm_csr_f64")(
        tags.data_ptr(), active.data_ptr(), rowptr.data_ptr(),
        colpak.data_ptr(), head.data_ptr(), tail1.data_ptr(),
        tail2.data_ptr(), table.data_ptr(), x.data_ptr(), y.data_ptr(),
        xi.data_ptr(), parts[0].data_ptr(), counts[0], parts[1].data_ptr(),
        counts[1], parts[2].data_ptr(), counts[2], rows, n, nrhs, ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmm_csr_f64.launches += 1
    count_bodies(gse_spmm_csr_f64, counts, A64_BODIES)
    _raise_on(rc, "gse_spmm_csr_f64")
    return y


# --- C′32 / C′64: the SELL-C-sigma layout -------------------------------------

def gse_spmm_sell_f32_plain(colpak, head, tail1, tail2, x, scales, buckets,
                            perm, *, rows: int, ei_bit: int, tag: int,
                            bucket_tags=None) -> torch.Tensor:
    """Plain version of C′32: B32's plain version on each column of the
    ``(n, nrhs)`` X, stacked to ``(rows, nrhs)`` (``bucket_tags``: the
    mixed launch, as B32's)."""
    cols = [gse_spmv_sell_f32_plain(colpak, head, tail1, tail2, x[:, j],
                                    scales, buckets, perm, rows=rows,
                                    ei_bit=ei_bit, tag=tag,
                                    bucket_tags=bucket_tags)
            for j in range(x.shape[1])]
    if not cols:
        return torch.zeros(rows, 0, dtype=torch.float32, device=colpak.device)
    return torch.stack(cols, dim=1)


def _sell_f32_args(name, tag, colpak, head, tail1, tail2, x, scales,
                   buckets, perm, device):
    """The device of a C′32 call (``on_device``); on the card, its operands
    checked."""
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    dev = on_device(device, colpak=colpak, head=head, x=x, scales=scales,
                    buckets=buckets, perm=perm,
                    tail1=tail1 if tag >= 2 else None,
                    tail2=tail2 if tag == 3 else None)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    dev = colpak.device
    _check_sell((("colpak", colpak, torch.uint32), ("head", head, torch.uint16),
                 ("tail1", tail1 if tag >= 2 else None, torch.uint16),
                 ("tail2", tail2 if tag == 3 else None, torch.uint32)),
                buckets, perm, dev)
    _check(x, "x", torch.float32, dev, 2)
    _check(scales.reshape(-1), "scales", torch.float32, dev, 1)
    return dev


def gse_spmm_sell_f32(colpak, head, tail1, tail2, x, scales, buckets, perm,
                      *, rows: int, ei_bit: int, tag: int,
                      long_from: int | None = None, bucket_tags=None,
                      device="cuda") -> torch.Tensor:
    """Y = A @ X as ``(rows, nrhs)`` f32 from the flat SELL segments at
    ``tag`` and an ``(n, nrhs)`` f32 X (row-major, as
    ``ops.gse_spmm_sell``'s caller holds it).

    ``tail1``/``tail2`` may be ``None`` when ``tag`` does not read them.
    ``long_from`` (required on the card) is the pack's
    ``GSESellC.long_from``: the bucket rows from there on run a block
    each.  The launches per body are counted in ``body_launches``
    ("block", "warp").  ``bucket_tags`` makes the launch mixed, as in
    ``gse_spmv_sell_f32`` (counted in ``mixed_launches`` too).
    """
    dev = _sell_f32_args("gse_spmm_sell_f32", tag, colpak, head, tail1,
                         tail2, x, scales, buckets, perm, device)
    if dev.type == "cpu":
        return gse_spmm_sell_f32_plain(colpak, head, tail1, tail2, x, scales,
                                       buckets, perm, rows=rows,
                                       ei_bit=ei_bit, tag=tag,
                                       bucket_tags=bucket_tags)
    n, nrhs = x.shape
    rows_pad = perm.shape[0]
    _check_long_from(long_from, rows_pad)
    y = torch.empty(rows, nrhs, dtype=torch.float32, device=dev)
    if rows_pad == 0 or nrhs == 0:
        return y
    tags, scales = resolve_bucket_tags(bucket_tags, scales, buckets.shape[0],
                                       tag)
    mixed = tags is not None
    scales = scales.reshape(-1)
    rc = _fn("gse_spmm_sell_f32")(
        -tag if mixed else tag, colpak.data_ptr(), head.data_ptr(),
        tail1.data_ptr() if tag >= 2 else None,
        tail2.data_ptr() if tag == 3 else None,
        x.data_ptr(), scales.data_ptr(), y.data_ptr(), buckets.data_ptr(),
        buckets.shape[0], perm.data_ptr(), rows_pad, long_from, nrhs, ei_bit,
        bucket_tag_vector(tags, dev).data_ptr() if mixed else None,
        scales.shape[0] // 3 if mixed else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmm_sell_f32.launches += 1
    gse_spmm_sell_f32.mixed_launches += mixed
    count_bodies(gse_spmm_sell_f32, (rows_pad - long_from, long_from))
    _raise_on(rc, "gse_spmm_sell_f32")
    return y


def gse_spmm_sell_f64_plain(colpak, head, tail1, tail2, table, x, tags,
                            active, buckets, perm, row_len, *, rows: int,
                            ei_bit: int) -> torch.Tensor:
    """Plain version of C′64: B64's plain version on each active column of
    the ``(nrhs, n)`` X at that column's tag; 0.0 for the others.  The
    active columns that share a tag share one decode, and their row sums
    run side by side (elementwise across columns)."""
    nrhs = x.shape[0]
    y = torch.zeros(nrhs, rows, dtype=torch.float64, device=x.device)
    by_tag = {}
    for j, (t, on) in enumerate(zip(tags.tolist(), active.tolist())):
        if on:
            by_tag.setdefault(min(max(int(t), 1), 3), []).append(j)
    starts = sell_row_starts(buckets, perm.shape[0], x.device)
    for t, js in by_tag.items():
        val, col = _decode_gsecsr(colpak, head, tail1, tail2, table, ei_bit,
                                  t)
        prod = val[:, None] * x[js].to(torch.float64)[:, col].t()
        y[js] = sell_scatter(row_sums(starts, row_len, prod), perm, rows).t()
    return y


def gse_spmm_sell_f64(colpak, head, tail1, tail2, table, x, tags, active,
                      buckets, perm, row_len, *, rows: int, ei_bit: int,
                      long_from: int | None = None,
                      device="cuda") -> torch.Tensor:
    """Y = A @ X as ``(nrhs, rows)`` f64 over the flat SELL segments and an
    ``(nrhs, n)`` f64 X, column j at ``tags[j]`` (int32, clipped to [1, 3])
    when ``active[j]`` (bool), both on the operand's device; inactive
    columns are 0.0.  ``row_len`` is each bucket row's real entry count.
    ``long_from`` (required on the card) is the pack's
    ``GSESellC.long_from``.
    """
    dev = on_device(device, colpak=colpak, head=head, tail1=tail1,
                    tail2=tail2, table=table, x=x, tags=tags, active=active,
                    buckets=buckets, perm=perm, row_len=row_len)
    if dev.type == "cpu":
        return gse_spmm_sell_f64_plain(colpak, head, tail1, tail2, table, x,
                                       tags, active, buckets, perm, row_len,
                                       rows=rows, ei_bit=ei_bit)
    if dev.type != "cuda":
        raise ValueError(f"gse_spmm_sell_f64 runs on cuda or cpu, not {dev}")
    dev = colpak.device
    _check_sell((("colpak", colpak, torch.uint32), ("head", head, torch.uint16),
                 ("tail1", tail1, torch.uint16),
                 ("tail2", tail2, torch.uint32)), buckets, perm, dev)
    _check(row_len, "row_len", torch.int32, dev, 1)
    _check(table, "table", torch.int32, dev, 1)
    _check(x, "x", torch.float64, dev, 2)
    nrhs, n = x.shape
    _check(tags, "tags", torch.int32, dev, 1)
    _check(active, "active", torch.bool, dev, 1)
    if tags.shape[0] != nrhs or active.shape[0] != nrhs:
        raise ValueError(f"tags/active have {tags.shape[0]}/"
                         f"{active.shape[0]} entries, x {nrhs} columns")
    rows_pad = perm.shape[0]
    _check_long_from(long_from, rows_pad)
    y = torch.empty(nrhs, rows, dtype=torch.float64, device=dev)
    if rows_pad == 0 or nrhs == 0:
        return y
    rc = _fn("gse_spmm_sell_f64")(
        tags.data_ptr(), active.data_ptr(), colpak.data_ptr(),
        head.data_ptr(), tail1.data_ptr(), tail2.data_ptr(), table.data_ptr(),
        x.data_ptr(), y.data_ptr(), buckets.data_ptr(), buckets.shape[0],
        perm.data_ptr(), row_len.data_ptr(), rows_pad, long_from, rows, n,
        nrhs, ei_bit, torch.cuda.current_stream(dev).cuda_stream)
    gse_spmm_sell_f64.launches += 1
    count_bodies(gse_spmm_sell_f64, (rows_pad - long_from, long_from))
    _raise_on(rc, "gse_spmm_sell_f64")
    return y


KERNELS = (gse_spmm_ell_f32, gse_spmm_csr_f64, gse_spmm_sell_f32,
           gse_spmm_sell_f64)


def reset_launch_counts():
    """Zero every wrapper's ``launches`` and, where a wrapper counts its
    launches per body, its ``body_launches``: ``gse_spmm_csr_f64``
    (``A64_BODIES``), ``gse_spmm_sell_f32`` and ``gse_spmm_sell_f64``
    (``SELL_BODIES``)."""
    for k in KERNELS:
        k.launches = 0
    gse_spmm_csr_f64.body_launches = dict.fromkeys(A64_BODIES, 0)
    gse_spmm_sell_f32.body_launches = dict.fromkeys(SELL_BODIES, 0)
    gse_spmm_sell_f32.mixed_launches = 0
    gse_spmm_sell_f64.body_launches = dict.fromkeys(SELL_BODIES, 0)


reset_launch_counts()
