"""Kernels A and B: the tag-specialized GSE-SEM SpMV, hand-written for
Hopper.

Kernel A replaces the Pallas kernel ``gse_spmv_call`` of
``repro/kernels/gse_spmv.py`` (bodies ``_spmv_body_tag1/2/3`` :106-121,
decode ``decode_tile`` :61, ``pallas_call`` :160).  The CUDA source is
``csrc/gse_spmv.cu``; it holds two builds, each with three tag variants:

* **A32** -- :func:`gse_spmv_ell_f32`: f32 decode and sums over the
  uniform-ELL arrays of ``ops.ell_pack_gsecsr``, what the Pallas kernel
  computes.  Held to rtol 2e-5 / atol 1e-4 against the Pallas kernel; its
  plain version repeats the kernel's sum order, so the two agree bitwise.
* **A64** -- :func:`gse_spmv_csr_f64`: f64 over the CSR rows, what
  ``spmv_gse`` computes; the operator inside the stepped CG loop.  The tag
  is read from a device int32 so the loop never syncs to choose a build.
  Bitwise equal to its plain version and to the reference.

Kernel B replaces ``gse_spmv_sell_call`` (``repro/kernels/gse_spmv.py``
:178, A's ``pallas_call`` once per width bucket, then the ``unperm``
gather) over the SELL-C-sigma layout of ``sparse.csr.pack_sell``.  The
CUDA source is ``csrc/gse_sell.cu``; one launch covers every bucket, the
row bodies are A's:

* **B32** -- :func:`gse_spmv_sell_f32` (``ops.gse_spmv_sell``): A32's warp
  row over each bucket row's width; bitwise A32 for finite x.
* **B64** -- :func:`gse_spmv_sell_f64` (``spmv_gse`` over a ``GSESellC``,
  the CG operator): A64's chain over each row's real slots; bitwise A64.
  A dense row's sum is one chain of dependent adds, so the rows of the
  buckets at least ``sparse.csr.B64_BLOCK_WIDTH`` wide (from the pack's
  ``long_from`` on) get a block each, whose other warps decode and multiply the slots into
  shared memory ahead of the one thread that adds them; the other rows
  get one warp each (32 slots loaded and decoded at a time, the products
  added in slot order from shuffle broadcasts).

The SELL wrappers take the pack's flat ``(slots,)`` segment arrays, its
``(n_buckets, 3)`` bucket table ``[first row, width, flat offset]`` and
``perm``; each bucket row writes ``y[perm[r]]``.

All are bound by HBM bytes: 6/8/12 B/nnz (B: per padded slot) of
segments at tags 1/2/3 plus the x gather.  Each wrapper launches its
kernel for CUDA tensors (or raises) and runs the plain PyTorch version
only for CPU tensors.  Each wrapper counts its launches in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.sparse.spmv import _decode_gsecsr

__all__ = ["gse_spmv_ell_f32", "gse_spmv_ell_f32_plain", "gse_spmv_csr_f64",
           "gse_spmv_csr_f64_plain", "gse_spmv_sell_f32",
           "gse_spmv_sell_f32_plain", "gse_spmv_sell_f64",
           "gse_spmv_sell_f64_plain", "csr_row_sums", "row_sums",
           "KERNELS", "reset_launch_counts", "gse_spmv_sell_f64_warp"]

_P = ctypes.c_void_p
_ARGTYPES = {
    "gse_spmv_ell_f32": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    "gse_spmv_csr_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         ctypes.c_longlong, ctypes.c_int, _P],
    "gse_spmv_sell_f32": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
                          ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_int,
                          _P],
    "gse_spmv_sell_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                          _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_int, _P],
    "gse_spmv_sell_f64_warp": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                               ctypes.c_int, _P, _P, ctypes.c_longlong,
                               ctypes.c_int, _P],
}
_SOURCE = {"gse_spmv_ell_f32": "gse_spmv", "gse_spmv_csr_f64": "gse_spmv",
           "gse_spmv_sell_f32": "gse_sell", "gse_spmv_sell_f64": "gse_sell",
           "gse_spmv_sell_f64_warp": "gse_sell"}
_BOUND = {}


def _fn(name: str):
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(_build.load(_SOURCE[name]), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def _check(t: torch.Tensor, name: str, dtype, device, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor")


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


# --- A32: f32 ELL -----------------------------------------------------------

def gse_spmv_ell_f32_plain(colpak, head, tail1, tail2, x, scales, *,
                           ei_bit: int, tag: int) -> torch.Tensor:
    """Plain version of A32: ``spmv_ell_ref`` semantics with the decode of
    ``decode_tile`` (the mantissa spliced tag by tag in f32).

    The row sum repeats the kernel's order -- 32 lane partials, lane ``l``
    adding slots ``l, l+32, ...`` from 0.0, then the warp's shuffle tree --
    so the card can hold the kernel to it bitwise; any f32 order computes
    the same function.
    """
    shift = 32 - ei_bit
    cp = colpak.to(torch.int64)
    col = cp & ((1 << shift) - 1)
    h = head.to(torch.int64)
    sgn = 1.0 - 2.0 * ((h >> 15) & 0x1).to(torch.float32)
    mant = (h & 0x7FFF).to(torch.float32)
    if tag >= 2:
        mant = mant * 65536.0 + tail1.to(torch.int64).to(torch.float32)
    if tag == 3:
        mant = mant * float(2.0**32) + tail2.to(torch.int64).to(torch.float32)
    vals = sgn * mant * scales.reshape(-1)[cp >> shift]
    prod = vals * x.to(torch.float32)[col]
    rows, width = prod.shape
    if width % 32:
        prod = torch.cat([prod, prod.new_zeros(rows, 32 - width % 32)], dim=1)
    lanes = prod.reshape(rows, -1, 32)
    acc = prod.new_zeros(rows, 32)
    for j in range(lanes.shape[1]):
        acc = acc + lanes[:, j]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0]


def gse_spmv_ell_f32(colpak, head, tail1, tail2, x, scales, *, ei_bit: int,
                     tag: int) -> torch.Tensor:
    """y = A @ x as (M,) f32 from (M, L) ELL segments at ``tag``.

    ``tail1``/``tail2`` may be ``None`` when ``tag`` does not read them.
    ``scales`` is the (k,) or (1, k) f32 table ``ref.make_scales`` gives.
    """
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    if colpak.device.type == "cpu":
        return gse_spmv_ell_f32_plain(colpak, head, tail1, tail2, x, scales,
                                      ei_bit=ei_bit, tag=tag)
    dev = colpak.device
    if dev.type != "cuda":
        raise ValueError(f"gse_spmv_ell_f32 runs on cuda or cpu, not {dev}")
    rows, width = colpak.shape
    _check(colpak, "colpak", torch.uint32, dev, 2)
    _check(head, "head", torch.uint16, dev, 2)
    segs = {"head": head}
    if tag >= 2:
        _check(tail1, "tail1", torch.uint16, dev, 2)
        segs["tail1"] = tail1
    if tag == 3:
        _check(tail2, "tail2", torch.uint32, dev, 2)
        segs["tail2"] = tail2
    for name, t in segs.items():
        if tuple(t.shape) != (rows, width):
            raise ValueError(f"{name} shape {tuple(t.shape)} != colpak's")
    _check(x, "x", torch.float32, dev, 1)
    scales = scales.reshape(-1)
    _check(scales, "scales", torch.float32, dev, 1)
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return y
    rc = _fn("gse_spmv_ell_f32")(
        tag, colpak.data_ptr(), head.data_ptr(),
        tail1.data_ptr() if tag >= 2 else None,
        tail2.data_ptr() if tag == 3 else None,
        x.data_ptr(), scales.data_ptr(), y.data_ptr(), rows, width, ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmv_ell_f32.launches += 1
    _raise_on(rc, "gse_spmv_ell_f32")
    return y


# --- A64: f64 CSR, the solver-loop operator --------------------------------

def gse_spmv_csr_f64_plain(rowptr, colpak, head, tail1, tail2, table, x, *,
                           ei_bit: int, tag) -> torch.Tensor:
    """Plain version of A64: the f64 decode of ``_decode_gsecsr``, then
    each row's products added in CSR order from 0.0 (:func:`csr_row_sums`).
    Padded slots are never read, so a non-finite x spreads as in
    ``spmv_gse``."""
    tag = min(max(int(tag), 1), 3)
    val, col = _decode_gsecsr(colpak, head, tail1, tail2, table, ei_bit, tag)
    prod = val * x.to(torch.float64)[col]
    return csr_row_sums(rowptr, prod[:, None])[:, 0]


def serial_sums(terms) -> torch.Tensor:
    """``(rows, k)`` sums of the ``(rows, w, k)`` terms, each row's ``w``
    terms added one after another from 0.0 (numpy's ``cumsum`` is a
    sequential accumulate; the leading 0.0 makes its first step the
    kernel's ``0.0 + t0``).  Runs on the host, returns on ``terms``'s
    device."""
    host = terms.detach().cpu().numpy()
    chain = np.concatenate([np.zeros_like(host[:, :1]), host], axis=1)
    return torch.from_numpy(np.ascontiguousarray(
        np.cumsum(chain, axis=1)[:, -1])).to(terms.device)


def row_sums(starts, lens, prod) -> torch.Tensor:
    """``(rows, k)`` sums of the ``(slots, k)`` terms ``prod``: row i adds
    ``prod[starts[i]:starts[i] + lens[i]]`` in order from 0.0 (elementwise
    across the k columns), the f64 kernels' chain.  Rows are grouped by the
    power of two above their length and each group's terms padded with
    +0.0, which leaves every chain's bits unchanged (a chain from +0.0
    never holds -0.0).  Slots past a row's length are never read.
    (``index_add_`` would not promise the order.)"""
    dev = prod.device
    y = torch.zeros(lens.shape[0], prod.shape[1], dtype=prod.dtype,
                    device=dev)
    host_lens = lens.cpu().numpy().astype(np.int64)
    group = np.where(host_lens > 0, 1 << np.ceil(np.log2(
        np.maximum(host_lens, 1))).astype(np.int64), 0)
    starts = starts.to(torch.int64)
    lens = lens.to(torch.int64)
    for w in np.unique(group[group > 0]).tolist():
        rows = torch.from_numpy(np.nonzero(group == w)[0]).to(dev)
        slot = torch.arange(w, device=dev)
        has = slot[None, :] < lens[rows, None]
        pos = torch.where(has, starts[rows, None] + slot[None, :], 0)
        y[rows] = serial_sums(torch.where(has[..., None], prod[pos], 0.0))
    return y


def csr_row_sums(rowptr, prod) -> torch.Tensor:
    """``(rows, k)`` sums of the ``(nnz, k)`` CSR-ordered terms ``prod``,
    each row in CSR order from 0.0 (:func:`row_sums`)."""
    rp = rowptr.to(torch.int64)
    return row_sums(rp[:-1], rp[1:] - rp[:-1], prod)


def gse_spmv_csr_f64(rowptr, colpak, head, tail1, tail2, table, x, *,
                     ei_bit: int, tag) -> torch.Tensor:
    """y = A @ x as (M,) f64 over GSE-SEM CSR segments.

    ``tag`` is an int or an int32 tensor on the operand's device (clipped
    to [1, 3] as the reference's ``lax.switch`` clips it); all three
    segment arrays are passed because the tag is chosen on the device.
    """
    if colpak.device.type == "cpu":
        return gse_spmv_csr_f64_plain(rowptr, colpak, head, tail1, tail2,
                                      table, x, ei_bit=ei_bit, tag=tag)
    dev = colpak.device
    if dev.type != "cuda":
        raise ValueError(f"gse_spmv_csr_f64 runs on cuda or cpu, not {dev}")
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
    _check(x, "x", torch.float64, dev, 1)
    if not isinstance(tag, torch.Tensor):
        tag = torch.full((), int(tag), dtype=torch.int32, device=dev)
    _check(tag.reshape(1), "tag", torch.int32, dev, 1)
    rows = rowptr.shape[0] - 1
    y = torch.empty(rows, dtype=torch.float64, device=dev)
    if rows == 0:
        return y
    rc = _fn("gse_spmv_csr_f64")(
        tag.data_ptr(), rowptr.data_ptr(), colpak.data_ptr(), head.data_ptr(),
        tail1.data_ptr(), tail2.data_ptr(), table.data_ptr(), x.data_ptr(),
        y.data_ptr(), rows, ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmv_csr_f64.launches += 1
    _raise_on(rc, "gse_spmv_csr_f64")
    return y


# --- B32 / B64: the SELL-C-sigma layout ---------------------------------------

def sell_rows(buckets, rows_pad: int):
    """Host-side ``[(first row, rows, width, flat offset), ...]`` of the
    ``(n_buckets, 3)`` bucket table of a pack with ``rows_pad`` rows."""
    tab = buckets.tolist()
    ends = [r0 for r0, _, _ in tab[1:]] + [rows_pad]
    return [(r0, end - r0, w, off) for (r0, w, off), end in zip(tab, ends)]


def sell_row_starts(buckets, rows_pad: int, device) -> torch.Tensor:
    """Flat first slot of every bucket row, ``(rows_pad,)`` int64."""
    parts = [off + torch.arange(rows, dtype=torch.int64, device=device) * w
             for _, rows, w, off in sell_rows(buckets, rows_pad)]
    return torch.cat(parts) if parts else torch.zeros(
        0, dtype=torch.int64, device=device)


def sell_scatter(rows_y, perm, rows: int):
    """Rows of the concatenated buckets put back in the original order:
    ``y[perm[r]] = rows_y[r]`` for every real row (the reference's
    ``unperm`` gather)."""
    real = perm >= 0
    y = rows_y.new_zeros((rows,) + tuple(rows_y.shape[1:]))
    y[perm[real].to(torch.int64)] = rows_y[real]
    return y


def _check_sell(segs, buckets, perm, dev):
    for name, t, dt in segs:
        if t is not None:
            _check(t, name, dt, dev, 1)
    _check(buckets, "buckets", torch.int64, dev, 2)
    if buckets.shape[1] != 3:
        raise ValueError(f"buckets must be (n_buckets, 3), got "
                         f"{tuple(buckets.shape)}")
    _check(perm, "perm", torch.int32, dev, 1)


def gse_spmv_sell_f32_plain(colpak, head, tail1, tail2, x, scales, buckets,
                            perm, *, rows: int, ei_bit: int,
                            tag: int) -> torch.Tensor:
    """Plain version of B32: A32's plain version on each bucket's
    ``(rows_b, w_b)`` view of the flat segments, the bucket rows then put
    back in the original order."""
    outs = []
    for _, nrows, w, off in sell_rows(buckets, perm.shape[0]):
        def view(t):
            return None if t is None else t[off:off + nrows * w].view(nrows, w)
        outs.append(gse_spmv_ell_f32_plain(
            view(colpak), view(head), view(tail1), view(tail2), x, scales,
            ei_bit=ei_bit, tag=tag))
    rows_y = torch.cat(outs) if outs else x.new_zeros(0, dtype=torch.float32)
    return sell_scatter(rows_y, perm, rows)


def gse_spmv_sell_f32(colpak, head, tail1, tail2, x, scales, buckets, perm,
                      *, rows: int, ei_bit: int, tag: int) -> torch.Tensor:
    """y = A @ x as (rows,) f32 from the flat SELL segments at ``tag``.

    ``tail1``/``tail2`` may be ``None`` when ``tag`` does not read them;
    ``scales`` is the (k,) or (1, k) f32 table ``ref.make_scales`` gives.
    """
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    if colpak.device.type == "cpu":
        return gse_spmv_sell_f32_plain(colpak, head, tail1, tail2, x, scales,
                                       buckets, perm, rows=rows,
                                       ei_bit=ei_bit, tag=tag)
    dev = colpak.device
    if dev.type != "cuda":
        raise ValueError(f"gse_spmv_sell_f32 runs on cuda or cpu, not {dev}")
    _check_sell((("colpak", colpak, torch.uint32), ("head", head, torch.uint16),
                 ("tail1", tail1 if tag >= 2 else None, torch.uint16),
                 ("tail2", tail2 if tag == 3 else None, torch.uint32)),
                buckets, perm, dev)
    _check(x, "x", torch.float32, dev, 1)
    scales = scales.reshape(-1)
    _check(scales, "scales", torch.float32, dev, 1)
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    if perm.shape[0] == 0:
        return y
    rc = _fn("gse_spmv_sell_f32")(
        tag, colpak.data_ptr(), head.data_ptr(),
        tail1.data_ptr() if tag >= 2 else None,
        tail2.data_ptr() if tag == 3 else None,
        x.data_ptr(), scales.data_ptr(), y.data_ptr(), buckets.data_ptr(),
        buckets.shape[0], perm.data_ptr(), perm.shape[0], ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmv_sell_f32.launches += 1
    _raise_on(rc, "gse_spmv_sell_f32")
    return y


def gse_spmv_sell_f64_plain(colpak, head, tail1, tail2, table, x, buckets,
                            perm, row_len, *, rows: int, ei_bit: int,
                            tag) -> torch.Tensor:
    """Plain version of B64: the f64 decode of ``_decode_gsecsr`` over the
    flat slots, then each bucket row's ``row_len`` real slots added in
    slot order from 0.0 (:func:`row_sums`), put back in the original
    order.  Padded slots are never added."""
    tag = min(max(int(tag), 1), 3)
    val, col = _decode_gsecsr(colpak, head, tail1, tail2, table, ei_bit, tag)
    prod = val * x.to(torch.float64)[col]
    starts = sell_row_starts(buckets, perm.shape[0], prod.device)
    rows_y = row_sums(starts, row_len, prod[:, None])[:, 0]
    return sell_scatter(rows_y, perm, rows)


def gse_spmv_sell_f64(colpak, head, tail1, tail2, table, x, buckets, perm,
                      row_len, *, rows: int, ei_bit: int, tag,
                      long_from: int | None = None) -> torch.Tensor:
    """y = A @ x as (rows,) f64 over the flat SELL segments.

    ``tag`` is an int or an int32 tensor on the operand's device (clipped
    to [1, 3]); all three segment arrays are passed because the tag is
    chosen on the device.  ``row_len`` is each bucket row's real entry
    count.  ``long_from`` (required on the card) is the pack's
    ``GSESellC.long_from``.
    """
    if colpak.device.type == "cpu":
        return gse_spmv_sell_f64_plain(colpak, head, tail1, tail2, table, x,
                                       buckets, perm, row_len, rows=rows,
                                       ei_bit=ei_bit, tag=tag)
    dev = colpak.device
    if dev.type != "cuda":
        raise ValueError(f"gse_spmv_sell_f64 runs on cuda or cpu, not {dev}")
    _check_sell((("colpak", colpak, torch.uint32), ("head", head, torch.uint16),
                 ("tail1", tail1, torch.uint16),
                 ("tail2", tail2, torch.uint32)), buckets, perm, dev)
    _check(row_len, "row_len", torch.int32, dev, 1)
    _check(table, "table", torch.int32, dev, 1)
    _check(x, "x", torch.float64, dev, 1)
    if not isinstance(tag, torch.Tensor):
        tag = torch.full((), int(tag), dtype=torch.int32, device=dev)
    _check(tag.reshape(1), "tag", torch.int32, dev, 1)
    if long_from is None or not 0 <= long_from <= perm.shape[0]:
        raise ValueError(f"long_from must be the pack's long_from, in "
                         f"[0, {perm.shape[0]}], got {long_from}")
    y = torch.empty(rows, dtype=torch.float64, device=dev)
    if perm.shape[0] == 0:
        return y
    rc = _fn("gse_spmv_sell_f64")(
        tag.data_ptr(), colpak.data_ptr(), head.data_ptr(), tail1.data_ptr(),
        tail2.data_ptr(), table.data_ptr(), x.data_ptr(), y.data_ptr(),
        buckets.data_ptr(), buckets.shape[0], perm.data_ptr(),
        row_len.data_ptr(), perm.shape[0], long_from, ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmv_sell_f64.launches += 1
    _raise_on(rc, "gse_spmv_sell_f64")
    return y


def gse_spmv_sell_f64_warp(colpak, head, tail1, tail2, table, x, buckets,
                           perm, row_len, *, rows: int, ei_bit: int,
                           tag) -> torch.Tensor:
    """The earlier design of B64 on CUDA tensors: every row on one warp,
    two warps per block.  No solver path calls it; ``chip_smoke.py`` times
    it beside :func:`gse_spmv_sell_f64`, on one card."""
    dev = colpak.device
    if dev.type != "cuda":
        raise ValueError(f"gse_spmv_sell_f64_warp runs on cuda, not {dev}")
    _check_sell((("colpak", colpak, torch.uint32), ("head", head, torch.uint16),
                 ("tail1", tail1, torch.uint16),
                 ("tail2", tail2, torch.uint32)), buckets, perm, dev)
    _check(row_len, "row_len", torch.int32, dev, 1)
    _check(table, "table", torch.int32, dev, 1)
    _check(x, "x", torch.float64, dev, 1)
    if not isinstance(tag, torch.Tensor):
        tag = torch.full((), int(tag), dtype=torch.int32, device=dev)
    _check(tag.reshape(1), "tag", torch.int32, dev, 1)
    y = torch.empty(rows, dtype=torch.float64, device=dev)
    rc = _fn("gse_spmv_sell_f64_warp")(
        tag.data_ptr(), colpak.data_ptr(), head.data_ptr(), tail1.data_ptr(),
        tail2.data_ptr(), table.data_ptr(), x.data_ptr(), y.data_ptr(),
        buckets.data_ptr(), buckets.shape[0], perm.data_ptr(),
        row_len.data_ptr(), perm.shape[0], ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_spmv_sell_f64_warp.launches += 1
    _raise_on(rc, "gse_spmv_sell_f64_warp")
    return y


KERNELS = (gse_spmv_ell_f32, gse_spmv_csr_f64, gse_spmv_sell_f32,
           gse_spmv_sell_f64, gse_spmv_sell_f64_warp)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
