"""Kernel A: the tag-specialized GSE-SEM SpMV, hand-written for Hopper.

Replaces the Pallas kernel ``gse_spmv_call`` of
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

Both are bound by HBM bytes: 6/8/12 B/nnz of segments at tags 1/2/3 plus
the x gather.  Each wrapper launches its kernel for CUDA tensors (or
raises) and runs the plain PyTorch version only for CPU tensors.  Each
wrapper counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.sparse.spmv import _decode_gsecsr

__all__ = ["gse_spmv_ell_f32", "gse_spmv_ell_f32_plain", "gse_spmv_csr_f64",
           "gse_spmv_csr_f64_plain", "KERNELS", "reset_launch_counts"]

_P = ctypes.c_void_p
_ARGTYPES = {
    "gse_spmv_ell_f32": [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    "gse_spmv_csr_f64": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         ctypes.c_longlong, ctypes.c_int, _P],
}
_BOUND = {}


def _fn(name: str):
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(_build.load("gse_spmv"), name)
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


def csr_row_sums(rowptr, prod) -> torch.Tensor:
    """``(rows, k)`` sums of the ``(nnz, k)`` CSR-ordered terms ``prod``:
    each row's terms added in CSR order from 0.0, one slot of the
    row-padded layout at a time, vectorised over rows and the k columns
    (elementwise, so column c is the sum of ``prod[:, c]`` alone).  Padded
    slots are never read.  (``index_add_`` would not promise the order.)"""
    rp = rowptr.to(torch.int64)
    starts, lens = rp[:-1], rp[1:] - rp[:-1]
    y = torch.zeros(lens.shape[0], prod.shape[1], dtype=prod.dtype,
                    device=prod.device)
    if prod.shape[0] == 0:
        return y
    slot = torch.arange(int(lens.max()), device=prod.device)
    has = slot[None, :] < lens[:, None]
    terms = prod[torch.where(has, starts[:, None] + slot[None, :], 0)]
    for j in range(slot.shape[0]):
        y = torch.where(has[:, j, None], y + terms[:, j], y)
    return y


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


KERNELS = (gse_spmv_ell_f32, gse_spmv_csr_f64)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
