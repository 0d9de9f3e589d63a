"""Kernel D: the dense GSE-SEM decode, hand-written for Hopper.

Replaces the Pallas kernel ``decode_pallas`` of
``repro/kernels/gse_decode.py`` (:50; body ``decode_kernel_body``,
``pallas_call`` :59).  The CUDA source is ``csrc/gse_dense.cu``, shared
with kernel E (``kernels/gse_matmul.py``).

Dense packs keep expIdx in the head below the sign (``m_h = 15 -
ei_bit``); this is not the sparse layout of ``csrc/gse_decode.cuh``.  The
value is ``(sgn * mant) * scales[expIdx]`` in f32 in the Pallas body's
order (the tag-3 mantissa spliced as ``(m * 2^16 + tail1) * 2^32 +
tail2``), which is bitwise the reference's ``ref.decode_ref`` and
``gse.decode_jnp(..., float32)`` for values in f32's normal range.  ``scales`` is the (k,) f32
table ``ref.make_scales`` gives: bias 1023 for ``gse.pack`` packs, 127 for
the model's f32-source segments.  The output is f32 or bf16 (rounded to
nearest even, as ``astype`` rounds).

Bound by HBM bytes: 2/4/8 segment bytes per value at tags 1/2/3 in, 4 or
2 out.  :func:`gse_decode_dense` launches the kernel for CUDA tensors (or
raises) and runs :func:`gse_decode_dense_plain` only for CPU tensors; it
counts its launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gse_spmv import _raise_on
from repro_torch.kernels.vec_f64 import on_device, refuse_grad

__all__ = ["gse_decode_dense", "gse_decode_dense_plain", "KERNELS",
           "reset_launch_counts"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGTYPES = {
    "gse_decode_dense": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _LL,
                         ctypes.c_int, _P],
    "gse_matmul_dense": [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
                         _LL, _LL, _LL, ctypes.c_int, _P, _P, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
}
_BOUND = {}
OUT_DTYPES = (torch.float32, torch.bfloat16)

# Values decoded per pass of the plain version: bounds its temporaries on
# a full-width unembedding (the CPU twin).
_CHUNK = 1 << 24


def dense_fn(name: str):
    """The bound C entry point ``name`` of ``csrc/gse_dense.cu``."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(_build.load("gse_dense"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def check_segments(head, tail1, tail2, tag: int, dev):
    """Type, device, shape and contiguity of the segments a tag reads."""
    if tag not in (1, 2, 3):
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    segs = {"head": (head, torch.uint16)}
    if tag >= 2:
        segs["tail1"] = (tail1, torch.uint16)
    if tag == 3:
        segs["tail2"] = (tail2, torch.uint32)
    for name, (t, dtype) in segs.items():
        if t is None:
            raise ValueError(f"tag {tag} reads {name}, got None")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.shape != head.shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and shaped like head")


def check_scales(scales, dev):
    if scales.dim() != 1:
        scales = scales.reshape(-1)
    if scales.dtype != torch.float32 or scales.device != dev \
            or not scales.is_contiguous():
        raise ValueError(f"scales must be a contiguous f32 tensor on {dev}")
    return scales


def decode_values(head, tail1, tail2, scales, ei_bit: int,
                  tag: int) -> torch.Tensor:
    """f32 values of the segments (torch ops), bit for bit the kernel's
    ``(sgn * mant) * scales[expIdx]``.

    Two exact rewrites make it a few passes over the data: the sign and
    the scale come from one table over the head's top ``1 + ei_bit`` bits
    (a sign flip is exact, so ``(sgn * mant) * scale == mant * (sgn *
    scale)``), and the tag-2 mantissa is the integer ``m_head << 16 |
    tail1`` converted once, which rounds as ``m_head * 2^16 + tail1``
    does in f32 (the product is exact; the sum rounds the same integer).
    """
    m_h = 15 - ei_bit
    h = head.to(torch.int32)
    top = torch.arange(1 << (1 + ei_bit), dtype=torch.int32,
                       device=head.device)
    scales = scales.reshape(-1)
    pad = (1 << ei_bit) - scales.numel()  # k need not be a power of two
    if pad > 0:
        scales = torch.cat([scales, scales.new_zeros(pad)])
    sgn_scale = ((1.0 - 2.0 * (top >> ei_bit).to(torch.float32))
                 * scales[(top & ((1 << ei_bit) - 1)).to(torch.int64)])
    m = h & ((1 << m_h) - 1)
    if tag >= 2:
        m = (m << 16) | tail1.to(torch.int32)
    mant = m.to(torch.float32)
    if tag == 3:
        mant = mant * float(2.0**32) + tail2.to(torch.int64).to(torch.float32)
    return mant * sgn_scale[(h >> m_h).to(torch.int64)]


def gse_decode_dense_plain(head, tail1, tail2, scales, *, ei_bit: int,
                           tag: int, out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of D, in chunks of the flattened tensor."""
    out = torch.empty(head.shape, dtype=out_dtype, device=head.device)
    flat = out.reshape(-1)
    segs = [t.reshape(-1) if t is not None and t.numel() else None
            for t in (head, tail1, tail2)]
    for lo in range(0, flat.numel(), _CHUNK):
        part = [t[lo:lo + _CHUNK] if t is not None else None for t in segs]
        flat[lo:lo + _CHUNK] = decode_values(*part, scales, ei_bit,
                                             tag).to(out_dtype)
    return out


def gse_decode_dense(head, tail1, tail2, scales, *, ei_bit: int, tag: int,
                     out_dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Decode dense GSE-SEM segments (any shape, head-split layout) to
    ``out_dtype`` (f32 or bf16) at ``tag``.

    ``tail1``/``tail2`` may be ``None`` when ``tag`` does not read them.
    """
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be f32 or bf16, got {out_dtype}")
    dev = on_device(device, head=head, scales=scales,
                    tail1=tail1 if tag >= 2 else None,
                    tail2=tail2 if tag == 3 else None)
    refuse_grad("gse_decode_dense", scales=scales)
    if dev.type == "cpu":
        return gse_decode_dense_plain(head, tail1, tail2, scales,
                                      ei_bit=ei_bit, tag=tag,
                                      out_dtype=out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"gse_decode_dense runs on cuda or cpu, not {dev}")
    dev = head.device
    check_segments(head, tail1, tail2, tag, dev)
    scales = check_scales(scales, dev)
    out = torch.empty(head.shape, dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    rc = dense_fn("gse_decode_dense")(
        tag, int(out_dtype == torch.bfloat16), head.data_ptr(),
        tail1.data_ptr() if tag >= 2 else None,
        tail2.data_ptr() if tag == 3 else None, scales.data_ptr(),
        out.data_ptr(), out.numel(), ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_decode_dense.launches += 1
    _raise_on(rc, "gse_decode_dense")
    return out


KERNELS = (gse_decode_dense,)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
