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
segments); Y is ``(M, N)`` f32, summed in f32 with FFMA (no TF32: the
oracle ``ref.matmul_ref`` is a full-f32 product).  At M <= 8 (the decode
steps, M = batch) a GEMV body reads each weight once, bound by the weight
stream (2/4/8 bytes per weight at tags 1/2/3); above it (prefill, M = B *
S) 64 x 64 tiles reuse each decoded W tile for 64 rows, bound by FP32
operations.  Any M, N, K run without padding.  Sums run in another order
than ``torch.matmul``'s, so the kernel is held to its plain version within
the reference kernel tests' tolerance (rtol 1e-5 / atol 1e-4).

:func:`gse_matmul_dense` launches the kernel for CUDA tensors (or raises)
and runs :func:`gse_matmul_dense_plain` only for CPU tensors; it counts its
launches in its ``launches`` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gse_decode import (check_scales, check_segments,
                                            dense_fn, gse_decode_dense_plain)
from repro_torch.kernels.gse_spmv import _raise_on
from repro_torch.kernels.vec_f64 import on_device

__all__ = ["gse_matmul_dense", "gse_matmul_dense_plain", "KERNELS",
           "reset_launch_counts", "X_DTYPES"]

X_DTYPES = (torch.float32, torch.bfloat16)

# Weights decoded per pass of the plain version (columns of W at a time).
_CHUNK = 1 << 24


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
        w = gse_decode_dense_plain(
            head[:, cols], tail1[:, cols] if tag >= 2 else None,
            tail2[:, cols] if tag == 3 else None, scales, ei_bit=ei_bit,
            tag=tag)
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
    rc = dense_fn("gse_matmul_dense")(
        tag, int(x.dtype == torch.bfloat16), x.data_ptr(), head.data_ptr(),
        tail1.data_ptr() if tag >= 2 else None,
        tail2.data_ptr() if tag == 3 else None, scales.data_ptr(),
        y.data_ptr(), m, kk, n, ei_bit,
        torch.cuda.current_stream(dev).cuda_stream)
    gse_matmul_dense.launches += 1
    _raise_on(rc, "gse_matmul_dense")
    return y


KERNELS = (gse_matmul_dense,)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
