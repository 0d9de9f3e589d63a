"""Kernel F: flash attention (online softmax), hand-written for Hopper.

Replaces the Pallas kernel ``flash_attention_pallas`` of
``repro/kernels/flash_attn.py`` (:76; body ``_flash_body``,
``pallas_call`` :89).  The CUDA source is ``csrc/flash_attn.cu``.

The function: q, k, v cast to f32, scores ``(q . k) * scale`` with
``scale`` the f32 of ``1/sqrt(hd)``, causal positions (key j > query i, on
global indices) filled with -1e30, softmax over the keys, ``p @ v``, the
output in q's dtype.  The kernel computes it with the Pallas kernel's
online softmax (running max, sum and accumulator per query row, ``out =
acc / max(l, 1e-30)``); the score matrix never exists in device memory.

:func:`flash_attention_gqa` takes the model's layout -- q ``(B, S, H,
hd)``, k and v ``(B, T, KV, hd)``, any strides with a contiguous last
dimension -- and lets query head h read KV head ``h // (H // KV)`` without
repeating K and V (the grouping of ``models/attention.py::_attend``).
:func:`flash_attention` is the reference's ``(BH, S, hd)`` signature.
Any S and T run (no padding upstream); hd <= 128.

Two CUDA bodies, chosen by :func:`flash_body` from the dtype and hd
before launch (never after a failed launch or build):

* ``"mma"``: bf16 q, k, v with hd a multiple of 16 -- the model's bf16
  prefill.  Both products on the tensor cores (``mma.sync`` m16n8k16, bf16
  in, f32 sums): q . k is the reference's f32 dot of bf16 values (each
  product exact in f32, the sum in another order) and ``p @ v`` takes p
  rounded to bf16.  Bound by 4 * S * T * hd operations per (batch, head),
  halved when causal, at the bf16 tensor-core rate.  Its rows are read
  with 16-byte copies: a q, k or v whose pointer or strides are not
  16-byte multiples is copied to a fresh contiguous tensor first.
* ``"ffma"``: f32 (the f32 twin's model), and bf16 with another hd.  The
  same operations in FP32 FFMA from shared memory.

Sums and exponentials run in another order than the plain version's
softmax, so the kernel is held to it within the reference kernel tests'
tolerances (rtol/atol 2e-5 in f32, 2e-2 in bf16).  The wrapper launches
the kernel for CUDA tensors (or raises) and runs
:func:`flash_attention_gqa_plain` only for CPU tensors; it counts its
launches in its ``launches`` attribute and per body in
``body_launches``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gse_spmv import _raise_on
from repro_torch.kernels.vec_f64 import on_device

__all__ = ["flash_attention", "flash_attention_gqa",
           "flash_attention_gqa_plain", "flash_body", "BODIES", "KERNELS",
           "reset_launch_counts", "HD_MAX", "NEG_INF"]

NEG_INF = -1e30
HD_MAX = 128
_DTYPES = (torch.float32, torch.bfloat16)
BODIES = ("mma", "ffma")
_P = ctypes.c_void_p
_I = ctypes.c_int
_BOUND = {}


def _fn():
    fn = _BOUND.get("flash")
    if fn is None:
        fn = _build.load("flash_attn").flash_attention_fwd
        fn.argtypes = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                       _I, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        _BOUND["flash"] = fn
    return fn


def _scale(hd: int) -> float:
    """``1/sqrt(hd)`` rounded to f32, as the Pallas kernel uses it."""
    return float(np.float32(1.0 / math.sqrt(hd)))


def flash_body(dtype, hd: int) -> str:
    """The CUDA body F launches for q, k, v of ``dtype`` and head dim
    ``hd``: ``"mma"`` (tensor cores) for bf16 with hd a multiple of 16 up
    to ``HD_MAX``, ``"ffma"`` otherwise."""
    if dtype == torch.bfloat16 and hd % 16 == 0 and 0 < hd <= HD_MAX:
        return "mma"
    return "ffma"


def _rows16(t):
    """t itself if every row starts on 16 bytes (the tensor-core body's
    copies), else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_gqa_plain(q, k, v, *, causal: bool = True):
    """Plain version of F: the full softmax in f32 over ``(B, KV, G, S,
    T)`` scores, the output ``(B, S, H, hd)`` in q's dtype."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          k.to(torch.float32)) * _scale(hd)
    if causal:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(j > i, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_attention_gqa(q, k, v, *, causal: bool = True, device="cuda",
                        body: str | None = None) -> torch.Tensor:
    """Softmax attention of q ``(B, S, H, hd)`` over k, v ``(B, T, KV,
    hd)`` with H a multiple of KV; returns ``(B, S, H, hd)`` in q's
    dtype.  ``body`` (CUDA only) overrides :func:`flash_body`'s choice, to
    time one body against the other; "mma" still needs bf16 and hd % 16
    == 0."""
    dev = on_device(device, q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, S, H, hd) and k, v (B, T, KV, hd)")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh == 0 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not fit: H must be a multiple of KV")
    if dev.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_gqa runs on cuda or cpu, not {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share f32 or bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if hd > HD_MAX:
        raise ValueError(f"head_dim {hd} > {HD_MAX}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last dimension")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must share one device")
    chosen = flash_body(q.dtype, hd)
    body = body or chosen
    if body not in BODIES or (body == "mma" and chosen != "mma"):
        raise ValueError(f"body {body!r} does not take {q.dtype} at hd {hd}")
    out = torch.empty(b, s, h, hd, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if body == "mma":
        q, k, v = _rows16(q), _rows16(k), _rows16(v)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    rc = _fn()(int(body == "mma"), int(q.dtype == torch.bfloat16),
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
               t, h, kvh, hd, strides, int(causal), _scale(hd),
               torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_gqa.launches += 1
    flash_attention_gqa.body_launches[body] += 1
    _raise_on(rc, "flash_attention_gqa")
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    device="cuda") -> torch.Tensor:
    """The reference's signature: q ``(BH, S, hd)``, k, v ``(BH, T, hd)``
    -> ``(BH, S, hd)`` in q's dtype."""
    out = flash_attention_gqa(q[:, :, None, :], k[:, :, None, :],
                              v[:, :, None, :], causal=causal, device=device)
    return out[:, :, 0, :]


KERNELS = (flash_attention_gqa,)


def reset_launch_counts():
    """Zero ``launches`` and the per-body ``body_launches``."""
    for k in KERNELS:
        k.launches = 0
    flash_attention_gqa.body_launches = dict.fromkeys(BODIES, 0)


reset_launch_counts()
