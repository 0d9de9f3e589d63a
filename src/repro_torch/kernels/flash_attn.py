"""Kernel F: flash attention (online softmax), hand-written for Hopper.

Replaces the Pallas kernel ``flash_attention_pallas`` of
``repro/kernels/flash_attn.py`` (:76; body ``_flash_body``,
``pallas_call`` :89).  The CUDA source is ``csrc/flash_attn.cu``.

The function: q, k, v cast to f32, scores ``(q . k) * scale`` with
``scale`` the f32 of ``1/sqrt(hd)``, causal positions (key j > query i, on
global indices) filled with -1e30, softmax over the keys, ``p @ v``, the
output in q's dtype.  A local ``window`` (causal only: RecurrentGemma's
local attention, ``models/attention.py``) also fills the keys ``j <= i -
window`` with -1e30, so query i sees keys ``i - window < j <= i``, the
reference's mask (``repro/models/attention.py:157-162``).  The kernel
computes it with the Pallas kernel's online softmax (running max, sum and
accumulator per query row, ``out = acc / max(l, 1e-30)``); the score
matrix never exists in device memory.

:func:`flash_attention_gqa` takes the model's layout -- q ``(B, S, H,
hd)``, k and v ``(B, T, KV, hd)``, any strides with a contiguous last
dimension -- and lets query head h read KV head ``h // (H // KV)`` without
repeating K and V (the grouping of ``models/attention.py::_attend``).
:func:`flash_attention` is the reference's ``(BH, S, hd)`` signature.
Any S and T run (no padding upstream); hd <= 256.

Two CUDA bodies, chosen by :func:`flash_body` from the dtype and hd
before launch (never after a failed launch or build):

* ``"mma"``: bf16 q, k, v with hd a multiple of 16 -- the model's bf16
  prefill.  Both products on the tensor cores (``mma.sync`` m16n8k16, bf16
  in, f32 sums): q . k is the reference's f32 dot of bf16 values (each
  product exact in f32, the sum in another order) and ``p @ v`` takes p
  rounded to bf16.  Bound by 4 * S * T * hd operations per (batch, head),
  halved when causal, at the bf16 tensor-core rate (with a window, 4 *
  hd * sum_i min(i + 1, window) per (batch, head)).  At hd 256 the Q
  fragments are read from shared memory at every key tile instead of
  being held in registers (O alone takes 128 registers a thread there).
  Its rows are read with 16-byte copies: a q, k or v whose pointer or
  strides are not 16-byte multiples is copied to a fresh contiguous
  tensor first.
* ``"ffma"``: f32 (the f32 twin's model), and bf16 with another hd.  The
  same operations in FP32 FFMA from register tiles, as an SGEMM computes:
  a block of 256 threads per 128 queries, each thread 8 queries x 4 keys
  of S and 8 queries x hd / 16 dims of O, Q and the double-buffered K and
  V tiles (64 keys, ``cp.async`` for f32) in shared memory read 16 bytes
  at a time; hd is zero-padded to 16, 32, 64, 128 or 256, each compiled.
  At 256 a block of 128 threads takes 64 queries and key tiles of 32, so
  its tiles fit in shared memory (206 KB) and O stays 128 registers a
  thread.

Sums and exponentials run in another order than the plain version's
softmax, so the kernel is held to it within the reference kernel tests'
tolerances (rtol/atol 2e-5 in f32, 2e-2 in bf16).  The key loop starts at
the first tile that reaches ``q0 - window + 1`` and a warp skips a tile
wholly outside its rows' windows.  Windows and hd 256 are compiled only
into a second library, ``flash_attn_window`` (the same source with
``FLASH_WINDOW=1``), which the wrapper loads for a window above 0 or hd
above 128.  At ``window = 0`` and hd <= 128 it launches the plain build,
the kernels of before, bitwise and at their speed (on an H100, with the
window compiled in they ran 9-36% slower at qwen3_4b's shapes, the
tensor-core body still 12% with it folded away).  The wrapper launches
the kernel for CUDA tensors (or raises) and runs
:func:`flash_attention_gqa_plain` only for CPU tensors; it counts its
launches in its ``launches`` attribute, per body in ``body_launches``,
the windowed ones per body in ``window_launches`` and the non-causal ones
(an encoder's self-attention, a decoder's cross-attention) per body in
``noncausal_launches``.
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
HD_MAX = 256
_DTYPES = (torch.float32, torch.bfloat16)
BODIES = ("mma", "ffma")
_BODY_ID = {"ffma": 0, "mma": 1}  # flash_attention_fwd's
_P = ctypes.c_void_p
_I = ctypes.c_int
_BOUND = {}


def _fn(window: int, hd: int):
    """The entry point of the plain build, or of the windowed build
    (``flash_attn_window``: windows and hd 256 compiled in) for a window
    above 0 or hd above 128."""
    name = "flash_attn_window" if window or hd > 128 else "flash_attn"
    fn = _BOUND.get(name)
    if fn is None:
        fn = _build.load(name).flash_attention_fwd
        fn.argtypes = [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                       _I, _I, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def _scale(hd: int) -> float:
    """``1/sqrt(hd)`` rounded to f32, as the Pallas kernel uses it."""
    return float(np.float32(1.0 / math.sqrt(hd)))


def flash_body(dtype, hd: int) -> str:
    """The CUDA body F launches for q, k, v of ``dtype`` and head dim
    ``hd``: ``"mma"`` (tensor cores) for bf16 with hd a multiple of 16 up
    to 128, or 256, ``"ffma"`` otherwise."""
    if dtype == torch.bfloat16 and (hd == 256 or (hd % 16 == 0
                                                   and 0 < hd <= 128)):
        return "mma"
    return "ffma"


def _rows16(t):
    """t itself if every row starts on 16 bytes (the tensor-core body's
    copies), else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_window(window: int, causal: bool) -> int:
    window = int(window)
    if window < 0 or (window and not causal):
        raise ValueError(f"window {window} needs causal attention and "
                         "window >= 0")
    return window


def flash_attention_gqa_plain(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """Plain version of F: the full softmax in f32 over ``(B, KV, G, S,
    T)`` scores, the output ``(B, S, H, hd)`` in q's dtype."""
    window = _check_window(window, causal)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, s, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          k.to(torch.float32)) * _scale(hd)
    if causal:
        i = torch.arange(s, device=q.device)[:, None]
        j = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(j > i, NEG_INF)
        if window:
            scores = scores.masked_fill(j <= i - window, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_attention_gqa(q, k, v, *, causal: bool = True, window: int = 0,
                        device="cuda", body: str | None = None
                        ) -> torch.Tensor:
    """Softmax attention of q ``(B, S, H, hd)`` over k, v ``(B, T, KV,
    hd)`` with H a multiple of KV; returns ``(B, S, H, hd)`` in q's
    dtype.  ``window`` > 0 (causal only) keeps the keys ``i - window < j
    <= i`` of query i.  ``body`` (CUDA only) overrides :func:`flash_body`'s
    choice, to time one body against another; "mma" still needs bf16 and
    hd % 16 == 0 (up to 128, or 256)."""
    dev = on_device(device, q=q, k=k, v=v)
    window = _check_window(window, causal)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, S, H, hd) and k, v (B, T, KV, hd)")
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh == 0 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not fit: H must be a multiple of KV")
    if dev.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal=causal,
                                         window=window)
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
    rc = _fn(window, hd)(_BODY_ID[body], int(q.dtype == torch.bfloat16),
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
               t, h, kvh, hd, strides, int(causal), window, _scale(hd),
               torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_gqa.launches += 1
    flash_attention_gqa.body_launches[body] += 1
    if window:
        flash_attention_gqa.window_launches[body] += 1
    if not causal:
        flash_attention_gqa.noncausal_launches[body] += 1
    _raise_on(rc, "flash_attention_gqa")
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    device="cuda") -> torch.Tensor:
    """The reference's signature: q ``(BH, S, hd)``, k, v ``(BH, T, hd)``
    -> ``(BH, S, hd)`` in q's dtype."""
    out = flash_attention_gqa(q[:, :, None, :], k[:, :, None, :],
                              v[:, :, None, :], causal=causal, window=window,
                              device=device)
    return out[:, :, 0, :]


KERNELS = (flash_attention_gqa,)


def reset_launch_counts():
    """Zero ``launches`` and the per-body ``body_launches``,
    ``window_launches`` and ``noncausal_launches``."""
    for k in KERNELS:
        k.launches = 0
    flash_attention_gqa.body_launches = dict.fromkeys(BODIES, 0)
    flash_attention_gqa.window_launches = dict.fromkeys(BODIES, 0)
    flash_attention_gqa.noncausal_launches = dict.fromkeys(BODIES, 0)


reset_launch_counts()
