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

Training: where autograd records on CUDA tensors,
:func:`flash_attention_gqa` runs through a ``torch.autograd.Function``
whose forward launches F with its
optional row statistic ``lse = m + log(max(l, 1e-30))`` (f32 ``(B, H,
S)``, written at the bodies' epilogue; ``lse_launches`` counts those
forwards) and whose backward launches :func:`flash_attention_gqa_bwd`
(``csrc/flash_attn_bwd.cu``: the standard flash-attention backward, P
recomputed from lse under the same mask, dQ over query tiles and dK/dV
over key tiles and the group's heads, deterministic, no atomics; hd <=
128).  The reference trains through its plain ``_attend`` and has no
backward kernel; the plain version of this one is autograd through
:func:`flash_attention_gqa_plain`
(:func:`flash_attention_gqa_bwd_plain`), which CPU tensors take.  Without
grad the serve paths launch F as before, no row statistic written.
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
           "flash_attention_gqa_plain", "flash_lse_plain",
           "flash_attention_gqa_bwd", "flash_attention_gqa_bwd_plain",
           "flash_body", "BODIES", "KERNELS", "reset_launch_counts",
           "HD_MAX", "BWD_HD_MAX", "NEG_INF"]

NEG_INF = -1e30
HD_MAX = 256
BWD_HD_MAX = 128  # the backward's head dims; 256 is ROADMAP queue 1 item 18
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
                       _I, _I, ctypes.c_float, _P, _P]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def _bwd_fn():
    """The backward's entry point (``csrc/flash_attn_bwd.cu``)."""
    fn = _BOUND.get("flash_attn_bwd")
    if fn is None:
        fn = _build.load("flash_attn_bwd").flash_attention_bwd
        fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _I, _I, _I, _P, _I, _I, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        _BOUND["flash_attn_bwd"] = fn
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


def _scores_plain(q, k, causal: bool, window: int):
    """The plain version's f32 scores ``(B, KV, G, S, T)``, masked."""
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
    return scores


def flash_attention_gqa_plain(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """Plain version of F: the full softmax in f32 over ``(B, KV, G, S,
    T)`` scores, the output ``(B, S, H, hd)`` in q's dtype."""
    window = _check_window(window, causal)
    b, s, h, hd = q.shape
    p = torch.softmax(_scores_plain(q, k, causal, window), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(b, s, h, hd).to(q.dtype)


def flash_lse_plain(q, k, *, causal: bool = True, window: int = 0):
    """Plain version of the forward's row statistic: each query row's
    log-sum-exp over its masked scores, f32 ``(B, H, S)``."""
    window = _check_window(window, causal)
    b, s, h, _ = q.shape
    lse = torch.logsumexp(_scores_plain(q, k, causal, window), dim=-1)
    return lse.reshape(b, h, s)


def flash_attention_gqa_bwd_plain(q, k, v, dout, *, causal: bool = True,
                                  window: int = 0):
    """Plain version of F's backward: autograd through
    :func:`flash_attention_gqa_plain`.  Returns (dq, dk, dv) in the dtypes
    of q, k and v."""
    with torch.enable_grad():
        qa, ka, va = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_gqa_plain(qa, ka, va, causal=causal,
                                        window=window)
        return torch.autograd.grad(out, (qa, ka, va), dout)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q (B, S, H, hd) and k, v (B, T, KV, hd)")
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or kvh == 0 or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do "
                         "not fit: H must be a multiple of KV")


def _check_cuda(q, k, v, dev):
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_gqa runs on cuda or cpu, not {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share f32 or bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.shape[3] > HD_MAX:
        raise ValueError(f"head_dim {q.shape[3]} > {HD_MAX}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("q, k, v need a contiguous last dimension")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k, v must share one device")


def _strides(q, k, v):
    return (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])


def _launch_fwd(q, k, v, causal: bool, window: int, body: str | None,
                want_lse: bool):
    """Launch F on CUDA q, k, v (checked); returns (out, lse or None)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    chosen = flash_body(q.dtype, hd)
    body = body or chosen
    if body not in BODIES or (body == "mma" and chosen != "mma"):
        raise ValueError(f"body {body!r} does not take {q.dtype} at hd {hd}")
    out = torch.empty(b, s, h, hd, dtype=q.dtype, device=q.device)
    lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
           if want_lse else None)
    if out.numel() == 0:
        return out, lse
    if body == "mma":
        q, k, v = _rows16(q), _rows16(k), _rows16(v)
    rc = _fn(window, hd)(_BODY_ID[body], int(q.dtype == torch.bfloat16),
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
               t, h, kvh, hd, _strides(q, k, v), int(causal), window,
               _scale(hd), lse.data_ptr() if want_lse else None,
               torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_gqa.launches += 1
    flash_attention_gqa.body_launches[body] += 1
    if window:
        flash_attention_gqa.window_launches[body] += 1
    if not causal:
        flash_attention_gqa.noncausal_launches[body] += 1
    if want_lse:
        flash_attention_gqa.lse_launches[body] += 1
    _raise_on(rc, "flash_attention_gqa")
    return out, lse


class _Flash(torch.autograd.Function):
    """F with its backward, on CUDA tensors.  The forward launches F and
    keeps its row statistic ``lse``; the backward launches
    :func:`flash_attention_gqa_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, body):
        out, lse = _launch_fwd(q, k, v, causal, window, body, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_gqa_bwd(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window,
            device=q.device)
        return dq, dk, dv, None, None, None


def flash_attention_gqa(q, k, v, *, causal: bool = True, window: int = 0,
                        device="cuda", body: str | None = None
                        ) -> torch.Tensor:
    """Softmax attention of q ``(B, S, H, hd)`` over k, v ``(B, T, KV,
    hd)`` with H a multiple of KV; returns ``(B, S, H, hd)`` in q's
    dtype.  ``window`` > 0 (causal only) keeps the keys ``i - window < j
    <= i`` of query i.  ``body`` (CUDA only) overrides :func:`flash_body`'s
    choice, to time one body against another; "mma" still needs bf16 and
    hd % 16 == 0 (up to 128, or 256).  Where autograd records (grad mode
    on and q, k or v requiring grad) a CUDA call goes through F's backward
    (:func:`flash_attention_gqa_bwd`); the forward then also writes the
    row statistic, with the same output bits.  CPU tensors take
    :func:`flash_attention_gqa_plain`, whose autograd is the backward's
    plain version."""
    dev = on_device(device, q=q, k=k, v=v)
    window = _check_window(window, causal)
    _check(q, k, v)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if grad and q.shape[3] > BWD_HD_MAX:
        raise NotImplementedError(
            f"F's backward takes head_dim <= {BWD_HD_MAX}, not "
            f"{q.shape[3]} (ROADMAP queue 1 item 18)")
    if dev.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal=causal,
                                         window=window)
    _check_cuda(q, k, v, dev)
    if grad:
        return _Flash.apply(q, k, v, causal, window, body)
    return _launch_fwd(q, k, v, causal, window, body, False)[0]


def flash_attention_gqa_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                            window: int = 0, device="cuda"):
    """F's backward: (dq, dk, dv) of the attention ``out`` =
    :func:`flash_attention_gqa` (q, k, v) given ``dout``, from the forward's
    row statistic ``lse`` (f32 ``(B, H, S)``).  On CUDA it launches
    ``csrc/flash_attn_bwd.cu`` (f32 sums, the gradients in q's dtype, no
    atomics: the same bits every run); CPU tensors take
    :func:`flash_attention_gqa_bwd_plain`.  hd <= 128."""
    dev = on_device(device, q=q, k=k, v=v)
    window = _check_window(window, causal)
    _check(q, k, v)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's shape")
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 {(b, h, s)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if hd > BWD_HD_MAX:
        raise NotImplementedError(
            f"F's backward takes head_dim <= {BWD_HD_MAX}, not {hd} "
            "(ROADMAP queue 1 item 18)")
    if dev.type == "cpu":
        return flash_attention_gqa_bwd_plain(q, k, v, dout, causal=causal,
                                             window=window)
    _check_cuda(q, k, v, dev)
    out = out.to(q.dtype).contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    dq = torch.empty(b, s, h, hd, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, t, kvh, hd, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    rc = _bwd_fn()(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                   lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), b, s, t, h, kvh, hd,
                   _strides(q, k, v), int(causal), window, _scale(hd),
                   torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_gqa_bwd.launches += 1
    _raise_on(rc, "flash_attention_gqa_bwd")
    return dq, dk, dv


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    device="cuda") -> torch.Tensor:
    """The reference's signature: q ``(BH, S, hd)``, k, v ``(BH, T, hd)``
    -> ``(BH, S, hd)`` in q's dtype."""
    out = flash_attention_gqa(q[:, :, None, :], k[:, :, None, :],
                              v[:, :, None, :], causal=causal, window=window,
                              device=device)
    return out[:, :, 0, :]


KERNELS = (flash_attention_gqa, flash_attention_gqa_bwd)


def reset_launch_counts():
    """Zero ``launches`` and F's per-body ``body_launches``,
    ``window_launches``, ``noncausal_launches`` and ``lse_launches`` (the
    forwards that wrote the backward's row statistic)."""
    for k in KERNELS:
        k.launches = 0
    flash_attention_gqa.body_launches = dict.fromkeys(BODIES, 0)
    flash_attention_gqa.window_launches = dict.fromkeys(BODIES, 0)
    flash_attention_gqa.noncausal_launches = dict.fromkeys(BODIES, 0)
    flash_attention_gqa.lse_launches = dict.fromkeys(BODIES, 0)


reset_launch_counts()
