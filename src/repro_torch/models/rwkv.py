"""RWKV-6 "Finch" time-mix and channel-mix (the ssm family): port of
``repro/models/rwkv.py``.

Per head (dim N), state S in R^{N x N}:

    out_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
    w_t   = exp(-exp(w_base + lora(x_t)))      data-dependent decay

The params are the reference's leaves, dense even under ``gse_serve``
(the reference draws them with ``M._normal``, not ``linear_weight_init``),
and their products are plain products that the reference leaves to XLA,
so they stay ``torch.matmul``; the f32 decay products of :func:`_decay`
run with TF32 off on the card (asserted there).  The recurrence runs on
the hand-written kernel ``kernels/wkv6.py`` (the reference: ``lax.scan``)
for a prompt (prefill) and for one token (decode) alike.

Kept from the reference as it is: one learned mix per stream (not the
5-way LoRA stack), and :func:`rwkv_channel_apply` mixing ``xr`` with
``mix_k`` (the time-mix's ``mix_r`` has no channel-mix counterpart).

Rounding points, as XLA's CPU build of the reference computes them where
parity needs them: ``jax.nn.silu`` and ``jax.nn.sigmoid`` are ``x * (1 /
(1 + exp(-x)))`` and ``1 / (1 + exp(-x))``, each operation in x's dtype;
``square(relu(.))`` is ``relu(x) * relu(x)``; at bf16 every elementwise
operation rounds (the optimized HLO converts after each one), except the
sum of ``_mix`` that the decay reads, which XLA leaves in f32
(``_mix(..., f32_sum=True)``).  XLA may fuse the elementwise chains into
FMAs at f32 and its ``tanh`` and ``exp`` are its own approximations: the
tests hold the f32 path within rtol 1e-5 and the bf16 path at the LM
tolerances.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import modules as M

Params = Dict[str, Any]

_DECAY_LORA = 64

__all__ = ["rwkv_time_init", "rwkv_channel_init", "rwkv_time_apply",
           "rwkv_channel_apply", "rwkv_state_init"]


def rwkv_time_init(gen, cfg, dtype, device) -> Params:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    s = 1.0 / math.sqrt(d)
    half = lambda: torch.full((d,), 0.5, dtype=dtype, device=device)  # noqa
    p = {"mix_r": half(), "mix_k": half(), "mix_v": half(), "mix_w": half()}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = M._normal(gen, (d, d), s, dtype, device)
    p["w_base"] = (torch.rand((d,), generator=gen, device=gen.device,
                              dtype=torch.float32) * 2.0 - 2.0).to(device)
    p["w_lora_a"] = M._normal(gen, (d, _DECAY_LORA), s, torch.float32,
                              device)
    p["w_lora_b"] = M._normal(gen, (_DECAY_LORA, d),
                              1.0 / math.sqrt(_DECAY_LORA), torch.float32,
                              device)
    p["bonus_u"] = M._normal(gen, (h, n), 0.1, torch.float32, device)
    return p


def rwkv_channel_init(gen, cfg, dtype, device) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": M._normal(gen, (d, ff), 1.0 / math.sqrt(d), dtype, device),
        "wv": M._normal(gen, (ff, d), 1.0 / math.sqrt(ff), dtype, device),
        "wr": M._normal(gen, (d, d), 1.0 / math.sqrt(d), dtype, device),
    }


def _shift(x, prev=None):
    """Token shift: the x_{t-1} stream; ``prev`` (B, D) the token before
    x's first (zeros when None)."""
    if prev is None:
        pad = torch.zeros_like(x[:, :1])
    else:
        pad = prev[:, None, :].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _mix(x, xs, m, f32_sum: bool = False):
    """``x * m + xs * (1 - m)`` in x's dtype; ``f32_sum``: the two rounded
    products added in f32 and left unrounded (what the reference's decay
    reads: XLA drops the rounding of a sum that is cast to f32 next)."""
    m = m.to(x.dtype)
    a, b = x * m, xs * (1.0 - m)
    if f32_sum:
        return a.to(torch.float32) + b.to(torch.float32)
    return a + b


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _decay(p, xw):
    if xw.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the RWKV decay products are f32: TF32 must be "
                           "off (torch.backends.cuda.matmul.allow_tf32)")
    lora = torch.tanh(xw.to(torch.float32) @ p["w_lora_a"].to(
        torch.float32)) @ p["w_lora_b"].to(torch.float32)
    return torch.exp(-torch.exp(p["w_base"].to(torch.float32) + lora))


def _mm(x, w, dtype):
    return torch.matmul(x.to(dtype), w.to(dtype))


def rwkv_time_apply(p: Params, x: torch.Tensor, cfg, state=None):
    """x: (B, S, D).  ``state``: ``{"S": (B, H, N, N) f32, "last": (B,
    D)}`` or None (zeros).  Returns ``(out, {"S": the state after x,
    "last": x[:, -1]})``."""
    dtype = cfg.compute_dtype
    b, s, d = x.shape
    n = cfg.rwkv_head_dim
    h = d // n
    prev = None if state is None else state["last"]
    xs = _shift(x, prev)
    r = _mm(_mix(x, xs, p["mix_r"]), p["wr"], dtype)
    k = _mm(_mix(x, xs, p["mix_k"]), p["wk"], dtype)
    v = _mm(_mix(x, xs, p["mix_v"]), p["wv"], dtype)
    g = M._silu(_mm(_mix(x, xs, p["mix_w"]), p["wg"], dtype))
    w = _decay(p, _mix(x, xs, p["mix_w"], f32_sum=True))  # (B, S, D) f32

    def heads(t):
        return t.reshape(b, s, h, n).to(torch.float32).contiguous()

    if state is None:
        s0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
    else:
        s0 = state["S"].contiguous()
    out, s_fin = wkv6(heads(r), heads(k), heads(v), heads(w),
                      p["bonus_u"].to(torch.float32).contiguous(), s0,
                      device=x.device)
    out = out.reshape(b, s, d).to(dtype) * g
    y = torch.matmul(out, p["wo"].to(dtype))
    return y, {"S": s_fin, "last": x[:, -1, :]}


def rwkv_channel_apply(p: Params, x: torch.Tensor, cfg, prev=None):
    """Returns ``(r * kv, x[:, -1])``; ``xr`` mixes with ``mix_k``, as in
    the reference."""
    dtype = cfg.compute_dtype
    xs = _shift(x, prev)
    xk = _mix(x, xs, p["mix_k"]).to(dtype)
    xr = _mix(x, xs, p["mix_k"]).to(dtype)
    kr = torch.relu(_mm(xk, p["wk"], dtype))
    kv = _mm(kr * kr, p["wv"], dtype)
    r = _sigmoid(_mm(xr, p["wr"], dtype))
    return r * kv, x[:, -1, :]


def rwkv_state_init(cfg, batch: int, device="cuda") -> Dict:
    d = cfg.d_model
    n = cfg.rwkv_head_dim
    h = d // n
    return {
        "S": torch.zeros((batch, h, n, n), dtype=torch.float32,
                         device=device),
        "last_t": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "last_c": torch.zeros((batch, d), dtype=torch.float32, device=device),
    }
