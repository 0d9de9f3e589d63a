"""The RG-LRU recurrent block (RecurrentGemma / Griffin): port of
``repro/models/rglru.py``.

Block = linear-in -> temporal conv1d(4) -> RG-LRU recurrence -> gated
out.  Per channel:

    r_t = sigmoid(u_t W_a)                  recurrence gate
    i_t = sigmoid(u_t W_x)                  input gate
    a_t = exp(-8 * softplus(lam) * r_t)     data-dependent decay
    h_t = a_t * h_(t-1) + sqrt(1 - a_t^2) * (i_t * u_t)

The params are the reference's leaves (``w_in``, ``w_gate_branch``,
``conv``, ``wa``, ``wx``, ``lam``, ``w_out``), dense even under
``gse_serve``: the reference draws them with ``M._normal``, not
``linear_weight_init``.  Their products are plain products that the
reference leaves to XLA, so they stay ``torch.matmul``; the f32 gate
products ``u @ wa`` and ``u @ wx`` run with TF32 off on the card, which
is torch's default for matmul (:func:`_gates` asserts it).

Prefill (:func:`rglru_apply`) runs the recurrence on the hand-written
kernel ``kernels/lru_scan.py`` (the reference: ``associative_scan``);
given a ``state`` it also leaves there the final ``h`` and the last
``_CONV_W - 1`` inputs of the conv, the decode state the reference's
serve loop would build.  Decode (:func:`rglru_step`) is the O(1) update.

Rounding points, as XLA's CPU build of the reference computes them (the
optimized HLO of the jitted ``rglru_apply``), where parity needs them:

* ``jax.nn.gelu`` is the tanh form ``x * (0.5 * (1 + tanh(c1 * (x + c2 *
  x^3))))`` with every operation rounded to x's dtype and the constants
  rounded to it (bf16: 0.796875 and 0.044677734375),
  ``modules._gelu`` (shared with the gelu MLP);
* ``_conv1d`` is the reference's Python ``sum`` from 0 over the four taps,
  each product and partial sum rounded to the compute dtype except the
  last sum, which its only consumers (the f32 gates) read unrounded;
* ``jax.nn.softplus`` is ``max(x, 0) + log1p(exp(-|x|))``, in ``lam``'s
  dtype (f32, or bf16 after the serve CLI's ``dequantize_tree``);
  ``sigmoid`` is ``1 / (1 + exp(-x))``; ``a * a`` is ``exp(log_a +
  log_a)`` (XLA's rewrite of ``exp(x) * exp(x)``);
* the recurrence rounds ``a * h`` and then ``+ b``.  XLA's CPU build may
  contract that, and the f32 multiply-adds elsewhere, into FMAs, and its
  scan adds in a tree: the tests hold the f32 path within rtol 1e-5.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.kernels.lru_scan import lru_scan
from repro_torch.models import modules as M

Params = Dict[str, Any]

_C = 8.0
_CONV_W = 4

__all__ = ["rglru_init", "rglru_apply", "rglru_state_init", "rglru_step"]


def rglru_init(gen, cfg, dtype, device) -> Params:
    d = cfg.d_model
    w = cfg.lru_width or d
    s = 1.0 / math.sqrt(d)
    p = {
        "w_in": M._normal(gen, (d, w), s, dtype, device),
        "w_gate_branch": M._normal(gen, (d, w), s, dtype, device),
        "conv": M._normal(gen, (_CONV_W, w), 0.1, dtype, device),
        "wa": M._normal(gen, (w, w), 1.0 / math.sqrt(w), dtype, device),
        "wx": M._normal(gen, (w, w), 1.0 / math.sqrt(w), dtype, device),
        "lam": (2.0 + 3.0 * torch.rand((w,), generator=gen,
                                       device=gen.device,
                                       dtype=torch.float32)).to(device),
        "w_out": M._normal(gen, (w, d), 1.0 / math.sqrt(w), dtype, device),
    }
    return p


def _conv1d(p, x, state=None):
    """Causal depthwise conv, width 4; ``state`` (B, 3, W) holds the
    trailing inputs.  Returns (out, new_state): the reference's ``sum``
    from 0, in x's dtype."""
    w = p["conv"].to(x.dtype)
    if state is None:
        pads = torch.zeros((x.shape[0], _CONV_W - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
        xp = torch.cat([pads, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = 0
    for i in range(_CONV_W - 1):
        out = out + xp[:, i:i + s, :] * w[i]
    # The last sum stays unrounded (f32): only the f32 gates read it.
    last = (xp[:, _CONV_W - 1:, :] * w[_CONV_W - 1]).to(torch.float32)
    out = out.to(torch.float32) + last
    new_state = xp[:, xp.shape[1] - (_CONV_W - 1):, :]
    return out, new_state


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    in x's dtype."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _gates(p, u):
    """(a, gated) in f32 from the conv's output ``u``."""
    if u.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the RG-LRU gates are f32 products: TF32 must be "
                           "off (torch.backends.cuda.matmul.allow_tf32)")
    u32 = u.to(torch.float32)
    r = _sigmoid(u32 @ p["wa"].to(torch.float32))
    i = _sigmoid(u32 @ p["wx"].to(torch.float32))
    log_a = -_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    a2 = torch.exp(log_a + log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i * u32)
    return a, gated


def _branches(p, x, dtype):
    u = torch.matmul(x.to(dtype), p["w_in"].to(dtype))
    gate = M._gelu(torch.matmul(x.to(dtype), p["w_gate_branch"].to(dtype)))
    return u, gate


def rglru_apply(p: Params, x: torch.Tensor, cfg,
                state: Dict | None = None) -> torch.Tensor:
    """Full-sequence apply (prefill). x: (B, S, D).  With ``state`` (from
    :func:`rglru_state_init`), its ``h`` and ``conv`` are set in place to
    the decode state after the sequence."""
    dtype = cfg.compute_dtype
    u, gate = _branches(p, x, dtype)
    u, conv_state = _conv1d(p, u)
    a, b = _gates(p, u)
    h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                     device=a.device)
    h, h_last = lru_scan(a.contiguous(), b.contiguous(), h0,
                         device=a.device)
    if state is not None:
        state["h"].copy_(h_last)
        state["conv"].copy_(conv_state)
    y = h.to(dtype) * gate
    return torch.matmul(y, p["w_out"].to(dtype))


def rglru_state_init(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> Dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, _CONV_W - 1, w), dtype=dtype,
                                device=device)}


def rglru_step(p: Params, x: torch.Tensor, state: Dict, cfg):
    """Single-token decode. x: (B, 1, D) -> (B, 1, D); ``state`` is updated
    in place and returned."""
    dtype = cfg.compute_dtype
    u, gate = _branches(p, x, dtype)
    u, conv_state = _conv1d(p, u, state["conv"])
    a, b = _gates(p, u)
    h = a[:, 0] * state["h"] + b[:, 0]
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    y = h[:, None, :].to(dtype) * gate
    return torch.matmul(y, p["w_out"].to(dtype)), state
