"""Attention: port of ``repro/models/attention.py``.

MHA/GQA/MQA with qk-norm and QKV bias, local windows and the 8-bit GSE-SEM
KV cache.  GQA uses the reference's grouped layout (no materialized KV
repeat): q ``(B, S, KV, G, hd)`` against k ``(B, T, KV, hd)``.

* :func:`attn_apply` (train / prefill, causal self-attention) runs kernel
  F (``kernels/flash_attn.py``) on q, k, v in the model's ``(B, S, H,
  hd)`` layout.  ``forward`` gives positions ``arange(S)``, so the mask
  ``j <= i`` on positions is F's causal mask on indices, and a ``window``
  (RecurrentGemma's local layers) F's ``i - window < j`` (the reference's
  mask, ``:157-162``; its ``chunked`` ``attn_impl`` computes the same
  function).  Given a ``cache``, the prompt's keys and values are written
  in place where the reference's decode loop would have left them: slots
  ``[0, S)``, or for a ring of ``size`` slots the last ``size`` positions,
  each at ``p % size``; packed to 8 bits under ``kv_cache_gse``.  (The
  reference's prefill fills no cache; its serve loop fills it one decode
  step at a time.)
* :func:`decode_attn_apply` attends one new token over the cache in plain
  torch (the reference has no kernel there), keeping ``_attend``'s
  rounding points and, for windows, the ring's slot order and ``valid``
  mask (``:289``, ``:299-307``); it writes the new key and value into the
  cache in place (the reference returns an updated copy).
* ``kv_cache_gse``: :func:`_kv_pack_u8` and :func:`_kv_decode_u8` are the
  reference's (``:222-255``) bit for bit: one byte per value, sign |
  expIdx(3) | mantissa(4) against the fixed table ``_KV_TABLE``.  The
  decode runs over the whole cache at every step in plain torch; a kernel
  that fuses it into decode attention is an owed design (ROADMAP queue 2).

* The encoder-decoder family (seamless): :func:`encoder_attn_apply` is
  bidirectional self-attention without rope, on F with ``causal=False``
  (S = T).  :func:`cross_kv` projects the encoder's output to keys and
  values; :func:`cross_attn_apply` attends the decoder's queries over
  them: on F with ``causal=False`` (S decoder queries over T encoder
  keys, S != T) in the prefill, and for one query (a decode step) in
  plain torch with ``_attend`` under an all-true mask, as
  :func:`decode_attn_apply` attends one token.  Neither applies rope or
  qk-norm, as the reference's (``:169-210``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.kernels.flash_attn import flash_attention_gqa
from repro_torch.models import modules as M

Params = Dict[str, Any]

NEG_INF = -1e30

__all__ = ["attn_init", "attn_apply", "cache_init", "decode_attn_apply",
           "cross_attn_init", "encoder_attn_apply", "cross_kv",
           "cross_attn_apply", "NEG_INF"]


def attn_init(gen, cfg, dtype, device) -> Params:
    """Fused projection layout: wq (d, H*hd), wk/wv (d, KV*hd), wo."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": M.linear_weight_init(gen, (d, h * hd), s, cfg, device),
        "wk": M.linear_weight_init(gen, (d, kv * hd), s, cfg, device),
        "wv": M.linear_weight_init(gen, (d, kv * hd), s, cfg, device),
        "wo": M.linear_weight_init(gen, (h * hd, d), 1.0 / math.sqrt(h * hd),
                                   cfg, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(h * hd, dtype=dtype, device=device)
        p["bk"] = torch.zeros(kv * hd, dtype=dtype, device=device)
        p["bv"] = torch.zeros(kv * hd, dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dtype, device=device)
    return p


def cross_attn_init(gen, cfg, dtype, device) -> Params:
    """Cross-attention's params: :func:`attn_init`'s layout."""
    return attn_init(gen, cfg, dtype, device)


def _qk_normalize(p, q, k):
    def rn(x, scale):
        x32 = x.to(torch.float32)
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + 1e-6)
                * scale.to(torch.float32)).to(x.dtype)

    return rn(q, p["q_norm"]), rn(k, p["k_norm"])


def _project_qkv(p, x, cfg, dtype):
    xc = x.to(dtype)
    b, s = x.shape[:2]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = M.linear(xc, p["wq"], cfg, dtype)
    k = M.linear(xc, p["wk"], cfg, dtype)
    v = M.linear(xc, p["wv"], cfg, dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q, k = _qk_normalize(p, q, k)
    return q, k, v


def _attend(q, k, v, mask, cfg, dtype):
    """q: (B,S,H,hd); k,v: (B,T,KV,hd); mask broadcastable (B,1,1,S,T).
    Scores from a ``dtype`` einsum, then f32 and the scale, the mask, a
    softmax, probabilities back in ``dtype`` for the value product."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskge,btke->bkgst", qg, k).to(torch.float32) * scale
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgst,btke->bskge", probs, v)
    return out.reshape(b, s, h, hd)


def _ring_fill(cache: Dict, k, v, cfg):
    """Write the prompt's keys and values ``(B, S, KV, hd)`` into the cache
    in place, where the reference's decode loop leaves them: slot ``p`` for
    ``p < S`` in a linear cache, slot ``p % size`` for the last ``size``
    positions in a ring (a linear cache of ``size >= S`` is the same)."""
    if cfg.kv_cache_gse:
        k, v = _kv_pack_u8(k), _kv_pack_u8(v)
    s, size = k.shape[1], cache["k"].shape[1]
    first = max(0, s - size)
    slots = torch.arange(first, s, device=k.device) % size
    cache["k"][:, slots] = k[:, first:]
    cache["v"][:, slots] = v[:, first:]


def attn_apply(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
               window: int = 0, use_rope: bool = True,
               cache: Dict | None = None) -> torch.Tensor:
    """Full-sequence (prefill) causal self-attention on kernel F, over a
    local ``window`` when it is not 0."""
    dtype = cfg.compute_dtype
    q, k, v = _project_qkv(p, x, cfg, dtype)
    if use_rope:
        q = M.rope(q, positions, cfg.rope_theta)
        k = M.rope(k, positions, cfg.rope_theta)
    if cache is not None:
        _ring_fill(cache, k, v, cfg)
    out = flash_attention_gqa(q, k, v, causal=True, window=window,
                              device=q.device)
    b2, s2 = out.shape[:2]
    return M.linear(out.reshape(b2, s2, -1), p["wo"], cfg, dtype)


def encoder_attn_apply(p: Params, x: torch.Tensor, cfg,
                       positions: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional (encoder) self-attention on kernel F (``causal=False``),
    no rope; ``positions`` is unused, as in the reference."""
    dtype = cfg.compute_dtype
    q, k, v = _project_qkv(p, x, cfg, dtype)
    out = flash_attention_gqa(q, k, v, causal=False, device=q.device)
    b2, s2 = out.shape[:2]
    return M.linear(out.reshape(b2, s2, -1), p["wo"], cfg, dtype)


def cross_kv(p: Params, enc_out: torch.Tensor, cfg):
    """The encoder output's keys and values ``(B, T, KV, hd)`` for one
    decoder layer's cross-attention."""
    dtype = cfg.compute_dtype
    xc = enc_out.to(dtype)
    k = M.linear(xc, p["wk"], cfg, dtype)
    v = M.linear(xc, p["wv"], cfg, dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    b, t = enc_out.shape[:2]
    return (k.reshape(b, t, cfg.num_kv_heads, cfg.hd),
            v.reshape(b, t, cfg.num_kv_heads, cfg.hd))


def cross_attn_apply(p: Params, x: torch.Tensor, enc_kv, cfg) -> torch.Tensor:
    """Decoder cross-attention of x ``(B, S, D)`` over ``enc_kv = (k, v)``
    from :func:`cross_kv`: kernel F without a mask for S > 1, ``_attend``
    for one query."""
    dtype = cfg.compute_dtype
    b, s = x.shape[:2]
    q = M.linear(x.to(dtype), p["wq"], cfg, dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.hd)
    k, v = enc_kv
    if s == 1:
        every = torch.ones((1, 1, 1, 1, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = _attend(q, k, v, every, cfg, dtype)
    else:
        out = flash_attention_gqa(q, k, v, causal=False, device=q.device)
    return M.linear(out.reshape(b, s, -1), p["wo"], cfg, dtype)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

# The reference's 8-bit GSE-SEM cache entry: sign(1) | expIdx(3) |
# mantissa(4), against a fixed table of shared exponents (one byte per
# value: half bf16's bytes, a quarter of f32's).
_KV_TABLE = (5, 3, 1, -1, -3, -5, -7, -9)
_KV_MBITS = 4
_F32_MIN_NORMAL = 2.0 ** -126


def _kv_pack_u8(x: torch.Tensor) -> torch.Tensor:
    """The reference's pack, bit for bit: |x| in f32 times ``2^(4 - e)``
    for each exponent from the smallest up (exact: a power of two), the
    first whose mantissa is below 15.5 taken, the mantissa rounded half to
    even and clipped to [0, 15]; values past the largest binade saturate
    to mantissa 15 at expIdx 0.  The sign bit is ``x < 0`` (-0 packs as
    +0), with subnormal x taken as zero: XLA's CPU build flushes them, so
    a negative subnormal packs as +0 there too."""
    a = torch.abs(x.to(torch.float32))
    sign = ((x < 0) & (a >= _F32_MIN_NORMAL)).to(torch.uint8)
    best_idx = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    best_mant = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    found = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for j, e in reversed(list(enumerate(_KV_TABLE))):
        mant = a * float(2.0 ** (_KV_MBITS - e))
        fits = (mant < 15.5) & ~found
        best_idx = torch.where(fits, j, best_idx)
        best_mant = torch.where(
            fits, torch.clamp(torch.round(mant), 0, 15).to(torch.uint8),
            best_mant)
        found = found | fits
    best_mant = torch.where(found, best_mant, 15)
    return (sign << 7) | (best_idx << 4) | best_mant


def _kv_decode_u8(u: torch.Tensor, dtype) -> torch.Tensor:
    """The reference's decode, bit for bit: ``(sgn * mant) * 2^(e - 4)`` in
    f32 (exact), then cast to ``dtype`` (exact for bf16 too: 4 bits of
    mantissa)."""
    ui = u.to(torch.int32)
    sgn = 1.0 - 2.0 * ((ui >> 7) & 0x1).to(torch.float32)
    idx = (ui >> 4) & 0x7
    mant = (ui & 0xF).to(torch.float32)
    scales = torch.tensor([2.0 ** (e - _KV_MBITS) for e in _KV_TABLE],
                          dtype=torch.float32, device=u.device)
    return (sgn * mant * scales[idx]).to(dtype)


def cache_init(cfg, batch: int, max_len: int, window: int = 0, dtype=None,
               device="cuda") -> Dict:
    """Per-layer KV cache: ``max_len`` slots, or a ring of ``min(window,
    max_len)`` for a local-window layer; uint8 under ``kv_cache_gse``, else
    the compute dtype."""
    dtype = dtype or cfg.compute_dtype
    if cfg.kv_cache_gse:
        dtype = torch.uint8
    size = min(window, max_len) if window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attn_apply(p: Params, x: torch.Tensor, cache: Dict, pos: int,
                      cfg, window: int = 0, use_rope: bool = True):
    """One new token ``x`` (B, 1, D) at position ``pos`` over the cache;
    returns ``(y, cache)`` with the cache updated in place.  A window's
    ring is written at ``pos % size`` and attended in slot order, as the
    reference attends it."""
    dtype = cfg.compute_dtype
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, dtype)
    if use_rope:
        q = M.rope(q, positions, cfg.rope_theta)
        k_new = M.rope(k_new, positions, cfg.rope_theta)
    size = cache["k"].shape[1]
    slot = pos % size if window else min(pos, size - 1)
    if cfg.kv_cache_gse:
        k_new, v_new = _kv_pack_u8(k_new), _kv_pack_u8(v_new)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    k, v = cache["k"], cache["v"]
    if cfg.kv_cache_gse:
        k, v = _kv_decode_u8(k, dtype), _kv_decode_u8(v, dtype)
    idx = torch.arange(size, device=x.device)
    if window:
        # Ring semantics: every slot once wrapped, each slot's position.
        valid = (idx <= slot) | (pos >= size)
        true_pos = torch.where(idx <= slot, pos - (slot - idx),
                               pos - (slot + size - idx))
        valid &= true_pos >= 0
    else:
        valid = idx <= pos
    out = _attend(q, k, v, valid[None, None, None, None, :], cfg, dtype)
    b2, s2 = out.shape[:2]
    return M.linear(out.reshape(b2, s2, -1), p["wo"], cfg, dtype), cache
