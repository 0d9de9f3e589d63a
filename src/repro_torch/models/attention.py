"""Attention, the dense parts: port of ``repro/models/attention.py``.

MHA/GQA/MQA with qk-norm and QKV bias.  GQA uses the reference's grouped
layout (no materialized KV repeat): q ``(B, S, KV, G, hd)`` against k
``(B, T, KV, hd)``.

* :func:`attn_apply` (train / prefill, causal self-attention) runs kernel
  F (``kernels/flash_attn.py``) on q, k, v in the model's ``(B, S, H,
  hd)`` layout.  ``forward`` gives positions ``arange(S)``, so the mask
  ``j <= i`` on positions is F's causal mask on indices.  The reference's
  ``naive`` and ``chunked`` ``attn_impl`` compute the same function and
  both run F.  Given a ``cache``, the prompt's keys and values are written
  into its first S slots in place (the port's prefill fills the decode
  cache; the reference's serve loop fills it one decode step at a time).
* :func:`decode_attn_apply` attends one new token over the cache in plain
  torch (the reference has no kernel there), keeping ``_attend``'s
  rounding points; it writes the new key and value into the cache in
  place (the reference returns an updated copy).

Cross-attention, local windows and the 8-bit ``kv_cache_gse`` raise
``NotImplementedError`` (ROADMAP queue 1 item 16).
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
           "NEG_INF"]


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported yet "
                              "(ROADMAP queue 1 item 16)")


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


def attn_apply(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
               window: int = 0, use_rope: bool = True,
               cache: Dict | None = None) -> torch.Tensor:
    """Full-sequence (prefill) causal self-attention on kernel F."""
    if window:
        _unported("local-window attention")
    dtype = cfg.compute_dtype
    q, k, v = _project_qkv(p, x, cfg, dtype)
    if use_rope:
        q = M.rope(q, positions, cfg.rope_theta)
        k = M.rope(k, positions, cfg.rope_theta)
    if cache is not None:
        s = k.shape[1]
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    out = flash_attention_gqa(q, k, v, causal=True, device=q.device)
    b2, s2 = out.shape[:2]
    return M.linear(out.reshape(b2, s2, -1), p["wo"], cfg, dtype)


def cache_init(cfg, batch: int, max_len: int, window: int = 0, dtype=None,
               device="cuda") -> Dict:
    """Per-layer KV cache in the compute dtype."""
    if window:
        _unported("the local-window ring cache")
    if cfg.kv_cache_gse:
        _unported("the 8-bit GSE-SEM KV cache (kv_cache_gse)")
    dtype = dtype or cfg.compute_dtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attn_apply(p: Params, x: torch.Tensor, cache: Dict, pos: int,
                      cfg, window: int = 0, use_rope: bool = True):
    """One new token ``x`` (B, 1, D) at position ``pos`` over the cache;
    returns ``(y, cache)`` with the cache updated in place."""
    if window:
        _unported("local-window attention")
    if cfg.kv_cache_gse:
        _unported("the 8-bit GSE-SEM KV cache (kv_cache_gse)")
    dtype = cfg.compute_dtype
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, dtype)
    if use_rope:
        q = M.rope(q, positions, cfg.rope_theta)
        k_new = M.rope(k_new, positions, cfg.rope_theta)
    size = cache["k"].shape[1]
    slot = min(int(pos), size - 1)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    valid = torch.arange(size, device=x.device) <= pos
    out = _attend(q, cache["k"], cache["v"], valid[None, None, None, None, :],
                  cfg, dtype)
    b2, s2 = out.shape[:2]
    return M.linear(out.reshape(b2, s2, -1), p["wo"], cfg, dtype), cache
