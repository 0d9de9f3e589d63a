"""Model assembly, the ``dense`` family: port of
``repro/models/transformer.py``.

Pre-norm decoder-only stacks (qwen3-4b, granite-3-2b, granite-34b,
qwen1.5-32b).  The params tree keeps the
reference's layout, including the stacked ``(L, ...)`` layer leaves that
its ``init_params`` builds with ``vmap``: under ``gse_serve`` each layer's
weights are packed with their own shared-exponent table, stacked to
``(L, k)``.  Layers run in a Python loop over views of the stacked
leaves (the reference scans).  The other families (moe, hybrid, ssm,
encdec, vlm prefixes) raise ``NotImplementedError`` (ROADMAP queue 1 item
16).

Decode state is updated in place: ``decode_step`` writes each layer's new
key and value into the stacked cache and returns the same state object
(the reference returns a new one).  ``forward(..., state=)`` fills the
cache with the prompt's keys and values, so decoding can follow a
prefill.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import modules as M
from repro_torch.tree import tree_map

Params = Dict[str, Any]

__all__ = ["init_params", "forward", "logits_from_hidden",
           "decode_state_init", "decode_step"]


def _dense_only(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP queue 1 "
            "item 16); the port runs the dense family")


def _layer_kinds(cfg) -> Tuple[str, ...]:
    _dense_only(cfg)
    return ("attn",) * cfg.num_layers


def _stackable(cfg) -> bool:
    return cfg.scan_layers and len(set(_layer_kinds(cfg))) == 1


def _layer_init(gen, cfg, kind: str, dtype, device) -> Params:
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} (ROADMAP item 16)")
    return {
        "norm1": M.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": A.attn_init(gen, cfg, dtype, device),
        "norm2": M.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": M.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype,
                          cfg=cfg, device=device),
    }


def _stack(make_layer, n: int) -> Params:
    """Stack ``n`` layers' trees into ``(n, ...)`` leaves, filling
    preallocated tensors so no layer is held twice."""
    first = make_layer(0)
    stacked = tree_map(lambda t: t.new_empty((n, *t.shape)), first)
    tree_map(lambda s, t: s[0].copy_(t), stacked, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, t, i=i: s[i].copy_(t), stacked, make_layer(i))
    return stacked


def init_params(cfg, gen: torch.Generator, device="cuda") -> Params:
    """Random params in the reference's tree layout, drawn from ``gen``
    (on its own device) and put on ``device``.  Returns the params only:
    the reference's sharding specs have no counterpart here."""
    dtype = cfg.param_dtype
    kinds = _layer_kinds(cfg)
    params: Params = {
        "embed": M.embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                              device),
        "final_norm": M.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = M.unembed_init(gen, cfg.padded_vocab,
                                           cfg.d_model, dtype, cfg=cfg,
                                           device=device)
    make = lambda i: _layer_init(gen, cfg, kinds[i], dtype, device)  # noqa: E731
    if _stackable(cfg):
        params["layers"] = _stack(make, cfg.num_layers)
    else:
        params["layers"] = [make(i) for i in range(cfg.num_layers)]
    return params


def _layers(cfg, params):
    """Each layer's params: views into the stacked leaves."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers
    return [tree_map(lambda t, i=i: t[i], layers)
            for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _block_apply(cfg, p, x, positions, kind: str, cache=None):
    """Returns (y, aux)."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} (ROADMAP item 16)")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = M.rmsnorm(p["norm1"], x)
    y = A.attn_apply(p["attn"], h, cfg, positions, cache=cache)
    return _mlp_half(cfg, p, x, y), aux


def _mlp_half(cfg, p, x, y):
    """The block after attention: ``x + y``, the MLP on its norm, and the
    second residual add.  The norm reads the first sum before it is
    rounded to x's dtype, as XLA's CPU build of the reference computes it
    (the add is fused into the norm with f32 excess precision); the
    residual stream itself is rounded after each add, as there."""
    x_mid = x.to(torch.float32) + y.to(x.dtype).to(torch.float32)
    h2 = M.rmsnorm(p["norm2"], x_mid).to(x.dtype)
    y2 = M.mlp(p["mlp"], h2, cfg.mlp_act, cfg.compute_dtype, cfg=cfg)
    return x_mid.to(x.dtype) + y2.to(x.dtype)


def forward(cfg, params: Params, tokens: torch.Tensor, prefix_embeds=None,
            enc_embeds=None, state: Dict | None = None):
    """Returns (final_hidden (B, S, D), aux_loss).  With ``state`` (from
    ``decode_state_init``), each layer's cache gets the prompt's keys and
    values in slots ``[0, S)``."""
    if prefix_embeds is not None or enc_embeds is not None:
        raise NotImplementedError("prefix and encoder embeddings (vlm, "
                                  "encdec; ROADMAP queue 1 item 16)")
    dtype = cfg.compute_dtype
    x = M.embed(params["embed"], tokens, dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    kinds = _layer_kinds(cfg)
    caches = _layers(cfg, state) if state is not None else [None] * len(kinds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind, cache in zip(_layers(cfg, params), kinds, caches):
        x, a = _block_apply(cfg, p, x, positions, kind, cache)
        aux = aux + a
    return M.rmsnorm(params["final_norm"], x), aux


def logits_from_hidden(cfg, params: Params, h: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embed"]["table"].to(cfg.compute_dtype)
        logits = torch.matmul(h.to(cfg.compute_dtype).to(torch.float32),
                              w.t().to(torch.float32))
    else:
        logits = M.unembed(params["unembed"], h, cfg.compute_dtype, cfg=cfg)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------

def decode_state_init(cfg, batch: int, max_len: int, device="cuda") -> Dict:
    """Stacked per-layer KV caches, ``(L, B, max_len, KV, hd)``."""
    kinds = _layer_kinds(cfg)
    if _stackable(cfg):
        one = A.cache_init(cfg, batch, max_len, device=device)
        return {"layers": {k: v.new_zeros((cfg.num_layers, *v.shape))
                           for k, v in one.items()}}
    return {"layers": [A.cache_init(cfg, batch, max_len, device=device)
                       for _ in kinds]}


def _block_decode(cfg, p, x, cache, pos: int, kind: str):
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} (ROADMAP item 16)")
    h = M.rmsnorm(p["norm1"], x)
    y, cache = A.decode_attn_apply(p["attn"], h, cache, pos, cfg)
    return _mlp_half(cfg, p, x, y), cache


def decode_step(cfg, params: Params, state: Dict, tokens: torch.Tensor,
                pos: int, enc_out=None):
    """One decode step: returns (logits (B, V), state), the state updated
    in place."""
    if enc_out is not None:
        raise NotImplementedError("encoder outputs (encdec; ROADMAP queue 1 "
                                  "item 16)")
    x = M.embed(params["embed"], tokens[:, None], cfg.compute_dtype)
    kinds = _layer_kinds(cfg)
    for p, kind, cache in zip(_layers(cfg, params), kinds,
                              _layers(cfg, state)):
        x, _ = _block_decode(cfg, p, x, cache, pos, kind)
    h = M.rmsnorm(params["final_norm"], x)
    return logits_from_hidden(cfg, params, h)[:, 0, :], state
