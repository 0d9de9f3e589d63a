"""Model assembly, every family of the reference: port of
``repro/models/transformer.py``.

``dense``: pre-norm decoder-only stacks (qwen3-4b, granite-3-2b,
granite-34b, qwen1.5-32b).  ``vlm``: the dense stack (internvl2-2b's
InternLM2 backbone) with the frontend's patch embeddings (``forward``'s
``prefix_embeds``, ``num_prefix_tokens`` of them) prepended to the text,
positions ``arange(P + S)``.  ``hybrid``: RecurrentGemma
(recurrentgemma-2b), RG-LRU blocks (``models/rglru.py``) with every
``hybrid_period``-th layer a local-window MQA (``"local_attn"``,
``cfg.local_window``).  ``moe``: the dense skeleton with the MoE FFN
(``models/moe.py``; qwen3-moe-235b-a22b, grok-1-314b), its expert stacks
stacked ``(L, E, ...)``.  ``ssm``: RWKV-6 time-mix and channel-mix
(``models/rwkv.py``; rwkv6-1.6b).  ``encdec``: Seamless-M4T
(seamless-m4t-large-v2), a bidirectional encoder over the frontend's
frame embeddings (``enc_embeds`` plus a sinusoidal table; ``"enc_attn"``
layers) and a causal decoder whose layers (``"dec_attn"``) add
cross-attention over each layer's ``cross_kv`` of the encoder output
after the self-attention residual.  The params tree keeps the
reference's layout: the stacked ``(L, ...)`` layer leaves that its
``init_params`` builds with ``vmap`` for a homogeneous stack
(``params["encoder"]`` and ``params["decoder"]`` for encdec; under
``gse_serve`` each layer's weights are packed with their own
shared-exponent table, stacked to ``(L, k)``), and a list of per-layer
trees for a heterogeneous one (the hybrid family, ``scan_layers=False``).
Layers run in a Python loop (the reference scans a homogeneous stack).
Under autograd each layer is one rematerialized unit when ``cfg.remat``
asks for it (:func:`_remat`, the reference's ``_maybe_remat``).

Decode state is updated in place: ``decode_step`` writes each layer's new
key and value into its cache (a ring for local-window layers), each
RG-LRU layer's ``h`` and conv inputs and each RWKV layer's ``S``,
``last_t`` and ``last_c`` into its state, and returns the same state
object (the reference returns a new one).  ``forward(..., state=)`` fills
the caches with the prompt's keys and values (for vlm all P + S
positions, for encdec the decoder's prompt) and the recurrent states with
the prompt's, so decoding can follow a prefill.  An encdec decode step
takes the encoder output (:func:`encode`) and recomputes each layer's
``cross_kv`` from it, as the reference's does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import modules as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import rwkv as W
from repro_torch.tree import tree_map

Params = Dict[str, Any]

__all__ = ["init_params", "forward", "encode", "logits_from_hidden",
           "decode_state_init", "decode_step"]


_FAMILIES = ("dense", "hybrid", "moe", "ssm", "encdec", "vlm")


def _layer_kinds(cfg) -> Tuple[str, ...]:
    """The layer kinds of the stack that decodes (encdec: the decoder's)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{_FAMILIES}")
    if cfg.family == "encdec":
        return ("dec_attn",) * cfg.num_layers
    if cfg.family == "hybrid":
        attn_ids = set(cfg.attn_layer_ids())
        return tuple("local_attn" if i in attn_ids else "rglru"
                     for i in range(cfg.num_layers))
    if cfg.family == "ssm":
        return ("rwkv",) * cfg.num_layers
    if cfg.family == "moe":
        return ("moe",) * cfg.num_layers
    return ("attn",) * cfg.num_layers


def _stackable(cfg) -> bool:
    return cfg.scan_layers and len(set(_layer_kinds(cfg))) == 1


def _layer_init(gen, cfg, kind: str, dtype, device,
                lazy: bool = False) -> Params:
    """One layer's params; ``lazy``: the expert stacks as ``moe.Lazy``
    leaves, for :func:`_stack`."""
    p = {"norm1": M.rmsnorm_init(cfg.d_model, dtype, device)}
    if kind == "rwkv":
        p["time"] = W.rwkv_time_init(gen, cfg, dtype, device)
        p["norm2"] = M.rmsnorm_init(cfg.d_model, dtype, device)
        p["chan"] = W.rwkv_channel_init(gen, cfg, dtype, device)
        return p
    if kind in ("attn", "enc_attn", "dec_attn", "local_attn", "moe"):
        p["attn"] = A.attn_init(gen, cfg, dtype, device)
    elif kind == "rglru":
        p["rglru"] = R.rglru_init(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    if kind == "dec_attn":
        p["norm_x"] = M.rmsnorm_init(cfg.d_model, dtype, device)
        p["xattn"] = A.cross_attn_init(gen, cfg, dtype, device)
    p["norm2"] = M.rmsnorm_init(cfg.d_model, dtype, device)
    if kind == "moe":
        p["moe"] = MOE.moe_init(gen, cfg, dtype, device, lazy=lazy)
    else:
        p["mlp"] = M.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype,
                              cfg=cfg, device=device)
    return p


def _stack(make_layer, n: int) -> Params:
    """Stack ``n`` layers' trees into ``(n, ...)`` leaves, filling
    preallocated tensors so no layer is held twice.  A ``moe.Lazy`` leaf
    (an expert stack) is drawn as it is stored, so at most one such leaf
    is held beside the stack; the draws keep the order of an eager init
    (the expert stacks are a layer's last random leaves)."""
    is_lazy = lambda t: isinstance(t, MOE.Lazy)  # noqa: E731

    def store(stacked, layer, i):
        tree_map(lambda s, t: s[i].copy_(t.draw() if is_lazy(t) else t),
                 stacked, layer, is_leaf=is_lazy)

    first = make_layer(0)
    stacked = tree_map(lambda t: torch.empty((n, *t.shape), dtype=t.dtype,
                                             device=t.device),
                       first, is_leaf=is_lazy)
    store(stacked, first, 0)
    del first
    for i in range(1, n):
        store(stacked, make_layer(i), i)
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
    make = lambda i, lazy=False: _layer_init(  # noqa: E731
        gen, cfg, kinds[i], dtype, device, lazy)
    if cfg.family == "encdec":
        params["encoder"] = _stack(lambda i: _layer_init(
            gen, cfg, "enc_attn", dtype, device), cfg.encoder_layers)
        params["decoder"] = _stack(make, cfg.num_layers)
    elif _stackable(cfg):
        params["layers"] = _stack(lambda i: make(i, True), cfg.num_layers)
    else:
        params["layers"] = [make(i) for i in range(cfg.num_layers)]
    return params


def _layers(cfg, params, key: str = "layers"):
    """Each layer's params (or decode state) under ``key``: views into the
    stacked leaves."""
    layers = params[key]
    if isinstance(layers, list):
        return layers
    n = cfg.encoder_layers if key == "encoder" else cfg.num_layers
    return [tree_map(lambda t, i=i: t[i], layers) for i in range(n)]


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _remat(cfg, fn, *args, **kw):
    """``fn(*args, **kw)``, as one rematerialized unit where autograd
    records and ``cfg.remat`` asks for it: the reference's ``_maybe_remat``
    (``jax.checkpoint`` around each layer) as
    ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, which
    keeps only the layer's inputs and runs its forward again in the
    backward.  ``"dots"`` (the reference's policy that saves the matmul
    outputs) recomputes the whole layer here too: the same values, more
    recompute.  The gradients are the bits of a run without remat."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args, **kw)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _norm_in(x, x_sum):
    """What a layer's first norm, or the final norm, reads: the previous
    layer's output ``x``, or in an unrolled stack its f32 sum ``x_sum``
    before the rounding to x's dtype.  The reference scans a homogeneous
    stack, whose carry is rounded, and loops over a heterogeneous one (the
    hybrid family), where XLA's CPU build fuses a layer's last residual
    add into the next norm with f32 excess precision."""
    return x if x_sum is None else x_sum


def _block_apply(cfg, p, x, positions, kind: str, cache=None, x_sum=None,
                 enc_kv=None):
    """Returns (the f32 sum of the layer's output, aux); fills the layer's
    decode ``cache`` (a KV cache, an RG-LRU or an RWKV state) when one is
    given.  ``x_sum``: see :func:`_norm_in`; ``enc_kv``: a ``"dec_attn"``
    layer's cross keys and values."""
    h = M.rmsnorm(p["norm1"], _norm_in(x, x_sum)).to(x.dtype)
    if kind == "rwkv":
        y, st = W.rwkv_time_apply(p["time"], h, cfg)
        if cache is not None:
            cache["S"].copy_(st["S"])
            cache["last_t"].copy_(st["last"])
        return _rwkv_half(cfg, p, x, y, cache, prev=None), _no_aux(x)
    if kind in ("attn", "moe", "dec_attn"):
        y = A.attn_apply(p["attn"], h, cfg, positions, cache=cache)
    elif kind == "enc_attn":
        y = A.encoder_attn_apply(p["attn"], h, cfg, positions)
    elif kind == "local_attn":
        y = A.attn_apply(p["attn"], h, cfg, positions,
                         window=cfg.local_window, cache=cache)
    elif kind == "rglru":
        y = R.rglru_apply(p["rglru"], h, cfg, state=cache)
    else:
        raise ValueError(kind)
    if kind == "dec_attn":
        x, y = _cross_half(cfg, p, x, y, enc_kv)
    return _mlp_half(cfg, p, x, y, kind)


def _no_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _cross_half(cfg, p, x, y, enc_kv):
    """A decoder layer's cross-attention after its self-attention ``y``:
    ``x + y``, cross-attention over ``enc_kv`` on its norm (``norm_x``),
    rounded as :func:`_mlp_half` rounds the sum its norm reads.  Returns
    (``x + y`` in x's dtype, the cross-attention's output): the pair
    :func:`_mlp_half` adds."""
    x_mid = x.to(torch.float32) + y.to(x.dtype).to(torch.float32)
    hx = M.rmsnorm(p["norm_x"], x_mid).to(x.dtype)
    return x_mid.to(x.dtype), A.cross_attn_apply(p["xattn"], hx, enc_kv, cfg)


def _mlp_half(cfg, p, x, y, kind: str = "attn"):
    """The block after attention: ``x + y``, the MLP (the MoE on a moe
    layer) on its norm, and the second residual add.  The norm reads the
    first sum before it is rounded to x's dtype, as XLA's CPU build of the
    reference computes it (the add is fused into the norm with f32 excess
    precision); the residual stream itself is rounded after each add, as
    there.  Returns (the second sum in f32, aux); rounded to x's dtype the
    sum is the layer's output (the same bits as adding in x's dtype)."""
    x_mid = x.to(torch.float32) + y.to(x.dtype).to(torch.float32)
    h2 = M.rmsnorm(p["norm2"], x_mid).to(x.dtype)
    if kind == "moe":
        y2, aux = MOE.moe_apply(p["moe"], h2, cfg)
    else:
        y2 = M.mlp(p["mlp"], h2, cfg.mlp_act, cfg.compute_dtype, cfg=cfg)
        aux = _no_aux(x)
    return (x_mid.to(x.dtype).to(torch.float32)
            + y2.to(x.dtype).to(torch.float32)), aux


def _rwkv_half(cfg, p, x, y, cache, prev):
    """An RWKV layer after its time-mix: ``x + y``, the channel-mix on its
    norm (``prev``: the previous token's norm output, None at the start),
    the second residual add; ``cache["last_c"]`` (when given) takes the
    last norm output.  Rounded as :func:`_mlp_half`; returns the f32
    sum."""
    x_mid = x.to(torch.float32) + y.to(x.dtype).to(torch.float32)
    h2 = M.rmsnorm(p["norm2"], x_mid).to(x.dtype)
    y2, last_c = W.rwkv_channel_apply(p["chan"], h2, cfg, prev=prev)
    if cache is not None:
        cache["last_c"].copy_(last_c)
    return (x_mid.to(x.dtype).to(torch.float32)
            + y2.to(x.dtype).to(torch.float32))


def forward(cfg, params: Params, tokens: torch.Tensor, prefix_embeds=None,
            enc_embeds=None, state: Dict | None = None, enc_out=None):
    """Returns (final_hidden (B, P + S, D), aux_loss: the sum of the moe
    layers').  ``prefix_embeds`` (B, P, D) (vlm: the patch embeddings)
    come before the text, in the compute dtype.  An encdec model runs its
    encoder over ``enc_embeds`` (B, T, D) (:func:`encode`), or takes its
    output ``enc_out``, and its decoder over the tokens.  With ``state``
    (from ``decode_state_init``), each attention layer's cache gets the
    sequence's keys and values where the decode loop would write them,
    each RG-LRU layer's state its ``h`` and conv inputs after the prompt
    and each RWKV layer's its ``S``, ``last_t`` and ``last_c``."""
    dtype = cfg.compute_dtype
    x = M.embed(params["embed"], tokens, dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "encdec":
        if enc_out is None:
            if enc_embeds is None:
                raise ValueError("encdec needs encoder-side embeddings "
                                 "(enc_embeds) or the encoder's output")
            enc_out = encode(cfg, params, enc_embeds)
        caches = (_layers(cfg, state, "self") if state is not None
                  else [None] * cfg.num_layers)
        def dec_layer(p, x, cache):
            kv = A.cross_kv(p["xattn"], enc_out, cfg)
            return _block_apply(cfg, p, x, positions, "dec_attn", cache,
                                enc_kv=kv)[0]

        for p, cache in zip(_layers(cfg, params, "decoder"), caches):
            x = _remat(cfg, dec_layer, p, x, cache).to(dtype)
        return M.rmsnorm(params["final_norm"], x).to(dtype), aux
    kinds = _layer_kinds(cfg)
    caches = _layers(cfg, state) if state is not None else [None] * len(kinds)
    unrolled, x_sum = not _stackable(cfg), None
    for p, kind, cache in zip(_layers(cfg, params), kinds, caches):
        out, a = _remat(cfg, _block_apply, cfg, p, x, positions, kind, cache,
                        x_sum)
        x, x_sum = out.to(dtype), (out if unrolled else None)
        aux = aux + a
    return M.rmsnorm(params["final_norm"], _norm_in(x, x_sum)).to(dtype), aux


def encode(cfg, params: Params, enc_embeds: torch.Tensor) -> torch.Tensor:
    """An encdec model's encoder: ``enc_embeds`` (B, T, D) in the compute
    dtype plus the sinusoidal table of positions ``arange(T)``, through
    the ``"enc_attn"`` stack.  Returns the encoder output (B, T, D), what
    ``decode_step`` takes as ``enc_out``."""
    dtype = cfg.compute_dtype
    e = enc_embeds.to(dtype)
    b, t = e.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=e.device).expand(b, t)
    e = e + M.sinusoidal(positions, cfg.d_model).to(dtype)
    for p in _layers(cfg, params, "encoder"):
        out, _ = _remat(cfg, _block_apply, cfg, p, e, positions, "enc_attn")
        e = out.to(dtype)
    return e


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
    """Per-layer decode state: for a homogeneous stack, stacked KV caches
    ``(L, B, max_len, KV, hd)`` (dense, vlm, moe; encdec's decoder under
    the key ``"self"``) or RWKV states ``{"S": (L, B, H, N, N) f32,
    "last_t", "last_c": (L, B, D) f32}`` (ssm); else a list of KV caches
    (rings of ``min(local_window, max_len)`` slots on local-window layers)
    and RG-LRU states ``{"h", "conv"}``."""
    kinds = _layer_kinds(cfg)

    def one(kind):
        if kind in ("attn", "moe", "dec_attn"):
            return A.cache_init(cfg, batch, max_len, device=device)
        if kind == "rwkv":
            return W.rwkv_state_init(cfg, batch, device=device)
        if kind == "local_attn":
            return A.cache_init(cfg, batch, max_len, window=cfg.local_window,
                                device=device)
        return R.rglru_state_init(cfg, batch, cfg.compute_dtype,
                                  device=device)

    if _stackable(cfg) or cfg.family == "encdec":
        first = one(kinds[0])
        key = "self" if cfg.family == "encdec" else "layers"
        return {key: {k: v.new_zeros((cfg.num_layers, *v.shape))
                      for k, v in first.items()}}
    return {"layers": [one(kind) for kind in kinds]}


def _block_decode(cfg, p, x, cache, pos: int, kind: str, x_sum=None,
                  enc_kv=None):
    """Returns (the f32 sum of the layer's output, cache), the cache
    updated in place; ``x_sum``: see :func:`_norm_in`; ``enc_kv``: a
    ``"dec_attn"`` layer's cross keys and values."""
    h = M.rmsnorm(p["norm1"], _norm_in(x, x_sum)).to(x.dtype)
    if kind == "rwkv":
        y, st = W.rwkv_time_apply(p["time"], h, cfg, state={
            "S": cache["S"], "last": cache["last_t"]})
        cache["S"].copy_(st["S"])
        cache["last_t"].copy_(st["last"])
        return _rwkv_half(cfg, p, x, y, cache, prev=cache["last_c"]), cache
    if kind in ("attn", "moe", "dec_attn"):
        y, cache = A.decode_attn_apply(p["attn"], h, cache, pos, cfg)
    elif kind == "local_attn":
        y, cache = A.decode_attn_apply(p["attn"], h, cache, pos, cfg,
                                       window=cfg.local_window)
    elif kind == "rglru":
        y, cache = R.rglru_step(p["rglru"], h, cache, cfg)
    else:
        raise ValueError(kind)
    if kind == "dec_attn":
        x, y = _cross_half(cfg, p, x, y, enc_kv)
    return _mlp_half(cfg, p, x, y, kind)[0], cache


def decode_step(cfg, params: Params, state: Dict, tokens: torch.Tensor,
                pos: int, enc_out=None):
    """One decode step: returns (logits (B, V), state), the state updated
    in place.  An encdec model needs the encoder output ``enc_out`` (B, T,
    D) (:func:`encode`); each decoder layer's ``cross_kv`` is recomputed
    from it, as the reference's step does."""
    dtype = cfg.compute_dtype
    x = M.embed(params["embed"], tokens[:, None], dtype)
    if cfg.family == "encdec":
        if enc_out is None:
            raise ValueError("an encdec decode step needs the encoder's "
                             "output (enc_out)")
        for p, cache in zip(_layers(cfg, params, "decoder"),
                            _layers(cfg, state, "self")):
            kv = A.cross_kv(p["xattn"], enc_out, cfg)
            out, _ = _block_decode(cfg, p, x, cache, pos, "dec_attn",
                                   enc_kv=kv)
            x = out.to(dtype)
        h = M.rmsnorm(params["final_norm"], x).to(dtype)
        return logits_from_hidden(cfg, params, h)[:, 0, :], state
    kinds = _layer_kinds(cfg)
    unrolled, x_sum = not _stackable(cfg), None
    for p, kind, cache in zip(_layers(cfg, params), kinds,
                              _layers(cfg, state)):
        out, _ = _block_decode(cfg, p, x, cache, pos, kind, x_sum)
        x, x_sum = out.to(dtype), (out if unrolled else None)
    h = M.rmsnorm(params["final_norm"], _norm_in(x, x_sum)).to(dtype)
    return logits_from_hidden(cfg, params, h)[:, 0, :], state
