"""Serve step factories: port of ``repro/models/stepfns.py``
(``make_serve_step``, ``make_prefill_step``).

The train step (``make_train_step``, ``lm_loss``) is still to be ported
(ROADMAP queue 1 item 16.3).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(cfg) -> Callable:
    """serve_step(params, state, tokens, pos[, enc_out]) -> (next_tokens,
    state): one new token per request over a filled KV cache (updated in
    place); an encdec model takes the encoder's output ``enc_out``."""

    def serve_step(params, state, tokens, pos, enc_out=None):
        logits, state = T.decode_step(cfg, params, state, tokens, pos,
                                      enc_out=enc_out)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill_step(cfg) -> Callable:
    """prefill(params, tokens[, prefix_embeds=, enc_embeds=, state=,
    enc_out=]) -> last-position logits (B, V).  A vlm prompt's patch
    embeddings come as ``prefix_embeds``; an encdec prompt's frame
    embeddings as ``enc_embeds``, or the encoder's output (``T.encode``)
    as ``enc_out``.  Given a decode ``state``, it also fills the caches
    with the prompt (the prefix included)."""

    def prefill(params, tokens, prefix_embeds=None, enc_embeds=None,
                state=None, enc_out=None):
        h, _ = T.forward(cfg, params, tokens, prefix_embeds=prefix_embeds,
                         enc_embeds=enc_embeds, state=state, enc_out=enc_out)
        return T.logits_from_hidden(cfg, params, h[:, -1:, :])[:, 0, :]

    return prefill
