"""Serve step factories: port of ``repro/models/stepfns.py``
(``make_serve_step``, ``make_prefill_step``).

The train step (``make_train_step``, ``lm_loss``) is ROADMAP queue 1 item
16.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import transformer as T

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(cfg) -> Callable:
    """serve_step(params, state, tokens, pos) -> (next_tokens, state): one
    new token per request over a filled KV cache (updated in place)."""

    def serve_step(params, state, tokens, pos, enc_out=None):
        logits, state = T.decode_step(cfg, params, state, tokens, pos,
                                      enc_out=enc_out)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return serve_step


def make_prefill_step(cfg) -> Callable:
    """prefill(params, tokens[, state=]) -> last-position logits (B, V).
    Given a decode ``state``, it also fills the caches with the prompt."""

    def prefill(params, tokens, prefix_embeds=None, enc_embeds=None,
                state=None):
        h, _ = T.forward(cfg, params, tokens, prefix_embeds=prefix_embeds,
                         enc_embeds=enc_embeds, state=state)
        return T.logits_from_hidden(cfg, params, h[:, -1:, :])[:, 0, :]

    return prefill
