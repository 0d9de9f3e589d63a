"""Train and serve step factories: port of ``repro/models/stepfns.py``
(``lm_loss``, ``TrainState``, ``make_loss_fn``, ``make_train_step``,
``make_serve_step``, ``make_prefill_step``).

The LM loss is computed in sequence chunks, each one checkpointed, so the
``(B, S, V)`` logits never exist: a chunk's logits live only while its
loss is taken, and again while its gradient is (the reference's ``scan``
over ``jax.checkpoint``).  The chunks' losses are added in the
reference's carry order, from 0.

``make_train_step`` differentiates the loss with autograd (``forward``
runs each layer as one rematerialized unit where ``cfg.remat`` asks for
it, and kernel F through its backward) and applies the optimizer.  Unlike
the reference it updates the state's tensors in place: the params and
the optimizer moments are overwritten, and the returned state holds the
same tensors (a full-width model's params, gradients and two moments are
four copies of its weights; a new copy of each would add two).  The
hybrid, ssm and moe families' train steps raise ``NotImplementedError``
(their kernels ``lru_scan`` and ``wkv6`` and the moe dispatch have no
backward yet: ROADMAP queue 1 item 18).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import transformer as T
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["lm_loss", "TrainState", "make_loss_fn", "make_train_step",
           "make_serve_step", "make_prefill_step", "AUX_LOSS_WEIGHT"]

Params = Dict[str, Any]

AUX_LOSS_WEIGHT = 0.01


def _chunk_loss(cfg, params, h_c, l_c, m_c) -> torch.Tensor:
    """One chunk's summed masked cross-entropy, its logits f32."""
    logits = T.logits_from_hidden(cfg, params, h_c)      # (B, c, V) f32
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, l_c.to(torch.int64)[..., None])[..., 0]
    return torch.sum((logz - ll) * m_c)


def lm_loss(cfg, params: Params, hidden: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """Mean masked cross-entropy, chunked over the sequence axis (the
    reference's chunk rule: the largest of 512, 256, ..., 1 dividing S)."""
    b, s, d = hidden.shape
    if chunk is None:
        chunk = s
        for c in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
            if s % c == 0 and c <= s:
                chunk = c
                break
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        args = (hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
                mask[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            loss = checkpoint(_chunk_loss, cfg, params, *args,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            loss = _chunk_loss(cfg, params, *args)
        total = total + loss
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    return total / denom


class TrainState(NamedTuple):
    """The params, the optimizer's state and the step (an int32 scalar
    tensor), as the reference's ``TrainState``."""
    params: Params
    opt_state: Any
    step: torch.Tensor


def make_loss_fn(cfg) -> Callable:
    """loss_fn(params, batch) -> (total, {"loss", "aux_loss"}): the LM loss
    past the vlm prefix plus ``AUX_LOSS_WEIGHT`` times the moe aux loss."""

    def loss_fn(params, batch):
        h, aux = T.forward(cfg, params, batch["tokens"],
                           prefix_embeds=batch.get("prefix_embeds"),
                           enc_embeds=batch.get("enc_embeds"))
        if batch.get("prefix_embeds") is not None:
            # prefix positions carry no LM loss; hidden includes them.
            h = h[:, batch["prefix_embeds"].shape[1]:, :]
        loss = lm_loss(cfg, params, h, batch["labels"], batch["loss_mask"])
        total = loss + AUX_LOSS_WEIGHT * aux
        return total, {"loss": loss, "aux_loss": aux}

    return loss_fn


def make_train_step(cfg, optimizer,
                    grad_transform: Optional[Callable] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``grad_transform(grads) -> grads`` is the hook where the distributed
    layer installs GSE-SEM gradient compression
    (``distributed/compress.py``).  The metrics are f32 scalar tensors:
    ``loss``, ``aux_loss``, ``total_loss`` and ``grad_norm`` (the global
    norm of the gradients after ``grad_transform``, as the reference takes
    it)."""
    loss_fn = make_loss_fn(cfg)

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                total, metrics = loss_fn(state.params, batch)
                grads_flat = torch.autograd.grad(total, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads_flat)
        grads = tree_map(lambda _: next(it), state.params)
        del grads_flat, it
        if grad_transform is not None:
            grads = grad_transform(grads)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params, state.step)
        with torch.no_grad():
            tree_map(lambda p, u: p.add_(u), state.params, updates)
            del updates
            gnorm = global_norm(grads)
        new_state = TrainState(params=state.params, opt_state=opt_state,
                               step=state.step + 1)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(total_loss=total.detach(), grad_norm=gnorm)
        return new_state, metrics

    return train_step


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
