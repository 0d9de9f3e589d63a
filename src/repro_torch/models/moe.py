"""Mixture-of-Experts FFN with sort-based capacity dispatch: port of
``repro/models/moe.py``.

Three dispatches, as in the reference:

* ``sort`` (the default): the T * k (token, expert) pairs are sorted by
  expert (stable) and packed into an ``(E, C, d)`` buffer, C the
  capacity (:func:`_capacity`); pairs past an expert's capacity go to the
  spill row ``E * C`` and are dropped (GShard/Switch semantics).
* ``dense``: every expert on every token, weighted by the gates after
  the fact (the reference's anti-baseline).
* ``grouped`` (:func:`_moe_grouped`): the tokens split into
  ``moe_groups`` groups, each sorted, packed (by gathers) and dropped on
  its own.

The expert weights are dense ``(E, d, ff)`` / ``(E, ff, d)`` stacks in
``param_dtype``, even under ``gse_serve`` (the reference draws them with
``M._normal``, not ``linear_weight_init``); ``gather_cast`` is a cast on
one card.  The expert products (``ecd,edf->ecf``) are plain XLA products
in the reference, outside any Pallas kernel, and stay ``torch.bmm`` /
``torch.matmul`` in the compute dtype.

Where the port holds the reference's bits, and how:

* The router product is f32 (TF32 off on the card, which
  :func:`_route` asserts), then ``exp(x - max) / sum``, then the top k
  with ties to the lower expert id (``lax.top_k``'s order; ``torch.topk``
  promises none, so a stable descending sort is taken), renormalized.
  The two sums (over E, over k) are reductions whose order XLA picks: the
  tests hold the gates to a tolerance and the expert ids, kept mask and
  slots exactly.
* Every sort is stable (``jnp.argsort`` is).
* The combine ``zeros.at[stok].add(contrib)`` equals a left fold from 0.0
  of each token's contributions in sorted order (expert-major, so its
  experts in ascending id: a token never picks an expert twice).  The
  port folds k ``(T, d)`` f32 tensors in that order
  (:func:`_fold_sorted`) rather than ``index_add_``, whose atomics on the
  card add in a varying order.
* The grouped combine un-sorts and sums over k: the same fold, in the
  top-k order (:func:`_moe_grouped`).

:func:`record_routes` collects each call's expert ids and kept mask, for
checks that compare routing across devices.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import modules as M
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]

__all__ = ["moe_init", "moe_apply", "record_routes", "Lazy"]

# The open record_routes() lists, innermost last.
_RECORDS: list = []


@contextlib.contextmanager
def record_routes():
    """Within the block, every ``moe_apply`` appends ``{"probs",
    "expert_ids", "keep", "slot", "dispatch"}`` (CPU tensors; ``keep`` and
    ``slot`` in the sorted order of the sort dispatch, per group for the
    grouped one, None for the dense one) to the list this yields."""
    out: list = []
    _RECORDS.append(out)
    try:
        yield out
    finally:
        _RECORDS.remove(out)


def _record(probs, expert_ids, keep, slot, dispatch):
    if not _RECORDS:
        return
    entry = {"probs": probs.cpu(), "expert_ids": expert_ids.cpu(),
             "keep": None if keep is None else keep.cpu(),
             "slot": None if slot is None else slot.cpu(),
             "dispatch": dispatch}
    for rec in _RECORDS:
        rec.append(entry)


class Lazy:
    """A weight drawn from ``gen`` when :meth:`draw` is called: the shape,
    dtype and device of ``M._normal(gen, shape, scale, dtype, device)``.
    ``transformer._stack`` draws each into its stacked leaf, so a layer's
    expert stacks are never all held beside the stack."""

    def __init__(self, gen, shape, scale, dtype, device):
        self.gen, self.shape, self.scale = gen, tuple(shape), scale
        self.dtype, self.device = dtype, torch.device(device)

    def draw(self) -> torch.Tensor:
        return M._normal(self.gen, self.shape, self.scale, self.dtype,
                         self.device)


def moe_init(gen, cfg, dtype, device, lazy: bool = False) -> Params:
    """The router (f32) and the dense expert stacks in ``dtype``, drawn in
    the reference's order; ``lazy``: the stacks as :class:`Lazy` leaves."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.expert_ff
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(ff)
    router = M._normal(gen, (d, e), s_in, torch.float32, device)
    stacks = {"w_gate": ((e, d, ff), s_in), "w_up": ((e, d, ff), s_in),
              "w_down": ((e, ff, d), s_out)}
    p = {"router": router}
    for name, (shape, scale) in stacks.items():
        w = Lazy(gen, shape, scale, dtype, device)
        p[name] = w if lazy else w.draw()
    return p


def _capacity(cfg, num_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * num_tokens
                      * cfg.experts_per_token / cfg.num_experts))
    return max(8, ((c + 7) // 8) * 8)


def _route(router: torch.Tensor, x: torch.Tensor, k: int):
    """(probs, gate_vals, expert_ids) of the f32 router product on ``x``
    (``(..., d)``): softmax over the experts, the top k (ties to the lower
    id), the gates renormalized over k."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router is an f32 product: TF32 must be "
                           "off (torch.backends.cuda.matmul.allow_tf32)")
    logits = torch.matmul(x.to(torch.float32), router.to(torch.float32))
    z = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = z / z.sum(dim=-1, keepdim=True)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[..., :k], ids[..., :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_ids


def _expert_ffn(p: Params, xe: torch.Tensor, dtype) -> torch.Tensor:
    """The experts' SwiGLU on ``xe`` (``(..., E, C, d)``): ``E`` products
    in the compute dtype, ``jax.nn.silu`` rounded as XLA rounds it."""
    wg = p["w_gate"].to(dtype)
    wu = p["w_up"].to(dtype)
    g = torch.matmul(xe, wg)
    u = torch.matmul(xe, wu)
    del wg, wu
    h = M._silu(g) * u
    del g, u
    return torch.matmul(h, p["w_down"].to(dtype))


def _fold_sorted(contrib: torch.Tensor, order: torch.Tensor, t: int,
                 k: int) -> torch.Tensor:
    """``zeros((t, d)).at[flat_token[order]].add(contrib)`` as the
    reference computes it: ``contrib`` ``(t * k, d)`` f32 is in the sorted
    order ``order`` (sorted position i holds the pair ``order[i]`` = token
    * k + j); each token's k contributions are added from 0.0 in ascending
    sorted position."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    at = torch.sort(inv.view(t, k), dim=1).values
    y = torch.zeros((t, contrib.shape[1]), dtype=torch.float32,
                    device=contrib.device)
    for j in range(k):
        y = y + contrib[at[:, j]]
    return y


def moe_apply(p: Params, x: torch.Tensor, cfg,
              dispatch: str | None = None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """x: (B, S, D) -> (y in x's dtype, the f32 aux loss).  Serving only:
    where autograd records it raises (the dispatch's gradients are not yet
    held to the reference's)."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in tree_leaves(p)
            if isinstance(t, torch.Tensor))):
        raise NotImplementedError("the moe dispatch under autograd is "
                                  "ROADMAP queue 1 item 18")
    if dispatch is None:
        dispatch = cfg.moe_dispatch
    if dispatch == "grouped":
        return _moe_grouped(p, x, cfg)
    if dispatch not in ("sort", "dense"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dtype = cfg.compute_dtype
    t = b * s
    xt = x.reshape(t, d)
    dev = x.device

    probs, gate_vals, expert_ids = _route(p["router"], xt, k)
    # Switch-style load-balance auxiliary loss.
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.nn.functional.one_hot(expert_ids, e)
                    .to(torch.float32).sum(dim=1), dim=0)
    aux = e * torch.sum(me * ce)

    if dispatch == "dense":
        _record(probs, expert_ids, None, None, dispatch)
        y_all = _expert_ffn(p, xt.to(dtype)[None], dtype)      # (E, T, d)
        gates_full = torch.zeros((t, e), dtype=torch.float32, device=dev)
        gates_full.scatter_(1, expert_ids, gate_vals)
        y = torch.einsum("etd,te->td", y_all.to(torch.float32), gates_full)
        return y.reshape(b, s, d).to(x.dtype), aux

    # ---- sort-based capacity dispatch ----
    cap = _capacity(cfg, t)
    flat_expert = expert_ids.reshape(-1)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    flat_gate = gate_vals.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    se, stok, sg = flat_expert[order], flat_token[order], flat_gate[order]
    counts = torch.bincount(se, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))
    _record(probs, expert_ids, keep, slot, dispatch)

    buf = torch.zeros((e * cap + 1, d), dtype=dtype, device=dev)
    buf[slot[keep]] = xt[stok[keep]].to(dtype)   # kept slots are distinct
    ye = _expert_ffn(p, buf[: e * cap].view(e, cap, d), dtype)
    del buf
    ye_flat = torch.cat([ye.reshape(e * cap, d),
                         torch.zeros((1, d), dtype=dtype, device=dev)])
    del ye
    contrib = ye_flat[slot].to(torch.float32) * (
        sg * keep.to(torch.float32))[:, None]
    y = _fold_sorted(contrib, order, t, k)
    return y.reshape(b, s, d).to(x.dtype), aux


def _moe_grouped(p: Params, x: torch.Tensor, cfg) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Group-local dispatch: the tokens in G groups, each sorted, packed by
    gathers and dropped on its own (capacity per group).  The combine
    gathers each sorted pair's expert output, un-sorts it and adds each
    token's k contributions from 0.0 in top-k order."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    dtype = cfg.compute_dtype
    dev = x.device
    t = b * s
    g = min(cfg.moe_groups, t)
    while t % g:
        g -= 1
    tg = t // g
    xg = x.reshape(g, tg, d)

    probs, gate_vals, expert_ids = _route(p["router"], xg, k)  # (G, Tg, k)
    cap = _capacity(cfg, tg)
    fe = expert_ids.reshape(g, tg * k)
    ftok = torch.arange(tg, device=dev).repeat_interleave(k).expand(g, -1)
    fgate = gate_vals.reshape(g, tg * k)

    order = torch.argsort(fe, dim=1, stable=True)
    se = torch.gather(fe, 1, order)
    stok = torch.gather(ftok, 1, order)
    sg = torch.gather(fgate, 1, order)
    bounds = torch.searchsorted(
        se, torch.arange(e + 1, device=dev).expand(g, -1).contiguous())
    starts = bounds[:, :-1]
    counts = bounds[:, 1:] - bounds[:, :-1]

    me = torch.mean(probs, dim=(0, 1))
    ce = torch.sum(counts, dim=0).to(torch.float32) / t
    aux = e * torch.sum(me * ce)
    pos_in_e = torch.arange(tg * k, device=dev)[None, :] - torch.gather(
        starts, 1, se)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))
    _record(probs, expert_ids, keep, slot, "grouped")

    # Scatter-free dispatch: slot (ee, c) of a group gathers its sorted
    # pair starts[ee] + c.
    xsel = torch.gather(xg.to(dtype), 1, stok[..., None].expand(-1, -1, d))
    cpos = torch.arange(cap, device=dev)[None, None, :]
    src = torch.clamp(starts[:, :, None] + cpos, 0, tg * k - 1)
    valid = cpos < counts[:, :, None]
    xe = torch.gather(xsel, 1, src.reshape(g, e * cap)[..., None]
                      .expand(-1, -1, d)).reshape(g, e, cap, d)
    del xsel
    xe = torch.where(valid[..., None], xe, torch.zeros((), dtype=dtype,
                                                       device=dev))
    ye = _expert_ffn(p, xe, dtype)                           # (G, E, C, d)
    del xe

    ye_flat = torch.cat([ye.reshape(g, e * cap, d),
                         torch.zeros((g, 1, d), dtype=dtype, device=dev)], 1)
    del ye
    contrib = torch.gather(ye_flat, 1, slot[..., None].expand(-1, -1, d))
    contrib = contrib.to(torch.float32) * (sg * keep.to(torch.float32)
                                           )[..., None]
    inv_order = torch.argsort(order, dim=1)
    contrib = torch.gather(contrib, 1, inv_order[..., None].expand(-1, -1, d))
    parts = contrib.reshape(g, tg, k, d)
    y = torch.zeros((g, tg, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + parts[:, :, j]
    return y.reshape(b, s, d).to(x.dtype), aux
