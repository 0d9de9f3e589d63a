"""AdamW, the cosine schedule and global-norm clipping: port of
``repro/optim/adamw.py`` in plain torch ops on f32 state (the reference
has no kernel here).

The arithmetic is the reference's, step for step, in f32: the schedule
from the f32 step, the clip scale ``min(1, clip_norm / max(gnorm,
1e-12))`` with ``gnorm`` the square root of the leaves' dot products
summed in ``jax.tree.leaves`` order (:func:`tree.tree_leaves_sorted`:
dict keys sorted; :func:`global_norm`), the moments, the bias corrections ``1 - b ** t`` and
the decoupled weight decay.  Unlike the reference, :meth:`AdamW.update`
writes the new moments into the state's tensors in place (the state of a
full-width model is four copies of its params; keeping the old moments
beside the new would add two), and returns the updates as new tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves_sorted, tree_map

__all__ = ["AdamW", "AdamWState", "global_norm"]


class AdamWState(NamedTuple):
    mu: Any
    nu: Any


def global_norm(grads) -> torch.Tensor:
    """``sqrt(sum(vdot(g, g)))`` over the leaves in ``jax.tree.leaves``
    order, as f32.  Each leaf's sum of squares is accumulated in f64: the
    reference's f32 ``vdot`` (XLA's CPU dot) loses precision on leaves of
    millions of elements (13% low on qwen3_4b's full-width 2-layer twin,
    whose gradients agree with the port's to 1e-6; to 1e-6 on the smoke
    configs), and the card's and the host's f32 dots would each lose
    another amount."""
    total = 0
    for g in tree_leaves_sorted(grads):
        total = total + torch.linalg.vector_norm(g, dtype=torch.float64) ** 2
    return torch.sqrt(total).to(torch.float32)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1

    def schedule(self, step) -> torch.Tensor:
        """The learning rate at ``step`` (a tensor), in f32."""
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp_max((step + 1.0) / max(self.warmup_steps, 1), 1.0)
        prog = torch.clamp(
            (step - self.warmup_steps)
            / max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    def init(self, params) -> AdamWState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params))

    def update(self, grads, state: AdamWState, params,
               step) -> Tuple[Any, AdamWState]:
        """Returns (updates, state): ``params + updates`` is the step.  The
        state's moment tensors are updated in place and returned."""
        with torch.no_grad():
            gnorm = global_norm(grads)
            dev = gnorm.device
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
            t = torch.as_tensor(step, device=dev).to(torch.float32) + 1.0
            bc1 = 1 - torch.pow(_f32(self.b1, dev), t)
            bc2 = 1 - torch.pow(_f32(self.b2, dev), t)
            lr = self.schedule(torch.as_tensor(step, device=dev))

            def one(g, m, v, p):
                g = (g * scale).to(torch.float32)
                m.mul_(self.b1).add_((1 - self.b1) * g)
                v.mul_(self.b2).add_((1 - self.b2) * g * g)
                mh = m / bc1
                vh = v / bc2
                u = -lr * (mh / (torch.sqrt(vh) + self.eps)
                           + self.weight_decay * p.to(torch.float32))
                return u.to(p.dtype)

            updates = tree_map(one, grads, state.mu, state.nu, params)
        return updates, state
