"""Deterministic, shardable, resume-exact synthetic token pipeline: port of
``repro/data/pipeline.py``.

Every batch is a pure function of (seed, step, shard), drawn with the
reference's own random bits (``data/_threefry.py``: threefry2x32 and the
``jax.random`` draws it uses), so a restart from a checkpoint replays the
exact stream and each data-parallel shard makes only its slice.  The
synthetic "documents" follow a Zipfian unigram mix with an induced bigram
twist (``label[t] = (token[t] * 7919 + 1) % V`` half the time), so the LM
loss has a learnable signal.

``batch_at``'s tokens, labels and mask are the reference's exactly (the
argmax of its Gumbel noise, whose ``log`` is torch's: a flip needs two
candidates within an ulp or so of each other); the frontends' stub
embeddings (``prefix_embeds``, ``enc_embeds``) are the reference's
standard normals within a few f32 ulps (torch's ``erfinv``).  The
``(B, S + 1, V)`` Gumbel block is streamed a block of rows at a time
(:func:`_threefry.categorical`).  Batches are made on ``device`` (the
card unless asked).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.data import _threefry as R

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_prefix_tokens: int = 0   # vlm
    enc_len: int = 0             # encdec
    d_model: int = 0             # for frontend stub embeddings


def _zipf_logits(vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks
    return np.log(p / p.sum())


class TokenPipeline:
    """Stateless batch generator: ``batch_at(step[, shard, num_shards])``,
    the reference's draws without ``jax_enable_x64`` (as its train CLI
    runs; under x64 its gate ``bernoulli(key, 0.5, ...)`` takes 0.5 as an
    f64 and draws other bits)."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._logits = torch.from_numpy(
            _zipf_logits(cfg.vocab_size).astype(np.float32)).to(self.device)

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1
                 ) -> Dict[str, torch.Tensor]:
        cfg, dev = self.cfg, self.device
        assert cfg.global_batch % num_shards == 0
        b = cfg.global_batch // num_shards
        key = R.fold_in(R.fold_in(R.key(cfg.seed), step), shard)
        ks = R.split(key, 4)
        base = R.categorical(ks[0], self._logits, (b, cfg.seq_len + 1))
        tokens = base[:, :-1]
        perm_shift = 7919  # prime; x -> (x*k+1) % V is a fixed map
        follow = (tokens * perm_shift + 1) % cfg.vocab_size
        gate = R.bernoulli(ks[1], 0.5, follow.shape, device=dev)
        labels = torch.where(gate, follow, base[:, 1:])
        batch = {
            "tokens": tokens.to(torch.int32),
            "labels": labels.to(torch.int32),
            "loss_mask": torch.ones((b, cfg.seq_len), dtype=torch.float32,
                                    device=dev),
        }
        if cfg.num_prefix_tokens:
            batch["prefix_embeds"] = R.normal(
                ks[2], (b, cfg.num_prefix_tokens, cfg.d_model), device=dev)
        if cfg.enc_len:
            batch["enc_embeds"] = R.normal(
                ks[3], (b, cfg.enc_len, cfg.d_model), device=dev)
        return batch

    def iterate(self, start_step: int = 0, shard: int = 0,
                num_shards: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch_at(step, shard, num_shards)
            step += 1
