"""GSE-SEM gradient compression with error feedback: port of
``repro/distributed/compress.py``.

A gradient is packed to the 16-bit GSE-SEM head against a shared-exponent
table of its own (``core/gse.py``: ``extract_shared_exponents_jnp``,
``pack32_jnp``) and decoded at ``tag``, bitwise the reference's round
trip; an error-feedback buffer carries each step's quantization error
into the next step's gradient (Karimireddy et al. 2019), and leaves
smaller than ``min_size`` pass untouched.  This is what ``launch/train.py
--grad-compress`` installs as the train step's ``grad_transform``.  The
reference leaves the cross-pod reduction of the compressed payload to
XLA; on one card there is no collective, so only the round trip is
ported (ROADMAP queue 1 item 15 for the wire).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core import gse
from repro_torch.tree import tree_map

__all__ = ["compress_decompress", "make_error_feedback_transform"]


def compress_decompress(g: torch.Tensor, k: int = 8, tag: int = 1):
    """Round-trip a gradient tensor through the GSE-SEM wire format.
    Returns (g_hat, err) with ``err = g - g_hat`` (in f32, then both in
    g's dtype), for error feedback."""
    flat = g.to(torch.float32).reshape(-1)
    table = gse.extract_shared_exponents_jnp(flat, k)
    head, tail1 = gse.pack32_jnp(flat, table, k)
    g_hat = gse.decode32_jnp(table, head, tail1, k, tag, torch.float32)
    g_hat = g_hat.reshape(g.shape)
    err = g.to(torch.float32) - g_hat
    return g_hat.to(g.dtype), err.to(g.dtype)


def make_error_feedback_transform(k: int = 8, tag: int = 1,
                                  min_size: int = 65536
                                  ) -> Tuple[Callable, Callable]:
    """Returns (init_buf, transform).

    ``transform(grads, buf) -> (compressed_grads, new_buf)`` adds the
    carried quantization error before compressing and skips leaves of
    fewer than ``min_size`` elements (their buffer stays zero)."""

    def init_buf(grads):
        return tree_map(torch.zeros_like, grads)

    def transform(grads, buf):
        def one(g, e):
            if g.numel() < min_size:
                return g, torch.zeros_like(g)
            return compress_decompress(g + e, k=k, tag=tag)

        pairs = tree_map(one, grads, buf)
        is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
        return (tree_map(lambda p: p[0], pairs, is_leaf=is_pair),
                tree_map(lambda p: p[1], pairs, is_leaf=is_pair))

    return init_buf, transform
