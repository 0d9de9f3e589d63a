"""The reference's random draws, bit for bit: threefry2x32 and the parts of
``jax.random`` the data pipeline uses, in torch.

Copied from the definitions in the installed jax (``jax/_src/prng.py``
and ``jax/_src/random.py``) with ``jax_threefry_partitionable`` on (the
installed jax's default; ``jax.random.key`` keys, threefry2x32):

* a key is two uint32 words ``(k1, k2)``; ``key(seed)`` is ``(seed >> 32,
  seed & 0xFFFFFFFF)``;
* ``fold_in(key, d)`` is threefry2x32 of the count pair ``(0, d)``;
* ``split(key, n)`` is key ``i`` = threefry2x32 of ``(0, i)`` (the
  partitionable, fold-like split);
* ``bits(key, shape)``: the element at flat index ``n`` is ``y1 ^ y2`` of
  threefry2x32 of ``(n >> 32, n & 0xFFFFFFFF)`` (32 bits);
* ``uniform`` (f32, as the reference draws without ``jax_enable_x64``):
  the top mantissa bits of those bits as a float in [1, 2),
  minus 1, scaled to [minval, maxval) and floored at minval;
  ``bernoulli(p)`` is ``uniform < p``; ``gumbel`` is ``-log(-log(u))``
  with ``u`` uniform in [tiny, 1); ``categorical`` the argmax of gumbel
  noise plus the logits; ``normal`` is ``sqrt(2) * erfinv(u)`` with ``u``
  uniform in (-1, 1).

Torch has no ``>>`` on ``uint32`` on the CPU, so the words are held in
int64 tensors in [0, 2^32) and every sum is masked back to 32 bits.  The
integer draws (bits, bernoulli, the argmax of categorical) are the
reference's exactly; ``log`` and ``erfinv`` are torch's, within an ulp or
a few of XLA's (``tests/test_torch_pipeline.py`` states the bounds).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key", "fold_in", "split", "threefry2x32", "bits", "uniform",
           "bernoulli", "gumbel", "categorical", "normal"]

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 (20 rounds) of the count words ``x1``, ``x2`` (int64
    tensors in [0, 2^32), or ints) under the key ``(k1, k2)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & M32
    return x1, x2


def key(seed: int):
    """``jax.random.key(seed)``'s two words."""
    seed = int(seed)
    return ((seed >> 32) & M32, seed & M32)


def fold_in(k, data: int):
    """``jax.random.fold_in(k, data)``."""
    return threefry2x32(k[0], k[1], 0, int(data) & M32)


def split(k, num: int):
    """``jax.random.split(k, num)`` as a list of keys."""
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def _counts(start: int, n: int, device):
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def bits(k, shape, start: int = 0, count=None, device="cuda"):
    """``jax.random.bits(k, shape, uint32)`` flattened: the elements at flat
    indices ``[start, start + count)`` of ``shape``, as int64."""
    n = math.prod(shape) if count is None else int(count)
    hi, lo = _counts(start, n, device)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return y1 ^ y2


def uniform(k, shape, minval=0.0, maxval=1.0, start: int = 0, count=None,
            device="cuda"):
    """``jax.random.uniform(k, shape, float32, minval, maxval)``, flattened
    as :func:`bits`."""
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(minval)))
    # XLA fuses ``u * span + lo`` into one FMA: the product of u's 23 bits
    # and span's 24 is exact in f64, the sum rounded once to f32.
    u = (bits(k, shape, start, count, device) >> 9).to(torch.float64) \
        * (2.0 ** -23)
    return torch.clamp_min((u * span + lo).to(torch.float32), lo)


def bernoulli(k, p: float, shape, device="cuda"):
    """``jax.random.bernoulli(k, p, shape)`` with ``p`` an f32 (the
    reference's mode without ``jax_enable_x64``, under which a Python float
    is f64 and the uniforms 64-bit)."""
    return (uniform(k, shape, device=device) < p).reshape(shape)


def gumbel(k, shape, start: int = 0, count=None, device="cuda"):
    """``jax.random.gumbel(k, shape, float32)`` (mode "low"), flattened as
    :func:`bits`."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(k, shape, tiny, 1.0, start, count, device)
    return -torch.log(-torch.log(u))


def categorical(k, logits: torch.Tensor, shape, block_elems: int = 1 << 24):
    """``jax.random.categorical(k, logits, shape=shape)`` for 1-D f32
    ``logits`` (V,): per element of ``shape``, the argmax over V of gumbel
    noise (drawn for the whole ``(*shape, V)`` block) plus the logits.
    The noise is streamed a block of rows at a time (about
    ``block_elems`` values), so the block never exists whole; int64."""
    v = logits.shape[0]
    rows = math.prod(shape)
    per = max(1, block_elems // v)
    full = (*shape, v)
    out = torch.empty(rows, dtype=torch.int64, device=logits.device)
    for r0 in range(0, rows, per):
        n = min(per, rows - r0)
        g = gumbel(k, full, r0 * v, n * v, logits.device).view(n, v)
        out[r0:r0 + n] = torch.argmax(g + logits, dim=1)
    return out.reshape(shape)


def normal(k, shape, device="cuda"):
    """``jax.random.normal(k, shape, float32)``: ``sqrt(2) * erfinv(u)``,
    ``u`` uniform in [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0, device=device)
    return (torch.erfinv(u) * float(np.float32(np.sqrt(2)))).reshape(shape)
