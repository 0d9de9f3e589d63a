"""GSE-SEM quantization of LM weights: port of
``repro/quant/gse_tensor.py``.

``quantize_tree`` packs every float leaf of at least ``min_size``
elements with the port's numpy ``gse.pack`` (bitwise the reference's): one
shared-exponent table per leaf, so a stacked ``(L, ...)`` leaf shares one
table across its layers, as in the reference.  ``dequantize_tree`` decodes
each pack with kernel D at the requested tag, written in the requested
dtype (bf16 rounded to nearest even, which equals the reference's
``decode_jnp(..., float32).astype(dtype)``); the decode is elementwise, so
a leaf of any rank decodes flat.  ``gse_linear`` multiplies with kernel E.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import gse
from repro_torch.core.precision_table import TAG_BITS_USED
from repro_torch.kernels.gse_decode import gse_decode_dense
from repro_torch.kernels.gse_matmul import X_DTYPES, gse_matmul_dense
from repro_torch.kernels.ref import make_scales
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["quantize_tree", "dequantize_tree", "gse_linear", "tree_bytes"]


def _is_packed(x) -> bool:
    return isinstance(x, gse.GSEPacked)


def _scales(p: gse.GSEPacked, tag: int) -> torch.Tensor:
    """Decode scales of a dense pack at ``tag``; rejects tag 3 on an
    f32-source pack as ``decode_jnp`` does."""
    p._tag_bytes(tag)
    bias = 1023 if p.frac_bits == gse._F64_FRAC else 127
    return make_scales(p.table, TAG_BITS_USED[tag] - p.ei_bit, bias=bias)


def quantize_tree(params: Any, k: int = 8, min_size: int = 4096) -> Any:
    """Pack float leaves (>= min_size elements) to GSEPacked on the leaf's
    device; keep the rest."""

    def q(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and leaf.numel() >= min_size):
            vals = leaf.detach().to(torch.float64).cpu().numpy()
            return gse.pack(vals, k, device=leaf.device)
        return leaf

    return tree_map(q, params)


def dequantize_tree(packed: Any, tag: int = 2, dtype=torch.bfloat16) -> Any:
    """Decode every GSEPacked leaf at ``tag`` into ``dtype`` with kernel D."""

    def dq(leaf):
        if not _is_packed(leaf):
            return leaf
        out = dtype if dtype in (torch.float32, torch.bfloat16) \
            else torch.float32
        return gse_decode_dense(leaf.head, leaf.tail1, leaf.tail2,
                                _scales(leaf, tag), ei_bit=leaf.ei_bit,
                                tag=tag, out_dtype=out,
                                device=leaf.head.device).to(dtype)

    return tree_map(dq, packed, is_leaf=_is_packed)


def gse_linear(x: torch.Tensor, w: Any, tag: int = 2,
               dtype=torch.bfloat16) -> torch.Tensor:
    """x @ W for a dense or GSEPacked W (kernel E for packs): x is cast to
    ``dtype`` (f32 or bf16), the product summed in f32 and returned in
    ``dtype``."""
    if not _is_packed(w):
        return torch.matmul(x.to(dtype), w.to(dtype))
    if dtype not in X_DTYPES:
        raise TypeError(f"gse_linear runs in f32 or bf16, got {dtype}")
    xc = x.to(dtype)
    lead = xc.shape[:-1]
    y = gse_matmul_dense(xc.reshape(-1, xc.shape[-1]).contiguous(), w.head,
                         w.tail1, w.tail2, _scales(w, tag), ei_bit=w.ei_bit,
                         tag=tag, device=xc.device)
    return y.to(dtype).reshape(*lead, y.shape[-1])


def tree_bytes(tree: Any, tag: int = 2) -> int:
    """Bytes the parameter stream reads at serving precision ``tag``."""
    total = 0
    for leaf in tree_leaves(tree, is_leaf=_is_packed):
        if _is_packed(leaf):
            total += leaf.nbytes(tag)
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif isinstance(leaf, np.ndarray):
            total += leaf.nbytes
    return total
