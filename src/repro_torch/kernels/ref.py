"""Pure-torch oracles for the SpMV kernels (the ``ref.py`` contract).

Port of ``repro/kernels/ref.py``: ``make_scales`` (:21), ``_mant``
(:38), ``decode_ref`` (:57), ``decode_csr_ref`` (:67), ``spmv_ell_ref``
(:87), ``matmul_ref`` (:108) and ``flash_ref`` (:116).  All decode math
follows the f32 kernel discipline: mantissa segments are combined in f32
(tag-2/3 mantissas round to 24 bits) and scales come from a per-tag
power-of-two table.  Unsigned segments are widened to int64 before any
shift (torch on the CPU has no shifts for uint16/uint32).

The dense decode and the attention are the plain versions of kernels D
and F (``gse_decode.decode_values`` and
``flash_attn.flash_attention_gqa_plain``), so the port knows the dense
head-split layout in one place; the tests hold them to the reference's
oracles.
"""
from __future__ import annotations

import torch

from repro_torch.core.gse import _pow2_exact
from repro_torch.core.precision_table import TAG_BITS_USED
from repro_torch.kernels.flash_attn import flash_attention_gqa_plain
from repro_torch.kernels.gse_decode import decode_values

__all__ = ["make_scales", "decode_ref", "decode_csr_ref", "spmv_ell_ref",
           "matmul_ref", "flash_ref"]


def make_scales(table: torch.Tensor, bits_used: int, bias: int = 1023,
                dtype=torch.float32) -> torch.Tensor:
    """Per-exponent-index decode scales: 2^(E_sh - bits_used), exact."""
    pow_ = table.to(torch.int32) - bias - bits_used
    half = torch.div(pow_, 2, rounding_mode="floor")
    return _pow2_exact(half, dtype) * _pow2_exact(pow_ - half, dtype)


def _mant(m_head, tail1, tail2, tag):
    if tag == 1:
        return m_head
    if tag == 2:
        return m_head * 65536.0 + tail1.to(torch.int64).to(torch.float32)
    return (
        m_head * float(2.0**48)
        + tail1.to(torch.int64).to(torch.float32) * float(2.0**32)
        + tail2.to(torch.int64).to(torch.float32)
    )


def decode_ref(head, tail1, tail2, table, ei_bit: int, tag: int):
    """Oracle for the dense decode kernel: packed segments -> f32 values
    (``gse.pack`` packs: scales at bias 1023)."""
    scales = make_scales(table, TAG_BITS_USED[tag] - ei_bit)
    return decode_values(head, tail1, tail2, scales, ei_bit, tag)


def _split_sparse(colpak, head, ei_bit: int):
    """(sgn, exp_idx, col, m_head) of the sparse layout, f32 mantissa."""
    shift = 32 - ei_bit
    cp = colpak.to(torch.int64)
    exp_idx = cp >> shift
    col = cp & ((1 << shift) - 1)
    h = head.to(torch.int64)
    sgn = 1.0 - 2.0 * ((h >> 15) & 0x1).to(torch.float32)
    m_head = (h & 0x7FFF).to(torch.float32)
    return sgn, exp_idx, col, m_head


def decode_csr_ref(colpak, head, tail1, tail2, table, ei_bit: int, tag: int):
    """Per-entry f32 decode oracle for the flat sparse layout: expIdx rides
    the top ``ei_bit`` bits of ``colpak`` and the head keeps the full
    15-bit mantissa."""
    sgn, exp_idx, _, m_head = _split_sparse(colpak, head, ei_bit)
    mant = _mant(m_head, tail1, tail2, tag)
    scales = make_scales(table, TAG_BITS_USED[tag])
    return sgn * mant * scales[exp_idx]


def spmv_ell_ref(colpak, head, tail1, tail2, table, x, ei_bit: int, tag: int):
    """Oracle for the f32 ELL SpMV: (rows, L) arrays, y = A @ x with the
    decode fused, f32 sums."""
    sgn, exp_idx, col, m_head = _split_sparse(colpak, head, ei_bit)
    mant = _mant(m_head, tail1, tail2, tag)
    scales = make_scales(table, TAG_BITS_USED[tag])
    vals = sgn * mant * scales[exp_idx]
    return torch.sum(vals * x.to(torch.float32)[col], dim=1)


def matmul_ref(x, head, tail1, tail2, table, ei_bit: int, tag: int):
    """Oracle for the GSE matmul: ``x @ decode(W)`` as a full-f32 product
    (no TF32 on the card)."""
    w = decode_ref(head, tail1, tail2, table, ei_bit, tag)
    return torch.matmul(x.to(torch.float32), w)


def flash_ref(q, k, v, causal: bool = True):
    """Oracle for flash attention: plain softmax attention over ``(BH, S,
    hd)`` in f32, the output in q's dtype (one head per batch row)."""
    return flash_attention_gqa_plain(q[:, :, None], k[:, :, None],
                                     v[:, :, None], causal=causal)[:, :, 0]
