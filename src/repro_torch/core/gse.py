"""GSE-SEM: Group-Shared-Exponent / Sign-ExponentIndex-Mantissa format.

Port of ``repro/core/gse.py``: ``_ei_bit``, ``GSEPacked``,
``extract_shared_exponents`` (:136), ``pack_with_table`` (:174), ``pack``,
``_decode_parts`` and ``decode`` are host-side numpy, copied so the packed
bits match ``repro`` exactly; ``_pow2_exact`` (:314) is torch.

Format (paper Section III.B): ``k`` shared exponents are extracted from
the data (top-(k-1) by frequency plus the maximum), each stored as
``biased_exponent + 1``.  ``EI_BIT = ceil(log2(k))`` head bits index the
table and ``M_H = 15 - EI_BIT`` mantissa bits remain in the head.  The
denormalized mantissa ``M`` is a ``W = M_H + 48``-bit integer with
``value = (-1)^sign * M * 2^(E_sh - W)``; head keeps its top ``M_H``
bits, tail1 the next 16 and tail2 the low 32:

    tag=1  head                 (16 bits/val)
    tag=2  head + tail1         (32 bits/val)
    tag=3  head + tail1 + tail2 (64 bits/val)

Packed segments are torch tensors at their storage widths (head/tail1
``uint16``, tail2 ``uint32``, table ``int32``) so the byte model is
literal.  Torch on the CPU has no shifts for unsigned 16/32-bit tensors,
so host code works in numpy and device-side code widens to int64 first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.precision_table import TAG_VALUE_BYTES

__all__ = [
    "GSEPacked",
    "extract_shared_exponents",
    "pack",
    "pack_with_table",
    "decode",
]

_F64_BIAS = 1023
_F64_FRAC = 52
_F32_BIAS = 127
_F32_FRAC = 23
_BIG = np.int64(1 << 40)


def _ei_bit(k: int) -> int:
    if k < 2 or k > 4096:
        raise ValueError(f"k must be in [2, 4096], got {k}")
    return max(1, int(np.ceil(np.log2(k))))


def _np(t) -> np.ndarray:
    """Host numpy view of a tensor (or array) at its own dtype."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


@dataclasses.dataclass
class GSEPacked:
    """A GSE-SEM packed tensor; segment arrays are torch tensors."""

    table: torch.Tensor  # (k,) int32, biased exponent + 1
    head: torch.Tensor   # (...,) uint16: sign | expIdx | top mantissa
    tail1: torch.Tensor  # (...,) uint16: mantissa bits [W-M_H-16, W-M_H)
    tail2: torch.Tensor  # (...,) uint32: mantissa bits [0, 32)
    ei_bit: int
    frac_bits: int       # 52 (f64 source) or 23 (f32 source)

    @property
    def m_h(self) -> int:
        return 15 - self.ei_bit

    @property
    def width(self) -> int:
        return self.m_h + 48 if self.frac_bits == _F64_FRAC else self.m_h + 16

    @property
    def shape(self):
        return tuple(self.head.shape)

    def _tag_bytes(self, tag: int) -> int:
        """Per-value stored bytes a tag-``tag`` read streams."""
        if tag not in (1, 2, 3):
            raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
        if self.frac_bits != _F64_FRAC and tag == 3:
            raise ValueError(
                "f32-source packs (frac_bits=23) store no tail2; "
                "tags 1 and 2 only"
            )
        return TAG_VALUE_BYTES[tag]

    def nbytes(self, tag: int) -> int:
        n = int(np.prod(self.head.shape))
        return n * self._tag_bytes(tag) + int(self.table.numel()) * 4

    def bytes_touched(self, tag: int) -> int:
        """Modeled HBM bytes a tag-``tag`` decode streams for this operand."""
        return self.nbytes(tag)


def extract_shared_exponents(vals: np.ndarray, k: int) -> np.ndarray:
    """Return the (k,) int32 table of shared exponents, stored biased+1.

    Top-(k-1) biased exponents by frequency of occurrence, plus the maximum
    exponent.  Entries are sorted descending; unused slots repeat the max
    entry.
    """
    v = np.asarray(_np(vals), dtype=np.float64).ravel()
    bits = v.view(np.uint64)
    e_b = ((bits >> _F64_FRAC) & 0x7FF).astype(np.int64)
    frac = bits & ((np.uint64(1) << np.uint64(_F64_FRAC)) - np.uint64(1))
    nonzero = (e_b != 0) | (frac != 0)
    e_eff = np.where(e_b != 0, e_b, 1)[nonzero]  # subnormals -> biased 1
    if e_eff.size == 0:
        return np.full((k,), 1, dtype=np.int32)
    counts = np.bincount(e_eff, minlength=2048)
    order = np.argsort(-counts, kind="stable")
    top = [int(e) for e in order[: k] if counts[e] > 0]
    e_max = int(e_eff.max())
    if e_max not in top:
        top = top[: k - 1] + [e_max]
    table = np.asarray(top, dtype=np.int64) + 1  # denormalized convention
    if table.size < k:
        table = np.concatenate(
            [table, np.full((k - table.size,), table.max(), dtype=np.int64)]
        )
    table = np.sort(table)[::-1]
    return table.astype(np.int32)


def _pack_segments(vals: np.ndarray, table: np.ndarray, k: int):
    """numpy core of :func:`pack_with_table`: ``(head, tail1, tail2)``."""
    ei = _ei_bit(k)
    m_h = 15 - ei
    w = m_h + 48
    v = np.ascontiguousarray(np.asarray(vals, dtype=np.float64))
    shp = v.shape
    v = v.ravel()
    bits = v.view(np.uint64)
    sign = ((bits >> np.uint64(63)) & np.uint64(1)).astype(np.uint64)
    e_b = ((bits >> np.uint64(_F64_FRAC)) & np.uint64(0x7FF)).astype(np.int64)
    frac = (bits & ((np.uint64(1) << np.uint64(_F64_FRAC)) - np.uint64(1))).astype(
        np.uint64
    )
    nonzero = (e_b != 0) | (frac != 0)
    m53 = np.where(e_b != 0, (np.uint64(1) << np.uint64(_F64_FRAC)) | frac, frac)
    e_eff = np.where(e_b != 0, e_b, 1)

    tbl = np.asarray(table, dtype=np.int64)
    diff = tbl[None, :] - e_eff[:, None]  # (n, k)
    diff = np.where(diff > 0, diff, _BIG)
    exp_idx = np.argmin(diff, axis=1).astype(np.uint64)
    min_diff = diff[np.arange(diff.shape[0]), exp_idx]
    overflow = min_diff >= _BIG  # value above all table entries
    min_diff = np.where(overflow, 1, min_diff)

    lsh = w - _F64_FRAC - min_diff  # left shift amount (may be negative)
    # Right-shift path: round-to-nearest-even on the discarded bits; a
    # carry past W bits saturates to the all-ones mantissa.
    rsh = np.minimum(np.maximum(-lsh, 0), 63).astype(np.uint64)
    floor_ = m53 >> rsh
    rem = m53 & ((np.uint64(1) << rsh) - np.uint64(1))
    half = (np.uint64(1) << rsh) >> np.uint64(1)
    round_up = (rsh > 0) & (
        (rem > half) | ((rem == half) & ((floor_ & np.uint64(1)) == np.uint64(1)))
    )
    rounded = np.minimum(
        floor_ + round_up.astype(np.uint64),
        (np.uint64(1) << np.uint64(w)) - np.uint64(1),
    )
    m = np.where(lsh >= 0, m53 << np.maximum(lsh, 0).astype(np.uint64), rounded)
    m = np.where(nonzero, m, np.uint64(0))
    # Saturate overflowed values to all-ones mantissa under the max entry.
    max_idx = np.uint64(np.argmax(tbl))
    m = np.where(overflow & nonzero, (np.uint64(1) << np.uint64(w)) - np.uint64(1), m)
    exp_idx = np.where(overflow & nonzero, max_idx, exp_idx)

    head = (
        (sign << np.uint64(15))
        | (exp_idx << np.uint64(m_h))
        | (m >> np.uint64(w - m_h))
    ).astype(np.uint16)
    tail1 = ((m >> np.uint64(32)) & np.uint64(0xFFFF)).astype(np.uint16)
    tail2 = (m & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return head.reshape(shp), tail1.reshape(shp), tail2.reshape(shp)


def pack_with_table(vals, table, k: int, device="cuda") -> GSEPacked:
    """Pack float64 ``vals`` against an existing shared-exponent table.

    Values whose exponent is >= every table entry saturate to the largest
    representable magnitude under the max table entry.
    """
    head, tail1, tail2 = _pack_segments(_np(vals), _np(table), k)
    return GSEPacked(
        table=torch.from_numpy(np.asarray(_np(table), np.int32)).to(device),
        head=torch.from_numpy(head).to(device),
        tail1=torch.from_numpy(tail1).to(device),
        tail2=torch.from_numpy(tail2).to(device),
        ei_bit=_ei_bit(k),
        frac_bits=_F64_FRAC,
    )


def pack(vals, k: int = 8, device="cuda") -> GSEPacked:
    """Extract shared exponents from ``vals`` and pack (paper Algorithm 1)."""
    v = _np(vals)
    return pack_with_table(v, extract_shared_exponents(v, k), k, device=device)


def _decode_parts(table, head, tail1, tail2, ei_bit: int, frac_bits: int,
                  tag: int):
    """numpy decode. Returns (sign_factor, mant, exp_scale_pow):
    value = sign * mant * 2**pow with mant an integer."""
    m_h = 15 - ei_bit
    w = m_h + 48 if frac_bits == _F64_FRAC else m_h + 16
    h = head.astype(np.uint32)
    sign = (h >> 15) & 0x1
    exp_idx = (h >> m_h) & ((1 << ei_bit) - 1)
    m_head = (h & ((1 << m_h) - 1)).astype(np.uint64)

    if tag == 1:
        mant = m_head
        bits_used = m_h
    elif tag == 2:
        mant = (m_head << 16) | tail1.astype(np.uint64)
        bits_used = m_h + 16
    elif tag == 3:
        mant = (
            (m_head << 48)
            | (tail1.astype(np.uint64) << 32)
            | tail2.astype(np.uint64)
        )
        bits_used = w
    else:
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")

    e_sh = table[exp_idx].astype(np.int64) - (
        _F64_BIAS if frac_bits == _F64_FRAC else _F32_BIAS
    )
    pow_ = e_sh - bits_used
    sgn = 1.0 - 2.0 * sign.astype(np.float64)
    return sgn, mant, pow_


def decode(packed: GSEPacked, tag: int = 3) -> torch.Tensor:
    """Reference decode to float64 (numpy arithmetic), on the packed
    tensor's device.  ``tag`` selects precision (1/2/3)."""
    if packed.frac_bits != _F64_FRAC and tag == 3:
        raise ValueError(
            "f32-source packs (frac_bits=23) store no tail2; tags 1 and 2 only"
        )
    sgn, mant, pow_ = _decode_parts(
        _np(packed.table), _np(packed.head), _np(packed.tail1),
        _np(packed.tail2), packed.ei_bit, packed.frac_bits, tag,
    )
    out = sgn * np.ldexp(mant.astype(np.float64), pow_.astype(np.int64))
    return torch.from_numpy(out).to(packed.head.device)


def _pow2_exact(n: torch.Tensor, dtype) -> torch.Tensor:
    """Exact 2**n for integer n, via exponent-field construction.

    Exponents below the normal range clip to 0 (underflow-to-zero), above
    it to the max finite binade (saturate).
    """
    if dtype == torch.float64:
        e = torch.clamp(n.to(torch.int64) + _F64_BIAS, 0, 2046)
        return (e << _F64_FRAC).view(torch.float64)
    e = torch.clamp(n.to(torch.int32) + _F32_BIAS, 0, 254)
    return (e << _F32_FRAC).view(torch.float32).to(dtype)
