"""GSE-SEM: Group-Shared-Exponent / Sign-ExponentIndex-Mantissa format.

Port of ``repro/core/gse.py``: ``_ei_bit``, ``GSEPacked``,
``extract_shared_exponents`` (:136), ``pack_with_table`` (:174), ``pack``,
``_decode_parts`` and ``decode`` are host-side numpy, copied so the packed
bits match ``repro`` exactly; ``_pow2_exact`` (:314) is torch.  The
f32-source pack of the LM path is torch on any device, bitwise the
reference's: ``_decode_jnp``/``decode_jnp`` (:331, :372),
``extract_shared_exponents_jnp`` (:395), ``pack32_jnp`` (:421), ``pack32``
(:473) and ``decode32_jnp`` (:499) keep the reference's names.

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
    "decode_jnp",
    "extract_shared_exponents_jnp",
    "pack32_jnp",
    "pack32",
    "decode32_jnp",
    "gse_fake_quant",
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


def _decode_jnp(table, head, tail1, tail2, ei_bit: int, frac_bits: int,
                tag: int, dtype) -> torch.Tensor:
    """``sgn * ((mant * 2^half) * 2^(pow - half))`` in ``dtype``, in the
    reference's order: the tag-3 mantissa is ``m_head * 2^48 + tail1 *
    2^32 + tail2`` left to right, each term rounded to ``dtype``."""
    m_h = 15 - ei_bit
    w = m_h + 48 if frac_bits == _F64_FRAC else m_h + 16
    h = head.to(torch.int32)
    sign = (h >> 15) & 0x1
    exp_idx = ((h >> m_h) & ((1 << ei_bit) - 1)).to(torch.int64)
    m_head = (h & ((1 << m_h) - 1)).to(dtype)
    if tag == 1:
        mant = m_head
        bits_used = m_h
    elif tag == 2:
        mant = m_head * 65536.0 + tail1.to(torch.int32).to(dtype)
        bits_used = m_h + 16
    else:
        mant = (m_head * float(2.0**48)
                + tail1.to(torch.int32).to(dtype) * float(2.0**32)
                + tail2.to(torch.int64).to(dtype))
        bits_used = w
    e_sh = table.to(torch.int32)[exp_idx] - (
        _F64_BIAS if frac_bits == _F64_FRAC else _F32_BIAS)
    pow_ = e_sh - bits_used
    half = torch.div(pow_, 2, rounding_mode="floor")
    sgn = 1.0 - 2.0 * sign.to(dtype)
    return sgn * ((mant * _pow2_exact(half, dtype))
                  * _pow2_exact(pow_ - half, dtype))


def decode_jnp(packed: GSEPacked, tag: int = 3,
               dtype=torch.float32) -> torch.Tensor:
    """Decode on the packed tensor's device: int->float convert + scale."""
    if packed.frac_bits != _F64_FRAC and tag == 3:
        raise ValueError(
            "f32-source packs (frac_bits=23) store no tail2; tags 1 and 2 only"
        )
    return _decode_jnp(packed.table, packed.head, packed.tail1, packed.tail2,
                       packed.ei_bit, packed.frac_bits, tag, dtype)


def _f32_fields(vals: torch.Tensor):
    """(sign, biased exponent, fraction) of f32 ``vals`` as int32."""
    bits = vals.to(torch.float32).contiguous().view(torch.int32)
    sign = (bits >> 31) & 0x1
    e_b = (bits >> _F32_FRAC) & 0xFF
    frac = bits & ((1 << _F32_FRAC) - 1)
    return sign, e_b, frac


def extract_shared_exponents_jnp(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k exponent table of f32 ``vals`` (biased+1, int32, descending),
    on their device.

    ``jax.lax.top_k`` takes the lower bin first among equal counts; a
    stable descending sort does the same (``torch.topk`` promises no
    order on ties).  Bins that win with a zero count become the max entry,
    as the reference's numpy-parity rule says.
    """
    _, e_b, frac = _f32_fields(vals)
    nonzero = (e_b != 0) | (frac != 0)
    e_eff = torch.where(e_b != 0, e_b, 1).reshape(-1)
    counts = torch.zeros(256, dtype=torch.int32, device=vals.device)
    counts.index_add_(0, e_eff, nonzero.reshape(-1).to(torch.int32))
    top_counts, top = torch.sort(counts, descending=True, stable=True)
    top_counts, top = top_counts[: k - 1], top[: k - 1].to(torch.int32)
    e_max = torch.where(nonzero.reshape(-1), e_eff, 0).max() if \
        e_eff.numel() else torch.zeros((), dtype=torch.int32,
                                       device=vals.device)
    e_max = torch.clamp(e_max, min=1).to(torch.int32)
    top = torch.where(top_counts > 0, top, e_max)
    table = torch.cat([top, e_max.reshape(1)]) + 1
    return torch.sort(table, descending=True).values.to(torch.int32)


# Elements packed per pass of ``pack32_jnp``: bounds its int32/int64
# temporaries (about 40 bytes per element) on a full-width unembedding.
_PACK32_CHUNK = 1 << 24


def _exponent_plan(table, ei: int):
    """Per biased exponent 0-255: (table index, left shift of the 24-bit
    mantissa, overflow).  The index is the argmin over the table of the
    positive gaps to the exponent (a subnormal's is 1), the first on ties
    (a strict < keeps the earlier entry, as jnp.argmin does); a value whose
    exponent no entry exceeds overflows."""
    w = 15 - ei + 16
    e_eff = torch.clamp(torch.arange(256, dtype=torch.int32,
                                     device=table.device), min=1)
    big = 1 << 20
    best = torch.full_like(e_eff, big)
    exp_idx = torch.zeros_like(e_eff)
    for j in range(table.shape[0]):
        d = table[j] - e_eff
        d = torch.where(d > 0, d, big)
        upd = d < best
        best = torch.where(upd, d, best)
        exp_idx = torch.where(upd, j, exp_idx)
    overflow = best >= big
    lsh = w - _F32_FRAC - torch.where(overflow, 1, best)
    return exp_idx, lsh, overflow


def _pack32_flat(sign, e_b, frac, table, ei: int):
    m_h = 15 - ei
    w = m_h + 16
    nonzero = (e_b != 0) | (frac != 0)
    m24 = torch.where(e_b != 0, (1 << _F32_FRAC) | frac, frac).to(torch.int64)
    # The table index and shift depend on the exponent alone: looked up.
    plan_idx, plan_lsh, plan_overflow = _exponent_plan(table, ei)
    e = e_b.to(torch.int64)
    exp_idx, lsh, overflow = plan_idx[e], plan_lsh[e], plan_overflow[e]
    # Right shifts round to nearest-even on the discarded bits; a carry
    # past W saturates (the reference's ``pack32_jnp``).
    rsh = torch.clamp(-lsh, 0, 31).to(torch.int64)
    floor_ = m24 >> rsh
    rem = m24 & ((1 << rsh) - 1)
    half = (1 << rsh) >> 1
    round_up = (rsh > 0) & ((rem > half) | ((rem == half)
                                            & ((floor_ & 1) == 1)))
    rounded = torch.clamp(floor_ + round_up.to(torch.int64), max=(1 << w) - 1)
    m = torch.where(lsh >= 0, m24 << torch.clamp(lsh, 0, 31).to(torch.int64),
                    rounded)
    m = torch.where(nonzero, m, 0)
    sat = overflow & nonzero
    m = torch.where(sat, (1 << w) - 1, m)
    exp_idx = torch.where(sat, torch.argmax(table).to(torch.int32), exp_idx)
    head = ((sign.to(torch.int64) << 15) | (exp_idx.to(torch.int64) << m_h)
            | (m >> 16))
    return head.to(torch.int32).to(torch.uint16), \
        (m & 0xFFFF).to(torch.int32).to(torch.uint16)


def pack32_jnp(vals: torch.Tensor, table: torch.Tensor, k: int):
    """f32 -> ``(head u16, tail1 u16)`` against a (k,) table, on the
    device of ``vals``; bitwise the reference's ``pack32_jnp``.

    W = M_H + 16: tags 1 (head) and 2 (head + tail1); tail2 is zero for
    f32 sources.  Elementwise given the table, so it runs in chunks.
    """
    ei = _ei_bit(k)
    flat = vals.to(torch.float32).reshape(-1)
    tbl = table.to(torch.int32).to(flat.device)
    head = torch.empty(flat.shape, dtype=torch.uint16, device=flat.device)
    tail1 = torch.empty_like(head)
    for lo in range(0, flat.numel(), _PACK32_CHUNK):
        sign, e_b, frac = _f32_fields(flat[lo:lo + _PACK32_CHUNK])
        head[lo:lo + _PACK32_CHUNK], tail1[lo:lo + _PACK32_CHUNK] = \
            _pack32_flat(sign, e_b, frac, tbl, ei)
    return head.reshape(vals.shape), tail1.reshape(vals.shape)


def pack32(vals, k: int = 8, table=None, device="cuda") -> GSEPacked:
    """f32-source pack into a ``GSEPacked`` (tags 1/2 only; ``tail2`` is
    a zero-length leaf, as in the reference).  ``vals`` (a tensor or an
    array) is moved to ``device`` first."""
    x = torch.as_tensor(np.asarray(vals, np.float32) if not isinstance(
        vals, torch.Tensor) else vals, dtype=torch.float32).to(device)
    if table is None:
        table = extract_shared_exponents_jnp(x, k)
    table = torch.as_tensor(table).to(torch.int32).to(device)
    head, tail1 = pack32_jnp(x, table, k)
    return GSEPacked(table=table, head=head, tail1=tail1,
                     tail2=torch.zeros((0,), dtype=torch.uint32,
                                       device=device),
                     ei_bit=_ei_bit(k), frac_bits=_F32_FRAC)


def decode32_jnp(table, head, tail1, k: int, tag: int = 1,
                 dtype=torch.float32) -> torch.Tensor:
    """Decode of an f32-source pack (tags 1 and 2)."""
    if tag not in (1, 2):
        raise ValueError("f32-source packs support tags 1 and 2 only")
    zeros = torch.zeros(head.shape, dtype=torch.uint32, device=head.device)
    return _decode_jnp(table, head, tail1, zeros, _ei_bit(k), _F32_FRAC, tag,
                       dtype)


# ---------------------------------------------------------------------------
# Fake-quant (straight-through) for stepped-precision training
# ---------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):
    """decode32(pack32(x)) forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, k, tag):
        table = extract_shared_exponents_jnp(x, k)
        head, tail1 = pack32_jnp(x, table, k)
        return decode32_jnp(table, head, tail1, k, tag,
                            torch.float32).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gse_fake_quant(x: torch.Tensor, k: int = 8, tag: int = 1) -> torch.Tensor:
    """``decode(pack(x))`` with an identity gradient (the straight-through
    estimator): the reference's ``gse_fake_quant``, the forward bitwise
    its ``decode32_jnp(pack32_jnp(x))`` at ``tag`` (1 or 2), on x's
    device."""
    return _FakeQuant.apply(x, k, tag)
