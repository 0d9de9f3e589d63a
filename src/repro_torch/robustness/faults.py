"""Seeded fault injection for the GSE stack.

Port of ``repro/robustness/faults.py``.  The fault model is silent data
corruption where the format keeps bits:

  * the packed segment arrays of a :class:`~repro_torch.sparse.csr.GSECSR`
    (head / tail1 / tail2 / colpak) and its shared-exponent ``table``;
  * buffers about to cross an interconnect (:func:`make_wire_fault`, a
    hook for the halo exchange);
  * the memoized packed-operand entries of ``kernels.ops._cached_pack``
    (host or device memory of a long-lived service process).

Everything is seeded: ``numpy.random.default_rng(seed)`` picks the
(element, bit) pairs exactly as the reference does, and the corruption is
a plain XOR, so one seed flips the same bits in both packages.

:func:`make_tag_fault_operator` wraps an operator so it misbehaves only at
tags <= ``fail_tag`` (indefinite or NaN-producing) and is exact above: the
recoverable low-tag breakdown the guards and the tag escalation
(``robustness/guards.py``) must detect and solve through.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable

import numpy as np
import torch

from repro_torch.sparse.csr import GSECSR, GSESellC
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "GSECSR_SEGMENTS",
    "bitflip_array",
    "corrupt_gsecsr",
    "corrupt_pack_cache",
    "gsecsr_checksums",
    "verify_gsecsr",
    "make_wire_fault",
    "make_tag_fault_operator",
]

# GSECSR segments that injection may target (fixed-width integer storage,
# so a bit flip is well defined and silent by construction).
GSECSR_SEGMENTS = ("head", "tail1", "tail2", "colpak", "table")

# torch dtypes numpy has no counterpart for, moved to the host through a
# same-width integer view.
_HOST_VIEW = {torch.bfloat16: torch.int16}


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(_HOST_VIEW.get(t.dtype, t.dtype)).numpy()


def _flip_positions(numel: int, width: int, seed: int, nflips: int):
    """The seeded (element, bit) pairs, drawn as the reference draws
    them."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, max(numel, 1), size=nflips)
    bit = rng.integers(0, width, size=nflips)
    return zip(idx, bit)


def _flip_host(a: np.ndarray, seed: int, nflips: int) -> None:
    """XOR ``nflips`` seeded single-bit flips into ``a`` in place."""
    width = a.dtype.itemsize * 8
    udtype = np.dtype(f"uint{width}")
    view = a.view(udtype).reshape(-1)
    for i, b in _flip_positions(view.size, width, seed, nflips):
        view[i] ^= udtype.type(1) << udtype.type(b)


def bitflip_array(arr, seed: int, nflips: int = 1):
    """A copy of ``arr`` with ``nflips`` seeded single-bit flips.

    Any fixed-width dtype: a float is reinterpreted as the same-width
    unsigned integer, flipped and reinterpreted back (one storage bit
    inverted, no arithmetic).  Returns the type it was given: numpy in,
    numpy out; a tensor in, a tensor out on the same device.
    """
    tensor = isinstance(arr, torch.Tensor)
    a = np.array(_to_host(arr) if tensor else arr)  # a writable host copy
    if a.size and nflips > 0:
        _flip_host(a, seed, nflips)
    return torch.from_numpy(a).view(arr.dtype).to(arr.device) if tensor else a


def corrupt_gsecsr(a: GSECSR, target: str, seed: int,
                   nflips: int = 1) -> GSECSR:
    """A new ``GSECSR`` with seeded bit flips in one segment.

    ``target`` is one of :data:`GSECSR_SEGMENTS`; the original operand is
    untouched (a dataclass copy), so a test can solve with both.  A
    ``table`` flip is the high-leverage fault: one shared exponent scales
    a whole group of values.
    """
    if target not in GSECSR_SEGMENTS:
        raise ValueError(
            f"target must be one of {GSECSR_SEGMENTS}, got {target!r}")
    return dataclasses.replace(
        a, **{target: bitflip_array(getattr(a, target), seed, nflips)}
    )


def gsecsr_checksums(a: GSECSR) -> dict:
    """CRC32 per packed segment, over a host copy of each: the reference
    for :func:`verify_gsecsr` (and equal to the reference package's on the
    same pack)."""
    out = {}
    for name in GSECSR_SEGMENTS:
        seg = np.ascontiguousarray(_to_host(getattr(a, name)))
        out[name] = zlib.crc32(seg.tobytes())
    return out


def verify_gsecsr(a: GSECSR, ref: dict) -> list:
    """Names of the segments whose CRC32 no longer matches ``ref`` (empty:
    intact)."""
    now = gsecsr_checksums(a)
    return [name for name in ref if now.get(name) != ref[name]]


def corrupt_pack_cache(a, key=None, seed: int = 0, nflips: int = 1) -> bool:
    """Silently corrupt a memoized ``_cached_pack`` entry on operand ``a``.

    Swaps a bit-flipped copy of one of the entry's tensors into the cache
    while keeping the stored checksum: memory corruption after the pack
    was built.  The next ``_cached_pack`` hit must detect the mismatch and
    repack (``PACK_STATS['corrupt']``).  Entries are trees of tensors (the
    ELL pack, the row lengths); the leaf is chosen as the reference
    chooses it.  Returns True if an entry was corrupted (False: the cache
    is empty or the key absent).
    """
    cache = a.__dict__.get("_pack_cache")
    if not cache:
        return False
    if key is None:
        key = next(iter(cache))
    if key not in cache:
        return False
    entry, ck = cache[key]
    leaves = tree_leaves(entry)
    if not leaves:
        return False
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError(f"pack-cache entry {key!r} is not a tree of tensors")
    rng = np.random.default_rng(seed)
    which = int(rng.integers(0, len(leaves)))
    pos = iter(range(len(leaves)))

    def swap(t):
        return bitflip_array(t, seed + 1, nflips) if next(pos) == which else t

    cache[key] = (tree_map(swap, entry), ck)
    return True


_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def make_wire_fault(target: str, seed: int, nflips: int = 1) -> Callable:
    """A wire-fault hook ``hook(name, arr)`` for a halo exchange.

    ``target`` names the payload to corrupt (``"head"``, ``"tail1"``,
    ``"table"``, or ``"raw"`` for the exact-wire f64 buffer).  The hook
    receives each buffer about to cross the wire (after the sender's
    checksum) and XORs the seeded (element, bit) positions into the
    matching one through its unsigned view, on the buffer's device; the
    positions are the reference hook's for the same seed.  Installing it
    waits for the port's distributed wire.
    """
    def hook(name: str, arr: torch.Tensor) -> torch.Tensor:
        if name != target:
            return arr
        width = arr.element_size() * 8
        flat = arr.reshape(-1).view(_SIGNED[arr.element_size()]).clone()
        udtype = np.dtype(f"uint{width}")
        for i, b in _flip_positions(flat.numel(), width, seed, nflips):
            mask = (np.array(1, udtype) << np.array(b, udtype)).view(
                np.dtype(f"int{width}"))
            flat[int(i)] ^= int(mask)
        return flat.view(arr.dtype).reshape(arr.shape)

    return hook


def make_tag_fault_operator(a, mode: str = "indefinite",
                            fail_tag: int = 1) -> Callable:
    """Wrap operator ``a`` so it misbehaves at tags <= ``fail_tag`` only.

    Modes (exact at tags above ``fail_tag``):

      * ``"indefinite"``: the product negated, so ``p.Ap`` turns negative
        on the first iteration, the textbook CG breakdown;
      * ``"nan"``: the product times NaN, poisoning the residual
        recurrence at once.

    ``a`` is a ``GSECSR``/``GSESellC`` (routed through the solvers'
    ``_gsecsr_operator``) or an ``apply(v, tag)`` callable.  The result is
    a tagged operator, so it drives the generic solver paths.
    """
    if mode not in ("indefinite", "nan"):
        raise ValueError(f"mode must be 'indefinite' or 'nan', got {mode!r}")
    if isinstance(a, (GSECSR, GSESellC)):
        from repro_torch.solvers.cg import _gsecsr_operator
        base = _gsecsr_operator(a)
    else:
        base = a

    def apply(v, tag):
        y = base(v, tag)
        bad = -y if mode == "indefinite" else y * float("nan")
        return torch.where(torch.as_tensor(tag) <= fail_tag, bad, y)

    return apply
