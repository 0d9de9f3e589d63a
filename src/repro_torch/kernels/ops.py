"""Public wrappers around the SpMV and SpMM kernels: ELL packing, the pack
cache and the tag-specialized dispatch.

Port of ``repro/kernels/ops.py``: ``_cached_pack`` (:72),
``ell_pack_gsecsr`` (:172), ``spmv_kernel_for`` (:349),
``spmm_kernel_for`` (:387), ``gse_spmm_ell`` (:427) and
``gse_spmv_ell`` (:660).  The reference pads rows to its (8, 128) grid
block; the CUDA kernel takes any row count, so only the lane width (128,
the reference's default plan) is padded.  ``PACK_STATS`` is a plain dict
until the metrics registry is ported.
"""
from __future__ import annotations

import functools
import zlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.precision_table import TAG_BITS_USED
from repro_torch.kernels import ref
from repro_torch.kernels.gse_spmm import gse_spmm_ell_f32
from repro_torch.kernels.gse_spmv import gse_spmv_ell_f32
from repro_torch.sparse.csr import GSECSR, scatter_rows

__all__ = ["gse_spmv_ell", "gse_spmm_ell", "ell_pack_gsecsr",
           "spmv_kernel_for", "spmm_kernel_for", "PACK_STATS",
           "PACK_CACHE_MAX", "LANE"]

# Operand-pack cache accounting: ``hits``/``misses`` let callers assert
# that repeated solves re-pack nothing; ``evictions`` counts LRU drops and
# ``corrupt`` counts checksum-mismatch detect-and-repack events.
PACK_STATS = {"hits": 0, "misses": 0, "evictions": 0, "corrupt": 0}

# Per-operator-instance LRU bound on cached packed layouts.
PACK_CACHE_MAX = 8

# ELL row width alignment (the reference's default launch plan lane).
LANE = 128


def _leaves(entry):
    if isinstance(entry, (tuple, list)):
        for e in entry:
            yield from _leaves(e)
    else:
        yield entry


def _entry_checksum(entry) -> int:
    """CRC32 over every array leaf of a packed-operand entry, computed at
    build time and re-verified on every cache hit so a silently corrupted
    pack is rebuilt instead of feeding garbage segments to every solve."""
    ck = 0
    for leaf in _leaves(entry):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        ck = zlib.crc32(np.ascontiguousarray(leaf).tobytes(), ck)
    return ck


def _cached_pack(a, key, build):
    """Memoize a packed-operand build on the operator instance itself.

    Entries are ``(packed, crc32)`` in an LRU ``OrderedDict`` bounded by
    :data:`PACK_CACHE_MAX`; a hit re-verifies the checksum and a mismatch
    counts in ``PACK_STATS['corrupt']`` and triggers a repack.
    """
    cache = a.__dict__.setdefault("_pack_cache", OrderedDict())
    hit = key in cache
    if hit:
        entry, ck = cache[key]
        if _entry_checksum(entry) != ck:
            PACK_STATS["corrupt"] += 1
            hit = False  # detected corruption: fall through to repack
        else:
            PACK_STATS["hits"] += 1
            cache.move_to_end(key)
    if not hit:
        PACK_STATS["misses"] += 1
        entry = build()
        cache[key] = (entry, _entry_checksum(entry))
        cache.move_to_end(key)
        while len(cache) > PACK_CACHE_MAX:
            cache.popitem(last=False)
            PACK_STATS["evictions"] += 1
    return entry


_SEGMENT_DTYPES = (
    ("colpak", np.uint32),
    ("head", np.uint16),
    ("tail1", np.uint16),
    ("tail2", np.uint32),
)


def ell_pack_gsecsr(a: GSECSR, lane: int = LANE):
    """GSE-SEM CSR -> padded uniform-ELL segment tensors for the SpMV
    kernel, on ``a``'s device.

    Returns ``(colpak, head, tail1, tail2)``, each (rows, L) with L the
    longest row rounded up to ``lane``.  Padded slots hold colpak=0 and
    head=0 (mantissa 0 -> decodes to +0.0).  Memoized on the operator
    instance: repeat callers re-scatter nothing.
    """
    def build():
        rowptr = np.asarray(a.rowptr.cpu().numpy(), np.int64)
        L = int(max(1, np.diff(rowptr).max(initial=0)))
        L = ((L + lane - 1) // lane) * lane
        outs, _, _ = scatter_rows(
            rowptr, [(getattr(a, n), d) for n, d in _SEGMENT_DTYPES], L
        )
        return tuple(torch.from_numpy(o).to(a.device) for o in outs)

    return _cached_pack(a, ("ell", lane), build)


@functools.lru_cache(maxsize=None)
def spmv_kernel_for(tag: int, ei_bit: int):
    """Tag-specialized SpMV dispatch: the returned callable takes exactly
    the operands ``tag`` streams -- ``(colpak, head, x, scales)`` for tag
    1, ``+ tail1`` for tag 2, ``+ tail2`` for tag 3 -- so the tag-1/-2
    launches never touch the tail arrays."""
    if tag == 1:
        def call(colpak, head, x, scales):
            return gse_spmv_ell_f32(colpak, head, None, None, x, scales,
                                    ei_bit=ei_bit, tag=1)
    elif tag == 2:
        def call(colpak, head, tail1, x, scales):
            return gse_spmv_ell_f32(colpak, head, tail1, None, x, scales,
                                    ei_bit=ei_bit, tag=2)
    elif tag == 3:
        def call(colpak, head, tail1, tail2, x, scales):
            return gse_spmv_ell_f32(colpak, head, tail1, tail2, x, scales,
                                    ei_bit=ei_bit, tag=3)
    else:
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    return call


def gse_spmv_ell(ell, table, x: torch.Tensor, ei_bit: int,
                 tag: int = 1) -> torch.Tensor:
    """y = A @ x (f32) from ELL-packed GSE-SEM segments (kernel A32).

    Only the segment arrays ``tag`` reads are passed and streamed:
    ``GSECSR.bytes_touched(tag)`` gives the modeled per-call matrix bytes
    (6/8/12 per nnz for tags 1/2/3 vs 12 for FP64 CSR).
    """
    colpak, head, t1, t2 = ell
    scales = ref.make_scales(table, TAG_BITS_USED[tag])
    operands = [colpak, head]
    if tag >= 2:
        operands.append(t1)
    if tag == 3:
        operands.append(t2)
    return spmv_kernel_for(tag, ei_bit)(*operands, x, scales)


@functools.lru_cache(maxsize=None)
def spmm_kernel_for(tag: int, ei_bit: int):
    """Tag-specialized SpMM dispatch, the multi-RHS twin of
    :func:`spmv_kernel_for`: the returned callable takes exactly the
    operands ``tag`` streams -- ``(colpak, head, x, scales)`` for tag 1,
    ``+ tail1`` for tag 2, ``+ tail2`` for tag 3 -- with ``x`` an
    ``(nrhs, n)`` block, and a ``device=`` keyword (default ``"cuda"``).
    The segments are streamed once for all ``nrhs`` columns."""
    if tag == 1:
        def call(colpak, head, x, scales, *, device="cuda"):
            return gse_spmm_ell_f32(colpak, head, None, None, x, scales,
                                    ei_bit=ei_bit, tag=1, device=device)
    elif tag == 2:
        def call(colpak, head, tail1, x, scales, *, device="cuda"):
            return gse_spmm_ell_f32(colpak, head, tail1, None, x, scales,
                                    ei_bit=ei_bit, tag=2, device=device)
    elif tag == 3:
        def call(colpak, head, tail1, tail2, x, scales, *, device="cuda"):
            return gse_spmm_ell_f32(colpak, head, tail1, tail2, x, scales,
                                    ei_bit=ei_bit, tag=3, device=device)
    else:
        raise ValueError(f"tag must be 1, 2 or 3, got {tag}")
    return call


def gse_spmm_ell(ell, table, x: torch.Tensor, ei_bit: int, tag: int = 1, *,
                 device="cuda") -> torch.Tensor:
    """Y = A @ X (f32, ``(m, nrhs)``) from ELL-packed GSE-SEM segments
    (kernel C32), X a dense ``(n, nrhs)`` block as in the reference.

    X is passed to the kernel as ``(nrhs, n)``, columns contiguous, as the
    reference passes it to its Pallas kernel.  Only the segment arrays
    ``tag`` reads are passed and streamed, once for every column:
    ``iteration_stream_bytes(a, tag, nrhs=nrhs)`` is the modeled traffic.
    """
    if x.dim() != 2:
        raise ValueError(f"gse_spmm_ell wants a (n, nrhs) block; got "
                         f"{tuple(x.shape)}")
    colpak, head, t1, t2 = ell
    scales = ref.make_scales(table, TAG_BITS_USED[tag])
    operands = [colpak, head]
    if tag >= 2:
        operands.append(t1)
    if tag == 3:
        operands.append(t2)
    xt = x.to(torch.float32).t().contiguous()
    return spmm_kernel_for(tag, ei_bit)(*operands, xt, scales, device=device)
