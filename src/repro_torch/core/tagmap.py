"""Per-group precision tag maps.

Port of ``repro/core/tagmap.py`` (kept as a copy: it is host numpy and
the port imports nothing of ``repro``): :class:`TagMap` gives one tag per
group of :data:`GROUP_SIZE` rows, and :func:`normalize_tags` maps the
public ``tags=`` axis to what the solvers dispatch on -- a uniform map
becomes its int tag, so its solve is bitwise the int-tag solve.

A non-uniform map is applied by zeroing the tail segments below each
entry's induced tag (the max of its row's and its column's group tags,
so a masked SPD operand stays exactly symmetric;
``kernels.ops.masked_for_tagmap``) and decoding at the map's max tag,
which is bitwise a per-entry decode at the entry's own tag.  The SELL
width buckets are the coarse unit of the f32 kernels B32 and C′32: each
bucket runs at the max tag of its entries, and a tag-1 bucket reads no
tail.

The map's :attr:`crc32` keys every derived cache entry (the masked pack,
the bucket tags), so a promoted map never hits a stale one.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["TagMap", "normalize_tags", "GROUP_SIZE"]

# Rows per tag group: the reference kernels' sublane row block and the
# SELL slice height (``kernels.ops.SELL_C``).
GROUP_SIZE = 8


class TagMap:
    """Per-row-group precision tags: ``tags[g]`` governs rows
    ``[g*group_size, (g+1)*group_size)``.

    Immutable by convention (promotion returns a NEW map so cache keys
    derived from :attr:`crc32` stay valid); tags are 1/2/3, the GSE
    escalation ladder.
    """

    __slots__ = ("tags", "group_size", "_crc")

    def __init__(self, tags, group_size: int = GROUP_SIZE):
        tags = np.ascontiguousarray(np.asarray(tags, np.uint8))
        if tags.ndim != 1 or tags.size == 0:
            raise ValueError(f"tags must be a non-empty 1-D array, "
                             f"got shape {tags.shape}")
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        bad = (tags < 1) | (tags > 3)
        if bad.any():
            raise ValueError(
                f"tags must be in {{1, 2, 3}}; offending groups "
                f"{np.nonzero(bad)[0][:8].tolist()}"
            )
        tags.setflags(write=False)
        object.__setattr__(self, "tags", tags)
        object.__setattr__(self, "group_size", int(group_size))
        object.__setattr__(self, "_crc", None)

    def __setattr__(self, name, value):  # immutability guard
        raise AttributeError("TagMap is immutable; build a new map "
                             "(with_tags / promoted)")

    # -- constructors ------------------------------------------------------

    @classmethod
    def uniform(cls, tag: int, n_groups: int,
                group_size: int = GROUP_SIZE) -> "TagMap":
        return cls(np.full(n_groups, tag, np.uint8), group_size)

    @classmethod
    def for_rows(cls, m: int, tag: int = 1,
                 group_size: int = GROUP_SIZE) -> "TagMap":
        """Uniform map covering ``m`` rows (``ceil(m/group_size)`` groups)."""
        return cls.uniform(tag, -(-m // group_size), group_size)

    # -- identity ----------------------------------------------------------

    @property
    def n_groups(self) -> int:
        return int(self.tags.size)

    @property
    def is_uniform(self) -> bool:
        return bool((self.tags == self.tags[0]).all())

    @property
    def min_tag(self) -> int:
        return int(self.tags.min())

    @property
    def max_tag(self) -> int:
        return int(self.tags.max())

    @property
    def crc32(self) -> int:
        """CRC32 of the tag bytes + group size: the cache-key token every
        derived artifact (masked pack, tuned plan) is keyed under."""
        if self._crc is None:
            ck = zlib.crc32(self.tags.tobytes(),
                            zlib.crc32(np.int64(self.group_size).tobytes()))
            object.__setattr__(self, "_crc", ck)
        return self._crc

    def __eq__(self, other):
        return (isinstance(other, TagMap)
                and self.group_size == other.group_size
                and np.array_equal(self.tags, other.tags))

    def __hash__(self):
        return hash((self.group_size, self.tags.tobytes()))

    def __repr__(self):
        counts = {int(t): int(n) for t, n in
                  zip(*np.unique(self.tags, return_counts=True))}
        return (f"TagMap(n_groups={self.n_groups}, "
                f"group_size={self.group_size}, counts={counts}, "
                f"crc=0x{self.crc32:08x})")

    # -- lookups -----------------------------------------------------------

    def row_tags(self, m: int) -> np.ndarray:
        """(m,) uint8 per-row tags (rows beyond the map keep the last
        group's tag so padded rows never index out of range)."""
        g = np.minimum(np.arange(m, dtype=np.int64) // self.group_size,
                       self.n_groups - 1)
        return self.tags[g]

    def entry_tags(self, row_ids, cols=None) -> np.ndarray:
        """(nnz,) uint8 per-entry tags from CSR-order row ids.

        With ``cols`` the induced tag is SYMMETRIC: the max of the row's
        and the column's group tags.  A row-only induced tag perturbs
        entry (i, j) differently from (j, i), so the masked operand of an
        SPD matrix would silently lose symmetry and CG's convergence
        contract with it; the symmetric max keeps ``A~ = A~^T`` exactly
        (and matches the physics -- by symmetry the large entries of a
        promoted row sit in its column too).  Matrix paths MUST pass
        ``cols``; the row-only form is for row-indexed streams (halo
        vector entries, the ELL row-block model).
        """
        g = np.minimum(np.asarray(row_ids, np.int64) // self.group_size,
                       self.n_groups - 1)
        et = self.tags[g]
        if cols is not None:
            gc = np.minimum(np.asarray(cols, np.int64) // self.group_size,
                            self.n_groups - 1)
            et = np.maximum(et, self.tags[gc])
        return et

    def tag_counts(self) -> dict:
        """``{tag: n_groups_at_tag}`` over the full ladder."""
        return {t: int((self.tags == t).sum()) for t in (1, 2, 3)}

    # -- derivation --------------------------------------------------------

    def with_tags(self, group_idx, tag) -> "TagMap":
        """New map with ``tags[group_idx] = tag`` (scalar or per-index)."""
        tags = self.tags.copy()
        tags[np.asarray(group_idx, np.int64)] = tag
        return TagMap(tags, self.group_size)

    def promoted(self, group_idx, step: int = 1) -> "TagMap":
        """New map with the given groups stepped up ``step`` rungs
        (clipped at tag 3 -- the exact path is the final rung)."""
        idx = np.asarray(group_idx, np.int64)
        tags = self.tags.copy()
        tags[idx] = np.minimum(tags[idx] + step, 3).astype(np.uint8)
        return TagMap(tags, self.group_size)

    def floored(self, floor: int) -> "TagMap":
        """New map with every group raised to AT LEAST ``floor`` -- the
        per-group recovery ladder's rung (only sub-floor groups promote;
        floor 3 is the uniform exact path).  Returns ``self`` when no
        group is below the floor (cache keys stay stable)."""
        if floor <= self.min_tag:
            return self
        return TagMap(np.maximum(self.tags, min(int(floor), 3)),
                      self.group_size)


def normalize_tags(tags, m: int | None = None,
                   group_size: int = GROUP_SIZE):
    """Normalize the public ``tags=`` axis to what the pipelines dispatch on.

    * ``None``          -> ``None`` (caller keeps its legacy ``init_tag``);
    * ``int`` 1/2/3     -> the same int (legacy fast path, today's jaxpr);
    * uniform ``TagMap``-> its plain int tag (SAME jaxpr -- the uniform
      fast path the bit-identity acceptance criterion pins);
    * non-uniform map   -> the ``TagMap`` itself (masked-operand path).

    ``m`` (row count) lets a bare int be requested as a map via
    ``TagMap.for_rows`` upstream; it is unused for the cases above but
    validates a map's coverage when provided.
    """
    if tags is None:
        return None
    if isinstance(tags, (int, np.integer)):
        t = int(tags)
        if t not in (1, 2, 3):
            raise ValueError(f"tag must be 1, 2 or 3, got {t}")
        return t
    if isinstance(tags, TagMap):
        if m is not None:
            need = -(-m // tags.group_size)
            if tags.n_groups != need:
                raise ValueError(
                    f"TagMap covers {tags.n_groups} groups of "
                    f"{tags.group_size} rows but the operator has {m} rows "
                    f"({need} groups)"
                )
        return tags.max_tag if tags.is_uniform else tags
    raise TypeError(f"tags must be an int tag, a TagMap, or None; "
                    f"got {type(tags).__name__}")
