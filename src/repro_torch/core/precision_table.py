"""Per-tag and per-dtype byte constants of the GSE-SEM encoding.

Port of ``repro/core/precision_table.py`` (kept as a copy: the port
imports nothing of ``repro``).  Every figure derives from one fact about
the encoding (paper Section III.C):

  tag 1 streams the u16 head            -> 2 value bytes / entry
  tag 2 streams head + u16 tail1        -> 4 value bytes / entry
  tag 3 streams head + tail1 + u32 tail2-> 8 value bytes / entry

and every CSR/ELL entry additionally streams a packed u32 column index
(``COLIDX_BYTES``), giving the paper's 6/8/12 B/nnz matrix-stream figures
(``SLOT_BYTES``).  The halo wire ships only the value segments, so
``WIRE_ENTRY_BYTES == TAG_VALUE_BYTES``.
"""
from __future__ import annotations

__all__ = [
    "TAG_VALUE_BYTES",
    "COLIDX_BYTES",
    "SLOT_BYTES",
    "WIRE_ENTRY_BYTES",
    "DTYPE_BYTES",
    "TAGS",
    "TAG_SEGMENTS",
    "SEGMENT_BYTES",
    "TAG_BITS_USED",
    "tag_operand_names",
]

# GSE tags in escalation order (head-only -> +tail1 -> +tail2).
TAGS = (1, 2, 3)

# Segment-array bytes per entry: u16 head, u16 tail1, u32 tail2.
SEGMENT_BYTES = {"head": 2, "tail1": 2, "tail2": 4}

# The tail segment arrays each tag streams beyond the always-read head.
TAG_SEGMENTS = {1: (), 2: ("tail1",), 3: ("tail1", "tail2")}

# Mantissa bits a decode at each tag consumes from the 15-bit head plus
# the 16-bit tail1 / 32-bit tail2 splices: 15 / 31 / 63.  The dense
# GSEPacked path offsets these by the expIdx bits stolen from the head
# (``m_h = 15 - ei_bit``); the sparse path keeps all 15 head bits because
# expIdx rides colpak instead.
TAG_BITS_USED = {t: 15 + sum(8 * SEGMENT_BYTES[s] for s in TAG_SEGMENTS[t])
                 for t in TAGS}

# Value-segment bytes one matrix entry (or one wire x-entry) costs at each
# tag -- head + the tails TAG_SEGMENTS says that tag reads: 2 / 4 / 8.
TAG_VALUE_BYTES = {
    t: SEGMENT_BYTES["head"] + sum(SEGMENT_BYTES[s] for s in TAG_SEGMENTS[t])
    for t in TAGS
}


def tag_operand_names(tag: int) -> tuple:
    """The operand list the tag-specialized SpMV kernels stream."""
    return ("scales", "colpak", "head") + TAG_SEGMENTS[tag] + ("x",)


# Every stored entry also streams one packed u32 column index (expIdx in
# the top EI_BIT bits, column in the rest).
COLIDX_BYTES = 4

# Matrix-stream bytes one padded slot (or one nnz) costs at each tag:
# the paper's 6/8/12 B/nnz format promise.
SLOT_BYTES = {t: TAG_VALUE_BYTES[t] + COLIDX_BYTES for t in TAGS}

# Bytes one boundary x-entry costs on the halo wire at each tag.
WIRE_ENTRY_BYTES = dict(TAG_VALUE_BYTES)

# Shape-string dtype widths used by byte estimators.
DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}
