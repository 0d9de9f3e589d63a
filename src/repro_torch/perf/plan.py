"""Kernel launch plans and the one resolution dispatcher.

Port of ``repro/perf/plan.py``.  Every SpMV and SpMM entry point of
``kernels.ops`` resolves its launch configuration through
:func:`resolve`, with the reference's precedence:

  1. an explicit ``blocks=`` argument;
  2. an explicit ``plan=KernelPlan(...)``;
  3. the tuned cache entry (``perf.tunecache``, keyed by ``shape-class |
     tag | layout | nrhs`` and by the operand's device);
  4. :data:`DEFAULT_PLAN`, which launches today's kernels bit for bit.

The plan's axes are the port's own kernels' axes:

* ``lanes`` -- the lanes one row of kernels A32 and C32 runs on (one of
  ``kernels.gse_spmv.ELL_LANES``; default ``ELL_LANES_DEFAULT``).  Every
  group size gives the same sum, so the choice moves time, never bits;
* ``lane`` -- the pack alignment of the ELL width and of the SELL slice
  widths (128);
* ``sell_c``, ``sell_sigma``, ``sell_bucket`` -- the SELL-C-sigma pack of
  kernels B32, C′32, B64 and C′64: slice height C (a multiple of 8), sort
  window sigma (None: a full sort), and ``"pow2"`` or ``"exact"`` width
  buckets.

``blocks`` is the reference's (BM, BL) Pallas grid tile.  The card's
kernels have no such grid and pad no rows, so ``blocks`` is accepted and
checked as the reference checks it (:meth:`KernelPlan.compatible_with_sell`
and ``kernels.ops``'s SELL check), recorded in the plan (and in a tuned
payload), and chooses no launch; the autotuner does not sweep it.

The shape class buckets operators by power-of-two row count and mean row
length, derived alike from a ``GSECSR``/``CSR`` and from a packed
``GSESellC``; :func:`shape_class`, :func:`tag_token` and :func:`plan_key`
give the reference's strings for the same operator.  The A64 and C64 row
plan's thresholds (``sparse.csr.A64_WARP_LEN``, ``A64_BLOCK_LEN``) stay
constants: the reference's planner dispatches only the f32 kernels, and
no plan reaches A64 or C64.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.gse_spmv import ELL_LANES_DEFAULT
from repro_torch.perf import tunecache

__all__ = ["KernelPlan", "DEFAULT_PLAN", "DEFAULT_BLOCKS", "resolve",
           "shape_class", "plan_key", "tag_token"]

DEFAULT_BLOCKS = (8, 128)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One kernel launch configuration.

    ``blocks``      -- the reference's (BM, BL) grid tile; checked, and
                       chooses no launch on the card;
    ``lanes``       -- lanes a row of A32 and C32 runs on;
    ``lane``        -- pack lane alignment (ELL width and SELL slice
                       widths round up to multiples of it);
    ``sell_c``      -- SELL slice height C (a multiple of 8);
    ``sell_sigma``  -- SELL sort window sigma (None: a full sort);
    ``sell_bucket`` -- SELL width buckets: ``"pow2"`` bins slice widths
                       into power-of-two lane multiples, ``"exact"``
                       keeps each distinct lane-aligned width;
    ``source``      -- provenance ("default" / "explicit" / "tuned"),
                       left out of equality, so a tuned plan that picks
                       the default configuration equals it.
    """

    blocks: tuple = DEFAULT_BLOCKS
    lanes: int = ELL_LANES_DEFAULT
    lane: int = 128
    sell_c: int = 8
    sell_sigma: int | None = None
    sell_bucket: str = "pow2"
    source: str = dataclasses.field(default="default", compare=False)

    def to_dict(self) -> dict:
        return {
            "blocks": list(self.blocks),
            "lanes": self.lanes,
            "lane": self.lane,
            "sell_c": self.sell_c,
            "sell_sigma": self.sell_sigma,
            "sell_bucket": self.sell_bucket,
        }

    @classmethod
    def from_dict(cls, d: dict, source: str = "tuned") -> "KernelPlan":
        return cls(
            blocks=tuple(d.get("blocks", DEFAULT_BLOCKS)),
            lanes=int(d.get("lanes", ELL_LANES_DEFAULT)),
            lane=int(d.get("lane", 128)),
            sell_c=int(d.get("sell_c", 8)),
            sell_sigma=(None if d.get("sell_sigma") is None
                        else int(d["sell_sigma"])),
            sell_bucket=str(d.get("sell_bucket", "pow2")),
            source=source,
        )

    def compatible_with_sell(self, sell) -> bool:
        """Can ``blocks`` tile an already-packed ``GSESellC``?  (The pack
        fixes C and the bucket widths; a tuned plan recorded for another
        pack falls back instead of raising.)"""
        bm, bl = self.blocks
        return (sell.c % bm == 0
                and all(w % bl == 0 for w in sell.widths))


DEFAULT_PLAN = KernelPlan()


def _p2(x: float) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def shape_class(obj) -> str:
    """Coarse matrix class: power-of-two rows x power-of-two mean row
    length, for any container with ``shape`` and ``nnz``."""
    rows = int(obj.shape[0])
    nnz = int(obj.nnz)
    mean_row = max(1, -(-nnz // max(rows, 1)))
    return f"m{_p2(rows)}r{_p2(mean_row)}"


def tag_token(tag) -> str:
    """Cache-key token of a precision axis value: ``tag{t}`` for an int,
    ``map{crc:08x}`` for a per-group ``TagMap`` (a promoted map never
    resolves a plan tuned for another map)."""
    crc = getattr(tag, "crc32", None)
    if crc is not None:
        return f"map{crc:08x}"
    return f"tag{tag}"


def plan_key(shape_cls: str, tag, layout: str, nrhs: int = 1) -> str:
    """Tune-cache key: ``shape-class | tag-token | layout | nrhs``."""
    return f"{shape_cls}|{tag_token(tag)}|{layout}|nrhs{int(nrhs)}"


def resolve(source=None, *, tag=None, layout: str | None = None,
            nrhs: int = 1, plan: KernelPlan | None = None,
            blocks=None) -> KernelPlan:
    """The one launch-plan dispatcher (precedence above).

    ``source`` is an optional operand (``GSECSR``/``GSESellC``/...) that
    enables the tuned-cache lookup, on its own device; without it (or
    without ``tag``/``layout``) resolution goes straight to the default
    plan.
    """
    if blocks is not None:
        base = plan if plan is not None else DEFAULT_PLAN
        return dataclasses.replace(base, blocks=tuple(blocks),
                                   source="explicit")
    if plan is not None:
        if plan.source == "default":
            plan = dataclasses.replace(plan, source="explicit")
        return plan
    if source is not None and tag is not None and layout is not None:
        payload = tunecache.lookup(
            plan_key(shape_class(source), tag, layout, nrhs),
            device=getattr(source, "device", "cuda"))
        if payload is not None:
            return KernelPlan.from_dict(payload.get("plan", payload),
                                        source="tuned")
    return DEFAULT_PLAN
