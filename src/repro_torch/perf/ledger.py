"""Per-kernel FLOP and byte ledger, checked against the kernels' real
arguments.

Port of ``repro/perf/ledger.py``.  One :class:`KernelLedger` per (kernel,
tag, layout, nrhs) records what one SpMV/SpMM application should move and
compute, from the tag-specialized operand lists the kernels stream:

  * ``flops``         -- useful work, ``2 * nnz * nrhs`` (padded slots
                         are not credited);
  * ``matrix_bytes``  -- the slot-honest matrix-stream model
                         (``GSECSR.bytes_touched`` / ``ELLLayout`` /
                         ``GSESellC.bytes_touched``);
  * ``vector_bytes``  -- x read and y write per column;
  * ``fp64_bytes``    -- what an fp64 CSR SpMV streams for the same math
                         (12 B/nnz + rowptr): divided by a time, the
                         effective bandwidth, the fair cross-format axis.

The reference cross-checks its byte model against the ``pallas_call``
operands of the jaxpr and the compiled HLO's parameters.  The port has
neither; it checks the model against the integer tensors ``kernels.ops``
really hands to the kernel functions of A32, C32, B32 and C′32:
:func:`launch_segment_bytes` (the port's ``pallas_segment_bytes``) and
:func:`launch_index_bytes` predict them, and :func:`recorded_launch_bytes`
(the port's ``jaxpr_pallas_int_bytes`` and ``hlo_segment_bytes``) records
them from a call.
"""
from __future__ import annotations

import dataclasses
import inspect

import torch

from repro_torch.core.precision_table import COLIDX_BYTES, SLOT_BYTES
from repro_torch.perf.plan import DEFAULT_BLOCKS
from repro_torch.sparse.csr import (
    CSR,
    GSECSR,
    GSESellC,
    ELLLayout,
    ell_layout,
    vector_stream_bytes,
)

__all__ = ["KernelLedger", "spmv_ledger", "launch_segment_bytes",
           "launch_index_bytes", "recorded_launch_bytes", "achieved",
           "SEGMENTS", "RECORDED_KERNELS"]

# The packed segment arguments of every f32 kernel function.
SEGMENTS = ("colpak", "head", "tail1", "tail2")
# The kernel functions of kernels.ops whose arguments are recorded.
RECORDED_KERNELS = ("gse_spmv_ell_f32", "gse_spmm_ell_f32",
                    "gse_spmv_sell_f32", "gse_spmm_sell_f32")


@dataclasses.dataclass(frozen=True)
class KernelLedger:
    kernel: str          # "spmv_ell" / "spmm_sell" / "spmv_csr" / ...
    tag: object          # GSE tag 1/2/3, or a store dtype name for CSR
    layout: str          # "csr" / "ell" / "sell"
    nrhs: int
    nnz: int
    slots: int           # padded slots streamed (== nnz for raw CSR)
    flops: int           # useful FLOPs: 2 * nnz * nrhs
    matrix_bytes: int    # modeled matrix-stream bytes (slot-honest)
    vector_bytes: int    # per-column x/y traffic * nrhs
    fp64_bytes: int      # fp64-CSR-equivalent bytes for the same math

    @property
    def bytes(self) -> int:
        return self.matrix_bytes + self.vector_bytes


def _fp64_equiv(a) -> int:
    # fp64 CSR matrix streams: 8 B value + 4 B colidx per nnz + rowptr.
    m = int(a.shape[0])
    return int(a.nnz) * (8 + COLIDX_BYTES) + (m + 1) * 4


def spmv_ledger(a, tag=None, layout=None, nrhs: int = 1,
                vec_dtype=torch.float64, store_dtype=None,
                jnp_path: bool = False) -> KernelLedger:
    """Ledger for one SpMV/SpMM application of ``a``.

    ``a`` is a ``GSECSR`` (give ``tag``) or a plain ``CSR`` (give
    ``store_dtype``, a torch dtype).  ``layout`` selects the byte account:
    ``None`` (the CSR nnz model), ``"ell"`` (uniform lane-padded), or an
    ``ELLLayout``/``GSESellC`` for the exact pack in hand.
    ``jnp_path=True`` charges the reference's jnp decode's extra
    ``row_ids`` stream (nnz * 4 B; the kernels do not pay it).
    """
    if nrhs < 1:
        raise ValueError(f"nrhs must be >= 1, got {nrhs}")
    slots = int(a.nnz)
    if isinstance(a, GSESellC) or isinstance(layout, GSESellC):
        lay = a if isinstance(a, GSESellC) else layout
        mat = lay.bytes_touched(tag)
        slots = lay.slots
        layout_name = "sell"
    elif isinstance(layout, ELLLayout):
        mat = layout.bytes_touched(tag)
        slots = layout.slots
        layout_name = "ell"
    elif layout == "ell":
        lay = ell_layout(a)
        mat = lay.bytes_touched(tag)
        slots = lay.slots
        layout_name = "ell"
    elif layout in (None, "csr"):
        if isinstance(a, CSR) or store_dtype is not None:
            dt = store_dtype or torch.float64
            mat = a.bytes_touched(dt)
            tag = str(dt).removeprefix("torch.")
        else:
            mat = a.bytes_touched(tag)
        layout_name = "csr"
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if jnp_path:
        mat += int(a.nnz) * 4  # row_ids stream of the segment-sum decode
    kernel = ("spmv" if nrhs == 1 else "spmm") + "_" + layout_name
    vec = vector_stream_bytes(a, dtype=vec_dtype)
    return KernelLedger(
        kernel=kernel, tag=tag, layout=layout_name, nrhs=nrhs,
        nnz=int(a.nnz), slots=slots, flops=2 * int(a.nnz) * nrhs,
        matrix_bytes=int(mat), vector_bytes=nrhs * vec,
        fp64_bytes=_fp64_equiv(a) + nrhs * vec,
    )


def _pad(x: int, b: int) -> int:
    return -(-x // b) * b


def launch_segment_bytes(src, tag: int, blocks=DEFAULT_BLOCKS,
                         lane: int = 128) -> int:
    """The packed-segment bytes ``kernels.ops`` hands to one launch of A32
    or C32 (a ``GSECSR``: its ``ell_pack_gsecsr`` arrays at ``lane``) or
    of B32 or C′32 (a ``GSESellC``: the flat bucket segments), at ``tag``.

    The port's ``pallas_segment_bytes``.  ``blocks`` is checked as the
    reference checks it (a SELL pack it cannot tile raises ValueError) and
    pads nothing: the kernels take any row count, so the ELL figure is the
    reference's less its padding of the rows to BM -- equal to it when the
    row count is a multiple of BM, and always on a SELL pack.
    """
    bm, bl = blocks
    if isinstance(src, GSESellC):
        if src.c % bm != 0 or any(w % bl != 0 for w in src.widths):
            raise ValueError(f"blocks {blocks} incompatible with SELL pack "
                             f"(c={src.c}, widths={src.widths})")
        return src.slots * SLOT_BYTES[tag]
    per_row = (src.rowptr[1:] - src.rowptr[:-1]).max() if src.shape[0] \
        else 0
    width = _pad(int(max(1, int(per_row))), lane)
    return int(src.shape[0]) * width * SLOT_BYTES[tag]


def launch_index_bytes(src) -> int:
    """The other integer arguments of that launch: A32 and C32 take each
    row's real slot count (``row_len``, int32 per row); B32 and C′32 take
    the bucket table (int64 ``(n_buckets, 3)``) and ``perm`` (int32 per
    bucket row)."""
    if isinstance(src, GSESellC):
        return (int(src.bucket_table.numel()) * 8
                + int(src.perm.shape[0]) * 4)
    return int(src.shape[0]) * 4


_RECORDERS = {}
_ACTIVE = []


def _recorder(name: str):
    """A stand-in for the kernel function ``name`` that notes its integer
    tensor arguments while a recording is active, then calls it."""
    if name not in _RECORDERS:
        from repro_torch.kernels import ops

        real = getattr(ops, name)
        sig = inspect.signature(real)

        def record(*args, **kw):
            if _ACTIVE:
                bound = sig.bind(*args, **kw).arguments
                _ACTIVE[-1].append({
                    arg: v.nbytes for arg, v in bound.items()
                    if isinstance(v, torch.Tensor)
                    and not v.dtype.is_floating_point})
            return real(*args, **kw)

        _RECORDERS[name] = record
    return _RECORDERS[name]


def recorded_launch_bytes(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` with the kernel functions of A32, C32,
    B32 and C′32 in ``kernels.ops`` recording their integer tensor
    arguments; returns ``{"segments": ..., "index": ..., "launches": ...,
    "out": ...}``, the segment bytes (colpak, head, tails) and the other
    integer bytes summed over every launch.  The port's
    ``jaxpr_pallas_int_bytes`` and ``hlo_segment_bytes``: what ops really
    hands to the kernels, the launches included."""
    from repro_torch.kernels import ops

    calls = []
    saved = {name: getattr(ops, name) for name in RECORDED_KERNELS}
    for name in RECORDED_KERNELS:
        setattr(ops, name, _recorder(name))
    _ACTIVE.append(calls)
    try:
        out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
        for name, real in saved.items():
            setattr(ops, name, real)
    return {
        "segments": sum(n for c in calls for a, n in c.items()
                        if a in SEGMENTS),
        "index": sum(n for c in calls for a, n in c.items()
                     if a not in SEGMENTS),
        "launches": len(calls),
        "out": out,
    }


def achieved(ledger: KernelLedger, seconds: float, roof=None) -> dict:
    """Rates for one measured kernel, priced by its ledger.

    ``achieved_gbps`` divides the physical modeled bytes by the time;
    ``effective_gbps`` the fp64-equivalent bytes.  With a
    ``roofline.host_roofline`` dict, ``roofline_fraction`` is attainable
    time over measured time, attainable = max(bytes / BW, flops / peak):
    1.0 runs at the device's probed roof, above 1 the working set sat in
    cache."""
    out = {
        "flops": ledger.flops,
        "bytes": ledger.bytes,
        "us": seconds * 1e6,
        "achieved_gbps": ledger.bytes / seconds / 1e9,
        "achieved_gflops": ledger.flops / seconds / 1e9,
        "effective_gbps": ledger.fp64_bytes / seconds / 1e9,
    }
    if roof is not None:
        from repro_torch.perf import roofline as _r

        out["roofline_fraction"] = _r.fraction(
            ledger.flops, ledger.bytes, seconds, roof)
    return out
