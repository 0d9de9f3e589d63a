#!/usr/bin/env python3
"""Time kernels A32 and C32 (the f32 ELL SpMV and SpMM) of one checkout.

    python3 tools/time_ell_kernels.py [--tree DIR] [--lanes 4,8,16,32]
                                      [--check] [--probe] [--reps 10]
                                      [--inner 10]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels into ``DIR/build/repro_torch``, packs chip_smoke.py's uniform
operator (``diag_rescale(random_spd(2^20, 8, seed=21), 8, 21)`` in
GSE-SEM CSR, then its 128-lane ELL pack) and prints, as its last line,
one JSON object with the card's name and the CUDA-event time of A32
(``gse_spmv_ell_f32``) and of C32 (``gse_spmm_ell_f32`` at nrhs 4) at
tags 1-3: the minimum over ``--reps`` of the mean of ``--inner`` calls.
It takes the wrappers' contract from the checkout: with a ``row_len``
keyword, the rows' real slot counts and an ``(n, nrhs)`` X; without one
(the contract before the kernels read only real slots), an ``(nrhs, n)``
X.  So one card can time an earlier tree (a ``git archive`` unpacked in a
directory that .gitignore lists) beside this one, as ``chip_smoke.py
--earlier DIR`` does for phase 10's ``earlier_ms``.  On a tree with real
slots, ``--lanes`` times each listed group size (default: the wrappers'
default), and ``--check`` first holds every kernel call to its plain
version bitwise (C32 column by column) and raises on a mismatch.
``--probe`` also times each run on a copy of the ELL whose column indices
are cut to their low 10 bits (the same segments, row lengths and scale
indices, x gathered from 4 KB that stay in L1), so the difference is
what the x gathers cost; its results are not the operator's.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import itertools
import json
import subprocess
import sys
from pathlib import Path

N_FULL = 1 << 20
NRHS = 4


def cuda_ms(fn, reps: int, inner: int) -> float:
    """Minimum over ``reps`` of the CUDA-event time of ``inner`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def _tails(ell, tag: int):
    return (ell[2] if tag >= 2 else None, ell[3] if tag == 3 else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--lanes", default=None,
                    help="comma-separated group sizes (a tree with real "
                         "slots only)")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--inner", type=int, default=10)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_ell_kernels: no CUDA device")
    from repro_torch.core.precision_table import TAG_BITS_USED
    from repro_torch.kernels import gse_spmm as C, gse_spmv as K, ops, ref
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    dev = torch.device("cuda")
    g = pack_csr(G.diag_rescale(G.random_spd(N_FULL, nnz_per_row=8, seed=21,
                                             device=dev), 8.0, 21))
    ell = ops.ell_pack_gsecsr(g)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=N_FULL).astype(np.float32)).to(dev)
    xc = torch.from_numpy(rng.normal(size=(NRHS, N_FULL)).astype(
        np.float32)).to(dev)
    real_slots = "row_len" in inspect.signature(K.gse_spmv_ell_f32).parameters
    xs = xc.t().contiguous() if real_slots else xc
    if real_slots:
        row_len = ops.ell_row_lengths(g)
        lanes = ([int(v) for v in args.lanes.split(",")] if args.lanes
                 else [K.ELL_LANES_DEFAULT])
        runs = {f"lanes{v}": dict(row_len=row_len, lanes=v) for v in lanes}
    else:
        if args.lanes:
            raise SystemExit("--lanes needs a tree whose kernels read only "
                             "real slots")
        runs = {"ms": {}}
    out = {"tree": str(tree), "real_slots": real_slots,
           "ell_width": ell[0].shape[1], "nrhs": NRHS,
           "gse_spmv_ell_f32": {}, "gse_spmm_ell_f32": {}}
    mats = {"": ell}
    if args.probe:
        mask = (1 << (32 - g.ei_bit)) - 1
        cp = ell[0].to(torch.int64)
        local = ((cp & ~mask) | (cp & mask & 1023)).to(torch.uint32)
        mats["local_x."] = (local,) + tuple(ell[1:])
    for t in (1, 2, 3):
        scales = ref.make_scales(g.table, TAG_BITS_USED[t])
        if args.check:
            a32 = K.gse_spmv_ell_f32_plain(*ell[:2], *_tails(ell, t), x,
                                           scales, ei_bit=g.ei_bit, tag=t)
            c32 = C.gse_spmm_ell_f32_plain(*ell[:2], *_tails(ell, t), xs,
                                           scales, ei_bit=g.ei_bit, tag=t)
        for (prefix, mat), (run, kw) in itertools.product(mats.items(),
                                                          runs.items()):
            def spmv():
                return K.gse_spmv_ell_f32(*mat[:2], *_tails(mat, t), x,
                                          scales, ei_bit=g.ei_bit, tag=t,
                                          **kw)

            def spmm():
                return C.gse_spmm_ell_f32(*mat[:2], *_tails(mat, t), xs,
                                          scales, ei_bit=g.ei_bit, tag=t,
                                          **kw)

            if args.check and not prefix:
                same = [torch.equal(spmv().view(torch.int32),
                                    a32.view(torch.int32))]
                got = spmm()
                same += [torch.equal(got[:, j].view(torch.int32),
                                     c32[:, j].view(torch.int32))
                         for j in range(NRHS)]
                if not all(same):
                    raise AssertionError(f"tag {t} {run}: A32, C32 columns "
                                         f"bitwise their plain versions: "
                                         f"{same}")
            for name, fn in (("gse_spmv_ell_f32", spmv),
                             ("gse_spmm_ell_f32", spmm)):
                out[name].setdefault(prefix + run, {})[t] = cuda_ms(
                    fn, args.reps, args.inner)
    out["checked_bitwise"] = args.check
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out["card"] = (smi.stdout.strip().splitlines() or [""])[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
