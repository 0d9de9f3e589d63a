#!/usr/bin/env python3
"""Kernel F's forward with and without the backward's row statistic,
against an earlier tree's F: the same output bits and the same time.

    python3 tools/flash_lse_check.py --tree DIR [--reps 20]

DIR is an earlier checkout (e.g. ``git archive`` of the parent commit
unpacked under ``build/parent``) whose ``flash_attention_fwd`` takes no
``lse`` argument.  Its ``csrc/flash_attn.cu`` is compiled here with
``nvcc`` into ``build/earlier_flash/`` (the plain and the windowed
build); this tree's F is loaded through ``kernels/_build``.  At
qwen3_4b's prefill and training shapes (bf16, the tensor-core body; f32,
the FFMA body) and at a windowed shape, it runs the earlier F, this F
with ``lse`` null and this F writing ``lse``; requires the outputs
bitwise equal; and times the earlier F and this F (lse null) in turns,
earlier, this, this, earlier, then this F writing ``lse``, each launched
through its ``ctypes`` entry point (no wrapper's host time), with CUDA
events.  One JSON line per shape,
the card's name and power limit first.  Needs the card.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (label, b, s, h, kv, hd, window, dtype, body)
SHAPES = (("prefill", 4, 512, 32, 8, 128, 0, "bfloat16", "mma"),
          ("train", 4, 2048, 32, 8, 128, 0, "bfloat16", "mma"),
          ("train_f32", 4, 2048, 32, 8, 128, 0, "float32", "ffma"),
          ("window", 2, 2048, 8, 2, 64, 512, "bfloat16", "mma"))


def build_earlier(tree: Path, out: Path) -> dict:
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    src = tree / "src/repro_torch/kernels/csrc/flash_attn.cu"
    libs, procs = {}, []
    for name, flags in (("plain", ()), ("window", ("-DFLASH_WINDOW=1",))):
        lib = out / f"libflash_{name}.so"
        procs.append(subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS,
                                       *flags, "-o", str(lib), str(src)],
                                      stdout=subprocess.DEVNULL))
        libs[name] = lib
    for p in procs:
        if p.wait() != 0:
            raise SystemExit("nvcc failed on the earlier flash_attn.cu")
    bound = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).flash_attention_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, P, P, P, P, I, I, I, I, I, I, P, I, I,
                       ctypes.c_float, P]
        fn.restype = I
        bound[name] = fn
    return bound


def main() -> int:
    import torch

    from repro_torch.kernels import flash_attn as F

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_lse_check: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    earlier = build_earlier(opts.tree, ROOT / "build" / "earlier_flash")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def timed(fn) -> float:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(opts.reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / opts.reps

    for label, b, s, h, kv, hd, window, dt, body in SHAPES:
        dt = getattr(torch, dt)
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dt)
        k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dt)
        lib = earlier["window" if window or hd > 128 else "plain"]
        out_e = torch.empty_like(q)
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                          *v.stride()[:3])

        def run_earlier():
            rc = lib(F._BODY_ID[body], int(dt == torch.bfloat16),
                     q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out_e.data_ptr(), b, s, s, h, kv, hd, strides, 1,
                     window, F._scale(hd),
                     torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"earlier F failed: {rc}")

        out_k = torch.empty_like(q)
        lse_k = torch.empty(b, h, s, dtype=torch.float32, device=dev)
        this_fn = F._fn(window, hd)

        def run_this(lse_ptr=None):
            rc = this_fn(F._BODY_ID[body], int(dt == torch.bfloat16),
                         q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out_k.data_ptr(), b, s, s, h, kv, hd, strides, 1,
                         window, F._scale(hd), lse_ptr,
                         torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"this F failed: {rc}")

        run_earlier()
        with torch.no_grad():
            out_t = F.flash_attention_gqa(q, k, v, window=window, body=body)
        out_l, lse = F._launch_fwd(q, k, v, True, window, body, True)
        iv = torch.int16 if dt == torch.bfloat16 else torch.int32
        same = (torch.equal(out_e.view(iv), out_t.view(iv))
                and torch.equal(out_t.view(iv), out_l.view(iv)))
        run_this(lse_k.data_ptr())
        same = same and torch.equal(out_k.view(iv), out_t.view(iv))
        if not same:
            raise SystemExit(f"{label}: outputs differ")
        # Kernel against kernel: each launched through its ctypes entry
        # point, so the wrappers' host time stays out of the loop.
        t = [timed(run_earlier), timed(run_this), timed(run_this),
             timed(run_earlier)]
        t_lse = timed(lambda: run_this(lse_k.data_ptr()))
        print(json.dumps({"shape": label, "b": b, "s": s, "h": h, "kv": kv,
                          "hd": hd, "window": window, "dtype": str(dt),
                          "body": body, "bitwise_earlier": True,
                          "bitwise_with_lse": True,
                          "earlier_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                          "this_with_lse_ms": t_lse,
                          "lse_finite": bool(torch.isfinite(lse).all())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
