#!/usr/bin/env python3
"""Device time and host time of kernels E and F at qwen3_4b's serving shapes.

    python3 tools/time_lm_kernels.py [--gse-tag 2] [--batch 4] [--reps 5]

``chip_smoke.py`` phase 10 times back-to-back calls with CUDA events, so a
kernel shorter than its wrapper's host time reads as the host time.  This
script separates the two, on the card:

* ``graph_ms``: the kernel alone -- 20 calls captured in a CUDA graph and
  replayed, CUDA-event minimum over ``--reps`` replays, per call;
* ``event_ms``: back-to-back calls, as phase 10 times them;
* ``host_us``: the wrapper's host time per call (enqueueing 50 calls,
  host clock, without waiting for the card).

E (``gse_matmul_dense``) at M = ``--batch`` with bf16 x on every linear of
a decode step and the unembedding, on the model's own segments (weights
drawn on the card from a seed and packed by ``pack_linear_weight`` at
``--gse-tag``), beside ``torch.matmul`` on the decoded f32 weight (TF32
off); E's tiled body (``matmul_tc_kernel``, split TF32 on the tensor
cores) at prefill's M = ``PREFILL_ROWS`` (B 4 x S 512, as
``chip_smoke.py`` serves) on every linear of a layer, bf16 x,
beside the same ``torch.matmul``, with its bound on the TF32 tensor cores (495 TFLOP/s
times the two TF32 terms of a bf16 x) and the FP32 bound (67 TFLOP/s); F
(``flash_attention_gqa``) in bf16 at B 4, H 32, KV 8, hd 128, causal, S = T
2048 and 512, beside scaled_dot_product_attention.  Prints one JSON object
(last line).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PREFILL_ROWS = 4 * 512  # M of prefill's linears: batch 4 x prompt 512


def _event_ms(fn, reps: int, inner: int = 10) -> float:
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


def _graph_ms(fn, reps: int, calls: int = 20) -> float:
    import torch

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()  # the wrappers' per-stream scratch exists before the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def _host_us(fn, calls: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def _times(fn, reps: int, host: bool = False) -> dict:
    out = {"graph_ms": _graph_ms(fn, reps), "event_ms": _event_ms(fn, reps)}
    if host:
        out["host_us"] = _host_us(fn)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gse-tag", type=int, default=2, choices=(1, 2))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_lm_kernels: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.core.precision_table import TAG_VALUE_BYTES
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as F
    from repro_torch.kernels import gse_decode as D
    from repro_torch.kernels import gse_matmul as E
    from repro_torch.models.modules import pack_linear_weight, segment_read

    _build.build_all(("gse_dense", "flash_attn"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = dataclasses.replace(get_config("qwen3_4b"), gse_serve=True,
                              gse_tag=args.gse_tag)
    d, hd = cfg.d_model, cfg.hd
    q_n, kv_n = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shapes = {"wq": (d, q_n), "wk_wv": (d, kv_n), "wo": (q_n, d),
              "w_gate_w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d),
              "unembed": (d, cfg.padded_vocab)}
    out = {"gse_tag": args.gse_tag, "batch": args.batch, "e": {},
           "e_tiled": {}, "f": {}}
    for name, (kk, n) in shapes.items():
        vals = torch.randn((kk, n), generator=gen, device=dev) / math.sqrt(kk)
        w = pack_linear_weight(vals, cfg)
        del vals
        tag, ei, sc = segment_read(w, cfg)
        segs = (w["head"], w.get("tail1") if tag >= 2 else None, None, sc)
        x32 = torch.randn((args.batch, kk), generator=gen, device=dev)
        x = x32.to(torch.bfloat16)
        w32 = D.gse_decode_dense_plain(*segs, ei_bit=ei, tag=tag)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = E.gemv_plan(args.batch, kk, n, sms)
        out["e"][name] = {
            "shape": [args.batch, kk, n],
            "plan": dataclasses.asdict(plan),
            # Bytes: the segments, the table, x and y (as phase 10).
            "bound_ms": (kk * n * TAG_VALUE_BYTES[tag] + sc.numel() * 4
                         + args.batch * (kk * 2 + n * 4)) / 3.35e12 * 1e3,
            "kernel": _times(lambda: E.gse_matmul_dense(
                x, *segs, ei_bit=ei, tag=tag), args.reps, host=True),
            "library": _times(lambda: torch.matmul(x32, w32), args.reps,
                              host=True),
        }
        print(json.dumps({name: out["e"][name]}), flush=True)
        if name != "unembed":
            m = PREFILL_ROWS
            xp32 = torch.randn((m, kk), generator=gen, device=dev)
            xp = xp32.to(torch.bfloat16)
            ops = 2 * m * n * kk
            nbytes = (kk * n * TAG_VALUE_BYTES[tag] + sc.numel() * 4
                      + m * (kk * 2 + n * 4))
            out["e_tiled"][name] = {
                "shape": [m, kk, n],
                "bound_ms": max(E.tiled_terms(xp.dtype) * ops / 495e12,
                                nbytes / 3.35e12) * 1e3,
                "fp32_bound_ms": ops / 67e12 * 1e3,
                "kernel": _times(lambda: E.gse_matmul_dense(
                    xp, *segs, ei_bit=ei, tag=tag), args.reps, host=True),
                "library": _times(lambda: torch.matmul(xp32, w32),
                                  args.reps),
            }
            print(json.dumps({f"tiled_{name}": out["e_tiled"][name]}),
                  flush=True)
            del xp, xp32
        del w, w32
    for s in (2048, 512):
        q = torch.randn((4, s, 32, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((4, s, 8, 128), generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        ql = q.transpose(1, 2).contiguous()
        kl, vl = (t.repeat_interleave(4, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        out["f"][f"s{s}"] = {
            # The larger of q, k, v in and out over HBM and the causal
            # half of 4 S T hd per (batch, head) on the bf16 tensor cores.
            "bound_ms": max((q.numel() * 2 + k.numel() * 2) * 2 / 3.35e12,
                            4 * 4 * 32 * s * s * 128 / 2 / 989e12) * 1e3,
            "kernel": _times(lambda: F.flash_attention_gqa(
                q, k, v, causal=True), args.reps, host=True),
            "library": _times(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    ql, kl, vl, is_causal=True), args.reps),
        }
        print(json.dumps({f"f_s{s}": out["f"][f"s{s}"]}), flush=True)
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
