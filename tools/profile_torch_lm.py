#!/usr/bin/env python3
"""Where the time of qwen3_4b's prefill and decode steps goes on the GPU.

    python3 tools/profile_torch_lm.py [--layers 36] [--gse-tag 2]
                                      [--batch 4] [--prompt 512] [--steps 8]

Builds ``chip_smoke.py`` phase 13's model: qwen3_4b at full width,
``--layers`` deep, ``gse_serve`` at ``--gse-tag`` (0: dense f32 weights),
bf16 compute, weights drawn and packed on the card.  It warms up with one
prefill and one decode step, then times and profiles one prefill of
``--prompt`` tokens for ``--batch`` requests and ``--steps`` greedy decode
steps:

* wall clock (host clock around synchronized work);
* ``torch.profiler``: device busy time, the device's idle share, kernel
  launches, and the shares of kernel E (``matmul_gemv_kernel``: the
  decode steps' GEMV body; ``matmul_tiled_kernel``: prefill) and kernel F
  (``flash_fwd_kernel``) in the device time, with the kernels that take
  the most of it.

Prints one JSON object (last line) and writes the Chrome traces to
``build/profile_torch_lm_{prefill,decode}.json``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _summary(prof, wall: float, per: int) -> dict:
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0 and str(evt.device_type).endswith("CUDA"):
            kernels.append((evt.key, dev_us, evt.count))
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)

    def share(*names):
        us = sum(k[1] for k in kernels if any(n in k[0] for n in names))
        return us / busy if busy else None

    return {
        "wall_ms": wall / per * 1e3,
        "device_busy_ms": busy / per / 1e3,
        "device_idle_share": 1.0 - (busy / 1e6) / wall,
        "kernel_launches": sum(k[2] for k in kernels) / per,
        "e_gemv_share": share("matmul_gemv_kernel"),
        "e_tiled_share": share("matmul_tiled_kernel"),
        "f_share": share("flash_fwd_kernel"),
        "top_kernels": [{"name": k[0][:80], "device_ms": k[1] / per / 1e3,
                         "count": k[2] / per} for k in kernels[:8]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--gse-tag", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_lm: needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import stepfns, transformer as T

    _build.build_all()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3_4b"), num_layers=args.layers,
                              gse_serve=bool(args.gse_tag),
                              gse_tag=args.gse_tag or 2)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    prefill = stepfns.make_prefill_step(cfg)
    total = args.prompt + args.steps + 1

    def run_prefill():
        state = T.decode_state_init(cfg, args.batch, total, device=dev)
        tok = prefill(params, toks, state=state).argmax(-1)
        torch.cuda.synchronize()
        return state, tok

    def run_decode(state, tok, steps):
        for i in range(steps):
            logits, state = T.decode_step(cfg, params, state, tok,
                                          args.prompt + i)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()

    state, tok = run_prefill()  # warm-up: builds, allocator, first launches
    run_decode(state, tok, 1)
    out = {"layers": args.layers, "gse_tag": args.gse_tag,
           "batch": args.batch, "prompt": args.prompt, "steps": args.steps}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    for phase in ("prefill", "decode"):
        state, tok = run_prefill()
        t0 = time.perf_counter()
        if phase == "prefill":
            state, tok = run_prefill()
        else:
            run_decode(state, tok, args.steps)
        wall = time.perf_counter() - t0
        state, tok = run_prefill()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if phase == "prefill":
                run_prefill()
            else:
                run_decode(state, tok, args.steps)
        prof.export_chrome_trace(str(out_dir / f"profile_torch_lm_{phase}"
                                             ".json"))
        out[phase] = _summary(prof, wall,
                              1 if phase == "prefill" else args.steps)
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
