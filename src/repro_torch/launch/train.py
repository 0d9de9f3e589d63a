"""Training driver: port of ``repro/launch/train.py``.

  * resume-exact restart: batches are a pure function of the step
    (``data/pipeline.py``) and the loop resumes from the latest intact
    checkpoint (``checkpoint/ckpt.py``);
  * async double-buffered checkpoints with integrity hashes;
  * optional GSE-SEM gradient compression with error feedback
    (``--grad-compress``, ``distributed/compress.py``);
  * ``--simulate-failure-at N`` exits with 17 after step N, to prove the
    restart path end to end.

Usage (the smoke config on the CPU; on the card drop ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
      --smoke --steps 30 --ckpt-dir /tmp/ck --ckpt-every 10 --device cpu

The params come from a torch generator seeded 0 on the run's device (the
reference's JAX key 0 gives other numbers).  On the card the step is
deterministic: ``torch.use_deterministic_algorithms(True)`` (the
embedding's gradient, an indexed accumulate, then sorts instead of
adding atomically) with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (which that
mode requires of cuBLAS), and kernel F's backward uses no atomics, so a
resumed run's checkpoints are the bits of an uninterrupted run's.  The
mesh option of the reference (``--mesh``) is ROADMAP queue 1 item 17.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.compress import make_error_feedback_transform
from repro_torch.models import stepfns, transformer as T
from repro_torch.optim import AdamW

__all__ = ["build", "main", "parser", "deterministic"]


def deterministic(device) -> None:
    """Make the train step's bits independent of scheduling on ``device``:
    deterministic algorithms (and cuBLAS's fixed workspace, which they
    require) on the card; the CPU's ops are deterministic already."""
    if torch.device(device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)


def build(cfg, steps: int, lr: float = 3e-4, grad_compress: bool = False,
          device="cuda"):
    """(the initial TrainState, the train step) for ``steps`` steps of
    ``cfg``: AdamW with a warmup of ``max(steps // 20, 1)``, params drawn
    on ``device`` from a generator seeded 0, the optimizer's moments zero;
    ``grad_compress`` installs the error-feedback GSE-SEM transform (k 8,
    tag 1, leaves of at least 4096 elements)."""
    opt = AdamW(lr=lr, warmup_steps=max(steps // 20, 1), total_steps=steps)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen, device=device)
    state = stepfns.TrainState(
        params=params, opt_state=opt.init(params),
        step=torch.zeros((), dtype=torch.int32, device=device))
    transform = None
    if grad_compress:
        init_buf, tf = make_error_feedback_transform(k=8, tag=1,
                                                     min_size=4096)
        ef_state = {"buf": init_buf(params)}

        def transform(grads):
            g, ef_state["buf"] = tf(grads, ef_state["buf"])
            return g

    return state, stepfns.make_train_step(cfg, opt, grad_transform=transform)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=-1,
                    help="exit(17) after this step to test restart")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    deterministic(args.device)
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    state, step_fn = build(cfg, args.steps, args.lr, args.grad_compress,
                           device=args.device)
    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=0,
        num_prefix_tokens=cfg.num_prefix_tokens if cfg.family == "vlm" else 0,
        enc_len=args.seq if cfg.family == "encdec" else 0,
        d_model=cfg.d_model,
    )
    pipe = TokenPipeline(dcfg, device=args.device)

    start = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, start, _ = ckpt.restore(args.ckpt_dir, last, state)
            print(f"resumed from step {start}", flush=True)

    t0 = time.time()
    for step in range(start, args.steps):
        batch = pipe.batch_at(step)
        state, metrics = step_fn(state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(args.ckpt_dir, state, step + 1)
        if args.simulate_failure_at == step:
            print("simulating node failure", flush=True)
            os._exit(17)
    if args.ckpt_dir:
        ckpt.wait_pending(args.ckpt_dir)
        ckpt.save(args.ckpt_dir, state, args.steps)
    print("done", flush=True)
    return state


if __name__ == "__main__":
    main()
