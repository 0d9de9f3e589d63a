#!/usr/bin/env python3
"""The reference's train step at qwen3_4b's full width, cut to two layers:
the digest (``TRAIN_REF``) that ``chip_smoke.py``'s train twin holds the
port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/train_ref.py

JAX on the CPU at ``compute_dtype=float32``: the params are
``chip_smoke.lm_tree_np``'s numpy tree (seed ``LM_SEED``, the config
``chip_smoke.train_twin_config()``), the optimizer's moments zero, the
optimizer ``AdamW(lr=TRAIN_TWIN["lr"], warmup_steps=1,
total_steps=TRAIN_TWIN["steps"])``, the batches the reference's
``TokenPipeline`` at ``TRAIN_TWIN["batch"]`` x ``TRAIN_TWIN["seq"]``
(seed 0, steps 0, 1, 2), through the jitted ``make_train_step`` (its
state donated).  It prints one JSON line, the digest:
per step the loss, the norm of the step's gradients summed in f64
(``grad_norm``; the step's own f32-vdot metric beside it as
``grad_norm_f32_vdot``), and the first 8 values and the largest |value|
of ``TRAIN_LEAVES`` after the update (``chip_smoke.train_row``).  This
script runs the JAX package (it is not part of the port); it holds about
17 GB.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (numpy-only helpers: the params recipe)

from repro import configs  # noqa: E402
from repro.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro.models import stepfns  # noqa: E402
from repro.optim import AdamW  # noqa: E402


def main():
    t0 = time.perf_counter()
    tw = chip_smoke.TRAIN_TWIN
    cfg = dataclasses.replace(configs.get_config("qwen3_4b"),
                              num_layers=tw["layers"],
                              compute_dtype=jnp.float32)
    tree = chip_smoke.lm_tree_np(cfg, chip_smoke.LM_SEED)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    opt = AdamW(lr=tw["lr"], warmup_steps=1, total_steps=tw["steps"])
    state = stepfns.TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32))
    del params
    step_fn = jax.jit(stepfns.make_train_step(cfg, opt), donate_argnums=(0,))
    grad_fn = jax.jit(jax.grad(lambda p, b: stepfns.make_loss_fn(cfg)(p, b)[0]))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=tw["seq"],
                                    global_batch=tw["batch"], seed=0))
    rows = []
    for step in range(tw["steps"]):
        batch = pipe.batch_at(step)
        # The gradients' norm accumulated in f64: the step's own grad_norm
        # (an f32 vdot per leaf on XLA's CPU dot) loses precision on
        # leaves of millions of elements.
        sq = sum(float(np.sum(np.square(np.asarray(g, np.float64))))
                 for g in jax.tree.leaves(grad_fn(state.params, batch)))
        state, metrics = step_fn(state, batch)
        row = chip_smoke.train_row(metrics["loss"], np.sqrt(sq),
                                   state.params, np.asarray)
        row["grad_norm_f32_vdot"] = float(metrics["grad_norm"])
        rows.append(row)
    print(json.dumps(rows), flush=True)
    print(f"# {time.perf_counter() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
