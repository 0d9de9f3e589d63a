#!/usr/bin/env python3
"""The reference's ssm serving path (rwkv6_1p6b) at full width, cut to
three layers: the logits digest that ``chip_smoke.py`` phase 30 holds the
port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/rwkv_serve_ref.py [VARIANT ...]

JAX on the CPU for ``chip_smoke.RWKV_TWIN_VARIANTS``: the dense model and
``gse_serve`` at tag 2 at ``compute_dtype=float32``, ``gse_serve`` at tag
2 at bfloat16.  The params are ``chip_smoke.rwkv_tree_np``'s numpy tree
(seed ``RWKV_SEED``); under ``gse_serve`` the unembedding is packed with
the reference's ``extract_shared_exponents_jnp`` and ``pack32_jnp`` (the
RWKV weights stay dense, as its ``init_params`` draws them).  Two
requests of ``RWKV_TWIN["prompt"]`` tokens go through
``make_prefill_step``; then ``RWKV_TWIN["steps"]`` teacher-forced
``decode_step``s follow from the state after the prompt, computed along
the prefill path with the reference's own functions: each layer's ``S``
and ``last_t`` from ``rwkv_time_apply`` on its normed input, ``last_c``
the last row of its channel-mix input.  It prints one JSON line per
variant, as ``lm_serve_ref.py``.  This script runs the JAX package (it is
not part of the port); it holds about 8 GB.
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
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402  (numpy-only helpers: the params recipe)
from lm_serve_ref import pack  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import modules as M  # noqa: E402
from repro.models import rwkv as W  # noqa: E402
from repro.models import stepfns  # noqa: E402
from repro.models import transformer as T  # noqa: E402

DTYPES = {"bfloat16": jnp.bfloat16}


def params_for(cfg, dense):
    if not cfg.gse_serve:
        return dense
    out = jax.tree.map(lambda a: a, dense)
    out["unembed"]["w"] = pack(np.asarray(dense["unembed"]["w"]), cfg.gse_k)
    return out


def prompt_state(cfg, params, tokens, max_len):
    """The decode state after the prompt, along the prefill path."""
    x = M.embed(params["embed"], tokens, cfg.compute_dtype)
    b, s = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

    @jax.jit
    def layer(lp, x):
        h = M.rmsnorm(lp["norm1"], x)
        y, st = W.rwkv_time_apply(lp["time"], h, cfg)
        h2 = M.rmsnorm(lp["norm2"], x + y.astype(x.dtype))
        out, _ = T._block_apply(cfg, lp, x, positions, "rwkv")
        return out, st["S"], st["last"], h2[:, -1, :]

    state = T.decode_state_init(cfg, b, max_len)["layers"]
    parts = {"S": [], "last_t": [], "last_c": []}
    for i in range(cfg.num_layers):
        x, S, lt, lc = layer(jax.tree.map(lambda a: a[i], params["layers"]),
                             x)
        parts["S"].append(S)
        parts["last_t"].append(lt.astype(state["last_t"].dtype))
        parts["last_c"].append(lc.astype(state["last_c"].dtype))
    return {"layers": {k: jnp.stack(v) for k, v in parts.items()}}


def main(argv):
    twin = chip_smoke.RWKV_TWIN
    base = dataclasses.replace(configs.get_config("rwkv6_1p6b"),
                               num_layers=twin["layers"],
                               compute_dtype=jnp.float32)
    dense = jax.tree.map(jnp.asarray, chip_smoke.rwkv_tree_np(
        base, chip_smoke.RWKV_SEED))
    tokens = chip_smoke.lm_tokens(base, chip_smoke.RWKV_SEED + 1,
                                  twin["batch"],
                                  twin["prompt"] + twin["steps"])
    prompt = jnp.asarray(tokens[:, :twin["prompt"]])
    for name, kw in chip_smoke.RWKV_TWIN_VARIANTS.items():
        if argv and name not in argv:
            continue
        t0 = time.perf_counter()
        kw = dict(kw)
        if "compute_dtype" in kw:
            kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
        cfg = dataclasses.replace(base, **kw)
        params = params_for(cfg, dense)
        logits = [jax.jit(stepfns.make_prefill_step(cfg))(params, prompt)]
        state = prompt_state(cfg, params, prompt,
                             twin["prompt"] + twin["steps"])
        step = jax.jit(lambda p, s, t, pos: T.decode_step(cfg, p, s, t, pos))
        for i in range(twin["steps"]):
            pos = twin["prompt"] + i
            lg, state = step(params, state, jnp.asarray(tokens[:, pos]),
                             jnp.asarray(pos, jnp.int32))
            logits.append(lg)
        digest = chip_smoke.lm_digest(
            np.stack([np.asarray(lg, np.float32) for lg in logits]))
        print(json.dumps({"variant": name, "steps": digest,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
        del params, state, logits


if __name__ == "__main__":
    main(sys.argv[1:])
