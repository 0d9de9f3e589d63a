#!/usr/bin/env python3
"""The reference's LM serving path at qwen3_4b's full width, cut to two
layers: the logits digest that ``chip_smoke.py`` phase 12 holds the port
to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/lm_serve_ref.py [VARIANT ...]

JAX on the CPU at ``compute_dtype=float32``, for the dense model, for
``gse_serve`` at tags 1 and 2 and for the 8-bit KV cache (``kv8``:
``kv_cache_gse``, dense weights), and at ``compute_dtype=bfloat16`` (the
served dtype) for ``gse_serve`` at tag 2 (``tag2_bf16``); naming variants
runs only those.  The params
are ``chip_smoke.lm_tree_np``'s numpy tree (seed ``LM_SEED``); under ``gse_serve`` each layer's linear
weights are packed with the reference's ``extract_shared_exponents_jnp``
and ``pack32_jnp``, one table per layer, as its ``init_params`` does.
Two requests of ``LM_TWIN["prompt"]`` tokens go through
``make_prefill_step``; then ``LM_TWIN["steps"]`` teacher-forced
``decode_step``s follow, over a cache that holds the prompt's keys and
values (computed with the reference's ``_project_qkv`` and ``rope`` for
each layer, as its decode path would write them; packed with
``_kv_pack_u8`` under ``kv8``).  It prints one JSON
line per variant: the greedy tokens, the first 8 logits of request 0 and
the largest |logit| of each step (``chip_smoke.lm_digest``).  This script
runs the JAX package (it is not part of the port); it holds about 8 GB.
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
from repro.core import gse as G  # noqa: E402
from repro.models import attention as A  # noqa: E402
from repro.models import modules as M  # noqa: E402
from repro.models import stepfns  # noqa: E402
from repro.models import transformer as T  # noqa: E402

VARIANTS = {"dense": {}, "tag1": dict(gse_serve=True, gse_tag=1),
            "tag2": dict(gse_serve=True, gse_tag=2),
            "tag2_bf16": dict(gse_serve=True, gse_tag=2,
                              compute_dtype=jnp.bfloat16),
            "kv8": dict(kv_cache_gse=True)}
ROWS = 256  # rows of a weight packed per pack32_jnp call


def pack(w, k):
    """A (d_in, d_out) f32 weight as gse_serve segments (one table)."""
    table = G.extract_shared_exponents_jnp(jnp.asarray(w), k)
    parts = [G.pack32_jnp(jnp.asarray(w[r:r + ROWS]), table, k)
             for r in range(0, w.shape[0], ROWS)]
    return {"head": jnp.concatenate([p[0] for p in parts]),
            "tail1": jnp.concatenate([p[1] for p in parts]),
            "table": table}


def params_for(cfg, tree):
    if not cfg.gse_serve:
        return jax.tree.map(jnp.asarray, tree)
    out = jax.tree.map(jnp.asarray, tree)
    out["unembed"]["w"] = pack(tree["unembed"]["w"], cfg.gse_k)
    for group, name in chip_smoke.LM_LINEAR:
        stacked = tree["layers"][group][name]
        per_layer = [pack(stacked[i], cfg.gse_k)
                     for i in range(stacked.shape[0])]
        out["layers"][group][name] = {
            f: jnp.stack([p[f] for p in per_layer]) for f in per_layer[0]}
    return out


def prompt_cache(cfg, params, tokens, max_len):
    """The decode state after the prompt: each layer's rotated keys and
    values at positions [0, S), from the reference's own functions."""
    dtype = cfg.compute_dtype
    x = M.embed(params["embed"], tokens, dtype)
    b, s = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

    @jax.jit
    def layer(lp, x):
        h = M.rmsnorm(lp["norm1"], x)
        _, k, v = A._project_qkv(lp["attn"], h, cfg, dtype)
        k = M.rope(k, positions, cfg.rope_theta)
        if cfg.kv_cache_gse:
            k, v = A._kv_pack_u8(k), A._kv_pack_u8(v)
        y, _ = T._block_apply(cfg, lp, x, positions, "attn")
        return y, k, v

    state = T.decode_state_init(cfg, b, max_len)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k, v = layer(jax.tree.map(lambda a: a[i], params["layers"]), x)
        ks.append(k)
        vs.append(v)
    lay = state["layers"]
    return {"layers": {"k": lay["k"].at[:, :, :s].set(jnp.stack(ks)),
                       "v": lay["v"].at[:, :, :s].set(jnp.stack(vs))}}


def main(argv):
    twin = chip_smoke.LM_TWIN
    base = dataclasses.replace(configs.get_config("qwen3_4b"),
                               num_layers=twin["layers"],
                               compute_dtype=jnp.float32)
    tree = chip_smoke.lm_tree_np(base, chip_smoke.LM_SEED)
    tokens = chip_smoke.lm_tokens(base, chip_smoke.LM_SEED + 1,
                                  twin["batch"],
                                  twin["prompt"] + twin["steps"])
    prompt = jnp.asarray(tokens[:, :twin["prompt"]])
    for name, kw in VARIANTS.items():
        if argv and name not in argv:
            continue
        t0 = time.perf_counter()
        cfg = dataclasses.replace(base, **kw)
        params = params_for(cfg, tree)
        logits = [jax.jit(stepfns.make_prefill_step(cfg))(params, prompt)]
        state = prompt_cache(cfg, params, prompt,
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
