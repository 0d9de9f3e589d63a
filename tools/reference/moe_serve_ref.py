#!/usr/bin/env python3
"""The reference's moe serving path (qwen3_moe_235b_a22b) at full width,
cut to two layers and an expert ff of 256: the logits and route digest
that ``chip_smoke.py`` phase 28 holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/moe_serve_ref.py [VARIANT ...]

JAX on the CPU for ``chip_smoke.MOE_TWIN_VARIANTS``: the dense model,
``gse_serve`` at tag 2 and ``capacity_factor`` 0.5 (pairs dropped at the
prefill) at ``compute_dtype=float32``, ``gse_serve`` at tag 2 at
bfloat16.  The params are ``chip_smoke.moe_tree_np``'s numpy tree (seed
``MOE_SEED``); under ``gse_serve`` each layer's attention weights and the
unembedding are packed with the reference's
``extract_shared_exponents_jnp`` and ``pack32_jnp`` (one table per layer),
the expert stacks stay dense, as its ``init_params`` does.  Two requests
of ``MOE_TWIN["prompt"]`` tokens go through ``make_prefill_step``; then
``MOE_TWIN["steps"]`` teacher-forced ``decode_step``s follow, over a cache
that holds the prompt's keys and values (``lm_serve_ref.prompt_cache``'s
recipe).  The routes are the reference's routing (``moe.py:74-76``) on
each layer's MoE input, computed along the prefill path and along a
layer-by-layer decode with the reference's ``_block_decode``.  It prints
one JSON line per variant: per step the greedy tokens, the first 8
logits of request 0, the largest |logit| and the route digest
(``chip_smoke.route_digest``), and under "ids" the expert ids themselves
(``chip_smoke.encode_route_ids``), which phase 28 replays on the card at
bf16.  This script runs the JAX package (it is
not part of the port); it holds about 20 GB.
"""
import dataclasses
import json
import sys
import time
import zlib
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
from repro.models import attention as A  # noqa: E402
from repro.models import modules as M  # noqa: E402
from repro.models import stepfns  # noqa: E402
from repro.models import transformer as T  # noqa: E402

DTYPES = {"bfloat16": jnp.bfloat16}
ATTN = ("wq", "wk", "wv", "wo")


def params_for(cfg, dense):
    """``dense`` (jnp leaves) with the attention weights and the
    unembedding packed under ``gse_serve``; the other leaves shared."""
    if not cfg.gse_serve:
        return dense
    out = jax.tree.map(lambda a: a, dense)
    out["unembed"]["w"] = pack(np.asarray(dense["unembed"]["w"]), cfg.gse_k)
    for name in ATTN:
        stacked = np.asarray(dense["layers"]["attn"][name])
        per = [pack(stacked[i], cfg.gse_k) for i in range(stacked.shape[0])]
        out["layers"]["attn"][name] = {f: jnp.stack([p[f] for p in per])
                                       for f in per[0]}
    return out


def expert_ids(lp, h2, cfg):
    """The reference's routing (``moe.py:74-76``) on the MoE input h2."""
    xt = h2.reshape(-1, h2.shape[-1])
    probs = jax.nn.softmax(jnp.dot(xt.astype(jnp.float32),
                                   lp["moe"]["router"]), axis=-1)
    return jax.lax.top_k(probs, cfg.experts_per_token)[1]


def digest_ids(ids_per_layer, batch):
    """One step's route digest: per layer, per request, crc32 of its ids."""
    return [[zlib.crc32(r.tobytes()) for r in
             np.asarray(ids, np.int32).reshape(batch, -1)]
            for ids in ids_per_layer]


def prompt_pass(cfg, params, tokens, max_len):
    """The decode state after the prompt (each layer's rotated keys and
    values), the prompt's route digest and its expert ids per layer, along
    the prefill path."""
    dtype = cfg.compute_dtype
    x = M.embed(params["embed"], tokens, dtype)
    b, s = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

    @jax.jit
    def layer(lp, x):
        h = M.rmsnorm(lp["norm1"], x)
        _, k, v = A._project_qkv(lp["attn"], h, cfg, dtype)
        k = M.rope(k, positions, cfg.rope_theta)
        y = A.attn_apply(lp["attn"], h, cfg, positions)
        h2 = M.rmsnorm(lp["norm2"], x + y.astype(x.dtype))
        out, _ = T._block_apply(cfg, lp, x, positions, "moe")
        return out, k, v, expert_ids(lp, h2, cfg)

    state = T.decode_state_init(cfg, b, max_len)
    ks, vs, ids = [], [], []
    for i in range(cfg.num_layers):
        x, k, v, e = layer(jax.tree.map(lambda a: a[i], params["layers"]), x)
        ks.append(k)
        vs.append(v)
        ids.append(e)
    lay = state["layers"]
    return ({"layers": {"k": lay["k"].at[:, :, :s].set(jnp.stack(ks)),
                        "v": lay["v"].at[:, :, :s].set(jnp.stack(vs))}},
            digest_ids(ids, b), ids)


def step_routes(cfg):
    """``routes(params, state, tokens, pos)``: one decode step layer by
    layer (``_block_decode``), its route digest."""
    dtype = cfg.compute_dtype

    @jax.jit
    def layer(lp, x, cache, pos):
        h = M.rmsnorm(lp["norm1"], x)
        y, _ = A.decode_attn_apply(lp["attn"], h, cache, pos, cfg)
        h2 = M.rmsnorm(lp["norm2"], x + y.astype(x.dtype))
        out, _ = T._block_decode(cfg, lp, x, cache, pos, "moe")
        return out, expert_ids(lp, h2, cfg)

    def routes(params, state, tokens, pos):
        x = M.embed(params["embed"], tokens[:, None], dtype)
        ids = []
        for i in range(cfg.num_layers):
            lp = jax.tree.map(lambda a: a[i], params["layers"])
            cache = jax.tree.map(lambda a: a[i], state["layers"])
            x, e = layer(lp, x, cache, pos)
            ids.append(e)
        return digest_ids(ids, tokens.shape[0]), ids

    return routes


def main(argv):
    twin = chip_smoke.MOE_TWIN
    ff = twin["expert_ff"]
    base = dataclasses.replace(configs.get_config("qwen3_moe_235b_a22b"),
                               num_layers=twin["layers"], d_ff=ff,
                               moe_d_ff=ff, compute_dtype=jnp.float32)
    dense = jax.tree.map(jnp.asarray, chip_smoke.moe_tree_np(
        base, chip_smoke.MOE_SEED))
    tokens = chip_smoke.lm_tokens(base, chip_smoke.MOE_SEED + 1,
                                  twin["batch"],
                                  twin["prompt"] + twin["steps"])
    prompt = jnp.asarray(tokens[:, :twin["prompt"]])
    for name, kw in chip_smoke.MOE_TWIN_VARIANTS.items():
        if argv and name not in argv:
            continue
        t0 = time.perf_counter()
        kw = dict(kw)
        if "compute_dtype" in kw:
            kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
        cfg = dataclasses.replace(base, **kw)
        params = params_for(cfg, dense)
        logits = [jax.jit(stepfns.make_prefill_step(cfg))(params, prompt)]
        state, routes, ids = prompt_pass(cfg, params, prompt,
                                         twin["prompt"] + twin["steps"])
        routes = [routes]
        step = jax.jit(lambda p, s, t, pos: T.decode_step(cfg, p, s, t, pos))
        step_ids = step_routes(cfg)
        for i in range(twin["steps"]):
            pos = twin["prompt"] + i
            tok = jnp.asarray(tokens[:, pos])
            p32 = jnp.asarray(pos, jnp.int32)
            r, e = step_ids(params, state, tok, p32)
            routes.append(r)
            ids.extend(e)
            lg, state = step(params, state, tok, p32)
            logits.append(lg)
        digest = chip_smoke.lm_digest(
            np.stack([np.asarray(lg, np.float32) for lg in logits]))
        for row, r in zip(digest, routes):
            row["routes"] = r
        ids = chip_smoke.encode_route_ids([np.asarray(e) for e in ids])
        print(json.dumps({"variant": name, "steps": digest, "ids": ids,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
        del params, state, logits


if __name__ == "__main__":
    main(sys.argv[1:])
