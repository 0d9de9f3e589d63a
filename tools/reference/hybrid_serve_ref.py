#!/usr/bin/env python3
"""The reference's hybrid serving path (recurrentgemma_2b) at full width,
cut to three layers and a window of 64: the logits digest that
``chip_smoke.py`` phase 26 holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/hybrid_serve_ref.py [VARIANT ...]

JAX on the CPU at ``compute_dtype=float32`` for the dense model, for
``gse_serve`` at tag 2 and for ``kv_cache_gse`` (``kv8``), and at
``compute_dtype=bfloat16`` for ``gse_serve`` at tag 2 (``tag2_bf16``);
``chip_smoke.HYBRID_TWIN_VARIANTS`` names them.  The params are
``chip_smoke.hybrid_tree_np``'s numpy tree (seed ``HYBRID_SEED``), in the
reference's list layout; under ``gse_serve`` each layer's linear weights
are packed with the reference's ``extract_shared_exponents_jnp`` and
``pack32_jnp``, one table per weight, as its ``init_params`` does.  Two
requests of ``HYBRID_TWIN["prompt"]`` tokens go through
``make_prefill_step``; then ``HYBRID_TWIN["steps"]`` teacher-forced
``decode_step``s follow from the decode state after the prompt, computed
along the reference's prefill path with its own functions: each local
layer's ring holds the rotated keys and values of the last ``window``
positions at ``p % window`` (``_project_qkv``, ``rope``; packed with
``_kv_pack_u8`` under ``kv8``), each RG-LRU layer's state the scan's last
``h`` and the last three inputs of its conv (``_conv1d``, ``_gates``,
``associative_scan``).  It prints one JSON line per variant: the greedy
tokens, the first 8 logits of request 0 and the largest |logit| of each
step (``chip_smoke.lm_digest``).  This script runs the JAX package (it is
not part of the port); it holds about 12 GB.
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
from repro.models import attention as A  # noqa: E402
from repro.models import modules as M  # noqa: E402
from repro.models import rglru as R  # noqa: E402
from repro.models import stepfns  # noqa: E402
from repro.models import transformer as T  # noqa: E402

DTYPES = {"bfloat16": jnp.bfloat16}


def params_for(cfg, dense):
    """``dense`` (jnp leaves) with every linear weight packed under
    ``gse_serve``; the other leaves shared."""
    if not cfg.gse_serve:
        return dense
    out = jax.tree.map(lambda a: a, dense)
    out["unembed"]["w"] = pack(np.asarray(dense["unembed"]["w"]), cfg.gse_k)
    for lay in out["layers"]:
        for group, name in chip_smoke.LM_LINEAR:
            if group in lay and name in lay[group]:
                lay[group][name] = pack(np.asarray(lay[group][name]),
                                        cfg.gse_k)
    return out


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def prompt_state(cfg, params, tokens, max_len):
    """The decode state after the prompt, along the prefill path."""
    dtype = cfg.compute_dtype
    x = M.embed(params["embed"], tokens, dtype)
    b, s = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    kinds = T._layer_kinds(cfg)
    state = T.decode_state_init(cfg, b, max_len)["layers"]

    @jax.jit
    def attn_kv(lp, x):
        h = M.rmsnorm(lp["norm1"], x)
        _, k, v = A._project_qkv(lp["attn"], h, cfg, dtype)
        return M.rope(k, positions, cfg.rope_theta), v

    @jax.jit
    def lru_state(lp, x):
        h = M.rmsnorm(lp["norm1"], x)
        p = lp["rglru"]
        u = jnp.dot(h.astype(dtype), p["w_in"].astype(dtype))
        uc, conv = R._conv1d(p, u)
        a, bb = R._gates(p, uc)
        _, hs = jax.lax.associative_scan(_combine, (a, bb), axis=1)
        return hs[:, -1], conv

    block = jax.jit(lambda lp, x, kind: T._block_apply(
        cfg, lp, x, positions, kind)[0], static_argnums=2)
    out = []
    for lp, kind, st in zip(params["layers"], kinds, state):
        if kind == "local_attn":
            k, v = attn_kv(lp, x)
            if cfg.kv_cache_gse:
                k, v = A._kv_pack_u8(k), A._kv_pack_u8(v)
            size = st["k"].shape[1]
            first = max(0, s - size)
            slots = jnp.arange(first, s) % size
            out.append({"k": st["k"].at[:, slots].set(k[:, first:]),
                        "v": st["v"].at[:, slots].set(v[:, first:])})
        else:
            h_last, conv = lru_state(lp, x)
            out.append({"h": h_last, "conv": conv.astype(st["conv"].dtype)})
        x = block(lp, x, kind)
    return {"layers": out}


def main(argv):
    twin = chip_smoke.HYBRID_TWIN
    base = dataclasses.replace(configs.get_config("recurrentgemma_2b"),
                               num_layers=twin["layers"],
                               local_window=twin["window"],
                               compute_dtype=jnp.float32)
    dense = jax.tree.map(jnp.asarray, chip_smoke.hybrid_tree_np(
        base, chip_smoke.HYBRID_SEED))
    tokens = chip_smoke.lm_tokens(base, chip_smoke.HYBRID_SEED + 1,
                                  twin["batch"],
                                  twin["prompt"] + twin["steps"])
    prompt = jnp.asarray(tokens[:, :twin["prompt"]])
    for name, kw in chip_smoke.HYBRID_TWIN_VARIANTS.items():
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
