#!/usr/bin/env python3
"""The reference's encdec serving path (seamless_m4t_large_v2) at full
width, cut to two encoder and two decoder layers: the logits digest that
``chip_smoke.py`` phase 32 holds the port to (``ENCDEC_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/encdec_serve_ref.py [VARIANT ...]

JAX on the CPU for ``chip_smoke.EV_TWIN_VARIANTS``: the dense model and
``gse_serve`` at tag 2 at ``compute_dtype=float32``, ``gse_serve`` at tag
2 at bfloat16.  The params are ``chip_smoke.encdec_tree_np``'s numpy tree
(seed ``ENCDEC_SEED``); under ``gse_serve`` each layer's linear weights
(both stacks) and the unembedding are packed with the reference's
``extract_shared_exponents_jnp`` and ``pack32_jnp``, one table per layer,
as its ``init_params`` does.  The reference serves no encdec model (its
CLI calls ``serve_step`` without ``enc_out``), so the yardstick is built
from its own functions: ``enc_out`` from ``M.sinusoidal`` and
``_scan_encdec`` over the frames (the encoder half of ``forward``,
``repro/models/transformer.py:260-270``), then ``decode_step(...,
enc_out)`` teacher-forced from position 0 over ``ENCDEC_TWIN["prompt"] +
ENCDEC_TWIN["steps"]`` tokens; the digest keeps the steps from the
prompt's last position on (the port's prefill, then its decode steps).
It prints one JSON line per variant, as ``lm_serve_ref.py``.  This script
runs the JAX package (it is not part of the port); it holds about 10 GB.
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
from repro.models import transformer as T  # noqa: E402

DTYPES = {"bfloat16": jnp.bfloat16}


def params_for(cfg, tree):
    out = jax.tree.map(jnp.asarray, tree)
    if not cfg.gse_serve:
        return out
    out["unembed"]["w"] = pack(tree["unembed"]["w"], cfg.gse_k)
    for stack in ("encoder", "decoder"):
        for group, name in chip_smoke.EV_LINEAR:
            if group not in tree[stack]:
                continue
            stacked = tree[stack][group][name]
            per = [pack(stacked[i], cfg.gse_k)
                   for i in range(stacked.shape[0])]
            out[stack][group][name] = {f: jnp.stack([p[f] for p in per])
                                       for f in per[0]}
    return out


def enc_out_of(cfg, params, emb):
    """The encoder half of the reference's ``forward``."""
    @jax.jit
    def enc(p, e):
        e = e.astype(cfg.compute_dtype)
        b, s = e.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        e = e + M.sinusoidal(pos, cfg.d_model).astype(cfg.compute_dtype)
        return T._scan_encdec(cfg, p["encoder"], e, pos, "enc_attn")

    return enc(params, emb)


def main(argv):
    twin = chip_smoke.ENCDEC_TWIN
    base = dataclasses.replace(configs.get_config("seamless_m4t_large_v2"),
                               num_layers=twin["layers"],
                               encoder_layers=twin["layers"],
                               compute_dtype=jnp.float32)
    tree = chip_smoke.encdec_tree_np(base, chip_smoke.ENCDEC_SEED)
    tokens, emb = chip_smoke.ev_inputs(base, chip_smoke.ENCDEC_SEED, twin)
    n = twin["prompt"] + twin["steps"]
    for name, kw in chip_smoke.EV_TWIN_VARIANTS.items():
        if argv and name not in argv:
            continue
        t0 = time.perf_counter()
        kw = dict(kw)
        if "compute_dtype" in kw:
            kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
        cfg = dataclasses.replace(base, **kw)
        params = params_for(cfg, tree)
        enc_out = enc_out_of(cfg, params, jnp.asarray(emb))
        step = jax.jit(lambda p, s, t, pos, e: T.decode_step(cfg, p, s, t,
                                                             pos, e))
        state = T.decode_state_init(cfg, twin["batch"], n)
        logits = []
        for pos in range(n):
            lg, state = step(params, state, jnp.asarray(tokens[:, pos]),
                             jnp.asarray(pos, jnp.int32), enc_out)
            if pos >= twin["prompt"] - 1:
                logits.append(lg)
        digest = chip_smoke.lm_digest(
            np.stack([np.asarray(lg, np.float32) for lg in logits]))
        print(json.dumps({"variant": name, "steps": digest,
                          "jax": jax.__version__,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
        del params, state, logits, enc_out


if __name__ == "__main__":
    main(sys.argv[1:])
