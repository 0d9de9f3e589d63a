#!/usr/bin/env python3
"""The reference's vlm serving path (internvl2_2b) at full width, cut to
two layers: the logits digest that ``chip_smoke.py`` phase 32 holds the
port to (``VLM_REF``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference/vlm_serve_ref.py [VARIANT ...]

JAX on the CPU for ``chip_smoke.EV_TWIN_VARIANTS``: the dense model and
``gse_serve`` at tag 2 at ``compute_dtype=float32``, ``gse_serve`` at tag
2 at bfloat16.  The params are ``chip_smoke.lm_tree_np``'s numpy tree
(seed ``VLM_SEED``); under ``gse_serve`` each layer's linear weights and
the unembedding are packed as ``lm_serve_ref.py`` packs them.  The
reference cannot decode after a prefix (its ``decode_step`` takes
tokens, its prefill fills no cache), so the yardstick is its causal
``forward`` over the 256 patches and the whole teacher-forced text
(``VLM_TWIN["prompt"] + VLM_TWIN["steps"]`` tokens) and
``logits_from_hidden`` at the positions from the prompt's last on: a
position's decode logits are the causal forward's there.  It prints one
JSON line per variant, as ``lm_serve_ref.py``.  This script runs the JAX
package (it is not part of the port); it holds about 8 GB.
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
from lm_serve_ref import params_for  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import transformer as T  # noqa: E402

DTYPES = {"bfloat16": jnp.bfloat16}


def main(argv):
    twin = chip_smoke.VLM_TWIN
    base = dataclasses.replace(configs.get_config("internvl2_2b"),
                               num_layers=twin["layers"],
                               compute_dtype=jnp.float32)
    tree = chip_smoke.lm_tree_np(base, chip_smoke.VLM_SEED)
    tokens, emb = chip_smoke.ev_inputs(base, chip_smoke.VLM_SEED, twin)
    first = emb.shape[1] + twin["prompt"] - 1
    for name, kw in chip_smoke.EV_TWIN_VARIANTS.items():
        if argv and name not in argv:
            continue
        t0 = time.perf_counter()
        kw = dict(kw)
        if "compute_dtype" in kw:
            kw["compute_dtype"] = DTYPES[kw["compute_dtype"]]
        cfg = dataclasses.replace(base, **kw)
        params = params_for(cfg, tree)

        @jax.jit
        def run(p, t, e):
            h, _ = T.forward(cfg, p, t, prefix_embeds=e)
            return T.logits_from_hidden(cfg, p, h[:, first:])

        logits = np.asarray(run(params, jnp.asarray(tokens), jnp.asarray(emb)),
                            np.float32)
        digest = chip_smoke.lm_digest(logits.transpose(1, 0, 2))
        print(json.dumps({"variant": name, "steps": digest,
                          "jax": jax.__version__,
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
        del params, logits


if __name__ == "__main__":
    main(sys.argv[1:])
