"""Batched serving entry point: port of ``repro/launch/serve.py``.

Serves batched requests against a model (the smoke config by default);
``--gse-tag`` serves its weights from GSE-SEM segments: ``quantize_tree``
packs them and ``dequantize_tree`` (kernel D) decodes them at that tag,
then requests are served by a teacher-forced prefill through the decode
path followed by greedy decoding, as in the reference.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_4b \\
      --batch 4 --prompt-len 12 --gen 8 [--gse-tag 2] [--device cpu]

The reference's ``--smoke`` is ``store_true`` with ``default=True``, so it
can never select the full config; here it is ``--smoke/--no-smoke`` with
the same default.  Params and prompts come from torch generators seeded 0
and 1 (the reference's JAX keys 0 and 1 give other numbers).  The CLI
serves text only, as the reference's does: ``internvl2_2b`` without its
patch prefix; ``seamless_m4t_large_v2`` needs the encoder's frame
embeddings, which the CLI does not supply, so it raises ``ValueError``
(the reference's dies in ``cross_kv``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.models import stepfns, transformer as T
from repro_torch.quant import gse_tensor as Q

__all__ = ["main", "parser", "serve", "gse_params"]


def gse_params(params, gse_tag: int, log=print):
    """The weights served at ``gse_tag``: quantized at k=8 (leaves of at
    least 2048 elements) and decoded to bf16."""
    packed = Q.quantize_tree(params, k=8, min_size=2048)
    log(f"serving GSE-SEM tag={gse_tag}: "
        f"{Q.tree_bytes(packed, gse_tag) / 1e6:.2f} MB weight stream "
        f"(vs {Q.tree_bytes(packed, 3) / 1e6:.2f} MB full)")
    return Q.dequantize_tree(packed, tag=gse_tag, dtype=torch.bfloat16)


def serve(cfg, params, prompts: torch.Tensor, gen: int, log=print) -> list:
    """Teacher-forced prefill of ``prompts`` (B, P) through the decode path,
    then ``gen`` greedy tokens.  Returns each printed step's tokens."""
    batch, prompt_len = prompts.shape
    total = prompt_len + gen
    state = T.decode_state_init(cfg, batch, max_len=total,
                                device=prompts.device)
    serve_step = stepfns.make_serve_step(cfg)
    out = []
    tok = prompts[:, 0]
    for pos in range(total - 1):
        nxt, state = serve_step(params, state, tok, pos)
        tok = prompts[:, pos + 1] if pos + 1 < prompt_len else nxt
        if pos >= prompt_len - 1:
            out.append(nxt.tolist())
            log(f"pos {pos:4d} -> tokens {out[-1]}")
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--gse-tag", type=int, default=0,
                    help="0: dense bf16; 1/2/3: GSE-SEM serving precision")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    log = lambda msg: print(msg, flush=True)  # noqa: E731

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise ValueError(f"{args.arch} is an encoder-decoder model: the "
                         "serve CLI supplies no encoder input (frame "
                         "embeddings); serve it through "
                         "stepfns.make_prefill_step(enc_embeds=) and "
                         "decode_step(enc_out=)")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device=args.device)
    if args.gse_tag:
        params = gse_params(params, args.gse_tag, log)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)
                            ).to(args.device)
    t0 = time.time()
    tokens = serve(cfg, params, prompts, args.gen, log)
    dt = time.time() - t0
    log(f"served {args.batch} requests x {args.gen} new tokens in {dt:.2f}s "
        f"({args.batch * args.gen / dt:.1f} tok/s)")
    return tokens


if __name__ == "__main__":
    main()
