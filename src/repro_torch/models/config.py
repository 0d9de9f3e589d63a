"""Model configuration: port of ``repro/models/config.py``.

The same fields and defaults as the reference's ``ModelConfig``, with
torch dtypes (``param_dtype`` float32, ``compute_dtype`` bfloat16).  The
port runs every family of the reference: ``dense``, ``hybrid``, ``moe``,
``ssm``, ``encdec`` and ``vlm``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_act: str = "swiglu"         # swiglu | gelu (2-matmul)

    # hybrid (RecurrentGemma / Griffin)
    hybrid_period: int = 0
    local_window: int = 0
    lru_width: int = 0

    # SSM (RWKV-6)
    rwkv_head_dim: int = 64

    # encoder-decoder (Seamless)
    encoder_layers: int = 0

    # modality frontend stub
    frontend: Optional[str] = None
    num_prefix_tokens: int = 0

    # numerics / execution
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: str = "none"
    tie_embeddings: bool = False

    # GSE-SEM serving: weights stay in GSE-SEM segments
    gse_serve: bool = False
    gse_tag: int = 2
    gse_k: int = 8

    # perf levers of the reference (defaults kept)
    kv_cache_gse: bool = False
    moe_dispatch: str = "sort"
    moe_groups: int = 32
    cast_before_gather: bool = False
    attn_impl: str = "naive"        # naive | chunked: both run kernel F
    attn_chunk: int = 1024

    def kv_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 16 (the reference shards the
        tables over a 16-way axis); logits are sliced back to the vocab."""
        return ((self.vocab_size + 15) // 16) * 16

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def attn_layer_ids(self) -> Tuple[int, ...]:
        if self.family != "hybrid":
            return tuple(range(self.num_layers))
        p = self.hybrid_period
        return tuple(i for i in range(self.num_layers) if i % p == p - 1)

    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def has_decode(self) -> bool:
        return True
