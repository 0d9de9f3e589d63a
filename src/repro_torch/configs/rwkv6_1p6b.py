"""rwkv6-1.6b "Finch" [ssm, attention-free]: port of
``repro/configs/rwkv6_1p6b.py``.

24L, d_model=2048, d_ff=7168, vocab=65536, data-dependent decay,
head_dim 64 (32 rwkv heads).  O(1)-state decode.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_1p6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,            # d_model / rwkv_head_dim
        num_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        rwkv_head_dim=64,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6_smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=181,
        rwkv_head_dim=16,
    )
