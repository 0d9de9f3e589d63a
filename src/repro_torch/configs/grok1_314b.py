"""grok-1-314b [moe]: port of ``repro/configs/grok1_314b.py``.

64L, d_model=6144, 48H (GQA kv=8), d_ff=32768, vocab=131072,
MoE 8 experts top-2.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok1_314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        moe_d_ff=32768,
        vocab_size=131072,
        num_experts=8,
        experts_per_token=2,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok1_smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=160,
        moe_d_ff=160,
        vocab_size=199,
        num_experts=4,
        experts_per_token=2,
    )
