"""qwen3-moe-235b-a22b [moe]: port of
``repro/configs/qwen3_moe_235b_a22b.py``.

94L, d_model=4096, 64H (GQA kv=4), per-expert d_ff=1536, vocab=151936,
MoE 128 experts top-8, qk-norm.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_moe_235b_a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        head_dim=128,
        d_ff=1536,
        moe_d_ff=1536,
        vocab_size=151936,
        num_experts=128,
        experts_per_token=8,
        qk_norm=True,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_moe_smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=96,
        moe_d_ff=96,
        vocab_size=211,
        num_experts=4,
        experts_per_token=2,
        qk_norm=True,
    )
