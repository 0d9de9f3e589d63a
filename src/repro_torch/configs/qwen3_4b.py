"""qwen3-4b [dense]: port of ``repro/configs/qwen3_4b.py``.

36L, d_model=2560, 32H (GQA kv=8, head_dim=128), d_ff=9728, vocab=151936,
qk-norm.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3_4b_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=241,
        qk_norm=True,
    )
