"""qwen1.5-32b [dense]: port of ``repro/configs/qwen15_32b.py``
(hf:Qwen/Qwen1.5 family).

64L, d_model=5120, 40H (full MHA kv=40), d_ff=27392, vocab=152064,
QKV bias.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen15_32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen15_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=160,
        vocab_size=223,
        qkv_bias=True,
    )
