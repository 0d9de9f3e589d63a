"""granite-3-2b [dense]: port of ``repro/configs/granite_3_2b.py``
(hf:ibm-granite/granite-3.0-2b-base).

40L, d_model=2048, 32H (GQA kv=8), d_ff=8192, vocab=49155.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_3_2b",
        family="dense",
        num_layers=40,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=49155,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite3_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=197,
    )
