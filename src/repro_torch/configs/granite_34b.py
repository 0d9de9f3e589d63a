"""granite-34b [dense, code]: port of ``repro/configs/granite_34b.py``
(arXiv:2405.04324).

88L, d_model=6144, 48H (MQA kv=1), d_ff=24576, vocab=49152, llama-arch.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite34_smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        d_ff=128,
        vocab_size=193,
    )
