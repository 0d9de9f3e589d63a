"""internvl2-2b [vlm]: port of ``repro/configs/internvl2_2b.py``.

InternLM2 backbone: 24L, d_model=2048, 16H (GQA kv=8), d_ff=8192,
vocab=92553.  The InternViT frontend is a stub: the caller supplies 256
patch embeddings, prepended to the text sequence.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2_2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        frontend="vision_stub",
        num_prefix_tokens=256,
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2_smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=251,
        frontend="vision_stub",
        num_prefix_tokens=8,
    )
