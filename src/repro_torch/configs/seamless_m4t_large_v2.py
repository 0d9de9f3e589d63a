"""seamless-m4t-large-v2 [audio, enc-dec]: port of
``repro/configs/seamless_m4t_large_v2.py``.

24L encoder + 24L decoder, d_model=1024, 16H (GQA kv=16), d_ff=8192,
vocab=256206, GELU MLP.  The speech frontend is a stub: the caller
supplies precomputed frame embeddings to the encoder.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless_m4t_large_v2",
        family="encdec",
        num_layers=24,
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        mlp_act="gelu",
        frontend="audio_stub",
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless_smoke",
        family="encdec",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=503,
        mlp_act="gelu",
        frontend="audio_stub",
    )
