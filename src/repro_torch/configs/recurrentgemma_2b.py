"""recurrentgemma-2b [hybrid]: port of ``repro/configs/recurrentgemma_2b.py``.

26L Griffin pattern (2x RG-LRU : 1x local-attention, window 2048),
d_model=2560, 10H (MQA kv=1, head_dim=256), d_ff=7680, lru_width=2560,
vocab=256000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        hybrid_period=3,
        local_window=2048,
        lru_width=2560,
        mlp_act="swiglu",
        scan_layers=False,      # heterogeneous layers: a list of layers
        remat="full",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_smoke",
        family="hybrid",
        num_layers=3,
        d_model=64,
        num_heads=2,
        num_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=307,
        hybrid_period=3,
        local_window=16,
        lru_width=64,
        scan_layers=False,
    )
