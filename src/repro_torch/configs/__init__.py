"""Architecture registry: port of ``repro/configs/__init__.py``.

``get_config(arch, smoke)`` resolves the reference's ids and aliases.
Every architecture is ported: the dense family (``qwen3_4b``,
``granite_3_2b``, ``granite_34b``, ``qwen15_32b``), the hybrid family
(``recurrentgemma_2b``), the moe family (``qwen3_moe_235b_a22b``,
``grok1_314b``), the ssm family (``rwkv6_1p6b``), the encdec family
(``seamless_m4t_large_v2``) and the vlm family (``internvl2_2b``).
Sharding rules (``get_rules``) have no counterpart: the port runs on one
card.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "ALIASES", "PORTED", "get_config"]

ARCH_IDS = (
    "seamless_m4t_large_v2",
    "internvl2_2b",
    "qwen3_moe_235b_a22b",
    "grok1_314b",
    "recurrentgemma_2b",
    "qwen15_32b",
    "qwen3_4b",
    "granite_34b",
    "granite_3_2b",
    "rwkv6_1p6b",
)

ALIASES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "internvl2-2b": "internvl2_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "grok-1-314b": "grok1_314b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen1.5-32b": "qwen15_32b",
    "qwen3-4b": "qwen3_4b",
    "granite-34b": "granite_34b",
    "granite-3-2b": "granite_3_2b",
    "rwkv6-1.6b": "rwkv6_1p6b",
}

PORTED = ARCH_IDS


def _module(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.smoke_config() if smoke else mod.config()
