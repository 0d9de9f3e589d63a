"""Optimizers (port of ``repro/optim``)."""
from repro_torch.optim.adamw import AdamW, AdamWState

__all__ = ["AdamW", "AdamWState"]
