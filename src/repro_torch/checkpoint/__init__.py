"""Checkpoints of trees of tensors (``checkpoint.ckpt``)."""
