"""Core of the paper's contribution: GSE-SEM format + stepped precision,
and the per-group precision axis (``core.tagmap``)."""
from repro_torch.core.tagmap import GROUP_SIZE, TagMap, normalize_tags

__all__ = ["GROUP_SIZE", "TagMap", "normalize_tags"]
