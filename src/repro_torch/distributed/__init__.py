"""Distributed training helpers (port of ``repro/distributed``): so far
the GSE-SEM gradient compression of ``compress.py``.  The partition, the
wire and the sharding rules are ROADMAP queue 1 items 15 and 17."""
