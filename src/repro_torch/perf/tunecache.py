"""Persisted tuned-plan store, checksum-verified on every hit.

Port of ``repro/perf/tunecache.py``.  The autotuner's winners (and the
roofline probes) survive the process in one JSON file, keyed by the
launch-plan key ``shape-class | tag | layout | nrhs``
(``perf.plan.plan_key``).  Every entry carries a CRC32 over its
canonical JSON payload, verified on every lookup as the pack cache
(``kernels.ops.PACK_STATS``) verifies its packs: a corrupted entry is
dropped, counted in ``TUNE_STATS['corrupt']``, and the caller re-sweeps.
Writes are atomic (a temporary file, then ``os.replace``).

``TUNE_STATS`` is a dict-shaped view of the metrics registry's
``repro_tune_cache_events_total`` (the reference's series), so a repeat
run can assert that it re-sweeps nothing (``sweeps`` stays flat while
``hits`` grows).

Two differences from the reference, both deliberate:

* The file is the port's own: ``REPRO_TORCH_TUNE_CACHE`` names it, and the
  default is ``~/.cache/repro_torch/tunecache.json``.  A port payload has
  fields the reference's lacks (the plan's ``lanes``), so neither package
  ever reads the other's file.
* An entry belongs to the device it was measured on.  The image keeps one
  section per device (:func:`device_name`: ``"cpu"``, or ``"cuda:"`` and
  the card's name), and every call names the device it asks for (default
  ``"cuda"``, the port's): a plan tuned on the CPU's plain versions never
  resolves on the card, nor one tuned on another card.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib

import torch

from repro_torch.obs import metrics as OM

__all__ = ["TUNE_STATS", "cache_path", "device_name", "lookup", "store",
           "host_entry", "store_host", "reset", "clear_memory"]

TUNE_STATS = OM.stats_view(
    "repro_tune_cache_events_total",
    ("hits", "misses", "corrupt", "sweeps", "stores"),
    help="Tuned-plan store events by outcome.",
)

# In-memory image of the cache file: {"devices": {name: {"plans": {key:
# entry}, "host": entry}}} with entry = {"payload": <jsonable>, "crc":
# int}.  Reloaded whenever the resolved path changes (tests point
# REPRO_TORCH_TUNE_CACHE at temporary files).
_MEM: dict | None = None
_MEM_PATH: str | None = None


def cache_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tunecache.json")


def device_name(device="cuda") -> str:
    """The section an entry measured on ``device`` lives in: ``"cpu"``, or
    ``"cuda:"`` followed by the card's name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return f"cuda:{torch.cuda.get_device_name(index)}"
    return dev.type


def _crc(payload) -> int:
    return zlib.crc32(json.dumps(payload, sort_keys=True).encode())


def _image() -> dict:
    global _MEM, _MEM_PATH
    path = cache_path()
    if _MEM is None or _MEM_PATH != path:
        try:
            with open(path) as fh:
                _MEM = json.load(fh)
        except (OSError, ValueError):
            _MEM = {}
        if not isinstance(_MEM, dict) or not isinstance(
                _MEM.get("devices"), dict):
            _MEM = {"devices": {}}
        _MEM_PATH = path
    return _MEM


def _section(device) -> dict:
    sec = _image()["devices"].setdefault(device_name(device), {})
    sec.setdefault("plans", {})
    sec.setdefault("host", None)
    return sec


def _flush() -> None:
    path = cache_path()
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, prefix=".tunecache.")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(_MEM, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: readers never see a torn file
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _verify(entry) -> bool:
    return (isinstance(entry, dict) and "payload" in entry
            and _crc(entry["payload"]) == entry.get("crc"))


def lookup(key: str, device="cuda"):
    """Tuned payload for ``key`` on ``device`` or None; checksum-verified on
    every hit."""
    plans = _section(device)["plans"]
    entry = plans.get(key)
    if entry is None:
        TUNE_STATS["misses"] += 1
        return None
    if not _verify(entry):
        TUNE_STATS["corrupt"] += 1
        del plans[key]
        _flush()
        return None
    TUNE_STATS["hits"] += 1
    return entry["payload"]


def store(key: str, payload, device="cuda") -> None:
    """Persist a tuned payload under ``key`` for ``device`` (atomic
    rewrite)."""
    _section(device)["plans"][key] = {"payload": payload,
                                      "crc": _crc(payload)}
    TUNE_STATS["stores"] += 1
    _flush()


def host_entry(device="cuda"):
    """Persisted roofline probe of ``device`` ({stream_gbps, peak_gflops})
    or None."""
    entry = _section(device)["host"]
    if entry is None or not _verify(entry):
        return None
    return entry["payload"]


def store_host(payload, device="cuda") -> None:
    _section(device)["host"] = {"payload": payload, "crc": _crc(payload)}
    _flush()


def reset() -> None:
    """Zero the counters (tests)."""
    for k in TUNE_STATS:
        TUNE_STATS[k] = 0


def clear_memory() -> None:
    """Drop the in-memory image so the next access re-reads the file."""
    global _MEM, _MEM_PATH
    _MEM = None
    _MEM_PATH = None
