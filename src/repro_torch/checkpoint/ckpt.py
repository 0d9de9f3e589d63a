"""Checkpoints: atomic, double-buffered, hash-verified saves of a tree of
tensors.

Port of ``repro/checkpoint/ckpt.py``, with the same directory layout and
integrity contract:

  * ``save`` writes ``step_XXXXXXXX.tmp/``, fsyncs, and renames it to
    ``step_XXXXXXXX/``: a crash mid-write never corrupts the latest
    checkpoint (the previous one survives; ``latest_step`` skips partial
    directories).
  * ``save_async`` copies the tree to the host first and then hands the
    serialization to a thread (double-buffered: at most one outstanding
    write a path; the caller blocks on nothing beyond the device-to-host
    copy).
  * ``meta.json`` holds ``step``, the blob's ``sha256`` and ``bytes`` and
    the tree's canonical CRC32 (``tree_crc32``: key path, dtype, shape and
    bytes of each leaf, in sorted key order).  ``restore`` checks both: a
    blob whose bytes changed, or a tree whose decoded contents no longer
    match the stamp (a ``meta.json`` re-stamped to match a tampered blob
    included), raises ``CheckpointCorrupt``, and ``restore_latest_valid``
    walks back to the newest good step.
  * ``restore(..., device=)`` places every tensor leaf on ``device``
    (default: the device of the matching leaf of ``like``).

The blob is the port's own, made with the standard library and numpy
only: ``_MAGIC``, the length of a JSON index (8 bytes, little-endian),
the index (``step``, ``extra`` and ``{key: {dtype, shape, offset,
nbytes}}``) and the leaves' raw bytes, all compressed with zlib.  It
cannot read the reference package's msgpack/zstd checkpoints, and the
reference cannot read it; ``tree_crc32`` of one tree is the same number
in both packages.

Key paths are those of ``jax.tree_util.keystr``: ``['x']`` for a dict
key, ``[0]`` for a list or tuple index, ``.name`` for a NamedTuple field
and ``[<flat index i>]`` for the fields of ``core.precision.MonitorState``
(a registered pytree without keys in the reference).  ``None`` is an empty
subtree.  A tensor is hashed as its numpy copy (dtype as
``numpy.dtype.str``).
"""
from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import shutil
import struct
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.precision import MonitorState

__all__ = [
    "CheckpointCorrupt",
    "latest_step",
    "list_steps",
    "restore",
    "restore_latest_valid",
    "save",
    "save_async",
    "tree_crc32",
    "wait_pending",
]

_BLOB = "ckpt.bin.z"
_MAGIC = b"REPROTORCHCKPT1\n"
_ZLIB_LEVEL = 1  # the leaves are mostly float bits; more effort buys little

_EXEC = cf.ThreadPoolExecutor(max_workers=1)
_PENDING: Dict[str, cf.Future] = {}
_LOCK = threading.Lock()


class CheckpointCorrupt(IOError):
    """A checkpoint failed integrity verification (blob hash or tree CRC).

    Subclasses ``IOError`` so ``except IOError`` handlers keep working;
    ``restore_latest_valid`` catches it and falls back to the previous
    good step.
    """


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _rebuild(tree, leaf_fn, prefix=""):
    """``tree``'s containers with every leaf replaced by ``leaf_fn(keystr,
    leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, MonitorState):
        return MonitorState(*(
            _rebuild(getattr(tree, f), leaf_fn, f"{prefix}[<flat index {i}>]")
            for i, f in enumerate(("hist", "count", "tag"))))
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf_fn,
                                     f"{prefix}.{f}") for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, leaf_fn, f"{prefix}[{i}]")
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return leaf_fn(prefix, tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """``{keystr: host array}`` of every leaf of ``tree``."""
    flat = {}
    _rebuild(tree, lambda key, leaf: flat.__setitem__(key, _host(leaf)))
    return flat


def _flat_crc32(flat: Dict[str, np.ndarray]) -> int:
    """Canonical CRC32 of a flattened tree: key path, dtype, shape and
    bytes of each leaf, folded in sorted-key order."""
    crc = 0
    for key in sorted(flat):
        a = np.ascontiguousarray(flat[key])
        head = f"{key}|{a.dtype.str}|{a.shape}|".encode()
        crc = zlib.crc32(a.tobytes(), zlib.crc32(head, crc))
    return crc & 0xFFFFFFFF


def tree_crc32(tree: Any) -> int:
    """Canonical content CRC32 of a tree of tensors or arrays (over a host
    copy); equal to the reference package's ``tree_crc32`` on the same
    tree."""
    return _flat_crc32(_flatten(tree))


def _encode(flat: Dict[str, np.ndarray], step: int, extra: Dict) -> bytes:
    index, chunks, offset = {}, [], 0
    for key, a in flat.items():
        raw = np.ascontiguousarray(a).tobytes()
        index[key] = {"dtype": a.dtype.str, "shape": list(a.shape),
                      "offset": offset, "nbytes": len(raw)}
        chunks.append(raw)
        offset += len(raw)
    head = json.dumps({"step": step, "extra": extra, "arrays": index}
                      ).encode()
    return zlib.compress(
        b"".join([_MAGIC, struct.pack("<Q", len(head)), head, *chunks]),
        _ZLIB_LEVEL)


def _decode(comp: bytes):
    raw = zlib.decompress(comp)
    if not raw.startswith(_MAGIC):
        raise CheckpointCorrupt("not a checkpoint blob of this package")
    at = len(_MAGIC)
    (hlen,) = struct.unpack_from("<Q", raw, at)
    at += 8
    head = json.loads(raw[at:at + hlen])
    body = memoryview(raw)[at + hlen:]
    arrays = {}
    for key, d in head["arrays"].items():
        buf = body[d["offset"]:d["offset"] + d["nbytes"]]
        arrays[key] = np.frombuffer(buf, dtype=np.dtype(d["dtype"])).reshape(
            d["shape"])
    return head["step"], head["extra"], arrays


def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save(path: str, tree: Any, step: int, extra: Optional[Dict] = None
         ) -> str:
    """Synchronous atomic save; returns the checkpoint's directory."""
    flat = _flatten(tree)
    crc = _flat_crc32(flat)
    comp = _encode(flat, step, extra or {})
    digest = hashlib.sha256(comp).hexdigest()

    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    _fsync_write(os.path.join(tmp, _BLOB), comp)
    _fsync_write(os.path.join(tmp, "meta.json"), json.dumps(
        {"step": step, "sha256": digest, "bytes": len(comp),
         "tree_crc32": crc}).encode())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_async(path: str, tree: Any, step: int,
               extra: Optional[Dict] = None) -> cf.Future:
    """Double-buffered async save: waits for the previous write to
    ``path`` first (bounded memory), copies the tree to the host now, then
    hands the write to a thread."""
    with _LOCK:
        prev = _PENDING.get(path)
    if prev is not None:
        prev.result()  # at most one outstanding write a path
    host_tree = _rebuild(tree, lambda _, leaf: _host(leaf).copy())
    fut = _EXEC.submit(save, path, host_tree, step, extra)
    with _LOCK:
        _PENDING[path] = fut
    return fut


def wait_pending(path: str) -> None:
    with _LOCK:
        fut = _PENDING.get(path)
    if fut is not None:
        fut.result()


def list_steps(path: str) -> list:
    """Every completed checkpoint step under ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(path, name, "meta.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(path: str) -> Optional[int]:
    steps = list_steps(path)
    return steps[-1] if steps else None


def restore(path: str, step: int, like: Any, device=None):
    """Restore step ``step`` into the structure of ``like``.

    Returns ``(tree, step, extra)``.  Each leaf takes the dtype of the
    matching leaf of ``like``; a tensor leaf lands on ``device`` (default:
    the device of ``like``'s leaf), a numpy leaf stays on the host.
    Raises ``CheckpointCorrupt`` when the blob's sha256 or the decoded
    tree's CRC32 disagrees with ``meta.json``.
    """
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(d, _BLOB), "rb") as f:
        comp = f.read()
    if hashlib.sha256(comp).hexdigest() != meta["sha256"]:
        raise CheckpointCorrupt(f"checkpoint {d} failed integrity check")
    got, extra, arrays = _decode(comp)
    # The end-to-end content check: the CRC of the decoded leaves against
    # the one stamped at save time (the sha256 covers only the blob).
    if "tree_crc32" in meta and _flat_crc32(arrays) != meta["tree_crc32"]:
        raise CheckpointCorrupt(f"checkpoint {d} failed tree CRC32 check")

    def leaf(key, like_leaf):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        a = arrays[key]
        if tuple(a.shape) != tuple(np.shape(like_leaf)):
            raise ValueError(f"shape mismatch for {key}: ckpt {a.shape} vs "
                             f"{tuple(np.shape(like_leaf))}")
        if isinstance(like_leaf, torch.Tensor):
            t = torch.from_numpy(a.copy())
            return t.to(device=like_leaf.device if device is None
                        else device, dtype=like_leaf.dtype)
        return a.astype(np.asarray(like_leaf).dtype)

    return _rebuild(like, leaf), got, extra


def restore_latest_valid(path: str, like: Any, device=None):
    """Restore the newest checkpoint that passes verification.

    Walks the steps newest first and skips any that raise
    ``CheckpointCorrupt`` or are unreadable or mismatched: a corrupted
    latest checkpoint costs one re-run from the previous good one, never
    a crash and never silent garbage.  Returns ``(tree, step, extra,
    skipped)`` with ``skipped`` the corrupt steps passed over, or ``None``
    when no valid checkpoint exists.
    """
    skipped = []
    for step in reversed(list_steps(path)):
        try:
            tree, got, extra = restore(path, step, like, device=device)
        except (CheckpointCorrupt, OSError, KeyError, ValueError,
                zlib.error, struct.error):
            skipped.append(step)
            continue
        return tree, got, extra, skipped
    return None
