"""Span tracer: nested wall-clock spans written as schema-versioned JSONL.

Port of ``repro/obs/trace.py`` (schema v1, field for field).  A
:class:`Tracer` records a tree of named spans (pack builds, solves,
service flushes) with free-form attribute dicts.  One JSON object per
line; every event carries ``"v": SCHEMA_VERSION`` so consumers can reject
what they do not understand, and :func:`validate_jsonl` is the schema
check.

When no tracer is installed, :func:`span` is a no-op that touches
nothing of torch, so instrumented call sites cost nothing.  Under an
installed tracer each span also opens ``torch.profiler.record_function``
with its name, so the names reach torch's profiler (and the CUDA ranges
Nsight shows) around the kernels the span launched.

A span is timed on the host: ``dur_s`` runs from entering the block to
leaving it.  CUDA launches are asynchronous, so on the card ``dur_s``
covers the device work only up to the last host sync inside the block;
the solver loops sync once per chunk of iterations and once at the end
(their results are read on the host), so a solve span ends after its
last chunk's work has finished.  No span adds a sync of its own.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

__all__ = [
    "SCHEMA_VERSION",
    "Tracer",
    "active",
    "annotate",
    "capture",
    "current",
    "event",
    "install",
    "span",
    "uninstall",
    "validate_event",
    "validate_jsonl",
]

SCHEMA_VERSION = 1

# torch.profiler.record_function forwards span names into device profiles;
# imported on first use so that importing this module loads no torch.
_PROFILER_ANNOTATION = None


def _profiler_annotation():
    global _PROFILER_ANNOTATION
    if _PROFILER_ANNOTATION is None:
        try:
            from torch.profiler import record_function
            _PROFILER_ANNOTATION = record_function
        except Exception:  # pragma: no cover - profiler unavailable
            _PROFILER_ANNOTATION = False
    return _PROFILER_ANNOTATION or None


class Tracer:
    """Collects span/event records; thread-safe append, per-thread nesting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self.events: list[dict] = []

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Record a nested span; yields the attrs dict for late annotation."""
        stack = self._stack()
        rec = {
            "v": SCHEMA_VERSION,
            "kind": "span",
            "name": str(name),
            "id": self._new_id(),
            "parent": stack[-1]["id"] if stack else None,
            "depth": len(stack),
            "t0": time.time(),
            "dur_s": 0.0,
            "attrs": dict(attrs),
        }
        stack.append(rec)
        annotation_cls = _profiler_annotation()
        ctx = annotation_cls(rec["name"]) if annotation_cls else None
        start = time.perf_counter()
        try:
            if ctx is not None:
                with ctx:
                    yield rec["attrs"]
            else:
                yield rec["attrs"]
        finally:
            rec["dur_s"] = time.perf_counter() - start
            stack.pop()
            with self._lock:
                self.events.append(rec)

    def event(self, name: str, **attrs):
        """Record an instantaneous (zero-duration) event."""
        stack = self._stack()
        rec = {
            "v": SCHEMA_VERSION,
            "kind": "event",
            "name": str(name),
            "id": self._new_id(),
            "parent": stack[-1]["id"] if stack else None,
            "depth": len(stack),
            "t0": time.time(),
            "dur_s": 0.0,
            "attrs": dict(attrs),
        }
        with self._lock:
            self.events.append(rec)
        return rec

    def annotate(self, **attrs):
        """Merge attrs into the innermost open span (no-op at top level)."""
        stack = self._stack()
        if stack:
            stack[-1]["attrs"].update(attrs)

    def write_jsonl(self, path) -> int:
        """Write one event per line, oldest first; returns the line count."""
        with self._lock:
            events = list(self.events)
        events.sort(key=lambda e: e["id"])
        with open(path, "w") as fh:
            for rec in events:
                fh.write(json.dumps(rec, sort_keys=False) + "\n")
        return len(events)


# -- module-level installed tracer --------------------------------------

_INSTALLED: Tracer | None = None


def install(tracer: Tracer) -> Tracer:
    global _INSTALLED
    _INSTALLED = tracer
    return tracer


def uninstall() -> None:
    global _INSTALLED
    _INSTALLED = None


def current() -> Tracer | None:
    return _INSTALLED


def active() -> bool:
    return _INSTALLED is not None


_NULL_ATTRS: dict = {}


@contextlib.contextmanager
def span(name: str, **attrs):
    """Span on the installed tracer; near-free no-op when none is active."""
    tracer = _INSTALLED
    if tracer is None:
        yield _NULL_ATTRS
        return
    with tracer.span(name, **attrs) as a:
        yield a


def event(name: str, **attrs):
    tracer = _INSTALLED
    if tracer is not None:
        tracer.event(name, **attrs)


def annotate(**attrs):
    tracer = _INSTALLED
    if tracer is not None:
        tracer.annotate(**attrs)


@contextlib.contextmanager
def capture(path=None):
    """Install a fresh tracer for the block; optionally write JSONL after."""
    tracer = Tracer()
    prev = _INSTALLED
    install(tracer)
    try:
        yield tracer
    finally:
        install(prev) if prev is not None else uninstall()
        if path is not None:
            tracer.write_jsonl(path)


# -- schema validation ---------------------------------------------------

_REQUIRED_FIELDS = {
    "v": int,
    "kind": str,
    "name": str,
    "id": int,
    "depth": int,
    "t0": (int, float),
    "dur_s": (int, float),
    "attrs": dict,
}
_KINDS = ("span", "event")


def validate_event(rec) -> None:
    """Raise ValueError if ``rec`` is not a valid v1 trace event."""
    if not isinstance(rec, dict):
        raise ValueError(f"event must be an object, got {type(rec).__name__}")
    for field, types in _REQUIRED_FIELDS.items():
        if field not in rec:
            raise ValueError(f"missing field {field!r}")
        if not isinstance(rec[field], types):
            raise ValueError(
                f"field {field!r} has type {type(rec[field]).__name__}"
            )
        if field in ("v", "id", "depth") and isinstance(rec[field], bool):
            raise ValueError(f"field {field!r} must be an int, got bool")
    if rec["v"] != SCHEMA_VERSION:
        raise ValueError(f"unsupported schema version {rec['v']}")
    if rec["kind"] not in _KINDS:
        raise ValueError(f"unknown kind {rec['kind']!r}")
    if "parent" not in rec:
        raise ValueError("missing field 'parent'")
    if rec["parent"] is not None and not isinstance(rec["parent"], int):
        raise ValueError("field 'parent' must be int or null")
    if rec["dur_s"] < 0:
        raise ValueError("negative dur_s")
    if rec["depth"] < 0:
        raise ValueError("negative depth")
    for key in rec["attrs"]:
        if not isinstance(key, str):
            raise ValueError("attrs keys must be strings")


def validate_jsonl(path) -> int:
    """Validate every line of a JSONL trace; returns the event count.

    Also checks referential integrity: a span's ``parent`` (when set) must
    be the id of some event in the file.
    """
    count = 0
    ids: set[int] = set()
    parents: list[tuple[int, int]] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}:{lineno}: bad JSON: {exc}") from exc
            try:
                validate_event(rec)
            except ValueError as exc:
                raise ValueError(f"{path}:{lineno}: {exc}") from exc
            ids.add(rec["id"])
            if rec["parent"] is not None:
                parents.append((lineno, rec["parent"]))
            count += 1
    for lineno, parent in parents:
        if parent not in ids:
            raise ValueError(f"{path}:{lineno}: dangling parent id {parent}")
    return count
