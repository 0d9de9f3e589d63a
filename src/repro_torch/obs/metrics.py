"""Metrics registry: counters, gauges and histograms with labels.

Port of ``repro/obs/metrics.py``, the port's own copy (pure Python).
``PACK_STATS`` (``kernels/ops.py``) and ``SolverService.stats`` are
dict-shaped views (:func:`stats_view`) over labeled counters registered
here, so every number the port produces shows through one exposition
surface: :meth:`Registry.to_prometheus` (Prometheus text format) and
:meth:`Registry.to_json`.  Metric names, help strings and label names are
the reference's, and so is the exposition, byte for byte.

All mutation goes through a registry-wide lock so the serving path can
update counters from worker threads.
"""

from __future__ import annotations

import json
import math
import threading
from collections import OrderedDict, deque
from collections.abc import MutableMapping
from typing import Iterator, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "REGISTRY",
    "Registry",
    "StatsView",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_BYTE_BUCKETS",
    "stats_view",
]

# Seconds-scale buckets: microseconds (fast kernels) through tens of seconds
# (first-call compiles on CPU interpret mode).
DEFAULT_TIME_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    float("inf"),
)

# Bytes-scale buckets: a single packed group through multi-GB operands.
DEFAULT_BYTE_BUCKETS = (
    64.0, 256.0, 1e3, 4e3, 16e3, 64e3, 256e3, 1e6, 4e6, 16e6, 64e6,
    256e6, 1e9, float("inf"),
)

# Histograms keep a bounded reservoir of recent observations so quantiles
# (p50/p95/p99) come from real samples rather than bucket interpolation.
_SAMPLE_WINDOW = 4096


def _check_label_values(labelnames: tuple[str, ...], kw: dict) -> tuple:
    if set(kw) != set(labelnames):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(sorted(kw))}"
        )
    return tuple(str(kw[name]) for name in labelnames)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
    return str(v)


class _Child:
    """One labeled series of a metric family."""

    def __init__(self, metric: "_Metric", labelvalues: tuple):
        self._metric = metric
        self._lock = metric._registry._lock
        self.labelvalues = labelvalues

    @property
    def labels_dict(self) -> dict:
        return dict(zip(self._metric.labelnames, self.labelvalues))


class Counter(_Child):
    def __init__(self, metric, labelvalues):
        super().__init__(metric, labelvalues)
        self.value = 0

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount

    def set(self, value):
        """Back-compat escape hatch for dict-view assignment (e.g. the tune
        cache's ``reset()`` zeroing its stats); not part of the Prometheus
        counter contract."""
        with self._lock:
            self.value = value

    def _zero(self):
        self.value = 0


class Gauge(_Child):
    def __init__(self, metric, labelvalues):
        super().__init__(metric, labelvalues)
        self.value = 0

    def set(self, value):
        with self._lock:
            self.value = value

    def inc(self, amount=1):
        with self._lock:
            self.value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    def _zero(self):
        self.value = 0


class Histogram(_Child):
    def __init__(self, metric, labelvalues):
        super().__init__(metric, labelvalues)
        self.buckets = metric.buckets
        self._zero()

    def _zero(self):
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0
        self.samples = deque(maxlen=_SAMPLE_WINDOW)

    def observe(self, value):
        value = float(value)
        with self._lock:
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[i] += 1
            self.sum += value
            self.count += 1
            self.samples.append(value)

    def quantile(self, q: float):
        """Quantile over the recent-sample reservoir; None when empty."""
        with self._lock:
            ordered = sorted(self.samples)
        if not ordered:
            return None
        idx = max(0, min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1))
        return ordered[idx]

    def summary(self) -> dict:
        with self._lock:
            n, s = self.count, self.sum
            ordered = sorted(self.samples)
        out = {"count": n, "sum": s}
        out["mean"] = (s / n) if n else None
        for name, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            if ordered:
                idx = max(0, min(len(ordered) - 1,
                                 math.ceil(q * len(ordered)) - 1))
                out[name] = ordered[idx]
            else:
                out[name] = None
        out["min"] = ordered[0] if ordered else None
        out["max"] = ordered[-1] if ordered else None
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Metric:
    """A named family of series sharing a kind, help string and label set."""

    def __init__(self, registry, kind, name, help, labelnames,
                 buckets=None):
        self._registry = registry
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self._children: OrderedDict[tuple, _Child] = OrderedDict()

    def labels(self, **kw) -> _Child:
        values = _check_label_values(self.labelnames, kw)
        with self._registry._lock:
            child = self._children.get(values)
            if child is None:
                child = _KINDS[self.kind](self, values)
                self._children[values] = child
        return child

    def _default(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"metric {self.name!r} has labels {self.labelnames}; "
                "use .labels(...)"
            )
        return self.labels()

    # Convenience passthroughs for unlabeled metrics.
    def inc(self, amount=1):
        self._default().inc(amount)

    def set(self, value):
        self._default().set(value)

    def dec(self, amount=1):
        self._default().dec(amount)

    def observe(self, value):
        self._default().observe(value)

    @property
    def value(self):
        return self._default().value

    def summary(self):
        return self._default().summary()


class Registry:
    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: OrderedDict[str, _Metric] = OrderedDict()

    def _register(self, kind, name, help, labelnames, buckets=None):
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind or existing.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}"
                    )
                if help and not existing.help:
                    existing.help = help
                return existing
            metric = _Metric(self, kind, name, help, labelnames, buckets)
            self._metrics[name] = metric
            return metric

    def counter(self, name, help="", labelnames=()):
        return self._register("counter", name, help, labelnames)

    def gauge(self, name, help="", labelnames=()):
        return self._register("gauge", name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_TIME_BUCKETS):
        return self._register("histogram", name, help, labelnames, buckets)

    def get(self, name) -> _Metric | None:
        return self._metrics.get(name)

    def reset(self):
        """Zero every series; registrations (and dict views) stay alive."""
        with self._lock:
            for metric in self._metrics.values():
                for child in metric._children.values():
                    child._zero()

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            metrics = [
                (m, list(m._children.items()))
                for m in self._metrics.values()
            ]
        for metric, children in metrics:
            if not children:
                continue
            if metric.help:
                lines.append(f"# HELP {metric.name} {metric.help}")
            lines.append(f"# TYPE {metric.name} {metric.kind}")
            for values, child in children:
                pairs = [
                    f'{k}="{_escape_label(v)}"'
                    for k, v in zip(metric.labelnames, values)
                ]
                if metric.kind == "histogram":
                    for bound, count in zip(child.buckets, child.counts):
                        bpairs = pairs + [f'le="{_fmt_value(float(bound))}"']
                        lines.append(
                            f"{metric.name}_bucket{{{','.join(bpairs)}}} "
                            f"{count}"
                        )
                    label = f"{{{','.join(pairs)}}}" if pairs else ""
                    lines.append(
                        f"{metric.name}_sum{label} {_fmt_value(child.sum)}"
                    )
                    lines.append(f"{metric.name}_count{label} {child.count}")
                else:
                    label = f"{{{','.join(pairs)}}}" if pairs else ""
                    lines.append(
                        f"{metric.name}{label} {_fmt_value(child.value)}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def to_json(self) -> dict:
        """JSON exposition: one object per family, one entry per series."""
        out = {"schema": 1, "metrics": []}
        with self._lock:
            metrics = [
                (m, list(m._children.items()))
                for m in self._metrics.values()
            ]
        for metric, children in metrics:
            fam = {
                "name": metric.name,
                "type": metric.kind,
                "help": metric.help,
                "series": [],
            }
            for values, child in children:
                labels = dict(zip(metric.labelnames, values))
                if metric.kind == "histogram":
                    entry = {"labels": labels, **child.summary()}
                else:
                    entry = {"labels": labels, "value": child.value}
                fam["series"].append(entry)
            out["metrics"].append(fam)
        return out

    def to_json_text(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=False)


REGISTRY = Registry()


class StatsView(MutableMapping):
    """Dict-shaped view over one family of labeled counters.

    Keeps the historical ``STATS["hits"] += 1`` call sites (and the tests
    that read them) working unchanged while the storage lives in the
    registry.  ``dict(view)``, iteration, ``len``, item assignment (used by
    cache ``reset()`` helpers) and membership all behave like the plain
    dicts they replace.
    """

    def __init__(self, metric: _Metric, keys: Sequence[str],
                 label: str, const: dict | None = None):
        self._metric = metric
        self._label = label
        self._const = dict(const or {})
        self._children: "OrderedDict[str, Counter]" = OrderedDict()
        for key in keys:
            self._children[key] = metric.labels(**self._const,
                                                **{label: key})

    def _child(self, key: str) -> Counter:
        child = self._children.get(key)
        if child is None:
            child = self._metric.labels(**self._const, **{self._label: key})
            self._children[key] = child
        return child

    def __getitem__(self, key):
        if key not in self._children:
            raise KeyError(key)
        return self._children[key].value

    def __setitem__(self, key, value):
        self._child(key).set(value)

    def __delitem__(self, key):
        raise TypeError("StatsView keys are fixed; set the value to 0")

    def __iter__(self) -> Iterator[str]:
        return iter(self._children)

    def __len__(self) -> int:
        return len(self._children)

    def __contains__(self, key) -> bool:
        return key in self._children

    def __repr__(self) -> str:
        return repr({k: c.value for k, c in self._children.items()})


def stats_view(name, keys, help="", label="event", const=None,
               registry=None) -> StatsView:
    """Register (idempotently) a counter family and return a dict view.

    ``const`` adds fixed labels to every series in the view — e.g. a
    per-service-instance id so two ``SolverService`` objects don't share
    counters.
    """
    registry = registry or REGISTRY
    labelnames = tuple(const or ()) + (label,)
    metric = registry.counter(name, help, labelnames=labelnames)
    return StatsView(metric, keys, label, const)
