"""Observability: the metrics registry, the span tracer and the solver
flight recorder.

Port of ``repro/obs/__init__.py``:

- ``obs.metrics``: the counter/gauge/histogram registry behind
  ``PACK_STATS`` and ``SolverService.stats``, with Prometheus-text and
  JSON exposition.
- ``obs.trace``: nested wall-clock spans with attributes, written as
  schema-versioned JSONL; under a tracer each span is also a
  ``torch.profiler.record_function`` range.
- ``obs.flight``: a fixed-size ring on the solve's device, carried
  through the solver loops, one row per iteration with no host sync;
  decoded after the solve into a ``FlightLog``.
"""

from repro_torch.obs import flight, metrics, trace
from repro_torch.obs.flight import (FlightLog, FlightParams, flight_init,
                                    flight_record)
from repro_torch.obs.metrics import REGISTRY, Registry, stats_view
from repro_torch.obs.trace import Tracer, capture, span, validate_jsonl

__all__ = [
    "FlightLog",
    "FlightParams",
    "REGISTRY",
    "Registry",
    "Tracer",
    "capture",
    "flight",
    "flight_init",
    "flight_record",
    "metrics",
    "span",
    "stats_view",
    "trace",
    "validate_jsonl",
]
