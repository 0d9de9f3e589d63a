"""Per-handle circuit breaker for the async solve service.

Port of ``repro/serve/breaker.py`` (:34-128), host code copied as it is.
A handle whose solves keep guard-tripping (a poisoned operand, a fault
injector, an operator that NaNs at its serving tag) should stop burning
batch slots: after ``fail_threshold`` consecutive guard-tripped
failures the breaker OPENS and the service sheds submissions against
the handle with a typed response carrying ``retry_after_s``.  After a
backoff the breaker HALF-OPENS: exactly one probe request is admitted;
its outcome closes the breaker (success) or re-opens it with the
backoff doubled (failure), up to ``max_backoff_s``.

The backoff carries seeded jitter (``numpy.random.default_rng``, as the
reference draws it) so a fleet of clients shedding against the same
handle doesn't re-probe in lockstep, while replays stay deterministic.
The clock is injectable: tests drive transitions with a fake clock
instead of sleeping, and the transitions are the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

__all__ = ["BreakerParams", "CircuitBreaker"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass(frozen=True)
class BreakerParams:
    fail_threshold: int = 3     # consecutive failures before opening
    backoff_s: float = 0.5      # first open -> half-open delay
    backoff_mult: float = 2.0   # growth per re-open from half-open
    max_backoff_s: float = 30.0
    jitter: float = 0.1         # +- fraction of the backoff, seeded


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN state machine, one per handle."""

    def __init__(self, params: BreakerParams | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 seed: int = 0):
        self.params = params or BreakerParams()
        self.clock = clock
        self._rng = np.random.default_rng(seed)
        self.state = CLOSED
        self.fails = 0          # consecutive failures while closed
        self.opened_at = 0.0
        self.backoff = self.params.backoff_s
        self._wait = 0.0        # jittered backoff for the current open
        self._probing = False   # half-open: one probe in flight
        self.transitions = []   # (state, t) log for tests/telemetry

    def _jittered(self, base: float) -> float:
        j = self.params.jitter
        return base * float(1.0 + self._rng.uniform(-j, j)) if j else base

    def _to(self, state: str) -> None:
        self.state = state
        self.transitions.append((state, self.clock()))

    def allow(self) -> bool:
        """May a request against this handle be admitted right now?

        While OPEN, flips to HALF_OPEN once the jittered backoff has
        elapsed and admits exactly ONE probe; further calls return False
        until that probe's outcome is recorded.
        """
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.clock() - self.opened_at >= self._wait:
                self._to(HALF_OPEN)
                self._probing = True
                return True
            return False
        # HALF_OPEN: one probe at a time.
        if not self._probing:
            self._probing = True
            return True
        return False

    def retry_after(self) -> float:
        """Seconds until the next admission attempt could succeed
        (0 when not OPEN) -- what the shed response carries."""
        if self.state != OPEN:
            return 0.0
        return max(0.0, self._wait - (self.clock() - self.opened_at))

    def release(self) -> None:
        """Give back an ``allow()`` admission that never dispatched (the
        request was rejected downstream) -- without this a half-open
        breaker's single probe slot would leak and jam the handle."""
        self._probing = False

    def record_success(self) -> None:
        """A request against the handle finished healthy."""
        self.fails = 0
        if self.state != CLOSED:
            self.backoff = self.params.backoff_s  # full reset on recovery
            self._to(CLOSED)
        self._probing = False

    def record_failure(self) -> None:
        """A request against the handle guard-tripped (health != ok)."""
        self._probing = False
        if self.state == HALF_OPEN:
            # The probe failed: re-open with the backoff escalated.
            self.backoff = min(self.backoff * self.params.backoff_mult,
                               self.params.max_backoff_s)
            self._open()
            return
        if self.state == OPEN:
            return
        self.fails += 1
        if self.fails >= self.params.fail_threshold:
            self._open()

    def _open(self) -> None:
        self.opened_at = self.clock()
        self._wait = self._jittered(self.backoff)
        self.fails = 0
        self._to(OPEN)
