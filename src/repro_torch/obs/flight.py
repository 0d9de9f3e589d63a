"""Device-side solver flight recorder.

Port of ``repro/obs/flight.py``.  A fixed-size ring kept on the solve's
device and carried through the solver loop's state.  Each iteration
appends one row: the iteration index, the recursive relative residual,
the precision tag the iteration ran at, the guard's health code after the
update, and three solver-specific values (CG/PCG: alpha, beta and the
curvature ``p.Ap``; GMRES: the Givens magnitude ``d``, the subdiagonal
``H[j+1, j]`` and 0).

Contracts, as in the reference:

* **No host sync in the loop.**  A row is written with ``torch.where``
  against an ``arange`` of the ring's slots; the slot index and the row
  count stay on the device, and nothing reaches the host before the
  decode after the solve.
* **Bit-identity.**  The recorder only observes values the iteration
  already computed; recorder-on trajectories and solutions are bitwise
  recorder-off.
* **Frozen iterations write nothing.**  The port's loops run a chunk of
  iterations and freeze the ones past the exit with ``torch.where``;
  ``flight_record(..., active=)`` then writes no row and leaves ``count``
  as it was, so ``recorded`` equals the solver's ``iters``.
* **Ring semantics.**  Row ``i`` lands at slot ``count % capacity``; once
  ``count > capacity`` the oldest rows are overwritten and the decode
  reports them as ``dropped``.

After the solve :meth:`FlightLog.from_state` decodes the ring on the host
and :func:`assert_consistent` checks it against what the solver reports
(``switch_iters``, ``trip_iter``, ``tag``, ``iters``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.robustness.guards import HEALTH_OK, health_name

__all__ = [
    "FlightLog",
    "FlightParams",
    "DEFAULT_FLIGHT",
    "COLUMNS",
    "assert_consistent",
    "flight_init",
    "flight_record",
    "pack_state_tags",
    "pack_tag_pair",
    "split_batched",
    "unpack_tag_pair",
]


@dataclasses.dataclass(frozen=True)
class FlightParams:
    """Recorder configuration.

    ``capacity`` is the ring size in rows; a row is 1 int32 iteration
    index, 2 int32 tag/health codes and 4 residual-dtype values (44 B a
    row at f64), so the default 1024-row ring takes 44 KiB of device
    memory a solve.
    """
    capacity: int = 1024

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")


DEFAULT_FLIGHT = FlightParams()

# Per-row columns, in decode order.  "it" is -1 on never-written slots.
COLUMNS = ("it", "relres", "tag", "health", "a0", "a1", "a2")

# On-device layout: two row-major buffers, ``ibuf`` (cap, 3) int32 [it,
# tag, health] and ``fbuf`` (cap, 4) residual-dtype [relres, a0, a1, a2],
# so appending a row is two masked writes, not one per column.
_ICOLS = ("it", "tag", "health")
_FCOLS = ("relres", "a0", "a1", "a2")


def check_flight(flight) -> None:
    """Refuse a ``flight=`` that is neither ``None`` nor ``FlightParams``."""
    if flight is not None and not isinstance(flight, FlightParams):
        raise TypeError(f"flight= takes a FlightParams or None, got "
                        f"{type(flight).__name__}")


def flight_init(params: FlightParams, dtype=torch.float64, device="cuda",
                batch: int | None = None) -> dict:
    """A fresh recorder state on ``device``: an empty ring and its row
    count.  ``batch`` stacks one ring per column along a leading axis (the
    batched solvers' layout)."""
    cap = params.capacity
    lead = () if batch is None else (batch,)
    ibuf = torch.zeros(*lead, cap, len(_ICOLS), dtype=torch.int32,
                       device=device)
    ibuf[..., 0] = -1  # it = -1 marks never-written slots
    return {
        "ibuf": ibuf,
        "fbuf": torch.zeros(*lead, cap, len(_FCOLS), dtype=dtype,
                            device=device),
        "count": torch.zeros(lead, dtype=torch.int32, device=device),
    }


def flight_record(fs, *, it, relres, tag, health=None, a0=None, a1=None,
                  a2=None, active=None) -> dict:
    """Append one row (one row per column of a batched ring) without a
    host sync and without feeding anything back into the solver state.

    Every value is a tensor on the ring's device (or a Python number), of
    the ring's leading shape: ``()`` for one ring, ``(nrhs,)`` for a
    batched one.  ``active`` (a bool of that shape) gates the write: where
    it is false no row is written and ``count`` stays.
    """
    ibuf, fbuf, count = fs["ibuf"], fs["fbuf"], fs["count"]
    cap = ibuf.shape[-2]
    dev, dtype = fbuf.device, fbuf.dtype
    lead = tuple(count.shape)

    def col(v, dt):
        if isinstance(v, torch.Tensor):
            return v.to(dt).expand(lead)
        # A fill on the device: ``as_tensor`` of a host number would copy
        # it to the card and wait for the stream.
        return torch.full(lead, 0 if v is None else v, dtype=dt, device=dev)

    irow = torch.stack([col(it, torch.int32), col(tag, torch.int32),
                        col(HEALTH_OK if health is None else health,
                            torch.int32)], dim=-1)
    frow = torch.stack([col(relres, dtype), col(a0, dtype), col(a1, dtype),
                        col(a2, dtype)], dim=-1)
    hit = torch.arange(cap, device=dev) == (count % cap).unsqueeze(-1)
    if active is None:
        step = 1
    else:
        active = active.expand(lead)
        hit = hit & active.unsqueeze(-1)
        step = active.to(torch.int32)
    hit = hit.unsqueeze(-1)
    return {
        "ibuf": torch.where(hit, irow.unsqueeze(-2), ibuf),
        "fbuf": torch.where(hit, frow.unsqueeze(-2), fbuf),
        "count": count + step,
    }


# -- per-group tag pairs ------------------------------------------------------
#
# A per-group TagMap run has no single tag: the int32 tag cell carries the
# active (min, max) pair, bit-packed.  A uniform pair (lo == hi) stores the
# plain tag; a non-uniform pair stores ``lo | (hi << 4)``, at least 33 and
# so disjoint from the plain tags (at most 3): the decode threshold
# ``_TAG_PACK_BASE`` is unambiguous.
_TAG_PACK_BASE = 8


def pack_tag_pair(lo: int, hi: int) -> int:
    """Bit-pack an active (min, max) tag pair into one int32 tag cell."""
    lo, hi = int(lo), int(hi)
    if not (1 <= lo <= hi <= 3):
        raise ValueError(f"tag pair must satisfy 1 <= lo <= hi <= 3, "
                         f"got ({lo}, {hi})")
    return lo if lo == hi else (lo | (hi << 4))


def unpack_tag_pair(v):
    """Inverse of :func:`pack_tag_pair`, vectorized: ``(lo, hi)`` arrays."""
    v = np.asarray(v)
    packed = v >= _TAG_PACK_BASE
    hi = np.where(packed, v >> 4, v)
    lo = np.where(packed, v & 0xF, v)
    return lo, hi


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def pack_state_tags(fs, lo: int, hi: int) -> dict:
    """Restamp the written rows' tag cells of a per-group (TagMap) run with
    the packed (min, max) pair, once, after the solve.

    The loop wrote the masked operand's decode tag (the map's max);
    unwritten slots (it == -1) stay as they are.  Returns host (numpy)
    buffers, as the reference does.
    """
    packed = pack_tag_pair(lo, hi)
    ibuf = np.array(_host(fs["ibuf"]))
    ibuf[ibuf[:, 0] >= 0, 1] = packed
    return {"ibuf": ibuf, "fbuf": _host(fs["fbuf"]),
            "count": _host(fs["count"])}


def split_batched(fs) -> list[dict]:
    """Split a stacked per-column flight state (leading nrhs axis, as the
    batched solvers return it) into one state dict per column."""
    nrhs = int(_host(fs["count"]).shape[0])
    return [{k: fs[k][j] for k in ("ibuf", "fbuf", "count")}
            for j in range(nrhs)]


@dataclasses.dataclass
class FlightLog:
    """Host-side decoded flight recording, rows ordered oldest -> newest."""

    it: np.ndarray
    relres: np.ndarray
    tag: np.ndarray
    health: np.ndarray
    a0: np.ndarray
    a1: np.ndarray
    a2: np.ndarray
    capacity: int
    recorded: int   # rows ever written (may exceed capacity)
    dropped: int    # rows overwritten by the ring
    # Per-group runs: the min tag of the active (min, max) pair; equals
    # ``tag`` on uniform recordings.
    tag_min: np.ndarray | None = None

    @classmethod
    def from_state(cls, fs) -> "FlightLog":
        """Decode a recorder state (one host copy, after the solve).

        A tag cell may carry a bit-packed (min, max) pair (per-group runs;
        see :func:`pack_tag_pair`): ``tag`` decodes to the pair's max and
        the min lands on :attr:`tag_min`.
        """
        ibuf, fbuf = _host(fs["ibuf"]), _host(fs["fbuf"])
        count = int(_host(fs["count"]))
        cap = ibuf.shape[0]
        if count <= cap:
            ibuf, fbuf = ibuf[:count], fbuf[:count]
        else:
            # The ring wrapped: slot (count % cap) holds the oldest row.
            shift = count % cap
            ibuf = np.roll(ibuf, -shift, axis=0)
            fbuf = np.roll(fbuf, -shift, axis=0)
        cols = {c: ibuf[:, i].copy() for i, c in enumerate(_ICOLS)}
        cols.update({c: fbuf[:, i].copy() for i, c in enumerate(_FCOLS)})
        lo, hi = unpack_tag_pair(cols["tag"])
        cols["tag"] = hi.astype(np.int32)
        return cls(**cols, capacity=cap, recorded=count,
                   dropped=max(count - cap, 0),
                   tag_min=lo.astype(np.int32))

    def __len__(self) -> int:
        return int(self.it.shape[0])

    def to_rows(self) -> list[dict]:
        return [
            {col: getattr(self, col)[i].item() for col in COLUMNS}
            for i in range(len(self))
        ]

    def switch_iters(self) -> np.ndarray:
        """The (2,) switch-iteration vector derived from the tag column:
        the first row at tag ``k`` carries the iteration the monitor
        recorded as the switch to ``k`` (-1: the tag never appears)."""
        out = np.full((2,), -1, np.int64)
        for slot, k in ((0, 2), (1, 3)):
            hits = np.nonzero(self.tag == k)[0]
            if hits.size:
                out[slot] = int(self.it[hits[0]])
        return out

    def switch_visible(self, k: int) -> bool:
        """True when the window provably holds the switch to tag ``k``:
        no row was dropped, or a row at a tag below ``k`` precedes the
        first tag-``k`` row inside the window."""
        hits = np.nonzero(self.tag == k)[0]
        if not hits.size:
            return self.dropped == 0
        if self.dropped == 0:
            return True
        return bool(np.any(self.tag[: hits[0]] < k))

    def first_unhealthy(self) -> int:
        """Iteration of the first row with health != ok (-1: none)."""
        bad = np.nonzero(self.health != HEALTH_OK)[0]
        return int(self.it[bad[0]]) if bad.size else -1

    def summary(self) -> dict:
        last = len(self) - 1
        return {
            "rows": len(self),
            "recorded": self.recorded,
            "dropped": self.dropped,
            "first_it": int(self.it[0]) if len(self) else -1,
            "last_it": int(self.it[last]) if len(self) else -1,
            "last_relres": float(self.relres[last]) if len(self) else None,
            "last_tag": int(self.tag[last]) if len(self) else 0,
            "last_tag_min": (int(self.tag_min[last])
                             if len(self) and self.tag_min is not None
                             else (int(self.tag[last]) if len(self) else 0)),
            "switch_iters": self.switch_iters().tolist(),
            "first_unhealthy": self.first_unhealthy(),
            "health_counts": {
                health_name(code): int(n)
                for code, n in zip(*np.unique(self.health,
                                              return_counts=True))
            } if len(self) else {},
        }

    def pretty(self, max_rows: int = 12) -> str:
        """Human-readable table (head and tail when the log is long)."""
        header = f"{'it':>6} {'tag':>3} {'health':>9} {'relres':>12}  a0/a1/a2"
        lines = [header]
        n = len(self)
        idx = (list(range(n)) if n <= max_rows
               else list(range(max_rows // 2)) + [None]
               + list(range(n - max_rows // 2, n)))
        for i in idx:
            if i is None:
                lines.append(f"{'...':>6}")
                continue
            lines.append(
                f"{int(self.it[i]):>6} {int(self.tag[i]):>3} "
                f"{health_name(self.health[i]):>9} "
                f"{float(self.relres[i]):>12.3e}  "
                f"{float(self.a0[i]):.3e}/{float(self.a1[i]):.3e}/"
                f"{float(self.a2[i]):.3e}"
            )
        if self.dropped:
            lines.append(f"({self.dropped} older rows dropped by the ring)")
        return "\n".join(lines)


def assert_consistent(log: FlightLog, res, *, is_recovered: bool = False):
    """Assert the flight telemetry matches the solver's own report.

    ``res`` is any result carrying ``iters``/``tag``/``switch_iters``/
    ``health``/``trip_iter``.  After a recovery restart the ring covers
    only the final segment: pass ``is_recovered=True`` to skip the
    whole-trajectory checks.  Raises ``AssertionError`` on a mismatch.
    """
    iters = int(_host(res.iters))
    if iters == 0:
        assert len(log) == 0, (
            f"flight: {len(log)} rows recorded for a 0-iteration solve"
        )
        return

    assert len(log) > 0, "flight: no rows recorded for a non-trivial solve"
    assert log.recorded >= len(log)

    # Row indices: one row per iteration, 0-based, contiguous.
    its = log.it.astype(np.int64)
    assert np.all(np.diff(its) == 1), (
        f"flight: iteration column not contiguous: {its[:8]}..."
    )

    sw = _host(res.switch_iters).astype(np.int64)
    if not is_recovered:
        assert log.recorded == iters, (
            f"flight: recorded {log.recorded} rows, solver ran {iters}"
        )
        assert int(its[-1]) == iters - 1, (
            f"flight: last row it={int(its[-1])}, expected {iters - 1}"
        )

        # The first row at tag k sits at the monitor's switch iteration.
        derived = log.switch_iters()
        for slot, k in ((0, 2), (1, 3)):
            if not log.switch_visible(k):
                continue  # the ring dropped the switch row
            if sw[slot] < 0:
                # Never switched to k: an init_tag >= k start shows tag-k
                # rows from iteration 0 without a switch.
                if derived[slot] >= 0:
                    assert int(its[0]) == derived[slot] and log.tag[0] >= k, (
                        f"flight: tag {k} appears at it={derived[slot]} but "
                        f"monitor never recorded the switch"
                    )
            else:
                assert derived[slot] == sw[slot], (
                    f"flight: first tag-{k} row at it={derived[slot]}, "
                    f"monitor switch_iters[{slot}]={sw[slot]}"
                )

        # The first unhealthy row is the guard's trip.
        trip = int(_host(res.trip_iter))
        health = int(_host(res.health))
        first_bad = log.first_unhealthy()
        if trip >= 0 and health != HEALTH_OK:
            assert first_bad == trip, (
                f"flight: first unhealthy row at it={first_bad}, guard "
                f"trip_iter={trip}"
            )
        if first_bad < 0 and log.dropped == 0:
            assert trip < 0 or health == HEALTH_OK, (
                f"flight: all rows healthy but trip_iter={trip}"
            )

    # The last row carries the tag the final iteration ran at; res.tag is
    # the monitor's tag after it, one step ahead iff that iteration
    # switched.
    final_tag = int(_host(res.tag))
    last_tag = int(log.tag[-1])
    stepped_at_exit = bool(np.any(sw == iters))
    if not is_recovered:
        expect = last_tag + (1 if stepped_at_exit else 0)
        assert final_tag == expect, (
            f"flight: last row tag={last_tag} (switch-at-exit="
            f"{stepped_at_exit}), solver final tag={final_tag}"
        )

    # Tags only step up.
    assert np.all(np.diff(log.tag) >= 0), "flight: tag column decreased"
