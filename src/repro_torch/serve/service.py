"""Resilient async solve service: chunked dispatch with admission control.

Port of ``repro/serve/service.py``: ``Accepted``, ``Shed``, ``_Group`` and
``_dwell_params`` (:75-120) and ``AsyncSolveService`` (:122-613).

``launch.solver_serve.SolverService`` buckets requests and flushes
synchronously: a flush runs each batched solve to completion, so a new
request waits for the whole previous batch, a straggler column holds
every report hostage, and a deadline is checked only afterwards.
:class:`AsyncSolveService` keeps the same registration, validation and
byte accounting (it subclasses the synchronous service) and runs them on
chunked solves (``serve.chunked``):

  * continuous batching -- a request joins a running batched solve at the
    next chunk boundary (``BatchedChunks.join``); the running columns are
    bitwise an uninterrupted run, and the joined column is bitwise a solo
    solve started at its join point;
  * admission control -- a bounded intake queue and a per-handle circuit
    breaker (``serve.breaker``); an over-capacity or open-breaker
    submission returns a typed :class:`Shed` (reason and
    ``retry_after_s``) instead of queueing or raising;
  * deadlines mid-solve -- ``deadline_s`` is checked at every chunk
    boundary; an expired request returns its current iterate flagged
    (``deadline_exceeded=True``, ``health="deadline"``), never dropped.
    The deadline also picks the monitor's dwell class at admission;
  * warm starts -- a small LRU of converged solutions keyed by (handle,
    CRC32 of ``b``) seeds ``x0`` for a repeated right-hand side;
  * pack integrity -- a ``GSECSR`` handle's segments are CRC-stamped at
    registration and verified before a new group dispatches against
    them; a corrupt pack is detected, counted and repacked
    (``pack_csr``) from the registration CSR.

A request runs exactly the operations of a solo solve: its column of the
batched loop is bitwise ``solve_cg`` on its ``b`` (kernel C64's column
is A64's, the column dots and updates the solo ones), and chunk
boundaries, joins, drops, deadlines and checkpoints change no bit of any
trajectory.  Execution is a cooperative single-threaded pump: ``pump()``
admits queued requests, runs ONE chunk of every group, then settles the
boundaries; ``run_until_idle()`` pumps until the queue and the groups
drain.  Clocks are injectable, so a fake clock replays the reference's
transitions exactly.

Telemetry is the reference's: ``sheds``, ``warm`` and ``pack_faults``
are dict views over ``repro_serve_shed_total``, ``repro_serve_warm_total``
and ``repro_serve_pack_faults_total``, beside ``repro_serve_chunks_total``,
the ``repro_serve_queue_wait_seconds`` and
``repro_serve_solve_latency_seconds`` histograms and the per-handle
``repro_serve_breaker_open`` gauge; ``pump`` runs inside the
``serve.pump`` span and observes the inherited flush-latency histogram.
The reference serves a sharded handle's partition over its halo wire;
the port serves the packed operand (or the ``operator=`` override) over
the single-device ``"exact"`` wire until ROADMAP queue 1 item 15.
"""
from __future__ import annotations

import dataclasses
import time
import zlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from repro_torch.core import precision as P
from repro_torch.launch.solver_serve import (
    SolveReport,
    SolveRequest,
    SolverService,
    _finite,
    _tags_token,
)
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.robustness import faults as F
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    HEALTH_NONFINITE,
    HEALTH_OK,
    GuardParams,
    health_name,
)
from repro_torch.serve.breaker import OPEN, BreakerParams, CircuitBreaker
from repro_torch.serve.chunked import BatchedChunks
from repro_torch.solvers.cg import solve_cg, solve_pcg
from repro_torch.sparse.csr import GSECSR, pack_csr

__all__ = ["Accepted", "Shed", "AsyncSolveService"]


@dataclasses.dataclass(frozen=True)
class Accepted:
    """Admission success: the request is queued under ``id``."""
    id: int


@dataclasses.dataclass(frozen=True)
class Shed:
    """Typed backpressure response: the request was NOT queued.

    ``reason`` is ``"queue_full"`` or ``"breaker_open"``;
    ``retry_after_s`` is the client's backoff hint (the breaker's
    remaining open window, or one chunk's worth of grace for a full
    queue).
    """
    reason: str
    retry_after_s: float


@dataclasses.dataclass
class _Group:
    """One running batched solve: the chunk driver and its live members
    (``members[j]`` owns column ``j`` of ``chunks``)."""
    chunks: BatchedChunks
    members: List[SolveRequest]


def _dwell_params(params: P.MonitorParams, deadline_s: Optional[float],
                  tight_s: float, loose_s: float) -> tuple:
    """Map a deadline to a dwell class: how long the monitor sits at the
    cheap tags before escalating.

    Loose deadlines double the monitor's decision windows (more time at
    6-8 B/nnz); tight ones halve them (escalate to the exact tag sooner).
    The class is part of the bucket key, so the requests of one batched
    group share one MonitorParams.
    """
    if deadline_s is None or loose_s > deadline_s >= tight_s:
        return "normal", params
    if deadline_s < tight_s:
        return "tight", dataclasses.replace(
            params, t=max(2, params.t // 2), l=max(2, params.l // 2),
            m=max(1, params.m // 2))
    return "loose", dataclasses.replace(
        params, t=params.t * 2, l=params.l * 2, m=params.m * 2)


class AsyncSolveService(SolverService):
    """Chunked, deadline-aware, backpressured solve service on ``device``.

    Parameters beyond :class:`SolverService`: ``chunk_iters`` is the
    iterations per chunk (the scheduling quantum: deadline checks, joins
    and shed decisions all happen at chunk boundaries); ``queue_limit``
    bounds the intake queue; ``breaker`` parameterizes the per-handle
    circuit breaker; ``warm_capacity`` sizes the warm-start LRU; ``clock``
    is injectable for tests and replays; ``chunk_hook(service, key,
    group)`` runs after every chunk (a stall-injection point).
    """

    def __init__(self, slots: int = 4,
                 params: P.MonitorParams | None = None,
                 maxiter: int = 5000,
                 guards: GuardParams | None = DEFAULT_GUARDS,
                 max_retries: int = 1,
                 chunk_iters: int = 64,
                 queue_limit: int = 32,
                 breaker: BreakerParams | None = None,
                 warm_capacity: int = 16,
                 tight_deadline_s: float = 0.2,
                 loose_deadline_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 seed: int = 0,
                 chunk_hook=None, *, device="cuda"):
        super().__init__(slots=slots, params=params, maxiter=maxiter,
                         guards=guards, max_retries=max_retries,
                         device=device)
        if chunk_iters < 1:
            raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.chunk_iters = chunk_iters
        self.queue_limit = queue_limit
        self.breaker_params = breaker or BreakerParams()
        self.warm_capacity = warm_capacity
        self.tight_deadline_s = tight_deadline_s
        self.loose_deadline_s = loose_deadline_s
        self.clock = clock
        self.seed = seed
        self.chunk_hook = chunk_hook
        self._groups: Dict[tuple, _Group] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._warm: OrderedDict = OrderedDict()
        self._pack_crcs: Dict[str, dict] = {}
        self._pack_k: Dict[str, int] = {}
        self._operators: Dict[str, Callable] = {}
        self._adaptive_done: Dict[int, SolveReport] = {}
        self.reports: Dict[int, SolveReport] = {}

        const = {"service": self.service_id}
        self.sheds = OM.stats_view(
            "repro_serve_shed_total", ("queue_full", "breaker_open"),
            help="Submissions shed by admission control, by reason.",
            label="reason", const=const)
        self.warm = OM.stats_view(
            "repro_serve_warm_total", ("hit", "miss", "store"),
            help="Warm-start LRU events.", const=const)
        self.pack_faults = OM.stats_view(
            "repro_serve_pack_faults_total", ("detected", "repacked"),
            help="Pack-integrity CRC mismatches caught before dispatch.",
            const=const)
        self.chunk_counter = OM.REGISTRY.counter(
            "repro_serve_chunks_total",
            "Solver chunks executed across all groups.",
            labelnames=("service",)).labels(**const)
        self.queue_wait = OM.REGISTRY.histogram(
            "repro_serve_queue_wait_seconds",
            "Submit-to-dispatch wait per admitted request.",
            labelnames=("service",)).labels(**const)
        self.solve_latency = OM.REGISTRY.histogram(
            "repro_serve_solve_latency_seconds",
            "Submit-to-report wall clock per request.",
            labelnames=("service",)).labels(**const)
        self._breaker_gauge = OM.REGISTRY.gauge(
            "repro_serve_breaker_open",
            "1 while the handle's circuit breaker is open.",
            labelnames=("service", "handle"))

    # -- registration ------------------------------------------------------

    def register(self, name: str, a, k: int = 8, operator=None,
                 **kw) -> str:
        """As :meth:`SolverService.register`, plus the pack's CRC stamp (a
        ``GSECSR`` handle) and an optional ``operator`` override: a
        tag-dispatched callable served instead of the packed matrix (fault
        injectors ride it; the byte reports still model the pack)."""
        handle = super().register(name, a, k=k, **kw)
        op = self._ops[handle]
        self._pack_k[handle] = k
        if isinstance(op.gse, GSECSR):
            self._pack_crcs[handle] = F.gsecsr_checksums(op.gse)
        if operator is not None:
            self._operators[handle] = operator
        return handle

    def _breaker(self, handle: str) -> CircuitBreaker:
        br = self._breakers.get(handle)
        if br is None:
            br = CircuitBreaker(self.breaker_params, clock=self.clock,
                                seed=self.seed + len(self._breakers))
            self._breakers[handle] = br
        return br

    def _verify_pack(self, handle: str) -> None:
        """Integrity check before a dispatch: a pack whose CRC drifted
        since registration is detected and repacked from the registration
        CSR before any solve reads it."""
        crcs = self._pack_crcs.get(handle)
        if crcs is None:
            return
        op = self._ops[handle]
        if not F.verify_gsecsr(op.gse, crcs):
            return
        self.pack_faults["detected"] += 1
        op.gse = pack_csr(op.csr, k=self._pack_k[handle])
        self._pack_crcs[handle] = F.gsecsr_checksums(op.gse)
        self.pack_faults["repacked"] += 1

    def _solve_op(self, req: SolveRequest):
        """The operand a request is served on: the ``operator=`` override,
        else the packed matrix."""
        return self._operators.get(req.handle, self._ops[req.handle].gse)

    # -- admission ---------------------------------------------------------

    def submit(self, handle: str, b, tol: float = 1e-8, x0=None,
               deadline_s: float | None = None, tags=None
               ) -> Union[Accepted, Shed]:
        """Admission-controlled intake.

        A malformed request still raises (``ValueError``/``KeyError``, as
        in the synchronous service); a well-formed request the service
        cannot take now comes back as a typed :class:`Shed`.  An accepted
        request returns :class:`Accepted` and is dispatched at a chunk
        boundary.  ``tags`` is the per-request precision axis (the
        synchronous service's values); ``tags="adaptive"`` runs the
        adaptive driver to completion at its admission boundary (its
        replan loop is not chunk-preemptible).
        """
        # The queue bound first: a queue_full shed must not spend a
        # half-open breaker's single probe.
        if len(self._pending) >= self.queue_limit:
            self.sheds["queue_full"] += 1
            return Shed("queue_full", retry_after_s=0.05)
        br = self._breaker(handle)
        if not br.allow():
            self.sheds["breaker_open"] += 1
            self._breaker_gauge.labels(
                service=self.service_id, handle=handle).set(1)
            return Shed("breaker_open", retry_after_s=br.retry_after())
        try:
            rid = super().submit(handle, b, tol=tol, x0=x0,
                                 deadline_s=deadline_s, tags=tags)
        except Exception:
            br.release()  # the admission never dispatched
            raise
        # The parent stamps time.monotonic(); re-stamp with the service
        # clock so deadlines and queue waits share one timeline.
        self._pending[-1].t_submit = self.clock()
        return Accepted(rid)

    # -- the pump ----------------------------------------------------------

    def pump(self) -> Dict[int, SolveReport]:
        """One cooperative scheduling round: admit queued requests into
        groups (joining running solves at this chunk boundary), advance
        every group one chunk, then settle the boundaries (completions,
        deadline expiries, degraded columns).  Returns the reports
        finalized this round (also kept on ``self.reports``).

        ``pump`` never raises out of a group: a group whose chunk throws
        degrades to error reports for its members, as ``flush`` does.
        """
        t0 = time.perf_counter()
        finalized: Dict[int, SolveReport] = {}
        with OT.span("serve.pump", service=self.service_id,
                     groups=len(self._groups),
                     queued=len(self._pending)):
            self._admit()
            if self._adaptive_done:
                finalized.update(self._adaptive_done)
                self._adaptive_done = {}
            for key in list(self._groups):
                group = self._groups[key]
                try:
                    group.chunks.run_chunk(self.chunk_iters)
                    self.chunk_counter.inc()
                    if self.chunk_hook is not None:
                        self.chunk_hook(self, key, group)
                    finalized.update(self._settle(key, group))
                except Exception:  # degraded, never propagated
                    self.stats["errors"] += 1
                    finalized.update(self._fail_group(key, group))
        self.queue_depth.set(len(self._pending))
        self.flush_latency.observe(time.perf_counter() - t0)
        self.reports.update(finalized)
        return finalized

    def run_until_idle(self, max_pumps: int = 10_000
                       ) -> Dict[int, SolveReport]:
        """Pump until the queue and all groups drain; returns every report
        finalized on the way."""
        out: Dict[int, SolveReport] = {}
        pumps = 0
        while (self._pending or self._groups) and pumps < max_pumps:
            out.update(self.pump())
            pumps += 1
        return out

    # -- internals ---------------------------------------------------------

    def _bucket(self, req: SolveRequest) -> tuple:
        cls, _ = _dwell_params(self.params, req.deadline_s,
                               self.tight_deadline_s, self.loose_deadline_s)
        return (req.handle, req.tol, cls, _tags_token(self._eff_tags(req)))

    def _eff_tags(self, req: SolveRequest):
        """The request's effective precision axis: its own override, else
        the handle's default."""
        return req.tags if req.tags is not None \
            else self._ops[req.handle].tags

    def _warm_key(self, handle: str, b) -> tuple:
        return (handle, zlib.crc32(np.ascontiguousarray(
            b.cpu().numpy()).tobytes()))

    def _warm_lookup(self, req: SolveRequest):
        key = self._warm_key(req.handle, req.b)
        hit = self._warm.get(key)
        if hit is None:
            self.warm["miss"] += 1
            return None
        self._warm.move_to_end(key)
        self.warm["hit"] += 1
        return hit

    def _warm_store(self, req: SolveRequest, x) -> None:
        key = self._warm_key(req.handle, req.b)
        self._warm[key] = x.clone()
        self._warm.move_to_end(key)
        while len(self._warm) > self.warm_capacity:
            self._warm.popitem(last=False)
        self.warm["store"] += 1

    def _admit(self) -> None:
        """Move queued requests into groups: join a running group of the
        same bucket when it has a free column, else start a new group.
        FIFO; a request whose group is full stays queued for the next
        boundary."""
        still: List[SolveRequest] = []
        for req in self._pending:
            if self._eff_tags(req) == "adaptive":
                self._admit_adaptive(req)
                continue
            key = self._bucket(req)
            group = self._groups.get(key)
            if group is not None and group.chunks.nrhs >= self.slots:
                still.append(req)
                continue
            x0 = req.x0
            if x0 is None:
                x0 = self._warm_lookup(req)
            self.queue_wait.observe(max(0.0, self.clock() - req.t_submit))
            if group is None:
                self._verify_pack(req.handle)
                _, dwell = _dwell_params(
                    self.params, req.deadline_s,
                    self.tight_deadline_s, self.loose_deadline_s)
                chunks = BatchedChunks(
                    self._solve_op(req), req.b, x0=x0, tol=req.tol,
                    maxiter=self.maxiter, params=dwell, guards=self.guards,
                    precond=self._ops[req.handle].precond,
                    tags=self._eff_tags(req))
                self._groups[key] = _Group(chunks=chunks, members=[req])
            else:
                group.chunks.join(req.b, x0=x0)
                group.members.append(req)
        self._pending = still
        self.queue_depth.set(len(self._pending))

    def _admit_adaptive(self, req: SolveRequest) -> None:
        """Dispatch one ``tags="adaptive"`` request at its admission
        boundary: the adaptive driver's host replan loop runs to
        completion here, with the breaker, warm-cache and degradation
        bookkeeping of a finalized column."""
        self.queue_wait.observe(max(0.0, self.clock() - req.t_submit))
        self._verify_pack(req.handle)
        op = self._ops[req.handle]
        br = self._breaker(req.handle)
        try:
            reps = self._run_adaptive(op, req.tol, [req])
            rep = reps[req.id]
        except Exception:  # degraded, never propagated (pump contract)
            self.stats["errors"] += 1
            self._solutions.pop(req.id, None)
            br.record_failure()
            reps = {req.id: SolveReport(
                id=req.id, handle=req.handle, iters=0,
                relres=float("inf"), converged=False, tag=0,
                switch_iters=np.full(2, -1, np.int64),
                est_bytes=0, batch_size=1, health="error",
            )}
        else:
            if rep.converged and rep.health == "ok":
                br.record_success()
                self._warm_store(req, self._solutions[req.id])
            else:
                br.record_failure()
            self.request_bytes.observe(rep.est_bytes)
        self._breaker_gauge.labels(
            service=self.service_id, handle=req.handle
        ).set(1 if br.state == OPEN else 0)
        self.solve_latency.observe(max(0.0, self.clock() - req.t_submit))
        self._adaptive_done.update(reps)

    def _expired(self, req: SolveRequest) -> bool:
        return (req.deadline_s is not None
                and self.clock() - req.t_submit > req.deadline_s)

    def _settle(self, key: tuple, group: _Group) -> Dict[int, SolveReport]:
        """Boundary processing after a chunk: finalize finished columns,
        expire lapsed deadlines (flagged current iterate, never dropped),
        drop their columns, retire empty groups."""
        out: Dict[int, SolveReport] = {}
        width = group.chunks.nrhs
        for j in reversed(range(group.chunks.nrhs)):
            req = group.members[j]
            done = group.chunks.col_done(j)
            expired = not done and self._expired(req)
            if not done and not expired:
                continue
            snap = group.chunks.drop(j)
            snap["batch"] = width
            group.members.pop(j)
            if expired:
                out[req.id] = self._finalize_expired(req, snap, key)
            else:
                out[req.id] = self._finalize(req, snap, key)
        if group.chunks.nrhs == 0:
            del self._groups[key]
        return out

    def _finalize(self, req: SolveRequest, snap: dict,
                  key: tuple) -> SolveReport:
        """A column that ran to its natural exit: the bounded tag-3
        retries of a degraded column (as in the synchronous service), the
        breaker and warm-cache bookkeeping, the request's byte share."""
        op = self._ops[req.handle]
        x = snap["x"]
        it = snap["iters"]
        relres = snap["relres"]
        conv = snap["converged"]
        tag = snap["tag"]
        h = snap["health"]
        trip = snap["trip_iter"]
        retries = 0
        deadline_hit = False
        x_finite = _finite(x)
        shares, total = self._byte_shares(
            op, np.asarray([it]),
            np.asarray(snap["switch_iters"]).reshape(1, -1),
            tags=self._eff_tags(req))
        est_bytes = int(shares[0])
        self.stats["modeled_bytes"] += total
        solve_op = self._solve_op(req)
        while (not conv or not x_finite) and retries < self.max_retries:
            if self._expired(req):
                deadline_hit = True
                self.stats["deadline_exceeded"] += 1
                break
            retries += 1
            self.stats["retries"] += 1
            warm = x if x_finite else req.x0
            kw = dict(x0=warm, tol=req.tol, maxiter=self.maxiter,
                      params=self.params, guards=self.guards, init_tag=3)
            if op.precond is not None:
                r2 = solve_pcg(solve_op, req.b, op.precond, **kw)
            else:
                r2 = solve_cg(solve_op, req.b, **kw)
            rx_finite = _finite(r2.x)
            r2_trip = int(r2.trip_iter)
            if trip < 0 and r2_trip >= 0:
                trip = it + r2_trip
            it += int(r2.iters)
            relres = float(r2.relres)
            conv = bool(r2.converged)
            tag = int(r2.tag)
            h = int(r2.health)
            if rx_finite:
                x = r2.x
            x_finite = x_finite or rx_finite
            sh2, tot2 = self._byte_shares(
                op, np.asarray([int(r2.iters)]),
                r2.switch_iters.cpu().numpy().reshape(1, -1))
            est_bytes += int(sh2[0])
            self.stats["modeled_bytes"] += tot2
        # A non-finite x never leaves the service unflagged.
        if not x_finite and h == HEALTH_OK:
            h = HEALTH_NONFINITE
            conv = False
        br = self._breaker(req.handle)
        if conv and h == HEALTH_OK:
            br.record_success()
            self._warm_store(req, x)
        else:
            br.record_failure()
        self._breaker_gauge.labels(
            service=self.service_id, handle=req.handle
        ).set(1 if br.state == OPEN else 0)
        self._solutions[req.id] = x
        self.stats["requests"] += 1
        self.solve_latency.observe(max(0.0, self.clock() - req.t_submit))
        self.request_bytes.observe(est_bytes)
        return SolveReport(
            id=req.id, handle=req.handle, iters=it, relres=relres,
            converged=conv, tag=tag,
            switch_iters=np.asarray(snap["switch_iters"]),
            est_bytes=est_bytes, batch_size=snap.get("batch", 1),
            health=health_name(h), trip_iter=trip, retries=retries,
            deadline_exceeded=deadline_hit,
        )

    def _finalize_expired(self, req: SolveRequest, snap: dict,
                          key: tuple) -> SolveReport:
        """Deadline lapsed mid-solve: the report carries the column's
        current (last healthy) iterate, flagged ``deadline_exceeded`` with
        ``health="deadline"`` when no guard already flagged it."""
        x = snap["ckpt"]
        x_finite = _finite(x)
        # The raw guard health, not the finalized one: a mid-solve column
        # is unconverged by definition, so only a genuine in-loop guard
        # trip shadows the "deadline" flag.
        h = snap.get("guard_health", HEALTH_OK)
        self.stats["deadline_exceeded"] += 1
        self.stats["requests"] += 1
        # A deadline expiry is a capacity signal, not an operand fault: it
        # neither trips nor closes the breaker.
        self._solutions[req.id] = x
        self.solve_latency.observe(max(0.0, self.clock() - req.t_submit))
        if h != HEALTH_OK:
            health = health_name(h)
        elif not x_finite:
            health = "nonfinite"
        else:
            health = "deadline"
        return SolveReport(
            id=req.id, handle=req.handle, iters=snap["iters"],
            relres=snap["relres"], converged=False, tag=snap["tag"],
            switch_iters=np.asarray(snap["switch_iters"]),
            est_bytes=0, batch_size=snap.get("batch", 1), health=health,
            trip_iter=snap["trip_iter"], retries=0,
            deadline_exceeded=True,
        )

    def _fail_group(self, key: tuple, group: _Group
                    ) -> Dict[int, SolveReport]:
        """A group whose chunk raised: every member degrades to an error
        report (the synchronous service's contract), each a breaker
        failure."""
        out: Dict[int, SolveReport] = {}
        for req in group.members:
            self._solutions.pop(req.id, None)
            self._breaker(req.handle).record_failure()
            out[req.id] = SolveReport(
                id=req.id, handle=req.handle, iters=0,
                relres=float("inf"), converged=False, tag=0,
                switch_iters=np.full(2, -1, np.int64),
                est_bytes=0, batch_size=len(group.members),
                health="error",
            )
        self._groups.pop(key, None)
        return out
