"""Request-batching solve service over registered GSE-SEM operators.

Port of ``repro/launch/solver_serve.py``: ``SolveRequest``,
``SolveReport``, ``_Operator`` and ``SolverService`` (``__init__``,
``register``, ``submit``, ``flush``, ``_run_slot``, ``solution``,
``_byte_shares``; :105-685) and the ``main`` demo (:688).

The service packs each registered matrix (and its optional
preconditioner) once, buckets incoming requests by (operator, tolerance,
precision axis), pads each bucket to a fixed slot width with all-zero
columns and runs the batched stepped CG or, on a preconditioned handle,
PCG (``solvers.batched.solve_cg_batched``/``solve_pcg_batched``): one
streaming pass over the packed matrix (kernel C64) feeds every request
in a slot, so the matrix (and preconditioner) traffic is charged once per
iteration however many requests ride along.  A degraded column gets a
bounded single-RHS retry at tag 3 (``solve_cg``/``solve_pcg``) from its
warm x.  Each request
gets a :class:`SolveReport`: iterations, final relative residual, its own
tag-switch schedule, health, retries and its modeled byte share of the
batch (matrix bytes split evenly across each iteration's active columns,
vector bytes owned per column).  A padding column has ``||b|| = 0``: it
converges at iteration 0 and never perturbs a real request.

Telemetry is the reference's (:186-211, :395-425), in the metrics
registry (``obs.metrics``) under the reference's names, labeled by the
service's id: ``stats`` is a dict-shaped view of
``repro_serve_events_total`` (its seven keys), ``queue_depth`` the
``repro_serve_queue_depth`` gauge, and every flush observes
``repro_serve_flush_latency_seconds`` and, per report,
``repro_serve_request_bytes``; ``flush`` runs inside the ``serve.flush``
span (``obs.trace``).  ``layout="sell"``
packs the operator into the SELL-C-sigma layout
(``kernels.ops.sell_pack_gsecsr``): the batched operator is then kernel
C′64 and the retry's B64, the trajectories are bitwise the ``"csr"``
handle's, and the byte reports charge the layout's padded slots.  The
precision axis ``tags=`` (``_normalize_service_tags`` :64, ``_tags_token``
:96, ``_run_adaptive`` :550, ``_byte_shares`` :645) is an int, a
``TagMap`` or ``"adaptive"``, per handle at ``register`` and per request
at ``submit``: requests bucket by their effective axis (a map by its
crc32); a non-uniform map runs the batched solve on the masked operand
and its byte shares charge the blended stream; ``"adaptive"`` serves each
request through ``solvers.adaptive.solve_adaptive`` on a CSR handle, with
its own byte account.  ``register(plan=, tune=True)`` attaches a launch
plan (``perf.plan.KernelPlan``) to the handle, explicit or from the
autotuner (``perf.autotune.get_or_tune``, :283-301): the SELL pack takes
its C, sigma, lane and buckets, and the trajectories stay bitwise the
untuned handle's.  Not yet ported: sharded handles (item 15), which raise
``NotImplementedError``.

Usage (demo, on the card):
  PYTHONPATH=src python -m repro_torch.launch.solver_serve --requests 6 --slots 4
  PYTHONPATH=src python -m repro_torch.launch.solver_serve --layout sell
  PYTHONPATH=src python -m repro_torch.launch.solver_serve --precond jacobi
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import precision as P
from repro_torch.core.tagmap import TagMap, normalize_tags
from repro_torch.kernels.ops import sell_pack_gsecsr
from repro_torch.kernels.vec_f64 import on_device, seq_dot
from repro_torch.obs import metrics as OM
from repro_torch.obs import trace as OT
from repro_torch.robustness.guards import (
    DEFAULT_GUARDS,
    GuardParams,
    HEALTH_NONFINITE,
    HEALTH_OK,
    health_name,
)
from repro_torch.solvers.batched import (column_tags_at, solve_cg_batched,
                                         solve_pcg_batched)
from repro_torch.solvers.cg import solve_cg, solve_pcg
from repro_torch.solvers.precond import make_jacobi, make_spai0
from repro_torch.sparse.csr import (CSR, GSESellC, iteration_stream_bytes,
                                    pack_csr)

__all__ = ["SolveRequest", "SolveReport", "SolverService"]

# Each service's ``service`` label in the metrics registry.
_SERVICE_IDS = itertools.count()

_PRECOND_FACTORY = {"jacobi": make_jacobi, "spai0": make_spai0}


def _normalize_service_tags(tags, m: int, sharded: bool = False,
                            sell: bool = False):
    """Validate and normalize a service-level ``tags=`` axis: ``None`` (the
    handle's or the monitor's default), an int or a uniform ``TagMap`` (its
    int tag), a non-uniform map (kept; single-device handles only) or
    ``"adaptive"`` (the adaptive driver, which reads the flat ``GSECSR``
    pack: a single-device CSR handle)."""
    if tags is None:
        return None
    if isinstance(tags, str):
        if tags != "adaptive":
            raise ValueError(
                f"tags= accepts an int tag, a TagMap, or 'adaptive'; "
                f"got {tags!r}")
        if sharded or sell:
            raise ValueError(
                "tags='adaptive' needs a single-device CSR handle "
                "(solve_adaptive reads the flat GSECSR pack)")
        return "adaptive"
    norm = normalize_tags(tags, m)
    if isinstance(norm, TagMap) and sharded:
        raise ValueError(
            "per-group tag maps are single-device; the sharded serve "
            "path takes int tags only")
    return norm


def _tags_token(tags):
    """Hashable bucket token of an effective tags axis (a map buckets by
    its crc32, so two equal maps share a slot)."""
    if isinstance(tags, TagMap):
        return ("map", tags.crc32)
    return tags


def _finite(v: torch.Tensor) -> bool:
    """Whether ``v . v`` is finite, as the reference tests a solution
    (``isfinite(vdot(x, x))``)."""
    return bool(torch.isfinite(seq_dot(v, v)))


@dataclasses.dataclass
class SolveRequest:
    id: int
    handle: str
    b: torch.Tensor
    tol: float
    x0: Optional[torch.Tensor] = None
    deadline_s: Optional[float] = None  # wall-clock budget from submit()
    t_submit: float = 0.0               # time.monotonic() at intake
    tags: object = None                 # per-request precision axis override


@dataclasses.dataclass
class SolveReport:
    id: int
    handle: str
    iters: int
    relres: float
    converged: bool
    tag: int
    switch_iters: np.ndarray  # (2,)
    est_bytes: int            # modeled byte share of the batch
    batch_size: int           # real requests in the slot it ran in
    # Degradation reporting: the health name (robustness.guards.HEALTH_NAMES,
    # or "error" when the slot's solve itself raised), the first guard-trip
    # iteration within the batched run (-1: never), the bounded tag-3
    # retries this request consumed, and whether its deadline lapsed before
    # recovery finished.
    health: str = "ok"
    trip_iter: int = -1
    retries: int = 0
    deadline_exceeded: bool = False


@dataclasses.dataclass
class _Operator:
    name: str
    csr: CSR
    gse: object      # GSECSR or GSESellC, packed once at registration
    precond: object = None  # preconditioner object, packed once, or None
    plan: object = None  # KernelPlan attached at register (explicit or tuned)
    tags: object = None  # handle-default axis: None | int | TagMap | "adaptive"


class SolverService:
    """Request-batching front end for the batched stepped CG and PCG.

    ``slots`` is the batch width every bucket is padded to: requests
    against the same (operator, tol) bucket share one batched solve.
    ``flush()`` drains the pending requests and returns per-request
    :class:`SolveReport` s.  The solves run on ``device``.
    """

    def __init__(self, slots: int = 4,
                 params: P.MonitorParams | None = None,
                 maxiter: int = 5000,
                 guards: GuardParams | None = DEFAULT_GUARDS,
                 max_retries: int = 1, *, device="cuda"):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.slots = slots
        self.params = params or P.MonitorParams.for_cg()
        self.maxiter = maxiter
        self.guards = guards
        self.max_retries = max_retries
        self.device = torch.device(device)
        self._ops: Dict[str, _Operator] = {}
        self._pending: List[SolveRequest] = []
        self._ids = itertools.count()
        self._solutions: Dict[int, torch.Tensor] = {}
        # Registry-backed telemetry: ``stats`` keeps the dict shape, the
        # gauge tracks the queue, the histograms give the flush-latency and
        # bytes-per-request percentiles.
        self.service_id = str(next(_SERVICE_IDS))
        const = {"service": self.service_id}
        self.stats = OM.stats_view(
            "repro_serve_events_total",
            ("batches", "requests", "padded_cols", "modeled_bytes",
             "retries", "errors", "deadline_exceeded"),
            help="SolverService lifetime event counts by kind.",
            const=const,
        )
        self.queue_depth = OM.REGISTRY.gauge(
            "repro_serve_queue_depth",
            "Requests waiting for the next flush.",
            labelnames=("service",),
        ).labels(**const)
        self.flush_latency = OM.REGISTRY.histogram(
            "repro_serve_flush_latency_seconds",
            "Wall-clock seconds per SolverService.flush call.",
            labelnames=("service",),
        ).labels(**const)
        self.request_bytes = OM.REGISTRY.histogram(
            "repro_serve_request_bytes",
            "Modeled streamed bytes charged to each served request.",
            labelnames=("service",),
            buckets=OM.DEFAULT_BYTE_BUCKETS,
        ).labels(**const)

    # -- registration ------------------------------------------------------

    def register(self, name: str, a: CSR, k: int = 8, precond=None,
                 layout: str = "csr", sharded: bool = False, plan=None,
                 tune: bool = False, tags=None) -> str:
        """Pack ``a`` (a ``CSR`` on the service's device) once; returns the
        handle requests are submitted against.  ``precond`` is ``None``,
        ``"jacobi"``/``"spai0"`` (packed here against ``k`` shared
        exponents) or a ready :mod:`repro_torch.solvers.precond` object on
        the service's device: one packed preconditioner serves every
        request against the handle.  ``layout="sell"`` also
        packs the SELL-C-sigma layout (cached on the packed instance):
        trajectories are bitwise the ``"csr"`` default's, and the byte
        reports charge the layout's padded slots.  ``tags`` sets the
        handle's default precision axis, overridable per request at
        :meth:`submit`: an int or a uniform ``TagMap`` the start tag, a
        non-uniform map the masked per-group schedule, ``"adaptive"`` the
        adaptive driver for every request (CSR handles only).

        ``plan``/``tune`` attach a launch plan to the handle: an explicit
        ``perf.plan.KernelPlan`` is used as it is; ``tune=True`` (without
        ``plan``) resolves one through ``perf.autotune.get_or_tune`` at
        tag 1 for the handle's layout (``"sell"``, else ``"ell"``): a
        sweep on the service's device the first time a matrix class is
        registered, a cache hit afterwards.  The SELL pack then takes the
        plan's C, sigma, lane and buckets; the trajectories stay bitwise
        the untuned handle's (every f64 body sums a row in CSR order from
        0.0, whatever the pack), and the byte reports charge the plan's
        pack."""
        if name in self._ops:
            raise ValueError(f"handle {name!r} already registered")
        if layout not in ("csr", "sell"):
            raise ValueError(
                f"unknown layout {layout!r}; expected 'csr' or 'sell'")
        if sharded and layout == "sell":
            raise ValueError(
                "sharded=True serves through the row-sharded CSR decode; "
                "the SELL layout is single-device (pick one)")
        if sharded:
            raise NotImplementedError(
                "sharded handles are not ported yet (ROADMAP queue 1 item 15)")
        tags = _normalize_service_tags(tags, int(a.shape[0]),
                                       sharded=sharded,
                                       sell=layout == "sell")
        on_device(self.device, a=a.val)
        if isinstance(precond, str):
            try:
                precond = _PRECOND_FACTORY[precond](a, k=k)
            except KeyError:
                raise ValueError(
                    f"unknown preconditioner {precond!r}; expected one of "
                    f"{sorted(_PRECOND_FACTORY)}") from None
        gse = pack_csr(a, k=k)
        if tune and plan is None:
            from repro_torch.perf import autotune

            plan, _, _ = autotune.get_or_tune(
                gse, tag=1, layout="sell" if layout == "sell" else "ell")
        if layout == "sell":
            gse = sell_pack_gsecsr(gse, plan=plan)
        self._ops[name] = _Operator(name=name, csr=a, gse=gse,
                                    precond=precond, plan=plan, tags=tags)
        return name

    # -- request intake ----------------------------------------------------

    def submit(self, handle: str, b, tol: float = 1e-8, x0=None,
               deadline_s: float | None = None, tags=None) -> int:
        """Queue one solve request; returns its request id.

        ``b`` (and ``x0``) must match the handle's dimension as ``(n,)`` or
        ``(n, 1)``, have a floating dtype and be entirely finite; the
        solve runs in float64.  ``deadline_s`` is a wall-clock budget from
        submission: a lapsed deadline suppresses the tag-3 retry.  ``tags``
        overrides the handle's precision axis for this request (the values
        of :meth:`register`); requests bucket by their effective axis."""
        op = self._ops.get(handle)
        if op is None:
            raise KeyError(f"unknown handle {handle!r}")
        n = op.csr.shape[0]
        b = torch.as_tensor(b, device=self.device)
        if b.dim() == 2 and b.shape[1] == 1:
            b = b[:, 0]
        if b.dim() != 1 or b.shape[0] != n:
            raise ValueError(
                f"b must be ({n},) or ({n}, 1) for handle {handle!r}; got "
                f"{tuple(b.shape)}")
        if not b.dtype.is_floating_point:
            raise ValueError(f"b must have a floating dtype for handle "
                             f"{handle!r}; got {b.dtype}")
        if not bool(torch.isfinite(b).all()):
            raise ValueError(
                f"b contains non-finite entries (handle {handle!r}); "
                "rejected at intake")
        if x0 is not None:
            x0 = torch.as_tensor(x0, device=self.device)
            if x0.dim() == 2 and x0.shape[1] == 1:
                x0 = x0[:, 0]  # same (n, 1) normalization as b
            if x0.shape != b.shape:
                raise ValueError(
                    f"x0 shape {tuple(x0.shape)} != b shape {tuple(b.shape)}")
            if not bool(torch.isfinite(x0).all()):
                raise ValueError(
                    f"x0 contains non-finite entries (handle {handle!r}); "
                    "rejected at intake")
            x0 = x0.to(torch.float64).contiguous()
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        tags = _normalize_service_tags(tags, n,
                                       sell=isinstance(op.gse, GSESellC))
        rid = next(self._ids)
        self._pending.append(SolveRequest(
            rid, handle, b.to(torch.float64).contiguous(), float(tol), x0,
            deadline_s=deadline_s, t_submit=time.monotonic(), tags=tags))
        self.queue_depth.set(len(self._pending))
        return rid

    # -- batch execution ---------------------------------------------------

    def flush(self) -> Dict[int, SolveReport]:
        """Drain pending requests: bucket by (handle, tol, tags), pad to
        the slot width, run the batched stepped solver, report per request.

        Solutions are kept only until the next flush (claim them with
        :meth:`solution`).  ``flush`` never raises out of a slot: a slot
        whose solve throws degrades to error reports (``health="error"``,
        not converged, no solution) for its requests, and every returned
        solution is either finite or flagged by a non-ok health."""
        t0 = time.perf_counter()
        self._solutions.clear()
        buckets: Dict[tuple, tuple] = {}
        for req in self._pending:
            eff = req.tags if req.tags is not None \
                else self._ops[req.handle].tags
            key = (req.handle, req.tol, _tags_token(eff))
            buckets.setdefault(key, (eff, []))[1].append(req)
        drained = len(self._pending)
        self._pending = []
        self.queue_depth.set(0)

        reports: Dict[int, SolveReport] = {}
        with OT.span("serve.flush", service=self.service_id,
                     requests=drained) as attrs:
            for (handle, tol, _), (eff, reqs) in buckets.items():
                op = self._ops[handle]
                for i in range(0, len(reqs), self.slots):
                    chunk = reqs[i:i + self.slots]
                    try:
                        reports.update(
                            self._run_slot(op, tol, chunk, tags=eff))
                    except Exception:  # degraded, never propagated
                        self.stats["errors"] += 1
                        for req in chunk:
                            self._solutions.pop(req.id, None)
                            reports[req.id] = SolveReport(
                                id=req.id, handle=op.name, iters=0,
                                relres=float("inf"), converged=False, tag=0,
                                switch_iters=np.full(2, -1, np.int64),
                                est_bytes=0, batch_size=len(chunk),
                                health="error",
                            )
            attrs["bytes"] = sum(r.est_bytes for r in reports.values())
        for rep in reports.values():
            self.request_bytes.observe(rep.est_bytes)
        self.flush_latency.observe(time.perf_counter() - t0)
        return reports

    def _run_slot(self, op: _Operator, tol: float,
                  reqs: List[SolveRequest],
                  tags=None) -> Dict[int, SolveReport]:
        if tags == "adaptive":
            return self._run_adaptive(op, tol, reqs)
        n = op.csr.shape[0]
        pad = self.slots - len(reqs)
        zero = torch.zeros(n, dtype=torch.float64, device=self.device)
        b = torch.stack([r.b for r in reqs] + [zero] * pad, dim=1)
        x0 = None
        if any(r.x0 is not None for r in reqs):
            x0 = torch.stack(
                [r.x0 if r.x0 is not None else zero for r in reqs]
                + [zero] * pad, dim=1)
        kw = dict(x0=x0, tol=tol, maxiter=self.maxiter, params=self.params,
                  guards=self.guards, tags=tags, device=self.device)
        if op.precond is not None:
            res = solve_pcg_batched(op.gse, b, op.precond, **kw)
        else:
            res = solve_cg_batched(op.gse, b, **kw)

        iters = res.iters.cpu().numpy()
        sw = res.switch_iters.cpu().numpy()
        relres = res.relres.tolist()
        converged = res.converged.tolist()
        tag = res.tag.tolist()
        health = np.broadcast_to(res.health.cpu().numpy(),
                                 iters.shape).astype(np.int64)
        trip = np.broadcast_to(res.trip_iter.cpu().numpy(),
                               iters.shape).astype(np.int64)
        nreal = len(reqs)
        shares, total_bytes = self._byte_shares(op, iters, sw, tags=tags)
        self.stats["batches"] += 1
        self.stats["requests"] += nreal
        self.stats["padded_cols"] += pad
        self.stats["modeled_bytes"] += total_bytes

        out = {}
        for j, req in enumerate(reqs):
            x = res.x[:, j].contiguous()
            it_j = int(iters[j])
            relres_j = relres[j]
            conv_j = converged[j]
            tag_j = tag[j]
            bytes_j = int(shares[j])
            h_j = int(health[j])
            trip_j = int(trip[j])
            retries = 0
            deadline_hit = False
            x_finite = _finite(x)
            # Degraded column: bounded single-RHS retries at tag 3 (the
            # strongest rung of the escalation ladder).  A lapsed deadline
            # suppresses them; the report still ships what the batched
            # pass produced, flagged.
            while (not conv_j or not x_finite) and retries < self.max_retries:
                if req.deadline_s is not None and \
                        time.monotonic() - req.t_submit > req.deadline_s:
                    deadline_hit = True
                    self.stats["deadline_exceeded"] += 1
                    break
                retries += 1
                self.stats["retries"] += 1
                r2 = self._retry(op, req, tol, x if x_finite else req.x0)
                rx_finite = _finite(r2.x)
                r2_trip = int(r2.trip_iter)
                if trip_j < 0 and r2_trip >= 0:
                    trip_j = it_j + r2_trip
                it_j += int(r2.iters)
                relres_j = float(r2.relres)
                conv_j = bool(r2.converged)
                tag_j = int(r2.tag)
                h_j = int(r2.health)
                if rx_finite:
                    x = r2.x
                x_finite = x_finite or rx_finite
                sh2, tot2 = self._byte_shares(
                    op, np.asarray([int(r2.iters)]),
                    r2.switch_iters.cpu().numpy().reshape(1, -1))
                bytes_j += int(sh2[0])
                self.stats["modeled_bytes"] += tot2
            # A non-finite solution never leaves the service unflagged,
            # whatever the solver reported.
            if not x_finite and h_j == HEALTH_OK:
                h_j = HEALTH_NONFINITE
                conv_j = False
            self._solutions[req.id] = x
            out[req.id] = SolveReport(
                id=req.id,
                handle=op.name,
                iters=it_j,
                relres=relres_j,
                converged=conv_j,
                tag=tag_j,
                switch_iters=sw[j],
                est_bytes=bytes_j,
                batch_size=nreal,
                health=health_name(h_j),
                trip_iter=trip_j,
                retries=retries,
                deadline_exceeded=deadline_hit,
            )
        return out

    def _retry(self, op: _Operator, req, tol: float, warm):
        """One single-RHS retry at tag 3 from ``warm``."""
        kw = dict(x0=warm, tol=tol, maxiter=self.maxiter,
                  params=self.params, guards=self.guards, init_tag=3)
        if op.precond is not None:
            return solve_pcg(op.gse, req.b, op.precond, **kw)
        return solve_cg(op.gse, req.b, **kw)

    def _run_adaptive(self, op: _Operator, tol: float,
                      reqs: List[SolveRequest]) -> Dict[int, SolveReport]:
        """``tags="adaptive"``: the adaptive driver is a host loop over
        single-RHS segments, so each request runs its own solve (no slot
        sharing), ``est_bytes`` is the driver's own blended account
        (``AdaptiveResult.spmv_bytes``) and ``relres`` the true tag-3
        residual its stop is gated on.  A degraded request gets the
        batched path's bounded tag-3 retry."""
        from repro_torch.solvers.adaptive import solve_adaptive

        # The async subclass's injectable clock times the deadline.
        clock = getattr(self, "clock", time.monotonic)
        out = {}
        self.stats["batches"] += 1
        self.stats["requests"] += len(reqs)
        for req in reqs:
            res = solve_adaptive(op.gse, req.b, precond=op.precond,
                                 x0=req.x0, tol=tol, maxiter=self.maxiter,
                                 params=self.params)
            x = res.x
            it_j = int(res.iters)
            relres_j = float(res.true_relres)
            conv_j = bool(res.converged)
            tag_j = int(res.tagmap.max_tag)
            bytes_j = int(res.spmv_bytes)
            h_j = HEALTH_OK
            retries = 0
            deadline_hit = False
            x_finite = _finite(x)
            self.stats["modeled_bytes"] += bytes_j
            while (not conv_j or not x_finite) and retries < self.max_retries:
                if req.deadline_s is not None and \
                        clock() - req.t_submit > req.deadline_s:
                    deadline_hit = True
                    self.stats["deadline_exceeded"] += 1
                    break
                retries += 1
                self.stats["retries"] += 1
                r2 = self._retry(op, req, tol, x if x_finite else req.x0)
                rx_finite = _finite(r2.x)
                it_j += int(r2.iters)
                relres_j = float(r2.relres)
                conv_j = bool(r2.converged)
                tag_j = int(r2.tag)
                h_j = int(r2.health)
                if rx_finite:
                    x = r2.x
                x_finite = x_finite or rx_finite
                sh2, tot2 = self._byte_shares(
                    op, np.asarray([int(r2.iters)]),
                    r2.switch_iters.cpu().numpy().reshape(1, -1))
                bytes_j += int(sh2[0])
                self.stats["modeled_bytes"] += tot2
            if not x_finite and h_j == HEALTH_OK:
                h_j = HEALTH_NONFINITE
                conv_j = False
            self._solutions[req.id] = x
            out[req.id] = SolveReport(
                id=req.id, handle=op.name, iters=it_j, relres=relres_j,
                converged=conv_j, tag=tag_j,
                switch_iters=np.full(2, -1, np.int64), est_bytes=bytes_j,
                batch_size=len(reqs), health=health_name(h_j), trip_iter=-1,
                retries=retries, deadline_exceeded=deadline_hit)
        return out

    def solution(self, request_id: int) -> torch.Tensor:
        """The solved ``x`` for a flushed request (popped to free memory)."""
        try:
            return self._solutions.pop(request_id)
        except KeyError:
            raise KeyError(
                f"no flushed solution for request {request_id!r}") from None

    def _byte_shares(self, op: _Operator, iters, sw, tags=None):
        """One walk of the per-iteration byte model: the per-column shares
        and their sum, which is ``batched_run_bytes`` (each iteration adds
        ``iteration_stream_bytes(..., nrhs=n_active)``, split evenly among
        the columns sharing the streaming pass; a preconditioned handle's
        stored preconditioner is charged beside the matrix).  An int
        ``tags`` floors the schedule's tag (the batch started there, not
        at tag 1); a non-uniform ``TagMap`` charges every live iteration
        the blended stream (the map is pinned: no switch schedule)."""
        nrhs = iters.shape[0]
        shares = np.zeros(nrhs, np.float64)
        tm = tags if isinstance(tags, TagMap) else None
        floor = int(tags) if isinstance(tags, (int, np.integer)) else 1
        for it in range(int(iters.max(initial=0))):
            col_tags = column_tags_at(iters, sw, it)
            live = np.nonzero(col_tags > 0)[0]
            if live.size == 0:
                continue
            if tm is not None:
                tot = iteration_stream_bytes(op.gse, tm, op.precond,
                                             nrhs=live.size)
                shares[live] += tot / live.size
                continue
            tag = max(int(col_tags.max()), floor)
            tot = iteration_stream_bytes(op.gse, tag, op.precond,
                                         nrhs=live.size)
            shares[live] += tot / live.size
        return np.rint(shares).astype(np.int64), int(round(shares.sum()))


def main(argv=None):
    import argparse

    from repro_torch.sparse import generators as G
    from repro_torch.sparse.spmv import spmv

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--n", type=int, default=24, help="Poisson grid side")
    ap.add_argument("--precond", default="none",
                    choices=["none", "jacobi", "spai0"])
    ap.add_argument("--layout", default="csr", choices=["csr", "sell"],
                    help="operator pack: 'sell' rides the SELL-C-sigma "
                         "sliced layout (padding-honest byte reports)")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    a = G.poisson2d(args.n, device=args.device)
    host = G.poisson2d(args.n, device="cpu")  # b on the host: deterministic
    params = P.MonitorParams(t=40, l=60, m=30, rsd_limit=0.5,
                             reldec_limit=0.45)
    svc = SolverService(slots=args.slots, params=params, maxiter=20000,
                        device=args.device)
    svc.register("poisson", a, k=8,
                 precond=None if args.precond == "none" else args.precond,
                 layout=args.layout)

    rng = np.random.default_rng(0)
    ids = []
    for _ in range(args.requests):
        b = spmv(host, torch.from_numpy(rng.normal(size=a.shape[1])))
        ids.append(svc.submit("poisson", b, tol=args.tol))

    t0 = time.perf_counter()
    reports = svc.flush()
    if svc.device.type == "cuda":
        torch.cuda.synchronize(svc.device)
    dt = time.perf_counter() - t0
    for rid in ids:
        r = reports[rid]
        print(
            f"req {r.id}: iters={r.iters} relres={r.relres:.2e} "
            f"converged={r.converged} tag={r.tag} "
            f"switches={r.switch_iters.tolist()} "
            f"est_bytes={r.est_bytes} batch={r.batch_size}/{args.slots} "
            f"health={r.health}"
        )
    s = svc.stats
    print(
        f"served {s['requests']} requests in {s['batches']} batches "
        f"({s['padded_cols']} padded cols, "
        f"{s['modeled_bytes'] / 1e6:.2f} MB modeled matrix+vector stream) "
        f"in {dt:.2f}s on {svc.device}"
    )


if __name__ == "__main__":
    main()
