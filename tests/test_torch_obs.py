"""The port's observability layer against the JAX reference.

The metrics registry's Prometheus text and JSON equal the reference's
after the same calls; the tracer nests spans and writes schema-v1 JSONL
that both packages' validators accept, and rejects the reference test's
malformed records; the flight ring appends, wraps and decodes field for
field as the reference's.  On small systems (``poisson2d(12)`` with the
reference test's monitor that switches at iterations 10 and 15) every
solver's flight ring equals the reference's -- ``it``, ``tag`` and
``health`` exactly, ``relres`` and ``a0``-``a2`` bitwise -- and
recorder-on is bitwise recorder-off.  The named cases are in
``test_torch_flight*.py``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.obs import flight as J_OF  # noqa: E402
from repro.obs import metrics as J_OM  # noqa: E402
from repro.obs import trace as J_OT  # noqa: E402
from repro.robustness.faults import make_tag_fault_operator as j_fault  # noqa: E402,E501
from repro.robustness.guards import DEFAULT_GUARDS as J_GUARDS  # noqa: E402
from repro.solvers import batched as J_b  # noqa: E402
from repro.solvers import cg as J_cg  # noqa: E402
from repro.solvers import make_gse_operator as j_gse  # noqa: E402
from repro.solvers import make_jacobi as j_jacobi  # noqa: E402
from repro.solvers import solve_gmres as j_gmres  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402,E501
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.obs import flight as T_OF  # noqa: E402
from repro_torch.obs import metrics as T_OM  # noqa: E402
from repro_torch.obs import trace as T_OT  # noqa: E402
from repro_torch.robustness.faults import make_tag_fault_operator as t_fault  # noqa: E402,E501
from repro_torch.robustness.guards import DEFAULT_GUARDS  # noqa: E402
from repro_torch.solvers import batched as T_b  # noqa: E402
from repro_torch.solvers import cg as T_cg  # noqa: E402
from repro_torch.solvers import make_gse_operator, make_jacobi  # noqa: E402
from repro_torch.solvers import solve_gmres  # noqa: E402

CPU = "cpu"
# The reference test's monitor: C2 fires at every due check, so the
# switches land at iterations 10 and 15.
STEP = dict(t=10, l=10, m=5, rsd_limit=0.5, reldec_limit=2.0)
COLS = ("it", "tag", "health", "relres", "a0", "a1", "a2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sys12():
    a = J_gen.poisson2d(12)
    g = J_csr.pack_csr(a, k=8)
    ta = csr_from_repro({n: np.asarray(getattr(a, n)) for n in
                         ("rowptr", "col", "val", "row_ids")}, a.shape,
                        device=CPU)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    rng = np.random.default_rng(3)
    b = np.array(j_spmv(a, jnp.asarray(rng.normal(size=a.shape[1]))))
    return dict(a=a, g=g, ta=ta, tg=tg, b=b)


def _same_ring(tfs, jfs):
    """The port's ring decodes to the reference's, field for field."""
    lt, lj = T_OF.FlightLog.from_state(tfs), J_OF.FlightLog.from_state(jfs)
    for c in COLS + ("tag_min",):
        np.testing.assert_array_equal(getattr(lt, c), np.asarray(getattr(
            lj, c)), err_msg=c)
    assert (lt.capacity, lt.recorded, lt.dropped) == (
        lj.capacity, lj.recorded, lj.dropped)
    assert lt.summary() == lj.summary()
    assert lt.pretty() == lj.pretty()
    return lt


# --- the metrics registry ------------------------------------------------------

def _drive(OM):
    """One sequence of registry calls, for either package."""
    r = OM.Registry()
    c = r.counter("events_total", "Events.", labelnames=("kind",))
    c.labels(kind="a").inc(2)
    c.labels(kind="b \"q\"\n").inc()
    g = r.gauge("depth", "Queue depth.")
    g.set(7)
    g.dec(2)
    h = r.histogram("lat_seconds", "Latency.", labelnames=("svc",))
    for v in range(1, 101):
        h.labels(svc="0").observe(v / 100.0)
    hb = r.histogram("req_bytes", "Bytes.", buckets=OM.DEFAULT_BYTE_BUCKETS)
    for v in (10, 300, 5e6, 3e9):
        hb.observe(v)
    sv = OM.stats_view("pack_events_total", ("hits", "misses"),
                       help="Pack events.", registry=r, const={"svc": "1"})
    sv["hits"] += 3
    sv["misses"] = 5
    r.counter("unused_total", "Registered, never set.")
    return r, sv


def test_exposition_equals_the_reference():
    jr, jsv = _drive(J_OM)
    tr, tsv = _drive(T_OM)
    assert tr.to_prometheus() == jr.to_prometheus()
    assert tr.to_json() == jr.to_json()
    assert tr.to_json_text() == jr.to_json_text()
    assert dict(tsv) == dict(jsv) == {"hits": 3, "misses": 5}
    assert repr(tsv) == repr(jsv)
    tr.reset()
    jr.reset()
    assert tr.to_prometheus() == jr.to_prometheus()
    assert dict(tsv) == {"hits": 0, "misses": 0}


def test_registry_refusals_and_dict_view():
    r = T_OM.Registry()
    c = r.counter("x_total", "h")
    assert r.counter("x_total", "h") is c
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        r.gauge("x_total", "h")
    with pytest.raises(ValueError):
        r.counter("y_total", labelnames=("k",)).inc()  # needs .labels()
    sv = T_OM.stats_view("v_total", ("hits",), registry=r)
    with pytest.raises(KeyError):
        sv["unknown"]
    with pytest.raises(TypeError):
        del sv["hits"]
    assert sv == {"hits": 0} and "hits" in sv and len(sv) == 1


def _service_lines(OM, service_id):
    """The service's series in the global registry's Prometheus text, its
    id replaced, without the (wall-clock) flush-latency family."""
    tag = f'service="{service_id}"'
    return [ln.replace(tag, 'service="S"')
            for ln in OM.REGISTRY.to_prometheus().splitlines()
            if tag in ln and "flush_latency" not in ln]


def test_pack_stats_and_service_stats_are_registry_backed(sys12):
    from repro.launch.solver_serve import SolverService as JService

    from repro_torch.launch.solver_serve import SolverService

    assert isinstance(T_ops.PACK_STATS, T_OM.StatsView)
    js = JService(slots=2, params=_params(False), maxiter=800)
    ts = SolverService(slots=2, params=_params(True), maxiter=800,
                       device=CPU)
    js.register("op", sys12["a"], k=8)
    ts.register("op", sys12["ta"], k=8)
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = rng.standard_normal(144)
        js.submit("op", jnp.asarray(b), tol=1e-8)
        ts.submit("op", torch.from_numpy(b), tol=1e-8)
    assert ts.queue_depth.value == js.queue_depth.value == 3
    reports = ts.flush()
    js.flush()
    assert all(r.converged for r in reports.values())
    assert ts.queue_depth.value == 0
    lat = ts.flush_latency.summary()
    assert lat["count"] == 1 and lat["p99"] >= lat["p50"] > 0
    by = ts.request_bytes.summary()
    assert by["count"] == 3 and by["min"] > 0
    assert ts.stats["requests"] == 3 and ts.stats["batches"] == 2
    got = _service_lines(T_OM, ts.service_id)
    assert got == _service_lines(J_OM, js.service_id)
    assert 'repro_serve_events_total{service="S",event="requests"} 3' in got
    text = T_OM.REGISTRY.to_prometheus()
    for name in ("repro_pack_cache_events_total", "repro_serve_events_total",
                 "repro_serve_queue_depth",
                 "repro_serve_flush_latency_seconds_bucket",
                 "repro_serve_request_bytes_bucket"):
        assert name in text
    jt = J_OM.REGISTRY.to_prometheus().splitlines()
    for line in text.splitlines():
        if line.startswith("# HELP repro_"):
            assert line in jt  # the reference's names and help strings


# --- the tracer -------------------------------------------------------------------

def test_span_nesting_and_jsonl_round_trip(tmp_path):
    tr = T_OT.Tracer()
    with tr.span("outer", phase="pack") as attrs:
        attrs["bytes"] = 123
        with tr.span("inner"):
            tr.annotate(rows=4)
        tr.event("mark", note="hi")
    byname = {e["name"]: e for e in tr.events}
    assert byname["inner"]["parent"] == byname["outer"]["id"]
    assert byname["inner"]["depth"] == 1 and byname["inner"]["attrs"] == {
        "rows": 4}
    assert byname["mark"]["parent"] == byname["outer"]["id"]
    assert byname["outer"]["attrs"] == {"phase": "pack", "bytes": 123}
    assert set(byname["outer"]) == set(byname["mark"]) == {
        "v", "kind", "name", "id", "parent", "depth", "t0", "dur_s", "attrs"}
    path = tmp_path / "t.jsonl"
    assert tr.write_jsonl(str(path)) == 3
    assert T_OT.validate_jsonl(str(path)) == J_OT.validate_jsonl(
        str(path)) == 3
    ids = [json.loads(line)["id"] for line in path.read_text().splitlines()]
    assert ids == sorted(ids)


BAD = [
    {"v": 1, "kind": "span", "name": "x"},
    {"v": 1, "kind": "span", "name": "x", "id": 1, "parent": 99, "depth": 0,
     "t0": 0.0, "dur_s": 0.1, "attrs": {}},
    {"v": 2, "kind": "span", "name": "x", "id": 1, "parent": None,
     "depth": 0, "t0": 0.0, "dur_s": 0.1, "attrs": {}},
    {"v": 1, "kind": "blob", "name": "x", "id": 1, "parent": None,
     "depth": 0, "t0": 0.0, "dur_s": 0.1, "attrs": {}},
    {"v": 1, "kind": "span", "name": "x", "id": True, "parent": None,
     "depth": 0, "t0": 0.0, "dur_s": 0.1, "attrs": {}},
    {"v": 1, "kind": "span", "name": "x", "id": 1, "parent": None,
     "depth": 0, "t0": 0.0, "dur_s": -1.0, "attrs": {}},
    {"v": 1, "kind": "span", "name": "x", "id": 1, "depth": 0, "t0": 0.0,
     "dur_s": 0.1, "attrs": {}},
]


@pytest.mark.parametrize("rec", BAD, ids=range(len(BAD)))
def test_validator_rejects_the_malformed_records(tmp_path, rec):
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    for OT in (T_OT, J_OT):
        with pytest.raises(ValueError):
            OT.validate_jsonl(str(path))
    path.write_text("{not json\n")
    with pytest.raises(ValueError, match="bad JSON"):
        T_OT.validate_jsonl(str(path))


def test_module_span_is_a_no_op_without_a_tracer(tmp_path):
    assert T_OT.current() is None and not T_OT.active()
    with T_OT.span("ignored", k=1) as attrs:
        attrs["x"] = 2  # writable even when dropped
    T_OT.event("ignored")
    T_OT.annotate(y=1)
    path = tmp_path / "cap.jsonl"
    with T_OT.capture(str(path)) as tr:
        assert T_OT.current() is tr
        with T_OT.span("solve.test", n=4):
            T_OT.event("inside")
    assert T_OT.current() is None
    assert T_OT.validate_jsonl(str(path)) == len(tr.events) == 2


def test_spans_reach_the_torch_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T_OT.capture():
            with T_OT.span("solve.named_in_profile"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "solve.named_in_profile" in names


def test_solves_emit_their_spans(tmp_path, sys12):
    s = sys12
    b = torch.from_numpy(s["b"])
    kw = dict(tol=1e-10, maxiter=400, params=T_P.MonitorParams(**STEP))
    path = tmp_path / "solves.jsonl"
    with T_OT.capture(str(path)) as tr:
        T_cg.solve_cg(s["tg"], b, **kw)
        T_cg.solve_pcg(s["tg"], b, make_jacobi(s["ta"], k=8), **kw)
        solve_gmres(make_gse_operator(s["tg"]), b, restart=25, **kw)
        T_b.solve_cg_batched(s["tg"], b, device=CPU, **kw)
        T_b.solve_pcg_batched(s["tg"], b, make_jacobi(s["ta"], k=8),
                              device=CPU, **kw)
    assert T_OT.validate_jsonl(str(path)) == len(tr.events)
    spans = {e["name"]: e for e in tr.events}
    assert spans["solve.cg"]["attrs"] == dict(n=144, tol=1e-10, init_tag=1,
                                              fused=True)
    assert spans["solve.pcg"]["attrs"]["fused"] is True
    assert spans["solve.gmres"]["attrs"]["restart"] == 25
    assert spans["solve.cg_batched"]["attrs"] == dict(n=144, nrhs=1,
                                                      tol=1e-10)
    assert "solve.pcg_batched" in spans


# --- the ring -------------------------------------------------------------------

def _fill(OF, fs, rows):
    for i, (tag, health) in enumerate(rows):
        fs = OF.flight_record(fs, it=i, relres=1.0 / (i + 1), tag=tag,
                              health=health, a0=0.5 * i, a1=-1.0 * i,
                              a2=float(i * i))
    return fs


@pytest.mark.parametrize("cap", [4, 8, 16])
def test_ring_append_wrap_and_decode_equal_the_reference(cap):
    rows = [(1 + i // 4, 0 if i < 9 else 2) for i in range(11)]
    jfs = _fill(J_OF, J_OF.flight_init(J_OF.FlightParams(capacity=cap),
                                       jnp.float64), rows)
    tfs = _fill(T_OF, T_OF.flight_init(T_OF.FlightParams(capacity=cap),
                                       torch.float64, CPU), rows)
    for k in ("ibuf", "fbuf", "count"):
        np.testing.assert_array_equal(tfs[k].numpy(), np.asarray(jfs[k]))
    log = _same_ring(tfs, jfs)
    assert log.recorded == 11 and log.dropped == max(11 - cap, 0)
    assert log.switch_visible(3) == J_OF.FlightLog.from_state(
        jfs).switch_visible(3)


def test_a_frozen_row_is_not_written():
    fs = T_OF.flight_init(T_OF.FlightParams(capacity=4), torch.float64, CPU)
    fs = T_OF.flight_record(fs, it=0, relres=1.0, tag=1,
                            active=torch.tensor(True))
    for it in (1, 2):
        fs = T_OF.flight_record(fs, it=it, relres=9.0, tag=3,
                                active=torch.tensor(False))
    assert int(fs["count"]) == 1
    assert fs["ibuf"][:, 0].tolist() == [0, -1, -1, -1]
    batched = T_OF.flight_init(T_OF.FlightParams(capacity=2), torch.float64,
                               CPU, batch=3)
    batched = T_OF.flight_record(
        batched, it=torch.tensor([0, 0, 0], dtype=torch.int32),
        relres=torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), tag=2,
        active=torch.tensor([True, False, True]))
    assert batched["count"].tolist() == [1, 0, 1]
    cols = T_OF.split_batched(batched)
    assert [T_OF.FlightLog.from_state(c).relres.tolist() for c in cols] == [
        [1.0], [], [3.0]]


def test_tag_pairs_and_flight_params():
    for lo, hi in ((1, 1), (1, 3), (2, 3), (3, 3)):
        assert T_OF.pack_tag_pair(lo, hi) == J_OF.pack_tag_pair(lo, hi)
    v = np.array([1, 2, 3, 0x31, 0x32, 0x21])
    for t, j in zip(T_OF.unpack_tag_pair(v), J_OF.unpack_tag_pair(v)):
        np.testing.assert_array_equal(t, j)
    with pytest.raises(ValueError):
        T_OF.pack_tag_pair(3, 1)
    with pytest.raises(ValueError):
        T_OF.FlightParams(capacity=0)
    assert T_OF.COLUMNS == J_OF.COLUMNS
    assert T_OF.DEFAULT_FLIGHT.capacity == J_OF.DEFAULT_FLIGHT.capacity


# --- every solver's ring against the reference's ----------------------------------

def _params(port):
    return (T_P if port else J_P).MonitorParams(**STEP)


@pytest.mark.parametrize("kind", ["cg", "cg_guarded", "cg_generic",
                                  "cg_sell", "pcg", "pcg_generic"])
def test_small_solves_record_the_reference_ring(kind, sys12):
    s = sys12
    fp = (J_OF.FlightParams(capacity=256), T_OF.FlightParams(capacity=256))
    guards = DEFAULT_GUARDS if kind == "cg_guarded" else None
    kw = dict(tol=1e-10, maxiter=400, recover=False)
    jop, top = s["g"], s["tg"]
    if kind == "cg_sell":
        from repro.kernels import ops as J_ops
        jop, top = J_ops.sell_pack_gsecsr(jop), T_ops.sell_pack_gsecsr(top)
    if kind.endswith("generic"):
        jop, top = j_gse(jop), make_gse_operator(top)
    jb, tb = jnp.asarray(s["b"]), torch.from_numpy(s["b"])
    if kind.startswith("pcg"):
        jm, tm = j_jacobi(s["a"], k=8), make_jacobi(s["ta"], k=8)
        jr = J_cg.solve_pcg(jop, jb, jm, params=_params(False),
                            guards=None, flight=fp[0], **kw)
        off = T_cg.solve_pcg(top, tb, tm, params=_params(True), guards=None,
                             **kw)
        on = T_cg.solve_pcg(top, tb, tm, params=_params(True), guards=None,
                            flight=fp[1], **kw)
    else:
        jr = J_cg.solve_cg(jop, jb, params=_params(False),
                           guards=None if guards is None else J_GUARDS,
                           flight=fp[0], **kw)
        off = T_cg.solve_cg(top, tb, params=_params(True), guards=guards,
                            **kw)
        on = T_cg.solve_cg(top, tb, params=_params(True), guards=guards,
                           flight=fp[1], **kw)
    assert torch.equal(on.x, off.x) and int(on.iters) == int(off.iters)
    np.testing.assert_array_equal(on.x.numpy(), np.asarray(jr.x))
    log = _same_ring(on.flight, jr.flight)
    T_OF.assert_consistent(log, on)
    if kind.startswith("cg"):
        assert log.switch_iters().tolist() == [10, 15]


@pytest.mark.parametrize("precond", [False, True])
def test_small_gmres_records_the_reference_ring(precond, sys12):
    s = sys12
    kw = dict(tol=1e-10, restart=25, maxiter=400, recover=False)
    jm = j_jacobi(s["a"], k=8) if precond else None
    tm = make_jacobi(s["ta"], k=8) if precond else None
    jr = j_gmres(j_gse(s["g"]), jnp.asarray(s["b"]), params=_params(False),
                 precond=jm, flight=J_OF.FlightParams(capacity=64), **kw)
    op = make_gse_operator(s["tg"])
    tb = torch.from_numpy(s["b"])
    off = solve_gmres(op, tb, params=_params(True), precond=tm, **kw)
    on = solve_gmres(op, tb, params=_params(True), precond=tm,
                     flight=T_OF.FlightParams(capacity=64), **kw)
    assert torch.equal(on.x, off.x)
    np.testing.assert_array_equal(on.x.numpy(), np.asarray(jr.x))
    log = _same_ring(on.flight, jr.flight)
    T_OF.assert_consistent(log, on)
    assert np.all(log.a0 > 0)  # the Givens magnitude


@pytest.mark.parametrize("pcg", [False, True])
def test_small_batched_solves_record_the_reference_rings(pcg, sys12):
    s = sys12
    rng = np.random.default_rng(0)
    blk = np.concatenate([rng.standard_normal((144, 3)), np.zeros((144, 1))],
                         axis=1)
    kw = dict(tol=1e-10, maxiter=400)
    fp = T_OF.FlightParams(capacity=128)
    if pcg:
        jr = J_b.solve_pcg_batched(s["g"], jnp.asarray(blk),
                                   j_jacobi(s["a"], k=8),
                                   params=_params(False),
                                   flight=J_OF.FlightParams(capacity=128),
                                   **kw)
        m = make_jacobi(s["ta"], k=8)
        off = T_b.solve_pcg_batched(s["tg"], torch.from_numpy(blk), m,
                                    params=_params(True), device=CPU, **kw)
        on = T_b.solve_pcg_batched(s["tg"], torch.from_numpy(blk), m,
                                   params=_params(True), flight=fp,
                                   device=CPU, **kw)
    else:
        jr = J_b.solve_cg_batched(s["g"], jnp.asarray(blk),
                                  params=_params(False),
                                  flight=J_OF.FlightParams(capacity=128),
                                  **kw)
        off = T_b.solve_cg_batched(s["tg"], torch.from_numpy(blk),
                                   params=_params(True), device=CPU, **kw)
        on = T_b.solve_cg_batched(s["tg"], torch.from_numpy(blk),
                                  params=_params(True), flight=fp,
                                  device=CPU, **kw)
    assert torch.equal(on.x, off.x)
    np.testing.assert_array_equal(on.x.numpy(), np.asarray(jr.x))
    for k in ("ibuf", "fbuf", "count"):
        np.testing.assert_array_equal(on.flight[k].numpy(),
                                      np.asarray(jr.flight[k]))
    for j, (tc, jc) in enumerate(zip(T_OF.split_batched(on.flight),
                                     J_OF.split_batched(jr.flight))):
        log = _same_ring(tc, jc)
        assert log.recorded == int(on.iters[j])
        assert log.switch_iters().tolist() == on.switch_iters[j].tolist() \
            or j == 3


def test_guard_trip_lands_in_the_health_column(sys12):
    s = sys12
    kw = dict(tol=1e-8, maxiter=400, recover=False)
    jr = J_cg.solve_cg(j_fault(s["g"], mode="indefinite", fail_tag=1),
                       jnp.asarray(s["b"]), params=_params(False),
                       flight=J_OF.FlightParams(capacity=256), **kw)
    tr = T_cg.solve_cg(t_fault(s["tg"], mode="indefinite", fail_tag=1),
                       torch.from_numpy(s["b"]), params=_params(True),
                       flight=T_OF.FlightParams(capacity=256), **kw)
    log = _same_ring(tr.flight, jr.flight)
    T_OF.assert_consistent(log, tr)
    assert int(tr.trip_iter) == int(jr.trip_iter) == 0
    assert log.first_unhealthy() == 0 and log.health.tolist() == [1]


def test_recovered_solve_keeps_the_final_segment(sys12):
    s = sys12
    kw = dict(tol=1e-8, maxiter=3000)
    jr = J_cg.solve_cg(j_fault(s["g"], mode="indefinite", fail_tag=1),
                       jnp.asarray(s["b"]), params=_params(False),
                       flight=J_OF.FlightParams(capacity=256), **kw)
    tr = T_cg.solve_cg(t_fault(s["tg"], mode="indefinite", fail_tag=1),
                       torch.from_numpy(s["b"]), params=_params(True),
                       flight=T_OF.FlightParams(capacity=256), **kw)
    assert bool(tr.converged) and int(tr.tag) > 1
    log = _same_ring(tr.flight, jr.flight)
    T_OF.assert_consistent(log, tr, is_recovered=True)
    assert int(log.tag[-1]) >= 2
