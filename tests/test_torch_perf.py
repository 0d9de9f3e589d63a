"""The port's perf layer (``repro_torch.perf``) against the reference's
(``repro.perf``), on the CPU.

On the same numpy-seeded operators (``poisson2d(8)``, ``poisson2d(12)``,
``sk512_rs8_s0``; ``poisson2d(9)`` where the row count must not be a
multiple of 8):

* launch plans: ``resolve``'s precedence (explicit blocks, plan, tuned
  cache, default) as the reference's; ``shape_class``, ``tag_token`` (ints
  and a ``TagMap``) and ``plan_key`` give the reference's strings; with an
  empty cache ``planned_spmv``/``planned_spmm`` are bitwise the explicit
  default calls (the plain versions here) for tags 1-3 x ell/sell x nrhs
  1/4, and within rtol 2e-5 / atol 1e-4 of the reference's planned calls
  (Pallas in interpret mode; ``tests/test_spmm.py``'s tolerance); every
  autotuner candidate is bitwise the default plan;
* the ledger: ``spmv_ledger`` field for field the reference's (CSR at f64
  and f32 store, ``"ell"``, an ``ELLLayout``, a ``GSESellC``,
  ``jnp_path``, nrhs 1/4); the launch bytes equal to the integer
  arguments ops hands the kernels, and to the reference's
  ``pallas_segment_bytes`` less its padding of the rows to BM;
* the tune cache: persist and replay with no re-sweep, corruption detected
  and healed, ``TUNE_STATS`` and its registry series, a CPU entry that
  never resolves for the card;
* the roofline (``device="cpu"``, quick) persisted, with the reference's
  ``attainable_seconds``/``fraction`` arithmetic; ``timing``'s call
  counts and return values as the reference's;
* the service: ``register(tune=True)`` and ``register(plan=)`` report as
  the reference's service under the same plan, bitwise the untuned
  handle's trajectory.

chip_smoke.py's phase 25 runs the same layer on the card.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.core.tagmap import TagMap as JMap  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.launch import solver_serve as J_s  # noqa: E402
from repro.perf import ledger as J_led  # noqa: E402
from repro.perf import plan as J_plan  # noqa: E402
from repro.perf import roofline as J_roof  # noqa: E402
from repro.perf import timing as J_time  # noqa: E402
from repro.perf import tunecache as J_tc  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro, gsecsr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.core.precision_table import SLOT_BYTES  # noqa: E402
from repro_torch.core.tagmap import TagMap as TMap  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.launch import solver_serve as T_s  # noqa: E402
from repro_torch.obs import metrics as T_OM  # noqa: E402
from repro_torch.perf import autotune as T_auto  # noqa: E402
from repro_torch.perf import ledger as T_led  # noqa: E402
from repro_torch.perf import plan as T_plan  # noqa: E402
from repro_torch.perf import roofline as T_roof  # noqa: E402
from repro_torch.perf import timing as T_time  # noqa: E402
from repro_torch.perf import tunecache as T_tc  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402

CPU = "cpu"
TOL = dict(rtol=2e-5, atol=1e-4)
GSE_ARRAYS = ("rowptr", "colpak", "head", "tail1", "tail2", "table",
              "row_ids")
CASES = {
    "p8": lambda: J_gen.poisson2d(8),
    "p12": lambda: J_gen.poisson2d(12),
    "sk512": lambda: J_gen.diag_rescale(J_gen.skewed_spd(512, seed=0), 8.0,
                                        0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """Both packages' tune caches on empty temporary files."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref.json"))
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "port.json"))
    for tc in (J_tc, T_tc):
        tc.clear_memory()
        tc.reset()
    yield tmp_path
    for tc in (J_tc, T_tc):
        tc.clear_memory()


def _port_csr(a):
    return csr_from_repro({n: np.asarray(getattr(a, n))
                           for n in ("rowptr", "col", "val", "row_ids")},
                          a.shape, device=CPU)


def _pair(a):
    jg = J_csr.pack_csr(a, k=8)
    tg = gsecsr_from_repro({n: np.asarray(getattr(jg, n))
                            for n in GSE_ARRAYS}, jg.ei_bit, jg.shape,
                           device=CPU)
    return jg, tg


@pytest.fixture(scope="module")
def ops_pairs():
    out = {}
    for name, make in CASES.items():
        a = make()
        out[name] = (a, *_pair(a))
    return out


def _x(n, nrhs, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.normal(size=n if nrhs == 1 else (n, nrhs)),
                      np.float32)


def _default_call(tg, x, tag, layout):
    """The explicit default-plan call: (8, 128) blocks, today's kernels."""
    if layout == "ell":
        ell = T_ops.ell_pack_gsecsr(tg)
        row_len = T_ops.ell_row_lengths(tg)
        if x.dim() == 1:
            return T_ops.gse_spmv_ell(ell, tg.table, x, tg.ei_bit, tag=tag,
                                      blocks=(8, 128), row_len=row_len)
        return T_ops.gse_spmm_ell(ell, tg.table, x, tg.ei_bit, tag=tag,
                                  blocks=(8, 128), row_len=row_len,
                                  device=CPU)
    sell = T_ops.sell_pack_gsecsr(tg)
    if x.dim() == 1:
        return T_ops.gse_spmv_sell(sell, x, tag=tag, blocks=(8, 128))
    return T_ops.gse_spmm_sell(sell, x, tag=tag, blocks=(8, 128), device=CPU)


def _planned(tg, x, tag, layout, plan=None):
    if x.dim() == 1:
        return T_ops.planned_spmv(tg, x, tag=tag, layout=layout, plan=plan)
    return T_ops.planned_spmm(tg, x, tag=tag, layout=layout, plan=plan,
                              device=CPU)


def _bitwise(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# --- launch plans -------------------------------------------------------------

def test_resolve_precedence(caches, ops_pairs):
    _, jg, tg = ops_pairs["p8"]
    for P in (J_plan, T_plan):
        assert P.resolve() is P.DEFAULT_PLAN
        assert P.DEFAULT_BLOCKS == (8, 128)
        got = P.resolve(blocks=(16, 128))
        assert (got.blocks, got.source) == ((16, 128), "explicit")
        p = P.KernelPlan(blocks=(32, 128))
        assert P.resolve(plan=p).blocks == (32, 128)
        assert P.resolve(plan=P.DEFAULT_PLAN).source == "explicit"
        assert P.resolve(plan=p, blocks=(8, 256)).blocks == (8, 256)
    for P, g in ((J_plan, jg), (T_plan, tg)):
        got = P.resolve(g, tag=1, layout="ell", nrhs=1)
        assert got == P.DEFAULT_PLAN and got.source == "default"
    # A tuned entry under the same key resolves on both sides.
    key = T_plan.plan_key(T_plan.shape_class(tg), 1, "ell", 1)
    assert key == J_plan.plan_key(J_plan.shape_class(jg), 1, "ell", 1)
    tuned = T_plan.KernelPlan(lanes=16, blocks=(16, 128))
    T_tc.store(key, {"plan": tuned.to_dict()}, device=CPU)
    J_tc.store(key, {"plan": J_plan.KernelPlan(blocks=(16, 128)).to_dict()})
    for P, g in ((J_plan, jg), (T_plan, tg)):
        got = P.resolve(g, tag=1, layout="ell", nrhs=1)
        assert (got.blocks, got.source) == ((16, 128), "tuned")
        assert P.resolve(g, tag=1, layout="ell", nrhs=4) == P.DEFAULT_PLAN
        assert P.resolve(g, tag=1, layout="ell",
                         plan=P.KernelPlan()).source == "explicit"
    assert T_plan.resolve(tg, tag=1, layout="ell").lanes == 16
    assert T_plan.resolve(tg, tag=1, layout="ell") == tuned
    assert T_plan.KernelPlan.from_dict(tuned.to_dict()) == tuned


@pytest.mark.parametrize("case", sorted(CASES))
def test_keys_equal_the_reference(case, ops_pairs):
    a, jg, tg = ops_pairs[case]
    js, ts = J_ops.sell_pack_gsecsr(jg), T_ops.sell_pack_gsecsr(tg)
    for j, t in ((a, _port_csr(a)), (jg, tg), (js, ts)):
        assert T_plan.shape_class(t) == J_plan.shape_class(j)
    tags = (np.arange(-(-tg.shape[0] // 8)) % 3 + 1).astype(np.uint8)
    for jt, tt in [(t, t) for t in (1, 2, 3)] + [(JMap(tags), TMap(tags))]:
        assert T_plan.tag_token(tt) == J_plan.tag_token(jt)
        for layout in ("ell", "sell"):
            for nrhs in (1, 4):
                assert T_plan.plan_key(T_plan.shape_class(tg), tt, layout,
                                       nrhs) == J_plan.plan_key(
                    J_plan.shape_class(jg), jt, layout, nrhs)
    assert T_plan.tag_token(TMap(tags)).startswith("map")


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("layout", ["ell", "sell"])
@pytest.mark.parametrize("nrhs", [1, 4])
def test_empty_cache_bit_identity(caches, ops_pairs, tag, layout, nrhs):
    """With an empty cache the planned calls are bitwise the explicit
    default calls, and agree with the reference's planned calls."""
    _, jg, tg = ops_pairs["p8"]
    xn = _x(tg.shape[1], nrhs, tag * 10 + nrhs)
    x = torch.from_numpy(xn)
    got = _planned(tg, x, tag, layout)
    assert _bitwise(got, _default_call(tg, x, tag, layout))
    planned = J_ops.planned_spmv if nrhs == 1 else J_ops.planned_spmm
    want = np.asarray(planned(jg, jnp.asarray(xn), tag=tag, layout=layout))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_for_default_blocks_unchanged(ops_pairs):
    """blocks=None resolves to (8, 128): the same cached callable."""
    _, _, tg = ops_pairs["p8"]
    for kernel_for in (T_ops.spmv_kernel_for, T_ops.spmm_kernel_for):
        assert kernel_for(1, tg.ei_bit) is kernel_for(1, tg.ei_bit,
                                                      blocks=(8, 128))
    for kernel_for in (T_ops.sell_kernel_for, T_ops.sell_spmm_kernel_for):
        assert kernel_for(2, tg.ei_bit) is kernel_for(2, tg.ei_bit,
                                                      blocks=(8, 128))


@pytest.mark.parametrize("case", ["p8", "sk512"])
@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_every_candidate_is_bitwise_the_default(caches, ops_pairs, case,
                                                layout):
    _, jg, tg = ops_pairs[case]
    if layout == "sell":  # the reference's SELL candidates, every one
        from repro.perf import autotune as J_auto

        assert [(p.blocks, p.sell_c, p.sell_sigma, p.sell_bucket)
                for p in T_auto.candidates("sell")] == [
            (p.blocks, p.sell_c, p.sell_sigma, p.sell_bucket)
            for p in J_auto.candidates("sell")]
    else:
        assert [p.lanes for p in T_auto.candidates("ell")] == [8, 4, 16, 32]
    assert T_auto.candidates(layout)[0] == T_plan.DEFAULT_PLAN
    for nrhs in (1, 4):
        x = torch.from_numpy(_x(tg.shape[1], nrhs, nrhs))
        for tag in (1, 2, 3):
            want = _planned(tg, x, tag, layout, plan=T_plan.DEFAULT_PLAN)
            for cand in T_auto.candidates(layout)[1:]:
                assert _bitwise(_planned(tg, x, tag, layout, plan=cand),
                                want), (cand, tag, nrhs)


def test_grid_tiles_are_checked_as_the_reference_checks_them(ops_pairs):
    _, jg, tg = ops_pairs["p8"]
    js, ts = J_ops.sell_pack_gsecsr(jg), T_ops.sell_pack_gsecsr(tg)
    for blocks in ((16, 128), (8, 256)):
        with pytest.raises(ValueError):
            J_led.pallas_segment_bytes(js, 1, blocks=blocks)
        with pytest.raises(ValueError):
            T_led.launch_segment_bytes(ts, 1, blocks=blocks)
        with pytest.raises(ValueError):
            T_ops.gse_spmv_sell(ts, torch.zeros(ts.shape[1]), blocks=blocks)
    packed = T_ops.gse_decode  # kernel D's and E's tiles: positive ints
    from repro_torch.core import gse as T_gse

    w = T_gse.pack(torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 8))), k=8, device=CPU)
    dense = packed(w, tag=2, device=CPU)
    assert torch.equal(packed(w, tag=2, block=(8, 128), device=CPU), dense)
    assert torch.equal(T_ops.gse_matmul(torch.ones(2, 16), w, tag=2,
                                        blocks=(8, 128, 128), device=CPU),
                       T_ops.gse_matmul(torch.ones(2, 16), w, tag=2,
                                        device=CPU))
    for bad in ((8,), (0, 128), (8.0, 128)):
        with pytest.raises(ValueError, match="positive ints"):
            packed(w, tag=2, block=bad, device=CPU)
    with pytest.raises(ValueError, match="positive ints"):
        T_ops.gse_matmul(torch.ones(2, 16), w, blocks=(8, 128), device=CPU)


# --- the ledger ---------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_spmv_ledger_equals_the_reference(case, ops_pairs):
    a, jg, tg = ops_pairs[case]
    js, ts = J_ops.sell_pack_gsecsr(jg), T_ops.sell_pack_gsecsr(tg)
    jl, tl = J_csr.ell_layout(jg), T_csr.ell_layout(tg)
    ta = _port_csr(a)
    rows = []
    for nrhs in (1, 4):
        for jdt, tdt in ((jnp.float64, torch.float64),
                         (jnp.float32, torch.float32)):
            rows.append((J_led.spmv_ledger(a, nrhs=nrhs, store_dtype=jdt),
                         T_led.spmv_ledger(ta, nrhs=nrhs, store_dtype=tdt)))
            rows.append((J_led.spmv_ledger(a, nrhs=nrhs, vec_dtype=jdt),
                         T_led.spmv_ledger(ta, nrhs=nrhs, vec_dtype=tdt)))
        for tag in (1, 2, 3):
            for jlay, tlay in ((None, None), ("ell", "ell"), (jl, tl),
                               (js, ts)):
                for jnp_path in (False, True):
                    rows.append((
                        J_led.spmv_ledger(jg, tag=tag, layout=jlay,
                                          nrhs=nrhs, jnp_path=jnp_path),
                        T_led.spmv_ledger(tg, tag=tag, layout=tlay,
                                          nrhs=nrhs, jnp_path=jnp_path)))
            rows.append((J_led.spmv_ledger(js, tag=tag, nrhs=nrhs),
                         T_led.spmv_ledger(ts, tag=tag, nrhs=nrhs)))
    for j, t in rows:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.bytes == j.bytes
    led = T_led.spmv_ledger(tg, tag=1, layout="ell")
    got = T_led.achieved(led, 1e-3, roof={"stream_gbps": 10.0,
                                          "peak_gflops": 100.0})
    want = J_led.achieved(J_led.spmv_ledger(jg, tag=1, layout="ell"), 1e-3,
                          roof={"stream_gbps": 10.0, "peak_gflops": 100.0})
    assert got == want


@pytest.mark.parametrize("case", ["p8", "p9", "sk512"])
def test_launch_bytes_are_the_recorded_arguments(case, ops_pairs):
    """The ledger's launch bytes equal the integer tensors ops hands the
    kernel function; against the reference's ``pallas_segment_bytes`` they
    are equal on a SELL pack and where the rows are a multiple of 8, and
    smaller by exactly the reference's padding of the rows to 8 elsewhere
    (``poisson2d(9)``, 81 rows)."""
    if case == "p9":
        a = J_gen.poisson2d(9)
        jg, tg = _pair(a)
    else:
        _, jg, tg = ops_pairs[case]
    rows = tg.shape[0]
    js, ts = J_ops.sell_pack_gsecsr(jg), T_ops.sell_pack_gsecsr(tg)
    ell, row_len = T_ops.ell_pack_gsecsr(tg), T_ops.ell_row_lengths(tg)
    width = ell[0].shape[1]
    for nrhs in (1, 4):
        x = torch.from_numpy(_x(tg.shape[1], nrhs, 0))
        for tag in (1, 2, 3):
            if nrhs == 1:
                got_e = T_led.recorded_launch_bytes(
                    T_ops.gse_spmv_ell, ell, tg.table, x, tg.ei_bit, tag=tag,
                    row_len=row_len)
                got_s = T_led.recorded_launch_bytes(T_ops.gse_spmv_sell, ts,
                                                    x, tag=tag)
            else:
                got_e = T_led.recorded_launch_bytes(
                    T_ops.gse_spmm_ell, ell, tg.table, x, tg.ei_bit, tag=tag,
                    row_len=row_len, device=CPU)
                got_s = T_led.recorded_launch_bytes(
                    T_ops.gse_spmm_sell, ts, x, tag=tag, device=CPU)
            assert got_e["launches"] == got_s["launches"] == 1
            assert got_e["segments"] == T_led.launch_segment_bytes(tg, tag)
            assert got_e["index"] == T_led.launch_index_bytes(tg) == rows * 4
            assert got_s["segments"] == T_led.launch_segment_bytes(ts, tag)
            assert got_s["index"] == T_led.launch_index_bytes(ts)
            assert got_s["segments"] == J_led.pallas_segment_bytes(js, tag)
            pad = (-rows) % 8
            assert J_led.pallas_segment_bytes(jg, tag) - got_e["segments"] \
                == pad * width * SLOT_BYTES[tag]
            assert (pad == 0) == (case != "p9")
            planned = T_led.recorded_launch_bytes(_planned, tg, x, tag,
                                                  "ell")
            assert planned["segments"] == got_e["segments"]
            assert torch.equal(planned["out"], got_e["out"])
    assert T_ops.gse_spmv_ell is not None  # the kernels are restored
    from repro_torch.kernels import gse_spmv as T_k

    assert T_ops.gse_spmv_ell_f32 is T_k.gse_spmv_ell_f32


# --- the tune cache -------------------------------------------------------------

def test_tune_persist_replay_and_corruption(caches, ops_pairs):
    _, jg, tg = ops_pairs["p8"]
    plan1, payload1, hit1 = T_auto.get_or_tune(tg, tag=1, layout="ell",
                                               iters=1, warmup=1)
    assert not hit1
    assert T_tc.TUNE_STATS["sweeps"] == 1 and T_tc.TUNE_STATS["stores"] == 1
    assert set(payload1) == {"plan", "us", "default_us", "sweep",
                             "decode_bound"}
    assert payload1["default_us"] >= payload1["us"] > 0
    assert len(payload1["sweep"]) == len(T_auto.candidates("ell"))
    assert payload1["decode_bound"] == (tg.nnz < T_auto.DECODE_BOUND_NNZ)
    path = caches / "port.json"
    assert path.exists() and not (caches / "ref.json").exists()
    plan2, payload2, hit2 = T_auto.get_or_tune(tg, tag=1, layout="ell")
    assert hit2 and plan2 == plan1 and payload2 == payload1
    T_tc.clear_memory()
    plan3, _, hit3 = T_auto.get_or_tune(tg, tag=1, layout="ell")
    assert hit3 and plan3 == plan1
    assert T_tc.TUNE_STATS["sweeps"] == 1
    got = T_plan.resolve(tg, tag=1, layout="ell", nrhs=1)
    assert got == plan1 and got.source == "tuned"
    x = torch.from_numpy(_x(tg.shape[1], 1, 0))
    assert _bitwise(T_ops.planned_spmv(tg, x, tag=1),
                    _default_call(tg, x, 1, "ell"))
    # A flipped payload (crc kept): detected, dropped, re-swept.
    blob = json.loads(path.read_text())
    key = next(iter(blob["devices"]["cpu"]["plans"]))
    blob["devices"]["cpu"]["plans"][key]["payload"]["us"] = -1.0
    path.write_text(json.dumps(blob))
    T_tc.clear_memory()
    assert T_tc.lookup(key, device=CPU) is None
    assert T_tc.TUNE_STATS["corrupt"] == 1
    _, payload, hit = T_auto.get_or_tune(tg, tag=1, layout="ell", iters=1,
                                         warmup=1)
    assert not hit and payload["us"] > 0
    assert T_tc.TUNE_STATS["sweeps"] == 2
    # TUNE_STATS is the registry's series, under the reference's name.
    text = T_OM.REGISTRY.to_prometheus()
    assert "# TYPE repro_tune_cache_events_total counter" in text
    assert 'repro_tune_cache_events_total{event="corrupt"} 1' in text
    assert dict(T_tc.TUNE_STATS) == {
        "hits": T_tc.TUNE_STATS["hits"], "misses": T_tc.TUNE_STATS["misses"],
        "corrupt": 1, "sweeps": 2, "stores": 2}


def test_sell_tune_and_tuned_sell_dispatch(caches, ops_pairs):
    _, jg, tg = ops_pairs["sk512"]
    plan, payload, hit = T_auto.get_or_tune(tg, tag=2, layout="sell",
                                            nrhs=4, iters=1, warmup=1)
    assert not hit and len(payload["sweep"]) == 5
    assert T_plan.resolve(tg, tag=2, layout="sell", nrhs=4) == plan
    x = torch.from_numpy(_x(tg.shape[1], 4, 5))
    assert _bitwise(T_ops.planned_spmm(tg, x, tag=2, layout="sell",
                                       device=CPU),
                    _default_call(tg, x, 2, "sell"))
    # A tuned plan whose grid does not tile another pack falls back.
    sell = T_ops.sell_pack_gsecsr(tg)
    key = T_plan.plan_key(T_plan.shape_class(sell), 1, "sell", 1)
    T_tc.store(key, {"plan": T_plan.KernelPlan(blocks=(16, 128)).to_dict()},
               device=CPU)
    assert _bitwise(T_ops.gse_spmv_sell(sell, x[:, 0], tag=1),
                    _default_call(tg, x[:, 0], 1, "sell"))


def test_cpu_entries_never_resolve_on_the_card(caches, ops_pairs,
                                               monkeypatch):
    _, _, tg = ops_pairs["p8"]
    plan, _, _ = T_auto.get_or_tune(tg, tag=1, layout="ell", iters=1,
                                    warmup=1)
    T_roof.host_roofline(device=CPU, quick=True)
    key = T_plan.plan_key(T_plan.shape_class(tg), 1, "ell", 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert T_tc.device_name("cuda") == "cuda:NVIDIA H100 80GB HBM3"
    assert T_tc.device_name(CPU) == "cpu"
    assert T_tc.lookup(key, device="cuda") is None
    assert T_tc.host_entry("cuda") is None
    assert T_tc.lookup(key, device=CPU)["plan"] == plan.to_dict()
    T_tc.store(key, {"plan": T_plan.KernelPlan(lanes=32).to_dict()},
               device="cuda")
    T_tc.clear_memory()
    assert T_tc.lookup(key, device="cuda")["plan"]["lanes"] == 32
    assert T_tc.lookup(key, device=CPU)["plan"] == plan.to_dict()
    blob = json.loads((caches / "port.json").read_text())
    assert sorted(blob["devices"]) == ["cpu", "cuda:NVIDIA H100 80GB HBM3"]
    assert blob["devices"]["cuda:NVIDIA H100 80GB HBM3"]["host"] is None


# --- roofline and timing --------------------------------------------------------

def test_host_roofline_persisted(caches):
    r1 = T_roof.host_roofline(device=CPU, quick=True)
    assert r1["probed"] and r1["stream_gbps"] > 0 and r1["peak_gflops"] > 0
    assert (r1["device"], r1["stream_n"], r1["matmul_n"]) == (
        "cpu", 1 << 21, 512)
    r2 = T_roof.host_roofline(device=CPU, quick=True)
    assert not r2["probed"]
    assert (r2["stream_gbps"], r2["peak_gflops"]) == (r1["stream_gbps"],
                                                      r1["peak_gflops"])
    assert T_roof.host_roofline(device=CPU, quick=True, refresh=True)[
        "probed"]
    for flops, nbytes, sec in ((1e9, 1e9, 0.5), (1e12, 1e6, 2.0),
                               (0, 3e8, 1e-3)):
        assert T_roof.attainable_seconds(flops, nbytes, r1) == \
            J_roof.attainable_seconds(flops, nbytes, r1)
        assert T_roof.fraction(flops, nbytes, sec, r1) == \
            J_roof.fraction(flops, nbytes, sec, r1)
    att = T_roof.attainable_seconds(1e9, 1e9, r1)
    assert T_roof.fraction(1e9, 1e9, att, r1) == pytest.approx(1.0)


def test_measure_semantics():
    for mod in (T_time, J_time):
        calls = []

        def fn(k, scale=1.0):
            calls.append(k)
            return np.float64(len(calls) * scale)

        out, best = mod.measure(fn, 7, iters=3, warmup=2, scale=2.0)
        assert (len(calls), out, set(calls)) == (5, 10.0, {7})
        assert 0 <= best < 1
        calls.clear()
        out, first, best = mod.measure_split(fn, 1, iters=4, warmup=3)
        assert (len(calls), out) == (7, 7.0)
        assert first >= 0 and best >= 0
        calls.clear()
        mod.measure(fn, 1, iters=2, warmup=0)
        assert len(calls) == 2
        calls.clear()
        assert mod.best_seconds(fn, 1, iters=1, warmup=1) >= 0
        assert len(calls) == 2
        for f in (mod.measure, mod.measure_split, mod.best_seconds):
            with pytest.raises(ValueError, match="iters"):
                f(fn, 1, iters=0)
    out, best = T_time.measure(lambda: (torch.ones(3), [torch.zeros(1)]),
                               iters=2)
    assert torch.equal(out[0], torch.ones(3)) and best >= 0


def test_perf_entry_points_default_to_the_card():
    """The layer's entry points run on the card unless asked for the CPU;
    the tuner and the dispatcher follow the operand's device."""
    import inspect

    for fn in (T_roof.host_roofline, T_roof.probe_stream_gbps,
               T_roof.probe_peak_gflops, T_tc.lookup, T_tc.store,
               T_tc.host_entry, T_tc.store_host, T_tc.device_name,
               T_ops.planned_spmm):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn.__qualname__
    for fn in (T_auto.tune, T_auto.get_or_tune, T_plan.resolve,
               T_ops.planned_spmv):
        assert "device" not in inspect.signature(fn).parameters


# --- the service ----------------------------------------------------------------

def _skewed_small():
    """tests/test_torch_sell.py's small skewed operator: its SELL packs
    differ by plan (slots 44032, 47104, 53248, 47104, 43008)."""
    return J_gen.skewed_spd(320, dense_rows=2, base_halfwidth=10,
                            tail_scale=6.0, seed=0)


def _serve(mod, a, b, device, **register):
    kw = {} if device is None else dict(device=device)
    prec = J_P if mod is J_s else T_P
    svc = mod.SolverService(slots=2, params=prec.MonitorParams(t=40, l=60,
                                                               m=30),
                            maxiter=2000, **kw)
    svc.register("op", a, k=8, layout="sell", **register)
    rid = svc.submit("op", jnp.asarray(b) if mod is J_s
                     else torch.from_numpy(b), tol=1e-8)
    rep = svc.flush()[rid]
    d = dataclasses.asdict(rep)
    d["switch_iters"] = np.asarray(rep.switch_iters).tolist()
    d["relres"] = np.float64(rep.relres).view(np.uint64)
    return svc, d, np.asarray(svc.solution(rid))


def test_register_tune_and_plan_equal_the_reference(caches):
    """register(tune=True) (both caches holding the same stored winner
    under the same key) and register(plan=) report as the reference's
    service does; the trajectory and x are the untuned handle's."""
    a = _skewed_small()
    ta = _port_csr(a)
    b = np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(0).normal(size=a.shape[0]))))
    _, base, x0 = _serve(T_s, ta, b, CPU)
    jg, tg = _pair(a)
    key = T_plan.plan_key(T_plan.shape_class(tg), 1, "sell", 1)
    assert key == J_plan.plan_key(J_plan.shape_class(jg), 1, "sell", 1)
    jplan = J_plan.KernelPlan(blocks=(16, 128), sell_c=16, sell_sigma=64)
    tplan = T_plan.KernelPlan(blocks=(16, 128), sell_c=16, sell_sigma=64)
    J_tc.store(key, {"plan": jplan.to_dict()})
    T_tc.store(key, {"plan": tplan.to_dict()}, device=CPU)
    runs = [(_serve(J_s, a, b, None, tune=True),
             _serve(T_s, ta, b, CPU, tune=True))]
    for jp, tp in ((J_plan.KernelPlan(sell_bucket="exact"),
                    T_plan.KernelPlan(sell_bucket="exact")),
                   (J_plan.KernelPlan(sell_c=8, sell_sigma=32),
                    T_plan.KernelPlan(sell_c=8, sell_sigma=32))):
        runs.append((_serve(J_s, a, b, None, plan=jp),
                     _serve(T_s, ta, b, CPU, plan=tp)))
    assert T_tc.TUNE_STATS["sweeps"] == 0  # the stored winner: a hit
    seen = set()
    for (jsvc, jrep, jx), (tsvc, trep, tx) in runs:
        assert trep == jrep
        assert dict(tsvc.stats) == dict(jsvc.stats)
        assert np.array_equal(tx.view(np.uint64), jx.view(np.uint64))
        assert np.array_equal(tx.view(np.uint64), x0.view(np.uint64))
        assert {k: v for k, v in trep.items() if k != "est_bytes"} == \
            {k: v for k, v in base.items() if k != "est_bytes"}
        op = tsvc._ops["op"]
        assert op.plan is not None
        assert (op.gse.c, op.gse.slots) == (jsvc._ops["op"].gse.c,
                                            jsvc._ops["op"].gse.slots)
        seen.add(trep["est_bytes"])
    assert len(seen | {base["est_bytes"]}) == 4  # every pack bills its own
