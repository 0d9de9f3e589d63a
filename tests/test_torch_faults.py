"""The port's fault injection against the JAX reference.

``bitflip_array`` and the ``make_wire_fault`` hook flip the reference's
bits for the same seeds (numpy, tensors, every width); ``gsecsr_checksums``
are the reference's CRC32s of the same pack and ``verify_gsecsr`` names
each corrupted segment; ``corrupt_pack_cache`` on the port's ELL cache
makes the next ``ell_pack_gsecsr`` repack and count one ``corrupt`` event
in the registry; and ``make_tag_fault_operator`` through ``solve_cg`` with
guards and recovery trips at tag 1 and recovers with the reference's
numbers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.robustness import faults as J_f  # noqa: E402
from repro.solvers import cg as J_cg  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import gsecsr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.obs import metrics as T_OM  # noqa: E402
from repro_torch.robustness import faults as T_f  # noqa: E402
from repro_torch.robustness.guards import HEALTH_OK  # noqa: E402
from repro_torch.solvers import cg as T_cg  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402

CPU = "cpu"
DTYPES = [np.float64, np.float32, np.float16, np.uint16, np.uint32,
          np.int32, np.uint8, np.int64]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pack():
    a = J_gen.poisson2d(24)
    g = J_csr.pack_csr(a, k=8)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    b = np.array(j_spmv(a, jnp.ones(a.shape[1])))
    return dict(a=a, g=g, tg=tg, b=b)


def _values(dtype, n=97, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype,
                        endpoint=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("seed,nflips", [(0, 1), (5, 3), (11, 40)])
def test_bitflip_array_flips_the_reference_bits(dtype, seed, nflips):
    a = _values(dtype)
    want = J_f.bitflip_array(a, seed, nflips)
    got = T_f.bitflip_array(a, seed, nflips)
    assert isinstance(got, np.ndarray) and got.dtype == a.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    t = torch.from_numpy(a.copy())
    flipped = T_f.bitflip_array(t, seed, nflips)
    assert isinstance(flipped, torch.Tensor) and flipped.dtype == t.dtype
    assert flipped.device == t.device
    np.testing.assert_array_equal(flipped.numpy().view(np.uint8),
                                  want.view(np.uint8))
    assert torch.equal(t, torch.from_numpy(a))  # the input is untouched
    # The same positions again undo the flips.
    np.testing.assert_array_equal(T_f.bitflip_array(got, seed, nflips), a)


def test_bitflip_array_on_bfloat16_and_edge_cases():
    a = _values(np.float32, 33)
    t = torch.from_numpy(a).to(torch.bfloat16)
    want = np.asarray(J_f.bitflip_array(jnp.asarray(t.float().numpy(),
                                                    jnp.bfloat16), 3, 2))
    got = T_f.bitflip_array(t, 3, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    empty = np.zeros(0, np.float64)
    assert T_f.bitflip_array(empty, 0).size == 0
    np.testing.assert_array_equal(T_f.bitflip_array(a, 0, nflips=0), a)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint16,
                                   np.uint32, np.int32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("seed,nflips", [(0, 1), (7, 5)])
def test_wire_fault_hook_flips_the_reference_bits(dtype, seed, nflips):
    a = _values(dtype, 64).reshape(8, 8)
    want = np.asarray(J_f.make_wire_fault("head", seed, nflips)(
        "head", jnp.asarray(a)))
    hook = T_f.make_wire_fault("head", seed, nflips)
    t = torch.from_numpy(a.copy())
    got = hook("head", t)
    assert got.shape == t.shape and got.dtype == t.dtype
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  want.view(np.uint8))
    assert torch.equal(t, torch.from_numpy(a))
    assert hook("tail1", t) is t  # another payload crosses untouched


def test_checksums_are_the_reference_and_name_each_segment(pack):
    g, tg = pack["g"], pack["tg"]
    ref = J_f.gsecsr_checksums(g)
    assert T_f.gsecsr_checksums(tg) == ref
    # The port's own pack of the same matrix holds the same bits.
    own = T_csr.pack_csr(T_gen.poisson2d(24, device=CPU), k=8)
    assert T_f.gsecsr_checksums(own) == ref
    assert T_f.verify_gsecsr(tg, ref) == []
    for target in T_f.GSECSR_SEGMENTS:
        for seed in (0, 1, 2):
            bad = T_f.corrupt_gsecsr(tg, target, seed)
            jbad = J_f.corrupt_gsecsr(g, target, seed)
            assert T_f.verify_gsecsr(bad, ref) == [target]
            np.testing.assert_array_equal(getattr(bad, target).numpy(),
                                          np.asarray(getattr(jbad, target)))
        assert T_f.verify_gsecsr(tg, ref) == []  # the original untouched
    with pytest.raises(ValueError, match="target"):
        T_f.corrupt_gsecsr(tg, "rowptr", 0)


def _corrupt_count():
    text = T_OM.REGISTRY.to_prometheus()
    line = [ln for ln in text.splitlines() if ln.startswith(
        'repro_pack_cache_events_total{event="corrupt"}')]
    return int(line[0].split()[-1])


def test_a_corrupted_ell_pack_is_repacked(pack):
    tg = T_csr.pack_csr(T_gen.poisson2d(24, device=CPU), k=8)
    assert not T_f.corrupt_pack_cache(tg)  # nothing cached yet
    clean = [t.clone() for t in T_ops.ell_pack_gsecsr(tg)]
    assert not T_f.corrupt_pack_cache(tg, key=("nope",))
    before, reg_before = T_ops.PACK_STATS["corrupt"], _corrupt_count()
    misses = T_ops.PACK_STATS["misses"]
    assert T_f.corrupt_pack_cache(tg, seed=0)
    entry, _ = tg.__dict__["_pack_cache"][("ell", T_ops.LANE)]
    assert any(not torch.equal(e, c) for e, c in zip(entry, clean))
    repacked = T_ops.ell_pack_gsecsr(tg)  # a hit, a checksum miss, a repack
    assert T_ops.PACK_STATS["corrupt"] == before + 1
    assert _corrupt_count() == reg_before + 1
    assert T_ops.PACK_STATS["misses"] == misses + 1
    for got, want in zip(repacked, clean):
        assert torch.equal(got, want)
    T_ops.ell_pack_gsecsr(tg)  # the repacked entry is healthy
    assert T_ops.PACK_STATS["corrupt"] == before + 1
    T_ops.sell_pack_gsecsr(tg)
    with pytest.raises(TypeError, match="tree of tensors"):
        T_f.corrupt_pack_cache(tg, key=("sell", T_ops.SELL_C, T_ops.SELL_SIGMA,
                                        T_ops.LANE, T_ops.SELL_BUCKET))


@pytest.mark.parametrize("mode,fail_tag", [("indefinite", 1), ("nan", 1),
                                           ("indefinite", 2)])
def test_tag_fault_recovery_gives_the_reference_numbers(mode, fail_tag,
                                                        pack):
    fast = dict(t=30, l=30, m=15)
    kw = dict(tol=1e-8, maxiter=2000)
    rj = J_cg.solve_cg(J_f.make_tag_fault_operator(pack["g"], mode=mode,
                                                   fail_tag=fail_tag),
                       jnp.asarray(pack["b"]),
                       params=J_P.MonitorParams(**fast), **kw)
    rt = T_cg.solve_cg(T_f.make_tag_fault_operator(pack["tg"], mode=mode,
                                                   fail_tag=fail_tag),
                       torch.from_numpy(pack["b"]),
                       params=T_P.MonitorParams(**fast), **kw)
    assert int(rt.trip_iter) == int(rj.trip_iter) == 0
    assert int(rt.tag) == int(rj.tag) > fail_tag
    assert bool(rt.converged) and int(rt.health) == HEALTH_OK
    assert (int(rt.iters), rt.switch_iters.tolist()) == (
        int(rj.iters), np.asarray(rj.switch_iters).tolist())
    np.testing.assert_array_equal(rt.x.numpy(), np.asarray(rj.x))
    with pytest.raises(ValueError, match="mode"):
        T_f.make_tag_fault_operator(pack["tg"], mode="flip")
