"""Stepped CG over the port's SELL-C-sigma pack against the JAX reference.

``sk512_rs8_s0`` -- ``diag_rescale(skewed_spd(512, seed=0), 8, 0)`` packed
at k=8 and then to SELL-C-sigma with the default plan (C=8, a full sort,
lane 128, pow2 buckets: widths 128/256/512) -- is solved once in each
package (module fixtures), ``b_j = A x_j`` with ``x_j =
default_rng(j).normal(512)``, tol 1e-8, ``MonitorParams(40, 60, 30)``.
The solo solve steps at [210, 300] and converges in 1498 iterations at
tag 3; the port's iterations, tag, schedule, ``relres`` and ``x`` are the
reference's bit for bit and the port's CSR solve's.  The batched solve
over ``[b_0, b_1, b_2, 0]`` equals the reference's field for field.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as J_P  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.solvers import batched as J_b  # noqa: E402
from repro.solvers import cg as J_cg  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.convert import csr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.solvers import batched as T_b  # noqa: E402
from repro_torch.solvers.cg import solve_cg  # noqa: E402
from repro_torch.solvers.operators import make_gse_operator  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402

QS = dict(t=40, l=60, m=30)
CPU = "cpu"
KW = dict(tol=1e-8, maxiter=20000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solver loops run thousands of tiny CPU ops: one intra-op thread
    is faster than a pool and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(v):
    return np.asarray(v, dtype=np.float64).view(np.uint64)


@pytest.fixture(scope="module")
def case():
    a = J_gen.diag_rescale(J_gen.skewed_spd(512, seed=0), 8.0, 0)
    jg = J_csr.pack_csr(a, k=8)
    ta = csr_from_repro({n: np.asarray(getattr(a, n))
                         for n in ("rowptr", "col", "val", "row_ids")},
                        a.shape, device=CPU)
    tg = T_csr.pack_csr(ta, k=8)
    bs = [np.array(j_spmv(a, jnp.asarray(
        np.random.default_rng(j).normal(size=512)))) for j in range(3)]
    return dict(jg=jg, tg=tg, js=J_ops.sell_pack_gsecsr(jg),
                ts=T_ops.sell_pack_gsecsr(tg), bs=bs)


@pytest.fixture(scope="module")
def solo(case):
    b = case["bs"][0]
    jr = J_cg.solve_cg(case["js"], jnp.asarray(b),
                       params=J_P.MonitorParams(**QS), **KW)
    tr = solve_cg(case["ts"], torch.from_numpy(b),
                  params=T_P.MonitorParams(**QS), **KW)
    return jr, tr


def test_the_pack_is_the_reference_case(case):
    ts = case["ts"]
    assert ts.widths == (128, 256, 512)
    assert ts.bucket_rows == (496, 8, 8)
    assert ts.nnz == 63964 and ts.slots == 69632
    assert [ts.bytes_touched(t) for t in (1, 2, 3)] == [419872, 559136,
                                                        837664]
    assert T_csr.iteration_stream_bytes(ts, 1, nrhs=4) == 444448


def test_solo_sell_solve_equals_the_reference(solo):
    jr, tr = solo
    assert int(tr.iters) == int(jr.iters) == 1498
    assert int(tr.tag) == int(jr.tag) == 3
    assert tr.switch_iters.tolist() == np.asarray(jr.switch_iters).tolist() \
        == [210, 300]
    assert bool(tr.converged) and int(tr.health) == int(jr.health)
    assert _bits(float(tr.relres)) == _bits(float(jr.relres))
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))


def test_solo_sell_solve_is_bitwise_the_csr_solve(case, solo):
    _, tr = solo
    tc = solve_cg(case["tg"], torch.from_numpy(case["bs"][0]),
                  params=T_P.MonitorParams(**QS), **KW)
    for f in ("iters", "tag", "switch_iters", "relres", "converged",
              "health", "trip_iter"):
        assert torch.equal(torch.as_tensor(getattr(tc, f)),
                           torch.as_tensor(getattr(tr, f))), f
    assert torch.equal(tc.x.view(torch.int64), tr.x.view(torch.int64))


def test_generic_operator_over_sell_equals_the_fused_path(case):
    b = torch.from_numpy(case["bs"][1])
    kw = dict(tol=1e-8, maxiter=256, params=T_P.MonitorParams(**QS))
    fused = solve_cg(case["ts"], b, **kw)
    generic = solve_cg(make_gse_operator(case["ts"]), b, **kw)
    assert int(fused.iters) == int(generic.iters) == 256
    assert fused.switch_iters.tolist() == generic.switch_iters.tolist()
    assert torch.equal(fused.x.view(torch.int64), generic.x.view(torch.int64))


@pytest.fixture(scope="module")
def batched(case):
    b = np.stack(case["bs"] + [np.zeros(512)], axis=1)
    jr = J_b.solve_cg_batched(case["js"], jnp.asarray(b),
                              params=J_P.MonitorParams(**QS), **KW)
    tr = T_b.solve_cg_batched(case["ts"], torch.from_numpy(b),
                              params=T_P.MonitorParams(**QS), device=CPU, **KW)
    return jr, tr


def test_batched_sell_solve_equals_the_reference(batched):
    jr, tr = batched
    assert tr.iters.tolist() == np.asarray(jr.iters).tolist() == [
        1498, 1498, 1678, 0]
    assert tr.tag.tolist() == np.asarray(jr.tag).tolist() == [3, 3, 3, 1]
    assert tr.switch_iters.tolist() == np.asarray(jr.switch_iters).tolist() \
        == [[210, 300], [150, 180], [120, 150], [-1, -1]]
    for f in ("converged", "health", "trip_iter"):
        assert np.asarray(getattr(tr, f)).tolist() == \
            np.asarray(getattr(jr, f)).tolist(), f
    np.testing.assert_array_equal(_bits(tr.relres.numpy()), _bits(jr.relres))
    np.testing.assert_array_equal(_bits(tr.x.numpy()), _bits(jr.x))


def test_batched_column_zero_is_the_solo_solve(batched, solo):
    _, tr = batched
    _, ts = solo
    assert torch.equal(tr.x[:, 0].contiguous().view(torch.int64),
                       ts.x.view(torch.int64))


def test_batched_run_bytes_over_sell_equals_the_reference(case, batched):
    jr, tr = batched
    want = J_b.batched_run_bytes(case["js"], jr.iters, jr.switch_iters)
    assert T_b.batched_run_bytes(case["ts"], tr.iters,
                                 tr.switch_iters) == want
    # The padded slots are charged: more than the nnz-only CSR account.
    assert want > J_b.batched_run_bytes(case["jg"], jr.iters,
                                        jr.switch_iters)
