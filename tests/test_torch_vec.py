"""The CG loop's vector kernels round as the JAX reference's CG step.

``seq_dot`` and ``fma_axpy`` (``repro_torch.kernels.vec_f64``) reproduce
how XLA's CPU backend compiles ``jnp.vdot`` and ``x + alpha * p`` inside
the reference's jitted solver.  Here, on the CPU, their plain versions run
and are held bitwise to the jitted reference ops, and the fused CG step
built from them to the reference's jitted step.
"""
import ctypes
import ctypes.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.solvers.fused_cg import fused_cg_step_g as j_step  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402

from repro_torch.convert import gsecsr_from_repro  # noqa: E402
from repro_torch.kernels import vec_f64 as V  # noqa: E402
from repro_torch.solvers.fused_cg import fused_cg_step_g  # noqa: E402

_vdot = jax.jit(jnp.vdot)


def _bits(t):
    return np.asarray(t, dtype=np.float64).view(np.int64)


@pytest.mark.parametrize("n", [1, 5, 8, 9, 37, 2000, 2001, 2007])
def test_seq_dot_plain_equals_jitted_vdot_bitwise(n):
    rng = np.random.default_rng(n)
    for _ in range(20):
        a = rng.normal(size=n) * np.exp(rng.normal(size=n))
        b = rng.normal(size=n)
        for u, v in ((a, b), (a, a)):
            got = V.seq_dot_plain(torch.from_numpy(u), torch.from_numpy(v))
            assert got.dtype == torch.float64 and got.dim() == 0
            assert _bits(got.item()) == _bits(_vdot(jnp.asarray(u),
                                                    jnp.asarray(v)))


def test_seq_dot_of_empty_vectors_is_zero():
    e = torch.zeros(0, dtype=torch.float64)
    assert float(V.seq_dot(e, e)) == 0.0


def _libm_fma(a, x, y):
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.fma.argtypes = [ctypes.c_double] * 3
    libm.fma.restype = ctypes.c_double
    return np.array([libm.fma(a, u, v) for u, v in zip(x, y)])


@pytest.mark.parametrize("spread", [0.0, 20.0, 200.0])
def test_fma_axpy_plain_is_a_correctly_rounded_fma(spread):
    rng = np.random.default_rng(int(spread) + 1)
    n = 4000
    x = rng.normal(size=n) * 2.0 ** rng.uniform(-spread, spread, n)
    y = rng.normal(size=n) * 2.0 ** rng.uniform(-spread, spread, n)
    for a in (float(rng.normal()), -1.0 / 3.0, 2.0 ** 40 + 1.0):
        # Half the entries cancel to a few bits: y close to -a * x.
        yy = y.copy()
        yy[::2] = -(a * x[::2]) * (1 + 2.0 ** -40 * rng.normal(size=n // 2))
        got = V.fma_axpy_plain(torch.tensor(a, dtype=torch.float64),
                               torch.from_numpy(x), torch.from_numpy(yy))
        assert np.array_equal(_bits(got.numpy()), _bits(_libm_fma(a, x, yy)))


def test_fma_axpy_plain_equals_the_reference_updates_bitwise():
    rng = np.random.default_rng(3)
    x, p, r = (rng.normal(size=2000) for _ in range(3))
    a = rng.normal()
    upd = jax.jit(lambda x, a, p: (x + a * p, x - a * p))
    plus, minus = upd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(p))
    ta = torch.tensor(a, dtype=torch.float64)
    tx, tp = torch.from_numpy(x), torch.from_numpy(p)
    assert np.array_equal(_bits(V.fma_axpy(ta, tp, tx).numpy()), _bits(plus))
    assert np.array_equal(_bits(V.fma_axpy(-ta, tp, tx).numpy()),
                          _bits(minus))


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_fused_cg_step_equals_the_jitted_reference_step_bitwise(tag):
    a = J_gen.diag_rescale(J_gen.random_spd(2000, seed=21), 8.0, 21)
    g = J_csr.pack_csr(a)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device="cpu")
    rng = np.random.default_rng(tag)
    x, r, p = (rng.normal(size=2000) for _ in range(3))
    rs = float(_vdot(jnp.asarray(r), jnp.asarray(r)))
    want = jax.jit(j_step)(g, jnp.asarray(x), jnp.asarray(r), jnp.asarray(p),
                           jnp.asarray(rs), jnp.int32(tag))
    got = fused_cg_step_g(tg, *(torch.from_numpy(v) for v in (x, r, p)),
                          torch.tensor(rs, dtype=torch.float64),
                          torch.tensor(tag, dtype=torch.int32))
    for name, w, t in zip(("x", "r", "p", "rs", "denom"), want, got):
        assert np.array_equal(_bits(w), _bits(t.numpy())), name


def test_cpu_tensors_take_the_plain_versions():
    V.reset_launch_counts()
    a = torch.arange(40, dtype=torch.float64)
    s = torch.tensor(0.5, dtype=torch.float64)
    assert torch.equal(V.seq_dot(a, a), V.seq_dot_plain(a, a))
    assert torch.equal(V.fma_axpy(s, a, a), V.fma_axpy_plain(s, a, a))
    assert V.seq_dot.launches == V.fma_axpy.launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        V.seq_dot(a.to("meta"), a.to("meta"))
