"""The f32-source GSE-SEM pack of the LM path, bitwise against the JAX
reference: ``extract_shared_exponents_jnp``, ``pack32_jnp``, ``pack32``,
``decode32_jnp`` and ``decode_jnp``.

Two places where a port could drift are pinned on purpose: equal bin
counts (``jax.lax.top_k`` takes the lower exponent first; the port sorts
stably), and tables with duplicate entries (``jnp.argmin`` takes the
first index; the port's strict ``<`` keeps the earlier one).  Inputs are
numpy arrays handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gse as J  # noqa: E402

from repro_torch.core import gse as T  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the other test workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(shape, seed, spread=4):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=shape) * np.exp2(rng.integers(-spread, spread,
                                                      size=shape))
    v = v.astype(np.float32)
    v.reshape(-1)[::11] = 0.0
    return v


def _tied():
    """Four exponents with five values each: three slots, four tied bins."""
    parts = [np.full(5, 2.0 ** e, np.float32) for e in (3, -1, -5, 1)]
    parts[1] *= -1.0
    return np.concatenate(parts)


CASES = {
    "normal": _mixed((64, 96), 0),
    "wide": _mixed((300,), 1, spread=40),
    "three_d": _mixed((3, 4, 50), 2),
    "tied": _tied(),
    "few_exponents": np.array([1.0, 1.5, -1.25, 0.0, 1.75], np.float32),
    "zeros": np.zeros((4, 8), np.float32),
    "subnormal": np.array([1e-40, -3e-39, 2.0 ** -126, 1.0, 0.0],
                          np.float32),
}


def _same(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.zeros(0, want.dtype)).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("k", [2, 4, 8, 16])
def test_extract_shared_exponents_is_bitwise(name, k):
    v = CASES[name]
    _same(T.extract_shared_exponents_jnp(torch.from_numpy(v), k),
          J.extract_shared_exponents_jnp(jnp.asarray(v), k))


def test_ties_take_the_lower_exponent():
    table = T.extract_shared_exponents_jnp(torch.from_numpy(_tied()), 4)
    # Bins 122, 126, 128 (lowest of four tied) plus the max 130, stored +1.
    assert table.tolist() == [131, 129, 127, 123]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("k", [4, 8])
def test_pack32_jnp_is_bitwise(name, k):
    v = CASES[name]
    table = J.extract_shared_exponents_jnp(jnp.asarray(v), k)
    hj, tj = J.pack32_jnp(jnp.asarray(v), table, k)
    ht, tt = T.pack32_jnp(torch.from_numpy(v),
                          torch.from_numpy(np.array(table)), k)
    _same(ht, hj)
    _same(tt, tj)


@pytest.mark.parametrize("table", [
    [127, 127, 126, 124, 124, 120, 120, 120],   # duplicates, sorted
    [126, 126, 125, 125, 124, 123, 122, 121],   # a pack32 table's head
    [120, 130, 125, 125, 131, 118, 127, 127],   # duplicates, unsorted
])
def test_pack32_jnp_first_index_on_duplicate_tables(table):
    """argmin over equal gaps takes the first index; values above every
    entry saturate under the first maximal entry."""
    v = _mixed((40, 30), 5, spread=12)
    tbl = np.asarray(table, np.int32)
    hj, tj = J.pack32_jnp(jnp.asarray(v), jnp.asarray(tbl), 8)
    ht, tt = T.pack32_jnp(torch.from_numpy(v), torch.from_numpy(tbl), 8)
    _same(ht, hj)
    _same(tt, tj)


def test_pack32_rounds_ties_to_even_like_the_reference():
    """Mantissas whose discarded bits are exactly half an ulp."""
    m = np.arange(1, 65, dtype=np.uint32)
    bits = (np.uint32(127 - 20) << 23) | (m << 10) | np.uint32(1 << 9)
    v = np.concatenate([bits.view(np.float32), np.float32([1.0, -1.0])])
    table = np.asarray([128, 120, 119, 118, 117, 116, 115, 114], np.int32)
    hj, tj = J.pack32_jnp(jnp.asarray(v), jnp.asarray(table), 8)
    ht, tt = T.pack32_jnp(torch.from_numpy(v), torch.from_numpy(table), 8)
    _same(ht, hj)
    _same(tt, tj)


@pytest.mark.parametrize("k", [4, 8])
def test_pack32_container_and_decode32(k):
    v = CASES["normal"]
    pj = J.pack32(v, k)
    pt = T.pack32(v, k, device=CPU)
    for f in ("table", "head", "tail1", "tail2"):
        _same(getattr(pt, f), getattr(pj, f))
    assert (pt.ei_bit, pt.frac_bits, pt.width) == (pj.ei_bit, pj.frac_bits,
                                                   pj.width)
    for tag in (1, 2):
        assert pt.nbytes(tag) == pj.nbytes(tag)
        want = J.decode32_jnp(pj.table, pj.head, pj.tail1, k, tag)
        got = T.decode32_jnp(pt.table, pt.head, pt.tail1, k, tag)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
        got = T.decode_jnp(pt, tag, torch.float32)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    with pytest.raises(ValueError):
        pt.nbytes(3)
    with pytest.raises(ValueError):
        T.decode_jnp(pt, 3)
    with pytest.raises(ValueError):
        T.decode32_jnp(pt.table, pt.head, pt.tail1, k, 3)


def test_pack32_against_a_given_table():
    v = CASES["wide"]
    table = np.asarray([140, 130, 127, 127, 120, 110, 100, 90], np.int32)
    pj = J.pack32(v, 8, table=jnp.asarray(table))
    pt = T.pack32(v, 8, table=torch.from_numpy(table), device=CPU)
    _same(pt.head, pj.head)
    _same(pt.tail1, pj.tail1)


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_decode_jnp_f64_source_is_bitwise(tag, dtype):
    v = _mixed((24, 40), 9).astype(np.float64) / 3.0
    pj = J.pack(v, 8)
    pt = T.pack(v, 8, device=CPU)
    want = np.asarray(J.decode_jnp(pj, tag, getattr(jnp, dtype)))
    got = T.decode_jnp(pt, tag, getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
