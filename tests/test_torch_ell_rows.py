"""The row walk of kernels A32 and C32 (the f32 SpMV and SpMM over the
uniform ELL pack), as the CPU can check it.

``ops.ell_pack_gsecsr`` pads every row to the longest row rounded up to
128 lanes (the TPU's), with colpak 0 and head 0.  The CUDA kernels
(``csrc/gse_spmv.cu``, ``csrc/gse_spmm.cu``, body ``group_row_f32`` in
``csrc/gse_rows.cuh``) read only each row's
real slots, ``ops.ell_row_lengths`` (the CSR's ``diff(rowptr)``), and run
a row on a group of ``lanes`` lanes: lane g carries the chains of the
warp's lanes g, g + lanes, ... (virtual lane v adds slots v, v+32, ...
from 0.0), adds the shuffle tree's offsets of ``lanes`` and more within
itself and the rest across the group.  A row with padding adds, once, the
product a padded slot would add (+-0.0 for a finite x[0], NaN otherwise).
The plain versions walk every padded slot on 32 lanes.  These tests hold
a model of the kernels' walk -- lane registers, the slots each takes, the
in-lane and cross-lane steps of the tree -- bitwise to the plain versions
and within the JAX tests' tolerance to the reference's Pallas kernels in
interpret mode, with x[0] finite and not, and plant faults (two virtual
lanes swapped, the padded slot's product dropped) that must show.  The
row lengths are held to ``diff(rowptr)`` and to the pack's padding, and
the wrappers to their contract.  ``chip_smoke.py`` phases 2, 7 and 10 hold
the CUDA kernels to the plain versions on the card.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as J_ops  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402

from repro_torch.core.precision_table import TAG_BITS_USED  # noqa: E402
from repro_torch.kernels import gse_spmm as T_c  # noqa: E402
from repro_torch.kernels import gse_spmv as T_k  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402
from repro_torch.sparse import csr as T_csr  # noqa: E402
from repro_torch.sparse import generators as T_gen  # noqa: E402

CPU = "cpu"
CSRC = Path(T_k.__file__).resolve().parent / "csrc"

# spd_rs8_2k (10-29 entries a row), poisson2d(8) (3-5) and sk512_rs8_s0
# (skewed: nine rows longer than 128, the longest 512).
CASES = {
    "spd_rs8_2k": lambda m, d: m.diag_rescale(
        m.random_spd(2000, seed=21, **d), 8.0, 21),
    "poisson2d_8": lambda m, d: m.poisson2d(8, **d),
    "sk512_rs8_s0": lambda m, d: m.diag_rescale(
        m.skewed_spd(512, seed=0, **d), 8.0, 0),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(reference pack, port pack) of ``name`` at k = 8."""
    return (J_csr.pack_csr(CASES[name](J_gen, {})),
            T_csr.pack_csr(CASES[name](T_gen, {"device": CPU})))


def _x(n, seed, nrhs=None):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n if nrhs is None else (n, nrhs)).astype(
        np.float32)


def _tails(ell, tag):
    return (ell[2] if tag >= 2 else None, ell[3] if tag == 3 else None)


def _products(ell, x, scales, tag, ei_bit):
    """``(rows, width, nc)`` f32 products of every ELL slot for the ``(n,
    nc)`` x, in the order of ``gse_spmv_ell_f32_plain``'s decode, and the
    ``(nc,)`` product of a padded slot (colpak 0, head 0)."""
    shift = 32 - ei_bit
    cp, h = ell[0].to(torch.int64), ell[1].to(torch.int64)
    sgn = 1.0 - 2.0 * ((h >> 15) & 0x1).to(torch.float32)
    mant = (h & 0x7FFF).to(torch.float32)
    if tag >= 2:
        mant = mant * 65536.0 + ell[2].to(torch.int64).to(torch.float32)
    if tag == 3:
        mant = mant * float(2.0**32) + ell[3].to(torch.int64).to(
            torch.float32)
    scales = scales.reshape(-1)
    vals = sgn * mant * scales[cp >> shift]
    prods = vals[..., None] * x[cp & ((1 << shift) - 1)]
    pad_val = torch.tensor(1.0) * torch.tensor(0.0) * scales[0]
    return prods.numpy(), (pad_val * x[0]).numpy()


def _group_walk(prods, row_len, pad, lanes, fault=None):
    """The kernels' sums of ``prods`` ``(rows, width, nc)``: each row on
    ``lanes`` lanes, lane g's chain k (virtual lane g + lanes * k) adding
    slots j0 + g + lanes * k below the row's length, round j0 by round
    (no slot at or past the length is read); virtual lane 0 starts from
    0.0 + pad when the row is shorter than the width; then the tree's
    offsets 16 .. lanes within each lane and lanes/2 .. 1 across the
    group.  ``fault``: "lanes_swapped" (virtual lanes 0 and 8 swapped
    before the tree), "pad_dropped" (no padded slot's product)."""
    rows, width, nc = prods.shape
    k_n = 32 // lanes
    f0 = np.float32(0.0)
    acc = np.zeros((rows, lanes, k_n, nc), np.float32)
    if fault != "pad_dropped":
        padded = (row_len < width)[:, None]
        acc[:, 0, 0] = np.where(padded, f0 + pad[None, :], f0)
    with np.errstate(invalid="ignore", over="ignore"):
        for j0 in range(0, width, 32):
            for k in range(k_n):
                j = j0 + np.arange(lanes) + lanes * k
                ok = (j[None, :] < row_len[:, None])[..., None]
                v = prods[:, np.minimum(j, width - 1)]
                acc[:, :, k] = np.where(ok, acc[:, :, k] + v, acc[:, :, k])
        if fault == "lanes_swapped":
            virt = acc.transpose(0, 2, 1, 3).reshape(rows, 32, nc).copy()
            virt[:, [0, 8]] = virt[:, [8, 0]]
            acc = virt.reshape(rows, k_n, lanes, nc).transpose(0, 2, 1, 3)
        h = k_n // 2
        while h:
            acc[:, :, :h] = acc[:, :, :h] + acc[:, :, h:2 * h]
            h //= 2
        top = acc[:, :, 0].copy()
        off = lanes // 2
        while off:
            top[:, :off] = top[:, :off] + top[:, off:2 * off]
            off //= 2
    return top[:, 0]


def _walk(tg, ell, x, tag, lanes, fault=None):
    """The model of A32 (x ``(n,)``, returns ``(rows,)``) or C32 (x ``(n,
    nrhs)``, returns ``(rows, nrhs)``) on the pack ``ell`` of ``tg``."""
    scales = T_ref.make_scales(tg.table, TAG_BITS_USED[tag])
    xt = torch.from_numpy(x)
    cols = xt[:, None] if xt.dim() == 1 else xt
    prods, pad = _products(ell, cols, scales, tag, tg.ei_bit)
    y = _group_walk(prods, T_ops.ell_row_lengths(tg).numpy(), pad, lanes,
                    fault)
    return y[:, 0] if xt.dim() == 1 else y


def _a32_plain(tg, ell, x, tag):
    return T_k.gse_spmv_ell_f32_plain(
        ell[0], ell[1], *_tails(ell, tag), torch.from_numpy(x),
        T_ref.make_scales(tg.table, TAG_BITS_USED[tag]), ei_bit=tg.ei_bit,
        tag=tag).numpy()


def _c32_plain(tg, ell, x, tag):
    return T_c.gse_spmm_ell_f32_plain(
        ell[0], ell[1], *_tails(ell, tag), torch.from_numpy(x),
        T_ref.make_scales(tg.table, TAG_BITS_USED[tag]), ei_bit=tg.ei_bit,
        tag=tag).numpy()


@functools.lru_cache(maxsize=None)
def _reference(name, tag, nrhs):
    """The reference's Pallas SpMV (nrhs None) or SpMM in interpret mode on
    ``_x(n, 100 + tag, nrhs)``."""
    jg, _ = _case(name)
    x = jnp.asarray(_x(jg.shape[1], 100 + tag, nrhs))
    ell = J_ops.ell_pack_gsecsr(jg)
    call = J_ops.gse_spmv_ell if nrhs is None else J_ops.gse_spmm_ell
    return np.asarray(call(ell, jg.table, x, jg.ei_bit, tag=tag))


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


def _same_values(got, want):
    """Bitwise equal where ``want`` is finite; NaN where it is NaN; the
    same infinity where it is infinite."""
    fin = np.isfinite(want)
    return (np.array_equal(np.isfinite(got), fin)
            and np.array_equal(np.isnan(got), np.isnan(want))
            and np.array_equal(got[~fin & ~np.isnan(want)],
                               want[~fin & ~np.isnan(want)])
            and np.array_equal(_bits(got[fin]), _bits(want[fin])))


# --- the row lengths ---------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_row_lengths_are_diff_rowptr_and_bound_the_real_slots(name):
    """``ell_row_lengths`` is ``diff(rowptr)`` as int32 on the operator's
    device, memoized beside the pack; every ELL slot below it is the CSR's
    next entry and every slot at or past it holds colpak 0, head 0 and
    zero tails."""
    _, tg = _case(name)
    lens = T_ops.ell_row_lengths(tg)
    assert lens.dtype == torch.int32 and lens.device == tg.rowptr.device
    rp = tg.rowptr.to(torch.int64)
    assert torch.equal(lens.to(torch.int64), rp[1:] - rp[:-1])
    hits = T_ops.PACK_STATS["hits"]
    assert T_ops.ell_row_lengths(tg) is lens
    assert T_ops.PACK_STATS["hits"] == hits + 1
    ell = T_ops.ell_pack_gsecsr(tg)
    width = ell[0].shape[1]
    assert int(lens.max()) <= width and width % T_ops.LANE == 0
    real = torch.arange(width)[None, :] < lens[:, None].to(torch.int64)
    for seg, flat in zip(ell, (tg.colpak, tg.head, tg.tail1, tg.tail2)):
        assert not bool(seg[~real].to(torch.int64).any())
        assert torch.equal(seg[real], flat)


# --- A32 ---------------------------------------------------------------------

@pytest.mark.parametrize("lanes", T_k.ELL_LANES)
@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_a32_walk_is_bitwise_the_plain_version_and_reference(name, tag,
                                                             lanes):
    """A32's walk over the real slots, on any group size: bitwise the
    plain version (every padded slot on 32 lanes), and within rtol 2e-5 /
    atol 1e-4 of the reference's Pallas kernel in interpret mode."""
    _, tg = _case(name)
    ell = T_ops.ell_pack_gsecsr(tg)
    x = _x(tg.shape[1], 100 + tag)
    got = _walk(tg, ell, x, tag, lanes)
    assert np.array_equal(_bits(got), _bits(_a32_plain(tg, ell, x, tag)))
    np.testing.assert_allclose(got, _reference(name, tag, None), rtol=2e-5,
                               atol=1e-4)


# --- C32 ---------------------------------------------------------------------

@pytest.mark.parametrize("nrhs", [1, 3, 4, 9])
@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_c32_walk_is_bitwise_the_plain_version_and_reference(name, tag,
                                                             nrhs):
    """C32's walk (each column on its own lane chains): bitwise the plain
    version, column j bitwise A32's walk on column j (so at nrhs 1 bitwise
    A32), and within rtol 2e-5 / atol 1e-4 of the reference's Pallas SpMM
    in interpret mode.  nrhs 3 and 9 leave a pass of four columns part
    full; the passes do not change a column's sum."""
    _, tg = _case(name)
    ell = T_ops.ell_pack_gsecsr(tg)
    x = _x(tg.shape[1], 100 + tag, nrhs)
    lanes = T_k.ELL_LANES_DEFAULT
    got = _walk(tg, ell, x, tag, lanes)
    assert got.shape == (tg.shape[0], nrhs)
    assert np.array_equal(_bits(got), _bits(_c32_plain(tg, ell, x, tag)))
    for j in range(nrhs):
        assert np.array_equal(
            _bits(got[:, j]), _bits(_walk(tg, ell, x[:, j].copy(), tag,
                                          lanes)))
    np.testing.assert_allclose(got, _reference(name, tag, nrhs), rtol=2e-5,
                               atol=1e-4)


# --- a non-finite x[0] ---------------------------------------------------------

@pytest.mark.parametrize("ell_lane", [128, 1])
@pytest.mark.parametrize("kernel", ["a32", "c32"])
@pytest.mark.parametrize("value", [np.inf, np.nan])
def test_a_non_finite_x0_gives_the_plain_versions_rows(value, kernel,
                                                       ell_lane):
    """x[0] inf or NaN on poisson2d(8): the plain version's padded slots
    make every padded row NaN; the walk, which reads no padded slot, gives
    the same values row for row (C32: column 0 only; column 1 finite).  At
    an ELL lane of 1 the rows of the longest length have no padding and
    stay finite unless they hold column 0."""
    _, tg = _case("poisson2d_8")
    ell = T_ops.ell_pack_gsecsr(tg, lane=ell_lane)
    x = _x(tg.shape[1], 7, None if kernel == "a32" else 2)
    if kernel == "a32":
        x[0] = value
    else:
        x[0, 0] = value
    plain = _a32_plain if kernel == "a32" else _c32_plain
    want = plain(tg, ell, x, 2)
    got = _walk(tg, ell, x, 2, 4)
    assert _same_values(got, want)
    bad = ~np.isfinite(want)
    if kernel == "c32":
        assert np.isfinite(want[:, 1]).all()
        bad = bad[:, 0]
    lens = T_ops.ell_row_lengths(tg).numpy()
    assert bad[lens < ell[0].shape[1]].all()
    if ell_lane == 1:
        assert 0 < (~bad).sum() < bad.size


# --- planted faults ----------------------------------------------------------

@pytest.mark.parametrize("lanes", T_k.ELL_LANES)
def test_walk_model_sees_swapped_virtual_lanes(lanes):
    """Two virtual lanes (0 and 8) trading chains -- within lane 0 at 8
    lanes or fewer, across lanes above -- break the bitwise equality with
    the plain version on some rows of spd_rs8_2k."""
    _, tg = _case("spd_rs8_2k")
    ell = T_ops.ell_pack_gsecsr(tg)
    x = _x(tg.shape[1], 5)
    bad = (_bits(_walk(tg, ell, x, 3, lanes, "lanes_swapped"))
           != _bits(_a32_plain(tg, ell, x, 3)))
    assert bad.any()


@pytest.mark.parametrize("value", [1.5, np.inf])
def test_the_padded_slots_product_matters_only_for_a_non_finite_x0(value):
    """Without the padded slot's product the walk stays bitwise the plain
    version for a finite x[0] (the skipped slots add +-0.0 to chains that
    never hold -0.0) and loses the plain version's NaN rows for an
    infinite one."""
    _, tg = _case("poisson2d_8")
    ell = T_ops.ell_pack_gsecsr(tg)
    x = _x(tg.shape[1], 9)
    x[0] = value
    got = _walk(tg, ell, x, 1, 8, "pad_dropped")
    want = _a32_plain(tg, ell, x, 1)
    assert _same_values(got, want) == bool(np.isfinite(value))


# --- the wrappers --------------------------------------------------------------

def _ell_call(wrapper, tg, row_len, **kw):
    ell = T_ops.ell_pack_gsecsr(tg)
    n = tg.shape[1]
    scales = T_ref.make_scales(tg.table, TAG_BITS_USED[1])
    if wrapper == "gse_spmv_ell_f32":
        return T_k.gse_spmv_ell_f32(ell[0], ell[1], None, None,
                                    torch.zeros(n), scales, ei_bit=tg.ei_bit,
                                    tag=1, row_len=row_len, **kw)
    if wrapper == "gse_spmm_ell_f32":
        return T_c.gse_spmm_ell_f32(ell[0], ell[1], None, None,
                                    torch.zeros(n, 4), scales,
                                    ei_bit=tg.ei_bit, tag=1, row_len=row_len,
                                    device=CPU, **kw)
    if wrapper == "ops.gse_spmv_ell":
        return T_ops.gse_spmv_ell(ell, tg.table, torch.zeros(n), tg.ei_bit,
                                  row_len=row_len, **kw)
    return T_ops.gse_spmm_ell(ell, tg.table, torch.zeros(n, 4), tg.ei_bit,
                              row_len=row_len, device=CPU, **kw)


ELL_WRAPPERS = ["gse_spmv_ell_f32", "gse_spmm_ell_f32", "ops.gse_spmv_ell",
                "ops.gse_spmm_ell"]


@pytest.mark.parametrize("wrapper", ELL_WRAPPERS)
def test_ell_wrappers_refuse_row_lengths_of_another_row_count(wrapper):
    """A ``row_len`` with one row too few is refused on the CPU too; the
    operator's own is taken, and changes nothing there."""
    _, tg = _case("poisson2d_8")
    lens = T_ops.ell_row_lengths(tg)
    with pytest.raises(ValueError, match="row_len"):
        _ell_call(wrapper, tg, lens[:-1])
    assert torch.equal(_ell_call(wrapper, tg, lens),
                       _ell_call(wrapper, tg, None))


@pytest.mark.parametrize("wrapper", ["gse_spmv_ell_f32", "gse_spmm_ell_f32"])
def test_ell_kernels_refuse_a_group_size_they_were_not_built_for(wrapper):
    _, tg = _case("poisson2d_8")
    with pytest.raises(ValueError, match="lanes"):
        _ell_call(wrapper, tg, None, lanes=5)


def test_group_sizes_are_the_ones_the_sources_build():
    """Every entry of ``ELL_LANES`` has its instantiation in both sources,
    and the default is one of them."""
    for src in ("gse_spmv.cu", "gse_spmm.cu"):
        built = re.findall(r"case (\d+): return \w+_ell_f32_on<\1>",
                           (CSRC / src).read_text())
        assert tuple(sorted(int(b) for b in built)) == T_k.ELL_LANES
    assert T_k.ELL_LANES_DEFAULT in T_k.ELL_LANES
