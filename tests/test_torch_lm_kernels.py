"""Kernels D, E and F of the LM path (their plain versions, as the CPU
runs them) and the port's ``ops.gse_decode``/``ops.gse_matmul`` against
the JAX reference.

The same numpy inputs go through the reference's Pallas kernels in
interpret mode and its ``ref.*`` oracles, and through the port.  D is
held bitwise (to ``ops.gse_decode``, ``ref.decode_ref`` and
``gse.decode_jnp``); E and F within the tolerances of
``tests/test_kernels.py``: rtol 1e-5 / atol 1e-4 for E, rtol/atol 2e-5
for F in f32 and 2e-2 in bf16, on shapes that are and are not multiples
of the reference's blocks.  ``chip_smoke.py`` holds the CUDA kernels to
these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gse as J_gse  # noqa: E402
from repro.kernels import ops as J_ops  # noqa: E402
from repro.kernels import ref as J_ref  # noqa: E402
from repro.kernels.flash_attn import flash_attention_pallas  # noqa: E402
from repro.models import attention as J_attn  # noqa: E402
from repro.models.config import ModelConfig as J_Config  # noqa: E402

from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.kernels import flash_attn as T_f  # noqa: E402
from repro_torch.kernels import gse_decode as T_d  # noqa: E402
from repro_torch.kernels import gse_matmul as T_e  # noqa: E402
from repro_torch.kernels import ops as T_ops  # noqa: E402
from repro_torch.kernels import ref as T_ref  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the other test workers keep the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.choice([-2, 0, 1], size=shape)
    vals = rng.uniform(1.0, 2.0, shape) * np.exp2(base)
    return vals * rng.choice([-1.0, 1.0], size=shape)


def _pair(shape, k=8, seed=0):
    """The same values packed by the reference and by the port."""
    vals = _values(shape, seed)
    return J_gse.pack(vals, k), T_gse.pack(vals, k, device=CPU), vals


def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


# --- D ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (24, 384), (10, 130), (3, 5)])
@pytest.mark.parametrize("tag", [1, 2, 3])
def test_decode_plain_is_bitwise_the_reference(shape, tag):
    jp, tp, _ = _pair(shape, seed=sum(shape) + tag)
    got = T_ops.gse_decode(tp, tag=tag, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want = np.asarray(J_ops.gse_decode(jp, tag=tag))
    np.testing.assert_array_equal(_u32(got), _u32(want))
    oracle = J_ref.decode_ref(jp.head, jp.tail1, jp.tail2, jp.table,
                              jp.ei_bit, tag)
    np.testing.assert_array_equal(_u32(got), _u32(oracle))
    port_oracle = T_ref.decode_ref(tp.head, tp.tail1, tp.tail2, tp.table,
                                   tp.ei_bit, tag)
    np.testing.assert_array_equal(_u32(got), _u32(port_oracle))
    np.testing.assert_array_equal(
        _u32(got), _u32(J_gse.decode_jnp(jp, tag, jnp.float32)))


@pytest.mark.parametrize("k", [2, 16])
def test_decode_plain_k_sweep_bitwise(k):
    jp, tp, vals = _pair((16, 128), k=k, seed=k)
    got = T_ops.gse_decode(tp, tag=3, device=CPU).numpy()
    np.testing.assert_array_equal(_u32(got), _u32(J_ops.gse_decode(jp, 3)))
    assert (np.abs(got - vals) / np.abs(vals)).max() < 1e-6


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_decode_plain_bf16_is_the_rounded_f32_decode(tag):
    jp, tp, _ = _pair((12, 40), seed=tag)
    scales = T_ref.make_scales(tp.table, 15 + 16 * (tag >= 2) + 32 * (tag == 3)
                               - tp.ei_bit)
    got = T_d.gse_decode_dense(tp.head, tp.tail1, tp.tail2, scales,
                               ei_bit=tp.ei_bit, tag=tag,
                               out_dtype=torch.bfloat16, device=CPU)
    want = np.asarray(J_gse.decode_jnp(jp, tag, jnp.float32).astype(
        jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), want)


def test_decode_1d_and_the_reference_rejections():
    jp, tp, _ = _pair((512,), seed=6)
    got = T_ops.gse_decode(tp, tag=2, device=CPU)
    assert tuple(got.shape) == (512,)
    np.testing.assert_array_equal(_u32(got), _u32(J_ops.gse_decode(jp, 2)))
    vals32 = np.random.default_rng(0).normal(size=(8, 128)).astype(np.float32)
    p32 = T_gse.pack32(vals32, device=CPU)
    # The reference fails on these too (reshaping a pack32's empty tail2,
    # unpacking a 3-D shape); the port raises ValueError.
    with pytest.raises(ValueError, match="f64-source"):
        T_ops.gse_decode(p32, tag=1, device=CPU)
    with pytest.raises(ValueError, match="f64-source"):
        T_ops.gse_matmul(torch.ones(2, 8), p32, tag=1, device=CPU)
    p3 = T_gse.pack(np.ones((2, 8, 16)), device=CPU)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        T_ops.gse_decode(p3, tag=1, device=CPU)
    with pytest.raises(ValueError, match="2-D pack"):
        T_ops.gse_matmul(torch.ones(2, 8), p3, tag=1, device=CPU)


def test_wrappers_raise_for_cpu_tensors_unless_asked():
    _, tp, _ = _pair((8, 16), seed=1)
    with pytest.raises(ValueError, match="expected cuda"):
        T_ops.gse_decode(tp, tag=1)
    with pytest.raises(ValueError, match="expected cuda"):
        T_ops.gse_matmul(torch.ones(2, 8), tp, tag=1)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="expected cuda"):
        T_f.flash_attention_gqa(q, q[:, :, :1], q[:, :, :1])


# --- E ----------------------------------------------------------------------

@pytest.mark.parametrize("mkn", [(8, 128, 128), (32, 384, 256), (5, 100, 70),
                                 (1, 33, 9)])
@pytest.mark.parametrize("tag", [1, 2, 3])
def test_matmul_plain_matches_the_pallas_kernel(mkn, tag):
    m, kk, n = mkn
    rng = np.random.default_rng(m + n)
    x = rng.normal(size=(m, kk)).astype(np.float32)
    jp, tp, _ = _pair((kk, n), seed=n)
    got = T_ops.gse_matmul(torch.from_numpy(x), tp, tag=tag, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    want = J_ops.gse_matmul(jnp.asarray(x), jp, tag=tag)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    oracle = J_ref.matmul_ref(jnp.asarray(x), jp.head, jp.tail1, jp.tail2,
                              jp.table, jp.ei_bit, tag)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-4)
    port_oracle = T_ref.matmul_ref(torch.from_numpy(x), tp.head, tp.tail1,
                                   tp.tail2, tp.table, tp.ei_bit, tag)
    np.testing.assert_allclose(got.numpy(), port_oracle.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_matmul_plain_input_dtypes(xdtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, xdtype))
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    jp, tp, _ = _pair((128, 128), seed=3)
    got = T_ops.gse_matmul(tx, tp, tag=1, device=CPU)
    want = J_ref.matmul_ref(jx, jp.head, jp.tail1, jp.tail2, jp.table,
                            jp.ei_bit, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_matmul_plain_accuracy_vs_true_values():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    _, tp, vals = _pair((256, 128), seed=1)
    exact = x.astype(np.float64) @ vals
    out3 = T_ops.gse_matmul(torch.from_numpy(x), tp, tag=3, device=CPU)
    assert np.abs(out3.numpy() - exact).max() / np.abs(exact).max() < 1e-5
    out1 = T_ops.gse_matmul(torch.from_numpy(x), tp, tag=1, device=CPU)
    r1 = np.abs(out1.numpy() - exact).max() / np.abs(exact).max()
    assert 1e-6 < r1 < 1e-2


@pytest.mark.parametrize("tag", [1, 2])
def test_matmul_plain_on_model_segments_matches_take_weight(tag):
    """Bias-127 f32-source segments, as ``modules.linear`` passes them."""
    from repro.models import modules as J_mod

    rng = np.random.default_rng(tag)
    vals = (rng.normal(size=(48, 40)) / 7).astype(np.float32)
    table = J_gse.extract_shared_exponents_jnp(jnp.asarray(vals), 8)
    head, tail1 = J_gse.pack32_jnp(jnp.asarray(vals), table, 8)
    cfg = J_Config(name="t", family="dense", num_layers=1, d_model=48,
                   num_heads=1, num_kv_heads=1, d_ff=40, vocab_size=8,
                   gse_serve=True, gse_tag=tag, compute_dtype=jnp.float32)
    w = J_mod.take_weight({"head": head, "tail1": tail1, "table": table},
                          cfg, jnp.float32, (None, None))
    x = rng.normal(size=(6, 48)).astype(np.float32)
    th = torch.from_numpy(np.array(head))
    tt1 = torch.from_numpy(np.array(tail1))
    m_h = 15 - 3  # k = 8: three expIdx bits
    scales = T_ref.make_scales(torch.from_numpy(np.array(table)),
                               m_h + 16 * (tag - 1), bias=127)
    got_w = T_d.gse_decode_dense(th, tt1, None, scales, ei_bit=3, tag=tag,
                                 device=CPU)
    np.testing.assert_array_equal(_u32(got_w), _u32(w))
    got = T_e.gse_matmul_dense(torch.from_numpy(x), th, tt1, None, scales,
                               ei_bit=3, tag=tag, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.asarray(x) @ w),
                               rtol=1e-5, atol=1e-5)


# --- F ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 128, 64), (1, 256, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_the_pallas_kernel(shape, causal):
    bh, s, hd = shape
    rng = np.random.default_rng(s + hd)
    q, k, v = (rng.normal(size=(bh, s, hd)).astype(np.float32)
               for _ in range(3))
    got = T_f.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, device=CPU)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  blocks=(128, 128))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("st", [(70, 70), (33, 90), (5, 3)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_unaligned_matches_flash_ref(st, causal):
    s, t = st
    rng = np.random.default_rng(s * t)
    q = rng.normal(size=(3, s, 16)).astype(np.float32)
    k, v = (rng.normal(size=(3, t, 16)).astype(np.float32) for _ in range(2))
    got = T_f.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, device=CPU)
    want = J_ref.flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    port_oracle = T_ref.flash_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal)
    np.testing.assert_allclose(got.numpy(), port_oracle.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_plain_bf16():
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 128, 64)).astype(np.float32)
               for _ in range(3))
    got = T_f.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True, device=CPU)
    assert got.dtype == torch.bfloat16
    want = flash_attention_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("heads", [(4, 2), (4, 1), (2, 2)])
def test_flash_gqa_plain_matches_the_models_attend(heads):
    """The model's layout: q (B, S, H, hd), k/v (B, T, KV, hd), the
    reference's grouped ``_attend`` at f32 under a causal mask."""
    h, kv = heads
    b, s, hd = 2, 24, 16
    rng = np.random.default_rng(h * 10 + kv)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    cfg = J_Config(name="t", family="dense", num_layers=1, d_model=h * hd,
                   num_heads=h, num_kv_heads=kv, d_ff=8, vocab_size=8,
                   head_dim=hd, compute_dtype=jnp.float32)
    pos = jnp.arange(s)
    mask = (pos[None, :] <= pos[:, None])[None, None, None]
    want = J_attn._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask, cfg, jnp.float32)
    got = T_f.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, device=CPU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
