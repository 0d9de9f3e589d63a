"""Kernel F's backward on the CPU: autograd through F (which CPU tensors
run on F's plain version; CUDA tensors on the port's
``torch.autograd.Function``) against ``jax.grad`` of the reference's
``_attend`` (the path the reference trains through) and of
``ref.flash_ref`` (the Pallas kernel's oracle), at f32, causal, causal over a window and non-causal with S != T,
with GQA.

Tolerances: f32 gradients within rtol/atol 2e-5 (the reference kernel
tests' f32 tolerance; the sums run in another order), the row statistic
within 1e-5 of ``logsumexp`` of the reference's masked scores.  The CUDA
backward (``csrc/flash_attn_bwd.cu``) runs only on the card, where
``chip_smoke.py`` phase 34 holds it to the plain version's gradients.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as J_ref  # noqa: E402
from repro.models import attention as J_A  # noqa: E402

from repro_torch.kernels import flash_attn as F  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
# (b, s, t, h, kv, hd, causal, window)
CASES = {
    "causal_gqa": (2, 13, 13, 4, 2, 16, True, 0),
    "causal_mha": (1, 9, 9, 3, 3, 8, True, 0),
    "window": (2, 17, 17, 4, 1, 16, True, 5),
    "noncausal_st": (2, 7, 11, 4, 2, 16, False, 0),
    "noncausal_ss": (1, 10, 10, 2, 2, 24, False, 0),
}


def _inputs(case, seed=0):
    b, s, t, h, kv, hd, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd),
                          (b, s, h, hd))]


def _mask(case):
    _, s, t, _, _, _, causal, window = CASES[case]
    i = np.arange(s)[:, None]
    j = np.arange(t)[None, :]
    m = np.ones((s, t), bool)
    if causal:
        m &= j <= i
        if window:
            m &= j > i - window
    return m[None, None, None]


def _jax_grads(case, q, k, v, dout):
    """jax.grad of the reference's _attend at f32 under the case's mask."""
    mask = jnp.asarray(_mask(case))

    def f(q, k, v):
        out = J_A._attend(q, k, v, mask, None, jnp.float32)
        return jnp.sum(out * dout)

    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


def _torch_grads(case, q, k, v, dout, fn=F.flash_attention_gqa):
    _, _, _, _, _, _, causal, window = CASES[case]
    qa, ka, va = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fn(qa, ka, va, causal=causal, window=window, **(
        {"device": "cpu"} if fn is F.flash_attention_gqa else {}))
    return out, torch.autograd.grad(out, (qa, ka, va), torch.from_numpy(dout))


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_through_f_matches_jax_grad_of_attend(case):
    q, k, v, dout = _inputs(case)
    want = _jax_grads(case, q, k, v, dout)
    _, got = _torch_grads(case, q, k, v, dout)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_the_function_is_autograd_through_the_plain_version(case):
    """On the CPU F's gradients are autograd through
    flash_attention_gqa_plain, bit for bit, and so is the backward's entry
    point given the plain row statistic."""
    q, k, v, dout = _inputs(case, seed=1)
    out_f, got = _torch_grads(case, q, k, v, dout)
    out_p, want = _torch_grads(case, q, k, v, dout,
                               fn=F.flash_attention_gqa_plain)
    assert torch.equal(out_f, out_p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, _, _, _, _, _, causal, window = CASES[case]
    bwd = F.flash_attention_gqa_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)), out_p.detach(),
        F.flash_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                          causal=causal, window=window),
        torch.from_numpy(dout), causal=causal, window=window, device="cpu")
    for g, w in zip(bwd, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["causal_mha", "noncausal_ss"])
def test_matches_jax_grad_of_the_pallas_oracle(case):
    """One KV head per query head: ``ref.flash_ref`` (BH, S, hd), the
    oracle of the Pallas kernel, differentiated by JAX."""
    b, s, t, h, kv, hd, causal, _ = CASES[case]
    q, k, v, dout = _inputs(case, seed=2)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(b * x.shape[2],  # noqa
                                                     x.shape[1], hd)
    qf, kf, vf, df = map(fold, (q, k, v, dout))
    want = jax.grad(lambda q, k, v: jnp.sum(
        J_ref.flash_ref(q, k, v, causal=causal) * df), argnums=(0, 1, 2))(
        qf, kf, vf)
    qa, ka, va = (torch.from_numpy(x).requires_grad_(True)
                  for x in (qf, kf, vf))
    out = F.flash_attention(qa, ka, va, causal=causal, device="cpu")
    got = torch.autograd.grad(out, (qa, ka, va), torch.from_numpy(df))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_row_statistic_is_the_masked_logsumexp(case):
    b, s, t, h, kv, hd, causal, window = CASES[case]
    q, k, _, _ = _inputs(case)
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = jnp.einsum("bskge,btke->bkgst", qg, k) * (1.0 / math.sqrt(hd))
    scores = jnp.where(jnp.asarray(_mask(case)), scores, -1e30)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(b, h, s)
    got = F.flash_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal, window=window)
    assert got.shape == (b, h, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_backward_checks_and_hd_limit():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="lse"):
        F.flash_attention_gqa_bwd(q, k, k, q, lse[:, :1], q, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        F.flash_attention_gqa_bwd(q, k, k, q[:, :3], lse, q, device="cpu")
    big = torch.zeros(1, 4, 1, 256, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        F.flash_attention_gqa(big, big, big, window=2, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        F.flash_attention_gqa_bwd(big, big, big, big,
                                  torch.zeros(1, 1, 4), big, device="cpu")
    # Without grad, hd 256 still serves (the forward has no such limit).
    with torch.no_grad():
        assert F.flash_attention_gqa(big, big, big, window=2,
                                     device="cpu").shape == big.shape
    assert F.BWD_HD_MAX == 128


def test_cpu_takes_no_launch():
    q, k, v, dout = _inputs("causal_gqa")
    F.reset_launch_counts()
    _torch_grads("causal_gqa", q, k, v, dout)
    assert F.flash_attention_gqa.launches == 0
    assert F.flash_attention_gqa_bwd.launches == 0
    assert sum(F.flash_attention_gqa.lse_launches.values()) == 0
