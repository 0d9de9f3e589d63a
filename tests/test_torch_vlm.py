"""The port's vlm family (internvl2_2b: the dense InternLM2 stack with the
vision frontend's patch embeddings prepended to the text) against the JAX
reference at the smoke size (2 layers, d 64, 4 heads of 16 over 2 KV
heads, 8 patches).

The reference's params (``init_params`` at ``jax.random.key(0)``) are
carried over with ``convert.params_from_repro``; both sides get the same
numpy tokens and patch embeddings (standard normal, as the reference's
data pipeline draws them).  On the CPU kernels E and F run their plain
versions (f32).

The reference cannot decode after a prefix (its ``decode_step`` takes
tokens and its prefill fills no cache), so its yardstick is its causal
``forward`` and ``logits_from_hidden`` over the whole teacher-forced
sequence, prefix included: a position's decode logits are the forward's
logits at that position.  The port's prefill (``make_prefill_step(
prefix_embeds=, state=)``, the caches filled for all P + S positions)
and its decode steps after it are held to them.  Tolerances: rtol/atol
1e-5 at f32 (dense, ``gse_serve`` tags 1 and 2), BF16_TOL (rtol 0.02,
atol 0.075) at bf16: the port's F keeps the scores in f32 where the
reference's ``_attend`` rounds them, and the decode steps attend in plain
torch where the yardstick is the forward.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_configs  # noqa: E402
from repro.core import gse as J_gse  # noqa: E402
from repro.models import stepfns as J_steps  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.quant import gse_tensor as J_Q  # noqa: E402

from repro_torch import configs as T_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.kernels import flash_attn as T_F  # noqa: E402
from repro_torch.kernels import gse_matmul as T_E  # noqa: E402
from repro_torch.launch import serve as T_serve  # noqa: E402
from repro_torch.models import stepfns as T_steps  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.quant import gse_tensor as T_Q  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
ARCH = "internvl2_2b"
B, PROMPT, STEPS = 2, 6, 5
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.02, atol=0.075)
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
VARIANTS = {"dense": {}, "tag1": dict(gse_serve=True, gse_tag=1),
            "tag2": dict(gse_serve=True, gse_tag=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32", **kw):
    jd, td = _DT[dtype]
    return (dataclasses.replace(J_configs.get_config(ARCH, smoke=True),
                                compute_dtype=jd, **kw),
            dataclasses.replace(T_configs.get_config(ARCH, smoke=True),
                                compute_dtype=td, **kw))


_PARAMS = {}


def _params(gse_serve=False):
    if gse_serve not in _PARAMS:
        cj, _ = _cfgs(**(VARIANTS["tag1"] if gse_serve else {}))
        pj, _ = J_T.init_params(cj, jax.random.key(0))
        _PARAMS[gse_serve] = (pj, convert.params_from_repro(
            jax.tree.map(np.asarray, pj), device=CPU))
    return _PARAMS[gse_serve]


def _inputs(cfg, seed=1, length=PROMPT + STEPS):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, length), dtype=np.int32)
    patches = rng.standard_normal((B, cfg.num_prefix_tokens, cfg.d_model),
                                  dtype=np.float32)
    return toks, patches


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _reference_logits(cj, pj, toks, patches):
    """The reference's forward over the prefix and every token, and its
    logits at every position (B, P + S, V)."""
    @jax.jit
    def run(p, t, e):
        h, _ = J_T.forward(cj, p, t, prefix_embeds=e)
        return J_T.logits_from_hidden(cj, p, h)

    return run(pj, toks, patches)


# --- configs and params ------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_the_reference(smoke):
    cj = J_configs.get_config(ARCH, smoke=smoke)
    ct = T_configs.get_config("internvl2-2b", smoke=smoke)
    for f in dataclasses.fields(cj):
        a, b = getattr(cj, f.name), getattr(ct, f.name)
        if f.name.endswith("dtype"):
            assert str(a).split(".")[-1].rstrip("'>") in str(b), f.name
        else:
            assert a == b, f.name
    assert ct.padded_vocab == cj.padded_vocab and ct.hd == cj.hd
    assert T_T._layer_kinds(ct) == J_T._layer_kinds(cj) == \
        ("attn",) * ct.num_layers
    assert ct.num_prefix_tokens == (8 if smoke else 256)


@pytest.mark.parametrize("gse_serve", [False, True])
def test_init_has_the_reference_stacked_layout(gse_serve):
    cj, ct = _cfgs(**(VARIANTS["tag2"] if gse_serve else {}))
    pj, _ = J_T.init_params(cj, jax.random.key(0))
    mine = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    lay = lambda tree: tree_map(  # noqa: E731
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    assert lay(mine) == lay(convert.params_from_repro(
        jax.tree.map(np.asarray, pj), device=CPU))
    st = T_T.decode_state_init(ct, B, 10, device=CPU)
    sj = J_T.decode_state_init(cj, B, 10)
    assert tuple(st["layers"]["k"].shape) == tuple(sj["layers"]["k"].shape)


# --- forward, prefill, decode ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_the_prefix_against_the_reference(dtype):
    """Hidden states and logits over P + S positions (positions arange(P +
    S), the prefix in the compute dtype before the text)."""
    cj, ct = _cfgs(dtype)
    pj, pt = _params()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    toks, patches = _inputs(cj)
    hj, _ = jax.jit(lambda p, t, e: J_T.forward(cj, p, t, prefix_embeds=e))(
        pj, toks, patches)
    ht, aux = T_T.forward(ct, pt, torch.from_numpy(toks),
                          prefix_embeds=torch.from_numpy(patches))
    assert ht.shape == (B, cj.num_prefix_tokens + toks.shape[1], ct.d_model)
    assert ht.dtype == ct.compute_dtype and float(aux) == 0.0
    _close(ht, hj.astype(jnp.float32), tol)
    _close(T_T.logits_from_hidden(ct, pt, ht),
           J_T.logits_from_hidden(cj, pj, hj), tol)
    # The reference's prefill step: the last position's logits.
    lj = jax.jit(J_steps.make_prefill_step(cj))(pj, toks, patches)
    _close(T_steps.make_prefill_step(ct)(
        pt, torch.from_numpy(toks), prefix_embeds=torch.from_numpy(patches)),
        lj, tol)


@pytest.mark.parametrize("variant", ["dense", "tag1", "tag2", "bf16"])
def test_prefill_then_decode_against_the_reference(variant):
    """The served path: the prefill over the patches and PROMPT tokens
    (the caches filled for all P + PROMPT positions), then STEPS
    teacher-forced decode steps, against the reference's forward over
    the whole sequence at the same positions; ``bf16`` is gse_serve tag
    2 at bfloat16, the served configuration."""
    kw = VARIANTS["tag2"] if variant == "bf16" else VARIANTS[variant]
    dtype = "bfloat16" if variant == "bf16" else "float32"
    cj, ct = _cfgs(dtype, **kw)
    pj, pt = _params(bool(kw))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    toks, patches = _inputs(cj, seed=2)
    want = _reference_logits(cj, pj, toks, patches)
    p = cj.num_prefix_tokens
    tt = torch.from_numpy(toks)
    st = T_T.decode_state_init(ct, B, p + PROMPT + STEPS, device=CPU)
    got = [T_steps.make_prefill_step(ct)(
        pt, tt[:, :PROMPT], prefix_embeds=torch.from_numpy(patches),
        state=st)]
    for i in range(STEPS - 1):
        lt, st = T_T.decode_step(ct, pt, st, tt[:, PROMPT + i],
                                 p + PROMPT + i)
        got.append(lt)
    for i, g in enumerate(got):
        w = want[:, p + PROMPT - 1 + i]
        assert g.shape == (B, ct.vocab_size)
        _close(g, w, tol)
        if dtype == "float32":
            np.testing.assert_array_equal(torch.argmax(g, -1).numpy(),
                                          np.asarray(jnp.argmax(w, -1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_fills_the_caches_for_the_prefix(dtype):
    """The prefill's caches hold the keys and values of every position,
    the prefix's included: a teacher-forced decode over the text after
    them continues as a second prefill over the longer sequence does
    (f32 within 1e-5, bf16 within BF16_TOL)."""
    _, ct = _cfgs(dtype)
    _, pt = _params()
    toks, patches = _inputs(ct, seed=3)
    tt, pe = torch.from_numpy(toks), torch.from_numpy(patches)
    p = ct.num_prefix_tokens
    st = T_T.decode_state_init(ct, B, p + PROMPT + STEPS, device=CPU)
    T_steps.make_prefill_step(ct)(pt, tt[:, :PROMPT], prefix_embeds=pe,
                                  state=st)
    assert float(st["layers"]["k"][:, :, :p + PROMPT].abs().sum()) > 0
    assert float(st["layers"]["k"][:, :, p + PROMPT:].abs().sum()) == 0
    for i in range(STEPS):
        lt, st = T_T.decode_step(ct, pt, st, tt[:, PROMPT + i],
                                 p + PROMPT + i)
    want = T_steps.make_prefill_step(ct)(pt, tt[:, :PROMPT + STEPS],
                                         prefix_embeds=pe)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(lt, want, **tol)


# --- quantize and serve ------------------------------------------------------

def test_quantize_tree_and_params_from_repro():
    pj, pt = _params()
    qj = J_Q.quantize_tree(pj, k=8, min_size=2048)
    qt = T_Q.quantize_tree(pt, k=8, min_size=2048)
    isj = lambda x: isinstance(x, J_gse.GSEPacked)  # noqa: E731
    ist = lambda x: isinstance(x, T_gse.GSEPacked)  # noqa: E731
    lj = jax.tree.leaves(qj, is_leaf=isj)
    lt = tree_leaves(qt, is_leaf=ist)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert isj(a) == ist(b)
        if ist(b):
            for f in ("table", "head", "tail1", "tail2"):
                np.testing.assert_array_equal(getattr(b, f).numpy(),
                                              np.asarray(getattr(a, f)))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for tag in (1, 2, 3):
        assert T_Q.tree_bytes(qt, tag) == J_Q.tree_bytes(qj, tag)
    gj, gt = _params(gse_serve=True)
    for a, b in zip(jax.tree.leaves(gj), tree_leaves(gt)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _reference_serve(cfg, params, prompts, gen):
    """The reference's ``launch/serve.py`` loop, on the given prompts."""
    batch, prompt_len = prompts.shape
    total = prompt_len + gen
    state = J_T.decode_state_init(cfg, batch, max_len=total)
    serve_step = jax.jit(J_steps.make_serve_step(cfg))
    out, tok = [], prompts[:, 0]
    for pos in range(total - 1):
        nxt, state = serve_step(params, state, tok,
                                jnp.asarray(pos, jnp.int32))
        tok = prompts[:, pos + 1] if pos + 1 < prompt_len else nxt
        if pos >= prompt_len - 1:
            out.append(np.asarray(nxt).tolist())
    return out


@pytest.mark.parametrize("gse_tag", [0, 2])
def test_serve_cli_gives_the_reference_tokens(gse_tag):
    """internvl2 serves text only through the decode path, as the
    reference's CLI does."""
    argv = ["--arch", ARCH, "--device", CPU]
    if gse_tag:
        argv += ["--gse-tag", str(gse_tag)]
    got = T_serve.main(argv)
    cj = J_configs.get_config(ARCH, smoke=True)
    ct = T_configs.get_config(ARCH, smoke=True)
    pt = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    pj = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), pt))
    if gse_tag:
        pj = J_Q.dequantize_tree(J_Q.quantize_tree(pj, k=8, min_size=2048),
                                 tag=gse_tag, dtype=jnp.bfloat16)
    prompts = torch.randint(0, ct.vocab_size, (4, 12),
                            generator=torch.Generator().manual_seed(1))
    want = _reference_serve(cj, pj, jnp.asarray(prompts.numpy()), 8)
    assert len(got) == 8 and got == want


def test_vlm_runs_on_the_cpu_without_a_launch():
    _, ct = _cfgs(**VARIANTS["tag2"])
    params = T_T.init_params(ct, torch.Generator().manual_seed(1),
                             device=CPU)
    T_F.reset_launch_counts()
    T_E.reset_launch_counts()
    toks, patches = _inputs(ct, seed=4)
    p = ct.num_prefix_tokens
    st = T_T.decode_state_init(ct, B, p + PROMPT + 1, device=CPU)
    logits = T_steps.make_prefill_step(ct)(
        params, torch.from_numpy(toks[:, :PROMPT]),
        prefix_embeds=torch.from_numpy(patches), state=st)
    logits, st = T_T.decode_step(ct, params, st, logits.argmax(-1),
                                 p + PROMPT)
    assert logits.shape == (B, ct.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert T_F.flash_attention_gqa.launches == 0
    assert T_E.gse_matmul_dense.launches == 0
