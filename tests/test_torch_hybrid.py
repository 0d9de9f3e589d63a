"""The port's hybrid family (recurrentgemma_2b), local-window attention and
the 8-bit GSE-SEM KV cache against the JAX reference, at recurrentgemma's
smoke size (3 layers: RG-LRU, RG-LRU, local attention; d 64, hd 32,
window 16) and qwen3_4b's.

The reference's params (``init_params`` at ``jax.random.key(0)``, the
list layout of a heterogeneous stack) are carried over with
``convert.params_from_repro``; both sides get the same numpy tokens.  On
the CPU every kernel wrapper runs its plain version (F and ``lru_scan``
in f32).  Tolerances:

* Bitwise: ``_kv_pack_u8`` and ``_kv_decode_u8`` on seeded values and on
  edge cases (0, -0, past the top binade, below the bottom one, exact
  ties at .5, NaN and inf), the pack of ``quantize_tree`` on the list
  layout.
* rtol/atol 2e-5 (F's f32 tolerance): F's plain version with a window
  against the reference's ``_attend`` under the windowed mask, hd 32 and
  256.
* rtol 1e-5 / atol 1e-6: ``lru_scan``'s plain version (sequential, the
  product and the sum each rounded) against ``jax.lax.associative_scan``
  (a tree of the same operations).
* rtol/atol 1e-5 at compute_dtype float32: ``rglru_apply``,
  ``rglru_step``, ``forward``, prefill logits and the decode steps through
  a ring wrap (a 12-token prompt and 8 steps: the 16-slot ring wraps in
  decode; a 20-token prompt: it wraps in prefill), with and without
  ``kv_cache_gse``, on the hybrid and on qwen3_4b.
* BF16_TOL (rtol 0.02, atol 0.075) at bfloat16, as ``test_torch_lm.py``.
* The serve CLI's tokens equal the reference serve loop's on the same
  params, dense and at ``--gse-tag 2``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_configs  # noqa: E402
from repro.core import gse as J_gse  # noqa: E402
from repro.models import attention as J_A  # noqa: E402
from repro.models import modules as J_M  # noqa: E402
from repro.models import rglru as J_R  # noqa: E402
from repro.models import stepfns as J_steps  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.quant import gse_tensor as J_Q  # noqa: E402

from repro_torch import configs as T_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.kernels import flash_attn as T_F  # noqa: E402
from repro_torch.kernels import lru_scan as T_L  # noqa: E402
from repro_torch.launch import serve as T_serve  # noqa: E402
from repro_torch.models import attention as T_A  # noqa: E402
from repro_torch.models import rglru as T_R  # noqa: E402
from repro_torch.models import stepfns as T_steps  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.quant import gse_tensor as T_Q  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
B = 2
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.02, atol=0.075)
FLASH_TOL = dict(rtol=2e-5, atol=2e-5)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = "recurrentgemma_2b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch=ARCH, dtype="float32", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    return (dataclasses.replace(J_configs.get_config(arch, smoke=True),
                                compute_dtype=jd, **kw),
            dataclasses.replace(T_configs.get_config(arch, smoke=True),
                                compute_dtype=td, **kw))


_PARAMS = {}


def _params(arch=ARCH):
    """The reference's params at key 0 (jax) and the port's copy."""
    if arch not in _PARAMS:
        cj, _ = _cfgs(arch)
        pj, _ = J_T.init_params(cj, jax.random.key(0))
        _PARAMS[arch] = (pj, convert.params_from_repro(
            jax.tree.map(np.asarray, pj), device=CPU))
    return _PARAMS[arch]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# --- configs ------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_the_reference(smoke):
    cj = J_configs.get_config(ARCH, smoke=smoke)
    ct = T_configs.get_config("recurrentgemma-2b", smoke=smoke)
    for f in dataclasses.fields(cj):
        a, b = getattr(cj, f.name), getattr(ct, f.name)
        if f.name.endswith("dtype"):
            assert str(a).split(".")[-1].rstrip("'>") in str(b), f.name
        else:
            assert a == b, f.name
    assert ct.attn_layer_ids() == cj.attn_layer_ids()
    assert T_T._layer_kinds(ct) == J_T._layer_kinds(cj)
    assert ARCH in T_configs.PORTED


def test_init_has_the_reference_list_layout():
    pj, pt = _params()
    _, ct = _cfgs()
    mine = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    lay = lambda tree: tree_map(  # noqa: E731
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    assert isinstance(mine["layers"], list)
    assert lay(mine) == lay(pt)
    assert sorted(mine["layers"][0]["rglru"]) == sorted(
        ["w_in", "w_gate_branch", "conv", "wa", "wx", "lam", "w_out"])
    # Dense even under gse_serve, as the reference draws them.
    cg = dataclasses.replace(ct, gse_serve=True)
    packed = T_T.init_params(cg, torch.Generator().manual_seed(0), device=CPU)
    assert all(isinstance(v, torch.Tensor)
               for v in packed["layers"][0]["rglru"].values())
    assert "head" in packed["layers"][2]["attn"]["wq"]


# --- the 8-bit KV cache -----------------------------------------------------

def _kv_edge_values():
    table = J_A._KV_TABLE
    edges = [0.0, -0.0, 30.0, 31.0, -31.0, 1e3, -1e30, 3.4e38, np.inf,
             -np.inf, 1e-5, -1e-5, 2.0 ** -14, 2.0 ** -13, 1e-30, -1e-30,
             -1e-38, -1e-45, 2.0 ** -126, -2.0 ** -126]
    for e in table:  # exact ties at .5, and the binade edges (15.5)
        for m in (0.5, 1.5, 2.5, 7.5, 14.5, 15.5, 15.0, 7.75):
            edges += [m * 2.0 ** (e - 4), -m * 2.0 ** (e - 4)]
    return np.array(edges, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_pack_and_decode_are_bitwise_the_reference(dtype):
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.normal(size=4000).astype(np.float32) * s
        for s in (1e-3, 0.05, 1.0, 8.0, 64.0)] + [_kv_edge_values(),
                                                   np.array([np.nan],
                                                            np.float32)])
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(vals).astype(jd)
    xt = torch.from_numpy(vals).to(td)
    uj = np.array(J_A._kv_pack_u8(xj))
    ut = T_A._kv_pack_u8(xt)
    assert ut.dtype == torch.uint8
    np.testing.assert_array_equal(ut.numpy(), uj)
    every = np.arange(256, dtype=np.uint8)  # every byte decodes the same
    for u in (uj, every):
        for dj, dt, view in ((jnp.float32, torch.float32, np.int32),
                             (jnp.bfloat16, torch.bfloat16, np.int16)):
            want = np.asarray(J_A._kv_decode_u8(jnp.asarray(u), dj))
            got = T_A._kv_decode_u8(torch.from_numpy(u), dt)
            assert got.dtype == dt
            np.testing.assert_array_equal(
                got.view(getattr(torch, np.dtype(view).name)).numpy(),
                want.view(view))


def test_kv_cache_init_and_ring_sizes():
    _, ct = _cfgs()
    kv = dataclasses.replace(ct, kv_cache_gse=True)
    c = T_A.cache_init(kv, 2, 40, window=16, device=CPU)
    assert c["k"].dtype == torch.uint8 and c["k"].shape == (2, 16, 1, 32)
    assert T_A.cache_init(ct, 2, 10, window=16, device=CPU)["v"].shape == \
        (2, 10, 1, 32)
    state = T_T.decode_state_init(ct, 2, 40, device=CPU)["layers"]
    assert state[2]["k"].shape == (2, 16, 1, 32)
    assert state[0]["h"].shape == (2, 64) and state[0]["h"].dtype == \
        torch.float32
    assert state[0]["conv"].shape == (2, 3, 64)


# --- F with a window ----------------------------------------------------------

@pytest.mark.parametrize("hd", [32, 256])
@pytest.mark.parametrize("s, window, heads", [(40, 16, (2, 1)),
                                              (70, 64, (10, 1)),
                                              (33, 1, (4, 2))])
def test_flash_window_against_the_reference_attend(hd, s, window, heads):
    h, kv = heads
    rng = np.random.default_rng(s + window + hd)
    q = rng.normal(size=(2, s, h, hd)).astype(np.float32)
    k, v = (rng.normal(size=(2, s, kv, hd)).astype(np.float32)
            for _ in range(2))
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    mask = ((j <= i) & (j > i - window))[None, None, None]
    cj, _ = _cfgs()
    want = J_A._attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(mask), cj, jnp.float32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    plain = T_F.flash_attention_gqa_plain(qt, kt, vt, window=window)
    _close(plain, want, FLASH_TOL)
    got = T_F.flash_attention_gqa(qt, kt, vt, window=window, device=CPU)
    assert torch.equal(got, plain)
    # The window changes the answer where it masks anything.
    assert not torch.equal(plain, T_F.flash_attention_gqa_plain(qt, kt, vt))


def test_flash_window_arguments():
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="causal"):
        T_F.flash_attention_gqa(q, q, q, causal=False, window=2, device=CPU)
    with pytest.raises(ValueError, match="window"):
        T_F.flash_attention_gqa_plain(q, q, q, window=-1)
    assert T_F.flash_body(torch.bfloat16, 256) == "mma"
    assert T_F.flash_body(torch.float32, 256) == "ffma"
    assert T_F.flash_body(torch.bfloat16, 144) == "ffma"
    assert T_F.HD_MAX == 256


# --- lru_scan -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 37, 64), (1, 1, 8), (3, 256, 16)])
def test_lru_scan_against_the_associative_scan(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.5, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    h0 = torch.zeros(shape[0], shape[2])
    h, last = T_L.lru_scan(at, bt, h0, device=CPU)
    _close(h, want, SCAN_TOL)
    assert torch.equal(last, h[:, -1])
    hp, _ = T_L.lru_scan_plain(at, bt, h0)
    assert torch.equal(h, hp)
    # From h0: the same recurrence, step by step.
    h0 = torch.from_numpy(rng.normal(size=(shape[0], shape[2]))
                          .astype(np.float32))
    h, last = T_L.lru_scan(at, bt, h0, device=CPU)
    want0 = at[:, 0] * h0 + bt[:, 0]
    assert torch.equal(h[:, 0], want0)


def test_lru_scan_checks_its_inputs():
    a = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="h0"):
        T_L.lru_scan(a, a, torch.zeros(2, 5), device=CPU)
    with pytest.raises(TypeError, match="float32"):
        T_L.lru_scan(a.double(), a.double(), torch.zeros(2, 4).double(),
                     device=CPU)
    h, last = T_L.lru_scan(a[:, :0], a[:, :0], torch.ones(2, 4), device=CPU)
    assert h.shape == (2, 0, 4) and torch.equal(last, torch.ones(2, 4))


# --- the RG-LRU block ---------------------------------------------------------

def _rglru_params():
    pj, pt = _params()
    return pj["layers"][0]["rglru"], pt["layers"][0]["rglru"]


def test_rglru_apply_and_its_state():
    cj, ct = _cfgs()
    pj, pt = _rglru_params()
    x = np.random.default_rng(5).normal(size=(B, 11, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: J_R.rglru_apply(p, x, cj))(pj, x)
    state = T_R.rglru_state_init(ct, B, torch.float32, device=CPU)
    got = T_R.rglru_apply(pt, torch.from_numpy(x), ct, state=state)
    _close(got, want, F32_TOL)
    # The state the reference's steps leave after the same 11 inputs.
    sj = J_R.rglru_state_init(cj, B, jnp.float32)
    step = jax.jit(lambda p, x, s: J_R.rglru_step(p, x, s, cj))
    for t in range(x.shape[1]):
        _, sj = step(pj, x[:, t:t + 1], sj)
    _close(state["h"], sj["h"], F32_TOL)
    _close(state["conv"], sj["conv"], F32_TOL)
    # Two inputs: the conv's state keeps the zero padding in front.
    short = T_R.rglru_state_init(ct, B, torch.float32, device=CPU)
    T_R.rglru_apply(pt, torch.from_numpy(x[:, :2]), ct, state=short)
    assert torch.equal(short["conv"][:, 0], torch.zeros(B, 64))


def test_rglru_step_against_the_reference():
    cj, ct = _cfgs()
    pj, pt = _rglru_params()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    h = rng.normal(size=(B, 64)).astype(np.float32)
    conv = rng.normal(size=(B, 3, 64)).astype(np.float32)
    yj, sj = jax.jit(lambda p, x, s: J_R.rglru_step(p, x, s, cj))(
        pj, x, {"h": h, "conv": conv})
    st = {"h": torch.from_numpy(h.copy()), "conv": torch.from_numpy(
        conv.copy())}
    yt, st2 = T_R.rglru_step(pt, torch.from_numpy(x), st, ct)
    assert st2 is st
    _close(yt, yj, F32_TOL)
    _close(st["h"], sj["h"], F32_TOL)
    np.testing.assert_array_equal(st["conv"].numpy(), np.asarray(sj["conv"]))


# --- forward, prefill and decode --------------------------------------------

def test_forward_f32():
    cj, ct = _cfgs()
    pj, pt = _params()
    toks = _tokens(1, (B, 24), cj.vocab_size)  # past the window
    hj, _ = jax.jit(lambda p, t: J_T.forward(cj, p, t))(pj, toks)
    ht, _ = T_T.forward(ct, pt, torch.from_numpy(toks))
    assert ht.shape == hj.shape and ht.dtype == torch.float32
    _close(ht, hj, F32_TOL)


def _reference_decode(cj, pj, toks, max_len):
    """The reference's decode_step over every position of ``toks`` from an
    empty state: the logits of each step and the final state."""
    step = jax.jit(lambda p, s, t, pos: J_T.decode_step(cj, p, s, t, pos))
    sj = J_T.decode_state_init(cj, toks.shape[0], max_len)
    out = []
    for pos in range(toks.shape[1]):
        lj, sj = step(pj, sj, toks[:, pos], jnp.asarray(pos, jnp.int32))
        out.append(lj)
    return out, sj


def _prefill_decode(ct, pt, toks, prompt):
    """prefill(state=) then decode_step: the logits of each and a copy of
    the state right after the prefill."""
    total = toks.shape[1]
    st = T_T.decode_state_init(ct, toks.shape[0], total, device=CPU)
    tt = torch.from_numpy(toks)
    out = [T_steps.make_prefill_step(ct)(pt, tt[:, :prompt], state=st)]
    after = tree_map(lambda t: t.clone(), st)
    for pos in range(prompt, total):
        lt, st = T_T.decode_step(ct, pt, st, tt[:, pos], pos)
        out.append(lt)
    return out, st, after


@pytest.mark.parametrize("kv8", [False, True])
@pytest.mark.parametrize("prompt, steps", [(12, 8), (20, 4)])
def test_prefill_then_decode_through_a_ring_wrap(prompt, steps, kv8):
    """prefill(state=) then decode_step, against the reference: the
    prefill logits against its make_prefill_step and (without the 8-bit
    cache) its decode loop's step at prompt - 1, every later step against
    its decode loop from
    position 0 (the reference's serve loop).  A 12-token prompt wraps the
    16-slot ring in decode, a 20-token one in prefill.

    Under kv_cache_gse the decode loop attends over the packed prompt and
    an f32 rounding difference between the two paths' keys can move a
    packed entry by a mantissa step (the prompt-20 case moves the logits by
    0.006 so).  There the steps are held at 1e-5 to the reference's
    decode_step run from the port's own state after the prefill, and the
    ring to the reference's: under 0.2% of its bytes differ, each decoding
    within a mantissa step."""
    cj, ct = _cfgs(kv_cache_gse=kv8)
    pj, pt = _params()
    toks = _tokens(2, (B, prompt + steps), cj.vocab_size)
    want, sj = _reference_decode(cj, pj, toks, prompt + steps)
    got, st, after = _prefill_decode(ct, pt, toks, prompt)
    _close(got[0], jax.jit(J_steps.make_prefill_step(cj))(
        pj, toks[:, :prompt]), F32_TOL)
    if kv8:
        state = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in c.items()}
                            for c in after["layers"]]}
        step = jax.jit(lambda p, s, t, pos: J_T.decode_step(cj, p, s, t,
                                                            pos))
        want = want[:prompt]
        for pos in range(prompt, prompt + steps):
            lj, state = step(pj, state, toks[:, pos],
                             jnp.asarray(pos, jnp.int32))
            want.append(lj)
    # Under kv_cache_gse the loop's step at prompt - 1 attends over the
    # packed prompt, the prefill over the exact one.
    pairs = zip(got[1:], want[prompt:]) if kv8 else zip(got,
                                                        want[prompt - 1:])
    for g, w in pairs:
        _close(g, w, F32_TOL)
        np.testing.assert_array_equal(torch.argmax(g, -1).numpy(),
                                      np.asarray(jnp.argmax(w, -1)))
    ring = st["layers"][2]
    assert ring["k"].shape[1] == cj.local_window
    assert ring["k"].dtype == (torch.uint8 if kv8 else torch.float32)
    for name in ("k", "v"):
        if kv8:
            mine, ref = ring[name].numpy(), np.asarray(sj["layers"][2][name])
            assert (mine != ref).mean() < 2e-3
            _close(T_A._kv_decode_u8(ring[name], torch.float32),
                   J_A._kv_decode_u8(sj["layers"][2][name], jnp.float32),
                   dict(rtol=1 / 8, atol=2.0 ** -13))
        else:
            _close(ring[name], sj["layers"][2][name], F32_TOL)
    for i in (0, 1):
        _close(st["layers"][i]["h"], sj["layers"][i]["h"], F32_TOL)


def _qwen_prompt_state(cj, pj, toks, max_len):
    """The reference's decode state after the prompt along its prefill path
    (``_project_qkv``, ``rope``, ``_block_apply`` per layer), packed with
    ``_kv_pack_u8``: what the port's prefill(state=) writes."""
    dtype = cj.compute_dtype
    x = J_M.embed(pj["embed"], toks, dtype)
    b, s = x.shape[:2]
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    state = J_T.decode_state_init(cj, b, max_len)
    ks, vs = [], []
    for i in range(cj.num_layers):
        lp = jax.tree.map(lambda a: a[i], pj["layers"])
        h = J_M.rmsnorm(lp["norm1"], x)
        _, k, v = J_A._project_qkv(lp["attn"], h, cj, dtype)
        k = J_M.rope(k, positions, cj.rope_theta)
        ks.append(J_A._kv_pack_u8(k))
        vs.append(J_A._kv_pack_u8(v))
        x, _ = J_T._block_apply(cj, lp, x, positions, "attn")
    lay = state["layers"]
    return {"layers": {"k": lay["k"].at[:, :, :s].set(jnp.stack(ks)),
                       "v": lay["v"].at[:, :, :s].set(jnp.stack(vs))}}


def test_qwen3_kv_cache_gse_decode_and_prefill():
    """qwen3_4b under kv_cache_gse: the decode loop from position 0 against
    the reference's, and prefill then decode against the reference's decode
    steps over the same packed prompt cache (the reference's prefill path:
    its decode loop over the prompt would attend over the packed cache)."""
    cj, ct = _cfgs("qwen3_4b", kv_cache_gse=True)
    pj, pt = _params("qwen3_4b")
    prompt, steps = 8, 4
    toks = _tokens(3, (B, prompt + steps), cj.vocab_size)
    want, sj = _reference_decode(cj, pj, toks, prompt + steps)
    st = T_T.decode_state_init(ct, B, prompt + steps, device=CPU)
    assert st["layers"]["k"].dtype == torch.uint8
    for pos in range(prompt + steps):
        lt, st = T_T.decode_step(ct, pt, st, torch.from_numpy(toks[:, pos]),
                                 pos)
        _close(lt, want[pos], F32_TOL)
    np.testing.assert_array_equal(st["layers"]["k"].numpy(),
                                  np.asarray(sj["layers"]["k"]))
    got, st, _ = _prefill_decode(ct, pt, toks, prompt)
    lj = jax.jit(J_steps.make_prefill_step(cj))(pj, toks[:, :prompt])
    _close(got[0], lj, F32_TOL)
    sj = _qwen_prompt_state(cj, pj, jnp.asarray(toks[:, :prompt]),
                            prompt + steps)
    step = jax.jit(lambda p, s, t, pos: J_T.decode_step(cj, p, s, t, pos))
    for i, pos in enumerate(range(prompt, prompt + steps)):
        lj, sj = step(pj, sj, toks[:, pos], jnp.asarray(pos, jnp.int32))
        _close(got[1 + i], lj, F32_TOL)
    np.testing.assert_array_equal(st["layers"]["v"].numpy(),
                                  np.asarray(sj["layers"]["v"]))


def test_forward_prefill_decode_bf16():
    cj, ct = _cfgs(dtype="bfloat16")
    pj, pt = _params()
    toks = _tokens(4, (B, 20), cj.vocab_size)
    hj, _ = jax.jit(lambda p, t: J_T.forward(cj, p, t))(pj, toks)
    ht, _ = T_T.forward(ct, pt, torch.from_numpy(toks))
    assert ht.dtype == torch.bfloat16
    _close(ht, hj, BF16_TOL)
    want, _ = _reference_decode(cj, pj, toks, 20)
    got, _, _ = _prefill_decode(ct, pt, toks, 14)
    for g, w in zip(got, want[13:]):
        _close(g, w, BF16_TOL)


# --- quantize and serve -------------------------------------------------------

@pytest.mark.parametrize("min_size", [2048, 64])
def test_quantize_tree_on_the_list_layout(min_size):
    """The list layout packs as the reference's: at 64 the conv (4 x 64)
    and lam (64) leaves are packed too, as at full width at 2048."""
    pj, pt = _params()
    qj = J_Q.quantize_tree(pj, k=8, min_size=min_size)
    qt = T_Q.quantize_tree(pt, k=8, min_size=min_size)
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
    rg = qt["layers"][0]["rglru"]
    assert ist(rg["conv"]) == ist(rg["lam"]) == (min_size == 64)
    assert T_Q.tree_bytes(qt, 2) == J_Q.tree_bytes(qj, 2)


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
    """``main(["--arch", "recurrentgemma_2b", "--device", "cpu"])`` (bf16,
    batch 4, 12-token prompts and 8 new tokens: the ring wraps) against
    the reference's serve loop on the same params and prompts."""
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


def test_hybrid_entry_points_default_to_the_card_and_run_on_the_cpu():
    """The new entry points default to the card; asked for the CPU, the
    hybrid path takes the plain versions of F and lru_scan (no launch)."""
    import inspect

    for fn in (T_L.lru_scan, T_R.rglru_state_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    _, ct = _cfgs()
    params = T_T.init_params(ct, torch.Generator().manual_seed(1),
                             device=CPU)
    T_L.reset_launch_counts()
    T_F.reset_launch_counts()
    st = T_T.decode_state_init(ct, 1, 20, device=CPU)
    toks = torch.zeros(1, 18, dtype=torch.int64)
    logits = T_steps.make_prefill_step(ct)(params, toks, state=st)
    assert logits.shape == (1, ct.vocab_size)
    assert T_L.lru_scan.launches == T_F.flash_attention_gqa.launches == 0
    assert T_F.flash_attention_gqa.window_launches == {"mma": 0, "ffma": 0}


def test_plain_memo_decodes_each_weight_once_with_the_same_bits():
    """``gse_matmul.plain_memo`` (the CPU twins' switch in chip_smoke.py):
    within it the plain E reuses each decoded column block, bitwise the
    products without it, keyed by the stored head tensor and view; it keeps
    nothing once the block ends."""
    from repro_torch.kernels import gse_matmul as T_E
    from repro_torch.models import modules as T_Mo

    _, ct = _cfgs(gse_serve=True, gse_tag=2)
    rng = np.random.default_rng(9)
    w = T_Mo.pack_linear_weight(torch.from_numpy(
        rng.normal(size=(64, 96)).astype(np.float32)), ct)
    tag, ei, scales = T_Mo.segment_read(w, ct)
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    args = (w["head"], w["tail1"], None, scales)
    want = T_E.gse_matmul_dense_plain(x, *args, ei_bit=ei, tag=tag)
    calls = []
    real = T_E.gse_decode_dense_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    T_E.gse_decode_dense_plain = counted
    try:
        with T_E.plain_memo():
            for _ in range(3):
                got = T_E.gse_matmul_dense_plain(x, *args, ei_bit=ei,
                                                 tag=tag)
                assert torch.equal(got, want)
            # Another view of the same storage is another weight.
            T_E.gse_matmul_dense_plain(x[:, :32], w["head"][:32],
                                       w["tail1"][:32], None, scales,
                                       ei_bit=ei, tag=tag)
            assert len(calls) == 2
        assert T_E._MEMO is None
    finally:
        T_E.gse_decode_dense_plain = real


def test_flash_windowed_build_is_its_own_library():
    """F's windows and hd 256 live in a second build of the same source
    (``flash_attn_window``, FLASH_WINDOW=1), so a window of 0 at hd <= 128
    runs the plain build; the two libraries hash apart."""
    from repro_torch.kernels import _build

    assert "flash_attn_window" in _build.SOURCES
    cu, flags = _build._source("flash_attn_window")
    assert cu == _build._source("flash_attn")[0] and "-DFLASH_WINDOW=1" in \
        flags
    assert _build._lib_path("flash_attn_window") != \
        _build._lib_path("flash_attn")
    text = cu.read_text()
    assert "#if FLASH_WINDOW" in text and "kHdMax = kWindowBuild ? 256 : 128" \
        in text
