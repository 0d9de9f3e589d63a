"""The port's ssm family (rwkv6_1p6b; ``models/rwkv.py`` on the
hand-written ``wkv6`` kernel) against the JAX reference at the smoke size
(2 layers, d 64, 4 heads of 16).

The reference's params (``init_params`` at ``jax.random.key(0)``, the
stacked ``(L, ...)`` layout) are carried over with
``convert.params_from_repro``; both sides get the same numpy inputs.  On
the CPU ``wkv6`` runs its plain version.  Tolerances:

* Bitwise: ``wkv6_plain`` (out and the final state) against the jitted
  ``lax.scan`` of the reference's step (``rwkv.py:136-143``) at head dims
  8, 16, 32 and 64, from a zero and a non-zero state, with torch's fused
  ``addcmul`` and with the exact f64 emulation of an FMA; the emulation
  against the fused one; ``quantize_tree`` on the RWKV leaves.
* rtol/atol 1e-5 at f32: ``rwkv_time_apply``, ``rwkv_channel_apply`` and
  their states, ``forward``, prefill logits and decode steps (XLA may
  contract the mixes into FMAs, and its ``tanh``/``exp`` are its own).
* BF16_TOL (rtol 0.02, atol 0.075) at bf16, as ``test_torch_lm.py`` (the
  decode steps measured 0.003 after copying XLA's rounding points).
* Prefill then decode equals a teacher-forced decode over the same tokens
  (the port's form of ``test_decode_matches_prefill_rwkv``) within f32
  ulps, bitwise at bf16 on these inputs.
* The serve CLI's tokens equal the reference serve loop's, ``--gse-tag``
  0 and 2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_configs  # noqa: E402
from repro.core import gse as J_gse  # noqa: E402
from repro.models import rwkv as J_W  # noqa: E402
from repro.models import stepfns as J_steps  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.quant import gse_tensor as J_Q  # noqa: E402

from repro_torch import configs as T_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import gse_matmul as T_E  # noqa: E402
from repro_torch.kernels import wkv6 as T_K  # noqa: E402
from repro_torch.launch import serve as T_serve  # noqa: E402
from repro_torch.models import rwkv as T_W  # noqa: E402
from repro_torch.models import stepfns as T_steps  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.quant import gse_tensor as T_Q  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
B = 2
ARCH = "rwkv6_1p6b"
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.02, atol=0.075)
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


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


def _params():
    """The reference's params at key 0 (jax) and the port's copy."""
    if not _PARAMS:
        cj, _ = _cfgs()
        pj, _ = J_T.init_params(cj, jax.random.key(0))
        _PARAMS["p"] = (pj, convert.params_from_repro(
            jax.tree.map(np.asarray, pj), device=CPU))
    return _PARAMS["p"]


def _layer0():
    pj, pt = _params()
    return (jax.tree.map(lambda a: a[0], pj["layers"]),
            tree_map(lambda t: t[0], pt["layers"]))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# --- configs and params -----------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_the_reference(smoke):
    cj = J_configs.get_config(ARCH, smoke=smoke)
    ct = T_configs.get_config("rwkv6-1.6b", smoke=smoke)
    for f in dataclasses.fields(cj):
        a, b = getattr(cj, f.name), getattr(ct, f.name)
        if f.name.endswith("dtype"):
            assert str(a).split(".")[-1].rstrip("'>") in str(b), f.name
        else:
            assert a == b, f.name
    assert T_T._layer_kinds(ct) == J_T._layer_kinds(cj) == \
        ("rwkv",) * ct.num_layers
    assert ct.is_attention_free and ARCH in T_configs.PORTED


@pytest.mark.parametrize("gse_serve", [False, True])
def test_init_has_the_reference_stacked_layout(gse_serve):
    """Same tree, shapes and dtypes as the reference's init; the RWKV
    weights stay dense under gse_serve, only the unembedding is packed."""
    cj, ct = _cfgs(gse_serve=gse_serve)
    pj, _ = J_T.init_params(cj, jax.random.key(0))
    mine = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    lay = lambda tree: tree_map(  # noqa: E731
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    assert lay(mine) == lay(convert.params_from_repro(
        jax.tree.map(np.asarray, pj), device=CPU))
    n, d, h, hn = ct.num_layers, ct.d_model, 4, ct.rwkv_head_dim
    assert mine["layers"]["time"]["bonus_u"].shape == (n, h, hn)
    assert mine["layers"]["chan"]["wk"].shape == (n, d, ct.d_ff)
    assert all(isinstance(v, torch.Tensor)
               for grp in ("time", "chan")
               for v in mine["layers"][grp].values())
    assert isinstance(mine["unembed"]["w"], dict) == gse_serve
    wb = mine["layers"]["time"]["w_base"]
    assert float(wb.min()) >= -2.0 and float(wb.max()) < 0.0


def test_decode_state_layout():
    _, ct = _cfgs()
    st = T_T.decode_state_init(ct, B, 10, device=CPU)["layers"]
    sj = J_T.decode_state_init(_cfgs()[0], B, 10)["layers"]
    assert sorted(st) == sorted(sj) == ["S", "last_c", "last_t"]
    for k in st:
        assert tuple(st[k].shape) == tuple(sj[k].shape)
        assert st[k].dtype == torch.float32
    assert st["S"].shape == (2, B, 4, 16, 16)


# --- the wkv6 kernel ----------------------------------------------------------

def _ref_scan(r, k, v, w, u, s0):
    """The reference's scan step (``rwkv.py:136-150``) over t."""
    def step(S, inp):
        rt, kt, vt, wt = inp
        kv = kt[..., :, None] * vt[..., None, :]
        out = jnp.einsum("bhn,bhnm->bhm", rt, S + u[None, :, :, None] * kv)
        S = wt[..., :, None] * S + kv
        return S, out

    xs = tuple(a.transpose(1, 0, 2, 3) for a in (r, k, v, w))
    s_fin, outs = jax.lax.scan(step, s0, xs)
    return outs.transpose(1, 0, 2, 3), s_fin


def _wkv_inputs(n, nonzero, b=2, s=9, h=3, seed=0):
    rng = np.random.default_rng(seed + n + 100 * nonzero)
    r, k, v = (rng.normal(size=(b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.3, 1.0, size=(b, s, h, n)).astype(np.float32)
    u = (0.1 * rng.normal(size=(h, n))).astype(np.float32)
    s0 = (rng.normal(size=(b, h, n, n)) if nonzero
          else np.zeros((b, h, n, n))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_wkv6_plain_is_bitwise_the_reference_scan(n, nonzero, fused,
                                                  monkeypatch):
    """out and the final state bitwise the jitted scan; ``fused`` False
    forces the exact f64 emulation of each FMA."""
    args = _wkv_inputs(n, nonzero)
    oj, sj = jax.jit(_ref_scan)(*args)
    if not fused:
        monkeypatch.setitem(T_K._BOUND, ("addcmul", "cpu"), False)
    ot, st = T_K.wkv6(*(torch.from_numpy(a) for a in args), device=CPU)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_fma_emulation_is_the_fused_multiply_add():
    """``_fma_exact`` against torch's fused ``addcmul`` (when this host's
    torch fuses it) and a fused/unfused split, on wide magnitudes,
    subnormal results, cancellations and ties."""
    rng = np.random.default_rng(4)
    a = (rng.normal(size=20000) * np.exp(rng.normal(size=20000) * 8)
         ).astype(np.float32)
    b = (rng.normal(size=20000) * np.exp(rng.normal(size=20000) * 8)
         ).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(size=20000) * 1e-6)
         ).astype(np.float32)  # near cancellation
    c[::3] = rng.normal(size=c[::3].shape).astype(np.float32) * 1e-38
    at, bt, ct = (torch.from_numpy(x) for x in (a, b, c))
    got = T_K._fma_exact(at, bt, ct)
    fused = T_K._addcmul_rounds_once(torch.device("cpu"))
    if fused:
        assert torch.equal(got, torch.addcmul(ct, at, bt))
    assert not torch.equal(got, ct + at * bt)  # the probe tells them apart
    # Where the f64 sum is exact, one rounding of it is the FMA.
    p = at.double() * bt.double()
    s = p + ct.double()
    exact = (s - p == ct.double()) & (s - ct.double() == p)
    assert torch.equal(got[exact], s[exact].float())


def test_wkv6_checks_its_inputs():
    args = [torch.from_numpy(a) for a in _wkv_inputs(16, True)]
    r, k, v, w, u, s0 = args
    with pytest.raises(ValueError, match="k must have"):
        T_K.wkv6(r, k[:, :3], v, w, u, s0, device=CPU)
    with pytest.raises(ValueError, match="u must be"):
        T_K.wkv6(r, k, v, w, u[:, :8], s0, device=CPU)
    with pytest.raises(ValueError, match="s0 must be"):
        T_K.wkv6(r, k, v, w, u, s0[:1], device=CPU)
    with pytest.raises(TypeError, match="float32"):
        T_K.wkv6(r.double(), k, v, w, u, s0, device=CPU)
    with pytest.raises(ValueError, match="contiguous"):
        T_K.wkv6(r.transpose(0, 1).contiguous().transpose(0, 1), k, v, w, u,
                 s0, device=CPU)
    with pytest.raises(ValueError, match="up to 64"):
        big = torch.zeros(1, 2, 1, 65)
        T_K.wkv6(big, big, big, big, torch.zeros(1, 65),
                 torch.zeros(1, 1, 65, 65), device=CPU)
    with pytest.raises(ValueError, match="r must be"):
        T_K.wkv6(r[0], k, v, w, u, s0, device=CPU)
    with pytest.raises(ValueError, match="expected cuda"):
        T_K.wkv6(r, k, v, w, u, s0)
    out, st = T_K.wkv6(r[:, :0].contiguous(), k[:, :0].contiguous(),
                       v[:, :0].contiguous(), w[:, :0].contiguous(), u, s0,
                       device=CPU)
    assert out.shape == (2, 0, 3, 16) and torch.equal(st, s0)


def test_wkv6_is_built_from_the_repo_sources():
    """``wkv6`` is one of the sources ``_build.build_all`` compiles; the
    kernel's FMA sequence is the one the plain version computes."""
    assert "wkv6" in _build.SOURCES
    cu, flags = _build._source("wkv6")
    text = cu.read_text()
    assert flags == () and 'extern "C" int wkv6_f32' in text
    for op in ("__fmul_rn(sk[j][i], vm)", "__fmaf_rn(su[i], kv, st[i])",
               "__fmaf_rn(sr[j][i], tt, acc)",
               "__fmaf_rn(sw[j][i], st[i], kv)"):
        assert op in text, op


# --- time-mix and channel-mix --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_time_and_channel_apply_against_the_reference(dtype, with_state):
    cj, ct = _cfgs(dtype)
    lj, lt = _layer0()
    jd, td = _DT[dtype]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 7, 64)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    sj = st = None
    if with_state:
        s0 = (0.3 * rng.normal(size=(B, 4, 16, 16))).astype(np.float32)
        last = rng.normal(size=(B, 64)).astype(np.float32)
        sj = {"S": jnp.asarray(s0), "last": jnp.asarray(last)}
        st = {"S": torch.from_numpy(s0.copy()), "last": torch.from_numpy(
            last.copy())}
    yj, nj = jax.jit(lambda p, x, s: J_W.rwkv_time_apply(p, x, cj, s))(
        lj["time"], xj, sj)
    yt, nt = T_W.rwkv_time_apply(lt["time"], xt, ct, state=st)
    assert yt.dtype == td
    _close(yt, yj.astype(jnp.float32), tol)
    _close(nt["S"], nj["S"], F32_TOL if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    np.testing.assert_array_equal(_np(nt["last"]),
                                  np.asarray(nj["last"].astype(jnp.float32)))
    prev = None if not with_state else st["last"]
    cj_prev = None if not with_state else sj["last"]
    yj, lj_c = jax.jit(lambda p, x, pr: J_W.rwkv_channel_apply(p, x, cj, pr))(
        lj["chan"], xj, cj_prev)
    yt, lt_c = T_W.rwkv_channel_apply(lt["chan"], xt, ct, prev=prev)
    _close(yt, yj.astype(jnp.float32), tol)
    np.testing.assert_array_equal(_np(lt_c),
                                  np.asarray(lj_c.astype(jnp.float32)))


def test_channel_mix_mixes_xr_with_mix_k():
    """The reference's quirk, kept: ``xr`` mixes with ``mix_k``; a
    channel-mix ``mix_r`` would be ignored, and changing ``mix_k`` moves
    the receptance too."""
    _, ct = _cfgs()
    _, lt = _layer0()
    p = dict(lt["chan"])
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(B, 5, 64)).astype(np.float32))
    y0, _ = T_W.rwkv_channel_apply(p, x, ct)
    y1, _ = T_W.rwkv_channel_apply(dict(p, mix_r=torch.zeros(64)), x, ct)
    assert torch.equal(y0, y1)
    p2 = dict(p, mix_k=torch.full((64,), 0.25))
    xs = T_W._shift(x)
    xk = T_W._mix(x, xs, p2["mix_k"])
    want = torch.sigmoid(xk @ p["wr"]) * ((torch.relu(xk @ p["wk"]) ** 2)
                                         @ p["wv"])
    torch.testing.assert_close(T_W.rwkv_channel_apply(p2, x, ct)[0], want,
                               rtol=1e-5, atol=1e-6)


# --- forward, prefill and decode --------------------------------------------

def _reference_decode(cj, pj, toks, max_len):
    step = jax.jit(lambda p, s, t, pos: J_T.decode_step(cj, p, s, t, pos))
    sj = J_T.decode_state_init(cj, toks.shape[0], max_len)
    out = []
    for pos in range(toks.shape[1]):
        lj, sj = step(pj, sj, toks[:, pos], jnp.asarray(pos, jnp.int32))
        out.append(lj)
    return out, sj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_against_the_reference(dtype):
    """forward's hidden states, the prefill logits and the decode steps
    after it, against the reference's forward and its decode loop from
    position 0; the state after prefill then decode against the loop's."""
    cj, ct = _cfgs(dtype)
    pj, pt = _params()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    prompt, steps = 10, 6
    toks = _tokens(1, (B, prompt + steps), cj.vocab_size)
    hj, _ = jax.jit(lambda p, t: J_T.forward(cj, p, t))(pj, toks)
    ht, aux = T_T.forward(ct, pt, torch.from_numpy(toks))
    assert ht.dtype == _DT[dtype][1] and float(aux) == 0.0
    _close(ht, hj.astype(jnp.float32), tol)
    want, sj = _reference_decode(cj, pj, toks, prompt + steps)
    st = T_T.decode_state_init(ct, B, prompt + steps, device=CPU)
    tt = torch.from_numpy(toks)
    got = [T_steps.make_prefill_step(ct)(pt, tt[:, :prompt], state=st)]
    _close(got[0], jax.jit(J_steps.make_prefill_step(cj))(
        pj, toks[:, :prompt]), tol)
    for pos in range(prompt, prompt + steps):
        lt, st = T_T.decode_step(ct, pt, st, tt[:, pos], pos)
        got.append(lt)
    for g, w in zip(got, want[prompt - 1:]):
        _close(g, w, tol)
        if dtype == "float32":
            np.testing.assert_array_equal(torch.argmax(g, -1).numpy(),
                                          np.asarray(jnp.argmax(w, -1)))
    s_tol = F32_TOL if dtype == "float32" else dict(rtol=0.02, atol=0.02)
    for name in ("S", "last_t", "last_c"):
        _close(st["layers"][name], sj["layers"][name].astype(jnp.float32),
               s_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_prefill(dtype):
    """The port's ``test_decode_matches_prefill_rwkv``: prefill(state=)
    then decode_step gives the logits and state of a teacher-forced
    decode over the same tokens (f32 within 1e-5; bf16 here bitwise), and
    forward's last hidden row the prefill's."""
    _, ct = _cfgs(dtype)
    _, pt = _params()
    prompt, steps = 12, 5
    toks = torch.from_numpy(_tokens(2, (B, prompt + steps), ct.vocab_size))
    st = T_T.decode_state_init(ct, B, prompt + steps, device=CPU)
    got = [T_steps.make_prefill_step(ct)(pt, toks[:, :prompt], state=st)]
    for pos in range(prompt, prompt + steps):
        got.append(T_T.decode_step(ct, pt, st, toks[:, pos], pos)[0])
    tf = T_T.decode_state_init(ct, B, prompt + steps, device=CPU)
    want = []
    for pos in range(prompt + steps):
        want.append(T_T.decode_step(ct, pt, tf, toks[:, pos], pos)[0])
    tol = F32_TOL if dtype == "float32" else dict(rtol=0, atol=0)
    for g, w in zip(got, want[prompt - 1:]):
        torch.testing.assert_close(g, w, **tol)
        assert torch.equal(g.argmax(-1), w.argmax(-1))
    for name in ("S", "last_t", "last_c"):
        torch.testing.assert_close(st["layers"][name], tf["layers"][name],
                                   **tol)


# --- quantize and serve -------------------------------------------------------

def test_quantize_tree_on_the_rwkv_leaves():
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
    tm = qt["layers"]["time"]
    assert ist(tm["wr"]) and ist(tm["w_lora_a"]) and not ist(tm["bonus_u"])
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


def test_rwkv_entry_points_default_to_the_card_and_run_on_the_cpu():
    """The new entry points default to the card; asked for the CPU, the
    ssm path takes the plain versions of wkv6 and E (no launch)."""
    import inspect

    for fn in (T_K.wkv6, T_W.rwkv_state_init, T_T.init_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    _, ct = _cfgs(gse_serve=True)
    params = T_T.init_params(ct, torch.Generator().manual_seed(1),
                             device=CPU)
    T_K.reset_launch_counts()
    T_E.reset_launch_counts()
    st = T_T.decode_state_init(ct, 1, 12, device=CPU)
    logits = T_steps.make_prefill_step(ct)(
        params, torch.zeros(1, 10, dtype=torch.int64), state=st)
    logits, st = T_T.decode_step(ct, params, st, logits.argmax(-1), 10)
    assert logits.shape == (1, ct.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert T_K.wkv6.launches == T_E.gse_matmul_dense.launches == 0
