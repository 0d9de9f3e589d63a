"""The port's encdec family (seamless_m4t_large_v2: a bidirectional
encoder over frame embeddings, a causal decoder with cross-attention)
against the JAX reference at the smoke size (2 + 2 layers, d 64, 4 heads
of 16, GELU MLP).

The reference's params (``init_params`` at ``jax.random.key(0)``: stacked
``encoder`` and ``decoder`` leaves) are carried over with
``convert.params_from_repro``; both sides get the same numpy tokens and
frame embeddings (standard normal, as the reference's data pipeline draws
them).  On the CPU kernels E and F run their plain versions (f32).

The reference serves no encdec model (its CLI calls ``serve_step``
without ``enc_out``), so its yardstick is built from its own functions:
``enc_out`` from ``M.sinusoidal`` and ``_scan_encdec`` (the encoder half
of ``forward``), then ``decode_step(..., enc_out)`` teacher-forced from
position 0.  The port's prefill (``make_prefill_step(state=)``) is held
to that decode at the prompt's last position, and its decode steps after
the prefill to the decode steps after it.  Tolerances:

* Bitwise: the gelu MLP at bf16 (``modules._gelu``: XLA's rounding of
  every op and constant), ``_gelu`` on 3 x 65,536 seeded values,
  ``quantize_tree``/``dequantize_tree`` on both stacks, the ``gse_serve``
  init's segments through ``params_from_repro``.
* ``sinusoidal`` within 2 f32 ulps of the jitted reference (torch's
  ``exp``/``sin``/``cos`` against XLA's; the count of values that differ
  at all is asserted below a bound).
* rtol/atol 1e-5 at f32: the encoder, cross-attention, ``forward``, the
  prefill and the decode steps (``gse_serve`` tags 1 and 2 too).
* BF16_TOL (rtol 0.02, atol 0.075) at bf16: the port's F keeps the
  scores and probabilities in f32 where the reference's ``_attend``
  rounds them to bf16; the decode path (plain ``_attend`` on both sides,
  the reference's rounding points copied, ``transformer._cross_half``)
  measured within 5e-7 until a bf16 flip of a sum-order difference.
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
from repro.models import transformer as J_T  # noqa: E402
from repro.quant import gse_tensor as J_Q  # noqa: E402

from repro_torch import configs as T_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.kernels import flash_attn as T_F  # noqa: E402
from repro_torch.kernels import gse_matmul as T_E  # noqa: E402
from repro_torch.launch import serve as T_serve  # noqa: E402
from repro_torch.models import attention as T_A  # noqa: E402
from repro_torch.models import modules as T_M  # noqa: E402
from repro_torch.models import stepfns as T_steps  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.quant import gse_tensor as T_Q  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
ARCH = "seamless_m4t_large_v2"
B, FRAMES, PROMPT, STEPS = 2, 12, 7, 5
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
    """The reference's params at key 0 (jax) and the port's copy; the
    gse_serve init is the same at tags 1 and 2."""
    if gse_serve not in _PARAMS:
        cj, _ = _cfgs(**(VARIANTS["tag1"] if gse_serve else {}))
        pj, _ = J_T.init_params(cj, jax.random.key(0))
        _PARAMS[gse_serve] = (pj, convert.params_from_repro(
            jax.tree.map(np.asarray, pj), device=CPU))
    return _PARAMS[gse_serve]


def _inputs(cfg, seed=1, frames=FRAMES, length=PROMPT + STEPS):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, length), dtype=np.int32)
    emb = rng.standard_normal((B, frames, cfg.d_model), dtype=np.float32)
    return toks, emb


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _layer(tree, stack, i=0):
    """Layer ``i`` of a stacked tree (jax arrays or torch tensors)."""
    return jax.tree.map(lambda a: a[i], tree[stack])


def _reference_enc_out(cj, pj, emb):
    """The encoder half of the reference's ``forward`` (``:260-270``)."""
    @jax.jit
    def enc(p, e):
        e = e.astype(cj.compute_dtype)
        b, s = e.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        e = e + J_M.sinusoidal(pos, cj.d_model).astype(cj.compute_dtype)
        return J_T._scan_encdec(cj, p["encoder"], e, pos, "enc_attn")

    return enc(pj, emb)


def _reference_decode(cj, pj, toks, enc_out, n):
    """The reference's ``decode_step(..., enc_out)`` teacher-forced over
    the first ``n`` tokens from position 0: the logits of each step."""
    step = jax.jit(lambda p, s, t, pos, e: J_T.decode_step(cj, p, s, t, pos,
                                                           e))
    state = J_T.decode_state_init(cj, toks.shape[0], n)
    out = []
    for pos in range(n):
        lg, state = step(pj, state, toks[:, pos], jnp.asarray(pos, jnp.int32),
                         enc_out)
        out.append(lg)
    return out


# --- configs and params ------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_the_reference(smoke):
    cj = J_configs.get_config(ARCH, smoke=smoke)
    ct = T_configs.get_config("seamless-m4t-large-v2", smoke=smoke)
    for f in dataclasses.fields(cj):
        a, b = getattr(cj, f.name), getattr(ct, f.name)
        if f.name.endswith("dtype"):
            assert str(a).split(".")[-1].rstrip("'>") in str(b), f.name
        else:
            assert a == b, f.name
    assert ct.padded_vocab == cj.padded_vocab and ct.hd == cj.hd
    assert T_T._layer_kinds(ct) == ("dec_attn",) * ct.num_layers
    assert ARCH in T_configs.PORTED


@pytest.mark.parametrize("gse_serve", [False, True])
def test_init_has_the_reference_stacked_layout(gse_serve):
    """Same tree (``encoder``/``decoder`` stacks), shapes and dtypes as the
    reference's init; under gse_serve each layer's linears are segments
    with a table per layer, stacked (L, k)."""
    cj, ct = _cfgs(**(VARIANTS["tag2"] if gse_serve else {}))
    pj, _ = J_T.init_params(cj, jax.random.key(0))
    mine = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    lay = lambda tree: tree_map(  # noqa: E731
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    assert lay(mine) == lay(convert.params_from_repro(
        jax.tree.map(np.asarray, pj), device=CPU))
    assert sorted(mine) == ["decoder", "embed", "encoder", "final_norm",
                            "unembed"]
    assert sorted(mine["decoder"]) == ["attn", "mlp", "norm1", "norm2",
                                       "norm_x", "xattn"]
    wq = mine["decoder"]["xattn"]["wq"]
    if gse_serve:
        assert wq["table"].shape == (ct.num_layers, ct.gse_k)
    else:
        assert wq.shape == (ct.num_layers, ct.d_model, ct.d_model)


def test_decode_state_layout():
    cj, ct = _cfgs()
    st = T_T.decode_state_init(ct, B, 10, device=CPU)
    sj = J_T.decode_state_init(cj, B, 10)
    assert sorted(st) == sorted(sj) == ["self"]
    for k in ("k", "v"):
        assert tuple(st["self"][k].shape) == tuple(sj["self"][k].shape) == (
            ct.num_layers, B, 10, ct.num_kv_heads, ct.hd)


# --- modules -----------------------------------------------------------------

@pytest.mark.parametrize("d,n", [(64, 16), (1024, 512)])
def test_sinusoidal_within_two_ulps(d, n):
    """The table at the smoke width over its 16 frames and at seamless's
    width over the full cell's 512: every value within 2^-23 of the
    jitted reference's (2 ulps of the values in [0.5, 1]; the table lies
    in [-1, 1]).  The frequencies follow XLA's exp (``_exp_xla``);
    ``sin`` and ``cos`` are torch's: measured 246 of 2,048 and 48,474 of
    1,048,576 values differ, each by one ulp."""
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (2, n))
    want = np.asarray(jax.jit(lambda p: J_M.sinusoidal(p, d))(pos))
    got = T_M.sinusoidal(torch.from_numpy(pos.copy()), d)
    assert got.dtype == torch.float32 and got.shape == (2, n, d)
    diff = np.abs(got.numpy() - want)
    assert float(diff.max()) <= 2.0 ** -23
    assert int((diff > 0).sum()) <= 0.15 * want.size


def test_exp_xla_is_bitwise_the_jitted_exp():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-10, 0, 100000),
                        rng.uniform(-80, 80, 100000)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    np.testing.assert_array_equal(T_M._exp_xla(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_xla_gelu(dtype):
    """``modules._gelu`` on 3 x 65,536 seeded values: bitwise the jitted
    ``jax.nn.gelu`` at bf16, within 2e-6 at f32 (``tanh``'s ulps)."""
    jd, td = _DT[dtype]
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((3, 65536))).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x, jd)).astype(
        jnp.float32))
    got = _np(T_M._gelu(torch.from_numpy(x).to(td)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_against_the_reference(dtype):
    """``M.mlp(..., "gelu", ...)`` on a decoder layer's weights: bitwise
    at bf16 (the MLP's dots are f32 sums rounded once on both sides)."""
    cj, ct = _cfgs(dtype)
    pj, pt = _params()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 9, ct.d_model)).astype(np.float32)
    lj, lt = _layer(pj, "decoder"), _layer(pt, "decoder")
    want = jax.jit(lambda p, x: J_M.mlp(p, x, "gelu", cj.compute_dtype,
                                        cfg=cj))(lj["mlp"],
                                                 jnp.asarray(x).astype(
                                                     cj.compute_dtype))
    got = T_M.mlp(lt["mlp"], torch.from_numpy(x).to(ct.compute_dtype),
                  "gelu", ct.compute_dtype, cfg=ct)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        _close(got, want, F32_TOL)


# --- attention ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_attn_and_cross_attention_against_the_reference(dtype):
    """encoder_attn_apply (F, non-causal, S = T), cross_kv, and
    cross_attn_apply at S 9 over T 12 (F, non-causal) and at S 1 (the
    decode step's ``_attend``)."""
    cj, ct = _cfgs(dtype)
    pj, pt = _params()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(4)
    e = rng.standard_normal((B, FRAMES, ct.d_model)).astype(np.float32)
    lj, lt = _layer(pj, "encoder"), _layer(pt, "encoder")
    pos = np.broadcast_to(np.arange(FRAMES, dtype=np.int32), (B, FRAMES))
    ej = jnp.asarray(e).astype(cj.compute_dtype)
    et = torch.from_numpy(e).to(ct.compute_dtype)
    want = jax.jit(lambda p, x: J_A.encoder_attn_apply(p, x, cj, pos))(
        lj["attn"], ej)
    T_F.reset_launch_counts()
    got = T_A.encoder_attn_apply(lt["attn"], et, ct,
                                 torch.from_numpy(pos.copy()))
    assert got.dtype == ct.compute_dtype
    _close(got, want.astype(jnp.float32), tol)
    dj, dt = _layer(pj, "decoder", 1), _layer(pt, "decoder", 1)
    kvj = jax.jit(lambda p, x: J_A.cross_kv(p, x, cj))(dj["xattn"], ej)
    kvt = T_A.cross_kv(dt["xattn"], et, ct)
    for a, b in zip(kvt, kvj):
        assert a.shape == (B, FRAMES, ct.num_kv_heads, ct.hd)
        _close(a, b.astype(jnp.float32), F32_TOL if dtype == "float32"
               else dict(rtol=0, atol=0))  # one f32 sum, rounded once
    for s in (9, 1):
        x = rng.standard_normal((B, s, ct.d_model)).astype(np.float32)
        want = jax.jit(lambda p, x, kv: J_A.cross_attn_apply(p, x, kv, cj))(
            dj["xattn"], jnp.asarray(x).astype(cj.compute_dtype), kvj)
        got = T_A.cross_attn_apply(dt["xattn"], torch.from_numpy(x).to(
            ct.compute_dtype), kvt, ct)
        assert got.shape == (B, s, ct.d_model)
        _close(got, want.astype(jnp.float32),
               tol if s > 1 else dict(rtol=1e-5, atol=1e-6))
    # On the CPU the plain F ran: no launch counted.
    assert T_F.flash_attention_gqa.noncausal_launches == {"mma": 0,
                                                          "ffma": 0}


# --- forward, prefill, decode ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_against_the_reference(dtype):
    """forward's hidden states and logits (the encoder run inside), and
    ``encode`` against the reference's enc_out."""
    cj, ct = _cfgs(dtype)
    pj, pt = _params()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    toks, emb = _inputs(cj)
    hj, _ = jax.jit(lambda p, t, e: J_T.forward(cj, p, t, enc_embeds=e))(
        pj, toks, emb)
    ht, aux = T_T.forward(ct, pt, torch.from_numpy(toks),
                          enc_embeds=torch.from_numpy(emb))
    assert ht.dtype == ct.compute_dtype and float(aux) == 0.0
    _close(ht, hj.astype(jnp.float32), tol)
    lj = J_T.logits_from_hidden(cj, pj, hj)
    _close(T_T.logits_from_hidden(ct, pt, ht), lj, tol)
    eo = T_T.encode(ct, pt, torch.from_numpy(emb))
    _close(eo, _reference_enc_out(cj, pj, emb).astype(jnp.float32), tol)
    # forward from the encoder's output is forward from its embeddings.
    h2, _ = T_T.forward(ct, pt, torch.from_numpy(toks), enc_out=eo)
    assert torch.equal(h2, ht)


@pytest.mark.parametrize("variant", ["dense", "tag1", "tag2", "bf16"])
def test_prefill_then_decode_against_the_reference(variant):
    """The served path: ``make_prefill_step(enc_out=, state=)`` over the
    prompt, then teacher-forced ``decode_step(..., enc_out)``, both given
    the reference's enc_out, against the reference's decode from position
    0 (its logits at the prompt's last position, then each step's);
    ``bf16`` is gse_serve tag 2 at bfloat16, the served configuration."""
    kw = VARIANTS["tag2"] if variant == "bf16" else VARIANTS[variant]
    dtype = "bfloat16" if variant == "bf16" else "float32"
    cj, ct = _cfgs(dtype, **kw)
    pj, pt = _params(bool(kw))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    toks, emb = _inputs(cj, seed=2)
    eoj = _reference_enc_out(cj, pj, emb)
    want = _reference_decode(cj, pj, toks, eoj, PROMPT + STEPS)
    eot = torch.from_numpy(np.array(eoj.astype(jnp.float32))).to(
        ct.compute_dtype)
    tt = torch.from_numpy(toks)
    st = T_T.decode_state_init(ct, B, PROMPT + STEPS, device=CPU)
    got = [T_steps.make_prefill_step(ct)(pt, tt[:, :PROMPT], enc_out=eot,
                                         state=st)]
    serve_step = T_steps.make_serve_step(ct)
    for pos in range(PROMPT, PROMPT + STEPS):
        lt, st = T_T.decode_step(ct, pt, st, tt[:, pos], pos, enc_out=eot)
        got.append(lt)
    nxt, _ = serve_step(pt, T_T.decode_state_init(ct, B, 1, device=CPU),
                        tt[:, 0], 0, enc_out=eot)
    assert nxt.shape == (B,) and nxt.dtype == torch.int32
    for g, w in zip(got, want[PROMPT - 1:]):
        assert g.shape == (B, ct.vocab_size)
        _close(g, w, tol)
        if dtype == "float32":
            np.testing.assert_array_equal(torch.argmax(g, -1).numpy(),
                                          np.asarray(jnp.argmax(w, -1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_prefill(dtype):
    """prefill(state=) then decode_step equals a teacher-forced decode
    over the same tokens from position 0 (f32 within 1e-5; bf16 within
    BF16_TOL: the prefill's F keeps f32 scores), the caches likewise;
    the port's encoder feeds both."""
    _, ct = _cfgs(dtype)
    _, pt = _params()
    toks, emb = _inputs(ct, seed=3)
    tt = torch.from_numpy(toks)
    eo = T_T.encode(ct, pt, torch.from_numpy(emb))
    st = T_T.decode_state_init(ct, B, PROMPT + STEPS, device=CPU)
    got = [T_steps.make_prefill_step(ct)(
        pt, tt[:, :PROMPT], enc_embeds=torch.from_numpy(emb), state=st)]
    for pos in range(PROMPT, PROMPT + STEPS):
        got.append(T_T.decode_step(ct, pt, st, tt[:, pos], pos,
                                   enc_out=eo)[0])
    tf = T_T.decode_state_init(ct, B, PROMPT + STEPS, device=CPU)
    want = [T_T.decode_step(ct, pt, tf, tt[:, pos], pos, enc_out=eo)[0]
            for pos in range(PROMPT + STEPS)]
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=0.02, atol=0.075))
    for g, w in zip(got, want[PROMPT - 1:]):
        torch.testing.assert_close(g, w, **tol)
    for k in ("k", "v"):
        torch.testing.assert_close(st["self"][k].float(),
                                   tf["self"][k].float(), **tol)


def test_encdec_needs_its_encoder_input():
    _, ct = _cfgs()
    _, pt = _params()
    toks = torch.zeros(1, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="enc_embeds"):
        T_T.forward(ct, pt, toks)
    st = T_T.decode_state_init(ct, 1, 4, device=CPU)
    with pytest.raises(ValueError, match="enc_out"):
        T_T.decode_step(ct, pt, st, toks[:, 0], 0)


# --- quantize and serve ------------------------------------------------------

def test_quantize_tree_and_params_from_repro_carry_both_stacks():
    """quantize_tree on the encoder/decoder stacks bitwise the reference's,
    tree_bytes equal, dequantize_tree bitwise at tags 1-3 (bf16); a
    gse_serve init's stacked segments through params_from_repro
    bitwise."""
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
    assert ist(qt["encoder"]["mlp"]["w_up"])
    assert ist(qt["decoder"]["xattn"]["wq"])
    for tag in (1, 2, 3):
        assert T_Q.tree_bytes(qt, tag) == J_Q.tree_bytes(qj, tag)
        dj = J_Q.dequantize_tree(qj, tag=tag, dtype=jnp.bfloat16)
        dt = T_Q.dequantize_tree(qt, tag=tag, dtype=torch.bfloat16)
        for a, b in zip(jax.tree.leaves(dj), tree_leaves(dt)):
            if b.dtype == torch.bfloat16:
                np.testing.assert_array_equal(
                    b.view(torch.int16).numpy(), np.asarray(a).view(np.int16))
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    gj, gt = _params(gse_serve=True)
    for a, b in zip(jax.tree.leaves(gj), tree_leaves(gt)):
        np.testing.assert_array_equal(
            b.numpy() if b.dtype != torch.bfloat16 else _np(b),
            np.asarray(a))
    assert gt["decoder"]["xattn"]["wk"]["head"].dtype == torch.uint16


def test_serve_cli_raises_for_encdec():
    """The reference's CLI dies on seamless (``serve_step`` without
    ``enc_out``); the port's says why, before building anything."""
    with pytest.raises(ValueError, match="encoder input"):
        T_serve.main(["--arch", ARCH, "--device", CPU])


def test_encdec_entry_points_default_to_the_card_and_run_on_the_cpu():
    """The entry points default to the card; asked for the CPU the encdec
    path takes the plain E and F (no launch, the non-causal counter 0)."""
    import inspect

    for fn in (T_T.init_params, T_T.decode_state_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    _, ct = _cfgs(**VARIANTS["tag2"])
    params = T_T.init_params(ct, torch.Generator().manual_seed(1),
                             device=CPU)
    T_F.reset_launch_counts()
    T_E.reset_launch_counts()
    toks, emb = _inputs(ct, seed=5)
    eo = T_T.encode(ct, params, torch.from_numpy(emb))
    st = T_T.decode_state_init(ct, B, PROMPT + 1, device=CPU)
    logits = T_steps.make_prefill_step(ct)(
        params, torch.from_numpy(toks[:, :PROMPT]), enc_out=eo, state=st)
    logits, st = T_T.decode_step(ct, params, st, logits.argmax(-1), PROMPT,
                                 enc_out=eo)
    assert logits.shape == (B, ct.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert T_F.flash_attention_gqa.launches == 0
    assert T_F.flash_attention_gqa.noncausal_launches == {"mma": 0,
                                                          "ffma": 0}
    assert T_E.gse_matmul_dense.launches == 0
