"""The port's LM serving path against the JAX reference at qwen3_4b's smoke
size: params, forward, prefill, decode, quantize/dequantize and the serve
loop.

The reference's params (``init_params`` at ``jax.random.key(0)``) are
carried over with ``convert.params_from_repro``; both sides get the same
numpy tokens.  On the CPU every kernel wrapper runs its plain version:
E and F compute in f32.

* Exact: ``quantize_tree``'s tables and segments, ``dequantize_tree`` at
  tags 1/2/3 into f32 and bf16, ``tree_bytes``, ``take_weight``'s decode,
  and ``pack32_jnp``/``extract_shared_exponents_jnp`` on the ``gse_serve``
  init values.
* At ``compute_dtype=float32`` (dense, and ``gse_serve`` at tags 1/2/3):
  ``forward`` hidden states, ``make_prefill_step`` logits and 4
  teacher-forced ``decode_step`` logits within rtol/atol 1e-5, the greedy
  tokens equal.
* At bfloat16 (the configs' default): within BF16_TOL (rtol 0.02, atol
  0.075); the largest difference measured is 0.049 on values up to 3.1
  (the dense model's decode steps: 5e-7).  The reference rounds the
  attention scores, probabilities and products to bf16 (and, under
  ``gse_serve``, the decoded weights); the port's kernels E and F keep them
  in f32, so the two differ by bf16 roundings, not by a fault.  The
  port's plain torch ops round where XLA's CPU build of the reference
  rounds (``modules._silu``, ``transformer._mlp_half``), so the dense
  decode path stays within f32 ulps of it.
* The serve loop (``launch/serve.py``: teacher-forced prefill through the
  decode path, then greedy decoding, bf16) gives the reference's tokens
  at ``--gse-tag`` 0/1/2/3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_configs  # noqa: E402
from repro.core import gse as J_gse  # noqa: E402
from repro.models import modules as J_M  # noqa: E402
from repro.models import stepfns as J_steps  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.quant import gse_tensor as J_Q  # noqa: E402

from repro_torch import configs as T_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.launch import serve as T_serve  # noqa: E402
from repro_torch.models import modules as T_M  # noqa: E402
from repro_torch.models import stepfns as T_steps  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.quant import gse_tensor as T_Q  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
B, S, STEPS = 2, 8, 4
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.02, atol=0.075)
VARIANTS = {"dense": {}, "tag1": dict(gse_serve=True, gse_tag=1),
            "tag2": dict(gse_serve=True, gse_tag=2),
            "tag3": dict(gse_serve=True, gse_tag=3)}
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant, dtype="float32"):
    kw = VARIANTS[variant]
    jd, td = _DT[dtype]
    base_j = J_configs.get_config("qwen3_4b", smoke=True)
    base_t = T_configs.get_config("qwen3_4b", smoke=True)
    return (dataclasses.replace(base_j, compute_dtype=jd, **kw),
            dataclasses.replace(base_t, compute_dtype=td, **kw))


_PARAMS = {}


def _params(variant):
    """The reference's params (jax) and the port's copy (torch, CPU).  The
    gse_serve init differs between tags only in tag 3's tail2, so tags 1
    and 2 share one init."""
    key = "tag1" if variant == "tag2" else variant
    if key not in _PARAMS:
        cj, _ = _cfgs(key)
        pj, _ = J_T.init_params(cj, jax.random.key(0))
        tree = jax.tree.map(np.asarray, pj)
        _PARAMS[key] = (pj, convert.params_from_repro(tree, device=CPU))
    return _PARAMS[key]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


_RUNS = {}


def _runs(variant, dtype):
    """forward, prefill and STEPS decode logits on both sides (cached)."""
    key = (variant, dtype)
    if key in _RUNS:
        return _RUNS[key]
    cj, ct = _cfgs(variant, dtype)
    pj, pt = _params(variant)
    toks = _tokens(1, (B, S), cj.vocab_size)
    hj, _ = jax.jit(lambda p, t: J_T.forward(cj, p, t))(pj, toks)
    ht, _ = T_T.forward(ct, pt, torch.from_numpy(toks))
    lj = jax.jit(J_steps.make_prefill_step(cj))(pj, toks)
    lt = T_steps.make_prefill_step(ct)(pt, torch.from_numpy(toks))
    step = jax.jit(lambda p, s, t, pos: J_T.decode_step(cj, p, s, t, pos))
    sj = J_T.decode_state_init(cj, B, STEPS)
    st = T_T.decode_state_init(ct, B, STEPS, device=CPU)
    dec = []
    for pos in range(STEPS):
        ldj, sj = step(pj, sj, toks[:, pos], jnp.asarray(pos, jnp.int32))
        ldt, st = T_T.decode_step(ct, pt, st, torch.from_numpy(toks[:, pos]),
                                  pos)
        dec.append((ldj, ldt))
    _RUNS[key] = dict(forward=(hj, ht), prefill=(lj, lt), decode=dec)
    return _RUNS[key]


# --- configs and params -----------------------------------------------------

OTHER_DENSE = ("granite_3_2b", "granite_34b", "qwen15_32b")


@pytest.mark.parametrize("arch", ("qwen3-4b",) + OTHER_DENSE)
@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_the_reference(arch, smoke):
    cj = J_configs.get_config(arch, smoke=smoke)
    ct = T_configs.get_config(arch, smoke=smoke)
    for f in dataclasses.fields(cj):
        a, b = getattr(cj, f.name), getattr(ct, f.name)
        if f.name.endswith("dtype"):
            assert str(a).split(".")[-1].rstrip("'>") in str(b), f.name
        else:
            assert a == b, f.name
    assert ct.padded_vocab == cj.padded_vocab and ct.hd == cj.hd


def test_unported_archs_and_options_raise():
    """Every architecture resolves (the encdec and vlm families included),
    an unknown one raises, and the port's step functions now include the
    train step (ROADMAP queue 1 item 16.3; tests/test_torch_train.py holds
    it to the reference)."""
    for arch in J_configs.ARCH_IDS:
        assert T_configs.get_config(arch).family == \
            J_configs.get_config(arch).family
    assert set(T_configs.PORTED) == set(J_configs.ARCH_IDS)
    with pytest.raises(KeyError):
        T_configs.get_config("no_such_arch")
    for name in ("make_train_step", "lm_loss", "make_loss_fn", "TrainState",
                 "make_serve_step", "make_prefill_step"):
        assert hasattr(J_steps, name) and name in T_steps.__all__, name
    _, ct = _cfgs("dense")
    # The 8-bit cache and local windows are ported: uint8 slots, a ring.
    from repro_torch.models import attention as T_A
    kv8 = T_A.cache_init(dataclasses.replace(ct, kv_cache_gse=True), 1, 4,
                         device=CPU)
    assert kv8["k"].dtype == kv8["v"].dtype == torch.uint8
    assert kv8["k"].shape == (1, 4, ct.num_kv_heads, ct.hd)
    ring = T_A.cache_init(ct, 1, 4, window=2, device=CPU)
    assert ring["k"].shape == ring["v"].shape == (1, 2, ct.num_kv_heads,
                                                  ct.hd)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_init_has_the_reference_layout(variant):
    """Same tree, shapes and dtypes as the reference's init, stacked
    (L, ...) leaves included."""
    pj, pt = _params(variant)
    _, ct = _cfgs(variant)
    mine = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    lay = lambda tree: tree_map(  # noqa: E731
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    want = lay(convert.params_from_repro(jax.tree.map(np.asarray, pj), CPU))
    assert lay(mine) == want == lay(pt)


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_gse_serve_pack_is_bitwise_on_the_init_values(tag):
    """The dense init draws the values the gse_serve init packs (the same
    keys); the port's pack of them is the reference's, layer by layer."""
    pj_dense, _ = _params("dense")
    pj, _ = _params(f"tag{tag}")
    _, ct = _cfgs(f"tag{tag}")
    checked = 0
    for path in (("layers", "attn", "wq"), ("layers", "attn", "wo"),
                 ("layers", "mlp", "w_down"), ("unembed", "w")):
        vals, want = pj_dense, pj
        for k in path:
            vals, want = vals[k], want[k]
        vals = np.array(vals)
        stacked = path[0] == "layers"
        for i in range(vals.shape[0] if stacked else 1):
            v = vals[i] if stacked else vals
            w = {k: np.asarray(a[i] if stacked else a)
                 for k, a in want.items()}
            got = T_M.pack_linear_weight(torch.from_numpy(v), ct)
            assert sorted(got) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(got[k].numpy(), w[k])
            table = T_gse.extract_shared_exponents_jnp(torch.from_numpy(v), 8)
            np.testing.assert_array_equal(table.numpy(), w["table"])
            checked += 1
    assert checked == 2 * 3 + 1


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_weight_decode_is_bitwise(tag, dtype):
    cj, ct = _cfgs(f"tag{tag}", dtype)
    pj, pt = _params(f"tag{tag}")
    wj = jax.tree.map(lambda a: a[1], pj["layers"]["mlp"]["w_up"])
    wt = tree_map(lambda a: a[1], pt["layers"]["mlp"]["w_up"])
    want = J_M.take_weight(wj, cj, cj.compute_dtype, (None, None))
    got = T_M.take_weight(wt, ct, ct.compute_dtype)
    assert got.dtype == ct.compute_dtype
    np.testing.assert_array_equal(
        got.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy(),
        np.asarray(want).view(np.int16 if dtype == "bfloat16" else np.int32))


def test_table_scales_are_built_once_per_stored_table():
    """``linear``'s scale tables: make_scales at bias 127 for every layer's
    view of a stacked table, built once and rebuilt after a write."""
    from repro_torch.kernels.ref import make_scales
    rng = np.random.default_rng(5)
    stacked = torch.from_numpy(rng.integers(100, 130, size=(3, 8),
                                            dtype=np.int32))
    first = [T_M.table_scales(stacked[i], 11) for i in range(3)]
    for i, got in enumerate(first):
        assert torch.equal(got, make_scales(stacked[i], 11, bias=127))
        assert T_M.table_scales(stacked[i], 11).data_ptr() == got.data_ptr()
    assert torch.equal(T_M.table_scales(stacked, 11),
                       make_scales(stacked, 11, bias=127))
    assert torch.equal(T_M.table_scales(stacked[1], 27),
                       make_scales(stacked[1], 27, bias=127))
    stacked[2, 0] += 1
    assert torch.equal(T_M.table_scales(stacked[2], 11),
                       make_scales(stacked[2], 11, bias=127))
    odd = stacked.t()[1]  # a strided view: built directly, not cached
    assert torch.equal(T_M.table_scales(odd, 11),
                       make_scales(odd, 11, bias=127))


# --- forward, prefill, decode ----------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_f32(variant):
    hj, ht = _runs(variant, "float32")["forward"]
    assert ht.shape == hj.shape and ht.dtype == torch.float32
    _close(ht, hj, F32_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_f32(variant):
    lj, lt = _runs(variant, "float32")["prefill"]
    _, ct = _cfgs(variant)
    assert lt.shape == (B, ct.vocab_size) and lt.dtype == torch.float32
    _close(lt, lj, F32_TOL)
    np.testing.assert_array_equal(torch.argmax(lt, -1).numpy(),
                                  np.asarray(jnp.argmax(lj, -1)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_steps_f32(variant):
    for ldj, ldt in _runs(variant, "float32")["decode"]:
        _close(ldt, ldj, F32_TOL)
        np.testing.assert_array_equal(torch.argmax(ldt, -1).numpy(),
                                      np.asarray(jnp.argmax(ldj, -1)))


@pytest.mark.parametrize("variant", ["dense", "tag2"])
def test_forward_prefill_decode_bf16(variant):
    runs = _runs(variant, "bfloat16")
    hj, ht = runs["forward"]
    assert ht.dtype == torch.bfloat16
    _close(ht, hj, BF16_TOL)
    _close(runs["prefill"][1], runs["prefill"][0], BF16_TOL)
    for ldj, ldt in runs["decode"]:
        _close(ldt, ldj, BF16_TOL)


@pytest.mark.parametrize("variant", ["dense", "tag2"])
def test_prefill_fills_the_cache_the_decode_path_fills(variant):
    """prefill(state=) leaves the caches the teacher-forced decode steps
    leave, so decoding goes on from either the same way."""
    _, ct = _cfgs(variant)
    _, pt = _params(variant)
    toks = torch.from_numpy(_tokens(2, (B, S + 1), ct.vocab_size))
    st_p = T_T.decode_state_init(ct, B, S + 1, device=CPU)
    last = T_steps.make_prefill_step(ct)(pt, toks[:, :S], state=st_p)
    st_d = T_T.decode_state_init(ct, B, S + 1, device=CPU)
    for pos in range(S):
        ld, st_d = T_T.decode_step(ct, pt, st_d, toks[:, pos], pos)
    torch.testing.assert_close(last, ld, **F32_TOL)
    for k in ("k", "v"):
        torch.testing.assert_close(st_p["layers"][k], st_d["layers"][k],
                                   **F32_TOL)
    nxt_p, _ = T_T.decode_step(ct, pt, st_p, toks[:, S], S)
    nxt_d, _ = T_T.decode_step(ct, pt, st_d, toks[:, S], S)
    torch.testing.assert_close(nxt_p, nxt_d, **F32_TOL)


@pytest.mark.parametrize("arch,gse", [("granite_3_2b", False),
                                      ("granite_34b", True),
                                      ("qwen15_32b", True)])
def test_other_dense_configs_f32(arch, gse):
    """granite_3_2b (GQA, dense weights), granite_34b (MQA) and qwen15_32b
    (MHA with QKV bias, given random values here; both under gse_serve tag
    2) at their smoke sizes: prefill and two decode steps at f32."""
    kw = dict(compute_dtype=None, gse_serve=gse, gse_tag=2)
    cj = dataclasses.replace(J_configs.get_config(arch, smoke=True),
                             **dict(kw, compute_dtype=jnp.float32))
    ct = dataclasses.replace(T_configs.get_config(arch, smoke=True),
                             **dict(kw, compute_dtype=torch.float32))
    pj, _ = J_T.init_params(cj, jax.random.key(3))
    if cj.qkv_bias:
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv"):
            b = pj["layers"]["attn"][name]
            pj["layers"]["attn"][name] = jnp.asarray(
                rng.normal(size=b.shape).astype(np.float32) / 4)
    pt = convert.params_from_repro(jax.tree.map(np.asarray, pj), CPU)
    toks = _tokens(4, (B, S + 2), cj.vocab_size)
    lj = [jax.jit(J_steps.make_prefill_step(cj))(pj, toks[:, :S])]
    st = T_T.decode_state_init(ct, B, S + 2, device=CPU)
    lt = [T_steps.make_prefill_step(ct)(pt, torch.from_numpy(toks[:, :S]),
                                        state=st)]
    sj = J_T.decode_state_init(cj, B, S + 2)
    step = jax.jit(lambda p, s, t, pos: J_T.decode_step(cj, p, s, t, pos))
    for pos in range(S):  # the reference fills its cache step by step
        _, sj = step(pj, sj, toks[:, pos], jnp.asarray(pos, jnp.int32))
    for pos in (S, S + 1):
        l, sj = step(pj, sj, toks[:, pos], jnp.asarray(pos, jnp.int32))
        lj.append(l)
        l, st = T_T.decode_step(ct, pt, st, torch.from_numpy(toks[:, pos]),
                                pos)
        lt.append(l)
    for a, b in zip(lj, lt):
        _close(b, a, F32_TOL)
        np.testing.assert_array_equal(torch.argmax(b, -1).numpy(),
                                      np.asarray(jnp.argmax(a, -1)))


# --- quantize / dequantize ------------------------------------------------

@pytest.fixture(scope="module")
def quantized():
    pj, pt = _params("dense")
    qj = J_Q.quantize_tree(pj, k=8, min_size=2048)
    qt = T_Q.quantize_tree(pt, k=8, min_size=2048)
    return qj, qt


def _packed_leaves(tree, cls):
    return [x for x in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, cls))]


def test_quantize_tree_is_bitwise(quantized):
    qj, qt = quantized
    lj = _packed_leaves(qj, J_gse.GSEPacked)
    lt = tree_leaves(qt, is_leaf=lambda x: isinstance(x, T_gse.GSEPacked))
    assert len(lj) == len(lt)
    n_packed = 0
    for a, b in zip(lj, lt):
        if isinstance(a, J_gse.GSEPacked):
            assert isinstance(b, T_gse.GSEPacked)
            assert (a.ei_bit, a.frac_bits) == (b.ei_bit, b.frac_bits)
            for f in ("table", "head", "tail1", "tail2"):
                np.testing.assert_array_equal(getattr(b, f).numpy(),
                                              np.asarray(getattr(a, f)))
            n_packed += 1
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert n_packed >= 9  # embed, unembed and the stacked weights


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_tree_bytes_is_exact(quantized, tag):
    qj, qt = quantized
    assert T_Q.tree_bytes(qt, tag) == J_Q.tree_bytes(qj, tag)
    _, pt = _params("tag2")
    pj, _ = _params("tag2")
    assert T_Q.tree_bytes(pt, tag) == J_Q.tree_bytes(pj, tag)


@pytest.mark.parametrize("tag", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_tree_is_bitwise(quantized, tag, dtype):
    qj, qt = quantized
    jd, td = _DT[dtype]
    dj = J_Q.dequantize_tree(qj, tag=tag, dtype=jd)
    dt = T_Q.dequantize_tree(qt, tag=tag, dtype=td)
    view = (torch.int16, np.int16) if dtype == "bfloat16" else \
        (torch.int32, np.int32)
    for a, b in zip(jax.tree.leaves(dj), tree_leaves(dt)):
        if b.dtype == td:
            np.testing.assert_array_equal(b.view(view[0]).numpy(),
                                          np.asarray(a).view(view[1]))
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("tag", [1, 2, 3])
def test_gse_linear(tag):
    rng = np.random.default_rng(tag)
    w = rng.normal(size=(64, 128)) / 8
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    wj, wt = J_gse.pack(w, 8), T_gse.pack(w, 8, device=CPU)
    want = J_Q.gse_linear(jnp.asarray(x), wj, tag=tag, dtype=jnp.float32)
    got = T_Q.gse_linear(torch.from_numpy(x), wt, tag=tag,
                         dtype=torch.float32)
    assert got.shape == (3, 5, 128)
    _close(got, want, F32_TOL)
    want16 = J_Q.gse_linear(jnp.asarray(x), wj, tag=tag, dtype=jnp.bfloat16)
    got16 = T_Q.gse_linear(torch.from_numpy(x), wt, tag=tag,
                           dtype=torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    _close(got16, want16, BF16_TOL)


def test_params_from_repro_checks_dtypes():
    pj, _ = _params("tag2")
    tree = jax.tree.map(np.asarray, pj)
    tree["unembed"]["w"]["head"] = tree["unembed"]["w"]["head"].astype(
        np.int32)
    with pytest.raises(TypeError, match="head must be uint16"):
        convert.params_from_repro(tree, device=CPU)
    with pytest.raises(TypeError, match="floating"):
        convert.params_from_repro({"x": np.zeros(3, np.int64)}, device=CPU)
    bf = convert.params_from_repro({"x": np.asarray(jnp.ones(3,
                                                             jnp.bfloat16))},
                                   device=CPU)
    assert bf["x"].dtype == torch.bfloat16 and bf["x"].tolist() == [1.0] * 3


# --- the serve loop ---------------------------------------------------------

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


@pytest.mark.parametrize("gse_tag", [0, 1, 2, 3])
def test_serve_loop_gives_the_reference_tokens(gse_tag):
    cj = J_configs.get_config("qwen3_4b", smoke=True)
    ct = T_configs.get_config("qwen3_4b", smoke=True)
    pj, pt = _params("dense")
    if gse_tag:
        pj = J_Q.dequantize_tree(J_Q.quantize_tree(pj, k=8, min_size=2048),
                                 tag=gse_tag, dtype=jnp.bfloat16)
        pt = T_serve.gse_params(pt, gse_tag, log=lambda m: None)
    prompts = _tokens(7, (4, 12), cj.vocab_size)
    want = _reference_serve(cj, pj, jnp.asarray(prompts), 8)
    got = T_serve.serve(ct, pt, torch.from_numpy(prompts), 8,
                        log=lambda m: None)
    assert got == want


def test_serve_cli_runs_on_the_cpu_and_can_pick_the_full_config(monkeypatch):
    tokens = T_serve.main(["--device", CPU, "--gse-tag", "2", "--gen", "2",
                           "--prompt-len", "3", "--batch", "2"])
    assert len(tokens) == 2 and all(len(t) == 2 for t in tokens)
    seen = []

    def fake(arch, smoke=False):
        seen.append(smoke)
        raise RuntimeError("stop")

    monkeypatch.setattr(T_serve.configs, "get_config", fake)
    for argv, want in ((["--no-smoke"], False), ([], True)):
        with pytest.raises(RuntimeError, match="stop"):
            T_serve.main(argv + ["--device", CPU])
        assert seen[-1] is want
