"""The port's moe family (qwen3_moe_235b_a22b, grok1_314b; ``models/moe.py``)
against the JAX reference at the smoke sizes (2 layers, d 64, 4 experts
top-2).

The reference's params (``init_params`` at ``jax.random.key(0)``, the
stacked ``(L, ...)`` layout, experts ``(L, E, d, ff)``) are carried over
with ``convert.params_from_repro``; both sides get the same numpy inputs.
On the CPU every kernel wrapper runs its plain version.  Tolerances:

* Exact: ``_capacity``; the expert ids, the kept mask and the slots of
  all three dispatches (the reference's routing and sort, re-run in JAX
  on its own router product, against the port's ``record_routes``); the
  combine's fold (``_fold_sorted``) against ``zeros.at[stok].add`` and
  the grouped sum over k, given the same contributions; ``quantize_tree``
  on the stacked expert leaves.
* ``moe_apply``'s y: rtol 1e-5 / atol 2e-6 at f32 (the expert products
  and the router's sums add in other orders: up to 8e-7 measured); rtol /
  atol 0.02 at bf16 (a bf16 ulp at the outputs' magnitude; the dense
  dispatch's ``etd,te->td`` measured 0.016).  The aux loss within rtol
  1e-5 (f32) and 1e-3 (bf16).
* Forward, prefill and decode: rtol/atol 1e-5 at f32, BF16_TOL (rtol
  0.02, atol 0.075) at bf16, as ``test_torch_lm.py``.
* The serve CLI's tokens equal the reference serve loop's on the same
  params, at ``--gse-tag`` 0 and 2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_configs  # noqa: E402
from repro.core import gse as J_gse  # noqa: E402
from repro.models import moe as J_MOE  # noqa: E402
from repro.models import stepfns as J_steps  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.quant import gse_tensor as J_Q  # noqa: E402

from repro_torch import configs as T_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.kernels import flash_attn as T_F  # noqa: E402
from repro_torch.kernels import gse_matmul as T_E  # noqa: E402
from repro_torch.launch import serve as T_serve  # noqa: E402
from repro_torch.models import moe as T_MOE  # noqa: E402
from repro_torch.models import stepfns as T_steps  # noqa: E402
from repro_torch.models import transformer as T_T  # noqa: E402
from repro_torch.quant import gse_tensor as T_Q  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"
B = 2
ARCHS = ("qwen3_moe_235b_a22b", "grok1_314b")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.02, atol=0.075)
Y_TOL = {"float32": dict(rtol=1e-5, atol=2e-6),
         "bfloat16": dict(rtol=0.02, atol=0.02)}
AUX_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# A router near-tie at bf16: the k-th and (k + 1)-th probabilities closer
# than this (see test_forward_and_decode_against_the_reference).
NEAR_TIE = 0.005
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype="float32", **kw):
    jd, td = _DT[dtype]
    return (dataclasses.replace(J_configs.get_config(arch, smoke=True),
                                compute_dtype=jd, **kw),
            dataclasses.replace(T_configs.get_config(arch, smoke=True),
                                compute_dtype=td, **kw))


_PARAMS = {}


def _params(arch):
    """The reference's params at key 0 (jax) and the port's copy."""
    if arch not in _PARAMS:
        cj, _ = _cfgs(arch)
        pj, _ = J_T.init_params(cj, jax.random.key(0))
        _PARAMS[arch] = (pj, convert.params_from_repro(
            jax.tree.map(np.asarray, pj), device=CPU))
    return _PARAMS[arch]


def _layer0(arch):
    pj, pt = _params(arch)
    return (jax.tree.map(lambda a: a[0], pj["layers"]["moe"]),
            tree_map(lambda t: t[0], pt["layers"]["moe"]))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# --- configs and params -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
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
    assert ct.expert_ff == cj.expert_ff and ct.hd == cj.hd
    assert T_T._layer_kinds(ct) == J_T._layer_kinds(cj)
    assert arch in T_configs.PORTED


def test_aliases_resolve():
    assert T_configs.get_config("qwen3-moe-235b-a22b").name == \
        "qwen3_moe_235b_a22b"
    assert T_configs.get_config("grok-1-314b", smoke=True).name == \
        "grok1_smoke"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_stacked_layout(arch):
    """Same tree, shapes and dtypes as the reference's init: stacked
    ``(L, ...)`` leaves, experts ``(L, E, d, ff)``; the experts and the
    router stay dense under gse_serve, the attention linears are packed."""
    pj, pt = _params(arch)
    _, ct = _cfgs(arch)
    mine = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    lay = lambda tree: tree_map(  # noqa: E731
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), tree)
    assert lay(mine) == lay(pt)
    e, d, ff, n = ct.num_experts, ct.d_model, ct.expert_ff, ct.num_layers
    assert mine["layers"]["moe"]["w_gate"].shape == (n, e, d, ff)
    assert mine["layers"]["moe"]["w_down"].shape == (n, e, ff, d)
    assert "mlp" not in mine["layers"]
    cg = dataclasses.replace(ct, gse_serve=True)
    packed = T_T.init_params(cg, torch.Generator().manual_seed(0), device=CPU)
    pjg, _ = J_T.init_params(dataclasses.replace(_cfgs(arch)[0],
                                                 gse_serve=True),
                             jax.random.key(0))
    assert lay(packed) == lay(convert.params_from_repro(
        jax.tree.map(np.asarray, pjg), device=CPU))
    assert all(isinstance(v, torch.Tensor)
               for v in packed["layers"]["moe"].values())
    assert packed["layers"]["moe"]["w_up"].dtype == torch.float32
    assert "head" in packed["layers"]["attn"]["wq"]


@pytest.mark.parametrize("tokens", [1, 2, 4, 7, 20, 48, 64, 100, 2048])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0])
def test_capacity_is_the_reference(tokens, cf):
    for arch in ARCHS:
        for smoke in (True, False):
            cj = dataclasses.replace(J_configs.get_config(arch, smoke=smoke),
                                     capacity_factor=cf)
            ct = dataclasses.replace(T_configs.get_config(arch, smoke=smoke),
                                     capacity_factor=cf)
            assert T_MOE._capacity(ct, tokens) == J_MOE._capacity(cj, tokens)
    full = T_configs.get_config("qwen3_moe_235b_a22b")
    assert T_MOE._capacity(full, 2048) == 160
    assert T_MOE._capacity(full, 4) == 8


# --- routing, dispatch and combine ----------------------------------------

def _ref_route(router, xt, k):
    """The reference's routing (``moe.py:74-77``) on ``xt``."""
    logits = jnp.dot(xt.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    return probs, gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True), \
        expert_ids


def _ref_sort(expert_ids, e, k, cap):
    """The reference's sort dispatch (``moe.py:101-117``): (order, keep,
    slot) of the flattened (token, expert) pairs."""
    flat = expert_ids.reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    counts = jnp.bincount(se, length=e)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(flat.shape[0]) - starts[se]
    keep = pos < cap
    return order, keep, jnp.where(keep, se * cap + pos, e * cap)


def _ref_grouped_sort(expert_ids, e, k, cap):
    """The reference's grouped dispatch (``moe.py:178-204``) per group."""
    g = expert_ids.shape[0]
    fe = expert_ids.reshape(g, -1)
    order = jnp.argsort(fe, axis=1)
    se = jnp.take_along_axis(fe, order, axis=1)
    bounds = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(e + 1)))(
        se)
    starts = bounds[:, :-1]
    pos = jnp.arange(fe.shape[1])[None, :] - jnp.take_along_axis(starts, se,
                                                                 axis=1)
    keep = pos < cap
    return order, keep, jnp.where(keep, se * cap + pos, e * cap)


def _groups(cfg, t):
    g = min(cfg.moe_groups, t)
    while t % g:
        g -= 1
    return g


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dispatch", ["sort", "dense", "grouped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_apply_against_the_reference(arch, dispatch, dtype, cf):
    """Routing, kept mask and slots exact; y and aux within Y_TOL and
    AUX_RTOL.  capacity_factor 0.25 forces drops (the spill row)."""
    cj, ct = _cfgs(arch, dtype, capacity_factor=cf, moe_groups=4)
    pj, pt = _layer0(arch)
    jd, td = _DT[dtype]
    x = np.random.default_rng(7).normal(size=(B, 24, 64)).astype(np.float32)
    xj = jnp.asarray(x).astype(jd)
    yj, aj = jax.jit(lambda p, x: J_MOE.moe_apply(p, x, cj, dispatch))(pj, xj)
    with T_MOE.record_routes() as rec:
        yt, at = T_MOE.moe_apply(pt, torch.from_numpy(x).to(td), ct,
                                 dispatch)
    assert yt.dtype == td and yt.shape == (B, 24, 64)
    _close(yt, yj.astype(jnp.float32), Y_TOL[dtype])
    np.testing.assert_allclose(float(at), float(aj), rtol=AUX_RTOL[dtype])
    (r,) = rec
    assert r["dispatch"] == dispatch
    e, k, t = ct.num_experts, ct.experts_per_token, B * 24
    if dispatch == "grouped":
        g = _groups(ct, t)
        _, _, ids = _ref_route(pj["router"], xj.reshape(g, t // g, 64), k)
        np.testing.assert_array_equal(r["expert_ids"].numpy(),
                                      np.asarray(ids))
        _, keep, slot = _ref_grouped_sort(ids, e, k,
                                          J_MOE._capacity(cj, t // g))
    else:
        _, _, ids = _ref_route(pj["router"], xj.reshape(t, 64), k)
        np.testing.assert_array_equal(r["expert_ids"].numpy(),
                                      np.asarray(ids))
        if dispatch == "dense":
            assert r["keep"] is None
            return
        _, keep, slot = _ref_sort(ids, e, k, J_MOE._capacity(cj, t))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(keep))
    np.testing.assert_array_equal(r["slot"].numpy(), np.asarray(slot))
    if cf < 1:  # the forced drops reach the spill row
        assert int((~r["keep"]).sum()) > 0
        assert int((r["slot"] == e * J_MOE._capacity(
            cj, t // (_groups(ct, t) if dispatch == "grouped" else 1))
        ).sum()) == int((~r["keep"]).sum())


@pytest.mark.parametrize("t, k, e, d", [(48, 2, 4, 64), (33, 8, 16, 96),
                                        (512, 8, 128, 40), (7, 2, 8, 3)])
def test_combine_fold_is_bitwise_the_scatter_add(t, k, e, d):
    """``_fold_sorted`` against the reference's ``zeros.at[stok].add`` and
    the grouped combine's fold against its ``jnp.sum`` over k, on the same
    contributions (wide magnitudes, so any other order shows)."""
    rng = np.random.default_rng(t + k)
    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    contrib = (rng.normal(size=(t * k, d))
               * np.exp(3 * rng.normal(size=(t * k, d)))).astype(np.float32)
    order = np.argsort(ids.reshape(-1), kind="stable")
    stok = np.repeat(np.arange(t), k)[order]
    want = jax.jit(lambda c, s: jnp.zeros((t, d), jnp.float32).at[s].add(c))(
        contrib, stok)
    got = T_MOE._fold_sorted(torch.from_numpy(contrib),
                             torch.from_numpy(order), t, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The grouped combine: the un-sorted (G, Tg * k, d) sum over k.
    g = 1 if t % 3 else 3
    parts = contrib.reshape(g, t // g, k, d)
    want = jax.jit(lambda c: jnp.sum(c, axis=2))(parts)
    y = torch.zeros(g, t // g, d)
    for j in range(k):
        y = y + torch.from_numpy(parts)[:, :, j]
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))


def test_grouped_combine_matches_the_sort_dispatch_without_drops():
    """With one group and no drops the grouped and sort dispatches send the
    same pairs to the same experts: their outputs agree within f32 ulps."""
    _, ct = _cfgs("grok1_314b", capacity_factor=8.0, moe_groups=1)
    _, pt = _layer0("grok1_314b")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, 10, 64)).astype(np.float32))
    ys, aux_s = T_MOE.moe_apply(pt, x, ct, "sort")
    yg, aux_g = T_MOE.moe_apply(pt, x, ct, "grouped")
    torch.testing.assert_close(ys, yg, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(aux_s, aux_g)
    with pytest.raises(ValueError, match="dispatch"):
        T_MOE.moe_apply(pt, x, ct, "scatter")


# --- forward, prefill and decode --------------------------------------------

def _reference_decode(cj, pj, toks, max_len, state=None, start=0):
    step = jax.jit(lambda p, s, t, pos: J_T.decode_step(cj, p, s, t, pos))
    sj = J_T.decode_state_init(cj, toks.shape[0], max_len) if state is None \
        else state
    out = []
    for pos in range(start, toks.shape[1]):
        lj, sj = step(pj, sj, toks[:, pos], jnp.asarray(pos, jnp.int32))
        out.append(lj)
    return out, sj


def _prefill_decode(ct, pt, toks, prompt):
    total = toks.shape[1]
    st = T_T.decode_state_init(ct, toks.shape[0], total, device=CPU)
    tt = torch.from_numpy(toks)
    out = [T_steps.make_prefill_step(ct)(pt, tt[:, :prompt], state=st)]
    after = tree_map(lambda t: t.clone(), st)
    for pos in range(prompt, total):
        lt, st = T_T.decode_step(ct, pt, st, tt[:, pos], pos)
        out.append(lt)
    return out, st, after


def _first_near_tie(records, k, batch, positions):
    """Per request, the first position at which some layer routed a token
    whose k-th and (k + 1)-th router probabilities lie within NEAR_TIE
    (``positions`` of them, or ``positions`` where none did).  ``records``:
    record_routes' entries of a forward (one per layer, T = B * S rows) or
    of a decode loop (one per layer and step, B rows)."""
    first = np.full(batch, positions)
    for i, r in enumerate(records):
        top = torch.sort(r["probs"], dim=-1, descending=True).values
        near = (top[:, k - 1] - top[:, k] < NEAR_TIE).numpy()
        if near.shape[0] == batch:      # a decode step: layers in order
            at = np.full(batch, i // (len(records) // positions))
        else:                           # a forward: (B, S) rows
            near = near.reshape(batch, positions)
            at, near = np.argmax(near, axis=1), near.any(axis=1)
        first = np.where(near, np.minimum(first, at), first)
    return first


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_decode_against_the_reference(arch, dtype):
    """forward's hidden states and aux, and teacher-forced decode_step over
    every position from an empty cache.

    At bf16 the port's attention keeps f32 where the reference rounds to
    bf16, so a router input moves by bf16 ulps, and a token whose k-th and
    (k + 1)-th probabilities lie within NEAR_TIE may pick another expert
    (one did: layer 1 of qwen3_moe's forward, margin 0.0014).  There a
    request is held to the reference up to its first such position (which
    its later positions' attention reads); at least half the positions are
    held.  f32 holds every position."""
    cj, ct = _cfgs(arch, dtype)
    pj, pt = _params(arch)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    bf16 = dtype == "bfloat16"
    s = 12
    toks = _tokens(1, (B, s), cj.vocab_size)
    hj, aj = jax.jit(lambda p, t: J_T.forward(cj, p, t))(pj, toks)
    with T_MOE.record_routes() as rec:
        ht, at = T_T.forward(ct, pt, torch.from_numpy(toks))
    assert ht.shape == hj.shape and ht.dtype == _DT[dtype][1]
    k = ct.experts_per_token
    first = _first_near_tie(rec, k, B, s) if bf16 else np.full(B, s)
    assert first.sum() >= B * s // 2, first
    for b in range(B):
        _close(ht[b, :first[b]], hj[b, :first[b]].astype(jnp.float32), tol)
    # A flipped expert moves two experts' counts by 1 / T in the aux loss.
    np.testing.assert_allclose(float(at), float(aj), rtol=AUX_RTOL[dtype]
                               if (first == s).all() else 0.01)
    want, _ = _reference_decode(cj, pj, toks, s)
    st = T_T.decode_state_init(ct, B, s, device=CPU)
    got = []
    with T_MOE.record_routes() as rec:
        for pos in range(s):
            lt, st = T_T.decode_step(ct, pt, st,
                                     torch.from_numpy(toks[:, pos]), pos)
            got.append(lt)
    first = _first_near_tie(rec, k, B, s) if bf16 else np.full(B, s)
    assert first.sum() >= B * s // 2, first
    for pos in range(s):
        held = pos < first
        _close(got[pos][held], np.asarray(want[pos])[held], tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_prefill_then_decode(arch, cf):
    """prefill(state=) then decode_step.  Without drops (capacity_factor
    8) it equals a teacher-forced decode over the same tokens, the port's
    and the reference's.  With the default capacity the 20-token prefill
    drops pairs a one-token-at-a-time decode keeps (capacity is per call):
    the prefill logits are held to the reference's make_prefill_step and
    the steps to its decode_step run from the port's state after the
    prefill."""
    cj, ct = _cfgs(arch, capacity_factor=cf)
    pj, pt = _params(arch)
    prompt, steps = 20, 4
    toks = _tokens(2, (B, prompt + steps), cj.vocab_size)
    with T_MOE.record_routes() as rec:
        got, st, after = _prefill_decode(ct, pt, toks, prompt)
    dropped = sum(int((~r["keep"]).sum()) for r in rec[:ct.num_layers])
    assert (dropped > 0) == (cf < 2), dropped
    _close(got[0], jax.jit(J_steps.make_prefill_step(cj))(
        pj, toks[:, :prompt]), F32_TOL)
    if cf > 2:
        want, _ = _reference_decode(cj, pj, toks, prompt + steps)
        st2 = T_T.decode_state_init(ct, B, prompt + steps, device=CPU)
        mine = []
        for pos in range(prompt + steps):
            lt, st2 = T_T.decode_step(ct, pt, st2,
                                      torch.from_numpy(toks[:, pos]), pos)
            mine.append(lt)
        for g, w, m in zip(got, want[prompt - 1:], mine[prompt - 1:]):
            _close(g, w, F32_TOL)
            _close(g, m.numpy(), F32_TOL)
            assert torch.equal(g.argmax(-1), m.argmax(-1))
        for name in ("k", "v"):
            _close(st["layers"][name], st2["layers"][name].numpy(), F32_TOL)
        return
    state = {"layers": {k: jnp.asarray(v.numpy())
                        for k, v in after["layers"].items()}}
    want, _ = _reference_decode(cj, pj, toks, prompt + steps, state=state,
                                start=prompt)
    for g, w in zip(got[1:], want):
        _close(g, w, F32_TOL)
        np.testing.assert_array_equal(torch.argmax(g, -1).numpy(),
                                      np.asarray(jnp.argmax(w, -1)))


@pytest.mark.parametrize("dispatch", ["dense", "grouped"])
def test_forward_under_the_other_dispatches(dispatch):
    cj, ct = _cfgs("qwen3_moe_235b_a22b", moe_dispatch=dispatch,
                   moe_groups=3)
    pj, pt = _params("qwen3_moe_235b_a22b")
    toks = _tokens(5, (B, 9), cj.vocab_size)
    hj, aj = jax.jit(lambda p, t: J_T.forward(cj, p, t))(pj, toks)
    ht, at = T_T.forward(ct, pt, torch.from_numpy(toks))
    _close(ht, hj, F32_TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


# --- quantize and serve -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_on_the_stacked_experts(arch):
    """The 4-D expert stacks pack as the reference's (one table per stacked
    leaf) and decode with kernel D's plain version as its decode."""
    pj, pt = _params(arch)
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
    wg = qt["layers"]["moe"]["w_gate"]
    assert ist(wg) and tuple(wg.head.shape) == tuple(
        pt["layers"]["moe"]["w_gate"].shape)
    assert T_Q.tree_bytes(qt, 2) == J_Q.tree_bytes(qj, 2)
    for tag in (1, 2):
        dj = J_Q.dequantize_tree(qj, tag=tag, dtype=jnp.bfloat16)
        dt = T_Q.dequantize_tree(qt, tag=tag, dtype=torch.bfloat16)
        a = np.asarray(dj["layers"]["moe"]["w_down"]).view(np.int16)
        b = dt["layers"]["moe"]["w_down"].view(torch.int16).numpy()
        np.testing.assert_array_equal(b, a)


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("gse_tag", [0, 2])
def test_serve_cli_gives_the_reference_tokens(arch, gse_tag):
    """``main(["--arch", arch, "--device", "cpu"])`` (bf16, batch 4,
    12-token prompts, 8 new tokens) against the reference's serve loop on
    the same params and prompts."""
    argv = ["--arch", arch, "--device", CPU]
    if gse_tag:
        argv += ["--gse-tag", str(gse_tag)]
    got = T_serve.main(argv)
    cj = J_configs.get_config(arch, smoke=True)
    ct = T_configs.get_config(arch, smoke=True)
    pt = T_T.init_params(ct, torch.Generator().manual_seed(0), device=CPU)
    pj = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), pt))
    if gse_tag:
        pj = J_Q.dequantize_tree(J_Q.quantize_tree(pj, k=8, min_size=2048),
                                 tag=gse_tag, dtype=jnp.bfloat16)
    prompts = torch.randint(0, ct.vocab_size, (4, 12),
                            generator=torch.Generator().manual_seed(1))
    want = _reference_serve(cj, pj, jnp.asarray(prompts.numpy()), 8)
    assert len(got) == 8 and got == want


def test_moe_entry_points_default_to_the_card_and_run_on_the_cpu():
    """The entry points default to the card; asked for the CPU, the moe
    path takes the plain versions of E and F (no launch)."""
    import inspect

    for fn in (T_T.init_params, T_T.decode_state_init):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert T_serve.parser().parse_args([]).device == "cuda"
    _, ct = _cfgs("qwen3_moe_235b_a22b", gse_serve=True)
    params = T_T.init_params(ct, torch.Generator().manual_seed(1),
                             device=CPU)
    T_E.reset_launch_counts()
    T_F.reset_launch_counts()
    st = T_T.decode_state_init(ct, 1, 12, device=CPU)
    toks = torch.zeros(1, 10, dtype=torch.int64)
    logits = T_steps.make_prefill_step(ct)(params, toks, state=st)
    logits, st = T_T.decode_step(ct, params, st, logits.argmax(-1), 10)
    assert logits.shape == (1, ct.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert T_F.flash_attention_gqa.launches == 0
    assert T_E.gse_matmul_dense.launches == 0


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_replay(dtype):
    """``chip_smoke.replay_routes`` (how phase 28 holds bf16 at every
    position): replaying a forward's own expert ids gives its hidden
    states bit for bit with every gap 0; moving one token's last expert
    to one it did not pick routes it there and reports that token with a
    positive gap (its router logits' difference); forced ids left over or
    missing raise.  ``encode_route_ids`` / ``decode_route_ids`` round
    trip a prefill and decode steps' ids."""
    cs = _chip_smoke()
    _, ct = _cfgs("qwen3_moe_235b_a22b", dtype)
    _, pt = _params("qwen3_moe_235b_a22b")
    toks = torch.from_numpy(_tokens(5, (B, 6), ct.vocab_size))
    with T_MOE.record_routes() as rec:
        h, _ = T_T.forward(ct, pt, toks)
    ids = [r["expert_ids"].numpy() for r in rec]
    with cs.replay_routes(ids) as gaps:
        h2, _ = T_T.forward(ct, pt, toks)
    assert torch.equal(h, h2)
    assert gaps == [(0.0, 0)] * ct.num_layers
    moved = [i.copy() for i in ids]
    row = moved[0][3]
    row[-1] = next(e for e in range(ct.num_experts) if e not in row)
    with cs.replay_routes(moved) as gaps, T_MOE.record_routes() as rec2:
        h3, _ = T_T.forward(ct, pt, toks)
    assert gaps[0][1] == 1 and gaps[0][0] > 0
    assert np.array_equal(rec2[0]["expert_ids"].numpy(), moved[0])
    assert not torch.equal(h3[0, 3], h[0, 3])
    assert torch.equal(h3[0, :3], h[0, :3])     # causal: earlier tokens
    with pytest.raises(AssertionError, match="more moe_apply calls"):
        with cs.replay_routes(ids[:-1]):
            T_T.forward(ct, pt, toks)
    with pytest.raises(AssertionError, match="were not used"):
        with cs.replay_routes(ids + ids[:1]):
            T_T.forward(ct, pt, toks)
    k, layers, prompt, steps = ct.experts_per_token, ct.num_layers, 6, 2
    calls = ([np.arange(B * prompt * k).reshape(-1, k) % ct.num_experts]
             * layers + [np.full((B, k), 3)] * (layers * steps))
    got = cs.decode_route_ids(cs.encode_route_ids(calls), B, prompt, steps,
                              layers, k)
    assert len(got) == len(calls)
    assert all(np.array_equal(a, b) for a, b in zip(got, calls))
    with pytest.raises(ValueError):
        cs.decode_route_ids(cs.encode_route_ids(calls[:-1]), B, prompt,
                            steps, layers, k)
