"""The port's train path against the JAX reference on the CPU: the train
step (``stepfns.make_train_step``: ``lm_loss``, ``make_loss_fn``, AdamW),
remat, the train CLI's resume, the guards on the kernels without a
backward, ``gse_fake_quant`` and the gradient compression.

The reference's params (``init_params`` at ``jax.random.key(0)``) are
carried over with ``convert.params_from_repro``, the optimizer's moments
start at zero on both sides, and both take the reference pipeline's
batches.  On the CPU kernel F runs its plain version through the port's
autograd ``Function``.

Tolerances (stated per check):

* f32 (qwen3_4b, granite_3_2b, internvl2_2b, seamless_m4t_large_v2 smoke
  configs, 3 steps of the jitted reference ``make_train_step``): loss
  within 1e-5 relative, and grad_norm within 1e-5 of the norm of the
  reference's gradients summed in f64 (the port's ``optim.global_norm``
  sums each leaf's squares in f64; the reference's metric chains an f32
  ``vdot`` per leaf, one sequential sum on XLA's CPU build, which is
  within 1e-4 here and 6% low at full width); every gradient leaf's
  relative L2 error (against the reference's ``jax.grad`` on the same
  params) at most 1e-5;
  the params after each step within 2 lr_t per step taken in max-norm
  (Adam's step of a gradient near zero may take either sign) plus 1e-6.
* bf16 (the configs' default compute dtype): loss and grad_norm within
  rtol 0.02 (``BF16_TOL``'s rtol), the params within 2 lr_t per step plus
  0.02 times their magnitude.
* Bitwise: remat on against off (the gradients and the step), a resumed
  CLI run's final checkpoint against an uninterrupted run's
  (``tree_crc32``), ``gse_fake_quant``'s forward and ``compress``'s
  ``g_hat`` and ``err`` against the reference's.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J_configs  # noqa: E402
from repro.core import gse as J_gse  # noqa: E402
from repro.data.pipeline import DataConfig as J_DataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as J_Pipeline  # noqa: E402
from repro.distributed import compress as J_compress  # noqa: E402
from repro.models import stepfns as J_steps  # noqa: E402
from repro.models import transformer as J_T  # noqa: E402
from repro.optim import AdamW as J_AdamW  # noqa: E402

from repro_torch import configs as T_configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import gse as T_gse  # noqa: E402
from repro_torch.distributed import compress as T_compress  # noqa: E402
from repro_torch.models import stepfns as T_steps  # noqa: E402
from repro_torch.optim import AdamW as T_AdamW  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
B, S, STEPS = 2, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
F32_REL = 1e-5
BF16_RTOL = 0.02
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


def _batches(cj, steps=STEPS):
    dcfg = J_DataConfig(
        vocab_size=cj.vocab_size, seq_len=S, global_batch=B, seed=0,
        num_prefix_tokens=(cj.num_prefix_tokens if cj.family == "vlm"
                           else 0),
        enc_len=S if cj.family == "encdec" else 0, d_model=cj.d_model)
    pipe = J_Pipeline(dcfg)
    return [pipe.batch_at(i) for i in range(steps)]


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _flat(tree_j, tree_t):
    """Matching (path, jax leaf, torch leaf) of two param trees."""
    out = []

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            out.append((path, a, b))

    walk(tree_j, tree_t, "")
    return out


def _port_grads(ct, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, _ = T_steps.make_loss_fn(ct)(params, batch)
        grads = torch.autograd.grad(total, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


_RUNS = {}


def _train_both(arch, dtype="float32"):
    """STEPS train steps on both sides from the same params and batches:
    per step the metrics, the gradients (before the step) and the params
    after it.  Cached."""
    key = (arch, dtype)
    if key in _RUNS:
        return _RUNS[key]
    cj, ct = _cfgs(arch, dtype)
    pj, _ = J_T.init_params(cj, jax.random.key(0))
    pt = convert.params_from_repro(jax.tree.map(np.asarray, pj), device=CPU)
    oj, ot = J_AdamW(**OPT), T_AdamW(**OPT)
    sj = J_steps.TrainState(params=pj, opt_state=oj.init(pj),
                            step=jnp.zeros((), jnp.int32))
    st = T_steps.TrainState(pt, ot.init(pt), torch.zeros((),
                                                         dtype=torch.int32))
    step_j = jax.jit(J_steps.make_train_step(cj, oj))
    grad_j = jax.jit(jax.grad(lambda p, b: J_steps.make_loss_fn(cj)(p, b)[0]))
    step_t = T_steps.make_train_step(ct, ot)
    rows = []
    for batch in _batches(cj):
        bt = _to_torch(batch)
        gj = grad_j(sj.params, batch)
        gt = _port_grads(ct, st.params, bt)
        sj, mj = step_j(sj, batch)
        st, mt = step_t(st, bt)
        gnorm64 = float(np.sqrt(sum(np.sum(np.square(np.asarray(
            g, np.float64))) for g in jax.tree.leaves(gj))))
        rows.append(dict(
            metrics=({k: float(v) for k, v in mj.items()},
                     {k: float(v) for k, v in mt.items()}),
            gnorm64=gnorm64,
            grads=_flat(jax.tree.map(np.asarray, gj),
                        tree_map(lambda t: t.clone(), gt)),
            params=_flat(jax.tree.map(np.asarray, sj.params),
                         tree_map(lambda t: t.clone(), st.params)),
            lr=float(oj.schedule(sj.step - 1))))
    assert int(st.step) == int(sj.step) == STEPS
    _RUNS[key] = rows
    return rows


TRAIN_ARCHS = ("qwen3_4b", "granite_3_2b", "internvl2_2b",
               "seamless_m4t_large_v2")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_f32_train_steps_match_the_reference(arch):
    rows = _train_both(arch)
    budget = 0.0
    for i, row in enumerate(rows):
        mj, mt = row["metrics"]
        for k in ("loss", "total_loss"):
            assert abs(mt[k] - mj[k]) <= F32_REL * abs(mj[k]), (i, k, mt, mj)
        # grad_norm: the norm of the reference's gradients summed in f64,
        # as the port sums; the reference's own metric chains an f32 vdot
        # per leaf (XLA's CPU dot, one sequential sum), within 1e-4 here.
        want = row["gnorm64"]
        assert abs(mt["grad_norm"] - want) <= F32_REL * want, (i, mt, want)
        assert abs(mj["grad_norm"] - want) <= 1e-4 * want, (i, mj, want)
        for path, g_j, g_t in row["grads"]:
            err = np.linalg.norm(_np(g_t) - g_j) / max(np.linalg.norm(g_j),
                                                       1e-30)
            assert err <= F32_REL, (i, path, err)
        budget += 2 * row["lr"]
        for path, p_j, p_t in row["params"]:
            err = np.abs(_np(p_t) - p_j).max()
            assert err <= budget + 1e-6, (i, path, err, budget)


@pytest.mark.parametrize("arch", ("qwen3_4b", "internvl2_2b"))
def test_bf16_train_steps_match_the_reference(arch):
    rows = _train_both(arch, "bfloat16")
    budget = 0.0
    for i, row in enumerate(rows):
        mj, mt = row["metrics"]
        for k in ("loss", "grad_norm"):
            assert abs(mt[k] - mj[k]) <= BF16_RTOL * abs(mj[k]), (i, k)
        budget += 2 * row["lr"]
        for path, p_j, p_t in row["params"]:
            err = np.abs(_np(p_t) - p_j)
            assert np.all(err <= budget + BF16_RTOL * np.abs(p_j)), (i, path)


def test_lm_loss_chunks_add_in_the_reference_order():
    """Chunked at 4 over S 16 (the chunk rule would take 16): the same
    loss as the reference's lm_loss at that chunk, and as one chunk."""
    cj, ct = _cfgs("qwen3_4b")
    pj, _ = J_T.init_params(cj, jax.random.key(0))
    pt = convert.params_from_repro(jax.tree.map(np.asarray, pj), device=CPU)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((B, S, cj.d_model)).astype(np.float32)
    labels = rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    for chunk in (4, None):
        want = float(J_steps.lm_loss(cj, pj, jnp.asarray(h), labels, mask,
                                     chunk=chunk))
        with torch.enable_grad():
            ht = torch.from_numpy(h).requires_grad_(True)
            got = T_steps.lm_loss(ct, pt, ht, torch.from_numpy(labels),
                                  torch.from_numpy(mask), chunk=chunk)
        assert abs(float(got) - want) <= F32_REL * abs(want)
        assert got.grad_fn is not None


def test_remat_is_bitwise_no_remat():
    """remat="full" (each layer checkpointed) against "none": the same
    gradients and the same step, bit for bit."""
    cj, _ = _cfgs("qwen3_4b")
    batch = _to_torch(_batches(cj, 1)[0])
    out = {}
    for remat in ("none", "full"):
        _, ct = _cfgs("qwen3_4b", remat=remat)
        params = convert.params_from_repro(jax.tree.map(
            np.asarray, J_T.init_params(cj, jax.random.key(0))[0]),
            device=CPU)
        grads = _port_grads(ct, params, batch)
        opt = T_AdamW(**OPT)
        st = T_steps.TrainState(params, opt.init(params),
                                torch.zeros((), dtype=torch.int32))
        st, m = T_steps.make_train_step(ct, opt)(st, batch)
        out[remat] = (tree_leaves(grads), tree_leaves(st.params), m)
    for a, b in zip(out["none"][0] + out["none"][1],
                    out["full"][0] + out["full"][1]):
        assert torch.equal(a, b)
    assert {k: float(v) for k, v in out["none"][2].items()} == \
        {k: float(v) for k, v in out["full"][2].items()}


def test_train_cli_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    """launch.train on the CPU: killed by --simulate-failure-at (exit 17),
    then resumed from the latest intact checkpoint; the final checkpoint's
    tree_crc32 is the uninterrupted run's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(where, *extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
             "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every",
             "2", "--device", "cpu", "--ckpt-dir", str(tmp_path / where),
             *extra], env=env, capture_output=True, text=True, timeout=300)

    whole = run("whole")
    assert whole.returncode == 0, whole.stderr
    killed = run("resumed", "--simulate-failure-at", "3")
    assert killed.returncode == 17, killed.stderr
    assert "simulating node failure" in killed.stdout
    resumed = run("resumed")
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step" in resumed.stdout
    crcs = [json.loads((tmp_path / w / "step_00000006" / "meta.json")
                       .read_text())["tree_crc32"]
            for w in ("whole", "resumed")]
    assert crcs[0] == crcs[1]
    assert ckpt.list_steps(str(tmp_path / "whole")) == [2, 4, 6]


def test_train_cli_defaults_and_device():
    from repro_torch.launch import train as T_train

    args = T_train.parser().parse_args([])
    assert (args.arch, args.steps, args.batch, args.seq, args.lr,
            args.ckpt_every, args.simulate_failure_at, args.device) == (
        "granite_3_2b", 50, 4, 64, 3e-4, 20, -1, "cuda")
    state, step = T_train.build(T_configs.get_config("granite_3_2b",
                                                     smoke=True), 4,
                                device=CPU)
    assert all(t.device.type == "cpu" for t in tree_leaves(state.params))
    assert int(state.step) == 0


# --- the guards: kernels without a backward raise under autograd -----------

def test_kernels_without_a_backward_raise_under_grad():
    from repro_torch.kernels import gse_decode, gse_matmul, lru_scan, wkv6

    a = torch.rand(1, 3, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        lru_scan.lru_scan(a, a.detach(), torch.zeros(1, 4), device=CPU)
    r = torch.rand(1, 2, 1, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        wkv6.wkv6(r, r.detach(), r.detach(), r.detach(),
                  torch.rand(1, 4), torch.zeros(1, 1, 4, 4), device=CPU)
    packed = T_gse.pack32(np.ones((8, 4), np.float32), device=CPU)
    scales = torch.ones(8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        gse_decode.gse_decode_dense(packed.head, packed.tail1, None, scales,
                                    ei_bit=packed.ei_bit, tag=1, device=CPU)
    x = torch.ones(2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        gse_matmul.gse_matmul_dense(x, packed.head, packed.tail1, None,
                                    torch.ones(8), ei_bit=packed.ei_bit,
                                    tag=1, device=CPU)
    # Without grad (or with inputs that need none) they serve as before.
    with torch.no_grad():
        lru_scan.lru_scan(a, a, torch.zeros(1, 4), device=CPU)


@pytest.mark.parametrize("arch", ("recurrentgemma_2b", "rwkv6_1p6b",
                                  "qwen3_moe_235b_a22b"))
def test_unported_families_train_steps_raise(arch):
    """The hybrid, ssm and moe families' train steps fail loudly (their
    backward is ROADMAP queue 1 item 18) instead of training with zero
    gradients."""
    from repro_torch.launch import train as T_train

    cfg = T_configs.get_config(arch, smoke=True)
    state, step = T_train.build(cfg, 2, device=CPU)
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.int32),
             "labels": torch.zeros(1, 4, dtype=torch.int32),
             "loss_mask": torch.ones(1, 4)}
    with pytest.raises(NotImplementedError, match="queue 1 item 18"):
        step(state, batch)
    assert all(not t.requires_grad for t in tree_leaves(state.params))


# --- gse_fake_quant and the gradient compression ---------------------------

def _grad_like(seed, shape=(96, 160)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * np.exp(rng.standard_normal(shape) * 3)).astype(np.float32)


@pytest.mark.parametrize("tag", (1, 2))
def test_gse_fake_quant_forward_bitwise_and_identity_gradient(tag):
    x = _grad_like(tag)
    want = np.asarray(J_gse.gse_fake_quant(jnp.asarray(x), 8, tag))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = T_gse.gse_fake_quant(xt, 8, tag)
    assert np.array_equal(_np(got).view(np.int32), want.view(np.int32))
    g = torch.from_numpy(_grad_like(9))
    (dx,) = torch.autograd.grad(got, xt, g)
    assert torch.equal(dx, g)
    gj = jax.grad(lambda v: jnp.sum(J_gse.gse_fake_quant(v, 8, tag)
                                    * jnp.asarray(g.numpy())))(jnp.asarray(x))
    assert np.array_equal(np.asarray(gj), g.numpy())


@pytest.mark.parametrize("tag", (1, 2))
def test_compress_decompress_bitwise(tag):
    g = _grad_like(10 + tag)
    hj, ej = J_compress.compress_decompress(jnp.asarray(g), k=8, tag=tag)
    ht, et = T_compress.compress_decompress(torch.from_numpy(g), k=8, tag=tag)
    assert np.array_equal(_np(ht).view(np.int32), np.asarray(hj).view(
        np.int32))
    assert np.array_equal(_np(et).view(np.int32), np.asarray(ej).view(
        np.int32))


def test_error_feedback_transform_matches_the_reference():
    grads = {"big": _grad_like(20, (128, 64)), "small": _grad_like(21, (7,))}
    init_j, tf_j = J_compress.make_error_feedback_transform(k=8, tag=1,
                                                            min_size=4096)
    init_t, tf_t = T_compress.make_error_feedback_transform(k=8, tag=1,
                                                            min_size=4096)
    gj = jax.tree.map(jnp.asarray, grads)
    gt = tree_map(torch.from_numpy, grads)
    bj, bt = init_j(gj), init_t(gt)
    for _ in range(2):
        oj, bj = tf_j(gj, bj)
        ot, bt = tf_t(gt, bt)
        for k in grads:
            assert np.array_equal(_np(ot[k]), np.asarray(oj[k]))
            assert np.array_equal(_np(bt[k]), np.asarray(bj[k]))
    assert np.array_equal(_np(ot["small"]), grads["small"])


def test_train_entry_points_default_to_cuda():
    """The train path's entry points run on the card unless asked: the
    pipeline, launch.train's build and CLI, F's backward, the port's
    modules importing neither jax nor repro (test_torch_isolation.py's
    glob covers the new files)."""
    import inspect

    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attn as F
    from repro_torch.launch import train as T_train

    for fn in (TokenPipeline, T_train.build, F.flash_attention_gqa_bwd):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert T_train.parser().get_default("device") == "cuda"
