"""The port's AdamW (``optim/adamw.py``) against the reference's: the
cosine schedule with warmup, global-norm clipping and the update, at f32.

Tolerances: the schedule within 1 f32 ulp relative (2^-23; torch's and
XLA's ``cos`` may round differently); the global norm within 1e-6 of
the f64 sum of squares; the moments within 1e-6 relative; the updates
within 1e-6 relative plus 1e-9 (the same f32 operations in the same
order; the norm's sum is f64 in the port, an f32 chain in the reference,
and an update whose two terms nearly cancel, ``m/sqrt(v)`` against the
weight decay, keeps their last bits' difference times lr).  The leaves' norms are summed in ``jax.tree.leaves`` order (dict
keys sorted)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamW as J_AdamW  # noqa: E402

from repro_torch.optim import AdamW as T_AdamW  # noqa: E402
from repro_torch.optim import adamw as T_adamw  # noqa: E402
from repro_torch.tree import tree_leaves_sorted, tree_map  # noqa: E402

KW = dict(lr=3e-3, warmup_steps=5, total_steps=40, weight_decay=0.1)


@pytest.mark.parametrize("step", (0, 1, 4, 5, 6, 20, 39, 40, 100))
def test_schedule(step):
    want = float(J_AdamW(**KW).schedule(jnp.asarray(step, jnp.int32)))
    got = float(T_AdamW(**KW).schedule(torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= 2.0 ** -23 * abs(want)


def _tree(seed, scale):
    rng = np.random.default_rng(seed)
    return {"b": {"w": (rng.standard_normal((6, 5)) * scale)
                  .astype(np.float32)},
            "a": (rng.standard_normal(7) * scale).astype(np.float32),
            "c": [(rng.standard_normal((3, 2)) * scale).astype(np.float32)]}


def test_leaves_in_jax_order():
    t = _tree(0, 1.0)
    want = [np.asarray(x) for x in jax.tree.leaves(t)]
    got = tree_leaves_sorted(t)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("scale", (1e-3, 10.0))  # clip off, clip on
def test_update_and_clipping_match_the_reference(scale):
    params = _tree(1, 1.0)
    oj, ot = J_AdamW(**KW), T_AdamW(**KW)
    pj = jax.tree.map(jnp.asarray, params)
    pt = tree_map(torch.from_numpy, params)
    sj, st = oj.init(pj), ot.init(pt)
    for step in range(3):
        grads = _tree(10 + step, scale)
        gj = jax.tree.map(jnp.asarray, grads)
        gt = tree_map(torch.from_numpy, grads)
        gnorm = float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                                  for g in jax.tree.leaves(grads))))
        assert abs(float(T_adamw.global_norm(gt)) - gnorm) <= 1e-6 * gnorm
        uj, sj = oj.update(gj, sj, pj, jnp.asarray(step, jnp.int32))
        ut, st = ot.update(gt, st, pt, torch.tensor(step, dtype=torch.int32))
        for a, b in zip(jax.tree.leaves(uj), tree_leaves_sorted(ut)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-9)
        for name in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(getattr(sj, name)),
                            tree_leaves_sorted(getattr(st, name))):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-20)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        pt = tree_map(lambda p, u: p + u, pt, ut)


def test_init_is_f32_zeros_like_the_params():
    st = T_AdamW().init({"w": torch.ones(3, dtype=torch.bfloat16)})
    assert st.mu["w"].dtype == torch.float32 and not st.mu["w"].any()
    assert st.nu["w"].shape == (3,)
