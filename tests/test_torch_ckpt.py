"""The port's checkpoints against the JAX reference.

``tree_crc32`` is the reference's number on the same trees: nested dicts,
lists and tuples of arrays and tensors, ``MonitorState`` and a CG loop
state with its guard state and flight ring.  ``spd_rs8_2k``
(``diag_rescale(random_spd(2000, seed=21), 8, 21)``, guards on, the ring
holding all 2791 rows) chunked at iterations 700 and 1920 through
``save``/``save_async`` and ``restore_latest_valid`` is bitwise the
reference's unchunked solve: x, the iteration count, relres, the
switches at [120, 150] and the ring.  A flipped blob byte and a tampered
blob under a re-stamped ``meta.json`` raise ``CheckpointCorrupt``, and
``restore_latest_valid`` walks back past them.
"""
import json
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as J_ck  # noqa: E402
from repro.core import precision as J_P  # noqa: E402
from repro.obs import flight as J_OF  # noqa: E402
from repro.robustness.guards import DEFAULT_GUARDS as J_GUARDS  # noqa: E402
from repro.solvers import cg as J_cg  # noqa: E402
from repro.sparse import csr as J_csr  # noqa: E402
from repro.sparse import generators as J_gen  # noqa: E402
from repro.sparse.spmv import spmv as j_spmv  # noqa: E402

from repro_torch.checkpoint import ckpt as T_ck  # noqa: E402
from repro_torch.convert import gsecsr_from_repro  # noqa: E402
from repro_torch.core import precision as T_P  # noqa: E402
from repro_torch.obs import flight as T_OF  # noqa: E402
from repro_torch.robustness.guards import DEFAULT_GUARDS  # noqa: E402
from repro_torch.solvers import cg as T_cg  # noqa: E402

CPU = "cpu"
QS = dict(t=40, l=60, m=30)
STEP = dict(t=10, l=10, m=5, rsd_limit=0.5, reldec_limit=2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _system(a, x_true):
    g = J_csr.pack_csr(a, k=8)
    tg = gsecsr_from_repro(
        {n: np.asarray(getattr(g, n)) for n in
         ("rowptr", "colpak", "head", "tail1", "tail2", "table", "row_ids")},
        g.ei_bit, g.shape, device=CPU)
    return g, tg, np.array(j_spmv(a, jnp.asarray(x_true)))


def _nested(lib):
    rng = np.random.default_rng(4)
    arrs = [rng.normal(size=(3, 2)), rng.integers(0, 9, 5).astype(np.int32),
            np.array(True), rng.normal(size=4).astype(np.float32),
            np.arange(6, dtype=np.uint16).reshape(2, 3)]
    if lib == "torch":
        arrs = [torch.from_numpy(a) for a in arrs]
    else:
        arrs = [jnp.asarray(a) for a in arrs]
    return {"b": arrs[0], "a": [arrs[1], (arrs[2], {"z": arrs[3]})],
            "c": {"7": arrs[4], "k": None}}


def test_tree_crc32_is_the_reference_number_on_nested_trees():
    assert T_ck.tree_crc32(_nested("torch")) == J_ck.tree_crc32(
        _nested("jax"))
    np_tree = {"x": np.arange(5.0), "l": [np.int64(3), np.zeros((0, 2))]}
    assert T_ck.tree_crc32(np_tree) == J_ck.tree_crc32(np_tree)
    mon_t = T_P.init(T_P.MonitorParams(**QS), tag=2, device=CPU)
    mon_j = J_P.init(J_P.MonitorParams(**QS), tag=2)
    assert T_ck.tree_crc32({"mon": mon_t}) == J_ck.tree_crc32({"mon": mon_j})
    assert T_ck.tree_crc32(_nested("torch")) != T_ck.tree_crc32(
        {"b": torch.zeros(3, 2)})


def test_tree_crc32_of_a_loop_state_is_the_reference_number():
    """A guarded, recorded CG state after 23 iterations.  The port's CG
    state also carries ``rr`` (equal to ``rs``); the rest is the
    reference's tree, leaf for leaf."""
    g, tg, b = _system(J_gen.poisson2d(12), np.random.default_rng(3).normal(
        size=144))
    kw = dict(maxiter=400, init_tag=1, stop_at=23, return_state=True)
    *_, js = J_cg._solve_cg_fused(
        g, jnp.asarray(b), jnp.zeros(144), jnp.asarray(1e-10),
        params=J_P.MonitorParams(**STEP), guards=J_GUARDS,
        flight=J_OF.FlightParams(capacity=16), **kw)
    *_, ts = T_cg._solve_cg_fused(
        tg, torch.from_numpy(b), torch.zeros(144, dtype=torch.float64),
        torch.tensor(1e-10, dtype=torch.float64),
        params=T_P.MonitorParams(**STEP), guards=DEFAULT_GUARDS,
        flight=T_OF.FlightParams(capacity=16), **kw)
    assert sorted(ts) == sorted(list(js) + ["rr"])
    assert int(ts["it"]) == 23 and int(ts["mon"].tag) == 3
    shared = {k: ts[k] for k in js}
    assert T_ck.tree_crc32(shared) == J_ck.tree_crc32(js)
    assert T_ck.tree_crc32(ts["fl"]) == J_ck.tree_crc32(js["fl"])


def test_a_chunked_solve_through_checkpoints_is_the_unchunked_solve(
        tmp_path):
    a = J_gen.diag_rescale(J_gen.random_spd(2000, seed=21), 8.0, 21)
    g, tg, b = _system(a, np.random.default_rng(0).normal(size=2000))
    jr = J_cg.solve_cg(g, jnp.asarray(b), tol=1e-8, maxiter=20000,
                       params=J_P.MonitorParams(**QS),
                       flight=J_OF.FlightParams(capacity=4096))
    args = (tg, torch.from_numpy(b), torch.zeros(2000, dtype=torch.float64),
            torch.tensor(1e-8, dtype=torch.float64), 20000,
            T_P.MonitorParams(**QS))
    kw = dict(guards=DEFAULT_GUARDS, flight=T_OF.FlightParams(capacity=4096))
    path = str(tmp_path / "ck")
    state = None
    for n, stop in enumerate((700, 1920)):
        res, _, state = T_cg._solve_cg_fused(*args, resume=state,
                                             stop_at=stop, return_state=True,
                                             **kw)
        assert int(res.iters) == stop
        crc = T_ck.tree_crc32(state)
        if n == 0:
            T_ck.save(path, state, stop, extra={"chunk": n})
        else:
            T_ck.save_async(path, state, stop, extra={"chunk": n})
            T_ck.wait_pending(path)
        like = state
        state = None  # resume only from what the disk holds
        tree, step, extra, skipped = T_ck.restore_latest_valid(path, like)
        assert (step, extra, skipped) == (stop, {"chunk": n}, [])
        assert T_ck.tree_crc32(tree) == crc
        assert isinstance(tree["mon"], T_P.MonitorState)
        state = tree
    with open(os.path.join(path, "step_00001920", "meta.json")) as f:
        meta = json.load(f)
    assert meta["tree_crc32"] == crc and meta["step"] == 1920
    assert T_ck.list_steps(path) == [700, 1920]
    res, _ = T_cg._solve_cg_fused(*args, resume=state, **kw)
    assert (int(res.iters), res.switch_iters.tolist()) == (2791, [120, 150])
    assert int(res.iters) == int(jr.iters)
    assert float(res.relres) == float(jr.relres)
    np.testing.assert_array_equal(res.x.numpy(), np.asarray(jr.x))
    log = T_OF.FlightLog.from_state(res.flight)
    jlog = J_OF.FlightLog.from_state(jr.flight)
    for c in T_OF.COLUMNS:
        np.testing.assert_array_equal(getattr(log, c), getattr(jlog, c))
    T_OF.assert_consistent(log, res)


def _small_state():
    return {"x": torch.arange(12, dtype=torch.float64),
            "mon": T_P.init(T_P.MonitorParams(t=4, l=4, m=2), device=CPU),
            "l": [torch.ones(3, dtype=torch.int32)]}


def _blob(path, step):
    return os.path.join(path, f"step_{step:08d}", "ckpt.bin.z")


def test_a_flipped_blob_byte_is_skipped(tmp_path):
    path = str(tmp_path)
    st = _small_state()
    T_ck.save(path, st, 1)
    st2 = dict(st, x=st["x"] + 1)
    T_ck.save(path, st2, 2)
    tree, step, _, skipped = T_ck.restore_latest_valid(path, st)
    assert step == 2 and skipped == [] and torch.equal(tree["x"], st2["x"])
    blob = bytearray(open(_blob(path, 2), "rb").read())
    blob[len(blob) // 2] ^= 0x10
    open(_blob(path, 2), "wb").write(bytes(blob))
    with pytest.raises(T_ck.CheckpointCorrupt, match="integrity"):
        T_ck.restore(path, 2, st)
    tree, step, _, skipped = T_ck.restore_latest_valid(path, st)
    assert (step, skipped) == (1, [2])
    assert T_ck.tree_crc32(tree) == T_ck.tree_crc32(st)
    assert isinstance(T_ck.CheckpointCorrupt("x"), IOError)


def test_a_restamped_meta_fails_the_tree_crc(tmp_path):
    """The blob's leaf bytes changed and ``meta.json``'s sha256 and size
    re-stamped to match: only the tree CRC32 catches it."""
    path = str(tmp_path)
    st = _small_state()
    T_ck.save(path, st, 1)
    T_ck.save(path, st, 2)
    raw = bytearray(zlib.decompress(open(_blob(path, 2), "rb").read()))
    raw[-1] ^= 0x01  # the last leaf's last byte
    comp = zlib.compress(bytes(raw))
    open(_blob(path, 2), "wb").write(comp)
    meta_path = os.path.join(path, "step_00000002", "meta.json")
    meta = json.load(open(meta_path))
    import hashlib
    meta.update(sha256=hashlib.sha256(comp).hexdigest(), bytes=len(comp))
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(T_ck.CheckpointCorrupt, match="tree CRC32"):
        T_ck.restore(path, 2, st)
    _, step, _, skipped = T_ck.restore_latest_valid(path, st)
    assert (step, skipped) == (1, [2])


def test_partial_and_mismatched_checkpoints(tmp_path):
    path = str(tmp_path)
    assert T_ck.latest_step(path + "/none") is None
    assert T_ck.restore_latest_valid(path, _small_state()) is None
    st = _small_state()
    T_ck.save(path, st, 3)
    os.makedirs(os.path.join(path, "step_00000009.tmp"))  # a crashed write
    os.makedirs(os.path.join(path, "step_00000008"))  # no meta.json
    assert T_ck.latest_step(path) == 3 and T_ck.list_steps(path) == [3]
    with pytest.raises(KeyError):
        T_ck.restore(path, 3, dict(st, y=torch.zeros(1)))
    with pytest.raises(ValueError, match="shape"):
        T_ck.restore(path, 3, dict(st, x=torch.zeros(5)))
    tree, step, extra = T_ck.restore(path, 3, st)
    assert (step, extra) == (3, {})
    assert tree["l"][0].dtype == torch.int32
    assert torch.equal(tree["mon"].hist, st["mon"].hist)
    T_ck.save(path, st, 3)  # overwriting a step replaces it
    assert T_ck.list_steps(path) == [3]
