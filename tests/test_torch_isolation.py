"""The port stands alone: ``src/repro_torch``, ``tools/`` and
``chip_smoke.py`` import neither JAX nor the JAX package, entry points
default to the card and run on the CPU when asked, and ``chip_smoke.py``
fails without a card or without the rest of the repository.
"""
import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "msgpack", "zstandard"}
# The telemetry, fault and checkpoint modules, and the async serving that
# checkpoints through them: the card's machine has no msgpack and no
# zstandard, so the checkpoint blob is the port's own.
TELEMETRY = ["repro_torch.obs", "repro_torch.obs.metrics",
             "repro_torch.obs.trace", "repro_torch.obs.flight",
             "repro_torch.checkpoint.ckpt", "repro_torch.robustness.faults",
             "repro_torch.serve", "repro_torch.serve.breaker",
             "repro_torch.serve.chunked", "repro_torch.serve.service"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f"{path.name} imports {bad}"
    for node in ast.walk(tree):  # no torch.compile anywhere in the port
        if isinstance(node, ast.Attribute) and node.attr == "compile":
            assert not (isinstance(node.value, ast.Name)
                        and node.value.id == "torch"), path.name


@pytest.mark.parametrize("module", TELEMETRY)
def test_telemetry_modules_load_no_jax_msgpack_or_zstandard(module):
    """Imported alone, in a fresh interpreter, each module loads none of
    the forbidden packages (nor anything that imports them)."""
    code = (f"import sys, {module}; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stdout + out.stderr


def _device_defaults():
    from repro_torch import convert
    from repro_torch.core import gse, precision
    from repro_torch.kernels import (flash_attn, gse_decode, gse_matmul,
                                     gse_spmm, ops, vec_f64)
    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.models import attention, transformer
    from repro_torch.serve import AsyncSolveService
    from repro_torch.solvers.batched import (solve_cg_batched,
                                             solve_ir_batched,
                                             solve_pcg_batched)
    from repro_torch.sparse import csr, generators

    fns = [csr.from_coo, gse.pack, gse.pack_with_table, precision.init,
           convert.gsecsr_from_repro, convert.csr_from_repro,
           SolverService, AsyncSolveService, solve_cg_batched,
           solve_pcg_batched,
           solve_ir_batched, vec_f64.seq_dot_cols,
           vec_f64.fma_axpy_cols, vec_f64.ref_norm_cols,
           gse_spmm.gse_spmm_ell_f32, gse_spmm.gse_spmm_csr_f64,
           ops.gse_spmm_ell, gse_spmm.gse_spmm_sell_f32,
           gse_spmm.gse_spmm_sell_f64, ops.gse_spmm_sell, gse.pack32,
           gse_decode.gse_decode_dense, gse_matmul.gse_matmul_dense,
           flash_attn.flash_attention, flash_attn.flash_attention_gqa,
           ops.gse_decode, ops.gse_matmul, convert.params_from_repro,
           transformer.init_params, transformer.decode_state_init,
           attention.cache_init]
    fns += [getattr(generators, n) for n in generators.__all__
            if "device" in inspect.signature(getattr(generators, n)).parameters]
    return fns


def test_entry_points_default_to_cuda():
    fns = _device_defaults()
    assert len(fns) >= 38
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__


def test_asking_for_cpu_runs_the_main_path_on_cpu():
    from repro_torch.core.precision import MonitorParams
    from repro_torch.kernels import gse_spmv as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import vec_f64 as V
    from repro_torch.solvers.cg import solve_cg
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr
    from repro_torch.sparse.spmv import spmv_gse

    a = G.random_spd(200, seed=4, device="cpu")
    g = pack_csr(a)
    assert all(t.device.type == "cpu" for t in (g.colpak, g.head, g.table))
    x = torch.ones(200, dtype=torch.float64)
    K.reset_launch_counts()
    V.reset_launch_counts()
    y = ops.gse_spmv_ell(ops.ell_pack_gsecsr(g), g.table, x.float(),
                         g.ei_bit, tag=2)
    b = spmv_gse(g, x, 3)
    res = solve_cg(g, b, tol=1e-10, maxiter=500,
                   params=MonitorParams(t=20, l=20, m=10))
    assert y.device.type == "cpu" and bool(res.converged)
    assert res.x.device.type == "cpu"
    # CPU tensors take the plain versions: no kernel launched.
    assert K.gse_spmv_ell_f32.launches == K.gse_spmv_csr_f64.launches == 0
    assert V.seq_dot.launches == V.fma_axpy.launches == 0


def test_the_per_group_path_runs_where_its_operand_lies():
    """The per-group precision axis adds no device argument: the masked
    views, the bucket tags, the mixed launch and the adaptive driver run on
    the operand's device (the CPU's plain versions here, no launch), and
    the service still defaults to the card, whatever its ``tags``."""
    from repro_torch.core.tagmap import TagMap
    from repro_torch.kernels import gse_spmv as K
    from repro_torch.kernels import ops
    from repro_torch.launch.solver_serve import SolverService
    from repro_torch.solvers.adaptive import solve_adaptive
    from repro_torch.sparse import generators as G
    from repro_torch.sparse.csr import pack_csr

    a = G.poisson2d(4, device="cpu")
    g = pack_csr(a)
    tm = TagMap([1, 2])
    sell = ops.sell_pack_gsecsr(g)
    K.reset_launch_counts()
    assert ops.masked_for_tagmap(g, tm).tail1.device.type == "cpu"
    masked = ops.masked_for_tagmap(sell, tm)
    assert masked.segments[2].device.type == "cpu"
    assert ops.sell_bucket_tags(sell, tm) == sell.bucket_tags(tm)
    y = ops.gse_spmv_sell(masked, torch.ones(16), tag=tm)
    assert y.device.type == "cpu"
    assert K.gse_spmv_sell_f32.launches == K.gse_spmv_sell_f32.mixed_launches \
        == 0
    assert "device" not in inspect.signature(solve_adaptive).parameters
    r = solve_adaptive(g, torch.ones(16, dtype=torch.float64), tol=1e-3,
                       maxiter=50)
    assert r.x.device.type == "cpu" and r.converged
    assert inspect.signature(SolverService).parameters[
        "device"].default == "cuda"
    for tags in (2, tm, "adaptive"):
        with pytest.raises(ValueError, match="expected cuda"):
            SolverService().register("op", a, tags=tags)


def test_the_lm_path_runs_on_the_cpu_when_asked():
    """init_params, pack32, params_from_repro and the serve CLI default to
    the card and run on the CPU with ``device="cpu"``; the CPU takes the
    plain versions of kernels D, E and F."""
    import numpy as np

    from repro_torch import configs, convert
    from repro_torch.core import gse
    from repro_torch.kernels import flash_attn, gse_decode, gse_matmul
    from repro_torch.launch import serve
    from repro_torch.models import stepfns, transformer as T

    for fn in (gse.pack32, convert.params_from_repro, T.init_params):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    p32 = gse.pack32(np.ones((4, 8), np.float32), device="cpu")
    assert p32.head.device.type == "cpu"
    tree = convert.params_from_repro({"w": np.ones((2, 3), np.float32)},
                                     device="cpu")
    assert tree["w"].device.type == "cpu"
    cfg = configs.get_config("qwen3_4b", smoke=True)
    import dataclasses
    cfg = dataclasses.replace(cfg, gse_serve=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for mod in (gse_decode, gse_matmul, flash_attn):
        mod.reset_launch_counts()
    tokens = torch.zeros(2, 5, dtype=torch.int64)
    logits = stepfns.make_prefill_step(cfg)(params, tokens)
    assert logits.device.type == "cpu" and logits.shape == (2, 241)
    assert serve.main(["--device", "cpu", "--gen", "1", "--prompt-len", "2",
                       "--batch", "1", "--gse-tag", "1"])
    assert (gse_decode.gse_decode_dense.launches
            == gse_matmul.gse_matmul_dense.launches
            == flash_attn.flash_attention_gqa.launches == 0)
    assert serve.parser().parse_args([]).device == "cuda"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
