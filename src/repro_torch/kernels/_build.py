"""Build and load the port's hand-written CUDA kernels.

Every ``kernels/csrc/*.cu`` source has a plain C interface.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``) and loaded with ``ctypes``; the Python wrappers pass
tensor pointers and PyTorch's current stream.  A library's file name
carries a hash of its source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source is rebuilt and never shadowed by a stale
build.  Nothing here runs at import time:
the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "SOURCES", "VARIANTS", "build_all",
           "load", "BUILD_LOG"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gse_spmv", "gse_spmm", "gse_sell", "vec_f64", "gmres_f64",
           "gse_dense", "flash_attn", "flash_attn_window", "flash_attn_bwd",
           "lru_scan", "wkv6")
# Libraries built from another library's source with extra flags: kernel
# F's windowed build (its window checks compiled in; the plain build keeps
# them out, so a window of 0 runs the code of before at its speed).
VARIANTS = {"flash_attn_window": ("flash_attn", ("-DFLASH_WINDOW=1",))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": float, "log": str} for builds made by this process.
BUILD_LOG: dict = {}
_LIBS: dict = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str):
    """(the ``.cu`` file, the extra nvcc flags) of library ``name``."""
    base, flags = VARIANTS.get(name, (name, ()))
    return CSRC / f"{base}.cu", flags


def _lib_path(name: str) -> Path:
    cu, flags = _source(name)
    src = cu.read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + " ".join(NVCC_FLAGS + flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library of ``names`` with one ``nvcc`` per
    source, all started together.  Returns ``{name: library path}``;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cu, flags = _source(name)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib
