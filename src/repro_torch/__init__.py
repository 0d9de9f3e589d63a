"""repro_torch: the GSE-SEM stepped-precision solvers and GSE-SEM LM
serving on PyTorch and CUDA.

The port of the JAX package ``repro`` to an NVIDIA H100.  Subpackages
mirror ``repro``'s names; the Pallas kernels become hand-written CUDA
kernels under ``kernels/csrc``.  Entry points that create tensors take a
``device=`` argument that defaults to ``"cuda"``; tests pass ``"cpu"``,
where each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
