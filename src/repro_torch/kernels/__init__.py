"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes build
and wrappers, and the plain PyTorch oracles in ``ref.py``."""
