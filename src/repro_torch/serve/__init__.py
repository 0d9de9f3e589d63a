"""Resilient async solve serving.

Port of ``repro/serve/``: chunked solver execution (``chunked``: a solver
family run in bounded segments of K iterations, bitwise the unchunked
run), a per-handle circuit breaker (``breaker``) and the admission and
dispatch service on top (``service``: bounded intake, typed shed
responses, continuous batching at chunk boundaries, deadlines enforced
mid-solve, warm starts, checkpoint and resume).
"""
from repro_torch.serve.breaker import BreakerParams, CircuitBreaker
from repro_torch.serve.chunked import BatchedChunks, IRChunks, SolveChunks
from repro_torch.serve.service import (
    Accepted,
    AsyncSolveService,
    Shed,
)

__all__ = [
    "Accepted",
    "AsyncSolveService",
    "BatchedChunks",
    "BreakerParams",
    "CircuitBreaker",
    "IRChunks",
    "Shed",
    "SolveChunks",
]
