"""Roofline probes of a device: stream bandwidth and FP32 peak.

Port of ``repro/perf/roofline.py``.  A device's attainable rates are
measured once (a STREAM triad and an FP32 matmul), persisted in the tune
cache under that device (``perf.tunecache``, checksum-verified like every
entry), and every priced kernel reports

    roofline_fraction = max(bytes / BW, flops / peak) / measured_seconds

attainable time over measured time.  :func:`host_roofline` keeps the
reference's name and probes the device it is given, the card by default.

On the card the triad's three f64 arrays are 256 MiB each, five times the
H100's 50 MB L2, and the matmul is 8192 x 8192 in FP32 with TF32 off (the
caller's setting restored): the reference's f32 probe, not the tensor
cores'.  The triad (``torch.add(b, x, alpha=2.0, out=y)``) and the matmul
are probes of the device, not ports of a kernel.
"""
from __future__ import annotations

import torch

from repro_torch.perf import timing, tunecache

__all__ = ["probe_stream_gbps", "probe_peak_gflops", "host_roofline",
           "attainable_seconds", "fraction"]

# Probe sizes per device type: (triad elements, quick triad elements,
# matmul n, quick matmul n).  On the card the triad stays past the L2 even
# when quick.
_SIZES = {"cuda": (1 << 25, 1 << 25, 8192, 4096),
          "cpu": (1 << 23, 1 << 21, 1024, 512)}


def _randn(shape, seed: int, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def probe_stream_gbps(n: int | None = None, iters: int = 5,
                      device="cuda") -> float:
    """STREAM-triad bandwidth of ``device`` in GB/s: ``y = 2x + b`` over
    three f64 arrays of ``n`` elements (default 256 MiB each on the card,
    64 MiB on the CPU)."""
    dev = torch.device(device)
    n = _SIZES[dev.type][0] if n is None else n
    x = _randn(n, 0, torch.float64, dev)
    b = _randn(n, 1, torch.float64, dev)
    y = torch.empty_like(x)
    _, sec = timing.measure(lambda: torch.add(b, x, alpha=2.0, out=y),
                            iters=iters, warmup=2)
    return 3 * 8 * n / sec / 1e9


def probe_peak_gflops(n: int | None = None, iters: int = 5,
                      device="cuda") -> float:
    """FP32 FLOP rate of ``device`` in GFLOP/s: an (n, n) f32 matmul, 2n^3
    FLOPs a call, TF32 off."""
    dev = torch.device(device)
    n = _SIZES[dev.type][2] if n is None else n
    a = _randn((n, n), 2, torch.float32, dev)
    b = _randn((n, n), 3, torch.float32, dev)
    out = torch.empty_like(a)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, sec = timing.measure(lambda: torch.mm(a, b, out=out),
                                iters=iters, warmup=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2 * n**3 / sec / 1e9


def host_roofline(refresh: bool = False, quick: bool = False,
                  device="cuda") -> dict:
    """``{stream_gbps, peak_gflops, device, stream_n, matmul_n, probed}``
    for ``device``.

    Persisted in the tune cache under the device, so a repeat run probes
    nothing (``probed=False`` on a hit); ``refresh=True`` forces a
    re-measure.  ``quick`` shrinks the probes (on the card only the
    matmul)."""
    if not refresh:
        hit = tunecache.host_entry(device)
        if hit is not None:
            return {**hit, "probed": False}
    dev = torch.device(device)
    n_full, n_quick, m_full, m_quick = _SIZES[dev.type]
    stream_n = n_quick if quick else n_full
    matmul_n = m_quick if quick else m_full
    iters = 3 if quick else 5
    payload = {
        "stream_gbps": probe_stream_gbps(n=stream_n, iters=iters,
                                         device=dev),
        "peak_gflops": probe_peak_gflops(n=matmul_n, iters=iters,
                                         device=dev),
        "device": tunecache.device_name(dev),
        "stream_n": stream_n,
        "matmul_n": matmul_n,
    }
    tunecache.store_host(payload, device)
    return {**payload, "probed": True}


def attainable_seconds(flops: float, bytes_: float, roof: dict) -> float:
    """Roofline lower bound on the time of (flops, bytes) on ``roof``."""
    return max(bytes_ / (roof["stream_gbps"] * 1e9),
               flops / (roof["peak_gflops"] * 1e9))


def fraction(flops: float, bytes_: float, seconds: float,
             roof: dict) -> float:
    """Attainable time over measured time (1.0 is at the roofline; above
    1 the working set sat in cache above the streamed-bandwidth roof)."""
    return attainable_seconds(flops, bytes_, roof) / seconds
