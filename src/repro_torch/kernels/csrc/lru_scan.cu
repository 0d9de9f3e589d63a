// The RG-LRU recurrence on Hopper: h_t = a_t * h_(t-1) + b_t, per channel.
//
// Replaces no Pallas kernel: the reference computes the recurrence of its
// RG-LRU block (src/repro/models/rglru.py:94-100, `rglru_apply`) with
// `jax.lax.associative_scan` over plain XLA, and no single PyTorch call
// computes it.  Without a kernel the port's prefill would launch a few
// elementwise ops per position and layer (2560 positions x 18 layers of
// recurrentgemma_2b).
//
// a, b: (B, S, W) f32, contiguous; h0: (B, W) f32.  Writes h (B, S, W) and
// h_last (B, W).  One thread per (batch, channel), sequential in t: the
// threads of a warp hold 32 neighbouring channels, so every step's loads
// of a and b and its store of h are coalesced.  Each step rounds the
// product and then the sum (__fmul_rn, __fadd_rn: no contraction to an
// FMA), as the plain version (a torch loop) does, so the two are equal
// bit for bit.  The loads of the next kUnroll steps are issued before
// their products, so a thread keeps several loads in flight.
//
// Bound by bytes: 12 B S W (a and b read once, h written once) over the
// device memory rate.  At B W = 10,240 threads (recurrentgemma_2b, batch
// 4) the card holds 80 blocks of 128: fewer threads than it can keep
// busy, so the kernel is latency-bound before it is byte-bound.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads) lru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ h,
    float* __restrict__ h_last, int batch, int s_len, int width) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= width || bi >= batch) return;
  const int64_t base = (int64_t)bi * s_len * width + c;
  float hv = h0[(int64_t)bi * width + c];
  int t = 0;
  for (; t + kUnroll <= s_len; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)(t + u) * width;
      av[u] = a[i];
      bv[u] = b[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      hv = __fadd_rn(__fmul_rn(av[u], hv), bv[u]);
      h[base + (int64_t)(t + u) * width] = hv;
    }
  }
  for (; t < s_len; ++t) {
    const int64_t i = base + (int64_t)t * width;
    hv = __fadd_rn(__fmul_rn(a[i], hv), b[i]);
    h[i] = hv;
  }
  h_last[(int64_t)bi * width + c] = hv;
}

}  // namespace

extern "C" int lru_scan_f32(const float* a, const float* b, const float* h0,
                            float* h, float* h_last, int batch, int s_len,
                            int width, void* stream) {
  if (batch <= 0 || width <= 0) return 0;
  if (batch > 65535 || s_len < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((width + kThreads - 1) / kThreads),
                  (unsigned)batch);
  lru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, h0, h, h_last, batch, s_len, width);
  return (int)cudaGetLastError();
}
