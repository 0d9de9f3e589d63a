// The RWKV-6 time-mix recurrence on Hopper, per (batch, head) with state
// S in R^{N x N}:
//
//   out_t[m] = sum_n r_t[n] * (S[n][m] + u[n] * k_t[n] * v_t[m])
//   S[n][m]  = w_t[n] * S[n][m] + k_t[n] * v_t[m]
//
// Replaces no Pallas kernel: the reference runs this recurrence
// (src/repro/models/rwkv.py:136-151, `rwkv_time_apply`) as `jax.lax.scan`
// over plain XLA, and no single PyTorch call computes it.  Without a kernel
// the port's prefill would launch several operations per token and layer
// (2048 tokens x 24 layers of rwkv6_1p6b).
//
// r, k, v, w: (B, S, H, N) f32, contiguous; u: (H, N) f32; s0: (B, H, N, N)
// f32 (S[b][h][n][m]).  Writes out (B, S, H, N) and s_out (B, H, N, N).
//
// One block per (b, h), one thread per column m holding S[:, m] in
// registers.  The r, k, w and v of kChunk steps are staged in shared
// memory at a time, every load of a chunk issued before any is used, so
// the steps between two barriers wait on no global load (a barrier and a
// load a step left the first design at 63x its bound: 7.11 ms at (4,
// 2048, 32, 64) on an H100).  Every operation rounds as XLA's CPU build of
// the reference's scan step does (the order tests/test_torch_rwkv.py holds
// bitwise):
//
//   kv  = k_n * v_m                 (__fmul_rn)
//   t   = fma(u_n, kv, S_nm)        (__fmaf_rn)
//   acc = fma(r_n, t, acc)          n ascending from acc = 0
//   S'  = fma(w_n, S_nm, kv)
//
// so the kernel equals its plain version (kernels/wkv6.py) bit for bit.
// The sum over n is one dependent chain of N FMAs a step: with B H blocks
// of N threads the card is latency-bound, not byte- or FMA-bound (a
// chunked form would fill it but sums in another order).
//
// N (runtime) <= NP, NP in {8, 16, 32, 64} (compile time: S stays in
// registers).  The entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // steps staged in shared memory at a time

// NP: threads (columns) a block, N rounded up; EXACT: N == NP, so the
// column guards fold away.
template <int NP, bool EXACT>
__global__ void __launch_bounds__(NP) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ out, float* __restrict__ s_out, int heads, int s_len,
    int n_rt) {
  const int n = EXACT ? NP : n_rt;
  __shared__ float sr[kChunk][NP], sk[kChunk][NP], sw[kChunk][NP];
  __shared__ float sv[kChunk][NP];
  __shared__ float su[NP];
  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - b * heads;
  const int m = threadIdx.x;
  const bool act = EXACT || m < n;
  const int64_t stride_t = (int64_t)heads * n;
  const int64_t base = ((int64_t)b * s_len * heads + h) * n + m;
  const int64_t sbase = (int64_t)bh * n * n + m;

  float st[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    st[i] = (act && (EXACT || i < n)) ? s0[sbase + (int64_t)i * n] : 0.0f;
  if (act) su[m] = u[(int64_t)h * n + m];

  for (int t0 = 0; t0 < s_len; t0 += kChunk) {
    const int tc = min(kChunk, s_len - t0);
    __syncthreads();  // the previous chunk is consumed
    if (act) {
      // Every load of the chunk issued before any is used.
#pragma unroll 8
      for (int j = 0; j < tc; ++j) {
        const int64_t o = base + (int64_t)(t0 + j) * stride_t;
        sr[j][m] = r[o];
        sk[j][m] = k[o];
        sw[j][m] = w[o];
        sv[j][m] = v[o];
      }
    }
    __syncthreads();
    for (int j = 0; j < tc; ++j) {
      const float vm = sv[j][m];
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (EXACT || i < n) {
          const float kv = __fmul_rn(sk[j][i], vm);
          const float tt = __fmaf_rn(su[i], kv, st[i]);
          acc = __fmaf_rn(sr[j][i], tt, acc);
          st[i] = __fmaf_rn(sw[j][i], st[i], kv);
        }
      }
      if (act) out[base + (int64_t)(t0 + j) * stride_t] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i)
    if (act && (EXACT || i < n)) s_out[sbase + (int64_t)i * n] = st[i];
}

template <int NP>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* out, float* s_out,
           int batch, int heads, int s_len, int n, cudaStream_t stream) {
  const unsigned grid = (unsigned)(batch * heads);
  if (n == NP)
    wkv6_kernel<NP, true><<<grid, NP, 0, stream>>>(r, k, v, w, u, s0, out,
                                                  s_out, heads, s_len, n);
  else
    wkv6_kernel<NP, false><<<grid, NP, 0, stream>>>(r, k, v, w, u, s0, out,
                                                   s_out, heads, s_len, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_f32(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* s0,
                        float* out, float* s_out, int batch, int s_len,
                        int heads, int n, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0) return 0;
  if (n > 64 || s_len < 0 || (int64_t)batch * heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 8) return launch<8>(r, k, v, w, u, s0, out, s_out, batch, heads,
                               s_len, n, st);
  if (n <= 16) return launch<16>(r, k, v, w, u, s0, out, s_out, batch, heads,
                                 s_len, n, st);
  if (n <= 32) return launch<32>(r, k, v, w, u, s0, out, s_out, batch, heads,
                                 s_len, n, st);
  return launch<64>(r, k, v, w, u, s0, out, s_out, batch, heads, s_len, n,
                    st);
}
