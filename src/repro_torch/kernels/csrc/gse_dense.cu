// Kernels D and E on Hopper: the dense GSE-SEM decode and the matmul that
// decodes its weight tiles in shared memory.
//
// D replaces the Pallas kernel `decode_pallas` (src/repro/kernels/
// gse_decode.py:50, body `decode_kernel_body`, `pallas_call` :59); E
// replaces `gse_matmul_pallas` (src/repro/kernels/gse_matmul.py:52, body
// `_matmul_body`, `pallas_call` :63).
//
// Layout (dense, head-split): expIdx sits in the head below the sign, so
// m_h = 15 - ei_bit mantissa bits remain there; tail1 and tail2 extend the
// mantissa at tags 2 and 3.  This is not the sparse layout of
// `gse_decode.cuh`, where expIdx rides colpak and the head keeps 15 bits;
// mixing the two misreads the top mantissa bits as an exponent index.
// The value is (sgn * mant) * scales[expIdx] in f32, the order of the Pallas
// bodies, with every operation a round-to-nearest intrinsic so nvcc
// contracts nothing; the scale table (2^(E_sh - bits), `ref.make_scales`,
// bias 1023 for `gse.pack` packs and 127 for the model's f32-source
// segments) is passed in.
//
// * D (`gse_decode_dense`): one thread per value, grid-stride.  It reads
//   only the segments the tag needs (2, 4 or 8 bytes per value) and writes
//   f32 or bf16 (round to nearest even).  Bound by bytes: segments in,
//   4 or 2 bytes out per value.
//
// * E (`gse_matmul_dense`): Y (M, N) f32 = X (M, K) @ decode(W (K, N)),
//   X in f32 or bf16, f32 sums with FFMA (no TF32: the oracle is a full-f32
//   product).  Two bodies:
//   - M <= 8, the decode steps' GEMV (M = batch): a block owns 64 columns
//     (two per lane) and its eight warps split K; X is staged in shared
//     memory in chunks of 256, each weight is read and decoded once, and
//     the warps' partial sums are added in warp order at the end.  Bound by
//     the weight stream: 2/4/8 bytes per weight at tags 1/2/3.
//   - M > 8, prefill (M = B * S): 64 x 64 output tiles, K in steps of 16;
//     each W tile is decoded once into shared memory and serves all 64 rows
//     of the block's X tile; each thread accumulates a 4 x 4 block.  Bound
//     by FP32 FFMA at prefill sizes (2 M N K operations).
//   Both read only the segments the tag needs (the TPU kernel streams all
//   three) and check every bound, so any M, N and K run without padding.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int TAG>
__device__ __forceinline__ float decode_dense(uint32_t h, uint32_t t1,
                                              uint32_t t2, int m_h,
                                              uint32_t ei_mask,
                                              const float* __restrict__ scales) {
  const float sgn = __fsub_rn(1.0f, __fmul_rn(2.0f, (float)((h >> 15) & 1u)));
  const uint32_t idx = (h >> m_h) & ei_mask;
  float mant = (float)(h & ((1u << m_h) - 1u));
  if (TAG >= 2) mant = __fadd_rn(__fmul_rn(mant, 65536.0f), (float)t1);
  if (TAG == 3) {
    mant = __fadd_rn(__fmul_rn(mant, 4294967296.0f), __uint2float_rn(t2));
  }
  return __fmul_rn(__fmul_rn(sgn, mant), __ldg(scales + idx));
}

template <int TAG>
__device__ __forceinline__ float load_decode(
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, int64_t i, int m_h, uint32_t ei_mask,
    const float* __restrict__ scales) {
  const uint32_t h = head[i];
  const uint32_t t1 = TAG >= 2 ? (uint32_t)tail1[i] : 0u;
  const uint32_t t2 = TAG == 3 ? tail2[i] : 0u;
  return decode_dense<TAG>(h, t1, t2, m_h, ei_mask, scales);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// --- D ---------------------------------------------------------------------

template <int TAG, typename OutT>
__global__ void __launch_bounds__(kThreads) decode_dense_kernel(
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const float* __restrict__ scales,
    OutT* __restrict__ out, int64_t n, int m_h, uint32_t ei_mask) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    store(out + i, load_decode<TAG>(head, tail1, tail2, i, m_h, ei_mask,
                                    scales));
  }
}

// --- E, M <= 8: the GEMV body ------------------------------------------------

constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvCols = 64;     // two per lane
constexpr int kGemvChunk = 256;   // K values of X staged per pass

template <int TAG, typename XT, int MR>
__global__ void __launch_bounds__(kThreads) matmul_gemv_kernel(
    const XT* __restrict__ x, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ scales, float* __restrict__ y, int m, int64_t kk,
    int64_t n, int m_h, uint32_t ei_mask) {
  __shared__ float xs[MR][kGemvChunk];
  __shared__ float red[kGemvWarps][MR][kGemvCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t col0 = (int64_t)blockIdx.x * kGemvCols + 2 * lane;
  const bool ok0 = col0 < n, ok1 = col0 + 1 < n;
  float acc[MR][2];
#pragma unroll
  for (int r = 0; r < MR; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int64_t k0 = 0; k0 < kk; k0 += kGemvChunk) {
    const int len = kk - k0 < kGemvChunk ? (int)(kk - k0) : kGemvChunk;
    __syncthreads();
    for (int e = threadIdx.x; e < MR * kGemvChunk; e += kThreads) {
      const int r = e / kGemvChunk, c = e % kGemvChunk;
      xs[r][c] = (r < m && c < len) ? to_f32(x[(int64_t)r * kk + k0 + c])
                                    : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = warp; c < len; c += kGemvWarps) {
      const int64_t base = (k0 + c) * n + col0;
      const float w0 = ok0 ? load_decode<TAG>(head, tail1, tail2, base, m_h,
                                              ei_mask, scales) : 0.0f;
      const float w1 = ok1 ? load_decode<TAG>(head, tail1, tail2, base + 1,
                                              m_h, ei_mask, scales) : 0.0f;
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        acc[r][0] = __fmaf_rn(xs[r][c], w0, acc[r][0]);
        acc[r][1] = __fmaf_rn(xs[r][c], w1, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    red[warp][r][2 * lane] = acc[r][0];
    red[warp][r][2 * lane + 1] = acc[r][1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < MR * kGemvCols; e += kThreads) {
    const int r = e / kGemvCols, c = e % kGemvCols;
    const int64_t col = (int64_t)blockIdx.x * kGemvCols + c;
    if (r >= m || col >= n) continue;
    float s = red[0][r][c];
#pragma unroll
    for (int w = 1; w < kGemvWarps; ++w) s = __fadd_rn(s, red[w][r][c]);
    y[(int64_t)r * n + col] = s;
  }
}

// --- E, M > 8: the tiled body -------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 16;

template <int TAG, typename XT>
__global__ void __launch_bounds__(kThreads) matmul_tiled_kernel(
    const XT* __restrict__ x, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ scales, float* __restrict__ y, int64_t m,
    int64_t kk, int64_t n, int m_h, uint32_t ei_mask) {
  __shared__ float as[kBK][kBM];  // X tile, transposed
  __shared__ float ws[kBK][kBN];  // decoded W tile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t row0 = (int64_t)blockIdx.y * kBM;
  const int64_t col0 = (int64_t)blockIdx.x * kBN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int64_t k0 = 0; k0 < kk; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kBK, c = e % kBK;
      const int64_t row = row0 + r, k = k0 + c;
      as[c][r] = (row < m && k < kk) ? to_f32(x[row * kk + k]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kBN, c = e % kBN;
      const int64_t k = k0 + r, col = col0 + c;
      ws[r][c] = (k < kk && col < n)
                     ? load_decode<TAG>(head, tail1, tail2, k * n + col, m_h,
                                        ei_mask, scales)
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[c][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[c][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = col0 + tx * 4 + j;
      if (col < n) y[row * n + col] = acc[i][j];
    }
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < 132 * 16 ? (b < 1 ? 1 : b) : 132 * 16);
}

template <int TAG, typename OutT>
void launch_decode(const void* head, const void* tail1, const void* tail2,
                   const float* scales, void* out, int64_t n, int ei_bit,
                   cudaStream_t st) {
  decode_dense_kernel<TAG, OutT><<<blocks_for(n), kThreads, 0, st>>>(
      (const uint16_t*)head, (const uint16_t*)tail1, (const uint32_t*)tail2,
      scales, (OutT*)out, n, 15 - ei_bit, (1u << ei_bit) - 1u);
}

template <int TAG, typename XT>
void launch_matmul(const void* x, const void* head, const void* tail1,
                   const void* tail2, const float* scales, float* y, int64_t m,
                   int64_t kk, int64_t n, int ei_bit, cudaStream_t st) {
  const int m_h = 15 - ei_bit;
  const uint32_t mask = (1u << ei_bit) - 1u;
  const XT* xp = (const XT*)x;
  const uint16_t* h = (const uint16_t*)head;
  const uint16_t* t1 = (const uint16_t*)tail1;
  const uint32_t* t2 = (const uint32_t*)tail2;
  if (m <= 8) {
    const dim3 grid((unsigned)((n + kGemvCols - 1) / kGemvCols));
    if (m <= 1) {
      matmul_gemv_kernel<TAG, XT, 1><<<grid, kThreads, 0, st>>>(
          xp, h, t1, t2, scales, y, (int)m, kk, n, m_h, mask);
    } else if (m <= 2) {
      matmul_gemv_kernel<TAG, XT, 2><<<grid, kThreads, 0, st>>>(
          xp, h, t1, t2, scales, y, (int)m, kk, n, m_h, mask);
    } else if (m <= 4) {
      matmul_gemv_kernel<TAG, XT, 4><<<grid, kThreads, 0, st>>>(
          xp, h, t1, t2, scales, y, (int)m, kk, n, m_h, mask);
    } else {
      matmul_gemv_kernel<TAG, XT, 8><<<grid, kThreads, 0, st>>>(
          xp, h, t1, t2, scales, y, (int)m, kk, n, m_h, mask);
    }
    return;
  }
  const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                  (unsigned)((m + kBM - 1) / kBM));
  matmul_tiled_kernel<TAG, XT><<<grid, kThreads, 0, st>>>(
      xp, h, t1, t2, scales, y, m, kk, n, m_h, mask);
}

}  // namespace

extern "C" int gse_decode_dense(int tag, int out_bf16, const void* head,
                                const void* tail1, const void* tail2,
                                const float* scales, void* out, long long n,
                                int ei_bit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n > 0) {
    if (out_bf16) {
      if (tag == 1) launch_decode<1, __nv_bfloat16>(head, tail1, tail2, scales, out, n, ei_bit, st);
      else if (tag == 2) launch_decode<2, __nv_bfloat16>(head, tail1, tail2, scales, out, n, ei_bit, st);
      else launch_decode<3, __nv_bfloat16>(head, tail1, tail2, scales, out, n, ei_bit, st);
    } else {
      if (tag == 1) launch_decode<1, float>(head, tail1, tail2, scales, out, n, ei_bit, st);
      else if (tag == 2) launch_decode<2, float>(head, tail1, tail2, scales, out, n, ei_bit, st);
      else launch_decode<3, float>(head, tail1, tail2, scales, out, n, ei_bit, st);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int gse_matmul_dense(int tag, int x_bf16, const void* x,
                                const void* head, const void* tail1,
                                const void* tail2, const float* scales,
                                float* y, long long m, long long kk,
                                long long n, int ei_bit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m > 0 && n > 0) {
    if (x_bf16) {
      if (tag == 1) launch_matmul<1, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else if (tag == 2) launch_matmul<2, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else launch_matmul<3, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
    } else {
      if (tag == 1) launch_matmul<1, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else if (tag == 2) launch_matmul<2, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else launch_matmul<3, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
    }
  }
  return (int)cudaGetLastError();
}
