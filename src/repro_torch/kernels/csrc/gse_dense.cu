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
//   - M <= 8, the decode steps' GEMV (M = batch), bound by the weight
//     stream: 2/4/8 bytes per weight at tags 1/2/3.  A block owns 256
//     columns (eight per lane; 64 on narrow matrices, a warp then loading
//     four rows) and one of the plan's K splits (at most 8192 / M rows);
//     the grid is (column tiles, splits), planned by the wrapper so that
//     every decode-step shape launches at least 2 x 132 blocks (16 blocks
//     for N = 1024 had left the HBM idle), in one wave of three blocks
//     per SM where the row cap allows.  Each lane loads 16 bytes
//     of each segment the tag reads (8 heads, 8 tail1, two loads of 4
//     tail2) per row, decodes them in registers with decode_dense (D's
//     decode), and keeps 8 (tag 1), 4 or 2 (tag 3) independent rows in
//     flight (half at M 8); the block's x is staged in shared memory as
//     f32.  The sums are fixed in order: rows within a sub-warp, sub-warps
//     in order, then the splits in order by the last block of the column
//     tile to finish (a per-tile counter), in the same launch.  No float atomics, so two
//     calls give the same bits.  Unaligned segments or N % 8 != 0 take
//     scalar loads in the same kernel (the wrapper picks the
//     instantiation).
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

// --- E, M <= 8: the GEMV body, split over K -------------------------------

constexpr int kGemvWarps = kThreads / 32;
constexpr int kGemvCols = 256;  // columns per block at RW 1: eight per lane
// Shared floats: the block's x (rows x MR, so at most 8192 / MR K rows per
// block: the plan's cap), then the sub-warps' sums (8 RW x 4 rows x 256 /
// RW columns).
constexpr int kGemvSmem = 8192;

// One K row of a lane's eight columns, as loaded: eight heads, eight tail1
// and eight tail2 words.
struct Row8 {
  uint4 h, t1, t2a, t2b;
};

// A 16-byte load that does not allocate in L1: each weight is read once.
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Element i of W's row-major segments and the seven after it.  VEC: four
// 16-byte loads at most (the wrapper checked the alignment); otherwise
// scalar loads of the `left` columns that exist, the rest read as 0.
template <int TAG, bool VEC>
__device__ __forceinline__ Row8 load_row8(const uint16_t* __restrict__ head,
                                          const uint16_t* __restrict__ tail1,
                                          const uint32_t* __restrict__ tail2,
                                          int64_t i, int64_t left) {
  Row8 s = {};
  if (VEC) {
    s.h = ld_stream(head + i);
    if (TAG >= 2) s.t1 = ld_stream(tail1 + i);
    if (TAG == 3) {
      s.t2a = ld_stream(tail2 + i);
      s.t2b = ld_stream(tail2 + i + 4);
    }
    return s;
  }
  uint32_t h[4] = {0u, 0u, 0u, 0u}, t1[4] = {0u, 0u, 0u, 0u};
  uint32_t t2[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < left) {
      h[j >> 1] |= (uint32_t)__ldg(head + i + j) << (16 * (j & 1));
      if (TAG >= 2) t1[j >> 1] |= (uint32_t)__ldg(tail1 + i + j) << (16 * (j & 1));
      if (TAG == 3) t2[j] = __ldg(tail2 + i + j);
    }
  }
  s.h = make_uint4(h[0], h[1], h[2], h[3]);
  s.t1 = make_uint4(t1[0], t1[1], t1[2], t1[3]);
  s.t2a = make_uint4(t2[0], t2[1], t2[2], t2[3]);
  s.t2b = make_uint4(t2[4], t2[5], t2[6], t2[7]);
  return s;
}

// acc[r][j] += x[r] * decode(W[row][col + j]), one FFMA each; xr holds the
// row's MR values of x.
template <int TAG, int MR>
__device__ __forceinline__ void fma_row8(float (&acc)[MR][8], const Row8& s,
                                         const float* xr, int m_h,
                                         uint32_t ei_mask,
                                         const float* __restrict__ scales) {
  float xv[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) xv[r] = xr[r];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int sh = 16 * (j & 1);
    const uint32_t h = (word(s.h, j >> 1) >> sh) & 0xFFFFu;
    const uint32_t t1 = TAG >= 2 ? (word(s.t1, j >> 1) >> sh) & 0xFFFFu : 0u;
    const uint32_t t2 = TAG == 3 ? word(j < 4 ? s.t2a : s.t2b, j & 3) : 0u;
    const float w = decode_dense<TAG>(h, t1, t2, m_h, ei_mask, scales);
#pragma unroll
    for (int r = 0; r < MR; ++r) acc[r][j] = __fmaf_rn(xv[r], w, acc[r][j]);
  }
}

// Block (column tile, K split).  RW rows of W per warp load: a lane owns
// eight columns, so a block covers 256 / RW columns over rows [split *
// rows, +rows) of K (RW = 4 keeps the K splits few on narrow matrices).
// Sub-warp sw = warp * RW + lane / (32 / RW), of 8 * RW, sums rows k0 + sw,
// k0 + sw + 8 * RW, ... in order; the sub-warps' sums are added in order.
// With one split that is y; with more, each block stores its split's sums
// in `part` (splits x M x N), and the last block of a column tile to finish
// (the tile's counter) adds the splits in split order and resets the
// counter for the next launch.  So the result does not depend on which
// block finishes first, and one launch does all of it.
// Registers for three blocks per SM (two at M 8), which the plan's grids
// of just over 2 x 132 blocks rely on to run in one wave.
template <int TAG, typename XT, int MR, int RW, bool VEC>
__global__ void __launch_bounds__(kThreads, MR == 8 ? 2 : 3)
    matmul_gemv_kernel(
    const XT* __restrict__ x, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ scales, float* __restrict__ y,
    float* __restrict__ part, unsigned int* __restrict__ count, int m,
    int64_t kk, int64_t n, int rows, int m_h, uint32_t ei_mask) {
  // Independent rows in flight per lane: 128 bytes of segments; half at
  // M 8, whose 64 sums take the registers, and with scalar loads.
  constexpr int kUnroll =
      (TAG == 1 ? 8 : (TAG == 2 ? 4 : 2)) / (MR == 8 || !VEC ? 2 : 1);
  constexpr int kR = MR < 4 ? MR : 4;  // rows of y reduced per round
  constexpr int kCols = kGemvCols / RW;
  constexpr int kSub = kGemvWarps * RW;
  constexpr int kJ = (MR * kCols + kThreads - 1) / kThreads;
  __shared__ __align__(16) float sm[kGemvSmem];
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int sub = (threadIdx.x >> 5) * RW + lane / (32 / RW);
  const int splits = (int)gridDim.y;
  const int64_t tile0 = (int64_t)blockIdx.x * kCols;
  const int c8 = 8 * (lane % (32 / RW));  // the lane's first column
  const int64_t col = tile0 + c8;
  const int64_t k0 = (int64_t)blockIdx.y * rows;
  const int len = (int)(kk - k0 < rows ? kk - k0 : rows);

  // The block's x as f32, the MR values of a K row side by side.
  for (int e = threadIdx.x; e < len * MR; e += kThreads) {
    const int i = e / MR, r = e % MR;
    sm[e] = r < m ? to_f32(x[(int64_t)r * kk + k0 + i]) : 0.0f;
  }
  __syncthreads();

  float acc[MR][8];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
  if (col < n) {
    const int64_t left = n - col;
    int i = sub;
    for (; i + (kUnroll - 1) * kSub < len; i += kUnroll * kSub) {
      Row8 s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = load_row8<TAG, VEC>(head, tail1, tail2,
                                   (k0 + i + u * kSub) * n + col, left);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        fma_row8<TAG, MR>(acc, s[u], sm + (i + u * kSub) * MR, m_h,
                          ei_mask, scales);
      }
    }
    for (; i < len; i += kSub) {
      const Row8 s = load_row8<TAG, VEC>(head, tail1, tail2,
                                         (k0 + i) * n + col, left);
      fma_row8<TAG, MR>(acc, s, sm + i * MR, m_h, ei_mask, scales);
    }
  }
  __syncthreads();  // x is read: sm takes the sub-warps' sums

  float* out = splits == 1 ? y : part + (int64_t)blockIdx.y * m * n;
#pragma unroll
  for (int r0 = 0; r0 < MR; r0 += kR) {
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      float4* dst = reinterpret_cast<float4*>(
          sm + (sub * kR + rr) * kCols + c8);
      dst[0] = make_float4(acc[r0 + rr][0], acc[r0 + rr][1], acc[r0 + rr][2],
                           acc[r0 + rr][3]);
      dst[1] = make_float4(acc[r0 + rr][4], acc[r0 + rr][5], acc[r0 + rr][6],
                           acc[r0 + rr][7]);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kR * kCols; e += kThreads) {
      const int rr = e / kCols, c = e % kCols;
      if (r0 + rr < m && tile0 + c < n) {
        float s = sm[rr * kCols + c];
        for (int w = 1; w < kSub; ++w) {
          s = __fadd_rn(s, sm[(w * kR + rr) * kCols + c]);
        }
        out[(int64_t)(r0 + rr) * n + tile0 + c] = s;
      }
    }
    __syncthreads();
  }
  if (splits == 1) return;

  // The last block of the column tile adds the splits in order, four
  // splits' loads in flight for each of its outputs at once.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count + blockIdx.x, 1u) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s[kJ];
  const float* p[kJ];
  bool ok[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / kCols, c = e % kCols;
    ok[j] = r < m && tile0 + c < n;
    p[j] = part + (int64_t)r * n + tile0 + c;
    s[j] = -0.0f;  // -0 + v == v for every v
  }
  const int64_t pitch = (int64_t)m * n;
  for (int sp0 = 0; sp0 < splits; sp0 += 4) {
    float v[kJ][4];
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[j][u] = ok[j] && sp0 + u < splits ? __ldcg(p[j] + (sp0 + u) * pitch)
                                            : 0.0f;
      }
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (sp0 + u < splits) s[j] = __fadd_rn(s[j], v[j][u]);
      }
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (ok[j]) y[p[j] - part] = s[j];
  }
  if (threadIdx.x == 0) count[blockIdx.x] = 0u;
}

// The earlier GEMV design, kept only as the yardstick chip_smoke.py times
// the split-K body against (no model path launches it): a block owns 64
// columns (two 2-byte loads per lane and segment), its eight warps split
// K with four rows in flight, so the grid is N / 64 blocks.
constexpr int kGemv64Cols = 64;
constexpr int kGemv64Chunk = 256;

template <int TAG, typename XT, int MR>
__global__ void __launch_bounds__(kThreads) matmul_gemv64_kernel(
    const XT* __restrict__ x, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ scales, float* __restrict__ y, int m, int64_t kk,
    int64_t n, int m_h, uint32_t ei_mask) {
  __shared__ float xs[MR][kGemv64Chunk];
  __shared__ float red[kGemvWarps][MR][kGemv64Cols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t col0 = (int64_t)blockIdx.x * kGemv64Cols + 2 * lane;
  const bool ok0 = col0 < n, ok1 = col0 + 1 < n;
  float acc[MR][2];
#pragma unroll
  for (int r = 0; r < MR; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int64_t k0 = 0; k0 < kk; k0 += kGemv64Chunk) {
    const int len = kk - k0 < kGemv64Chunk ? (int)(kk - k0) : kGemv64Chunk;
    __syncthreads();
    for (int e = threadIdx.x; e < MR * kGemv64Chunk; e += kThreads) {
      const int r = e / kGemv64Chunk, c = e % kGemv64Chunk;
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
  for (int e = threadIdx.x; e < MR * kGemv64Cols; e += kThreads) {
    const int r = e / kGemv64Cols, c = e % kGemv64Cols;
    const int64_t col = (int64_t)blockIdx.x * kGemv64Cols + c;
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

// The split-K GEMV at MR >= m rows of x: grid (column tiles, splits).
// RW = 4 only with vector loads (the plan's narrow tiles).
template <int TAG, typename XT, int MR>
void launch_gemv(const XT* x, const uint16_t* h, const uint16_t* t1,
                 const uint32_t* t2, const float* scales, float* y, float* part,
                 unsigned int* count, int m, int64_t kk, int64_t n, int rows,
                 int splits, int rw, bool vec, int m_h, uint32_t mask,
                 cudaStream_t st) {
  const int cols = kGemvCols / rw;
  const dim3 grid((unsigned)((n + cols - 1) / cols), (unsigned)splits);
  if (vec && rw == 4) {
    matmul_gemv_kernel<TAG, XT, MR, 4, true><<<grid, kThreads, 0, st>>>(
        x, h, t1, t2, scales, y, part, count, m, kk, n, rows, m_h, mask);
  } else if (vec) {
    matmul_gemv_kernel<TAG, XT, MR, 1, true><<<grid, kThreads, 0, st>>>(
        x, h, t1, t2, scales, y, part, count, m, kk, n, rows, m_h, mask);
  } else {
    matmul_gemv_kernel<TAG, XT, MR, 1, false><<<grid, kThreads, 0, st>>>(
        x, h, t1, t2, scales, y, part, count, m, kk, n, rows, m_h, mask);
  }
}

template <int TAG, typename XT>
void launch_matmul(const void* x, const void* head, const void* tail1,
                   const void* tail2, const float* scales, float* y, int64_t m,
                   int64_t kk, int64_t n, int ei_bit, float* part,
                   unsigned int* count, int rows, int splits, int rw,
                   bool vec, cudaStream_t st) {
  const int m_h = 15 - ei_bit;
  const uint32_t mask = (1u << ei_bit) - 1u;
  const XT* xp = (const XT*)x;
  const uint16_t* h = (const uint16_t*)head;
  const uint16_t* t1 = (const uint16_t*)tail1;
  const uint32_t* t2 = (const uint32_t*)tail2;
  if (m <= 8) {
    const int mi = (int)m;
    if (m <= 1) {
      launch_gemv<TAG, XT, 1>(xp, h, t1, t2, scales, y, part, count, mi, kk,
                              n, rows, splits, rw, vec, m_h, mask, st);
    } else if (m <= 2) {
      launch_gemv<TAG, XT, 2>(xp, h, t1, t2, scales, y, part, count, mi, kk,
                              n, rows, splits, rw, vec, m_h, mask, st);
    } else if (m <= 4) {
      launch_gemv<TAG, XT, 4>(xp, h, t1, t2, scales, y, part, count, mi, kk,
                              n, rows, splits, rw, vec, m_h, mask, st);
    } else {
      launch_gemv<TAG, XT, 8>(xp, h, t1, t2, scales, y, part, count, mi, kk,
                              n, rows, splits, rw, vec, m_h, mask, st);
    }
    return;
  }
  const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                  (unsigned)((m + kBM - 1) / kBM));
  matmul_tiled_kernel<TAG, XT><<<grid, kThreads, 0, st>>>(
      xp, h, t1, t2, scales, y, m, kk, n, m_h, mask);
}

template <int TAG, typename XT>
void launch_gemv64(const void* x, const void* head, const void* tail1,
                   const void* tail2, const float* scales, float* y, int64_t m,
                   int64_t kk, int64_t n, int ei_bit, cudaStream_t st) {
  const int m_h = 15 - ei_bit;
  const uint32_t mask = (1u << ei_bit) - 1u;
  const XT* xp = (const XT*)x;
  const uint16_t* h = (const uint16_t*)head;
  const uint16_t* t1 = (const uint16_t*)tail1;
  const uint32_t* t2 = (const uint32_t*)tail2;
  const dim3 grid((unsigned)((n + kGemv64Cols - 1) / kGemv64Cols));
  if (m <= 4) {
    matmul_gemv64_kernel<TAG, XT, 4><<<grid, kThreads, 0, st>>>(
        xp, h, t1, t2, scales, y, (int)m, kk, n, m_h, mask);
  } else {
    matmul_gemv64_kernel<TAG, XT, 8><<<grid, kThreads, 0, st>>>(
        xp, h, t1, t2, scales, y, (int)m, kk, n, m_h, mask);
  }
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

// m <= 8 takes the split-K GEMV: `rows` K rows per split, `splits` splits
// (the wrapper's plan: (splits - 1) * rows < kk <= splits * rows, rows <=
// 8192 / MR), column tiles of 256 / rw (rw 1 or 4), `part` holds splits x m x n
// floats, `count` one zero per column tile (the kernel leaves them zero),
// `vec` says every segment pointer is 16-byte aligned and n % 8 == 0 (rw 4
// needs it).  Above 8 they are not read.
extern "C" int gse_matmul_dense(int tag, int x_bf16, const void* x,
                                const void* head, const void* tail1,
                                const void* tail2, const float* scales,
                                float* y, long long m, long long kk,
                                long long n, int ei_bit, float* part,
                                unsigned int* count, int rows, int splits,
                                int rw, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int mr = m <= 1 ? 1 : (m <= 2 ? 2 : (m <= 4 ? 4 : 8));
  if (m > 0 && m <= 8 && n > 0 &&
      (kk <= 0 || rows <= 0 || rows * mr > kGemvSmem || splits > 65535 ||
       (rw != 1 && rw != 4) || (rw == 4 && !vec) ||
                          (long long)(splits - 1) * rows >= kk ||
                          (long long)splits * rows < kk)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m > 0 && n > 0) {
    if (x_bf16) {
      if (tag == 1) launch_matmul<1, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, part, count, rows, splits, rw, vec != 0, st);
      else if (tag == 2) launch_matmul<2, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, part, count, rows, splits, rw, vec != 0, st);
      else launch_matmul<3, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, part, count, rows, splits, rw, vec != 0, st);
    } else {
      if (tag == 1) launch_matmul<1, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, part, count, rows, splits, rw, vec != 0, st);
      else if (tag == 2) launch_matmul<2, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, part, count, rows, splits, rw, vec != 0, st);
      else launch_matmul<3, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, part, count, rows, splits, rw, vec != 0, st);
    }
  }
  return (int)cudaGetLastError();
}

// The earlier GEMV design (matmul_gemv64_kernel), m <= 8: timed beside the
// split-K body only.
extern "C" int gse_matmul_dense_gemv64(int tag, int x_bf16, const void* x,
                                       const void* head, const void* tail1,
                                       const void* tail2, const float* scales,
                                       float* y, long long m, long long kk,
                                       long long n, int ei_bit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m > 8) return (int)cudaErrorInvalidValue;
  if (m > 0 && n > 0) {
    if (x_bf16) {
      if (tag == 1) launch_gemv64<1, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else if (tag == 2) launch_gemv64<2, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else launch_gemv64<3, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
    } else {
      if (tag == 1) launch_gemv64<1, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else if (tag == 2) launch_gemv64<2, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else launch_gemv64<3, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
    }
  }
  return (int)cudaGetLastError();
}
