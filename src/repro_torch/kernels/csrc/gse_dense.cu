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
//   - M > 8, prefill (M = B * S): the tiled body on the tensor cores,
//     split TF32 (design (a) of the two the accuracy allows; see the note
//     above matmul_tc_kernel).  128 x 128 output tiles, K in steps of 32;
//     each W tile is decoded once per block into shared memory, split
//     there into two TF32 terms per weight, and serves all 128 rows of the
//     block's X tile through mma.sync m16n8k8.  Bound by the TF32 tensor
//     cores at prefill sizes (2 M N K operations per term).  The earlier
//     FFMA tile (64 x 64, 4 x 4 per thread) is kept as
//     gse_matmul_dense_tiled64, timed beside it only.
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

// --- E, M > 8: the earlier tiled body (FFMA) ---------------------------------
//
// The earlier design, kept only as the yardstick chip_smoke.py times the
// tensor-core body against (no model path launches it): 64 x 64 tiles, K
// in steps of 16, single-buffered, a 4 x 4 block of FFMA sums per thread.

constexpr int kBM = 64, kBN = 64, kBK = 16;

template <int TAG, typename XT>
__global__ void __launch_bounds__(kThreads) matmul_tiled64_kernel(
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

// --- E, M > 8: the tiled body on the tensor cores (split TF32) ---------------
//
// What bounds it: operations.  At prefill sizes (M = B * S = 2048) each
// decoded weight serves M rows, far above the card's ~295 operations per
// byte, so the multiply-adds are the limit, not the weight stream.  The
// FFMA tile above reached about a quarter of the FP32 peak (67 TFLOP/s);
// the TF32 tensor cores offer 495 TFLOP/s.
//
// Accuracy, and why design (a), split TF32.  The oracle is a full-f32
// product held at rtol 1e-5 / atol 1e-4 up to K = 9728 (w_down), so one
// TF32 MMA of the decoded weight (11 significant bits) cannot carry tag-2
// and tag-3 weights.  Each decoded weight w is split into two TF32 terms,
// hi = tf32(w) and lo = tf32(w - hi), so w = hi + lo + r with |r| <=
// 2^-22 |w|.  A bf16 x (the served compute dtype) is exact in TF32, so
// x.hi and x.lo are exact products and y carries only r's error.  An f32
// x (the f32 twin only) is split the same way and adds the third term
// x_lo.hi (3xTF32); x_lo.lo (2^-22) is dropped.  The tensor cores add in
// f32 but not with IEEE round-to-nearest (their alignment truncates), and
// over K = 9728 that bias could reach atol.  So the MMA accumulator only
// carries kTcSumK = 64 rows of K (16 or 24 MMAs, partial sums of a few
// products), and each partial is added into a second f32 sum with
// __fadd_rn, in K order: the long sum rounds as an FFMA loop would.
// Design (b), a register-blocked FFMA tile, would stay at the FP32 peak,
// 7.4x below the TF32 rate even with two terms.
//
// Layout: 128 x 128 output tiles, 256 threads = 8 warps of 64 x 32 (2 x 4
// warps), each warp 4 x 4 mma.sync m16n8k8 tiles; one block per SM (the
// two sums take 128 registers a thread).  Per K step of 32 the block
// stages the X tile (128 x 32) and the W tile (32 x 128) in shared memory
// as TF32 terms, double-buffered: the segments and x of step k + 1 are
// loaded into registers (16-byte loads where aligned) before step k's
// MMAs are issued, then decoded and split into the other buffers between
// its last MMAs, so the decode overlaps the tensor cores and one barrier a
// step separates the buffers.  The decode and the split run once per
// weight per block.  Rows of the tiles are padded (36 and 136 words) so
// every fragment read is free of bank conflicts.  The sums are in a fixed
// order and the kernel uses no atomics, so two calls give the same bits.

constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 32;
constexpr int kTcThreads = 256;
constexpr int kTcAPitch = kTcBK + 4;  // floats per row of the X tile
constexpr int kTcWPitch = kTcBN + 8;  // floats per K row of the W tile
constexpr int kTcAStage = kTcBM * kTcAPitch;
constexpr int kTcWStage = kTcBK * kTcWPitch;
constexpr int kTcSumK = 2 * kTcBK;  // K rows per MMA partial

template <typename XT> struct IsF32 { static constexpr bool value = false; };
template <> struct IsF32<float> { static constexpr bool value = true; };

// TF32 by bit operations: the significand rounded to 10 explicit bits, to
// nearest with ties away from zero (cvt.rna's rounding), and the 13 bits
// the tensor cores ignore cleared.  Finite inputs only.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo + r, |r| <= 2^-22 |v|; v - hi is exact in f32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(__fsub_rn(v, __uint_as_float(hi)));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 in, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ld_vec(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// One thread's share of a K step, as loaded: 16 weights of one K row
// (heads, tail1, tail2) and 16 values of one row of x (bf16: two words,
// f32: four).
struct TcStage {
  uint4 h[2], t1[2], t2[4], x[4];
};

// Thread t loads W row k0 + t / 8, columns col0 + 16 (t % 8) + [0, 16),
// and x row row0 + t / 2, columns k0 + 16 (t % 2) + [0, 16); rows of K
// from kend on (the end of the block's K split), and rows and columns out
// of range, read as 0.  VEC: 16-byte loads (the wrapper checked that N and
// K are multiples of 8 and every pointer is 16-byte aligned, and splits
// end at multiples of kTcSumK, so a load is all in range or all out).
template <int TAG, typename XT, bool VEC>
__device__ __forceinline__ void tc_load(
    TcStage& s, const XT* __restrict__ x, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    int64_t m, int64_t kk, int64_t kend, int64_t n, int64_t row0,
    int64_t col0, int64_t k0) {
  constexpr bool kF32 = IsF32<XT>::value;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int t = threadIdx.x;
  const int64_t k = k0 + (t >> 3), c = col0 + (t & 7) * 16;
  const int64_t r = row0 + (t >> 1), kx = k0 + (t & 1) * 16;
  if (VEC) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool ok = k < kend && c + 8 * q < n;
      const int64_t i = k * n + c + 8 * q;
      s.h[q] = ok ? ld_vec(head + i) : zero;
      if (TAG >= 2) s.t1[q] = ok ? ld_vec(tail1 + i) : zero;
      if (TAG == 3) {
        s.t2[2 * q] = ok ? ld_vec(tail2 + i) : zero;
        s.t2[2 * q + 1] = ok ? ld_vec(tail2 + i + 4) : zero;
      }
    }
    constexpr int kPer = kF32 ? 4 : 8;  // x values per 16-byte load
#pragma unroll
    for (int q = 0; q < 16 / kPer; ++q) {
      const bool ok = r < m && kx + kPer * q < kend;
      s.x[q] = ok ? ld_vec(x + r * kk + kx + kPer * q) : zero;
    }
    return;
  }
  uint32_t h[8], t1[8], t2[16], xw[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = t1[j] = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    t2[j] = 0u;
    xw[j] = 0u;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int sh = 16 * (j & 1);
    if (k < kend && c + j < n) {
      const int64_t i = k * n + c + j;
      h[j >> 1] |= (uint32_t)__ldg(head + i) << sh;
      if (TAG >= 2) t1[j >> 1] |= (uint32_t)__ldg(tail1 + i) << sh;
      if (TAG == 3) t2[j] = __ldg(tail2 + i);
    }
    if (r < m && kx + j < kend) {
      const XT v = x[r * kk + kx + j];
      if (kF32) {
        xw[j] = __float_as_uint(to_f32(v));
      } else {
        xw[j >> 1] |= (__float_as_uint(to_f32(v)) >> 16) << sh;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    s.h[q] = make_uint4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    s.t1[q] = make_uint4(t1[4 * q], t1[4 * q + 1], t1[4 * q + 2],
                         t1[4 * q + 3]);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    s.t2[q] = make_uint4(t2[4 * q], t2[4 * q + 1], t2[4 * q + 2],
                         t2[4 * q + 3]);
    s.x[q] = make_uint4(xw[4 * q], xw[4 * q + 1], xw[4 * q + 2],
                        xw[4 * q + 3]);
  }
}

// A quarter q of the staged step into shared memory (weights and x
// values 4q .. 4q + 3 of the thread's 16), so the next step's decode can
// be spread between the current step's MMAs: W decoded with decode_dense
// (D's decode, so E's tiled weights are D's) and split into its two TF32
// terms; x as f32 bits (a bf16 value widened, exact in TF32) or, for an
// f32 x, split the same way.
template <int TAG, typename XT>
__device__ __forceinline__ void tc_store_quarter(
    const TcStage& s, int q, uint32_t* a_hi, uint32_t* a_lo, uint32_t* w_hi,
    uint32_t* w_lo, int m_h, uint32_t ei_mask,
    const float* __restrict__ scales) {
  constexpr bool kF32 = IsF32<XT>::value;
  const int t = threadIdx.x;
  const int wo = (t >> 3) * kTcWPitch + (t & 7) * 16 + 4 * q;
  const int ao = (t >> 1) * kTcAPitch + (t & 1) * 16 + 4 * q;
  uint32_t wh[4], wl[4], ah[4], al[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 4 * q + e;
    const int sh = 16 * (j & 1);
    const uint32_t h = (word(s.h[j >> 3], (j >> 1) & 3) >> sh) & 0xFFFFu;
    const uint32_t t1 =
        TAG >= 2 ? (word(s.t1[j >> 3], (j >> 1) & 3) >> sh) & 0xFFFFu : 0u;
    const uint32_t t2 = TAG == 3 ? word(s.t2[j >> 2], j & 3) : 0u;
    split_tf32(decode_dense<TAG>(h, t1, t2, m_h, ei_mask, scales), wh[e],
               wl[e]);
    if (kF32) {
      split_tf32(__uint_as_float(word(s.x[j >> 2], j & 3)), ah[e], al[e]);
    } else {
      ah[e] = ((word(s.x[j >> 3], (j >> 1) & 3) >> sh) & 0xFFFFu) << 16;
    }
  }
  *reinterpret_cast<uint4*>(w_hi + wo) = make_uint4(wh[0], wh[1], wh[2], wh[3]);
  *reinterpret_cast<uint4*>(w_lo + wo) = make_uint4(wl[0], wl[1], wl[2], wl[3]);
  *reinterpret_cast<uint4*>(a_hi + ao) = make_uint4(ah[0], ah[1], ah[2], ah[3]);
  if (kF32) {
    *reinterpret_cast<uint4*>(a_lo + ao) =
        make_uint4(al[0], al[1], al[2], al[3]);
  }
}

// Shared memory of the tiled body, in 32-bit words: x hi and lo, W hi and
// lo, each double-buffered (x lo is written for an f32 x only).
constexpr int kTcSmem =
    4 * (kTcAStage + kTcWStage) * (int)sizeof(uint32_t);

// Block (column tile, row tile, K split): rows [z * rows, (z + 1) * rows)
// of K.  With one split the block writes y; with more, each writes its
// split's sums to `part` (splits x m x n), and the last block of the tile
// to finish (the tile's counter) adds the splits in split order into y
// and resets the counter for the next launch, as the GEMV body does.
template <int TAG, typename XT, bool VEC>
__global__ void __launch_bounds__(kTcThreads, 1) matmul_tc_kernel(
    const XT* __restrict__ x, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ scales, float* __restrict__ y,
    float* __restrict__ part, unsigned int* __restrict__ count, int64_t m,
    int64_t kk, int64_t n, int64_t rows, int m_h, uint32_t ei_mask) {
  constexpr bool kF32 = IsF32<XT>::value;
  extern __shared__ __align__(16) uint32_t tc_smem[];
  uint32_t* const a_hi = tc_smem;
  uint32_t* const a_lo = a_hi + 2 * kTcAStage;
  uint32_t* const w_hi = a_lo + 2 * kTcAStage;
  uint32_t* const w_lo = w_hi + 2 * kTcWStage;
  const int64_t row0 = (int64_t)blockIdx.y * kTcBM;
  const int64_t col0 = (int64_t)blockIdx.x * kTcBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // The warp's fragment offsets: rows (warp / 4) * 64 + g of X, columns
  // (warp % 4) * 32 + g of W; K columns tq (X) and rows tq (W).
  const int af = ((warp >> 2) * 64 + g) * kTcAPitch + tq;
  const int wf = tq * kTcWPitch + (warp & 3) * 32 + g;
  float acc[4][4][4], win[4][4][4];  // the sum, the MMA partial
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = win[mi][ni][e] = 0.0f;
  const int64_t kbeg = (int64_t)blockIdx.z * rows;
  const int64_t kend = kbeg + rows < kk ? kbeg + rows : kk;
  const int64_t steps = (kend - kbeg + kTcBK - 1) / kTcBK;
  TcStage st;
  tc_load<TAG, XT, VEC>(st, x, head, tail1, tail2, m, kk, kend, n, row0,
                        col0, kbeg);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    tc_store_quarter<TAG, XT>(st, q, a_hi, a_lo, w_hi, w_lo, m_h, ei_mask,
                              scales);
  }
  __syncthreads();
  for (int64_t s = 0; s < steps; ++s) {
    const int ca = (int)(s & 1) * kTcAStage, na = kTcAStage - ca;
    const int cw = (int)(s & 1) * kTcWStage, nw = kTcWStage - cw;
    // The next step's segments and x (all out of range, so no load, after
    // the last step), decoded between this step's MMAs into the other
    // buffers.
    tc_load<TAG, XT, VEC>(st, x, head, tail1, tail2, m, kk, kend, n, row0,
                          col0, kbeg + (s + 1) * kTcBK);
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int o = cw + wf + ks * kTcWPitch + ni * 8;
        bh[ni][0] = w_hi[o];
        bh[ni][1] = w_hi[o + 4 * kTcWPitch];
        bl[ni][0] = w_lo[o];
        bl[ni][1] = w_lo[o + 4 * kTcWPitch];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int o = ca + af + mi * 16 * kTcAPitch + ks;
        const uint32_t ah[4] = {a_hi[o], a_hi[o + 8 * kTcAPitch], a_hi[o + 4],
                                a_hi[o + 8 * kTcAPitch + 4]};
        // Term by term over the four column tiles, so no MMA waits on the
        // one before it.
        if (kF32) {
          const uint32_t al[4] = {a_lo[o], a_lo[o + 8 * kTcAPitch],
                                  a_lo[o + 4], a_lo[o + 8 * kTcAPitch + 4]};
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            mma_tf32(win[mi][ni], al, bh[ni][0], bh[ni][1]);
          }
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(win[mi][ni], ah, bl[ni][0], bl[ni][1]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(win[mi][ni], ah, bh[ni][0], bh[ni][1]);
        }
      }
      // The decode waits on the loads above, so it starts halfway through
      // the step's MMAs: two quarters after each of the last two K slices.
      if (ks >= kTcBK / 2) {
#pragma unroll
        for (int q = 2 * (ks / 8) - 4; q < 2 * (ks / 8) - 2; ++q) {
          tc_store_quarter<TAG, XT>(st, q, a_hi + na, a_lo + na, w_hi + nw,
                                    w_lo + nw, m_h, ei_mask, scales);
        }
      }
    }
    // The MMA partial covers kTcSumK rows of K; then it joins the sum.
    if ((s & 1) || s + 1 == steps) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], win[mi][ni][e]);
            win[mi][ni][e] = 0.0f;
          }
    }
    __syncthreads();
  }
  const int splits = (int)gridDim.z;
  float* const out = splits == 1 ? y : part + (int64_t)blockIdx.z * m * n;
  const int64_t rb = row0 + (warp >> 2) * 64 + g;
  const int64_t cb = col0 + (warp & 3) * 32 + 2 * tq;
  const bool pairs = (n & 1) == 0;  // (row * n + even col) is 8-byte aligned
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t r = rb + mi * 16 + half * 8;
      if (r >= m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int64_t c = cb + ni * 8;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (pairs && c + 1 < n) {
          *reinterpret_cast<float2*>(out + r * n + c) = make_float2(v0, v1);
        } else {
          if (c < n) out[r * n + c] = v0;
          if (c + 1 < n) out[r * n + c + 1] = v1;
        }
      }
    }
  if (splits == 1) return;
  __shared__ bool last;
  const unsigned int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count + tile, 1u) == (unsigned)(splits - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t pitch = m * n;
  for (int e = threadIdx.x; e < kTcBM * kTcBN; e += kTcThreads) {
    const int64_t r = row0 + e / kTcBN, c = col0 + e % kTcBN;
    if (r >= m || c >= n) continue;
    const float* p = part + r * n + c;
    float v = __ldcg(p);
    for (int z = 1; z < splits; ++z) v = __fadd_rn(v, __ldcg(p + z * pitch));
    y[r * n + c] = v;
  }
  if (threadIdx.x == 0) count[tile] = 0u;
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
  const dim3 grid((unsigned)((n + kTcBN - 1) / kTcBN),
                  (unsigned)((m + kTcBM - 1) / kTcBM), (unsigned)splits);
  const int64_t krows = splits == 1 ? kk : rows;
  if (vec) {
    cudaFuncSetAttribute(matmul_tc_kernel<TAG, XT, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    matmul_tc_kernel<TAG, XT, true><<<grid, kTcThreads, kTcSmem, st>>>(
        xp, h, t1, t2, scales, y, part, count, m, kk, n, krows, m_h, mask);
  } else {
    cudaFuncSetAttribute(matmul_tc_kernel<TAG, XT, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    matmul_tc_kernel<TAG, XT, false><<<grid, kTcThreads, kTcSmem, st>>>(
        xp, h, t1, t2, scales, y, part, count, m, kk, n, krows, m_h, mask);
  }
}

template <int TAG, typename XT>
void launch_tiled64(const void* x, const void* head, const void* tail1,
                    const void* tail2, const float* scales, float* y,
                    int64_t m, int64_t kk, int64_t n, int ei_bit,
                    cudaStream_t st) {
  const dim3 grid((unsigned)((n + kBN - 1) / kBN),
                  (unsigned)((m + kBM - 1) / kBM));
  matmul_tiled64_kernel<TAG, XT><<<grid, kThreads, 0, st>>>(
      (const XT*)x, (const uint16_t*)head, (const uint16_t*)tail1,
      (const uint32_t*)tail2, scales, y, m, kk, n, 15 - ei_bit,
      (1u << ei_bit) - 1u);
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
// needs it).  Above 8 the tiled body splits K into `splits` runs of `rows`
// (a multiple of kTcSumK; rows is not read at one split), with the same
// `part` (splits x m x n floats) and `count` (one zero per output tile)
// when splits > 1, and `vec` says more: kk % 8 == 0 and x 16-byte
// aligned too.
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
  if (m > 8 && n > 0 &&
      ((m + kTcBM - 1) / kTcBM > 65535 || splits < 1 || splits > 65535 ||
       (splits > 1 &&
        (rows <= 0 || rows % kTcSumK != 0 || part == nullptr ||
         count == nullptr || (long long)(splits - 1) * rows >= kk ||
         (long long)splits * rows < kk)))) {
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

// The earlier tiled design (matmul_tiled64_kernel), m > 8: timed beside
// the tensor-core body only.
extern "C" int gse_matmul_dense_tiled64(int tag, int x_bf16, const void* x,
                                        const void* head, const void* tail1,
                                        const void* tail2, const float* scales,
                                        float* y, long long m, long long kk,
                                        long long n, int ei_bit,
                                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m <= 8 || (m + kBM - 1) / kBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    if (x_bf16) {
      if (tag == 1) launch_tiled64<1, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else if (tag == 2) launch_tiled64<2, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else launch_tiled64<3, __nv_bfloat16>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
    } else {
      if (tag == 1) launch_tiled64<1, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else if (tag == 2) launch_tiled64<2, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
      else launch_tiled64<3, float>(x, head, tail1, tail2, scales, y, m, kk, n, ei_bit, st);
    }
  }
  return (int)cudaGetLastError();
}
