// Kernel F on Hopper: causal or full softmax attention with an online
// softmax, GQA without repeating K and V.
//
// Replaces the Pallas kernel `flash_attention_pallas` (src/repro/kernels/
// flash_attn.py:76, body `_flash_body`, `pallas_call` :89).  The function
// is the same: scores = (q . k) * 1/sqrt(hd) in f32 from q, k, v cast to
// f32, causal positions filled with -1e30 on global indices (key j <= query
// i), the running max m, sum l and accumulator acc updated per key tile
// (corr = exp(m_prev - m_new), p = exp(s - m_new), l = l * corr + sum p,
// acc = acc * corr + p v), and out = acc / max(l, 1e-30) in q's dtype.
// The (S, T) score matrix never exists in device memory.
//
// Layout: q (B, S, H, hd) and k, v (B, T, KV, hd), read through element
// strides (the last dimension contiguous), as the model holds them; query
// head h reads KV head h / (H / KV), the grouping of the reference's
// `_attend`.  The output is a contiguous (B, S, H, hd).
//
// Two bodies; the wrapper picks one from the dtype and hd before launch.
//
// * The tensor-core body (`flash_fwd_mma_kernel`): bf16 q, k, v with hd a
//   multiple of 16 (<= 128), the model's prefill, compiled for each hd so
//   that its loops unroll whole (a run-time hd kept them from it).  One
//   block per (batch * head, query tile of 128), eight warps of 16
//   queries; the Q fragments stay in registers and the K and V tiles of 64
//   keys are double-buffered in shared memory with cp.async, one barrier
//   per tile.  Both products run on mma.sync m16n8k16 bf16 -> f32: Q K^T
//   is the reference's f32 dot of bf16 values (each product exact in f32;
//   only the order of the sum differs), and P V takes P rounded to bf16
//   (relative error 2^-9 per probability) with f32 sums.  The softmax is
//   f32 (ex2.approx of the scores times log2 e).  Tiles above the diagonal
//   are skipped, per block and per warp; only the tiles that cross the
//   diagonal or T are masked.  Bound by operations on the bf16 tensor
//   cores: 4 * S * T * hd per (batch, head), halved when causal, over 989
//   TFLOP/s.
//
// * The FFMA body (`flash_fwd_kernel`): f32 (the f32 twin's model), and
//   bf16 with hd not a multiple of 16.  One block per (query tile of 64,
//   batch * head): it keeps its Q tile, one K and one V tile of 64 keys and
//   the probabilities in shared memory as f32 (rows padded by one word
//   against bank conflicts), walks the key tiles in order, and skips the
//   tiles above the diagonal when causal.  Four threads own a query row:
//   each computes 16 of the tile's 64 scores and hd / 4 of the row's
//   accumulator; the row's max and sum go over the four lanes with
//   shuffles.  Bound by FP32 operations (67 TFLOP/s): it does the same
//   4 * S * T * hd in FFMA from shared memory, as the f32 oracle does.
//
// Both: any S and T run (keys past T get probability 0, queries past S are
// not written); skipping a tile above the diagonal changes nothing, since
// its probabilities are exact zeros.  hd <= 128.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;  // four per query row
constexpr int kHdMax = 128;
constexpr int kScores = kBK / 4;   // per thread
constexpr int kAcc = kHdMax / 4;   // per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int s_len, int t_len, int heads, int kv_heads, int hd,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
    float scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* qs = smem;                  // kBQ x hdp
  float* ks = qs + kBQ * hdp;        // kBK x hdp
  float* vs = ks + kBK * hdp;        // kBK x hd
  float* ps = vs + kBK * hd;         // kBQ x (kBK + 1)

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int qi = q0 + row;

  const T* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  for (int e = threadIdx.x; e < kBQ * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    qs[r * hdp + d] = q0 + r < s_len ? to_f32(qb[(int64_t)(q0 + r) * q_ss + d])
                                     : 0.0f;
  }

  float m_i = kNegInf, l_i = 0.0f;
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;

  const int kv_end = causal ? min(t_len, q0 + kBQ) : t_len;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = threadIdx.x; e < kBK * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      const bool in = kv0 + j < t_len;
      ks[j * hdp + d] = in ? to_f32(kb[(int64_t)(kv0 + j) * k_ss + d]) : 0.0f;
      vs[j * hd + d] = in ? to_f32(vb[(int64_t)(kv0 + j) * v_ss + d]) : 0.0f;
    }
    __syncthreads();

    float s[kScores];
#pragma unroll
    for (int jj = 0; jj < kScores; ++jj) s[jj] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float qd = qs[row * hdp + d];
#pragma unroll
      for (int jj = 0; jj < kScores; ++jj) {
        s[jj] = __fmaf_rn(qd, ks[(sub + 4 * jj) * hdp + d], s[jj]);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kScores; ++jj) {
      const int kj = kv0 + sub + 4 * jj;
      float sc = __fmul_rn(s[jj], scale);
      if (kj >= t_len) sc = -INFINITY;         // no such key: p = 0
      else if (causal && kj > qi) sc = kNegInf;  // the reference's fill
      s[jj] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kScores; ++jj) {
      const float p = expf(s[jj] - m_new);
      ps[row * (kBK + 1) + sub + 4 * jj] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_i = l_i * corr + rs;
    m_i = m_new;
    __syncwarp();  // the row's four threads share one warp
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int d = sub + 4 * a;
      if (d < hd) {
        float pv = 0.0f;
        for (int j = 0; j < kBK; ++j) {
          pv = __fmaf_rn(ps[row * (kBK + 1) + j], vs[j * hd + d], pv);
        }
        acc[a] = acc[a] * corr + pv;
      }
    }
    __syncwarp();
  }

  if (qi < s_len) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* ob = o + (((int64_t)b * s_len + qi) * heads + h) * hd;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int d = sub + 4 * a;
      if (d < hd) store(ob + d, acc[a] / denom);
    }
  }
}

// --- the tensor-core body: bf16 q, k, v, hd a multiple of 16 --------------

constexpr int kMmaBQ = 128;               // queries per block: 16 per warp
constexpr int kMmaBK = 64;                // keys per tile
constexpr int kMmaWarps = kMmaBQ / 16;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + R) of a bf16 (rows, HD) view with a pitch of `ld` elements
// into shared rows of HD + 8 elements, by 16-byte cp.async; rows at or past
// `limit` are filled with zeros.
template <int R, int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t ld, int r0, int limit) {
  constexpr int kChunks = HD / 8;
  constexpr int kIters = (R * kChunks + kMmaThreads - 1) / kMmaThreads;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    if (R * kChunks % kMmaThreads == 0 || e < R * kChunks) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const bool ok = r0 + r < limit;
      cp_async16(dst + r * (HD + 8) + c,
                 ok ? src + (int64_t)(r0 + r) * ld + c : src, ok);
    }
  }
}

// One block per (batch * head, query tile of 128), the longest causal tiles
// first.  Warp w owns queries q0 + 16w .. +15: its Q fragments stay in
// registers; the K and V tiles of 64 keys are double-buffered in shared
// memory (cp.async).  Per key tile: S = Q K^T with mma m16n8k16 (bf16 in,
// f32 sums: the products of two bf16 values are exact in f32, as in the
// reference's f32 dot), the scale, the masks (only on tiles that cross the
// diagonal or T), the online softmax in f32 (exp2 of the scores times
// log2 e), then O += P V with P rounded to bf16 and f32 sums.  A warp skips
// a tile whose keys all lie above its queries.  The output tile is staged
// in shared memory and stored with 16-byte writes.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int s_len, int t_len,
    int heads, int kv_heads, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int causal, float scale) {
  constexpr int kLd = HD + 8;  // padded rows: ldmatrix without conflicts
  constexpr int kDk = HD / 16;
  constexpr int kDt = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kMmaBQ rows, then O
  bf16* ks = qs + kMmaBQ * kLd;                   // 2 x kMmaBK rows
  bf16* vs = ks + 2 * kMmaBK * kLd;               // 2 x kMmaBK rows

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kMmaBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wq0 = q0 + warp * 16;  // the warp's first query
  const bf16* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const bf16* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const bf16* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

  load_tile<kMmaBQ, HD>(qs, qb, q_ss, q0, s_len);
  cp_async_commit();
  const int kv_end = causal ? min(t_len, q0 + kMmaBQ) : t_len;
  const int ntiles = (kv_end + kMmaBK - 1) / kMmaBK;
  if (ntiles > 0) {
    load_tile<kMmaBK, HD>(ks, kb, k_ss, 0, t_len);
    load_tile<kMmaBK, HD>(vs, vb, v_ss, 0, t_len);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qf[kDk][4];
#pragma unroll
  for (int kk = 0; kk < kDk; ++kk) {
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                        (lane >> 4) * 8);
  }

  float acc[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_r[2] = {0.0f, 0.0f};            // this thread's part of the sum

  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t * kMmaBK;
    const int buf = t & 1;
    cp_async_wait<0>();  // tile t has landed ...
    __syncthreads();     // ... for every thread, and tile t - 1 is read
    if (t + 1 < ntiles) {
      load_tile<kMmaBK, HD>(ks + (buf ^ 1) * kMmaBK * kLd, kb, k_ss,
                            kv0 + kMmaBK, t_len);
      load_tile<kMmaBK, HD>(vs + (buf ^ 1) * kMmaBK * kLd, vb, v_ss,
                            kv0 + kMmaBK, t_len);
    }
    cp_async_commit();
    if (!(causal && kv0 > wq0 + 15)) {
      const bf16* kt = ks + buf * kMmaBK * kLd;
      const bf16* vt = vs + buf * kMmaBK * kLd;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      const bool edge =
          kv0 + kMmaBK > t_len || (causal && kv0 + kMmaBK - 1 > wq0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sc = __fmul_rn(s[j][e], scale);
          if (edge) {
            const int kj = kv0 + j * 8 + 2 * tg + (e & 1);
            const int qi = wq0 + g + (e >> 1) * 8;
            if (kj >= t_len) sc = -INFINITY;          // no such key: p = 0
            else if (causal && kj > qi) sc = kNegInf;  // the reference's fill
          }
          s[j][e] = sc;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc);
        }
      }
      float corr[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        corr[r] = exp2_approx((m_r[r] - m_new) * kLog2e);
        m_r[r] = m_new;
        ms[r] = m_new * kLog2e;
      }
      uint32_t pf[4][4];  // P as bf16 A fragments, 16 keys each
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2_approx(fmaf(s[j][0], kLog2e, -ms[0]));
        const float p1 = exp2_approx(fmaf(s[j][1], kLog2e, -ms[0]));
        const float p2 = exp2_approx(fmaf(s[j][2], kLog2e, -ms[1]));
        const float p3 = exp2_approx(fmaf(s[j][3], kLog2e, -ms[1]));
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + rs[r];
#pragma unroll
      for (int d = 0; d < kDt; ++d) {
        acc[d][0] *= corr[0];
        acc[d][1] *= corr[0];
        acc[d][2] *= corr[1];
        acc[d][3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int dp = 0; dp < kDt / 2; ++dp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                 kLd + dp * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp], pf[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pf[kk], bv[2], bv[3]);
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), staged in the Q rows (read into registers at
  // the start), then stored with 16-byte writes.
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    den[r] = fmaxf(l_r[r], 1e-30f);
  }
  bf16* os = qs + warp * 16 * kLd;
#pragma unroll
  for (int d = 0; d < kDt; ++d) {
    const int c = d * 8 + 2 * tg;
    *reinterpret_cast<uint32_t*>(os + g * kLd + c) =
        pack_bf16(__fdiv_rn(acc[d][0], den[0]), __fdiv_rn(acc[d][1], den[0]));
    *reinterpret_cast<uint32_t*>(os + (g + 8) * kLd + c) =
        pack_bf16(__fdiv_rn(acc[d][2], den[1]), __fdiv_rn(acc[d][3], den[1]));
  }
  __syncthreads();
  bf16* ob = o + ((int64_t)b * s_len * heads + h) * HD;
  constexpr int kChunks = HD / 8;
  for (int e = threadIdx.x; e < kMmaBQ * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    if (q0 + r < s_len) {
      *reinterpret_cast<uint4*>(ob + (int64_t)(q0 + r) * heads * HD + c) =
          *reinterpret_cast<const uint4*>(qs + r * kLd + c);
    }
  }
}

template <typename T>
int launch_ffma(const void* q, const void* k, const void* v, void* o,
                int batch, int s_len, int t_len, int heads, int kv_heads,
                int hd, const long long* st, int causal, float scale,
                cudaStream_t stream) {
  if (hd > kHdMax) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * (hd + 1) + (size_t)kBK * (hd + 1) + (size_t)kBK * hd +
       (size_t)kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s_len + kBQ - 1) / kBQ),
                  (unsigned)(batch * heads));
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s_len, t_len, heads,
      kv_heads, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               int batch, int s_len, int t_len, int heads, int kv_heads,
               const long long* st, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(kMmaBQ + 4 * kMmaBK) *
                      (size_t)(HD + 8);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * heads),
                  (unsigned)((s_len + kMmaBQ - 1) / kMmaBQ));
  flash_fwd_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, s_len, t_len,
      heads, kv_heads, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// body 0: the FFMA body (f32, or bf16 with is_bf16 = 1); body 1: the tensor-core
// body (bf16 only, hd a multiple of 16 up to 128, every row 16-byte aligned:
// pointers at 16 bytes, strides in multiples of 8 elements).
// strides: q (batch, seq, head), k (...), v (...) in elements, nine values;
// scale is the f32 of 1/sqrt(hd), as the Pallas kernel rounds it.
extern "C" int flash_attention_fwd(int body, int is_bf16, const void* q,
                                   const void* k, const void* v, void* o,
                                   int batch, int s_len, int t_len, int heads,
                                   int kv_heads, int hd,
                                   const long long* strides, int causal,
                                   float scale, void* stream) {
  if (batch == 0 || s_len == 0 || heads == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (body == 1) {
    if (!is_bf16 || hd <= 0 || hd % 16 != 0 || hd > kHdMax) {
      return (int)cudaErrorInvalidValue;
    }
    switch (hd) {  // hd fixed at compile time: the loops unroll whole
      case 16: return launch_mma<16>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
      case 32: return launch_mma<32>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
      case 48: return launch_mma<48>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
      case 64: return launch_mma<64>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
      case 80: return launch_mma<80>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
      case 96: return launch_mma<96>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
      case 112: return launch_mma<112>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
      default: return launch_mma<128>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, scale, st);
    }
  }
  if (is_bf16) {
    return launch_ffma<__nv_bfloat16>(q, k, v, o, batch, s_len, t_len, heads,
                                      kv_heads, hd, strides, causal, scale,
                                      st);
  }
  return launch_ffma<float>(q, k, v, o, batch, s_len, t_len, heads, kv_heads,
                            hd, strides, causal, scale, st);
}
