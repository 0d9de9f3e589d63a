// Kernel F on Hopper: causal or full softmax attention with an online
// softmax, GQA without repeating K and V, and causal attention over a
// local window (RecurrentGemma's local layers).
//
// Replaces the Pallas kernel `flash_attention_pallas` (src/repro/kernels/
// flash_attn.py:76, body `_flash_body`, `pallas_call` :89).  The function
// is the same: scores = (q . k) * 1/sqrt(hd) in f32 from q, k, v cast to
// f32, causal positions filled with -1e30 on global indices (key j <= query
// i), the running max m, sum l and accumulator acc updated per key tile
// (corr = exp(m_prev - m_new), p = exp(s - m_new), l = l * corr + sum p,
// acc = acc * corr + p v), and out = acc / max(l, 1e-30) in q's dtype.
// The (S, T) score matrix never exists in device memory.  With a window w
// > 0 (causal only), keys j <= i - w are filled with -1e30 as well, the
// reference's mask (src/repro/models/attention.py:157-162): query i sees
// keys i - w < j <= i.  A block's key loop then starts at the tile that
// holds key q0 - w + 1 and a warp skips a tile whose keys all lie at or
// below its first query minus w.  Windows and hd 256 are compiled in only
// with FLASH_WINDOW=1 (the library `flash_attn_window`, which the wrapper
// loads for a window above 0 or hd above 128).  The plain build keeps the
// tensor-core body as it was before windows came and folds the window out
// of the FFMA body, so a window of 0 at hd <= 128 runs the kernels of
// before, bitwise and at their speed (compiled in, the window's checks
// cost 9-36%; folded away, the windowed tensor-core body still ran 12%
// slower at hd 128 on the card).
//
// Layout: q (B, S, H, hd) and k, v (B, T, KV, hd), read through element
// strides (the last dimension contiguous), as the model holds them; query
// head h reads KV head h / (H / KV), the grouping of the reference's
// `_attend`.  The output is a contiguous (B, S, H, hd).
//
// Two bodies; the wrapper picks one from the dtype and hd before launch.
//
// * The tensor-core body (`flash_fwd_mma_kernel`): bf16 q, k, v with hd a
//   multiple of 16 (<= 128) or 256, the model's prefill, compiled for each
//   hd so that its loops unroll whole (a run-time hd kept them from it).  One
//   block per (batch * head, query tile of 128), eight warps of 16
//   queries; the Q fragments stay in registers and the K and V tiles of 64
//   keys are double-buffered in shared memory with cp.async, one barrier
//   per tile.  At hd 256 O alone takes 128 f32 registers a thread, so the Q
//   fragments are read again from shared memory (ldmatrix) at every key
//   tile instead of being held in registers; the tiles take 202,752 bytes
//   of shared memory.  Both products run on mma.sync m16n8k16 bf16 -> f32:
//   Q K^T is the reference's f32 dot of bf16 values (each product exact in
//   f32; only the order of the sum differs), and P V takes P rounded to
//   bf16 (relative error 2^-9 per probability) with f32 sums.  The softmax is
//   f32 (ex2.approx of the scores times log2 e).  Tiles above the diagonal
//   are skipped, per block and per warp; only the tiles that cross the
//   diagonal or T are masked.  Bound by operations on the bf16 tensor
//   cores: 4 * S * T * hd per (batch, head), halved when causal, over 989
//   TFLOP/s; with a window, 4 * hd * sum_i min(i + 1, w).
//
// * The FFMA body (`flash_fwd_kernel`): f32 (the f32 twin's model), and
//   bf16 with hd not a multiple of 16.  The products run from register
//   tiles, as an SGEMM runs them: one block of 256 threads per (batch *
//   head, query tile of 128); thread (ty, tx) owns 8 queries x 4 keys of
//   each 64-key tile of S and 8 queries x hd / 16 dims of O.  Q stays in
//   shared memory; the K and V tiles are double-buffered there (cp.async
//   for f32 whose rows start on 16 bytes; bf16 is converted on load), and
//   every operand is read four floats at a time: 128 FMAs per 12 shared
//   loads in S, 256 per 16 in P V, where the earlier design (four threads
//   a query row) paced each FMA by one or two scalar shared loads (15.6
//   ms on qwen3_4b's f32 prefill shape, 7.6x its FP32 bound; NVIDIA H100
//   80GB HBM3, 700 W).
//   hd is zero-padded to 16, 32, 64, 128 or 256, each compiled.  At 256 a
//   block of 128 threads takes 64 queries and key tiles of 32 (a thread:
//   8 queries x 2 keys of S, 8 queries x 16 dims of O), so Q, the
//   double-buffered K and V tiles and P fit in 205,824 bytes of shared
//   memory and O stays 128 registers a thread.  A row's max
//   and sum go over its 16 threads with shuffles; the probabilities go
//   through shared memory, each warp reading back its own rows.  Bound by
//   FP32 operations (67 TFLOP/s): 4 * S * T * hd per (batch, head), halved
//   when causal.
//
// Both: any S and T run (keys past T get probability 0, queries past S are
// not written); skipping a tile above the diagonal, or below a window,
// changes nothing, since its probabilities are exact zeros.  hd <= 256.
//
// Given a non-null `lse` (f32, (B, H, S)), both bodies also write each
// query row's log-sum-exp m + log(max(l, 1e-30)) in natural-log units at
// their epilogue: the row statistic the backward (csrc/flash_attn_bwd.cu)
// recomputes P = exp(s - lse) from.  With lse null nothing else changes:
// the same output bits (training and the serve paths launch the same
// loops; only the epilogue's store is added).
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef FLASH_WINDOW
#define FLASH_WINDOW 0
#endif

namespace {

constexpr bool kWindowBuild = FLASH_WINDOW != 0;
constexpr int kHdMax = kWindowBuild ? 256 : 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

#if FLASH_WINDOW
// One block per (batch * head, query tile of 128), the longest causal tiles
// first.  Warp w owns queries q0 + 16w .. +15: its Q fragments stay in
// registers (at hd <= 128; at 256 they are read from the Q tile in shared
// memory at every key tile); the K and V tiles of 64 keys are
// double-buffered in shared memory (cp.async).  Per key tile: S = Q K^T
// with mma m16n8k16 (bf16 in, f32 sums: the products of two bf16 values
// are exact in f32, as in the reference's f32 dot), the scale, the masks
// (only on tiles that cross the diagonal, a window's edge or T), the
// online softmax in f32 (exp2 of the scores times
// log2 e), then O += P V with P rounded to bf16 and f32 sums.  A warp skips
// a tile whose keys all lie above its queries, or at or below its first
// query minus the window.  A row whose keys so far all lie outside its
// window (window > 0 only) keeps m = -1e30 with p = 0 and corr = 0: the
// reference's exp(-1e30 - m) terms are zeroed by the first real score
// anyway, and exp2 of fmaf(-1e30, log2 e, 1.44e30) is not 1 but 2^(the
// product's rounding error).  The output tile is staged in shared memory
// and stored with 16-byte writes.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int s_len, int t_len,
    int heads, int kv_heads, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int causal, int window, float scale,
    float* __restrict__ lse) {
  constexpr int kLd = HD + 8;  // padded rows: ldmatrix without conflicts
  constexpr int kDk = HD / 16;
  constexpr int kDt = HD / 8;
  constexpr bool kQRegs = HD <= 128;  // Q fragments held in registers
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
  // The first tile that holds key q0 - window + 1 (0 without a window).
  const int t_first = window ? max(0, q0 - window + 1) / kMmaBK : 0;
  if (ntiles > t_first) {
    load_tile<kMmaBK, HD>(ks + (t_first & 1) * kMmaBK * kLd, kb, k_ss,
                          t_first * kMmaBK, t_len);
    load_tile<kMmaBK, HD>(vs + (t_first & 1) * kMmaBK * kLd, vb, v_ss,
                          t_first * kMmaBK, t_len);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qf[kQRegs ? kDk : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kDk; ++kk) {
      ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                          (lane >> 4) * 8);
    }
  }

  float acc[kDt][4];
#pragma unroll
  for (int d = 0; d < kDt; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_r[2] = {0.0f, 0.0f};            // this thread's part of the sum

  for (int t = t_first; t < ntiles; ++t) {
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
    if (!(causal && kv0 > wq0 + 15) &&
        !(window && kv0 + kMmaBK - 1 <= wq0 - window)) {
      const bf16* kt = ks + buf * kMmaBK * kLd;
      const bf16* vt = vs + buf * kMmaBK * kLd;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kDk; ++kk) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                            kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
          }
        } else {  // hd 256: this k step's Q fragment from shared memory
          uint32_t qa[4];
          ldsm_x4(qa, qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                            kk * 16 + ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qa, bk[0], bk[1]);
            mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
          }
        }
      }
      const bool edge =
          kv0 + kMmaBK > t_len || (causal && kv0 + kMmaBK - 1 > wq0) ||
          (window && kv0 <= wq0 + 15 - window);
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
            else if (window && kj <= qi - window) sc = kNegInf;
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
        if (window && m_new <= kNegInf) {  // no key of the row's window yet
          corr[r] = 0.0f;
          ms[r] = 0.0f;  // p = exp2(-1.44e30) = 0
        }
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
  if (lse != nullptr && tg == 0) {  // the backward's row statistic
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = wq0 + g + r * 8;
      if (qi < s_len) {
        lse[((int64_t)b * heads + h) * s_len + qi] = m_r[r] + logf(den[r]);
      }
    }
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
#else
// The plain build's tensor-core body: no window, hd <= 128.  It is the
// body as it was before windows came, kept apart: the windowed body above,
// its window folded to 0 and hd <= 128, gave the same bits but ran 12%
// slower (a longer prologue and loop, 2976 instructions against 2808).
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
    int64_t v_sh, int causal, float scale, float* __restrict__ lse) {
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
  if (lse != nullptr && tg == 0) {  // the backward's row statistic
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = wq0 + g + r * 8;
      if (qi < s_len) {
        lse[((int64_t)b * heads + h) * s_len + qi] = m_r[r] + logf(den[r]);
      }
    }
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
#endif  // FLASH_WINDOW

// --- the FFMA body: f32, or bf16 at another hd ------------------------------

constexpr int kFBQ = 128;     // queries per block
constexpr int kFBK = 64;      // keys per tile
constexpr int kFThreads = 256;
constexpr int kFRows = 8;     // queries per thread: ty * 8 + ii
constexpr int kFKeys = 4;     // keys per thread in S: tx + 16 * jj

// Shared-memory shape of the FFMA body at a padded head dim HDP (16, 32,
// 64, 128 or 256; hd zero-padded up to it).  K rows are padded to kLdK
// floats (HDP + 4: the 16-byte loads of eight consecutive rows hit eight
// distinct bank groups); Q and V rows are read by a whole quarter warp at
// once (one row, or one dim range of one row) and stay unpadded.  P is
// the tile's probabilities, kBQ x kBK.  At HDP 128: 231,424 bytes.  At
// HDP 256 the block is 128 threads, 64 queries and tiles of 32 keys
// (kKeys 2): 205,824 bytes; 128 queries would need 428 KB.
template <int HDP>
struct FTile {
  static constexpr int kThreads = HDP > 128 ? 128 : kFThreads;
  static constexpr int kKeys = HDP > 128 ? 2 : kFKeys;
  static constexpr int kBQ = kThreads / 16 * kFRows;
  static constexpr int kBK = 16 * kKeys;
  static constexpr int kLdK = HDP + 4;
  static constexpr int kKBuf = kBK * kLdK;
  static constexpr int kVBuf = kBK * HDP;
  static constexpr int kFloats =
      kBQ * HDP + 2 * kKBuf + 2 * kVBuf + kBQ * kBK;
  // O's dims per thread: kNv vectors of kVec, dim h * 16 * kVec + tx * kVec
  // + e, so a quarter warp's V loads are consecutive 16-byte words.
  static constexpr int kVec = HDP >= 64 ? 4 : HDP / 16;
  static constexpr int kNv = HDP / (16 * kVec);
};

template <int V>
__device__ __forceinline__ void lds_vec(float (&r)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
    r[0] = *p;
  }
}

// Rows [r0, r0 + R) of a (rows, hd) view with a pitch of `ld` elements into
// shared rows of LD floats, zero past hd (up to HDP) and for rows at or
// past `limit`.  async (f32 only; hd, the pitch and the row starts in
// multiples of four floats): 16-byte cp.async, waited on by the caller;
// otherwise loads converted to f32 and stored by the threads.
template <int R, int HDP, int LD, typename T>
__device__ __forceinline__ void ffma_load(float* dst, const T* src,
                                          int64_t ld, int r0, int limit,
                                          int hd, bool async) {
  constexpr int kChunks = HDP / 4;
  for (int e = threadIdx.x; e < R * kChunks; e += FTile<HDP>::kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const bool row = r0 + r < limit;
    const T* g = src + (int64_t)(r0 + r) * ld + c;
    if (std::is_same<T, float>::value && async) {
      const bool ok = row && c < hd;
      cp_async16(dst + r * LD + c, ok ? (const void*)g : (const void*)src,
                 ok);
    } else {
      float4 v;
      v.x = row && c < hd ? to_f32(g[0]) : 0.0f;
      v.y = row && c + 1 < hd ? to_f32(g[1]) : 0.0f;
      v.z = row && c + 2 < hd ? to_f32(g[2]) : 0.0f;
      v.w = row && c + 3 < hd ? to_f32(g[3]) : 0.0f;
      *reinterpret_cast<float4*>(dst + r * LD + c) = v;
    }
  }
}

// One block per (batch * head, query tile of kBQ = 128; 64 at HDP 256),
// the longest causal tiles first; kThreads threads (256; 128 at HDP 256),
// thread (ty, tx) = (t / 16, t % 16).  Per key tile of kBK = 64 (32 at HDP
// 256; double-buffered, cp.async for f32), after one barrier:
// * S = Q K^T from register tiles: the thread's 8 queries (ty * 8 + ii)
//   against its kKeys keys (tx + 16 jj), Q and K rows in shared memory
//   read four dims at a time (16-byte loads), 128 FMAs per 12 loads;
// * the scale, the masks (-1e30 above the diagonal on global indices and,
//   with a window w, at or below i - w; -inf past T), and the online
//   softmax per query row, its max and sum over
//   the 16 threads of the row (shuffles within a half warp); corr per row;
// * P (f32) into shared memory; each warp writes and reads back only its
//   own 16 rows, so a __syncwarp orders them;
// * O = O * corr + P V from register tiles: 8 queries x HDP / 16 dims, 256
//   FMAs per 16 loads (HDP 128).
// A warp skips a tile whose keys all lie above its 16 queries, or at or
// below its first query minus the window (its probabilities there are
// exact zeros).  A row whose processed keys all lie outside its window
// keeps m = -1e30 and sums exp(0) terms, as the reference's softmax would;
// the first key inside the window zeroes them (corr = exp(-1e30 - m)).
// out = O / max(l, 1e-30).
template <typename T, int HDP>
__global__ void __launch_bounds__(FTile<HDP>::kThreads, 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int s_len, int t_len, int heads, int kv_heads, int hd,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int causal,
    int window, float scale, int async, float* __restrict__ lse) {
  using Tl = FTile<HDP>;
  constexpr int kLdK = Tl::kLdK, kVec = Tl::kVec, kNv = Tl::kNv;
  constexpr int kDims = kVec * kNv;
  constexpr int kBQ = Tl::kBQ, kBK = Tl::kBK, kKeys = Tl::kKeys;
  if (!kWindowBuild) window = 0;       // folds the window's code away
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                     // kBQ rows of HDP
  float* ks = qs + kBQ * HDP;          // 2 x K tile
  float* vs = ks + 2 * Tl::kKBuf;      // 2 x V tile
  float* ps = vs + 2 * Tl::kVBuf;      // P

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int wq0 = q0 + (threadIdx.x >> 5) * 16;  // the warp's first query
  const bool as = async != 0;
  const T* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;

  ffma_load<kBQ, HDP, HDP>(qs, qb, q_ss, q0, s_len, hd, as);
  const int kv_end = causal ? min(t_len, q0 + kBQ) : t_len;
  const int ntiles = (kv_end + kBK - 1) / kBK;
  // The first tile that holds key q0 - window + 1 (0 without a window).
  const int t_first = window ? max(0, q0 - window + 1) / kBK : 0;
  if (ntiles > t_first) {
    ffma_load<kBK, HDP, kLdK>(ks + (t_first & 1) * Tl::kKBuf, kb, k_ss,
                              t_first * kBK, t_len, hd, as);
    ffma_load<kBK, HDP, HDP>(vs + (t_first & 1) * Tl::kVBuf, vb, v_ss,
                             t_first * kBK, t_len, hd, as);
  }
  cp_async_commit();

  float m_i[kFRows], l_i[kFRows], acc[kFRows][kDims];
#pragma unroll
  for (int ii = 0; ii < kFRows; ++ii) {
    m_i[ii] = kNegInf;
    l_i[ii] = 0.0f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[ii][d] = 0.0f;
  }
  const float* qrow = qs + ty * kFRows * HDP;
  float* prow = ps + ty * kFRows * kBK;

  for (int t = t_first; t < ntiles; ++t) {
    const int kv0 = t * kBK;
    const float* kt = ks + (t & 1) * Tl::kKBuf;
    const float* vt = vs + (t & 1) * Tl::kVBuf;
    cp_async_wait<0>();  // tile t has landed ...
    __syncthreads();     // ... for every thread, and tile t - 1 is read
    if (t + 1 < ntiles) {
      ffma_load<kBK, HDP, kLdK>(ks + ((t + 1) & 1) * Tl::kKBuf, kb, k_ss,
                                kv0 + kBK, t_len, hd, as);
      ffma_load<kBK, HDP, HDP>(vs + ((t + 1) & 1) * Tl::kVBuf, vb, v_ss,
                               kv0 + kBK, t_len, hd, as);
    }
    cp_async_commit();
    if (causal && kv0 > wq0 + 15) continue;
    if (window && kv0 + kBK - 1 <= wq0 - window) continue;
    float s[kFRows][kKeys];
#pragma unroll
    for (int ii = 0; ii < kFRows; ++ii) {
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) s[ii][jj] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < HDP; d += 4) {
      float4 kf[kKeys];
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        kf[jj] = *reinterpret_cast<const float4*>(
            kt + (tx + 16 * jj) * kLdK + d);
      }
#pragma unroll
      for (int ii = 0; ii < kFRows; ++ii) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qrow + ii * HDP + d);
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj) {
          s[ii][jj] = __fmaf_rn(qf.x, kf[jj].x, s[ii][jj]);
          s[ii][jj] = __fmaf_rn(qf.y, kf[jj].y, s[ii][jj]);
          s[ii][jj] = __fmaf_rn(qf.z, kf[jj].z, s[ii][jj]);
          s[ii][jj] = __fmaf_rn(qf.w, kf[jj].w, s[ii][jj]);
        }
      }
    }
    __syncwarp();  // the warp has read its rows of the previous tile's P
#pragma unroll
    for (int ii = 0; ii < kFRows; ++ii) {
      const int qi = q0 + ty * kFRows + ii;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int kj = kv0 + tx + 16 * jj;
        float sc = __fmul_rn(s[ii][jj], scale);
        if (kj >= t_len) sc = -INFINITY;           // no such key: p = 0
        else if (causal && kj > qi) sc = kNegInf;  // the reference's fill
        else if (window && kj <= qi - window) sc = kNegInf;
        s[ii][jj] = sc;
        mx = fmaxf(mx, sc);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_i[ii], mx);
      const float corr = expf(m_i[ii] - m_new);
      m_i[ii] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const float p = expf(s[ii][jj] - m_new);
        prow[ii * kBK + tx + 16 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l_i[ii] = l_i[ii] * corr + rs;
#pragma unroll
      for (int d = 0; d < kDims; ++d) acc[ii][d] *= corr;
    }
    __syncwarp();  // the warp's 16 rows of P are written
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pf[kFRows];
#pragma unroll
      for (int ii = 0; ii < kFRows; ++ii) {
        pf[ii] = *reinterpret_cast<const float4*>(prow + ii * kBK + j);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vt + (j + u) * HDP + tx * kVec;
#pragma unroll
        for (int hv = 0; hv < kNv; ++hv) {
          float vf[kVec];
          lds_vec<kVec>(vf, vrow + hv * 16 * kVec);
#pragma unroll
          for (int ii = 0; ii < kFRows; ++ii) {
            const float p = u == 0 ? pf[ii].x
                          : u == 1 ? pf[ii].y
                          : u == 2 ? pf[ii].z : pf[ii].w;
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              acc[ii][hv * kVec + e] =
                  __fmaf_rn(p, vf[e], acc[ii][hv * kVec + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < kFRows; ++ii) {
    const int qi = q0 + ty * kFRows + ii;
    if (qi >= s_len) continue;
    const float denom = fmaxf(l_i[ii], 1e-30f);
    if (lse != nullptr && tx == 0) {  // the backward's row statistic
      lse[((int64_t)b * heads + h) * s_len + qi] = m_i[ii] + logf(denom);
    }
    T* ob = o + (((int64_t)b * s_len + qi) * heads + h) * hd;
#pragma unroll
    for (int hv = 0; hv < kNv; ++hv) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = hv * 16 * kVec + tx * kVec + e;
        if (d < hd) store(ob + d, acc[ii][hv * kVec + e] / denom);
      }
    }
  }
}

template <typename T, int HDP>
int launch_ffma_tiles(const void* q, const void* k, const void* v, void* o,
                      int batch, int s_len, int t_len, int heads,
                      int kv_heads, int hd, const long long* st, int causal,
                      int window, float scale, float* lse,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)FTile<HDP>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // cp.async for f32 whose rows all start on 16 bytes.
  bool async = sizeof(T) == 4 && hd % 4 == 0 && (uintptr_t)q % 16 == 0 &&
               (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  for (int i = 0; i < 9; ++i) async = async && st[i] % 4 == 0;
  constexpr int kBQ = FTile<HDP>::kBQ;
  const dim3 grid((unsigned)(batch * heads),
                  (unsigned)((s_len + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, HDP><<<grid, FTile<HDP>::kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s_len, t_len, heads,
      kv_heads, hd, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, window, scale, (int)async, lse);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ffma_hd(const void* q, const void* k, const void* v, void* o,
                   int batch, int s_len, int t_len, int heads, int kv_heads,
                   int hd, const long long* st, int causal, int window,
                   float scale, float* lse, cudaStream_t stream) {
  if (hd <= 0 || hd > kHdMax) return (int)cudaErrorInvalidValue;
  if (hd <= 16) {
    return launch_ffma_tiles<T, 16>(q, k, v, o, batch, s_len, t_len, heads,
                                    kv_heads, hd, st, causal, window, scale,
                                    lse, stream);
  }
  if (hd <= 32) {
    return launch_ffma_tiles<T, 32>(q, k, v, o, batch, s_len, t_len, heads,
                                    kv_heads, hd, st, causal, window, scale,
                                    lse, stream);
  }
  if (hd <= 64) {
    return launch_ffma_tiles<T, 64>(q, k, v, o, batch, s_len, t_len, heads,
                                    kv_heads, hd, st, causal, window, scale,
                                    lse, stream);
  }
#if FLASH_WINDOW
  if (hd > 128) {
    return launch_ffma_tiles<T, 256>(q, k, v, o, batch, s_len, t_len, heads,
                                     kv_heads, hd, st, causal, window, scale,
                                     lse, stream);
  }
#endif
  return launch_ffma_tiles<T, 128>(q, k, v, o, batch, s_len, t_len, heads,
                                   kv_heads, hd, st, causal, window, scale,
                                   lse, stream);
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               int batch, int s_len, int t_len, int heads, int kv_heads,
               const long long* st, int causal, int window, float scale,
               float* lse, cudaStream_t stream) {
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
#if FLASH_WINDOW
      st[8], causal, window, scale, lse);
#else
      st[8], causal, scale, lse);
#endif
  return (int)cudaGetLastError();
}

}  // namespace

// body 0: the FFMA body (f32, or bf16 with is_bf16 = 1); body 1: the tensor-core
// body (bf16 only, hd a multiple of 16 up to 128, or 256 in the windowed
// build, every row 16-byte aligned: pointers at 16 bytes, strides in
// multiples of 8 elements).  hd above 128 only in the windowed build.
// strides: q (batch, seq, head), k (...), v (...) in elements, nine values;
// window: 0, or (the FLASH_WINDOW=1 build only) w > 0 with causal = 1
// (keys i - w < j <= i);
// scale is the f32 of 1/sqrt(hd), as the Pallas kernel rounds it;
// lse: null, or an f32 (batch, heads, s_len) that takes each query row's
// m + log(max(l, 1e-30)) (the backward's row statistic, csrc/
// flash_attn_bwd.cu); null writes nothing and computes the same output.
extern "C" int flash_attention_fwd(int body, int is_bf16, const void* q,
                                   const void* k, const void* v, void* o,
                                   int batch, int s_len, int t_len, int heads,
                                   int kv_heads, int hd,
                                   const long long* strides, int causal,
                                   int window, float scale, void* lse,
                                   void* stream) {
  float* lse_out = (float*)lse;
  if (window < 0 || (window && (!causal || !kWindowBuild))) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || s_len == 0 || heads == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (body == 1) {
    if (!is_bf16 || hd <= 0 || hd % 16 != 0 || hd > kHdMax ||
        (hd > 128 && hd != 256)) {
      return (int)cudaErrorInvalidValue;
    }
    switch (hd) {  // hd fixed at compile time: the loops unroll whole
      case 16: return launch_mma<16>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
      case 32: return launch_mma<32>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
      case 48: return launch_mma<48>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
      case 64: return launch_mma<64>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
      case 80: return launch_mma<80>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
      case 96: return launch_mma<96>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
      case 112: return launch_mma<112>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
#if FLASH_WINDOW
      case 128: return launch_mma<128>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
      default: return launch_mma<256>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
#else
      default: return launch_mma<128>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, strides, causal, window, scale, lse_out, st);
#endif
    }
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    return launch_ffma_hd<__nv_bfloat16>(q, k, v, o, batch, s_len, t_len,
                                         heads, kv_heads, hd, strides, causal,
                                         window, scale, lse_out, st);
  }
  return launch_ffma_hd<float>(q, k, v, o, batch, s_len, t_len, heads,
                               kv_heads, hd, strides, causal, window, scale,
                               lse_out, st);
}
