// Kernel F's backward on Hopper: the gradients of softmax attention with
// respect to q, k and v, the standard flash-attention construction.
//
// Replaces no Pallas kernel: the reference's `flash_attention_pallas`
// (src/repro/kernels/flash_attn.py:76) is forward-only, and the reference
// trains through its plain `_attend` (src/repro/models/attention.py:95);
// its docstring (:11-13) pairs the kernel with "a custom_vjp twin
// (standard flash-attention construction)" for training.  This is that
// twin, for the port's kernel F (csrc/flash_attn.cu), whose forward hands
// it each query row's log-sum-exp lse = m + log(max(l, 1e-30)).
//
// The function, per (batch, query head h, query i, key j), under the
// forward's mask (causal: key j > query i masked; a causal window w: also
// j <= i - w; non-causal: none, S and T free):
//   P = exp(s - lse_i) with s = (q_i . k_j) * scale (masked: s = -1e30, so
//   P = 0), D_i = rowsum(dO_i o O_i),
//   dV_j = sum_i P dO_i,  dP = dO_i . v_j,  dS = P (dP - D_i),
//   dQ_i = scale * sum_j dS k_j,  dK_j = scale * sum_i dS q_i,
// with query head h reading KV head h / G (G = H / KV): dK and dV of a KV
// head sum over its G query heads, in head order.  Sums are f32 (inputs
// converted on load); the gradients are stored in q's dtype.
//
// Deterministic, with no atomics: three kernels on the caller's stream,
//   1. `bwd_dot_kernel`: D, one warp per query row (a fixed shuffle tree);
//   2. `flash_bwd_dq_kernel`: one block per (batch * head, query tile of
//      64), looping over the key tiles in order: S and dP from register
//      tiles (a thread: 4 queries x 4 keys), dS through shared memory, then
//      dQ += dS K (a thread: 4 queries x hd / 16 dims);
//   3. `flash_bwd_dkv_kernel`: one block per (batch * KV head, key tile of
//      64), looping over the group's G heads and, for each, the query tiles
//      that can see the tile, in order: S^T and dP^T (a thread: 4 keys x 4
//      queries), P^T and dS^T through shared memory, then dV += P^T dO and
//      dK += dS^T Q (a thread: 4 keys x hd / 16 dims of each).
// Every output element is written by one thread of one block, after one
// fixed sequence of f32 FMAs, so the bits do not depend on scheduling.
//
// Bound: 10 S T hd operations per (batch, head) (five products of 2 S T
// hd: S recomputed, then dP, dV, dQ and dK; the elementwise work aside),
// halved when causal, at the bf16 tensor cores' 989 TFLOP/s for bf16
// inputs.  This is the FP32 FFMA body (67 TFLOP/s on the card); it
// computes S and dP in each of the two kernels, so it does 14 S T hd.
// A tensor-core body (mma.sync on bf16 at hd % 16 == 0) is the next
// design (ROADMAP queue 2).  hd is padded to 16, 32, 64 or 128, each
// compiled; hd above 128 is refused (the windowed hd 256 of recurrentgemma
// is ROADMAP queue 1 item 18).
//
// The entry point launches on the caller's stream, allocates nothing (the
// wrapper passes D's scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // (ty, tx) = (t / 16, t % 16)
constexpr int kTile = 64;      // rows of the outer and of the inner tile
constexpr int kRows = 4;       // outer rows a thread: ty * 4 + ii
constexpr int kCols = 4;       // inner rows a thread in S: tx + 16 * jj

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The shape of the tiles at a padded head dim HDP.  Outer rows (read by
// the 16 threads of a half warp at one address: a broadcast) are HDP
// floats; inner rows (read 16 rows at once, four floats each) are padded
// to kLdI = HDP + 4 so eight consecutive rows hit distinct bank groups.
// A thread's output dims: kNv vectors of kVec, dim hv * 16 * kVec + tx *
// kVec + e, so a half warp reads consecutive 16-byte words of a row.
template <int HDP>
struct BTile {
  static constexpr int kLdI = HDP + 4;
  static constexpr int kVec = HDP >= 64 ? 4 : HDP / 16;
  static constexpr int kNv = HDP / (16 * kVec);
  static constexpr int kDims = kVec * kNv;  // HDP / 16
  // Floats of shared memory: two outer tiles, two inner tiles, two
  // kTile x kTile tiles (dS, and P in the dK/dV kernel), two row vectors.
  static constexpr int kFloats =
      2 * kTile * HDP + 2 * kTile * kLdI + 2 * kTile * kTile + 2 * kTile;
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

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = __fmaf_rn(a.x, b.x, acc);
  acc = __fmaf_rn(a.y, b.y, acc);
  acc = __fmaf_rn(a.z, b.z, acc);
  return __fmaf_rn(a.w, b.w, acc);
}

// Rows [r0, r0 + R) of a (rows, hd) view with a pitch of `ld` elements into
// shared rows of LD floats, converted to f32, zero past hd (up to HDP) and
// for rows at or past `limit`.
template <int R, int HDP, int LD, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t ld, int r0, int limit,
                                          int hd) {
  constexpr int kChunks = HDP / 4;
  for (int e = threadIdx.x; e < R * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const bool row = r0 + r < limit;
    const T* g = src + (int64_t)(r0 + r) * ld + c;
    float4 v;
    v.x = row && c < hd ? to_f32(g[0]) : 0.0f;
    v.y = row && c + 1 < hd ? to_f32(g[1]) : 0.0f;
    v.z = row && c + 2 < hd ? to_f32(g[2]) : 0.0f;
    v.w = row && c + 3 < hd ? to_f32(g[3]) : 0.0f;
    *reinterpret_cast<float4*>(dst + r * LD + c) = v;
  }
}

// P of query qi and key kj from the raw dot `dot`: the forward's mask on
// global indices, 0 for a query or key that does not exist.
__device__ __forceinline__ float prob(float dot, float scale, float lse,
                                      int qi, int kj, int s_len, int t_len,
                                      int causal, int window) {
  if (qi >= s_len || kj >= t_len) return 0.0f;
  float sc = __fmul_rn(dot, scale);
  if (causal && kj > qi) sc = kNegInf;
  else if (window && kj <= qi - window) sc = kNegInf;
  return expf(sc - lse);
}

// D_i = sum_d dO[i, d] O[i, d] for every (batch, query, head) row of the
// contiguous (B, S, H, hd) O and dO, one warp a row, into dsum (B, H, S).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ dsum, int s_len, int heads, int hd, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) {
    acc = __fmaf_rn(to_f32(o[row * hd + d]), to_f32(dout[row * hd + d]),
                    acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const int64_t sh = (int64_t)s_len * heads;
    const int64_t b = row / sh, rem = row % sh;
    const int i = (int)(rem / heads), h = (int)(rem % heads);
    dsum[(b * heads + h) * s_len + i] = acc;
  }
}

// dQ: one block per (batch * head, query tile of 64), the longest causal
// tiles first.  Q and dO rows of the tile, lse and D stay in shared memory;
// per key tile (K and V into shared memory): S and dP as 4 x 4 register
// tiles, dS = P (dP - D) into shared memory, then dQ += dS K.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dq, int s_len, int t_len, int heads, int kv_heads,
    int hd, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int causal, int window, float scale) {
  using Tl = BTile<HDP>;
  constexpr int kLdI = Tl::kLdI, kVec = Tl::kVec, kNv = Tl::kNv;
  constexpr int kDims = Tl::kDims;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                      // kTile x HDP
  float* dos = qs + kTile * HDP;       // kTile x HDP
  float* ks = dos + kTile * HDP;       // kTile x kLdI
  float* vs = ks + kTile * kLdI;       // kTile x kLdI
  float* dss = vs + kTile * kLdI;      // kTile x kTile, a row per query
  float* lses = dss + kTile * kTile;   // kTile
  float* dds = lses + kTile;           // kTile

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  const T* dob = dout + ((int64_t)b * s_len * heads + h) * hd;
  const int64_t row_bh = ((int64_t)b * heads + h) * s_len;

  load_rows<kTile, HDP, HDP>(qs, qb, q_ss, q0, s_len, hd);
  load_rows<kTile, HDP, HDP>(dos, dob, (int64_t)heads * hd, q0, s_len, hd);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const bool ok = q0 + i < s_len;
    lses[i] = ok ? lse[row_bh + q0 + i] : 0.0f;
    dds[i] = ok ? dsum[row_bh + q0 + i] : 0.0f;
  }
  const int kv_end = causal ? min(t_len, q0 + kTile) : t_len;
  const int ntiles = (kv_end + kTile - 1) / kTile;
  const int t_first = window ? max(0, q0 - window + 1) / kTile : 0;

  float acc[kRows][kDims];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[ii][d] = 0.0f;
  }

  for (int t = t_first; t < ntiles; ++t) {
    const int kv0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and dS are read
    load_rows<kTile, HDP, kLdI>(ks, kb, k_ss, kv0, t_len, hd);
    load_rows<kTile, HDP, kLdI>(vs, vb, v_ss, kv0, t_len, hd);
    __syncthreads();
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) s[ii][jj] = dp[ii][jj] = 0.0f;
    }
#pragma unroll 2
    for (int d = 0; d < HDP; d += 4) {
      float4 kf[kCols], vf[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        kf[jj] = *reinterpret_cast<const float4*>(ks + (tx + 16 * jj) * kLdI
                                                  + d);
        vf[jj] = *reinterpret_cast<const float4*>(vs + (tx + 16 * jj) * kLdI
                                                  + d);
      }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qs + (ty * kRows + ii) * HDP + d);
        const float4 of =
            *reinterpret_cast<const float4*>(dos + (ty * kRows + ii) * HDP
                                             + d);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          s[ii][jj] = dot4(qf, kf[jj], s[ii][jj]);
          dp[ii][jj] = dot4(of, vf[jj], dp[ii][jj]);
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
      const int i = ty * kRows + ii;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int j = tx + 16 * jj;
        const float p = prob(s[ii][jj], scale, lses[i], q0 + i, kv0 + j,
                             s_len, t_len, causal, window);
        dss[i * kTile + j] = p * (dp[ii][jj] - dds[i]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 df[kRows];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        df[ii] = *reinterpret_cast<const float4*>(
            dss + (ty * kRows + ii) * kTile + j);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* krow = ks + (j + u) * kLdI + tx * kVec;
#pragma unroll
        for (int hv = 0; hv < kNv; ++hv) {
          float kv[kVec];
          lds_vec<kVec>(kv, krow + hv * 16 * kVec);
#pragma unroll
          for (int ii = 0; ii < kRows; ++ii) {
            const float g = comp(df[ii], u);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              acc[ii][hv * kVec + e] =
                  __fmaf_rn(g, kv[e], acc[ii][hv * kVec + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int qi = q0 + ty * kRows + ii;
    if (qi >= s_len) continue;
    T* out = dq + (((int64_t)b * s_len + qi) * heads + h) * hd;
#pragma unroll
    for (int hv = 0; hv < kNv; ++hv) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = hv * 16 * kVec + tx * kVec + e;
        if (d < hd) store(out + d, __fmul_rn(acc[ii][hv * kVec + e], scale));
      }
    }
  }
}

// dK and dV: one block per (batch * KV head, key tile of 64).  K and V
// rows of the tile stay in shared memory; for each of the group's heads in
// order, and each query tile that can see the tile in order (Q, dO, lse
// and D into shared memory): S^T and dP^T as 4 x 4 register tiles (keys x
// queries), P^T and dS^T into shared memory, then dV += P^T dO and dK +=
// dS^T Q.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    T* __restrict__ dk, T* __restrict__ dv, int s_len, int t_len,
    int heads, int kv_heads, int hd, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int causal, int window, float scale) {
  using Tl = BTile<HDP>;
  constexpr int kLdI = Tl::kLdI, kVec = Tl::kVec, kNv = Tl::kNv;
  constexpr int kDims = Tl::kDims;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                      // kTile x HDP
  float* vs = ks + kTile * HDP;        // kTile x HDP
  float* qs = vs + kTile * HDP;        // kTile x kLdI
  float* dos = qs + kTile * kLdI;      // kTile x kLdI
  float* ps = dos + kTile * kLdI;      // kTile x kTile, a row per key
  float* dss = ps + kTile * kTile;     // kTile x kTile, a row per key
  float* lses = dss + kTile * kTile;   // kTile
  float* dds = lses + kTile;           // kTile

  const int group = heads / kv_heads;
  const int b = blockIdx.x / kv_heads, kvh = blockIdx.x % kv_heads;
  const int kv0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kb = k + (int64_t)b * k_sb + (int64_t)kvh * k_sh;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)kvh * v_sh;
  load_rows<kTile, HDP, HDP>(ks, kb, k_ss, kv0, t_len, hd);
  load_rows<kTile, HDP, HDP>(vs, vb, v_ss, kv0, t_len, hd);

  // The query tiles that can see a key of [kv0, kv0 + kTile): causal,
  // from the one holding query kv0; with a window w, up to query kv0 +
  // kTile - 2 + w.
  const int q_first = causal ? kv0 / kTile : 0;
  const int q_end = window ? min(s_len, kv0 + kTile - 1 + window) : s_len;
  const int nq = (q_end + kTile - 1) / kTile;

  float adk[kRows][kDims], adv[kRows][kDims];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
#pragma unroll
    for (int d = 0; d < kDims; ++d) adk[ii][d] = adv[ii][d] = 0.0f;
  }

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const T* qb = q + (int64_t)b * q_sb + (int64_t)h * q_sh;
    const T* dob = dout + ((int64_t)b * s_len * heads + h) * hd;
    const int64_t row_bh = ((int64_t)b * heads + h) * s_len;
    for (int qt = q_first; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_rows<kTile, HDP, kLdI>(qs, qb, q_ss, q0, s_len, hd);
      load_rows<kTile, HDP, kLdI>(dos, dob, (int64_t)heads * hd, q0, s_len,
                                  hd);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const bool ok = q0 + i < s_len;
        lses[i] = ok ? lse[row_bh + q0 + i] : 0.0f;
        dds[i] = ok ? dsum[row_bh + q0 + i] : 0.0f;
      }
      __syncthreads();
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) s[ii][jj] = dp[ii][jj] = 0.0f;
      }
#pragma unroll 2
      for (int d = 0; d < HDP; d += 4) {
        float4 qf[kCols], of[kCols];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          qf[jj] = *reinterpret_cast<const float4*>(
              qs + (tx + 16 * jj) * kLdI + d);
          of[jj] = *reinterpret_cast<const float4*>(
              dos + (tx + 16 * jj) * kLdI + d);
        }
#pragma unroll
        for (int ii = 0; ii < kRows; ++ii) {
          const float4 kf = *reinterpret_cast<const float4*>(
              ks + (ty * kRows + ii) * HDP + d);
          const float4 vf = *reinterpret_cast<const float4*>(
              vs + (ty * kRows + ii) * HDP + d);
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj) {
            // q . k in the dQ kernel's order (q first), so both kernels
            // see the same S.
            s[ii][jj] = dot4(qf[jj], kf, s[ii][jj]);
            dp[ii][jj] = dot4(of[jj], vf, dp[ii][jj]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const int j = ty * kRows + ii;
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const int i = tx + 16 * jj;
          const float p = prob(s[ii][jj], scale, lses[i], q0 + i, kv0 + j,
                               s_len, t_len, causal, window);
          ps[j * kTile + i] = p;
          dss[j * kTile + i] = p * (dp[ii][jj] - dds[i]);
        }
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kTile; i += 4) {
        float4 pf[kRows], df[kRows];
#pragma unroll
        for (int ii = 0; ii < kRows; ++ii) {
          pf[ii] = *reinterpret_cast<const float4*>(
              ps + (ty * kRows + ii) * kTile + i);
          df[ii] = *reinterpret_cast<const float4*>(
              dss + (ty * kRows + ii) * kTile + i);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* orow = dos + (i + u) * kLdI + tx * kVec;
          const float* qrow = qs + (i + u) * kLdI + tx * kVec;
#pragma unroll
          for (int hv = 0; hv < kNv; ++hv) {
            float ov[kVec], qv[kVec];
            lds_vec<kVec>(ov, orow + hv * 16 * kVec);
            lds_vec<kVec>(qv, qrow + hv * 16 * kVec);
#pragma unroll
            for (int ii = 0; ii < kRows; ++ii) {
              const float pp = comp(pf[ii], u), gg = comp(df[ii], u);
#pragma unroll
              for (int e = 0; e < kVec; ++e) {
                adv[ii][hv * kVec + e] =
                    __fmaf_rn(pp, ov[e], adv[ii][hv * kVec + e]);
                adk[ii][hv * kVec + e] =
                    __fmaf_rn(gg, qv[e], adk[ii][hv * kVec + e]);
              }
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int kj = kv0 + ty * kRows + ii;
    if (kj >= t_len) continue;
    const int64_t at = (((int64_t)b * t_len + kj) * kv_heads + kvh) * hd;
#pragma unroll
    for (int hv = 0; hv < kNv; ++hv) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int d = hv * 16 * kVec + tx * kVec + e;
        if (d < hd) {
          store(dk + at + d, __fmul_rn(adk[ii][hv * kVec + e], scale));
          store(dv + at + d, adv[ii][hv * kVec + e]);
        }
      }
    }
  }
}

template <typename T, int HDP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, int batch, int s_len, int t_len,
               int heads, int kv_heads, int hd, const long long* st,
               int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BTile<HDP>::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)batch * s_len * heads;
  const unsigned dot_blocks =
      (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  bwd_dot_kernel<T><<<dot_blocks, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, dsum, s_len, heads, hd, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gq((unsigned)(batch * heads),
                (unsigned)((s_len + kTile - 1) / kTile));
  flash_bwd_dq_kernel<T, HDP><<<gq, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dq, s_len, t_len, heads, kv_heads, hd, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 gk((unsigned)(batch * kv_heads),
                (unsigned)((t_len + kTile - 1) / kTile));
  flash_bwd_dkv_kernel<T, HDP><<<gk, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dk, (T*)dv, s_len, t_len, heads, kv_heads, hd, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_hd(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* dsum, void* dq,
                  void* dk, void* dv, int batch, int s_len, int t_len,
                  int heads, int kv_heads, int hd, const long long* st,
                  int causal, int window, float scale, cudaStream_t stream) {
  if (hd <= 16) {
    return launch_bwd<T, 16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                             s_len, t_len, heads, kv_heads, hd, st, causal,
                             window, scale, stream);
  }
  if (hd <= 32) {
    return launch_bwd<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                             s_len, t_len, heads, kv_heads, hd, st, causal,
                             window, scale, stream);
  }
  if (hd <= 64) {
    return launch_bwd<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                             s_len, t_len, heads, kv_heads, hd, st, causal,
                             window, scale, stream);
  }
  return launch_bwd<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, batch,
                            s_len, t_len, heads, kv_heads, hd, st, causal,
                            window, scale, stream);
}

}  // namespace

// q (B, S, H, hd), k and v (B, T, KV, hd) through element strides (q, k,
// v: batch, seq, head; nine values; the last dimension contiguous); o (the
// forward's output) and dout contiguous (B, S, H, hd); lse the forward's
// f32 (B, H, S) row statistic; dsum an f32 (B, H, S) scratch for D; dq
// contiguous (B, S, H, hd), dk and dv contiguous (B, T, KV, hd), all in
// q's dtype (f32, or bf16 with is_bf16 = 1).  0 < hd <= 128; window 0, or
// w > 0 with causal = 1; scale the f32 of 1/sqrt(hd), as the forward's.
extern "C" int flash_attention_bwd(int is_bf16, const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dsum, void* dq, void* dk, void* dv,
                                   int batch, int s_len, int t_len,
                                   int heads, int kv_heads, int hd,
                                   const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  if (hd <= 0 || hd > 128 || window < 0 || (window && !causal) ||
      kv_heads <= 0 || heads % kv_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || heads == 0 || s_len == 0 || t_len == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    return launch_bwd_hd<__nv_bfloat16>(
        q, k, v, o, dout, (const float*)lse, (float*)dsum, dq, dk, dv, batch,
        s_len, t_len, heads, kv_heads, hd, strides, causal, window, scale,
        st);
  }
  return launch_bwd_hd<float>(q, k, v, o, dout, (const float*)lse,
                              (float*)dsum, dq, dk, dv, batch, s_len, t_len,
                              heads, kv_heads, hd, strides, causal, window,
                              scale, st);
}
