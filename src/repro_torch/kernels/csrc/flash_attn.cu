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
// One block per (query tile of 64, batch * head): it keeps its Q tile, one
// K and one V tile of 64 keys and the probabilities in shared memory
// (rows padded by one word against bank conflicts), walks the key tiles in
// order, and skips the tiles above the diagonal when causal: their
// probabilities are exact zeros, so skipping them changes nothing.  Four
// threads own a query row: each computes 16 of the tile's 64 scores and
// hd / 4 of the row's accumulator; the row's max and sum go over the four
// lanes with shuffles.  Any S and T run: keys past T get probability 0 and
// queries past S are not written.  hd <= 128.
//
// What bounds it: operations.  4 * S * T * hd flops per (batch, head),
// halved when causal, in FP32 FFMA from shared memory.  No tensor cores:
// the oracle computes in f32.
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int s_len, int t_len, int heads, int kv_heads, int hd,
           const long long* st, int causal, float scale,
           cudaStream_t stream) {
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

}  // namespace

// strides: q (batch, seq, head), k (...), v (...) in elements, nine values;
// scale is the f32 of 1/sqrt(hd), as the Pallas kernel rounds it.
extern "C" int flash_attention_fwd(int bf16, const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int s_len, int t_len, int heads,
                                   int kv_heads, int hd,
                                   const long long* strides, int causal,
                                   float scale, void* stream) {
  if (batch == 0 || s_len == 0 || heads == 0) return 0;
  if (bf16) {
    return launch<__nv_bfloat16>(q, k, v, o, batch, s_len, t_len, heads,
                                 kv_heads, hd, strides, causal, scale,
                                 (cudaStream_t)stream);
  }
  return launch<float>(q, k, v, o, batch, s_len, t_len, heads, kv_heads, hd,
                       strides, causal, scale, (cudaStream_t)stream);
}
