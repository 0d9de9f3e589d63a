// The GSE-SEM decode of one stored entry, shared by the SpMV (gse_spmv.cu)
// and the SpMM (gse_spmm.cu) kernels so the two cannot drift apart, as the
// reference's Pallas bodies share `decode_tile`.
//
// Layout (sparse, 15-bit head): expIdx = colpak >> (32 - ei_bit), the
// column is the low bits, sign = head bit 15, mantissa = head & 0x7FFF,
// spliced with tail1 (tag >= 2) and tail2 (tag 3).  Every operation is a
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gse {

// Exact 2^n by exponent-field construction, clipped to [0, 2046] like the
// reference `_pow2_exact` (underflow to zero, saturate at the top binade).
__device__ __forceinline__ double pow2_f64(int n) {
  long long e = (long long)n + 1023;
  e = e < 0 ? 0 : (e > 2046 ? 2046 : e);
  return __longlong_as_double(e << 52);
}

// Python's n // 2 (floor division) for a signed int.
__device__ __forceinline__ int floor_half(int n) {
  return n >= 0 ? n / 2 : -((1 - n) / 2);
}

// f64 value at TAG, in the order of the reference `_decode_gsecsr`: the
// tag-3 mantissa is m_head * 2^48 + tail1 * 2^32 + tail2 left to right,
// the scale 2^(E_sh - bits) is applied as two exact power-of-two factors.
// `e_sh` is table[expIdx] - 1023.
template <int TAG>
__device__ __forceinline__ double decode_f64(uint32_t h, uint32_t t1,
                                             uint32_t t2, int e_sh) {
  constexpr int kBits = TAG == 1 ? 15 : (TAG == 2 ? 31 : 63);
  const double m_head = (double)(h & 0x7FFFu);
  double mant;
  if (TAG == 1) {
    mant = m_head;
  } else if (TAG == 2) {
    mant = __dadd_rn(__dmul_rn(m_head, 65536.0), (double)t1);
  } else {
    mant = __dadd_rn(__dadd_rn(__dmul_rn(m_head, 281474976710656.0),
                               __dmul_rn((double)t1, 4294967296.0)),
                     (double)t2);
  }
  const int p = e_sh - kBits;
  const int half = floor_half(p);
  const double sgn = __dsub_rn(1.0, __dmul_rn(2.0, (double)((h >> 15) & 1u)));
  return __dmul_rn(
      sgn, __dmul_rn(__dmul_rn(mant, pow2_f64(half)), pow2_f64(p - half)));
}

// f32 value at TAG in the order of `decode_tile`: sign * mantissa * scale,
// the mantissa spliced in f32; `scale` is scales[expIdx].
template <int TAG>
__device__ __forceinline__ float decode_f32(uint32_t h, uint32_t t1,
                                            uint32_t t2, float scale) {
  const float sgn = __fsub_rn(1.0f, __fmul_rn(2.0f, (float)((h >> 15) & 1u)));
  float mant = (float)(h & 0x7FFFu);
  if (TAG >= 2) mant = __fadd_rn(__fmul_rn(mant, 65536.0f), (float)t1);
  if (TAG == 3) {
    mant = __fadd_rn(__fmul_rn(mant, 4294967296.0f), __uint2float_rn(t2));
  }
  return __fmul_rn(__fmul_rn(sgn, mant), scale);
}

}  // namespace gse
