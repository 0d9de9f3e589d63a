// The row bodies of the GSE-SEM SpMV and SpMM kernels, shared by the
// uniform layouts (gse_spmv.cu: A, gse_spmm.cu: C) and the SELL-C-sigma
// layout (gse_sell.cu: B, C').  A row is a run of stored slots starting at
// flat slot `base`; the callers differ only in how they find a row's slots
// and where they write its result, so B cannot drift from A, nor C' from C.
//
// * warp_row_f32 / warp_row_cols_f32 (A32, B32 / C32, C'32): one warp per
//   row, lane l adds slots l, l+32, ... of the row's `width` from 0.0, then
//   the warp's shuffle tree; the result is valid in lane 0.
// * row_sum_f64 / row_walk_f64 (A64 / C64): one thread walks the row's
//   real slots in stored order (CSR order) from 0.0 with
//   __dmul_rn/__dadd_rn, so no FMA contraction changes a bit.
// * warp_chain_f64 / warp_walk_f64 (B64 / C'64): the same chain, one warp
//   per row.  Lane l decodes and multiplies slot j0 + l of each 32-slot
//   chunk (coalesced loads, all lanes at once), then every lane adds the
//   chunk's products in slot order from __shfl_sync broadcasts: the sums
//   are row_sum_f64's / row_walk_f64's bit for bit, and a long row's chain
//   waits on one add per slot instead of a load (the next chunks' loads
//   are in flight while a chunk is added).  Lanes past the row's end (and
//   inactive columns) hold +0.0, which the chain adds unconditionally: a
//   chain from +0.0 never holds -0.0, so adding +0.0 changes no bit, and
//   the adds need no predicate.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_decode.cuh"

namespace gse {

constexpr int kCols = 8;  // right-hand-side columns per SpMM pass (registers)
// Columns per pass of the warp-row SpMM (C'64): the solve service's slot
// width.  The warp row broadcasts every product with a shuffle, and a
// dense row's warp is bound by the shuffles it issues, so a pass carries
// no column it does not need.
constexpr int kColsWarp = 4;

template <int TAG>
__device__ __forceinline__ float warp_row_f32(
    int64_t base, int width, int lane, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const float* __restrict__ x,
    const float* __restrict__ scales, int shift, uint32_t mask) {
  float acc = 0.0f;
  for (int j = lane; j < width; j += 32) {
    const int64_t k = base + j;
    const uint32_t cp = __ldg(colpak + k);
    const float val = decode_f32<TAG>(
        __ldg(head + k), TAG >= 2 ? __ldg(tail1 + k) : 0u,
        TAG == 3 ? __ldg(tail2 + k) : 0u, __ldg(scales + (cp >> shift)));
    acc = __fadd_rn(acc, __fmul_rn(val, __ldg(x + (cp & mask))));
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  return acc;
}

// The same walk for the `nc` (<= kCols) columns of X that start at `xg`,
// each column n long; each slot is decoded once for every column.
template <int TAG>
__device__ __forceinline__ void warp_row_cols_f32(
    int64_t base, int width, int lane, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const float* __restrict__ xg,
    int64_t n, int nc, const float* __restrict__ scales, int shift,
    uint32_t mask, float (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  for (int j = lane; j < width; j += 32) {
    const int64_t k = base + j;
    const uint32_t cp = __ldg(colpak + k);
    const float val = decode_f32<TAG>(
        __ldg(head + k), TAG >= 2 ? __ldg(tail1 + k) : 0u,
        TAG == 3 ? __ldg(tail2 + k) : 0u, __ldg(scales + (cp >> shift)));
    const int64_t col = cp & mask;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) {
        acc[c] = __fadd_rn(acc[c], __fmul_rn(val, __ldg(xg + c * n + col)));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    for (int off = 16; off > 0; off >>= 1) {
      acc[c] = __fadd_rn(acc[c], __shfl_down_sync(0xffffffffu, acc[c], off));
    }
  }
}

template <int TAG>
__device__ __forceinline__ double row_sum_f64(
    int64_t begin, int64_t end, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ x, int shift, uint32_t mask) {
  double acc = 0.0;
  for (int64_t k = begin; k < end; ++k) {
    const uint32_t cp = __ldg(colpak + k);
    const double val = decode_f64<TAG>(
        __ldg(head + k), TAG >= 2 ? __ldg(tail1 + k) : 0u,
        TAG == 3 ? __ldg(tail2 + k) : 0u, __ldg(table + (cp >> shift)) - 1023);
    acc = __dadd_rn(acc, __dmul_rn(val, __ldg(x + (cp & mask))));
  }
  return acc;
}

// y = A x at the device tag `*tag` (clipped to [1, 3] as the reference's
// lax.switch clips tag - 1): the branch is uniform across the grid and the
// tag-1 branch never loads a tail.
__device__ __forceinline__ double row_sum_f64_at(
    const int32_t* __restrict__ tag, int64_t begin, int64_t end,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    int shift, uint32_t mask) {
  int t = __ldg(tag);
  t = t < 1 ? 1 : (t > 3 ? 3 : t);
  if (t == 1) {
    return row_sum_f64<1>(begin, end, colpak, head, tail1, tail2, table, x,
                          shift, mask);
  } else if (t == 2) {
    return row_sum_f64<2>(begin, end, colpak, head, tail1, tail2, table, x,
                          shift, mask);
  }
  return row_sum_f64<3>(begin, end, colpak, head, tail1, tail2, table, x,
                        shift, mask);
}

// Per-column tags of one SpMM pass: tg[c] is column c0 + c's tag (clipped
// to [1, 3]) when active, 0 otherwise; `need` has bit t set when some
// active column runs tag t; returns the highest such tag (0: none).
template <int N>
__device__ __forceinline__ int column_tags(
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ active,
    int c0, int nc, int (&tg)[N], unsigned& need) {
  need = 0u;
  int maxtag = 0;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    tg[c] = 0;
    if (c < nc && __ldg(active + c0 + c)) {
      int t = __ldg(tags + c0 + c);
      t = t < 1 ? 1 : (t > 3 ? 3 : t);
      tg[c] = t;
      need |= 1u << t;
      maxtag = t > maxtag ? t : maxtag;
    }
  }
  return maxtag;
}

// One row's walk for the columns of this pass.  MAXTAG, the highest active
// tag, fixes which segments are loaded; each slot is decoded once per tag
// that some active column runs.
template <int MAXTAG>
__device__ __forceinline__ void row_walk_f64(
    int64_t begin, int64_t end, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ xg, int64_t n, int shift, uint32_t mask,
    const int (&tg)[kCols], unsigned need, double (&acc)[kCols]) {
  for (int64_t k = begin; k < end; ++k) {
    const uint32_t cp = __ldg(colpak + k);
    const uint32_t h = __ldg(head + k);
    const uint32_t t1 = MAXTAG >= 2 ? __ldg(tail1 + k) : 0u;
    const uint32_t t2 = MAXTAG == 3 ? __ldg(tail2 + k) : 0u;
    const int e_sh = __ldg(table + (cp >> shift)) - 1023;
    const double v1 = (need & 2u) ? decode_f64<1>(h, t1, t2, e_sh) : 0.0;
    const double v2 =
        (MAXTAG >= 2 && (need & 4u)) ? decode_f64<2>(h, t1, t2, e_sh) : 0.0;
    const double v3 =
        (MAXTAG == 3 && (need & 8u)) ? decode_f64<3>(h, t1, t2, e_sh) : 0.0;
    const int64_t col = cp & mask;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (tg[c] != 0) {
        const double v = tg[c] == 1 ? v1 : (tg[c] == 2 ? v2 : v3);
        acc[c] = __dadd_rn(acc[c], __dmul_rn(v, __ldg(xg + c * n + col)));
      }
    }
  }
}

// row_walk_f64 at the pass's highest active tag (uniform across the grid).
__device__ __forceinline__ void row_walk_f64_at(
    int maxtag, int64_t begin, int64_t end,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ xg,
    int64_t n, int shift, uint32_t mask, const int (&tg)[kCols],
    unsigned need, double (&acc)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0;
  if (maxtag == 1) {
    row_walk_f64<1>(begin, end, colpak, head, tail1, tail2, table, xg, n,
                    shift, mask, tg, need, acc);
  } else if (maxtag == 2) {
    row_walk_f64<2>(begin, end, colpak, head, tail1, tail2, table, xg, n,
                    shift, mask, tg, need, acc);
  } else if (maxtag == 3) {
    row_walk_f64<3>(begin, end, colpak, head, tail1, tail2, table, xg, n,
                    shift, mask, tg, need, acc);
  }
}

// The segments of one slot, loaded ahead of their use (zeros past the row).
struct Slot {
  uint32_t cp, h, t1, t2;
};

template <int TAG>
__device__ __forceinline__ Slot load_slot(
    int64_t k, bool ok, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2) {
  Slot s;
  s.cp = ok ? __ldg(colpak + k) : 0u;
  s.h = ok ? (uint32_t)__ldg(head + k) : 0u;
  s.t1 = (TAG >= 2 && ok) ? (uint32_t)__ldg(tail1 + k) : 0u;
  s.t2 = (TAG == 3 && ok) ? __ldg(tail2 + k) : 0u;
  return s;
}

// row_sum_f64 on one warp (see the top of the file); valid in every lane.
// Software-pipelined so a long row's chain does not wait on memory: while
// the warp adds chunk c, the segments of chunk c + 2 and the x values of
// chunk c + 1 are in flight.
template <int TAG>
__device__ __forceinline__ double warp_chain_f64(
    int64_t base, int len, int lane, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ x, int shift, uint32_t mask) {
  double acc = 0.0;
  if (len <= 0) return acc;
  const Slot s0 = load_slot<TAG>(base + lane, lane < len, colpak, head,
                                 tail1, tail2);
  Slot s1 = load_slot<TAG>(base + 32 + lane, 32 + lane < len, colpak, head,
                           tail1, tail2);
  double p = 0.0;
  if (lane < len) {
    p = __dmul_rn(decode_f64<TAG>(s0.h, s0.t1, s0.t2,
                                  __ldg(table + (s0.cp >> shift)) - 1023),
                  __ldg(x + (s0.cp & mask)));
  }
  for (int j0 = 0; j0 < len; j0 += 32) {
    const bool ok1 = j0 + 32 + lane < len;
    const double x1 = ok1 ? __ldg(x + (s1.cp & mask)) : 0.0;
    const int e1 = ok1 ? __ldg(table + (s1.cp >> shift)) - 1023 : 0;
    const Slot s2 = load_slot<TAG>(base + j0 + 64 + lane, j0 + 64 + lane < len,
                                   colpak, head, tail1, tail2);
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      acc = __dadd_rn(acc, __shfl_sync(0xffffffffu, p, s));
    }
    p = ok1 ? __dmul_rn(decode_f64<TAG>(s1.h, s1.t1, s1.t2, e1), x1) : 0.0;
    s1 = s2;
  }
  return acc;
}

// warp_chain_f64 at the device tag `*tag` (clipped to [1, 3]).
__device__ __forceinline__ double warp_chain_f64_at(
    const int32_t* __restrict__ tag, int64_t base, int len, int lane,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    int shift, uint32_t mask) {
  int t = __ldg(tag);
  t = t < 1 ? 1 : (t > 3 ? 3 : t);
  if (t == 1) {
    return warp_chain_f64<1>(base, len, lane, colpak, head, tail1, tail2,
                             table, x, shift, mask);
  } else if (t == 2) {
    return warp_chain_f64<2>(base, len, lane, colpak, head, tail1, tail2,
                             table, x, shift, mask);
  }
  return warp_chain_f64<3>(base, len, lane, colpak, head, tail1, tail2,
                           table, x, shift, mask);
}

// Column c's product for the slot `sl` (e_sh its scale exponent, xv the
// column's x value), decoded at the column's tag; 0.0 when inactive.
template <int MAXTAG, int N>
__device__ __forceinline__ void slot_products(
    const Slot& sl, int e_sh, const int (&tg)[N], unsigned need,
    const double (&xv)[N], double (&p)[N]) {
  const double v1 = (need & 2u) ? decode_f64<1>(sl.h, sl.t1, sl.t2, e_sh)
                                : 0.0;
  const double v2 = (MAXTAG >= 2 && (need & 4u))
                        ? decode_f64<2>(sl.h, sl.t1, sl.t2, e_sh) : 0.0;
  const double v3 = (MAXTAG == 3 && (need & 8u))
                        ? decode_f64<3>(sl.h, sl.t1, sl.t2, e_sh) : 0.0;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const double v = tg[c] == 1 ? v1 : (tg[c] == 2 ? v2 : v3);
    p[c] = tg[c] != 0 ? __dmul_rn(v, xv[c]) : 0.0;
  }
}

// row_walk_f64 on one warp: each column's chain as in warp_chain_f64, with
// the same software pipeline.  tg[] is uniform across the warp, so every
// shuffle is warp-wide.
template <int MAXTAG, int N>
__device__ __forceinline__ void warp_walk_f64(
    int64_t base, int len, int lane, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ xg, int64_t n, int shift, uint32_t mask,
    const int (&tg)[N], unsigned need, double (&acc)[N]) {
  if (len <= 0) return;
  double xv[N], p[N];
  const Slot s0 = load_slot<MAXTAG>(base + lane, lane < len, colpak, head,
                                    tail1, tail2);
  Slot s1 = load_slot<MAXTAG>(base + 32 + lane, 32 + lane < len, colpak,
                              head, tail1, tail2);
#pragma unroll
  for (int c = 0; c < N; ++c) {
    xv[c] = (tg[c] != 0 && lane < len) ? __ldg(xg + c * n + (s0.cp & mask))
                                       : 0.0;
  }
  slot_products<MAXTAG, N>(s0, lane < len ? __ldg(table + (s0.cp >> shift)) -
                                             1023 : 0,
                        tg, need, xv, p);
  for (int j0 = 0; j0 < len; j0 += 32) {
    const bool ok1 = j0 + 32 + lane < len;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      xv[c] = (tg[c] != 0 && ok1) ? __ldg(xg + c * n + (s1.cp & mask)) : 0.0;
    }
    const int e1 = ok1 ? __ldg(table + (s1.cp >> shift)) - 1023 : 0;
    const Slot s2 = load_slot<MAXTAG>(base + j0 + 64 + lane,
                                      j0 + 64 + lane < len, colpak, head,
                                      tail1, tail2);
    // Slot-outer, so the columns' independent chains interleave.
#pragma unroll
    for (int s = 0; s < 32; ++s) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[c] = __dadd_rn(acc[c], __shfl_sync(0xffffffffu, p[c], s));
      }
    }
    slot_products<MAXTAG, N>(s1, e1, tg, need, xv, p);
    s1 = s2;
  }
}

// warp_walk_f64 at the pass's highest active tag (uniform across the grid).
template <int N>
__device__ __forceinline__ void warp_walk_f64_at(
    int maxtag, int64_t base, int len, int lane,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ xg,
    int64_t n, int shift, uint32_t mask, const int (&tg)[N],
    unsigned need, double (&acc)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = 0.0;
  if (maxtag == 1) {
    warp_walk_f64<1, N>(base, len, lane, colpak, head, tail1, tail2, table, xg,
                     n, shift, mask, tg, need, acc);
  } else if (maxtag == 2) {
    warp_walk_f64<2, N>(base, len, lane, colpak, head, tail1, tail2, table, xg,
                     n, shift, mask, tg, need, acc);
  } else if (maxtag == 3) {
    warp_walk_f64<3, N>(base, len, lane, colpak, head, tail1, tail2, table, xg,
                     n, shift, mask, tg, need, acc);
  }
}

}  // namespace gse
