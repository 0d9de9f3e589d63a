// The row bodies of the GSE-SEM SpMV and SpMM kernels, shared by the
// uniform layouts (gse_spmv.cu: A, gse_spmm.cu: C) and the SELL-C-sigma
// layout (gse_sell.cu: B, C').  A row is a run of stored slots starting at
// flat slot `base`; the callers differ only in how they find a row's slots
// and where they write its result, so B cannot drift from A, nor C' from C.
//
// * group_row_f32 (A32, C32) and warp_row_f32 / warp_row_cols_f32 (B32's
//   / C'32's other rows, the same walk on 32 lanes): for each
//   column of a pass, the sum of the warp's 32 lane chains, lane l adding
//   slots l, l+32, ... from 0.0, then the warp's shuffle tree (offsets 16,
//   8, 4, 2, 1), on a group of G lanes: lane g of the group carries the
//   chains of lanes g, g+G, ..., and the tree's offsets of G and more add
//   within a lane, so the sum is the same on any G.  The SELL warp rows
//   run 32 lanes over the bucket width (padding included); A32 and C32
//   run `lanes` lanes over each row's real slots (`len`), and a row with
//   padding
//   adds the product a padded slot would (pad_products_f32: +-0.0 for a
//   finite x[0], so a chain from +0.0 keeps its bits, and NaN otherwise,
//   as the padded walk gives).  X is (n, nrhs) row-major (A32 and B32:
//   one column), a slot's four columns in one 16-byte load.
// * block_lanes_f32 / block_lanes_cols_f32 (B32's / C'32's long rows): the
//   same 32 lane chains and shuffle tree on one block.  Warps 1..7 decode
//   and multiply the row's slots a chunk ahead into shared memory
//   (double-buffered; C'32 stages a slot's four products side by side);
//   the 32 lanes of warp 0 then take slots l, l+32, ... of each chunk back
//   in order, so a lane's chain waits on one __fadd_rn per slot it adds,
//   not on a load (a 262,144-slot hub in 0.19-0.23 ms; with a warp a row
//   the whole kernel took 1.8-4 ms; NVIDIA H100 80GB HBM3, 700 W).  In
//   C'32 a lane's four column chains are independent, so four columns
//   cost one column's chain.
// * The f64 bodies (A64, B64, C64, C'64) all add a row's products in stored
//   order (CSR order) from 0.0 with __dmul_rn/__dadd_rn, so no FMA
//   contraction changes a bit and every body gives the same sums; they
//   differ only in which threads load, decode and multiply, and which
//   thread adds.  No f64 body walks a row on one thread:
//   - row_block_f64 (A64's short rows): a block stages the products of a
//     run of consecutive short rows in shared memory, every thread taking
//     slots t, t + 256, ... of the run (coalesced loads); then thread i
//     adds row i's products.
//   - row_block_cols_f64 (C64's short rows): the same for kColsWarp
//     columns, the run's products staged a chunk of 1024 slots at a time;
//     thread i's chains carry over from one chunk to the next (the
//     uniform operator at nrhs 4 in 0.36-0.40 ms, where one thread a row
//     took 0.98-1.65 ms).
//   - block_chain_f64 (A64's and B64's long rows): one block per row.
//     Warps 1..7 decode and multiply the row's slots a chunk at a time
//     into shared memory, double-buffered one chunk ahead; thread 0 reads
//     the chunk back in slot order with loads that do not depend on the
//     sum and adds it, so the chain waits on one __dadd_rn per slot and
//     on nothing else.
//   - block_chain_cols_f64 (C64's and C'64's long rows): the same for
//     kColsWarp columns; lane c of warp 0 adds column c, the four chains
//     in lockstep.
//   - warp_chain_f64 / warp_walk_f64 (A64's rows in between, B64's other
//     rows / C64's rows in between, C'64's other rows): one warp per row.
//     Lane l decodes and multiplies slot j0 + l of each 32-slot chunk
//     (coalesced loads, all lanes at once), then every lane adds the
//     chunk's products in slot order from __shfl_sync broadcasts.
//   The column bodies read X as (columns, n) (C'64) or, in C64, as an
//   interleaved copy whose four values of a matrix column share a
//   32-byte sector (x_values).
//   Slots past a row's end (and inactive columns) hold +0.0, which the
//   chains add unconditionally: a chain from +0.0 never holds -0.0, so
//   adding +0.0 changes no bit, and the adds need no predicate.  The same
//   holds for the f32 lane chains of block_lanes_f32 and for the +-0.0 a
//   padded slot adds to group_row_f32's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_decode.cuh"

namespace gse {

// Columns per pass of C32, C'32, C64 and C'64: the solve service's slot
// width.  A warp row broadcasts every product with a shuffle per column,
// and a long row's block chain adds each column on a lane of its own, so
// a pass carries no column it does not need; C32 and C'32 read a slot's
// four x values in one 16-byte load (a pass of eight was slower at nrhs 4).
constexpr int kColsWarp = 4;

// The segments of one slot, loaded ahead of their use (zeros past the row).
struct Slot {
  uint32_t cp, h, t1, t2;
};

// A read-only load; with CS a streaming one (__ldcs, evict first), for
// segments read once, which leaves the caches to the gathered x.
template <bool CS, typename T>
__device__ __forceinline__ T ld_seg(const T* __restrict__ p) {
  return CS ? __ldcs(p) : __ldg(p);
}

template <int TAG, bool CS = false>
__device__ __forceinline__ Slot load_slot(
    int64_t k, bool ok, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2) {
  Slot s;
  s.cp = ok ? ld_seg<CS>(colpak + k) : 0u;
  s.h = ok ? (uint32_t)ld_seg<CS>(head + k) : 0u;
  s.t1 = (TAG >= 2 && ok) ? (uint32_t)ld_seg<CS>(tail1 + k) : 0u;
  s.t2 = (TAG == 3 && ok) ? ld_seg<CS>(tail2 + k) : 0u;
  return s;
}

// The ELL operands of A32 and C32 (gse_spmv.cu, gse_spmm.cu): the (rows,
// width) row-major segments, x (A32: (n,); C32: (n, nrhs) row-major),
// the f32 scale table, each row's real slot count `row_len` (the CSR's
// diff(rowptr)) and y.
struct EllF32 {
  const uint32_t* colpak;
  const uint16_t* head;
  const uint16_t* tail1;
  const uint32_t* tail2;
  const float* x;
  const float* scales;
  const int32_t* row_len;
  float* y;
  int64_t rows;
  int width;
  int shift;
  uint32_t mask;
};

// Row `row`'s real slot count (0 past the last row), clipped to the ELL
// width so a bad length cannot read past its row.
__device__ __forceinline__ int ell_row_len(const EllF32& a, int64_t row) {
  if (row >= a.rows) return 0;
  const int len = __ldg(a.row_len + row);
  return len < 0 ? 0 : (len > a.width ? a.width : len);
}

// The warp's shuffle tree (offsets 16, 8, 4, 2, 1) over the 32 lane sums
// of a row held by a group of G lanes, lane g holding virtual lanes
// g + G k in acc[k]: the offsets 16 .. G add within the lane, the rest by
// shuffles within the group.  Valid in the group's lane 0.
template <int G, int K>
__device__ __forceinline__ float lane_tree(float (&acc)[K]) {
  static_assert(G * K == 32, "a group's lanes carry the warp's 32 lanes");
#pragma unroll
  for (int h = K / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int k = 0; k < h; ++k) acc[k] = __fadd_rn(acc[k], acc[k + h]);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc[0] = __fadd_rn(acc[0], __shfl_down_sync(0xffffffffu, acc[0], off, G));
  }
  return acc[0];
}

// The x values of a pass's N columns at matrix column `col` of an (n,
// ldx) row-major X whose pass starts at xg, into xv (0.0 for the columns
// past nc, and for all of them unless `ok`): a slot's columns share one
// 32-byte sector.  `vec` (N % 4 == 0, every pass full and every row
// 16-byte aligned) loads four columns at once.
template <int N>
__device__ __forceinline__ void x_row_f32(const float* __restrict__ xg,
                                          int64_t ldx, uint32_t col, int nc,
                                          bool vec, bool ok, float (&xv)[N]) {
  const float* src = xg + (int64_t)col * ldx;
  if (N % 4 == 0 && vec) {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(src) + h)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xv[4 * h] = v.x;
      xv[4 * h + 1] = v.y;
      xv[4 * h + 2] = v.z;
      xv[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) xv[c] = (ok && c < nc) ? __ldg(src + c) : 0.0f;
  }
}

// For each of the pass's N columns (x_row_f32's layout), the product a
// padded ELL slot (colpak 0, head 0) would add when `padded`, else 0.0:
// the decoded +0.0 times the column's x[0], so +-0.0 when x[0] and
// scales[0] are finite and NaN otherwise.  Added once to a row that has
// padding, it gives that row the padded walk's NaN without reading a
// padded slot.
template <int TAG, int N>
__device__ __forceinline__ void pad_products_f32(
    const float* __restrict__ xg, int64_t ldx, int nc, bool vec,
    const float* __restrict__ scales, bool padded, float (&pad)[N]) {
  float x0[N];
  x_row_f32<N>(xg, ldx, 0u, nc, vec, padded, x0);
  const float v0 = padded ? decode_f32<TAG>(0u, 0u, 0u, __ldg(scales)) : 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) pad[c] = padded ? __fmul_rn(v0, x0[c]) : 0.0f;
}

// One row's sums for the `nc` (<= N) columns of a pass of an (n, ldx)
// row-major X whose pass starts at xg, each in the lane order of A32's
// plain version, on a group of G lanes (G a power of two dividing 32, the
// group aligned in its warp): virtual lane v (0..31) adds the slots v,
// v+32, ... below `len` from 0.0 (column c's virtual lane 0 from 0.0 +
// pad[c]), and lane g of the group carries virtual lanes g, g+G, ... (K
// = 32 / G chains a column), so its slots are g, g+G, g+2G, ... in turn:
// coalesced across the group, K segment loads and K gathers in flight at
// once.  Each slot is decoded once for every column (x_row_f32: with
// `vec`, a slot's four columns in one 16-byte load); each column ends in
// its own lane_tree.  The segments are streamed (ld_seg's CS: on the
// uniform operator that cut C32's time and left A32's).  `len` may be
// below the stored width: the slots past it are never read (pad stands
// for them).  out[c] is valid in the group's lane 0; every lane of the
// warp must call it.
template <int TAG, int G, int N>
__device__ __forceinline__ void group_row_f32(
    int64_t base, int len, int g, const float (&pad)[N],
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ xg, int64_t ldx, int nc, bool vec,
    const float* __restrict__ scales, int shift, uint32_t mask,
    float (&out)[N]) {
  constexpr int K = 32 / G;
  float acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int c = 0; c < N; ++c) acc[k][c] = 0.0f;
  }
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) acc[0][c] = __fadd_rn(0.0f, pad[c]);
  }
  for (int j0 = 0; j0 < len; j0 += 32) {
    Slot sl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = j0 + g + G * k;
      sl[k] = load_slot<TAG, true>(base + j, j < len, colpak, head, tail1,
                                   tail2);
    }
    float sc[K], xv[K][N];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool ok = j0 + g + G * k < len;
      sc[k] = ok ? __ldg(scales + (sl[k].cp >> shift)) : 0.0f;
      x_row_f32<N>(xg, ldx, sl[k].cp & mask, nc, vec, ok, xv[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (j0 + g + G * k < len) {
        const float val = decode_f32<TAG>(sl[k].h, sl[k].t1, sl[k].t2, sc[k]);
#pragma unroll
        for (int c = 0; c < N; ++c) {
          acc[k][c] = __fadd_rn(acc[k][c], __fmul_rn(val, xv[k][c]));
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float col[K];
#pragma unroll
    for (int k = 0; k < K; ++k) col[k] = acc[k][c];
    out[c] = lane_tree<G, K>(col);
  }
}

// B32's and C'32's other rows (gse_sell.cu): group_row_f32's sum on a whole
// warp (G = 32) over the bucket width, padding included, written for that
// case.  The SELL warp rows on group_row_f32 itself ran slower at tags 2-3
// (B32 on the skewed operator 0.30/0.41 ms against 0.26/0.28; NVIDIA H100
// 80GB HBM3, 700 W), where the long-row blocks' registers leave few warps
// an SM beside them.
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

// warp_row_f32's walk for the `nc` (<= N) columns of a pass of an (n,
// ldx) row-major X whose pass starts at xg; each slot is decoded once for
// every column (with `vec`, x_row_f32's 16-byte loads).
template <int TAG, int N>
__device__ __forceinline__ void warp_row_cols_f32(
    int64_t base, int width, int lane, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const float* __restrict__ xg,
    int64_t ldx, int nc, bool vec,
    const float* __restrict__ scales, int shift, uint32_t mask,
    float (&acc)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = 0.0f;
  for (int j = lane; j < width; j += 32) {
    const int64_t k = base + j;
    const uint32_t cp = __ldg(colpak + k);
    const float val = decode_f32<TAG>(
        __ldg(head + k), TAG >= 2 ? __ldg(tail1 + k) : 0u,
        TAG == 3 ? __ldg(tail2 + k) : 0u, __ldg(scales + (cp >> shift)));
    if (N % 4 == 0 && vec) {
      float xv[N];
      x_row_f32<N>(xg, ldx, cp & mask, nc, true, true, xv);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[c] = __fadd_rn(acc[c], __fmul_rn(val, xv[c]));
      }
    } else {
      // Only the pass's columns.
      const float* src = xg + (int64_t)(cp & mask) * ldx;
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (c < nc) {
          acc[c] = __fadd_rn(acc[c], __fmul_rn(val, __ldg(src + c)));
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c) {
    for (int off = 16; off > 0; off >>= 1) {
      acc[c] = __fadd_rn(acc[c], __shfl_down_sync(0xffffffffu, acc[c], off));
    }
  }
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

// One row's sum on one warp (see the top of the file); valid in every lane.
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

// Threads of a chain block (block_chain_f64, block_chain_cols_f64 and
// row_block_f64), its producer threads (warps 1..7), and the products per
// chunk of block_chain_f64 (two buffers: 16 KB of shared memory).
constexpr int kChainThreads = 256;
constexpr int kChainProducers = kChainThreads - 32;
constexpr int kChainChunk = 1024;
constexpr int kChainPer = (kChainChunk + kChainProducers - 1) / kChainProducers;

// Products j = t, t + STRIDE, ... (PER of them, j < limit) of the slots
// [base, base + len) into buf[j], +0.0 for len <= j < limit: each thread
// loads all its slots' segments first, so its PER gathers are in flight
// together.
template <int TAG, int PER, int STRIDE>
__device__ __forceinline__ void stage_products(
    double* buf, int t, int limit, int64_t base, int len,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    int shift, uint32_t mask) {
  Slot sl[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * STRIDE;
    sl[u] = load_slot<TAG>(base + j, j < limit && j < len, colpak, head,
                           tail1, tail2);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * STRIDE;
    if (j >= limit) continue;
    double v = 0.0;
    if (j < len) {
      v = __dmul_rn(decode_f64<TAG>(sl[u].h, sl[u].t1, sl[u].t2,
                                    __ldg(table + (sl[u].cp >> shift)) - 1023),
                    __ldg(x + (sl[u].cp & mask)));
    }
    buf[j] = v;
  }
}

// acc plus the N products at src (16-byte aligned, N a multiple of 16),
// added in order.  Two register groups of 8: one is loaded while the
// other is added, so each add waits on the previous add only.
template <int N>
__device__ __forceinline__ double chain_add(const double* src_d, double acc) {
  double2 a[4], b[4];
  const double2* src = reinterpret_cast<const double2*>(src_d);
#pragma unroll
  for (int u = 0; u < 4; ++u) a[u] = src[u];
  for (int j = 0; j < N / 2; j += 8) {
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = src[j + 4 + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = __dadd_rn(acc, a[u].x);
      acc = __dadd_rn(acc, a[u].y);
    }
    if (j + 8 < N / 2) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = src[j + 8 + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = __dadd_rn(acc, b[u].x);
      acc = __dadd_rn(acc, b[u].y);
    }
  }
  return acc;
}

// One row's sum on one block of kChainThreads (see the top of the file);
// valid in thread 0.  Every thread of the block must call it.  The chain
// adds each chunk in full, the +0.0 past the row's end included.
template <int TAG>
__device__ __forceinline__ double block_chain_f64(
    double* buf, int64_t base, int len, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ x, int shift, uint32_t mask) {
  double acc = 0.0;
  const int chunks = (len + kChainChunk - 1) / kChainChunk;
  const bool producer = threadIdx.x >= 32;
  const int p = threadIdx.x - 32;
  if (producer && chunks > 0) {
    stage_products<TAG, kChainPer, kChainProducers>(
        buf, p, kChainChunk, base, len, colpak, head, tail1, tail2, table, x,
        shift, mask);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (producer) {
      if (c + 1 < chunks) {
        const int c1 = (c + 1) * kChainChunk;
        stage_products<TAG, kChainPer, kChainProducers>(
            buf + ((c + 1) & 1) * kChainChunk, p, kChainChunk, base + c1,
            len - c1, colpak, head, tail1, tail2, table, x, shift, mask);
      }
    } else if (threadIdx.x == 0) {
      acc = chain_add<kChainChunk>(buf + (c & 1) * kChainChunk, acc);
    }
    __syncthreads();
  }
  return acc;
}

// block_chain_f64 at the device tag `*tag` (clipped to [1, 3]).
__device__ __forceinline__ double block_chain_f64_at(
    const int32_t* __restrict__ tag, double* buf, int64_t base, int len,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    int shift, uint32_t mask) {
  int t = __ldg(tag);
  t = t < 1 ? 1 : (t > 3 ? 3 : t);
  if (t == 1) {
    return block_chain_f64<1>(buf, base, len, colpak, head, tail1, tail2,
                              table, x, shift, mask);
  } else if (t == 2) {
    return block_chain_f64<2>(buf, base, len, colpak, head, tail1, tail2,
                              table, x, shift, mask);
  }
  return block_chain_f64<3>(buf, base, len, colpak, head, tail1, tail2,
                            table, x, shift, mask);
}

// Most slots and rows of a row block (sparse/csr.py's ROW_BLOCK_SLOTS and
// ROW_BLOCK_ROWS): its products fill block_chain_f64's two buffers, and
// each thread adds one row.
constexpr int kRowBlockSlots = 2 * kChainChunk;
constexpr int kRowBlockRows = kChainThreads;

// Rows [r0, r1) of a CSR on one block of kChainThreads (see the top of the
// file): every thread stages products t, t + kChainThreads, ... of the
// slots [rowptr[r0], rowptr[r1]) (at most kRowBlockSlots) in buf, then
// thread i (i < r1 - r0 <= kRowBlockRows) adds row r0 + i's products in
// CSR order from 0.0 and writes y[r0 + i].  Thread i loads its row's
// bounds before the staging, so they arrive with the segments.  Every
// thread of the block must call it.
template <int TAG>
__device__ __forceinline__ void row_block_f64(
    double* buf, const int32_t* __restrict__ rowptr, int r0, int r1,
    int base, int len, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ x, double* __restrict__ y, int shift,
    uint32_t mask) {
  const int r = r0 + (int)threadIdx.x;
  const int beg = r < r1 ? __ldg(rowptr + r) - base : 0;
  const int end = r < r1 ? __ldg(rowptr + r + 1) - base : 0;
  stage_products<TAG, kRowBlockSlots / kChainThreads, kChainThreads>(
      buf, threadIdx.x, len, base, len, colpak, head, tail1, tail2, table, x,
      shift, mask);
  __syncthreads();
  if (r < r1) {
    double acc = 0.0;
#pragma unroll 4
    for (int j = beg; j < end; ++j) {
      acc = __dadd_rn(acc, buf[j]);
    }
    y[r] = acc;
  }
}

// row_block_f64 at the device tag `*tag` (clipped to [1, 3]).  A row block
// over its budgets is not one that sparse/csr.py's plan builds: its rows
// get NaN rather than overrun shared memory.
__device__ __forceinline__ void row_block_f64_at(
    const int32_t* __restrict__ tag, double* buf,
    const int32_t* __restrict__ rowptr, int r0, int r1,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    double* __restrict__ y, int shift, uint32_t mask) {
  const int base = __ldg(rowptr + r0);
  const int len = __ldg(rowptr + r1) - base;
  if (r1 < r0 || r1 - r0 > kRowBlockRows || len < 0 ||
      len > kRowBlockSlots) {
    const int r = r0 + (int)threadIdx.x;
    if (r < r1) y[r] = __longlong_as_double(0x7ff8000000000000LL);
    return;
  }
  int t = __ldg(tag);
  t = t < 1 ? 1 : (t > 3 ? 3 : t);
  if (t == 1) {
    row_block_f64<1>(buf, rowptr, r0, r1, base, len, colpak, head, tail1,
                     tail2, table, x, y, shift, mask);
  } else if (t == 2) {
    row_block_f64<2>(buf, rowptr, r0, r1, base, len, colpak, head, tail1,
                     tail2, table, x, y, shift, mask);
  } else {
    row_block_f64<3>(buf, rowptr, r0, r1, base, len, colpak, head, tail1,
                     tail2, table, x, y, shift, mask);
  }
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

// The pass's N x values at matrix column `col` into xv (0.0 unless `ok`).
// XI false: X as (columns, n), column c at xg + c * n, inactive columns
// not read.  XI true: C64's interleaved copy, the N values of column `col`
// side by side at xg + col * N (inactive columns hold 0.0), so with N ==
// kColsWarp one slot's gathers read one 32-byte sector, as two 16-byte
// loads.
template <bool XI, int N>
__device__ __forceinline__ void x_values(const double* __restrict__ xg,
                                         int64_t n, uint32_t col, bool ok,
                                         const int (&tg)[N],
                                         double (&xv)[N]) {
  static_assert(!XI || N % 2 == 0, "interleaved columns load in pairs");
  if (XI) {
    const double2* src =
        reinterpret_cast<const double2*>(xg + (int64_t)col * N);
#pragma unroll
    for (int h = 0; h < N / 2; ++h) {
      const double2 v = ok ? __ldg(src + h) : make_double2(0.0, 0.0);
      xv[2 * h] = v.x;
      xv[2 * h + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      xv[c] = (tg[c] != 0 && ok) ? __ldg(xg + c * n + col) : 0.0;
    }
  }
}

// One row's sums for the N columns of the pass on one warp: each column's
// chain as in warp_chain_f64, with the same software pipeline.  tg[] is
// uniform across the warp, so every shuffle is warp-wide.  XI: the layout
// of X (x_values).
template <int MAXTAG, int N, bool XI>
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
  x_values<XI, N>(xg, n, s0.cp & mask, lane < len, tg, xv);
  slot_products<MAXTAG, N>(s0, lane < len ? __ldg(table + (s0.cp >> shift)) -
                                             1023 : 0,
                        tg, need, xv, p);
  for (int j0 = 0; j0 < len; j0 += 32) {
    const bool ok1 = j0 + 32 + lane < len;
    x_values<XI, N>(xg, n, s1.cp & mask, ok1, tg, xv);
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
template <bool XI, int N>
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
    warp_walk_f64<1, N, XI>(base, len, lane, colpak, head, tail1, tail2,
                             table, xg, n, shift, mask, tg, need, acc);
  } else if (maxtag == 2) {
    warp_walk_f64<2, N, XI>(base, len, lane, colpak, head, tail1, tail2,
                             table, xg, n, shift, mask, tg, need, acc);
  } else if (maxtag == 3) {
    warp_walk_f64<3, N, XI>(base, len, lane, colpak, head, tail1, tail2,
                             table, xg, n, shift, mask, tg, need, acc);
  }
}

// Products per column per chunk of block_chain_cols_f64, and a column's
// stride in a buffer: two buffers of kColsWarp columns take 32.9 KB of
// shared memory (under the 48 KB static limit), and the stride of 514
// doubles puts consecutive columns 4 banks apart, so lanes 0-3 read their
// columns' 16-byte pairs without a bank conflict.
constexpr int kColsChunk = 512;
constexpr int kColsStride = kColsChunk + 2;
constexpr int kColsPer = (kColsChunk + kChainProducers - 1) / kChainProducers;

// Products [0, CHUNK) of the slots [base, base + len) for the N columns of
// the pass into buf[c * STRIDE + j] (+0.0 past len and for inactive
// columns), by thread t of THREADS taking slots t, t + THREADS, ... (PER
// of them, PER * THREADS >= CHUNK): each slot is decoded once per tag
// that some active column runs (slot_products).  Each thread loads all
// its slots' segments, then all their scale exponents and x values
// (x_values, layout XI), then multiplies, so its loads of each kind are
// in flight together.
template <int MAXTAG, int N, int CHUNK, int PER, int THREADS, int STRIDE,
          bool XI>
__device__ __forceinline__ void stage_products_cols(
    double* buf, int t, int64_t base, int len,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ xg,
    int64_t n, int shift, uint32_t mask, const int (&tg)[N],
    unsigned need) {
  Slot sl[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * THREADS;
    sl[u] = load_slot<MAXTAG>(base + j, j < CHUNK && j < len, colpak, head,
                              tail1, tail2);
  }
  int e_sh[PER];
  double xv[PER][N];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * THREADS;
    const bool ok = j < CHUNK && j < len;
    e_sh[u] = ok ? __ldg(table + (sl[u].cp >> shift)) - 1023 : 0;
    x_values<XI, N>(xg, n, sl[u].cp & mask, ok, tg, xv[u]);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * THREADS;
    if (j >= CHUNK) continue;
    double p[N];
    slot_products<MAXTAG, N>(sl[u], e_sh[u], tg, need, xv[u], p);
#pragma unroll
    for (int c = 0; c < N; ++c) buf[c * STRIDE + j] = j < len ? p[c] : 0.0;
  }
}

// One row's walk for the N columns of the pass on one block of
// kChainThreads (see the top of the file): block_chain_f64's producers
// and double buffer, and lane c of warp 0 adding column c's products, the
// N chains in lockstep.  Returns column threadIdx.x's sum in threads
// 0..N-1.  Every thread of the block must call it.  XI: the layout of X
// (x_values).
template <int MAXTAG, int N, bool XI>
__device__ __forceinline__ double block_chain_cols_f64(
    double* buf, int64_t base, int len, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ xg, int64_t n, int shift, uint32_t mask,
    const int (&tg)[N], unsigned need) {
  double acc = 0.0;
  const int chunks = (len + kColsChunk - 1) / kColsChunk;
  const bool producer = threadIdx.x >= 32;
  const int p = threadIdx.x - 32;
  if (producer && chunks > 0) {
    stage_products_cols<MAXTAG, N, kColsChunk, kColsPer, kChainProducers,
                        kColsStride, XI>(
        buf, p, base, len, colpak, head, tail1, tail2, table, xg, n, shift,
        mask, tg, need);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (producer) {
      if (c + 1 < chunks) {
        const int c1 = (c + 1) * kColsChunk;
        stage_products_cols<MAXTAG, N, kColsChunk, kColsPer, kChainProducers,
                            kColsStride, XI>(
            buf + ((c + 1) & 1) * N * kColsStride, p, base + c1, len - c1,
            colpak, head, tail1, tail2, table, xg, n, shift, mask, tg, need);
      }
    } else if (threadIdx.x < N) {
      acc = chain_add<kColsChunk>(
          buf + (c & 1) * N * kColsStride + threadIdx.x * kColsStride, acc);
    }
    __syncthreads();
  }
  return acc;
}

// block_chain_cols_f64 at the pass's highest active tag (uniform across
// the grid); 0.0 when no column is active.
template <bool XI, int N>
__device__ __forceinline__ double block_chain_cols_f64_at(
    int maxtag, double* buf, int64_t base, int len,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ xg,
    int64_t n, int shift, uint32_t mask, const int (&tg)[N],
    unsigned need) {
  if (maxtag == 1) {
    return block_chain_cols_f64<1, N, XI>(buf, base, len, colpak, head,
                                          tail1, tail2, table, xg, n, shift,
                                          mask, tg, need);
  } else if (maxtag == 2) {
    return block_chain_cols_f64<2, N, XI>(buf, base, len, colpak, head,
                                          tail1, tail2, table, xg, n, shift,
                                          mask, tg, need);
  } else if (maxtag == 3) {
    return block_chain_cols_f64<3, N, XI>(buf, base, len, colpak, head,
                                          tail1, tail2, table, xg, n, shift,
                                          mask, tg, need);
  }
  return 0.0;
}

// Products per chunk of row_block_cols_f64: kColsWarp columns of a chunk
// fit in block_chain_cols_f64's two buffers, so one static buffer of 32.9
// KB serves both bodies of C64's launch (the whole row block's 2048 slots
// would need 64 KB, past the 48 KB a block has without opting in to
// dynamic shared memory, and fewer blocks would fit an SM).
constexpr int kRowColsChunk = kRowBlockSlots / 2;
constexpr int kRowColsPer = kRowColsChunk / kChainThreads;
static_assert(kColsWarp * kRowColsChunk <= 2 * kColsWarp * kColsStride,
              "row_block_cols_f64's chunk must fit the block chain's buffers");
static_assert(kRowColsPer * kChainThreads == kRowColsChunk,
              "every thread stages the same number of a chunk's slots");

// Rows [r0, r1) of a CSR for the N columns of the pass on one block of
// kChainThreads (see the top of the file): for each chunk of
// kRowColsChunk slots of [rowptr[r0], rowptr[r1]) (at most
// kRowBlockSlots), every thread stages products t, t + kChainThreads, ...
// of the chunk in buf (stage_products_cols), then thread i
// (i < r1 - r0 <= kRowBlockRows) adds row r0 + i's products in the chunk
// to its N chains in CSR order; the chains start from 0.0 and carry over
// from chunk to chunk.  Writes yg[c * m + r0 + i] for c < nc.  Every
// thread of the block must call it.  XI: the layout of X (x_values).
template <int MAXTAG, int N, bool XI>
__device__ __forceinline__ void row_block_cols_f64(
    double* buf, const int32_t* __restrict__ rowptr, int r0, int r1,
    int base, int len, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ xg, int64_t n, int shift, uint32_t mask,
    const int (&tg)[N], unsigned need, double* __restrict__ yg, int64_t m,
    int nc) {
  const int r = r0 + (int)threadIdx.x;
  const int beg = r < r1 ? __ldg(rowptr + r) - base : 0;
  const int end = r < r1 ? __ldg(rowptr + r + 1) - base : 0;
  double acc[N];
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = 0.0;
  for (int c0 = 0; c0 < len; c0 += kRowColsChunk) {
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    stage_products_cols<MAXTAG, N, kRowColsChunk, kRowColsPer, kChainThreads,
                        kRowColsChunk, XI>(buf, threadIdx.x, base + c0,
                                           len - c0, colpak, head, tail1,
                                           tail2, table, xg, n, shift, mask,
                                           tg, need);
    __syncthreads();
    const int j1 = (end < c0 + kRowColsChunk ? end : c0 + kRowColsChunk) - c0;
#pragma unroll 4
    for (int j = (beg > c0 ? beg : c0) - c0; j < j1; ++j) {
#pragma unroll
      for (int c = 0; c < N; ++c) {
        acc[c] = __dadd_rn(acc[c], buf[c * kRowColsChunk + j]);
      }
    }
  }
  if (r < r1) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c < nc) yg[(int64_t)c * m + r] = acc[c];
    }
  }
}

// row_block_cols_f64 at the pass's highest active tag (uniform across the
// grid); 0.0 when no column is active.  A row block over its budgets is
// not one that sparse/csr.py's plan builds: its rows get NaN rather than
// overrun shared memory.
template <bool XI, int N>
__device__ __forceinline__ void row_block_cols_f64_at(
    int maxtag, double* buf, const int32_t* __restrict__ rowptr, int r0,
    int r1, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ xg, int64_t n, int shift, uint32_t mask,
    const int (&tg)[N], unsigned need, double* __restrict__ yg, int64_t m,
    int nc) {
  const int base = __ldg(rowptr + r0);
  const int len = __ldg(rowptr + r1) - base;
  const bool bad = r1 < r0 || r1 - r0 > kRowBlockRows || len < 0 ||
                   len > kRowBlockSlots;
  if (bad || maxtag == 0) {
    const int r = r0 + (int)threadIdx.x;
    const double v = bad ? __longlong_as_double(0x7ff8000000000000LL) : 0.0;
    for (int c = 0; c < nc && r < r1; ++c) yg[(int64_t)c * m + r] = v;
    return;
  }
  if (maxtag == 1) {
    row_block_cols_f64<1, N, XI>(buf, rowptr, r0, r1, base, len, colpak,
                                   head, tail1, tail2, table, xg, n, shift,
                                   mask, tg, need, yg, m, nc);
  } else if (maxtag == 2) {
    row_block_cols_f64<2, N, XI>(buf, rowptr, r0, r1, base, len, colpak,
                                   head, tail1, tail2, table, xg, n, shift,
                                   mask, tg, need, yg, m, nc);
  } else {
    row_block_cols_f64<3, N, XI>(buf, rowptr, r0, r1, base, len, colpak,
                                   head, tail1, tail2, table, xg, n, shift,
                                   mask, tg, need, yg, m, nc);
  }
}

// f32 products per chunk of block_lanes_f32 (two buffers: 16 KB of shared
// memory); a multiple of 32, so every chunk starts at lane 0.
constexpr int kLanesChunk = 2048;
constexpr int kLanesPer = (kLanesChunk + kChainProducers - 1) / kChainProducers;
static_assert(kLanesChunk % 32 == 0, "a chunk must start at lane 0");

// The segments of producer t's slots of the chunk [base, base + len) of
// CHUNK slots (zeros past len).
template <int TAG, int CHUNK = kLanesChunk, int PER = kLanesPer>
__device__ __forceinline__ void load_slots_f32(
    Slot (&sl)[PER], int t, int64_t base, int len,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2) {
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * kChainProducers;
    sl[u] = load_slot<TAG>(base + j, j < CHUNK && j < len, colpak, head,
                           tail1, tail2);
  }
}

// The f32 products [0, kLanesChunk) of a chunk of `len` slots whose
// segments producer t holds in sl, into buf[j] (+0.0 for len <= j): each
// is warp_row_f32's product of its slot.  All the scales and x values are
// loaded before the first product, so they are in flight together.
template <int TAG>
__device__ __forceinline__ void finish_products_f32(
    float* buf, const Slot (&sl)[kLanesPer], int t, int len,
    const float* __restrict__ x, const float* __restrict__ scales, int shift,
    uint32_t mask) {
  float sc[kLanesPer], xv[kLanesPer];
#pragma unroll
  for (int u = 0; u < kLanesPer; ++u) {
    const int j = t + u * kChainProducers;
    const bool ok = j < kLanesChunk && j < len;
    sc[u] = ok ? __ldg(scales + (sl[u].cp >> shift)) : 0.0f;
    xv[u] = ok ? __ldg(x + (sl[u].cp & mask)) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kLanesPer; ++u) {
    const int j = t + u * kChainProducers;
    if (j >= kLanesChunk) continue;
    buf[j] = j < len ? __fmul_rn(decode_f32<TAG>(sl[u].h, sl[u].t1, sl[u].t2,
                                                 sc[u]),
                                 xv[u])
                     : 0.0f;
  }
}

// warp_row_f32's sum of one row of `width` slots on one block of
// kChainThreads (see the top of the file): the producers (warps 1..7)
// stage the products a chunk ahead, lane l of warp 0 adds slots l, l+32,
// ... of each chunk in order from 0.0 (the +0.0 past the row's end
// included), then warp 0's shuffle tree.  Valid in thread 0.  Every
// thread of the block must call it.  While a producer finishes chunk
// c + 1's products, the segments of chunk c + 2 are already in flight.
template <int TAG>
__device__ __forceinline__ float block_lanes_f32(
    float* buf, int64_t base, int width, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const float* __restrict__ x,
    const float* __restrict__ scales, int shift, uint32_t mask) {
  float acc = 0.0f;
  const int chunks = (width + kLanesChunk - 1) / kLanesChunk;
  const bool producer = threadIdx.x >= 32;
  const int p = threadIdx.x - 32;
  Slot sl[kLanesPer];
  if (producer && chunks > 0) {
    load_slots_f32<TAG>(sl, p, base, width, colpak, head, tail1, tail2);
    finish_products_f32<TAG>(buf, sl, p, width, x, scales, shift, mask);
    load_slots_f32<TAG>(sl, p, base + kLanesChunk, width - kLanesChunk,
                        colpak, head, tail1, tail2);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (producer) {
      if (c + 1 < chunks) {
        const int c1 = (c + 1) * kLanesChunk;
        Slot next[kLanesPer];  // zeros past the row's last chunk
        load_slots_f32<TAG>(next, p, base + c1 + kLanesChunk,
                            width - c1 - kLanesChunk, colpak, head, tail1,
                            tail2);
        finish_products_f32<TAG>(buf + ((c + 1) & 1) * kLanesChunk, sl, p,
                                 width - c1, x, scales, shift, mask);
#pragma unroll
        for (int u = 0; u < kLanesPer; ++u) sl[u] = next[u];
      }
    } else {
      const float* src = buf + (c & 1) * kLanesChunk + threadIdx.x;
#pragma unroll 16
      for (int k = 0; k < kLanesChunk; k += 32) acc = __fadd_rn(acc, src[k]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    }
  }
  return acc;
}

// --- C'32's long rows: block_lanes_f32 for the columns of a pass ------------

// f32 values staged per buffer of block_lanes_cols_f32 (two buffers: 32 KB
// of shared memory); a chunk holds kLanesColsFloats / N slots, each
// slot's N products side by side.
constexpr int kLanesColsFloats = 4096;

// The N-column products [0, CHUNK) of a chunk of `len` slots whose
// segments producer t holds in sl, into buf[j * N + c] (+0.0 for len <=
// j): each is warp_row_cols_f32's product of its slot and column, stored
// with 16-byte writes.  The scales and x values are all loaded before the
// first product.
template <int TAG, int N, int CHUNK, int PER>
__device__ __forceinline__ void finish_products_cols_f32(
    float* buf, const Slot (&sl)[PER], int t, int len,
    const float* __restrict__ xg, int64_t ldx, int nc, bool vec,
    const float* __restrict__ scales, int shift, uint32_t mask) {
  static_assert(N % 4 == 0, "a slot's products are stored as float4");
  float sc[PER], xv[PER][N];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * kChainProducers;
    const bool ok = j < CHUNK && j < len;
    sc[u] = ok ? __ldg(scales + (sl[u].cp >> shift)) : 0.0f;
    x_row_f32<N>(xg, ldx, sl[u].cp & mask, nc, vec, ok, xv[u]);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int j = t + u * kChainProducers;
    if (j >= CHUNK) continue;
    const bool ok = j < len;
    const float val = decode_f32<TAG>(sl[u].h, sl[u].t1, sl[u].t2, sc[u]);
    float4* dst = reinterpret_cast<float4*>(buf + j * N);
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      dst[h] = ok ? make_float4(__fmul_rn(val, xv[u][4 * h]),
                                __fmul_rn(val, xv[u][4 * h + 1]),
                                __fmul_rn(val, xv[u][4 * h + 2]),
                                __fmul_rn(val, xv[u][4 * h + 3]))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// warp_row_cols_f32's sums of one row of `width` slots for the `nc` (<= N)
// columns of a pass of an (n, ldx) row-major X, on one block of
// kChainThreads: block_lanes_f32 with each slot's N products staged side by
// side.  The producers (warps 1..7) decode each slot once, multiply it by
// each column's x and stage a chunk ahead; lane l of warp 0 takes slot l,
// l+32, ... of each chunk back with one 16-byte shared load per four
// columns and adds it to its N chains (independent of each other), from
// 0.0, then warp 0's shuffle tree per column.  So each column is bitwise
// warp_row_cols_f32's, and a lone column block_lanes_f32's.  Valid in
// thread 0.  Every thread of the block must call it.
template <int TAG, int N>
__device__ __forceinline__ void block_lanes_cols_f32(
    float* buf, int64_t base, int width, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const float* __restrict__ xg,
    int64_t ldx, int nc, bool vec, const float* __restrict__ scales,
    int shift, uint32_t mask, float (&acc)[N]) {
  constexpr int kChunk = kLanesColsFloats / N;
  constexpr int kPer = (kChunk + kChainProducers - 1) / kChainProducers;
  static_assert(kChunk % 32 == 0, "a chunk must start at lane 0");
#pragma unroll
  for (int c = 0; c < N; ++c) acc[c] = 0.0f;
  const int chunks = (width + kChunk - 1) / kChunk;
  const bool producer = threadIdx.x >= 32;
  const int p = threadIdx.x - 32;
  Slot sl[kPer];
  if (producer && chunks > 0) {
    load_slots_f32<TAG, kChunk, kPer>(sl, p, base, width, colpak, head,
                                      tail1, tail2);
    finish_products_cols_f32<TAG, N, kChunk, kPer>(
        buf, sl, p, width, xg, ldx, nc, vec, scales, shift, mask);
    load_slots_f32<TAG, kChunk, kPer>(sl, p, base + kChunk, width - kChunk,
                                      colpak, head, tail1, tail2);
  }
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    if (producer) {
      if (c + 1 < chunks) {
        const int c1 = (c + 1) * kChunk;
        Slot next[kPer];  // zeros past the row's last chunk
        load_slots_f32<TAG, kChunk, kPer>(next, p, base + c1 + kChunk,
                                          width - c1 - kChunk, colpak, head,
                                          tail1, tail2);
        finish_products_cols_f32<TAG, N, kChunk, kPer>(
            buf + ((c + 1) & 1) * kLanesColsFloats, sl, p, width - c1, xg,
            ldx, nc, vec, scales, shift, mask);
#pragma unroll
        for (int u = 0; u < kPer; ++u) sl[u] = next[u];
      }
    } else {
      const float4* src = reinterpret_cast<const float4*>(
                              buf + (c & 1) * kLanesColsFloats) +
                          threadIdx.x * (N / 4);
#pragma unroll 8
      for (int k = 0; k < kChunk; k += 32) {
#pragma unroll
        for (int h = 0; h < N / 4; ++h) {
          const float4 v = src[k * (N / 4) + h];
          acc[4 * h] = __fadd_rn(acc[4 * h], v.x);
          acc[4 * h + 1] = __fadd_rn(acc[4 * h + 1], v.y);
          acc[4 * h + 2] = __fadd_rn(acc[4 * h + 2], v.z);
          acc[4 * h + 3] = __fadd_rn(acc[4 * h + 3], v.w);
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < 32) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      for (int off = 16; off > 0; off >>= 1) {
        acc[c] = __fadd_rn(acc[c], __shfl_down_sync(0xffffffffu, acc[c], off));
      }
    }
  }
}

}  // namespace gse
