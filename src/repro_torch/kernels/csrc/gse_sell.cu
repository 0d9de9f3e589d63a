// Kernels B and C' on Hopper: the GSE-SEM SpMV and SpMM over the SELL-C-sigma
// layout, four builds.
//
// Replaces the Pallas functions `gse_spmv_sell_call` (src/repro/kernels/
// gse_spmv.py:178, kernel B) and `gse_spmm_sell_call` (src/repro/kernels/
// gse_spmm.py:155, kernel C').  The reference runs A's (C's) `pallas_call`
// once per width bucket, concatenates the bucket outputs and restores the
// row order with an `unperm` gather.  Here one launch covers every bucket:
// the kernels read the reference's row-major (rows_b, w_b) bucket arrays
// through their flat concatenation, a small device table gives each
// bucket's first row, width and flat slot offset (64-bit, so a pack past
// 2^31 slots cannot overflow), and each bucket row writes y[perm[r]]
// itself; slice-padding rows (perm == -1) write nothing.  No host loop over
// buckets runs on the solver path.  The row bodies are A's and C's
// (gse_rows.cuh), so:
//
// * B32 (`gse_spmv_sell_f32`, ops.gse_spmv_sell): one warp per bucket row,
//   A32's lane order over the row's bucket width.  The slots uniform ELL
//   adds beyond that width decode to exact zeros, so for finite x each row
//   is bitwise A32's.  Padded slots are read, as the reference kernel reads
//   them (column 0, head 0): with a non-finite x[0] the NaN rows are the
//   reference SELL kernel's.
// * B64 (`gse_spmv_sell_f64`, spmv_gse over a GSESellC, the CG operator):
//   each row's products added in slot order, which is CSR order, from 0.0
//   with A64's __dmul_rn/__dadd_rn chain, at a device tag: each row is
//   bitwise A64's, and padded slots are never read.  Rows of the buckets
//   at least B64_BLOCK_WIDTH (sparse/csr.py) wide (the pack's `long_from` on: the
//   widths ascend, so they are the last bucket rows) get a block each,
//   launched first: block_chain_f64 (gse_rows.cuh) keeps the chain off the
//   shuffles, so a dense row costs one dependent add per slot.  The other
//   rows get a warp each, eight to a block (warp_chain_f64: the lanes
//   decode and multiply 32 consecutive slots at once, and every lane adds
//   them from shuffle broadcasts).
// * C'32 (`gse_spmm_sell_f32`, ops.gse_spmm_sell): C32's warp row over the
//   bucket width, each slot decoded once for every column; Y is (m, nrhs).
//   Per column bitwise C32, at nrhs = 1 bitwise B32.
// * C'64 (`gse_spmm_sell_f64`, spmm_gse over a GSESellC, the batched CG
//   operator): B64's warp row for every column, C64's per-column device
//   tags and active flags, the segments of the highest active tag loaded
//   once per pass of four columns (the service's slot width); column j
//   bitwise B64 at tags[j], and so C64; Y is (nrhs, m), inactive columns
//   0.0.
//
// What bounds it: HBM bytes.  The byte bound of one call is
// sell.bytes_touched(tag) (every padded slot's segments and colidx, perm,
// the exponent table) plus the x and y vectors: (m + n) * 4 (B32) or * 8
// (B64), nrhs * (m + n) * 4 | 8 for C'.  The f64 builds read only real
// slots, so they stream less than that model charges.
//
// The simple orders are kept for parity with A and C.  A dense row (the
// skewed operators' hubs, 262,144 entries) is one serial chain of
// dependent adds: bitwise parity with the CSR reference requires it, and
// no row's sum is split, so its bound is the chain, one __dadd_rn latency
// per slot, not the bytes.  A64's one thread per row waited on a load for
// every step of that chain (45-67 ms per SpMV on the full-size skewed
// operator; NVIDIA H100 80GB HBM3, 700 W); the warp row keeps the chain
// but loads and decodes 32 slots at a time and is then bound by its
// shuffles (about 15 ns a slot, 4.1-5.4 ms for B64 there).  B64's long
// rows run block_chain_f64, which leaves the add as the chain's only
// step; C'64 runs the warp row, two warps per block (the hub rows spread
// over SMs), and shuffles four columns.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_rows.cuh"

namespace {

constexpr int kThreads = 256;
// C'64's warp rows (and B64's earlier design) run in blocks of two warps,
// so the few rows of a dense bucket (the hubs) land on different SMs
// instead of sharing one SM's shuffle unit.
constexpr int kThreadsWarp = 64;
using gse::kChainThreads;
using gse::kCols;
using gse::kColsWarp;

// First flat slot and width of bucket row r.  `tab` holds one row
// [first row, width, flat offset] per bucket, first rows ascending.
__device__ __forceinline__ int64_t locate(const int64_t* __restrict__ tab,
                                          int nb, int64_t r, int& width) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(tab + 3 * mid) <= r) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int64_t w = __ldg(tab + 3 * lo + 1);
  width = (int)w;
  return __ldg(tab + 3 * lo + 2) + (r - __ldg(tab + 3 * lo)) * w;
}

template <int TAG>
__global__ void __launch_bounds__(kThreads) spmv_sell_f32_kernel(
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ x, const float* __restrict__ scales,
    float* __restrict__ y, const int64_t* __restrict__ tab, int nb,
    const int32_t* __restrict__ perm, int64_t rows_pad, int shift,
    uint32_t mask) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows_pad) return;  // uniform across the warp
  const int dst = __ldg(perm + row);
  if (dst < 0) return;  // slice padding row, uniform across the warp
  int width;
  const int64_t base = locate(tab, nb, row, width);
  const float acc = gse::warp_row_f32<TAG>(base, width, lane, colpak, head,
                                           tail1, tail2, x, scales, shift,
                                           mask);
  if (lane == 0) y[dst] = acc;
}

// Blocks [0, rows_pad - long_from) take bucket rows long_from, ... one
// each (block_chain_f64); the blocks after them take rows [0, long_from),
// one per warp (warp_chain_f64).
__global__ void __launch_bounds__(kChainThreads) spmv_sell_f64_kernel(
    const int32_t* __restrict__ tag, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ x, double* __restrict__ y,
    const int64_t* __restrict__ tab, int nb, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ row_len, int64_t rows_pad, int64_t long_from,
    int shift, uint32_t mask) {
  __shared__ __align__(16) double buf[2 * gse::kChainChunk];
  const int64_t n_long = rows_pad - long_from;
  if ((int64_t)blockIdx.x < n_long) {
    const int64_t row = long_from + blockIdx.x;
    const int dst = __ldg(perm + row);
    if (dst < 0) return;  // uniform across the block
    int width;
    const int64_t base = locate(tab, nb, row, width);
    const double acc = gse::block_chain_f64_at(
        tag, buf, base, __ldg(row_len + row), colpak, head, tail1, tail2,
        table, x, shift, mask);
    if (threadIdx.x == 0) y[dst] = acc;
    return;
  }
  const int64_t row = ((int64_t)blockIdx.x - n_long) * (kChainThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= long_from) return;  // uniform across the warp
  const int dst = __ldg(perm + row);
  if (dst < 0) return;
  int width;
  const int64_t base = locate(tab, nb, row, width);
  const double acc = gse::warp_chain_f64_at(
      tag, base, __ldg(row_len + row), lane, colpak, head, tail1, tail2,
      table, x, shift, mask);
  if (lane == 0) y[dst] = acc;
}

// The earlier B64 design, kept only as the yardstick chip_smoke.py times
// the block chain against (no solver path launches it): every row on one
// warp (warp_chain_f64), two warps per block.
__global__ void __launch_bounds__(kThreadsWarp) spmv_sell_f64_warp_kernel(
    const int32_t* __restrict__ tag, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ x, double* __restrict__ y,
    const int64_t* __restrict__ tab, int nb, const int32_t* __restrict__ perm,
    const int32_t* __restrict__ row_len, int64_t rows_pad, int shift,
    uint32_t mask) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows_pad) return;  // uniform across the warp
  const int dst = __ldg(perm + row);
  if (dst < 0) return;
  int width;
  const int64_t base = locate(tab, nb, row, width);
  const double acc = gse::warp_chain_f64_at(
      tag, base, __ldg(row_len + row), lane, colpak, head, tail1, tail2,
      table, x, shift, mask);
  if (lane == 0) y[dst] = acc;
}

template <int TAG>
__global__ void __launch_bounds__(kThreads) spmm_sell_f32_kernel(
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ x, const float* __restrict__ scales,
    float* __restrict__ y, const int64_t* __restrict__ tab, int nb,
    const int32_t* __restrict__ perm, int64_t rows_pad, int64_t n, int nrhs,
    int shift, uint32_t mask) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows_pad) return;  // uniform across the warp
  const int dst = __ldg(perm + row);
  if (dst < 0) return;
  const int c0 = blockIdx.y * kCols;
  const int nc = nrhs - c0 < kCols ? nrhs - c0 : kCols;
  int width;
  const int64_t base = locate(tab, nb, row, width);
  float acc[kCols];
  gse::warp_row_cols_f32<TAG>(base, width, lane, colpak, head, tail1, tail2,
                              x + (int64_t)c0 * n, n, nc, scales, shift, mask,
                              acc);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) y[(int64_t)dst * nrhs + c0 + c] = acc[c];
    }
  }
}

__global__ void __launch_bounds__(kThreadsWarp) spmm_sell_f64_kernel(
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ active,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    double* __restrict__ y, const int64_t* __restrict__ tab, int nb,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ row_len,
    int64_t rows_pad, int64_t m, int64_t n, int nrhs, int shift,
    uint32_t mask) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows_pad) return;  // uniform across the warp
  const int dst = __ldg(perm + row);
  if (dst < 0) return;
  const int c0 = blockIdx.y * kColsWarp;
  const int nc = nrhs - c0 < kColsWarp ? nrhs - c0 : kColsWarp;
  int tg[kColsWarp];
  unsigned need;
  // maxtag is uniform across the grid: no divergence.
  const int maxtag = gse::column_tags(tags, active, c0, nc, tg, need);
  int width;
  const int64_t base = locate(tab, nb, row, width);
  double acc[kColsWarp];
  gse::warp_walk_f64_at(maxtag, base, __ldg(row_len + row), lane, colpak,
                        head, tail1, tail2, table, x + (int64_t)c0 * n, n,
                        shift, mask, tg, need, acc);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsWarp; ++c) {
      if (c < nc) y[(int64_t)(c0 + c) * m + dst] = acc[c];
    }
  }
}

}  // namespace

// y (m,) f32 = A x over the SELL buckets at `tag`; x is (n,) f32.
extern "C" int gse_spmv_sell_f32(int tag, const void* colpak, const void* head,
                                 const void* tail1, const void* tail2,
                                 const void* x, const void* scales, void* y,
                                 const void* tab, int nb, const void* perm,
                                 long long rows_pad, int ei_bit,
                                 void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long blocks = (rows_pad * 32 + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* cp = (const uint32_t*)colpak;
  const uint16_t* hd = (const uint16_t*)head;
  const uint16_t* t1 = (const uint16_t*)tail1;
  const uint32_t* t2 = (const uint32_t*)tail2;
  const float* xs = (const float*)x;
  const float* sc = (const float*)scales;
  float* out = (float*)y;
  const int64_t* tb = (const int64_t*)tab;
  const int32_t* pm = (const int32_t*)perm;
  if (tag == 1) {
    spmv_sell_f32_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, shift, mask);
  } else if (tag == 2) {
    spmv_sell_f32_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, shift, mask);
  } else if (tag == 3) {
    spmv_sell_f32_kernel<3><<<(unsigned)blocks, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, shift, mask);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// y (m,) f64 = A x over the SELL buckets at the device tag; x is (n,) f64.
// Bucket rows [long_from, rows_pad) run a block each.
extern "C" int gse_spmv_sell_f64(const void* tag, const void* colpak,
                                 const void* head, const void* tail1,
                                 const void* tail2, const void* table,
                                 const void* x, void* y, const void* tab,
                                 int nb, const void* perm, const void* row_len,
                                 long long rows_pad, long long long_from,
                                 int ei_bit, void* stream) {
  if (long_from < 0 || long_from > rows_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long warps = kChainThreads / 32;
  const long long blocks = (rows_pad - long_from) +
                           (long_from + warps - 1) / warps;
  if (blocks > 0) {
    spmv_sell_f64_kernel<<<(unsigned)blocks, kChainThreads, 0,
                           (cudaStream_t)stream>>>(
        (const int32_t*)tag, (const uint32_t*)colpak, (const uint16_t*)head,
        (const uint16_t*)tail1, (const uint32_t*)tail2,
        (const int32_t*)table, (const double*)x, (double*)y,
        (const int64_t*)tab, nb, (const int32_t*)perm,
        (const int32_t*)row_len, rows_pad, long_from, shift, mask);
  }
  return (int)cudaGetLastError();
}

// The earlier B64 design (spmv_sell_f64_warp_kernel): timed beside
// gse_spmv_sell_f64 only.
extern "C" int gse_spmv_sell_f64_warp(const void* tag, const void* colpak,
                                      const void* head, const void* tail1,
                                      const void* tail2, const void* table,
                                      const void* x, void* y, const void* tab,
                                      int nb, const void* perm,
                                      const void* row_len, long long rows_pad,
                                      int ei_bit, void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long blocks = (rows_pad * 32 + kThreadsWarp - 1) / kThreadsWarp;
  if (blocks > 0) {
    spmv_sell_f64_warp_kernel<<<(unsigned)blocks, kThreadsWarp, 0,
                                (cudaStream_t)stream>>>(
        (const int32_t*)tag, (const uint32_t*)colpak, (const uint16_t*)head,
        (const uint16_t*)tail1, (const uint32_t*)tail2,
        (const int32_t*)table, (const double*)x, (double*)y,
        (const int64_t*)tab, nb, (const int32_t*)perm,
        (const int32_t*)row_len, rows_pad, shift, mask);
  }
  return (int)cudaGetLastError();
}

// Y (m, nrhs) f32 = A X over the SELL buckets at `tag`; X is (nrhs, n) f32.
extern "C" int gse_spmm_sell_f32(int tag, const void* colpak, const void* head,
                                 const void* tail1, const void* tail2,
                                 const void* x, const void* scales, void* y,
                                 const void* tab, int nb, const void* perm,
                                 long long rows_pad, long long n, int nrhs,
                                 int ei_bit, void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const dim3 grid((unsigned)((rows_pad * 32 + kThreads - 1) / kThreads),
                  (unsigned)((nrhs + kCols - 1) / kCols));
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* cp = (const uint32_t*)colpak;
  const uint16_t* hd = (const uint16_t*)head;
  const uint16_t* t1 = (const uint16_t*)tail1;
  const uint32_t* t2 = (const uint32_t*)tail2;
  const float* xs = (const float*)x;
  const float* sc = (const float*)scales;
  float* out = (float*)y;
  const int64_t* tb = (const int64_t*)tab;
  const int32_t* pm = (const int32_t*)perm;
  if (tag == 1) {
    spmm_sell_f32_kernel<1><<<grid, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, n, nrhs, shift,
        mask);
  } else if (tag == 2) {
    spmm_sell_f32_kernel<2><<<grid, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, n, nrhs, shift,
        mask);
  } else if (tag == 3) {
    spmm_sell_f32_kernel<3><<<grid, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, n, nrhs, shift,
        mask);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Y (nrhs, m) f64 = A X over the SELL buckets, column j at tags[j] when
// active[j]; X is (nrhs, n) f64.
extern "C" int gse_spmm_sell_f64(const void* tags, const void* active,
                                 const void* colpak, const void* head,
                                 const void* tail1, const void* tail2,
                                 const void* table, const void* x, void* y,
                                 const void* tab, int nb, const void* perm,
                                 const void* row_len, long long rows_pad,
                                 long long m, long long n, int nrhs,
                                 int ei_bit, void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const dim3 grid((unsigned)((rows_pad * 32 + kThreadsWarp - 1) / kThreadsWarp),
                  (unsigned)((nrhs + kColsWarp - 1) / kColsWarp));
  spmm_sell_f64_kernel<<<grid, kThreadsWarp, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tags, (const uint8_t*)active, (const uint32_t*)colpak,
      (const uint16_t*)head, (const uint16_t*)tail1, (const uint32_t*)tail2,
      (const int32_t*)table, (const double*)x, (double*)y,
      (const int64_t*)tab, nb, (const int32_t*)perm, (const int32_t*)row_len,
      rows_pad, m, n, nrhs, shift, mask);
  return (int)cudaGetLastError();
}
