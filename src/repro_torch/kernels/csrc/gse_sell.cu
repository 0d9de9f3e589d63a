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
// * B32 (`gse_spmv_sell_f32`, ops.gse_spmv_sell): A32's lane order over
//   the row's bucket width: lane l adds slots l, l+32, ... from 0.0, then
//   the warp's shuffle tree.  The slots uniform ELL adds beyond that width
//   decode to exact zeros, so for finite x each row is bitwise A32's.
//   Padded slots are read, as the reference kernel reads them (column 0,
//   head 0): with a non-finite x[0] the NaN rows are the reference SELL
//   kernel's.  Rows from the pack's `long_from` on (B64's long rows) get a
//   block each, launched first (block_lanes_f32): producer warps decode and
//   multiply the row a chunk of 2048 slots ahead into shared memory, and
//   the 32 lanes of warp 0 add each chunk in that lane order, so a lane
//   waits on one __fadd_rn per slot it adds, not on a load round.  A
//   producer holds the next chunk's segments in registers while it
//   finishes this one's products, so a chunk costs about one memory
//   latency, not two.  The other rows get a warp each (warp_row_f32),
//   eight to a block.  Measured on the skewed operator (NVIDIA H100 80GB
//   HBM3, 700 W, tags 1/2/3): 0.23/0.26/0.28 ms, 2.1-2.5x cuSPARSE; the
//   hubs alone 0.19-0.23 ms.  At tags 2-3 the producers' registers leave
//   two blocks an SM, which doubles the warp rows' time beside them.  The
//   first design gave a hub row (262,144 slots) one warp, 8192 dependent
//   load rounds: 1.78/3.50/3.99 ms, 16-37x cuSPARSE.
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
// * C'32 (`gse_spmm_sell_f32`, ops.gse_spmm_sell): B32's two bodies for a
//   pass of kColsWarp columns, each slot decoded once for every column; X
//   is (n, nrhs) row-major, as the caller holds it, so a slot's columns
//   share one 32-byte sector (one 16-byte load when nrhs % 4 == 0); Y is
//   (m, nrhs).  The rows from the pack's `long_from` on get a block each,
//   launched first (block_lanes_cols_f32): the producers stage each slot's
//   four products side by side a chunk of 1024 slots ahead, and lane l of
//   warp 0 adds slots l, l+32, ... of each column, four independent
//   chains, from one 16-byte shared load a slot.  The other rows get a
//   warp each (warp_row_cols_f32).  Every column keeps A32's lane order,
//   so per column bitwise C32, at nrhs = 1 bitwise B32.  The earlier design
//   (every row on a warp, X as (nrhs, n), a slot's columns in four
//   sectors) took 13.34/7.29/7.77 ms on the skewed operator at nrhs 4
//   (NVIDIA H100 80GB HBM3, 700 W), 5-10x cuSPARSE.
// * C'64 (`gse_spmm_sell_f64`, spmm_gse over a GSESellC, the batched CG
//   operator): B64's bodies for every column, with C64's per-column device
//   tags and active flags, the segments of the highest active tag loaded
//   once per pass of four columns (the service's slot width); column j
//   bitwise B64 at tags[j], and so C64; Y is (nrhs, m), inactive columns
//   0.0.  The long rows (from the pack's `long_from`, as B64) get a block
//   each, launched first (block_chain_cols_f64): its producer warps decode
//   each slot once per tag an active column runs and stage the four
//   columns' products in shared memory a chunk ahead; lanes 0-3 of warp 0
//   each add one column in lockstep, so four columns cost one column's
//   chain.  The other rows get a warp each, eight to a block
//   (warp_walk_f64: B64's warp row, a shuffle per column and slot): the
//   long rows' block shape, since one launch runs both and keeps the
//   hubs' chains running beside the warp rows.  Alone, these rows run
//   slightly faster in 2-warp blocks, but a second launch for them costs
//   more than that (PERF.md).
//
// What bounds it: HBM bytes.  The byte bound of one call is
// sell.bytes_touched(tag) (every padded slot's segments and colidx, perm,
// the exponent table) plus the x and y vectors: (m + n) * 4 (B32) or * 8
// (B64), nrhs * (m + n) * 4 | 8 for C'.  The f64 builds read only real
// slots, so they stream less than that model charges.
//
// A dense row (the skewed operators' hubs, 262,144 entries) is one serial
// chain of dependent adds in the f64 builds: bitwise parity with the CSR
// reference requires it, and no row's sum is split, so its bound is the
// chain, one __dadd_rn latency per slot, not the bytes.  A warp row keeps
// the chain but is bound by its shuffles on the chain's path (about 15 ns
// a slot for one column, 32-71 ns for C'64's four; NVIDIA H100 80GB HBM3,
// 700 W); the block chains leave the add as the chain's only step.
//
// Per-group precision (a TagMap, ops.masked_for_tagmap and
// ops.sell_bucket_tags): the reference runs A's (C's) Pallas call once per
// bucket at the bucket's tag (`_sell_mixed_cached`, src/repro/kernels/
// ops.py:306).  Here the mixed builds of B32 and C'32 (a negative tag,
// -(largest bucket tag), when the buckets' tags differ) cover every bucket
// in one launch: each bucket row reads its bucket's tag from a small
// device vector and runs that tag's body with that tag's scales, so a
// tag-1 bucket reads no tail and the launch streams sell.bytes_touched(tm).  A build holds the bodies of the
// tags up to its largest only.  Bucket for bucket it is bitwise the
// uniform launch at the bucket's tag over the same masked pack.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_rows.cuh"

namespace {

using gse::kChainThreads;
using gse::kColsWarp;

// First flat slot, width and bucket of bucket row r.  `tab` holds one row
// [first row, width, flat offset] per bucket, first rows ascending.
__device__ __forceinline__ int64_t locate(const int64_t* __restrict__ tab,
                                          int nb, int64_t r, int& width,
                                          int& bucket) {
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
  bucket = lo;
  return __ldg(tab + 3 * lo + 2) + (r - __ldg(tab + 3 * lo)) * w;
}

__device__ __forceinline__ int64_t locate(const int64_t* __restrict__ tab,
                                          int nb, int64_t r, int& width) {
  int bucket;
  return locate(tab, nb, r, width, bucket);
}

// The tag bucket `b` runs at: TAG (1-3), or, in a mixed build (TAG = -2
// or -3, the largest bucket tag negated), the bucket's entry of the device
// vector `btags` (ops.sell_bucket_tags; the host checks that its largest
// is -TAG, and runs buckets all at one tag as the uniform build).  A warp row and a long
// row's block lie within one bucket, so the branch on it is uniform across
// the warp (the block).  A mixed build holds only the bodies of the tags
// up to its largest, so its registers are those of that tag's body, as in
// the uniform build.  In a mixed build `scales` holds the three tags'
// tables of `k` entries, a row each.
template <int TAG>
__device__ __forceinline__ int bucket_tag(const int32_t* __restrict__ btags,
                                          int b) {
  return TAG > 0 ? TAG : __ldg(btags + b);
}

template <int TAG>
__device__ __forceinline__ const float* tag_scales(
    const float* __restrict__ scales, int k, int t) {
  return TAG > 0 ? scales : scales + (int64_t)(t - 1) * k;
}

// Which body runs tag t in build TAG: 1, 2 or 3 (3 only in builds that
// reach it).
template <int TAG>
__device__ __forceinline__ int body_of(int t) {
  if (TAG == 1 || (TAG < 0 && t == 1)) return 1;
  if (TAG == 2 || TAG == -2 || (TAG == -3 && t == 2)) return 2;
  return 3;
}

// Blocks [0, rows_pad - long_from) take bucket rows long_from, ... one
// each (block_lanes_f32); the blocks after them take rows [0, long_from),
// one per warp (warp_row_f32).  A negative TAG is a mixed build: each row
// runs the body of its bucket's tag (bucket_tag).
template <int TAG>
__global__ void __launch_bounds__(kChainThreads) spmv_sell_f32_kernel(
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ x, const float* __restrict__ scales,
    float* __restrict__ y, const int64_t* __restrict__ tab, int nb,
    const int32_t* __restrict__ perm, int64_t rows_pad, int64_t long_from,
    int shift, uint32_t mask, const int32_t* __restrict__ btags, int k) {
  __shared__ __align__(16) float buf[2 * gse::kLanesChunk];
  const int64_t n_long = rows_pad - long_from;
  if ((int64_t)blockIdx.x < n_long) {
    const int64_t row = long_from + blockIdx.x;
    const int dst = __ldg(perm + row);
    if (dst < 0) return;  // uniform across the block
    int width, b;
    const int64_t base = locate(tab, nb, row, width, b);
    const int t = bucket_tag<TAG>(btags, b);
    const float* sc = tag_scales<TAG>(scales, k, t);
    float acc;
    if (body_of<TAG>(t) == 1) {
      acc = gse::block_lanes_f32<1>(buf, base, width, colpak, head, tail1,
                                    tail2, x, sc, shift, mask);
    } else if (body_of<TAG>(t) == 2) {
      acc = gse::block_lanes_f32<2>(buf, base, width, colpak, head, tail1,
                                    tail2, x, sc, shift, mask);
    } else {
      acc = gse::block_lanes_f32<3>(buf, base, width, colpak, head, tail1,
                                    tail2, x, sc, shift, mask);
    }
    if (threadIdx.x == 0) y[dst] = acc;
    return;
  }
  const int64_t row = ((int64_t)blockIdx.x - n_long) * (kChainThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= long_from) return;  // uniform across the warp
  const int dst = __ldg(perm + row);
  if (dst < 0) return;  // slice padding row, uniform across the warp
  int width, b;
  const int64_t base = locate(tab, nb, row, width, b);
  const int t = bucket_tag<TAG>(btags, b);
  const float* sc = tag_scales<TAG>(scales, k, t);
  float acc;
  if (body_of<TAG>(t) == 1) {
    acc = gse::warp_row_f32<1>(base, width, lane, colpak, head, tail1, tail2,
                               x, sc, shift, mask);
  } else if (body_of<TAG>(t) == 2) {
    acc = gse::warp_row_f32<2>(base, width, lane, colpak, head, tail1, tail2,
                               x, sc, shift, mask);
  } else {
    acc = gse::warp_row_f32<3>(base, width, lane, colpak, head, tail1, tail2,
                               x, sc, shift, mask);
  }
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

// Blocks [0, rows_pad - long_from) take bucket rows long_from, ... one
// each (block_lanes_cols_f32); the blocks after them take rows
// [0, long_from), one per warp (warp_row_cols_f32).  grid.y walks the
// passes of kColsWarp columns of the (n, nrhs) row-major X.  A negative
// TAG is a mixed build, as in spmv_sell_f32_kernel.
template <int TAG>
__global__ void __launch_bounds__(kChainThreads) spmm_sell_f32_kernel(
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ x, const float* __restrict__ scales,
    float* __restrict__ y, const int64_t* __restrict__ tab, int nb,
    const int32_t* __restrict__ perm, int64_t rows_pad, int64_t long_from,
    int nrhs, int vec, int shift, uint32_t mask,
    const int32_t* __restrict__ btags, int k) {
  __shared__ __align__(16) float buf[2 * gse::kLanesColsFloats];
  const int c0 = blockIdx.y * kColsWarp;
  const int nc = nrhs - c0 < kColsWarp ? nrhs - c0 : kColsWarp;
  const float* xg = x + c0;
  float acc[kColsWarp];
  const int64_t n_long = rows_pad - long_from;
  if ((int64_t)blockIdx.x < n_long) {
    const int64_t row = long_from + blockIdx.x;
    const int dst = __ldg(perm + row);
    if (dst < 0) return;  // uniform across the block
    int width, b;
    const int64_t base = locate(tab, nb, row, width, b);
    const int t = bucket_tag<TAG>(btags, b);
    const float* sc = tag_scales<TAG>(scales, k, t);
    if (body_of<TAG>(t) == 1) {
      gse::block_lanes_cols_f32<1, kColsWarp>(
          buf, base, width, colpak, head, tail1, tail2, xg, nrhs, nc,
          vec != 0, sc, shift, mask, acc);
    } else if (body_of<TAG>(t) == 2) {
      gse::block_lanes_cols_f32<2, kColsWarp>(
          buf, base, width, colpak, head, tail1, tail2, xg, nrhs, nc,
          vec != 0, sc, shift, mask, acc);
    } else {
      gse::block_lanes_cols_f32<3, kColsWarp>(
          buf, base, width, colpak, head, tail1, tail2, xg, nrhs, nc,
          vec != 0, sc, shift, mask, acc);
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int c = 0; c < kColsWarp; ++c) {
        if (c < nc) y[(int64_t)dst * nrhs + c0 + c] = acc[c];
      }
    }
    return;
  }
  const int64_t row = ((int64_t)blockIdx.x - n_long) * (kChainThreads / 32) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= long_from) return;  // uniform across the warp
  const int dst = __ldg(perm + row);
  if (dst < 0) return;
  int width, b;
  const int64_t base = locate(tab, nb, row, width, b);
  const int t = bucket_tag<TAG>(btags, b);
  const float* sc = tag_scales<TAG>(scales, k, t);
  if (body_of<TAG>(t) == 1) {
    gse::warp_row_cols_f32<1, kColsWarp>(base, width, lane, colpak, head,
                                         tail1, tail2, xg, nrhs, nc,
                                         vec != 0, sc, shift, mask, acc);
  } else if (body_of<TAG>(t) == 2) {
    gse::warp_row_cols_f32<2, kColsWarp>(base, width, lane, colpak, head,
                                         tail1, tail2, xg, nrhs, nc,
                                         vec != 0, sc, shift, mask, acc);
  } else {
    gse::warp_row_cols_f32<3, kColsWarp>(base, width, lane, colpak, head,
                                         tail1, tail2, xg, nrhs, nc,
                                         vec != 0, sc, shift, mask, acc);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsWarp; ++c) {
      if (c < nc) y[(int64_t)dst * nrhs + c0 + c] = acc[c];
    }
  }
}

// Blocks [0, rows_pad - long_from) take bucket rows long_from, ... one
// each (block_chain_cols_f64); the blocks after them take rows
// [0, long_from), one per warp (warp_walk_f64).  grid.y walks the passes
// of kColsWarp columns.
__global__ void __launch_bounds__(kChainThreads) spmm_sell_f64_kernel(
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ active,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    double* __restrict__ y, const int64_t* __restrict__ tab, int nb,
    const int32_t* __restrict__ perm, const int32_t* __restrict__ row_len,
    int64_t rows_pad, int64_t long_from, int64_t m, int64_t n, int nrhs,
    int shift, uint32_t mask) {
  __shared__ __align__(16) double buf[2 * kColsWarp * gse::kColsStride];
  const int c0 = blockIdx.y * kColsWarp;
  const int nc = nrhs - c0 < kColsWarp ? nrhs - c0 : kColsWarp;
  int tg[kColsWarp];
  unsigned need;
  // maxtag is uniform across the grid: no divergence.
  const int maxtag = gse::column_tags(tags, active, c0, nc, tg, need);
  const double* xg = x + (int64_t)c0 * n;
  const int64_t n_long = rows_pad - long_from;
  if ((int64_t)blockIdx.x < n_long) {
    const int64_t row = long_from + blockIdx.x;
    const int dst = __ldg(perm + row);
    if (dst < 0) return;  // uniform across the block
    int width;
    const int64_t base = locate(tab, nb, row, width);
    const double acc = gse::block_chain_cols_f64_at<false>(
        maxtag, buf, base, __ldg(row_len + row), colpak, head, tail1, tail2,
        table, xg, n, shift, mask, tg, need);
    if ((int)threadIdx.x < nc) y[(int64_t)(c0 + threadIdx.x) * m + dst] = acc;
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
  double acc[kColsWarp];
  gse::warp_walk_f64_at<false>(maxtag, base, __ldg(row_len + row), lane,
                               colpak, head, tail1, tail2, table, xg, n, shift,
                               mask, tg, need, acc);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kColsWarp; ++c) {
      if (c < nc) y[(int64_t)(c0 + c) * m + dst] = acc[c];
    }
  }
}

}  // namespace

// y (m,) f32 = A x over the SELL buckets at `tag`; x is (n,) f32.  Bucket
// rows [long_from, rows_pad) run a block each.  A negative tag is the mixed
// launch, -(largest bucket tag), -2 or -3: bucket b runs at btags[b]
// (device int32), with `scales` the (3, k) tables of tags 1-3.
extern "C" int gse_spmv_sell_f32(int tag, const void* colpak, const void* head,
                                 const void* tail1, const void* tail2,
                                 const void* x, const void* scales, void* y,
                                 const void* tab, int nb, const void* perm,
                                 long long rows_pad, long long long_from,
                                 int ei_bit, const void* btags, int k,
                                 void* stream) {
  if (long_from < 0 || long_from > rows_pad ||
      (tag < 0 && (btags == nullptr || k <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long warps = kChainThreads / 32;
  const long long blocks = (rows_pad - long_from) +
                           (long_from + warps - 1) / warps;
  if (blocks <= 0) return (int)cudaGetLastError();
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
  const int32_t* bt = (const int32_t*)btags;
  if (tag == -2) {
    spmv_sell_f32_kernel<-2><<<(unsigned)blocks, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, shift,
        mask, bt, k);
  } else if (tag == -3) {
    spmv_sell_f32_kernel<-3><<<(unsigned)blocks, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, shift,
        mask, bt, k);
  } else if (tag == 1) {
    spmv_sell_f32_kernel<1><<<(unsigned)blocks, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, shift,
        mask, bt, k);
  } else if (tag == 2) {
    spmv_sell_f32_kernel<2><<<(unsigned)blocks, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, shift,
        mask, bt, k);
  } else if (tag == 3) {
    spmv_sell_f32_kernel<3><<<(unsigned)blocks, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, shift,
        mask, bt, k);
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

// Y (m, nrhs) f32 = A X over the SELL buckets at `tag`; X is (n, nrhs) f32,
// row-major.  Bucket rows [long_from, rows_pad) run a block each.  A
// negative tag is the mixed launch, as in gse_spmv_sell_f32.
extern "C" int gse_spmm_sell_f32(int tag, const void* colpak, const void* head,
                                 const void* tail1, const void* tail2,
                                 const void* x, const void* scales, void* y,
                                 const void* tab, int nb, const void* perm,
                                 long long rows_pad, long long long_from,
                                 int nrhs, int ei_bit, const void* btags,
                                 int k, void* stream) {
  if (long_from < 0 || long_from > rows_pad || nrhs <= 0 ||
      (tag < 0 && (btags == nullptr || k <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long warps = kChainThreads / 32;
  const dim3 grid(
      (unsigned)((rows_pad - long_from) + (long_from + warps - 1) / warps),
      (unsigned)((nrhs + kColsWarp - 1) / kColsWarp));
  if (grid.x == 0) return (int)cudaGetLastError();
  // Four columns of a slot in one 16-byte load: every pass full, every row
  // of X 16-byte aligned.
  const int vec = nrhs % kColsWarp == 0 && (uintptr_t)x % 16 == 0;
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
  const int32_t* bt = (const int32_t*)btags;
  if (tag == -2) {
    spmm_sell_f32_kernel<-2><<<grid, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, nrhs,
        vec, shift, mask, bt, k);
  } else if (tag == -3) {
    spmm_sell_f32_kernel<-3><<<grid, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, nrhs,
        vec, shift, mask, bt, k);
  } else if (tag == 1) {
    spmm_sell_f32_kernel<1><<<grid, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, nrhs,
        vec, shift, mask, bt, k);
  } else if (tag == 2) {
    spmm_sell_f32_kernel<2><<<grid, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, nrhs,
        vec, shift, mask, bt, k);
  } else if (tag == 3) {
    spmm_sell_f32_kernel<3><<<grid, kChainThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, tb, nb, pm, rows_pad, long_from, nrhs,
        vec, shift, mask, bt, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Y (nrhs, m) f64 = A X over the SELL buckets, column j at tags[j] when
// active[j]; X is (nrhs, n) f64.  Bucket rows [long_from, rows_pad) run a
// block each.
extern "C" int gse_spmm_sell_f64(const void* tags, const void* active,
                                 const void* colpak, const void* head,
                                 const void* tail1, const void* tail2,
                                 const void* table, const void* x, void* y,
                                 const void* tab, int nb, const void* perm,
                                 const void* row_len, long long rows_pad,
                                 long long long_from, long long m,
                                 long long n, int nrhs, int ei_bit,
                                 void* stream) {
  if (long_from < 0 || long_from > rows_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long warps = kChainThreads / 32;
  const dim3 grid(
      (unsigned)((rows_pad - long_from) + (long_from + warps - 1) / warps),
      (unsigned)((nrhs + kColsWarp - 1) / kColsWarp));
  if (grid.x > 0 && grid.y > 0) {
    spmm_sell_f64_kernel<<<grid, kChainThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tags, (const uint8_t*)active, (const uint32_t*)colpak,
        (const uint16_t*)head, (const uint16_t*)tail1, (const uint32_t*)tail2,
        (const int32_t*)table, (const double*)x, (double*)y,
        (const int64_t*)tab, nb, (const int32_t*)perm,
        (const int32_t*)row_len, rows_pad, long_from, m, n, nrhs, shift,
        mask);
  }
  return (int)cudaGetLastError();
}
