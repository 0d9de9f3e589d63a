// Kernel C on Hopper: tag-specialized GSE-SEM SpMM, Y = A X, two builds.
//
// Replaces the Pallas kernel `gse_spmm_call` (src/repro/kernels/gse_spmm.py,
// bodies `_spmm_body_tag1/2/3` and `_accumulate`, `pallas_call` :137).  As
// there, each stored entry is decoded once and the decoded value serves
// every right-hand-side column; the decode is `gse_decode.cuh`, shared with
// the SpMV (kernel A) so the two cannot drift.  A pass over the matrix
// serves kColsWarp (4) columns; wider batches take one more pass per group
// (grid.y).
//
// What bounds it: HBM bytes.  An SpMM at nrhs columns does 2 * nrhs flops
// per nonzero against 6/8/12 matrix bytes (tags 1/2/3) plus each column's
// x gather and y write, far below the card's operations-per-byte balance at
// the batch widths of the solve service (4).  The bound is
// bytes_touched(tag) + nrhs * (m + n) * 4 (C32) or * 8 (C64): the matrix is
// streamed once however many columns ride along, the byte model
// `iteration_stream_bytes(nrhs=)` made literal.
//
// * C32 (`gse_spmm_ell_f32`): f32 over the uniform ELL arrays of
//   `ell_pack_gsecsr`, the function the Pallas kernel computes.  A32's
//   walk for the columns of a pass (group_row_f32): each row on a
//   group of `lanes` lanes over its `row_len` real slots, each slot decoded
//   once for every column, each column on its own lane chains and tree,
//   so column j is bitwise A32 on column j.  X is (n, nrhs) row-major, as
//   the caller holds it, so a slot's four x values share one 32-byte
//   sector and arrive in one 16-byte load (C'32's x_row_f32); Y is (m,
//   nrhs).  The first design walked all 128 slots of a row on a warp and
//   read X as (nrhs, n), four sectors a slot: 0.88/0.97/1.08 ms at nrhs 4
//   on the uniform operator, 20-14x its byte bound and up to 1.065x
//   cuSPARSE (NVIDIA H100 80GB HBM3, 700 W).
//
// * C64 (`gse_spmm_csr_f64`): f64 over the CSR rows, the operator of the
//   batched stepped CG loop.  Each column j carries its own tag (device
//   int32 tags[j], clipped to [1, 3]) and an active flag (device uint8
//   active[j]); both are read on the device, so the loop never syncs to
//   choose a build.  A pass of kColsWarp (4, the service's slot width)
//   columns loads only the segments its highest active tag reads and
//   decodes each entry once per tag that some active column runs; every
//   row's products are added in CSR order from 0.0 with
//   __dmul_rn/__dadd_rn, so column j of Y is bitwise A64 at tags[j] on
//   column j of X.  Inactive columns read nothing and get 0.0.  Y is
//   (nrhs, m).  Which threads load and add a row follows A64's row plan
//   (GSECSR.row_plan, sparse/csr.py), one launch for the three bodies of
//   gse_rows.cuh, grid.y walking the passes:
//   - long rows a block each, launched first (block_chain_cols_f64,
//     C'64's long-row body): producer warps stage the four columns'
//     products a chunk ahead; lanes 0-3 of warp 0 add a column each in
//     lockstep;
//   - rows in between a warp each, eight to a block (warp_walk_f64,
//     C'64's other rows);
//   - short rows in row blocks of consecutive rows (row_block_cols_f64):
//     the block's threads stage the run's products for the four columns
//     with coalesced loads, then thread i adds row i's for each column.
//   Shared memory: the run's 2048 slots times four columns would take 64
//   KB, past the 48 KB of static shared memory, and as dynamic memory
//   would leave three blocks on an SM where six fit now; so a row block
//   stages its run in two chunks of 1024 slots (32 KB) in the block
//   chain's buffers, each thread's four chains carried from the first
//   chunk into the second, in the same order.
//   The x gathers: a slot's four x values, one in each column of an
//   (nrhs, n) X, are four 32-byte sectors, and on the uniform operator
//   (random columns over 2^20) those sectors are the kernel's traffic.
//   So the entry point first copies X interleaved (interleave_cols_kernel:
//   a pass's four values of a matrix column side by side, inactive
//   columns 0.0), and every body gathers a slot's four values as one
//   sector (x_values in gse_rows.cuh).  The copy reads and writes X once.
//   The kernel keeps three blocks an SM (80 registers): the row blocks
//   gain more from the blocks in flight than the long rows lose.
//   Measured (NVIDIA H100 80GB HBM3, 700 W, nrhs 4, tags 1/2/3): 0.36/
//   0.39/0.40 ms on the uniform operator, 4.8-6.8x its byte bound and
//   3.4-3.8x under cuSPARSE; 1.25-1.28 ms on the skewed CSR, where the
//   hubs' chains (bound 1.07 ms) set the time.  The first design gave
//   each row one thread (a warp's loads touched 32 rows some 17 slots
//   apart, and a dense row waited on a load at every step): 0.98/1.20/
//   1.65 ms on the uniform operator, 18.5-19.4x its byte bound.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = gse::kChainThreads / 32;  // C64's warp rows a block
using gse::kColsWarp;

// C32: rows on groups of G lanes (group_row_f32), 256 / G rows a
// block; grid.y walks the passes of kColsWarp columns of the (n, nrhs)
// row-major X.
template <int TAG, int G>
__global__ void __launch_bounds__(kThreads) spmm_ell_f32_kernel(
    const gse::EllF32 a, int nrhs, int vec) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int g = threadIdx.x & (G - 1);
  const int len = gse::ell_row_len(a, row);
  const int c0 = blockIdx.y * kColsWarp;
  const int nc = nrhs - c0 < kColsWarp ? nrhs - c0 : kColsWarp;
  const float* xg = a.x + c0;
  float pad[kColsWarp], acc[kColsWarp];
  gse::pad_products_f32<TAG, kColsWarp>(xg, nrhs, nc, vec != 0, a.scales,
                                        len < a.width, pad);
  gse::group_row_f32<TAG, G, kColsWarp>(
      row * (int64_t)a.width, len, g, pad, a.colpak, a.head, a.tail1,
      a.tail2, xg, nrhs, nc, vec != 0, a.scales, a.shift, a.mask, acc);
  if (g == 0 && row < a.rows) {
    float* dst = a.y + row * nrhs + c0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int c = 0; c < kColsWarp; ++c) {
        if (c < nc) dst[c] = acc[c];
      }
    }
  }
}

template <int G>
int spmm_ell_f32_on(int tag, const gse::EllF32& a, int nrhs, int vec,
                    cudaStream_t s) {
  const long long blocks = (a.rows * G + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks,
                  (unsigned)((nrhs + kColsWarp - 1) / kColsWarp));
  if (tag == 1) {
    spmm_ell_f32_kernel<1, G><<<grid, kThreads, 0, s>>>(a, nrhs, vec);
  } else if (tag == 2) {
    spmm_ell_f32_kernel<2, G><<<grid, kThreads, 0, s>>>(a, nrhs, vec);
  } else if (tag == 3) {
    spmm_ell_f32_kernel<3, G><<<grid, kThreads, 0, s>>>(a, nrhs, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// X (nrhs, n) into C64's interleaved copy xi: pass p's kColsWarp values of
// matrix column `col` side by side at xi[(p * n + col) * kColsWarp], 0.0
// for inactive columns and for those past nrhs (x_values in gse_rows.cuh).
__global__ void __launch_bounds__(kThreads) interleave_cols_kernel(
    const uint8_t* __restrict__ active, const double* __restrict__ x,
    double* __restrict__ xi, int64_t n, int nrhs, int64_t cells) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;  // cells = passes * n
  const int p = (int)(i / n);
  const int64_t col = i - (int64_t)p * n;
  double v[kColsWarp];
#pragma unroll
  for (int c = 0; c < kColsWarp; ++c) {
    const int j = p * kColsWarp + c;
    v[c] = (j < nrhs && __ldg(active + j)) ? __ldg(x + (int64_t)j * n + col)
                                           : 0.0;
  }
  double2* out = reinterpret_cast<double2*>(xi + i * kColsWarp);
#pragma unroll
  for (int h = 0; h < kColsWarp / 2; ++h) {
    out[h] = make_double2(v[2 * h], v[2 * h + 1]);
  }
}

// Blocks [0, n_long) take the long rows, one each (block_chain_cols_f64);
// the next ceil(n_warp / 8) take the warp rows, eight to a block
// (warp_walk_f64); the rest take the row blocks [first row, end row)
// (row_block_cols_f64).  grid.y walks the passes of kColsWarp columns;
// xi is the interleaved copy of X.  At least three blocks an SM (see the
// top of the file).
__global__ void __launch_bounds__(gse::kChainThreads, 3) spmm_csr_f64_kernel(
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ rowptr, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ xi, double* __restrict__ y,
    const int32_t* __restrict__ long_rows, int64_t n_long,
    const int32_t* __restrict__ warp_rows, int64_t n_warp,
    const int32_t* __restrict__ row_blocks, int64_t m, int64_t n, int nrhs,
    int shift, uint32_t mask) {
  __shared__ __align__(16) double buf[2 * kColsWarp * gse::kColsStride];
  const int c0 = blockIdx.y * kColsWarp;
  const int nc = nrhs - c0 < kColsWarp ? nrhs - c0 : kColsWarp;
  int tg[kColsWarp];
  unsigned need;
  // maxtag is uniform across the grid: no divergence.
  const int maxtag = gse::column_tags(tags, active, c0, nc, tg, need);
  const double* xg = xi + (int64_t)blockIdx.y * n * kColsWarp;
  double* yg = y + (int64_t)c0 * m;
  int64_t b = blockIdx.x;
  if (b < n_long) {
    const int row = __ldg(long_rows + b);
    const int base = __ldg(rowptr + row);
    const double acc = gse::block_chain_cols_f64_at<true>(
        maxtag, buf, base, __ldg(rowptr + row + 1) - base, colpak, head,
        tail1, tail2, table, xg, n, shift, mask, tg, need);
    if ((int)threadIdx.x < nc) yg[(int64_t)threadIdx.x * m + row] = acc;
    return;
  }
  b -= n_long;
  const int64_t warp_blocks = (n_warp + kWarps - 1) / kWarps;
  if (b < warp_blocks) {
    const int64_t w = b * kWarps + (threadIdx.x >> 5);
    if (w >= n_warp) return;  // uniform across the warp
    const int row = __ldg(warp_rows + w);
    const int base = __ldg(rowptr + row);
    double acc[kColsWarp];
    gse::warp_walk_f64_at<true>(maxtag, base, __ldg(rowptr + row + 1) - base,
                                threadIdx.x & 31, colpak, head, tail1, tail2,
                                table, xg, n, shift, mask, tg, need, acc);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int c = 0; c < kColsWarp; ++c) {
        if (c < nc) yg[(int64_t)c * m + row] = acc[c];
      }
    }
    return;
  }
  b -= warp_blocks;
  gse::row_block_cols_f64_at<true>(
      maxtag, buf, rowptr, __ldg(row_blocks + 2 * b),
      __ldg(row_blocks + 2 * b + 1), colpak, head, tail1, tail2, table, xg, n,
      shift, mask, tg, need, yg, m, nc);
}

}  // namespace

// Y (m, nrhs) f32 = A X over the (rows, width) ELL segments at `tag`, each
// row over its row_len[row] real slots, on groups of `lanes` lanes; X is
// (n, nrhs) f32, row-major.
extern "C" int gse_spmm_ell_f32(int tag, int lanes, const void* colpak,
                                const void* head, const void* tail1,
                                const void* tail2, const void* x,
                                const void* scales, const void* row_len,
                                void* y, long long rows, int width, int nrhs,
                                int ei_bit, void* stream) {
  if (nrhs <= 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaGetLastError();
  const int shift = 32 - ei_bit;
  const gse::EllF32 a{(const uint32_t*)colpak, (const uint16_t*)head,
                      (const uint16_t*)tail1, (const uint32_t*)tail2,
                      (const float*)x, (const float*)scales,
                      (const int32_t*)row_len, (float*)y, rows, width, shift,
                      (1u << shift) - 1u};
  // Four columns of a slot in one 16-byte load: every pass full, every row
  // of X 16-byte aligned.
  const int vec = nrhs % kColsWarp == 0 && (uintptr_t)x % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 4: return spmm_ell_f32_on<4>(tag, a, nrhs, vec, s);
    case 8: return spmm_ell_f32_on<8>(tag, a, nrhs, vec, s);
    case 16: return spmm_ell_f32_on<16>(tag, a, nrhs, vec, s);
    case 32: return spmm_ell_f32_on<32>(tag, a, nrhs, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Y (nrhs, m) = A X over CSR segments, column j at tags[j] when active[j];
// X is (nrhs, n) f64.  The row plan: `long_rows` (n_long row ids),
// `warp_rows` (n_warp row ids) and `row_blocks` (n_blocks [first row, end
// row) pairs) cover every row once.  `xi` is scratch of
// ceil(nrhs / kColsWarp) * n * kColsWarp doubles, 16-byte aligned, for X
// interleaved: two launches, the copy and the product.
extern "C" int gse_spmm_csr_f64(const void* tags, const void* active,
                                const void* rowptr, const void* colpak,
                                const void* head, const void* tail1,
                                const void* tail2, const void* table,
                                const void* x, void* y, void* xi,
                                const void* long_rows,
                                long long n_long, const void* warp_rows,
                                long long n_warp, const void* row_blocks,
                                long long n_blocks, long long rows,
                                long long n, int nrhs, int ei_bit,
                                void* stream) {
  if (n_long < 0 || n_warp < 0 || n_blocks < 0 || nrhs < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long blocks = n_long + (n_warp + kWarps - 1) / kWarps + n_blocks;
  const long long passes = (nrhs + kColsWarp - 1) / kColsWarp;
  const long long copy_blocks = (passes * n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL || copy_blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)blocks, (unsigned)passes);
  cudaStream_t s = (cudaStream_t)stream;
  if (grid.x > 0 && grid.y > 0) {
    if (copy_blocks > 0) {
      interleave_cols_kernel<<<(unsigned)copy_blocks, kThreads, 0, s>>>(
          (const uint8_t*)active, (const double*)x, (double*)xi, n, nrhs,
          passes * n);
    }
    spmm_csr_f64_kernel<<<grid, gse::kChainThreads, 0, s>>>(
        (const int32_t*)tags, (const uint8_t*)active, (const int32_t*)rowptr,
        (const uint32_t*)colpak, (const uint16_t*)head,
        (const uint16_t*)tail1, (const uint32_t*)tail2, (const int32_t*)table,
        (const double*)xi, (double*)y, (const int32_t*)long_rows, n_long,
        (const int32_t*)warp_rows, n_warp, (const int32_t*)row_blocks, rows,
        n, nrhs, shift, mask);
  }
  return (int)cudaGetLastError();
}
