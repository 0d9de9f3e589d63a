// Kernel C on Hopper: tag-specialized GSE-SEM SpMM, Y = A X, two builds.
//
// Replaces the Pallas kernel `gse_spmm_call` (src/repro/kernels/gse_spmm.py,
// bodies `_spmm_body_tag1/2/3` and `_accumulate`, `pallas_call` :137).  As
// there, each stored entry is decoded once and the decoded value serves
// every right-hand-side column; the decode is `gse_decode.cuh`, shared with
// the SpMV (kernel A) so the two cannot drift.  X arrives as (nrhs, n), so
// each column's gather reads one contiguous vector, as the Pallas kernel's
// (nrhs, N) block does.  A block of kCols columns keeps its partial sums in
// registers; wider batches take one more pass over the matrix per group
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
//   `ell_pack_gsecsr`, the function the Pallas kernel computes.  One warp
//   per row as in A32; lane l adds slots l, l+32, ... from 0.0 for every
//   column, then A32's shuffle tree per column, so at nrhs = 1 the result
//   is bitwise A32's.  Y is (m, nrhs).
//
// * C64 (`gse_spmm_csr_f64`): f64 over the CSR rows, the operator of the
//   batched stepped CG loop.  One thread per row walks rowptr[i]..rowptr[i+1]
//   in CSR order from 0.0 with __dmul_rn/__dadd_rn, as A64 does.  Each
//   column j carries its own tag (device int32 tags[j], clipped to [1, 3])
//   and an active flag (device uint8 active[j]); both are read on the
//   device, so the loop never syncs to choose a build.  The kernel loads
//   only the segments the highest active tag reads and decodes each entry
//   once per tag that some active column runs, so column j of Y is bitwise
//   A64 at tags[j] on column j of X.  Inactive columns read nothing and get
//   0.0.  Y is (nrhs, m).
//
// C32 keeps A32's warp row.  C64 still walks a row on one thread
// (row_walk_f64), the design A64 had before its row plan: a warp's loads
// touch 32 rows some 17 slots apart, 18.5-19.4x its byte bound on the
// uniform operator (NVIDIA H100 80GB HBM3, 700 W).  A64's row bodies
// (gse_rows.cuh: row blocks, warp rows, block chains) keep the same sums
// and are C64's next design (ROADMAP R4).
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_rows.cuh"

namespace {

constexpr int kThreads = 256;
using gse::kCols;

template <int TAG>
__global__ void __launch_bounds__(kThreads) spmm_ell_f32_kernel(
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ x, const float* __restrict__ scales,
    float* __restrict__ y, int64_t rows, int width, int64_t n, int nrhs,
    int shift, uint32_t mask) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const int c0 = blockIdx.y * kCols;
  const int nc = nrhs - c0 < kCols ? nrhs - c0 : kCols;
  float acc[kCols];
  gse::warp_row_cols_f32<TAG>(row * (int64_t)width, width, lane, colpak, head,
                              tail1, tail2, x + (int64_t)c0 * n, n, nc,
                              scales, shift, mask, acc);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) y[row * nrhs + c0 + c] = acc[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads) spmm_csr_f64_kernel(
    const int32_t* __restrict__ tags, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ rowptr, const uint32_t* __restrict__ colpak,
    const uint16_t* __restrict__ head, const uint16_t* __restrict__ tail1,
    const uint32_t* __restrict__ tail2, const int32_t* __restrict__ table,
    const double* __restrict__ x, double* __restrict__ y, int64_t rows,
    int64_t n, int nrhs, int shift, uint32_t mask) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int c0 = blockIdx.y * kCols;
  const int nc = nrhs - c0 < kCols ? nrhs - c0 : kCols;
  int tg[kCols];
  unsigned need;
  // maxtag is uniform across the grid: no divergence.
  const int maxtag = gse::column_tags(tags, active, c0, nc, tg, need);
  double acc[kCols];
  gse::row_walk_f64_at(maxtag, __ldg(rowptr + row), __ldg(rowptr + row + 1),
                       colpak, head, tail1, tail2, table,
                       x + (int64_t)c0 * n, n, shift, mask, tg, need, acc);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c < nc) y[(int64_t)(c0 + c) * rows + row] = acc[c];
  }
}

}  // namespace

// Y (m, nrhs) = A X over ELL segments at `tag`; X is (nrhs, n) f32.
extern "C" int gse_spmm_ell_f32(int tag, const void* colpak, const void* head,
                                const void* tail1, const void* tail2,
                                const void* x, const void* scales, void* y,
                                long long rows, int width, long long n,
                                int nrhs, int ei_bit, void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const dim3 grid((unsigned)((rows * 32 + kThreads - 1) / kThreads),
                  (unsigned)((nrhs + kCols - 1) / kCols));
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* cp = (const uint32_t*)colpak;
  const uint16_t* hd = (const uint16_t*)head;
  const uint16_t* t1 = (const uint16_t*)tail1;
  const uint32_t* t2 = (const uint32_t*)tail2;
  const float* xs = (const float*)x;
  const float* sc = (const float*)scales;
  float* out = (float*)y;
  if (tag == 1) {
    spmm_ell_f32_kernel<1><<<grid, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, rows, width, n, nrhs, shift, mask);
  } else if (tag == 2) {
    spmm_ell_f32_kernel<2><<<grid, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, rows, width, n, nrhs, shift, mask);
  } else if (tag == 3) {
    spmm_ell_f32_kernel<3><<<grid, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, rows, width, n, nrhs, shift, mask);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Y (nrhs, m) = A X over CSR segments, column j at tags[j] when active[j];
// X is (nrhs, n) f64.
extern "C" int gse_spmm_csr_f64(const void* tags, const void* active,
                                const void* rowptr, const void* colpak,
                                const void* head, const void* tail1,
                                const void* tail2, const void* table,
                                const void* x, void* y, long long rows,
                                long long n, int nrhs, int ei_bit,
                                void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const dim3 grid((unsigned)((rows + kThreads - 1) / kThreads),
                  (unsigned)((nrhs + kCols - 1) / kCols));
  spmm_csr_f64_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tags, (const uint8_t*)active, (const int32_t*)rowptr,
      (const uint32_t*)colpak, (const uint16_t*)head, (const uint16_t*)tail1,
      (const uint32_t*)tail2, (const int32_t*)table, (const double*)x,
      (double*)y, rows, n, nrhs, shift, mask);
  return (int)cudaGetLastError();
}
