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
// The simple one-warp-per-row (C32) and one-thread-per-row (C64) orders are
// kept for parity with A; A64's uncoalesced row walk is already 6.3-14.5x
// its byte bound, and a faster order that keeps the bits is later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_decode.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;  // right-hand-side columns per pass (registers)

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
  const float* __restrict__ xg = x + (int64_t)c0 * n;
  const int64_t base = row * (int64_t)width;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
  for (int j = lane; j < width; j += 32) {
    const int64_t k = base + j;
    const uint32_t cp = __ldg(colpak + k);
    const float val = gse::decode_f32<TAG>(
        __ldg(head + k), TAG >= 2 ? __ldg(tail1 + k) : 0u,
        TAG == 3 ? __ldg(tail2 + k) : 0u, __ldg(scales + (cp >> shift)));
    const int64_t col = cp & mask;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) acc[c] = __fadd_rn(acc[c], __fmul_rn(val, __ldg(xg + c * n + col)));
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    for (int off = 16; off > 0; off >>= 1) {
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c < nc) y[row * nrhs + c0 + c] = acc[c];
    }
  }
}

// One row's CSR walk for the columns of this pass.  tg[c] is column c's
// tag (0: inactive); `need` has bit t set when some active column runs tag
// t.  MAXTAG, the highest of them, fixes which segments are loaded.
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
    const double v1 = (need & 2u) ? gse::decode_f64<1>(h, t1, t2, e_sh) : 0.0;
    const double v2 =
        (MAXTAG >= 2 && (need & 4u)) ? gse::decode_f64<2>(h, t1, t2, e_sh) : 0.0;
    const double v3 =
        (MAXTAG == 3 && (need & 8u)) ? gse::decode_f64<3>(h, t1, t2, e_sh) : 0.0;
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
  unsigned need = 0u;
  int maxtag = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    tg[c] = 0;
    if (c < nc && __ldg(active + c0 + c)) {
      int t = __ldg(tags + c0 + c);
      t = t < 1 ? 1 : (t > 3 ? 3 : t);  // the reference clips tag - 1 to [0, 2]
      tg[c] = t;
      need |= 1u << t;
      maxtag = t > maxtag ? t : maxtag;
    }
  }
  double acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.0;
  const int64_t b = __ldg(rowptr + row);
  const int64_t e = __ldg(rowptr + row + 1);
  const double* __restrict__ xg = x + (int64_t)c0 * n;
  // maxtag is uniform across the grid: no divergence.
  if (maxtag == 1) {
    row_walk_f64<1>(b, e, colpak, head, tail1, tail2, table, xg, n, shift,
                    mask, tg, need, acc);
  } else if (maxtag == 2) {
    row_walk_f64<2>(b, e, colpak, head, tail1, tail2, table, xg, n, shift,
                    mask, tg, need, acc);
  } else if (maxtag == 3) {
    row_walk_f64<3>(b, e, colpak, head, tail1, tail2, table, xg, n, shift,
                    mask, tg, need, acc);
  }
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
