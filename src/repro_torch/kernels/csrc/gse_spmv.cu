// Kernel A on Hopper: tag-specialized GSE-SEM SpMV, two builds.
//
// Replaces the Pallas kernel `gse_spmv_call` (src/repro/kernels/gse_spmv.py,
// bodies `_spmv_body_tag1/2/3`, decode `decode_tile`).  Both builds decode
// the GSE-SEM segments in the kernel: expIdx = colpak >> (32 - ei_bit), the
// column is the low bits, sign = head bit 15, mantissa = head & 0x7FFF,
// spliced with tail1 (tag >= 2) and tail2 (tag 3), times 2^(E_sh - 15/31/63).
// Each tag variant is a template instance that loads only the segments its
// tag reads: 6/8/12 bytes per nonzero plus the x gather.
//
// What bounds it: HBM bytes.  An SpMV does 2 flops per nonzero against
// 6-12 matrix bytes plus the gathered x, far below the card's
// operations-per-byte balance, so the design goal is to touch each segment
// byte once and nothing more.
//
// * A32 (`gse_spmv_ell_f32`): f32 decode and sums over the uniform ELL
//   arrays of `ell_pack_gsecsr`, the same function as the Pallas kernel.
//   One warp per row, lanes striding along L, so each segment load is
//   coalesced; a warp shuffle replaces the 128 lane partials the TPU kernel
//   summed after its grid.  The decode keeps `decode_tile`'s operation
//   order with round-to-nearest intrinsics; the row sum may use any order.
//
// * A64 (`gse_spmv_csr_f64`): the f64 operator of the stepped CG loop, the
//   same function as `spmv_gse` (`_decode_gsecsr` plus `segment_sum`).  One
//   thread per row walks rowptr[i]..rowptr[i+1] in CSR order from 0.0 with
//   __dmul_rn/__dadd_rn (no FMA contraction), which keeps the result bitwise
//   equal to the reference's sequential row sum.  The tag is read from a
//   device int32 so the solver loop never syncs to pick a build; the branch
//   is uniform across the grid and the tag-1 branch never loads a tail.
//   Padded slots do not exist here, so a non-finite x spreads exactly as in
//   `spmv_gse`.  The per-row order costs coalescing; a row-parallel design
//   that keeps the parity is later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_rows.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) spmv_csr_f64_kernel(
    const int32_t* __restrict__ tag, const int32_t* __restrict__ rowptr,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    double* __restrict__ y, int64_t rows, int shift, uint32_t mask) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  y[row] = gse::row_sum_f64_at(tag, __ldg(rowptr + row),
                               __ldg(rowptr + row + 1), colpak, head, tail1,
                               tail2, table, x, shift, mask);
}

template <int TAG>
__global__ void __launch_bounds__(kThreads) spmv_ell_f32_kernel(
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const float* __restrict__ x, const float* __restrict__ scales,
    float* __restrict__ y, int64_t rows, int width, int shift, uint32_t mask) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const float acc = gse::warp_row_f32<TAG>(row * (int64_t)width, width, lane,
                                           colpak, head, tail1, tail2, x,
                                           scales, shift, mask);
  if (lane == 0) y[row] = acc;
}

}  // namespace

extern "C" int gse_spmv_csr_f64(const void* tag, const void* rowptr,
                                const void* colpak, const void* head,
                                const void* tail1, const void* tail2,
                                const void* table, const void* x, void* y,
                                long long rows, int ei_bit, void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long blocks = (rows + kThreads - 1) / kThreads;
  spmv_csr_f64_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tag, (const int32_t*)rowptr, (const uint32_t*)colpak,
      (const uint16_t*)head, (const uint16_t*)tail1, (const uint32_t*)tail2,
      (const int32_t*)table, (const double*)x, (double*)y, rows, shift, mask);
  return (int)cudaGetLastError();
}

extern "C" int gse_spmv_ell_f32(int tag, const void* colpak, const void* head,
                                const void* tail1, const void* tail2,
                                const void* x, const void* scales, void* y,
                                long long rows, int width, int ei_bit,
                                void* stream) {
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long blocks = (rows * 32 + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* cp = (const uint32_t*)colpak;
  const uint16_t* hd = (const uint16_t*)head;
  const uint16_t* t1 = (const uint16_t*)tail1;
  const uint32_t* t2 = (const uint32_t*)tail2;
  const float* xs = (const float*)x;
  const float* sc = (const float*)scales;
  float* out = (float*)y;
  if (tag == 1) {
    spmv_ell_f32_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, rows, width, shift, mask);
  } else if (tag == 2) {
    spmv_ell_f32_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, rows, width, shift, mask);
  } else if (tag == 3) {
    spmv_ell_f32_kernel<3><<<(unsigned)blocks, kThreads, 0, s>>>(
        cp, hd, t1, t2, xs, sc, out, rows, width, shift, mask);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
