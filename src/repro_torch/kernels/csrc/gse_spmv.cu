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
//   same function as `spmv_gse` (`_decode_gsecsr` plus `segment_sum`).
//   Each row's products are added in CSR order from 0.0 with
//   __dmul_rn/__dadd_rn (no FMA contraction), which keeps the result
//   bitwise equal to the reference's sequential row sum; which threads
//   load, decode and multiply, and which thread adds, follows the row's
//   length, by the pack's row plan (GSECSR.row_plan, sparse/csr.py), one
//   launch for all three bodies (gse_rows.cuh):
//   - long rows (the skewed operators' hubs) a block each, launched first
//     (block_chain_f64, B64's long-row body): seven warps stage the
//     products a chunk ahead of the one thread that adds them, so a dense
//     row costs one dependent add per slot, not a load;
//   - rows in between a warp each (warp_chain_f64, B64's other rows);
//   - short rows (the uniform operators) in row blocks of consecutive
//     rows (row_block_f64): the block's threads stage the run's products
//     in shared memory with coalesced loads, then each thread adds one row.
//   A thread that walked its own row (the first design) read the segments
//   of 32 rows 17 slots apart per warp load, and waited on a load at every
//   step of a dense row (45-66 ms per SpMV on the full-size skewed
//   operator; NVIDIA H100 80GB HBM3, 700 W).  The tag is read from a
//   device int32 so the solver loop never syncs to pick a build; the
//   branch is uniform across the grid and the tag-1 branch never loads a
//   tail.  Padded slots do not exist here, so a non-finite x spreads
//   exactly as in `spmv_gse`.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gse_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = gse::kChainThreads / 32;  // A64's warp rows a block

// Blocks [0, n_long) take the long rows, one each (block_chain_f64); the
// next ceil(n_warp / 8) take the warp rows, eight to a block
// (warp_chain_f64); the rest take the row blocks [first row, end row)
// (row_block_f64).
__global__ void __launch_bounds__(gse::kChainThreads) spmv_csr_f64_kernel(
    const int32_t* __restrict__ tag, const int32_t* __restrict__ rowptr,
    const uint32_t* __restrict__ colpak, const uint16_t* __restrict__ head,
    const uint16_t* __restrict__ tail1, const uint32_t* __restrict__ tail2,
    const int32_t* __restrict__ table, const double* __restrict__ x,
    double* __restrict__ y, const int32_t* __restrict__ long_rows,
    int64_t n_long, const int32_t* __restrict__ warp_rows, int64_t n_warp,
    const int32_t* __restrict__ row_blocks, int shift, uint32_t mask) {
  __shared__ __align__(16) double buf[gse::kRowBlockSlots];
  int64_t b = blockIdx.x;
  if (b < n_long) {
    const int row = __ldg(long_rows + b);
    const int base = __ldg(rowptr + row);
    const double acc = gse::block_chain_f64_at(
        tag, buf, base, __ldg(rowptr + row + 1) - base, colpak, head, tail1,
        tail2, table, x, shift, mask);
    if (threadIdx.x == 0) y[row] = acc;
    return;
  }
  b -= n_long;
  const int64_t warp_blocks = (n_warp + kWarps - 1) / kWarps;
  if (b < warp_blocks) {
    const int64_t w = b * kWarps + (threadIdx.x >> 5);
    if (w >= n_warp) return;  // uniform across the warp
    const int row = __ldg(warp_rows + w);
    const int base = __ldg(rowptr + row);
    const double acc = gse::warp_chain_f64_at(
        tag, base, __ldg(rowptr + row + 1) - base, threadIdx.x & 31, colpak,
        head, tail1, tail2, table, x, shift, mask);
    if ((threadIdx.x & 31) == 0) y[row] = acc;
    return;
  }
  b -= warp_blocks;
  gse::row_block_f64_at(tag, buf, rowptr, __ldg(row_blocks + 2 * b),
                        __ldg(row_blocks + 2 * b + 1), colpak, head, tail1,
                        tail2, table, x, y, shift, mask);
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

// y (rows,) f64 = A x over the CSR at the device tag; x is (n,) f64.  The
// row plan: `long_rows` (n_long row ids), `warp_rows` (n_warp row ids) and
// `row_blocks` (n_blocks [first row, end row) pairs) cover every row once.
extern "C" int gse_spmv_csr_f64(const void* tag, const void* rowptr,
                                const void* colpak, const void* head,
                                const void* tail1, const void* tail2,
                                const void* table, const void* x, void* y,
                                const void* long_rows, long long n_long,
                                const void* warp_rows, long long n_warp,
                                const void* row_blocks, long long n_blocks,
                                int ei_bit, void* stream) {
  if (n_long < 0 || n_warp < 0 || n_blocks < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int shift = 32 - ei_bit;
  const uint32_t mask = (1u << shift) - 1u;
  const long long blocks = n_long + (n_warp + kWarps - 1) / kWarps + n_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks > 0) {
    spmv_csr_f64_kernel<<<(unsigned)blocks, gse::kChainThreads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)tag, (const int32_t*)rowptr, (const uint32_t*)colpak,
        (const uint16_t*)head, (const uint16_t*)tail1, (const uint32_t*)tail2,
        (const int32_t*)table, (const double*)x, (double*)y,
        (const int32_t*)long_rows, n_long, (const int32_t*)warp_rows, n_warp,
        (const int32_t*)row_blocks, shift, mask);
  }
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
