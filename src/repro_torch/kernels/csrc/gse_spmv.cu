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
//   The sum is the plain version's: 32 lane chains (lane l adds slots l,
//   l+32, ... from 0.0), then the warp's shuffle tree; the decode keeps
//   `decode_tile`'s operation order with round-to-nearest intrinsics.
//   The ELL width is the TPU's: the longest row rounded up to 128 lanes,
//   so on the uniform operator (17 entries a row, 35 at most) 87% of the
//   slots are padding.  A warp that walked all of a row's 128 slots
//   (the first design) streamed 7.5x the bytes the real slots hold, at
//   80-88% of the HBM rate (0.29/0.40/0.55 ms at tags 1/2/3, 1.9-3.5x
//   cuSPARSE; NVIDIA H100 80GB HBM3, 700 W).  So each row reads only its
//   `row_len` real slots (the CSR's diff(rowptr), ops.ell_row_lengths),
//   and a row with padding adds the product a padded slot would add, once
//   (+-0.0 for a finite x[0]: no bit changes; NaN otherwise, the padded
//   walk's NaN).  With 17 slots a row, a warp a row would leave most
//   lanes idle and one row's chain of dependent loads in flight per warp;
//   so a row runs on a group of `lanes` (4, 8, 16 or 32) lanes
//   (group_row_f32): lane g carries the chains of lanes g, g + lanes,
//   ..., adds the tree's wider offsets within itself and the rest by
//   shuffles within the group, which is the same sum bit for bit.
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

// A32: rows on groups of G lanes (group_row_f32), 256 / G rows a block.
template <int TAG, int G>
__global__ void __launch_bounds__(kThreads) spmv_ell_f32_kernel(
    const gse::EllF32 a) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int g = threadIdx.x & (G - 1);
  const int len = gse::ell_row_len(a, row);
  float pad[1], acc[1];
  gse::pad_products_f32<TAG, 1>(a.x, 1, 1, false, a.scales, len < a.width,
                                pad);
  gse::group_row_f32<TAG, G, 1>(row * (int64_t)a.width, len, g, pad,
                                a.colpak, a.head, a.tail1, a.tail2, a.x, 1,
                                1, false, a.scales, a.shift, a.mask, acc);
  if (g == 0 && row < a.rows) a.y[row] = acc[0];
}

template <int G>
int spmv_ell_f32_on(int tag, const gse::EllF32& a, cudaStream_t s) {
  const long long blocks = (a.rows * G + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (tag == 1) {
    spmv_ell_f32_kernel<1, G><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  } else if (tag == 2) {
    spmv_ell_f32_kernel<2, G><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  } else if (tag == 3) {
    spmv_ell_f32_kernel<3, G><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

// y (rows,) f32 = A x over the (rows, width) ELL segments at `tag`, each
// row over its row_len[row] real slots, on groups of `lanes` lanes; x is
// (n,) f32.
extern "C" int gse_spmv_ell_f32(int tag, int lanes, const void* colpak,
                                const void* head, const void* tail1,
                                const void* tail2, const void* x,
                                const void* scales, const void* row_len,
                                void* y, long long rows, int width,
                                int ei_bit, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const int shift = 32 - ei_bit;
  const gse::EllF32 a{(const uint32_t*)colpak, (const uint16_t*)head,
                      (const uint16_t*)tail1, (const uint32_t*)tail2,
                      (const float*)x, (const float*)scales,
                      (const int32_t*)row_len, (float*)y, rows, width, shift,
                      (1u << shift) - 1u};
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 4: return spmv_ell_f32_on<4>(tag, a, s);
    case 8: return spmv_ell_f32_on<8>(tag, a, s);
    case 16: return spmv_ell_f32_on<16>(tag, a, s);
    case 32: return spmv_ell_f32_on<32>(tag, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
