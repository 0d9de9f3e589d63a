// The stepped CG loop's f64 vector operations on Hopper, rounded as the
// reference rounds them.
//
// The reference's CG step (src/repro/solvers/fused_cg.py `_step_at_tag`,
// src/repro/solvers/cg.py `_solve_cg`) is compiled by XLA's CPU backend,
// which contracts a multiply feeding an add into one fused multiply-add:
//
//   * `jnp.vdot(a, b)` is one chain in index order.  Its emitter (a column-
//     major GEMV in tiles of 8) starts the accumulator at a[0] * b[0] and
//     adds the rest of that first tile as separately rounded products,
//     acc = acc + a[i] * b[i]; every later element is one fused step,
//     acc = fma(a[i], b[i], acc);
//   * `x + alpha * p`, `r - alpha * ap` and `r + beta * p` are elementwise
//     fma(alpha, p, x), fma(-alpha, ap, r) and fma(beta, p, r).
//
// The stepped solver's tag schedule depends on this rounding: at tag 1 the
// CG recurrence turns an ulp into a different residual history, and the
// monitor's switch decisions count its decreases.  These two kernels
// compute the same roundings with __fma_rn, so the port's iterates are
// bitwise the reference's and the card and the CPU twin agree.
//
// * `seq_dot_f64`: bound by the chain's latency, not by bytes.  Every step
//   depends on the one before, so one thread runs all n dependent FMAs;
//   the other warps of the block stage the next tile of a and b into
//   shared memory with coalesced loads while it does (double-buffered), so
//   the chain never waits on HBM.  The computing thread in turn loads the
//   next group of kGroup pairs from shared memory into registers (16-byte
//   loads) before it chains the current group, so the chain does not wait
//   on shared memory either.  A parallel reduction would be far faster but
//   would round differently.
// * `fma_axpy_f64`: out = fma(alpha, x, y), one thread per element, bound
//   by HBM bytes (two reads, one write).  alpha is read from device memory,
//   so the loop never syncs to pass it.
//
// The batched CG loop keeps its vectors as (nrhs, n) blocks, one column
// contiguous per right-hand side, and runs the column-batched twins:
//
// * `seq_dot_cols_f64`: one block per column, each running the chain above
//   on its own column, so the chains run side by side on separate SMs and
//   a batch costs one chain's latency, not nrhs of them.  Column j rounds
//   exactly as `seq_dot_f64` on that column.  An inactive column (device
//   uint8 active[j] == 0) reads nothing and gets 0.0.
// * `fma_axpy_cols_f64`: out[j] = fma(alpha[j], x[j], y[j]), grid.y over
//   the columns; column j is bitwise `fma_axpy_f64` on that column.
//
// The single-vector entry points are the same kernels with one column.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDotThreads = 256;  // warp 0 computes, warps 1..7 load
constexpr int kTile = 1024;       // elements of a and b per buffer (32 KB in all)
constexpr int kHead = 8;          // leading elements added without fusion
constexpr int kGroup = 16;        // pairs per register group of the chain
constexpr int kLoaders = kDotThreads - 32;
constexpr int kAxpyThreads = 256;

__device__ __forceinline__ void stage(const double* __restrict__ a,
                                      const double* __restrict__ b,
                                      long long base, long long n,
                                      double* sa, double* sb) {
  for (int i = threadIdx.x - 32; i < kTile; i += kLoaders) {
    const long long g = base + i;
    if (g < n) {
      sa[i] = a[g];
      sb[i] = b[g];
    }
  }
}

__device__ __forceinline__ void load_group(const double* xa, const double* xb,
                                           double* ra, double* rb) {
#pragma unroll
  for (int k = 0; k < kGroup; k += 2) {
    const double2 p = *reinterpret_cast<const double2*>(xa + k);
    const double2 q = *reinterpret_cast<const double2*>(xb + k);
    ra[k] = p.x;
    ra[k + 1] = p.y;
    rb[k] = q.x;
    rb[k + 1] = q.y;
  }
}

// Block j computes out[j] = a[j] . b[j] over the j-th n-long column;
// `active` may be null (every column active).
__global__ void __launch_bounds__(kDotThreads)
seq_dot_f64_kernel(const double* __restrict__ a, const double* __restrict__ b,
                   long long n, const uint8_t* __restrict__ active,
                   double* __restrict__ out) {
  __shared__ __align__(16) double sa[2][kTile];
  __shared__ __align__(16) double sb[2][kTile];
  const int col = blockIdx.x;
  if (active != nullptr && !active[col]) {  // uniform across the block
    if (threadIdx.x == 0) out[col] = 0.0;
    return;
  }
  a += (long long)col * n;
  b += (long long)col * n;
  const bool loader = threadIdx.x >= 32;
  const long long tiles = (n + kTile - 1) / kTile;
  double acc = 0.0;
  if (loader && tiles > 0) stage(a, b, 0, n, sa[0], sb[0]);
  __syncthreads();
  for (long long t = 0; t < tiles; ++t) {
    const int cur = (int)(t & 1);
    if (loader) {
      if (t + 1 < tiles) stage(a, b, (t + 1) * kTile, n, sa[cur ^ 1], sb[cur ^ 1]);
    } else if (threadIdx.x == 0) {
      const long long left = n - t * kTile;
      const int m = left < kTile ? (int)left : kTile;
      const double* xa = sa[cur];
      const double* xb = sb[cur];
      int i = 0;
      if (t == 0) {
        const int head = m < kHead ? m : kHead;
        acc = __dmul_rn(xa[0], xb[0]);
        for (i = 1; i < head; ++i) acc = __dadd_rn(acc, __dmul_rn(xa[i], xb[i]));
      }
      if (i + kGroup <= m) {  // i is even here, so the 16-byte loads align
        double ra[kGroup], rb[kGroup];
        load_group(xa + i, xb + i, ra, rb);
        for (; i + 2 * kGroup <= m; i += kGroup) {
          double na[kGroup], nb[kGroup];
          load_group(xa + i + kGroup, xb + i + kGroup, na, nb);
#pragma unroll
          for (int k = 0; k < kGroup; ++k) acc = __fma_rn(ra[k], rb[k], acc);
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            ra[k] = na[k];
            rb[k] = nb[k];
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) acc = __fma_rn(ra[k], rb[k], acc);
        i += kGroup;
      }
      for (; i < m; ++i) acc = __fma_rn(xa[i], xb[i], acc);
    }
    __syncthreads();  // buffer `cur` is read; the other one is full
  }
  if (threadIdx.x == 0) out[col] = acc;
}

// Column j = blockIdx.y of the (ncols, n) blocks: out = fma(alpha[j], x, y).
__global__ void __launch_bounds__(kAxpyThreads)
fma_axpy_f64_kernel(const double* __restrict__ alpha,
                    const double* __restrict__ x, const double* __restrict__ y,
                    double* __restrict__ out, long long n) {
  const long long off = (long long)blockIdx.y * n;
  const double s = alpha[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[off + i] = __fma_rn(s, x[off + i], y[off + i]);
}

cudaError_t launch_axpy(const void* alpha, const void* x, const void* y,
                        void* out, long long n, int ncols, void* stream) {
  long long blocks = (n + kAxpyThreads - 1) / kAxpyThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  if (blocks < 1) blocks = 1;
  fma_axpy_f64_kernel<<<dim3((unsigned)blocks, (unsigned)ncols), kAxpyThreads,
                        0, (cudaStream_t)stream>>>(
      (const double*)alpha, (const double*)x, (const double*)y, (double*)out, n);
  return cudaGetLastError();
}

}  // namespace

// out[0] = a . b over n f64 elements, rounded as the reference's vdot (0.0 for n = 0).
extern "C" int seq_dot_f64(const void* a, const void* b, long long n, void* out,
                           void* stream) {
  seq_dot_f64_kernel<<<1, kDotThreads, 0, (cudaStream_t)stream>>>(
      (const double*)a, (const double*)b, n, nullptr, (double*)out);
  return (int)cudaGetLastError();
}

// out[j] = a[j] . b[j] for the ncols n-long columns of two (ncols, n)
// blocks, each rounded as seq_dot_f64; 0.0 where active[j] is 0.
extern "C" int seq_dot_cols_f64(const void* a, const void* b, long long n,
                                int ncols, const void* active, void* out,
                                void* stream) {
  seq_dot_f64_kernel<<<ncols, kDotThreads, 0, (cudaStream_t)stream>>>(
      (const double*)a, (const double*)b, n, (const uint8_t*)active,
      (double*)out);
  return (int)cudaGetLastError();
}

// out[i] = fma(alpha[0], x[i], y[i]) over n f64 elements.
extern "C" int fma_axpy_f64(const void* alpha, const void* x, const void* y,
                            void* out, long long n, void* stream) {
  return (int)launch_axpy(alpha, x, y, out, n, 1, stream);
}

// out[j, i] = fma(alpha[j], x[j, i], y[j, i]) over (ncols, n) f64 blocks.
extern "C" int fma_axpy_cols_f64(const void* alpha, const void* x,
                                 const void* y, void* out, long long n,
                                 int ncols, void* stream) {
  return (int)launch_axpy(alpha, x, y, out, n, ncols, stream);
}
