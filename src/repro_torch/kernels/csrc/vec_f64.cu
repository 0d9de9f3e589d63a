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
// Stepped GMRES runs two GEMVs over its Krylov basis V ((R, n) row-major),
// rounded as XLA's CPU build of the reference (src/repro/solvers/gmres.py
// :147-148, :220) adds them; XLA emits 256-bit vectors there
// (prefer-vector-width=256), four f64 lanes:
//
// * `gemv_rows_ref_f64`: out[r] = V[r] . w for r < rows.  XLA's row-major
//   GEMV keeps four partial sums per row, lane l taking the elements
//   k = l (mod 4) of the first 4 * (n / 4), each step one FMA from 0.0;
//   the row's result is ((l0 + l2) + (l1 + l3)) + tail, the tail an FMA
//   chain from 0.0 over the n % 4 trailing elements.  Like seq_dot it is
//   bound by its chains' latency: one block per row, threads 0-3 of warp 0
//   carry the four lane chains (each loading its next group of 16 from
//   shared memory while it chains the current one) while warps 1-7 copy
//   the next 4096-element tiles of the row and of w into shared memory
//   with cp.async (two stages, 128 KB of dynamic shared memory: four
//   chains eat a tile four times as fast as seq_dot's one).
// * `gemv_cols_ref_f64`: out[k] = sum_{i < rows} c[i] * V[i, k] (+ x[k]):
//   one FMA chain per column in row order, from 0.0 or from the addend
//   (XLA fuses the reference's `x + y @ V` into the dot).  Without an
//   addend and with n % 4 == 1 the last column is XLA's scalar tail, which
//   starts at c[0] * V[0, k] and adds rows 1-7 as rounded products before
//   fusing.  Bound by HBM bytes: one thread per column, coalesced rows.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDotThreads = 256;  // warp 0 computes, warps 1..7 load
constexpr int kTile = 1024;       // elements of a and b per buffer (32 KB in all)
constexpr int kHead = 8;          // leading elements added without fusion
constexpr int kGroup = 16;        // pairs per register group of the chain
constexpr int kLoaders = kDotThreads - 32;
constexpr int kAxpyThreads = 256;
constexpr int kLanes = 4;         // partial sums per row of XLA's row GEMV
constexpr int kRowTile = 4096;    // doubles of a row (and of w) per stage
constexpr int kRowSmem = 2 * 2 * kRowTile * (int)sizeof(double);  // 128 KB
constexpr int kColThreads = 256;

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

// Copy one tile of a V row and of w (up to kRowTile doubles each) into
// shared memory asynchronously (cp.async, no register staging): 16-byte
// pieces for even n (rows 16-byte aligned), 8-byte ones otherwise.  The
// four chains eat a tile four times as fast as seq_dot's one, so the
// tile is 4x larger and every loader has all its copies in flight at once.
__device__ __forceinline__ void stage_async(const double* __restrict__ a,
                                            const double* __restrict__ b,
                                            long long base, long long m,
                                            double* sa, double* sb,
                                            bool pairs) {
  const long long left = m - base;
  const int len = left < kRowTile ? (int)left : kRowTile;  // a multiple of 4
  if (pairs) {
    for (int i = 2 * (threadIdx.x - 32); i < len; i += 2 * kLoaders) {
      __pipeline_memcpy_async(sa + i, a + base + i, 16);
      __pipeline_memcpy_async(sb + i, b + base + i, 16);
    }
  } else {
    for (int i = threadIdx.x - 32; i < len; i += kLoaders) {
      __pipeline_memcpy_async(sa + i, a + base + i, 8);
      __pipeline_memcpy_async(sb + i, b + base + i, 8);
    }
  }
  __pipeline_commit();
}

// Block r computes out[r] = V[r] . w over the first m = 4 * (n / 4)
// elements in four lane chains, then adds the tail.  Dynamic shared
// memory: two stages of a row tile and a w tile (kRowSmem bytes).
__global__ void __launch_bounds__(kDotThreads)
gemv_rows_ref_kernel(const double* __restrict__ V, const double* __restrict__ w,
                     long long n, double* __restrict__ out) {
  extern __shared__ __align__(16) double smem[];
  const double* row = V + (long long)blockIdx.x * n;
  const long long m = n - n % kLanes;
  const bool loader = threadIdx.x >= 32;
  const int lane = threadIdx.x;  // chains run on threads 0..3
  const long long tiles = (m + kRowTile - 1) / kRowTile;
  const bool pairs = n % 2 == 0 && (reinterpret_cast<uintptr_t>(V) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  double acc = 0.0;
  if (loader && tiles > 0) {
    stage_async(row, w, 0, m, smem, smem + kRowTile, pairs);
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  for (long long t = 0; t < tiles; ++t) {
    const int cur = (int)(t & 1);
    double* sa = smem + 2 * kRowTile * cur;
    double* sb = sa + kRowTile;
    if (loader) {
      if (t + 1 < tiles) {
        double* na = smem + 2 * kRowTile * (cur ^ 1);
        stage_async(row, w, (t + 1) * kRowTile, m, na, na + kRowTile, pairs);
        __pipeline_wait_prior(0);  // lands while the chains run tile t
      }
    } else if (lane < kLanes) {
      const long long left = m - t * kRowTile;
      const int len = left < kRowTile ? (int)left : kRowTile;  // a multiple of 4
      const double* xa = sa + lane;
      const double* xb = sb + lane;
      constexpr int kStep = kGroup * kLanes;
      int i = 0;
      // Groups of kGroup steps, the next group's shared loads in flight
      // while the current group's dependent FMAs run (as seq_dot does).
      if (kStep <= len) {
        double ra[kGroup], rb[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          ra[k] = xa[k * kLanes];
          rb[k] = xb[k * kLanes];
        }
        for (; i + 2 * kStep <= len; i += kStep) {
          double na[kGroup], nb[kGroup];
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            na[k] = xa[i + kStep + k * kLanes];
            nb[k] = xb[i + kStep + k * kLanes];
          }
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
        i += kStep;
      }
      for (; i < len; i += kLanes) acc = __fma_rn(xa[i], xb[i], acc);
    }
    __syncthreads();  // stage `cur` is read; the other one is full
  }
  if (threadIdx.x < 32) {
    const unsigned mask = 0xfu;
    if (lane < kLanes) {
      const double l2 = __shfl_sync(mask, acc, 2);
      const double l3 = __shfl_sync(mask, acc, 3);
      const double l1 = __shfl_sync(mask, acc, 1);
      if (lane == 0) {
        double tail = 0.0;
        for (long long k = m; k < n; ++k) tail = __fma_rn(row[k], w[k], tail);
        out[blockIdx.x] = __dadd_rn(__dadd_rn(__dadd_rn(acc, l2), __dadd_rn(l1, l3)), tail);
      }
    }
  }
}

// Thread k computes out[k] = addend[k] + sum_{i < rows} c[i] * V[i, k] as
// one FMA chain in row order (addend may be null: the chain starts at 0.0).
__global__ void __launch_bounds__(kColThreads)
gemv_cols_ref_kernel(const double* __restrict__ c, const double* __restrict__ V,
                     const double* __restrict__ addend, long long n, int rows,
                     double* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const double* col = V + k;
  int i = 0;
  double acc;
  if (addend == nullptr && n % kLanes == 1 && k == n - 1) {
    // XLA's scalar tail column: the first 8 rows as rounded products.
    acc = __dmul_rn(__ldg(c), __ldg(col));
    for (i = 1; i < rows && i < kHead; ++i)
      acc = __dadd_rn(acc, __dmul_rn(__ldg(c + i), __ldg(col + (long long)i * n)));
  } else {
    acc = addend != nullptr ? addend[k] : 0.0;
  }
#pragma unroll 8
  for (; i < rows; ++i) acc = __fma_rn(__ldg(c + i), __ldg(col + (long long)i * n), acc);
  out[k] = acc;
}

// The chain-latency probe: one thread runs n dependent steps from
// registers, acc = __dadd_rn(acc, b) (op 0) or acc = __fma_rn(acc, a, b)
// (op 1), n a multiple of 8.  out[0] = acc (so nothing is dead code),
// out[1] = the SM clocks the loop took.  A dependent chain cannot go
// faster than one step per latency, so n times the latency is the bound
// of seq_dot (an FMA chain) and of the f64 SpMV rows (an add chain).
__global__ void chain_probe_kernel(int op, long long n, double a, double b,
                                   double* __restrict__ out) {
  double acc = a;
  const long long t0 = clock64();
  if (op == 0) {
    for (long long i = 0; i < n; i += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = __dadd_rn(acc, b);
    }
  } else {
    for (long long i = 0; i < n; i += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = __fma_rn(acc, a, b);
    }
  }
  const long long t1 = clock64();
  out[0] = acc;
  out[1] = (double)(t1 - t0);
}

}  // namespace

// The chain-latency probe (chain_probe_kernel): one thread, n steps.
extern "C" int chain_probe_f64(int op, long long n, double a, double b,
                               void* out, void* stream) {
  if ((op != 0 && op != 1) || n <= 0 || n % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  chain_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(op, n, a, b,
                                                        (double*)out);
  return (int)cudaGetLastError();
}

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

// out[r] = V[r] . w for the first `rows` rows of a row-major (R, n) f64 V,
// rounded as XLA's CPU row GEMV (see gemv_rows_ref_kernel).
extern "C" int gemv_rows_ref_f64(const void* V, const void* w, long long n,
                                 int rows, void* out, void* stream) {
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      gemv_rows_ref_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kRowSmem);
  if (attr != cudaSuccess) return (int)attr;
  gemv_rows_ref_kernel<<<rows, kDotThreads, kRowSmem, (cudaStream_t)stream>>>(
      (const double*)V, (const double*)w, n, (double*)out);
  return (int)cudaGetLastError();
}

// out[k] = (addend[k] +) sum_{i < rows} c[i] * V[i, k] over the n columns,
// rounded as XLA's CPU column GEMV (see gemv_cols_ref_kernel); addend may
// be null.
extern "C" int gemv_cols_ref_f64(const void* c, const void* V,
                                 const void* addend, long long n, int rows,
                                 void* out, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kColThreads - 1) / kColThreads;
  gemv_cols_ref_kernel<<<(unsigned)blocks, kColThreads, 0, (cudaStream_t)stream>>>(
      (const double*)c, (const double*)V, (const double*)addend, n, rows,
      (double*)out);
  return (int)cudaGetLastError();
}
