// The stepped GMRES loop's small f64 kernels on Hopper, rounded as the
// reference's CPU build rounds them (src/repro/solvers/gmres.py).
//
// * `givens_step_f64` (gmres.py:154-170): one inner iteration's
//   least-squares update.  The Hessenberg column [h[0..j], hj1, 0...] is
//   rotated by rotations 0..j-1, rotation j is formed to zero its
//   subdiagonal, the column goes to H[:, j], g[j], g[j+1] are rotated and
//   resid = |g[j+1]|.  XLA's CPU build contracts cs*a + sn*b into
//   fma(cs, a, sn*b) and -sn*a + cs*b into fma(cs, b, -(sn*a)), evaluates
//   the masked update `on*t + (1-on)*col` as t + 0*col, rewrites _givens'
//   (a/scale)/dn as a/(dn*scale) and forms dn = sqrt(fma(an, an, bn*bn)).
//   The recurrence is sequential and O(restart): one thread runs it, in
//   place, and only where the device flag `active` is set, so the stepped
//   loop never syncs to run it.
// * `trsv_upper_ref_f64` (gmres.py:210-219): the cycle's back substitution
//   on the padded restart x restart triangle (the leading j x j block of H,
//   the identity elsewhere, a zero diagonal entry replaced by 1).  The
//   reference calls LAPACK's dtrsm from OpenBLAS, whose SkylakeX kernels
//   solve in blocks of 16 rows from the bottom (first a leftover block of
//   each power of two below 16 in restart % 16): a block subtracts its
//   product with the solved rows below -- per row one FMA chain from 0.0
//   in column order, subtracted once -- then solves itself, multiplying
//   by the reciprocal of the diagonal and updating the rows above with
//   FMAs.  One thread, once per restart cycle.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTrsmBlock = 16;

__device__ __forceinline__ double hessenberg(const double* H, int restart,
                                             int i, int k) {
  return H[(long long)i * restart + k];
}

__global__ void givens_step_kernel(const double* __restrict__ h,
                                   const double* __restrict__ hj1,
                                   double* __restrict__ cs,
                                   double* __restrict__ sn,
                                   double* __restrict__ g,
                                   double* __restrict__ H,
                                   double* __restrict__ resid,
                                   const bool* __restrict__ active, int j,
                                   int restart) {
  if (!*active) return;
  // The column lives in H[:, j] while it is rotated.
  double* col = H + j;
  const long long ld = restart;
  for (int i = 0; i <= restart; ++i) {
    col[i * ld] = i <= j ? h[i] : (i == j + 1 ? *hj1 : 0.0);
  }
  for (int i = 0; i < j; ++i) {
    const double a = col[i * ld];
    const double b = col[(i + 1) * ld];
    const double t1 = __fma_rn(cs[i], a, __dmul_rn(sn[i], b));
    const double t2 = __fma_rn(cs[i], b, -__dmul_rn(sn[i], a));
    col[i * ld] = __dadd_rn(t1, __dmul_rn(0.0, a));
    col[(i + 1) * ld] = __dadd_rn(t2, __dmul_rn(0.0, b));
  }
  for (int i = j; i <= restart; ++i) col[i * ld] = __dadd_rn(col[i * ld], 0.0);
  // _givens(a, b), scaled by max(|a|, |b|) (NaN propagates).
  const double a = col[j * ld];
  const double b = col[(j + 1) * ld];
  const double m = (isnan(a) || isnan(b)) ? a + b : fmax(fabs(a), fabs(b));
  const bool safe = m > 0.0;
  const double scale = safe ? m : 1.0;
  const double an = __ddiv_rn(a, scale);
  const double bn = __ddiv_rn(b, scale);
  const double d = __dmul_rn(__dsqrt_rn(__fma_rn(an, an, __dmul_rn(bn, bn))), scale);
  const double c = safe ? __ddiv_rn(a, d) : 1.0;
  const double s = safe ? __ddiv_rn(b, d) : 0.0;
  col[j * ld] = d;
  col[(j + 1) * ld] = 0.0;
  const double gj = g[j];
  const double g1 = __dmul_rn(-s, gj);
  cs[j] = c;
  sn[j] = s;
  g[j + 1] = g1;
  g[j] = __dmul_rn(c, gj);
  *resid = fabs(g1);
}

__global__ void trsv_upper_ref_kernel(const double* __restrict__ H,
                                      const double* __restrict__ g,
                                      const int* __restrict__ jp, int n,
                                      double* __restrict__ y,
                                      double* __restrict__ b) {
  const int jj = *jp;
  auto R = [&](int i, int k) -> double {
    double v = (i < jj && k < jj) ? hessenberg(H, n, i, k) : (i == k ? 1.0 : 0.0);
    return (i == k && v == 0.0) ? 1.0 : v;
  };
  for (int i = 0; i < n; ++i) {
    b[i] = i < jj ? g[i] : 0.0;
    y[i] = 0.0;
  }
  // Leftover blocks (smallest first) from the bottom, then whole blocks.
  const int rem = n % kTrsmBlock;
  int top = n;
  for (int step = 1; top > 0; step = step < kTrsmBlock ? 2 * step : step) {
    const int size = step < kTrsmBlock ? (rem & step) : kTrsmBlock;
    if (size == 0) continue;
    const int lo = top - size;
    if (top < n) {  // subtract the product with the solved rows below
      for (int i = lo; i < top; ++i) {
        double acc = 0.0;
        for (int k = top; k < n; ++k) acc = __fma_rn(R(i, k), y[k], acc);
        b[i] = __dsub_rn(b[i], acc);
      }
    }
    for (int k = top - 1; k >= lo; --k) {
      const double yk = __dmul_rn(b[k], __ddiv_rn(1.0, R(k, k)));
      y[k] = yk;
      for (int i = lo; i < k; ++i) b[i] = __fma_rn(-yk, R(i, k), b[i]);
    }
    top = lo;
  }
}

}  // namespace

// One inner iteration's rotations and Givens update (givens_step_kernel),
// in place, where *active is set.
extern "C" int givens_step_f64(const void* h, const void* hj1, void* cs,
                               void* sn, void* g, void* H, void* resid,
                               const void* active, int j, int restart,
                               void* stream) {
  if (restart <= 0 || j < 0 || j >= restart) return (int)cudaErrorInvalidValue;
  givens_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)h, (const double*)hj1, (double*)cs, (double*)sn,
      (double*)g, (double*)H, (double*)resid, (const bool*)active, j, restart);
  return (int)cudaGetLastError();
}

// y = the back substitution of a cycle of *j inner iterations over the
// (restart + 1, restart) row-major H and the (restart + 1,) g
// (trsv_upper_ref_kernel); b is (restart,) scratch.
extern "C" int trsv_upper_ref_f64(const void* H, const void* g, const void* j,
                                  int restart, void* y, void* b, void* stream) {
  if (restart <= 0) return (int)cudaErrorInvalidValue;
  trsv_upper_ref_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)H, (const double*)g, (const int*)j, restart, (double*)y,
      (double*)b);
  return (int)cudaGetLastError();
}
