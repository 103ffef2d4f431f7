// cauchy_rowsum: boundary rows pushed through a merge's Cauchy matrix.
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/cauchy_rowsum.py::cauchy_rowsum,
// called by kernels/assemble.py::rows_through_merge on every non-root level of
// the upsweep.  For merge b, row r (R <= 2) and column i:
//
//   S[b, r, i] = sum_j wz[b, r, j] / ((p_bj - shift_bi) - tau_bi)
//
// The sums feed the next level's z-vector, so they must be f64-grade.  The TPU
// kernel builds them from f32 pairs; Hopper has IEEE f64 and computes the
// contract directly.
//
// What bounds it on an H100: FP64 arithmetic.  Each (column, pole) pair costs
// an f64 division and R multiply-adds, against k*(3 + 2R)*m doubles of
// device-memory traffic.  Design: a block holds 64 columns x 4 pole lanes
// (256 threads); poles and the R weight rows are staged through shared memory
// in 256-wide tiles (a warp reads one pole at a time: a broadcast), one
// reciprocal serves both rows, and each row is a compensated (TwoSum) sum
// whose four lane partials are combined in shared memory.  Products use
// __dmul_rn so no FMA contraction changes a term.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 64;
constexpr int kLanes = 4;
constexpr int kThreads = kCols * kLanes;
constexpr int kTile = kThreads;
constexpr int kMaxRows = 2;

__device__ __forceinline__ void two_sum_acc(double& s, double& c, double x) {
  const double t = __dadd_rn(s, x);
  const double bp = __dsub_rn(t, s);
  const double err = __dadd_rn(__dsub_rn(s, __dsub_rn(t, bp)), __dsub_rn(x, bp));
  s = t;
  c = __dadd_rn(c, err);
}

__global__ void __launch_bounds__(kThreads)
cauchy_rowsum_kernel(const double* __restrict__ poles, const double* __restrict__ shift,
                     const double* __restrict__ tau, const double* __restrict__ wz,
                     double* __restrict__ out, int m, int R) {
  __shared__ double sp[kTile];
  __shared__ double sw[kMaxRows][kTile];
  __shared__ double red[2 * kMaxRows][kLanes][kCols];

  const int b = blockIdx.y;
  const int c = threadIdx.x % kCols;
  const int lane = threadIdx.x / kCols;
  const int i = blockIdx.x * kCols + c;
  const bool live = i < m;
  const size_t ib = (size_t)b * m + (live ? i : 0);
  const double sv = live ? shift[ib] : 0.0;
  const double tv = live ? tau[ib] : 0.0;
  const double* pb = poles + (size_t)b * m;
  const double* wb = wz + (size_t)b * R * m;

  double s[kMaxRows] = {0.0, 0.0};
  double cc[kMaxRows] = {0.0, 0.0};
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int len = min(kTile, m - j0);
    __syncthreads();
    if (threadIdx.x < len) {
      sp[threadIdx.x] = pb[j0 + threadIdx.x];
      for (int r = 0; r < R; ++r) sw[r][threadIdx.x] = wb[(size_t)r * m + j0 + threadIdx.x];
    }
    __syncthreads();
    if (live) {
      for (int jj = lane; jj < len; jj += kLanes) {
        const double inv = 1.0 / __dsub_rn(__dsub_rn(sp[jj], sv), tv);
        for (int r = 0; r < R; ++r) two_sum_acc(s[r], cc[r], __dmul_rn(sw[r][jj], inv));
      }
    }
  }

  for (int r = 0; r < kMaxRows; ++r) {
    red[2 * r][lane][c] = s[r];
    red[2 * r + 1][lane][c] = cc[r];
  }
  __syncthreads();
  if (lane == 0 && live) {
    for (int r = 0; r < R; ++r) {
      double S = 0.0, C = 0.0;
      for (int l = 0; l < kLanes; ++l) {
        two_sum_acc(S, C, red[2 * r][l][c]);
        C = __dadd_rn(C, red[2 * r + 1][l][c]);
      }
      out[((size_t)b * R + r) * m + i] = S + C;
    }
  }
}

}  // namespace

// poles, shift, tau: (k, m) f64; wz: (k, R, m) f64 with 1 <= R <= 2;
// out: (k, R, m) f64.  All contiguous on one device.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError() (cudaErrorInvalidValue for
// R outside [1, 2]).
extern "C" int cauchy_rowsum_launch(const void* poles, const void* shift,
                                    const void* tau, const void* wz, void* out,
                                    int k, int m, int R, void* stream) {
  if (R < 1 || R > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 0 || m <= 0) return 0;
  const dim3 grid((m + kCols - 1) / kCols, k);
  cauchy_rowsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(poles), static_cast<const double*>(shift),
      static_cast<const double*>(tau), static_cast<const double*>(wz),
      static_cast<double*>(out), m, R);
  return static_cast<int>(cudaGetLastError());
}
