// secular_sums: the secular root finder's per-iteration reductions.
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/secular_sums.py::secular_sums,
// the Pallas kernel behind every iteration of kernels/secular.py::_solve_roots.
// For merge b and root i, with dif_ij = (p_bj - shift_bi) - tau_bi:
//
//   S1 = sum_j z2_bj / dif_ij        S2 = sum_j z2_bj / dif_ij^2
//   S1L, S2L: the same sums restricted to j <= sl_bi
//
// The TPU kernel carries f64 as f32 pairs; Hopper has IEEE f64, so this
// computes the contract directly in f64.
//
// What bounds it on an H100: FP64 arithmetic.  Each (root, pole) pair costs an
// f64 division (a multi-instruction reciprocal sequence), two multiplies and
// the adds of the sums, while device-memory traffic is only k*(2m + 5B)
// doubles: the poles and weights are staged through shared memory once per
// block of roots.  Design: a block holds 64 roots x 4 pole lanes (256
// threads); every thread walks a quarter of each 256-pole shared-memory tile
// for its root (all threads of a warp read the same pole: a broadcast), and
// the four lanes' partial sums are combined in shared memory at the end.
// S1/S1L decide convergence, so they are accumulated as compensated (TwoSum)
// sums; S2/S2L only steer the step and are plain f64 sums.  The products use
// __dmul_rn so no FMA contraction changes a term: every term is rounded
// exactly as the plain PyTorch version rounds it, and only the order of the
// sums differs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRoots = 64;
constexpr int kLanes = 4;
constexpr int kThreads = kRoots * kLanes;
constexpr int kTile = kThreads;

__device__ __forceinline__ void two_sum_acc(double& s, double& c, double x) {
  const double t = __dadd_rn(s, x);
  const double bp = __dsub_rn(t, s);
  const double err = __dadd_rn(__dsub_rn(s, __dsub_rn(t, bp)), __dsub_rn(x, bp));
  s = t;
  c = __dadd_rn(c, err);
}

__global__ void __launch_bounds__(kThreads)
secular_sums_kernel(const double* __restrict__ poles, const double* __restrict__ z2,
                    const double* __restrict__ shift, const double* __restrict__ tau,
                    const int64_t* __restrict__ sl, double* __restrict__ out,
                    int k, int m, int B) {
  __shared__ double sp[kTile];
  __shared__ double sz[kTile];
  __shared__ double red[6][kLanes][kRoots];

  const int b = blockIdx.y;
  const int r = threadIdx.x % kRoots;
  const int lane = threadIdx.x / kRoots;
  const int i = blockIdx.x * kRoots + r;
  const bool live = i < B;
  const size_t ib = (size_t)b * B + (live ? i : 0);
  const double sv = live ? shift[ib] : 0.0;
  const double tv = live ? tau[ib] : 0.0;
  const int64_t sli = live ? sl[ib] : -1;
  const double* pb = poles + (size_t)b * m;
  const double* zb = z2 + (size_t)b * m;

  double s1 = 0.0, c1 = 0.0, s1l = 0.0, c1l = 0.0, s2 = 0.0, s2l = 0.0;
  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int len = min(kTile, m - j0);
    __syncthreads();
    if (threadIdx.x < len) {
      sp[threadIdx.x] = pb[j0 + threadIdx.x];
      sz[threadIdx.x] = zb[j0 + threadIdx.x];
    }
    __syncthreads();
    if (live) {
      for (int jj = lane; jj < len; jj += kLanes) {
        const double dif = __dsub_rn(__dsub_rn(sp[jj], sv), tv);
        const double inv = 1.0 / dif;
        const double t1 = __dmul_rn(sz[jj], inv);
        const double t2 = __dmul_rn(t1, inv);
        two_sum_acc(s1, c1, t1);
        s2 = __dadd_rn(s2, t2);
        if ((int64_t)(j0 + jj) <= sli) {
          two_sum_acc(s1l, c1l, t1);
          s2l = __dadd_rn(s2l, t2);
        }
      }
    }
  }

  red[0][lane][r] = s1;
  red[1][lane][r] = c1;
  red[2][lane][r] = s1l;
  red[3][lane][r] = c1l;
  red[4][lane][r] = s2;
  red[5][lane][r] = s2l;
  __syncthreads();
  if (lane == 0 && live) {
    double S1 = 0.0, C1 = 0.0, S1L = 0.0, C1L = 0.0, S2 = 0.0, S2L = 0.0;
    for (int l = 0; l < kLanes; ++l) {
      two_sum_acc(S1, C1, red[0][l][r]);
      C1 = __dadd_rn(C1, red[1][l][r]);
      two_sum_acc(S1L, C1L, red[2][l][r]);
      C1L = __dadd_rn(C1L, red[3][l][r]);
      S2 = __dadd_rn(S2, red[4][l][r]);
      S2L = __dadd_rn(S2L, red[5][l][r]);
    }
    const size_t plane = (size_t)k * B;
    out[ib] = S1 + C1;
    out[plane + ib] = S2;
    out[2 * plane + ib] = S1L + C1L;
    out[3 * plane + ib] = S2L;
  }
}

}  // namespace

// poles, z2: (k, m) f64; shift, tau: (k, B) f64; sl: (k, B) int64;
// out: (4, k, B) f64 = S1, S2, S1L, S2L.  All contiguous on one device.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int secular_sums_launch(const void* poles, const void* z2,
                                   const void* shift, const void* tau,
                                   const void* sl, void* out, int k, int m,
                                   int B, void* stream) {
  if (k <= 0 || B <= 0) return 0;
  const dim3 grid((B + kRoots - 1) / kRoots, k);
  secular_sums_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(poles), static_cast<const double*>(z2),
      static_cast<const double*>(shift), static_cast<const double*>(tau),
      static_cast<const int64_t*>(sl), static_cast<double*>(out), k, m, B);
  return static_cast<int>(cudaGetLastError());
}
