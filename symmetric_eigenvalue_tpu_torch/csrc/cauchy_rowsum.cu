// cauchy_rowsum: boundary rows pushed through a merge's Cauchy matrix.
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/cauchy_rowsum.py::cauchy_rowsum,
// called by kernels/assemble.py::rows_through_merge on every non-root level of
// the upsweep.  For merge b with K_b active slots, row r (R <= 2) and column i:
//
//   S[b, r, i] = sum_{j < K_b} wz[b, r, j] / ((p_bj - shift_bi) - tau_bi)   (i < K_b)
//   S[b, r, i] = 0                                                          (i >= K_b)
//
// The sums feed the next level's z-vector, so they must be f64-grade.  The TPU
// kernel builds them from f32 pairs over all m slots; Hopper has IEEE f64 and
// computes the contract directly, over the active slots only.
//
// The K cut is exact.  wz is +0 past K_b (zhat is 0 in inactive slots), and a
// TwoSum of a +0 term leaves (s, c) as they were.  The pole range is cut into
// `splits` chunks of `chunk` poles and each chunk into 8 lanes (pole j goes to
// lane (j - chunk start) % 8), as functions of m and the launch plan alone,
// never of K; each lane adds its poles in ascending order.  So on the columns
// i < K_b a launch gives bit for bit what the same launch gives with K_b = m,
// and the caller (which keeps only those columns) sees no change.
//
// What bounds it on an H100.  At full K (a spectrum that deflates slowly, such
// as the Poisson matrix's): FP64 instructions.  Each (pole, column) term is two
// DADDs for the denominator, a correctly rounded reciprocal (MUFU.RCP64H and a
// Newton sequence), and per row a DMUL and a six-DADD TwoSum; the count of one
// term is read from the SASS of cauchy_rowsum_term_yardstick<R> (never
// launched), against k*(3 + R)*m doubles of traffic.  At the K of a spectrum
// that deflates fast (K_b <= ~100 at every level of a random matrix): launch
// latency and the k*R*m doubles of zeros written.  Design:
//  - A block holds 128 columns: 32 column groups x 8 pole lanes (256 threads;
//    the 8 lanes of a group are neighbours in one warp), each thread 4
//    columns, so each pole and weight read from shared memory (a broadcast)
//    serves 4 columns, and the 4 x R TwoSum chains and 4 reciprocals of a
//    pole are independent work that hides the FP64 latency.  R is a template
//    parameter and every accumulator index is known at compile time: the
//    sums stay in registers (no stack frame).
//  - The lanes of a group are combined by an xor butterfly of compensated
//    adds (fixed order; both lanes of an exchange get the same bits).
//  - Where k x (column blocks) cannot fill the SMs the pole sweep is split
//    across blocks (the host's plan, from k, m, the SM count and the blocks an
//    SM holds).  Each split writes its compensated partials (s, c) to a
//    scratch; the last split to arrive at a column block (a counter,
//    __threadfence + atomicAdd) adds them in split order and writes S, then
//    zeroes the counter for the next launch.  No atomics on values: the same
//    result from run to run.
//  - The K cut: a block whose columns all lie at or past K_b writes their
//    zeros and returns, a split whose poles all lie at or past K_b returns at
//    once, and the sweep ends at K_b, read from device memory (no host sync).
//  - Every rounding is written out (__dadd_rn, __dmul_rn), so no FMA
//    contraction changes a term; the reciprocal (__drcp_rn, correctly
//    rounded) is shared by the R rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;                     // pole lanes of a column group
constexpr int kGroups = 32;                   // column groups a block
constexpr int kThreads = kGroups * kLanes;
constexpr int kColsPerThread = 4;
constexpr int kCols = kGroups * kColsPerThread;   // columns a block
constexpr int kTile = 256;                    // poles a shared-memory tile
constexpr int kMinBlocks = 2;                 // caps the registers at 128
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void two_sum_acc(double& s, double& c, double x) {
  const double t = __dadd_rn(s, x);
  const double bp = __dsub_rn(t, s);
  const double err = __dadd_rn(__dsub_rn(s, __dsub_rn(t, bp)), __dsub_rn(x, bp));
  s = t;
  c = __dadd_rn(c, err);
}

// (s, c) += (s', c'), both compensated sums.  TwoSum's error is exact, so
// the two lanes of an exchange get the same bits whichever adds which.
__device__ __forceinline__ void add_pair(double& s, double& c, double so, double co) {
  const double t = __dadd_rn(s, so);
  const double bp = __dsub_rn(t, s);
  const double err = __dadd_rn(__dsub_rn(s, __dsub_rn(t, bp)), __dsub_rn(so, bp));
  s = t;
  c = __dadd_rn(__dadd_rn(c, co), err);
}

// One (pole, column) term added to the column's R sums.
template <int R>
__device__ __forceinline__ void term_acc(double p, const double (&w)[R], double sv,
                                         double tv, double (&s)[R], double (&c)[R]) {
  const double inv = __drcp_rn(__dsub_rn(__dsub_rn(p, sv), tv));
#pragma unroll
  for (int r = 0; r < R; ++r) two_sum_acc(s[r], c[r], __dmul_rn(w[r], inv));
}

// grid (column blocks * splits, k).  part: (k, splits, R, 2, m) f64 and
// counters (k, column blocks) when splits > 1.
template <int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cauchy_rowsum_kernel(const double* __restrict__ poles, const double* __restrict__ shift,
                     const double* __restrict__ tau, const double* __restrict__ wz,
                     const int64_t* __restrict__ K, double* __restrict__ out,
                     double* __restrict__ part, unsigned int* __restrict__ counters,
                     int m, int splits, int chunk) {
  __shared__ double sp[kTile];
  __shared__ double sw[R][kTile];
  __shared__ bool last;

  const int b = blockIdx.y;
  const int cb = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int Kb = static_cast<int>(min(max((long long)K[b], 0LL), (long long)m));
  const int col0 = cb * kCols;
  const int group = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  double* ob = out + (size_t)b * R * m;

  if (col0 >= Kb) {   // every column at or past K_b
    if (split == 0) {
      for (int t = threadIdx.x; t < R * kCols; t += kThreads) {
        const int i = col0 + t % kCols;
        if (i < m) ob[(size_t)(t / kCols) * m + i] = 0.0;
      }
    }
    return;
  }
  const int j0 = split * chunk;
  if (j0 >= Kb) return;   // every pole of this split at or past K_b
  const int j1 = min(j0 + chunk, Kb);
  const int nact = (Kb + chunk - 1) / chunk;   // splits with poles below K_b

  double sv[kColsPerThread], tv[kColsPerThread];
  double s[kColsPerThread][R], c[kColsPerThread][R];
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    const int i = col0 + group + kGroups * q;
    const bool live = i < Kb;
    sv[q] = live ? shift[(size_t)b * m + i] : 0.0;
    tv[q] = live ? tau[(size_t)b * m + i] : 0.0;
#pragma unroll
    for (int r = 0; r < R; ++r) s[q][r] = c[q][r] = 0.0;
  }

  const double* pb = poles + (size_t)b * m;
  const double* wb = wz + (size_t)b * R * m;
  for (int t0 = j0; t0 < j1; t0 += kTile) {
    const int len = min(kTile, j1 - t0);
    __syncthreads();
    if (threadIdx.x < len) {
      sp[threadIdx.x] = pb[t0 + threadIdx.x];
#pragma unroll
      for (int r = 0; r < R; ++r) sw[r][threadIdx.x] = wb[(size_t)r * m + t0 + threadIdx.x];
    }
    __syncthreads();
    for (int jj = lane; jj < len; jj += kLanes) {
      const double p = sp[jj];
      double w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = sw[r][jj];
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) term_acc<R>(p, w, sv[q], tv[q], s[q], c[q]);
    }
  }

  // the 8 lanes of each group: every lane gets the totals
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const double so = __shfl_xor_sync(kFull, s[q][r], o);
        const double co = __shfl_xor_sync(kFull, c[q][r], o);
        add_pair(s[q][r], c[q][r], so, co);
      }
    }
  }

  if (nact == 1) {   // one split: write S (lane q writes column q of the group)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int i = col0 + group + kGroups * q;
      if (lane == q && i < m) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          ob[(size_t)r * m + i] = i < Kb ? __dadd_rn(s[q][r], c[q][r]) : 0.0;
      }
    }
    return;
  }

  const size_t plane = (size_t)m;
  double* pp = part + (((size_t)b * splits + split) * R) * 2 * plane;
#pragma unroll
  for (int q = 0; q < kColsPerThread; ++q) {
    const int i = col0 + group + kGroups * q;
    if (lane == q && i < Kb) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pp[(size_t)(2 * r) * plane + i] = s[q][r];
        pp[(size_t)(2 * r + 1) * plane + i] = c[q][r];
      }
    }
  }

  // the last split to arrive adds the partials in split order
  unsigned int* counter = counters + (size_t)b * (gridDim.x / splits) + cb;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == static_cast<unsigned int>(nact - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const double* p0 = part + ((size_t)b * splits * R) * 2 * plane;
  for (int t = threadIdx.x; t < R * kCols; t += kThreads) {
    const int r = t / kCols;
    const int i = col0 + t % kCols;
    if (i >= m) continue;
    double v = 0.0;
    if (i < Kb) {
      const double* pr = p0 + (size_t)(2 * r) * plane + i;
      double S = __ldcg(pr), C = __ldcg(pr + plane);
      for (int q = 1; q < nact; ++q) {
        const double* ps = pr + (size_t)q * R * 2 * plane;
        add_pair(S, C, __ldcg(ps), __ldcg(ps + plane));
      }
      v = __dadd_rn(S, C);
    }
    ob[(size_t)r * m + i] = v;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// One (pole, column) term exactly as the sweep adds it (never launched: the
// FP64 instructions in its SASS are the yardstick of a term for the bound).
// Every input is loaded and every sum stored, so nothing is dropped.
template <int R>
__global__ void cauchy_rowsum_term_yardstick(const double* __restrict__ in,
                                             double* __restrict__ io) {
  double w[R], s[R], c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w[r] = in[3 + r];
    s[r] = io[2 * r];
    c[r] = io[2 * r + 1];
  }
  term_acc<R>(in[0], w, in[1], in[2], s, c);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    io[2 * r] = s[r];
    io[2 * r + 1] = c[r];
  }
}

void* kernel_for(int R) {
  return R == 1 ? reinterpret_cast<void*>(&cauchy_rowsum_kernel<1>)
                : reinterpret_cast<void*>(&cauchy_rowsum_kernel<2>);
}

}  // namespace

// poles, shift, tau: (k, m) f64; wz: (k, R, m) f64 with 1 <= R <= 2; K: (k,)
// int64; out: (k, R, m) f64.  splits * chunk >= m > (splits - 1) * chunk;
// when splits > 1, part holds (k, splits, R, 2, m) f64 of scratch and
// counters k * ceil(m / 128) zeroed unsigned ints, which the launch leaves
// zeroed.  All contiguous on one device.  Launches one kernel on `stream`,
// allocates nothing, returns cudaGetLastError() (cudaErrorInvalidValue for R
// outside [1, 2] or an inconsistent split).
extern "C" int cauchy_rowsum_launch(const void* poles, const void* shift,
                                    const void* tau, const void* wz, const void* K,
                                    void* out, void* part, void* counters, int k,
                                    int m, int R, int splits, int chunk,
                                    void* stream) {
  if (R < 1 || R > 2 || splits < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 0 || m <= 0) return 0;
  if ((long long)splits * chunk < m || (long long)(splits - 1) * chunk >= m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(((m + kCols - 1) / kCols) * splits, k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* p = static_cast<const double*>(poles);
  const double* sh = static_cast<const double*>(shift);
  const double* ta = static_cast<const double*>(tau);
  const double* w = static_cast<const double*>(wz);
  const int64_t* Kp = static_cast<const int64_t*>(K);
  double* o = static_cast<double*>(out);
  double* pt = static_cast<double*>(part);
  unsigned int* cn = static_cast<unsigned int*>(counters);
  if (R == 1) {
    cauchy_rowsum_kernel<1><<<grid, kThreads, 0, st>>>(p, sh, ta, w, Kp, o, pt, cn,
                                                       m, splits, chunk);
  } else {
    cauchy_rowsum_kernel<2><<<grid, kThreads, 0, st>>>(p, sh, ta, w, Kp, o, pt, cn,
                                                       m, splits, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// For the launch plan and the report, of the instance for R rows: out[0]
// registers a thread, out[1] local (stack and spill) bytes a thread, out[2]
// blocks an SM holds at once.  Returns a cudaError_t.
extern "C" int cauchy_rowsum_info(int R, int* out) {
  if (R < 1 || R > 2) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for(R);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  return 0;
}

// Keeps the yardstick kernels in the library (their SASS is read, never run).
extern "C" void* cauchy_rowsum_term_yardsticks(int R) {
  return R == 1 ? reinterpret_cast<void*>(&cauchy_rowsum_term_yardstick<1>)
                : reinterpret_cast<void*>(&cauchy_rowsum_term_yardstick<2>);
}
