// rotation_replay: the inverse Givens chain of every merge of a tree level,
// applied in place to the rows of the level's vectors y (k*m, C).
//
// Replaces the device loop of
// symmetric_eigenvalue_tpu/kernels/assemble.py::_replay_rotations_level (a
// lax.fori_loop over max(nwave) waves, no pallas_call), called from
// kernels/assemble.py::_apply_u_finish on every level of the downsweep.
//
//   for w = nwave_b .. 1, for every logged rotation i < nrot_b of merge b
//   with rot_wave[b, i] == w (a = rot_a[b, i], b' = rot_b[b, i]):
//     y[a]  <- c*y[a] + s*y[b']
//     y[b'] <- -s*y[a] + c*y[b']      (both from the values before the step)
//
// Rotations of one wave touch disjoint rows (the deflation tree pairs slots
// of disjoint blocks at each level), so a wave's rotations may run in any
// order and at once; waves run in descending order.  Every value is the
// product of separate IEEE roundings, mul, mul, add (__fmul_rn / __fadd_rn,
// __dmul_rn / __dadd_rn: no FMA contraction), with c and s first rounded to
// y's type: bit for bit the PyTorch wave loop, which runs them as separate
// elementwise kernels.  Nothing is read on the host: the block reads nrot,
// nwave and the log itself, so a level's launch is the same whatever the data.
//
// What bounds it on an H100: bytes.  Each logged rotation reads and writes
// two rows of y: 4*nrot*C*sizeof(T) bytes for a level.
//
// Design.  One block per (merge, 64-column tile), 512 threads: a thread owns
// one column of the tile and one of 8 rotation lanes.  Per wave, the block
// stages that wave's rotations from the log (a 1024-entry window at a time,
// compacted through a shared counter: the order inside a wave is free) into
// shared memory; then rotation lane l applies staged rotations l, l+8, ...,
// two at a time (four rows of loads in flight a thread), to its column.  A
// warp is 32 neighbouring columns of one row: each load is one coalesced
// 128-byte (f32) or 256-byte (f64) segment.  __syncthreads() separates the
// staging, the rotations and the next staging.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;       // columns a block
constexpr int kLanes = 8;       // rotation lanes a block
constexpr int kThreads = kTile * kLanes;
constexpr int kStage = 1024;    // log entries staged at a time

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ void rotate(T* __restrict__ pa, T* __restrict__ pb,
                                       T c, T s) {
  const T ua = *pa;
  const T ub = *pb;
  *pa = add(mul(c, ua), mul(s, ub));
  *pb = add(mul(-s, ua), mul(c, ub));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rotation_replay_kernel(const int64_t* __restrict__ rot_a,
                       const int64_t* __restrict__ rot_b,
                       const double* __restrict__ rot_c,
                       const double* __restrict__ rot_s,
                       const int64_t* __restrict__ rot_wave,
                       const int64_t* __restrict__ nrot,
                       const int64_t* __restrict__ nwave, T* y, int m,
                       long long C) {
  __shared__ int s_a[kStage];
  __shared__ int s_b[kStage];
  __shared__ T s_c[kStage];
  __shared__ T s_s[kStage];
  __shared__ int s_count;

  const int b = blockIdx.y;
  const int nr = static_cast<int>(nrot[b]);
  if (nr <= 0) return;
  const int nw = static_cast<int>(nwave[b]);
  const long long log0 = static_cast<long long>(b) * m;
  const int lane = threadIdx.x / kTile;
  const long long col = static_cast<long long>(blockIdx.x) * kTile
                        + threadIdx.x % kTile;
  const bool live = col < C;
  T* yb = y + log0 * C + col;

  for (int w = nw; w >= 1; --w) {
    for (int base = 0; base < nr; base += kStage) {
      if (threadIdx.x == 0) s_count = 0;
      __syncthreads();
      const int end = min(base + kStage, nr);
      for (int i = base + threadIdx.x; i < end; i += kThreads) {
        if (rot_wave[log0 + i] == w) {
          const int slot = atomicAdd(&s_count, 1);
          s_a[slot] = static_cast<int>(rot_a[log0 + i]);
          s_b[slot] = static_cast<int>(rot_b[log0 + i]);
          s_c[slot] = static_cast<T>(rot_c[log0 + i]);
          s_s[slot] = static_cast<T>(rot_s[log0 + i]);
        }
      }
      __syncthreads();
      const int cnt = s_count;
      if (live) {
        int r = lane;
        // two rotations of the wave at a time: their four rows are
        // distinct, so all four loads go out before the first store
        for (; r + kLanes < cnt; r += 2 * kLanes) {
          const int r2 = r + kLanes;
          T* pa1 = yb + static_cast<long long>(s_a[r]) * C;
          T* pb1 = yb + static_cast<long long>(s_b[r]) * C;
          T* pa2 = yb + static_cast<long long>(s_a[r2]) * C;
          T* pb2 = yb + static_cast<long long>(s_b[r2]) * C;
          const T ua1 = *pa1, ub1 = *pb1, ua2 = *pa2, ub2 = *pb2;
          const T c1 = s_c[r], sn1 = s_s[r], c2 = s_c[r2], sn2 = s_s[r2];
          *pa1 = add(mul(c1, ua1), mul(sn1, ub1));
          *pb1 = add(mul(-sn1, ua1), mul(c1, ub1));
          *pa2 = add(mul(c2, ua2), mul(sn2, ub2));
          *pb2 = add(mul(-sn2, ua2), mul(c2, ub2));
        }
        if (r < cnt) {
          rotate(yb + static_cast<long long>(s_a[r]) * C,
                 yb + static_cast<long long>(s_b[r]) * C, s_c[r], s_s[r]);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

// rot_a, rot_b, rot_wave: (k, m) int64; rot_c, rot_s: (k, m) f64; nrot,
// nwave: (k,) int64; y: (k*m, C) contiguous, f32 (is_f32 = 1) or f64, on the
// same device; updated in place.  Returns the launch's cudaError_t.
extern "C" int rotation_replay_launch(const void* rot_a, const void* rot_b,
                                      const void* rot_c, const void* rot_s,
                                      const void* rot_wave, const void* nrot,
                                      const void* nwave, void* y, int is_f32,
                                      int k, int m, long long C,
                                      void* stream) {
  if (k <= 0 || m <= 0 || C <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((C + kTile - 1) / kTile), k);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const int64_t*>(rot_a);
  const auto* bb = static_cast<const int64_t*>(rot_b);
  const auto* c = static_cast<const double*>(rot_c);
  const auto* s = static_cast<const double*>(rot_s);
  const auto* w = static_cast<const int64_t*>(rot_wave);
  const auto* nr = static_cast<const int64_t*>(nrot);
  const auto* nw = static_cast<const int64_t*>(nwave);
  if (is_f32) {
    rotation_replay_kernel<float><<<grid, kThreads, 0, st>>>(
        a, bb, c, s, w, nr, nw, static_cast<float*>(y), m, C);
  } else {
    rotation_replay_kernel<double><<<grid, kThreads, 0, st>>>(
        a, bb, c, s, w, nr, nw, static_cast<double*>(y), m, C);
  }
  return static_cast<int>(cudaGetLastError());
}
