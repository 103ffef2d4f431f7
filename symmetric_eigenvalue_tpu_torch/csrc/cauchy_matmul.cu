// cauchy_matmul / cauchy_materialize: the mixed-precision downsweep's Cauchy
// products, with U generated on the fly and never stored.
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/cauchy_matmul.py::cauchy_matmul
// (_kernel, every non-root level of the f32 downsweep, called from
// kernels/assemble.py::_apply_u_matmul) and ::cauchy_materialize (_mat_kernel,
// the root U of the same sweep, called from kernels/assemble.py::assemble_u).
//
//   M[b, j, i] = f32( (zhat_bj / ((p_bj - sv_bi) - tau_bi)) * ninv_bi )
//   cauchy_matmul:      Y[b] = M[b][:, :K_b] @ X[b][:K_b, :]      (f32 out)
//   cauchy_materialize: U[b, j, c] = M-entry for column slot s_c < K_b,
//                       else [j == s_c] (the deflated column e_slot, exact)
//
// The TPU kernels carry the f64 pole differences as f32 pairs; Hopper has
// IEEE f64, so every entry is computed in f64 (__dsub_rn / __ddiv_rn /
// __dmul_rn: no FMA contraction) and rounded to f32 once, bit-identical to
// the plain PyTorch versions' entries.
//
// What bounds them on an H100.  cauchy_matmul: FP32 operations, 2*K_b*m*C per
// merge (a GEMM at high arithmetic intensity) plus one f64 division per M
// entry.  Design: one block per (merge, 128-row tile, 128-column tile), 256
// threads with an 8x8 register block each (two 4-row and two 4-column
// groups, so every shared-memory read is a conflict-free float4).  The
// contraction runs over slot tiles of 16, only up to the merge's own K_b,
// read on the device (the deflation skip: no host sync, tiles past K_b are
// never generated nor multiplied).  Each slot tile's 128x16 M block is built
// in shared memory in f64 and rounded to f32, the 16x128 X block is staged
// beside it, and the threads accumulate with f32 FFMA (at most 128 registers,
// two blocks per SM).  Every 512 slots the
// register sums are added into Y (stored on the first chunk), so no f32 sum
// runs longer than 512 terms, as in the plain version's slot blocks.  Slots
// >= K_b inside the last tile are written as exact zeros (never
// 0 * ncolinv, which could be 0 * inf), so the result equals the product
// over all m slots wherever that product is finite.  No tensor cores and no
// copy pipeline yet: its time beside its bound is in PERF.md.
// cauchy_materialize: the 4*m*C bytes it writes; one thread per output
// entry, consecutive threads on consecutive columns (coalesced stores).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TJ = 128;   // output rows per block
constexpr int TC = 128;   // output columns per block
constexpr int TI = 16;    // contraction slots per step
constexpr int CHUNK = 512;  // contraction slots per f32 register sum
constexpr int kThreads = 256;
static_assert((TJ * TI) % kThreads == 0 && (TI * TC) % kThreads == 0, "tiles");
static_assert(CHUNK % TI == 0, "chunk");

__device__ __forceinline__ float cauchy_entry(double p, double sv, double tau,
                                              double z, double ninv) {
  const double den = __dsub_rn(__dsub_rn(p, sv), tau);
  return __double2float_rn(__dmul_rn(__ddiv_rn(z, den), ninv));
}

// Y[j, c0..c0+3] (+)= v, masked at the ragged column edge
__device__ __forceinline__ void put4(float* Yrow, int c0, int C, bool vec, bool add,
                                     const float* v) {
  if (vec && c0 + 3 < C) {
    float4* q = reinterpret_cast<float4*>(Yrow + c0);
    float4 o = add ? *q : make_float4(0.f, 0.f, 0.f, 0.f);
    o.x += v[0]; o.y += v[1]; o.z += v[2]; o.w += v[3];
    *q = o;
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (c0 + t < C) Yrow[c0 + t] = add ? Yrow[c0 + t] + v[t] : v[t];
}

__global__ void __launch_bounds__(kThreads, 2)
cauchy_matmul_kernel(const double* __restrict__ poles, const double* __restrict__ shift,
                     const double* __restrict__ tau, const double* __restrict__ zhat,
                     const double* __restrict__ ninv, const float* __restrict__ X,
                     const int64_t* __restrict__ Kact, float* __restrict__ Y,
                     int m, int C) {
  __shared__ __align__(16) float Ms[TI][TJ];
  __shared__ __align__(16) float Xs[TI][TC];

  const size_t b = blockIdx.z;
  const int j0 = blockIdx.y * TJ;
  const int c0 = blockIdx.x * TC;
  const double* pb = poles + b * m;
  const double* sb = shift + b * m;
  const double* tb = tau + b * m;
  const double* zb = zhat + b * m;
  const double* nb = ninv + b * m;
  const float* Xb = X + b * (size_t)m * C;
  float* Yb = Y + b * (size_t)m * C;
  const int64_t kb = Kact[b];
  const int kend = kb < 0 ? 0 : (kb > m ? m : (int)kb);
  const bool vec = (C % 4) == 0;

  const int tx = threadIdx.x % 16;    // columns tx*4 + {0..3}, 64 + tx*4 + {0..3}
  const int ty = threadIdx.x / 16;    // rows    ty*4 + {0..3}, 64 + ty*4 + {0..3}

  float acc[8][8];
  bool stored = false;
  int i0 = 0;
  do {   // one contraction chunk (also runs once when kend == 0: Y = 0)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    const int i1 = min(kend, i0 + CHUNK);
    for (int it = i0; it < i1; it += TI) {
#pragma unroll 1   // unrolled, the f64 divisions took 233 registers
      for (int l = 0; l < (TJ * TI) / kThreads; ++l) {
        const int idx = threadIdx.x + kThreads * l;
        const int ii = idx / TJ, jj = idx % TJ;
        const int j = j0 + jj, i = it + ii;
        Ms[ii][jj] = (j < m && i < kend)
                         ? cauchy_entry(pb[j], sb[i], tb[i], zb[j], nb[i])
                         : 0.0f;
      }
#pragma unroll
      for (int l = 0; l < (TI * TC) / kThreads; ++l) {
        const int idx = threadIdx.x + kThreads * l;
        const int ii = idx / TC, cc = idx % TC;
        const int i = it + ii, c = c0 + cc;
        Xs[ii][cc] = (i < kend && c < C) ? Xb[(size_t)i * C + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int ii = 0; ii < TI; ++ii) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Ms[ii][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Ms[ii][64 + ty * 4]);
        const float4 x0 = *reinterpret_cast<const float4*>(&Xs[ii][tx * 4]);
        const float4 x1 = *reinterpret_cast<const float4*>(&Xs[ii][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], x[c], acc[r][c]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = j0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4);
      if (j >= m) continue;
      float* Yrow = Yb + (size_t)j * C;
      put4(Yrow, c0 + tx * 4, C, vec, stored, &acc[r][0]);
      put4(Yrow, c0 + 64 + tx * 4, C, vec, stored, &acc[r][4]);
    }
    stored = true;
    i0 = i1;
  } while (i0 < kend);
}

constexpr int kMatThreads = 256;
constexpr int kMatRows = 8;   // output rows per block (one column per thread)

__global__ void __launch_bounds__(kMatThreads)
cauchy_materialize_kernel(const double* __restrict__ poles, const double* __restrict__ zhat,
                          const double* __restrict__ shift, const double* __restrict__ tau,
                          const double* __restrict__ ninv, const int64_t* __restrict__ slots,
                          const int64_t* __restrict__ Kact, float* __restrict__ U,
                          int m, int C) {
  const size_t b = blockIdx.z;
  const int c = blockIdx.x * kMatThreads + threadIdx.x;
  if (c >= C) return;
  const size_t bc = b * C + c;
  const int64_t slot = slots[bc];
  const bool active = slot < Kact[b];
  const double sv = shift[bc], tv = tau[bc], nv = ninv[bc];
  const int j0 = blockIdx.y * kMatRows;
  const int j1 = min(m, j0 + kMatRows);
  for (int j = j0; j < j1; ++j) {
    const float u = active ? cauchy_entry(poles[b * m + j], sv, tv, zhat[b * m + j], nv)
                           : (slot == j ? 1.0f : 0.0f);
    U[(b * m + j) * (size_t)C + c] = u;
  }
}

}  // namespace

// poles, shift, tau, zhat, ninv: (k, m) f64; X: (k, m, C) f32; K: (k,) int64;
// Y: (k, m, C) f32.  All contiguous on one device.  Launches on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int cauchy_matmul_launch(const void* poles, const void* shift,
                                    const void* tau, const void* zhat,
                                    const void* ninv, const void* X,
                                    const void* K, void* Y, int k, int m,
                                    int C, void* stream) {
  if (k <= 0 || m <= 0 || C <= 0) return 0;
  const dim3 grid((C + TC - 1) / TC, (m + TJ - 1) / TJ, k);
  cauchy_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(poles), static_cast<const double*>(shift),
      static_cast<const double*>(tau), static_cast<const double*>(zhat),
      static_cast<const double*>(ninv), static_cast<const float*>(X),
      static_cast<const int64_t*>(K), static_cast<float*>(Y), m, C);
  return static_cast<int>(cudaGetLastError());
}

// poles, zhat: (k, m) f64; shift, tau, ninv: (k, C) f64; slots: (k, C) int64;
// K: (k,) int64; U: (k, m, C) f32.  Same conventions as above.
extern "C" int cauchy_materialize_launch(const void* poles, const void* zhat,
                                         const void* shift, const void* tau,
                                         const void* ninv, const void* slots,
                                         const void* K, void* U, int k, int m,
                                         int C, void* stream) {
  if (k <= 0 || m <= 0 || C <= 0) return 0;
  const dim3 grid((C + kMatThreads - 1) / kMatThreads,
                  (m + kMatRows - 1) / kMatRows, k);
  cauchy_materialize_kernel<<<grid, kMatThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(poles), static_cast<const double*>(zhat),
      static_cast<const double*>(shift), static_cast<const double*>(tau),
      static_cast<const double*>(ninv), static_cast<const int64_t*>(slots),
      static_cast<const int64_t*>(K), static_cast<float*>(U), m, C);
  return static_cast<int>(cudaGetLastError());
}
