// secular_sums and secular_solve: the secular root finder on the card.
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/secular_sums.py::secular_sums,
// the Pallas kernel behind every iteration of kernels/secular.py::_solve_roots,
// and (secular_solve) the lax.while_loop around it
// (symmetric_eigenvalue_tpu/kernels/secular.py::_solve_roots, `solve_block`).
// For merge b and root i, with dif_ij = (p_bj - shift_bi) - tau_bi and the
// sweep cut at the merge's active count K_b (merge_partition leaves z2 = 0
// past it and the sentinel poles keep every dif finite and nonzero, so a
// skipped term is +-0 and the cut is exact):
//
//   S1 = sum_{j<K_b} z2_bj / dif_ij       S2 = sum_{j<K_b} z2_bj / dif_ij^2
//   S1L, S2L: the same sums restricted to j <= sl_bi
//
// The TPU kernel carries f64 as f32 pairs; Hopper has IEEE f64, so this
// computes the contract directly in f64.
//
// What bounds it on an H100: FP64 arithmetic.  Each (root, pole) pair costs an
// f64 reciprocal (a multi-instruction sequence), two multiplies and the adds
// of one compensated and one plain sum, while device-memory traffic is only
// k*(2m + 5B) doubles.  Design, both kernels:
//  - A block holds 32 roots x 8 pole lanes (256 threads); the 8 lanes of a
//    root are in one warp, each walks every 8th pole of a shared-memory tile
//    (the 8 lanes read 8 neighbouring doubles, the 4 roots of a warp the
//    same ones: no bank conflict), and the lanes are combined by shuffles in
//    a fixed order.  At k=1, B=16384 that is 512 blocks and, at 4 blocks an
//    SM (__launch_bounds__), 32 resident warps an SM.
//  - A pole feeds ONE (compensated, plain) pair of sums: the left one for
//    j <= sl, the right one past it (a lane's poles ascend, so each tile is
//    one loop up to the split and one after it); S1 = S1L + S1R at the end.
//  - Every term comes from one device function, `term`, whose reciprocal is
//    the IEEE one (__drcp_rn), so the kernel's terms are bit for bit those
//    of the plain PyTorch version, and the shift slot's singular term that
//    the iteration takes out of S1 (Ds = 1 + rho (S1 - t1s)) is the one the
//    sweep put in.  S1 and S1L are compensated (TwoSum) sums, S2 and S2L
//    plain; every rounding is written out (__dadd_rn, __dmul_rn), so no FMA
//    contraction changes a term or a sum.
// secular_solve runs the whole safeguarded middle-way / Newton / bisection
// iteration of kernels/secular.py for every root of a level in one launch:
// each block loops until its own 32 roots have converged (or max_iters), as
// the JAX package's per-slot-block while_loop does (a root whose pass leaves
// tau and its bracket unchanged is at a fixed point and counts as done: every
// later pass would repeat it; at some roots no double meets the test, whose
// scale ignores the rounding of the terms' differences), a warp whose roots have
// all converged skips the sweep, and the poles and z2 of a merge stay in
// dynamic shared memory across iterations when they fit (K_b <= the launch's
// capacity), else they stream through it in tiles from L2.  No host sync.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRoots = 32;
constexpr int kLanes = 8;
constexpr int kThreads = kRoots * kLanes;
constexpr int kTile = 256;   // poles per shared-memory tile of secular_sums
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void two_sum_acc(double& s, double& c, double x) {
  const double t = __dadd_rn(s, x);
  const double bp = __dsub_rn(t, s);
  const double err = __dadd_rn(__dsub_rn(s, __dsub_rn(t, bp)), __dsub_rn(x, bp));
  s = t;
  c = __dadd_rn(c, err);
}

// The terms of one (root, pole) pair: t1 = z2 / dif, t2 = t1 / dif, with
// dif = (p - sv) - tv, rounded as the plain version rounds them.
__device__ __forceinline__ void term(double p, double z, double sv, double tv,
                                     double& t1, double& t2) {
  const double dif = __dsub_rn(__dsub_rn(p, sv), tv);
  const double inv = __drcp_rn(dif);
  t1 = __dmul_rn(z, inv);
  t2 = __dmul_rn(t1, inv);
}

struct Sums {
  double s1l, c1l, s1r, c1r, s2l, s2r;
};

__device__ __forceinline__ void zero(Sums& a) {
  a.s1l = a.c1l = a.s1r = a.c1r = a.s2l = a.s2r = 0.0;
}

// This lane's poles of one tile: jj = lane + 8q < len, global index j0 + jj;
// left of the split while j0 + jj <= sl.
__device__ __forceinline__ void sweep(const double* sp, const double* sz, int j0,
                                      int len, int lane, long long sl, double sv,
                                      double tv, Sums& a) {
  int split = 0;   // the lane's first pole right of the split, as a tile index
  const long long lim = sl - j0;
  if (lim >= len) {
    split = len;
  } else if (lim >= 0) {
    split = static_cast<int>(lim) + 1;
  }
  int jj = lane;
  for (; jj < split; jj += kLanes) {
    double t1, t2;
    term(sp[jj], sz[jj], sv, tv, t1, t2);
    two_sum_acc(a.s1l, a.c1l, t1);
    a.s2l = __dadd_rn(a.s2l, t2);
  }
  for (; jj < len; jj += kLanes) {
    double t1, t2;
    term(sp[jj], sz[jj], sv, tv, t1, t2);
    two_sum_acc(a.s1r, a.c1r, t1);
    a.s2r = __dadd_rn(a.s2r, t2);
  }
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

// Combine the 8 lanes of each root (xor butterfly: every lane gets the
// totals); all 32 lanes of the warp must call it.
__device__ __forceinline__ void combine_lanes(Sums& a) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const double s1l = __shfl_xor_sync(kFull, a.s1l, o);
    const double c1l = __shfl_xor_sync(kFull, a.c1l, o);
    const double s1r = __shfl_xor_sync(kFull, a.s1r, o);
    const double c1r = __shfl_xor_sync(kFull, a.c1r, o);
    const double s2l = __shfl_xor_sync(kFull, a.s2l, o);
    const double s2r = __shfl_xor_sync(kFull, a.s2r, o);
    add_pair(a.s1l, a.c1l, s1l, c1l);
    add_pair(a.s1r, a.c1r, s1r, c1r);
    a.s2l = __dadd_rn(a.s2l, s2l);
    a.s2r = __dadd_rn(a.s2r, s2r);
  }
}

// S1, S2, S1L, S2L of combined lanes.
__device__ __forceinline__ void totals(const Sums& a, double& S1, double& S2,
                                       double& S1L, double& S2L) {
  double s = a.s1l, c = a.c1l;
  add_pair(s, c, a.s1r, a.c1r);
  S1 = __dadd_rn(s, c);
  S1L = __dadd_rn(a.s1l, a.c1l);
  S2 = __dadd_rn(a.s2l, a.s2r);
  S2L = a.s2l;
}

__global__ void __launch_bounds__(kThreads, 4)
secular_sums_kernel(const double* __restrict__ poles, const double* __restrict__ z2,
                    const double* __restrict__ shift, const double* __restrict__ tau,
                    const int64_t* __restrict__ sl, const int64_t* __restrict__ K,
                    double* __restrict__ out, int k, int m, int B) {
  __shared__ double sp[kTile];
  __shared__ double sz[kTile];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kRoots + threadIdx.x / kLanes;
  const bool live = i < B;
  const size_t ib = (size_t)b * B + (live ? i : 0);
  const double sv = live ? shift[ib] : 0.0;
  const double tv = live ? tau[ib] : 0.0;
  const long long sli = live ? sl[ib] : -1;
  const int Kb = static_cast<int>(min(max((long long)K[b], 0LL), (long long)m));
  const double* pb = poles + (size_t)b * m;
  const double* zb = z2 + (size_t)b * m;

  Sums a;
  zero(a);
  for (int j0 = 0; j0 < Kb; j0 += kTile) {
    const int len = min(kTile, Kb - j0);
    __syncthreads();
    if (threadIdx.x < len) {
      sp[threadIdx.x] = pb[j0 + threadIdx.x];
      sz[threadIdx.x] = zb[j0 + threadIdx.x];
    }
    __syncthreads();
    if (live) sweep(sp, sz, j0, len, lane, sli, sv, tv, a);
  }
  combine_lanes(a);
  if (live && lane == 0) {
    double S1, S2, S1L, S2L;
    totals(a, S1, S2, S1L, S2L);
    const size_t plane = (size_t)k * B;
    out[ib] = S1;
    out[plane + ib] = S2;
    out[2 * plane + ib] = S1L;
    out[3 * plane + ib] = S2L;
  }
}

// min / max that return NaN when either operand is NaN (torch.minimum,
// torch.maximum), not the other operand (fmin, fmax).
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a != a || b != b) ? __dadd_rn(a, b) : fmin(a, b);
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || b != b) ? __dadd_rn(a, b) : fmax(a, b);
}

// One root's state in the iteration (every lane of the root holds a copy
// and computes the same update).
struct Root {
  double tau, lo, hi, sv, zs2, dlo, dhi;
  int it;
  bool done;
};

// One step of kernels/secular.py's iteration from the root's sums, each
// operation in the plain version's order and rounding.
__device__ __forceinline__ void step(Root& r, double rho, double tolf, double S1,
                                     double S2, double S1L, double S2L) {
  const double tau = r.tau;
  double t1s, t2s;
  term(r.sv, r.zs2, r.sv, tau, t1s, t2s);   // the shift slot: dif = -tau
  const double psi = __dmul_rn(rho, S1L);
  const double psi1 = __dmul_rn(rho, S2L);
  const double phi = __dsub_rn(__dmul_rn(rho, S1), psi);
  const double phi1 = __dsub_rn(__dmul_rn(rho, S2), psi1);
  const double f = __dadd_rn(__dadd_rn(1.0, psi), phi);
  const double S1o = __dsub_rn(S1, t1s);
  const double Ds = __dadd_rn(1.0, __dmul_rn(rho, S1o));
  const double rz = __dmul_rn(rho, r.zs2);
  const double h = __dsub_rn(__dmul_rn(tau, Ds), rz);
  const double scale_h = __dadd_rn(
      __dmul_rn(fabs(tau), __dadd_rn(1.0, __dmul_rn(fabs(rho), fabs(S1o)))), rz);
  const bool done_now = fabs(h) <= __dmul_rn(tolf, scale_h);
  const bool f_pos = (h > 0.0) != (tau < 0.0);
  const double hi = f_pos ? nan_min(r.hi, tau) : r.hi;
  const double lo = f_pos ? r.lo : nan_max(r.lo, tau);
  const bool same_bracket = lo == r.lo && hi == r.hi;
  r.lo = lo;
  r.hi = hi;
  const double Dlo = __dsub_rn(r.dlo, tau);
  const double Dhi = __dsub_rn(r.dhi, tau);
  const double c1 = __dmul_rn(__dmul_rn(psi1, Dlo), Dlo);
  const double c2 = __dmul_rn(__dmul_rn(phi1, Dhi), Dhi);
  const double c3 = __dsub_rn(__dsub_rn(f, __dmul_rn(Dlo, psi1)), __dmul_rn(Dhi, phi1));
  const double a = c3;
  const double bq = __dadd_rn(__dadd_rn(__dmul_rn(c3, __dadd_rn(Dlo, Dhi)), c1), c2);
  const double c = __dmul_rn(__dmul_rn(f, Dlo), Dhi);
  double disc = __dsub_rn(__dmul_rn(bq, bq), __dmul_rn(__dmul_rn(4.0, a), c));
  disc = disc < 0.0 ? 0.0 : disc;   // clamp(min=0) keeps a NaN
  const double sq = __dsqrt_rn(disc);
  const double q = __dmul_rn(0.5, __dadd_rn(bq, bq >= 0.0 ? sq : -sq));
  const double big = 1e30;
  const double e1 = a != 0.0 ? __ddiv_rn(q, a) : big;
  const double e2 = q != 0.0 ? __ddiv_rn(c, q) : big;
  const double cand1 = __dadd_rn(tau, e1);
  const double cand2 = __dadd_rn(tau, e2);
  const bool in1 = (cand1 > lo) && (cand1 < hi);
  const bool in2 = (cand2 > lo) && (cand2 < hi);
  const bool pick1 = in1 && (!in2 || fabs(e1) <= fabs(e2));
  const double t_quad = pick1 ? cand1 : cand2;
  const bool ok_quad = (in1 || in2) && isfinite(t_quad);
  const double hp = __dadd_rn(Ds, __dmul_rn(__dmul_rn(tau, rho), __dsub_rn(S2, t2s)));
  const double t_newton = __dsub_rn(tau, __ddiv_rn(h, hp != 0.0 ? hp : 1.0));
  const bool in_n = (t_newton > lo) && (t_newton < hi);
  const double t_next =
      ok_quad ? t_quad : (in_n ? t_newton : __dmul_rn(0.5, __dadd_rn(lo, hi)));
  // a pass that leaves (tau, lo, hi) unchanged is a fixed point: every later
  // pass repeats it, so the root already holds the tau of max_iters passes
  const bool fixed = t_next == tau && same_bracket;
  r.it += 1;
  if (done_now || fixed) {
    r.done = true;
  } else {
    r.tau = t_next;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
secular_solve_kernel(const double* __restrict__ poles, const double* __restrict__ z2,
                     const double* __restrict__ rho_e, const int64_t* __restrict__ K,
                     const double* __restrict__ shift, const double* __restrict__ zs2,
                     const double* __restrict__ lo0, const double* __restrict__ hi0,
                     const double* __restrict__ tau0, const double* __restrict__ dlo,
                     const double* __restrict__ dhi, const uint8_t* __restrict__ done0,
                     double tolf, int max_iters, double* __restrict__ tau_out,
                     int* __restrict__ iters_out, int m, int cap) {
  extern __shared__ double smem[];
  double* sp = smem;
  double* sz = smem + cap;

  const int b = blockIdx.y;
  const int lane = threadIdx.x % kLanes;
  const int i = blockIdx.x * kRoots + threadIdx.x / kLanes;
  const bool live = i < m;
  const size_t ib = (size_t)b * m + (live ? i : 0);
  const int Kb = static_cast<int>(min(max((long long)K[b], 0LL), (long long)m));
  const double rho = rho_e[b];
  const double* pb = poles + (size_t)b * m;
  const double* zb = z2 + (size_t)b * m;

  Root r;
  r.tau = live ? tau0[ib] : 0.0;
  r.lo = live ? lo0[ib] : 0.0;
  r.hi = live ? hi0[ib] : 0.0;
  r.sv = live ? shift[ib] : 0.0;
  r.zs2 = live ? zs2[ib] : 0.0;
  r.dlo = live ? dlo[ib] : 0.0;
  r.dhi = live ? dhi[ib] : 0.0;
  r.it = 0;
  r.done = !live || done0[ib] != 0;

  const bool resident = Kb <= cap;
  if (resident) {
    for (int j = threadIdx.x; j < Kb; j += kThreads) {
      sp[j] = pb[j];
      sz[j] = zb[j];
    }
  }
  for (int iter = 0; iter < max_iters; ++iter) {
    // every thread takes part (the syncs): the block leaves together when
    // all its roots are done
    if (__syncthreads_and(r.done)) break;
    const bool warp_busy = __any_sync(kFull, !r.done);
    Sums a;
    zero(a);
    if (resident) {
      if (warp_busy && !r.done) sweep(sp, sz, 0, Kb, lane, i, r.sv, r.tau, a);
    } else {
      for (int j0 = 0; j0 < Kb; j0 += cap) {
        const int len = min(cap, Kb - j0);
        __syncthreads();
        for (int j = threadIdx.x; j < len; j += kThreads) {
          sp[j] = pb[j0 + j];
          sz[j] = zb[j0 + j];
        }
        __syncthreads();
        if (warp_busy && !r.done) sweep(sp, sz, j0, len, lane, i, r.sv, r.tau, a);
      }
    }
    if (warp_busy) {
      combine_lanes(a);
      if (!r.done) {
        double S1, S2, S1L, S2L;
        totals(a, S1, S2, S1L, S2L);
        step(r, rho, tolf, S1, S2, S1L, S2L);
      }
    }
  }
  if (live && lane == 0) {
    tau_out[ib] = r.tau;
    iters_out[ib] = r.it;
  }
}

// One (root, pole) term exactly as `sweep` adds it to one side's sums (never
// launched: the FP64 instructions in its SASS are the yardstick of a term for
// the sweeps' bound).  Every input is loaded and every sum stored.
__global__ void secular_sums_term_yardstick(const double* __restrict__ in,
                                            double* __restrict__ io) {
  double t1, t2;
  term(in[0], in[1], in[2], in[3], t1, t2);
  double s = io[0], c = io[1];
  two_sum_acc(s, c, t1);
  io[0] = s;
  io[1] = c;
  io[2] = __dadd_rn(io[2], t2);
}

}  // namespace

// Keeps the yardstick kernel in the library (its SASS is read, never run).
extern "C" void* secular_sums_term_yardsticks() {
  return reinterpret_cast<void*>(&secular_sums_term_yardstick);
}

// poles, z2: (k, m) f64; shift, tau: (k, B) f64; sl: (k, B) int64; K: (k,)
// int64; out: (4, k, B) f64 = S1, S2, S1L, S2L.  All contiguous on one
// device.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int secular_sums_launch(const void* poles, const void* z2,
                                   const void* shift, const void* tau,
                                   const void* sl, const void* K, void* out,
                                   int k, int m, int B, void* stream) {
  if (k <= 0 || B <= 0) return 0;
  const dim3 grid((B + kRoots - 1) / kRoots, k);
  secular_sums_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(poles), static_cast<const double*>(z2),
      static_cast<const double*>(shift), static_cast<const double*>(tau),
      static_cast<const int64_t*>(sl), static_cast<const int64_t*>(K),
      static_cast<double*>(out), k, m, B);
  return static_cast<int>(cudaGetLastError());
}

// poles, z2, shift, zs2, lo, hi, tau0, dlo, dhi: (k, m) f64; rho: (k,) f64;
// K: (k,) int64; done0: (k, m) uint8 (bool); tau_out: (k, m) f64; iters:
// (k, m) int32.  All contiguous on one device.  `cap` poles (and as many
// z2) are held in 16 * cap bytes of dynamic shared memory (cap <= 3072: no
// opt-in needed).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int secular_solve_launch(const void* poles, const void* z2,
                                    const void* rho, const void* K,
                                    const void* shift, const void* zs2,
                                    const void* lo, const void* hi,
                                    const void* tau0, const void* dlo,
                                    const void* dhi, const void* done0,
                                    double tolf, int max_iters, void* tau_out,
                                    void* iters, int k, int m, int cap,
                                    void* stream) {
  if (k <= 0 || m <= 0) return 0;
  if (cap <= 0 || cap > 3072) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kRoots - 1) / kRoots, k);
  const size_t shmem = 2 * sizeof(double) * (size_t)cap;
  secular_solve_kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(poles), static_cast<const double*>(z2),
      static_cast<const double*>(rho), static_cast<const int64_t*>(K),
      static_cast<const double*>(shift), static_cast<const double*>(zs2),
      static_cast<const double*>(lo), static_cast<const double*>(hi),
      static_cast<const double*>(tau0), static_cast<const double*>(dlo),
      static_cast<const double*>(dhi), static_cast<const uint8_t*>(done0), tolf,
      max_iters, static_cast<double*>(tau_out), static_cast<int*>(iters), m, cap);
  return static_cast<int>(cudaGetLastError());
}
