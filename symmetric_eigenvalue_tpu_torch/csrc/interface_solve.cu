// interface_solve: the Spike interface system, a 2x2 block-tridiagonal solve
// over the P row blocks of a partitioned shifted-tridiagonal solve, one
// column per eigenpair.
//
// Replaces the two lax.scan loops of
// symmetric_eigenvalue_tpu/kernels/refine.py::interface_solve (the forward
// sweep and the back sweep over the blocks), which the JAX package runs
// inside its jitted refinement passes; the plain version runs them as a
// Python loop of about 36 small launches a block.  Inputs are each block's boundary
// responses (P, K): p* and q* the unit-load responses at the block's first
// and last row, scaled by the couplers, u* the right-hand side's.  For every
// column, with G_{-1} = 0 and h_{-1} = 0:
//
//   forward, b = 0 .. P-1:  d11 = 1 - pf g21;  det = d11 floored at +-2^-96;
//     i11 = 1/det, i21 = (pl g21)/det, i22 = d11/det;
//     r1 = uf - pf h2, r2 = ul - pl h2;
//     H1 = i11 r1, h2 = H2 = i21 r1 + i22 r2;
//     G11 = i11 qf, g21 = G21 = i21 qf + i22 ql;
//   back, b = P-1 .. 0:  F_b = H1_b - G11_b F_{b+1},  L_b = H2_b - G21_b F_{b+1}.
//
// Every operation is a correctly rounded __dadd_rn / __dsub_rn / __dmul_rn /
// __ddiv_rn in the plain loop's order (kernels/shifted_solve.py::
// interface_solve_plain; no FMA contraction), so the kernel is its plain
// version bit for bit.
//
// Design: one thread a column, both sweeps in the same thread, the carry
// (g21, h2) and F_{b+1} in registers; consecutive threads take consecutive
// columns, so every copy of a block row is coalesced.  What bounded the
// one-ahead loads of the old kernel (tools/kernel_phase_probe.py, H100): a
// forward step waited 0.41 us on its row's loads against a 0.20 us chain
// at K = 16384, and every back step 0.42 us; at the triage's K = 5 each
// step waited likewise with one warp on the card.  So a step's inputs come
// from shared memory: where every row of the block of threads' columns
// fits (the triage's small K), all six inputs are copied in at once
// (cp.async) and every forward value stays there for the back sweep; else
// each thread fills a ring of kRing rows kAhead rows ahead of its sweep
// (its own column's copies: no barrier), the forward values (H1, H2, G11,
// G21) of the last ps rows stay in shared memory and the rest go to F's
// and L's slots and a (P - ps) K scratch (kept in L2 ahead of the inputs,
// which are copied evict-first), copied back into the ring's two halves in
// batches of kBack rows two batches ahead of the back sweep.  The plan
// (columns a block of threads, ps, whole or ring;
// kernels/shifted_solve.py::interface_plan) keeps every block of threads
// resident at once.  What bounds it then: at the Spike pass's P = 128, K =
// 16384 the inputs' and outputs' bytes and the scratch round trip of the
// rows past ps; at the triage's K = 5 the chain of 2 P dependent steps (a
// forward step's divisions: d11 / det is 1 exactly, and skipped, unless
// the floor was taken).
// The optional scales (the Spike pass's ec_above on pf, pl and e_cross on
// qf, ql) are applied at use, one product each, as the plain version's
// multiplication does.  ``shifted`` writes the neighbour values the passes
// read, F_below[b] = F[b+1] and L_above[b] = L[b-1] (0 at the ends),
// instead of F and L.  No host fetch and no synchronising call: a CUDA
// graph can hold the launch.
//
// Least time: the bytes of six (P, K) inputs read and two written (8 P K
// doubles).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // a block of threads: up to 64 columns
constexpr int kAhead = 6;      // ring mode: rows copied ahead of the sweep (8 and 4 ran slower)
constexpr int kRing = kAhead + 1;   // the ring's rows (a slot is refilled a step after its read)
constexpr int kBack = kRing * 6 / 8;   // back sweep: rows of each half of the ring (4 values a row)
constexpr double kTiny2 = 0x1p-96;

// Phase probes, compiled only where KERNEL_PROBES is defined
// (tools/kernel_phase_probe.py): column 0's clock64 cycles in the forward
// sweep's waits with d11, its chain, its stores, and the back sweep.
#ifdef KERNEL_PROBES
__device__ long long g_if[8];
#define IF_PROBE_START long long iacc_[4] = {0, 0, 0, 0}; long long iprev_ = clock64()
#define IF_PROBE(i) do { if (i_col == 0) { const long long now_ = clock64(); \
    iacc_[i] += now_ - iprev_; iprev_ = now_; } } while (0)
#define IF_PROBE_STORE do { if (i_col == 0) { \
    for (int k_ = 0; k_ < 4; ++k_) g_if[k_] = iacc_[k_]; g_if[4] = P; } } while (0)
#else
#define IF_PROBE_START do {} while (0)
#define IF_PROBE(i) do {} while (0)
#define IF_PROBE_STORE do {} while (0)
#endif

struct Row {      // a block's forward-sweep inputs
  double pf, pl, qf, ql, uf, ul;
};

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
// The same copy, marked evict-first in L2 (an input read once): L2 keeps
// the forward values the back sweep reads again instead.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void cp_async8_once(double* smem, const double* gmem,
                                               uint64_t policy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 8, %2;\n"
               ::"r"(dst), "l"(gmem), "l"(policy));
}
// A forward value the back sweep reads again: kept in L2 ahead of the rest.
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void store_kept(double* gmem, double v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f64 [%0], %1, %2;\n" ::"l"(gmem), "d"(v), "l"(policy)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const double* in[6];   // pf, pl, qf, ql, uf, ul: (P, K), row stride ld
  long long ld;
  const double* sp;      // (P,) scales of pf, pl, or null
  const double* sq;      // (P,) scales of qf, ql, or null
  int P, K, shifted;
  int nc;                // columns a block of threads
  int ps;                // last rows whose forward values stay in shared memory
  double* Fo;
  double* Lo;
  double* G11;           // (P - ps, K) scratch
  double* G21;
};

// kWhole: every input row in shared memory (copied in one go by the whole
// block of threads, then ps = P); else a ring of kRing rows, each thread
// copying its own column kAhead rows ahead.
template <bool kWhole>
__global__ void __launch_bounds__(kThreads) interface_kernel(const Args a) {
  extern __shared__ double sh[];
  const int P = a.P, K = a.K, NC = a.nc, col = threadIdx.x;
  const int c0 = blockIdx.x * NC, i = c0 + col;
  const bool live = col < NC && i < K;
  const int i_col = live ? i : -1;
  (void)i_col;
  double* ss = sh;                             // sp then sq, 2 P
  double* ring = ss + 2 * P;                   // (kWhole ? P : kRing) x 6 x NC
  double* fw = ring + (size_t)(kWhole ? P : kRing) * 6 * NC;   // ps x 4 x NC
  const int nb = P - a.ps;                     // rows whose values go to global memory
  const uint64_t once = evict_first(), kept = evict_last();
  for (int b = threadIdx.x; b < P; b += blockDim.x) {
    ss[b] = a.sp != nullptr ? a.sp[b] : 1.0;
    ss[P + b] = a.sq != nullptr ? a.sq[b] : 1.0;
  }
  // this thread's column of the six inputs at the next row to copy
  const double* src[6];
  for (int x = 0; x < 6; ++x) src[x] = a.in[x] + i;
  auto copy_row = [&](int slot) {
    for (int x = 0; x < 6; ++x) {
      cp_async8_once(ring + ((size_t)slot * 6 + x) * NC + col, src[x], once);
      src[x] += a.ld;
    }
  };
  if (kWhole) {
    const int cols = min(NC, K - c0);
    for (int e = threadIdx.x; e < 6 * P * cols; e += blockDim.x) {
      const int c = e % cols, rest = e / cols, x = rest % 6, b = rest / 6;
      cp_async8_once(ring + ((size_t)b * 6 + x) * NC + c, a.in[x] + b * a.ld + c0 + c, once);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    cp_wait<0>();
  } else {
    for (int j = 0; j < kAhead; ++j) {
      if (live && j < P) copy_row(j);
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }
  __syncthreads();
  if (!live) return;
  IF_PROBE_START;
  // the storage slot of F_b and of L_b (H1_b and H2_b between the sweeps,
  // for b < nb): shifted by a block, the first F and the last L wrapped
  auto fslot = [&](int b) -> int64_t {
    return (int64_t)(a.shifted ? (b == 0 ? P - 1 : b - 1) : b) * K + i;
  };
  auto lslot = [&](int b) -> int64_t {
    return (int64_t)(a.shifted ? (b == P - 1 ? 0 : b + 1) : b) * K + i;
  };

  // a row's inputs from shared memory, its couplers applied (a missing
  // coupler is a stored 1.0, and x * 1.0 is x: no branch, so the reads
  // and products of the next row interleave with this row's chain)
  auto read_row = [&](int b, int at) {
    const double* r = ring + (size_t)at * 6 * NC + col;
    const double s = ss[b], q = ss[P + b];
    return Row{__dmul_rn(r[0], s), __dmul_rn(r[NC], s), __dmul_rn(r[2 * NC], q),
               __dmul_rn(r[3 * NC], q), r[4 * NC], r[5 * NC]};
  };
  double g21 = 0.0, h2 = 0.0;
  int slot = 0;                                 // ring mode: row b's slot
  if (!kWhole) cp_wait<kAhead - 1>();           // row 0's copies have landed
  Row nxt = read_row(0, 0);
  for (int b = 0; b < P; ++b) {
    const Row cur = nxt;
    if (!kWhole) {
      // row b + kAhead into the slot row b - 1 held, then row b + 1 read
      int next = slot + kAhead;
      next -= next >= kRing ? kRing : 0;
      if (b + kAhead < P) copy_row(next);
      asm volatile("cp.async.commit_group;\n" ::);
      slot = slot + 1 == kRing ? 0 : slot + 1;
      cp_wait<kAhead - 1>();                    // row b + 1's copies have landed
    }
    nxt = read_row(min(b + 1, P - 1), kWhole ? min(b + 1, P - 1) : slot);   // unused past P
    // D_b = I - Lo_b G_{b-1} = [[1 - pf g21, 0], [-pl g21, 1]]
    const double d11 = __dsub_rn(1.0, __dmul_rn(cur.pf, g21));
    IF_PROBE(0);
    const double det = fabs(d11) < kTiny2 ? (d11 < 0.0 ? -kTiny2 : kTiny2) : d11;
    const double i11 = __ddiv_rn(1.0, det);
    const double i21 = __ddiv_rn(__dmul_rn(cur.pl, g21), det);
    // d11 / d11 = 1 exactly for a finite nonzero d11: the division only
    // where the floor was taken or d11 is not finite
    const double i22 = det == d11 && fabs(d11) <= 0x1.fffffffffffffp+1023 ? 1.0
                                                                          : __ddiv_rn(d11, det);
    const double r1 = __dsub_rn(cur.uf, __dmul_rn(cur.pf, h2));
    const double r2 = __dsub_rn(cur.ul, __dmul_rn(cur.pl, h2));
    const double h1 = __dmul_rn(i11, r1);
    h2 = __dadd_rn(__dmul_rn(i21, r1), __dmul_rn(i22, r2));
    const double g11 = __dmul_rn(i11, cur.qf);
    g21 = __dadd_rn(__dmul_rn(i21, cur.qf), __dmul_rn(i22, cur.ql));
    IF_PROBE(1);
    if (b >= nb) {
      double* f = fw + (size_t)(b - nb) * 4 * NC + col;
      f[0] = h1;
      f[NC] = h2;
      f[2 * NC] = g11;
      f[3 * NC] = g21;
    } else {
      const int64_t at = (int64_t)b * K + i;
      store_kept(a.Fo + fslot(b), h1, kept);
      store_kept(a.Lo + lslot(b), h2, kept);
      store_kept(a.G11 + at, g11, kept);
      store_kept(a.G21 + at, g21, kept);
    }
    IF_PROBE(2);
  }

  // the back sweep: rows P - 1 .. nb from shared memory, then rows nb - 1
  // .. 0 (this thread's own stores above) in batches of kBack rows, copied
  // into the ring's two halves two batches ahead (the first two while the
  // shared rows run); each row's four values read a row ahead
  auto copy_back = [&](int batch) {
    double* half = ring + (size_t)(batch & 1) * kBack * 4 * NC + col;
    for (int u = 0; u < kBack; ++u) {
      const int b = nb - 1 - batch * kBack - u;
      if (b < 0) break;
      double* d = half + (size_t)u * 4 * NC;
      cp_async8(d, a.Fo + fslot(b));
      cp_async8(d + NC, a.Lo + lslot(b));
      cp_async8(d + 2 * NC, a.G11 + (int64_t)b * K + i);
      cp_async8(d + 3 * NC, a.G21 + (int64_t)b * K + i);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (!kWhole && nb > 0) {
    __threadfence_block();
    copy_back(0);
    copy_back(1);
  }
  struct Fwd {
    double h1, h2, g11, g21;
  };
  auto read_fwd = [&](const double* f) { return Fwd{f[0], f[NC], f[2 * NC], f[3 * NC]}; };
  double f_next = 0.0;
  auto back = [&](int b, const Fwd& v) {
    const double F = __dsub_rn(v.h1, __dmul_rn(v.g11, f_next));
    const double L = __dsub_rn(v.h2, __dmul_rn(v.g21, f_next));
    // shifted: F_0 and L_{P-1} have no neighbour slot; their slots hold
    // F_below[P-1] = 0 and L_above[0] = 0
    a.Fo[fslot(b)] = a.shifted && b == 0 ? 0.0 : F;
    a.Lo[lslot(b)] = a.shifted && b == P - 1 ? 0.0 : L;
    f_next = F;
  };
  if (P - 1 >= nb) {
    Fwd v = read_fwd(fw + (size_t)(P - 1 - nb) * 4 * NC + col);
    for (int b = P - 1; b >= nb; --b) {
      const Fwd cur = v;
      v = read_fwd(fw + (size_t)(max(b - 1, nb) - nb) * 4 * NC + col);   // unused past nb
      back(b, cur);
    }
  }
  for (int batch = 0; batch * kBack < nb; ++batch) {
    cp_wait<1>();                               // this batch's copies have landed
    const double* half = ring + (size_t)(batch & 1) * kBack * 4 * NC + col;
    const int rows = min(kBack, nb - batch * kBack);
    Fwd v = read_fwd(half);
    for (int u = 0; u < rows; ++u) {
      const Fwd cur = v;
      v = read_fwd(half + (size_t)min(u + 1, rows - 1) * 4 * NC);   // unused past rows
      back(nb - 1 - batch * kBack - u, cur);
    }
    copy_back(batch + 2);                       // into the half just read
  }
  IF_PROBE(3);
  IF_PROBE_STORE;
}

// One block of one column (never launched): the forward step with the
// Spike pass's scaling and the back step.  in[0..9] = pf, pl, qf, ql, uf, ul,
// sp, sq, g21, h2 a thread; every result is stored.  The FP64 instructions
// in its SASS are the yardstick of a (block, column) pair's work for the
// kernel's bound.
__global__ void interface_step_yardstick(const double* __restrict__ in,
                                         double* __restrict__ out) {
  const double* w = in + 10 * threadIdx.x;
  double* o = out + 6 * threadIdx.x;
  const double pf = __dmul_rn(w[0], w[6]), pl = __dmul_rn(w[1], w[6]);
  const double qf = __dmul_rn(w[2], w[7]), ql = __dmul_rn(w[3], w[7]);
  const double g21 = w[8], h2 = w[9];
  const double d11 = __dsub_rn(1.0, __dmul_rn(pf, g21));
  const double det = fabs(d11) < kTiny2 ? (d11 < 0.0 ? -kTiny2 : kTiny2) : d11;
  const double i11 = __ddiv_rn(1.0, det);
  const double i21 = __ddiv_rn(__dmul_rn(pl, g21), det);
  const double i22 = __ddiv_rn(d11, det);
  const double r1 = __dsub_rn(w[4], __dmul_rn(pf, h2));
  const double r2 = __dsub_rn(w[5], __dmul_rn(pl, h2));
  const double H1 = __dmul_rn(i11, r1);
  const double H2 = __dadd_rn(__dmul_rn(i21, r1), __dmul_rn(i22, r2));
  const double G11 = __dmul_rn(i11, qf);
  const double G21 = __dadd_rn(__dmul_rn(i21, qf), __dmul_rn(i22, ql));
  o[0] = H2;
  o[1] = G21;
  o[2] = __dsub_rn(H1, __dmul_rn(G11, w[9]));   // the back step, F_{b+1} = h2
  o[3] = __dsub_rn(H2, __dmul_rn(G21, w[9]));
  o[4] = H1;
  o[5] = G11;
}

}  // namespace

// (SMs, shared bytes an SM holds, shared bytes a block of threads may opt
// into) of the current device, into out[0..2]: the launch plan's inputs
// (kernels/shifted_solve.py::interface_plan).
extern "C" int interface_solve_limits(void* out) {
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = sms;
  o[1] = per_sm;
  o[2] = optin;
  return 0;
}

// pf, pl, qf, ql, uf, ul: (P, K) f64 with unit column stride and row stride
// `ld` (elements); sp, sq: (P,) f64 scales of (pf, pl) and (qf, ql), or null;
// Fo, Lo: (P, K) f64 contiguous outputs (F, L, or with `shifted` F_below,
// L_above); G11, G21: (P - ps, K) f64 scratch (null when ps = P).  The plan
// (kernels/shifted_solve.py::interface_plan): nc columns a block of
// threads, the forward values of the last ps rows kept in shared memory,
// `whole` (every input row copied at once; ps = P) and `smem`, its dynamic
// shared bytes, 8 (2 P + (whole ? P : kRing) 6 nc + 4 ps nc).  Launch on
// `stream`, allocate nothing, return the launch's cudaError_t.
extern "C" int interface_solve_launch(const void* pf, const void* pl,
                                      const void* qf, const void* ql,
                                      const void* uf, const void* ul,
                                      long long ld, const void* sp,
                                      const void* sq, int P, int K, int shifted,
                                      void* Fo, void* Lo, void* G11, void* G21,
                                      int nc, int ps, int whole, int smem,
                                      void* stream) {
  if (P <= 0 || K <= 0) return 0;
  const long long need = 8LL * (2LL * P + (long long)(whole ? P : kRing) * 6 * nc
                                + 4LL * ps * nc);
  if (nc < 1 || nc > kThreads || ps < 0 || ps > P || (whole && ps != P) || smem != need
      || (ps < P && (G11 == nullptr || G21 == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{{static_cast<const double*>(pf), static_cast<const double*>(pl),
          static_cast<const double*>(qf), static_cast<const double*>(ql),
          static_cast<const double*>(uf), static_cast<const double*>(ul)},
         ld, static_cast<const double*>(sp), static_cast<const double*>(sq), P, K, shifted,
         nc, ps, static_cast<double*>(Fo), static_cast<double*>(Lo),
         static_cast<double*>(G11), static_cast<double*>(G21)};
  const void* fn = whole ? (const void*)interface_kernel<true> : (const void*)interface_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((K + nc - 1) / nc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (whole) {
    interface_kernel<true><<<grid, kThreads, static_cast<size_t>(smem), st>>>(a);
  } else {
    interface_kernel<false><<<grid, kThreads, static_cast<size_t>(smem), st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef KERNEL_PROBES
// The probed copy's phase cycles of column 0 (four phases, then P).
extern "C" int interface_probe_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_if, sizeof(g_if)));
}
#endif

// Keeps the yardstick in the library (its SASS is read, never run).
extern "C" void* interface_solve_yardstick() {
  return reinterpret_cast<void*>(&interface_step_yardstick);
}
