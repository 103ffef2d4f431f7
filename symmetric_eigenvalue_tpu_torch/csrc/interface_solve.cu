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
// (g21, h2) and F_{b+1} in registers.  The forward sweep writes H1 and H2
// into the outputs' storage (at the slots the back sweep then overwrites
// with F and L) and G11, G21 to a 2 P K scratch; consecutive threads take
// consecutive columns, so every load and store of a block row is
// coalesced.  A step's loads do not depend on the carry: each sweep loads
// block b+1's values before computing block b.  (Loading eight blocks ahead
// through a ring of registers measured slower on the H100, so a step's
// time is not a load's latency; the carry's chain of a division, products
// and sums is the suspect.)
// The optional scales (the Spike pass's ec_above on pf, pl and e_cross on
// qf, ql) are applied at load time, one product each, as the plain
// version's multiplication does.  ``shifted`` writes the neighbour values
// the passes read, F_below[b] = F[b+1] and L_above[b] = L[b-1] (0 at the
// ends), instead of F and L.  No host fetch and no synchronising call: a
// CUDA graph can hold the launch.
//
// Least time: the bytes of six (P, K) inputs read and two written (8 P K
// doubles); the scratch and the H round trip add 8 P K more, and with one
// thread a column the card holds K threads, too few at the shapes of the
// triage's passes (K of 1 to a few hundred) to hide either sweep's latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr double kTiny2 = 0x1p-96;

struct Row {      // a block's forward-sweep inputs
  double pf, pl, qf, ql, uf, ul;
};

__device__ __forceinline__ Row load_row(const double* __restrict__ pf,
                                        const double* __restrict__ pl,
                                        const double* __restrict__ qf,
                                        const double* __restrict__ ql,
                                        const double* __restrict__ uf,
                                        const double* __restrict__ ul,
                                        int64_t at) {
  return Row{pf[at], pl[at], qf[at], ql[at], uf[at], ul[at]};
}

__global__ void __launch_bounds__(kThreads)
interface_kernel(const double* __restrict__ pf, const double* __restrict__ pl,
                 const double* __restrict__ qf, const double* __restrict__ ql,
                 const double* __restrict__ uf, const double* __restrict__ ul,
                 int64_t ld, const double* __restrict__ sp,
                 const double* __restrict__ sq, int P, int K, int shifted,
                 double* Fo, double* Lo, double* G11, double* G21) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  // the storage slot of F_b and of L_b (H1_b and H2_b before the back sweep)
  auto fslot = [&](int b) -> int64_t {
    return (int64_t)(shifted ? (b + P - 1) % P : b) * K + i;
  };
  auto lslot = [&](int b) -> int64_t {
    return (int64_t)(shifted ? (b + 1) % P : b) * K + i;
  };

  double g21 = 0.0, h2 = 0.0;
  Row nxt = load_row(pf, pl, qf, ql, uf, ul, i);
  for (int b = 0; b < P; ++b) {
    Row cur = nxt;
    if (b + 1 < P)
      nxt = load_row(pf, pl, qf, ql, uf, ul, (int64_t)(b + 1) * ld + i);
    if (sp != nullptr) {
      const double s = sp[b];
      cur.pf = __dmul_rn(cur.pf, s);
      cur.pl = __dmul_rn(cur.pl, s);
    }
    if (sq != nullptr) {
      const double s = sq[b];
      cur.qf = __dmul_rn(cur.qf, s);
      cur.ql = __dmul_rn(cur.ql, s);
    }
    // D_b = I - Lo_b G_{b-1} = [[1 - pf g21, 0], [-pl g21, 1]]
    const double d11 = __dsub_rn(1.0, __dmul_rn(cur.pf, g21));
    const double det = fabs(d11) < kTiny2 ? (d11 < 0.0 ? -kTiny2 : kTiny2) : d11;
    const double i11 = __ddiv_rn(1.0, det);
    const double i21 = __ddiv_rn(__dmul_rn(cur.pl, g21), det);
    const double i22 = __ddiv_rn(d11, det);
    const double r1 = __dsub_rn(cur.uf, __dmul_rn(cur.pf, h2));
    const double r2 = __dsub_rn(cur.ul, __dmul_rn(cur.pl, h2));
    Fo[fslot(b)] = __dmul_rn(i11, r1);
    h2 = __dadd_rn(__dmul_rn(i21, r1), __dmul_rn(i22, r2));
    Lo[lslot(b)] = h2;
    const int64_t at = (int64_t)b * K + i;
    G11[at] = __dmul_rn(i11, cur.qf);
    g21 = __dadd_rn(__dmul_rn(i21, cur.qf), __dmul_rn(i22, cur.ql));
    G21[at] = g21;
  }

  double f_next = 0.0;
  int b = P - 1;
  double h1n = Fo[fslot(b)], h2n = Lo[lslot(b)];
  double g11n = G11[(int64_t)b * K + i], g21n = G21[(int64_t)b * K + i];
  for (; b >= 0; --b) {
    const double h1 = h1n, hh2 = h2n, g11 = g11n, gg21 = g21n;
    if (b > 0) {
      h1n = Fo[fslot(b - 1)];
      h2n = Lo[lslot(b - 1)];
      g11n = G11[(int64_t)(b - 1) * K + i];
      g21n = G21[(int64_t)(b - 1) * K + i];
    }
    const double F = __dsub_rn(h1, __dmul_rn(g11, f_next));
    const double L = __dsub_rn(hh2, __dmul_rn(gg21, f_next));
    // shifted: F_0 and L_{P-1} have no neighbour slot; their slots hold
    // F_below[P-1] = 0 and L_above[0] = 0
    Fo[fslot(b)] = shifted && b == 0 ? 0.0 : F;
    Lo[lslot(b)] = shifted && b == P - 1 ? 0.0 : L;
    f_next = F;
  }
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

// pf, pl, qf, ql, uf, ul: (P, K) f64 with unit column stride and row stride
// `ld` (elements); sp, sq: (P,) f64 scales of (pf, pl) and (qf, ql), or null;
// Fo, Lo: (P, K) f64 contiguous outputs (F, L, or with `shifted` F_below,
// L_above); G11, G21: (P, K) f64 scratch.  Launch on `stream`, allocate
// nothing, return the launch's cudaError_t.
extern "C" int interface_solve_launch(const void* pf, const void* pl,
                                      const void* qf, const void* ql,
                                      const void* uf, const void* ul,
                                      long long ld, const void* sp,
                                      const void* sq, int P, int K, int shifted,
                                      void* Fo, void* Lo, void* G11, void* G21,
                                      void* stream) {
  if (P <= 0 || K <= 0) return 0;
  const dim3 grid((K + kThreads - 1) / kThreads);
  interface_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(pf), static_cast<const double*>(pl),
      static_cast<const double*>(qf), static_cast<const double*>(ql),
      static_cast<const double*>(uf), static_cast<const double*>(ul),
      static_cast<int64_t>(ld), static_cast<const double*>(sp),
      static_cast<const double*>(sq), P, K, shifted, static_cast<double*>(Fo),
      static_cast<double*>(Lo), static_cast<double*>(G11),
      static_cast<double*>(G21));
  return static_cast<int>(cudaGetLastError());
}

// Keeps the yardstick in the library (its SASS is read, never run).
extern "C" void* interface_solve_yardstick() {
  return reinterpret_cast<void*>(&interface_step_yardstick);
}
