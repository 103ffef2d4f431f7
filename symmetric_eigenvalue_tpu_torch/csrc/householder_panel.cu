// The dense reduction's column step and the compact-WY T factor.
//
// Replaces two device loops of the JAX package that hold no pallas_call:
//  - symmetric_eigenvalue_tpu/kernels/tridiagonalize.py::_tridiagonalize_block,
//    its column body `col_body` (:114), run by the lax.fori_loops at :139
//    (columns of a panel) and :146 (panels).  JAX compiles the loop into one
//    program; the port drove it from Python with ~31 small launches a column.
//    Here a column is two launches: the unchanged dword_vecmat matvec
//    (csrc/dword_matvec.cu) and one column_step_kernel that finishes the
//    column's W row and then makes the next column's reflector.
//  - _larft (:213), its lax.fori_loop at :227 (two launches a reflector in the
//    port's torch loop): larft, one launch a panel, T by diagonal blocks
//    and block products.
//  - symmetric_eigenvalue_tpu/kernels/band_reduce.py::apply_q2_wave_blocked
//    (:509), the T factors its wave body (:551-604) forms a wave at a time
//    (T^{-1} = diag(1/tau) + striu(Y^T Y), :569-574): q2_blocks_t, the T
//    (by larft's diagonal blocks and joins over the band Gram, formed as
//    one product) and the Y^T, laid out for the waves, of every block of a
//    chunk of waves in one launch before the chunk's first wave (the
//    waves themselves are csrc/q2_apply.cu).
//
// The column step at local column j of a bucket of width m, panel offset o,
// jj = j - o, with Vp / Wp the panel's reflector and W accumulator rows
// (row stride ld = m) and As the bucket's trailing matrix (row stride lda):
//  R  (the reflector half) a[i] = As[j,i] - sum_{k<jj} Vp[k,i] Wp[k,j]
//      - sum_{k<jj} Wp[k,i] Vp[k,j] for i >= j+1, sigma2 = sum_{i>=j+2} a[i]^2,
//      the pivot, norm, alpha, tau and the no-op flag, v into Vp[jj] and
//      (tau, alpha) into te[j]; also p = Wp[:jj] v and q = Vp[:jj] v, from
//      P = sum_i Wp[k,i] a[i] and Q = sum_i Vp[k,i] a[i] divided by the
//      pivot's denominator.
//  M  y = v[j+1:] @ As[j+1:]  (dword_vecmat).
//  W  (the W half) Wp[jj] = tau (y - Vp[:jj]^T p - Wp[:jj]^T q) - half v with
//      half = 0.5 tau^2 (y.v - 2 p.q): v.(A_updated v) = y.v - 2 p.q because
//      Vp[k].v = q[k] and Wp[k].v = p[k], so no second pass over w.
// A panel of cnt columns at o launches R(o) alone, then M(j) and the fused
// W(j) + R(j+1) for j = o .. o+cnt-2, then M and W alone for its last
// column (kernels/householder_panel.py::panel_launches): every launch but
// two of a panel does both halves, and the three instances below are one
// kernel with a half switched off.  The last column of the last bucket
// (j = m - 2) has nothing below its pivot: its R half, in identity mode,
// writes te[j][1] = a[j+1] and zeroes Wp[jj] (v and tau stay zero), as the
// plain loop does, and no M or W follows.
//
// What bounds the step on an H100: M's bytes (the bucket's rows below the
// pivot, ~0.64 ms at 16384 x 16384).  R and W read 2 jj + 1 rows of the panel
// (about 8 MB at m = 16384, jj = 31, mostly from L2); what they must avoid is
// latency.  So each launch is cooperative (cudaLaunchCooperativeKernel) with
// a grid that spans every SM (the occupancy API times the SM count,
// kernels/householder_panel.py::column_plan), each block owns one slice of
// the row's entries and copies its slice of the panel rows into shared
// memory once (cp.async) for both halves, and the grid-wide steps are
// cooperative_groups grid syncs: one after W's y.v partials, one after R's
// sigma2 / P / Q partials.  After a sync every block sums the per-block
// partials in the same fixed block order, so all blocks hold the same bits,
// identical from run to run, and each finishes its own slice: W's -half v,
// R's division of v by the pivot's denominator.  The P / Q totals are
// spread over the blocks, a warp a row.  Between the halves no sync is
// needed: a thread owns the same entries in both, so its W entries are final
// when R reads them, and the one W entry every block needs, Wp[jj][j+1], each
// block recomputes in the order its owner does.
//
// larft: T (nb x nb, upper) with T[k,k] = tau_k and
// T[:k,k] = -tau_k T[:k,:k] G[:k,k] for k = 0..nb-1, from the panel's Gram
// G, in blocks.  One block of 256 threads: G's strict upper triangle and
// the taus staged in shared memory in one coalesced pass (to nb = 128; a
// global scratch past it) into M, whose rows are trimmed to their 32-row
// block-row (Tri: no lower block triangle); each 32-column diagonal block
// of T by the recurrence, a warp a block and a lane a row, each row's sums
// for the later columns in registers (no global load in the dependent
// chain, no wait between lanes); then the blocks joined pairwise, widths
// 32, 64, .., by the compact-WY identity T_AB = -T_AA G_AB T_BB, two rounds
// of 4 x 4 tiles a width (X = G_AB T_BB, then T_AB over G_AB's place; in
// q2_blocks_t X too, in place, each round's tiles computed before any is
// stored, which saves X's 32 KB at nb = 128).  What bounds it on
// an H100: latency (the diagonal blocks' 31 dependent steps and log2(nb /
// 32) joins), not its bytes.
// q2_blocks_t (the same T for every reflector block of the two-stage
// backtransform, over a Gram it forms itself) shares that body
// (larft_diag, larft_joins).  What bounds it: the log's and the stores'
// bytes (1.3 ms at n = 16384, band 128) once the Gram is out of the
// dependent chain; the old kernel built a Gram column inside each of the
// b - 1 steps, one block of threads an SM.  So at b > 32 a block of 256
// threads a reflector block reads Y from the log once, a slab of 16 rows
// at a time into a ring copied three slabs ahead (cp.async) in M's idle
// storage, stores Y^T from the slab and adds the slab's rows to G on the
// FP64 tensor cores (16 x 8 tiles, their sums in registers), then runs
// larft's body on M in shared memory (84,992 bytes at b = 128: two blocks
// of threads an SM); at b <=
// 32 a team of lanes (b rounded up to a power of two) a reflector block,
// 128 / L of them a block of threads, T by one diagonal block, the teams'
// consecutive stores written by the whole block of threads at once.
//
// Contractions are fused multiply-adds (__fma_rn); every other rounding is
// written out; v is divided by the denominator (__ddiv_rn), not multiplied
// by its reciprocal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;   // column step: a block's slice, 128 entries at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPanel = 1024; // nb the column step takes
constexpr int kScalars = 4;     // shared doubles for a block's scalars

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The block's sum of x (every thread calls), in thread 0: warps' sums in
// warp order.
__device__ __forceinline__ double block_sum(double x, double* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, red[w]);
  }
  __syncthreads();
  return s;
}

// The sums over b < blocks of ws[b * stride] and, for t >= 0, of
// ws[b * stride + t], by one warp: each lane adds its blocks b = lane,
// lane + 32, ... in order (their loads all in flight), then a fixed tree; in
// lane 0.  Every warp that calls it gets the same bits.
__device__ __forceinline__ void grid_totals(const double* ws, int stride, int blocks, int t,
                                            double& first, double& at_t) {
  constexpr int kAhead = 8;
  const int lane = threadIdx.x & 31;
  double s0 = 0.0, s1 = 0.0;
  for (int b0 = 0; b0 < blocks; b0 += 32 * kAhead) {
    double x0[kAhead], x1[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int b = b0 + lane + 32 * u;
      x0[u] = b < blocks ? __ldcg(ws + (size_t)b * stride) : 0.0;
      x1[u] = b < blocks && t >= 0 ? __ldcg(ws + (size_t)b * stride + t) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      s0 = __dadd_rn(s0, x0[u]);
      s1 = __dadd_rn(s1, x1[u]);
    }
  }
  first = warp_sum(s0);
  at_t = warp_sum(s1);
}

__device__ __forceinline__ void cp_async8(double* smem, const double* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}

struct Step {
  const double* As;  // the bucket (m, m), unit column stride, row stride lda
  long long lda;
  double* Vp;        // the panel's reflector rows, row stride ld
  double* Wp;        // its W rows
  int ld;
  const double* y;   // M's output (the W half)
  double* te;        // (tau, alpha) of the bucket's columns
  double* pq;        // p then q of the last reflector (2 nb)
  double* ws;        // partials and two slots: blocks (2 nb + 2) + 2
  int m, j, jj;      // the first half's column and panel row
  int slice, cached; // entries a block owns; panel rows it may cache
};

// Shared doubles of a launch (the plan sizes them for the panel's widest).
__host__ __device__ __forceinline__ long long step_shared(int np, int nv, int slice,
                                                          int cached) {
  return 2LL * np + 2LL * nv + kScalars + kWarps + 3LL * slice
         + 2LL * cached * slice;
}

// kW: the W row of column j (panel row jj).  kR: the reflector of column
// c = j + kW (panel row jr = jj + kW).
template <bool kW, bool kR>
__global__ void __launch_bounds__(kThreads) column_step_kernel(const Step a) {
  extern __shared__ double sh[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, S = a.slice, m = a.m, ld = a.ld;
  const int lo = blockIdx.x * S;
  const int ne = max(0, min(S, m - lo));  // entries lo .. lo + ne - 1
  const int jw = a.jj;                    // the W row (kW)
  const int c = a.j + (kW ? 1 : 0);       // the reflector's column (kR)
  const int jr = a.jj + (kW ? 1 : 0);     // and its panel row
  const int nold = kW ? jw : jr;          // rows finished by earlier launches
  const int kc = min(nold, a.cached);     // of them in shared memory
  double* sp = sh;                        // p, q of column j (kW)
  double* sq = sp + (kW ? jw : 0);
  double* vj = sq + (kW ? jw : 0);        // Vp[k][c], Wp[k][c], k < jr (kR)
  double* wj = vj + (kR ? jr : 0);
  double* scal = wj + (kR ? jr : 0);
  double* red = scal + kScalars;
  double* ev = red + kWarps;              // Vp[jw] at the slice (kW)
  double* ew = ev + S;                    // y, then the W row (kW)
  double* ea = ew + S;                    // As[c], then the delayed row (kR)
  double* Vc = ea + S;                    // rows k < kc of Vp, Wp at the slice
  double* Wc = Vc + (size_t)kc * S;
  double* ws_w = a.ws;                    // W's y.v partials
  double* piv = a.ws + G;                 // R's pivot
  double* wslot = a.ws + G + 1;           // W's Wp[jw][c] before -half v
  double* ws_r = a.ws + G + 2;            // R's sigma2, P, Q partials

  for (int k = 0; k < kc; ++k) {
    for (int s = tid; s < ne; s += kThreads) {
      cp_async8(Vc + (size_t)k * S + s, a.Vp + (size_t)k * ld + lo + s);
      cp_async8(Wc + (size_t)k * S + s, a.Wp + (size_t)k * ld + lo + s);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (kW) {
    for (int k = tid; k < jw; k += kThreads) {
      sp[k] = __ldcg(a.pq + k);
      sq[k] = __ldcg(a.pq + jw + k);
    }
  }
  if (kR) {
    for (int k = tid; k < nold; k += kThreads) {
      vj[k] = __ldg(a.Vp + (size_t)k * ld + c);
      wj[k] = __ldg(a.Wp + (size_t)k * ld + c);
    }
    if (kW && tid == 0) vj[jw] = __ldg(a.Vp + (size_t)jw * ld + c);
  }
  for (int s = tid; s < ne; s += kThreads) {
    const int i = lo + s;
    if (kW) {
      ev[s] = __ldg(a.Vp + (size_t)jw * ld + i);
      ew[s] = __ldg(a.y + i);
    }
    if (kR) ea[s] = i > c ? __ldg(a.As + (size_t)c * a.lda + i) : 0.0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if (kW) {
    const double tau = __ldcg(a.te + 2 * a.j);
    if (warp == 1) {
      // p.q, a lane's terms in order, then a fixed tree
      double x = 0.0;
      for (int k = lane; k < jw; k += 32) x = __fma_rn(sp[k], sq[k], x);
      x = warp_sum(x);
      if (lane == 0) scal[1] = x;
    }
    double sv = 0.0;
    for (int s = tid; s < ne; s += kThreads) {
      const int i = lo + s;
      double s1 = 0.0, s2 = 0.0;
      int k = 0;
#pragma unroll 4
      for (; k < kc; ++k) {
        s1 = __fma_rn(Vc[(size_t)k * S + s], sp[k], s1);
        s2 = __fma_rn(Wc[(size_t)k * S + s], sq[k], s2);
      }
      for (; k < jw; ++k) {
        s1 = __fma_rn(__ldg(a.Vp + (size_t)k * ld + i), sp[k], s1);
        s2 = __fma_rn(__ldg(a.Wp + (size_t)k * ld + i), sq[k], s2);
      }
      const double yi = ew[s];
      const double w = __dmul_rn(tau, __dsub_rn(__dsub_rn(yi, s1), s2));
      ew[s] = w;
      if (kR && i == c) *wslot = w;       // every block needs it after the sync
      if (i > a.j) sv = __dadd_rn(sv, __dmul_rn(yi, ev[s]));
    }
    const double part = block_sum(sv, red);
    if (tid == 0) ws_w[blockIdx.x] = part;
    grid.sync();
    if (warp == 0) {
      double yv, unused;
      grid_totals(ws_w, 1, G, -1, yv, unused);
      if (lane == 0) {
        // v.(A_updated v) = y.v - 2 p.q; half = 0.5 tau (tau v.(A v)) as
        // the plain loop's dot(w, v) * tau * 0.5
        const double vav = __fma_rn(-2.0, scal[1], yv);
        scal[0] = __dmul_rn(__dmul_rn(__dmul_rn(tau, vav), tau), 0.5);
      }
    } else if (kR && tid == 32) {
      scal[3] = __ldcg(wslot);
    }
    __syncthreads();
    const double half = scal[0];
    for (int s = tid; s < ne; s += kThreads) {
      const int i = lo + s;
      const double w = i > a.j ? __fma_rn(-half, ev[s], ew[s]) : ew[s];
      a.Wp[(size_t)jw * ld + i] = w;
      ew[s] = w;
    }
    // Wp[jw][c] as its owner finishes it
    if (kR && tid == 0) wj[jw] = __fma_rn(-half, vj[jw], scal[3]);
    __syncthreads();
  }
  if (!kR) return;

  // the delayed row past c; the pivot (i = c + 1) apart, ea keeps the
  // entries below it
  const bool identity = c == m - 2;
  for (int s = tid; s < ne; s += kThreads) {
    const int i = lo + s;
    if (i <= c) continue;
    double s1 = 0.0, s2 = 0.0;
    int k = 0;
#pragma unroll 4
    for (; k < kc; ++k) {
      s1 = __fma_rn(Vc[(size_t)k * S + s], wj[k], s1);
      s2 = __fma_rn(Wc[(size_t)k * S + s], vj[k], s2);
    }
    for (; k < nold; ++k) {
      s1 = __fma_rn(__ldg(a.Vp + (size_t)k * ld + i), wj[k], s1);
      s2 = __fma_rn(__ldg(a.Wp + (size_t)k * ld + i), vj[k], s2);
    }
    if (kW) {                             // row jw, finished above
      s1 = __fma_rn(ev[s], wj[jw], s1);
      s2 = __fma_rn(ew[s], vj[jw], s2);
    }
    const double x = __dsub_rn(__dsub_rn(ea[s], s1), s2);
    if (i == c + 1) {
      if (identity) a.te[2 * c + 1] = x;
      else *piv = x;
    }
    ea[s] = i == c + 1 ? 0.0 : x;
  }
  if (identity) {
    // j = m - 2: the identity reflector; v and tau stay zero, and the W row
    // (an earlier panel's, maybe) is zeroed
    for (int s = tid; s < ne; s += kThreads) a.Wp[(size_t)jr * ld + lo + s] = 0.0;
    return;
  }
  __syncthreads();

  // the block's partials of row t: t = 0 sigma2 = sum a^2, t = 1 + k
  // P[k] = sum Wp[k] a, t = 1 + jr + k Q[k] = sum Vp[k] a, over the entries
  // past the pivot; `parts` consecutive lanes a row, each over every
  // parts-th entry in order, then a fixed tree
  const int R = 2 * jr + 1;
  int parts = 32;
  while (parts > 1 && parts * R > kThreads) parts >>= 1;
  const int part = tid & (parts - 1);
  const int s0 = max(0, c + 2 - lo);
  for (int t0 = 0; t0 < R; t0 += kThreads / parts) {
    const int t = t0 + tid / parts;
    double x = 0.0;
    if (t < R) {
      const bool is_p = t <= jr;
      const int k = is_p ? t - 1 : t - 1 - jr;
      const double* row = t == 0 ? ea
                          : k < kc ? (is_p ? Wc : Vc) + (size_t)k * S
                          : kW && k == jw ? (is_p ? ew : ev)
                          : nullptr;
      const double* far = row != nullptr ? row : (is_p ? a.Wp : a.Vp) + (size_t)k * ld + lo;
      for (int s = s0 + part; s < ne; s += parts) {
        const double r = row != nullptr ? row[s] : __ldg(far + s);
        x = __dadd_rn(x, __dmul_rn(r, ea[s]));
      }
    }
    for (int off = parts >> 1; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (t < R && part == 0) ws_r[(size_t)blockIdx.x * R + t] = x;
  }
  grid.sync();

  // every warp: sigma2's total (the same bits in every warp and block),
  // beside the total of its first P / Q row (rows 1 + blockIdx.x + G w, ...)
  double denom = 0.0, unit = 0.0;
  for (int t = 1 + blockIdx.x + G * warp, first = 1; first || t < R;
       t += G * kWarps, first = 0) {
    double sigma2, tot;
    grid_totals(ws_r, R, G, t < R ? t : -1, sigma2, tot);
    if (first) {
      if (lane == 0) {
        const double pivot = __ldcg(piv);
        const double norm = __dsqrt_rn(__dadd_rn(sigma2, __dmul_rn(pivot, pivot)));
        double alpha = pivot >= 0.0 ? -norm : norm;   // sign avoids cancellation
        const bool no_op = sigma2 == 0.0;             // already tridiagonal here
        denom = no_op ? 1.0 : __dsub_rn(pivot, alpha);
        const double tau = no_op ? 0.0 : __ddiv_rn(__dsub_rn(alpha, pivot), alpha);
        alpha = no_op ? pivot : alpha;
        unit = no_op ? 0.0 : 1.0;
        if (blockIdx.x == 0 && warp == 0) {
          a.te[2 * c] = tau;
          a.te[2 * c + 1] = alpha;
          a.Vp[(size_t)jr * ld + c + 1] = unit;
        }
      }
      denom = __shfl_sync(0xffffffffu, denom, 0);
      unit = __shfl_sync(0xffffffffu, unit, 0);
    }
    if (t < R && lane == 0) {
      // p = Wp v, q = Vp v: the pivot column's term and the rest / denom
      const bool is_p = t <= jr;
      const int k = is_p ? t - 1 : t - 1 - jr;
      const double* at = (is_p ? a.Wp : a.Vp) + (size_t)k * ld + c + 1;
      a.pq[t - 1] = __fma_rn(__ldcg(at), unit, __ddiv_rn(tot, denom));
    }
  }
  for (int s = s0 + tid; s < ne; s += kThreads) {
    a.Vp[(size_t)jr * ld + lo + s] = __ddiv_rn(ea[s], denom);
  }
}

// The cost of a grid-wide sync at a launch's grid (a yardstick for
// chip_smoke.py, never launched on the reduction's path).
__global__ void __launch_bounds__(kThreads) grid_sync_probe_kernel(int syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s < syncs; ++s) grid.sync();
}

// The working matrix M of larft and q2_blocks_t (nbp rows: nb rounded up to
// 32, or a team's width below 32): T on and above its diagonal; G's strict
// upper triangle inside each 32-column diagonal block stored transposed
// below that block's diagonal (M(c, r) = G[r][c], r < c, the recurrence's
// broadcast reads), and between blocks at its own place (M(r, c) = G[r][c]),
// where the join that makes T_AB first reads and then overwrites it.  Rows
// are trimmed to their block-row: row r holds columns 32 (r / 32) .. nbp - 1,
// in rows of nbp - 32 (r / 32) + 2 doubles (even: every row 16-byte
// aligned), so the lower block triangle takes no memory (10,496 doubles at
// nbp = 128 against 16,640 for the square).
struct Tri {
  double* p;
  int nbp;
  __device__ __forceinline__ long long row(int r) const {
    const long long I = r >> 5;
    return 32 * (I * (nbp + 2) - 16 * I * (I - 1)) + (r - 32 * I) * (nbp - 32 * I + 2) - 32 * I;
  }
  __device__ __forceinline__ int ld(int r) const { return nbp - 32 * (r >> 5) + 2; }
  __device__ __forceinline__ double* at(int r, int c) const { return p + row(r) + c; }
  __device__ __forceinline__ double& operator()(int r, int c) const { return p[row(r) + c]; }
};

// Doubles of M at nbp rows (a multiple of 32, or below 32).
__host__ __device__ constexpr long long tri_doubles(int nbp) {
  return nbp < 32 ? (long long)nbp * (nbp + 2)
                  : 32LL * ((long long)(nbp / 32) * (nbp + 2)
                            - 16LL * (nbp / 32) * (nbp / 32 - 1));
}

__host__ __device__ constexpr int larft_padded(int nb) { return (nb + 31) & ~31; }

// Four doubles at a 16-byte aligned p, as two 16-byte loads.
__device__ __forceinline__ void load4(const double* p, double* x) {
  const double2 u = reinterpret_cast<const double2*>(p)[0];
  const double2 w = reinterpret_cast<const double2*>(p)[1];
  x[0] = u.x;
  x[1] = u.y;
  x[2] = w.x;
  x[3] = w.y;
}

__device__ __forceinline__ void store4(double* p, const double* x) {
  reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
}

// One diagonal block of T by the recurrence, L (a power of two to 32)
// columns: blk points at its first entry (its rows ld apart), tz at its
// taus; every lane r < L of the team calls it.  T[r][k] = -tau_k sum_{r <=
// l < k} T[r][l] G[l][k], the sum for every later column k kept in
// registers and added to as each T[r][l] is made (the order of the
// one-column-a-step recurrence: the same bits); G's entries are the team's
// broadcast reads, and no lane waits for another.
template <int L>
__device__ __forceinline__ void larft_diag(double* blk, int ld, const double* tz, int r) {
  double acc[L];
#pragma unroll
  for (int k = 0; k < L; ++k) acc[k] = 0.0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const double t = l < r ? 0.0 : (l == r ? tz[l] : __dmul_rn(acc[l], -tz[l]));
    if (l >= r) blk[(size_t)r * ld + l] = t;
#pragma unroll
    for (int k = l + 1; k < L; ++k) acc[k] = __fma_rn(t, blk[(size_t)k * ld + l], acc[k]);
  }
}

// One 4 x 4 tile of a join at rows i0.., columns c0.. of the pair (A =
// [a, a + h), B = [a + h, a + h + hb)), into acc: X = G_AB T_BB (step 1),
// or T_AB = -T_AA X without the sign (step 2), X in M at G_AB's place
// (kInPlace) or in its own h x hb block (row stride hb).  Sums run over l in
// increasing order, fused multiply-adds; T's triangles masked.
template <bool kInPlace>
__device__ __forceinline__ void larft_join_tile(Tri M, const double* X, int a, int h, int hb,
                                                int i0, int c0, bool step2, double acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0;
  }
  const double* rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = M.at(a + i0 + i, 0);
  if (!step2) {
    // X[i][c] = sum_{l <= c} G[a + i][a + h + l] T[a + h + l][a + h + c]
    for (int l = 0; l <= c0 + 3; ++l) {
      double x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = rows[i][a + h + l];
      load4(M.at(a + h + l, a + h + c0), y);
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] = l <= c0 + c ? y[c] : 0.0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = __fma_rn(x[i], y[c], acc[i][c]);
      }
    }
  } else {
    // T_AB[i][c] = -sum_{l >= i} T[a + i][a + l] X[l][c]
    for (int l = i0; l < h; ++l) {
      double x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = l >= i0 + i ? rows[i][a + l] : 0.0;
      load4(kInPlace ? M.at(a + l, a + h + c0) : X + (size_t)l * hb + c0, y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = __fma_rn(x[i], y[c], acc[i][c]);
      }
    }
  }
}

// Where a join tile's result goes: X (step 1; in M at G_AB's place when
// kInPlace) or T_AB (step 2, negated).
template <bool kInPlace>
__device__ __forceinline__ void larft_join_store(Tri M, double* X, int a, int h, int hb, int i0,
                                                 int c0, bool step2, double acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    double v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = step2 ? -acc[i][c] : acc[i][c];
    store4(step2 || kInPlace ? M.at(a + i0 + i, a + h + c0) : X + (size_t)(i0 + i) * hb + c0, v);
  }
}

// The joins of T's diagonal blocks, widths h = 32, 64, ..: T_AB = -T_AA
// G_AB T_BB for each pair of neighbouring blocks (A = [a, a + h), B = [a +
// h, a + h + hb)), all pairs of a width at once, in two steps of 4 x 4
// tiles, every thread of the block of kThreads calling.  kInPlace (nbp <=
// kInPlaceMax, a tile a thread at 256 threads): each step's tiles are all
// computed before any is stored, X over G_AB and T_AB over X, so no
// scratch; else X in its own nbp^2 / 4 doubles.
constexpr int kInPlaceMax = 128;

template <int kThreads, bool kInPlace>
__device__ __forceinline__ void larft_joins(Tri M, double* X, int nbp) {
  static_assert(!kInPlace || kThreads * 16 >= kInPlaceMax * kInPlaceMax / 4,
                "a join step's tiles, one a thread");
  const int tid = threadIdx.x;
  for (int h = 32; h < nbp; h *= 2) {
    const int pairs = (nbp - h + 2 * h - 1) / (2 * h);   // pairs with a B
    const int full = (h / 4) * (h / 4);                   // a pair's tiles (fewer in a narrow B)
    for (int step = 0; step < 2; ++step) {
      for (int t0 = 0; t0 < pairs * full; t0 += kThreads) {
        const int t = t0 + tid;
        const int p = t / full, in = t - p * full;
        const int a = 2 * h * p, hb = min(h, nbp - a - h), tc = max(hb / 4, 1);
        const bool live = t < pairs * full && in < (h / 4) * tc;
        const int i0 = 4 * (in / tc), c0 = 4 * (in % tc);
        double* Xp = kInPlace ? X : X + (size_t)p * h * h;
        double acc[4][4];
        if (live) larft_join_tile<kInPlace>(M, Xp, a, h, hb, i0, c0, step == 1, acc);
        if (kInPlace) __syncthreads();        // every tile read before any is stored
        if (live) larft_join_store<kInPlace>(M, Xp, a, h, hb, i0, c0, step == 1, acc);
      }
      __syncthreads();
    }
  }
}

// larft: T (nb x nb, upper) with T[k,k] = tau_k and T[:k,k] = -tau_k
// T[:k,:k] G[:k,k], from the panel's Gram G, in blocks: M (Tri, nbp = nb
// rounded up to 32) zero past nb (tau too, so the padding's T is zero), T's
// 32-column diagonal blocks a warp each (larft_diag), then the joins
// (larft_joins, X in its own storage); in shared memory to nb = 128, else
// in a global scratch.
constexpr int kLarftThreads = 256;

// Phase probes of larft, compiled only where KERNEL_PROBES is defined
// (tools/panel_qr_profile.py --phases): thread 0's clock64 cycles in the
// staging, the diagonal blocks, the joins and the store (larft_probe_read).
#ifdef KERNEL_PROBES
__device__ long long g_lt[8];
#define LT_PROBE_START long long lacc_[4] = {0, 0, 0, 0}; long long lprev_ = clock64()
#define LT_PROBE(i) do { if (threadIdx.x == 0) { const long long now_ = clock64(); \
    lacc_[i] += now_ - lprev_; lprev_ = now_; } } while (0)
#define LT_PROBE_STORE do { if (threadIdx.x == 0) { \
    for (int i_ = 0; i_ < 4; ++i_) g_lt[i_] = lacc_[i_]; } } while (0)
#else
#define LT_PROBE_START do {} while (0)
#define LT_PROBE(i) do {} while (0)
#define LT_PROBE_STORE do {} while (0)
#endif

// Doubles of larft's M, the joins' X and the taus.
__host__ __device__ constexpr long long larft_doubles(int nb) {
  return tri_doubles(larft_padded(nb)) + (long long)larft_padded(nb) * larft_padded(nb) / 4
         + larft_padded(nb);
}

// kShared: M, X and the taus in shared memory (to nb = kInPlaceMax), so
// their accesses compile to shared loads and stores; else in `scratch`.
template <bool kShared>
__global__ void __launch_bounds__(kLarftThreads) larft_kernel(const double* __restrict__ G,
                                                              const double* __restrict__ tau,
                                                              double* __restrict__ T,
                                                              double* scratch, int nb) {
  extern __shared__ double sh[];
  const int nbp = larft_padded(nb);
  LT_PROBE_START;
  const Tri M{kShared ? sh : scratch, nbp};
  double* X = M.p + tri_doubles(nbp);          // nbp^2 / 4: the widest level's joins
  double* tz = X + (size_t)nbp * nbp / 4;      // nbp taus, zero past nb
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kLarftWarps = kLarftThreads / 32;

  // G's strict upper triangle, a warp a row of G (coalesced), and the
  // taus: into shared memory every copy in flight at once (cp.async)
  for (int r = warp; r < nbp; r += kLarftWarps) {
    for (int c = r + 1 + lane; c < nbp; c += 32) {
      double* dst = (c >> 5) == (r >> 5) ? M.at(c, r) : M.at(r, c);
      if (kShared && c < nb && r < nb) {
        cp_async8(dst, G + (size_t)r * nb + c);
      } else {
        *dst = c < nb && r < nb ? __ldg(G + (size_t)r * nb + c) : 0.0;
      }
    }
  }
  for (int k = tid; k < nbp; k += kLarftThreads) {
    if (kShared && k < nb) cp_async8(tz + k, tau + k);
    else tz[k] = k < nb ? tau[k] : 0.0;
  }
  if (kShared) {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  LT_PROBE(0);

  for (int q = warp; q < nbp / 32; q += kLarftWarps) {
    larft_diag<32>(M.at(32 * q, 32 * q), M.ld(32 * q), tz + 32 * q, lane);
  }
  __syncthreads();
  LT_PROBE(1);
  larft_joins<kLarftThreads, false>(M, X, nbp);
  LT_PROBE(2);

  for (int r = warp; r < nb; r += kLarftWarps) {
    for (int c = lane; c < nb; c += 32) {
      T[(size_t)r * nb + c] = r <= c ? M(r, c) : 0.0;
    }
  }
  LT_PROBE(3);
  LT_PROBE_STORE;
}

// The live blocks s = slo .. shi of wave w of the two-stage backtransform
// (J = Kmax - 1 - s, k = w - 2 s; g = b, so nJ = Kmax), in the closed form
// of kernels/band_reduce.py::q2_wave_range:
//   shi = min(w / 2, Kmax - 1),
//   slo = max(0, ceil((w - Kmax + 1) / 2),
//             ceil(((Kmax - 1) b + w b - (n - 3)) / (3 b))).
__device__ __forceinline__ long long q2_ceil_div(long long a, long long d) {
  return a <= 0 ? -((-a) / d) : (a + d - 1) / d;
}
__device__ __forceinline__ void q2_wave_range(int n, int b, int Kmax, int w, int& slo,
                                              int& shi) {
  shi = min(w / 2, Kmax - 1);
  long long lo = max(0LL, q2_ceil_div((long long)w - Kmax + 1, 2));
  lo = max(lo, q2_ceil_div((long long)(Kmax - 1 + w) * b - (n - 3), 3LL * b));
  slo = static_cast<int>(lo);
}

// (i, c) of entry e of a matrix of `cols` columns in csrc/q2_apply.cu's 16 x
// 4 tiles (tile (i / 16, c / 4) at ((i / 16) (cols / 4) + c / 4) 64,
// row-major inside).
__device__ __forceinline__ void q2_untile(int e, int cols, int& i, int& c) {
  const int tile = e >> 6, in = e & 63, tc = cols >> 2;
  i = (tile / tc) * 16 + (in >> 2);
  c = (tile % tc) * 4 + (in & 3);
}

// Phase probes of q2_blocks_t, compiled only where KERNEL_PROBES is defined
// (tools/kernel_phase_probe.py): thread 0's clock64 cycles of every block of
// threads in the loads, the Y^T store, the Gram, the diagonal blocks, the
// joins and the T store, summed over the blocks (q2_blocks_t_probe_read).
#ifdef KERNEL_PROBES
__device__ unsigned long long g_q2[8];
#define Q2_PROBE_START long long qacc_[6] = {0, 0, 0, 0, 0, 0}; long long qprev_ = clock64()
#define Q2_PROBE(i) do { if (threadIdx.x == 0) { const long long now_ = clock64(); \
    qacc_[i] += now_ - qprev_; qprev_ = now_; } } while (0)
#define Q2_PROBE_STORE do { if (threadIdx.x == 0) { \
    for (int i_ = 0; i_ < 6; ++i_) atomicAdd(&g_q2[i_], (unsigned long long)qacc_[i_]); \
    atomicAdd(&g_q2[7], 1ULL); } } while (0)
#else
#define Q2_PROBE_START do {} while (0)
#define Q2_PROBE(i) do {} while (0)
#define Q2_PROBE_STORE do {} while (0)
#endif

// q2_blocks_t: the T factor of every compact-WY block of a chunk of waves
// w0 .. w0 + nw - 1 of the two-stage backtransform
// (kernels/band_reduce.py::apply_q2_wave_blocked), and its Y^T laid out for
// csrc/q2_apply.cu: wave w = w0 + blockIdx.y, its live blocks s = slo +
// x (past shi: nothing to make) at slot blockIdx.y S + x of the chunk's
// stores.  The chunk bounds the stores: every block at once would take (b
// rounded up to 16)^2 (Kmax (Kmax + 1) / 2) doubles for T alone, 137 GB at
// n = 16384, b = 2.
// Block (J, k) holds the hop-k reflectors of the g = b sweeps J g .. J g + g - 1:
// reflector i is v_i = Vw[min(J g + i, n - 2), k, :] at window rows i ..
// i + b - 1 (Y's column i; row n - 2 of the log is zero, so sweeps past the
// last are identities), tau_i likewise from tw.  Its Gram G = Y^T Y,
// G[l, c] = sum_r Y[r, l] Y[r, c] = sum_q v_c[q] v_l[q + c - l] (l < c),
// summed over r in increasing order, then T from G as larft forms it.  Each
// matrix is zero-padded to wr = b rounded up to 16 rows and kept in
// q2_untile's tiles: T (wr x wr, zero below the diagonal and past g) in Ts,
// and Y^T (wr x ys) in Ys, Y^T(i, r) = v_i[r - i] for 0 <= r - i < b and
// zero elsewhere (the log's bits).  An identity reflector (tau = 0, v = 0)
// gets T[i, i] = 0 here, where the JAX package's inverse form gives 1: its
// column of Y is zero, so I - Y T Y^T is the same.

// Wide bands (b > 32): one block of kQ2Threads threads a reflector block.
// Y is read a slab of rows at a time (every column of the block, cp.async,
// the log's entries once) into a ring of slabs in shared memory, all but
// one slab copied ahead of the one in use; each slab's columns of Y^T are
// stored from it, and its rows added to G = Y^T Y on the FP64 tensor cores
// (mma.sync.m16n8k4, as csrc/dword_matmul.cu): G's 16 x 8 tiles that hold
// an entry above the diagonal, kQ2WarpTiles a warp, their sums in
// registers across the slabs (in rounds of kQ2WarpTiles 8 tiles past b =
// 128), each skipping the slabs whose rows cannot meet it; then the sums
// into M and larft's diagonal blocks and joins.  kShared (b <= 128): M in
// shared memory, joined in place, and the ring (4 slabs of 16 rows) in M's
// storage, idle until the sums land (84,992 bytes at b = 128: two blocks of
// threads an SM); else 3 slabs of 8 rows beside the taus, M and X in
// `scratch`, q2_t_scratch(b) a slot.
constexpr int kQ2Threads = 256;
constexpr int kQ2WarpTiles = 9;

__host__ __device__ constexpr int q2_slab_ld(int nbp) { return nbp + 4; }   // conflict-free fragments
__host__ __device__ constexpr int q2_slab_rows(bool shared) { return shared ? 16 : 8; }
__host__ __device__ constexpr int q2_ring_slabs(bool shared) { return shared ? 4 : 3; }

// Shared doubles of a wide launch: the taus, then the ring, sharing its
// storage with M when kShared.
__host__ __device__ constexpr long long q2_wide_doubles(int b, bool shared) {
  return larft_padded(b)
         + (shared ? (tri_doubles(larft_padded(b))
                          > (long long)q2_ring_slabs(true) * q2_slab_rows(true)
                                * q2_slab_ld(larft_padded(b))
                      ? tri_doubles(larft_padded(b))
                      : (long long)q2_ring_slabs(true) * q2_slab_rows(true)
                            * q2_slab_ld(larft_padded(b)))
                   : (long long)q2_ring_slabs(false) * q2_slab_rows(false)
                         * q2_slab_ld(larft_padded(b)));
}

// Global scratch doubles a slot of a wide launch takes when not kShared.
__host__ __device__ constexpr long long q2_t_scratch(int b) {
  return tri_doubles(larft_padded(b)) + (long long)larft_padded(b) * larft_padded(b) / 4;
}

// The Gram's 16 x 8 tile `id` (l0, c0): the column tiles c0 = 8 j in
// order, each with its row tiles l0 = 16 i, i <= (8 j + 7) / 16 (the ones
// holding an entry above the diagonal); j = 2 m and 2 m + 1 hold m + 1
// each, so the tiles before column tile 2 m are m (m + 1) and before 2 m +
// 1 (m + 1)^2.
__device__ __forceinline__ void q2_gram_tile(int id, int& l0, int& c0) {
  int m = static_cast<int>((sqrtf(4.0f * id + 1.0f) - 1.0f) * 0.5f);
  while (m * (m + 1) > id) --m;
  while ((m + 1) * (m + 2) <= id) ++m;
  const bool even = id < (m + 1) * (m + 1);
  c0 = 16 * m + (even ? 0 : 8);
  l0 = 16 * (id - (even ? m * (m + 1) : (m + 1) * (m + 1)));
}

// c (16 x 8) += a (16 x 4) b (4 x 8).  Lane = 4 g + t holds a[h] = A[g +
// 8 h][t], b = B[t][g] and c[2 h + v] = C[g + 8 h][2 t + v].
__device__ __forceinline__ void q2_mma(double (&c)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kShared>
__global__ void __launch_bounds__(kQ2Threads, 2)
q2_blocks_t_wide(const double* __restrict__ Vw, const double* __restrict__ tw, double* Ts,
                 double* Ys, double* scratch, int n, int b, int Kmax, int ys, int w0, int S) {
  extern __shared__ double sh[];
  constexpr int kSlab = q2_slab_rows(kShared), kDepth = q2_ring_slabs(kShared);
  const int w = w0 + static_cast<int>(blockIdx.y);
  int slo, shi;
  q2_wave_range(n, b, Kmax, w, slo, shi);
  const int s = slo + static_cast<int>(blockIdx.x);
  if (s > shi) return;                       // past the wave's blocks
  Q2_PROBE_START;
  const int J = Kmax - 1 - s, k = w - 2 * s;
  const int g = b, wr = (g + 15) & ~15, h = 2 * b - 1, nbp = larft_padded(b);
  const int sld = q2_slab_ld(nbp);
  const size_t blk = (size_t)blockIdx.y * S + blockIdx.x;
  double* T = Ts + blk * wr * wr;
  double* Y = Ys + blk * wr * ys;
  double* tz = sh;                           // nbp taus, zero past g
  double* ring = tz + nbp;                   // kDepth slabs of kSlab rows of Y, rows sld apart
  const Tri M{kShared ? ring : scratch + blk * q2_t_scratch(b), nbp};
  double* X = kShared ? nullptr : M.p + tri_doubles(nbp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  auto vrow = [&](int i) {
    return Vw + ((size_t)min(J * g + i, n - 2) * Kmax + k) * b;
  };
  for (int i = tid; i < nbp; i += kQ2Threads) {
    tz[i] = i < g ? __ldg(tw + (size_t)min(J * g + i, n - 2) * Kmax + k) : 0.0;
  }
  // Y's rows r0 .. r0 + kSlab - 1 into ring slot `at`: kSlab threads a
  // column, along v_i
  auto stage = [&](int r0, int at) {
    double* sb = ring + at * kSlab * sld;
    for (int idx = tid; idx < kSlab * nbp; idx += kQ2Threads) {
      const int i = idx / kSlab, rho = idx % kSlab, q = r0 + rho - i;
      double* dst = sb + rho * sld + i;
      if (i < g && q >= 0 && q < b) cp_async8(dst, vrow(i) + q);
      else *dst = 0.0;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  const int mt = nbp / 16, tiles = mt * (mt + 1);
  for (int round = 0; round * 8 * kQ2WarpTiles < tiles; ++round) {
    // this warp's tiles of the round, their sums in registers
    int l0[kQ2WarpTiles], c0[kQ2WarpTiles];
    double acc[kQ2WarpTiles][4];
#pragma unroll
    for (int u = 0; u < kQ2WarpTiles; ++u) {
      const int id = round * 8 * kQ2WarpTiles + u * 8 + warp;
      if (id < tiles) q2_gram_tile(id, l0[u], c0[u]);
      else l0[u] = c0[u] = nbp;              // none: never active, never stored
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[u][x] = 0.0;
    }
    const int rows = round == 0 ? ys : h;   // round 0 also stores Y^T
    const int slabs = (rows + kSlab - 1) / kSlab;
    for (int sl = 0; sl < kDepth - 1; ++sl) {
      if (sl < slabs) stage(sl * kSlab, sl);
      else asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int sl = 0; sl < slabs; ++sl) {
      const int r0 = sl * kSlab, at = sl % kDepth;
      cp_wait<kDepth - 2>();
      __syncthreads();                       // slab sl in; slab sl - 1 done with
      if (sl + kDepth - 1 < slabs) stage(r0 + (kDepth - 1) * kSlab, (sl + kDepth - 1) % kDepth);
      else asm volatile("cp.async.commit_group;\n" ::);
      Q2_PROBE(0);
      const double* sb = ring + at * kSlab * sld;
      if (round == 0) {
        // Y^T's columns r0 .. r0 + 4 nj - 1: the tiles (ti, r0 / 4 + j), in pairs
        const int nj = min(kSlab, ys - r0) / 4;
        for (int e = 2 * tid; e < (wr / 16) * nj * 64; e += 2 * kQ2Threads) {
          const int ti = e / (nj * 64), rem = e - ti * nj * 64, j = rem >> 6, in = rem & 63;
          const int i = ti * 16 + (in >> 2), rho = 4 * j + (in & 3);
          reinterpret_cast<double2*>(Y + ((size_t)ti * (ys / 4) + r0 / 4 + j) * 64 + in)[0] =
              make_double2(sb[rho * sld + i], sb[(rho + 1) * sld + i]);
        }
      }
      Q2_PROBE(1);
      if (r0 < h) {
#pragma unroll
        for (int u = 0; u < kQ2WarpTiles; ++u) {
          // the tile's rows that can be nonzero: c0 .. l0 + 15 + b - 1
          if (c0[u] < g && r0 <= l0[u] + b + 14 && r0 + kSlab - 1 >= c0[u]) {
#pragma unroll
            for (int kk = 0; kk < kSlab; kk += 4) {
              const double* row = sb + (kk + tq) * sld;
              q2_mma(acc[u], row[l0[u] + gq], row[l0[u] + gq + 8], row[c0[u] + gq]);
            }
          }
        }
      }
      Q2_PROBE(2);
    }
    __syncthreads();                         // every slab read: the ring's storage is M's
    // the sums into M: above the diagonal only, transposed inside a
    // diagonal block
#pragma unroll
    for (int u = 0; u < kQ2WarpTiles; ++u) {
      if (l0[u] >= nbp) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int l = l0[u] + gq + 8 * (x >> 1), c = c0[u] + 2 * tq + (x & 1);
        if (l < c) {
          if ((l >> 5) == (c >> 5)) M(c, l) = acc[u][x];
          else M(l, c) = acc[u][x];
        }
      }
    }
  }
  __syncthreads();
  Q2_PROBE(2);

  for (int q = warp; q < nbp / 32; q += kQ2Threads / 32) {
    larft_diag<32>(M.at(32 * q, 32 * q), M.ld(32 * q), tz + 32 * q, lane);
  }
  __syncthreads();
  Q2_PROBE(3);
  larft_joins<kQ2Threads, kShared>(M, X, nbp);
  Q2_PROBE(4);
  for (int e = 2 * tid; e < wr * wr; e += 2 * kQ2Threads) {
    int r, c;
    q2_untile(e, wr, r, c);                  // c even: (r, c) and (r, c + 1)
    const double* mr = M.at(r, 0);
    reinterpret_cast<double2*>(T + e)[0] =
        make_double2(r <= c && c < g ? mr[c] : 0.0, r <= c + 1 && c + 1 < g ? mr[c + 1] : 0.0);
  }
  Q2_PROBE(5);
  Q2_PROBE_STORE;
}

// Narrow bands (b <= 32): a team of L lanes (b rounded up to a power of
// two) a reflector block, kQ2TeamThreads / L blocks a block of threads (a
// warp a block at b > 16, several a warp below): each team copies its v's
// and taus into shared memory (cp.async), forms its Gram a column a lane
// (into M below the diagonal) and T by one diagonal block (larft_diag<L>:
// no join); then the whole block of threads stores the live teams' T and
// Y^T, whose slots are consecutive, in one coalesced sweep each (16-byte
// streaming stores: mostly the padding of small b, never read back here).  A team's v's and M take rows of L + 1 doubles (an odd stride:
// a lane a row without bank conflicts); per team 2 L (L + 1) + L doubles of
// shared memory.
constexpr int kQ2TeamThreads = 128;

__host__ __device__ constexpr int q2_team_width(int b) {
  return b <= 2 ? 2 : b <= 4 ? 4 : b <= 8 ? 8 : b <= 16 ? 16 : 32;
}

__host__ __device__ constexpr long long q2_team_doubles(int L) {
  return 2LL * L * (L + 1) + L;
}

template <int L>
__global__ void __launch_bounds__(kQ2TeamThreads)
q2_blocks_t_teams(const double* __restrict__ Vw, const double* __restrict__ tw, double* Ts,
                  double* Ys, int n, int b, int Kmax, int ys, int w0, int S) {
  extern __shared__ double sh[];
  constexpr int kTeams = kQ2TeamThreads / L;
  constexpr int ld = L + 1;
  const int tid = threadIdx.x, team = tid / L, r = tid % L;
  const int w = w0 + static_cast<int>(blockIdx.y);
  int slo, shi;
  q2_wave_range(n, b, Kmax, w, slo, shi);
  const int x0 = static_cast<int>(blockIdx.x) * kTeams;
  // the live teams: x0 .. x0 + nlive - 1 (a slot inside the chunk's S and
  // a block inside the wave)
  const int nlive = min(min(kTeams, S - x0), shi - slo - x0 + 1);
  if (nlive <= 0) return;
  Q2_PROBE_START;
  const bool live = team < nlive;
  const int s = slo + x0 + team, J = Kmax - 1 - s, k = w - 2 * s;
  const int g = b, wr = (g + 15) & ~15;
  double* vs = sh + team * q2_team_doubles(L);   // v_i at i ld
  double* Mt = vs + L * ld;                       // L x ld: T and G transposed
  double* tz = Mt + L * ld;
  if (live) {
    for (int idx = r; idx < g * b; idx += L) {
      const int i = idx / b, q = idx - i * b;
      cp_async8(vs + i * ld + q, Vw + ((size_t)min(J * g + i, n - 2) * Kmax + k) * b + q);
    }
    tz[r] = r < g ? __ldg(tw + (size_t)min(J * g + r, n - 2) * Kmax + k) : 0.0;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  Q2_PROBE(0);
  if (live) {
    // column r of G: G[l][r] = sum_q v_r[q] v_l[q + r - l], l < r, into
    // Mt[r][l], every l's sum in a register, q ascending; zero past g
    double acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = 0.0;
    if (r < g) {
      for (int q = 0; q < b; ++q) {
        const double vr = vs[r * ld + q];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          // lane r reads v_l[q + r - l]: neighbouring lanes, neighbouring words
          if (l < r && q + r - l < b) acc[l] = __fma_rn(vr, vs[l * ld + q + r - l], acc[l]);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l < r) Mt[r * ld + l] = acc[l];
    }
  }
  __syncwarp();
  Q2_PROBE(2);
  if (live) larft_diag<L>(Mt, ld, tz, r);
  __syncthreads();
  Q2_PROBE(3);
  // the live teams' slots, consecutive: Y^T, then T, two entries of a
  // tile's row a thread
  const size_t blk0 = (size_t)blockIdx.y * S + x0;
  double* Y = Ys + blk0 * wr * ys;
  for (int e = 2 * tid; e < nlive * wr * ys; e += 2 * kQ2TeamThreads) {
    const int t = e / (wr * ys);
    int i, c;
    q2_untile(e - t * wr * ys, ys, i, c);
    const double* v = sh + t * q2_team_doubles(L) + i * ld - i;   // v_i[c - i] at v[c]
    const bool row = i < g;
    __stcs(reinterpret_cast<double2*>(Y + e),
           make_double2(row && c >= i && c - i < b ? v[c] : 0.0,
                        row && c + 1 >= i && c + 1 - i < b ? v[c + 1] : 0.0));
  }
  Q2_PROBE(1);
  double* T = Ts + blk0 * wr * wr;
  for (int e = 2 * tid; e < nlive * wr * wr; e += 2 * kQ2TeamThreads) {
    const int t = e / (wr * wr);
    int i, c;
    q2_untile(e - t * wr * wr, wr, i, c);
    const double* m = sh + t * q2_team_doubles(L) + L * ld + i * ld;
    __stcs(reinterpret_cast<double2*>(T + e),
           make_double2(i <= c && c < g ? m[c] : 0.0, i <= c + 1 && c + 1 < g ? m[c + 1] : 0.0));
  }
  Q2_PROBE(5);
  Q2_PROBE_STORE;
}

}  // namespace

// (blocks of every column step instance one SM holds at `smem` dynamic
// shared bytes, the SM count, the shared bytes a block may opt into) of the
// current device, into out[0..2].  Opts the instances into that much shared
// memory first (a launch past 48 KB needs it), and fails where the device
// takes no cooperative launch.
extern "C" int column_step_occupancy(int smem, void* out) {
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const void* fns[3] = {(const void*)column_step_kernel<false, true>,
                        (const void*)column_step_kernel<true, false>,
                        (const void*)column_step_kernel<true, true>};
  int least = 1 << 30;
  for (const void* fn : fns) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    least = blocks < least ? blocks : least;
  }
  int* o = static_cast<int*>(out);
  o[0] = least;
  o[1] = sms;
  o[2] = optin;
  return 0;
}

template <bool kW, bool kR>
static int launch_step(const void* As, long long lda, void* Vp, void* Wp, int ld,
                       const void* y, void* te, void* pq, void* ws, int m, int j, int jj,
                       int grid, int slice, int cached, int smem, void* stream) {
  const int c = j + (kW ? 1 : 0), jr = jj + (kW ? 1 : 0);
  const int nold = kW ? jj : jr;
  const int kc = cached < nold ? cached : nold;
  const long long need = 8LL * step_shared(kW ? jj : 0, kR ? jr : 0, slice, kc);
  if (m < 2 || j < 0 || jj < 0 || c > m - 2 || (kW && j > m - 3)
      || (kR ? jr : jj) >= kMaxPanel
      || ld < m || grid < 1 || slice < 1 || (long long)grid * slice < m || cached < 0
      || smem < need || (kW && y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Step st{static_cast<const double*>(As), lda, static_cast<double*>(Vp),
          static_cast<double*>(Wp), ld, static_cast<const double*>(y),
          static_cast<double*>(te), static_cast<double*>(pq), static_cast<double*>(ws),
          m, j, jj, slice, cached};
  void* args[] = {&st};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)column_step_kernel<kW, kR>, dim3(grid), dim3(kThreads),
      args, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no error for the next one
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The column step's three launches, one argument list (kernels/
// householder_panel.py's _CudaSteps):
// As: the bucket's (m, m) f64 matrix, unit column stride, row stride lda.
// Vp, Wp: the panel's reflector and W rows (row stride ld >= m), rows < jj
// complete; y: M's (m,) output (the W half; may be null for the reflector
// alone); te: the bucket's (ncols, 2) (tau, alpha); pq: 2 nb doubles (in:
// p, q of column j; out: those of the reflector made); ws: grid (2 nb + 2)
// + 2 doubles of scratch.  grid, slice, cached and smem from the plan
// (kernels/householder_panel.py::column_plan after column_step_occupancy on
// this device): grid blocks co-resident, grid * slice >= m.  One cooperative
// kernel on `stream`; allocates nothing; returns the launch's cudaError_t.
//
// column_reflector_launch: the reflector of column j (panel row jj; at
// j = m - 2 the identity reflector).
extern "C" int column_reflector_launch(const void* As, long long lda, void* Vp, void* Wp,
                                       int ld, const void* y, void* te, void* pq, void* ws,
                                       int m, int j, int jj, int grid, int slice, int cached,
                                       int smem, void* stream) {
  return launch_step<false, true>(As, lda, Vp, Wp, ld, y, te, pq, ws, m, j, jj, grid, slice,
                                  cached, smem, stream);
}

// column_w_launch: the W row of column j (panel row jj), j <= m - 3.
extern "C" int column_w_launch(const void* As, long long lda, void* Vp, void* Wp, int ld,
                               const void* y, void* te, void* pq, void* ws, int m, int j,
                               int jj, int grid, int slice, int cached, int smem,
                               void* stream) {
  return launch_step<true, false>(As, lda, Vp, Wp, ld, y, te, pq, ws, m, j, jj, grid, slice,
                                  cached, smem, stream);
}

// column_w_reflector_launch: the W row of column j (panel row jj), then the
// reflector of column j + 1 (panel row jj + 1).
extern "C" int column_w_reflector_launch(const void* As, long long lda, void* Vp, void* Wp,
                                         int ld, const void* y, void* te, void* pq, void* ws,
                                         int m, int j, int jj, int grid, int slice,
                                         int cached, int smem, void* stream) {
  return launch_step<true, true>(As, lda, Vp, Wp, ld, y, te, pq, ws, m, j, jj, grid, slice,
                                 cached, smem, stream);
}

// `syncs` grid syncs in a cooperative launch of `grid` blocks of the column
// step's width (chip_smoke.py times it at the column step's grid).
extern "C" int grid_sync_probe_launch(int grid, int syncs, void* stream) {
  void* args[] = {&syncs};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)grid_sync_probe_kernel, dim3(grid), dim3(kThreads), args,
      0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of M, X and the taus that a larft launch keeps in shared memory
// (0: they go to the global scratch instead; nb > kInPlaceMax).
extern "C" int larft_shared_bytes(int nb) {
  return nb > 0 && larft_padded(nb) <= kInPlaceMax ? static_cast<int>(8 * larft_doubles(nb)) : 0;
}

// G: (nb, nb) f64 contiguous Gram of the panel (its strict upper triangle
// read); tau: (nb,); T: (nb, nb) out, contiguous.  scratch:
// larft_doubles(nb) doubles (kernels/householder_panel.py::
// larft_scratch_doubles) when larft_shared_bytes(nb) is 0, else unused (may
// be null).  One block of kLarftThreads; one kernel on `stream`.
extern "C" int larft_launch(const void* G, const void* tau, void* T, void* scratch, int nb,
                            void* stream) {
  if (nb <= 0 || nb > 46340) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = larft_shared_bytes(nb);
  if (smem == 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        larft_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const double* g = static_cast<const double*>(G);
  const double* t = static_cast<const double*>(tau);
  double* out = static_cast<double*>(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 0) {
    larft_kernel<true><<<1, kLarftThreads, static_cast<size_t>(smem), st>>>(g, t, out, nullptr, nb);
  } else {
    larft_kernel<false><<<1, kLarftThreads, 0, st>>>(g, t, out, static_cast<double*>(scratch), nb);
  }
  return static_cast<int>(cudaGetLastError());
}

// A q2_blocks_t launch at band b: its kernel, threads, reflector blocks a
// block of threads and dynamic shared bytes; `staged`: M in shared memory
// (a wide band; a narrow band always is).
struct Q2Instance {
  const void* fn;
  int threads, per_block;
  long long smem;
};

static Q2Instance q2_instance(int b, int staged) {
  if (b <= 32) {
    const int L = q2_team_width(b), teams = kQ2TeamThreads / L;
    const void* fns[5] = {(const void*)q2_blocks_t_teams<2>, (const void*)q2_blocks_t_teams<4>,
                          (const void*)q2_blocks_t_teams<8>, (const void*)q2_blocks_t_teams<16>,
                          (const void*)q2_blocks_t_teams<32>};
    const int at = L == 2 ? 0 : L == 4 ? 1 : L == 8 ? 2 : L == 16 ? 3 : 4;
    return {fns[at], kQ2TeamThreads, teams, 8LL * teams * q2_team_doubles(L)};
  }
  return {staged ? (const void*)q2_blocks_t_wide<true> : (const void*)q2_blocks_t_wide<false>,
          kQ2Threads, 1, 8LL * q2_wide_doubles(b, staged != 0)};
}

// Whether q2_blocks_t keeps M in shared memory at band b on the current
// device (1: a narrow band, or a wide one whose M fits what a block may opt
// into and joins in place, b <= 128; 0: it needs the scratch), into *out.
extern "C" int q2_blocks_t_staged(int b, void* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(out) =
      b <= 32 || (larft_padded(b) <= kInPlaceMax && q2_instance(b, 1).smem <= optin) ? 1 : 0;
  return 0;
}

// (blocks of threads an SM holds by the occupancy API, reflector blocks a
// block of threads, its threads, its dynamic shared bytes) of the
// q2_blocks_t launch at band b on the current device, into out[0..3].
extern "C" int q2_blocks_t_occupancy(int b, void* out) {
  int staged = 0;
  cudaError_t err = static_cast<cudaError_t>(q2_blocks_t_staged(b, &staged));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Q2Instance q = q2_instance(b, staged);
  err = cudaFuncSetAttribute(q.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q.smem));
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, q.fn, q.threads,
                                                        static_cast<size_t>(q.smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = blocks;
  o[1] = q.per_block;
  o[2] = q.threads;
  o[3] = static_cast<int>(q.smem);
  return 0;
}

// Vw: (n - 1, Kmax, b) f64 and tw: (n - 1, Kmax), the chase's reflector
// log (kernels/band_reduce.py::band_to_tridiag_wave), contiguous; the
// chunk: waves w0 .. w0 + nw - 1, S slots a wave; Ts: nw S blocks of wr x
// wr f64 out (wr = (b + 15) & ~15); Ys: as many blocks of wr x ys f64 out,
// ys the columns csrc/q2_apply.cu reads (y_stride,
// kernels/band_reduce.py::_q2_y_stride); both in 16 x 4 tiles, a slot past
// its wave's blocks left unwritten.  scratch: nw S q2_t_scratch(b) doubles
// (kernels/band_reduce.py::q2_t_scratch_doubles) where q2_blocks_t_staged(b)
// is 0, else unused (may be null).  One kernel on `stream`: a grid of
// ceil(S / per_block) x nw blocks of threads (q2_instance).
extern "C" int q2_blocks_t_launch(const void* Vw, const void* tw, void* Ts, void* Ys,
                                  void* scratch, int n, int b, int Kmax, int ys, int w0, int nw,
                                  int S, void* stream) {
  if (n < 3 || b < 2 || b > 1024 || Kmax != (n - 3) / b + 1 || Kmax > 65535
      || ys < 2 * b + 2 || ys % 4 != 0 || w0 < 0 || nw < 1 || nw > 65535 || S < 1
      || w0 + nw > 3 * Kmax - 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int staged = 0;
  cudaError_t err = static_cast<cudaError_t>(q2_blocks_t_staged(b, &staged));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!staged && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Q2Instance q = q2_instance(b, staged);
  if (q.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(q.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(q.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + q.per_block - 1) / q.per_block, nw);
  const size_t smem = static_cast<size_t>(q.smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* v = static_cast<const double*>(Vw);
  const double* t = static_cast<const double*>(tw);
  double* T = static_cast<double*>(Ts);
  double* Y = static_cast<double*>(Ys);
  if (b > 32) {
    if (staged) {
      q2_blocks_t_wide<true><<<grid, q.threads, smem, st>>>(v, t, T, Y, nullptr, n, b, Kmax, ys,
                                                           w0, S);
    } else {
      q2_blocks_t_wide<false><<<grid, q.threads, smem, st>>>(
          v, t, T, Y, static_cast<double*>(scratch), n, b, Kmax, ys, w0, S);
    }
  } else {
    switch (q2_team_width(b)) {
      case 2: q2_blocks_t_teams<2><<<grid, q.threads, smem, st>>>(v, t, T, Y, n, b, Kmax, ys, w0, S); break;
      case 4: q2_blocks_t_teams<4><<<grid, q.threads, smem, st>>>(v, t, T, Y, n, b, Kmax, ys, w0, S); break;
      case 8: q2_blocks_t_teams<8><<<grid, q.threads, smem, st>>>(v, t, T, Y, n, b, Kmax, ys, w0, S); break;
      case 16: q2_blocks_t_teams<16><<<grid, q.threads, smem, st>>>(v, t, T, Y, n, b, Kmax, ys, w0, S); break;
      default: q2_blocks_t_teams<32><<<grid, q.threads, smem, st>>>(v, t, T, Y, n, b, Kmax, ys, w0, S); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef KERNEL_PROBES
// The probed copy's larft phase cycles (thread 0's four).
extern "C" int larft_probe_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_lt, sizeof(g_lt)));
}

// The probed copy's q2_blocks_t phase cycles summed over every block of
// threads' thread 0 since the last read (six phases, then the blocks of
// threads counted), and the sums zeroed.
extern "C" int q2_blocks_t_probe_read(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_q2, sizeof(g_q2));
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_q2, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
