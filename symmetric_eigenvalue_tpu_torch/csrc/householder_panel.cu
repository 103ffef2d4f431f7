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
//    port's torch loop): larft, one launch a panel.
//  - symmetric_eigenvalue_tpu/kernels/band_reduce.py::apply_q2_wave_blocked
//    (:509), the T factors its wave body (:551-604) forms a wave at a time:
//    q2_blocks_t, the T (and the Y^T, laid out for the waves) of every
//    block of a chunk of waves in one launch before the chunk's first wave
//    (the waves themselves are csrc/q2_apply.cu).
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
// larft (and q2_blocks_t, a batched form of the same recurrence over a Gram
// it builds itself): T (nb x nb, upper) with T[k,k] = tau_k and
// T[:k,k] = -tau_k T[:k,:k] G[:k,k] for k = 0..nb-1, from the panel's Gram G.
// It is latency-bound: nb-1 dependent triangular matvecs.  One block, one
// thread a row of T; T's columns packed in shared memory (nb (nb+1)/2
// doubles, 66 KB at nb = 128) beside G's column k, staged each step, or,
// past what a block may hold, in a global scratch; at step k every thread
// walks l = 0..k-1 together, so the threads read neighbouring entries of
// column l of T and one broadcast G[l,k].
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

// T's columns from the Gram of nb reflectors: T[k,k] = tau_k and
// T[:k,k] = -tau_k T[:k,:k] G[:k,k] for k = 0..nb-1, with T(r, c) at
// tc(r, c) (shared or global, written by this block only) and column k of G
// staged into gk by stage(k, gk) (every thread calls it; it fills gk[l],
// l < k).  Every thread of the block calls it; one thread a row of T: at
// step k the threads walk l = 0..k-1 together, so they read neighbouring
// entries of column l of T and one broadcast G[l,k].
template <class Stage, class Store>
__device__ __forceinline__ void larft_columns(Stage stage, const double* __restrict__ tau,
                                              double* gk, Store tc, int nb) {
  const int tid = threadIdx.x;
  if (tid == 0) tc(0, 0) = tau[0];
  for (int k = 1; k < nb; ++k) {
    stage(k, gk);
    __syncthreads();                         // gk and T's columns < k
    const double ntau = -tau[k];
    for (int r0 = 0; r0 < k; r0 += blockDim.x) {
      const int r = r0 + tid;
      double acc = 0.0;
      // rows r < k, summed over l = r..k-1 (T is upper triangular)
#pragma unroll 8
      for (int l = r0; l < k; ++l) {
        if (r <= l) acc = __fma_rn(tc(r, l), gk[l], acc);
      }
      if (r < k) tc(r, k) = __dmul_rn(acc, ntau);
    }
    if (tid == 0) tc(k, k) = tau[k];
    __syncthreads();                         // before gk is overwritten
  }
}

// T's columns packed, column l at l (l + 1) / 2.
struct PackedT {
  double* p;
  __device__ __forceinline__ double& operator()(int r, int c) const {
    return p[(size_t)c * (c + 1) / 2 + r];
  }
};

// T row-major with row stride ld.
struct DenseT {
  double* p;
  int ld;
  __device__ __forceinline__ double& operator()(int r, int c) const {
    return p[(size_t)r * ld + c];
  }
};

__global__ void larft_kernel(const double* __restrict__ G, const double* __restrict__ tau,
                             double* __restrict__ T, double* gscratch, int nb,
                             int use_shared) {
  extern __shared__ double sh[];
  double* gk = use_shared ? sh : gscratch;   // column k of G, staged
  const PackedT tc{gk + nb};
  const int tid = threadIdx.x;
  larft_columns(
      [&](int k, double* col) {
        for (int l = tid; l < k; l += blockDim.x) col[l] = G[(size_t)l * nb + k];
      },
      tau, gk, tc, nb);
  __syncthreads();
  for (int idx = tid; idx < nb * nb; idx += blockDim.x) {
    const int r = idx / nb, c = idx - r * nb;
    T[idx] = r <= c ? tc(r, c) : 0.0;
  }
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

// q2_blocks_t: the T factor of every compact-WY block of a chunk of waves
// w0 .. w0 + nw - 1 of the two-stage backtransform
// (kernels/band_reduce.py::apply_q2_wave_blocked), and its Y^T laid out for
// csrc/q2_apply.cu, one block of threads a reflector block: blockIdx.y the
// wave w = w0 + blockIdx.y, blockIdx.x its block s = slo + blockIdx.x
// (past shi: nothing to make, it returns), at slot blockIdx.y S +
// blockIdx.x of the chunk's stores.  The chunk bounds the stores: every
// block at once would take (b rounded up to 16)^2 (Kmax (Kmax + 1) / 2)
// doubles for T alone, 137 GB at n = 16384, b = 2.
// Block (J, k) holds the hop-k reflectors of the g = b sweeps J g .. J g + g - 1:
// reflector i is v_i = Vw[min(J g + i, n - 2), k, :] at window rows i ..
// i + b - 1 (Y's column i; row n - 2 of the log is zero, so sweeps past the
// last are identities), tau_i likewise from tw.  The Gram is made from that
// band structure as the recurrence asks for its columns, G[l, c] = sum_q
// v_c[q] v_l[q + c - l] (l < c).  Each matrix is zero-padded to wr = b
// rounded up to 16 rows and kept in csrc/q2_apply.cu's 16 x 4 tiles (tile
// (i / 16, c / 4) of a matrix of `cols` columns at ((i / 16) (cols / 4) +
// c / 4) 64, row-major inside): T (wr x wr, zero below the diagonal and
// past g) in Ts, and Y^T (wr x ys) in Ys, Y^T(i, r) = v_i[r - i] for 0 <=
// r - i < b and zero elsewhere.  An identity reflector (tau = 0, v = 0)
// gets T[i, i] = 0 here, where the JAX package's inverse form gives 1: its
// column of Y is zero, so I - Y T Y^T is the same.  staged: the block's
// v's and T's packed columns in shared memory (else v read through the
// read-only cache and T built in a global scratch, read back through L1).
__global__ void q2_blocks_t_kernel(const double* __restrict__ Vw, const double* __restrict__ tw,
                                   double* Ts, double* Ys, double* scratch, int n, int b,
                                   int Kmax, int ys, int w0, int S, int staged) {
  extern __shared__ double sh[];
  const int w = w0 + static_cast<int>(blockIdx.y);
  int slo, shi;
  q2_wave_range(n, b, Kmax, w, slo, shi);
  const int s = slo + static_cast<int>(blockIdx.x);
  if (s > shi) return;                       // past the wave's blocks
  const int J = Kmax - 1 - s, k = w - 2 * s;
  const int g = b, wr = (g + 15) & ~15;
  const size_t blk = (size_t)blockIdx.y * S + blockIdx.x;
  double* T = Ts + blk * wr * wr;
  double* Y = Ys + blk * wr * ys;
  // (i, c) of entry e of a tiled matrix of `cols` columns
  auto untile = [](int e, int cols, int& i, int& c) {
    const int tile = e >> 6, in = e & 63, tc = cols >> 2;
    i = (tile / tc) * 16 + (in >> 2);
    c = (tile % tc) * 4 + (in & 3);
  };
  double* taus = sh;
  double* gk = taus + g;
  double* vs = gk + g;                       // v_i at i b (staged)
  const int tid = threadIdx.x;
  auto vrow = [&](int i) {
    return Vw + ((size_t)min(J * g + i, n - 2) * Kmax + k) * b;
  };
  for (int i = tid; i < g; i += blockDim.x) {
    taus[i] = __ldg(tw + (size_t)min(J * g + i, n - 2) * Kmax + k);
  }
  if (staged) {
    for (int idx = tid; idx < g * b; idx += blockDim.x) {
      vs[idx] = __ldg(vrow(idx / b) + idx % b);
    }
  }
  __syncthreads();
  auto v = [&](int i, int q) { return staged ? vs[i * b + q] : __ldg(vrow(i) + q); };
  for (int e = tid; e < wr * ys; e += blockDim.x) {
    int i, r;
    untile(e, ys, i, r);
    const int q = r - i;
    Y[e] = i < g && q >= 0 && q < b ? v(i, q) : 0.0;
  }
  auto stage = [&](int c, double* col) {
    for (int l = tid; l < c; l += blockDim.x) {
      double s = 0.0;
      for (int q = 0; q < b - (c - l); ++q) s = __fma_rn(v(c, q), v(l, q + c - l), s);
      col[l] = s;
    }
  };
  auto store = [&](auto tc) {
    __syncthreads();
    for (int e = tid; e < wr * wr; e += blockDim.x) {
      int r, c;
      untile(e, wr, r, c);
      T[e] = r <= c && c < g ? tc(r, c) : 0.0;
    }
  };
  if (staged) {
    const PackedT tc{vs + g * b};
    larft_columns(stage, taus, gk, tc, g);
    store(tc);
  } else {
    const DenseT tc{scratch + blk * g * g, g};
    larft_columns(stage, taus, gk, tc, g);
    store(tc);
  }
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

// Bytes of T's packed columns and G's staged column that a larft launch
// keeps in shared memory (0: they go to the global scratch instead).
extern "C" int larft_shared_bytes(int nb) {
  const long long bytes = 8LL * (nb + (long long)nb * (nb + 1) / 2);
  return bytes <= 200LL * 1024 ? static_cast<int>(bytes) : 0;
}

// G: (nb, nb) f64 contiguous Gram of the panel; tau: (nb,); T: (nb, nb) out,
// contiguous.  gscratch: nb + nb (nb + 1) / 2 doubles when
// larft_shared_bytes(nb) is 0, else unused (may be null).  One block; one
// kernel on `stream`.
extern "C" int larft_launch(const void* G, const void* tau, void* T, void* gscratch,
                            int nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = larft_shared_bytes(nb);
  if (smem == 0 && gscratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        larft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = nb >= 1024 ? 1024 : ((nb + 31) / 32) * 32;
  larft_kernel<<<1, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(G), static_cast<const double*>(tau),
      static_cast<double*>(T), static_cast<double*>(gscratch), nb, smem > 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes of a q2_blocks_t launch at g = b: its taus and G's staged
// column, with the block's v's and T's packed columns when `staged`.
static long long q2_blocks_t_bytes(int g, int staged) {
  return 8LL * (2LL * g + (staged ? (long long)g * g + (long long)g * (g + 1) / 2 : 0));
}

// Whether q2_blocks_t stages a block in shared memory at band b on the
// current device (1: it fits in what a block may opt into; 0: it needs
// the scratch), into *out.
extern "C" int q2_blocks_t_staged(int b, void* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(out) = q2_blocks_t_bytes(b, 1) <= optin ? 1 : 0;
  return 0;
}

// Vw: (n - 1, Kmax, b) f64 and tw: (n - 1, Kmax), the chase's reflector
// log (kernels/band_reduce.py::band_to_tridiag_wave), contiguous; the
// chunk: waves w0 .. w0 + nw - 1, S slots a wave; Ts: nw S blocks of wr x
// wr f64 out (wr = (b + 15) & ~15); Ys: as many blocks of wr x ys f64 out,
// ys the columns csrc/q2_apply.cu reads (y_stride,
// kernels/band_reduce.py::_q2_y_stride); both in 16 x 4 tiles, a slot past
// its wave's blocks left unwritten.  scratch: nw S b^2 doubles where
// q2_blocks_t_staged(b) is 0, else unused (may be null).  One kernel on
// `stream`: a grid of S x nw blocks of threads.
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
  const int smem = static_cast<int>(q2_blocks_t_bytes(b, staged));
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(q2_blocks_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = ((b + 31) / 32) * 32;
  q2_blocks_t_kernel<<<dim3(S, nw), threads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(Vw), static_cast<const double*>(tw), static_cast<double*>(Ts),
      static_cast<double*>(Ys), static_cast<double*>(scratch), n, b, Kmax, ys, w0, S, staged);
  return static_cast<int>(cudaGetLastError());
}
