// The two-stage front end's device loops: the wavefront bulge chase and the
// band reduction's panel QR.
//
// Replaces two device loops of the JAX package that hold no pallas_call:
//  - symmetric_eigenvalue_tpu/kernels/band_reduce.py::band_to_tridiag_wave
//    (:254; its lax.fori_loop over the waves at :294, the wave body at
//    :322-408).  JAX compiles the loop into one program; the port drove it
//    from Python, a wave at a time (~20 launches and two 2-D index writes a
//    wave, 12,280 waves at n=4096).  Here: band_chase, ONE cooperative
//    launch for the whole chase.
//  - _reduce_block's column loop (:67-86, col_body :71): the Householder QR
//    of a b-column panel, one launch a panel (panel_qr).
//
// band_chase.  The state is the symmetric matrix in band storage: entry
// (i, j), |i - j| <= H = 3b - 2, at P[(i + 2b) * (6b - 3) + j - i + H],
// rows -2b .. n + 3b - 1 (the windows and their mirrors never leave that
// band or those rows; the padding stays zero).  That is 104 MB at
// n = 16384, b = 128, where the padded square would be 2.3 GB, and the
// same function: the chase reads and writes nothing outside the band.  The
// launch packs B's band into P, runs every wave, then reads d and e off P.
// Wave t (t = 0 .. 3(n-3)) has the live slots s = 0 .. W_t - 1 of the
// closed-form schedule (wave_width): jj = t/3 - s, kk = t%3 + 3s, rows
// r .. r + b - 1 with r = jj + kk b + 1, window columns r - 2b + 1 ..
// r + 3b - 2, the pivot at window column off = 2b - 2 (kk = 0) or b - 1.
// The slots' windows and mirrors are disjoint within a wave, and a wave
// depends on the one before it, so a wave is two grid-wide steps.  Step A,
// a block a slot: the reflector from x = the pivot column (sigma2, beta,
// tau, v: v0 = 1, or 0 with tau = 0 when sigma2 == 0; v = x / denom
// elsewhere, so an underflowed sigma2 leaves a nonzero v beside tau = 0)
// into the slot's record, the log Vw[jj, kk], tw[jj, kk], then the pivot
// column and its mirror set to (beta, 0, ..).  A grid sync.  Step B, a
// block an item, each slot 1 + nchunks items: the diagonal block D (window
// columns 2b-1 .. 3b-2: the left update, then the right update on the
// left-updated block, both made in the pass that writes it back
// transposed, as the mirror write comes second in the JAX package and the
// plain version; w2 = tau (D v - v (w1 . v)) from D as read, so the block
// is read from shared memory, not rewritten there), and chunks of `chunk`
// of the other 4b - 2 window columns (the left update, separable by
// column: w1[c] = tau v.S[:, c]; the strip and its mirror both written
// from the tile as read, the pivot column left as step A wrote it).  A
// grid sync.  A wave with no live slot (every block computes the same
// W_t) makes no sync.  Every sum runs in a fixed order: two runs give the
// same bits.
// What bounds it on an H100: at n = 4096, b = 128 the windows' bytes
// (3 b (5b - 2) 8 B a task, 39.5 ms at 3.35 TB/s; the band storage keeps P
// in the 50 MB L2 there) and at every size the two grid syncs a wave (~1 us
// each, 12,280 waves at n = 4096, 49,144 at n = 16384).  The items
// keep every block's work to one tile in shared memory (the b x b block,
// 132 KB at b = 128, or a b x chunk strip; past b = 167 a global scratch
// a block), read from P once and written back once.  Measured (PERF.md
// section 6): a wave is latency, the diagonal item's chain of L2 round
// trips and block barriers (13.9 us a wave at n = 4096, b = 128), not
// bytes.
//
// panel_qr.  For j = 0 .. cnt - 1 (u = o + b + j < m): the Householder
// reflector of panel row j (Pt[j] = column o + j of As, updated) at pivot u
// (LAPACK convention: zero below u, one at u), then Pt -= tau (Pt v) v^T,
// Yp[j] = v, tp[j] = tau.  Each block owns a slice of the m entries of every
// panel row, cached in shared memory for the whole panel (rows that do not
// fit stay in a global copy), so the panel is read once.  Rows above j are
// dead (no output reads them), so column j updates rows j + 1 .. cnt - 1
// only.  Two grid syncs a column: after the sigma2 partials, and after the
// partials of w = Pt v.  Column j - 1's update of row j is made by every
// block from w_j's total (the same bits everywhere) before sigma2 of
// column j; its update of the rows past j waits for their totals, which
// the blocks spread among themselves in that same step and read after the
// first sync.  What bounds it: latency, the two syncs a column (the panel
// is 128 x m, read once).
//
// Contractions are fused multiply-adds (__fma_rn); every other rounding is
// written out, and v is divided by its denominator (__ddiv_rn).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;     // band_chase block
constexpr int kQrThreads = 256;   // panel_qr block
constexpr int kQrWarps = kQrThreads / 32;

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The block's sum of x (every thread calls), in every thread: warps' sums
// in warp order.
__device__ __forceinline__ double block_sum_all(double x, double* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) s = __dadd_rn(s, red[w]);
  __syncthreads();
  return s;
}

// The sum over g < blocks of ws[g * stride + t] by one warp (every lane
// calls; the total in lane 0): each lane adds its blocks g = lane,
// lane + 32, ... in order, then a fixed tree.  Every warp gets the same bits.
__device__ __forceinline__ double grid_total(const double* ws, int stride, int blocks, int t) {
  constexpr int kAhead = 8;
  const int lane = threadIdx.x & 31;
  double s = 0.0;
  for (int g0 = 0; g0 < blocks; g0 += 32 * kAhead) {
    double x[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int g = g0 + lane + 32 * q;
      x[q] = g < blocks ? __ldcg(ws + (size_t)g * stride + t) : 0.0;
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) s = __dadd_rn(s, x[q]);
  }
  return warp_sum(s);
}

// ---------------------------------------------------------------------------
// band_chase

struct Chase {
  const double* B;   // (n, n), row stride ldb
  long long ldb;
  double* P;         // band storage, (n + 5b) x (6b - 3), zero on entry
  double* Vw;        // (n - 1, kmax, b) log, or null
  double* tw;        // (n - 1, kmax), or null
  double* d;         // (n,)
  double* e;         // (n - 1,)
  double* rs;        // wmax (b + 2): each slot's record, v then tau, beta
  double* gwork;     // grid * work doubles when the work tile is not shared
  long long work;    // doubles of a block's work tile
  int work_shared;
  int n, b, kmax, wmax, twaves, chunk, nchunks;
};

// The live slots of wave t: s = 0 .. W - 1 (a prefix), from
// s <= t/3 (jj >= 0) and jj + kk b + 2 <= n - 1.
__host__ __device__ __forceinline__ int wave_width(int n, int b, int t, int wmax) {
  const int q = t / 3, rm = t - 3 * (t / 3);
  const long long room = (long long)n - 3 - q - (long long)rm * b;
  if (room < 0) return 0;
  const long long w = (q < room / (3 * b - 1) ? q : room / (3 * b - 1)) + 1;
  return static_cast<int>(w < wmax ? w : wmax);
}

__device__ __forceinline__ size_t pidx(const Chase& a, int i, int j) {
  return (size_t)(i + 2 * a.b) * (size_t)(6 * a.b - 3) + (size_t)(j - i + 3 * a.b - 2);
}

struct Slot {
  int jj, kk, r, off;
};

__device__ __forceinline__ Slot slot_of(int b, int t, int s) {
  Slot q;
  q.jj = t / 3 - s;
  q.kk = t % 3 + 3 * s;
  q.r = q.jj + q.kk * b + 1;
  q.off = q.kk == 0 ? 2 * b - 2 : b - 1;
  return q;
}

// f(i, c) for i < rows, c < cols: with cols <= blockDim each thread keeps
// one column c and walks the rows (neighbouring threads on neighbouring
// columns), else each thread walks whole columns; no division per entry
// (a division an entry made the items instruction-bound on their SM).
template <typename F>
__device__ __forceinline__ void for_tile(int rows, int cols, F f) {
  if (cols <= (int)blockDim.x) {
    const int per = blockDim.x / cols;
    const int c = threadIdx.x % cols, i0 = threadIdx.x / cols;
    if (i0 >= per) return;
    for (int i = i0; i < rows; i += per) f(i, c);
  } else {
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      for (int i = 0; i < rows; ++i) f(i, c);
    }
  }
}

// T[i * ld + c] = *addr(i, c) for i < rows, c < cols, as for_tile walks
// them, kAhead loads of each thread in flight before their stores (each
// load is an L2 round trip).
template <typename A>
__device__ __forceinline__ void load_tile(int rows, int cols, A addr, double* T, int ld) {
  constexpr int kAhead = 8;
  int per, c, i0, cstep;
  if (cols <= (int)blockDim.x) {
    per = blockDim.x / cols;
    c = threadIdx.x % cols;
    i0 = threadIdx.x / cols;
    cstep = cols;                        // one column a thread
    if (i0 >= per) return;
  } else {
    per = 1;
    c = threadIdx.x;
    i0 = 0;
    cstep = blockDim.x;
  }
  for (; c < cols; c += cstep) {
    for (int i = i0; i < rows; i += kAhead * per) {
      double x[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int ii = i + u * per;
        if (ii < rows) x[u] = __ldcg(addr(ii, c));
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int ii = i + u * per;
        if (ii < rows) T[(size_t)ii * ld + c] = x[u];
      }
    }
  }
}

// The reflector of a slot from its pivot column x (b entries), by warp 0:
// v into v[], tau and beta into scal[0..1] (all in shared memory, read by
// the block after the barrier), the log written when `log`.
__device__ void slot_reflector(const Chase& a, const Slot& q, const double* x, double* v,
                               double* scal, bool log) {
  const int b = a.b;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double part = 0.0;
    for (int i = lane; i < b; i += 32) {
      const double xi = x[i];
      v[i] = xi;
      if (i >= 1) part = __fma_rn(xi, xi, part);
    }
    const double sigma2 = __shfl_sync(0xffffffffu, warp_sum(part), 0);
    const double x0 = __shfl_sync(0xffffffffu, v[0], 0);
    const double nrm = __dsqrt_rn(__dadd_rn(__dmul_rn(x0, x0), sigma2));
    const double beta = x0 >= 0.0 ? -nrm : nrm;   // the sign avoids cancellation
    const bool no_op = sigma2 == 0.0;
    const double denom = no_op ? 1.0 : __dsub_rn(x0, beta);
    const double tau = no_op ? 0.0 : __ddiv_rn(__dsub_rn(beta, x0), beta);
    for (int i = lane; i < b; i += 32) {
      const double vi = i == 0 ? (no_op ? 0.0 : 1.0) : __ddiv_rn(v[i], denom);
      v[i] = vi;
      if (log) a.Vw[((size_t)q.jj * a.kmax + q.kk) * b + i] = vi;
    }
    if (lane == 0) {
      scal[0] = tau;
      scal[1] = no_op ? x0 : beta;
      if (log) a.tw[(size_t)q.jj * a.kmax + q.kk] = tau;
    }
  }
  __syncthreads();
}

// out[c] = tau * sum_{i < rows} v[i] T[i * ld + c] for c < nc, in order of
// i within each of the block's row groups, the groups' partials in order.
__device__ void column_dots(const double* T, int ld, int rows, int nc, const double* v, double tau,
                            double* out, double* part) {
  const int groups = nc >= (int)blockDim.x ? 1 : blockDim.x / nc;
  const int per = (rows + groups - 1) / groups;
  for (int c0 = 0; c0 < nc; c0 += blockDim.x) {
    const int idx = threadIdx.x;
    const int g = groups == 1 ? 0 : idx / nc;
    const int c = groups == 1 ? c0 + idx : idx - g * nc;
    double x = 0.0;
    if (g < groups && c < nc) {
      const int i1 = min(rows, (g + 1) * per);
      for (int i = g * per; i < i1; ++i) x = __fma_rn(v[i], T[(size_t)i * ld + c], x);
      part[idx] = x;
    }
    __syncthreads();
    if (idx < nc && c0 + idx < nc) {
      const int cc = groups == 1 ? c0 + idx : idx;
      double s = groups == 1 ? part[idx] : 0.0;
      if (groups > 1) {
        for (int h = 0; h < groups; ++h) s = __dadd_rn(s, part[h * nc + idx]);
      }
      out[cc] = __dmul_rn(tau, s);
    }
    __syncthreads();
  }
}

// out[i] = tau * sum_{k < cols} T[i * ld + k] v[k] for i < rows.
__device__ void row_dots(const double* T, int ld, int rows, int cols, const double* v, double tau,
                         double* out, double* part) {
  const int groups = rows >= (int)blockDim.x ? 1 : blockDim.x / rows;
  const int per = (cols + groups - 1) / groups;
  for (int r0 = 0; r0 < rows; r0 += blockDim.x) {
    const int idx = threadIdx.x;
    const int g = groups == 1 ? 0 : idx / rows;
    const int i = groups == 1 ? r0 + idx : idx - g * rows;
    if (g < groups && i < rows) {
      double x = 0.0;
      const int k1 = min(cols, (g + 1) * per);
      for (int k = g * per; k < k1; ++k) x = __fma_rn(T[(size_t)i * ld + k], v[k], x);
      part[idx] = x;
    }
    __syncthreads();
    if (idx < rows && r0 + idx < rows) {
      const int ii = groups == 1 ? r0 + idx : idx;
      double s = groups == 1 ? part[idx] : 0.0;
      if (groups > 1) {
        for (int h = 0; h < groups; ++h) s = __dadd_rn(s, part[h * rows + idx]);
      }
      out[ii] = __dmul_rn(tau, s);
    }
    __syncthreads();
  }
}

// Item 0 of a slot: the b x b diagonal block D (window columns 2b - 1 ..
// 3b - 2), both updates in the pass that writes it back transposed:
// D'' = D - v w1^T - w2 v^T with w1 = tau v^T D and w2 = tau D' v =
// tau (D v - v (w1 . v)), both from the block as it was read.
__device__ void chase_diag(const Chase& a, const Slot& q, double tau, double* T,
                           const double* v, double* w, double* u, double* part,
                           double* red) {
  const int b = a.b, ld = b + 1;
  const int r = q.r;
  load_tile(b, b, [&](int i, int k) { return a.P + pidx(a, r + i, r + k); }, T, ld);
  __syncthreads();
  column_dots(T, ld, b, b, v, tau, w, part);           // w1 = tau v^T D
  row_dots(T, ld, b, b, v, 1.0, u, part);              // u = D v
  double wv = 0.0;
  for (int i = threadIdx.x; i < b; i += blockDim.x) wv = __fma_rn(w[i], v[i], wv);
  wv = block_sum_all(wv, red);                         // w1 . v
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    u[i] = __dmul_rn(tau, __fma_rn(-v[i], wv, u[i]));  // w2
  }
  __syncthreads();
  // the mirror write comes second: P[r + x, r + y] = D''[y, x]
  for_tile(b, b, [&](int x, int y) {
    const double d1 = __fma_rn(-v[y], w[x], T[(size_t)y * ld + x]);
    a.P[pidx(a, r + x, r + y)] = __fma_rn(-u[y], v[x], d1);
  });
  __syncthreads();
}

// Item 1 + ch of a slot: chunk ch of the window's other columns (local
// columns 0 .. 2b - 2 and 3b - 1 .. 5b - 3, in that order), all but the
// pivot column, which step A wrote.
__device__ void chase_chunk(const Chase& a, const Slot& q, int ch, double tau, double* T,
                            const double* v, double* w, double* part) {
  // the strip and its mirror are written from the same fused multiply-add
  // of the tile as read: the same bits, no pass through shared memory
  const int b = a.b, cw = a.chunk, ld = cw + 1;
  const int r = q.r;
  const int p0 = ch * cw;
  const int nc = min(cw, 4 * b - 2 - p0);
  const int c0 = r - (2 * b - 1);       // the window's first column
  auto col = [&](int c) {
    const int p = p0 + c;
    return c0 + (p < 2 * b - 1 ? p : p + b);
  };
  const int pivot = c0 + q.off;
  load_tile(b, nc, [&](int i, int c) { return a.P + pidx(a, r + i, col(c)); }, T, ld);
  __syncthreads();
  column_dots(T, ld, b, nc, v, tau, w, part);          // w1 = tau v^T S
  for_tile(b, nc, [&](int i, int c) {
    const int j = col(c);
    if (j != pivot) a.P[pidx(a, r + i, j)] = __fma_rn(-v[i], w[c], T[(size_t)i * ld + c]);
  });
  // the mirror: row col(c), columns r .. r + b - 1
  for_tile(nc, b, [&](int c, int i) {
    const int j = col(c);
    if (j != pivot) a.P[pidx(a, j, r + i)] = __fma_rn(-v[i], w[c], T[(size_t)i * ld + c]);
  });
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) band_chase_kernel(const Chase a) {
  extern __shared__ double sh[];
  cg::grid_group grid = cg::this_grid();
  const int b = a.b, G = gridDim.x;
  const long long nthreads = (long long)G * blockDim.x;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // pack B's band
  const long long ldp = 6LL * b - 3, H = 3LL * b - 2;
  for (long long idx = gtid; idx < (long long)a.n * ldp; idx += nthreads) {
    const long long i = idx / ldp, c = idx - i * ldp;
    const long long j = i + c - H;
    if (j >= 0 && j < a.n) a.P[(i + 2LL * b) * ldp + c] = __ldg(a.B + i * a.ldb + j);
  }
  grid.sync();

  double* red = sh;                              // 32
  double* scal = red + 32;                       // 2: tau, beta
  double* v = scal + 2;                          // b: x, then v
  double* w = v + b;                             // max(b, chunk): w1
  double* u = w + (b > a.chunk ? b : a.chunk);   // b: D v, then w2
  double* part = u + b;                          // kThreads
  double* T = a.work_shared ? part + kThreads : a.gwork + (size_t)blockIdx.x * a.work;
  const int items = 1 + a.nchunks;
  const bool log = a.Vw != nullptr;
  for (int t = 0; t < a.twaves; ++t) {
    const int W = wave_width(a.n, b, t, a.wmax);
    if (W == 0) continue;                        // the same for every block
    // step A: a block a slot, the reflector and the pivot column
    for (int s = blockIdx.x; s < W; s += G) {
      const Slot q = slot_of(b, t, s);
      const int pivot = q.r - (2 * b - 1) + q.off;
      for (int i = threadIdx.x; i < b; i += blockDim.x) {
        w[i] = __ldcg(a.P + pidx(a, q.r + i, pivot));
      }
      __syncthreads();
      slot_reflector(a, q, w, v, scal, log);
      double* rec = a.rs + (size_t)s * (b + 2);
      for (int i = threadIdx.x; i < b; i += blockDim.x) {
        rec[i] = v[i];
        const double x = i == 0 ? scal[1] : 0.0;
        a.P[pidx(a, q.r + i, pivot)] = x;
        a.P[pidx(a, pivot, q.r + i)] = x;
      }
      if (threadIdx.x == 0) {
        rec[b] = scal[0];
        rec[b + 1] = scal[1];
      }
      __syncthreads();
    }
    grid.sync();
    // step B: a block an item
    for (int it = blockIdx.x; it < W * items; it += G) {
      const int s = it / items, qi = it - s * items;
      const Slot q = slot_of(b, t, s);
      const double* rec = a.rs + (size_t)s * (b + 2);
      for (int i = threadIdx.x; i < b; i += blockDim.x) v[i] = __ldcg(rec + i);
      if (threadIdx.x == 0) scal[0] = __ldcg(rec + b);
      __syncthreads();
      const double tau = scal[0];
      if (qi == 0) chase_diag(a, q, tau, T, v, w, u, part, red);
      else chase_chunk(a, q, qi - 1, tau, T, v, w, part);
    }
    grid.sync();
  }
  for (long long i = gtid; i < a.n; i += nthreads) {
    a.d[i] = __ldcg(a.P + pidx(a, (int)i, (int)i));
    if (i < a.n - 1) a.e[i] = __ldcg(a.P + pidx(a, (int)i, (int)i + 1));
  }
}

// ---------------------------------------------------------------------------
// panel_qr

struct PanelQR {
  const double* As;  // the bucket (m, m), row stride lda; the panel is columns o .. o + b - 1
  long long lda;
  double* Yp;        // (b, ldy) reflector rows, zero on entry
  long long ldy;
  double* tp;        // (b,) taus, zero on entry
  double* Pg;        // (b, m): the panel rows k >= kc (null when kc == b)
  double* ws;        // G b + G + 1 + b doubles
  int m, o, b, cnt, slice, kc;
};

__global__ void __launch_bounds__(kQrThreads) panel_qr_kernel(const PanelQR a) {
  extern __shared__ double sh[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, S = a.slice, b = a.b, cnt = a.cnt;
  const int lo = blockIdx.x * S;
  const int ne = max(0, min(S, a.m - lo));       // entries lo .. lo + ne - 1
  double* red = sh;                              // kQrWarps
  double* scal = red + kQrWarps;                 // 4
  double* wt = scal + 4;                         // b: tau w of the rows past j
  double* rows = wt + b;                         // kc x S
  double* wpart = a.ws;                          // G x b: w partials, row k at g b + k
  double* spart = a.ws + (size_t)G * b;          // G: sigma2 partials
  double* piv = spart + G;                       // the pivot
  double* wtot = piv + 1;                        // b: w totals of the rows past j
  auto row = [&](int k) -> double* {
    return k < a.kc ? rows + (size_t)k * S : a.Pg + (size_t)k * a.m + lo;
  };

  // Pt[k][i] = As[i][o + k] on the block's slice, kAhead loads of each
  // thread in flight before their stores
  {
    constexpr int kAhead = 8;
    for (int base = tid; base < ne * b; base += kAhead * kQrThreads) {
      double x[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int idx = base + q * kQrThreads;
        if (idx < ne * b) {
          const int s = idx / b, k = idx - s * b;
          x[q] = __ldg(a.As + (size_t)(lo + s) * a.lda + a.o + k);
        }
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int idx = base + q * kQrThreads;
        if (idx < ne * b) {
          const int s = idx / b, k = idx - s * b;
          row(k)[s] = x[q];
        }
      }
    }
  }
  __syncthreads();

  double tau_prev = 0.0;
  for (int j = 0; j < cnt; ++j) {
    const int u = a.o + b + j;                   // the pivot entry
    double* rj = row(j);
    if (j > 0) {
      // column j - 1's update of row j, from w_j's total (every block the
      // same bits), then the totals of the rows past j spread over the
      // blocks, a warp a row
      if (warp == 0) {
        const double tot = grid_total(wpart, b, G, j);
        if (lane == 0) scal[0] = __dmul_rn(tau_prev, tot);
      }
      for (int k = j + 1 + blockIdx.x + G * warp; k < cnt; k += G * kQrWarps) {
        const double tot = grid_total(wpart, b, G, k);
        if (lane == 0) wtot[k] = tot;
      }
      __syncthreads();
      const double tw = scal[0];
      const double* vp = row(j - 1);
      for (int s = max(0, u - 1 - lo) + tid; s < ne; s += kQrThreads) {
        rj[s] = __fma_rn(-tw, vp[s], rj[s]);
      }
      __syncthreads();
    }
    double part = 0.0;
    for (int s = max(0, u + 1 - lo) + tid; s < ne; s += kQrThreads) {
      part = __fma_rn(rj[s], rj[s], part);
    }
    part = block_sum_all(part, red);
    if (tid == 0) {
      spart[blockIdx.x] = part;
      if (u >= lo && u < lo + ne) *piv = rj[u - lo];
    }
    grid.sync();

    // the reflector: every block the same bits
    if (warp == 0) {
      const double sigma2 = grid_total(spart, 1, G, 0);
      if (lane == 0) {
        const double pivot = __ldcg(piv);
        const double norm = __dsqrt_rn(__dadd_rn(sigma2, __dmul_rn(pivot, pivot)));
        const double alpha = pivot >= 0.0 ? -norm : norm;   // the sign avoids cancellation
        const bool no_op = sigma2 == 0.0;                    // already reduced here
        scal[1] = no_op ? 1.0 : __dsub_rn(pivot, alpha);
        scal[2] = no_op ? 0.0 : __ddiv_rn(__dsub_rn(alpha, pivot), alpha);
        scal[3] = no_op ? 0.0 : 1.0;
      }
    }
    if (j > 0) {
      for (int k = j + 1 + tid; k < cnt; k += kQrThreads) wt[k] = __dmul_rn(tau_prev, __ldcg(wtot + k));
    }
    __syncthreads();
    const double denom = scal[1], tau = scal[2], unit = scal[3];
    if (j > 0) {
      // column j - 1's update of the rows past j
      const int s0 = max(0, u - 1 - lo);
      const int width = ne - s0;
      const double* vp = row(j - 1);
      if (width > 0) {
        for_tile(cnt - j - 1, width, [&](int i, int c) {
          double* rk = row(j + 1 + i);
          rk[s0 + c] = __fma_rn(-wt[j + 1 + i], vp[s0 + c], rk[s0 + c]);
        });
      }
    }
    // v into row j's place (the row is dead) and into Yp[j]
    const int su = max(0, u - lo);
    for (int s = su + tid; s < ne; s += kQrThreads) {
      const int i = lo + s;
      const double vi = i == u ? unit : __ddiv_rn(rj[s], denom);
      rj[s] = vi;
      a.Yp[(size_t)j * a.ldy + i] = vi;
    }
    if (blockIdx.x == 0 && tid == 0) a.tp[j] = tau;
    __syncthreads();
    // the block's partials of w_k = Pt[k] . v, k = j + 1 .. cnt - 1: `parts`
    // consecutive lanes a row, each over every parts-th entry in order
    const int R = cnt - j - 1;
    if (R > 0) {
      int parts = 32;
      while (parts > 1 && parts * R > kQrThreads) parts >>= 1;
      const int pi = tid & (parts - 1);
      for (int t0 = 0; t0 < R; t0 += kQrThreads / parts) {
        const int t = t0 + tid / parts;
        double x = 0.0;
        if (t < R) {
          const double* rk = row(j + 1 + t);
          for (int s = su + pi; s < ne; s += parts) x = __fma_rn(rk[s], rj[s], x);
        }
        for (int off = parts >> 1; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
        if (t < R && pi == 0) wpart[(size_t)blockIdx.x * b + j + 1 + t] = x;
      }
    }
    tau_prev = tau;
    grid.sync();
  }
}

int coop_occupancy(const void* fn, int threads, int smem, void* out) {
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = blocks;
  o[1] = sms;
  o[2] = optin;
  return 0;
}

int coop_launch(const void* fn, int grid, int threads, void** args, int smem, void* stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(threads), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();   // a refused launch leaves no error for the next one
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (blocks of band_chase one SM holds at `smem` dynamic shared bytes, the SM
// count, the shared bytes a block may opt into) of the current device, into
// out[0..2]; opts the kernel into that much shared memory first.
extern "C" int band_chase_occupancy(int smem, void* out) {
  return coop_occupancy((const void*)band_chase_kernel, kThreads, smem, out);
}

// The whole chase of B (n, n) f64, row stride ldb, band b (n >= 3, b >= 2):
// P zero-filled (n + 5b) x (6b - 3); Vw (n - 1, kmax, b) and tw
// (n - 1, kmax) zero-filled, or both null (no log); d (n,), e (n - 1,);
// rs wmax (b + 2) doubles; gwork grid * work doubles unless work_shared.
// grid, smem from kernels/band_reduce.py::chase_plan after
// band_chase_occupancy on this device.  One cooperative kernel on
// `stream`; allocates nothing; returns the launch's cudaError_t.
extern "C" int band_chase_launch(const void* B, long long ldb, void* P, void* Vw, void* tw,
                                 void* d, void* e, void* rs, void* gwork,
                                 long long work, int work_shared, int n, int b, int chunk,
                                 int grid, int smem, void* stream) {
  if (n < 3 || b < 2 || chunk < 1 || grid < 1 || ldb < n || (Vw == nullptr) != (tw == nullptr)
      || work < (long long)b * (b + 1) || work < (long long)b * (chunk + 1)
      || (!work_shared && gwork == nullptr) || rs == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kmax = (n - 3) / b;
  Chase a{static_cast<const double*>(B), ldb, static_cast<double*>(P),
          static_cast<double*>(Vw), static_cast<double*>(tw), static_cast<double*>(d),
          static_cast<double*>(e), static_cast<double*>(rs), static_cast<double*>(gwork),
          work, work_shared, n, b, kmax + 1, kmax / 3 + 1, 3 * (n - 3) + 1, chunk,
          (4 * b - 2 + chunk - 1) / chunk};
  const long long need = 8LL * (34 + 2LL * b + (b > chunk ? b : chunk) + kThreads
                                + (work_shared ? work : 0));
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  return coop_launch((const void*)band_chase_kernel, grid, kThreads, args, smem, stream);
}

extern "C" int panel_qr_occupancy(int smem, void* out) {
  return coop_occupancy((const void*)panel_qr_kernel, kQrThreads, smem, out);
}

// The QR of the panel at columns o .. o + b - 1 of the bucket As (m, m) f64,
// row stride lda: cnt = min(b, m - o - b) live columns (0 < cnt); Yp
// (b, ldy >= m) and tp (b,) zero-filled receive the reflectors and taus;
// Pg (b, m) holds the rows past kc (null when kc == b); ws
// grid b + grid + 1 + b doubles.  grid blocks of `slice` entries
// (grid * slice >= m), kc panel rows cached in `smem` bytes, from
// kernels/band_reduce.py::panel_qr_plan after panel_qr_occupancy.  One
// cooperative kernel on `stream`; returns the launch's cudaError_t.
extern "C" int panel_qr_launch(const void* As, long long lda, void* Yp, long long ldy,
                               void* tp, void* Pg, void* ws, int m, int o, int b, int cnt,
                               int slice, int kc, int grid, int smem, void* stream) {
  if (m < 1 || b < 1 || o < 0 || cnt < 1 || cnt > b || o + b + cnt > m || lda < m || ldy < m
      || grid < 1 || slice < 1 || (long long)grid * slice < m || kc < 0 || kc > b
      || (kc < b && Pg == nullptr)
      || smem < 8LL * (kQrWarps + 4 + b + (long long)kc * slice)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PanelQR a{static_cast<const double*>(As), lda, static_cast<double*>(Yp), ldy,
            static_cast<double*>(tp), static_cast<double*>(Pg), static_cast<double*>(ws),
            m, o, b, cnt, slice, kc};
  void* args[] = {&a};
  return coop_launch((const void*)panel_qr_kernel, grid, kQrThreads, args, smem, stream);
}
