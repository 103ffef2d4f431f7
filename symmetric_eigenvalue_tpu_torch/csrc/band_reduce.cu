// The two-stage front end's device loops: the wavefront bulge chase and the
// band reduction's panel QR.
//
// Replaces two device loops of the JAX package that hold no pallas_call:
//  - symmetric_eigenvalue_tpu/kernels/band_reduce.py::band_to_tridiag_wave
//    (:254; its lax.fori_loop over the waves at :294, the wave body at
//    :322-408).  band_chase is ONE cooperative launch for the whole chase.
//  - _reduce_block's column loop (:67-86, col_body :71): the Householder QR
//    of a b-column panel, one launch a panel (panel_qr).
//
// band_chase.  The state is the band's lower triangle, stored once, by
// column as LAPACK's dsbtrd keeps it: entry (i, c), c <= i <= c + H,
// H = 3b - 2, at Q[(c + 2b)(3b - 1) + i - c], columns -2b .. n + b - 1 (the
// windows never leave that band or those columns; the padding stays zero):
// 51 MB at n = 16384, b = 128.  The launch packs B's lower band into Q, runs
// every wave, then reads d and e off Q.  Wave t (t = 0 .. 3(n-3)) has the
// live slots s = 0 .. W_t - 1 of the closed-form schedule (wave_width):
// task (jj, kk) = (t/3 - s, t%3 + 3s) on rows r .. r + b - 1,
// r = jj + kk b + 1.  Its window without the diagonal block is the strip S
// (b x (4b - 2)): columns c < 2b - 1 the left strip (matrix column
// r - 2b + 1 + c, rows r .. r + b - 1: a run down a stored column), the
// rest the right strip as its transpose (matrix row r - b + 1 + c, columns
// r .. r + b - 1: a run across stored columns); the pivot is S's column
// 2b - 2 (kk = 0) or b - 1.  A task is H S and H D H on its diagonal block
// D, H = I - tau v v^T: S -= v w1^T with w1 = tau v^T S (column by column),
// and D as LAPACK's dlarfy (w = tau D v, w += -tau/2 (w . v) v,
// D -= v w^T + w v^T), one matvec and one dot on the packed lower half.
// Reflectors are formed a wave ahead, so a wave is one grid-wide step and
// one grid sync: the pivot column of task (jj, kk + 1), the stored column r
// at rows r + b .. r + 2b - 1, is S's columns 2b - 1 .. 3b - 2 at row 0 of
// task (jj, kk), which only its left update writes, in wave t; the items
// that update those b columns form the next hop's reflector from them, write
// its record (v, tau; records double-buffered by the wave's parity), its log
// entry, and set the column to (beta, 0, ..) before the sync.  Sweep j's
// first pivot column (column j, rows j + 1 .. j + b) is final after wave
// 3j - 2: one more item of wave 3j - 1 forms its reflector (sweep 0's before
// wave 0).  Items, a block each, every tile copied in by 8-byte
// cp.async (all of a thread's copies in flight at once) and written back
// once; a global scratch a block where not even the diagonal block fits in
// shared memory (b > ~239):
//  - b <= 32: a block of 256 threads a whole task, its window in one round
//    of copies; the last warp updates the diagonal block while the other
//    seven update the strips (a named barrier), then warp 0 forms the
//    reflector.
//  - past it, blocks of 512 threads: the diagonal block, chunks of the left
//    strip, of the next hop's b columns and of the right strip, each wave's
//    chunk the narrowest from 16 columns that keeps the wave's items to one
//    round of the grid.  The next hop's columns are split like the rest;
//    each of their items leaves its row-0 values in xs, and the last to
//    finish (a per-slot arrival count, no wait) forms the reflector.  One
//    block holding all b columns was the wave's longest item (128 KB in and
//    128 KB out of one SM).
// Every sum runs in a fixed order: two runs give the same bits.
// What bounds it on an H100: the windows' bytes (each task reads and writes
// its strip and its diagonal block's lower half once: 0.37 s at n = 16384,
// b = 128, at HBM's 3.35 TB/s; but Q, 13.7 MB at n = 4096 and 51 MB at
// n = 16384, stays in or about the 50 MB L2, so chip_smoke.py also prices
// the bytes at the L2 rate it measures) and the latency of a wave's longest
// item plus one grid sync (~1 us) a wave (49,019 syncs at n = 16384).  An
// item's time is the bytes its SM moves: with every SM copying, one SM
// loads 128 KB in ~2.1 us by 8-byte copies (~1.7 us by 16-byte ones) and
// stores it in ~2.4 us, so the items are cut small and spread over every
// SM.  The copies are 8-byte: the left strip's runs (down stored columns)
// land across the tile's rows, never 16 contiguous bytes in shared memory;
// the right strip's and the diagonal block's runs are contiguous at both
// ends, but the tile's rows (nc + 1 doubles) and the packed block's
// columns (tri(q)) change their 16-byte alignment from run to run.  The
// previous design (the whole symmetric band, 104 MB, and its mirror
// written; a block a slot forming the wave's reflectors between two grid
// syncs; 512-thread blocks and a 132 KB diagonal tile, one an SM) took
// 1.35 s at n = 16384, band 128, and 0.79 s at u = 16 (PERF.md section 6).
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

constexpr int kQrThreads = 256;   // panel_qr block
constexpr int kQrWarps = kQrThreads / 32;
constexpr int kAhead = 8;         // loads of a thread in flight
constexpr int kChunkMin = 16;     // band_chase: the narrowest chunk of a wave

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

// f(i, c) for i < rows, c < cols: with cols <= blockDim each thread keeps
// one column c and walks the rows (neighbouring threads on neighbouring
// columns), else each thread walks whole columns; no division per entry.
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

// ---------------------------------------------------------------------------
// band_chase

struct Chase {
  const double* B;   // (n, n), row stride ldb
  long long ldb;
  double* Q;         // the lower band, (n + 3b) x (3b - 1), zero on entry
  double* Vw;        // (n - 1, kmax, b) log, or null
  double* tw;        // (n - 1, kmax), or null
  double* d;         // (n,)
  double* e;         // (n - 1,)
  double* rs;        // 2 wmax (b + 1): the records of a wave's slots, v then
                     // tau, by the wave's parity
  double* xs;        // wmax b: each slot's next pivot column, as its parts
                     // leave it
  int* arrived;      // wmax: the slot's next items done, zero between waves
  double* gwork;     // grid * work doubles when the work tile is not shared
  long long work;    // doubles of a block's work tile
  int work_shared;
  int n, b, kmax, wmax, twaves, chunk, whole;
};

// The live slots of wave t: s = 0 .. W - 1 (a prefix), from
// s <= t/3 (jj >= 0) and jj + kk b + 2 <= n - 1; none before wave 0.
__host__ __device__ __forceinline__ int wave_width(int n, int b, int t, int wmax) {
  if (t < 0) return 0;
  const int q = t / 3, rm = t - 3 * (t / 3);
  const long long room = (long long)n - 3 - q - (long long)rm * b;
  if (room < 0) return 0;
  const long long w = (q < room / (3 * b - 1) ? q : room / (3 * b - 1)) + 1;
  return static_cast<int>(w < wmax ? w : wmax);
}

// Q's entry (i, c) of the lower band, c <= i <= c + 3b - 2.
__device__ __forceinline__ double* qat(const Chase& a, int i, int c) {
  return a.Q + (size_t)(c + 2 * a.b) * (size_t)(3 * a.b - 1) + (size_t)(i - c);
}

struct Slot {
  int jj, kk, r, pivot;   // pivot: the strip's column of the pivot
};

__device__ __forceinline__ Slot slot_of(int b, int t, int s) {
  Slot q;
  q.jj = t / 3 - s;
  q.kk = t % 3 + 3 * s;
  q.r = q.jj + q.kk * b + 1;
  q.pivot = q.kk == 0 ? 2 * b - 2 : b - 1;
  return q;
}

// A walk over s < slow, q < fast with consecutive threads on consecutive q:
// the global offset g = s gS + q and the tile index t = s ts + q tq kept
// by additions (no multiplication or division per entry).
// The block's threads: band_chase runs 256 (a whole task a block) or 512
// (the items of a slot).
__device__ __forceinline__ int nthr() { return static_cast<int>(blockDim.x); }

// A team of the block's threads, tid < count, synced by barrier `bar`: 0
// the whole block (__syncthreads), else a named barrier of count threads.
struct Team {
  int tid, count, bar;
  __device__ __forceinline__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(count) : "memory");
    }
  }
};

__device__ __forceinline__ Team whole_block() {
  return Team{static_cast<int>(threadIdx.x), nthr(), 0};
}

struct Walk {
  int s, q, fast, ds, dq, t, tstep, twrap;
  long long g, gstep, gwrap;
  __device__ __forceinline__ Walk(int fast_, long long gS, int ts, int tq, Team team)
      : fast(fast_) {
    ds = team.count / fast;
    dq = team.count - ds * fast;
    s = team.tid / fast;
    q = team.tid - s * fast;
    g = s * gS + q;
    t = s * ts + q * tq;
    gstep = ds * gS + dq;
    gwrap = gS - fast;
    tstep = ds * ts + dq * tq;
    twrap = ts - fast * tq;
  }
  __device__ __forceinline__ void next() {
    g += gstep;
    t += tstep;
    s += ds;
    q += dq;
    if (q >= fast) {
      q -= fast;
      ++s;
      g += gwrap;
      t += twrap;
    }
  }
};

// A strip run's walk: S[i][c0 + c] (i < b, c < nc, all left or all right)
// at Q + base + s (3b - 2) + q, tile index i ld + c; the left strip walked
// down its stored columns (s = c, q = i), the right along its rows (s = i,
// q = c).
struct StripRun {
  long long base;
  int slow, fast, ts, tq;
  bool left;
  __device__ __forceinline__ StripRun(const Chase& a, int r, int c0, int nc, int ld) {
    const int b = a.b;
    const long long ldq = 3LL * b - 1;
    left = c0 < 2 * b - 1;
    if (left) {   // S[i][c] = Q(r + i, r - 2b + 1 + c)
      base = (r + 1 + c0) * ldq + 2 * b - 1 - c0;
      slow = nc;
      fast = b;
      ts = 1;
      tq = ld;
    } else {      // S[i][c] = Q(r - b + 1 + c, r + i)
      base = (r + 2 * b) * ldq + c0 - b + 1;
      slow = b;
      fast = nc;
      ts = ld;
      tq = 1;
    }
  }
  __device__ __forceinline__ Walk walk(const Chase& a, Team team = whole_block()) const {
    return Walk(fast, 3LL * a.b - 2, ts, tq, team);
  }
};

// Up to K loads of a thread's entries of a walk issued into x (their tile
// indices into at); commit stores them.  k0: the thread's first entry's
// flat index, advanced by K nthr().
template <int K>
__device__ __forceinline__ void issue(const double* G, int total, int k0, Walk& w, double* x,
                                      int* at) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (k0 + u * nthr() < total) {
      x[u] = __ldcg(G + w.g);
      at[u] = w.t;
    }
    w.next();
  }
}

template <int K>
__device__ __forceinline__ void commit(int total, int k0, const double* x, const int* at,
                                       double* T) {
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (k0 + u * nthr() < total) T[at[u]] = x[u];
  }
}

// An 8-byte asynchronous copy from global to shared memory (through L1:
// after a grid sync a load sees every write made before it) and the wait
// for a thread's copies.
__device__ __forceinline__ void copy8(double* dst, const double* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// T's tile of a strip run: asynchronous copies, every one of a thread in
// flight at once, where T is shared memory (kShared); else kAhead loads at
// a time.
template <bool kShared>
__device__ __forceinline__ void load_strip(const Chase& a, int r, int c0, int nc, double* T,
                                           int ld) {
  const StripRun run(a, r, c0, nc, ld);
  const int total = run.slow * run.fast;
  Walk w = run.walk(a);
  const double* G = a.Q + run.base;
  if (kShared) {
    for (int k = threadIdx.x; k < total; k += nthr()) {
      copy8(T + w.t, G + w.g);
      w.next();
    }
  } else {
    for (int k0 = threadIdx.x; k0 < total; k0 += kAhead * nthr()) {
      double x[kAhead];
      int at[kAhead];
      issue<kAhead>(G, total, k0, w, x, at);
      commit<kAhead>(total, k0, x, at, T);
    }
  }
}

// S[i][c0 + c] = T[i * ld + c] - v[i] w1[c] (i < b, c < nc) back into Q, as
// load_strip walks it, but the slot's pivot column and, where x is given,
// row 0 of the strip's columns 2b - 1 .. 3b - 2, which go to x[c - (2b - 1)]
// (the next hop's pivot column).
__device__ __forceinline__ void store_strip(const Chase& a, int r, int c0, int nc,
                                            const double* T, int ld, const double* v,
                                            const double* w1, int pivot, double* x,
                                            Team team = whole_block()) {
  const int b = a.b;
  const StripRun run(a, r, c0, nc, ld);
  const int total = run.slow * run.fast;
  Walk w = run.walk(a, team);
  double* G = a.Q + run.base;
  const int skip = pivot - c0;                     // the pivot's run column, left
  const int xend = 3 * b - 1 - c0;                 // x's columns end, right
  for (int k = team.tid; k < total; k += team.count) {
    const int i = run.left ? w.q : w.s, c = run.left ? w.s : w.q;
    const double y = __fma_rn(-v[i], w1[c], T[w.t]);
    if (run.left) {
      if (c != skip) G[w.g] = y;
    } else if (x != nullptr && i == 0 && c < xend) {
      x[c0 + c - (2 * b - 1)] = y;
    } else {
      G[w.g] = y;
    }
    w.next();
  }
}

// out[c] = tau * sum_{i < rows} v[i] T[i * ld + c] for c < nc, in order of
// i within each of the block's row groups, the groups' partials in order.
__device__ __forceinline__ void column_dots(const double* T, int ld, int rows, int nc,
                                            const double* v, double tau, double* out,
                                            double* part, Team team = whole_block()) {
  const int groups = nc >= team.count ? 1 : team.count / nc;
  const int per = (rows + groups - 1) / groups;
  for (int c0 = 0; c0 < nc; c0 += team.count) {
    const int idx = team.tid;
    const int g = groups == 1 ? 0 : idx / nc;
    const int c = groups == 1 ? c0 + idx : idx - g * nc;
    double x = 0.0;
    if (g < groups && c < nc) {
      const int i1 = min(rows, (g + 1) * per);
      for (int i = g * per; i < i1; ++i) x = __fma_rn(v[i], T[(size_t)i * ld + c], x);
      part[idx] = x;
    }
    team.sync();
    if (idx < nc && c0 + idx < nc) {
      const int cc = groups == 1 ? c0 + idx : idx;
      double s = groups == 1 ? part[idx] : 0.0;
      if (groups > 1) {
        for (int h = 0; h < groups; ++h) s = __dadd_rn(s, part[h * nc + idx]);
      }
      out[cc] = __dmul_rn(tau, s);
    }
    team.sync();
  }
}

// The packed lower diagonal block: D(i, q), q <= i < b, at tri(q) + i - q.
__device__ __forceinline__ int tri(int b, int q) { return q * b - (q * (q - 1)) / 2; }

// f(q, o, k) for the packed block's entries (q + o, q), k = tri(q) + o: a
// warp a column (q = warp, warp + warps, ..), its lanes down the column.
template <typename F>
__device__ __forceinline__ void for_diag(int b, F f) {
  const int lane = threadIdx.x & 31, warps = nthr() >> 5;
  for (int q = threadIdx.x >> 5; q < b; q += warps) {
    const int k0 = tri(b, q);
    for (int o = lane; o < b - q; o += 32) f(q, o, k0 + o);
  }
}

template <bool kShared>
__device__ __forceinline__ void load_diag(const Chase& a, int r, double* Dt) {
  const double* G = qat(a, r, r);
  const long long ldq = 3LL * a.b - 1;
  if (kShared) {
    for_diag(a.b, [&](int q, int o, int k) { copy8(Dt + k, G + q * ldq + o); });
  } else {
    for_diag(a.b, [&](int q, int o, int k) { Dt[k] = __ldcg(G + q * ldq + o); });
  }
}

// The diagonal block after its load: H D H as LAPACK's dlarfy,
// u = D v, w = tau u, w += (-tau / 2 (w . v)) v, D -= v w^T + w v^T,
// written back to Q; u's sums each in order of q within the block's row
// groups, the groups in order; u and then w in w[0 .. b - 1].
__device__ __forceinline__ void update_diag(const Chase& a, int r, double tau, const double* Dt, const double* v,
                            double* w, double* part, double* red) {
  const int b = a.b;
  const int groups = b >= nthr() ? 1 : nthr() / b;
  const int per = (b + groups - 1) / groups;
  for (int i0 = 0; i0 < b; i0 += nthr()) {
    const int g = groups == 1 ? 0 : threadIdx.x / b;
    const int i = groups == 1 ? i0 + threadIdx.x : threadIdx.x - g * b;
    if (g < groups && i < b) {
      const int q0 = g * per, q1 = min(b, q0 + per), ti = tri(b, i);
      double x = 0.0;
      int tq = tri(b, q0);
      for (int q = q0; q < q1; ++q) {    // D(i, q) down column q, or D(q, i) down column i
        x = __fma_rn(Dt[q <= i ? tq + i - q : ti + q - i], v[q], x);
        tq += b - q;
      }
      if (groups == 1) w[i] = x;
      else part[threadIdx.x] = x;
    }
  }
  __syncthreads();
  double dot = 0.0;
  for (int i = threadIdx.x; i < b; i += nthr()) {
    double x = w[i];
    if (groups > 1) {
      x = 0.0;
      for (int g = 0; g < groups; ++g) x = __dadd_rn(x, part[g * b + i]);
    }
    const double wi = __dmul_rn(tau, x);
    w[i] = wi;
    dot = __fma_rn(wi, v[i], dot);
  }
  dot = block_sum_all(dot, red);
  const double alpha = __dmul_rn(__dmul_rn(-0.5, tau), dot);
  for (int i = threadIdx.x; i < b; i += nthr()) w[i] = __fma_rn(alpha, v[i], w[i]);
  __syncthreads();
  double* G = qat(a, r, r);
  const long long ldq = 3LL * b - 1;
  for_diag(b, [&](int q, int o, int k) {
    const int i = q + o;
    G[q * ldq + o] = __fma_rn(-v[i], w[q], __fma_rn(-w[i], v[q], Dt[k]));
  });
}

// The diagonal block of a whole task (b <= 32) by one warp beside the
// strips' team: lane i sums row i of D v over q in order, the dot by a
// fixed tree, then update_diag's rank-2 update a column at a time.
__device__ __forceinline__ void update_diag_warp(const Chase& a, int r, double tau,
                                                 const double* Dt, const double* v, double* w) {
  const int b = a.b, lane = threadIdx.x & 31;
  double wi = 0.0, p = 0.0;
  if (lane < b) {
    const int ti = tri(b, lane);
    int tq = 0;
    double x = 0.0;
    for (int q = 0; q < b; ++q) {      // D(i, q) down column q, or D(q, i) down column i
      x = __fma_rn(Dt[q <= lane ? tq + lane - q : ti + q - lane], v[q], x);
      tq += b - q;
    }
    wi = __dmul_rn(tau, x);
    p = __dmul_rn(wi, v[lane]);
  }
  const double dot = __shfl_sync(0xffffffffu, warp_sum(p), 0);
  const double alpha = __dmul_rn(__dmul_rn(-0.5, tau), dot);
  if (lane < b) w[lane] = __fma_rn(alpha, v[lane], wi);
  __syncwarp();
  double* G = qat(a, r, r);
  const long long ldq = 3LL * b - 1;
  for (int q = 0; q < b; ++q) {
    const int k0 = tri(b, q);
    for (int o = lane; o < b - q; o += 32) {
      const int i = q + o;
      G[q * ldq + o] = __fma_rn(-v[i], w[q], __fma_rn(-w[i], v[q], Dt[k0 + o]));
    }
  }
}

// The reflector of x (b entries, shared) by warp 0, as the plain chase forms
// it: v and tau into the record rec (v then tau) and the log (vlog, tlog;
// null without a log), and the pivot column col[0 .. b - 1] (stride 1 in Q)
// set to (beta, 0, ..): beta = -sign(x0) |x|, tau = (beta - x0) / beta,
// v = x / (x0 - beta) with v0 = 1; where sigma2 = |x[1:]|^2 == 0, tau = 0,
// v0 = 0, the rest x, and the pivot keeps x0.
__device__ __forceinline__ void form_reflector(const Chase& a, const double* x, double* rec, double* vlog,
                               double* tlog, double* col) {
  const int b = a.b;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double part = 0.0;
    for (int i = lane; i < b; i += 32) {
      if (i >= 1) part = __fma_rn(x[i], x[i], part);
    }
    const double sigma2 = __shfl_sync(0xffffffffu, warp_sum(part), 0);
    const double x0 = x[0];
    const double nrm = __dsqrt_rn(__dadd_rn(__dmul_rn(x0, x0), sigma2));
    const double beta = x0 >= 0.0 ? -nrm : nrm;   // the sign avoids cancellation
    const bool no_op = sigma2 == 0.0;
    const double denom = no_op ? 1.0 : __dsub_rn(x0, beta);
    const double tau = no_op ? 0.0 : __ddiv_rn(__dsub_rn(beta, x0), beta);
    for (int i = lane; i < b; i += 32) {
      const double vi = i == 0 ? (no_op ? 0.0 : 1.0) : __ddiv_rn(x[i], denom);
      rec[i] = vi;
      if (vlog != nullptr) vlog[i] = vi;
      col[i] = i == 0 ? (no_op ? x0 : beta) : 0.0;
    }
    if (lane == 0) {
      rec[b] = tau;
      if (tlog != nullptr) *tlog = tau;
    }
  }
}

// The reflector of task (jj, kk) formed in wave t: its record for wave t + 1
// (slot (t + 1)/3 - jj), its log entry, the pivot column (stored column c0
// at rows c0 + i0 ..).
__device__ __forceinline__ void form_task(const Chase& a, int t, int jj, int kk, const double* x, int c0, int i0) {
  const int b = a.b, s = (t + 1) / 3 - jj;
  double* rec = a.rs + ((size_t)((t + 1) & 1) * a.wmax + s) * (b + 1);
  const bool log = a.Vw != nullptr;
  form_reflector(a, x, rec, log ? a.Vw + ((size_t)jj * a.kmax + kk) * b : nullptr,
                 log ? a.tw + (size_t)jj * a.kmax + kk : nullptr, qat(a, c0 + i0, c0));
}

template <int kT, bool kShared>
__global__ void __launch_bounds__(kT, kT == 256 ? 2 : 1) band_chase_kernel(const Chase a) {
  extern __shared__ double sh[];
  cg::grid_group grid = cg::this_grid();
  const int b = a.b, G = gridDim.x, ldq = 3 * b - 1;
  const long long nthreads = (long long)G * blockDim.x;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // pack B's lower band, each row's run read in order
  for (long long idx = gtid; idx < (long long)a.n * ldq; idx += nthreads) {
    const long long i = idx / ldq, c = i - (idx - i * ldq);
    if (c >= 0) a.Q[(c + 2LL * b) * ldq + i - c] = __ldg(a.B + i * a.ldb + c);
  }
  grid.sync();

  double* red = sh;                                  // 32
  double* v = red + 36;                              // b: the slot's v
  double* x = v + b;                                 // b: the next pivot column
  double* y = x + b;                                 // b: the diagonal block's D v, w
  double* w = y + b;                                 // w1 of the tile's columns
  double* part = w + (a.whole ? 4 * b - 2 : max(a.chunk, b));   // nthr()
  double* T = kShared ? part + nthr() : a.gwork + (size_t)blockIdx.x * a.work;
  const bool log = a.Vw != nullptr;
  for (int t = -1; t < a.twaves; ++t) {
    const int W = wave_width(a.n, b, t, a.wmax);
    const int j1 = (t + 1) / 3;                      // sweep of a hop-0 reflector
    const int hop0 = (t + 1) % 3 == 0 && j1 <= a.n - 3 ? 1 : 0;
    // the wave's chunk: the narrowest from kChunkMin up that keeps its
    // items to one round of the grid, else chunk (the same in every block)
    int chunk = a.chunk, nleft = 0, nnext = 0, items = 1;
    if (!a.whole) {
      for (int c = kChunkMin;; c *= 2) {
        chunk = min(c, a.chunk);
        nleft = (2 * b - 1 + chunk - 1) / chunk;
        nnext = (b + chunk - 1) / chunk;
        items = 1 + nleft + nnext + (b - 1 + chunk - 1) / chunk;
        if (chunk == a.chunk || W * items + hop0 <= G) break;
      }
    }
    const int nitems = W * items + hop0;
    if (nitems == 0) continue;                       // the same for every block
    for (int it = blockIdx.x; it < nitems; it += G) {
      if (it == W * items) {
        // sweep j1's first reflector, from column j1 (rows j1 + 1 .. j1 + b)
        for (int i = threadIdx.x; i < b; i += nthr()) x[i] = __ldcg(qat(a, j1 + 1 + i, j1));
        __syncthreads();
        double* rec = a.rs + (size_t)((t + 1) & 1) * a.wmax * (b + 1);
        form_reflector(a, x, rec, log ? a.Vw + (size_t)j1 * a.kmax * b : nullptr,
                       log ? a.tw + (size_t)j1 * a.kmax : nullptr, qat(a, j1 + 1, j1));
        __syncthreads();
        continue;
      }
      const int s = it / items, qi = it - s * items;
      const Slot q = slot_of(b, t, s);
      const double* rec = a.rs + ((size_t)(t & 1) * a.wmax + s) * (b + 1);
      const bool ahead = q.jj + (q.kk + 1) * b + 2 <= a.n - 1;   // the next hop is live
      // the item's kind: 0 the diagonal block, 1 .. nleft left chunks, then
      // nnext chunks of the next hop's columns, then right chunks; or the
      // whole task
      int kind, c0 = 0, c1 = 0;
      if (a.whole) {
        kind = 4;
      } else if (qi == 0) {
        kind = 0;
      } else if (qi <= nleft) {
        kind = 1;
        c0 = (qi - 1) * chunk;
        c1 = min(c0 + chunk, 2 * b - 1);
      } else if (qi <= nleft + nnext) {
        kind = 2;
        c0 = 2 * b - 1 + (qi - nleft - 1) * chunk;
        c1 = min(c0 + chunk, 3 * b - 1);
      } else {
        kind = 3;
        c0 = 3 * b - 1 + (qi - nleft - nnext - 1) * chunk;
        c1 = min(c0 + chunk, 4 * b - 2);
      }
      // v and tau from the record, in flight beside the tiles' loads
      double vr = 0.0;
      if (threadIdx.x < b) vr = __ldcg(rec + threadIdx.x);
      for (int i = threadIdx.x + nthr(); i < b; i += nthr()) v[i] = __ldcg(rec + i);
      const double tau = __ldcg(rec + b);
      if (kind == 0) {
        load_diag<kShared>(a, q.r, T);
      } else if (kind != 4) {
        load_strip<kShared>(a, q.r, c0, c1 - c0, T, c1 - c0 + 1);
      } else {
        // a whole task (b <= 32, T in shared memory): both strips and the
        // packed block in one round of copies
        const int ld = 4 * b - 1;
        load_strip<kShared>(a, q.r, 0, 2 * b - 1, T, ld);
        load_strip<kShared>(a, q.r, 2 * b - 1, 2 * b - 1, T + 2 * b - 1, ld);
        load_diag<kShared>(a, q.r, T + (size_t)b * ld);
      }
      if (kShared) copy_wait();
      if (threadIdx.x < b) v[threadIdx.x] = vr;
      __syncthreads();
      if (kind == 0) {
        update_diag(a, q.r, tau, T, v, y, part, red);
      } else if (kind != 4) {
        const int nc = c1 - c0;
        column_dots(T, nc + 1, b, nc, v, tau, w, part);
        store_strip(a, q.r, c0, nc, T, nc + 1, v, w, q.pivot, kind == 2 && ahead ? x : nullptr);
      } else {
        // a whole task: the last warp updates the diagonal block while the
        // others (a team on a named barrier) update the strips
        const int ld = 4 * b - 1;
        if ((int)threadIdx.x >= nthr() - 32) {
          update_diag_warp(a, q.r, tau, T + (size_t)b * ld, v, y);
        } else {
          const Team team{static_cast<int>(threadIdx.x), nthr() - 32, 1};
          column_dots(T, ld, b, 4 * b - 2, v, tau, w, part, team);
          store_strip(a, q.r, 0, 2 * b - 1, T, ld, v, w, q.pivot, nullptr, team);
          store_strip(a, q.r, 2 * b - 1, 2 * b - 1, T + 2 * b - 1, ld, v, w + 2 * b - 1,
                      q.pivot, ahead ? x : nullptr, team);
          if (ahead) {    // warp 0 forms the next reflector, the block's warp D aside
            team.sync();
            form_task(a, t, q.jj, q.kk + 1, x, q.r, b);
          }
        }
      }
      // the next hop's reflector (a whole task's formed above): by the last
      // of the slot's next items to finish (its parts through xs; an arrival
      // count, no wait)
      bool form = ahead && kind == 2 && nnext == 1;
      if (ahead && kind == 2 && nnext > 1) {
        int* last = reinterpret_cast<int*>(red + 32);
        double* xs = a.xs + (size_t)s * b;
        __syncthreads();
        for (int m = c0 - (2 * b - 1) + threadIdx.x; m < c1 - (2 * b - 1); m += nthr()) xs[m] = x[m];
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) *last = atomicAdd(a.arrived + s, 1) == nnext - 1;
        __syncthreads();
        form = *last != 0;
        if (form) {
          __threadfence();
          for (int m = threadIdx.x; m < b; m += nthr()) x[m] = __ldcg(xs + m);
          if (threadIdx.x == 0) a.arrived[s] = 0;
        }
      }
      if (form) {
        __syncthreads();
        form_task(a, t, q.jj, q.kk + 1, x, q.r, b);
      }
      __syncthreads();
    }
    grid.sync();
  }
  for (long long i = gtid; i < a.n; i += nthreads) {
    a.d[i] = __ldcg(qat(a, (int)i, (int)i));
    if (i < a.n - 1) a.e[i] = __ldcg(qat(a, (int)i + 1, (int)i));
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

// band_chase's block: 256 threads a whole task, else 512 an item.
int chase_threads(bool whole) { return whole ? 256 : 512; }

// Its instances: a whole task a block (b <= 32, the tile always in shared
// memory), else items with the tile in shared memory or a global scratch.
const void* chase_kernel(bool whole, bool shared) {
  if (whole) return (const void*)band_chase_kernel<256, true>;
  return shared ? (const void*)band_chase_kernel<512, true>
                : (const void*)band_chase_kernel<512, false>;
}

}  // namespace

// (blocks of band_chase (a whole task a block when `whole`) one SM holds at
// `smem` dynamic shared bytes, the SM
// count, the shared bytes a block may opt into) of the current device, into
// out[0..2]; opts the kernel into that much shared memory first.
extern "C" int band_chase_occupancy(int whole, int smem, void* out) {
  const int threads = chase_threads(whole != 0);
  const int err = whole ? 0 : coop_occupancy(chase_kernel(false, false), threads, smem, out);
  return err != 0 ? err : coop_occupancy(chase_kernel(whole != 0, true), threads, smem, out);
}

// The whole chase of B (n, n) f64, row stride ldb, band b (n >= 3, b >= 2;
// B symmetric, its lower band read): Q zero-filled (n + 3b) x (3b - 1);
// Vw (n - 1, kmax, b) and tw (n - 1, kmax) zero-filled, or both null (no
// log); d (n,), e (n - 1,); rs 2 wmax (b + 1) and xs wmax b doubles, arrived
// wmax ints zero-filled; gwork grid * work
// doubles unless work_shared; a block a whole task when `whole`, else items
// of up to `chunk` strip columns (each wave the narrowest of kChunkMin,
// 2 kChunkMin, .. chunk that keeps the wave's items to one round of the
// grid).  grid, smem from
// kernels/band_reduce.py::chase_plan after band_chase_occupancy on this
// device.  One cooperative kernel on `stream`; allocates nothing; returns
// the launch's cudaError_t.
extern "C" int band_chase_launch(const void* B, long long ldb, void* Q, void* Vw, void* tw,
                                 void* d, void* e, void* rs, void* xs, void* arrived, void* gwork,
                                 long long work, int work_shared, int n, int b, int chunk,
                                 int whole, int grid, int smem, void* stream) {
  const long long tri = (long long)b * (b + 1) / 2;
  const long long strip = whole ? (long long)b * (4 * b - 1) : (long long)b * (chunk + 1);
  if (n < 3 || b < 2 || chunk < 1 || grid < 1 || ldb < n || (Vw == nullptr) != (tw == nullptr)
      || (whole && (b > 32 || !work_shared))
      || work < (whole ? tri + strip : (tri > strip ? tri : strip))
      || (!work_shared && gwork == nullptr) || rs == nullptr || xs == nullptr
      || arrived == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kmax = (n - 3) / b;
  Chase a{static_cast<const double*>(B), ldb, static_cast<double*>(Q),
          static_cast<double*>(Vw), static_cast<double*>(tw), static_cast<double*>(d),
          static_cast<double*>(e), static_cast<double*>(rs), static_cast<double*>(xs),
          static_cast<int*>(arrived), static_cast<double*>(gwork), work, work_shared, n, b,
          kmax + 1, kmax / 3 + 1, 3 * (n - 3) + 1, chunk, whole};
  const long long cols = whole ? 4LL * b - 2 : (chunk > b ? chunk : b);
  const int threads = chase_threads(whole != 0);
  const long long need = 8LL * (36 + 3LL * b + cols + threads + (work_shared ? work : 0));
  if (smem < need) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  return coop_launch(chase_kernel(whole != 0, work_shared != 0), grid, threads, args, smem,
                     stream);
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
