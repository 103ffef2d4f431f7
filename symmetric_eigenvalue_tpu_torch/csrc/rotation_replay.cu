// rotation_replay: a tree level's Givens deflation rotations (the MergeRep's
// rotation log) replayed in place, in two launch forms of one source.
//
// rotation_replay (the downsweep, y (k*m, C)) replaces the device loop of
// symmetric_eigenvalue_tpu/kernels/assemble.py::_replay_rotations_level (a
// lax.fori_loop over max(nwave) waves, no pallas_call), called from
// kernels/assemble.py::_apply_u_finish on every level of the downsweep:
//
//   for w = nwave_b .. 1, every logged rotation i < nrot_b of merge b with
//   rot_wave[b, i] == w (a = rot_a[b, i], b' = rot_b[b, i]):
//     y[a]  <- c*y[a] + s*y[b']
//     y[b'] <- -s*y[a] + c*y[b']      (both from the values before the step)
//
// rotation_replay_t (the upsweep's transposed chain, wt (k*m, r), r <= 2)
// replaces ::_replay_rotations_cols_t (assemble.py:106; loops :124, :143),
// called by kernels/assemble.py::rows_through_merge on every non-root level:
//
//   for w = 1 .. nwave_b, every rotation of wave w:
//     wt[a]  <- c*wt[a] - s*wt[b']
//     wt[b'] <- s*wt[a] + c*wt[b']
//
// Rotations of one wave touch disjoint rows (the deflation tree pairs slots
// of disjoint blocks at each level), so a wave's rotations may run in any
// order and at once.  Every value is the product of separate IEEE roundings
// (mul, mul, add or sub: __fmul_rn / __fadd_rn / __fsub_rn and the double
// forms, no FMA contraction), with c and s first rounded to the data's type
// (the downsweep form reads them in f64, the transposed one in its data's):
// bit for bit the PyTorch wave loops, which run them as separate elementwise
// kernels.  Nothing is read on the host: a launch reads nrot, nwave and the
// log itself, so it is the same whatever the data (a CUDA graph can hold it).
//
// What bounds them on an H100.  The downsweep: bytes, 4*nrot*C*sizeof(T) for
// a level (two rows read and written a rotation); the heavy levels (the
// Poisson matrix's, thousands of rotations in one wave) stream at that rate,
// the light ones (a random spectrum's, tens of rotations in chains up to 9
// waves deep over hundreds of merges) are a few dependent round trips.  The
// transposed form: 4*r*sizeof(T) bytes a rotation, far below its latency
// floor of one L2 round trip a wave.
//
// Design of the downsweep form.  A column of y meets only its own values,
// so a thread that owns some columns applies the whole chain to them in
// order with no barrier between waves.  Work items are (merge, column tile,
// rotation slice): a tile is 256 threads x VEC columns (16-byte loads where
// C and y allow), a merge whose log holds one wave is cut into slices of
// kSlice rotations (independent, so its items run anywhere at once), any
// other merge is one slice.  The grid is what the SMs hold (the occupancy
// API, from the wrapper); every block reads nrot and nwave of 256 merges at
// a time, scans their item counts, and takes every gridDim-th item, so a
// merge with no rotation costs one load.  An item stages its rotations in
// shared memory once, as a counting sort by wave (kWaves buckets, in replay
// order), and its threads then apply bucket after bucket, kUnroll rotations
// of a bucket at a time (2*kUnroll rows of 16 bytes in flight a thread,
// kBlocksPerSm blocks of them an SM).  A
// merge whose log passes kStage entries or kWaves waves is staged a wave at
// a time by scanning its log in windows (slow, never dropped).
//
// Design of the transposed form.  r <= 2 columns leave nothing to share
// across columns, so the threads of a block take a merge's rotations: one
// wave's at a time (a counting sort of their indices by wave), __syncthreads
// between non-empty waves, kUnrollT rotations a thread at a time; a one-wave
// log is applied straight from global memory.  Blocks stride over merges.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads a block (both forms)
constexpr int kWaves = 32;      // wave buckets of the counting sort
constexpr int kStage = 512;     // downsweep: log entries staged at once
constexpr int kPer = kStage / kThreads;
constexpr int kSlice = 32;      // downsweep: rotations a one-wave item
constexpr int kUnroll = 2;      // downsweep: rotations a thread has in flight
constexpr int kBlocksPerSm = 4; // downsweep: the register budget's target
constexpr int kStageT = 4096;   // transposed: log indices staged at once
constexpr int kUnrollT = 4;     // transposed: rotations a thread has in flight

// Phase probes, compiled only where KERNEL_PROBES is defined
// (tools/kernel_phase_probe.py): the downsweep form's thread 0 cycles
// (clock64) in the merge scan, the staging and the rotations, summed over
// every block, and the items the blocks took.
#ifdef KERNEL_PROBES
__device__ unsigned long long g_rr[4];
struct Probe {
  long long acc[3];
  long long prev;
  __device__ void start() {
    acc[0] = acc[1] = acc[2] = 0;
    prev = clock64();
  }
  __device__ void mark(int i) {
    const long long now = clock64();
    acc[i] += now - prev;
    prev = now;
  }
  __device__ void item() {
    if (threadIdx.x == 0) atomicAdd(&g_rr[3], 1ull);
  }
  __device__ void store() {
    if (threadIdx.x == 0)
      for (int i = 0; i < 3; ++i)
        atomicAdd(&g_rr[i], static_cast<unsigned long long>(acc[i]));
  }
};
#else
struct Probe {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void item() {}
  __device__ void store() {}
};
#endif

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ int bucket(long long w) {
  return static_cast<int>(min(max(w, 1ll), static_cast<long long>(kWaves))) - 1;
}

// Items of a merge in the downsweep form: its column tiles times its slices.
__device__ __forceinline__ long long merge_items(int nr, int nw, long long ntile) {
  if (nr <= 0) return 0;
  return ntile * (nw <= 1 ? (nr + kSlice - 1) / kSlice : 1);
}

// Inclusive sum of v over the block's threads.
__device__ __forceinline__ long long block_inclusive_scan(long long v, long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long t = lane < kThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += u;
    }
    if (lane < kThreads / 32) s_warp[lane] = t;
  }
  __syncthreads();
  return v + (warp ? s_warp[warp - 1] : 0);
}

// ---------------------------------------------------------------------------
// the downsweep form

template <typename T>
struct Staged {       // a block's staged rotations
  int a[kStage];
  int b[kStage];
  T c[kStage];
  T s[kStage];
};

// Rotations [i, end) of the stage, all of one wave, on this thread's VEC
// columns of the merge's rows (yb: row 0 of the merge at this column).
template <typename T, int VEC>
__device__ __forceinline__ void apply_rows(T* __restrict__ yb, long long C,
                                           const Staged<T>& st, int i, int end) {
  using P = Pack<T, VEC>;
  for (; i + kUnroll <= end; i += kUnroll) {
    P ua[kUnroll], ub[kUnroll];
    P* pa[kUnroll];
    P* pb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      pa[u] = reinterpret_cast<P*>(yb + static_cast<long long>(st.a[i + u]) * C);
      pb[u] = reinterpret_cast<P*>(yb + static_cast<long long>(st.b[i + u]) * C);
      ua[u] = *pa[u];
      ub[u] = *pb[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const T c = st.c[i + u], s = st.s[i + u];
      P na, nb;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        na.v[j] = add(mul(c, ua[u].v[j]), mul(s, ub[u].v[j]));
        nb.v[j] = add(mul(-s, ua[u].v[j]), mul(c, ub[u].v[j]));
      }
      *pa[u] = na;
      *pb[u] = nb;
    }
  }
  for (; i < end; ++i) {
    P* pa = reinterpret_cast<P*>(yb + static_cast<long long>(st.a[i]) * C);
    P* pb = reinterpret_cast<P*>(yb + static_cast<long long>(st.b[i]) * C);
    const P ua = *pa, ub = *pb;
    const T c = st.c[i], s = st.s[i];
    P na, nb;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      na.v[j] = add(mul(c, ua.v[j]), mul(s, ub.v[j]));
      nb.v[j] = add(mul(-s, ua.v[j]), mul(c, ub.v[j]));
    }
    *pa = na;
    *pb = nb;
  }
}

struct Log {          // a level's rotation log: (k, m) fields, (k,) counts
  const int64_t* a;
  const int64_t* b;
  const void* c;      // double (downsweep) or the data's type (transposed)
  const void* s;
  const int64_t* wave;
  const int64_t* nrot;
  const int64_t* nwave;
  long long sa, sb, sc, ss, sw;   // each field's row stride (elements)
  int k, m;
};

template <typename CT>
struct MergeLog {     // merge b's row of every field
  const int64_t* a;
  const int64_t* b;
  const CT* c;
  const CT* s;
  const int64_t* w;
};

template <typename CT>
__device__ __forceinline__ MergeLog<CT> merge_log(const Log& L, int b) {
  const long long r = b;
  return {L.a + r * L.sa, L.b + r * L.sb, static_cast<const CT*>(L.c) + r * L.sc,
          static_cast<const CT*>(L.s) + r * L.ss, L.wave + r * L.sw};
}

// One item: merge b (nr rotations, nw waves), column tile `tile`, slice
// `slice` (a one-wave merge's rotations [slice*kSlice, +kSlice)).  Every
// thread of the block calls it (it holds barriers).
template <typename T, int VEC>
__device__ __forceinline__ void replay_rows_item(
    const Log& L, T* y, long long C, int b, int nr, int nw, long long tile,
    int slice, Staged<T>& st, int* s_cnt, int* s_pos, int* s_count,
    Probe& pr) {
  const int tid = threadIdx.x;
  const MergeLog<double> lg = merge_log<double>(L, b);
  const long long col = tile * (static_cast<long long>(kThreads) * VEC)
                        + static_cast<long long>(tid) * VEC;
  const bool live = col < C;
  T* yb = y + static_cast<long long>(b) * L.m * C + col;
  if (nw <= 1) {
    // one wave: the slice's rotations in any order
    const int lo = slice * kSlice;
    const int n = min(kSlice, nr - lo);
    if (tid < n) {
      const int i = lo + tid;
      st.a[tid] = static_cast<int>(lg.a[i]);
      st.b[tid] = static_cast<int>(lg.b[i]);
      st.c[tid] = static_cast<T>(lg.c[i]);
      st.s[tid] = static_cast<T>(lg.s[i]);
    }
    __syncthreads();
    pr.mark(1);
    if (live) apply_rows<T, VEC>(yb, C, st, 0, n);
    __syncthreads();
  } else if (nr <= kStage && nw <= kWaves) {
    // the whole log at once, bucketed by wave in descending order
    if (tid < kWaves) s_cnt[tid] = 0;
    __syncthreads();
    int ea[kPer], eb[kPer], ew[kPer];
    T ec[kPer], es[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = tid + q * kThreads;
      ew[q] = -1;
      if (i < nr) {
        ea[q] = static_cast<int>(lg.a[i]);
        eb[q] = static_cast<int>(lg.b[i]);
        ec[q] = static_cast<T>(lg.c[i]);
        es[q] = static_cast<T>(lg.s[i]);
        ew[q] = bucket(lg.w[i]);
        atomicAdd(&s_cnt[ew[q]], 1);
      }
    }
    __syncthreads();
    if (tid == 0) {
      int pos = 0;
      for (int w = kWaves - 1; w >= 0; --w) {
        s_pos[w] = pos;
        pos += s_cnt[w];
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (ew[q] >= 0) {
        const int slot = atomicAdd(&s_pos[ew[q]], 1);
        st.a[slot] = ea[q];
        st.b[slot] = eb[q];
        st.c[slot] = ec[q];
        st.s[slot] = es[q];
      }
    }
    __syncthreads();
    pr.mark(1);
    // bucket w now spans [s_pos[w] - s_cnt[w], s_pos[w])
    if (live) {
      for (int w = kWaves - 1; w >= 0; --w) {
        const int n = s_cnt[w];
        if (n) apply_rows<T, VEC>(yb, C, st, s_pos[w] - n, s_pos[w]);
      }
    }
    __syncthreads();
  } else {
    // a long or deep log: a wave at a time, the log scanned in windows
    for (int w = nw; w >= 1; --w) {
      for (int base = 0; base < nr; base += kStage) {
        if (tid == 0) *s_count = 0;
        __syncthreads();
        const int end = min(base + kStage, nr);
        for (int i = base + tid; i < end; i += kThreads) {
          if (lg.w[i] == w) {
            const int slot = atomicAdd(s_count, 1);
            st.a[slot] = static_cast<int>(lg.a[i]);
            st.b[slot] = static_cast<int>(lg.b[i]);
            st.c[slot] = static_cast<T>(lg.c[i]);
            st.s[slot] = static_cast<T>(lg.s[i]);
          }
        }
        __syncthreads();
        pr.mark(1);
        if (live) apply_rows<T, VEC>(yb, C, st, 0, *s_count);
        __syncthreads();
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rotation_replay_kernel(Log L, T* y, long long C) {
  __shared__ Staged<T> st;
  __shared__ long long s_end[kThreads];
  __shared__ long long s_warp[kThreads / 32];
  __shared__ int s_nr[kThreads];
  __shared__ int s_nw[kThreads];
  __shared__ int s_cnt[kWaves];
  __shared__ int s_pos[kWaves];
  __shared__ int s_count;

  Probe pr;
  pr.start();
  const int tid = threadIdx.x;
  const long long ntile = (C + static_cast<long long>(kThreads) * VEC - 1)
                          / (static_cast<long long>(kThreads) * VEC);
  const long long G = gridDim.x;
  long long base = 0;    // the first item of this window of merges
  for (int c0 = 0; c0 < L.k; c0 += kThreads) {
    const int b = c0 + tid;
    int nr = 0, nw = 0;
    if (b < L.k) {
      nr = static_cast<int>(L.nrot[b]);
      nw = static_cast<int>(L.nwave[b]);
    }
    const long long incl = block_inclusive_scan(merge_items(nr, nw, ntile), s_warp);
    s_end[tid] = incl;
    s_nr[tid] = nr;
    s_nw[tid] = nw;
    __syncthreads();
    const long long total = s_end[kThreads - 1];
    pr.mark(0);
    for (long long j = base + (blockIdx.x - base % G + G) % G; j < base + total;
         j += G) {
      const long long local = j - base;
      int lo = 0, hi = kThreads - 1;     // the first merge with s_end > local
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] > local) hi = mid; else lo = mid + 1;
      }
      const long long within = local - (lo ? s_end[lo - 1] : 0);
      pr.item();
      replay_rows_item<T, VEC>(L, y, C, c0 + lo, s_nr[lo], s_nw[lo],
                                   within % ntile,
                                   static_cast<int>(within / ntile), st, s_cnt,
                                   s_pos, &s_count, pr);
      pr.mark(2);
    }
    base += total;
    __syncthreads();
  }
  pr.store();
}

// ---------------------------------------------------------------------------
// the transposed form

template <typename T, int R>
__device__ __forceinline__ void rotate_t(T* __restrict__ pa, T* __restrict__ pb,
                                         T c, T s) {
  T wa[R], wb[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    wa[j] = pa[j];
    wb[j] = pb[j];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    pa[j] = sub(mul(c, wa[j]), mul(s, wb[j]));
    pb[j] = add(mul(s, wa[j]), mul(c, wb[j]));
  }
}

// Rotations idx(i) for i in [lo, hi) stepping by kThreads from lo + tid, all
// of one wave, kUnrollT at a time (their rows' loads all out first).
template <typename T, int R, typename Idx>
__device__ __forceinline__ void apply_t(const MergeLog<T>& lg, T* wb, int lo,
                                        int hi, Idx idx) {
  int i = lo + threadIdx.x;
  for (; i + (kUnrollT - 1) * kThreads < hi; i += kUnrollT * kThreads) {
    T wa[kUnrollT][R], wv[kUnrollT][R], c[kUnrollT], s[kUnrollT];
    T* pa[kUnrollT];
    T* pb[kUnrollT];
#pragma unroll
    for (int u = 0; u < kUnrollT; ++u) {
      const int e = idx(i + u * kThreads);
      pa[u] = wb + lg.a[e] * R;
      pb[u] = wb + lg.b[e] * R;
      c[u] = static_cast<T>(lg.c[e]);
      s[u] = static_cast<T>(lg.s[e]);
    }
#pragma unroll
    for (int u = 0; u < kUnrollT; ++u) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        wa[u][j] = pa[u][j];
        wv[u][j] = pb[u][j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollT; ++u) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        pa[u][j] = sub(mul(c[u], wa[u][j]), mul(s[u], wv[u][j]));
        pb[u][j] = add(mul(s[u], wa[u][j]), mul(c[u], wv[u][j]));
      }
    }
  }
  for (; i < hi; i += kThreads) {
    const int e = idx(i);
    rotate_t<T, R>(wb + lg.a[e] * R, wb + lg.b[e] * R, static_cast<T>(lg.c[e]),
                   static_cast<T>(lg.s[e]));
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
rotation_replay_t_kernel(Log L, T* wt) {
  __shared__ int s_idx[kStageT];
  __shared__ int s_cnt[kWaves];
  __shared__ int s_pos[kWaves];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const auto staged = [&](int i) { return s_idx[i]; };
  for (int b = blockIdx.x; b < L.k; b += gridDim.x) {
    const int nr = static_cast<int>(L.nrot[b]);
    if (nr <= 0) continue;
    const int nw = static_cast<int>(L.nwave[b]);
    const MergeLog<T> lg = merge_log<T>(L, b);
    T* wb = wt + static_cast<long long>(b) * L.m * R;
    if (nw <= 1) {
      apply_t<T, R>(lg, wb, 0, nr, [](int i) { return i; });
    } else if (nr <= kStageT && nw <= kWaves) {
      __syncthreads();       // the previous merge's readers of s_cnt are done
      if (tid < kWaves) s_cnt[tid] = 0;
      __syncthreads();
      for (int i = tid; i < nr; i += kThreads) atomicAdd(&s_cnt[bucket(lg.w[i])], 1);
      __syncthreads();
      if (tid == 0) {
        int pos = 0;
        for (int w = 0; w < kWaves; ++w) {
          s_pos[w] = pos;
          pos += s_cnt[w];
        }
      }
      __syncthreads();
      for (int i = tid; i < nr; i += kThreads)
        s_idx[atomicAdd(&s_pos[bucket(lg.w[i])], 1)] = i;
      __syncthreads();
      // wave w now spans [s_pos[w] - s_cnt[w], s_pos[w])
      for (int w = 0; w < kWaves; ++w) {
        const int n = s_cnt[w];
        if (n == 0) continue;
        apply_t<T, R>(lg, wb, s_pos[w] - n, s_pos[w], staged);
        __syncthreads();     // the wave's stores before the next wave's loads
      }
    } else {
      // a long or deep log: a wave at a time, the log scanned in windows
      for (int w = 1; w <= nw; ++w) {
        for (int base = 0; base < nr; base += kStageT) {
          __syncthreads();
          if (tid == 0) s_count = 0;
          __syncthreads();
          const int end = min(base + kStageT, nr);
          for (int i = base + tid; i < end; i += kThreads)
            if (lg.w[i] == w) s_idx[atomicAdd(&s_count, 1)] = i;
          __syncthreads();
          apply_t<T, R>(lg, wb, 0, s_count, staged);
        }
      }
      __syncthreads();
    }
  }
}

// A yardstick (chip_smoke.l2_round_trip_cycles), never on a path: one
// thread chases indices through buf, `warm` steps (the whole cycle, back to
// 0) to bring them into L2, then `steps` timed ones with loads that skip L1
// (ld.global.cg); out[0] the timed steps' cycles, out[1] where the chase
// ended (keeps it live).
__global__ void l2_chase_kernel(const int* buf, int warm, int steps,
                                long long* out) {
  int j = 0;
  for (int i = 0; i < warm; ++i) j = __ldcg(buf + j);
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) j = __ldcg(buf + j);
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = j;
}

// The downsweep form's instances (its log in f64): f32 y takes VEC 4 or 1,
// f64 y 2 or 1.
const void* rows_instance(int y_f32, int vec) {
  if (y_f32 && vec == 4) return reinterpret_cast<const void*>(&rotation_replay_kernel<float, 4>);
  if (y_f32 && vec == 1) return reinterpret_cast<const void*>(&rotation_replay_kernel<float, 1>);
  if (!y_f32 && vec == 2) return reinterpret_cast<const void*>(&rotation_replay_kernel<double, 2>);
  if (!y_f32 && vec == 1) return reinterpret_cast<const void*>(&rotation_replay_kernel<double, 1>);
  return nullptr;
}

// The transposed form's instances (its log in the data's type).
const void* cols_instance(int w_f32, int r) {
  if (w_f32 && r == 2) return reinterpret_cast<const void*>(&rotation_replay_t_kernel<float, 2>);
  if (w_f32 && r == 1) return reinterpret_cast<const void*>(&rotation_replay_t_kernel<float, 1>);
  if (!w_f32 && r == 2) return reinterpret_cast<const void*>(&rotation_replay_t_kernel<double, 2>);
  if (!w_f32 && r == 1) return reinterpret_cast<const void*>(&rotation_replay_t_kernel<double, 1>);
  return nullptr;
}

Log make_log(const void* rot_a, const void* rot_b, const void* rot_c,
             const void* rot_s, const void* rot_wave, const void* nrot,
             const void* nwave, const long long* strides, int k, int m) {
  Log L;
  L.a = static_cast<const int64_t*>(rot_a);
  L.b = static_cast<const int64_t*>(rot_b);
  L.c = rot_c;
  L.s = rot_s;
  L.wave = static_cast<const int64_t*>(rot_wave);
  L.nrot = static_cast<const int64_t*>(nrot);
  L.nwave = static_cast<const int64_t*>(nwave);
  L.sa = strides[0];
  L.sb = strides[1];
  L.sc = strides[2];
  L.ss = strides[3];
  L.sw = strides[4];
  L.k = k;
  L.m = m;
  return L;
}

}  // namespace

// The downsweep form.  rot_a, rot_b, rot_wave: (k, m) int64; rot_c, rot_s:
// (k, m) f64; each field's rows contiguous, strides[5]
// their row strides (a, b, c, s, wave; host memory); nrot, nwave: (k,)
// int64; y: (k*m, C)
// contiguous, f32 (y_f32 = 1) or f64, updated in place; vec: columns a
// thread loads at once (4 or 1 for f32 y, 2 or 1 for f64; 16-byte loads need
// C a multiple of vec and y 16-byte aligned); grid: blocks of 256 threads
// (rotation_replay_info's blocks an SM times the SMs, or fewer); all on one
// device.  Returns the launch's cudaError_t.
extern "C" int rotation_replay_launch(const void* rot_a, const void* rot_b,
                                      const void* rot_c, const void* rot_s,
                                      const void* rot_wave, const void* nrot,
                                      const void* nwave,
                                      const long long* strides, void* y,
                                      int y_f32, int vec, int k, int m,
                                      long long C, int grid, void* stream) {
  if (k <= 0 || m <= 0 || C <= 0) return 0;
  const void* fn = rows_instance(y_f32, vec);
  if (fn == nullptr || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Log L = make_log(rot_a, rot_b, rot_c, rot_s, rot_wave, nrot, nwave, strides,
                   k, m);
  void* args[] = {&L, &y, &C};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args,
                                           0, static_cast<cudaStream_t>(stream)));
}

// The transposed form: the log as above but rot_c, rot_s in wt's type; wt
// (k*m, r) contiguous, r = 1 or 2, f32 (w_f32 = 1) or f64, updated in place;
// grid: blocks of 256 threads striding over the k merges.  Returns the
// launch's cudaError_t.
extern "C" int rotation_replay_t_launch(const void* rot_a, const void* rot_b,
                                        const void* rot_c, const void* rot_s,
                                        const void* rot_wave, const void* nrot,
                                        const void* nwave,
                                        const long long* strides, void* wt,
                                        int w_f32, int r, int k, int m,
                                        int grid, void* stream) {
  if (k <= 0 || m <= 0) return 0;
  const void* fn = cols_instance(w_f32, r);
  if (fn == nullptr || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Log L = make_log(rot_a, rot_b, rot_c, rot_s, rot_wave, nrot, nwave, strides,
                   k, m);
  void* args[] = {&L, &wt};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args,
                                           0, static_cast<cudaStream_t>(stream)));
}

// For the launch plan and the report, of one instance (transposed = 0: the
// downsweep form, `width` its vec; 1: the transposed form, `width` its r):
// out[0] registers a thread, out[1] local (stack and spill) bytes a thread,
// out[2] blocks an SM holds at once, out[3] the device's SMs, out[4] static
// shared bytes a block.  Returns a cudaError_t.
extern "C" int rotation_replay_info(int transposed, int data_f32, int width,
                                    int* out) {
  const void* fn = transposed ? cols_instance(data_f32, width)
                              : rows_instance(data_f32, width);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks;
  out[3] = sms;
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// The L2 round-trip yardstick: buf the chase's int32 cycle (device), out
// two int64 (device).  Returns the launch's cudaError_t.
extern "C" int rotation_replay_l2_chase(const void* buf, int warm, int steps,
                                        void* out, void* stream) {
  l2_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buf), warm, steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

#ifdef KERNEL_PROBES
// The probed copy's cycles (merge scan, staging, rotations; thread 0 of
// every block, summed) and items taken, then zeroed for the next launch.
extern "C" int rotation_replay_probe_read(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_rr, sizeof(g_rr));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_rr, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
