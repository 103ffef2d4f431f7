// The dense reduction's column step and the compact-WY T factor.
//
// Replaces two device loops of the JAX package that hold no pallas_call:
//  - symmetric_eigenvalue_tpu/kernels/tridiagonalize.py::_tridiagonalize_block,
//    its column body `col_body` (:114), run by the lax.fori_loops at :139
//    (columns of a panel) and :146 (panels).  JAX compiles the loop into one
//    program; the port drove it from Python with ~31 small launches a column.
//    Here a column is three launches: column_reflector (K1), the unchanged
//    dword_vecmat matvec (K2, csrc/dword_matvec.cu) and column_w (K3).
//  - _larft (:213), its lax.fori_loop at :227 (two launches a reflector in the
//    port's torch loop): larft, one launch a panel.
//
// The column step at local column j of a bucket of width m, panel offset o,
// jj = j - o, with Vp / Wp the panel's reflector and W accumulator rows
// (row stride ld = m) and As the bucket's trailing matrix (row stride lda):
//  K1  a[i] = As[j,i] - sum_{k<jj} Vp[k,i] Wp[k,j] - sum_{k<jj} Wp[k,i] Vp[k,j]
//      for i >= j+1 (all the Householder vector reads), sigma2 = sum_{i>=j+2}
//      a[i]^2, the pivot, norm, alpha, tau and the no-op flag, v written into
//      Vp[jj] and (tau, alpha) into te[j]; also p = Wp[:jj] v and q = Vp[:jj] v
//      (sum_i Wp[k,i] a[i] is gathered while the block holds those rows, and
//      divided by the pivot's denominator at the end).
//  K2  y = v[j+1:] @ As[j+1:]  (dword_vecmat).
//  K3  Wp[jj] = tau (y - Vp[:jj]^T p - Wp[:jj]^T q) - half v with
//      half = 0.5 tau^2 (y.v - 2 p.q): v.(A_updated v) = y.v - 2 p.q because
//      Vp[k].v = q[k] and Wp[k].v = p[k], so no second pass over w.
// The last column of the last bucket (j = m - 2) has nothing below its pivot:
// K1 alone, in identity mode, writes te[j][1] = a[j+1] and zeroes Wp[jj] (v
// and tau stay zero), as the plain loop does.
//
// What bounds the step on an H100: K2's bytes (the bucket's rows below the
// pivot, ~0.64 ms at 16384 x 16384).  K1 and K3 read 2 jj + 1 rows of the
// panel (about 16 MB at m = 16384, jj = 31, mostly from L2: ~5 us at HBM
// rate); what they must avoid is host pace, so each is one launch with a grid
// over the row and an arrival counter (as dword_matvec.cu) whose last block
// finishes the step: K1's scales v by the pivot's denominator, K3's adds the
// -half v term.  Sums across blocks are taken in block order: the same result
// from run to run.
//
// larft: T (nb x nb, upper) with T[k,k] = tau_k and
// T[:k,k] = -tau_k T[:k,:k] G[:k,k] for k = 0..nb-1, from the panel's Gram G.
// It is latency-bound: nb-1 dependent triangular matvecs.  One block, one
// thread a row of T; T's columns packed in shared memory (nb (nb+1)/2
// doubles, 66 KB at nb = 128) beside G's column k, staged each step, or,
// past what a block may hold, in a global scratch; at step k every thread
// walks l = 0..k-1 together, so the threads read neighbouring entries of
// column l of T and one broadcast G[l,k].
//
// Contractions are fused multiply-adds (__fma_rn); every other rounding is
// written out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // K1 and K3: one row entry a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPanel = 1024; // nb the column step takes (shared memory)
constexpr int kCache = 32;      // panel rows a thread holds in registers
constexpr int kBatch = 8;       // a last block's loads in flight per thread

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The block's partial of row r (lane 0 of each warp has stored its warp's
// sum at wpart[warp * R + r]) in warp order.
__device__ __forceinline__ double block_partial(const double* wpart, int R, int r) {
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, wpart[w * R + r]);
  return s;
}

// Rows r = warp, warp + kWarps, ... of the (blocks x R) partials, summed
// over blocks by one warp each (lanes over blocks, then a fixed tree):
// into tot[r].
__device__ void sum_partials(const double* ws, int blocks, int R, double* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += kWarps) {
    double s = 0.0;
    for (int b = lane; b < blocks; b += 32) s = __dadd_rn(s, __ldcg(ws + (size_t)b * R + r));
    s = warp_sum(s);
    if (lane == 0) tot[r] = s;
  }
}

__device__ __forceinline__ bool arrive_last(unsigned int* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

__global__ void __launch_bounds__(kThreads)
column_reflector_kernel(const double* __restrict__ As, long long lda, double* Vp,
                        double* Wp, int ld, double* te, double* pq, double* ws,
                        unsigned int* counter, int m, int j, int jj, int identity) {
  extern __shared__ double sh[];
  const int R = 2 * jj + 1;               // sigma2, then jj of P, jj of Q
  double* vj = sh;                        // Vp[k][j]
  double* wj = sh + jj;                   // Wp[k][j]
  double* wpart = sh + 2 * jj;            // kWarps x R
  double* tot = wpart + kWarps * R;       // R, then the scalars
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < jj; k += kThreads) {
    vj[k] = Vp[(size_t)k * ld + j];
    wj[k] = Wp[(size_t)k * ld + j];
  }
  __syncthreads();

  // the delayed row, one entry a thread; the panel's first kCache rows
  // stay in registers (all their loads in flight at once) for the sums
  // below, wider panels load the rest twice
  const int i = j + 1 + blockIdx.x * kThreads + tid;
  const bool in = i < m;
  double vr[kCache], wr[kCache];
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    vr[k] = (in && k < jj) ? __ldg(Vp + (size_t)k * ld + i) : 0.0;
    wr[k] = (in && k < jj) ? __ldg(Wp + (size_t)k * ld + i) : 0.0;
  }
  double a = 0.0;
  if (in) {
    double s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      if (k < jj) {
        s1 = __fma_rn(vr[k], wj[k], s1);
        s2 = __fma_rn(wr[k], vj[k], s2);
      }
    }
    for (int k = kCache; k < jj; ++k) {
      s1 = __fma_rn(__ldg(Vp + (size_t)k * ld + i), wj[k], s1);
      s2 = __fma_rn(__ldg(Wp + (size_t)k * ld + i), vj[k], s2);
    }
    a = __dsub_rn(__dsub_rn(As[(size_t)j * lda + i], s1), s2);
  }
  if (identity) {
    // j = m - 2: the identity reflector; v and tau stay zero
    if (in) te[1] = a;
    for (int c = tid; c < m; c += kThreads) Wp[(size_t)jj * ld + c] = 0.0;
    return;
  }
  if (in) Vp[(size_t)jj * ld + i] = a;    // scaled into v by the last block

  // sigma2, P[k] = sum Wp[k][i] a[i], Q[k] = sum Vp[k][i] a[i] over i >= j+2
  const double am = (in && i >= j + 2) ? a : 0.0;
  double x = warp_sum(__dmul_rn(am, am));
  if (lane == 0) wpart[warp * R] = x;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    if (k < jj) {
      const double pw = warp_sum(__dmul_rn(wr[k], am));
      const double pv = warp_sum(__dmul_rn(vr[k], am));
      if (lane == 0) {
        wpart[warp * R + 1 + k] = pw;
        wpart[warp * R + 1 + jj + k] = pv;
      }
    }
  }
  for (int k = kCache; k < jj; ++k) {
    const double wk = in ? __ldg(Wp + (size_t)k * ld + i) : 0.0;
    const double vk = in ? __ldg(Vp + (size_t)k * ld + i) : 0.0;
    const double pw = warp_sum(__dmul_rn(wk, am));
    const double pv = warp_sum(__dmul_rn(vk, am));
    if (lane == 0) {
      wpart[warp * R + 1 + k] = pw;
      wpart[warp * R + 1 + jj + k] = pv;
    }
  }
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) ws[(size_t)blockIdx.x * R + r] = block_partial(wpart, R, r);

  if (!arrive_last(counter)) return;
  sum_partials(ws, gridDim.x, R, tot);
  __syncthreads();
  double* scal = tot + R;                 // denom, unit
  if (tid == 0) {
    const double pivot = __ldcg(Vp + (size_t)jj * ld + j + 1);
    const double sigma2 = tot[0];
    const double norm = __dsqrt_rn(__dadd_rn(sigma2, __dmul_rn(pivot, pivot)));
    double alpha = pivot >= 0.0 ? -norm : norm;   // sign avoids cancellation
    const bool no_op = sigma2 == 0.0;             // already tridiagonal here
    const double denom = no_op ? 1.0 : __dsub_rn(pivot, alpha);
    const double tau = no_op ? 0.0 : __ddiv_rn(__dsub_rn(alpha, pivot), alpha);
    alpha = no_op ? pivot : alpha;
    const double unit = no_op ? 0.0 : 1.0;
    te[0] = tau;
    te[1] = alpha;
    scal[0] = denom;
    scal[1] = unit;
    Vp[(size_t)jj * ld + j + 1] = unit;
  }
  __syncthreads();
  const double denom = scal[0], unit = scal[1];
  for (int k = tid; k < jj; k += kThreads) {
    pq[k] = __fma_rn(__ldg(Wp + (size_t)k * ld + j + 1), unit, __ddiv_rn(tot[1 + k], denom));
    pq[jj + k] = __fma_rn(__ldg(Vp + (size_t)k * ld + j + 1), unit,
                          __ddiv_rn(tot[1 + jj + k], denom));
  }
  double* row = Vp + (size_t)jj * ld;
  for (int c0 = j + 2 + tid; c0 < m; c0 += kBatch * kThreads) {
    double x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      x[u] = c < m ? __ldcg(row + c) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c < m) row[c] = __ddiv_rn(x[u], denom);
    }
  }
  if (tid == 0) *counter = 0u;
}

__global__ void __launch_bounds__(kThreads)
column_w_kernel(const double* __restrict__ y, const double* Vp, double* Wp, int ld,
                const double* te, const double* pq, double* ws, unsigned int* counter,
                int m, int j, int jj) {
  __shared__ double wpart[kWarps];
  __shared__ double half_s;
  extern __shared__ double sh[];
  double* p = sh;                         // jj
  double* q = sh + jj;                    // jj
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < jj; k += kThreads) {
    p[k] = pq[k];
    q[k] = pq[jj + k];
  }
  const double tau = te[0];
  __syncthreads();

  const int i = blockIdx.x * kThreads + tid;
  const bool in = i < m;
  double sv = 0.0;
  if (in) {
    double s1 = 0.0, s2 = 0.0;
#pragma unroll 16
    for (int k = 0; k < jj; ++k) {
      s1 = __fma_rn(__ldg(Vp + (size_t)k * ld + i), p[k], s1);
      s2 = __fma_rn(__ldg(Wp + (size_t)k * ld + i), q[k], s2);
    }
    const double yi = y[i];
    Wp[(size_t)jj * ld + i] = __dmul_rn(tau, __dsub_rn(__dsub_rn(yi, s1), s2));
    if (i >= j + 1) sv = __dmul_rn(yi, Vp[(size_t)jj * ld + i]);
  }
  const double x = warp_sum(sv);
  if (lane == 0) wpart[warp] = x;
  __syncthreads();
  if (tid == 0) ws[blockIdx.x] = block_partial(wpart, 1, 0);

  if (!arrive_last(counter)) return;
  sum_partials(ws, gridDim.x, 1, &half_s);   // y.v
  __syncthreads();
  if (tid == 0) {
    double pdotq = 0.0;
    for (int k = 0; k < jj; ++k) pdotq = __fma_rn(p[k], q[k], pdotq);
    // v.(A_updated v) = y.v - 2 p.q; half = 0.5 tau (tau v.(A v)) as the
    // plain loop's dot(w, v) * tau * 0.5
    const double vav = __fma_rn(-2.0, pdotq, half_s);
    half_s = __dmul_rn(__dmul_rn(__dmul_rn(tau, vav), tau), 0.5);
  }
  __syncthreads();
  const double half = half_s;
  double* wrow = Wp + (size_t)jj * ld;
  const double* vrow = Vp + (size_t)jj * ld;
  for (int c0 = j + 1 + tid; c0 < m; c0 += kBatch * kThreads) {
    double x[kBatch], v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      x[u] = c < m ? __ldcg(wrow + c) : 0.0;
      v[u] = c < m ? vrow[c] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c < m) wrow[c] = __fma_rn(-half, v[u], x[u]);
    }
  }
  if (tid == 0) *counter = 0u;
}

__global__ void larft_kernel(const double* __restrict__ G, const double* __restrict__ tau,
                             double* __restrict__ T, double* gscratch, int nb,
                             int use_shared) {
  extern __shared__ double sh[];
  double* gk = use_shared ? sh : gscratch;   // column k of G, staged
  double* tc = gk + nb;                      // T's column l at l (l + 1) / 2
  const int tid = threadIdx.x;
  if (tid == 0) tc[0] = tau[0];
  for (int k = 1; k < nb; ++k) {
    for (int l = tid; l < k; l += blockDim.x) gk[l] = G[(size_t)l * nb + k];
    __syncthreads();                         // gk and T's columns < k
    const double ntau = -tau[k];
    const size_t colk = (size_t)k * (k + 1) / 2;
    for (int r0 = 0; r0 < k; r0 += blockDim.x) {
      const int r = r0 + tid;
      double acc = 0.0;
      // rows r < k, summed over l = r..k-1 (T is upper triangular): the
      // threads walk l together, reading neighbouring entries of column l
#pragma unroll 8
      for (int l = r0; l < k; ++l) {
        if (r <= l) acc = __fma_rn(tc[(size_t)l * (l + 1) / 2 + r], gk[l], acc);
      }
      if (r < k) tc[colk + r] = __dmul_rn(acc, ntau);
    }
    if (tid == 0) tc[colk + k] = tau[k];
    __syncthreads();                         // before gk is overwritten
  }
  __syncthreads();
  for (int idx = tid; idx < nb * nb; idx += blockDim.x) {
    const int r = idx / nb, c = idx - r * nb;
    T[idx] = r <= c ? tc[(size_t)c * (c + 1) / 2 + r] : 0.0;
  }
}

}  // namespace

// Shared memory of the column step's kernels for a panel of nb columns.
static size_t reflector_shmem(int jj) {
  const int R = 2 * jj + 1;
  return sizeof(double) * (size_t)(2 * jj + kWarps * R + R + 2);
}

// As: the bucket's (m, m) f64 matrix, unit column stride, row stride lda.
// Vp, Wp: the panel's reflector and W rows (row stride ld >= m), rows < jj
// complete; te: (tau, alpha) of column j (2 doubles); pq: 2 jj doubles
// (out: p, q); ws: ceil((m - j - 1) / 256) * (2 jj + 1) doubles of scratch;
// counter: one zeroed unsigned int, left zeroed.  identity (j = m - 2): one
// block, te[1] and Wp[jj] only.  0 <= j <= m - 2, 0 <= jj < 1024.  Launches
// one kernel on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int column_reflector_launch(const void* As, long long lda, void* Vp, void* Wp,
                                       int ld, void* te, void* pq, void* ws, void* counter,
                                       int m, int j, int jj, int identity, void* stream) {
  if (m < 2 || j < 0 || j > m - 2 || jj < 0 || jj >= kMaxPanel || ld < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shmem = reflector_shmem(jj);
  if (shmem > 48 * 1024) {
    // panels wider than 170 columns (164 KB at the widest)
    const cudaError_t err = cudaFuncSetAttribute(
        column_reflector_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(reflector_shmem(kMaxPanel - 1)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (m - j - 1 + kThreads - 1) / kThreads;
  column_reflector_kernel<<<blocks, kThreads, shmem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(As), lda, static_cast<double*>(Vp),
      static_cast<double*>(Wp), ld, static_cast<double*>(te), static_cast<double*>(pq),
      static_cast<double*>(ws), static_cast<unsigned int*>(counter), m, j, jj,
      identity ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// y: K2's (m,) output; Vp (row jj = v), Wp (out: row jj), te, pq as K1 left
// them; ws: ceil(m / 256) doubles; counter as above.  One kernel on `stream`.
extern "C" int column_w_launch(const void* y, const void* Vp, void* Wp, int ld,
                               const void* te, const void* pq, void* ws, void* counter,
                               int m, int j, int jj, void* stream) {
  if (m < 2 || j < 0 || j > m - 3 || jj < 0 || jj >= kMaxPanel || ld < m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (m + kThreads - 1) / kThreads;
  column_w_kernel<<<blocks, kThreads, sizeof(double) * (size_t)(2 * jj),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(y), static_cast<const double*>(Vp),
      static_cast<double*>(Wp), ld, static_cast<const double*>(te),
      static_cast<const double*>(pq), static_cast<double*>(ws),
      static_cast<unsigned int*>(counter), m, j, jj);
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
