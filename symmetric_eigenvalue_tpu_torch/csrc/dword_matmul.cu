// dword_matmul: batched f64 GEMM, C[b] = A[b] @ B[b], and its fused in-place
// form C[b] -= A[b] @ B[b].
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/dword_matmul.py::dword_matmul,
// the f64-grade GEMM of the f64 downsweep (kernels/assemble.py::_apply_u_matmul),
// of the dense and banded front ends (panel Grams, rank-2k trailing updates,
// compact-WY back-transforms) and of the orthogonality self-check
// (utils/checks.py).  The TPU has no f64 unit and emulates the product with
// 21 exact bf16 passes (Ozaki slicing); Hopper has IEEE f64 tensor cores, so
// the same contract (an f64-accurate A @ B: every product and every sum is
// IEEE f64, only the order of the sums is the kernel's own) is a native GEMM.
//
// What bounds it on an H100 depends on the caller's shape:
//   * the downsweep's level products (2 x 2048x8192 @ 8192x8192) are bound by
//     FP64 operations, 2*M*N*K per batch entry at the tensor cores' rate;
//   * a panel Gram (32x16384 @ 16384x32) is bound by the bytes of A and B,
//     and a single output tile would sit on one of the 132 SMs;
//   * a rank-2k trailing update (16384x64 @ 64x16384, subtracted from C) is
//     bound by the bytes of C.
// What the design does about each:
//   * FP64 tensor cores: mma.sync.m16n8k4.f64 by inline PTX, f64 accumulators
//     in registers.  Two tile shapes, chosen by the launcher from (M, N):
//     128x128 per block with 8 warps of 64x32 (64 f64 accumulators a
//     thread) for large outputs, 32x64 with 4 warps of 32x16 for skinny
//     ones.
//   * a copy pipeline: cp.async (16 bytes a thread, 8 where a row is not
//     16-byte aligned) into a 4-stage ring in dynamic shared memory, three
//     k-steps of 16 in flight while the current one is multiplied, one
//     __syncthreads() a step.  Rows of the A tile are padded to 20 doubles
//     and rows of the B tile to BN + 4, so that the 8-byte fragment loads of
//     each half warp fall on 16 distinct bank pairs.  Ragged edges are
//     zero-filled by the copy's source size, so every shape is taken.  The
//     copies' addresses are worked out once per thread, not per step: their
//     instructions share the instruction slots with the mma (with the copies
//     taken out the large shape runs in the library's time; handing whole
//     rows to the copy engine with cp.async.bulk instead, 128 bytes a row,
//     was three times slower).
//   * split-K: the launcher is given S slices; blockIdx.z walks batch * S,
//     slice s multiplies its own k-range into scratch tile s, and a second
//     kernel adds the S partial tiles in slice order (no atomics: the result
//     is the same from run to run) and stores or subtracts.
//   * a fused epilogue: mode 1 reads the C tile (all loads of a 16-row group
//     before the first store), subtracts the product and writes it back (C
//     may be a strided view: row stride ldc, batch stride given), so a
//     trailing update passes over C twice, not four times.
// Its times beside its bounds are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;       // contraction depth of one pipeline stage
constexpr int STAGES = 4;
constexpr int SA = BK + 4;   // padded row of the A tile, in doubles

// n (0, 1 or 2) doubles from gmem to the 16-byte slot at shared address dst,
// the rest of the slot zero-filled.  VEC: gmem is 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void copy_pair(uint32_t dst, const double* gmem, int n,
                                          const double* any) {
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(8 * n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(n > 0 ? 8 : 0));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst + 8),
                 "l"(n > 1 ? gmem + 1 : any), "r"(n > 1 ? 8 : 0));
  }
}

// c (16x8) += a (16x4) b (4x8).  Lane = 4 g + t holds a[h] = A[g + 8 h][t],
// b = B[t][g] and c[2 h + v] = C[g + 8 h][2 t + v].
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// VEC: the rows of A and of B are 16-byte aligned (else the copies go 8
// bytes at a time).  vecC: so are the row pairs of C.  mode 0 stores the
// product, mode 1 subtracts it from C.
template <int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS, bool VEC>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32, MIN_BLOCKS)
dgemm_mma_kernel(const double* __restrict__ A, const double* __restrict__ B, double* C,
                 int M, int N, int K, long long ldc, long long strideC, int splits,
                 int kchunk, int mode, int vecC) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NI = WN / 8;
  constexpr int SB = BN + 4;
  constexpr int A_STAGE = BM * SA, B_STAGE = BK * SB;
  // a thread copies LA pairs of A, RA rows apart, and LB pairs of B, RB rows
  // apart, always at the same place in their rows
  constexpr int LA = (BM * BK / 2) / kThreads, RA = kThreads / (BK / 2);
  constexpr int LB = (BK * BN / 2) / kThreads, RB = kThreads / (BN / 2);
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert(kThreads % (BK / 2) == 0 && kThreads % (BN / 2) == 0 && LA * RA == BM &&
                    LB * RB == BK,
                "copies");

  extern __shared__ __align__(16) double smem[];
  double* As = smem;                      // [STAGES][BM][SA]
  double* Bs = smem + STAGES * A_STAGE;   // [STAGES][BK][SB]

  const int bz = blockIdx.z / splits, sl = blockIdx.z % splits;
  A += (size_t)bz * M * K;
  B += (size_t)bz * K * N;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int kbeg = sl * kchunk;
  const int klen = min(K, kbeg + kchunk) - kbeg;
  const int nk = (klen + BK - 1) / BK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;

  // Everything about this thread's copies that does not change from step
  // to step is worked out once: the loop's own instructions are few, and
  // they compete with the mma for the instruction slots.
  const int kkA = (tid % (BK / 2)) * 2, rA = tid / (BK / 2);
  const int ccB = (tid % (BN / 2)) * 2, rB = tid / (BN / 2);
  const double* srcA = A + (size_t)(row0 + rA) * K + kbeg + kkA;
  const double* srcB = B + (size_t)(kbeg + rB) * N + col0 + ccB;
  const size_t strideA = (size_t)RA * K, strideB = (size_t)RB * N;
  const int colsB = max(0, min(2, N - (col0 + ccB)));
  const int rowsA = max(0, min(LA, (M - (row0 + rA) + RA - 1) / RA));   // rows inside M
  const uint32_t dstA = static_cast<uint32_t>(__cvta_generic_to_shared(As + rA * SA + kkA));
  const uint32_t dstB = static_cast<uint32_t>(__cvta_generic_to_shared(Bs + rB * SB + ccB));

  auto load_stage = [&](int step) {
    const int slot = step % STAGES;
    const int k0 = step * BK;
    const int nA = max(0, min(2, klen - k0 - kkA));   // doubles left in the row
    const int leftB = klen - k0 - rB;                 // rows left from this thread's first
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int n = l < rowsA ? nA : 0;
      copy_pair<VEC>(dstA + (slot * A_STAGE + l * RA * SA) * 8,
                     n ? srcA + k0 + l * strideA : A, n, A);
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int n = l * RB < leftB ? colsB : 0;
      copy_pair<VEC>(dstB + (slot * B_STAGE + l * RB * SB) * 8,
                     n ? srcB + (size_t)k0 * N + l * strideB : B, n, B);
    }
  };

  double acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int it = 0; it < nk; ++it) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    // the slot of step it-1 is free now: every warp has passed the barrier
    if (it + STAGES - 1 < nk) load_stage(it + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const double* as = As + (it % STAGES) * A_STAGE + (wm0 + g) * SA + t;
    const double* bs = Bs + (it % STAGES) * B_STAGE + t * SB + wn0 + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      double a[MI][2], b[NI];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        a[i][0] = as[(i * 16) * SA + kk];
        a[i][1] = as[(i * 16 + 8) * SA + kk];
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) b[j] = bs[kk * SB + j * 8];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_f64(acc[i][j], a[i], b[j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // epilogue: thread holds (r, c), (r, c+1), (r+8, c), (r+8, c+1) per tile
  double* Cb;
  long long ld;
  if (splits > 1) {   // partial tile of this slice: (splits, batch, M, N)
    Cb = C + ((size_t)sl * (gridDim.z / splits) + bz) * (size_t)M * N;
    ld = N;
    mode = 0;
  } else {
    Cb = C + (size_t)bz * strideC;
    ld = ldc;
  }
  const int cbase = col0 + wn0 + 2 * t;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = row0 + wm0 + i * 16 + g;
    if (mode) {
      // all loads of the 16-row group first, so that they are in flight
      // together, then the subtraction in the accumulators
      double old[2][NI][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int c = cbase + j * 8;
          const double* Crow = Cb + (size_t)(r + 8 * h) * ld;
          old[h][j][0] = old[h][j][1] = 0.0;
          if (r + 8 * h >= M) continue;
          if (vecC && c + 1 < N) {
            const double2 o = *reinterpret_cast<const double2*>(Crow + c);
            old[h][j][0] = o.x;
            old[h][j][1] = o.y;
          } else {
            if (c < N) old[h][j][0] = Crow[c];
            if (c + 1 < N) old[h][j][1] = Crow[c + 1];
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          acc[i][j][2 * h] = old[h][j][0] - acc[i][j][2 * h];
          acc[i][j][2 * h + 1] = old[h][j][1] - acc[i][j][2 * h + 1];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r + 8 * h >= M) continue;
      double* Crow = Cb + (size_t)(r + 8 * h) * ld;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = cbase + j * 8;
        const double v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (vecC && c + 1 < N) {
          *reinterpret_cast<double2*>(Crow + c) = make_double2(v0, v1);
        } else {
          if (c < N) Crow[c] = v0;
          if (c + 1 < N) Crow[c + 1] = v1;
        }
      }
    }
  }
}

// C[b, i, j] = (mode ? C[b, i, j] : 0) -+ sum over slices, in slice order.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const double* __restrict__ part, double* C, int batch, int M, int N,
                     long long ldc, long long strideC, int splits, int mode) {
  const size_t per = (size_t)M * N;
  const size_t total = per * batch;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  double s = part[idx];
  for (int k = 1; k < splits; ++k) s += part[(size_t)k * total + idx];
  const size_t b = idx / per, ij = idx % per;
  double* p = C + b * (size_t)strideC + (ij / N) * (size_t)ldc + ij % N;
  *p = mode ? *p - s : s;
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS, bool VEC>
int launch_gemm(const double* A, const double* B, double* out, int batch, int M, int N,
                int K, long long ldc, long long strideC, int splits, int kchunk, int mode,
                int vecC, cudaStream_t stream) {
  constexpr int SB = BN + 4;
  constexpr int smem = STAGES * (BM * SA + BK * SB) * (int)sizeof(double);
  auto kernel = dgemm_mma_kernel<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, VEC>;
  // the shared-memory limit is kept per device: set on every launch
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batch * splits);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(A, B, out, M, N, K, ldc, strideC,
                                                         splits, kchunk, mode, vecC);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int MIN_BLOCKS, typename... Args>
int launch_gemm_aligned(bool vec, Args... args) {
  return vec ? launch_gemm<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, true>(args...)
             : launch_gemm<BM, BN, WARPS_M, WARPS_N, MIN_BLOCKS, false>(args...);
}

}  // namespace

// A: (batch, M, K), B: (batch, K, N), f64, contiguous.  C: (batch, M, N) f64
// with unit column stride, row stride ldc and batch stride strideC (in
// doubles).  mode 0: C = A @ B; mode 1: C -= A @ B.  tile_rows picks the
// block tile: 32 (32x64) or 128 (128x128).  splits > 1 cuts K into slices
// of kchunk (a multiple of 16, splits * kchunk >= K) whose partial products
// go to `scratch` (splits * batch * M * N doubles) and are added in slice
// order.  Launches on `stream`, allocates nothing, returns the first CUDA
// error.
extern "C" int dword_matmul_launch(const void* A, const void* B, void* C, void* scratch,
                                   int batch, int M, int N, int K, long long ldc,
                                   long long strideC, int tile_rows, int splits, int kchunk,
                                   int mode, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0 || K <= 0) return 0;
  if (splits < 1 || (splits > 1 && (scratch == nullptr || kchunk % BK != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* a = static_cast<const double*>(A);
  const double* b = static_cast<const double*>(B);
  double* c = static_cast<double*>(C);
  double* out = splits > 1 ? static_cast<double*>(scratch) : c;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = K % 2 == 0 && N % 2 == 0 && aligned(a) && aligned(b);
  const int vecC = splits > 1 ? (N % 2 == 0 && aligned(out))
                              : (ldc % 2 == 0 && strideC % 2 == 0 && aligned(c));
  if (splits == 1) kchunk = K;
  int rc;
  if (tile_rows == 32)
    rc = launch_gemm_aligned<32, 64, 1, 4, 4>(vec, a, b, out, batch, M, N, K, ldc, strideC,
                                              splits, kchunk, mode, vecC, st);
  else if (tile_rows == 128)
    rc = launch_gemm_aligned<128, 128, 2, 4, 1>(vec, a, b, out, batch, M, N, K, ldc, strideC,
                                                splits, kchunk, mode, vecC, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0 || splits == 1) return rc;
  const size_t total = (size_t)batch * M * N;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      out, c, batch, M, N, ldc, strideC, splits, mode);
  return static_cast<int>(cudaGetLastError());
}
