// dword_matmul: batched f64 GEMM, C[b] = A[b] @ B[b].
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/dword_matmul.py::dword_matmul,
// the f64-grade GEMM of the f64 downsweep (kernels/assemble.py::_apply_u_matmul)
// and of the orthogonality self-check (utils/checks.py).  The TPU has no f64
// unit and emulates the product with 21 exact bf16 passes (Ozaki slicing);
// Hopper has IEEE f64 FMA units, so this is a plain f64 GEMM with the same
// contract.  One launch covers a whole tree level: blockIdx.z is the merge.
//
// What bounds it on an H100: FP64 operations (2*M*N*K per batch entry; the
// level's Cauchy-block products run at arithmetic intensity far above the
// card's FP64 ridge point).  Design: 64x64 output tiles, 256 threads with a
// 4x4 register block each, 16-deep k-steps staged through shared memory (A
// transposed with one pad column against bank conflicts), DFMA on the CUDA
// cores, ragged edges masked with zeros.  No tensor-core DMMA, no
// multi-stage copy pipeline: those are later work; this kernel's time beside
// its bound is recorded in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);

__global__ void __launch_bounds__(kThreads)
dgemm_batched_kernel(const double* __restrict__ A, const double* __restrict__ B,
                     double* __restrict__ C, int M, int N, int K) {
  __shared__ double As[BK][BM + 1];
  __shared__ double Bs[BK][BN];

  const size_t bz = blockIdx.z;
  A += bz * (size_t)M * K;
  B += bz * (size_t)K * N;
  C += bz * (size_t)M * N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);

  double acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / kThreads; ++l) {
      const int idx = threadIdx.x + kThreads * l;
      const int ar = idx / BK, ac = idx % BK;
      const int gr = row0 + ar, gk = k0 + ac;
      As[ac][ar] = (gr < M && gk < K) ? A[(size_t)gr * K + gk] : 0.0;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / kThreads; ++l) {
      const int idx = threadIdx.x + kThreads * l;
      const int br = idx / BN, bc = idx % BN;
      const int gk = k0 + br, gc = col0 + bc;
      Bs[br][bc] = (gk < K && gc < N) ? B[(size_t)gk * N + gc] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      double a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + (BM / TM) * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + (BM / TM) * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + (BN / TN) * j;
      if (c < N) C[(size_t)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// A: (batch, M, K), B: (batch, K, N), C: (batch, M, N); f64, contiguous, one
// device.  Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int dword_matmul_launch(const void* A, const void* B, void* C,
                                   int batch, int M, int N, int K, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  dgemm_batched_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<const double*>(B),
      static_cast<double*>(C), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
