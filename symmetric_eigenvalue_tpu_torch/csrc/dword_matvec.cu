// dword_vecmat: f64-grade vector-matrix product, y[j] = sum_i v[i] * A[i, j].
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/dword_matvec.py::dword_vecmat
// (kernel body `_kernel`), the per-column Householder matvec of the dense
// front end (kernels/tridiagonalize.py::_tridiagonalize_block).  The TPU has
// no f64 unit: its kernel streams A as an (hi, lo) f32 pair, splits both
// operands by mantissa masking so that every partial product is exact, and
// folds them through three compensation channels.  Hopper has IEEE f64 and an
// exact FMA, so the contract (A read once, the sum good to about one rounding
// of sum_i |v_i||A_ij| whatever the length) is kept with an error-free product
// (p = v*a rounded, e = fma(v, a, -p) exact) and a TwoSum accumulation.
//
// What bounds it on an H100: bytes.  A is rows x cols doubles read once
// (2.1 GB at 16384 x 16384) against 2 useful FP64 operations per element; the
// ~12 FP64 instructions per element of the compensated sum still fit under
// the memory stream.  Design: the contraction runs over ROWS, so consecutive
// threads read consecutive columns of one row-major row (coalesced, any row
// stride `lda`, so a trailing-submatrix view needs no copy).  A block owns 128
// columns and one chunk of rows; the grid is split over row chunks as well as
// column tiles so that every SM has several blocks in flight even at 4096
// columns.  The chunk's slice of v is staged through shared memory 128 rows
// at a time.  Each thread keeps four independent (sum, compensation) pairs,
// so four loads are in flight per thread.  (128 columns with 128-row tiles
// was the fastest of the block shapes tried on the card; PERF.md has the
// times.)  Row-chunk partials go to a workspace as (hi, lo) pairs and a
// second tiny kernel adds them in chunk order: no atomics, so the result is
// the same from run to run.
//
// Every rounding is written out (__dmul_rn, __dadd_rn, __fma_rn): the compiler
// must not contract or reassociate a compensated sum.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;     // columns per block, one per thread
constexpr int kRowTile = 128;  // rows of v staged in shared memory at a time

__device__ __forceinline__ void two_sum_acc(double& s, double& c, double x) {
  const double t = __dadd_rn(s, x);
  const double bp = __dsub_rn(t, s);
  const double err = __dadd_rn(__dsub_rn(s, __dsub_rn(t, bp)), __dsub_rn(x, bp));
  s = t;
  c = __dadd_rn(c, err);
}

// s + c += v * a, the product's rounding error included.
__device__ __forceinline__ void fma_acc(double& s, double& c, double v, double a) {
  const double p = __dmul_rn(v, a);
  const double e = __fma_rn(v, a, -p);
  two_sum_acc(s, c, p);
  c = __dadd_rn(c, e);
}

__global__ void __launch_bounds__(kCols)
vecmat_partial_kernel(const double* __restrict__ v, const double* __restrict__ A,
                      double* __restrict__ ws, int rows, int cols, long long lda,
                      int rows_per_chunk) {
  __shared__ double sv[kRowTile];

  const int col = blockIdx.x * kCols + threadIdx.x;
  const bool live = col < cols;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const double* Ac = A + (live ? col : 0);

  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  double c0 = 0.0, c1 = 0.0, c2 = 0.0, c3 = 0.0;
  for (int t0 = r0; t0 < r1; t0 += kRowTile) {
    const int len = min(kRowTile, r1 - t0);
    __syncthreads();
    for (int q = threadIdx.x; q < len; q += kCols) sv[q] = v[t0 + q];
    __syncthreads();
    if (!live) continue;
    const double* At = Ac + (size_t)t0 * lda;
    int i = 0;
    for (; i + 4 <= len; i += 4) {
      const double a0 = At[(size_t)(i + 0) * lda];
      const double a1 = At[(size_t)(i + 1) * lda];
      const double a2 = At[(size_t)(i + 2) * lda];
      const double a3 = At[(size_t)(i + 3) * lda];
      fma_acc(s0, c0, sv[i + 0], a0);
      fma_acc(s1, c1, sv[i + 1], a1);
      fma_acc(s2, c2, sv[i + 2], a2);
      fma_acc(s3, c3, sv[i + 3], a3);
    }
    for (; i < len; ++i) fma_acc(s0, c0, sv[i], At[(size_t)i * lda]);
  }
  if (!live) return;
  two_sum_acc(s0, c0, s1);
  two_sum_acc(s0, c0, s2);
  two_sum_acc(s0, c0, s3);
  c0 = __dadd_rn(__dadd_rn(c0, c1), __dadd_rn(c2, c3));
  const size_t base = (size_t)blockIdx.y * 2 * cols;
  ws[base + col] = s0;
  ws[base + cols + col] = c0;
}

__global__ void __launch_bounds__(kCols)
vecmat_finish_kernel(const double* __restrict__ ws, double* __restrict__ y,
                     int cols, int chunks) {
  const int col = blockIdx.x * kCols + threadIdx.x;
  if (col >= cols) return;
  double s = 0.0, c = 0.0;
  for (int k = 0; k < chunks; ++k) {   // fixed order: deterministic
    const size_t base = (size_t)k * 2 * cols;
    two_sum_acc(s, c, ws[base + col]);
    c = __dadd_rn(c, ws[base + cols + col]);
  }
  y[col] = __dadd_rn(s, c);
}

}  // namespace

// v: (rows,) f64 contiguous; A: (rows, cols) f64 with unit column stride and
// row stride `lda` elements; y: (cols,) f64; ws: (chunks, 2, cols) f64 scratch
// with chunks = ceil(rows / rows_per_chunk).  One device.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int dword_vecmat_launch(const void* v, const void* A, void* y,
                                   void* ws, int rows, int cols, long long lda,
                                   int rows_per_chunk, void* stream) {
  if (rows <= 0 || cols <= 0 || rows_per_chunk <= 0) return 0;
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const int col_tiles = (cols + kCols - 1) / kCols;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vecmat_partial_kernel<<<dim3(col_tiles, chunks), kCols, 0, st>>>(
      static_cast<const double*>(v), static_cast<const double*>(A),
      static_cast<double*>(ws), rows, cols, lda, rows_per_chunk);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  vecmat_finish_kernel<<<col_tiles, kCols, 0, st>>>(
      static_cast<const double*>(ws), static_cast<double*>(y), cols, chunks);
  return static_cast<int>(cudaGetLastError());
}
