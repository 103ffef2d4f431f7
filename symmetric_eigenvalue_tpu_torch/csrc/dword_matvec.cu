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
// ~12 FP64 instructions per element of the compensated sum fit under the
// memory stream.  What the stream needs is bytes in flight, and no second
// launch.  Design:
//  - The contraction runs over ROWS, so neighbouring threads read
//    neighbouring columns of one row-major row (any row stride `lda`: a
//    trailing-submatrix view needs no copy).
//  - Each thread owns two columns and reads them as one 16-byte load per
//    row, with eight rows in flight (128 threads: 256 columns, 16 KB in
//    flight per block); the block's slice of v waits in shared memory, so
//    the registers go to A's loads.  A row whose first element is not 16-byte aligned
//    (odd lda, odd column offset) is read as the aligned pairs one column
//    on: a thread's first column comes from its left neighbour by a shuffle,
//    and lane 0 of each warp loads that element alone (the "head").
//  - The grid is column tiles x row chunks, sized to whole waves of the
//    blocks the SMs hold at once (one wave at 4096 columns, several at
//    16384, so no wave runs a few blocks alone); the plan is `_plan` in
//    kernels/dword_matvec.py.  Each chunk writes its partial sums as (hi,
//    lo) pairs; the last block to arrive at a column tile (a per-tile
//    counter, __threadfence + atomicAdd) adds the partials in chunk order
//    (six chunks' loads in flight at a time) and writes y, then sets the
//    counter back to zero for the next call.  One launch, and the same
//    result from run to run.
//
// Every rounding is written out (__dmul_rn, __dadd_rn, __fma_rn): the compiler
// must not contract or reassociate a compensated sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2 * kThreads;   // columns per tile, two per thread
constexpr int kRows = 8;              // rows in flight per thread
constexpr int kBatch = 6;             // chunk partials in flight per thread

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

// The 16-byte load of one row for the thread whose columns are c, c + 1:
// the pair at c (aligned row) or at c + 1 (row start 8 bytes past a 16-byte
// boundary), or one element at the ragged right edge.  `head` is element c
// of an unaligned row, loaded by lane 0 alone.
struct RowLoad {
  double x, y, head;
};

__device__ __forceinline__ RowLoad load_row(const double* __restrict__ row, int c,
                                            int cols, int lane) {
  const int odd = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 3) & 1);
  const int j = c + odd;
  RowLoad r{0.0, 0.0, 0.0};
  if (j + 1 < cols) {
    const double2 p = __ldg(reinterpret_cast<const double2*>(row + j));
    r.x = p.x;
    r.y = p.y;
  } else if (j < cols) {
    r.x = __ldg(row + j);
  }
  if (odd && lane == 0 && c < cols) r.head = __ldg(row + c);
  return r;
}

// Columns c, c + 1 of a loaded row.  Every lane of the warp calls it (the
// shuffle); `odd` is the same for the whole warp (one row).
__device__ __forceinline__ void row_columns(const RowLoad& r, bool odd, int lane,
                                            double& a0, double& a1) {
  const double left = __shfl_up_sync(0xffffffffu, r.y, 1);
  if (odd) {
    a0 = lane == 0 ? r.head : left;
    a1 = r.x;
  } else {
    a0 = r.x;
    a1 = r.y;
  }
}

__global__ void __launch_bounds__(kThreads)
vecmat_kernel(const double* __restrict__ v, const double* __restrict__ A,
              double* __restrict__ y, double* __restrict__ ws,
              unsigned int* __restrict__ counters, int rows, int cols,
              long long lda, int rows_per_chunk) {
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const int lane = threadIdx.x & 31;
  const int c = tile * kCols + 2 * threadIdx.x;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);

  // the chunk's slice of v, read from shared memory when its row is added
  // (only A's loads are held in registers while in flight)
  extern __shared__ double sv[];
  for (int i = threadIdx.x; i < r1 - r0; i += kThreads) sv[i] = v[r0 + i];
  __syncthreads();

  // two chains per column (even and odd rows of a group)
  double s0a = 0.0, c0a = 0.0, s1a = 0.0, c1a = 0.0;
  double s0b = 0.0, c0b = 0.0, s1b = 0.0, c1b = 0.0;
  int r = r0;
  for (; r + kRows <= r1; r += kRows) {
    RowLoad ld[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      ld[q] = load_row(A + (size_t)(r + q) * lda, c, cols, lane);
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const bool odd = ((reinterpret_cast<uintptr_t>(A + (size_t)(r + q) * lda) >> 3) & 1) != 0;
      double a0, a1;
      row_columns(ld[q], odd, lane, a0, a1);
      const double vr = sv[r - r0 + q];
      if (q & 1) {
        fma_acc(s0b, c0b, vr, a0);
        fma_acc(s1b, c1b, vr, a1);
      } else {
        fma_acc(s0a, c0a, vr, a0);
        fma_acc(s1a, c1a, vr, a1);
      }
    }
  }
  for (; r < r1; ++r) {
    const double* row = A + (size_t)r * lda;
    const RowLoad ld = load_row(row, c, cols, lane);
    const bool odd = ((reinterpret_cast<uintptr_t>(row) >> 3) & 1) != 0;
    double a0, a1;
    row_columns(ld, odd, lane, a0, a1);
    const double vr = sv[r - r0];
    fma_acc(s0a, c0a, vr, a0);
    fma_acc(s1a, c1a, vr, a1);
  }
  two_sum_acc(s0a, c0a, s0b);
  c0a = __dadd_rn(c0a, c0b);
  two_sum_acc(s1a, c1a, s1b);
  c1a = __dadd_rn(c1a, c1b);

  if (chunks == 1) {
    if (c < cols) y[c] = __dadd_rn(s0a, c0a);
    if (c + 1 < cols) y[c + 1] = __dadd_rn(s1a, c1a);
    return;
  }
  double* part = ws + (size_t)chunk * 2 * cols;
  if (c < cols) {
    part[c] = s0a;
    part[cols + c] = c0a;
  }
  if (c + 1 < cols) {
    part[c + 1] = s1a;
    part[cols + c + 1] = c1a;
  }

  // the last block of this column tile adds the chunks' partials in order
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + tile, 1u) == static_cast<unsigned int>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // chunk order, kBatch chunks' partials loaded at a time (the adds of the
  // zeros past the last chunk change nothing)
  const bool ok0 = c < cols, ok1 = c + 1 < cols;
  double s0 = 0.0, e0 = 0.0, s1 = 0.0, e1 = 0.0;
  for (int k0 = 0; k0 < chunks; k0 += kBatch) {
    double h0[kBatch], l0[kBatch], h1[kBatch], l1[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const bool in = k0 + q < chunks;
      const double* pk = ws + (size_t)(k0 + q) * 2 * cols;
      h0[q] = in && ok0 ? __ldcg(pk + c) : 0.0;
      l0[q] = in && ok0 ? __ldcg(pk + cols + c) : 0.0;
      h1[q] = in && ok1 ? __ldcg(pk + c + 1) : 0.0;
      l1[q] = in && ok1 ? __ldcg(pk + cols + c + 1) : 0.0;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      two_sum_acc(s0, e0, h0[q]);
      e0 = __dadd_rn(e0, l0[q]);
      two_sum_acc(s1, e1, h1[q]);
      e1 = __dadd_rn(e1, l1[q]);
    }
  }
  if (ok0) y[c] = __dadd_rn(s0, e0);
  if (ok1) y[c + 1] = __dadd_rn(s1, e1);
  if (threadIdx.x == 0) counters[tile] = 0u;
}

}  // namespace

// Blocks of the kernel one SM holds at once with `rows_per_chunk` rows of v
// in shared memory (for the launch plan), or -1 on error.
extern "C" int dword_vecmat_blocks_per_sm(int rows_per_chunk) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, vecmat_kernel, kThreads, sizeof(double) * (size_t)rows_per_chunk)
      != cudaSuccess) {
    return -1;
  }
  return n;
}

// v: (rows,) f64 contiguous; A: (rows, cols) f64 with unit column stride, row
// stride `lda` elements and 8-byte alignment; y: (cols,) f64.  chunks =
// ceil(rows / rows_per_chunk) row chunks, rows_per_chunk <= 6144 (its slice
// of v in shared memory); when chunks > 1, ws holds (chunks, 2, cols) f64
// of scratch and counters ceil(cols / 256) zeroed unsigned ints, which the
// launch leaves zeroed.  One device.  Launches one kernel on `stream`,
// allocates nothing, returns cudaGetLastError().
extern "C" int dword_vecmat_launch(const void* v, const void* A, void* y,
                                   void* ws, void* counters, int rows,
                                   int cols, long long lda,
                                   int rows_per_chunk, void* stream) {
  if (rows <= 0 || cols <= 0 || rows_per_chunk <= 0) return 0;
  if (rows_per_chunk > 6144) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const int col_tiles = (cols + kCols - 1) / kCols;
  const size_t shmem = sizeof(double) * (size_t)rows_per_chunk;
  vecmat_kernel<<<dim3(col_tiles, chunks), kThreads, shmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(v), static_cast<const double*>(A),
      static_cast<double*>(y), static_cast<double*>(ws),
      static_cast<unsigned int*>(counters), rows, cols, lda, rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}
