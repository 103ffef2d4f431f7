// q2_apply: the two-stage backtransform's waves, X <- Q2 X in place.
//
// Replaces the wave loop of the JAX package's
// symmetric_eigenvalue_tpu/kernels/band_reduce.py::apply_q2_wave_blocked
// (:509; its lax.fori_loop at :606, the wave body at :551-604), which holds
// no pallas_call.  JAX compiles the loop into one program; the port drove
// it from Python a wave at a time (a numpy plan, two index copies, Z and Y
// by scatter, a Gram, a batched triangular solve, a gather of X's rows into
// a copy, three dword_matmul launches and a scatter back: 3,070 waves at
// n = 16384, u = 16).  Here every block's T comes from one q2_blocks_t
// launch a chunk of waves before the chunk's first wave
// (csrc/householder_panel.cu) and each wave is one launch of this kernel
// that reads X's rows where they lie and writes them back in place.
//
// The blocks.  g = b consecutive sweeps' hop-k reflectors form the block
// B(J, k) = I - Y T Y^T over the h = 2b - 1 window rows base .. base + h - 1,
// base = J g + k b + 1: Y's column i is v_i = Vw[min(J g + i, n - 2), k, :]
// at window rows i .. i + b - 1 (the zero row n - 2 stands for sweeps past
// the last).  q2_blocks_t writes block (J, k)'s T and its Y^T, Y^T(i, r) =
// v_i[r - i] and zero outside the band, each zero-padded to rows of 16 and
// stored in the A fragment's 16 x 4 tiles (`tiled`), wave w's blocks at
// consecutive slots of the chunk's two stores.  Wave w applies the blocks
// s = s_lo .. s_lo + count - 1, J = nJ - 1 - s, k = w - 2 s (the closed form
// of kernels/band_reduce.py::q2_wave_range: the JAX wave body's valid mask
// with the blocks whose first reflector lies past the matrix left out),
// s_lo, count and the first slot passed by the launch.  A wave's blocks sit
// 3b rows apart, so their windows are disjoint and the in-place writes of
// one launch never meet; each wave is a launch, so it sees the one before
// it whole.
//
// A block of threads takes one (block, tile of CT columns): it copies the
// tile's h rows into shared memory (cp.async; rows past n, the JAX
// package's zero padding, and rows past h are zero-filled and never
// written back: Y is zero there), then
//   W1 = Y^T G  (g x CT; Y^T's row i has its b nonzeros at columns i ..
//                i + b - 1, so a 16-row tile contracts over b + 15 rows),
//   W2 = T W1   (T upper triangular: row tile i0 contracts over i0 .. g-1),
//   G  = G - Y W2, written straight from the accumulators to X
// on the FP64 tensor cores (mma.sync.m16n8k4.f64, as csrc/dword_matmul.cu),
// with f64 accumulators.  Y^T and T are read from their stores through the
// read-only cache (the tiles of one block run side by side, so they are
// read from L2, not HBM): in the stores' 16 x 4 tiles a warp's fragment is
// two 256-byte runs, with no masks, where reading v_i from the log itself
// took 16 cache lines and ~1.5 sectors for each one used (the A operands'
// L2 traffic bounds the kernel at band 128: PERF.md).  W1 and W2 live in
// shared memory beside the tile.  W2 overwrites W1 by rounds of row tiles: round q reads rows of
// W1 at or past its own first row, which no earlier round wrote.  A warp
// owns 8 NI columns and every RG-th row tile (RG = 8 / CG warps down a
// column group).
//
// What bounds it on an H100: X's bytes at b = 16 (31 rows read and written
// a block, 4.27 TB at n = 16384), at b = 128 X's bytes and the FP64
// operations about equally (552 GB, 1.1e13 operations of the banded and
// triangular forms; PERF.md).  Sums run in a fixed order: two runs give the
// same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[2], double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

struct Q2 {
  double* X;          // (n, C), unit column stride, row stride ldx
  long long ldx;
  const double* Ys;   // every block's Y^T, (w_rows, y_stride) in 16 x 4 tiles
  const double* Ts;   // every block's T, (w_rows, w_rows) in 16 x 4 tiles
  int n, C, b, nJ;
  int w, slo, slot0;  // the wave, its first block, that block's slot
  int vec;            // X and ldx 16-byte aligned: 16-byte copies
};

// Shared-memory geometry of a tile: rows of the G tile (h + 3: the
// contraction of W1 runs in steps of 4 rows past h, zero there) and of W
// (g rounded up to 16), a row padded by 4 doubles against bank conflicts.
__host__ __device__ __forceinline__ int g_rows(int b) { return ((2 * b - 1 + 3) + 1) & ~1; }
__host__ __device__ __forceinline__ int w_rows(int b) { return (b + 15) & ~15; }
__host__ __device__ __forceinline__ long long tile_bytes(int b, int ct) {
  return 8LL * (g_rows(b) + w_rows(b)) * (ct + 4);
}
// The columns of a block's Y^T in the Y store (csrc/householder_panel.cu,
// q2_blocks_t): past the h + 3 window rows W1's contraction reads and the h
// rounded up to 16 of the update's row tiles, a multiple of 4.
__host__ __device__ __forceinline__ int y_stride(int b) {
  const int h = 2 * b - 1;
  return max((h + 3 + 3) & ~3, (h + 15) & ~15);
}
// Entry (i, c) of a block's matrix of `cols` columns in the stores' layout:
// 16 x 4 tiles (the A fragment's rows and one k-step), tile (i / 16, c / 4)
// at ((i / 16) (cols / 4) + c / 4) 64, row-major inside.  A warp's fragment
// (two 8-row halves of a tile) is two 256-byte runs.
__host__ __device__ __forceinline__ size_t tiled(int i, int c, int cols) {
  return ((size_t)(i >> 4) * (cols >> 2) + (c >> 2)) * 64 + (i & 15) * 4 + (c & 3);
}

template <int NI, int CG>
__device__ void apply_block(const Q2& a, int J, int k, size_t blk, int tile, double* Gs,
                            double* Ws) {
  constexpr int CT = 8 * NI * CG;
  constexpr int SC = CT + 4;
  constexpr int RG = kWarps / CG;
  const int b = a.b, g = b, h = 2 * b - 1, n = a.n;
  const int HS = g_rows(b), GP = w_rows(b);
  const int base = J * g + k * b + 1;
  const int c0 = tile * CT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wc = (warp % CG) * 8 * NI, rg = warp / CG;
  const double* T = a.Ts + blk * GP * GP;    // zero past g
  const int ys = y_stride(b);
  const double* Yb = a.Ys + blk * GP * ys;   // Y^T(i, r) = v_i[r - i], zero elsewhere
  const int rows = min(h, n - base);       // window rows inside the matrix
  const int cols = min(CT, a.C - c0);

  // the tile: HS rows x CT columns, zero past `rows` and `cols`
  for (int p = tid; p < HS * (CT / 2); p += kThreads) {
    const int r = p / (CT / 2), c = 2 * (p % (CT / 2));
    const int nv = r < rows ? max(0, min(2, cols - c)) : 0;
    const double* src = nv ? a.X + (size_t)(base + r) * a.ldx + c0 + c : a.X;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(Gs + r * SC + c));
    if (a.vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                   "r"(8 * nv));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                   "r"(nv > 0 ? 8 : 0));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst + 8),
                   "l"(nv > 1 ? src + 1 : a.X), "r"(nv > 1 ? 8 : 0));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // W1 = Y^T G: row tile i0 contracts over window rows i0 .. i0 + b + 14
  for (int i0 = rg * 16; i0 < GP; i0 += RG * 16) {
    double acc[NI][4] = {};
    const double* ya = Yb + tiled(i0 + gq, 0, ys) + t;
    const int rhi = min(h, i0 + 15 + b);
#pragma unroll 4
    for (int r0 = i0; r0 < rhi; r0 += 4) {
      const double af[2] = {__ldg(ya + 16 * r0), __ldg(ya + 16 * r0 + 32)};
      const double* gs = Gs + (r0 + t) * SC + wc + gq;
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_f64(acc[j], af, gs[8 * j]);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      double* ws = Ws + (i0 + gq) * SC + wc + 8 * j + 2 * t;
      ws[0] = acc[j][0];
      ws[1] = acc[j][1];
      ws[8 * SC] = acc[j][2];
      ws[8 * SC + 1] = acc[j][3];
    }
  }
  __syncthreads();

  // W2 = T W1, in rounds of RG row tiles (round q reads W1's rows from
  // q RG 16 on; earlier rounds wrote only rows above)
  for (int q0 = 0; q0 < GP; q0 += RG * 16) {
    const int i0 = q0 + rg * 16;
    double acc[NI][4] = {};
    if (i0 < GP) {
      const double* ta = T + tiled(i0 + gq, 0, GP) + t;
#pragma unroll 4
      for (int j0 = i0; j0 < g; j0 += 4) {
        const double af[2] = {__ldg(ta + 16 * j0), __ldg(ta + 16 * j0 + 32)};
        const double* ws = Ws + (j0 + t) * SC + wc + gq;
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_f64(acc[j], af, ws[8 * j]);
      }
    }
    __syncthreads();
    if (i0 < GP) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        double* ws = Ws + (i0 + gq) * SC + wc + 8 * j + 2 * t;
        ws[0] = acc[j][0];
        ws[1] = acc[j][1];
        ws[8 * SC] = acc[j][2];
        ws[8 * SC + 1] = acc[j][3];
      }
    }
    __syncthreads();
  }

  // G - Y W2: row tile r0 contracts over the reflectors i with
  // r0 - b + 1 <= i <= r0 + 15; written to X from the accumulators
  const int HP = (h + 15) & ~15;
  for (int r0 = rg * 16; r0 < HP; r0 += RG * 16) {
    double acc[NI][4] = {};
    const int ra = r0 + gq, rb = ra + 8;
    const int ilo = max(0, r0 - b + 1) & ~3, ihi = min(g, r0 + 16);
#pragma unroll 4
    for (int i0 = ilo; i0 < ihi; i0 += 4) {
      const int i = i0 + t;
      const double af[2] = {__ldg(Yb + tiled(i, ra, ys)), __ldg(Yb + tiled(i, rb, ys))};
      const double* ws = Ws + i * SC + wc + gq;
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_f64(acc[j], af, ws[8 * j]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = hh ? rb : ra;
      if (r >= rows) continue;
      double* xr = a.X + (size_t)(base + r) * a.ldx + c0;
      const double* gr = Gs + r * SC;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = wc + 8 * j + 2 * t;
        const double x0 = __dsub_rn(gr[c], acc[j][2 * hh]);
        const double x1 = __dsub_rn(gr[c + 1], acc[j][2 * hh + 1]);
        if (a.vec && c + 1 < cols) {
          *reinterpret_cast<double2*>(xr + c) = make_double2(x0, x1);
        } else {
          if (c < cols) xr[c] = x0;
          if (c + 1 < cols) xr[c + 1] = x1;
        }
      }
    }
  }
}

// One wave: blockIdx.x the column tile, blockIdx.y the block (s = s_lo +
// blockIdx.y, at slot slot0 + blockIdx.y).
template <int NI, int CG>
__global__ void __launch_bounds__(kThreads, 2) q2_apply_kernel(const Q2 a) {
  extern __shared__ __align__(16) double smem[];
  constexpr int SC = 8 * NI * CG + 4;
  double* Gs = smem;
  double* Ws = smem + (size_t)g_rows(a.b) * SC;
  const int s = a.slo + static_cast<int>(blockIdx.y);
  apply_block<NI, CG>(a, a.nJ - 1 - s, a.w - 2 * s, (size_t)a.slot0 + blockIdx.y, blockIdx.x,
                      Gs, Ws);
}

using Kernel = void (*)(const Q2);

// The tile shapes: columns CT = 8 NI CG a block of threads.
Kernel kernel_for(int ct) {
  switch (ct) {
    case 256: return q2_apply_kernel<4, 8>;
    case 64: return q2_apply_kernel<4, 2>;
    case 32: return q2_apply_kernel<4, 1>;
    case 16: return q2_apply_kernel<2, 1>;
    case 8: return q2_apply_kernel<1, 1>;
    default: return nullptr;
  }
}

}  // namespace

// (blocks of threads one SM holds at band b and tile width ct, the SM
// count, the shared bytes a block may opt into) of the current device, into
// out[0..2].  Opts the kernel into all the shared memory a block may have
// first.
extern "C" int q2_apply_occupancy(int b, int ct, void* out) {
  const Kernel fn = kernel_for(ct);
  if (fn == nullptr || b < 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, optin = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const long long smem = tile_bytes(b, ct);
  if (err == cudaSuccess) {
    // what a block may opt into, whatever b: the attribute is the kernel's,
    // shared by every band
    err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  }
  if (err == cudaSuccess && smem <= optin) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)fn, kThreads,
                                                        static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = blocks;
  o[1] = sms;
  o[2] = optin;
  return 0;
}

// X: (n, C) f64, unit column stride, row stride ldx, updated in place.
// Ys, Ts: the stores of q2_blocks_t's chunk holding wave w.  Wave w's live
// blocks are s = slo .. slo + count - 1 at slots slot0 .. slot0 + count - 1
// (worked out by the caller in the closed form).  ct: the tile width (256,
// 64, 32, 16 or 8; shared memory opted in by q2_apply_occupancy).  One
// kernel on `stream`, a grid of column tiles x count.
extern "C" int q2_apply_launch(void* X, long long ldx, const void* Ys, const void* Ts, int n,
                               int C, int b, int w, int slo, int count, int slot0, int ct,
                               void* stream) {
  const Kernel fn = kernel_for(ct);
  const int nJ = n >= 3 && b >= 2 ? (n - 3) / b + 1 : 0;   // = Kmax at g = b
  if (fn == nullptr || n < 3 || b < 2 || C < 1 || ldx < C || count < 1 || count > 65535
      || slo < 0 || slo + count > nJ || slot0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (C + ct - 1) / ct;
  const int vec = (reinterpret_cast<uintptr_t>(X) % 16 == 0 && ldx % 2 == 0) ? 1 : 0;
  const Q2 a{static_cast<double*>(X), ldx, static_cast<const double*>(Ys),
             static_cast<const double*>(Ts), n, C, b, nJ, w, slo, slot0, vec};
  fn<<<dim3(tiles, count), kThreads, static_cast<size_t>(tile_bytes(b, ct)),
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
