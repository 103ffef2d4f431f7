// cauchy_matmul / cauchy_materialize: the mixed-precision downsweep's Cauchy
// products, with U generated on the fly and never stored.
//
// Replaces symmetric_eigenvalue_tpu/kernels/pallas/cauchy_matmul.py::cauchy_matmul
// (_kernel, every non-root level of the f32 downsweep, called from
// kernels/assemble.py::_apply_u_matmul) and ::cauchy_materialize (_mat_kernel,
// the root U of the same sweep, called from kernels/assemble.py::assemble_u).
//
//   M[b, j, i] = f32( (zhat_bj / ((p_bj - sv_bi) - tau_bi)) * ninv_bi )
//   cauchy_matmul:      Y[b] = M[b][:, :K_b] @ X[b][:K_b, :]      (f32 out)
//   cauchy_materialize: U[b, j, c] = M-entry for column slot s_c < K_b,
//                       else [j == s_c] (the deflated column e_slot, exact)
//
// The TPU kernels carry the f64 pole differences as f32 pairs; Hopper has
// IEEE f64, so every entry is computed in f64 and rounded to f32 once.
//
// cauchy_matmul.  What bounds it on an H100: operations.  2*K_b*m*C per merge
// is a GEMM far above the ridge point, and a product on the CUDA cores
// cannot pass their 67 TFLOP/s; the tensor cores take f32 operands only as
// TF32 (10 mantissa bits).  So the product is the three-pass split that the
// TPU kernel's default tier (bf16_3x) makes with bf16 words, here with TF32
// words: each f32 operand x is cut into hi = tf32(x) and lo = tf32(x - hi),
// and lo*hi + hi*lo + hi*hi accumulate in f32 on the tensor cores (about 21
// of 24 mantissa bits; never a single TF32 pass).  The bound is then 3 passes
// of 2*K*m*C at the TF32 tensor rate, beside one f64 reciprocal per M entry
// and column tile on the FP64 pipe.
//
// Design.  One block per (merge, row tile, 128-column tile), warps in two
// roles that meet at one __syncthreads() per 32-slot step:
//   * producer warps generate the NEXT step's M tile in f64, round it to
//     f32, split it and write the hi words and the lo words into two
//     double-buffered tiles, and keep the X tiles of the next steps in
//     flight with cp.async (16 bytes a thread, 4 where a row is not 16-byte
//     aligned) through a ring in dynamic shared memory.  A thread loads the
//     poles of eight entries before it stores the first, so that their long
//     dependent chains interleave; the quotient is a reciprocal
//     approximation with one Newton step (relative error 2^-46 before the
//     rounding to f32), a third of the IEEE division's FP64 instructions;
//     a thread that got an entry that is not finite (a zero, subnormal or
//     infinite denominator) makes its entries of the step again by the
//     division itself;
//   * two consumer warpgroups multiply the CURRENT step's tiles with
//     wgmma.mma_async (m64nNk8, TF32), as Y^T = X^T M^T: the warpgroup
//     instruction takes TF32 operands from shared memory only K-major
//     (contraction index adjacent), which X (slot-major) is not, but its A
//     operand may come from registers.  So A is the X^T fragment, 64 output
//     columns a warpgroup, read from the ring as it lies in memory (rows
//     padded to 136 floats: conflict-free) and split into hi and lo in
//     registers; B is the generated tile, M[j][i] with the slots adjacent,
//     K-major as the producers write it (rows of 128 bytes in the 128-byte
//     swizzle).  The sums stay in registers (N/2 a thread).
//   So the FP64 pipe (generation), the copy engine (X) and the tensor pipe
//   (products) work at the same time, on different warps.
//   The tensor cores cut each sum off toward zero, an error that grows with
//   the number of sums in a row (6.5e-5 of |M|@|X| after 8192 slots, where
//   an f32 sum has 3e-6).  So in the 128-row shape the register sums are
//   added every two steps, rounded to nearest on the CUDA cores, into
//   running sums in shared memory, and start again from zero.
//   Two shapes, chosen by the launcher from m: 128 rows with 4 producer
//   warps (one block per SM), and 64 rows with 2 producer warps (two blocks
//   per SM, no running sums: at most two steps) for merges of at most 64
//   rows, where a 128-row tile would be half padding.
//   The contraction runs only up to the merge's own K_b, read on the device
//   (the deflation skip: no host sync; tiles past K_b are neither generated
//   nor multiplied).  Slots >= K_b inside the last tile are written as exact
//   zeros and their X rows are zero-filled (never 0 * ncolinv, which could
//   be 0 * inf), so the result equals the product over all m slots wherever
//   that product is finite.  Its times beside its bounds are in PERF.md.
// cauchy_materialize: bound by the 4*m*C bytes it writes; one thread per
// output entry, consecutive threads on consecutive columns (coalesced
// stores); the IEEE division, bit-identical to the plain version's entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 32;            // contraction slots per step: 128 bytes of TF32
constexpr int TC = 128;           // output columns per block
constexpr int SX_ROW = TC + 8;    // padded row of the X tile, in floats
constexpr int kConsumers = 256;   // two warpgroups, 64 output columns each
constexpr int kXWords = TI * SX_ROW;   // floats per X stage

__device__ __forceinline__ float cauchy_entry(double p, double sv, double tau,
                                              double z, double ninv) {
  const double den = __dsub_rn(__dsub_rn(p, sv), tau);
  return __double2float_rn(__dmul_rn(__ddiv_rn(z, den), ninv));
}

// The same entry for the product, without the division: a reciprocal
// approximation (relative error 2^-23) and one Newton step, within 2^-46 of
// the quotient before the one rounding to f32.  No branch, so that a
// thread's entries interleave.  The approximation flushes subnormals, and the
// Newton step makes NaN of a zero, subnormal or infinite denominator, where
// the division gives inf, a finite value or zero: the caller makes an entry
// that is not finite again with cauchy_entry.
__device__ __forceinline__ float cauchy_entry_fast(double p, double sv, double tau,
                                                   double z, double ninv) {
  const double den = __dsub_rn(__dsub_rn(p, sv), tau);
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(r) : "d"(den));
  r = fma(r, fma(-den, r, 1.0), r);
  return __double2float_rn(__dmul_rn(__dmul_rn(z, r), ninv));
}

// the f32 value x rounded to TF32 (10 mantissa bits; to nearest, ties away
// from zero): half a TF32 ulp added to the magnitude, the low 13 bits cut.
// What cvt.rna.tf32.f32 gives for every finite x, in two instructions (the
// compiler's own expansion guards inf and NaN with three more; here inf
// stays inf and NaN stays NaN or becomes inf).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi, lo TF32 words (lo exact up to its own rounding)
__device__ __forceinline__ uint2 tf32_split(float x) {
  const uint32_t hi = to_tf32(x);
  return make_uint2(hi, to_tf32(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem, bool vec,
                                             int valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(4 * valid));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4 * e),
                   "l"(e < valid ? gmem + e : gmem), "r"(e < valid ? 4 : 0));
  }
}

// byte offset of M[r][i] in a tile of 128-byte rows in the 128-byte swizzle:
// the 16-byte chunk i/4 of row r lies in chunk (i/4) ^ (r % 8)
__device__ __forceinline__ int swizzled(int r, int i) {
  return r * 128 + ((((i >> 2) ^ (r & 7)) << 4) | ((i & 3) << 2));
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x N, f32) += a (64 x 8 TF32, registers) b (8 x N TF32, shared), N =
// 128 or 64.  Lane 4 g + t of warp w holds a[q] = A[16 w + g + 8 (q & 1)][t +
// 4 (q >> 1)] and d[4 nb + 2 h + e] = D[16 w + g + 8 h][8 nb + 2 t + e].
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int TJ, int PW, int NX, int FLUSH>
struct Shape {
  static constexpr int kProducers = PW * 32;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kMTile = TJ * TI * 4;   // bytes of one hi or lo tile
  // 1024 to align the tiles, two buffers of (hi, lo), the X ring, poles and
  // zhat, the running sums
  static constexpr int kSmem = 1024 + 4 * kMTile + NX * kXWords * 4 + 2 * TJ * 8 +
                               (FLUSH > 0 ? TJ * TC * 4 : 0);
};

// TJ rows of M per block (the N of the wgmma), PW producer warps, NX stages
// of X in flight, running sums every FLUSH steps (0: never), GB entries a
// producer thread has in flight.
template <int TJ, int PW, int NX, int FLUSH, int MIN_BLOCKS, int GB>
__global__ void __launch_bounds__(kConsumers + PW * 32, MIN_BLOCKS)
cauchy_matmul_kernel(const double* __restrict__ poles, const double* __restrict__ shift,
                     const double* __restrict__ tau, const double* __restrict__ zhat,
                     const double* __restrict__ ninv, const float* __restrict__ X,
                     const int64_t* __restrict__ Kact, float* __restrict__ Y,
                     int m, int C, int vec) {
  using S = Shape<TJ, PW, NX, FLUSH>;
  constexpr int NACC = TJ / 2;   // sums a consumer thread holds
  static_assert((TI * TC / 4) % S::kProducers == 0, "X chunks per producer thread");
  static_assert(TJ % (PW * GB) == 0 && GB % (8 / PW) == 0, "M rows per producer batch");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: the tiles start on one
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* Mt = base;   // [2 buffers][hi, lo][TJ rows][128 bytes]
  float* Xs = reinterpret_cast<float*>(base + 4 * S::kMTile);   // [NX][TI][SX_ROW]
  double* Ps = reinterpret_cast<double*>(base + 4 * S::kMTile + NX * kXWords * 4);
  double* Zs = Ps + TJ;                                 // [TJ] poles, [TJ] zhat
  float* Ysum = reinterpret_cast<float*>(Zs + TJ);      // [NACC][consumers]

  const size_t b = blockIdx.z;
  const int j0 = blockIdx.y * TJ;
  const int c0 = blockIdx.x * TC;
  const float* Xb = X + b * (size_t)m * C;
  float* Yb = Y + b * (size_t)m * C;
  const int64_t kb = Kact[b];
  const int kend = kb < 0 ? 0 : (kb > m ? m : (int)kb);
  const int nsteps = (kend + TI - 1) / TI;

  const int tid = threadIdx.x;
  const bool producer = tid >= kConsumers;
  const int ptid = tid - kConsumers;

  for (int r = tid; r < TJ; r += S::kThreads) {
    const int j = j0 + r;
    Ps[r] = j < m ? poles[b * m + j] : 0.0;
    Zs[r] = j < m ? zhat[b * m + j] : 0.0;
  }
  __syncthreads();

  // ---- producer side -----------------------------------------------------
  auto copy_x = [&](int step) {
    float* xs = Xs + (step % NX) * kXWords;
    const int i0 = step * TI;
#pragma unroll
    for (int l = 0; l < (TI * TC / 4) / S::kProducers; ++l) {
      const int q = ptid + S::kProducers * l;
      const int ii = q / (TC / 4), cc = (q % (TC / 4)) * 4;
      const int i = i0 + ii, c = c0 + cc;
      const int valid = i < kend ? max(0, min(4, C - c)) : 0;
      cp_async_f32(xs + ii * SX_ROW + cc, valid ? Xb + (size_t)i * C + c : Xb, vec, valid);
    }
  };
  // shift, tau and ncolinv of this thread's slot, fetched one step ahead
  double sv = 0.0, tv = 0.0, nv = 0.0;
  auto fetch_slot = [&](int step) {
    const int i = step * TI + (ptid & 31);
    const bool live = i < kend;
    sv = live ? shift[b * m + i] : 0.0;
    tv = live ? tau[b * m + i] : 0.0;
    nv = live ? ninv[b * m + i] : 0.0;
  };
  // Row r of the step's tile, slot ii: byte r * 128 + a swizzled offset in
  // the row.  A thread's rows are r0, r0 + PW, ...: with PW 2 or 4 their
  // r % 8 takes 8 / PW values in turn, so those offsets are worked out once.
  const int r0 = ptid >> 5, ii = ptid & 31;   // this thread's first row, its slot
  constexpr int kPhases = 8 / PW;
  static_assert(PW == 2 || PW == 4, "row phases of a producer thread");
  int chunk[kPhases];
#pragma unroll
  for (int ph = 0; ph < kPhases; ++ph)
    chunk[ph] = swizzled(r0 + ph * PW, ii) - (r0 + ph * PW) * 128;
  auto generate_m = [&](int step) {
    unsigned char* hi = Mt + (step & 1) * 2 * S::kMTile + r0 * 128;
    unsigned char* lo = hi + S::kMTile;
    // slots past K_b are exact zeros, whatever their poles
    const uint32_t live = step * TI + ii < kend ? 0xffffffffu : 0u;
    const double s0 = sv, t0 = tv, n0 = nv;
    if (step + 1 < nsteps) fetch_slot(step + 1);
    // GB rows at a time, every load before the first store, so that the
    // entries' long dependent chains interleave.  Rows past m hold zero
    // poles; what they give reaches only rows of Y that are not stored.
    float odd = 0.0f;   // becomes NaN with the first entry that is not finite
#pragma unroll 1
    for (int rb = 0; rb < TJ; rb += PW * GB) {
      uint2 w[GB];
#pragma unroll
      for (int u = 0; u < GB; ++u) {
        const int r = r0 + rb + u * PW;
        const float v = cauchy_entry_fast(Ps[r], s0, t0, Zs[r], n0);
        odd = fmaf(v, 0.0f, odd);
        w[u] = tf32_split(v);
      }
#pragma unroll
      for (int u = 0; u < GB; ++u) {
        const int off = (rb + u * PW) * 128 + chunk[u % kPhases];
        *reinterpret_cast<uint32_t*>(hi + off) = w[u].x & live;
        *reinterpret_cast<uint32_t*>(lo + off) = w[u].y & live;
      }
    }
    // an entry that is not finite (none on a solver's data): the denominator
    // may have been outside the normal range, so this thread's entries
    // again, one at a time, by the division
    if (odd != 0.0f) {
#pragma unroll 1
      for (int r = r0; r < TJ; r += PW) {
        const uint2 w = tf32_split(cauchy_entry(Ps[r], s0, t0, Zs[r], n0));
        const int off = swizzled(r, ii) - r0 * 128;
        *reinterpret_cast<uint32_t*>(hi + off) = w.x & live;
        *reinterpret_cast<uint32_t*>(lo + off) = w.y & live;
      }
    }
    // the tensor cores read shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // ---- consumer side -----------------------------------------------------
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cw0 = (warp >> 2) * 64 + (warp & 3) * 16;   // this warp's 16 columns
  float acc[NACC];
#pragma unroll
  for (int v = 0; v < NACC; ++v) acc[v] = 0.0f;

  auto multiply = [&](int step) {
    const float* xs = Xs + (step % NX) * kXWords + t * SX_ROW + cw0 + g;
    const uint32_t mt =
        static_cast<uint32_t>(__cvta_generic_to_shared(Mt + (step & 1) * 2 * S::kMTile));
    // a[kk][q] = X[slot 8 kk + t + 4 (q >> 1)][column g + 8 (q & 1)]
    uint32_t ahi[TI / 8][4], alo[TI / 8][4];
#pragma unroll
    for (int kk = 0; kk < TI / 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint2 w = tf32_split(xs[(8 * kk + 4 * (q >> 1)) * SX_ROW + 8 * (q & 1)]);
        ahi[kk][q] = w.x;
        alo[kk][q] = w.y;
      }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TI / 8; ++kk) {
      const uint64_t dhi = wgmma_desc(mt + 32 * kk);
      const uint64_t dlo = wgmma_desc(mt + S::kMTile + 32 * kk);
      // the two small passes first (x lo * m hi, x hi * m lo), then hi * hi
      wgmma_tf32(acc, alo[kk], dhi);
      wgmma_tf32(acc, ahi[kk], dlo);
      wgmma_tf32(acc, ahi[kk], dhi);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // the products read the fragments and write the sums behind the
    // compiler's back: both count as used up to here
#pragma unroll
    for (int kk = 0; kk < TI / 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        asm volatile("" : "+r"(ahi[kk][q]), "+r"(alo[kk][q])::"memory");
#pragma unroll
    for (int v = 0; v < NACC; ++v) asm volatile("" : "+f"(acc[v])::"memory");
  };
  // register sums into the running sums (each thread its own words,
  // thread-minor: no bank conflict, no barrier), rounded to nearest
  auto flush = [&](bool first) {
#pragma unroll
    for (int v = 0; v < NACC; ++v) {
      float* y = Ysum + v * kConsumers + tid;
      *y = first ? acc[v] : *y + acc[v];
      acc[v] = 0.0f;
    }
  };

  // ---- the pipeline ------------------------------------------------------
  if (producer && nsteps > 0) {
#pragma unroll
    for (int s = 0; s < NX - 1; ++s) {
      if (s < nsteps) copy_x(s);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    fetch_slot(0);
    generate_m(0);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NX - 2));
  }
  __syncthreads();
  for (int it = 0; it < nsteps; ++it) {
    if (producer) {
      // the X slot and the M buffer of step it-1 are free: the consumers
      // passed the barrier that ended that step
      if (it + NX - 1 < nsteps) copy_x(it + NX - 1);
      asm volatile("cp.async.commit_group;\n" ::);
      if (it + 1 < nsteps) generate_m(it + 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NX - 2));
    } else {
      multiply(it);
      if (FLUSH > 0 && (it + 1) % FLUSH == 0) flush(it + 1 == FLUSH);
    }
    __syncthreads();
  }
  if (producer) return;
  if (FLUSH > 0 && nsteps >= FLUSH) {
#pragma unroll
    for (int v = 0; v < NACC; ++v) acc[v] += Ysum[v * kConsumers + tid];
  }

  // ---- epilogue: acc[4 nb + 2 h + e] = Y[j0 + 8 nb + 2 t + e][column g + 8 h]
#pragma unroll
  for (int nb = 0; nb < TJ / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + 8 * nb + 2 * t + e;
      if (j >= m) continue;
      float* Yrow = Yb + (size_t)j * C + c0 + cw0 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (c0 + cw0 + g + 8 * h < C) Yrow[8 * h] = acc[4 * nb + 2 * h + e];
    }
}

constexpr int kMatThreads = 256;
constexpr int kMatRows = 8;   // output rows per block (one column per thread)

__global__ void __launch_bounds__(kMatThreads)
cauchy_materialize_kernel(const double* __restrict__ poles, const double* __restrict__ zhat,
                          const double* __restrict__ shift, const double* __restrict__ tau,
                          const double* __restrict__ ninv, const int64_t* __restrict__ slots,
                          const int64_t* __restrict__ Kact, float* __restrict__ U,
                          int m, int C) {
  const size_t b = blockIdx.z;
  const int c = blockIdx.x * kMatThreads + threadIdx.x;
  if (c >= C) return;
  const size_t bc = b * C + c;
  const int64_t slot = slots[bc];
  const bool active = slot < Kact[b];
  const double sv = shift[bc], tv = tau[bc], nv = ninv[bc];
  const int j0 = blockIdx.y * kMatRows;
  const int j1 = min(m, j0 + kMatRows);
  for (int j = j0; j < j1; ++j) {
    const float u = active ? cauchy_entry(poles[b * m + j], sv, tv, zhat[b * m + j], nv)
                           : (slot == j ? 1.0f : 0.0f);
    U[(b * m + j) * (size_t)C + c] = u;
  }
}

template <int TJ, int PW, int NX, int FLUSH, int MIN_BLOCKS, int GB>
int launch_matmul(const double* poles, const double* shift, const double* tau,
                  const double* zhat, const double* ninv, const float* X,
                  const int64_t* K, float* Y, int k, int m, int C, cudaStream_t stream) {
  using S = Shape<TJ, PW, NX, FLUSH>;
  auto kernel = cauchy_matmul_kernel<TJ, PW, NX, FLUSH, MIN_BLOCKS, GB>;
  // the shared-memory limit is kept per device: set on every launch
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (C % 4 == 0) && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const dim3 grid((C + TC - 1) / TC, (m + TJ - 1) / TJ, k);
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(poles, shift, tau, zhat, ninv, X, K, Y, m,
                                                  C, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// poles, shift, tau, zhat, ninv: (k, m) f64; X: (k, m, C) f32; K: (k,) int64;
// Y: (k, m, C) f32.  All contiguous on one device.  Merges of at most 64
// rows take the 64-row tile.  Launches on `stream`, allocates nothing,
// returns the first CUDA error.
extern "C" int cauchy_matmul_launch(const void* poles, const void* shift,
                                    const void* tau, const void* zhat,
                                    const void* ninv, const void* X,
                                    const void* K, void* Y, int k, int m,
                                    int C, void* stream) {
  if (k <= 0 || m <= 0 || C <= 0) return 0;
  const auto* p = static_cast<const double*>(poles);
  const auto* s = static_cast<const double*>(shift);
  const auto* t = static_cast<const double*>(tau);
  const auto* z = static_cast<const double*>(zhat);
  const auto* n = static_cast<const double*>(ninv);
  const auto* x = static_cast<const float*>(X);
  const auto* kk = static_cast<const int64_t*>(K);
  auto* y = static_cast<float*>(Y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 64) return launch_matmul<64, 2, 3, 0, 2, 4>(p, s, t, z, n, x, kk, y, k, m, C, st);
  return launch_matmul<128, 4, 4, 2, 1, 8>(p, s, t, z, n, x, kk, y, k, m, C, st);
}

// poles, zhat: (k, m) f64; shift, tau, ninv: (k, C) f64; slots: (k, C) int64;
// K: (k,) int64; U: (k, m, C) f32.  Same conventions as above.
extern "C" int cauchy_materialize_launch(const void* poles, const void* zhat,
                                         const void* shift, const void* tau,
                                         const void* ninv, const void* slots,
                                         const void* K, void* U, int k, int m,
                                         int C, void* stream) {
  if (k <= 0 || m <= 0 || C <= 0) return 0;
  const dim3 grid((C + kMatThreads - 1) / kMatThreads,
                  (m + kMatRows - 1) / kMatRows, k);
  cauchy_materialize_kernel<<<grid, kMatThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(poles), static_cast<const double*>(zhat),
      static_cast<const double*>(shift), static_cast<const double*>(tau),
      static_cast<const double*>(ninv), static_cast<const int64_t*>(slots),
      static_cast<const int64_t*>(K), static_cast<float*>(U), m, C);
  return static_cast<int>(cudaGetLastError());
}
