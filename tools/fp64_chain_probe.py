#!/usr/bin/env python3
"""Latency of the FP64 operations on the chains of ``deflation_tree`` and
``block_lu_solve``, on one GPU, by clock64 around dependent chains.

It writes a small CUDA source into ``build/fp64_chain/``, builds it with
``nvcc`` for ``sm_90a`` and runs one warp of dependent chains a kind, each
operation fed by the last one's result so nothing overlaps: ``__dmul_rn``,
``__dadd_rn``, ``__ddiv_rn`` and ``__dsqrt_rn`` on normal operands of
moderate exponent, ``__ddiv_rn`` with a subnormal numerator, with a
quotient near 2^-1000 and near 2^900 (the ranges where its fast path may
give way to the slow one; those three chains also carry a subtraction and an
addition a step), a double's ``__shfl_xor_sync`` and a shared-memory load, and ``ddiv_fast`` (``csrc/spike_solve.cu``, the source's own text:
``__ddiv_rn``'s fast path without its branch).  Then it holds
``ddiv_fast`` against ``__ddiv_rn`` on 2^26 pairs each of every bit
pattern, of moderate exponents and of the block LU's range, and
``dsqrt_fast`` (``csrc/deflation_tree.cu``) against ``__dsqrt_rn`` on 2^26
values each of every bit pattern and of the rotations' range: wherever a
fast path applies its bits must be the intrinsic's.  Prints one JSON line:
cycles an operation for each kind and the pairs' counts, with the card's
name and power limit (nvidia-smi):

    python3 tools/fp64_chain_probe.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from symmetric_eigenvalue_tpu_torch import _build  # noqa: E402

KINDS = ("dmul", "dadd", "ddiv", "dsqrt", "ddiv_subnormal_numerator",
         "ddiv_quotient_2^-1000", "ddiv_quotient_2^900", "shfl_double",
         "shared_load", "ddiv_fast")
FAST_DDIV = ROOT / "symmetric_eigenvalue_tpu_torch" / "csrc" / "spike_solve.cu"
FAST_DSQRT = ROOT / "symmetric_eigenvalue_tpu_torch" / "csrc" / "deflation_tree.cu"
PAIRS = 1 << 26
CHAIN = 1024

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

@FAST_DDIV@
@FAST_DSQRT@

template <int KIND>
__device__ __forceinline__ double step(double x, double a, double b, const double* sh) {
  if constexpr (KIND == 0) return __dmul_rn(x, a);                 // a ~ 1
  else if constexpr (KIND == 1) return __dadd_rn(x, a);
  else if constexpr (KIND == 2) return __ddiv_rn(a, x);            // moderate
  else if constexpr (KIND == 3) return __dsqrt_rn(x);              // x ~ 1
  else if constexpr (KIND == 4) return __ddiv_rn(__dadd_rn(b, __dsub_rn(x, x)), a);
  else if constexpr (KIND == 5)
    return __ddiv_rn(__dadd_rn(b * 1e300, __dsub_rn(x, x)), 1e284);
  else if constexpr (KIND == 6) return __ddiv_rn(__dadd_rn(1e300, __dsub_rn(x, x)), 1e29);
  else if constexpr (KIND == 7) return __shfl_xor_sync(0xffffffffu, x, 1);
  else if constexpr (KIND == 8) return sh[(__double_as_longlong(x) & 1) + threadIdx.x];
  else {
    bool ok;
    return ddiv_fast(a, x, ok);
  }
}

__device__ __forceinline__ uint64_t mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// ddiv_fast against __ddiv_rn on n pairs: mode 0 every bit pattern (all
// exponents, subnormals, zeros, infinities, NaNs), mode 1 moderate
// exponents (|x|, |y| in 2^-60 .. 2^60), mode 2 the block LU's range (x up
// to 2^81, y down to 2^-200); counts where the fast path applies and where
// its bits differ from __ddiv_rn's
__global__ void check_kernel(int mode, long long n, unsigned long long* counts) {
  unsigned long long taken = 0, differ = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint64_t a = mix(2 * i + 17 * mode), b = mix(2 * i + 1 + 17 * mode);
    if (mode > 0) {
      const int span = mode == 1 ? 120 : 280, lo = mode == 1 ? 60 : 200;
      const uint64_t ea = (1023 - lo + (a >> 52) % span) & 0x7ff;
      const uint64_t eb = (1023 - lo + (b >> 52) % span) & 0x7ff;
      a = (a & 0x800fffffffffffffull) | (ea << 52);
      b = (b & 0x800fffffffffffffull) | (eb << 52);
    }
    const double x = __longlong_as_double(a), y = __longlong_as_double(b);
    bool ok;
    const double q = ddiv_fast(x, y, ok);
    if (ok) {
      ++taken;
      if (__double_as_longlong(q) != __double_as_longlong(__ddiv_rn(x, y))) ++differ;
    }
  }
  atomicAdd(counts, taken);
  atomicAdd(counts + 1, differ);
}

// dsqrt_fast against __dsqrt_rn: mode 0 every bit pattern, mode 1 the
// rotations' range (x = za^2 + zb^2 in 2^-200 .. 2^200)
__global__ void check_sqrt_kernel(int mode, long long n, unsigned long long* counts) {
  unsigned long long taken = 0, differ = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint64_t a = mix(3 * i + 101 * mode);
    if (mode > 0) a = (a & 0x000fffffffffffffull) | ((823 + (a >> 52) % 400) << 52);
    const double x = __longlong_as_double(a);
    bool ok;
    const double q = dsqrt_fast(x, ok);
    if (ok) {
      ++taken;
      if (__double_as_longlong(q) != __double_as_longlong(__dsqrt_rn(x))) ++differ;
    }
  }
  atomicAdd(counts, taken);
  atomicAdd(counts + 1, differ);
}

extern "C" int check_sqrt(int mode, long long n, unsigned long long* out) {
  unsigned long long* d;
  cudaMalloc(&d, 2 * sizeof(unsigned long long));
  cudaMemset(d, 0, 2 * sizeof(unsigned long long));
  check_sqrt_kernel<<<1024, 256>>>(mode, n, d);
  cudaError_t err = cudaMemcpy(out, d, 2 * sizeof(unsigned long long),
                               cudaMemcpyDeviceToHost);
  cudaFree(d);
  return static_cast<int>(err);
}

extern "C" int check(int mode, long long n, unsigned long long* out) {
  unsigned long long* d;
  cudaMalloc(&d, 2 * sizeof(unsigned long long));
  cudaMemset(d, 0, 2 * sizeof(unsigned long long));
  check_kernel<<<1024, 256>>>(mode, n, d);
  cudaError_t err = cudaMemcpy(out, d, 2 * sizeof(unsigned long long),
                               cudaMemcpyDeviceToHost);
  cudaFree(d);
  return static_cast<int>(err);
}

template <int KIND>
__global__ void chain_kernel(int n, double a, double b, long long* cycles, double* sink) {
  __shared__ double sh[64];
  sh[threadIdx.x] = 1.0;
  sh[threadIdx.x + 32] = 1.0;
  __syncwarp();
  double x = 1.0 + threadIdx.x * 1e-9;
  const long long t0 = clock64();
#pragma unroll 8
  for (int i = 0; i < n; ++i) x = step<KIND>(x, a, b, sh);
  const long long t1 = clock64();
  sink[threadIdx.x] = x;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

template <int KIND>
int run(int n, double a, double b, long long* out) {
  long long* d_cycles;
  double* d_sink;
  cudaMalloc(&d_cycles, sizeof(long long));
  cudaMalloc(&d_sink, 32 * sizeof(double));
  chain_kernel<KIND><<<1, 32>>>(n, a, b, d_cycles, d_sink);
  cudaError_t err = cudaMemcpy(out, d_cycles, sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(d_cycles);
  cudaFree(d_sink);
  return static_cast<int>(err);
}

extern "C" int chain(int kind, int n, double a, double b, long long* out) {
  switch (kind) {
    case 0: return run<0>(n, a, b, out);
    case 1: return run<1>(n, a, b, out);
    case 2: return run<2>(n, a, b, out);
    case 3: return run<3>(n, a, b, out);
    case 4: return run<4>(n, a, b, out);
    case 5: return run<5>(n, a, b, out);
    case 6: return run<6>(n, a, b, out);
    case 7: return run<7>(n, a, b, out);
    case 8: return run<8>(n, a, b, out);
    default: return run<9>(n, a, b, out);
  }
}
"""


def main():
    work = ROOT / "build" / "fp64_chain"
    work.mkdir(parents=True, exist_ok=True)
    src, lib = work / "chain.cu", work / "libchain.so"
    text = FAST_DDIV.read_text()
    fast = text[text.index("// FAST_DDIV_BEGIN"):text.index("// FAST_DDIV_END")]
    text = FAST_DSQRT.read_text()
    root = text[text.index("// FAST_DSQRT_BEGIN"):text.index("// FAST_DSQRT_END")]
    src.write_text(SOURCE.replace("@FAST_DDIV@", fast).replace("@FAST_DSQRT@",
                                                               root))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).chain
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   ctypes.c_double, ctypes.c_void_p]
    out = ctypes.c_longlong()
    cycles = {}
    for kind, name in enumerate(KINDS):
        a, b = 1.0000001, 2.0 ** -1060
        if name == "ddiv":
            a = 1.0
        per = []
        for n in (CHAIN, 2 * CHAIN):          # the difference drops the ends
            if fn(kind, n, a, b, ctypes.byref(out)) != 0:
                raise RuntimeError(f"chain {name} failed")
            fn(kind, n, a, b, ctypes.byref(out))
            per.append(out.value)
        cycles[name] = (per[1] - per[0]) / CHAIN
    chk = ctypes.CDLL(str(lib)).check
    chk.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    pair = (ctypes.c_ulonglong * 2)()
    fast = {}
    for mode, name in enumerate(("every_bit_pattern", "moderate_exponents",
                                 "block_lu_range")):
        if chk(mode, PAIRS, ctypes.addressof(pair)) != 0:
            raise RuntimeError("check failed")
        fast[name] = {"pairs": PAIRS, "fast_path_taken": int(pair[0]),
                      "bits_differ_from_ddiv_rn": int(pair[1])}
    chk2 = ctypes.CDLL(str(lib)).check_sqrt
    chk2.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    roots = {}
    for mode, name in enumerate(("every_bit_pattern", "rotation_range")):
        if chk2(mode, PAIRS, ctypes.addressof(pair)) != 0:
            raise RuntimeError("check_sqrt failed")
        roots[name] = {"values": PAIRS, "fast_path_taken": int(pair[0]),
                       "bits_differ_from_dsqrt_rn": int(pair[1])}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()
    print(json.dumps({"tool": "fp64_chain_probe", "card": card,
                      "cycles_an_operation": cycles,
                      "ddiv_fast_against_ddiv_rn": fast,
                      "dsqrt_fast_against_dsqrt_rn": roots}))


if __name__ == "__main__":
    main()
