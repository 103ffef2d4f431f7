#!/usr/bin/env python3
"""Where a wave of ``band_chase`` spends its time, on one GPU.

Copies the port's package into ``build/chase_phase_profile/``, adds clock64
probes to that copy of ``csrc/band_reduce.cu`` (the repository's source is
not touched), and runs the chase of a random band matrix at (n, b) =
(4096, 128), (4096, 16), (16384, 128), (16384, 16).  For each item kind
(``diag``, ``left``, ``next``, ``right``, ``task``, see
``band_reduce.chase_slot_items``) it prints the mean of three phases a
block measures: the loads (record and tile, to the first barrier), the
update (to the reflector's step) and the rest (the next hop's reflector,
the item's last barrier); and, per wave, block 0's own work and its wait at
the grid sync.  Clock cycles are converted at the card's maximum SM clock
(nvidia-smi clocks.max.sm).  The probes' atomics slow the chase by a few
per cent; its time is printed beside.

``--copy-rate`` instead runs a microbenchmark of one SM's copy rate: each
block loads 128 KB of contiguous doubles from global into shared memory
(8-byte ``cp.async``, 16-byte ``cp.async.cg`` or ``ld.global.cg`` eight at
a time a thread) and stores it back, at 256 and 1024 threads and 1 to 264
blocks; clock64 a block, averaged.

    python3 tools/chase_phase_profile.py [--copy-rate]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "build" / "chase_phase_profile"
KINDS = ("diag", "left", "next", "right", "task")

PROBES = [
    ("namespace {\n", "__device__ unsigned long long g_dbg[64];\nnamespace {\n"),
    ("    const int nitems = W * items + hop0;\n"
     "    if (nitems == 0) continue;                       // the same for every block\n",
     "    const int nitems = W * items + hop0;\n"
     "    if (nitems == 0) continue;                       // the same for every block\n"
     "    const long long w0 = clock64();\n"),
    ("      const int s = it / items, qi = it - s * items;",
     "      const long long d0 = clock64();\n"
     "      const int s = it / items, qi = it - s * items;"),
    ("      if (threadIdx.x < b) v[threadIdx.x] = vr;\n      __syncthreads();\n",
     "      if (threadIdx.x < b) v[threadIdx.x] = vr;\n      __syncthreads();\n"
     "      const long long d1 = clock64();\n"),
    ("      // the next hop's reflector (a whole task's formed above)",
     "      const long long d2 = clock64();\n"
     "      // the next hop's reflector (a whole task's formed above)"),
    ("        form_task(a, t, q.jj, q.kk + 1, x, q.r, b);\n      }\n"
     "      __syncthreads();\n    }\n    grid.sync();\n",
     "        form_task(a, t, q.jj, q.kk + 1, x, q.r, b);\n      }\n"
     "      __syncthreads();\n"
     "      if (threadIdx.x == 0) {\n"
     "        atomicAdd(&g_dbg[kind * 4], (unsigned long long)(d1 - d0));\n"
     "        atomicAdd(&g_dbg[kind * 4 + 1], (unsigned long long)(d2 - d1));\n"
     "        atomicAdd(&g_dbg[kind * 4 + 2], (unsigned long long)(clock64() - d2));\n"
     "        atomicAdd(&g_dbg[kind * 4 + 3], 1ULL);\n"
     "      }\n    }\n"
     "    const long long w1 = clock64();\n    grid.sync();\n"
     "    if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "      g_dbg[40] += (unsigned long long)(w1 - w0);\n"
     "      g_dbg[41] += (unsigned long long)(clock64() - w1);\n"
     "      g_dbg[42] += 1ULL;\n    }\n"),
]
READERS = """
extern "C" int chase_probe_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_dbg, sizeof(g_dbg));
}
extern "C" int chase_probe_reset() {
  unsigned long long z[64] = {0};
  return (int)cudaMemcpyToSymbol(g_dbg, z, sizeof(z));
}
"""

COPY_RATE = r"""
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
__device__ unsigned long long g_t[4096];
template <int W>
__global__ void copy_kernel(const double* src, double* dst, int n) {
  extern __shared__ double sh[];
  const double* s = src + (size_t)blockIdx.x * n;
  double* d = dst + (size_t)blockIdx.x * n;
  for (int rep = 0; rep < 3; ++rep) {
    __syncthreads();
    long long t0 = clock64();
    if (W == 8) {
      for (int k = threadIdx.x; k < n; k += blockDim.x) {
        unsigned a = (unsigned)__cvta_generic_to_shared(sh + k);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(s + k) : "memory");
      }
    } else if (W == 16) {
      for (int k = 2 * threadIdx.x; k < n; k += 2 * blockDim.x) {
        unsigned a = (unsigned)__cvta_generic_to_shared(sh + k);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(s + k) : "memory");
      }
    } else {
      for (int k0 = threadIdx.x; k0 < n; k0 += 8 * blockDim.x) {
        double x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) if (k0 + u * blockDim.x < n) x[u] = __ldcg(s + k0 + u * blockDim.x);
#pragma unroll
        for (int u = 0; u < 8; ++u) if (k0 + u * blockDim.x < n) sh[k0 + u * blockDim.x] = x[u];
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    long long t1 = clock64();
    for (int k = threadIdx.x; k < n; k += blockDim.x) d[k] = sh[k] + 1.0;
    __syncthreads();
    long long t2 = clock64();
    if (threadIdx.x == 0 && rep == 2) { g_t[2 * blockIdx.x] = t1 - t0; g_t[2 * blockIdx.x + 1] = t2 - t1; }
  }
}
int main(int argc, char** argv) {
  const int n = 16384;
  const double mhz = atof(argv[1]);
  double *src, *dst;
  cudaMalloc(&src, 264 * (size_t)n * 8);
  cudaMalloc(&dst, 264 * (size_t)n * 8);
  cudaMemset(src, 0, 264 * (size_t)n * 8);
  const char* names[] = {"ld.global.cg x8", "cp.async 8 B", "cp.async.cg 16 B"};
  for (int w = 0; w < 3; ++w) for (int T : {256, 1024}) for (int G : {1, 88, 132, 264}) {
    auto k = w == 0 ? copy_kernel<0> : w == 1 ? copy_kernel<8> : copy_kernel<16>;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, n * 8);
    k<<<G, T, n * 8>>>(src, dst, n);
    cudaDeviceSynchronize();
    unsigned long long h[4096];
    cudaMemcpyFromSymbol(h, g_t, sizeof(h));
    double l = 0, st = 0;
    for (int g = 0; g < G; ++g) { l += h[2 * g]; st += h[2 * g + 1]; }
    printf("{\"loads\": \"%s\", \"threads\": %d, \"blocks\": %d, \"kb_a_block\": 128, "
           "\"load_us\": %.3f, \"store_us\": %.3f, \"error\": \"%s\"}\n", names[w], T, G,
           l / G / mhz, st / G / mhz, cudaGetErrorString(cudaGetLastError()));
  }
  return 0;
}
"""


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.strip()


def copy_rate(mhz: float, card: str) -> int:
    WORK.mkdir(parents=True, exist_ok=True)
    src, exe = WORK / "copy_rate.cu", WORK / "copy_rate"
    src.write_text(COPY_RATE)
    from symmetric_eigenvalue_tpu_torch import _build   # noqa: E402
    subprocess.run([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe), str(mhz)], capture_output=True, text=True,
                         check=True).stdout
    for line in out.splitlines():
        print(json.dumps({**json.loads(line), "card": card}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--copy-rate", action="store_true")
    args = ap.parse_args()
    card = smi("name,power.limit").replace("\n", "; ")
    mhz = float(smi("clocks.max.sm").split()[0])
    sys.path.insert(0, str(ROOT))
    if args.copy_rate:
        return copy_rate(mhz, card)
    shutil.rmtree(WORK / "symmetric_eigenvalue_tpu_torch", ignore_errors=True)
    shutil.copytree(ROOT / "symmetric_eigenvalue_tpu_torch",
                    WORK / "symmetric_eigenvalue_tpu_torch")
    cu = WORK / "symmetric_eigenvalue_tpu_torch" / "csrc" / "band_reduce.cu"
    text = cu.read_text()
    for old, new in PROBES:
        if text.count(old) != 1:
            raise SystemExit(f"probe anchor not found once: {old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text + READERS)
    sys.path[0] = str(WORK)
    import torch
    from symmetric_eigenvalue_tpu_torch import _build
    from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as br
    _build.build_all(["band_reduce"])
    br.band_to_tridiag_wave(torch.zeros((8, 8), dtype=torch.float64,
                                        device="cuda"), 2)
    lib = _build._LIBS["band_reduce"]
    lib.chase_probe_read.argtypes = [ctypes.c_void_p]
    us = lambda cycles: cycles / mhz          # noqa: E731
    for n, b in ((4096, 128), (4096, 16), (16384, 128), (16384, 16)):
        g = torch.Generator(device="cuda").manual_seed(3)
        A = torch.randn((n, n), dtype=torch.float64, device="cuda",
                        generator=g)
        A = (A + A.T) / 2
        i = torch.arange(n, device="cuda")
        B = torch.where((i[:, None] - i[None, :]).abs() <= b, A, 0.0)
        del A
        br.band_to_tridiag_wave(B, b)
        torch.cuda.synchronize()
        lib.chase_probe_reset()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        br.band_to_tridiag_wave(B, b)
        stop.record()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 64)()
        lib.chase_probe_read(ctypes.addressof(out))
        row = {"n": n, "b": b, "ms_with_probes": start.elapsed_time(stop),
               "plan": br.chase_device_plan(
                   n, b, torch.cuda.current_device())._asdict(),
               "card": card, "clock_mhz": mhz}
        for k, name in enumerate(KINDS):
            count = out[4 * k + 3]
            if count:
                row[name] = {"items": count,
                             "load_us": us(out[4 * k]) / count,
                             "update_us": us(out[4 * k + 1]) / count,
                             "rest_us": us(out[4 * k + 2]) / count}
        waves = out[42]
        row.update(waves=waves, block0_work_us=us(out[40]) / waves,
                   block0_sync_wait_us=us(out[41]) / waves)
        print(json.dumps(row), flush=True)
        del B
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
