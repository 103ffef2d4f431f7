#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    every CUDA kernel of the port, built from csrc/ by nvcc
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes: time, plain time, library time, error
  4. solve    the main path: solve_tridiagonal_staged, n=16384 random f64
              (bench.py's input, seed 0), all eigenpairs; residual,
              orthogonality and eigenvalues against scipy; launch counts
  5. poisson  eigh_tridiagonal(eigvals_only=True) on the n=16384 Poisson
              matrix against its analytic spectrum
  6. profile  one more main-path solve under torch.profiler: device time
              by kernel and the device's idle share
  7. the per-kernel summary line, then the nvidia-smi line, then the
     final {"ok": true, ...} line

Needs one CUDA card; exits 1 without printing a result when
torch.cuda.is_available() is False.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import scipy.linalg
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu_torch import _build
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_rowsum as cr
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as dm
from symmetric_eigenvalue_tpu_torch.kernels import secular_sums as ss
from symmetric_eigenvalue_tpu_torch.utils.checks import max_ortho_error

N = 16384
SEED = 0
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): FP64 on the tensor
# cores (DMMA) and on the CUDA cores, and the HBM3 rate
PEAK_FP64_TENSOR = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(ops: float, peak: float, nbytes: float):
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def check_secular_sums(k, m, reps):
    """Roots at every slot (shift = own pole, sl = slot), tau inside the
    gap, a few roots 1e-13 from their pole: as the top / bottom merge
    levels give them."""
    g = np.random.default_rng(1)
    dev = "cuda"
    poles = np.sort(g.standard_normal((k, m)), axis=1)
    gaps = np.diff(poles, axis=1, append=poles[:, -1:] + 1.0)
    tau = 0.45 * gaps * g.random((k, m)) + 1e-15
    tau[:, ::997] = 1e-13
    z2 = (0.1 * g.standard_normal((k, m))) ** 2
    sl = np.tile(np.arange(m), (k, 1))
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    args = (t(poles), t(z2), t(poles), t(tau), t(sl, torch.int64))
    got = ss.secular_sums(*args)
    ref = ss.secular_sums_plain(*args)
    # scale per root: max(|sum|, max_j |term|) (the S2 terms are positive)
    P, Z, S, T = args[:4]
    tmax = torch.empty((k, m), dtype=torch.float64, device=dev)
    step = max(1, (1 << 22) // (k * m))
    for i0 in range(0, m, step):
        dif = ((P[:, None, :] - S[:, i0:i0 + step, None])
               - T[:, i0:i0 + step, None])
        tmax[:, i0:i0 + step] = (Z[:, None, :] / dif).abs().amax(dim=2)
    sc1 = torch.maximum(ref[0].abs(), tmax)
    sc2 = ref[1].abs()
    err = max(float(((got[0] - ref[0]).abs() / sc1).max()),
              float(((got[2] - ref[2]).abs() / sc1).max()),
              float(((got[1] - ref[1]).abs() / sc2).max()),
              float(((got[3] - ref[3]).abs() / sc2).max()))
    abs_err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
    ms = time_ms(lambda: ss.secular_sums(*args), reps)
    plain = time_ms(lambda: ss.secular_sums_plain(*args), max(1, reps // 4))
    pairs = float(k) * m * m
    left = float(k) * m * (m + 1) / 2
    ops = 7.0 * pairs + 2.0 * left   # 2 sub, div, 2 mul, 2 add; +2 if j<=sl
    nbytes = 8.0 * (2 * k * m + 3 * k * m + 4 * k * m)
    b_ms, b_by = bound(ops, PEAK_FP64, nbytes)
    return dict(k=k, m=m, B=m, max_rel_err=err, tol=1e-12,
                max_abs_err=abs_err, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by)


def check_cauchy_rowsum(k, m, reps):
    g = np.random.default_rng(2)
    dev = "cuda"
    poles = np.sort(g.standard_normal((k, m)), axis=1)
    gaps = np.diff(poles, axis=1, append=poles[:, -1:] + 1.0)
    tau = 0.45 * gaps * g.random((k, m)) + 1e-15
    tau[:, ::997] = 1e-13
    wz = 0.2 * g.standard_normal((k, 2, m))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    args = (t(poles), t(poles), t(tau), t(wz))
    got = cr.cauchy_rowsum(*args)
    ref = cr.cauchy_rowsum_plain(*args)
    abs_err = float((got - ref).abs().max())
    err = abs_err / float(ref.abs().max())
    ms = time_ms(lambda: cr.cauchy_rowsum(*args), reps)
    plain = time_ms(lambda: cr.cauchy_rowsum_plain(*args), reps)
    pairs = float(k) * m * m
    b_ms, b_by = bound(7.0 * pairs, PEAK_FP64, 8.0 * (3 * k * m + 4 * k * m))
    return dict(k=k, m=m, rows=2, max_rel_err=err, tol=1e-12,
                max_abs_err=abs_err, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by)


def check_dword_matmul(k, M, K, N, reps):
    g = torch.Generator(device="cuda").manual_seed(3)
    A = torch.randn((k, M, K), dtype=torch.float64, device="cuda", generator=g)
    B = torch.randn((k, K, N), dtype=torch.float64, device="cuda", generator=g)
    got = dm.dword_matmul(A, B)
    ref = dm.dword_matmul_plain(A, B)
    scale = torch.matmul(A.abs(), B.abs())
    err = float(((got - ref).abs() / scale).max())
    abs_err = float((got - ref).abs().max())
    del scale
    ms = time_ms(lambda: dm.dword_matmul(A, B), reps)
    plain = time_ms(lambda: dm.dword_matmul_plain(A, B), reps)
    library = time_ms(lambda: torch.matmul(A, B), reps)
    b_ms, b_by = bound(2.0 * k * M * N * K, PEAK_FP64_TENSOR,
                       8.0 * k * (M * K + K * N + M * N))
    return dict(k=k, M=M, K=K, N=N, max_rel_err=err, tol=1e-12,
                max_abs_err=abs_err, ms=ms,
                plain_ms=plain, library_ms=library, bound_ms=b_ms,
                bound_by=b_by)


def profile_main_path(d, e, cfg, top: int = 12):
    """Device time by kernel over one main-path solve (torch.profiler), the
    device's busy time and its idle share of the wall."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st.solve_tridiagonal_staged(d, e, config=cfg, compute_vectors=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the CPU-side operator
        # rows repeat their kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "top": [{"name": k[:90], "device_s": us * 1e-6, "calls": c}
                    for us, c, k in rows[:top]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi_line = smi.splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi_line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build (one nvcc per source, all at once)
    t0 = time.perf_counter()
    reports = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(reports), "ptxas": {
              name: [ln.strip() for ln in rep.splitlines() if "Used" in ln]
              for name, rep in reports.items()}})

    # 3. each kernel against its plain version at the main path's shapes:
    # secular_sums at the root level (k=1, all m roots) and the bottom level
    # (k=256 merges of m=64); cauchy_rowsum at the widest non-root level;
    # dword_matmul at the m=8192 level's GEMM (2048-row block x 8192 cols)
    checks = {
        "secular_sums": [check_secular_sums(1, N, 10),
                         check_secular_sums(256, 64, 50)],
        "cauchy_rowsum": [check_cauchy_rowsum(2, 8192, 20)],
        "dword_matmul": [check_dword_matmul(2, 2048, 8192, 8192, 5)],
    }
    for name, rows in checks.items():
        for row in rows:
            emit({"phase": "kernel_check", "kernel": name, **row})
            require(row["max_rel_err"] <= row["tol"],
                    f"{name} disagrees with its plain version: {row}")

    # 4. the main path: all eigenpairs of bench.py's random n=16384 input
    rng = np.random.default_rng(SEED)
    d = rng.standard_normal(N) * 5.0
    e = rng.standard_normal(N - 1) * 2.0
    cfg = st.SolverConfig(mixed_precision_vectors=False)
    for mod in (ss, cr, dm):
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                             compute_vectors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"secular_sums": ss.launches, "cauchy_rowsum": cr.launches,
                "dword_matmul": dm.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    lam = res.eigenvalues.cpu().numpy()
    V = res.eigenvectors
    require(V.shape == (N, N) and bool(torch.isfinite(V).all())
            and np.isfinite(lam).all(), "non-finite or misshapen result")
    norm_t = float(np.abs(lam).max())
    resid = float(st.residuals(d, e, res).max()) / norm_t
    ortho = max_ortho_error(V)
    ref = scipy.linalg.eigvalsh_tridiagonal(d, e)
    lam_err = float(np.abs(lam - ref).max()) / norm_t
    del res, V
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res2, timer2 = st.solve_tridiagonal_staged(d, e, config=cfg,
                                               compute_vectors=True)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    del res2
    emit({"phase": "solve", "n": N, "matrix": "random", "seed": SEED,
          "config": "mixed_precision_vectors=False", "wall_s": wall,
          "phases_s": timer.times, "warm_wall_s": wall2,
          "warm_phases_s": timer2.times, "peak_mem_bytes": peak_mem,
          "residual_over_normT": resid, "ortho": ortho,
          "eig_err_vs_scipy_over_normT": lam_err, "launches": launches})
    require(resid <= 1e-12, f"residual {resid} > 1e-12 ||T||")
    require(ortho <= 1e-10, f"orthogonality {ortho} > 1e-10")
    require(lam_err <= 1e-12, f"eigenvalues off scipy by {lam_err} ||T||")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    # 5. deflation-heavy: Poisson eigenvalues against the analytic spectrum
    dp, ep = st.create_matrix_scheme2(N)
    t0 = time.perf_counter()
    lam_p = st.eigh_tridiagonal(dp, ep, config=cfg, eigvals_only=True)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    exact = st.eigenvalues_of_scheme2(N)
    p_err = float(np.abs(lam_p.cpu().numpy() - exact).max()) / \
        float(np.abs(exact).max())
    emit({"phase": "poisson", "n": N, "eigvals_only": True, "wall_s": wall_p,
          "eig_err_vs_analytic_over_normT": p_err})
    require(p_err <= 1e-12, f"Poisson eigenvalues off by {p_err} ||T||")

    # 6. where the main path's device time goes (one more run, profiled)
    emit({"phase": "profile", **profile_main_path(d, e, cfg)})

    # 7. summary
    replaces = {
        "secular_sums":
            "symmetric_eigenvalue_tpu/kernels/pallas/secular_sums.py:169",
        "cauchy_rowsum":
            "symmetric_eigenvalue_tpu/kernels/pallas/cauchy_rowsum.py:143",
        "dword_matmul":
            "symmetric_eigenvalue_tpu/kernels/pallas/dword_matmul.py:183",
    }
    kernels = []
    for name, rows in checks.items():
        row = rows[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"symmetric_eigenvalue_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
