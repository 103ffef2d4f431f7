#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  1. device    the card's name and power limit (nvidia-smi), torch and CUDA
  2. build     every CUDA kernel of the port, built from csrc/ by nvcc (one
               process per source, all at once)
  3. kernels   each kernel against its plain PyTorch version on the card at
               the main path's shapes: time, plain time, library time,
               bound, error and tolerance
  4. solve     the main path: solve_tridiagonal_staged with the default
               (mixed-precision) SolverConfig, n=16384 random (bench.py's
               input, seed 0), all eigenpairs, cold then three times
               warm; residual, orthogonality and eigenvalues against
               scipy; the triage's column counts; launch counts of all
               seven kernels
  5. solve_f64 the same input through the pure-f64 path
               (mixed_precision_vectors=False), cold then three times warm
  6. poisson   eigh_tridiagonal(eigvals_only=True) and the mixed path's full
               eigenpairs on the n=16384 Poisson matrix against its analytic
               spectrum (heavy deflation, wide cluster segments)
  7. profile   one more warm main-path solve under torch.profiler: device
               time by kernel, the device's idle share, and the host time,
               device span and launches of the interface solve and the
               residual triage
  8. the per-kernel summary line, then the nvidia-smi line, then the final
     {"ok": true, ...} line

Needs one CUDA card; exits 1 without printing a result when
torch.cuda.is_available() is False.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
from symmetric_eigenvalue_tpu_torch.driver import _prescale
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_matmul as cm
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_rowsum as cr
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as dm
from symmetric_eigenvalue_tpu_torch.kernels import secular_sums as ss
from symmetric_eigenvalue_tpu_torch.kernels import spike_solve as sp
from symmetric_eigenvalue_tpu_torch.kernels.refine import band_prep
from symmetric_eigenvalue_tpu_torch.utils.checks import max_ortho_error

N = 16384
SEED = 0
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): FP64 on the tensor
# cores (DMMA) and on the CUDA cores, FP32 on the CUDA cores, the HBM3 rate
PEAK_FP64_TENSOR = 67e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

REPLACES = {
    "secular_sums":
        "symmetric_eigenvalue_tpu/kernels/pallas/secular_sums.py:169",
    "cauchy_rowsum":
        "symmetric_eigenvalue_tpu/kernels/pallas/cauchy_rowsum.py:143",
    "dword_matmul":
        "symmetric_eigenvalue_tpu/kernels/pallas/dword_matmul.py:183",
    "cauchy_matmul":
        "symmetric_eigenvalue_tpu/kernels/pallas/cauchy_matmul.py:174",
    "cauchy_materialize":
        "symmetric_eigenvalue_tpu/kernels/pallas/cauchy_matmul.py:270",
    "spike_pass_a":
        "symmetric_eigenvalue_tpu/kernels/pallas/spike_solve.py:270",
    "spike_pass_b":
        "symmetric_eigenvalue_tpu/kernels/pallas/spike_solve.py:296",
}
SOURCES = {"spike_pass_a": "spike_solve", "spike_pass_b": "spike_solve",
           "cauchy_materialize": "cauchy_matmul"}


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


def launch_counts():
    return {"secular_sums": ss.launches, "cauchy_rowsum": cr.launches,
            "dword_matmul": dm.launches,
            "cauchy_matmul": cm.matmul_launches,
            "cauchy_materialize": cm.materialize_launches,
            "spike_pass_a": sp.pass_a_launches,
            "spike_pass_b": sp.pass_b_launches}


def reset_counts() -> None:
    ss.launches = cr.launches = dm.launches = 0
    cm.matmul_launches = cm.materialize_launches = 0
    sp.pass_a_launches = sp.pass_b_launches = 0


def random_matrix(n: int, seed: int):
    """bench.py's random input: d ~ 5 N(0, 1), e ~ 2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) * 5.0, rng.standard_normal(n - 1) * 2.0


# --------------------------------------------------------------------------
# kernels of the eigenvalue phase and the f64 downsweep

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


# --------------------------------------------------------------------------
# kernels of the mixed-precision downsweep and refinement

def _merge_data(g, k, m):
    """Merge-like Cauchy inputs on the card: sorted poles, shifts at poles,
    roots 1e-13..0.45 gap away, a few 1e-13 from their pole."""
    poles = np.sort(g.standard_normal((k, m)), axis=1)
    gaps = np.diff(poles, axis=1, append=poles[:, -1:] + 1.0)
    tau = 0.45 * gaps * g.random((k, m)) + 1e-15
    tau[:, ::997] = 1e-13
    zhat = g.standard_normal((k, m)) / np.sqrt(m)
    ncol = np.abs(g.standard_normal((k, m))) + 0.5
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    return t(poles), t(poles), t(tau), t(zhat), t(1.0 / ncol)


def check_cauchy_matmul(k, m, C, kact, reps):
    """Fused Cauchy product at a downsweep level's shape, ``kact`` active
    slots per merge (ncolinv zero past them, as the driver gives it)."""
    g = np.random.default_rng(4)
    poles, shift, tau, zhat, ninv = _merge_data(g, k, m)
    ninv[:, kact:] = 0.0
    K = torch.full((k,), kact, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    X = torch.randn((k, m, C), dtype=torch.float32, device="cuda",
                    generator=gen)
    args = (poles, shift, tau, zhat, ninv, X, K)
    got = cm.cauchy_matmul(*args)
    ref = cm.cauchy_matmul_plain(*args)
    # per entry, the scale of an f32 sum in another order: |M| @ |X|
    Mf = torch.where(torch.arange(m, device="cuda")[None, None, :]
                     < K[:, None, None],
                     cm._cauchy_block(poles, shift, tau, zhat, ninv),
                     torch.zeros((), device="cuda"))
    scale = torch.bmm(Mf.abs(), X.abs())
    diff = (got - ref).abs()
    err = float((diff / torch.clamp(scale, min=1e-30)).max())
    abs_err = float(diff.max())
    del scale, diff
    # the deflation skip is exact: the same call over all m slots agrees
    full = cm.cauchy_matmul(poles, shift, tau, zhat, ninv, X,
                            torch.full_like(K, m))
    fin = torch.isfinite(full)
    skip_exact = bool(torch.equal(got[fin], full[fin]))
    del full, fin
    ms = time_ms(lambda: cm.cauchy_matmul(*args), reps)
    plain = time_ms(lambda: cm.cauchy_matmul_plain(*args), max(1, reps // 2))
    library = time_ms(lambda: torch.bmm(Mf, X), reps)
    ops = 2.0 * k * kact * m * C
    nbytes = 8.0 * 5 * k * m + 4.0 * k * kact * C + 4.0 * k * m * C
    b_ms, b_by = bound(ops, PEAK_FP32, nbytes)
    return dict(k=k, m=m, C=C, K=kact, max_rel_err=err, tol=1e-5,
                tol_of="|M|@|X| per entry", skip_bit_exact=skip_exact,
                max_abs_err=abs_err, ms=ms, plain_ms=plain,
                library_ms=library, library_is="torch.bmm of the pre-built "
                "f32 M with X (the product alone)",
                bound_ms=b_ms, bound_by=b_by)


def check_cauchy_materialize(m, C, kact, reps):
    """The root U[:, sel] at the main path's root shape: C selected slots,
    ``kact`` of the m slots active."""
    g = np.random.default_rng(6)
    poles, _shift, tau, zhat, ninv = _merge_data(g, 1, m)
    slots = torch.as_tensor(g.permutation(m)[:C][None], device="cuda")
    shift_idx = torch.as_tensor(g.integers(0, m, (1, m)), device="cuda")
    K = torch.tensor([kact], dtype=torch.int64, device="cuda")
    act = slots < K[:, None]
    args = (poles, zhat, poles.gather(1, shift_idx.gather(1, slots)),
            tau.gather(1, slots),
            torch.where(act, ninv.gather(1, slots), 0.0), slots, K)
    got = cm.cauchy_materialize(*args)
    ref = cm.cauchy_materialize_plain(*args)
    a = act[:, None, :].expand_as(got)
    diff = (got - ref).abs()
    err = float((diff[a] / ref[a].abs().clamp(min=1e-38)).max())
    eye_exact = bool(torch.equal(got[~a], ref[~a]))
    abs_err = float(diff.max())
    del diff, a
    ms = time_ms(lambda: cm.cauchy_materialize(*args), reps)
    plain = time_ms(lambda: cm.cauchy_materialize_plain(*args), reps)
    nact = int(act.sum())
    nbytes = 4.0 * m * C + 8.0 * (2 * m + 4 * C)
    b_ms, b_by = bound(1.0 * m * nact, PEAK_FP64, nbytes)
    return dict(m=m, C=C, K=kact, max_rel_err=err, tol=2.0 ** -22,
                tol_of="|entry|, active entries", identity_exact=eye_exact,
                max_abs_err=abs_err, ms=ms, plain_ms=plain,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


@contextlib.contextmanager
def plain_spike_passes():
    """spike_refine composed from the plain passes (on the card)."""
    a, b = sp.spike_pass_a, sp.spike_pass_b
    sp.spike_pass_a, sp.spike_pass_b = sp.spike_pass_a_plain, \
        sp.spike_pass_b_plain
    try:
        yield
    finally:
        sp.spike_pass_a, sp.spike_pass_b = a, b


def _col_rel(got, ref):
    """max over columns of max|got - ref| / max|ref| (per column)."""
    scale = ref.abs().amax(dim=tuple(range(ref.ndim - 1))).clamp(min=1e-300)
    d = (got - ref).abs().amax(dim=tuple(range(ref.ndim - 1)))
    return float((d / scale).max()), float(d.max())


def check_spike(d, e, lam_all, nb, K, shifts, reps):
    """Pass A and pass B against their plain versions at the main path's
    refinement shape (the prescaled system, one chunk of K columns of f32
    right-hand sides), and the normalized spike_refine result."""
    g = np.random.default_rng(7 if shifts == "random" else 8)
    n = d.shape[0]
    if shifts == "random":
        lo, hi = float(lam_all.min()), float(lam_all.max())
        lam = torch.as_tensor(np.sort(g.uniform(lo, hi, K)), device="cuda")
    else:
        pick = np.sort(g.choice(n, K, replace=False))
        lam = torch.as_tensor(lam_all[pick], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    V = torch.randn((n, K), dtype=torch.float32, device="cuda", generator=gen)
    V /= torch.linalg.vector_norm(V, dim=0, keepdim=True)
    db, e_all, e_cross, ec_above, tiny = band_prep(d, e, nb)
    P = db.shape[0] // nb
    bnd = sp.spike_pass_a(db, e_all, tiny, lam, V, nb)
    bnd_p = sp.spike_pass_a_plain(db, e_all, tiny, lam, V, nb)
    err_a, abs_a = _col_rel(bnd.permute(0, 1, 2).reshape(6 * P, K),
                            bnd_p.reshape(6 * P, K))
    La, Fb = sp._interface(bnd_p, e_cross, ec_above)
    bargs = (db, e_all, tiny, lam, V, nb, La, Fb, ec_above, e_cross)
    X, mx = sp.spike_pass_b(*bargs)
    X_p, mx_p = sp.spike_pass_b_plain(*bargs)
    err_b, abs_b = _col_rel(X, X_p)
    err_mx = float(((mx - mx_p).abs() / mx_p.abs().clamp(min=1e-300)).max())
    Xr, res = sp.spike_refine(d, e, lam, V, nb=nb, chunk=K)
    with plain_spike_passes():
        Xr_p, res_p = sp.spike_refine(d, e, lam, V, nb=nb, chunk=K)
    err_r, abs_r = _col_rel(Xr, Xr_p)
    err_res = float(((res - res_p).abs() / res_p.abs()).max())
    ms_a = time_ms(lambda: sp.spike_pass_a(db, e_all, tiny, lam, V, nb), reps)
    plain_a = time_ms(lambda: sp.spike_pass_a_plain(db, e_all, tiny, lam, V,
                                                    nb), 2)
    ms_b = time_ms(lambda: sp.spike_pass_b(*bargs), reps)
    plain_b = time_ms(lambda: sp.spike_pass_b_plain(*bargs), 2)
    npad = db.shape[0]
    # FP64 operations per (row, column): forward 4 + 2 per rhs, back 5 per
    # rhs (a division counts one); the fold adds 2 per boundary row in B
    ops_a = float(npad) * K * (4 + 2 * 3 + 5 * 3)
    ops_b = float(npad) * K * (4 + 2 + 5) + 4.0 * P * K
    in_bytes = 4.0 * n * K + 8.0 * (2 * npad + K + 1)
    ba = bound(ops_a, PEAK_FP64, in_bytes + 8.0 * 6 * P * K)
    bb = bound(ops_b, PEAK_FP64, in_bytes + 8.0 * (4 * P + 2 * P * K)
               + 8.0 * (npad * K + P * K))
    common = dict(n=n, nb=nb, K=K, shifts=shifts, tol=1e-12,
                  tol_of="column max |x|", refine_rel_err=err_r,
                  refine_abs_err=abs_r, res_est_rel_err=err_res,
                  clipped_columns=int((res >= 1e29).sum()))
    require(err_res <= 1e-10, f"spike_refine estimates disagree ({shifts}): "
            f"{err_res}")
    return (dict(common, pass_="A", max_rel_err=err_a, max_abs_err=abs_a,
                 ms=ms_a, plain_ms=plain_a, library_ms=None,
                 bound_ms=ba[0], bound_by=ba[1]),
            dict(common, pass_="B", max_rel_err=max(err_b, err_mx, err_r),
                 max_abs_err=abs_b, ms=ms_b, plain_ms=plain_b,
                 library_ms=None, bound_ms=bb[0], bound_by=bb[1]))


# --------------------------------------------------------------------------
# the main path

def solve_and_check(d, e, cfg, ref, norm_ref):
    """One solve_tridiagonal_staged call with eigenvectors; returns its
    JSON fields after checking residual, orthogonality and eigenvalues."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                             compute_vectors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = launch_counts()
    lam = res.eigenvalues.cpu().numpy()
    V = res.eigenvectors
    n = lam.shape[0]
    require(V.shape == (n, n) and V.dtype == torch.float64
            and bool(torch.isfinite(V).all()) and np.isfinite(lam).all(),
            "non-finite or misshapen result")
    resid = float(st.residuals(d, e, res).max()) / norm_ref
    ortho = max_ortho_error(V)
    lam_err = float(np.abs(lam - ref).max()) / norm_ref
    del res, V
    torch.cuda.empty_cache()
    out = {"wall_s": wall, "phases_s": timer.times, "counts": timer.counts,
           "peak_mem_bytes": peak, "residual_over_normT": resid,
           "ortho": ortho, "eig_err_vs_ref_over_normT": lam_err,
           "launches": counts}
    require(resid <= 1e-12, f"residual {resid} > 1e-12 ||T||")
    require(ortho <= 1e-10, f"orthogonality {ortho} > 1e-10")
    require(lam_err <= 1e-12, f"eigenvalues off the reference by {lam_err} "
            "||T||")
    return out


def warm_walls(d, e, cfg, reps: int = 3):
    """Walls of ``reps`` warm solves (host clock, synchronized) and the
    phases of the median one: the host-bound parts of a solve vary from
    machine to machine, so one wall alone says little."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                 compute_vectors=True)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, timer.times))
        del res
        torch.cuda.empty_cache()
    walls = [w for w, _ in runs]
    return walls, sorted(runs, key=lambda r: r[0])[reps // 2][1]


RANGES = ("spike.interface_solve", "refine.triage")


def _launches_under(ev) -> int:
    """Kernels launched by a profiler event and everything it called."""
    return len(ev.kernels) + sum(_launches_under(c) for c in ev.cpu_children)


def profile_main_path(d, e, cfg, top: int = 16):
    """Device time by kernel over one main-path solve (torch.profiler), the
    device's busy time and idle share of the wall, and for the interface
    solve's and the triage's ranges their host wall, device span and kernel
    launches."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st.solve_tridiagonal_staged(d, e, config=cfg, compute_vectors=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ranges = {name: {"calls": 0, "launches": 0} for name in RANGES}
    for ev in prof.events():
        if ev.name in ranges and ev.device_type != DeviceType.CUDA:
            ranges[ev.name]["calls"] += 1
            ranges[ev.name]["launches"] += _launches_under(ev)
    rows = []
    for ev in prof.key_averages():
        if ev.key in ranges:
            # the range's host wall, and its span on the device timeline
            # (gaps included): neither is kernel time
            if ev.device_type == DeviceType.CUDA:
                ranges[ev.key]["device_span_s"] = ev.device_time_total * 1e-6
            else:
                ranges[ev.key]["host_s"] = ev.cpu_time_total * 1e-6
                ranges[ev.key]["share_of_wall"] = \
                    ev.cpu_time_total * 1e-6 / wall
            continue
        # device-side events only (kernels, copies): the CPU-side operator
        # rows repeat their kernels' time
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) * 1e-6
    launches = sum(r[1] for r in rows)
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "device_events": launches, "ranges": ranges,
            "top": [{"name": k[:90], "device_s": us * 1e-6, "calls": c}
                    for us, c, k in rows[:top]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
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
              name: [ln.strip() for ln in rep.splitlines()
                     if "Used" in ln or "spill" in ln]
              for name, rep in reports.items()}})

    # the main path's input, its prescaled system and a reference spectrum
    d, e = random_matrix(N, SEED)
    ref = scipy.linalg.eigvalsh_tridiagonal(d, e)
    norm_ref = float(np.abs(ref).max())
    dt, et = (torch.as_tensor(a, device="cuda") for a in (d, e))
    ds, es, snorm = _prescale(dt, et)
    lam_scaled = ref / float(snorm)

    # 3. each kernel against its plain version at the main path's shapes:
    # secular_sums at the root level (k=1, all m roots) and the bottom level
    # (k=256 merges of m=64); cauchy_rowsum at the widest non-root level;
    # dword_matmul at the m=8192 level's f64 GEMM; cauchy_matmul at the
    # m=8192 level (all slots active, and 1/8 of them: the deflation skip)
    # and the bottom level (k=256, m=64) with a full vec_chunk of 8192
    # columns; cauchy_materialize at the root (m=16384, 8192 columns); the
    # Spike passes at one refinement chunk (n=16384, nb=128, K=2048)
    checks = {
        "secular_sums": [check_secular_sums(1, N, 10),
                         check_secular_sums(256, 64, 50)],
        "cauchy_rowsum": [check_cauchy_rowsum(2, 8192, 20)],
        "dword_matmul": [check_dword_matmul(2, 2048, 8192, 8192, 5)],
        "cauchy_matmul": [check_cauchy_matmul(2, 8192, 8192, 8192, 3),
                          check_cauchy_matmul(2, 8192, 8192, 1024, 5),
                          check_cauchy_matmul(256, 64, 8192, 64, 10)],
        "cauchy_materialize": [check_cauchy_materialize(N, 8192, 12000, 10)],
    }
    spike_rand = check_spike(ds, es, lam_scaled, 128, 2048, "random", 5)
    spike_eig = check_spike(ds, es, lam_scaled, 128, 2048, "eigenvalues", 5)
    checks["spike_pass_a"] = [spike_rand[0], spike_eig[0]]
    checks["spike_pass_b"] = [spike_rand[1], spike_eig[1]]
    for name, rows in checks.items():
        for row in rows:
            emit({"phase": "kernel_check", "kernel": name, **row})
            require(row["max_rel_err"] <= row["tol"],
                    f"{name} disagrees with its plain version: {row}")
            require(row.get("skip_bit_exact", True),
                    f"{name}: the deflation skip changed the result: {row}")
            require(row.get("identity_exact", True),
                    f"{name}: identity columns not exact: {row}")
            if "refine_rel_err" in row:
                require(row["refine_rel_err"] <= row["tol"],
                        f"{name}: spike_refine disagrees: {row}")
    del ds, es

    # 4. the main path: default (mixed) config, all eigenpairs, cold
    cfg = st.SolverConfig()
    reset_counts()
    solve = solve_and_check(d, e, cfg, ref, norm_ref)
    launches = solve["launches"]
    walls, phases = warm_walls(d, e, cfg)
    emit({"phase": "solve", "n": N, "matrix": "random", "seed": SEED,
          "config": "SolverConfig() (mixed_precision_vectors=True)",
          **solve, "warm_walls_s": walls, "warm_median_phases_s": phases})
    for name in ("cauchy_matmul", "cauchy_materialize", "spike_pass_a",
                 "spike_pass_b", "secular_sums", "cauchy_rowsum"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the main path")

    # 5. the pure-f64 path on the same input
    cfg64 = st.SolverConfig(mixed_precision_vectors=False)
    reset_counts()
    s64 = solve_and_check(d, e, cfg64, ref, norm_ref)
    walls64, phases64 = warm_walls(d, e, cfg64)
    emit({"phase": "solve_f64", "n": N, "matrix": "random", "seed": SEED,
          "config": "mixed_precision_vectors=False", **s64,
          "warm_walls_s": walls64, "warm_median_phases_s": phases64})
    require(s64["launches"]["dword_matmul"] > 0,
            "dword_matmul was not launched on the f64 path")

    # 6. deflation-heavy: Poisson against its analytic spectrum
    dp, ep = st.create_matrix_scheme2(N)
    exact = st.eigenvalues_of_scheme2(N)
    norm_p = float(np.abs(exact).max())
    t0 = time.perf_counter()
    lam_p = st.eigh_tridiagonal(dp, ep, config=cfg64, eigvals_only=True)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    p_err = float(np.abs(lam_p.cpu().numpy() - exact).max()) / norm_p
    require(p_err <= 1e-12, f"Poisson eigenvalues off by {p_err} ||T||")
    reset_counts()
    pfull = solve_and_check(dp, ep, cfg, exact, norm_p)
    emit({"phase": "poisson", "n": N, "eigvals_only_wall_s": wall_p,
          "eigvals_only_err_vs_analytic_over_normT": p_err,
          "full_mixed": pfull})

    # 7. where the main path's device time goes (one more run, profiled)
    emit({"phase": "profile", **profile_main_path(d, e, cfg)})

    # 8. summary; launches from the main path's run, except dword_matmul,
    # whose path is the pure-f64 one (on the mixed path it serves only the
    # wide cluster-orth Grams)
    kernels = []
    for name, rows in checks.items():
        row = rows[0]
        path = "solve_f64" if name == "dword_matmul" else "solve"
        count = s64["launches"][name] if path == "solve_f64" \
            else launches[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "symmetric_eigenvalue_tpu_torch/csrc/"
                      f"{SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name], "launches": count,
            "launches_on": path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
