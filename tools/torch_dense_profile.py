#!/usr/bin/env python3
"""Time and profile the PyTorch port's dense front ends on one GPU.

``eigh`` of chip_smoke.py's dense input (A = (G + G^T) / (2 sqrt n), G
standard normal from a seeded generator on the card, n=16384, seed 0),
default config, all eigenpairs: one cold solve with its residual,
orthogonality and eigenvalue error against ``torch.linalg.eigvalsh``, then
two warm solves, each with its wall, phases (``dense.tridiagonalize``,
``dense.apply_q``, ...), peak device memory and the kernels' launch
counters; then
``tridiagonalize`` alone under torch.profiler, at n and at n=4096 (device
events a column, busy time, idle share of its wall, and device time by
kernel: the column step's kernels and the matvec each a column), and
``eigh(band=128)`` at n=4096 (its phases).  Prints one JSON line per
measurement.

With ``--two-stage`` it runs the two-stage and banded front ends alone, at
``--n`` (default 4096 there) on chip_smoke.py's two-stage input (seed + 1):
``eigh(A, band=128)`` and ``eigh_banded`` of A's band u=16, each cold with
its checks, then twice warm, each line with its wall, phases
(``dense.reduce_to_band``, ``dense.band_to_tridiag``, ``dense.apply_q2``,
...), peak memory and launches.  With ``--apply-q`` it times the
one-stage reflector backtransform alone: ``apply_q`` of ``tridiagonalize``'s
reflectors (panel 32) on an n x n X at ``--n`` (default 4096), ``--reps``
warm calls each on the host's clock with a sync, then one call under
torch.profiler (device busy time, idle share, ``larft``'s device time and
launches).  Every line carries the card's name and its power limit
(nvidia-smi).

It imports the package from the tree it sits in, so a copy placed in
another checkout's ``tools/`` (an older commit unpacked by ``git archive``)
measures that checkout (counters that tree lacks read null):

    python3 tools/torch_dense_profile.py --tag change
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import symmetric_eigenvalue_tpu_torch as st  # noqa: E402
from symmetric_eigenvalue_tpu_torch.kernels import (  # noqa: E402
    band_reduce as br, dword_matmul as dm, dword_matvec as dv,
    tridiagonalize as tri)
from symmetric_eigenvalue_tpu_torch.utils.checks import (  # noqa: E402
    max_ortho_error)
from symmetric_eigenvalue_tpu_torch.utils.timing import (  # noqa: E402
    PhaseTimer)

try:
    from symmetric_eigenvalue_tpu_torch.kernels import (  # noqa: E402
        householder_panel as hp)
except ImportError:          # a tree from before the column step's kernels
    hp = None

COUNTERS = (("dword_vecmat", dv, "launches"), ("dword_matmul", dm, "launches"),
            ("column_reflector", hp, "reflector_launches"),
            ("column_w", hp, "w_launches"),
            ("column_w_reflector", hp, "w_reflector_launches"),
            ("larft", hp, "larft_launches"),
            ("band_chase", br, "chase_launches"),
            ("panel_qr", br, "panel_qr_launches"),
            ("q2_blocks_t", br, "q2_blocks_t_launches"),
            ("q2_apply", br, "q2_apply_launches"))
# the column step's kernels in any tree: one cooperative kernel, or the
# arrival-counter pair of the tree before it
COLUMN_KERNELS = ("column_step_kernel", "column_reflector_kernel",
                  "column_w_kernel")


def dense_matrix(n: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((n, n), dtype=torch.float64, device="cuda", generator=g)
    return (G + G.T).div_(2.0 * n ** 0.5)


def counts():
    return {name: getattr(mod, attr, None) for name, mod, attr in COUNTERS}


def reset():
    for _, mod, attr in COUNTERS:
        if mod is not None and hasattr(mod, attr):
            setattr(mod, attr, 0)


def timed_eigh(A, solver=None, **kw):
    timer = PhaseTimer()
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = (solver or st.eigh)(A, timer=timer, **kw)
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t0,
                 "phases_s": dict(timer.times), "launches": counts(),
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def checks(A, lam, V, ref, chunk: int = 2048):
    norm = float(ref.abs().max())
    worst = 0.0
    for o in range(0, A.shape[0], chunk):
        R = torch.matmul(A, V[:, o:o + chunk]) - V[:, o:o + chunk] \
            * lam[o:o + chunk]
        worst = max(worst, float(R.abs().max()))
    return {"residual_over_normA": worst / norm, "ortho": max_ortho_error(V),
            "eig_err_vs_eigvalsh_over_normA":
                float((lam - ref).abs().max()) / norm}


def profiled(fn, n: int, keep=()):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, events, by_kernel = 0.0, 0, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            busy += ev.self_device_time_total * 1e-6
            events += ev.count
            by_kernel[ev.key[:90]] = {"device_s":
                                      ev.self_device_time_total * 1e-6,
                                      "calls": ev.count}
    column = sum(v["device_s"] for k, v in by_kernel.items()
                 if any(name in k for name in COLUMN_KERNELS))
    vecmat = sum(v["device_s"] for k, v in by_kernel.items()
                 if "vecmat" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1]["device_s"])[:8]
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "device_events": events, "device_events_per_column":
                events / (n - 1),
            "column_step_device_ms_per_column": 1e3 * column / (n - 1),
            "vecmat_device_ms_per_column": 1e3 * vecmat / (n - 1),
            "top_kernels": dict(top),
            "kept_kernels": {k: v for k, v in by_kernel.items()
                             if any(name in k for name in keep)}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a label for the output lines")
    ap.add_argument("--n", type=int, default=None,
                    help="16384 (4096 with --two-stage)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--two-stage", action="store_true",
                    help="the two-stage and banded front ends alone")
    ap.add_argument("--apply-q", action="store_true",
                    help="the one-stage apply_q alone")
    ap.add_argument("--reps", type=int, default=10,
                    help="warm calls of --apply-q")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dense_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = {"card": torch.cuda.get_device_name(0),
           "nvidia_smi": smi.splitlines()[0] if smi else None,
           "tag": args.tag}
    if args.two_stage:
        return two_stage(args.n or 4096, args.seed + 1, dev)
    if args.apply_q:
        return apply_q_alone(args.n or 4096, args.seed + 1, args.reps, dev)
    args.n = args.n or 16384
    A = dense_matrix(args.n, args.seed)
    ref = torch.linalg.eigvalsh(A)
    (lam, V), cold = timed_eigh(A)
    print(json.dumps({**dev, "what": f"eigh n={args.n} cold", **cold,
                      **checks(A, lam, V, ref)}), flush=True)
    del lam, V
    torch.cuda.empty_cache()
    for rep in range(2):
        _, warm = timed_eigh(A)
        print(json.dumps({**dev, "what": f"eigh n={args.n} warm {rep}",
                          **warm}), flush=True)
        torch.cuda.empty_cache()
    reset()
    buckets = 4 if args.n >= 8192 else 1       # driver._bucket_count
    prof = profiled(lambda: tri.tridiagonalize(A, buckets=buckets), args.n)
    print(json.dumps({**dev, "what": f"tridiagonalize n={args.n} profiled",
                      **prof, "launches": counts()}), flush=True)
    del A, ref
    torch.cuda.empty_cache()
    A2 = dense_matrix(4096, args.seed + 1)
    tri.tridiagonalize(A2)                      # warm-up
    reset()
    prof = profiled(lambda: tri.tridiagonalize(A2), 4096)
    print(json.dumps({**dev, "what": "tridiagonalize n=4096 profiled",
                      **prof, "launches": counts()}), flush=True)
    _, two = timed_eigh(A2, band=128)
    print(json.dumps({**dev, "what": "eigh(band=128) n=4096", **two}),
          flush=True)
    return 0


def apply_q_alone(n: int, seed: int, reps: int, dev) -> int:
    """The one-stage apply_q at n: warm walls, then one profiled call."""
    A = dense_matrix(n, seed)
    _, _, Yt, taus = tri.tridiagonalize(A)
    X = dense_matrix(n, seed + 1)
    tri.apply_q(Yt, taus, X, panel=32)          # warm-up
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tri.apply_q(Yt, taus, X, panel=32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    reset()
    prof = profiled(lambda: tri.apply_q(Yt, taus, X, panel=32), n,
                    keep=("larft",))
    larft = prof["kept_kernels"]
    print(json.dumps({**dev, "what": f"apply_q n={n} panel 32",
                      "walls_s": walls, "profiled_wall_s": prof["wall_s"],
                      "device_busy_s": prof["device_busy_s"],
                      "idle_share": prof["idle_share"],
                      "device_events": prof["device_events"],
                      "larft": larft, "top_kernels": prof["top_kernels"],
                      "launches": counts()}), flush=True)
    return 0


def two_stage(n: int, seed: int, dev) -> int:
    """eigh(band=128) and eigh_banded (u=16) at n: cold with checks, then
    twice warm."""
    A = dense_matrix(n, seed)
    idx = torch.arange(n, device="cuda")
    Ab = torch.where((idx[:, None] - idx[None, :]).abs() <= 16, A, 0.0)
    ab = torch.zeros((17, n), dtype=torch.float64)
    for k in range(17):                         # scipy's upper band storage
        ab[16 - k, k:] = torch.diagonal(Ab, offset=k).cpu()
    for what, M, run in (
            ("eigh(band=128)", A, lambda tm: st.eigh(A, band=128, timer=tm)),
            ("eigh_banded(u=16)", Ab,
             lambda tm: st.eigh_banded(ab.numpy(), timer=tm))):
        ref = torch.linalg.eigvalsh(M)
        for rep in ("cold", "warm 0", "warm 1"):
            (lam, V), line = timed_eigh(None, solver=lambda _, timer: run(
                timer))
            if rep == "cold":
                line.update(checks(M, lam, V, ref))
            print(json.dumps({**dev, "what": f"{what} n={n} {rep}", **line}),
                  flush=True)
            del lam, V
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
