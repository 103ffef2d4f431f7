#!/usr/bin/env python3
"""Time and profile the PyTorch port's tridiagonal solves on one GPU.

For the default (mixed-precision) and the pure-f64 config on bench.py's
random input (n=16384, seed 0), and the default config on the Poisson
matrix (a spectrum that deflates slowly): one cold solve (its residual,
orthogonality and the triage's column counts), three warm walls
with their phases, the host syncs of one warm solve (torch.cuda's sync
debug mode counts them), and one warm solve under torch.profiler: device
events, busy time and idle share, the Spike passes' device time and share
of it, the block LU's and the interface solve's (kernels or, in a tree
that predates them, their loops' launches under the ranges),
cauchy_rowsum's device time, and the host time, calls and kernel launches
of the named ranges; the peak device memory of the warm solves.  Prints
one JSON line per solve.

It imports the package from the tree it sits in, so a copy placed in
another checkout's ``tools/`` (an older commit unpacked by ``git archive``)
measures that checkout:

    python3 tools/torch_solve_profile.py --tag change
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import symmetric_eigenvalue_tpu_torch as st  # noqa: E402
from symmetric_eigenvalue_tpu_torch.utils.checks import (  # noqa: E402
    max_ortho_error)

RANGES = ("secular.solve_roots", "spike.interface_solve", "refine.triage")


def solve(d, e, cfg):
    return st.solve_tridiagonal_staged(d, e, config=cfg, compute_vectors=True)


def host_syncs(d, e, cfg) -> int:
    """Synchronizing CUDA calls of one solve (each one warns in sync debug
    mode)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve(d, e, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def _launches_under(ev) -> int:
    """Kernels launched by a profiler event and everything it called."""
    return len(ev.kernels) + sum(_launches_under(c) for c in ev.cpu_children)


def profiled(d, e, cfg):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, timer = solve(d, e, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, events, ranges, spike = 0.0, 0, {}, {}
    rowsum = {"device_s": 0.0, "calls": 0}
    iface = {"device_s": 0.0, "calls": 0}
    for ev in prof.key_averages():
        if ev.key in RANGES:
            if ev.device_type != DeviceType.CUDA:
                ranges[ev.key] = {"host_s": ev.cpu_time_total * 1e-6,
                                  "calls": ev.count, "launches": 0}
            continue
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            busy += ev.self_device_time_total * 1e-6
            events += ev.count
            if "spike_kernel<" in ev.key:
                # spike_kernel<true, double, true> is the blocked solver's
                # block LU, <true, ...> pass A, <false, ...> pass B
                which = ("L" if "spike_kernel<true, double, true>" in ev.key
                         else "A" if "spike_kernel<true" in ev.key else "B")
                row = spike.setdefault(which, {"device_s": 0.0, "calls": 0})
                row["device_s"] += ev.self_device_time_total * 1e-6
                row["calls"] += ev.count
            if "cauchy_rowsum_kernel" in ev.key:
                rowsum["device_s"] += ev.self_device_time_total * 1e-6
                rowsum["calls"] += ev.count
            if "interface_kernel" in ev.key:
                iface["device_s"] += ev.self_device_time_total * 1e-6
                iface["calls"] += ev.count
    for ev in prof.events():
        if ev.name in ranges and ev.device_type != DeviceType.CUDA:
            ranges[ev.name]["launches"] += _launches_under(ev)
    spike_s = sum(r["device_s"] for k, r in spike.items() if k != "L")
    return {"wall_s": wall, "phases_s": timer.times, "device_busy_s": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "device_events": events, "ranges": ranges,
            "spike_passes": spike, "spike_device_s": spike_s,
            "spike_share_of_busy": spike_s / busy if busy else None,
            "interface_solve": iface, "cauchy_rowsum": rowsum}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a label for the output lines")
    ap.add_argument("--n", type=int, default=16384)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_solve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    rng = np.random.default_rng(0)          # bench.py's random input
    random = (rng.standard_normal(args.n) * 5.0,
              rng.standard_normal(args.n - 1) * 2.0)
    for name, cfg, (d, e) in (
            ("mixed", st.SolverConfig(), random),
            ("f64", st.SolverConfig(mixed_precision_vectors=False), random),
            ("poisson_mixed", st.SolverConfig(),
             st.create_matrix_scheme2(args.n))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, cold_timer = solve(d, e, cfg)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        resid = float(st.residuals(d, e, res).max())
        ortho = max_ortho_error(res.eigenvectors)
        del res
        warm = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, timer = solve(d, e, cfg)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0, timer.times))
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        print(json.dumps({
            "tag": args.tag, "config": name, "n": args.n,
            "card": smi[0] if smi else None, "cold_wall_s": cold,
            "residual_max": resid, "ortho": ortho,
            "triage_counts": cold_timer.counts,
            "warm_walls_s": [w for w, _ in warm],
            "warm_phases_s": [p for _, p in warm],
            "warm_peak_mem_bytes": peak,
            "host_syncs": host_syncs(d, e, cfg),
            "profile": profiled(d, e, cfg)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
