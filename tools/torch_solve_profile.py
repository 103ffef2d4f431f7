#!/usr/bin/env python3
"""Time and profile the PyTorch port's tridiagonal solves on one GPU.

For the default (mixed-precision) and the pure-f64 config on bench.py's
random input (n=16384, seed 0), and the default config on the Poisson
matrix (a spectrum that deflates slowly): one cold solve (its residual,
orthogonality, the triage's column counts and the bit patterns' sums of
lambda and V), three warm walls
with their phases, the host syncs of one warm solve (torch.cuda's sync
debug mode counts them), and one warm solve under torch.profiler: device
events, busy time and idle share, the Spike passes' device time and share
of it, the block LU's and the interface solve's (kernels or, in a tree
that predates them, their loops' launches under the ranges),
cauchy_rowsum's device time, and the host time, calls and kernel launches
of the named ranges; the peak device memory of the warm solves.  Then
eigh_tridiagonal(eigvals_only=True) on the Poisson matrix: cold and three
warm walls, host syncs, profile.  Prints one JSON line per solve.

The eigenvalue phase is split by the step of a level (``steps``): tear and
leaves (``tear``, ``leaf_blocks``, the sentinels and the leaf eigensolve),
``merge_partition``, the root setup with ``secular_solve``
(``_solve_roots``), the Gu-Eisenstat z and the column norms, and
``rows_through_merge``, each summed over the levels, and ``other`` (the
rest of ``_upsweep``): its host time in one more warm solve, its host
syncs, and, in the profiled solve, its device span (a ``step.<name>``
record_function range this script opens around the step).  The script
wraps the package's functions by name, so it splits any tree that has
them.

It imports the package from the tree it sits in, so a copy placed in
another checkout's ``tools/`` (an older commit unpacked by ``git archive``)
measures that checkout:

    python3 tools/torch_solve_profile.py --tag change

``--warm N`` takes N warm solves a config (3 by default) and ``--configs``
a subset of them (``mixed,poisson_eigvals_only`` for the walls alone): the
card's host is noisy, so compare trees over many runs in turns.
"""

from __future__ import annotations

import argparse
import contextlib
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
from symmetric_eigenvalue_tpu_torch import driver  # noqa: E402
from symmetric_eigenvalue_tpu_torch.kernels import secular  # noqa: E402
from symmetric_eigenvalue_tpu_torch.utils.checks import (  # noqa: E402
    max_ortho_error)

CONFIGS = ("mixed", "f64", "poisson_mixed", "poisson_eigvals_only")
RANGES = ("secular.solve_roots", "spike.interface_solve", "refine.triage",
          "upsweep.tear_leaves", "merge.partition", "merge.z_colnorm",
          "merge.rows_through_merge")
# the package's ranges inside (or around) a step: the device timeline
# credits a kernel to the innermost range only
STEP_RANGES = {"upsweep.tear_leaves": "tear_leaves",
               "merge.partition": "merge_partition",
               "secular.solve_roots": "solve_roots",
               "merge.z_colnorm": "z_colnorm",
               "merge.rows_through_merge": "rows_through_merge"}
# the eigenvalue phase's steps: (module, function, step)
STEP_SITES = ((driver, "tear", "tear_leaves"),
              (driver, "leaf_blocks", "tear_leaves"),
              (driver, "_sentinels", "tear_leaves"),
              (secular, "merge_partition", "merge_partition"),
              (secular, "_solve_roots", "solve_roots"),
              (secular, "_gu_eisenstat_z", "z_colnorm"),
              (secular, "map_slot_blocks", "z_colnorm"),
              (driver, "rows_through_merge", "rows_through_merge"))
STEPS = ("tear_leaves", "merge_partition", "solve_roots", "z_colnorm",
         "rows_through_merge", "other")


def bits_sum(x) -> int:
    """The sum of a float64 tensor's bit patterns as int64 (wrapping): the
    same for two runs exactly when their bits agree, as far as a checksum
    can say, without copying the tensor to the host."""
    return int(x.contiguous().view(torch.int64).sum())


def solve(d, e, cfg, vectors=True):
    return st.solve_tridiagonal_staged(d, e, config=cfg,
                                       compute_vectors=vectors)


class StepSplit:
    """The eigenvalue phase's steps seen so far: each step's host time and
    calls (``stats``, summed over the levels) and the steps running now."""

    def __init__(self):
        self.stats = {name: {"host_s": 0.0, "calls": 0} for name in STEPS}
        self.stack = []

    def now(self) -> str:
        """The step running now: ``other`` in the rest of ``_upsweep``,
        ``outside`` past it."""
        if not self.stack:
            return "outside"
        return "other" if self.stack[-1] == "eigenvalues" else self.stack[-1]


@contextlib.contextmanager
def step_split():
    """The eigenvalue phase's steps timed and named inside the block (a
    ``step.<name>`` range around each for the profiler); yields the
    :class:`StepSplit`."""
    split = StepSplit()
    stack = split.stack

    def wrap(fn, step):
        def run(*args, **kwargs):
            if stack != (["eigenvalues"] if step != "eigenvalues" else []):
                return fn(*args, **kwargs)       # nested, or past the phase
            stack.append(step)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(f"step.{step}"):
                    return fn(*args, **kwargs)
            finally:
                stack.pop()
                if step != "eigenvalues":
                    split.stats[step]["host_s"] += time.perf_counter() - t0
                    split.stats[step]["calls"] += 1
        return run

    def leaf_eigh_fn(*args, **kwargs):
        return wrap(inner_leaf(*args, **kwargs), "tear_leaves")

    inner_leaf, inner_upsweep = driver.leaf_eigh_fn, driver._upsweep
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in STEP_SITES]
    for mod, name, step in STEP_SITES:
        setattr(mod, name, wrap(getattr(mod, name), step))
    driver.leaf_eigh_fn = leaf_eigh_fn
    driver._upsweep = wrap(inner_upsweep, "eigenvalues")
    try:
        yield split
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        driver.leaf_eigh_fn, driver._upsweep = inner_leaf, inner_upsweep


def host_syncs(d, e, cfg, vectors=True):
    """Synchronizing CUDA calls of one solve (each one warns in sync debug
    mode), in all and by the eigenvalue phase's step (``outside``: the
    rest of the solve)."""
    by_step = {name: 0 for name in STEPS + ("outside",)}
    torch.cuda.synchronize()
    with step_split() as split, warnings.catch_warnings():
        def seen(message, *args, **kwargs):
            if "synchroniz" in str(message):
                by_step[split.now()] += 1

        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solve(d, e, cfg, vectors)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(by_step.values()), by_step


def step_host_times(d, e, cfg, vectors=True):
    """Host time and calls of each step over one more warm solve."""
    torch.cuda.synchronize()
    with step_split() as split:
        t0 = time.perf_counter()
        _, timer = solve(d, e, cfg, vectors)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = split.stats
    eig = timer.times.get("eigenvalues", 0.0)
    stats["other"]["host_s"] = eig - sum(
        v["host_s"] for k, v in stats.items() if k != "other")
    return {"wall_s": wall, "eigenvalues_s": eig, "steps": stats}


def _launches_under(ev) -> int:
    """Kernels launched by a profiler event and everything it called."""
    return len(ev.kernels) + sum(_launches_under(c) for c in ev.cpu_children)


def profiled(d, e, cfg, vectors=True):
    torch.cuda.synchronize()
    with step_split(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, timer = solve(d, e, cfg, vectors)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, events, ranges, spike = 0.0, 0, {}, {}
    steps = {}
    averages = prof.key_averages()
    # a range's device-side span carries the range's own name: not kernels
    host_keys = {ev.key for ev in averages if ev.device_type != DeviceType.CUDA}
    rowsum = {"device_s": 0.0, "calls": 0}
    iface = {"device_s": 0.0, "calls": 0}
    for ev in averages:
        step = ev.key[5:] if ev.key.startswith("step.") \
            else STEP_RANGES.get(ev.key)
        if step is not None and ev.device_type == DeviceType.CUDA:
            row = steps.setdefault(step, {"device_span_s": 0.0})
            row["device_span_s"] += ev.device_time_total * 1e-6
        elif ev.key.startswith("step."):
            row = steps.setdefault(step, {"device_span_s": 0.0})
            row["host_s"] = ev.cpu_time_total * 1e-6
            row["calls"] = ev.count
        if ev.key in RANGES:
            if ev.device_type != DeviceType.CUDA:
                ranges[ev.key] = {"host_s": ev.cpu_time_total * 1e-6,
                                  "calls": ev.count, "launches": 0}
            continue
        if ev.key in host_keys:
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
            "interface_solve": iface, "cauchy_rowsum": rowsum,
            "eigenvalue_steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a label for the output lines")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--warm", type=int, default=3,
                    help="warm solves a config (walls and phases)")
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help=f"which of {', '.join(CONFIGS)}")
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
    configs = args.configs.split(",")
    for name, cfg, (d, e) in (
            ("mixed", st.SolverConfig(), random),
            ("f64", st.SolverConfig(mixed_precision_vectors=False), random),
            ("poisson_mixed", st.SolverConfig(),
             st.create_matrix_scheme2(args.n))):
        if name not in configs:
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, cold_timer = solve(d, e, cfg)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        resid = float(st.residuals(d, e, res).max())
        ortho = max_ortho_error(res.eigenvectors)
        lam_bits, v_bits = bits_sum(res.eigenvalues), bits_sum(
            res.eigenvectors)
        del res
        warm = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(args.warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, timer = solve(d, e, cfg)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0, timer.times))
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        syncs, syncs_by_step = host_syncs(d, e, cfg)
        print(json.dumps({
            "tag": args.tag, "config": name, "n": args.n,
            "card": smi[0] if smi else None, "cold_wall_s": cold,
            "cold_phases_s": cold_timer.times,
            "residual_max": resid, "ortho": ortho,
            "lam_bits_sum": lam_bits, "V_bits_sum": v_bits,
            "triage_counts": cold_timer.counts,
            "warm_walls_s": [w for w, _ in warm],
            "warm_phases_s": [p for _, p in warm],
            "warm_peak_mem_bytes": peak,
            "host_syncs": syncs, "host_syncs_by_step": syncs_by_step,
            "eigenvalue_steps_warm": step_host_times(d, e, cfg),
            "profile": profiled(d, e, cfg)}), flush=True)
    if "poisson_eigvals_only" not in configs:
        return 0
    # eigenvalues only, the Poisson matrix: eigh_tridiagonal's walls; the
    # split, syncs and profile of the staged solve it runs
    d, e = st.create_matrix_scheme2(args.n)
    cfg = st.SolverConfig()
    walls = []
    for _ in range(1 + args.warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lam = st.eigh_tridiagonal(d, e, config=cfg, eigvals_only=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    syncs, syncs_by_step = host_syncs(d, e, cfg, vectors=False)
    print(json.dumps({
        "tag": args.tag, "config": "poisson_eigvals_only", "n": args.n,
        "card": smi[0] if smi else None, "cold_wall_s": walls[0],
        "warm_walls_s": walls[1:], "host_syncs": syncs,
        "lam_bits_sum": bits_sum(lam),
        "host_syncs_by_step": syncs_by_step,
        "eigenvalue_steps_warm": step_host_times(d, e, cfg, vectors=False),
        "profile": profiled(d, e, cfg, vectors=False)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
