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

It imports the package from the tree it sits in, so a copy placed in
another checkout's ``tools/`` (an older commit unpacked by ``git archive``)
measures that checkout (counters that tree lacks read null):

    python3 tools/torch_dense_profile.py --tag change
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import symmetric_eigenvalue_tpu_torch as st  # noqa: E402
from symmetric_eigenvalue_tpu_torch.kernels import (  # noqa: E402
    dword_matmul as dm, dword_matvec as dv, tridiagonalize as tri)
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
            ("larft", hp, "larft_launches"))
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


def timed_eigh(A, **kw):
    timer = PhaseTimer()
    reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = st.eigh(A, timer=timer, **kw)
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


def profiled(fn, n: int):
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
            "top_kernels": dict(top)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a label for the output lines")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dense_profile: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = {"card": torch.cuda.get_device_name(0), "tag": args.tag}
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


if __name__ == "__main__":
    sys.exit(main())
