#!/usr/bin/env python3
"""Where a ``panel_qr`` or ``larft`` launch spends its time, on one GPU.

For each shape it prints one JSON line with four times of the same call:

- ``host_us``: the wrapper's host path alone (plan, occupancy lookups,
  workspace, the ctypes call and the launch's own host cost), timed on the
  host clock behind a device spin (chip_smoke.host_launch_us);
- ``events_ms``: CUDA events around back-to-back calls (chip_smoke.time_ms,
  what chip_smoke.py's ``ms`` reports);
- ``device_ms``: the kernel's device time by ``torch.profiler``
  (chip_smoke.device_ms);
- ``graph_ms``: the calls captured in one CUDA graph and replayed (the
  device's time with no host in the way; null if capture fails).

``panel_qr`` runs on chip_smoke.py's dense input (chip_smoke.check_panel_qr's)
at (m, o, b); ``larft`` on chip_smoke.larft_inputs (nb reflectors over 4096
columns).  ``--grids`` also times the panel shapes at each given grid (the
plan laid out at that grid, ``band_reduce._panel_qr_layout``).

With ``--phases`` it instead copies the package into
``build/panel_qr_phases/``, defines ``KERNEL_PROBES`` at the top of that
copy's ``band_reduce.cu`` and ``householder_panel.cu`` (which switches on
their clock64 probes; the repository's sources are not touched) and
prints, for each panel shape (and grid of ``--grids``), the cycles thread 0
of each block spends a launch in each phase: the panel's load, column 0's
partials, the grid syncs (the wait for the slowest block), the totals'
reads with the reflector, v with the next pivot row's update, and the next
column's partials with the rows' update; block 0's, and the mean, the
least and the most over the blocks, in µs at the card's maximum SM clock;
and for ``larft`` at nb = 32 and 128 thread 0's staging, diagonal blocks,
joins and store.

Every line carries the card's name and power limit (nvidia-smi):

    python3 tools/panel_qr_profile.py --tag change
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from symmetric_eigenvalue_tpu_torch.kernels import (  # noqa: E402
    band_reduce as br, householder_panel as hp)

SHAPES = ((4096, 0), (16384, 0), (16384, 8192))   # (m, o) at b = 128
PHASES = ("load", "first_partials", "sync", "totals_and_reflector",
          "v_and_next_row", "partials")
LARFT_PHASES = ("stage", "diagonal_blocks", "joins", "store")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return out.splitlines()[0] if out else None


def graph_ms(fn, reps):
    """Device time a call of ``reps`` calls captured in one CUDA graph."""
    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return cs.time_ms(graph.replay, 3) / reps, None
    except Exception as exc:               # capture refused: say why
        torch.cuda.synchronize()
        return None, f"{type(exc).__name__}: {exc}"[:200]


def measure(fn, reps, only):
    g_ms, g_err = graph_ms(fn, reps)
    return dict(host_us=cs.host_launch_us(fn, reps),
                events_ms=cs.time_ms(fn, reps),
                device_ms=cs.device_ms(fn, reps, only=only), graph_ms=g_ms,
                graph_error=g_err)


def forced_plan(mod, grid):
    """A stand-in for ``mod.panel_qr_device_plan`` that lays the launch
    out at ``grid`` blocks (None: the planner's own)."""
    if grid is None:
        return mod.panel_qr_device_plan

    def plan(m, o, b, index):
        _, sms, optin = mod._occupancy("panel_qr", index, 0)
        return mod._panel_qr_layout(
            m, o, b, grid, sms, optin,
            lambda smem: mod._occupancy("panel_qr", index, smem)[0])
    return plan


def grid_list(args):
    return [None] + [int(x) for x in args.grids.split(",") if x]


def panel_rows(args, base):
    out = []
    saved = br.panel_qr_device_plan
    for m, o in SHAPES:
        b = 128
        A = cs.dense_matrix(m, cs.SEED + 30)
        Yp, tp = A.new_zeros((b, m)), A.new_zeros(b)
        row = dict(base, kernel="panel_qr", m=m, o=o, b=b,
                   **measure(lambda: br.panel_qr(A, o, b, Yp, tp), args.reps,
                             "panel_qr"))
        if args.grids:
            got = {}
            for g in grid_list(args):
                br.panel_qr_device_plan = forced_plan(br, g)
                try:
                    got["plan" if g is None else str(g)] = cs.time_ms(
                        lambda: br.panel_qr(A, o, b, Yp, tp), args.reps)
                except (ValueError, RuntimeError) as exc:
                    got[str(g)] = f"{type(exc).__name__}: {exc}"[:120]
                finally:
                    br.panel_qr_device_plan = saved
            row["grid_ms"] = got
        out.append(row)
        del A, Yp, tp
    return out


def larft_rows(args, base):
    out = []
    for nb in (32, 128):
        G, tau = cs.larft_inputs(nb, 4096)
        out.append(dict(base, kernel="larft", nb=nb,
                        **measure(lambda: hp.larft(G, tau), args.reps,
                                  "larft")))
    return out


def probed_copy():
    """The package copied under build/ with KERNEL_PROBES defined in its two
    sources, imported in place of the repository's: (its _build,
    band_reduce, householder_panel)."""
    work = ROOT / "build" / "panel_qr_phases"
    pkg = work / "symmetric_eigenvalue_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(ROOT / "symmetric_eigenvalue_tpu_torch", pkg)
    for name in ("band_reduce.cu", "householder_panel.cu"):
        cu = pkg / "csrc" / name
        cu.write_text("#define KERNEL_PROBES\n" + cu.read_text())
    for name in [m for m in sys.modules
                 if m.startswith("symmetric_eigenvalue_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(work))
    from symmetric_eigenvalue_tpu_torch import _build as pb
    from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as pbr
    from symmetric_eigenvalue_tpu_torch.kernels import householder_panel as php
    pb.build_all(["band_reduce", "householder_panel"])
    return pb, pbr, php


def spread(rows, names):
    """Block 0's, the mean, the least and the most over the blocks."""
    cols = list(zip(*rows))
    return dict(block0_us=dict(zip(names, rows[0])),
                mean_us=dict(zip(names, [sum(c) / len(c) for c in cols])),
                max_us=dict(zip(names, map(max, cols))),
                min_us=dict(zip(names, map(min, cols))))


def phases(args, base):
    """The probed copy's phases at each panel shape (module docstring)."""
    pb, pbr, php = probed_copy()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    read = pb.function("band_reduce", "panel_qr_probe_read", [ctypes.c_void_p])
    out = []
    saved = pbr.panel_qr_device_plan
    for (m, o), g in [(s, g) for s in SHAPES for g in grid_list(args)]:
        b = 128
        pbr.panel_qr_device_plan = forced_plan(pbr, g)
        A = cs.dense_matrix(m, cs.SEED + 30)
        Yp, tp = A.new_zeros((b, m)), A.new_zeros(b)
        ms = cs.time_ms(lambda: pbr.panel_qr(A, o, b, Yp, tp), 5)
        plan = pbr.panel_qr_device_plan(m, o, b, torch.cuda.current_device())
        buf = (ctypes.c_longlong * (8 * 1024))()
        pbr.panel_qr(A, o, b, Yp, tp)
        torch.cuda.synchronize()
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        rows = [[buf[8 * k + i] / mhz for i in range(len(PHASES))]
                for k in range(plan.grid)]
        out.append(dict(base, kernel="panel_qr (probed copy)", m=m, o=o, b=b,
                        plan=plan._asdict(), events_ms=ms, sm_mhz=mhz,
                        **spread(rows, PHASES)))
        pbr.panel_qr_device_plan = saved
        del A, Yp, tp
    lread = pb.function("householder_panel", "larft_probe_read",
                        [ctypes.c_void_p])
    for nb in (32, 128):
        G, tau = cs.larft_inputs(nb, 4096)
        ms = cs.time_ms(lambda: php.larft(G, tau), 20)
        buf = (ctypes.c_longlong * 8)()
        php.larft(G, tau)
        torch.cuda.synchronize()
        pb.check_launch(lread(ctypes.addressof(buf)), "probe read")
        out.append(dict(base, kernel="larft (probed copy)", nb=nb,
                        events_ms=ms, sm_mhz=mhz,
                        thread0_us=dict(zip(LARFT_PHASES,
                                            [buf[i] / mhz
                                             for i in range(4)]))))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a label for the output lines")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--grids", default="",
                    help="comma-separated panel_qr grids to time (or, with "
                    "--phases, to probe) as well")
    ap.add_argument("--phases", action="store_true",
                    help="clock64 phases of a probed copy of the kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("panel_qr_profile: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(tag=args.tag, card=card(),
                device=torch.cuda.get_device_name(0))
    rows = (phases(args, base) if args.phases
            else panel_rows(args, base) + larft_rows(args, base))
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
