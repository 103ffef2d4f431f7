#!/usr/bin/env python3
"""Where a ``q2_blocks_t`` or an ``interface_solve`` launch spends its time,
on one GPU, by clock64 phase probes.

It copies the package into ``build/kernel_phases/``, defines
``KERNEL_PROBES`` at the top of that copy's ``householder_panel.cu`` and
``interface_solve.cu`` (which switches on their clock64 probes; the
repository's sources are not touched), builds the copy, and prints one JSON
line a shape:

- ``q2_blocks_t`` on the chase's log (chip_smoke.q2_log) at each (n, b),
  every chunk as ``apply_q2_wave_blocked`` cuts them (``--q2-chunks``
  limits how many): thread 0's cycles of each block of threads in the
  phases ``loads`` (the log's entries and taus to the block), ``y_store``
  (Y^T's tiles), ``gram`` (the band Gram), ``diagonal_blocks`` (T's
  diagonal blocks by the recurrence), ``joins`` (the block products) and
  ``t_store``, summed over the blocks and divided by their count, in µs at
  the card's maximum SM clock; beside the probed and the unprobed
  launches' event times;
- ``interface_solve`` on the mixed n=16384 solve's own pass-1 boundary
  values (P=128, K=16384, scaled and shifted: chip_smoke.scan_inputs) and
  on its triage's blocked solves (P=171 and P=256, K=5;
  chip_smoke.triage_calls): column 0's cycles in the forward sweep's
  ``wait_and_d11`` (the step's loads reach their first use), ``chain`` (the
  rest of the step's arithmetic), ``stores``, and the whole ``back_sweep``;
  each also a step (over P), beside the probed and the unprobed launches'
  times.

With ``--times-only`` it builds no probed copy and times the tree's own
kernels at the same shapes (``q2_blocks_t`` over every chunk): CUDA events
over back-to-back calls, the profiler's device time (which reads low when its
window drops events) and ``graph_ms``, the calls captured in one CUDA graph
and replayed (device time with no host path in the way; null if capture
fails): a copy placed in another checkout's ``tools/`` (an older commit
unpacked by ``git archive``) times that checkout, so parent and change run in
one call.

Every line carries the card's name and power limit (nvidia-smi):

    python3 tools/kernel_phase_probe.py --tag change
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
    band_reduce as br, shifted_solve as shs)

Q2_SHAPES = ((4096, 128), (4096, 16), (16384, 128), (16384, 4), (16384, 2))
Q2_PHASES = ("loads", "y_store", "gram", "diagonal_blocks", "joins",
             "t_store")
IF_PHASES = ("wait_and_d11", "chain", "stores", "back_sweep")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return out.splitlines()[0] if out else None


def sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True, check=False).stdout.split()[0])


def probed_copy():
    """The package copied under build/ with KERNEL_PROBES defined in its two
    sources, imported beside the repository's (chip_smoke keeps the
    repository's): (its _build, band_reduce, shifted_solve)."""
    work = ROOT / "build" / "kernel_phases"
    pkg = work / "symmetric_eigenvalue_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(ROOT / "symmetric_eigenvalue_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("householder_panel.cu", "interface_solve.cu"):
        cu = pkg / "csrc" / name
        cu.write_text("#define KERNEL_PROBES\n" + cu.read_text())
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.startswith("symmetric_eigenvalue_tpu_torch")}
    sys.path.insert(0, str(work))
    try:
        from symmetric_eigenvalue_tpu_torch import _build as pb
        from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as pbr
        from symmetric_eigenvalue_tpu_torch.kernels import (
            shifted_solve as pshs)
    finally:
        sys.path.remove(str(work))
        for m in [m for m in sys.modules
                  if m.startswith("symmetric_eigenvalue_tpu_torch")]:
            del sys.modules[m]
        sys.modules.update(saved)
    pb.build_all(["householder_panel", "interface_solve"])
    return pb, pbr, pshs


def q2_rows(args, base, pb, pbr, mhz):
    read = pb.function("householder_panel", "q2_blocks_t_probe_read",
                       [ctypes.c_void_p])
    buf = (ctypes.c_ulonglong * 8)()
    out = []
    for n, b in Q2_SHAPES:
        Vw, tw = cs.q2_log(n, b)
        chunks = br.q2_device_chunks(n, b, torch.cuda.current_device())
        chunks = chunks[:args.q2_chunks] if args.q2_chunks else chunks
        events = cs.time_ms(lambda: cs.q2_blocks_t_all(n, b, Vw, tw, chunks),
                            3)
        probed_ms = cs.time_ms(
            lambda: cs.q2_blocks_t_all(n, b, Vw, tw, chunks, pbr), 1)
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        cs.q2_blocks_t_all(n, b, Vw, tw, chunks, pbr)
        torch.cuda.synchronize()
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        blocks = max(int(buf[7]), 1)
        out.append(dict(base, kernel="q2_blocks_t (probed copy)", n=n, b=b,
                        chunks=len(chunks), blocks_counted=int(buf[7]),
                        events_ms=events, probed_events_ms=probed_ms,
                        sm_mhz=mhz, mean_block_us=dict(zip(
                            Q2_PHASES, [buf[i] / blocks / mhz
                                        for i in range(6)]))))
        del Vw, tw
        torch.cuda.empty_cache()
    return out


def interface_cases():
    """(what, the six inputs, the scales) at the shapes the issue names."""
    seen, _ = cs.scan_inputs("random")
    bnd, e_cross, ec_above = seen["interface"][0]
    cases = [("random n=16384: the Spike pass's pass-1 boundary values",
              (bnd[2], bnd[3], bnd[4], bnd[5], bnd[0], bnd[1]),
              (ec_above, e_cross))]
    calls, _ = cs.triage_calls("random")
    for what, args in calls:
        cases.append((f"random n=16384: {what}", cs.blocked_boundary(args),
                      (None, None)))
    return cases


def interface_rows(args, base, pb, pshs, mhz):
    read = pb.function("interface_solve", "interface_probe_read",
                       [ctypes.c_void_p])
    buf = (ctypes.c_longlong * 8)()
    out = []
    for what, ins, (ec, ecr) in interface_cases():
        kw = dict(ec_above=ec, e_cross=ecr, shifted=True)
        got = pshs.interface_solve(*ins, **kw)
        want = shs.interface_solve(*ins, **kw)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        torch.cuda.synchronize()
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        P, K = ins[4].shape
        us = [buf[i] / mhz for i in range(4)]
        out.append(dict(
            base, kernel="interface_solve (probed copy)", what=what, P=P,
            K=K, probed_equals_unprobed=same, sm_mhz=mhz,
            events_ms=cs.time_ms(lambda: shs.interface_solve(*ins, **kw),
                                 args.reps),
            device_ms=cs.device_ms(lambda: shs.interface_solve(*ins, **kw),
                                   args.reps),
            probed_events_ms=cs.time_ms(
                lambda: pshs.interface_solve(*ins, **kw), args.reps),
            column0_us=dict(zip(IF_PHASES, us)),
            column0_us_a_step=dict(zip(IF_PHASES, [u / P for u in us])),
            column0_cycles_a_forward_step=sum(buf[i] for i in range(3)) / P))
    return out


def graph_ms(fn, reps):
    """Device time a call of ``reps`` calls of ``fn`` captured in one CUDA
    graph and replayed (after an eager warm-up on a side stream), or None
    with the reason when capture fails."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        ms = cs.time_ms(graph.replay, 5) / reps
        del graph
        torch.cuda.empty_cache()
        return ms, None
    except Exception as exc:               # capture refused: say why
        torch.cuda.synchronize()
        return None, f"{type(exc).__name__}: {exc}"[:200]


def time_rows(args, base):
    """The tree's own kernels, unprobed, at the same shapes."""
    out = []
    if "q2_blocks_t" in args.only:
        for n, b in Q2_SHAPES:
            Vw, tw = cs.q2_log(n, b)
            chunks = br.q2_device_chunks(n, b, torch.cuda.current_device())
            run = lambda: cs.q2_blocks_t_all(n, b, Vw, tw, chunks)  # noqa: E731
            g_ms, g_err = graph_ms(run, 1)
            out.append(dict(base, kernel="q2_blocks_t", n=n, b=b,
                            chunks=len(chunks), events_ms=cs.time_ms(run, 3),
                            device_ms=cs.device_ms(run, 3,
                                                   only="q2_blocks_t"),
                            graph_ms=g_ms, graph_error=g_err))
            del Vw, tw
            torch.cuda.empty_cache()
    if "interface_solve" in args.only:
        for what, ins, (ec, ecr) in interface_cases():
            kw = dict(ec_above=ec, e_cross=ecr, shifted=True)
            run = lambda: shs.interface_solve(*ins, **kw)  # noqa: E731
            g_ms, g_err = graph_ms(run, args.reps)
            out.append(dict(base, kernel="interface_solve", what=what,
                            P=ins[4].shape[0], K=ins[4].shape[1],
                            events_ms=cs.time_ms(run, args.reps),
                            device_ms=cs.device_ms(run, args.reps),
                            graph_ms=g_ms, graph_error=g_err))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="", help="a label for the output lines")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--q2-chunks", type=int, default=0,
                    help="probe only the first N chunks of each shape")
    ap.add_argument("--only", default="q2_blocks_t,interface_solve")
    ap.add_argument("--times-only", action="store_true",
                    help="time the tree's own kernels, no probed copy")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_phase_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dict(tag=args.tag, card=card(),
                device=torch.cuda.get_device_name(0))
    cs._build.build_all()             # the repository's sources, at once
    if args.times_only:
        for row in time_rows(args, base):
            print(json.dumps(row), flush=True)
        return
    pb, pbr, pshs = probed_copy()
    mhz = sm_mhz()
    rows = []
    if "q2_blocks_t" in args.only:
        rows += q2_rows(args, base, pb, pbr, mhz)
    if "interface_solve" in args.only:
        rows += interface_rows(args, base, pb, pshs, mhz)
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
