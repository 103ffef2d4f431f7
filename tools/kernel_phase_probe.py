#!/usr/bin/env python3
"""Where a ``q2_blocks_t``, an ``interface_solve``, a ``rotation_replay``, a
``deflation_tree`` or a ``block_lu_solve`` launch spends its time, on one
GPU, by clock64 phase probes.

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
  times;
- ``rotation_replay`` (the downsweep form) on every level of the mixed
  n=16384 solves of the random and the Poisson matrix (and the Poisson
  root's y in f64): thread 0's cycles of each block in ``scan`` (reading
  and scanning the merges' item counts), ``stage`` (an item's log to
  shared memory) and ``apply`` (its rotations), in µs a block and in all,
  beside the items taken and the probed and unprobed launches' times.

With ``--only deflation_tree,block_lu_solve`` it probes those two kernels
(``deflation_tree.cu`` and ``spike_solve.cu`` copied with KERNEL_PROBES):
the tree's thread 0 of merge 0 on every merge level of the n=16384 solves
of the random and the Poisson matrix (eigenvalues only) and on a synthetic
(1, 98304) level, in ``loads_and_start_copy``, ``thread_levels``,
``warp_levels``, ``block_levels``, ``counts_and_placement`` (the cluster's
barrier and levels included), ``records``, ``tail`` and
``cluster_exit_wait``; the block LU on the triage's shapes and a refinement
chunk: the wide form's column 0 (band load, forward sweep,
re-elimination, back substitution with its stores) and the narrow form's
thread 0 (staging, forward sweep, back substitution, stores), with the
divisions that left the fast path counted and the slowest block's time.
With ``--times-only`` those cases are timed by CUDA-graph replays (and
each matrix's merge levels summed).

With ``--only rotation_replay,rotation_replay_t --times-only`` it times the
replays of those levels as the tree runs them: the downsweep's launch
(events, profiler, CUDA graph) and the same launch on an empty log (the
grid alone); rows_through_merge's transposed chain on every non-root level
(the ``rotation_replay_t`` kernel where the tree has it: events, profiler,
graph, the host's time a call), and the torch wave loop with
``rotation_waves``' fetches it replaced (events, host wall a call).

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
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
import symmetric_eigenvalue_tpu_torch as st  # noqa: E402
from symmetric_eigenvalue_tpu_torch import driver  # noqa: E402
from symmetric_eigenvalue_tpu_torch.kernels import (  # noqa: E402
    assemble, band_reduce as br, deflation_tree as dtr,
    rotation_replay as rr, shifted_solve as shs)

Q2_SHAPES = ((4096, 128), (4096, 16), (16384, 128), (16384, 4), (16384, 2))
Q2_PHASES = ("loads", "y_store", "gram", "diagonal_blocks", "joins",
             "t_store")
IF_PHASES = ("wait_and_d11", "chain", "stores", "back_sweep")
RR_PHASES = ("scan", "stage", "apply")
# deflation_tree.cu's probes: thread 0 of merge 0
DT_PHASES = ("loads_and_start_copy", "thread_levels", "warp_levels",
             "block_levels", "counts_and_placement", "records", "tail",
             "cluster_exit_wait")
# spike_solve.cu's block-LU probes: column 0 of row block 0 (the wide
# form), thread 0 of block 0 (the narrow form)
LU_PHASES = ("band_load", "forward_sweep", "re_elimination",
             "back_substitution_and_stores")
LU_NARROW_PHASES = ("band_and_v_staging", "forward_sweep",
                    "back_substitution", "stores")   # thread 0 of block 0


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
    """The package copied under build/ with KERNEL_PROBES defined in its
    probed sources, imported beside the repository's (chip_smoke keeps the
    repository's): (its _build, band_reduce, shifted_solve,
    rotation_replay, deflation_tree)."""
    work = ROOT / "build" / "kernel_phases"
    pkg = work / "symmetric_eigenvalue_tpu_torch"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(ROOT / "symmetric_eigenvalue_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in PROBED:
        cu = pkg / "csrc" / f"{name}.cu"
        cu.write_text("#define KERNEL_PROBES\n" + cu.read_text())
    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.startswith("symmetric_eigenvalue_tpu_torch")}
    sys.path.insert(0, str(work))
    try:
        from symmetric_eigenvalue_tpu_torch import _build as pb
        from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as pbr
        from symmetric_eigenvalue_tpu_torch.kernels import (
            shifted_solve as pshs, rotation_replay as prr,
            deflation_tree as pdtr)
    finally:
        sys.path.remove(str(work))
        for m in [m for m in sys.modules
                  if m.startswith("symmetric_eigenvalue_tpu_torch")]:
            del sys.modules[m]
        sys.modules.update(saved)
    pb.build_all(PROBED)
    return pb, pbr, pshs, prr, pdtr


PROBED = ("householder_panel", "interface_solve", "rotation_replay",
          "deflation_tree", "spike_solve")


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


def replay_cases():
    """Every level's replays of the mixed n=16384 solves of the random and
    the Poisson matrix as the tree runs them: [(what, rep, y)] of the
    downsweep (the first call a level shape; the Poisson root's y once
    more in f64) and [(what, rep, wt)] of rows_through_merge's transposed
    chain (wt: the boundary rows permuted and laid out as the chain takes
    them)."""
    down, up = [], []
    for matrix, (d, e) in (("random", cs.random_matrix(cs.N, cs.SEED)),
                           ("Poisson", st.create_matrix_scheme2(cs.N))):
        got, rows = {}, []
        inner_rr, inner_rows = assemble.rotation_replay, driver.rows_through_merge

        def rec_rr(rep, y, waves=None):
            got.setdefault(tuple(y.shape[:2]), (rep, y.clone()))
            return inner_rr(rep, y, waves)

        def rec_rows(rep, w, *a):
            rows.append((rep, w.clone()))
            return inner_rows(rep, w, *a)

        assemble.rotation_replay, driver.rows_through_merge = rec_rr, rec_rows
        try:
            st.solve_tridiagonal_staged(d, e, compute_vectors=True)
        finally:
            assemble.rotation_replay = inner_rr
            driver.rows_through_merge = inner_rows
        for (k, m), (rep, y) in got.items():
            down.append((f"{matrix}, level k={k}, m={m}", rep, y))
        if matrix == "Poisson":
            (k, m), (rep, y) = next(iter(got.items()))
            down.append((f"{matrix}, level k={k}, m={m}, as f64", rep,
                         y.double()))
        for rep, w in rows:
            k, r, m = w.shape
            wt = w.gather(2, rep.p12[:, None, :].expand(k, r, m)) \
                .transpose(1, 2).contiguous()
            up.append((f"{matrix}, level k={k}, m={m}", rep, wt))
        del got, rows
        torch.cuda.empty_cache()
    return down, up


def replay_rows(args, base, prr, pb, mhz):
    """The downsweep form's clock64 split on every level (probed copy)."""
    read = pb.function("rotation_replay", "rotation_replay_probe_read",
                       [ctypes.c_void_p])
    buf = (ctypes.c_ulonglong * 4)()
    out = []
    down, _ = replay_cases()
    for what, rep, y in down:
        work = y.clone()
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        got = prr.rotation_replay(rep, y.clone())
        same = torch.equal(got, rr.rotation_replay(rep, y.clone()))
        torch.cuda.synchronize()
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        plan = cs.replay_plan(rep, y, False)
        blocks = plan["grid"]
        out.append(dict(
            base, kernel="rotation_replay (probed copy)", what=what,
            k=y.shape[0], m=y.shape[1], C=y.shape[2],
            dtype=str(y.dtype).split(".")[-1], nrot=int(rep.nrot.sum()),
            nwave_max=int(rep.nwave.max()), plan=plan, items=int(buf[3]),
            probed_equals_unprobed=same, sm_mhz=mhz,
            block_us=dict(zip(RR_PHASES, [buf[i] / blocks / mhz
                                          for i in range(3)])),
            events_ms=cs.time_ms(lambda: rr.rotation_replay(rep, work),
                                 args.reps),
            probed_events_ms=cs.time_ms(
                lambda: prr.rotation_replay(rep, work), args.reps)))
    return out


def replay_time_rows(args, base):
    """The replays as the tree runs them, every level (see the module's
    docstring); a tree without ``rotation_replay_t`` times only the torch
    loop it had in rows_through_merge."""
    out = []
    only = args.only.split(",")
    if "rotation_replay" not in only and "rotation_replay_t" not in only:
        return out
    down, up = replay_cases()
    if "rotation_replay" in only:
        for what, rep, y in down:
            work = y.clone()
            run = lambda: rr.rotation_replay(rep, work)  # noqa: E731
            empty = rep._replace(nrot=torch.zeros_like(rep.nrot),
                                 nwave=torch.zeros_like(rep.nwave))
            g_ms, g_err = graph_ms(run, args.reps)
            e_ms, e_err = graph_ms(lambda: rr.rotation_replay(empty, work),
                                   args.reps)
            size = y.element_size()
            out.append(dict(
                base, kernel="rotation_replay", what=what, k=y.shape[0],
                m=y.shape[1], C=y.shape[2], dtype=str(y.dtype).split(".")[-1],
                nrot=int(rep.nrot.sum()), nwave_max=int(rep.nwave.max()),
                events_ms=cs.time_ms(run, args.reps),
                device_ms=cs.device_ms(run, args.reps,
                                       only="rotation_replay_kernel"),
                graph_ms=g_ms, graph_error=g_err, empty_log_graph_ms=e_ms,
                empty_log_graph_error=e_err,
                bytes_bound_ms=1e3 * 4.0 * int(rep.nrot.sum()) * y.shape[2]
                * size / cs.PEAK_BYTES))
    if "rotation_replay_t" in only:
        kernel = getattr(rr, "rotation_replay_t", None)
        for what, rep, wt in up:
            k, m, r = wt.shape
            work = wt.clone()

            def replaced():
                waves = rr.rotation_waves(rep)
                loop = getattr(rr, "replay_waves_t", None) or getattr(
                    assemble, "_replay_rotations_cols_t")
                loop(waves, work.view(k * m, r))

            t0 = time.perf_counter()
            for _ in range(5):
                replaced()
            torch.cuda.synchronize()
            row = dict(base, kernel="rotation_replay_t", what=what, k=k, m=m,
                       r=r, nrot=int(rep.nrot.sum()),
                       nwave_max=int(rep.nwave.max()),
                       bytes_bound_ms=1e3 * 4.0 * int(rep.nrot.sum()) * r
                       * wt.element_size() / cs.PEAK_BYTES,
                       replaced_events_ms=cs.time_ms(replaced, 5),
                       replaced_host_ms=1e3 * (time.perf_counter() - t0) / 5)
            if kernel is not None:
                run = lambda: kernel(rep, work)  # noqa: E731
                g_ms, g_err = graph_ms(run, args.reps)
                row.update(events_ms=cs.time_ms(run, args.reps),
                           device_ms=cs.device_ms(
                               run, args.reps, only="rotation_replay_t"),
                           graph_ms=g_ms, graph_error=g_err,
                           host_launch_us=cs.host_launch_us(run, args.reps))
            out.append(row)
    return out


def tree_cases():
    """deflation_tree's inputs on every merge level of the n=16384 solves of
    the random and the Poisson matrix (eigenvalues only, f64), and a
    synthetic (1, 98304) level of clustered poles (the CLI's root width):
    [(what, matrix, (ds, zs, defl0, tol))]."""
    out = []
    for matrix, (d, e) in (("random", cs.random_matrix(cs.N, cs.SEED)),
                           ("Poisson", st.create_matrix_scheme2(cs.N))):
        with cs.recorded_trees() as got:
            st.solve_tridiagonal_staged(d, e, compute_vectors=False)
        for (k, m), args in got.items():
            out.append((f"{matrix}, level k={k}, m={m}", matrix, args))
        del got
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
    k, m = 1, 98304
    rand = lambda: torch.randn((k, m), generator=g, device="cuda",  # noqa
                               dtype=torch.float64)
    ds = torch.sort(torch.round(rand() * 20.0) / 10.0 + 1e-7 * rand(),
                    dim=1).values
    defl0 = torch.rand((k, m), generator=g, device="cuda") < 0.15
    keep = torch.rand((k, m), generator=g, device="cuda") > 0.2
    zs = torch.where(defl0 | ~keep, 0.0, rand() / m ** 0.5)
    tol = torch.full((k,), 1e-4, dtype=torch.float64, device="cuda")
    out.append(("synthetic clusters, k=1, m=98304", "synthetic",
                (ds, zs, defl0, tol)))
    torch.cuda.empty_cache()
    return out


def tree_plan(mod, k, m):
    plan = mod.launch_plan(k, m)
    return plan._asdict() if hasattr(plan, "_asdict") else str(plan)


def tree_rows(args, base, pb, pdtr, mhz):
    """deflation_tree's clock64 split on every case (probed copy)."""
    read = pb.function("deflation_tree", "deflation_tree_probe_read",
                       [ctypes.c_void_p])
    buf = (ctypes.c_longlong * 16)()
    out = []
    for what, _, targs in tree_cases():
        k, m = targs[0].shape
        got = pdtr.deflation_tree(*targs)
        want = dtr.deflation_tree(*targs)
        flat = lambda o: [*o[:3], *o[3]]  # noqa: E731
        same = all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))
        torch.cuda.synchronize()
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        out.append(dict(
            base, kernel="deflation_tree (probed copy)", what=what, k=k,
            m=m, nrot=int(want[3][5].sum()), plan=tree_plan(pdtr, k, m),
            probed_equals_unprobed=same, sm_mhz=mhz,
            levels=int(buf[8]),
            thread0_us=dict(zip(DT_PHASES, [buf[i] / mhz
                                            for i in range(8)])),
            events_ms=cs.time_ms(lambda: dtr.deflation_tree(*targs),
                                 args.reps),
            probed_events_ms=cs.time_ms(
                lambda: pdtr.deflation_tree(*targs), args.reps)))
    return out


def block_lu_cases():
    """block_lu_solve's arguments at the triage shapes of the mixed n=16384
    solves of the random and the Poisson matrix (chip_smoke.triage_calls),
    and on the random solve's first refinement chunk at nb=128 (K=2048)."""
    cases = []
    for matrix in ("random", "poisson"):
        calls, _ = cs.triage_calls(matrix)
        for what, largs in calls:
            cases.append((f"{matrix} n=16384: {what}", largs))
    seen, _ = cs.scan_inputs("random")
    d, e, lam, V = seen["first_pass"][0]
    cases.append(("random n=16384: the first refinement chunk, nb=128",
                  cs.block_lu_args(d, e, lam, V, 128)))
    return cases


def block_lu_rows(args, base, pb, pshs, mhz):
    """block_lu_solve's clock64 split on every case (probed copy)."""
    read = pb.function("spike_solve", "block_lu_probe_read",
                       [ctypes.c_void_p])
    buf = (ctypes.c_longlong * 12)()
    out = []
    for what, largs in block_lu_cases():
        want = shs.block_lu_solve(*largs)
        torch.cuda.synchronize()
        pb.check_launch(read(ctypes.addressof(buf)), "probe zero")
        got = pshs.block_lu_solve(*largs)
        torch.cuda.synchronize()
        pb.check_launch(read(ctypes.addressof(buf)), "probe read")
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        nb, K = largs[7], largs[6].shape[1]
        plan = getattr(pshs, "block_lu_plan", None)
        out.append(dict(
            base, kernel="block_lu_solve (probed copy)", what=what, nb=nb,
            K=K, P=largs[0].shape[0] // nb,
            plan=None if plan is None else plan(nb, K)._asdict(),
            probed_equals_unprobed=same, sm_mhz=mhz,
            form=shs.block_lu_plan(nb, K).form,
            column0_us=dict(zip(LU_PHASES, [buf[i] / mhz for i in range(4)])),
            narrow_thread0_us=dict(zip(LU_NARROW_PHASES,
                                       [buf[4 + i] / mhz for i in range(4)])),
            narrow_slow_divisions_forward=int(buf[8]),
            narrow_slow_divisions_back=int(buf[9]),
            narrow_slowest_block_us=buf[10] / mhz,
            events_ms=cs.time_ms(lambda: shs.block_lu_solve(*largs),
                                 args.reps),
            probed_events_ms=cs.time_ms(
                lambda: pshs.block_lu_solve(*largs), args.reps)))
    return out


def tree_time_rows(args, base):
    """deflation_tree's graph replays on every case, and each matrix's
    levels summed."""
    out, sums = [], {}
    for what, matrix, targs in tree_cases():
        k, m = targs[0].shape
        run = lambda: dtr.deflation_tree(*targs)  # noqa: E731
        g_ms, g_err = graph_ms(run, args.reps)
        if matrix != "synthetic" and g_ms is not None:
            sums[matrix] = sums.get(matrix, 0.0) + g_ms
        out.append(dict(base, kernel="deflation_tree", what=what, k=k, m=m,
                        nrot=int(run()[3][5].sum()),
                        plan=tree_plan(dtr, k, m),
                        events_ms=cs.time_ms(run, args.reps),
                        device_ms=cs.device_ms(run, args.reps),
                        graph_ms=g_ms, graph_error=g_err))
    for matrix, ms in sums.items():
        out.append(dict(base, kernel="deflation_tree",
                        what=f"{matrix}: every merge level summed",
                        graph_ms=ms))
    return out


def block_lu_time_rows(args, base):
    """block_lu_solve's graph replays on every case."""
    out = []
    for what, largs in block_lu_cases():
        run = lambda: shs.block_lu_solve(*largs)  # noqa: E731
        g_ms, g_err = graph_ms(run, args.reps)
        nb, K = largs[7], largs[6].shape[1]
        form = getattr(shs, "block_lu_plan", None)
        out.append(dict(base, kernel="block_lu_solve", what=what, nb=nb,
                        K=K, P=largs[0].shape[0] // nb,
                        form="wide" if form is None else form(nb, K).form,
                        events_ms=cs.time_ms(run, args.reps),
                        device_ms=cs.device_ms(run, args.reps),
                        graph_ms=g_ms, graph_error=g_err))
    return out


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
    out += replay_time_rows(args, base)
    only = args.only.split(",")
    if "deflation_tree" in only:
        out += tree_time_rows(args, base)
    if "block_lu_solve" in only:
        out += block_lu_time_rows(args, base)
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
    pb, pbr, pshs, prr, pdtr = probed_copy()
    mhz = sm_mhz()
    rows = []
    if "q2_blocks_t" in args.only:
        rows += q2_rows(args, base, pb, pbr, mhz)
    if "interface_solve" in args.only:
        rows += interface_rows(args, base, pb, pshs, mhz)
    if "rotation_replay" in args.only.split(","):
        rows += replay_rows(args, base, prr, pb, mhz)
    if "deflation_tree" in args.only.split(","):
        rows += tree_rows(args, base, pb, pdtr, mhz)
    if "block_lu_solve" in args.only.split(","):
        rows += block_lu_rows(args, base, pb, pshs, mhz)
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
