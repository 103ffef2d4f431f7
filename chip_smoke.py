#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it.

Run from the repository root:  python3 chip_smoke.py
With ``--only dword_matmul,cauchy_matmul`` (any of the 22 kernels' names)
it builds those kernels' sources, runs phase 3 for them alone, held to the
same limits, and stops: half a minute for work on one kernel.

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  1. device    the card's name and power limit (nvidia-smi), torch and CUDA
  2. build     every CUDA kernel of the port, built from csrc/ by nvcc (one
               process per source, all at once)
  3. kernels   each kernel against its plain PyTorch version on the card at
               the shapes its path gives it: time (CUDA events over
               back-to-back calls, and the profiler's device time per call),
               plain time, library time, bound, error and tolerance;
               secular_solve (the root finder's whole iteration) on the
               level data of a tear of the main path's matrix, against the
               plain loop with the sums kernel (the path it replaces) and
               with the plain sums, and (secular_stall) on the bottom level
               and on a level that deflates little against the plain loop
               run on the CPU: no root stalls at max_secular_iters where
               that loop converges; the Spike passes bit for bit their
               plain versions (also on each chunk of a mixed solve's own
               downsweep output), with their launch plan, registers, scratch
               bytes and a bound from the FP64 instructions of one row of
               the plain LU (cuobjdump's SASS); cauchy_rowsum also with
               K = m/8 (the K cut bit for bit the K = m result, 0 past K)
               and on every non-root level of a mixed solve of the main
               input and of the Poisson matrix, its bound from the FP64
               instructions of one term (SASS) over the terms the inputs
               need; dword_matmul also at a ragged
               shape, batched, and in its fused form C -= A @ B on a strided
               view, with its split-K plan; cauchy_matmul also against the
               plain emulation of its TF32 split, against an f64 product,
               and at denominators outside the normal range;
               rotation_replay bit for bit its plain version (the wave
               loop) on every level of the mixed n=16384 solve of the main
               input and of the Poisson matrix, and once in f64, with the
               cost of its grid alone (the same launch on an empty log);
               rotation_replay_t (the transposed form) bit for bit its
               plain loop on every non-root level of the same solves and
               of the main input in the float32 mode, beside its bytes
               bound, its latency floor (waves x an L2 round trip this run
               measures) and the replaced torch loop with its host fetches,
               and rows_through_merge there with no host sync;
               deflation_tree (the merge's Givens deflation tree, one launch
               a merge level) bit for bit its plain loop, every output, on
               every level of the random and the Poisson n=16384 solves in
               f64 and in the float32 mode and on synthetic levels (m not a
               power of two, m = 1 and 2, the CLI's root width 98304),
               beside its bytes bound (74 bytes a slot in f64), its latency
               floor (its levels x an L2 round trip) and the replaced torch
               loop, with no host sync;
               interface_solve bit for bit its plain loop on the mixed
               random and Poisson n=16384 solves' own pass-1 boundary
               values (P=128, K=16384, the Spike pass's scaled and shifted
               form) and on the boundary rows of their triage's blocked
               solves; block_lu_solve bit for bit its plain loop on their
               first refinement chunk at nb=128 and at the triage's extra
               and rescue shapes (nb=96 and 64, the risky columns); both
               with bounds from their yardsticks' SASS; the dense
               reduction's column step, one cooperative kernel launched
               three ways (column_reflector alone, column_w alone, and
               column_w_reflector: a column's W row fused with the next
               column's reflector), from identical inputs against the
               plain step at m=16384 (jj = 0, 15, 31), a later bucket's
               strided view (m=12288), sigma2 == 0 (a panel's first
               column, and inside a panel), the identity column j = m-2
               and a 512-column panel, each run-to-run identical; a whole
               32-column panel at m=16384 through the kernels' schedule
               against the plain loop (device time a column by kernel,
               launches, the cost of a grid sync); a whole tridiagonalize
               at n=1024 against the plain column step (2e-12 n max|A|);
               larft at nb=32, 128, 127 and 1 against its plain loop; the
               wavefront chase (band_chase, the whole chase one
               cooperative launch) at (n, b) = (4096, 128), (4096, 16),
               (1024, 128), (1024, 16), (1024, 256) against the plain wave loop on the
               card (d and e within 2e-12 n max|B|, eigvalsh of T against
               eigvalsh(B) within 1e-12 ||B||, the log by the similarity it
               defines within 1e-12, two runs bit for bit, the log off: d
               and e bit for bit, no host sync, one launch), with a grid
               sync's cost and the bound (window bytes, FP64 operations, a
               grid sync a wave); the panel QR (panel_qr, one launch a panel) at
               m=4096 and 16384, b=128, a middle panel, one with 5 live
               columns and a 1024-column one, against the plain column loop (Yp, tp within
               2e-12 m; one grid sync a column; the wrapper's host path),
               and a whole reduce_to_band at n=1024; the
               backtransform through Q2: every block's T (q2_blocks_t, one
               launch a chunk of waves) of the chase's log at (n, b) =
               (4096, 128), (4096, 16), (16384, 128) against its plain
               recurrence (1e-12 max|T|), and q2_apply's widest wave at
               (4096, 128), (4096, 16), (16384, 128), (1024, 256) against
               the plain wave (1e-12 max|X|; rows outside the wave bit for
               bit) and torch.ormqr of the same blocks, then the whole
               backtransform (a q2_blocks_t a chunk, a q2_apply a wave)
               against the plain waves (1e-11 max|X|, no host sync; the
               two kernels' device time apart), beside the replaced host
               loop at n=4096, each row with its plan (tile, instance,
               blocks of threads an SM) and the A operands' bytes its
               launches fetch from L2, timed at the L2 rate the run
               measures; at n=16384, u=2
               and u=4 the whole backtransform's memory beyond X within
               q2_store_budget (n^2/2 doubles), 1025 columns of Q2 held
               by the similarity its log defines
  4. solve     the main path: solve_tridiagonal_staged with the default
               (mixed-precision) SolverConfig, n=16384 random (bench.py's
               input, seed 0), all eigenpairs, cold then three times
               warm; residual, orthogonality and eigenvalues against
               scipy; the triage's column counts; launch counts of all
               thirteen kernels (interface_solve once a Spike pass and once
               a blocked solve, block_lu_solve exactly when a column is
               risky, deflation_tree once a merge level, cold and in each
               warm solve), each merge level's (k, m, K) and launches, the host
               time of the spike.interface_solve and refine.triage ranges;
               the same input solved twice more through the kernels and
               once with the scans' plain versions substituted here: V
               bit for bit the same
  5. solve_f64 the same input through the pure-f64 path
               (mixed_precision_vectors=False), cold then three times warm
  6. poisson   eigh_tridiagonal(eigvals_only=True) and the mixed path's full
               eigenpairs on the n=16384 Poisson matrix against its analytic
               spectrum (it deflates slowly: each level's K from m/2 to m,
               the widest non-root level full; wide cluster segments), with
               each merge level's (k, m, K)
  7. small_n   n=4096 and n=8192, random (bench.py's, seed 0) and Poisson,
               all eigenpairs, default config: the staged route and the
               fused route (part A one CUDA graph replay) side by side,
               each cold, then five warm rounds of one solve of each in
               turns (median), with phases, host syncs, launches, graph
               replays, peak memory and the three limits; two fused
               solves in a row return distinct, right V; one profiled warm
               solve of each route at n=8192; a capture under the profiler
  8. dense     the dense front end at full width: eigh of a random symmetric
               n=16384 matrix (seed 0) with the default config, all
               eigenpairs, cold with every check (residual, orthogonality,
               eigenvalues against torch.linalg.eigvalsh on the card), once
               warm, and once with the pure-f64 config (same checks);
               phases, peak memory, launches of all twenty kernels (the
               column step's three and dword_vecmat exactly
               householder_panel.column_launches(n, 32, 4): about two a
               column; larft once an apply_q panel);
               dense.tridiagonalize beside its bound (the matvecs' bytes at
               3.35 TB/s) and torch.linalg.eigh's time on the same matrix;
               then (dense_two_stage_full) the same matrix through
               eigh(band=128) and its band u=16 through eigh_banded, all
               eigenpairs, the three limits, phases, peak memory and
               launches (larft's beside panel_qr's), beside the
               one-stage walls; dense.apply_q2 of
               both beside its bound and its A operands' L2 traffic
  9. dense_two_stage  eigh(band=128) and eigh_banded (u=16) at n=4096, the
               same three limits (larft once a panel of reduce_to_band and
               of apply_q, band_chase once a chase, panel_qr once a panel,
               q2_blocks_t once a chunk of waves and q2_apply once a wave
               with a live block
               on both front ends: band_reduce.chase_launch_count,
               panel_qr_count and q2_wave_count); the host syncs of the
               chase and of the backtransform through Q2 on what each front
               end hands them (none);
               eigvals_only through both front ends; then
               dense_f32: eigh in float32 mode at n=4096, the JAX package's
               f32 grades (eigenvalues 1e-4, residual and orthogonality
               1e-3)
 10. profile   one more warm solve under torch.profiler, for the tridiagonal
               main path (n=16384) and for the dense path (n=4096): device
               time by kernel, the device's idle share, and the host time,
               device span and launches of the named ranges (at most 5
               launches a spike.interface_solve, under 100 in
               refine.triage); tridiagonalize alone at n=4096: its idle
               share and at most 3 device events a column
 11. staged_32768  the main path at n=32768 (bench.py's recipe, seed 0):
               the plain staged route (asserted), the same three limits,
               its peak memory beside 19.2 n^2 (n=16384's peak scaled)
 12. grouped   n=65536 full eigenpairs resident: the switch takes the
               grouped route on its own (asserted); its threshold, group
               width and groups, the refinement chunks the solve resolved,
               peak memory beside 8 n^2 + 12 n g (under the card's), the
               same three limits, launches, each level's K, triage counts
 13. streamed  solve_tridiagonal_streamed at n=65536, group=4096, halo=256:
               eigenvalues bit for bit the grouped phase's; per block the
               residual of every column, the block's Gram and its
               cross-Gram with the block before; a seeded sample of 8
               columns a block, orthogonal across all; peak memory
 14. cli_mtx   the CLI as a user runs it: phase 4's input written with the
               port's native MTX writer into build/cli/, read back bit for
               bit by the native and the Python readers, then
               ``python -m symmetric_eigenvalue_tpu_torch -i FILE -e OUT
               --profile-dir DIR`` in a subprocess: every residual and
               eigenvalue of the output file against phase 4's scipy
               spectrum (1e-12 ||T||), launches and device time of each
               kernel from the trace
 15. cli_select  -s 2 -n 16384 -eFILE with 2048 index lines (duplicates, 0,
               n+1, a non-integer): residuals on exactly the valid lines,
               eigenvalues against the analytic spectrum
 16. cli_f32   --f32 -s 1 -n 16384 -e, profiled: the JAX package's float32
               grades (eigenvalues 1e-4, residuals 1e-3 ||T|| against
               scipy's f64 spectrum), the merge and refinement kernels
               launched
 17. cli_profile  --profile-dir at n=4096 leaves a trace; a missing and a
               malformed -i return 1 with "Could not read input file:"
 18. cli_streamed  -s 2 -n 98304 -e in this process: the gate takes the
               streamed branch (the basis alone would be 77.3 GB); every
               residual and eigenvalue checked; peak, windows, phases
 19. mesh      phase 4's input over a mesh (dist/mesh.py): every card when
               two or more are visible, else cuda:0 x 4 (four logical
               shards of one card), default config, all eigenpairs: the
               cold solve with its three limits, eigenvalues against the
               unsharded port solve (1e-13 ||T||) and scipy's, launches of
               each kernel by shard and device (the merge, downsweep and
               replay kernels on every shard, the Spike passes on the lead
               device), per-device peaks, the slot-sharded top merges'
               tau bit for bit the unsharded merge's; three warm walls of
               each route in turns; host syncs of each and the lines that
               make them; the pure-f64 path (dword_matmul on every shard)
               and the Poisson eigenvalues over the same mesh
 20. mesh_grouped  n=65536 through the grouped route over the mesh:
               eigenvalues against the grouped phase's (1e-13 ||T||),
               residual in column chunks, per-device peaks, wall
 21. mesh_cli  -s 1 -n 16384 -e --devices <cards> in a subprocess against
               scipy's spectrum; --devices <cards + 1> returns 1 with its
               message
 22. mesh_multiprocess  with two or more cards: two processes (one card
               each, CUDA_VISIBLE_DEVICES) on NCCL through
               distributed_init, each solving phase 4's input over the
               two-process mesh and checking its eigenvalues and
               residual; with one card a line saying so, no work
 23. the per-kernel summary line, then the nvidia-smi line, then the final
     {"ok": true, ...} line

With ``--cli-only`` it builds every kernel, runs phases 14-18 and stops;
with ``--mesh-only`` phases 19-22 (phase 20 then solves n=65536 unsharded
first for its reference).

Needs one CUDA card; exits 1 without printing a result when
torch.cuda.is_available() is False.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import scipy.linalg
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu_torch import _build, driver
from symmetric_eigenvalue_tpu_torch.dist import mesh as tmesh
from symmetric_eigenvalue_tpu_torch.driver import _prescale
from symmetric_eigenvalue_tpu_torch.kernels import assemble
from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as br
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_matmul as cm
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_rowsum as cr
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as dm
from symmetric_eigenvalue_tpu_torch.kernels import deflation_tree as dtr
from symmetric_eigenvalue_tpu_torch.kernels import dword_matvec as dv
from symmetric_eigenvalue_tpu_torch.kernels import householder_panel as hp
from symmetric_eigenvalue_tpu_torch.kernels import rotation_replay as rr
from symmetric_eigenvalue_tpu_torch.kernels import secular as sec
from symmetric_eigenvalue_tpu_torch.kernels import secular_sums as ss
from symmetric_eigenvalue_tpu_torch.kernels import shifted_solve as shs
from symmetric_eigenvalue_tpu_torch.kernels import spike_solve as sp
from symmetric_eigenvalue_tpu_torch.kernels.refine import band_prep
from symmetric_eigenvalue_tpu_torch.kernels import tridiagonalize as tridiag_mod
from symmetric_eigenvalue_tpu_torch.kernels.tridiagonalize import _bucket_cuts
from symmetric_eigenvalue_tpu_torch.utils.checks import (
    max_cross_ortho_error, max_ortho_error)
from symmetric_eigenvalue_tpu_torch.utils.timing import PhaseTimer, sync

N = 16384
N_TWO_STAGE = 4096
N_LARGE = 32768         # the plain staged route, first size above N
N_HUGE = 65536          # the grouped and streamed routes (N65536_FULL.json)
STREAM_GROUP, STREAM_HALO = 4096, 256
SEED = 0
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): FP64 on the tensor
# cores (DMMA) and on the CUDA cores, FP32 on the CUDA cores, TF32 on the
# tensor cores, the HBM3 rate
PEAK_FP64_TENSOR = 67e12
PEAK_FP64 = 34e12
PEAK_FP32 = 67e12
PEAK_TF32_TENSOR = 495e12
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
    "dword_vecmat":
        "symmetric_eigenvalue_tpu/kernels/pallas/dword_matvec.py:127",
    # the Pallas kernel and the lax.while_loop around it
    # (symmetric_eigenvalue_tpu/kernels/secular.py:299-361)
    "secular_solve":
        "symmetric_eigenvalue_tpu/kernels/pallas/secular_sums.py:169",
    # a lax.fori_loop over the waves, no pallas_call
    "rotation_replay":
        "symmetric_eigenvalue_tpu/kernels/assemble.py:277",
    # the transposed chain of rows_through_merge, lax.fori_loops with no
    # pallas_call
    "rotation_replay_t":
        "symmetric_eigenvalue_tpu/kernels/assemble.py:106",
    # lax.scan loops of the refinement, no pallas_call
    "interface_solve":
        "symmetric_eigenvalue_tpu/kernels/refine.py:275",
    "block_lu_solve":
        "symmetric_eigenvalue_tpu/kernels/refine.py:124",
    # the dense reduction's column body and the T factor's loop, lax
    # fori_loops with no pallas_call
    "column_reflector":
        "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:114",
    "column_w":
        "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:114",
    "column_w_reflector":
        "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:114",
    "larft":
        "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:213",
    # the two-stage front end's wave loop and panel column loop, lax
    # fori_loops with no pallas_call
    "band_chase":
        "symmetric_eigenvalue_tpu/kernels/band_reduce.py:254",
    "panel_qr":
        "symmetric_eigenvalue_tpu/kernels/band_reduce.py:71",
    # the two-stage backtransform's wave loop, a lax.fori_loop with no
    # pallas_call: every block's T before the first wave, then the waves
    "q2_blocks_t":
        "symmetric_eigenvalue_tpu/kernels/band_reduce.py:509",
    "q2_apply":
        "symmetric_eigenvalue_tpu/kernels/band_reduce.py:509",
    # the merge's deflation tree, a Python loop over the tree levels
    # unrolled inside the jitted merge, no pallas_call
    "deflation_tree":
        "symmetric_eigenvalue_tpu/kernels/secular.py:106",
}
REPLACES_LOOP = {"secular_solve":
                 "symmetric_eigenvalue_tpu/kernels/secular.py:299-361",
                 "rotation_replay":
                 "symmetric_eigenvalue_tpu/kernels/assemble.py:319",
                 "rotation_replay_t":
                 "symmetric_eigenvalue_tpu/kernels/assemble.py:124,143",
                 "interface_solve":
                 "symmetric_eigenvalue_tpu/kernels/refine.py:317,329",
                 "block_lu_solve":
                 "symmetric_eigenvalue_tpu/kernels/refine.py:183,197",
                 "column_reflector":
                 "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:139,146",
                 "column_w":
                 "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:139,146",
                 "column_w_reflector":
                 "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:139,146",
                 "larft":
                 "symmetric_eigenvalue_tpu/kernels/tridiagonalize.py:227",
                 "band_chase":
                 "symmetric_eigenvalue_tpu/kernels/band_reduce.py:294",
                 "panel_qr":
                 "symmetric_eigenvalue_tpu/kernels/band_reduce.py:86",
                 "q2_blocks_t":
                 "symmetric_eigenvalue_tpu/kernels/band_reduce.py:606",
                 "q2_apply":
                 "symmetric_eigenvalue_tpu/kernels/band_reduce.py:606",
                 "deflation_tree":
                 "symmetric_eigenvalue_tpu/kernels/secular.py:150"}
SOURCES = {"spike_pass_a": "spike_solve", "spike_pass_b": "spike_solve",
           "cauchy_materialize": "cauchy_matmul",
           "dword_vecmat": "dword_matvec", "secular_solve": "secular_sums",
           "block_lu_solve": "spike_solve",
           "rotation_replay_t": "rotation_replay",
           "column_reflector": "householder_panel",
           "column_w": "householder_panel",
           "column_w_reflector": "householder_panel",
           "larft": "householder_panel",
           "band_chase": "band_reduce", "panel_qr": "band_reduce",
           "q2_blocks_t": "householder_panel"}
# the column step's matvec: the dword_vecmat source builds beside it
EXTRA_SOURCES = {"column_reflector": ("dword_matvec", "dword_matmul"),
                 "column_w": ("dword_matvec", "dword_matmul"),
                 "column_w_reflector": ("dword_matvec", "dword_matmul"),
                 "larft": ("dword_matmul",),
                 # the grid-sync yardstick; the whole reduce_to_band row
                 "band_chase": ("householder_panel", "dword_matmul"),
                 "panel_qr": ("householder_panel", "dword_matmul"),
                 # the chase makes their logs; the replaced loop's GEMMs
                 "q2_blocks_t": ("band_reduce", "q2_apply", "dword_matmul"),
                 "q2_apply": ("band_reduce", "householder_panel",
                              "dword_matmul"),
                 # the L2 round trip's yardstick; the solves' merge kernels
                 "deflation_tree": ("rotation_replay", "secular_sums",
                                    "cauchy_rowsum")}
KERNEL_NAMES = tuple(REPLACES)


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the script
    started (``elapsed_s``), so the lines show where the run's time goes."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T_START}
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


def device_ms_by_kernel(fn, reps: int):
    """Device time per call of ``fn`` by kernel name (torch.profiler: every
    kernel, copy and fill it launched), and the events per call, over
    ``reps`` calls after one warm-up.  A window that recorded no device
    event at all (the profiler drops one now and then) is profiled again,
    up to three times."""
    fn()
    torch.cuda.synchronize()
    times, events = {}, 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times, events = {}, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA \
                    and ev.self_device_time_total > 0:
                times[ev.key] = ev.self_device_time_total * 1e-3 / reps
                events += ev.count
        if times:
            break
    return times, events / reps


def device_ms(fn, reps: int, only: str = "") -> float:
    """Device time per call of ``fn``, of the kernels whose name holds
    ``only`` (all by default).  Beside ``time_ms`` it shows a call whose
    time is its host's, not its kernels'."""
    times, _ = device_ms_by_kernel(fn, reps)
    return sum(t for name, t in times.items() if only in name)


def bound(ops: float, peak: float, nbytes: float):
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def launch_counts():
    return {"secular_sums": ss.launches,
            "secular_solve": ss.solve_launches,
            "cauchy_rowsum": cr.launches,
            "dword_matmul": dm.launches,
            "cauchy_matmul": cm.matmul_launches,
            "cauchy_materialize": cm.materialize_launches,
            "spike_pass_a": sp.pass_a_launches,
            "spike_pass_b": sp.pass_b_launches,
            "dword_vecmat": dv.launches,
            "rotation_replay": rr.launches,
            "rotation_replay_t": rr.t_launches,
            "interface_solve": shs.interface_launches,
            "block_lu_solve": shs.block_lu_launches,
            "column_reflector": hp.reflector_launches,
            "column_w": hp.w_launches,
            "column_w_reflector": hp.w_reflector_launches,
            "larft": hp.larft_launches,
            "band_chase": br.chase_launches,
            "panel_qr": br.panel_qr_launches,
            "q2_blocks_t": br.q2_blocks_t_launches,
            "q2_apply": br.q2_apply_launches,
            "deflation_tree": dtr.launches}


def reset_counts() -> None:
    ss.launches = ss.solve_launches = 0
    cr.launches = dm.launches = dv.launches = 0
    cm.matmul_launches = cm.materialize_launches = 0
    sp.pass_a_launches = sp.pass_b_launches = 0
    rr.launches = rr.t_launches = 0
    shs.interface_launches = shs.block_lu_launches = 0
    hp.reflector_launches = hp.w_launches = hp.w_reflector_launches = 0
    hp.larft_launches = 0
    br.chase_launches = br.panel_qr_launches = 0
    br.q2_blocks_t_launches = br.q2_apply_launches = 0
    dtr.launches = 0


def random_matrix(n: int, seed: int):
    """bench.py's random input: d ~ 5 N(0, 1), e ~ 2 N(0, 1)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) * 5.0, rng.standard_normal(n - 1) * 2.0


# --------------------------------------------------------------------------
# kernels of the eigenvalue phase and the f64 downsweep

def check_secular_sums(k, m, reps, kact=None):
    """Roots at every slot (shift = own pole, sl = slot), tau inside the
    gap, a few roots 1e-13 from their pole: as the top / bottom merge
    levels give them.  ``kact``: the active count K of every merge (z2 zero
    and sentinel poles past it, as merge_partition leaves them; the sweeps
    stop at K), also held against the same call over all m poles."""
    g = np.random.default_rng(1)
    dev = "cuda"
    kact = m if kact is None else kact
    poles = np.sort(g.standard_normal((k, m)), axis=1)
    top = np.abs(poles).max() * 4.0 + 4.0
    poles[:, kact:] = top + 1e-3 * np.arange(kact, m)
    gaps = np.diff(poles, axis=1, append=poles[:, -1:] + 1.0)
    tau = 0.45 * gaps * g.random((k, m)) + 1e-15
    tau[:, ::997] = 1e-13
    z2 = (0.1 * g.standard_normal((k, m))) ** 2
    z2[:, kact:] = 0.0
    sl = np.tile(np.arange(m), (k, 1))
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    K = torch.full((k,), kact, dtype=torch.int64, device=dev)
    args = (t(poles), t(z2), t(poles), t(tau), t(sl, torch.int64), K)
    got = ss.secular_sums(*args)
    ref = ss.secular_sums_plain(*args)
    full = ss.secular_sums(*args[:5], torch.full_like(K, m))
    skip_exact = all(bool(torch.equal(x, y)) for x, y in zip(got, full))
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
    same = all(bool(torch.equal(x, y))
               for x, y in zip(got, ss.secular_sums(*args)))
    ms = time_ms(lambda: ss.secular_sums(*args), reps)
    dms = device_ms(lambda: ss.secular_sums(*args), reps)
    plain = time_ms(lambda: ss.secular_sums_plain(*args), max(1, reps // 4))
    # every (root, pole) pair swept issues one term's FP64 instructions
    # (SASS of the term yardstick) at the FP64 instruction rate
    per_term = secular_fp64_per_term()
    nbytes = 8.0 * (2 * k * kact + 3 * k * m + 4 * k * m) + 8.0 * k
    b_ms, b_by = bound(per_term * k * m * kact, fp64_rate(), nbytes)
    return dict(k=k, m=m, B=m, K=kact, max_rel_err=err, tol=1e-12,
                max_abs_err=abs_err, skip_bit_exact=skip_exact,
                run_to_run_identical=same, ms=ms, device_ms=dms,
                plain_ms=plain, fp64_instr_per_term=per_term,
                bound_ms=b_ms, bound_by=b_by)


def rowsum_inputs(k, m, kact, seed=2):
    """Merge-like inputs of cauchy_rowsum: sorted poles, every root's shift
    its own pole and tau inside the gap (every denominator nonzero), a few
    roots 1e-13 from their pole, R=2 weight rows, 0 past K = ``kact`` (as
    the caller's zhat is)."""
    g = np.random.default_rng(seed)
    poles = np.sort(g.standard_normal((k, m)), axis=1)
    gaps = np.diff(poles, axis=1, append=poles[:, -1:] + 1.0)
    tau = 0.45 * gaps * g.random((k, m)) + 1e-15
    tau[:, ::997] = 1e-13
    wz = 0.2 * g.standard_normal((k, 2, m))
    wz[:, :, kact:] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    return (t(poles), t(poles), t(tau), t(wz),
            torch.full((k,), kact, dtype=torch.int64, device="cuda"))


def check_cauchy_rowsum(args, reps, what, plain_reps=None):
    """cauchy_rowsum on (poles, shift, tau, wz, K) against its plain
    version; the K cut bit for bit the same launch with K = m on the
    columns below K, and exactly 0 past K; two runs identical; its launch
    plan; and a bound from the terms these inputs need (sum_b K_b^2, each
    the FP64 instructions of the SASS term yardstick) or its bytes."""
    wz, K = args[3:]
    k, R, m = wz.shape
    got = cr.cauchy_rowsum(*args)
    again = cr.cauchy_rowsum(*args)
    full = cr.cauchy_rowsum(*args[:4], torch.full_like(K, m))
    ref = cr.cauchy_rowsum_plain(*args)
    live = (torch.arange(m, device=K.device)[None, :]
            < K[:, None])[:, None, :].expand_as(got)
    abs_err = float((got - ref).abs().max())
    err = abs_err / max(float(ref.abs().max()), 1e-300)
    ms = time_ms(lambda: cr.cauchy_rowsum(*args), reps)
    dms = device_ms(lambda: cr.cauchy_rowsum(*args), reps)
    plain = time_ms(lambda: cr.cauchy_rowsum_plain(*args),
                    plain_reps or reps)
    Ks = K.clamp(0, m).tolist()
    per_term = rowsum_fp64_per_term(R)
    terms = float(sum(x * x for x in Ks))
    b_ms, b_by = bound(terms * per_term, fp64_rate(),
                       8.0 * (3 + R) * sum(Ks) + 8.0 * k * R * m)
    plan = cr.launch_plan(k, m, *cr._capacity(0, R))
    regs, local, per_sm = cr.kernel_info(R)
    return dict(inputs=what, k=k, m=m, rows=R, K_sum=sum(Ks),
                K_max=max(Ks), max_rel_err=err, tol=1e-12,
                tol_of="max |S| of the plain version", max_abs_err=abs_err,
                skip_bit_exact=bool(torch.equal(got[live], full[live])),
                zeros_past_K=not bool(got[~live].any()),
                run_to_run_identical=bool(torch.equal(got, again)),
                splits=plan.splits, chunk=plan.chunk, registers=regs,
                local_bytes=local, blocks_per_sm=per_sm,
                terms=terms, fp64_instr_per_term=per_term, ms=ms,
                device_ms=dms, plain_ms=plain, library_ms=None,
                bound_ms=b_ms, bound_by=b_by)


@contextlib.contextmanager
def recorded_rowsums():
    """Copies of the arguments of every cauchy_rowsum call made inside the
    block: in a solve, one call a non-root level of its upsweep."""
    seen = []
    inner = assemble.cauchy_rowsum

    def recorded(*args):
        seen.append(tuple(a.clone() for a in args))
        return inner(*args)

    assemble.cauchy_rowsum = recorded
    try:
        yield seen
    finally:
        assemble.cauchy_rowsum = inner


def rowsum_level_rows(d, e, what):
    """check_cauchy_rowsum on every non-root level of one mixed solve of
    (d, e), on that level's own inputs, and one line with their sums."""
    with recorded_rowsums() as seen:
        st.solve_tridiagonal_staged(d, e, compute_vectors=True)
    rows = [check_cauchy_rowsum(args, 20,
                                f"{what}, level m={args[0].shape[1]}",
                                plain_reps=3) for args in seen]
    del seen
    torch.cuda.empty_cache()
    emit({"phase": "cauchy_rowsum_levels", "solve": what,
          "launches": len(rows),
          **{f"{key}_sum": sum(r[key] for r in rows)
             for key in ("terms", "ms", "device_ms", "plain_ms", "bound_ms")}})
    return rows


def check_dword_matmul(k, M, K, N, reps):
    g = torch.Generator(device="cuda").manual_seed(3)
    A = torch.randn((k, M, K), dtype=torch.float64, device="cuda", generator=g)
    B = torch.randn((k, K, N), dtype=torch.float64, device="cuda", generator=g)
    got = dm.dword_matmul(A, B)
    ref = dm.dword_matmul_plain(A, B)
    scale = torch.matmul(A.abs(), B.abs())
    err = float(((got - ref).abs() / scale).max())
    abs_err = float((got - ref).abs().max())
    same = bool(torch.equal(got, dm.dword_matmul(A, B)))
    del scale, got, ref
    ms = time_ms(lambda: dm.dword_matmul(A, B), reps)
    dms = device_ms(lambda: dm.dword_matmul(A, B), reps)
    plain = time_ms(lambda: dm.dword_matmul_plain(A, B), reps)
    library = time_ms(lambda: torch.matmul(A, B), reps)
    lib_dms = device_ms(lambda: torch.matmul(A, B), reps)
    b_ms, b_by = bound(2.0 * k * M * N * K, PEAK_FP64_TENSOR,
                       8.0 * k * (M * K + K * N + M * N))
    plan = dm.split_plan(k, M, N, K)
    return dict(k=k, M=M, K=K, N=N, max_rel_err=err, tol=1e-12,
                tol_of="(|A| @ |B|) per entry", max_abs_err=abs_err,
                run_to_run_identical=same, tile_rows=plan.tile_rows,
                splits=plan.splits, blocks=plan.blocks, ms=ms, device_ms=dms,
                plain_ms=plain, library_ms=library,
                library_device_ms=lib_dms, bound_ms=b_ms, bound_by=b_by)


def check_dword_matmul_sub(M, K, N, offset, reps):
    """The fused trailing update C -= A @ B with C a view of a larger
    matrix (``offset`` rows and columns in: a bucket of the dense
    reduction), against C.sub_(A @ B)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    A = torch.randn((M, K), dtype=torch.float64, device="cuda", generator=g)
    B = torch.randn((K, N), dtype=torch.float64, device="cuda", generator=g)
    base = torch.randn((M + offset, N + offset), dtype=torch.float64,
                       device="cuda", generator=g)
    C = base[offset:, offset:]
    want = dm.dword_matmul_sub_plain_(C.clone(), A, B)
    before = base.clone()
    require(dm.dword_matmul_sub_(C, A, B).data_ptr() == C.data_ptr(),
            "dword_matmul_sub_ is not in place")
    first = C.clone()
    scale = torch.matmul(A.abs(), B.abs()).add_(before[offset:, offset:].abs())
    diff = (first - want).abs()
    err = float((diff / scale).max())
    abs_err = float(diff.max())
    # nothing outside the view was touched
    outside = bool(torch.equal(base[:offset], before[:offset])
                   and torch.equal(base[:, :offset], before[:, :offset]))
    del scale, diff, want
    base.copy_(before)
    same = bool(torch.equal(dm.dword_matmul_sub_(C, A, B), first))
    del before, first
    ms = time_ms(lambda: dm.dword_matmul_sub_(C, A, B), reps)
    dms = device_ms(lambda: dm.dword_matmul_sub_(C, A, B), reps)
    plain = time_ms(lambda: dm.dword_matmul_sub_plain_(C, A, B), reps)
    lib_dms = device_ms(lambda: dm.dword_matmul_sub_plain_(C, A, B), reps)
    product = time_ms(lambda: torch.matmul(A, B), reps)
    b_ms, b_by = bound(2.0 * M * N * K, PEAK_FP64_TENSOR,
                       8.0 * (M * K + K * N + 2 * M * N))
    plan = dm.split_plan(1, M, N, K)
    return dict(form="C -= A @ B", M=M, K=K, N=N, view_offset=offset,
                row_stride=C.stride(0), max_rel_err=err, tol=1e-12,
                tol_of="(|C| + |A| @ |B|) per entry", max_abs_err=abs_err,
                outside_view_untouched=outside, run_to_run_identical=same,
                tile_rows=plan.tile_rows, splits=plan.splits, ms=ms,
                device_ms=dms, plain_ms=plain, library_ms=plain,
                library_device_ms=lib_dms,
                library_is="C.sub_(torch.matmul(A, B)): the product "
                "written out, then subtracted", library_product_ms=product,
                bound_ms=b_ms, bound_by=b_by)


def check_dword_vecmat(m, zeros, sliced, reps):
    """The Householder matvec of the dense reduction at a bucket's width m:
    a symmetric A and a v whose first ``zeros`` entries are zero, as a
    reflector has them.  ``sliced``: pass only the rows below the zeros (a
    view with a row offset), the call the reduction makes."""
    g = torch.Generator(device="cuda").manual_seed(10)
    A = torch.randn((m, m), dtype=torch.float64, device="cuda", generator=g)
    A = (A + A.T).div_(2.0 * m ** 0.5)
    v = torch.randn(m, dtype=torch.float64, device="cuda", generator=g)
    v[:zeros] = 0.0
    v[zeros] = 1.0
    args = (v[zeros:], A[zeros:]) if sliced else (v, A)
    rows = args[1].shape[0]
    got = dv.dword_vecmat(*args)
    ref = dv.dword_vecmat_plain(*args)
    scale = torch.matmul(v.abs(), A.abs())
    abs_err = float((got - ref).abs().max())
    err = float(((got - ref).abs() / scale).max())
    again = dv.dword_vecmat(*args)
    # both against an extended-precision product on the host (256 columns)
    cols = slice(0, 256)
    exact = args[0].cpu().numpy().astype(np.longdouble) \
        @ args[1][:, cols].cpu().numpy().astype(np.longdouble)
    sc = scale[cols].cpu().numpy()
    exact_err = [float(np.abs(y[cols].cpu().numpy() - exact).max() / sc.max())
                 for y in (got, ref)]
    before = dv.launches
    dv.dword_vecmat(*args)
    one_launch = dv.launches - before == 1
    ms = time_ms(lambda: dv.dword_vecmat(*args), reps)
    dms = device_ms(lambda: dv.dword_vecmat(*args), reps)
    plain = time_ms(lambda: dv.dword_vecmat_plain(*args), reps)
    # cuBLAS dgemv in both orientations (A is symmetric: the same function)
    lib_vm = time_ms(lambda: torch.matmul(*args), reps)
    lib_mv = time_ms(lambda: torch.mv(args[1].T, args[0]), reps)
    # a profile that caught no device event (seen once) is not a time
    lib_dms = min((t for t in (
        device_ms(lambda: torch.matmul(*args), reps),
        device_ms(lambda: torch.mv(args[1].T, args[0]), reps)) if t > 0),
        default=None)
    plan = dv._plan(rows, m, *dv._capacity(0))
    b_ms, b_by = bound(2.0 * rows * m, PEAK_FP64, 8.0 * (rows * m + rows + m))
    return dict(m=m, rows=rows, leading_zeros=zeros, sliced=sliced,
                max_rel_err=err, tol=1e-13, tol_of="(|v| @ |A|) per entry",
                max_abs_err=abs_err, kernel_vs_longdouble=exact_err[0],
                plain_vs_longdouble=exact_err[1],
                run_to_run_identical=bool(torch.equal(got, again)),
                one_launch=one_launch, row_stride=args[1].stride(0),
                rows_per_chunk=plan.rows_per_chunk, chunks=plan.chunks,
                col_tiles=plan.col_tiles,
                ms=ms, device_ms=dms, plain_ms=plain,
                library_ms=min(lib_vm, lib_mv), library_device_ms=lib_dms,
                library_vecmat_ms=lib_vm, library_mv_ms=lib_mv,
                library_is="torch.matmul(v, A) / torch.mv(A.T, v), cuBLAS "
                "dgemv", bound_ms=b_ms, bound_by=b_by)


# --------------------------------------------------------------------------
# the dense reduction's column step and larft (csrc/householder_panel.cu)


def panel_state(m: int, o: int, jj: int, base: int = 0, seed: int = 11,
                zero_below: bool = False, nb: int = 32, done=None):
    """The state of a bucket at column j = o + jj of the panel at o, made on
    the card: a symmetric A (``base`` > 0: As is the strided view A[base:,
    base:] of a larger matrix, as a later bucket), the panel's first
    ``done`` (default jj) columns reduced by the plain loop (with the
    dword_vecmat kernel as matvec), Vtb, Wbuf, te as ``_tridiagonalize_block``
    holds them.  ``zero_below``: columns o .. j have nothing below their
    subdiagonal (sigma2 == 0 at each: no delayed update fills it in)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = m + base
    A = torch.randn((full, full), dtype=torch.float64, device="cuda",
                    generator=g)
    A = (A + A.T).div_(2.0 * full ** 0.5)
    As = A[base:, base:]
    j = o + jj
    if zero_below:
        for c in range(o, j + 1):
            As[c, c + 2:] = 0.0
            As[c + 2:, c] = 0.0
    ncols = j + 1
    Vtb = As.new_zeros((ncols, m))
    te = As.new_zeros((ncols, 2))
    Wbuf = As.new_zeros((nb, m))
    Wbuf.normal_(generator=g)        # stale rows of an earlier panel
    plain = hp._PlainSteps(As, Vtb, Wbuf, te)
    for c in range(o, o + (jj if done is None else done)):
        plain(c, o)
    return A, As, Vtb, Wbuf, te


def _state_copy(state):
    A, As, Vtb, Wbuf, te = state
    A2 = A.clone()
    base = A.shape[0] - As.shape[0]
    return A2, A2[base:, base:], Vtb.clone(), Wbuf.clone(), te.clone()


def _rel(got, ref):
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / (scale if scale > 0 else 1.0)


def check_fused(state, o: int, jj: int, base_row, reps: int, nb: int):
    """column_w_reflector (the W row of column j - 1, then the reflector of
    column j = o + jj) from identical inputs against column_w_plain then
    column_reflector_plain on the card.  ``state``: the panel with columns
    before j - 1 reduced; column j - 1's reflector is made here by the
    kernel, as the path makes it, so the fused launch finds its (p, q) in
    the step's buffer, and y by the plain matvec.  The (p, q) the launch
    leaves are held against Wp v and Vp v of the plain result (to 1e-13 of
    |Wp| |v|).  The timed calls restore (p, q) first (a copy, left out of
    ``device_ms``)."""
    j = o + jj
    m = state[1].shape[0]
    identity = j == m - 2
    kern = _state_copy(state)
    _, As_k, Vtb_k, Wbuf_k, te_k = kern
    ks = hp._CudaSteps(As_k, Vtb_k, Wbuf_k, te_k, nb)
    ks.column_reflector(j - 1, o)
    ks.y.copy_(dv.dword_vecmat_plain(Vtb_k[j - 1, j:], As_k[j:]))
    torch.cuda.synchronize()
    pq0 = ks.pq.clone()
    plain = _state_copy(kern)
    _, As_p, Vtb_p, Wbuf_p, te_p = plain
    before = hp.w_reflector_launches
    ks.column_w_reflector(j - 1, o)
    hp.column_w_plain(Vtb_p[o:], Wbuf_p, te_p, ks.y.clone(), j - 1, jj - 1)
    hp.column_reflector_plain(As_p, Vtb_p[o:], Wbuf_p, te_p, j, jj)
    torch.cuda.synchronize()
    one = hp.w_reflector_launches - before == 1
    errs = {"W_row": _rel(Wbuf_k[jj - 1], Wbuf_p[jj - 1]),
            "v": _rel(Vtb_k[j], Vtb_p[j]),
            "tau": _rel(te_k[j, 0], te_p[j, 0]),
            "alpha": _rel(te_k[j, 1], te_p[j, 1])}
    if identity:
        errs["W_row_zero"] = float(Wbuf_k[jj].abs().max())
        errs["v_untouched"] = float(Vtb_k[j].abs().max())
    else:
        v, Vp, Wp = Vtb_p[j], Vtb_p[o:j], Wbuf_p[:jj]
        for name, got, rows in (("p", ks.pq[:jj], Wp),
                                ("q", ks.pq[jj:2 * jj], Vp)):
            scale = float((rows.abs() @ v.abs()).max())
            errs[name] = float((got - rows @ v).abs().max()) / (
                scale if scale > 0 else 1.0)
    out = (Wbuf_k[jj - 1].clone(), Vtb_k[j].clone(), te_k[j].clone(),
           ks.pq[:2 * jj].clone())

    def run():
        ks.pq.copy_(pq0)
        ks.column_w_reflector(j - 1, o)

    run()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out, (
        Wbuf_k[jj - 1], Vtb_k[j], te_k[j], ks.pq[:2 * jj])))
    ms = time_ms(run, reps)
    dms = device_ms(run, reps, only="column_step_kernel")
    work = _state_copy(plain)
    y = ks.y.clone()
    plain_ms = time_ms(lambda: (
        hp.column_w_plain(work[2][o:], work[3], work[4], y.clone(), j - 1,
                          jj - 1),
        hp.column_reflector_plain(work[1], work[2][o:], work[3], work[4], j,
                                  jj)), reps)
    rows_in = m - j - 1
    b_ms, b_by = bound(
        4.0 * (jj - 1) * m + 4.0 * m + 4.0 * jj * rows_in + 6.0 * rows_in,
        PEAK_FP64,
        8.0 * (2 * (jj - 1) * m + 3 * m - j + 2 * rows_in + 2 * jj + 4))
    return dict(base_row, j=j, w_column=j - 1, max_rel_err=max(errs.values()),
                errors=errs, tol=1e-13,
                tol_of="max|row| (|tau|, |alpha|; |Wp| |v| for p, q)",
                max_abs_err=max(float((Wbuf_k[jj - 1] - Wbuf_p[jj - 1])
                                      .abs().max()),
                                float((Vtb_k[j] - Vtb_p[j]).abs().max()),
                                float((te_k[j] - te_p[j]).abs().max())),
                one_launch=one, run_to_run_identical=same, ms=ms,
                ms_includes="a copy restoring (p, q)", device_ms=dms,
                device_ms_is="the column step kernel's alone",
                plain_ms=plain_ms, plain_includes="a copy of y",
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                plan=ks.plan._asdict())


def check_column_step(m: int, jj: int, what: str, base: int = 0,
                      zero_below: bool = False, o: int = 0, reps: int = 20,
                      nb: int = 32):
    """One column step from identical inputs, the kernels against the plain
    versions on the card: column_reflector's v, tau, alpha (and the identity
    column's alpha and zeroed W row at j = m - 2), then column_w's W row
    from the same v and y (y by the plain matvec), and (jj > 0)
    column_w_reflector's W row of column j - 1 and reflector of column j
    (:func:`check_fused`).  Returns the (column_reflector, column_w,
    column_w_reflector) rows, None where the shape has none; each error is
    relative to max|row| (|tau|, |alpha| for the scalars)."""
    j = o + jj
    identity = j == m - 2
    base_row = dict(m=m, j=j, jj=jj, nb=nb, what=what,
                    identity_column=identity, sigma2_zero=zero_below)
    r2 = None
    if jj:
        state = panel_state(m, o, jj, base, zero_below=zero_below, nb=nb,
                            done=jj - 1)
        r2 = check_fused(state, o, jj, base_row, reps, nb)
        _, As, Vtb, Wbuf, te = state
        hp._PlainSteps(As, Vtb, Wbuf, te)(j - 1, o)
    else:
        state = panel_state(m, o, jj, base, zero_below=zero_below, nb=nb)
    kern, plain = _state_copy(state), _state_copy(state)
    del state
    _, As_k, Vtb_k, Wbuf_k, te_k = kern
    _, As_p, Vtb_p, Wbuf_p, te_p = plain
    ks = hp._CudaSteps(As_k, Vtb_k, Wbuf_k, te_k, nb)
    before = hp.reflector_launches
    ks.column_reflector(j, o)
    hp.column_reflector_plain(As_p, Vtb_p[o:], Wbuf_p, te_p, j, jj)
    torch.cuda.synchronize()
    one = hp.reflector_launches - before == 1
    errs = {"v": _rel(Vtb_k[j], Vtb_p[j]),
            "tau": _rel(te_k[j, 0], te_p[j, 0]),
            "alpha": _rel(te_k[j, 1], te_p[j, 1])}
    again = te_k[j].clone(), Vtb_k[j].clone()
    ks.column_reflector(j, o)
    same = bool(torch.equal(again[0], te_k[j])
                and torch.equal(again[1], Vtb_k[j]))
    rows_in = m - j - 1
    ms = time_ms(lambda: ks.column_reflector(j, o), reps)
    dms = device_ms(lambda: ks.column_reflector(j, o), reps)
    work = _state_copy(plain)
    plain_ms = time_ms(lambda: hp.column_reflector_plain(
        work[1], work[2][o:], work[3], work[4], j, jj), reps)
    b_ms, b_by = bound(4.0 * jj * rows_in + 6.0 * rows_in, PEAK_FP64,
                       8.0 * (rows_in * (2 * jj + 2) + 2))
    base_row["row_stride"] = As_k.stride(0)
    if r2 is not None:
        r2["row_stride"] = As_k.stride(0)
    if identity:
        errs["W_row"] = _rel(Wbuf_k[jj], Wbuf_p[jj])
        errs["W_row_zero"] = float(Wbuf_k[jj].abs().max())
        errs["v_untouched"] = float(Vtb_k[j].abs().max())
    if zero_below:
        errs["no_op_tau"] = float(te_k[j, 0].abs())
    r1 = dict(base_row, max_rel_err=max(errs.values()), errors=errs,
              tol=1e-13, tol_of="max|row| (|tau|, |alpha|)",
              max_abs_err=max(float((Vtb_k[j] - Vtb_p[j]).abs().max()),
                              float((te_k[j] - te_p[j]).abs().max())),
              one_launch=one, run_to_run_identical=same, ms=ms,
              device_ms=dms, plain_ms=plain_ms, library_ms=None,
              bound_ms=b_ms, bound_by=b_by, plan=ks.plan._asdict())
    if identity:
        return r1, None, r2
    # column_w on the kernel's v, with the same y for both
    y = dv.dword_vecmat_plain(Vtb_k[j, j + 1:], As_k[j + 1:])
    wstate = (Vtb_k.clone(), Wbuf_k.clone(), te_k.clone())
    ks.y.copy_(y)
    before = hp.w_launches
    ks.column_w(j, o)
    hp.column_w_plain(wstate[0][o:], wstate[1], wstate[2], y.clone(), j, jj)
    torch.cuda.synchronize()
    one = hp.w_launches - before == 1
    err_w = _rel(Wbuf_k[jj], wstate[1][jj])
    abs_w = float((Wbuf_k[jj] - wstate[1][jj]).abs().max())
    again = Wbuf_k[jj].clone()
    ks.column_w(j, o)
    same = bool(torch.equal(again, Wbuf_k[jj]))
    ms = time_ms(lambda: ks.column_w(j, o), reps)
    dms = device_ms(lambda: ks.column_w(j, o), reps)
    plain_ms = time_ms(lambda: hp.column_w_plain(
        wstate[0][o:], wstate[1], wstate[2], y.clone(), j, jj), reps)
    b_ms, b_by = bound(4.0 * jj * m + 4.0 * m, PEAK_FP64,
                       8.0 * ((2 * jj + 2) * m + rows_in))
    r3 = dict(base_row, max_rel_err=err_w, tol=1e-13, tol_of="max|W row|",
              max_abs_err=abs_w, one_launch=one, run_to_run_identical=same,
              ms=ms, device_ms=dms,
              plain_ms=plain_ms, plain_includes="a copy of y (the plain "
              "version overwrites it)", library_ms=None, bound_ms=b_ms,
              bound_by=b_by)
    return r1, r3, r2


@functools.lru_cache(maxsize=1)
def column_step_rows():
    """The column step's rows: m=16384 at jj = 0, 15, 31; a later bucket's
    strided view (m=12288 inside 16384); sigma2 == 0 forced at a panel's
    first column and inside a panel (the fused launch's no-op branch); the
    identity column j = m - 2 (its reflector alone and fused after the
    column before it); and a panel of 512 columns (eigh(panel=512): panel
    rows past what a block caches in shared memory, read from L2).
    Returns the rows of (column_reflector, column_w, column_w_reflector)."""
    rows = [check_column_step(N, 15, "mid panel"),
            check_column_step(N, 0, "first column of a panel"),
            check_column_step(N, 31, "last column of a panel"),
            check_column_step(12288, 31, "bucket start: strided view",
                              base=N - 12288),
            check_column_step(N, 0, "sigma2 == 0 forced", zero_below=True,
                              o=4096),
            check_column_step(N, 1, "sigma2 == 0 forced, inside a panel",
                              zero_below=True, o=4096),
            check_column_step(N, 30, "identity column j = m - 2",
                              o=N - 32, reps=50),
            check_column_step(4096, 300, "wide panel (nb=512)", nb=512)]
    return tuple([r[k] for r in rows if r[k] is not None] for k in range(3))


def whole_panel_row(m: int = N, nb: int = 32, reps: int = 5):
    """A whole panel of nb columns at the start of an m-wide bucket through
    the kernels' schedule (``_CudaSteps.panel``: a lone reflector, the
    matvec and a fused launch a column, a lone W row) against the plain
    loop (the same matvec kernel) on the card: Vtb, te and the W rows
    within 1e-13 of their largest entries, run-to-run identical; launches;
    device time a column by kernel; the cost of a grid sync at the plan's
    grid (grid_sync_probe: 0 and 100 syncs in one cooperative launch)."""
    A = dense_matrix(m, SEED + 9)
    g = torch.Generator(device="cuda").manual_seed(13)
    stale = torch.randn((nb, m), dtype=torch.float64, device="cuda",
                        generator=g)

    def fresh():
        return (A.clone(), A.new_zeros((nb, m)), stale.clone(),
                A.new_zeros((nb, 2)))

    kern, plain = fresh(), fresh()
    ks = hp._CudaSteps(*kern, nb)
    reset_counts()
    ks.panel(0, nb)
    launches = {k: v for k, v in launch_counts().items() if v}
    hp._PlainSteps(*plain).panel(0, nb)
    torch.cuda.synchronize()
    errs = {name: _rel(kern[i], plain[i])
            for i, name in ((1, "Vtb"), (2, "W_rows"), (3, "te"))}
    abs_err = max(float((kern[i] - plain[i]).abs().max()) for i in (1, 2, 3))
    again = fresh()
    hp._CudaSteps(*again, nb).panel(0, nb)
    torch.cuda.synchronize()
    same = all(torch.equal(kern[i], again[i]) for i in (1, 2, 3))
    del again, plain
    ms = time_ms(lambda: ks.panel(0, nb), reps)
    by_kernel, events = device_ms_by_kernel(lambda: ks.panel(0, nb), reps)
    step_ms = sum(t for k, t in by_kernel.items()
                  if "column_step_kernel" in k)
    vecmat_ms = sum(t for k, t in by_kernel.items() if "vecmat" in k)
    grid = ks.plan.grid
    sync0 = time_ms(lambda: hp.grid_sync_probe(grid, 0), 50)
    sync100 = time_ms(lambda: hp.grid_sync_probe(grid, 100), 20)
    work = fresh()
    plain_ms = time_ms(lambda: hp._PlainSteps(*work).panel(0, nb), 2)
    vec_bytes = sum(8.0 * (m - j - 1) * m for j in range(nb))
    b_ms, b_by = bound(vec_bytes / 4.0, PEAK_FP64, vec_bytes)
    return dict(m=m, nb=nb, what=f"a whole {nb}-column panel at m={m}, "
                "the kernels' schedule", max_rel_err=max(errs.values()),
                errors=errs, tol=1e-13, tol_of="max|Vtb|, max|W rows|, "
                "max|te|", max_abs_err=abs_err,
                run_to_run_identical=same, launches=launches,
                ms=ms, device_ms=sum(by_kernel.values()),
                device_events=events,
                column_step_device_ms_per_column=step_ms / nb,
                vecmat_device_ms_per_column=vecmat_ms / nb,
                device_ms_by_kernel=by_kernel,
                empty_cooperative_launch_ms=sync0,
                grid_sync_us=(sync100 - sync0) * 10.0,
                plan=ks.plan._asdict(), plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                bound_is="the panel's matvecs' bytes")


def whole_reduction_row(n: int = 1024, reps: int = 3):
    """A whole tridiagonalize at n, the kernels' column step against the
    plain one (both with the dword_vecmat kernel as matvec) on the card:
    d, e, Vt and taus within 2e-12 n max|A| (the CPU test's bound)."""
    A = dense_matrix(n, SEED + 7)
    got = tridiag_mod.tridiagonalize(A)
    with plain_column_steps():
        ref = tridiag_mod.tridiagonalize(A)
    scale = n * float(A.abs().max())
    errs = {name: float((g - r).abs().max()) for name, g, r in
            zip(("d", "e", "Vt", "taus"), got, ref)}
    ms = 1e3 * min(timed(lambda: tridiag_mod.tridiagonalize(A))
                   for _ in range(reps))
    dms = device_ms(lambda: tridiag_mod.tridiagonalize(A), 1)
    with plain_column_steps():
        plain = 1e3 * min(timed(lambda: tridiag_mod.tridiagonalize(A))
                          for _ in range(reps))
    b_ms, b_by = bound(2.0 * vecmat_stream_bytes(n, 32, 1) / 8.0, PEAK_FP64,
                       vecmat_stream_bytes(n, 32, 1))
    return dict(m=n, what=f"whole tridiagonalize, n={n}",
                max_rel_err=max(errs.values()) / scale, tol=2e-12,
                tol_of="n max|A| (the CPU test's bound)",
                errors=errs, max_abs_err=max(errs.values()),
                ms=ms, ms_is="host wall of the whole reduction (min of "
                f"{reps})", device_ms=dms, plain_ms=plain, library_ms=None,
                bound_ms=b_ms, bound_by=b_by,
                bound_is="the matvecs' bytes (vecmat_stream_bytes)")


def timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@contextlib.contextmanager
def plain_column_steps():
    """The reduction's column step as the plain loop on CUDA tensors (the
    loop the kernels replaced), for a comparison on the card."""
    saved = tridiag_mod.column_steps
    tridiag_mod.column_steps = lambda As, Vtb, Wbuf, te, nb: \
        hp._PlainSteps(As, Vtb, Wbuf, te)
    try:
        yield
    finally:
        tridiag_mod.column_steps = saved


def larft_inputs(nb: int, width: int):
    """An apply_q panel's Gram and taus: nb reflectors over ``width``
    columns with the reflector structure (unit on the superdiagonal, zero
    left of it), one identity reflector (tau 0, v 0) where nb > 1."""
    g = torch.Generator(device="cuda").manual_seed(12)
    Vp = torch.randn((nb, width), dtype=torch.float64, device="cuda",
                     generator=g).triu_(1).div_(width ** 0.5)
    idx = torch.arange(nb, device="cuda")
    Vp[idx, idx + 1] = 1.0
    tau = torch.rand(nb, dtype=torch.float64, device="cuda",
                     generator=g).add_(1.0)
    if nb > 1:                 # one identity reflector
        tau[nb // 3] = 0.0
        Vp[nb // 3] = 0.0
    return dm.dword_matmul(Vp, Vp.T.contiguous()), tau


def check_larft(nb: int, width: int, reps: int):
    """larft on an apply_q panel's Gram (larft_inputs) against larft_plain:
    T within 1e-13 max|T|, the lower triangle exactly zero; CUDA events,
    device time and the wrapper's host path alone; the bound counts G's
    strict upper triangle and the taus read, T written."""
    G, tau = larft_inputs(nb, width)
    before = hp.larft_launches
    got = hp.larft(G, tau)
    one = hp.larft_launches - before == 1
    ref = hp.larft_plain(G, tau)
    err = _rel(got, ref)
    same = bool(torch.equal(got, hp.larft(G, tau)))
    lower_zero = bool((torch.tril(got, -1) == 0).all())
    ms = time_ms(lambda: hp.larft(G, tau), reps)
    dms = device_ms(lambda: hp.larft(G, tau), reps)
    plain = time_ms(lambda: hp.larft_plain(G, tau), reps)
    b_ms, b_by = bound(nb ** 3 / 3.0, PEAK_FP64,
                       8.0 * (nb * (nb - 1) // 2 + nb + nb * nb))
    joins = ((nb - 1) // 32).bit_length()
    return dict(nb=nb, width=width, max_rel_err=err, tol=1e-13,
                tol_of="max|T|", max_abs_err=float((got - ref).abs().max()),
                one_launch=one, run_to_run_identical=same,
                lower_triangle_zero=lower_zero,
                shared_bytes=hp._build.function(
                    "householder_panel", "larft_shared_bytes",
                    hp._SHARED_ARGTYPES)(nb),
                ms=ms, device_ms=dms, plain_ms=plain, library_ms=None,
                bound_ms=b_ms, bound_by=b_by,
                host_launch_us=host_launch_us(lambda: hp.larft(G, tau), reps),
                latency_note=f"{min(nb, 32) - 1} dependent steps in each "
                f"32-column diagonal block, then {joins} rounds of joins "
                "(two block products each)")

# --------------------------------------------------------------------------
# the two-stage front end's kernels: the wavefront chase and the panel QR


def band_matrix(n: int, b: int, seed: int):
    """The band b of dense_matrix(n, seed), made on the card."""
    A = dense_matrix(n, seed)
    idx = torch.arange(n, device="cuda")
    return torch.where((idx[:, None] - idx[None, :]).abs() <= b, A, 0.0)


def grid_sync_us(grid: int) -> float:
    """A grid sync's cost at ``grid`` blocks (grid_sync_probe: 0 and 100
    syncs in one cooperative launch)."""
    sync0 = time_ms(lambda: hp.grid_sync_probe(grid, 0), 50)
    sync100 = time_ms(lambda: hp.grid_sync_probe(grid, 100), 20)
    return (sync100 - sync0) * 10.0


_L2_COPY_US = {}


def l2_copy_rate():
    """(bytes a second, the copy times) of the card's L2, measured once a
    run: the slope of a torch copy's device time from 2 to 8 MB (source and
    destination, 16 MB at most, stay in the 50 MB L2; each byte read and
    each written counted), 50 copies a CUDA graph so that no host launch and
    no copy's fixed cost enters the slope; the time of a 16 MB copy beside
    (32 MB together: how far a copy's two ends stay in L2)."""
    if not _L2_COPY_US:
        for mb in (2, 8, 16):
            x = torch.ones(mb << 17, dtype=torch.float64, device="cuda")
            y = torch.empty_like(x)
            y.copy_(x)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(50):
                    y.copy_(x)
            _L2_COPY_US[mb] = 1e3 * time_ms(graph.replay, 10) / 50
            del graph, x, y
    rate = 2 * 6 * 2 ** 20 / ((_L2_COPY_US[8] - _L2_COPY_US[2]) * 1e-6)
    return rate, dict(_L2_COPY_US)


def host_launch_us(fn, reps: int) -> float:
    """The host's time a call of ``fn`` (its wrapper's plan, workspace,
    ctypes call and launch), over ``reps`` calls enqueued behind a device
    spin long enough that the device never waits for the host."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def chase_bound(n: int, b: int, sync_us: float):
    """The chase's bound at (n, b): the windows the tasks read and write once
    (each task its strip, b (4b - 2) doubles, and its diagonal block's lower
    half, b (b + 1) / 2, read and written: 9 b^2 - 3 b doubles) at 3.35 TB/s
    against their FP64 operations (a task: the strip's dots and rank-1
    update, 4 b (4b - 2); the block's matvec and rank-2 update, 2 b^2 +
    2 b (b + 1)) at 34 TFLOP/s; beside it the same bytes at the L2 rate
    measured in this run (l2_copy_rate: the stored band, (n + 3b)(3b - 1)
    doubles, 13.7 MB at n=4096, b=128, stays in the 50 MB L2, so its
    windows need not come from HBM; at n=16384 it is 51 MB, about L2's
    size, and that bound is the looser), the latency floor, one grid sync a wave (band_reduce.chase_grid_syncs: a
    wave with an item, the packing and sweep 0's first reflector), and the
    syncs a wave."""
    tasks, waves = br.chase_tasks(n, b), br.chase_waves(n, b)
    syncs = br.chase_grid_syncs(n, b)
    nbytes = 8.0 * 2 * (b * (4 * b - 2) + b * (b + 1) // 2) * tasks
    ops = float(4 * b * (4 * b - 2) + 2 * b * b + 2 * b * (b + 1)) * tasks
    b_ms, b_by = bound(ops, PEAK_FP64, nbytes)
    rate, copy_us = l2_copy_rate()
    return dict(tasks=tasks, waves=waves, window_bytes=nbytes,
                band_bytes=8.0 * (n + 3 * b) * (3 * b - 1),
                fp64_ops=ops, bound_ms=b_ms, bound_by=b_by,
                l2_rate_bytes_per_s=rate, l2_copy_us_by_mb=copy_us,
                l2_bound_ms=max(1e3 * nbytes / rate, 1e3 * ops / PEAK_FP64),
                grid_syncs=syncs, grid_syncs_per_wave=syncs / waves,
                latency_floor_ms=syncs * sync_us * 1e-3,
                bound_is="max(window bytes / 3.35 TB/s, FP64 ops / 34 "
                "TFLOP/s); l2_bound_ms: the bytes at the measured L2 rate "
                "(l2_rate_bytes_per_s) against the same ops; "
                "latency_floor_ms: its grid syncs")


def log_similarity(B, b, d, e, vlog):
    """max|B Q2 - Q2 T| / ||B|| and max|Q2^T Q2 - I| of the orthogonal
    similarity a reflector log defines (Q2 = apply_q2_wave_blocked(I))."""
    n = B.shape[0]
    Q2 = br.apply_q2_wave_blocked(
        n, b, vlog, torch.eye(n, dtype=torch.float64, device="cuda"))
    T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
    resid = float((B @ Q2 - Q2 @ T).abs().max())
    norm = float(torch.linalg.eigvalsh(B).abs().max())
    return resid / norm, max_ortho_error(Q2)


def check_band_chase(n: int, b: int, reps: int):
    """The chase of a band-b matrix at n (the band of dense_matrix, scaled to
    max|B| = 1 as eigh_banded hands it to the chase) against the plain wave
    loop on the card: d and e within 2e-12 n max|B|; eigvalsh of the
    tridiagonal against torch.linalg.eigvalsh(B) within 1e-12 ||B||; the
    reflector log held by the similarity it defines (B Q2 = Q2 T within
    1e-12 ||B||, Q2 orthogonal within 1e-12), its elementwise distance to
    the plain loop's log reported beside how far the kernel's own log moves
    when B moves by one ulp (the log's entries are ill-conditioned where a
    column to zero is short: on the CPU the plain loop's tw moves 8.4e-9 at
    n=4096, u=16 under that perturbation); one launch, no host sync,
    run-to-run identical; the log switched off gives the same d and e bit
    for bit and 1-row placeholders; times with and without the log, the
    plain loop's (its one run, the reference), a grid sync's at the
    launch's grid, the bound and the grid syncs a wave."""
    B = band_matrix(n, b, SEED + 20 + b)
    B /= B.abs().max()              # max|B| = 1, as eigh_banded prescales
    before = br.chase_launches
    d, e, (Vw, tw) = br.band_to_tridiag_wave(B, b)
    one = br.chase_launches - before == 1
    torch.cuda.synchronize()
    box = []
    plain_ms = 1e3 * timed(lambda: box.append(
        br.band_to_tridiag_wave_plain(B, b)))
    ref = box.pop()
    got = (d, e, Vw, tw)
    want = (ref[0], ref[1], *ref[2])
    scale = n * float(B.abs().max())
    errs = {name: float((g - r).abs().max()) for name, g, r in
            zip(("d", "e", "Vw", "tw"), got, want)}
    again = br.band_to_tridiag_wave(B, b)
    same = all(torch.equal(x, y) for x, y in
               zip(got, (again[0], again[1], *again[2])))
    nudged = br.band_to_tridiag_wave(B * (1.0 + 2.0 ** -52), b)
    ulp_move = {name: float((g - r).abs().max()) for name, g, r in
                zip(("d", "e", "Vw", "tw"), got,
                    (nudged[0], nudged[1], *nudged[2]))}
    log_row_zero = bool((Vw[n - 2] == 0).all() and (tw[n - 2] == 0).all())
    d0, e0, (V0, t0) = br.band_to_tridiag_wave(B, b, want_log=False)
    nolog = (torch.equal(d0, d) and torch.equal(e0, e)
             and V0.shape == (1, Vw.shape[1], b) and t0.shape[0] == 1)
    lam_b = torch.linalg.eigvalsh(B).cpu().numpy()
    lam_t = scipy.linalg.eigvalsh_tridiagonal(d.cpu().numpy(),
                                              e.cpu().numpy())
    eig_err = float(np.abs(lam_t - lam_b).max()) / float(np.abs(lam_b).max())
    sim, ortho = log_similarity(B, b, d, e, (Vw, tw))
    sim_plain, ortho_plain = log_similarity(B, b, want[0], want[1], ref[2])
    syncs, sync_sites = host_sync_sites(
        lambda: br.band_to_tridiag_wave(B, b))
    del again, nudged, d0, e0, V0, t0, ref
    ms = time_ms(lambda: br.band_to_tridiag_wave(B, b), reps)
    ms_nolog = time_ms(lambda: br.band_to_tridiag_wave(B, b, want_log=False),
                       reps)
    dms = device_ms(lambda: br.band_to_tridiag_wave(B, b), 1,
                    only="band_chase")
    plan = br.chase_device_plan(n, b, torch.cuda.current_device())
    sync = grid_sync_us(plan.grid)
    row = dict(n=n, b=b, what=f"chase of a band-{b} matrix, n={n}",
               max_rel_err=max(errs["d"], errs["e"]) / scale, tol=2e-12,
               tol_of="n max|B|, d and e (the CPU test's bound)",
               errors=errs, max_abs_err=max(errs.values()),
               log_move_under_one_ulp_of_B=ulp_move,
               log_similarity_over_normB=sim, log_q2_ortho=ortho,
               plain_log_similarity_over_normB=sim_plain,
               plain_log_q2_ortho=ortho_plain,
               eig_err_vs_eigvalsh_over_normB=eig_err, one_launch=one,
               run_to_run_identical=same, log_row_n_minus_2_zero=log_row_zero,
               no_log_same_d_e=nolog, host_syncs=syncs,
               host_sync_sites=sync_sites,
               ms=ms, ms_without_log=ms_nolog, device_ms=dms,
               plain_ms=plain_ms, plain_is="the torch wave loop on the card, "
               "one call", library_ms=None, plan=plan._asdict(),
               grid_sync_us=sync, **chase_bound(n, b, sync))
    row["ms_over_l2_bound"] = ms / row["l2_bound_ms"]
    require(eig_err <= 1e-12, f"band_chase: eigenvalues of T off by "
            f"{eig_err} ||B||: {row}")
    require(sim <= 1e-12 and ortho <= 1e-12,
            f"band_chase: the log's Q2 is not B's similarity: {row}")
    require(nolog and log_row_zero and syncs == 0,
            f"band_chase: log switch, log row n-2 or a host sync: {row}")
    require(one and same and row["max_rel_err"] <= 2e-12,
            f"band_chase: launches, run-to-run bits or d and e: {row}")
    return row


def check_panel_qr(m: int, o: int, b: int, reps: int):
    """The QR of the panel at column o of a bucket of width m (b = 128; a
    dense_matrix) against panel_qr_plain on the card: Yp within 2e-12 m
    max|Yp| and tp within 2e-12 m; As untouched; one launch, run-to-run
    identical; its grid syncs as the kernel counts them (the second run),
    one a column; CUDA events and the profiler's device time side by side,
    and the wrapper's host path alone; the bound (the panel's live entries,
    (m - o - b) b, read and the reflectors written once, against the FP64
    operations) and a latency
    form (the live panel's bytes a column plus one grid sync a column),
    beside the partials every block reads from L2; the library's time, one
    torch.geqrf of the same (m - o - b) x b panel (LAPACK's reflectors and
    taus, the kernel's convention in another layout: their distance to the
    kernel's is reported, not held; an identity reflector, tau = 0, has
    v0 = 0 in the port and 1 in LAPACK, so the distance skips those)."""
    A = dense_matrix(m, SEED + 30)
    A0 = A.clone()
    cnt = min(b, m - o - b)
    Yp, tp = A.new_zeros((b, m)), A.new_zeros(b)
    before = br.panel_qr_launches
    br.panel_qr(A, o, b, Yp, tp)
    one = br.panel_qr_launches - before == 1
    Yr, tr = A.new_zeros((b, m)), A.new_zeros(b)
    br.panel_qr_plain(A, o, b, Yr, tr)
    err_y = float((Yp - Yr).abs().max())
    err_t = float((tp - tr).abs().max())
    rel = max(err_y / float(Yr.abs().max()), err_t) / m
    Y2, t2 = A.new_zeros((b, m)), A.new_zeros(b)
    count = torch.zeros(1, dtype=torch.int64, device=A.device)
    br.panel_qr(A, o, b, Y2, t2, syncs=count)
    syncs = int(count.item())
    same = torch.equal(Y2, Yp) and torch.equal(t2, tp)
    untouched = torch.equal(A, A0)
    del A0, Y2, t2
    ms = time_ms(lambda: br.panel_qr(A, o, b, Yp, tp), reps)
    dms = device_ms(lambda: br.panel_qr(A, o, b, Yp, tp), reps,
                    only="panel_qr")
    plain_ms = time_ms(lambda: br.panel_qr_plain(A, o, b, Yr, tr), 2)
    panel = A[o + b:, o:o + b]
    qr, tau_l = torch.geqrf(panel)
    V = torch.tril(qr[:, :cnt], -1) + torch.eye(
        m - o - b, cnt, dtype=A.dtype, device=A.device)
    live = tau_l[:cnt] != 0
    lib_errs = {"Yp": float((V - Yp[:cnt, o + b:].T)[:, live].abs().max()),
                "tp": float((tau_l[:cnt] - tp[:cnt]).abs().max())}
    del qr, tau_l, V
    lib_ms = time_ms(lambda: torch.geqrf(panel), reps)
    lib_dms = device_ms(lambda: torch.geqrf(panel), reps)
    host_us = host_launch_us(lambda: br.panel_qr(A, o, b, Yp, tp), reps)
    plan = br.panel_qr_device_plan(m, o, b, torch.cuda.current_device())
    sync = grid_sync_us(plan.grid)
    us = [o + b + j for j in range(cnt)]
    nbytes = 8.0 * (b * (m - o - b) + sum(m - u for u in us) + cnt)
    ops = float(sum(4 * (cnt - j) * (m - u) for j, u in enumerate(us)))
    b_ms, b_by = bound(ops, PEAK_FP64, nbytes)
    col_bytes = sum(8.0 * (cnt - j) * (m - u) for j, u in enumerate(us))
    # the partials every block reads after each sync: grid doubles a live
    # row, at the L2 rate this run measures
    part_bytes = 8.0 * plan.grid * plan.grid * sum(cnt - j
                                                   for j in range(cnt))
    return dict(m=m, o=o, b=b, live_columns=cnt,
                what=f"panel QR, m={m}, o={o}, b={b}",
                max_rel_err=rel, tol=2e-12,
                tol_of="m max|Yp| (Yp), m (tp)", max_abs_err=max(err_y, err_t),
                errors={"Yp": err_y, "tp": err_t}, one_launch=one,
                run_to_run_identical=same, outside_view_untouched=untouched,
                ms=ms, device_ms=dms, plain_ms=plain_ms,
                plain_is="the torch column loop on the card",
                library_ms=lib_ms, library_device_ms=lib_dms,
                library_is="torch.geqrf of the panel As[o+b:, o:o+b]",
                library_distance=lib_errs, plan=plan._asdict(),
                host_launch_us=host_us,
                host_launch_is="the wrapper's host path a call, the device "
                "kept busy ahead of it",
                grid_syncs=syncs, syncs_per_column=syncs / cnt,
                grid_sync_us=sync,
                partials_bytes_from_l2=part_bytes,
                partials_l2_ms=1e3 * part_bytes / l2_copy_rate()[0],
                bound_ms=b_ms, bound_by=b_by,
                bound_is="max(the panel's live entries read + reflectors "
                "written once / 3.35 TB/s, FP64 ops / 34 TFLOP/s)",
                per_column_bound_ms=1e3 * col_bytes / PEAK_BYTES
                + 1e-3 * syncs * sync,
                per_column_bound_is="the live panel's bytes a column at "
                "3.35 TB/s plus the grid syncs the kernel counted")


def whole_band_reduction_row(n: int = 1024, b: int = 128, reps: int = 3):
    """A whole reduce_to_band at n, the panel_qr kernel against the plain
    column loop (the rest the same kernels) on the card: B, Yt and taus
    within 2e-12 n max|A| (the CPU test's bound)."""
    A = dense_matrix(n, SEED + 31)
    got = br.reduce_to_band(A, b)
    saved = br.panel_qr
    br.panel_qr = br.panel_qr_plain
    try:
        ref = br.reduce_to_band(A, b)
        plain = 1e3 * min(timed(lambda: br.reduce_to_band(A, b))
                          for _ in range(reps))
    finally:
        br.panel_qr = saved
    scale = n * float(A.abs().max())
    errs = {name: float((g - r).abs().max()) for name, g, r in
            zip(("B", "Yt", "taus"), got, ref)}
    ms = 1e3 * min(timed(lambda: br.reduce_to_band(A, b))
                   for _ in range(reps))
    panels = br.panel_qr_count(n, b)
    nbytes = 8.0 * (n * n * 3)
    return dict(m=n, b=b, what=f"whole reduce_to_band, n={n}, band {b}",
                max_rel_err=max(errs.values()) / scale, tol=2e-12,
                tol_of="n max|A| (the CPU test's bound)", errors=errs,
                max_abs_err=max(errs.values()), panels=panels,
                ms=ms, ms_is=f"host wall of the whole reduction (min of "
                f"{reps})", plain_ms=plain, library_ms=None,
                bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes",
                bound_is="A read, B and Yt written once")

# --------------------------------------------------------------------------
# the two-stage backtransform's kernels: every block's T, then the waves


def q2_log(n: int, b: int):
    """The chase's reflector log of the band b of dense_matrix (max|B| = 1,
    as eigh_banded hands it to the chase), made by the band_chase kernel."""
    B = band_matrix(n, b, SEED + 40 + b)
    B /= B.abs().max()
    _, _, vlog = br.band_to_tridiag_wave(B, b)
    return vlog


def q2_t_ops(b: int) -> float:
    """FP64 operations of one block's T: the Gram's entries above the
    diagonal (b - d pairs at distance d, 2 (b - d) operations each) and the
    recurrence's triangular matvecs (c (c + 1) operations at column c)."""
    return float(sum(2 * (b - d) ** 2 for d in range(1, b))
                 + sum(c * (c + 1) + 1 for c in range(1, b)))


def q2_blocks_t_all(n: int, b: int, Vw, tw, chunks, module=br):
    """Every chunk's stores in turn, as apply_q2_wave_blocked makes them
    (each freed before the next), through ``module``'s q2_blocks_t."""
    for chunk in chunks:
        module.q2_blocks_t(n, b, Vw, tw, chunk)


def check_q2_blocks_t(n: int, b: int, reps: int, depth: int = 0):
    """Every block's T and Y^T (the two stores, 16 x 4 tiles) of the
    chase's log at (n, b), chunk by chunk as apply_q2_wave_blocked cuts the
    waves (q2_device_chunks: each chunk's stores within q2_store_budget),
    against q2_blocks_t_plain on the card (the same recurrence in torch,
    the Gram by one bmm) at every live slot: T within 1e-12 max|T|, Y^T bit
    for bit (a copy of the log); T zero below the diagonal; one launch a
    chunk, run-to-run identical; the times of all chunks (one
    backtransform's T), and the bound (the blocks' reflectors and taus
    read, both stores' live slots written once, against the FP64
    operations of the Gram and the recurrence at the CUDA cores' rate).
    ``depth``: only the first depth - 1 chunks and the last are held
    against the plain version (and its time is theirs; u=2 and u=4 at
    n=16384 make 132 and 35); every chunk is timed.  The row states the
    launch's blocks of threads an SM holds by the occupancy API and the
    reflector blocks each takes.  No PyTorch call forms a compact-WY T
    (torch.linalg.householder_product forms Q): library_ms is null."""
    Vw, tw = q2_log(n, b)
    chunks = br.q2_device_chunks(n, b, torch.cuda.current_device())
    held = (chunks if not depth or len(chunks) <= depth
            else chunks[:depth - 1] + chunks[-1:])
    err = scale = 0.0
    y_exact = same = lower_zero = one = True
    store_bytes = 0.0
    for chunk in chunks:
        slot = br.q2_chunk_blocks(n, b, chunk, "cuda")[0]
        if chunk not in held:
            store_bytes += 8.0 * slot.numel() * ((b + 15) & ~15) * (
                ((b + 15) & ~15) + br._q2_y_stride(b))
            continue
        before = br.q2_blocks_t_launches
        got = br.q2_blocks_t(n, b, Vw, tw, chunk)
        one &= br.q2_blocks_t_launches - before == 1
        ref = br.q2_blocks_t_plain(n, b, Vw, tw, chunk)
        err = max(err, float((got.T[slot] - ref.T[slot]).abs().max()))
        scale = max(scale, float(ref.T[slot].abs().max()))
        y_exact &= bool(torch.equal(got.Y[slot], ref.Y[slot]))
        del ref
        again = br.q2_blocks_t(n, b, Vw, tw, chunk)
        same &= bool(torch.equal(got.T[slot], again.T[slot])
                     and torch.equal(got.Y[slot], again.Y[slot]))
        del again
        lower_zero &= bool((torch.tril(br._untile(got.T[slot]), -1) == 0)
                           .all())
        store_bytes += 8.0 * slot.numel() * (got.T[0].numel()
                                             + got.Y[0].numel())
        del got
    ms = time_ms(lambda: q2_blocks_t_all(n, b, Vw, tw, chunks), reps)
    dms = device_ms(lambda: q2_blocks_t_all(n, b, Vw, tw, chunks), reps,
                    only="q2_blocks_t")
    plain_ms = time_ms(lambda: [br.q2_blocks_t_plain(n, b, Vw, tw, c)
                                for c in held], 1)
    blocks = br.q2_block_count(n, b)
    nbytes = 8.0 * blocks * (b * b + b) + store_bytes
    b_ms, b_by = bound(blocks * q2_t_ops(b), PEAK_FP64, nbytes)
    per_sm, per_block, threads, smem = br.q2_blocks_t_occupancy(
        torch.cuda.current_device(), b)
    return dict(n=n, b=b, blocks=blocks, chunks=len(chunks),
                chunks_held=len(held),
                what=f"every block's T and Y^T, n={n}, b={b}, "
                f"{len(chunks)} chunks", max_rel_err=err / scale, tol=1e-12,
                blocks_of_threads_per_sm=per_sm,
                reflector_blocks_per_block_of_threads=per_block,
                threads=threads, shared_bytes=smem,
                t_in_shared_memory=br._q2_t_staged(
                    torch.cuda.current_device(), b),
                tol_of="max|T|", max_abs_err=err, bit_exact=y_exact,
                bit_exact_of="the Y^T store", store_bytes=store_bytes,
                store_budget_bytes=br.q2_store_budget(n),
                one_launch=one, run_to_run_identical=same,
                lower_triangle_zero=lower_zero,
                ms=ms, device_ms=dms, plain_ms=plain_ms,
                plain_is="q2_blocks_t_plain on the card (torch), every "
                "chunk held", library_ms=None, library_is="none: no PyTorch call "
                "forms a compact-WY T factor", bound_ms=b_ms, bound_by=b_by,
                bound_is="max(reflectors + taus read, T and Y^T stores "
                "written / 3.35 TB/s, Gram + recurrence FP64 ops / 34 "
                "TFLOP/s)")


def q2_wave_bound(n: int, b: int, C: int, waves):
    """The bound of q2_apply over ``waves`` at (n, b) on C columns: X's
    window rows inside the matrix read and written once, each block's
    reflectors (b^2) and T's upper triangle read once, against the FP64 operations of the banded
    and triangular forms (4 b^2 + b (b + 1) a column a block) at the tensor
    cores' 67 TFLOP/s; with the blocks and the bytes."""
    Kmax, _, _ = br._wave_geometry(n, b)
    blocks, xrows = 0, 0
    for w in waves:
        s_lo, s_hi = br.q2_wave_range(n, b, w)
        for s in range(s_lo, s_hi + 1):
            base = (Kmax - 1 - s) * b + (w - 2 * s) * b + 1
            blocks += 1
            xrows += min(2 * b - 1, n - base)
    nbytes = 16.0 * xrows * C + 8.0 * blocks * (b * b + b * (b + 1) // 2)
    ops = float(blocks) * C * (4 * b * b + b * (b + 1))
    b_ms, b_by = bound(ops, PEAK_FP64_TENSOR, nbytes)
    return blocks, nbytes, ops, b_ms, b_by


def q2_a_traffic(n: int, b: int, C: int, waves, plan):
    """The A operands' L2 traffic of ``waves`` at (n, b) on C columns under
    ``plan``: each block of threads fetches plan.a_bytes of Y^T and T
    (band_reduce.q2_a_bytes) for its tile, ceil(C / tile) of them a live
    block; with that traffic's time at the L2 rate this run measures
    (l2_copy_rate), and the plan."""
    blocks = sum(max(0, hi - lo + 1)
                 for lo, hi in (br.q2_wave_range(n, b, w) for w in waves))
    nbytes = float(blocks) * -(-C // plan.tile) * plan.a_bytes
    rate, _ = l2_copy_rate()
    return dict(plan=plan._asdict(), a_bytes_from_l2=nbytes,
                a_l2_ms=1e3 * nbytes / rate, l2_rate_bytes_per_s=rate)


def check_q2_apply(n: int, b: int, reps: int, whole: bool = True,
                   replaced: bool = True):
    """q2_apply on the chase's log at (n, b) and an n x n X (seeded), with
    q2_blocks_t's T of a chunk holding the widest wave: that wave against
    q2_apply_plain (the same wave in torch: gather, three bmm, scatter)
    within 1e-12 max|X|, one launch, run-to-run identical, every row
    outside the wave's windows bit for bit; its time, the plain wave's, the
    library's (torch.ormqr of the wave's gathered blocks in geqrf form,
    batched: LAPACK's reflector application, the same function on the
    gathered rows; its distance to the kernel's reported) and the wave's
    bound.  ``whole``: every wave through apply_q2_wave_blocked (a
    q2_blocks_t a chunk, q2_wave_count q2_apply launches) against the plain
    waves in torch (q2_blocks_t_plain a chunk, then q2_apply_plain a wave)
    within 1e-11 max|X| (the error of ~3n/b waves of orthogonal blocks),
    no host sync, its time and the whole bound, and the device time of
    its q2_apply and of its q2_blocks_t kernels apart.  Each row states the
    plan (band_reduce.q2_apply_plan: tile, instance, cluster, blocks of
    threads an SM, shared bytes) and the A operands' bytes its launches
    fetch from L2, with their time at the L2 rate this run measures, beside
    bound_ms.  ``replaced``: beside the
    replaced host loop's time (apply_q2_wave_blocked_plain on the card, its
    GEMMs through dword_matmul)."""
    Vw, tw = q2_log(n, b)
    Kmax, _, _ = br._wave_geometry(n, b)
    sizes = br.q2_wave_sizes(n, b)
    w = int(np.argmax(sizes))
    S = int(sizes[w])
    g = torch.Generator(device="cuda").manual_seed(SEED + 50 + b)
    X0 = torch.randn((n, n), dtype=torch.float64, device="cuda", generator=g)
    xmax = float(X0.abs().max())
    blocks = br.q2_blocks_t(n, b, Vw, tw, br.Q2Chunk(w, w + 1, S))
    X = X0.clone()
    before = br.q2_apply_launches
    br.q2_apply(X, blocks, n, b, w)
    one = br.q2_apply_launches - before == 1
    Xr = X0.clone()
    br.q2_apply_plain(Xr, blocks, n, b, w)
    err = float((X - Xr).abs().max())
    X2 = X0.clone()
    br.q2_apply(X2, blocks, n, b, w)
    same = bool(torch.equal(X, X2))
    s_lo, _ = br.q2_wave_range(n, b, w)
    s = torch.arange(s_lo, s_lo + S, device="cuda")
    J, k = Kmax - 1 - s, w - 2 * s
    rows = (J * b + k * b + 1)[:, None] + torch.arange(2 * b - 1,
                                                        device="cuda")
    inside = rows < n
    untouched = torch.ones(n, dtype=torch.bool, device="cuda")
    untouched[rows[inside]] = False
    outside_same = bool(torch.equal(X[untouched], X0[untouched]))
    # LAPACK's application of the same blocks to the gathered rows
    Y, sw = br._q2_y(n, b, Vw, J, k)
    tau = tw[sw, k[:, None]]
    G = torch.where(inside[..., None], X0[rows.clamp(max=n - 1)], 0.0)
    lib = torch.ormqr(Y, tau, G, left=True, transpose=False)
    lib_dist = float((lib[inside] - X[rows[inside]]).abs().max())
    del X2, Xr, lib
    ms = time_ms(lambda: br.q2_apply(X, blocks, n, b, w), reps)
    dms = device_ms(lambda: br.q2_apply(X, blocks, n, b, w), reps,
                    only="q2_apply")
    plain_ms = time_ms(lambda: br.q2_apply_plain(X, blocks, n, b, w), 2)
    lib_ms = time_ms(lambda: torch.ormqr(Y, tau, G, left=True,
                                         transpose=False), 2)
    del G, Y
    _, nbytes, ops, b_ms, b_by = q2_wave_bound(n, b, n, (w,))
    plan = br._q2_device_plan(torch.cuda.current_device(), b)
    row = dict(n=n, b=b, C=n, wave=w, wave_blocks=S,
               what=f"the widest wave (w={w}, {S} blocks), n={n}, b={b}",
               wave_bytes=nbytes, wave_fp64_ops=ops,
               max_rel_err=err / xmax, tol=1e-12, tol_of="max|X|",
               max_abs_err=err, one_launch=one, run_to_run_identical=same,
               outside_view_untouched=outside_same, ms=ms, device_ms=dms,
               plain_ms=plain_ms, plain_is="q2_apply_plain on the card "
               "(torch: gather, three bmm, scatter)", library_ms=lib_ms,
               library_is="torch.ormqr of the wave's gathered blocks "
               "(geqrf form, batched), the gather not timed",
               library_distance=lib_dist, bound_ms=b_ms, bound_by=b_by,
               bound_is="max(X's window rows read and written + Y and T "
               "read / 3.35 TB/s, banded/triangular FP64 ops / 67 TFLOP/s)",
               **q2_a_traffic(n, b, n, (w,), plan))
    del X, blocks
    torch.cuda.empty_cache()
    if whole:
        chunks = br.q2_device_chunks(n, b, torch.cuda.current_device())
        before = (br.q2_blocks_t_launches, br.q2_apply_launches)
        Xk = br.apply_q2_wave_blocked(n, b, (Vw, tw), X0)
        launches = (br.q2_blocks_t_launches - before[0],
                    br.q2_apply_launches - before[1])
        Xp = X0.clone()
        for chunk in chunks:
            plain_blocks = br.q2_blocks_t_plain(n, b, Vw, tw, chunk)
            for v in range(chunk.w0, chunk.w1):
                br.q2_apply_plain(Xp, plain_blocks, n, b, v)
            del plain_blocks
        whole_err = float((Xk - Xp).abs().max())
        del Xp
        torch.cuda.empty_cache()
        Xt = X0.clone()
        all_ms = time_ms(lambda: br.apply_q2_wave_blocked(
            n, b, (Vw, tw), Xt, overwrite=True), 2)
        syncs = host_syncs(lambda: br.apply_q2_wave_blocked(
            n, b, (Vw, tw), Xt, overwrite=True))
        by_kernel, _ = device_ms_by_kernel(lambda: br.apply_q2_wave_blocked(
            n, b, (Vw, tw), Xt, overwrite=True), 1)
        all_dms = sum(by_kernel.values())
        split = {k: sum(t for name, t in by_kernel.items() if k in name)
                 for k in ("q2_apply", "q2_blocks_t")}
        _, wbytes, wops, wb_ms, wb_by = q2_wave_bound(
            n, b, n, range(3 * Kmax - 2))
        expected = (len(chunks), br.q2_wave_count(n, b))
        row.update(whole=dict(
            launches={"q2_blocks_t": launches[0], "q2_apply": launches[1]},
            launches_expected={"q2_blocks_t": expected[0],
                               "q2_apply": expected[1]},
            max_rel_err=whole_err / xmax, tol=1e-11, host_syncs=syncs,
            ms=all_ms, device_ms=all_dms, q2_apply_device_ms=split[
                "q2_apply"], q2_blocks_t_device_ms=split["q2_blocks_t"],
            bytes=wbytes, fp64_ops=wops, bound_ms=wb_ms, bound_by=wb_by,
            blocks=br.q2_block_count(n, b),
            **q2_a_traffic(n, b, n, range(3 * Kmax - 2), plan)))
        if replaced:
            row["whole"].update(
                replaced_loop_ms=1e3 * timed(
                    lambda: br.apply_q2_wave_blocked_plain(
                        n, b, (Vw, tw), X0)),
                replaced_is="apply_q2_wave_blocked_plain on the card, one "
                "call (the host wave loop the kernels replace)")
        del Xt, Xk
        require(whole_err <= 1e-11 * xmax and syncs == 0
                and launches == expected,
                f"q2_apply: the whole backtransform: {row}")
    torch.cuda.empty_cache()
    return row


def check_q2_small_band(n: int, b: int, C: int = 1024):
    """The backtransform of a small band at n, as eigh_banded runs it (the
    chase's log of the band b of dense_matrix), on the first C + 1 columns
    of I, so X becomes Q2's first C + 1 columns (the time grows with C, the
    stores do not): the memory it takes beyond X and the log (the peak of
    torch's allocator) held within q2_store_budget (n^2 / 2 doubles) and 5%
    for the allocator's rounding, where every block's stores at once take
    (16/b)^2 n^2 / 2 doubles; the result held by the similarity the log
    defines on those columns (B Q2[:, :C] = Q2[:, :C+1] T[:C+1, :C], T
    tridiagonal, within 1e-12 ||B||, ||B|| from T's extreme eigenvalues)
    and the columns orthonormal within 1e-12; the launch counts (a
    q2_blocks_t a chunk, a q2_apply a wave) and the time of the call."""
    B = band_matrix(n, b, SEED + 40 + b)
    B /= B.abs().max()
    d, e, vlog = br.band_to_tridiag_wave(B, b)
    chunks = br.q2_device_chunks(n, b, torch.cuda.current_device())
    Q2 = torch.eye(n, C + 1, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = (br.q2_blocks_t_launches, br.q2_apply_launches)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    br.apply_q2_wave_blocked(n, b, vlog, Q2, overwrite=True)
    t1.record()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    launches = (br.q2_blocks_t_launches - before[0],
                br.q2_apply_launches - before[1])
    expected = (len(chunks), br.q2_wave_count(n, b))
    budget = br.q2_store_budget(n)
    dn, en = d.cpu().numpy(), e.cpu().numpy()
    norm = max(abs(float(scipy.linalg.eigvalsh_tridiagonal(
        dn, en, select="i", select_range=(i, i))[0])) for i in (0, n - 1))
    T = (torch.diag(d[:C + 1]) + torch.diag(e[:C], 1)
         + torch.diag(e[:C], -1))[:, :C]
    resid = float((B @ Q2[:, :C] - Q2 @ T).abs().max())
    del T, B
    ortho = max_ortho_error(Q2)
    del Q2
    torch.cuda.empty_cache()
    every = br.q2_block_count(n, b) * br._q2_slot_bytes(b, False)
    row = dict(n=n, b=b, C=C + 1, what=f"the whole backtransform at a "
               f"small band, n={n}, b={b}, {C + 1} columns (memory)",
               chunks=len(chunks),
               launches={"q2_blocks_t": launches[0], "q2_apply": launches[1]},
               launches_expected={"q2_blocks_t": expected[0],
                                  "q2_apply": expected[1]},
               peak_extra_bytes=extra, store_budget_bytes=budget,
               every_block_store_bytes=every, x_bytes=8.0 * n * (C + 1),
               max_rel_err=resid / norm, tol=1e-12,
               tol_of="||B|| (B Q2 - Q2 T)", max_abs_err=resid,
               q2_ortho=ortho, ms=t0.elapsed_time(t1))
    require(extra <= 1.05 * budget and ortho <= 1e-12
            and launches == expected,
            f"q2_apply: the small-band backtransform's memory, launches or "
            f"orthogonality: {row}")
    return row


def split_level(d, e, k: int, m: int):
    """The inputs of one merge level of a tear of T = (d, e): T's first k*m
    rows cut into 2k blocks of m/2, the boundary inside each merge torn as
    core/tearing.py tears it (theta = sign(beta); d[r] -= theta beta,
    d[r+1] -= beta / theta), each block's eigenpairs by LAPACK on the host,
    z = [last row of the left block's eigenvectors, first row of the right
    block's / theta], rho = |beta|: what the driver hands merge_decompose at
    that level."""
    h = m // 2
    d = np.array(d[:k * m], dtype=np.float64)
    e = np.asarray(e[:k * m - 1], dtype=np.float64)
    rows = np.arange(k) * m + h - 1
    beta = e[rows]
    theta = np.where(beta < 0, -1.0, 1.0)
    d[rows] -= theta * beta
    d[rows + 1] -= beta / theta
    lam = np.empty((k, m))
    z = np.empty((k, m))
    for b in range(2 * k):
        r0 = b * h
        w, Q = scipy.linalg.eigh_tridiagonal(d[r0:r0 + h], e[r0:r0 + h - 1])
        lam[b // 2, (b % 2) * h:(b % 2 + 1) * h] = w
        if b % 2 == 0:
            z[b // 2, :h] = Q[-1]
        else:
            z[b // 2, h:] = Q[0] / theta[b // 2]
    return lam, z, np.abs(beta)


def spread_level(k: int, m: int, seed: int):
    """The inputs of a merge level that deflates little (as a spectrum with
    spread-out eigenvectors gives it, such as the dense path's): each half's
    eigenvalues standard normal, z the halves' unit boundary rows (random
    directions), rho = |beta| ~ 1.  Nearly every slot stays active, so the
    sweeps run over K_b ~ m poles."""
    g = np.random.default_rng(seed)
    h = m // 2
    lam = np.concatenate([np.sort(g.standard_normal((k, h)), axis=1),
                          np.sort(g.standard_normal((k, m - h)), axis=1)],
                         axis=1)
    z = g.standard_normal((k, m))
    z[:, :h] /= np.linalg.norm(z[:, :h], axis=1, keepdims=True)
    z[:, h:] /= np.linalg.norm(z[:, h:], axis=1, keepdims=True)
    return lam, z, np.abs(g.standard_normal(k)) + 0.5


def check_secular_solve(level, reps, stall=False):
    """The root finder's whole iteration (one secular_solve launch) on a
    merge level: against the loop it replaces (secular_solve_plain with the
    sums kernel, run on the card) and against the all-plain loop (the setup
    built from CPU copies, so its midpoint sweep is the plain one; the loop
    on the card with the plain sums): tau within 1e-11 |tau|, the same shift
    choices; each root's sweeps, and a bound by operations from them.

    ``stall``: also the secular_stall check against the plain loop run on
    the CPU: no root ends at max_secular_iters where that loop converges,
    the summed sweeps within 1% of its, tau within 1e-11 |tau| of the
    all-plain loop."""
    lam, z, rho = level
    cfg = st.SolverConfig()
    eps, max_iters = cfg.eps(), cfg.max_secular_iters
    tolf = cfg.secular_tol_factor * eps
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    part = sec.merge_partition(t(lam), t(z), t(rho), eps=eps,
                               deflation_factor=cfg.deflation_factor)
    k, m = part.poles_sec.shape
    act = torch.arange(m, device="cuda")[None, :] < part.K[:, None]
    level_in = (part.poles_sec, part.zu, part.rho_e, part.K, act)
    setup, sidx = sec._root_setup(*level_in)
    setup_c, sidx_p = sec._root_setup(*(x.cpu() for x in level_in))
    setup_p = ss.RootSetup(*(x.cuda() for x in setup_c))
    sidx_p = sidx_p.cuda()
    tau, iters = ss.secular_solve(setup, tolf, max_iters)
    again, _ = ss.secular_solve(setup, tolf, max_iters)
    tau_y, iters_y = ss.secular_solve_plain(setup, tolf, max_iters,
                                            sums=ss.secular_sums)
    tau_p, iters_p = ss.secular_solve_plain(setup_p, tolf, max_iters)
    scale = tau_p.abs().clamp(min=1e-300)
    rel_y = float(((tau - tau_y).abs() / scale)[act].max())
    rel_p = float(((tau - tau_p).abs() / scale)[act].max())
    abs_err = float((tau - tau_p).abs()[act].max())
    ms = time_ms(lambda: ss.secular_solve(setup, tolf, max_iters), reps)
    dms = device_ms(lambda: ss.secular_solve(setup, tolf, max_iters), reps)
    loop = lambda: ss.secular_solve_plain(setup, tolf, max_iters,
                                          sums=ss.secular_sums)
    replaced = time_ms(loop, max(1, reps // 2))
    replaced_dms = device_ms(loop, max(1, reps // 2))
    plain = time_ms(lambda: ss.secular_solve_plain(setup_p, tolf, max_iters),
                    1)
    # one term's FP64 instructions (SASS of the term yardstick) per (root,
    # pole) pair swept, every sweep of every root counted; the bytes: the
    # level's inputs read once (seven (k, m) f64 fields, the poles and z2 up
    # to K_b, rho_e and K, done0), tau and the iteration counts written
    Kb = part.K.clamp(max=m)
    swept = float((iters.to(torch.float64) * Kb[:, None]).sum())
    b_ms, b_by = bound(secular_fp64_per_term() * swept, fp64_rate(),
                       8.0 * (7 * k * m + 2 * int(Kb.sum()) + 2 * k)
                       + 1.0 * k * m + 12.0 * k * m)
    Ks = part.K.tolist()
    it_k = iters[act].to(torch.float64)
    extra = {}
    if stall:
        tau_c, iters_c = ss.secular_solve_plain(setup_c, tolf, max_iters)
        iters_c = iters_c.cuda()
        at_max = (iters == max_iters) & act
        where_cpu = at_max & (iters_c < max_iters)
        ratio = int(iters.sum()) / max(1, int(iters_c.sum()))
        rel_c = float(((tau - tau_c.cuda()).abs() / scale)[act].max())
        extra["secular_stall"] = dict(
            roots_at_max_iters=int(at_max.sum()),
            roots_at_max_where_cpu_plain_converges=int(where_cpu.sum()),
            iters_sum=int(iters.sum()), cpu_plain_iters_sum=int(iters_c.sum()),
            cpu_plain_iters_max=int(iters_c.max()), sweeps_ratio=ratio,
            vs_plain_loop=rel_p, vs_cpu_plain_loop=rel_c,
            max_secular_iters=max_iters, tolf=tolf,
            ok=bool(int(where_cpu.sum()) == 0 and abs(ratio - 1.0) <= 0.01
                    and rel_p <= 1e-11))
    return dict(k=k, m=m, K_sum=int(sum(Ks)), K_min=min(Ks), K_max=max(Ks),
                active_roots=int(act.sum()), max_rel_err=max(rel_y, rel_p),
                tol=1e-11, tol_of="|tau| per active root",
                vs_replaced_loop=rel_y, vs_plain_loop=rel_p,
                max_abs_err=abs_err,
                shift_choices_identical=bool(torch.equal(sidx, sidx_p)),
                shift_choices_differing=int((sidx != sidx_p)[act].sum()),
                run_to_run_identical=bool(torch.equal(tau, again)),
                iters_sum=int(iters.sum()), iters_max=int(iters.max()),
                iters_mean_active=float(it_k.mean()),
                replaced_loop_iters_sum=int(iters_y.sum()),
                replaced_loop_passes=int(iters_y.max()),
                plain_loop_iters_sum=int(iters_p.sum()),
                roots_iters_differ=int((iters != iters_y)[act].sum()),
                pairs_swept=swept, ms=ms, device_ms=dms,
                replaced_loop_ms=replaced,
                replaced_loop_device_ms=replaced_dms,
                replaced_loop_is="secular_solve_plain with the secular_sums "
                "kernel on the card: the path before this kernel",
                plain_ms=plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, **extra)


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
    emu = cm.cauchy_matmul_split_plain(*args)
    # per entry, the scale of an f32 sum in another order: |M| @ |X|
    Mf = torch.where(torch.arange(m, device="cuda")[None, None, :]
                     < K[:, None, None],
                     cm._cauchy_block(poles, shift, tau, zhat, ninv),
                     torch.zeros((), device="cuda"))
    scale = torch.clamp(torch.bmm(Mf.abs(), X.abs()), min=1e-30)
    diff = (got - ref).abs()
    err = float((diff / scale).max())
    abs_err = float(diff.max())
    err_emu = float(((got - emu).abs() / scale).max())
    # all three against the f64 product of the same f32 entries (the first
    # merge, a few hundred columns): the kernel's grade between the full-f32
    # product and the emulated split
    cols = slice(0, min(C, 512))
    exact = torch.matmul(Mf[0].double(), X[0, :, cols].double())
    vs_f64 = [float(((y[0, :, cols].double() - exact).abs()
                     / scale[0, :, cols]).max()) for y in (got, ref, emu)]
    same = bool(torch.equal(got, cm.cauchy_matmul(*args)))
    del scale, diff, exact, emu
    # the deflation skip is exact: the same call over all m slots agrees
    full = cm.cauchy_matmul(poles, shift, tau, zhat, ninv, X,
                            torch.full_like(K, m))
    fin = torch.isfinite(full)
    skip_exact = bool(torch.equal(got[fin], full[fin]))
    del full, fin
    ms = time_ms(lambda: cm.cauchy_matmul(*args), reps)
    dms = device_ms(lambda: cm.cauchy_matmul(*args), reps)
    plain = time_ms(lambda: cm.cauchy_matmul_plain(*args), max(1, reps // 2))
    library = time_ms(lambda: torch.bmm(Mf, X), reps)
    lib_dms = device_ms(lambda: torch.bmm(Mf, X), reps)
    # three TF32 passes on the tensor cores; the earlier design's bound was
    # one pass of FP32 on the CUDA cores
    ops = 2.0 * k * kact * m * C
    nbytes = 8.0 * 5 * k * m + 4.0 * k * kact * C + 4.0 * k * m * C
    b_ms, b_by = bound(3.0 * ops, PEAK_TF32_TENSOR, nbytes)
    simt_ms, _ = bound(ops, PEAK_FP32, nbytes)
    return dict(k=k, m=m, C=C, K=kact, max_rel_err=err, tol=1e-5,
                tol_of="|M|@|X| per entry", skip_bit_exact=skip_exact,
                run_to_run_identical=same,
                kernel_vs_split_emulation=err_emu, tol_vs_emulation=6e-6,
                tol_vs_emulation_why="the same split words and the same "
                "three products: only the order and the rounding of the f32 "
                "sums differ",
                kernel_vs_f64=vs_f64[0], plain_vs_f64=vs_f64[1],
                split_emulation_vs_f64=vs_f64[2],
                max_abs_err=abs_err, ms=ms, device_ms=dms, plain_ms=plain,
                library_ms=library, library_device_ms=lib_dms,
                library_is="torch.bmm of the pre-built "
                "f32 M with X (full f32, the product alone)",
                bound_ms=b_ms, bound_by=b_by,
                bound_is="3 TF32 passes on the tensor cores",
                fp32_simt_bound_ms=simt_ms)


def check_cauchy_matmul_edges(m, C):
    """Denominators that no merge gives: zero, subnormal, subnormal under a
    zero numerator, infinite.  The kernel's quotient is a reciprocal
    approximation with a Newton step, which would make NaN of all four; it
    must take the division there, as the plain version does: Y is finite
    exactly where the plain version's is, and agrees with it there."""
    g = np.random.default_rng(12)
    poles, shift, tau, zhat, ninv = _merge_data(g, 1, m)
    # shift_i = pole_i, so entry (i, i) has the denominator -tau_i
    tau[0, 3] = 0.0                      # z / 0: row 3 is not finite
    tau[0, 10] = 5e-324                  # the quotient overflows: nor row 10
    tau[0, 20], zhat[0, 20] = 1e-310, 0.0   # 0 / subnormal = 0: finite
    tau[0, 30] = float("inf")            # z / inf = 0 down slot 30: finite
    K = torch.full((1,), m, dtype=torch.int64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    X = torch.randn((1, m, C), dtype=torch.float32, device="cuda",
                    generator=gen)
    args = (poles, shift, tau, zhat, ninv, X, K)
    got = cm.cauchy_matmul(*args)
    ref = cm.cauchy_matmul_plain(*args)
    fin = torch.isfinite(ref)
    Mf = cm._cauchy_block(poles, shift, tau, zhat, ninv)
    Mf = torch.where(torch.isfinite(Mf), Mf, torch.zeros((), device="cuda"))
    scale = torch.clamp(torch.bmm(Mf.abs(), X.abs()), min=1e-30)
    diff = torch.where(fin, got - ref, torch.zeros((), device="cuda")).abs()
    return dict(k=1, m=m, C=C, K=m, edge_denominators=True,
                max_rel_err=float((diff / scale).max()), tol=1e-5,
                tol_of="|M|@|X| per entry, where the plain version is finite",
                max_abs_err=float(diff.max()),
                nonfinite_as_plain=bool(torch.equal(torch.isfinite(got), fin)),
                nonfinite_rows=int((~fin).any(dim=2).sum()))


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
    dms = device_ms(lambda: cm.cauchy_materialize(*args), reps)
    plain = time_ms(lambda: cm.cauchy_materialize_plain(*args), reps)
    nact = int(act.sum())
    nbytes = 4.0 * m * C + 8.0 * (2 * m + 4 * C)
    b_ms, b_by = bound(1.0 * m * nact, PEAK_FP64, nbytes)
    return dict(m=m, C=C, K=kact, max_rel_err=err, tol=2.0 ** -22,
                tol_of="|entry|, active entries", identity_exact=eye_exact,
                max_abs_err=abs_err, ms=ms, device_ms=dms, plain_ms=plain,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


@contextlib.contextmanager
def recorded_replays(form="rotation_replay"):
    """The (MergeRep, data) of each level's Givens replay ``form``
    (``rotation_replay``: the downsweeps', y; ``rotation_replay_t``:
    rows_through_merge's, wt) run inside the block, the data copied before
    the replay: the first call of each level shape (k, m), in the order of
    the sweep."""
    got = {}
    inner = getattr(assemble, form)

    def recorded(rep, x, waves=None):
        key = tuple(x.shape[:2])
        if key not in got:
            got[key] = (rep, x.clone())
        return inner(rep, x, waves)

    setattr(assemble, form, recorded)
    try:
        yield got
    finally:
        setattr(assemble, form, inner)


@contextlib.contextmanager
def plain_replays():
    """Both Givens replays' plain versions (the wave loops, with their
    fetches of the log) in place of the kernel's two launch forms."""
    inner = assemble.rotation_replay, assemble.rotation_replay_t
    assemble.rotation_replay = rr.rotation_replay_plain
    assemble.rotation_replay_t = rr.rotation_replay_t_plain
    try:
        yield
    finally:
        assemble.rotation_replay, assemble.rotation_replay_t = inner


def graph_ms(fn, reps: int):
    """Device time a call of ``reps`` calls of ``fn`` captured in one CUDA
    graph and replayed (after an eager warm-up on a side stream): no host
    path in the way, and no event the profiler could drop."""
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
    ms = time_ms(graph.replay, 5) / reps
    del graph
    return ms


def replay_plan(rep, x, transposed):
    """The wrapper's plan of one launch: instance, grid and occupancy."""
    k, m, width = x.shape
    vec = width if transposed else rr.row_vec(x)
    occ = rr.occupancy(x.device, transposed, x.dtype == torch.float32, vec)
    grid = (rr.launch_plan_t(k, occ) if transposed
            else rr.launch_plan(k, m, width, vec, occ))
    return dict(vec_or_r=vec, grid=grid, **occ._asdict())


def empty_log(rep):
    """``rep`` with no logged rotation: the launch's grid alone."""
    return rep._replace(nrot=torch.zeros_like(rep.nrot),
                        nwave=torch.zeros_like(rep.nwave))


def check_rotation_replay(rep, y, what, reps=5):
    """rotation_replay against its plain version (the wave loop planned on
    the host, with its fetch of the log) on one level's own (MergeRep, y):
    bit for bit, run to run; device time by the profiler and by a CUDA
    graph's replay, and the same launch's on an empty log (what the grid
    costs alone); the bound is the bytes of two rows read and written a
    logged rotation."""
    k, m, C = y.shape
    nrot = int(rep.nrot.sum())
    got = rr.rotation_replay(rep, y.clone())
    ref = rr.rotation_replay_plain(rep, y.clone())
    again = rr.rotation_replay(rep, y.clone())
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    bit = bool(torch.equal(got, ref))
    same = bool(torch.equal(got, again))
    del got, ref, again
    work = y.clone()
    ms = time_ms(lambda: rr.rotation_replay(rep, work), reps)
    dms = device_ms(lambda: rr.rotation_replay(rep, work), reps)
    gms = graph_ms(lambda: rr.rotation_replay(rep, work), reps)
    empty = empty_log(rep)
    empty_gms = graph_ms(lambda: rr.rotation_replay(empty, work), reps)
    plain = time_ms(lambda: rr.rotation_replay_plain(rep, work), 2)
    size = y.element_size()
    b_ms, b_by = bound(6.0 * nrot * C,
                       PEAK_FP32 if size == 4 else PEAK_FP64,
                       4.0 * nrot * C * size)
    return dict(what=what, k=k, m=m, C=C, dtype=str(y.dtype).split(".")[-1],
                nrot=nrot, nwave_max=int(rep.nwave.max()),
                plan=replay_plan(rep, y, False),
                max_abs_err=abs_err, max_rel_err=abs_err, tol=0.0,
                bit_exact=bit, run_to_run_identical=same, ms=ms,
                device_ms=dms, graph_ms=gms, empty_log_graph_ms=empty_gms,
                plain_ms=plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by)


def replay_level_rows(d, e, what, f64_row=False):
    """rotation_replay on every level of a mixed solve of (d, e) (staged
    route: n > 8192), on the level's own data; ``f64_row``: the root
    level's y once more in f64 (the pure-f64 path's type)."""
    with recorded_replays() as got:
        st.solve_tridiagonal_staged(d, e, compute_vectors=True)
    rows = [check_rotation_replay(rep, y, f"{what}, level k={k}, m={m}")
            for (k, m), (rep, y) in got.items()]
    if f64_row:
        (k, m), (rep, y) = next(iter(got.items()))
        rows.append(check_rotation_replay(
            rep, y.double(), f"{what}, level k={k}, m={m}, as f64"))
    del got
    torch.cuda.empty_cache()
    return rows


@functools.lru_cache(maxsize=1)
def l2_round_trip_cycles() -> float:
    """An L2 hit's round trip in SM cycles: one thread chasing indices a
    cache line apart through 8 MB held in L2 (``rotation_replay_l2_chase``,
    loads that skip L1), after a pass over the whole cycle that brings
    them there."""
    n = 1 << 16
    stride = 32                          # ints: a 128-byte line apart
    order = np.random.default_rng(7).permutation(n)
    nxt = np.empty(n * stride, np.int32)
    nxt[order * stride] = np.roll(order, -1) * stride
    buf = torch.as_tensor(nxt, device="cuda")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    fn = _build.function("rotation_replay", "rotation_replay_l2_chase",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p])
    steps = 4096
    _build.check_launch(fn(buf.data_ptr(), n, steps, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream),
                        "rotation_replay_l2_chase")
    return float(out[0]) / steps


def check_rotation_replay_t(rep, wt, what, reps=20, host_path=False):
    """rotation_replay_t against its plain version (the torch wave loop
    with rotation_waves' fetches of the log: what rows_through_merge ran
    before) on one level's own (MergeRep, wt): bit for bit, run to run;
    time by events, the profiler and a CUDA graph's replay, and with
    ``host_path`` the host's time a call; the bytes bound (two rows of r
    values read and written a rotation) and the latency floor (a wave an
    L2 round trip)."""
    k, m, r = wt.shape
    nrot = int(rep.nrot.sum())
    got = rr.rotation_replay_t(rep, wt.clone())
    ref = rr.rotation_replay_t_plain(rep, wt.clone())
    again = rr.rotation_replay_t(rep, wt.clone())
    torch.cuda.synchronize()
    abs_err = float((got - ref).abs().max())
    bit = bool(torch.equal(got, ref))
    same = bool(torch.equal(got, again))
    work = wt.clone()
    run = lambda: rr.rotation_replay_t(rep, work)  # noqa: E731
    plain = lambda: rr.rotation_replay_t_plain(rep, work)  # noqa: E731
    t0 = time.perf_counter()
    for _ in range(3):
        plain()
    plain_host_ms = 1e3 * (time.perf_counter() - t0) / 3
    size = wt.element_size()
    nwave = int(rep.nwave.max())
    cycles, mhz = l2_round_trip_cycles(), sm_clock_mhz()
    b_ms, b_by = bound(6.0 * nrot * r, PEAK_FP32 if size == 4 else PEAK_FP64,
                       4.0 * nrot * r * size)
    return dict(what=what, k=k, m=m, r=r, dtype=str(wt.dtype).split(".")[-1],
                log_dtype=str(rep.rot_c.dtype).split(".")[-1], nrot=nrot,
                nwave_max=nwave, plan=replay_plan(rep, wt, True),
                max_abs_err=abs_err, max_rel_err=abs_err, tol=0.0,
                bit_exact=bit, run_to_run_identical=same,
                ms=time_ms(run, reps), device_ms=device_ms(run, reps),
                graph_ms=graph_ms(run, reps),
                host_launch_us=host_launch_us(run, reps) if host_path else None,
                plain_ms=time_ms(plain, 3), plain_host_ms=plain_host_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                latency_floor_ms=nwave * cycles / (mhz * 1e3),
                latency_floor_is=f"nwave_max x an L2 round trip "
                f"({cycles:.0f} cycles, l2_round_trip_cycles) at {mhz:g} MHz")


def rows_t_level_rows(d, e, what, cfg=None):
    """rotation_replay_t on every non-root level of a mixed solve of (d, e)
    (``cfg``: its SolverConfig), on the level's own data, and
    rows_through_merge there once more under torch.cuda's sync debug mode
    (``host_syncs_rows_through_merge``, required 0)."""
    levels = []
    inner = driver.rows_through_merge

    def recorded(rep, w, *args):
        if len(levels) < 32:
            levels.append((rep, w.clone()))
        return inner(rep, w, *args)

    driver.rows_through_merge = recorded
    try:
        with recorded_replays("rotation_replay_t") as got:
            st.solve_tridiagonal_staged(d, e, compute_vectors=False,
                                        config=cfg or st.SolverConfig())
    finally:
        driver.rows_through_merge = inner
    rows = []
    for i, (((k, m), (rep, wt)), (rep_w, w)) in enumerate(zip(got.items(),
                                                              levels)):
        row = check_rotation_replay_t(rep, wt, f"{what}, level k={k}, m={m}",
                                      host_path=i == 0)
        row["host_syncs_rows_through_merge"] = host_syncs(
            lambda: assemble.rows_through_merge(rep_w, w))
        rows.append(row)
    del got, levels
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def recorded_trees():
    """The inputs (ds, zs, defl0, tol) of each merge level's deflation tree
    run inside the block, copied: the first call of each level shape (k,
    m), in the order of the upsweep."""
    got = {}
    inner = sec._deflation_tree

    def recorded(ds, zs, defl0, tol):
        key = tuple(ds.shape)
        if key not in got:
            got[key] = tuple(t.clone() for t in (ds, zs, defl0, tol))
        return inner(ds, zs, defl0, tol)

    sec._deflation_tree = recorded
    try:
        yield got
    finally:
        sec._deflation_tree = inner


def _tree_outputs(out):
    d, z, defl, log = out
    return (d, z, defl, *log)


def same_bits(a, b) -> bool:
    """Equal shape, dtype and bits (-0.0 is not 0.0; a NaN is itself)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = torch.int32 if a.element_size() == 4 else torch.int64
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return bool(torch.equal(a, b))


def check_deflation_tree(args, what, reps=20, host_path=False):
    """deflation_tree against its plain version (the torch loop over the
    tree levels) on one level's own inputs: every output bit for bit (d, z,
    defl, the packed log, nrot, nwave), run to run; time by events, the
    profiler and a CUDA graph's replay, and with ``host_path`` the host's
    time a call and the host syncs of a call (required 0); the bytes bound
    (ds, zs, defl0 read, d, z, defl and the (k, m) log written: 6 s + 26
    bytes a slot for s-byte data) and the latency floor (the tree's levels,
    each at least an L2 round trip)."""
    k, m = args[0].shape
    got = _tree_outputs(dtr.deflation_tree(*args))
    ref = _tree_outputs(dtr.deflation_tree_plain(*args))
    again = _tree_outputs(dtr.deflation_tree(*args))
    torch.cuda.synchronize()
    bit = all(same_bits(g, r) for g, r in zip(got, ref))
    same = all(same_bits(g, r) for g, r in zip(got, again))
    abs_err = max((float((g.double() - r.double()).abs().max())
                   for g, r in zip(got, ref) if g.numel()), default=0.0)
    nrot = int(ref[8].sum())
    nwave = int(ref[9].max()) if k else 0
    del got, ref, again
    run = lambda: dtr.deflation_tree(*args)  # noqa: E731
    plain = lambda: dtr.deflation_tree_plain(*args)  # noqa: E731
    t0 = time.perf_counter()
    for _ in range(3):
        plain()
    torch.cuda.synchronize()
    plain_host_ms = 1e3 * (time.perf_counter() - t0) / 3
    size = args[0].element_size()
    plan = dtr.launch_plan(k, m)
    cycles, mhz = l2_round_trip_cycles(), sm_clock_mhz()
    # ~20 operations a node of the padded tree: an upper bound, far below
    # the bytes
    b_ms, b_by = bound(20.0 * k * (plan.padded - 1),
                       PEAK_FP32 if size == 4 else PEAK_FP64,
                       k * m * (6.0 * size + 26) + k * (size + 16))
    return dict(what=what, k=k, m=m, dtype=str(args[0].dtype).split(".")[-1],
                levels=plan.levels, nrot=nrot, nwave_max=nwave,
                launch_form=(f"{plan.form}: a warp a merge, "
                             f"{plan.merges_per_block} a block"
                             if plan.form == "warp" else
                             f"{plan.form}: {plan.cluster} block(s) of "
                             f"{plan.threads} threads a merge"),
                plan=plan._asdict(),
                **dtr.info(args[0].device, size == 4, plan),
                max_abs_err=abs_err, max_rel_err=abs_err, tol=0.0,
                bit_exact=bit, run_to_run_identical=same,
                ms=time_ms(run, reps), device_ms=device_ms(run, reps),
                graph_ms=graph_ms(run, reps),
                host_launch_us=host_launch_us(run, reps) if host_path else None,
                host_syncs_kernel=host_syncs(run) if host_path else 0,
                plain_ms=time_ms(plain, 3), plain_host_ms=plain_host_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                latency_floor_ms=plan.levels * cycles / (mhz * 1e3),
                latency_floor_is=f"levels x an L2 round trip ({cycles:.0f} "
                f"cycles, l2_round_trip_cycles) at {mhz:g} MHz")


def tree_level_rows(d, e, what, cfg=None):
    """deflation_tree on every merge level of a solve of (d, e) (``cfg``:
    its SolverConfig; eigenvalues only: the upsweep is the whole of the
    tree's path), on the level's own inputs."""
    with recorded_trees() as got:
        st.solve_tridiagonal_staged(d, e, compute_vectors=False,
                                    config=cfg or st.SolverConfig())
    rows = [check_deflation_tree(args, f"{what}, level k={k}, m={m}",
                                 host_path=i == 0)
            for i, ((k, m), args) in enumerate(got.items())]
    del got
    torch.cuda.empty_cache()
    return rows


def synthetic_tree_rows():
    """deflation_tree on synthetic levels of clustered poles (a coarse grid
    plus tiny offsets, a fifth of z exactly 0, 15% deflated before the
    tree): m not a power of two with shared (k=3, m=1000) and global
    (k=2, m=6000, f32) summaries, the CLI's root width (k=1, m=98304),
    and m = 1 and 2."""
    rows = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    for k, m, dtype in ((3, 1000, torch.float64), (2, 6000, torch.float32),
                        (1, 98304, torch.float64), (16, 2, torch.float64),
                        (16, 1, torch.float32)):
        def rand(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.float64)
        ds = torch.sort(torch.round(rand(k, m) * 20.0) / 10.0
                        + 1e-7 * rand(k, m), dim=1).values
        defl0 = torch.rand((k, m), generator=g, device="cuda") < 0.15
        keep = torch.rand((k, m), generator=g, device="cuda") > 0.2
        zs = torch.where(defl0 | ~keep, 0.0, rand(k, m) / m ** 0.5)
        tol = torch.full((k,), 1e-4, dtype=torch.float64, device="cuda")
        args = (ds.to(dtype), zs.to(dtype), defl0, tol.to(dtype))
        rows.append(check_deflation_tree(
            args, f"synthetic clusters, k={k}, m={m}, "
            f"{str(dtype).split('.')[-1]}", reps=10))
    return rows


def plain_replays_substituted(d, e, cfg):
    """Phase 4's input solved through the kernel's two launch forms and once
    with the replays' plain loops substituted: lam and V bit for bit the
    same."""
    out, runs = {}, []
    for route in ("kernels", "plain"):
        reset_counts()
        with plain_replays() if route == "plain" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                 compute_vectors=True)
            torch.cuda.synchronize()
        c = launch_counts()
        out[route] = {"wall_s": time.perf_counter() - t0,
                      "rotation_replay": c["rotation_replay"],
                      "rotation_replay_t": c["rotation_replay_t"]}
        runs.append(res)
    out["lam_equal"] = bool(torch.equal(runs[0].eigenvalues,
                                        runs[1].eigenvalues))
    out["V_equal"] = bool(torch.equal(runs[0].eigenvectors,
                                      runs[1].eigenvectors))
    del runs
    torch.cuda.empty_cache()
    require(out["lam_equal"] and out["V_equal"]
            and out["plain"]["rotation_replay"] == 0
            and out["plain"]["rotation_replay_t"] == 0
            and out["kernels"]["rotation_replay_t"] > 0,
            f"the replays' kernel changes the solve: {out}")
    return out


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


def spike_inputs(n, lam_all, K, shifts, sliced=False):
    """K shifts (random in the spectrum's range, or K of its eigenvalues)
    and unit f32 right-hand sides V (n, K).  ``sliced``: V is the first K
    columns of an n x n matrix (row stride n), the layout in which the
    solve hands each chunk of its downsweep's output to the passes."""
    g = np.random.default_rng(7 if shifts == "random" else 8)
    if shifts == "random":
        lo, hi = float(lam_all.min()), float(lam_all.max())
        lam = torch.as_tensor(np.sort(g.uniform(lo, hi, K)), device="cuda")
    else:
        pick = np.sort(g.choice(n, K, replace=False))
        lam = torch.as_tensor(lam_all[pick], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    V = torch.randn((n, n if sliced else K), dtype=torch.float32,
                    device="cuda", generator=gen)[:, :K]
    V /= torch.linalg.vector_norm(V, dim=0, keepdim=True)
    return lam, V


@contextlib.contextmanager
def first_spike_refine():
    """Records the arguments (d, e, lam, V) of the first spike_refine call
    made inside the block: in a mixed solve, its refinement of the f32
    downsweep's output."""
    seen = []
    refine = sp.spike_refine

    def recorded(d, e, lam, V, *args, **kwargs):
        if not seen:
            seen.append((d, e, lam, V))
        return refine(d, e, lam, V, *args, **kwargs)

    sp.spike_refine = recorded
    try:
        yield seen
    finally:
        sp.spike_refine = refine


def check_spike(d, e, lam, V, nb, shifts, reps):
    """Pass A and pass B against their plain versions at the main path's
    refinement shape (the prescaled system (d, e), one chunk of K columns
    of right-hand sides V with shifts lam), and the normalized spike_refine
    result."""
    n, K = V.shape
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
    exact_a = bool(torch.equal(bnd, bnd_p))
    exact_b = bool(torch.equal(X, X_p) and torch.equal(mx, mx_p))
    ms_a = time_ms(lambda: sp.spike_pass_a(db, e_all, tiny, lam, V, nb), reps)
    dms_a = device_ms(lambda: sp.spike_pass_a(db, e_all, tiny, lam, V, nb),
                      reps)
    plain_a = time_ms(lambda: sp.spike_pass_a_plain(db, e_all, tiny, lam, V,
                                                    nb), 2)
    ms_b = time_ms(lambda: sp.spike_pass_b(*bargs), reps)
    dms_b = device_ms(lambda: sp.spike_pass_b(*bargs), reps)
    plain_b = time_ms(lambda: sp.spike_pass_b_plain(*bargs), 2)
    npad = db.shape[0]
    # the plain block LU's work, whatever the kernel re-eliminates: every
    # (row, column) pair issues one row's FP64 instructions, counted in the
    # SASS of the row yardsticks, at the FP64 instruction rate
    rate, per_row = fp64_rate(), spike_fp64_per_row()
    in_bytes = V.element_size() * float(n) * K + 8.0 * (2 * npad + K + 1)
    ba = bound(float(npad) * K * per_row["A"], rate,
               in_bytes + 8.0 * 6 * P * K)
    bb = bound(float(npad) * K * per_row["B"], rate,
               in_bytes + 8.0 * (4 * P + 2 * P * K) + 8.0 * (npad * K + P * K))
    common = dict(n=n, nb=nb, K=K, shifts=shifts, v_row_stride=V.stride(0),
                  tol=1e-12,
                  tol_of="column max |x|", refine_rel_err=err_r,
                  refine_abs_err=abs_r, res_est_rel_err=err_res,
                  clipped_columns=int((res >= 1e29).sum()),
                  fp64_instr_per_s=rate,
                  bound_is="the plain LU's FP64 instructions (SASS of the "
                  "row yardstick) at 64 a clock an SM, or its bytes")
    require(err_res <= 1e-10, f"spike_refine estimates disagree ({shifts}): "
            f"{err_res}")
    scr_a = scratch_bytes(lambda: sp.spike_pass_a(db, e_all, tiny, lam, V,
                                                  nb))
    scr_b = scratch_bytes(lambda: sp.spike_pass_b(*bargs))
    return (dict(common, pass_="A", bit_exact=exact_a, max_rel_err=err_a,
                 max_abs_err=abs_a, scratch_bytes=scr_a,
                 **spike_plan_fields("A", nb, V),
                 fp64_instr_per_row=per_row["A"], ms=ms_a, device_ms=dms_a,
                 plain_ms=plain_a, library_ms=None, bound_ms=ba[0],
                 bound_by=ba[1]),
            dict(common, pass_="B", bit_exact=exact_b,
                 max_rel_err=max(err_b, err_mx, err_r), max_abs_err=abs_b,
                 scratch_bytes=scr_b,
                 **spike_plan_fields("B", nb, V),
                 fp64_instr_per_row=per_row["B"], ms=ms_b, device_ms=dms_b,
                 plain_ms=plain_b, library_ms=None, bound_ms=bb[0],
                 bound_by=bb[1]))


# --------------------------------------------------------------------------
# the refinement's scans: interface_solve and block_lu_solve

@contextlib.contextmanager
def plain_scans():
    """The two scan kernels' wrappers replaced by their plain versions (on
    the card), in this script only: the solve as it ran before they were
    kernels."""
    inner = shs.interface_solve, shs.block_lu_solve
    shs.interface_solve = shs.interface_solve_plain
    shs.block_lu_solve = shs.block_lu_solve_plain
    try:
        yield
    finally:
        shs.interface_solve, shs.block_lu_solve = inner


@contextlib.contextmanager
def recorded_scans():
    """Records what a solve inside the block hands the scans: the first
    Spike pass's interface inputs (pass A's boundary values, the couplers),
    its first refinement chunk (d, e, lam, V widened to f64: the blocked
    solver's shape at refine_block when use_pallas_refine=False), and every
    block-LU call of the triage's extra and rescue passes."""
    seen = {"interface": [], "first_pass": [], "block_lu": []}
    inner = sp._interface, sp.spike_refine, shs.block_lu_solve

    def interface(bnd, e_cross, ec_above):
        if not seen["interface"]:
            seen["interface"].append((bnd, e_cross, ec_above))
        return inner[0](bnd, e_cross, ec_above)

    def refine(d, e, lam, V, *args, **kwargs):
        if not seen["first_pass"]:
            k = min(2048, V.shape[1])
            seen["first_pass"].append((d, e, lam[:k], V[:, :k].to(
                torch.float64)))
        return inner[1](d, e, lam, V, *args, **kwargs)

    def block_lu(*args):
        seen["block_lu"].append(args)
        return inner[2](*args)

    sp._interface, sp.spike_refine, shs.block_lu_solve = (interface, refine,
                                                          block_lu)
    try:
        yield seen
    finally:
        sp._interface, sp.spike_refine, shs.block_lu_solve = inner


@functools.cache
def scan_inputs(matrix):
    """One mixed n=16384 solve of bench.py's input ("random") or of the
    Poisson matrix, recorded (:func:`recorded_scans`), and its triage
    counts."""
    d, e = (random_matrix(N, SEED) if matrix == "random"
            else st.create_matrix_scheme2(N))
    with recorded_scans() as seen:
        res, timer = st.solve_tridiagonal_staged(d, e, compute_vectors=True)
    del res
    torch.cuda.empty_cache()
    return seen, dict(timer.counts)


def block_lu_args(d, e, lam, V, nb):
    """block_lu_solve's arguments for the blocked solve of (d, e) at block
    size nb."""
    db, e_all, e_cross, ec_above, tiny = band_prep(d, e, nb)
    return (db, e_all, tiny, ec_above, e_cross, lam, V.contiguous(), nb)


def rebanded(args, nb):
    """A recorded block-LU call's system and columns at block size nb (the
    band's first n entries are d, e_all's first n-1 are e)."""
    db, e_all, _tiny, _eca, _ecr, lam, V, _nb = args
    n = V.shape[0]
    return block_lu_args(db[:n], e_all[:n - 1], lam, V, nb)


def interface_fp64_per_step():
    """FP64 instructions of one (block, column) step of interface_solve,
    both sweeps, in the Spike pass's scaled form:
    interface_step_yardstick."""
    counts = sass_fp64_counts("interface_solve", "interface_step_yardstick")
    require(len(counts) == 1, f"one interface yardstick: {counts}")
    return next(iter(counts.values()))


def block_lu_fp64_per_row():
    """FP64 instructions of one (row, column) of the block LU, its couplers'
    products included: block_lu_row_yardstick."""
    counts = sass_fp64_counts("spike_solve", "block_lu_row_yardstick")
    require(len(counts) == 1, f"one block-LU yardstick: {counts}")
    return next(iter(counts.values()))


def _exactness(got, want, again):
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return dict(bit_exact=all(torch.equal(g, w) for g, w in zip(got, want)),
                run_to_run_identical=all(torch.equal(g, a)
                                         for g, a in zip(got, again)),
                max_abs_err=err, max_rel_err=err / max(scale, 1e-300),
                tol=0.0, tol_of="bit for bit its plain version")


# Cycles of one forward step of interface_solve's dependent chain (the
# floor on d11, the divisions, the products and sums of h2 and g21): the
# chain phase a step that tools/kernel_phase_probe.py measures for column 0
# on an H100 at the P=171, K=5 triage shape (0.1452 us at 1980 MHz), every
# input already in shared memory.
IF_STEP_CYCLES = 287.0


def sm_clock_mhz() -> float:
    """The SM clock now (nvidia-smi clocks.sm)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])


def check_interface(ins, scales, shifted, what, reps):
    """interface_solve against its plain version on the card, on one set of
    the six (P, K) boundary inputs: bit for bit, identical run to run, its
    launch plan and scratch, times (events, profiler), the plain loop's
    time, a bound from the bytes of the inputs and outputs or the FP64
    instructions of the yardstick step, and the latency floor: 2 P
    dependent steps of IF_STEP_CYCLES at the SM clock of this run."""
    ec, ecr = scales
    kw = dict(ec_above=ec, e_cross=ecr, shifted=shifted)
    call = functools.partial(shs.interface_solve, *ins, **kw)
    got = call()
    want = shs.interface_solve_plain(*ins, **kw)
    row = _exactness(got, want, call())
    P, K = ins[4].shape
    per_step = interface_fp64_per_step()
    b = bound(float(P) * K * per_step, fp64_rate(),
              8.0 * (8.0 * P * K + sum(P for s in scales if s is not None)))
    plan = shs.interface_device_plan(P, K, ins[4].device)
    mhz = sm_clock_mhz()
    row.update(what=what, P=P, K=K, scaled=ec is not None, shifted=shifted,
               input_row_stride=ins[4].stride(0), threads=64,
               plan=plan._asdict(), blocks=plan.blocks,
               scratch_bytes=scratch_bytes(call),
               latency_floor_ms=2.0 * P * IF_STEP_CYCLES / (mhz * 1e3),
               latency_floor_is=f"2 P steps x {IF_STEP_CYCLES:g} cycles "
               "(a forward step's chain, tools/kernel_phase_probe.py) at "
               f"the SM clock of this run, {mhz:g} MHz",
               fp64_instr_per_step=per_step,
               ms=time_ms(call, reps), device_ms=device_ms(call, reps),
               plain_ms=time_ms(functools.partial(
                   shs.interface_solve_plain, *ins, **kw), 2),
               library_ms=None, bound_ms=b[0], bound_by=b[1],
               bound_is="8 P K doubles (six inputs, two outputs) or the "
               "Spike form's FP64 instructions a (block, column) step "
               "(SASS of the yardstick) at 64 a clock an SM")
    return row


def check_block_lu(args, what, reps):
    """block_lu_solve against its plain version on the card, on one blocked
    solve's arguments: bit for bit, identical run to run, the launch plan,
    registers and spills, times, the plain loop's time, and a bound from
    the FP64 instructions of the yardstick row or the bytes."""
    call = functools.partial(shs.block_lu_solve, *args)
    got = call()
    want = shs.block_lu_solve_plain(*args)
    row = _exactness(got, want, call())
    db, V, nb = args[0], args[6], args[7]
    npad = db.shape[0]
    n, K = V.shape
    P = npad // nb
    form = shs.block_lu_plan(nb, K)
    if form.form == "narrow":
        regs, spill = shs.narrow_info()
        layout = dict(launch_form="narrow: 32 (row block, column) pairs a "
                      "block, a warp a right-hand side, every row's factors "
                      "in shared memory",
                      blocks=shs.narrow_grid(P, K), pairs=form.pairs,
                      threads=form.threads,
                      shared_bytes=form.shared_bytes, registers=regs,
                      spill_bytes=spill)
    else:
        plan = shs.plan_for("L", nb, V)
        regs, spill, blocks = shs.kernel_info("L", False, plan.threads,
                                              plan.shared_bytes)
        layout = dict(launch_form="wide: a thread a (row block, column), "
                      "checkpointed segments re-eliminated",
                      segment_rows=plan.segment,
                      checkpoints=plan.checkpoints, threads=plan.threads,
                      shared_bytes=plan.shared_bytes, registers=regs,
                      spill_bytes=spill, blocks_per_sm=blocks)
    per_row = block_lu_fp64_per_row()
    b = bound(float(npad) * K * per_row, fp64_rate(),
              8.0 * (n * K + 2 * npad + 2 * P + K + 1 + 3 * npad * K))
    row.update(what=what, n=n, nb=nb, P=P, K=K, v_row_stride=V.stride(0),
               **layout,
               fp64_instr_per_row=per_row,
               ms=time_ms(call, reps), device_ms=device_ms(call, reps),
               plain_ms=time_ms(functools.partial(
                   shs.block_lu_solve_plain, *args), 2),
               library_ms=None, bound_ms=b[0], bound_by=b[1],
               bound_is="the plain LU's FP64 instructions a row and column "
               "with the couplers' products (SASS of the yardstick) at 64 a "
               "clock an SM, or V's bytes and the three outputs'")
    return row


def blocked_boundary(args):
    """The blocked solver's interface inputs from one block-LU call: the
    kernel's u, p, q at each block's first and last row."""
    nb = args[7]
    K = args[6].shape[1]
    u, p, q = (t.view(-1, nb, K) for t in shs.block_lu_solve(*args))
    return (p[:, 0], p[:, nb - 1], q[:, 0], q[:, nb - 1], u[:, 0],
            u[:, nb - 1])


def triage_calls(matrix):
    """The recorded block-LU calls of a solve's extra pass (nb =
    refine_block_alt) and rescue pass (refine_block_rescue); a pass the
    solve did not make is the extra pass's columns re-banded at its block
    size (its shape, on the same columns).  [] when nothing was risky."""
    seen, counts = scan_inputs(matrix)
    cfg = st.SolverConfig()
    calls = seen["block_lu"]
    out = []
    for tag, nb in (("extra pass", cfg.refine_block_alt),
                    ("rescue pass", cfg.refine_block_rescue)):
        mine = [a for a in calls if a[7] == nb]
        if mine:
            out.append((f"{tag}, nb={nb}, the solve's own call", mine[0]))
        elif calls:
            out.append((f"{tag}'s shape, nb={nb}, on the extra pass's "
                        "columns (no such pass in this solve)",
                        rebanded(calls[0], nb)))
    return out, counts


def interface_rows():
    """interface_solve on the mixed n=16384 solve's own pass-1 boundary
    values (P=128, K=16384, scaled and shifted: the Spike pass), on the
    boundary rows of its triage's blocked solves (nb=96 and 64), and on the
    Poisson solve's pass-1 boundary values."""
    rows = []
    for matrix in ("random", "poisson"):
        seen, counts = scan_inputs(matrix)
        bnd, e_cross, ec_above = seen["interface"][0]
        rows.append(check_interface(
            (bnd[2], bnd[3], bnd[4], bnd[5], bnd[0], bnd[1]),
            (ec_above, e_cross), True,
            f"{matrix} n={N}: the Spike pass's pass-1 boundary values", 5))
        calls, _ = triage_calls(matrix)
        for what, args in calls:
            rows.append(check_interface(
                blocked_boundary(args), (None, None), True,
                f"{matrix} n={N}: {what} ({counts.get('risky')} risky)",
                20))
    return rows


def block_lu_rows():
    """block_lu_solve at the mixed n=16384 solve's triage shapes (its extra
    and rescue passes: nb=96 and 64, the risky columns; the main path's
    launches), then on its first refinement chunk at nb=128 (the
    use_pallas_refine=False shape, K=2048); the same for the Poisson
    solve."""
    rows = []
    for matrix in ("random", "poisson"):
        seen, counts = scan_inputs(matrix)
        calls, _ = triage_calls(matrix)
        for what, args in calls:
            rows.append(check_block_lu(
                args, f"{matrix} n={N}: {what} ({counts.get('risky')} "
                "risky)", 20))
        d, e, lam, V = seen["first_pass"][0]
        rows.append(check_block_lu(
            block_lu_args(d, e, lam, V, 128),
            f"{matrix} n={N}: the first refinement chunk, nb=128", 5))
    return rows


@contextlib.contextmanager
def range_host_times():
    """The host time and calls of the two refinement ranges in the block
    (host clock around spike_solve._interface, the spike.interface_solve
    range, and driver._triage_passes, the refine.triage range): what a
    solve's host spends there, profiler off."""
    out = {"spike.interface_solve": {"calls": 0, "host_s": 0.0},
           "refine.triage": {"calls": 0, "host_s": 0.0}}
    inner = sp._interface, driver._triage_passes

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                out[name]["calls"] += 1
                out[name]["host_s"] += time.perf_counter() - t0
        return run

    sp._interface = timed("spike.interface_solve", inner[0])
    driver._triage_passes = timed("refine.triage", inner[1])
    try:
        yield out
    finally:
        sp._interface, driver._triage_passes = inner


def check_scan_launches(launches, counts, spike_passes, path):
    """One interface_solve launch a Spike pass and one a blocked solve
    (each with one block_lu_solve launch); block_lu_solve launched exactly
    when the triage found risky columns (the extra pass runs the blocked
    solver by default)."""
    require(launches["interface_solve"]
            == spike_passes + launches["block_lu_solve"],
            f"{path}: interface_solve launched {launches['interface_solve']} "
            f"times for {spike_passes} Spike passes and "
            f"{launches['block_lu_solve']} blocked solves")
    require((launches["block_lu_solve"] > 0) == (counts.get("risky", 0) > 0),
            f"{path}: block_lu_solve launched {launches['block_lu_solve']} "
            f"times with {counts.get('risky', 0)} risky columns")


def plain_substituted_check(d, e, cfg):
    """Phase 4's input solved twice through the kernels and once with the
    scans' plain versions substituted: V bit for bit the same, the triage's
    counts the same."""
    out = {}
    Vs = []
    for route in ("kernels", "plain", "kernels_again"):
        reset_counts()
        with plain_scans() if route == "plain" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                     compute_vectors=True)
            torch.cuda.synchronize()
        c = launch_counts()
        out[route] = {"wall_s": time.perf_counter() - t0,
                      "counts": dict(timer.counts),
                      "interface_solve": c["interface_solve"],
                      "block_lu_solve": c["block_lu_solve"]}
        Vs.append(res.eigenvectors)
        del res
    out["V_plain_equal_kernels"] = bool(torch.equal(Vs[0], Vs[1]))
    out["V_kernels_run_to_run"] = bool(torch.equal(Vs[0], Vs[2]))
    out["max_abs_diff"] = float((Vs[0] - Vs[1]).abs().max())
    del Vs
    torch.cuda.empty_cache()
    require(out["V_plain_equal_kernels"] and out["V_kernels_run_to_run"]
            and out["plain"]["counts"] == out["kernels"]["counts"]
            and out["plain"]["interface_solve"] == 0
            and out["plain"]["block_lu_solve"] == 0,
            f"the scans' kernels change the solve: {out}")
    return out


def scratch_bytes(call) -> int:
    """Device memory one call allocates beyond what it returns: its peak
    allocation over what was allocated before, less its outputs."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    kept = sum(t.numel() * t.element_size() for t in outs)
    return torch.cuda.max_memory_allocated() - before - kept


def spike_plan_fields(which, nb, V):
    """The launch plan of a Spike pass and its kernel's registers, spills
    and blocks an SM holds (occupancy API)."""
    plan = sp.plan_for(which, nb, V)
    regs, spill, blocks = sp.kernel_info(which, V.dtype == torch.float32,
                                         plan.threads, plan.shared_bytes)
    return dict(segment_rows=plan.segment, checkpoints=plan.checkpoints,
                threads=plan.threads, shared_bytes=plan.shared_bytes,
                registers=regs, spill_bytes=spill, blocks_per_sm=blocks)


_FP64_SASS = re.compile(r"\s(DADD|DMUL|DFMA|DSETP|DMNMX|MUFU\.RCP64H)\b")


_SASS_COUNTS = {}


def sass_fp64_counts(source, marker):
    """{kernel: FP64 instructions} of every kernel whose mangled name holds
    ``marker`` in cuobjdump's SASS of the built library ``source``, counted
    up to the kernel's EXIT (a division's or a reciprocal's slow path, a
    subroutine past it, is left out).  Read once per (source, marker)."""
    key = (source, marker)
    if key not in _SASS_COUNTS:
        tool = Path(_build.nvcc_path()).parent / "cuobjdump"
        sass = subprocess.run([str(tool), "-sass",
                               str(_build.library_path(source))],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        counts = {}
        for part in sass.split("Function : ")[1:]:
            name = part.split("\n", 1)[0].strip()
            if marker not in name:
                continue
            body = re.split(r"^\s*/\*[0-9a-f]+\*/\s+EXIT\s*;", part,
                            maxsplit=1, flags=re.M)[0]
            counts[name] = len(_FP64_SASS.findall(body))
        require(bool(counts) and min(counts.values()) > 0,
                f"no {marker} in the SASS of {source}: {counts}")
        _SASS_COUNTS[key] = counts
    return _SASS_COUNTS[key]


def _instance(counts, tag):
    """The count of the one template instance whose name holds ``tag``."""
    found = [v for name, v in counts.items() if tag in name]
    require(len(found) == 1, f"no single instance {tag} in {counts}")
    return found[0]


def spike_fp64_per_row():
    """FP64 instructions one row of the plain block LU issues, per pass:
    spike_row_yardstick<3> (pass A) and <1> (pass B)."""
    counts = sass_fp64_counts("spike_solve", "spike_row_yardstick")
    return {"A": _instance(counts, "ILi3E"), "B": _instance(counts, "ILi1E")}


def rowsum_fp64_per_term(R):
    """FP64 instructions of one (pole, column) term of cauchy_rowsum with R
    rows: cauchy_rowsum_term_yardstick<R>."""
    return _instance(sass_fp64_counts("cauchy_rowsum",
                                      "cauchy_rowsum_term_yardstick"),
                     f"ILi{R}E")


def secular_fp64_per_term():
    """FP64 instructions of one (root, pole) term of the secular sweeps:
    secular_sums_term_yardstick."""
    counts = sass_fp64_counts("secular_sums", "secular_sums_term_yardstick")
    require(len(counts) == 1, f"one secular term yardstick: {counts}")
    return next(iter(counts.values()))


@functools.cache
def fp64_rate():
    """FP64 instructions a second: 64 a clock on each SM, at the card's
    maximum SM clock (nvidia-smi)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 64.0 * sms * float(mhz) * 1e6


# --------------------------------------------------------------------------
# the main path

def all_finite(V, chunk: int = 2048) -> bool:
    """Every entry of V finite, in column chunks: torch.isfinite of a
    floating tensor builds |V| and two masks, which for the n=65536 basis
    is 40 GiB more than the basis itself."""
    return bool(torch.stack([torch.isfinite(V[:, o:o + chunk]).all()
                             for o in range(0, V.shape[1], chunk)]).all())


def solve_and_check(d, e, cfg, ref, norm_ref):
    """One solve_tridiagonal_staged call with eigenvectors; returns its
    JSON fields and the eigenvalues (host) after checking residual,
    orthogonality and eigenvalues."""
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
            and all_finite(V) and np.isfinite(lam).all(),
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
    return out, lam


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


RANGES = ("spike.interface_solve", "refine.triage", "secular.solve_roots",
          "upsweep.tear_leaves", "merge.partition", "merge.z_colnorm",
          "merge.rows_through_merge")


@contextlib.contextmanager
def record_levels():
    """Each merge level's (k, m), its merges' active counts K and the root
    finder's launches at that level, recorded around
    secular._solve_roots (K is read back to the host: one sync a level,
    in the run recorded only), with the midpoint sweep's bound."""
    levels = []
    inner = sec._solve_roots
    per_term, rate = secular_fp64_per_term(), fp64_rate()

    def recorded(poles_sec, zu, rho_e, K, *args, **kwargs):
        before = (ss.launches, ss.solve_launches)
        out = inner(poles_sec, zu, rho_e, K, *args, **kwargs)
        k, m = poles_sec.shape
        Ks = K.tolist()
        levels.append({
            "k": k, "m": m, "K_sum": sum(Ks), "K_min": min(Ks),
            "K_max": max(Ks), **({"K": Ks} if k <= 4 else {}),
            "secular_sums_launches": ss.launches - before[0],
            "secular_solve_launches": ss.solve_launches - before[1],
            "secular_sums_bound_ms": bound(per_term * m * sum(Ks), rate,
                                           8.0 * 9 * k * m)[0]})
        return out

    sec._solve_roots = recorded
    try:
        yield levels
    finally:
        sec._solve_roots = inner


def _launches_under(ev) -> int:
    """Kernels launched by a profiler event and everything it called."""
    return len(ev.kernels) + sum(_launches_under(c) for c in ev.cpu_children)


def profile_solve(run, top: int = 16):
    """Device time by kernel over one call of ``run`` (torch.profiler), the
    device's busy time and idle share of the wall, and for the interface
    solve's and the triage's ranges their host wall, device span and kernel
    launches."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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


# --------------------------------------------------------------------------
# the small-n routes: staged and fused (part A one CUDA graph) at n <= 8192

N_SMALL = (4096, 8192)
FUSED_KERNELS = ("rotation_replay", "cauchy_matmul", "cauchy_materialize",
                 "spike_pass_a", "spike_pass_b", "interface_solve")
GRAPH_RANGES_NOTE = ("record_function ranges inside part A's CUDA graph "
                     "(spike.interface_solve) are not recorded on a replay")


def host_syncs(run) -> int:
    """Synchronizing CUDA calls of ``run()`` (each one warns in torch.cuda's
    sync debug mode), as tools/torch_solve_profile.py counts them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def small_cell(d, e, ref, norm_ref, cfg, warm: int = 5):
    """Both routes at one small cell.  Cold: the staged route, then the
    fused one after dropping the cached graphs (its wall holds the warm-up
    run and the capture), each with every check.  Warm: ``warm`` rounds of
    one solve of each route, in turns (which goes first alternates: the
    host's speed drifts within a call), nothing emptied between them (a
    caller's repeated solves); the median wall and its phases.  Then one
    more warm solve of each for launches, graph replays and peak memory
    (the fused graph cached: its pool's live blocks count in both), and
    one for host syncs.  Returns {"staged": ..., "fused": ...}."""
    routes = (("staged", False), ("fused", True))
    solve = functools.partial(st.solve_tridiagonal_staged, d, e, config=cfg,
                              compute_vectors=True)
    out = {}
    for name, fused in routes:
        # no graph cached at either cold solve: the staged peak holds none,
        # the fused cold solve captures its own
        driver.FUSED_BT_OVERRIDE = fused
        driver.clear_fused_graphs()
        torch.cuda.empty_cache()
        reset_counts()
        r0 = driver.graph_replays
        cold, _ = solve_and_check(d, e, cfg, ref, norm_ref)
        out[name] = {"cold": cold,
                     "cold_graph_replays": driver.graph_replays - r0,
                     "warm_walls_s": [], "phases": []}
    for i in range(warm):
        for name, fused in (routes if i % 2 == 0 else routes[::-1]):
            driver.FUSED_BT_OVERRIDE = fused
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, timer = solve()
            torch.cuda.synchronize()
            out[name]["warm_walls_s"].append(time.perf_counter() - t0)
            out[name]["phases"].append(timer.times)
            del res
    for name, fused in routes:
        o = out[name]
        walls = o["warm_walls_s"]
        o["warm_median_s"] = float(np.median(walls))
        o["warm_median_phases_s"] = o.pop("phases")[
            int(np.argsort(walls)[len(walls) // 2])]
        driver.FUSED_BT_OVERRIDE = fused
        reset_counts()
        r0 = driver.graph_replays
        torch.cuda.reset_peak_memory_stats()
        res, _ = solve()
        torch.cuda.synchronize()
        o.update(warm_launches=launch_counts(),
                 warm_graph_replays=driver.graph_replays - r0,
                 warm_peak_mem_bytes=torch.cuda.max_memory_allocated())
        del res
        o["host_syncs"] = host_syncs(solve)
        key = "bt.fused_bt" if fused else "bt.downsweep"
        require(key in o["cold"]["phases_s"]
                and key in o["warm_median_phases_s"],
                f"{name} route not taken: {o['warm_median_phases_s']}")
    f = out["fused"]
    require(f["cold_graph_replays"] == 1 and f["warm_graph_replays"] == 1,
            f"part A not one graph replay a solve: {f}")
    for name in FUSED_KERNELS:
        require(f["warm_launches"][name] > 0,
                f"fused route: {name} not launched")
    out["reserved_bytes_after"] = torch.cuda.memory_reserved()
    return out


def run_small_n(cfg):
    """n=4096 and n=8192, random and Poisson: the staged and the fused
    route side by side; then two fused solves in a row, one profiled warm
    solve of each route at n=8192, and a capture made under the profiler
    (the CLI's --profile-dir).  Returns each cell's warm medians."""
    medians = {}
    try:
        for n in N_SMALL:
            dp, ep = (np.asarray(a) for a in st.create_matrix_scheme2(n))
            for matrix, (d, e) in (("random", random_matrix(n, SEED)),
                                   ("poisson", (dp, ep))):
                t0 = time.perf_counter()
                ref = scipy.linalg.eigvalsh_tridiagonal(d, e)
                ref_s = time.perf_counter() - t0
                norm_ref = float(np.abs(ref).max())
                cell = small_cell(d, e, ref, norm_ref, cfg)
                ratio = (cell["fused"]["warm_median_s"]
                         / cell["staged"]["warm_median_s"])
                medians[f"{matrix}_{n}"] = ratio
                emit({"phase": "small_n", "n": n, "matrix": matrix,
                      "seed": SEED if matrix == "random" else None,
                      "config": "SolverConfig()", "scipy_reference_s": ref_s,
                      **cell, "fused_over_staged_warm_median": ratio})
        # two fused solves in a row: the second replay overwrites part A's
        # buffers, so each result must be a tensor of its own
        n = N_SMALL[0]
        d, e = random_matrix(n, SEED)
        driver.FUSED_BT_OVERRIDE = True
        r1, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                            compute_vectors=True)
        r2, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                            compute_vectors=True)
        norm_ref = float(r1.eigenvalues.abs().max())
        res1 = float(st.residuals(d, e, r1).max()) / norm_ref
        res2 = float(st.residuals(d, e, r2).max()) / norm_ref
        twice = {"distinct": r1.eigenvectors.data_ptr()
                 != r2.eigenvectors.data_ptr(),
                 "identical_values": bool(torch.equal(r1.eigenvectors,
                                                      r2.eigenvectors)),
                 "residual_first_after_second": res1,
                 "residual_second": res2}
        del r1, r2
        require(twice["distinct"] and res1 <= 1e-12 and res2 <= 1e-12,
                f"two fused solves in a row: {twice}")
        # where the time goes at n=8192, each route (warm, cached graph)
        n = N_SMALL[1]
        d, e = random_matrix(n, SEED)
        profiles = {}
        for route, fused in (("staged", False), ("fused", True)):
            driver.FUSED_BT_OVERRIDE = fused
            st.solve_tridiagonal_staged(d, e, config=cfg,
                                        compute_vectors=True)
            profiles[route] = profile_solve(
                lambda: st.solve_tridiagonal_staged(d, e, config=cfg,
                                                    compute_vectors=True))
        # a capture under the profiler, as --profile-dir makes one
        n = N_SMALL[0]
        d, e = random_matrix(n, SEED)
        driver.clear_fused_graphs()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            r, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                               compute_vectors=True)
            torch.cuda.synchronize()
        res_p = float(st.residuals(d, e, r).max()) / float(
            r.eigenvalues.abs().max())
        del r
        require(res_p <= 1e-12, f"capture under the profiler: {res_p}")
    finally:
        # the default again, and no graph pool held into the later phases'
        # peaks
        driver.FUSED_BT_OVERRIDE = False
        driver.clear_fused_graphs()
    emit({"phase": "small_n_checks", "two_fused_solves": twice,
          "profile_8192_random": profiles, "ranges_note": GRAPH_RANGES_NOTE,
          "capture_under_profiler_residual_over_normT": res_p,
          "fused_over_staged_warm_median": medians,
          "fused_no_worse_everywhere": all(r <= 1.0
                                           for r in medians.values()),
          "gate_default": driver._fused_bt_enabled(
              N_SMALL[1], cfg, False, True, N_SMALL[1])})
    torch.cuda.empty_cache()
    return medians


# --------------------------------------------------------------------------
# the memory routes: staged at n=32768, grouped and streamed at n=65536

GROUPED = "bt.downsweep_refine_grouped"


def host_reference(n: int):
    """The random input at size n and its spectrum from scipy on the host
    (timed: O(n^2) in LAPACK, once a size)."""
    d, e = random_matrix(n, SEED)
    t0 = time.perf_counter()
    ref = scipy.linalg.eigvalsh_tridiagonal(d, e)
    return d, e, ref, float(np.abs(ref).max()), time.perf_counter() - t0


@contextlib.contextmanager
def record_route():
    """The grouped route's threshold and group width, and every refinement
    chunk, as a solve resolved them on the card (recorded around the
    driver's own functions)."""
    got = {"threshold_bytes": [], "group_width": [], "refine_chunk": []}
    bt_bytes, width = driver._grouped_bt_bytes, driver._group_width
    chunk = st.SolverConfig.resolved_refine_chunk

    def rec(key, fn):
        def recorded(*args):
            got[key].append(fn(*args))
            return got[key][-1]
        return recorded

    driver._grouped_bt_bytes = rec("threshold_bytes", bt_bytes)
    driver._group_width = rec("group_width", width)
    st.SolverConfig.resolved_refine_chunk = rec("refine_chunk", chunk)
    try:
        yield got
    finally:
        driver._grouped_bt_bytes, driver._group_width = bt_bytes, width
        st.SolverConfig.resolved_refine_chunk = chunk


MAIN_PATH_KERNELS = ("cauchy_matmul", "cauchy_materialize", "spike_pass_a",
                     "spike_pass_b", "secular_sums", "secular_solve",
                     "cauchy_rowsum", "rotation_replay", "rotation_replay_t",
                     "interface_solve", "deflation_tree")


def run_staged_large(cfg):
    """n=32768 through the plain staged route (12 n^2 stays under the
    grouped threshold): the first peak measured above n=16384, beside the
    19.2 n^2 bytes that n=16384's 5.16 GB scales to."""
    n = N_LARGE
    d, e, ref, norm_ref, ref_s = host_reference(n)
    torch.cuda.empty_cache()
    reset_counts()
    with record_route() as route:
        out, _ = solve_and_check(d, e, cfg, ref, norm_ref)
    require(GROUPED not in out["phases_s"], f"n={n} took the grouped route")
    emit({"phase": "staged_32768", "n": n, "matrix": "random", "seed": SEED,
          "scipy_reference_s": ref_s, **out,
          "peak_estimate_bytes": 19.2 * n * n,
          "peak_over_n2": out["peak_mem_bytes"] / float(n * n),
          "twelve_n_C_bytes": 12.0 * n * n, "route": route})
    for name in MAIN_PATH_KERNELS:
        require(out["launches"][name] > 0, f"{name} not launched at n={n}")


def run_grouped(cfg):
    """n=65536 full eigenpairs resident: the switch takes the grouped route
    on its own.  Returns the eigenvalues and the reference's pieces."""
    n = N_HUGE
    d, e, ref, norm_ref, ref_s = host_reference(n)
    torch.cuda.empty_cache()
    reset_counts()
    with record_levels() as levels, record_route() as route:
        out, lam = solve_and_check(d, e, cfg, ref, norm_ref)
    require(GROUPED in out["phases_s"],
            f"n={n} did not take the grouped route: {out['phases_s']}")
    g = route["group_width"][0]
    total = torch.cuda.get_device_properties(0).total_memory
    estimate = 8.0 * n * n + 12.0 * n * g
    emit({"phase": "grouped", "n": n, "matrix": "random", "seed": SEED,
          "config": "SolverConfig()", "scipy_reference_s": ref_s, **out,
          "levels": levels, "threshold_bytes": route["threshold_bytes"][0],
          "twelve_n_C_bytes": 12.0 * n * n, "group_width": g,
          "groups": -(-n // g), "refine_chunks": route["refine_chunk"],
          "peak_estimate_bytes": estimate, "device_total_bytes": total})
    require(out["peak_mem_bytes"] < total, "peak over the card's memory")
    for name in MAIN_PATH_KERNELS:
        require(out["launches"][name] > 0, f"{name} not launched at n={n}")
    return d, e, lam, norm_ref


def run_streamed(cfg, d, e, lam_grouped, norm_ref):
    """n=65536 drained in group=4096 / halo=256 blocks (N65536_FULL.json's
    parameters): each block's residual, Gram and cross-Gram with the one
    before, and at the end a seeded sample of 8 columns a block."""
    n = N_HUGE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lam, blocks, timer = st.solve_tridiagonal_streamed(
        d, e, config=cfg, group=STREAM_GROUP, halo=STREAM_HALO)
    lam = lam.cpu().numpy()
    require(np.array_equal(lam, lam_grouped),
            "streamed eigenvalues differ from the grouped solve's")
    rng = np.random.default_rng(SEED)
    rows, samples, prev = [], [], None
    for a, Vo in blocks:
        w = int(Vo.shape[1])
        require(Vo.shape == (n, w) and Vo.dtype == torch.float64
                and all_finite(Vo), f"block {a} misshapen")
        res = float(st.residuals(d, e, st.EighTridiagonalResult(
            torch.as_tensor(lam[a:a + w], device="cuda"), Vo)).max())
        row = {"start": a, "residual_over_normT": res / norm_ref,
               "ortho": max_ortho_error(Vo),
               "cross_ortho": (max_cross_ortho_error(prev, Vo)
                               if prev is not None else None)}
        rows.append(row)
        take = np.sort(rng.choice(w, size=min(8, w), replace=False))
        samples.append(Vo[:, torch.as_tensor(take, device="cuda")])
        prev = Vo
        require(row["residual_over_normT"] <= 1e-12,
                f"block {a}: residual {row['residual_over_normT']} ||T||")
        require(row["ortho"] <= 1e-10, f"block {a}: Gram {row['ortho']}")
        require(row["cross_ortho"] is None or row["cross_ortho"] <= 1e-10,
                f"block {a}: cross-Gram {row['cross_ortho']}")
    wall = time.perf_counter() - t0
    counts = launch_counts()
    del prev, Vo
    sample = max_ortho_error(torch.cat(samples, dim=1))
    require(sample <= 1e-10, f"global sample orthogonality {sample}")
    require([r["start"] for r in rows] == list(range(0, n, STREAM_GROUP)),
            "streamed blocks out of order or missing")
    emit({"phase": "streamed", "n": n, "group": STREAM_GROUP,
          "halo": STREAM_HALO, "blocks": len(rows), "cut": None,
          "wall_with_checks_s": wall, "phases_s": timer.times,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "max_residual_over_normT": max(r["residual_over_normT"]
                                         for r in rows),
          "max_ortho_within_block": max(r["ortho"] for r in rows),
          "max_ortho_adjacent_blocks": max(r["cross_ortho"] or 0.0
                                           for r in rows),
          "max_ortho_global_sample": sample,
          "sample_columns": sum(int(v.shape[1]) for v in samples),
          "launches": counts, "per_block": rows})
    for name in MAIN_PATH_KERNELS:
        require(counts[name] > 0, f"{name} not launched on the streamed run")
    del samples
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the CLI: python -m symmetric_eigenvalue_tpu_torch, as a user runs it

ROOT = Path(__file__).resolve().parent
CLI_DIR = ROOT / "build" / "cli"
N_CLI_STREAM = 98304        # the basis alone (8 n^2 = 77.3 GB) passes the card
N_CLI_PROFILE = 4096
N_SELECT = 2048             # lines of cli_select's index file
# kernel names in a profiler trace (demangled) -> the port's kernels; the
# split-K reduction (SPLITK) counts toward dword_matmul's time, not its
# launches
TRACE_KERNELS = {"secular_sums": "secular_sums_kernel",
                 "secular_solve": "secular_solve_kernel",
                 "cauchy_rowsum": "cauchy_rowsum_kernel",
                 "cauchy_matmul": "cauchy_matmul_kernel",
                 "cauchy_materialize": "cauchy_materialize_kernel",
                 "spike_pass_a": "spike_kernel<true",
                 "spike_pass_b": "spike_kernel<false",
                 "dword_matmul": "dgemm_mma_kernel",
                 "dword_vecmat": "vecmat_kernel",
                 "rotation_replay": "rotation_replay_kernel",
                 "rotation_replay_t": "rotation_replay_t_kernel",
                 "deflation_tree": "deflation_tree_kernel"}
SPLITK = "splitk_reduce_kernel"
MERGE_KERNELS = ("secular_sums", "secular_solve", "cauchy_rowsum",
                 "rotation_replay_t", "deflation_tree")
REFINE_KERNELS = ("cauchy_matmul", "cauchy_materialize", "spike_pass_a",
                  "spike_pass_b", "rotation_replay")


def trace_kernels(trace_dir: Path):
    """Launches and device time of each kernel of the port in the one
    Chrome trace ``--profile-dir`` wrote into ``trace_dir``, with the
    trace's kernel events and their device time in all."""
    files = sorted(trace_dir.glob("*.json"))
    require(len(files) == 1 and files[0].stat().st_size > 0,
            f"expected one non-empty trace in {trace_dir}, found {files}")
    rows = {name: {"launches": 0, "device_ms": 0.0} for name in TRACE_KERNELS}
    events, total_us = 0, 0.0
    for ev in json.loads(files[0].read_text())["traceEvents"]:
        if ev.get("cat") != "kernel":
            continue
        events += 1
        total_us += ev.get("dur", 0.0)
        name = ev.get("name", "")
        for kernel, key in TRACE_KERNELS.items():
            if key in name:
                rows[kernel]["launches"] += 1
                rows[kernel]["device_ms"] += ev.get("dur", 0.0) * 1e-3
        if SPLITK in name:
            rows["dword_matmul"]["device_ms"] += ev.get("dur", 0.0) * 1e-3
    return {"trace_bytes": files[0].stat().st_size,
            "kernel_events": events, "kernel_device_s": total_us * 1e-6,
            "port_kernels": {k: v for k, v in rows.items() if v["launches"]}}


@contextlib.contextmanager
def kernel_events():
    """Launches (the wrappers' own counts) and device time of every kernel
    of the port over the block, for runs too long to profile: CUDA events
    recorded on the stream just before and just after each launch call
    (the ctypes functions ``_build.function`` hands out, ``<kernel>_launch``;
    the info queries launch nothing and are not timed)."""
    reset_counts()
    spans = {name: [] for name in KERNEL_NAMES}
    inner = _build.function

    def timed_function(lib, symbol, argtypes):
        fn = inner(lib, symbol, argtypes)
        kernel = symbol[:-len("_launch")]
        if kernel not in spans:
            return fn

        def launch(*args):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            rc = fn(*args)
            t1.record()
            spans[kernel].append((t0, t1))
            return rc
        return launch

    _build.function = timed_function
    got = {}
    try:
        yield got
    finally:
        _build.function = inner
    torch.cuda.synchronize()
    counts = launch_counts()
    got.update({name: {"launches": counts[name], "device_ms": sum(
        a.elapsed_time(b) for a, b in spans[name])}
        for name in KERNEL_NAMES if counts[name]})


def cli_main(argv):
    """``cli.main(argv)`` in this process: (rc, stdout, stderr, wall)."""
    from symmetric_eigenvalue_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def cli_subprocess(argv, timeout: int = 600):
    """``python -m symmetric_eigenvalue_tpu_torch argv`` from the
    repository root: (rc, stdout, stderr, wall)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "symmetric_eigenvalue_tpu_torch", *argv],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        capture_output=True, text=True, timeout=timeout)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def report_lines(stdout: str):
    return [ln for ln in stdout.splitlines() if ln.startswith("Required")]


def check_cli_run(what, rc, stdout, stderr):
    require(rc == 0, f"{what}: rc {rc}; stderr: {stderr[-2000:]}")
    require("Program finished successfully!" in stdout,
            f"{what}: no 'Program finished successfully!'")


def results_file(path: Path, n: int):
    """(eigenvalues, residuals with NaN where none was written)."""
    from symmetric_eigenvalue_tpu_torch.io.results import read_results
    lam, res = read_results(path)
    require(lam.shape == (n,), f"{path.name}: {lam.shape[0]} lines, not {n}")
    return lam, np.array([np.nan if r is None else r for r in res])


def run_cli_mtx(d, e, ref, norm_ref):
    """The main path's input written with the port's native writer, then
    the real entry point in a subprocess: -i FILE -e OUT, profiled."""
    from symmetric_eigenvalue_tpu_torch.io import mtx, native
    n = d.shape[0]
    path = CLI_DIR / f"random_{n}.mtx"
    require(native.get_lib() is not None, "the native MTX parser did not load")
    require(native.write_symm_tridiag(path, d, e, "bench.py random, seed 0"),
            "the native writer failed")
    dn, en = mtx.read_symmetric_tridiagonal(path)
    dp, ep = mtx.read_symmetric_tridiagonal(path, use_native=False)
    require(np.array_equal(dn, dp) and np.array_equal(en, ep),
            "native and Python readers differ")
    require(np.array_equal(dn, d) and np.array_equal(en, e),
            "the written matrix does not read back bit for bit")
    out, trace = CLI_DIR / "mtx_out.txt", CLI_DIR / "trace_mtx"
    torch.cuda.empty_cache()
    rc, stdout, stderr, wall = cli_subprocess(
        ["-i", str(path), "-e", str(out), "--profile-dir", str(trace)])
    check_cli_run("cli_mtx", rc, stdout, stderr)
    lam, res = results_file(out, n)
    resid = float(res.max()) / norm_ref
    lam_err = float(np.abs(lam - ref).max()) / norm_ref
    emit({"phase": "cli_mtx", "n": n, "matrix": "random", "seed": SEED,
          "argv": f"-i {path.relative_to(ROOT)} -e OUT --profile-dir DIR",
          "mtx_bytes": path.stat().st_size, "native_parser": True,
          "subprocess_wall_s_profiled": wall, "report": report_lines(stdout),
          "max_residual_over_normT": resid,
          "eig_err_vs_scipy_over_normT": lam_err, **trace_kernels(trace)})
    require(not np.isnan(res).any(), "cli_mtx: a line without a residual")
    require(resid <= 1e-12, f"cli_mtx: residual {resid} ||T||")
    require(lam_err <= 1e-12, f"cli_mtx: eigenvalues off scipy by {lam_err}")


def run_cli_select():
    """-s 2 -n 16384 -eFILE: 2048 index lines with duplicates, 0, n+1 and
    a non-integer line; residuals on exactly the valid lines."""
    n = N
    rng = np.random.default_rng(SEED)
    valid = [int(i) for i in rng.integers(1, n + 1, size=N_SELECT - 4)]
    lines = valid + [valid[0], 0, n + 1, "7.5x"]
    rng.shuffle(lines)
    evfile, out = CLI_DIR / "select.txt", CLI_DIR / "select_out.txt"
    evfile.write_text("".join(f"{ln}\n" for ln in lines))
    want = sorted({i - 1 for i in valid})
    torch.cuda.empty_cache()
    with kernel_events() as kernels:
        rc, stdout, stderr, wall = cli_main(
            ["-s", "2", "-n", str(n), f"-e{evfile}", str(out)])
    check_cli_run("cli_select", rc, stdout, stderr)
    exact = st.eigenvalues_of_scheme2(n)
    norm_t = float(np.abs(exact).max())
    lam, res = results_file(out, n)
    have = np.flatnonzero(~np.isnan(res)).tolist()
    resid = float(np.nanmax(res)) / norm_t
    lam_err = float(np.abs(lam - exact).max()) / norm_t
    emit({"phase": "cli_select", "n": n, "matrix": "Poisson",
          "index_lines": len(lines), "valid_distinct": len(want),
          "warnings": stdout.count("WARNING: Line"), "wall_s": wall,
          "report": report_lines(stdout), "max_residual_over_normT": resid,
          "eig_err_vs_analytic_over_normT": lam_err, "kernels": kernels})
    require(have == want, "cli_select: residuals not on exactly the valid "
            f"lines ({len(have)} lines, {len(want)} valid)")
    require(stdout.count("WARNING: Line") == 3, "cli_select: not 3 warnings")
    require(resid <= 1e-12, f"cli_select: residual {resid} ||T||")
    require(lam_err <= 1e-12, f"cli_select: eigenvalues off by {lam_err}")


def run_cli_streamed(n: int = N_CLI_STREAM):
    """-s 2 -n 98304 -e OUT in this process: the gate takes the streamed
    branch (12 n^2 = 116 GB), every residual and eigenvalue checked, the
    peak far under the 8 n^2 the basis would need."""
    from symmetric_eigenvalue_tpu_torch import cli
    from symmetric_eigenvalue_tpu_torch.config import usable_device_bytes
    gate, streamed = cli._use_streamed, driver.solve_tridiagonal_streamed
    said, windows, timers = [], [], []

    def recorded_gate(*args):
        said.append(gate(*args))
        return said[-1]

    def counted(*args, **kwargs):
        lam, blocks, timer = streamed(*args, **kwargs)
        timers.append(timer)
        return lam, (windows.append(a) or (a, V) for a, V in blocks), timer

    out = CLI_DIR / "streamed_out.txt"
    torch.cuda.empty_cache()
    threshold = cli._STREAM_SHARE * usable_device_bytes("cuda")
    torch.cuda.reset_peak_memory_stats()
    cli._use_streamed, driver.solve_tridiagonal_streamed = \
        recorded_gate, counted
    try:
        with kernel_events() as kernels:
            rc, stdout, stderr, wall = cli_main(
                ["-s", "2", "-n", str(n), "-e", str(out)])
    finally:
        cli._use_streamed, driver.solve_tridiagonal_streamed = gate, streamed
    peak = torch.cuda.max_memory_allocated()
    check_cli_run("cli_streamed", rc, stdout, stderr)
    exact = st.eigenvalues_of_scheme2(n)
    norm_t = float(np.abs(exact).max())
    lam, res = results_file(out, n)
    resid = float(res.max()) / norm_t
    lam_err = float(np.abs(lam - exact).max()) / norm_t
    emit({"phase": "cli_streamed", "n": n, "matrix": "Poisson",
          "cut": None if n == N_CLI_STREAM else f"n={n}, not {N_CLI_STREAM}",
          "gate": said, "gate_threshold_bytes": threshold,
          "twelve_n2_bytes": 12.0 * n * n,
          "twelve_n2_bytes_at_65536": 12.0 * N_HUGE * N_HUGE,
          "eight_n2_bytes": 8.0 * n * n, "peak_mem_bytes": peak,
          "windows": len(windows), "wall_s": wall,
          "phases_s": timers[0].times if timers else None,
          "report": report_lines(stdout), "max_residual_over_normT": resid,
          "eig_err_vs_analytic_over_normT": lam_err, "kernels": kernels})
    require(said == [True], f"cli_streamed: the gate said {said}")
    require(windows == list(range(0, n, 4096)), "cli_streamed: windows")
    require(peak < 0.25 * 8.0 * n * n,
            f"cli_streamed: peak {peak} not well under 8 n^2")
    require(not np.isnan(res).any(), "cli_streamed: a line without residual")
    require(resid <= 1e-12, f"cli_streamed: residual {resid} ||T||")
    require(lam_err <= 1e-12, f"cli_streamed: eigenvalues off by {lam_err}")
    for name in MERGE_KERNELS + REFINE_KERNELS:
        require(name in kernels, f"cli_streamed: {name} not launched")


def run_cli_f32():
    """--f32 -s 1 -n 16384 -e, profiled: the JAX package's float32 grades
    against the f64 spectrum of the same matrix, and the merge and
    refinement kernels launched (from the trace)."""
    n = N
    d64, e64 = st.create_matrix_scheme1(n)
    ref = scipy.linalg.eigvalsh_tridiagonal(d64.numpy(), e64.numpy())
    norm_t = float(np.abs(ref).max())
    out, trace = CLI_DIR / "f32_out.txt", CLI_DIR / "trace_f32"
    torch.cuda.empty_cache()
    reset_counts()
    rc, stdout, stderr, wall = cli_main(
        ["--f32", "-s", "1", "-n", str(n), "-e", str(out),
         "--profile-dir", str(trace)])
    check_cli_run("cli_f32", rc, stdout, stderr)
    counts = launch_counts()
    lam, res = results_file(out, n)
    resid = float(res.max()) / norm_t
    lam_err = float(np.abs(lam - ref).max()) / norm_t
    traced = trace_kernels(trace)
    emit({"phase": "cli_f32", "n": n, "matrix": "scheme 1",
          "wall_s_profiled": wall, "report": report_lines(stdout),
          "max_residual_over_normT": resid,
          "eig_err_vs_f64_scipy_over_normT": lam_err,
          "wrapper_launches": {k: v for k, v in counts.items() if v},
          **traced})
    require(not np.isnan(res).any(), "cli_f32: a line without residual")
    require(lam_err <= 1e-4, f"cli_f32: eigenvalues off by {lam_err} ||T||")
    require(resid <= 1e-3, f"cli_f32: residual {resid} ||T||")
    for name in MERGE_KERNELS + REFINE_KERNELS:
        require(traced["port_kernels"].get(name, {}).get("launches", 0) > 0
                and counts[name] > 0, f"cli_f32: {name} not launched")


def run_cli_profile_and_errors():
    """--profile-dir leaves a non-empty trace; a missing and a malformed -i
    each give rc 1 and 'Could not read input file:' on stderr (two
    subprocesses at once)."""
    trace = CLI_DIR / "trace"
    torch.cuda.empty_cache()
    rc, stdout, stderr, wall = cli_main(
        ["--profile-dir", str(trace), "-s", "1", "-n", str(N_CLI_PROFILE),
         "-e"])
    check_cli_run("cli_profile", rc, stdout, stderr)
    traced = trace_kernels(trace)
    bad = CLI_DIR / "malformed.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n"
                   "3 3 2\n1 1 1.0\n3 1 5.0\n")
    procs = {what: subprocess.Popen(
        [sys.executable, "-m", "symmetric_eigenvalue_tpu_torch", "-i",
         str(path)], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for what, path in (("missing", CLI_DIR / "missing.mtx"),
                           ("malformed", bad))}
    errors = {}
    for what, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        errors[what] = {"rc": proc.returncode, "stderr": err.strip()[-300:]}
    emit({"phase": "cli_profile", "n": N_CLI_PROFILE, "matrix": "scheme 1",
          "wall_s_profiled": wall, "report": report_lines(stdout), **traced,
          "errors": errors})
    require(traced["kernel_events"] > 0, "cli_profile: no kernel traced")
    for what, got in errors.items():
        require(got["rc"] == 1 and "Could not read input file:"
                in got["stderr"], f"cli error path ({what}): {got}")


# --------------------------------------------------------------------------
# the mesh: the solve sharded over several devices (dist/mesh.py)

MESH_SHARDS = 4              # [cuda:0] * 4 on a card alone
MESH_SHARD_KERNELS = ("secular_sums", "secular_solve", "cauchy_rowsum",
                      "cauchy_matmul", "cauchy_materialize", "rotation_replay",
                      "rotation_replay_t", "deflation_tree")
MESH_LEAD_KERNELS = ("spike_pass_a", "spike_pass_b")
MESH_DIR = ROOT / "build" / "mesh"
# each kernel's wrapper where it launches (the counter moves inside it)
LAUNCH_SITES = ((ss, "_launch"), (ss, "_launch_solve"), (cr, "_launch"),
                (cm, "_launch_matmul"), (cm, "_launch_materialize"),
                (rr, "_launch"), (sp, "spike_pass_a"), (sp, "spike_pass_b"),
                (dm, "_launch"), (dv, "_launch"), (dtr, "_launch"))


def solve_mesh():
    """Every card when there are two or more, else MESH_SHARDS shards of
    cuda:0; and what the mesh line calls it."""
    count = torch.cuda.device_count()
    if count >= 2:
        return tmesh.make_mesh(), f"{count} distinct cards"
    return (tmesh.make_mesh(devices=["cuda:0"] * MESH_SHARDS),
            f"cuda:0 x {MESH_SHARDS} (one card visible)")


def _first_device(x):
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (tuple, list)):
        for y in x:
            dev = _first_device(y)
            if dev is not None:
                return dev
    return None


@contextlib.contextmanager
def record_shard_launches():
    """Each kernel's launches by the mesh shard whose work enqueued them
    ("shard s", recorded around ``dist.mesh._on_shard``; "lead" for the
    replicated work and everything outside a sharded call: the
    refinement) and by the device of the tensors it was given:
    {"shard 0 @ cuda:0": {kernel: launches}, ...}."""
    tally = {}
    where = ["lead"]
    on_shard = tmesh._on_shard
    saved = [getattr(mod, name) for mod, name in LAUNCH_SITES]

    def sharded(fn, args, device, shard):
        where.append("lead" if shard is None else f"shard {shard}")
        try:
            return on_shard(fn, args, device, shard)
        finally:
            where.pop()

    def counted(inner):
        def launch(*args, **kwargs):
            before = launch_counts()
            out = inner(*args, **kwargs)
            key = f"{where[-1]} @ {_first_device(args)}"
            for name, v in launch_counts().items():
                if v != before[name]:
                    row = tally.setdefault(key, {})
                    row[name] = row.get(name, 0) + v - before[name]
            return out
        return launch

    tmesh._on_shard = sharded
    for (mod, name), inner in zip(LAUNCH_SITES, saved):
        setattr(mod, name, counted(inner))
    try:
        yield tally
    finally:
        tmesh._on_shard = on_shard
        for (mod, name), inner in zip(LAUNCH_SITES, saved):
            setattr(mod, name, inner)


def launches_where(tally, kernel):
    """{place: launches} of one kernel."""
    return {k: row[kernel] for k, row in tally.items() if row.get(kernel)}


@contextlib.contextmanager
def record_slot_merges():
    """The slot-sharded merges of a meshed solve: each one's partition and
    arguments and the tau it gave (recorded around driver.merge_roots)."""
    got = []
    inner = driver.merge_roots

    def recorded(part, **kwargs):
        rep = inner(part, **kwargs)
        if kwargs.get("slot_mesh") is not None:
            got.append((part, kwargs, rep.tau))
        return rep

    driver.merge_roots = recorded
    try:
        yield got
    finally:
        driver.merge_roots = inner


def slot_tau_bit_exact(merges):
    """Each recorded slot-sharded merge solved again without the mesh: is
    every tau bit for bit the sharded one?  [(m, K, bit_exact)]."""
    out = []
    for part, kwargs, tau in merges:
        plain = driver.merge_roots(part, **{**kwargs, "slot_mesh": None})
        out.append({"m": int(part.poles.shape[1]), "K": int(part.K[0]),
                    "bit_exact": bool(torch.equal(plain.tau, tau))})
    return out


def mesh_peaks(mesh, reset: bool = False):
    """{device: peak bytes} over the mesh's distinct devices, or, with
    ``reset``, their peaks set back to what they hold now."""
    devs = dict.fromkeys(mesh.devices)
    if reset:
        for dv_ in devs:
            torch.cuda.reset_peak_memory_stats(dv_)
        return None
    return {str(dv_): torch.cuda.max_memory_allocated(dv_) for dv_ in devs}


def host_sync_sites(run, top: int = 8):
    """Synchronizing CUDA calls of ``run()`` (torch.cuda's sync debug mode)
    and the Python lines that made the most of them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{Path(w.filename).name}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    ranked = sorted(sites.items(), key=lambda kv: -kv[1])[:top]
    return sum(sites.values()), dict(ranked)


def mesh_solve_checked(d, e, cfg, mesh, ref, norm_ref):
    """One meshed solve_tridiagonal_staged with eigenvectors: wall, phases,
    per-device peaks, launches by shard, eigenvalues (host) and the three
    limits."""
    torch.cuda.empty_cache()
    mesh_peaks(mesh, reset=True)
    reset_counts()
    with record_shard_launches() as where:
        sync(device=mesh.devices)
        t0 = time.perf_counter()
        res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                 compute_vectors=True,
                                                 mesh=mesh)
        sync(device=mesh.devices)
        wall = time.perf_counter() - t0
    peaks = mesh_peaks(mesh)
    lam = res.eigenvalues.cpu().numpy()
    V = res.eigenvectors
    n = lam.shape[0]
    require(V.shape == (n, n) and V.device == mesh.lead and all_finite(V)
            and np.isfinite(lam).all(), "meshed solve: misshapen result")
    resid = float(st.residuals(d, e, res).max()) / norm_ref
    ortho = max_ortho_error(V)
    lam_err = float(np.abs(lam - ref).max()) / norm_ref
    del res, V
    torch.cuda.empty_cache()
    require(resid <= 1e-12, f"meshed solve: residual {resid} > 1e-12 ||T||")
    require(ortho <= 1e-10, f"meshed solve: orthogonality {ortho}")
    require(lam_err <= 1e-12, f"meshed solve: eigenvalues off scipy's by "
            f"{lam_err} ||T||")
    return {"wall_s": wall, "phases_s": timer.times, "counts": timer.counts,
            "peak_mem_bytes_by_device": peaks, "launches_by_shard": where,
            "residual_over_normT": resid, "ortho": ortho,
            "eig_err_vs_scipy_over_normT": lam_err}, lam


def run_mesh(d, e, ref, norm_ref, cfg):
    """Phase mesh: the main path's input over the mesh against the
    unsharded solve in the same call."""
    mesh, kind = solve_mesh()
    lam0 = st.solve_tridiagonal_staged(d, e, config=cfg)[0] \
        .eigenvalues.cpu().numpy()
    with record_slot_merges() as merges:
        cold, lam = mesh_solve_checked(d, e, cfg, mesh, ref, norm_ref)
    tau = slot_tau_bit_exact(merges)
    vs_unsharded = float(np.abs(lam - lam0).max()) / norm_ref
    where = cold["launches_by_shard"]
    # warm walls, the two routes in turns (which goes first alternates)
    walls = {"unsharded": [], "mesh": []}
    runs = {"unsharded": lambda: st.solve_tridiagonal_staged(
                d, e, config=cfg, compute_vectors=True),
            "mesh": lambda: st.solve_tridiagonal_staged(
                d, e, config=cfg, compute_vectors=True, mesh=mesh)}
    for r in range(3):
        for name in (("unsharded", "mesh") if r % 2 == 0
                     else ("mesh", "unsharded")):
            sync(device=mesh.devices)
            t0 = time.perf_counter()
            out = runs[name]()
            sync(device=mesh.devices)
            walls[name].append(time.perf_counter() - t0)
            del out
            torch.cuda.empty_cache()
    syncs = {name: host_sync_sites(run) for name, run in runs.items()}
    # the pure-f64 path and the Poisson spectrum over the same mesh
    cfg64 = st.SolverConfig(mixed_precision_vectors=False)
    f64, _ = mesh_solve_checked(d, e, cfg64, mesh, ref, norm_ref)
    dp, ep = st.create_matrix_scheme2(N)
    exact = st.eigenvalues_of_scheme2(N)
    norm_p = float(np.abs(exact).max())
    sync(device=mesh.devices)
    t0 = time.perf_counter()
    lam_p = st.eigh_tridiagonal(dp, ep, config=cfg64, eigvals_only=True,
                                mesh=mesh)
    sync(device=mesh.devices)
    wall_p = time.perf_counter() - t0
    p_err = float(np.abs(lam_p.cpu().numpy() - exact).max()) / norm_p
    emit({"phase": "mesh", "n": N, "matrix": "random", "seed": SEED,
          "config": "SolverConfig()", "mesh": kind,
          "mesh_devices": [str(x) for x in mesh.devices],
          "cold": cold, "eig_err_vs_unsharded_over_normT": vs_unsharded,
          "slot_sharded_tau": tau,
          "warm_walls_s": walls,
          "warm_median_s": {k: float(np.median(v)) for k, v in walls.items()},
          "host_syncs": {k: v[0] for k, v in syncs.items()},
          "host_sync_sites": {k: v[1] for k, v in syncs.items()},
          "f64": f64,
          "poisson_eigvals_only": {"wall_s": wall_p,
                                   "err_vs_analytic_over_normT": p_err}})
    require(vs_unsharded <= 1e-13, f"mesh: eigenvalues {vs_unsharded} ||T|| "
            "off the unsharded solve's")
    require(tau and all(t["bit_exact"] for t in tau),
            f"mesh: slot-sharded tau not bit for bit the unsharded: {tau}")
    require(p_err <= 1e-12, f"mesh: Poisson eigenvalues off by {p_err}")
    shards = [f"shard {s} @ {x}" for s, x in enumerate(mesh.devices)]
    for name in MESH_SHARD_KERNELS:
        got = launches_where(where, name)
        require(all(got.get(s, 0) > 0 for s in shards),
                f"mesh: {name} not launched on every shard: {got}")
    for name in MESH_LEAD_KERNELS:
        got = launches_where(where, name)
        require(got.get(f"lead @ {mesh.lead}", 0) > 0 and len(got) == 1,
                f"mesh: {name} not on the lead device alone: {got}")
    got = launches_where(f64["launches_by_shard"], "dword_matmul")
    require(all(got.get(s, 0) > 0 for s in shards),
            f"mesh: dword_matmul not launched on every shard (f64): {got}")


def run_mesh_grouped(cfg, d, e, lam_ref, norm_ref):
    """Phase mesh_grouped: n=65536 through the grouped route over the mesh,
    eigenvalues against ``lam_ref`` (the unsharded grouped solve's; None:
    solved here first, and ||T|| read from its eigenvalues), residual in
    column chunks."""
    mesh, kind = solve_mesh()
    n = d.shape[0]
    unsharded_s = None
    if lam_ref is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = st.solve_tridiagonal_staged(d, e, config=cfg,
                                          compute_vectors=True)[0]
        torch.cuda.synchronize()
        unsharded_s = time.perf_counter() - t0
        lam_ref = res.eigenvalues.cpu().numpy()
        norm_ref = float(np.abs(lam_ref).max())
        del res
    torch.cuda.empty_cache()
    mesh_peaks(mesh, reset=True)
    reset_counts()
    with record_shard_launches() as where:
        sync(device=mesh.devices)
        t0 = time.perf_counter()
        res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                 compute_vectors=True,
                                                 mesh=mesh)
        sync(device=mesh.devices)
        wall = time.perf_counter() - t0
    peaks = mesh_peaks(mesh)
    lam = res.eigenvalues.cpu().numpy()
    require(res.eigenvectors.shape == (n, n) and all_finite(res.eigenvectors),
            "mesh_grouped: misshapen result")
    resid = float(st.residuals(d, e, res).max()) / norm_ref
    lam_err = float(np.abs(lam - lam_ref).max()) / norm_ref
    del res
    torch.cuda.empty_cache()
    emit({"phase": "mesh_grouped", "n": n, "matrix": "random", "seed": SEED,
          "mesh": kind, "wall_s": wall, "phases_s": timer.times,
          "unsharded_wall_s": unsharded_s,
          "peak_mem_bytes_by_device": peaks, "launches_by_shard": where,
          "residual_over_normT": resid,
          "eig_err_vs_unsharded_over_normT": lam_err})
    require(GROUPED in timer.times, "mesh_grouped: not the grouped route")
    require(resid <= 1e-12, f"mesh_grouped: residual {resid} ||T||")
    require(lam_err <= 1e-13, f"mesh_grouped: eigenvalues {lam_err} ||T|| "
            "off the unsharded solve's")
    for name in ("cauchy_matmul", "cauchy_materialize", "rotation_replay"):
        got = launches_where(where, name)
        require(len(got) == len(mesh.devices),
                f"mesh_grouped: {name} not on every shard: {got}")


def run_mesh_cli(ref, norm_ref):
    """Phase mesh_cli: -s 1 -n 16384 -e --devices <cards> in a subprocess
    (the scheme's spectrum from scipy here), and --devices <cards + 1>:
    rc 1 and the message."""
    count = torch.cuda.device_count()
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    out = MESH_DIR / "cli.txt"
    argv = ["-s", "1", "-n", str(N), "-e", "--devices", str(count), str(out)]
    rc, stdout, stderr, wall = cli_subprocess(argv)
    check_cli_run("mesh_cli", rc, stdout, stderr)
    d1, e1 = st.create_matrix_scheme1(N)
    ref1 = scipy.linalg.eigvalsh_tridiagonal(d1.cpu().numpy(),
                                             e1.cpu().numpy())
    norm1 = float(np.abs(ref1).max())
    lam, res = results_file(out, N)
    lam_err = float(np.abs(lam - ref1).max()) / norm1
    worst = float(np.nanmax(res)) / norm1
    rc_bad, out_bad, err_bad, _ = cli_subprocess(
        ["-s", "1", "-n", "64", "--devices", str(count + 1)])
    emit({"phase": "mesh_cli", "n": N, "argv": argv[:-1],
          "wall_s": wall, "report": report_lines(stdout),
          "devices_line": [ln for ln in stdout.splitlines()
                           if ln.startswith("Number of devices")],
          "eig_err_vs_scipy_over_normT": lam_err,
          "max_residual_over_normT": worst,
          "too_many": {"argv": ["--devices", str(count + 1)],
                       "rc": rc_bad, "stderr": err_bad.strip()[-300:]}})
    require(f"Number of devices is: {count}  (backend: cuda)" in stdout,
            "mesh_cli: no device line")
    require(lam_err <= 1e-12 and worst <= 1e-12,
            f"mesh_cli: eigenvalues {lam_err}, residuals {worst} ||T||")
    require(rc_bad == 1 and out_bad == "" and "Cannot shard over "
            f"{count + 1} devices" in err_bad,
            f"mesh_cli: --devices {count + 1} did not fail cleanly")


def mesh_worker(rank: int, port: int) -> int:
    """One process of mesh_multiprocess (``--mesh-worker RANK,PORT``): its
    own card (CUDA_VISIBLE_DEVICES), NCCL through distributed_init, the
    n=16384 random input solved over the two processes' mesh; checks its
    own eigenvalues (against the spectrum the parent wrote) and residual,
    prints one JSON line."""
    import torch.distributed as dist
    tmesh.distributed_init(f"localhost:{port}", 2, rank)
    mesh = tmesh.make_mesh()
    d, e = random_matrix(N, SEED)
    ref = np.load(MESH_DIR / "ref.npy")
    norm_ref = float(np.abs(ref).max())
    cfg = st.SolverConfig()
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                 compute_vectors=True,
                                                 mesh=mesh)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    lam = res.eigenvalues.cpu().numpy()
    resid = float(st.residuals(d, e, res).max()) / norm_ref
    lam_err = float(np.abs(lam - ref).max()) / norm_ref
    emit({"rank": rank, "mesh_size": mesh.size,
          "device": torch.cuda.get_device_name(0), "walls_s": walls,
          "phases_s": timer.times, "residual_over_normT": resid,
          "eig_err_vs_scipy_over_normT": lam_err,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    dist.destroy_process_group()
    require(mesh.size == 2, f"rank {rank}: mesh of {mesh.size}")
    require(resid <= 1e-12 and lam_err <= 1e-12,
            f"rank {rank}: residual {resid}, eigenvalues {lam_err} ||T||")
    return 0


def run_mesh_multiprocess(ref):
    """Phase mesh_multiprocess: two processes, one card each, on NCCL; on a
    card alone it says it needs two and runs nothing."""
    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "mesh_multiprocess", "ran": False,
              "cards_visible": count,
              "note": "needs two cards (NCCL does not let two ranks share "
                      "one); one is visible: this phase ran no work"})
        return
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    np.save(MESH_DIR / "ref.npy", ref)
    with contextlib.closing(socket.socket()) as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
         f"{rank},{port}"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "CUDA_VISIBLE_DEVICES": str(rank)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            results.append({"rc": proc.returncode,
                            "result": json.loads(lines[-1]) if lines
                            else None, "stderr": err.strip()[-1500:]})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    emit({"phase": "mesh_multiprocess", "ran": True, "processes": 2,
          "wall_s": time.perf_counter() - t0, "ranks": results})
    for rank, got in enumerate(results):
        require(got["rc"] == 0 and got["result"] is not None,
                f"mesh_multiprocess: rank {rank} failed: {got}")


def run_mesh_phases(d, e, ref, norm_ref, cfg, d65=None, e65=None,
                    lam65=None, norm65=None):
    """The four mesh phases (n=65536's input made here when not given)."""
    run_mesh(d, e, ref, norm_ref, cfg)
    if d65 is None:
        d65, e65 = random_matrix(N_HUGE, SEED)
    run_mesh_grouped(cfg, d65, e65, lam65, norm65)
    run_mesh_cli(ref, norm_ref)
    run_mesh_multiprocess(ref)


# --------------------------------------------------------------------------
# the dense and banded front ends

def dense_matrix(n: int, seed: int):
    """tools/run_dense_eigh.py's input, made on the card: A = (G + G^T) /
    (2 sqrt(n)), G standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    G = torch.randn((n, n), dtype=torch.float64, device="cuda", generator=g)
    return (G + G.T).div_(2.0 * n ** 0.5)


def dense_checks(A, lam, V, ref, chunk: int = 2048):
    """max|AV - V lam| / ||A||, max|V^T V - I| and max|lam - ref| / ||A||
    (||A|| = max|ref|), each held to its limit."""
    n = A.shape[0]
    norm = float(ref.abs().max())
    require(V.shape == (n, n) and V.dtype == torch.float64
            and all_finite(V) and bool(torch.isfinite(lam).all()),
            "non-finite or misshapen result")
    worst = 0.0
    for o in range(0, n, chunk):
        R = torch.matmul(A, V[:, o:o + chunk]) \
            - V[:, o:o + chunk] * lam[o:o + chunk]
        worst = max(worst, float(R.abs().max()))
        del R
    resid = worst / norm
    ortho = max_ortho_error(V)
    lam_err = float((lam - ref).abs().max()) / norm
    require(resid <= 1e-12, f"residual {resid} > 1e-12 ||A||")
    require(ortho <= 1e-10, f"orthogonality {ortho} > 1e-10")
    require(lam_err <= 1e-12, f"eigenvalues off torch.linalg.eigvalsh by "
            f"{lam_err} ||A||")
    return {"residual_over_normA": resid, "ortho": ortho,
            "eig_err_vs_eigvalsh_over_normA": lam_err}


def vecmat_stream_bytes(n: int, panel: int, buckets: int) -> float:
    """Bytes of A the n-2 Householder matvecs of ``tridiagonalize`` read:
    per column the rows below the pivot, over the bucket's width."""
    cuts = _bucket_cuts(n, panel, buckets)
    total = 0.0
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        m = n - c0
        total += sum(8.0 * (m - j - 1) * m for j in range(c1 - c0)
                     if j != m - 2)
    return total


def timed_dense(run):
    """One call of ``run(timer)`` -> (lam, V): wall, phases, peak memory."""
    timer = PhaseTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lam, V = run(timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return lam, V, {"wall_s": wall, "phases_s": timer.times,
                    "counts": timer.counts,
                    "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def dense_f32(A, ref):
    """eigh in float32 mode (SolverConfig(dtype=torch.float32)) on the
    card: float32 results within the JAX package's f32 grades
    (eigenvalues 1e-4 ||A|| off the f64 eigvalsh, residual 1e-3 ||A||,
    orthogonality 1e-3), eigvals_only as well."""
    cfg32 = st.SolverConfig(dtype=torch.float32)
    n = A.shape[0]
    norm = float(ref.abs().max())
    reset_counts()
    lam, V, run = timed_dense(lambda tm: st.eigh(A, config=cfg32, timer=tm))
    launches = launch_counts()
    require(lam.dtype == V.dtype == torch.float32 and V.shape == (n, n),
            f"eigh f32 returned {lam.dtype}, {V.dtype}, {tuple(V.shape)}")
    lam64, V64 = lam.double(), V.double()
    worst = 0.0
    for o in range(0, n, 2048):
        R = torch.matmul(A, V64[:, o:o + 2048]) - V64[:, o:o + 2048] \
            * lam64[o:o + 2048]
        worst = max(worst, float(R.abs().max()))
    resid = worst / norm
    ortho = max_ortho_error(V64)
    lam_err = float((lam64 - ref).abs().max()) / norm
    only = st.eigh(A, config=cfg32, eigvals_only=True)
    only_err = float((only.double() - ref).abs().max()) / norm
    _, _, warm = timed_dense(lambda tm: st.eigh(A, config=cfg32, timer=tm))
    emit({"phase": "dense_f32", "n": n, "config": "SolverConfig(dtype="
          "torch.float32)", **run, "warm": warm, "residual_over_normA": resid,
          "ortho": ortho, "eig_err_vs_eigvalsh_over_normA": lam_err,
          "eigvals_only_err_over_normA": only_err, "launches": launches})
    require(resid <= 1e-3 and ortho <= 1e-3 and lam_err <= 1e-4
            and only_err <= 1e-4 and only.dtype == torch.float32,
            "eigh in float32 outside the f32 grades")
    expected = hp.column_launches(n, 32, driver._bucket_count(n))
    require(all(launches[k] == v for k, v in expected.items())
            and launches["larft"] == -(-(n - 1) // 32),
            "eigh in float32 did not take the column step and larft kernels")
    del V, V64


def tridiagonalize_profile(A):
    """tridiagonalize(A) alone under the profiler: the device's idle share
    of the reduction and its device events a column (at most 3: the column
    step makes two launches a column)."""
    n = A.shape[0]
    reset_counts()
    prof = profile_solve(lambda: tridiag_mod.tridiagonalize(A))
    per_column = prof["device_events"] / (n - 1)
    emit({"phase": "profile", "path": f"tridiagonalize, n={n}", **prof,
          "device_events_per_column": per_column,
          "launches": launch_counts()})
    require(per_column <= 3.0,
            f"the reduction made {per_column} device events a column")


def upper_band_storage(A, u: int):
    """scipy's upper band storage (u+1, n) of the band of A, on the host."""
    n = A.shape[0]
    ab = np.zeros((u + 1, n))
    for k in range(u + 1):
        ab[u - k, k:] = torch.diagonal(A, offset=k).cpu().numpy()
    return ab


def two_stage_solves(A, ref, band: int, u: int):
    """eigh(A, band=band) and eigh_banded of A's band u on the card, all
    eigenpairs, each with the three limits (dense_checks), wall, phases,
    peak memory and launches; the launch counts held to the schedule's
    formulas: one band_chase a chase, band_reduce.panel_qr_count(n, band)
    panel_qr, one larft a panel of reduce_to_band and of apply_q."""
    n = A.shape[0]
    reset_counts()
    lam, V, run = timed_dense(lambda tm: st.eigh(A, band=band, timer=tm))
    two = {**run, **dense_checks(A, lam, V, ref),
           "launches": launch_counts()}
    del lam, V
    torch.cuda.empty_cache()
    idx = torch.arange(n, device="cuda")
    Ab = torch.where((idx[:, None] - idx[None, :]).abs() <= u, A, 0.0)
    refb = torch.linalg.eigvalsh(Ab)
    ab = upper_band_storage(Ab, u)
    reset_counts()
    lamb, Vb, runb = timed_dense(lambda tm: st.eigh_banded(ab, timer=tm))
    banded = {**runb, **dense_checks(Ab, lamb, Vb, refb),
              "launches": launch_counts()}
    del lamb, Vb, Ab, refb
    torch.cuda.empty_cache()
    lt, lb = two["launches"], banded["launches"]
    require(lt["dword_matmul"] > 0,
            "dword_matmul was not launched on the two-stage path")
    # the backtransform through Q2: a q2_blocks_t a chunk of waves and a
    # q2_apply a wave with a live block on both front ends (eigh_banded's
    # only GEMM user was the host wave loop these replaced)
    index = torch.cuda.current_device()
    for name, got, bb in (("eigh(band)", lt, band), ("eigh_banded", lb, u)):
        want = {"q2_blocks_t": len(br.q2_device_chunks(n, bb, index)),
                "q2_apply": br.q2_wave_count(n, bb)}
        require(all(got[k] == v for k, v in want.items()),
                f"{name} launched {got} against {want}")
    # reduce_to_band's panels (n-2)//b and apply_q's (n-1)/b take larft
    larft = (n - 2) // band + -(-(n - 1) // band)
    require(lt["larft"] == larft, f"larft launched {lt['larft']} times on "
            f"the two-stage path, not {larft}")
    expect = {"band_chase": br.chase_launch_count(n, band),
              "panel_qr": br.panel_qr_count(n, band), "larft": larft,
              "q2_blocks_t": len(br.q2_device_chunks(n, band, index)),
              "q2_apply": br.q2_wave_count(n, band)}
    require(all(lt[k] == v for k, v in expect.items()),
            f"eigh(band={band}) launched {lt} against {expect}")
    require(lb["band_chase"] == br.chase_launch_count(n, u)
            and lb["panel_qr"] == 0,
            f"eigh_banded launched {lb} against one band_chase")
    two["launches_expected"] = expect
    return two, banded


def kernel_table(d, e, ref):
    """For every kernel, a function that runs its checks and returns their
    rows, each kernel against its plain version at the shapes its path
    gives it: secular_sums at the root level (k=1, all m roots) and the
    bottom level (k=256 merges of m=64); cauchy_rowsum at the widest
    non-root level (every slot active, and 1/8 of them), then on every
    non-root level of a mixed solve of (d, e) and of the Poisson matrix,
    on the level's own inputs; dword_matmul at the m=8192 level's f64 GEMM;
    cauchy_matmul at the m=8192 level (all slots active, and 1/8 of them:
    the deflation skip) and the bottom level (k=256, m=64) with a full
    vec_chunk of 8192 columns; cauchy_materialize at the root (m=16384,
    8192 columns); the Spike passes at one refinement chunk (n=16384,
    nb=128, K=2048) of the prescaled system of (d, e), whose spectrum is
    ``ref`` (V contiguous, and a column slice of an n x n V as the solve
    passes it), then at every chunk of what a mixed solve of (d, e) hands
    its first refinement pass (the f32 downsweep's output); secular_solve on the root and the bottom level of a tear of
    (d, e), and on two levels that deflate little: K_b above the 3072 poles
    a block holds (the streamed sweeps) and between 256 and 3072 (resident
    sweeps over more than 64 poles); rotation_replay on every level of a
    mixed solve of the Poisson matrix and of (d, e), on the level's own
    data, and rotation_replay_t on every non-root level of those solves and
    of (d, e) in the float32 mode; interface_solve and block_lu_solve on what mixed solves of (d, e)
    and of the Poisson matrix hand them (:func:`interface_rows`,
    :func:`block_lu_rows`)."""
    spike = []

    def spike_rows(which):
        if not spike:
            ds, es, snorm = _prescale(*(torch.as_tensor(a, device="cuda")
                                        for a in (d, e)))
            lam = ref / float(snorm)
            for s, sliced in (("random", False), ("eigenvalues", False),
                              ("eigenvalues", True)):
                spike.append(check_spike(
                    ds, es, *spike_inputs(N, lam, 2048, s, sliced), 128, s,
                    5))
            with first_spike_refine() as seen:
                st.solve_tridiagonal_staged(d, e, compute_vectors=True)
            d_s, e_s, lam_s, V_s = seen[0]
            for o in range(0, V_s.shape[1], 2048):
                spike.append(check_spike(
                    d_s, e_s, lam_s[o:o + 2048], V_s[:, o:o + 2048], 128,
                    f"solve's downsweep output, columns {o}:{o + 2048}", 5))
            del seen, d_s, e_s, lam_s, V_s
            torch.cuda.empty_cache()
        return [pair[which] for pair in spike]

    return {
        # secular_sums at the root and the bottom level, and at the root
        # with a quarter of the slots active (the sweeps stop at K)
        "secular_sums": lambda: [check_secular_sums(1, N, 10),
                                 check_secular_sums(256, 64, 50),
                                 check_secular_sums(1, N, 10, kact=N // 4)],
        # secular_solve on the root level (k=1, m=16384) and the bottom
        # level (k=256, m=64) of a tear of the main path's matrix, then on
        # levels that deflate little: k=1, m=16384 (streamed) and k=4,
        # m=2048 (resident)
        "secular_solve": lambda: [
            check_secular_solve(split_level(d, e, 1, N), 10),
            check_secular_solve(split_level(d, e, 256, 64), 20, stall=True),
            check_secular_solve(spread_level(1, N, 5), 5),
            check_secular_solve(spread_level(4, 2048, 6), 10, stall=True)],
        # cauchy_rowsum at the widest non-root level with every slot active
        # and with 1/8 of them (the K cut), then on every non-root level of
        # a mixed solve of the main input and of the Poisson matrix
        "cauchy_rowsum": lambda: [
            check_cauchy_rowsum(rowsum_inputs(2, 8192, 8192), 20,
                                "random, K = m"),
            check_cauchy_rowsum(rowsum_inputs(2, 8192, 1024), 20,
                                "random, K = m/8, wz 0 past K"),
            *rowsum_level_rows(d, e, "mixed solve, random n=16384"),
            *rowsum_level_rows(*st.create_matrix_scheme2(N),
                               "mixed solve, Poisson n=16384")],
        # after the f64 downsweep's GEMM, the dense front end's skinny
        # shapes: a 32-row panel's Gram over K=16384, and the rank-2k
        # trailing update of the first bucket;
        # then a ragged shape (odd everywhere, split-K), a batch of 16
        # reflector blocks' products at n=4096, band 128 (the shape of a
        # wave of the host loop that q2_apply replaced: no path makes it
        # now), and the fused trailing update on a strided bucket view
        "dword_matmul": lambda: [
            check_dword_matmul(2, 2048, 8192, 8192, 5),
            check_dword_matmul(1, 32, 16384, 32, 50),
            check_dword_matmul(1, 16384, 64, 16384, 3),
            check_dword_matmul(1, 1000, 4001, 777, 20),
            check_dword_matmul(16, 128, 255, 4096, 20),
            check_dword_matmul_sub(16384, 64, 16384, 64, 3),
            check_dword_matmul_sub(1000, 4001, 777, 3, 20)],
        # after the level shapes, denominators outside the normal range in
        # both tile shapes
        "cauchy_matmul": lambda: [
            check_cauchy_matmul(2, 8192, 8192, 8192, 3),
            check_cauchy_matmul(2, 8192, 8192, 1024, 5),
            check_cauchy_matmul(256, 64, 8192, 64, 10),
            check_cauchy_matmul_edges(256, 200),
            check_cauchy_matmul_edges(64, 200)],
        "cauchy_materialize": lambda: [
            check_cauchy_materialize(N, 8192, 12000, 10)],
        # every level of a mixed solve of the Poisson matrix (many
        # rotations, the root's y once more in f64) and of the main input
        "rotation_replay": lambda: [
            *replay_level_rows(*st.create_matrix_scheme2(N),
                               "mixed solve, Poisson n=16384", f64_row=True),
            *replay_level_rows(d, e, "mixed solve, random n=16384")],
        # the transposed form on every non-root level of the same solves'
        # upsweeps (f64), and of the main input's in the float32 mode
        "rotation_replay_t": lambda: [
            *rows_t_level_rows(d, e, "random n=16384"),
            *rows_t_level_rows(*st.create_matrix_scheme2(N),
                               "Poisson n=16384"),
            *rows_t_level_rows(d, e, "random n=16384, float32 mode",
                               st.SolverConfig(dtype=torch.float32))],
        # every merge level of the random and the Poisson solves in f64
        # (the mixed config's eigenvalue phase) and in the float32 mode,
        # then synthetic levels (m not a power of two, m = 1 and 2, 98304)
        "deflation_tree": lambda: [
            *tree_level_rows(d, e, "random n=16384, f64"),
            *tree_level_rows(*st.create_matrix_scheme2(N),
                             "Poisson n=16384, f64"),
            *tree_level_rows(d, e, "random n=16384, float32 mode",
                             st.SolverConfig(dtype=torch.float32)),
            *tree_level_rows(*st.create_matrix_scheme2(N),
                             "Poisson n=16384, float32 mode",
                             st.SolverConfig(dtype=torch.float32)),
            *synthetic_tree_rows()],
        "spike_pass_a": lambda: spike_rows(0),
        "spike_pass_b": lambda: spike_rows(1),
        # the Spike pass's interface on the mixed random and Poisson
        # solves' own pass-1 boundary values, and the blocked solver's on
        # the boundary rows of their triage's block LU
        "interface_solve": interface_rows,
        # the blocked solver's block LU at nb=128 on a refinement chunk and
        # at the triage's extra and rescue shapes, random and Poisson
        "block_lu_solve": block_lu_rows,
        # dword_vecmat at the first and the last bucket's width of the
        # n=16384 reduction, full height and as the reduction calls it
        # (rows below the reflector's zeros only), and at an odd width
        # (ragged against every tile size, odd stride)
        "dword_vecmat": lambda: [
            check_dword_vecmat(N, N // 8, False, 20),
            check_dword_vecmat(4096, 512, False, 50),
            check_dword_vecmat(N, N // 8, True, 20),
            check_dword_vecmat(4096, 512, True, 50),
            check_dword_vecmat(4001, 333, True, 50)],
        # the column step from identical inputs at the n=16384 reduction's
        # first bucket (jj = 15, 0, 31), a later bucket's strided view,
        # sigma2 == 0, the identity column and a 512-column panel, then a
        # whole reduction at n=1024 against the plain column step; the
        # fused launch also over a whole panel at m=16384
        "column_reflector": lambda: [*column_step_rows()[0],
                                     whole_reduction_row()],
        "column_w": lambda: column_step_rows()[1],
        "column_w_reflector": lambda: [*column_step_rows()[2],
                                       whole_panel_row()],
        # apply_q's panel (nb=32 over n=16384) and the two-stage path's
        # (nb = band = 128 over n=4096), a ragged one (apply_q's last
        # panel) and nb=1
        "larft": lambda: [check_larft(32, N, 50), check_larft(128, 4096, 20),
                          check_larft(127, 4096, 20),
                          check_larft(1, 4096, 20)],
        # the chase at the two-stage path's shape first (n=4096, band 128),
        # then eigh_banded's (u=16), then both at n=1024, and band 256 (its
        # b x b block past shared memory: the global work tile)
        "band_chase": lambda: [check_band_chase(4096, 128, 3),
                               check_band_chase(4096, 16, 3),
                               check_band_chase(1024, 128, 5),
                               check_band_chase(1024, 16, 5),
                               check_band_chase(1024, 256, 3)],
        # the panel QR of the n=4096 two-stage path's first panel, the
        # dense n=16384 matrix's first and a middle panel, a last panel
        # with 5 live columns, a 1024-column panel (rows past what shared
        # memory holds in the global copy), then a whole reduce_to_band at
        # n=1024
        "panel_qr": lambda: [check_panel_qr(4096, 0, 128, 10),
                             check_panel_qr(N, 0, 128, 5),
                             check_panel_qr(N, 8192, 128, 5),
                             check_panel_qr(4096, 4096 - 128 - 5, 128, 10),
                             check_panel_qr(4096, 0, 1024, 3),
                             whole_band_reduction_row()],
        # every block's T of the chase's log, chunk by chunk, at the
        # two-stage path's shapes (n=4096, band 128 and u=16), then
        # n=16384, band 128 (dense_two_stage_full drives u=16 there), and
        # n=16384 at u=4 and u=2 (35 and 132 chunks, four of them held)
        "q2_blocks_t": lambda: [check_q2_blocks_t(4096, 128, 10),
                                check_q2_blocks_t(4096, 16, 10),
                                check_q2_blocks_t(N, 128, 3),
                                check_q2_blocks_t(N, 4, 2, depth=4),
                                check_q2_blocks_t(N, 2, 2, depth=4)],
        # the widest wave and the whole backtransform at n=4096 (band 128
        # and u=16, beside the replaced host loop) and at n=16384, band
        # 128; band 256 at n=1024 (the 8-column tile); then the memory of
        # the whole backtransform at n=16384 and the small bands u=2 and
        # u=4 (the most chunks)
        "q2_apply": lambda: [check_q2_apply(4096, 128, 10),
                             check_q2_apply(4096, 16, 10),
                             check_q2_apply(N, 128, 3, replaced=False),
                             check_q2_apply(1024, 256, 10),
                             check_q2_small_band(N, 2),
                             check_q2_small_band(N, 4)],
    }


def run_cli(d, e, ref, norm_ref):
    """The CLI phases, in a fresh build/cli/."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    run_cli_mtx(d, e, ref, norm_ref)
    run_cli_select()
    run_cli_f32()
    run_cli_profile_and_errors()
    run_cli_streamed()


def run_kernel_checks(table, names):
    """Run the checks of the kernels in ``names``, print one line per row
    and hold every row to its limits; returns {kernel: rows}."""
    checks = {}
    for name in KERNEL_NAMES:
        if name not in names:
            continue
        checks[name] = table[name]()
        for row in checks[name]:
            emit({"phase": "kernel_check", "kernel": name, **row})
            require(row["max_rel_err"] <= row["tol"],
                    f"{name} disagrees with its plain version: {row}")
            require(row.get("skip_bit_exact", True),
                    f"{name}: the deflation skip changed the result: {row}")
            require(row.get("zeros_past_K", True),
                    f"{name}: columns past K not 0: {row}")
            require(row.get("local_bytes", 0) == 0,
                    f"{name}: stack frame or spills: {row}")
            require(row.get("identity_exact", True),
                    f"{name}: identity columns not exact: {row}")
            require(row.get("run_to_run_identical", True),
                    f"{name}: two runs on the same input differ: {row}")
            require(row.get("outside_view_untouched", True),
                    f"{name}: wrote outside the view it was given: {row}")
            require(row.get("one_launch", True),
                    f"{name}: more than one launch a call: {row}")
            require(row.get("syncs_per_column", 1) == 1,
                    f"{name}: not one grid sync a column: {row}")
            require(row.get("lower_triangle_zero", True),
                    f"{name}: nonzero below the diagonal: {row}")
            require(row.get("shift_choices_identical", True),
                    f"{name}: shift choices differ from the plain ones: "
                    f"{row}")
            require(row.get("kernel_vs_split_emulation", 0.0)
                    <= row.get("tol_vs_emulation", 0.0),
                    f"{name} disagrees with the split emulation: {row}")
            require(row.get("nonfinite_as_plain", True)
                    and row.get("nonfinite_rows", 2) == 2,
                    f"{name}: not finite where its plain version is, or "
                    f"the reverse: {row}")
            if "refine_rel_err" in row:
                require(row["refine_rel_err"] <= row["tol"],
                        f"{name}: spike_refine disagrees: {row}")
            require(row.get("bit_exact", True),
                    f"{name}: not bit for bit its plain version: {row}")
            require(row.get("host_syncs_rows_through_merge", 0) == 0,
                    f"{name}: rows_through_merge synchronizes: {row}")
            require(row.get("host_syncs_kernel", 0) == 0,
                    f"{name}: a call synchronizes the host: {row}")
            require(row.get("secular_stall", {}).get("ok", True),
                    f"{name}: roots stall where the CPU plain loop "
                    f"converges: {row}")
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", metavar="KERNEL[,KERNEL...]", default="",
                    help="build and check only these kernels "
                    f"({', '.join(KERNEL_NAMES)}), then stop: no solve, and "
                    "not the final line of a whole run")
    ap.add_argument("--cli-only", action="store_true",
                    help="build every kernel and run the CLI phases alone, "
                    "then stop: not the final line of a whole run")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build every kernel and run the mesh phases alone, "
                    "then stop: not the final line of a whole run")
    ap.add_argument("--mesh-worker", metavar="RANK,PORT", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = [k for k in args.only.split(",") if k]
    if set(only) - set(KERNEL_NAMES):
        ap.error(f"--only takes names from {', '.join(KERNEL_NAMES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mesh_worker:
        rank, port = (int(x) for x in args.mesh_worker.split(","))
        return mesh_worker(rank, port)
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
    reports = _build.build_all(sorted(
        {SOURCES.get(k, k) for k in only}
        | {x for k in only for x in EXTRA_SOURCES.get(k, ())})
        or _build.KERNELS)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(reports), "ptxas": {
              name: [ln.strip() for ln in rep.splitlines()
                     if "Used" in ln or "spill" in ln]
              for name, rep in reports.items()}})
    # the process's first window of torch.cuda's sync debug mode reports a
    # synchronizing call inside torch.cuda itself (seen on the card: one,
    # in torch/cuda/__init__.py, whatever runs in it); open it here, so
    # the windows that count a path's host syncs see only the path's
    emit({"phase": "sync_debug_first_window",
          "host_syncs": host_sync_sites(lambda: None)})
    frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads",
                        reports.get("cauchy_rowsum", ""))
    require(("cauchy_rowsum" not in reports or len(frames) >= 4)
            and all(f == ("0", "0", "0") for f in frames),
            f"cauchy_rowsum: a stack frame or spills in ptxas: {frames}")

    # the main path's input and a reference spectrum
    d, e = random_matrix(N, SEED)
    ref = scipy.linalg.eigvalsh_tridiagonal(d, e)
    norm_ref = float(np.abs(ref).max())

    if args.cli_only:
        run_cli(d, e, ref, norm_ref)
        print(smi_line, flush=True)
        emit({"ok": True, "only": ["cli"]})
        return 0
    if args.mesh_only:
        run_mesh_phases(d, e, ref, norm_ref, st.SolverConfig())
        print(smi_line, flush=True)
        emit({"ok": True, "only": ["mesh"]})
        return 0

    # 3. each kernel against its plain version at its path's shapes
    checks = run_kernel_checks(kernel_table(d, e, ref), only or KERNEL_NAMES)
    scan_inputs.cache_clear()
    torch.cuda.empty_cache()
    if only:
        print(smi_line, flush=True)
        emit({"ok": True, "only": only})
        return 0

    # 4. the main path: default (mixed) config, all eigenpairs, cold
    cfg = st.SolverConfig()
    reset_counts()
    with record_levels() as levels, range_host_times() as cold_ranges:
        solve, _ = solve_and_check(d, e, cfg, ref, norm_ref)
    solve["levels"] = levels
    launches = solve["launches"]
    reset_counts()
    with range_host_times() as warm_ranges:
        walls, phases = warm_walls(d, e, cfg)
    tree_warm = dtr.launches / len(walls)
    scans = plain_substituted_check(d, e, cfg)
    replays = plain_replays_substituted(d, e, cfg)
    emit({"phase": "solve", "n": N, "matrix": "random", "seed": SEED,
          "config": "SolverConfig() (mixed_precision_vectors=True)",
          **solve, "warm_walls_s": walls, "warm_median_phases_s": phases,
          "ranges_host_cold": cold_ranges,
          "ranges_host_warm_total": warm_ranges, "warm_solves": len(walls),
          "deflation_tree_launches_a_warm_solve": tree_warm,
          "scans_plain_substituted": scans,
          "replays_plain_substituted": replays})
    for name in MAIN_PATH_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the main path")
    require(launches["cauchy_rowsum"] == len(levels) - 1,
            "cauchy_rowsum not launched once a non-root level")
    require(launches["rotation_replay_t"] == len(levels) - 1,
            "rotation_replay_t not launched once a non-root level")
    require(launches["deflation_tree"] == len(levels) == tree_warm,
            f"deflation_tree not launched once a merge level ({len(levels)})"
            f": {launches['deflation_tree']} cold, {tree_warm} a warm solve")
    check_scan_launches(launches, solve["counts"],
                        cold_ranges["spike.interface_solve"]["calls"],
                        "the main path")

    # 5. the pure-f64 path on the same input
    cfg64 = st.SolverConfig(mixed_precision_vectors=False)
    reset_counts()
    s64, _ = solve_and_check(d, e, cfg64, ref, norm_ref)
    walls64, phases64 = warm_walls(d, e, cfg64)
    emit({"phase": "solve_f64", "n": N, "matrix": "random", "seed": SEED,
          "config": "mixed_precision_vectors=False", **s64,
          "warm_walls_s": walls64, "warm_median_phases_s": phases64})
    for name in ("dword_matmul", "secular_sums", "secular_solve"):
        require(s64["launches"][name] > 0,
                f"{name} was not launched on the f64 path")

    # 6. Poisson against its analytic spectrum: a spectrum that deflates
    # slowly (each level's K from m/2 to m, the widest non-root level full)
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
    with record_levels() as plevels, range_host_times() as pranges:
        pfull, _ = solve_and_check(dp, ep, cfg, exact, norm_p)
    pfull["levels"] = plevels
    pfull["ranges_host"] = pranges
    emit({"phase": "poisson", "n": N, "eigvals_only_wall_s": wall_p,
          "eigvals_only_err_vs_analytic_over_normT": p_err,
          "full_mixed": pfull})
    require(pfull["launches"]["cauchy_rowsum"] == len(plevels) - 1,
            "cauchy_rowsum not launched once a non-root level (Poisson)")
    require(pfull["launches"]["deflation_tree"] == len(plevels),
            "deflation_tree not launched once a merge level (Poisson)")
    check_scan_launches(pfull["launches"], pfull["counts"],
                        pranges["spike.interface_solve"]["calls"], "Poisson")

    # 7. the small-n routes: staged and fused side by side
    run_small_n(cfg)

    # 8. the dense front end at full width: cold with every check, then warm
    A = dense_matrix(N, SEED)
    t0 = time.perf_counter()
    ref_a = torch.linalg.eigvalsh(A)
    torch.cuda.synchronize()
    eigvalsh_s = time.perf_counter() - t0
    reset_counts()
    with range_host_times() as dranges:
        lam_a, V_a, cold = timed_dense(lambda tm: st.eigh(A, timer=tm))
    dense_launches = launch_counts()
    cold["ranges_host"] = dranges
    dense = {**cold, **dense_checks(A, lam_a, V_a, ref_a),
             "launches": dense_launches}
    del lam_a, V_a
    torch.cuda.empty_cache()
    _, _, warm = timed_dense(lambda tm: st.eigh(A, timer=tm))
    torch.cuda.empty_cache()
    # the same matrix with pure-f64 tridiagonal eigenvectors: what the
    # front end alone costs in orthogonality
    lam_a, V_a, run64 = timed_dense(
        lambda tm: st.eigh(A, config=cfg64, timer=tm))
    dense64 = {**run64, **dense_checks(A, lam_a, V_a, ref_a)}
    del lam_a, V_a
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.linalg.eigh(A)
    torch.cuda.synchronize()
    library_s = time.perf_counter() - t0
    stream_bytes = vecmat_stream_bytes(N, 32, 4)
    column_expected = hp.column_launches(N, 32, driver._bucket_count(N))
    emit({"phase": "dense", "n": N, "matrix": "(G+G^T)/(2 sqrt n)",
          "seed": SEED, "config": "SolverConfig(), panel=32, buckets=4",
          "min_gap_over_normA": float((ref_a[1:] - ref_a[:-1]).min()
                                      / ref_a.abs().max()),
          "vecmat_stream_bytes": stream_bytes,
          "tridiagonalize_s": {
              "cold": cold["phases_s"]["dense.tridiagonalize"],
              "warm": warm["phases_s"]["dense.tridiagonalize"],
              "bound_s": stream_bytes / PEAK_BYTES,
              "bound_is": "vecmat_stream_bytes / 3.35e12",
              "library_eigh_s": library_s},
          "apply_q_s": {"cold": cold["phases_s"]["dense.apply_q"],
                        "warm": warm["phases_s"]["dense.apply_q"]},
          "column_step_launches_per_column": sum(
              dense_launches[k] for k in column_expected) / (N - 1),
          "column_launches_expected": column_expected,
          **dense, "warm": warm, "f64_config": dense64,
          "library_eigvalsh_s": eigvalsh_s,
          "library_eigh_s": library_s,
          "library_is": "torch.linalg.eigh(A) on the card, the whole path"})
    require(dense_launches["dword_vecmat"] == N - 2,
            f"dword_vecmat launched {dense_launches['dword_vecmat']} times "
            f"on the dense path, not n-2 = {N - 2}")
    require(dense_launches["dword_matmul"] > 0,
            "dword_matmul was not launched on the dense path")
    # the column step's schedule: each panel's first reflector alone, a
    # fused W row + next reflector a column, each panel's last W row alone
    # (none after the identity column j = n-2); apply_q one larft a panel
    for name, count in column_expected.items():
        require(dense_launches[name] == count,
                f"{name} launched {dense_launches[name]} times on the dense "
                f"path, not {count} (householder_panel.column_launches)")
    apply_q_panels = -(-(N - 1) // 32)
    require(dense_launches["larft"] == apply_q_panels,
            f"larft launched {dense_launches['larft']} times on the dense "
            f"path, not once an apply_q panel ({apply_q_panels})")
    require(sum(dense_launches[k] for k in column_expected)
            <= 2.1 * (N - 1),
            "the column step made more than 2.1 launches a column")
    check_scan_launches(dense_launches, cold["counts"],
                        dranges["spike.interface_solve"]["calls"], "dense")

    # 8b. the same matrix through the two-stage front end (band 128) and
    # its band u=16 through eigh_banded, beside the one-stage walls above
    two_full, banded_full = two_stage_solves(A, ref_a, 128, 16)
    # the chase's bound and latency floor beside its phase, both bands
    chase_full = {}
    for name, bb, run in (("band_128", 128, two_full),
                          ("u_16", 16, banded_full)):
        plan = br.chase_device_plan(N, bb, torch.cuda.current_device())
        sync = grid_sync_us(plan.grid)
        chase_full[name] = dict(
            band_to_tridiag_s=run["phases_s"]["dense.band_to_tridiag"],
            plan=plan._asdict(), grid_sync_us=sync, **chase_bound(N, bb, sync))
        chase_full[name]["phase_over_l2_bound"] = (
            1e3 * chase_full[name]["band_to_tridiag_s"]
            / chase_full[name]["l2_bound_ms"])
    # the backtransform through Q2 beside its bound, both bands
    q2_full = {}
    for name, bb, run in (("band_128", 128, two_full),
                          ("u_16", 16, banded_full)):
        Kmax, _, _ = br._wave_geometry(N, bb)
        waves = range(3 * Kmax - 2)
        _, _, _, b_ms, b_by = q2_wave_bound(N, bb, N, waves)
        plan = br._q2_device_plan(torch.cuda.current_device(), bb)
        phase_s = run["phases_s"]["dense.apply_q2"]
        q2_full[name] = dict(apply_q2_s=phase_s, bound_ms=b_ms, bound_by=b_by,
                             phase_over_bound=1e3 * phase_s / b_ms,
                             **q2_a_traffic(N, bb, N, waves, plan))
    emit({"phase": "dense_two_stage_full", "n": N, "matrix": "the dense "
          "phase's", "eigh_band_128": two_full, "eigh_banded_u_16":
          banded_full, "chase": chase_full, "apply_q2": q2_full,
          "one_stage_wall_s": {"cold": cold["wall_s"],
                               "warm": warm["wall_s"]}})
    del A, ref_a
    torch.cuda.empty_cache()

    # 9. the two-stage and the banded front ends (the panel QR and the chase
    # as kernels): both solves with their checks and launch counts, the
    # chase's host syncs, eigenvalues only through both front ends
    A2 = dense_matrix(N_TWO_STAGE, SEED + 1)
    ref2 = torch.linalg.eigvalsh(A2)
    two, banded = two_stage_solves(A2, ref2, 128, 16)
    # eigenvalues only, both front ends (no reflector store, no wave log)
    norm2 = float(ref2.abs().max())
    vals = {}
    for name, band in (("one_stage", 0), ("two_stage", 128)):
        t0 = time.perf_counter()
        lam_only = st.eigh(A2, band=band, eigvals_only=True)
        torch.cuda.synchronize()
        err = float((lam_only - ref2).abs().max()) / norm2
        vals[name] = {"wall_s": time.perf_counter() - t0,
                      "eig_err_vs_eigvalsh_over_normA": err}
        require(err <= 1e-12, f"eigvals_only ({name}) off by {err} ||A||")
    # the chase and the backtransform through Q2 alone on what each front
    # end hands them: no host sync inside
    B2, _, _ = br.reduce_to_band(A2, 128)
    B16 = band_matrix(N_TWO_STAGE, 16, SEED + 1)
    X2 = torch.randn((N_TWO_STAGE, N_TWO_STAGE), dtype=torch.float64,
                     device="cuda")
    log128 = br.band_to_tridiag_wave(B2, 128)[2]
    log16 = br.band_to_tridiag_wave(B16, 16)[2]
    syncs = {"reduce_to_band": host_syncs(lambda: br.reduce_to_band(A2, 128)),
             "band_to_tridiag_band_128": host_syncs(
                 lambda: br.band_to_tridiag_wave(B2, 128)),
             "band_to_tridiag_u_16": host_syncs(
                 lambda: br.band_to_tridiag_wave(B16, 16)),
             "apply_q2_band_128": host_syncs(
                 lambda: br.apply_q2_wave_blocked(N_TWO_STAGE, 128, log128,
                                                  X2, overwrite=True)),
             "apply_q2_u_16": host_syncs(
                 lambda: br.apply_q2_wave_blocked(N_TWO_STAGE, 16, log16, X2,
                                                  overwrite=True))}
    del B2, B16, X2, log128, log16
    emit({"phase": "dense_two_stage", "n": N_TWO_STAGE,
          "eigh_band_128": two, "eigvals_only": vals,
          "eigh_banded_u_16": banded, "host_syncs": syncs})
    require(all(count == 0 for count in syncs.values()),
            f"a host sync inside dense.reduce_to_band, dense.band_to_tridiag "
            f"or dense.apply_q2: {syncs}")
    two_launches = two["launches"]
    dense_f32(A2, ref2)

    # 10. where the device time goes (one more warm run of each, profiled)
    reset_counts()
    prof = profile_solve(lambda: st.solve_tridiagonal_staged(
        d, e, config=cfg, compute_vectors=True))
    emit({"phase": "profile", "path": "solve_tridiagonal_staged, n=16384",
          **prof, "launches": launch_counts()})
    ranges = prof["ranges"]
    require(ranges["spike.interface_solve"]["launches"]
            <= 5 * max(ranges["spike.interface_solve"]["calls"], 1),
            f"spike.interface_solve: more than 5 launches a pass: {ranges}")
    require(ranges["refine.triage"]["launches"] < 100,
            f"refine.triage: 100 launches or more: {ranges}")
    _, _, warm2 = timed_dense(lambda tm: st.eigh(A2, timer=tm))
    emit({"phase": "profile", "path": f"eigh, n={N_TWO_STAGE}",
          "unprofiled_warm": warm2, "ranges_note": GRAPH_RANGES_NOTE,
          **profile_solve(lambda: st.eigh(A2))})
    # the one-stage reduction alone: its device idle share and its device
    # events a column (the column step's two launches, the panel's rank-2k
    # update and its two concatenations)
    tridiagonalize_profile(A2)
    del A2
    torch.cuda.empty_cache()

    # 11.-13. the memory routes: n=32768 staged, n=65536 grouped (the whole
    # basis resident) and streamed (halo'd blocks, never the whole basis)
    run_staged_large(cfg)
    d65, e65, lam65, norm65 = run_grouped(cfg)
    run_streamed(cfg, d65, e65, lam65, norm65)
    torch.cuda.empty_cache()

    # 14.-18. the CLI, as a user runs it
    run_cli(d, e, ref, norm_ref)

    # 19.-22. the mesh; n=65536 against the grouped phase's eigenvalues
    run_mesh_phases(d, e, ref, norm_ref, cfg, d65, e65, lam65, norm65)
    del d65, e65, lam65

    # 23. summary; launches from each kernel's own path: the main path's
    # run, the pure-f64 one for dword_matmul (on the mixed path it serves
    # only the wide cluster-orth Grams), the dense one for dword_vecmat
    paths = {"dword_matmul": ("solve_f64", s64["launches"]),
             "dword_vecmat": ("dense", dense_launches),
             "column_reflector": ("dense", dense_launches),
             "column_w": ("dense", dense_launches),
             "column_w_reflector": ("dense", dense_launches),
             "larft": ("dense", dense_launches),
             "band_chase": ("dense_two_stage", two_launches),
             "panel_qr": ("dense_two_stage", two_launches),
             "q2_blocks_t": ("dense_two_stage", two_launches),
             "q2_apply": ("dense_two_stage", two_launches)}
    kernels = []
    for name, rows in checks.items():
        row = rows[0]
        path, counted = paths.get(name, ("solve", launches))
        count = counted[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "symmetric_eigenvalue_tpu_torch/csrc/"
                      f"{SOURCES.get(name, name)}.cu",
            "replaces": REPLACES[name],
            **({"replaces_loop": REPLACES_LOOP[name]}
               if name in REPLACES_LOOP else {}),
            "launches": count,
            "launches_on": path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": row["ms"], "device_ms": row.get("device_ms"),
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            **({"l2_bound_ms": row["l2_bound_ms"]}
               if "l2_bound_ms" in row else {}),
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
