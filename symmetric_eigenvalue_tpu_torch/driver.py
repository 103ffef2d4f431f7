"""Solver driver: divide -> batched leaf solve -> batched conquer -> downsweep
-> (mixed precision) refinement.

Port of ``symmetric_eigenvalue_tpu/driver.py``.  Each tree level's merges
run together as one k-batched merge; the eigenvectors come from a top-down
sweep

    W[:, sel] = BD(Q_leaf) BD(U_{L-1}) ... U_root[:, sel]

with each level's U rematerialized from its compact MergeRep, in column
chunks of ``config.vec_chunk`` so only a chunk's buffers are live.  In the
default mixed-precision config the sweep runs in f32 and an f64 epilogue
(inverse iteration through the Spike kernels, residual triage with extra
and rescue passes, cluster CholeskyQR) restores working-precision
eigenpairs.  Everything runs on the device the caller names; a CUDA run goes
through the hand-written kernels and never through their plain versions.

Dense and banded inputs (:func:`eigh`, :func:`eigh_banded`) are reduced to
tridiagonal form by ``kernels/tridiagonalize.py`` or
``kernels/band_reduce.py``, solved by :func:`solve_tridiagonal_staged`, and
their eigenvectors transformed back through the reflectors.

Two memory routes for solves whose eigenvectors crowd the device: the
grouped route (the f32 downsweep and the first refinement pass run per
column group into one preallocated f64 result) when 12*n*C bytes pass
:func:`_grouped_bt_bytes`, and :func:`solve_tridiagonal_streamed`, which
never holds the whole basis.  Small mixed solves (n <= 8192) of
:func:`solve_tridiagonal_staged` take the fused route when
``FUSED_BT_OVERRIDE`` opens :func:`_fused_bt_enabled` (closed by default:
on the H100 its walls were not shown to be no worse than the staged
route's): part A, the f32 downsweep and the first refinement pass, as one
CUDA graph replay on CUDA; part B, the cluster orthonormalization planned
on the host from the eigenvalues while part A runs, and the measured
residuals, ending in one fetch.

With a mesh (``dist/mesh.py``, ``mesh=`` on the entry points) the
upsweep's levels are sharded over its devices by merge (or, for the few
wide top merges, by root slot) and the downsweep by column; the
refinement runs on the lead device on the gathered columns.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import (DEFAULT_CONFIG, SolverConfig, resolve_device,
                     usable_device_bytes)
from .core.tearing import tear
from .core.tree import TreePlan, build_plan
from .core.tridiag import residual_norms
from .dist.mesh import (Replicas, agreed, batch_mapped, last_axis_sharded,
                        replicated)
from .kernels import cauchy_matmul, rotation_replay, spike_solve
from .kernels.assemble import apply_u_level, assemble_u, rows_through_merge
from .kernels.band_reduce import (apply_q2_wave_blocked, band_to_tridiag_wave,
                                  reduce_to_band)
from .kernels.leaf import leaf_blocks, leaf_eigh_fn, solve_leaves
from .kernels.refine import (_wide_orth, apply_cluster_orth_plan,
                             inverse_iteration, orth_explicit_qr,
                             orthonormalize_clusters, plan_cluster_orth)
from .kernels.rotation_replay import planned_waves
from .kernels.secular import (MergeRep, merge_decompose, merge_partition,
                              merge_roots, widened)
from .kernels.tridiagonalize import apply_q, tridiagonalize
from .utils.timing import PhaseTimer, sync

_SENTINEL_MIN = 1e29    # Spike estimates above it mark a clipped solve (1e30)


class EighTridiagonalResult(NamedTuple):
    eigenvalues: torch.Tensor               # (n,) ascending
    eigenvectors: Optional[torch.Tensor]    # (n, C) columns in `select` order


def _merge_kwargs(config: SolverConfig):
    return dict(eps=config.eps(),
                deflation_factor=config.deflation_factor,
                max_secular_iters=config.max_secular_iters,
                secular_tol_factor=config.secular_tol_factor,
                use_gu_eisenstat=config.use_gu_eisenstat,
                block_size=config.block_size)


def _sentinels(d, e, plan: TreePlan):
    """Pad-slot diagonal values strictly above any eigenvalue of any torn
    block (Gershgorin of the torn blocks is bounded by max|d| + 3 max|e|)."""
    abs_e_max = torch.abs(e).max() if e.shape[0] > 0 else d.new_zeros(())
    bound = torch.abs(d).max() + 3.0 * abs_e_max
    base = 1.5 * bound + 1.0
    return base + torch.arange(plan.padded_n, dtype=d.dtype,
                               device=d.device) * (1e-3 * bound + 1e-3)


def _one_merge(x, i: int):
    """Merge i of a level's k-batched MergePartition or MergeRep."""
    return type(x)(*(t[i:i + 1] for t in x))


def _upsweep(d, e, plan: TreePlan, config: SolverConfig, mesh=None):
    """Tear, solve leaves, and run all merge levels bottom-up.

    With ``mesh`` (JAX ``driver.py:96-187``): tearing and the leaf blocks
    run replicated on the lead device, the leaf eigensolves batch-sharded
    over the leaves; a level whose merge count k divides the mesh (k >=
    its size) runs ``merge_decompose`` and ``rows_through_merge``
    batch-sharded over its merges, a wider one runs ``merge_partition``
    replicated and ``merge_roots`` one merge at a time with its slots
    sharded over the mesh (``slot_mesh``).  The sharded calls make the
    single-device code's host fetches once a shard (the leaf eigensolve's,
    ``rows_through_merge``'s rotation logs), and each waits for its own
    card, so the batch-sharded levels run on the cards one after another.

    Returns (reps, lam_top_sorted (padded_n,), Q_leaf) on the lead
    device."""
    dev = d.device

    def prep(d, e):
        d_t, betas, thetas = tear(d, e, plan)
        return leaf_blocks(d_t, e, plan, _sentinels(d, e, plan)), betas, thetas

    A, betas, thetas = replicated(prep, mesh)(d, e)
    last_rows = torch.as_tensor(
        np.asarray(plan.leaf_sizes, dtype=np.int64) - 1, device=dev)
    eigh_fn = leaf_eigh_fn(plan.leaf_pad)

    def leaf_eigh(A, last_rows):
        lam, Q = eigh_fn(A)
        rows = torch.arange(A.shape[0], device=A.device)
        return lam, Q, Q[:, 0, :], Q[rows, last_rows, :]

    lam, Q, f, l = batch_mapped(leaf_eigh, mesh, plan.num_leaves)(A,
                                                                   last_rows)

    reps = []
    L = plan.num_levels
    kw = _merge_kwargs(config)
    ndev = mesh.size if mesh is not None else 1
    for li, lv in enumerate(plan.levels):
        k, m = lv.num_merges, lv.merge_size
        h = m // 2
        lam2 = lam.reshape(k, 2, h)
        f2 = f.reshape(k, 2, h)
        l2 = l.reshape(k, 2, h)
        theta = thetas[li]
        # z = [last row of W_left ; first row of W_right / theta]
        z = torch.cat([l2[:, 0, :], f2[:, 1, :] / theta[:, None]], dim=1)
        rho = betas[li] * theta          # = |beta| >= 0 by construction
        dm = lam2.reshape(k, m)
        if mesh is not None and (k < ndev or k % ndev):
            # wide top-of-tree merges: the O(m) deflation replicates, the
            # O(m^2) root finding is sharded over slots
            part = replicated(functools.partial(
                merge_partition, eps=kw["eps"],
                deflation_factor=kw["deflation_factor"]), mesh)(dm, z, rho)
            roots_kw = {key: kw[key] for key in (
                "eps", "max_secular_iters", "secular_tol_factor",
                "use_gu_eisenstat", "block_size")}
            per_merge = [merge_roots(_one_merge(part, i), slot_mesh=mesh,
                                     **roots_kw) for i in range(k)]
            rep = MergeRep(*(torch.cat(fs) for fs in zip(*per_merge)))
        else:
            rep = batch_mapped(functools.partial(merge_decompose, **kw),
                               mesh, k)(dm, z, rho)
        if li < L - 1:
            # propagate the subtree's first/last actual boundary rows
            zero = torch.zeros((k, h), dtype=d.dtype, device=dev)
            w = torch.stack([torch.cat([f2[:, 0, :], zero], dim=1),
                             torch.cat([zero, l2[:, 1, :]], dim=1)], dim=1)
            y = batch_mapped(rows_through_merge, mesh, k)(rep, w)
            f, l = y[:, 0, :], y[:, 1, :]
        lam = rep.lam_sorted
        reps.append(rep)
    return reps, lam.reshape(-1), Q


def _upsweep_leaf_only(d, e, plan: TreePlan):
    """Single leaf: one dense eigh (no merges)."""
    lam, Q, _, _ = solve_leaves(d, e, plan, _sentinels(d, e, plan))
    return lam.reshape(-1), Q


@contextlib.contextmanager
def full_f32_matmul():
    """Pin f32 matrix products to full f32 (TF32 off) and restore the
    caller's setting after: the counterpart of the JAX package's
    ``Precision.HIGHEST``.  TF32 keeps ~1e-3, which would swamp the
    refinement's f32-grade contamination model."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def downsweep_stepped(reps, Q_leaf, plan: TreePlan, config: SolverConfig,
                      sel, dtype: torch.dtype = torch.float64, mesh=None,
                      replicas: Optional[Replicas] = None):
    """W[:, sel] = BD(Q_leaf) BD(U_{L-1}) ... U_root[:, sel] in ``dtype``,
    one level at a time and in column chunks of ``config.vec_chunk``
    (columns are independent end to end).  Each step drops its input before
    the next, so a chunk keeps only X_in, X_out and one block live.

    dtype float32 (the mixed path): the root U through
    ``cauchy_materialize``, every other level through ``cauchy_matmul``,
    the leaf product in full f32.

    ``mesh`` (JAX ``driver.py:367-434``): when C is a multiple of its size
    (C >= it), column-sharded: each shard sweeps its own contiguous C/ndev
    columns end to end on its device, on copies of the O(n) ``reps`` and
    ``Q_leaf`` (``replicas``: those copies made once by the caller, as
    ``Replicas(mesh, (reps, Q_leaf))``, for several calls of one solve),
    and the columns are gathered on the lead device with no other
    collective; otherwise the sweep runs on the lead device."""
    if mesh is not None:
        C = int(sel.shape[0])
        if C % mesh.size == 0 and C >= mesh.size:
            if replicas is None:
                replicas = Replicas(mesh, (reps, Q_leaf))

            def shard(rq, cols):
                return downsweep_stepped(rq[0], rq[1], plan, config, cols,
                                         dtype)

            return last_axis_sharded(shard, mesh, (None, 1), 2)(replicas,
                                                               sel)
    n, C = plan.n, int(sel.shape[0])
    dev = Q_leaf.device
    block = config.block_size
    waves = [planned_waves(rep) for rep in reps]
    row_map = torch.as_tensor(plan.row_map(), device=dev)
    V = torch.empty((n, C), dtype=dtype, device=dev)
    Q = Q_leaf.to(dtype)
    chunk = max(1, config.vec_chunk)
    for o in range(0, C, chunk):
        cols = sel[o:o + chunk]
        w = int(cols.shape[0])
        X = assemble_u(reps[-1], cols=cols, block=block, waves=waves[-1],
                       dtype=dtype)
        for li in range(plan.num_levels - 2, -1, -1):
            lv = plan.levels[li]
            X = apply_u_level(reps[li], X.reshape(lv.num_merges,
                                                  lv.merge_size, w),
                              block=block, waves=waves[li])
        with full_f32_matmul():
            X = torch.bmm(Q, X.reshape(plan.num_leaves, plan.leaf_pad, w))
        V[:, o:o + w] = X.reshape(plan.padded_n, w).index_select(0, row_map)
        del X
    return V


def _residual_norms_chunked(d, e, lam, V, chunk: int):
    """||T v_i - lam_i v_i|| for every column of V, in column chunks (a
    full-width pass would allocate several (n, C) temporaries)."""
    out = torch.empty(V.shape[1], dtype=d.dtype, device=V.device)
    for o in range(0, V.shape[1], chunk):
        out[o:o + chunk] = residual_norms(d, e, lam[o:o + chunk],
                                          V[:, o:o + chunk])
    return out


def _refine_ops(d, e, n: int, config: SolverConfig):
    """The epilogue's two building blocks.

    one_pass(lam_c, V_c, nb, allow_spike=True): one inverse-iteration pass,
    returning (V, res_estimate or None): ``spike_solve.spike_refine`` (the
    Spike kernels on CUDA, their plain versions on the CPU) when
    ``config.use_pallas_refine`` and n >= 512, else the PyTorch solver in
    column chunks.  residuals_chunked(lam_c, V_c): MEASURED residual norms
    as a host array (one fetch)."""
    chunk = max(1, min(config.vec_chunk,
                       config.resolved_refine_chunk(n, d.device)))
    use_spike = config.use_pallas_refine and n >= 512

    def one_pass(lam_c, V_c, nb, allow_spike=True):
        if use_spike and allow_spike:
            return spike_solve.spike_refine(d, e, lam_c, V_c, nb=nb,
                                            chunk=chunk)
        nc = int(lam_c.shape[0])
        X = torch.empty((n, nc), dtype=d.dtype, device=d.device)
        for o in range(0, nc, chunk):
            X[:, o:o + chunk] = inverse_iteration(
                d, e, lam_c[o:o + chunk], V_c[:, o:o + chunk], steps=1,
                block=nb)
        return X, None

    def residuals_chunked(lam_c, V_c):
        return _residual_norms_chunked(d, e, lam_c, V_c, chunk).cpu().numpy()

    return one_pass, residuals_chunked


def _refine_vectors(d, e, lam, sel, V, config: SolverConfig,
                    subtimer: Optional[PhaseTimer] = None,
                    pass1_done: bool = False, res1_dev=None):
    """Mixed-precision epilogue on the prescaled system (d, e, lam all
    divided by the same norm): one f64 inverse-iteration pass restores
    working-precision residuals from the f32 downsweep; segments of close
    eigenvalues are re-orthonormalized (dstein-style) before residual
    triage and once more at the end.

    ``subtimer`` records the step walls ("refine_pass1", "ortho_mid",
    "residuals1", "refine_extra", "refine_rescue", "ortho_final") and the
    triage's column counts; with a device it syncs after each step.

    ``pass1_done``: the caller already ran the first pass (the grouped
    route folds it into its downsweep groups); ``res1_dev`` then carries
    its Spike estimates, or None."""
    subtimer = subtimer if subtimer is not None else PhaseTimer()
    lam_sel = lam[sel]
    C = int(sel.shape[0])
    n = int(d.shape[0])
    one_pass, residuals_chunked = _refine_ops(d, e, n, config)

    if not pass1_done:
        with subtimer.phase("refine_pass1"):
            V, res1_dev = one_pass(lam_sel, V, config.refine_block)

    lam_host = lam.cpu().numpy()
    norm_t = float(np.max(np.abs(lam_host))) if lam_host.size else 0.0
    lam_np = lam_host[sel.cpu().numpy()]

    did_triage = config.refine_steps > 1 and C > 1
    touched = np.zeros(C, dtype=bool)
    if did_triage:
        # explicitly orthonormalize every near-degenerate segment the f32
        # downsweep could not resolve (gaps below ~refine_risky_gap_factor *
        # u_f32 * ||T||) BEFORE residual triage
        u_f32 = float(torch.finfo(torch.float32).eps) / 2.0
        gap_mid = max(config.ortho_gap_factor,
                      config.refine_risky_gap_factor * u_f32)
        with subtimer.phase("ortho_mid"):
            V = orthonormalize_clusters(
                lam_np, V, norm_t, gap_factor=gap_mid,
                min_gap_factor=config.cluster_gap_factor)
        with subtimer.phase("residuals1"):
            # MEASURED residuals: the Spike estimate undershoots on
            # block-resonant columns, so triage never trusts it; its clip
            # sentinel still forces a column into the extra pass
            res1 = residuals_chunked(lam_sel, V)
            sentinel = (res1_dev.cpu().numpy() > _SENTINEL_MIN
                        if res1_dev is not None else np.zeros(C, bool))
        with torch.profiler.record_function("refine.triage"):
            V, touched = _triage_passes(d, e, lam_sel, V, res1, sentinel,
                                        norm_t, config, one_pass,
                                        residuals_chunked, subtimer)
    # final cleanup: genuinely degenerate segments (skipped by the mid pass)
    # and segments holding a column the extra/rescue passes replaced
    with subtimer.phase("ortho_final"):
        if did_triage:
            V = orthonormalize_clusters(
                lam_np, V, norm_t, gap_factor=gap_mid, touched=touched,
                degenerate_below=config.cluster_gap_factor)
        else:
            V = orthonormalize_clusters(lam_np, V, norm_t,
                                        gap_factor=config.ortho_gap_factor)
    return V


def _fused_extra(lam_r, V, idx, res1_idx, config: SolverConfig, one_pass,
                 residuals_chunked):
    """The extra-pass triage step: gather the risky columns ``idx`` (host
    int array), give them ``refine_steps - 1`` passes at the alternate
    block size, measure their residuals, and write back only the columns
    whose measured residual beats ``res1_idx``.  Returns (res_b, improved)
    as host arrays.

    The JAX package has two variants of this step, one jit for narrow
    buckets and an unfused one for wide or Spike buckets; they compute the
    same columns, so one function serves both here."""
    idx_t = torch.as_tensor(idx, device=V.device)
    Vr = V[:, idx_t]
    for _ in range(config.refine_steps - 1):
        Vr, _unused = one_pass(lam_r, Vr, config.refine_block_alt,
                               allow_spike=config.use_pallas_refine_extra)
    res_b = residuals_chunked(lam_r, Vr)
    improved = res_b < res1_idx
    if improved.any():
        keep = torch.as_tensor(np.flatnonzero(improved), device=V.device)
        V[:, idx_t[keep]] = Vr[:, keep]
    return res_b, improved


def _triage_passes(d, e, lam_sel, V, res1, sentinel, norm_t,
                   config: SolverConfig, one_pass, residuals_chunked,
                   subtimer: PhaseTimer):
    """Residual triage + extra/rescue refinement passes.

    Flags columns whose MEASURED residual exceeds refine_residual_factor *
    eps * ||T|| (or whose Spike estimate hit the 1e30 clip sentinel), gives
    them extra passes at ``refine_block_alt`` and accepts a re-solve only
    when the measured residual improves; columns still above the threshold
    get two PyTorch-solver passes at ``refine_block_rescue``, accepted the
    same way.  No column ends worse than its best attempt.  Returns (V,
    touched), touched marking the replaced columns; the column counts go to
    ``subtimer.counts``."""
    C = int(lam_sel.shape[0])
    touched = np.zeros(C, dtype=bool)
    thr_res = config.refine_residual_factor * config.eps() * \
        max(norm_t, 1e-30)
    risky = (res1 > thr_res) | sentinel
    idx = np.nonzero(risky)[0]
    counts = subtimer.counts
    counts["risky"] = int(idx.size)
    counts["risky_sentinel"] = int(sentinel.sum())
    counts["extra_improved"] = 0
    counts["rescue"] = 0
    counts["rescue_improved"] = 0
    if not idx.size:
        return V, touched
    with subtimer.phase("refine_extra"):
        res_b, improved = _fused_extra(lam_sel[torch.as_tensor(
            idx, device=V.device)], V, idx, res1[idx], config, one_pass,
            residuals_chunked)
    touched[idx[improved]] = True
    counts["extra_improved"] = int(improved.sum())
    res_after = res1.copy()
    res_after[idx] = np.where(improved, res_b, res1[idx])
    still = np.nonzero(risky & (res_after > thr_res))[0]
    counts["rescue"] = int(still.size)
    if still.size:
        with subtimer.phase("refine_rescue"):
            st = torch.as_tensor(still, device=V.device)
            lam_r2 = lam_sel[st]
            Vr2 = inverse_iteration(d, e, lam_r2, V[:, st], steps=2,
                                    block=config.refine_block_rescue)
            res2 = residuals_chunked(lam_r2, Vr2)
            improved2 = res2 < res_after[still]
            if improved2.any():
                keep = torch.as_tensor(np.flatnonzero(improved2),
                                       device=V.device)
                V[:, st[keep]] = Vr2[:, keep]
            touched[still[improved2]] = True
            counts["rescue_improved"] = int(improved2.sum())
    return V, touched


# The JAX package sizes the grouped route for a 16 GB chip with ~14.5e9
# usable bytes: it switches at 8e9 bytes of 12*n*C and budgets 2e9 bytes
# for a group.  Here both keep that share of the run device's budget; on
# the CPU (0.9 * 16e9 usable) the switch lands at 7.94e9, the reference's
# 8e9 to within 1%.
_GROUPED_SHARE = 8e9 / 14.5e9
_GROUP_SHARE = 2e9 / 14.5e9


def _grouped_bt_bytes(device) -> float:
    """Bytes of 12*n*C (the f32 downsweep output and its f64 refined copy,
    live together on the plain staged route) above which the mixed path
    takes the grouped route."""
    return _GROUPED_SHARE * usable_device_bytes(device)


def _group_width(n: int, config: SolverConfig, device) -> int:
    """Columns a group of the grouped route: its f32 downsweep output and
    f64 refined copy (12*n*g bytes) within the group budget, a multiple of
    256 (the Spike passes' column tiling), at least 256 and at most
    ``max(vec_chunk, 256)``."""
    g = int(_GROUP_SHARE * usable_device_bytes(device) / (12.0 * max(n, 1)))
    return max(256, min(max(config.vec_chunk, 256), (g // 256) * 256))


def _grouped_downsweep_refine(reps, Q, d, e, lam, sel, plan: TreePlan,
                              config: SolverConfig, subtimer: PhaseTimer,
                              mesh=None):
    """Column-grouped f32 downsweep + first refinement pass, for solves
    whose whole f32 downsweep output and f64 refined copy (12*n*C bytes)
    crowd the device.  Columns are independent through both steps, so each
    group's f32 output is dropped as soon as its refined columns land in
    the one preallocated (n, C) f64 result: the peak is 8*n*C + 12*n*g
    bytes plus a group's working set.

    Returns ``(V, res1_dev)``, res1_dev the groups' Spike estimates
    concatenated, or None when any group ran the estimate-free solver.
    The step is timed as "downsweep_refine_grouped" in ``subtimer``.

    PyTorch's caching allocator reuses a freed group's blocks in stream
    order, so one group's working set is live at a time without the host
    sync the JAX package needs between groups.

    ``mesh``: each group's downsweep is column-sharded over it (the reps
    and Q_leaf copied to the shards once for all groups; the width the
    least over the mesh's processes, so all make the same gathers); the
    refinement pass runs on the lead device."""
    n = plan.n
    C = int(sel.shape[0])
    one_pass, _ = _refine_ops(d, e, n, config)
    g = int(agreed(mesh, _group_width(n, config, d.device)))
    lam_sel = lam[sel]
    X = torch.empty((n, C), dtype=d.dtype, device=d.device)
    res_parts = []
    replicas = Replicas(mesh, (reps, Q)) if mesh is not None else None
    with subtimer.phase("downsweep_refine_grouped"):
        for o in range(0, C, g):
            Vg = downsweep_stepped(reps, Q, plan, config, sel[o:o + g],
                                   dtype=torch.float32, mesh=mesh,
                                   replicas=replicas)
            Xg, rg = one_pass(lam_sel[o:o + g], Vg, config.refine_block)
            del Vg
            X[:, o:o + g].copy_(Xg)
            del Xg
            res_parts.append(rg)
    if any(r is None for r in res_parts):
        return X, None
    return X, torch.cat(res_parts)


# True opens the fused route's gate past its size and config conditions
# (the tests, chip_smoke.py): the counterpart of the JAX package's
# SE_FORCE_FUSED_BT.  Closed by default on every device: the JAX package
# opens it on a TPU only, and on the H100 the fused route's median warm wall
# was not no worse than the staged route's in every n=4096 and n=8192 cell
# of chip_smoke.py's small_n phase (PERF.md).
FUSED_BT_OVERRIDE = False
_FUSED_BT_MAX_N = 8192
_FUSED_GRAPHS_MAX = 2
_FUSED_GRAPHS: "OrderedDict[tuple, _PartAGraph]" = OrderedDict()
# one warm-up stream per device for every capture: PyTorch keeps a cuBLAS
# workspace for each stream that ran a product, so a new stream a capture
# would hold one more workspace each time
_WARMUP_STREAMS: dict = {}
graph_replays = 0
"""Replays of a part A graph so far."""


def _fused_bt_enabled(n: int, config: SolverConfig, leaf_only: bool,
                      want_vectors: bool, C: int, mesh=None) -> bool:
    """Gate of the fused small-n backtransform (part A as one CUDA graph,
    part B ending in one fetch): vectors of a tree with merges on one
    device (no ``mesh``), the mixed config with triage (refine_steps > 1),
    C > 1 columns and n <= 8192, and ``FUSED_BT_OVERRIDE``."""
    if not want_vectors or leaf_only or mesh is not None:
        return False
    if not config.mixed_precision_vectors or config.refine_steps <= 1:
        return False
    if C <= 1 or n > _FUSED_BT_MAX_N:
        return False
    return bool(FUSED_BT_OVERRIDE)


def _fused_bt_a_body(reps, Q, d, e, lam, sel, row_map, plan: TreePlan,
                     config: SolverConfig, chunk: int):
    """Part A of the fused route: the f32 downsweep of the columns ``sel``
    in one column chunk (``cauchy_materialize`` at the root,
    ``cauchy_matmul`` and ``rotation_replay`` per level, the leaf product in
    full f32, the row map), then one f64 inverse-iteration pass (the Spike
    passes when ``config.use_pallas_refine`` and n >= 512).  Returns (V (n,
    C) f64, est (C,)): est the Spike residual estimates, zeros otherwise.
    No host fetch: a CUDA graph holds it."""
    n, C = plan.n, int(sel.shape[0])
    block = config.block_size
    X = assemble_u(reps[-1], cols=sel, block=block, dtype=torch.float32)
    for li in range(plan.num_levels - 2, -1, -1):
        lv = plan.levels[li]
        X = apply_u_level(reps[li], X.reshape(lv.num_merges, lv.merge_size, C),
                          block=block)
    with full_f32_matmul():
        X = torch.bmm(Q.to(torch.float32),
                      X.reshape(plan.num_leaves, plan.leaf_pad, C))
    V = X.reshape(plan.padded_n, C).index_select(0, row_map)
    del X
    lam_sel = lam[sel]
    if config.use_pallas_refine and n >= 512:
        return spike_solve.spike_refine(d, e, lam_sel, V,
                                        nb=config.refine_block, chunk=chunk)
    V = inverse_iteration(d, e, lam_sel, V, steps=1, block=config.refine_block)
    return V, torch.zeros(C, dtype=V.dtype, device=V.device)


class _PartAGraph(NamedTuple):
    """A captured part A: the graph, its static inputs (every MergeRep
    field, Q_leaf, d, e, lam, sel, flattened), its outputs (V, est) in the
    graph's pool, and each kernel counter's launches in one replay."""

    graph: "torch.cuda.CUDAGraph"
    inputs: list
    outputs: tuple
    launches: dict


# every kernel counter part A can reach: (module, name)
_PART_A_COUNTERS = ((cauchy_matmul, "matmul_launches"),
                    (cauchy_matmul, "materialize_launches"),
                    (rotation_replay, "launches"),
                    (spike_solve, "pass_a_launches"),
                    (spike_solve, "pass_b_launches"))


def _part_a_inputs(reps, Q, d, e, lam, sel):
    return [t for rep in reps for t in rep] + [Q, d, e, lam, sel]


def _capture_part_a(args, plan: TreePlan, config: SolverConfig, chunk: int):
    """Capture part A on static copies of ``args`` (reps, Q, d, e, lam,
    sel): one eager warm-up run on a side stream first (it builds the
    kernels' libraries and the library handles and caches a capture may
    not create), then the capture.  A failed capture raises."""
    reps = args[0]
    dev = args[1].device
    static = [t.clone() for t in _part_a_inputs(*args)]
    nf = len(reps[0])
    s_reps = [type(reps[0])(*static[i * nf:(i + 1) * nf])
              for i in range(len(reps))]
    s_args = (s_reps, *static[len(reps) * nf:])
    row_map = torch.as_tensor(plan.row_map(), device=dev)
    with torch.cuda.device(dev):
        side = _WARMUP_STREAMS.get(dev)
        if side is None:
            side = _WARMUP_STREAMS[dev] = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _fused_bt_a_body(*s_args, row_map, plan, config, chunk)
        torch.cuda.current_stream().wait_stream(side)
        warm = {c: getattr(*c) for c in _PART_A_COUNTERS}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = _fused_bt_a_body(*s_args, row_map, plan, config, chunk)
            per_replay = {c: getattr(*c) - warm[c] for c in _PART_A_COUNTERS}
        finally:
            # a capture launches nothing: keep the warm-up's real launches
            for (mod, name), v in warm.items():
                setattr(mod, name, v)
    # row_map rides last: the graph reads it and no solve copies into it
    return _PartAGraph(graph, static + [row_map], out, per_replay)


def _fused_bt_a(reps, Q, d, e, lam, sel, plan: TreePlan, config: SolverConfig,
                chunk: int):
    """Part A (:func:`_fused_bt_a_body`) enqueued: eagerly on the CPU; on
    CUDA as one replay of the graph cached for (n, C, config, device,
    chunk) (at most two cached; a new key is captured at its first solve),
    after copying this solve's inputs into the graph's static buffers.  The
    returned (V, est) are then the graph's own buffers, which its next
    replay overwrites.  Each replay adds its captured launches to the
    kernels' counters."""
    global graph_replays
    if d.device.type != "cuda":
        row_map = torch.as_tensor(plan.row_map(), device=d.device)
        return _fused_bt_a_body(reps, Q, d, e, lam, sel, row_map, plan,
                                config, chunk)
    key = (plan.n, int(sel.shape[0]), config, d.device, chunk)
    args = (reps, Q, d, e, lam, sel)
    entry = _FUSED_GRAPHS.get(key)
    if entry is None:
        entry = _capture_part_a(args, plan, config, chunk)
        _FUSED_GRAPHS[key] = entry
        while len(_FUSED_GRAPHS) > _FUSED_GRAPHS_MAX:
            _FUSED_GRAPHS.popitem(last=False)
    else:
        _FUSED_GRAPHS.move_to_end(key)
        for dst, src in zip(entry.inputs, _part_a_inputs(*args)):
            dst.copy_(src)
    with torch.cuda.device(d.device):
        entry.graph.replay()
    graph_replays += 1
    for (mod, name), k in entry.launches.items():
        setattr(mod, name, getattr(mod, name) + k)
    return entry.outputs


def clear_fused_graphs() -> None:
    """Drop the cached part A graphs and the device memory their pools
    hold."""
    _FUSED_GRAPHS.clear()


def _plan_tensors(orth_plan, device):
    """plan_cluster_orth's index arrays on ``device`` by one asynchronous
    copy from pinned memory (no host sync): (starts_l, widths_l,
    seg_of_col, srcpos, mask_plan)."""
    _sig, starts_l, widths_l, seg_of_col, srcpos, mask_plan = orth_plan[:6]
    parts = [*starts_l, *widths_l, seg_of_col, srcpos,
             mask_plan.astype(np.int64)]
    flat = torch.from_numpy(np.concatenate(parts))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    out, o = [], 0
    for a in parts:
        out.append(flat[o:o + a.size])
        o += a.size
    nb = len(starts_l)
    return (out[:nb], out[nb:2 * nb], out[2 * nb], out[2 * nb + 1],
            out[2 * nb + 2].to(torch.bool))


def _fused_backtransform(reps, Q, d, e, lam, sel, plan: TreePlan,
                         config: SolverConfig, sub: PhaseTimer):
    """The fused small-n backtransform of the prescaled system: fetch lam
    and sel (the device is idle at the end of the eigenvalue phase), enqueue
    part A (:func:`_fused_bt_a`), plan the cluster orthonormalization on
    the host from the eigenvalues alone while it runs
    (``plan_cluster_orth``), then part B: the planned CholeskyQRs merged
    into a new V (``apply_cluster_orth_plan``), the measured residuals, and
    ONE fetch of [res, est, seg_ok] ("fused_bt" in ``sub``).  Rejected and
    wide segments get an explicit orthonormalization ("ortho_rescue") and
    their residuals measured again; then the staged route's triage
    (``_triage_passes``) and, for segments holding a replaced column,
    "ortho_final": the JAX package's steps after its part B."""
    n = plan.n
    C = int(sel.shape[0])
    lam_all = lam.cpu().numpy()
    sel_np = sel.cpu().numpy()
    lam_np = lam_all[sel_np]
    norm_t = float(np.max(np.abs(lam_all)))
    u_f32 = float(torch.finfo(torch.float32).eps) / 2.0
    gap_mid = max(config.ortho_gap_factor,
                  config.refine_risky_gap_factor * u_f32)
    chunk = max(1, min(config.vec_chunk,
                       config.resolved_refine_chunk(n, d.device)))
    spike = config.use_pallas_refine and n >= 512
    with sub.phase("fused_bt"):
        V_a, est = _fused_bt_a(reps, Q, d, e, lam, sel, plan, config, chunk)
        orth_plan = plan_cluster_orth(lam_np, norm_t, gap_mid, C, n)
        seg_ranges, wide = orth_plan[6], orth_plan[7]
        starts_l, widths_l, seg_of_col, srcpos, mask_plan = _plan_tensors(
            orth_plan, d.device)
        lam_sel = lam[sel]
        V, ok_cat = apply_cluster_orth_plan(V_a, orth_plan[0], starts_l,
                                            widths_l, seg_of_col, srcpos,
                                            mask_plan)
        if V is V_a:    # nothing planned: leave the graph's buffer to it
            V = V_a.clone()
        res = _residual_norms_chunked(d, e, lam_sel, V, chunk)
        packed = torch.cat([res, est, ok_cat.to(res.dtype)]).cpu().numpy()
    del V_a, est
    res1 = packed[:C]
    est_np = packed[C:2 * C]
    ok = packed[2 * C:] > 0.5
    bad = [seg_ranges[i] for i in np.nonzero(~ok)[0]]
    if bad or wide:
        with sub.phase("ortho_rescue"):
            for s, t in wide:
                okw, Yw = _wide_orth(V[:, s:t])
                if bool(okw):
                    V[:, s:t] = Yw
                else:
                    orth_explicit_qr(V, [(s, t)])
            orth_explicit_qr(V, bad)
    sentinel = est_np > _SENTINEL_MIN if spike else np.zeros(C, dtype=bool)
    one_pass, residuals_chunked = _refine_ops(d, e, n, config)
    if bad or wide:
        # res1 was measured before the rescue: measure the rescued columns
        # again, or the triage would judge a re-solve against a stale
        # baseline
        ridx = np.unique(np.concatenate([np.arange(s, t)
                                         for s, t in bad + wide]))
        ridx_t = torch.as_tensor(ridx, device=V.device)
        res1 = res1.copy()
        res1[ridx] = residuals_chunked(lam_sel[ridx_t], V[:, ridx_t])
    with torch.profiler.record_function("refine.triage"):
        V, touched = _triage_passes(d, e, lam_sel, V, res1, sentinel, norm_t,
                                    config, one_pass, residuals_chunked, sub)
    if touched.any():
        with sub.phase("ortho_final"):
            V = orthonormalize_clusters(lam_np, V, norm_t, gap_factor=gap_mid,
                                        touched=touched)
    return V


def _backtransform(reps, Q, d, e, lam, cols, plan: TreePlan,
                   config: SolverConfig, mixed: bool, sub: PhaseTimer,
                   fused: bool = True, mesh=None):
    """Eigenvector columns ``cols`` of the prescaled system: the leaf's own
    vectors when there is no merge, the f64 downsweep, or (``mixed``) the
    f32 downsweep and the refinement epilogue: fused
    (:func:`_fused_backtransform`) when ``fused`` (False for the streamed
    route's windows) and :func:`_fused_bt_enabled` open, grouped when
    12*n*C bytes pass :func:`_grouped_bt_bytes`, else staged.  ``sub``
    gets the steps' times and the triage's counts.

    f32 mode (d in f32): the MergeReps, Q_leaf, d, e and lam are widened to
    f64 and the f64 mode's route runs on them, the same kernels at the same
    shapes (they are f64-only, as the JAX package's); the columns come back
    rounded to f32.  The refinement's thresholds read ``config.eps()`` (the
    f32 unit roundoff) and u_f32, as the JAX package reads them.

    ``mesh``: the downsweep is column-sharded over it
    (:func:`downsweep_stepped`); the refinement runs on the lead device
    on the gathered columns, as the JAX package's refinement, whose kernel
    calls are not sharded either; the fused route is closed."""
    if d.dtype != torch.float64:
        reps = None if reps is None else [widened(rep) for rep in reps]
        f64 = [t.to(torch.float64) for t in (Q, d, e, lam)]
        return _backtransform(reps, *f64, cols, plan, config, mixed,
                              sub, fused, mesh).to(d.dtype)
    n = plan.n
    if reps is None:
        return Q[0][:n, :n][:, cols]
    if not mixed:
        return downsweep_stepped(reps, Q, plan, config, cols, mesh=mesh)
    if fused and _fused_bt_enabled(n, config, False, True,
                                   int(cols.shape[0]), mesh):
        return _fused_backtransform(reps, Q, d, e, lam, cols, plan, config,
                                    sub)
    if 12.0 * n * int(cols.shape[0]) > agreed(mesh,
                                              _grouped_bt_bytes(d.device)):
        V, res1_dev = _grouped_downsweep_refine(reps, Q, d, e, lam, cols,
                                                plan, config, sub, mesh)
        return _refine_vectors(d, e, lam, cols, V, config, subtimer=sub,
                               pass1_done=True, res1_dev=res1_dev)
    with sub.phase("downsweep"):
        V = downsweep_stepped(reps, Q, plan, config, cols,
                              dtype=torch.float32, mesh=mesh)
    return _refine_vectors(d, e, lam, cols, V, config, subtimer=sub)


def _prescale(d, e):
    """Global prescale to ||T||-ish ~ 1 (keeps every intermediate O(1))."""
    abs_e_max = torch.abs(e).max() if e.shape[0] > 0 else d.new_zeros(())
    snorm = torch.clamp(torch.abs(d).max() + 2.0 * abs_e_max, min=1e-30)
    return d / snorm, e / snorm, snorm


def _eigenvalues(d, e, plan: TreePlan, config: SolverConfig,
                 timer: PhaseTimer, mesh=None):
    """The timed eigenvalue phase: (reps or None, lam (n,), Q_leaf)."""
    with timer.phase("eigenvalues"):
        if plan.num_levels == 0:
            lam_flat, Q = _upsweep_leaf_only(d, e, plan)
            reps = None
        else:
            reps, lam_flat, Q = _upsweep(d, e, plan, config, mesh)
    return reps, lam_flat[:plan.n], Q


def _solve_scaled(d, e, sel, plan: TreePlan, config: SolverConfig,
                  want_vectors: bool, timer: PhaseTimer, mixed: bool,
                  mesh=None):
    reps, lam, Q = _eigenvalues(d, e, plan, config, timer, mesh)
    if not want_vectors:
        return lam, None
    cols = sel if sel is not None else torch.arange(plan.n, device=d.device)
    sub = PhaseTimer(timer.device)
    with timer.phase("backtransformation"):
        V = _backtransform(reps, Q, d, e, lam, cols, plan, config, mixed,
                           sub, mesh=mesh)
    timer.times.update({f"bt.{k}": v for k, v in sub.times.items()})
    timer.counts.update(sub.counts)
    return lam, V


def _solve(d, e, sel, plan: TreePlan, config: SolverConfig,
           want_vectors: bool, timer: PhaseTimer, mixed: bool = False,
           mesh=None):
    d, e, snorm = _prescale(d, e)
    lam, V = _solve_scaled(d, e, sel, plan, config, want_vectors, timer,
                           mixed, mesh)
    return lam * snorm, V


def _run_device(config: SolverConfig, device, mesh) -> torch.device:
    """The device an entry point runs on: ``device``, else the mesh's lead
    device, else ``config.device``; a ``device`` other than the mesh's
    lead raises."""
    if mesh is None:
        return resolve_device(device if device is not None
                              else config.device)
    dev = None if device is None else resolve_device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev != mesh.lead:
        raise ValueError(f"device={device!r} is not the mesh's lead device "
                         f"{mesh.lead}")
    return mesh.lead


def _inputs(d, e, config: SolverConfig, device, select, mesh=None):
    dev = _run_device(config, device, mesh)
    d = torch.as_tensor(d, dtype=config.dtype).to(dev)
    e = torch.as_tensor(e, dtype=config.dtype).to(dev)
    n = int(d.shape[0])
    if d.ndim != 1 or n < 1:
        raise ValueError("diagonal must be a non-empty 1-D array")
    if e.shape != (max(n - 1, 0),):
        raise ValueError(f"off-diagonal must have length n-1, got "
                         f"{tuple(e.shape)}")
    sel = None
    if select is not None:
        sel = torch.as_tensor(np.asarray(select, dtype=np.int64), device=dev)
        if sel.ndim != 1 or (sel.numel() and (int(sel.min()) < 0
                                              or int(sel.max()) >= n)):
            raise ValueError(f"select must be 1-D indices in [0, {n})")
    return d, e, sel


def _run_timer(timer: Optional[PhaseTimer], dev, mesh=None) -> PhaseTimer:
    """``timer`` (or a new one) syncing the run's device, or every device
    of ``mesh``, at the end of each phase."""
    if timer is None:
        timer = PhaseTimer()
    timer.device = dev if mesh is None else mesh.devices
    return timer


def solve_tridiagonal_staged(d, e, *, config: SolverConfig = DEFAULT_CONFIG,
                             compute_vectors: bool = False, select=None,
                             timer: Optional[PhaseTimer] = None,
                             device=None, mesh=None):
    """All eigenvalues (and optionally eigenvectors) of symmetric tridiagonal
    T with the eigenvalue phase and the backtransformation timed apart.

    Args:
      d: (n,) diagonal.  e: (n-1,) off-diagonal.  numpy arrays or tensors.
      compute_vectors: compute all eigenvectors.
      select: optional 0-based indices (ascending eigenvalue order) of the
        eigenvectors to compute.
      timer: a PhaseTimer to record "eigenvalues" / "backtransformation".
      device: "cuda" or "cpu" (default: ``config.device``, or the mesh's
        lead device).  CUDA without a card raises; nothing falls back to
        the CPU.
      mesh: optional ``dist.mesh.Mesh`` for multi-device execution: the
        upsweep's levels sharded by merge or by slot, the downsweep by
        column, the refinement on the lead device, where the results
        are; ``device`` may only name that device.  Every process of a
        multi-process mesh gets the whole result.

    Returns ``(EighTridiagonalResult, timer)`` in ``config.dtype`` (f32
    mode: the eigenvalue phase in f32, its kernels on widened operands;
    the backtransform on the f64 mode's route, see :func:`_backtransform`).
    With ``config.mixed_precision_vectors`` (the default) the eigenvectors
    are swept down in f32 and refined in f64 (the timer then also holds
    the backtransform's steps as "bt.<step>" and the triage's column counts
    in ``counts``);
    otherwise the sweep runs in f64.  Mixed solves with n <= 8192 take
    the fused route when ``FUSED_BT_OVERRIDE`` opens
    :func:`_fused_bt_enabled` ("bt.fused_bt" and the rescue and triage
    steps in the timer).  When the mixed path's f32 downsweep
    output and f64 copy (12*n*C bytes, C the selected columns) would pass
    :func:`_grouped_bt_bytes`, the downsweep and the first refinement pass
    run per column group ("bt.downsweep_refine_grouped").
    """
    want_vectors = compute_vectors or (select is not None)
    d, e, sel = _inputs(d, e, config, device, select, mesh)
    n = int(d.shape[0])
    plan = build_plan(n, config.resolved_leaf_size(n), config.max_leaves)
    timer = _run_timer(timer, d.device, mesh)
    lam, V = _solve(d, e, sel, plan, config, want_vectors, timer,
                    mixed=config.mixed_precision_vectors, mesh=mesh)
    return EighTridiagonalResult(eigenvalues=lam, eigenvectors=V), timer


def solve_tridiagonal_streamed(d, e, *, config: SolverConfig = DEFAULT_CONFIG,
                               group: int = 4096, halo: int = 256,
                               timer: Optional[PhaseTimer] = None,
                               device=None):
    """All eigenpairs without ever holding the whole eigenvector basis: the
    eigenvalues once, then the eigenvector columns in halo'd windows, each
    window swept down, refined, and cut to the ``group`` columns it owns.

    A near-degenerate cluster that straddles an owned boundary lies inside
    both neighbouring windows (each carries ``halo`` columns a side), which
    orthonormalize the same columns the same way, so the owned halves stay
    mutually orthogonal; the tests and ``chip_smoke.py`` measure each
    block's Gram and its cross-Gram with the previous block.  One device by
    design (it takes no mesh: the mesh shards the resident solve).

    Returns ``(lam, blocks, timer)``: ``lam`` the (n,) ascending
    eigenvalues (as :func:`solve_tridiagonal_staged` returns them),
    ``blocks`` a generator of ``(col_start, V_owned)`` in order, V_owned an
    (n, <= group) tensor in ``config.dtype`` on the run's device holding
    eigenvector columns ``col_start : col_start + V_owned.shape[1]``.
    ``timer`` gets "eigenvalues" at the call and accumulates
    "backtransformation_streamed" as the blocks are drained (one device
    sync a block).  ``device`` as :func:`solve_tridiagonal_staged`."""
    d, e, _ = _inputs(d, e, config, device, None)
    n = int(d.shape[0])
    group = max(1, min(int(group), n))
    halo = max(0, int(halo))
    W = min(n, group + 2 * halo)
    plan = build_plan(n, config.resolved_leaf_size(n), config.max_leaves)
    timer = _run_timer(timer, d.device)
    d, e, snorm = _prescale(d, e)
    reps, lam, Q = _eigenvalues(d, e, plan, config, timer)

    def window(s):
        cols = torch.arange(s, s + W, device=d.device)
        # the windows never take the fused route (as the JAX package's)
        return _backtransform(reps, Q, d, e, lam, cols, plan, config,
                              config.mixed_precision_vectors, PhaseTimer(),
                              fused=False)

    def blocks():
        V_all = None
        for a in range(0, n, group):
            w = min(group, n - a)
            t0 = time.perf_counter()
            if W == n:      # one window covers every column: compute it once
                if V_all is None:
                    V_all = window(0)
                Vo = V_all[:, a:a + w].contiguous()
            else:
                s = min(max(a - halo, 0), n - W)
                Vo = window(s)[:, a - s:a - s + w].contiguous()
            sync(Vo)
            timer.times["backtransformation_streamed"] = (
                timer.times.get("backtransformation_streamed", 0.0)
                + time.perf_counter() - t0)
            yield a, Vo

    return lam * snorm, blocks(), timer


def solve_tridiagonal(d, e, *, config: SolverConfig = DEFAULT_CONFIG,
                      compute_vectors: bool = False, select=None,
                      device=None, mesh=None) -> EighTridiagonalResult:
    """All eigenvalues (and optionally eigenvectors) of symmetric tridiagonal
    T, eigenvectors from the f64 downsweep (as the JAX package's off-TPU
    single-jit path, whatever ``mixed_precision_vectors`` says), returned in
    ``config.dtype``.  Arguments as
    :func:`solve_tridiagonal_staged`."""
    d, e, sel = _inputs(d, e, config, device, select, mesh)
    n = int(d.shape[0])
    plan = build_plan(n, config.resolved_leaf_size(n), config.max_leaves)
    want_vectors = compute_vectors or (select is not None)
    lam, V = _solve(d, e, sel, plan, config, want_vectors,
                    _run_timer(None, d.device, mesh), mesh=mesh)
    return EighTridiagonalResult(eigenvalues=lam, eigenvectors=V)


def eigh_tridiagonal(d, e, *, config: SolverConfig = DEFAULT_CONFIG,
                     eigvals_only: bool = False, device=None, mesh=None):
    """scipy-style convenience wrapper: returns lam or (lam, V)."""
    res = solve_tridiagonal(d, e, config=config,
                            compute_vectors=not eigvals_only, device=device,
                            mesh=mesh)
    if eigvals_only:
        return res.eigenvalues
    return res.eigenvalues, res.eigenvectors


def _bucket_count(n: int) -> int:
    """Trailing-submatrix buckets of the dense reductions."""
    return 4 if n >= 8192 else 1


def eigh(A, *, config: SolverConfig = DEFAULT_CONFIG,
         eigvals_only: bool = False, panel: int = 32, band: int = 0,
         device=None, timer: Optional[PhaseTimer] = None, mesh=None):
    """Dense symmetric eigensolver: Householder tridiagonalization front end
    (kernels/tridiagonalize.py) + :func:`solve_tridiagonal_staged` (so
    ``config.mixed_precision_vectors`` decides how the tridiagonal
    eigenvectors are computed) + compact-WY backtransformation.  Returns lam
    or (lam, V) like ``torch.linalg.eigh``.

    ``band`` > 0 selects the two-stage front end instead (dense -> band by
    GEMM panels -> tridiagonal by wavefront bulge chasing,
    kernels/band_reduce.py), with eigenvectors back through Q1 Q2.

    A: (n, n) numpy array or tensor, symmetric (not checked); it is not
    modified.  ``device``: "cuda" or "cpu" (default ``config.device``); CUDA
    without a card raises.  ``timer`` records "dense.tridiagonalize" (or
    "dense.reduce_to_band" and "dense.band_to_tridiag"), the tridiagonal
    solve's "eigenvalues" and "backtransformation", and "dense.apply_q"
    (after "dense.apply_q2" on the two-stage path).  ``mesh``: passed to
    the tridiagonal solve (:func:`solve_tridiagonal_staged`); the
    reductions and the reflector backtransform run on its lead device.
    """
    dev = _run_device(config, device, mesh)
    A = torch.as_tensor(A, dtype=config.dtype).to(dev)
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] < 1:
        raise ValueError(f"A must be square and non-empty, got "
                         f"{tuple(A.shape)}")
    n = int(A.shape[0])
    band = int(band)
    timer = _run_timer(timer, dev, mesh)
    want_vectors = not eigvals_only
    vlog = None
    if band > 0:
        with timer.phase("dense.reduce_to_band"):
            B, Yt, taus = reduce_to_band(A, band, buckets=_bucket_count(n),
                                         want_reflectors=want_vectors)
        with timer.phase("dense.band_to_tridiag"):
            d, e, vlog = band_to_tridiag_wave(B, band, want_log=want_vectors)
            del B
    else:
        with timer.phase("dense.tridiagonalize"):
            d, e, Yt, taus = tridiagonalize(A, panel=panel,
                                            buckets=_bucket_count(n))
    del A       # a device copy of a host input is dead from here on
    res, _ = solve_tridiagonal_staged(d, e, config=config,
                                      compute_vectors=want_vectors,
                                      timer=timer, device=dev, mesh=mesh)
    if eigvals_only:
        return res.eigenvalues
    W = res.eigenvectors
    if band > 0:
        with timer.phase("dense.apply_q2"):
            W = apply_q2_wave_blocked(n, band, vlog, W)
        panel = band
    with timer.phase("dense.apply_q"):
        X = apply_q(Yt, taus, W, panel=panel)
    return res.eigenvalues, X


def eigh_banded(a_band, *, lower: bool = False,
                config: SolverConfig = DEFAULT_CONFIG,
                eigvals_only: bool = False, device=None,
                timer: Optional[PhaseTimer] = None, mesh=None):
    """All eigenpairs of a real symmetric BANDED matrix, from LAPACK-style
    band storage (``scipy.linalg.eig_banded`` conventions).

    Args:
      a_band: (u+1, n) band storage of the symmetric matrix A with u
        off-diagonals.  Upper form (default): ``a_band[u + i - j, j] = A[i, j]``
        for ``max(0, j-u) <= i <= j``; lower form (``lower=True``):
        ``a_band[i - j, j] = A[i, j]`` for ``j <= i <= min(n-1, j+u)``.
        Entries outside the valid range are ignored.
      lower: which form ``a_band`` uses.
      eigvals_only: skip eigenvectors.
      device, timer, mesh: as :func:`eigh` (the chase is
        "dense.band_to_tridiag", the backtransform "dense.apply_q2").

    Returns ``lam`` or ``(lam, V)`` with eigenvalues ascending.

    u <= 1 routes straight to the tridiagonal solver.  u >= 2 runs the
    band -> tridiagonal WAVEFRONT bulge chase (kernels/band_reduce.py) on the
    matrix prescaled to max|A| = 1 and transforms eigenvectors back through
    the reflector log.
    """
    dev = _run_device(config, device, mesh)
    if isinstance(a_band, torch.Tensor):
        a_band = a_band.detach().cpu().numpy()
    a_band = np.asarray(a_band)
    if a_band.ndim != 2 or a_band.shape[0] < 1:
        raise ValueError("a_band must be a (u+1, n) band-storage array")
    u = int(a_band.shape[0]) - 1
    n = int(a_band.shape[1])
    if n == 0:
        raise ValueError("empty matrix")
    timer = _run_timer(timer, dev, mesh)
    want_vectors = not eigvals_only

    def diag_k(k):
        """Diagonal k >= 0: diag_k[j] = A[j, j+k] for j in [0, n-k)."""
        if lower:
            return a_band[k, : n - k]       # A[j+k, j]
        return a_band[u - k, k:]            # A[j, j+k] stored at col j+k

    if u == 0 or n == 1:
        diag = torch.as_tensor(np.array(diag_k(0)), dtype=config.dtype).to(dev)
        lam, order = torch.sort(diag)
        if eigvals_only:
            return lam
        return lam, torch.eye(n, dtype=config.dtype, device=dev)[:, order]

    if u == 1:
        res, _ = solve_tridiagonal_staged(
            np.array(diag_k(0)), np.array(diag_k(1)), config=config,
            compute_vectors=want_vectors, timer=timer, device=dev,
            mesh=mesh)
        if eigvals_only:
            return res.eigenvalues
        return res.eigenvalues, res.eigenvectors

    # densify (host-side, cheap relative to the chase) for the general case
    A = np.zeros((n, n), dtype=a_band.dtype)
    np.fill_diagonal(A, diag_k(0))
    for k in range(1, min(u, n - 1) + 1):
        idx = np.arange(n - k)
        A[idx, idx + k] = diag_k(k)
        A[idx + k, idx] = diag_k(k)
    B = torch.as_tensor(A, dtype=config.dtype).to(dev)
    # prescale to O(1): reflectors are scale-invariant
    s = torch.clamp(B.abs().max(), min=1e-30)
    with timer.phase("dense.band_to_tridiag"):
        d, e, vlog = band_to_tridiag_wave(B / s, u, want_log=want_vectors)
        del B
    res, _ = solve_tridiagonal_staged(d, e, config=config,
                                      compute_vectors=want_vectors,
                                      timer=timer, device=dev, mesh=mesh)
    if eigvals_only:
        return res.eigenvalues * s
    with timer.phase("dense.apply_q2"):
        V = apply_q2_wave_blocked(n, u, vlog, res.eigenvectors)
    return res.eigenvalues * s, V


def residuals(d, e, result: EighTridiagonalResult, select=None,
              chunk: int = 2048):
    """Per-eigenpair residual ||T v - lam v||, in column chunks.  ``d``/``e``
    are moved to the eigenvectors' device."""
    V = result.eigenvectors
    dev, dt = V.device, V.dtype
    d = torch.as_tensor(d, dtype=dt).to(dev)
    e = torch.as_tensor(e, dtype=dt).to(dev)
    lam = result.eigenvalues
    if select is not None:
        lam = lam[torch.as_tensor(np.asarray(select, dtype=np.int64),
                                  device=dev)]
    return sync(_residual_norms_chunked(d, e, lam, V, chunk))
