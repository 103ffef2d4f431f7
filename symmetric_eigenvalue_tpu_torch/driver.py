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
never holds the whole basis.  Not ported yet: the fused small-n
backtransform (the reference takes it on a TPU backend only); small
solves take the staged route.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import (DEFAULT_CONFIG, SolverConfig, resolve_device,
                     usable_device_bytes)
from .core.tearing import tear
from .core.tree import TreePlan, build_plan
from .core.tridiag import residual_norms
from .kernels import spike_solve
from .kernels.assemble import (apply_u_level, assemble_u, rotation_waves,
                               rows_through_merge)
from .kernels.band_reduce import (apply_q2_wave_blocked, band_to_tridiag_wave,
                                  reduce_to_band)
from .kernels.leaf import leaf_blocks, leaf_eigh_fn, solve_leaves
from .kernels.refine import inverse_iteration, orthonormalize_clusters
from .kernels.secular import merge_decompose
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


def _upsweep(d, e, plan: TreePlan, config: SolverConfig):
    """Tear, solve leaves, and run all merge levels bottom-up.

    Returns (reps, lam_top_sorted (padded_n,), Q_leaf)."""
    dev = d.device
    d_t, betas, thetas = tear(d, e, plan)
    A = leaf_blocks(d_t, e, plan, _sentinels(d, e, plan))
    lam, Q = leaf_eigh_fn(plan.leaf_pad)(A)
    last_rows = torch.as_tensor(
        np.asarray(plan.leaf_sizes, dtype=np.int64) - 1, device=dev)
    f = Q[:, 0, :]
    l = Q[torch.arange(plan.num_leaves, device=dev), last_rows, :]

    reps = []
    L = plan.num_levels
    kw = _merge_kwargs(config)
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
        rep = merge_decompose(lam2.reshape(k, m), z, rho, **kw)
        if li < L - 1:
            # propagate the subtree's first/last actual boundary rows
            zero = torch.zeros((k, h), dtype=d.dtype, device=dev)
            w = torch.stack([torch.cat([f2[:, 0, :], zero], dim=1),
                             torch.cat([zero, l2[:, 1, :]], dim=1)], dim=1)
            y = rows_through_merge(rep, w)
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
                      sel, dtype: torch.dtype = torch.float64):
    """W[:, sel] = BD(Q_leaf) BD(U_{L-1}) ... U_root[:, sel] in ``dtype``,
    one level at a time and in column chunks of ``config.vec_chunk``
    (columns are independent end to end).  Each step drops its input before
    the next, so a chunk keeps only X_in, X_out and one block live.

    dtype float32 (the mixed path): the root U through
    ``cauchy_materialize``, every other level through ``cauchy_matmul``,
    the leaf product in full f32."""
    n, C = plan.n, int(sel.shape[0])
    dev = Q_leaf.device
    block = config.block_size
    waves = [rotation_waves(rep) for rep in reps]
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
                              config: SolverConfig, subtimer: PhaseTimer):
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
    sync the JAX package needs between groups."""
    n = plan.n
    C = int(sel.shape[0])
    one_pass, _ = _refine_ops(d, e, n, config)
    g = _group_width(n, config, d.device)
    lam_sel = lam[sel]
    X = torch.empty((n, C), dtype=d.dtype, device=d.device)
    res_parts = []
    with subtimer.phase("downsweep_refine_grouped"):
        for o in range(0, C, g):
            Vg = downsweep_stepped(reps, Q, plan, config, sel[o:o + g],
                                   dtype=torch.float32)
            Xg, rg = one_pass(lam_sel[o:o + g], Vg, config.refine_block)
            del Vg
            X[:, o:o + g].copy_(Xg)
            del Xg
            res_parts.append(rg)
    if any(r is None for r in res_parts):
        return X, None
    return X, torch.cat(res_parts)


def _backtransform(reps, Q, d, e, lam, cols, plan: TreePlan,
                   config: SolverConfig, mixed: bool, sub: PhaseTimer):
    """Eigenvector columns ``cols`` of the prescaled system: the leaf's own
    vectors when there is no merge, the f64 downsweep, or (``mixed``) the
    f32 downsweep and the refinement epilogue, grouped when 12*n*C bytes
    pass :func:`_grouped_bt_bytes`.  ``sub`` gets the steps' times and the
    triage's counts."""
    n = plan.n
    if reps is None:
        return Q[0][:n, :n][:, cols]
    if not mixed:
        return downsweep_stepped(reps, Q, plan, config, cols)
    if 12.0 * n * int(cols.shape[0]) > _grouped_bt_bytes(d.device):
        V, res1_dev = _grouped_downsweep_refine(reps, Q, d, e, lam, cols,
                                                plan, config, sub)
        return _refine_vectors(d, e, lam, cols, V, config, subtimer=sub,
                               pass1_done=True, res1_dev=res1_dev)
    with sub.phase("downsweep"):
        V = downsweep_stepped(reps, Q, plan, config, cols,
                              dtype=torch.float32)
    return _refine_vectors(d, e, lam, cols, V, config, subtimer=sub)


def _prescale(d, e):
    """Global prescale to ||T||-ish ~ 1 (keeps every intermediate O(1))."""
    abs_e_max = torch.abs(e).max() if e.shape[0] > 0 else d.new_zeros(())
    snorm = torch.clamp(torch.abs(d).max() + 2.0 * abs_e_max, min=1e-30)
    return d / snorm, e / snorm, snorm


def _eigenvalues(d, e, plan: TreePlan, config: SolverConfig,
                 timer: PhaseTimer):
    """The timed eigenvalue phase: (reps or None, lam (n,), Q_leaf)."""
    with timer.phase("eigenvalues"):
        if plan.num_levels == 0:
            lam_flat, Q = _upsweep_leaf_only(d, e, plan)
            reps = None
        else:
            reps, lam_flat, Q = _upsweep(d, e, plan, config)
    return reps, lam_flat[:plan.n], Q


def _solve_scaled(d, e, sel, plan: TreePlan, config: SolverConfig,
                  want_vectors: bool, timer: PhaseTimer, mixed: bool):
    reps, lam, Q = _eigenvalues(d, e, plan, config, timer)
    if not want_vectors:
        return lam, None
    cols = sel if sel is not None else torch.arange(plan.n, device=d.device)
    sub = PhaseTimer(d.device)
    with timer.phase("backtransformation"):
        V = _backtransform(reps, Q, d, e, lam, cols, plan, config, mixed,
                           sub)
    timer.times.update({f"bt.{k}": v for k, v in sub.times.items()})
    timer.counts.update(sub.counts)
    return lam, V


def _solve(d, e, sel, plan: TreePlan, config: SolverConfig,
           want_vectors: bool, timer: PhaseTimer, mixed: bool = False):
    d, e, snorm = _prescale(d, e)
    lam, V = _solve_scaled(d, e, sel, plan, config, want_vectors, timer,
                           mixed)
    return lam * snorm, V


def _inputs(d, e, config: SolverConfig, device, select):
    dev = resolve_device(device if device is not None else config.device)
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


def _run_timer(timer: Optional[PhaseTimer], dev) -> PhaseTimer:
    if timer is None:
        timer = PhaseTimer(dev)
    timer.device = dev
    return timer


def solve_tridiagonal_staged(d, e, *, config: SolverConfig = DEFAULT_CONFIG,
                             compute_vectors: bool = False, select=None,
                             timer: Optional[PhaseTimer] = None,
                             device=None):
    """All eigenvalues (and optionally eigenvectors) of symmetric tridiagonal
    T with the eigenvalue phase and the backtransformation timed apart.

    Args:
      d: (n,) diagonal.  e: (n-1,) off-diagonal.  numpy arrays or tensors.
      compute_vectors: compute all eigenvectors.
      select: optional 0-based indices (ascending eigenvalue order) of the
        eigenvectors to compute.
      timer: a PhaseTimer to record "eigenvalues" / "backtransformation".
      device: "cuda" or "cpu" (default: ``config.device``).  CUDA without a
        card raises; nothing falls back to the CPU.

    Returns ``(EighTridiagonalResult, timer)``.  Eigenvectors are f64.  With
    ``config.mixed_precision_vectors`` (the default) they are swept down in
    f32 and refined in f64 (the timer then also holds the backtransform's
    steps as "bt.<step>" and the triage's column counts in ``counts``);
    otherwise the sweep runs in f64.  When the mixed path's f32 downsweep
    output and f64 copy (12*n*C bytes, C the selected columns) would pass
    :func:`_grouped_bt_bytes`, the downsweep and the first refinement pass
    run per column group ("bt.downsweep_refine_grouped").
    """
    want_vectors = compute_vectors or (select is not None)
    d, e, sel = _inputs(d, e, config, device, select)
    n = int(d.shape[0])
    plan = build_plan(n, config.resolved_leaf_size(n), config.max_leaves)
    timer = _run_timer(timer, d.device)
    lam, V = _solve(d, e, sel, plan, config, want_vectors, timer,
                    mixed=config.mixed_precision_vectors)
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
    design.

    Returns ``(lam, blocks, timer)``: ``lam`` the (n,) ascending
    eigenvalues (as :func:`solve_tridiagonal_staged` returns them),
    ``blocks`` a generator of ``(col_start, V_owned)`` in order, V_owned an
    (n, <= group) f64 tensor on the run's device holding eigenvector
    columns ``col_start : col_start + V_owned.shape[1]``.  ``timer`` gets
    "eigenvalues" at the call and accumulates "backtransformation_streamed"
    as the blocks are drained (one device sync a block).  ``device`` as
    :func:`solve_tridiagonal_staged`."""
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
        return _backtransform(reps, Q, d, e, lam, cols, plan, config,
                              config.mixed_precision_vectors, PhaseTimer())

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
                      device=None) -> EighTridiagonalResult:
    """All eigenvalues (and optionally eigenvectors) of symmetric tridiagonal
    T, eigenvectors in f64 (as the JAX package's off-TPU single-jit path,
    whatever ``mixed_precision_vectors`` says).  Arguments as
    :func:`solve_tridiagonal_staged`."""
    d, e, sel = _inputs(d, e, config, device, select)
    n = int(d.shape[0])
    plan = build_plan(n, config.resolved_leaf_size(n), config.max_leaves)
    want_vectors = compute_vectors or (select is not None)
    lam, V = _solve(d, e, sel, plan, config, want_vectors,
                    PhaseTimer(d.device))
    return EighTridiagonalResult(eigenvalues=lam, eigenvectors=V)


def eigh_tridiagonal(d, e, *, config: SolverConfig = DEFAULT_CONFIG,
                     eigvals_only: bool = False, device=None):
    """scipy-style convenience wrapper: returns lam or (lam, V)."""
    res = solve_tridiagonal(d, e, config=config,
                            compute_vectors=not eigvals_only, device=device)
    if eigvals_only:
        return res.eigenvalues
    return res.eigenvalues, res.eigenvectors


def _bucket_count(n: int) -> int:
    """Trailing-submatrix buckets of the dense reductions."""
    return 4 if n >= 8192 else 1


def eigh(A, *, config: SolverConfig = DEFAULT_CONFIG,
         eigvals_only: bool = False, panel: int = 32, band: int = 0,
         device=None, timer: Optional[PhaseTimer] = None):
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
    (after "dense.apply_q2" on the two-stage path).
    """
    dev = resolve_device(device if device is not None else config.device)
    A = torch.as_tensor(A, dtype=config.dtype).to(dev)
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] < 1:
        raise ValueError(f"A must be square and non-empty, got "
                         f"{tuple(A.shape)}")
    n = int(A.shape[0])
    band = int(band)
    timer = _run_timer(timer, dev)
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
                                      timer=timer, device=dev)
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
                timer: Optional[PhaseTimer] = None):
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
      device, timer: as :func:`eigh` (the chase is "dense.band_to_tridiag",
        the backtransform "dense.apply_q2").

    Returns ``lam`` or ``(lam, V)`` with eigenvalues ascending.

    u <= 1 routes straight to the tridiagonal solver.  u >= 2 runs the
    band -> tridiagonal WAVEFRONT bulge chase (kernels/band_reduce.py) on the
    matrix prescaled to max|A| = 1 and transforms eigenvectors back through
    the reflector log.
    """
    dev = resolve_device(device if device is not None else config.device)
    if isinstance(a_band, torch.Tensor):
        a_band = a_band.detach().cpu().numpy()
    a_band = np.asarray(a_band)
    if a_band.ndim != 2 or a_band.shape[0] < 1:
        raise ValueError("a_band must be a (u+1, n) band-storage array")
    u = int(a_band.shape[0]) - 1
    n = int(a_band.shape[1])
    if n == 0:
        raise ValueError("empty matrix")
    timer = _run_timer(timer, dev)
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
            compute_vectors=want_vectors, timer=timer, device=dev)
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
                                      timer=timer, device=dev)
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
