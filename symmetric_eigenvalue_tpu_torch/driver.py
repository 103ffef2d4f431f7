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

Not ported yet: the fused small-n backtransform, the grouped downsweep +
refine route for 12*n*C bytes above device memory, and the streamed route;
the plain staged path runs at every size.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SolverConfig, resolve_device
from .core.tearing import tear
from .core.tree import TreePlan, build_plan
from .core.tridiag import residual_norms
from .kernels import spike_solve
from .kernels.assemble import (apply_u_level, assemble_u, rotation_waves,
                               rows_through_merge)
from .kernels.leaf import leaf_blocks, leaf_eigh_fn, solve_leaves
from .kernels.refine import inverse_iteration, orthonormalize_clusters
from .kernels.secular import merge_decompose
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
                    subtimer: Optional[PhaseTimer] = None):
    """Mixed-precision epilogue on the prescaled system (d, e, lam all
    divided by the same norm): one f64 inverse-iteration pass restores
    working-precision residuals from the f32 downsweep; segments of close
    eigenvalues are re-orthonormalized (dstein-style) before residual
    triage and once more at the end.

    ``subtimer`` records the step walls ("refine_pass1", "ortho_mid",
    "residuals1", "refine_extra", "refine_rescue", "ortho_final") and the
    triage's column counts; with a device it syncs after each step."""
    subtimer = subtimer if subtimer is not None else PhaseTimer()
    lam_sel = lam[sel]
    C = int(sel.shape[0])
    n = int(d.shape[0])
    one_pass, residuals_chunked = _refine_ops(d, e, n, config)

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


def _prescale(d, e):
    """Global prescale to ||T||-ish ~ 1 (keeps every intermediate O(1))."""
    abs_e_max = torch.abs(e).max() if e.shape[0] > 0 else d.new_zeros(())
    snorm = torch.clamp(torch.abs(d).max() + 2.0 * abs_e_max, min=1e-30)
    return d / snorm, e / snorm, snorm


def _solve_scaled(d, e, sel, plan: TreePlan, config: SolverConfig,
                  want_vectors: bool, timer: PhaseTimer, mixed: bool):
    n = plan.n
    with timer.phase("eigenvalues"):
        if plan.num_levels == 0:
            lam_flat, Q = _upsweep_leaf_only(d, e, plan)
            reps = None
        else:
            reps, lam_flat, Q = _upsweep(d, e, plan, config)
        lam = lam_flat[:n]
    if not want_vectors:
        return lam, None
    cols = sel if sel is not None else torch.arange(n, device=d.device)
    with timer.phase("backtransformation"):
        if reps is None:
            V = Q[0][:n, :n][:, cols]
        elif not mixed:
            V = downsweep_stepped(reps, Q, plan, config, cols)
        else:
            sub = PhaseTimer(d.device)
            with sub.phase("downsweep"):
                V = downsweep_stepped(reps, Q, plan, config, cols,
                                      dtype=torch.float32)
            V = _refine_vectors(d, e, lam, cols, V, config, subtimer=sub)
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
    otherwise the sweep runs in f64.
    """
    want_vectors = compute_vectors or (select is not None)
    d, e, sel = _inputs(d, e, config, device, select)
    n = int(d.shape[0])
    plan = build_plan(n, config.resolved_leaf_size(n), config.max_leaves)
    if timer is None:
        timer = PhaseTimer(d.device)
    timer.device = d.device
    lam, V = _solve(d, e, sel, plan, config, want_vectors, timer,
                    mixed=config.mixed_precision_vectors)
    return EighTridiagonalResult(eigenvalues=lam, eigenvectors=V), timer


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
