"""Solver driver: divide -> batched leaf solve -> batched conquer -> downsweep.

Port of ``symmetric_eigenvalue_tpu/driver.py`` for full eigenpairs in pure
f64.  Each tree level's merges run together as one k-batched merge; the
eigenvectors come from a top-down sweep

    W[:, sel] = BD(Q_leaf) BD(U_{L-1}) ... U_root[:, sel]

with each level's U rematerialized from its compact MergeRep, in column
chunks of ``config.vec_chunk`` so only a chunk's buffers are live.
Everything runs on the device the caller names; a CUDA run goes through the
hand-written kernels and never through their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SolverConfig, resolve_device
from .core.tearing import tear
from .core.tree import TreePlan, build_plan
from .core.tridiag import residual_norms
from .kernels.assemble import (apply_u_level, assemble_u, rotation_waves,
                               rows_through_merge)
from .kernels.leaf import leaf_blocks, leaf_eigh_fn, solve_leaves
from .kernels.secular import merge_decompose
from .utils.timing import PhaseTimer, sync

_NEXT_SLICE = ("mixed_precision_vectors=True (f32 downsweep + f64 refinement) "
               "is the next slice of the PyTorch port; pass "
               "SolverConfig(mixed_precision_vectors=False)")


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


def downsweep_stepped(reps, Q_leaf, plan: TreePlan, config: SolverConfig,
                      sel):
    """W[:, sel] = BD(Q_leaf) BD(U_{L-1}) ... U_root[:, sel], one level at a
    time and in column chunks of ``config.vec_chunk`` (columns are
    independent end to end).  Each step drops its input before the next, so
    a chunk keeps only X_in, X_out and one GEMM block live."""
    n, C = plan.n, int(sel.shape[0])
    dev = Q_leaf.device
    block = config.block_size
    waves = [rotation_waves(rep) for rep in reps]
    row_map = torch.as_tensor(plan.row_map(), device=dev)
    V = torch.empty((n, C), dtype=Q_leaf.dtype, device=dev)
    chunk = max(1, config.vec_chunk)
    for o in range(0, C, chunk):
        cols = sel[o:o + chunk]
        w = int(cols.shape[0])
        X = assemble_u(reps[-1], cols=cols, block=block, waves=waves[-1])
        for li in range(plan.num_levels - 2, -1, -1):
            lv = plan.levels[li]
            X = apply_u_level(reps[li], X.reshape(lv.num_merges,
                                                  lv.merge_size, w),
                              block=block, waves=waves[li])
        X = torch.bmm(Q_leaf, X.reshape(plan.num_leaves, plan.leaf_pad, w))
        V[:, o:o + w] = X.reshape(plan.padded_n, w).index_select(0, row_map)
        del X
    return V


def _prescale(d, e):
    """Global prescale to ||T||-ish ~ 1 (keeps every intermediate O(1))."""
    abs_e_max = torch.abs(e).max() if e.shape[0] > 0 else d.new_zeros(())
    snorm = torch.clamp(torch.abs(d).max() + 2.0 * abs_e_max, min=1e-30)
    return d / snorm, e / snorm, snorm


def _solve_scaled(d, e, sel, plan: TreePlan, config: SolverConfig,
                  want_vectors: bool, timer: PhaseTimer):
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
        else:
            V = downsweep_stepped(reps, Q, plan, config, cols)
    return lam, V


def _solve(d, e, sel, plan: TreePlan, config: SolverConfig,
           want_vectors: bool, timer: PhaseTimer):
    d, e, snorm = _prescale(d, e)
    lam, V = _solve_scaled(d, e, sel, plan, config, want_vectors, timer)
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

    Returns ``(EighTridiagonalResult, timer)``.  Eigenvectors come from the
    pure-f64 path: ``config.mixed_precision_vectors`` must be False when
    eigenvectors are requested (the mixed path is not ported yet).
    """
    want_vectors = compute_vectors or (select is not None)
    if want_vectors and config.mixed_precision_vectors:
        raise NotImplementedError(_NEXT_SLICE)
    d, e, sel = _inputs(d, e, config, device, select)
    n = int(d.shape[0])
    plan = build_plan(n, config.resolved_leaf_size(n), config.max_leaves)
    if timer is None:
        timer = PhaseTimer(d.device)
    timer.device = d.device
    lam, V = _solve(d, e, sel, plan, config, want_vectors, timer)
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
    out = torch.empty(V.shape[1], dtype=dt, device=dev)
    for o in range(0, V.shape[1], chunk):
        out[o:o + chunk] = residual_norms(d, e, lam[o:o + chunk],
                                          V[:, o:o + chunk])
    return sync(out)
