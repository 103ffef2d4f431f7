"""Eigenvector assembly from a MergeRep: U application and row propagation.

Port of ``symmetric_eigenvalue_tpu/kernels/assemble.py``.  U is never
stored: it is rematerialized from the compact MergeRep and consumed at once.
f64 vectors go through row blocks generated in PyTorch and the
``dword_matmul`` GEMM; f32 vectors (the mixed-precision downsweep) go
through the fused ``cauchy_matmul`` kernel, and the f32 root U through
``cauchy_materialize``.  Every function takes a level's k-batched MergeRep.

Coordinate convention: ``U[j, i]`` with rows j = pole coordinates (original
concat-of-children order after ``p12`` inversion) and columns i = eigenvalues
in ascending order (via ``colperm``).

Rotation replays: rotations within one wave of the deflation tree touch
disjoint rows.  The downsweep's replay (``_apply_u_finish``) and
``rows_through_merge``'s transposed replay are the two launch forms of the
``rotation_replay`` kernel on CUDA (``rotation_replay``,
``rotation_replay_t``), which read the rotation log on the device; on the
CPU the waves are planned on the host from the log and each wave is one
gather / rotate / scatter; both rows of a rotation are read before either
is written.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .cauchy_matmul import cauchy_materialize, cauchy_matmul
from .cauchy_rowsum import cauchy_rowsum
from .dword_matmul import dword_matmul
from .rotation_replay import Wave, rotation_replay, rotation_replay_t
from .secular import MergeRep, inverse_permutation, map_slot_blocks


def _gather_rows(X, perm):
    """X (k, m, C) with rows permuted per merge: out[b, j] = X[b, perm[b, j]]."""
    k, m, C = X.shape
    off = torch.arange(k, device=X.device)[:, None] * m
    return X.reshape(k * m, C).index_select(0, (perm + off).reshape(-1)) \
        .reshape(k, m, C)


def _denom_block(rep: MergeRep, rows, slots):
    """(k, |rows|, |slots|) of d_row - lam_slot = (d_row - d_shift) - tau.
    ``slots``: (k, S) slot indices per merge."""
    shift = rep.shift_idx.gather(1, slots)
    return ((rep.poles_sec[:, rows][:, :, None]
             - rep.poles_sec.gather(1, shift)[:, None, :])
            - rep.tau.gather(1, slots)[:, None, :])


def _apply_u_finish(rep: MergeRep, y, waves):
    """Inverse-rotation replay on rows (``rotation_replay``, in place; y is
    a fresh contiguous product), then un-permute to original order."""
    yf = rotation_replay(rep, y, waves)
    return _gather_rows(yf, inverse_permutation(rep.p12))


def assemble_u(rep: MergeRep, cols: Optional[torch.Tensor] = None,
               block: int = 2048, waves: Optional[List[Wave]] = None,
               dtype: Optional[torch.dtype] = None):
    """Materialize U columns for every merge: (k, m, C) with rows in original
    order.  ``cols``: indices into the ascending eigenvalue order (None = all
    m).  ``dtype``: None (f64: rows produced in blocks of ``block``) or
    torch.float32 (the ``cauchy_materialize`` kernel: entries computed in
    f64, rounded once)."""
    k, m = rep.poles.shape
    dev = rep.poles.device
    slots = rep.colperm if cols is None else rep.colperm[:, cols]
    act = slots < rep.K[:, None]
    ncol = rep.colnorm.gather(1, slots)
    if dtype == torch.float32:
        shift_sel = rep.poles_sec.gather(1, rep.shift_idx.gather(1, slots))
        ninv_sel = torch.where(act, 1.0 / ncol, torch.zeros_like(ncol))
        u = cauchy_materialize(rep.poles_sec, rep.zhat, shift_sel,
                               rep.tau.gather(1, slots), ninv_sel,
                               slots.contiguous(), rep.K)
        return _apply_u_finish(rep, u, waves)
    if dtype not in (None, torch.float64):
        raise ValueError(f"assemble_u: dtype must be float32 or float64, "
                         f"got {dtype}")

    def row_block(rows):
        denom = _denom_block(rep, rows, slots)
        u = rep.zhat[:, rows][:, :, None] / denom / ncol[:, None, :]
        eye_cols = rows[None, :, None] == slots[:, None, :]
        return torch.where(act[:, None, :], u, eye_cols.to(u.dtype))

    u = map_slot_blocks(row_block, m, block, dev)
    return _apply_u_finish(rep, u, waves)


def _apply_u_matmul(rep: MergeRep, X, block: int):
    """Phase A of apply_u: Y0 = [[Ua, 0],[0, I]] P_col X (partitioned rows),
    X (k, m, C).  f64 X: row blocks of the Cauchy factor generated in f64
    and multiplied by the ``dword_matmul`` GEMM.  f32 X: the fused
    ``cauchy_matmul`` kernel, contracting only each merge's own K active
    slots."""
    k, m = rep.poles.shape
    dev = rep.poles.device
    Xs = _gather_rows(X, inverse_permutation(rep.colperm))
    slots = torch.arange(m, device=dev).expand(k, m)
    act = slots < rep.K[:, None]
    ncol_inv = torch.where(act, 1.0 / rep.colnorm,
                           torch.zeros_like(rep.colnorm))
    if X.dtype == torch.float32:
        shift_val = rep.poles_sec.gather(1, rep.shift_idx)
        y = cauchy_matmul(rep.poles_sec, shift_val, rep.tau, rep.zhat,
                          ncol_inv, Xs, rep.K)
        # inactive columns are e_slot: identity passthrough on inactive rows
        return y.add_(torch.where((~act)[:, :, None], Xs,
                                  torch.zeros((), dtype=y.dtype, device=dev)))
    if X.dtype != torch.float64:
        raise TypeError(f"apply_u: X must be float32 or float64, got "
                        f"{X.dtype}")

    def row_block(rows):
        denom = _denom_block(rep, rows, slots)
        Mb = (rep.zhat[:, rows][:, :, None] / denom) * ncol_inv[:, None, :]
        yb = dword_matmul(Mb, Xs)
        # inactive columns are e_slot: identity passthrough on inactive rows
        passthrough = (rows[None, :] >= rep.K[:, None])[:, :, None]
        return yb + torch.where(passthrough, Xs[:, rows],
                                torch.zeros((), dtype=yb.dtype, device=dev))

    return map_slot_blocks(row_block, m, block, dev)


def apply_u_level(reps: MergeRep, X, block: int = 2048,
                  waves: Optional[List[Wave]] = None):
    """Y = U X for every merge of a level without materializing U:
    reps (k-batched), X (k, m, C) with rows in each merge's ascending
    eigenvalue order; returns (k, m, C) with rows in original order.

    U factorizes as P_row^-1 R [[Ua, 0], [0, I]] P_col: permute, one GEMM per
    row block, rotations on rows, un-permute.  ``waves``: the level's
    :func:`rotation_waves`, when the caller already planned them."""
    return _apply_u_finish(reps, _apply_u_matmul(reps, X, block), waves)


def apply_u(rep: MergeRep, X, block: int = 2048):
    """Y = U X for a single merge (k == 1): X (m, C) -> (m, C)."""
    if rep.poles.shape[0] != 1:
        raise ValueError("apply_u takes a single merge; use apply_u_level")
    return apply_u_level(rep, X[None], block)[0]


def rows_through_merge(rep: MergeRep, w,
                       waves: Optional[List[Wave]] = None):
    """y = w @ (R U_slot) with output columns in ascending-eigenvalue order.

    ``w``: (k, r, m) rows in original coordinates, r <= 2.  Used on the
    upsweep to push each subtree's first/last boundary rows through its
    merge at O(r K^2) cost without materializing U: the transposed Givens
    chain (``rotation_replay_t``: one kernel launch on CUDA, which reads the
    log on the card, so the level makes no host sync; ``waves``: the level's
    :func:`rotation_waves` on the CPU, when the caller planned them), then
    the Cauchy sums through the ``cauchy_rowsum`` kernel, cut at each
    merge's K (wz is 0 past it, and only the columns below it are kept)."""
    k, r, m = w.shape
    with torch.profiler.record_function("merge.rows_through_merge"):
        p12 = rep.p12[:, None, :].expand(k, r, m)
        wt = w.gather(2, p12).transpose(1, 2).contiguous()
        wp = rotation_replay_t(rep, wt, waves).transpose(1, 2)
        wz = (wp * rep.zhat[:, None, :]).contiguous()
        shift_val = rep.poles_sec.gather(1, rep.shift_idx)
        # f32 mode: the kernel takes f64 operands; S comes back in wz's dtype
        S = cauchy_rowsum(*(t.to(torch.float64) for t in (
            rep.poles_sec, shift_val, rep.tau, wz)), rep.K).to(wz.dtype)
        active = (torch.arange(m, device=w.device)[None, :]
                  < rep.K[:, None])[:, None, :]
        y = torch.where(active, S / rep.colnorm[:, None, :], wp)
        return y.gather(2, rep.colperm[:, None, :].expand(k, r, m))
