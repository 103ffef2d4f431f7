"""Batched parallel Jacobi eigensolver for small symmetric blocks.

Port of ``symmetric_eigenvalue_tpu/kernels/jacobi.py``, the JAX package's
leaf solver on the TPU.  The port's default leaf solver is the batched
``torch.linalg.eigh`` (as the JAX package's is off the TPU); this one is
selectable through ``leaf.solve_leaves(eigh_fn=jacobi_eigh)``.

Rotation schedule: the pivot pairs follow the classic **round-robin
tournament** ordering: each of the b-1 rounds holds b/2 index-disjoint
rotations, so a whole round applies to all P blocks at once as a handful of
batched gathers/scatters: b-1 wave steps per sweep instead of b(b-1)/2.
Convergence is still quadratic (cyclic-by-rounds order is a valid cyclic
Jacobi ordering); the sweep loop exits when every block's off-diagonal mass
is negligible (one host read per sweep).
"""

from __future__ import annotations

import numpy as np
import torch


def _round_robin_pairs(b: int) -> np.ndarray:
    """(b-1, 2, b/2) int64: disjoint pivot pairs (i<j) per tournament round."""
    players = list(range(b))
    rounds = []
    for _ in range(b - 1):
        pairs = sorted(tuple(sorted((players[i], players[b - 1 - i])))
                       for i in range(b // 2))
        rounds.append(np.array(pairs, dtype=np.int64).T)   # (2, b/2)
        players = [players[0], players[-1]] + players[1:-1]
    return np.stack(rounds)


def jacobi_eigh(A, max_sweeps: int = 30, tol_factor: float = 1e-14):
    """Eigendecomposition of a (P, b, b) stack of symmetric matrices.

    Returns (lam (P, b) ascending, V (P, b, b)) with V columns the
    eigenvectors.  ``tol_factor`` scales the per-block Frobenius norm for the
    sweep-convergence test.  A is not modified.
    """
    P, b, _ = A.shape
    dev = A.device
    if b == 1:
        return A[..., 0], torch.ones_like(A)
    if b % 2:                      # odd leaf sizes: pad with a decoupled row
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
        # Gershgorin row-sum bound: every true eigenvalue satisfies
        # |lam| <= max_i sum_j |A_ij|, so the decoupled pad eigenvalue set
        # just above it always sorts last
        big = A.abs().sum(dim=2).amax(dim=1)
        A[:, b, b] = big * (1.0 + 1e-3) + 1.0
        lam, V = jacobi_eigh(A, max_sweeps, tol_factor)
        return lam[:, :b], V[:, :b, :b]

    rounds = torch.as_tensor(_round_robin_pairs(b), device=dev)
    A = A.clone()
    fro = torch.sqrt((A * A).sum(dim=(1, 2)))
    tol = tol_factor * torch.clamp(fro, min=1e-30)            # (P,)
    offmask = 1.0 - torch.eye(b, dtype=A.dtype, device=dev)

    def offdiag_sq(A):
        # direct masked sum: total-minus-diagonal would cancel to rounding
        # noise (~eps*||A||_F^2) and fake convergence at off ~ sqrt(eps)
        return (A * A * offmask).sum(dim=(1, 2))

    V = torch.eye(b, dtype=A.dtype, device=dev).expand(P, b, b).contiguous()
    pivot_floor = tol[:, None] * (0.1 / (b * b))
    for _ in range(max_sweeps):
        if not bool((offdiag_sq(A) > tol * tol).any()):
            break
        for r in range(b - 1):
            ii, jj = rounds[r, 0], rounds[r, 1]              # (b/2,) disjoint
            app = A[:, ii, ii]                               # (P, b/2)
            aqq = A[:, jj, jj]
            apq = A[:, ii, jj]
            # classic stable rotation: t = sign(theta)/(|theta| +
            # sqrt(theta^2+1)); negligible pivots are skipped (they
            # contribute < tol to the residual)
            do = apq.abs() > pivot_floor
            theta = (aqq - app) / (2.0 * torch.where(do, apq, 1.0))
            theta = torch.clamp(theta, -1e15, 1e15)
            t = torch.sign(theta) / (theta.abs()
                                     + torch.sqrt(theta * theta + 1.0))
            t = torch.where(theta == 0, 1.0, t)              # sign(0)=0 guard
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            c = torch.where(do, c, 1.0)
            s = torch.where(do, s, 0.0)
            # A <- G^T A G: all b/2 rotations of the round touch disjoint
            # rows/columns, so they apply as one batched gather/rotate/scatter
            cb, sb = c[:, :, None], s[:, :, None]            # (P, b/2, 1)
            row_i, row_j = A[:, ii, :], A[:, jj, :]          # (P, b/2, b)
            A[:, ii, :] = cb * row_i - sb * row_j
            A[:, jj, :] = sb * row_i + cb * row_j
            cc, sc = c[:, None, :], s[:, None, :]
            col_i, col_j = A[:, :, ii], A[:, :, jj]          # (P, b, b/2)
            A[:, :, ii] = cc * col_i - sc * col_j
            A[:, :, jj] = sc * col_i + cc * col_j
            # exact annihilation of the pivot elements
            A[:, ii, jj] = 0.0
            A[:, jj, ii] = 0.0
            v_i, v_j = V[:, :, ii], V[:, :, jj]
            V[:, :, ii] = cc * v_i - sc * v_j
            V[:, :, jj] = sc * v_i + cc * v_j

    lam = A.diagonal(dim1=1, dim2=2)
    order = torch.argsort(lam, dim=1)
    lam = torch.gather(lam, 1, order)
    V = torch.gather(V, 2, order[:, None, :].expand(P, b, b))
    return lam, V
