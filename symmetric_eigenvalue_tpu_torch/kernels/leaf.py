"""Batched leaf eigensolver.

Port of ``symmetric_eigenvalue_tpu/kernels/leaf.py``: one batched dense
symmetric eigendecomposition of all (P, b, b) leaf blocks.  b=1/2 use exact
closed forms; b>2 use batched ``torch.linalg.eigh`` (what the JAX package
uses off the TPU).  Pad slots carry large, well-separated sentinel diagonal
values so their eigenpairs are (sentinel, e_i) and sort last in each leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tree import TreePlan


def leaf_blocks(d_torn, e, plan: TreePlan, sentinels):
    """Build the (P, b, b) dense symmetric tridiagonal leaf blocks.

    ``sentinels``: (padded_n,) diagonal values used at pad slots.
    In-leaf off-diagonals exclude the torn boundary entries (they became betas).
    """
    P, b, n = plan.num_leaves, plan.leaf_pad, plan.n
    dev = d_torn.device
    rows = torch.as_tensor(plan.row_map(), device=dev)
    diag = sentinels.clone()
    diag[rows] = d_torn
    diag = diag.reshape(P, b)

    A = torch.zeros((P, b, b), dtype=d_torn.dtype, device=dev)
    ar = torch.arange(b, device=dev)
    A[:, ar, ar] = diag
    if b > 1:
        # static gather of in-leaf off-diagonal entries
        off_idx = np.zeros((P, b - 1), dtype=np.int64)
        off_mask = np.zeros((P, b - 1), dtype=bool)
        for i, (off, sz) in enumerate(zip(plan.leaf_offsets, plan.leaf_sizes)):
            cnt = max(sz - 1, 0)
            off_idx[i, :cnt] = off + np.arange(cnt)
            off_mask[i, :cnt] = True
        eg = e[torch.as_tensor(np.clip(off_idx, 0, max(n - 2, 0)), device=dev)]
        eg = torch.where(torch.as_tensor(off_mask, device=dev), eg,
                         torch.zeros_like(eg))
        ar1 = torch.arange(b - 1, device=dev)
        A[:, ar1, ar1 + 1] = eg
        A[:, ar1 + 1, ar1] = eg
    return A


def eigh2x2(A):
    """Exact batched eigendecomposition of symmetric 2x2 blocks (..., 2, 2).

    Closed-form and cancellation-free (lam2 - a evaluated as c^2/(h+r)).
    Returns ascending eigenvalues and an orthogonal Q with columns matching.
    """
    a = A[..., 0, 0]
    b = A[..., 1, 1]
    c = A[..., 0, 1]
    t = 0.5 * (a + b)
    h = 0.5 * (a - b)
    r = torch.hypot(h, c)
    lam1 = t - r
    lam2 = t + r
    # eigenvector of lam2: (c, lam2 - a) or (lam2 - b, c), choosing the
    # cancellation-free branch via (r - h)(r + h) = c^2
    hp = torch.abs(h) + r
    ratio = c / torch.where(hp > 0, hp, torch.ones_like(hp))
    ones = torch.ones_like(c)
    pos = h >= 0
    v2x = torch.where(pos, ones, ratio)
    v2y = torch.where(pos, ratio, ones)
    nrm = torch.hypot(v2x, v2y)
    v2x = v2x / nrm
    v2y = v2y / nrm
    # degenerate diagonal block (h == 0, c == 0): identity
    degen = r == 0
    v2x = torch.where(degen, torch.zeros_like(v2x), v2x)
    v2y = torch.where(degen, ones, v2y)
    # v1 orthogonal to v2
    v1x = -v2y
    v1y = v2x
    lam = torch.stack([lam1, lam2], dim=-1)
    Q = torch.stack([torch.stack([v1x, v2x], dim=-1),
                     torch.stack([v1y, v2y], dim=-1)], dim=-2)
    return lam, Q


def eigh1x1(A):
    """Trivial base case: pure secular recursion to scalar leaves."""
    lam = A[..., 0, 0]
    return lam[..., None], torch.ones_like(A)


def leaf_eigh_fn(leaf_pad: int):
    """Batched leaf eigensolver for a padded leaf size: closed forms for
    b=1/2, batched ``torch.linalg.eigh`` otherwise."""
    if leaf_pad == 1:
        return eigh1x1
    if leaf_pad == 2:
        return eigh2x2
    return torch.linalg.eigh


def solve_leaves(d_torn, e, plan: TreePlan, sentinels, eigh_fn=None):
    """Eigendecompose all leaves; return (lam (P,b), Q (P,b,b), first/last rows).

    ``first``/``last`` are the first/last *actual* rows of each leaf's Q — the
    only parts of Q the conquer phase needs.
    """
    A = leaf_blocks(d_torn, e, plan, sentinels)
    lam, Q = (eigh_fn or torch.linalg.eigh)(A)
    first = Q[:, 0, :]
    last_rows = torch.as_tensor(np.asarray(plan.leaf_sizes, dtype=np.int64) - 1,
                                device=A.device)
    last = Q[torch.arange(plan.num_leaves, device=A.device), last_rows, :]
    return lam, Q, first, last
