"""Divide phase: rank-one tearing of T into the leaf blocks.

Port of ``symmetric_eigenvalue_tpu/core/tearing.py``.  ``theta = sign(beta)``
(so ``rho = beta * theta = |beta| >= 0``), which makes the whole divide phase
one vectorized scatter over every split boundary of every level at once.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .tree import TreePlan


def tear(d, e, plan: TreePlan):
    """Modify D at every split boundary; return (d_torn, per-level betas/thetas).

    For each internal node with boundary row r (last actual row of its left
    subtree):  beta = E[r];  theta = sign(beta) (0 -> +1);
    D[r] -= theta*beta;  D[r+1] -= beta/theta.
    """
    betas: List[torch.Tensor] = []
    thetas: List[torch.Tensor] = []
    if plan.num_levels == 0:
        return d, betas, thetas

    all_rows = np.concatenate([np.asarray(lv.boundary_rows, dtype=np.int64)
                               for lv in plan.levels])
    rows = torch.as_tensor(all_rows, device=d.device)
    beta_all = e[rows]
    theta_all = torch.where(beta_all < 0, -1.0, 1.0).to(d.dtype)
    # boundary rows are distinct, so each index_add_ is a plain scatter-add;
    # the two run in the reference's order (rows first, then rows + 1)
    d = d.clone()
    d.index_add_(0, rows, -theta_all * beta_all)
    d.index_add_(0, rows + 1, -beta_all / theta_all)

    off = 0
    for lv in plan.levels:
        k = lv.num_merges
        betas.append(beta_all[off:off + k])
        thetas.append(theta_all[off:off + k])
        off += k
    return d, betas, thetas
