"""Tridiagonal matrix utilities: generators, mat-vec, residuals, oracles.

Port of ``symmetric_eigenvalue_tpu/core/tridiag.py`` (scheme 1/2 generators,
the analytic scheme-2 spectrum, the residual mat-vec, the dense oracle).
"""

from __future__ import annotations

import numpy as np
import torch


def create_matrix_scheme1(n: int, dtype=torch.float64, device="cpu"):
    """Tridiagonal [-1, d_i, -1] with d_i evenly spaced in [1, 100]."""
    if n == 1:
        return (torch.ones(1, dtype=dtype, device=device),
                torch.zeros(0, dtype=dtype, device=device))
    spacing = (100.0 - 1.0) / (n - 1)
    d = 1.0 + spacing * torch.arange(n, dtype=dtype, device=device)
    e = -torch.ones(n - 1, dtype=dtype, device=device)
    return d, e


def create_matrix_scheme2(n: int, dtype=torch.float64, device="cpu"):
    """Poisson matrix [-1, 2, -1]."""
    d = 2.0 * torch.ones(n, dtype=dtype, device=device)
    e = -torch.ones(max(n - 1, 0), dtype=dtype, device=device)
    return d, e


def eigenvalues_of_scheme2(n: int, dtype=np.float64) -> np.ndarray:
    """Analytic spectrum of the Poisson matrix: 2 + 2 cos(pi*i/(n+1)),
    i=1..n, returned ascending."""
    i = np.arange(1, n + 1, dtype=dtype)
    lam = 2.0 + 2.0 * np.cos(np.pi * i / (n + 1))
    return np.sort(lam)


def tridiag_matvec(d, e, x):
    """y = T @ x for symmetric tridiagonal T = (d, e); x may be (n,) or (n, k)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    y = d[:, None] * x
    if e.shape[0] > 0:
        y[:-1] += e[:, None] * x[1:]
        y[1:] += e[:, None] * x[:-1]
    return y[:, 0] if squeeze else y


def residual_norms(d, e, lam, vecs):
    """||T v_i - lam_i v_i||_2 per eigenpair (columns of ``vecs``)."""
    r = tridiag_matvec(d, e, vecs) - lam[None, :] * vecs
    return torch.linalg.vector_norm(r, dim=0)


def tridiag_norm_bound(d, e):
    """Cheap upper bound on ||T||_2 (Gershgorin / inf-norm)."""
    n = d.shape[0]
    if n == 1:
        return torch.abs(d[0])
    ea = torch.abs(e)
    row = torch.abs(d).clone()
    row[:-1] += ea
    row[1:] += ea
    return torch.max(row)


def dense_from_tridiag(d, e) -> np.ndarray:
    """Dense numpy matrix from (d, e) — test oracle helper.  Tensors are
    read through the host."""
    d = np.asarray(d.cpu() if isinstance(d, torch.Tensor) else d)
    e = np.asarray(e.cpu() if isinstance(e, torch.Tensor) else e)
    T = np.diag(d)
    if e.shape[0] > 0:
        T += np.diag(e, 1) + np.diag(e, -1)
    return T
