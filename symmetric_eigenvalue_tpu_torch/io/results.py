"""Result-file writer.

Port of the JAX package's ``io/results.py``, byte for byte the same
output.  Format parity with ``writeResults`` (filehandling.c:537,544): one
line per eigenvalue in ascending order, printed with C's ``%20.19g``; when
the eigenvector was computed, its residual ||T x_i - lambda_i x_i||_2
follows on the same line.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _fmt(x: float) -> str:
    return f"{x:20.19g}"


def write_results(path, eigenvalues, residual_values=None,
                  computed_indices: Optional[Sequence[int]] = None):
    """Write the output file.

    Args:
      eigenvalues: (n,) ascending.
      residual_values: per-computed-eigenvector residuals, aligned with
        ``computed_indices`` (or with all eigenvalues when indices is None).
      computed_indices: which eigenvalue positions (0-based, ascending order)
        have computed eigenvectors; None with residuals given means "all".
    """
    lam = np.asarray(eigenvalues)
    n = lam.shape[0]
    res_at = {}
    if residual_values is not None:
        rv = np.asarray(residual_values)
        if computed_indices is None:
            computed_indices = range(n)
        for j, idx in enumerate(computed_indices):
            res_at[int(idx)] = rv[j]
    with open(path, "w") as f:
        for i in range(n):
            if i in res_at:
                f.write(f"{_fmt(lam[i])} {_fmt(res_at[i])}\n")
            else:
                f.write(f"{_fmt(lam[i])}\n")


def read_results(path):
    """Parse a results file back -> (eigenvalues, residuals-or-None list)."""
    lams, ress = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            lams.append(float(parts[0]))
            ress.append(float(parts[1]) if len(parts) > 1 else None)
    return np.asarray(lams), ress
