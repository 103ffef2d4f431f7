"""Self-check helpers: blocked f64 orthogonality measurement.

The Gram matrix is computed in row blocks through the ``dword_matmul`` GEMM
(the hand-written kernel on CUDA, ``torch.matmul`` on the CPU) and each
block's ``max |G - I|`` is folded on the device, so the extra memory is one
(row_chunk, n) block and one scalar per block reaches the host.
"""

from __future__ import annotations

import torch

from ..kernels.dword_matmul import dword_matmul


def max_ortho_error(V, row_chunk: int = 2048) -> float:
    """max |VᵀV - I| of an (n, C) eigenvector matrix, blocked over rows of
    the Gram."""
    C = V.shape[1]
    worst = torch.zeros((), dtype=V.dtype, device=V.device)
    for r0 in range(0, C, row_chunk):
        r1 = min(C, r0 + row_chunk)
        G = dword_matmul(V[:, r0:r1].T.contiguous(), V)
        G[:, r0:r1].diagonal().sub_(1.0)
        worst = torch.maximum(worst, G.abs().max())
    return float(worst)


def max_cross_ortho_error(Va, Vb, row_chunk: int = 2048) -> float:
    """max |Vaᵀ Vb| between two disjoint eigenvector column groups."""
    ga = Va.shape[1]
    worst = torch.zeros((), dtype=Va.dtype, device=Va.device)
    for r0 in range(0, ga, row_chunk):
        r1 = min(ga, r0 + row_chunk)
        G = dword_matmul(Va[:, r0:r1].T.contiguous(), Vb)
        worst = torch.maximum(worst, G.abs().max())
    return float(worst)
