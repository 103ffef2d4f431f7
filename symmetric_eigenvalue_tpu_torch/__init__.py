"""symmetric_eigenvalue_tpu_torch: the PyTorch/CUDA port of the parallel
Cuppen divide-and-conquer eigensolver for real symmetric tridiagonal
matrices.

A second package beside ``symmetric_eigenvalue_tpu`` (the JAX reference):
the same tearing, batched leaf solves, per-level k-batched secular merges and
top-down eigenvector sweep, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``csrc/``, built by ``nvcc`` at first
use).  This package imports torch, numpy and the standard library only.

Covered so far: all eigenvalues, and eigenvectors through the default
mixed-precision path (f32 downsweep + f64 refinement) or in pure f64
(``SolverConfig(mixed_precision_vectors=False)``).  Entry points run on the
device ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

from .config import DEFAULT_CONFIG, SolverConfig
from .core.tridiag import (
    create_matrix_scheme1,
    create_matrix_scheme2,
    eigenvalues_of_scheme2,
    residual_norms,
    tridiag_matvec,
)
from .driver import (
    EighTridiagonalResult,
    eigh_tridiagonal,
    residuals,
    solve_tridiagonal,
    solve_tridiagonal_staged,
)

__all__ = [
    "DEFAULT_CONFIG",
    "SolverConfig",
    "EighTridiagonalResult",
    "create_matrix_scheme1",
    "create_matrix_scheme2",
    "eigenvalues_of_scheme2",
    "eigh_tridiagonal",
    "residual_norms",
    "residuals",
    "solve_tridiagonal",
    "solve_tridiagonal_staged",
    "tridiag_matvec",
]

__version__ = "0.1.0"
