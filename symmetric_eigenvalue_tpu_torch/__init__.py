"""symmetric_eigenvalue_tpu_torch: the PyTorch/CUDA port of the parallel
Cuppen divide-and-conquer eigensolver for real symmetric tridiagonal
matrices.

A second package beside ``symmetric_eigenvalue_tpu`` (the JAX reference):
the same tearing, batched leaf solves, per-level k-batched secular merges and
top-down eigenvector sweep, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels for Hopper (``csrc/``, built by ``nvcc`` at first
use).  This package imports torch, numpy and the standard library only.

Covered so far: all eigenvalues of a tridiagonal matrix, and eigenvectors
through the default mixed-precision path (f32 downsweep + f64 refinement)
or in pure f64 (``SolverConfig(mixed_precision_vectors=False)``), at
sizes whose basis crowds the card through the grouped route (the downsweep
and the first refinement pass per column group, switched on by the
solve's own size) or the streamed one (``solve_tridiagonal_streamed``:
eigenvector columns in halo'd windows, never the whole basis); dense
symmetric input (``eigh``: one-stage Householder tridiagonalization, or the
two-stage band reduction with ``band > 0``) and banded input in LAPACK band
storage (``eigh_banded``), with eigenvectors transformed back through the
reflectors; the batched Jacobi leaf solver (``kernels.jacobi.jacobi_eigh``,
selectable in ``leaf.solve_leaves``); float32 mode
(``SolverConfig(dtype=torch.float32)``, its kernel operands widened to
f64); host IO (``io``: Matrix Market through the port's own C parser,
selection and result files) and the ``cuppen`` CLI (``python -m
symmetric_eigenvalue_tpu_torch``, ``cli.py``); the fused small-n
backtransform (n <= 8192, opened by ``driver.FUSED_BT_OVERRIDE``: the
downsweep and the first refinement pass as one CUDA graph replay); the
multi-device mesh (``mesh=`` on every solving entry point, a mesh from
``symmetric_eigenvalue_tpu_torch.dist.mesh.make_mesh`` as in the JAX
package, ``distributed_init`` for several processes, and the CLI's
``--devices`` and multi-process flags): the upsweep's levels sharded by
merge or by slot, the downsweep by column, the refinement on the lead
device.  Every Pallas kernel of the JAX
package has its CUDA counterpart, and so do five of its device loops:
the downsweep's Givens replay, the refinement's two scans (the Spike
interface solve and the blocked solver's block LU), the dense
reduction's column step (one cooperative kernel launched three ways),
the compact-WY T factor, and the two-stage front end's wavefront bulge
chase (one cooperative launch a chase) and panel QR (one a panel) (ten
sources, eighteen kernels); the dense and banded front ends take float32 mode as
well (their reductions on an f64 copy).  Entry
points run on the device ``"cuda"`` unless the caller passes
``device="cpu"`` (or a mesh, which runs on its devices).
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
    eigh,
    eigh_banded,
    eigh_tridiagonal,
    residuals,
    solve_tridiagonal,
    solve_tridiagonal_staged,
    solve_tridiagonal_streamed,
)

__all__ = [
    "DEFAULT_CONFIG",
    "SolverConfig",
    "EighTridiagonalResult",
    "create_matrix_scheme1",
    "create_matrix_scheme2",
    "eigenvalues_of_scheme2",
    "eigh",
    "eigh_banded",
    "eigh_tridiagonal",
    "residual_norms",
    "residuals",
    "solve_tridiagonal",
    "solve_tridiagonal_staged",
    "solve_tridiagonal_streamed",
    "tridiag_matvec",
]

__version__ = "0.1.0"
