"""Solver configuration (PyTorch port).

Same fields and defaults as ``symmetric_eigenvalue_tpu.config.SolverConfig``
plus ``device``.  The GPU and the CPU both run IEEE float64, so the unit
roundoff is 2^-52 everywhere and the auto leaf size is the non-TPU rule (32).
``dtype=torch.float32`` (the CLI's ``--f32``) runs the eigenvalue phase in
f32 with the f32 unit roundoff; the kernels, which are f64-only as the JAX
package's, take its operands widened to f64, and results come back in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_IEEE_F64_EPS = 2.0 ** -52


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point; a CUDA request without CUDA raises
    (the solver never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def usable_device_bytes(device) -> float:
    """Device-memory budget for byte-budgeted chunk formulas: 0.9 of the
    card's free memory (``torch.cuda.mem_get_info``), or of 16 GB for the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return 0.9 * float(free)
    return 0.9 * 16e9


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static configuration for the Cuppen divide-and-conquer solver.

    Field meanings are those of the JAX package's ``SolverConfig``.
    ``mixed_precision_vectors=True`` (the default) makes
    ``solve_tridiagonal_staged`` sweep the eigenvectors down in f32 (the
    ``cauchy_matmul`` / ``cauchy_materialize`` kernels) and restore f64
    accuracy with the refinement epilogue: Spike inverse-iteration passes
    (``use_pallas_refine``: the Spike kernels for n >= 512, else the blocked
    solver; ``use_pallas_refine_extra``: the same for the risky columns'
    extra pass, False by default as in the JAX package, so that pass and
    the rescue pass run the blocked solver, whose block LU and interface
    solve are kernels on CUDA), residual triage and cluster CholeskyQR,
    steered by the ``refine_*`` and ``*_gap_factor`` fields.  ``solve_tridiagonal``
    always returns f64-path eigenvectors.  The dense and banded entry points
    (``eigh``, ``eigh_banded``) reduce to tridiagonal form and then call
    ``solve_tridiagonal_staged``, so ``mixed_precision_vectors`` decides
    for them too; the reflector backtransform is always f64.
    ``single_jit_max_n`` has no effect: there is no whole-solve compile, so
    no size limit routes between paths.

    ``device``: where the entry points run when the caller passes no
    ``device`` ("cuda" or "cpu").
    """

    leaf_size: Optional[int] = None
    max_leaves: Optional[int] = None
    dtype: torch.dtype = torch.float64
    unit_roundoff: Optional[float] = None
    deflation_factor: float = 8.0
    max_secular_iters: int = 60
    secular_tol_factor: float = 8.0
    use_gu_eisenstat: bool = True
    block_size: int = 2048
    vec_chunk: int = 8192
    refine_chunk: int = 2048
    refine_block: int = 128
    refine_block_alt: int = 96
    refine_block_rescue: int = 64
    refine_residual_factor: float = 50.0
    mixed_precision_vectors: bool = True
    refine_steps: int = 2
    use_pallas_refine: bool = True
    use_pallas_refine_extra: bool = False
    refine_risky_gap_factor: float = 100.0
    cluster_gap_factor: float = 1e-8
    ortho_gap_factor: float = 1e-6
    single_jit_max_n: Optional[int] = None
    device: str = "cuda"

    def resolved_refine_chunk(self, n: int, device) -> int:
        """Byte-budgeted refinement column chunk (peak ~12 n^2 + 200 n chunk
        bytes), floored at 256 and capped at ``refine_chunk``.  ``device``:
        where the run's tensors are (its memory is the budget)."""
        budget = usable_device_bytes(device) - 12.0 * float(n) * float(n)
        cols = int(budget / (200.0 * max(n, 1)))
        chunk = 256
        while chunk * 2 <= cols and chunk * 2 <= self.refine_chunk:
            chunk *= 2
        return min(chunk, self.refine_chunk)

    def eps(self) -> float:
        if self.unit_roundoff is not None:
            return float(self.unit_roundoff)
        if self.dtype == torch.float64:
            return _IEEE_F64_EPS
        return float(torch.finfo(self.dtype).eps)

    def resolved_leaf_size(self, n: Optional[int] = None) -> int:
        """Auto leaf size: 32 (batched LAPACK-class ``eigh`` leaves)."""
        if self.leaf_size is not None:
            return self.leaf_size
        return 32


DEFAULT_CONFIG = SolverConfig()
