"""Blocked Householder tridiagonalization: dense symmetric -> (d, e, Vt, tau).

Port of ``symmetric_eigenvalue_tpu/kernels/tridiagonalize.py`` (its TPU
route): a LAPACK ``sytrd``/``latrd``-style panel algorithm.  The inner panel
loop reduces one column at a time against the panel's delayed-update
accumulators Vp/Wp, with one full matvec ``v @ As`` per Householder column
(:func:`dword_vecmat`); on CUDA the column step is two kernel launches
(``kernels/householder_panel.py``: the matvec, then the column's W row fused
with the next column's reflector), on the CPU the plain torch loop.  Each panel ends with one symmetric rank-2k
trailing update (:func:`dword_matmul_sub_`).  Eigenvectors are transformed
back in compact-WY form (``larft``/``larfb`` equivalents; the T factor is
the ``larft`` kernel on CUDA).

Layout, as in the JAX package: reflector k is ROW k of ``Vt``, full width,
zero at entries <= k and one at entry k+1, so ``Vt`` and ``taus`` compare
elementwise with the JAX package's.  PyTorch runs eagerly with dynamic
shapes, so inside the loops the known-zero parts are sliced away instead of
masked (the matvec streams only the rows below the pivot, a panel of
``apply_q`` touches only the rows its reflectors reach), and there is no pad
to tile sizes, no per-panel f32 split and no padded no-op column.  No step
of the column loop reads a value back to the host: the data-dependent
"already tridiagonal" branch is taken on the device.
"""

from __future__ import annotations

import torch

from .dword_matmul import dword_matmul, dword_matmul_sub_
# _householder is band_reduce's too (its panel QR imports it from here)
from .householder_panel import _householder, column_steps, larft  # noqa: F401


def _tridiagonalize_block(As, ncols: int, nb: int):
    """Run the blocked-Householder reduction over the FIRST ``ncols`` columns
    of the trailing symmetric submatrix ``As`` (m, m), updating ``As`` in
    place.

    Returns (Vtb (ncols, m) reflector rows in LOCAL coordinates, taus
    (ncols,), evec (ncols,)).  Reflector for local column j has zeros at
    entries <= j and unit at j+1, exactly the full-matrix convention shifted.
    The column step (:func:`householder_panel.column_steps`) is the kernels'
    on CUDA and the plain loop on the CPU.
    """
    m = As.shape[0]
    Vtb = As.new_zeros((ncols, m))
    te = As.new_zeros((ncols, 2))            # (tau, alpha) per column
    Wbuf = As.new_zeros((nb, m))             # panel W accumulators, rows
    step = column_steps(As, Vtb, Wbuf, te, nb)
    with step.context():
        for o in range(0, ncols, nb):
            cnt = min(nb, ncols - o)
            step.panel(o, cnt)
            Vp = Vtb[o:o + cnt]
            Wp = Wbuf[:cnt]
            # trailing symmetric rank-2k update, fused: As -= [V;W]^T [W;V],
            # subtracted inside the kernel (As is a strided view after the
            # first bucket)
            dword_matmul_sub_(As, torch.cat([Vp, Wp]).T.contiguous(),
                              torch.cat([Wp, Vp]))
    return Vtb, te[:, 0], te[:, 1]


def _bucket_cuts(n: int, nb: int, buckets: int):
    """Bucket boundaries on panel boundaries covering columns [0, n-1)."""
    buckets = max(1, min(int(buckets), (n - 1 + nb - 1) // nb))
    width = -((n - 1) // -buckets)            # ceil
    width = -(width // -nb) * nb              # round up to whole panels
    cuts = [0]
    while cuts[-1] + width < n - 1:
        cuts.append(cuts[-1] + width)
    cuts.append(n - 1)
    return cuts


def tridiagonalize(A, panel: int = 32, buckets: int = 1):
    """A (n, n) symmetric -> (d (n,), e (n-1,), Vt (n, n), tau (n,)).

    T = Q^T A Q with Q = H_0 H_1 ... H_{n-3};  H_k = I - tau_k v_k v_k^T where
    v_k = Vt[k, :] (reflectors stored as ROWS; zero at entries <= k, unit at
    entry k+1).  A is not modified (the reduction works on one copy).

    ``buckets``: split the column range into equal chunks, each processed on
    the shrunk trailing submatrix A[c0:, c0:] (a view: the kernels take its
    row stride), so the per-column matvec and the trailing update touch only
    the trailing block.  The result does not depend on ``buckets`` beyond
    rounding.
    """
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    if n == 1:
        return (A.diagonal().clone(), A.new_zeros((0,)), A.new_zeros((n, n)),
                A.new_zeros((n,)))
    nb = max(1, min(panel, n))
    cuts = _bucket_cuts(n, nb, buckets)

    d = A.new_zeros((n,))
    evec = A.new_zeros((n,))
    Vt = A.new_zeros((n, n))
    taus = A.new_zeros((n,))

    As = A.clone()
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        ncols = c1 - c0
        Vtb, tb, eb = _tridiagonalize_block(As, ncols, nb)
        Vt[c0:c1, c0:] = Vtb
        taus[c0:c1] = tb
        evec[c0:c1] = eb
        d[c0:c1] = As.diagonal()[:ncols]
        As = As[ncols:, ncols:]               # shrink to the next bucket
    # the last (n - cuts[-1]) columns are inside the final 1x1 tail
    d[cuts[-1]:] = As.diagonal()
    return d, evec[:n - 1], Vt, taus


def _larft(Vp, tau):
    """Forward compact-WY T factor: Q = I - V T V^T for one panel.

    Vp (nb, n): reflectors as rows with unit structure already baked in;
    T upper triangular (nb, nb):
    T[:k, k] = -tau_k T[:k, :k] (V^T v_k), T[k, k] = tau_k, from the Gram
    by :func:`larft` (one kernel launch on CUDA, the plain loop on the CPU).
    """
    G = dword_matmul(Vp, Vp.T.contiguous())   # (nb, nb) gram
    return larft(G, tau)


def apply_q(Vt, taus, X, panel: int = 32, transpose: bool = False):
    """Apply Q (or Q^T) to X (n, k) in compact-WY blocks; returns a new
    tensor.

    Q = H_0 H_1 ... with H_j from row j of Vt;  Q @ X applies panels in
    reverse order, Q^T @ X forward.  Used for eigenvector backtransformation:
    A = Q T Q^T, so dense eigenvectors are Q @ (tridiagonal eigenvectors).
    The reflectors of the panel at offset o are zero at entries <= o, so the
    panel updates only rows o+1.. of X.
    """
    n = Vt.shape[0]
    nb = max(1, min(panel, n))
    num_panels = (n - 1 + nb - 1) // nb
    X = X.clone()
    order = range(num_panels) if transpose else reversed(range(num_panels))
    for p in order:
        o = p * nb
        hi = min(o + nb, n)
        Vp = Vt[o:hi, o + 1:].contiguous()
        T = _larft(Vp, taus[o:hi])
        M = T.T if transpose else T
        Xs = X[o + 1:]
        # X <- (I - V M V^T) X; the outer products carry the O(n^2 nb) work
        dword_matmul_sub_(Xs, Vp.T.contiguous(), M @ dword_matmul(Vp, Xs))
    return X
