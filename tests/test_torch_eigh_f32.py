"""PyTorch port, the dense and banded front ends in float32 mode
(``SolverConfig(dtype=torch.float32)``) on ``device="cpu"``, held against
the JAX package's float32 ``driver.eigh`` (one- and two-stage) and
``driver.eigh_banded`` on the same matrices.

The port runs its reductions and reflector backtransforms on an f64 copy
(their kernels are f64-only) and the tridiagonal solve in f32, and returns
float32, as the JAX package does.  Grades: the JAX package's float32 ones
(as the CLI's ``--f32`` is held): eigenvalues within 1e-4 ||A|| of the f64
spectrum and of the JAX package's, residuals within 1e-3 ||A||,
orthogonality within 1e-3; the JAX package's own results meet them too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu_torch.kernels import tridiagonalize as tri

CFG32 = st.SolverConfig(dtype=torch.float32, leaf_size=16)
JCFG32 = se.SolverConfig(dtype=jnp.float32, leaf_size=16)


def _sym(rng, n):
    A = rng.standard_normal((n, n)) * 2.0
    return (A + A.T) / 2


def _grades(A, lam, V, ref):
    lam = np.asarray(lam, np.float64)
    nA = max(np.abs(ref).max(), 1.0)
    out = {"eig": np.abs(lam - ref).max() / nA}
    if V is not None:
        V = np.asarray(V, np.float64)
        out["resid"] = np.abs(A @ V - V * lam[None, :]).max() / nA
        out["ortho"] = np.abs(V.T @ V - np.eye(A.shape[0])).max()
    return out


def _held(got, want):
    assert got["eig"] <= 1e-4 and want["eig"] <= 1e-4
    if "resid" in got:
        assert got["resid"] <= 1e-3 and want["resid"] <= 1e-3
        assert got["ortho"] <= 1e-3 and want["ortho"] <= 1e-3


def _band(A, u):
    n = A.shape[0]
    i = np.arange(n)
    Ab = np.where(np.abs(i[:, None] - i[None, :]) <= u, A, 0.0)
    ab = np.zeros((u + 1, n))
    for k in range(u + 1):
        ab[u - k, k:] = np.diagonal(Ab, offset=k)
    return Ab, ab


@pytest.mark.parametrize("n,band", [(96, 0), (80, 8)])
def test_eigh_float32_matches_jax(rng, n, band):
    A = _sym(rng, n)
    ref = np.linalg.eigvalsh(A)
    lam, V = st.eigh(A, config=CFG32, band=band, device="cpu")
    assert lam.dtype == V.dtype == torch.float32 and V.shape == (n, n)
    jlam, jV = se.driver.eigh(A, config=JCFG32, band=band)
    assert np.asarray(jlam).dtype == np.float32
    _held(_grades(A, lam.numpy(), V.numpy(), ref),
          _grades(A, jlam, jV, ref))
    assert np.abs(lam.numpy() - np.asarray(jlam, np.float64)).max() \
        <= 1e-4 * np.abs(ref).max()
    only = st.eigh(A, config=CFG32, band=band, eigvals_only=True,
                   device="cpu")
    assert only.dtype == torch.float32
    assert _grades(A, only.numpy(), None, ref)["eig"] <= 1e-4


def test_eigh_banded_float32_matches_jax(rng):
    n, u = 72, 6
    Ab, ab = _band(_sym(rng, n), u)
    ref = np.linalg.eigvalsh(Ab)
    lam, V = st.eigh_banded(ab, config=CFG32, device="cpu")
    assert lam.dtype == V.dtype == torch.float32 and V.shape == (n, n)
    jlam, jV = se.driver.eigh_banded(ab, config=JCFG32)
    _held(_grades(Ab, lam.numpy(), V.numpy(), ref),
          _grades(Ab, jlam, jV, ref))
    only = st.eigh_banded(ab, config=CFG32, eigvals_only=True, device="cpu")
    assert only.dtype == torch.float32
    assert _grades(Ab, only.numpy(), None, ref)["eig"] <= 1e-4


def test_float64_eigh_is_its_stages_bit_for_bit(rng):
    """Widening is the identity on f64 tensors: the f64 eigh is exactly
    tridiagonalize, the staged tridiagonal solve and apply_q run by hand,
    bit for bit, in f64."""
    n = 64
    A = _sym(rng, n)
    cfg = st.SolverConfig(leaf_size=16)
    lam, V = st.eigh(A, config=cfg, device="cpu")
    assert lam.dtype == V.dtype == torch.float64
    d, e, Vt, taus = tri.tridiagonalize(torch.as_tensor(A), panel=32)
    res, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                         compute_vectors=True, device="cpu")
    X = tri.apply_q(Vt, taus, res.eigenvectors, panel=32)
    assert torch.equal(lam, res.eigenvalues) and torch.equal(V, X)
