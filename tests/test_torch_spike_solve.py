"""PyTorch port, Spike solve on the CPU (the plain passes through
spike_refine) against the JAX package: its Pallas Spike kernels in
interpret mode and its XLA blocked solver, mirroring
tests/test_spike_solve.py.

Tolerances: solutions agree to 1e-11 of max|X| (same decomposition and
pivoting; the JAX kernels carry f32 pairs, ~2^-47); true residuals
||(T - lam) x - b|| <= 1e-12 max|x|; normalized near-singular solves have
residual <= 1e-11 ||T||."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import refine as jref
from symmetric_eigenvalue_tpu.kernels.pallas import spike_solve as jsp
from symmetric_eigenvalue_tpu_torch.kernels import refine as tref
from symmetric_eigenvalue_tpu_torch.kernels import spike_solve as tsp


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _system(rng, n, K, near_singular=False):
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) * 0.5
    if near_singular:
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        lam = np.linalg.eigvalsh(T)[rng.choice(n, K, replace=False)]
    else:
        lam = np.sort(rng.standard_normal(K)) * 2.0
    B = rng.standard_normal((n, K))
    B /= np.linalg.norm(B, axis=0, keepdims=True)
    return d, e, lam, B


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _residual(d, e, lam, B, X):
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    R = T @ X - X * lam[None, :] - B
    return np.max(np.abs(R)) / max(np.max(np.abs(X)), 1.0)


@pytest.mark.parametrize("n,K,nb", [(700, 16, 128), (1024, 40, 128),
                                    (500, 8, 96), (333, 8, 128)])
def test_matches_jax_solvers(rng, n, K, nb):
    """Unnormalized solve vs the JAX Pallas kernels (interpret) and the JAX
    XLA blocked solver; n=333 has decoupled pad rows."""
    d, e, lam, B = _system(rng, n, K)
    X = tsp.solve_shifted_tridiagonal_spike(*_t(d, e, lam, B), nb=nb).numpy()
    assert X.shape == (n, K) and X.dtype == np.float64
    assert _residual(d, e, lam, B, X) < 1e-12
    jargs = [jnp.asarray(a) for a in (d, e, lam, B)]
    Xb = np.asarray(jref.solve_shifted_tridiagonal_blocked(*jargs, nb=nb))
    assert np.abs(X - Xb).max() <= 1e-11 * np.abs(Xb).max()
    if n == 700:
        Xk = np.asarray(jsp.solve_shifted_tridiagonal_spike(
            *jargs, nb=nb, interpret=True))
        assert np.abs(X - Xk).max() <= 1e-11 * np.abs(Xk).max()


def test_near_singular_shifts(rng):
    """Shifts at eigenvalues (the inverse-iteration regime, clamped pivots):
    normalized columns are eigenvectors, the free estimate matches the
    measured residual, and the directions match the JAX kernels'."""
    n, K = 640, 8
    d, e, lam, B = _system(rng, n, K, near_singular=True)
    X, res = tsp.spike_refine(*_t(d, e, lam, B), nb=128)
    X, res = X.numpy(), res.numpy()
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    col_res = np.linalg.norm(T @ X - X * lam[None, :], axis=0)
    normT = np.max(np.abs(lam))
    assert np.max(col_res) < 1e-11 * normT
    assert np.all(np.abs(res - col_res) <= 1e-2 * np.maximum(col_res, 1e-18)
                  + 1e-15 * normT)
    assert np.max(np.abs(np.linalg.norm(X, axis=0) - 1.0)) < 1e-12
    Xj, resj = jsp.spike_refine(*(jnp.asarray(a) for a in (d, e, lam, B)),
                                nb=128, interpret=True)
    dots = np.abs(np.sum(X * np.asarray(Xj), axis=0))
    assert np.all(dots >= 1 - 1e-11)


def test_column_padding_and_f32_input(rng):
    """K not a multiple of any tile, V given as f32 (the downsweep's output,
    read without an f64 copy): same result as the f64 input."""
    n, K = 512, 40
    d, e, lam, B = _system(rng, n, K)
    B32 = B.astype(np.float32)
    X32, r32 = tsp.spike_refine(*_t(d, e, lam), torch.as_tensor(B32))
    X64, r64 = tsp.spike_refine(*_t(d, e, lam, B32.astype(np.float64)))
    assert X32.shape == (n, K)
    assert torch.equal(X32, X64)
    np.testing.assert_allclose(r32.numpy(), r64.numpy(), rtol=1e-12)
    Xu = tsp.solve_shifted_tridiagonal_spike(*_t(d, e, lam, B)).numpy()
    assert _residual(d, e, lam, B, Xu) < 1e-12


def test_chunked_matches_single(rng):
    """Multi-chunk processing (with a partial last chunk, one interface
    solve over all chunks) equals the single-chunk result."""
    n, K = 256, 2500
    d, e, lam, B = _system(rng, n, K)
    X1, r1 = tsp.spike_refine(*_t(d, e, lam, B), nb=128, chunk=4096)
    X2, r2 = tsp.spike_refine(*_t(d, e, lam, B), nb=128, chunk=1000)
    np.testing.assert_allclose(X1.numpy(), X2.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), rtol=1e-10, atol=0)


def test_clip_flags_residual_estimate(rng, monkeypatch):
    """A back substitution that hits the +-2^80 clip (lowered to 1e4 here)
    is not a solution: its estimate must be the 1e30 sentinel, as the JAX
    kernels report, and its output still finite unit vectors."""
    monkeypatch.setattr(tref, "_BIG", 1e4)
    monkeypatch.setattr(tsp, "_BIG", 1e4)
    monkeypatch.setattr(jsp, "_BIG", 1e4)
    n, K, nb = 384, 6, 48
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) * 0.5
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    w, Q = np.linalg.eigh(T)
    idx = np.linspace(10, n - 10, K).astype(int)
    lam = w[idx]
    B = Q[:, idx] + rng.standard_normal((n, K)) * 1e-8
    B /= np.linalg.norm(B, axis=0, keepdims=True)
    X, res = tsp.spike_refine(*_t(d, e, lam, B), nb=nb)
    assert np.all(res.numpy() >= 1e29), res
    X = X.numpy()
    assert np.all(np.isfinite(X))
    np.testing.assert_allclose(np.linalg.norm(X, axis=0), 1.0, atol=1e-9)
    _, resj = jsp.spike_refine(*(jnp.asarray(a) for a in (d, e, lam, B)),
                               nb=nb, interpret=True)
    assert np.all(np.asarray(resj) >= 1e29)


def test_passes_match_block_lu(rng):
    """Pass A's six boundary values and pass B's folded solve are exactly
    the block LU of refine._block_lu_solve, and together with the interface
    solve they reproduce the reconstruction of the blocked solver."""
    n, K, nb = 300, 5, 64
    d, e, lam, B = _system(rng, n, K)
    dt, et, lt, Bt = _t(d, e, lam, B)
    db, e_all, e_cross, ec_above, tiny = tref.band_prep(dt, et, nb)
    P = db.shape[0] // nb
    bnd = tsp.spike_pass_a(db, e_all, tiny, lt, Bt, nb)
    assert bnd.shape == (6, P, K)
    La, Fb = tsp._interface(bnd, e_cross, ec_above)
    X, mx = tsp.spike_pass_b(db, e_all, tiny, lt, Bt, nb, La, Fb, ec_above,
                             e_cross)
    assert X.shape == (P * nb, K) and mx.shape == (P, K)
    assert torch.equal(mx, X.view(P, nb, K).abs().amax(dim=1))
    Xb = tref.solve_shifted_tridiagonal_blocked(dt, et, lt, Bt, nb=nb)
    assert (X[:n] - Xb).abs().max() <= 1e-12 * Xb.abs().max()
    with pytest.raises(ValueError):
        tsp.spike_pass_a(db, e_all, tiny, lt, Bt[:, :3], nb)
    with pytest.raises(TypeError):
        tsp.spike_pass_a(db, e_all, tiny, lt, Bt.half(), nb)
