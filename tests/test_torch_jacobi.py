"""PyTorch port, batched Jacobi leaf solver: held against the JAX package's
``jacobi_eigh`` and ``numpy.linalg.eigh`` on the same blocks (CPU, f64):
eigenvalues to 1e-13 ||A||, V^T A V diagonal and V^T V = I to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import jacobi as jjac
from symmetric_eigenvalue_tpu_torch.core.tree import build_plan
from symmetric_eigenvalue_tpu_torch.kernels import jacobi as tjac
from symmetric_eigenvalue_tpu_torch.kernels import leaf as tleaf


def _blocks(rng, kind, P, b):
    A = rng.standard_normal((P, b, b))
    A = (A + A.transpose(0, 2, 1)) / 2
    if kind == "diagonal":
        A = A * np.eye(b)
    elif kind == "degenerate":
        # repeated eigenvalues: Q diag(1, 1, 2, 2, ...) Q^T
        Q = np.linalg.qr(rng.standard_normal((P, b, b)))[0]
        lam = np.repeat(np.arange(1, b // 2 + 2), 2)[:b].astype(float)
        A = (Q * lam[None, None, :]) @ Q.transpose(0, 2, 1)
        A = (A + A.transpose(0, 2, 1)) / 2
    elif kind == "ones":
        A = np.ones((P, b, b))
    elif kind == "graded":
        s = np.logspace(0, -6, b)
        A = A * s[None, :, None] * s[None, None, :]
    return A


def _check(A, lam, V):
    P, b, _ = A.shape
    norm = np.abs(A).sum(axis=2).max(axis=1)[:, None]
    ref = np.linalg.eigvalsh(A)
    assert np.all(np.abs(lam - ref) <= 1e-13 * np.maximum(norm, 1e-300))
    D = V.transpose(0, 2, 1) @ A @ V
    off = D - D * np.eye(b)
    assert np.abs(off).max() <= 1e-12 * max(norm.max(), 1.0)
    assert np.abs(V.transpose(0, 2, 1) @ V - np.eye(b)).max() <= 1e-12
    assert np.all(np.diff(lam, axis=1) >= 0)


@pytest.mark.parametrize("kind,P,b", [
    ("random", 6, 8), ("random", 3, 32), ("random", 4, 7), ("random", 2, 9),
    ("diagonal", 3, 8), ("degenerate", 3, 8), ("ones", 2, 9),
    ("graded", 3, 6), ("random", 5, 2), ("random", 5, 3)])
def test_jacobi_matches_jax_and_numpy(rng, kind, P, b):
    A = _blocks(rng, kind, P, b)
    before = A.copy()
    lam, V = tjac.jacobi_eigh(torch.as_tensor(A))
    assert np.array_equal(A, before)          # the input is not modified
    lam, V = lam.numpy(), V.numpy()
    _check(A, lam, V)
    lj, Vj = jjac.jacobi_eigh(jnp.asarray(A))
    norm = np.abs(A).sum(axis=2).max()
    assert np.abs(lam - np.asarray(lj)).max() <= 1e-13 * max(norm, 1.0)
    if kind in ("random", "graded"):
        # simple spectra: the vectors agree up to sign
        assert np.abs(np.abs(V) - np.abs(np.asarray(Vj))).max() <= 1e-9


def test_b1_is_trivial():
    A = torch.as_tensor([[[3.0]], [[-2.0]]])
    lam, V = tjac.jacobi_eigh(A)
    assert lam.tolist() == [[3.0], [-2.0]] and V.tolist() == [[[1.0]], [[1.0]]]


def test_round_robin_pairs_match_jax():
    for b in (2, 4, 8, 10):
        ours = tjac._round_robin_pairs(b)
        assert np.array_equal(ours, jjac._round_robin_pairs(b))
        # every pair exactly once, each round index-disjoint
        pairs = {tuple(p) for r in ours for p in r.T}
        assert len(pairs) == b * (b - 1) // 2
        assert all(len(set(r.ravel())) == b for r in ours)


@pytest.mark.parametrize("n", [12, 13])
def test_leaf_solve_through_jacobi(rng, n):
    """A single-leaf tridiagonal solve with ``eigh_fn=jacobi_eigh`` (even and
    odd leaf size) agrees with the default leaf solver and with numpy."""
    d = rng.standard_normal(n) * 3
    e = rng.standard_normal(n - 1)
    plan = build_plan(n, n)
    sent = torch.as_tensor(50.0 + np.arange(plan.padded_n))
    args = (torch.as_tensor(d), torch.as_tensor(e), plan, sent)
    lam, Q, first, last = tleaf.solve_leaves(*args, eigh_fn=tjac.jacobi_eigh)
    lam0, _, _, _ = tleaf.solve_leaves(*args)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    ref = np.linalg.eigvalsh(T)
    assert np.abs(lam.numpy()[0, :n] - ref).max() <= 1e-13 * np.abs(ref).max()
    assert np.abs(lam.numpy() - lam0.numpy()).max() <= 1e-12
    Qn = Q.numpy()[0, :n, :n]
    assert np.abs(T @ Qn - Qn * lam.numpy()[0, :n]).max() <= 1e-12 * \
        np.abs(ref).max()
    assert np.array_equal(first.numpy(), Q.numpy()[:, 0, :])
    assert np.array_equal(last.numpy(), Q.numpy()[:, n - 1, :])


def test_lapack_case_of_the_jax_tests(rng):
    """The (32, 24, 24) stack of the JAX package's own Jacobi test."""
    A = rng.standard_normal((32, 24, 24))
    A = A + A.transpose(0, 2, 1)
    lam, V = tjac.jacobi_eigh(torch.as_tensor(A))
    _check(A, lam.numpy(), V.numpy())
    lj, _ = jjac.jacobi_eigh(jnp.asarray(A))
    assert np.abs(lam.numpy() - np.asarray(lj)).max() <= 1e-12


def test_diagonal_and_degenerate_case_of_the_jax_tests():
    A = np.zeros((3, 8, 8))
    A[0] = np.eye(8) * 3
    A[1] = np.diag(np.arange(8.0))
    A[2] = np.eye(8) * 2
    A[2, 0, 1] = A[2, 1, 0] = 1e-14
    lam, V = tjac.jacobi_eigh(torch.as_tensor(A))
    lam, V = lam.numpy(), V.numpy()
    for i in range(3):
        assert np.abs(lam[i] - np.linalg.eigvalsh(A[i])).max() < 1e-13
        assert np.abs(V[i].T @ V[i] - np.eye(8)).max() < 1e-13
