"""PyTorch port, whole slice: solve_tridiagonal_staged (pure-f64
eigenpairs) and eigh_tridiagonal on the CPU against the JAX package.

Eigenvalues agree elementwise to 1e-13 ||T||.  Eigenvectors are free in
sign (and inside clusters), so they are held to residual <= 1e-12 ||T||,
orthogonality <= 1e-12, and |<v_port, v_jax>| >= 1 - 1e-10 for eigenvalues
separated from their neighbours by more than 1e-6 ||T||.
"""

import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu.core.tridiag import dense_from_tridiag


def _glued_wilkinson():
    k, copies = 10, 4
    dw = np.abs(np.arange(2 * k + 1) - k).astype(float)
    ew = np.ones(2 * k)
    d = np.concatenate([dw] * copies)
    e = np.concatenate(sum([[ew, [1e-8]] for _ in range(copies - 1)], [])
                       + [ew])
    return d, e


def _case(name, rng):
    if name == "random256":
        return rng.standard_normal(256) * 5, rng.standard_normal(255) * 2, 8
    if name == "ragged200":
        return rng.standard_normal(200) * 5, rng.standard_normal(199) * 2, 8
    if name == "scheme2_128":
        return 2.0 * np.ones(128), -np.ones(127), 16
    d, e = _glued_wilkinson()
    return d, e, 16


@pytest.mark.parametrize("name", ["random256", "ragged200", "scheme2_128",
                                  "glued_wilkinson"])
def test_matches_jax(name, rng):
    d, e, leaf = _case(name, rng)
    n = d.shape[0]
    lam_j, V_j = se.eigh_tridiagonal(d, e,
                                     config=se.SolverConfig(leaf_size=leaf))
    lam_j, V_j = np.asarray(lam_j), np.asarray(V_j)
    cfg = st.SolverConfig(leaf_size=leaf, mixed_precision_vectors=False)
    res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                             compute_vectors=True,
                                             device="cpu")
    assert set(timer.times) == {"eigenvalues", "backtransformation"}
    lam_e, V_e = st.eigh_tridiagonal(d, e, config=cfg, device="cpu")
    T = dense_from_tridiag(d, e)
    norm_t = np.abs(lam_j).max()
    for lam, V in ((res.eigenvalues, res.eigenvectors), (lam_e, V_e)):
        lam, V = lam.numpy(), V.numpy()
        assert lam.dtype == np.float64 and V.shape == (n, n)
        assert np.abs(lam - lam_j).max() <= 1e-13 * norm_t
        assert np.abs(T @ V - V * lam[None, :]).max() <= 1e-12 * norm_t
        assert np.abs(V.T @ V - np.eye(n)).max() <= 1e-12
        gaps = np.diff(lam_j)
        sep = np.minimum(np.append(gaps, np.inf), np.insert(gaps, 0, np.inf))
        well = sep > 1e-6 * norm_t
        dots = np.abs(np.sum(V * V_j, axis=0))
        # glued Wilkinson: every eigenvalue sits in a ~1e-8 cluster of 4
        assert (well.sum() == 0) if name == "glued_wilkinson" \
            else (well.sum() > n // 2)
        assert np.all(dots[well] >= 1 - 1e-10)
    if name == "scheme2_128":
        exact = st.eigenvalues_of_scheme2(n)
        assert np.abs(res.eigenvalues.numpy() - exact).max() <= 1e-13 * 4


def test_select_eigvals_only_and_leaf_only(rng):
    n = 60
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    cfg = st.SolverConfig(leaf_size=8, mixed_precision_vectors=False)
    full = st.solve_tridiagonal(d, e, config=cfg, compute_vectors=True,
                                device="cpu")
    sel = [0, 7, 33, 59]
    part = st.solve_tridiagonal(d, e, config=cfg, select=sel, device="cpu")
    assert part.eigenvectors.shape == (n, len(sel))
    assert torch.allclose(part.eigenvectors.abs(),
                          full.eigenvectors[:, sel].abs(), atol=1e-13)
    r = st.residuals(d, e, part, select=sel)
    assert r.shape == (len(sel),) and float(r.max()) < 1e-12 * 5
    lam = st.eigh_tridiagonal(d, e, config=cfg, eigvals_only=True,
                              device="cpu")
    assert torch.equal(lam, full.eigenvalues)
    # one leaf (n <= leaf size): the dense leaf solve is the whole solve
    one = st.solve_tridiagonal(d[:20], e[:19], config=st.SolverConfig(
        leaf_size=32, mixed_precision_vectors=False), compute_vectors=True,
        device="cpu")
    T = dense_from_tridiag(d[:20], e[:19])
    lam1, V1 = one.eigenvalues.numpy(), one.eigenvectors.numpy()
    assert np.abs(lam1 - np.linalg.eigvalsh(T)).max() < 1e-13 * 5
    assert np.abs(T @ V1 - V1 * lam1).max() < 1e-13 * 5


def test_mixed_precision_vectors_is_next_slice(rng):
    d = rng.standard_normal(16)
    e = rng.standard_normal(15)
    with pytest.raises(NotImplementedError, match="next slice"):
        st.solve_tridiagonal_staged(d, e, compute_vectors=True, device="cpu")
    # eigenvalues alone do not depend on the vector precision
    res, _ = st.solve_tridiagonal_staged(d, e, device="cpu")
    assert res.eigenvectors is None
    ref = np.linalg.eigvalsh(dense_from_tridiag(d, e))
    assert np.abs(res.eigenvalues.numpy() - ref).max() < 1e-13 * 5


def test_rejects_bad_inputs():
    cfg = st.SolverConfig(mixed_precision_vectors=False)
    with pytest.raises(ValueError):
        st.solve_tridiagonal(np.ones(4), np.ones(4), config=cfg, device="cpu")
    with pytest.raises(ValueError):
        st.solve_tridiagonal(np.ones(4), np.ones(3), config=cfg, select=[4],
                             device="cpu")
