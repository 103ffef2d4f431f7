"""PyTorch port, dense and banded entry points: ``eigh`` (one-stage and
two-stage) and ``eigh_banded`` on ``device="cpu"`` held against the JAX
package's ``driver.eigh`` / ``driver.eigh_banded``, ``numpy.linalg.eigvalsh``
and ``scipy.linalg.eig_banded`` on the same matrices.

Eigenvalues: 1e-12 ||A||.  Eigenvectors by residual (1e-11 ||A||) and
orthogonality (1e-11), beside the JAX package's numbers, never elementwise
(column signs and the basis inside a cluster are free)."""

import numpy as np
import pytest
import scipy.linalg
import torch

import symmetric_eigenvalue_tpu as se
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu_torch.utils.timing import PhaseTimer

CFG = st.SolverConfig(leaf_size=16)
CFG64 = st.SolverConfig(leaf_size=16, mixed_precision_vectors=False)
JCFG = se.SolverConfig(leaf_size=16)


def _sym(rng, n, scale=3.0):
    A = rng.standard_normal((n, n)) * scale
    return (A + A.T) / 2


def _quality(A, lam, V):
    n = A.shape[0]
    nA = max(np.abs(np.linalg.eigvalsh(A)).max(), 1.0)
    return (np.abs(A @ V - V * lam[None, :]).max() / nA,
            np.abs(V.T @ V - np.eye(n)).max())


def _check_pairs(A, lam, V, jlam=None, jV=None):
    lam, V = lam.numpy(), V.numpy()
    ref = np.linalg.eigvalsh(A)
    nA = max(np.abs(ref).max(), 1.0)
    assert np.abs(lam - ref).max() <= 1e-12 * nA
    resid, ortho = _quality(A, lam, V)
    assert resid <= 1e-11 and ortho <= 1e-11
    if jlam is not None:
        assert np.abs(lam - np.asarray(jlam)).max() <= 1e-12 * nA
        jres, jortho = _quality(A, np.asarray(jlam), np.asarray(jV))
        # beside the JAX package's numbers: no worse than 10x of them plus
        # 1e-12 (the JAX package solves these small sizes in pure f64; the
        # port's default config refines f32 vectors, good to ~1e-12)
        assert resid <= 10 * jres + 1e-12 and ortho <= 10 * jortho + 1e-12


@pytest.mark.parametrize("n,band,cfg", [
    (1, 0, CFG), (2, 0, CFG), (3, 0, CFG), (48, 0, CFG), (100, 0, CFG),
    (100, 0, CFG64), (100, 8, CFG), (65, 8, CFG64), (20, 32, CFG)])
def test_eigh_matches_jax(rng, n, band, cfg):
    A = _sym(rng, n)
    before = A.copy()
    lam, V = st.eigh(A, config=cfg, band=band, device="cpu")
    assert np.array_equal(A, before)
    assert lam.dtype == V.dtype == torch.float64 and V.shape == (n, n)
    jlam, jV = se.driver.eigh(A, config=JCFG, band=band)
    _check_pairs(A, lam, V, jlam, jV)
    lam_only = st.eigh(A, config=cfg, band=band, eigvals_only=True,
                       device="cpu")
    assert np.abs(lam_only.numpy() - lam.numpy()).max() <= \
        1e-13 * max(np.abs(lam.numpy()).max(), 1.0)


def test_eigh_mixed_route_at_spike_size(rng):
    """n >= 512 with the default config: the tridiagonal solve runs the f32
    downsweep and the Spike refinement (plain passes on the CPU), the dense
    reduction takes a ragged panel and the bucketed path is forced through
    tridiagonalize directly in its own tests."""
    n = 530
    A = _sym(rng, n, scale=1.0)
    timer = PhaseTimer()
    lam, V = st.eigh(torch.as_tensor(A), device="cpu", timer=timer)
    _check_pairs(A, lam, V)
    for phase in ("dense.tridiagonalize", "eigenvalues", "backtransformation",
                  "bt.refine_pass1", "dense.apply_q"):
        assert timer.times[phase] > 0.0, phase


def test_eigh_two_stage_records_its_phases(rng):
    n = 90
    A = _sym(rng, n)
    timer = PhaseTimer()
    lam, V = st.eigh(A, config=CFG, band=8, device="cpu", timer=timer)
    _check_pairs(A, lam, V)
    assert {"dense.reduce_to_band", "dense.band_to_tridiag", "eigenvalues",
            "backtransformation", "dense.apply_q2", "dense.apply_q"} \
        <= set(timer.times)
    assert "dense.tridiagonalize" not in timer.times


def test_eigh_already_tridiagonal(rng):
    n = 32
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    A = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    lam, V = st.eigh(A, config=st.SolverConfig(leaf_size=8), device="cpu")
    _check_pairs(A, lam, V)


def test_eigh_rejects_bad_input():
    with pytest.raises(ValueError, match="square"):
        st.eigh(np.zeros((3, 4)), device="cpu")
    with pytest.raises(ValueError, match="square"):
        st.eigh(np.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="square"):
        st.eigh(np.zeros((0, 0)), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        st.eigh(np.eye(3), device="meta")


def _band_storage(A, u, lower):
    n = A.shape[0]
    ab = np.zeros((u + 1, n))
    for k in range(min(u, n - 1) + 1):
        diag = np.diagonal(A, k)
        if lower:
            ab[k, :n - k] = diag
        else:
            ab[u - k, k:] = diag
    return ab


@pytest.mark.parametrize("n,u,lower", [
    (40, 0, False), (40, 1, False), (40, 1, True), (40, 2, False),
    (40, 2, True), (64, 5, False), (64, 5, True), (12, 20, False),
    (12, 12, True), (1, 3, False), (2, 1, True), (3, 2, False)])
def test_eigh_banded_matches_jax_and_scipy(rng, n, u, lower):
    A = _sym(rng, n)
    i = np.arange(n)
    A[np.abs(i[:, None] - i[None, :]) > u] = 0.0
    ab = _band_storage(A, u, lower)
    # entries outside the valid range are ignored
    junk = ab.copy()
    for k in range(1, u + 1):
        if lower:
            junk[k, max(n - k, 0):] = 77.0
        else:
            junk[u - k, :min(k, n)] = 77.0
    lam, V = st.eigh_banded(junk, lower=lower, config=CFG, device="cpu")
    jlam, jV = se.driver.eigh_banded(ab, lower=lower, config=JCFG)
    _check_pairs(A, lam, V, jlam, jV)
    if u < n:
        ref = scipy.linalg.eig_banded(ab, lower=lower, eigvals_only=True)
        assert np.abs(lam.numpy() - ref).max() <= 1e-12 * max(
            np.abs(ref).max(), 1.0)
    lam_only = st.eigh_banded(torch.as_tensor(ab), lower=lower, config=CFG,
                              eigvals_only=True, device="cpu")
    assert np.abs(lam_only.numpy() - lam.numpy()).max() <= 1e-13 * max(
        np.abs(lam.numpy()).max(), 1.0)


def test_eigh_banded_prescale(rng):
    """The chase runs on the matrix scaled to max|A| = 1: a badly scaled
    band matrix keeps its relative accuracy."""
    n, u = 48, 4
    A = _sym(rng, n)
    i = np.arange(n)
    A[np.abs(i[:, None] - i[None, :]) > u] = 0.0
    for scale in (1e-20, 1e150):
        lam, V = st.eigh_banded(_band_storage(A * scale, u, False),
                                config=CFG64, device="cpu")
        ref = np.linalg.eigvalsh(A)
        assert np.abs(lam.numpy() / scale - ref).max() <= 1e-12 * \
            np.abs(ref).max()
        V = V.numpy()
        assert np.abs(A @ V - V * (lam.numpy() / scale)).max() <= 1e-11 * \
            np.abs(ref).max()


def test_eigh_banded_rejects_bad_input():
    with pytest.raises(ValueError, match="band-storage"):
        st.eigh_banded(np.zeros(5), device="cpu")
    with pytest.raises(ValueError, match="band-storage"):
        st.eigh_banded(np.zeros((0, 5)), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        st.eigh_banded(np.zeros((2, 0)), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        st.eigh_banded(np.ones((2, 4)), device="meta")
