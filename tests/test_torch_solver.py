"""PyTorch port, whole slice: solve_tridiagonal_staged (the default
mixed-precision eigenvectors and the pure-f64 ones) and eigh_tridiagonal on
the CPU against the JAX package.

Eigenvalues agree elementwise to 1e-13 ||T||.  Eigenvectors are free in
sign (and inside clusters), so they are held to residual <= 1e-12 ||T||,
orthogonality (1e-12 for the f64 path; 1e-10, 1e-9 for clustered spectra,
for the mixed one), and |<v_port, v_jax>| >= 1 - 1e-10 for eigenvalues
separated from their neighbours by more than 1e-6 ||T|| (f64 path) or
1e-4 ||T|| (mixed path).
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


def _clustered():
    k = 10
    dw = np.abs(np.arange(2 * k + 1) - k).astype(float)
    ew = np.ones(2 * k)
    d = np.concatenate([dw] * 6)
    e = np.concatenate(sum([[ew, [1e-9]] for _ in range(5)], []) + [ew])
    return d, e


def _mixed_case(name):
    """(d, e, SolverConfig kwargs, select, orthogonality limit)."""
    rng = np.random.default_rng(1234)
    if name == "random200_chunk64":
        return (rng.standard_normal(200) * 5, rng.standard_normal(199) * 2,
                dict(leaf_size=16, vec_chunk=64), None, 1e-10)
    if name == "scheme2_256":
        return 2.0 * np.ones(256), -np.ones(255), dict(leaf_size=16), None, \
            1e-10
    if name == "glued_wilkinson":
        d, e = _clustered()
        return d, e, dict(leaf_size=16), None, 1e-9
    # n >= 512 takes the Spike passes; 640 = 20 leaves of 32, padded to 32
    d, e = rng.standard_normal(640) * 5, rng.standard_normal(639) * 2
    sel = np.arange(3, 640, 5) if name == "ragged640_select" else None
    return d, e, dict(leaf_size=32), sel, 1e-10


_JAX_RESULTS = {}


def _jax_mixed(name, d, e, kw, sel):
    """The JAX package's default-config solve, once per input (off the TPU
    it has no Spike route, so use_pallas_refine does not change it)."""
    key = "ragged640" if name == "ragged640_no_spike" else name
    if key not in _JAX_RESULTS:
        from symmetric_eigenvalue_tpu.driver import solve_tridiagonal_staged
        res, _ = solve_tridiagonal_staged(d, e, config=se.SolverConfig(**kw),
                                          compute_vectors=True, select=sel)
        _JAX_RESULTS[key] = (np.asarray(res.eigenvalues),
                             np.asarray(res.eigenvectors))
    return _JAX_RESULTS[key]


@pytest.mark.parametrize("name", ["random200_chunk64", "scheme2_256",
                                  "glued_wilkinson", "ragged640",
                                  "ragged640_no_spike", "ragged640_select"])
def test_mixed_precision_default_matches_jax(name):
    """The default config (f32 downsweep + f64 refinement) against the JAX
    package's solve_tridiagonal_staged: eigenvalues to 1e-13 ||T||,
    residual <= 1e-12 ||T||, orthogonality within the case's limit, and
    the same vectors where the neighbours are > 1e-4 ||T|| away.
    ragged640_no_spike runs the refinement through the PyTorch solver
    (use_pallas_refine=False) instead of the Spike passes."""
    d, e, kw, sel, ortho_tol = _mixed_case(name)
    n = d.shape[0]
    lam_j, V_j = _jax_mixed(name, d, e, kw, sel)
    cfg = st.SolverConfig(**kw, use_pallas_refine=(
        name != "ragged640_no_spike"))
    assert cfg.mixed_precision_vectors
    res, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                             compute_vectors=True,
                                             select=sel, device="cpu")
    assert {"bt.downsweep", "bt.refine_pass1", "bt.ortho_final"} \
        <= set(timer.times)
    lam, V = res.eigenvalues.numpy(), res.eigenvectors.numpy()
    cols = np.arange(n) if sel is None else sel
    assert V.dtype == np.float64 and V.shape == (n, cols.size)
    norm_t = np.abs(lam_j).max()
    assert np.abs(lam - lam_j).max() <= 1e-13 * norm_t
    T = dense_from_tridiag(d, e)
    assert np.abs(T @ V - V * lam[cols][None, :]).max() <= 1e-12 * norm_t
    assert np.abs(V.T @ V - np.eye(cols.size)).max() <= ortho_tol
    gaps = np.diff(lam_j)
    sep = np.minimum(np.append(gaps, np.inf), np.insert(gaps, 0, np.inf))
    well = (sep > 1e-4 * norm_t)[cols]
    assert (well.sum() == 0) if name == "glued_wilkinson" \
        else (well.sum() > cols.size // 2)
    dots = np.abs(np.sum(V * V_j, axis=0))
    assert np.all(dots[well] >= 1 - 1e-10)
    if name == "scheme2_256":
        exact = st.eigenvalues_of_scheme2(n)
        assert np.abs(lam - exact).max() <= 1e-13 * 4
    # eigenvalues alone do not depend on the vector precision
    vals, _ = st.solve_tridiagonal_staged(d, e, config=cfg, device="cpu")
    assert vals.eigenvectors is None
    assert torch.equal(vals.eigenvalues, res.eigenvalues)


def test_refine_rescue_from_clipped_spike(monkeypatch):
    """A Spike pass whose back substitution clipped returns a garbage
    column with the 1e30 estimate.  Both Spike passes failing
    (use_pallas_refine_extra=True) must trigger the rescue stage (PyTorch
    solver passes accepted on measured residuals), and the result must
    still meet the residual target."""
    from symmetric_eigenvalue_tpu_torch.core.tridiag import residual_norms
    from symmetric_eigenvalue_tpu_torch.kernels import refine, spike_solve

    n = 768
    d = np.linspace(1.0, 100.0, n)          # scheme 1: well separated
    e = -np.ones(n - 1)
    T = dense_from_tridiag(d, e)
    w = np.linalg.eigvalsh(T)
    lam_target = w[np.argmin(np.abs(w - 50.0))]
    g = torch.as_tensor(np.sin(np.arange(n) * 2.17))
    g /= torch.linalg.vector_norm(g)
    calls = []

    def fake_spike(dd, ee, lam_c, V_c, nb=128, chunk=2048, normalize=True):
        X = refine.inverse_iteration(dd, ee, lam_c, V_c, steps=1, block=nb)
        res = residual_norms(dd, ee, lam_c, X)
        # the driver solves the prescaled system: match lam_target there
        hit = (lam_c * (np.abs(d).max() + 2.0) - lam_target).abs() < 1e-8
        X[:, hit] = g[:, None]
        res[hit] = 1e30
        calls.append(int(hit.sum()))
        return X, res

    monkeypatch.setattr(spike_solve, "spike_refine", fake_spike)
    res, timer = st.solve_tridiagonal_staged(
        d, e, config=st.SolverConfig(leaf_size=32,
                                     use_pallas_refine_extra=True),
        compute_vectors=True, device="cpu")
    assert calls == [1, 1]                  # pass 1 and the extra pass
    assert "bt.refine_rescue" in timer.times, timer.times
    assert timer.counts["risky_sentinel"] >= 1
    assert timer.counts["rescue"] >= 1 and timer.counts["rescue_improved"] >= 1
    lam = res.eigenvalues.numpy()
    V = res.eigenvectors.numpy()
    nT = np.abs(lam).max()
    assert np.abs(T @ V - V * lam[None, :]).max() < 1e-12 * nT
    assert np.abs(V.T @ V - np.eye(n)).max() < 1e-10


def test_rejects_bad_inputs():
    cfg = st.SolverConfig(mixed_precision_vectors=False)
    with pytest.raises(ValueError):
        st.solve_tridiagonal(np.ones(4), np.ones(4), config=cfg, device="cpu")
    with pytest.raises(ValueError):
        st.solve_tridiagonal(np.ones(4), np.ones(3), config=cfg, select=[4],
                             device="cpu")
