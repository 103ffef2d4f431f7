"""PyTorch port, refinement (kernels/refine.py) on the CPU against the JAX
package's kernels/refine.py, function by function, in f64.

Tolerances: the solvers agree to 1e-13 of the solution's max (same
pivoting; XLA may contract a multiply-add where PyTorch does not); at
shifts within 1e-10 of an eigenvalue the directions agree to 1e-12.
Cluster orthonormalization: orthogonality <= 1e-12, the same column span,
and the batched CholeskyQR results agree with the JAX ones to 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import refine as jref
from symmetric_eigenvalue_tpu_torch.kernels import refine as tref


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _tridiag(rng, n, scale=1.0):
    return rng.standard_normal(n) * scale, rng.standard_normal(n - 1)


def _dense(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _same_direction(a, b, tol):
    a = a / np.linalg.norm(a, axis=0)
    b = b / np.linalg.norm(b, axis=0)
    assert np.all(np.abs(np.sum(a * b, axis=0)) >= 1 - tol)


def test_solve_shifted_tridiagonal(rng):
    n, K = 40, 7
    d, e = _tridiag(rng, n)
    lam = rng.standard_normal(K) * 2
    B = rng.standard_normal((n, K))
    X = tref.solve_shifted_tridiagonal(*_t(d, e, lam, B)).numpy()
    Xj = np.asarray(jax.jit(jref.solve_shifted_tridiagonal)(
        *_j(d, e, lam, B)))
    _close(X, Xj, 1e-13)
    T = _dense(d, e)
    for i in range(K):
        x = np.linalg.solve(T - lam[i] * np.eye(n), B[:, i])
        assert np.abs(X[:, i] - x).max() < 1e-10 * max(1, np.abs(x).max())
    # shifts at eigenvalues (the scaled back substitution); n == 1
    w, V = np.linalg.eigh(T)
    Xs = tref.solve_shifted_tridiagonal(*_t(d, e, w[:5] + 1e-14,
                                            B[:, :5])).numpy()
    assert np.isfinite(Xs).all()
    _same_direction(Xs, V[:, :5], 1e-6)
    _same_direction(Xs, np.asarray(jax.jit(jref.solve_shifted_tridiagonal)(
        *_j(d, e, w[:5] + 1e-14, B[:, :5]))), 1e-12)
    one = tref.solve_shifted_tridiagonal(*_t(d[:1], e[:0], lam, B[:1]))
    _close(one, jref.solve_shifted_tridiagonal(*_j(d[:1], e[:0], lam,
                                                   B[:1])), 1e-15)


def test_block_lu_solve(rng):
    P, nb, R, K = 3, 16, 2, 5
    db = rng.standard_normal((P, nb))
    eb = rng.standard_normal((P, nb - 1))
    lam = rng.standard_normal(K)
    rhs = rng.standard_normal((P, nb, R, K))
    tiny = 2.0 ** -48 * 4.0
    got = tref._block_lu_solve(*_t(db, eb, lam, rhs), torch.tensor(tiny))
    ref = jref._block_lu_solve(*_j(db, eb, lam, rhs), jnp.asarray(tiny))
    _close(got, ref, 1e-13)


@pytest.mark.parametrize("n,nb", [(300, 64), (517, 128)])
def test_blocked_solver(rng, n, nb):
    """Random shifts and shifts 1e-10 / 1e-13 from eigenvalues, a size that
    is not a multiple of nb."""
    d, e = _tridiag(rng, n, 2.0)
    w = np.linalg.eigvalsh(_dense(d, e))
    lam = np.concatenate([rng.standard_normal(4) * 2, w[:2] + 1e-10,
                          w[-2:] - 1e-13])
    B = rng.standard_normal((n, lam.shape[0]))
    X = tref.solve_shifted_tridiagonal_blocked(*_t(d, e, lam, B),
                                               nb=nb).numpy()
    Xj = np.asarray(jax.jit(
        lambda *a: jref.solve_shifted_tridiagonal_blocked(*a, nb=nb))(
        *_j(d, e, lam, B)))
    _close(X[:, :4], Xj[:, :4], 1e-13)
    _same_direction(X[:, 4:], Xj[:, 4:], 1e-12)
    T = _dense(d, e)
    for i in range(lam.shape[0]):
        r = (T - lam[i] * np.eye(n)) @ X[:, i] - B[:, i]
        assert np.abs(r).max() / max(np.abs(X[:, i]).max(), 1.0) < 1e-13


def test_interface_solve(rng):
    P, K = 20, 6
    ins = [rng.standard_normal((P, K)) * 0.3 for _ in range(4)] + \
        [rng.standard_normal((P, K)) for _ in range(2)]
    F, L = tref.interface_solve(*_t(*ins))
    Fj, Lj = jref.interface_solve(*_j(*ins))
    _close(F, Fj, 1e-13)
    _close(L, Lj, 1e-13)


@pytest.mark.parametrize("n", [80, 600])
def test_inverse_iteration(rng, n):
    """One pass from f32-perturbed eigenvectors (n=600: the blocked solver)
    restores f64 residuals, as the JAX pass does."""
    d, e = _tridiag(rng, n)
    T = _dense(d, e)
    w, V = np.linalg.eigh(T)
    V32 = (V + 1e-6 * rng.standard_normal(V.shape)).astype(np.float32)
    X = tref.inverse_iteration(*_t(d, e, w, V32)).numpy()
    Xj = np.asarray(jax.jit(jref.inverse_iteration)(*_j(d, e, w, V32)))
    nT = np.abs(w).max()
    assert np.abs(T @ X - X * w[None, :]).max() < 1e-12 * nT
    assert np.abs(X.T @ X - np.eye(n)).max() < 1e-10
    _same_direction(X, Xj, 1e-12)
    assert np.abs(np.linalg.norm(X, axis=0) - 1).max() < 1e-13


def test_cluster_segments(rng):
    lam = np.array([0.0, 1e-12, 2e-12, 1.0, 2.0, 2.0 + 1e-13])
    assert tref.cluster_segments(lam, 1e-9) == [(0, 3), (4, 6)]
    assert tref.cluster_segments(np.array([0.0, 1.0]), 1e-9) == []
    lam = np.sort(rng.standard_normal(300))
    assert tref.cluster_segments(lam, 5e-3) == \
        jref.cluster_segments(lam, 5e-3)


def _orthonormal(rng, n, k):
    return np.linalg.qr(rng.standard_normal((n, k)))[0]


def _segments_input(rng, n, segs, noise=1e-6):
    V = _orthonormal(rng, n, n)
    for s, t in segs:
        V[:, s:t] += noise * rng.standard_normal((n, t - s))
    return V


def test_gram_reduce(rng):
    S = rng.standard_normal((5, 300, 4))
    ref = np.einsum("bnw,bnv->bwv", S, S)
    np.testing.assert_allclose(tref._gram_reduce(torch.as_tensor(S)).numpy(),
                               ref, rtol=1e-13, atol=1e-14)
    np.testing.assert_allclose(
        tref._cluster_gram(torch.as_tensor(S), 5, 4).numpy(),
        np.asarray(jref._cluster_gram(jnp.asarray(S), 5, 4)), rtol=1e-13,
        atol=1e-14)


@pytest.mark.parametrize("w", [4, 16])
def test_cluster_orth_bodies(rng, w):
    """Narrow (position-major) and wide (segment-major) batched CholeskyQR
    bodies against the JAX bodies, with a pad segment and a rank-deficient
    segment that both must reject."""
    n = 64
    segs = [(2, 2 + w), (30, 30 + w - 1), (50, 50 + w // 2)]
    V = _segments_input(rng, n, segs)
    V[:, 51] = V[:, 50]                     # rank-deficient third segment
    starts = np.array([s for s, _ in segs] + [0])
    widths = np.array([t - s for s, t in segs] + [0])
    if w <= 8:
        Y, ok = tref.cluster_orth_narrow_body(*_t(V, starts, widths), w=w)
        Yj, okj = jref.cluster_orth_narrow_body(*_j(V, starts, widths), w=w)
    else:
        Y, ok = tref.cluster_orth_body(*_t(V, starts, widths), nseg=4, wmax=w)
        Yj, okj = jref.cluster_orth_body(*_j(V, starts, widths), nseg=4,
                                         wmax=w)
    ok, okj = ok.numpy(), np.asarray(okj)
    assert ok.tolist() == okj.tolist() == [True, True, False, True]
    Y, Yj = Y.numpy(), np.asarray(Yj)
    for i, (s, t) in enumerate(segs[:2]):
        cols = (np.arange(t - s) * 4 + i) if w <= 8 else i * w + np.arange(
            t - s)
        blk = Y[:, cols]
        assert np.abs(blk.T @ blk - np.eye(t - s)).max() < 1e-12
        np.testing.assert_allclose(blk, Yj[:, cols], rtol=0, atol=1e-12)


def test_wide_orth_and_explicit_qr(rng):
    n, w = 300, 260
    V = _segments_input(rng, n, [(0, w)])
    ok, Y = tref._wide_orth(torch.as_tensor(V[:, :w]))
    okj, Yj = jref._compiled_wide_orth(n, w, False)(jnp.asarray(V[:, :w]))
    assert bool(ok) and bool(okj)
    np.testing.assert_allclose(Y.numpy(), np.asarray(Yj), rtol=0, atol=1e-12)
    Vd = V.copy()
    Vd[:, 1] = Vd[:, 0]
    ok, _ = tref._wide_orth(torch.as_tensor(Vd[:, :w]))
    assert not bool(ok)                     # cholesky_ex reports the failure
    Q = tref.orth_explicit_qr(torch.as_tensor(Vd.copy()), [(0, w)]).numpy()
    assert np.abs(Q[:, :w].T @ Q[:, :w] - np.eye(w)).max() < 1e-12
    assert np.array_equal(Q[:, w:], Vd[:, w:])


def _check_orth(out, V, segs, span_tol):
    for s, t in segs:
        blk = out[:, s:t]
        assert np.abs(blk.T @ blk - np.eye(t - s)).max() < 1e-12, (s, t)
        if span_tol is not None:
            proj = blk @ (blk.T @ V[:, s:t])
            assert np.abs(proj - V[:, s:t]).max() < span_tol, (s, t)


def test_orthonormalize_clusters_buckets(rng, monkeypatch):
    """Narrow and wide width buckets, several dispatches per bucket (small
    budget), a segment wider than 256 and untouched columns passing through
    bit-identical; the result matches the JAX package's."""
    monkeypatch.setattr(tref, "_BATCH_BUDGET_BYTES", 8 * 400 * 8)
    monkeypatch.setattr(tref, "_MIN_BUDGET_COLS", 8)
    monkeypatch.setattr(jref, "_BATCH_BUDGET_BYTES", 8 * 400 * 8)
    monkeypatch.setattr(jref, "_MIN_BUDGET_COLS", 8)
    n = 400
    lam = np.arange(n, dtype=float)
    segs = [(4, 6), (10, 12), (20, 24), (30, 33), (40, 46), (60, 62),
            (70, 82), (90, 92), (100, 370)]
    for s, t in segs:
        lam[s:t] = lam[s] + 1e-12 * np.arange(t - s)
    V = _segments_input(rng, n, segs, 1e-7)
    out = tref.orthonormalize_clusters(lam, torch.as_tensor(V.copy()),
                                       norm_t=float(n)).numpy()
    _check_orth(out, V, segs, 1e-6)
    mask = np.ones(n, dtype=bool)
    for s, t in segs:
        mask[s:t] = False
    assert np.array_equal(out[:, mask], V[:, mask])
    outj = np.asarray(jref.orthonormalize_clusters(lam, jnp.asarray(V),
                                                   norm_t=float(n)))
    np.testing.assert_allclose(out, outj, rtol=0, atol=1e-12)


def test_orthonormalize_clusters_rank_deficient(rng):
    """A segment the refinement could not separate (two identical columns):
    CholeskyQR is rejected (cholesky_ex / Gershgorin) and the explicit QR
    still returns an orthonormal block.  A separable segment of the same
    width bucket, in the same batch, is accepted and written back beside
    it, as the JAX package writes it; untouched columns stay bit for bit."""
    n = 64
    lam = np.arange(n, dtype=float)
    lam[20:23] = 20.0
    lam[40:43] = 40.0 + 1e-12 * np.arange(3)
    V = _segments_input(rng, n, [(40, 43)], 1e-7)
    V[:, 21] = V[:, 20]
    out = tref.orthonormalize_clusters(lam, torch.as_tensor(V.copy()),
                                       norm_t=float(n)).numpy()
    assert np.isfinite(out).all()
    _check_orth(out, V, [(20, 23)], None)
    _check_orth(out, V, [(40, 43)], 1e-6)
    mask = np.ones(n, dtype=bool)
    mask[20:23] = mask[40:43] = False
    assert np.array_equal(out[:, mask], V[:, mask])
    outj = np.asarray(jref.orthonormalize_clusters(lam, jnp.asarray(V),
                                                   norm_t=float(n)))
    _check_orth(outj, V, [(20, 23)], None)
    np.testing.assert_allclose(out[:, 40:43], outj[:, 40:43], rtol=0,
                               atol=1e-12)


def test_orthonormalize_clusters_filters(rng):
    """The final cleanup's filter (degenerate_below, touched) and the mid
    pass's min_gap_factor keep exactly the JAX package's segments."""
    n = 96
    norm_t = float(n)
    lam = np.arange(n, dtype=float)
    lam[10:13] = 10.0                                 # degenerate
    lam[40:43] = [40.0, 40.0 + 1e-5, 40.0 + 2e-5]     # separable, in band
    lam[70:72] = [70.0, 70.0 + 1e-5]                  # separable, touched
    V = _segments_input(rng, n, [(10, 13), (40, 43), (70, 72)])
    touched = np.zeros(n, dtype=bool)
    touched[71] = True
    kw = dict(norm_t=norm_t, gap_factor=1e-6, touched=touched,
              degenerate_below=1e-8)
    out = tref.orthonormalize_clusters(lam, torch.as_tensor(V.copy()),
                                       **kw).numpy()
    _check_orth(out, V, [(10, 13), (70, 72)], 1e-5)
    assert np.array_equal(out[:, 40:43], V[:, 40:43])
    np.testing.assert_allclose(
        out, np.asarray(jref.orthonormalize_clusters(lam, jnp.asarray(V),
                                                     **kw)),
        rtol=0, atol=1e-12)
    # mid pass: fully degenerate segments wait for the final cleanup
    mid = tref.orthonormalize_clusters(lam, torch.as_tensor(V.copy()),
                                       norm_t=norm_t, gap_factor=1e-6,
                                       min_gap_factor=1e-8).numpy()
    assert np.array_equal(mid[:, 10:13], V[:, 10:13])
    _check_orth(mid, V, [(40, 43), (70, 72)], 1e-5)
