"""PyTorch port, two-stage front end: band reduction, bulge chases and their
backtransforms held against the JAX package's on the same matrices (CPU,
f64), elementwise to 2e-12 n (entries are O(1)): each reduction is a chain
of ~n dependent reflectors, backward but not forward stable, so the two
packages' different roundings of one step feed all later ones (5e-11 was
seen at n=64 on a draw with one short column; a wrong sign or index gives
O(1))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import band_reduce as jband
from symmetric_eigenvalue_tpu_torch import interop
from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as tband
from symmetric_eigenvalue_tpu_torch.kernels.tridiagonalize import apply_q


def _tol(n):
    return 2e-12 * n


def _sym(rng, n, band=None):
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    if band is not None:
        i = np.arange(n)
        A[np.abs(i[:, None] - i[None, :]) > band] = 0.0
    return A


def _tridiag(d, e):
    d, e = np.asarray(d), np.asarray(e)
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _err(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max(initial=0.0)


@pytest.mark.parametrize("n,b,buckets", [(64, 8, 1), (96, 16, 1),
                                         (100, 8, 1), (33, 8, 1),
                                         (130, 16, 4), (100, 8, 3)])
def test_reduce_to_band_matches_jax(rng, n, b, buckets):
    A = _sym(rng, n)
    before = A.copy()
    ref = jband.reduce_to_band(jnp.asarray(A), b, buckets=buckets)
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), b,
                                       buckets=buckets)
    assert np.array_equal(A, before)
    for name, g, r in zip(("B", "Yt", "taus"), (B, Yt, taus), ref):
        assert _err(g.numpy(), r) <= _tol(n), name
    B = B.numpy()
    i = np.arange(n)
    assert np.abs(B[np.abs(i[:, None] - i[None, :]) > b]).max() <= 1e-13
    assert np.array_equal(B, B.T)
    # A Q1 = Q1 B through apply_q with panel = band
    Q = apply_q(Yt, taus, torch.eye(n, dtype=torch.float64), panel=b).numpy()
    assert np.abs(A @ Q - Q @ B).max() <= 1e-12
    assert np.abs(Q.T @ Q - np.eye(n)).max() <= 1e-13
    # eigenvalues-only callers skip the reflector store
    B0, Y0, t0 = tband.reduce_to_band(torch.as_tensor(A), b, buckets=buckets,
                                      want_reflectors=False)
    assert Y0.shape == (1, 1)
    assert np.array_equal(B0.numpy(), B) and torch.equal(t0, taus)


def test_reduce_to_band_small_is_the_identity(rng):
    A = _sym(rng, 6)
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), 8)
    assert np.array_equal(B.numpy(), A)
    assert not Yt.any() and not taus.any()
    A = _sym(rng, 40)                       # n == band: (40, 40) of the JAX test
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), 40)
    assert np.array_equal(B.numpy(), A) and not taus.any()


@pytest.mark.parametrize("n,b", [(24, 2), (96, 8), (130, 8), (128, 16),
                                 (200, 5), (64, 70)])
def test_wavefront_chase_matches_jax(rng, n, b):
    A = _sym(rng, n, band=b)
    dj, ej, (Vj, tj) = jband.band_to_tridiag_wave(jnp.asarray(A), b)
    d, e, (Vw, tw) = tband.band_to_tridiag_wave(torch.as_tensor(A), b)
    assert Vw.shape == np.asarray(Vj).shape and tw.shape == tj.shape
    for name, g, r in (("d", d, dj), ("e", e, ej), ("Vw", Vw, Vj),
                       ("tw", tw, tj)):
        assert _err(g.numpy(), r) <= _tol(n), name
    T = _tridiag(d.numpy(), e.numpy())
    w0 = np.linalg.eigvalsh(A)
    assert np.abs(w0 - np.linalg.eigvalsh(T)).max() <= 1e-12 * max(
        np.abs(w0).max(), 1.0)
    eye = torch.eye(n, dtype=torch.float64)
    Q2 = tband.apply_q2_wave(n, b, (Vw, tw), eye).numpy()
    assert np.abs(Q2.T @ Q2 - np.eye(n)).max() <= 1e-13
    assert np.abs(Q2.T @ A @ Q2 - T).max() <= 1e-12
    # the blocked application against the per-sweep one, and against the
    # JAX package's blocked application of the JAX package's log
    X = rng.standard_normal((n, 7))
    Ya = tband.apply_q2_wave(n, b, (Vw, tw), torch.as_tensor(X)).numpy()
    Yb = tband.apply_q2_wave_blocked(n, b, (Vw, tw),
                                     torch.as_tensor(X)).numpy()
    assert np.abs(Ya - Yb).max() <= 1e-13
    ref = np.asarray(jband.apply_q2_wave_blocked(n, b, (Vj, tj),
                                                 jnp.asarray(X)))
    assert np.abs(Yb - ref).max() <= _tol(n)
    # no log for eigenvalues-only callers, same (d, e)
    d0, e0, (V0, t0) = tband.band_to_tridiag_wave(torch.as_tensor(A), b,
                                                  want_log=False)
    assert V0.shape[0] == 1 and t0.shape[0] == 1
    assert torch.equal(d0, d) and torch.equal(e0, e)


def test_jax_wave_log_through_the_port(rng):
    """The JAX package's reflector log, carried across by interop, through
    the port's two backtransforms: the same Q2 X as the JAX package's."""
    n, b = 100, 8
    A = _sym(rng, n, band=b)
    _, _, (Vj, tj) = jband.band_to_tridiag_wave(jnp.asarray(A), b)
    vlog = interop.wave_log_from_numpy(np.asarray(Vj), np.asarray(tj))
    X = rng.standard_normal((n, 5))
    ref = np.asarray(jband.apply_q2_wave(n, b, (Vj, tj), jnp.asarray(X)))
    for fn in (tband.apply_q2_wave, tband.apply_q2_wave_blocked):
        assert np.abs(fn(n, b, vlog, torch.as_tensor(X)).numpy()
                      - ref).max() <= 1e-12
    with pytest.raises(ValueError):
        interop.wave_log_from_numpy(np.asarray(Vj), np.asarray(tj)[:, :-1])
    with pytest.raises(ValueError):
        interop.wave_log_from_numpy(np.asarray(tj), np.asarray(tj))


def test_jax_band_reflectors_through_the_port(rng):
    n, b = 64, 8
    A = _sym(rng, n)
    out = jband.reduce_to_band(jnp.asarray(A), b)
    B, Yt, taus = interop.band_reflectors_from_numpy(
        *(np.asarray(x) for x in out))
    Q = apply_q(Yt, taus, torch.eye(n, dtype=torch.float64), panel=b).numpy()
    assert np.abs(A @ Q - Q @ B.numpy()).max() <= 1e-12
    with pytest.raises(ValueError, match="Yt"):
        interop.band_reflectors_from_numpy(np.zeros((4, 4)), np.zeros((4, 3)),
                                           np.zeros(4))


def test_chase_schedule_matches_jax():
    for n, b in [(24, 5), (10, 2), (7, 9), (2, 3), (3, 2)]:
        assert np.array_equal(tband._chase_schedule(n, b),
                              jband._chase_schedule(n, b))
    for n, b in [(96, 8), (130, 8), (64, 70), (3, 2), (4096, 128)]:
        assert tband._wave_geometry(n, b) == jband._wave_geometry(n, b)


@pytest.mark.parametrize("n,b", [(48, 6), (40, 3)])
def test_sequential_chase_matches_jax(rng, n, b):
    A = _sym(rng, n, band=b)
    dj, ej, csj = jband.band_to_tridiag(jnp.asarray(A), b)
    d, e, cs = tband.band_to_tridiag(torch.as_tensor(A), b)
    assert _err(d.numpy(), dj) <= _tol(n) and _err(e.numpy(), ej) <= _tol(n)
    assert _err(cs.numpy(), csj) <= _tol(n)
    X = rng.standard_normal((n, 4))
    got = tband.apply_q2(n, b, cs, torch.as_tensor(X)).numpy()
    ref = np.asarray(jband.apply_q2(n, b, csj, jnp.asarray(X)))
    assert np.abs(got - ref).max() <= _tol(n)
    Q2 = tband.apply_q2(n, b, cs, torch.eye(n, dtype=torch.float64)).numpy()
    T = _tridiag(d.numpy(), e.numpy())
    assert np.abs(Q2.T @ A @ Q2 - T).max() <= 1e-12


def test_wavefront_against_the_sequential_chase(rng):
    """Wave and sequential chases produce orthogonally similar tridiagonals
    of the same matrix (eigenvalues equal; entries may differ in sign)."""
    n, b = 72, 6
    A = _sym(rng, n, band=b)
    dw, ew, _ = tband.band_to_tridiag_wave(torch.as_tensor(A), b)
    ds, es, _ = tband.band_to_tridiag(torch.as_tensor(A), b)
    lw = np.linalg.eigvalsh(_tridiag(dw.numpy(), ew.numpy()))
    ls = np.linalg.eigvalsh(_tridiag(ds.numpy(), es.numpy()))
    assert np.abs(lw - ls).max() <= 1e-12


@pytest.mark.parametrize("n,b", [(48, 8), (65, 8)])
def test_two_stage_pipeline(rng, n, b):
    """dense -> band -> tridiagonal, eigenvectors back through Q = Q1 Q2."""
    A = _sym(rng, n)
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), b)
    d, e, vlog = tband.band_to_tridiag_wave(B, b)
    T = _tridiag(d.numpy(), e.numpy())
    Q2 = tband.apply_q2_wave_blocked(n, b, vlog,
                                     torch.eye(n, dtype=torch.float64))
    Q = apply_q(Yt, taus, Q2, panel=b).numpy()
    assert np.abs(A @ Q - Q @ T).max() <= 1e-12
    assert np.abs(Q.T @ Q - np.eye(n)).max() <= 1e-13


@pytest.mark.parametrize("n,b", [(2, 4), (1, 2), (5, 1)])
def test_degenerate_sizes_pass_through(rng, n, b):
    A = _sym(rng, n, band=b)
    d, e, vlog = tband.band_to_tridiag_wave(torch.as_tensor(A), b)
    assert np.array_equal(d.numpy(), np.diag(A))
    assert np.array_equal(e.numpy(), np.diag(A, 1))
    X = torch.as_tensor(rng.standard_normal((n, 3)))
    assert torch.equal(tband.apply_q2_wave(n, b, vlog, X), X)
    assert torch.equal(tband.apply_q2_wave_blocked(n, b, vlog, X), X)
