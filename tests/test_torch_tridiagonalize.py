"""PyTorch port, dense front end: ``tridiagonalize`` and ``apply_q`` held
against the JAX package's on the same matrices (CPU, f64).

The two packages use the same reflector convention and signs, so ``d``,
``e``, ``Vt`` and ``taus`` agree elementwise, to 2e-12 n max|A|: Householder
reduction is backward stable, not forward stable, so the two packages'
different roundings of one column feed every later column, and the
difference grows along the chain of n reflectors (6e-11 was seen at n=64 on
a draw with one short column; a wrong sign or index gives O(1))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import tridiagonalize as jtri
from symmetric_eigenvalue_tpu_torch import interop
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as dm
from symmetric_eigenvalue_tpu_torch.kernels import dword_matvec as dv
from symmetric_eigenvalue_tpu_torch.kernels import tridiagonalize as ttri


def _sym(rng, n):
    A = rng.standard_normal((n, n))
    return (A + A.T) / 2


def _tridiag(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


# the (n, panel) of the JAX package's reconstruction test with one bucket,
# then its bucketed cases
@pytest.mark.parametrize("n,panel,buckets", [
    (5, 2, 1), (16, 4, 1), (33, 8, 1), (64, 32, 1), (50, 7, 1),
    (64, 8, 3), (100, 8, 4), (129, 16, 4), (33, 8, 2)])
def test_tridiagonalize_matches_jax(rng, n, panel, buckets):
    A = _sym(rng, n)
    before = A.copy()
    ref = [np.asarray(x) for x in jtri.tridiagonalize(
        jnp.asarray(A), panel=panel, buckets=buckets)]
    got = ttri.tridiagonalize(torch.as_tensor(A), panel=panel,
                              buckets=buckets)
    assert np.array_equal(A, before)          # the input is not modified
    tol = 2e-12 * n * np.abs(A).max()
    for name, g, r in zip(("d", "e", "Vt", "taus"), got, ref):
        assert g.shape == r.shape, name
        assert np.abs(g.numpy() - r).max() <= tol, name
    d, e, Vt, taus = got
    # reflector layout: zero at entries <= k, one at k+1 (or all zero)
    V = Vt.numpy()
    assert np.all(np.tril(V) == 0.0)
    unit = np.diagonal(V, offset=1)
    assert np.all((unit == 1.0) | (unit == 0.0))
    # Q^T A Q = T, through apply_q on the identity
    Q = ttri.apply_q(Vt, taus, torch.eye(n, dtype=torch.float64),
                     panel=panel).numpy()
    T = _tridiag(d.numpy(), e.numpy())
    assert np.abs(Q.T @ Q - np.eye(n)).max() <= 1e-13
    assert np.abs(Q.T @ A @ Q - T).max() <= 1e-12 * max(np.abs(A).max(), 1)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_tiny_sizes_match_jax(rng, n):
    A = _sym(rng, n)
    ref = jtri.tridiagonalize(jnp.asarray(A))
    got = ttri.tridiagonalize(torch.as_tensor(A))
    for g, r in zip(got, ref):
        assert g.shape == np.asarray(r).shape
        assert np.abs(g.numpy() - np.asarray(r)).max(initial=0.0) <= 1e-15
    X = rng.standard_normal((n, 2))
    QX = ttri.apply_q(got[2], got[3], torch.as_tensor(X)).numpy()
    ref_QX = np.asarray(jtri.apply_q(ref[2], ref[3], jnp.asarray(X)))
    assert np.abs(QX - ref_QX).max() <= 1e-15


def test_already_tridiagonal_takes_the_no_op_branch(rng):
    """Every column is already reduced: all reflectors are the identity
    (tau = 0, v = 0) and (d, e) are A's own diagonals, as in the JAX
    package."""
    n = 32
    d0, e0 = rng.standard_normal(n), rng.standard_normal(n - 1)
    A = _tridiag(d0, e0)
    d, e, Vt, taus = ttri.tridiagonalize(torch.as_tensor(A), panel=8)
    assert np.array_equal(d.numpy(), d0) and np.array_equal(e.numpy(), e0)
    assert not Vt.any() and not taus.any()
    ref = jtri.tridiagonalize(jnp.asarray(A), panel=8)
    assert np.array_equal(np.asarray(ref[1]), e.numpy())
    assert not np.asarray(ref[3]).any()


def test_partly_reduced_matrix_mixes_both_branches(rng):
    """A block-diagonal A = diag(tridiagonal, dense): the first columns take
    the no-op branch, the rest real reflectors, with no host decision."""
    n, k = 24, 10
    A = np.zeros((n, n))
    A[:k, :k] = _tridiag(rng.standard_normal(k), rng.standard_normal(k - 1))
    A[k:, k:] = _sym(rng, n - k)
    ref = [np.asarray(x) for x in jtri.tridiagonalize(jnp.asarray(A),
                                                      panel=4)]
    got = ttri.tridiagonalize(torch.as_tensor(A), panel=4)
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - r).max() <= 1e-12
    assert not got[3][:k].any() and got[3][k:n - 2].all()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_apply_q_matches_jax(rng, source, transpose):
    """apply_q and its transpose against the JAX package's, to 1e-12, on the
    port's own reflectors and on the JAX package's (carried across by
    interop), including a ragged last panel."""
    n, panel = 40, 7
    A = _sym(rng, n)
    if source == "port":
        _, _, Vt, taus = ttri.tridiagonalize(torch.as_tensor(A), panel=panel)
    else:
        out = jtri.tridiagonalize(jnp.asarray(A), panel=panel)
        _, _, Vt, taus = interop.tridiagonal_reflectors_from_numpy(
            *(np.asarray(x) for x in out))
    X = rng.standard_normal((n, 6))
    got = ttri.apply_q(Vt, taus, torch.as_tensor(X), panel=panel,
                       transpose=transpose).numpy()
    ref = np.asarray(jtri.apply_q(jnp.asarray(Vt.numpy()),
                                  jnp.asarray(taus.numpy()), jnp.asarray(X),
                                  panel=panel, transpose=transpose))
    assert np.abs(got - ref).max() <= 1e-12
    # and against the explicit product of reflectors
    Q = np.eye(n)
    for k in range(n):
        v = Vt.numpy()[k]
        Q = Q @ (np.eye(n) - float(taus[k]) * np.outer(v, v))
    assert np.abs(got - (Q.T if transpose else Q) @ X).max() <= 1e-12


def test_port_reflectors_through_the_jax_apply_q(rng):
    """The reverse direction: the port's reflectors through the JAX
    package's apply_q give an orthogonal Q with Q^T A Q = T."""
    n, panel = 33, 8
    A = _sym(rng, n)
    d, e, Vt, taus = ttri.tridiagonalize(torch.as_tensor(A), panel=panel,
                                         buckets=2)
    Q = np.asarray(jtri.apply_q(jnp.asarray(Vt.numpy()),
                                jnp.asarray(taus.numpy()),
                                jnp.eye(n, dtype=jnp.float64), panel=panel))
    assert np.abs(Q.T @ Q - np.eye(n)).max() <= 1e-13
    assert np.abs(Q.T @ A @ Q - _tridiag(d.numpy(), e.numpy())).max() <= 1e-12


def test_larft_matches_jax(rng):
    nb, n = 6, 20
    Vp = np.triu(rng.standard_normal((nb, n)), 1)
    Vp[np.arange(nb), np.arange(nb) + 1] = 1.0
    tau = rng.uniform(0.5, 1.5, nb)
    tau[3] = 0.0
    Vp[3] = 0.0
    got = ttri._larft(torch.as_tensor(Vp), torch.as_tensor(tau)).numpy()
    ref = np.asarray(jtri._larft(jnp.asarray(Vp), jnp.asarray(tau)))
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    assert np.all(np.tril(got, -1) == 0.0)


def test_interop_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="Vt"):
        interop.tridiagonal_reflectors_from_numpy(
            np.zeros(4), np.zeros(3), np.zeros((4, 3)), np.zeros(4))
    with pytest.raises(ValueError, match="e has shape"):
        interop.tridiagonal_reflectors_from_numpy(
            np.zeros(4), np.zeros(4), np.zeros((4, 4)), np.zeros(4))


def test_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        ttri.tridiagonalize(torch.zeros((3, 4), dtype=torch.float64))


def test_cpu_run_counts_no_launches(rng):
    before = (dv.launches, dm.launches)
    A = _sym(rng, 20)
    _, _, Vt, taus = ttri.tridiagonalize(torch.as_tensor(A), panel=4)
    ttri.apply_q(Vt, taus, torch.as_tensor(A), panel=4)
    assert (dv.launches, dm.launches) == before == (0, 0)
