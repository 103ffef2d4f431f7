"""PyTorch port, dword_matmul: the plain version (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode, to 1e-12 of |A||B|
elementwise (the JAX kernel is ~2^-47-grade, the port native f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import symmetric_eigenvalue_tpu.kernels.pallas.dword_matmul as jdm
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as tdm


@pytest.fixture
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jdm.pl, "pallas_call", patched)


def _rel(Y, ref, A, B):
    scale = np.abs(A) @ np.abs(B)
    return (np.abs(Y - ref) / np.maximum(scale, 1e-300)).max()


@pytest.mark.parametrize("M,K,N", [(256, 256, 256), (100, 200, 300),
                                   (256, 64, 256)])
def test_plain_matches_interpreted_jax(interpreted, rng, M, K, N):
    A = rng.standard_normal((M, K))
    B = rng.standard_normal((K, N))
    ref = np.asarray(jdm.dword_matmul(jnp.asarray(A), jnp.asarray(B)))
    Y = tdm.dword_matmul(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert _rel(Y, ref, A, B) <= 1e-12


def test_batched_matches_interpreted_jax(interpreted, rng):
    k, M, K, N = 3, 70, 130, 90          # ragged against every tile size
    A = rng.standard_normal((k, M, K))
    B = rng.standard_normal((k, K, N)) * np.logspace(-3, 3, N)[None, None]
    Y = tdm.dword_matmul(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert Y.shape == (k, M, N)
    for b in range(k):
        ref = np.asarray(jdm.dword_matmul(jnp.asarray(A[b]),
                                          jnp.asarray(B[b])))
        assert _rel(Y[b], ref, A[b], B[b]) <= 1e-12


def test_rejects_bad_inputs():
    a = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        tdm.dword_matmul(a, a)
    with pytest.raises(TypeError):
        tdm.dword_matmul(a.float(), a.T.float())
    with pytest.raises(ValueError):
        tdm.dword_matmul(a[None], a.T)


def test_ortho_checks_match_jax(rng):
    """utils.checks (the Gram through dword_matmul) against the JAX
    package's checks on the same nearly orthonormal basis."""
    from symmetric_eigenvalue_tpu.utils import checks as jchecks
    from symmetric_eigenvalue_tpu_torch.utils import checks as tchecks
    n = 96
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V = Q + 1e-9 * rng.standard_normal((n, n))
    got = tchecks.max_ortho_error(torch.as_tensor(V), row_chunk=40)
    ref = jchecks.max_ortho_error(jnp.asarray(V), row_chunk=40)
    assert abs(got - ref) <= 1e-15 + 1e-12 * ref
    assert got > 1e-10
    got = tchecks.max_cross_ortho_error(torch.as_tensor(V[:, :50]),
                                        torch.as_tensor(V[:, 50:]),
                                        row_chunk=16)
    ref = jchecks.max_cross_ortho_error(jnp.asarray(V[:, :50]),
                                        jnp.asarray(V[:, 50:]), row_chunk=16)
    assert abs(got - ref) <= 1e-15 + 1e-12 * ref
