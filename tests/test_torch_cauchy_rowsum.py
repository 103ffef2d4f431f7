"""PyTorch port, cauchy_rowsum: the plain version (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode.  Tolerance 1e-12 of
the largest sum: the sums feed the next level's z-vector."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import symmetric_eigenvalue_tpu.kernels.pallas.cauchy_rowsum as jcr
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_rowsum as tcr


@pytest.fixture
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jcr.pl, "pallas_call", patched)


@pytest.mark.parametrize("m,r", [(64, 2), (512, 2), (64, 1)])
def test_plain_matches_interpreted_jax(interpreted, rng, m, r):
    k = 2
    poles = np.sort(rng.standard_normal((k, m)), axis=1)
    tau = np.abs(rng.standard_normal((k, m))) * 1e-3 + 1e-15
    tau[:, m // 3] = 1e-13                # near-pole root
    shift = poles.copy()
    wz = rng.standard_normal((k, r, m)) * 0.2
    got = tcr.cauchy_rowsum(torch.as_tensor(poles), torch.as_tensor(shift),
                            torch.as_tensor(tau), torch.as_tensor(wz)).numpy()
    for b in range(k):
        ref = np.asarray(jcr.cauchy_rowsum(
            jnp.asarray(poles[b]), jnp.asarray(shift[b]), jnp.asarray(tau[b]),
            jnp.asarray(wz[b])))
        rel = np.abs(got[b] - ref).max() / np.abs(ref).max()
        assert rel <= 1e-12, (m, r, b, rel)


def test_plain_blocking(rng):
    """Column blocks of the plain version give the unblocked result (to
    rounding: the block width changes the GEMM's summation order)."""
    k, m = 2, 50
    poles = np.sort(rng.standard_normal((k, m)), axis=1)
    tau = 1e-3 * rng.random((k, m))
    wz = rng.standard_normal((k, 2, m))
    args = [torch.as_tensor(a) for a in (poles, poles, tau, wz)]
    full = tcr.cauchy_rowsum(*args)
    old = tcr._PLAIN_PAIRS
    try:
        tcr._PLAIN_PAIRS = 3 * k * m
        blocked = tcr.cauchy_rowsum(*args)
        assert (blocked - full).abs().max() <= 1e-14 * full.abs().max()
    finally:
        tcr._PLAIN_PAIRS = old


def test_rejects_bad_inputs():
    p = torch.zeros((1, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        tcr.cauchy_rowsum(p, p, p, torch.zeros((1, 3, 4), dtype=torch.float64))
    with pytest.raises(TypeError):
        tcr.cauchy_rowsum(p, p, p, torch.zeros((1, 2, 4)))
