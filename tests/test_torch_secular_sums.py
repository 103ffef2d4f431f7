"""PyTorch port, secular_sums: the plain version (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode, on pair-quantised
inputs (the TPU kernel's inputs are f32 pairs).

Tolerances: S1/S1L to 1e-12 of max(|sum|, max|term|) (they decide
convergence); S2/S2L to 1e-5 of the same scale, which is the JAX kernel's
own f32 grade for them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import symmetric_eigenvalue_tpu.kernels.pallas.secular_sums as jss
from symmetric_eigenvalue_tpu_torch.kernels import secular_sums as tss


@pytest.fixture
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jss.pl, "pallas_call", patched)


def _quantize_pair(v):
    hi = v.astype(np.float32).astype(np.float64)
    lo = (v - hi).astype(np.float32).astype(np.float64)
    return hi + lo


def _inputs(rng, m, B):
    poles = _quantize_pair(np.sort(rng.standard_normal(m)))
    z2 = _quantize_pair((rng.standard_normal(m) * 0.1) ** 2)
    sl = rng.permutation(m)[:B].astype(np.int32)
    shift = poles[sl]
    tau = _quantize_pair(1e-3 * rng.random(B) + 1e-14)
    tau[5] = 1e-13                      # near-pole root
    return poles, z2, shift, tau, sl


@pytest.mark.parametrize("m,B,ti,tj", [(128, 32, 32, 64), (256, 64, 64, 128)])
def test_plain_matches_interpreted_jax(interpreted, rng, m, B, ti, tj):
    poles, z2, shift, tau, sl = _inputs(rng, m, B)
    ref = jss.secular_sums(jnp.asarray(poles), jnp.asarray(z2),
                           jnp.asarray(shift), jnp.asarray(tau),
                           jnp.asarray(sl), ti=ti, tj=tj)
    t = lambda a: torch.as_tensor(a)[None]
    got = tss.secular_sums(t(poles), t(z2), t(shift), t(tau),
                           t(sl.astype(np.int64)))
    dif = (poles[None, :] - shift[:, None]) - tau[:, None]
    t1 = z2[None, :] / dif
    t2 = t1 / dif
    sc1 = np.maximum(np.abs(t1.sum(1)), np.abs(t1).max(1))
    sc2 = np.maximum(np.abs(t2.sum(1)), np.abs(t2).max(1))
    S1, S2, S1L, S2L = (g[0].numpy() for g in got)
    J1, J2, J1L, J2L = (np.asarray(r) for r in ref)
    assert (np.abs(S1 - J1) / sc1).max() <= 1e-12
    assert (np.abs(S1L - J1L) / sc1).max() <= 1e-12
    assert (np.abs(S2 - J2) / sc2).max() <= 1e-5
    assert (np.abs(S2L - J2L) / sc2).max() <= 1e-5


def test_batched_plain_matches_per_merge(rng):
    """A (k, m) batch equals k separate calls, with root blocks smaller
    than B (the plain version's memory blocking)."""
    k, m, B = 3, 96, 40
    poles = np.sort(rng.standard_normal((k, m)), axis=1)
    z2 = rng.random((k, m))
    sl = np.stack([rng.permutation(m)[:B] for _ in range(k)])
    shift = np.take_along_axis(poles, sl, 1)
    tau = 1e-2 * rng.random((k, B))
    t = torch.as_tensor
    batch = tss.secular_sums(t(poles), t(z2), t(shift), t(tau), t(sl))
    old = tss._PLAIN_PAIRS
    try:
        tss._PLAIN_PAIRS = 7 * m
        for b in range(k):
            one = tss.secular_sums(t(poles[b:b + 1]), t(z2[b:b + 1]),
                                   t(shift[b:b + 1]), t(tau[b:b + 1]),
                                   t(sl[b:b + 1]))
            for x, y in zip(batch, one):
                assert torch.equal(x[b], y[0])
    finally:
        tss._PLAIN_PAIRS = old


def test_rejects_bad_inputs():
    p = torch.zeros((1, 4), dtype=torch.float64)
    s = torch.zeros((1, 2), dtype=torch.float64)
    sl = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        tss.secular_sums(p.float(), p, s, s, sl)
    with pytest.raises(TypeError):
        tss.secular_sums(p, p, s, s, sl.int())
    with pytest.raises(ValueError):
        tss.secular_sums(p, p, s, s[:, :1], sl)
