"""PyTorch port, secular_sums: the plain version (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode, on pair-quantised
inputs (the TPU kernel's inputs are f32 pairs); the sweep's cut at each
merge's active count K; the input checks of secular_sums and
secular_solve.

Tolerances: S1/S1L to 1e-12 of max(|sum|, max|term|) (they decide
convergence); S2/S2L to 1e-5 of the same scale, which is the JAX kernel's
own f32 grade for them.  The K cut to 1e-15 of the full sweep: the terms it
skips are zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import symmetric_eigenvalue_tpu.kernels.pallas.secular_sums as jss
from symmetric_eigenvalue_tpu_torch.kernels import secular as tsec
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
                           t(sl.astype(np.int64)),
                           torch.tensor([m], dtype=torch.int64))
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
    K = torch.tensor([m, m - 9, 17])
    batch = tss.secular_sums(t(poles), t(z2), t(shift), t(tau), t(sl), K)
    old = tss._PLAIN_PAIRS
    try:
        tss._PLAIN_PAIRS = 7 * m
        for b in range(k):
            one = tss.secular_sums(t(poles[b:b + 1]), t(z2[b:b + 1]),
                                   t(shift[b:b + 1]), t(tau[b:b + 1]),
                                   t(sl[b:b + 1]), K[b:b + 1])
            for x, y in zip(batch, one):
                assert torch.equal(x[b], y[0])
    finally:
        tss._PLAIN_PAIRS = old


def _merge_level(rng, k, m, tiny_every=3):
    """A level's merge_partition output: random poles, every
    ``tiny_every``-th z negligible (so K < m), rho ~ 1."""
    d = torch.as_tensor(rng.standard_normal((k, m)) * 5)
    z = torch.as_tensor(rng.standard_normal((k, m)))
    z[:, ::tiny_every] *= 1e-20
    rho = torch.as_tensor(np.abs(rng.standard_normal(k)) + 0.5)
    return tsec.merge_partition(d, z, rho, eps=2.0 ** -52,
                                deflation_factor=8.0)


@pytest.mark.parametrize("k,m", [(1, 96), (4, 64)])
def test_k_cut_matches_the_full_sweep(rng, k, m):
    """The sums cut at K_b agree with the sweep over all m poles to 1e-15
    of max(|sum|, max|term|): past K, merge_partition's z is exactly 0 and
    its sentinel poles keep every term finite, so the terms cut are 0."""
    part = _merge_level(rng, k, m)
    assert bool((part.K < m).all())
    past = torch.arange(m)[None, :] >= part.K[:, None]
    assert bool((part.zu[past] == 0).all())
    z2 = part.zu * part.zu
    sl = torch.as_tensor(rng.integers(0, m, (k, m)))
    shift = part.poles_sec.gather(1, sl)
    tau = torch.as_tensor(1e-3 * rng.random((k, m)) + 1e-14)
    args = (part.poles_sec, z2, shift, tau, sl)
    cut = tss.secular_sums(*args, part.K)
    full = tss.secular_sums(*args, torch.full((k,), m))
    dif = (part.poles_sec[:, None, :] - shift[:, :, None]) - tau[:, :, None]
    t1 = z2[:, None, :] / dif
    sc = torch.maximum(t1.sum(2).abs(), t1.abs().amax(2))
    sc2 = (t1 / dif).abs().sum(2)
    for x, y, s_ in zip(cut, full, (sc, sc2, sc, sc2)):
        assert bool(torch.isfinite(x).all())
        assert float(((x - y).abs() / s_).max()) <= 1e-15


def test_rejects_bad_inputs():
    p = torch.zeros((1, 4), dtype=torch.float64)
    s = torch.zeros((1, 2), dtype=torch.float64)
    sl = torch.zeros((1, 2), dtype=torch.int64)
    K = torch.full((1,), 4)
    with pytest.raises(TypeError):
        tss.secular_sums(p.float(), p, s, s, sl, K)
    with pytest.raises(TypeError):
        tss.secular_sums(p, p, s, s, sl.int(), K)
    with pytest.raises(ValueError):
        tss.secular_sums(p, p, s, s[:, :1], sl, K)
    with pytest.raises(TypeError):
        tss.secular_sums(p, p, s, s, sl, K.int())
    with pytest.raises(ValueError):
        tss.secular_sums(p, p, s, s, sl, K[None])


def _setup(k=2, m=8):
    f = lambda: torch.zeros((k, m), dtype=torch.float64)
    return tss.RootSetup(poles_sec=f(), zu2=f(), rho_e=torch.ones(k,
                         dtype=torch.float64), K=torch.full((k,), m),
                         shift_val=f(), zs2=f(), lo=f(), hi=f(), tau0=f(),
                         delta_lo=f(), delta_hi=f(),
                         done0=torch.ones((k, m), dtype=torch.bool))


@pytest.mark.parametrize("field,bad,err", [
    ("tau0", torch.zeros((2, 7), dtype=torch.float64), ValueError),
    ("lo", torch.zeros((2, 8), dtype=torch.float32), TypeError),
    ("rho_e", torch.ones((2, 1), dtype=torch.float64), ValueError),
    ("K", torch.full((2,), 8, dtype=torch.int32), TypeError),
    ("done0", torch.ones((2, 8), dtype=torch.uint8), TypeError),
    ("zs2", torch.zeros((2, 8), dtype=torch.float64, device="meta"),
     ValueError),
])
def test_secular_solve_rejects_bad_inputs(field, bad, err):
    setup = _setup()._replace(**{field: bad})
    with pytest.raises(err):
        tss.secular_solve(setup, 1e-15, 10)


def test_secular_solve_rejects_bad_arguments():
    with pytest.raises(TypeError):
        tss.secular_solve(tuple(_setup()), 1e-15, 10)
    with pytest.raises(ValueError):
        tss.secular_solve(_setup(), 1e-15, -1)
    tau, iters = tss.secular_solve(_setup(), 1e-15, 10)   # all done: no sweep
    assert iters.dtype == torch.int32 and int(iters.sum()) == 0
    assert tss.launches == tss.solve_launches == 0
