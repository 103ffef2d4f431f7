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


# --------------------------------------------------------------------------
# A root whose bracket freezes: the kernel's sums (compensated, in its lane
# order) are closer to the exact sum of the rounded terms than torch.sum,
# and at some roots no double meets the test |h| <= tolf * scale_h (the
# rounding of the terms (p_j - shift) - tau puts a step larger than the test
# into h).  Such a root's bracket closes to adjacent doubles; its pass then
# leaves (tau, lo, hi) unchanged, a fixed point that secular_solve ends
# instead of repeating it up to max_iters.

_LANES = 8


def _two_sum(s, c, x):
    t = s + x
    bp = t - s
    return t, c + ((s - (t - bp)) + (x - bp))


def _add_pair(s, c, so, co):
    t = s + so
    bp = t - s
    return t, (c + co) + ((s - (t - bp)) + (so - bp))


def _kernel_order_sums(poles, z2, shift, tau, sl, K):
    """csrc/secular_sums.cu's sums in its order: 8 lanes a root, lane l
    sweeping poles l, l+8, ... into compensated (TwoSum) left/right S1 and
    plain S2 sums, the lanes combined by the xor butterfly, then S1 =
    (S1L + S1R) compensated."""
    k, m = poles.shape
    B = shift.shape[1]
    acc = [torch.zeros((k, B, _LANES), dtype=torch.float64) for _ in range(6)]
    s1l, c1l, s1r, c1r, s2l, s2r = acc
    lanes = torch.arange(_LANES)
    for q in range(-(-int(K.max()) // _LANES)):
        j = q * _LANES + lanes
        valid = (j[None, :] < K[:, None])[:, None, :]
        jc = j.clamp(max=m - 1)
        dif = (poles[:, jc][:, None, :] - shift[:, :, None]) - tau[:, :, None]
        inv = 1.0 / dif
        t1 = z2[:, jc][:, None, :] * inv
        t2 = t1 * inv
        is_left = j[None, None, :] <= sl[:, :, None]
        left, right = is_left & valid, ~is_left & valid
        ns, nc = _two_sum(s1l, c1l, t1)
        s1l, c1l = torch.where(left, ns, s1l), torch.where(left, nc, c1l)
        s2l = torch.where(left, s2l + t2, s2l)
        ns, nc = _two_sum(s1r, c1r, t1)
        s1r, c1r = torch.where(right, ns, s1r), torch.where(right, nc, c1r)
        s2r = torch.where(right, s2r + t2, s2r)
    for o in (4, 2, 1):
        x = [a[..., lanes ^ o] for a in (s1l, c1l, s1r, c1r, s2l, s2r)]
        s1l, c1l = _add_pair(s1l, c1l, x[0], x[1])
        s1r, c1r = _add_pair(s1r, c1r, x[2], x[3])
        s2l, s2r = s2l + x[4], s2r + x[5]
    s, c = _add_pair(s1l[..., 0], c1l[..., 0], s1r[..., 0], c1r[..., 0])
    return (s + c, s2l[..., 0] + s2r[..., 0], s1l[..., 0] + c1l[..., 0],
            s2l[..., 0])


def _torn_merge():
    """One merge of the bottom level of a tear of bench.py's random input
    (n=16384, seed 0): rows 11392..11455 torn in two halves of 32 (theta =
    sign(beta)), each half's eigenpairs, z the halves' boundary rows."""
    import scipy.linalg
    rng = np.random.default_rng(0)
    d = rng.standard_normal(16384) * 5.0
    e = rng.standard_normal(16383) * 2.0
    r0, h = 178 * 64, 32
    d, e = d[r0:r0 + 2 * h].copy(), e[r0:r0 + 2 * h - 1]
    beta = e[h - 1]
    theta = -1.0 if beta < 0 else 1.0
    d[h - 1] -= theta * beta
    d[h] -= beta / theta
    w1, Q1 = scipy.linalg.eigh_tridiagonal(d[:h], e[:h - 1])
    w2, Q2 = scipy.linalg.eigh_tridiagonal(d[h:], e[h:])
    return (np.concatenate([w1, w2]), np.concatenate([Q1[-1], Q2[0] / theta]),
            abs(beta))


def _spread_merge():
    """The first merge of a level that deflates little (m=2048: each half's
    eigenvalues standard normal, z unit boundary rows, seed 6)."""
    g = np.random.default_rng(6)
    k, m, h = 4, 2048, 1024
    lam = np.concatenate([np.sort(g.standard_normal((k, h)), axis=1),
                          np.sort(g.standard_normal((k, m - h)), axis=1)],
                         axis=1)
    z = g.standard_normal((k, m))
    z[:, :h] /= np.linalg.norm(z[:, :h], axis=1, keepdims=True)
    z[:, h:] /= np.linalg.norm(z[:, h:], axis=1, keepdims=True)
    return lam[0], z[0], abs(g.standard_normal(k))[0] + 0.5


@pytest.mark.parametrize("merge", [_torn_merge, _spread_merge])
def test_frozen_bracket_ends_at_its_fixed_point(merge):
    """With the kernel's sums, some root ends above the test on a frozen
    bracket, yet before max_iters; tau stays within 1e-11 |tau| of the
    plain loop's, and the summed sweeps within 1% of its, or two a root
    that ended on its fixed point (the pass that closes the bracket and the
    one that finds it closed) on a merge of a few dozen roots."""
    from symmetric_eigenvalue_tpu_torch.config import SolverConfig
    lam, z, rho = merge()
    cfg = SolverConfig()
    eps = cfg.eps()
    tolf = cfg.secular_tol_factor * eps
    t = lambda a: torch.as_tensor(np.atleast_2d(a), dtype=torch.float64)
    part = tsec.merge_partition(t(lam), t(z), t(rho).reshape(1), eps=eps,
                                deflation_factor=cfg.deflation_factor)
    m = part.poles_sec.shape[1]
    act = torch.arange(m)[None, :] < part.K[:, None]
    setup, _ = tsec._root_setup(part.poles_sec, part.zu, part.rho_e, part.K,
                                act)
    mi = cfg.max_secular_iters
    tau_p, it_p = tss.secular_solve_plain(setup, tolf, mi)
    tau_k, it_k = tss.secular_solve_plain(setup, tolf, mi,
                                          sums=_kernel_order_sums)
    assert int(it_k.max()) < mi and int(it_p.max()) < mi
    rel = ((tau_k - tau_p).abs() / tau_p.abs())[act]
    assert float(rel.max()) <= 1e-11
    # h at the kernel-order tau: some root ended without meeting the test
    sl = torch.arange(m)[None, :]
    S1 = _kernel_order_sums(setup.poles_sec, setup.zu2, setup.shift_val,
                            tau_k, sl, setup.K)[0]
    S1o = S1 - setup.zs2 * (1.0 / -tau_k)
    rz = setup.rho_e[:, None] * setup.zs2
    h = tau_k * (1.0 + setup.rho_e[:, None] * S1o) - rz
    scale_h = tau_k.abs() * (1.0 + setup.rho_e.abs()[:, None] * S1o.abs()) + rz
    fixed = int(((h.abs() > tolf * scale_h) & act).sum())
    assert fixed > 0
    extra = abs(int(it_k.sum()) - int(it_p.sum()))
    assert extra <= max(0.01 * int(it_p.sum()), 2 * fixed)
