"""PyTorch port, cauchy_rowsum: the plain version (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode, the cut at each merge's
active count K, and a CPU model of the CUDA kernel's summation order (pole
lanes, splits, combine).  Tolerance 1e-12 of the largest sum: the sums feed
the next level's z-vector."""

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
    """With K = m: the JAX kernel has no K and sums every slot."""
    k = 2
    poles = np.sort(rng.standard_normal((k, m)), axis=1)
    tau = np.abs(rng.standard_normal((k, m))) * 1e-3 + 1e-15
    tau[:, m // 3] = 1e-13                # near-pole root
    shift = poles.copy()
    wz = rng.standard_normal((k, r, m)) * 0.2
    K = torch.full((k,), m, dtype=torch.int64)
    got = tcr.cauchy_rowsum(torch.as_tensor(poles), torch.as_tensor(shift),
                            torch.as_tensor(tau), torch.as_tensor(wz),
                            K).numpy()
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
    args.append(torch.full((k,), m, dtype=torch.int64))
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
    K = torch.full((1,), 4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tcr.cauchy_rowsum(p, p, p, torch.zeros((1, 3, 4), dtype=torch.float64),
                          K)
    with pytest.raises(TypeError):
        tcr.cauchy_rowsum(p, p, p, torch.zeros((1, 2, 4)), K)


@pytest.mark.parametrize("bad,err", [
    (torch.full((2,), 4, dtype=torch.int64), ValueError),        # shape
    (torch.full((1, 1), 4, dtype=torch.int64), ValueError),      # shape
    (torch.full((1,), 4, dtype=torch.int32), TypeError),         # dtype
    (torch.full((1,), 4.0, dtype=torch.float64), TypeError),     # dtype
    (torch.empty((1,), dtype=torch.int64, device="meta"), ValueError),  # device
])
def test_rejects_bad_k(bad, err):
    p = torch.zeros((1, 4), dtype=torch.float64)
    wz = torch.zeros((1, 2, 4), dtype=torch.float64)
    with pytest.raises(err):
        tcr.cauchy_rowsum(p, p, p, wz, bad)


def _level(rng, k, m, r, kact):
    """Poles ascending, every root's shift its own pole and tau inside the
    gap (so every denominator is nonzero), a few roots 1e-13 from their
    pole, and wz 0 past each merge's K (as the caller's zhat is)."""
    poles = np.sort(rng.standard_normal((k, m)), axis=1)
    gaps = np.diff(poles, axis=1, append=poles[:, -1:] + 1.0)
    tau = 0.45 * gaps * rng.random((k, m)) + 1e-15
    tau[:, ::97] = 1e-13
    wz = 0.2 * rng.standard_normal((k, r, m))
    wz *= np.arange(m)[None, None, :] < np.asarray(kact)[:, None, None]
    t = torch.as_tensor
    return (t(poles), t(poles), t(tau), t(wz),
            torch.as_tensor(kact, dtype=torch.int64))


@pytest.mark.parametrize("r", [1, 2])
def test_k_cut_is_exact(rng, r):
    """Columns at or past K are 0; the columns below K agree with the K = m
    result (the plain bmm may sum in another order: 1e-14 relative)."""
    k, m = 3, 300
    kact = [100, 1, 0]
    args = _level(rng, k, m, r, kact)
    cut = tcr.cauchy_rowsum(*args)
    full = tcr.cauchy_rowsum(*args[:4], torch.full((k,), m, dtype=torch.int64))
    for b, kb in enumerate(kact):
        assert not cut[b, :, kb:].any()
        if kb:
            d = (cut[b, :, :kb] - full[b, :, :kb]).abs().max()
            assert d <= 1e-14 * full[b, :, :kb].abs().max(), (b, float(d))


def _two_sum(s, c, x):
    t = s + x
    bp = t - s
    return t, c + ((s - (t - bp)) + (x - bp))


def _add_pair(s, c, so, co):
    t = s + so
    bp = t - s
    return t, (c + co) + ((s - (t - bp)) + (so - bp))


def _kernel_order_rowsum(poles, shift, tau, wz, K, plan):
    """csrc/cauchy_rowsum.cu's sums in its order.  The poles are cut into
    ``plan.splits`` chunks of ``plan.chunk``; in a chunk starting at j0, lane
    l (of 8) adds the terms of poles j0 + l, j0 + l + 8, ... below K by
    TwoSum (a thread's 4 columns are independent chains: they change no
    order); the lanes are combined by the xor butterfly (4, 2, 1) of
    compensated adds; the splits that hold a pole below K are added in
    split order to the first (S, C) and the result is S + C; columns at or
    past K are 0."""
    k, r, m = wz.shape
    L = tcr.LANES
    lanes = torch.arange(L)
    Kc = K.clamp(0, m)
    parts = []
    for sp in range(plan.splits):
        j0, j1 = sp * plan.chunk, min(m, (sp + 1) * plan.chunk)
        s = torch.zeros((k, r, m, L), dtype=torch.float64)
        c = torch.zeros_like(s)
        for q in range(-(-(j1 - j0) // L)):
            j = j0 + q * L + lanes
            valid = (j[None, :] < j1) & (j[None, :] < Kc[:, None])
            jc = j.clamp(max=m - 1)
            dif = ((poles[:, jc][:, None, :] - shift[:, :, None])
                   - tau[:, :, None])
            x = wz[:, :, jc][:, :, None, :] * (1.0 / dif)[:, None, :, :]
            ns, nc = _two_sum(s, c, x)
            v = valid[:, None, None, :]
            s, c = torch.where(v, ns, s), torch.where(v, nc, c)
        for o in (4, 2, 1):
            s, c = _add_pair(s, c, s[..., lanes ^ o], c[..., lanes ^ o])
        parts.append((s[..., 0], c[..., 0]))
    S, C = parts[0]
    for sp in range(1, plan.splits):
        act = (sp * plan.chunk < Kc)[:, None, None]
        nS, nC = _add_pair(S, C, *parts[sp])
        S, C = torch.where(act, nS, S), torch.where(act, nC, C)
    live = (torch.arange(m)[None, :] < Kc[:, None])[:, None, :]
    return torch.where(live, S + C, 0.0)


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_kernel_order_k_cut_is_bit_exact(rng, r, splits):
    """The kernel's order, modelled on the CPU: with K < m (wz 0 past K) the
    columns below K are bit for bit the K = m result of the same plan, and
    both agree with the plain version to 1e-12 of max|S|."""
    k, m = 3, 600
    kact = [600, 131, 7]
    args = _level(rng, k, m, r, kact)
    chunk = -(-m // splits)
    plan = tcr.Plan(-(-m // chunk), chunk)
    full_K = torch.full((k,), m, dtype=torch.int64)
    got = _kernel_order_rowsum(*args, plan)
    full = _kernel_order_rowsum(*args[:4], full_K, plan)
    for b, kb in enumerate(kact):
        assert torch.equal(got[b, :, :kb], full[b, :, :kb]), b
        assert not got[b, :, kb:].any()
    for K, model in ((args[4], got), (full_K, full)):
        ref = tcr.cauchy_rowsum_plain(*args[:4], K)
        err = (model - ref).abs().max() / ref.abs().max()
        assert err <= 1e-12, float(err)


@pytest.mark.parametrize("k,m", [(256, 64), (32, 512), (16, 1024),
                                 (2, 8192), (1, 16384), (3, 1000)])
@pytest.mark.parametrize("per_sm", [1, 2, 4])
def test_launch_plan(k, m, per_sm):
    """The splits cover the poles with none empty, each at least a tile,
    and their count is the smallest that makes four waves of the card's
    132 * per_sm slots, the last one 90% full (else the most splits)."""
    plan = tcr.launch_plan(k, m, 132, per_sm)
    assert plan.splits * plan.chunk >= m > (plan.splits - 1) * plan.chunk
    assert plan.splits == 1 or plan.chunk >= tcr.MIN_SPLIT_POLES
    cap = 132 * per_sm

    def ok(s):
        blocks = k * -(-m // tcr.COLS) * s
        return blocks >= 4 * cap and blocks >= 0.9 * -(-blocks // cap) * cap

    counts = range(1, max(1, m // tcr.MIN_SPLIT_POLES) + 1)
    good = [s for s in counts if ok(s)]
    assert plan.splits == (good[0] if good else counts[-1])
