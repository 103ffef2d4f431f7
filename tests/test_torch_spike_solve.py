"""PyTorch port, Spike solve on the CPU (the plain passes through
spike_refine) against the JAX package: its Pallas Spike kernels in
interpret mode and its XLA blocked solver, mirroring
tests/test_spike_solve.py.

Tolerances: solutions agree to 1e-11 of max|X| (same decomposition and
pivoting; the JAX kernels carry f32 pairs, ~2^-47); true residuals
||(T - lam) x - b|| <= 1e-12 max|x|; normalized near-singular solves have
residual <= 1e-11 ||T||."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import refine as jref
from symmetric_eigenvalue_tpu.kernels.pallas import spike_solve as jsp
from symmetric_eigenvalue_tpu_torch.kernels import refine as tref
from symmetric_eigenvalue_tpu_torch.kernels import shifted_solve as shs
from symmetric_eigenvalue_tpu_torch.kernels import spike_solve as tsp


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _system(rng, n, K, near_singular=False):
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) * 0.5
    if near_singular:
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        lam = np.linalg.eigvalsh(T)[rng.choice(n, K, replace=False)]
    else:
        lam = np.sort(rng.standard_normal(K)) * 2.0
    B = rng.standard_normal((n, K))
    B /= np.linalg.norm(B, axis=0, keepdims=True)
    return d, e, lam, B


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _residual(d, e, lam, B, X):
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    R = T @ X - X * lam[None, :] - B
    return np.max(np.abs(R)) / max(np.max(np.abs(X)), 1.0)


@pytest.mark.parametrize("n,K,nb", [(700, 16, 128), (1024, 40, 128),
                                    (500, 8, 96), (333, 8, 128)])
def test_matches_jax_solvers(rng, n, K, nb):
    """Unnormalized solve vs the JAX Pallas kernels (interpret) and the JAX
    XLA blocked solver; n=333 has decoupled pad rows."""
    d, e, lam, B = _system(rng, n, K)
    X = tsp.solve_shifted_tridiagonal_spike(*_t(d, e, lam, B), nb=nb).numpy()
    assert X.shape == (n, K) and X.dtype == np.float64
    assert _residual(d, e, lam, B, X) < 1e-12
    jargs = [jnp.asarray(a) for a in (d, e, lam, B)]
    Xb = np.asarray(jref.solve_shifted_tridiagonal_blocked(*jargs, nb=nb))
    assert np.abs(X - Xb).max() <= 1e-11 * np.abs(Xb).max()
    if n == 700:
        Xk = np.asarray(jsp.solve_shifted_tridiagonal_spike(
            *jargs, nb=nb, interpret=True))
        assert np.abs(X - Xk).max() <= 1e-11 * np.abs(Xk).max()


def test_near_singular_shifts(rng):
    """Shifts at eigenvalues (the inverse-iteration regime, clamped pivots):
    normalized columns are eigenvectors, the free estimate matches the
    measured residual, and the directions match the JAX kernels'."""
    n, K = 640, 8
    d, e, lam, B = _system(rng, n, K, near_singular=True)
    X, res = tsp.spike_refine(*_t(d, e, lam, B), nb=128)
    X, res = X.numpy(), res.numpy()
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    col_res = np.linalg.norm(T @ X - X * lam[None, :], axis=0)
    normT = np.max(np.abs(lam))
    assert np.max(col_res) < 1e-11 * normT
    assert np.all(np.abs(res - col_res) <= 1e-2 * np.maximum(col_res, 1e-18)
                  + 1e-15 * normT)
    assert np.max(np.abs(np.linalg.norm(X, axis=0) - 1.0)) < 1e-12
    Xj, resj = jsp.spike_refine(*(jnp.asarray(a) for a in (d, e, lam, B)),
                                nb=128, interpret=True)
    dots = np.abs(np.sum(X * np.asarray(Xj), axis=0))
    assert np.all(dots >= 1 - 1e-11)


def test_column_padding_and_f32_input(rng):
    """K not a multiple of any tile, V given as f32 (the downsweep's output,
    read without an f64 copy): same result as the f64 input."""
    n, K = 512, 40
    d, e, lam, B = _system(rng, n, K)
    B32 = B.astype(np.float32)
    X32, r32 = tsp.spike_refine(*_t(d, e, lam), torch.as_tensor(B32))
    X64, r64 = tsp.spike_refine(*_t(d, e, lam, B32.astype(np.float64)))
    assert X32.shape == (n, K)
    assert torch.equal(X32, X64)
    np.testing.assert_allclose(r32.numpy(), r64.numpy(), rtol=1e-12)
    Xu = tsp.solve_shifted_tridiagonal_spike(*_t(d, e, lam, B)).numpy()
    assert _residual(d, e, lam, B, Xu) < 1e-12


def test_chunked_matches_single(rng):
    """Multi-chunk processing (with a partial last chunk, one interface
    solve over all chunks) equals the single-chunk result."""
    n, K = 256, 2500
    d, e, lam, B = _system(rng, n, K)
    X1, r1 = tsp.spike_refine(*_t(d, e, lam, B), nb=128, chunk=4096)
    X2, r2 = tsp.spike_refine(*_t(d, e, lam, B), nb=128, chunk=1000)
    np.testing.assert_allclose(X1.numpy(), X2.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), rtol=1e-10, atol=0)


def test_clip_flags_residual_estimate(rng, monkeypatch):
    """A back substitution that hits the +-2^80 clip (lowered to 1e4 here)
    is not a solution: its estimate must be the 1e30 sentinel, as the JAX
    kernels report, and its output still finite unit vectors."""
    monkeypatch.setattr(shs, "_BIG", 1e4)
    monkeypatch.setattr(tsp, "_BIG", 1e4)
    monkeypatch.setattr(jsp, "_BIG", 1e4)
    n, K, nb = 384, 6, 48
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) * 0.5
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    w, Q = np.linalg.eigh(T)
    idx = np.linspace(10, n - 10, K).astype(int)
    lam = w[idx]
    B = Q[:, idx] + rng.standard_normal((n, K)) * 1e-8
    B /= np.linalg.norm(B, axis=0, keepdims=True)
    X, res = tsp.spike_refine(*_t(d, e, lam, B), nb=nb)
    assert np.all(res.numpy() >= 1e29), res
    X = X.numpy()
    assert np.all(np.isfinite(X))
    np.testing.assert_allclose(np.linalg.norm(X, axis=0), 1.0, atol=1e-9)
    _, resj = jsp.spike_refine(*(jnp.asarray(a) for a in (d, e, lam, B)),
                               nb=nb, interpret=True)
    assert np.all(np.asarray(resj) >= 1e29)


def test_passes_match_block_lu(rng):
    """Pass A's six boundary values and pass B's folded solve are exactly
    the block LU of shifted_solve._block_lu_solve, and together with the
    interface solve they reproduce the reconstruction of the blocked
    solver."""
    n, K, nb = 300, 5, 64
    d, e, lam, B = _system(rng, n, K)
    dt, et, lt, Bt = _t(d, e, lam, B)
    db, e_all, e_cross, ec_above, tiny = tref.band_prep(dt, et, nb)
    P = db.shape[0] // nb
    bnd = tsp.spike_pass_a(db, e_all, tiny, lt, Bt, nb)
    assert bnd.shape == (6, P, K)
    La, Fb = tsp._interface(bnd, e_cross, ec_above)
    X, mx = tsp.spike_pass_b(db, e_all, tiny, lt, Bt, nb, La, Fb, ec_above,
                             e_cross)
    assert X.shape == (P * nb, K) and mx.shape == (P, K)
    assert torch.equal(mx, X.view(P, nb, K).abs().amax(dim=1))
    Xb = tref.solve_shifted_tridiagonal_blocked(dt, et, lt, Bt, nb=nb)
    assert (X[:n] - Xb).abs().max() <= 1e-12 * Xb.abs().max()
    with pytest.raises(ValueError):
        tsp.spike_pass_a(db, e_all, tiny, lt, Bt[:, :3], nb)
    with pytest.raises(TypeError):
        tsp.spike_pass_a(db, e_all, tiny, lt, Bt.half(), nb)


# --------------------------------------------------------------------------
# The kernels' schedule (csrc/spike_solve.cu), modelled in PyTorch: a forward
# sweep that keeps the elimination state (a, c, r) at the first row of every
# S-row segment, then, segment by segment from the bottom, the segment's
# forward elimination re-run from its checkpoint (its factors held, as the
# kernel holds them in registers) and back-substituted into the segment
# above.  Pass A's third right-hand side, the unit load on the last row, is
# zero at every checkpoint (only the last step reads the load), so the kernel
# keeps no checkpoint of it and rebuilds its factor rr from the swap.  The
# model must equal shifted_solve._block_lu_solve bit for bit: the same
# operations on the same inputs.

def _lu_step(db, e_ext, lam, rhs, tiny, j, a, c, r):
    """Row j's pivoted elimination step, as shifted_solve._block_lu_solve
    writes it: the factors of row j and the state of row j + 1."""
    sub = e_ext[:, j, None]
    a0n = db[:, j + 1, None] - lam[None, :]
    c0n = e_ext[:, j + 1, None]
    rn = rhs[:, j + 1]
    swap = sub.abs() > a.abs()
    piv = shs._clamp_piv(torch.where(swap, sub, a), tiny)
    mlt = torch.where(swap, a / piv, sub / piv)
    u1 = torch.where(swap, a0n, c)
    sw = swap[:, None, :]
    ml = mlt[:, None, :]
    rr = torch.where(sw, rn, r)
    a_new = torch.where(swap, c - mlt * a0n, a0n - mlt * c)
    c_new = torch.where(swap, -mlt * c0n, c0n.expand_as(c))
    r_new = torch.where(sw, r - ml * rn, rn - ml * r)
    return (a_new, c_new, r_new), (piv, u1, swap, rr)


def _segment_schedule(db, eb, lam, rhs, tiny, S, last_unit=False):
    """The block solves of _block_lu_solve (same arguments) in the kernels'
    schedule with S-row segments; ``last_unit``: rhs[:, :, 2] is pass A's
    unit load on the last row, not kept at the checkpoints."""
    P, nb = db.shape
    K = lam.shape[0]
    e_ext = torch.cat([eb, eb.new_zeros((P, 1))], dim=1)
    a = db[:, 0, None] - lam[None, :]
    c = e_ext[:, 0, None].expand(P, K)
    r = rhs[:, 0]
    segments = [(g, min(g + S, nb - 1)) for g in range(0, nb - 1, S)]
    checkpoints = []
    for j0, j1 in segments:
        checkpoints.append((a, c, r[:, :2] if last_unit else r))
        for j in range(j0, j1):
            (a, c, r), _ = _lu_step(db, e_ext, lam, rhs, tiny, j, a, c, r)
    out = torch.empty(rhs.shape, dtype=rhs.dtype)
    x1 = shs._clip(r / shs._clamp_piv(a, tiny)[:, None, :])
    x2 = torch.zeros_like(x1)
    out[:, nb - 1] = x1
    for (j0, j1), (a, c, r) in zip(reversed(segments),
                                   reversed(checkpoints)):
        if last_unit:
            r = torch.cat([r, torch.zeros_like(r[:, :1])], dim=1)
        factors = []
        for j in range(j0, j1):
            (a, c, r), f = _lu_step(db, e_ext, lam, rhs, tiny, j, a, c, r)
            factors.append(f)
        for j in range(j1 - 1, j0 - 1, -1):
            piv, u1, swap, rr = factors[j - j0]
            if last_unit:
                # the load's rr: swap ? (1 on the last row, else 0) : +0
                unit = torch.where(swap & (j + 1 == nb - 1), 1.0, 0.0)
                rr = torch.cat([rr[:, :2], unit[:, None]], dim=1)
            u2 = torch.where(swap, e_ext[:, j + 1, None], 0.0)
            x = shs._clip((rr - u1[:, None, :] * x1 - u2[:, None, :] * x2)
                           / piv[:, None, :])
            out[:, j] = x
            x1, x2 = x, x1
    return out


def _pass_rhs(db, e_all, nb, V, La=None, Fb=None, ec_above=None,
              e_cross=None):
    """Pass A's right-hand sides (P, nb, 3, K) (v, unit loads on the first
    and last rows) or, given the couplings, pass B's (P, nb, 1, K) with
    them folded into the first and last rows: as the plain passes build
    them."""
    npad = db.shape[0]
    P = npad // nb
    K = V.shape[1]
    Vb = tsp._blocks(V, npad, nb)
    if La is None:
        rhs = torch.zeros((P, nb, 3, K), dtype=torch.float64)
        rhs[:, :, 0] = Vb
        rhs[:, 0, 1] = 1.0
        rhs[:, nb - 1, 2] = 1.0
        return rhs
    rows = torch.arange(nb)[None, :, None]
    fold = (torch.where(rows == 0, (ec_above[:, None] * La)[:, None, :], 0.0)
            + torch.where(rows == nb - 1,
                          (e_cross[:, None] * Fb)[:, None, :], 0.0))
    return (Vb - fold)[:, :, None, :]


def _check_schedule(d, e, lam, V, nb, S):
    dt, et, lt = _t(d, e, lam)
    db, e_all, e_cross, ec_above, tiny = tref.band_prep(dt, et, nb)
    P = db.shape[0] // nb
    band = (db.view(P, nb), e_all.view(P, nb)[:, :nb - 1], lt)
    rhs_a = _pass_rhs(db, e_all, nb, V)
    want_a = shs._block_lu_solve(*band, rhs_a, tiny)
    got_a = _segment_schedule(*band, rhs_a, tiny, S, last_unit=True)
    assert torch.equal(got_a, want_a)
    bnd = tsp.spike_pass_a(db, e_all, tiny, lt, V, nb)
    La, Fb = tsp._interface(bnd, e_cross, ec_above)
    rhs_b = _pass_rhs(db, e_all, nb, V, La, Fb, ec_above, e_cross)
    want_b = shs._block_lu_solve(*band, rhs_b, tiny)
    assert torch.equal(_segment_schedule(*band, rhs_b, tiny, S), want_b)
    X, mx = tsp.spike_pass_b(db, e_all, tiny, lt, V, nb, La, Fb, ec_above,
                             e_cross)
    assert torch.equal(X, want_b[:, :, 0].reshape(-1, lam.shape[0]))
    # the block LU instance: pass A's schedule with every row written, the
    # unit loads' solutions scaled by their couplers
    K = lam.shape[0]
    u, p, q = shs.block_lu_solve(db, e_all, tiny, ec_above, e_cross, lt,
                                 V.to(torch.float64), nb)
    assert torch.equal(u, got_a[:, :, 0].reshape(-1, K))
    assert torch.equal(p, (got_a[:, :, 1] * ec_above[:, None, None])
                       .reshape(-1, K))
    assert torch.equal(q, (got_a[:, :, 2] * e_cross[:, None, None])
                       .reshape(-1, K))
    return want_a


@pytest.mark.parametrize("nb,S", [(128, 1), (128, 3), (128, 8), (128, 16),
                                  (128, 128), (100, 8), (100, 16), (45, 16),
                                  (2, 1), (2, 8)])
@pytest.mark.parametrize("shifts", ["random", "eigenvalues"])
def test_segment_schedule_is_block_lu(rng, monkeypatch, nb, S, shifts):
    """Checkpoints every S rows and re-elimination per segment give the
    block LU's solutions bit for bit, for S dividing nb or not, S = nb and
    nb = 2, with shifts at random and on eigenvalues, V f32 and f64.  On
    eigenvalues, rows 1 and n-2 are decoupled (their couplings zero), so
    their diagonal entries are exact eigenvalues and two columns' shifts sit
    on them: an exactly zero pivot, floored at +-tiny."""
    n, K = max(3 * nb + nb // 2 + 1, 41), 12
    d, e, lam, B = _system(rng, n, K, near_singular=shifts == "eigenvalues")
    floored = []
    if shifts == "eigenvalues":
        e[[0, 1, n - 3, n - 2]] = 0.0
        lam[:2] = d[1], d[n - 2]
        clamp = shs._clamp_piv

        def counted(piv, tiny):
            floored.append(int((piv.abs() < tiny).sum()))
            return clamp(piv, tiny)

        monkeypatch.setattr(shs, "_clamp_piv", counted)
    for V in (torch.as_tensor(B), torch.as_tensor(B.astype(np.float32))):
        _check_schedule(d, e, lam, V, nb, S)
    assert (sum(floored) > 0) == (shifts == "eigenvalues")


@pytest.mark.parametrize("S", [3, 8, 16])
def test_segment_schedule_clip_case(rng, monkeypatch, S):
    """The back substitution of test_clip_flags_residual_estimate (clip at
    1e4, so the cascade hits it) through the segment schedule: bit for bit
    the block LU's, clipped values included."""
    monkeypatch.setattr(shs, "_BIG", 1e4)
    n, K, nb = 384, 6, 48
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1) * 0.5
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    w, Q = np.linalg.eigh(T)
    idx = np.linspace(10, n - 10, K).astype(int)
    B = Q[:, idx] + rng.standard_normal((n, K)) * 1e-8
    B /= np.linalg.norm(B, axis=0, keepdims=True)
    sol = _check_schedule(d, e, w[idx], torch.as_tensor(B), nb, S)
    assert bool((sol.abs() == 1e4).any())


def _resident(regs):
    """Blocks an SM holds, modelled as the occupancy API counts them on an
    H100: four quarters of 16K registers, each holding whole warps (a
    warp's registers in units of 256), 228 KB of shared memory with 1 KB
    reserved a block, at most 32 blocks and 2048 threads."""
    def blocks(threads, smem):
        warp_regs = -(-regs * 32 // 256) * 256
        by_regs = 4 * (16384 // warp_regs) // (threads // 32)
        by_smem = 233472 // (smem + 1024)
        return min(by_regs, by_smem, 32, 2048 // threads)
    return blocks


@pytest.mark.parametrize("which,nb,regs,threads", [
    ("A", 128, 158, 128), ("B", 128, 144, 128), ("A", 96, 158, 128),
    ("A", 600, 158, 64), ("B", 2, 100, 128)])
def test_launch_plan(which, nb, regs, threads):
    """The plan: the kernel's segment S, one checkpoint a segment, the block
    width that puts the most threads on an SM (the wider on a tie), and the
    shared memory of the band and the checkpoints."""
    plan = tsp.launch_plan(nb, which, _resident(regs))
    assert plan.segment == tsp._SEGMENT
    assert plan.checkpoints == -(-(nb - 1) // plan.segment)
    assert plan.threads == threads
    fields = 4 if which == "A" else 3
    assert plan.shared_bytes == 8 * (2 * nb + plan.checkpoints * fields
                                     * plan.threads)
    assert plan.shared_bytes == tsp.shared_bytes(nb, which, plan.threads)
    assert plan.blocks_per_sm == _resident(regs)(plan.threads,
                                                 plan.shared_bytes) > 0


def test_launch_plan_rejects_blocks_that_do_not_fit():
    """A block size whose checkpoints exceed a block's shared memory at
    every width raises (the CPU never asks for a plan)."""
    with pytest.raises(ValueError):
        tsp.launch_plan(8000, "A", _resident(158))
    assert tsp.launch_plan(1, "B", _resident(144)).checkpoints == 0
