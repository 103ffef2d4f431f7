"""PyTorch port, the refinement's scan recurrences as kernels
(kernels/shifted_solve.py) on the CPU: the plain versions against the loops
they replace and against the JAX package's kernels/refine.py, a model of
the interface kernel's storage order, the triage built on them against the
JAX package's, and the wrappers' dispatch.

Tolerances: the plain versions are today's loops, so they equal their
compositions exactly; against the JAX functions 1e-13 of the result's max
(the same pivoting; XLA may contract a multiply-add where PyTorch does
not).  The triage's columns are inverse-iteration solves at shifts on the
eigenvalues: their sign is the rounding's, so they are compared up to sign,
to 1e-13."""

import contextlib
import ctypes
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
from symmetric_eigenvalue_tpu import driver as jdrv
from symmetric_eigenvalue_tpu.kernels import refine as jref
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu_torch import _build, driver as tdrv
from symmetric_eigenvalue_tpu_torch.core.tridiag import residual_norms
from symmetric_eigenvalue_tpu_torch.kernels import refine as tref
from symmetric_eigenvalue_tpu_torch.kernels import shifted_solve as shs
from symmetric_eigenvalue_tpu_torch.kernels import spike_solve as tsp
from symmetric_eigenvalue_tpu_torch.utils.timing import PhaseTimer

CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def _band(rng, n, nb):
    d = rng.standard_normal(n) * 2.0
    e = rng.standard_normal(n - 1)
    return tref.band_prep(*_t(d, e), nb)


@pytest.mark.parametrize("n,nb", [(300, 64), (333, 96), (517, 128)])
def test_block_lu_plain_is_the_stacked_solve(rng, n, nb):
    """block_lu_solve's plain version (unit loads generated, outputs
    scaled) is exactly the blocked solver's former composition: the three
    right-hand sides stacked through _block_lu_solve, then the unit-load
    solutions scaled by their couplers.  That _block_lu_solve is within
    1e-13 of the JAX package's is test_torch_refine.py::
    test_block_lu_solve."""
    K = 5
    db, e_all, e_cross, ec_above, tiny = _band(rng, n, nb)
    lam = torch.as_tensor(rng.standard_normal(K) * 2.0)
    V = torch.as_tensor(rng.standard_normal((n, K)))
    u, p, q = shs.block_lu_solve(db, e_all, tiny, ec_above, e_cross, lam, V,
                                 nb)
    npad = db.shape[0]
    P = npad // nb
    rhs = torch.zeros((P, nb, 3, K), dtype=torch.float64)
    rhs[:, :, 0] = torch.cat([V, V.new_zeros((npad - n, K))]).view(P, nb, K)
    rhs[:, 0, 1] = 1.0
    rhs[:, nb - 1, 2] = 1.0
    band = (db.view(P, nb), e_all.view(P, nb)[:, :nb - 1])
    sol = shs._block_lu_solve(*band, lam, rhs, tiny)
    assert torch.equal(u, sol[:, :, 0].reshape(npad, K))
    assert torch.equal(p, (sol[:, :, 1] * ec_above[:, None, None])
                       .reshape(npad, K))
    assert torch.equal(q, (sol[:, :, 2] * e_cross[:, None, None])
                       .reshape(npad, K))


def _interface_inputs(rng, P, K):
    return [torch.as_tensor(rng.standard_normal((P, K)) * 0.3)
            for _ in range(4)] + \
        [torch.as_tensor(rng.standard_normal((P, K))) for _ in range(2)]


def test_interface_plain_is_the_spike_interface(rng):
    """The fused plain interface (couplers' products, both sweeps, the
    shift) is exactly what the Spike pass computed before it was one
    launch: the scaled inputs through the unscaled loop, then the
    neighbour rows; and within 1e-13 of the JAX interface_solve."""
    P, K = 20, 6
    bnd = _interface_inputs(rng, P, K)
    ec = torch.as_tensor(rng.standard_normal(P) * 0.5)
    ecr = torch.as_tensor(rng.standard_normal(P) * 0.5)
    Fb, La = shs.interface_solve(*bnd[:4], *bnd[4:], ec_above=ec,
                                 e_cross=ecr, shifted=True)
    scaled = [bnd[0] * ec[:, None], bnd[1] * ec[:, None],
              bnd[2] * ecr[:, None], bnd[3] * ecr[:, None], *bnd[4:]]
    F, L = shs.interface_solve(*scaled)
    assert torch.equal(La, torch.cat([L.new_zeros((1, K)), L[:-1]]))
    assert torch.equal(Fb, torch.cat([F[1:], F.new_zeros((1, K))]))
    # the Spike pass's own entry point, on pass A's (6, P, K) layout
    packed = torch.stack([bnd[4], bnd[5], bnd[0], bnd[1], bnd[2], bnd[3]])
    La2, Fb2 = tsp._interface(packed, ecr, ec)
    assert torch.equal(La2, La) and torch.equal(Fb2, Fb)
    Fj, Lj = jref.interface_solve(*(jnp.asarray(t.numpy()) for t in scaled))
    _close(F, Fj, 1e-13)
    _close(L, Lj, 1e-13)


# the cards the interface model runs on: (SMs, shared bytes an SM holds, a
# block may opt into): the H100's, then one whose small shared memory makes
# the ring keep only some rows' forward values, then none
_IF_CARDS = ((132, 233472, 232448), (1, 40 * 1024, 40 * 1024),
             (1, 32 * 1024, 32 * 1024))


def _kernel_model(ins, sp, sq, shifted, card=_IF_CARDS[0]):
    """csrc/interface_solve.cu in numpy (IEEE f64, each operation rounded,
    no FMA; d11 / det taken as 1 where det is a finite d11), a block of
    threads (plan.nc columns, one a lane, vectorised)
    at a time under shs.interface_plan on ``card``: the input rows staged
    whole or through a ring of 7 rows copied 6 ahead (a slot refilled the
    step after its read); the forward values of rows >= P - ps kept in
    "shared memory", those below in F's and L's storage slots (shifted by
    one block with ``shifted``) and the G scratch; the back sweep over the
    shared rows, then the global rows in batches (the ring's two halves, 5
    rows each), copied two batches ahead (the first two before the shared
    rows); the same end rows."""
    pf, pl, qf, ql, uf, ul = (t.numpy() for t in ins)
    P, K = uf.shape
    plan = shs.interface_plan(P, K, *card)
    ahead, ring_rows = shs._IF_RING - 1, shs._IF_RING
    nb = P - plan.ps
    Fo, Lo = np.full((P, K), np.nan), np.full((P, K), np.nan)
    G11, G21 = np.full((nb, K), np.nan), np.full((nb, K), np.nan)
    src = np.stack([pf, pl, qf, ql, uf, ul])              # (6, P, K)

    def fslot(b):
        return (b + P - 1) % P if shifted else b

    def lslot(b):
        return (b + 1) % P if shifted else b

    tiny2 = 2.0 ** -96
    for c0 in range(0, K, plan.nc):
        cols = slice(c0, min(c0 + plan.nc, K))
        if plan.whole:
            ring = src[:, :, cols].copy()                   # every row at once
        else:
            ring = np.full((6, ring_rows, cols.stop - c0), np.nan)
            for j in range(min(ahead, P)):
                ring[:, j] = src[:, j, cols]
        fw = np.full((4, plan.ps, cols.stop - c0), np.nan)
        g21 = h2 = np.zeros(cols.stop - c0)
        slot = 0
        for b in range(P):
            cur = ring[:, b if plan.whole else slot].copy()
            if not plan.whole:
                nxt = (slot + ahead) % ring_rows
                ring[:, nxt] = np.nan                        # the slot's old row
                if b + ahead < P:
                    ring[:, nxt] = src[:, b + ahead, cols]
                slot = (slot + 1) % ring_rows
            a_pf, a_pl, a_qf, a_ql, a_uf, a_ul = cur
            if sp is not None:
                a_pf, a_pl = a_pf * float(sp[b]), a_pl * float(sp[b])
            if sq is not None:
                a_qf, a_ql = a_qf * float(sq[b]), a_ql * float(sq[b])
            d11 = 1.0 - a_pf * g21
            det = np.where(np.abs(d11) < tiny2,
                           np.where(d11 < 0, -tiny2, tiny2), d11)
            # the kernel skips d11 / det where it is d11 / d11 = 1 exactly
            with np.errstate(invalid="ignore", divide="ignore"):
                i22 = np.where((det == d11) & np.isfinite(d11), 1.0,
                               d11 / det)
            i11, i21 = 1.0 / det, (a_pl * g21) / det
            r1 = a_uf - a_pf * h2
            r2 = a_ul - a_pl * h2
            h1 = i11 * r1
            h2 = i21 * r1 + i22 * r2
            g11 = i11 * a_qf
            g21 = i21 * a_qf + i22 * a_ql
            if b >= nb:
                fw[:, b - nb] = (h1, h2, g11, g21)
            else:
                Fo[fslot(b), cols], Lo[lslot(b), cols] = h1, h2
                G11[b, cols], G21[b, cols] = g11, g21

        back_rows = ring_rows * 6 // 8             # kBack: rows a half holds
        halves = np.full((2, back_rows, 4, cols.stop - c0), np.nan)

        def copy_back(batch):
            halves[batch & 1] = np.nan
            for u in range(back_rows):
                b = nb - 1 - batch * back_rows - u
                if b < 0:
                    break
                halves[batch & 1, u] = (Fo[fslot(b), cols], Lo[lslot(b), cols],
                                        G11[b, cols], G21[b, cols])

        if not plan.whole and nb > 0:
            copy_back(0)
            copy_back(1)
        f_next = np.zeros(cols.stop - c0)

        def back(b, h1, hh2, g11, gg21):
            nonlocal f_next
            F = h1 - g11 * f_next
            L = hh2 - gg21 * f_next
            Fo[fslot(b), cols] = 0.0 if shifted and b == 0 else F
            Lo[lslot(b), cols] = 0.0 if shifted and b == P - 1 else L
            f_next = F

        for b in range(P - 1, nb - 1, -1):
            back(b, *fw[:, b - nb])
        batch = 0
        while batch * back_rows < nb:
            rows = halves[batch & 1].copy()
            for u in range(back_rows):
                b = nb - 1 - batch * back_rows - u
                if b < 0:
                    break
                back(b, *rows[u])
            copy_back(batch + 2)
            batch += 1
    return Fo, Lo


@pytest.mark.parametrize("P", [1, 2, 127, 171, 256])
@pytest.mark.parametrize("K", [1, 5, 33, 300])
@pytest.mark.parametrize("shifted", [False, True])
def test_interface_kernel_order_is_the_plain_loop(rng, P, K, shifted):
    """The kernel's schedule (one column a thread; input rows staged whole
    or through the ring; the last rows' forward values in shared memory,
    the rest in the outputs' slots and the scratch, copied back ahead of
    the back sweep) gives the plain version's values bit for bit, with and
    without the couplers and the shift, on every model card (the whole,
    the partial and the empty shared rows), and with a column whose d11
    is exactly 0 (floored to +2^-96)."""
    ins = _interface_inputs(rng, P, K)
    sp = torch.as_tensor(rng.standard_normal(P))
    sq = torch.as_tensor(rng.standard_normal(P))
    if P > 1:
        # column 0: g21 after block 0 is ql[0] sq[0] = 2, and pf[1] sp[1]
        # = 0.5, so block 1's d11 = 1 - 0.5 * 2 = 0
        ins[3][0, 0], ins[0][1, 0], sq[0], sp[1] = 2.0, 0.5, 1.0, 1.0
    for scales in ((None, None), (sp, sq)):
        want = shs.interface_solve(*ins, ec_above=scales[0],
                                   e_cross=scales[1], shifted=shifted)
        for card in _IF_CARDS:
            got = _kernel_model(ins, *scales, shifted, card)
            assert np.array_equal(got[0], want[0].numpy())
            assert np.array_equal(got[1], want[1].numpy())
    if P > 1:       # the floor's case was built: block 1's d11 is 0
        assert 1.0 - float(ins[0][1, 0]) * float(ins[3][0, 0]) == 0.0


def test_interface_plan():
    """interface_plan on the H100's figures: every block of threads
    resident at once; the triage's shapes (P=171 and 256, K=5) staged
    whole in one block of threads; the Spike pass's P=128, K=16384 through
    the ring with part of its rows' forward values in shared memory; the
    bytes always the kernel's formula (8 (2 P + rows 6 nc + 4 ps nc)) and
    within what a block may opt into; the source's constants."""
    text = (CSRC / "interface_solve.cu").read_text()
    assert int(re.search(r"kThreads = (\d+);", text).group(1)) \
        == shs._IF_THREADS
    ahead = int(re.search(r"kAhead = (\d+);", text).group(1))
    assert re.search(r"kRing = kAhead \+ 1;", text) \
        and shs._IF_RING == ahead + 1
    sms, per_sm, optin = _IF_CARDS[0]
    for P, K in ((171, 5), (256, 5)):
        plan = shs.interface_plan(P, K, sms, per_sm, optin)
        assert plan.whole and plan.ps == P and plan.nc == K
    spike = shs.interface_plan(128, 16384, sms, per_sm, optin)
    assert not spike.whole and 0 < spike.ps < 128 and spike.nc == 64
    assert -(-spike.blocks // sms) * (spike.smem + 1024) <= per_sm
    for P in (1, 2, 64, 128, 171, 256, 1024):
        for K in (1, 5, 33, 300, 2048, 16384, 65536):
            for card in _IF_CARDS if P <= 256 else _IF_CARDS[:1]:
                plan = shs.interface_plan(P, K, *card)
                rows = P if plan.whole else shs._IF_RING
                assert plan.smem == 8 * (2 * P + rows * 6 * plan.nc
                                         + 4 * plan.ps * plan.nc)
                assert plan.smem <= card[2] and 0 <= plan.ps <= P
                assert plan.blocks * plan.nc >= K > (plan.blocks - 1) \
                    * plan.nc
                if -(-plan.blocks // card[0]) * 1024 < card[1]:
                    assert -(-plan.blocks // card[0]) * (plan.smem + 1024) \
                        <= card[1] or plan.ps == 0


# the JAX configuration of the triage test; its one-pass refinement
# compiled at (n, K=2, nb=64) serves both tests below
_FACTOR = 14.0
_CFG_J = se.SolverConfig(refine_residual_factor=_FACTOR)


@pytest.mark.parametrize("nb", [64, 96, 128])
def test_inverse_iteration_two_steps_matches_jax(rng, nb):
    """Two inverse-iteration steps through the blocked solver's new route
    (block_lu_solve, interface_solve) at each block size the driver uses,
    n=600 a multiple of none, from f32-perturbed eigenvectors: the JAX
    pass twice gives the same directions; residuals and norms as
    test_torch_refine.py::test_inverse_iteration holds them."""
    n = 600
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    w, Q = np.linalg.eigh(T)
    cols = np.array([3, 451])
    lam = w[cols]
    V32 = (Q[:, cols] + 1e-6 * rng.standard_normal((n, 2))).astype(
        np.float32)
    X = tref.inverse_iteration(*_t(d, e, lam, V32), steps=2,
                               block=nb).numpy()
    step = jdrv._compiled_refine(n, 2, _CFG_J, nb)
    dj, ej, lj = (jnp.asarray(a) for a in (d, e, lam))
    Xj = np.asarray(step(dj, ej, lj, step(dj, ej, lj, jnp.asarray(
        V32.astype(np.float64)))))
    nT = np.abs(w).max()
    assert np.abs(T @ X - X * lam[None, :]).max() < 1e-12 * nT
    assert np.abs(np.linalg.norm(X, axis=0) - 1).max() < 1e-13
    cos = np.abs(np.sum(X * Xj, axis=0)) / (np.linalg.norm(X, axis=0)
                                           * np.linalg.norm(Xj, axis=0))
    assert np.all(cos >= 1 - 1e-12)


def _poisson(n):
    """The prescaled Poisson matrix, its spectrum and eigenvectors, and
    f32-grade columns (1e-7 noise) for a refinement to improve."""
    d, e = (np.asarray(a, dtype=np.float64)
            for a in st.create_matrix_scheme2(n))
    s = np.abs(d).max() + 2.0 * np.abs(e).max()
    d, e = d / s, e / s
    w, Q = np.linalg.eigh(np.diag(d) + np.diag(e, 1) + np.diag(e, -1))
    V = Q + 1e-7 * np.random.default_rng(3).standard_normal(Q.shape)
    return d, e, w, V / np.linalg.norm(V, axis=0)


class _Phases:
    @contextlib.contextmanager
    def phase(self, name):
        yield


def test_triage_passes_match_jax():
    """The triage's extra pass (blocked solver, nb=96) and rescue pass
    (nb=64, two steps) on the Poisson n=600 matrix with f32-grade columns
    and refine_residual_factor=14: every column is risky and improves; the
    two columns the nb=96 pass leaves above 14 eps ||T|| (its largest
    residuals, ~19 eps ||T|| against the next ~11) go to the rescue, which
    improves both.  The JAX package's triage on the same inputs rescues the
    same columns and returns the same V up to each column's sign."""
    n, fac = 600, _FACTOR
    d, e, w, V = _poisson(n)
    norm_t = float(np.abs(w).max())
    dt, et, wt, Vt = _t(d, e, w, V)
    res1 = residual_norms(dt, et, wt, Vt).numpy()
    sentinel = np.zeros(n, dtype=bool)
    cfg = st.SolverConfig(refine_residual_factor=fac)
    one_pass, resid = tdrv._refine_ops(dt, et, n, cfg)
    sub = PhaseTimer()
    got, touched = tdrv._triage_passes(dt, et, wt, Vt.clone(), res1,
                                       sentinel, norm_t, cfg, one_pass,
                                       resid, sub)
    assert sub.counts == {"risky": n, "risky_sentinel": 0,
                          "extra_improved": n, "rescue": 2,
                          "rescue_improved": 2}
    assert touched.all()
    # the JAX triage, its rescue's residual call recorded (the extra pass
    # runs fused, measuring inside its jit)
    dj, ej, wj = (jnp.asarray(a) for a in (d, e, w))
    op_j, res_j = jdrv._refine_ops(dj, ej, n, n, _CFG_J)
    calls = []

    def recorded(lam_c, V_c):
        out = res_j(lam_c, V_c)
        calls.append((np.asarray(lam_c), out))
        return out

    want, touched_j = jdrv._triage_passes(dj, ej, wj, jnp.asarray(V), res1,
                                          sentinel, norm_t, _CFG_J, op_j,
                                          recorded, _Phases(), False)
    assert np.array_equal(touched_j, touched)
    assert len(calls) == 1                      # the rescue, 2 columns
    lam_r, res2 = calls[0]
    rescued = np.searchsorted(w, lam_r)
    assert lam_r.shape == (2,) and np.array_equal(w[rescued], lam_r)
    assert (res2 < fac * 2.0 ** -52 * norm_t).all()   # both improved
    got, want = got.numpy(), np.asarray(want)
    sign = np.sign(np.sum(got * want, axis=0))
    assert np.abs(got - want * sign).max() <= 1e-13


def test_cpu_tensors_count_no_launches_and_others_raise(rng):
    """CPU tensors take the plain versions and count nothing; a tensor on
    any other device than CUDA or the CPU ('meta' here) raises at the
    launch; the wrappers take f64 only."""
    before = (shs.interface_launches, shs.block_lu_launches)
    n, nb, K = 600, 96, 3
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    lam = rng.standard_normal(K)
    B = rng.standard_normal((n, K))
    tref.inverse_iteration(*_t(d, e, lam, B), steps=2, block=nb)
    assert (shs.interface_launches, shs.block_lu_launches) == before
    meta = dict(dtype=torch.float64, device="meta")
    P = 2
    ins = [torch.empty((P, K), **meta) for _ in range(6)]
    with pytest.raises(ValueError, match="unsupported device"):
        shs.interface_solve(*ins)
    with pytest.raises(ValueError, match="unsupported device"):
        shs.block_lu_solve(torch.empty(P * nb, **meta),
                           torch.empty(P * nb, **meta),
                           torch.empty((), **meta), torch.empty(P, **meta),
                           torch.empty(P, **meta), torch.empty(K, **meta),
                           torch.empty((n // 4, K), **meta), nb)
    assert (shs.interface_launches, shs.block_lu_launches) == before
    db, e_all, e_cross, ec_above, tiny = tref.band_prep(*_t(d, e), nb)
    with pytest.raises(TypeError):
        shs.block_lu_solve(db, e_all, tiny, ec_above, e_cross,
                           *_t(lam), torch.as_tensor(B, dtype=torch.float32),
                           nb)
    with pytest.raises(TypeError):
        shs.interface_solve(*(t.float() for t in _t(*(
            rng.standard_normal((P, K)) for _ in range(6)))))


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int*": ctypes.c_void_p, "long long": ctypes.c_longlong,
            "int": ctypes.c_int}


def _c_signature(source, symbol):
    """The ctypes types of an extern "C" function's parameters, read from
    its definition in csrc/<source>.cu."""
    text = (CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, symbol
    types = []
    for param in m.group(1).split(","):
        words = " ".join(param.split()).rsplit(" ", 1)[0]
        words = words.replace(" *", "*")
        types.append(_C_TYPES[words])
    return types


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("interface_solve", "interface_solve_launch",
     shs._INTERFACE_ARGTYPES),
    ("interface_solve", "interface_solve_limits", shs._LIMITS_ARGTYPES),
    ("spike_solve", "block_lu_launch", shs._BLOCK_LU_ARGTYPES),
    ("spike_solve", "block_lu_narrow_launch", shs._NARROW_ARGTYPES),
    ("spike_solve", "block_lu_narrow_info", shs._NARROW_INFO_ARGTYPES),
    ("spike_solve", "spike_pass_a_launch", tsp._ARGTYPES_A),
    ("spike_solve", "spike_pass_b_launch", tsp._ARGTYPES_B),
    ("spike_solve", "spike_kernel_info", shs._INFO_ARGTYPES)])
def test_bindings_match_the_sources(source, symbol, argtypes):
    """Every wrapper's ctypes argument list is its C function's (a pointer
    passed as an int would be cut to 32 bits on the card), and the new
    source is one _build builds."""
    assert _c_signature(source, symbol) == list(argtypes)
    assert source in _build.KERNELS


# --------------------------------------------------------------------------
# the block LU's narrow form (csrc/spike_solve.cu, block_lu_narrow_kernel)

@pytest.mark.parametrize("nb", [64, 96, 128])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 17, 31, 32, 33, 64, 2048])
def test_block_lu_plan_narrow_or_wide(nb, K):
    """Narrow up to a warp's 32 columns, wide past them (the use_pallas_
    refine=False chunk's K=2048 among them); the narrow form's shared
    memory (six doubles a row and pair: band, V column, factors, the
    solutions; the swap flags) within an H100 block's 232,448 bytes at the
    driver's block sizes."""
    form = shs.block_lu_plan(nb, K)
    assert form.form == ("narrow" if K <= 32 else "wide")
    if form.form == "narrow":
        assert (form.pairs, form.threads) == (32, 128)
        assert form.shared_bytes == shs.narrow_shared_bytes(nb) \
            == (8 * 6 + 1) * nb * 32
        assert form.shared_bytes <= 232448
    else:
        assert form == shs.LUForm("wide", 0, 0, 0)


def test_block_lu_plan_falls_back_to_wide_past_the_shared_memory():
    """A block size whose rows no longer fit a block's shared memory takes
    the wide form (nb = 149: 233,632 bytes)."""
    assert shs.block_lu_plan(148, 5).form == "narrow"
    assert shs.block_lu_plan(149, 5).form == "wide"
    assert shs.block_lu_plan(256, 1).form == "wide"


def _narrow_write_model(P, nb, K):
    """The narrow kernel's index arithmetic, vectorised: each block's lanes
    (lane -> pair g = 32 b + lane -> (row block p, column i); lanes past P K
    idle), the rows its four warps stage (row j by warp j mod 4: its row
    block's nb rows of V's column i) and write out.  Returns (pairs taken a pair, V entries
    staged, output entries written)."""
    blocks = shs.narrow_grid(P, K)
    taken = np.zeros(P * K, np.int64)
    staged = np.zeros((P * nb, K), np.int64)
    writes = np.zeros((P * nb, K), np.int64)
    for b in range(blocks):
        g = b * 32 + np.arange(32)
        g = g[g < P * K]
        p, i = g // K, g % K
        np.add.at(taken, p * K + i, 1)
        for w in range(4):
            rows = p[:, None] * nb + np.arange(w, nb, 4)[None, :]
            cols = np.broadcast_to(i[:, None], rows.shape)
            np.add.at(staged, (rows, cols), 1)
            np.add.at(writes, (rows, cols), 1)
    return taken, staged, writes


@pytest.mark.parametrize("P, nb, K", [(171, 96, 5), (256, 64, 5),
                                      (171, 96, 17), (7, 128, 32),
                                      (5, 64, 1), (3, 96, 31), (1, 64, 2)])
def test_block_lu_narrow_packing_takes_every_pair_once(P, nb, K):
    """A CPU model of the lane -> (row block, column) packing: every pair
    taken by exactly one lane of one block, every V entry staged and every
    output entry written exactly once."""
    taken, staged, writes = _narrow_write_model(P, nb, K)
    assert (taken == 1).all()
    assert (staged == 1).all()
    assert (writes == 1).all()
    assert shs.narrow_grid(P, K) == -(-(P * K) // 32)


def test_block_lu_narrow_shape_on_the_cpu_is_the_plain_version(rng):
    """At a narrow shape the CPU path is still the plain version, and
    counts no launch."""
    n, nb, K = 500, 96, 5
    d = rng.standard_normal(n) * 2.0
    e = rng.standard_normal(n - 1)
    db, e_all, e_cross, ec_above, tiny = tref.band_prep(*_t(d, e), nb)
    lam, V = _t(rng.standard_normal(K), rng.standard_normal((n, K)))
    assert shs.block_lu_plan(nb, K).form == "narrow"
    before = shs.block_lu_launches
    got = shs.block_lu_solve(db, e_all, tiny, ec_above, e_cross, lam, V, nb)
    want = shs.block_lu_solve_plain(db, e_all, tiny, ec_above, e_cross, lam,
                                    V, nb)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert shs.block_lu_launches == before
