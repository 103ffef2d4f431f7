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


def _kernel_model(ins, sp, sq, shifted):
    """csrc/interface_solve.cu for every column in Python floats (IEEE f64,
    each operation rounded, no FMA): the same storage slots (H1, H2 in F's
    and L's, shifted by one block with ``shifted``), the same order of the
    back sweep's loads (a block ahead of its stores) and the same end
    rows."""
    pf, pl, qf, ql, uf, ul = (t.numpy() for t in ins)
    P, K = uf.shape
    Fo, Lo, G11, G21 = (np.full((P, K), np.nan) for _ in range(4))

    def fslot(b):
        return (b + P - 1) % P if shifted else b

    def lslot(b):
        return (b + 1) % P if shifted else b

    tiny2 = 2.0 ** -96
    for i in range(K):
        g21 = h2 = 0.0
        for b in range(P):
            a_pf, a_pl = float(pf[b, i]), float(pl[b, i])
            a_qf, a_ql = float(qf[b, i]), float(ql[b, i])
            if sp is not None:
                a_pf, a_pl = a_pf * float(sp[b]), a_pl * float(sp[b])
            if sq is not None:
                a_qf, a_ql = a_qf * float(sq[b]), a_ql * float(sq[b])
            d11 = 1.0 - a_pf * g21
            det = (-tiny2 if d11 < 0 else tiny2) if abs(d11) < tiny2 else d11
            i11, i21, i22 = 1.0 / det, (a_pl * g21) / det, d11 / det
            r1 = float(uf[b, i]) - a_pf * h2
            r2 = float(ul[b, i]) - a_pl * h2
            Fo[fslot(b), i] = i11 * r1
            h2 = i21 * r1 + i22 * r2
            Lo[lslot(b), i] = h2
            G11[b, i] = i11 * a_qf
            g21 = i21 * a_qf + i22 * a_ql
            G21[b, i] = g21
        def load(b):
            return (Fo[fslot(b), i], Lo[lslot(b), i], G11[b, i], G21[b, i])

        f_next = 0.0
        nxt = load(P - 1)
        for b in range(P - 1, -1, -1):
            h1, hh2, g11, gg21 = nxt
            if b > 0:
                nxt = load(b - 1)
            F = h1 - g11 * f_next
            L = hh2 - gg21 * f_next
            Fo[fslot(b), i] = 0.0 if shifted and b == 0 else F
            Lo[lslot(b), i] = 0.0 if shifted and b == P - 1 else L
            f_next = F
    return Fo, Lo


@pytest.mark.parametrize("P", [1, 2, 7])
@pytest.mark.parametrize("shifted", [False, True])
def test_interface_kernel_order_is_the_plain_loop(rng, P, shifted):
    """The kernel's schedule (one column a thread, H in the outputs'
    slots, the back sweep's loads a block ahead of its stores) gives the
    plain version's values bit for bit, with and without the couplers and
    the shift."""
    K = 3
    ins = _interface_inputs(rng, P, K)
    sp = torch.as_tensor(rng.standard_normal(P))
    sq = torch.as_tensor(rng.standard_normal(P))
    for scales in ((None, None), (sp, sq)):
        want = shs.interface_solve(*ins, ec_above=scales[0],
                                   e_cross=scales[1], shifted=shifted)
        got = _kernel_model(ins, *scales, shifted)
        assert np.array_equal(got[0], want[0].numpy())
        assert np.array_equal(got[1], want[1].numpy())


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
    ("spike_solve", "block_lu_launch", shs._BLOCK_LU_ARGTYPES),
    ("spike_solve", "spike_pass_a_launch", tsp._ARGTYPES_A),
    ("spike_solve", "spike_pass_b_launch", tsp._ARGTYPES_B),
    ("spike_solve", "spike_kernel_info", shs._INFO_ARGTYPES)])
def test_bindings_match_the_sources(source, symbol, argtypes):
    """Every wrapper's ctypes argument list is its C function's (a pointer
    passed as an int would be cut to 32 bits on the card), and the new
    source is one _build builds."""
    assert _c_signature(source, symbol) == list(argtypes)
    assert source in _build.KERNELS
