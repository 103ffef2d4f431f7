"""PyTorch port, Cauchy kernels on the CPU (their plain versions) against
the JAX package: cauchy_matmul and cauchy_materialize against the Pallas
kernels in interpret mode (full-f32 "highest" tier), the deflation skip,
and the f32 assemble_u / apply_u_level on JAX-produced merge
representations (carried across by interop) against the JAX f32 XLA path.
The CUDA kernel multiplies with a three-pass TF32 split; its plain
emulation (tf32_split, cauchy_matmul_split_plain) is held against the
Pallas kernel in both of its tiers, and a whole mixed solve is run with it.

Tolerances: f32 products summed in another order, 2e-5 of max|Y| against
the Pallas kernel (whose entries also carry f32-pair rounding) and 1e-5 of
max|Y| against the XLA path; materialized entries 2^-22 of max|U|."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import symmetric_eigenvalue_tpu.kernels.pallas.cauchy_matmul as jcm
from symmetric_eigenvalue_tpu.kernels import assemble as jas
from symmetric_eigenvalue_tpu.kernels.secular import merge_decompose
from symmetric_eigenvalue_tpu_torch import interop
from symmetric_eigenvalue_tpu_torch.kernels import assemble as tas
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_matmul as tcm

KW = dict(eps=2.0 ** -52, deflation_factor=8.0, max_secular_iters=60,
          secular_tol_factor=8.0, use_gu_eisenstat=True)


@pytest.fixture
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jcm.pl, "pallas_call", patched)
    monkeypatch.setenv("SE_DOWNSWEEP_PRECISION", "highest")


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)[None], dtype=dtype)


def _cauchy_inputs(rng, m, C):
    poles = np.sort(rng.standard_normal(m))
    tau = np.abs(rng.standard_normal(m)) * 1e-3 + 1e-15
    tau[7] = 1e-13                      # near-pole root
    zhat = rng.standard_normal(m) * 0.1
    ncolinv = np.abs(rng.standard_normal(m)) + 0.1
    X = rng.standard_normal((m, C)).astype(np.float32)
    return poles, poles.copy(), tau, zhat, ncolinv, X


def _port_matmul(poles, shift, tau, zhat, ninv, X, K):
    return tcm.cauchy_matmul(_t(poles), _t(shift), _t(tau), _t(zhat),
                             _t(ninv), _t(X, torch.float32),
                             torch.tensor([K]))[0].numpy()


@pytest.mark.parametrize("m,C,tiles", [(256, 256, dict(tj=128, ti=128,
                                                       tc=128)),
                                       (64, 512, {})])
def test_cauchy_matmul_matches_pallas(interpreted, rng, m, C, tiles):
    """Full-width tiles and a small merge (m < 512: the deep levels)."""
    args = _cauchy_inputs(rng, m, C)
    Yj = np.asarray(jcm.cauchy_matmul(*(jnp.asarray(a) for a in args),
                                      **tiles))
    Y = _port_matmul(*args, K=m)
    assert Y.dtype == np.float32 and Y.shape == (m, C)
    assert np.abs(Y - Yj).max() <= 2e-5 * np.abs(Yj).max()
    poles, shift, tau, zhat, ninv, X = args
    M = (zhat[:, None] / ((poles[:, None] - shift[None, :]) - tau[None, :])) \
        * ninv[None, :]
    ref = M @ X.astype(np.float64)
    assert np.abs(Y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_cauchy_matmul_deflation_skip(interpreted, rng):
    """K < m: slots past K (ncolinv 0) contribute exactly nothing, so the
    skip is bit-identical to the full contraction, per merge, and matches
    the Pallas kernel's own skip."""
    m, C, K = 1024, 512, 300
    poles = np.sort(rng.standard_normal(m))
    shift = poles[rng.integers(0, m, m)]
    tau = rng.standard_normal(m) * 1e-8
    zhat = rng.standard_normal(m)
    ninv = np.abs(rng.standard_normal(m)) + 0.5
    ninv[K:] = 0.0
    X = rng.standard_normal((m, C)).astype(np.float32)
    args = (poles, shift, tau, zhat, ninv, X)
    Y_skip = _port_matmul(*args, K=K)
    Y_full = _port_matmul(*args, K=m)
    fin = np.isfinite(Y_full)
    assert fin.all()
    assert np.array_equal(Y_skip, Y_full)
    Yj = np.asarray(jcm.cauchy_matmul(*(jnp.asarray(a) for a in args),
                                      kact=K))
    assert np.abs(Y_skip - Yj).max() <= 2e-5 * np.abs(Yj).max()
    # a level batch with each merge's own K
    b = lambda a, dt=torch.float64: torch.as_tensor(np.stack([a, a]),
                                                    dtype=dt)
    Yb = tcm.cauchy_matmul(b(poles), b(shift), b(tau), b(zhat), b(ninv),
                           b(X, torch.float32),
                           torch.tensor([K, m])).numpy()
    assert np.array_equal(Yb[0], Y_skip)
    assert np.array_equal(Yb[1], Y_full)


def test_cauchy_materialize_matches_pallas(interpreted, rng):
    """Root U with deflated identity columns: 2^-22 of max|U| against the
    Pallas kernel and the f64 formula; identity columns exact."""
    m, C, K = 1024, 512, 700
    poles = np.sort(rng.standard_normal(m))
    shift_idx = rng.integers(0, m, m)
    tau = rng.standard_normal(m) * 1e-8
    zhat = rng.standard_normal(m)
    ncol = np.abs(rng.standard_normal(m)) + 0.5
    slots = rng.permutation(m)[:C]
    act = slots < K
    ninv = np.where(act, 1.0 / ncol[slots], 0.0)
    shift_sel = poles[shift_idx[slots]]
    Uj = np.asarray(jcm.cauchy_materialize(
        jnp.asarray(poles), jnp.asarray(shift_sel), jnp.asarray(tau[slots]),
        jnp.asarray(zhat), jnp.asarray(ninv), jnp.asarray(slots), K))
    U = tcm.cauchy_materialize(_t(poles), _t(zhat), _t(shift_sel),
                               _t(tau[slots]), _t(ninv),
                               torch.as_tensor(slots[None]),
                               torch.tensor([K]))[0].numpy()
    assert U.dtype == np.float32 and U.shape == (m, C)
    scale = np.abs(Uj).max()
    assert np.abs(U - Uj).max() <= 2.0 ** -22 * scale
    denom = (poles[:, None] - shift_sel[None, :]) - tau[slots][None, :]
    ref = np.where(act[None, :], zhat[:, None] / denom / ncol[slots][None, :],
                   np.arange(m)[:, None] == slots[None, :])
    assert np.abs(U - ref).max() <= 2.0 ** -22 * np.abs(ref).max()
    assert np.array_equal(U[:, ~act],
                          (np.arange(m)[:, None] == slots[None, ~act]))


# ---------------------------------------------------------------------------
# the three-pass TF32 split of the CUDA kernel, emulated in plain PyTorch

def _split_inputs(kind):
    g = np.random.default_rng(77)
    x = g.standard_normal(4096).astype(np.float32)
    if kind == "normal":
        return x
    if kind == "wide_range":
        return (x * np.exp2(g.integers(-60, 60, x.size))).astype(np.float32)
    if kind == "tf32_exact":         # 11 significant bits: hi = x, lo = 0
        return (np.round(x * 512) / 512).astype(np.float32)[np.abs(x) < 2]
    if kind == "ties":               # exactly half a TF32 ulp above a word
        hi = np.float32(1.0) + np.arange(64, dtype=np.float32) * 2.0 ** -10
        return np.concatenate([hi + np.float32(2.0 ** -11),
                               -(hi + np.float32(2.0 ** -11))])
    return np.zeros(8, dtype=np.float32) * np.array([1, -1] * 4,
                                                    dtype=np.float32)


@pytest.mark.parametrize("kind", ["normal", "wide_range", "tf32_exact",
                                  "ties", "zeros"])
def test_tf32_split(kind):
    """hi has at most 11 significant bits (the low 13 mantissa bits are
    zero), so has lo; hi is within half a TF32 ulp of x; hi + lo gives x
    back to 2^-21 relative; exact for TF32 values and zeros."""
    x = _split_inputs(kind)
    hi, lo = (t.numpy() for t in tcm.tf32_split(torch.as_tensor(x)))
    assert hi.dtype == lo.dtype == np.float32
    assert not (hi.view(np.int32) & 0x1FFF).any()
    assert not (lo.view(np.int32) & 0x1FFF).any()
    x64, back = x.astype(np.float64), hi.astype(np.float64) + lo
    assert np.all(np.abs(x64 - hi) <= 2.0 ** -11 * np.abs(x64))
    assert np.all(np.abs(x64 - back) <= 2.0 ** -21 * np.abs(x64))
    if kind in ("tf32_exact", "zeros"):
        assert np.array_equal(hi, x) and not lo.any()
    if kind == "ties":               # ties round away from zero
        assert np.all(np.abs(hi) > np.abs(x))


@pytest.fixture
def interpreted_default_tier(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jcm.pl, "pallas_call", patched)
    monkeypatch.delenv("SE_DOWNSWEEP_PRECISION", raising=False)


def _split_product_errors(rng, m, C, K):
    """Inputs, the emulated split product, the full-f32 plain product, and
    the per-entry scale |M| @ |X| with the f64 product of the f32 entries."""
    poles, shift, tau, zhat, ninv, X = _cauchy_inputs(rng, m, C)
    ninv[K:] = 0.0
    targs = (_t(poles), _t(shift), _t(tau), _t(zhat), _t(ninv),
             _t(X, torch.float32), torch.tensor([K]))
    Mf = tcm._cauchy_block(*targs[:5])[0].numpy().astype(np.float64)
    Mf[:, K:] = 0.0
    exact = Mf @ X.astype(np.float64)
    scale = np.abs(Mf) @ np.abs(X).astype(np.float64)
    emu = tcm.cauchy_matmul_split_plain(*targs)[0].numpy()
    plain = tcm.cauchy_matmul_plain(*targs)[0].numpy()
    return (poles, shift, tau, zhat, ninv, X), emu, plain, exact, scale


@pytest.mark.parametrize("m,C,K,tiles", [
    (256, 256, 256, dict(tj=128, ti=128, tc=128)), (1024, 512, 300, {})])
def test_split_emulation_between_the_pallas_tiers(interpreted_default_tier,
                                                  monkeypatch, rng, m, C, K,
                                                  tiles):
    """The three-pass TF32 split against the JAX kernel in its default tier
    (bf16_3x, the same split with bf16 words) and in "highest": closer to
    the f64 product than the former, and per entry within 2^-18 of
    |M| @ |X| of the latter and of the port's own full-f32 product (f32
    sums of hundreds of terms in three different orders: measured 1.9e-6
    to 2.2e-6, half of 2^-18)."""
    args, emu, plain, exact, scale = _split_product_errors(rng, m, C, K)
    jargs = [jnp.asarray(a) for a in args]
    Y3 = np.asarray(jcm.cauchy_matmul(*jargs, kact=K, **tiles))
    monkeypatch.setenv("SE_DOWNSWEEP_PRECISION", "highest")
    Yh = np.asarray(jcm.cauchy_matmul(*jargs, kact=K, **tiles))
    err = lambda y: (np.abs(y - exact) / scale).max()
    assert err(Y3) > 4 * err(Yh)          # the two tiers did differ
    assert err(emu) < err(Y3)
    assert (np.abs(emu - Yh) / scale).max() <= 2.0 ** -18
    assert (np.abs(plain - Yh) / scale).max() <= 2.0 ** -18
    # and of the same grade as the full-f32 plain version
    assert (np.abs(emu - plain) / scale).max() <= 2.0 ** -18
    assert emu.dtype == np.float32 and emu.shape == (m, C)


def test_split_emulation_deflation_skip(rng):
    """Slots past K contribute exactly nothing to the emulation either."""
    m, C, K = 640, 64, 200
    args, emu, _, _, _ = _split_product_errors(rng, m, C, K)
    targs = [_t(a) for a in args[:5]] + [_t(args[5], torch.float32)]
    full = tcm.cauchy_matmul_split_plain(*targs, torch.tensor([m]))[0].numpy()
    assert np.isfinite(full).all() and np.array_equal(emu, full)


@pytest.mark.parametrize("matrix", ["random", "poisson"])
def test_mixed_solve_with_the_split_product(monkeypatch, matrix):
    """One mixed-precision solve (n=512: the Spike route) whose downsweep
    multiplies with the emulated split instead of the full-f32 product:
    residual <= 1e-12 ||T||, orthogonality <= 1e-10, and the eigenvalues of
    the unpatched run, bit for bit."""
    import symmetric_eigenvalue_tpu_torch as st
    n = 512
    if matrix == "random":
        g = np.random.default_rng(5)
        d, e = g.standard_normal(n) * 5.0, g.standard_normal(n - 1) * 2.0
    else:
        d, e = 2.0 * np.ones(n), -np.ones(n - 1)
    cfg = st.SolverConfig(leaf_size=32)
    base, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                          compute_vectors=True, device="cpu")
    calls = []

    def split_product(*args):
        calls.append(args[5].shape)
        return tcm.cauchy_matmul_split_plain(*args)

    monkeypatch.setattr(tas, "cauchy_matmul", split_product)
    res, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                         compute_vectors=True, device="cpu")
    assert len(calls) >= 3               # every non-root level of the sweep
    assert torch.equal(res.eigenvalues, base.eigenvalues)
    lam, V = res.eigenvalues.numpy(), res.eigenvectors.numpy()
    norm_t = np.abs(lam).max()
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    assert np.abs(T @ V - V * lam[None, :]).max() <= 1e-12 * norm_t
    assert np.abs(V.T @ V - np.eye(n)).max() <= 1e-10
    # the two products differ in the last bits of f32, the vectors agree
    Vb = base.eigenvectors.numpy()
    gaps = np.diff(lam)
    sep = np.minimum(np.append(gaps, np.inf), np.insert(gaps, 0, np.inf))
    well = sep > 1e-4 * norm_t
    assert well.sum() > n // 2
    assert np.all(np.abs(np.sum(V * Vb, axis=0))[well] >= 1 - 1e-10)


_J_MERGE = jax.jit(functools.partial(merge_decompose, **KW))
_J_LEVEL = jax.jit(jax.vmap(functools.partial(merge_decompose, **KW)))
_J_ASSEMBLE32 = jax.jit(functools.partial(jas.assemble_u, dtype=jnp.float32),
                        static_argnames=("block",))
_J_APPLY_LEVEL = jax.jit(jas.apply_u_level, static_argnames=("block",))


def _merge_inputs(rng, kind, m):
    if kind == "heavy":
        base = np.sort(rng.standard_normal(m // 2) * 3)
        d = np.sort(np.concatenate([base, base + 1e-13 * rng.random(m // 2)]))
    else:
        d = np.sort(rng.standard_normal(m) * 3)
        d[4] = d[5]                       # one rotation
    z = rng.standard_normal(m)
    return d, z / np.linalg.norm(z)


def _rep(jrep):
    return interop.merge_rep_from_numpy(
        {f: np.asarray(getattr(jrep, f)) for f in jrep._fields})


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    assert np.abs(a.astype(np.float64) - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("kind,m", [("light", 64), ("heavy", 300)])
def test_assemble_u_f32(rng, kind, m):
    """f32 root U (cauchy_materialize + f32 rotation replay) against the JAX
    f32 XLA path on the same merge."""
    d, z = _merge_inputs(rng, kind, m)
    jrep = _J_MERGE(jnp.asarray(d), jnp.asarray(z), jnp.asarray(1.9))
    rep = _rep(jrep)
    _close(tas.assemble_u(rep, dtype=torch.float32)[0], _J_ASSEMBLE32(jrep),
           1e-5)
    cols = np.array([0, 5, m - 1, 3])
    _close(tas.assemble_u(rep, cols=torch.as_tensor(cols),
                          dtype=torch.float32)[0],
           _J_ASSEMBLE32(jrep, cols=jnp.asarray(cols), block=8), 1e-5)


def test_apply_u_level_f32(rng):
    """f32 apply_u_level (cauchy_matmul with each merge's own K, f32
    rotation replay) against the JAX f32 XLA path on one level."""
    k, m = 3, 64
    d = np.stack([_merge_inputs(rng, kind, m)[0]
                  for kind in ("light", "heavy", "light")])
    z = rng.standard_normal((k, m))
    jreps = _J_LEVEL(jnp.asarray(d), jnp.asarray(z),
                     jnp.asarray([0.5, 1.9, 3.0]))
    reps = _rep(jreps)
    assert int(reps.K.min()) < m          # the heavy merge deflates
    X = rng.standard_normal((k, m, 40)).astype(np.float32)
    _close(tas.apply_u_level(reps, torch.as_tensor(X)),
           _J_APPLY_LEVEL(jreps, jnp.asarray(X), block=16), 1e-5)


def test_rejects_bad_inputs(rng):
    args = [torch.zeros((1, 8), dtype=torch.float64) for _ in range(5)]
    X = torch.zeros((1, 8, 4), dtype=torch.float32)
    with pytest.raises(TypeError):
        tcm.cauchy_matmul(*args, X.double(), torch.tensor([8]))
    with pytest.raises(ValueError):
        tcm.cauchy_matmul(*args, X[:, :4], torch.tensor([8]))
    with pytest.raises(TypeError):
        tcm.cauchy_materialize(*args, torch.zeros((1, 8)),
                               torch.tensor([8]))
