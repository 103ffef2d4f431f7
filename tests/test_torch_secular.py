"""PyTorch port, secular merge: merge_decompose on identical (d, z, rho)
against the JAX package.  The discrete results (active count, partition,
rotation log) must be equal; eigenvalues, root offsets, z and column norms
agree to 1e-13 relative.  The root finder's iteration alone
(secular_solve_plain, what CPU tensors run and the card's kernel is held
to) against the JAX package's _solve_roots, and each root solved alone
against the batched loop: the property the kernel's per-block exit rests
on."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu.kernels.secular as jsec
from symmetric_eigenvalue_tpu.kernels.secular import \
    merge_decompose as jmerge
from symmetric_eigenvalue_tpu_torch.kernels import secular as tsec
from symmetric_eigenvalue_tpu_torch.kernels import secular_sums as tss
from symmetric_eigenvalue_tpu_torch.kernels.secular import \
    merge_decompose as tmerge

KW = dict(eps=2.0 ** -52, deflation_factor=8.0, max_secular_iters=60,
          secular_tol_factor=8.0, use_gu_eisenstat=True, block_size=2048)


# one jit for every case; cases share shapes so most calls reuse a compile
_JAX_LEVEL = jax.jit(jax.vmap(functools.partial(jmerge, **KW)))
M = 32


def _jax_rep(d, z, rho):
    rep = _JAX_LEVEL(jnp.asarray(d), jnp.asarray(z), jnp.asarray(rho))
    return {f: np.asarray(getattr(rep, f)) for f in rep._fields}


def _compare(d, z, rho, tol_root=1e-13):
    """d, z: (k, m); rho: (k,).  ``tol_root``: relative tolerance on tau
    and the column norms."""
    ref = _jax_rep(d, z, rho)
    rep = tmerge(torch.as_tensor(d), torch.as_tensor(z),
                 torch.as_tensor(rho), **KW)
    got = {f: getattr(rep, f).numpy() for f in rep._fields}
    # the root finder's sweeps stop at K: z is exactly 0 past it
    part = tsec.merge_partition(torch.as_tensor(d), torch.as_tensor(z),
                                torch.as_tensor(rho), eps=KW["eps"],
                                deflation_factor=KW["deflation_factor"])
    past = np.arange(d.shape[1])[None, :] >= part.K.numpy()[:, None]
    assert np.all(part.zu.numpy()[past] == 0.0)
    for f in ("K", "p12", "nrot", "nwave", "colperm", "shift_idx"):
        assert np.array_equal(got[f], ref[f]), f
    for b in range(d.shape[0]):
        nr = int(ref["nrot"][b])
        for f in ("rot_a", "rot_b", "rot_wave"):
            assert np.array_equal(got[f][b, :nr], ref[f][b, :nr]), f
        for f in ("rot_c", "rot_s"):
            assert np.abs(got[f][b, :nr] - ref[f][b, :nr]).max(initial=0) \
                <= 1e-15, f
    act = np.arange(d.shape[1])[None, :] < ref["K"][:, None]
    for f in ("lam_sorted", "poles", "poles_sec", "rho"):
        scale = np.abs(ref[f]).max()
        assert np.abs(got[f] - ref[f]).max() <= 1e-13 * scale, f
    for f, tol in (("tau", tol_root), ("zhat", 1e-13),
                   ("colnorm", tol_root)):
        diff = np.abs(got[f] - ref[f])[act]
        assert np.all(diff <= tol * np.abs(ref[f])[act] + 1e-300), f
    return rep


def test_random_merge(rng):
    m = M
    d = np.sort(rng.standard_normal(m) * 10)
    z = rng.standard_normal(m)
    _compare(d[None], (z / np.linalg.norm(z))[None], np.array([3.7]))


def test_unsorted_and_batch(rng):
    k, m = 6, M
    d = rng.standard_normal((k, m)) * 5
    z = rng.standard_normal((k, m))
    rho = np.abs(rng.standard_normal(k)) + 0.1
    _compare(d, z, rho)


def test_tiny_z_entries_deflate(rng):
    m = M
    d = np.sort(rng.standard_normal(m) * 4)
    z = rng.standard_normal(m)
    z[::4] = 1e-18
    rep = _compare(d[None], z[None], np.array([2.0]))
    assert int(rep.K[0]) < m


def test_duplicate_poles_rotate(rng):
    m = M
    d = np.sort(rng.standard_normal(m))
    d[5] = d[6]
    d[10] = d[11] = d[12]
    z = rng.standard_normal(m)
    rep = _compare(d[None], z[None], np.array([1.0]))
    assert int(rep.nrot[0]) >= 3


def test_heavy_deflation(rng):
    half = 150
    base = np.sort(rng.standard_normal(half) * 3)
    d = np.sort(np.concatenate([base, base + 1e-13 * rng.random(half)]))
    z = rng.standard_normal(2 * half)
    # poles 1e-13 apart: the root finder may stop anywhere inside its 8*eps
    # test on h, and one root's stopping iterate depends on the summation
    # order.  The JAX package's own eager and jitted runs differ there by
    # 3.3e-12 relative in tau (and so in its column norm); the port matches
    # the eager run.  The eigenvalue moves by ~3e-18.
    rep = _compare(d[None], (z / np.linalg.norm(z))[None], np.array([1.9]),
                   tol_root=1e-11)
    assert int(rep.nrot[0]) > 64


@pytest.mark.parametrize("case", ["zero_z_dominant", "two_nonzero", "rho0"])
def test_zero_z_cases(rng, case):
    m = M
    d = np.sort(rng.standard_normal(m) * 2)
    z = rng.standard_normal(m)
    rho = 1.9
    if case == "zero_z_dominant":
        d[-1], d[0] = 50.0, -50.0
        z[-1] = z[0] = 0.0
    elif case == "two_nonzero":
        z = np.zeros(m)
        z[3], z[17] = 0.8, -0.6
    else:
        rho = 0.0
    _compare(d[None], z[None], np.array([rho]))


# --------------------------------------------------------------------------
# the root finder's iteration alone

def _root_case(rng, case):
    """(d, z, rho, max_iters, tol_root) of one merge."""
    m = M
    d = np.sort(rng.standard_normal(m) * 10)
    z = rng.standard_normal(m)
    z /= np.linalg.norm(z)
    rho, iters, tol = 3.7, KW["max_secular_iters"], 1e-13
    if case == "heavy_deflation":
        half = 150
        base = np.sort(rng.standard_normal(half) * 3)
        d = np.sort(np.concatenate([base, base + 1e-13 * rng.random(half)]))
        z = rng.standard_normal(2 * half)
        z /= np.linalg.norm(z)
        rho, tol = 1.9, 1e-11          # see test_heavy_deflation
    elif case == "exterior_root":
        rho = 400.0                    # the last root far past every pole
    elif case == "rho0":
        rho = 0.0
    elif case == "max_iters":
        iters = 2                      # stops before the roots converge
    return d, z, rho, iters, tol


_J_ROOTS = {}


def _jax_roots(part, active, max_iters):
    key = (part.poles_sec.shape[0], max_iters)
    if key not in _J_ROOTS:
        _J_ROOTS[key] = jax.jit(functools.partial(
            jsec._solve_roots, eps=KW["eps"], max_iters=max_iters,
            tol_factor=KW["secular_tol_factor"], block=KW["block_size"]))
    tau, sidx, sval = _J_ROOTS[key](part.poles_sec, part.zu, part.rho_e,
                                    part.K, active)
    return np.asarray(tau), np.asarray(sidx), np.asarray(sval)


def _port_setup(d, z, rho):
    part = tsec.merge_partition(torch.as_tensor(d)[None],
                                torch.as_tensor(z)[None],
                                torch.tensor([rho], dtype=torch.float64),
                                eps=KW["eps"],
                                deflation_factor=KW["deflation_factor"])
    active = torch.arange(d.shape[0])[None, :] < part.K[:, None]
    return part, active, *tsec._root_setup(part.poles_sec, part.zu,
                                           part.rho_e, part.K, active)


TOLF = KW["secular_tol_factor"] * KW["eps"]


@pytest.mark.parametrize("case", ["random", "heavy_deflation",
                                  "exterior_root", "rho0", "max_iters"])
def test_solve_plain_matches_jax_solve_roots(rng, case):
    """secular_solve_plain on the port's setup against the JAX package's
    _solve_roots on its own merge_partition of the same (d, z, rho): the
    same active count and shift choices, tau to the merge tests'
    tolerance."""
    d, z, rho, max_iters, tol = _root_case(rng, case)
    jpart = jsec.merge_partition(jnp.asarray(d), jnp.asarray(z),
                                 jnp.asarray(rho), eps=KW["eps"],
                                 deflation_factor=KW["deflation_factor"])
    jact = jnp.arange(d.shape[0]) < jpart.K
    jtau, jsidx, _ = _jax_roots(jpart, jact, max_iters)
    part, active, setup, sidx = _port_setup(d, z, rho)
    assert int(part.K[0]) == int(jpart.K)
    tau, iters = tss.secular_solve_plain(setup, TOLF, max_iters)
    act = active[0].numpy()
    assert np.array_equal(sidx[0].numpy()[act], jsidx[act])
    got, ref = tau[0].numpy()[act], jtau[act]
    assert np.all(np.abs(got - ref) <= tol * np.abs(ref) + 1e-300)
    assert int(iters.max()) <= max_iters
    assert np.all(iters[0].numpy()[~act] == 0)
    if case == "max_iters":
        assert int(iters.max()) == max_iters
    # the CPU route of the merge runs exactly this
    tau2, sidx2, _ = tsec._solve_roots(part.poles_sec, part.zu, part.rho_e,
                                       part.K, active, KW["eps"], max_iters,
                                       KW["secular_tol_factor"])
    assert torch.equal(tau2, tau) and torch.equal(sidx2, sidx)


@pytest.mark.parametrize("case", ["random", "heavy_deflation"])
def test_each_root_alone_matches_the_batch(rng, case):
    """Per-root independence: a root solved alone (every other root marked
    done) follows the batched loop's trajectory: tau to 1e-13 relative and
    the same number of sweeps (the plain sums of one root do not depend on
    the others, so they agree bit for bit)."""
    d, z, rho, max_iters, _ = _root_case(rng, case)
    _, active, setup, _ = _port_setup(d, z, rho)
    tau, iters = tss.secular_solve_plain(setup, TOLF, max_iters)
    act = np.flatnonzero(active[0].numpy())
    for i in act[:: max(1, len(act) // 12)]:
        alone = torch.ones_like(setup.done0)
        alone[0, i] = False
        t1, it1 = tss.secular_solve_plain(setup._replace(done0=alone), TOLF,
                                          max_iters)
        assert abs(float(t1[0, i] - tau[0, i])) \
            <= 1e-13 * abs(float(tau[0, i]))
        assert int(it1[0, i]) == int(iters[0, i])
        assert int(it1.sum()) == int(iters[0, i])
