"""PyTorch port, secular merge: merge_decompose on identical (d, z, rho)
against the JAX package.  The discrete results (active count, partition,
rotation log) must be equal; eigenvalues, root offsets, z and column norms
agree to 1e-13 relative."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels.secular import \
    merge_decompose as jmerge
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
