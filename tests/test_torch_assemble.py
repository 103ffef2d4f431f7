"""PyTorch port, assembly: a JAX MergeRep carried across as numpy arrays
(interop.merge_rep_from_numpy) into the port's apply_u, apply_u_level,
assemble_u and rows_through_merge, each held against the JAX function on
the same rep to 1e-13 of the result's scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import assemble as jas
from symmetric_eigenvalue_tpu.kernels.secular import merge_decompose
from symmetric_eigenvalue_tpu_torch import interop
from symmetric_eigenvalue_tpu_torch.kernels import assemble as tas
from symmetric_eigenvalue_tpu_torch.kernels import rotation_replay as rr

KW = dict(eps=2.0 ** -52, deflation_factor=8.0, max_secular_iters=60,
          secular_tol_factor=8.0, use_gu_eisenstat=True)
# the JAX reference functions, jitted once per module
_J_MERGE = jax.jit(functools.partial(merge_decompose, **KW))
_J_LEVEL = jax.jit(jax.vmap(functools.partial(merge_decompose, **KW)))
_J_ASSEMBLE = jax.jit(jas.assemble_u, static_argnames=("block",))
_J_APPLY = jax.jit(jas.apply_u, static_argnames=("block",))
_J_APPLY_LEVEL = jax.jit(jas.apply_u_level, static_argnames=("block",))
_J_ROWS = jax.jit(jas.rows_through_merge)
_J_ROWS_LEVEL = jax.jit(jax.vmap(jas.rows_through_merge))


def _merge_inputs(rng, kind, m):
    if kind == "heavy":
        base = np.sort(rng.standard_normal(m // 2) * 3)
        d = np.sort(np.concatenate([base, base + 1e-13 * rng.random(m // 2)]))
    else:
        d = np.sort(rng.standard_normal(m) * 3)
        d[4] = d[5]                       # one rotation
    z = rng.standard_normal(m)
    return d, z / np.linalg.norm(z)


def _close(a, b, tol=1e-13):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("kind,m", [("light", 64), ("heavy", 300)])
def test_single_merge(rng, kind, m):
    d, z = _merge_inputs(rng, kind, m)
    jrep = _J_MERGE(jnp.asarray(d), jnp.asarray(z), jnp.asarray(1.9))
    if kind == "heavy":
        assert int(jrep.nrot) > 64        # the JAX wave-replay branch
    rep = interop.merge_rep_from_numpy(
        {f: np.asarray(getattr(jrep, f)) for f in jrep._fields})
    assert rep.poles.shape == (1, m) and rep.K.shape == (1,)

    _close(tas.assemble_u(rep)[0], _J_ASSEMBLE(jrep))
    cols = np.array([0, 5, m - 1, 3])
    _close(tas.assemble_u(rep, cols=torch.as_tensor(cols), block=8)[0],
           _J_ASSEMBLE(jrep, cols=jnp.asarray(cols), block=8))
    X = rng.standard_normal((m, 6))
    _close(tas.apply_u(rep, torch.as_tensor(X)),
           _J_APPLY(jrep, jnp.asarray(X)))
    _close(tas.apply_u(rep, torch.as_tensor(X), block=8),
           _J_APPLY(jrep, jnp.asarray(X), block=8))
    w = rng.standard_normal((2, m))
    _close(tas.rows_through_merge(rep, torch.as_tensor(w)[None])[0],
           _J_ROWS(jrep, jnp.asarray(w)))


def test_level_batch(rng):
    k, m = 3, 64
    d = np.stack([_merge_inputs(rng, kind, m)[0]
                  for kind in ("light", "heavy", "light")])
    z = rng.standard_normal((k, m))
    rho = np.array([0.5, 1.9, 3.0])
    jreps = _J_LEVEL(jnp.asarray(d), jnp.asarray(z), jnp.asarray(rho))
    reps = interop.merge_rep_from_numpy(
        {f: np.asarray(getattr(jreps, f)) for f in jreps._fields})
    X = rng.standard_normal((k, m, 5))
    _close(tas.apply_u_level(reps, torch.as_tensor(X), block=16),
           _J_APPLY_LEVEL(jreps, jnp.asarray(X), block=16))
    w = rng.standard_normal((k, 2, m))
    ref = _J_ROWS_LEVEL(jreps, jnp.asarray(w))
    _close(tas.rows_through_merge(reps, torch.as_tensor(w)), ref)


def test_interop_rejects_bad_shapes(rng):
    d, z = _merge_inputs(rng, "light", 64)
    jrep = _J_MERGE(jnp.asarray(d), jnp.asarray(z), jnp.asarray(1.0))
    arrays = {f: np.asarray(getattr(jrep, f)) for f in jrep._fields}
    arrays["K"] = np.zeros((2, 2), np.int32)
    with pytest.raises(ValueError):
        interop.merge_rep_from_numpy(arrays)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rows_through_merge_replays_through_the_transposed_form(
        rng, monkeypatch, dtype):
    """rows_through_merge hands its boundary rows to ``rotation_replay_t``
    once, as (k, m, r) contiguous in w's dtype (f32 mode: the level's own
    f32 log), and its replay is the plain transposed loop's bit for bit."""
    k, m = 3, 64
    d = np.stack([_merge_inputs(rng, kind, m)[0]
                  for kind in ("light", "heavy", "light")])
    jreps = _J_LEVEL(jnp.asarray(d), jnp.asarray(rng.standard_normal((k, m))),
                     jnp.asarray([0.5, 1.9, 3.0]))
    reps = interop.merge_rep_from_numpy(
        {f: np.asarray(getattr(jreps, f)) for f in jreps._fields})
    reps = type(reps)(*(t.to(dtype) if t.is_floating_point() else t
                        for t in reps))
    w = torch.as_tensor(rng.standard_normal((k, 2, m)), dtype=dtype)
    seen = []
    inner = tas.rotation_replay_t

    def recorded(rep, wt, waves=None):
        seen.append(wt.clone())
        assert wt.shape == (k, m, 2) and wt.is_contiguous()
        assert wt.dtype == dtype and rep.rot_c.dtype == dtype
        out = inner(rep, wt, waves)
        ref = rr.replay_waves_t(rr.rotation_waves(rep),
                                seen[-1].view(k * m, 2))
        assert torch.equal(out.view(k * m, 2), ref)
        return out

    monkeypatch.setattr(tas, "rotation_replay_t", recorded)
    y = tas.rows_through_merge(reps, w)
    assert len(seen) == 1 and y.dtype == dtype and y.shape == (k, 2, m)
