"""PyTorch port, the inverse Givens replay (kernels/rotation_replay.py) on
the CPU against the JAX package's device loop
(``kernels/assemble.py::_replay_rotations_level``), on the real levels of
two upsweeps carried across as numpy arrays: a Poisson n=1024 tear (many
rotations, one wave a level) and a random one (few rotations, chains up to
four waves deep).

The plain version (the wave loop) is held bit for bit, in f32 and f64,
against a numpy loop over each merge's log in reverse order with every
product and sum rounded apart (what the CUDA kernel computes: a wave's
rotations touch disjoint rows, so their order inside a wave changes
nothing).  Against the JAX loop it agrees to 2 ulp of the level's largest
|y| a wave: XLA:CPU contracts c*u_a + s*u_b into a fused multiply-add
(measured: up to 0.5 ulp of max|y| on the Poisson levels, thousands of ulp
of a result that cancels), which the elementwise kernels here and on the
card never do."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
from symmetric_eigenvalue_tpu import driver as jdrv
from symmetric_eigenvalue_tpu.kernels import assemble as jas
from symmetric_eigenvalue_tpu.kernels.secular import MergeRep as JMergeRep
from symmetric_eigenvalue_tpu_torch import interop
from symmetric_eigenvalue_tpu_torch.kernels import rotation_replay as rr

N = 1024
_J_REPLAY = jax.jit(jas._replay_rotations_level)


def _input(kind):
    if kind == "poisson":
        return se.create_matrix_scheme2(N)
    rng = np.random.default_rng(5)
    return rng.standard_normal(N) * 5.0, rng.standard_normal(N - 1) * 2.0


@functools.lru_cache(maxsize=2)
def _levels(kind):
    """The upsweep's k-stacked MergeReps of one input, per level (JAX)."""
    d, e = _input(kind)
    cfg = se.SolverConfig(leaf_size=32)
    fn, _plan, leaf_only = jdrv._compiled_upsweep(N, cfg, None)
    assert not leaf_only
    reps = fn(jnp.asarray(d), jnp.asarray(e))[0]
    return [{f: np.asarray(getattr(r, f)) for f in r._fields} for r in reps]


def _sequential(fields, y):
    """Each merge's log in reverse order, one rotation at a time, every
    product and sum rounded apart (numpy), in y's dtype."""
    y = y.copy()
    for b in range(y.shape[0]):
        for i in range(int(fields["nrot"][b]) - 1, -1, -1):
            a, bb = fields["rot_a"][b, i], fields["rot_b"][b, i]
            c = y.dtype.type(fields["rot_c"][b, i])
            s = y.dtype.type(fields["rot_s"][b, i])
            ua, ub = y[b, a].copy(), y[b, bb].copy()
            y[b, a] = c * ua + s * ub
            y[b, bb] = -s * ua + c * ub
    return y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["poisson", "random"])
def test_plain_replay_matches_jax(kind, dtype):
    rng = np.random.default_rng(11)
    rotated = 0
    for fields in _levels(kind):
        k, m = fields["rot_a"].shape
        y = rng.standard_normal((k, m, 6)).astype(dtype)
        rep = interop.merge_rep_from_numpy(fields)
        got = rr.rotation_replay(rep, torch.as_tensor(y.copy())).numpy()
        assert got.dtype == y.dtype
        assert np.array_equal(got, _sequential(fields, y))
        jrep = JMergeRep(**jax.tree.map(jnp.asarray, fields))
        ref = np.asarray(_J_REPLAY(jrep, jnp.asarray(y)))
        tol = 2 * max(int(fields["nwave"].max()), 1) * np.spacing(
            np.abs(y).max())
        assert np.abs(got - ref).max() <= tol
        rotated += int(fields["nrot"].sum())
    assert rotated > 0              # the levels carry real rotations


def test_replay_in_place_and_planned_waves():
    """The replay updates y in place; waves planned once (as the
    downsweep's column chunks use them) give the same result."""
    fields = _levels("random")[-2]
    rep = interop.merge_rep_from_numpy(fields)
    k, m = fields["rot_a"].shape
    y = torch.as_tensor(np.random.default_rng(3).standard_normal((k, m, 4)))
    y2 = y.clone()
    out = rr.rotation_replay(rep, y)
    assert out.data_ptr() == y.data_ptr()
    waves = rr.planned_waves(rep)
    assert isinstance(waves, list) and waves
    assert torch.equal(rr.rotation_replay(rep, y2, waves), y)


def test_replay_rejects_bad_inputs():
    rep = interop.merge_rep_from_numpy(_levels("random")[0])
    k, m = rep.rot_a.shape
    with pytest.raises(ValueError):
        rr.rotation_replay(rep, torch.zeros((k, m + 1, 2)))
    with pytest.raises(TypeError):
        rr.rotation_replay(rep, torch.zeros((k, m, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        rr._launch(rep, torch.zeros((k, m, 2)))       # not a CUDA tensor


def test_no_rotation_is_identity():
    fields = dict(_levels("random")[0])
    fields["nrot"] = np.zeros_like(fields["nrot"])
    rep = interop.merge_rep_from_numpy(fields)
    k, m = rep.rot_a.shape
    y = torch.as_tensor(np.random.default_rng(4).standard_normal((k, m, 3)))
    assert torch.equal(rr.rotation_replay(rep, y.clone()), y)
    assert rr.rotation_waves(rep) == []
