"""PyTorch port, leaf solve: closed forms and batched leaf eigensolves held
against the JAX package on the same inputs (CPU, f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.core.tree import build_plan as jbuild_plan
from symmetric_eigenvalue_tpu.kernels import leaf as jleaf
from symmetric_eigenvalue_tpu_torch.core.tree import build_plan
from symmetric_eigenvalue_tpu_torch.kernels import leaf as tleaf


def test_eigh2x2_matches_jax(rng):
    A = rng.standard_normal((64, 2, 2))
    A = A + A.transpose(0, 2, 1)
    special = np.array([[[1.0, 0.0], [0.0, 1.0]], [[2.0, 0.0], [0.0, -3.0]],
                        [[1.0, 1e-12], [1e-12, 1.0]], [[0.0, 0.0], [0.0, 0.0]]])
    A = np.concatenate([A, special])
    lj, Qj = jax.jit(jleaf.eigh2x2)(jnp.asarray(A))
    lt, Qt = tleaf.eigh2x2(torch.as_tensor(A))
    scale = np.maximum(np.abs(np.asarray(lj)).max(axis=1, keepdims=True), 1.0)
    assert np.all(np.abs(lt.numpy() - np.asarray(lj)) <= 1e-14 * scale)
    assert np.abs(Qt.numpy() - np.asarray(Qj)).max() <= 1e-14
    lt1, Qt1 = tleaf.eigh1x1(torch.as_tensor(A[:, :1, :1]))
    assert np.array_equal(lt1.numpy(), A[:, :1, 0])
    assert np.all(Qt1.numpy() == 1.0)


@pytest.mark.parametrize("n,leaf", [(64, 16), (37, 4), (8, 2), (4, 1)])
def test_solve_leaves_matches_jax(n, leaf, rng):
    d = rng.standard_normal(n) * 4
    e = rng.standard_normal(n - 1)
    plan = build_plan(n, leaf)
    jplan = jbuild_plan(n, leaf)
    sent = 20.0 + np.arange(plan.padded_n) * 0.01
    Aj = np.asarray(jleaf.leaf_blocks(jnp.asarray(d), jnp.asarray(e), jplan,
                                      jnp.asarray(sent)))
    At = tleaf.leaf_blocks(torch.as_tensor(d), torch.as_tensor(e), plan,
                           torch.as_tensor(sent))
    assert np.array_equal(At.numpy(), Aj)
    fn_j = jleaf.leaf_eigh_fn(plan.leaf_pad)
    fn_t = tleaf.leaf_eigh_fn(plan.leaf_pad)
    lj, _, _, _ = jleaf.solve_leaves(jnp.asarray(d), jnp.asarray(e), jplan,
                                     jnp.asarray(sent), eigh_fn=fn_j)
    lt, Qt, ft, la = tleaf.solve_leaves(torch.as_tensor(d), torch.as_tensor(e),
                                        plan, torch.as_tensor(sent),
                                        eigh_fn=fn_t)
    scale = max(1.0, np.abs(np.asarray(lj)).max())
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= 1e-14 * scale
    # eigenvectors up to sign: residual and orthogonality of each leaf
    A, Q, lam = At.numpy(), Qt.numpy(), lt.numpy()
    for i in range(plan.num_leaves):
        assert np.abs(A[i] @ Q[i] - Q[i] * lam[i]).max() <= 1e-14 * scale
        assert np.abs(Q[i].T @ Q[i] - np.eye(plan.leaf_pad)).max() <= 1e-14
    assert np.array_equal(ft.numpy(), Q[:, 0, :])
    last = np.asarray(plan.leaf_sizes) - 1
    assert np.array_equal(la.numpy(), Q[np.arange(plan.num_leaves), last, :])
