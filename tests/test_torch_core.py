"""PyTorch port, core modules: tree plan, tearing, tridiagonal utilities,
each held against the JAX package on the same inputs (CPU, f64)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.core import tearing as jtear
from symmetric_eigenvalue_tpu.core import tree as jtree
from symmetric_eigenvalue_tpu.core import tridiag as jtri
from symmetric_eigenvalue_tpu_torch.core import tearing as ttear
from symmetric_eigenvalue_tpu_torch.core import tree as ttree
from symmetric_eigenvalue_tpu_torch.core import tridiag as ttri

PLANS = [(1, 32, None), (7, 1, None), (100, 8, None), (200, 8, None),
         (1000, 32, 8), (16384, 32, None)]


@pytest.mark.parametrize("n,leaf,max_leaves", PLANS)
def test_build_plan_fields_equal(n, leaf, max_leaves):
    pj = jtree.build_plan(n, leaf, max_leaves)
    pt = ttree.build_plan(n, leaf, max_leaves)
    fj = dataclasses.asdict(pj)
    ft = dataclasses.asdict(pt)
    assert fj == ft
    assert np.array_equal(pj.row_map(), pt.row_map())
    assert np.array_equal(pj.pad_mask(), pt.pad_mask())


@pytest.mark.parametrize("n,leaf", [(16, 4), (37, 4), (100, 8), (200, 8)])
def test_tear_matches_jax(n, leaf, rng):
    d = rng.standard_normal(n) * 3
    e = rng.standard_normal(n - 1)
    e[n // 3] = 0.0                      # theta = +1 branch at beta == 0
    plan = ttree.build_plan(n, leaf)
    dj, bj, thj = jtear.tear(jnp.asarray(d), jnp.asarray(e),
                             jtree.build_plan(n, leaf))
    dt, bt, tht = ttear.tear(torch.as_tensor(d), torch.as_tensor(e), plan)
    ulp = np.spacing(np.abs(np.asarray(dj)))
    assert np.all(np.abs(dt.numpy() - np.asarray(dj)) <= ulp)
    assert len(bt) == len(bj) == plan.num_levels
    for a, b in zip(bt, bj):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tht, thj):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n", [1, 2, 50])
def test_generators_equal(n):
    for gj, gt in ((jtri.create_matrix_scheme1, ttri.create_matrix_scheme1),
                   (jtri.create_matrix_scheme2, ttri.create_matrix_scheme2)):
        dj, ej = gj(n)
        dt, et = gt(n)
        assert dt.dtype == torch.float64 and et.dtype == torch.float64
        assert np.array_equal(dt.numpy(), np.asarray(dj))
        assert np.array_equal(et.numpy(), np.asarray(ej))
    assert np.array_equal(ttri.eigenvalues_of_scheme2(n),
                          jtri.eigenvalues_of_scheme2(n))


@pytest.mark.parametrize("n,k", [(1, 3), (2, 1), (40, 5)])
def test_matvec_residuals_norm_bound(n, k, rng):
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    V = rng.standard_normal((n, k))
    lam = rng.standard_normal(k)
    dt, et = torch.as_tensor(d), torch.as_tensor(e)
    yj = np.asarray(jtri.tridiag_matvec(jnp.asarray(d), jnp.asarray(e),
                                        jnp.asarray(V)))
    yt = ttri.tridiag_matvec(dt, et, torch.as_tensor(V)).numpy()
    assert np.array_equal(yt, yj)
    yj1 = np.asarray(jtri.tridiag_matvec(jnp.asarray(d), jnp.asarray(e),
                                         jnp.asarray(V[:, 0])))
    assert np.array_equal(
        ttri.tridiag_matvec(dt, et, torch.as_tensor(V[:, 0])).numpy(), yj1)
    rj = np.asarray(jtri.residual_norms(jnp.asarray(d), jnp.asarray(e),
                                        jnp.asarray(lam), jnp.asarray(V)))
    rt = ttri.residual_norms(dt, et, torch.as_tensor(lam),
                             torch.as_tensor(V)).numpy()
    assert np.abs(rt - rj).max() <= 1e-15 * max(1.0, np.abs(rj).max())
    assert float(ttri.tridiag_norm_bound(dt, et)) == \
        float(jtri.tridiag_norm_bound(jnp.asarray(d), jnp.asarray(e)))


def test_config_matches_jax_defaults():
    import symmetric_eigenvalue_tpu as se
    import symmetric_eigenvalue_tpu_torch as st
    fj = {f.name: f.default for f in dataclasses.fields(se.SolverConfig)}
    ft = {f.name: f.default for f in dataclasses.fields(st.SolverConfig)}
    assert set(ft) == set(fj) | {"device"}
    for name, default in fj.items():
        if name != "dtype":
            assert ft[name] == default, name
    cfg = st.SolverConfig()
    assert cfg.dtype == torch.float64 and cfg.device == "cuda"
    assert cfg.eps() == 2.0 ** -52 == se.SolverConfig().eps()
    assert cfg.resolved_leaf_size(16384) == 32 == \
        se.SolverConfig().resolved_leaf_size(16384)
    assert st.SolverConfig(unit_roundoff=1e-10).eps() == 1e-10
    cpu = st.SolverConfig(device="cpu")
    assert 256 <= cpu.resolved_refine_chunk(1024, "cpu") <= cpu.refine_chunk
