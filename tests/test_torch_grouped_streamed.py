"""PyTorch port, the memory routes: the grouped route of
solve_tridiagonal_staged and solve_tridiagonal_streamed, on the CPU against
the JAX package's own routes on the same inputs.

Tolerances: eigenvalues bit for bit the port's staged route (the same
eigenvalue code) and within 1e-13 ||T|| of the JAX package's; residual
<= 1e-12 ||T||; orthogonality <= 1e-10 (grouped, the whole basis) and
<= 1e-11 (streamed: each block's Gram and its cross-Gram with the previous
block, as the JAX package's own tests hold it).  Columns are independent
through the downsweep and the first refinement pass, so the grouped route's
columns agree with the staged route's to rounding: held to 1e-12 up to sign
(bit for bit on the CPU).  Against the JAX package's eigenvectors, which are
free in sign and inside clusters: |<v_port, v_jax>| >= 1 - 1e-10 for
eigenvalues separated from their neighbours by more than 1e-4 ||T||.
"""

import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu.core.tridiag import dense_from_tridiag
from symmetric_eigenvalue_tpu.driver import solve_tridiagonal_streamed as \
    jax_streamed
from symmetric_eigenvalue_tpu_torch import driver
from symmetric_eigenvalue_tpu_torch.utils.checks import (
    max_cross_ortho_error, max_ortho_error)

GROUPED = "bt.downsweep_refine_grouped"


def _well_separated(lam, norm_t, sep=1e-4):
    gaps = np.diff(lam)
    near = np.minimum(np.append(gaps, np.inf), np.insert(gaps, 0, np.inf))
    return near > sep * norm_t


def _match_jax(V, V_j, lam, norm_t):
    """|<v_port, v_jax>| >= 1 - 1e-10 on the well-separated columns."""
    well = _well_separated(lam, norm_t)
    assert well.sum() > V.shape[1] // 2
    dots = np.abs(np.sum(V * V_j, axis=0))
    assert np.all(dots[well] >= 1 - 1e-10)


def _force_grouped(monkeypatch):
    monkeypatch.setattr(driver, "_grouped_bt_bytes", lambda device: 1.0)


@pytest.mark.parametrize("select", [None, "every_third"])
def test_grouped_matches_jax(select, monkeypatch):
    """n=512, leaf 32, vec_chunk=128 (so groups of 256 columns), with all
    columns and with a selection of 171 (not a multiple of the group)."""
    rng = np.random.default_rng(1234)
    n = 512
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    sel = None if select is None else np.arange(0, n, 3)
    cols = np.arange(n) if sel is None else sel
    kw = dict(select=sel) if sel is not None else dict(compute_vectors=True)
    cfg = st.SolverConfig(leaf_size=32, vec_chunk=128)
    staged, t_staged = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                   device="cpu", **kw)
    assert GROUPED not in t_staged.times
    _force_grouped(monkeypatch)
    res, timer = st.solve_tridiagonal_staged(d, e, config=cfg, device="cpu",
                                             **kw)
    assert GROUPED in timer.times and "bt.downsweep" not in timer.times
    assert "bt.refine_pass1" not in timer.times
    assert driver._group_width(n, cfg, "cpu") == 256

    monkeypatch.setenv("SE_GROUPED_BT_BYTES", "1")
    res_j, _ = se.driver.solve_tridiagonal_staged(
        d, e, config=se.SolverConfig(leaf_size=32, vec_chunk=128,
                                     mixed_precision_vectors=True), **kw)
    lam_j = np.asarray(res_j.eigenvalues)
    V_j = np.asarray(res_j.eigenvectors)

    assert torch.equal(res.eigenvalues, staged.eigenvalues)
    lam = res.eigenvalues.numpy()
    V = res.eigenvectors.numpy()
    norm_t = np.abs(lam).max()
    assert V.dtype == np.float64 and V.shape == (n, cols.size)
    assert np.abs(lam - lam_j).max() <= 1e-13 * norm_t
    T = dense_from_tridiag(d, e)
    assert np.abs(T @ V - V * lam[cols][None, :]).max() <= 1e-12 * norm_t
    assert max_ortho_error(res.eigenvectors) <= 1e-10
    V0 = staged.eigenvectors.numpy()
    sign = np.sign(np.sum(V * V0, axis=0))
    assert np.abs(V * sign - V0).max() <= 1e-12
    _match_jax(V, V_j, lam[cols], norm_t)


def test_grouped_switch(monkeypatch, rng):
    """The grouped route is taken exactly when the mixed path's 12*n*C
    bytes pass the threshold, C the selection's length; never on the f64
    path, the eigenvalues-only solve or a leaf-only solve.  The threshold
    and the group budget come from the run device's budget and no
    environment variable."""
    assert abs(driver._grouped_bt_bytes("cpu") / 8e9 - 1.0) < 0.01
    monkeypatch.setenv("SE_GROUPED_BT_BYTES", "1")
    assert driver._grouped_bt_bytes(torch.device("cpu")) > 7.9e9
    cfg = st.SolverConfig()
    # 0.9 * 16e9 * 2/14.5 bytes over 12*n per column, in multiples of 256
    assert driver._group_width(65536, cfg, "cpu") == 2304
    assert driver._group_width(1 << 20, cfg, "cpu") == 256
    assert driver._group_width(512, cfg, "cpu") == cfg.vec_chunk
    assert driver._group_width(512, st.SolverConfig(vec_chunk=64),
                               "cpu") == 256

    n, leaf = 192, 16
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    sel = np.arange(0, n, 3)                    # C = 64
    monkeypatch.setattr(driver, "_grouped_bt_bytes",
                        lambda device: 12.0 * n * sel.size)
    mixed = st.SolverConfig(leaf_size=leaf)

    def grouped(**kw):
        kw.setdefault("config", mixed)
        _, timer = st.solve_tridiagonal_staged(d, e, device="cpu", **kw)
        return GROUPED in timer.times

    assert not grouped(select=sel)              # 12*n*C == threshold
    assert grouped(select=np.arange(sel.size + 1))
    assert grouped(compute_vectors=True)        # C = n
    assert not grouped()                        # eigenvalues only
    assert not grouped(compute_vectors=True, config=st.SolverConfig(
        leaf_size=leaf, mixed_precision_vectors=False))
    assert not grouped(compute_vectors=True,
                       config=st.SolverConfig(leaf_size=256))


def _streamed_blocks(d, e, lam, blocks, norm_t, limit=1e-11):
    """Drain the port's blocks, holding each to residual, Gram and
    neighbour cross-Gram; returns (starts, blocks as numpy)."""
    d_t = torch.as_tensor(d)
    e_t = torch.as_tensor(e)
    starts, got, prev = [], [], None
    for a, Vo in blocks:
        w = int(Vo.shape[1])
        assert Vo.dtype == torch.float64 and Vo.device.type == "cpu"
        res = st.residual_norms(d_t, e_t, lam[a:a + w], Vo)
        assert float(res.max()) <= 1e-12 * norm_t
        assert max_ortho_error(Vo) <= limit
        if prev is not None:
            assert max_cross_ortho_error(prev, Vo) <= limit
        prev = Vo
        starts.append(a)
        got.append(Vo.numpy())
    return starts, got


def test_streamed_matches_jax(rng):
    n = 384
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    cfg = st.SolverConfig(leaf_size=32)
    staged, _ = st.solve_tridiagonal_staged(d, e, config=cfg, device="cpu")
    lam, blocks, timer = st.solve_tridiagonal_streamed(
        d, e, config=cfg, group=128, halo=32, device="cpu")
    assert set(timer.times) == {"eigenvalues"}
    assert torch.equal(lam, staged.eigenvalues)
    norm_t = float(lam.abs().max())
    starts, got = _streamed_blocks(d, e, lam, blocks, norm_t)
    assert starts == [0, 128, 256]
    assert set(timer.times) == {"eigenvalues", "backtransformation_streamed"}

    lam_j, blocks_j, _ = jax_streamed(
        d, e, config=se.SolverConfig(leaf_size=32,
                                     mixed_precision_vectors=True),
        group=128, halo=32)
    lam_np = lam.numpy()
    assert np.abs(lam_np - np.asarray(lam_j)).max() <= 1e-13 * norm_t
    starts_j, V_j = zip(*[(a, np.asarray(Vo)) for a, Vo in blocks_j])
    assert list(starts_j) == starts
    _match_jax(np.concatenate(got, axis=1), np.concatenate(V_j, axis=1),
               lam_np, norm_t)


def test_streamed_single_window(rng):
    """n=96, group=64, halo=32: one window covers every column, computed
    once and cut into blocks of 64 and 32."""
    n = 96
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    lam, blocks, _ = st.solve_tridiagonal_streamed(
        d, e, config=st.SolverConfig(leaf_size=16), group=64, halo=32,
        device="cpu")
    norm_t = float(lam.abs().max())
    starts, got = _streamed_blocks(d, e, lam, blocks, norm_t)
    assert starts == [0, 64] and [b.shape[1] for b in got] == [64, 32]
    V = np.concatenate(got, axis=1)
    assert V.shape == (n, n)
    assert max_ortho_error(torch.as_tensor(V)) <= 1e-11
    lam_j, blocks_j, _ = jax_streamed(
        d, e, config=se.SolverConfig(leaf_size=16,
                                     mixed_precision_vectors=True),
        group=64, halo=32)
    V_j = np.concatenate([np.asarray(Vo) for _, Vo in blocks_j], axis=1)
    assert np.abs(lam.numpy() - np.asarray(lam_j)).max() <= 1e-13 * norm_t
    _match_jax(V, V_j, lam.numpy(), norm_t)


@pytest.mark.parametrize("mixed", [True, False])
def test_streamed_leaf_only_and_f64(mixed, rng):
    """A leaf-only solve (n=20 under a leaf of 32: the windows slice the
    leaf's own vectors, bit for bit the staged route's) and the pure-f64
    path (n=200, windows of 64 + 2*16 through the f64 downsweep)."""
    for n, leaf, group, halo in ((20, 32, 8, 4), (200, 16, 64, 16)):
        d = rng.standard_normal(n)
        e = rng.standard_normal(n - 1)
        cfg = st.SolverConfig(leaf_size=leaf, mixed_precision_vectors=mixed)
        staged, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                                compute_vectors=True,
                                                device="cpu")
        lam, blocks, _ = st.solve_tridiagonal_streamed(
            d, e, config=cfg, group=group, halo=halo, device="cpu")
        assert torch.equal(lam, staged.eigenvalues)
        norm_t = float(lam.abs().max())
        starts, got = _streamed_blocks(d, e, lam, blocks, norm_t)
        assert starts == list(range(0, n, group))
        V = np.concatenate(got, axis=1)
        V0 = staged.eigenvectors.numpy()
        if n == 20:
            assert np.array_equal(V, V0)
        elif not mixed:
            # the f64 downsweep: each column independent of the others
            assert np.abs(V - V0).max() <= 1e-13
        lam_j, blocks_j, _ = jax_streamed(
            d, e, config=se.SolverConfig(leaf_size=leaf,
                                         mixed_precision_vectors=mixed),
            group=group, halo=halo)
        V_j = np.concatenate([np.asarray(Vo) for _, Vo in blocks_j], axis=1)
        _match_jax(V, V_j, lam.numpy(), norm_t)
