"""PyTorch port, the fused small-n backtransform on the CPU against the JAX
package: the host planner of the cluster orthonormalization
(``plan_cluster_orth``, equal to the JAX planner's output), its
application (``apply_cluster_orth_plan``, columns to 1e-13 and the same
acceptance flags), the route end to end with the gate forced open in both
packages (``driver.FUSED_BT_OVERRIDE`` here, ``SE_FORCE_FUSED_BT=1`` there)
and each case that closes the gate.

On the CPU part A runs eagerly (its CUDA graph exists only on the card,
where chip_smoke.py drives it); the route's arithmetic is the same."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu.driver import \
    solve_tridiagonal_staged as j_solve_staged
from symmetric_eigenvalue_tpu.kernels import refine as jref
from symmetric_eigenvalue_tpu_torch import driver
from symmetric_eigenvalue_tpu_torch.kernels import refine as tref

FUSED_NAMES = {"bt.fused_bt", "bt.ortho_rescue", "bt.refine_extra",
               "bt.refine_rescue", "bt.ortho_final"}
STAGED_ONLY = {"bt.downsweep", "bt.refine_pass1", "bt.ortho_mid",
               "bt.residuals1"}


def _clusters(rng, widths, gap=1.0, spread=1e-12):
    """Ascending eigenvalues: one group per entry of ``widths``, groups
    ``gap`` apart, members ``spread`` apart (a width of 1 is a singleton)."""
    lam, x = [], 0.0
    for w in widths:
        lam.extend(x + spread * np.arange(w) * (1 + 0.1 * rng.random(w)))
        x += gap
    return np.asarray(lam)


def _lam_set(kind, rng):
    """(lam, n) for one planner case."""
    if kind == "singletons":
        return np.sort(rng.standard_normal(300)), 300
    if kind == "narrow":
        return _clusters(rng, [1, 2, 3, 1, 5, 8, 4, 2, 7, 1, 6]), 500
    if kind == "wide":
        return _clusters(rng, [3, 300, 1, 12, 40, 9, 257, 2, 130, 1]), 800
    # more segments than one batch holds: n = 2^20 cuts the budget to 512
    # columns, 256 two-column segments a batch
    return _clusters(rng, [2] * 600 + [3] * 20 + [1] * 5), 1 << 20


@pytest.mark.parametrize("kind", ["singletons", "narrow", "wide",
                                  "over_budget"])
def test_plan_cluster_orth_equals_jax(kind):
    rng = np.random.default_rng(21)
    lam, n = _lam_set(kind, rng)
    norm_t = float(np.abs(lam).max())
    gap = 1e-8
    C = lam.shape[0]
    got = tref.plan_cluster_orth(lam, norm_t, gap, C, n)
    ref = jref.plan_cluster_orth(lam, norm_t, gap, C, n)
    assert got[0] == ref[0]                                    # sig
    for a, b in zip(got[1:3], ref[1:3]):                       # starts, widths
        assert len(a) == len(b)
        assert all(np.array_equal(x, y) and x.dtype == y.dtype
                   for x, y in zip(a, b))
    for a, b in zip(got[3:6], ref[3:6]):      # seg_of_col, srcpos, mask_plan
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert got[6] == ref[6] and got[7] == ref[7]     # seg_ranges, wide segs
    if kind == "over_budget":
        assert sum(1 for s in got[0] if s[1] == 2) >= 3   # 600 segs, 3 batches
    if kind == "wide":
        assert got[7] and any(not s[2] for s in got[0])   # wide, non-narrow


def _plan_input(rng):
    """(lam, V): clusters of every bucket kind and near-orthonormal columns
    (an orthonormal basis plus 1e-9 noise), with the columns of one
    two-column segment made equal: a rank-deficient segment the CholeskyQR
    must reject."""
    lam = _clusters(rng, [1, 2, 3, 1, 6, 12, 1, 2, 20, 1])
    n, C = 80, lam.shape[0]
    Q, _ = np.linalg.qr(rng.standard_normal((n, C)))
    V = Q + 1e-9 * rng.standard_normal((n, C))
    V[:, 2] = V[:, 1]                                   # segment (1, 3)
    return lam, V


def test_apply_cluster_orth_plan_matches_jax():
    rng = np.random.default_rng(22)
    lam, V = _plan_input(rng)
    n, C = V.shape
    plan = tref.plan_cluster_orth(lam, float(np.abs(lam).max()), 1e-8, C, n)
    sig, starts_l, widths_l, seg_of_col, srcpos, mask_plan = plan[:6]
    tt = torch.as_tensor
    Vt = tt(V)
    got, ok = tref.apply_cluster_orth_plan(
        Vt, sig, [tt(a) for a in starts_l], [tt(a) for a in widths_l],
        tt(seg_of_col), tt(srcpos), tt(mask_plan))
    ref, ok_ref = jref.apply_cluster_orth_plan(
        jnp.asarray(V), sig, tuple(jnp.asarray(a) for a in starts_l),
        tuple(jnp.asarray(a) for a in widths_l), jnp.asarray(seg_of_col),
        jnp.asarray(srcpos), jnp.asarray(mask_plan))
    ok, ok_ref = ok.numpy(), np.asarray(ok_ref)
    assert np.array_equal(ok, ok_ref)
    assert not ok[plan[6].index((1, 3))] and ok.sum() == ok.size - 1
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-13
    assert got.data_ptr() != Vt.data_ptr()              # a new tensor
    # the rejected segment and every unplanned column keep their input
    keep = ~mask_plan
    keep[1:3] = True
    assert np.array_equal(got.numpy()[:, keep], V[:, keep])


def test_apply_cluster_orth_plan_nothing_planned():
    V = torch.as_tensor(np.eye(6)[:, :4])
    plan = tref.plan_cluster_orth(np.arange(4.0), 3.0, 1e-8, 4, 6)
    assert plan[0] == ()
    out, ok = tref.apply_cluster_orth_plan(V, plan[0], [], [],
                                           *(torch.as_tensor(a)
                                             for a in plan[3:6]))
    assert out is V and ok.numel() == 0


def _tridiag(n):
    rng = np.random.default_rng(n)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


@functools.lru_cache(maxsize=4)
def _jax_fused(n, select):
    """The JAX package's fused route (forced on the CPU): eigenvalues."""
    import os
    d, e = _tridiag(n)
    cfg = se.SolverConfig(leaf_size=32, mixed_precision_vectors=True)
    os.environ["SE_FORCE_FUSED_BT"] = "1"
    try:
        res, _ = j_solve_staged(d, e, config=cfg,
                                compute_vectors=select is None,
                                select=None if select is None
                                else np.arange(0, n, select))
    finally:
        del os.environ["SE_FORCE_FUSED_BT"]
    return np.asarray(res.eigenvalues)


def _port(n, override, monkeypatch, select=None):
    d, e = _tridiag(n)
    monkeypatch.setattr(driver, "FUSED_BT_OVERRIDE", override)
    return st.solve_tridiagonal_staged(
        d, e, config=st.SolverConfig(leaf_size=32), device="cpu",
        compute_vectors=select is None, select=select)


def _checks(n, lam, V, cols):
    d, e = _tridiag(n)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    norm_t = np.abs(lam).max()
    lam_c = lam[cols]
    assert np.abs(T @ V - V * lam_c[None, :]).max() <= 1e-12 * norm_t
    assert np.abs(V.T @ V - np.eye(V.shape[1])).max() <= 1e-11


@pytest.mark.parametrize("n", [256, 700])
def test_fused_route_matches_staged_and_jax(n, monkeypatch):
    """n=256 (leaf 32: the PyTorch inverse-iteration solver) and n=700 (the
    Spike passes' plain versions): the same eigenvalues as the staged
    route bit for bit and as the JAX fused route to 1e-13 ||T||, every
    residual and the orthogonality within the limits, and the fused
    route's sub-phases only."""
    staged, _ = _port(n, False, monkeypatch)
    fused, timer = _port(n, True, monkeypatch)
    lam = fused.eigenvalues.numpy()
    assert np.array_equal(lam, staged.eigenvalues.numpy())
    ref = _jax_fused(n, None)
    assert np.abs(lam - ref).max() <= 1e-13 * np.abs(ref).max()
    V = fused.eigenvectors.numpy()
    assert V.shape == (n, n) and V.dtype == np.float64
    _checks(n, lam, V, np.arange(n))
    bt = {k for k in timer.times if k.startswith("bt.")}
    assert "bt.fused_bt" in bt and bt <= FUSED_NAMES
    assert not bt & STAGED_ONLY
    assert set(timer.counts) >= {"risky", "rescue"}


@pytest.mark.parametrize("n", [256, 700])
def test_fused_route_select(n, monkeypatch):
    """A selection of every third column (ascending order)."""
    sel = np.arange(0, n, 3)
    res, timer = _port(n, True, monkeypatch, select=sel)
    lam = res.eigenvalues.numpy()
    ref = _jax_fused(n, 3)
    assert np.abs(lam - ref).max() <= 1e-13 * np.abs(ref).max()
    V = res.eigenvectors.numpy()
    assert V.shape == (n, sel.size)
    _checks(n, lam, V, sel)
    assert "bt.fused_bt" in timer.times


def test_fused_route_two_solves_distinct(monkeypatch):
    """Two fused solves in a row return distinct tensors, both right (on
    the card part A's output lives in the graph's pool and is
    overwritten by the next replay)."""
    r1, _ = _port(256, True, monkeypatch)
    r2, _ = _port(256, True, monkeypatch)
    assert r1.eigenvectors.data_ptr() != r2.eigenvectors.data_ptr()
    for r in (r1, r2):
        _checks(256, r.eigenvalues.numpy(), r.eigenvectors.numpy(),
                np.arange(256))
    assert torch.equal(r1.eigenvectors, r2.eigenvectors)


def test_fused_route_f32_mode(monkeypatch):
    """float32 mode takes the fused route after its widening to f64."""
    d, e = _tridiag(256)
    monkeypatch.setattr(driver, "FUSED_BT_OVERRIDE", True)
    res, timer = st.solve_tridiagonal_staged(
        d, e, config=st.SolverConfig(leaf_size=32, dtype=torch.float32),
        device="cpu", compute_vectors=True)
    assert "bt.fused_bt" in timer.times
    V = res.eigenvectors
    assert V.dtype == torch.float32
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    lam = res.eigenvalues.double().numpy()
    Vn = V.double().numpy()
    assert np.abs(T @ Vn - Vn * lam).max() <= 1e-5 * np.abs(lam).max()


_CFG = st.SolverConfig()


@pytest.mark.parametrize("case,args,override,want", [
    ("no_vectors", (256, _CFG, False, False, 256), True, False),
    ("leaf_only", (256, _CFG, True, True, 256), True, False),
    ("not_mixed", (256, st.SolverConfig(mixed_precision_vectors=False),
                   False, True, 256), True, False),
    ("one_refine_step", (256, st.SolverConfig(refine_steps=1), False, True,
                         256), True, False),
    ("one_column", (256, _CFG, False, True, 1), True, False),
    ("n_over_8192", (8193, _CFG, False, True, 8193), True, False),
    ("default_closed", (8192, _CFG, False, True, 8192), None, False),
    ("forced_open", (8192, _CFG, False, True, 8192), True, True),
    ("forced_open_two_columns", (256, _CFG, False, True, 2), True, True),
])
def test_fused_gate(case, args, override, want, monkeypatch):
    """Each case that closes the gate (the default among them), and the
    forced opening at the edges of the size range (n = 8192, C = 2)."""
    if override is not None:
        monkeypatch.setattr(driver, "FUSED_BT_OVERRIDE", override)
    assert driver._fused_bt_enabled(*args) is want, case


def test_closed_gate_takes_the_staged_route(monkeypatch):
    """The default solve and one selected column (even when forced open)
    take the staged route; the unstaged solve_tridiagonal never takes the
    fused one."""
    d, e = _tridiag(256)
    _, timer = st.solve_tridiagonal_staged(
        d, e, config=st.SolverConfig(leaf_size=32), device="cpu",
        compute_vectors=True)
    assert "bt.fused_bt" not in timer.times and "bt.downsweep" in timer.times
    res, timer = _port(256, True, monkeypatch, select=np.array([7]))
    assert "bt.fused_bt" not in timer.times and "bt.downsweep" in timer.times
    calls = []
    monkeypatch.setattr(driver, "_fused_backtransform",
                        lambda *a, **k: calls.append(1))
    st.solve_tridiagonal(d, e, compute_vectors=True, device="cpu",
                         config=st.SolverConfig(leaf_size=32))
    assert not calls
