"""PyTorch port, the multi-device mesh (``dist/mesh.py`` and the driver's
mesh branches) on logical CPU shards, against the JAX package's mesh
solves on the suite's 8 virtual CPU devices.

The five solve tests are the counterparts of ``tests/test_sharding.py``'s,
with the same inputs (``rng``, seed 1234), n, leaf sizes and limits, on
``make_mesh(devices=[cpu] * 8)`` and ``[cpu] * 4``; each also holds its
eigenvalues against the JAX package's mesh solve of the same input to
1e-13 ||T|| (the two upsweeps round differently in the last bits: its
leaf solver and secular sums are not the port's).  Bit for bit where it
must hold: a one-device mesh against no mesh, and the slot-sharded root
merge (tau, zhat, column norms) against the unsharded one through the
plain secular_solve.
"""

import functools

import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu.core.tridiag import dense_from_tridiag
from symmetric_eigenvalue_tpu.dist.mesh import make_mesh as jax_make_mesh
from symmetric_eigenvalue_tpu_torch import driver
from symmetric_eigenvalue_tpu_torch.dist import mesh as tmesh
from symmetric_eigenvalue_tpu_torch.kernels import secular as tsec
from symmetric_eigenvalue_tpu_torch.utils import timing

CPU = torch.device("cpu")


def cpu_mesh(ndev):
    return tmesh.make_mesh(devices=[CPU] * ndev)


def _inputs(name):
    """Each JAX sharding test's input, drawn as that test draws it."""
    rng = np.random.default_rng(1234)
    n = {"solve": 128, "eigvals": 96, "small_mesh": 64, "staged_mixed": 2048,
         "staged_chunked": 96}[name]
    scale = 3.0 if name in ("solve", "staged_mixed") else 1.0
    return rng.standard_normal(n) * scale, rng.standard_normal(n - 1)


@functools.lru_cache(maxsize=None)
def _jax_mesh_eigenvalues(name, leaf, ndev):
    """The JAX package's mesh solve of ``_inputs(name)``: eigenvalues."""
    d, e = _inputs(name)
    lam = se.eigh_tridiagonal(d, e, eigvals_only=True,
                              config=se.SolverConfig(leaf_size=leaf),
                              mesh=jax_make_mesh(ndev))
    return np.asarray(lam)


def _resid_ortho(d, e, lam, V):
    T = dense_from_tridiag(d, e)
    return (np.abs(T @ V - V * lam[None, :]).max(),
            np.abs(V.T @ V - np.eye(V.shape[1])).max())


@pytest.mark.parametrize("ndev", [8, 4])
def test_sharded_solve_matches_unsharded(rng, ndev):
    n = 128
    d = rng.standard_normal(n) * 3
    e = rng.standard_normal(n - 1)
    cfg = st.SolverConfig(leaf_size=8)   # 16 leaves over the shards
    lam0, V0 = st.eigh_tridiagonal(d, e, config=cfg, device="cpu")
    lam1, V1 = st.eigh_tridiagonal(d, e, config=cfg, mesh=cpu_mesh(ndev))
    assert np.allclose(lam0.numpy(), lam1.numpy(), atol=1e-13)
    lam1, V1 = lam1.numpy(), V1.numpy()
    nT = np.abs(lam1).max()
    resid, ortho = _resid_ortho(d, e, lam1, V1)
    assert resid < 1e-12 * nT and ortho < 1e-12
    assert np.abs(lam1 - _jax_mesh_eigenvalues("solve", 8, 8)).max() \
        <= 1e-13 * nT


@pytest.mark.parametrize("ndev", [8, 4])
def test_sharded_eigvals_only(rng, ndev):
    n = 96
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    lam = st.eigh_tridiagonal(d, e, eigvals_only=True,
                              config=st.SolverConfig(leaf_size=4),
                              mesh=cpu_mesh(ndev)).numpy()
    wref = np.linalg.eigvalsh(dense_from_tridiag(d, e))
    assert np.abs(lam - wref).max() < 1e-12
    assert np.abs(lam - _jax_mesh_eigenvalues("eigvals", 4, 8)).max() \
        <= 1e-13 * np.abs(wref).max()


@pytest.mark.parametrize("ndev", [4, 8])
def test_mesh_smaller_than_leaves(rng, ndev):
    """Mesh larger than some level batch sizes: the top levels replicate
    their deflation and shard their roots over slots."""
    n = 64
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    lam, V = st.eigh_tridiagonal(d, e, config=st.SolverConfig(leaf_size=16),
                                 mesh=cpu_mesh(ndev))
    lam = lam.numpy()
    wref = np.linalg.eigvalsh(dense_from_tridiag(d, e))
    assert np.abs(lam - wref).max() < 1e-12
    assert np.abs(lam - _jax_mesh_eigenvalues("small_mesh", 16, 4)).max() \
        <= 1e-13 * np.abs(wref).max()


@pytest.mark.parametrize("ndev", [8, 4])
def test_staged_mixed_sharded_at_scale(rng, ndev):
    """The default pipeline (staged, mixed precision, column-chunked
    stepped downsweep, Spike refinement) at n=2048 over the mesh."""
    n = 2048
    d = rng.standard_normal(n) * 3
    e = rng.standard_normal(n - 1)
    cfg = st.SolverConfig(leaf_size=64, vec_chunk=1024,
                          mixed_precision_vectors=True)
    res, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                         compute_vectors=True,
                                         mesh=cpu_mesh(ndev))
    lam = res.eigenvalues.numpy()
    V = res.eigenvectors.numpy()
    nT = np.abs(lam).max()
    resid = np.abs(d[:, None] * V
                   + np.vstack([e[:, None] * V[1:], np.zeros((1, n))])
                   + np.vstack([np.zeros((1, n)), e[:, None] * V[:-1]])
                   - V * lam[None, :]).max()
    assert resid < 1e-12 * nT
    assert np.abs(V.T @ V - np.eye(n)).max() < 1e-10
    assert np.abs(lam - _jax_mesh_eigenvalues("staged_mixed", 64, 8)).max() \
        <= 1e-13 * nT


@pytest.mark.parametrize("ndev", [8, 4])
def test_staged_chunked_with_mesh(rng, ndev):
    """Stepped downsweep + column chunking + mesh (slot-sharded top
    merges)."""
    n = 96
    d = rng.standard_normal(n)
    e = rng.standard_normal(n - 1)
    cfg = st.SolverConfig(leaf_size=8, vec_chunk=32)
    res, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                         compute_vectors=True,
                                         mesh=cpu_mesh(ndev))
    lam = res.eigenvalues.numpy()
    V = res.eigenvectors.numpy()
    nT = np.abs(lam).max()
    resid, ortho = _resid_ortho(d, e, lam, V)
    assert resid < 1e-12 * nT and ortho < 1e-12
    assert np.abs(lam - _jax_mesh_eigenvalues("staged_chunked", 8, 8)).max() \
        <= 1e-13 * nT


@pytest.mark.parametrize("mixed", [True, False])
def test_one_device_mesh_is_bit_for_bit_no_mesh(rng, mixed):
    n = 640                       # the Spike route (n >= 512) when mixed
    d = rng.standard_normal(n) * 5
    e = rng.standard_normal(n - 1) * 2
    cfg = st.SolverConfig(leaf_size=16, mixed_precision_vectors=mixed)
    r0, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                        compute_vectors=True, device="cpu")
    r1, _ = st.solve_tridiagonal_staged(d, e, config=cfg,
                                        compute_vectors=True,
                                        mesh=cpu_mesh(1))
    assert torch.equal(r0.eigenvalues, r1.eigenvalues)
    assert torch.equal(r0.eigenvectors, r1.eigenvectors)


def _level_partition(rng, m, kw):
    """One wide merge (k=1) of two random halves, as merge_partition leaves
    it."""
    h = m // 2
    d = np.concatenate([np.sort(rng.standard_normal(h)),
                        np.sort(rng.standard_normal(h))])
    z = rng.standard_normal(m)
    z /= np.linalg.norm(z)
    return tsec.merge_partition(
        torch.as_tensor(d)[None], torch.as_tensor(z)[None],
        torch.tensor([0.7], dtype=torch.float64), eps=kw["eps"],
        deflation_factor=kw["deflation_factor"])


@pytest.mark.parametrize("ndev", [8, 4])
def test_slot_sharded_merge_roots_bit_for_bit(rng, ndev, monkeypatch):
    kw = driver._merge_kwargs(st.SolverConfig())
    roots_kw = {k: kw[k] for k in ("eps", "max_secular_iters",
                                   "secular_tol_factor", "use_gu_eisenstat")}
    m = 256
    part = _level_partition(rng, m, kw)
    ref = tsec.merge_roots(part, block_size=64, **roots_kw)
    owned = []
    inner = tsec.secular_solve

    def recorded(setup, tolf, max_iters):
        owned.append(int((~setup.done0).sum()))
        return inner(setup, tolf, max_iters)

    monkeypatch.setattr(tsec, "secular_solve", recorded)
    got = tsec.merge_roots(part, block_size=64, slot_mesh=cpu_mesh(ndev),
                           **roots_kw)
    # one solve a shard, each over its own m / ndev slots at most
    assert len(owned) == ndev and max(owned) <= m // ndev
    assert sum(owned) == int(part.K[0])
    for name in tsec.MergeRep._fields:
        assert torch.equal(getattr(ref, name), getattr(got, name)), name


def _shard_calls(monkeypatch):
    calls = []
    inner = tmesh._on_shard

    def recorded(fn, args, device, shard):
        calls.append(shard)
        return inner(fn, args, device, shard)

    monkeypatch.setattr(tmesh, "_on_shard", recorded)
    return calls


def test_batch_mapped_branches(monkeypatch):
    calls = _shard_calls(monkeypatch)
    seen = []

    def fn(x, y):
        seen.append(x.shape[0])
        return x * 2.0 + y[:, :1], (x.sum(dim=1), y.long())

    x = torch.arange(48.0).reshape(16, 3)
    y = torch.arange(32.0).reshape(16, 2)
    want = fn(x, y)
    seen.clear()
    assert tmesh.batch_mapped(fn, None, 16) is fn
    mesh = cpu_mesh(8)
    got = tmesh.batch_mapped(fn, mesh, 16)(x, y)
    assert seen == [2] * 8 and calls == list(range(8))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1][0], want[1][0])
    assert torch.equal(got[1][1], want[1][1])
    for batch in (12, 4):         # not a multiple of 8, or fewer than 8
        seen.clear()
        calls.clear()
        got = tmesh.batch_mapped(fn, mesh, batch)(x[:batch], y[:batch])
        assert seen == [batch] and calls == [None]
        assert torch.equal(got[0], want[0][:batch])


def test_last_axis_sharded_and_replicated(monkeypatch):
    calls = _shard_calls(monkeypatch)
    g = np.random.default_rng(0)
    A = torch.as_tensor(g.standard_normal((6, 5)))
    X = torch.as_tensor(g.standard_normal((5, 16)))
    mesh = cpu_mesh(4)
    widths = []

    def fn(A, X):
        widths.append(X.shape[1])
        return A @ X

    got = tmesh.last_axis_sharded(fn, mesh, (None, 1), 2)(A, X)
    assert widths == [4] * 4 and calls == [0, 1, 2, 3]
    assert torch.equal(got, torch.cat([A @ X[:, o:o + 4]
                                       for o in range(0, 16, 4)], dim=1))
    widths.clear()
    got = tmesh.last_axis_sharded(fn, mesh, (None, 1), 2)(
        tmesh.Replicas(mesh, A), X)
    assert widths == [4] * 4 and torch.allclose(got, A @ X, atol=1e-14)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.last_axis_sharded(fn, mesh, (None, 1), 2)(A, X[:, :6])
    calls.clear()
    assert tmesh.replicated(fn, None) is fn
    assert torch.equal(tmesh.replicated(fn, mesh)(A, X), A @ X)
    assert calls == [None]


def test_make_mesh(monkeypatch):
    mesh = cpu_mesh(8)
    assert (mesh.size, mesh.lead, mesh.num_processes, mesh.first_shard) \
        == (8, CPU, 1, 0)
    with pytest.raises(ValueError, match="not both"):
        tmesh.make_mesh(2, devices=[CPU] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        tmesh.make_mesh()
    # a host with two cards: distinct cards, and no silent cut
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.make_mesh().devices == (torch.device("cuda", 0),
                                         torch.device("cuda", 1))
    assert tmesh.make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="2 CUDA card"):
        tmesh.make_mesh(3)
    with pytest.raises(ValueError, match="does not exist"):
        tmesh.make_mesh(devices=["cuda:2"])
    with pytest.raises(ValueError, match="process_id"):
        tmesh.distributed_init("localhost:1", 2, 2)
    with pytest.raises(ValueError, match="needs"):
        tmesh.distributed_init("localhost:1", 2)


def test_fused_route_closed_under_a_mesh(monkeypatch):
    monkeypatch.setattr(driver, "FUSED_BT_OVERRIDE", True)
    cfg = st.SolverConfig()
    assert driver._fused_bt_enabled(4096, cfg, False, True, 4096)
    assert not driver._fused_bt_enabled(4096, cfg, False, True, 4096,
                                        cpu_mesh(2))
    # and a solve under a mesh takes the staged route
    g = np.random.default_rng(3)
    d, e = g.standard_normal(600), g.standard_normal(599)
    _, timer = st.solve_tridiagonal_staged(d, e, config=cfg,
                                           compute_vectors=True,
                                           mesh=cpu_mesh(2))
    assert "bt.downsweep" in timer.times and "bt.fused_bt" not in timer.times


def test_device_other_than_the_mesh_lead_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    d, e = np.ones(16) * 2, -np.ones(15)
    mesh = cpu_mesh(2)
    with pytest.raises(ValueError, match="lead device"):
        st.solve_tridiagonal_staged(d, e, device="cuda:1", mesh=mesh)
    with pytest.raises(ValueError, match="lead device"):
        st.eigh(np.eye(4), device="cuda:1", mesh=mesh)
    lam = st.eigh_tridiagonal(d, e, eigvals_only=True, device="cpu",
                              mesh=mesh)
    assert lam.device == CPU


def test_grouped_route_shards_each_group(monkeypatch):
    """The grouped route under a mesh: every group's downsweep sharded by
    column, the O(n) reps and Q_leaf copied once a solve (not a group),
    the eigenpairs those of the unsharded grouped solve."""
    monkeypatch.setattr(driver, "_grouped_bt_bytes", lambda device: 1.0)
    made = []
    inner = tmesh.Replicas.__init__

    def counted(self, mesh, value):
        made.append(mesh.size)
        inner(self, mesh, value)

    monkeypatch.setattr(tmesh.Replicas, "__init__", counted)
    g = np.random.default_rng(5)
    n = 1024
    d, e = g.standard_normal(n) * 5, g.standard_normal(n - 1) * 2
    cfg = st.SolverConfig(vec_chunk=256)     # four groups of 256 columns
    r0, t0 = st.solve_tridiagonal_staged(d, e, config=cfg,
                                         compute_vectors=True, device="cpu")
    r1, t1 = st.solve_tridiagonal_staged(d, e, config=cfg,
                                         compute_vectors=True,
                                         mesh=cpu_mesh(4))
    assert made == [4]
    assert "bt.downsweep_refine_grouped" in t1.times
    lam = r1.eigenvalues.numpy()
    nT = np.abs(lam).max()
    assert np.abs(lam - r0.eigenvalues.numpy()).max() <= 1e-13 * nT
    resid, ortho = _resid_ortho(d, e, lam, r1.eigenvectors.numpy())
    assert resid < 1e-12 * nT and ortho < 1e-10


@pytest.mark.parametrize("band", [0, 3])
def test_dense_and_banded_front_ends_take_a_mesh(band):
    g = np.random.default_rng(11)
    n = 96
    G = g.standard_normal((n, n))
    A = (G + G.T) / 2
    if band:
        A = np.triu(np.tril(A, band), -band)
    mesh = cpu_mesh(4)
    cfg = st.SolverConfig(leaf_size=8)
    if band:
        ab = np.zeros((band + 1, n))
        for k in range(band + 1):
            ab[band - k, k:] = np.diag(A, k)
        lam, V = st.eigh_banded(ab, config=cfg, mesh=mesh)
    else:
        lam, V = st.eigh(A, config=cfg, mesh=mesh)
    lam, V = lam.numpy(), V.numpy()
    nA = np.abs(lam).max()
    assert np.abs(lam - np.linalg.eigvalsh(A)).max() <= 1e-12 * nA
    assert np.abs(A @ V - V * lam).max() <= 1e-12 * nA
    assert np.abs(V.T @ V - np.eye(n)).max() <= 1e-12


def test_timer_syncs_every_mesh_device(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(torch.device(d)))
    devs = (torch.device("cuda", 0), torch.device("cuda", 1),
            torch.device("cuda", 0), CPU)
    timer = timing.PhaseTimer(devs)
    with timer.phase("x"):
        pass
    assert synced == [torch.device("cuda", 0), torch.device("cuda", 1)]
    synced.clear()
    timing.sync(device=torch.device("cuda", 1))
    assert synced == [torch.device("cuda", 1)]
