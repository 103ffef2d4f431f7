"""PyTorch port, two-stage front end: band reduction, bulge chases and their
backtransforms held against the JAX package's on the same matrices (CPU,
f64), elementwise to 2e-12 n (entries are O(1)): each reduction is a chain
of ~n dependent reflectors, backward but not forward stable, so the two
packages' different roundings of one step feed all later ones (5e-11 was
seen at n=64 on a draw with one short column; a wrong sign or index gives
O(1))."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import band_reduce as jband
from symmetric_eigenvalue_tpu_torch import _build, interop
from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as tband
from symmetric_eigenvalue_tpu_torch.kernels.tridiagonalize import apply_q


def _tol(n):
    return 2e-12 * n


def _sym(rng, n, band=None):
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    if band is not None:
        i = np.arange(n)
        A[np.abs(i[:, None] - i[None, :]) > band] = 0.0
    return A


def _tridiag(d, e):
    d, e = np.asarray(d), np.asarray(e)
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


def _err(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max(initial=0.0)


@pytest.mark.parametrize("n,b,buckets", [(64, 8, 1), (96, 16, 1),
                                         (100, 8, 1), (33, 8, 1),
                                         (130, 16, 4), (100, 8, 3)])
def test_reduce_to_band_matches_jax(rng, n, b, buckets):
    A = _sym(rng, n)
    before = A.copy()
    ref = jband.reduce_to_band(jnp.asarray(A), b, buckets=buckets)
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), b,
                                       buckets=buckets)
    assert np.array_equal(A, before)
    for name, g, r in zip(("B", "Yt", "taus"), (B, Yt, taus), ref):
        assert _err(g.numpy(), r) <= _tol(n), name
    B = B.numpy()
    i = np.arange(n)
    assert np.abs(B[np.abs(i[:, None] - i[None, :]) > b]).max() <= 1e-13
    assert np.array_equal(B, B.T)
    # A Q1 = Q1 B through apply_q with panel = band
    Q = apply_q(Yt, taus, torch.eye(n, dtype=torch.float64), panel=b).numpy()
    assert np.abs(A @ Q - Q @ B).max() <= 1e-12
    assert np.abs(Q.T @ Q - np.eye(n)).max() <= 1e-13
    # eigenvalues-only callers skip the reflector store
    B0, Y0, t0 = tband.reduce_to_band(torch.as_tensor(A), b, buckets=buckets,
                                      want_reflectors=False)
    assert Y0.shape == (1, 1)
    assert np.array_equal(B0.numpy(), B) and torch.equal(t0, taus)


def test_reduce_to_band_small_is_the_identity(rng):
    A = _sym(rng, 6)
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), 8)
    assert np.array_equal(B.numpy(), A)
    assert not Yt.any() and not taus.any()
    A = _sym(rng, 40)                       # n == band: (40, 40) of the JAX test
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), 40)
    assert np.array_equal(B.numpy(), A) and not taus.any()


@pytest.mark.parametrize("n,b", [(24, 2), (96, 8), (130, 8), (128, 16),
                                 (200, 5), (64, 70)])
def test_wavefront_chase_matches_jax(rng, n, b):
    A = _sym(rng, n, band=b)
    dj, ej, (Vj, tj) = jband.band_to_tridiag_wave(jnp.asarray(A), b)
    d, e, (Vw, tw) = tband.band_to_tridiag_wave(torch.as_tensor(A), b)
    assert Vw.shape == np.asarray(Vj).shape and tw.shape == tj.shape
    for name, g, r in (("d", d, dj), ("e", e, ej), ("Vw", Vw, Vj),
                       ("tw", tw, tj)):
        assert _err(g.numpy(), r) <= _tol(n), name
    T = _tridiag(d.numpy(), e.numpy())
    w0 = np.linalg.eigvalsh(A)
    assert np.abs(w0 - np.linalg.eigvalsh(T)).max() <= 1e-12 * max(
        np.abs(w0).max(), 1.0)
    eye = torch.eye(n, dtype=torch.float64)
    Q2 = tband.apply_q2_wave(n, b, (Vw, tw), eye).numpy()
    assert np.abs(Q2.T @ Q2 - np.eye(n)).max() <= 1e-13
    assert np.abs(Q2.T @ A @ Q2 - T).max() <= 1e-12
    # the blocked application against the per-sweep one, and against the
    # JAX package's blocked application of the JAX package's log
    X = rng.standard_normal((n, 7))
    Ya = tband.apply_q2_wave(n, b, (Vw, tw), torch.as_tensor(X)).numpy()
    Yb = tband.apply_q2_wave_blocked(n, b, (Vw, tw),
                                     torch.as_tensor(X)).numpy()
    assert np.abs(Ya - Yb).max() <= 1e-13
    ref = np.asarray(jband.apply_q2_wave_blocked(n, b, (Vj, tj),
                                                 jnp.asarray(X)))
    assert np.abs(Yb - ref).max() <= _tol(n)
    # no log for eigenvalues-only callers, same (d, e)
    d0, e0, (V0, t0) = tband.band_to_tridiag_wave(torch.as_tensor(A), b,
                                                  want_log=False)
    assert V0.shape[0] == 1 and t0.shape[0] == 1
    assert torch.equal(d0, d) and torch.equal(e0, e)


def test_jax_wave_log_through_the_port(rng):
    """The JAX package's reflector log, carried across by interop, through
    the port's two backtransforms: the same Q2 X as the JAX package's."""
    n, b = 100, 8
    A = _sym(rng, n, band=b)
    _, _, (Vj, tj) = jband.band_to_tridiag_wave(jnp.asarray(A), b)
    vlog = interop.wave_log_from_numpy(np.asarray(Vj), np.asarray(tj))
    X = rng.standard_normal((n, 5))
    ref = np.asarray(jband.apply_q2_wave(n, b, (Vj, tj), jnp.asarray(X)))
    for fn in (tband.apply_q2_wave, tband.apply_q2_wave_blocked):
        assert np.abs(fn(n, b, vlog, torch.as_tensor(X)).numpy()
                      - ref).max() <= 1e-12
    with pytest.raises(ValueError):
        interop.wave_log_from_numpy(np.asarray(Vj), np.asarray(tj)[:, :-1])
    with pytest.raises(ValueError):
        interop.wave_log_from_numpy(np.asarray(tj), np.asarray(tj))


def test_jax_band_reflectors_through_the_port(rng):
    n, b = 64, 8
    A = _sym(rng, n)
    out = jband.reduce_to_band(jnp.asarray(A), b)
    B, Yt, taus = interop.band_reflectors_from_numpy(
        *(np.asarray(x) for x in out))
    Q = apply_q(Yt, taus, torch.eye(n, dtype=torch.float64), panel=b).numpy()
    assert np.abs(A @ Q - Q @ B.numpy()).max() <= 1e-12
    with pytest.raises(ValueError, match="Yt"):
        interop.band_reflectors_from_numpy(np.zeros((4, 4)), np.zeros((4, 3)),
                                           np.zeros(4))


def test_chase_schedule_matches_jax():
    for n, b in [(24, 5), (10, 2), (7, 9), (2, 3), (3, 2)]:
        assert np.array_equal(tband._chase_schedule(n, b),
                              jband._chase_schedule(n, b))
    for n, b in [(96, 8), (130, 8), (64, 70), (3, 2), (4096, 128)]:
        assert tband._wave_geometry(n, b) == jband._wave_geometry(n, b)


@pytest.mark.parametrize("n,b", [(48, 6), (40, 3)])
def test_sequential_chase_matches_jax(rng, n, b):
    A = _sym(rng, n, band=b)
    dj, ej, csj = jband.band_to_tridiag(jnp.asarray(A), b)
    d, e, cs = tband.band_to_tridiag(torch.as_tensor(A), b)
    assert _err(d.numpy(), dj) <= _tol(n) and _err(e.numpy(), ej) <= _tol(n)
    assert _err(cs.numpy(), csj) <= _tol(n)
    X = rng.standard_normal((n, 4))
    got = tband.apply_q2(n, b, cs, torch.as_tensor(X)).numpy()
    ref = np.asarray(jband.apply_q2(n, b, csj, jnp.asarray(X)))
    assert np.abs(got - ref).max() <= _tol(n)
    Q2 = tband.apply_q2(n, b, cs, torch.eye(n, dtype=torch.float64)).numpy()
    T = _tridiag(d.numpy(), e.numpy())
    assert np.abs(Q2.T @ A @ Q2 - T).max() <= 1e-12


def test_wavefront_against_the_sequential_chase(rng):
    """Wave and sequential chases produce orthogonally similar tridiagonals
    of the same matrix (eigenvalues equal; entries may differ in sign)."""
    n, b = 72, 6
    A = _sym(rng, n, band=b)
    dw, ew, _ = tband.band_to_tridiag_wave(torch.as_tensor(A), b)
    ds, es, _ = tband.band_to_tridiag(torch.as_tensor(A), b)
    lw = np.linalg.eigvalsh(_tridiag(dw.numpy(), ew.numpy()))
    ls = np.linalg.eigvalsh(_tridiag(ds.numpy(), es.numpy()))
    assert np.abs(lw - ls).max() <= 1e-12


@pytest.mark.parametrize("n,b", [(48, 8), (65, 8)])
def test_two_stage_pipeline(rng, n, b):
    """dense -> band -> tridiagonal, eigenvectors back through Q = Q1 Q2."""
    A = _sym(rng, n)
    B, Yt, taus = tband.reduce_to_band(torch.as_tensor(A), b)
    d, e, vlog = tband.band_to_tridiag_wave(B, b)
    T = _tridiag(d.numpy(), e.numpy())
    Q2 = tband.apply_q2_wave_blocked(n, b, vlog,
                                     torch.eye(n, dtype=torch.float64))
    Q = apply_q(Yt, taus, Q2, panel=b).numpy()
    assert np.abs(A @ Q - Q @ T).max() <= 1e-12
    assert np.abs(Q.T @ Q - np.eye(n)).max() <= 1e-13


@pytest.mark.parametrize("n,b", [(2, 4), (1, 2), (5, 1)])
def test_degenerate_sizes_pass_through(rng, n, b):
    A = _sym(rng, n, band=b)
    d, e, vlog = tband.band_to_tridiag_wave(torch.as_tensor(A), b)
    assert np.array_equal(d.numpy(), np.diag(A))
    assert np.array_equal(e.numpy(), np.diag(A, 1))
    X = torch.as_tensor(rng.standard_normal((n, 3)))
    assert torch.equal(tband.apply_q2_wave(n, b, vlog, X), X)
    assert torch.equal(tband.apply_q2_wave_blocked(n, b, vlog, X), X)


# --------------------------------------------------------------------------
# the chase's device-side schedule, the launch counts, the panel QR, and CPU
# models of the two kernels (csrc/band_reduce.cu) held against the plain
# versions


def _givens_tasks(n, b):
    """(sweep j, hop k) -> (rows, pivot columns) of ``_chase_schedule``'s
    rotations: a chain starts where (pi, pj) does not follow
    (pi + b, pi - 1) from the element before it; its sweep is its first
    pj."""
    tasks = {}
    prev = None
    for pi, pj in tband._chase_schedule(n, b).tolist():
        if prev is not None and pi == prev[0] + b and pj == prev[0] - 1:
            k += 1
        else:
            j, k = pj, 0
        rows, cols = tasks.setdefault((j, k), (set(), set()))
        rows.update((pi - 1, pi))
        cols.add(pj)
        prev = (pi, pj)
    return tasks


def _jax_geometry(n, b):
    """The JAX wave body's slot geometry (band_reduce.py:335-340) for every
    wave: (jj, kk, r, off, valid), each (Twaves, Wmax)."""
    _, Wmax, Twaves = jband._wave_geometry(n, b)
    slots = jnp.arange(Wmax)
    t = jnp.arange(Twaves)[:, None]
    jj = t // 3 - slots
    kk = (t % 3) + 3 * slots
    valid = (jj >= 0) & (jj + kk * b + 2 <= n - 1)
    r = jj + kk * b + 1
    off = jnp.where(kk == 0, 2 * b - 2, b - 1)
    return tuple(np.asarray(x) for x in (jj, kk, r, off, valid))


@pytest.mark.parametrize("n,b", [(24, 5), (10, 2), (7, 9), (64, 70), (97, 8),
                                 (130, 16), (2, 3), (1, 4), (3, 2), (9, 1),
                                 (12, 0)])
def test_device_schedule_matches_jax_and_givens(n, b):
    """wave_slots / wave_width (band_chase's closed form) against the JAX
    wave body's geometry and against the Givens schedule: each live slot is
    one (sweep, hop) task of _chase_schedule, with its rows and the pivot
    column the hop's first rotation zeroes, at wave 3 jj + kk, and every
    task is in exactly one wave."""
    if b < 1:
        # no schedule: the chase passes B through and launches nothing
        assert tband.chase_waves(n, b) == 0
        assert tband.chase_launch_count(n, b) == 0
        return
    _, Wmax, Twaves = tband._wave_geometry(n, b)
    t = np.arange(Twaves)[:, None]
    s = np.arange(Wmax)[None, :]
    jj, kk, r, off, live = tband.wave_slots(n, b, t, s)
    ref = _jax_geometry(n, b)
    for name, got, want in zip(("jj", "kk", "r", "off", "live"),
                               (jj, kk, r, off, live), ref):
        assert np.array_equal(got, want), name
    # the live slots are a prefix of their wave, of width wave_width
    assert np.array_equal(live.sum(axis=1), tband.wave_width(n, b, t[:, 0]))
    assert np.array_equal(live, s < live.sum(axis=1, keepdims=True))
    tasks = {(int(a), int(c)): (int(rr), int(o)) for a, c, rr, o in
             zip(jj[live], kk[live], r[live], off[live])}
    assert len(tasks) == int(live.sum())
    assert np.array_equal(3 * jj[live] + kk[live],
                          np.broadcast_to(t, live.shape)[live])
    if n < 3 or b < 2:
        # the chase passes B through: no task runs, nothing is launched
        assert tband.chase_waves(n, b) == tband.chase_tasks(n, b) == 0
        assert tband.chase_launch_count(n, b) == 0
        assert not live.any() or b < 2
        return
    assert len(tasks) == tband.chase_tasks(n, b)
    givens = _givens_tasks(n, b)
    assert set(tasks) == set(givens)
    for (j, k), (rr, o) in tasks.items():
        rows, cols = givens[(j, k)]
        assert rows == set(range(rr, min(rr + b, n))), (j, k)
        assert rr - (2 * b - 1) + o == min(cols) == (j if k == 0 else
                                                     j + (k - 1) * b + 1)
    assert tband.chase_waves(n, b) == int(ref[4].any(axis=1).sum())
    assert tband.chase_launch_count(n, b) == 1


def test_launch_count_formulas(monkeypatch):
    """The counts chip_smoke.py requires of a two-stage solve: one
    band_chase launch a chase, panel_qr_count(n, b) panel QRs (each with a
    live column) across every bucket split; and the chase sizes the
    bounds are computed from."""
    calls = []

    def counting(As, o, b, Yp, tp):
        calls.append(min(b, As.shape[0] - o - b))
        tband.panel_qr_plain(As, o, b, Yp, tp)

    monkeypatch.setattr(tband, "panel_qr", counting)
    rng = np.random.default_rng(5)
    for n, b, buckets in [(40, 4, 1), (41, 4, 3), (37, 8, 2), (10, 8, 1),
                          (9, 8, 1), (30, 3, 4)]:
        calls.clear()
        tband.reduce_to_band(torch.as_tensor(_sym(rng, n)), b,
                             buckets=buckets)
        assert len(calls) == tband.panel_qr_count(n, b), (n, b, buckets)
        assert all(c > 0 for c in calls)
    assert (tband.chase_tasks(4096, 128), tband.chase_tasks(4096, 16)) == (
        67520, 525824)
    assert tband.chase_waves(4096, 128) <= 3 * (4096 - 3) + 1 == 12280
    assert tband.chase_launch_count(4096, 128) == 1
    assert tband.panel_qr_count(4096, 128) == 31
    # one grid sync a wave (and sweep 0's first reflector, the packing)
    assert tband.chase_grid_syncs(4096, 128) == 12155
    assert tband.chase_grid_syncs(3, 2) == 3 and tband.chase_grid_syncs(2, 2) == 0


@pytest.mark.parametrize("m,b,ncols", [(40, 4, 8), (50, 8, 16), (21, 8, 16),
                                       (64, 16, 32)])
def test_panel_qr_plain_matches_jax_col_body(rng, m, b, ncols):
    """panel_qr_plain, as _reduce_block drives it panel by panel, against
    the JAX col_body loop's Yp and tp (its _reduce_block's reflector rows
    and taus), including a last panel with fewer live columns than b
    (m=21, b=8: its second panel has 5)."""
    A = _sym(rng, m)
    _, Yj, tj = jband._reduce_block(jnp.asarray(A), ncols, b, False)
    As = torch.as_tensor(A.copy())
    Ytb, taus = tband._reduce_block(As, ncols, b)
    assert _err(Ytb.numpy(), Yj) <= _tol(m)
    assert _err(taus.numpy(), tj) <= _tol(m)
    # one panel alone: the plain QR leaves As as it was
    As0 = torch.as_tensor(A.copy())
    Yp, tp = As0.new_zeros((b, m)), As0.new_zeros(b)
    tband.panel_qr_plain(As0, 0, b, Yp, tp)
    assert np.array_equal(As0.numpy(), A)
    assert np.array_equal(Yp.numpy(), Ytb[:b].numpy())
    assert np.array_equal(tp.numpy(), taus[:b].numpy())


def _reflector(x):
    """The chase's reflector of x (b entries): (v, tau, the pivot's new
    value), as the plain chase and band_chase form it."""
    sigma2 = float(np.dot(x[1:], x[1:]))
    x0 = x[0]
    nrm = np.sqrt(x0 * x0 + sigma2)
    beta = -nrm if x0 >= 0 else nrm
    no_op = sigma2 == 0.0
    v = x / (1.0 if no_op else x0 - beta)
    v[0] = 0.0 if no_op else 1.0
    tau = 0.0 if no_op else (beta - x0) / beta
    return v, tau, x0 if no_op else beta


def _chase_model(B, b, want_log=True, chunk=64, whole=False, events=None,
                 grid=None, waves=None):
    """numpy model of band_chase: B's lower band stored once, by column
    (entry (i, c), c <= i <= c + 3b - 2, at [c + 2b, i - c]); sweep 0's
    first reflector formed before wave 0, then each wave as the kernel runs
    it, one grid sync a wave: each slot's items (chase_slot_items) read the
    state the wave started from and the slot's reflector from its record;
    the diagonal block updated as one symmetric rank-2 update (LAPACK's
    dlarfy); the ``next`` item forms the next hop's reflector from the
    pivot column it has just updated, writes its record and log entry and
    sets the column to (beta, 0, ..); a wave t = 3j' - 1 has one more item,
    sweep j''s first reflector from column j' (final since wave 3j' - 2).
    Asserted every wave: each write inside the storage, each entry written
    at most once, no entry an item reads written by another item; and of
    every reflector, that no item writes the entries it was formed from
    between the wave that forms it and the wave that uses it (the zeroing
    of its pivot column by the item that forms it aside).  ``events``, a
    list, receives (task, wave formed, wave used); ``waves``, a list, the
    waves that ran an item (each ends in a grid sync).  With ``grid`` each wave
    takes the chunk band_chase picks for that many blocks
    (chase_wave_chunk, ``chunk`` the widest), else ``chunk`` throughout."""
    n = B.shape[0]
    plan = tband.ChasePlan(grid or 0, 0, 0, True, chunk, whole)
    H, ldq = 3 * b - 2, 3 * b - 1
    Kmax, Wmax, Twaves = tband._wave_geometry(n, b)
    Q = np.zeros((n + 3 * b, ldq))
    i = np.arange(n)[:, None]
    c = i - np.arange(ldq)[None, :]
    ok = c >= 0
    Q[c[ok] + 2 * b, (i - c)[ok]] = B[np.broadcast_to(i, c.shape)[ok], c[ok]]

    def at(rows, cols):
        """Flat indices into Q of the lower entries (rows, cols)."""
        rows, cols = np.broadcast_arrays(np.asarray(rows), np.asarray(cols))
        qc, o = cols + 2 * b, rows - cols
        assert (qc >= 0).all() and (qc < Q.shape[0]).all()
        assert (o >= 0).all() and (o < ldq).all()
        return qc * ldq + o

    Vw = np.zeros((n - 1 if want_log else 1, Kmax, b))
    tw = np.zeros(Vw.shape[:2])
    rb = np.arange(b)
    records = {}              # task -> (v, tau, wave formed, pivot entries)
    used = {}
    last = {}                 # entry -> (wave, item) of its last write

    def form(task, x, piv, t, item, reads, writes):
        v, tau, beta = _reflector(x.copy())
        assert task not in records, task
        records[task] = (v, tau, t, piv)
        if want_log:
            Vw[task], tw[task] = v, tau
        reads.append(piv)
        newcol = np.zeros(b)
        newcol[0] = beta
        writes.append((piv, newcol))

    def strip(r, c0, c1):
        """Flat indices (b, c1 - c0) of the strip's columns c0 .. c1 - 1."""
        c = np.arange(c0, c1)[None, :]
        rows = r + rb[:, None]
        left = at(rows, np.minimum(r - 2 * b + 1 + c, rows))
        right = at(np.maximum(r - b + 1 + c, rows), rows)
        return np.where(c < 2 * b - 1, left, right)

    for t in range(-1, Twaves):
        Q0 = Q.ravel().copy()
        W = tband.wave_width(n, b, t) if t >= 0 else 0
        j1 = (t + 1) // 3
        hop0 = (t + 1) % 3 == 0 and j1 <= n - 3
        wave_chunk = tband.chase_wave_chunk(b, plan, W, hop0)
        items = []
        for s in range(W):
            jj, kk, r, off, _ = (int(x) for x in tband.wave_slots(n, b, t, s))
            v, tau, tf, _ = records[(jj, kk)]
            assert tf < t
            used[(jj, kk)] = t
            for kind, c0, c1 in tband.chase_slot_items(b, wave_chunk, whole):
                items.append((kind, c0, c1, s, jj, kk, r, v, tau))
        if hop0:
            items.append(("hop0", 0, 0, -1, j1, 0, 0, None, 0.0))
        if items and waves is not None:
            waves.append(t)
        # the next items of a slot are one group: the last of them to finish
        # forms the reflector from the parts the others left (ordered by
        # their arrival count); every other item is a group of its own
        group = [len(items) + it[3] if it[0] == "next" else g
                 for g, it in enumerate(items)]
        parts = {}
        reads_all, writes_all = [], []
        for it, (kind, c0, c1, s, jj, kk, r, v, tau) in enumerate(items):
            reads, writes = [], []
            if kind == "hop0":
                piv = at(jj + 1 + rb, jj)
                form((jj, 0), Q0[piv], piv, t, it, reads, writes)
            if kind in ("diag", "task"):
                idx = at(r + np.maximum(rb[:, None], rb[None, :]),
                         r + np.minimum(rb[:, None], rb[None, :]))
                D = Q0[idx]                       # the symmetric block
                w = tau * (D @ v)
                w += (-0.5 * tau * np.dot(w, v)) * v
                D = D - np.outer(v, w) - np.outer(w, v)
                low = rb[:, None] >= rb[None, :]
                reads.append(idx[low])
                writes.append((idx[low], D[low]))
            if kind in ("left", "next", "right", "task"):
                if kind == "task":
                    c0, c1 = 0, 4 * b - 2
                idx = strip(r, c0, c1)
                S = Q0[idx]
                reads.append(idx.ravel())
                S = S - np.outer(v, tau * (v @ S))
                keep = np.ones(S.shape, dtype=bool)
                pc = (2 * b - 2 if kk == 0 else b - 1) - c0
                if 0 <= pc < c1 - c0:
                    keep[:, pc] = False           # the pivot column: as formed
                lo, hi = max(c0, 2 * b - 1), min(c1, 3 * b - 1)
                if lo < hi and jj + (kk + 1) * b + 2 <= n - 1:
                    cs = slice(lo - c0, hi - c0)
                    keep[0, cs] = False
                    x, piv, left = parts.setdefault(s, (np.zeros(b),
                                                        np.zeros(b, int), [b]))
                    x[lo - 2 * b + 1:hi - 2 * b + 1] = S[0, cs]
                    piv[lo - 2 * b + 1:hi - 2 * b + 1] = idx[0, cs]
                    left[0] -= hi - lo
                    if left[0] == 0:              # the last part
                        form((jj, kk + 1), x, piv, t, it, reads, writes)
                writes.append((idx[keep], S[keep]))
            reads_all.append(np.concatenate(reads))
            writes_all.append(writes)
        writer = np.full(Q.size, -1)
        for it, writes in enumerate(writes_all):
            for idx, _ in writes:
                assert (writer[idx] == -1).all(), f"wave {t} writes twice"
                assert len(np.unique(idx)) == len(idx)
                writer[idx] = group[it]
        for it, reads in enumerate(reads_all):
            w = writer[reads]
            assert ((w == -1) | (w == group[it])).all(), \
                f"wave {t}: item {it} reads what another item writes"
        for it, writes in enumerate(writes_all):
            for idx, val in writes:
                Q.ravel()[idx] = val
                for x in idx.tolist():
                    last[x] = (t, it)
        # a reflector's entries are not written between its forming and use
        for task, (_, _, tf, piv) in records.items():
            if task not in used or used[task] >= t:
                assert all(last[x][0] == tf for x in piv.tolist()), task
    assert set(used) == set(records)
    if events is not None:
        events.extend((task, rec[2], used[task])
                      for task, rec in records.items())
    d = Q.ravel()[at(np.arange(n), np.arange(n))]
    e = Q.ravel()[at(np.arange(1, n), np.arange(n - 1))]
    return d, e, Vw, tw


@pytest.mark.parametrize("n,b,chunk,whole,grid", [
    (40, 4, 64, False, None), (64, 8, 5, False, None),
    (97, 8, 64, False, None), (50, 16, 16, False, None),
    (30, 2, 3, False, None), (20, 12, 7, False, None),
    # the next pivot's b columns at a chunk edge: the chunk b, b - 1, b + 1
    (60, 8, 8, False, None), (60, 8, 7, False, None),
    (45, 6, 7, False, None), (33, 2, 1, False, None),
    (35, 3, 2, False, None),
    # each wave's chunk picked for a grid of 20 blocks, as the kernel does
    (90, 8, 32, False, 20), (70, 16, 64, False, 20),
    # a whole task a block
    (64, 8, 64, True, None), (30, 2, 64, True, None),
    (41, 3, 64, True, None)])
def test_chase_kernel_model_matches_plain(rng, n, b, chunk, whole, grid):
    """The lower band storage, the items' split of the window, the dlarfy
    diagonal update and the reflectors formed a wave ahead of band_chase,
    modelled in numpy, against the plain chase: d, e and the log within
    2e-12 n max|B| (the diagonal block's two-sided update rounds otherwise
    than the plain loop's one-sided pair), the eigenvalues of T against B's
    within 1e-12 ||B||, and the log by the similarity it defines (B Q2 =
    Q2 T and Q2 orthogonal within 1e-12), which is what holds on the card,
    where a short column to zero makes the log's entries ill-conditioned;
    an off-band B entry within the storage band (a reduce_to_band output's
    rounding) is carried as the plain chase carries it."""
    A = _sym(rng, n, band=b)
    A[min(n - 1, b + 2), 0] = A[0, min(n - 1, b + 2)] = 1e-15
    d, e, (Vw, tw) = tband.band_to_tridiag_wave_plain(torch.as_tensor(A), b)
    md, me, mV, mt = _chase_model(A, b, chunk=chunk, whole=whole, grid=grid)
    tol = _tol(n) * np.abs(A).max()
    for name, g, r in (("d", md, d), ("e", me, e), ("Vw", mV, Vw),
                       ("tw", mt, tw)):
        assert _err(g, r.numpy()) <= tol, name
    T = _tridiag(md, me)
    w0 = np.linalg.eigvalsh(A)
    assert np.abs(w0 - np.linalg.eigvalsh(T)).max() <= 1e-12 * max(
        np.abs(w0).max(), 1.0)
    vlog = (torch.as_tensor(mV), torch.as_tensor(mt))
    Q2 = tband.apply_q2_wave(n, b, vlog,
                             torch.eye(n, dtype=torch.float64)).numpy()
    assert np.abs(Q2.T @ Q2 - np.eye(n)).max() <= 1e-12
    assert np.abs(A @ Q2 - Q2 @ T).max() <= 1e-12 * max(np.abs(w0).max(), 1)
    assert not mV[n - 2].any() and not mt[n - 2].any()
    md0, me0, mV0, _ = _chase_model(A, b, want_log=False, chunk=chunk,
                                    whole=whole, grid=grid)
    assert mV0.shape[0] == 1 and np.array_equal(md0, md)
    assert np.array_equal(me0, me)


@pytest.mark.parametrize("n,b", [(10, 4), (8, 3), (20, 8), (25, 9), (12, 5),
                                 (30, 2), (47, 6), (9, 2), (16, 16)])
def test_chase_reflectors_formed_a_wave_ahead(rng, n, b):
    """band_chase's schedule, n < 3b and b > n/3 included: every task's
    reflector is formed once, before the wave that uses it: the next hop's
    (j, k + 1) in the wave of (j, k) (t = 3j + k), sweep j's first in wave
    3j - 1; and no item writes the entries a reflector was formed from
    between the two waves (asserted inside the model, as is each wave's
    read / write disjointness)."""
    A = _sym(rng, n, band=b)
    events, waves = [], []
    _chase_model(A, b, chunk=max(1, b // 2), events=events, waves=waves)
    assert len(events) == tband.chase_tasks(n, b)
    # one grid sync after packing and one after each wave that ran an item
    assert tband.chase_grid_syncs(n, b) == 1 + len(waves)
    for (j, k), tf, tu in events:
        assert tu == 3 * j + k
        assert tf == tu - 1, ((j, k), tf, tu)
    events.clear()
    _chase_model(A, b, whole=True, events=events)
    assert len(events) == tband.chase_tasks(n, b)


def test_chase_reflector_underflow_keeps_v(rng):
    """sigma2 underflowing to 0 while x is not zero: tau = 0, v0 = 0 and the
    rest of x in the log, in the plain chase and the kernel's model."""
    n, b = 24, 4
    A = _sym(rng, n, band=b)
    A[2:5, 0] = A[0, 2:5] = 1e-170          # x = column 0 below the band edge
    A[1, 0] = A[0, 1] = 0.5
    d, e, (Vw, tw) = tband.band_to_tridiag_wave_plain(torch.as_tensor(A), b)
    assert tw[0, 0] == 0.0 and Vw[0, 0, 0] == 0.0 and Vw[0, 0, 1:].any()
    for whole in (False, True):
        md, me, mV, mt = _chase_model(A, b, chunk=3, whole=whole)
        assert np.array_equal(mV[0, 0], Vw[0, 0].numpy()) and mt[0, 0] == 0.0


def _panel_qr_model(As, o, b, grid):
    """numpy model of panel_qr's schedule: ``grid`` slices of the m entries,
    column j - 1's update of row j made before sigma2 of column j and its
    update of the rows past j after it, v stored in row j's place (entries
    below the pivot stale), the dead rows above j never updated."""
    m = As.shape[0]
    Pt = As[:, o:o + b].T.copy()
    Yp, tp = np.zeros((b, m)), np.zeros(b)
    cnt = min(b, m - o - b)
    S = -(-m // grid)
    wpart = np.zeros((grid, b))
    tau_prev = 0.0
    for j in range(cnt):
        u = o + b + j
        if j > 0:
            tw_j = tau_prev * wpart[:, j].sum()
            Pt[j, u - 1:] -= tw_j * Pt[j - 1, u - 1:]
            wtot = wpart.sum(axis=0)
        sig = [float(np.dot(Pt[j, max(u + 1, g * S):(g + 1) * S],
                            Pt[j, max(u + 1, g * S):(g + 1) * S]))
               for g in range(grid)]
        sigma2, pivot = sum(sig), Pt[j, u]
        norm = np.sqrt(sigma2 + pivot * pivot)
        alpha = -norm if pivot >= 0 else norm
        no_op = sigma2 == 0.0
        denom = 1.0 if no_op else pivot - alpha
        tau = 0.0 if no_op else (alpha - pivot) / alpha
        if j > 0:
            Pt[j + 1:cnt, u - 1:] -= np.outer(tau_prev * wtot[j + 1:cnt],
                                              Pt[j - 1, u - 1:])
        Pt[j, u + 1:] /= denom
        Pt[j, u] = 0.0 if no_op else 1.0
        Yp[j, u:] = Pt[j, u:]
        tp[j] = tau
        for g in range(grid):
            lo = max(u, g * S)
            wpart[g, j + 1:cnt] = Pt[j + 1:cnt, lo:(g + 1) * S] @ Pt[j, lo:(g + 1) * S]
        tau_prev = tau
    return Yp, tp


@pytest.mark.parametrize("m,o,b,grid", [(64, 0, 8, 5), (64, 24, 8, 7),
                                        (45, 32, 8, 3), (100, 16, 16, 1),
                                        (33, 0, 4, 33)])
def test_panel_qr_model_matches_plain(rng, m, o, b, grid):
    """panel_qr's deferred-update schedule, modelled in numpy over ``grid``
    slices, against panel_qr_plain (1e-13 of the largest entry; m=45, o=32
    leaves 5 live columns)."""
    A = _sym(rng, m)
    Yp, tp = torch.zeros((b, m), dtype=torch.float64), torch.zeros(
        b, dtype=torch.float64)
    tband.panel_qr_plain(torch.as_tensor(A), o, b, Yp, tp)
    mY, mt = _panel_qr_model(A, o, b, grid)
    assert _err(mY, Yp.numpy()) <= 1e-13 * np.abs(Yp.numpy()).max()
    assert _err(mt, tp.numpy()) <= 1e-13


def test_kernel_plans():
    """chase_plan, chase_wave_chunk and panel_qr_plan with a card's figures
    (132 SMs, 227 KB a block; occupancy: the blocks an SM's 228 KB and 2048
    threads hold)."""
    sms, optin = 132, 232448

    def resident(threads):
        return lambda smem: min(2048 // threads, 233472 // max(smem + 1024,
                                                               1))

    def chase_resident(whole, smem):
        return resident(256 if whole else 512)(smem)

    # band 128: 512-thread items, the widest chunk to b / 2 that leaves two
    # blocks an SM, the tile and the packed block in shared memory
    plan = tband.chase_plan(4096, 128, sms, optin, chase_resident)
    assert not plan.whole and plan.work_shared and plan.chunk == 64
    assert plan.work == max(128 * 129 // 2, 128 * 65) and plan.smem <= optin
    assert plan.grid == 11 * 33 + 1               # the widest wave at chunk 16
    # each wave the narrowest chunk whose items fit one round of the grid
    plan = plan._replace(grid=264)
    assert [tband.chase_wave_chunk(128, plan, w, False)
            for w in (1, 8, 11, 16, 43)] == [16, 16, 32, 64, 64]
    assert tband.chase_wave_chunk(128, plan, 8, True) == 32
    # u=16: a block of 256 threads a whole task
    plan = tband.chase_plan(16384, 16, sms, optin, chase_resident)
    assert plan.whole and plan.work_shared
    assert plan.work == 16 * 17 // 2 + 16 * 63
    assert plan.grid == 342 + 1
    assert tband.chase_wave_chunk(16, plan, 342, True) == plan.chunk
    plan = tband.chase_plan(16384, 16, sms, optin, lambda t, smem: 1)
    assert plan.grid == sms
    assert tband.chase_plan(4096, 32, sms, optin, chase_resident).whole
    assert not tband.chase_plan(4096, 33, sms, optin, chase_resident).whole
    # band 256: the packed block does not fit, the tile goes to global memory
    plan = tband.chase_plan(4096, 256, sms, optin, chase_resident)
    assert not plan.work_shared and plan.smem < 32 * 1024
    with pytest.raises(ValueError):
        tband.chase_plan(4096, 128, sms, optin, lambda t, smem: 0)
    qr = tband.panel_qr_plan(16384, 128, sms, optin, resident(256))
    assert qr.grid == sms and qr.grid * qr.slice >= 16384
    assert qr.cached == 128 and qr.smem <= optin
    qr = tband.panel_qr_plan(4096, 128, sms, optin, resident(256))
    assert qr.grid == 128 and qr.slice == 32 and qr.cached == 128
    qr = tband.panel_qr_plan(65536, 128, sms, optin, resident(256))
    assert 0 < qr.cached < 128 and qr.smem <= optin
    with pytest.raises(ValueError):
        tband.panel_qr_plan(4096, 128, sms, optin, lambda smem: 0)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_signature(symbol):
    text = (_build.CSRC / "band_reduce.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, symbol
    types = []
    for param in m.group(1).split(","):
        words = " ".join(param.split()).rsplit(" ", 1)[0]
        types.append(_C_TYPES[words.replace(" *", "*")])
    return types


@pytest.mark.parametrize("symbol,argtypes", [
    ("band_chase_launch", tband._CHASE_ARGTYPES),
    ("band_chase_occupancy", tband._CHASE_OCCUPANCY_ARGTYPES),
    ("panel_qr_launch", tband._PANEL_ARGTYPES),
    ("panel_qr_occupancy", tband._OCCUPANCY_ARGTYPES)])
def test_bindings_match_the_source(symbol, argtypes):
    """Every ctypes argument list is its C function's (a pointer passed as
    an int would be cut to 32 bits on the card), and _build builds the
    source."""
    assert _c_signature(symbol) == list(argtypes)
    assert "band_reduce" in _build.KERNELS


def test_cuda_wrappers_launch_with_faked_card(monkeypatch):
    """The CUDA wrappers on 'meta' tensors with the card's calls faked: one
    band_chase launch a chase with the plan's grid, shared bytes and work
    tile on the current stream, null log pointers without the log; one
    panel_qr launch a panel with its live columns and plan, none for a
    panel with no live column; each counter counts its launches."""
    import contextlib
    import types
    calls = []

    def function(name, symbol, argtypes):
        assert name == "band_reduce"
        return lambda *args: calls.append((symbol, args)) or 0

    meta = dict(dtype=torch.float64, device="meta")
    monkeypatch.setattr(tband._build, "function", function)
    monkeypatch.setattr(tband, "_occupancy",
                        lambda kernel, index, smem: (1, 132, 232448))
    monkeypatch.setattr(tband, "_chase_occupancy",
                        lambda index, whole, smem: (1, 132, 232448))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None:
                        types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(tband, "chase_launches", 0)
    monkeypatch.setattr(tband, "panel_qr_launches", 0)
    n, b = 300, 16
    d, e, (Vw, tw) = tband._launch_chase(torch.empty((n, n), **meta), b,
                                         True)
    plan = tband.chase_plan(n, b, 132, 232448, lambda whole, smem: 1)
    Kmax, _, _ = tband._wave_geometry(n, b)
    assert d.shape == (n,) and e.shape == (n - 1,)
    assert Vw.shape == (n - 1, Kmax, b) and tw.shape == (n - 1, Kmax)
    symbol, args = calls[-1]
    assert symbol == "band_chase_launch"
    assert args[11:] == (plan.work, int(plan.work_shared), n, b, plan.chunk,
                         int(plan.whole), plan.grid, plan.smem, 7)
    assert all(isinstance(x, int) for x in args[2:11] if x is not None)
    tband._launch_chase(torch.empty((n, n), **meta), b, False)
    assert calls[-1][1][3] is None and calls[-1][1][4] is None
    assert tband.chase_launches == 2
    m, b = 200, 8
    As = torch.empty((m, m), **meta)
    for o, cnt in ((0, 8), (m - b - 3, 3), (m - b, 0)):
        before = len(calls)
        tband._launch_panel_qr(As, o, b, torch.empty((b, m), **meta),
                               torch.empty(b, **meta))
        if cnt == 0:
            assert len(calls) == before
            continue
        qr = tband.panel_qr_plan(m, b, 132, 232448, lambda smem: 1)
        symbol, args = calls[-1]
        assert symbol == "panel_qr_launch"
        assert args[7:] == (m, o, b, cnt, qr.slice, qr.cached, qr.grid,
                            qr.smem, 7)
    assert tband.panel_qr_launches == 2
    with pytest.raises(TypeError):
        tband._launch_chase(torch.empty((n, n), dtype=torch.float32,
                                        device="meta"), 16, True)
