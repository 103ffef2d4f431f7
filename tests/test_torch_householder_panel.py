"""PyTorch port, the dense reduction's column step and the compact-WY T
factor (``kernels/householder_panel.py``, ``csrc/householder_panel.cu``).

The CUDA kernels run only on the card (``chip_smoke.py --only
column_reflector,column_w,column_w_reflector,larft`` holds them against the
plain versions there).  Here, on the CPU:

- a torch model of the kernels' stage split (the reflector with p, q
  gathered from the unscaled row, the matvec, the W row with the half-step
  from v.(A v) = y.v - 2 p.q) drives ``tridiagonalize`` and is held against
  the plain loop and the JAX package's ``tridiagonalize`` at
  ``test_torch_tridiagonalize``'s (n, panel, buckets), to 2e-12 n max|A|
  (that file's bound: the reduction is backward, not forward, stable), a
  column at a time and in the kernels' schedule (``panel_launches``: the
  panel's first reflector alone, each W row fused with the next column's
  reflector, the last W row alone), with p, q passed between launches in
  one buffer as on the card;
- the schedule's launch counts (``column_launches``) and the cooperative
  launch plan (``column_plan``);
- the identity behind the half-step, the no-op (sigma2 == 0) and the
  identity-reflector (j = m - 2) columns;
- ``larft_plain`` against the JAX package's ``_larft`` at nb = 8, 32, 128,
  and a numpy model of the larft kernel's blocked order (diagonal blocks
  by the recurrence, joins by -T_AA G_AB T_BB) against both;
- dispatch: a tensor on another device than the CPU never takes a plain
  version; the ctypes argument lists match the C signatures."""

import contextlib
import ctypes
import gc
import pathlib
import re
import types
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import tridiagonalize as jtri
from symmetric_eigenvalue_tpu_torch import _build
from symmetric_eigenvalue_tpu_torch.kernels import householder_panel as hp
from symmetric_eigenvalue_tpu_torch.kernels import tridiagonalize as ttri

CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"


def _sym(rng, n):
    A = rng.standard_normal((n, n))
    return (A + A.T) / 2


def _tridiag(d, e):
    return np.diag(d) + np.diag(e, 1) + np.diag(e, -1)


class _ModelSteps:
    """The kernels' stage split in torch: K1 (the delayed row from j+1 on,
    sigma2 and the unscaled P = Wp a, Q = Vp a, then v, tau, alpha and
    p = Wp v, q = Vp v from them), K2 (the matvec), K3 (the W row without
    the half-step, then - half v with half = 0.5 tau^2 (y.v - 2 p.q))."""

    def __init__(self, As, Vtb, Wbuf, te, nb):
        self.As, self.Vtb, self.Wbuf, self.te = As, Vtb, Wbuf, te
        self.halves = []

    def context(self):
        return contextlib.nullcontext()

    def panel(self, o, cnt):
        for j in range(o, o + cnt):
            self(j, o)

    def __call__(self, j, o):
        As, te, Wp = self.As, self.te, self.Wbuf
        m = As.shape[0]
        jj = j - o
        Vp = self.Vtb[o:]
        # K1
        a = (As[j, j + 1:] - Vp[:jj, j + 1:].T @ Wp[:jj, j]
             - Wp[:jj, j + 1:].T @ Vp[:jj, j])
        if j == m - 2:
            te[j, 1] = a[0]
            Wp[jj].zero_()
            return
        pivot, below = a[0], a[1:]
        sigma2 = below @ below
        P = Wp[:jj, j + 2:] @ below
        Q = Vp[:jj, j + 2:] @ below
        norm = torch.sqrt(sigma2 + pivot * pivot)
        alpha = torch.where(pivot >= 0, -norm, norm)
        no_op = sigma2 == 0.0
        denom = torch.where(no_op, 1.0, pivot - alpha)
        tau = torch.where(no_op, 0.0, (alpha - pivot) / alpha)
        unit = (~no_op).to(As.dtype)
        te[j, 0] = tau
        te[j, 1] = torch.where(no_op, pivot, alpha)
        Vp[jj, j + 1] = unit
        Vp[jj, j + 2:] = below / denom
        p = Wp[:jj, j + 1] * unit + P / denom
        q = Vp[:jj, j + 1] * unit + Q / denom
        # K2
        v = Vp[jj]
        y = v[j + 1:] @ As[j + 1:]
        # K3
        Wp[jj] = tau * (y - Vp[:jj].T @ p - Wp[:jj].T @ q)
        half = tau * (y[j + 1:] @ v[j + 1:] - 2.0 * (p @ q)) * tau * 0.5
        Wp[jj, j + 1:] -= half * v[j + 1:]
        self.halves.append(float(half))


class _ScheduleModel:
    """The kernels' schedule in torch (``hp.panel_launches``): each launch
    as its kernel orders the work.  ``column_reflector`` leaves v, tau,
    alpha and (p, q) in one buffer (P = Wp a, Q = Vp a from the unscaled
    row past the pivot, divided by the pivot's denominator, plus the pivot
    column's term); ``column_w`` reads them back for the W row and its
    half-step 0.5 tau^2 (y.v - 2 p.q); ``column_w_reflector`` is the two in
    turn, the reflector reading the W row just made.  Records the launches
    it made."""

    def __init__(self, As, Vtb, Wbuf, te, nb):
        self.As, self.Vtb, self.Wbuf, self.te = As, Vtb, Wbuf, te
        self.pq = As.new_zeros(2 * nb)
        self.y = As.new_zeros(As.shape[0])
        self.made = []

    def context(self):
        return contextlib.nullcontext()

    def panel(self, o, cnt):
        for kind, j in hp.panel_launches(self.As.shape[0], o, cnt):
            self.made.append(kind)
            getattr(self, kind)(j, o)

    def column_reflector(self, j, o):
        As, te, Wp, Vp = self.As, self.te, self.Wbuf, self.Vtb[o:]
        m, jj = As.shape[0], j - o
        a = (As[j, j + 1:] - Vp[:jj, j + 1:].T @ Wp[:jj, j]
             - Wp[:jj, j + 1:].T @ Vp[:jj, j])
        if j == m - 2:
            te[j, 1] = a[0]
            Wp[jj].zero_()
            return
        pivot, below = a[0], a[1:]
        sigma2 = below @ below
        P = Wp[:jj, j + 2:] @ below
        Q = Vp[:jj, j + 2:] @ below
        norm = torch.sqrt(sigma2 + pivot * pivot)
        alpha = torch.where(pivot >= 0, -norm, norm)
        no_op = sigma2 == 0.0
        denom = torch.where(no_op, 1.0, pivot - alpha)
        unit = (~no_op).to(As.dtype)
        te[j, 0] = torch.where(no_op, 0.0, (alpha - pivot) / alpha)
        te[j, 1] = torch.where(no_op, pivot, alpha)
        Vp[jj, j + 1] = unit
        Vp[jj, j + 2:] = below / denom
        self.pq[:jj] = Wp[:jj, j + 1] * unit + P / denom
        self.pq[jj:2 * jj] = Vp[:jj, j + 1] * unit + Q / denom

    def dword_vecmat(self, j, o):
        v = self.Vtb[j]
        self.y = v[j + 1:] @ self.As[j + 1:]

    def column_w(self, j, o):
        Wp, Vp, y = self.Wbuf, self.Vtb[o:], self.y
        jj = j - o
        p, q = self.pq[:jj], self.pq[jj:2 * jj]
        tau = self.te[j, 0]
        v = Vp[jj]
        w = tau * (y - Vp[:jj].T @ p - Wp[:jj].T @ q)
        half = tau * (y[j + 1:] @ v[j + 1:] - 2.0 * (p @ q)) * tau * 0.5
        w[j + 1:] -= half * v[j + 1:]
        Wp[jj] = w

    def column_w_reflector(self, j, o):
        self.column_w(j, o)
        self.column_reflector(j + 1, o)


@contextlib.contextmanager
def _model(monkeypatch, model=_ModelSteps):
    made = []

    def steps(As, Vtb, Wbuf, te, nb):
        made.append(model(As, Vtb, Wbuf, te, nb))
        return made[-1]

    with monkeypatch.context() as mp:
        mp.setattr(ttri, "column_steps", steps)
        yield made


_JAX_REFS = {}


def _jax_tridiagonalize(A, panel, buckets):
    """The JAX package's tridiagonalize of A, once a case (the two model
    tests share it)."""
    key = (A.tobytes(), panel, buckets)
    if key not in _JAX_REFS:
        _JAX_REFS[key] = [np.asarray(x) for x in jtri.tridiagonalize(
            jnp.asarray(A), panel=panel, buckets=buckets)]
    return _JAX_REFS[key]


@pytest.mark.parametrize("n,panel,buckets", [
    (5, 2, 1), (16, 4, 1), (33, 8, 1), (64, 32, 1), (50, 7, 1),
    (64, 8, 3), (100, 8, 4), (129, 16, 4), (33, 8, 2)])
def test_stage_split_matches_plain_and_jax(rng, monkeypatch, n, panel,
                                           buckets):
    A = _sym(rng, n)
    plain = ttri.tridiagonalize(torch.as_tensor(A), panel=panel,
                                buckets=buckets)
    with _model(monkeypatch) as made:
        got = ttri.tridiagonalize(torch.as_tensor(A), panel=panel,
                                  buckets=buckets)
    assert len(made) == len(ttri._bucket_cuts(n, panel, buckets)) - 1
    ref = _jax_tridiagonalize(A, panel, buckets)
    tol = 2e-12 * n * np.abs(A).max()
    for name, g, p, r in zip(("d", "e", "Vt", "taus"), got, plain, ref):
        assert g.shape == p.shape == r.shape, name
        assert np.abs(g.numpy() - p.numpy()).max() <= tol, name
        assert np.abs(g.numpy() - r).max() <= tol, name
    d, e, Vt, taus = got
    Q = ttri.apply_q(Vt, taus, torch.eye(n, dtype=torch.float64),
                     panel=panel).numpy()
    assert np.abs(Q.T @ A @ Q - _tridiag(d.numpy(), e.numpy())).max() \
        <= 1e-12 * max(np.abs(A).max(), 1.0)


@pytest.mark.parametrize("n,panel,buckets", [
    (5, 2, 1), (16, 4, 1), (33, 8, 1), (64, 32, 1), (50, 7, 1),
    (64, 8, 3), (100, 8, 4), (129, 16, 4), (33, 8, 2)])
def test_schedule_model_matches_plain_and_jax(rng, monkeypatch, n, panel,
                                              buckets):
    """The kernels' schedule (lone reflector, fused W + reflector steps,
    lone W row) drives tridiagonalize to the plain loop's and the JAX
    package's result, and makes exactly column_launches' launches."""
    A = _sym(rng, n)
    plain = ttri.tridiagonalize(torch.as_tensor(A), panel=panel,
                                buckets=buckets)
    with _model(monkeypatch, _ScheduleModel) as made:
        got = ttri.tridiagonalize(torch.as_tensor(A), panel=panel,
                                  buckets=buckets)
    ref = _jax_tridiagonalize(A, panel, buckets)
    tol = 2e-12 * n * np.abs(A).max()
    for name, g, p, r in zip(("d", "e", "Vt", "taus"), got, plain, ref):
        assert g.shape == p.shape == r.shape, name
        assert np.abs(g.numpy() - p.numpy()).max() <= tol, name
        assert np.abs(g.numpy() - r).max() <= tol, name
    launched = [kind for step in made for kind in step.made]
    counts = hp.column_launches(n, panel, buckets)
    assert {k: launched.count(k) for k in counts} == counts


@pytest.mark.parametrize("n,panel,buckets", [
    (2, 32, 1), (3, 2, 1), (16384, 32, 4), (4096, 32, 1), (4096, 512, 1),
    (8193, 32, 4), (99, 1, 3)])
def test_column_launches(n, panel, buckets):
    """The reflector half runs n-1 times, the W half and the matvec n-2;
    two launches a column inside a panel, a lone reflector opening each
    panel and a lone W row closing each but the one that ends on the
    identity column (j = n-2: its reflector only)."""
    got = hp.column_launches(n, panel, buckets)
    assert got["column_reflector"] + got["column_w_reflector"] == n - 1
    assert got["column_w"] + got["column_w_reflector"] == n - 2
    assert got["dword_vecmat"] == n - 2
    nb = max(1, min(panel, n))
    cuts = ttri._bucket_cuts(n, nb, buckets)
    panels = sum(-(-(c1 - c0) // nb) for c0, c1 in zip(cuts[:-1], cuts[1:]))
    assert got["column_reflector"] == panels
    assert got["column_w"] == panels - 1
    m = n - cuts[-2]                     # the last bucket ends on j = m - 2
    o = (m - 2) // nb * nb               # at its last panel
    last = hp.panel_launches(m, o, m - 1 - o)[-1]
    if m - 1 - o > 1:
        # the identity column closes the panel, fused into the step before
        assert last == ("column_w_reflector", m - 3)
    else:
        assert last == ("column_reflector", m - 2)
    if n == 16384 and panel == 32 and buckets == 4:
        assert sum(got.values()) == 33276        # ~2.03 a column
    # inside a panel: the matvec and one fused launch a column
    seq = hp.panel_launches(1000, 64, 32)
    assert seq[0] == ("column_reflector", 64)
    assert seq[1:-2:2] == [("dword_vecmat", j) for j in range(64, 95)]
    assert seq[2:-2:2] == [("column_w_reflector", j) for j in range(64, 95)]
    assert seq[-2:] == [("dword_vecmat", 95), ("column_w", 95)]
    # a panel of the identity column alone
    assert hp.panel_launches(10, 8, 1) == [("column_reflector", 8)]


def test_column_plan():
    """The cooperative grid spans every SM (a multiple of the SM count),
    covers the row, fits the shared memory the occupancy allows, and caches
    up to nb - 1 panel rows; it shrinks the blocks an SM where fewer are
    co-resident and raises where none fits."""
    sms, optin = 132, 232448

    def resident(smem):               # 228 KB an SM, 1 KB kept a block
        return min(16, 233472 // (smem + 1024))

    for m, nb in ((16384, 32), (12288, 32), (4096, 32), (4096, 512),
                  (65536, 32), (3, 2), (100000, 1024)):
        plan = hp.column_plan(m, nb, sms, optin, resident)
        per_sm = plan.grid // sms
        assert plan.grid == per_sm * sms and per_sm >= 1
        assert plan.grid * plan.slice >= m
        assert per_sm <= max(1, -(-(-(-m // hp._THREADS)) // sms))
        assert plan.smem <= optin and resident(plan.smem) >= per_sm
        assert 0 <= plan.cached <= nb - 1
        assert plan.smem == 8 * (4 * nb + 8 + 3 * plan.slice
                                 + 2 * plan.cached * plan.slice)
    # the n=16384 reduction's first bucket: one entry a thread, every panel
    # row of a 32-column panel in shared memory
    assert hp.column_plan(16384, 32, sms, optin, resident) == (
        132, 125, 31, 66088)
    assert hp.column_plan(65536, 32, sms, optin, resident).grid == 4 * 132
    # where only one block an SM is co-resident
    one = hp.column_plan(65536, 32, sms, optin, lambda smem: 1)
    assert one.grid == sms and one.slice == 497
    with pytest.raises(ValueError, match="no cooperative launch"):
        hp.column_plan(16384, 32, sms, optin, lambda smem: 0)


def test_cuda_stepper_launches_the_schedule(monkeypatch):
    """The CUDA stepper on 'meta' tensors with the card's calls faked: each
    panel makes panel_launches' launches in order, each kernel with (j,
    jj = j - o) and the plan's grid, slice, cached rows and shared bytes on
    the current stream, the matvec over the rows below the pivot; each
    kernel's counter counts its launches; and the stepper is freed as soon
    as it is dropped (no reference cycle keeps the bucket alive)."""
    calls = []

    def function(name, symbol, argtypes):
        assert len(argtypes) == len(hp._STEP_ARGTYPES)
        return lambda *args: calls.append((symbol, args)) or 0

    meta = dict(dtype=torch.float64, device="meta")
    monkeypatch.setattr(hp._build, "function", function)
    monkeypatch.setattr(hp, "_occupancy", lambda index, smem: (1, 132, 232448))
    monkeypatch.setattr(hp, "_scratch", lambda index, stream, grid, nb: (
        torch.empty(1, **meta), torch.empty(1, **meta)))
    monkeypatch.setattr(hp.dv, "launch_raw",
                        lambda *args: calls.append(("dword_vecmat", args)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None:
                        types.SimpleNamespace(cuda_stream=7))
    for name in ("reflector_launches", "w_launches", "w_reflector_launches"):
        monkeypatch.setattr(hp, name, 0)
    m, nb = 40, 8
    ks = hp._CudaSteps(torch.empty((m, m), **meta),
                       torch.empty((m - 1, m), **meta),
                       torch.empty((nb, m), **meta),
                       torch.empty((m - 1, 2), **meta), nb)
    plan = hp.column_plan(m, nb, 132, 232448, lambda smem: 1)
    assert ks.plan == plan
    want = []
    for o in range(0, m - 1, nb):
        ks.panel(o, min(nb, m - 1 - o))
        want += [(kind, j, o) for kind, j in
                 hp.panel_launches(m, o, min(nb, m - 1 - o))]
    assert len(calls) == len(want)
    for (symbol, args), (kind, j, o) in zip(calls, want):
        if kind == "dword_vecmat":
            assert symbol == kind and args[3:5] == (m - j - 1, m)
        else:
            assert symbol == kind + "_launch"
            assert args[10:] == (j, j - o, *plan, 7)
    kinds = [kind for kind, _, _ in want]
    assert (hp.reflector_launches, hp.w_launches, hp.w_reflector_launches) \
        == tuple(kinds.count(k) for k in ("column_reflector", "column_w",
                                          "column_w_reflector"))
    gc.disable()
    try:
        ref = weakref.ref(ks)
        del ks
        assert ref() is None
    finally:
        gc.enable()


def test_half_step_identity(rng):
    """v.(A_updated v) = y.v - 2 p.q with p = Wp v, q = Vp v, y = v As: the
    column_w kernel's half-step, held against the plain loop's dot(w, v) on
    a panel's delayed state, column by column."""
    n, nb = 80, 16
    As = torch.as_tensor(_sym(rng, n))
    Vtb = As.new_zeros((nb, n))
    te = As.new_zeros((nb, 2))
    Wbuf = As.new_zeros((nb, n))
    plain = hp._PlainSteps(As, Vtb, Wbuf, te)
    for j in range(nb):
        plain(j, 0)
        v = Vtb[j]
        Vp, Wp = Vtb[:j], Wbuf[:j]
        y = v @ As
        p, q = Wp @ v, Vp @ v
        Av = y - Vp.T @ p - Wp.T @ q
        lhs = float(Av @ v)
        rhs = float(y @ v - 2.0 * (p @ q))
        scale = float(y.abs() @ v.abs() + 2.0 * (p.abs() @ q.abs()))
        assert abs(lhs - rhs) <= 1e-14 * scale
        # and what the plain step stored: W = w - 0.5 tau (w.v) v
        tau = float(te[j, 0])
        w = tau * Av
        ref = w - 0.5 * tau * tau * rhs * v
        assert torch.allclose(Wbuf[j], ref, rtol=0, atol=1e-13 * float(
            ref.abs().max()))


def test_no_op_and_identity_columns(rng, monkeypatch):
    """A block-diagonal A = diag(tridiagonal, dense): the first columns have
    sigma2 == 0 (v = 0 past the pivot's zero, tau = 0, alpha = the pivot),
    the last one (j = n-2) the identity reflector; both models (a column at
    a time, and the kernels' schedule, where they fall inside fused steps)
    take both branches where the plain loop does (the zero taus and
    reflectors exact, the rest to 1e-12)."""
    n, k = 24, 10
    A = np.zeros((n, n))
    A[:k, :k] = _tridiag(rng.standard_normal(k), rng.standard_normal(k - 1))
    A[k:, k:] = _sym(rng, n - k)
    plain = ttri.tridiagonalize(torch.as_tensor(A), panel=4)
    for model in (_ModelSteps, _ScheduleModel):
        with _model(monkeypatch, model):
            got = ttri.tridiagonalize(torch.as_tensor(A), panel=4)
        for g, p in zip(got, plain):
            assert np.abs(g.numpy() - p.numpy()).max() <= 1e-12
        d, e, Vt, taus = got
        assert not taus[:k - 1].any() and not Vt[:k - 1].any()
        assert np.array_equal(e[:k - 1].numpy(), np.diag(A, 1)[:k - 1])
        assert taus[k:n - 2].all()
        # the last column: identity reflector, e[n-2] the updated A[n-2, n-1]
        assert taus[n - 2] == 0 and not Vt[n - 2].any()
        assert e[n - 2] != 0


def test_identity_column_zeroes_stale_w_row(rng):
    """At j = m - 2 the plain step zeroes the W row (Wbuf is reused across
    panels and still holds an earlier panel's row) and leaves v and tau."""
    m = 12
    As = torch.as_tensor(_sym(rng, m))
    Vtb = As.new_zeros((m - 1, m))
    te = As.new_zeros((m - 1, 2))
    Wbuf = torch.as_tensor(rng.standard_normal((4, m)))
    o = m - 4
    plain = hp._PlainSteps(As, Vtb, Wbuf, te)
    for j in range(o, m - 1):
        plain(j, o)
    assert not Wbuf[m - 2 - o].any()
    assert not Vtb[m - 2].any() and te[m - 2, 0] == 0
    assert te[m - 2, 1] != 0


@pytest.mark.parametrize("nb", [8, 32, 128])
def test_larft_plain_matches_jax(rng, nb):
    n = nb + 40
    Vp = np.triu(rng.standard_normal((nb, n)), 1)
    Vp[np.arange(nb), np.arange(nb) + 1] = 1.0
    tau = rng.uniform(0.5, 1.5, nb)
    tau[nb // 3] = 0.0
    Vp[nb // 3] = 0.0
    G = torch.as_tensor(Vp) @ torch.as_tensor(Vp).T
    got = hp.larft_plain(G, torch.as_tensor(tau)).numpy()
    assert np.array_equal(
        got, ttri._larft(torch.as_tensor(Vp), torch.as_tensor(tau)).numpy())
    ref = np.asarray(jtri._larft(jnp.asarray(Vp), jnp.asarray(tau)))
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert np.all(np.tril(got, -1) == 0.0)


def _larft_kernel_model(G, tau):
    """numpy model of the larft kernel's order: nb padded to a multiple of
    32 with zero G and tau; G's strict upper triangle only; each 32-column
    diagonal block by the recurrence a row at a time (row r keeps the sums
    of its later columns and adds T[r][l] G[l][k] to them as each T[r][l]
    is made, l ascending); then widths 32, 64, ..: X = G_AB T_BB, then
    T_AB = -T_AA X, the triangles of T_AA and T_BB masked."""
    nb = G.shape[0]
    nbp = -(-nb // 32) * 32
    Gu = np.zeros((nbp, nbp))
    Gu[:nb, :nb] = np.triu(G, 1)
    tz = np.zeros(nbp)
    tz[:nb] = tau
    T = np.zeros((nbp, nbp))
    for c0 in range(0, nbp, 32):
        for r in range(c0, c0 + 32):
            acc = np.zeros(nbp)
            for l in range(r, c0 + 32):
                T[r, l] = tz[l] if l == r else acc[l] * -tz[l]
                acc[l + 1:c0 + 32] += T[r, l] * Gu[l, l + 1:c0 + 32]
    h = 32
    while h < nbp:
        for a in range(0, nbp - h, 2 * h):
            A, B = slice(a, a + h), slice(a + h, min(a + 2 * h, nbp))
            X = Gu[A, B] @ np.triu(T[B, B])
            T[A, B] = -(np.triu(T[A, A]) @ X)
        h *= 2
    return np.triu(T[:nb, :nb])


def _reflector_gram(rng, nb, width):
    """Gram and taus of nb Householder reflectors over ``width`` entries as
    the reductions make them (row k: zero to k, one at k + 1, tau = 2 /
    v.v), row nb // 3 an identity reflector (v = 0, tau = 0)."""
    V = np.triu(rng.standard_normal((nb, width)), 2) / np.sqrt(width)
    V[np.arange(nb), np.arange(nb) + 1] = 1.0
    tau = 2.0 / np.einsum("ij,ij->i", V, V)
    V[nb // 3] = 0.0
    tau[nb // 3] = 0.0
    return V, V @ V.T, tau


@pytest.mark.parametrize("nb", [1, 5, 32, 33, 64, 127, 128])
def test_larft_blocked_model_matches_plain_and_jax(rng, nb):
    """The larft kernel's blocked order (diagonal blocks by the recurrence,
    joins by -T_AA G_AB T_BB), modelled in numpy, against larft_plain and
    the JAX package's _larft on a Gram of reflector-structured V with one
    tau = 0: within 1e-13 max|T| (the two orders round differently; a
    join's products carry about nb eps of |T|), the lower triangle and the
    identity reflector's row and column off the diagonal exactly zero."""
    V, G, tau = _reflector_gram(rng, nb, nb + 40)
    got = _larft_kernel_model(G, tau)
    plain = hp.larft_plain(torch.as_tensor(G), torch.as_tensor(tau)).numpy()
    ref = np.asarray(jtri._larft(jnp.asarray(V), jnp.asarray(tau)))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-13 * scale
    assert np.abs(got - ref).max() <= 1e-13 * scale
    assert np.all(np.tril(got, -1) == 0.0)
    k = nb // 3
    assert not got[k].any() and not got[:, k].any()
    assert np.array_equal(np.diag(got), tau)


def test_larft_working_set():
    """larft keeps its working set (M with its rows trimmed to their 32-row
    block-row, the joins' X and the taus) in shared memory exactly to nb =
    128 (csrc's kInPlaceMax), so the apply_q and band-128 panels never take
    the global scratch."""
    text = (CSRC / "householder_panel.cu").read_text()
    assert int(re.search(r"kInPlaceMax = (\d+);", text).group(1)) == 128
    assert "larft_padded(nb) <= kInPlaceMax" in text
    for nb in (1, 32, 33, 127, 128, 129, 300):
        nbp = -(-nb // 32) * 32
        rows = sum(nbp - 32 * (r // 32) + 2 for r in range(nbp))
        assert hp.larft_scratch_doubles(nb) == rows + nbp * nbp // 4 + nbp
    assert 8 * hp.larft_scratch_doubles(128) == 117760


def test_other_devices_never_take_the_plain_versions(monkeypatch):
    """'meta' tensors (a stand-in for CUDA here) reach the kernel side,
    which takes CUDA alone and raises; no plain version is called and no
    launch is counted."""
    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on a non-CPU tensor")

    for name in ("column_reflector_plain", "column_w_plain", "larft_plain"):
        monkeypatch.setattr(hp, name, forbidden)
    before = (hp.reflector_launches, hp.w_launches, hp.w_reflector_launches,
              hp.larft_launches)
    meta = dict(dtype=torch.float64, device="meta")
    m, nb = 16, 4
    with pytest.raises(ValueError, match="unsupported device"):
        hp.column_steps(torch.empty((m, m), **meta),
                        torch.empty((m - 1, m), **meta),
                        torch.empty((nb, m), **meta),
                        torch.empty((m - 1, 2), **meta), nb)
    with pytest.raises(ValueError, match="unsupported device"):
        ttri.tridiagonalize(torch.empty((m, m), **meta), panel=nb)
    with pytest.raises(ValueError, match="unsupported device"):
        hp.larft(torch.empty((nb, nb), **meta), torch.empty(nb, **meta))
    assert (hp.reflector_launches, hp.w_launches, hp.w_reflector_launches,
            hp.larft_launches) == before == (0, 0, 0, 0)
    with pytest.raises(TypeError):
        hp.larft(torch.zeros((nb, nb), dtype=torch.float32),
                 torch.zeros(nb, dtype=torch.float32))
    with pytest.raises(TypeError):
        hp.column_steps(*(torch.zeros((m, m), dtype=torch.float32)
                          for _ in range(4)), nb)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "long long": ctypes.c_longlong, "int": ctypes.c_int}


def _c_signature(symbol):
    text = (CSRC / "householder_panel.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, symbol
    types = []
    for param in m.group(1).split(","):
        words = " ".join(param.split()).rsplit(" ", 1)[0]
        types.append(_C_TYPES[words.replace(" *", "*")])
    return types


@pytest.mark.parametrize("symbol,argtypes", [
    ("column_reflector_launch", hp._STEP_ARGTYPES),
    ("column_w_launch", hp._STEP_ARGTYPES),
    ("larft_launch", hp._LARFT_ARGTYPES),
    ("larft_shared_bytes", hp._SHARED_ARGTYPES),
    ("column_w_reflector_launch", hp._STEP_ARGTYPES),
    ("column_step_occupancy", hp._OCCUPANCY_ARGTYPES),
    ("grid_sync_probe_launch", hp._PROBE_ARGTYPES)])
def test_bindings_match_the_source(symbol, argtypes):
    """Every ctypes argument list is its C function's (a pointer passed as
    an int would be cut to 32 bits on the card), and _build builds the
    source."""
    assert _c_signature(symbol) == list(argtypes)
    assert "householder_panel" in _build.KERNELS
