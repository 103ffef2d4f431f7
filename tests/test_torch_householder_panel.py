"""PyTorch port, the dense reduction's column step and the compact-WY T
factor (``kernels/householder_panel.py``, ``csrc/householder_panel.cu``).

The CUDA kernels run only on the card (``chip_smoke.py --only
column_reflector,column_w,larft`` holds them against the plain versions
there).  Here, on the CPU:

- a torch model of the kernels' stage split (column_reflector with p, q
  gathered from the unscaled row, the matvec, column_w with the half-step
  from v.(A v) = y.v - 2 p.q) drives ``tridiagonalize`` and is held against
  the plain loop and the JAX package's ``tridiagonalize`` at
  ``test_torch_tridiagonalize``'s (n, panel, buckets), to 2e-12 n max|A|
  (that file's bound: the reduction is backward, not forward, stable);
- the identity behind the half-step, the no-op (sigma2 == 0) and the
  identity-reflector (j = m - 2) columns;
- ``larft_plain`` against the JAX package's ``_larft`` at nb = 8, 32, 128;
- dispatch: a tensor on another device than the CPU never takes a plain
  version; the ctypes argument lists match the C signatures."""

import contextlib
import ctypes
import pathlib
import re

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


@contextlib.contextmanager
def _model(monkeypatch):
    made = []

    def steps(As, Vtb, Wbuf, te, nb):
        made.append(_ModelSteps(As, Vtb, Wbuf, te, nb))
        return made[-1]

    with monkeypatch.context() as mp:
        mp.setattr(ttri, "column_steps", steps)
        yield made


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
    ref = [np.asarray(x) for x in jtri.tridiagonalize(
        jnp.asarray(A), panel=panel, buckets=buckets)]
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
    the last one (j = n-2) the identity reflector; the model takes both
    branches where the plain loop does (the zero taus and reflectors exact,
    the rest to 1e-12)."""
    n, k = 24, 10
    A = np.zeros((n, n))
    A[:k, :k] = _tridiag(rng.standard_normal(k), rng.standard_normal(k - 1))
    A[k:, k:] = _sym(rng, n - k)
    plain = ttri.tridiagonalize(torch.as_tensor(A), panel=4)
    with _model(monkeypatch):
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


def test_other_devices_never_take_the_plain_versions(monkeypatch):
    """'meta' tensors (a stand-in for CUDA here) reach the kernel side,
    which takes CUDA alone and raises; no plain version is called and no
    launch is counted."""
    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on a non-CPU tensor")

    for name in ("column_reflector_plain", "column_w_plain", "larft_plain"):
        monkeypatch.setattr(hp, name, forbidden)
    before = (hp.reflector_launches, hp.w_launches, hp.larft_launches)
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
    assert (hp.reflector_launches, hp.w_launches, hp.larft_launches) \
        == before == (0, 0, 0)
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
    ("column_reflector_launch", hp._REFLECTOR_ARGTYPES),
    ("column_w_launch", hp._W_ARGTYPES),
    ("larft_launch", hp._LARFT_ARGTYPES),
    ("larft_shared_bytes", hp._SHARED_ARGTYPES)])
def test_bindings_match_the_source(symbol, argtypes):
    """Every ctypes argument list is its C function's (a pointer passed as
    an int would be cut to 32 bits on the card), and _build builds the
    source."""
    assert _c_signature(symbol) == list(argtypes)
    assert "householder_panel" in _build.KERNELS
