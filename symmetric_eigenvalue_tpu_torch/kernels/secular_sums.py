"""Secular root finder on the card: the per-iteration sums and the whole
iteration.  CUDA kernels + plain versions.

For each merge b and root i, with dif_ij = (poles_bj - shift_bi) - tau_bi and
the sweep cut at the merge's active count K_b:

    S1[b, i]  = sum_{j < K_b} z2_bj / dif_ij     S2: z2_bj / dif_ij^2
    S1L[b, i] = sum_{j < K_b, j <= sl_bi} z2_bj / dif_ij      S2L likewise

The cut is exact: ``merge_partition`` leaves z2 = 0 past K_b and its
sentinel poles keep every dif there finite and nonzero.

:func:`secular_sums` ports ``symmetric_eigenvalue_tpu/kernels/pallas/
secular_sums.py``, batched over the k merges of a tree level.
:func:`secular_solve` runs the safeguarded middle-way / Newton / bisection
iteration of ``kernels/secular.py`` (the JAX package's ``lax.while_loop``
around that kernel) for every root of a level in one launch.  CUDA tensors
launch ``csrc/secular_sums.cu``; CPU tensors run the plain versions.

Both take f64 operands only.  The solver's f32 mode
(``SolverConfig(dtype=torch.float32)``) widens its f32 operands to f64 at
the call (``secular._solve_roots``) and rounds tau back to f32, so it
launches these kernels as the f64 mode does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build

launches = 0
"""secular_sums kernel launches so far (the CPU path never counts)."""
solve_launches = 0
"""secular_solve kernel launches so far (the CPU path never counts)."""

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SOLVE_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_double, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
_PLAIN_PAIRS = 1 << 22     # (root, pole) pairs per block of the plain version
_SOLVE_CAP = 3072          # poles a secular_solve block holds (48 KB)


class RootSetup(NamedTuple):
    """One level's root-finder state before the iteration, as
    ``kernels/secular.py::_root_setup`` makes it: every field (k, m) f64 but
    ``rho_e`` (k,) f64, ``K`` (k,) int64 and ``done0`` (k, m) bool.  Root i
    of merge b lives at slot i; its left sums run over j <= i."""

    poles_sec: torch.Tensor   # poles, far sentinels in inactive slots
    zu2: torch.Tensor         # z^2 (0 past K)
    rho_e: torch.Tensor       # effective rho of each merge
    K: torch.Tensor           # active slots of each merge
    shift_val: torch.Tensor   # the pole each root is measured from
    zs2: torch.Tensor         # z^2 at the shift pole
    lo: torch.Tensor          # bracket of tau
    hi: torch.Tensor
    tau0: torch.Tensor        # starting tau
    delta_lo: torch.Tensor    # bracket poles of the middle-way model
    delta_hi: torch.Tensor
    done0: torch.Tensor       # roots with nothing to solve (inactive slots)


def secular_sums_plain(poles, z2, shift, tau, sl, K):
    """Plain PyTorch version: same terms (1/dif, z2*inv, t1*inv) as the
    kernel, summed by ``torch.sum``, terms at j >= K_b masked out; blocked
    over roots so live memory stays O(block * m).  Works on any device."""
    k, m = poles.shape
    B = shift.shape[1]
    out = torch.empty((4, k, B), dtype=poles.dtype, device=poles.device)
    cols = torch.arange(m, device=poles.device)
    inside = (cols[None, :] < K[:, None])[:, None, :]
    step = max(1, _PLAIN_PAIRS // max(k * m, 1))
    for i0 in range(0, B, step):
        i1 = min(B, i0 + step)
        dif = ((poles[:, None, :] - shift[:, i0:i1, None])
               - tau[:, i0:i1, None])
        inv = 1.0 / dif
        t1 = torch.where(inside, z2[:, None, :] * inv, 0.0)
        t2 = t1 * inv
        left = cols[None, None, :] <= sl[:, i0:i1, None]
        out[0, :, i0:i1] = t1.sum(dim=2)
        out[1, :, i0:i1] = t2.sum(dim=2)
        out[2, :, i0:i1] = torch.where(left, t1, 0.0).sum(dim=2)
        out[3, :, i0:i1] = torch.where(left, t2, 0.0).sum(dim=2)
    return out.unbind(0)


def secular_sums(poles, z2, shift, tau, sl, K):
    """(S1, S2, S1L, S2L), each (k, B) f64.

    poles, z2: (k, m) f64; shift, tau: (k, B) f64; sl: (k, B) int64 global
    pole indices for the left mask; K: (k,) int64, the poles swept per
    merge.  CPU tensors use the plain version; CUDA tensors launch the
    kernel (or raise)."""
    _check(poles, z2, shift, tau, sl, K)
    if poles.device.type == "cpu":
        return secular_sums_plain(poles, z2, shift, tau, sl, K)
    return _launch(poles, z2, shift, tau, sl, K)


def secular_solve_plain(setup: RootSetup, tolf: float, max_iters: int,
                        sums=secular_sums_plain):
    """The root finder's iteration in PyTorch, every root of the level at
    once: per iteration one call of ``sums`` (S1, S2, S1L, S2L at the
    current tau), then the update; a root is frozen once it meets the test
    or its pass leaves (tau, lo, hi) unchanged (a fixed point of the
    iteration: its bracket has closed to adjacent doubles while |h| stays
    above the test), and the loop stops when all are (one host sync per
    iteration) or after ``max_iters``.
    Returns (tau, iters): tau (k, m) f64 and the sweeps each root took
    (k, m) int32.  Works on any device; ``sums`` may be the kernel."""
    s = setup
    k, m = s.poles_sec.shape
    dev = s.poles_sec.device
    sl = torch.arange(m, device=dev).expand(k, m).contiguous()
    rho = s.rho_e[:, None]
    zs2 = s.zs2
    tau, lo, hi = s.tau0, s.lo, s.hi
    big = torch.tensor(1e30, dtype=tau.dtype, device=dev)
    one = torch.ones_like(tau)
    done = s.done0
    iters = torch.zeros((k, m), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters and not bool(done.all()):
        S1, S2, S1L, S2L = sums(s.poles_sec, s.zu2, s.shift_val, tau, sl, s.K)
        iters += (~done).to(torch.int32)
        # the shift slot's dif is -tau exactly (shift_val is the pole)
        inv_s = 1.0 / -tau
        t1s = zs2 * inv_s
        t2s = t1s * inv_s
        psi = rho * S1L
        psi1 = rho * S2L
        phi = rho * S1 - psi
        phi1 = rho * S2 - psi1
        f = 1.0 + psi + phi
        # convergence test on h = tau*D - rho*z_s^2 (singular term isolated)
        Ds = 1.0 + rho * (S1 - t1s)
        h = tau * Ds - rho * zs2
        scale_h = torch.abs(tau) * (1.0 + torch.abs(rho)
                                    * torch.abs(S1 - t1s)) + rho * zs2
        done_now = torch.abs(h) <= tolf * scale_h
        # sign(f) = sign(h) * sign(tau); f > 0 => root below tau
        f_pos = (h > 0) ^ (tau < 0)
        lo_in, hi_in = lo, hi
        hi = torch.where(f_pos, torch.minimum(hi, tau), hi)
        lo = torch.where(f_pos, lo, torch.maximum(lo, tau))
        # middle-way model: c3 + c1/(Dlo - eta) + c2/(Dhi - eta) fitted to
        # f and f'  ->  a eta^2 - b eta + c = 0
        Dlo = s.delta_lo - tau
        Dhi = s.delta_hi - tau
        c1 = psi1 * Dlo * Dlo
        c2 = phi1 * Dhi * Dhi
        c3 = f - Dlo * psi1 - Dhi * phi1
        a = c3
        b = c3 * (Dlo + Dhi) + c1 + c2
        c = f * Dlo * Dhi
        disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
        sq = torch.sqrt(disc)
        q = 0.5 * (b + torch.where(b >= 0, sq, -sq))
        e1 = torch.where(a != 0, q / torch.where(a != 0, a, one), big)
        e2 = torch.where(q != 0, c / torch.where(q != 0, q, one), big)
        cand1 = tau + e1
        cand2 = tau + e2
        in1 = (cand1 > lo) & (cand1 < hi)
        in2 = (cand2 > lo) & (cand2 < hi)
        # prefer the smaller step (tangent root) among in-bracket options
        pick1 = in1 & (~in2 | (torch.abs(e1) <= torch.abs(e2)))
        t_quad = torch.where(pick1, cand1, cand2)
        ok_quad = (in1 | in2) & torch.isfinite(t_quad)
        # fallbacks: safeguarded Newton on h, then bisection
        hp = Ds + tau * rho * (S2 - t2s)
        t_newton = tau - h / torch.where(hp != 0, hp, one)
        in_n = (t_newton > lo) & (t_newton < hi)
        t_next = torch.where(ok_quad, t_quad,
                             torch.where(in_n, t_newton, 0.5 * (lo + hi)))
        # a pass that leaves (tau, lo, hi) as it found them is a fixed
        # point: every later pass repeats it, so the root already has the
        # tau it would have after max_iters
        fixed = (t_next == tau) & (lo == lo_in) & (hi == hi_in)
        done = done | done_now | fixed
        tau = torch.where(done, tau, t_next)
        it += 1
    return tau, iters


def secular_solve(setup: RootSetup, tolf: float, max_iters: int):
    """(tau, iters) of every root of the level: :func:`secular_solve_plain`
    on CPU tensors; on CUDA tensors one kernel launch, which iterates each
    block of 32 roots until they have converged or reached their fixed
    point (or ``max_iters``), with no host sync; other devices raise."""
    _check_solve(setup, max_iters)
    if setup.poles_sec.device.type == "cpu":
        return secular_solve_plain(setup, tolf, max_iters)
    return _launch_solve(setup, tolf, max_iters)


def _check(poles, z2, shift, tau, sl, K):
    if poles.ndim != 2 or z2.shape != poles.shape:
        raise ValueError(f"poles/z2 must be (k, m), got {tuple(poles.shape)}, "
                         f"{tuple(z2.shape)}")
    k = poles.shape[0]
    if shift.ndim != 2 or shift.shape[0] != k or tau.shape != shift.shape \
            or sl.shape != shift.shape:
        raise ValueError("shift/tau/sl must be (k, B) with the poles' k")
    if K.shape != (k,):
        raise ValueError(f"K must be ({k},), got {tuple(K.shape)}")
    for name, t in (("poles", poles), ("z2", z2), ("shift", shift),
                    ("tau", tau)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
    for name, t in (("sl", sl), ("K", K)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    dev = poles.device
    if any(t.device != dev for t in (z2, shift, tau, sl, K)):
        raise ValueError("all inputs must be on one device")


def _check_solve(setup, max_iters):
    if not isinstance(setup, RootSetup):
        raise TypeError("setup must be a RootSetup")
    p = setup.poles_sec
    if p.ndim != 2:
        raise ValueError(f"poles_sec must be (k, m), got {tuple(p.shape)}")
    k = p.shape[0]
    for name in RootSetup._fields:
        t = getattr(setup, name)
        want = (k,) if name in ("rho_e", "K") else tuple(p.shape)
        dtype = {"K": torch.int64, "done0": torch.bool}.get(name,
                                                            torch.float64)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != p.device:
            raise ValueError("all inputs must be on one device")
    if not isinstance(max_iters, int) or max_iters < 0:
        raise ValueError(f"max_iters must be an int >= 0, got {max_iters!r}")


def _launch(poles, z2, shift, tau, sl, K):
    global launches
    if poles.device.type != "cuda":
        raise ValueError(f"secular_sums: unsupported device {poles.device}")
    k, m = poles.shape
    B = shift.shape[1]
    if k > 65535:
        raise ValueError(f"secular_sums: k={k} exceeds the grid limit 65535")
    out = torch.empty((4, k, B), dtype=torch.float64, device=poles.device)
    if out.numel() == 0:
        return out.unbind(0)
    ins = [t.contiguous() for t in (poles, z2, shift, tau, sl, K)]
    fn = _build.function("secular_sums", "secular_sums_launch", _ARGTYPES)
    with torch.cuda.device(poles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), out.data_ptr(), k, m, B, stream)
    _build.check_launch(rc, "secular_sums")
    launches += 1
    return out.unbind(0)


def _launch_solve(setup, tolf, max_iters):
    global solve_launches
    dev = setup.poles_sec.device
    if dev.type != "cuda":
        raise ValueError(f"secular_solve: unsupported device {dev}")
    k, m = setup.poles_sec.shape
    if k > 65535:
        raise ValueError(f"secular_solve: k={k} exceeds the grid limit 65535")
    tau = torch.empty((k, m), dtype=torch.float64, device=dev)
    iters = torch.empty((k, m), dtype=torch.int32, device=dev)
    if tau.numel() == 0:
        return tau, iters
    ins = [t.contiguous() for t in setup]
    ins[-1] = ins[-1].view(torch.uint8)
    cap = min(m, _SOLVE_CAP)
    fn = _build.function("secular_sums", "secular_solve_launch",
                         _SOLVE_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), float(tolf), int(max_iters),
                tau.data_ptr(), iters.data_ptr(), k, m, cap, stream)
    _build.check_launch(rc, "secular_solve")
    solve_launches += 1
    return tau, iters
