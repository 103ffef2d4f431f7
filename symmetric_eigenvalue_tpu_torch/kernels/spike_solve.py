"""The Spike-partitioned shifted-tridiagonal solve: CUDA kernels (pass A,
pass B) + plain versions, and the refinement pass built on them.

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/spike_solve.py``.  One
inverse-iteration pass (T - lam_i I) x_i = v_i for every column runs as

  pass A (kernel): per (row block, column), the pivoted block LU for v and
      unit loads on the block's first and last rows; only the six boundary
      values per block and column are written;
  interface (kernel): the 2x2 block-tridiagonal coupling solve over the P
      blocks (``shifted_solve.interface_solve``), once for all column
      chunks, one launch that also scales pass A's boundary responses by
      their couplers and writes the neighbour values pass B reads;
  pass B (kernel): each block re-eliminated with the neighbour couplings
      folded into its first/last rows at load time; writes x and the
      per-block max |x|,

followed by the max-prescaled normalization and the free residual estimate
``||v_i|| / ||x_i||`` (the dstein acceptance quantity), 1e30 when the back
substitution hit the +-2^80 clip.  The arithmetic is IEEE f64 throughout
(the TPU's f32-pair arithmetic is not carried over, nor its 1024-column
tile, its row padding or the ``scan=True`` chunk loop, which works around
XLA buffer fragmentation).  CUDA tensors launch ``csrc/spike_solve.cu``
(one thread a (block, column); the back substitution re-eliminates each
S-row segment from a checkpoint in shared memory, so no factor leaves the
SM and nothing is allocated beyond the outputs; :func:`launch_plan`, which
``shifted_solve`` keeps for all three of that source's block-LU
instances); CPU tensors run :func:`spike_pass_a_plain` /
:func:`spike_pass_b_plain`, both built on ``shifted_solve._block_lu_solve``,
and the interface's plain loop.

lam and the band are f64 only: the solver's f32 mode widens d, e and lam
to f64 before the backtransform (``driver._backtransform``), so the
passes run as in the f64 mode; the driver rounds the refined columns to
f32 at the end.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import shifted_solve
from .refine import band_prep
from .shifted_solve import (  # noqa: F401  (the launch plan's names)
    _BIG, _SEGMENT, _block_lu_solve, kernel_info, launch_plan, plan_for,
    shared_bytes)

pass_a_launches = 0
"""Pass A kernel launches so far (the CPU path never counts)."""
pass_b_launches = 0
"""Pass B kernel launches so far."""

_COMMON = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 7)
_ARGTYPES_A = _COMMON + [ctypes.c_void_p] * 2
_ARGTYPES_B = _COMMON + [ctypes.c_void_p] * 7
_CLIP_FLAG = 1e30


def _blocks(V, npad, nb):
    """V (n, K) as f64 blocks (P, nb, K), zero pad rows."""
    n, K = V.shape
    Vp = V.to(torch.float64)
    if npad > n:
        Vp = torch.cat([Vp, Vp.new_zeros((npad - n, K))], dim=0)
    return Vp.view(npad // nb, nb, K)


def spike_pass_a_plain(db, e_all, tiny, lam, V, nb: int):
    """Plain version of pass A: the boundary rows of the three-rhs block
    solve.  Returns bnd (6, P, K) = uf, ul, s1f, s1l, s2f, s2l."""
    npad = db.shape[0]
    P = npad // nb
    K = lam.shape[0]
    rhs = torch.zeros((P, nb, 3, K), dtype=torch.float64, device=db.device)
    rhs[:, :, 0] = _blocks(V, npad, nb)
    rhs[:, 0, 1] = 1.0
    rhs[:, nb - 1, 2] = 1.0
    sol = _block_lu_solve(db.view(P, nb), e_all.view(P, nb)[:, :nb - 1],
                          lam, rhs, tiny)
    return torch.stack([sol[:, 0, 0], sol[:, nb - 1, 0],
                        sol[:, 0, 1], sol[:, nb - 1, 1],
                        sol[:, 0, 2], sol[:, nb - 1, 2]])


def spike_pass_b_plain(db, e_all, tiny, lam, V, nb: int, L_above, F_below,
                       ec_above, e_cross):
    """Plain version of pass B: the block solve with the couplings folded
    into the first/last rows' right-hand side.  Returns (X (npad, K),
    mx (P, K))."""
    npad = db.shape[0]
    P = npad // nb
    K = lam.shape[0]
    rows = torch.arange(nb, device=db.device)[None, :, None]
    tL = (ec_above[:, None] * L_above)[:, None, :]
    tF = (e_cross[:, None] * F_below)[:, None, :]
    fold = (torch.where(rows == 0, tL, 0.0)
            + torch.where(rows == nb - 1, tF, 0.0))
    rhs = (_blocks(V, npad, nb) - fold)[:, :, None, :]
    sol = _block_lu_solve(db.view(P, nb), e_all.view(P, nb)[:, :nb - 1],
                          lam, rhs, tiny)[:, :, 0]
    return sol.reshape(npad, K), sol.abs().amax(dim=1)


def _check_v(lam, V):
    if V.ndim != 2 or V.shape[1] != lam.shape[0]:
        raise ValueError(f"V must be (n, K) with K = len(lam), got "
                         f"{tuple(V.shape)} and {tuple(lam.shape)}")
    if V.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"V must be float32 or float64, got {V.dtype}")
    if lam.dtype != torch.float64:
        raise TypeError(f"lam must be float64, got {lam.dtype}")
    if V.device != lam.device:
        raise ValueError("lam and V must be on one device")


def spike_pass_a(db, e_all, tiny, lam, V, nb: int):
    """Pass A: bnd (6, P, K) f64.  db, e_all (npad,) f64 and tiny from
    ``refine.band_prep``; lam (K,) f64; V (n, K) f32 or f64 (a column slice
    is taken without a copy).  CPU tensors use the plain version; CUDA
    tensors launch the kernel (or raise)."""
    _check_v(lam, V)
    if V.device.type == "cpu":
        return spike_pass_a_plain(db, e_all, tiny, lam, V, nb)
    global pass_a_launches
    P = db.shape[0] // nb
    K = lam.shape[0]
    bnd = torch.empty((6, P, K), dtype=torch.float64, device=V.device)
    if K == 0:
        return bnd
    _run("A", db, e_all, tiny, lam, V, nb, K, [bnd])
    pass_a_launches += 1
    return bnd


def spike_pass_b(db, e_all, tiny, lam, V, nb: int, L_above, F_below,
                 ec_above, e_cross):
    """Pass B: (X (npad, K) f64, mx (P, K) f64).  Arguments as
    :func:`spike_pass_a`, plus the interface values L_above, F_below (P, K)
    and the couplers ec_above, e_cross (P,).  CPU tensors use the plain
    version; CUDA tensors launch the kernel (or raise)."""
    _check_v(lam, V)
    if V.device.type == "cpu":
        return spike_pass_b_plain(db, e_all, tiny, lam, V, nb, L_above,
                                  F_below, ec_above, e_cross)
    global pass_b_launches
    npad = db.shape[0]
    P = npad // nb
    K = lam.shape[0]
    X = torch.empty((npad, K), dtype=torch.float64, device=V.device)
    mx = torch.empty((P, K), dtype=torch.float64, device=V.device)
    if K == 0:
        return X, mx
    _run("B", db, e_all, tiny, lam, V, nb, K,
         [L_above.contiguous(), F_below.contiguous(), ec_above.contiguous(),
          e_cross.contiguous(), X, mx])
    pass_b_launches += 1
    return X, mx


def _run(which, db, e_all, tiny, lam, V, nb, K, tail):
    if V.device.type != "cuda":
        raise ValueError(f"spike_solve: unsupported device {V.device}")
    n = V.shape[0]
    P = db.shape[0] // nb
    if P > 65535 or db.shape[0] >= 2 ** 31:
        raise ValueError(f"spike_solve: {P} row blocks exceed the grid limit")
    if V.stride(1) != 1:
        V = V.contiguous()
    for t in [db, e_all, tiny, lam] + tail:
        if t.device != V.device or t.dtype != torch.float64:
            raise ValueError("spike_solve: every operand must be f64 on V's "
                             "device")
    ins = [t.contiguous() for t in (db, e_all, tiny.reshape(1), lam)]
    plan = plan_for(which, nb, V)
    symbol = f"spike_pass_{which.lower()}_launch"
    fn = _build.function("spike_solve", symbol,
                         _ARGTYPES_A if which == "A" else _ARGTYPES_B)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), V.data_ptr(), V.stride(0),
                int(V.dtype == torch.float32), n, nb, P, K, plan.threads,
                plan.shared_bytes,
                *(t.data_ptr() for t in tail), stream)
    _build.check_launch(rc, symbol)


def _interface(bnd, e_cross, ec_above):
    """bnd (6, P, K) -> (L_above, F_below) (P, K): each block's neighbour
    values x[first row of the block below], x[last row of the block above].
    One ``interface_solve`` launch on CUDA: the couplers' products, both
    sweeps and the shift by one block."""
    with torch.profiler.record_function("spike.interface_solve"):
        F_below, L_above = shifted_solve.interface_solve(
            bnd[2], bnd[3], bnd[4], bnd[5], bnd[0], bnd[1],
            ec_above=ec_above, e_cross=e_cross, shifted=True)
    return L_above, F_below


def _normalize(X, mx, V):
    """Max-prescaled unit columns of X (mx: pass B's per-block max |x|) and
    the free residual estimate ||v|| / ||x|| (1e30 where the solve hit the
    clip or is not finite)."""
    vnorm = torch.linalg.vector_norm(V.to(torch.float32),
                                     dim=0).to(torch.float64)
    mx_raw = mx.amax(dim=0)
    mxc = torch.clamp(mx_raw, min=1e-30)
    Y = X / mxc[None, :]
    nrm = torch.clamp(torch.linalg.vector_norm(Y, dim=0), min=1e-30)
    res = vnorm / (mxc * nrm)
    # ||v||/||x|| assumes x solves the system; a clipped cascade is not a
    # solution and its estimate comes out absurdly small, so flag it for the
    # driver's extra and rescue passes
    clipped = ~torch.isfinite(mx_raw) | (mx_raw >= _BIG * 0.99)
    res = torch.where(clipped, torch.full_like(res, _CLIP_FLAG), res)
    return Y / nrm[None, :], res


def spike_refine(d, e, lam, V, nb: int = 128, chunk: int = 2048,
                 normalize: bool = True):
    """One f64 inverse-iteration pass: returns (X (n, K) f64, res_est (K,)
    f64), X normalized and ``res_est[i] = ||v_i|| / ||x_i||`` (or 1e30 on a
    clipped solve).  ``normalize=False`` returns the raw solution and zeros.

    Columns run in ``chunk``-wide slices with ONE interface solve across
    all of them.  d, e f64 on V's device; lam (K,) f64; V (n, K) f32 or
    f64."""
    n = d.shape[0]
    K = lam.shape[0]
    nb = int(nb)
    chunk = max(1, int(chunk))
    db, e_all, e_cross, ec_above, tiny = band_prep(d, e, nb)
    npad = db.shape[0]
    P = npad // nb
    bnd = torch.empty((6, P, K), dtype=torch.float64, device=V.device)
    for o in range(0, K, chunk):
        bnd[:, :, o:o + chunk] = spike_pass_a(db, e_all, tiny,
                                              lam[o:o + chunk],
                                              V[:, o:o + chunk], nb)
    L_above, F_below = _interface(bnd, e_cross, ec_above)
    del bnd
    X = torch.empty((n, K), dtype=torch.float64, device=V.device)
    res = torch.zeros(K, dtype=torch.float64, device=V.device)
    for o in range(0, K, chunk):
        Vc = V[:, o:o + chunk]
        Xc, mx = spike_pass_b(db, e_all, tiny, lam[o:o + chunk], Vc, nb,
                              L_above[:, o:o + chunk],
                              F_below[:, o:o + chunk], ec_above, e_cross)
        Xc = Xc[:n]
        if normalize:
            Xc, res[o:o + chunk] = _normalize(Xc, mx, Vc)
        X[:, o:o + chunk] = Xc
    return X, res


def solve_shifted_tridiagonal_spike(d, e, lam, B, nb: int = 128):
    """Spike solve of (T - lam_i I) x_i = B[:, i] for every column: the
    unnormalized solution X (n, K) f64."""
    X, _ = spike_refine(d, e, lam, B, nb=nb, normalize=False)
    return X
