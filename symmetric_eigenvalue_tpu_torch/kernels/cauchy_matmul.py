"""Fused Cauchy generation + f32 product, and the f32 root-U materialization:
CUDA kernels + plain versions.

    M[b, j, i] = f32((zhat_bj / ((poles_bj - shift_bi) - tau_bi)) * ncolinv_bi)

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/cauchy_matmul.py``
(``cauchy_matmul`` and ``cauchy_materialize``), batched over the k merges of
a tree level.  Entries are computed in f64 and rounded to f32 once (in the
product's kernel the quotient is a reciprocal approximation with one Newton
step, within 2^-46 of the division before that rounding; an entry that comes
out not finite is made again by the division, so a zero, subnormal or
infinite denominator gives what the plain version gives).  On the
card the product runs on the tensor cores as a three-pass split, the design
of the TPU kernel's default tier (bf16_3x) with TF32 words in place of bf16
words: x = hi + lo, and hi*hi + lo*hi + hi*lo summed in f32 (about 21 of 24
mantissa bits); the ``SE_DOWNSWEEP_PRECISION`` switch is not carried over.
The plain version is a full-f32 product; :func:`cauchy_matmul_split_plain`
emulates the split in plain PyTorch, for tests and checks only.  Contraction
slots at or past a merge's active count K_b contribute exactly nothing (the
deflation skip).  Ragged shapes are masked inside the kernels, so every
shape is taken.  CUDA tensors launch ``csrc/cauchy_matmul.cu``; CPU tensors
run the plain versions.

The merge data are f64 only: the solver's f32 mode widens its MergeReps to
f64 before the backtransform (``driver._backtransform``), so these kernels
run as in the f64 mode.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

matmul_launches = 0
"""``cauchy_matmul`` kernel launches so far (the CPU path never counts)."""
materialize_launches = 0
"""``cauchy_materialize`` kernel launches so far."""

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLAIN_SLOTS = 512         # contraction slots per step of the plain product
_GRID_MAX = 65535


def _cauchy_block(poles, shift, tau, zhat, ncolinv):
    """(k, |rows|, |cols|) f32 entries from row-indexed poles/zhat (k, R)
    and column-indexed shift/tau/ncolinv (k, S), computed in f64."""
    den = (poles[:, :, None] - shift[:, None, :]) - tau[:, None, :]
    return ((zhat[:, :, None] / den) * ncolinv[:, None, :]).to(torch.float32)


def _sum_over_slot_blocks(poles, shift, tau, zhat, ncolinv, X, K, product):
    """Y = sum over blocks of contraction slots of product(M block, slots):
    M generated in f64 and rounded to f32 block by block, blocks past every
    merge's K skipped and slots past a merge's own K zeroed."""
    k, m = poles.shape
    Y = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    kmax = int(K.max()) if k else 0
    for i0 in range(0, min(kmax, m), _PLAIN_SLOTS):
        i1 = min(m, i0 + _PLAIN_SLOTS)
        Mb = _cauchy_block(poles, shift[:, i0:i1], tau[:, i0:i1], zhat,
                           ncolinv[:, i0:i1])
        live = torch.arange(i0, i1, device=X.device)[None, :] < K[:, None]
        Mb = torch.where(live[:, None, :], Mb,
                         torch.zeros((), device=X.device))
        Y += product(Mb, slice(i0, i1))
    return Y


def cauchy_matmul_plain(poles, shift, tau, zhat, ncolinv, X, K):
    """Plain PyTorch version: slot blocks of M multiplied by f32
    ``torch.bmm``.  Works on any device (the CUDA caller must keep TF32
    off)."""
    return _sum_over_slot_blocks(poles, shift, tau, zhat, ncolinv, X, K,
                                 lambda Mb, sl: torch.bmm(Mb, X[:, sl]))


def tf32_split(x):
    """x (f32) -> (hi, lo), both f32 tensors holding TF32 values (10 stored
    mantissa bits, the low 13 bits zero): hi is x rounded to nearest, ties
    away from zero, as the card's ``cvt.rna.tf32.f32`` rounds; lo is the
    exact remainder x - hi rounded the same way.  hi + lo reproduces x to
    2^-22 relative."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def cauchy_matmul_split_plain(poles, shift, tau, zhat, ncolinv, X, K):
    """Plain emulation of the kernel's arithmetic: the entries of
    :func:`cauchy_matmul_plain`, both operands cut by :func:`tf32_split`,
    and the three products lo*hi + hi*lo + hi*hi summed in f32.  The sums
    inside each product run in PyTorch's order, not the tensor cores'.  Not
    used by the solver.  Works on any device (the CUDA caller must keep TF32
    off)."""
    xh, xl = tf32_split(X)

    def three_passes(Mb, sl):
        mh, ml = tf32_split(Mb)
        return (torch.bmm(ml, xh[:, sl]) + torch.bmm(mh, xl[:, sl])
                + torch.bmm(mh, xh[:, sl]))

    return _sum_over_slot_blocks(poles, shift, tau, zhat, ncolinv, X, K,
                                 three_passes)


def cauchy_materialize_plain(poles, zhat, shift, tau, ncolinv, slots, K):
    """Plain PyTorch version: the Cauchy entries of the active columns
    (slot < K), the unit column e_slot for the others.  Any device."""
    k, m = poles.shape
    u = _cauchy_block(poles, shift, tau, zhat, ncolinv)
    rows = torch.arange(m, device=poles.device)
    eye = (rows[None, :, None] == slots[:, None, :]).to(torch.float32)
    return torch.where((slots < K[:, None])[:, None, :], u, eye)


def _check(named, shapes, device):
    for name, t in named.items():
        want_dtype, want_shape = shapes[name]
        if t.dtype != want_dtype:
            raise TypeError(f"{name} must be {want_dtype}, got {t.dtype}")
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{name} must have shape {want_shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError("all inputs must be on one device")


def cauchy_matmul(poles, shift, tau, zhat, ncolinv, X, K):
    """Y (k, m, C) f32 = M[b][:, :K_b] @ X[b][:K_b] for every merge b.

    poles, shift, tau, zhat, ncolinv: (k, m) f64 (shift and tau indexed by
    contraction slot); X: (k, m, C) f32; K: (k,) int64 active slot counts.
    CPU tensors use the plain version; CUDA tensors launch the kernel (or
    raise)."""
    k, m = poles.shape
    f64, f32, i64 = torch.float64, torch.float32, torch.int64
    if X.ndim != 3:
        raise ValueError(f"X must be (k, m, C), got {tuple(X.shape)}")
    C = X.shape[2]
    _check(dict(poles=poles, shift=shift, tau=tau, zhat=zhat,
                ncolinv=ncolinv, X=X, K=K),
           dict(poles=(f64, (k, m)), shift=(f64, (k, m)), tau=(f64, (k, m)),
                zhat=(f64, (k, m)), ncolinv=(f64, (k, m)),
                X=(f32, (k, m, C)), K=(i64, (k,))), poles.device)
    if poles.device.type == "cpu":
        return cauchy_matmul_plain(poles, shift, tau, zhat, ncolinv, X, K)
    return _launch_matmul(poles, shift, tau, zhat, ncolinv, X, K)


def cauchy_materialize(poles, zhat, shift, tau, ncolinv, slots, K):
    """U (k, m, C) f32: column c of merge b is the Cauchy column of slot
    ``slots[b, c]`` when that slot is active (< K_b), else e_slot exactly.

    poles, zhat: (k, m) f64 per row; shift, tau, ncolinv: (k, C) f64 per
    column (gathered for the selected slots); slots: (k, C) int64; K: (k,)
    int64.  CPU tensors use the plain version; CUDA tensors launch the
    kernel (or raise)."""
    k, m = poles.shape
    f64, i64 = torch.float64, torch.int64
    if slots.ndim != 2:
        raise ValueError(f"slots must be (k, C), got {tuple(slots.shape)}")
    C = slots.shape[1]
    _check(dict(poles=poles, zhat=zhat, shift=shift, tau=tau,
                ncolinv=ncolinv, slots=slots, K=K),
           dict(poles=(f64, (k, m)), zhat=(f64, (k, m)), shift=(f64, (k, C)),
                tau=(f64, (k, C)), ncolinv=(f64, (k, C)),
                slots=(i64, (k, C)), K=(i64, (k,))), poles.device)
    if poles.device.type == "cpu":
        return cauchy_materialize_plain(poles, zhat, shift, tau, ncolinv,
                                        slots, K)
    return _launch_materialize(poles, zhat, shift, tau, ncolinv, slots, K)


def _run(symbol, what, ins, out, k, m, C):
    fn = _build.function("cauchy_matmul", symbol, _ARGTYPES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), out.data_ptr(), k, m, C, stream)
    _build.check_launch(rc, what)


def _launch_matmul(poles, shift, tau, zhat, ncolinv, X, K):
    global matmul_launches
    if poles.device.type != "cuda":
        raise ValueError(f"cauchy_matmul: unsupported device {poles.device}")
    k, m, C = X.shape
    if k > _GRID_MAX or (m + 63) // 64 > _GRID_MAX or C > _GRID_MAX * 128:
        raise ValueError(f"cauchy_matmul: shape {(k, m, C)} exceeds the "
                         "kernel's grid limits")
    Y = torch.empty((k, m, C), dtype=torch.float32, device=X.device)
    if Y.numel() == 0:
        return Y
    ins = [t.contiguous() for t in (poles, shift, tau, zhat, ncolinv, X, K)]
    _run("cauchy_matmul_launch", "cauchy_matmul", ins, Y, k, m, C)
    matmul_launches += 1
    return Y


def _launch_materialize(poles, zhat, shift, tau, ncolinv, slots, K):
    global materialize_launches
    if poles.device.type != "cuda":
        raise ValueError(f"cauchy_materialize: unsupported device "
                         f"{poles.device}")
    k, m = poles.shape
    C = slots.shape[1]
    if k > _GRID_MAX or (m + 7) // 8 > _GRID_MAX or C >= 2 ** 31:
        raise ValueError(f"cauchy_materialize: shape {(k, m, C)} exceeds "
                         "the kernel's grid limits")
    U = torch.empty((k, m, C), dtype=torch.float32, device=poles.device)
    if U.numel() == 0:
        return U
    ins = [t.contiguous() for t in (poles, zhat, shift, tau, ncolinv, slots,
                                    K)]
    _run("cauchy_materialize_launch", "cauchy_materialize", ins, U, k, m, C)
    materialize_launches += 1
    return U
