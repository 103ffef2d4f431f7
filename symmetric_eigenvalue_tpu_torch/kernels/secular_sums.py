"""Secular root finder's per-iteration reductions: CUDA kernel + plain version.

For each merge b and root i, with dif_ij = (poles_bj - shift_bi) - tau_bi:

    S1[b, i]  = sum_j z2_bj / dif_ij          S2[b, i]  = sum_j z2_bj / dif_ij^2
    S1L[b, i] = sum_{j <= sl_bi} z2_bj / dif_ij
    S2L[b, i] = sum_{j <= sl_bi} z2_bj / dif_ij^2

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/secular_sums.py``, batched
over the k merges of a tree level.  CUDA tensors launch
``csrc/secular_sums.cu``; CPU tensors run :func:`secular_sums_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts)."""

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLAIN_PAIRS = 1 << 22     # (root, pole) pairs per block of the plain version


def secular_sums_plain(poles, z2, shift, tau, sl):
    """Plain PyTorch version: same terms (1/dif, z2*inv, t1*inv) as the
    kernel, summed by ``torch.sum``; blocked over roots so live memory stays
    O(block * m).  Works on any device."""
    k, m = poles.shape
    B = shift.shape[1]
    out = torch.empty((4, k, B), dtype=poles.dtype, device=poles.device)
    cols = torch.arange(m, device=poles.device)
    step = max(1, _PLAIN_PAIRS // max(k * m, 1))
    for i0 in range(0, B, step):
        i1 = min(B, i0 + step)
        dif = ((poles[:, None, :] - shift[:, i0:i1, None])
               - tau[:, i0:i1, None])
        inv = 1.0 / dif
        t1 = z2[:, None, :] * inv
        t2 = t1 * inv
        left = cols[None, None, :] <= sl[:, i0:i1, None]
        out[0, :, i0:i1] = t1.sum(dim=2)
        out[1, :, i0:i1] = t2.sum(dim=2)
        out[2, :, i0:i1] = torch.where(left, t1, 0.0).sum(dim=2)
        out[3, :, i0:i1] = torch.where(left, t2, 0.0).sum(dim=2)
    return out.unbind(0)


def secular_sums(poles, z2, shift, tau, sl):
    """(S1, S2, S1L, S2L), each (k, B) f64.

    poles, z2: (k, m) f64; shift, tau: (k, B) f64; sl: (k, B) int64 global
    pole indices for the left mask.  CPU tensors use the plain version; CUDA
    tensors launch the kernel (or raise)."""
    _check(poles, z2, shift, tau, sl)
    if poles.device.type == "cpu":
        return secular_sums_plain(poles, z2, shift, tau, sl)
    return _launch(poles, z2, shift, tau, sl)


def _check(poles, z2, shift, tau, sl):
    if poles.ndim != 2 or z2.shape != poles.shape:
        raise ValueError(f"poles/z2 must be (k, m), got {tuple(poles.shape)}, "
                         f"{tuple(z2.shape)}")
    k = poles.shape[0]
    if shift.ndim != 2 or shift.shape[0] != k or tau.shape != shift.shape \
            or sl.shape != shift.shape:
        raise ValueError("shift/tau/sl must be (k, B) with the poles' k")
    for name, t in (("poles", poles), ("z2", z2), ("shift", shift),
                    ("tau", tau)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
    if sl.dtype != torch.int64:
        raise TypeError(f"sl must be int64, got {sl.dtype}")
    dev = poles.device
    if any(t.device != dev for t in (z2, shift, tau, sl)):
        raise ValueError("all inputs must be on one device")


def _launch(poles, z2, shift, tau, sl):
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
    ins = [t.contiguous() for t in (poles, z2, shift, tau, sl)]
    fn = _build.function("secular_sums", "secular_sums_launch", _ARGTYPES)
    with torch.cuda.device(poles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), out.data_ptr(), k, m, B, stream)
    _build.check_launch(rc, "secular_sums")
    launches += 1
    return out.unbind(0)
