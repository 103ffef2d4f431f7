"""Boundary rows through a merge's Cauchy matrix: CUDA kernel + plain version.

    S[b, r, i] = sum_j wz[b, r, j] / ((poles_bj - shift_bi) - tau_bi),  r < 2

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/cauchy_rowsum.py``, batched
over the k merges of a tree level.  CUDA tensors launch
``csrc/cauchy_rowsum.cu``; CPU tensors run :func:`cauchy_rowsum_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts)."""

MAX_ROWS = 2
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PLAIN_PAIRS = 1 << 22     # (pole, column) pairs per block of the plain version


def cauchy_rowsum_plain(poles, shift, tau, wz):
    """Plain PyTorch version: ``wz @ (1 / denom)`` per column block, as the
    JAX package's XLA path computes it.  Works on any device."""
    k, m = poles.shape
    out = torch.empty_like(wz)
    step = max(1, _PLAIN_PAIRS // max(k * m, 1))
    for i0 in range(0, m, step):
        i1 = min(m, i0 + step)
        denom = ((poles[:, :, None] - shift[:, None, i0:i1])
                 - tau[:, None, i0:i1])
        out[:, :, i0:i1] = torch.bmm(wz, 1.0 / denom)
    return out


def cauchy_rowsum(poles, shift, tau, wz):
    """S (k, r, m) f64.  poles, shift, tau: (k, m) f64; wz: (k, r, m) f64,
    1 <= r <= 2.  CPU tensors use the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if poles.ndim != 2 or shift.shape != poles.shape or tau.shape != poles.shape:
        raise ValueError("poles/shift/tau must all be (k, m)")
    k, m = poles.shape
    if wz.ndim != 3 or wz.shape[0] != k or wz.shape[2] != m \
            or not 1 <= wz.shape[1] <= MAX_ROWS:
        raise ValueError(f"wz must be (k, r<={MAX_ROWS}, m), got "
                         f"{tuple(wz.shape)}")
    for name, t in (("poles", poles), ("shift", shift), ("tau", tau),
                    ("wz", wz)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != poles.device:
            raise ValueError("all inputs must be on one device")
    if poles.device.type == "cpu":
        return cauchy_rowsum_plain(poles, shift, tau, wz)
    return _launch(poles, shift, tau, wz)


def _launch(poles, shift, tau, wz):
    global launches
    if poles.device.type != "cuda":
        raise ValueError(f"cauchy_rowsum: unsupported device {poles.device}")
    k, m = poles.shape
    R = wz.shape[1]
    if k > 65535:
        raise ValueError(f"cauchy_rowsum: k={k} exceeds the grid limit 65535")
    out = torch.empty((k, R, m), dtype=torch.float64, device=poles.device)
    if out.numel() == 0:
        return out
    ins = [t.contiguous() for t in (poles, shift, tau, wz)]
    fn = _build.function("cauchy_rowsum", "cauchy_rowsum_launch", _ARGTYPES)
    with torch.cuda.device(poles.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), out.data_ptr(), k, m, R, stream)
    _build.check_launch(rc, "cauchy_rowsum")
    launches += 1
    return out
