"""f64-grade GEMM: CUDA kernel + plain version.

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/dword_matmul.py``.  The TPU
kernel emulates an f64 product with exact bf16 slices; on Hopper the contract
(an f64-accurate ``A @ B``) is a native f64 GEMM.  Batched: one launch
multiplies every (A[b], B[b]) pair of a tree level.  CUDA tensors launch
``csrc/dword_matmul.cu``; CPU tensors run :func:`dword_matmul_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts)."""

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1


def dword_matmul_plain(A, B):
    """Plain PyTorch version (``torch.matmul``).  Works on any device."""
    return torch.matmul(A, B)


def dword_matmul(A, B):
    """C = A @ B in f64.  A (M, K) and B (K, N), or batched (k, M, K) and
    (k, K, N).  CPU tensors use the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if A.ndim != B.ndim or A.ndim not in (2, 3):
        raise ValueError(f"A, B must both be 2-D or both 3-D, got "
                         f"{tuple(A.shape)}, {tuple(B.shape)}")
    if A.shape[-1] != B.shape[-2] or (A.ndim == 3 and A.shape[0] != B.shape[0]):
        raise ValueError(f"shape mismatch {tuple(A.shape)} @ {tuple(B.shape)}")
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError(f"A, B must be float64, got {A.dtype}, {B.dtype}")
    if A.device != B.device:
        raise ValueError("A and B must be on one device")
    if A.device.type == "cpu":
        return dword_matmul_plain(A, B)
    if A.ndim == 2:
        return _launch(A[None], B[None])[0]
    return _launch(A, B)


def _launch(A, B):
    global launches
    if A.device.type != "cuda":
        raise ValueError(f"dword_matmul: unsupported device {A.device}")
    batch, M, K = A.shape
    N = B.shape[2]
    if max(M, N, K) > _INT_MAX or batch > 65535 or M > 65535 * 64:
        raise ValueError(f"dword_matmul: shape {(batch, M, K, N)} exceeds the "
                         "kernel's grid limits")
    C = torch.empty((batch, M, N), dtype=torch.float64, device=A.device)
    if C.numel() == 0:
        return C
    if K == 0:
        return C.zero_()
    A = A.contiguous()
    B = B.contiguous()
    fn = _build.function("dword_matmul", "dword_matmul_launch", _ARGTYPES)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(A.data_ptr(), B.data_ptr(), C.data_ptr(), batch, M, N, K,
                stream)
    _build.check_launch(rc, "dword_matmul")
    launches += 1
    return C
