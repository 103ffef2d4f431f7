"""f64-grade vector-matrix product ``y = v @ A``: CUDA kernel + plain version.

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/dword_matvec.py``.  The TPU
kernel streams A as a pre-split f32 (hi, lo) pair padded to its tile sizes;
on Hopper the contract is an f64 ``v @ A`` with A read once: no split, no
padding, any row stride (a trailing-submatrix view is passed as it is).  The
caller's A is symmetric, so ``v @ A == A @ v``; the kernel contracts over rows
so that A streams in its row-major layout.  CUDA tensors launch
``csrc/dword_matvec.cu``; CPU tensors run :func:`dword_vecmat_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts)."""

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
             + [ctypes.c_int, ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1
_COLS_PER_BLOCK = 128       # kCols of the kernel
_ROW_TILE = 128             # kRowTile of the kernel
_BLOCKS_PER_SM = 8          # blocks the grid aims to give every SM
_SM_COUNT = {}              # device index -> number of SMs


def dword_vecmat_plain(v, A):
    """Plain PyTorch version (``torch.matmul``).  Works on any device."""
    return torch.matmul(v, A)


def dword_vecmat(v, A):
    """y (m,) = v (n,) @ A (n, m) in f64.  CPU tensors use the plain version;
    CUDA tensors launch the kernel (or raise).  A may be a view with any row
    stride; a non-unit column stride costs one copy."""
    if v.ndim != 1 or A.ndim != 2 or A.shape[0] != v.shape[0]:
        raise ValueError(f"shape mismatch {tuple(v.shape)} @ {tuple(A.shape)}")
    if v.dtype != torch.float64 or A.dtype != torch.float64:
        raise TypeError(f"v, A must be float64, got {v.dtype}, {A.dtype}")
    if v.device != A.device:
        raise ValueError("v and A must be on one device")
    if v.device.type == "cpu":
        return dword_vecmat_plain(v, A)
    return _launch(v, A)


def _row_chunk(rows: int, cols: int, sm_count: int) -> int:
    """Rows per block: whole shared-memory tiles, few enough that the grid has
    about ``_BLOCKS_PER_SM`` blocks per SM."""
    col_tiles = -(-cols // _COLS_PER_BLOCK)
    chunks = max(1, -(-(_BLOCKS_PER_SM * sm_count) // col_tiles))
    per = -(-rows // chunks)
    return max(_ROW_TILE, -(-per // _ROW_TILE) * _ROW_TILE)


def _launch(v, A):
    global launches
    if v.device.type != "cuda":
        raise ValueError(f"dword_vecmat: unsupported device {v.device}")
    rows, cols = A.shape
    if max(rows, cols) > _INT_MAX:
        raise ValueError(f"dword_vecmat: shape {(rows, cols)} exceeds the "
                         "kernel's index range")
    y = torch.empty((cols,), dtype=torch.float64, device=v.device)
    if cols == 0:
        return y
    if rows == 0:
        return y.zero_()
    if A.stride(1) != 1:
        A = A.contiguous()
    v = v.contiguous()
    sm_count = _SM_COUNT.get(v.device.index)
    if sm_count is None:
        sm_count = torch.cuda.get_device_properties(
            v.device).multi_processor_count
        _SM_COUNT[v.device.index] = sm_count
    per = _row_chunk(rows, cols, sm_count)
    chunks = -(-rows // per)
    ws = torch.empty((chunks, 2, cols), dtype=torch.float64, device=v.device)
    fn = _build.function("dword_matvec", "dword_vecmat_launch", _ARGTYPES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(v.data_ptr(), A.data_ptr(), y.data_ptr(), ws.data_ptr(),
                rows, cols, A.stride(0), per, stream)
    _build.check_launch(rc, "dword_vecmat")
    launches += 1
    return y
