"""f64-grade vector-matrix product ``y = v @ A``: CUDA kernel + plain version.

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/dword_matvec.py``.  The TPU
kernel streams A as a pre-split f32 (hi, lo) pair padded to its tile sizes;
on Hopper the contract is an f64 ``v @ A`` with A read once: no split, no
padding, any row stride (a trailing-submatrix view is passed as it is).  The
caller's A is symmetric, so ``v @ A == A @ v``; the kernel contracts over rows
so that A streams in its row-major layout.  CUDA tensors launch
``csrc/dword_matvec.cu`` (one launch a call); CPU tensors run
:func:`dword_vecmat_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts)."""

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
             + [ctypes.c_int, ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1
_THREADS = 128              # kThreads of the kernel
_COLS_PER_TILE = 2 * _THREADS   # kCols: two columns a thread
_ROW_STEP = 8               # kRows: chunks are whole multiples of it
_MAX_CHUNK_ROWS = 2048      # v's slice in shared memory: 16 KB at most
_BLOCK_BYTES = 1 << 20      # about how much of A a block streams
_CAPACITY = {}              # device index -> (SMs, blocks an SM holds)
_SCRATCH = {}               # (device index, stream) -> (ws, counters)


class Plan(NamedTuple):
    rows_per_chunk: int
    chunks: int
    col_tiles: int


def dword_vecmat_plain(v, A):
    """Plain PyTorch version (``torch.matmul``).  Works on any device."""
    return torch.matmul(v, A)


def dword_vecmat(v, A):
    """y (m,) = v (n,) @ A (n, m) in f64.  CPU tensors use the plain version;
    CUDA tensors launch the kernel (or raise).  A may be a view with any row
    stride; a non-unit column stride costs one copy.  (The dense reduction's
    column step launches it through :func:`launch_raw`.)"""
    if v.ndim != 1 or A.ndim != 2 or A.shape[0] != v.shape[0]:
        raise ValueError(f"shape mismatch {tuple(v.shape)} @ {tuple(A.shape)}")
    if v.dtype != torch.float64 or A.dtype != torch.float64:
        raise TypeError(f"v, A must be float64, got {v.dtype}, {A.dtype}")
    if v.device != A.device:
        raise ValueError("v and A must be on one device")
    if v.device.type == "cpu":
        return dword_vecmat_plain(v, A)
    return _launch(v, A)


def _plan(rows: int, cols: int, sm_count: int, per_sm: int) -> Plan:
    """Launch geometry: 256-column tiles and row chunks (whole multiples of
    8 rows, at most 2048), as many blocks as fill whole waves of the
    ``sm_count * per_sm`` blocks the card holds at once: one wave where A
    is small, about ``_BLOCK_BYTES`` of A a block where it is large.  A
    last wave of a few blocks would run them alone."""
    col_tiles = -(-cols // _COLS_PER_TILE)
    capacity = max(1, sm_count * per_sm)
    waves = max(1, round(8.0 * rows * cols / (capacity * _BLOCK_BYTES)))
    chunks = max(1, waves * capacity // col_tiles)
    per = -(-rows // chunks)
    per = min(_MAX_CHUNK_ROWS, -(-per // _ROW_STEP) * _ROW_STEP)
    return Plan(per, -(-rows // per), col_tiles)


def _capacity(index: int):
    """(SMs, blocks of the kernel an SM holds) of device ``index``."""
    cap = _CAPACITY.get(index)
    if cap is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        with torch.cuda.device(index):
            per_sm = _build.function("dword_matvec",
                                     "dword_vecmat_blocks_per_sm",
                                     [ctypes.c_int])(_MAX_CHUNK_ROWS)
        if per_sm <= 0:
            raise RuntimeError("dword_vecmat: occupancy query failed")
        cap = _CAPACITY[index] = (sms, per_sm)
    return cap


def _scratch(index: int, stream: int, plan: Plan, cols: int):
    """The partial sums' workspace and the per-tile arrival counters of one
    device and stream, grown as needed.  The counters are zeroed once, when
    made, and every launch leaves them zeroed."""
    ws, counters = _SCRATCH.get((index, stream), (None, None))
    need = plan.chunks * 2 * cols
    dev = torch.device("cuda", index)
    if ws is None or ws.numel() < need:
        ws = torch.empty(need, dtype=torch.float64, device=dev)
    if counters is None or counters.numel() < plan.col_tiles:
        counters = torch.zeros(plan.col_tiles, dtype=torch.int32, device=dev)
    _SCRATCH[(index, stream)] = (ws, counters)
    return ws, counters


def _launch(v, A):
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"dword_vecmat: unsupported device {dev}")
    rows, cols = A.shape
    if max(rows, cols) > _INT_MAX:
        raise ValueError(f"dword_vecmat: shape {(rows, cols)} exceeds the "
                         "kernel's index range")
    y = torch.empty((cols,), dtype=torch.float64, device=dev)
    if cols == 0:
        return y
    if rows == 0:
        return y.zero_()
    if A.stride(1) != 1:
        A = A.contiguous()
    if v.stride(0) != 1:
        v = v.contiguous()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    if torch.cuda.current_device() == index:
        launch_raw(v.data_ptr(), A.data_ptr(), y.data_ptr(), rows, cols,
                   A.stride(0), index, stream)
    else:
        with torch.cuda.device(index):
            launch_raw(v.data_ptr(), A.data_ptr(), y.data_ptr(), rows, cols,
                       A.stride(0), index, stream)
    return y


def launch_raw(v_ptr: int, A_ptr: int, y_ptr: int, rows: int, cols: int,
               lda: int, index: int, stream: int) -> None:
    """One launch on raw pointers: y (cols,) = v (rows,) @ A (rows, cols,
    row stride ``lda``, unit column stride), f64, rows and cols > 0, all on
    device ``index`` (the current device) and ``stream``.  For a caller that
    has checked its tensors once and launches many times (the dense
    reduction's column step); counts the launch."""
    global launches
    plan = _plan(rows, cols, *_capacity(index))
    ws, counters = _scratch(index, stream, plan, cols)
    fn = _build.function("dword_matvec", "dword_vecmat_launch", _ARGTYPES)
    rc = fn(v_ptr, A_ptr, y_ptr, ws.data_ptr(), counters.data_ptr(), rows,
            cols, lda, plan.rows_per_chunk, stream)
    _build.check_launch(rc, "dword_vecmat")
    launches += 1
