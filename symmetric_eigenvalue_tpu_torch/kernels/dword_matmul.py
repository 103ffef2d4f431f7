"""f64-grade GEMM: CUDA kernel + plain version.

Port of ``symmetric_eigenvalue_tpu/kernels/pallas/dword_matmul.py``.  The TPU
kernel emulates an f64 product with exact bf16 slices; on Hopper the contract
(an f64-accurate ``A @ B``: every product and sum is IEEE f64, the order of
the sums is the kernel's own) is a native f64 GEMM on the FP64 tensor cores.
Batched: one launch multiplies every (A[b], B[b]) pair of a tree level or of
a wave of reflector blocks.  Two forms: :func:`dword_matmul` returns
``A @ B``; :func:`dword_matmul_sub_` computes ``C -= A @ B`` in place (C may
be a strided view), without the product ever reaching device memory.

The launch plan (tile shape and split-K count) is a pure function of the
shape, :func:`split_plan`.  CUDA tensors launch ``csrc/dword_matmul.cu``; CPU
tensors run the plain versions.

f64 only: the solver's f32 mode runs its backtransform (the f64
downsweep's products, the cluster Grams) on operands widened to f64
(``driver._backtransform``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts).  A split-K product,
with its second kernel that adds the slices, counts once."""

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1
_GRID_MAX = 65535
_SMS = 132             # streaming multiprocessors of an H100
_BLOCKS_WANTED = 2 * _SMS
_MIN_SLICE = 64        # shortest k-range worth a block of its own
_K_STEP = 16           # the kernel's pipeline stage: slices are multiples


_TILES = {32: (32, 64), 128: (128, 128)}


class Plan(NamedTuple):
    """How one product is launched: a block tile of ``tile_rows`` rows (32:
    32x64, 128: 128x128), ``splits`` slices of K of ``kchunk`` each,
    ``blocks`` thread blocks in all."""
    tile_rows: int
    splits: int
    kchunk: int
    blocks: int


@functools.lru_cache(maxsize=1024)
def split_plan(batch: int, M: int, N: int, K: int) -> Plan:
    """The launch plan of a (batch, M, K) @ (batch, K, N) product.

    Outputs with a side of at most 64 take the 32x64 tile, the others
    128x128.  When the output tiles of all batch entries cannot give every
    SM two blocks and K is long, K is cut into S slices (each at least 64
    deep, a multiple of the kernel's 16-deep stage) so that about two blocks
    per SM are in flight; the S partial tiles are then added in slice order.
    Outputs that fill the card take S = 1.
    """
    tile_rows = 32 if min(M, N) <= 64 else 128
    bm, bn = _TILES[tile_rows]
    tiles = max(1, batch) * -(-M // bm) * -(-N // bn)
    splits = 1
    if tiles < _BLOCKS_WANTED and K >= 2 * _MIN_SLICE:
        splits = min(-(-_BLOCKS_WANTED // tiles), K // _MIN_SLICE)
    if splits == 1:
        return Plan(tile_rows, 1, max(K, 1), tiles)
    per_slice = -(-K // splits)
    kchunk = -(-per_slice // _K_STEP) * _K_STEP
    splits = -(-K // kchunk)             # no empty slice
    return Plan(tile_rows, splits, kchunk, tiles * splits)


def dword_matmul_plain(A, B):
    """Plain PyTorch version (``torch.matmul``).  Works on any device."""
    return torch.matmul(A, B)


def dword_matmul_sub_plain_(C, A, B):
    """Plain PyTorch version of the fused form: ``C.sub_(A @ B)``."""
    return C.sub_(torch.matmul(A, B))


def _check(A, B):
    if A.ndim != B.ndim or A.ndim not in (2, 3):
        raise ValueError(f"A, B must both be 2-D or both 3-D, got "
                         f"{tuple(A.shape)}, {tuple(B.shape)}")
    if A.shape[-1] != B.shape[-2] or (A.ndim == 3
                                      and A.shape[0] != B.shape[0]):
        raise ValueError(f"shape mismatch {tuple(A.shape)} @ {tuple(B.shape)}")
    if A.dtype != torch.float64 or B.dtype != torch.float64:
        raise TypeError(f"A, B must be float64, got {A.dtype}, {B.dtype}")
    if A.device != B.device:
        raise ValueError("A and B must be on one device")


def dword_matmul(A, B):
    """C = A @ B in f64.  A (M, K) and B (K, N), or batched (k, M, K) and
    (k, K, N).  CPU tensors use the plain version; CUDA tensors launch the
    kernel (or raise)."""
    _check(A, B)
    if A.device.type == "cpu":
        return dword_matmul_plain(A, B)
    C = torch.empty(A.shape[:-1] + B.shape[-1:], dtype=torch.float64,
                    device=A.device)
    if C.numel() and A.shape[-1] == 0:
        C.zero_()
    _launch(C, A, B, mode=0)
    return C


def dword_matmul_sub_(C, A, B):
    """C -= A @ B in f64, in place; returns C.  Shapes as
    :func:`dword_matmul`, C (M, N) or (k, M, N).  C may be a strided view
    (a trailing submatrix, say) as long as its columns are adjacent in
    memory; it must not overlap A or B.  CPU tensors use the plain version;
    CUDA tensors launch the kernel (or raise)."""
    _check(A, B)
    if C.shape != A.shape[:-1] + B.shape[-1:]:
        raise ValueError(f"C must have shape "
                         f"{tuple(A.shape[:-1] + B.shape[-1:])}, got "
                         f"{tuple(C.shape)}")
    if C.dtype != torch.float64 or C.device != A.device:
        raise TypeError("C must be float64 on the device of A and B")
    if A.device.type == "cpu":
        return dword_matmul_sub_plain_(C, A, B)
    _launch(C, A, B, mode=1)
    return C


def _launch(C, A, B, mode: int) -> None:
    """One product into C, (M, N) or (batch, M, N): stored (mode 0) or
    subtracted (mode 1)."""
    global launches
    if A.device.type != "cuda":
        raise ValueError(f"dword_matmul: unsupported device {A.device}")
    batch = A.shape[0] if A.ndim == 3 else 1
    M, K = A.shape[-2:]
    N = B.shape[-1]
    if C.numel() == 0 or K == 0:
        return
    if C.stride(-1) != 1 and N > 1:
        raise ValueError("dword_matmul: the columns of C must be adjacent in "
                         f"memory, got strides {C.stride()}")
    plan = split_plan(batch, M, N, K)
    if (max(M, N, K) > _INT_MAX
            or -(-N // _TILES[plan.tile_rows][1]) > _GRID_MAX
            or batch * plan.splits > _GRID_MAX):
        raise ValueError(f"dword_matmul: shape {(batch, M, K, N)} exceeds the "
                         "kernel's grid limits")
    A = A.contiguous()
    B = B.contiguous()
    scratch = 0
    if plan.splits > 1:
        # kept alive by this frame until the launch is enqueued; the caching
        # allocator hands it out again only to later work on this stream
        partial = torch.empty((plan.splits, batch, M, N), dtype=torch.float64,
                              device=A.device)
        scratch = partial.data_ptr()
    fn = _build.function("dword_matmul", "dword_matmul_launch", _ARGTYPES)
    args = (A.data_ptr(), B.data_ptr(), C.data_ptr(), scratch, batch, M, N, K,
            C.stride(-2) if M > 1 else N,
            C.stride(0) if batch > 1 else 0, plan.tile_rows, plan.splits,
            plan.kchunk, mode)
    if A.device.index == torch.cuda.current_device():
        # the panel loops launch thousands of small products: no context
        # manager on their way
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(A.device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "dword_matmul")
    launches += 1
