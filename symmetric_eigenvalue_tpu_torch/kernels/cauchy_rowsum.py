"""Boundary rows through a merge's Cauchy matrix: CUDA kernel + plain version.

    S[b, r, i] = sum_{j < K_b} wz[b, r, j] / ((poles_bj - shift_bi) - tau_bi)

for the columns i < K_b of each merge b (r < 2), and 0 past K_b.  Port of
``symmetric_eigenvalue_tpu/kernels/pallas/cauchy_rowsum.py``, batched over the
k merges of a tree level and cut at each merge's active count K (exact: the
caller's wz is 0 past K and it keeps only the columns below K).  CUDA
tensors launch ``csrc/cauchy_rowsum.cu`` (one launch a call, no host sync);
CPU tensors run :func:`cauchy_rowsum_plain`.

f64 operands only: the solver's f32 mode widens its f32 operands to f64
at the call (``assemble.rows_through_merge``) and rounds S back to f32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts)."""

MAX_ROWS = 2
COLS = 128                 # kCols of the kernel: columns a block
LANES = 8                  # kLanes: pole lanes of a column
MIN_SPLIT_POLES = 256      # kTile: a split sweeps at least one tile
WAVES = 4                  # waves of blocks a full-K launch aims at
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_PLAIN_PAIRS = 1 << 22     # (pole, column) pairs per block of the plain version
_CAPACITY = {}             # (device index, R) -> (SMs, blocks an SM holds)
_COUNTERS = {}             # (device index, stream) -> zeroed arrival counters


class Plan(NamedTuple):
    splits: int
    chunk: int


def cauchy_rowsum_plain(poles, shift, tau, wz, K):
    """Plain PyTorch version: ``wz @ (1 / denom)`` per column block over the
    poles below K, as the JAX package's XLA path computes it, and 0 in the
    columns past K.  Works on any device."""
    k, m = poles.shape
    out = torch.empty_like(wz)
    active = torch.arange(m, device=poles.device)[None, :] < K[:, None]
    step = max(1, _PLAIN_PAIRS // max(k * m, 1))
    for i0 in range(0, m, step):
        i1 = min(m, i0 + step)
        denom = ((poles[:, :, None] - shift[:, None, i0:i1])
                 - tau[:, None, i0:i1])
        inv = torch.where(active[:, :, None], 1.0 / denom, 0.0)
        out[:, :, i0:i1] = torch.bmm(wz, inv)
    return torch.where(active[:, None, :], out, 0.0)


def cauchy_rowsum(poles, shift, tau, wz, K):
    """S (k, r, m) f64.  poles, shift, tau: (k, m) f64; wz: (k, r, m) f64,
    1 <= r <= 2; K: (k,) int64, each merge's active count.  CPU tensors use
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if poles.ndim != 2 or shift.shape != poles.shape or tau.shape != poles.shape:
        raise ValueError("poles/shift/tau must all be (k, m)")
    k, m = poles.shape
    if wz.ndim != 3 or wz.shape[0] != k or wz.shape[2] != m \
            or not 1 <= wz.shape[1] <= MAX_ROWS:
        raise ValueError(f"wz must be (k, r<={MAX_ROWS}, m), got "
                         f"{tuple(wz.shape)}")
    if K.shape != (k,):
        raise ValueError(f"K must be ({k},), got {tuple(K.shape)}")
    if K.dtype != torch.int64:
        raise TypeError(f"K must be int64, got {K.dtype}")
    for name, t in (("poles", poles), ("shift", shift), ("tau", tau),
                    ("wz", wz)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
    for t in (shift, tau, wz, K):
        if t.device != poles.device:
            raise ValueError("all inputs must be on one device")
    if poles.device.type == "cpu":
        return cauchy_rowsum_plain(poles, shift, tau, wz, K)
    return _launch(poles, shift, tau, wz, K)


def launch_plan(k: int, m: int, sm_count: int, per_sm: int) -> Plan:
    """How the pole sweep is split across blocks, from the shape and the
    card alone (never from K, so the K cut stays exact): the fewest splits
    whose k * ceil(m / COLS) * splits blocks make ``WAVES`` waves of the
    ``sm_count * per_sm`` blocks the card holds at once, the last wave at
    least 90% full; else as many as ``MIN_SPLIT_POLES`` poles a split
    allow.  The blocks of a merge whose K is below m return early (a
    quarter of them at K = m/2), so a full-K plan of one wave would leave
    most of the card idle on a spectrum that deflates slowly.  ``chunk``
    poles a split, the last one ragged."""
    base = k * -(-m // COLS)
    capacity = max(1, sm_count * per_sm)
    most = max(1, m // MIN_SPLIT_POLES)
    splits = most
    for s in range(1, most + 1):
        blocks = base * s
        if blocks >= WAVES * capacity \
                and blocks >= 0.9 * -(-blocks // capacity) * capacity:
            splits = s
            break
    chunk = -(-m // splits)
    return Plan(-(-m // chunk), chunk)


def kernel_info(R: int, index: int = 0):
    """(registers a thread, local bytes a thread, blocks an SM holds) of
    the kernel's instance for R rows on device ``index``."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(index):
        rc = _build.function("cauchy_rowsum", "cauchy_rowsum_info",
                             [ctypes.c_int, ctypes.c_void_p])(
                                 R, ctypes.addressof(out))
    _build.check_launch(rc, "cauchy_rowsum_info")
    return tuple(out)


def _capacity(index: int, R: int):
    """(SMs, blocks of the R-row kernel an SM holds) of device ``index``."""
    cap = _CAPACITY.get((index, R))
    if cap is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        per_sm = kernel_info(R, index)[2]
        if per_sm <= 0:
            raise RuntimeError("cauchy_rowsum: occupancy query failed")
        cap = _CAPACITY[(index, R)] = (sms, per_sm)
    return cap


def _counters(index: int, stream: int, need: int):
    """The per-column-block arrival counters of one device and stream,
    grown as needed.  Zeroed once, when made; every launch leaves them
    zeroed."""
    counters = _COUNTERS.get((index, stream))
    if counters is None or counters.numel() < need:
        counters = torch.zeros(need, dtype=torch.int32,
                               device=torch.device("cuda", index))
        _COUNTERS[(index, stream)] = counters
    return counters


def _launch(poles, shift, tau, wz, K):
    global launches
    dev = poles.device
    if dev.type != "cuda":
        raise ValueError(f"cauchy_rowsum: unsupported device {dev}")
    k, m = poles.shape
    R = wz.shape[1]
    if k > 65535:
        raise ValueError(f"cauchy_rowsum: k={k} exceeds the grid limit 65535")
    out = torch.empty((k, R, m), dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out
    ins = [t.contiguous() for t in (poles, shift, tau, wz, K)]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    plan = launch_plan(k, m, *_capacity(index, R))
    part = out
    counters = out
    if plan.splits > 1:
        part = torch.empty((k, plan.splits, R, 2, m), dtype=torch.float64,
                           device=dev)
        counters = _counters(index, stream, k * -(-m // COLS))
    fn = _build.function("cauchy_rowsum", "cauchy_rowsum_launch", _ARGTYPES)
    with torch.cuda.device(index):
        rc = fn(*(t.data_ptr() for t in ins), out.data_ptr(), part.data_ptr(),
                counters.data_ptr(), k, m, R, plan.splits, plan.chunk, stream)
    _build.check_launch(rc, "cauchy_rowsum")
    launches += 1
    return out
