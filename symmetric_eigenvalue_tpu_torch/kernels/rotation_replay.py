"""Givens replays of a tree level's deflation rotations: CUDA kernel (two
launch forms) + plain versions.

Port of two device loops of ``symmetric_eigenvalue_tpu/kernels/assemble.py``
(``lax.fori_loop``s over the waves, no ``pallas_call``), each on the rows
of every merge b of a level and in the data's dtype:

- :func:`rotation_replay` (``_replay_rotations_level``, the downsweep), on
  y (k, m, C)::

      for w = nwave_b .. 1, every logged rotation i < nrot_b of wave w:
          u_a <- c u_a + s u_b,   u_b <- -s u_a + c u_b

- :func:`rotation_replay_t` (``_replay_rotations_cols_t``, the upsweep's
  transposed chain in ``rows_through_merge``), on wt (k, m, r), r <= 2::

      for w = 1 .. nwave_b, every logged rotation of wave w:
          w_a <- c w_a - s w_b,   w_b <- s w_a + c w_b

Rotations within one wave touch disjoint rows, so a wave is one gather /
rotate / scatter.  CUDA tensors launch ``csrc/rotation_replay.cu``, which
reads the rotation log on the device (no host fetch, so a launch is the
same whatever the data and a CUDA graph can hold it); CPU tensors run the
plain versions, the wave loops planned on the host from the log
(:func:`rotation_waves`, one device-to-host copy of it).  The kernel rounds
mul, mul, add (or sub) separately, as the loops' elementwise kernels do:
the two agree bit for bit.

The launch plans (:func:`launch_plan`, :func:`launch_plan_t`) and the
kernel's constants below are plain Python, so the CPU tests model the
kernel's schedule with them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import _build
from .secular import MergeRep

launches = 0
"""``rotation_replay`` (downsweep form) launches so far (the CPU path never
counts)."""
t_launches = 0
"""``rotation_replay_t`` (transposed form) launches so far."""

# csrc/rotation_replay.cu's constants
THREADS = 256       # threads a block (both forms)
WAVES = 32          # wave buckets of the counting sort
STAGE = 512         # downsweep: log entries staged at once
SLICE = 32          # downsweep: rotations a one-wave item
STAGE_T = 4096      # transposed: log indices staged at once

Wave = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_T_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_INFO_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
_OCCUPANCY: Dict[tuple, "Occupancy"] = {}


class Occupancy(NamedTuple):
    """One instance on one card: ``rotation_replay_info``'s figures."""

    registers: int
    local_bytes: int
    blocks_per_sm: int
    sms: int
    shared_bytes: int


def rotation_waves(rep: MergeRep) -> List[Wave]:
    """The level's rotations grouped by wave, ascending: for each wave the
    flat row indices (b*m + a, b*m + b) and (c, s) of all its rotations over
    all k merges.  Empty when nothing rotated.  Reads the log on the host."""
    k, m = rep.rot_a.shape
    nrot = rep.nrot.cpu().numpy()
    if not nrot.any():
        return []
    dev = rep.rot_a.device
    wave = rep.rot_wave.cpu().numpy()
    valid = np.arange(m)[None, :] < nrot[:, None]
    a_flat = (rep.rot_a + torch.arange(k, device=dev)[:, None] * m).reshape(-1)
    b_flat = (rep.rot_b + torch.arange(k, device=dev)[:, None] * m).reshape(-1)
    c_flat = rep.rot_c.reshape(-1)
    s_flat = rep.rot_s.reshape(-1)
    waves = []
    for w in range(1, int(wave[valid].max()) + 1):
        sel = torch.as_tensor(np.flatnonzero(valid & (wave == w)), device=dev)
        if sel.numel():
            waves.append((a_flat[sel], b_flat[sel], c_flat[sel], s_flat[sel]))
    return waves


def replay_waves(waves: List[Wave], y):
    """The wave loop on the rows of y (k*m, C), in place: waves in
    descending order, u_a <- c u_a + s u_b, u_b <- -s u_a + c u_b, in y's
    dtype."""
    for a, b, c, s in reversed(waves):
        ua = y[a]
        ub = y[b]
        c = c.to(y.dtype)[:, None]
        s = s.to(y.dtype)[:, None]
        y[a] = c * ua + s * ub
        y[b] = -s * ua + c * ub
    return y


def replay_waves_t(waves: List[Wave], wt):
    """The transposed chain on wt (k*m, r), the columns of w stored as rows,
    in place: waves ascending, w_a <- c w_a - s w_b, w_b <- s w_a + c w_b,
    in wt's dtype."""
    for a, b, c, s in waves:
        wa = wt[a]
        wb = wt[b]
        c = c.to(wt.dtype)[:, None]
        s = s.to(wt.dtype)[:, None]
        wt[a] = c * wa - s * wb
        wt[b] = s * wa + c * wb
    return wt


def planned_waves(rep: MergeRep) -> Optional[List[Wave]]:
    """What a caller that replays one level many times (column chunks)
    plans once: the level's :func:`rotation_waves` on the CPU, None on CUDA
    (the kernel reads the log itself)."""
    return rotation_waves(rep) if rep.rot_a.device.type == "cpu" else None


def rotation_replay_plain(rep: MergeRep, y,
                          waves: Optional[List[Wave]] = None):
    """Plain version: the wave loop on y (k, m, C), in place (``waves``: the
    level's :func:`rotation_waves`, when the caller planned them).  Any
    device; on CUDA it fetches the log."""
    k, m, C = y.shape
    if waves is None:
        waves = rotation_waves(rep)
    replay_waves(waves, y.view(k * m, C))
    return y


def rotation_replay_t_plain(rep: MergeRep, wt,
                            waves: Optional[List[Wave]] = None):
    """Plain version of the transposed form: :func:`replay_waves_t` on wt
    (k, m, r), in place.  Any device; on CUDA it fetches the log."""
    k, m, r = wt.shape
    if waves is None:
        waves = rotation_waves(rep)
    replay_waves_t(waves, wt.view(k * m, r))
    return wt


def _check(rep: MergeRep, x, what: str, max_width: Optional[int]):
    if x.ndim != 3 or tuple(x.shape[:2]) != tuple(rep.rot_a.shape):
        raise ValueError(f"{what} must be (k, m, {'r' if max_width else 'C'}"
                         f") with (k, m) = {tuple(rep.rot_a.shape)}, got "
                         f"{tuple(x.shape)}")
    if max_width is not None and not 1 <= x.shape[2] <= max_width:
        raise ValueError(f"{what}: r must be 1 or 2, got {x.shape[2]}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} must be float32 or float64, got {x.dtype}")


def rotation_replay(rep: MergeRep, y, waves: Optional[List[Wave]] = None):
    """Apply the level's inverse Givens chain to y (k, m, C) f32 or f64 in
    place and return it; y's rows are each merge's partitioned slots.  CPU
    tensors use the plain version (``waves`` as there); CUDA tensors launch
    the kernel (or raise)."""
    _check(rep, y, "y", None)
    if y.device.type == "cpu":
        return rotation_replay_plain(rep, y, waves)
    return _launch(rep, y, transposed=False)


def rotation_replay_t(rep: MergeRep, wt, waves: Optional[List[Wave]] = None):
    """Apply the level's transposed Givens chain to wt (k, m, r), r <= 2,
    f32 or f64, in place and return it (``rows_through_merge``'s boundary
    rows, a merge's slots as rows).  CPU tensors use the plain version
    (``waves`` as there); CUDA tensors launch the kernel (or raise)."""
    _check(rep, wt, "wt", 2)
    if wt.device.type == "cpu":
        return rotation_replay_t_plain(rep, wt, waves)
    return _launch(rep, wt, transposed=True)


def row_vec(y) -> int:
    """Columns a thread of the downsweep form loads at once: 16 bytes (4
    f32, 2 f64) where C is a multiple of it and y 16-byte aligned, else 1."""
    vec = 4 if y.dtype == torch.float32 else 2
    C = y.shape[-1]
    return vec if C % vec == 0 and y.data_ptr() % 16 == 0 else 1


def column_tiles(C: int, vec: int) -> int:
    """The downsweep form's column tiles: THREADS threads of vec columns."""
    return -(-C // (THREADS * vec))


def launch_plan(k: int, m: int, C: int, vec: int, occ: Occupancy) -> int:
    """The downsweep form's grid: what the SMs hold, or fewer where the
    level cannot have that many items (k merges, each its column tiles
    times at most ceil(m / SLICE) slices)."""
    most = k * column_tiles(C, vec) * -(-m // SLICE)
    return max(1, min(occ.blocks_per_sm * occ.sms, most))


def launch_plan_t(k: int, occ: Occupancy) -> int:
    """The transposed form's grid: a block a merge, up to what the SMs
    hold (the blocks stride over the rest)."""
    return max(1, min(occ.blocks_per_sm * occ.sms, k))


def occupancy(device, transposed: bool, data_f32: bool,
              width: int) -> Occupancy:
    """``rotation_replay_info`` of one instance on ``device`` (queried once
    a device and instance)."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, transposed, data_f32, width)
    occ = _OCCUPANCY.get(key)
    if occ is None:
        fn = _build.function("rotation_replay", "rotation_replay_info",
                             _INFO_ARGTYPES)
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(index):
            rc = fn(int(transposed), int(data_f32), width,
                    ctypes.addressof(out))
        _build.check_launch(rc, "rotation_replay_info")
        occ = _OCCUPANCY[key] = Occupancy(*out)
    return occ


def _field(t, dtype, index: int):
    """A log field as the kernel reads it: ``dtype`` with each row's
    entries adjacent (the deflation tree's (k, m) views of (k, m + 1)
    buffers as they are; anything else copied), and its row stride."""
    if t.get_device() != index:
        raise ValueError("rotation_replay: the MergeRep and the data must "
                         "be on one device")
    if t.dtype != dtype or (t.shape[-1] > 1 and t.stride(-1) != 1):
        t = t.to(dtype).contiguous()
    return t, t.stride(0) if t.ndim == 2 else 0


def _launch(rep: MergeRep, x, transposed: bool = False):
    global launches, t_launches
    name = "rotation_replay_t" if transposed else "rotation_replay"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    k, m, width = x.shape
    if not x.is_contiguous():
        raise ValueError(f"{name}: the data must be contiguous (it is "
                         "updated in place)")
    if m >= 2 ** 31:
        raise ValueError(f"{name}: {m} rows a merge exceed the kernel's "
                         "int32 slot indices")
    index = x.get_device()
    # the downsweep form reads c and s in f64, the transposed one in its
    # data's type (the level's own on every path; rounding them here is
    # the plain loop's own first step)
    cs_dtype = x.dtype if transposed else torch.float64
    fields = [_field(t, dtype, index) for t, dtype in (
        (rep.rot_a, torch.int64), (rep.rot_b, torch.int64),
        (rep.rot_c, cs_dtype), (rep.rot_s, cs_dtype),
        (rep.rot_wave, torch.int64), (rep.nrot, torch.int64),
        (rep.nwave, torch.int64))]
    if x.numel() == 0:
        return x
    data_f32 = x.dtype == torch.float32
    vec = width if transposed else row_vec(x)
    occ = occupancy(x.device, transposed, data_f32, vec)
    strides = (ctypes.c_longlong * 5)(*(st for _, st in fields[:5]))
    args = [t.data_ptr() for t, _ in fields] + [ctypes.addressof(strides),
                                                x.data_ptr(), int(data_f32)]
    if transposed:
        fn = _build.function("rotation_replay", "rotation_replay_t_launch",
                             _T_ARGTYPES)
        args += [width, k, m, launch_plan_t(k, occ)]
    else:
        fn = _build.function("rotation_replay", "rotation_replay_launch",
                             _ARGTYPES)
        args += [vec, k, m, width, launch_plan(k, m, width, vec, occ)]
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    _build.check_launch(rc, name)
    if transposed:
        t_launches += 1
    else:
        launches += 1
    return x
