"""Inverse Givens replay of a tree level's deflation rotations: CUDA kernel
+ plain version.

Port of the device loop of ``symmetric_eigenvalue_tpu/kernels/assemble.py``
(``_replay_rotations_level``: a ``lax.fori_loop`` over ``max(nwave)`` waves,
no ``pallas_call``).  For every merge b of a level, on the rows of its
(m, C) block of y and in y's dtype:

    for w = nwave_b .. 1, every logged rotation i < nrot_b of wave w:
        u_a <- c u_a + s u_b,   u_b <- -s u_a + c u_b

Rotations within one wave touch disjoint rows, so a wave is one gather /
rotate / scatter.  CUDA tensors launch ``csrc/rotation_replay.cu``, which
reads the rotation log on the device (no host fetch, so a level's launch
is the same whatever the data and a CUDA graph can hold it); CPU tensors
run the plain version, the wave loop planned on the host from the log
(:func:`rotation_waves`, one device-to-host copy of it).  The kernel rounds
mul, mul, add separately, as the loop's elementwise kernels do: the two
agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build
from .secular import MergeRep

launches = 0
"""``rotation_replay`` kernel launches so far (the CPU path never counts)."""

Wave = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_void_p])
_GRID_MAX = 65535


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


def rotation_replay(rep: MergeRep, y, waves: Optional[List[Wave]] = None):
    """Apply the level's inverse Givens chain to y (k, m, C) f32 or f64 in
    place and return it; y's rows are each merge's partitioned slots.  CPU
    tensors use the plain version (``waves`` as there); CUDA tensors launch
    the kernel (or raise)."""
    if y.ndim != 3 or tuple(y.shape[:2]) != tuple(rep.rot_a.shape):
        raise ValueError(f"y must be (k, m, C) with (k, m) = "
                         f"{tuple(rep.rot_a.shape)}, got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"y must be float32 or float64, got {y.dtype}")
    if y.device.type == "cpu":
        return rotation_replay_plain(rep, y, waves)
    return _launch(rep, y)


def _launch(rep: MergeRep, y):
    global launches
    if y.device.type != "cuda":
        raise ValueError(f"rotation_replay: unsupported device {y.device}")
    k, m, C = y.shape
    if not y.is_contiguous():
        raise ValueError("rotation_replay: y must be contiguous (it is "
                         "updated in place)")
    if k > _GRID_MAX:
        raise ValueError(f"rotation_replay: {k} merges exceed the grid limit")
    ints = [t.to(torch.int64).contiguous()
            for t in (rep.rot_a, rep.rot_b, rep.rot_wave, rep.nrot,
                      rep.nwave)]
    cs = [t.to(torch.float64).contiguous() for t in (rep.rot_c, rep.rot_s)]
    for t in ints + cs:
        if t.device != y.device:
            raise ValueError("rotation_replay: the MergeRep and y must be on "
                             "one device")
    if y.numel() == 0:
        return y
    a, b, w, nrot, nwave = ints
    fn = _build.function("rotation_replay", "rotation_replay_launch",
                         _ARGTYPES)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), cs[0].data_ptr(),
                cs[1].data_ptr(), w.data_ptr(), nrot.data_ptr(),
                nwave.data_ptr(), y.data_ptr(), int(y.dtype == torch.float32),
                k, m, C, stream)
    _build.check_launch(rc, "rotation_replay")
    launches += 1
    return y
