"""State carried across from the JAX package.

The solver has no weights: its state between layers is the per-level
``MergeRep`` (and the leaf eigenvectors), and, for dense and banded inputs,
the front end's reflectors.  These helpers take that state as numpy arrays
(e.g. a JAX ``MergeRep``'s fields, or ``tridiagonalize``'s outputs, after
``np.asarray``) so one layer of the port can be held against the JAX package
alone.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .kernels.secular import MergeRep

_SCALAR_FIELDS = ("rho", "K", "nrot", "nwave")


def merge_rep_from_numpy(arrays: Mapping[str, np.ndarray],
                         device="cpu") -> MergeRep:
    """``MergeRep`` from numpy arrays keyed by field name.

    Accepts one merge (fields (m,) and scalars) or a level (fields (k, m) and
    (k,)); a single merge gets a batch dimension k = 1.  Floating fields
    become float64 and integer fields int64."""
    batched = np.asarray(arrays["poles"]).ndim == 2
    out = {}
    for name in MergeRep._fields:
        a = np.asarray(arrays[name])
        if not batched:
            a = a[None]
        if not (a.ndim == (1 if name in _SCALAR_FIELDS else 2)):
            raise ValueError(f"field {name} has shape {a.shape}")
        dtype = torch.float64 if np.issubdtype(a.dtype, np.floating) \
            else torch.int64
        out[name] = torch.as_tensor(np.array(a), dtype=dtype,
                                    device=device)
    return MergeRep(**out)


def _f64(a, shape, name: str, device):
    a = np.asarray(a)
    if a.shape != shape:
        raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    return torch.as_tensor(np.array(a), dtype=torch.float64, device=device)


def tridiagonal_reflectors_from_numpy(d, e, Vt, taus, device="cpu"):
    """``(d, e, Vt, taus)`` of ``tridiagonalize`` as tensors: reflector k is
    row k of ``Vt`` (n, n); ``kernels.tridiagonalize.apply_q`` takes
    ``Vt, taus``."""
    n = int(np.asarray(d).shape[0])
    return (_f64(d, (n,), "d", device), _f64(e, (max(n - 1, 0),), "e", device),
            _f64(Vt, (n, n), "Vt", device), _f64(taus, (n,), "taus", device))


def band_reflectors_from_numpy(B, Yt, taus, device="cpu"):
    """``(B, Yt, taus)`` of ``reduce_to_band`` as tensors: reflector c is row
    c of ``Yt`` (n, n); ``apply_q(Yt, taus, X, panel=band)`` applies Q1."""
    n = int(np.asarray(B).shape[0])
    return (_f64(B, (n, n), "B", device), _f64(Yt, (n, n), "Yt", device),
            _f64(taus, (n,), "taus", device))


def wave_log_from_numpy(Vw, tw, device="cpu"):
    """The wavefront chase's reflector log ``(Vw (n-1, Kmax, b), tw (n-1,
    Kmax))`` as the ``vlog`` pair ``apply_q2_wave`` /
    ``apply_q2_wave_blocked`` take."""
    Vw = np.asarray(Vw)
    if Vw.ndim != 3:
        raise ValueError(f"Vw has shape {Vw.shape}, expected (n-1, Kmax, b)")
    return (_f64(Vw, Vw.shape, "Vw", device),
            _f64(tw, Vw.shape[:2], "tw", device))
