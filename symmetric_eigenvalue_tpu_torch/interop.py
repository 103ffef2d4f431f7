"""State carried across from the JAX package.

The solver has no weights: its state between layers is the per-level
``MergeRep`` (and the leaf eigenvectors).  These helpers take that state as
numpy arrays — e.g. a JAX ``MergeRep``'s fields after ``np.asarray`` — so one
layer of the port can be held against the JAX package alone.
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
