"""Static merge-tree plan.

The reference builds an ``EVRepTree`` of per-node bookkeeping redundantly on every
MPI rank (backtransformation.c:28-158) and walks it with per-rank control flow.
The TPU build replaces that with a *static plan* computed once on the host: a
complete binary tree with a power-of-two number of leaves, each leaf padded to a
uniform size ``b`` so that every merge level is one batched, fixed-shape kernel
call (all merges of a level execute together under vmap/shard_map).

Padding scheme: leaf ``i`` owns original rows ``[off_i, off_i + size_i)`` placed at
padded rows ``[i*b, i*b + size_i)``; the remaining pad slots get large sentinel
diagonal values and exactly-zero z-entries, so they deflate at every merge and
their eigenpairs stay ``(sentinel, e_i)`` until they are sliced off at the end.

Leaf sizing matches the reference: ``n // P`` with the first ``n % P`` leaves one
larger (main.c:317-332, backtransformation.c:85-95).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Static description of one merge level (1 = bottom-most merges)."""

    level: int                    # 1..L
    num_merges: int               # k = P / 2^level
    merge_size: int               # m = b * 2^level (padded)
    boundary_rows: Tuple[int, ...]  # original-coordinate row index of the last
    # actual row of each merge's left subtree; beta = E[boundary_rows[j]]


@dataclasses.dataclass(frozen=True)
class TreePlan:
    n: int                       # original matrix dimension
    num_leaves: int              # P = 2^L
    num_levels: int              # L
    leaf_pad: int                # b: padded leaf size
    leaf_sizes: Tuple[int, ...]  # actual sizes, sum == n
    leaf_offsets: Tuple[int, ...]
    levels: Tuple[LevelPlan, ...]  # bottom-up: levels[0] merges leaves

    @property
    def padded_n(self) -> int:
        return self.num_leaves * self.leaf_pad

    def row_map(self) -> np.ndarray:
        """(n,) padded-row index of each original row."""
        rows = np.empty(self.n, dtype=np.int64)
        for i, (off, sz) in enumerate(zip(self.leaf_offsets, self.leaf_sizes)):
            rows[off:off + sz] = i * self.leaf_pad + np.arange(sz)
        return rows

    def pad_mask(self) -> np.ndarray:
        """(padded_n,) True at pad slots."""
        mask = np.ones(self.padded_n, dtype=bool)
        mask[self.row_map()] = False
        return mask


def build_plan(n: int, leaf_size: int = 32, max_leaves: int | None = None) -> TreePlan:
    """Choose a power-of-two leaf count P with actual leaf sizes ~= leaf_size.

    ``max_leaves`` caps P (the analog of the reference's NUMTASKS); leaf sizes
    follow the reference's n//P (+1 for the first n%P leaves) layout.
    """
    if n < 1:
        raise ValueError("matrix dimension must be >= 1")
    leaf_size = max(1, leaf_size)
    P = 1
    while P * 2 <= n and n / (P * 2) >= leaf_size / 1.0 and (n + P * 2 - 1) // (P * 2) >= 1:
        if n // (P * 2) < 1:
            break
        if (n / (P * 2)) < leaf_size:
            break
        P *= 2
    if max_leaves is not None:
        while P > max(1, max_leaves):
            P //= 2
    L = int(round(math.log2(P)))

    base = n // P
    rem = n % P
    sizes = tuple(base + (1 if i < rem else 0) for i in range(P))
    offsets = tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)[:-1]]))
    b = max(sizes)

    levels = []
    for lev in range(1, L + 1):
        k = P >> lev
        half = 1 << (lev - 1)
        bounds = []
        for j in range(k):
            mid_leaf = j * (1 << lev) + half
            bounds.append(offsets[mid_leaf] - 1)
        levels.append(LevelPlan(level=lev, num_merges=k,
                                merge_size=b * (1 << lev),
                                boundary_rows=tuple(bounds)))
    return TreePlan(n=n, num_leaves=P, num_levels=L, leaf_pad=b,
                    leaf_sizes=sizes, leaf_offsets=offsets,
                    levels=tuple(levels))
