"""Eigenvector-selection file parsing.

Port of the JAX package's ``io/evselect.py``.  Parity with
``determineEigenvectorsToCompute`` (filehandling.c:165-239): the file holds
1-based eigenvalue indices, one per line; invalid lines (non-positive,
non-integer prefix, or > n) are warned about and skipped; the result is
sorted (duplicates preserved, as in the reference).  A bare ``-e`` means
"all".
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional


@dataclasses.dataclass
class EVSelection:
    """Ref struct ``EVToCompute`` (filehandling.h:10-24)."""

    all: bool = False
    indices: Optional[List[int]] = None   # 0-based, sorted

    @property
    def any(self) -> bool:
        return self.all or bool(self.indices)


def determine_eigenvectors_to_compute(compute_ev: bool,
                                      filename: Optional[str],
                                      n: int,
                                      warn=None) -> EVSelection:
    if warn is None:
        warn = lambda msg: print(msg, file=sys.stdout)  # noqa: E731
    if not compute_ev:
        return EVSelection(all=False, indices=None)
    if filename is None:
        return EVSelection(all=True, indices=None)

    indices: List[int] = []
    with open(filename, "r") as f:
        for lineno, line in enumerate(f):
            try:
                cur = int(line.strip().split()[0]) if line.strip() else 0
            except (ValueError, IndexError):
                cur = 0  # atoi semantics: non-integer -> 0 (filehandling.c:195)
            if cur <= 0 or cur > n:
                warn(f'WARNING: Line {lineno} ("{line.rstrip(chr(10))}") in file '
                     f"{filename} will be ignored. No valid eigenvector index "
                     "for given problem.")
            else:
                indices.append(cur - 1)
    indices.sort()
    return EVSelection(all=False, indices=indices)
