"""Matrix Market I/O for symmetric tridiagonal matrices.

Port of the JAX package's ``io/mtx.py`` (the same readers, writer,
messages and exception types).  Replaces the reference's vendored NIST
``mmio`` library (lib/mmio.c) plus its
``readSymmTriadiagonalMatrixFromSparseMTX`` (filehandling.c:76-153): parses
``coordinate real general`` files, validates square / tridiagonal /
symmetric, and returns (d, e) arrays.  Also provides the
(unused-in-reference) general 3-band reader (filehandling.c:12-74) and a
writer for round-tripping.

The native C parser (``io/native.py``, the port's ``native/mtxio.c``) reads
when it can be built; this module falls back to pure Python/numpy.
"""

from __future__ import annotations

import numpy as np


class MTXFormatError(ValueError):
    pass


def _read_header(f):
    banner = f.readline()
    if not banner.startswith("%%MatrixMarket"):
        raise MTXFormatError("Could not process Matrix Market banner.")
    parts = banner.strip().split()
    if len(parts) < 5:
        raise MTXFormatError("Could not process Matrix Market banner.")
    _, obj, fmt, field, symm = parts[:5]
    if (obj.lower(), fmt.lower(), field.lower(), symm.lower()) != (
            "matrix", "coordinate", "real", "general"):
        raise MTXFormatError(
            f"Unsupported Matrix Market type: [{obj} {fmt} {field} {symm}] "
            "(need: matrix coordinate real general)")
    line = f.readline()
    while line.startswith("%"):
        line = f.readline()
    rows, cols, nnz = (int(x) for x in line.split())
    return rows, cols, nnz


def _load_entries(f, nnz):
    data = np.loadtxt(f, dtype=np.float64, ndmin=2, max_rows=nnz)
    if data.shape[0] != nnz or data.shape[1] != 3:
        raise MTXFormatError("Malformed entry lines in MTX file")
    r = data[:, 0].astype(np.int64)
    c = data[:, 1].astype(np.int64)
    v = data[:, 2]
    return r, c, v


def read_symmetric_tridiagonal(path, use_native: bool = True):
    """Read a symmetric tridiagonal matrix -> (d (n,), e (n-1,)) numpy float64.

    Validation mirrors filehandling.c:111-147: square, |r-c| <= 1, and the
    super-diagonal must equal the sub-diagonal (symmetry).  Uses the native C
    parser (io/native.py) when available; pure-Python fallback below.
    """
    import os
    if not os.path.exists(path):
        # unify the two parser paths: the native C parser reports a missing
        # file as a generic parse error string; raise the same exception the
        # pure-Python open() would
        raise FileNotFoundError(f"No such file: {path}")
    if use_native:
        from . import native
        out = native.read_symm_tridiag(path)
        if out is not None:
            d, e, err = out
            if d is None:
                raise MTXFormatError(err)
            return d, e
    with open(path, "r") as f:
        rows, cols, nnz = _read_header(f)
        if rows != cols:
            raise MTXFormatError("Matrix is not square")
        n = rows
        r, c, v = _load_entries(f, nnz)

    if np.any(np.abs(r - c) > 1):
        raise MTXFormatError("Matrix is not tridiagonal")
    d = np.zeros(n)
    e_lower = np.full(max(n - 1, 0), np.nan)
    e_upper = np.full(max(n - 1, 0), np.nan)
    diag = r == c
    d[r[diag] - 1] = v[diag]
    lower = r == c + 1
    e_lower[c[lower] - 1] = v[lower]
    upper = c == r + 1
    e_upper[r[upper] - 1] = v[upper]
    have_l = ~np.isnan(e_lower)
    have_u = ~np.isnan(e_upper)
    if np.any(have_l & have_u & (e_lower != e_upper)):
        raise MTXFormatError("Matrix is not symmetric")
    e = np.where(have_l, e_lower, e_upper)
    e[np.isnan(e)] = 0.0
    return d, e


def read_tridiagonal_banded(path):
    """General (possibly nonsymmetric) tridiagonal reader -> (n, 3) packed rows
    [sub, diag, super].  (Ref: the unused filehandling.c:12-74.)"""
    with open(path, "r") as f:
        rows, cols, nnz = _read_header(f)
        if rows != cols:
            raise MTXFormatError("Matrix is not square")
        n = rows
        r, c, v = _load_entries(f, nnz)
    if np.any(np.abs(r - c) > 1):
        raise MTXFormatError("Matrix is not tridiagonal")
    T = np.zeros((n, 3))
    T[r - 1, (c - r) + 1] = v
    return T


def write_symmetric_tridiagonal(
        path, d, e,
        comment: str = "generated by symmetric_eigenvalue_tpu_torch"):
    """Write (d, e) in coordinate/real/general MTX form (both off-diagonals),
    matching the layout of the reference's sample input (tinyL.mtx)."""
    d = np.asarray(d)
    e = np.asarray(e)
    n = d.shape[0]
    entries = []
    for i in range(n):
        entries.append((i + 1, i + 1, d[i]))
        if i + 1 < n:
            entries.append((i + 2, i + 1, e[i]))
            entries.append((i + 1, i + 2, e[i]))
    # column-major order like the sample fixture
    entries.sort(key=lambda t: (t[1], t[0]))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"%{comment}\n")
        f.write(f"{n} {n} {len(entries)}\n")
        for r, c, v in entries:
            f.write(f"{r} {c} {v:.17g}\n")
