"""Debug printers (ref helper.c:64-93): tridiagonal matrices, vectors and
dense matrices as text.  Each takes numpy arrays or tensors on any
device."""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def print_vector(vec):
    print(", ".join(f"{v:g}" for v in _host(vec)))


def print_tridiagonal_matrix(d, e):
    d = _host(d)
    e = _host(e)
    n = d.shape[0]
    assert n > 0
    if n == 1:
        print(f"{d[0]:g}")
        return
    if n == 2:
        print(f"{d[0]:g}\t{e[0]:g}")
        print(f"{e[0]:g}\t{d[1]:g}")
        return
    print(f"0\t{d[0]:g}\t{e[0]:g}")
    for i in range(1, n - 1):
        print(f"{e[i-1]:g}\t{d[i]:g}\t{e[i]:g}")
    print(f"{e[n-2]:g}\t{d[n-1]:g}\t0")


def print_matrix(M):
    for row in _host(M):
        print_vector(row)
