#!/usr/bin/env python3
"""How ``panel_qr``'s rounding moves the two-stage solve's accuracy, on the CPU.

``panel_qr`` forms w_k = P_k . v of a column's update from the one-pass
partials, w_k = r_k[u] + d_k / denom, rather than as the dot of P_k with
the rounded v it stores.  This script runs ``eigh(A, band=128)`` of a
seeded random symmetric A (A = (G + G^T) / (2 sqrt n), G standard normal)
on the CPU with the band reduction's panel QR swapped for each of:

- ``plain``: ``panel_qr_plain``, the torch column loop (what CPU tensors
  run, and the arithmetic of the two-sync kernel PR 15 launched);
- ``one_sync``: a numpy model of the one-sync kernel's arithmetic (the
  partials d_k of each block's slice of the live entries, the slices of the
  card's plan, ``panel_qr_plan`` at 132 SMs; totals summed in block order;
  w_k = r_k[u] + d_k / denom);
- ``one_sync_stored_v``: the same with w_k = r_k[u] + sum_{i > u} r_k[i] v_i
  from the stored v (the form that would need a second grid sync a column).

For each it prints one JSON line: the reduction's orthogonality
max|Q1^T Q1 - I| and backward error ||Q1^T A Q1 - B||_F / ||A||_F, the
whole solve's orthogonality max|V^T V - I| and
residual max|A V - V diag(lam)| / max|A| (chip_smoke.py's measures), and
the wall of each variant.  Usage:

    python3 tools/panel_qr_rounding.py --n 4096
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import symmetric_eigenvalue_tpu_torch as st  # noqa: E402
from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as br  # noqa: E402
from symmetric_eigenvalue_tpu_torch.kernels.tridiagonalize import (  # noqa: E402
    apply_q)
from symmetric_eigenvalue_tpu_torch.utils.checks import (  # noqa: E402
    max_ortho_error)

SMS, OPTIN = 132, 232448           # an H100's SMs and shared bytes a block


def one_sync_model(As, o, b, Yp, tp, stored_v):
    """The one-sync kernel's arithmetic (the module docstring) on the panel
    at column o of As, into Yp and tp; As is not modified."""
    A = As.numpy()
    m = A.shape[0]
    base = o + b
    live = m - base
    cnt = min(b, live)
    if cnt <= 0:
        return
    grid = br.panel_qr_plan(m, o, b, SMS, OPTIN, lambda smem: 1).grid
    S = -(-live // grid)
    slices = [(g * S, min((g + 1) * S, live)) for g in range(grid)]
    Pt = A[base:, o:o + b].T.copy()              # entry i at i - base

    def block_sums(rows, vec, c):
        """sum over the blocks, in block order, of rows . vec on each
        block's entries past c (entry c is the pivot)."""
        tot = np.zeros(rows.shape[0])
        for lo, hi in slices:
            lo = max(lo, c + 1)
            if lo < hi:
                tot += rows[:, lo:hi] @ vec[lo:hi]
        return tot

    tot = block_sums(Pt[:cnt], Pt[0], 0)
    for j in range(cnt):
        sigma2, pivot = tot[j], Pt[j, j]
        norm = np.sqrt(sigma2 + pivot * pivot)
        alpha = -norm if pivot >= 0 else norm
        no_op = sigma2 == 0.0
        denom = 1.0 if no_op else pivot - alpha
        tau = 0.0 if no_op else (alpha - pivot) / alpha
        Pt[j, j + 1:] /= denom
        Pt[j, j] = 0.0 if no_op else 1.0
        v = Pt[j]
        if stored_v:
            w = Pt[j + 1:cnt, j] + block_sums(Pt[j + 1:cnt], v, j)
        else:
            w = Pt[j + 1:cnt, j] + tot[j + 1:] / denom
        Yp[j, base + j:] = torch.from_numpy(v[j:].copy())
        tp[j] = tau
        if j + 1 < cnt:
            Pt[j + 1:cnt, j + 1:] -= np.outer(tau * w, v[j + 1:])
            tot = np.zeros(cnt)
            tot[j + 1:] = block_sums(Pt[j + 1:cnt], Pt[j + 1], j + 1)


VARIANTS = {
    "plain": br.panel_qr_plain,
    "one_sync": lambda As, o, b, Yp, tp: one_sync_model(As, o, b, Yp, tp,
                                                        False),
    "one_sync_stored_v": lambda As, o, b, Yp, tp: one_sync_model(
        As, o, b, Yp, tp, True),
}


def run(A, band, name):
    saved = br.panel_qr
    br.panel_qr = VARIANTS[name]
    try:
        t0 = time.perf_counter()
        B, Yt, taus = br.reduce_to_band(A, band)
        Q1 = apply_q(Yt, taus, torch.eye(A.shape[0], dtype=A.dtype),
                     panel=band)
        scale = float(A.abs().max())
        out = dict(variant=name,
                   q1_ortho=max_ortho_error(Q1),
                   q1_backward=float(torch.linalg.norm(Q1.T @ A @ Q1 - B)
                                     / torch.linalg.norm(A)))
        del Q1, B, Yt
        lam, V = st.eigh(A, band=band, device="cpu")
        out.update(ortho=max_ortho_error(V),
                   residual=float((A @ V - V * lam).abs().max()) / scale,
                   wall_s=time.perf_counter() - t0)
        return out
    finally:
        br.panel_qr = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--band", type=int, default=128)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    G = np.random.default_rng(args.seed).standard_normal((args.n, args.n))
    A = torch.from_numpy((G + G.T) / (2.0 * args.n ** 0.5))
    for name in args.variants.split(","):
        print(json.dumps(dict(n=args.n, band=args.band, seed=args.seed,
                              **run(A, args.band, name))), flush=True)


if __name__ == "__main__":
    main()
