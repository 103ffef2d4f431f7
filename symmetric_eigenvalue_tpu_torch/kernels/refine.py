"""Eigenvector refinement: batched shifted tridiagonal solves (inverse
iteration) and cluster re-orthonormalization.

Port of ``symmetric_eigenvalue_tpu/kernels/refine.py``, in f64.  The mixed
path's f32 downsweep leaves f32-grade eigenvectors; one f64 inverse-iteration
pass per eigenpair, (T - lam_i I) y_i = v_i for all columns at once, restores
working-precision residuals, and groups of close eigenvalues are
re-orthonormalized by a batched CholeskyQR (dstein-style).  ``lax.scan``
recurrences of the unblocked solver (n < 512) are Python loops over rows
with every column as one tensor lane; those of the blocked solver, the
block LU and the interface solve, are the CUDA kernels of
``shifted_solve`` on the card (their plain loops on the CPU), and the Spike
kernels (``spike_solve``) take the first pass on the main path.

Not carried over: the TPU writeback variants (``_compiled_orth_writeback``,
``_compiled_orth_writeback_dus``), which exist to dodge TPU scatters and
VMEM limits.  Their counterpart here is an indexed column copy
(``V[:, cols] = ...``): :func:`orthonormalize_clusters` updates V in place.
The fused small-n route plans its orthonormalization from the eigenvalues
alone (:func:`plan_cluster_orth`, numpy on the host, the JAX planner's
output exactly) and applies the plan with no host fetch
(:func:`apply_cluster_orth_plan`).

Cholesky: ``jnp.linalg.cholesky`` returns NaN on a Gram that is not SPD and
the acceptance test reads that; ``torch.linalg.cholesky_ex`` reports it as
``info != 0``, which is folded into the same acceptance flags.
"""

from __future__ import annotations

import numpy as np
import torch

from . import shifted_solve
from .dword_matmul import dword_matmul
# the plain loops live in shifted_solve, beside their kernels; these names
# stay importable from here
from .shifted_solve import (  # noqa: F401
    _block_lu_solve, _clamp_piv, interface_solve)


def _pivot_floor(d, e):
    """tiny = 2^-48 * (max|d| + 2 max|e|) as a 0-d tensor, and the scale."""
    e_max = e.abs().max() if e.numel() else d.new_zeros(())
    scale = d.abs().max() + 2.0 * e_max
    return (2.0 ** -48) * torch.clamp(scale, min=1e-30), scale


def solve_shifted_tridiagonal(d, e, lam, B):
    """Solve (T - lam_i I) x_i = B[:, i] for every i simultaneously.

    d (n,), e (n-1,), lam (K,), B (n, K) -> X (n, K).  Partial pivoting
    between adjacent rows, pivots floored at +-tiny; the back substitution
    carries a power-of-two scale per column (rows emitted at 2^-s_j and
    recombined at the end), as the JAX package does."""
    n = d.shape[0]
    K = lam.shape[0]
    dtype = B.dtype
    if n == 1:
        piv = d[0] - lam
        piv = torch.where(piv == 0, torch.full_like(piv, 1e-30), piv)
        return B / piv[None, :]
    tiny, _ = _pivot_floor(d, e)
    e_ext = torch.cat([e, e.new_zeros(1)])

    a = d[0] - lam
    c = e_ext[0].expand(K)
    r = B[0]
    ud, u1, u2, rr = [], [], [], []
    for j in range(n - 1):
        sub = e[j]
        a0n = d[j + 1] - lam
        c0n = e_ext[j + 1]
        rn = B[j + 1]
        swap = sub.abs() > a.abs()
        piv = _clamp_piv(torch.where(swap, sub, a), tiny)
        m = torch.where(swap, a / piv, sub / piv)
        ud.append(piv)
        u1.append(torch.where(swap, a0n, c))
        u2.append(torch.where(swap, c0n, torch.zeros_like(c)))
        rr.append(torch.where(swap, rn, r))
        a_new = torch.where(swap, c - m * a0n, a0n - m * c)
        c = torch.where(swap, -m * c0n, c0n.expand(K))
        r = torch.where(swap, r - m * rn, rn - m * r)
        a = a_new

    x_last = r / _clamp_piv(a, tiny)
    # fills, not host copies: the fused route captures this in a CUDA graph
    two_m30 = torch.full((), 2.0 ** -30, dtype=dtype, device=B.device)
    two_m40 = torch.full((), 2.0 ** -40, dtype=dtype, device=B.device)
    one = torch.ones((), dtype=dtype, device=B.device)
    xs = torch.empty((n, K), dtype=dtype, device=B.device)
    ss = torch.empty((n, K), dtype=dtype, device=B.device)
    xs[n - 1] = x_last
    ss[n - 1] = 0.0
    x1, x2 = x_last, torch.zeros_like(x_last)
    s = torch.zeros_like(x_last)
    g = torch.ones_like(x_last)
    for j in range(n - 2, -1, -1):
        x = (rr[j] * g - u1[j] * x1 - u2[j] * x2) / ud[j]
        mag = x.abs()
        f1 = torch.where(mag > 2.0 ** 20, two_m30, one)
        f2 = torch.where(mag > 2.0 ** 50, two_m30, one)
        f3 = torch.where(mag > 2.0 ** 80, two_m40, one)
        fac = f1 * f2 * f3
        shift = (torch.where(mag > 2.0 ** 20, 30.0, 0.0)
                 + torch.where(mag > 2.0 ** 50, 30.0, 0.0)
                 + torch.where(mag > 2.0 ** 80, 40.0, 0.0)).to(dtype)
        x = x * fac
        x2 = x1 * fac
        x1 = x
        g = g * fac
        s = s + shift
        xs[j] = x
        ss[j] = s
    s_max = ss.max(dim=0, keepdim=True).values
    return xs * torch.exp2(ss - s_max)


def band_prep(d, e, nb: int):
    """Split the band into P = ceil(n/nb) blocks of nb rows, padding with
    decoupled, well-conditioned rows (diagonal 4*scale + 4, zero coupling).

    Returns (db (npad,), e_all (npad,), e_cross (P,), ec_above (P,), tiny
    (0-d)): e_all[p*nb + j] for j < nb-1 is block p's band, e_cross[p] =
    e_all[p*nb + nb-1] couples block p to p+1, ec_above[p] = e_cross[p-1]."""
    n = d.shape[0]
    tiny, scale = _pivot_floor(d, e)
    npad = n + (-n) % nb
    db = d
    if npad > n:
        db = torch.cat([d, (4.0 * scale + 4.0).expand(npad - n)])
    e_all = torch.cat([e, e.new_zeros(npad - e.shape[0])])
    P = npad // nb
    e_cross = e_all.view(P, nb)[:, nb - 1].contiguous()
    ec_above = torch.cat([e_cross.new_zeros(1), e_cross[:-1]])
    return db, e_all, e_cross, ec_above, tiny


def solve_shifted_tridiagonal_blocked(d, e, lam, B, nb: int = 128):
    """Spike-style partitioned solve of (T - lam_i I) x_i = B[:, i].

    The same pivoted elimination within P = n/nb independent row blocks
    (three right-hand sides each: B and unit loads at the block's first and
    last row; ``shifted_solve.block_lu_solve``), a 2x2 block-tridiagonal
    interface solve over the blocks' boundary values
    (``shifted_solve.interface_solve``), and the interiors from

        x_b = u_b - p_b * L_{b-1} - q_b * F_{b+1}.

    f64 only (B is widened): on CUDA each of the two loops is one kernel
    launch."""
    return _blocked_solve(band_prep(d, e, nb), lam, B.to(d.dtype), nb)


def _blocked_solve(band, lam, B, nb: int):
    """:func:`solve_shifted_tridiagonal_blocked` on a band already split by
    :func:`band_prep` (B f64 (n, K)): the block LU, the interface solve on
    its boundary rows, and the reconstruction."""
    db, e_all, e_cross, ec_above, tiny = band
    n, K = B.shape
    npad = db.shape[0]
    P = npad // nb
    u, p, q = (t.view(P, nb, K) for t in shifted_solve.block_lu_solve(
        db, e_all, tiny, ec_above, e_cross, lam, B, nb))
    F_below, L_above = shifted_solve.interface_solve(
        p[:, 0], p[:, nb - 1], q[:, 0], q[:, nb - 1], u[:, 0], u[:, nb - 1],
        shifted=True)
    x = u - p * L_above[:, None, :] - q * F_below[:, None, :]
    return x.reshape(npad, K)[:n]


def inverse_iteration(d, e, lam, V, steps: int = 1, block: int = 128):
    """Refine eigenvector columns by ``steps`` inverse-iteration passes.

    V may be f32 (the mixed downsweep); the solves run in d's dtype.
    Columns are re-normalized each step (max-prescaled).  n >= 512 uses the
    blocked solver, its band split once for all steps."""
    n = d.shape[0]
    X = V.to(d.dtype)
    band = band_prep(d, e, block) if n >= 512 else None
    for _ in range(steps):
        if band is not None:
            X = _blocked_solve(band, lam, X, block)
        else:
            X = solve_shifted_tridiagonal(d, e, lam, X)
        mx = torch.clamp(X.abs().amax(dim=0, keepdim=True), min=1e-30)
        X = X / mx
        X = X / torch.linalg.vector_norm(X, dim=0, keepdim=True)
    return X


def cluster_segments(lam, gap_tol):
    """Host-side: contiguous index ranges (start, stop), stop - start >= 2,
    of eigenvalues closer than gap_tol to a neighbour."""
    lam = np.asarray(lam)
    segs = []
    start = 0
    for i in range(1, lam.shape[0] + 1):
        if i == lam.shape[0] or lam[i] - lam[i - 1] > gap_tol:
            if i - start >= 2:
                segs.append((start, i))
            start = i
    return segs


_MAX_BATCH_W = 256
# Per-dispatch budget for the batched cluster-orth gather S (nseg, n, w) f64
_BATCH_BUDGET_BYTES = 1 << 29
_MIN_BUDGET_COLS = 512
_NARROW_ORTH_W = 8


def _gram_reduce(S):
    """Per-segment Grams (nseg, w, w) of S (nseg, n, w) as elementwise
    products reduced over n, one (w, w) entry at a time (never the
    (nseg, n, w, w) product)."""
    w = S.shape[2]
    G = S.new_empty((S.shape[0], w, w))
    for i in range(w):
        for j in range(i + 1):
            g = (S[:, :, i] * S[:, :, j]).sum(dim=1)
            G[:, i, j] = g
            G[:, j, i] = g
    return G


def _gram(S):
    """S^T S per batch entry: the ``dword_matmul`` kernel on CUDA,
    ``torch.matmul`` on the CPU.  S (..., n, w) -> (..., w, w)."""
    St = S.transpose(-1, -2)
    if S.device.type == "cpu":
        return torch.matmul(St, S)
    return dword_matmul(St.contiguous(), S.contiguous())


def _cluster_gram(S, nseg: int, wmax: int):
    """Per-segment Grams (nseg, wmax, wmax) from S (nseg, n, wmax): an
    einsum on the CPU; on CUDA elementwise reductions for narrow widths and
    the batched ``dword_matmul`` kernel, (nseg, wmax, n) @ (nseg, n, wmax),
    for wide ones."""
    if S.device.type == "cpu":
        return torch.einsum("bnw,bnv->bwv", S, S)
    if wmax <= _NARROW_ORTH_W:
        return _gram_reduce(S)
    return _gram(S)


def _accept(G, Y, info, eye):
    """A-priori CholeskyQR acceptance per batch entry: Gershgorin row sums
    of |G - I| below 0.1 (bounds cond(G), so one CholeskyQR reaches ~n*u
    orthogonality), a finite result and a Cholesky that succeeded."""
    err = (G - eye).abs().sum(dim=-1).amax(dim=-1)
    finite = torch.isfinite(Y).flatten(start_dim=Y.ndim - 2).all(dim=-1)
    return finite & (err < 0.1) & (info == 0)


def cluster_orth_body(V, starts, widths, *, nseg: int, wmax: int):
    """Batched CholeskyQR over ``nseg`` segments of up to ``wmax`` columns
    (segment-major output).  starts/widths: (nseg,) int64 on V's device;
    pad segments (width 0) and pad columns carry an identity Gram block.
    Returns (Yflat (n, nseg*wmax), seg_ok (nseg,) bool)."""
    n, C = V.shape
    ar = torch.arange(wmax, device=V.device)
    cols = torch.clamp(starts[:, None] + ar[None, :], 0, C - 1)
    colmask = ar[None, :] < widths[:, None]                    # (nseg, wmax)
    S = V[:, cols].permute(1, 0, 2) * colmask[:, None, :]     # (nseg, n, wmax)
    G = _cluster_gram(S, nseg, wmax)
    eye = torch.eye(wmax, dtype=V.dtype, device=V.device)
    G = G + eye[None] * (~colmask).to(V.dtype)[:, :, None]
    L, info = torch.linalg.cholesky_ex(G)
    Y = torch.linalg.solve_triangular(L.mT, S, upper=True, left=False)
    seg_ok = _accept(G, Y, info, eye[None])
    return Y.permute(1, 0, 2).reshape(n, nseg * wmax), seg_ok


def cluster_orth_narrow_body(V, starts, widths, *, w: int):
    """Position-major batched CholeskyQR for narrow segments (w <= 8): the
    w x w Gram, its Cholesky (Crout) and the forward substitution unrolled
    over w as (n, nseg) elementwise work.  Column p of segment s is at
    ``p*nseg + s`` of the returned (n, w*nseg) block."""
    C = V.shape[1]
    S, Gd = [], [[None] * w for _ in range(w)]
    for p in range(w):
        colp = torch.clamp(starts + p, 0, C - 1)
        S.append(V[:, colp] * (p < widths).to(V.dtype)[None, :])
    for i in range(w):
        for j in range(i + 1):
            g = (S[i] * S[j]).sum(dim=0)                       # (nseg,)
            if i == j:                                         # identity pad
                g = torch.where(i < widths, g, torch.ones_like(g))
            Gd[i][j] = Gd[j][i] = g
    err = torch.zeros_like(Gd[0][0])
    for i in range(w):
        row = sum((Gd[i][j] - (1.0 if i == j else 0.0)).abs()
                  for j in range(w))
        err = torch.maximum(err, row)
    L = [[None] * w for _ in range(w)]
    for i in range(w):
        for j in range(i + 1):
            acc = Gd[i][j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(acc) if i == j else acc / L[j][j]
    Y = []
    for i in range(w):
        acc = S[i]
        for k in range(i):
            acc = acc - Y[k] * L[i][k][None, :]
        Y.append(acc / L[i][i][None, :])
    ok = err < 0.1
    for yi in Y:
        ok = ok & torch.isfinite(yi).all(dim=0)
    return torch.cat(Y, dim=1), ok


def plan_cluster_orth(lam_np, norm_t, gap_factor: float, C: int, n: int):
    """Host plan of a batched cluster orthonormalization from the
    eigenvalues alone (segments depend only on the gaps, never on V), so it
    can be made while the device computes V.

    Returns (sig, starts_list, widths_list, seg_of_col, srcpos, mask_plan,
    seg_ranges, wide_segs):
      sig          tuple of (g2, w2, narrow, nseg) per bucket
      starts/widths  per-bucket (g2,) int64 numpy arrays
      seg_of_col   (C,) flat planned-segment index owning each column
      srcpos       (C,) column's replacement index inside the concatenated
                   bucket outputs (narrow buckets are position-major, wide
                   ones segment-major)
      mask_plan    (C,) True on planned columns
      seg_ranges   [(s, t)] per planned segment in flat order (for the
                   explicit QR of a rejected one)
      wide_segs    [(s, t)] segments over ``_MAX_BATCH_W`` columns, left to
                   the caller."""
    lam_np = np.asarray(lam_np)
    segs = cluster_segments(lam_np, gap_factor * norm_t)
    small = [(s, t) for (s, t) in segs if t - s <= _MAX_BATCH_W]
    wide = [(s, t) for (s, t) in segs if t - s > _MAX_BATCH_W]
    buckets = {}
    for (s, t) in small:
        w2 = 1 << (t - s - 1).bit_length() if t - s > 1 else 1
        buckets.setdefault(max(w2, 2), []).append((s, t))
    budget_cols = max(_MIN_BUDGET_COLS, _BATCH_BUDGET_BYTES // (8 * n))
    sig, starts_l, widths_l, seg_ranges = [], [], [], []
    mask_plan = np.zeros(C, bool)
    srcpos = np.zeros(C, np.int64)
    seg_of_col = np.zeros(C, np.int64)
    off = 0
    segidx = 0
    for w2, segs_w in sorted(buckets.items()):
        gcap = max(1, budget_cols // w2)
        for o in range(0, len(segs_w), gcap):
            batch = segs_w[o:o + gcap]
            nseg = len(batch)
            g2 = 1 << (nseg - 1).bit_length() if nseg > 1 else 1
            narrow = w2 <= _NARROW_ORTH_W
            starts = np.zeros(g2, np.int64)
            widths = np.zeros(g2, np.int64)
            for i, (s, t) in enumerate(batch):
                starts[i] = s
                widths[i] = t - s
                mask_plan[s:t] = True
                seg_of_col[s:t] = segidx
                srcpos[s:t] = (off + np.arange(t - s) * g2 + i) if narrow \
                    else (off + i * w2 + np.arange(t - s))
                seg_ranges.append((s, t))
                segidx += 1
            sig.append((g2, w2, narrow, nseg))
            starts_l.append(starts)
            widths_l.append(widths)
            off += g2 * w2
    return (tuple(sig), starts_l, widths_l, seg_of_col, srcpos, mask_plan,
            seg_ranges, wide)


def apply_cluster_orth_plan(V, sig, starts_l, widths_l, seg_of_col, srcpos,
                            mask_plan):
    """Run every planned bucket's CholeskyQR and merge the accepted
    segments into V with one gather + select, acceptance decided on the
    device (no host fetch).  ``starts_l``/``widths_l``, ``seg_of_col``,
    ``srcpos`` and ``mask_plan``: :func:`plan_cluster_orth`'s arrays as
    tensors on V's device.  Returns (V', ok_cat): V' a new tensor (V itself
    when nothing is planned), rejected segments keeping their input
    columns; ok_cat[i] says whether planned segment i was accepted."""
    Yflats, oks = [], []
    for (g2, w2, narrow, nseg), st, wd in zip(sig, starts_l, widths_l):
        if narrow:
            Yf, ok = cluster_orth_narrow_body(V, st, wd, w=w2)
        else:
            Yf, ok = cluster_orth_body(V, st, wd, nseg=g2, wmax=w2)
        Yflats.append(Yf)
        oks.append(ok[:nseg])
    if not Yflats:
        return V, torch.zeros((0,), dtype=torch.bool, device=V.device)
    ok_cat = torch.cat(oks)
    Ycat = torch.cat(Yflats, dim=1)
    col_ok = mask_plan & ok_cat[seg_of_col]
    return torch.where(col_ok[None, :], Ycat[:, srcpos], V), ok_cat


def _wide_orth(S):
    """CholeskyQR of ONE oversized segment S (n, w), w > 256: one Gram and a
    triangular solve, with the batched path's acceptance.  Returns (ok (0-d
    bool), Y)."""
    G = _gram(S)
    L, info = torch.linalg.cholesky_ex(G)
    Y = torch.linalg.solve_triangular(L.T, S, upper=True, left=False)
    eye = torch.eye(S.shape[1], dtype=S.dtype, device=S.device)
    return _accept(G, Y, info, eye), Y


def orth_explicit_qr(V, segs):
    """Explicit QR of the given (s, t) column ranges, in place."""
    for s, t in segs:
        V[:, s:t] = torch.linalg.qr(V[:, s:t])[0]
    return V


def orthonormalize_clusters(lam, V, norm_t, gap_factor: float = 1e-8,
                            min_gap_factor: float = 0.0,
                            touched=None, degenerate_below: float = 0.0):
    """Orthonormalize eigenvector groups whose eigenvalue gaps are below
    gap_factor * ||T|| (inverse iteration cannot separate them; any
    orthonormal basis of the cluster subspace has an equally small
    residual).  Updates V in place and returns it.

    ``touched`` / ``degenerate_below`` (the final cleanup): keep only
    segments whose every gap is below degenerate_below*||T|| or that hold a
    touched column.  ``min_gap_factor`` (the mid pass): keep only segments
    with at least one gap above min_gap_factor*||T||.

    Segments up to 256 columns go through batched CholeskyQRs bucketed by
    power-of-two width (each bucket's gather bounded by
    ``_BATCH_BUDGET_BYTES``), each batch written back into V before the
    next (its rejected segments keep their columns), with one host fetch
    of every acceptance flag; wider ones take one CholeskyQR each; rejected
    segments take an explicit QR."""
    lam_np = np.asarray(lam)
    segs = cluster_segments(lam_np, gap_factor * norm_t)
    if (touched is not None or degenerate_below > 0.0) and segs:
        thr_deg = degenerate_below * norm_t
        tch = None if touched is None else np.asarray(touched)

        def _needs(s, t):
            if degenerate_below > 0.0 and \
                    np.diff(lam_np[s:t]).max(initial=0.0) < thr_deg:
                return True
            return tch is not None and bool(tch[s:t].any())

        segs = [(s, t) for (s, t) in segs if _needs(s, t)]
    if min_gap_factor > 0.0 and segs:
        thr = min_gap_factor * norm_t
        segs = [(s, t) for (s, t) in segs
                if np.diff(lam_np[s:t]).max(initial=0.0) >= thr]
    if not segs:
        return V

    small = [(s, t) for (s, t) in segs if t - s <= _MAX_BATCH_W]
    large = [(s, t) for (s, t) in segs if t - s > _MAX_BATCH_W]
    dev = V.device
    if small:
        n = V.shape[0]
        buckets = {}
        for (s, t) in small:
            w2 = 1 << (t - s - 1).bit_length() if t - s > 1 else 1
            buckets.setdefault(max(w2, 2), []).append((s, t))
        budget_cols = max(_MIN_BUDGET_COLS, _BATCH_BUDGET_BYTES // (8 * n))
        seg_oks, batches = [], []
        for w2, segs_w in sorted(buckets.items()):
            gcap = max(1, budget_cols // w2)
            for o in range(0, len(segs_w), gcap):
                batch = segs_w[o:o + gcap]
                nseg = len(batch)
                g2 = 1 << (nseg - 1).bit_length() if nseg > 1 else 1
                starts = np.zeros(g2, np.int64)
                widths = np.zeros(g2, np.int64)
                for i, (s, t) in enumerate(batch):
                    starts[i] = s
                    widths[i] = t - s
                narrow = w2 <= _NARROW_ORTH_W
                st = torch.as_tensor(starts, device=dev)
                wd = torch.as_tensor(widths, device=dev)
                if narrow:
                    Yf, seg_ok = cluster_orth_narrow_body(V, st, wd, w=w2)
                else:
                    Yf, seg_ok = cluster_orth_body(V, st, wd, nseg=g2,
                                                   wmax=w2)
                # write the batch back at once, keeping V's columns where
                # its segment is rejected (chosen on the device, no fetch):
                # no batch's result outlives it, so the extra memory is one
                # batch, not every clustered column twice.  Narrow results
                # are position-major, wide ones segment-major.
                cols, src, seg = [], [], []
                for i, (s, t) in enumerate(batch):
                    cols.append(np.arange(s, t))
                    src.append(np.arange(t - s) * g2 + i if narrow
                               else i * w2 + np.arange(t - s))
                    seg.append(np.full(t - s, i))
                cols_t, src_t, seg_t = (
                    torch.as_tensor(np.concatenate(a), device=dev)
                    for a in (cols, src, seg))
                V[:, cols_t] = torch.where(seg_ok[seg_t][None, :],
                                           Yf[:, src_t], V[:, cols_t])
                del Yf
                seg_oks.append(seg_ok[:nseg])
                batches += batch
        ok_all = torch.cat(seg_oks).cpu().numpy()      # the one fetch
        large += [b for b, ok in zip(batches, ok_all) if not ok]

    for s, t in large:
        ok, Y = _wide_orth(V[:, s:t])
        if bool(ok):
            V[:, s:t] = Y
        else:
            # near-parallel columns the refinement could not separate
            orth_explicit_qr(V, [(s, t)])
    return V
