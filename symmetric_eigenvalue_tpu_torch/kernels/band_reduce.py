"""Two-stage SBR: dense symmetric -> banded -> tridiagonal, and back.

Port of ``symmetric_eigenvalue_tpu/kernels/band_reduce.py``.

  stage 1 (:func:`reduce_to_band`):  A -> B banded with bandwidth b, via QR
      panels: for each block column k (offset o = k*b) a Householder QR of
      the panel A[o+b:, o:o+b] (the only column-sequential part; each step
      touches a b x m strip: :func:`panel_qr`), then the two-sided block
      update A <- H^T A H, H = I - Y T Y^T, as three GEMMs (A@Y, small Gram,
      fused symmetric rank-2b update) through :func:`dword_matmul`.
  stage 2 (:func:`band_to_tridiag_wave`): B -> tridiagonal by wavefront bulge
      chasing: O(n^2 b) work on small windows, Theta(n) dependent waves.

Reflectors of stage 1 are ROWS of Yt (row c = reflector annihilating column c
below the band; unit at c+b) with scalar taus, the convention of
``tridiagonalize.Vt`` shifted by b, so ``tridiagonalize.apply_q`` applies Q1
to eigenvector blocks unchanged (panel=b).

The three device loops of the JAX package that hold no ``pallas_call``,
the chase's wave loop (JAX ``:294``), the panel QR's column loop (JAX
``:86``) and the blocked backtransform's wave loop (JAX ``:606``), are CUDA
kernels on CUDA tensors: the whole chase is ONE cooperative launch
(``band_chase``, ``csrc/band_reduce.cu``: the band's lower triangle stored
once, each reflector formed a wave ahead of its task, one grid sync a wave,
the schedule computed on the device from the closed form of
:func:`wave_slots` and the items of :func:`chase_slot_items`),
each panel's QR one launch (``panel_qr``, the same source), and the
backtransform, for each chunk of waves, one ``q2_blocks_t`` launch (the
chunk's blocks' T and Y^T, ``csrc/householder_panel.cu``; their wave slots
from the closed form of :func:`q2_wave_range`) then one ``q2_apply`` launch
a wave (``csrc/q2_apply.cu``).  CPU tensors run the plain versions
(:func:`band_to_tridiag_wave_plain`, the torch wave loop;
:func:`panel_qr_plain`, the torch column loop;
:func:`apply_q2_wave_blocked_plain`, the host wave loop); any other device
raises.  No step reads a value back to the host.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from .. import _build
from .dword_matmul import dword_matmul, dword_matmul_sub_
from .tridiagonalize import _householder, _larft

chase_launches = 0
"""``band_chase`` kernel launches so far (the CPU path never counts)."""
panel_qr_launches = 0
"""``panel_qr`` kernel launches so far."""
q2_blocks_t_launches = 0
"""``q2_blocks_t`` kernel launches so far."""
q2_apply_launches = 0
"""``q2_apply`` kernel launches so far."""

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_OCCUPANCY_ARGTYPES = [_I, _P]
_CHASE_ARGTYPES = [_P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I,
                   _I, _I, _I, _I, _I, _P]
_CHASE_OCCUPANCY_ARGTYPES = [_I, _I, _P]
_PANEL_ARGTYPES = [_P, _LL, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _I, _P]
_Q2T_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_Q2T_STAGED_ARGTYPES = [_I, _P]
_Q2_OCCUPANCY_ARGTYPES = [_I, _I, _P]
_Q2_ARGTYPES = [_P, _LL, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_CHASE_WHOLE_B = 32         # band_chase gives a block a whole task to b <= 32
_CHASE_THREADS = (256, 512)   # its blocks: a whole task, a slot's items
_CHASE_CHUNK_MIN = 16       # the narrowest a wave's chunk gets (kChunkMin)
_QR_THREADS = 256           # kQrThreads of panel_qr
_QR_WARPS = _QR_THREADS // 32
_OCCUPANCY = {}             # (kernel, device index, smem) -> occupancy


class ChasePlan(NamedTuple):
    """``band_chase``'s cooperative launch: ``grid`` blocks (of 256 threads
    when ``whole``, else 512) of ``smem`` dynamic shared bytes; each block's
    work tile of ``work`` doubles in shared memory when ``work_shared``,
    else in a global scratch; the items of a slot (:func:`chase_slot_items`):
    the whole task when ``whole``, else the diagonal block and strips of
    each wave's chunk (:func:`chase_wave_chunk`, at most ``chunk``
    columns)."""
    grid: int
    smem: int
    work: int
    work_shared: bool
    chunk: int
    whole: bool


class PanelPlan(NamedTuple):
    """``panel_qr``'s cooperative launch over a bucket: ``grid`` blocks, each
    owning ``slice`` entries of every panel row and caching ``cached`` rows
    of its slice in ``smem`` bytes of shared memory (the rest in a global
    copy)."""
    grid: int
    slice: int
    cached: int
    smem: int


def _occupancy(kernel: str, index: int, smem: int) -> Tuple[int, int, int]:
    """(blocks an SM holds, SMs, shared bytes a block may opt into) of
    ``kernel`` (panel_qr) on CUDA device ``index`` at ``smem`` dynamic
    shared bytes (cached)."""
    key = (kernel, index, smem)
    got = _OCCUPANCY.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        fn = _build.function("band_reduce", f"{kernel}_occupancy",
                             _OCCUPANCY_ARGTYPES)
        with torch.cuda.device(index):
            rc = fn(smem, ctypes.addressof(out))
        _build.check_launch(rc, f"{kernel}_occupancy")
        got = _OCCUPANCY[key] = tuple(out)
    return got


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


# --------------------------------------------------------------------------
# the panel QR


def panel_qr_plain(As, o: int, b: int, Yp, tp) -> None:
    """Plain version of ``panel_qr``: the Householder QR of the panel
    As[:, o:o+b] (rows below o + b), one column at a time.  For j with
    u = o + b + j < m, the reflector of (the updated) column o + j at pivot
    u (``_householder``'s LAPACK convention) into Yp[j] and tp[j], then
    Pt -= tau (Pt v) v^T on the panel's rows Pt = As[:, o:o+b]^T (a copy;
    As is not modified).  Columns with u >= m keep Yp[j], tp[j] as given
    (zeros: identity reflectors)."""
    m = As.shape[0]
    Pt = As[:, o:o + b].T.contiguous()        # rows: panel columns
    for j in range(b):
        u = o + b + j                          # unit position
        if u >= m:
            break                              # identity reflectors
        v, tau, _ = _householder(Pt[j], u - 1, out=Yp[j])
        # apply (I - tau v v^T) to the remaining panel columns
        w = Pt @ v                             # (b,)
        Pt.addr_(w.mul_(tau), v, alpha=-1.0)
        tp[j] = tau


def panel_qr(As, o: int, b: int, Yp, tp) -> None:
    """The panel QR of :func:`_reduce_block` (see :func:`panel_qr_plain`):
    As (m, m) f64 with unit column stride, Yp (b, m) and tp (b,) zero-filled
    and contiguous, on one device.  CPU tensors run the plain loop; CUDA
    tensors launch ``panel_qr`` once (or raise); other devices raise."""
    if As.device.type == "cpu":
        panel_qr_plain(As, o, b, Yp, tp)
        return
    if As.device.type != "cuda":
        raise ValueError(f"panel_qr: unsupported device {As.device}")
    _launch_panel_qr(As, o, b, Yp, tp)


def panel_qr_plan(m: int, b: int, sms: int, max_shared: int,
                  resident: Callable[[int], int]) -> PanelPlan:
    """``panel_qr``'s launch for a bucket of width m and panel width b on a
    card of ``sms`` SMs whose blocks may hold ``max_shared`` bytes of shared
    memory (``resident(smem)``: the blocks an SM holds at ``smem``, from the
    occupancy API on the card): a block an SM (fewer where the slices
    would be under 32 entries), each caching as many panel rows of its
    slice as fit.  Raises when a block does not fit."""
    grid = max(1, min(sms, -(-m // 32)))
    width = -(-m // grid)
    fixed = 8 * (_QR_WARPS + 4 + b)
    cached = min(b, max(0, (max_shared - fixed) // (8 * width)))
    smem = fixed + 8 * cached * width
    if fixed > max_shared or resident(smem) < 1:
        raise ValueError(f"panel_qr: no cooperative launch fits m={m}, b={b}")
    return PanelPlan(grid, width, cached, smem)


def _launch_panel_qr(As, o: int, b: int, Yp, tp) -> None:
    global panel_qr_launches
    m = As.shape[0]
    for name, t in (("As", As), ("Yp", Yp), ("tp", tp)):
        if t.dtype != torch.float64:
            raise TypeError(f"panel_qr: {name} must be float64")
        if t.device != As.device:
            raise ValueError("panel_qr: tensors must be on one device")
    if As.stride(1) != 1 or not Yp.is_contiguous() or not tp.is_contiguous():
        raise ValueError("panel_qr: As needs a unit column stride, Yp and tp "
                         "must be contiguous")
    if Yp.shape != (b, m) or tp.shape != (b,) or o + b > m:
        raise ValueError(f"panel_qr: Yp {tuple(Yp.shape)}, tp "
                         f"{tuple(tp.shape)} for b={b}, m={m}, o={o}")
    cnt = min(b, m - o - b)
    if cnt <= 0:
        return                                 # identity reflectors only
    index = _device_index(As.device)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        _, sms, optin = _occupancy("panel_qr", index, 0)
        plan = panel_qr_plan(m, b, sms, optin,
                             lambda smem: _occupancy("panel_qr", index,
                                                     smem)[0])
        ws = torch.empty(plan.grid * (b + 1) + 1 + b, dtype=torch.float64,
                         device=As.device)
        Pg = None
        if plan.cached < b:
            Pg = torch.empty((b, m), dtype=torch.float64, device=As.device)
        fn = _build.function("band_reduce", "panel_qr_launch",
                             _PANEL_ARGTYPES)
        rc = fn(As.data_ptr(), As.stride(0), Yp.data_ptr(), Yp.stride(0),
                tp.data_ptr(), None if Pg is None else Pg.data_ptr(),
                ws.data_ptr(), m, o, b, cnt, plan.slice, plan.cached,
                plan.grid, plan.smem, stream)
    _build.check_launch(rc, "panel_qr")
    panel_qr_launches += 1


def panel_qr_count(n: int, band: int) -> int:
    """``panel_qr`` launches of ``reduce_to_band(A, band)`` at n, any
    buckets: one a panel, (n - 2) // band panels (every panel has a live
    column)."""
    b = int(band)
    return 0 if n <= b + 1 else max((n - 2) // b, 0)


def _reduce_block(As, ncols: int, b: int, want_reflectors: bool = True):
    """Blocked band reduction of the FIRST ``ncols`` columns (whole panels of
    ``b``) of the trailing symmetric submatrix ``As`` (m, m), local coords,
    updating ``As`` in place.

    Returns (Ytb (ncols, m), taus (ncols,)); reflector for local column c has
    zeros at entries < c + b and unit at c + b.
    """
    m = As.shape[0]
    Ytb = As.new_zeros((ncols if want_reflectors else 0, m))
    taus = As.new_zeros((ncols,))
    for o in range(0, ncols, b):
        # --- panel QR: Householder columns of As[o+b:, o:o+b] -----------
        Yp = Ytb[o:o + b] if want_reflectors else As.new_zeros((b, m))
        tp = taus[o:o + b]
        panel_qr(As, o, b, Yp, tp)

        # --- two-sided block update  As <- (I - Y T Y^T)^T As (I - Y T Y^T)
        T = _larft(Yp, tp)                         # (b, b) upper
        YpT = Yp.T.contiguous()
        P_ = dword_matmul(As, YpT)                 # (m, b) = As Y
        S = dword_matmul(Yp, P_)                   # (b, b) = Y^T As Y
        W = P_ @ T - 0.5 * (YpT @ (T.T @ S @ T))   # (m, b)
        # As -= Y W^T + W Y^T  as one fused (m, 2b) x (2b, m) GEMM
        dword_matmul_sub_(As, torch.cat([YpT, W], dim=1),
                          torch.cat([W.T, Yp], dim=0))
    return Ytb, taus


def reduce_to_band(A, band: int = 128, buckets: int = 1,
                   want_reflectors: bool = True):
    """A (n, n) symmetric -> (B (n, n) banded, Yt (n, n), taus (n,)).

    B = Q1^T A Q1 with bandwidth ``band`` (entries |i-j| > band are ~0);
    Q1 = H_0 H_1 ... where H_c = I - tau_c y_c y_c^T, y_c = Yt[c, :]
    (zero at entries < c + band, unit at c + band).  A is not modified.

    ``buckets``: split the panel range into chunks, each processed on the
    shrunk trailing submatrix (one contiguous copy per bucket, as
    ``tridiagonalize(buckets=)``): reflector support lives entirely in the
    trailing block, so rows above it are exactly frozen, and the per-panel
    GEMMs touch only the trailing block.  ``want_reflectors=False`` skips
    the n^2 reflector store for eigenvalues-only callers (Yt is then a
    (1, 1) placeholder).
    """
    n = A.shape[0]
    if A.ndim != 2 or A.shape[1] != n:
        raise ValueError(f"A must be square, got {tuple(A.shape)}")
    b = int(band)
    yt_shape = (n, n) if want_reflectors else (1, 1)
    if n <= b + 1:
        # already "banded"; no reflectors needed
        return A.clone(), A.new_zeros(yt_shape), A.new_zeros((n,))

    num_panels = max((n - 2) // b, 0)   # last <=b+1 columns are inside band
    buckets = max(1, min(int(buckets), num_panels))
    per = -(-num_panels // buckets)     # ceil: panels per bucket
    cuts = [0]
    while cuts[-1] + per * b < num_panels * b:
        cuts.append(cuts[-1] + per * b)
    cuts.append(num_panels * b)

    B = A.new_zeros((n, n))
    Yt = A.new_zeros(yt_shape)
    taus = A.new_zeros((n,))

    As = A.clone()
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        ncols = c1 - c0
        Ytb, tb = _reduce_block(As, ncols, b, want_reflectors)
        B[c0:c1, c0:] = As[:ncols, :]
        if want_reflectors:
            Yt[c0:c1, c0:] = Ytb
        taus[c0:c1] = tb
        As = As[ncols:, ncols:].contiguous()   # shrink to the next bucket

    B[cuts[-1]:, cuts[-1]:] = As
    # strips write rows [c0, c1) x cols [c0, n): upper-complete, but lower
    # band entries whose column lies in an EARLIER bucket are only present
    # as their upper mirrors; rebuild the lower triangle from the upper
    B = torch.triu(B) + torch.triu(B, 1).T
    return B, Yt, taus


def _chase_schedule(n: int, b: int) -> np.ndarray:
    """Static Givens schedule for band(b) -> tridiagonal (Schwarz chasing).

    Element (i, j) of column j (eliminated bottom-up) is zeroed by a rotation
    of rows (i-1, i); the two-sided application pushes a single bulge to
    (i + b, i - 1), giving the data-independent chase recurrence
    (pi, pj) -> (pi + b, pi - 1) until the band edge.  The schedule depends
    only on (n, b).
    """
    sched = []
    for j in range(n - 2):
        for i in range(min(j + b, n - 1), j + 1, -1):
            pi, pj = i, j
            while pi < n:
                sched.append((pi, pj))
                pj = pi - 1
                pi = pi + b
    if not sched:
        sched = [(1, 0)]          # degenerate; one plain 2x2 rotation
    return np.asarray(sched, np.int64)


def band_to_tridiag(B, band: int):
    """Banded symmetric B (n, n) -> (d, e, rot (S, 2) c/s log).

    Stage 2 by sequential Givens rotations:  T = Q2^T B Q2 with
    Q2^T = G_S ... G_1 (G_t a rotation of rows (pi_t - 1, pi_t)).
    CORRECTNESS TIER: one rotation per step, a few small launches each; the
    wavefront chase (:func:`band_to_tridiag_wave`) is the working path and
    this one its independent check at small n.
    """
    n = B.shape[0]
    if n < 2:
        return B.diagonal().clone(), B.new_zeros((0,)), B.new_zeros((1, 2))
    sched = _chase_schedule(n, int(band))
    A = B.clone()
    cs = B.new_zeros((sched.shape[0], 2))
    for t, (pi, pj) in enumerate(sched.tolist()):
        x = A[pi - 1, pj]
        y = A[pi, pj]
        r = torch.hypot(x, y)
        zero = r == 0
        safe = torch.where(zero, 1.0, r)
        c = torch.where(zero, 1.0, x / safe)
        s = torch.where(zero, 0.0, -y / safe)
        G = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
        A[pi - 1:pi + 1, :] = G @ A[pi - 1:pi + 1, :]
        A[:, pi - 1:pi + 1] = A[:, pi - 1:pi + 1] @ G.T
        torch.stack((c, s), out=cs[t])
    return A.diagonal().clone(), A.diagonal(offset=1).clone(), cs


def apply_q2(n: int, band: int, cs, X):
    """X <- Q2 @ X (eigenvector backtransform through the stage-2 rotations
    of :func:`band_to_tridiag`).

    Q2 = G_1^T ... G_S^T, so apply G_t^T for t = S..1 to rows
    (pi_t - 1, pi_t) of X.  Sequential replay (correctness tier).
    """
    if n < 2:
        return X
    sched = _chase_schedule(n, int(band)).tolist()
    X = X.clone()
    for t in range(len(sched) - 1, -1, -1):
        pi = sched[t][0]
        c, s = cs[t, 0], cs[t, 1]
        Gt = torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
        X[pi - 1:pi + 1, :] = Gt @ X[pi - 1:pi + 1, :]
    return X


def _wave_geometry(n: int, b: int):
    """Static geometry shared by the wavefront chase and its backtransform."""
    kmax_global = max((n - 3) // b, 0)
    Kmax = kmax_global + 1            # hops per sweep, padded
    Wmax = kmax_global // 3 + 1       # concurrent tasks per wave
    Twaves = 3 * max(n - 3, 0) + 1
    return Kmax, Wmax, Twaves


def wave_width(n: int, b: int, t):
    """Live slots of wave t of the chase (they are s = 0 .. W - 1), in
    closed form as ``band_chase`` computes it on the device: slot s is live
    when jj = t//3 - s >= 0 and jj + kk b + 2 <= n - 1 (kk = t%3 + 3s),
    i.e. s <= t//3 and s <= (n - 3 - t//3 - (t%3) b) // (3b - 1).  ``t`` an
    int or an integer numpy array; n >= 3, b >= 2."""
    _, Wmax, _ = _wave_geometry(n, b)
    q, rm = np.divmod(np.asarray(t, dtype=np.int64), 3)
    room = n - 3 - q - rm * b
    w = np.where(room < 0, 0,
                 np.minimum(q, np.maximum(room, 0) // (3 * b - 1)) + 1)
    w = np.minimum(w, Wmax)
    return int(w) if np.ndim(w) == 0 else w


def wave_slots(n: int, b: int, t, s):
    """The chase's task at wave t, slot s (integer numpy arrays broadcast
    together), as ``band_chase`` computes it on the device: (jj, kk, r, off,
    live), with jj = t//3 - s the sweep, kk = t%3 + 3s the hop, rows
    r .. r + b - 1 (r = jj + kk b + 1), the pivot at window column off
    (2b - 2 when kk = 0, else b - 1; the window's columns start at
    r - 2b + 1) and ``live`` the slot's membership of the wave
    (s < wave_width)."""
    t = np.asarray(t, dtype=np.int64)
    s = np.asarray(s, dtype=np.int64)
    jj = t // 3 - s
    kk = t % 3 + 3 * s
    r = jj + kk * b + 1
    off = np.where(kk == 0, 2 * b - 2, b - 1)
    live = s < wave_width(n, b, t)
    return jj, kk, r, off, live


def chase_waves(n: int, b: int) -> int:
    """Waves of the chase at (n, b) with a live slot: ``band_chase`` makes
    one grid sync after each (and one after packing the band)."""
    if n < 3 or b < 2:
        return 0
    _, _, Twaves = _wave_geometry(n, b)
    return int((wave_width(n, b, np.arange(Twaves)) > 0).sum())


def chase_grid_syncs(n: int, b: int) -> int:
    """Grid syncs of one ``band_chase`` launch at (n, b): one after packing
    the band and one after each wave with an item (a live slot, or the
    hop-0 reflector of sweep j = (t + 1) / 3 in a wave t = 3j - 1, sweep 0's
    in a wave before wave 0)."""
    if n < 3 or b < 2:
        return 0
    _, _, Twaves = _wave_geometry(n, b)
    t = np.arange(-1, Twaves)
    hop0 = ((t + 1) % 3 == 0) & ((t + 1) // 3 <= n - 3)
    live = np.concatenate(([0], wave_width(n, b, t[1:]))) > 0
    return 1 + int((live | hop0).sum())


def chase_tasks(n: int, b: int) -> int:
    """Tasks (sweep j, hop k) of the chase at (n, b): sum over the sweeps
    j = 0 .. n-3 of their (n - 3 - j) // b + 1 hops."""
    if n < 3 or b < 2:
        return 0
    j = np.arange(n - 2)
    return int(((n - 3 - j) // b + 1).sum())


def chase_launch_count(n: int, band: int) -> int:
    """``band_chase`` launches of ``band_to_tridiag_wave(B, band)`` at n:
    one (the whole chase), none where n < 3 or band < 2."""
    return 1 if n >= 3 and int(band) >= 2 else 0


def band_to_tridiag_wave(B, band: int, want_log: bool = True):
    """Banded symmetric B (n, n) -> (d, e, (Vw, tw)) by WAVEFRONT bulge
    chasing.

    Decomposition: task (j, k) applies ONE Householder reflector on rows
    [j+kb+1, j+(k+1)b], zeroing column (j for k=0, else j+(k-1)b+1) below the
    band edge; each task's triangular bulge is consumed column-by-column by
    the SUCCEEDING sweeps' same-hop tasks, so no task needs a triangular QR.
    Wave schedule t = 3j + k: concurrent tasks sit 3b-1 apart on the
    diagonal, with two-sided footprints (window cols [r-2b+1, r+3b-2])
    exactly disjoint; a wave's live slots are :func:`wave_slots`.

    Returns ``d (n,)``, ``e (n-1,)`` and the reflector log
    ``Vw (n-1, Kmax, b)`` / ``tw (n-1, Kmax)`` (row n-2 stays zero: the
    blocked backtransform reads it for sweeps past the last) consumed by
    :func:`apply_q2_wave`.  ``want_log=False`` skips the ~n^2 reflector
    store for eigenvalues-only callers (returns 1-row placeholders).

    CPU tensors run :func:`band_to_tridiag_wave_plain`; a CUDA tensor (f64)
    the ``band_chase`` kernel, one launch for the whole chase (or raises);
    other devices raise.
    """
    n = B.shape[0]
    b = int(band)
    if B.device.type == "cpu":
        return band_to_tridiag_wave_plain(B, b, want_log)
    if B.device.type != "cuda":
        raise ValueError(f"band_chase: unsupported device {B.device}")
    if n < 3 or b < 2:
        return _passthrough(B, n, b)
    return _launch_chase(B, b, want_log)


def _passthrough(B, n: int, b: int):
    """(d, e, log) where nothing is chased (n < 3 or b < 2)."""
    Kmax, _, _ = _wave_geometry(n, b)
    Vw = B.new_zeros((max(n - 1, 1), Kmax, max(b, 1)))
    tw = B.new_zeros((max(n - 1, 1), Kmax))
    return B.diagonal().clone(), B.diagonal(offset=1).clone(), (Vw, tw)


def band_to_tridiag_wave_plain(B, band: int, want_log: bool = True):
    """Plain version of ``band_chase``: the chase as a torch loop over the
    waves on a zero-padded copy of B (padded by 2b before and 3b after, so
    every window stays inside), one batched gather / reflector / indexed
    write of the windows and their mirrors per wave.  The same function as
    :func:`band_to_tridiag_wave`."""
    n = B.shape[0]
    b = int(band)
    dev = B.device
    Kmax, Wmax, Twaves = _wave_geometry(n, b)
    if n < 3 or b < 2:
        return _passthrough(B, n, b)

    OFF = 2 * b                       # live region offset in the padded array
    NP = n + 5 * b                    # every window stays inside
    W5 = 5 * b - 2
    P = B.new_zeros((NP, NP))
    P[OFF:OFF + n, OFF:OFF + n] = B
    nlog = n - 1 if want_log else 1
    Vw = B.new_zeros((nlog, Kmax, b))
    tw = B.new_zeros((nlog, Kmax))

    # the schedule's slots (Twaves, Wmax); wave t's live ones are a prefix
    jj_all, kk_all, r_all, off_all, _ = (
        torch.as_tensor(x, device=dev) for x in wave_slots(
            n, b, np.arange(Twaves)[:, None], np.arange(Wmax)[None, :]))
    rp_all = r_all + OFF
    rowr = torch.arange(b, device=dev)
    colr = torch.arange(W5, device=dev) - (2 * b - 1)

    for t in range(Twaves):
        W = wave_width(n, b, t)
        if W == 0:
            continue
        rp = rp_all[t, :W]
        off = off_all[t, :W, None, None].expand(W, b, 1)
        rows_idx = rp[:, None] + rowr                     # (W, b)
        cols_idx = rp[:, None] + colr                     # (W, W5)
        S = P[rows_idx[:, :, None], cols_idx[:, None, :]]  # (W, b, W5)

        x = torch.gather(S, 2, off)[..., 0]               # (W, b)
        x0 = x[:, 0]
        sigma2 = (x[:, 1:] * x[:, 1:]).sum(dim=1)
        nrm = torch.sqrt(x0 * x0 + sigma2)
        beta = torch.where(x0 >= 0, -nrm, nrm)        # sign avoids cancellation
        no_op = sigma2 == 0.0
        denom = torch.where(no_op, 1.0, x0 - beta)
        v = x / denom[:, None]
        v[:, 0] = ~no_op
        tau = torch.where(no_op, 0.0,
                          (beta - x0) / torch.where(no_op, 1.0, beta))
        beta_out = torch.where(no_op, x0, beta)

        # two-sided update of the strip:  S <- H S, then the (R, R) diagonal
        # block (local cols [2b-1, 3b-1)) gets the right application too
        w1 = tau[:, None] * torch.bmm(v[:, None, :], S)[:, 0]       # (W, W5)
        S.baddbmm_(v[:, :, None], w1[:, None, :], alpha=-1.0)
        D = S[:, :, 2 * b - 1: 3 * b - 1]
        w2 = tau[:, None] * torch.bmm(D, v[:, :, None])[..., 0]     # (W, b)
        D.baddbmm_(w2[:, :, None], v[:, None, :], alpha=-1.0)
        # exact-zero bookkeeping (the disjointness proof is structural)
        newcol = torch.zeros_like(x)
        newcol[:, 0] = beta_out
        S.scatter_(2, off, newcol[:, :, None])

        # in-wave windows are exactly disjoint; the mirror goes second, so
        # the (R, R) block ends as its transpose, as in the JAX package
        P[rows_idx[:, :, None], cols_idx[:, None, :]] = S
        P[cols_idx[:, :, None], rows_idx[:, None, :]] = S.transpose(1, 2)

        if want_log:
            Vw[jj_all[t, :W], kk_all[t, :W]] = v
            tw[jj_all[t, :W], kk_all[t, :W]] = tau
    d = P.diagonal()[OFF:OFF + n].clone()
    e = P.diagonal(offset=1)[OFF:OFF + n - 1].clone()
    return d, e, (Vw, tw)


def chase_slot_items(b: int, chunk: int, whole: bool):
    """The items of one slot of ``band_chase``, a block each, in their
    order within the slot: (kind, c0, c1) over the columns c of the slot's
    strip S (b x (4b - 2): the window without its diagonal block; c < 2b - 1
    the left strip, matrix column r - 2b + 1 + c, kept as column runs of
    the lower band; c >= 2b - 1 the right strip, matrix row r - b + 1 + c,
    kept as row runs): ``diag`` the diagonal block, ``left``, ``next`` and
    ``right`` chunks of ``chunk`` columns, the ``next`` ones over the right
    strip's first b columns (the next hop's pivot column: the last of them
    to finish forms its reflector), and ``task`` all of it in one item
    (``whole``)."""
    if whole:
        return [("task", 0, 4 * b - 2)]
    runs = (("left", 0, 2 * b - 1), ("next", 2 * b - 1, 3 * b - 1),
            ("right", 3 * b - 1, 4 * b - 2))
    return [("diag", 0, 0)] + [(kind, c, min(c + chunk, end))
                               for kind, start, end in runs
                               for c in range(start, end, chunk)]


def _chase_shared(b: int, chunk: int, whole: bool) -> Tuple[int, int]:
    """(bytes of a block's small vectors, doubles of its work tile) of
    ``band_chase`` (csrc/band_reduce.cu's layout): the block sums, the
    slot's v, the next pivot column x, the diagonal block's w, w1 over the
    tile's columns and the column-dot partials (a double a thread); the
    tile is the packed lower diagonal block beside the strip (b x (4b - 1))
    of a whole task, else the larger of the packed block and a b x
    (chunk + 1) strip."""
    cols = 4 * b - 2 if whole else max(chunk, b)
    small = 8 * (32 + 4 + 3 * b + cols + _CHASE_THREADS[0 if whole else 1])
    tri = b * (b + 1) // 2
    work = tri + b * (4 * b - 1) if whole else max(tri, b * (chunk + 1))
    return small, work


def chase_plan(n: int, b: int, sms: int, max_shared: int,
               resident: Callable[[bool, int], int]) -> ChasePlan:
    """``band_chase``'s launch at (n, b) on a card of ``sms`` SMs whose
    blocks may hold ``max_shared`` bytes of shared memory (``resident(whole,
    smem)``: the blocks an SM holds at ``smem``, from the occupancy API): to
    b = 32 a block of 256 threads a whole task (``whole``), its tile in
    shared memory; past it blocks of 512 threads a slot's items
    (:func:`chase_slot_items`), chunks of at most the widest power of two
    to min(64, b / 2) columns (each wave takes :func:`chase_wave_chunk`'s;
    a narrower chunk's tile is the packed diagonal block to within b / 2
    doubles, so it fits no better), the tile in a global scratch where not
    even the diagonal block fits (b > ~239 on an H100); the blocks an SM
    holds on every SM, and no more blocks than the widest wave has items at
    its narrowest chunk (one more: a wave's hop-0 reflector).  Raises when
    not one block an SM fits."""
    _, Wmax, _ = _wave_geometry(n, b)
    whole = b <= _CHASE_WHOLE_B
    chunk = b if whole else 1 << (min(64, b // 2).bit_length() - 1)
    small, work = _chase_shared(b, chunk, whole)
    smem, shared = small + 8 * work, True
    if not whole and (smem > max_shared or resident(whole, smem) < 1):
        smem, shared = small, False
    per_sm = resident(whole, smem)
    if smem > max_shared or per_sm < 1:
        raise ValueError(f"band_chase: no cooperative launch fits n={n}, "
                         f"b={b}")
    items = Wmax * len(chase_slot_items(b, min(_CHASE_CHUNK_MIN, chunk),
                                        whole)) + 1
    return ChasePlan(max(1, min(sms * per_sm, items)), smem, work, shared,
                     chunk, whole)


def chase_wave_chunk(b: int, plan: ChasePlan, width: int, hop0: bool) -> int:
    """The chunk ``band_chase`` takes in a wave of ``width`` slots (and a
    hop-0 reflector item when ``hop0``) under ``plan``, as it picks it on
    the device: the narrowest of 16, 32, .. (at most ``plan.chunk``) whose
    items fit in one round of the grid, else ``plan.chunk``;
    ``plan.chunk`` for a whole task a block."""
    if plan.whole:
        return plan.chunk
    c = _CHASE_CHUNK_MIN
    while True:
        chunk = min(c, plan.chunk)
        items = len(chase_slot_items(b, chunk, False))
        if chunk == plan.chunk or width * items + int(hop0) <= plan.grid:
            return chunk
        c *= 2


def _chase_occupancy(index: int, whole: bool, smem: int):
    """(blocks an SM holds, SMs, shared bytes a block may opt into) of
    ``band_chase``'s blocks (a whole task a block when ``whole``) on CUDA
    device ``index`` at ``smem`` dynamic shared bytes (cached)."""
    key = ("band_chase", index, whole, smem)
    got = _OCCUPANCY.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        fn = _build.function("band_reduce", "band_chase_occupancy",
                             _CHASE_OCCUPANCY_ARGTYPES)
        with torch.cuda.device(index):
            rc = fn(int(whole), smem, ctypes.addressof(out))
        _build.check_launch(rc, "band_chase_occupancy")
        got = _OCCUPANCY[key] = tuple(out)
    return got


def chase_device_plan(n: int, b: int, index: int) -> ChasePlan:
    """:func:`chase_plan` on CUDA device ``index``."""
    _, sms, optin = _chase_occupancy(index, True, 0)
    return chase_plan(n, b, sms, optin, lambda whole, smem:
                      _chase_occupancy(index, whole, smem)[0])


def _launch_chase(B, b: int, want_log: bool):
    global chase_launches
    n = B.shape[0]
    if B.dtype != torch.float64:
        raise TypeError(f"band_chase: B must be float64, got {B.dtype}")
    if B.ndim != 2 or B.shape[1] != n:
        raise ValueError(f"band_chase: B must be square, got "
                         f"{tuple(B.shape)}")
    if n > 2 ** 31 // (3 * b) or b > 2 ** 14:
        raise ValueError(f"band_chase: n={n}, b={b} past the kernel's "
                         "index range")
    if B.stride(1) != 1:
        B = B.contiguous()
    dev = B.device
    index = _device_index(dev)
    Kmax, Wmax, _ = _wave_geometry(n, b)
    f64 = dict(dtype=torch.float64, device=dev)
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        plan = chase_device_plan(n, b, index)
        Q = torch.zeros((n + 3 * b, 3 * b - 1), **f64)
        nlog = n - 1 if want_log else 1
        Vw = torch.zeros((nlog, Kmax, b), **f64)
        tw = torch.zeros((nlog, Kmax), **f64)
        d = torch.empty(n, **f64)
        e = torch.empty(n - 1, **f64)
        rs = torch.empty(2 * Wmax * (b + 1), **f64)
        xs = torch.empty(Wmax * b, **f64)
        arrived = torch.zeros(Wmax, dtype=torch.int32, device=dev)
        gwork = None
        if not plan.work_shared:
            gwork = torch.empty(plan.grid * plan.work, **f64)
        fn = _build.function("band_reduce", "band_chase_launch",
                             _CHASE_ARGTYPES)
        rc = fn(B.data_ptr(), B.stride(0), Q.data_ptr(),
                Vw.data_ptr() if want_log else None,
                tw.data_ptr() if want_log else None, d.data_ptr(),
                e.data_ptr(), rs.data_ptr(), xs.data_ptr(), arrived.data_ptr(),
                None if gwork is None else gwork.data_ptr(), plan.work,
                int(plan.work_shared), n, b, plan.chunk, int(plan.whole),
                plan.grid, plan.smem, stream)
    _build.check_launch(rc, "band_chase")
    chase_launches += 1
    return d, e, (Vw, tw)


def apply_q2_wave(n: int, band: int, vlog, X):
    """X <- Q2 @ X through the wavefront reflector log of
    :func:`band_to_tridiag_wave`, one sweep per step.

    Within a sweep the hops' row ranges [j+kb+1, j+(k+1)b] are disjoint, so a
    whole sweep applies as ONE batched rank-1 block update; sweeps apply in
    descending j (sweep-major order is a valid linearization of the task
    dependence order, hence yields the same Q2 product as wave order).
    Bandwidth-bound reference for :func:`apply_q2_wave_blocked`.
    """
    b = int(band)
    Vw, tw = vlog
    if n < 3 or b < 2:
        return X
    dev = X.device
    Xp = X.new_zeros((n + b, X.shape[1]))
    Xp[:n] = X
    rows0 = (torch.arange(_wave_geometry(n, b)[0], device=dev) * b + 1)[
        :, None] + torch.arange(b, device=dev)            # (Kmax, b), j = 0
    for j in range(n - 3, -1, -1):
        hops = (n - 3 - j) // b + 1                       # valid k: a prefix
        rows_idx = rows0[:hops] + j
        v = Vw[j, :hops]                                  # (hops, b)
        G = Xp[rows_idx]                                  # (hops, b, C)
        w = tw[j, :hops, None] * torch.bmm(v[:, None, :], G)[:, 0]
        Xp[rows_idx] = G.baddbmm_(v[:, :, None], w[:, None, :], alpha=-1.0)
    return Xp[:n].clone()


def apply_q2_wave_blocked_plain(n: int, band: int, vlog, X):
    """Plain version of :func:`apply_q2_wave_blocked`: the waves as a torch
    loop on a zero-padded copy of X, each wave planned on the host (numpy),
    its blocks' Y and T formed (T by the LAPACK identity T^{-1} = diag(1/tau)
    + striu(Y^T Y), 1/tau read as 1 where tau = 0, as in the JAX package),
    X's window rows gathered, three batched :func:`dword_matmul` products
    and a scatter back.  Returns a new tensor."""
    b = int(band)
    Vw, tw = vlog
    if n < 3 or b < 2:
        return X
    dev = X.device
    Kmax, _, _ = _wave_geometry(n, b)
    g = b
    h = b + g - 1
    nJ = -(-(n - 2) // g)                 # ceil: sweeps 0..n-3 in chunks of g
    Twaves = Kmax + 2 * nJ - 2

    Xp = X.new_zeros((n + 2 * h, X.shape[1]))
    Xp[:n] = X
    gr = torch.arange(g, device=dev)
    hr = torch.arange(h, device=dev)
    place_cols = gr[:, None] + torch.arange(b, device=dev)[None, :]  # (g, b)
    eye_g = torch.eye(g, dtype=X.dtype, device=dev)
    striu_mask = (gr[:, None] < gr[None, :]).to(X.dtype)

    for w in range(Twaves):
        # blocks of this wave: k = w - 2s, J = nJ-1-s, inside the log and
        # with at least their first reflector inside the matrix
        s_np = np.arange(max(0, (w - Kmax + 2) // 2), w // 2 + 1)
        J_np = nJ - 1 - s_np
        k_np = w - 2 * s_np
        keep = ((J_np >= 0) & (k_np >= 0) & (k_np <= Kmax - 1)
                & (J_np * g + k_np * b + 2 <= n - 1))
        if not keep.any():
            continue
        J = torch.as_tensor(J_np[keep], device=dev)
        k = torch.as_tensor(k_np[keep], device=dev)
        S = int(J.shape[0])
        base = J * g + k * b + 1
        jrows = torch.clamp(J[:, None] * g + gr[None, :], 0, n - 2)   # (S, g)
        Vblk = Vw[jrows, k[:, None]]                       # (S, g, b)
        tblk = tw[jrows, k[:, None]]                       # (S, g)

        Z = X.new_zeros((S, g, h))
        Z[:, gr[:, None], place_cols] = Vblk
        Y = Z.transpose(1, 2).contiguous()                 # (S, h, g)
        Sg = torch.bmm(Z, Y)
        nz = tblk != 0
        inv_tau = torch.where(nz, 1.0 / torch.where(nz, tblk, 1.0), 1.0)
        Tinv = Sg * striu_mask + eye_g * inv_tau[:, :, None]
        Tm = torch.linalg.solve_triangular(
            Tinv, eye_g.expand(S, g, g), upper=True)

        rows_idx = base[:, None] + hr[None, :]             # (S, h)
        G = Xp[rows_idx]                                   # (S, h, C)
        W2 = dword_matmul(Tm, dword_matmul(Z, G))          # (S, g, C)
        Xp[rows_idx] = dword_matmul_sub_(G, Y, W2)
    return Xp[:n].clone()


# --------------------------------------------------------------------------
# the blocked backtransform on the card: every block's T (q2_blocks_t), then
# one q2_apply launch a wave




class Q2Plan(NamedTuple):
    """``q2_apply``'s launch: tiles of ``tile`` columns a block of threads,
    ``smem`` dynamic shared bytes."""
    tile: int
    smem: int


class Q2Chunk(NamedTuple):
    """Waves ``w0`` .. ``w1`` - 1 of the blocked backtransform, whose blocks
    one ``q2_blocks_t`` launch makes: ``S`` slots a wave, wave w's live block
    s (:func:`q2_wave_range`) at slot (w - w0) S + s - s_lo."""
    w0: int
    w1: int
    S: int


_Q2_TILES = (256, 64, 32, 16, 8)   # the tile widths csrc/q2_apply.cu takes
_Q2_STORE_MIN = 1 << 26            # bytes a chunk's stores may always take


def q2_block_count(n: int, band: int) -> int:
    """Reflector blocks of the backtransform at (n, b): Kmax (Kmax + 1) / 2,
    block (J, k) live for k <= Kmax - 1 - J (g = b makes nJ = Kmax)."""
    b = int(band)
    if n < 3 or b < 2:
        return 0
    Kmax, _, _ = _wave_geometry(n, b)
    return Kmax * (Kmax + 1) // 2


def q2_wave_range(n: int, band: int, w):
    """(s_lo, s_hi) of wave w of the blocked backtransform in closed form, as
    ``q2_blocks_t`` computes them on the device: the live blocks are s = s_lo
    .. s_hi (none when s_lo > s_hi), J = nJ - 1 - s, k = w - 2s, where s_hi =
    min(w // 2, nJ - 1) and s_lo = max(0, ceil((w - Kmax + 1) / 2),
    ceil(((nJ - 1) g + w b - (n - 3)) / (g + 2b))) (J >= 0, 0 <= k <= Kmax -
    1 and J g + k b + 2 <= n - 1).  ``w`` an int or an integer numpy array;
    n >= 3, b >= 2."""
    b = int(band)
    g = b
    Kmax, _, _ = _wave_geometry(n, b)
    nJ = -(-(n - 2) // g)
    lo_k = -((Kmax - 1 - w) // 2)
    lo_row = -(((n - 3) - (nJ - 1) * g - w * b) // (g + 2 * b))
    if isinstance(w, int):            # the launch loop's: no numpy a wave
        return max(0, lo_k, lo_row), min(w // 2, nJ - 1)
    return (np.maximum(np.maximum(0, lo_k), lo_row),
            np.minimum(w // 2, nJ - 1))


def q2_wave_sizes(n: int, band: int):
    """Live blocks of every wave 0 .. 3 Kmax - 3 of the blocked
    backtransform (an int64 numpy array; empty where n < 3 or b < 2)."""
    b = int(band)
    if n < 3 or b < 2:
        return np.zeros(0, dtype=np.int64)
    Kmax, _, _ = _wave_geometry(n, b)
    s_lo, s_hi = q2_wave_range(n, b, np.arange(3 * Kmax - 2))
    return np.maximum(s_hi - s_lo + 1, 0)


def q2_wave_count(n: int, band: int) -> int:
    """Waves of the blocked backtransform with a live block: ``q2_apply``
    launches of one ``apply_q2_wave_blocked`` (none where n < 3 or b < 2)."""
    return int((q2_wave_sizes(n, band) > 0).sum())


def q2_store_budget(n: int) -> int:
    """Bytes one chunk's stores may take at order n: n^2 / 2 doubles (half
    of an n x n X), at least 64 MiB, whatever the band."""
    return max(4 * n * n, _Q2_STORE_MIN)


def _q2_slot_bytes(b: int, scratch: bool) -> int:
    """Bytes a slot of the stores takes at band b: T and Y^T zero-padded to
    rows of 16, and the b x b scratch when ``q2_blocks_t`` builds T in
    global memory (``scratch``)."""
    wr = (b + 15) & ~15
    return 8 * (wr * wr + wr * _q2_y_stride(b) + (b * b if scratch else 0))


def q2_chunks(n: int, band: int, slot_bytes: int, budget: int):
    """The backtransform's waves cut into :class:`Q2Chunk` s in order, each
    as many waves as keep (waves) x (its widest wave's blocks) x
    ``slot_bytes`` within ``budget`` (at least one wave, at most 65535),
    chunks without a live block left out.  The stores' peak is then the
    budget's, not the Kmax (Kmax + 1) / 2 blocks' (which grow as (16/b)^2
    n^2 / 2 doubles below b = 16)."""
    sizes = q2_wave_sizes(n, band).tolist()
    chunks, w0, S = [], 0, 0
    for w, size in enumerate(sizes):
        wide = max(S, size)
        if w > w0 and ((w + 1 - w0) * wide * slot_bytes > budget
                       or w - w0 == 65535):
            chunks.append(Q2Chunk(w0, w, S))
            w0, wide = w, size
        S = wide
    if sizes:
        chunks.append(Q2Chunk(w0, len(sizes), S))
    return [c for c in chunks if c.S > 0]


def q2_chunk_blocks(n: int, band: int, chunk: Q2Chunk, dev):
    """(slot, J, k) of the live blocks of ``chunk``, in slot order, as int64
    tensors on ``dev`` (numpy on the host: the plain versions' plan)."""
    b = int(band)
    Kmax, _, _ = _wave_geometry(n, b)
    w = np.arange(chunk.w0, chunk.w1)
    s_lo, s_hi = q2_wave_range(n, b, w)
    y, x = np.nonzero(np.arange(chunk.S)[None, :] <= (s_hi - s_lo)[:, None])
    s = s_lo[y] + x
    return tuple(torch.as_tensor(a, device=dev) for a in
                 (y * chunk.S + x, Kmax - 1 - s, w[y] - 2 * s))


def _q2_y(n: int, b: int, Vw, J, k):
    """Y (S, 2b - 1, b) of blocks (J, k): column i is Vw[min(J b + i, n - 2),
    k] at rows i .. i + b - 1; and the rows' sweeps (S, b)."""
    dev = Vw.device
    g = b
    gr = torch.arange(g, device=dev)
    sw = torch.clamp(J[:, None] * g + gr[None, :], max=n - 2)
    V = Vw[sw, k[:, None]]                                 # (S, g, b)
    Y = Vw.new_zeros((J.shape[0], 2 * b - 1, g))
    rows = gr[:, None] + torch.arange(b, device=dev)[None, :]      # (g, b)
    Y[:, rows, gr[:, None].expand(g, b)] = V
    return Y, sw


def _q2_y_stride(b: int) -> int:
    """Columns of a block's Y^T in the Y store (csrc/q2_apply.cu's
    y_stride): at least h + 3 (W1's contraction reads in steps of four rows
    past h = 2b - 1) and h rounded up to 16 (the update's row tiles), a
    multiple of 4."""
    h = 2 * b - 1
    return max((h + 6) & ~3, (h + 15) & ~15)


def _tile(M):
    """(S, R, C) -> the stores' layout (S, R/16, C/4, 16, 4): 16 x 4 tiles
    (the MMA A fragment's rows and one k-step), row-major inside and across
    (csrc/q2_apply.cu's ``tiled``); R a multiple of 16, C of 4."""
    S, R, C = M.shape
    return M.reshape(S, R // 16, 16, C // 4, 4).transpose(2, 3).contiguous()


def _untile(Mt):
    """The inverse of :func:`_tile`: (S, R/16, C/4, 16, 4) -> (S, R, C)."""
    S, P, Q, _, _ = Mt.shape
    return Mt.transpose(2, 3).reshape(S, 16 * P, 4 * Q)


class Q2Blocks(NamedTuple):
    """The reflector blocks of a :class:`Q2Chunk` of waves, slot by slot
    (:func:`q2_chunk_blocks`), each matrix zero-padded to rows of 16 and
    kept in 16 x 4 tiles (:func:`_tile`; :func:`_untile` gives the
    matrices): ``T`` its T factor (b rounded up to 16 square, zero past b);
    ``Y`` its Y^T (b rounded up to 16 x :func:`_q2_y_stride`), Y^T[i, r] =
    v_i[r - i] inside the band and zero elsewhere.  A slot past its wave's
    blocks is zero in the plain version and unwritten by the kernel."""
    T: torch.Tensor
    Y: torch.Tensor
    chunk: Q2Chunk


def q2_blocks_t_plain(n: int, band: int, Vw, tw, chunk: Q2Chunk) -> Q2Blocks:
    """Plain version of ``q2_blocks_t``: the T of every block of ``chunk`` by
    ``larft``'s recurrence T[c, c] = tau_c, T[:c, c] = -tau_c T[:c, :c]
    G[:c, c] over the blocks' Gram G = Y^T Y, batched over the blocks, and
    Y^T skewed.  An identity reflector (tau = 0, v = 0) gets T[i, i] = 0 (the
    inverse form of :func:`apply_q2_wave_blocked_plain` gives 1; I - Y T Y^T
    is the same)."""
    b = int(band)
    slot, J, k = q2_chunk_blocks(n, b, chunk, Vw.device)
    Y, sw = _q2_y(n, b, Vw, J, k)
    G = torch.bmm(Y.transpose(1, 2), Y)
    tau = tw[sw, k[:, None]]                               # (S, g)
    T = torch.diag_embed(tau)
    for c in range(1, b):
        T[:, :c, c] = -tau[:, c, None] * torch.bmm(
            T[:, :c, :c], G[:, :c, c, None])[..., 0]
    wr = (b + 15) & ~15
    slots = (chunk.w1 - chunk.w0) * chunk.S
    Ts = Vw.new_zeros((slots, wr, wr))
    Ts[slot, :b, :b] = T
    Ys = Vw.new_zeros((slots, wr, _q2_y_stride(b)))
    Ys[slot, :b, :2 * b - 1] = Y.transpose(1, 2)
    return Q2Blocks(_tile(Ts), _tile(Ys), chunk)


def q2_blocks_t(n: int, band: int, Vw, tw, chunk: Q2Chunk) -> Q2Blocks:
    """The T factor and skewed Y^T of every block of ``chunk`` (see
    :func:`q2_blocks_t_plain`) from the chase's log: CPU tensors run the
    plain version; CUDA tensors (f64, contiguous) launch ``q2_blocks_t``
    once (or raise); other devices raise."""
    b = int(band)
    if Vw.device.type == "cpu":
        return q2_blocks_t_plain(n, b, Vw, tw, chunk)
    if Vw.device.type != "cuda":
        raise ValueError(f"q2_blocks_t: unsupported device {Vw.device}")
    return _launch_q2_blocks_t(n, b, Vw, tw, chunk)


def _check_log(n: int, b: int, Vw, tw, what: str):
    Kmax, _, _ = _wave_geometry(n, b)
    if Vw.shape != (n - 1, Kmax, b) or tw.shape != (n - 1, Kmax):
        raise ValueError(f"{what}: log {tuple(Vw.shape)}, {tuple(tw.shape)} "
                         f"is not the chase's at n={n}, b={b}")
    if Vw.dtype != torch.float64 or tw.dtype != torch.float64:
        raise TypeError(f"{what}: the log must be float64")
    if not (Vw.is_contiguous() and tw.is_contiguous()):
        raise ValueError(f"{what}: the log must be contiguous")
    if b > 1024 or Kmax > 65535:
        raise ValueError(f"{what}: n={n}, b={b} past the kernel's range")


def _q2_t_staged(index: int, b: int) -> bool:
    """Whether ``q2_blocks_t`` keeps a block in shared memory at band b on
    CUDA device ``index`` (else it needs a global scratch; cached)."""
    key = ("q2_blocks_t", index, b)
    got = _OCCUPANCY.get(key)
    if got is None:
        out = ctypes.c_int(0)
        fn = _build.function("householder_panel", "q2_blocks_t_staged",
                             _Q2T_STAGED_ARGTYPES)
        with torch.cuda.device(index):
            rc = fn(b, ctypes.addressof(out))
        _build.check_launch(rc, "q2_blocks_t_staged")
        got = _OCCUPANCY[key] = bool(out.value)
    return got


def q2_device_chunks(n: int, band: int, index: int):
    """:func:`q2_chunks` as ``apply_q2_wave_blocked`` cuts them on CUDA
    device ``index`` (one ``q2_blocks_t`` launch each)."""
    b = int(band)
    return q2_chunks(n, b, _q2_slot_bytes(b, not _q2_t_staged(index, b)),
                     q2_store_budget(n))


def _launch_q2_blocks_t(n: int, b: int, Vw, tw, chunk: Q2Chunk):
    global q2_blocks_t_launches
    _check_log(n, b, Vw, tw, "q2_blocks_t")
    Kmax, _, _ = _wave_geometry(n, b)
    nw = chunk.w1 - chunk.w0
    if not (0 <= chunk.w0 and 1 <= nw <= 65535 and chunk.S >= 1
            and chunk.w1 <= 3 * Kmax - 2):
        raise ValueError(f"q2_blocks_t: chunk {chunk} outside the "
                         f"backtransform's waves at n={n}, b={b}")
    index = _device_index(Vw.device)
    slots = nw * chunk.S
    ys, wr = _q2_y_stride(b), (b + 15) & ~15
    f64 = dict(dtype=torch.float64, device=Vw.device)
    with torch.cuda.device(index):
        Ts = torch.empty((slots, wr // 16, wr // 4, 16, 4), **f64)
        Ys = torch.empty((slots, wr // 16, ys // 4, 16, 4), **f64)
        scratch = None
        if not _q2_t_staged(index, b):
            scratch = torch.empty((slots, b, b), **f64)
        stream = torch.cuda.current_stream(index).cuda_stream
        fn = _build.function("householder_panel", "q2_blocks_t_launch",
                             _Q2T_ARGTYPES)
        rc = fn(Vw.data_ptr(), tw.data_ptr(), Ts.data_ptr(), Ys.data_ptr(),
                None if scratch is None else scratch.data_ptr(), n, b, Kmax,
                ys, chunk.w0, nw, chunk.S, stream)
    _build.check_launch(rc, "q2_blocks_t")
    q2_blocks_t_launches += 1
    return Q2Blocks(Ts, Ys, chunk)


def _wave_slots(blocks: Q2Blocks, n: int, b: int, w: int):
    """(s_lo, live blocks, first slot) of wave w in ``blocks``."""
    chunk = blocks.chunk
    if not chunk.w0 <= w < chunk.w1:
        raise ValueError(f"q2_apply: wave {w} is not in {chunk}")
    s_lo, s_hi = q2_wave_range(n, b, w)
    return s_lo, s_hi - s_lo + 1, (w - chunk.w0) * chunk.S


def q2_apply_plain(X, blocks: Q2Blocks, n: int, band: int, w: int) -> None:
    """Plain version of ``q2_apply``: wave w of the blocked backtransform on
    X (n, C) in place, each live block (:func:`q2_wave_range`) G <- G - Y T
    Y^T G on its window rows base .. base + 2b - 2 (base = J b + k b + 1),
    rows past n read as zero and not written, T and Y from ``blocks``
    (:func:`q2_blocks_t` of a chunk holding wave w)."""
    b = int(band)
    s_lo, count, slot0 = _wave_slots(blocks, n, b, w)
    if count < 1:
        return
    dev = X.device
    Kmax, _, _ = _wave_geometry(n, b)
    s = torch.arange(s_lo, s_lo + count, device=dev)
    J, k = Kmax - 1 - s, w - 2 * s
    idx = slot0 + torch.arange(count, device=dev)
    T = _untile(blocks.T[idx])[:, :b, :b]
    Y = _untile(blocks.Y[idx])[:, :b, :2 * b - 1].transpose(1, 2)
    rows = (J * b + k * b + 1)[:, None] + torch.arange(2 * b - 1, device=dev)
    inside = rows < n
    G = torch.where(inside[..., None], X[rows.clamp(max=n - 1)], 0.0)
    G -= torch.bmm(Y, torch.bmm(T, torch.bmm(Y.transpose(1, 2), G)))
    X[rows[inside]] = G[inside]


def q2_apply_plan(band: int, optin: int,
                  resident: Callable[[int], int]) -> Q2Plan:
    """``q2_apply``'s tile at band b on a card whose blocks may opt into
    ``optin`` shared bytes (``resident(tile)``: the blocks of threads an SM
    holds at that tile, from the occupancy API): the widest tile of which
    an SM holds two (one block's copies then overlap the other's products),
    else the widest that fits.  Raises when none fits."""
    b = int(band)
    fits = [t for t in _Q2_TILES
            if _q2_tile_bytes(b, t) <= optin and resident(t) >= 1]
    if not fits:
        raise ValueError(f"q2_apply: no tile fits b={b}")
    two = [t for t in fits if resident(t) >= 2]
    t = (two or fits)[0]
    return Q2Plan(t, _q2_tile_bytes(b, t))


def _q2_tile_bytes(b: int, tile: int) -> int:
    """Shared bytes of a ``q2_apply`` block of threads (csrc/q2_apply.cu's
    tile_bytes): the window tile's 2b + 2 rows (2b - 1, padded for the
    contraction's steps of four) and W's b rows rounded up to 16, each of
    tile + 4 doubles."""
    rows = ((2 * b - 1 + 3) + 1) & ~1
    return 8 * (rows + ((b + 15) & ~15)) * (tile + 4)


def _q2_occupancy(index: int, b: int, tile: int):
    key = ("q2_apply", index, b, tile)
    got = _OCCUPANCY.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        fn = _build.function("q2_apply", "q2_apply_occupancy",
                             _Q2_OCCUPANCY_ARGTYPES)
        with torch.cuda.device(index):
            rc = fn(b, tile, ctypes.addressof(out))
        _build.check_launch(rc, "q2_apply_occupancy")
        got = _OCCUPANCY[key] = tuple(out)
    return got


def _q2_device_plan(index: int, b: int) -> Q2Plan:
    _, _, optin = _q2_occupancy(index, b, _Q2_TILES[-1])
    return q2_apply_plan(b, optin, lambda t: _q2_occupancy(index, b, t)[0])


def _launch_q2_apply(X, blocks: Q2Blocks, n: int, b: int, w: int,
                     plan: Q2Plan, stream) -> None:
    """One ``q2_apply`` launch for wave w, none when it has no live block."""
    global q2_apply_launches
    s_lo, count, slot0 = _wave_slots(blocks, n, b, w)
    if count < 1:
        return
    fn = _build.function("q2_apply", "q2_apply_launch", _Q2_ARGTYPES)
    rc = fn(X.data_ptr(), X.stride(0), blocks.Y.data_ptr(),
            blocks.T.data_ptr(), n, X.shape[1], b, w, s_lo, count, slot0,
            plan.tile, stream)
    _build.check_launch(rc, "q2_apply")
    q2_apply_launches += 1


def q2_apply(X, blocks: Q2Blocks, n: int, band: int, w: int) -> None:
    """Wave w of the blocked backtransform on X (n, C) in place (see
    :func:`q2_apply_plain`): CPU tensors run the plain version; CUDA
    tensors (f64, X with a unit column stride) launch ``q2_apply`` once
    when the wave has a live block (or raise); other devices raise."""
    b = int(band)
    if X.device.type == "cpu":
        q2_apply_plain(X, blocks, n, b, w)
        return
    if X.device.type != "cuda":
        raise ValueError(f"q2_apply: unsupported device {X.device}")
    _launch_q2_wave(X, blocks, n, b, w)


def _launch_q2_wave(X, blocks: Q2Blocks, n: int, b: int, w: int) -> None:
    _check_apply(X, blocks, n, b)
    index = _device_index(X.device)
    with torch.cuda.device(index):
        _launch_q2_apply(X, blocks, n, b, w, _q2_device_plan(index, b),
                         torch.cuda.current_stream(index).cuda_stream)


def _check_x(X, n: int) -> None:
    if X.dtype != torch.float64:
        raise TypeError(f"q2_apply: X must be float64, got {X.dtype}")
    if X.ndim != 2 or X.shape[0] != n or X.stride(1) != 1:
        raise ValueError(f"q2_apply: X {tuple(X.shape)} must be (n={n}, C) "
                         "with a unit column stride")


def _check_apply(X, blocks: Q2Blocks, n: int, b: int) -> None:
    _check_x(X, n)
    Ts, Ys, chunk = blocks
    slots, wr = (chunk.w1 - chunk.w0) * chunk.S, (b + 15) & ~15
    if Ts.dtype != torch.float64 or Ys.dtype != torch.float64:
        raise TypeError("q2_apply: the block stores must be float64")
    if Ts.shape != (slots, wr // 16, wr // 4, 16, 4) or Ys.shape != (
            slots, wr // 16, _q2_y_stride(b) // 4, 16, 4) \
            or not (Ts.is_contiguous() and Ys.is_contiguous()):
        raise ValueError(f"q2_apply: block stores {tuple(Ts.shape)}, "
                         f"{tuple(Ys.shape)} are not q2_blocks_t's of "
                         f"{chunk} at n={n}, b={b}")
    if not (X.device == Ts.device == Ys.device):
        raise ValueError("q2_apply: tensors must be on one device")


def apply_q2_wave_blocked(n: int, band: int, vlog, X, overwrite: bool = False):
    """X <- Q2 @ X at GEMM rate: compact-WY blocks over the wavefront log.

    g = b consecutive sweeps' SAME-HOP reflectors, which live in a
    (2b-1)-row window shifted one row per sweep, form one compact-WY block
    B(J, k) = I - Y T Y^T (Y: (2b-1, b), T upper triangular).

    Valid reordering: blocks commute unless |window offset| < 2b-1; ordering
    Q2 = prod_{J asc} prod_{k desc} B(J, k) only swaps disjoint-window
    factors of the sweep-major product.  Application is the reverse (J desc,
    k asc) scheduled as a wavefront wave(J, k) = k + 2*(nJ-1-J): concurrent
    blocks sit exactly 3b rows apart (disjoint), and every conflicting pair
    lands on earlier waves.  Blocks whose first reflector already lies
    outside the matrix are identities and are left out.

    CPU tensors run :func:`apply_q2_wave_blocked_plain`.  A CUDA tensor
    (f64, unit column stride) makes, for each chunk of waves
    (:func:`q2_device_chunks`: the stores stay within
    :func:`q2_store_budget`), one ``q2_blocks_t`` launch (the chunk's T and
    Y^T) and one ``q2_apply`` launch a wave with a live block, X's rows
    read and written where they lie, no host sync (or raises).  Other
    devices raise.  Returns Q2 @ X: a new tensor, or X itself, updated in
    place, with ``overwrite=True``.
    """
    b = int(band)
    if n < 3 or b < 2:
        return X
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"q2_apply: unsupported device {X.device}")
    if not overwrite:
        X = X.clone(memory_format=torch.contiguous_format)
    if X.device.type == "cpu":
        return X.copy_(apply_q2_wave_blocked_plain(n, b, vlog, X))
    _launch_q2_wave_blocked(n, b, vlog, X)
    return X


def _launch_q2_wave_blocked(n: int, b: int, vlog, X) -> None:
    Vw, tw = vlog
    _check_x(X, n)
    _check_log(n, b, Vw, tw, "q2_apply")
    if X.shape[1] == 0:
        return
    index = _device_index(X.device)
    with torch.cuda.device(index):
        plan = _q2_device_plan(index, b)
        stream = torch.cuda.current_stream(index).cuda_stream
        for chunk in q2_device_chunks(n, b, index):
            blocks = _launch_q2_blocks_t(n, b, Vw, tw, chunk)
            _check_apply(X, blocks, n, b)
            for w in range(chunk.w0, chunk.w1):
                _launch_q2_apply(X, blocks, n, b, w, plan, stream)
            del blocks        # the next chunk's stores reuse its memory
