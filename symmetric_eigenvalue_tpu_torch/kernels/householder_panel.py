"""The dense reduction's column step and the compact-WY T factor: CUDA
kernels + plain versions.

Counterparts of two device loops of the JAX package that hold no
``pallas_call``: ``symmetric_eigenvalue_tpu/kernels/tridiagonalize.py``'s
column body ``col_body`` (:114, run by the ``lax.fori_loop``s at :139 and
:146) and ``_larft``'s loop (:227).  CUDA tensors launch
``csrc/householder_panel.cu``:

- the column step (:func:`column_steps`), a panel at a time in the order of
  :func:`panel_launches`: ``column_reflector`` (the delayed row, the
  Householder vector, tau, alpha and the small products p = Wp v,
  q = Vp v) for the panel's first column, then a column at a time the
  unchanged ``dword_vecmat`` matvec and ``column_w_reflector`` (the column's
  W row, with the half-step from v.(A v) = y.v - 2 p.q, then the next
  column's reflector), and ``column_w`` (the W row alone) for the last:
  two launches a column, no host read.  The three are one cooperative
  kernel with a half switched off, its grid over every SM
  (:func:`column_plan`);
- ``larft``: T from the panel's Gram and its taus, one launch a panel.

CPU tensors run the plain versions, which are the loop the port ran before
the kernels (:func:`column_reflector_plain`, :func:`column_w_plain`,
:func:`larft_plain`): the column step's plain half-step is ``dot(w, v)``
after w, the JAX package's order.  Any other device raises.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from .. import _build
from . import dword_matvec as dv

reflector_launches = 0
"""``column_reflector`` kernel launches so far (the CPU path never counts)."""
w_launches = 0
"""``column_w`` kernel launches so far."""
w_reflector_launches = 0
"""``column_w_reflector`` kernel launches so far."""
larft_launches = 0
"""``larft`` kernel launches so far."""

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# column_reflector_launch, column_w_launch, column_w_reflector_launch
_STEP_ARGTYPES = [_P, _LL, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _I, _P]
_OCCUPANCY_ARGTYPES = [_I, _P]
_PROBE_ARGTYPES = [_I, _I, _P]
_LARFT_ARGTYPES = [_P, _P, _P, _P, _I, _P]
_SHARED_ARGTYPES = [_I]
_THREADS = 128              # kThreads of the column step
_WARPS = _THREADS // 32
_SCALARS = 4                # kScalars
_RESERVED = 1024            # shared bytes the card keeps for each block
MAX_PANEL = 1024            # kMaxPanel: the panel width the column step takes
_INT_MAX = 2 ** 31 - 1
_SCRATCH = {}               # (device index, stream) -> (ws, pq)
_OCCUPANCY = {}             # (device index, shared bytes) -> (blocks, SMs, opt-in)


class ColumnPlan(NamedTuple):
    """The column step's cooperative launch over a bucket: ``grid`` blocks
    (every SM takes part), each owning ``slice`` entries of the row and
    caching up to ``cached`` panel rows of its slice in ``smem`` bytes of
    shared memory."""
    grid: int
    slice: int
    cached: int
    smem: int


def _householder(x, j: int, out=None):
    """Householder vector zeroing x[j+2:], pivot at j+1; entries <= j are 0.

    Returns (v (n,), tau, alpha) with H = I - tau v v^T, H x = (..., alpha,
    0...), v normalized so v[j+1] = 1 (LAPACK convention).  ``out``: a
    zero-filled (n,) tensor that receives v.  tau and alpha are 0-dim
    tensors; nothing is read back to the host.
    """
    v = torch.zeros_like(x) if out is None else out
    pivot = x[j + 1]
    below = x[j + 2:]
    sigma2 = torch.dot(below, below)
    norm = torch.sqrt(torch.addcmul(sigma2, pivot, pivot))
    alpha = torch.where(pivot >= 0, -norm, norm)   # sign avoids cancellation
    no_op = sigma2 == 0.0        # already tridiagonal in this column
    denom_safe = torch.where(no_op, 1.0, pivot - alpha)
    torch.div(below, denom_safe, out=v[j + 2:])
    v[j + 1].copy_(~no_op)
    tau = torch.where(no_op, 0.0, (alpha - pivot) / alpha)
    alpha = torch.where(no_op, pivot, alpha)
    return v, tau, alpha


# --------------------------------------------------------------------------
# plain versions


def column_reflector_plain(As, Vp, Wp, te, j: int, jj: int):
    """Plain version of ``column_reflector`` at local column j of the bucket
    ``As`` (m, m), panel row jj = j - o: the delayed row
    a = (As - Vp^T Wp - Wp^T Vp)[j, :] over the panel's rows < jj, then the
    Householder vector into Vp[jj] and (tau, alpha) into te[j].  At j = m-2
    (nothing below the pivot) the identity reflector: te[j, 1] = a[j+1],
    Wp[jj] zeroed, v and tau left zero; returns None there, else v."""
    m = As.shape[0]
    # delayed update of column j (= row j: As and its updates stay
    # symmetric)
    a = As[j]
    if jj:
        a = torch.addmv(a, Vp[:jj].T, Wp[:jj, j], alpha=-1.0)
        a.addmv_(Wp[:jj].T, Vp[:jj, j], alpha=-1.0)
    if j == m - 2:
        # nothing lies below the pivot: no matvec either; the W row may
        # hold an earlier panel's
        te[j, 1] = a[j + 1]
        Wp[jj].zero_()
        return None
    v, tau, alpha = _householder(a, j, out=Vp[jj])
    torch.stack((tau, alpha), out=te[j])
    return v


def column_w_plain(Vp, Wp, te, y, j: int, jj: int):
    """Plain version of ``column_w``: Wp[jj] = w - (0.5 tau w.v) v with
    w = tau (y - Vp[:jj]^T (Wp[:jj] v) - Wp[:jj]^T (Vp[:jj] v)), v = Vp[jj],
    tau = te[j, 0], y = v[j+1:] @ As[j+1:] (the matvec).  The half-step is
    dot(w, v) after w, as in the JAX package; y is overwritten."""
    v = Vp[jj]
    tau = te[j, 0]
    # w = tau * (A_updated v), delayed; As v = v As (symmetry), and v is
    # zero above the pivot, so the matvec streamed only rows j+1..
    Av = y
    if jj:
        Av.addmv_(Vp[:jj].T, Wp[:jj] @ v, alpha=-1.0)
        Av.addmv_(Wp[:jj].T, Vp[:jj] @ v, alpha=-1.0)
    w = Av.mul_(tau)
    half = torch.dot(w, v).mul_(tau).mul_(0.5)
    torch.addcmul(w, half, v, value=-1.0, out=Wp[jj])


def larft_plain(G, tau):
    """Plain version of ``larft``: T (nb, nb) upper triangular with
    T[k, k] = tau_k and T[:k, k] = -tau_k T[:k, :k] G[:k, k]."""
    nb = G.shape[0]
    T = torch.diag(tau)
    ntau = -tau
    for k in range(1, nb):
        torch.mul(torch.mv(T[:k, :k], G[:k, k]), ntau[k], out=T[:k, k])
    return T


# --------------------------------------------------------------------------
# the column step


def panel_launches(m: int, o: int, cnt: int) -> List[Tuple[str, int]]:
    """The column step's launches over the panel of ``cnt`` columns at local
    column o of a bucket of width m, in order, as (kernel, column j): the
    first column's reflector alone, then for each column the matvec and
    either the fused W row of j and reflector of j + 1 or, at the panel's
    last column, the W row alone.  The identity column j = m - 2 (the last
    bucket's last column) has its reflector (fused into the step before it,
    or alone when it opens a panel) and no matvec or W row."""
    out = [("column_reflector", o)]
    for j in range(o, o + cnt):
        if j == m - 2:
            break
        out.append(("dword_vecmat", j))
        out.append(("column_w_reflector", j) if j + 1 < o + cnt
                   else ("column_w", j))
    return out


def column_launches(n: int, panel: int = 32, buckets: int = 1) -> Dict[str, int]:
    """Launches of each kernel in the column steps of ``tridiagonalize(A,
    panel, buckets)`` at n: the reflector half runs n - 1 times
    (``column_reflector`` + ``column_w_reflector``), the W half and the
    matvec n - 2 times (``column_w`` + ``column_w_reflector``)."""
    from .tridiagonalize import _bucket_cuts   # it imports this module
    counts = dict.fromkeys(("column_reflector", "column_w_reflector",
                            "column_w", "dword_vecmat"), 0)
    if n < 2:
        return counts
    nb = max(1, min(panel, n))
    cuts = _bucket_cuts(n, nb, buckets)
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        for o in range(0, c1 - c0, nb):
            for kind, _ in panel_launches(n - c0, o, min(nb, c1 - c0 - o)):
                counts[kind] += 1
    return counts


def column_plan(m: int, nb: int, sms: int, max_shared: int,
                resident: Callable[[int], int]) -> ColumnPlan:
    """The column step's launch at bucket width m and panel width nb on a
    card of ``sms`` SMs whose blocks may hold ``max_shared`` bytes of shared
    memory (``resident(smem)``: the blocks an SM holds, from the occupancy
    API on the card).  Blocks an SM: as many as one entry a thread needs,
    fewer where they would not be co-resident, at least one (every SM takes
    part); each block caches as many panel rows of its slice as its share of
    the SM's shared memory holds (up to nb - 1, the rest read from L2).
    Raises when not one block an SM fits."""
    want = max(1, -(-(-(-m // _THREADS)) // sms))
    for per_sm in range(want, 0, -1):
        grid = sms * per_sm
        width = -(-m // grid)
        fixed = 8 * (4 * nb + _SCALARS + _WARPS + 3 * width)
        room = max_shared // per_sm - _RESERVED - fixed
        if room < 0:
            continue
        cached = min(nb - 1, room // (16 * width))
        smem = fixed + 16 * cached * width
        if resident(smem) >= per_sm:
            return ColumnPlan(grid, width, cached, smem)
    raise ValueError(f"column step: no cooperative launch fits m={m}, "
                     f"nb={nb}")


def _occupancy(index: int, smem: int) -> Tuple[int, int, int]:
    """(blocks an SM holds, SMs, shared bytes a block may opt into) of the
    column step's kernel on CUDA device ``index`` at ``smem`` (cached)."""
    key = (index, smem)
    got = _OCCUPANCY.get(key)
    if got is None:
        out = (ctypes.c_int * 3)()
        fn = _build.function("householder_panel", "column_step_occupancy",
                             _OCCUPANCY_ARGTYPES)
        with torch.cuda.device(index):
            rc = fn(smem, ctypes.addressof(out))
        _build.check_launch(rc, "column_step_occupancy")
        got = _OCCUPANCY[key] = tuple(out)
    return got


class _PlainSteps:
    """The column step on CPU tensors: the plain versions and the plain
    matvec, a column at a time."""

    def __init__(self, As, Vtb, Wbuf, te):
        self.As, self.Vtb, self.Wbuf, self.te = As, Vtb, Wbuf, te

    def context(self):
        return contextlib.nullcontext()

    def panel(self, o: int, cnt: int) -> None:
        for j in range(o, o + cnt):
            self(j, o)

    def __call__(self, j: int, o: int) -> None:
        jj = j - o
        Vp = self.Vtb[o:]
        v = column_reflector_plain(self.As, Vp, self.Wbuf, self.te, j, jj)
        if v is None:
            return
        y = dv.dword_vecmat(v[j + 1:], self.As[j + 1:])
        column_w_plain(Vp, self.Wbuf, self.te, y, j, jj)


def _scratch(index: int, stream: int, grid: int, nb: int):
    """The partials' workspace and the (p, q) buffer of one device and
    stream, grown as needed."""
    ws, pq = _SCRATCH.get((index, stream), (None, None))
    dev = torch.device("cuda", index)
    if ws is None or ws.numel() < grid * (2 * nb + 2) + 2:
        ws = torch.empty(grid * (2 * nb + 2) + 2, dtype=torch.float64,
                         device=dev)
    if pq is None or pq.numel() < 2 * nb:
        pq = torch.empty(2 * nb, dtype=torch.float64, device=dev)
    _SCRATCH[(index, stream)] = (ws, pq)
    return ws, pq


class _CudaSteps:
    """The column step on a CUDA bucket: plan, handles, stream, pointers and
    the constant arguments resolved once; each panel then makes the launches
    of :func:`panel_launches` (two a column) and reads nothing back."""

    def __init__(self, As, Vtb, Wbuf, te, nb: int):
        m = As.shape[0]
        if nb > MAX_PANEL:
            raise ValueError(f"column step: panel {nb} exceeds the kernel's "
                             f"{MAX_PANEL}")
        if m > _INT_MAX // 2 or As.stride(1) != 1:
            raise ValueError("column step: the bucket needs a unit column "
                             "stride and fewer than 2^30 columns")
        for name, t in (("Vtb", Vtb), ("Wbuf", Wbuf), ("te", te)):
            if not t.is_contiguous():
                raise ValueError(f"column step: {name} must be contiguous")
        if Vtb.shape[1] != m or Wbuf.shape[1] != m or Wbuf.shape[0] < nb:
            raise ValueError("column step: Vtb, Wbuf must be (*, m), Wbuf "
                             "at least nb rows")
        dev = As.device
        self.index = (dev.index if dev.index is not None
                      else torch.cuda.current_device())
        self.m = m
        self.As, self.Vtb, self.Wbuf, self.te = As, Vtb, Wbuf, te
        self.stream = torch.cuda.current_stream(self.index).cuda_stream
        _, sms, optin = _occupancy(self.index, 0)
        self.plan = column_plan(m, nb, sms, optin,
                                lambda smem: _occupancy(self.index, smem)[0])
        ws, pq = _scratch(self.index, self.stream, self.plan.grid, nb)
        self.y = torch.empty(m, dtype=torch.float64, device=dev)
        self.fns = {kind: _build.function("householder_panel",
                                          f"{kind}_launch", _STEP_ARGTYPES)
                    for kind in ("column_reflector", "column_w",
                                 "column_w_reflector")}
        self.v_ptr = Vtb.data_ptr()
        self.head = (As.data_ptr(), As.stride(0))
        self.mid = (Wbuf.data_ptr(), m, self.y.data_ptr(), te.data_ptr(),
                    pq.data_ptr(), ws.data_ptr(), m)
        self.tail = (*self.plan, self.stream)
        self.ws, self.pq = ws, pq

    def context(self):
        return torch.cuda.device(self.index)

    def _step(self, kind: str, j: int, o: int) -> None:
        rc = self.fns[kind](*self.head, self.v_ptr + 8 * o * self.m,
                            *self.mid, j, j - o, *self.tail)
        _build.check_launch(rc, kind)

    # one method a kernel of panel_launches, by its name (no table of bound
    # methods: that would keep the bucket alive in a reference cycle)

    def column_reflector(self, j: int, o: int) -> None:
        """The reflector of column j of the panel at o, alone (the current
        device must be the bucket's)."""
        global reflector_launches
        self._step("column_reflector", j, o)
        reflector_launches += 1

    def dword_vecmat(self, j: int, o: int) -> None:
        """y = v[j+1:] @ As[j+1:] by dword_vecmat."""
        m = self.m
        dv.launch_raw(self.v_ptr + 8 * (j * m + j + 1),
                      self.head[0] + 8 * (j + 1) * self.head[1],
                      self.mid[2], m - j - 1, m, self.head[1], self.index,
                      self.stream)

    def column_w(self, j: int, o: int) -> None:
        """The W row of column j, alone."""
        global w_launches
        self._step("column_w", j, o)
        w_launches += 1

    def column_w_reflector(self, j: int, o: int) -> None:
        """The W row of column j, then the reflector of column j + 1."""
        global w_reflector_launches
        self._step("column_w_reflector", j, o)
        w_reflector_launches += 1

    def panel(self, o: int, cnt: int) -> None:
        for kind, j in panel_launches(self.m, o, cnt):
            getattr(self, kind)(j, o)


def column_steps(As, Vtb, Wbuf, te, nb: int):
    """The column step of one bucket of ``_tridiagonalize_block``: an object
    whose ``panel(o, cnt)`` reduces the cnt columns of the panel at local
    column o, writing Vtb[j] (v), te[j] (tau, alpha) and Wbuf[j - o] (the W
    row) for each, and whose ``context()`` the loop runs under.  As (m, m)
    f64 with unit column stride (any row stride), Vtb (ncols, m), Wbuf
    (>= nb, m) and te (ncols, 2) contiguous, on one device.  CPU tensors
    take the plain loop; CUDA tensors the kernels (or raise); other devices
    raise."""
    tensors = (As, Vtb, Wbuf, te)
    if any(t.dtype != torch.float64 for t in tensors):
        raise TypeError("column step: As, Vtb, Wbuf, te must be float64")
    if any(t.device != As.device for t in tensors):
        raise ValueError("column step: tensors must be on one device")
    if As.device.type == "cpu":
        return _PlainSteps(As, Vtb, Wbuf, te)
    if As.device.type != "cuda":
        raise ValueError(f"column step: unsupported device {As.device}")
    return _CudaSteps(As, Vtb, Wbuf, te, nb)


def grid_sync_probe(grid: int, syncs: int) -> None:
    """A cooperative launch of ``grid`` blocks that makes ``syncs`` grid
    syncs and nothing else, on the current CUDA device and stream: the
    yardstick of a grid sync's cost (never on the reduction's path)."""
    fn = _build.function("householder_panel", "grid_sync_probe_launch",
                         _PROBE_ARGTYPES)
    rc = fn(grid, syncs, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(rc, "grid_sync_probe")


# --------------------------------------------------------------------------
# larft


def larft(G, tau):
    """T (nb, nb) of the compact-WY form Q = I - V T V^T of one panel, from
    its Gram G = V V^T (nb, nb) and its taus (nb,), f64.  CPU tensors use
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if G.ndim != 2 or G.shape[0] != G.shape[1] or tau.shape != G.shape[:1]:
        raise ValueError(f"larft: G {tuple(G.shape)}, tau {tuple(tau.shape)}")
    if G.dtype != torch.float64 or tau.dtype != torch.float64:
        raise TypeError(f"larft: G, tau must be float64, got {G.dtype}, "
                        f"{tau.dtype}")
    if G.device != tau.device:
        raise ValueError("larft: G and tau must be on one device")
    if G.device.type == "cpu":
        return larft_plain(G, tau)
    return _launch_larft(G, tau)


def _launch_larft(G, tau):
    global larft_launches
    dev = G.device
    if dev.type != "cuda":
        raise ValueError(f"larft: unsupported device {dev}")
    nb = G.shape[0]
    T = torch.empty((nb, nb), dtype=torch.float64, device=dev)
    if nb == 0:
        return T
    if nb > 46340:
        raise ValueError(f"larft: nb {nb} exceeds the kernel's index range")
    G = G.contiguous()
    tau = tau.contiguous()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream(index).cuda_stream
        shared = _build.function("householder_panel", "larft_shared_bytes",
                                 _SHARED_ARGTYPES)
        scratch = None
        if shared(nb) == 0:
            scratch = torch.empty(nb + nb * (nb + 1) // 2,
                                  dtype=torch.float64, device=dev)
        fn = _build.function("householder_panel", "larft_launch",
                             _LARFT_ARGTYPES)
        rc = fn(G.data_ptr(), tau.data_ptr(), T.data_ptr(),
                None if scratch is None else scratch.data_ptr(), nb, stream)
    _build.check_launch(rc, "larft")
    larft_launches += 1
    return T
