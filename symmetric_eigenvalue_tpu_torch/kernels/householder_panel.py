"""The dense reduction's column step and the compact-WY T factor: CUDA
kernels + plain versions.

Counterparts of two device loops of the JAX package that hold no
``pallas_call``: ``symmetric_eigenvalue_tpu/kernels/tridiagonalize.py``'s
column body ``col_body`` (:114, run by the ``lax.fori_loop``s at :139 and
:146) and ``_larft``'s loop (:227).  CUDA tensors launch
``csrc/householder_panel.cu``:

- the column step (:func:`column_steps`): ``column_reflector`` (the delayed
  row, the Householder vector, tau, alpha and the small products p = Wp v,
  q = Vp v), the unchanged ``dword_vecmat`` matvec, and ``column_w`` (the W
  row, with the half-step from v.(A v) = y.v - 2 p.q): three launches a
  column, no host read;
- ``larft``: T from the panel's Gram and its taus, one launch a panel.

CPU tensors run the plain versions, which are the loop the port ran before
the kernels (:func:`column_reflector_plain`, :func:`column_w_plain`,
:func:`larft_plain`): the column step's plain half-step is ``dot(w, v)``
after w, the JAX package's order.  Any other device raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import _build
from . import dword_matvec as dv

reflector_launches = 0
"""``column_reflector`` kernel launches so far (the CPU path never counts)."""
w_launches = 0
"""``column_w`` kernel launches so far."""
larft_launches = 0
"""``larft`` kernel launches so far."""

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_REFLECTOR_ARGTYPES = [_P, _LL, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                       _P]
_W_ARGTYPES = [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P]
_LARFT_ARGTYPES = [_P, _P, _P, _P, _I, _P]
_SHARED_ARGTYPES = [_I]
_THREADS = 256              # kThreads of the column kernels
MAX_PANEL = 1024            # kMaxPanel: the panel width the column step takes
_INT_MAX = 2 ** 31 - 1
_SCRATCH = {}               # (device index, stream) -> (ws, counter, pq)


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


class _PlainSteps:
    """The column step on CPU tensors: the plain versions and the plain
    matvec."""

    def __init__(self, As, Vtb, Wbuf, te):
        self.As, self.Vtb, self.Wbuf, self.te = As, Vtb, Wbuf, te

    def context(self):
        return contextlib.nullcontext()

    def __call__(self, j: int, o: int) -> None:
        jj = j - o
        Vp = self.Vtb[o:]
        v = column_reflector_plain(self.As, Vp, self.Wbuf, self.te, j, jj)
        if v is None:
            return
        y = dv.dword_vecmat(v[j + 1:], self.As[j + 1:])
        column_w_plain(Vp, self.Wbuf, self.te, y, j, jj)


def _scratch(index: int, stream: int, m: int, nb: int):
    """Partials' workspace, arrival counter and the (p, q) buffer of one
    device and stream, grown as needed; the counter is zeroed once, when
    made, and every launch leaves it zeroed."""
    ws, counter, pq = _SCRATCH.get((index, stream), (None, None, None))
    blocks = -(-m // _THREADS)
    dev = torch.device("cuda", index)
    if ws is None or ws.numel() < blocks * (2 * nb + 1):
        ws = torch.empty(blocks * (2 * nb + 1), dtype=torch.float64,
                         device=dev)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    if pq is None or pq.numel() < 2 * nb:
        pq = torch.empty(2 * nb, dtype=torch.float64, device=dev)
    _SCRATCH[(index, stream)] = (ws, counter, pq)
    return ws, counter, pq


class _CudaSteps:
    """The column step on a CUDA bucket: handles, stream, pointers and the
    constant arguments resolved once; each column then makes three launches
    (one at the identity column) and reads nothing back."""

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
        ws, counter, pq = _scratch(self.index, self.stream, m, nb)
        self.y = torch.empty(m, dtype=torch.float64, device=dev)
        self.k1 = _build.function("householder_panel",
                                  "column_reflector_launch",
                                  _REFLECTOR_ARGTYPES)
        self.k3 = _build.function("householder_panel", "column_w_launch",
                                  _W_ARGTYPES)
        self.as_ptr, self.lda = As.data_ptr(), As.stride(0)
        self.v_ptr, self.w_ptr = Vtb.data_ptr(), Wbuf.data_ptr()
        self.te_ptr, self.y_ptr = te.data_ptr(), self.y.data_ptr()
        self.scratch = (pq.data_ptr(), ws.data_ptr(), counter.data_ptr())
        self.keep = (ws, counter, pq)

    def context(self):
        return torch.cuda.device(self.index)

    def reflector(self, j: int, o: int) -> None:
        """K1 at column j of the panel at o (the current device must be the
        bucket's)."""
        global reflector_launches
        m = self.m
        rc = self.k1(self.as_ptr, self.lda, self.v_ptr + 8 * o * m,
                     self.w_ptr, m, self.te_ptr + 16 * j, *self.scratch,
                     m, j, j - o, int(j == m - 2), self.stream)
        _build.check_launch(rc, "column_reflector")
        reflector_launches += 1

    def matvec(self, j: int, o: int) -> None:
        """K2: y = v[j+1:] @ As[j+1:] by dword_vecmat."""
        m = self.m
        dv.launch_raw(self.v_ptr + 8 * (j * m + j + 1),
                      self.as_ptr + 8 * (j + 1) * self.lda, self.y_ptr,
                      m - j - 1, m, self.lda, self.index, self.stream)

    def w(self, j: int, o: int) -> None:
        """K3: the W row of column j."""
        global w_launches
        m = self.m
        pq, ws, counter = self.scratch
        rc = self.k3(self.y_ptr, self.v_ptr + 8 * o * m, self.w_ptr, m,
                     self.te_ptr + 16 * j, pq, ws, counter, m, j, j - o,
                     self.stream)
        _build.check_launch(rc, "column_w")
        w_launches += 1

    def __call__(self, j: int, o: int) -> None:
        self.reflector(j, o)
        if j == self.m - 2:
            return
        self.matvec(j, o)
        self.w(j, o)


def column_steps(As, Vtb, Wbuf, te, nb: int):
    """The column step of one bucket of ``_tridiagonalize_block``: a callable
    ``step(j, o)`` that reduces local column j of the panel at offset o,
    writing Vtb[j] (v), te[j] (tau, alpha) and Wbuf[j - o] (the W row), and
    ``step.context()`` to run the loop under.  As (m, m) f64 with unit
    column stride (any row stride), Vtb (ncols, m), Wbuf (>= nb, m) and
    te (ncols, 2) contiguous, on one device.  CPU tensors take the plain
    loop; CUDA tensors the kernels (or raise); other devices raise."""
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
