"""The refinement's two scan recurrences as CUDA kernels, with their plain
versions: the Spike interface solve and the blocked shifted solve's block LU.

Port of the device loops of ``symmetric_eigenvalue_tpu/kernels/refine.py``
(no ``pallas_call``; each is a pair of ``lax.scan`` loops inside the JAX
package's jitted refinement passes):

  interface_solve: the 2x2 block-tridiagonal system over the P row blocks
      of a partitioned solve (JAX ``interface_solve``), a forward and a back
      sweep a column.  The Spike pass (``spike_solve._interface``) makes it
      one launch that also scales pass A's boundary responses by their
      couplers at load time and writes the neighbour values its pass B
      reads (``shifted``); the blocked solver calls it on the boundary rows
      of the block LU's output.
  block_lu_solve: the pivoted LU of every row block (JAX
      ``_block_lu_solve``) for the blocked solver's three right-hand sides,
      v and unit loads on each block's first and last row (generated, not
      read), writing u and the scaled unit-load solutions p = x1 ec_above,
      q = x2 e_cross at every row (what
      ``refine.solve_shifted_tridiagonal_blocked`` reconstructs x from).

CUDA tensors launch ``csrc/interface_solve.cu`` and the block LU instance of
``csrc/spike_solve.cu`` (the elimination of Spike pass A, every row
written), or raise; CPU tensors run :func:`interface_solve_plain` and
:func:`block_lu_solve_plain`, the loops as the JAX package's scans write
them.  Every kernel operation is correctly rounded in the plain loop's
order (no FMA contraction): each kernel is its plain version bit for bit.
Both are f64 only.  Neither launch fetches anything to the host, so a CUDA
graph can hold it (the fused small-n route's part A holds the interface).

The launch plan of ``csrc/spike_solve.cu``'s three block-LU instances
(pass A, pass B, the block LU; :func:`launch_plan`) lives here too, below
both users (``spike_solve`` imports ``refine``, which routes through this
module).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from .. import _build

interface_launches = 0
"""``interface_solve`` kernel launches so far (the CPU path never counts)."""
block_lu_launches = 0
"""``block_lu_solve`` kernel launches so far."""

_BIG = 2.0 ** 80            # back-substitution cascade clip
_TINY2 = 2.0 ** -96         # interface 2x2 determinant floor

_INTERFACE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 5)
_BLOCK_LU_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 6)
_INFO_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_MODES = {"B": 0, "A": 1, "L": 2}   # spike_solve.cu's instances

_SEGMENT = 8                 # kSegment of spike_solve.cu: rows a checkpoint covers
_THREADS = (32, 64, 128)     # the block widths the launch plan weighs
_MAX_SHARED = 232448         # bytes of shared memory a block may use (H100)
_INFO: Dict[Tuple, Tuple[int, int, int]] = {}
_GRID_Y = 65535


def _clamp_piv(piv, tiny):
    """Magnitude floor of a pivot at +-tiny (sign kept; zero goes to +tiny)."""
    return torch.where(piv.abs() < tiny,
                       torch.where(piv < 0, -tiny, tiny), piv)


def _clip(x):
    return torch.clamp(x, -_BIG, _BIG)


# --------------------------------------------------------------------------
# the launch plan of spike_solve.cu's block-LU instances

class Plan(NamedTuple):
    """How one block-LU instance is launched: S-row segments (one
    checkpoint each), ``threads`` columns a block, the dynamic shared memory
    a block holds (the band and the checkpoints), and the blocks an SM holds
    at once."""

    segment: int
    threads: int
    checkpoints: int
    shared_bytes: int
    blocks_per_sm: int


def shared_bytes(nb: int, which: str, threads: int) -> int:
    """A block's dynamic shared memory: the band (2 nb doubles) and, per
    checkpoint, a, c and the right-hand sides it keeps (two in pass A and
    the block LU ("L"), one in pass B) for every thread."""
    checkpoints = -(-(nb - 1) // _SEGMENT)
    fields = 3 if which == "B" else 4
    return 8 * (2 * nb + checkpoints * fields * threads)


def launch_plan(nb: int, which: str,
                resident: Callable[[int, int], int]) -> Plan:
    """The launch of instance ``which`` ("A", "B" or "L") at block size nb:
    the block width, of ``_THREADS``, whose blocks fill an SM with the most
    threads (``resident(threads, shared_bytes)``: the blocks an SM holds,
    from the occupancy API on the card); on a tie the wider block.  Raises
    when no width fits."""
    best = None
    for threads in _THREADS:
        smem = shared_bytes(nb, which, threads)
        if smem > _MAX_SHARED:
            continue
        blocks = resident(threads, smem)
        if blocks > 0 and (best is None
                           or blocks * threads >= best[0] * best[1]):
            best = (blocks, threads, smem)
    if best is None:
        raise ValueError(f"spike_solve: nb={nb} needs more shared memory "
                         f"than a block holds (pass {which})")
    blocks, threads, smem = best
    return Plan(_SEGMENT, threads, -(-(nb - 1) // _SEGMENT), smem, blocks)


def kernel_info(which: str, v_f32: bool, threads: int, smem: int,
                index: int = 0) -> Tuple[int, int, int]:
    """(registers a thread, spill bytes a thread, blocks an SM holds) of the
    instance's kernel on CUDA device ``index`` (cached)."""
    key = (index, which, v_f32, threads, smem)
    info = _INFO.get(key)
    if info is None:
        out = (ctypes.c_int * 3)()
        fn = _build.function("spike_solve", "spike_kernel_info",
                             _INFO_ARGTYPES)
        with torch.cuda.device(index):
            rc = fn(_MODES[which], int(v_f32), threads, smem,
                    ctypes.addressof(out))
        _build.check_launch(rc, "spike_kernel_info")
        info = _INFO[key] = (out[0], out[1], out[2])
    return info


def plan_for(which: str, nb: int, V) -> Plan:
    """The launch plan of instance ``which`` for V's device and type."""
    index = V.device.index if V.device.index is not None \
        else torch.cuda.current_device()
    f32 = V.dtype == torch.float32
    return launch_plan(nb, which, lambda t, smem: kernel_info(
        which, f32, t, smem, index)[2])


# --------------------------------------------------------------------------
# the plain versions

def _block_lu_solve(db, eb, lam, rhs, tiny):
    """Pivoted LU solve of every block system (T_b - lam_i I) x = rhs.

    db (P, nb), eb (P, nb-1): per-block bands; lam (K,); rhs (P, nb, R, K),
    R right-hand sides sharing each column's shift.  Partial pivoting
    between adjacent rows within each block (swap when |sub| > |a|), pivots
    clamped at +-tiny, back substitution clipped at +-2^80.  Returns the
    solutions (P, nb, R, K).  This is the arithmetic the block-LU kernels
    (``csrc/spike_solve.cu``: Spike pass A and B, the block LU) repeat
    operation for operation."""
    P, nb = db.shape
    K = lam.shape[0]
    e_ext = torch.cat([eb, eb.new_zeros((P, 1))], dim=1)
    a = db[:, 0, None] - lam[None, :]                         # (P, K)
    c = e_ext[:, 0, None].expand(P, K)
    r = rhs[:, 0]                                             # (P, R, K)
    ud, u1, u2, rr = [], [], [], []
    for j in range(nb - 1):
        sub = eb[:, j, None]                                  # (P, 1)
        a0n = db[:, j + 1, None] - lam[None, :]
        c0n = e_ext[:, j + 1, None]
        rn = rhs[:, j + 1]
        swap = sub.abs() > a.abs()
        piv = _clamp_piv(torch.where(swap, sub, a), tiny)
        mlt = torch.where(swap, a / piv, sub / piv)
        ud.append(piv)
        u1.append(torch.where(swap, a0n, c))
        u2.append(torch.where(swap, c0n, torch.zeros_like(c)))
        sw = swap[:, None, :]
        ml = mlt[:, None, :]
        rr.append(torch.where(sw, rn, r))
        a_new = torch.where(swap, c - mlt * a0n, a0n - mlt * c)
        c = torch.where(swap, -mlt * c0n, c0n.expand(P, K))
        r = torch.where(sw, r - ml * rn, rn - ml * r)
        a = a_new

    out = torch.empty(rhs.shape, dtype=rhs.dtype, device=rhs.device)
    x1 = _clip(r / _clamp_piv(a, tiny)[:, None, :])
    x2 = torch.zeros_like(x1)
    out[:, nb - 1] = x1
    for j in range(nb - 2, -1, -1):
        x = (rr[j] - u1[j][:, None, :] * x1
             - u2[j][:, None, :] * x2) / ud[j][:, None, :]
        x = _clip(x)
        out[:, j] = x
        x1, x2 = x, x1
    return out


def block_lu_solve_plain(db, e_all, tiny, ec_above, e_cross, lam, V,
                         nb: int):
    """Plain version of :func:`block_lu_solve`: the three right-hand sides
    stacked (V's rows, zero past n, and the unit loads) through
    :func:`_block_lu_solve`, the unit-load solutions scaled by the
    couplers.  Returns (u, p, q), (npad, K) each."""
    npad = db.shape[0]
    P = npad // nb
    n, K = V.shape
    rhs = V.new_zeros((P, nb, 3, K))
    rhs.view(npad, 3, K)[:n, 0] = V
    rhs[:, 0, 1] = 1.0
    rhs[:, nb - 1, 2] = 1.0
    sol = _block_lu_solve(db.view(P, nb), e_all.view(P, nb)[:, :nb - 1],
                          lam, rhs, tiny)
    u = sol[:, :, 0]
    p = sol[:, :, 1] * ec_above[:, None, None]
    q = sol[:, :, 2] * e_cross[:, None, None]
    return tuple(t.reshape(npad, K) for t in (u, p, q))


def interface_solve_plain(pf, pl_, qf, ql, uf, ul, ec_above=None,
                          e_cross=None, shifted: bool = False):
    """Plain version of :func:`interface_solve`: the couplers' products,
    a P-step forward sweep and a P-step back sweep over (K,) columns, then
    (``shifted``) the neighbour rows.

    The JAX recurrence carries G_b = D_b^-1 Up_b as a 2x2 whose second
    column is always zero; the terms it multiplies into are dropped here,
    which leaves every nonzero value bit-identical."""
    if ec_above is not None:
        pf = pf * ec_above[:, None]
        pl_ = pl_ * ec_above[:, None]
    if e_cross is not None:
        qf = qf * e_cross[:, None]
        ql = ql * e_cross[:, None]
    P, K = uf.shape
    G11 = torch.empty_like(uf)
    G21 = torch.empty_like(uf)
    H1 = torch.empty_like(uf)
    H2 = torch.empty_like(uf)
    g21 = uf.new_zeros(K)
    h2 = uf.new_zeros(K)
    for b in range(P):
        # D_b = I - Lo_b G_{b-1} = [[1 - pf g21, 0], [-pl g21, 1]]
        d11 = 1.0 - pf[b] * g21
        det = torch.where(d11.abs() < _TINY2,
                          torch.where(d11 < 0, -_TINY2, _TINY2), d11)
        i11 = 1.0 / det
        i21 = (pl_[b] * g21) / det
        i22 = d11 / det
        r1 = uf[b] - pf[b] * h2
        r2 = ul[b] - pl_[b] * h2
        H1[b] = i11 * r1
        h2 = i21 * r1 + i22 * r2
        H2[b] = h2
        G11[b] = i11 * qf[b]
        g21 = i21 * qf[b] + i22 * ql[b]
        G21[b] = g21
    F = torch.empty_like(uf)
    L = torch.empty_like(uf)
    f_next = uf.new_zeros(K)
    for b in range(P - 1, -1, -1):
        F[b] = H1[b] - G11[b] * f_next
        L[b] = H2[b] - G21[b] * f_next
        f_next = F[b]
    if not shifted:
        return F, L
    F_below = torch.cat([F[1:], F.new_zeros((1, K))], dim=0)
    L_above = torch.cat([L.new_zeros((1, K)), L[:-1]], dim=0)
    return F_below, L_above


# --------------------------------------------------------------------------
# the wrappers

def _require_f64(what, tensors, device):
    for t in tensors:
        if t.dtype != torch.float64:
            raise TypeError(f"{what}: every operand must be float64, got "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{what}: every operand must be on one device")


def interface_solve(pf, pl_, qf, ql, uf, ul, ec_above=None, e_cross=None,
                    shifted: bool = False):
    """The Spike interface system: 2x2 block-tridiagonal solve over blocks.

    Inputs (P, K) f64 are each block's boundary responses: p*/q* the unit
    responses at the first/last row (multiplied here by ``ec_above`` and
    ``e_cross`` (P,) when given), u* the rhs responses.  Returns (F, L)
    (P, K), the solution at every block's first/last row, or with
    ``shifted`` (F_below, L_above): F_below[b] = F[b+1], L_above[b] =
    L[b-1], 0 past the ends.  CPU tensors use the plain version; CUDA
    tensors launch the kernel (or raise)."""
    ins = (pf, pl_, qf, ql, uf, ul)
    if uf.ndim != 2 or any(t.shape != uf.shape for t in ins):
        raise ValueError(f"interface_solve: six (P, K) inputs expected, got "
                         f"{[tuple(t.shape) for t in ins]}")
    scales = [s for s in (ec_above, e_cross) if s is not None]
    if any(s.shape != (uf.shape[0],) for s in scales):
        raise ValueError("interface_solve: the couplers must be (P,)")
    _require_f64("interface_solve", list(ins) + scales, uf.device)
    if uf.device.type == "cpu":
        return interface_solve_plain(*ins, ec_above=ec_above,
                                     e_cross=e_cross, shifted=shifted)
    return _launch_interface(ins, ec_above, e_cross, shifted)


def _launch_interface(ins, ec_above, e_cross, shifted):
    global interface_launches
    uf = ins[4]
    if uf.device.type != "cuda":
        raise ValueError(f"interface_solve: unsupported device {uf.device}")
    P, K = uf.shape
    if K >= 2 ** 31:
        raise ValueError(f"interface_solve: {K} columns exceed the grid")
    Fo = torch.empty((P, K), dtype=torch.float64, device=uf.device)
    Lo = torch.empty((P, K), dtype=torch.float64, device=uf.device)
    if P == 0 or K == 0:
        return Fo, Lo
    ld = ins[0].stride(0)
    if any((t.stride(1) != 1 and K > 1) or (t.stride(0) != ld and P > 1)
           for t in ins):
        ins = [t.contiguous() for t in ins]
        ld = K
    scratch = torch.empty((2, P, K), dtype=torch.float64, device=uf.device)
    sp, sq = (None if s is None else s.contiguous()
              for s in (ec_above, e_cross))
    fn = _build.function("interface_solve", "interface_solve_launch",
                         _INTERFACE_ARGTYPES)
    with torch.cuda.device(uf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), ld,
                None if sp is None else sp.data_ptr(),
                None if sq is None else sq.data_ptr(), P, K, int(shifted),
                Fo.data_ptr(), Lo.data_ptr(), scratch[0].data_ptr(),
                scratch[1].data_ptr(), stream)
    _build.check_launch(rc, "interface_solve")
    interface_launches += 1
    return Fo, Lo


def block_lu_solve(db, e_all, tiny, ec_above, e_cross, lam, V, nb: int):
    """The blocked solver's block solves: (u, p, q), (npad, K) f64 each.

    db, e_all (npad,), tiny (0-d) and the couplers e_cross, ec_above (P,)
    from ``refine.band_prep``; lam (K,); V (n, K), n <= npad = P nb, a
    column slice taken without a copy; all f64.  Per block and column the
    pivoted LU of (T_b - lam I) against V's rows (zero past n) and unit
    loads on the block's first and last row: u the first solution, p and q
    the unit loads' scaled by ec_above and e_cross.  CPU tensors use the
    plain version; CUDA tensors launch the kernel (or raise)."""
    nb = int(nb)
    npad = db.shape[0]
    P = npad // nb
    if V.ndim != 2 or lam.shape != (V.shape[1],) or npad % nb \
            or V.shape[0] > npad or e_all.shape != (npad,) \
            or ec_above.shape != (P,) or e_cross.shape != (P,):
        raise ValueError(f"block_lu_solve: V (n, K) with K = len(lam) and "
                         f"n <= npad, npad a multiple of nb={nb}; got V "
                         f"{tuple(V.shape)}, lam {tuple(lam.shape)}, band "
                         f"{tuple(db.shape)}")
    _require_f64("block_lu_solve", (db, e_all, tiny, ec_above, e_cross, lam,
                                    V), V.device)
    if V.device.type == "cpu":
        return block_lu_solve_plain(db, e_all, tiny, ec_above, e_cross, lam,
                                    V, nb)
    return _launch_block_lu(db, e_all, tiny, ec_above, e_cross, lam, V, nb)


def _launch_block_lu(db, e_all, tiny, ec_above, e_cross, lam, V, nb):
    global block_lu_launches
    if V.device.type != "cuda":
        raise ValueError(f"block_lu_solve: unsupported device {V.device}")
    npad = db.shape[0]
    P = npad // nb
    n, K = V.shape
    outs = [torch.empty((npad, K), dtype=torch.float64, device=V.device)
            for _ in range(3)]
    if P == 0 or K == 0:
        return tuple(outs)
    if P > _GRID_Y or npad >= 2 ** 31:
        raise ValueError(f"block_lu_solve: {P} row blocks exceed the grid "
                         "limit")
    if V.stride(1) != 1:
        V = V.contiguous()
    ins = [t.contiguous() for t in (db, e_all, tiny.reshape(1), lam)]
    cpl = [t.contiguous() for t in (ec_above, e_cross)]
    plan = plan_for("L", nb, V)
    fn = _build.function("spike_solve", "block_lu_launch", _BLOCK_LU_ARGTYPES)
    with torch.cuda.device(V.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ins), V.data_ptr(), V.stride(0), 0,
                n, nb, P, K, plan.threads, plan.shared_bytes,
                *(t.data_ptr() for t in cpl), *(t.data_ptr() for t in outs),
                stream)
    _build.check_launch(rc, "block_lu_solve")
    block_lu_launches += 1
    return tuple(outs)
