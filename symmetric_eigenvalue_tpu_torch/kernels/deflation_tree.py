"""The merge's Givens deflation tree: CUDA kernel + plain version.

Port of a device loop of ``symmetric_eigenvalue_tpu/kernels/secular.py``
(``_deflation_tree``: a Python loop over the ceil(log2 m) tree levels,
unrolled inside the jitted merge, no ``pallas_call``), on the k merges of a
level at once::

    for l = 0 .. L-1, every aligned block of 2^(l+1) slots:
        a = last active slot of its left half, b = first of its right half
        r = sqrt(za^2 + zb^2), c = zb / r, s = za / r
        if r > 0 and |c s (d_b - d_a)| <= tol: rotate a away into b, log it

:func:`deflation_tree` launches ``csrc/deflation_tree.cu`` for CUDA
tensors, one launch for the whole tree (no host sync: the launch comes from
k and m alone, so a CUDA graph can hold it), and runs
:func:`deflation_tree_plain`, the torch loop (~35 launches a tree level),
for CPU tensors.  The kernel rounds every operation apart, as the loop's
elementwise kernels do: the two agree bit for bit, the packed log included.

The launch plan (:func:`launch_plan`) and the kernel's constants below are
plain Python, so the CPU tests model the kernel's schedule with them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build

launches = 0
"""Kernel launches so far (the CPU path never counts)."""

# csrc/deflation_tree.cu's constants
MAX_THREADS = 256            # threads a block
WARP_MERGES = 8              # the most merges a block in the warp form
SPREAD_BLOCKS = 128          # blocks the warp form spreads a level over, at least
WARP_PADDED = 256            # the widest padded merge a warp takes
STRETCH = 8                  # slots a thread's static tree (block and cluster forms)
BLOCK_SLOTS = MAX_THREADS * STRETCH   # a block's slots
MAX_CLUSTER = 8              # blocks a merge (a portable cluster)

_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_INFO_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]


class Plan(NamedTuple):
    """One launch: ``form`` "warp" (a warp a merge, ``merges_per_block`` of
    them a block), "block" (a block of threads a merge) or "cluster" (a
    thread block cluster of ``cluster`` blocks a merge); ``grid`` blocks of
    ``threads``; each thread ``subs`` static trees of ``stretch`` slots;
    the tree's ``levels`` over the ``padded`` (2^levels) slots, split into
    the thread's (``thread_levels``), the warp's, the block's and the
    cluster's."""

    form: str
    grid: int
    threads: int
    cluster: int
    merges_per_block: int
    stretch: int
    subs: int
    levels: int
    padded: int
    thread_levels: int
    warp_levels: int
    block_levels: int
    cluster_levels: int


def tree_levels(m: int) -> int:
    """The tree's levels, max(1, ceil(log2 m)) (the plain loop's L)."""
    return max(1, (m - 1).bit_length())


def launch_plan(k: int, m: int) -> Plan:
    """The launch for k merges of m slots.  Up to WARP_PADDED padded slots
    a warp takes a merge (a lane 2, 4 or 8 slots), one merge a block up to
    SPREAD_BLOCKS merges, past it as many a block (up to WARP_MERGES) as
    keep SPREAD_BLOCKS blocks (every SM a share of the start copy and the
    tail); past it a block of M2 / 8 threads (up to MAX_THREADS) a merge,
    past BLOCK_SLOTS a cluster of up to MAX_CLUSTER such blocks, and past
    MAX_CLUSTER * BLOCK_SLOTS each thread folds ``subs`` stretches of 8."""
    L = tree_levels(m)
    M2 = 1 << L
    log2 = lambda x: x.bit_length() - 1  # noqa: E731
    if M2 <= WARP_PADDED:
        S = max(2, M2 // 32)
        mpb = max(1, min(WARP_MERGES, k // SPREAD_BLOCKS))
        Lf = log2(S)
        return Plan("warp", -(-k // mpb), 32 * mpb, 1, mpb, S, 1, L, M2, Lf,
                    L - Lf, 0, 0)
    per_block = min(M2, BLOCK_SLOTS)
    threads = per_block // STRETCH
    C = min(MAX_CLUSTER, M2 // per_block)
    R = M2 // (C * per_block)
    return Plan("cluster" if C > 1 else "block", k * C, threads, C, 0,
                STRETCH, R, L, M2, log2(STRETCH * R), 5, log2(threads) - 5,
                log2(C))


def dynamic_shared_bytes(plan: Plan, itemsize: int) -> int:
    """The dynamic shared memory of a launch, a thread's: the records of
    its stretch by node (stretch - 1 of them: c, s and two int32 slots) or,
    where it folds ``subs`` > 1 stretches, its stack of log2(subs)
    summaries (two int32 slots and four values each); then an int32 per
    level of its own (a count, then an offset, then a record position)."""
    depth = plan.subs.bit_length() - 1
    lead = depth * (8 + 4 * itemsize) if plan.subs > 1 else \
        (plan.stretch - 1) * (8 + 2 * itemsize)
    return plan.threads * (lead + plan.thread_levels * 4)


def deflation_tree_plain(ds, zs, defl0, tol):
    """Wave-tree Givens deflation over ascending poles, batched over merges.

    Level l pairs, within every aligned block of 2^(l+1) slots, the LAST
    active slot of the left half with the FIRST active slot of the right half
    and rotates the earlier pole away when the induced off-diagonal
    |c s (d_b - d_a)| stays under tol; rotations within a level touch
    disjoint slots, so each level is one gather/rotate/scatter and the levels
    are the replay waves.  Returns (d, z, defl, rotation log), the log packed
    level by level with masked-out writes dumped into slot m (trimmed).
    """
    k, m = ds.shape
    dev, dt = ds.device, ds.dtype
    L = max(1, (m - 1).bit_length())     # ceil(log2(m))
    M2 = 1 << L

    pad = M2 - m
    if pad:
        ds = torch.cat([ds, torch.zeros((k, pad), dtype=dt, device=dev)], 1)
        zs = torch.cat([zs, torch.zeros((k, pad), dtype=dt, device=dev)], 1)
        defl0 = torch.cat([defl0, torch.ones((k, pad), dtype=torch.bool,
                                             device=dev)], 1)

    d, z, defl = ds.clone(), zs.clone(), defl0.clone()
    ra = torch.zeros((k, m + 1), dtype=torch.int64, device=dev)
    rb = torch.zeros_like(ra)
    rc = torch.zeros((k, m + 1), dtype=dt, device=dev)
    rs = torch.zeros_like(rc)
    rw = torch.zeros_like(ra)
    nrot = torch.zeros(k, dtype=torch.int64, device=dev)

    for lvl in range(L):
        B = 1 << (lvl + 1)
        half = B >> 1
        nb = M2 // B
        act = (~defl).reshape(k, nb, B)
        ih = torch.arange(half, device=dev)
        neg = torch.full((), -1, dtype=torch.int64, device=dev)
        top = torch.full((), half, dtype=torch.int64, device=dev)
        la = torch.where(act[:, :, :half], ih, neg).amax(dim=2)
        fi = torch.where(act[:, :, half:], ih, top).amin(dim=2)
        have = (la >= 0) & (fi < half)
        base = torch.arange(nb, device=dev) * B
        a = base + la.clamp(min=0)
        b = base + half + fi.clamp(max=half - 1)
        da = d.gather(1, a)
        db = d.gather(1, b)
        za = z.gather(1, a)
        zb = z.gather(1, b)
        r = torch.sqrt(za * za + zb * zb)
        pos_r = r > 0
        rsafe = torch.where(pos_r, r, torch.ones_like(r))
        c = torch.where(pos_r, zb / rsafe, torch.ones_like(r))
        s = torch.where(pos_r, za / rsafe, torch.zeros_like(r))
        do = have & pos_r & (torch.abs(c * s * (db - da)) <= tol[:, None])
        d.scatter_(1, a, torch.where(do, c * c * da + s * s * db, da))
        d.scatter_(1, b, torch.where(do, s * s * da + c * c * db, db))
        z.scatter_(1, a, torch.where(do, torch.zeros_like(za), za))
        z.scatter_(1, b, torch.where(do, r, zb))
        defl.scatter_(1, a, defl.gather(1, a) | do)
        # pack this level's rotations densely after the previous levels'
        do_i = do.to(torch.int64)
        pos = nrot[:, None] + torch.cumsum(do_i, dim=1) - 1
        pos = torch.where(do, pos, torch.full_like(pos, m))
        ra.scatter_(1, pos, torch.where(do, a, ra.gather(1, pos)))
        rb.scatter_(1, pos, torch.where(do, b, rb.gather(1, pos)))
        rc.scatter_(1, pos, torch.where(do, c, rc.gather(1, pos)))
        rs.scatter_(1, pos, torch.where(do, s, rs.gather(1, pos)))
        rw.scatter_(1, pos, torch.where(do, torch.full_like(a, lvl + 1),
                                        rw.gather(1, pos)))
        nrot = nrot + do_i.sum(dim=1)

    nwave = rw[:, :m].amax(dim=1)
    return (d[:, :m], z[:, :m], defl[:, :m],
            (ra[:, :m], rb[:, :m], rc[:, :m], rs[:, :m], rw[:, :m], nrot,
             nwave))


def _check(ds, zs, defl0, tol):
    if ds.ndim != 2 or zs.shape != ds.shape or defl0.shape != ds.shape \
            or tol.shape != ds.shape[:1]:
        raise ValueError("deflation_tree: ds, zs, defl0 must be (k, m) and "
                         f"tol (k,), got {tuple(ds.shape)}, "
                         f"{tuple(zs.shape)}, {tuple(defl0.shape)}, "
                         f"{tuple(tol.shape)}")
    if ds.dtype not in (torch.float32, torch.float64) \
            or zs.dtype != ds.dtype or tol.dtype != ds.dtype:
        raise TypeError("deflation_tree: ds, zs and tol must share one "
                        f"dtype, float32 or float64, got {ds.dtype}, "
                        f"{zs.dtype}, {tol.dtype}")
    if defl0.dtype != torch.bool:
        raise TypeError(f"deflation_tree: defl0 must be bool, got "
                        f"{defl0.dtype}")


def deflation_tree(ds, zs, defl0, tol):
    """The deflation tree of the k merges of a level: ds (k, m) ascending
    poles, zs (k, m), defl0 (k, m) bool (already deflated), tol (k,), f32
    or f64.  Returns (d, z, defl, (ra, rb, rc, rs, rw, nrot, nwave)) as
    :func:`deflation_tree_plain` does.  CPU tensors use the plain version;
    CUDA tensors launch the kernel (or raise)."""
    _check(ds, zs, defl0, tol)
    if ds.device.type == "cpu":
        return deflation_tree_plain(ds, zs, defl0, tol)
    return _launch(ds, zs, defl0, tol)


def info(device, f32: bool, plan: Plan):
    """``deflation_tree_info`` of the instance ``plan`` launches on
    ``device``: registers, local bytes, static shared bytes, the most
    threads a block may have."""
    fn = _build.function("deflation_tree", "deflation_tree_info",
                         _INFO_ARGTYPES)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device(device)):
        rc = fn(int(f32), plan.stretch, int(plan.subs > 1),
                ctypes.addressof(out))
    _build.check_launch(rc, "deflation_tree_info")
    return dict(zip(("registers", "local_bytes", "static_shared_bytes",
                     "max_threads"), out))


def _launch(ds, zs, defl0, tol):
    global launches
    if ds.device.type != "cuda":
        raise ValueError(f"deflation_tree: unsupported device {ds.device}")
    index = ds.get_device()
    if any(t.get_device() != index for t in (zs, defl0, tol)):
        raise ValueError("deflation_tree: the inputs must be on one device")
    k, m = ds.shape
    if m > 2 ** 30:
        raise ValueError(f"deflation_tree: {m} slots a merge exceed the "
                         "kernel's int32 slot indices")
    dev, dt = ds.device, ds.dtype
    # the kernel writes every entry, nrot and nwave too (m >= 1); the
    # outputs are contiguous slices of four allocations (the host path)
    d, z, rc, rs = torch.empty((4, k, m), dtype=dt, device=dev).unbind(0)
    ra, rb, rw = torch.empty((3, k, m), dtype=torch.int64,
                             device=dev).unbind(0)
    defl = torch.empty((k, m), dtype=torch.bool, device=dev)
    nrot, nwave = (torch.zeros if m == 0 else torch.empty)(
        (2, k), dtype=torch.int64, device=dev).unbind(0)
    out = (d, z, defl, (ra, rb, rc, rs, rw, nrot, nwave))
    if k == 0 or m == 0:
        return out
    ins = [t.contiguous() for t in (ds, zs, defl0, tol)]
    plan = launch_plan(k, m)
    fn = _build.function("deflation_tree", "deflation_tree_launch", _ARGTYPES)
    args = [t.data_ptr() for t in (*ins, d, z, defl, ra, rb, rc, rs, rw,
                                   nrot, nwave)]
    args += [int(dt == torch.float32), k, m, plan.threads, plan.cluster,
             plan.merges_per_block, plan.stretch, plan.subs]
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == torch.cuda.current_device():
        rc_ = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc_ = fn(*args, stream)
    _build.check_launch(rc_, "deflation_tree")
    launches += 1
    return out
