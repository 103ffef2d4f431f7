"""PyTorch port, the merge's Givens deflation tree
(kernels/deflation_tree.py) on the CPU.

The plain version (the torch loop CPU tensors run, and the card's kernel is
held to bit for bit) against the JAX package's ``_deflation_tree`` on the
same numpy inputs: random, heavy deflation, duplicate poles, zero z, all and
none deflated, m = 1, 2, 5 and 48, in f32 and f64.  The active sets and the
packed log's indices and waves must be equal; d, z, c and s agree within
``tests/test_torch_secular.py::_compare``'s tolerances (1e-13 of the largest
|value| for d and z, 1e-15 for c and s), in units of each dtype's eps:
XLA:CPU may contract a product and a sum into one fused multiply-add, which
the elementwise kernels here and on the card never do.

A numpy model of the CUDA kernel's schedule (each thread's stretches as
trees folded through a stack, the warp's xor butterfly, the block's levels in
warp 0, the cluster's in block 0; the values carried in the nodes'
summaries, a slot written when it leaves them changed; the log placed once
from the threads' counts, each record's position and each node's owner
asserted) is held bit for bit against the plain loop on the same cases, at
the launch plan and at another plan of the kernel's (a cluster of 64-thread
blocks, folded stretches), and on random cases up to m = 300, or 2200 under
the other plan (hypothesis).  The launch plan's forms (a warp a merge, a
block, a cluster) are checked over the main path's levels."""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from symmetric_eigenvalue_tpu.kernels.secular import \
    _deflation_tree as j_tree
from symmetric_eigenvalue_tpu_torch.kernels import deflation_tree as dtr
from symmetric_eigenvalue_tpu_torch.kernels import secular as tsec

_J_TREE = jax.jit(jax.vmap(j_tree))
KINDS = ("random", "heavy", "duplicates", "zero_z", "all_deflated",
         "none_deflated")
SIZES = (1, 2, 5, 48)
DTYPES = (np.float32, np.float64)


def _case(kind, k, m, dtype, seed=0):
    """(ds ascending, zs, defl0, tol) of k merges of m slots."""
    rng = np.random.default_rng(seed)
    if kind in ("heavy", "zero_z"):
        # clusters: poles on a coarse grid plus tiny offsets
        ds = np.round(rng.standard_normal((k, m)) * 2.0, 1) \
            + 1e-7 * rng.standard_normal((k, m))
    elif kind == "duplicates":
        ds = rng.integers(0, max(1, m // 4), (k, m)).astype(np.float64)
    else:
        ds = rng.standard_normal((k, m)) * 5.0
    ds = np.sort(ds, axis=1)
    zs = rng.standard_normal((k, m)) / np.sqrt(m)
    defl0 = rng.random((k, m)) < 0.15
    if kind == "zero_z":
        zs[rng.random((k, m)) < 0.5] = 0.0
    if kind == "all_deflated":
        defl0[:] = True
    if kind == "none_deflated":
        defl0[:] = False
    zs = np.where(defl0, 0.0, zs)
    # every tolerance far above the rounding of the poles in the data's
    # dtype (the solver's is 8 eps |d|max): a decision within an ulp of it
    # would turn on XLA's contraction, not on the tree
    dup_tol = 1e-12 if dtype == np.float64 else 1e-4
    tol = {"random": 0.05, "heavy": 1e-4, "duplicates": dup_tol,
           "zero_z": 1e-4, "all_deflated": 0.05,
           "none_deflated": 0.05}[kind] * np.ones(k)
    return ds.astype(dtype), zs.astype(dtype), defl0, tol.astype(dtype)


def _plain(ds, zs, defl0, tol):
    d, z, defl, log = dtr.deflation_tree_plain(
        *(torch.as_tensor(a) for a in (ds, zs, defl0, tol)))
    return [np.ascontiguousarray(t.numpy()) for t in (d, z, defl, *log)]


NAMES = ("d", "z", "defl", "ra", "rb", "rc", "rs", "rw", "nrot", "nwave")


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax(kind, m, dtype):
    args = _case(kind, 3, m, dtype, seed=m)
    got = dict(zip(NAMES, _plain(*args)))
    d, z, defl, log = _J_TREE(*(jnp.asarray(a) for a in args))
    ref = dict(zip(NAMES, [np.asarray(x) for x in (d, z, defl, *log)]))
    for f in ("defl", "nrot", "nwave"):
        assert np.array_equal(got[f], ref[f].astype(got[f].dtype)), f
    ulps = np.finfo(dtype).eps / np.finfo(np.float64).eps
    for f in ("d", "z"):
        assert got[f].dtype == dtype
        scale = max(np.abs(ref[f]).max(), 1e-300)
        assert np.abs(got[f] - ref[f]).max() <= 1e-13 * ulps * scale, f
    for b in range(args[0].shape[0]):
        nr = int(ref["nrot"][b])
        for f in ("ra", "rb", "rw"):
            assert np.array_equal(got[f][b, :nr], ref[f][b, :nr]), f
            assert not got[f][b, nr:].any(), f
        for f in ("rc", "rs"):
            assert got[f].dtype == dtype
            assert np.abs(got[f][b, :nr] - ref[f][b, :nr]).max(initial=0) \
                <= 1e-15 * ulps, f
            assert not got[f][b, nr:].any(), f
    if kind == "all_deflated" or m == 1:
        assert not got["nrot"].any()
    if kind in ("heavy", "duplicates") and m == 48:
        assert got["nwave"].max() >= 3      # chains across levels


# --------------------------------------------------------------------------
# the kernel's schedule

def _torch_sqrt(x):
    """torch's square root on the CPU, of one numpy scalar: ATen's
    vectorized sqrt, which misses the correctly rounded root by an ulp for
    ~0.7% of inputs (the same whatever the tensor's length)."""
    return torch.sqrt(torch.from_numpy(np.array([x]))).numpy()[0]


def _alt_plan(k, m):
    """Another plan the kernel's code runs for (k, m), to reach its cluster
    and folded paths at small widths: blocks of 64 threads (two warps), a
    cluster of up to 8 of them, and past 8 x 512 slots each thread folding
    stretches of 8; the launch plan itself below 512 padded slots."""
    plan = dtr.launch_plan(k, m)
    M2 = plan.padded
    if M2 < 1024:
        return plan
    C = min(8, M2 // 512)
    R = M2 // (C * 512)
    return plan._replace(form="cluster", grid=k * C, threads=64, cluster=C,
                         merges_per_block=0, stretch=8, subs=R,
                         thread_levels=3 + R.bit_length() - 1, warp_levels=5,
                         block_levels=1, cluster_levels=C.bit_length() - 1)


class _Summary(NamedTuple):
    """A node's summary as the kernel carries it: its slot range's start,
    first and last active slot (None: no slot), their dirty bits and
    current (d, z)."""
    lo: int
    f: object
    fdirty: bool
    fd: object
    fz: object
    l: object
    ldirty: bool
    ld: object
    lz: object


def _kernel_model(ds, zs, defl0, tol, plan=None, sqrt=_torch_sqrt):
    """numpy model of csrc/deflation_tree.cu: every value a numpy scalar of
    the data's dtype, each operation rounded apart in the kernel's order.
    The schedule of ``plan`` (the launch plan by default): each thread's
    static trees of ``stretch`` slots folded through a stack, the warp's
    xor butterfly (the lower lane of a pair owns the node), the block's
    levels in warp 0's lanes, the cluster's in block 0's; the values carried
    in the summaries and a slot written when it leaves them changed; the
    log placed once from the threads' counts.  Asserts each node's owner
    (the thread, warp or block whose slots start the node), that no slot is
    written twice after the start copy, and each record's position against
    the plain loop's order (level-major, node ascending).  ``sqrt``: the
    kernel's __dsqrt_rn / __fsqrt_rn round correctly, as torch's sqrt on the
    card does; against the plain loop on the CPU the model takes torch's CPU
    root."""
    k, m = ds.shape
    plan = plan or dtr.launch_plan(k, m)
    L, M2, S, R = plan.levels, plan.padded, plan.stretch, plan.subs
    C = plan.cluster
    W = 1 if plan.form == "warp" else plan.threads // 32
    Lf, Lw, Lb, Lc = (plan.thread_levels, plan.warp_levels,
                      plan.block_levels, plan.cluster_levels)
    assert Lf + Lw + Lb + Lc == L and (1 << Lf) == S * R
    zero = ds.dtype.type(0)
    one = ds.dtype.type(1)
    d_all = np.full((k, m), np.nan, ds.dtype)  # the kernel's outputs start empty
    z_all = d_all.copy()
    defl_all = np.zeros((k, m), bool)
    ra = np.full((k, m), -7, np.int64)
    rb, rw = ra.copy(), ra.copy()
    rc = np.full((k, m), np.nan, ds.dtype)
    rs = rc.copy()
    nrot = np.full(k, -7, np.int64)
    nwave = nrot.copy()
    per_thread = S * R
    threads = M2 // per_thread             # a merge's threads
    for mb in range(k):
        t_ = tol[mb]
        d, z, defl = d_all[mb], z_all[mb], defl_all[mb]
        d[:], z[:], defl[:] = ds[mb], zs[mb], defl0[mb]     # the start copy
        written = np.zeros(m, np.int64)

        def put(i, dv, zv, gone):
            written[i] += 1
            assert written[i] == 1, f"slot {i} written twice"
            d[i], z[i], defl[i] = dv, zv, gone

        recs = []          # (level, node, owner thread, a, b, c, s)

        def combine(A, B, level, owner, writes=True):
            """The kernel's combine; the node's owner asserted."""
            lo = A.lo
            assert B.lo == lo + (1 << level) and lo % (2 << level) == 0
            assert owner == lo // per_thread, (owner, lo)
            if A.f is None:
                return B._replace(lo=lo)
            if B.f is None:
                return A
            a, b = A.l, B.f
            da, za, db, zb = A.ld, A.lz, B.fd, B.fz
            r = sqrt(za * za + zb * zb)
            rot = False
            c, s = one, zero
            if r > zero:
                c, s = zb / r, za / r
                rot = bool(abs((c * s) * (db - da)) <= t_)
            left_one, right_one = A.f == a, B.l == b
            bd, bz, bdirty = db, zb, B.fdirty
            if rot:
                cc, ss = c * c, s * s
                if writes:
                    put(a, cc * da + ss * db, zero, True)
                bd, bz, bdirty = ss * da + cc * db, r, True
                recs.append((level, lo >> (level + 1), owner, a, b, c, s))
            elif writes and not left_one and A.ldirty:
                put(a, da, za, False)
            if rot and left_one:
                first = (b, bdirty, bd, bz)
            else:
                first = (A.f, A.fdirty, A.fd, A.fz)
            last = (b, bdirty, bd, bz) if right_one else \
                (B.l, B.ldirty, B.ld, B.lz)
            if writes and not (rot and left_one) and not right_one \
                    and bdirty:
                put(b, bd, bz, False)
            return _Summary(lo, *first, *last)

        def leaf(i):
            if i < m and not defl0[mb, i]:
                return _Summary(i, i, False, ds[mb, i], zs[mb, i], i, False,
                                ds[mb, i], zs[mb, i])
            return _Summary(i, *(None,) * 8)

        # 1. each thread's levels: static trees, folded through a stack
        summ = []
        for t in range(threads):
            stack = {}
            for r in range(R):
                s0 = t * per_thread + r * S
                nodes = [leaf(s0 + i) for i in range(S)]
                lv = 0
                while len(nodes) > 1:
                    nodes = [combine(nodes[2 * j], nodes[2 * j + 1], lv, t)
                             for j in range(len(nodes) // 2)]
                    lv += 1
                cur, bit = nodes[0], 0
                while (r >> bit) & 1:
                    cur = combine(stack[bit], cur, lv + bit, t)
                    bit += 1
                stack[bit] = cur
            summ.append(cur)
        # 2. the warp's levels (the lower lane of each pair owns the node)
        for i in range(Lw):
            for t in range(0, threads, 2 << i):
                summ[t] = combine(summ[t], summ[t + (1 << i)], Lf + i, t)
        per_warp = 32
        # 3. the block's levels in warp 0 (lane w for warp w): the owner is
        # lane w, standing for the warp whose slots start the node
        per_block = 32 * W
        for i in range(Lb):
            for blk in range(C):
                for w in range(0, W, 2 << i):
                    t0 = blk * per_block + w * per_warp
                    t1 = t0 + (1 << i) * per_warp
                    summ[t0] = combine(summ[t0], summ[t1], Lf + Lw + i, t0)
        # 4. the cluster's levels in block 0's warp 0 (lane c for block c)
        for i in range(Lc):
            for c in range(0, C, 2 << i):
                t0 = c * per_block
                t1 = t0 + (1 << i) * per_block
                summ[t0] = combine(summ[t0], summ[t1], Lf + Lw + Lb + i, t0)
        root = summ[0]
        if root.f is not None:
            if root.fdirty:
                put(root.f, root.fd, root.fz, False)
            if root.l != root.f and root.ldirty:
                put(root.l, root.ld, root.lz, False)

        # the log placed once: a thread's counts a level, prefixes within
        # the warp, over the block's warps, over the cluster's blocks
        Lcta = L - Lc
        lanes = C * W * 32                   # a warp merge's idle lanes too
        cnt = np.zeros((lanes, L), np.int64)
        for lv, _, owner, *_ in recs:
            cnt[owner, lv] += 1
        pre = np.zeros_like(cnt)
        base = np.zeros(L, np.int64)
        off = cnt[:, :Lcta].reshape(C, W, 32, Lcta)
        in_warp = np.cumsum(off, axis=2) - off
        warp_tot = off.sum(axis=2)                            # (C, W, L)
        over_warps = np.cumsum(warp_tot, axis=1) - warp_tot
        block_tot = warp_tot.sum(axis=1)                      # (C, L)
        over_blocks = np.cumsum(block_tot, axis=0) - block_tot
        grand = block_tot.sum(axis=0)
        base[:Lcta] = np.cumsum(grand) - grand
        pre[:, :Lcta] = (in_warp + over_warps[:, :, None, :]
                         + over_blocks[:, None, None, :]).reshape(lanes,
                                                                  Lcta)
        done = int(grand.sum())
        for lv in range(Lcta, L):            # the cluster's, in lane order
            base[lv] = done
            owners = sorted(r_[2] for r_ in recs if r_[0] == lv)
            for i, o_ in enumerate(owners):
                pre[o_, lv] = i
            done += len(owners)
        # each record's position against the plain loop's order
        order = sorted(recs, key=lambda r_: (r_[0], r_[1]))
        want = {(r_[0], r_[1]): i for i, r_ in enumerate(order)}
        nxt = {}
        for lv, node, owner, a, b, c, s in recs:  # a thread's in its order
            at = nxt.get((owner, lv), 0)
            nxt[(owner, lv)] = at + 1
            pos = int(base[lv] + pre[owner, lv]) + at
            assert pos == want[(lv, node)], (lv, node, pos)
            ra[mb, pos], rb[mb, pos], rc[mb, pos], rs[mb, pos] = a, b, c, s
            rw[mb, pos] = lv + 1
        nrot[mb] = done
        nwave[mb] = max((r_[0] + 1 for r_ in recs), default=0)
        ra[mb, done:] = rb[mb, done:] = rw[mb, done:] = 0
        rc[mb, done:] = rs[mb, done:] = zero
    return [d_all, z_all, defl_all, ra, rb, rc, rs, rw, nrot, nwave]


def _bit_for_bit(got, ref):
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert np.ascontiguousarray(g).tobytes() == \
            np.ascontiguousarray(r).tobytes(), name


@pytest.mark.parametrize("alt", (False, True), ids=("plan", "alt_plan"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("m", SIZES + (300,))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_model_matches_plain(kind, m, dtype, alt):
    """At the launch plan, and (alt_plan) at m = 300 in blocks of two warps
    with the widths doubled to 1100 in a cluster of two (see _alt_plan)."""
    if alt and m == 300:
        m = 1100
    args = _case(kind, 2, m, dtype, seed=m + 1)
    plan = _alt_plan(2, m) if alt else None
    _bit_for_bit(_kernel_model(*args, plan=plan), _plain(*args))


@pytest.mark.parametrize("kind, m, dtype", [("heavy", 5000, np.float64),
                                            ("duplicates", 9000, np.float32)])
def test_kernel_model_folded_stretches(kind, m, dtype):
    """_alt_plan past 4096 padded slots: each thread folds 2 (m = 5000) or
    4 (m = 9000) stretches of 8 through its stack, under a cluster of 8."""
    args = _case(kind, 1, m, dtype, seed=3)
    plan = _alt_plan(1, m)
    assert plan.subs == (2 if m == 5000 else 4) and plan.cluster == 8
    _bit_for_bit(_kernel_model(*args, plan=plan), _plain(*args))


def _rounded_sqrt(t):
    """A correctly rounded torch.sqrt (numpy's), as torch's on the card."""
    return torch.from_numpy(np.sqrt(t.numpy()))


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_model_matches_plain_rounded_sqrt(monkeypatch, kind, dtype):
    """What the card compares: the plain loop with a correctly rounded
    square root against the model with the kernel's."""
    args = _case(kind, 2, 300, dtype, seed=7)
    want = _kernel_model(*args, sqrt=np.sqrt)
    monkeypatch.setattr(torch, "sqrt", _rounded_sqrt)
    _bit_for_bit(want, _plain(*args))


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 300), k=st.integers(1, 3), seed=st.integers(0, 2**16),
       f32=st.booleans(), deflated=st.floats(0.0, 1.0),
       grid=st.sampled_from([0.0, 0.5, 0.1]), alt=st.booleans())
def test_kernel_model_matches_plain_random(m, k, seed, f32, deflated, grid,
                                           alt):
    """Random masks and poles (on a grid of that spacing, or spread), some
    z exactly zero; with ``alt`` the width scaled to 4 m + 1000 under
    _alt_plan (a cluster of 64-thread blocks, folded stretches past 4096
    padded slots)."""
    if alt:
        m = 4 * m + 1000
    rng = np.random.default_rng(seed)
    ds = rng.standard_normal((k, m)) * 3.0
    if grid:
        ds = np.round(ds / grid) * grid + 1e-9 * rng.standard_normal((k, m))
    ds = np.sort(ds, axis=1)
    defl0 = rng.random((k, m)) < deflated
    zs = rng.standard_normal((k, m)) * (rng.random((k, m)) > 0.1)
    zs = np.where(defl0, 0.0, zs / np.sqrt(m))
    tol = 10.0 ** rng.uniform(-8, -1, k)
    dtype = np.float32 if f32 else np.float64
    args = tuple(a.astype(dtype) if a.dtype != bool else a
                 for a in (ds, zs, defl0, tol))
    _bit_for_bit(_kernel_model(*args, plan=_alt_plan(k, m) if alt else None),
                 _plain(*args))


# --------------------------------------------------------------------------
# the wrapper

def test_cpu_path_is_the_plain_version():
    args = [torch.as_tensor(a) for a in _case("heavy", 4, 100, np.float64)]
    got = dtr.deflation_tree(*args)
    ref = dtr.deflation_tree_plain(*args)
    flat = lambda out: [*out[:3], *out[3]]  # noqa: E731
    assert all(torch.equal(g, r) for g, r in zip(flat(got), flat(ref)))
    assert dtr.launches == 0


def test_merge_partition_takes_the_wrapper(monkeypatch):
    seen = []

    def spy(*args):
        seen.append(tuple(args[0].shape))
        return dtr.deflation_tree(*args)

    monkeypatch.setattr(tsec, "deflation_tree", spy)
    d, z, _, _ = _case("random", 2, 20, np.float64)
    tsec.merge_partition(torch.as_tensor(d), torch.as_tensor(z),
                         torch.ones(2, dtype=torch.float64),
                         eps=2.0 ** -52, deflation_factor=8.0)
    assert seen == [(2, 20)]


def test_rejects_bad_inputs():
    ds, zs, defl0, tol = (torch.as_tensor(a)
                          for a in _case("random", 2, 8, np.float64))
    with pytest.raises(ValueError, match="must be"):
        dtr.deflation_tree(ds[0], zs[0], defl0[0], tol)
    with pytest.raises(ValueError, match="must be"):
        dtr.deflation_tree(ds, zs[:, :4], defl0, tol)
    with pytest.raises(ValueError, match="must be"):
        dtr.deflation_tree(ds, zs, defl0, tol[:1])
    with pytest.raises(TypeError, match="dtype"):
        dtr.deflation_tree(ds, zs.float(), defl0, tol)
    with pytest.raises(TypeError, match="dtype"):
        dtr.deflation_tree(ds.half(), zs.half(), defl0, tol.half())
    with pytest.raises(TypeError, match="bool"):
        dtr.deflation_tree(ds, zs, defl0.to(torch.uint8), tol)
    meta = [t.to("meta") for t in (ds, zs, defl0, tol)]
    with pytest.raises(ValueError, match="unsupported device"):
        dtr.deflation_tree(*meta)
    assert dtr.launches == 0


@pytest.mark.parametrize(
    "k, m, form, grid, threads, cluster, stretch, subs, levels", [
        (256, 64, "warp", 128, 64, 1, 2, 1, 6),     # the bottom level
        (1, 16384, "cluster", 8, 256, 8, 8, 1, 14),  # the root
        (2, 8192, "cluster", 8, 256, 4, 8, 1, 13),
        (4, 4096, "cluster", 8, 256, 2, 8, 1, 12),
        (3, 1000, "block", 3, 128, 1, 8, 1, 10),     # padded to 1024
        (1, 98304, "cluster", 8, 256, 8, 8, 8, 17),  # the CLI's root
        (7, 1, "warp", 7, 32, 1, 2, 1, 1),           # a lane a merge
        (7, 2, "warp", 7, 32, 1, 2, 1, 1),
        (2048, 16, "warp", 256, 256, 1, 2, 1, 4),    # 8 merges a block
    ])
def test_launch_plan(k, m, form, grid, threads, cluster, stretch, subs,
                     levels):
    plan = dtr.launch_plan(k, m)
    assert (plan.form, plan.grid, plan.threads, plan.cluster, plan.stretch,
            plan.subs, plan.levels) == (form, grid, threads, cluster,
                                        stretch, subs, levels)
    assert plan.padded == 1 << levels >= m
    assert plan.thread_levels + plan.warp_levels + plan.block_levels \
        + plan.cluster_levels == levels
    assert 1 << plan.thread_levels == plan.stretch * plan.subs
    assert plan.threads % 32 == 0 and plan.threads <= dtr.MAX_THREADS
    if form == "warp":
        assert plan.merges_per_block * 32 == plan.threads
        assert plan.grid * plan.merges_per_block >= k
        assert plan.block_levels == plan.cluster_levels == 0
    else:
        assert plan.merges_per_block == 0 and plan.grid == k * cluster
        assert plan.warp_levels == 5
        assert 1 << plan.block_levels == plan.threads // 32 >= 2
        assert plan.cluster_levels == (cluster - 1).bit_length()


@pytest.mark.parametrize("m", [2048, 2049, 4096, 6000, 16384, 16385, 65536,
                               98304, 2 ** 20])
def test_launch_plan_cluster_form(m):
    """Past a block's 2048 slots a cluster of up to 8 blocks of 256 threads
    a merge (a portable cluster), then stretches folded a thread."""
    plan = dtr.launch_plan(3, m)
    M2 = plan.padded
    per_cluster = plan.cluster * plan.threads * plan.stretch * plan.subs
    assert per_cluster == M2
    if M2 <= dtr.BLOCK_SLOTS:
        assert plan.form == "block" and plan.cluster == 1
    else:
        assert plan.form == "cluster" and plan.threads == dtr.MAX_THREADS
        assert plan.cluster == min(dtr.MAX_CLUSTER, M2 // dtr.BLOCK_SLOTS)
        assert plan.subs == max(1, M2 // (dtr.MAX_CLUSTER * dtr.BLOCK_SLOTS))
        assert plan.grid == 3 * plan.cluster


@pytest.mark.parametrize("m", [64, 2048, 16384, 16385, 98304, 2 ** 20,
                               2 ** 30])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_dynamic_shared_bytes(m, itemsize):
    """A thread's per-level ints and its stretch's records by node or,
    where it folds several stretches, its stack live in dynamic shared
    memory (no local memory): within an H100
    block's 232,448 bytes beside the 48 KB a block's static arrays may
    take, up to the kernel's largest merge (2^30 slots)."""
    plan = dtr.launch_plan(1, m)
    got = dtr.dynamic_shared_bytes(plan, itemsize)
    depth = plan.subs.bit_length() - 1
    lead = depth * (8 + 4 * itemsize) if plan.subs > 1 else \
        (plan.stretch - 1) * (8 + 2 * itemsize)
    assert got == plan.threads * (lead + plan.thread_levels * 4)
    assert plan.thread_levels == 3 + depth or plan.form == "warp"
    assert got <= 232448 - 48 * 1024


@pytest.mark.parametrize("k, m", [(1, 1), (5, 3), (256, 64), (255, 64),
                                  (128, 128), (64, 256), (9, 200),
                                  (4096, 2), (700, 100)])
def test_launch_plan_warp_form(k, m):
    """Up to 256 padded slots a warp takes a merge (a lane 2, 4 or 8 slots,
    lanes past the padded width idle); a merge a block up to 128 merges,
    then as many a block (up to 8) as keep 128 blocks."""
    plan = dtr.launch_plan(k, m)
    assert plan.form == "warp" and plan.cluster == 1 and plan.subs == 1
    assert plan.stretch == max(2, plan.padded // 32)
    assert plan.merges_per_block == max(1, min(dtr.WARP_MERGES,
                                               k // dtr.SPREAD_BLOCKS))
    assert plan.grid >= min(k, dtr.SPREAD_BLOCKS)
    assert plan.grid == -(-k // plan.merges_per_block)
    assert plan.warp_levels == plan.levels - plan.thread_levels <= 5


@pytest.mark.parametrize("symbol, argtypes", [
    ("deflation_tree_launch", dtr._ARGTYPES),
    ("deflation_tree_info", dtr._INFO_ARGTYPES)])
def test_bindings_match_the_source(symbol, argtypes):
    """The wrapper's ctypes argument lists are the C functions' (a pointer
    passed as an int would be cut to 32 bits on the card)."""
    import ctypes
    import pathlib
    import re
    from symmetric_eigenvalue_tpu_torch import _build
    text = (pathlib.Path(_build.__file__).resolve().parent / "csrc"
            / "deflation_tree.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, symbol
    kinds = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int*": ctypes.c_void_p, "int": ctypes.c_int}
    got = [kinds[" ".join(p.split()).rsplit(" ", 1)[0].replace(" *", "*")]
           for p in m.group(1).split(",")]
    assert got == list(argtypes)


def test_fast_division_is_one_text():
    """deflation_tree.cu and spike_solve.cu carry the same fast division
    (FAST_DDIV_BEGIN .. FAST_DDIV_END), the one tools/fp64_chain_probe.py
    holds bit for bit against __ddiv_rn on the card."""
    import pathlib
    from symmetric_eigenvalue_tpu_torch import _build
    csrc = pathlib.Path(_build.__file__).resolve().parent / "csrc"
    blocks = []
    for name in ("deflation_tree", "spike_solve"):
        text = (csrc / f"{name}.cu").read_text()
        blocks.append(text[text.index("// FAST_DDIV_BEGIN"):
                           text.index("// FAST_DDIV_END")])
    assert blocks[0] == blocks[1]
    assert "ddiv_by" in blocks[0] and "rcp_fast" in blocks[0]


@functools.lru_cache(maxsize=None)
def _solver_levels(n):
    """(k, m) of every merge level of a solve at n with 64-wide leaves."""
    out, m = [], 64
    while m <= n:
        out.append((n // m, m))
        m *= 2
    return tuple(out)


def test_launch_plan_over_the_main_path():
    """Every level of an n=16384 solve: one launch a level; a warp a merge
    up to m=256, a block to 2048, then clusters of 2, 4 and 8 blocks."""
    forms = []
    for k, m in _solver_levels(16384):
        plan = dtr.launch_plan(k, m)
        assert plan.padded == m and plan.subs == 1
        lanes = 32 if plan.form == "warp" else plan.cluster * plan.threads
        assert lanes * plan.stretch == m
        forms.append((plan.form, plan.cluster))
    assert forms == [("warp", 1)] * 3 + [("block", 1)] * 3 + [
        ("cluster", 2), ("cluster", 4), ("cluster", 8)]
