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

A numpy model of the CUDA kernel's schedule (a block of threads a merge,
each thread q adjacent nodes a level, the nodes' (first, last) active-slot
summaries in two buffers by level parity, each thread's rotations kept as
records in a stretch of its own at every level and placed by an exclusive
scan of the threads' counts, the log's tail zeroed) is held bit for bit against the plain loop on the same cases,
at the launch plan's threads and at fewer (several nodes a thread), and on
random cases up to m = 300 (hypothesis)."""

import functools

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


def _kernel_model(ds, zs, defl0, tol, threads=None, sqrt=_torch_sqrt):
    """numpy model of csrc/deflation_tree.cu: every value a numpy scalar of
    the data's dtype, each operation rounded apart in the kernel's order.
    ``sqrt``: the kernel's __dsqrt_rn / __fsqrt_rn round correctly, as
    torch's sqrt on the card does; against the plain loop on the CPU the
    model takes torch's CPU root."""
    k, m = ds.shape
    plan = dtr.launch_plan(k, m)
    nt = threads or plan.threads
    L, M2 = plan.levels, plan.padded
    half, quarter = M2 // 2, M2 // 4
    zero = ds.dtype.type(0)
    per = dtr.records_per_thread(plan._replace(threads=nt))
    d_all, z_all, defl_all = ds.copy(), zs.copy(), defl0.copy()
    ra = np.full((k, m), -7, np.int64)      # the kernel's outputs start empty
    rb, rw = ra.copy(), ra.copy()
    rc = np.full((k, m), np.nan, ds.dtype)
    rs = rc.copy()
    nrot = np.full(k, -7, np.int64)
    nwave = nrot.copy()
    for mb in range(k):
        d, z, defl, t_ = d_all[mb], z_all[mb], defl_all[mb], tol[mb]
        summ = np.full((half + quarter, 2), -9, np.int64)
        rec_ab = np.full((nt * per, 2), -9, np.int64)
        rec_cs = np.full((nt * per, 2), np.nan, ds.dtype)
        # a record's writer: one thread at every level, or a thread still
        # copying a level's records could meet another's next level
        owner = np.full(nt * per, -1)
        base, last_wave = 0, 0
        for lvl in range(L):
            nodes = M2 >> (lvl + 1)
            q = nodes // nt if nodes > nt else 1
            out = half if lvl & 1 else 0
            inn = 0 if lvl & 1 else half
            counts = []
            for t in range(nt):
                j0 = t * q
                cnt = 0
                for j in range(j0, min(j0 + q, nodes)):
                    if lvl == 0:
                        left, right = ((s, s) if s < m and not defl[s]
                                       else (-1, -1) for s in (2 * j, 2 * j + 1))
                    else:
                        left = tuple(summ[inn + 2 * j])
                        right = tuple(summ[inn + 2 * j + 1])
                    assert min(left + right) >= -1     # written a level before
                    if left[0] < 0:
                        node = right
                    elif right[0] < 0:
                        node = left
                    else:
                        a, b = left[1], right[0]
                        da, db, za, zb = d[a], d[b], z[a], z[b]
                        r = sqrt(za * za + zb * zb)
                        rotated = False
                        if r > zero:
                            c, s = zb / r, za / r
                            if abs((c * s) * (db - da)) <= t_:
                                rotated = True
                                cc, ss = c * c, s * s
                                d[a] = cc * da + ss * db
                                d[b] = ss * da + cc * db
                                z[a] = zero
                                z[b] = r
                                defl[a] = True
                                at = t * per + cnt
                                assert owner[at] in (-1, t) and cnt < per
                                owner[at] = t
                                rec_ab[at] = (a, b)
                                rec_cs[at] = (c, s)
                                cnt += 1
                        node = (right[0] if rotated and left[0] == left[1]
                                else left[0], right[1])
                    summ[out + j] = node
                counts.append(cnt)
            offs = np.concatenate([[0], np.cumsum(counts)])
            for t in range(nt):
                for i in range(counts[t]):
                    pos = base + offs[t] + i
                    ra[mb, pos], rb[mb, pos] = rec_ab[t * per + i]
                    rc[mb, pos], rs[mb, pos] = rec_cs[t * per + i]
                    rw[mb, pos] = lvl + 1
            base += int(offs[-1])
            if offs[-1] > 0:
                last_wave = lvl + 1
        nrot[mb], nwave[mb] = base, last_wave
        ra[mb, base:] = rb[mb, base:] = rw[mb, base:] = 0
        rc[mb, base:] = rs[mb, base:] = zero
    return [d_all, z_all, defl_all, ra, rb, rc, rs, rw, nrot, nwave]


def _bit_for_bit(got, ref):
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert np.ascontiguousarray(g).tobytes() == \
            np.ascontiguousarray(r).tobytes(), name


@pytest.mark.parametrize("threads", (None, 32), ids=("plan", "32_threads"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("m", SIZES + (300,))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_model_matches_plain(kind, m, dtype, threads):
    args = _case(kind, 2, m, dtype, seed=m + 1)
    _bit_for_bit(_kernel_model(*args, threads=threads), _plain(*args))


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
       grid=st.sampled_from([0.0, 0.5, 0.1]), threads=st.sampled_from([32, 64,
                                                                        None]))
def test_kernel_model_matches_plain_random(m, k, seed, f32, deflated, grid,
                                           threads):
    """Random masks and poles (on a grid of that spacing, or spread), some
    z exactly zero."""
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
    _bit_for_bit(_kernel_model(*args, threads=threads), _plain(*args))


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


@pytest.mark.parametrize("k, m, threads, levels, shared, scratch", [
    (256, 64, 32, 6, True, 256 * 32 * 24),            # the bottom level
    (1, 16384, 1024, 14, False, 8192 * 24 + 8 * 12288),  # the root
    (2, 8192, 1024, 13, False, 2 * (4096 * 24 + 8 * 6144)),
    (4, 4096, 1024, 12, True, 4 * 2048 * 24),
    (3, 1000, 512, 10, True, 3 * 512 * 24),           # padded to 1024
    (1, 98304, 1024, 17, False, 65536 * 24 + 8 * 98304),  # the CLI's root
    (7, 1, 32, 1, True, 7 * 32 * 24),                 # a record a thread
    (7, 2, 32, 1, True, 7 * 32 * 24),
])
def test_launch_plan(k, m, threads, levels, shared, scratch):
    plan = dtr.launch_plan(k, m)
    assert (plan.grid, plan.threads, plan.levels) == (k, threads, levels)
    assert plan.padded == 1 << levels >= m and plan.shared_summaries == shared
    assert plan.shared_bytes == (
        8 * (plan.padded // 2 + plan.padded // 4) if shared else 0)
    assert plan.shared_bytes <= 48 * 1024           # no opt-in needed
    assert dtr.scratch_bytes(k, m, 8) == scratch
    records = plan.threads * dtr.records_per_thread(plan)
    assert records == max(plan.padded // 2, plan.threads)
    assert dtr.scratch_bytes(k, m, 4) == scratch - 8 * k * records
    assert plan.threads % 32 == 0 and plan.threads & (plan.threads - 1) == 0


@functools.lru_cache(maxsize=None)
def _solver_levels(n):
    """(k, m) of every merge level of a solve at n with 64-wide leaves."""
    out, m = [], 64
    while m <= n:
        out.append((n // m, m))
        m *= 2
    return tuple(out)


def test_launch_plan_over_the_main_path():
    """Every level of an n=16384 solve: one launch a level, a block a merge,
    the shared summaries where the padded width allows."""
    for k, m in _solver_levels(16384):
        plan = dtr.launch_plan(k, m)
        assert plan.grid * m == 16384 and plan.padded == m
        assert plan.shared_summaries == (m <= dtr.SHARED_SUMMARY_SLOTS)
