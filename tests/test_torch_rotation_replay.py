"""PyTorch port, the Givens replays (kernels/rotation_replay.py) on the CPU
against the JAX package's device loops
(``kernels/assemble.py::_replay_rotations_level`` and
``::_replay_rotations_cols_t``), on the real levels of two upsweeps carried
across as numpy arrays: a Poisson n=1024 tear (many rotations, one wave a
level) and a random one (few rotations, chains up to four waves deep).

numpy models of the CUDA kernel's two launch forms (their items, wave
buckets, column tiles and lanes, with the kernel's constants from
``rotation_replay``, and small ones that reach the windowed paths) are held
bit for bit against the plain loops on those levels, in f32 and f64, and on
synthetic logs: merges with no rotation, a log out of wave order, one
longer than a staging window, one deeper than the wave buckets.

The plain version (the wave loop) is held bit for bit, in f32 and f64,
against a numpy loop over each merge's log in reverse order with every
product and sum rounded apart (what the CUDA kernel computes: a wave's
rotations touch disjoint rows, so their order inside a wave changes
nothing).  Against the JAX loop it agrees to 2 ulp of the level's largest
|y| a wave: XLA:CPU contracts c*u_a + s*u_b into a fused multiply-add
(measured: up to 0.5 ulp of max|y| on the Poisson levels, thousands of ulp
of a result that cancels), which the elementwise kernels here and on the
card never do."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu as se
from symmetric_eigenvalue_tpu import driver as jdrv
from symmetric_eigenvalue_tpu.kernels import assemble as jas
from symmetric_eigenvalue_tpu.kernels.secular import MergeRep as JMergeRep
from symmetric_eigenvalue_tpu_torch import interop
from symmetric_eigenvalue_tpu_torch.kernels import assemble as tas
from symmetric_eigenvalue_tpu_torch.kernels import rotation_replay as rr
from symmetric_eigenvalue_tpu_torch.kernels.secular import MergeRep

N = 1024
_J_REPLAY = jax.jit(jas._replay_rotations_level)
_J_REPLAY_T = jax.jit(jax.vmap(jas._replay_rotations_cols_t))
_J_ROWS_LEVEL = jax.jit(jax.vmap(jas.rows_through_merge))


def _input(kind):
    if kind == "poisson":
        return se.create_matrix_scheme2(N)
    rng = np.random.default_rng(5)
    return rng.standard_normal(N) * 5.0, rng.standard_normal(N - 1) * 2.0


@functools.lru_cache(maxsize=2)
def _levels(kind):
    """The upsweep's k-stacked MergeReps of one input, per level (JAX)."""
    d, e = _input(kind)
    cfg = se.SolverConfig(leaf_size=32)
    fn, _plan, leaf_only = jdrv._compiled_upsweep(N, cfg, None)
    assert not leaf_only
    reps = fn(jnp.asarray(d), jnp.asarray(e))[0]
    return [{f: np.asarray(getattr(r, f)) for f in r._fields} for r in reps]


def _sequential(fields, y):
    """Each merge's log in reverse order, one rotation at a time, every
    product and sum rounded apart (numpy), in y's dtype."""
    y = y.copy()
    for b in range(y.shape[0]):
        for i in range(int(fields["nrot"][b]) - 1, -1, -1):
            a, bb = fields["rot_a"][b, i], fields["rot_b"][b, i]
            c = y.dtype.type(fields["rot_c"][b, i])
            s = y.dtype.type(fields["rot_s"][b, i])
            ua, ub = y[b, a].copy(), y[b, bb].copy()
            y[b, a] = c * ua + s * ub
            y[b, bb] = -s * ua + c * ub
    return y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["poisson", "random"])
def test_plain_replay_matches_jax(kind, dtype):
    rng = np.random.default_rng(11)
    rotated = 0
    for fields in _levels(kind):
        k, m = fields["rot_a"].shape
        y = rng.standard_normal((k, m, 6)).astype(dtype)
        rep = interop.merge_rep_from_numpy(fields)
        got = rr.rotation_replay(rep, torch.as_tensor(y.copy())).numpy()
        assert got.dtype == y.dtype
        assert np.array_equal(got, _sequential(fields, y))
        jrep = JMergeRep(**jax.tree.map(jnp.asarray, fields))
        ref = np.asarray(_J_REPLAY(jrep, jnp.asarray(y)))
        tol = 2 * max(int(fields["nwave"].max()), 1) * np.spacing(
            np.abs(y).max())
        assert np.abs(got - ref).max() <= tol
        rotated += int(fields["nrot"].sum())
    assert rotated > 0              # the levels carry real rotations


def test_replay_in_place_and_planned_waves():
    """The replay updates y in place; waves planned once (as the
    downsweep's column chunks use them) give the same result."""
    fields = _levels("random")[-2]
    rep = interop.merge_rep_from_numpy(fields)
    k, m = fields["rot_a"].shape
    y = torch.as_tensor(np.random.default_rng(3).standard_normal((k, m, 4)))
    y2 = y.clone()
    out = rr.rotation_replay(rep, y)
    assert out.data_ptr() == y.data_ptr()
    waves = rr.planned_waves(rep)
    assert isinstance(waves, list) and waves
    assert torch.equal(rr.rotation_replay(rep, y2, waves), y)


def test_replay_rejects_bad_inputs():
    rep = interop.merge_rep_from_numpy(_levels("random")[0])
    k, m = rep.rot_a.shape
    with pytest.raises(ValueError):
        rr.rotation_replay(rep, torch.zeros((k, m + 1, 2)))
    with pytest.raises(TypeError):
        rr.rotation_replay(rep, torch.zeros((k, m, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        rr._launch(rep, torch.zeros((k, m, 2)))       # not a CUDA tensor


def test_no_rotation_is_identity():
    fields = dict(_levels("random")[0])
    fields["nrot"] = np.zeros_like(fields["nrot"])
    rep = interop.merge_rep_from_numpy(fields)
    k, m = rep.rot_a.shape
    y = torch.as_tensor(np.random.default_rng(4).standard_normal((k, m, 3)))
    assert torch.equal(rr.rotation_replay(rep, y.clone()), y)
    assert rr.rotation_waves(rep) == []


# --------------------------------------------------------------------------
# the transposed form's plain version and rows_through_merge against JAX


def _wt(w):
    """(k, r, m) boundary rows as the transposed form takes them: (k, m, r)
    contiguous."""
    return torch.as_tensor(np.ascontiguousarray(w.transpose(0, 2, 1)))


@pytest.mark.parametrize("kind", ["poisson", "random"])
def test_plain_transposed_replay_and_rows_match_jax(kind):
    """The plain transposed chain against JAX ``_replay_rotations_cols_t``
    (2 ulp of max|w| a wave: XLA:CPU's FMA, as above) and
    ``rows_through_merge`` (through ``rotation_replay_t``) against JAX's
    (1e-13 of the result's scale, as tests/test_torch_assemble.py holds it)
    on every non-root level."""
    rng = np.random.default_rng(12)
    for fields in _levels(kind)[:-1]:
        k, m = fields["rot_a"].shape
        w = rng.standard_normal((k, 2, m))
        rep = interop.merge_rep_from_numpy(fields)
        jrep = JMergeRep(**jax.tree.map(jnp.asarray, fields))
        got = rr.rotation_replay_t(rep, _wt(w)).numpy().transpose(0, 2, 1)
        ref = np.asarray(_J_REPLAY_T(jrep, jnp.asarray(w)))
        tol = 2 * max(int(fields["nwave"].max()), 1) * np.spacing(
            np.abs(w).max())
        assert np.abs(got - ref).max() <= tol
        rows = tas.rows_through_merge(rep, torch.as_tensor(w)).numpy()
        ref = np.asarray(_J_ROWS_LEVEL(jrep, jnp.asarray(w)))
        assert np.abs(rows - ref).max() <= 1e-13 * np.abs(ref).max()


# --------------------------------------------------------------------------
# numpy models of the kernel's launch forms


def _rot(x, a, b, c, s, transposed):
    """One wave's rotations at once on the rows (a, b) of x, every product
    and sum rounded apart in x's dtype; the wave's rows must be disjoint
    (what lets the kernel's lanes and unrolled loads take them at once)."""
    assert len(set(a.tolist()) | set(b.tolist())) == 2 * len(a)
    c = c.astype(x.dtype)[:, None]
    s = s.astype(x.dtype)[:, None]
    ua, ub = x[a].copy(), x[b].copy()
    if transposed:
        x[a] = c * ua - s * ub
        x[b] = s * ua + c * ub
    else:
        x[a] = c * ua + s * ub
        x[b] = -s * ua + c * ub


def _buckets(wave, lo, hi, nw, *, stage, waves, transposed, rng):
    """An item's log entries [lo, hi) as the kernel stages them: lists of
    entry indices, each one wave's, in replay order, each in an order the
    shared atomics might give (any).  One wave: the range as it is; a log
    within ``stage`` entries and ``waves`` buckets: a counting sort by wave
    (out-of-range waves clamped into the buckets, as ``bucket``); longer or
    deeper: a wave at a time, the log scanned in windows of ``stage``."""
    if nw <= 1:
        out = [np.arange(lo, hi)]
    elif hi - lo <= stage and nw <= waves:
        bk = np.clip(wave[lo:hi], 1, waves) - 1
        order = range(waves) if transposed else range(waves - 1, -1, -1)
        out = [lo + np.flatnonzero(bk == w) for w in order]
    else:
        order = range(1, nw + 1) if transposed else range(nw, 0, -1)
        out = [base + np.flatnonzero(wave[base:min(base + stage, hi)] == w)
               for w in order for base in range(lo, hi, stage)]
    return [rng.permutation(x) for x in out if len(x)]


def _rows_model(fields, y, *, grid, threads=rr.THREADS, vec=1,
                slice_=rr.SLICE, stage=rr.STAGE, waves=rr.WAVES, seed=0):
    """The downsweep form's schedule on y (k, m, C): ``grid`` blocks (run
    in a random order), each walking the merges ``threads`` at a time,
    scanning their items (column tiles times slices) and taking every
    grid-th item; an item's threads apply its staged buckets to their
    columns.  Returns y and how often each (merge, rotation, tile) ran."""
    k, m, C = y.shape
    y = y.copy()
    nrot, nwave = fields["nrot"], fields["nwave"]
    tw = threads * vec
    ntile = -(-C // tw)
    ran = np.zeros((k, m, ntile), np.int64)
    rng = np.random.default_rng(seed)

    def items(b):
        if b >= k or nrot[b] <= 0:
            return 0
        return ntile * (-(-int(nrot[b]) // slice_) if nwave[b] <= 1 else 1)

    for g in rng.permutation(grid):
        base = 0
        for c0 in range(0, k, threads):
            end = np.cumsum([items(b) for b in range(c0, c0 + threads)])
            j = base + (g - base % grid) % grid
            while j < base + end[-1]:
                local = j - base
                t = int(np.searchsorted(end, local, side="right"))
                within = local - (end[t - 1] if t else 0)
                b, tile, sl = c0 + t, within % ntile, within // ntile
                nr, nw = int(nrot[b]), int(nwave[b])
                lo, hi = (sl * slice_, min(nr, (sl + 1) * slice_)) \
                    if nw <= 1 else (0, nr)
                cols = slice(tile * tw, min(C, (tile + 1) * tw))
                for bucket in _buckets(fields["rot_wave"][b], lo, hi, nw,
                                       stage=stage, waves=waves,
                                       transposed=False, rng=rng):
                    view = y[b, :, cols]
                    _rot(view, fields["rot_a"][b, bucket],
                         fields["rot_b"][b, bucket],
                         fields["rot_c"][b, bucket],
                         fields["rot_s"][b, bucket], False)
                    ran[b, bucket, tile] += 1
                j += grid
            base += end[-1]
    return y, ran


def _cols_t_model(fields, wt, *, grid, threads=rr.THREADS,
                  stage=rr.STAGE_T, waves=rr.WAVES, seed=0):
    """The transposed form's schedule on wt (k, m, r): block g takes merges
    g, g + grid, ...; the block's lanes take a wave's rotations (thread t
    the bucket's entries t, t + threads, ...), a barrier between waves.
    Returns wt and how often each (merge, rotation) ran."""
    k, m, r = wt.shape
    wt = wt.copy()
    ran = np.zeros((k, m), np.int64)
    rng = np.random.default_rng(seed)
    for g in rng.permutation(grid):
        for b in range(g, k, grid):
            nr, nw = int(fields["nrot"][b]), int(fields["nwave"][b])
            if nr <= 0:
                continue
            for bucket in _buckets(fields["rot_wave"][b], 0, nr, nw,
                                   stage=stage, waves=waves, transposed=True,
                                   rng=rng):
                lanes = np.concatenate([bucket[t::threads]
                                        for t in range(threads)])
                _rot(wt[b], fields["rot_a"][b, lanes],
                     fields["rot_b"][b, lanes], fields["rot_c"][b, lanes],
                     fields["rot_s"][b, lanes], True)
                ran[b, lanes] += 1
    return wt, ran


def _logged(fields):
    """(k, m) mask of the logged rotations."""
    k, m = fields["rot_a"].shape
    return np.arange(m)[None, :] < fields["nrot"][:, None]


def _synthetic_level(seed=3):
    """A level of k=4 merges of m=1024 whose logs are valid (a wave's rows
    disjoint) but out of wave order: merge 0 has no rotation, merge 1 a
    chain 40 waves deep (past the 32 buckets), merge 2 one wave of 100
    rotations (four 32-rotation slices), merge 3 a 600-entry log over 5
    waves (past the 512-entry stage)."""
    rng = np.random.default_rng(seed)
    k, m = 4, 1024
    a = np.zeros((k, m), np.int64)
    b = np.zeros((k, m), np.int64)
    w = np.zeros((k, m), np.int64)
    nrot = np.zeros(k, np.int64)
    for mb, per_wave in ((1, [3] * 40), (2, [100]), (3, [120] * 5)):
        rows = []
        for wave, n in enumerate(per_wave, start=1):
            pick = rng.permutation(m)[:2 * n]
            rows += [(p, q, wave) for p, q in pick.reshape(n, 2)]
        rows = [rows[i] for i in rng.permutation(len(rows))]
        n = len(rows)
        a[mb, :n], b[mb, :n], w[mb, :n] = np.array(rows).T
        nrot[mb] = n
    theta = rng.uniform(0, 2 * np.pi, (k, m))
    fields = {f: np.zeros((k, m)) for f in MergeRep._fields}
    fields.update(K=np.zeros(k, np.int64), rho=np.zeros(k), rot_a=a,
                  rot_b=b, rot_wave=w, rot_c=np.cos(theta),
                  rot_s=np.sin(theta), nrot=nrot,
                  nwave=np.where(nrot > 0, w.max(axis=1), 0))
    for f in ("shift_idx", "p12", "colperm"):
        fields[f] = np.zeros((k, m), np.int64)
    return fields


_SMALL = dict(threads=2, slice_=3, stage=4, waves=3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["poisson", "random", "synthetic"])
@pytest.mark.parametrize("consts", ["kernel", "small"])
def test_rows_model_matches_plain(kind, dtype, consts):
    """The downsweep form's schedule (the kernel's constants, 16-byte
    columns where the dtype allows; or small ones: 2 threads, 3-rotation
    slices, 4-entry stages, 3 buckets, a ragged last tile) is the plain
    wave loop bit for bit, and runs every logged rotation once a tile."""
    levels = [_synthetic_level()] if kind == "synthetic" else _levels(kind)
    rng = np.random.default_rng(21)
    kw = dict(vec=4 if dtype == np.float32 else 2, grid=7) \
        if consts == "kernel" else dict(_SMALL, vec=2, grid=5)
    C = 9 if consts == "small" else 8
    for fields in levels:
        k, m = fields["rot_a"].shape
        y = rng.standard_normal((k, m, C)).astype(dtype)
        got, ran = _rows_model(fields, y, **kw)
        rep = interop.merge_rep_from_numpy(fields)
        ref = rr.rotation_replay(rep, torch.as_tensor(y.copy())).numpy()
        assert np.array_equal(got, ref)
        assert np.array_equal(ran, np.repeat(_logged(fields)[:, :, None],
                                             ran.shape[2], axis=2))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["poisson", "random", "synthetic"])
@pytest.mark.parametrize("consts", ["kernel", "small"])
def test_cols_t_model_matches_plain(kind, dtype, consts):
    """The transposed form's schedule (lanes over a wave's rotations; the
    kernel's constants, or 2 threads, 4-index stages and 3 buckets) is the
    plain transposed loop bit for bit, r = 2 and 1, each logged rotation
    once."""
    levels = [_synthetic_level()] if kind == "synthetic" else _levels(kind)
    rng = np.random.default_rng(22)
    kw = dict(grid=3) if consts == "kernel" else dict(
        grid=2, threads=2, stage=4, waves=3)
    for fields in levels:
        k, m = fields["rot_a"].shape
        rep = interop.merge_rep_from_numpy(fields)
        for r in (2, 1):
            wt = rng.standard_normal((k, m, r)).astype(dtype)
            got, ran = _cols_t_model(fields, wt, **kw)
            ref = rr.rotation_replay_t(rep, torch.as_tensor(wt.copy()))
            assert np.array_equal(got, ref.numpy())
            assert np.array_equal(ran, _logged(fields).astype(np.int64))


def test_synthetic_level_reaches_every_path():
    """The synthetic level exercises what the real ones do not: a merge
    with no rotation, a chain deeper than the buckets and a log longer than
    a downsweep stage (the windowed scans), a one-wave log of several
    slices."""
    f = _synthetic_level()
    assert f["nrot"][0] == 0
    assert f["nwave"][1] > rr.WAVES
    assert f["nrot"][3] > rr.STAGE and 1 < f["nwave"][3] <= rr.WAVES
    assert f["nwave"][2] == 1 and f["nrot"][2] > rr.SLICE
    # the real levels' logs are in wave order; this one is not
    w = f["rot_wave"][1, :f["nrot"][1]]
    assert (np.diff(w) < 0).any()


def test_launch_plans():
    occ = rr.Occupancy(registers=40, local_bytes=0, blocks_per_sm=4,
                       sms=132, shared_bytes=17000)
    assert rr.column_tiles(8192, 4) == 8 and rr.column_tiles(8191, 1) == 32
    # what the SMs hold, or the level's most items
    assert rr.launch_plan(256, 64, 8192, 4, occ) == 528
    assert rr.launch_plan(1, 64, 100, 1, occ) == -(-64 // rr.SLICE)
    assert rr.launch_plan(2, 130, 100, 1, occ) == 2 * -(-130 // rr.SLICE)
    assert rr.launch_plan_t(256, occ) == 256
    assert rr.launch_plan_t(10 ** 6, occ) == 528
    y32 = torch.zeros((2, 3, 8), dtype=torch.float32)
    assert rr.row_vec(y32) == 4
    assert rr.row_vec(torch.zeros((2, 3, 6), dtype=torch.float32)) == 1
    assert rr.row_vec(torch.zeros((2, 3, 6), dtype=torch.float64)) == 2
    assert rr.row_vec(torch.zeros((2, 3, 9), dtype=torch.float64)) == 1


def test_transposed_wrapper_cpu_path_and_errors():
    fields = _levels("random")[1]
    rep = interop.merge_rep_from_numpy(fields)
    k, m = rep.rot_a.shape
    wt = torch.as_tensor(np.random.default_rng(6).standard_normal((k, m, 2)))
    ref = wt.clone()
    out = rr.rotation_replay_t(rep, wt)
    assert out.data_ptr() == wt.data_ptr()          # in place
    rr.replay_waves_t(rr.rotation_waves(rep), ref.view(k * m, 2))
    assert torch.equal(out, ref)
    waves = rr.planned_waves(rep)
    again = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (k, m, 2)))
    assert torch.equal(rr.rotation_replay_t(rep, again, waves), ref)
    with pytest.raises(ValueError):
        rr.rotation_replay_t(rep, torch.zeros((k, m, 3)))       # r > 2
    with pytest.raises(ValueError):
        rr.rotation_replay_t(rep, torch.zeros((k, m + 1, 2)))
    with pytest.raises(ValueError):
        rr.rotation_replay_t(rep, torch.zeros((k, m)))
    with pytest.raises(TypeError):
        rr.rotation_replay_t(rep, torch.zeros((k, m, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        rr._launch(rep, torch.zeros((k, m, 2)), transposed=True)
