"""PyTorch port, dword_vecmat: the plain version (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode, to 1e-13 of
max_j sum_i |v_i||A_ij| (the JAX kernel is ~2^-48-grade, the port native
f64), the wrapper's input checks, the launch geometry it computes, and the
kernel's reading of rows that do not start on a 16-byte boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import symmetric_eigenvalue_tpu.kernels.pallas.dword_matvec as jdv
from symmetric_eigenvalue_tpu.kernels.pallas.cauchy_matmul import split_f64
from symmetric_eigenvalue_tpu_torch.kernels import dword_matvec as tdv


@pytest.fixture
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jdv.pl, "pallas_call", patched)


def _jax_vecmat(v, A):
    Ah, Al = split_f64(jnp.asarray(A))
    return np.asarray(jdv.dword_vecmat(jnp.asarray(v), Ah, Al, ti=256,
                                       tj=512))


def _cases(rng, name):
    n, m = 512, 512
    if name == "random":
        return rng.standard_normal(n), rng.standard_normal((n, m))
    if name == "reflector":
        # leading zeros and a unit entry, as a Householder vector has them
        v = rng.standard_normal(n)
        v[:100] = 0.0
        v[100] = 1.0
        A = rng.standard_normal((n, m))
        return v, (A + A.T) / 2
    # adversarial cancellation: entries paired to nearly cancel, so the
    # result is ~1e-8 times smaller than the terms
    A = rng.standard_normal((n // 2, m))
    return np.ones(n), np.concatenate([A, -A * (1.0 + 1e-8)], axis=0)


@pytest.mark.parametrize("name", ["random", "reflector", "cancellation"])
def test_plain_matches_interpreted_jax(interpreted, rng, name):
    v, A = _cases(rng, name)
    ref = _jax_vecmat(v, A)
    y = tdv.dword_vecmat(torch.as_tensor(v), torch.as_tensor(A)).numpy()
    exact = np.asarray(v, np.longdouble) @ np.asarray(A, np.longdouble)
    scale = (np.abs(v) @ np.abs(A)).max()
    assert np.abs(y - ref).max() <= 1e-13 * scale
    assert np.abs(y - np.asarray(exact, np.float64)).max() <= 1e-13 * scale


def test_views_and_rectangles(rng):
    """A trailing-submatrix view (row stride > width) and a non-square A go
    through unchanged; a transposed A (non-unit column stride) as well."""
    big = torch.as_tensor(rng.standard_normal((70, 90)))
    v = torch.as_tensor(rng.standard_normal(50))
    A = big[20:, 30:]
    assert not A.is_contiguous()
    y = tdv.dword_vecmat(v, A)
    assert y.shape == (60,)
    assert torch.allclose(y, v @ A.contiguous(), rtol=0, atol=1e-13)
    At = big[:50, :60].T                     # (60, 50), column stride 90
    y = tdv.dword_vecmat(torch.as_tensor(rng.standard_normal(60)), At)
    assert y.shape == (50,)
    assert tdv.launches == 0


def test_rejects_bad_inputs():
    v = torch.zeros(3, dtype=torch.float64)
    A = torch.zeros((3, 4), dtype=torch.float64)
    with pytest.raises(ValueError):
        tdv.dword_vecmat(v, A.T)
    with pytest.raises(ValueError):
        tdv.dword_vecmat(v[None], A)
    with pytest.raises(ValueError):
        tdv.dword_vecmat(v, A[0])
    with pytest.raises(TypeError):
        tdv.dword_vecmat(v.float(), A.float())
    with pytest.raises(TypeError):
        tdv.dword_vecmat(v, A.float())
    with pytest.raises(ValueError, match="one device"):
        tdv.dword_vecmat(v, A.to("meta"))


def test_non_cpu_tensor_goes_to_the_launch():
    """Only a CPU tensor takes the plain version: any other device reaches
    the launch, which takes CUDA alone."""
    v = torch.empty(8, dtype=torch.float64, device="meta")
    A = torch.empty((8, 8), dtype=torch.float64, device="meta")
    before = tdv.launches
    with pytest.raises(ValueError, match="unsupported device"):
        tdv.dword_vecmat(v, A)
    assert tdv.launches == before


@pytest.mark.parametrize("rows,cols", [(16384, 16384), (16383, 16384),
                                       (4096, 4096), (1, 4096), (63, 5),
                                       (100000, 300), (3668, 4001)])
def test_row_chunks_cover_the_rows(rows, cols):
    """The launch geometry: chunks of whole 8-row steps (at most 2048 rows,
    v's slice in shared memory), every row in exactly one chunk, 256-column
    tiles, and whole waves of the blocks the card holds at once (132 SMs,
    4 blocks each): one wave where A is small, and no last wave run by a
    few blocks alone."""
    sms, per_sm = 132, 4
    plan = tdv._plan(rows, cols, sms, per_sm)
    per, chunks = plan.rows_per_chunk, plan.chunks
    assert per % 8 == 0 and 8 <= per <= 2048
    assert (chunks - 1) * per < rows <= chunks * per
    assert (plan.col_tiles - 1) * 256 < cols <= plan.col_tiles * 256
    blocks, full = chunks * plan.col_tiles, sms * per_sm
    last = blocks % full
    assert blocks <= full or last == 0 or last >= full // 2
    if rows * cols <= 4096 * 4096:
        assert blocks <= full
    if rows >= 4096 and cols >= 4096:
        assert blocks >= full * 0.9


def _row_loads(head, cols, tile):
    """A model of how csrc/dword_matvec.cu reads one row of a 256-column
    tile (``load_row`` and ``row_columns``), thread by thread: the element
    indices of its 16-byte load (a pair at c, or at c + 1 in a row that
    starts 8 bytes past a 16-byte boundary; one element at the ragged
    edge; or none), of its head element (lane 0 of a warp, unaligned rows
    only), and of the two values it takes as its columns c, c + 1 (the
    first from its left lane's pair, by a shuffle, in an unaligned row)."""
    loads = []
    for t in range(128):
        c = tile * 256 + 2 * t
        j = c + head
        load = (j, j + 1) if j + 1 < cols else (j,) if j < cols else ()
        head_el = (c,) if head and t % 32 == 0 and c < cols else ()
        loads.append((c, load, head_el))
    out = []
    for t, (c, load, head_el) in enumerate(loads):
        x, y = (load + (None, None))[:2]
        if head:
            left = (loads[t - 1][1] + (None, None))[1] if t % 32 else None
            columns = ((head_el + (None,))[0] if t % 32 == 0 else left, x)
        else:
            columns = (x, y)
        out.append({"c": c, "load": load, "head": head_el,
                    "columns": columns})
    return out


@pytest.mark.parametrize("head", [0, 1])
@pytest.mark.parametrize("cols,tile", [(256, 0), (4001, 15), (4001, 3),
                                       (255, 0), (2, 0), (1, 0), (513, 2)])
def test_row_loads_cover_each_column_once(head, cols, tile):
    """Every 16-byte load of the kernel's row reading starts on a 16-byte
    boundary (element index + head even), no load reaches past the row,
    and each thread's two columns come out as its own columns, whether the
    row is aligned (head 0) or starts 8 bytes past a boundary (head 1: an
    odd row stride or column offset)."""
    threads = _row_loads(head, cols, tile)
    seen = []
    for t in threads:
        c = t["c"]
        if len(t["load"]) == 2:
            assert (t["load"][0] + head) % 2 == 0
        assert all(0 <= j < cols for j in t["load"] + t["head"])
        for h, got in enumerate(t["columns"]):
            if c + h < cols:
                assert got == c + h
                seen.append(got)
    lo, hi = tile * 256, min(cols, tile * 256 + 256)
    assert sorted(seen) == list(range(lo, hi))
    heads = [t["head"] for t in threads if t["head"]]
    assert all(h == (threads[32 * w]["c"],)
               for w, h in enumerate(heads)) if head else heads == []


@pytest.mark.parametrize("lda,offset", [(4001, 0), (4001, 333), (4096, 1),
                                        (4096, 512), (16448, 63)])
def test_views_give_both_row_kinds(lda, offset):
    """The rows the kernel meets in the dense reduction's views (A[j+1:]
    of a bucket, any column offset): an odd row stride alternates aligned
    and unaligned rows, an even one keeps the first row's kind; the model
    above covers both kinds in every such row."""
    base = torch.zeros((6, lda), dtype=torch.float64)
    A = base[1:, offset:]
    heads = [(A[r].data_ptr() // 8) % 2 for r in range(5)]
    if lda % 2:
        assert heads[0] != heads[1] and heads[0] == heads[2]
    else:
        assert len(set(heads)) == 1
    for h in set(heads):
        cols = A.shape[1]
        for tile in (0, (cols - 1) // 256):
            got = sorted(c for t in _row_loads(h, cols, tile)
                         for k, c in enumerate(t["columns"])
                         if t["c"] + k < cols)
            assert got == list(range(tile * 256, min(cols, tile * 256 + 256)))
