"""PyTorch port: the two-stage backtransform's blocked wave loop
(kernels/band_reduce.py::apply_q2_wave_blocked, q2_blocks_t, q2_apply;
csrc/q2_apply.cu and q2_blocks_t in csrc/householder_panel.cu) on the CPU:
the plain versions against the JAX package's apply_q2_wave_blocked and
against torch.ormqr, the device schedule's closed form against the host
plan, the chunks of waves and their stores' bytes, the batched T against
the reference's inverse form and larft, a numpy model of the kernel's tile
against the plain wave, and the CUDA wrappers' launches with the card's
calls faked."""

import contextlib
import ctypes
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetric_eigenvalue_tpu.kernels import band_reduce as jband
from symmetric_eigenvalue_tpu_torch import _build
from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as tband
from symmetric_eigenvalue_tpu_torch.kernels.householder_panel import larft_plain


def _band(rng, n, b, zero=None):
    """A random symmetric band-b matrix; ``zero`` (lo, hi): rows and columns
    lo..hi-1 zeroed, so the chase meets columns with nothing to annihilate
    (sigma2 = 0: identity reflectors, tau = 0 and v = 0, inside the log)."""
    A = rng.standard_normal((n, n))
    A = (A + A.T) / 2
    i = np.arange(n)
    A[np.abs(i[:, None] - i[None, :]) > b] = 0.0
    if zero is not None:
        A[zero[0]:zero[1], :] = 0.0
        A[:, zero[0]:zero[1]] = 0.0
    return A


def _log(rng, n, b, zero=None):
    A = _band(rng, n, b, zero)
    _, _, (Vw, tw) = tband.band_to_tridiag_wave(torch.as_tensor(A), b)
    return A, Vw, tw


def _whole(n, b):
    """One chunk holding every wave, as many slots a wave as the widest."""
    sizes = tband.q2_wave_sizes(n, b)
    return tband.Q2Chunk(0, len(sizes), int(sizes.max()))


def _chunk_of(chunks, w):
    return next(c for c in chunks if c.w0 <= w < c.w1)


def _keep(n, b, w):
    """The host plan of apply_q2_wave_blocked_plain for wave w: the live
    blocks' (J, k) (the JAX wave body's valid mask, less the blocks whose
    first reflector lies past the matrix)."""
    Kmax, _, _ = tband._wave_geometry(n, b)
    nJ = -(-(n - 2) // b)
    s = np.arange(max(0, (w - Kmax + 2) // 2), w // 2 + 1)
    J, k = nJ - 1 - s, w - 2 * s
    keep = (J >= 0) & (k >= 0) & (k <= Kmax - 1) & (J * b + k * b + 2 <= n - 1)
    return J[keep], k[keep]


# --------------------------------------------------------------------------
# the plain version against the JAX package


@pytest.mark.parametrize("C", [3, 40])
@pytest.mark.parametrize("n,b", [(23, 2), (40, 3), (38, 5), (61, 8), (66, 8),
                                 (90, 16)])
def test_plain_matches_jax(rng, n, b, C):
    """apply_q2_wave_blocked_plain (and the CPU wrapper, with and without
    overwrite) against the JAX package's apply_q2_wave_blocked of the same
    log, at (n - 2) % b != 0 (the last chunk of sweeps clamped to the log's
    zero row n - 2) except (66, 8), narrow and wide X: within 1e-12, a few
    hundred roundings of entries of size ~1 through orthogonal blocks."""
    A = _band(rng, n, b)
    _, _, (Vj, tj) = jband.band_to_tridiag_wave(jnp.asarray(A), b)
    Vw, tw = (torch.as_tensor(np.array(x)) for x in (Vj, tj))
    X = rng.standard_normal((n, C))
    ref = np.asarray(jband.apply_q2_wave_blocked(n, b, (Vj, tj),
                                                 jnp.asarray(X)))
    got = tband.apply_q2_wave_blocked_plain(n, b, (Vw, tw),
                                            torch.as_tensor(X.copy()))
    assert np.abs(got.numpy() - ref).max() <= 1e-12
    Xt = torch.as_tensor(X.copy())
    out = tband.apply_q2_wave_blocked(n, b, (Vw, tw), Xt)
    assert out is not Xt and np.array_equal(Xt.numpy(), X)
    assert torch.equal(out, got)
    same = tband.apply_q2_wave_blocked(n, b, (Vw, tw), Xt, overwrite=True)
    assert same is Xt and torch.equal(Xt, got)


# --------------------------------------------------------------------------
# the device schedule


@pytest.mark.parametrize("n,b", [(4096, 128), (4096, 16), (3, 2), (10, 2),
                                 (37, 5), (100, 3), (130, 16), (1000, 7)])
def test_wave_range_matches_the_host_plan(n, b):
    """q2_wave_range's closed form (the kernel's) against the host plan of
    every wave, in its int and array forms; every live block (J, k) in
    exactly one wave at wave k + 2 (nJ - 1 - J), Kmax (Kmax + 1) / 2 of
    them, each wave's blocks 3b rows apart; q2_wave_sizes each wave's
    count and q2_wave_count the waves with a live block; q2_chunk_blocks of
    one chunk holding every wave gives each block once, wave w's at slots
    w S .. w S + count - 1 in the order of s."""
    Kmax, _, _ = tband._wave_geometry(n, b)
    nJ = -(-(n - 2) // b)
    waves = Kmax + 2 * nJ - 2
    lo, hi = tband.q2_wave_range(n, b, np.arange(waves))
    seen, live = set(), 0
    for w in range(waves):
        J, k = _keep(n, b, w)
        s_lo, s_hi = tband.q2_wave_range(n, b, w)
        assert (s_lo, s_hi) == (int(lo[w]), int(hi[w]))
        s = np.arange(s_lo, s_hi + 1)
        assert np.array_equal(nJ - 1 - s, J) and np.array_equal(w - 2 * s, k)
        base = J * b + k * b + 1
        assert np.all(np.diff(base) == -3 * b)
        live += len(J) > 0
        assert tband.q2_wave_sizes(n, b)[w] == len(J)
        for pair in zip(J.tolist(), k.tolist()):
            assert pair not in seen
            seen.add(pair)
    assert len(tband.q2_wave_sizes(n, b)) == 3 * Kmax - 2 >= waves
    assert tband.q2_wave_count(n, b) == live
    assert len(seen) == tband.q2_block_count(n, b) == Kmax * (Kmax + 1) // 2
    chunk = _whole(n, b)
    slot, tJ, tk = (a.numpy() for a in tband.q2_chunk_blocks(
        n, b, chunk, torch.device("cpu")))
    assert sorted(zip(tJ.tolist(), tk.tolist())) == sorted(seen)
    assert np.all(np.diff(slot) > 0)
    for w in range(waves):
        J, k = _keep(n, b, w)
        at = slot // chunk.S == w
        assert np.array_equal(slot[at], w * chunk.S + np.arange(len(J)))
        assert np.array_equal(tJ[at], J) and np.array_equal(tk[at], k)


def test_wave_and_block_counts():
    """The counts chip_smoke.py requires of a two-stage solve and the PERF
    shapes: waves with a live block (one q2_apply launch each) and blocks
    (one T each) at n=4096 and 16384, band 128 and u=16; none below n=3 or
    b=2."""
    assert [(tband.q2_wave_count(n, b), tband.q2_block_count(n, b))
            for n, b in ((4096, 128), (4096, 16), (16384, 128),
                         (16384, 16))] == [(93, 528), (765, 32896),
                                           (381, 8256), (3069, 524800)]
    assert tband.q2_wave_count(2, 4) == tband.q2_block_count(40, 1) == 0


# --------------------------------------------------------------------------
# the chunks of waves: the stores' bytes


@pytest.mark.parametrize("n,b,budget", [
    (16384, 2, None), (16384, 3, None), (16384, 4, None), (16384, 16, None),
    (16384, 128, None), (4096, 128, None), (4096, 16, None),
    (300, 16, 40000), (61, 8, 9000), (1000, 7, 1)])
def test_chunks_cover_every_wave_within_budget(n, b, budget):
    """q2_chunks cuts the waves into chunks in order, each the waves w0 ..
    w1 - 1, every wave with a live block in exactly one (a chunk of dead
    waves alone is left out), S its widest wave's count, its stores (w1 - w0) S slot bytes within the
    budget unless it is one wave; every wave with a live block in one
    chunk.  At the default budget (q2_store_budget: n^2 / 2 doubles, half an
    n x n X) the stores stay there whatever b, where every block at once
    took (16/b)^2 n^2 / 2 doubles below b = 16 (137 GB at n = 16384, b = 2)."""
    sizes = tband.q2_wave_sizes(n, b)
    slot = tband._q2_slot_bytes(b, False)
    budget = tband.q2_store_budget(n) if budget is None else budget
    chunks = tband.q2_chunks(n, b, slot, budget)
    covered = np.zeros(len(sizes), dtype=np.int64)
    for c in chunks:
        covered[c.w0:c.w1] += 1
    assert np.all(covered[sizes > 0] == 1) and covered.max() == 1
    assert all(p.w1 <= c.w0 for p, c in zip(chunks, chunks[1:]))
    for c in chunks:
        assert c.S == int(sizes[c.w0:c.w1].max()) >= 1
        assert (c.w1 - c.w0) * c.S * slot <= budget or c.w1 - c.w0 == 1
        assert c.w1 - c.w0 <= 65535
    if budget == tband.q2_store_budget(n) and n == 16384:
        assert budget == 4 * n * n
        every = tband.q2_block_count(n, b) * slot
        assert every > 2 * budget      # all at once would pass the budget
        assert len(chunks) >= every // budget


def _inverse_form_t(n, b, Vw, tw):
    """Every block's T the way the JAX package and the plain loop make it:
    T^{-1} = diag(1/tau) + striu(Y^T Y), 1/tau read as 1 where tau = 0;
    with the blocks' slots in :func:`_whole`'s chunk."""
    slot, J, k = tband.q2_chunk_blocks(n, b, _whole(n, b), Vw.device)
    Y, sw = tband._q2_y(n, b, Vw, J, k)
    tau = tw[sw, k[:, None]]
    nz = tau != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, tau, 1.0), 1.0)
    eye = torch.eye(b, dtype=Vw.dtype)
    Tinv = torch.bmm(Y.transpose(1, 2), Y).triu(1) + torch.diag_embed(inv)
    return torch.linalg.solve_triangular(Tinv, eye.expand_as(Tinv),
                                         upper=True), Y, tau, slot, J


@pytest.mark.parametrize("n,b,zero", [(60, 6, (20, 35)), (47, 4, (10, 24)),
                                      (41, 5, None)])
def test_blocks_t_plain_matches_inverse_form_and_larft(rng, n, b, zero):
    """q2_blocks_t_plain (larft's recurrence over the Gram from Y's band
    structure) against the inverse form and against larft_plain of each
    block's Gram, on logs with identity reflectors inside live blocks (a
    band matrix with a zero block: sigma2 = 0) and without: the recurrence
    gives T[i, i] = 0 at an identity reflector where the inverse form gives
    1, and agrees everywhere else within 1e-13 max|T|; I - Y T Y^T agrees
    within 1e-13 (an identity reflector's v is all zero, so its T entry
    multiplies nothing); against larft_plain within 1e-14 max|T| (the same
    recurrence, batched sums)."""
    _, Vw, tw = _log(rng, n, b, zero)
    chunk = _whole(n, b)
    Tt, Yt, got = tband.q2_blocks_t_plain(n, b, Vw, tw, chunk)
    assert got == chunk
    Tinv, Y, tau, slot, J = _inverse_form_t(n, b, Vw, tw)
    # the stores: 16 x 4 tiles of the zero-padded T and Y^T, a slot past
    # its wave's blocks zero
    wr, ys = (b + 15) & ~15, tband._q2_y_stride(b)
    slots = (chunk.w1 - chunk.w0) * chunk.S
    assert Tt.shape == (slots, wr // 16, wr // 4, 16, 4)
    assert Yt.shape == (slots, wr // 16, ys // 4, 16, 4)
    Tp, Ys = tband._untile(Tt), tband._untile(Yt)
    assert torch.equal(tband._tile(Ys), Yt)
    empty = torch.ones(slots, dtype=torch.bool)
    empty[slot] = False
    assert Tp[empty].abs().sum() == 0 and Ys[empty].abs().sum() == 0
    Tp, Ys = Tp[slot], Ys[slot]
    assert torch.equal(Ys[:, :b, :2 * b - 1], Y.transpose(1, 2))
    assert Ys[:, b:].abs().sum() == 0 and Ys[:, :, 2 * b - 1:].abs().sum() == 0
    assert Tp[:, b:].abs().sum() == 0 and Tp[:, :, b:].abs().sum() == 0
    T = Tp[:, :b, :b]
    ident = tau == 0
    live = (J[:, None] * b + torch.arange(b)) <= n - 3     # real sweeps
    if zero is not None:
        # identity reflectors of real sweeps and hops, inside live blocks
        assert (ident & live).any()
        vnorm = torch.linalg.vector_norm(Y, dim=1)
        assert torch.all(vnorm[ident] == 0)
    scale = float(T.abs().max())
    diag = torch.diagonal(T, dim1=1, dim2=2)
    assert torch.all(diag[ident] == 0)
    assert torch.all(torch.diagonal(Tinv, dim1=1, dim2=2)[ident] == 1)
    off = ~torch.diag_embed(ident)
    assert float((T - Tinv)[off].abs().max()) <= 1e-13 * scale
    assert torch.equal(torch.tril(T, -1), torch.zeros_like(T))
    Q = torch.bmm(Y, torch.bmm(T, Y.transpose(1, 2)))
    Qinv = torch.bmm(Y, torch.bmm(Tinv, Y.transpose(1, 2)))
    assert float((Q - Qinv).abs().max()) <= 1e-13
    G = torch.bmm(Y.transpose(1, 2), Y)
    for s in range(T.shape[0]):
        assert float((T[s] - larft_plain(G[s], tau[s])).abs().max()) \
            <= 1e-14 * scale


# --------------------------------------------------------------------------
# one wave against LAPACK's ormqr


@pytest.mark.parametrize("n,b,C,zero", [(61, 8, 9, None), (90, 16, 5, None),
                                        (60, 6, 7, (20, 35)), (41, 3, 4, None)])
def test_one_wave_against_ormqr(rng, n, b, C, zero):
    """q2_apply (the CPU wrapper: the plain wave) of the widest wave and of
    the last against torch.ormqr of the wave's blocks in geqrf form: the
    reflectors of each block below its diagonal, v0 = 1 implicit (the log
    holds v0 = 1 for every non-identity reflector, 0 for an identity one,
    whose tau = 0 makes it the identity in LAPACK as well), applied to the
    blocks' window rows (rows past n as zero): within 1e-13 of max|X|, an
    oracle independent of the port.  T and Y^T from the chunk holding the
    wave, the waves cut into chunks of a few slots each."""
    _, Vw, tw = _log(rng, n, b, zero)
    Kmax, _, _ = tband._wave_geometry(n, b)
    chunks = tband.q2_chunks(n, b, 1, 8)
    assert len(chunks) > 2
    widths = [len(_keep(n, b, w)[0]) for w in range(3 * Kmax - 2)]
    for w in (int(np.argmax(widths)), 3 * Kmax - 3):
        blocks = tband.q2_blocks_t(n, b, Vw, tw, _chunk_of(chunks, w))
        J, k = (torch.as_tensor(a) for a in _keep(n, b, w))
        Y, sw = tband._q2_y(n, b, Vw, J, k)
        tau = tw[sw, k[:, None]]
        v0 = torch.diagonal(Y, dim1=1, dim2=2)
        assert torch.all(v0[tau != 0] == 1) and torch.all(v0[tau == 0] == 0)
        X = torch.as_tensor(rng.standard_normal((n, C)))
        rows = (J * b + k * b + 1)[:, None] + torch.arange(2 * b - 1)
        inside = rows < n
        G = torch.where(inside[..., None], X[rows.clamp(max=n - 1)], 0.0)
        ref = torch.ormqr(Y, tau, G, left=True, transpose=False)
        got = X.clone()
        tband.q2_apply(got, blocks, n, b, w)
        assert float((got[rows[inside]] - ref[inside]).abs().max()) \
            <= 1e-13 * float(X.abs().max())
        untouched = torch.ones(n, dtype=torch.bool)
        untouched[rows[inside]] = False
        assert torch.equal(got[untouched], X[untouched])


# --------------------------------------------------------------------------
# a numpy model of the kernel's tile (csrc/q2_apply.cu::apply_block)


def _tile_model(X, Ts, Ys, n, b, w, slot0, ct, writes):
    """q2_apply's launch of wave w modelled in numpy, with the kernel's own
    index arithmetic: a grid of (column tiles, count) blocks of threads, s =
    s_lo + blockIdx.y at slot slot0 + blockIdx.y of the stores; the tile
    of g_rows = 2b + 2 rows zero past min(h, n - base) and past C; W1 a
    16-row tile i0 at a time over window rows i0 .. min(h, i0 + 15 + b) in
    steps of 4, W2 over j = i0 .. g - 1, the update's row tile r0 over i =
    (max(0, r0 - b + 1) & ~3) .. min(g, r0 + 16); rows r < min(h, n - base)
    and columns < C written; Y^T and T read from their stores (Ys, Ts)
    over exactly those ranges.  ``writes`` counts each (row, column)
    written."""
    g, h = b, 2 * b - 1
    Kmax, _, _ = tband._wave_geometry(n, b)
    HS, GP = 2 * b + 2, (b + 15) & ~15
    HP = (h + 15) & ~15
    C = X.shape[1]
    s_lo, s_hi = tband.q2_wave_range(n, b, w)
    for y in range(s_hi - s_lo + 1):
        s = s_lo + y
        J, k = Kmax - 1 - s, w - 2 * s
        base = J * g + k * b + 1
        rows = min(h, n - base)
        T = Ts[slot0 + y]                        # (GP, GP), zero past g
        Yt = Ys[slot0 + y]                       # (GP, y_stride)
        assert T.shape == (GP, GP) and Yt.shape[1] >= max(HS + 1, HP)
        for tile in range(-(-C // ct)):
            c0 = tile * ct
            cols = min(ct, C - c0)
            Gs = np.zeros((HS, ct))
            Gs[:rows, :cols] = X[base:base + rows, c0:c0 + cols]
            W = np.zeros((GP, ct))
            for i0 in range(0, GP, 16):
                r = np.arange(i0, min(h, i0 + 15 + b), 4)[:, None] \
                    + np.arange(4)
                r = r.ravel()
                W[i0:i0 + 16] = Yt[i0:i0 + 16, r] @ Gs[r]
            W2 = np.zeros_like(W)
            for i0 in range(0, GP, 16):
                j = (np.arange(i0, g, 4)[:, None] + np.arange(4)).ravel()
                W2[i0:i0 + 16] = T[i0:i0 + 16, j] @ W[j]
            for r0 in range(0, HP, 16):
                lo, hi = max(0, r0 - b + 1) & ~3, min(g, r0 + 16)
                i = (np.arange(lo, hi, 4)[:, None] + np.arange(4)).ravel()
                upd = Yt[i, r0:r0 + 16].T @ W2[i]
                for rr in range(r0, min(r0 + 16, rows)):
                    X[base + rr, c0:c0 + cols] = Gs[rr, :cols] \
                        - upd[rr - r0, :cols]
                    writes[base + rr, c0:c0 + cols] += 1


@pytest.mark.parametrize("n,b,C,ct,zero", [(61, 8, 40, 32, None),
                                           (90, 16, 9, 256, None),
                                           (60, 6, 21, 8, (20, 35)),
                                           (35, 16, 17, 16, None),
                                           (23, 2, 5, 64, None)])
def test_tile_model_matches_the_plain_wave(rng, n, b, C, ct, zero):
    """The numpy model of the kernel's tile over every wave, each chunk's
    stores made before its first wave (chunks of a few slots), against the
    plain loop (1e-13 of max|X|): its contraction ranges hold every nonzero
    of Y, T and W; every write lies in rows [0, n) and columns [0, C),
    each (row, column) at most once a wave; and a block whose reflectors
    are all identities leaves its rows bit for bit."""
    _, Vw, tw = _log(rng, n, b, zero)
    Kmax, _, _ = tband._wave_geometry(n, b)
    X0 = rng.standard_normal((n, C))
    ref = tband.apply_q2_wave_blocked_plain(n, b, (Vw, tw),
                                            torch.as_tensor(X0)).numpy()
    X = X0.copy()
    for chunk in tband.q2_chunks(n, b, 1, 12):
        Ts, Ys = (tband._untile(x).numpy()
                  for x in tband.q2_blocks_t(n, b, Vw, tw, chunk)[:2])
        for w in range(chunk.w0, chunk.w1):
            writes = np.zeros((n + 4 * b, C + 256), dtype=np.int64)
            _tile_model(X, Ts, Ys, n, b, w, (w - chunk.w0) * chunk.S, ct,
                        writes)
            assert writes.max(initial=0) <= 1
        assert writes[n:].sum() == 0 and writes[:, C:].sum() == 0
    assert np.abs(X - ref).max() <= 1e-13 * np.abs(X0).max()
    # an all-identity block: zero its reflectors in a copy of the log
    J, k = _keep(n, b, 0)
    Vz, tz = Vw.clone(), tw.clone()
    for i in range(b):
        sw = min(int(J[0]) * b + i, n - 2)
        Vz[sw, int(k[0])] = 0.0
        tz[sw, int(k[0])] = 0.0
    Tz, Yz = (tband._untile(x).numpy() for x in tband.q2_blocks_t(
        n, b, Vz, tz, tband.Q2Chunk(0, 1, 1))[:2])
    X = X0.copy()
    _tile_model(X, Tz, Yz, n, b, 0, 0, ct,
                np.zeros((n + 4 * b, C + 256), dtype=np.int64))
    assert np.array_equal(X, X0)


# --------------------------------------------------------------------------
# the launch plan, the bindings and the wrappers with the card faked


def _resident(b, tile):
    """Blocks of threads an H100 SM holds at a tile (228 KB of shared
    memory, 1 KB reserved a block, at most 8 blocks of 256 threads)."""
    return min(8, 233472 // (tband._q2_tile_bytes(b, tile) + 1024))


def test_apply_plan():
    """q2_apply_plan with a card's figures: the widest tile of which an SM
    holds two (u=16: 256 columns; band 128: 32, its 64-column tile fits
    once; band 256: 8), the widest that fits where none fits twice, and
    raises where no tile fits."""
    optin = 232448
    got = {b: tband.q2_apply_plan(b, optin, lambda t, b=b: _resident(b, t))
           for b in (2, 16, 128, 256)}
    assert {b: p.tile for b, p in got.items()} == {2: 256, 16: 256, 128: 32,
                                                   256: 8}
    assert all(p.smem == tband._q2_tile_bytes(b, p.tile) <= optin
               for b, p in got.items())
    assert tband.q2_apply_plan(128, optin, lambda t: min(
        _resident(128, t), 1)).tile == 64
    with pytest.raises(ValueError):
        tband.q2_apply_plan(16, optin, lambda t: 0)


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("source,symbol,argtypes", [
    ("q2_apply", "q2_apply_launch", tband._Q2_ARGTYPES),
    ("q2_apply", "q2_apply_occupancy", tband._Q2_OCCUPANCY_ARGTYPES),
    ("householder_panel", "q2_blocks_t_launch", tband._Q2T_ARGTYPES),
    ("householder_panel", "q2_blocks_t_staged", tband._Q2T_STAGED_ARGTYPES)])
def test_bindings_match_the_source(source, symbol, argtypes):
    """Every ctypes argument list is its C function's, and _build builds
    both sources."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
    assert m, symbol
    types_ = [_C_TYPES[" ".join(p.split()).rsplit(" ", 1)[0].replace(" *", "*")]
              for p in m.group(1).split(",")]
    assert types_ == list(argtypes)
    assert source in _build.KERNELS


def test_source_tile_geometry_matches_the_plan():
    """The tile widths, shared bytes and Y store stride csrc/q2_apply.cu
    takes are the plan's (_Q2_TILES, _q2_tile_bytes, _q2_y_stride)."""
    text = (_build.CSRC / "q2_apply.cu").read_text()
    cases = [int(x) for x in
             re.findall(r"case (\d+): return q2_apply_kernel", text)]
    assert sorted(cases, reverse=True) == list(tband._Q2_TILES)
    assert "return ((2 * b - 1 + 3) + 1) & ~1;" in text
    assert "return (b + 15) & ~15;" in text
    assert "8LL * (g_rows(b) + w_rows(b)) * (ct + 4)" in text
    assert "return max((h + 3 + 3) & ~3, (h + 15) & ~15);" in text
    for b in range(2, 300):
        h = 2 * b - 1
        assert tband._q2_y_stride(b) == max((h + 6) & ~3, (h + 15) & ~15)
        assert tband._q2_y_stride(b) % 4 == 0


def _fake_card(monkeypatch, calls):
    """The card's calls faked: q2_apply_launch and q2_blocks_t_launch record
    their arguments in ``calls``; an H100's occupancy; stream 7."""
    def function(name, symbol, argtypes):
        assert (name, symbol) in {("q2_apply", "q2_apply_launch"),
                                  ("householder_panel", "q2_blocks_t_launch")}
        return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(tband._build, "function", function)
    monkeypatch.setattr(tband, "_q2_occupancy",
                        lambda index, b, t: (_resident(b, t), 132, 232448))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index=None:
                        types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(tband, "_q2_t_staged", lambda index, b: True)
    monkeypatch.setattr(tband, "q2_blocks_t_launches", 0)
    monkeypatch.setattr(tband, "q2_apply_launches", 0)


def test_cuda_wrappers_launch_with_faked_card(monkeypatch):
    """apply_q2_wave_blocked on 'meta' tensors with the card's calls faked:
    for each chunk of q2_device_chunks one q2_blocks_t launch with its
    waves and slots, then one q2_apply launch a wave with a live block, each
    with its wave, first block, live count, first slot and the plan's tile,
    on the current stream, X updated in place; each counter counts its
    launches, and q2_apply alone launches its wave."""
    calls = []
    _fake_card(monkeypatch, calls)
    n, b, C = 300, 16, 70
    meta = dict(dtype=torch.float64, device="meta")
    monkeypatch.setattr(tband, "q2_store_budget", lambda n: 40000)
    Kmax, _, _ = tband._wave_geometry(n, b)
    vlog = (torch.empty((n - 1, Kmax, b), **meta),
            torch.empty((n - 1, Kmax), **meta))
    X = torch.empty((n, C), **meta)
    tband._launch_q2_wave_blocked(n, b, vlog, X)
    chunks = tband.q2_device_chunks(n, b, 0)
    assert len(chunks) > 2
    waves = tband.q2_wave_count(n, b)
    live = [w for w in range(3 * Kmax - 2) if len(_keep(n, b, w)[0])]
    got, want = [], []
    for c in chunks:
        want.append(("q2_blocks_t_launch",
                     (None, n, b, Kmax, tband._q2_y_stride(b), c.w0,
                      c.w1 - c.w0, c.S, 7)))
        for w in live:
            if c.w0 <= w < c.w1:
                J, _ = _keep(n, b, w)
                want.append(("q2_apply_launch",
                             (n, C, b, w, Kmax - 1 - int(J[0]), len(J),
                              (w - c.w0) * c.S, 256, 7)))
    for sym, args in calls:
        got.append((sym, args[4:]))
    assert got == want
    assert (tband.q2_blocks_t_launches, tband.q2_apply_launches) == (
        len(chunks), waves)
    calls.clear()
    c = _chunk_of(chunks, live[3])
    slots = (c.w1 - c.w0) * c.S
    blocks = tband.Q2Blocks(
        torch.empty((slots, 1, 4, 16, 4), **meta),
        torch.empty((slots, 1, tband._q2_y_stride(b) // 4, 16, 4), **meta),
        c)
    tband._launch_q2_wave(X, blocks, n, b, live[3])
    assert len(calls) == 1 and calls[0][1][7:11] == (
        live[3], Kmax - 1 - int(_keep(n, b, live[3])[0][0]),
        len(_keep(n, b, live[3])[0]), (live[3] - c.w0) * c.S)
    calls.clear()
    dead = min(set(range(3 * Kmax - 2)) - set(live))
    tband._launch_q2_wave(X, blocks._replace(chunk=tband.Q2Chunk(
        dead, dead + 1, slots)), n, b, dead)         # no live block
    assert calls == []
    with pytest.raises(ValueError, match="not in"):
        tband._launch_q2_wave(X, blocks, n, b, c.w1)
    with pytest.raises(TypeError):
        tband._launch_q2_wave_blocked(n, b, vlog, X.float())
    with pytest.raises(ValueError, match="log"):
        tband._launch_q2_wave_blocked(n, b, (vlog[0][:, :, :4], vlog[1]), X)
    with pytest.raises(ValueError, match="unit column stride"):
        tband._launch_q2_wave_blocked(n, b, vlog, X.t().contiguous().t())


@pytest.mark.parametrize("b", [2, 4])
def test_small_band_stores_stay_within_budget(monkeypatch, b):
    """eigh_banded's backtransform at n = 16384 and a small band, driven on
    'meta' tensors with the card's calls faked: every store it allocates
    (T and Y^T of a chunk) stays within q2_store_budget (n^2 / 2 doubles,
    1.07 GB), where the stores of every block at once took 137 GB at b = 2
    and 34 GB at b = 4; the chunks make every wave's q2_apply launch."""
    calls, stores = [], []
    _fake_card(monkeypatch, calls)
    launch = tband._launch_q2_blocks_t

    def record(*args):
        blocks = launch(*args)
        stores.append(8 * (blocks.T.numel() + blocks.Y.numel()))
        return blocks

    monkeypatch.setattr(tband, "_launch_q2_blocks_t", record)
    n, C = 16384, 16384
    meta = dict(dtype=torch.float64, device="meta")
    Kmax, _, _ = tband._wave_geometry(n, b)
    vlog = (torch.empty((n - 1, Kmax, b), **meta),
            torch.empty((n - 1, Kmax), **meta))
    tband._launch_q2_wave_blocked(n, b, vlog, torch.empty((n, C), **meta))
    budget = tband.q2_store_budget(n)
    assert budget == 4 * n * n
    assert max(stores) <= budget
    every = tband.q2_block_count(n, b) * tband._q2_slot_bytes(b, False)
    assert every >= 30 * budget
    assert tband.q2_apply_launches == tband.q2_wave_count(n, b)
    assert tband.q2_blocks_t_launches == len(stores) \
        == len(tband.q2_device_chunks(n, b, 0))
