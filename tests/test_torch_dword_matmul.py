"""PyTorch port, dword_matmul: the plain versions (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode, to 1e-12 of |A||B|
elementwise (the JAX kernel is ~2^-47-grade, the port native f64); the
fused form C -= A @ B, on strided views too, to 1e-12 of |C| + |A||B|; and
the CUDA kernel's launch plan (tile and split-K count), a pure function of
the shape."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import symmetric_eigenvalue_tpu.kernels.pallas.dword_matmul as jdm
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as tdm


@pytest.fixture
def interpreted(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jdm.pl, "pallas_call", patched)


def _rel(Y, ref, A, B):
    scale = np.abs(A) @ np.abs(B)
    return (np.abs(Y - ref) / np.maximum(scale, 1e-300)).max()


@pytest.mark.parametrize("M,K,N", [(256, 256, 256), (100, 200, 300),
                                   (256, 64, 256)])
def test_plain_matches_interpreted_jax(interpreted, rng, M, K, N):
    A = rng.standard_normal((M, K))
    B = rng.standard_normal((K, N))
    ref = np.asarray(jdm.dword_matmul(jnp.asarray(A), jnp.asarray(B)))
    Y = tdm.dword_matmul(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert _rel(Y, ref, A, B) <= 1e-12


def test_batched_matches_interpreted_jax(interpreted, rng):
    k, M, K, N = 3, 70, 130, 90          # ragged against every tile size
    A = rng.standard_normal((k, M, K))
    B = rng.standard_normal((k, K, N)) * np.logspace(-3, 3, N)[None, None]
    Y = tdm.dword_matmul(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    assert Y.shape == (k, M, N)
    for b in range(k):
        ref = np.asarray(jdm.dword_matmul(jnp.asarray(A[b]),
                                          jnp.asarray(B[b])))
        assert _rel(Y[b], ref, A[b], B[b]) <= 1e-12


@pytest.mark.parametrize("view", ["contiguous", "trailing_block",
                                  "batched", "batched_strided"])
def test_fused_subtract_matches_interpreted_jax(interpreted, rng, view):
    """dword_matmul_sub_(C, A, B) is C - A @ B with the JAX kernel's product,
    in place, whatever the row stride of C; nothing outside C changes."""
    k, M, K, N = (3 if view.startswith("batched") else 1), 70, 130, 90
    A = rng.standard_normal((k, M, K))
    B = rng.standard_normal((k, K, N))
    pad = 0 if view in ("contiguous", "batched") else 7
    base = rng.standard_normal((k, M + pad, N + pad))
    before = base.copy()
    tb = torch.as_tensor(base)
    C = tb[:, pad:, pad:]
    assert C.is_contiguous() == (pad == 0)
    if k == 1:
        out = tdm.dword_matmul_sub_(C[0], torch.as_tensor(A[0]),
                                    torch.as_tensor(B[0]))
        assert out.data_ptr() == C[0].data_ptr()
    else:
        out = tdm.dword_matmul_sub_(C, torch.as_tensor(A), torch.as_tensor(B))
        assert out.data_ptr() == C.data_ptr()
    for b in range(k):
        prod = np.asarray(jdm.dword_matmul(jnp.asarray(A[b]),
                                           jnp.asarray(B[b])))
        want = before[b, pad:, pad:] - prod
        scale = np.abs(before[b, pad:, pad:]) + np.abs(A[b]) @ np.abs(B[b])
        assert (np.abs(base[b, pad:, pad:] - want) / scale).max() <= 1e-12
    assert np.array_equal(base[:, :pad], before[:, :pad])
    assert np.array_equal(base[:, :, :pad], before[:, :, :pad])


def test_fused_subtract_rejects_bad_inputs():
    a = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        tdm.dword_matmul_sub_(torch.zeros((4, 5), dtype=torch.float64), a, a.T)
    with pytest.raises(TypeError):
        tdm.dword_matmul_sub_(torch.zeros((4, 4)), a, a.T)


# (batch, M, N, K) -> tile rows, whether K is split.  The first three are
# the shapes the chip check times: the f64 downsweep's level product, a
# panel's Gram, the rank-2k trailing update.
_PLAN_CASES = {
    "downsweep_level": ((2, 2048, 8192, 8192), 128, False),
    "panel_gram": ((1, 32, 32, 16384), 32, True),
    "rank2k_update": ((1, 16384, 16384, 64), 128, False),
    "apply_q_panel": ((1, 32, 16384, 16384), 32, True),
    "band_as_times_y": ((1, 16384, 128, 16384), 128, True),
    "cluster_gram": ((4, 40, 40, 16384), 32, True),
    "ortho_check_rows": ((1, 2048, 16384, 16384), 128, False),
    "wave_blocks": ((16, 128, 4096, 255), 128, False),
    "ragged": ((1, 1000, 777, 4001), 128, True),
    "short_k_skinny": ((1, 32, 32, 100), 32, False),
    "tiny": ((1, 3, 5, 7), 32, False),
}


@pytest.mark.parametrize("name", sorted(_PLAN_CASES))
def test_split_plan(name):
    """Skinny outputs over a long K are cut into enough slices to fill the
    card (at least one block per SM, at most ~two), each slice a multiple of
    the kernel's 16-deep stage and at least 64 deep, no slice empty;
    outputs that fill the card on their own are not split."""
    (batch, M, N, K), tile_rows, split = _PLAN_CASES[name]
    plan = tdm.split_plan(batch, M, N, K)
    bm, bn = {32: (32, 64), 128: (128, 128)}[plan.tile_rows]
    tiles = batch * -(-M // bm) * -(-N // bn)
    assert plan.tile_rows == tile_rows
    assert plan.blocks == tiles * plan.splits
    assert (plan.splits > 1) == split
    if split:
        assert plan.kchunk % 16 == 0 and plan.kchunk >= 64
        assert (plan.splits - 1) * plan.kchunk < K <= plan.splits * plan.kchunk
        assert 132 <= plan.blocks <= 2 * 132 + tiles
    else:
        assert plan.kchunk >= K
    assert tdm.split_plan(batch, M, N, K) == plan       # a pure function


def test_rejects_bad_inputs():
    a = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        tdm.dword_matmul(a, a)
    with pytest.raises(TypeError):
        tdm.dword_matmul(a.float(), a.T.float())
    with pytest.raises(ValueError):
        tdm.dword_matmul(a[None], a.T)


def test_ortho_checks_match_jax(rng):
    """utils.checks (the Gram through dword_matmul) against the JAX
    package's checks on the same nearly orthonormal basis."""
    from symmetric_eigenvalue_tpu.utils import checks as jchecks
    from symmetric_eigenvalue_tpu_torch.utils import checks as tchecks
    n = 96
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    V = Q + 1e-9 * rng.standard_normal((n, n))
    got = tchecks.max_ortho_error(torch.as_tensor(V), row_chunk=40)
    ref = jchecks.max_ortho_error(jnp.asarray(V), row_chunk=40)
    assert abs(got - ref) <= 1e-15 + 1e-12 * ref
    assert got > 1e-10
    got = tchecks.max_cross_ortho_error(torch.as_tensor(V[:, :50]),
                                        torch.as_tensor(V[:, 50:]),
                                        row_chunk=16)
    ref = jchecks.max_cross_ortho_error(jnp.asarray(V[:, :50]),
                                        jnp.asarray(V[:, 50:]), row_chunk=16)
    assert abs(got - ref) <= 1e-15 + 1e-12 * ref
