"""PyTorch port, dword_vecmat: the plain version (what CPU tensors run)
against the JAX Pallas kernel run in interpret mode, to 1e-13 of
max_j sum_i |v_i||A_ij| (the JAX kernel is ~2^-48-grade, the port native
f64), the wrapper's input checks, and the launch geometry it computes."""

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
                                       (100000, 300)])
def test_row_chunks_cover_the_rows(rows, cols):
    """The launch geometry: whole 128-row tiles per block, every row in
    exactly one chunk, and about eight blocks per SM at the large shapes."""
    sms = 132
    per = tdv._row_chunk(rows, cols, sms)
    chunks = -(-rows // per)
    assert per % 128 == 0 and per >= 128
    assert (chunks - 1) * per < rows <= chunks * per
    col_tiles = -(-cols // 128)
    assert chunks * col_tiles <= 8 * sms + col_tiles
    if rows >= 4096 and cols >= 4096:
        assert chunks * col_tiles >= 4 * sms
