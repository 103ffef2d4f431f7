"""PyTorch port, host IO: the Matrix Market reader and writer (native C
parser and pure-Python path), the eigenvector-selection file and the
result file, case by case against the JAX package's ``io`` modules
(``tests/test_io.py``) on the same seeded inputs.

Tolerances: none.  Arrays read from a file agree bit for bit, files written
by both packages from the same numbers agree byte for byte, and a rejected
file raises the same exception type with the same message.
"""

import numpy as np
import pytest

from symmetric_eigenvalue_tpu.io import evselect as jev
from symmetric_eigenvalue_tpu.io import mtx as jmtx
from symmetric_eigenvalue_tpu.io import results as jres
from symmetric_eigenvalue_tpu_torch.io import evselect as tev
from symmetric_eigenvalue_tpu_torch.io import mtx as tmtx
from symmetric_eigenvalue_tpu_torch.io import native
from symmetric_eigenvalue_tpu_torch.io import results as tres

TINYL = """%%MatrixMarket matrix coordinate real general
%matrix L
4 4 10
1 1 2
2 1 -1
1 2 -1
2 2 2
3 2 -1
2 3 -1
3 3 2
4 3 -1
3 4 -1
4 4 2
"""

BAD = {
    "nonsquare": ("%%MatrixMarket matrix coordinate real general\n"
                  "2 3 1\n1 1 1.0\n", "square"),
    "nontridiagonal": ("%%MatrixMarket matrix coordinate real general\n"
                       "3 3 2\n1 1 1.0\n3 1 5.0\n", "tridiagonal"),
    "asymmetric": ("%%MatrixMarket matrix coordinate real general\n"
                   "2 2 4\n1 1 1.0\n2 1 3.0\n1 2 4.0\n2 2 1.0\n",
                   "symmetric"),
    "wrong_banner": ("%%MatrixMarket matrix array real general\n"
                     "2 2\n1\n2\n", "Unsupported"),
}


@pytest.fixture
def tinyl(tmp_path):
    p = tmp_path / "tinyL.mtx"
    p.write_text(TINYL)
    return p


def _seeded(n, seed=1234):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n - 1)


def test_native_library_builds_outside_the_package():
    """The parser is built from the port's own C source into build/native/
    at the repository root (a C compiler is there: these cases run)."""
    assert native.get_lib() is not None
    root = native.SRC.parent.parent.parent
    assert native.SRC == root / "symmetric_eigenvalue_tpu_torch" / \
        "native" / "mtxio.c"
    assert native.library_path().parent == root / "build" / "native"
    assert native.library_path().exists()


@pytest.mark.parametrize("use_native", [True, False])
def test_read_tinyl(tinyl, use_native):
    d, e = tmtx.read_symmetric_tridiagonal(tinyl, use_native=use_native)
    dj, ej = jmtx.read_symmetric_tridiagonal(tinyl, use_native=use_native)
    assert np.array_equal(d, dj) and np.array_equal(e, ej)
    assert np.all(d == 2.0) and np.all(e == -1.0)


@pytest.mark.parametrize("use_native", [True, False])
def test_roundtrip(tmp_path, use_native):
    d, e = _seeded(12)
    p = tmp_path / "m.mtx"
    tmtx.write_symmetric_tridiagonal(p, d, e)
    d2, e2 = tmtx.read_symmetric_tridiagonal(p, use_native=use_native)
    assert np.array_equal(d, d2) and np.array_equal(e, e2)
    d3, e3 = jmtx.read_symmetric_tridiagonal(p, use_native=use_native)
    assert np.array_equal(d2, d3) and np.array_equal(e2, e3)


def test_writer_matches_reference_fixture(tmp_path):
    """The writer regenerates the sample fixture byte for byte (comment
    line included), and writes what the JAX package's writer writes."""
    p = tmp_path / "gen.mtx"
    tmtx.write_symmetric_tridiagonal(p, [2.0] * 4, [-1.0] * 3,
                                     comment="matrix L")
    assert p.read_text() == TINYL
    d, e = _seeded(37)
    pj = tmp_path / "j.mtx"
    tmtx.write_symmetric_tridiagonal(p, d, e, comment="x")
    jmtx.write_symmetric_tridiagonal(pj, d, e, comment="x")
    assert p.read_bytes() == pj.read_bytes()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("case", sorted(BAD))
def test_rejections(tmp_path, case, use_native):
    text, what = BAD[case]
    p = tmp_path / "bad.mtx"
    p.write_text(text)
    with pytest.raises(tmtx.MTXFormatError, match=what) as got:
        tmtx.read_symmetric_tridiagonal(p, use_native=use_native)
    with pytest.raises(jmtx.MTXFormatError) as want:
        jmtx.read_symmetric_tridiagonal(p, use_native=use_native)
    assert issubclass(tmtx.MTXFormatError, ValueError)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("use_native", [True, False])
def test_missing_file_raises_filenotfound(tmp_path, use_native):
    with pytest.raises(FileNotFoundError):
        tmtx.read_symmetric_tridiagonal(tmp_path / "nope.mtx",
                                        use_native=use_native)


def test_banded_reader(tinyl, tmp_path):
    T = tmtx.read_tridiagonal_banded(tinyl)
    assert T.shape == (4, 3)
    assert np.array_equal(T, jmtx.read_tridiagonal_banded(tinyl))
    d, e = _seeded(9)
    p = tmp_path / "m.mtx"
    tmtx.write_symmetric_tridiagonal(p, d, e)
    assert np.array_equal(tmtx.read_tridiagonal_banded(p),
                          jmtx.read_tridiagonal_banded(p))


@pytest.mark.parametrize("compute_ev", [True, False])
def test_evselect_all_or_none(compute_ev):
    sel = tev.determine_eigenvectors_to_compute(compute_ev, None, 10)
    ref = jev.determine_eigenvectors_to_compute(compute_ev, None, 10)
    assert (sel.all, sel.indices, sel.any) == (ref.all, ref.indices, ref.any)


@pytest.mark.parametrize("text", ["3\n1\nbogus\n0\n99\n2\n",
                                  "5\n5\n5\n2\n\n-4\n7x\n10\n11\n"])
def test_evselect_file(tmp_path, text):
    """atoi semantics, warn-and-skip, 0-based, sorted, duplicates kept: the
    same indices and the same warnings as the JAX package."""
    p = tmp_path / "ev.txt"
    p.write_text(text)
    got, want = [], []
    sel = tev.determine_eigenvectors_to_compute(True, str(p), 10,
                                                warn=got.append)
    ref = jev.determine_eigenvectors_to_compute(True, str(p), 10,
                                                warn=want.append)
    assert sel.indices == ref.indices and not sel.all
    assert got == want and len(got) >= 3
    assert sel.indices == sorted(sel.indices)


@pytest.mark.parametrize("which", ["all", "none", "partial"])
def test_write_results_byte_identical(tmp_path, which):
    """Both writers on the same numpy arrays write the same bytes (C's
    %20.19g), and the reader gives the numbers back."""
    rng = np.random.default_rng(7)
    lam = np.sort(rng.standard_normal(20) * 50)
    res = np.abs(rng.standard_normal(20)) * 1e-15
    args = {"all": (res, None), "none": (None, None),
            "partial": (res[[1, 4, 19]], np.array([1, 4, 19]))}[which]
    p, pj = tmp_path / "t.txt", tmp_path / "j.txt"
    tres.write_results(p, lam, *args)
    jres.write_results(pj, lam, *args)
    assert p.read_bytes() == pj.read_bytes()
    lam2, res2 = tres.read_results(p)
    assert np.array_equal(lam2, lam)
    assert res2 == jres.read_results(pj)[1]
    have = [i for i, r in enumerate(res2) if r is not None]
    assert have == {"all": list(range(20)), "none": [],
                    "partial": [1, 4, 19]}[which]


def test_native_parser_matches_python(tmp_path):
    """The native reader and the Python one give the same (d, e) bit for
    bit, and the native writer's file reads back to the same arrays and is
    the Python writer's file byte for byte."""
    d, e = _seeded(200)
    p = tmp_path / "m.mtx"
    tmtx.write_symmetric_tridiagonal(p, d, e)
    dn, en, err = native.read_symm_tridiag(p)
    assert err == ""
    d2, e2 = tmtx.read_symmetric_tridiagonal(p, use_native=False)
    assert np.array_equal(dn, d2) and np.array_equal(en, e2)
    p2 = tmp_path / "m2.mtx"
    assert native.write_symm_tridiag(p2, d, e, "x")
    d3, e3 = tmtx.read_symmetric_tridiagonal(p2, use_native=False)
    assert np.array_equal(d3, dn) and np.array_equal(e3, en)
    p3 = tmp_path / "m3.mtx"
    tmtx.write_symmetric_tridiagonal(p3, d, e, comment="x")
    assert p2.read_bytes() == p3.read_bytes()


def test_native_parser_rejects_bad(tmp_path):
    p = tmp_path / "bad.mtx"
    p.write_text(BAD["nontridiagonal"][0])
    d, e, err = native.read_symm_tridiag(p)
    assert d is None and e is None and "tridiagonal" in err
