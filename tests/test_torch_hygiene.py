"""PyTorch port, hygiene: the port and chip_smoke.py import nothing of JAX
or of the JAX package, CUDA is never replaced by the CPU behind the
caller's back, and CPU tensors never count as kernel launches."""

import ast
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import symmetric_eigenvalue_tpu_torch as st
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_rowsum as cr
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as dm
from symmetric_eigenvalue_tpu_torch.kernels import secular_sums as ss

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "symmetric_eigenvalue_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "symmetric_eigenvalue_tpu")


def test_import_leaves_jax_out():
    code = ("import sys, symmetric_eigenvalue_tpu_torch, "
            "symmetric_eigenvalue_tpu_torch.interop, "
            "symmetric_eigenvalue_tpu_torch.utils.checks\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'symmetric_eigenvalue_tpu'))\n"
            "print(repr(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, e = np.ones(8), np.ones(7)
    cfg = st.SolverConfig(mixed_precision_vectors=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.eigh_tridiagonal(d, e, config=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.solve_tridiagonal_staged(d, e, config=cfg, compute_vectors=True)
    with pytest.raises(RuntimeError):
        st.solve_tridiagonal(d, e, config=cfg, device="cuda")


def test_cpu_tensors_count_no_launches(rng):
    before = (ss.launches, cr.launches, dm.launches)
    n = 96
    cfg = st.SolverConfig(leaf_size=8, mixed_precision_vectors=False)
    res = st.solve_tridiagonal(rng.standard_normal(n),
                               rng.standard_normal(n - 1), config=cfg,
                               compute_vectors=True, device="cpu")
    assert res.eigenvectors.device.type == "cpu"
    assert (ss.launches, cr.launches, dm.launches) == before == (0, 0, 0)


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository (or without a card)
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
