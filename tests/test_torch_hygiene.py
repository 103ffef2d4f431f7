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
from symmetric_eigenvalue_tpu_torch.kernels import band_reduce as br
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_matmul as cm
from symmetric_eigenvalue_tpu_torch.kernels import cauchy_rowsum as cr
from symmetric_eigenvalue_tpu_torch.kernels import deflation_tree as dtr
from symmetric_eigenvalue_tpu_torch.kernels import dword_matmul as dm
from symmetric_eigenvalue_tpu_torch.kernels import dword_matvec as dv
from symmetric_eigenvalue_tpu_torch.kernels import householder_panel as hp
from symmetric_eigenvalue_tpu_torch.kernels import rotation_replay as rr
from symmetric_eigenvalue_tpu_torch.kernels import secular_sums as ss
from symmetric_eigenvalue_tpu_torch.kernels import shifted_solve as shs
from symmetric_eigenvalue_tpu_torch.kernels import spike_solve as sp
from symmetric_eigenvalue_tpu_torch.kernels.secular import MergeRep

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
    # the default (mixed-precision) config as well
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.solve_tridiagonal_staged(d, e, compute_vectors=True)
    # the dense and banded entry points
    A = np.eye(8) + np.diag(e, 1) + np.diag(e, -1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.eigh(A)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.eigh(A, band=2, eigvals_only=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.eigh_banded(np.ones((3, 8)))
    with pytest.raises(RuntimeError):
        st.eigh_banded(np.ones((1, 8)), device="cuda")
    # the streamed route raises at the call, before any block is drained
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.solve_tridiagonal_streamed(d, e)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.solve_tridiagonal_streamed(d, e, config=cfg, device="cuda")


def test_exports_every_name_of_the_jax_package():
    """The port's __all__ holds every name of the JAX package's __all__
    (read from its source: no JAX import here)."""
    tree = ast.parse((ROOT / "symmetric_eigenvalue_tpu" /
                      "__init__.py").read_text())
    jax_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__"
                           for t in node.targets))
    assert "solve_tridiagonal_streamed" in jax_all
    assert sorted(set(jax_all) - set(st.__all__)) == []
    assert all(hasattr(st, name) for name in st.__all__)


def _counts():
    return (ss.launches, ss.solve_launches, cr.launches, dm.launches,
            cm.matmul_launches, cm.materialize_launches, sp.pass_a_launches,
            sp.pass_b_launches, dv.launches, rr.launches, rr.t_launches,
            shs.interface_launches, shs.block_lu_launches,
            hp.reflector_launches, hp.w_launches, hp.w_reflector_launches,
            hp.larft_launches, br.chase_launches, br.panel_qr_launches,
            br.q2_blocks_t_launches, br.q2_apply_launches, dtr.launches)


def test_cpu_tensors_count_no_launches(rng):
    """CPU runs take the plain versions and count nothing: the f64 path,
    and the default mixed path at n >= 512 (Cauchy kernels, Spike passes,
    cluster Grams)."""
    before = _counts()
    n = 96
    cfg = st.SolverConfig(leaf_size=8, mixed_precision_vectors=False)
    res = st.solve_tridiagonal(rng.standard_normal(n),
                               rng.standard_normal(n - 1), config=cfg,
                               compute_vectors=True, device="cpu")
    assert res.eigenvectors.device.type == "cpu"
    n = 520
    res, timer = st.solve_tridiagonal_staged(
        rng.standard_normal(n), rng.standard_normal(n - 1),
        compute_vectors=True, device="cpu")
    assert res.eigenvectors.device.type == "cpu"
    assert "bt.refine_pass1" in timer.times
    # the dense front ends: one-stage, two-stage and banded
    A = rng.standard_normal((40, 40))
    lam, V = st.eigh(A + A.T, device="cpu")
    assert V.device.type == "cpu"
    st.eigh(A + A.T, band=4, device="cpu")
    st.eigh_banded(np.ones((4, 40)), device="cpu")
    assert _counts() == before == (0,) * 22


def test_non_cpu_tensors_never_take_the_plain_version():
    """Only a CPU tensor runs a plain version: any other device goes to the
    kernel launch, which takes CUDA alone and raises for the rest (here the
    'meta' device), so no computation silently falls back."""
    f64 = dict(dtype=torch.float64, device="meta")
    i64 = dict(dtype=torch.int64, device="meta")
    k, m, C, n, nb = 2, 8, 4, 16, 8
    v = [torch.empty((k, m), **f64) for _ in range(5)]
    calls = {
        "secular_sums": lambda: ss.secular_sums(
            *v[:4], torch.empty((k, m), **i64), torch.empty(k, **i64)),
        "secular_solve": lambda: ss.secular_solve(ss.RootSetup(
            *v[:2], torch.empty(k, **f64), torch.empty(k, **i64),
            *(torch.empty((k, m), **f64) for _ in range(7)),
            torch.empty((k, m), dtype=torch.bool, device="meta")), 1e-15, 60),
        "cauchy_rowsum": lambda: cr.cauchy_rowsum(
            *v[:3], torch.empty((k, 2, m), **f64), torch.empty(k, **i64)),
        "dword_matmul": lambda: dm.dword_matmul(v[0], v[1].T),
        "dword_vecmat": lambda: dv.dword_vecmat(v[0][0], v[1].T),
        "cauchy_matmul": lambda: cm.cauchy_matmul(
            *v, torch.empty((k, m, C), dtype=torch.float32, device="meta"),
            torch.empty(k, **i64)),
        "cauchy_materialize": lambda: cm.cauchy_materialize(
            *v[:2], *(torch.empty((k, C), **f64) for _ in range(3)),
            torch.empty((k, C), **i64), torch.empty(k, **i64)),
        "spike_pass_a": lambda: sp.spike_pass_a(
            torch.empty(n, **f64), torch.empty(n, **f64),
            torch.empty((), **f64), torch.empty(C, **f64),
            torch.empty((n, C), **f64), nb),
        "spike_pass_b": lambda: sp.spike_pass_b(
            torch.empty(n, **f64), torch.empty(n, **f64),
            torch.empty((), **f64), torch.empty(C, **f64),
            torch.empty((n, C), **f64), nb, torch.empty((2, C), **f64),
            torch.empty((2, C), **f64), torch.empty(2, **f64),
            torch.empty(2, **f64)),
        "rotation_replay": lambda: rr.rotation_replay(
            MergeRep._make([torch.empty((k, m), **i64)]
                           * len(MergeRep._fields)),
            torch.empty((k, m, C), **f64)),
        "rotation_replay_t": lambda: rr.rotation_replay_t(
            MergeRep._make([torch.empty((k, m), **i64)]
                           * len(MergeRep._fields)),
            torch.empty((k, m, 2), **f64)),
        "deflation_tree": lambda: dtr.deflation_tree(
            *v[:2], torch.empty((k, m), dtype=torch.bool, device="meta"),
            torch.empty(k, **f64)),
        "interface_solve": lambda: shs.interface_solve(
            *(torch.empty((2, C), **f64) for _ in range(6))),
        "block_lu_solve": lambda: shs.block_lu_solve(
            torch.empty(n, **f64), torch.empty(n, **f64),
            torch.empty((), **f64), torch.empty(2, **f64),
            torch.empty(2, **f64), torch.empty(C, **f64),
            torch.empty((n, C), **f64), nb),
        "column_step": lambda: hp.column_steps(
            torch.empty((n, n), **f64), torch.empty((n - 1, n), **f64),
            torch.empty((nb, n), **f64), torch.empty((n - 1, 2), **f64), nb),
        "larft": lambda: hp.larft(torch.empty((nb, nb), **f64),
                                  torch.empty(nb, **f64)),
        "band_chase": lambda: br.band_to_tridiag_wave(
            torch.empty((n, n), **f64), 4),
        "panel_qr": lambda: br.panel_qr(
            torch.empty((n, n), **f64), 0, 4, torch.empty((4, n), **f64),
            torch.empty(4, **f64)),
        "q2_blocks_t": lambda: br.q2_blocks_t(
            n, 4, torch.empty((n - 1, 4, 4), **f64),
            torch.empty((n - 1, 4), **f64), br.Q2Chunk(0, 1, 1)),
        "q2_apply": lambda: br.q2_apply(
            torch.empty((n, C), **f64), br.Q2Blocks(
                torch.empty((10, 4, 4), **f64),
                torch.empty((10, 16, 16), **f64), br.Q2Chunk(0, 1, 1)),
            n, 4, 0),
        "apply_q2_wave_blocked": lambda: br.apply_q2_wave_blocked(
            n, 4, (torch.empty((n - 1, 4, 4), **f64),
                   torch.empty((n - 1, 4), **f64)),
            torch.empty((n, C), **f64)),
    }
    before = _counts()
    for name, call in calls.items():
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert _counts() == before


def test_refine_chunk_follows_the_run_device(monkeypatch, rng):
    """The refinement chunk is budgeted on the device the run's tensors are
    on, not on config.device: a CPU run with the default config
    (device="cuda") never asks CUDA for its memory."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_cuda(*a, **k):
        raise AssertionError("torch.cuda.mem_get_info called on a CPU run")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_cuda)
    cfg = st.SolverConfig()
    assert cfg.device == "cuda"
    assert cfg.resolved_refine_chunk(16384, torch.device("cpu")) == 2048
    assert cfg.resolved_refine_chunk(4096, "cpu") == cfg.refine_chunk
    n = 520
    res, _ = st.solve_tridiagonal_staged(
        rng.standard_normal(n), rng.standard_normal(n - 1), config=cfg,
        compute_vectors=True, device="cpu")
    assert res.eigenvectors.shape == (n, n)


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository (or without a card)
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in PKG.rglob("*")
    if p.suffix in (".py", ".c", ".cu")))
def test_sources_name_no_path_in_the_jax_package(path):
    """No file of the port reads, builds or loads anything inside
    symmetric_eigenvalue_tpu/: no code string names such a path (the
    native parser compiles the port's own native/mtxio.c), no CUDA source
    includes a file from there, and the C copy does not name it at all."""
    text = (ROOT / path).read_text()
    if path.endswith(".c"):
        assert "symmetric_eigenvalue_tpu/" not in text
    if not path.endswith(".py"):
        assert not any("symmetric_eigenvalue_tpu/" in ln
                       for ln in text.splitlines()
                       if ln.lstrip().startswith("#include"))
        return
    for s in _code_strings(ast.parse(text)):
        assert "symmetric_eigenvalue_tpu/" not in s, (path, s)
        assert s != "symmetric_eigenvalue_tpu", (path, s)


def test_cli_help_runs_without_jax():
    """``python -m symmetric_eigenvalue_tpu_torch -h`` prints the help and
    imports nothing of JAX."""
    out = subprocess.run([sys.executable, "-m",
                          "symmetric_eigenvalue_tpu_torch", "-h"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("usage: cuppen")
    code = ("import runpy, sys\nsys.argv = ['cuppen', '-h']\ntry:\n"
            "    runpy.run_module('symmetric_eigenvalue_tpu_torch', "
            "run_name='__main__')\nexcept SystemExit:\n    pass\n"
            "print(repr(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'symmetric_eigenvalue_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_dense_from_tridiag_stays_out_of_all():
    """As in the JAX package: a test oracle in core.tridiag, not exported."""
    from symmetric_eigenvalue_tpu_torch.core.tridiag import dense_from_tridiag
    assert "dense_from_tridiag" not in st.__all__
    T = dense_from_tridiag(torch.tensor([1.0, 2.0, 3.0]), np.array([4.0, 5.0]))
    assert np.array_equal(T, [[1, 4, 0], [4, 2, 5], [0, 5, 3]])
