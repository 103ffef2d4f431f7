"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``.  Libraries go to
``build/torch_kernels/`` at the repository root, named by a hash of source and
flags, so an edited source rebuilds and an unchanged one is reused.  Nothing
is built at import time: the first launch of a kernel builds its library, and
``build_all`` builds every library at once with one ``nvcc`` process per
source running in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
KERNELS = ("secular_sums", "cauchy_rowsum", "dword_matmul", "cauchy_matmul",
           "spike_solve", "dword_matvec", "rotation_replay", "interface_solve",
           "householder_panel", "band_reduce", "q2_apply", "deflation_tree")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, object] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns ``{name: ptxas report}`` for the libraries built by this call;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def function(name: str, symbol: str, argtypes: Sequence):
    """The ``ctypes`` function ``symbol`` of kernel library ``name`` (built on
    first use), returning the launch's ``cudaError_t`` as an int."""
    key = f"{name}:{symbol}"
    fn = _FUNCS.get(key)
    if fn is None:
        if name not in _LIBS:
            build_all([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_LIBS[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
