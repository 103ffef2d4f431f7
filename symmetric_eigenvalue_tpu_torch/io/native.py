"""ctypes loader for the native MTX parser (the port's ``native/mtxio.c``).

Port of the JAX package's ``io/native.py`` with the same ctypes
signatures and the same ``None`` when no C compiler is there (``io/mtx.py``
then keeps its pure-Python path).  The library is compiled at first use,
never at import, with ``$CC`` (default ``cc``) ``-O2 -shared -fPIC`` into
``build/native/`` at the repository root, named by a hash of the source, as
``_build.py`` places the CUDA kernels: an edited source rebuilds, and nothing
is written into the package directory.  The parser is host IO, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "mtxio.c"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libmtxio_{tag}.so"


def _build(so: Path) -> bool:
    cc = os.environ.get("CC", "cc")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp),
                        str(SRC)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on the first call; None when it
    cannot be built or loaded (no compiler, read-only checkout)."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.mtx_read_symm_tridiag.restype = ctypes.c_long
    lib.mtx_read_symm_tridiag.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_char_p, ctypes.c_long,
    ]
    lib.mtx_write_symm_tridiag.restype = ctypes.c_long
    lib.mtx_write_symm_tridiag.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_char_p,
    ]
    lib.mtx_free.restype = None
    lib.mtx_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    _LIB = lib
    return _LIB


def read_symm_tridiag(path) -> Optional[Tuple[np.ndarray, np.ndarray, str]]:
    """Returns (d, e, "") on success, (None, None, errmsg) on parse error, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    dp = ctypes.POINTER(ctypes.c_double)()
    ep = ctypes.POINTER(ctypes.c_double)()
    errbuf = ctypes.create_string_buffer(512)
    n = lib.mtx_read_symm_tridiag(str(path).encode(), ctypes.byref(dp),
                                  ctypes.byref(ep), errbuf, 512)
    if n < 0:
        return None, None, errbuf.value.decode(errors="replace")
    d = np.ctypeslib.as_array(dp, shape=(n,)).copy()
    e = np.ctypeslib.as_array(ep, shape=(max(n - 1, 0),)).copy() \
        if n > 1 else np.zeros(0)
    lib.mtx_free(dp)
    lib.mtx_free(ep)
    return d, e, ""


def write_symm_tridiag(path, d, e, comment: str = "") -> bool:
    """Write (d, e) in coordinate/real/general form (column-major entries,
    ``%.17g``); False when the library is unavailable or the file cannot
    be opened."""
    lib = get_lib()
    if lib is None:
        return False
    d = np.ascontiguousarray(d, dtype=np.float64)
    e = np.ascontiguousarray(e, dtype=np.float64)
    n = lib.mtx_write_symm_tridiag(
        str(path).encode(),
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        d.shape[0], comment.encode())
    return n >= 0
