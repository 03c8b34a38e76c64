"""ctypes binding of the port's native data-loading library.

``native/matio.cpp`` (the port's own C++ source) is built with ``g++`` at
first use into ``_build/native-<hash of the source>/libmatio.so`` inside the
package (a directory git ignores), through a temporary name renamed into
place, so that processes building at once never load a half-written library.
It provides:

* :func:`read_coordinate` — the MatrixMarket coordinate parser
  :func:`~.matrix_market.read_mtx` takes for large numeric files;
* :func:`pack_ell` — COO sorted by (row, col) to the padded-ELL arrays of
  :func:`~..ops.operators.build_ell` (slot-major, the same bits).

There is no quiet fallback: a failed build raises with the compiler's
output, and :func:`read_mtx` does not retry in Python (the JAX package falls
back).  :func:`available` says whether the library builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "read_coordinate", "pack_ell", "build"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "matio.cpp"
BUILD_ROOT = _PKG / "_build"

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)
_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def _library_path(source: Path, build_root: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return build_root / f"native-{digest}" / "libmatio.so"


def compile_command(compiler, source, output) -> list[str]:
    """The ``g++`` command line that builds the library (no
    ``-march=native``: the library is the same on every host)."""
    return [str(compiler), "-std=c++17", "-O3", "-fPIC", "-shared", "-Wall",
            "-o", str(output), str(source)]


def build() -> Path:
    """Build the library from :data:`SOURCE` into :data:`BUILD_ROOT` if it
    is missing; return its path.  Raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    source = Path(SOURCE)
    path = _library_path(source, Path(BUILD_ROOT))
    if path.exists():
        return path
    compiler = shutil.which("g++")
    if compiler is None:
        raise RuntimeError("g++ not found: the native MatrixMarket reader "
                           "cannot be built")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(compile_command(compiler, source, tmp),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    with _lock:
        path = build()
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.ncgvt_read_coordinate.restype = ctypes.c_int64
            lib.ncgvt_read_coordinate.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(_I64P),
                ctypes.POINTER(_I64P), ctypes.POINTER(_F64P)]
            lib.ncgvt_free.restype = None
            lib.ncgvt_free.argtypes = [ctypes.c_void_p]
            lib.ncgvt_pack_ell.restype = ctypes.c_int
            lib.ncgvt_pack_ell.argtypes = [
                _I64P, _I64P, _F64P, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, _F64P, ctypes.POINTER(ctypes.c_int32)]
            _libs[path] = lib
        return lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def read_coordinate(path):
    """The entries of a MatrixMarket coordinate file with a value on each
    line: ``(row, col, val)``, 0-based int64 indices and float64 values, in
    file order.  Raises ``ValueError`` on a file it cannot parse."""
    lib = _load()
    row_p, col_p, val_p = _I64P(), _I64P(), _F64P()
    nnz = lib.ncgvt_read_coordinate(os.fspath(path).encode(),
                                    ctypes.byref(row_p), ctypes.byref(col_p),
                                    ctypes.byref(val_p))
    if nnz < 0:
        raise ValueError(f"native MatrixMarket parse failed for {path}")
    try:
        return tuple(np.ctypeslib.as_array(ptr, shape=(nnz,)).copy()
                     for ptr in (row_p, col_p, val_p))
    finally:
        for ptr in (row_p, col_p, val_p):
            lib.ncgvt_free(ptr)


def pack_ell(row, col, val, n: int, L: int):
    """COO sorted by (row, col) to padded ELL: ``(val, idx)``, ``(n, L)``
    views of slot-major ``(L, n)`` float64 / int32 arrays, padding value 0
    and index i, as :func:`~..ops.operators.build_ell` returns them.
    Raises ``ValueError`` when a row is out of range or holds more than
    ``L`` entries."""
    lib = _load()
    row = np.ascontiguousarray(row, dtype=np.int64)
    col = np.ascontiguousarray(col, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.float64)
    if not (row.shape == col.shape == val.shape and row.ndim == 1):
        raise ValueError("row, col and val must be 1-D of one length")
    val_t = np.zeros((L, n), dtype=np.float64)
    idx_t = np.tile(np.arange(n, dtype=np.int32), (L, 1))
    rc = lib.ncgvt_pack_ell(
        row.ctypes.data_as(_I64P), col.ctypes.data_as(_I64P),
        val.ctypes.data_as(_F64P), len(val), n, L,
        val_t.ctypes.data_as(_F64P),
        idx_t.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"native ELL pack failed: a row index outside [0, "
                         f"{n}) or a row of more than {L} entries")
    return val_t.T, idx_t.T
