"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles on its own, with ``nvcc`` for Hopper
(``sm_90a``), into a shared library with a plain C interface that is loaded
through ``ctypes``.  The libraries land in ``_build/<hash of csrc>/`` inside
the package (a directory that ``.gitignore`` lists), so an edit of any source
or header rebuilds everything, and an unchanged checkout builds once.  All
sources compile in parallel, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module, and the CPU
has neither ``nvcc`` nor a card.  The first CUDA launch calls :func:`library`,
which builds what is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build", "library", "nvcc_command"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("sym_dia.cu", "sym_family.cu")
ARCH = "arch=compute_90a,code=sm_90a"

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_OFFS = ctypes.POINTER(ctypes.c_int)
# argument types of each library's C entry points (csrc/*.cu, extern "C")
_SIGNATURES = {
    "sym_dia.cu": {
        name: [_VP, _OFFS, _INT, _INT, ctypes.c_longlong, _VP, _VP, _VP, _VP,
               _INT, _INT, _VP]
        for name in ("sym_dia_spmv_f32", "sym_dia_spmv_f64")
    },
    "sym_family.cu": {
        name: [_INT, _VP, _OFFS, _INT, _INT, ctypes.c_longlong,
               ctypes.POINTER(_VP), _INT, ctypes.POINTER(_VP), _INT,
               ctypes.POINTER(_VP), _INT, _VP, _INT, _VP]
        for name in ("sym_family_f32", "sym_family_f64")
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_command(nvcc, source, output) -> list[str]:
    """The ``nvcc`` command line that builds one source into a library."""
    return [
        str(nvcc), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(output), str(source),
    ]


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _build_dir() -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Build every missing library, all sources at once; return their paths.

    Each compile writes to a temporary name and is renamed into place, so a
    concurrent or interrupted build never leaves a half-written library.
    ``nvcc``'s output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) goes to ``<lib>.log`` beside the library.
    """
    out_dir = _build_dir()
    paths = {src: out_dir / f"lib{Path(src).stem}.so" for src in SOURCES}
    todo = {src: p for src, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        procs[src] = (subprocess.Popen(
            nvcc_command(nvcc, CSRC / src, tmp), stdout=log,
            stderr=subprocess.STDOUT, cwd=CSRC,
        ), tmp, log)
    failed = []
    for src, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[src])
        else:
            failed.append(src)
    if failed:
        logs = "\n".join(
            paths[s].with_suffix(".log").read_text() for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build()[source]))
            for name, argtypes in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib
