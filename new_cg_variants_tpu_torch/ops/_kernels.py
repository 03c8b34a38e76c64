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

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "build", "load", "library", "using", "nvcc_command",
           "KERNEL_TILE", "SYM_FAMILY_TILE", "MAX_DIAGS", "KERNEL_DTYPES",
           "STORAGE_DTYPES", "compute_dtype", "offsets_array", "check_band",
           "check_ell", "check_vectors"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("sym_dia.cu", "sym_family.cu", "dia_spmv.cu", "pipe_vector.cu",
           "dia_family.cu", "df_spmv.cu", "df_pipe.cu", "ell_spmv.cu")
ARCH = "arch=compute_90a,code=sm_90a"

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_OFFS = ctypes.POINTER(ctypes.c_int)
_PTRS = ctypes.POINTER(_VP)
# argument types of each library's C entry points (csrc/*.cu, extern "C")
_SIGNATURES = {
    "sym_dia.cu": {
        name: [_VP, _OFFS, _INT, _INT, _LL, _VP, _VP, _VP, _VP, _INT, _INT,
               _VP]
        for name in ("sym_dia_spmv_f32", "sym_dia_spmv_f64",
                     "sym_dia_spmv_bf16")
    },
    "sym_family.cu": {
        name: [_INT, _VP, _OFFS, _INT, _INT, _LL, _PTRS, _INT, _PTRS, _INT,
               _PTRS, _INT, _VP, _INT, _VP]
        for name in ("sym_family_f32", "sym_family_f64", "sym_family_bf16")
    },
    "dia_spmv.cu": {
        name: [_VP, _OFFS, _INT, _LL, _VP, _VP, _LL, _LL, _VP, _VP, _INT,
               _INT, _INT, _VP]
        for name in ("dia_spmv_f32", "dia_spmv_f64", "dia_spmv_bf16")
    },
    "pipe_vector.cu": {
        name: [_INT, _LL, _PTRS, _INT, _PTRS, _INT, _PTRS, _INT, _VP, _INT,
               _VP]
        for name in ("pipe_vector_f32", "pipe_vector_f64")
    },
    "dia_family.cu": {
        name: [_INT, _VP, _OFFS, _INT, _LL, _PTRS, _INT, _PTRS, _INT, _PTRS,
               _INT, _VP, _INT, _VP]
        for name in ("dia_family_f32", "dia_family_f64", "dia_family_bf16")
    },
    "df_spmv.cu": {
        "df_dia_spmv_f32": [_VP, _VP, _VP, _OFFS, _INT, _LL, _PTRS, _PTRS,
                            _INT, _INT, _INT, _VP],
        "df_dense_spmv_f32": [_VP, _VP, _VP, _LL, _PTRS, _PTRS, _INT, _INT,
                              _VP],
    },
    "df_pipe.cu": {
        "df_pipe_f32": [_LL, _PTRS, _INT, _PTRS, _INT, _PTRS, _INT, _VP, _VP,
                        _VP, _INT, _VP],
    },
    "ell_spmv.cu": {
        **{name: [_VP, _VP, _INT, _LL, _VP, _VP, _VP, _VP, _VP, _INT, _INT,
                  _VP] for name in ("ell_spmv_f32", "ell_spmv_f64",
                                    "ell_spmv_bf16")},
        **{name: [_VP, _LL, _VP, _VP, _VP, _INT, _INT, _VP]
           for name in ("ell_gather_f32", "ell_gather_f64")},
    },
}

#: threads per block of every kernel, rows per block of all but the
#: half-band family kernel, rows per dot partial (csrc/sym_common.cuh:kTile)
KERNEL_TILE = 256
#: rows per block of the half-band family kernel, two a thread
#: (csrc/sym_family.cu:kFamilyTile)
SYM_FAMILY_TILE = 512
#: stored diagonals a launch may take (csrc/sym_common.cuh:kMaxDiags)
MAX_DIAGS = 256
#: suffix of the C entry point per element type of the vectors
KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
#: per element type of a stored matrix (band, ELL values): the suffix of the
#: C entry points that take it and the element type of the vectors, scalars
#: and arithmetic that go with it.  bf16 is a storage-only tier: the matrix
#: in bf16, everything else in float32 (csrc/storage.cuh)
STORAGE_DTYPES = {
    torch.float32: ("f32", torch.float32),
    torch.float64: ("f64", torch.float64),
    torch.bfloat16: ("bf16", torch.float32),
}


def compute_dtype(dtype):
    """The vectors' element type of a kernel on data stored as ``dtype``
    (``dtype`` itself where it is no storage type of a kernel)."""
    return STORAGE_DTYPES.get(dtype, (None, dtype))[1]


@functools.lru_cache(maxsize=64)
def offsets_array(offsets: tuple):
    """The stored offsets as a C ``int`` array."""
    return (ctypes.c_int * len(offsets))(*offsets)


def check_band(offsets, data):
    """Validate the stored band a CUDA kernel is handed; return ``(n,
    suffix)``, the dimension and the suffix of the C entry point."""
    if not data.is_cuda:
        raise ValueError("operator data must lie on the CUDA device")
    if data.dtype not in STORAGE_DTYPES:
        raise TypeError(
            f"the CUDA band kernels take float32, float64 or bfloat16 data, "
            f"not {data.dtype}")
    ndiag, n = data.shape
    if not data.is_contiguous():
        raise ValueError("operator data must be contiguous (ndiag, n)")
    if len(offsets) != ndiag:
        raise ValueError(f"{len(offsets)} offsets for {ndiag} diagonals")
    if ndiag > MAX_DIAGS:
        raise ValueError(f"{ndiag} stored diagonals > {MAX_DIAGS}")
    if n == 0:
        raise ValueError("empty operator")
    return n, STORAGE_DTYPES[data.dtype][0]


def check_ell(val, idx):
    """Validate the padded-ELL arrays a CUDA kernel is handed: ``(n, L)``
    views of slot-major storage (``val.T`` / ``idx.T`` contiguous), values
    float32, float64 or bfloat16, indices int32.  Return ``(n, L,
    suffix)``."""
    if not (val.is_cuda and idx.device == val.device):
        raise ValueError("ELL values and indices must lie on one CUDA device")
    if val.dtype not in STORAGE_DTYPES:
        raise TypeError(
            f"the CUDA ELL kernel takes float32, float64 or bfloat16 values, "
            f"not {val.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"ELL indices must be int32, not {idx.dtype}")
    if val.ndim != 2 or idx.shape != val.shape:
        raise ValueError(f"ELL arrays of shapes {tuple(val.shape)} and "
                         f"{tuple(idx.shape)}, expected one (n, L)")
    if not (val.T.is_contiguous() and idx.T.is_contiguous()):
        raise ValueError("ELL arrays must be (n, L) views of contiguous "
                         "slot-major (L, n) storage")
    n, L = val.shape
    if n == 0 or L == 0 or n >= 2 ** 31:
        raise ValueError(f"ELL shape ({n}, {L}) out of range")
    return n, L, STORAGE_DTYPES[val.dtype][0]


def check_vectors(ref, vecs, n):
    """Every vector on ``ref``'s device, of the vectors' dtype that goes
    with ``ref``'s (:func:`compute_dtype`: float32 for bf16 data),
    contiguous ``(n,)``."""
    want = compute_dtype(ref.dtype)
    for v in vecs:
        if v.device != ref.device:
            raise ValueError(f"vector on {v.device}, expected {ref.device}")
        if v.dtype != want:
            raise TypeError(f"vector {v.dtype} != {want} (data {ref.dtype})")
        if v.shape != (n,) or not v.is_contiguous():
            raise ValueError(f"vector must be contiguous ({n},), "
                             f"got {tuple(v.shape)}")


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


def _build_dir(csrc: Path, build_root: Path) -> Path:
    h = hashlib.sha256()
    for f in sorted(csrc.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return build_root / h.hexdigest()[:16]


def build(csrc=None, build_root=None) -> dict[str, Path]:
    """Build every missing library, all sources at once; return their paths.

    ``csrc`` / ``build_root``: another directory of sources (an edited copy,
    for a kernel study) and where its libraries go; default the package's
    own.  Of :data:`SOURCES` those that ``csrc`` holds are built.

    Each compile writes to a temporary name and is renamed into place, so a
    concurrent or interrupted build never leaves a half-written library.
    ``nvcc``'s output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) goes to ``<lib>.log`` beside the library.
    """
    csrc = Path(csrc or CSRC)
    out_dir = _build_dir(csrc, Path(build_root or BUILD_ROOT))
    paths = {src: out_dir / f"lib{Path(src).stem}.so" for src in SOURCES
             if (csrc / src).exists()}
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
            nvcc_command(nvcc, csrc / src, tmp), stdout=log,
            stderr=subprocess.STDOUT, cwd=csrc,
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


def load(source: str, path) -> ctypes.CDLL:
    """Load one built library and declare its entry points' types."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = load(source, build()[source])
        return lib


@contextlib.contextmanager
def using(libs: dict):
    """Within the block the wrappers launch the kernels of ``libs`` (source ->
    library from :func:`load`, built from another directory of sources) in
    place of the package's own: how a kernel study runs an edited kernel
    through the port's wrappers and checks."""
    with _lock:
        saved = dict(_libs)
        _libs.update(libs)
    try:
        yield
    finally:
        with _lock:
            _libs.clear()
            _libs.update(saved)
