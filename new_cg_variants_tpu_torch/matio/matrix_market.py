"""MatrixMarket I/O: the port of the JAX package's ``matio/matrix_market.py``.

Reads the ``.mtx`` fixtures of the reference repository (read there with
``scipy.io.mmread``, ``numerical_experiments/figure_gen.py:350``) in the two
layouts they use, ``matrix coordinate real {general,symmetric}`` and ``matrix
array real {general,symmetric}``, plus ``integer`` and ``pattern`` fields.
Symmetric input is expanded to both triangles.

:func:`read_mtx` takes the native C++ reader (:mod:`._native`, the port's
``native/matio.cpp``) for large numeric coordinate files, as the JAX package
does, and the pure-Python parser otherwise; both give the same
:class:`CooMatrix`.  A native reader that fails to build raises: there is no
quiet fallback to Python.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

__all__ = ["CooMatrix", "read_mtx", "write_mtx", "matrix_path", "load_matrix"]

#: coordinate files of more entries than this take the native reader (the
#: JAX package's threshold, ``matio/matrix_market.py:98``)
NATIVE_MIN_NNZ = 200_000


@dataclass
class CooMatrix:
    """Minimal COO container returned by :func:`read_mtx`.

    Rows/cols are 0-based int64, values float64.  ``shape`` is (m, n).
    Symmetric inputs are expanded (both triangles present); duplicates are
    kept as they are.
    """

    shape: tuple
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.val.size)

    def toarray(self) -> np.ndarray:
        a = np.zeros(self.shape, dtype=np.float64)
        np.add.at(a, (self.row, self.col), self.val)
        return a

    def tocsr(self):
        """Convert to scipy CSR (duplicates summed)."""
        import scipy.sparse as sp

        return sp.coo_matrix((self.val, (self.row, self.col)),
                             shape=self.shape).tocsr()


def _parse_header(line: str):
    parts = line.strip().lower().split()
    if len(parts) < 5 or parts[0] != "%%matrixmarket" or parts[1] != "matrix":
        raise ValueError(f"not a MatrixMarket file: {line!r}")
    fmt, field, symmetry = parts[2], parts[3], parts[4]
    if fmt not in ("coordinate", "array"):
        raise ValueError(f"unsupported format {fmt!r}")
    if field not in ("real", "integer", "pattern", "double"):
        raise ValueError(f"unsupported field {field!r}")
    if symmetry not in ("general", "symmetric", "skew-symmetric"):
        raise ValueError(f"unsupported symmetry {symmetry!r}")
    return fmt, field, symmetry


def read_mtx(path: str, native: bool = True) -> CooMatrix:
    """Read a MatrixMarket file into a :class:`CooMatrix`.

    Symmetric matrices are expanded so that both triangles are stored, as
    ``scipy.io.mmread`` does.  With ``native`` a coordinate file of more than
    :data:`NATIVE_MIN_NNZ` entries whose field is not ``pattern`` is parsed
    by the native reader (:func:`._native.read_coordinate`); every other file
    by the Python parser.  The entries, their order and the symmetry
    expansion are the same either way.
    """
    with open(path, "r") as f:
        fmt, field, symmetry = _parse_header(f.readline())
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        size_parts = line.split()

        if fmt == "coordinate":
            m, n, nnz = (int(size_parts[0]), int(size_parts[1]),
                         int(size_parts[2]))
            if native and nnz > NATIVE_MIN_NNZ and field != "pattern":
                from . import _native

                row, col, val = _native.read_coordinate(path)
                return _expand_symmetry(CooMatrix((m, n), row, col, val),
                                        symmetry)
            if field == "pattern":
                data = np.loadtxt(f, dtype=np.int64, ndmin=2, usecols=(0, 1))
                row = data[:, 0] - 1
                col = data[:, 1] - 1
                val = np.ones(len(row), dtype=np.float64)
            else:
                data = np.loadtxt(f, dtype=np.float64, ndmin=2)
                row = data[:, 0].astype(np.int64) - 1
                col = data[:, 1].astype(np.int64) - 1
                val = (data[:, 2] if data.shape[1] > 2
                       else np.ones(len(row), dtype=np.float64))
            if len(row) != nnz:
                raise ValueError(f"expected {nnz} entries, read {len(row)}")
            return _expand_symmetry(CooMatrix((m, n), row, col, val), symmetry)

        # array (dense, column-major)
        m, n = int(size_parts[0]), int(size_parts[1])
        vals = np.loadtxt(f, dtype=np.float64).ravel()
        if symmetry == "general":
            if vals.size != m * n:
                raise ValueError("bad array entry count")
            a = vals.reshape((n, m)).T  # column-major
            row, col = np.nonzero(np.ones_like(a, dtype=bool))
            return CooMatrix((m, n), row, col, a[row, col])
        # symmetric / skew: the lower triangle, column by column
        ii, jj = np.tril_indices(m, 0, n)
        order = np.lexsort((ii, jj))  # by column, then row, as stored
        row = ii[order].astype(np.int64)
        col = jj[order].astype(np.int64)
        if vals.size != row.size:
            raise ValueError("bad symmetric array entry count")
        return _expand_symmetry(CooMatrix((m, n), row, col, vals), symmetry)


def _expand_symmetry(coo: CooMatrix, symmetry: str) -> CooMatrix:
    if symmetry == "general":
        return coo
    off = coo.row != coo.col
    sign = -1.0 if symmetry == "skew-symmetric" else 1.0
    row = np.concatenate([coo.row, coo.col[off]])
    col = np.concatenate([coo.col, coo.row[off]])
    val = np.concatenate([coo.val, sign * coo.val[off]])
    return CooMatrix(coo.shape, row, col, val)


def write_mtx(path: str, a, symmetric: bool = False) -> None:
    """Write a dense or COO matrix as ``coordinate real`` MatrixMarket."""
    if isinstance(a, CooMatrix):
        row, col, val, shape = a.row, a.col, a.val, a.shape
    else:
        a = np.asarray(a)
        row, col = np.nonzero(a)
        val = a[row, col]
        shape = a.shape
    if symmetric:
        keep = row >= col
        row, col, val = row[keep], col[keep], val[keep]
    sym = "symmetric" if symmetric else "general"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {sym}\n")
        f.write(f"{shape[0]} {shape[1]} {len(val)}\n")
        for i, j, v in zip(row, col, val):
            f.write(f"{i + 1} {j + 1} {v:.16e}\n")


def matrix_path(name: str) -> str:
    """Resolve a fixture matrix by name, in ``$CG_TPU_MATRIX_DIR`` and then
    the repository's ``matrices/`` directory."""
    candidates = [
        os.environ.get("CG_TPU_MATRIX_DIR", ""),
        os.path.join(os.path.dirname(__file__), "..", "..", "matrices"),
    ]
    fname = name if name.endswith(".mtx") else name + ".mtx"
    for d in candidates:
        if d and os.path.exists(os.path.join(d, fname)):
            return os.path.join(d, fname)
    raise FileNotFoundError(f"matrix {name!r} not found in {candidates}")


def load_matrix(name: str) -> CooMatrix:
    """Load a named fixture matrix (e.g. ``'bcsstk03'``)."""
    return read_mtx(matrix_path(name))
