"""The port's native MatrixMarket reader and ELL packing.

``read_mtx(path, native=True)`` takes the port's C++ reader
(``new_cg_variants_tpu_torch/native/matio.cpp``, built with ``g++`` at first
use) for coordinate files of more than ``NATIVE_MIN_NNZ`` entries whose
field is not ``pattern``, and must return the Python parser's
``CooMatrix``: the same ``row``, ``col`` and ``val``, in the same order.
Held on files ``write_mtx`` writes (``banded_model`` symmetric, ``make_spd``
general and symmetric; above the threshold as it is and below it with the
threshold lowered) and on small hand-written integer, skew-symmetric and
pattern files; the reader's triplets are also held to the JAX package's
``_native.read_coordinate`` over its own ``native/matio.cpp``, built here
into a temporary directory (``native/`` is not written to).  ``build_ell``
packs through ``pack_ell`` and must give the numpy packing's arrays
(``_build_ell_numpy``, its packing before) bit for bit, and the JAX
package's ``_native.pack_ell`` values.  A failed build raises with the
compiler's output; nothing falls back to Python.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest
from conftest import make_spd

from new_cg_variants_tpu.matio import _native as jax_native
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.matio import _native
from new_cg_variants_tpu_torch.matio import matrix_market as mm
from new_cg_variants_tpu_torch.ops.operators import _build_ell_numpy, build_ell

ROOT = Path(__file__).resolve().parent.parent

HAND_WRITTEN = {
    "integer general": (
        "%%MatrixMarket matrix coordinate integer general\n"
        "% a comment\n"
        "3 4 5\n1 1 7\n2 3 -2\n3 4 11\n1 4 3\n3 1 -5\n"),
    "real skew-symmetric": (
        "%%MatrixMarket matrix coordinate real skew-symmetric\n"
        "4 4 3\n2 1 0.5\n4 2 -1.25e-3\n3 1 2.0\n"),
    "real symmetric, duplicates": (
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 5\n1 1 1.0\n2 1 0.25\n2 1 0.25\n3 3 -0.0\n3 2 1e-300\n"),
    "pattern symmetric": (
        "%%MatrixMarket matrix coordinate pattern symmetric\n"
        "3 3 3\n1 1\n2 1\n3 2\n"),
}


def same_coo(got, want):
    assert got.shape == want.shape
    for name in ("row", "col", "val"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert np.array_equal(np.signbit(got.val), np.signbit(want.val))


def _write_band(path, n, k):
    op, _, _ = port.banded_model(n, k=k, kappa=1e4, device="cpu")
    port.write_mtx(str(path), port.ops.operators.coo_from_scipy(op.tocsr()),
                   symmetric=True)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    out = {"band large": _write_band(d / "band_large.mtx", 30_000, 8),
           "band small": _write_band(d / "band_small.mtx", 500, 4)}
    a = make_spd(40, seed=3)
    for sym in (False, True):
        path = d / f"spd_{'sym' if sym else 'gen'}.mtx"
        port.write_mtx(str(path), a, symmetric=sym)
        out[f"spd {'symmetric' if sym else 'general'}"] = path
    for name, text in HAND_WRITTEN.items():
        path = d / (name.split(",")[0].replace(" ", "_") + ".mtx")
        path.write_text(text)
        out[name] = path
    return out


def test_the_large_file_is_above_the_threshold(files):
    coo = mm.read_mtx(str(files["band large"]), native=False)
    # entries as stored: the lower triangle and the diagonal
    assert np.count_nonzero(coo.row >= coo.col) > mm.NATIVE_MIN_NNZ


@pytest.mark.parametrize("name", ["band large", "band small", "spd general",
                                  "spd symmetric", "integer general",
                                  "real skew-symmetric",
                                  "real symmetric, duplicates",
                                  "pattern symmetric"])
@pytest.mark.parametrize("threshold", ["as is", "lowered"])
def test_native_read_gives_the_python_coo(files, monkeypatch, name,
                                          threshold):
    path = str(files[name])
    want = mm.read_mtx(path, native=False)
    if threshold == "lowered":
        monkeypatch.setattr(mm, "NATIVE_MIN_NNZ", 0)
    calls = []
    reader = _native.read_coordinate
    monkeypatch.setattr(_native, "read_coordinate",
                        lambda p: calls.append(p) or reader(p))
    same_coo(mm.read_mtx(path, native=True), want)
    native_route = name != "pattern symmetric" and (
        threshold == "lowered" or name == "band large")
    assert len(calls) == int(native_route)


def test_native_reader_refuses_a_pattern_file(files):
    with pytest.raises(ValueError, match="parse failed"):
        _native.read_coordinate(str(files["pattern symmetric"]))


@pytest.fixture(scope="module")
def jax_library(tmp_path_factory):
    """The JAX package's native library, built from ``native/matio.cpp``
    into a temporary directory."""
    so = tmp_path_factory.mktemp("jax_native") / "libncgv_native.so"
    subprocess.run(["g++", "-std=c++17", "-O3", "-fPIC", "-shared", "-o",
                    str(so), str(ROOT / "native" / "matio.cpp")], check=True)
    return so


@pytest.fixture
def jax_reader(jax_library, monkeypatch):
    monkeypatch.setattr(jax_native, "_SO_PATH", jax_library)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_build_failed", False)
    return jax_native


@pytest.mark.parametrize("name", ["band large", "band small", "spd general",
                                  "spd symmetric", "integer general",
                                  "real skew-symmetric",
                                  "real symmetric, duplicates"])
def test_triplets_match_the_jax_native_reader(files, jax_reader, name):
    got = _native.read_coordinate(str(files[name]))
    want = jax_reader.read_coordinate(str(files[name]))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _sorted_coo(seed, n=300, density=0.03):
    """A random COO with empty rows, duplicates and -0.0 values, sorted by
    (row, col) as pack_ell takes it."""
    rng = np.random.default_rng(seed)
    nnz = int(n * n * density)
    row = rng.integers(0, n, nnz)
    row = row[row % 7 != 3]  # some empty rows
    col = rng.integers(0, n, row.size)
    row = np.concatenate([row, row[:20]])  # duplicates
    col = np.concatenate([col, col[:20]])
    val = rng.standard_normal(row.size)
    val[::11] = -0.0
    order = np.lexsort((col, row))
    return port.CooMatrix((n, n), row[order], col[order], val[order])


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("seed", range(4))
def test_build_ell_packs_natively_the_numpy_packings_bits(seed, order,
                                                          jax_reader,
                                                          monkeypatch):
    coo = _sorted_coo(seed)
    given = coo
    if order == "shuffled":  # build_ell sorts; pack_ell takes sorted input
        perm = np.random.default_rng(seed).permutation(coo.nnz)
        given = port.CooMatrix(coo.shape, coo.row[perm], coo.col[perm],
                               coo.val[perm])
    calls = []
    pack = _native.pack_ell
    monkeypatch.setattr(_native, "pack_ell",
                        lambda *a: calls.append(1) or pack(*a))
    val, idx, nnz = build_ell(given)
    assert calls == [1]
    want_val, want_idx, want_nnz = _build_ell_numpy(given)
    assert val.shape == want_val.shape and idx.shape == want_idx.shape
    assert val.T.flags.c_contiguous and idx.T.flags.c_contiguous
    assert val.dtype == np.float64 and idx.dtype == np.int32
    assert val.tobytes() == want_val.tobytes()
    assert np.array_equal(idx, want_idx) and nnz == want_nnz == coo.nnz
    if order == "sorted":  # (shuffled duplicates may swap slots)
        jval, jidx = jax_reader.pack_ell(coo.row, coo.col, coo.val,
                                         coo.shape[0], val.shape[1])
        assert np.array_equal(val, jval) and np.array_equal(idx, jidx)


def test_pack_ell_refuses_a_row_longer_than_L():
    coo = _sorted_coo(0)
    L = _build_ell_numpy(coo)[0].shape[1]
    with pytest.raises(ValueError, match="more than"):
        _native.pack_ell(coo.row, coo.col, coo.val, coo.shape[0], L - 1)


def test_a_failed_build_raises_with_the_compilers_output(files, monkeypatch,
                                                          tmp_path):
    broken = tmp_path / "matio.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", broken)
    monkeypatch.setattr(_native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(mm, "NATIVE_MIN_NNZ", 0)
    with pytest.raises(RuntimeError, match="failed") as info:
        mm.read_mtx(str(files["spd general"]), native=True)
    assert "error" in str(info.value)
    assert not _native.available()
    # the Python parser still reads the file when asked for it
    assert mm.read_mtx(str(files["spd general"]), native=False).nnz > 0


def test_build_lands_in_the_ignored_directory_without_march_native():
    path = _native.build()
    assert _native.available()
    assert path.is_relative_to(_native.BUILD_ROOT)
    cmd = _native.compile_command("g++", "matio.cpp", "libmatio.so")
    assert not any(flag.startswith("-march") for flag in cmd)
    for flag in ("-O3", "-fPIC", "-shared", "-std=c++17"):
        assert flag in cmd
