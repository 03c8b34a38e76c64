"""Port parity: MatrixMarket I/O (``matio/matrix_market``) against the JAX
package's module.

Every file is written here (``write_mtx``, or by hand for the layouts
``write_mtx`` does not produce) from matrices made with numpy from a seed, and
read by both packages: the COO arrays agree exactly.  No fixture of the
reference repository is needed.
"""

import numpy as np
import pytest

from new_cg_variants_tpu.matio import matrix_market as jm
from new_cg_variants_tpu_torch.matio import matrix_market as tm


def random_coo(n=40, density=0.15, seed=0, symmetric=False):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.uniform(size=(n, n)) < density)
    if symmetric:
        a = a + a.T
    np.fill_diagonal(a, rng.uniform(1.0, 2.0, n))
    return a


def same_coo(j, t):
    assert tuple(j.shape) == tuple(t.shape) and j.nnz == t.nnz
    for field in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(j, field), getattr(t, field))


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("symmetric", [False, True], ids=["general",
                                                          "symmetric"])
def test_write_read_round_trip_across_packages(tmp_path, writer, symmetric):
    a = random_coo(symmetric=symmetric)
    path = str(tmp_path / "a.mtx")
    (tm if writer == "port" else jm).write_mtx(path, a, symmetric=symmetric)
    got, want = tm.read_mtx(path), jm.read_mtx(path, native=False)
    same_coo(want, got)
    np.testing.assert_array_equal(got.toarray(), a)
    np.testing.assert_array_equal(got.tocsr().toarray(), a)


def test_writing_a_coo_matrix_round_trips(tmp_path):
    a = random_coo(seed=3)
    row, col = np.nonzero(a)
    coo = tm.CooMatrix(a.shape, row, col, a[row, col])
    path = str(tmp_path / "c.mtx")
    tm.write_mtx(path, coo)
    same_coo(jm.read_mtx(path, native=False), tm.read_mtx(path))
    np.testing.assert_array_equal(tm.read_mtx(path).toarray(), a)


def test_symmetric_expansion_matches_jax(tmp_path):
    """A symmetric file stores one triangle; both packages expand it to both
    (the diagonal once)."""
    a = random_coo(n=30, seed=5, symmetric=True)
    path = str(tmp_path / "s.mtx")
    tm.write_mtx(path, a, symmetric=True)
    got = tm.read_mtx(path)
    assert got.nnz == np.count_nonzero(a)
    same_coo(jm.read_mtx(path, native=False), got)
    np.testing.assert_array_equal(got.toarray(), a)


LAYOUTS = {
    "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                "% a comment\n3 3 4\n1 1\n2 3\n3 1\n3 3\n"),
    "integer": ("%%MatrixMarket matrix coordinate integer symmetric\n"
                "3 3 3\n1 1 4\n2 1 -1\n3 3 7\n"),
    "array": ("%%MatrixMarket matrix array real general\n"
              "2 3\n1.5\n-2\n0\n4\n5.25\n6\n"),
    "array symmetric": ("%%MatrixMarket matrix array real symmetric\n"
                        "3 3\n1\n2\n3\n4\n5\n6\n"),
    "skew-symmetric": ("%%MatrixMarket matrix coordinate real "
                       "skew-symmetric\n3 3 2\n2 1 1.5\n3 2 -2\n"),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_match_jax(tmp_path, layout):
    path = tmp_path / "l.mtx"
    path.write_text(LAYOUTS[layout])
    got = tm.read_mtx(str(path))
    same_coo(jm.read_mtx(str(path), native=False), got)
    assert got.row.dtype == got.col.dtype and got.val.dtype == np.float64


def test_array_symmetric_layout_is_column_major_lower_triangle(tmp_path):
    path = tmp_path / "a.mtx"
    path.write_text(LAYOUTS["array symmetric"])
    np.testing.assert_array_equal(
        tm.read_mtx(str(path)).toarray(),
        [[1.0, 2.0, 3.0], [2.0, 4.0, 5.0], [3.0, 5.0, 6.0]])


@pytest.mark.parametrize("text,match", [
    ("%%MatrixMarket tensor coordinate real general\n1 1 1\n1 1 1\n",
     "not a MatrixMarket"),
    ("%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
     "field"),
    ("%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1\n",
     "expected 3 entries"),
])
def test_bad_files_raise_as_in_jax(tmp_path, text, match):
    path = tmp_path / "bad.mtx"
    path.write_text(text)
    with pytest.raises(ValueError, match=match):
        tm.read_mtx(str(path))
    with pytest.raises(ValueError, match=match):
        jm.read_mtx(str(path), native=False)


def test_load_matrix_finds_a_named_file(tmp_path, monkeypatch):
    a = random_coo(n=12, seed=9, symmetric=True)
    tm.write_mtx(str(tmp_path / "tiny.mtx"), a, symmetric=True)
    monkeypatch.setenv("CG_TPU_MATRIX_DIR", str(tmp_path))
    assert tm.matrix_path("tiny") == str(tmp_path / "tiny.mtx")
    np.testing.assert_array_equal(tm.load_matrix("tiny.mtx").toarray(), a)
    with pytest.raises(FileNotFoundError):
        tm.load_matrix("no_such_matrix")
