"""Port parity: model problems are built bit-identically to the JAX package."""

import numpy as np
import pytest

from new_cg_variants_tpu.matio import problems as jp
from new_cg_variants_tpu_torch.matio import problems as tp


@pytest.mark.parametrize("n,k", [(64, 2), (1000, 8), (4096, 32), (4099, 17)])
def test_banded_model_symdia_bit_identical(n, k):
    jop, jb, jx = jp.banded_model(n, k=k, fmt="symdia")
    top, tb, tx = tp.banded_model(n, k=k, fmt="symdia", device="cpu")
    assert top.offsets == tuple(jop.offsets)
    np.testing.assert_array_equal(top.data.numpy(), np.asarray(jop.data))
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tx, jx)
    assert top.nnz == jop.nnz


def test_model_spectrum_and_diagonal_bit_identical():
    np.testing.assert_array_equal(tp.model_spectrum_eigenvalues(777),
                                  jp.model_spectrum_eigenvalues(777))
    np.testing.assert_array_equal(tp.banded_model_diagonal(777, kappa=1e4),
                                  jp.banded_model_diagonal(777, kappa=1e4))


@pytest.mark.parametrize("fmt,error,match", [
    ("csr", ValueError, "unknown fmt"),
    ("ell", ValueError, "unknown fmt"),
])
def test_unported_formats_raise(fmt, error, match):
    """A name that is no format of ``banded_model`` is a ``ValueError`` (as in
    the JAX package, it builds ``dia``, ``symdia`` and ``stencil``; the
    stencil is compared with the JAX package in test_torch_stencil.py)."""
    with pytest.raises(error, match=match):
        tp.banded_model(64, k=2, fmt=fmt, device="cpu")


def test_dia_format_is_ported():
    """``fmt="dia"`` builds a ``DiaOperator`` (compared with the JAX package
    in test_torch_operators.py)."""
    op, b, _ = tp.banded_model(64, k=2, fmt="dia", device="cpu")
    assert op.offsets == (-1, 0, 1) and b.shape == (64,)
