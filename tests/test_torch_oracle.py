"""Port parity: the extended-precision oracle (``solvers/oracle.py``).

The port's ``exact_cg`` / ``exact_pcg`` run on the host in ``np.longdouble``,
as the JAX package's do, so on the same numpy / scipy inputs they must give
the JAX package's histories and ``x`` bit for bit: dense input, and CSR input
through the sparse branch (``_SPARSE_MIN_N`` lowered in both modules), with
and without Jacobi.  A port operator (half-band, full DIA, dense, ELL in its
RCM order) hands over its host matrix through ``tocsr()`` / ``todense()``;
against the JAX operator of the same matrix the histories agree to rtol
1e-14 (the two CSR assemblies may sum a row in another order).  A tensor on
the CPU gives the numpy input's bits; an unknown probe raises.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.matio.matrix_market import CooMatrix as JaxCoo
from new_cg_variants_tpu.ops import operators as jo
from new_cg_variants_tpu.solvers import oracle as jor
from new_cg_variants_tpu.solvers.precond import (
    JacobiPreconditioner as JaxJacobi,
)
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops import operators as to
from new_cg_variants_tpu_torch.solvers import oracle as tor
from new_cg_variants_tpu_torch.solvers.precond import JacobiPreconditioner

from conftest import make_spd

ALL_PROBES = tor.KNOWN_PROBES
OP_RTOL = 1e-14


def assert_same(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            assert a[key] == b[key], key


def assert_close(a, b, rtol=OP_RTOL):
    assert set(a) == set(b)
    assert a["iterations"] == b["iterations"]
    for key in a:
        if isinstance(a[key], np.ndarray):
            scale = np.abs(b[key]).max() or 1.0
            np.testing.assert_allclose(a[key], b[key], rtol=rtol,
                                       atol=rtol * scale, err_msg=key)


def dense_problem(n=48, seed=3):
    a = make_spd(n, cond=1e3, seed=seed)
    a += np.diag(np.linspace(0.0, 2.0, n))  # a diagonal for Jacobi to act on
    b = a @ np.linspace(0.5, 1.5, n)
    return a, b


@pytest.mark.parametrize("prec", [None, "jacobi"])
@pytest.mark.parametrize("form", ["dense", "csr", "coo", "csr-sparse-branch"])
def test_exact_pcg_bitwise_equals_jax(monkeypatch, form, prec):
    a, b = dense_problem()
    if form == "csr-sparse-branch":
        monkeypatch.setattr(tor, "_SPARSE_MIN_N", 16)
        monkeypatch.setattr(jor, "_SPARSE_MIN_N", 16)
    if form == "dense":
        ta = ja = a
    elif form == "coo":
        c = sp.coo_matrix(a)
        row, col = c.row.astype(np.int64), c.col.astype(np.int64)
        ta = port.CooMatrix(a.shape, row, col, c.data)
        ja = JaxCoo(a.shape, row.copy(), col.copy(), c.data.copy())
    else:
        ta = ja = sp.csr_matrix(a)
    kw = dict(max_iter=60, probes=ALL_PROBES, preconditioner=prec)
    assert_same(port.exact_pcg(ta, b, **kw), cgt.exact_pcg(ja, b, **kw))


@pytest.mark.parametrize("branch", ["dense", "sparse"])
def test_exact_cg_bitwise_equals_jax(monkeypatch, branch):
    a, b = dense_problem(40, seed=5)
    if branch == "sparse":
        monkeypatch.setattr(tor, "_SPARSE_MIN_N", 16)
        monkeypatch.setattr(jor, "_SPARSE_MIN_N", 16)
    a = sp.csr_matrix(a)
    kw = dict(max_iter=50, probes=("residual_2_norm", "error_A_norm", "nu"))
    out = port.exact_cg(a, b, **kw)
    assert out["name"] == "exact_cg"
    assert_same(out, cgt.exact_cg(a, b, **kw))


def test_exact_pcg_x0_and_x_true_bitwise():
    a, b = dense_problem(32, seed=7)
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal(32)
    x_true = np.linalg.solve(a, b)
    kw = dict(x0=x0, x_true=x_true, max_iter=40,
              probes=("error_2_norm", "save_x"), preconditioner="jacobi")
    assert_same(port.exact_pcg(a, b, **kw), cgt.exact_pcg(a, b, **kw))


def test_preconditioner_objects_run_on_the_host():
    """The port's Jacobi object (a tensor inside) against the JAX package's
    holding the same float64 diagonal as numpy (which the JAX oracle
    multiplies in long double), bit for bit; any other object with
    ``apply`` takes a float64 CPU tensor, and its result is read back."""
    a, b = dense_problem()
    d = 1.0 / np.diag(a)
    tpc = JacobiPreconditioner(torch.from_numpy(d))
    jpc = JaxJacobi(np.asarray(d))
    kw = dict(max_iter=50, probes=("updated_residual_2_norm", "alpha"))
    assert_same(port.exact_pcg(a, b, preconditioner=tpc, **kw),
                cgt.exact_pcg(a, b, preconditioner=jpc, **kw))

    class Halving:
        seen = []

        def apply(self, v):
            self.seen.append((v.dtype, v.device.type))
            return 0.5 * v

    def halving_in_float64(v):
        return np.asarray(0.5 * v.astype(np.float64), dtype=np.longdouble)

    out = port.exact_pcg(a, b, preconditioner=Halving(), **kw)
    ref = port.exact_pcg(a, b, preconditioner=halving_in_float64, **kw)
    assert set(Halving.seen) == {(torch.float64, "cpu")}
    assert_same(out, ref)


def test_tensor_input_equals_numpy_bitwise():
    a, b = dense_problem()
    kw = dict(max_iter=40, probes=ALL_PROBES, preconditioner="jacobi")
    assert_same(port.exact_pcg(torch.from_numpy(a), torch.from_numpy(b), **kw),
                port.exact_pcg(a, b, **kw))


def _operators(kind):
    """The same matrix as a port operator (on the CPU) and a JAX operator,
    with its right-hand side."""
    if kind in ("symdia", "dia"):
        top, b, _ = port.banded_model(300, k=5, kappa=100.0, fmt=kind,
                                      device="cpu")
        jop, _, _ = cgt.banded_model(300, k=5, kappa=100.0, fmt=kind)
        return top, jop, b
    if kind == "dense":
        a, b = dense_problem(40, seed=9)
        return port.as_operator(a, device="cpu"), jo.as_operator(a), b
    # ELL in the RCM order from_coo keeps: a permuted 2-D Laplacian
    m = 12
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    a = (sp.kron(t, sp.eye(m)) + sp.kron(sp.eye(m), t)).tocsr()
    p = np.random.default_rng(4).permutation(m * m)
    a = a[p][:, p].tocoo()
    row, col = a.row.astype(np.int64), a.col.astype(np.int64)
    top = port.from_coo(port.CooMatrix(a.shape, row, col, a.data), fmt="ell",
                        device="cpu")
    assert top.perm is not None
    jop = jo.from_coo(JaxCoo(a.shape, row.copy(), col.copy(), a.data.copy()),
                      fmt="ell")
    return top, jop, a @ np.ones(m * m)


@pytest.mark.parametrize("prec", [None, "jacobi"])
@pytest.mark.parametrize("branch", ["dense", "sparse"])
@pytest.mark.parametrize("kind", ["symdia", "dia", "dense", "ell"])
def test_port_operator_against_jax_operator(monkeypatch, kind, branch, prec):
    if branch == "sparse":
        monkeypatch.setattr(tor, "_SPARSE_MIN_N", 16)
        monkeypatch.setattr(jor, "_SPARSE_MIN_N", 16)
    top, jop, b = _operators(kind)
    kw = dict(max_iter=40, probes=ALL_PROBES, preconditioner=prec)
    assert_close(port.exact_pcg(top, b, **kw), cgt.exact_pcg(jop, b, **kw))


def test_ell_in_locality_order_equals_given_order():
    """The oracle reads an ELL operator kept in RCM order in its original
    numbering: the same matrix in the given order gives the same bits."""
    top, _, b = _operators("ell")
    given = to.EllOperator(top.val, top.idx, top.nnz)
    kw = dict(max_iter=40, probes=ALL_PROBES)
    assert_same(port.exact_pcg(top, b, **kw), port.exact_pcg(given, b, **kw))


def test_unknown_probe_raises():
    a, b = dense_problem(16)
    with pytest.raises(ValueError, match="unknown oracle probes"):
        port.exact_pcg(a, b, probes=("error_A_norm", "mu"))


def test_early_exit_truncates_and_exports():
    a, b = dense_problem(24, seed=11)
    out = port.exact_pcg(a, b, max_iter=200, probes=("nu",))
    assert out["iterations"] < 199
    assert out["nu"].shape == (out["iterations"] + 1,)
    assert out["x"].dtype == np.float64
    from new_cg_variants_tpu_torch.solvers import variants

    assert {"exact_cg", "exact_pcg"} <= set(port.__all__)
    assert variants.exact_pcg is port.exact_pcg
