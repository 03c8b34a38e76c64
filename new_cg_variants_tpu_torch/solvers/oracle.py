"""Exact-arithmetic oracle: HS-CG with full reorthogonalization.

The ground truth every finite-precision variant is compared against, the
port of the JAX package's ``solvers/oracle.py`` (and of the reference's
``numerical_experiments/cg_variants/exact_cg.py``): HS iteration in extended
precision (``np.longdouble``) with each new residual explicitly
orthogonalized against all previous residuals, and early exit at
``sqrt(nu) < sqrt(nu_0) * 1e-14`` (``exact_cg.py:108,149-150``).

**It runs on the host, in numpy, by design**, and takes no ``device``: no
GPU has an extended-precision type (the H100's widest is float64, the
precision of the runs it is the reference for), and the reference itself
runs its oracle in long double on the CPU (``figure_gen.py:53-55``).  This
is the oracle's definition, not a CPU fallback of a device path.  The
precision is the host's ``np.longdouble``: 80-bit extended on x86-64,
software quad on aarch64 (``np.finfo(np.longdouble)``; the harness records
it in ``env_info``).  The O(k n) reorthogonalization sweep is a GEMV against
the stored residual basis, so it is still vectorized.

Large operators stay SPARSE end to end: above ``_SPARSE_MIN_N`` rows the
matvec runs on a long-double scipy CSR and ``x_true`` comes from a sparse LU
(``exact_cg.py`` iterates on the CSR it is given;
``callbacks/error_A_norm.py:36-39`` spsolve), so the large matrices of the
experiment (n up to ~90k) run without the O(n^2) densification.

``A`` may be any operator of the port (``tocsr()`` / ``todense()`` give
host float64 in the original numbering, an :class:`~..ops.operators.
EllOperator` kept in a locality order included), a
:class:`~..matio.matrix_market.CooMatrix`, a scipy sparse matrix, a numpy
array or a tensor on any device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["exact_cg", "exact_pcg", "KNOWN_PROBES"]


#: above this dimension the oracle keeps A sparse (CSR longdouble)
_SPARSE_MIN_N = 4096

#: probe names the oracle records; anything else raises (no silent
#: zero-filled histories)
KNOWN_PROBES = (
    "updated_residual_2_norm", "residual_2_norm", "error_A_norm",
    "error_2_norm", "alpha", "beta", "nu", "save_x", "save_r",
)


def _host(a):
    """A tensor (any device, any float type) as float64 numpy; anything
    else as it is."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return a


def _as_matrix(A, dtype):
    """Operator/CooMatrix/scipy/array/tensor -> dense ndarray or scipy CSR.

    Sparse-representable operators above ``_SPARSE_MIN_N`` rows come back
    as CSR in the requested (long double) dtype; ``A @ x`` and
    ``A.diagonal()`` work identically on both returns.
    """
    import scipy.sparse as sp

    A = _host(A)
    if sp.issparse(A):
        csr = A.tocsr()
        if csr.shape[0] >= _SPARSE_MIN_N:
            return csr.astype(dtype)
        return np.asarray(csr.toarray(), dtype=dtype)
    if hasattr(A, "tocsr"):
        n = A.n if hasattr(A, "n") else A.shape[0]
        if n >= _SPARSE_MIN_N:
            return A.tocsr().astype(dtype)
    if hasattr(A, "todense"):
        return np.asarray(A.todense(), dtype=dtype)
    if hasattr(A, "toarray"):
        return np.asarray(A.toarray(), dtype=dtype)
    return np.asarray(A, dtype=dtype)


def _solve_x_true(A, b):
    """f64 direct solve, sparse when A is sparse."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    if sp.issparse(A):
        return spla.spsolve(A.astype(np.float64).tocsc(),
                            np.asarray(b, dtype=np.float64))
    return np.linalg.solve(A.astype(np.float64),
                           np.asarray(b, dtype=np.float64))


def _host_preconditioner(preconditioner, dtype):
    """An object with ``apply`` (the port's preconditioners take tensors):
    moved to the host, applied to a float64 CPU tensor, its result read back
    in ``dtype``, as the JAX oracle reads back a JAX preconditioner's
    float64 result."""
    pc = preconditioner.to("cpu") if hasattr(preconditioner, "to") else \
        preconditioner

    def prec(v):
        t = torch.from_numpy(np.asarray(v, dtype=np.float64))
        return np.asarray(_host(pc.apply(t)), dtype=dtype)

    return prec


def exact_cg(A, b, x0=None, max_iter=100, probes=None, dtype=np.longdouble,
             **kwargs):
    return exact_pcg(
        A, b, x0=x0, max_iter=max_iter, probes=probes, preconditioner=None,
        dtype=dtype, _name="exact_cg", **kwargs
    )


def exact_pcg(
    A,
    b,
    x0=None,
    max_iter=100,
    probes=None,
    preconditioner=None,
    x_true=None,
    dtype=np.longdouble,
    tol_factor=1e-14,
    _name="exact_pcg",
    **kwargs,
):
    """HS-PCG with M^{-1}-orthogonalized residuals in extended precision.

    Returns an output dict shaped like :func:`..solvers.api.run` results
    (numpy arrays; ``'x'`` float64): probe histories are truncated at the
    early-exit iteration.  ``preconditioner``: ``None``, ``"jacobi"`` (the
    diagonal of ``A`` in ``dtype``), a Jacobi object (its ``inv_diag`` read
    back to the host, the products in ``dtype``), another object with
    ``apply`` (run on the host, :func:`_host_preconditioner`) or a callable
    on numpy vectors.
    """
    A = _as_matrix(A, dtype)
    b = np.asarray(_host(b), dtype=dtype)
    n = b.shape[0]
    x = np.zeros_like(b) if x0 is None else np.asarray(_host(x0), dtype=dtype)
    if preconditioner is None:
        prec = lambda v: v
    elif isinstance(preconditioner, str) and preconditioner == "jacobi":
        d = 1.0 / np.asarray(A.diagonal())
        prec = lambda v: d * v
    elif hasattr(preconditioner, "inv_diag"):
        # a Jacobi object: its diagonal on the host, applied in ``dtype``
        d = _host(preconditioner.inv_diag)
        prec = lambda v: d * v
    elif hasattr(preconditioner, "apply"):
        prec = _host_preconditioner(preconditioner, dtype)
    else:
        prec = preconditioner

    probes = probes or ("updated_residual_2_norm",)
    unknown = set(probes) - set(KNOWN_PROBES)
    if unknown:
        raise ValueError(
            f"unknown oracle probes {sorted(unknown)}; known: {KNOWN_PROBES}"
        )
    want = set(probes)
    if x_true is None and any(p.startswith("error") for p in want):
        x_true = _solve_x_true(A, b)
    if x_true is not None:
        x_true = np.asarray(_host(x_true), dtype=dtype)

    hist = {
        p: (np.zeros((max_iter, n), dtype=np.float64)
            if p in ("save_x", "save_r")
            else np.zeros(max_iter, dtype=np.float64))
        for p in want
    }

    kmax = min(n, max_iter)
    R = np.zeros((kmax, n), dtype=dtype)
    Rt = np.zeros((kmax, n), dtype=dtype)

    r = b - A @ x
    rt = prec(r)
    nu = r @ rt
    R[0] = r / np.sqrt(nu)
    Rt[0] = rt / np.sqrt(nu)
    p = rt.copy()
    s = A @ p
    mu = p @ s
    a = nu / mu
    tol = np.sqrt(nu) * tol_factor

    def record(k):
        for name in want:
            if name == "updated_residual_2_norm":
                hist[name][k] = float(np.sqrt(r @ r))
            elif name == "residual_2_norm":
                tr = b - A @ x
                hist[name][k] = float(np.sqrt(tr @ tr))
            elif name == "error_A_norm":
                e = x - x_true
                hist[name][k] = float(np.sqrt(e @ (A @ e)))
            elif name == "error_2_norm":
                hist[name][k] = float(np.sqrt((x - x_true) @ (x - x_true)))
            elif name == "alpha":
                hist[name][k] = float(a)
            elif name == "beta":
                hist[name][k] = float(beta) if k else 0.0
            elif name == "nu":
                hist[name][k] = float(nu)
            elif name == "save_x":
                hist[name][k] = np.asarray(x, dtype=np.float64)
            elif name == "save_r":
                hist[name][k] = np.asarray(r, dtype=np.float64)

    beta = 0.0
    record(0)
    last = 0
    for k in range(1, max_iter):
        x = x + a * p
        r = r - a * s
        if k < kmax:
            # enforce M^{-1}-orthogonality against all previous residuals
            r = r - R[:k].T @ (Rt[:k] @ r)
        rt = prec(r)
        nu1 = nu
        nu = r @ rt
        if k < kmax:
            R[k] = r / np.sqrt(nu)
            Rt[k] = rt / np.sqrt(nu)
        beta = nu / nu1
        p = rt + beta * p
        s = A @ p
        mu = p @ s
        a = nu / mu
        record(k)
        last = k
        if np.sqrt(nu) < tol:
            break

    out = {"name": _name, "max_iter": max_iter, "x": x.astype(np.float64),
           "iterations": last}
    for name in want:
        out[name] = hist[name][: last + 1]
    return out
