"""Post-hoc probes: expensive oracle measurements from saved histories.

The port of the JAX package's ``probes/posthoc.py``.  The reference computes
two callbacks *inside* the solver loop that need a direct solve or the full
residual history each iteration
(``numerical_experiments/callbacks/updated_error_A_norm.py`` — one
``spsolve`` per iteration — and ``callbacks/lanczos_recurrence.py``).  A
host solve inside the step loop would stall the device each iteration, so
the run records the cheap histories (``save_r``, ``alpha``, ``beta``
probes, which :func:`~..solvers.api.run` returns as numpy arrays) and these
quantities are derived afterwards on the host, in float64:

* :func:`updated_error_A_norm` — ``sqrt(r_k' A^{-1} r_k)`` per iteration,
  with ONE factorization amortized over all iterations instead of the
  reference's per-iteration ``spsolve``.
* :func:`lanczos_recurrence` — Lanczos vectors ``z_k = (-1)^k r_k/|r_k|``,
  the alpha/beta coefficients recovered from the CG scalars
  (``lanczos_alpha[k-1] = 1/a_{k-1} + b_{k-1}/a_{k-2}``), the 3-term
  recurrence error ``||A Z - Z T||`` column-wise, and successive-vector
  orthogonality — matching ``lanczos_recurrence.py:67-77`` including the
  rectangular ``(T, T-1)`` tridiagonal assembly.

Both take the output dict of :func:`~..solvers.api.run` (which must have
been run with the required probes) and write their results into it,
mirroring how the reference callbacks extend ``output``.  ``A`` may be any
operator of the port (``tocsr()`` / ``todense()`` are host float64), a
scipy matrix, an array or a tensor on any device; a history given as a
tensor is read back to the host.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

__all__ = ["updated_error_A_norm", "lanczos_recurrence", "REQUIRED_PROBES"]

REQUIRED_PROBES = {
    "updated_error_A_norm": ("save_r",),
    "lanczos_recurrence": ("save_r", "alpha", "beta"),
}


def _host64(a):
    """A history or matrix as float64 numpy (a tensor from any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def _as_dense64(A):
    if hasattr(A, "todense"):
        return np.asarray(A.todense(), dtype=np.float64)
    if hasattr(A, "toarray"):
        return np.asarray(A.toarray(), dtype=np.float64)
    return _host64(A)


def updated_error_A_norm(A, output):
    """A^{-1}-norm of the *updated* residual per iteration.

    cf. ``callbacks/updated_error_A_norm.py:42-48``: this is the error
    norm the algorithm itself "believes", ``sqrt(r' A^{-1} r)``, as
    opposed to the A-norm of the true error.  ONE factorization is
    amortized over all iterations (the reference does a sparse solve per
    iteration): dense Cholesky for small operators, sparse LU above
    ~4k rows where densifying is prohibitive.
    """
    r_hist = _host64(output["save_r"])  # (T, n)
    n = r_hist.shape[1]
    if n >= 4096 and hasattr(A, "tocsr"):
        import scipy.sparse.linalg as spla

        lu = spla.splu(A.tocsr().tocsc())
        err = lu.solve(r_hist.T)  # (n, T)
    else:
        a = _as_dense64(A)
        cho = scipy.linalg.cho_factor(a)
        err = scipy.linalg.cho_solve(cho, r_hist.T)  # (n, T)
    vals = np.sqrt(np.maximum(np.einsum("nt,tn->t", err, r_hist), 0.0))
    output["updated_error_A_norm"] = vals
    return vals


def lanczos_recurrence(A, output):
    """Lanczos quantities recovered from a CG run's saved histories.

    Writes ``lanczos_z`` (n, T), ``lanczos_alpha``/``lanczos_beta`` (T,),
    ``lanczos_3_term_error`` and ``lanczos_orthogonality`` (T-1,) into
    ``output``, with the exact index mapping of
    ``callbacks/lanczos_recurrence.py``: at iteration ``k >= 1``,

    ``alpha_T[k-1] = 1/a_{k-1} + b_{k-1}/a_{k-2}``  (2nd term 0 at k=1)
    ``beta_T[k-1]  = ||r_k|| / (a_{k-1} ||r_{k-1}||)``

    ``A`` is densified on the host (n^2 float64 values), as the JAX
    package does.
    """
    r_hist = _host64(output["save_r"])  # (T, n)
    a_cg = _host64(output["alpha"])  # (T,)
    b_cg = _host64(output["beta"])  # (T,)
    T = r_hist.shape[0]
    a = _as_dense64(A)

    rnorm = np.linalg.norm(r_hist, axis=1)  # (T,)
    signs = (-1.0) ** np.arange(T)
    Z = (signs / rnorm)[None, :] * r_hist.T  # (n, T)

    alpha_T = np.zeros(T)
    beta_T = np.zeros(T)
    for k in range(1, T):
        alpha_T[k - 1] = 1.0 / a_cg[k - 1]
        if k > 1:
            alpha_T[k - 1] += b_cg[k - 1] / a_cg[k - 2]
        beta_T[k - 1] = rnorm[k] / (a_cg[k - 1] * rnorm[k - 1])

    # rectangular (T, T-1) tridiagonal, as the reference assembles it
    Tm = np.zeros((T, T - 1))
    idx = np.arange(T - 1)
    Tm[idx, idx] = alpha_T[: T - 1]
    Tm[idx[:-1], idx[:-1] + 1] = beta_T[: T - 2]
    Tm[idx + 1, idx] = beta_T[: T - 1]

    E = a @ Z[:, :-1] - Z @ Tm
    output["lanczos_z"] = Z
    output["lanczos_alpha"] = alpha_T
    output["lanczos_beta"] = beta_T
    output["lanczos_3_term_error"] = np.linalg.norm(E, axis=0)
    output["lanczos_orthogonality"] = np.abs(
        np.einsum("ji,ji->i", beta_T[: T - 1] * Z[:, :-1], Z[:, 1:])
    )
    return output["lanczos_3_term_error"]
