"""The public variant entry points.

Name-for-name the JAX package's exports: ``hs_cg``, ``cg_cg``, ``gv_cg``,
``pr_cg``, ``m_cg``, ``pipe_p_cg``, ``pipe_pr_cg``, ``pipe_p_m_cg``,
``pipe_pr_m_cg`` and their ``_pcg`` twins (the 18 names of
``VARIANT_NAMES``), each with the reference's signature shape
``variant(A, b, x0, max_iter, probes=..., preconditioner=..., ...)`` plus
``device``.  The JAX package's other two entry points, the
extended-precision oracle ``exact_cg`` / ``exact_pcg``, are not ported yet.
"""

from __future__ import annotations

import sys

from .api import VARIANT_NAMES, run

__all__ = list(VARIANT_NAMES)


def _make_variant(name):
    def variant(
        A,
        b,
        x0=None,
        max_iter=100,
        probes=("updated_residual_2_norm",),
        preconditioner=None,
        x_true=None,
        w_replace=None,
        dtype=None,
        device=None,
    ):
        return run(name, A, b, x0=x0, max_iter=max_iter, probes=probes,
                   preconditioner=preconditioner, x_true=x_true,
                   w_replace=w_replace, dtype=dtype, device=device)

    variant.__name__ = name
    variant.__qualname__ = name
    variant.__doc__ = f"{name} on the PyTorch/CUDA port (see solvers.families)."
    return variant


_mod = sys.modules[__name__]
for _name in VARIANT_NAMES:
    setattr(_mod, _name, _make_variant(_name))
