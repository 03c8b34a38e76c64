"""PyTorch/CUDA port of new_cg_variants_tpu for NVIDIA Hopper (H100).

The JAX package ``new_cg_variants_tpu`` is the reference and stays as it is;
this package imports nothing of it.  Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas for the TPU becomes a hand-written
CUDA kernel under ``csrc/``, built with ``nvcc`` at first use.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``, which runs
the kernels' plain PyTorch versions.

Ported so far: every CG variant of ``VARIANT_NAMES`` (hs, cg, gv, pr, m and
the four pipe families, each with its preconditioned twin) on symmetric
half-band, full-DIA, dense, padded-ELL, constant-band stencil and
block-banded operators, with compensated dots (``compensated=True``) and in
the double-word mode (``dtype="f32x2"``).  General sparse input (a scipy
sparse matrix, a :class:`CooMatrix` or a ``.mtx`` file) takes the JAX
package's auto format policy (:func:`from_coo`).  The convergence-measurement
layer: the extended-precision oracle ``exact_cg`` / ``exact_pcg`` (on the
host), the post-hoc probes (:mod:`.probes.posthoc`), the ``figure_gen`` and
single-device scaling harnesses (:mod:`.harness`), the profiling utilities
(:mod:`.utils`) and the command line (``python -m new_cg_variants_tpu_torch
solve | convergence | scaling``).
"""

from .matio.matrix_market import CooMatrix, load_matrix, read_mtx, write_mtx
from .matio.problems import banded_model, model_spectrum
from .ops.compensated import comp_dot
from .ops.doublefloat import (
    DF,
    DFJacobi,
    DFOperator,
    DoubleFloatContext,
    df_operator,
    df_split,
    df_split3,
)
from .ops.operators import (
    DenseOperator,
    DiaOperator,
    EllOperator,
    as_operator,
    from_coo,
)
from .ops.stencil import BandedStencilOperator
from .ops.sym_dia import SymDiaOperator
from .solvers.api import VARIANT_NAMES, SolveResult, run, solve
from .solvers.precond import JacobiPreconditioner, make_preconditioner
from .solvers.variants import *  # noqa: F401,F403 — the public variants
from .solvers.variants import __all__ as _variant_all

__version__ = "0.1.0"

__all__ = [
    "banded_model",
    "model_spectrum",
    "SymDiaOperator",
    "DiaOperator",
    "DenseOperator",
    "EllOperator",
    "BandedStencilOperator",
    "as_operator",
    "from_coo",
    "CooMatrix",
    "read_mtx",
    "write_mtx",
    "load_matrix",
    "run",
    "solve",
    "SolveResult",
    "VARIANT_NAMES",
    "JacobiPreconditioner",
    "make_preconditioner",
    "DF",
    "df_split",
    "df_split3",
    "df_operator",
    "DFOperator",
    "DFJacobi",
    "DoubleFloatContext",
    "comp_dot",
    "__version__",
] + list(_variant_all)
