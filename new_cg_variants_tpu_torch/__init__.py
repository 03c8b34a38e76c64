"""PyTorch/CUDA port of new_cg_variants_tpu for NVIDIA Hopper (H100).

The JAX package ``new_cg_variants_tpu`` is the reference and stays as it is;
this package imports nothing of it.  Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas for the TPU becomes a hand-written
CUDA kernel under ``csrc/``, built with ``nvcc`` at first use.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``, which runs
the kernels' plain PyTorch versions.

This slice: pipe-P/PR CG (unpreconditioned) on symmetric half-band storage.
"""

from .matio.problems import banded_model
from .ops.sym_dia import SymDiaOperator
from .solvers.api import SolveResult, run, solve
from .solvers.variants import pipe_p_cg, pipe_p_m_cg, pipe_pr_cg, pipe_pr_m_cg

__all__ = [
    "banded_model",
    "SymDiaOperator",
    "run",
    "solve",
    "SolveResult",
    "pipe_p_cg",
    "pipe_pr_cg",
    "pipe_p_m_cg",
    "pipe_pr_m_cg",
]
