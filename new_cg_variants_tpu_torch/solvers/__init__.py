"""Solver families, loops and entry points."""

from .api import SolveResult, VARIANT_NAMES, run, solve
from .context import Context
from .families import FAMILIES, family_of
from .oracle import exact_cg, exact_pcg
from .precond import FunctionPreconditioner, JacobiPreconditioner, make_preconditioner
from .variants import *  # noqa: F401,F403
