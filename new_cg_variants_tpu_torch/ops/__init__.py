"""Operators and their kernels."""

from .operators import DenseOperator, DiaOperator, EllOperator, as_operator, from_coo
