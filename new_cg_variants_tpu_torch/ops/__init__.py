"""Operators and their kernels."""
