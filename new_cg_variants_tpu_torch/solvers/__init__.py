"""Solver families, loops and entry points."""
