"""Vectors a solve moves into or out of its operator's reordered basis (the
program's ``basis_moves / solves``: ``b`` and ``x0`` in, ``x`` out)."""

from h100_bench.metrics._counted import per_solve


def read(obs):
    return per_solve("basis_moves")
