"""The program's counters that older trees of the program lack, for the
readers beside this file (``format_s``, ``rcm_s``, ``ell_pack_s``,
``basis_moves_per_solve``).

Unlike :mod:`._program_counters`, a counter the program has not counted
reads ``None``, never 0: a tree without the counter prints no metric."""

import importlib

from h100_bench.metrics._program_counters import PROGRAM


def _snapshot():
    try:
        module = importlib.import_module(PROGRAM)
    except ImportError:
        return {}
    counters = getattr(module, "counters", None)
    return {} if counters is None else counters()


def value(name):
    """The counter ``name`` over the process (its host seconds, for a
    span's ``<name>_s``)."""
    snapshot = _snapshot()
    return float(snapshot[name]) if name in snapshot else None


def per_solve(name):
    """The counter ``name`` over the counter ``solves``."""
    snapshot = _snapshot()
    if name not in snapshot or not snapshot.get("solves"):
        return None
    return snapshot[name] / snapshot["solves"]
