"""The program's own counters per solve, for the readers beside this file
(``host_syncs_per_solve``, ``overshoot_steps_per_solve``,
``captures_per_call``, ``capture_pool_mb``, ``launch_ms``).

The counters (``new_cg_variants_tpu_torch/utils/profiling.py:counters``)
are the process's: every solve of the run, the warm-up call included, and
only the program's.  ``None`` where the program keeps no counters (a tree
older than them) or counted no solve."""

import importlib

PROGRAM = "new_cg_variants_tpu_torch.utils.profiling"


def per_solve(name, scale=1.0):
    """``scale`` times the counter ``name`` over the counter ``solves``."""
    try:
        module = importlib.import_module(PROGRAM)
    except ImportError:
        return None
    counters = getattr(module, "counters", None)
    if counters is None:
        return None
    snapshot = counters()
    solves = snapshot.get("solves", 0)
    if not solves:
        return None
    return scale * snapshot.get(name, 0) / solves
