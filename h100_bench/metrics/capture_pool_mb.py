"""``capture_pool_mb.iter`` and ``capture_pool_mb.solve``: MB a call by
which the card's reserved memory grew over the call's captures (the
program's ``pool_bytes / solves / 1e6``)."""

from h100_bench.metrics._program_counters import per_solve


def read(obs):
    return per_solve("pool_bytes", 1e-6)
