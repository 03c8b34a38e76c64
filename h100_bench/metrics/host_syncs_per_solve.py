"""``host_syncs_per_solve``: reads a solve that made the host wait for the
card (the program's ``host_syncs / solves``: the tolerance, each chunk's
norms, the result's norm)."""

from h100_bench.metrics._program_counters import per_solve


def read(obs):
    return per_solve("host_syncs")
