"""``captures_per_call.iter`` and ``captures_per_call.solve``: CUDA graphs
captured a call (the program's ``captures / solves``; one a chunk length a
loop)."""

from h100_bench.metrics._program_counters import per_solve


def read(obs):
    return per_solve("captures")
