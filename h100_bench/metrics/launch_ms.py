"""``launch_ms.iter`` and ``launch_ms.solve``: host milliseconds a call
spent inside graph launches (the program's ``replay_s / solves``, times
1e3)."""

from h100_bench.metrics._program_counters import per_solve


def read(obs):
    return per_solve("replay_s", 1e3)
