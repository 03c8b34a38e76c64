"""``capture_hit_share.iter`` and ``capture_hit_share.solve``: the share of
calls, in %, whose loop replayed graphs that an earlier call captured on
the same operator instead of capturing its own (the program's
``capture_hits / solves``; 0 where the program counts solves but no hit)."""

from h100_bench.metrics._program_counters import per_solve


def read(obs):
    return per_solve("capture_hits", 100.0)
