"""``overshoot_steps_per_solve``: steps a solve ran and then took back,
where its tolerance fell inside a replayed chunk (the program's
``steps_taken_back / solves``)."""

from h100_bench.metrics._program_counters import per_solve


def read(obs):
    return per_solve("steps_taken_back")
