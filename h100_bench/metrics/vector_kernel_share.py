"""``vector_kernel_share.iter``: the share, in %, of the pipe vector phases
that the program built on its one-pass kernel (``csrc/pipe_vector.cu``)
rather than on the generic body of torch updates and dots (the program's
``vector_phases.kernel`` over ``vector_phases.kernel +
vector_phases.generic``).  The program counts a phase when the step's
Python runs: eager steps and captures, not replays.  ``None`` where it
counts neither or both read 0: a tree without the counters, or a cell whose
whole-step kernels build no vector phase."""

from h100_bench.metrics._counted import value


def read(obs):
    kernel = value("vector_phases.kernel") or 0.0
    built = kernel + (value("vector_phases.generic") or 0.0)
    return 100.0 * kernel / built if built else None
