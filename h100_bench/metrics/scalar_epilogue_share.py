"""``scalar_epilogue_share.iter`` / ``.solve``: the share, in %, of the pipe
steps whose scalar epilogue (beta from the predicted nu, the dots' sum,
alpha) the program formed inside the half-band kernel's launch
(``csrc/sym_family.cu``, the block that finishes last) rather than with
torch kernels (the program's ``scalar_epilogues.kernel`` over
``scalar_epilogues.kernel + scalar_epilogues.torch``).  The program counts
a step when its Python runs: eager steps and captures, not replays.
``None`` where it counts neither or both read 0: a tree without the
counters, or a cell that runs no pipe step."""

from h100_bench.metrics._counted import value


def read(obs):
    kernel = value("scalar_epilogues.kernel") or 0.0
    built = kernel + (value("scalar_epilogues.torch") or 0.0)
    return 100.0 * kernel / built if built else None
