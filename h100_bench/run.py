"""Run one cell of the benchmark on the CUDA card.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line (the last of standard
output): ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``, each number
compared beside its limit (also the last lines of standard error).  Exits
non-zero, printing no result, without enough CUDA cards, when the program
is absent, or when JAX or the JAX package was loaded.
"""

import time

_T0 = time.perf_counter()  # set-up starts with the process

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
# this file's own directory first on the path would let the benchmark's
# module names shadow the standard library's
sys.path[:] = [str(_ROOT)] + [p for p in sys.path
                              if Path(p or ".").resolve() != _ROOT / "h100_bench"]

if __name__ == "__main__":
    from h100_bench.harness import main

    sys.exit(main(sys.argv[1:], _ROOT, _T0))
