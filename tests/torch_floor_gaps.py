"""Readings of the rounding floor: the port against the JAX package on the CPU.

    python tests/torch_floor_gaps.py

Runs the convergence harness of both packages in float64 on the CPU, every
name of ``DEFAULT_VARIANTS`` and the oracle, deep enough to reach the
rounding floor, on two kinds of matrix written with ``write_mtx``:

* ``spd200``: the dense SPD matrix of ``tests/test_torch_harness.py`` (n =
  200, condition 1e3) under five seeds, 150 iterations;
* ``hpcg27``: HPCG's 27-point operator on 32^3 (``chip_smoke.py``'s
  convergence matrix (a)) under three seeded permutations, 150 iterations.

Each configuration prints one JSON line with ``row_compare``'s gaps (the
port's row less the JAX package's) before the floor and at it, and the
faults against ``chip_smoke.py``'s limits.  These are the
readings, beside ``chip_study.py floors`` (the card against the CPU), behind
``chip_smoke.py``'s floor limits.  Takes a few minutes; n = 32,768 runs
about 30 s a configuration.
"""

import json
import os
import pathlib
import sys
import tempfile
import time
import warnings

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from conftest import make_spd  # noqa: E402
from new_cg_variants_tpu.harness import convergence as jhc  # noqa: E402
from new_cg_variants_tpu.matio.matrix_market import read_mtx as jax_read  # noqa: E402
import new_cg_variants_tpu_torch as port  # noqa: E402
from new_cg_variants_tpu_torch.harness import convergence as hc  # noqa: E402
from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy  # noqa: E402

ITERS = 150
#: where spd200's rows are cut before the floor: tests/test_torch_harness.py's
#: CONFIGS (1e-5 reached, the floor not yet); hpcg27's at CONV_CMP_ITERS
SPD_CUT = {"jacobi": 22, None: 40}
SPD_SEEDS = (1, 2, 3, 4, 5)
PERM_SEEDS = (cs.PERM_SEED, 1, 2)
NAMES = hc.DEFAULT_VARIANTS + ("exact_pcg",)


def spd_matrix(seed, n=200):
    """``tests/test_torch_harness.py``'s matrix (seed 1 there)."""
    a = make_spd(n, cond=1e3, seed=seed)
    return a + np.diag(np.linspace(0.0, 1.0, n))


def both_rows(path, prec, out):
    """Both packages' trial files of ``path`` under ``out/port`` and
    ``out/jax``; returns the seconds of each."""
    seconds = {}
    for pkg, harness, reader in (("port", hc, port.read_mtx),
                                 ("jax", jhc, jax_read)):
        kw = dict(device="cpu") if pkg == "port" else {}
        t0 = time.perf_counter()
        harness.test_matrix(reader(str(path)), ITERS, "m", prec,
                            variants=hc.DEFAULT_VARIANTS, data_dir=out / pkg,
                            include_exact=True, **kw)
        seconds[pkg] = time.perf_counter() - t0
    return seconds


def main():
    warnings.simplefilter("ignore")
    cases = [("spd200", s, spd_matrix(s)) for s in SPD_SEEDS]
    cases += [("hpcg27 32^3", s, None) for s in PERM_SEEDS]
    for kind, seed, dense in cases:
        with tempfile.TemporaryDirectory() as tmp:
            d = pathlib.Path(tmp)
            a = dense if dense is not None else coo_from_scipy(
                cs.stencil27(cs.CONV_GRID, seed))
            port.write_mtx(str(d / "m.mtx"), a, symmetric=True)
            for prec in ("jacobi", None):
                seconds = both_rows(d / "m.mtx", prec, d)
                cut = SPD_CUT[prec] if dense is not None \
                    else cs.CONV_CMP_ITERS
                rec, faults = cs.row_compare(hc, d / "port", d / "jax", "m",
                                             prec, NAMES, cut=cut)
                print(json.dumps(dict(matrix=kind, seed=seed,
                                      preconditioner=prec, iterations=ITERS,
                                      seconds=seconds, **rec, faults=faults)),
                      flush=True)


if __name__ == "__main__":
    main()
