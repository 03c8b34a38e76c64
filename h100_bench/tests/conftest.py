"""Shared pieces of the benchmark's own tests (``python -m pytest
h100_bench/tests -q`` from the repository root).

The marker ``card`` is for tests that need a CUDA card; each decides inside
the test whether there is one and skips without.  ``tiny`` is a copy of the
benchmark in a temporary directory with every configuration and mix shrunk
to a size the CPU runs in seconds, the limits left as they are.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: what each configuration and mix becomes in ``tiny``
SHRINK = {
    "configs/petsc_banded_k32.json": {"n": 2048},
    "configs/hpcg_27pt_104_perm.json": {"grid": 12},
    "mixes/fixed4000.json": {"rhs_pool": 3, "sample": 2, "trace_calls": 2},
    "mixes/fixed50.json": {"rhs_pool": 3, "sample": 2, "trace_calls": 2},
    "mixes/rtol1e-5.json": {"rhs_pool": 3, "sample": 2, "trace_calls": 2},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


def make_tiny(dst):
    dst = Path(dst)
    shutil.copytree(ROOT / "h100_bench", dst / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for rel, change in SHRINK.items():
        path = dst / "h100_bench" / rel
        data = json.loads(path.read_text())
        data.update(change)
        path.write_text(json.dumps(data))
    return dst


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path / "tiny")


def run_cell(root, workload, seed=2**31 + 7, seconds=0.5, trace=0):
    """The harness on the CPU (its look for a card skipped): ``(exit
    code, the last line as a dict or None, standard error lines)``."""
    import io

    from h100_bench.harness import run

    out, err = io.StringIO(), io.StringIO()
    rc = run(root, workload, seed, seconds, trace, device="cpu", out=out,
             err=err)
    lines = out.getvalue().strip().splitlines()
    return (rc, json.loads(lines[-1]) if lines else None,
            err.getvalue().strip().splitlines())
