"""What the benchmark may import and read."""

import ast
import sys
import types
from pathlib import Path

import pytest

from h100_bench import harness

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "new_cg_variants_tpu"}
PROGRAM = "new_cg_variants_tpu_torch"
#: the JAX package's benchmark artefacts, which nothing here reads
UNREAD = ("benchmarks/", "bench.py", "BENCH_", "BASELINE.json",
          "PERF_TPU.md")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in
                 p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_and_no_reads_of_tpu_artefacts(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if path.parent.name != "tests":
        text = path.read_text()
        assert not [u for u in UNREAD if u in text]


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] != PROGRAM
        assert not name.startswith(("h100_bench.problems",
                                    "h100_bench.entries"))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "new_cg_variants_tpu_torch_x",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "new_cg_variants_tpu.ops",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "new_cg_variants_tpu.ops"]


def test_a_run_with_jax_loaded_prints_no_result(tiny, monkeypatch):
    from conftest import run_cell

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run_cell(tiny, "petsc_banded_k32.rtol1e-5")
    assert rc != 0 and line is None
    assert "jax" in err[-1]
