"""The port exports what the JAX package exports.

Each JAX subpackage's ``__init__`` is read with ``ast`` (nothing of the JAX
package is imported here): every name it imports must be importable from
the port's counterpart, and a star import must come from the port's module
of the same name.  The ``__all__`` of each module of the JAX ``parallel``
package must be the port module's, but for the one name listed with the
reason it has no counterpart.  Then the keyword arguments the JAX entry
points take and the port accepts as well (``use_jit``, ``fmt``,
``native``).
"""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest

import new_cg_variants_tpu_torch as port

ROOT = Path(__file__).resolve().parent.parent
JAX_DIR = ROOT / "new_cg_variants_tpu"
SUBPACKAGES = ("matio", "ops", "solvers", "probes", "parallel", "harness",
               "utils")
#: JAX exports with no counterpart in the port, and why
LATER = {("parallel.launch", "ASYNC_LIBTPU_FLAGS"):
         "a TPU compiler's flags for overlapping collectives (libtpu); the "
         "port overlaps by hand, async_op=True (ROADMAP §3)"}
PARALLEL_MODULES = ("contexts", "dist", "ell_exchange", "launch")


def jax_imports(path):
    """``(names, star modules)`` that an ``__init__`` imports relatively."""
    names, stars = [], []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for alias in node.names:
                if alias.name == "*":
                    stars.append(node.module)
                else:
                    names.append(alias.asname or alias.name)
    return names, stars


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_the_jax_names(sub):
    names, stars = jax_imports(JAX_DIR / sub / "__init__.py")
    mod = importlib.import_module(f"new_cg_variants_tpu_torch.{sub}")
    missing = [n for n in names if not hasattr(mod, n)]
    assert missing == [n for n in names if (sub, n) in LATER]
    for star in stars:
        src = importlib.import_module(f"new_cg_variants_tpu_torch.{sub}."
                                      f"{star}")
        assert src.__all__ and all(hasattr(mod, n) for n in src.__all__)


def jax_all(path):
    """The names of a module's ``__all__`` list, read with ``ast``."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "__all__"):
            return [elt.value for elt in node.value.elts]
    return None


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_export_the_jax_names(module):
    names = jax_all(JAX_DIR / "parallel" / f"{module}.py")
    mod = importlib.import_module(
        f"new_cg_variants_tpu_torch.parallel.{module}")
    later = [n for n in names if (f"parallel.{module}", n) in LATER]
    assert all(hasattr(mod, n) for n in names if n not in later)
    assert sorted(mod.__all__) == sorted(n for n in names if n not in later)
    assert not any(hasattr(mod, n) for n in later)


def test_star_exports_name_every_variant():
    from new_cg_variants_tpu_torch import solvers

    assert list(port.VARIANT_NAMES) + ["exact_cg", "exact_pcg"] == \
        solvers.variants.__all__
    assert all(callable(getattr(solvers, n)) for n in port.VARIANT_NAMES)


def test_top_level_exports_the_jax_names_and_version():
    tree = ast.parse((JAX_DIR / "__init__.py").read_text())
    names, version = [], None
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            names += [a.asname or a.name for a in node.names
                      if a.name != "*" and not a.name.startswith("_")]
        elif (isinstance(node, ast.Assign)
              and node.targets[0].id == "__version__"):
            version = node.value.value
    assert names and all(hasattr(port, n) for n in names)
    assert port.__version__ == version == "0.1.0"
    assert "__version__" in port.__all__


@pytest.mark.parametrize("fn, name, default", [
    (port.run, "use_jit", True),
    (port.solve, "use_jit", True),
    (port.read_mtx, "native", True),
])
def test_jax_keywords_are_accepted(fn, name, default):
    assert inspect.signature(fn).parameters[name].default is default


def test_test_matrix_takes_fmt_and_ignores_it(tmp_path):
    from new_cg_variants_tpu_torch.harness import convergence as hc

    assert inspect.signature(hc.test_matrix).parameters["fmt"].default == \
        "auto"
    a = np.diag(np.arange(1.0, 41.0)) + 0.1 * np.eye(40, k=1) \
        + 0.1 * np.eye(40, k=-1)
    runs = {}
    for fmt in ("dia", "auto"):
        d = tmp_path / fmt
        hc.test_matrix(a, 8, "tri40", None, variants=("hs_cg",), data_dir=d,
                       fmt=fmt, device="cpu")
        runs[fmt] = np.load(d / "tri40_None" / "hs_cg.npy",
                            allow_pickle=True).item()
    np.testing.assert_array_equal(runs["dia"]["error_A_norm"],
                                  runs["auto"]["error_A_norm"])


@pytest.mark.parametrize("entry", ["run", "solve"])
def test_use_jit_changes_nothing(entry):
    op, b, _ = port.banded_model(256, k=4, kappa=100.0, device="cpu")
    if entry == "run":
        got, want = (port.run("pipe_pr_cg", op, b, max_iter=10, device="cpu",
                              use_jit=jit)["updated_residual_2_norm"]
                     for jit in (False, True))
    else:
        got, want = (port.solve(op, b, rtol=1e-8, device="cpu",
                                use_jit=jit).x.numpy()
                     for jit in (False, True))
    np.testing.assert_array_equal(got, want)
