"""Rules the PyTorch/CUDA port keeps.

* It imports neither JAX nor anything of the JAX package (whose name is a
  prefix of the port's own: ``new_cg_variants_tpu`` vs
  ``new_cg_variants_tpu_torch``).
* It never drops to the CPU on its own: ``device=None`` means the CUDA card,
  and without one the entry points raise (the harnesses and the command
  line too; the oracle and the post-hoc probes run on the host by design).
* Its kernels build for Hopper (``sm_90a``) into a directory git ignores.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops import _kernels

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "new_cg_variants_tpu_torch"
FORBIDDEN = re.compile(r"^(jax|jaxlib|new_cg_variants_tpu)$")


def forbidden_imports(source: str) -> list[str]:
    """Absolute imports of JAX or of the JAX package in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        else:
            continue
        found += [n for n in names if FORBIDDEN.match(n.split(".")[0])]
    return found


def test_forbidden_import_check_minds_the_prefix():
    assert forbidden_imports("import new_cg_variants_tpu.ops") == [
        "new_cg_variants_tpu.ops"]
    assert forbidden_imports("from new_cg_variants_tpu import run")
    assert forbidden_imports("import jax.numpy as jnp")
    assert forbidden_imports("importlib.import_module('jax')")
    assert not forbidden_imports("import new_cg_variants_tpu_torch.ops")
    assert not forbidden_imports("from new_cg_variants_tpu_torch import run")
    assert not forbidden_imports("from . import jax_free")


@pytest.mark.parametrize(
    "path",
    sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "chip_study.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_sources_import_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import new_cg_variants_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'new_cg_variants_tpu'))\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_distributed_layer_and_native_reader_loads_no_jax():
    code = (
        "import sys\n"
        "import new_cg_variants_tpu_torch.parallel, "
        "new_cg_variants_tpu_torch.matio._native\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'new_cg_variants_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_source_is_the_ports_own():
    """The native reader builds from the port's C++ source (``native/`` of
    the JAX package stays as it is), with a plain C interface of the three
    entry points its binding declares, standard headers only, and a build
    that does not tune for the host (``-march``)."""
    from new_cg_variants_tpu_torch.matio import _native

    assert _native.SOURCE == PORT_DIR / "native" / "matio.cpp"
    text = _native.SOURCE.read_text()
    assert text != (ROOT / "native" / "matio.cpp").read_text()
    assert re.findall(r"#include\s*<([^>]+)>", text) == [
        "cstdint", "cstdio", "cstdlib"]
    block = text.split('extern "C" {')[1]
    assert sorted(re.findall(r"^\w+ (ncgvt_\w+)\(", block, re.M)) == [
        "ncgvt_free", "ncgvt_pack_ell", "ncgvt_read_coordinate"]
    binding = (PORT_DIR / "matio" / "_native.py").read_text()
    for name in ("ncgvt_free", "ncgvt_pack_ell", "ncgvt_read_coordinate"):
        assert f"lib.{name}.argtypes" in binding
    cmd = _native.compile_command("g++", "matio.cpp", "libmatio.so")
    assert not any("march" in flag for flag in cmd)
    assert _native.BUILD_ROOT == _kernels.BUILD_ROOT


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small_problem():
    return port.banded_model(256, k=4, kappa=100.0, device="cpu")


@pytest.mark.parametrize(
    "entry",
    ["solve", "run", "variant", "solve-jacobi", "run-jacobi",
     "run-callable"] + list(port.VARIANT_NAMES))
def test_default_device_without_cuda_raises(no_cuda, small_problem, entry):
    op, b, _ = small_problem
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "solve":
            port.solve(op, b, max_iter=3)
        elif entry == "run":
            port.run("pipe_pr_cg", op, b, max_iter=3)
        elif entry == "variant":
            port.pipe_pr_cg(op, b, max_iter=3)
        elif entry == "solve-jacobi":
            port.solve(op, b, variant="pipe_pr_pcg", preconditioner="jacobi",
                       max_iter=3)
        elif entry == "run-jacobi":
            port.run("pr_pcg", op, b, preconditioner="jacobi", max_iter=3)
        elif entry == "run-callable":
            port.run("hs_pcg", op, b, preconditioner=lambda v: v, max_iter=3)
        else:
            pre = "jacobi" if entry.endswith("pcg") else None
            getattr(port, entry)(op, b, max_iter=3, preconditioner=pre)


@pytest.mark.parametrize("kind", ["dia", "dense", "array", "spectrum"])
@pytest.mark.parametrize("entry", ["solve", "run", "pipe_pr_cg", "pipe_pr_pcg",
                                   "hs_pcg"])
def test_default_device_without_cuda_raises_on_each_operator_kind(
        no_cuda, kind, entry):
    if kind == "dia":
        op, b, _ = port.banded_model(256, k=4, kappa=100.0, fmt="dia",
                                     device="cpu")
    elif kind == "spectrum":
        op, b, _ = port.model_spectrum(256, kappa=100.0, device="cpu")
    else:
        a = np.diag(np.arange(1.0, 9.0))
        op = a if kind == "array" else port.as_operator(a, device="cpu")
        b = np.ones(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "solve":
            port.solve(op, b, max_iter=3)
        elif entry == "run":
            port.run("pr_cg", op, b, max_iter=3)
        else:
            pre = "jacobi" if entry.endswith("pcg") else None
            getattr(port, entry)(op, b, max_iter=3, preconditioner=pre)


def test_problem_and_convert_default_to_cuda(no_cuda):
    from new_cg_variants_tpu_torch.convert import (
        operator_from_numpy,
        preconditioner_from_numpy,
        state_from_numpy,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        port.banded_model(64, k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.banded_model(64, k=2, fmt="dia")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.model_spectrum(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.as_operator(np.eye(4))
    for kind, offsets in (("dia", (-1, 0)), ("dense", None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            operator_from_numpy(offsets, np.ones((2, 2)), kind=kind)
    with pytest.raises(RuntimeError, match="CUDA"):
        operator_from_numpy((0, 1), np.ones((2, 8)))
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy({"x": np.ones(8)})
    with pytest.raises(RuntimeError, match="CUDA"):
        preconditioner_from_numpy(np.ones(8))


def test_explicit_cpu_runs_plain_versions(small_problem):
    op, b, x_true = small_problem
    res = port.solve(op, b, rtol=1e-10, device="cpu")
    assert res.converged and res.x.device.type == "cpu"
    np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-8)


def test_kernel_or_generic_choice_reads_the_configuration_only():
    """No step asks whether a card is there, and no launch sits in a ``try``:
    the context picks the fused phase or the generic body from the
    preconditioner and the norm alone, and a CUDA tensor reaches the kernel
    or raises."""
    for rel in ("solvers/context.py", "solvers/families.py",
                "solvers/engine.py", "ops/sym_fused.py", "ops/sym_dia.py",
                "ops/operators.py", "ops/spmv_dia.py", "ops/fused_step.py",
                "ops/fused_family.py", "ops/compensated.py",
                "ops/doublefloat.py", "ops/df_spmv.py", "solvers/api.py",
                "ops/ell_spmv.py", "ops/stencil.py", "ops/block_banded.py",
                "parallel/contexts.py"):
        tree = ast.parse((PORT_DIR / rel).read_text())
        for node in ast.walk(tree):
            assert not isinstance(node, ast.Try), rel
            if isinstance(node, ast.Attribute):
                assert node.attr != "is_available", rel
            assert not (isinstance(node, ast.Name) and node.id == "os"), rel


@pytest.mark.parametrize("entry", [
    "from_coo", "as_operator-scipy", "solve-scipy", "run-coo",
    "block_banded_from_coo", "banded_model-stencil", "convert-ell",
    "convert-stencil", "convert-block_banded", "df_operator-coo"])
def test_sparse_entry_points_default_to_cuda(no_cuda, entry):
    import scipy.sparse as sp

    from new_cg_variants_tpu_torch.convert import operator_from_numpy
    from new_cg_variants_tpu_torch.ops.block_banded import (
        block_banded_from_coo,
    )

    a = (sp.random(600, 600, density=0.01, random_state=0)
         + 10 * sp.eye(600)).tocsr()
    coo = port.ops.operators.coo_from_scipy(a + a.T)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "from_coo":
            port.from_coo(coo)
        elif entry == "as_operator-scipy":
            port.as_operator(a)
        elif entry == "solve-scipy":
            port.solve(a, np.ones(600), max_iter=2)
        elif entry == "run-coo":
            port.run("pr_pcg", coo, np.ones(600), preconditioner="jacobi",
                     max_iter=2)
        elif entry == "block_banded_from_coo":
            block_banded_from_coo(coo)
        elif entry == "banded_model-stencil":
            port.banded_model(64, k=2, fmt="stencil")
        elif entry == "convert-ell":
            operator_from_numpy(kind="ell", val=np.ones((4, 1)),
                                idx=np.arange(4)[:, None], nnz=4)
        elif entry == "convert-stencil":
            operator_from_numpy(kind="stencil", diag=np.ones(4),
                                off_value=0.5, k=2)
        elif entry == "convert-block_banded":
            operator_from_numpy(kind="block_banded",
                                a_blk=np.ones((1, 128, 384)), n_orig=100,
                                nnz=10)
        else:
            port.df_operator(coo)


def test_ell_kernel_source_calls_no_library():
    """Row 12 is written by hand: no cuSPARSE, cuBLAS, Thrust or CUB, and no
    header beyond the CUDA runtime's and its bf16 type's (through the
    storage types' header of csrc/)."""
    text = (PORT_DIR / "csrc" / "ell_spmv.cu").read_text()
    includes = re.findall(r"#include\s*[<\"]([^>\"]+)", text)
    assert includes == ["storage.cuh"]
    storage = (PORT_DIR / "csrc" / "storage.cuh").read_text()
    assert re.findall(r"#include\s*[<\"]([^>\"]+)", storage) == [
        "cuda_bf16.h", "cuda_runtime.h"]
    for name in ("cusparse", "cublas", "thrust", "cub::", "cutlass"):
        assert name not in (text + storage).lower()
    assert "__global__" in text and "ell_spmv_kernel" in text


def test_nvcc_command_targets_hopper():
    cmd = _kernels.nvcc_command("nvcc", "csrc/sym_dia.cu", "libsym_dia.so")
    assert "compute_90a,code=sm_90a" in " ".join(cmd)
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[-1] == "csrc/sym_dia.cu"


def test_every_kernel_source_is_built_and_notes_what_it_replaces():
    built = set(_kernels.SOURCES)
    assert built == {p.name for p in (PORT_DIR / "csrc").glob("*.cu")}
    assert built == set(_kernels._SIGNATURES)
    assert {"dia_spmv.cu", "pipe_vector.cu", "dia_family.cu", "df_spmv.cu",
            "df_pipe.cu", "ell_spmv.cu"} <= built
    for name in built:
        text = (PORT_DIR / "csrc" / name).read_text()
        assert "Replaces the TPU kernel" in text
        assert "What bounds it on an H100" in text
        assert 'extern "C"' in text


def test_double_word_sources_round_every_step_once():
    """The double-word kernels rest on error-free transforms, which a fused
    multiply-add breaks: no build flag may allow fast math or flush
    subnormals, and the double-word arithmetic of ``csrc/df_common.cuh`` is
    written in intrinsics that are never contracted (the study of
    ``chip_study.py`` that puts plain operators back must fail the checks)."""
    cmd = " ".join(_kernels.nvcc_command("nvcc", "csrc/df_spmv.cu", "x.so"))
    for flag in ("fast_math", "ftz=true", "fmad=true", "prec-div=false"):
        assert flag not in cmd
    common = (PORT_DIR / "csrc" / "df_common.cuh").read_text()
    for intrinsic in ("__fadd_rn", "__fsub_rn", "__fmul_rn"):
        assert common.count(intrinsic) == 1
    for name in ("df_spmv.cu", "df_pipe.cu"):
        text = (PORT_DIR / "csrc" / name).read_text()
        assert '#include "df_common.cuh"' in text
        assert "fma" not in text.replace("fmad", "")


def test_every_study_edit_applies_to_the_kernel_sources():
    """``chip_study.py`` builds edited copies of the sources; each edit's
    text stands exactly once in the source it names, so a study fails here
    and not on the card when a kernel is rewritten."""
    import chip_study

    edits = (list(chip_study.MUTANTS.values())
             + list(chip_study.SYM_MUTANTS.values())
             + list(chip_study.DF_MUTANTS.values())
             + list(chip_study.ELL_MUTANTS.values())
             + list(chip_study.BF16_MUTANTS.values())
             + list(chip_study.LAUNCH_BOUNDS)
             + [e for opt in (chip_study.SYM_OPTIONS,
                              chip_study.ELL_OPTIONS,
                              chip_study.DENSE_OPTIONS,
                              chip_study.PIPE_OPTIONS)
                for edits in opt.values() for e in edits])
    assert len(edits) >= 30
    for source, text, replacement in edits:
        body = (PORT_DIR / "csrc" / source).read_text()
        if text is None:  # a whole file: it declares the same entry points
            assert c_entry_points(replacement) == c_entry_points(body)
            continue
        assert body.count(text) == 1, (source, text)
        assert replacement != text


def c_entry_points(source: str) -> dict[str, int]:
    """Name -> argument count of each function defined after an
    ``extern "C" {`` in ``source``."""
    found = {}
    for block in source.split('extern "C" {')[1:]:
        for name, args in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", block,
                                     re.M):
            found[name] = len(args.split(","))
    return found


@pytest.mark.parametrize("source", _kernels.SOURCES)
def test_signatures_match_the_c_entry_points(source):
    """``_SIGNATURES`` declares every ``extern "C"`` entry point of a source
    with as many arguments as the C function takes (ctypes would pass a
    missing pointer as garbage, not fail)."""
    body = (PORT_DIR / "csrc" / source).read_text()
    declared = {name: len(types)
                for name, types in _kernels._SIGNATURES[source].items()}
    assert c_entry_points(body) == declared


def test_gitignore_lists_the_build_directory():
    lines = (ROOT / ".gitignore").read_text().split()
    rel = _kernels.BUILD_ROOT.relative_to(ROOT).as_posix()
    assert rel + "/" in lines or rel in lines
    assert "chiprun_out/" in lines


@pytest.fixture(scope="module")
def written_matrix(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtx")
    a = np.diag(np.arange(1.0, 601.0)) + 0.1 * np.eye(600, k=1) \
        + 0.1 * np.eye(600, k=-1)
    port.write_mtx(str(d / "tri600.mtx"), a, symmetric=True)
    return d


@pytest.mark.parametrize("entry", [
    "test_matrix", "run_convergence_suite", "time_variant", "scaling_run",
    "cli solve", "cli convergence", "cli scaling"])
def test_harness_and_cli_default_to_cuda(no_cuda, monkeypatch, tmp_path,
                                        written_matrix, entry):
    from new_cg_variants_tpu_torch import cli
    from new_cg_variants_tpu_torch.harness import convergence as hc
    from new_cg_variants_tpu_torch.harness import scaling as hs

    coo = port.read_mtx(str(written_matrix / "tri600.mtx"))
    op, b, _ = port.banded_model(256, k=4, kappa=100.0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "test_matrix":
            hc.test_matrix(coo, 5, "tri600", None, variants=("hs_cg",),
                           data_dir=tmp_path)
        elif entry == "run_convergence_suite":
            hc.run_convergence_suite(
                configs=[("tri600", 5, None)], variants=("hs_cg",),
                data_dir=tmp_path, fig_dir=tmp_path, make_plots=False,
                matrix_dir=written_matrix, verbose=False)
        elif entry == "time_variant":
            hs.time_variant("hs_cg", op, b, max_iter=3, trials=1)
        elif entry == "scaling_run":
            hs.scaling_run(["hs_cg"], n=256, k=4, max_iter=3, trials=1,
                           verbose=False)
        elif entry == "cli solve":
            cli.main(["solve", "-n", "256", "-k", "4", "--max-iter", "3"])
        elif entry == "cli convergence":
            monkeypatch.setenv("CG_TPU_MATRIX_DIR", str(written_matrix))
            cli.main(["convergence", "--matrices", "tri600",
                      "--data-dir", str(tmp_path), "--no-plots"])
        else:
            cli.main(["scaling", "-n", "256", "-k", "4", "--max-iter", "3",
                      "--trials", "1"])
    assert not list(tmp_path.glob("*/*.npy"))  # nothing ran


def test_oracle_and_posthoc_run_on_the_host(no_cuda):
    """The oracle and the post-hoc probes take no device: without a card
    they run, on any input the port hands them."""
    from new_cg_variants_tpu_torch.probes import posthoc

    a = np.diag(np.arange(1.0, 33.0))
    out = port.exact_pcg(a, np.ones(32), max_iter=40, probes=("save_r",))
    assert out["iterations"] > 0
    assert posthoc.updated_error_A_norm(a, out).shape == (
        out["iterations"] + 1,)
