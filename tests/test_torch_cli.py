"""Port parity: the command line (``python -m new_cg_variants_tpu_torch``).

The JAX package's CLI cases that need no fixture and no mesh, with
``--device cpu``: ``solve`` on the banded model (its ``iterations`` and
``converged`` lines against the JAX CLI's, both in float64), in f32x2 and
with Jacobi on a written ``.mtx`` file; ``scaling`` writing its result
files; ``convergence`` through ``$CG_TPU_MATRIX_DIR`` on a written matrix;
a bad variant.  One device only: ``--devices 2``, ``--partition`` and a mesh
size above 1 raise ``NotImplementedError``.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from new_cg_variants_tpu.cli import main as jax_main
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.cli import main

from conftest import make_spd

ROOT = Path(__file__).resolve().parent.parent
BANDED = ["--problem", "banded", "-n", "2048", "-k", "4", "--kappa", "100"]


def fields(out):
    return dict(kv.split("=", 1) for kv in out.split() if "=" in kv)


@pytest.mark.parametrize("variant", ["pipe_pr_cg", "hs_cg", "gv_cg",
                                     "pipe_pr_pcg"])
def test_solve_banded_matches_jax(capsys, variant):
    argv = ["solve", *BANDED, "--ksp-type", variant, "--rtol", "1e-7",
            "--max-iter", "1000"]
    if variant.endswith("pcg"):
        argv += ["--pc-type", "jacobi"]
    assert main(argv + ["--device", "cpu"]) == 0
    got = fields(capsys.readouterr().out)
    assert jax_main(argv) == 0
    want = fields(capsys.readouterr().out)
    assert got["converged"] == want["converged"] == "True"
    assert abs(int(got["iterations"]) - int(want["iterations"])) <= 1
    assert got["devices"] == "1" and float(got["forward_error"]) < 1e-4


def test_solve_f32x2(capsys):
    rc = main(["solve", "--problem", "banded", "-n", "1024", "-k", "4",
               "--kappa", "100", "--ksp-type", "pipe_pr_cg",
               "--dtype", "f32x2", "--rtol", "1e-9", "--max-iter", "500",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "converged=True" in out


def test_solve_mtx_file(tmp_path, capsys):
    a = make_spd(300, cond=100.0, seed=2) + np.eye(300)
    path = tmp_path / "spd300.mtx"
    port.write_mtx(str(path), a, symmetric=True)
    rc = main(["solve", "--problem", "mtx", "--matrix", str(path),
               "--ksp-type", "hs_pcg", "--pc-type", "jacobi", "--rtol",
               "1e-8", "--max-iter", "500", "--device", "cpu"])
    got = fields(capsys.readouterr().out)
    assert rc == 0 and got["converged"] == "True" and got["n"] == "300"
    assert float(got["forward_error"]) < 1e-6


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_solve_dtypes_on_cpu(capsys, dtype):
    """On the CPU the plain versions take every dtype (bf16: storage only,
    vectors in float32); on the card bf16 data reaches the kernels'
    TypeError (not ported yet), with no cast."""
    rc = main(["solve", *BANDED, "--ksp-norm-type", "none", "--max-iter",
               "20", "--dtype", dtype, "--device", "cpu"])
    got = fields(capsys.readouterr().out)
    assert rc == 0 and got["iterations"] == "20"
    assert np.isfinite(float(got["forward_error"]))


def test_scaling_writes_results(tmp_path, capsys):
    rc = main(["scaling", "--problem", "spectrum", "-n", "1024",
               "--kappa", "100", "--variants", "hs_cg",
               "--mesh-sizes", "1", "--max-iter", "40", "--trials", "1",
               "--data-dir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    files = list(tmp_path.glob("hs_cg_p1_*.json"))
    assert len(files) == 1
    d = json.loads(files[0].read_text())
    assert d["best"] > 0
    env = json.loads((tmp_path / "env_info.json").read_text())
    assert "longdouble" in env and not any("jax" in k or "tpu" in k.lower()
                                           for k in env)
    call = (tmp_path / "scaling.call").read_text()
    assert call.startswith("python -m new_cg_variants_tpu_torch scaling")
    assert "hs_cg" in capsys.readouterr().out


def test_convergence_subset_through_env(tmp_path, monkeypatch, capsys):
    a = make_spd(200, cond=1e3, seed=1) + np.diag(np.linspace(0, 1, 200))
    mats = tmp_path / "matrices"
    mats.mkdir()
    port.write_mtx(str(mats / "nos4.mtx"), a, symmetric=True)
    monkeypatch.setenv("CG_TPU_MATRIX_DIR", str(mats))
    rc = main(["convergence", "--matrices", "nos4", "--variants",
               "hs_pcg,pipe_pr_pcg", "--data-dir", str(tmp_path / "d"),
               "--fig-dir", str(tmp_path / "f"), "--max-iter-cap", "60",
               "--no-plots", "--exact", "--device", "cpu"])
    assert rc == 0
    assert "completed 2 configs" in capsys.readouterr().out
    table = (tmp_path / "f" / "convergence_table_data.tex").read_text()
    rows = table.splitlines()
    assert len(rows) == 2 and rows[0].startswith(r"\texttt{nos4} & -")
    assert (tmp_path / "d" / "nos4_jacobi" / "exact_pcg.npy").exists()


def test_bad_variant_errors():
    with pytest.raises(KeyError):
        main(["solve", "--problem", "banded", "-n", "256", "-k", "2",
              "--ksp-type", "bogus_cg", "--max-iter", "5", "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["solve", "-n", "256", "-k", "2", "--devices", "2"],
    ["solve", "-n", "256", "-k", "2", "--partition", "row"],
    ["scaling", "-n", "256", "-k", "2", "--mesh-sizes", "1,2"],
], ids=["devices", "partition", "mesh-sizes"])
def test_multi_device_requests_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        main(argv + ["--device", "cpu"])


def test_module_help():
    proc = subprocess.run(
        [sys.executable, "-m", "new_cg_variants_tpu_torch", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"solve.*convergence.*scaling", proc.stdout)


@pytest.mark.parametrize("sub", ["solve", "convergence", "scaling"])
def test_subcommand_help_names_the_device(capsys, sub):
    with pytest.raises(SystemExit) as exc:
        main([sub, "--help"])
    out = capsys.readouterr().out
    assert exc.value.code == 0 and "--device" in out
    assert "--backend" not in out
