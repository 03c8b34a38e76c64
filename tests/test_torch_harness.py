"""Port parity: the experiment harnesses (``harness/``).

* ``test_matrix`` / ``parse_convergence_data`` of both packages on one
  ``.mtx`` file written with ``write_mtx`` (no fixture): the iterations to
  1e-5 within 1 and the log10 of the best error within 0.05 for every
  variant, the oracle's columns equal, on runs stopped before the rounding
  floor.  At the floor the best error is the least of rounding noise, and
  two summation orders draw it differently: there every name of
  ``DEFAULT_VARIANTS`` is held to ``chip_smoke.py``'s floor limits
  (``row_compare``; the readings behind them: ``tests/torch_floor_gaps.py``);
* the trial files cross-read: the JAX package's ``parse_convergence_data``
  reads the port's files and the port's reads the JAX package's, giving the
  same rows; the port's files hold numpy arrays and Python scalars only;
* the table's bolding rule, ``resume``, ``gen_convergence_table``'s order,
  ``run_convergence_suite`` through ``matrix_dir`` and ``$CG_TPU_MATRIX_DIR``;
* ``ScalingResult``'s JSON keys and file name against the JAX package's,
  ``scaling_run`` / ``time_variant`` on one device (a mesh size above 1
  raises), and the figures where matplotlib is installed.
"""

import json

import numpy as np
import pytest
import torch

from new_cg_variants_tpu.harness import convergence as jhc
from new_cg_variants_tpu.harness import scaling as jhs
from new_cg_variants_tpu.matio.matrix_market import read_mtx as jax_read_mtx
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.harness import convergence as hc
from new_cg_variants_tpu_torch.harness import scaling as hs

from conftest import make_spd

VARIANTS = ("hs_pcg", "gv_pcg", "pipe_pr_pcg")
TABLE = VARIANTS + ("exact_pcg",)
#: (preconditioner, iterations): 1e-5 reached (at ~26 / ~15), the rounding
#: floor not yet (from ~70 / ~35)
CONFIGS = ((None, 40), ("jacobi", 22))
ITER_SLACK = 1
LOG10_TOL = 0.05


def spd_matrix(n=200):
    a = make_spd(n, cond=1e3, seed=1)
    return a + np.diag(np.linspace(0.0, 1.0, n))  # a diagonal for Jacobi


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtx")
    port.write_mtx(str(d / "spd200.mtx"), spd_matrix(), symmetric=True)
    return d


@pytest.fixture(scope="module")
def both_runs(written, tmp_path_factory):
    """Both packages' trial files for CONFIGS, and their rows."""
    out = {}
    for pkg, harness, reader in (("port", hc, port.read_mtx),
                                 ("jax", jhc, jax_read_mtx)):
        d = tmp_path_factory.mktemp(pkg)
        coo = reader(str(written / "spd200.mtx"))
        rows = {}
        for prec, iters in CONFIGS:
            kw = dict(variants=VARIANTS, data_dir=d, include_exact=True)
            if pkg == "port":
                kw["device"] = "cpu"
            harness.test_matrix(coo, iters, "spd200", prec, **kw)
            rows[prec] = harness.parse_convergence_data(
                "spd200", prec, variants=TABLE, data_dir=d,
                matrix_dir=written)
        out[pkg] = (d, rows)
    return out


def numbers(data_dir, prec):
    return {v: hc.trial_summary(np.load(
        data_dir / f"spd200_{prec}" / f"{v}.npy", allow_pickle=True).item())
        for v in TABLE}


@pytest.mark.parametrize("prec", [c[0] for c in CONFIGS])
def test_rows_match_jax(both_runs, prec):
    got = numbers(both_runs["port"][0], prec)
    want = numbers(both_runs["jax"][0], prec)
    for v in TABLE:
        assert abs(got[v][0] - want[v][0]) <= ITER_SLACK, (v, got, want)
        assert abs(got[v][1] - want[v][1]) <= LOG10_TOL, (v, got, want)
        assert got[v][0] > 0  # 1e-5 reached
    assert got["exact_pcg"] == want["exact_pcg"]
    row = both_runs["port"][1][prec]
    assert row.startswith(r"\texttt{spd200} & " + ("Jac." if prec else "-")
                          + " & 200 & 40000")


#: deep enough for every name to sit at its rounding floor (from ~70 / ~35)
FLOOR_ITERS = 150


@pytest.mark.parametrize("prec", [c[0] for c in CONFIGS])
def test_floors_match_jax(written, tmp_path, prec):
    """Both packages at the rounding floor: iterations within 1, the floors
    within chip_smoke.py's limits, the oracle identical."""
    import chip_smoke

    names = hc.DEFAULT_VARIANTS + ("exact_pcg",)
    for pkg, harness, reader in (("port", hc, port.read_mtx),
                                 ("jax", jhc, jax_read_mtx)):
        kw = dict(device="cpu") if pkg == "port" else {}
        harness.test_matrix(reader(str(written / "spd200.mtx")), FLOOR_ITERS,
                            "spd200", prec, variants=hc.DEFAULT_VARIANTS,
                            data_dir=tmp_path / pkg, include_exact=True, **kw)
    cut = dict(CONFIGS)[prec]
    rec, faults = chip_smoke.row_compare(hc, tmp_path / "port",
                                         tmp_path / "jax", "spd200", prec,
                                         names, cut=cut)
    assert not faults, rec
    assert all(v["cpu"] < chip_smoke.CONV_FLOOR_MAX
               for v in rec["floor"].values())


@pytest.mark.parametrize("prec", [c[0] for c in CONFIGS])
@pytest.mark.parametrize("reader", ["jax reads port", "port reads jax"])
def test_trial_files_cross_read(both_runs, written, reader, prec):
    src = "port" if reader == "jax reads port" else "jax"
    harness = jhc if src == "port" else hc
    d, rows = both_runs[src]
    row = harness.parse_convergence_data("spd200", prec, variants=TABLE,
                                         data_dir=d, n=200, nnz=40000)
    assert row == rows[prec]


def test_trial_files_hold_numpy_only(both_runs):
    d = both_runs["port"][0]
    for f in sorted(d.glob("*/*.npy")):
        trial = np.load(f, allow_pickle=True).item()
        for key, val in trial.items():
            assert isinstance(val, (np.ndarray, str, int, float)), (f, key)
            if isinstance(val, np.ndarray):
                assert val.dtype != object, (f, key)
        assert trial["x"].dtype == np.float64
        assert isinstance(trial["seconds"], float)


def test_constants_match_jax():
    assert hc.MATRIX_CONFIGS == jhc.MATRIX_CONFIGS
    assert hc.DEFAULT_VARIANTS == jhc.DEFAULT_VARIANTS
    assert hc.PAPER_VARIANTS == jhc.PAPER_VARIANTS
    assert hc.PROBES == jhc.PROBES
    assert hc.ERROR_TOL == jhc.ERROR_TOL


def test_table_bolding_rule(tmp_path):
    """A variant >10% slower than the first must get \\tableemph."""
    d = tmp_path / "fake_None"
    d.mkdir()
    e0 = np.concatenate([np.geomspace(1, 1e-9, 50), np.full(50, 1e-9)])
    e1 = np.concatenate([np.geomspace(1, 1e-6, 90), np.full(10, 1e-6)])
    for name, e in (("hs_pcg", e0), ("gv_pcg", e1)):
        np.save(d / f"{name}.npy",
                {"name": name, "max_iter": 100, "error_A_norm": e},
                allow_pickle=True)
    row = hc.parse_convergence_data(
        "fake", None, variants=("hs_pcg", "gv_pcg"), data_dir=tmp_path,
        n=10, nnz=20,
    )
    assert row.count("\\tableemph") == 2  # slower iters AND worse accuracy
    assert row == jhc.parse_convergence_data(
        "fake", None, variants=("hs_pcg", "gv_pcg"), data_dir=tmp_path,
        n=10, nnz=20)


def test_resume_skips_existing(tmp_path, monkeypatch, written):
    coo = port.read_mtx(str(written / "spd200.mtx"))
    hc.test_matrix(coo, 12, "spd200", None, variants=("hs_cg",),
                   data_dir=tmp_path, device="cpu")

    def boom(*a, **k):
        raise AssertionError("run() called despite resume=True")

    monkeypatch.setattr(hc, "run", boom)
    out = hc.test_matrix(coo, 12, "spd200", None, variants=("hs_cg",),
                         data_dir=tmp_path, resume=True, device="cpu")
    assert "hs_cg" in out and out["hs_cg"]["max_iter"] == 12


def test_gen_convergence_table_order(tmp_path):
    for name, prec in (("b", "jacobi"), ("a", "None"), ("c", "None"),
                       ("a", "jacobi")):
        d = tmp_path / f"{name}_{prec}"
        d.mkdir()
        (d / "convergence.txt").write_text(f"{name} {prec}\n")
    out = hc.gen_convergence_table(tmp_path, tmp_path / "figs")
    assert out.read_text() == "a None\nc None\na jacobi\nb jacobi\n"
    jout = jhc.gen_convergence_table(tmp_path, tmp_path / "jfigs")
    assert jout.read_text() == out.read_text()


@pytest.mark.parametrize("via", ["matrix_dir", "env"])
def test_run_convergence_suite_reads_written_matrices(tmp_path, monkeypatch,
                                                      written, via):
    kw = dict(configs=[("spd200", 20, "jacobi"), ("absent", 10, None)],
              variants=("hs_pcg", "pr_pcg"), table_variants=None,
              data_dir=tmp_path / "data", fig_dir=tmp_path / "figs",
              make_plots=False, verbose=False, device="cpu")
    if via == "env":
        monkeypatch.setenv("CG_TPU_MATRIX_DIR", str(written))
    else:
        kw["matrix_dir"] = written
    kw["table_variants"] = kw["variants"]
    done = hc.run_convergence_suite(**kw)
    assert done == [("spd200", 20, "jacobi")]
    table = (tmp_path / "figs" / "convergence_table_data.tex").read_text()
    assert table.startswith(r"\texttt{spd200} & Jac. & 200 & 40000")


def test_load_matrix(written, monkeypatch):
    with pytest.raises(FileNotFoundError):
        hc.load_matrix("absent", written)
    monkeypatch.setenv("CG_TPU_MATRIX_DIR", str(written))
    a = hc.load_matrix("spd200")
    b = hc.load_matrix("spd200", written)
    np.testing.assert_array_equal(a.toarray(), b.toarray())


def test_test_matrix_f32x2_and_float32(tmp_path, written):
    coo = port.read_mtx(str(written / "spd200.mtx"))
    for dtype in ("f32x2", torch.float32):
        out = hc.test_matrix(coo, 30, "spd200", None, variants=("pr_cg",),
                             data_dir=tmp_path / str(dtype), dtype=dtype,
                             device="cpu")
        tr = out["pr_cg"]
        assert tr["x"].dtype == np.float64
        assert hc.trial_summary(tr)[0] > 0


# -- scaling -----------------------------------------------------------------

def test_scaling_result_keys_and_file_match_jax(tmp_path):
    r = hs.ScalingResult("hs_cg", 64, 10, 1, [0.2, 0.1], 1e-9)
    j = jhs.ScalingResult("hs_cg", 64, 10, 1, [0.2, 0.1], 1e-9)
    assert r.to_dict() == j.to_dict()
    path = hs.save_result(r, tmp_path / "port")
    jpath = jhs.save_result(j, tmp_path / "jax")
    assert path.name == jpath.name == "hs_cg_p1_n64.json"
    d = json.loads(path.read_text())
    assert d == json.loads(jpath.read_text())
    assert d["best"] == 0.1 and d["variant"] == "hs_cg"


@pytest.mark.parametrize("problem", ["banded", "spectrum"])
def test_scaling_run_single_device(problem, tmp_path):
    kw = dict(k=4) if problem == "banded" else {}
    res = hs.scaling_run(["hs_cg", "pipe_pr_cg"], problem=problem, n=2048,
                         kappa=100.0, max_iter=60, trials=2, verbose=False,
                         data_dir=tmp_path, device="cpu", **kw)
    assert len(res) == 2
    for r in res:
        assert r.best > 0 and len(r.times) == 2 and r.n_devices == 1
        assert r.n == 2048
        # known-solution forward error after 60 iterations on this
        # well-conditioned problem (scaling_tests.py:81 analog)
        assert r.error < 1e-4
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["env_info.json", "hs_cg_p1_n2048.json",
                     "pipe_pr_cg_p1_n2048.json"]


def test_scaling_multi_device_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        hs.scaling_run(["hs_cg"], n=256, k=2, mesh_sizes=(1, 2),
                       verbose=False, device="cpu")
    op, b, _ = port.banded_model(64, k=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        hs.time_variant("hs_cg", op, b, mesh=object(), device="cpu")


@pytest.mark.parametrize("dtype", [None, torch.float32, "f32x2"])
def test_time_variant_error_matches_a_run(dtype):
    """The timed loop's final iterate is the solver's: its forward error
    equals that of ``run`` over the same iterations."""
    op, b, x_true = port.banded_model(512, k=4, kappa=50.0, device="cpu")
    res = hs.time_variant("pipe_pr_cg", op, b, x_true=x_true, max_iter=30,
                          trials=1, dtype=dtype,
                          device="cpu")
    out = port.run("pipe_pr_cg", op, b, max_iter=31, dtype=dtype,
                   device="cpu")
    x = torch.as_tensor(out["x"]).double().numpy()
    assert res.error == np.linalg.norm(x - x_true)
    assert res.n == 512 and res.max_iter == 30


def test_time_variant_block_banded_in_original_order():
    op, _, _ = port.banded_model(600, k=3, kappa=20.0, fmt="dia",
                                 device="cpu")
    a = op.tocsr()
    p = np.random.default_rng(0).permutation(600)
    a = a[p][:, p].tocsr()
    bb = port.from_coo(port.ops.operators.coo_from_scipy(a),
                       fmt="block_banded", device="cpu")
    x_true = np.ones(600)
    res = hs.time_variant("hs_cg", bb, a @ x_true, x_true=x_true,
                          max_iter=80, trials=1, device="cpu")
    assert res.n == 600 and res.error < 1e-6


# -- figures -----------------------------------------------------------------

def test_plotting(both_runs, tmp_path):
    pytest.importorskip("matplotlib")
    from new_cg_variants_tpu_torch.harness import plotting

    d = both_runs["port"][0]
    p = plotting.plot_matrix_test("spd200", "jacobi", "error_A_norm",
                                  variants=VARIANTS, data_dir=d,
                                  fig_dir=tmp_path)
    assert p.exists() and p.stat().st_size > 0
    p2 = plotting.plot_matrices_test(["spd200", "spd200"], [None, "jacobi"],
                                     variants=VARIANTS, data_dir=d,
                                     fig_dir=tmp_path)
    assert p2.exists() and p2.stat().st_size > 0


def test_scaling_plots(tmp_path):
    pytest.importorskip("matplotlib")
    from new_cg_variants_tpu_torch.harness import scaling_plots

    for t in (0.2, 0.3):
        hs.save_result(hs.ScalingResult("hs_cg", 64, 10, 1, [t], 1e-9),
                       tmp_path)
    (tmp_path / "broken_p2_n64.json").write_text("{")
    assert scaling_plots.load_results(tmp_path) == {"hs_cg": {1: (0.3, 1e-9)}}
    p = scaling_plots.plot_strong_scaling(tmp_path, tmp_path / "figs")
    assert p.exists() and p.stat().st_size > 0
