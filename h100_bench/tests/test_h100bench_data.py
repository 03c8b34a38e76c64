"""A new configuration, mix, metric and check are taken as data: files
added to a copy of the benchmark and entries in its BENCHMARK.json, no
existing file edited."""

import json

from conftest import run_cell


def test_new_files_are_taken(tiny):
    bench = tiny / "h100_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "hpcg_27pt_8_natural.json").write_text(json.dumps(
        {"problem": "hpcg_27pt", "grid": 8, "perm_seed": None,
         "dtype": "float32"}))
    (bench / "mixes" / "fixed20.json").write_text(json.dumps(
        {"entry": "solve", "variant": "pipe_pr_cg", "norm_type": "none",
         "max_iter": 20, "loop": "closed", "callers": 1, "rhs_pool": 2,
         "sample": 2, "trace_calls": 1}))
    (bench / "metrics" / "calls_in_window.py").write_text(
        "def read(obs):\n    return float(len(obs['calls']))\n")
    (bench / "checks" / "answer_length.py").write_text(
        "def measure(ctx):\n"
        "    n = ctx.config['grid'] ** 3\n"
        "    return {i: abs(len(x) - n) for i, x in ctx.samples.items()}\n")
    (bench / "limits" / "hpcg_27pt_8_natural.fixed20.json").write_text(
        json.dumps({"checks": {"iterations": 0, "answer_length": 0,
                               "residual": 1e-3}}))
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "hpcg_27pt_8_natural", "source": "https://example.org/x",
        "file": "h100_bench/configs/hpcg_27pt_8_natural.json",
        "reduced": ["grid"], "why": "test"})
    spec["workloads"].append({
        "name": "hpcg_27pt_8_natural.fixed20",
        "config": "hpcg_27pt_8_natural", "traffic": "fixed20", "chips": 1,
        "why": "test"})
    spec["end_to_end"][0]["workloads"].append("hpcg_27pt_8_natural.fixed20")
    spec["per_layer"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "harness", "moves": "iter_ms",
        "workloads": ["hpcg_27pt_8_natural.fixed20"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))

    rc, line, _ = run_cell(tiny, "hpcg_27pt_8_natural.fixed20", trace=1)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["calls_in_window"]["value"] == line["attempted"]
    assert line["checks"]["answer_length"] == {"value": 0, "limit": 0}
    rc, line, _ = run_cell(tiny, "hpcg_27pt_8_natural.fixed20")
    assert set(line["metrics"]) == {"iter_ms", "setup_s"}
    # the files that were there are as they were
    assert all(p.read_bytes() == data for p, data in before.items())


def test_a_split_metric_is_read_by_its_stem():
    """``capture_ms.iter`` and ``capture_ms.solve`` move different
    end-to-end metrics; both are read by ``metrics/capture_ms.py``."""
    from conftest import ROOT
    from h100_bench.spec import Cell

    cell = Cell(ROOT, "petsc_banded_k32.fixed4000")
    for name in ("capture_ms.iter", "capture_ms.solve",
                 "device_idle_share.iter"):
        stem = name.split(".")[0]
        assert cell.reader(name).__file__.endswith(f"metrics/{stem}.py")
    assert cell.reader("iter_ms").__file__.endswith("metrics/iter_ms.py")
