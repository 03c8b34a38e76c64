"""The shape of a run's last line, on the CPU at a tiny size."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _names(kind, workload):
    return {m["name"] for m in _benchmark()[kind]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      _benchmark()["workloads"]])
def test_last_line(tiny, workload):
    rc, line, err = run_cell(tiny, workload, seconds=0.3)
    assert rc == 0
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == _names("end_to_end", workload)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    checks = line["checks"]
    assert checks and all(set(c) == {"value", "limit"}
                          for c in checks.values())
    # the numbers compared, beside their limits, are stderr's last lines
    assert err[-len(checks):] == [
        f"check {k} = {c['value']!r} (limit {c['limit']!r})"
        for k, c in checks.items()]


def test_traced_line(tiny):
    rc, line, _ = run_cell(tiny, "petsc_banded_k32.rtol1e-5", trace=1)
    assert rc == 0 and line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    # on the CPU no device trace and no capture: only what the host reads
    want = _names("per_layer", "petsc_banded_k32.rtol1e-5")
    assert set(line["metrics"]) <= want and "build_s" in line["metrics"]
    assert list(line)[-1] == "checks"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    p = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "petsc_banded_k32.fixed4000", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_fail(tmp_path):
    """A checkout of BENCHMARK.json and h100_bench only, no program."""
    import shutil

    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path[:0] = [sys.argv[1]];"
            "from h100_bench.harness import run;"
            "sys.exit(run(sys.argv[1], 'petsc_banded_k32.fixed4000', 1, 1,"
            " 0, device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
    assert "new_cg_variants_tpu_torch" in p.stderr
