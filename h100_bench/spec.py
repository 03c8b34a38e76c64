"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them is a file of its own, found by name:

* ``configs/<config>.json`` (the path that ``BENCHMARK.json`` gives): the
  sizes, and ``problem``, the family whose modules build it:
  ``problems/<problem>.py`` (the program's input and operator) and
  ``reference/<problem>.py`` (the plain reference, rebuilt from the same
  formula);
* ``mixes/<traffic>.json``: the mix's parameters, read by :mod:`.traffic`;
  ``entry`` names ``entries/<entry>.py``, the program call it drives;
* ``metrics/<metric>.py``: one reader a metric, ``read(obs)``; a metric
  split by the end-to-end metric it moves (``capture_ms.iter``,
  ``capture_ms.solve``) without a file of its own is read by the file of
  its name up to the first dot (``metrics/capture_ms.py``);
* ``checks/<check>.py``: one comparison a file, ``measure(ctx)``;
* ``limits/<workload>.json``: the cell's checks and their limits.

A later cell, mix, configuration, metric or check is a new file and a new
entry; no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent

__all__ = ["BENCH", "Cell", "load_module"]


def load_module(path):
    """The module in the file ``path``, loaded by its path (names such as
    ``capture_ms.iter`` are no Python identifiers)."""
    path = Path(path)
    name = "h100_bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, mix,
    limits and metrics, read from the files under ``bench``."""

    def __init__(self, root, workload, bench=None):
        root = Path(root)
        bench = root / BENCH.name if bench is None else Path(bench)
        self.root, self.bench = root, bench
        self.benchmark = _json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.benchmark["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(there are: {', '.join(sorted(cells))})")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in self.benchmark["configs"]}
        entry = configs[self.workload["config"]]
        self.config = _json(root / entry["file"])
        self.config.setdefault("name", entry["name"])
        self.mix = _json(bench / "mixes" / f"{self.workload['traffic']}.json")
        self.limits = _json(bench / "limits" / f"{workload}.json")

    def metrics(self, kind):
        """``(name, unit, reader)`` of the cell's ``end_to_end`` or
        ``per_layer`` metrics: those whose ``workloads`` list it, or that
        have no such list."""
        out = []
        for m in self.benchmark[kind]:
            if "workloads" in m and self.name not in m["workloads"]:
                continue
            out.append((m["name"], m["unit"], self.reader(m["name"])))
        return out

    def reader(self, name):
        """The module that reads metric ``name``: ``metrics/<name>.py``, or
        else the file of the name up to its first dot."""
        path = self.bench / "metrics" / f"{name}.py"
        if not path.exists():
            path = path.with_name(name.split(".")[0] + ".py")
        return load_module(path)

    def problem(self):
        return load_module(self.bench / "problems"
                           / f"{self.config['problem']}.py")

    def reference(self):
        return load_module(self.bench / "reference"
                           / f"{self.config['problem']}.py")

    def entry(self):
        return load_module(self.bench / "entries" / f"{self.mix['entry']}.py")

    def checks(self):
        """``(name, limit, module)`` of each comparison the cell makes."""
        return [(name, lim, load_module(self.bench / "checks" / f"{name}.py"))
                for name, lim in self.limits["checks"].items()]

