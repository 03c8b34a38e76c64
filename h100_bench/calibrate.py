"""The readings that a cell's limits are set from, in one process.

    python3 h100_bench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--control storage|reference] [--out FILE]

Sets the cell up once, then for each seed of ``--seeds`` makes the mix's
``sample`` calls of the program on that seed's right-hand sides, as a run
does, and judges every answer with the cell's checks; for each seed of
``--control-seeds`` it puts the control in the program's place: the plain
reference CG (``reference/linalg.py:cg``) computed in the precision next
below the configuration's (:data:`CONTROL`), on the same right-hand sides,
judged the same way.  The configuration's ``control`` names which:
``storage``, the program itself with its operator stored in that
precision (its own lower-precision path, vectors as before), or
``reference`` (the default).  ``--control`` overrides it, as a second
witness.  One JSON line a seed (``side``: ``program`` or
``control``) on standard output and in ``--out``.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "h100_bench"]

#: the precision a control computes in, for a configuration's dtype
CONTROL = {"float64": "float32", "float32": "bfloat16"}


def program_operator(cell, device):
    problem = cell.problem()
    inp = problem.program_input(cell.config, device)
    return problem.program_operator(cell.config, inp, device)


def control_call(cell, device, op=None, kind=None):
    """``b -> result`` of the control in :data:`CONTROL`'s precision with
    the mix's iteration cap and tolerance: the program's entry on its
    operator stored in that precision (``kind`` ``storage``; ``op`` is the
    program's operator, built here if not given), or the reference CG,
    its result shaped like the program's ``SolveResult`` (``reference``).
    ``kind`` defaults to the configuration's ``control``."""
    import torch

    from h100_bench.reference.linalg import cg

    low = getattr(torch, CONTROL[cell.config["dtype"]])
    mix = cell.mix
    kind = kind or cell.config.get("control", "reference")
    if kind == "storage":
        op = program_operator(cell, device) if op is None else op
        return cell.entry().prepare(op.astype(low), mix, device)
    if kind != "reference":
        raise ValueError(f"unknown control {kind!r}")
    mv = cell.reference().matvec(cell.config, device, low)
    rtol = mix.get("rtol") if mix["norm_type"] != "none" else None

    class Result:
        pass

    def call(b):
        x, k = cg(mv, b.to(low), int(mix["max_iter"]), rtol)
        res = Result()
        res.x, res.iterations = x, k
        res.converged = rtol is None or k < int(mix["max_iter"])
        return res

    return call


def readings(cell, seed, call, device, calls):
    """One seed: ``calls`` calls on its right-hand sides, every answer
    judged; the checks' worst readings and the verdict."""
    import torch

    from h100_bench import traffic
    from h100_bench.harness import judge

    problem, reference = cell.problem(), cell.reference()
    n = problem.size(cell.config)
    pool = traffic.rhs_pool(seed, n, calls, reference.matvec(cell.config,
                                                             device),
                            problem.dtype(cell.config), device)
    recs, answers = [], {}
    t = time.perf_counter()
    for i in range(calls):
        res = call(pool[i])
        recs.append({"i": i, "iterations": int(res.iterations),
                     "converged": bool(res.converged)})
        answers[i] = res.x
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    checks, bad, correct = judge(cell, reference, seed, recs, answers, n,
                                 calls, device)
    return {"seed": seed, "correct": correct, "failed": len(bad),
            "checks": {k: v["value"] for k, v in checks.items()},
            "iterations": [r["iterations"] for r in recs],
            "seconds": seconds}


def main(argv, device=None, root=ROOT):
    import torch

    from h100_bench.spec import Cell

    ap = argparse.ArgumentParser(prog="h100_bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control", choices=("storage", "reference"),
                    default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = Cell(root, args.workload)
    device = torch.device(device or "cuda")
    calls = int(cell.mix["sample"])
    lines = []

    def emit(rec):
        line = json.dumps(rec)
        lines.append(line)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(lines) + "\n")

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    kind = args.control or cell.config.get("control", "reference")
    op = None
    if seeds or (control_seeds and kind == "storage"):
        op = program_operator(cell, device)
    if seeds:
        call = cell.entry().prepare(op, cell.mix, device)
        for seed in seeds:
            emit({"side": "program", "workload": cell.name,
                  **readings(cell, seed, call, device, calls)})
        del call
    if control_seeds:
        call = control_call(cell, device, op, kind)
        del op
        for seed in control_seeds:
            emit({"side": "control", "workload": cell.name, "control": kind,
                  "dtype": CONTROL[cell.config["dtype"]],
                  **readings(cell, seed, call, device, calls)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
