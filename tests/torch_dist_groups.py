"""Gloo groups of spawned ranks for the port's distributed tests.

:func:`start` spawns the ``world`` ranks of one group, each running
``torch_dist_worker.main`` on the same list of cases (the ranks import only
the port); :func:`join` waits for every group under one deadline, kills what
is left on expiry and fails the calling test, and returns each group's
results (rank 0's ``{case key: (status, value)}``).
"""

import multiprocessing
import pickle
import time

import pytest

import torch_dist_worker as worker


def start(world, tmp, cases):
    """Spawn the ranks of a group of ``world`` running ``cases``; returns
    ``(processes, path of rank 0's results)``."""
    ctx = multiprocessing.get_context("spawn")
    out = tmp / f"results_{world}.pkl"
    procs = [ctx.Process(target=worker.main, daemon=True,
                         args=(rank, world, str(tmp / f"store_{world}"),
                               str(out), cases))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs, out


def join(groups, deadline_s):
    """Wait for every group (``{world: start(...)}``) until ``deadline_s``
    seconds from now; kill all on expiry.  Returns ``{world: results}``."""
    end = time.monotonic() + deadline_s
    for procs, _ in groups.values():
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    late = [p for procs, _ in groups.values() for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(10)
    if late:
        pytest.fail(f"{len(late)} rank processes still running after "
                    f"{deadline_s} s: killed")
    results = {}
    for world, (procs, out) in groups.items():
        codes = [p.exitcode for p in procs]
        if any(codes):
            pytest.fail(f"world {world}: rank exit codes {codes}")
        with open(out, "rb") as f:
            results[world] = pickle.load(f)
    return results


def kill(groups):
    """Kill every rank still running (after a failed reference)."""
    for procs, _ in groups.values():
        for p in procs:
            if p.is_alive():
                p.kill()


def result(results, world, key):
    """The value of a case that ran without error on rank 0."""
    status, value = results[world][key]
    assert status == "ok", value
    return value
