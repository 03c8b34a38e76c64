"""Counters and spans of the solve loop (``utils/profiling.py``) on the CPU.

Counter deltas around one call of ``solve`` / ``run``:

* the eager tolerance loop reads the norm back once an iteration, plus the
  tolerance, the last test and the three reads of ``solve``;
* the replayed loop (a host capture in place of ``graphs.CudaCapture``,
  ``tests/torch_host_capture.py``; chunks 1, 2, 7 and 64, the stops of
  ``test_torch_capture_loops.py``) counts its replays, captures and reads
  as the loop's arithmetic says, and ``steps_taken_back`` is the chunk's
  length where the stop fell inside a chunk, else 0; the counters agree
  with the host capture's own count of replays and captures;
* ``norm_type="none"`` reads back once;
* a history run reads each probe's rows once, and its progress lines once
  a line (eager) or once a replay.

Under a CPU ``torch.profiler`` the spans appear by name, each inside its
``solve``, as often as their counters say, and ``record_function`` gets
``solve=<id>`` with each span's arguments; with no profiler it is never
entered.  Results are the eager loop's bits either way.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.matio.matrix_market import CooMatrix
from new_cg_variants_tpu_torch.ops.operators import from_coo
from new_cg_variants_tpu_torch.solvers import api, graphs
from new_cg_variants_tpu_torch.utils import profiling
from test_torch_variants import scaled_band
from torch_host_capture import host_runner

CHUNKS = (1, 2, 7, 64)
#: as in ``test_torch_capture_loops.py``: 0 (the initial norm is below the
#: tolerance), or T, the first step eager and T = 1 + i c ending chunk i
TARGETS = (0, 2, 8, 9, 15, 65)
NAMES = ("pipe_pr_pcg", "hs_cg")
SPANS = ("solve", "loop.start", "capture", "replay", "readback", "restore")
#: reads of ``solve`` after its loop (``api.solve_result``): the norm, and
#: the tolerance for ``converged``
SOLVE_READS = 2


@pytest.fixture(scope="module")
def sband():
    offsets, data = scaled_band()
    top = operator_from_numpy(offsets, data, device="cpu")
    return top, top.todense() @ np.ones(data.shape[1])


def _jacobi(name):
    return "jacobi" if name.endswith("pcg") else None


def counted(fn):
    """``(fn(), {counter: its growth over the call})``."""
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def _solve(top, b, name, **kw):
    return api.solve(top, b, variant=name, preconditioner=_jacobi(name),
                     device="cpu", **kw)


def _case(top, b, name, how, target):
    """``solve`` keywords of a case that stops at ``target``."""
    if target == 0:
        return dict(rtol=2.0, atol=0.0, max_iter=100)
    if how == "max_iter":
        return dict(rtol=0.0, atol=0.0, max_iter=target)
    # the eager loop's norm at the target, as the absolute tolerance
    norm = _solve(top, b, name, rtol=0.0, atol=0.0, max_iter=target).norm
    return dict(rtol=0.0, atol=norm, max_iter=100)


@pytest.fixture
def replayed(monkeypatch):
    """Make ``graphs.runner`` answer a host runner of ``chunk`` steps; the
    host captures it makes are appended to the list returned."""
    made = []

    def use(chunk):
        monkeypatch.setattr(
            graphs, "runner",
            lambda dev, use_jit, hooked=False: host_runner(chunk, hooked,
                                                           made))
        return made

    return use


# --- the counter table -------------------------------------------------------


def test_count_adds_and_counters_is_a_snapshot():
    before = profiling.counters()
    profiling.count("test.tracing.n")
    profiling.count("test.tracing.n", 4)
    profiling.count("test.tracing.s", 0.25)
    snap = profiling.counters()
    assert snap["test.tracing.n"] - before.get("test.tracing.n", 0) == 5
    assert snap["test.tracing.s"] - before.get("test.tracing.s", 0) == 0.25
    snap["test.tracing.n"] = -1
    assert profiling.counters()["test.tracing.n"] != -1


def test_a_span_with_a_counter_keeps_its_host_seconds():
    _, grown = counted(lambda: _sleep_in_span(0.02))
    assert grown["test.tracing.spans"] == 1
    assert 0.02 <= grown["test.tracing_s"] < 5.0
    _, grown = counted(lambda: _sleep_in_span(0.0, counter=None))
    assert grown == {}


def _sleep_in_span(seconds, counter="test.tracing.spans"):
    import time

    with profiling.span("test.tracing", counter, k=1):
        time.sleep(seconds)


# --- the eager loop ----------------------------------------------------------


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("how", ["tolerance", "max_iter"])
@pytest.mark.parametrize("name", NAMES)
def test_the_eager_loop_reads_once_an_iteration(sband, name, how, target):
    top, b = sband
    kw = _case(top, b, name, how, target)
    res, grown = counted(lambda: _solve(top, b, name, **kw))
    k = res.iterations
    if how == "max_iter":
        assert k == target
    # the tolerance, the norm before each step and after the last one (none
    # when max_iter stopped the loop), and solve's reads
    last = 0 if k == kw["max_iter"] else 1
    assert grown["host_syncs"] == 1 + k + last + SOLVE_READS
    assert grown["solves"] == 1
    assert not {"replays", "captures", "steps_taken_back"} & set(grown)
    assert grown["readback_s"] > 0


# --- the replayed loop -------------------------------------------------------


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("how", ["tolerance", "max_iter"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", NAMES)
def test_the_replayed_loop_counts_as_its_arithmetic(sband, replayed, name,
                                                     chunk, how, target):
    top, b = sband
    kw = _case(top, b, name, how, target)
    want = _solve(top, b, name, use_jit=False, **kw)
    made = replayed(chunk)
    got, grown = counted(lambda: _solve(top, b, name, **kw))
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x) and got.norm == want.norm
    k = got.iterations
    assert grown["solves"] == 1
    if k == 0:
        # the tolerance and the initial norm; no loop is started
        assert grown["host_syncs"] == 2 + SOLVE_READS and made == []
        assert not {"replays", "captures"} & set(grown)
        return
    c = min(chunk, kw["max_iter"] - 1)
    chunks = -(-(k - 1) // c)
    inside = (k - 1) % c
    # the tolerance, the initial norm, the eager first step's norm, one
    # read a chunk, and solve's reads
    assert grown["host_syncs"] == 3 + chunks + SOLVE_READS
    assert grown.get("replays", 0) == chunks + inside == made[0].replays
    assert grown.get("captures", 0) == (chunks > 0) + (inside > 0) \
        == len(made[0].captured)
    assert grown.get("steps_taken_back", 0) == (c if inside else 0)
    assert grown.get("replay_s", 0) > 0 or chunks == 0


@pytest.mark.parametrize("max_iter", [0, 1, 8, 9, 65])
@pytest.mark.parametrize("chunk", (None,) + CHUNKS)
def test_norm_none_reads_back_once(sband, replayed, chunk, max_iter):
    top, b = sband
    want = _solve(top, b, "pipe_pr_cg", norm_type="none", max_iter=max_iter)
    made = replayed(chunk) if chunk else []
    got, grown = counted(lambda: _solve(top, b, "pipe_pr_cg",
                                        norm_type="none", max_iter=max_iter))
    assert torch.equal(got.x, want.x) and got.iterations == max_iter
    assert grown["host_syncs"] == 1 and grown["solves"] == 1
    assert grown.get("replays", 0) == sum(m.replays for m in made)
    assert grown.get("captures", 0) == sum(len(m.captured) for m in made)
    assert "steps_taken_back" not in grown


@pytest.mark.parametrize("print_every", [0, 4])
@pytest.mark.parametrize("chunk", (None,) + CHUNKS)
def test_a_history_run_reads_its_rows_once(sband, replayed, capsys, chunk,
                                           print_every):
    top, b = sband
    made = replayed(chunk) if chunk else []
    probes = ("nu", "alpha")
    out, grown = counted(lambda: api.run(
        "pipe_pr_cg", top, b, max_iter=30, probes=probes,
        print_every=print_every, device="cpu"))
    lines = capsys.readouterr().out.count("\n")
    assert lines == (29 // print_every if print_every else 0)
    # each probe's rows once; the progress lines once a line eagerly, once
    # a replay (and once for the eager first step's row) under replays
    progress = 0
    if print_every:
        progress = made[0].replays + 1 if made else lines
    assert grown["host_syncs"] == len(probes) + progress
    assert grown["solves"] == 1
    assert out["nu"].shape == (30,)


# --- spans -------------------------------------------------------------------


def _spans(prof):
    """The program's span events of a profile, host side."""
    return [e for e in prof.events()
            if e.name in SPANS and e.device_type == DeviceType.CPU]


def _enclosing(e):
    p = e.cpu_parent
    while p is not None and p.name not in SPANS:
        p = p.cpu_parent
    return p


@pytest.mark.parametrize("chunk", CHUNKS)
def test_spans_nest_in_their_solve(sband, replayed, chunk):
    top, b = sband
    kw = _case(top, b, "pipe_pr_pcg", "tolerance", 15)
    want = _solve(top, b, "pipe_pr_pcg", use_jit=False, **kw)
    replayed(chunk)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, grown = counted(lambda: _solve(top, b, "pipe_pr_pcg", **kw))
    assert torch.equal(got.x, want.x) and got.iterations == want.iterations
    spans = _spans(prof)
    by_name = {n: [e for e in spans if e.name == n] for n in SPANS}
    assert len(by_name["solve"]) == 1
    solve = by_name["solve"][0]
    assert _enclosing(solve) is None
    assert len(by_name["readback"]) == grown["host_syncs"]
    assert len(by_name["replay"]) == grown["replays"]
    assert len(by_name["capture"]) == grown["captures"]
    assert len(by_name["loop.start"]) == 1
    assert len(by_name["restore"]) == (1 if grown.get("steps_taken_back")
                                       else 0)
    for e in spans:
        if e is not solve:
            assert _enclosing(e) is solve, e.name
            assert solve.time_range.start <= e.time_range.start
            assert e.time_range.end <= solve.time_range.end


def test_record_function_gets_the_solve_id_and_arguments(sband, replayed,
                                                         monkeypatch):
    top, b = sband
    opened = []
    real = profiling.record_function

    def spy(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(profiling, "record_function", spy)
    replayed(7)
    with profile(activities=[ProfilerActivity.CPU]):
        first = profiling.counters().get("solves", 0) + 1
        _solve(top, b, "hs_cg", rtol=1e-6, max_iter=100)
        _solve(top, b, "hs_cg", rtol=1e-6, max_iter=100)
    names = [n for n, _ in opened]
    assert names.count("solve") == 2
    second = names.index("solve", 1)
    for i, (name, args) in enumerate(opened):
        sid = first if i < second else first + 1
        words = args.split()
        assert words[0] == f"solve={sid}", (name, args)
        if name in ("capture", "replay"):
            assert words[1].startswith("steps=")
            assert int(words[1][6:]) in (1, 7)
        else:
            assert len(words) == 1
    assert {"solve", "loop.start", "capture", "replay",
            "readback"} <= set(names)


def test_the_build_span(monkeypatch):
    opened = []
    real = profiling.record_function
    monkeypatch.setattr(profiling, "record_function",
                        lambda name, args=None: opened.append(
                            (name, args)) or real(name, args))
    n = 64
    i = np.arange(n)
    coo = CooMatrix(shape=(n, n), row=np.r_[i, i[:-1], i[1:]],
                    col=np.r_[i, i[1:], i[:-1]],
                    val=np.r_[np.full(n, 4.0), np.full(2 * n - 2, -1.0)])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op = from_coo(coo, fmt="dia", device="cpu")
    assert op.n == n
    assert [e.name for e in prof.events() if e.name == "build"] == ["build"]
    (name, args), = [o for o in opened if o[0] == "build"]
    assert args.split()[1:] == ["fmt=dia", f"n={n}"]


def test_no_profiler_no_record_function(sband, replayed, monkeypatch):
    top, b = sband
    entered = []
    real = profiling.record_function

    def spy(name, args=None):
        entered.append(name)
        return real(name, args)

    monkeypatch.setattr(profiling, "record_function", spy)
    replayed(7)
    res, grown = counted(lambda: _solve(top, b, "pipe_pr_cg", rtol=1e-6))
    assert entered == [] and grown["replays"] > 0
    api.run("pipe_pr_cg", top, b, max_iter=20, device="cpu")
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        again = _solve(top, b, "pipe_pr_cg", rtol=1e-6)
    assert "solve" in entered and "replay" in entered
    assert torch.equal(again.x, res.x)
