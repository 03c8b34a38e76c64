"""The compiled mesh loop on the CPU (``parallel/dist.py``,
``harness/scaling.py``): ``dist_run``, ``dist_solve`` and
``time_variant(mesh=)`` with their loops captured, against the eager loop.

On the card the three mesh loops replay captured CUDA graphs with every
collective of a step inside them (``graphs.runner`` of the rank's device);
on the CPU they run eagerly.  Here each spawned gloo rank (groups of 1 and
2, ``tests/torch_dist_groups.py``; the ranks import only the port) has
``graphs.runner`` answer a host capture (``tests/torch_host_capture.py``)
of chunks of 1, 2 and 7 steps, so the public entry points run the replayed
loops' bookkeeping with gloo's collectives; each case then runs eagerly.
Held, on every row context (half-band, DIA, ELL by index exchange and by
all-gather, block-banded, stencil, f32x2) and the column context packed
and unpacked:

* ``dist_run``: ``x``, ``nu`` and every probe (``save_x`` gathered) the
  eager bits, the chunk graph replayed as many times as the loop has whole
  chunks;
* ``dist_solve``: the eager iterations, norm and bits where the loop stops
  before its first step, at the end of a chunk, inside one, and at
  ``max_iter`` (``norm_type="none"`` too);
* ``time_variant(mesh=)``: the eager forward error, and the harness's
  chained trials the eager ``x``;
* the gv replacement hook: a tensor answer the eager bits, a Python answer
  ``TypeError``.

Also: the mesh path takes the eager loop on the CPU (no runner is
started), and no mesh context's step or probe row reads back to the host
(``HostReads`` of ``tests/test_torch_capture_reads.py``, the condition for
capture) in an in-process world of one and across two ranks.  Parity with
the JAX package's ``dist_run`` stays in ``tests/test_torch_distributed*.py``.
"""

import numpy as np
import pytest

import new_cg_variants_tpu_torch as port
import torch_dist_groups as groups_
import torch_dist_worker as worker
from new_cg_variants_tpu_torch.parallel import dist as pdist
from new_cg_variants_tpu_torch.solvers import graphs
from new_cg_variants_tpu_torch.utils import profiling

WORLDS = (1, 2)
CHUNKS = (1, 2, 7)
DEADLINE_S = 240
N = 256
ITERS = 12  # history rows: the first step eager, then 10 replayed
PROBES = ("nu", "alpha", "residual_2_norm", "save_x")
#: context -> (problem, fmt, keyword arguments of the entry points)
CONTEXTS = {
    "symdia": (("scaled", N, 4), "symdia", {}),
    "dia": (("scaled", N, 4), "dia", {}),
    "ell": (("ell", N, 7, 20, 3), "ell", {}),
    "ell all-gather": (("ell", N, 7, None, 3), "ell", {}),
    "block": (("block", N, 2, 1e2), "block", {}),
    "stencil": (("banded", N, 4, 1e2), "stencil", {}),
    "f32x2": (("banded", N, 4, 1e2), "dia", {"dtype": "f32x2"}),
    "col": (("dense", N, 4, 1e2), "dense", {"partition": "col"}),
    "col unpacked": (("dense", N, 4, 1e2), "dense",
                     {"partition": "col", "col_packed": False}),
}
#: (context, chunk) of the solves that stop at every point: the half-band
#: context in each chunk, the ELL and column contexts in chunks of 7
SOLVES = [("symdia", c) for c in CHUNKS] + [("ell", 7), ("col", 7)]
#: the iteration a solve stops at: 0 (the initial norm below the
#: tolerance); with the first step eager, T = 1 + i c ends chunk i of c
#: steps, so 8 ends a chunk of 1 or 7 and falls inside one of 2, and 9
#: ends a chunk of 1 or 2 and falls inside one of 7
TARGETS = (0, 8, 9)
#: (target, how) of each solve: max_iter = 0 is the norm-none case's
STOPS = [(t, how) for t in TARGETS for how in ("tolerance", "max_iter")
         if t or how == "tolerance"]
#: (context, chunk) of the history runs: every context in chunks of 7,
#: all but f32x2 (the slowest on the CPU) in chunks of 1 and 2 too
RUNS = [(ctx, c) for ctx in CONTEXTS for c in CHUNKS
        if ctx != "f32x2" or c == 7]
#: the contexts of time_variant, each in chunks of 7, the half-band one in
#: each chunk
TIMED = ("symdia", "dia", "ell", "block", "f32x2", "col")
TIMED_RUNS = [("symdia", c) for c in CHUNKS[:-1]] + [(ctx, 7)
                                                     for ctx in TIMED]
TIMED_ITERS = 15
TIMED_CHUNK_ITERS = 4  # 3 chunks: 12 steps a trial


def _case(key, entry, ctx, chunk, variant="pipe_pr_pcg", **extra):
    prob, fmt, kw = CONTEXTS[ctx]
    kw = dict(kw, **extra.pop("kw", {}))
    if variant.endswith("pcg"):
        kw.setdefault("preconditioner", "jacobi")
    return dict(key=key, kind="captured", entry=entry, fmt=fmt,
                problem=prob, variant=variant, chunk=chunk, kw=kw, **extra)


def cases(world):
    out = []
    for ctx, chunk in RUNS:
        out.append(_case(("run", ctx, chunk), "run", ctx, chunk,
                         kw=dict(max_iter=ITERS, probes=PROBES)))
    for ctx in CONTEXTS:
        out.append(_case(("solve none", ctx), "solve", ctx, 7,
                         kw=dict(norm_type="none", max_iter=9)))
        out.append(dict(key=("reads", ctx), kind="reads", fmt=CONTEXTS[ctx][1],
                        problem=CONTEXTS[ctx][0], variant="pipe_pr_pcg",
                        kw=CONTEXTS[ctx][2]))
    for ctx, chunk in SOLVES:
        for target, how in STOPS:
            out.append(_case(("solve", ctx, chunk, target, how),
                             "solve", ctx, chunk, target=target, how=how))
    out.append(_case(("solve inside", "f32x2"), "solve", "f32x2", 7,
                     target=9, how="tolerance"))
    for ctx, chunk in TIMED_RUNS:
        out.append(_case(("time_variant", ctx, chunk), "time_variant", ctx,
                         chunk, variant="pipe_pr_cg",
                         kw=dict(max_iter=TIMED_ITERS, trials=2,
                                 chunk_iters=TIMED_CHUNK_ITERS,
                                 x_true=np.ones(N))))
    for ctx in TIMED:
        out.append(dict(key=("chained", ctx), kind="chained",
                        fmt=CONTEXTS[ctx][1], problem=CONTEXTS[ctx][0],
                        variant="pipe_pr_cg", chunk=7, steps=12, trials=3,
                        kw=CONTEXTS[ctx][2]))
    for chunk in CHUNKS:
        out.append(_case(("hook", chunk), "run", "symdia", chunk,
                         variant="gv_cg",
                         kw=dict(max_iter=ITERS, probes=PROBES,
                                 hook="tensor")))
    out.append(_case(("hook", "bool"), "run", "symdia", 7, variant="gv_cg",
                     kw=dict(max_iter=ITERS, hook="bool")))
    return out


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory):
    """The gloo groups, started with the module: the tests in this process
    run while they work."""
    tmp = tmp_path_factory.mktemp("dist_capture")
    started = {world: groups_.start(world, tmp, cases(world))
               for world in WORLDS}
    yield started
    groups_.kill(started)


@pytest.fixture(scope="module")
def runs(groups):
    return groups_.join(groups, DEADLINE_S)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _replays(steps, chunk):
    """Replays of ``steps`` steps in chunks of ``chunk``: whole chunks,
    then one step a replay."""
    return steps // chunk + steps % chunk


# --- in this process: a world of one ---------------------------------------


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    fresh = not dist.is_initialized()
    yield pdist.make_mesh(device="cpu")
    if fresh and dist.is_initialized():
        dist.destroy_process_group()


def test_the_mesh_path_takes_the_eager_loop_on_the_cpu(monkeypatch, mesh):
    """On ``device="cpu"`` ``dist_run``, ``dist_solve`` and
    ``time_variant(mesh=)`` start no runner."""
    from new_cg_variants_tpu_torch.harness.scaling import time_variant

    made = []
    real = graphs.Runner.start
    monkeypatch.setattr(graphs.Runner, "start",
                        lambda self, *a, **k: made.append(1) or real(
                            self, *a, **k))
    op, b = worker.problem(("scaled", N, 4), "symdia")
    pdist.dist_run("pipe_pr_cg", op, b, mesh=mesh, max_iter=12,
                   device="cpu")
    pdist.dist_run("gv_cg", op, b, mesh=mesh, max_iter=12, device="cpu",
                   w_replace=worker._every3_bool)  # a Python answer runs
    pdist.dist_solve(op, b, mesh=mesh, max_iter=40, device="cpu")
    time_variant("pipe_pr_cg", op, b, max_iter=10, trials=1, mesh=mesh,
                 device="cpu")
    assert made == []


@pytest.mark.parametrize("norm_type", ["natural", "none"])
def test_dist_solve_counts_the_reads_of_solve(mesh, norm_type):
    """``dist_solve`` reads its result back as ``solve`` does
    (``api.solve_result``): with the same arguments on a world of one, the
    same iterations and the same ``host_syncs``, so its norm and tolerance
    reads are counted as ``solve``'s."""
    op, b = worker.problem(("scaled", N, 4), "symdia")
    kw = dict(variant="pipe_pr_pcg", preconditioner="jacobi", rtol=1e-6,
              max_iter=40, norm_type=norm_type, device="cpu")
    got = {}
    for entry, fn in (("solve", lambda: port.solve(op, b, **kw)),
                      ("dist_solve", lambda: pdist.dist_solve(
                          op, b, mesh=mesh, **kw))):
        before = profiling.counters().get("host_syncs", 0)
        res = fn()
        got[entry] = (res.iterations,
                      profiling.counters().get("host_syncs", 0) - before)
    assert got["dist_solve"] == got["solve"]


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
@pytest.mark.parametrize("ctx", list(CONTEXTS) + ["dia compensated"])
def test_a_mesh_step_and_its_rows_read_nothing_back(mesh, ctx, name):
    """Every name's step on each mesh context, and its probe rows (every
    probe, the progress value, the tolerance loop's norms), read nothing
    back to the host: a pcg name also with a norm riding the dot batch, a
    gv name with its replacement hook as a captured loop calls it (but in
    f32x2, which takes none)."""
    base = ctx.replace(" compensated", "")
    prob, fmt, kw = CONTEXTS[base]
    kw = dict(kw, compensated=ctx != base)
    got = worker._reads(dict(problem=prob, fmt=fmt, variant=name, kw=kw))
    assert got["reads"] == []


# --- the gloo groups ------------------------------------------------------


@pytest.mark.parametrize("ctx, chunk", RUNS)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_run_captured_gives_the_eager_bits(runs, world, ctx, chunk):
    got = groups_.result(runs, world, ("run", ctx, chunk))
    cap, eager = got["captured"], got["eager"]
    for key in ("x", "nu") + PROBES:
        assert _same(cap[key], eager[key]), key
    assert cap["save_x"].shape == (ITERS, N)
    # one loop: its first step eagerly, then ITERS - 2 steps replayed
    (captured, replays), = got["captures"]
    assert replays == _replays(ITERS - 2, chunk)
    assert captured == (1 if chunk == 1 or (ITERS - 2) % chunk == 0 else 2)


@pytest.mark.parametrize("target, how", STOPS)
@pytest.mark.parametrize("ctx, chunk", SOLVES)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_solve_captured_stops_where_the_eager_loop_stops(
        runs, world, ctx, chunk, target, how):
    got = groups_.result(runs, world, ("solve", ctx, chunk, target, how))
    cap, eager = got["captured"], got["eager"]
    assert cap["iterations"] == eager["iterations"]
    if how == "max_iter" or target == 0:
        assert cap["iterations"] == target
    assert _same(cap["x"], eager["x"])
    assert _same(np.float64(cap["norm"]), np.float64(eager["norm"]))
    assert cap["converged"] == eager["converged"]
    if cap["iterations"] < 2:
        assert all(n == 0 for n, _ in got["captures"])
        return
    # the chunk graph, and the one-step graph only where the loop stopped
    # inside a chunk
    (captured, _), = got["captures"]
    c = min(chunk, (target if how == "max_iter" else 100) - 1)
    assert captured == (1 if (cap["iterations"] - 1) % c == 0 else 2)


@pytest.mark.parametrize("ctx", list(CONTEXTS) + ["f32x2 inside"])
@pytest.mark.parametrize("world", WORLDS)
def test_dist_solve_captured_norm_none_and_double_words(runs, world, ctx):
    if ctx == "f32x2 inside":
        got = groups_.result(runs, world, ("solve inside", "f32x2"))
    else:
        got = groups_.result(runs, world, ("solve none", ctx))
    cap, eager = got["captured"], got["eager"]
    assert cap["iterations"] == eager["iterations"]
    assert _same(cap["x"], eager["x"])
    assert _same(np.float64(cap["norm"]), np.float64(eager["norm"]))
    assert cap["converged"] == eager["converged"]
    if ctx != "f32x2 inside":
        # the first step eagerly, a chunk of 7 steps, one step
        assert cap["iterations"] == 9
        (_, replays), = got["captures"]
        assert replays == _replays(8, 7) == 2


@pytest.mark.parametrize("ctx, chunk", TIMED_RUNS)
@pytest.mark.parametrize("world", WORLDS)
def test_time_variant_on_a_mesh_captured(runs, world, ctx, chunk):
    """The warm-up trial captures, the two timed ones replay: the eager
    run's forward error, bit for bit."""
    got = groups_.result(runs, world, ("time_variant", ctx, chunk))
    cap, eager = got["captured"], got["eager"]
    assert cap["n_devices"] == eager["n_devices"] == world
    assert cap["n"] == N and len(cap["times"]) == 2
    assert np.isfinite(cap["error"])
    assert _same(np.float64(cap["error"]), np.float64(eager["error"]))
    steps = (TIMED_ITERS // TIMED_CHUNK_ITERS) * TIMED_CHUNK_ITERS
    (_, replays), = got["captures"]
    # the loop's chunk is bounded by the first trial's steps
    c = min(chunk, steps - 1)
    assert replays == _replays(steps - 1, c) + 2 * _replays(steps, c)


@pytest.mark.parametrize("ctx", TIMED)
@pytest.mark.parametrize("world", WORLDS)
def test_chained_trials_on_a_mesh_give_the_eager_iterate(runs, world, ctx):
    got = groups_.result(runs, world, ("chained", ctx))
    assert got["eager"].shape == (N,)
    assert _same(got["captured"], got["eager"])


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("world", WORLDS)
def test_a_tensor_hook_captured_gives_the_eager_bits(runs, world, chunk):
    got = groups_.result(runs, world, ("hook", chunk))
    cap, eager = got["captured"], got["eager"]
    for key in ("x", "nu") + PROBES:
        assert _same(cap[key], eager[key]), key


@pytest.mark.parametrize("world", WORLDS)
def test_a_python_hook_answer_is_refused_under_capture(runs, world):
    got = groups_.result(runs, world, ("hook", "bool"))
    assert got["captured"][0] == "TypeError"
    assert "use_jit=False" in got["captured"][1]
    assert got["eager"]["nu"].shape == ()  # eagerly it branches in Python


@pytest.mark.parametrize("ctx", list(CONTEXTS))
@pytest.mark.parametrize("world", WORLDS)
def test_a_mesh_step_reads_nothing_back_on_gloo_ranks(runs, world, ctx):
    """The step and rows of pipe-PR-PCG on each context at 1 and 2 ranks
    (at 2: the halo exchange's and the planned ELL exchange's messages)."""
    got = groups_.result(runs, world, ("reads", ctx))
    assert got["reads"] == []
    if ctx == "ell" and world == 2:
        assert got["shifts"]  # the index exchange, not the all-gather
