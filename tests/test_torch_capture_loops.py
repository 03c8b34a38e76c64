"""The compiled loop's chunk logic on the CPU (``solvers/graphs.py``,
``solvers/engine.py``).

On the card ``use_jit=True`` replays captured CUDA graphs of chunks of
steps; here a host capture stands in for ``graphs.CudaCapture``
(``tests/torch_host_capture.py``): a capture hands back the chunk's body,
and a replay calls it.  The body reads and
writes the same static buffers a graph would, so what is held here is the
loops' bookkeeping: the first step run eagerly, whole chunks, the rest a
step a replay, the rows copied out after each replay, the tolerance
loop's one read a chunk and its return to the chunk's start where the
eager loop would stop inside it.

Chunks of 1, 2, 7 and 64 steps.  Every case gives the eager loop's
iterations and bits exactly, and agrees with the JAX package's ``run`` /
``solve`` as the port's parity tests hold it (float64, the scaled band of
``test_torch_variants.py``; histories to rtol 1e-10 over 25 rows,
iterations within 2).  The gv replacement hook under capture: ``k`` a
device integer, a Python answer refused, a tensor answer the eager bits.
"""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.ops.sym_dia import SymDiaOperator as JaxSymDia
from new_cg_variants_tpu.solvers import api as japi
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.probes.probes import resolve_probes
from new_cg_variants_tpu_torch.solvers import api as tapi
from new_cg_variants_tpu_torch.solvers import engine, graphs
from new_cg_variants_tpu_torch.solvers.context import Context
from test_torch_variants import scaled_band
from torch_host_capture import host_runner

CHUNKS = (1, 2, 7, 64)
RTOL = 1e-10
ROWS = 25
PROBES = ("nu", "alpha", "residual_2_norm", "save_x")
NORM_TYPES = ("natural", "unpreconditioned", "preconditioned")
#: the iteration a tolerance case stops at: 0 (the initial norm is below
#: the tolerance), or T (the tolerance is the eager loop's norm there, or
#: max_iter = T with rtol = 0); with the first step eager, T = 1 + i c ends
#: chunk i of c steps, other T fall inside one
TARGETS = (0, 2, 8, 9, 15, 65)
NAMES = ("pipe_pr_pcg", "hs_cg")


@pytest.fixture(scope="module")
def sband():
    offsets, data = scaled_band()
    jop = JaxSymDia(offsets, jnp.asarray(data))
    top = operator_from_numpy(offsets, data, device="cpu")
    b = top.todense() @ np.ones(data.shape[1])
    return jop, top, b


def _jacobi(name):
    return "jacobi" if name.endswith("pcg") else None


def _pieces(top, name, w_replace=None, w_replace_init=None):
    return tapi.resolve(name, top, _jacobi(name), w_replace=w_replace,
                        w_replace_init=w_replace_init)[3:]


def _history(top, b, name, length, runner=None, print_every=0, **hooks):
    init_fn, step_fn, precond = _pieces(top, name, **hooks)
    tb = torch.from_numpy(b)
    return engine.history_scan(Context(top, precond), init_fn, step_fn,
                               resolve_probes(PROBES), tb,
                               torch.zeros_like(tb), length, {"b": tb},
                               print_every=print_every, runner=runner)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# --- history_scan ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(name, length):
    offsets, data = scaled_band()
    jop = JaxSymDia(offsets, jnp.asarray(data))
    b = operator_from_numpy(offsets, data, device="cpu").todense() \
        @ np.ones(data.shape[1])
    return japi.run(name, jop, b, max_iter=length,
                    probes=("nu", "alpha"), preconditioner=_jacobi(name))


@pytest.mark.parametrize("length", [1, 2, 3, 9, 10, 41])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", ["pipe_pr_pcg", "gv_cg", "hs_pcg"])
def test_history_replayed_gives_the_eager_bits(sband, name, chunk, length):
    _, top, b = sband
    made = []
    want_s, want = _history(top, b, name, length)
    got_s, got = _history(top, b, name, length,
                          runner=host_runner(chunk, made=made))
    for p in PROBES:
        assert _same(got[p], want[p]), p
    assert _same(got_s["x"], want_s["x"]) and got_s["k"] == want_s["k"]
    # the first step eagerly, then whole chunks (of no more steps than
    # remain), the rest one step a replay
    steps = length - 1
    if steps < 2:
        assert made == [] or made[0].captured == []
    else:
        c = min(chunk, steps - 1)
        assert made[0].replays == (steps - 1) // c + (steps - 1) % c
    jax = _jax_run(name, length)
    rows = min(length, ROWS)
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p].numpy()[:rows],
                                   np.asarray(jax[p])[:rows], rtol=RTOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_progress_lines_replayed_are_the_eager_lines(sband, capsys, chunk):
    _, top, b = sband
    _history(top, b, "pipe_pr_cg", 30, print_every=4)
    want = capsys.readouterr().out
    _history(top, b, "pipe_pr_cg", 30, print_every=4,
             runner=host_runner(chunk))
    got = capsys.readouterr().out
    assert got == want and want.count("\n") == 7


@pytest.mark.parametrize("chunk", CHUNKS)
def test_loop_loads_a_state_and_advances_as_the_eager_steps(sband, chunk):
    """``Loop.load`` / ``advance`` (how ``time_variant`` chains its trials):
    from an init state, m steps are the eager loop's m steps."""
    _, top, b = sband
    init_fn, step_fn, precond = _pieces(top, "pipe_pr_pcg")
    ctx = Context(top, precond)
    tb = torch.from_numpy(b)
    s0 = init_fn(ctx, tb, torch.zeros_like(tb))
    loop = host_runner(chunk).start(ctx, step_fn, s0, horizon=20)
    for m in (20, 13):
        loop.load(init_fn(ctx, tb * 1.5, torch.zeros_like(tb)))
        loop.advance(m)
        want = init_fn(ctx, tb * 1.5, torch.zeros_like(tb))
        for _ in range(m):
            want = step_fn(ctx, want)
        got = loop.state()
        assert got["k"] == want["k"] == m
        for key in ("x", "r", "nu", "a", "a1", "a2", "b1"):
            assert _same(got[key], want[key]), key


# --- tolerance_loop ----------------------------------------------------------


def _solve(top, b, name, norm_type, rtol, atol, max_iter, runner=None):
    init_fn, step_fn, precond = _pieces(top, name)
    tb = torch.from_numpy(b)
    return engine.tolerance_loop(Context(top, precond), init_fn, step_fn, tb,
                                 torch.zeros_like(tb), max_iter, rtol, atol,
                                 norm_type, runner=runner)


@functools.lru_cache(maxsize=None)
def _case(name, norm_type, how, target):
    """``(rtol, atol, max_iter)`` of a case that stops at ``target``."""
    offsets, data = scaled_band()
    top = operator_from_numpy(offsets, data, device="cpu")
    b = top.todense() @ np.ones(data.shape[1])
    if target == 0:
        return 2.0, 0.0, 100
    if how == "max_iter":
        return 0.0, 0.0, target
    # the eager loop's norm at the target, as the absolute tolerance
    _, _, nrm, _ = _solve(top, b, name, norm_type, 0.0, 0.0, target)
    return 0.0, float(nrm), 100


@functools.lru_cache(maxsize=None)
def _jax_solve(name, norm_type, rtol, atol, max_iter):
    offsets, data = scaled_band()
    jop = JaxSymDia(offsets, jnp.asarray(data))
    b = operator_from_numpy(offsets, data, device="cpu").todense() \
        @ np.ones(data.shape[1])
    return japi.solve(jop, b, variant=name, rtol=rtol, atol=atol,
                      max_iter=max_iter, norm_type=norm_type,
                      preconditioner=_jacobi(name))


def _tolerance_case(sband, name, norm_type, how, target, chunk):
    _, top, b = sband
    rtol, atol, max_iter = _case(name, norm_type, how, target)
    want = _solve(top, b, name, norm_type, rtol, atol, max_iter)
    made = []
    got = _solve(top, b, name, norm_type, rtol, atol, max_iter,
                 runner=host_runner(chunk, made=made))
    assert got[1] == want[1]
    assert _same(got[0]["x"], want[0]["x"]) and got[0]["k"] == want[0]["k"]
    assert _same(got[2], want[2]) and _same(got[3], want[3])
    jax = _jax_solve(name, norm_type, rtol, atol, max_iter)
    assert abs(got[1] - jax.iterations) <= 2
    return got[1], made


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("how", ["tolerance", "max_iter"])
@pytest.mark.parametrize("norm_type", NORM_TYPES)
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", NAMES)
def test_tolerance_replayed_stops_where_the_eager_loop_stops(
        sband, name, chunk, norm_type, how, target):
    iterations, made = _tolerance_case(sband, name, norm_type, how, target,
                                       chunk)
    if how == "max_iter":
        assert iterations == target
    if iterations < 2:
        return
    # one read a chunk: the chunk graph ran once for each chunk started
    # after the eager first step, the one-step graph only where the loop
    # stopped inside a chunk
    cap = made[0]
    c = min(chunk, (iterations if how == "max_iter" else 100) - 1)
    chunks = -(-(iterations - 1) // c)
    inside = (iterations - 1) % c
    assert cap.replays == chunks + inside
    assert len(cap.captured) == (2 if inside else 1)


@pytest.mark.parametrize("max_iter", [0, 1, 8, 9, 65])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", NAMES)
def test_norm_none_replays_max_iter_steps(sband, name, chunk, max_iter):
    _, top, b = sband
    want = _solve(top, b, name, "none", 0.0, 0.0, max_iter)
    got = _solve(top, b, name, "none", 0.0, 0.0, max_iter,
                 runner=host_runner(chunk))
    assert got[1] == want[1] == max_iter
    assert _same(got[0]["x"], want[0]["x"]) and _same(got[2], want[2])
    assert _jax_solve(name, "none", 0.0, 0.0, max_iter).iterations \
        == max_iter


# --- the gv replacement hook under capture -----------------------------------


def test_a_python_answer_is_refused_under_capture():
    view = {}
    for answer in (True, False, np.bool_(True)):
        with pytest.raises(TypeError, match="use_jit=False"):
            graphs.checked_hook(lambda k, v: answer, stateful=False)(
                torch.tensor(3), view)
        with pytest.raises(TypeError, match="use_jit=False"):
            graphs.checked_hook(lambda k, v, st: (answer, st),
                                stateful=True)(torch.tensor(3), view, {})
    out = graphs.checked_hook(lambda k, v: k % 10 == 0, stateful=False)(
        torch.tensor(20), view)
    assert isinstance(out, torch.Tensor) and bool(out)


def test_a_python_answer_fails_the_replayed_run(sband):
    _, top, b = sband
    hook = graphs.checked_hook(lambda k, view: True, stateful=False)
    with pytest.raises(TypeError, match="use_jit=False"):
        _history(top, b, "gv_cg", 20, runner=host_runner(7, hooked=True),
                 w_replace=hook)


def _tensor_every10(k, view):
    return torch.as_tensor(k % 10 == 0)


def _policy(k, view, st):
    do = torch.as_tensor(k >= st["next_k"])
    return do, dict(
        next_k=torch.where(do, st["next_k"] + st["interval"], st["next_k"]),
        interval=torch.where(do, 2 * st["interval"], st["interval"]),
        count=st["count"] + do.to(st["count"].dtype))


def _jax_policy(k, view, st):
    do = k >= st["next_k"]
    return do, dict(
        next_k=jnp.where(do, st["next_k"] + st["interval"], st["next_k"]),
        interval=jnp.where(do, 2 * st["interval"], st["interval"]),
        count=st["count"] + do.astype(jnp.int32))


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", ["gv_cg", "gv_pcg"])
def test_a_tensor_answer_replayed_gives_the_eager_bits(sband, name, chunk):
    """A hook answering with a tensor, called with a device ``k`` under
    capture, gives the eager run's bits (where ``k`` is a Python int), and
    the JAX run's histories."""
    jop, top, b = sband
    want_s, want = _history(top, b, name, 41, w_replace=_tensor_every10)
    hook = graphs.checked_hook(_tensor_every10, stateful=False)
    got_s, got = _history(top, b, name, 41, w_replace=hook,
                          runner=host_runner(chunk, hooked=True))
    for p in PROBES:
        assert _same(got[p], want[p]), p
    assert _same(got_s["x"], want_s["x"]) and got_s["k"] == want_s["k"] == 40
    jax = japi.run(name, jop, b, max_iter=41, probes=("nu", "alpha"),
                   preconditioner=_jacobi(name),
                   w_replace=lambda k, view: k % 10 == 0)
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p].numpy()[:ROWS],
                                   np.asarray(jax[p])[:ROWS], rtol=RTOL)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_a_stateful_hook_rides_the_replayed_state(sband, chunk):
    """The doubling-interval policy of ``test_torch_variants.py`` written
    with tensors: its state rides the captured loop as device tensors
    (given as Python ints, made tensors at the start) and ends where the
    eager run's does."""
    jop, top, b = sband
    init = dict(next_k=torch.tensor(5), interval=torch.tensor(10),
                count=torch.tensor(0))
    want_s, want = _history(top, b, "gv_cg", 60, w_replace=_policy,
                            w_replace_init=init)
    hook = graphs.checked_hook(_policy, stateful=True)
    got_s, got = _history(top, b, "gv_cg", 60, w_replace=hook,
                          w_replace_init=dict(next_k=5, interval=10, count=0),
                          runner=host_runner(chunk, hooked=True))
    for p in PROBES:
        assert _same(got[p], want[p]), p
    assert {k: int(v) for k, v in got_s["wrep"].items()} == \
        {k: int(v) for k, v in want_s["wrep"].items()} == \
        dict(next_k=75, interval=80, count=3)
    jax = japi.run("gv_cg", jop, b, max_iter=60, probes=("nu",),
                   w_replace=_jax_policy,
                   w_replace_init=dict(next_k=np.int32(5),
                                       interval=np.int32(10),
                                       count=np.int32(0)))
    np.testing.assert_allclose(got["nu"].numpy()[:ROWS],
                               np.asarray(jax["nu"])[:ROWS], rtol=RTOL)


def test_run_and_solve_take_the_eager_loop_on_the_cpu(monkeypatch, sband):
    """On ``device="cpu"`` no runner is made, whatever ``use_jit`` says."""
    _, top, b = sband
    made = []
    real = graphs.Runner.start
    monkeypatch.setattr(graphs.Runner, "start",
                        lambda self, *a, **k: made.append(1) or real(
                            self, *a, **k))
    for jit in (True, False):
        tapi.run("pipe_pr_cg", top, b, max_iter=40, use_jit=jit,
                 device="cpu")
        tapi.solve(top, b, max_iter=40, use_jit=jit, device="cpu")
    assert made == []
    assert graphs.runner(torch.device("cpu"), True) is None
    assert graphs.runner(torch.device("cuda"), False) is None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tapi.run("pipe_pr_cg", top, b, max_iter=9, print_every=4,
                 device="cpu")
    assert buf.getvalue().count("iter ") == 2
