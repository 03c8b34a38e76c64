"""The store of captured loops (``solvers/graphs.py``: ``Store``,
``capture_key``; ``solvers/context.py``: ``Context.graph_key``).

On the CPU a host capture stands in for ``graphs.CudaCapture``
(``tests/torch_host_capture.py``: a replay calls the chunk's body), and
``graphs.runner`` answers runners that share one store of the test's own:

* a second tolerance solve on an operator captures nothing and counts one
  ``capture_hits``;
* a loop misses on each part of the key alone (the state's shape and
  dtype, the step, the rows, the chunk, the checkpoint, the operator
  object, the dots), and a solve on another variant or norm type; a Jacobi
  diagonal, a mesh context and a double-word one name no key;
* an entry goes with its operator, and where the operator is freed during
  a capture, at the store's next lease;
* an answer is not overwritten by the next solve; two live loops of one key
  share no buffer; the store keeps at most its bound;
* an ELL operator in a locality order solves on one inner operator, and an
  operator already on the current card passes ``as_operator`` as itself,
  so repeated solves on either find their graphs;
* five successive right-hand sides give ``use_jit=False``'s iterations,
  norm and answer bit for bit, for pipe_pr_cg, pr_cg and hs_cg under the
  natural norm and none.

On the card (marker ``card``; ``python -m pytest
tests/test_torch_graph_store.py -m card --noconftest -q``): five successive
solves against ``use_jit=False`` bit for bit, and the reserved memory over
200 solves on one operator.  The file imports the port, torch and numpy
only, so that it runs where JAX is absent.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from new_cg_variants_tpu_torch import banded_model, solve
from new_cg_variants_tpu_torch.ops.block_banded import solver_basis
from new_cg_variants_tpu_torch.ops.doublefloat import DoubleFloatContext
from new_cg_variants_tpu_torch.ops.operators import EllOperator, as_operator
from new_cg_variants_tpu_torch.ops.sym_dia import SymDiaOperator
from new_cg_variants_tpu_torch.parallel.contexts import RowShardContext
from new_cg_variants_tpu_torch.solvers import graphs
from new_cg_variants_tpu_torch.solvers.context import Context
from new_cg_variants_tpu_torch.solvers.precond import JacobiPreconditioner
from new_cg_variants_tpu_torch.utils import profiling
from torch_host_capture import HostCapture

N, K, KAPPA = 400, 4, 100.0
CHUNK = 7
RTOL = 1e-8
NAMES = ("pipe_pr_cg", "pr_cg", "hs_cg")
NORMS = ("natural", "none")


@pytest.fixture
def band():
    op, _, _ = banded_model(N, k=K, kappa=KAPPA, device="cpu")
    return op


def _rhs(i, n=N, dtype=torch.float64, device="cpu"):
    g = torch.Generator().manual_seed(1000 + i)
    return torch.randn(n, generator=g, dtype=dtype).to(device)


@pytest.fixture
def stored(monkeypatch):
    """``graphs.runner`` answering runners of host captures (``CHUNK``
    steps) that share one store; yields ``(store, captures made)``."""
    store, made = graphs.Store(), []

    def make():
        made.append(HostCapture())
        return made[-1]

    def runner(device, use_jit, hooked=False):
        if not use_jit:
            return None
        return graphs.Runner(make, chunk=CHUNK, k_on_device=hooked,
                             store=store)

    monkeypatch.setattr(graphs, "runner", runner)
    return store, made


def counted(fn):
    """``(fn(), {counter: its growth over the call})``."""
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def _solve(op, b, **kw):
    kw = {"rtol": RTOL, "max_iter": 300, **kw}
    return solve(op, b, device="cpu", **kw)


# --- the loops of solve -------------------------------------------------------


def test_a_second_solve_on_the_operator_captures_nothing(band, stored):
    store, made = stored
    b = _rhs(0)
    first, grown = counted(lambda: _solve(band, b))
    assert grown["captures"] == 2 and "capture_hits" not in grown
    assert len(store) == 1 and len(made) == 1
    again, grown = counted(lambda: _solve(band, b))
    assert grown["capture_hits"] == 1 and "captures" not in grown
    assert grown["replays"] > 0 and len(made) == 1
    assert again.iterations == first.iterations
    assert torch.equal(again.x, first.x)


@pytest.mark.parametrize("part", [
    dict(variant="pr_cg"), dict(norm_type="none"),
    dict(norm_type="preconditioned", variant="pipe_pr_pcg")])
def test_a_solve_of_another_variant_or_norm_misses(band, stored, part):
    store, made = stored
    _solve(band, _rhs(0))
    _, grown = counted(lambda: _solve(band, _rhs(1), **part))
    assert "capture_hits" not in grown and grown["captures"] >= 1
    assert len(store) == 2 and len(made) == 2


@pytest.mark.parametrize("spec", ["jacobi", "f32x2"])
def test_a_jacobi_or_double_word_solve_is_not_stored(band, stored, spec):
    store, made = stored
    kw = (dict(variant="pipe_pr_pcg", preconditioner="jacobi")
          if spec == "jacobi" else dict(dtype="f32x2", max_iter=40))
    for i in range(2):
        _, grown = counted(lambda: _solve(band, _rhs(i), **kw))
        assert "capture_hits" not in grown and grown["captures"] >= 1
    assert len(store) == 0 and len(made) == 2


def test_contexts_that_name_no_key(band):
    state = {"x": torch.zeros(N, dtype=torch.float64)}
    jacobi = JacobiPreconditioner.from_operator(band)

    class Own(Context):
        pass

    for ctx in (Context(band, jacobi), Own(band),
                object.__new__(RowShardContext),
                object.__new__(DoubleFloatContext)):
        assert graphs.capture_key(ctx, _double, state, "rows") is None
    assert graphs.capture_key(Context(band), _double, state, "rows")


def test_an_answer_survives_the_next_solve(band, stored):
    for norm_type in NORMS:
        x1 = _solve(band, _rhs(0), norm_type=norm_type).x
        held = x1.clone()
        _solve(band, _rhs(1), norm_type=norm_type)
        assert torch.equal(x1, held), norm_type


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("norm_type", NORMS)
def test_successive_solves_give_the_eager_bits(band, stored, name,
                                               norm_type):
    store, made = stored
    kw = dict(variant=name, norm_type=norm_type,
              max_iter=300 if norm_type == "natural" else 45)
    before = profiling.counters().get("capture_hits", 0)
    for i in range(5):
        b = _rhs(i)
        want = _solve(band, b, use_jit=False, **kw)
        got = _solve(band, b, **kw)
        assert got.iterations == want.iterations, i
        assert got.norm == want.norm and got.converged == want.converged
        assert torch.equal(got.x, want.x), i
    assert profiling.counters()["capture_hits"] - before == 4
    assert len(made) == 1 and len(store) == 1


# --- loops started directly ---------------------------------------------------


def _double(ctx, s):
    return {"x": 2 * s["x"], "k": s["k"] + 1}


def _halve(ctx, s):
    return {"x": s["x"] / 2, "k": s["k"] + 1}


def _rows(key):
    return {"sum": lambda c, s: s["x"].sum()} if key == "sum" else {}


def _start(runner, ctx, step=_double, x=None, rows_key="sum",
           checkpoint=False):
    x = torch.ones(4, dtype=torch.float64) if x is None else x
    return runner.start(ctx, step, {"x": x, "k": 0}, _rows(rows_key),
                        horizon=20, checkpoint=checkpoint, rows_key=rows_key)


def _host_runner(store, chunk=CHUNK):
    return graphs.Runner(HostCapture, chunk=chunk, store=store)


#: a part of the key changed alone: (runner chunk, start keywords, context)
MISSES = {
    "shape": (CHUNK, dict(x=torch.ones(5, dtype=torch.float64)), None),
    "dtype": (CHUNK, dict(x=torch.ones(4, dtype=torch.float32)), None),
    "step": (CHUNK, dict(step=_halve), None),
    "rows": (CHUNK, dict(rows_key="none"), None),
    "chunk": (CHUNK + 1, {}, None),
    "checkpoint": (CHUNK, dict(checkpoint=True), None),
    "operator": (CHUNK, {}, "copy"),
    "compensated": (CHUNK, {}, "compensated"),
}


@pytest.mark.parametrize("part", sorted(MISSES))
def test_a_loop_misses_on_each_key_part(band, part):
    store = graphs.Store()
    chunk, kw, other = MISSES[part]
    ctx = Context(band)
    copy = SymDiaOperator(band.offsets, band.data.clone())
    loop = _start(_host_runner(store), ctx)
    loop.advance(9)
    del loop
    ctx2 = {None: ctx, "copy": Context(copy),
            "compensated": Context(band, compensated=True)}[other]
    _, grown = counted(lambda: _start(_host_runner(store, chunk), ctx2,
                                      **kw).advance(9))
    assert "capture_hits" not in grown and grown["captures"] >= 1
    assert len(store) == 2
    # the first key still hits
    _, grown = counted(lambda: _start(_host_runner(store), ctx).advance(9))
    assert grown["capture_hits"] == 1 and "captures" not in grown


def test_two_live_loops_of_one_key_share_no_buffer(band):
    store = graphs.Store()
    ctx = Context(band)
    one = _start(_host_runner(store), ctx)
    two, grown = counted(lambda: _start(_host_runner(store), ctx))
    assert "capture_hits" not in grown and len(store) == 1
    ptrs = {t.data_ptr() for t in one.bufs}
    assert not ptrs & {t.data_ptr() for t in two.bufs}
    one.advance(8)
    two.advance(3)
    assert torch.equal(one.state()["x"], torch.full((4,), 2.0 ** 9,
                                                   dtype=torch.float64))
    assert torch.equal(two.state()["x"], torch.full((4,), 2.0 ** 4,
                                                   dtype=torch.float64))
    del one, two
    three, grown = counted(lambda: _start(_host_runner(store), ctx))
    assert grown["capture_hits"] == 1
    assert {t.data_ptr() for t in three.bufs} == ptrs


def test_the_store_keeps_at_most_its_bound(band, stored):
    store, made = stored
    ops = [SymDiaOperator(band.offsets, band.data.clone()) for _ in range(6)]
    for op in ops:
        _solve(op, _rhs(0))
    assert len(store) == graphs.STORE_SIZE == 4 and len(made) == 6
    _, grown = counted(lambda: _solve(ops[0], _rhs(0)))  # out: least recent
    assert "capture_hits" not in grown
    _, grown = counted(lambda: _solve(ops[5], _rhs(0)))
    assert grown["capture_hits"] == 1
    assert len(store) == 4


def test_an_entry_goes_with_its_operator(stored, monkeypatch):
    store, _ = stored
    op, _, _ = banded_model(N, k=K, kappa=KAPPA, device="cpu")
    alive = weakref.ref(op)
    _solve(op, _rhs(0))
    assert len(store) == 1
    del op
    gc.collect()
    assert alive() is None and len(store) == 0
    # freed during a capture: kept until the store's next lease
    op, _, _ = banded_model(N, k=K, kappa=KAPPA, device="cpu")
    _solve(op, _rhs(0))
    monkeypatch.setattr(graphs, "_CAPTURING", [1])
    del op
    gc.collect()
    assert len(store) == 1
    monkeypatch.setattr(graphs, "_CAPTURING", [0])
    other, _, _ = banded_model(N, k=K, kappa=KAPPA, device="cpu")
    _solve(other, _rhs(0))
    assert len(store) == 1
    assert next(iter(store._entries))[0][0]() is other


def test_an_ell_solve_in_its_order_hits(stored):
    """An ELL operator in a locality order solves on one inner operator of
    its basis (``solver_basis``), so a second solve finds the first's
    graphs."""
    band, _, _ = banded_model(N, k=K, kappa=KAPPA, fmt="dia", device="cpu")
    val = band.data.T.contiguous()
    idx = (torch.arange(N)[:, None] + torch.tensor(band.offsets)).clamp(0,
                                                                       N - 1)
    val = torch.where((torch.arange(N)[:, None] + torch.tensor(band.offsets)
                       - idx) == 0, val, torch.zeros_like(val))
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(7))
    op = EllOperator(val, idx, N * len(band.offsets), perm=perm)
    assert solver_basis(op)[0] is solver_basis(op)[0]
    store, made = stored
    first = _solve(op, _rhs(0))
    again, grown = counted(lambda: _solve(op, _rhs(0)))
    assert grown["capture_hits"] == 1 and "captures" not in grown
    assert torch.equal(again.x, first.x) and len(made) == 1
    want = _solve(op, _rhs(0), use_jit=False)
    assert again.iterations == want.iterations
    assert torch.equal(again.x, want.x)


def test_an_operator_on_the_current_card_passes_as_itself(monkeypatch):
    """``device="cuda"`` (no index) names the current card: an operator
    already there is not wrapped anew, so its stored graphs are found."""

    class OnCard:
        device, dtype = torch.device("cuda", 1), torch.float32

        def mv(self, v):
            return v

        def diagonal(self):
            return None

        def to(self, device):
            return OnCard()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    op = OnCard()
    assert as_operator(op, device="cuda") is op
    assert as_operator(op, device="cuda:1") is op
    assert as_operator(op, device="cuda:0") is not op


# --- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("norm_type", NORMS)
def test_successive_solves_on_the_card_give_the_eager_bits(card, norm_type):
    op, _, _ = banded_model(65_536, k=8, dtype=np.float32, device=card)
    kw = dict(norm_type=norm_type, rtol=1e-5,
              max_iter=10_000 if norm_type == "natural" else 100)
    solve(op, _rhs(99, 65_536, torch.float32, card), device=card, **kw)
    before = profiling.counters()
    for i in range(5):
        b = _rhs(i, 65_536, torch.float32, card)
        want = solve(op, b, device=card, use_jit=False, **kw)
        got = solve(op, b, device=card, **kw)
        assert got.iterations == want.iterations, i
        assert got.norm == want.norm and got.converged == want.converged
        assert torch.equal(got.x, want.x), i
    after = profiling.counters()
    assert after["capture_hits"] - before.get("capture_hits", 0) == 5


@pytest.mark.card
def test_reserved_memory_stays_flat_over_repeated_solves(card):
    """Solves on the default device (``cuda``, no index) on an operator
    on ``cuda:0``: the operator passes as itself, so each finds the graphs
    stored."""
    op, _, _ = banded_model(65_536, k=8, dtype=np.float32, device=card)
    rhs = [_rhs(i, 65_536, torch.float32, card) for i in range(4)]
    kw = dict(rtol=1e-5, max_iter=10_000)
    _, grown = counted(lambda: solve(op, rhs[0], **kw))
    pool = grown.get("pool_bytes", 0)
    for b in rhs[1:]:  # each stop's single-step graph
        solve(op, b, **kw)

    def repeated():
        for i in range(200):
            solve(op, rhs[i % 4], **kw)  # the answer is dropped
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    start = torch.cuda.memory_reserved(card)
    _, grown = counted(repeated)
    growth = torch.cuda.memory_reserved(card) - start
    print("pool", pool, "growth over 200 solves", growth, "counters", grown)
    assert pool > 0 and growth < pool
    assert grown["capture_hits"] == 200 and "captures" not in grown
