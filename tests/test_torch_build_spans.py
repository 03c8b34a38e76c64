"""The operator build's spans and the solver basis's counter
(``ops/operators.py``, ``ops/block_banded.py``, ``utils/profiling.py``) on
the CPU.

* Under a CPU ``torch.profiler``, a build that takes the ELL route from
  ``fmt="auto"`` opens ``format``, ``rcm`` and ``ell.pack`` once each,
  inside ``build``; ``format`` and ``rcm`` do not overlap.
* ``rcm`` is counted once a COO: the format policy and the ELL order share
  the memoised probe.
* ``basis_moves`` grows by 3 a solve on ELL in RCM order or on a
  block-banded operator (``b`` and ``x0`` in, ``x`` out), and by 0 on a
  ``SymDiaOperator``, whose solve opens none of the new spans.
* A solve gives the same bits with the profiler on and off.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from new_cg_variants_tpu_torch import banded_model
from new_cg_variants_tpu_torch.ops import operators
from new_cg_variants_tpu_torch.ops.block_banded import (
    PermutedBlockBandedOperator,
)
from new_cg_variants_tpu_torch.ops.operators import (
    EllOperator,
    coo_from_scipy,
    from_coo,
)
from new_cg_variants_tpu_torch.solvers import api
from new_cg_variants_tpu_torch.utils import profiling

NEW_SPANS = ("format", "rcm", "ell.pack", "basis")


def _laplacian(side=24, seed=5):
    """The 5-point Laplacian on a ``side^2`` grid (n = 576 > the dense
    route's 512) under one random numbering: hundreds of occupied
    diagonals, so the auto route probes RCM."""
    one = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(side, side))
    a = sp.kronsum(one, one).tocsr()
    p = np.random.default_rng(seed).permutation(a.shape[0])
    return coo_from_scipy(a[p][:, p])


def _ell_route(monkeypatch):
    """``choose_format`` admitting no block-banded packing, so that
    ``fmt="auto"`` takes ELL at this size as at HPCG 104^3."""
    real = operators.choose_format
    monkeypatch.setattr(operators, "choose_format",
                        lambda coo, *a, **kw: real(coo, *a,
                                                   max_padded_values=0, **kw))


def _grown(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}


def _host_events(prof, names):
    return [e for e in prof.events()
            if e.name in names and e.device_type == DeviceType.CPU]


def test_build_spans_nest_in_build(monkeypatch):
    _ell_route(monkeypatch)
    coo = _laplacian()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the ELL fallback's warning
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            op, grown = _grown(lambda: from_coo(coo, device="cpu"))
    assert isinstance(op, EllOperator) and op.perm is not None
    events = _host_events(prof, ("build", "format", "rcm", "ell.pack"))
    by_name = {n: [e for e in events if e.name == n]
               for n in ("build", "format", "rcm", "ell.pack")}
    assert {n: len(v) for n, v in by_name.items()} == {
        "build": 1, "format": 1, "rcm": 1, "ell.pack": 1}
    build = by_name["build"][0]
    for name in ("format", "rcm", "ell.pack"):
        e = by_name[name][0]
        parent = e.cpu_parent
        while parent is not None and parent.name != "build":
            parent = parent.cpu_parent
        assert parent is build, name
        assert build.time_range.start <= e.time_range.start
        assert e.time_range.end <= build.time_range.end
    fmt, rcm = by_name["format"][0], by_name["rcm"][0]
    assert (fmt.time_range.end <= rcm.time_range.start
            or rcm.time_range.end <= fmt.time_range.start)
    assert grown["format"] == grown["rcm"] == grown["ell.pack"] == 1
    for name in ("format_s", "rcm_s", "ell.pack_s"):
        assert grown[name] > 0


def test_rcm_is_counted_once_a_coo(monkeypatch):
    _ell_route(monkeypatch)
    coo = _laplacian()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, auto = _grown(lambda: from_coo(coo, device="cpu"))
    # the auto route's probe and ``ell_order`` share the memoised result
    assert auto["rcm"] == 1
    _, again = _grown(lambda: from_coo(coo, fmt="ell", device="cpu"))
    assert "rcm" not in again and again["ell.pack"] == 1
    _, other = _grown(lambda: from_coo(_laplacian(seed=6), fmt="ell",
                                       device="cpu"))
    assert other["rcm"] == 1 and "format" not in other


@pytest.fixture(scope="module")
def ordered_ops():
    """The Laplacian as ELL in RCM order and block-banded, float32, with a
    right-hand side."""
    coo = _laplacian()
    ell = from_coo(coo, fmt="ell", dtype=torch.float32, device="cpu")
    banded = from_coo(coo, fmt="block_banded", dtype=torch.float32,
                      device="cpu")
    assert ell.perm is not None
    assert isinstance(banded, PermutedBlockBandedOperator)
    b = torch.from_numpy(
        np.random.default_rng(1).standard_normal(coo.shape[0])).float()
    return ell, banded, b


@pytest.mark.parametrize("which", ["ell", "block_banded"])
@pytest.mark.parametrize("norm_type", ["none", "natural"])
def test_a_solve_in_a_reordered_basis_moves_three(ordered_ops, which,
                                                  norm_type):
    ell, banded, b = ordered_ops
    op = ell if which == "ell" else banded
    for _ in range(2):
        res, grown = _grown(lambda: api.solve(
            op, b, variant="pipe_pr_cg", norm_type=norm_type, max_iter=20,
            device="cpu"))
        assert grown["basis_moves"] == 3 and grown["solves"] == 1
        assert grown["basis_s"] > 0
    assert res.iterations == 20 or norm_type != "none"


def test_the_band_path_moves_nothing_and_opens_no_new_span():
    op, b, _ = banded_model(2048, k=4, dtype=np.float32, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, grown = _grown(lambda: api.solve(
            op, b, norm_type="none", max_iter=20, device="cpu"))
    assert res.iterations == 20 and grown["solves"] == 1
    assert "basis_moves" not in grown
    assert _host_events(prof, NEW_SPANS) == []
    assert _host_events(prof, ("solve",))


@pytest.mark.parametrize("which", ["ell", "block_banded"])
def test_the_same_bits_with_the_profiler_on(ordered_ops, which):
    ell, banded, b = ordered_ops
    op = ell if which == "ell" else banded

    def solve():
        return api.solve(op, b, variant="pipe_pr_cg", rtol=1e-6,
                         max_iter=200, device="cpu")

    off = solve()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on, grown = _grown(solve)
    assert torch.equal(on.x, off.x) and on.iterations == off.iterations
    assert len(_host_events(prof, ("basis",))) == grown["basis_moves"] == 3
