"""The pipe vector phase of the generic body on the card: the one-pass
kernel (``csrc/pipe_vector.cu``) in place of the torch updates and dots.

``Context.pipe_vector_phase`` sends every uncompensated context whose
vectors the kernel takes to ``fused_step.fused_pipe_vector_phase``; on the
card that is the kernel, whose four dots are its per-block partials summed,
where the generic body's are four ``torch.dot``.  The CPU tests
(``tests/test_torch_dia_variants.py``) hold the route and its bits; these
hold the kernel's arithmetic against the generic body's, on HPCG's
27-point operator under the benchmark's random numbering, as ELL in its
RCM basis (``from_coo(fmt="ell")``, the cell ``hpcg_27pt_104_perm.fixed50``'s
path), at 32^3 (n a multiple of the kernel's 256-row tile) and 31^3 (not),
in float32 and float64:

* the kernel alone against ``generic_pipe_vector_phase`` on the same
  vectors: the five vectors to a few units in the last place, the dots to
  the rounding of two summation orders;
* ``solve(pipe_pr_cg, norm_type="none", max_iter=50)`` through the route
  (captured, as the benchmark runs it) against the same solve with the
  generic body (``use_jit=False``: the card's store of captured loops would
  otherwise replay the route's graphs): the same iteration count, ``x``
  within 1e3 units of rounding, and the cell's own checks (``iterations``,
  ``residual``, ``cg_gap``) at a tenth of their limits.

Marker ``card``; on the card ``python -m pytest
tests/test_torch_vector_route_card.py -m card --noconftest -q -s`` (``-s``
prints the readings).  Without a card every test skips.
"""

import math
from pathlib import Path

import pytest
import torch

from new_cg_variants_tpu_torch import solve
from new_cg_variants_tpu_torch.ops import fused_step
from new_cg_variants_tpu_torch.ops.operators import (
    EllOperator,
    coo_from_scipy,
    from_coo,
)
from new_cg_variants_tpu_torch.solvers import context
from new_cg_variants_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "hpcg_27pt_104_perm.fixed50"
SEED = 2**31 + 23
RHS = 3
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _cell(grid, dtype):
    from h100_bench.spec import Cell

    cell = Cell(ROOT, CELL)
    cell.config = dict(cell.config, grid=grid, dtype=dtype)
    return cell


def _operator(cell, card):
    coo = coo_from_scipy(cell.problem().csr(cell.config))
    op = from_coo(coo, fmt="ell", dtype=DTYPES[cell.config["dtype"]],
                  device=card)
    assert isinstance(op, EllOperator) and op.perm is not None
    return op


def _grown(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if k.startswith("vector_phases.") and v != before.get(k, 0)}


@pytest.mark.card
@pytest.mark.parametrize("grid", [32, 31])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_kernel_against_the_generic_body(card, grid, dtype):
    n = grid ** 3
    tdt = DTYPES[dtype]
    eps = torch.finfo(tdt).eps
    gen = torch.Generator(device=card).manual_seed(grid)
    vecs = [torch.randn(n, dtype=tdt, device=card, generator=gen)
            for _ in range(6)]
    a1 = torch.tensor(0.37, dtype=tdt, device=card)
    beta = torch.tensor(0.81, dtype=tdt, device=card)
    launches = fused_step.fused_pipe_vector_phase.launches
    *got, got_dots = fused_step.fused_pipe_vector_phase(*vecs, a1, beta)
    assert fused_step.fused_pipe_vector_phase.launches == launches + 1
    *want, want_dots = context.generic_pipe_vector_phase(
        context.Context(None), *vecs, a1, beta)
    # each output is two or three fused multiply-adds of O(1) terms
    scale = max(float(v.abs().max()) for v in vecs) * 4.0
    for k, (g, w) in enumerate(zip(got, want)):
        err = float((g - w).abs().max())
        assert err <= 8 * eps * scale, (k, err)
    pairs = ((want[3], want[4]), (want[1], want[4]), (want[4], want[4]),
             (want[1], want[1]))
    for k, (g, w, (a, b)) in enumerate(zip(got_dots, want_dots, pairs)):
        mass = float((a.double() * b.double()).abs().sum())
        err = abs(float(g) - float(w))
        print(f"{dtype} n={n} dot {k}: kernel {float(g)!r} generic "
              f"{float(w)!r} |diff| / sum|ab| {err / mass:.3e}")
        assert err <= 64 * eps * mass, (k, err, mass)


@pytest.mark.card
@pytest.mark.parametrize("grid", [32, 31])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_the_route_solves_as_the_generic_body(card, grid, dtype,
                                               monkeypatch):
    from h100_bench import traffic
    from h100_bench.harness import judge

    cell = _cell(grid, dtype)
    op = _operator(cell, card)
    mix = cell.mix
    kw = dict(variant=mix["variant"], norm_type=mix["norm_type"],
              max_iter=mix["max_iter"], device=card)
    n = grid ** 3
    reference = cell.reference()
    pool = traffic.rhs_pool(SEED, n, RHS, reference.matvec(cell.config, card),
                            DTYPES[dtype], card)
    routed, grown = _grown(lambda: [solve(op, pool[i], **kw)
                                    for i in range(RHS)])
    assert grown.get("vector_phases.kernel", 0) > 0
    assert "vector_phases.generic" not in grown
    monkeypatch.setattr(context.Context, "pipe_vector_phase",
                        context.generic_pipe_vector_phase)
    generic, grown = _grown(lambda: [solve(op, pool[i], use_jit=False, **kw)
                                     for i in range(RHS)])
    assert not grown
    tol = 1e3 * torch.finfo(DTYPES[dtype]).eps
    for i, (r, g) in enumerate(zip(routed, generic)):
        assert r.iterations == g.iterations == mix["max_iter"]
        gap = float(torch.linalg.vector_norm((r.x - g.x).double())
                    / torch.linalg.vector_norm(g.x.double()))
        print(f"{dtype} n={n} rhs {i}: ||x_route - x_generic|| / "
              f"||x_generic|| {gap:.3e}")
        assert gap <= tol, (i, gap)
    recs = [{"i": i, "iterations": int(r.iterations),
             "converged": bool(r.converged)} for i, r in enumerate(routed)]
    checks, bad, correct = judge(cell, reference, SEED, recs,
                                 {i: r.x for i, r in enumerate(routed)}, n,
                                 RHS, card)
    print(f"{dtype} n={n} checks {checks}")
    assert correct and not bad, checks
    for name in ("residual", "cg_gap"):
        value, limit = checks[name]["value"], checks[name]["limit"]
        assert math.isfinite(value) and value <= limit / 10, (name, checks)
