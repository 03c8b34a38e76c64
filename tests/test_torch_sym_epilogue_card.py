"""The half-band pipe entry with its scalar epilogue on the card
(``sym_fused.fused_sym_pipe_full_step_scalars``, ``csrc/sym_family.cu``:
``Scalars<PipeSpec<R>>``): beta formed in every thread from the previous
state's ``nu``, ``delta``, ``gamma`` and alpha, and the dots summed and
alpha formed by the block that finishes last, in the launch.

Against the torch epilogue on the same step (the same kernel entry without
the epilogue, its partials summed by ``torch.sum``, beta and alpha by
``ops/scalars.py``'s ``predict_nu`` / ``safe_div``), for the four pipe
entries (PR and Meurant prediction, recompute on and off), in float32,
float64 and a bf16 band, at n = 655,360 and a ragged n = 1,000:

* beta and the vectors: the same bits (the formulas are torch's operations
  in torch's order, each rounded on its own, and the update is the entry's
  own code given the same a1 and beta);
* mu, delta, gamma, nu: float64 to 1e-12 relative; float32 (and the bf16
  band, whose vectors are float32) to 64 units of rounding of the sum of
  the terms' magnitudes, since the two sum the partials in different
  orders.  The state is positive (entries in [0.5, 1.5], a1 = 0.1, beta >
  0), so every term is positive and that sum is the dot itself;
* alpha: the torch formula's bits on the kernel's own dots;
* the vectors against the plain version to a few units of rounding (the
  kernel contracts the updates into fused multiply-adds);
* two launches on one stream give the same bits, and leave the stream's
  ticket counter at 0.

And ``solve(pipe_pr_cg, norm_type="none", max_iter=4000)`` on the cell
``petsc_banded_k32.fixed4000``'s problem takes the epilogue on every step
(``scalar_epilogues.kernel``, never ``.torch``) and stays within the cell's
limits (``h100_bench/limits/petsc_banded_k32.fixed4000.json``).

Marker ``card``; on the card ``python -m pytest
tests/test_torch_sym_epilogue_card.py -m card --noconftest -q -s`` (``-s``
prints the readings).  Without a card every test skips.
"""

from pathlib import Path

import pytest
import torch

from new_cg_variants_tpu_torch import solve
from new_cg_variants_tpu_torch.ops import _kernels
from new_cg_variants_tpu_torch.ops import sym_fused as sf
from new_cg_variants_tpu_torch.ops.scalars import predict_nu, safe_div
from new_cg_variants_tpu_torch.ops.sym_dia import _mv_plain
from new_cg_variants_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "petsc_banded_k32.fixed4000"
SEED = 2**31 + 41
RHS = 2
K = 32
#: band storage -> vectors' dtype
STORAGE = {"float32": (torch.float32, torch.float32),
           "float64": (torch.float64, torch.float64),
           "bfloat16": (torch.bfloat16, torch.float32)}
#: the previous state: nu, delta, gamma, alpha (a1 gamma^2 large enough that
#: Meurant's prediction, -nu + a1^2 gamma, is positive too)
PREV = (1.0, 1.0, 150.0, 0.1)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _problem(card, storage, n, seed):
    sdt, vdt = STORAGE[storage]
    gen = torch.Generator(device=card).manual_seed(seed)
    data = torch.rand(K, n, dtype=torch.float64, device=card, generator=gen)
    data[0] += 2.0 * K
    for d in range(1, K):
        data[d, n - d:] = 0.0
    vecs = [0.5 + torch.rand(n, dtype=vdt, device=card, generator=gen)
            for _ in range(6)]
    prev = [torch.tensor(v, dtype=vdt, device=card) for v in PREV]
    return tuple(range(K)), data.to(sdt), vecs, prev


def _torch_epilogue(offsets, data, vecs, prev, meurant, recompute):
    """The step as the torch path runs it: beta by torch, the entry without
    the epilogue, alpha by torch."""
    nu, delta, gamma, a1 = prev
    beta = safe_div(predict_nu(nu, delta, gamma, a1, meurant), nu)
    *out, dots = sf.fused_sym_pipe_full_step(offsets, data, *vecs, a1, beta,
                                             recompute=recompute)
    return (*out, dots, safe_div(dots[3], dots[0]), beta)


@pytest.mark.card
@pytest.mark.parametrize("recompute", [True, False])
@pytest.mark.parametrize("meurant", [False, True])
@pytest.mark.parametrize("n", [655_360, 1000])
@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_the_epilogue_against_the_torch_epilogue(card, storage, n, meurant,
                                                 recompute):
    offsets, data, vecs, prev = _problem(card, storage, n, n + meurant)
    vdt = vecs[0].dtype
    eps = torch.finfo(vdt).eps
    launches = (sf.fused_sym_pipe_full_step_scalars.launches,
                sf.fused_sym_pipe_full_step.launches)
    got = sf.fused_sym_pipe_full_step_scalars(
        offsets, data, *vecs, *prev, meurant=meurant, recompute=recompute)
    # one launch, counted on its own wrapper, none on the entry without it
    assert (sf.fused_sym_pipe_full_step_scalars.launches,
            sf.fused_sym_pipe_full_step.launches) == (launches[0] + 1,
                                                      launches[1])
    want = _torch_epilogue(offsets, data, vecs, prev, meurant, recompute)
    assert torch.equal(got[8], want[8]), (float(got[8]), float(want[8]))
    assert float(got[8]) > 0
    for k in range(6):
        assert torch.equal(got[k], want[k]), k
    for k, (g, w) in enumerate(zip(got[6], want[6])):
        g, w = float(g), float(w)
        rel = abs(g - w) / abs(w)
        print(f"{storage} n={n} meurant={meurant} recompute={recompute} "
              f"dot {k}: epilogue {g!r} torch {w!r} rel {rel:.3e}")
        assert w > 0 and rel <= (1e-12 if vdt == torch.float64
                                 else 64 * eps), (k, g, w)
    mu, _, _, nu = got[6]
    assert torch.equal(got[7], safe_div(nu, mu))
    assert abs(float(got[7]) - float(want[7])) <= 4 * (
        1e-12 if vdt == torch.float64 else 64 * eps) * float(want[7])
    # the plain version, on the card's tensors (the band widened as the
    # kernel widens it)
    plain = sf._pipe_step_scalars_plain(
        offsets, data.to(vdt), *vecs, *prev, meurant, recompute,
        mv=_mv_plain)
    assert torch.equal(plain[8], got[8])
    for k in range(6):
        scale = 8.0 * K if k in (2, 5) and (k == 5 or recompute) else 4.0
        err = float((got[k] - plain[k]).abs().max())
        assert err <= 8 * eps * scale * float(plain[k].abs().max()), k


@pytest.mark.card
@pytest.mark.parametrize("storage", sorted(STORAGE))
def test_two_launches_repeat_their_bits(card, storage):
    offsets, data, vecs, prev = _problem(card, storage, 655_360, 7)
    runs = [sf.fused_sym_pipe_full_step_scalars(
        offsets, data, *vecs, *prev, meurant=False, recompute=True)
        for _ in range(2)]
    first, second = runs
    for a, b in zip(first[:6] + first[7:], second[:6] + second[7:]):
        assert torch.equal(a, b)
    for a, b in zip(first[6], second[6]):
        assert torch.equal(a, b)
    stream = torch.cuda.current_stream(card)
    assert int(_kernels.tickets(card, stream).item()) == 0


def _grown(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if k.startswith("scalar_epilogues.")
                 and v != before.get(k, 0)}


@pytest.mark.card
def test_the_cells_solve_within_its_limits(card):
    from h100_bench import traffic
    from h100_bench.harness import judge
    from h100_bench.spec import Cell

    cell = Cell(ROOT, CELL)
    cfg, mix = cell.config, cell.mix
    problem, reference = cell.problem(), cell.reference()
    n = problem.size(cfg)
    op = problem.program_operator(cfg, problem.program_input(cfg, card),
                                  card)
    pool = traffic.rhs_pool(SEED, n, RHS, reference.matvec(cfg, card),
                            problem.dtype(cfg), card)
    kw = dict(variant=mix["variant"], norm_type=mix["norm_type"],
              max_iter=mix["max_iter"], device=card)
    results, grown = _grown(lambda: [solve(op, pool[i], **kw)
                                     for i in range(RHS)])
    assert grown.get("scalar_epilogues.kernel", 0) > 0
    assert "scalar_epilogues.torch" not in grown
    recs = [{"i": i, "iterations": int(r.iterations),
             "converged": bool(r.converged)} for i, r in enumerate(results)]
    checks, bad, correct = judge(cell, reference, SEED, recs,
                                 {i: r.x for i, r in enumerate(results)}, n,
                                 RHS, card)
    print(f"{CELL} checks {checks}")
    assert correct and not bad, checks
