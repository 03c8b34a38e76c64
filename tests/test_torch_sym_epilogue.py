"""The pipe step's scalar epilogue in the half-band entry, on the CPU.

``Context.pipe_full_step`` hands the unpreconditioned pipe step on
half-band storage to ``sym_fused.fused_sym_pipe_full_step_scalars``, which
forms beta (from the predicted nu), the step and alpha in the kernel's one
launch on the card and in its plain version here.  These hold:

* the plain version gives the state the torch path gives (the context's
  hook declined, so the family forms the scalars with torch), every key
  bit for bit, over several steps, for PR and Meurant prediction with and
  without recompute, in float64 and float32;
* which path formed a step's scalars is counted (``scalar_epilogues.kernel``
  or ``.torch``, ``utils/profiling.py``) once a step: the half-band takes
  the kernel's; an ELL operator's generic body, full DIA, compensated dots,
  Jacobi and double words take torch's;
* the wrapper refuses vectors and a band on different devices.

The kernel itself is held to this plain version on the card
(``tests/test_torch_sym_epilogue_card.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops import sym_fused
from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy, from_coo
from new_cg_variants_tpu_torch.solvers.context import Context
from new_cg_variants_tpu_torch.solvers.families import FAMILIES
from new_cg_variants_tpu_torch.utils import profiling

N, K = 1000, 8
STEPS = 6
KEYS = {"x", "r", "p", "s", "w", "u", "nu", "mu", "delta", "gamma", "a",
        "a1", "a2", "b", "b1", "k"}


def _grown(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()
                 if k.startswith("scalar_epilogues.")
                 and v != before.get(k, 0)}


def _band(dtype):
    op, b, _ = port.banded_model(N, k=K, kappa=1e3, device="cpu")
    return op.astype(dtype), torch.as_tensor(b, dtype=dtype)


def _steps(ctx, family, b):
    init, step = FAMILIES[family]
    state = init(ctx, b, torch.zeros_like(b))
    states = []
    for _ in range(STEPS):
        state = step(ctx, state)
        states.append(state)
    return states


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("family", ["pipe_pr", "pipe_p", "pipe_pr_m",
                                    "pipe_p_m"])
def test_the_plain_epilogue_gives_the_torch_paths_state(family, dtype,
                                                        monkeypatch):
    op, b = _band(dtype)
    got, grown = _grown(lambda: _steps(Context(op), family, b))
    assert grown == {"scalar_epilogues.kernel": STEPS}
    monkeypatch.setattr(Context, "pipe_full_step",
                        lambda self, s_, meurant, recompute: None)
    want, grown = _grown(lambda: _steps(Context(op), family, b))
    assert grown == {"scalar_epilogues.torch": STEPS}
    for g, w in zip(got, want):
        assert set(g) == set(w) == KEYS
        for key in KEYS - {"k"}:
            assert g[key].dtype == dtype and torch.equal(g[key], w[key]), key
        assert g["k"] == w["k"]
    assert float(got[-1]["b"]) != 0 and float(got[-1]["a"]) != 0


@pytest.mark.parametrize("meurant", [False, True])
@pytest.mark.parametrize("recompute", [True, False])
def test_the_wrapper_returns_the_entry_and_its_scalars(meurant, recompute):
    """The plain version: the entry's outputs for ``beta`` formed from the
    previous scalars, then alpha of its dots."""
    op, b = _band(torch.float64)
    rng = np.random.default_rng(3)
    vecs = [torch.from_numpy(rng.standard_normal(N)) for _ in range(6)]
    prev = [torch.tensor(v, dtype=torch.float64)
            for v in (2.0, 0.5, 3.0, 0.25)]
    got = sym_fused.fused_sym_pipe_full_step_scalars(
        op.offsets, op.data, *vecs, *prev, meurant=meurant,
        recompute=recompute)
    nu, delta, gamma, a1 = prev
    pred = -nu + a1 * a1 * gamma if meurant else (
        nu - 2.0 * a1 * delta + a1 * a1 * gamma)
    beta = pred / nu
    want = sym_fused.fused_sym_pipe_full_step(
        op.offsets, op.data, *vecs, a1, beta, recompute=recompute)
    assert len(got) == 9 and torch.equal(got[8], beta)
    for g, w in zip(got[:6], want[:6]):
        assert torch.equal(g, w)
    for g, w in zip(got[6], want[6]):
        assert torch.equal(g, w)
    mu, _, _, nu2 = want[6]
    assert torch.equal(got[7], nu2 / mu)


def test_a_zero_nu_gives_a_zero_beta():
    op, _ = _band(torch.float64)
    vecs = [torch.ones(N, dtype=torch.float64) for _ in range(6)]
    zero = torch.tensor(0.0, dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    got = sym_fused.fused_sym_pipe_full_step_scalars(
        op.offsets, op.data, *vecs, zero, one, one, one, meurant=False)
    assert float(got[8]) == 0.0 and not torch.signbit(got[8])


def _ell():
    import scipy.sparse as sp

    grid = 6
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(grid, grid))
    a = (27.0 * sp.identity(grid ** 3) - sp.kron(sp.kron(t, t), t)).tocsr()
    p = np.random.default_rng(5).permutation(grid ** 3)
    op = from_coo(coo_from_scipy(a[p][:, p].tocsr()), fmt="ell",
                  dtype=torch.float64, device="cpu")
    return op, op.mv(torch.ones(op.n, dtype=torch.float64))


@pytest.mark.parametrize("name", ["pipe_pr_cg", "pipe_p_m_cg"])
def test_a_generic_body_step_counts_torch(name):
    """An ELL operator's pipe step (the split formulation over the vector
    phase and row 12's product) forms its scalars with torch."""
    op, b = _ell()
    assert isinstance(op, port.EllOperator)
    assert Context(op).pipe_full_step({}, False, True) is None
    res, grown = _grown(lambda: port.solve(
        op, b, variant=name, max_iter=STEPS, norm_type="none",
        device="cpu"))
    assert res.iterations == STEPS
    assert grown == {"scalar_epilogues.torch": STEPS}


@pytest.mark.parametrize("config", ["full_dia", "compensated", "jacobi",
                                    "f32x2"])
def test_other_routes_count_torch(config):
    """Full DIA (row 6's entry without an epilogue), compensated dots, the
    Jacobi twin and double words: the scalars stay torch's."""
    op, b = _band(torch.float64)
    kw = dict(variant="pipe_pr_cg", max_iter=STEPS, norm_type="none",
              device="cpu")
    if config == "full_dia":
        offsets, data = op.todia_host()
        op = port.DiaOperator(offsets, torch.from_numpy(data))
    elif config == "compensated":
        kw["compensated"] = True
    elif config == "jacobi":
        kw.update(variant="pipe_pr_pcg", preconditioner="jacobi")
    else:
        kw["dtype"] = "f32x2"
    res, grown = _grown(lambda: port.solve(op, b.numpy(), **kw))
    assert res.iterations == STEPS
    assert grown == {"scalar_epilogues.torch": STEPS}


def test_mixed_devices_raise():
    op, _ = _band(torch.float64)
    meta = [torch.empty(N, dtype=torch.float64, device="meta")] * 6
    one = torch.tensor(1.0, dtype=torch.float64)
    with pytest.raises(ValueError):
        sym_fused.fused_sym_pipe_full_step_scalars(
            op.offsets, op.data, *meta, one, one, one, one, meurant=False)
