"""Port parity: the full-DIA family entries (hs, pr, cgcg, gv and their Jacobi
twins; the Jacobi pipe step) against the JAX package's Pallas kernels in
interpret mode, as ``tests/test_fused_family.py`` and
``tests/test_fused_full_step.py`` run them (tile 2048).

The port runs the plain PyTorch versions (CPU tensors); both sides in
float64 on inputs from a numpy seed.  Vectors agree to rtol 1e-12 of the
vector's scale, dots to rtol 1e-11 of ``sum |a_i b_i|`` (the JAX kernels sum
the products lane-wise per tile, torch in one pass).  Each entry is also held,
bit for bit, to its family's generic expressions over ``DiaOperator.mv`` at
sizes the JAX kernel does not take (ragged n, n below one tile).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.ops import fused_family as jff
from new_cg_variants_tpu.ops import fused_step as jfs
from new_cg_variants_tpu_torch.ops import fused_family as tff
from new_cg_variants_tpu_torch.ops import fused_step as tfs
from new_cg_variants_tpu_torch.ops.operators import DiaOperator
from test_torch_fused_step import _assert_same, _state, _t
from test_torch_operators import random_dia

A1, BETA = 0.37, 0.12
SC = {"a1": A1, "beta": BETA}

#: entry -> (inputs in order (d: inv_diag), scalars, outputs in return order,
#: dots as pairs of outputs, module pair (JAX, port), keywords)
ENTRIES = {
    "fused_hs_matvec_phase": (
        "r p", "beta", "p2 s2", ("p2 s2",), (jff, tff), {}),
    "fused_pr_full_step": (
        "x r p s", "a1 beta", "x2 r2 p2 s2",
        ("p2 s2", "r2 s2", "s2 s2", "r2 r2"), (jff, tff), {}),
    "fused_cgcg_matvec_phase": (
        "x r p s", "a1", "x2 r2 w2", ("r2 r2", "w2 r2"), (jff, tff), {}),
    "fused_gv_matvec_phase": (
        "x r w u p s", "a1", "x2 r2 w2 t", ("r2 r2", "w2 r2"), (jff, tff), {}),
    "fused_pr_full_step_prec": (
        "d x r p s rt st", "a1 beta", "x2 r2 rt2 p2 s2 st2",
        ("p2 s2", "r2 st2", "st2 s2", "rt2 r2"), (jff, tff), {}),
    "fused_cgcg_matvec_phase_prec": (
        "d x r p s", "a1", "x2 r2 rt2 w2", ("r2 rt2", "w2 rt2"), (jff, tff),
        {}),
    "fused_gv_matvec_phase_prec": (
        "d x r w u p s rt st", "a1", "x2 r2 rt2 w2 wt2 t",
        ("r2 rt2", "w2 rt2"), (jff, tff), {}),
    "fused_pipe_full_step_prec": (
        "d x r w u p s rt st wt ut", "a1 beta",
        "x2 r2 w_out p2 s2 u2 rt2 st2 wt_out ut2",
        ("p2 s2", "r2 st2", "st2 s2", "rt2 r2"), (jfs, tfs),
        {"recompute": True}),
    "fused_pipe_full_step_prec/no recompute": (
        "d x r w u p s rt st wt ut", "a1 beta",
        "x2 r2 w_out p2 s2 u2 rt2 st2 wt_out ut2",
        ("p2 s2", "r2 st2", "st2 s2", "rt2 r2"), (jfs, tfs),
        {"recompute": False}),
}


def _inputs(names, n, seed):
    sv = _state(names, n, seed)
    if "d" in sv:
        sv["d"] = np.random.default_rng(seed + 1).uniform(0.5, 2.0, n)
    return sv


@pytest.mark.parametrize("n,offsets", [
    (4096, tuple(range(-31, 32))),
    (8192, (-3, -1, 0, 2, 7)),
    (4096, (-400, 0, 100)),
], ids=str)
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_matches_jax_kernel(entry, n, offsets):
    ins, scs, outs, dots, (jmod, tmod), kw = ENTRIES[entry]
    names, onames = ins.split(), outs.split()
    data = random_dia(n, offsets, seed=n)
    sv = _inputs(names, n, seed=n + len(names))
    fn = entry.split("/")[0]
    want = getattr(jmod, fn)(
        offsets, jnp.asarray(data), *[jnp.asarray(sv[k]) for k in names],
        *[jnp.asarray(SC[k]) for k in scs.split()], tile=2048, interpret=True,
        **kw)
    got = getattr(tmod, fn)(
        offsets, _t(data), *[_t(sv[k]) for k in names],
        *[SC[k] for k in scs.split()], **kw)
    pairs = [tuple(onames.index(v) for v in pr.split()) for pr in dots]
    _assert_same(got, want, pairs)


def _generic(op, d, v, a1, beta, entry, recompute):
    """The family's generic expressions (``solvers/families.py``) for the
    vectors ``entry`` returns, over ``op.mv``."""
    x2 = v["x"] + a1 * v["p"] if "x" in v else None
    r2 = v["r"] - a1 * v["s"] if "s" in v else None
    if entry == "fused_hs_matvec_phase":
        p2 = v["r"] + beta * v["p"]
        return p2, op.mv(p2)
    if entry == "fused_pr_full_step":
        p2 = r2 + beta * v["p"]
        return x2, r2, p2, op.mv(p2)
    if entry == "fused_cgcg_matvec_phase":
        return x2, r2, op.mv(r2)
    if entry == "fused_gv_matvec_phase":
        w2 = v["w"] - a1 * v["u"]
        return x2, r2, w2, op.mv(w2)
    if entry == "fused_pr_full_step_prec":
        rt2 = v["rt"] - a1 * v["st"]
        p2 = rt2 + beta * v["p"]
        s2 = op.mv(p2)
        return x2, r2, rt2, p2, s2, d * s2
    if entry == "fused_cgcg_matvec_phase_prec":
        rt2 = d * r2
        return x2, r2, rt2, op.mv(rt2)
    if entry == "fused_gv_matvec_phase_prec":
        rt2 = v["rt"] - a1 * v["st"]
        w2 = v["w"] - a1 * v["u"]
        wt2 = d * w2
        return x2, r2, rt2, w2, wt2, op.mv(wt2)
    w2 = v["w"] - a1 * v["u"]
    rt2 = v["rt"] - a1 * v["st"]
    wt2 = v["wt"] - a1 * v["ut"]
    p2 = rt2 + beta * v["p"]
    s2 = w2 + beta * v["s"]
    st2 = wt2 + beta * v["st"]
    if recompute:
        u2, w3 = op.mv2(st2, rt2)
        return x2, r2, w3, p2, s2, u2, rt2, st2, d * w3, d * u2
    u2 = op.mv(st2)
    return x2, r2, w2, p2, s2, u2, rt2, st2, wt2, d * u2


@pytest.mark.parametrize("n,offsets", [
    (4099, tuple(range(-31, 32))),     # ragged n
    (100, tuple(range(-7, 8))),        # n below one tile of either package
    (1000, (-2048, -1, 0, 1, 2048)),   # offsets wider than n
], ids=str)
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_is_the_generic_body(entry, n, offsets):
    """Bit for bit on the CPU: the same torch expressions in the same order."""
    ins, scs, outs, dots, (_, tmod), kw = ENTRIES[entry]
    names, onames = ins.split(), outs.split()
    op = DiaOperator(offsets, _t(random_dia(n, offsets, seed=n)))
    v = {k: _t(a) for k, a in _inputs(names, n, seed=n + 5).items()}
    sc = {k: torch.tensor(val, dtype=torch.float64) for k, val in SC.items()}
    fn = entry.split("/")[0]
    got = getattr(tmod, fn)(offsets, op.data, *[v[k] for k in names],
                            *[sc[k] for k in scs.split()], **kw)
    want = _generic(op, v.get("d"), v, sc["a1"], sc["beta"], fn,
                    kw.get("recompute"))
    assert len(got) == len(onames) + 1 and len(got[-1]) == len(dots)
    for g, w in zip(got[:-1], want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    by_name = dict(zip(onames, want))
    for g, pr in zip(got[-1], dots):
        a, b = (by_name[k] for k in pr.split())
        assert float(g) == float(torch.dot(a, b))


def test_cpu_path_does_not_count_launches_and_mixed_devices_raise():
    n, offsets = 300, (-1, 0, 1)
    data = _t(random_dia(n, offsets, 0))
    wrappers = tff.FUSED_FAMILY_WRAPPERS + (tfs.fused_pipe_full_step_prec,)
    before = [fn.launches for fn in wrappers]
    for entry, (ins, scs, _, _, (_, tmod), kw) in ENTRIES.items():
        v = _inputs(ins.split(), n, seed=0)
        getattr(tmod, entry.split("/")[0])(
            offsets, data, *[_t(v[k]) for k in ins.split()],
            *[SC[k] for k in scs.split()], **kw)
    assert [fn.launches for fn in wrappers] == before
    r, p = (_t(a) for a in _state("r p".split(), n, 0).values())
    meta = torch.empty(n, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="all-CUDA or all-CPU"):
        tff.fused_hs_matvec_phase(offsets, data, meta, p, BETA)
    with pytest.raises(ValueError, match="all-CUDA or all-CPU"):
        tff.fused_hs_matvec_phase(offsets, data.to("meta"), r, p, BETA)
