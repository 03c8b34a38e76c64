"""The port's double-word row context (``DFRowShardContext``) against the
JAX package's distributed f32x2 mode, on gloo groups of 1, 2 and 4 ranks.

Groups, references and the deadline as
``test_torch_distributed_formats.py``.  Wall time of the file 53-55 s
alone, 86 s in the whole run under ``-n 6``, nearly all of it the JAX
package's nine double-word runs, one after another (2-5 s each, a second
call as long as the first; narrow bands keep them short).

Held, over 25 iterations (26 rows):

* ``dist_run(dtype="f32x2")``'s collapsed nu and alpha histories (as
  ``test_torch_df_variants.py`` holds the single-device mode) against JAX's
  at the same mesh size, rtol 1e-10 (these runs stay above the double-word
  floor), and against the port's single-device f32x2 ``run``, rtol 1e-10
  (at one rank the same bits: the dots' cross-rank tree has one leaf):
  pipe_pr_cg on ``banded_model(1024, k=3)`` in DIA, hs_cg on its half-band (expanded on
  the host), pipe_pr_pcg with Jacobi on the scaled band of
  ``torch_dist_worker.scaled_band``; the final ``x`` (float64 ``hi + lo``)
  against the single-device run's;
* ``dist_solve(dtype="f32x2")``'s forward error on the half-band input;
* the collectives per iteration of every name at 2 and 4 ranks: one
  all-gather a sync phase (hs 2, every other family 1), no all-reduce, one
  halo exchange a product carrying both words; in the gv and pipe families
  the gather started before the halo;
* the overlapped pipe step against the split formulation, exactly;
* what raises before any process group is made: ``partition="col"``,
  ``compensated=True``, ``col_packed=False``, a replacement hook, a
  preconditioner other than Jacobi, an operator no DIA band holds.
"""

import numpy as np
import pytest
import torch

import torch_dist_groups as groups_
import torch_dist_worker as worker
from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops.operators import DiaOperator as JaxDia
from new_cg_variants_tpu.parallel import dist_run as jax_dist_run
from new_cg_variants_tpu.parallel import make_mesh as jax_make_mesh
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch import parallel

WORLDS = (1, 2, 4)
ITERS = 26
RTOL = 1e-10
DEADLINE_S = 240
MODEL = ("banded", 1024, 3, 1e4)
SCALED = ("scaled", 1024, 3)
DF = {"dtype": "f32x2"}
#: run key -> (variant, problem, fmt, keyword arguments)
HISTORIES = {
    "dia": ("pipe_pr_cg", MODEL, "dia", DF),
    "half-band input": ("hs_cg", MODEL, "symdia", DF),
    "jacobi": ("pipe_pr_pcg", SCALED, "dia",
               dict(DF, preconditioner="jacobi")),
}
PROBES = ("nu", "alpha")
SOLVE = ("banded", 1024, 3, 1e4)
COUNT_STEPS = 3
SYNCS = {"hs": 2, "cg": 1, "gv": 1, "pr": 1, "m": 1, "pipe_p": 1,
         "pipe_pr": 1, "pipe_p_m": 1, "pipe_pr_m": 1}
OVERLAPPED = ("gv", "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")


def cases(world):
    out = [dict(key=("run", key), kind="run", fmt=fmt, variant=name,
                problem=prob, kw=dict(max_iter=ITERS, probes=PROBES, **kw))
           for key, (name, prob, fmt, kw) in HISTORIES.items()]
    out.append(dict(key=("solve",), kind="solve", fmt="symdia",
                    problem=SOLVE, kw=dict(variant="pipe_pr_cg", rtol=1e-10,
                                           max_iter=3000, dtype="f32x2")))
    out.append(dict(key=("split",), kind="split", fmt="dia",
                    variant="pipe_pr_cg", problem=MODEL, kw=DF))
    if world > 1:
        for name in port.VARIANT_NAMES:
            prob = SCALED if name.endswith("pcg") else MODEL
            out.append(dict(key=("counts", name), kind="counts", fmt="dia",
                            variant=name, problem=prob, kw=DF,
                            steps=COUNT_STEPS))
    return out


def _jax_op(prob, fmt):
    if prob[0] == "banded":
        _, n, k, kappa = prob
        return jax_banded(n, k=k, kappa=kappa, fmt=fmt)[0]
    op, _ = worker.problem(prob, "dia")
    return JaxDia(op.offsets, op.data.numpy())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_f32x2")
    groups = {world: groups_.start(world, tmp, cases(world))
              for world in WORLDS}
    try:
        jax_out, single = {}, {}
        for key, (name, prob, fmt, kw) in HISTORIES.items():
            jop = _jax_op(prob, fmt)
            top, tb = worker.problem(prob, fmt)
            single[key] = port.run(name, top, tb, max_iter=ITERS,
                                   probes=PROBES, device="cpu", **kw)
            for world in WORLDS:
                jax_out[world, key] = jax_dist_run(
                    name, jop, tb, mesh=jax_make_mesh(world), max_iter=ITERS,
                    probes=PROBES, **kw)
        results = groups_.join(groups, DEADLINE_S)
    finally:
        groups_.kill(groups)
    return dict(port=results, jax=jax_out, single=single)


def _result(runs, world, key):
    return groups_.result(runs["port"], world, key)


@pytest.mark.parametrize("key", list(HISTORIES))
@pytest.mark.parametrize("world", WORLDS)
def test_f32x2_dist_run_matches_jax(runs, world, key):
    got = _result(runs, world, ("run", key))
    want = runs["jax"][world, key]
    nu = np.asarray(want["nu"])
    assert nu[-1] / nu[0] > 1e-12  # above the double-word floor
    for p in PROBES:
        assert got[p].shape == (ITERS,) and got[p].dtype == np.float32
        np.testing.assert_allclose(got[p], np.asarray(want[p]), rtol=RTOL)


@pytest.mark.parametrize("key", list(HISTORIES))
@pytest.mark.parametrize("world", WORLDS)
def test_f32x2_dist_run_matches_single_device(runs, world, key):
    got = _result(runs, world, ("run", key))
    want = runs["single"][key]
    for p in PROBES:
        if world == 1:
            np.testing.assert_array_equal(got[p], want[p])
        np.testing.assert_allclose(got[p], want[p], rtol=RTOL)
    x = want["x"].numpy()
    assert got["x"].dtype == np.float64
    np.testing.assert_allclose(got["x"], x, rtol=1e-9,
                               atol=1e-12 * np.abs(x).max())


@pytest.mark.parametrize("world", WORLDS)
def test_f32x2_dist_solve_forward_error(runs, world):
    got = _result(runs, world, ("solve",))
    _, n, k, kappa = SOLVE
    _, _, x_true = jax_banded(n, k=k, kappa=kappa)
    assert got["converged"]
    # rtol 1e-10 at kappa 1e4: ~1e-6 (the JAX package's own test: < 1e-4)
    assert np.linalg.norm(got["x"] - x_true) < 1e-5


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
@pytest.mark.parametrize("world", (2, 4))
def test_f32x2_collectives_per_iteration(runs, world, name):
    steps = _result(runs, world, ("counts", name))
    family = name.rsplit("_", 1)[0]
    assert len(steps) == COUNT_STEPS
    for step in steps:
        assert step["all_gather"] == SYNCS[family], step
        assert step["all_reduce"] == step["reduce_scatter"] == \
            step["index_exchange"] == 0, step
        assert step["halo"] == 1 and step["order"].count("halo") == 1, step
        if family in OVERLAPPED:
            assert step["order"] == ["all_gather async", "halo"], step


@pytest.mark.parametrize("world", WORLDS)
def test_f32x2_overlapped_pipe_step_equals_the_split_formulation(runs,
                                                                world):
    assert _result(runs, world, ("split",)) == 0.0


@pytest.mark.parametrize("entry", ["dist_run", "dist_solve"])
@pytest.mark.parametrize("knob", ["partition col", "compensated",
                                  "col_packed", "w_replace", "preconditioner",
                                  "ell"])
def test_f32x2_refusals_raise_before_a_process_group(knob, entry):
    import torch.distributed as dist

    op, b, _ = port.banded_model(64, k=3, kappa=100.0, fmt="dia",
                                 device="cpu")
    kw, variant, want = dict(dtype="f32x2", device="cpu"), "pipe_pr_cg", \
        NotImplementedError
    if knob == "partition col":
        kw["partition"] = "col"
    elif knob == "compensated":
        kw["compensated"] = True
    elif knob == "col_packed":
        kw["col_packed"] = False
    elif knob == "w_replace":
        variant, kw["w_replace"] = "gv_cg", lambda k, view: False
    elif knob == "preconditioner":
        variant, kw["preconditioner"] = "pipe_pr_pcg", lambda v: v
    else:
        op = port.from_coo(port.ops.operators.coo_from_scipy(op.tocsr()),
                           fmt="ell", device="cpu")
        want = TypeError
    if entry == "dist_solve" and knob == "w_replace":
        kw.pop("w_replace")  # dist_solve takes no hook: refuse its knob
        kw["compensated"] = True
    with pytest.raises(want):
        if entry == "dist_run":
            parallel.dist_run(variant, op, b, max_iter=3, **kw)
        else:
            parallel.dist_solve(op, b, variant=variant, max_iter=3, **kw)
    assert not dist.is_initialized()


def test_f32x2_entry_points_take_the_double_word_operator():
    """A ``DFOperator`` is taken as it is (its words split once)."""
    import torch.distributed as dist

    from new_cg_variants_tpu_torch.ops.doublefloat import df_operator

    op, b, _ = port.banded_model(256, k=3, kappa=100.0, fmt="dia",
                                 device="cpu")
    try:
        got = parallel.dist_run("pipe_pr_cg", df_operator(op, device="cpu"),
                                b, max_iter=10, dtype="f32x2", device="cpu")
        want = port.run("pipe_pr_cg", op, b, max_iter=10, dtype="f32x2",
                        device="cpu")
        np.testing.assert_array_equal(got["updated_residual_2_norm"],
                                      want["updated_residual_2_norm"])
        assert torch.equal(got["x"], want["x"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
