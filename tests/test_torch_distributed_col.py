"""The port's column partition (``ColShardContext``) against the JAX
package, on gloo groups of 1, 2 and 4 ranks.

The mpi4py structure (``scaling_experiments_mpi4py/scaling_tests.py:51-54``):
each rank owns ``m`` columns of a dense matrix.  Groups, references and the
deadline as ``test_torch_distributed_formats.py``; wall time of the file
36-50 s alone (most of it the JAX package's runs, the compensated ones the
slowest to compile), 98 s in the whole run under ``-n 6``.

Held, in float64 over 25 iterations (26 rows):

* ``dist_run(partition="col")`` histories of hs, cg, gv, pr and pipe_pr
  (``_cg``) against JAX's at the same mesh size, rtol 1e-10, and against the
  port's single-device ``run`` on the same dense operator, rtol 1e-11:
  ``banded_model(512, k=8)``'s matrix as a ``DenseOperator``, packed
  (``col_packed=True``: a phase's GEMM partials and scalars in one
  all-reduce) and unpacked (the product by reduce-scatter), gv and pipe_pr
  with compensated dots in both modes, and pipe_pr on the ``DiaOperator``
  (``todense`` on the host);
* ``mv`` / ``mv2`` gathered against ``todense() @ v``;
* the collectives per iteration of every name at 2 and 4 ranks, from the
  wrappers' counters and the order they reach ``torch.distributed``:
  packed, the totals of ``tests/test_comm_structure.py:39-50`` (hs 3, cgcg
  2, gv 1, pr 2, m 2, every pipe name 1), gv and the pipe names one
  all-reduce; unpacked, one reduce-scatter a product beside the row
  partition's all-reduces, in gv and the pipe names started before it;
* the overlapped pipe step against the split formulation and ``mv_dots`` /
  ``mv2_dots`` against ``mv`` / ``mv2`` and ``dots``: exactly unpacked;
  packed to 1e-14 of the largest value (its product comes from the
  all-reduce of the whole partial, the split one from a reduce-scatter: the
  ranks' partial sums in another order at 4 ranks).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_groups as groups_
import torch_dist_worker as worker
from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops.operators import as_operator as jax_as_operator
from new_cg_variants_tpu.parallel import dist_run as jax_dist_run
from new_cg_variants_tpu.parallel import make_mesh as jax_make_mesh
import new_cg_variants_tpu_torch as port

WORLDS = (1, 2, 4)
ITERS = 26  # rows: the initial state and 25 iterations
RTOL_JAX = 1e-10
RTOL_SINGLE = 1e-11
PRODUCT_TOL = 1e-13
PACKED_TOL = 1e-14
DEADLINE_S = 240
NAMES = ("hs_cg", "cg_cg", "gv_cg", "pr_cg", "pipe_pr_cg")
DENSE = ("dense", 512, 8, 1e4)
BANDED = ("banded", 512, 8, 1e4)
MODES = {"col": {"partition": "col"},
         "col unpacked": {"partition": "col", "col_packed": False}}
#: run key -> (variant, problem, fmt, keyword arguments)
HISTORIES = {
    **{(mode, name): (name, DENSE, "dense", kw)
       for mode, kw in MODES.items() for name in NAMES},
    **{(mode + " compensated", name): (name, DENSE, "dense",
                                       dict(kw, compensated=True))
       for mode, kw in MODES.items() for name in ("gv_cg", "pipe_pr_cg")},
    ("col of a DiaOperator", "pipe_pr_cg"): (
        "pipe_pr_cg", BANDED, "dia", MODES["col"]),
}
COUNT_STEPS = 3
#: collectives per iteration of each family, packed
#: (tests/test_comm_structure.py:39-50)
COL_PACKED = {"hs": 3, "cg": 2, "gv": 1, "pr": 2, "m": 2, "pipe_p": 1,
              "pipe_pr": 1, "pipe_p_m": 1, "pipe_pr_m": 1}
#: all-reduces per iteration of each family unpacked (the row partition's)
SYNCS = {"hs": 2, "cg": 1, "gv": 1, "pr": 1, "m": 1, "pipe_p": 1,
         "pipe_pr": 1, "pipe_p_m": 1, "pipe_pr_m": 1}
#: families whose sync phase carries the product
ONE_PHASE = ("gv", "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")


def _family(name):
    return name.rsplit("_", 1)[0]


def cases(world):
    out = []
    for key, (name, prob, fmt, kw) in HISTORIES.items():
        out.append(dict(key=("run",) + key, kind="run", fmt=fmt,
                        variant=name, problem=prob,
                        kw=dict(max_iter=ITERS, **kw)))
    for mode, kw in MODES.items():
        for kind in ("halo", "mode", "split", "mvdots"):
            out.append(dict(key=(kind, mode), kind=kind, fmt="dense",
                            variant="pipe_pr_cg", problem=DENSE, kw=kw))
        if world > 1:
            for name in port.VARIANT_NAMES:
                out.append(dict(key=("counts", mode, name), kind="counts",
                                fmt="dense", variant=name, problem=DENSE,
                                kw=kw, steps=COUNT_STEPS))
    return out


def _jax_op(prob, fmt):
    if fmt == "dense":
        dia, _ = worker.problem(BANDED, "dia")
        return jax_as_operator(jnp.asarray(dia.todense()))
    _, n, k, kappa = prob
    return jax_banded(n, k=k, kappa=kappa, fmt=fmt)[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every group, compute the references meanwhile, then join."""
    tmp = tmp_path_factory.mktemp("dist_col")
    groups = {world: groups_.start(world, tmp, cases(world))
              for world in WORLDS}
    try:
        jax_out, single, ops = {}, {}, {}
        for key, (name, prob, fmt, kw) in HISTORIES.items():
            if (prob, fmt) not in ops:
                ops[prob, fmt] = (_jax_op(prob, fmt),
                                  worker.problem(prob, fmt))
            jop, (top, tb) = ops[prob, fmt]
            single[key] = port.run(name, top, tb, max_iter=ITERS,
                                   device="cpu",
                                   compensated=kw.get("compensated", False))
            for world in WORLDS:
                jax_out[world, key] = jax_dist_run(
                    name, jop, tb, mesh=jax_make_mesh(world), max_iter=ITERS,
                    dtype=np.float64, **kw)
        results = groups_.join(groups, DEADLINE_S)
    finally:
        groups_.kill(groups)
    return dict(port=results, jax=jax_out, single=single)


def _result(runs, world, key):
    return groups_.result(runs["port"], world, key)


@pytest.mark.parametrize("key", list(HISTORIES), ids=" ".join)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_run_matches_jax_dist_run(runs, world, key):
    got = _result(runs, world, ("run",) + key)["updated_residual_2_norm"]
    want = np.asarray(runs["jax"][world, key]["updated_residual_2_norm"])
    assert got.shape == want.shape == (ITERS,)
    np.testing.assert_allclose(got, want, rtol=RTOL_JAX)


@pytest.mark.parametrize("key", list(HISTORIES), ids=" ".join)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_run_matches_single_device_run(runs, world, key):
    got = _result(runs, world, ("run",) + key)
    want = runs["single"][key]
    np.testing.assert_allclose(got["updated_residual_2_norm"],
                               want["updated_residual_2_norm"],
                               rtol=RTOL_SINGLE)
    x = want["x"].numpy()
    np.testing.assert_allclose(got["x"], x, rtol=1e-9,
                               atol=1e-12 * np.abs(x).max())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("world", WORLDS)
def test_products_match_the_dense_product(runs, world, mode):
    err = _result(runs, world, ("halo", mode))
    assert set(err) == {"mv", "mv2 v", "mv2 w"}
    assert max(err.values()) < PRODUCT_TOL, err


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("world", WORLDS)
def test_the_column_context(runs, world, mode):
    assert _result(runs, world, ("mode", mode))["type"] == "ColShardContext"


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("world", (2, 4))
def test_collectives_per_iteration(runs, world, mode, name):
    steps = _result(runs, world, ("counts", mode, name))
    family = _family(name)
    assert len(steps) == COUNT_STEPS
    for step in steps:
        order = step["order"]
        assert step["halo"] == step["index_exchange"] == \
            step["all_gather"] == 0, step
        if mode == "col":
            total = step["all_reduce"] + step["reduce_scatter"]
            assert total == len(order) == COL_PACKED[family], step
            if family in ONE_PHASE:
                assert order == ["all_reduce"], step
        else:
            assert step["reduce_scatter"] == 1, step
            assert step["all_reduce"] == SYNCS[family], step
            if family in ONE_PHASE:
                assert order == ["all_reduce async", "reduce_scatter"], step


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("world", WORLDS)
def test_overlapped_pipe_step_equals_the_split_formulation(runs, world,
                                                           mode):
    tol = PACKED_TOL if mode == "col" else 0.0
    assert _result(runs, world, ("split", mode)) <= tol


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("world", WORLDS)
def test_mv_dots_equal_mv_and_dots(runs, world, mode):
    err = _result(runs, world, ("mvdots", mode))
    tol = PACKED_TOL if mode == "col" else 0.0
    assert max(err.values()) <= tol, err
