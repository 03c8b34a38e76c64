"""The port's ELL, block-banded and stencil row contexts against the JAX
package, on gloo groups of 1, 2 and 4 ranks.

As ``test_torch_distributed.py``: every group's ranks are processes started
with the ``spawn`` method that import only the port
(``torch_dist_worker.py``, through ``torch_dist_groups.py``), all groups run
at once while this process runs the JAX package's ``dist_run`` on the
conftest's host-device mesh sliced to the same size and the port's
single-device ``run``, and one deadline joins them (children killed on
expiry, the fixture fails).  Inputs are made from seeds (no ``.mtx``
fixture).  Wall time of the file: 31 s alone (most of it the JAX
package's runs), 79 s in the whole run under ``-n 6``, where every file's
ranks compete for the cores (``test_torch_distributed.py``: 121 s); the
column context is ``test_torch_distributed_col.py``, the double-word one
``test_torch_distributed_f32x2.py``, each a file of its own to keep each
file's time down.

Held, in float64 over 25 iterations (26 rows), for hs, cg, gv, pr and
pipe_pr (``_cg``):

* ``dist_run`` histories against JAX's at the same mesh size, rtol 1e-10,
  and against the port's single-device ``run`` on the same operator, rtol
  1e-11: the ELL row context with a planned index exchange (a random
  banded pattern, ``torch_dist_worker.ell_matrix``: hops to the ring's
  neighbours at 2 and 4 ranks) and with the all-gather (a scattered
  pattern: the planner declines), the block-banded row context
  (``banded_model``'s matrix packed in 128-row blocks, n = 1024) and the
  stencil row context (``banded_model(fmt="stencil")``, n = 2048);
* each context's ``mv`` / ``mv2`` gathered against ``todense() @ v``, and
  a pattern whose rows couple only inside each rank's block (a plan with no
  hop: the JAX package's context gathers the whole vector there and reads
  it with local indices, ROADMAP §3);
* which exchange the ELL context takes at each size;
* the collectives per iteration of every name in every context at 2 and 4
  ranks, from the wrappers' counters, and the order in which they reach
  ``torch.distributed``: as ``tests/test_comm_structure.py``'s row counts
  (hs 2 all-reduces, every other family 1), one exchange a product (halo,
  index exchange or all-gather), and in the gv and pipe families the
  all-reduce started before the exchange;
* the overlapped pipe step against the split formulation, exactly, and
  ``mv_dots`` / ``mv2_dots`` against ``mv`` / ``mv2`` and ``dots``;
* what raises: block rows that do not divide, a stencil halo wider than a
  shard.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_groups as groups_
import torch_dist_worker as worker
from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops.block_banded import (
    block_banded_from_coo as jax_block_banded,
)
from new_cg_variants_tpu.ops.operators import coo_from_scipy as jax_coo
from new_cg_variants_tpu.ops.operators import from_coo as jax_from_coo
from new_cg_variants_tpu.parallel import dist_run as jax_dist_run
from new_cg_variants_tpu.parallel import make_mesh as jax_make_mesh
import new_cg_variants_tpu_torch as port

WORLDS = (1, 2, 4)
ITERS = 26  # rows: the initial state and 25 iterations
RTOL_JAX = 1e-10
RTOL_SINGLE = 1e-11
PRODUCT_TOL = 1e-13
DEADLINE_S = 240
NAMES = ("hs_cg", "cg_cg", "gv_cg", "pr_cg", "pipe_pr_cg")
ELL = ("ell", 512, 7, 40, 3)
ELL_SCATTERED = ("ell", 512, 7, None, 3)
BLOCK = ("block", 1024, 8, 1e4)
STENCIL = ("banded", 2048, 8, 1e4)
#: context -> (problem, fmt, keyword arguments of the run)
CONTEXTS = {
    "ell": (ELL, "ell", {}),
    "ell all-gather": (ELL_SCATTERED, "ell", {}),
    "block": (BLOCK, "block", {}),
    "stencil": (STENCIL, "stencil", {}),
}
#: run key -> (variant, problem, fmt, keyword arguments)
HISTORIES = {(ctx, name): (name, prob, fmt, kw)
             for ctx, (prob, fmt, kw) in CONTEXTS.items() for name in NAMES}
COUNT_STEPS = 3
#: all-reduces per iteration of each family in a row context
ROW_SYNCS = {"hs": 2, "cg": 1, "gv": 1, "pr": 1, "m": 1, "pipe_p": 1,
             "pipe_pr": 1, "pipe_p_m": 1, "pipe_pr_m": 1}
OVERLAPPED = ("gv", "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")
#: the exchange wrapper each row context calls once a product
EXCHANGE = {"ell": "index_exchange", "ell all-gather": "all_gather",
            "block": "halo", "stencil": "halo"}
BLOCK_ROWS = ("block", 384, 3, 1e2)  # 3 blocks of 128: not for 2 ranks
STENCIL_WIDE = ("banded", 16, 8, 1e2)  # halo 7 > 4 rows a rank at 4


def _family(name):
    return name.rsplit("_", 1)[0]


def cases(world):
    out = []
    for key, (name, prob, fmt, kw) in HISTORIES.items():
        out.append(dict(key=("run",) + key, kind="run", fmt=fmt,
                        variant=name, problem=prob,
                        kw=dict(max_iter=ITERS, **kw)))
    for ctx, (prob, fmt, kw) in CONTEXTS.items():
        out.append(dict(key=("halo", ctx), kind="halo", fmt=fmt,
                        problem=prob, kw=kw))
        out.append(dict(key=("mode", ctx), kind="mode", fmt=fmt,
                        problem=prob, kw=kw))
        out.append(dict(key=("split", ctx), kind="split", fmt=fmt,
                        variant="pipe_pr_cg", problem=prob, kw=kw))
        out.append(dict(key=("mvdots", ctx), kind="mvdots", fmt=fmt,
                        problem=prob, kw=kw))
        if world > 1:
            for name in port.VARIANT_NAMES:
                out.append(dict(key=("counts", ctx, name), kind="counts",
                                fmt=fmt, variant=name, problem=prob, kw=kw,
                                steps=COUNT_STEPS))
    out.append(dict(key=("halo", "ell one block a rank"), kind="halo",
                    fmt="ell", problem=("ell_blocks", 512, world), kw={}))
    out.append(dict(key=("mode", "ell one block a rank"), kind="mode",
                    fmt="ell", problem=("ell_blocks", 512, world), kw={}))
    if world > 1:
        out.append(dict(key=("raises", "nb % p"), kind="raises",
                        fmt="block", variant="pipe_pr_cg",
                        problem=BLOCK_ROWS))
    if world == 4:
        out.append(dict(key=("raises", "halo"), kind="raises",
                        fmt="stencil", variant="pipe_pr_cg",
                        problem=STENCIL_WIDE))
    return out


def _jax_op(prob, fmt):
    """The JAX package's operator of the same matrix."""
    kind = prob[0]
    if kind == "ell":
        coo = jax_coo(worker.ell_matrix(*prob[1:]))
        return jax_from_coo(coo, fmt="ell", dtype=jnp.float64)
    if kind == "banded" and fmt == "stencil":
        _, n, k, kappa = prob
        return jax_banded(n, k=k, kappa=kappa, fmt="stencil")[0]
    dia, _ = worker.problem(("banded",) + prob[1:], "dia")
    op, _ = jax_block_banded(jax_coo(dia.tocsr()), dtype=jnp.float64,
                             reorder=None)
    return op


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every group, compute the references meanwhile, then join."""
    tmp = tmp_path_factory.mktemp("dist_formats")
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
                                   device="cpu")
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
    assert got["x"].shape == x.shape
    np.testing.assert_allclose(got["x"], x, rtol=1e-9,
                               atol=1e-12 * np.abs(x).max())


@pytest.mark.parametrize("ctx", list(CONTEXTS) + ["ell one block a rank"])
@pytest.mark.parametrize("world", WORLDS)
def test_products_match_the_dense_product(runs, world, ctx):
    err = _result(runs, world, ("halo", ctx))
    assert set(err) == {"mv", "mv2 v", "mv2 w"}
    assert max(err.values()) < PRODUCT_TOL, err


@pytest.mark.parametrize("world", WORLDS)
def test_ell_exchange_mode(runs, world):
    """A plan of the ring's neighbours for the banded pattern at 2 and 4
    ranks, the all-gather for the scattered one and at one rank, and a plan
    with no hop where every rank's rows couple only among themselves."""
    planned = _result(runs, world, ("mode", "ell"))
    gather = _result(runs, world, ("mode", "ell all-gather"))
    blocks = _result(runs, world, ("mode", "ell one block a rank"))
    assert {planned["type"], gather["type"], blocks["type"]} == {
        "EllRowShardContext"}
    assert gather["shifts"] is None
    if world == 1:
        assert planned["shifts"] is None and blocks["shifts"] is None
    else:
        assert planned["shifts"] and set(planned["shifts"]) <= {1, world - 1}
        assert blocks["shifts"] == ()


@pytest.mark.parametrize("ctx, kind", [
    ("block", "BlockBandedRowShardContext"),
    ("stencil", "StencilRowShardContext")])
@pytest.mark.parametrize("world", WORLDS)
def test_context_of_each_operator(runs, world, ctx, kind):
    assert _result(runs, world, ("mode", ctx))["type"] == kind


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
@pytest.mark.parametrize("ctx", list(CONTEXTS))
@pytest.mark.parametrize("world", (2, 4))
def test_collectives_per_iteration(runs, world, ctx, name):
    steps = _result(runs, world, ("counts", ctx, name))
    family = _family(name)
    assert len(steps) == COUNT_STEPS
    sent = "all_gather" if ctx == "ell all-gather" else "halo"
    for step in steps:
        order = step["order"]
        assert step["all_reduce"] == ROW_SYNCS[family], step
        exchanges = {key: step[key] for key in
                     ("halo", "index_exchange", "all_gather")}
        assert exchanges == {key: int(key == EXCHANGE[ctx])
                             for key in exchanges}, step
        assert step["reduce_scatter"] == 0
        assert order.count(sent) == 1, step
        assert order.count("all_reduce") + order.count(
            "all_reduce async") == ROW_SYNCS[family], step
        if family in OVERLAPPED:
            assert order == ["all_reduce async", sent], step


@pytest.mark.parametrize("ctx", list(CONTEXTS))
@pytest.mark.parametrize("world", WORLDS)
def test_overlapped_pipe_step_equals_the_split_formulation(runs, world, ctx):
    assert _result(runs, world, ("split", ctx)) == 0.0


@pytest.mark.parametrize("ctx", list(CONTEXTS))
@pytest.mark.parametrize("world", WORLDS)
def test_mv_dots_equal_mv_and_dots(runs, world, ctx):
    """The products and dots of a sync phase do not depend on riding one
    phase."""
    err = _result(runs, world, ("mvdots", ctx))
    assert max(err.values()) == 0.0, err


@pytest.mark.parametrize("world", (2, 4))
def test_block_rows_must_divide_by_the_mesh_size(runs, world):
    kind, msg = _result(runs, world, ("raises", "nb % p"))
    assert kind == "ValueError" and "block rows" in msg


def test_stencil_halo_wider_than_a_shard_raises(runs):
    kind, msg = _result(runs, 4, ("raises", "halo"))
    assert kind == "ValueError" and "halo" in msg
