"""The port's row-partitioned distributed layer against the JAX package.

The port runs in gloo groups of 1, 2 and 4 ranks, each rank a process
started with the ``spawn`` method that imports only the port
(``torch_dist_worker.py``); all groups run at once while this process runs
the JAX package's ``dist_run`` on the conftest's host-device mesh sliced to
the same size, and the port's single-device ``run``.  The parent joins the
groups with one deadline, kills them on expiry and fails: a collective that
hangs costs this file its deadline, not the whole run's time limit.

Held, in float64 over 25 iterations (26 rows):

* ``dist_run`` histories (``updated_residual_2_norm``) against JAX's at the
  same mesh size, rtol 1e-10, and against the port's single-device ``run``,
  rtol 1e-11 (JAX's own ``tests/test_distributed.py`` holds its mesh to its
  single device so): hs, cg, gv, pr and pipe_pr (``_cg``) on
  ``banded_model(2048, k=8, kappa=1e4)`` in DIA and half-band storage, and
  pipe_pr_pcg with Jacobi on the scaled band of ``test_torch_variants.py``
  (n = 2048, half-band 8): Jacobi solves ``banded_model`` to the rounding
  floor within five iterations, past which two summation orders agree on
  nothing; compensated dots against JAX's compensated run;
* the halo: ``mv`` / ``mv2`` gathered against ``todense() @ v`` at k = 7,
  down to shards of 16 rows with a halo of 6 (n = 64, 4 ranks);
* ``dist_solve``'s forward error (JAX ``tests/test_distributed.py``);
* the overlapped pipe steps against the split formulation, exactly;
* the collectives per iteration of every name on both storages: hs two
  all-reduces, every other family one, one halo exchange per product, and
  in the gv and pipe families the all-reduce started before the halo
  exchange and waited for after the SpMV;
* bf16 half-band storage (float32 vectors) against the port's single-device
  bf16 run, rtol 1e-4 through iteration 15 (the JAX package casts its
  vectors to bf16 there, ROADMAP §3);
* what raises: ``n % p``, a halo wider than a shard, the routes of ROADMAP
  item 7b and ``device="cuda"`` without a card.
"""

import multiprocessing
import pickle
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops.operators import DiaOperator as JaxDia
from new_cg_variants_tpu.ops.sym_dia import SymDiaOperator as JaxSymDia
from new_cg_variants_tpu.parallel import dist_run as jax_dist_run
from new_cg_variants_tpu.parallel import make_mesh as jax_make_mesh
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch import parallel

WORLDS = (1, 2, 4)
FMTS = ("dia", "symdia")
ITERS = 26  # rows: the initial state and 25 iterations
RTOL_JAX = 1e-10
RTOL_SINGLE = 1e-11
BF16_ROWS, BF16_RTOL = 16, 1e-4
HALO_TOL = 1e-13
#: seconds for every group to finish, children's imports included
DEADLINE_S = 240
MODEL = ("banded", 2048, 8, 1e4)
SCALED = ("scaled", 2048, 8)
#: (variant, problem, keyword arguments of the run)
HISTORIES = {
    **{name: (name, MODEL, {}) for name in
       ("hs_cg", "cg_cg", "gv_cg", "pr_cg", "pipe_pr_cg")},
    "pipe_pr_pcg": ("pipe_pr_pcg", SCALED, {"preconditioner": "jacobi"}),
    "pipe_pr_cg compensated": ("pipe_pr_cg", MODEL, {"compensated": True}),
}
BF16_NAMES = ("pipe_pr_cg", "hs_cg")
SOLVE = ("banded", 4096, 5, 1e4)
HALO = ("banded", 64, 7, 1e4)
COUNT_PROBLEM = ("banded", 256, 4, 1e4)
COUNT_STEPS = 3
#: all-reduces per iteration of each family in the row partition
#: (tests/test_comm_structure.py's row counts)
SYNCS = {"hs": 2, "cg": 1, "gv": 1, "pr": 1, "m": 1, "pipe_p": 1,
         "pipe_pr": 1, "pipe_p_m": 1, "pipe_pr_m": 1}
#: families whose one all-reduce runs under the SpMV
OVERLAPPED = ("gv", "pipe_p", "pipe_pr", "pipe_p_m", "pipe_pr_m")


def _family(name):
    return name.rsplit("_", 1)[0]


def cases(world):
    """Every case a group of ``world`` ranks runs, in order."""
    out = []
    for fmt in FMTS:
        for key, (name, prob, kw) in HISTORIES.items():
            out.append(dict(key=("run", fmt, key), kind="run", fmt=fmt,
                            variant=name, problem=prob,
                            kw=dict(max_iter=ITERS, **kw)))
        out.append(dict(key=("halo", fmt), kind="halo", fmt=fmt,
                        problem=HALO))
        out.append(dict(key=("solve", fmt), kind="solve", fmt=fmt,
                        problem=SOLVE,
                        kw=dict(variant="pipe_pr_pcg", rtol=1e-10,
                                max_iter=4000, preconditioner="jacobi")))
        for name in ("pipe_pr_cg", "pipe_pr_pcg"):
            out.append(dict(key=("split", fmt, name), kind="split", fmt=fmt,
                            variant=name, problem=SCALED))
        if world > 1:
            for name in port.VARIANT_NAMES:
                out.append(dict(key=("counts", fmt, name), kind="counts",
                                fmt=fmt, variant=name, problem=COUNT_PROBLEM,
                                steps=COUNT_STEPS))
            out.append(dict(key=("raises", fmt, "n % p"), kind="raises",
                            fmt=fmt, variant="pipe_pr_cg",
                            problem=("banded", 2049, 4, 1e4)))
        if world == 4:
            out.append(dict(key=("raises", fmt, "halo"), kind="raises",
                            fmt=fmt, variant="pipe_pr_cg",
                            problem=("banded", 16, 7, 1e4)))
    for name in BF16_NAMES:
        out.append(dict(key=("run", "symdia", name + " bf16"), kind="run",
                        fmt="symdia", variant=name, problem=MODEL,
                        kw=dict(max_iter=ITERS, dtype=torch.bfloat16)))
    return out


def _jax_op(prob, fmt):
    if prob[0] == "banded":
        _, n, k, kappa = prob
        jop, b, _ = jax_banded(n, k=k, kappa=kappa, fmt=fmt)
        return jop, b
    sym, b = worker.problem(prob, "symdia")
    if fmt == "symdia":
        return JaxSymDia(sym.offsets, jnp.asarray(sym.data.numpy())), b
    offsets, data = sym.todia_host()
    return JaxDia(offsets, jnp.asarray(data)), b


def _start(world, tmp):
    ctx = multiprocessing.get_context("spawn")
    out = tmp / f"results_{world}.pkl"
    procs = [ctx.Process(target=worker.main, daemon=True,
                         args=(rank, world, str(tmp / f"store_{world}"),
                               str(out), cases(world)))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs, out


def _join(groups):
    """Wait for every group until the deadline; kill all on expiry."""
    end = time.monotonic() + DEADLINE_S
    for procs, _ in groups.values():
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    late = [p for procs, _ in groups.values() for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(10)
    if late:
        pytest.fail(f"{len(late)} rank processes still running after "
                    f"{DEADLINE_S} s: killed")
    results = {}
    for world, (procs, out) in groups.items():
        codes = [p.exitcode for p in procs]
        if any(codes):
            pytest.fail(f"world {world}: rank exit codes {codes}")
        with open(out, "rb") as f:
            results[world] = pickle.load(f)
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every group, compute the references meanwhile, then join."""
    tmp = tmp_path_factory.mktemp("dist")
    groups = {world: _start(world, tmp) for world in WORLDS}
    try:
        jax_out, single = {}, {}
        for fmt in FMTS:
            for key, (name, prob, kw) in HISTORIES.items():
                jop, b = _jax_op(prob, fmt)
                top, tb = worker.problem(prob, fmt)
                single[fmt, key] = port.run(name, top, tb, max_iter=ITERS,
                                            device="cpu", **kw)
                for world in WORLDS:
                    jax_out[world, fmt, key] = jax_dist_run(
                        name, jop, b, mesh=jax_make_mesh(world),
                        max_iter=ITERS, dtype=np.float64, **kw)
        top, tb = worker.problem(MODEL, "symdia")
        for name in BF16_NAMES:
            single["symdia", name + " bf16"] = port.run(
                name, top, tb, max_iter=ITERS, dtype=torch.bfloat16,
                device="cpu")
        results = _join(groups)
    finally:
        for procs, _ in groups.values():
            for p in procs:
                if p.is_alive():
                    p.kill()
    return dict(port=results, jax=jax_out, single=single)


def _result(runs, world, key):
    status, value = runs["port"][world][key]
    assert status == "ok", value
    return value


@pytest.mark.parametrize("key", list(HISTORIES))
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_run_matches_jax_dist_run(runs, world, fmt, key):
    got = _result(runs, world, ("run", fmt, key))["updated_residual_2_norm"]
    want = np.asarray(runs["jax"][world, fmt, key]["updated_residual_2_norm"])
    assert got.shape == want.shape == (ITERS,)
    np.testing.assert_allclose(got, want, rtol=RTOL_JAX)


@pytest.mark.parametrize("key", list(HISTORIES))
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_run_matches_single_device_run(runs, world, fmt, key):
    got = _result(runs, world, ("run", fmt, key))
    want = runs["single"][fmt, key]
    np.testing.assert_allclose(got["updated_residual_2_norm"],
                               want["updated_residual_2_norm"],
                               rtol=RTOL_SINGLE)
    # every rank returns the whole final iterate
    assert got["x"].shape == (want["x"].shape[0],)
    np.testing.assert_allclose(got["x"], want["x"].numpy(), rtol=1e-9,
                               atol=1e-12 * np.abs(want["x"].numpy()).max())


@pytest.mark.parametrize("name", BF16_NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_bf16_half_band_matches_single_device(runs, world, name):
    got = _result(runs, world, ("run", "symdia", name + " bf16"))
    want = runs["single"]["symdia", name + " bf16"]
    assert got["x"].dtype == np.float32  # bf16 storage, float32 vectors
    np.testing.assert_allclose(
        got["updated_residual_2_norm"][:BF16_ROWS],
        want["updated_residual_2_norm"][:BF16_ROWS], rtol=BF16_RTOL)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("world", WORLDS)
def test_halo_products_match_the_dense_product(runs, world, fmt):
    err = _result(runs, world, ("halo", fmt))
    assert set(err) == {"mv", "mv2 v", "mv2 w"}
    assert max(err.values()) < HALO_TOL, err


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_solve_forward_error(runs, world, fmt):
    got = _result(runs, world, ("solve", fmt))
    _, _, x_true = jax_banded(SOLVE[1], k=SOLVE[2], kappa=SOLVE[3])
    assert got["converged"]
    assert np.linalg.norm(got["x"] - x_true) < 1e-5


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("world", (2, 4))
def test_collectives_per_iteration(runs, world, fmt, name):
    steps = _result(runs, world, ("counts", fmt, name))
    family = _family(name)
    assert len(steps) == COUNT_STEPS
    for step in steps:
        assert step["all_reduce"] == SYNCS[family], step
        assert step["halo"] == 1, step
        assert step["order"].count("halo") == 1
        if family in OVERLAPPED:
            assert step["order"] == ["all_reduce async", "halo"], step


@pytest.mark.parametrize("name", ["pipe_pr_cg", "pipe_pr_pcg"])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("world", WORLDS)
def test_overlapped_pipe_step_equals_the_split_formulation(runs, world, fmt,
                                                           name):
    """The all-reduce under the SpMV changes no number: the overlapped step
    gives the split formulation's outputs and dots exactly.  The half-band
    context has no fused preconditioned vector phase and declines both
    preconditioned hooks (its family takes the generic body)."""
    diff = _result(runs, world, ("split", fmt, name))
    if fmt == "symdia" and name.endswith("pcg"):
        assert diff is None
    else:
        assert diff == 0.0


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("world", (2, 4))
def test_rows_must_divide_by_the_mesh_size(runs, world, fmt):
    kind, msg = _result(runs, world, ("raises", fmt, "n % p"))
    assert kind == "ValueError" and "divisible" in msg


@pytest.mark.parametrize("fmt", FMTS)
def test_halo_wider_than_a_shard_raises(runs, fmt):
    kind, msg = _result(runs, 4, ("raises", fmt, "halo"))
    assert kind == "ValueError" and "halo" in msg


def _refused(kind):
    op, b, _ = port.banded_model(64, k=3, kappa=100.0, fmt="dia",
                                 device="cpu")
    kw = dict(device="cpu")
    if kind == "f32x2":
        kw["dtype"] = "f32x2"
    elif kind == "col":
        kw["partition"] = "col"
    elif kind == "dense":
        op = op.todense()
    elif kind == "ell":
        op = port.from_coo(port.ops.operators.coo_from_scipy(op.tocsr()),
                           fmt="ell", device="cpu")
    elif kind == "stencil":
        op, b, _ = port.banded_model(64, k=3, kappa=100.0, fmt="stencil",
                                     device="cpu")
    elif kind == "block_banded":
        from new_cg_variants_tpu_torch.ops.block_banded import (
            block_banded_from_coo,
        )

        op, _ = block_banded_from_coo(
            port.ops.operators.coo_from_scipy(op.tocsr()),
            dtype=torch.float64, device="cpu")
    return op, b, kw


@pytest.mark.parametrize("entry", ["dist_run", "dist_solve"])
@pytest.mark.parametrize("kind", ["f32x2", "col", "dense", "ell", "stencil",
                                  "block_banded"])
def test_later_routes_raise_naming_the_roadmap_item(kind, entry):
    """Refused before any process group is made: these calls leave this
    process without one."""
    import torch.distributed as dist

    op, b, kw = _refused(kind)
    with pytest.raises(NotImplementedError, match="ROADMAP item 7b"):
        if entry == "dist_run":
            parallel.dist_run("pipe_pr_cg", op, b, max_iter=3, **kw)
        else:
            parallel.dist_solve(op, b, max_iter=3, **kw)
    assert not dist.is_initialized()


@pytest.mark.parametrize("entry", ["dist_run", "dist_solve", "make_mesh"])
def test_default_device_without_cuda_raises(monkeypatch, entry):
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    op, b, _ = port.banded_model(64, k=3, kappa=100.0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "dist_run":
            parallel.dist_run("pipe_pr_cg", op, b, max_iter=3)
        elif entry == "dist_solve":
            parallel.dist_solve(op, b, max_iter=3)
        else:
            parallel.make_mesh()
    assert not dist.is_initialized()
