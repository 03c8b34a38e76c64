"""The multi-device halves of the harness and the command line, sub-meshes
and the launch scripts, on gloo groups of 2 and 4 spawned ranks.

Groups and the deadline as ``test_torch_distributed_formats.py``; wall time
of the file 12 s alone.  Held:

* ``scaling_run(mesh_sizes=(1, 2))`` on a group of 2 writes, from rank 0,
  one ``{variant}_p1_n{n}.json`` and one ``_p2_`` file per name with the
  JAX package's keys (``ScalingResult.to_dict``) and ``env_info.json``; the
  two sizes reach the same forward error;
* ``time_variant(mesh=..., partition="row" | "col", chunk_iters=...)`` on a
  group of 2 ends at the single-device loop's iterate;
* ``make_mesh(2)`` on a world of 4: ``dist_run`` on ranks 0-1 gives a
  2-rank group's histories bit for bit, and ranks 2-3 get ``None`` and join
  no collective (the group then finishes its next case: nothing hangs);
* ``cli.main(["solve", "--devices", "2", ...])`` on a group of 2 prints the
  JAX package's command line's iteration count (float64 and f32x2), and
  ``scaling --mesh-sizes 1,2`` writes both sizes' files;
* asking for more devices than the processes started raises, naming the
  ``torchrun`` line, before any process group is made;
* ``gen_multihost_script`` writes one executable script a host that exports
  the caller's environment and execs ``torchrun`` (``python -m
  torch.distributed.run``) with the JAX signature's arguments.
"""

import contextlib
import io
import json
import os
import stat

import numpy as np
import pytest

import torch_dist_groups as groups_
from new_cg_variants_tpu.harness import scaling as jhs
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch import cli
from new_cg_variants_tpu_torch.parallel import launch

DEADLINE_S = 240
N = 1024
NAMES = ("hs_cg", "pipe_pr_cg")
SCALING_KW = dict(problem="banded", n=N, k=4, kappa=100.0, max_iter=30,
                  trials=1, mesh_sizes=(1, 2))
TIMED = ("banded", 512, 4, 50.0)
RUN = ("banded", 2048, 8, 1e4)
SOLVE_ARGV = ["solve", "-n", "1024", "-k", "4", "--kappa", "1000",
              "--ksp-type", "pipe_pr_cg", "--rtol", "1e-8"]
DTYPES = {"f64": [], "f32x2": ["--dtype", "f32x2"]}


def _x_true(prob):
    _, n, k, kappa = prob
    return port.banded_model(n, k=k, kappa=kappa, device="cpu")[2]


def cases(world, tmp):
    out = []
    if world == 2:
        out.append(dict(key=("scaling_run",), kind="call", fn="scaling_run",
                        variants=NAMES, dir=str(tmp / "scaling"),
                        kw=SCALING_KW))
        x_true = _x_true(TIMED)
        for part in ("row", "col"):
            out.append(dict(key=("time_variant", part), kind="call",
                            fn="time_variant", variant="pipe_pr_cg",
                            problem=TIMED, fmt="dia",
                            kw=dict(x_true=x_true, max_iter=30, trials=1,
                                    partition=part, chunk_iters=10)))
        for dt, extra in DTYPES.items():
            out.append(dict(key=("cli solve", dt), kind="call", fn="cli",
                            argv=SOLVE_ARGV + extra + ["--devices", "2",
                                                       "--device", "cpu"]))
        out.append(dict(key=("cli scaling",), kind="call", fn="cli",
                        argv=["scaling", "-n", str(N), "-k", "4", "--kappa",
                              "100", "--variants", "pipe_pr_cg",
                              "--max-iter", "20", "--trials", "1",
                              "--mesh-sizes", "1,2", "--data-dir",
                              str(tmp / "cli_scaling"), "--device", "cpu"]))
    out.append(dict(key=("run", "mesh 2"), kind="run", fmt="dia",
                    variant="pipe_pr_cg", problem=RUN, mesh=2,
                    kw=dict(max_iter=26), every_rank=True))
    # the next collective of the whole group: no rank was left behind
    out.append(dict(key=("run", "after"), kind="run", fmt="dia",
                    variant="hs_cg", problem=RUN, kw=dict(max_iter=5)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_harness")
    groups = {world: groups_.start(world, tmp, cases(world, tmp))
              for world in (2, 4)}
    try:
        jax_cli = {}
        from new_cg_variants_tpu import cli as jcli

        for dt, extra in DTYPES.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jcli.main(SOLVE_ARGV + extra + ["--devices", "2"])
            jax_cli[dt] = buf.getvalue().splitlines()
        results = groups_.join(groups, DEADLINE_S)
    finally:
        groups_.kill(groups)
    return dict(port=results, jax_cli=jax_cli, tmp=tmp)


def _result(runs, world, key):
    return groups_.result(runs["port"], world, key)


def test_scaling_run_writes_both_sizes_with_the_jax_keys(runs):
    res = _result(runs, 2, ("scaling_run",))
    assert [(r["variant"], r["n_devices"]) for r in res] == [
        (v, p) for p in (1, 2) for v in NAMES]
    d = runs["tmp"] / "scaling"
    names = sorted(p.name for p in d.glob("*.json"))
    assert names == sorted(["env_info.json"] + [
        f"{v}_p{p}_n{N}.json" for v in NAMES for p in (1, 2)])
    keys = set(jhs.ScalingResult("hs_cg", N, 30, 2, [0.1], 0.0)
               .to_dict())
    for v in NAMES:
        one, two = (json.loads((d / f"{v}_p{p}_n{N}.json").read_text())
                    for p in (1, 2))
        assert set(one) == set(two) == keys
        assert one["n_devices"] == 1 and two["n_devices"] == 2
        assert len(two["times"]) == 1 and two["time_per_iter"] > 0
        np.testing.assert_allclose(two["error"], one["error"], rtol=1e-8)


@pytest.mark.parametrize("part", ["row", "col"])
def test_time_variant_on_a_mesh_ends_at_the_single_device_iterate(runs,
                                                                  part):
    from new_cg_variants_tpu_torch.harness import scaling as hs

    got = _result(runs, 2, ("time_variant", part))
    op, b, x_true = port.banded_model(*TIMED[1:2], k=TIMED[2],
                                      kappa=TIMED[3], fmt="dia",
                                      device="cpu")
    want = hs.time_variant("pipe_pr_cg", op, b, x_true=x_true, max_iter=30,
                           trials=1, device="cpu")
    assert got["n_devices"] == 2 and got["n"] == TIMED[1]
    assert got["max_iter"] == 30 and len(got["times"]) == 1
    np.testing.assert_allclose(got["error"], want.error, rtol=1e-9)


def test_sub_mesh_runs_on_its_ranks_and_returns_none_beyond(runs):
    ranks = _result(runs, 4, ("run", "mesh 2"))
    assert len(ranks) == 4
    for status, value in ranks:
        assert status == "ok", value
    assert ranks[2][1] is None and ranks[3][1] is None
    two = _result(runs, 2, ("run", "mesh 2"))
    for rank in (0, 1):
        got = ranks[rank][1]
        np.testing.assert_array_equal(got["updated_residual_2_norm"],
                                      two[0][1]["updated_residual_2_norm"])
        np.testing.assert_array_equal(got["x"], two[0][1]["x"])


@pytest.mark.parametrize("world", (2, 4))
def test_whole_group_runs_after_a_sub_mesh(runs, world):
    got = _result(runs, world, ("run", "after"))
    assert got["updated_residual_2_norm"].shape == (5,)


def _fields(lines):
    return dict(kv.split("=", 1) for ln in lines[:3] for kv in ln.split()
                if "=" in kv)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_cli_solve_on_two_devices_matches_the_jax_cli(runs, dt):
    rc, lines = _result(runs, 2, ("cli solve", dt))
    assert rc == 0 and len(lines) == 4, lines
    got, want = _fields(lines), _fields(runs["jax_cli"][dt])
    assert got["devices"] == want["devices"] == "2"
    assert got["iterations"] == want["iterations"]
    assert got["converged"] == want["converged"] == "True"
    # at the stop the forward error carries each package's roundings (JAX
    # compiles its loop): the same size, not the same digits
    np.testing.assert_allclose(float(got["forward_error"]),
                               float(want["forward_error"]), rtol=0.05)


def test_cli_scaling_writes_both_sizes(runs):
    rc, lines = _result(runs, 2, ("cli scaling",))
    assert rc == 0
    d = runs["tmp"] / "cli_scaling"
    assert sorted(p.name for p in d.glob("pipe_pr_cg_p*.json")) == [
        f"pipe_pr_cg_p1_n{N}.json", f"pipe_pr_cg_p2_n{N}.json"]
    assert (d / "scaling.call").exists()


@pytest.mark.parametrize("argv", [
    ["solve", "-n", "256", "-k", "2", "--devices", "3"],
    ["scaling", "-n", "256", "-k", "2", "--mesh-sizes", "1,3"],
], ids=["solve", "scaling"])
def test_more_devices_than_processes_names_torchrun(argv):
    import torch.distributed as dist

    with pytest.raises(ValueError, match="torchrun --nproc-per-node 3 -m "
                       "new_cg_variants_tpu_torch"):
        cli.main(argv + ["--device", "cpu"])
    assert not dist.is_initialized()


def test_launch_scripts_exec_torchrun(tmp_path):
    paths = launch.gen_multihost_script(
        tmp_path / "out", "10.0.0.1:29500", 3,
        ["scaling", "--variants", "pipe_pr_cg", "-n", "655360",
         "--mesh-sizes", "1,2,4"], name="strong", python="/opt/py",
        extra_env={"NCCL_DEBUG": "WARN", "OMP_NUM_THREADS": 4})
    assert [p.name for p in paths] == [f"strong_host{i}.sh"
                                       for i in range(3)]
    for i, p in enumerate(paths):
        assert stat.S_IMODE(os.stat(p).st_mode) == 0o755
        text = p.read_text()
        assert text.startswith("#!/bin/sh\n")
        assert "export NCCL_DEBUG=WARN\n" in text
        assert "export OMP_NUM_THREADS=4\n" in text
        assert (f"exec /opt/py -m torch.distributed.run --nnodes 3 "
                f"--node-rank {i} --nproc-per-node gpu --rdzv-backend c10d "
                "--rdzv-endpoint 10.0.0.1:29500 -m new_cg_variants_tpu_torch "
                "scaling --variants pipe_pr_cg -n 655360 --mesh-sizes "
                "1,2,4\n") in text
        assert text.index("export NCCL") < text.index("exec ")


def test_launch_takes_the_jax_signature():
    import inspect

    from new_cg_variants_tpu.parallel import launch as jlaunch

    mine = inspect.signature(launch.gen_multihost_script)
    theirs = inspect.signature(jlaunch.gen_multihost_script)
    assert [(p.name, p.default) for p in mine.parameters.values()] == [
        (p.name, p.default) for p in theirs.parameters.values()]
