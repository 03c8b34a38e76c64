"""Multi-host launch scripts: the cluster-orchestration layer.

The port of the JAX package's ``parallel/launch.py``.  The reference's
orchestration is Slurm script generation: ``run_slurm.py`` writes one sbatch
file per trial with the MPI async-progress environment
(``run_slurm.py:23-24,38-66``), and ``strong_scaling_tests.py:6-38`` does the
same for the PETSc runs.  Here the launcher is ``torchrun``: it starts one
process per GPU on every host and joins them through its ``c10d``
rendezvous at the coordinator, setting ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``, from which :func:`~.dist.make_mesh` makes the process group.
:func:`gen_multihost_script` writes one shell script per host that exports
the caller's environment and execs that ``torchrun`` line with the command
line's arguments.

The JAX package's scripts also set ``ASYNC_LIBTPU_FLAGS``, a TPU compiler's
flags for overlapping its collectives with compute.  They have no
counterpart here: the port overlaps by hand, each sync phase's all-reduce
started with ``async_op=True`` before the SpMV (:mod:`.contexts`).
"""

from __future__ import annotations

import pathlib
import shlex

__all__ = ["gen_multihost_script"]


def gen_multihost_script(
    out_dir,
    coordinator: str,
    num_hosts: int,
    cli_args,
    name: str = "launch",
    python: str = "python",
    extra_env: dict | None = None,
):
    """Write ``{name}_host{i}.sh`` (mode 755) for each host; returns the
    paths.

    ``coordinator``: ``host:port`` of the rendezvous; ``cli_args``: the argv
    passed to ``python -m new_cg_variants_tpu_torch`` (e.g. ``["scaling",
    "--variants", "pipe_pr_cg", "-n", "655360", "--mesh-sizes",
    "1,2,4,8"]``); ``python``: the interpreter whose ``torchrun`` runs it
    (``python -m torch.distributed.run``); ``extra_env``: variables
    exported first.
    """
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cmd = " ".join(shlex.quote(str(a)) for a in cli_args)
    env_lines = "".join(f"export {k}={shlex.quote(str(v))}\n"
                        for k, v in (extra_env or {}).items())
    paths = []
    for i in range(num_hosts):
        script = (
            "#!/bin/sh\n"
            f"# generated by new_cg_variants_tpu_torch.parallel.launch "
            f"(host {i}/{num_hosts})\n"
            f"{env_lines}"
            "# torchrun, run by the interpreter given\n"
            f"exec {shlex.quote(python)} -m torch.distributed.run "
            f"--nnodes {num_hosts} --node-rank {i} --nproc-per-node gpu "
            f"--rdzv-backend c10d --rdzv-endpoint {shlex.quote(coordinator)} "
            f"-m new_cg_variants_tpu_torch {cmd}\n")
        p = out / f"{name}_host{i}.sh"
        p.write_text(script)
        p.chmod(0o755)
        paths.append(p)
    return paths
