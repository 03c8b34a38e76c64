"""Command-line drivers.

The port of the JAX package's ``cli.py``.  The reference exposes three entry
points: the convergence experiment script
(``numerical_experiments/figure_gen.py``, run as a script), the mpi4py
scaling CLI (``mpiexec -n P python scaling_tests.py n max_iter trial`` —
``scaling_experiments_mpi4py/scaling_tests.py:14``) and the PETSc drivers
with an options database (``mpirun ./ex2b -n ... -ksp_type pipeprcg
-recompute_w ...`` — ``scaling_experiments_petsc/ex2b.c``).

Here all three live under one ``python -m new_cg_variants_tpu_torch``:

* ``solve`` — PETSc-driver equivalent: build the banded/spectrum model
  problem (or load a ``.mtx`` file), run one variant to tolerance or
  fixed iterations, report timing + forward error.  Flag names follow
  the PETSc options (``--ksp-type``, ``--pc-type``, ``--ksp-norm-type``,
  ``--num-repeat``, ``-n``, ``-k``, ``--rho``, ``--kappa``,
  ``--off-value``).
* ``convergence`` — the figure_gen experiment suite (table + figures).
* ``scaling`` — timed variant x mesh-size matrix with min-over-trials,
  the strong-scaling harness.

Every subcommand runs on ``--device`` (default ``cuda``; without a card it
raises, ``--device cpu`` runs the kernels' plain versions).  One device
only: ``solve --devices N`` with N > 1, ``--partition`` and ``scaling
--mesh-sizes`` above 1 raise ``NotImplementedError`` until the distributed
layer is ported (ROADMAP item 7).
"""

from __future__ import annotations

import argparse
import sys
import time

from .harness.scaling import MULTI_DEVICE_MESSAGE


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")


def _add_problem_args(p):
    p.add_argument("--problem", choices=["banded", "spectrum", "mtx"],
                   default="banded")
    p.add_argument("-n", type=int, default=65536, help="problem dimension")
    p.add_argument("-k", type=int, default=32,
                   help="half-bandwidth (banded problem; nnz/row = 2k-1)")
    p.add_argument("--rho", type=float, default=None,
                   help="spectrum decay (banded default 0.95, spectrum 0.9)")
    p.add_argument("--kappa", type=float, default=1e6, help="condition number")
    p.add_argument("--off-value", type=float, default=1e-4,
                   help="off-diagonal value (banded problem)")
    p.add_argument("--matrix", type=str, default=None,
                   help="fixture name or .mtx path (--problem mtx)")
    p.add_argument("--mat-format", default="auto",
                   choices=["auto", "dia", "symdia", "stencil", "dense",
                            "ell", "block_banded"],
                   help="operator storage; auto: half-band (symdia) for the "
                        "banded model, the format policy of from_coo "
                        "(ops/operators.py:choose_format) for .mtx input")
    p.add_argument("--dtype", choices=["f32", "f64", "bf16", "f32x2"],
                   default=None,
                   help="compute dtype (default: the problem's, float64); "
                        "f32x2 = double-word arithmetic from float32 words; "
                        "bf16 = matrix STORAGE only (vectors stay f32; the "
                        "card's kernels do not take it yet)")
    _add_device_arg(p)


def _build_problem(args, dev):
    import numpy as np

    from .matio.matrix_market import load_matrix, read_mtx
    from .matio.problems import banded_model, model_spectrum
    from .ops.operators import from_coo

    mat_fmt = getattr(args, "mat_format", "auto")
    if args.problem == "banded":
        rho = 0.95 if args.rho is None else args.rho
        fmt = {"auto": "symdia"}.get(mat_fmt, mat_fmt)
        if fmt not in ("dia", "symdia", "stencil"):
            raise SystemExit(
                f"--mat-format {mat_fmt} does not apply to the banded "
                "model (choose auto|dia|symdia|stencil)")
        return banded_model(args.n, k=args.k, off_value=args.off_value,
                            kappa=args.kappa, rho=rho, fmt=fmt, device=dev)
    if args.problem == "spectrum":
        rho = 0.9 if args.rho is None else args.rho
        return model_spectrum(args.n, kappa=args.kappa, rho=rho, device=dev)
    if args.matrix is None:
        raise SystemExit("--problem mtx requires --matrix")
    coo = (read_mtx(args.matrix) if args.matrix.endswith(".mtx")
           else load_matrix(args.matrix))
    op = from_coo(coo, fmt=mat_fmt, device=dev)
    n = op.n
    x_true = np.ones(n) / np.sqrt(n)
    b = np.asarray(coo.tocsr() @ x_true, dtype=np.float64)
    return op, b, x_true


def _dtype(args):
    import torch

    return {None: None, "f32": torch.float32, "f64": torch.float64,
            "bf16": torch.bfloat16, "f32x2": "f32x2"}[args.dtype]


def cmd_solve(args):
    import numpy as np
    import torch

    from ._device import resolve_device
    from .solvers.api import solve

    if args.devices > 1 or args.partition is not None:
        raise NotImplementedError(MULTI_DEVICE_MESSAGE)
    dev = resolve_device(args.device)
    op, b, x_true = _build_problem(args, dev)
    dtype = _dtype(args)
    prec = None if args.pc_type == "none" else args.pc_type

    common = dict(
        variant=args.ksp_type, rtol=args.rtol, max_iter=args.max_iter,
        preconditioner=prec, norm_type=args.ksp_norm_type, dtype=dtype,
        device=dev,
    )
    times = []
    for _ in range(args.num_repeat):
        t0 = time.perf_counter()
        res = solve(op, b, **common)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)

    x = res.x.detach().to("cpu", torch.float64).numpy()
    err = float(np.linalg.norm(x - x_true))
    print(f"variant={args.ksp_type} n={op.n} devices={args.devices}")
    print(f"iterations={res.iterations} norm={res.norm:.6e} "
          f"converged={res.converged}")
    print(f"forward_error={err:.6e}")
    print(f"time_best={min(times):.4f}s over {args.num_repeat} repeats "
          f"(first includes the kernels' build and first launches)")
    return 0


def cmd_convergence(args):
    from ._device import resolve_device
    from .harness.convergence import (
        DEFAULT_VARIANTS, MATRIX_CONFIGS, run_convergence_suite,
    )

    dev = resolve_device(args.device)
    configs = MATRIX_CONFIGS
    if args.matrices:
        wanted = set(args.matrices.split(","))
        configs = [c for c in configs if c[0] in wanted]
    if args.max_iter_cap:
        configs = [(m, min(mi, args.max_iter_cap), p) for m, mi, p in configs]
    variants = (DEFAULT_VARIANTS if not args.variants
                else tuple(args.variants.split(",")))
    done = run_convergence_suite(
        configs=configs,
        variants=variants,
        # the paper's 7-column table needs all its variants present;
        # subset runs emit a table over just the variants that ran
        table_variants=None if not args.variants else variants,
        data_dir=args.data_dir, fig_dir=args.fig_dir,
        include_exact=args.exact, make_plots=not args.no_plots,
        resume=args.resume, dtype=_dtype(args), device=dev,
    )
    print(f"completed {len(done)} configs")
    return 0


def cmd_scaling(args):
    from .harness.scaling import scaling_run
    from .utils.env_info import write_call_file

    mesh_sizes = tuple(int(x) for x in args.mesh_sizes.split(","))
    if args.data_dir:
        write_call_file(args.data_dir, "scaling",
                        [f"python -m {__package__}"] + args.argv)

    kwargs = {}
    if args.problem == "banded":
        kwargs = dict(k=args.k, off_value=args.off_value, kappa=args.kappa,
                      rho=0.95 if args.rho is None else args.rho)
        if args.mat_format != "auto":
            kwargs["fmt"] = args.mat_format
    elif args.problem == "spectrum":
        kwargs = dict(kappa=args.kappa, rho=0.9 if args.rho is None else args.rho)
    else:
        raise SystemExit("scaling takes --problem banded or spectrum")
    scaling_run(
        variants=args.variants.split(","),
        problem=args.problem, n=args.n, max_iter=args.max_iter,
        trials=args.trials, mesh_sizes=mesh_sizes,
        preconditioner=None if args.pc_type == "none" else args.pc_type,
        dtype=_dtype(args), data_dir=args.data_dir, device=args.device,
        **kwargs,
    )
    if args.data_dir and args.plot:
        from .harness.scaling_plots import plot_strong_scaling

        print(plot_strong_scaling(args.data_dir, args.fig_dir))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="new_cg_variants_tpu_torch",
        description="predict-and-recompute CG variants on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="single solve (PETSc ex2a/ex2b analog)")
    _add_problem_args(ps)
    ps.add_argument("--ksp-type", default="pipe_pr_cg",
                    help="variant name (e.g. hs_cg, pipe_pr_pcg)")
    ps.add_argument("--pc-type", choices=["none", "jacobi"], default="none")
    ps.add_argument("--ksp-norm-type",
                    choices=["natural", "unpreconditioned", "preconditioned", "none"],
                    default="natural")
    ps.add_argument("--rtol", type=float, default=1e-8)
    ps.add_argument("--max-iter", type=int, default=10000)
    ps.add_argument("--num-repeat", type=int, default=1)
    ps.add_argument("--devices", type=int, default=1,
                    help="devices to solve over; only 1 until the "
                         "distributed layer is ported (ROADMAP item 7)")
    ps.add_argument("--partition", choices=["auto", "row", "col"],
                    default=None,
                    help="multi-device partition (ROADMAP item 7; raises)")
    ps.set_defaults(fn=cmd_solve)

    pc = sub.add_parser("convergence", help="figure_gen experiment suite")
    pc.add_argument("--matrices", type=str, default="",
                    help="comma-separated subset (default: all available)")
    pc.add_argument("--variants", type=str, default="")
    pc.add_argument("--data-dir", default="./data")
    pc.add_argument("--fig-dir", default="./figures")
    pc.add_argument("--exact", action="store_true",
                    help="also run the extended-precision oracle (on the "
                         "host, in long double)")
    pc.add_argument("--no-plots", action="store_true")
    pc.add_argument("--max-iter-cap", type=int, default=0,
                    help="cap per-config max_iter (quick runs)")
    pc.add_argument("--resume", action="store_true",
                    help="skip variants whose trial file already exists")
    pc.add_argument("--dtype", choices=["f32", "f64", "f32x2"], default=None,
                    help="variant dtype (default: the matrix file's, "
                         "float64: the reference's experiment, which the "
                         "card runs in its own float64, so no run is moved "
                         "to the CPU for precision); f32 measures float32 "
                         "attainable accuracy, f32x2 the double-word mode")
    _add_device_arg(pc)
    pc.set_defaults(fn=cmd_convergence)

    pg = sub.add_parser("scaling", help="strong-scaling harness")
    _add_problem_args(pg)
    pg.add_argument("--variants",
                    default="hs_cg,cg_cg,gv_cg,pr_cg,pipe_pr_cg")
    pg.add_argument("--mesh-sizes", default="1",
                    help="device counts; only 1 until the distributed layer "
                         "is ported (ROADMAP item 7)")
    pg.add_argument("--max-iter", type=int, default=1500)
    pg.add_argument("--trials", type=int, default=3)
    pg.add_argument("--pc-type", choices=["none", "jacobi"], default="none")
    pg.add_argument("--data-dir", default=None)
    pg.add_argument("--plot", action="store_true",
                    help="emit strong-scaling figures after the runs")
    pg.add_argument("--fig-dir", default="./figures")
    pg.set_defaults(fn=cmd_scaling)

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    args.argv = argv
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
