"""Convergence-experiment harness: the ``figure_gen`` driver of the port.

The port of the JAX package's ``harness/convergence.py``, which
re-expresses ``numerical_experiments/figure_gen.py`` over the solver API:

* :func:`test_matrix` — run a set of variants on one SPD matrix with the
  standard probe set and save one ``.npy`` trial dict per variant
  (``figure_gen.py:21-60``): problem setup ``x_true = 1/sqrt(N)``,
  ``b = A x_true``, ``x0 = 0``, Jacobi or no preconditioner, and the
  exact oracle run in extended precision on the host.
* :func:`parse_convergence_data` — one LaTeX table row per (matrix,
  preconditioner): n, nnz, per-variant iterations to relative A-norm
  error <= 1e-5 and log10 of best relative error, bolding
  (``\\tableemph``) variants >10% slower than the first (HS) variant or
  with accuracy exponent > 0.9x its value (``figure_gen.py:63-115``).
* :func:`gen_convergence_table` — concatenate all rows
  (``figure_gen.py:118-124``, unpreconditioned rows first).
* :data:`MATRIX_CONFIGS` — the reference's full experiment matrix
  (``figure_gen.py:245-339``) with per-config ``max_iter``; configs whose
  ``.mtx`` file is absent (``$CG_TPU_MATRIX_DIR``, the repository's
  ``matrices/``, or ``matrix_dir``) are skipped at run time.

Device and dtype: the variants run on ``device`` (default: the CUDA card)
in the data's dtype, float64 for a matrix read by
:func:`~..matio.matrix_market.read_mtx`, so the card computes the
reference's float64 experiment itself; pass ``dtype=torch.float32`` to
measure float32 attainable accuracy, or ``"f32x2"`` for the double-word
mode.  The oracle runs on the host (:mod:`..solvers.oracle`).

Trial files hold numpy arrays and Python scalars only (``'x'`` in
float64), so the JAX package's harness reads the port's files and the
other way round.
"""

from __future__ import annotations

import pathlib
import time

import numpy as np
import torch

from .._device import resolve_device
from ..matio.matrix_market import load_matrix as _load_fixture
from ..matio.matrix_market import read_mtx
from ..ops.operators import as_operator, torch_dtype
from ..solvers.api import is_double_word, run
from ..solvers.oracle import exact_pcg

__all__ = [
    "MATRIX_CONFIGS",
    "DEFAULT_VARIANTS",
    "PAPER_VARIANTS",
    "PROBES",
    "ERROR_TOL",
    "load_matrix",
    "test_matrix",
    "trial_summary",
    "parse_convergence_data",
    "gen_convergence_table",
    "run_convergence_suite",
]

#: (matrix_name, max_iter, preconditioner) — figure_gen.py:245-339 verbatim.
MATRIX_CONFIGS = [
    ("model_48_8_3", 110, None),
    ("model_48_8_3", 200, "jacobi"),
    ("bcsstk03", 250, "jacobi"),
    ("bcsstk14", 800, "jacobi"),
    ("bcsstk15", 830, "jacobi"),
    ("bcsstk16", 320, "jacobi"),
    ("bcsstk17", 3800, "jacobi"),
    ("bcsstk18", 2700, "jacobi"),
    ("bcsstk27", 380, "jacobi"),
    ("bcsstk03", 1250, None),
    ("bcsstk14", 25000, None),
    ("bcsstk15", 35000, None),
    ("bcsstk16", 900, None),
    ("bcsstk17", 45000, None),
    ("bcsstk18", 1750000, None),
    ("bcsstk27", 2300, None),
    ("nos1", 900, "jacobi"),
    ("nos2", 11000, "jacobi"),
    ("nos3", 350, "jacobi"),
    ("nos4", 120, "jacobi"),
    ("nos5", 350, "jacobi"),
    ("nos6", 130, "jacobi"),
    ("nos7", 200, "jacobi"),
    ("nos1", 4500, None),
    ("nos2", 45000, None),
    ("nos3", 400, None),
    ("nos4", 150, None),
    ("nos5", 600, None),
    ("nos6", 2400, None),
    ("nos7", 7000, None),
    ("bcsstm19", 1100, None),
    ("bcsstm20", 700, None),
    ("bcsstm21", 10, None),
    ("bcsstm22", 85, None),
    ("bcsstm23", 10000, None),
    ("bcsstm24", 45000, None),
    ("bcsstm25", 130000, None),
    ("494_bus", 2500, None),
    ("662_bus", 1200, None),
    ("685_bus", 950, None),
    ("1138_bus", 5000, None),
    ("494_bus", 500, "jacobi"),
    ("662_bus", 350, "jacobi"),
    ("685_bus", 350, "jacobi"),
    ("1138_bus", 1300, "jacobi"),
    ("s1rmq4m1", 1000, "jacobi"),
    ("s1rmt3m1", 1200, "jacobi"),
    ("s2rmq4m1", 2100, "jacobi"),
    ("s2rmt3m1", 3000, "jacobi"),
    ("s3dkq4m2", 60000, "jacobi"),
    ("s3dkt3m2", 75000, "jacobi"),
    ("s3rmq4m1", 12000, "jacobi"),
    ("s3rmt3m1", 17000, "jacobi"),
    ("s3rmt3m3", 40000, "jacobi"),
    ("s1rmq4m1", 12000, None),
    ("s1rmt3m1", 12000, None),
    ("s2rmq4m1", 35000, None),
    ("s2rmt3m1", 48000, None),
    ("s3rmq4m1", 100000, None),
    ("s3rmt3m1", 150000, None),
    ("s3rmt3m3", 250000, None),
]

#: the 9 variants the reference's main loop runs (figure_gen.py:345-348)
DEFAULT_VARIANTS = (
    "hs_pcg", "cg_pcg", "m_pcg", "gv_pcg",
    "pipe_p_m_pcg", "pipe_pr_m_pcg",
    "pr_pcg", "pipe_p_pcg", "pipe_pr_pcg",
)

#: the paper table's 7-variant column order (figure_gen.py:360)
PAPER_VARIANTS = (
    "hs_pcg", "cg_pcg", "m_pcg", "pr_pcg", "gv_pcg",
    "pipe_pr_m_pcg", "pipe_pr_pcg",
)

PROBES = ("error_A_norm", "residual_2_norm", "error_2_norm",
          "updated_residual_2_norm")

ERROR_TOL = 1e-5


def load_matrix(name: str, matrix_dir=None):
    """Load a fixture matrix, optionally from an explicit directory."""
    if matrix_dir is None:
        return _load_fixture(name)
    path = pathlib.Path(matrix_dir) / f"{name}.mtx"
    if not path.exists():
        raise FileNotFoundError(path)
    return read_mtx(str(path))


def _host_trial(trial):
    """A trial dict as the file holds it: tensors read back as float64
    numpy (never pickled as tensors)."""
    return {k: (v.detach().to("cpu", torch.float64).numpy()
                if isinstance(v, torch.Tensor) else v)
            for k, v in trial.items()}


def test_matrix(
    A,
    max_iter,
    title,
    preconditioner=None,
    variants=DEFAULT_VARIANTS,
    data_dir="./data",
    include_exact=False,
    dtype=None,
    fmt="auto",
    resume=False,
    device=None,
):
    """Run ``variants`` on A on ``device`` (default: the CUDA card), saving
    one trial dict per variant.

    Mirrors ``figure_gen.py:21-60``: ``x_true = 1/sqrt(N)``,
    ``b = A x_true``, ``x0 = 0``; ``exact_pcg`` (when requested) runs on
    the host in ``np.longdouble`` with ``min(max_iter, N)`` iterations.

    Each trial dict also holds ``'seconds'``, the wall time of its run (the
    histories read back to the host included).

    ``resume=True`` skips variants whose trial file already exists — the
    experiment-level resumability the reference README describes
    (re-run a single variant/matrix, regenerate only that figure;
    ``predict_and_recompute/README.md:38-40``).

    ``fmt`` is accepted and ignored, as the JAX package ignores it: the
    operator takes the auto format route.
    """
    import scipy.sparse as sp

    dev = resolve_device(device)
    # in the double-word mode the operator stays float64 (``run`` splits it)
    df = is_double_word(dtype)
    op = as_operator(A, dtype=None if df else torch_dtype(dtype), device=dev)
    n = op.n
    # Keep A SPARSE end to end (the reference feeds CSR throughout,
    # figure_gen.py:350): b comes from a CSR matvec and the oracle gets
    # the CSR, so the large configs never pay the O(n^2) densification.
    if sp.issparse(A) or hasattr(A, "tocsr"):
        a_mat = A.tocsr().astype(np.float64)
    elif hasattr(op, "tocsr"):
        a_mat = op.tocsr().astype(np.float64)
    else:
        a_mat = np.asarray(op.todense(), dtype=np.float64)
    x_true = np.ones(n) / np.sqrt(n)
    b = np.asarray(a_mat @ x_true, dtype=np.float64)

    out_dir = pathlib.Path(data_dir) / f"{title}_{preconditioner}"
    out_dir.mkdir(parents=True, exist_ok=True)

    results = {}
    if include_exact and not (resume and (out_dir / "exact_pcg.npy").exists()):
        t0 = time.perf_counter()
        trial = exact_pcg(
            a_mat, b, max_iter=min(max_iter, n), probes=PROBES,
            preconditioner=preconditioner, x_true=x_true,
        )
        trial["seconds"] = time.perf_counter() - t0
        np.save(out_dir / "exact_pcg.npy", trial, allow_pickle=True)
        results["exact_pcg"] = trial

    for variant in variants:
        if resume and (out_dir / f"{variant}.npy").exists():
            results[variant] = np.load(
                out_dir / f"{variant}.npy", allow_pickle=True
            ).item()
            continue
        t0 = time.perf_counter()
        trial = _host_trial(run(
            variant, op, b, max_iter=max_iter,
            preconditioner=preconditioner, probes=PROBES, x_true=x_true,
            dtype=dtype if df else None, device=dev,
        ))
        trial["seconds"] = time.perf_counter() - t0
        np.save(out_dir / f"{variant}.npy", trial, allow_pickle=True)
        results[variant] = trial
    return results


def trial_summary(trial):
    """``(iterations to relative A-norm error <= ERROR_TOL, log10 of the
    best relative error)`` of one trial dict; the iteration count is 0 when
    the tolerance is never reached (figure_gen.py:76-83)."""
    rel = trial["error_A_norm"] / trial["error_A_norm"][0]
    # argmin of a boolean: first index where rel <= tol (0 if never)
    return int(np.argmin(rel > ERROR_TOL)), float(np.log10(np.nanmin(rel)))


def parse_convergence_data(
    matrix_name,
    preconditioner=None,
    variants=PAPER_VARIANTS,
    data_dir="./data",
    n=None,
    nnz=None,
    matrix_dir=None,
):
    """Emit one LaTeX row (figure_gen.py:63-115) -> ``convergence.txt``.

    ``n``/``nnz`` may be passed to skip re-reading the matrix file.
    """
    if n is None or nnz is None:
        coo = load_matrix(matrix_name, matrix_dir)
        n = coo.shape[0]
        nnz = coo.nnz

    min_iters, min_errors = [], []
    for variant in variants:
        trial = np.load(
            pathlib.Path(data_dir) / f"{matrix_name}_{preconditioner}" / f"{variant}.npy",
            allow_pickle=True,
        ).item()
        it, err = trial_summary(trial)
        min_iters.append(it)
        min_errors.append(err)

    fmt_name = r"\texttt{" + matrix_name.replace("_", r"\_") + r"}"
    fmt_prec = "Jac." if preconditioner == "jacobi" else "-"
    data = f"{fmt_name} & {fmt_prec} & {n} & {nnz}"

    data_iter = ""
    data_err = ""
    for k in range(len(min_errors)):
        fmt_mi = min_iters[k] if min_iters[k] != 0 else "-"
        mi_bold = (
            "\\tableemph"
            if (min_iters[k] > 1.1 * min_iters[0]) or (min_iters[k] == 0)
            else ""
        )
        me_bold = "\\tableemph" if (min_errors[k] > 0.9 * min_errors[0]) else ""
        data_iter += f"& {mi_bold}{{{fmt_mi}}}"
        data_err += f"&{me_bold}{{{min_errors[k]:1.2f}}}"

    row = data + data_iter + data_err + "\\\\ \n"
    out = pathlib.Path(data_dir) / f"{matrix_name}_{preconditioner}" / "convergence.txt"
    out.write_text(row)
    return row


def gen_convergence_table(data_dir="./data", fig_dir="./figures"):
    """Concatenate all rows, None-preconditioner rows first
    (figure_gen.py:118-124)."""
    data_dir = pathlib.Path(data_dir)
    fig_dir = pathlib.Path(fig_dir)
    fig_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for suffix in ("None", "jacobi"):
        for d in sorted(data_dir.glob(f"*_{suffix}")):
            f = d / "convergence.txt"
            if f.exists():
                rows.append(f.read_text())
    out = fig_dir / "convergence_table_data.tex"
    out.write_text("".join(rows))
    return out


def run_convergence_suite(
    configs=None,
    variants=DEFAULT_VARIANTS,
    table_variants=None,
    data_dir="./data",
    fig_dir="./figures",
    matrix_dir=None,
    include_exact=False,
    make_plots=True,
    verbose=True,
    resume=False,
    dtype=None,
    device=None,
):
    """The reference's main loop (figure_gen.py:343-363): run every
    available (matrix, preconditioner) config on ``device`` (default: the
    CUDA card), emit plots + table rows.

    Missing matrix files are skipped, matching the reference README's note
    that ``s3dkq4m2`` must be downloaded separately.  ``make_plots`` needs
    matplotlib on the host.
    """
    from . import plotting

    dev = resolve_device(device)
    configs = MATRIX_CONFIGS if configs is None else configs
    if table_variants is None:
        table_variants = PAPER_VARIANTS
    done = []
    for matrix_name, max_iter, prec in configs:
        try:
            coo = load_matrix(matrix_name, matrix_dir)
        except FileNotFoundError:
            if verbose:
                print(f"skip {matrix_name} (fixture not present)")
            continue
        if verbose:
            print(f"matrix: {matrix_name}, preconditioner: {prec}")
        test_matrix(
            coo, max_iter, matrix_name, prec, variants=variants,
            data_dir=data_dir, include_exact=include_exact, resume=resume,
            dtype=dtype, device=dev,
        )
        if make_plots:
            for quantity in ("error_A_norm", "error_2_norm", "residual_2_norm"):
                plotting.plot_matrix_test(
                    matrix_name, prec, quantity, variants=variants,
                    data_dir=data_dir, fig_dir=fig_dir,
                )
        parse_convergence_data(
            matrix_name, prec, variants=table_variants, data_dir=data_dir,
            n=coo.shape[0], nnz=coo.nnz,
        )
        done.append((matrix_name, max_iter, prec))
    gen_convergence_table(data_dir, fig_dir)
    return done
