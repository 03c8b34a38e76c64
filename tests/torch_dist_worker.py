"""One rank of the port's distributed tests (``test_torch_distributed.py``,
``test_torch_distributed_formats.py``, ``test_torch_distributed_f32x2.py``,
``test_torch_dist_harness.py``, ``test_torch_dist_capture.py``).

The test spawns a group of these processes per world size; each joins a gloo
group through a ``FileStore``, runs every case of the list it is handed in
the same order as the other ranks (the collectives pair up case by case),
and rank 0 pickles ``{case key: result}`` to the output path.  A world of
one joins no group itself: the port's ``make_mesh`` makes it, as for a plain
script.  This module imports the port, torch and numpy only, never JAX, so
that a spawned rank loads no JAX.

A case is a dict with ``key`` and ``kind``:

* ``"run"`` — ``dist_run`` on a problem (:func:`problem`) in a storage
  ``fmt``; returns the probe histories and the gathered ``x`` (``None`` on
  a rank outside a sub-mesh, when ``case["mesh"]`` names one);
* ``"solve"`` — ``dist_solve``; returns ``x``, iterations and convergence;
* ``"halo"`` — the context's ``mv`` / ``mv2`` on random vectors, gathered,
  against ``todense() @ v``: the largest relative difference;
* ``"counts"`` — a few steps of one name on the context: per step the
  counters of every collective and the order of what reached
  ``torch.distributed``;
* ``"split"`` — the overlapped pipe step against the split formulation on
  the same state: the largest difference;
* ``"mode"`` — the context's type and, for ELL, whether it plans an index
  exchange (its hops) or gathers the whole vector;
* ``"raises"`` — ``dist_run`` expected to raise: the exception's type name
  and message;
* ``"call"`` — a function of :data:`CALLS` (the harness, the command line,
  sub-meshes): what it returns;
* ``"captured"`` — ``dist_run``, ``dist_solve`` or ``time_variant`` with
  the mesh loop captured by host captures, and eagerly (``tests/
  test_torch_dist_capture.py``); ``"chained"`` — the harness's trials on a
  mesh both ways; ``"reads"`` — one mesh step and its probe rows under
  ``HostReads``.

``case["kw"]`` holds the entry point's keyword arguments (``partition``,
``col_packed``, ``compensated``, ``dtype``, ...); the ``"counts"``,
``"split"`` and ``"halo"`` cases take the context's from it too.
"""

from __future__ import annotations

import pickle
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

#: seconds a rank waits in a collective before it gives up
TIMEOUT_S = 60


def scaled_band(n, h, seed=0, eps=1e-3):
    """``D^1/2 T D^1/2`` in half-band storage: ``T`` a diagonally dominant
    Toeplitz band, ``D`` random in [1, 100], so that Jacobi leaves a
    condition number near 1e3 (``test_torch_variants.py``'s problem)."""
    rng = np.random.default_rng(seed)
    c = -rng.uniform(0.5, 1.0, h)
    dsc = np.sqrt(rng.uniform(1.0, 100.0, n))
    data = np.zeros((h + 1, n))
    data[0] = 2.0 * np.abs(c).sum() * (1.0 + eps) * dsc * dsc
    for d in range(1, h + 1):
        data[d, : n - d] = c[d - 1] * dsc[: n - d] * dsc[d:]
    return tuple(range(h + 1)), data


def ell_matrix(n, L, bandwidth, seed):
    """A symmetric general sparse matrix (scipy CSR, float64) on the random
    pattern of the JAX package's ``test_distributed.py:_random_sparse_ell``
    (``L - 1`` columns a row within ``bandwidth`` of the diagonal, or
    anywhere with ``None``), symmetrized: negative off-diagonal values in
    [-1, -0.5], a diagonal just above each row's absolute sum, scaled on
    both sides by a random diagonal in [1, 10] so that 25 CG iterations stay
    above the rounding floor (condition number ~7e3)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    cols = np.empty((n, L - 1), dtype=np.int64)
    for i in range(n):
        if bandwidth is None:
            c = rng.choice(n, size=L - 1, replace=False)
        else:
            lo, hi = max(0, i - bandwidth), min(n, i + bandwidth + 1)
            c = lo + rng.choice(hi - lo, size=min(L - 1, hi - lo - 1),
                                replace=False)
            c = np.pad(c, (0, L - 1 - len(c)), constant_values=i)
        cols[i] = c
    rows = np.repeat(np.arange(n), L - 1)
    vals = -rng.uniform(0.5, 1.0, n * (L - 1))
    keep = rows != cols.ravel()
    s = sp.csr_matrix((vals[keep], (rows[keep], cols.ravel()[keep])),
                      shape=(n, n))
    s = s + s.T
    d = sp.diags(np.sqrt(rng.uniform(1.0, 100.0, n)))
    a = s + sp.diags(np.abs(s).sum(1).A1 * (1 + 1e-3))
    return (d @ a @ d).tocsr()


def block_diagonal_matrix(n, p):
    """A matrix whose rows couple only inside each of ``p`` row blocks: the
    exchange plan at ``p`` ranks has no hop."""
    import scipy.sparse as sp

    m = n // p
    blk = sp.diags([-np.ones(m - 1), 4 * np.ones(m), -np.ones(m - 1)],
                   [-1, 0, 1])
    return sp.block_diag([blk] * p).tocsr()


def problem(spec, fmt):
    """``(operator on the CPU, b)`` of ``spec`` in ``fmt``:

    * ``("banded", n, k, kappa)``: ``banded_model`` in ``fmt`` (``"dia"``,
      ``"symdia"``, ``"stencil"``);
    * ``("scaled", n, h)``: the scaled band in ``fmt`` (``"dia"`` /
      ``"symdia"``) with ``b = A 1``;
    * ``("ell", n, L, bandwidth, seed)``: :func:`ell_matrix` through
      ``from_coo(fmt="ell")``, ``("ell_blocks", n, p)``:
      :func:`block_diagonal_matrix` likewise; ``b = A x*``, ``x* = 1 /
      sqrt(n)``;
    * ``("block", n, k, kappa)``: ``banded_model``'s matrix packed by
      ``block_banded_from_coo`` in its natural order (``n`` a multiple of
      128: no pad rows);
    * ``("dense", n, k, kappa)``: ``banded_model``'s matrix as a
      ``DenseOperator``.
    """
    import new_cg_variants_tpu_torch as port
    from new_cg_variants_tpu_torch.convert import operator_from_numpy
    from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy

    kind = spec[0]
    if kind in ("ell", "ell_blocks"):
        a = ell_matrix(*spec[1:]) if kind == "ell" \
            else block_diagonal_matrix(*spec[1:])
        n = a.shape[0]
        op = port.from_coo(coo_from_scipy(a), fmt="ell", device="cpu")
        return op, a @ (np.ones(n) / np.sqrt(n))
    if kind in ("block", "dense"):
        from new_cg_variants_tpu_torch.ops.block_banded import (
            block_banded_from_coo,
        )

        _, n, k, kappa = spec
        dia, b, _ = port.banded_model(n, k=k, kappa=kappa, fmt="dia",
                                      device="cpu")
        if kind == "dense":
            return port.as_operator(dia.todense(), device="cpu"), b
        op, _ = block_banded_from_coo(coo_from_scipy(dia.tocsr()),
                                      dtype=torch.float64, reorder=None,
                                      device="cpu")
        return op, b
    if kind == "banded":
        _, n, k, kappa = spec
        op, b, _ = port.banded_model(n, k=k, kappa=kappa, fmt=fmt,
                                     device="cpu")
        return op, b
    _, n, h = spec
    sym = operator_from_numpy(*scaled_band(n, h), device="cpu")
    b = sym.todense() @ np.ones(n)
    if fmt == "symdia":
        return sym, b
    return operator_from_numpy(*sym.todia_host(), kind="dia",
                               device="cpu"), b


def _mesh(case):
    from new_cg_variants_tpu_torch.parallel import make_mesh

    return make_mesh(case.get("mesh"), device="cpu")


def _run(case):
    from new_cg_variants_tpu_torch.parallel import dist_run

    op, b = problem(case["problem"], case["fmt"])
    out = dist_run(case["variant"], op, b, mesh=_mesh(case), device="cpu",
                   **case["kw"])
    if out is None:
        return None
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def _solve(case):
    from new_cg_variants_tpu_torch.parallel import dist_solve

    op, b = problem(case["problem"], case["fmt"])
    res = dist_solve(op, b, device="cpu", **case["kw"])
    return dict(x=res.x.numpy(), iterations=res.iterations,
                converged=res.converged)


def _local(op, b, mesh):
    m = op.n // mesh.size()
    r = mesh.get_local_rank()
    return b[r * m:(r + 1) * m].contiguous()


def _ctx_kw(case):
    """The context's keyword arguments of ``_local_ctx_factory`` from the
    case's entry-point ones."""
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    kw = case.get("kw", {})
    return dict(partition=pdist._check_partition(
                    problem(case["problem"], case["fmt"])[0],
                    kw.get("partition", "auto")),
                col_packed=kw.get("col_packed", True))


def _halo(case):
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    op, _ = problem(case["problem"], case["fmt"])
    mesh = pdist.make_mesh(device="cpu")
    ctx = pdist._local_ctx_factory(op, mesh, None, **_ctx_kw(case))
    rng = np.random.default_rng(7)
    v, w = (torch.from_numpy(rng.standard_normal(op.n)) for _ in range(2))
    a = op.todense()
    y = pdist._gather(ctx.mv(_local(op, v, mesh)), mesh)
    y2, z2 = (pdist._gather(t, mesh) for t in ctx.mv2(_local(op, v, mesh),
                                                      _local(op, w, mesh)))
    err = {}
    for name, got, x in (("mv", y, v), ("mv2 v", y2, v), ("mv2 w", z2, w)):
        want = a @ x.numpy()
        err[name] = float(np.max(np.abs(got.numpy() - want))
                          / np.max(np.abs(want)))
    return err


def _local_solve(case, mesh):
    """This rank's ``_Local`` (context, family functions, rows of ``b`` and
    ``x0``) of the case's variant, Jacobi for a ``_pcg`` name."""
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    op, b = problem(case["problem"], case["fmt"])
    kw = case.get("kw", {})
    variant = case["variant"]
    pre = "jacobi" if variant.endswith("pcg") else None
    _, local, _ = pdist._setup(variant, op, b, None, mesh,
                               kw.get("partition", "auto"), pre,
                               kw.get("dtype"), kw.get("compensated", False),
                               kw.get("col_packed", True), "cpu")
    return local


#: what each collective wrapper of the contexts is logged as, by the
#: ``torch.distributed`` function it reaches (``halo``: every message of a
#: halo or index exchange, posted at two ranks and more)
LOGGED = {"all_reduce": "all_reduce", "batch_isend_irecv": "halo",
          "all_gather_into_tensor": "all_gather",
          "reduce_scatter_tensor": "reduce_scatter"}


def _counts(case):
    from new_cg_variants_tpu_torch.parallel import contexts
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    mesh = pdist.make_mesh(device="cpu")
    local = _local_solve(case, mesh)
    ctx, step_fn = local.ctx, local.step_fn
    state = local.init_fn(ctx, local.b, local.x0)
    # the order of what reaches torch.distributed
    log, saved = [], {name: getattr(dist, name) for name in LOGGED}

    def logged(name):
        def call(*args, async_op=False, **kw):
            log.append(LOGGED[name] + (" async" if async_op else ""))
            if name == "batch_isend_irecv":
                return saved[name](*args, **kw)
            return saved[name](*args, async_op=async_op, **kw)
        return call

    steps = []
    for name in LOGGED:
        setattr(dist, name, logged(name))
    try:
        for _ in range(case["steps"]):
            for fn in contexts.COLLECTIVES:
                fn.calls = 0
            del log[:]
            state = step_fn(ctx, state)
            steps.append(dict(
                all_reduce=contexts.all_reduce.calls,
                halo=contexts.halo_exchange.calls,
                index_exchange=contexts.index_exchange.calls,
                all_gather=contexts.all_gather.calls,
                reduce_scatter=contexts.reduce_scatter.calls,
                order=list(log)))
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
    return steps


def _split(case):
    """The context's overlapped pipe step against the split formulation
    (vector phase with its own all-reduce, then the products) on one state
    past init: the largest difference of any output (vectors, dots and, for
    the unpreconditioned step, alpha and beta) relative to the largest
    value, or ``None`` where the context declines the step."""
    import functools

    from new_cg_variants_tpu_torch.ops.doublefloat import DF
    from new_cg_variants_tpu_torch.parallel import dist as pdist
    from new_cg_variants_tpu_torch.solvers.context import (
        split_pipe_full_step,
        with_torch_scalars,
    )

    mesh = pdist.make_mesh(device="cpu")
    local = _local_solve(case, mesh)
    ctx, step_fn = local.ctx, local.step_fn
    pcg = case["variant"].endswith("pcg")
    s_ = step_fn(ctx, local.init_fn(ctx, local.b, local.x0))
    a1, beta = s_["a"], s_["b"]
    if not pcg:
        fused = ctx.pipe_full_step(s_, False, True)
        split = with_torch_scalars(
            functools.partial(split_pipe_full_step, ctx), s_, False, True)
    else:
        fused = ctx.pipe_full_step_prec(s_, a1, beta, True)
        vec = ctx.pipe_vector_phase_prec(s_, a1, beta)
        if fused is None or vec is None:
            return None if fused is None and vec is None else "one declined"
        x, r, w, rt, wt, p, s, st_, dots = vec
        u, w = ctx.mv2(st_, rt)
        wt, ut = ctx.prec(w), ctx.prec(u)
        split = (x, r, w, p, s, u, rt, st_, wt, ut, dots)

    def words(t):
        return [t.hi, t.lo] if isinstance(t, DF) else [t]

    def flat(out):
        items = [t for o in out for t in (o if isinstance(o, tuple) else (o,))]
        return torch.cat([w.reshape(-1) for t in items for w in words(t)])

    got, want = flat(fused), flat(split)
    return float((got - want).abs().max() / want.abs().max())


def _mvdots(case):
    """``mv_dots`` / ``mv2_dots`` against ``mv`` / ``mv2`` and ``dots`` on
    random vectors: the largest difference of each output, relative to its
    largest value."""
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    op, _ = problem(case["problem"], case["fmt"])
    mesh = pdist.make_mesh(device="cpu")
    ctx = pdist._local_ctx_factory(op, mesh, None, **_ctx_kw(case))
    rng = np.random.default_rng(11)
    v, w = (_local(op, torch.from_numpy(rng.standard_normal(op.n)), mesh)
            for _ in range(2))
    pairs = ((v, w), (w, w))
    y, d = ctx.mv_dots(v, pairs)
    y2, z2, d2 = ctx.mv2_dots(v, w, pairs)
    y0, (y20, z20), d0 = ctx.mv(v), ctx.mv2(v, w), ctx.dots(*pairs)

    def rel(got, want):
        got, want = (pdist._gather(t, mesh) if t.ndim else torch.stack([t])
                     for t in (got, want))
        return float((got - want).abs().max() / want.abs().max())

    return {"mv": rel(y, y0), "mv2 v": rel(y2, y20), "mv2 w": rel(z2, z20),
            **{f"dot {i}": max(rel(a, c), rel(b, c))
               for i, (a, b, c) in enumerate(zip(d, d2, d0))}}


def _mode(case):
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    op, _ = problem(case["problem"], case["fmt"])
    mesh = pdist.make_mesh(device="cpu")
    ctx = pdist._local_ctx_factory(op, mesh, None, **_ctx_kw(case))
    return dict(type=type(ctx).__name__, shifts=getattr(ctx, "shifts", ()))


def _raises(case):
    from new_cg_variants_tpu_torch.parallel import dist_run

    op, b = problem(case["problem"], case["fmt"])
    try:
        dist_run(case["variant"], op, b, device="cpu", max_iter=3,
                 **case.get("kw", {}))
    except (NotImplementedError, TypeError, ValueError) as e:
        return (type(e).__name__, str(e))
    return None


def _scaling(case):
    """``scaling_run`` over ``case["mesh_sizes"]`` into ``case["dir"]``:
    the results this rank returns (``None`` for a size it is outside of)."""
    from new_cg_variants_tpu_torch.harness.scaling import scaling_run

    res = scaling_run(case["variants"], device="cpu", verbose=False,
                      data_dir=case["dir"], **case["kw"])
    return [None if r is None else r.to_dict() for r in res]


def _time_variant(case):
    from new_cg_variants_tpu_torch.harness.scaling import time_variant

    op, b = problem(case["problem"], case["fmt"])
    res = time_variant(case["variant"], op, b, mesh=_mesh(case),
                       device="cpu", **case["kw"])
    return None if res is None else res.to_dict()


def _cli(case):
    """``cli.main(argv)`` with its standard output captured: ``(rc, lines)``
    or the exception's type name and message."""
    import contextlib
    import io

    from new_cg_variants_tpu_torch import cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(case["argv"])
    except (NotImplementedError, TypeError, ValueError, SystemExit) as e:
        return (type(e).__name__, str(e))
    return rc, buf.getvalue().splitlines()


CALLS = {"scaling_run": _scaling, "time_variant": _time_variant,
         "cli": _cli}


def _call(case):
    return CALLS[case["fn"]](case)


def _every3_tensor(k, view):
    """A gv replacement hook answering a bool tensor (capturable)."""
    return torch.as_tensor(k % 3 == 0)


def _every3_bool(k, view):
    """A gv replacement hook answering a Python bool (refused under
    capture)."""
    return bool(k % 3 == 0)


HOOKS = {"tensor": _every3_tensor, "bool": _every3_bool}


def _entry(case):
    """The public mesh entry point ``case["entry"]`` (``"run"``,
    ``"solve"``, ``"time_variant"``) on the case's problem, on the CPU: its
    output as numpy arrays and numbers."""
    from new_cg_variants_tpu_torch.harness.scaling import time_variant
    from new_cg_variants_tpu_torch.parallel import dist_run, dist_solve

    op, b = problem(case["problem"], case["fmt"])
    kw = dict(case["kw"])
    if "hook" in kw:
        kw["w_replace"] = HOOKS[kw.pop("hook")]
    entry = case["entry"]
    if entry == "run":
        out = dist_run(case["variant"], op, b, mesh=_mesh(case),
                       device="cpu", **kw)
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()}
    if entry == "solve":
        res = dist_solve(op, b, variant=case["variant"], mesh=_mesh(case),
                         device="cpu", **kw)
        return dict(x=res.x.numpy(), iterations=res.iterations,
                    norm=res.norm, converged=res.converged)
    res = time_variant(case["variant"], op, b, mesh=_mesh(case),
                       device="cpu", **kw)
    return res.to_dict()


def _captured(case):
    """The case's entry point with the mesh loop captured by host captures
    of ``case["chunk"]`` steps (``graphs.runner`` answering a
    :func:`torch_host_capture.host_runner` on the CPU, as ``CudaCapture``
    on the card), then eagerly: ``{"captured", "eager", "captures"}``, the
    last ``(graphs captured, replays)`` of each loop.  A ``"solve"`` case
    with ``case["target"]`` first finds, eagerly, the norm at that
    iteration and stops there (``atol``); with ``"how": "max_iter"`` it
    runs that many iterations."""
    import torch_host_capture as hc

    from new_cg_variants_tpu_torch.solvers import graphs

    case = dict(case, kw=dict(case["kw"]))
    target = case.get("target")
    if target is not None:
        if target == 0:
            case["kw"].update(rtol=2.0, max_iter=100)
        elif case["how"] == "max_iter":
            case["kw"].update(rtol=0.0, atol=0.0, max_iter=target)
        else:
            norm = _entry(dict(case, kw=dict(case["kw"], rtol=0.0, atol=0.0,
                                             max_iter=target)))["norm"]
            case["kw"].update(rtol=0.0, atol=norm, max_iter=100)
    made, real = [], graphs.runner

    def runner(device, use_jit, hooked=False):
        assert device.type == "cpu"
        if not use_jit:
            return None
        return hc.host_runner(case["chunk"], hooked=hooked, made=made)

    graphs.runner = runner
    try:
        got = _entry(case)
    except TypeError as e:  # a hook's Python answer
        got = ("TypeError", str(e))
    finally:
        graphs.runner = real
    return dict(captured=got, eager=_entry(case),
                captures=[(len(c.captured), c.replays) for c in made])


def _chained(case):
    """``time_variant``'s trials on a mesh through the harness's own
    pieces: the final ``x`` of ``case["trials"]`` chained trials replayed
    by host captures of ``case["chunk"]`` steps, and eagerly."""
    from new_cg_variants_tpu_torch.harness import scaling
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    import torch_host_capture as hc

    op, b = problem(case["problem"], case["fmt"])
    kw = case["kw"]
    mesh = _mesh(case)
    out = {}
    for label, runner in (("captured", hc.host_runner(case["chunk"])),
                          ("eager", None)):
        local, final_x = pdist._dist_chunked(
            case["variant"], op, b, mesh, kw.get("partition", "auto"), None,
            kw.get("dtype"), "cpu")
        trial = scaling._chained(local.ctx, local.init_fn, local.step_fn,
                                 local.b, local.x0, case["steps"], runner,
                                 torch.device("cpu"))
        for _ in range(case["trials"]):
            _, state = trial()
        out[label] = final_x(state)
    return out


def _reads(case):
    """One step of the case's name on the mesh context of the case's
    problem, and its probe rows, under ``HostReads``
    (``tests/test_torch_capture_reads.py``): what would read back to the
    host, make a tensor from host data or have a shape that depends on the
    data (a pcg name also with a norm riding the dot batch, a gv name with
    its hook as a captured loop calls it, but in f32x2, which takes
    none)."""
    from test_torch_capture_reads import HostReads, _rows

    from new_cg_variants_tpu_torch.parallel import dist as pdist
    from new_cg_variants_tpu_torch.solvers import graphs

    op, b = problem(case["problem"], case["fmt"])
    kw = case.get("kw", {})
    name = case["variant"]
    hook = None
    if name.startswith("gv") and kw.get("dtype") != "f32x2":
        hook = graphs.checked_hook(_every3_tensor, stateful=False)
    mesh, local, x_true = pdist._setup(
        name, op, b, None, _mesh(case), kw.get("partition", "auto"),
        "jacobi", kw.get("dtype"), kw.get("compensated", False),
        kw.get("col_packed", True), "cpu", w_replace=hook,
        x_true=np.ones(op.n), need_x_true=True)
    ctx, step_fn = local.ctx, local.step_fn
    aux = {"b": local.b, "x_true": x_true}
    state = local.init_fn(ctx, local.b, local.x0)
    if hook is not None:
        state["k"] = torch.tensor(2)
    reads = []
    with HostReads() as mode:
        s = step_fn(ctx, state)
        _rows(ctx, s, aux)
    reads += mode.reads
    if name.endswith("pcg"):
        ctx.extra_norm = "rt"
        (state["rho"],) = ctx.dots((state["rt"], state["rt"]))
        with HostReads() as mode:
            s = step_fn(ctx, state)
            _rows(ctx, s, aux)
        reads += mode.reads
    return dict(reads=reads, context=type(ctx).__name__,
                shifts=getattr(ctx, "shifts", ()))


CASES = {"run": _run, "solve": _solve, "halo": _halo, "counts": _counts,
         "split": _split, "mvdots": _mvdots, "mode": _mode,
         "raises": _raises, "call": _call, "captured": _captured,
         "chained": _chained, "reads": _reads}


def main(rank, world, store_path, out_path, cases):
    """Run ``cases`` as rank ``rank`` of ``world``; rank 0 writes the
    results.  A case that fails records its traceback under its key.  A
    case with ``"every_rank"`` set records every rank's ``(status,
    value)``, in rank order (gathered over the whole group)."""
    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        results = {}
        for case in cases:
            try:
                got = ("ok", CASES[case["kind"]](case))
            except Exception:  # reported to the test, which fails on it
                got = ("error", traceback.format_exc())
            if case.get("every_rank"):
                ranks = [None] * world
                if world > 1:
                    dist.all_gather_object(ranks, got)
                else:
                    ranks = [got]
                got = ("ok", ranks)
            results[case["key"]] = got
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
