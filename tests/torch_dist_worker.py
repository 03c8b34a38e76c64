"""One rank of the port's distributed tests (``test_torch_distributed.py``).

The test spawns a group of these processes per world size; each joins a gloo
group through a ``FileStore``, runs every case of the list it is handed in
the same order as the other ranks (the collectives pair up case by case),
and rank 0 pickles ``{case key: result}`` to the output path.  A world of
one joins no group itself: the port's ``make_mesh`` makes it, as for a plain
script.  This module imports the port, torch and numpy only, never JAX, so
that a spawned rank loads no JAX.

A case is a dict with ``key`` and ``kind``:

* ``"run"`` — ``dist_run`` on a problem (:func:`problem`) in a storage
  ``fmt``; returns the probe histories and the gathered ``x``;
* ``"solve"`` — ``dist_solve``; returns ``x``, iterations and convergence;
* ``"halo"`` — the row context's ``mv`` / ``mv2`` on random vectors,
  gathered, against ``todense() @ v``: the largest relative difference;
* ``"counts"`` — a few steps of one name on the row context: per step the
  all-reduce and halo counters and the order of the collectives;
* ``"split"`` — the overlapped pipe step against the split formulation on
  the same state: the largest difference;
* ``"raises"`` — ``dist_run`` expected to raise: the exception's type name
  and message.
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


def problem(spec, fmt):
    """``(operator on the CPU, b)`` of ``spec`` in ``fmt`` (``"dia"`` /
    ``"symdia"``): ``("banded", n, k, kappa)`` is ``banded_model``,
    ``("scaled", n, h)`` the scaled band with ``b = A 1``."""
    import new_cg_variants_tpu_torch as port
    from new_cg_variants_tpu_torch.convert import operator_from_numpy

    if spec[0] == "banded":
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


def _run(case):
    from new_cg_variants_tpu_torch.parallel import dist_run

    op, b = problem(case["problem"], case["fmt"])
    out = dist_run(case["variant"], op, b, device="cpu", **case["kw"])
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


def _halo(case):
    from new_cg_variants_tpu_torch.parallel import dist as pdist

    op, _ = problem(case["problem"], case["fmt"])
    mesh = pdist.make_mesh(device="cpu")
    ctx = pdist._local_ctx_factory(op, mesh, None)
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


def _counts(case):
    from new_cg_variants_tpu_torch.parallel import contexts
    from new_cg_variants_tpu_torch.parallel import dist as pdist
    from new_cg_variants_tpu_torch.solvers.api import _resolve

    op, b = problem(case["problem"], case["fmt"])
    b = torch.from_numpy(b)
    mesh = pdist.make_mesh(device="cpu")
    variant = case["variant"]
    pre = "jacobi" if variant.endswith("pcg") else None
    init_fn, step_fn, precond = _resolve(variant, op, pre)
    ctx = pdist._local_ctx_factory(op, mesh, precond)
    b_l = _local(op, b, mesh)
    state = init_fn(ctx, b_l, torch.zeros_like(b_l))
    # the order of what reaches torch.distributed (at two ranks and more
    # every rank posts messages in each halo exchange)
    log = []
    torch_reduce, torch_p2p = dist.all_reduce, dist.batch_isend_irecv

    def logged_reduce(*args, async_op=False, **kw):
        log.append("all_reduce async" if async_op else "all_reduce")
        return torch_reduce(*args, async_op=async_op, **kw)

    def logged_p2p(ops):
        log.append("halo")
        return torch_p2p(ops)

    steps = []
    dist.all_reduce, dist.batch_isend_irecv = logged_reduce, logged_p2p
    try:
        for _ in range(case["steps"]):
            contexts.all_reduce.calls = contexts.halo_exchange.calls = 0
            del log[:]
            state = step_fn(ctx, state)
            steps.append(dict(all_reduce=contexts.all_reduce.calls,
                              halo=contexts.halo_exchange.calls,
                              order=list(log)))
    finally:
        dist.all_reduce, dist.batch_isend_irecv = torch_reduce, torch_p2p
    return steps


def _split(case):
    """The row context's overlapped pipe step against the split formulation
    (vector phase with its own all-reduce, then the products) on one state
    past init: the largest difference of any output (vectors and dots), or
    ``None`` where the context declines the step."""
    from new_cg_variants_tpu_torch.parallel import dist as pdist
    from new_cg_variants_tpu_torch.solvers.api import _resolve
    from new_cg_variants_tpu_torch.solvers.context import split_pipe_full_step

    op, b = problem(case["problem"], case["fmt"])
    b = torch.from_numpy(b)
    mesh = pdist.make_mesh(device="cpu")
    variant = case["variant"]
    pcg = variant.endswith("pcg")
    init_fn, step_fn, precond = _resolve(variant, op,
                                         "jacobi" if pcg else None)
    ctx = pdist._local_ctx_factory(op, mesh, precond)
    b_l = _local(op, b, mesh)
    s_ = step_fn(ctx, init_fn(ctx, b_l, torch.zeros_like(b_l)))
    a1, beta = s_["a"], s_["b"]
    if not pcg:
        fused = ctx.pipe_full_step(s_, a1, beta, True)
        split = split_pipe_full_step(ctx, s_, a1, beta, True)
    else:
        fused = ctx.pipe_full_step_prec(s_, a1, beta, True)
        vec = ctx.pipe_vector_phase_prec(s_, a1, beta)
        if fused is None or vec is None:
            return None if fused is None and vec is None else "one declined"
        x, r, w, rt, wt, p, s, st_, dots = vec
        u, w = ctx.mv2(st_, rt)
        wt, ut = ctx.prec(w), ctx.prec(u)
        split = (x, r, w, p, s, u, rt, st_, wt, ut, dots)

    def flat(out):
        *vecs, dots = out
        return torch.cat([*vecs, torch.stack(dots)])

    return float((flat(fused) - flat(split)).abs().max())


def _raises(case):
    from new_cg_variants_tpu_torch.parallel import dist_run

    op, b = problem(case["problem"], case["fmt"])
    try:
        dist_run(case["variant"], op, b, device="cpu", max_iter=3)
    except (NotImplementedError, TypeError, ValueError) as e:
        return (type(e).__name__, str(e))
    return None


CASES = {"run": _run, "solve": _solve, "halo": _halo, "counts": _counts,
         "split": _split, "raises": _raises}


def main(rank, world, store_path, out_path, cases):
    """Run ``cases`` as rank ``rank`` of ``world``; rank 0 writes the
    results.  A case that fails records its traceback under its key."""
    torch.set_num_threads(1)
    if world > 1:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        results = {}
        for case in cases:
            try:
                results[case["key"]] = ("ok", CASES[case["kind"]](case))
            except Exception:  # reported to the test, which fails on it
                results[case["key"]] = ("error", traceback.format_exc())
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(results, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
