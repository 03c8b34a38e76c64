"""Distributed solver entry points on ``torch.distributed``.

The port of the JAX package's ``parallel/dist.py``.  The JAX package runs the
family step functions inside ``shard_map``; here every rank runs them in its
own process on its own device over a mesh context (:mod:`.contexts`), the
structure of the reference's two distributed harnesses: PETSc's
row-partitioned ``KSPSolve`` (``cg_impls/pipeprcg.c``, ``partition='row'``)
and the mpi4py column blocks (``scaling_experiments_mpi4py/cg_variants``,
``partition='col'``).

* :func:`make_mesh` — a 1-D ``DeviceMesh`` over the default process group,
  or over its ranks ``[0, n_devices)``.  A plain script with no group and no
  launcher environment gets a world of one on its device, as JAX's
  one-device mesh; under ``torchrun`` (or after :func:`initialize_multihost`)
  the mesh spans every rank.
* :func:`dist_run` / :func:`dist_solve` — the mesh analogues of
  :func:`~..solvers.api.run` and :func:`~..solvers.api.solve`: each rank
  slices its part of the operator, the right-hand side, the initial guess
  and a Jacobi preconditioner, runs the port's own loops over its context,
  and gathers ``x`` (and the vector probes), so that every rank of the mesh
  returns the global output.  A rank outside a sub-mesh joins no collective
  and returns ``None``.

The row partition takes DIA, symmetric half-band, ELL (index exchange or
all-gather), block-banded and stencil operators in float32, float64 and
bf16 storage; the column partition dense and DIA operators (densified);
``dtype="f32x2"`` the row partition of a DIA-representable operator (DIA,
half-band expanded on the host, or a ``DFOperator``).  Every entry point
takes ``device`` (default the CUDA card, which is then NCCL's); without a
card it raises.

The JAX package jits its mesh loops (``jax.jit`` over ``shard_map``).  Here
the loops of :func:`dist_run`, :func:`dist_solve` and the scaling
harness's ``time_variant(mesh=)`` run on the card as replays of captured
CUDA graphs, each step's NCCL collectives inside them
(:mod:`~..solvers.graphs`, the runner of the rank's device), with the
eager loop's iterations and bits; they take no ``use_jit`` (JAX's take
none either) and run eagerly on the CPU.  A failed capture raises.  The
bodies after the set-up (:func:`_dist_history`, :func:`_dist_tolerance`)
take the runner, so that a caller can run the eager loop on the card as a
witness.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..ops.block_banded import BlockBandedOperator, solver_basis
from ..ops.doublefloat import (
    DF,
    DFJacobi,
    DFOperator,
    _host64,
    df_operator,
    df_split,
)
from ..ops.ell_spmv import check_index
from ..ops.operators import (
    DenseOperator,
    DiaOperator,
    EllOperator,
    as_operator,
    torch_dtype,
)
from ..ops.stencil import BandedStencilOperator
from ..ops.sym_dia import SymDiaOperator
from ..probes.probes import resolve_probes
from ..solvers import graphs
from ..solvers.api import (
    compute_x_true,
    df_selfcheck,
    is_double_word,
    loop_runner,
    needs_x_true,
    resolve,
    solve_result,
    vectors,
)
from ..solvers.engine import history_scan, tolerance_loop
from ..solvers.families import family_of
from ..solvers.precond import JacobiPreconditioner
from .contexts import (
    BlockBandedRowShardContext,
    ColShardContext,
    DFRowShardContext,
    EllRowShardContext,
    RowShardContext,
    StencilRowShardContext,
    SymDiaRowShardContext,
    sym_dia_shard_data,
)
from .ell_exchange import plan_or_none

__all__ = ["make_mesh", "dist_run", "dist_solve",
           "initialize_multihost"]

AXIS = "i"

_ROW_TYPES = (DiaOperator, EllOperator, BlockBandedOperator, SymDiaOperator,
              BandedStencilOperator)


def make_mesh(n_devices=None, device=None):
    """1-D mesh over the partition axis, on ``device``'s kind (default the
    CUDA card).

    A group this makes on the card reduces CUDA tensors with NCCL and CPU
    tensors with gloo, so the card's mesh and a CPU mesh can share it; on
    the CPU it is gloo's.

    With no process group yet: under a launcher (``RANK`` and
    ``WORLD_SIZE`` set, as ``torchrun`` sets them) the default group is
    initialized from the environment, otherwise as a world of one.
    ``n_devices`` below the world size gives a mesh over ranks ``[0,
    n_devices)``: every rank must call this (the mesh's group is made by
    all), and a rank outside it holds a mesh it takes no part in
    (``get_coordinate()`` is ``None``; the entry points return ``None``
    there).  More devices than the world holds (or than ``WORLD_SIZE``
    names, before a group is made) raise ``ValueError`` before any group is
    made.
    """
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dev = resolve_device(device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if n_devices is not None and not 0 < n_devices <= world:
        raise ValueError(
            f"a mesh of {n_devices} devices in a world of {world} process"
            f"{'es' if world > 1 else ''}: start one process a device, e.g. "
            f"torchrun --nproc-per-node {n_devices} -m "
            "new_cg_variants_tpu_torch ...")
    if not dist.is_initialized():
        # on the card NCCL, with gloo for the CPU tensors of the same group
        backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else int(os.environ.get("LOCAL_RANK", 0)))
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return init_device_mesh(dev.type, (world,), mesh_dim_names=(AXIS,))
    return DeviceMesh(dev.type, torch.arange(n_devices),
                      mesh_dim_names=(AXIS,))


def initialize_multihost(**kwargs):
    """Join a multi-process (and multi-host) run: ``init_process_group``
    with the caller's arguments (backend, ``init_method``, world size and
    rank; or none under ``torchrun``, which sets them in the environment)."""
    dist.init_process_group(**kwargs)


def _in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _check_partition(op, partition):
    """The partition ``'row'`` or ``'col'`` that ``partition`` names for
    ``op``, or ``TypeError``."""
    if partition == "auto":
        partition = "row" if isinstance(op, _ROW_TYPES) else "col"
    if partition == "row" and not isinstance(op, _ROW_TYPES):
        raise TypeError(
            "row partition requires a DiaOperator, SymDiaOperator, "
            "BandedStencilOperator, EllOperator or BlockBandedOperator")
    if partition == "col" and not isinstance(op, (DenseOperator,
                                                  DiaOperator)):
        raise TypeError("col partition requires a dense-representable "
                        "operator")
    return partition


def _check_df_dist_args(partition, compensated, col_packed):
    """The distributed f32x2 mode is row-partitioned DIA with its own
    double-word reductions: refuse the knobs it cannot honour rather than
    run another configuration."""
    if partition not in ("auto", "row"):
        raise NotImplementedError(
            "distributed f32x2 supports partition='row' only (got "
            f"{partition!r})")
    if compensated:
        raise NotImplementedError(
            "compensated=True is meaningless under f32x2 (the mode's dots "
            "are already double-word); drop the flag")
    if not col_packed:
        raise NotImplementedError(
            "col_packed applies to the column partition only; distributed "
            "f32x2 is row-partitioned")


def _rank_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows(v, rank, m, dev):
    """This rank's rows ``[rank m, (rank + 1) m)`` of a global vector (or
    of every row of a stacked array's last axis), contiguous on ``dev``."""
    return v[..., rank * m:(rank + 1) * m].contiguous().to(dev)


def _halo_width(op):
    """How far a row's product reaches into the neighbours' rows."""
    if isinstance(op, (DiaOperator, SymDiaOperator)):
        return max(abs(o) for o in op.offsets)
    if isinstance(op, BandedStencilOperator):
        return op.k - 1
    return 0


def _shard_shape(op, mesh):
    """``(p, rank, m, device)`` of this rank's row block; ``ValueError``
    unless the rows divide and the halo fits a neighbour's shard."""
    p, rank = mesh.size(), mesh.get_local_rank()
    n = op.n
    if n % p:
        raise ValueError(f"n={n} must be divisible by mesh size {p}")
    m = n // p
    h = _halo_width(op)
    if h > m:
        raise ValueError(f"halo {h} wider than a shard of {m} rows: a "
                         "neighbour holds too few of them")
    return p, rank, m, _rank_device(mesh)


def _ell_locality_shard(op, rank, m, dev):
    """This rank's rows of an ``EllOperator`` kept in a locality order
    (``op.perm``), for the all-gather route: ``(val, idx, perm, cols)``,
    the rows ordered by their rank in that order (a subsequence of the
    stored ``B``'s rows, slot-major ``(L, m)``), ``perm[i]`` the shard's
    row that row i is, ``cols`` the columns those rows touch in the same
    order (indices into the whole vector) and ``idx`` the rows' indices
    into ``cache[cols]``.  At one rank these are the operator's own storage
    and order.  :func:`dist_run` and :func:`dist_solve` do not reach it:
    they hand the context the operator in its basis
    (:func:`~..ops.block_banded.solver_basis`: ``B`` with no order, split
    into contiguous row blocks); a permuted operator given to
    :func:`_local_ctx_factory` itself does."""
    if m == op.n:
        return (op.val_t.to(dev), op.idx_t.to(dev), op.perm.to(dev),
                op.perm.to(dev))
    order = op.perm.long()
    lo = rank * m
    rows = torch.nonzero((order >= lo) & (order < lo + m)).squeeze(1)
    # B's column indices are ranks in the order: sorted, they are the order
    used, idx = torch.unique(op.idx_t[:, rows], sorted=True,
                             return_inverse=True)
    return (op.val_t[:, rows].to(dev), idx.to(torch.int32).to(dev),
            (order[rows] - lo).to(torch.int32).to(dev),
            order[used].to(torch.int32).to(dev))


def _ell_shard(op, p, rank, m, dev):
    """This rank's ELL rows (slot-major) and how its cache is filled and
    read: ``(val, idx, shifts, send_idx, order)``, ``shifts`` ``None`` for
    the all-gather (the planner's ``None``).  On that route an operator in
    a locality order hands over its rows in that order (``order``: the
    rows' and the columns' order, :func:`_ell_locality_shard`); otherwise
    the rows come in the operator's own numbering and ``order`` is ``()``
    (the entry points' case: their operator is ``B`` in its basis, and the
    planner chooses the route on ``B``'s pattern)."""
    # one rank: nothing to exchange, and plan_or_none gives None for any
    # pattern (no traffic can undercut an all-gather of nothing)
    given = plan = None
    if p > 1:
        given = op._given()
        plan = plan_or_none(given[1].T.cpu().numpy(), op.n, p)
    if plan is None and op.perm is not None:
        val, idx, perm, cols = _ell_locality_shard(op, rank, m, dev)
        check_index(idx, cols.shape[0])
        return val.T, idx.T, None, (), (perm, cols)
    val_t, idx_t = given or op._given()
    rows = slice(rank * m, (rank + 1) * m)
    val = val_t[:, rows].contiguous().to(dev)
    if plan is None:
        idx, shifts, send, c = idx_t[:, rows], None, (), op.n
    else:
        idx = torch.from_numpy(plan.idx_remap[rows].T.copy())
        shifts = plan.shifts
        send = tuple(torch.from_numpy(a[rank]).long().to(dev)
                     for a in plan.send_idx)
        c = m + plan.recv_total
    idx = idx.to(torch.int32).contiguous().to(dev)
    check_index(idx, c)
    return val.T, idx.T, shifts, send, ()


def _local_ctx_factory(op, mesh, precond, compensated=False, partition="row",
                       col_packed=True):
    """This rank's context of the partition: its part of the operator and
    of a Jacobi ``inv_diag``, on its device.  Any other preconditioner must
    act row by row (the identity, a pointwise function)."""
    p, rank, m, dev = _shard_shape(op, mesh)
    if isinstance(precond, JacobiPreconditioner):
        precond = JacobiPreconditioner(_rows(precond.inv_diag, rank, m, dev))
    elif hasattr(precond, "to"):
        precond = precond.to(dev)
    group = mesh.get_group()
    common = dict(precond=precond, compensated=compensated)
    if partition == "col":
        a = op.a if isinstance(op, DenseOperator) else torch.as_tensor(
            op.todense(), dtype=op.dtype)
        return ColShardContext(_rows(a, rank, m, dev), group,
                               packed=col_packed, **common)
    if isinstance(op, EllOperator):
        val, idx, shifts, send, order = _ell_shard(op, p, rank, m, dev)
        return EllRowShardContext(val, idx, group, shifts=shifts,
                                  send_idx=send, order=order, **common)
    if isinstance(op, BlockBandedOperator):
        nb = op.a_blk.shape[0]
        if nb % p:
            raise ValueError(f"nb={nb} block rows must be divisible by mesh "
                             f"size {p}")
        nbl = nb // p
        local = op.a_blk[rank * nbl:(rank + 1) * nbl].contiguous().to(dev)
        return BlockBandedRowShardContext(local, group, **common)
    if isinstance(op, BandedStencilOperator):
        return StencilRowShardContext(_rows(op.diag, rank, m, dev),
                                      op.off_value.to(dev), op.k, group,
                                      **common)
    if isinstance(op, SymDiaOperator):
        local = sym_dia_shard_data(op.data, p, _halo_width(op), rank)
        return SymDiaRowShardContext(op.offsets, local.to(dev), group,
                                     **common)
    return RowShardContext(op.offsets, _rows(op.data, rank, m, dev), group,
                           **common)


def _gather(v, mesh):
    """The global vector (``(n,)``) or stacked rows (``(k, n)``) from every
    rank's ``(m,)`` / ``(k, m)``, on every rank of the mesh."""
    local = v.t().contiguous()
    out = local.new_empty((mesh.size() * local.shape[0],) + local.shape[1:])
    dist.all_gather_into_tensor(out, local, group=mesh.get_group())
    return out.t()


def _gather_df(v, mesh):
    """A double-word vector (or stack of rows) gathered, as float64."""
    return _gather(v.hi, mesh).double() + _gather(v.lo, mesh).double()


def _mesh_for(mesh, dev):
    if mesh is None:
        return make_mesh(device=dev)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for device {dev}")
    return mesh


class _Local:
    """A rank's part of a distributed solve: its context, the family's
    functions, its rows of ``b`` and ``x0`` (``b``, ``x0``), ``rows`` (a
    global vector to this rank's rows) and ``gather`` (a local vector, or
    stacked rows, to the global one in the caller's order)."""

    def __init__(self, ctx, init_fn, step_fn, b, x0, rows, gather):
        self.ctx, self.init_fn, self.step_fn = ctx, init_fn, step_fn
        self.b, self.x0, self.rows, self.gather = b, x0, rows, gather


def _single_word(variant, op, b, x0, mesh, partition, preconditioner,
                 dtype, compensated, col_packed, device, w_replace=None,
                 w_replace_init=None, x_true=None, need_x_true=False):
    """``(mesh, local, aux_x_true)`` of a single-word distributed solve, or
    ``(mesh, None, None)`` on a rank outside the mesh.  Every refusal raises
    before the mesh (and a process group) is made."""
    dev = resolve_device(device)
    # the global operator in ``dtype``, left where the caller made it (each
    # rank moves only its slice), ``b`` and ``x0`` in its vector dtype
    is_op = (hasattr(op, "mv") and hasattr(op, "diagonal")
             and not isinstance(op, torch.Tensor))
    op = as_operator(op, dtype=torch_dtype(dtype),
                     device=op.device if is_op else dev)
    b, x0 = vectors(op, b, x0, op.device)
    partition = _check_partition(solver_basis(op)[0], partition)
    mesh = _mesh_for(mesh, dev)
    if not _in_mesh(mesh):
        return mesh, None, None
    if need_x_true and x_true is None:
        x_true = compute_x_true(op, b)
    # ELL in a locality order, or block-banded: each rank takes a block of
    # the basis's rows; past one rank a preconditioner acts on a rank's rows
    op, to_basis, from_basis, init_fn, step_fn, precond = resolve(
        variant, op, preconditioner, shard_local=mesh.size() > 1,
        w_replace=w_replace, w_replace_init=w_replace_init)
    ctx = _local_ctx_factory(op, mesh, precond, compensated, partition,
                             col_packed)
    m, rank, rdev = op.n // mesh.size(), mesh.get_local_rank(), \
        _rank_device(mesh)

    def rows(v):
        return _rows(to_basis(v), rank, m, rdev)

    def gather(v):
        g = _gather(v, mesh)
        return from_basis(g) if g.ndim == 1 else from_basis(g.t()).t()

    local = _Local(ctx, init_fn, step_fn, rows(b), rows(x0), rows, gather)
    aux_x_true = None
    if need_x_true:
        aux_x_true = rows(torch.as_tensor(x_true, dtype=b.dtype,
                                          device=b.device))
    return mesh, local, aux_x_true


def _df_operator(op):
    """The double-word operator of ``op`` on the host (a ``DFOperator`` is
    taken as it is): the exact three-word split of a DIA band, a half-band
    expanded first."""
    if isinstance(op, DFOperator):
        return op
    return df_operator(op, fmt="dia", device="cpu")


def _double_word(variant, op, b, x0, mesh, preconditioner, device,
                 x_true=None, need_x_true=False):
    """``(mesh, local, aux_x_true)`` of a double-word distributed solve
    (the row partition of a DIA-representable operator), or ``(mesh, None,
    None)`` on a rank outside the mesh."""
    dev = resolve_device(device)
    op_df = _df_operator(op)
    if not isinstance(op_df.inner, DiaOperator):
        raise TypeError(
            "distributed f32x2 requires a DIA-representable operator (got "
            f"inner {type(op_df.inner).__name__})")
    spec = preconditioner
    if family_of(variant)[1] and not (
            spec is None or isinstance(spec, DFJacobi)
            or isinstance(spec, str) and spec in ("identity", "jacobi")):
        raise NotImplementedError(
            "distributed f32x2 supports preconditioner None|'jacobi'; got "
            + repr(spec))
    _, _, _, init_fn, step_fn, precond = resolve(variant, op_df, spec)
    mesh = _mesh_for(mesh, dev)
    if not _in_mesh(mesh):
        return mesh, None, None
    inner = op_df.inner
    p, rank, m, rdev = _shard_shape(inner, mesh)
    df_selfcheck(rdev)

    def rows(v):
        return DF(_rows(v.hi, rank, m, rdev), _rows(v.lo, rank, m, rdev))

    if isinstance(precond, DFJacobi):
        precond = DFJacobi(rows(precond.inv_diag))
    words = tuple(_rows(w, rank, m, rdev) for w in op_df._words)
    ctx = DFRowShardContext(inner.offsets, *words, mesh.get_group(), precond)
    b_df = df_split(_host64(b), device="cpu")
    x0_df = df_split(np.zeros(op_df.n) if x0 is None else _host64(x0),
                     device="cpu")

    def gather(v):
        if isinstance(v, DF):
            return _gather_df(v, mesh)
        return _gather(v, mesh)  # a collapsed probe row

    local = _Local(ctx, init_fn, step_fn, rows(b_df), rows(x0_df), rows,
                   gather)
    aux_x_true = None
    if need_x_true:
        if x_true is None:
            x_true = compute_x_true(op_df, _host64(b))
        aux_x_true = rows(df_split(_host64(x_true), device="cpu"))
    return mesh, local, aux_x_true


def _setup(variant, op, b, x0, mesh, partition, preconditioner, dtype,
           compensated, col_packed, device, **kw):
    if is_double_word(dtype):
        _check_df_dist_args(partition, compensated, col_packed)
        if kw.pop("w_replace", None) is not None:
            raise NotImplementedError(
                "distributed f32x2 takes no residual-replacement hook")
        kw.pop("w_replace_init", None)
        return _double_word(variant, op, b, x0, mesh, preconditioner, device,
                            **kw)
    return _single_word(variant, op, b, x0, mesh, partition, preconditioner,
                        dtype, compensated, col_packed, device, **kw)


def dist_run(
    variant,
    op,
    b,
    mesh=None,
    x0=None,
    max_iter=100,
    partition="auto",
    preconditioner=None,
    probes=("updated_residual_2_norm",),
    x_true=None,
    dtype=None,
    compensated=False,
    w_replace=None,
    w_replace_init=None,
    col_packed=True,
    device=None,
):
    """Distributed history run: the mesh analogue of
    :func:`~..solvers.api.run`, on ``device`` (default the CUDA card).

    Every rank of the mesh returns the global output: ``'x'`` (gathered, a
    tensor on the rank's device; float64 ``hi + lo`` in f32x2), ``'nu'`` at
    the end and one numpy array per probe (``save_x`` / ``save_r`` rows
    gathered to ``(max_iter, n)``).  A rank outside a sub-mesh
    (:func:`make_mesh` with ``n_devices`` below the world size) returns
    ``None``.  ``col_packed`` picks the column partition's combine
    (:class:`~.contexts.ColShardContext`); ``dtype="f32x2"`` runs the
    double-word mode (:class:`~.contexts.DFRowShardContext`).

    On the card the loop replays captured CUDA graphs, every collective of
    a step inside them (:mod:`~..solvers.graphs`), as the JAX package jits
    its ``shard_map``; a gv replacement hook is then called at capture,
    with ``k`` a device tensor, and must answer with a tensor, as under
    :func:`~..solvers.api.run`'s ``use_jit=True``.  On the CPU the loop is
    eager.
    """
    probe_fns = resolve_probes(probes)
    # the hook is wired into the step at set-up, so the runner comes first:
    # for the device's kind, whose current device is the rank's
    # (_rank_device) when the loop starts
    runner, w_replace = loop_runner(
        torch.device(resolve_device(device).type), True, w_replace,
        w_replace_init)
    mesh, local, aux_x_true = _setup(
        variant, op, b, x0, mesh, partition, preconditioner, dtype,
        compensated, col_packed, device, w_replace=w_replace,
        w_replace_init=w_replace_init, x_true=x_true,
        need_x_true=needs_x_true(probe_fns))
    if local is None:
        return None
    return _dist_history(variant, local, probe_fns, max_iter, aux_x_true,
                         runner)


def _dist_history(variant, local, probe_fns, max_iter, aux_x_true, runner):
    """:func:`dist_run` after its set-up: the history loop on ``local``
    (eager with ``runner=None``), then ``x`` and the vector probe rows
    gathered once."""
    aux = {"b": local.b}
    if aux_x_true is not None:
        aux["x_true"] = aux_x_true
    final, hist = history_scan(local.ctx, local.init_fn, local.step_fn,
                               probe_fns, local.b, local.x0, max_iter, aux,
                               runner=runner)
    nu = final["nu"]
    output = {"name": variant, "max_iter": max_iter,
              "x": local.gather(final["x"]),
              "nu": (nu.hi + nu.lo if isinstance(nu, DF) else nu)
              .cpu().numpy()}
    for name in probe_fns:
        h = hist[name]
        if h.ndim == 2:  # vector probe rows: (max_iter, m) on each rank
            h = local.gather(h)
        output[name] = h.cpu().numpy()
    return output


def dist_solve(
    op,
    b,
    variant="pipe_pr_cg",
    mesh=None,
    x0=None,
    rtol=1e-8,
    atol=0.0,
    max_iter=10_000,
    partition="auto",
    preconditioner=None,
    norm_type="natural",
    dtype=None,
    compensated=False,
    col_packed=True,
    device=None,
):
    """Distributed tolerance solve: the mesh analogue of
    :func:`~..solvers.api.solve`, on ``device`` (default the CUDA card).
    ``x`` is gathered on every rank of the mesh (float64 ``hi + lo`` in
    f32x2); a rank outside a sub-mesh returns ``None``.  On the card the
    loop replays captured chunks of steps, each chunk's norms read back at
    once: every rank reads the same all-reduced norms, so every rank stops
    at the same step."""
    mesh, local, _ = _setup(variant, op, b, x0, mesh, partition,
                            preconditioner, dtype, compensated, col_packed,
                            device)
    if local is None:
        return None
    return _dist_tolerance(local, max_iter, rtol, atol, norm_type,
                           graphs.runner(_rank_device(mesh), True))


def _dist_tolerance(local, max_iter, rtol, atol, norm_type, runner):
    """:func:`dist_solve` after its set-up: the tolerance loop on
    ``local`` (eager with ``runner=None``), then ``x`` gathered."""
    s, k, nrm, tol = tolerance_loop(local.ctx, local.init_fn, local.step_fn,
                                    local.b, local.x0, max_iter, rtol, atol,
                                    norm_type, runner=runner)
    return solve_result(local.gather(s["x"]), k, nrm, tol, norm_type)


def _dist_chunked(variant, op, b, mesh, partition, preconditioner,
                  dtype=None, device=None):
    """The scaling harness's pieces of a timed trial on a mesh (the
    analogue of the mpi4py timed loop, ``scaling_experiments_mpi4py/
    cg_variants/hs_cg.py:31-64``): ``(local, final_x)``, this rank's
    :class:`_Local` and ``final_x(state)``, which gathers the iterate,
    float64 on the host (a collective: every rank of the mesh calls it).
    ``None`` on a rank outside the mesh.  The trials themselves are
    :func:`~..harness.scaling.time_variant`'s, captured on the card as on
    one device."""
    _, local, _ = _setup(variant, op, b, None, mesh, partition,
                         preconditioner, dtype, False, True, device)
    if local is None:
        return None

    def final_x(state):
        return local.gather(state["x"]).detach().to("cpu",
                                                    torch.float64).numpy()

    return local, final_x
