"""Distributed solver entry points on ``torch.distributed``: the row partition.

The port of the JAX package's ``parallel/dist.py``.  The JAX package runs the
family step functions inside ``shard_map``; here every rank runs them in its
own process on its own device over a row context (:mod:`.contexts`), the
structure of PETSc's row-partitioned ``KSPSolve`` (``cg_impls/pipeprcg.c``).

* :func:`make_mesh` — a 1-D ``DeviceMesh`` over the default process group.
  A plain script with no group and no launcher environment gets a world of
  one on its device, as JAX's one-device mesh; under ``torchrun`` (or after
  :func:`initialize_multihost`) the mesh spans every rank.
* :func:`dist_run` / :func:`dist_solve` — the mesh analogues of
  :func:`~..solvers.api.run` and :func:`~..solvers.api.solve`: each rank
  slices its rows of the operator, the right-hand side, the initial guess
  and a Jacobi preconditioner, runs the port's own loops over its context,
  and gathers ``x`` (and the vector probes), so that every rank returns the
  global output.

The row partition covers DIA and symmetric half-band operators in float32,
float64 and bf16 storage.  ELL, block-banded and stencil rows, the column
partition and ``dtype="f32x2"`` raise ``NotImplementedError`` (ROADMAP item
7b); a sub-mesh (``n_devices`` other than the world size) raises too (item
7c).  Every entry point takes ``device`` (default the CUDA card, which is
then NCCL's); without a card it raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..ops.block_banded import BlockBandedOperator, solver_basis
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
from ..solvers.api import (
    SolveResult,
    _compute_x_true,
    _needs_x_true,
    _resolve,
    _vectors,
    is_double_word,
)
from ..solvers.engine import history_scan, tolerance_loop
from ..solvers.precond import JacobiPreconditioner
from .contexts import RowShardContext, SymDiaRowShardContext, sym_dia_shard_data

__all__ = ["AXIS", "make_mesh", "dist_run", "dist_solve",
           "initialize_multihost"]

AXIS = "i"

_ROW_TYPES = (DiaOperator, EllOperator, BlockBandedOperator, SymDiaOperator,
              BandedStencilOperator)
_LATER = "is not ported yet (ROADMAP item 7b)"


def make_mesh(n_devices=None, device=None):
    """1-D mesh over the row partition axis, on ``device``'s kind (default
    the CUDA card).

    A group this makes on the card reduces CUDA tensors with NCCL and CPU
    tensors with gloo, so the card's mesh and a CPU mesh can share it; on
    the CPU it is gloo's.

    With no process group yet: under a launcher (``RANK`` and
    ``WORLD_SIZE`` set, as ``torchrun`` sets them) the default group is
    initialized from the environment, otherwise as a world of one.
    ``n_devices`` must be ``None`` or the world size.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
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
    if n_devices is not None and n_devices != world:
        raise NotImplementedError(
            f"a mesh of {n_devices} of the {world} ranks: sub-meshes are not "
            "ported yet (ROADMAP item 7c)")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(AXIS,))


def initialize_multihost(**kwargs):
    """Join a multi-process (and multi-host) run: ``init_process_group``
    with the caller's arguments (backend, ``init_method``, world size and
    rank; or none under ``torchrun``, which sets them in the environment)."""
    dist.init_process_group(**kwargs)


def _check_partition(op, partition):
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
    if partition == "col":
        raise NotImplementedError(f"the column partition {_LATER}")
    if not isinstance(op, (DiaOperator, SymDiaOperator)):
        raise NotImplementedError(
            f"the row partition of a {type(op).__name__} {_LATER}")


def _rank_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows(v, rank, m, dev):
    """This rank's rows ``[rank m, (rank + 1) m)`` of a global vector (or
    of every row of a stacked array's last axis), contiguous on ``dev``."""
    return v[..., rank * m:(rank + 1) * m].contiguous().to(dev)


def _local_ctx_factory(op, mesh, precond, compensated=False):
    """This rank's context of the row partition: its slice of the DIA data
    (or its extended half-band slice) and of a Jacobi ``inv_diag``, on its
    device.  Any other preconditioner must act row by row (the identity, a
    pointwise function)."""
    p, rank = mesh.size(), mesh.get_local_rank()
    n = op.n
    if n % p:
        raise ValueError(f"n={n} must be divisible by mesh size {p}")
    m, dev = n // p, _rank_device(mesh)
    h = max(abs(o) for o in op.offsets)
    if h > m:
        raise ValueError(f"halo {h} wider than a shard of {m} rows: a "
                         "neighbour holds too few of them")
    if isinstance(precond, JacobiPreconditioner):
        precond = JacobiPreconditioner(_rows(precond.inv_diag, rank, m, dev))
    group = mesh.get_group()
    if isinstance(op, SymDiaOperator):
        local = sym_dia_shard_data(op.data, p, h, rank)
        return SymDiaRowShardContext(op.offsets, local.to(dev), group,
                                     precond, compensated)
    return RowShardContext(op.offsets, _rows(op.data, rank, m, dev), group,
                           precond, compensated)


def _gather(v, mesh):
    """The global vector (``(n,)``) or stacked rows (``(k, n)``) from every
    rank's ``(m,)`` / ``(k, m)``, on every rank."""
    local = v.t().contiguous()
    out = local.new_empty((mesh.size() * local.shape[0],) + local.shape[1:])
    dist.all_gather_into_tensor(out, local, group=mesh.get_group())
    return out.t()


def _pieces(op, b, x0, dtype, device):
    """What both entry points do first: the global operator in ``dtype``
    (left where the caller made it: each rank moves only its slice), ``b``
    and ``x0`` in the solve's vector dtype (bf16 storage: float32), and the
    resolved ``device``."""
    if is_double_word(dtype):
        raise NotImplementedError(f"distributed dtype='f32x2' {_LATER}")
    dev = resolve_device(device)
    is_op = (hasattr(op, "mv") and hasattr(op, "diagonal")
             and not isinstance(op, torch.Tensor))
    op = as_operator(op, dtype=torch_dtype(dtype),
                     device=op.device if is_op else dev)
    b, x0 = _vectors(op, b, x0, op.device)
    return op, b, x0, dev


def _mesh_for(mesh, dev):
    if mesh is None:
        return make_mesh(device=dev)
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh for device {dev}")
    return mesh


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
    device=None,
):
    """Distributed history run: the mesh analogue of
    :func:`~..solvers.api.run`, on ``device`` (default the CUDA card).

    Every rank returns the global output: ``'x'`` (gathered, a tensor on the
    rank's device), ``'nu'`` at the end and one numpy array per probe
    (``save_x`` / ``save_r`` rows gathered to ``(max_iter, n)``).
    """
    op, b, x0, dev = _pieces(op, b, x0, dtype, device)
    probe_fns = resolve_probes(probes)
    if _needs_x_true(probe_fns) and x_true is None:
        x_true = _compute_x_true(op, b)
    op, to_basis, from_basis = solver_basis(op)
    _check_partition(op, partition)
    b, x0 = to_basis(b), to_basis(x0)
    mesh = _mesh_for(mesh, dev)
    init_fn, step_fn, precond = _resolve(variant, op, preconditioner,
                                         w_replace, w_replace_init)
    ctx = _local_ctx_factory(op, mesh, precond, compensated)
    m, rank, rdev = op.n // mesh.size(), mesh.get_local_rank(), \
        _rank_device(mesh)
    aux = {"b": _rows(b, rank, m, rdev)}
    if _needs_x_true(probe_fns):
        aux["x_true"] = _rows(to_basis(torch.as_tensor(
            x_true, dtype=b.dtype, device=b.device)), rank, m, rdev)
    final, hist = history_scan(ctx, init_fn, step_fn, probe_fns, aux["b"],
                               _rows(x0, rank, m, rdev), max_iter, aux)
    output = {"name": variant, "max_iter": max_iter,
              "x": from_basis(_gather(final["x"], mesh)),
              "nu": final["nu"].cpu().numpy()}
    for name in probe_fns:
        h = hist[name]
        if h.ndim == 2:  # vector probe rows: (max_iter, m) on each rank
            h = from_basis(_gather(h, mesh).t()).t()
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
    device=None,
):
    """Distributed tolerance solve: the mesh analogue of
    :func:`~..solvers.api.solve`, on ``device`` (default the CUDA card).
    ``x`` is gathered on every rank."""
    op, b, x0, dev = _pieces(op, b, x0, dtype, device)
    op, to_basis, from_basis = solver_basis(op)
    _check_partition(op, partition)
    b, x0 = to_basis(b), to_basis(x0)
    mesh = _mesh_for(mesh, dev)
    init_fn, step_fn, precond = _resolve(variant, op, preconditioner)
    ctx = _local_ctx_factory(op, mesh, precond, compensated)
    m, rank, rdev = op.n // mesh.size(), mesh.get_local_rank(), \
        _rank_device(mesh)
    s, k, nrm, tol = tolerance_loop(ctx, init_fn, step_fn,
                                    _rows(b, rank, m, rdev),
                                    _rows(x0, rank, m, rdev), max_iter, rtol,
                                    atol, norm_type)
    return SolveResult(
        x=from_basis(_gather(s["x"], mesh)),
        iterations=int(k),
        norm=float(nrm),
        converged=bool(norm_type == "none" or float(nrm) <= float(tol)),
    )
