"""Mesh execution contexts on ``torch.distributed``: the row partition.

The port of the JAX package's ``parallel/contexts.py`` (row contexts).  The
reference's distributed structure is PETSc's row partition
(``cg_impls/pipeprcg.c:154-173``): each rank owns a contiguous block of
``m = n / p`` rows of the operator and its slice of every vector.

* **Halo exchange.** A product gathers a halo of width ``h`` (the band's
  reach) from each neighbour in two non-circular hops
  (:func:`halo_exchange`, ``torch.distributed.batch_isend_irecv``): edge
  ranks get zeros, which is the matrix's boundary condition, and no message
  goes to a missing neighbour (at world size 1 none is posted).  The two
  right-hand sides of ``mv2`` ride one message, stacked as ``(2, m)`` rows.
* **One all-reduce per synchronization phase.** ``dots`` stacks the local
  partials of a phase into one tensor and sums it over the ranks with one
  :func:`all_reduce`; with compensated dots the ``(value, error)`` pairs ride
  the same buffer.
* **Overlap by hand.** XLA overlaps the JAX package's reduction with the
  SpMV on its own; eager PyTorch does it explicitly, as PETSc's
  ``VecDotBegin / MatMult / VecDotEnd`` does: ``mv_dots``, ``mv2_dots``,
  :meth:`_MeshContext.pipe_full_step` and
  :meth:`RowShardContext.pipe_full_step_prec` start the all-reduce
  (``async_op=True``), run the halo exchange and the local SpMV, and then
  wait.  No scalar is read before its wait (NCCL reduces on its own stream).

The local products are the port's kernels at new shapes: the DIA SpMV on
halo-extended vectors (``dia_spmv_ext`` / ``dia_spmv2_ext``, row 3), the
half-band SpMV on an extended slice of ``m + 2h`` rows (row 1), and the pipe
vector phases (rows 4 and 5) on ``m`` rows.  Every other fused hook of
:class:`~..solvers.context.Context` declines here (returns ``None``), so each
family takes its generic body over ``mv`` / ``mv2`` / ``dots``.

Both collectives are module functions that count their calls
(``all_reduce.calls``, ``halo_exchange.calls``), as the kernel wrappers count
their launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.compensated import comp_dot_pair
from ..ops.fused_step import (
    fused_pipe_vector_phase,
    fused_pipe_vector_phase_prec,
)
from ..ops.spmv_dia import dia_spmv2_ext, dia_spmv_ext
from ..ops.sym_dia import sym_dia_spmv, sym_dia_spmv2
from ..solvers.context import generic_pipe_vector_phase

__all__ = ["RowShardContext", "SymDiaRowShardContext", "sym_dia_shard_data",
           "all_reduce", "halo_exchange"]


def all_reduce(buf, group, async_op=False):
    """Sum ``buf`` over the ranks of ``group`` in place: the one collective
    of a synchronization phase.  With ``async_op`` returns the work handle
    to ``wait()`` on."""
    all_reduce.calls += 1
    return dist.all_reduce(buf, group=group, async_op=async_op)


def halo_exchange(vecs, h, group):
    """``[left halo | v | right halo]`` of each local vector of ``vecs``, as
    the rows of one contiguous ``(len(vecs), m + 2h)`` tensor.

    Rank ``r`` sends its first ``h`` rows to ``r - 1`` and its last ``h`` to
    ``r + 1``, all vectors in one message each way; the halo slots of an
    edge rank stay zero.  ``h`` must not exceed ``m``.
    """
    halo_exchange.calls += 1
    m = vecs[0].shape[0]
    out = vecs[0].new_zeros((len(vecs), m + 2 * h))
    for row, v in zip(out, vecs):
        row[h:h + m] = v
    if h == 0:
        return out
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    ops, recvs = [], []
    for peer, send, slot in ((rank - 1, slice(h, 2 * h), slice(0, h)),
                             (rank + 1, slice(m, m + h),
                              slice(m + h, m + 2 * h))):
        if 0 <= peer < size:
            glob = dist.get_global_rank(group, peer)
            buf = out.new_empty((len(vecs), h))
            ops += [dist.P2POp(dist.isend, out[:, send].contiguous(), glob,
                               group),
                    dist.P2POp(dist.irecv, buf, glob, group)]
            recvs.append((slot, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for slot, buf in recvs:
            out[:, slot] = buf
    return out


all_reduce.calls = 0
halo_exchange.calls = 0


class _Pending:
    """A started all-reduce of a phase's stacked partials; :meth:`wait`
    returns its ``k`` global dots."""

    def __init__(self, parts, k, compensated, group):
        self.parts, self.k, self.compensated = parts, k, compensated
        self.work = all_reduce(parts, group, async_op=True)

    def wait(self):
        self.work.wait()
        return _split(self.parts, self.k, self.compensated)


def _split(summed, k, compensated):
    if compensated:
        return tuple(summed[i] + summed[k + i] for i in range(k))
    return tuple(summed.unbind(0))


class _MeshContext:
    """What every row context shares: the preconditioner, the batched
    reductions, the overlapped phases and the fused hooks that decline.

    A subclass sets ``offsets``, ``local_data``, ``group``, ``h`` and
    defines ``mv`` / ``mv2``.
    """

    precond = None
    compensated = False
    #: ``"r"`` / ``"rt"`` when a tolerance solve's norm rides the dot batch
    #: (set by :func:`~..solvers.engine.tolerance_loop`)
    extra_norm = None

    def __init__(self, offsets, local_data, group, precond=None,
                 compensated=False):
        self.offsets = tuple(int(o) for o in offsets)
        self.local_data = local_data
        self.group = group
        self.precond = precond
        self.compensated = compensated

    @property
    def has_prec(self) -> bool:
        return self.precond is not None

    def prec(self, v):
        return self.precond.apply(v) if self.precond is not None else v

    def _halo_extend(self, *vecs):
        return halo_exchange(vecs, self.h, self.group)

    def _partials(self, pairs):
        """The local partials of a phase, stacked: ``k`` dots, or with
        compensated dots ``k`` values then ``k`` errors."""
        if self.compensated:
            vals, errs = zip(*(comp_dot_pair(a, b) for a, b in pairs))
            return torch.stack(vals + errs)
        return torch.stack([torch.dot(a, b) for a, b in pairs])

    def _start(self, parts, k):
        return _Pending(parts, k, self.compensated, self.group)

    def _reduce(self, parts, k):
        all_reduce(parts, self.group)
        return _split(parts, k, self.compensated)

    def dots(self, *pairs):
        """One synchronization phase: the pairs' local partials summed over
        the ranks by one all-reduce."""
        return self._reduce(self._partials(pairs), len(pairs))

    def norm(self, v):
        (sq,) = self.dots((v, v))
        return torch.sqrt(sq)

    def mv_dots(self, v, pairs):
        """``(A v, dots(pairs))``: the all-reduce runs under the SpMV."""
        pending = self._start(self._partials(pairs), len(pairs))
        y = self.mv(v)
        return y, pending.wait()

    def mv2_dots(self, v, w, pairs):
        """``(A v, A w, dots(pairs))``: the all-reduce runs under the
        SpMV."""
        pending = self._start(self._partials(pairs), len(pairs))
        y, z = self.mv2(v, w)
        return y, z, pending.wait()

    def _pipe_vector_partials(self, x, r, w, u, p, s, a1, beta):
        """The unpreconditioned pipe vector phase with its four dots left as
        stacked local partials."""
        x2 = x + a1 * p
        r2 = r - a1 * s
        w2 = w - a1 * u
        p2 = r2 + beta * p
        s2 = w2 + beta * s
        parts = self._partials(((p2, s2), (r2, s2), (s2, s2), (r2, r2)))
        return x2, r2, w2, p2, s2, parts

    def pipe_vector_phase(self, x, r, w, u, p, s, a1, beta):
        return generic_pipe_vector_phase(self, x, r, w, u, p, s, a1, beta)

    def pipe_full_step(self, s_, a1, beta, recompute):
        """The unpreconditioned pipe iteration with its all-reduce under the
        SpMV: the operations of
        :func:`~..solvers.context.split_pipe_full_step`, in its return
        order."""
        x, r, w, p, s, parts = self._pipe_vector_partials(
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"], a1, beta)
        pending = self._start(parts, 4)
        if recompute:
            u, w = self.mv2(s, r)
        else:
            u = self.mv(s)
        return x, r, w, p, s, u, pending.wait()

    def pipe_vector_phase_prec(self, s_, a1, beta):
        return None

    def pipe_full_step_prec(self, s_, a1, beta, recompute):
        return None

    def hs_matvec_phase(self, rt, p, beta):
        return None

    def pr_full_step(self, s_, a1, beta):
        return None

    def pr_full_step_prec(self, s_, a1, beta):
        return None

    def cgcg_matvec_phase(self, s_, a1):
        return None

    def cgcg_matvec_phase_prec(self, s_, a1):
        return None

    def gv_matvec_phase(self, s_, a1):
        return None

    def gv_matvec_phase_prec(self, s_, a1):
        return None


class RowShardContext(_MeshContext):
    """Row-partitioned DIA operator.

    ``local_data`` is this rank's ``(ndiags, m)`` slice of the global
    row-indexed DIA array; ``h = max|offset|`` must not exceed ``m``.  The
    pipe vector phases run as one kernel pass (rows 4 and 5) whose four
    partials ride the phase's one all-reduce, under the same conditions as
    on one device: not with compensated dots, and the preconditioned one not
    while a norm rides the dot batch.
    """

    def __init__(self, offsets, local_data, group, precond=None,
                 compensated=False):
        super().__init__(offsets, local_data, group, precond, compensated)
        self.h = max(abs(o) for o in self.offsets)

    def mv(self, v):
        (vext,) = self._halo_extend(v)
        return dia_spmv_ext(self.offsets, self.local_data, vext)

    def mv2(self, v, w):
        vw = self._halo_extend(v, w)  # one message carries both
        return dia_spmv2_ext(self.offsets, self.local_data, vw[0], vw[1])

    def _pipe_vector_partials(self, x, r, w, u, p, s, a1, beta):
        if self.compensated:
            return super()._pipe_vector_partials(x, r, w, u, p, s, a1, beta)
        *vecs, dots = fused_pipe_vector_phase(x, r, w, u, p, s, a1, beta)
        return (*vecs, torch.stack(dots))

    def pipe_vector_phase(self, x, r, w, u, p, s, a1, beta):
        *vecs, parts = self._pipe_vector_partials(x, r, w, u, p, s, a1, beta)
        return (*vecs, self._reduce(parts, 4))

    def _prec_vector_partials(self, s_, a1, beta):
        """The fused preconditioned vector phase with its partials stacked,
        or ``None`` where the kernel's dot batch would not be the phase's."""
        if self.compensated or self.extra_norm is not None:
            return None
        *vecs, dots = fused_pipe_vector_phase_prec(
            s_["x"], s_["r"], s_["w"], s_["u"], s_["p"], s_["s"],
            s_["rt"], s_["st"], s_["wt"], s_["ut"], a1, beta)
        return (*vecs, torch.stack(dots))

    def pipe_vector_phase_prec(self, s_, a1, beta):
        """Preconditioned vector phase (row 5) + its one all-reduce."""
        out = self._prec_vector_partials(s_, a1, beta)
        return out and (*out[:-1], self._reduce(out[-1], 4))

    def pipe_full_step_prec(self, s_, a1, beta, recompute):
        """The preconditioned pipe iteration: row 5, the all-reduce started,
        the products and PCApplies under it.  Returns the family's fused
        tuple ``(x, r, w, p, s, u, rt, st, wt, ut, dots)``, or ``None``."""
        out = self._prec_vector_partials(s_, a1, beta)
        if out is None:
            return None
        x, r, w, rt, wt, p, s, st_, parts = out
        pending = self._start(parts, 4)
        if recompute:
            u, w = self.mv2(st_, rt)
            wt = self.prec(w)
        else:
            u = self.mv(st_)
        ut = self.prec(u)
        return x, r, w, p, s, u, rt, st_, wt, ut, pending.wait()


def sym_dia_shard_data(data, p, h, rank):
    """Rank ``rank``'s EXTENDED half-band slice ``(ndiags, m + 2h)`` for
    :class:`SymDiaRowShardContext`: the global half-band's columns ``[rank m
    - h, (rank + 1) m + h)``, zeros outside ``[0, n)``, on ``data``'s
    device.

    The mirror term of the shard's first rows reads the previous rank's
    tail, and the discarded extension touches the next rank's head; a rank
    copies only its own slice.
    """
    ndiags, n = data.shape
    m = n // p
    lo, hi = rank * m - h, (rank + 1) * m + h
    out = data.new_zeros((ndiags, m + 2 * h))
    out[:, max(lo, 0) - lo: min(hi, n) - lo] = data[:, max(lo, 0): min(hi, n)]
    return out


class SymDiaRowShardContext(_MeshContext):
    """Row-partitioned symmetric half-band operator (half the matrix traffic
    of the DIA row shard, the same halo structure).

    ``local_data`` is the rank's extended slice (:func:`sym_dia_shard_data`).
    The local product runs the half-band SpMV on the ``m + 2h`` rows of the
    halo-extended vector: evaluated there, the mirror formulation is the
    global operator restricted to the shard on rows ``[h, h + m)``, which
    are kept.  The extension's first ``h`` rows have no mirror source and
    get a zero; they are discarded.
    """

    def __init__(self, offsets, local_data, group, precond=None,
                 compensated=False):
        super().__init__(offsets, local_data, group, precond, compensated)
        self.h = max(self.offsets)
        self.m = local_data.shape[1] - 2 * self.h

    def mv(self, v):
        (vext,) = self._halo_extend(v)
        h = self.h
        return sym_dia_spmv(self.offsets, self.local_data, vext)[h:h + self.m]

    def mv2(self, v, w):
        vw = self._halo_extend(v, w)  # one message carries both
        h, m = self.h, self.m
        y, z = sym_dia_spmv2(self.offsets, self.local_data, vw[0], vw[1])
        return y[h:h + m], z[h:h + m]
