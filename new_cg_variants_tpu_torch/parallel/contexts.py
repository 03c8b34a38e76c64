"""Mesh execution contexts on ``torch.distributed``.

The port of the JAX package's ``parallel/contexts.py``.  The reference has
two distributed structures.  PETSc's row partition
(``cg_impls/pipeprcg.c:154-173``): each rank owns a contiguous block of
``m = n / p`` rows of the operator and its slice of every vector (the row
contexts: DIA, half-band, ELL, block-banded, stencil and double-word).  The
mpi4py column partition (``scaling_experiments_mpi4py/scaling_tests.py:
51-54``): each rank owns a block of ``m`` columns of a dense matrix and the
same slice of every vector (:class:`ColShardContext`).

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

The other row contexts exchange what their products read:
:class:`EllRowShardContext` the vector entries its column indices reference
(:func:`index_exchange`, one message per active ring hop of the plan of
:mod:`.ell_exchange`; :func:`all_gather` of the whole vector without a
plan), :class:`BlockBandedRowShardContext` one ``bs``-wide block from each
neighbour and :class:`StencilRowShardContext` ``k - 1`` rows, both through
:func:`halo_exchange`.  Their products are the port's: row 12 on the
shard's cache (``ell_spmv_cache``), ``torch.matmul`` over the block
windows, the window sum of ``ops/stencil.py``.  :class:`DFRowShardContext`
carries the double-word mode: both words of a vector in one halo exchange,
row 9 on the extended words (``df_dia_spmv_ext``), and a phase's
double-word partials combined by one :func:`all_gather` and a double-word
tree over the ranks (a sum would round the high words).
:class:`ColShardContext` reduces its GEMM partials with the phase's scalars
in one :func:`all_reduce` (packed) or by :func:`reduce_scatter` beside it.

Every collective is a module function that counts its calls
(``all_reduce.calls``, ``halo_exchange.calls``, ``index_exchange.calls``,
``all_gather.calls``, ``reduce_scatter.calls``), as the kernel wrappers
count their launches: host calls, so a step captured into a CUDA graph
counts once, at capture, however often the graph is replayed.  A step
reads nothing back to the host and builds every index tensor at the
context's construction (the planned exchange's ``send_idx``), which is
what lets the mesh loops capture it (``tests/test_torch_dist_capture.py``
holds that for every context).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.compensated import comp_dot_pair, df_add
from ..ops.df_spmv import df_dia_spmv2_ext, df_dia_spmv_ext
from ..ops.doublefloat import DF, df_dot
from ..ops.ell_spmv import ell_spmv2_cache, ell_spmv_cache
from ..ops.fused_step import (
    fused_pipe_vector_phase,
    fused_pipe_vector_phase_prec,
)
from ..ops.spmv_dia import dia_spmv2_ext, dia_spmv_ext
from ..ops.stencil import window_sum
from ..ops.sym_dia import sym_dia_spmv, sym_dia_spmv2
from ..solvers.context import generic_pipe_vector_phase, with_torch_scalars

__all__ = [
    "RowShardContext",
    "ColShardContext",
    "EllRowShardContext",
    "BlockBandedRowShardContext",
    "SymDiaRowShardContext",
    "sym_dia_shard_data",
    "DFRowShardContext",
    "StencilRowShardContext",
]


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


def index_exchange(vecs, shifts, send_idx, group):
    """``[v | hop payloads]`` of each local vector of ``vecs``, as the rows
    of one ``(len(vecs), m + sum_s C_s)`` tensor: the cache the remapped ELL
    indices point into (:func:`~.ell_exchange.plan_ell_exchange`).

    For each active hop ``s`` of ``shifts`` this rank sends its entries
    ``v[send_idx[j]]`` (all vectors in one message) to rank ``(r + s) % p``
    and receives the ``C_s`` entries rank ``(r - s) % p`` sends into the
    hop's slots; every hop is posted in one ``batch_isend_irecv``.
    """
    index_exchange.calls += 1
    m = vecs[0].shape[0]
    counts = [len(idx) for idx in send_idx]
    out = vecs[0].new_empty((len(vecs), m + sum(counts)))
    for row, v in zip(out, vecs):
        row[:m] = v
    if not shifts:
        return out
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    stacked = torch.stack(vecs)
    ops, recvs, base = [], [], m
    for s, idx, c in zip(shifts, send_idx, counts):
        to = dist.get_global_rank(group, (rank + s) % size)
        frm = dist.get_global_rank(group, (rank - s) % size)
        buf = out.new_empty((len(vecs), c))
        ops += [dist.P2POp(dist.isend, stacked[:, idx].contiguous(), to,
                           group),
                dist.P2POp(dist.irecv, buf, frm, group)]
        recvs.append((slice(base, base + c), buf))
        base += c
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for slot, buf in recvs:
        out[:, slot] = buf
    return out


def all_gather(buf, group, async_op=False):
    """Every rank's ``buf`` stacked along a new first axis, ``(p,) +
    buf.shape``; with ``async_op`` returns ``(out, work)``, ``out`` valid
    after ``work.wait()``."""
    all_gather.calls += 1
    size = dist.get_world_size(group)
    out = buf.new_empty((size * buf.shape[0],) + tuple(buf.shape[1:]))
    work = dist.all_gather_into_tensor(out, buf.contiguous(), group=group,
                                       async_op=async_op)
    out = out.view((size,) + tuple(buf.shape))
    return (out, work) if async_op else out


def reduce_scatter(partial, group):
    """The sum over the ranks of ``partial`` (``(n,)`` or ``(n, k)``), of
    which this rank keeps its block of ``n / p`` rows."""
    reduce_scatter.calls += 1
    size = dist.get_world_size(group)
    out = partial.new_empty((partial.shape[0] // size,)
                            + tuple(partial.shape[1:]))
    dist.reduce_scatter_tensor(out, partial.contiguous(), group=group)
    return out


COLLECTIVES = (all_reduce, halo_exchange, index_exchange, all_gather,
               reduce_scatter)
for _fn in COLLECTIVES:
    _fn.calls = 0


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

    A subclass sets its operator's data (and ``h``, the halo width, where
    it calls :meth:`_halo_extend`) and defines ``mv`` / ``mv2``.
    """

    precond = None
    compensated = False
    #: ``"r"`` / ``"rt"`` when a tolerance solve's norm rides the dot batch
    #: (set by :func:`~..solvers.engine.tolerance_loop`)
    extra_norm = None

    def __init__(self, group, precond=None, compensated=False):
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

    def pipe_full_step(self, s_, meurant, recompute):
        """The unpreconditioned pipe iteration with its all-reduce under the
        SpMV (:meth:`_pipe_iteration`), between torch's scalars
        (:func:`~..solvers.context.with_torch_scalars`)."""
        return with_torch_scalars(self._pipe_iteration, s_, meurant,
                                  recompute)

    def _pipe_iteration(self, s_, a1, beta, recompute):
        """The operations of
        :func:`~..solvers.context.split_pipe_full_step`, in its return
        order, with the dots' all-reduce started before the SpMV."""
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
        super().__init__(group, precond, compensated)
        self.offsets = tuple(int(o) for o in offsets)
        self.local_data = local_data
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
        super().__init__(group, precond, compensated)
        self.offsets = tuple(int(o) for o in offsets)
        self.local_data = local_data
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


class EllRowShardContext(_MeshContext):
    """Row-partitioned padded-ELL operator for general sparse matrices.

    ``local_val`` / ``local_idx`` are this rank's ``(m, L)`` rows, views of
    slot-major storage (row 12 reads slot l of neighbouring rows in one
    coalesced load).  Two ways to bring in the vector entries of other
    ranks:

    * **index exchange** (``shifts`` a tuple, from
      :func:`~.ell_exchange.plan_ell_exchange`): ``local_idx`` holds cache
      coordinates (the plan's ``idx_remap``) and ``send_idx`` this rank's
      row of each hop's request list; :func:`index_exchange` fills the
      cache ``[own rows | hop payloads]``, the PETSc ``VecScatter``;
    * **all-gather** (``shifts=None``, the planner's ``None``): the cache is
      the whole vector and ``local_idx`` holds global indices.

    The rows come in the original numbering, or, with ``order = (perm,
    cols)`` (the all-gather route of an operator kept in a locality order,
    ``dist.py:_ell_locality_shard``), in that order: row i is the shard's
    row ``perm[i]`` and ``local_idx`` points into ``cache[cols]``, the
    columns the rows touch in the same order.  Neighbouring rows then
    gather neighbouring entries, as in the single-device product, and each
    product gives the original numbering's bits.

    Both right-hand sides of ``mv2`` ride one exchange.  The product is row
    12 on the cache (:func:`~..ops.ell_spmv.ell_spmv_cache`; in a locality
    order one gather in first).
    """

    def __init__(self, local_val, local_idx, group, precond=None,
                 compensated=False, shifts=None, send_idx=(), order=()):
        super().__init__(group, precond, compensated)
        self.local_val = local_val
        self.local_idx = local_idx
        self.shifts = None if shifts is None else tuple(shifts)
        self.send_idx = tuple(send_idx)
        self.order = tuple(order)

    def _cache(self, *vecs):
        """The rows of ``(len(vecs), c)``: each vector's gather target."""
        if self.shifts is None:
            g = all_gather(torch.stack(vecs), self.group)  # (p, k, m)
            return g.transpose(0, 1).reshape(len(vecs), -1)
        return index_exchange(vecs, self.shifts, self.send_idx, self.group)

    def mv(self, v):
        (cache,) = self._cache(v)
        return ell_spmv_cache(self.local_val, self.local_idx, cache,
                              *self.order)

    def mv2(self, v, w):
        cv, cw = self._cache(v, w)  # one exchange carries both
        return ell_spmv2_cache(self.local_val, self.local_idx, cv, cw,
                               *self.order)


class BlockBandedRowShardContext(_MeshContext):
    """Row-partitioned block-banded operator: each rank owns ``nb / p``
    block rows ``local_blk`` (``(nb_local, bs, 3 bs)``) and the matching
    ``nb_local * bs`` rows of every vector.

    The block-tridiagonal coupling makes the halo one ``bs``-wide block from
    each neighbour (:func:`halo_exchange` with ``h = bs``; the edge ranks'
    zeros are the operator's zero end blocks).  The product is
    ``torch.matmul`` over the sliding block windows, as
    :class:`~..ops.block_banded.BlockBandedOperator`'s, bf16 blocks widened
    to the vectors' float32 at the product.
    """

    def __init__(self, local_blk, group, precond=None, compensated=False):
        super().__init__(group, precond, compensated)
        self.local_blk = local_blk
        self.h = local_blk.shape[1]

    def _product(self, ext):
        """``A_shard @ v`` of each row of ``ext`` (``(k, m + 2 bs)``), as the
        columns of ``(m, k)``."""
        nb, bs = self.local_blk.shape[0], self.h
        k = ext.shape[0]
        vp = ext.T.reshape(nb + 2, bs, k)
        win = torch.cat([vp[:-2], vp[1:-1], vp[2:]], dim=1)  # (nb, 3bs, k)
        return torch.matmul(self.local_blk.to(ext.dtype), win).reshape(-1, k)

    def mv(self, v):
        return self._product(self._halo_extend(v))[:, 0]

    def mv2(self, v, w):
        y = self._product(self._halo_extend(v, w))  # one message each way
        return y[:, 0], y[:, 1]


class StencilRowShardContext(_MeshContext):
    """Row-partitioned matrix-free constant-band stencil
    (:class:`~..ops.stencil.BandedStencilOperator`): each rank holds its
    slice of the diagonal and the scalar ``off_value``; the product is the
    window sum on the halo-extended vector (``h = k - 1``), rows ``[h, h +
    m)`` kept."""

    def __init__(self, local_diag, off_value, k, group, precond=None,
                 compensated=False):
        super().__init__(group, precond, compensated)
        self.local_diag = local_diag
        self.off_value = off_value
        self.k = int(k)
        self.h = self.k - 1

    def _mv_row(self, vext):
        h, m = self.h, self.local_diag.shape[0]
        w = window_sum(vext, self.k)[h:h + m]
        return ((self.local_diag - self.off_value) * vext[h:h + m]
                + self.off_value * w)

    def mv(self, v):
        (vext,) = self._halo_extend(v)
        return self._mv_row(vext)

    def mv2(self, v, w):
        vw = self._halo_extend(v, w)  # one message carries both
        return self._mv_row(vw[0]), self._mv_row(vw[1])


class _PendingGather:
    """A started all-gather of a phase's double-word partials; :meth:`wait`
    returns its ``k`` global dots."""

    def __init__(self, parts, k, group):
        self.k = k
        self.out, self.work = all_gather(parts, group, async_op=True)

    def wait(self):
        self.work.wait()
        return _df_combine(self.out, self.k)


def _df_combine(g, k):
    """The ``k`` double-word sums over the ranks of ``g`` (``(P, 2k)``: each
    rank's high words, then its low words), by the double-word halving tree
    over ``P`` padded with zero pairs to a power of two."""
    hi, lo = g[:, :k], g[:, k:]
    width = 1
    while width < hi.shape[0]:
        width *= 2
    if width != hi.shape[0]:
        pad = hi.new_zeros((width - hi.shape[0], k))
        hi, lo = torch.cat([hi, pad]), torch.cat([lo, pad])
    while width > 1:
        half = width // 2
        hi, lo = df_add(hi[:half], lo[:half], hi[half:], lo[half:])
        width = half
    return tuple(DF(hi[0, i], lo[0, i]) for i in range(k))


class DFRowShardContext(_MeshContext):
    """Row-partitioned double-word (f32x2) DIA context: the distributed
    accuracy mode.

    Vectors are :class:`~..ops.doublefloat.DF` pairs of the rank's rows; the
    operator is the exact three-word split, ``(ndiag, m)`` slices of its
    word arrays.  A product sends both words of a vector in one halo
    exchange (``mv2``: four rows) and runs row 9 on the extended words
    (:func:`~..ops.df_spmv.df_dia_spmv_ext`, the terms in the JAX package's
    ``_mv_ext`` order, which is ``DFOperator._mv_dia``'s).  A phase's dots
    are the local double-word partials (:func:`~..ops.doublefloat.df_dot`)
    gathered by one :func:`all_gather` of the ``(2k,)`` buffer and summed by
    the double-word halving tree over the ranks (:func:`_df_combine`): an
    all-reduce would round the high words in float32.  The vector phases
    take the generic double-word steps (the JAX package's row context has
    no fused one); the pipe step still starts its gather before the products.
    """

    def __init__(self, offsets, local_hi, local_lo, local_lo2, group,
                 precond=None):
        super().__init__(group, precond)
        self.offsets = tuple(int(o) for o in offsets)
        self.words = (local_hi, local_lo, local_lo2)
        self.h = max(abs(o) for o in self.offsets)

    def mv(self, v):
        ext = self._halo_extend(v.hi, v.lo)  # both words, one message
        return DF(*df_dia_spmv_ext(self.offsets, *self.words,
                                   (ext[0], ext[1])))

    def mv2(self, v, w):
        ext = self._halo_extend(v.hi, v.lo, w.hi, w.lo)  # one message
        y, z = df_dia_spmv2_ext(self.offsets, *self.words, (ext[0], ext[1]),
                                (ext[2], ext[3]))
        return DF(*y), DF(*z)

    def _partials(self, pairs):
        parts = [df_dot(a, b) for a, b in pairs]
        return torch.stack([p.hi for p in parts] + [p.lo for p in parts])

    def _start(self, parts, k):
        return _PendingGather(parts, k, self.group)

    def _reduce(self, parts, k):
        return _df_combine(all_gather(parts, self.group), k)

    def norm(self, v):
        (sq,) = self.dots((v, v))
        return torch.sqrt(torch.abs(sq.value()))


class ColShardContext(_MeshContext):
    """Column-partitioned dense operator (the mpi4py structure).

    ``local_a`` is this rank's ``(n, m)`` column block; every vector lives
    as its ``(m,)`` slice.  A product is the local GEMM partial
    (``torch.matmul``; ``mv2`` both right-hand sides in one ``(m, 2)`` GEMM,
    the reference's ``np.dot(A, [r|s])``, ``cg_variants/pipe_pr_cg.py:65``)
    summed over the ranks, of which the rank keeps its slice.

    ``packed=True``: a sync phase's GEMM partials and scalar partials
    (compensated pairs included) ride one :func:`all_reduce` buffer, the
    reference's single ``Allreduce`` (``cg_variants/gv_cg.py:29-38``,
    ``pipe_pr_cg.py:24-45``): gv and the pipe names pay one collective an
    iteration.  ``packed=False``: the product by :func:`reduce_scatter`
    (half the traffic) beside the scalars' own all-reduce, started before
    it.
    """

    def __init__(self, local_a, group, precond=None, compensated=False,
                 packed=True):
        super().__init__(group, precond, compensated)
        self.local_a = local_a
        self.packed = packed
        n, m = local_a.shape
        lo = dist.get_rank(group) * m
        self._rows = slice(lo, lo + m)

    def _gemm(self, x):
        """The local partial ``A[:, cols] @ x`` (bf16 storage widened to the
        vectors' float32)."""
        return self.local_a.to(x.dtype) @ x

    def mv(self, v):
        return reduce_scatter(self._gemm(v), self.group)

    def mv2(self, v, w):
        out = reduce_scatter(self._gemm(torch.stack([v, w], dim=1)),
                             self.group)
        y, z = out.T.contiguous()
        return y, z

    def _packed_reduce(self, partial, pairs):
        """One all-reduce of ``[partial | scalar partials]``; returns the
        summed partial's rows and the dots."""
        n = partial.shape[0]
        buf = torch.cat([partial, self._partials(pairs)])
        all_reduce(buf, self.group)
        return buf[:n], _split(buf[n:], len(pairs), self.compensated)

    def mv_dots(self, v, pairs):
        if not self.packed:
            return super().mv_dots(v, pairs)
        out, dots = self._packed_reduce(self._gemm(v), pairs)
        return out[self._rows], dots

    def mv2_dots(self, v, w, pairs):
        if not self.packed:
            return super().mv2_dots(v, w, pairs)
        partial = self._gemm(torch.stack([v, w], dim=1))  # (n, 2)
        n = partial.shape[0]
        out, dots = self._packed_reduce(partial.T.reshape(-1), pairs)
        return out[:n][self._rows], out[n:][self._rows], dots

    def _pipe_iteration(self, s_, a1, beta, recompute):
        """The unpreconditioned pipe iteration; packed, with the single
        all-reduce of the mpi4py ``pipe_pr_cg`` hot loop
        (``pipe_pr_cg.py:58-83``): vector updates, then one buffer with the
        2-RHS GEMM partials and the four scalars."""
        if not self.packed:
            return super()._pipe_iteration(s_, a1, beta, recompute)
        x = s_["x"] + a1 * s_["p"]
        r = s_["r"] - a1 * s_["s"]
        w = s_["w"] - a1 * s_["u"]
        p = r + beta * s_["p"]
        s = w + beta * s_["s"]
        pairs = ((p, s), (r, s), (s, s), (r, r))
        if recompute:
            u, w, d = self.mv2_dots(s, r, pairs)
        else:
            u, d = self.mv_dots(s, pairs)
        return x, r, w, p, s, u, d
