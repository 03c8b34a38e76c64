"""Index-based neighbour exchange for the row-partitioned ELL SpMV.

The port of the JAX package's ``parallel/ell_exchange.py`` (host numpy,
copied: the plans are the same, array for array).  The reference's
general-matrix distributed SpMV is PETSc ``mpiaij``: ``MatMult`` scatters
only the off-process vector entries each rank's column map references
(``VecScatter``, inside the overlapped hot region of
``cg_impls/pipeprcg.c:162-170``), so the traffic is O(interface), not O(n).

* At partition time (host, numpy) :func:`plan_ell_exchange` walks the ELL
  column-index array once and computes, for every ordered pair of ranks,
  the rows the requester needs from the owner.  Requests are grouped by
  *ring hop* (owner -> owner + s mod P), so the exchange is one message
  per rank and active hop (all hops posted together by
  :func:`~.contexts.index_exchange`), each hop's payload padded to the
  hop's largest request.
* The ELL index array is remapped once into *cache coordinates*: local
  rows first, then the received entries hop by hop.  The SpMV then
  gathers from the local cache only.

Degenerate sparsity (some rank referencing nearly everything) makes the
padded hop traffic exceed a plain all-gather; :func:`plan_or_none` measures
both and returns ``None`` when the all-gather is cheaper, which the caller
takes as "gather the whole vector".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["ExchangePlan", "plan_ell_exchange", "plan_or_none"]


@dataclass(frozen=True)
class ExchangePlan:
    """Static exchange schedule for a P-way row partition.

    ``shifts``
        tuple of active ring hops ``s`` (data moves owner → owner+s mod P).
    ``send_idx``
        one ``(P, C_s)`` int32 array per hop: row ``o`` holds the LOCAL
        row indices device ``o`` gathers and sends to device
        ``(o+s) % P``, padded with 0 (receivers never read pad slots).
    ``idx_remap``
        ``(n, L)`` int32, the ELL index array rewritten into cache
        coordinates: ``[0, m)`` = own rows, then hop payloads in
        ``shifts`` order.
    ``recv_total``
        per-device cache tail length, ``sum_s C_s``.
    """

    shifts: tuple
    send_idx: tuple  # of np.ndarray (P, C_s) int32
    idx_remap: np.ndarray  # (n, L) int32
    recv_total: int


def plan_ell_exchange(idx, n: int, p: int) -> ExchangePlan:
    """Build the exchange schedule from a global ELL index array.

    ``idx``: (n, L) global column indices (padding slots self-reference
    their own row, so they never generate traffic).  Rows are owned in
    ``p`` contiguous blocks of ``m = n // p``.
    """
    idx = np.asarray(idx)
    if n % p:
        raise ValueError(f"n={n} not divisible by p={p}")
    m = n // p
    owner_of = lambda g: g // m  # noqa: E731

    # requests[q][o] = sorted unique global indices device q needs from o
    requests = [[None] * p for _ in range(p)]
    row_owner = np.repeat(np.arange(p), m)[:, None]  # (n, 1)
    col_owner = idx // m
    for q in range(p):
        blk = idx[q * m : (q + 1) * m]
        remote = blk[col_owner[q * m : (q + 1) * m] != q]
        if remote.size:
            for o in np.unique(remote // m):
                requests[q][int(o)] = np.unique(remote[remote // m == o])

    # group by ring hop s = (q - o) mod p; pad each hop to its max count
    shifts, send_idx, hop_of = [], [], {}
    for s in range(1, p):
        counts = [
            0 if requests[(o + s) % p][o] is None
            else len(requests[(o + s) % p][o])
            for o in range(p)
        ]
        c = max(counts)
        if c == 0:
            continue
        hop_of[s] = len(shifts)
        send = np.zeros((p, c), dtype=np.int32)
        for o in range(p):
            r = requests[(o + s) % p][o]
            if r is not None:
                send[o, : len(r)] = (r - o * m).astype(np.int32)
        shifts.append(s)
        send_idx.append(send)

    counts = [a.shape[1] for a in send_idx]
    base = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    recv_total = int(base[-1])

    # remap the index array into per-device cache coordinates
    remap = np.empty_like(idx, dtype=np.int32)
    own = col_owner == row_owner
    remap[own] = (idx[own] - (row_owner * m)[own.nonzero()[0], 0]).astype(np.int32)
    for q in range(p):
        lo, hi = q * m, (q + 1) * m
        blk_own = own[lo:hi]
        if blk_own.all():
            continue
        blk = idx[lo:hi]
        where = (~blk_own).nonzero()
        g = blk[where]
        o = g // m
        s = (q - o) % p
        hop_slot = np.array([hop_of[int(sv)] for sv in s])
        pos = np.empty(len(g), dtype=np.int64)
        for o_u in np.unique(o):
            sel = o == o_u
            pos[sel] = np.searchsorted(requests[q][int(o_u)], g[sel])
        remap[lo:hi][where] = (m + base[hop_slot] + pos).astype(np.int32)

    return ExchangePlan(tuple(shifts), tuple(send_idx), remap, recv_total)


def plan_or_none(idx, n: int, p: int, margin: float = 0.5):
    """Plan the exchange, or ``None`` when all-gather is the better deal.

    Padded per-device exchange traffic (``sum_s C_s``) is compared
    against the ``all_gather`` volume (``n - m`` received per device).
    The plan pays a message per active hop where the
    all-gather pays one collective, so it must win by a real ``margin``
    (default: traffic at most half the all-gather) — near-ties go to the
    single-collective dense exchange.
    """
    plan = plan_ell_exchange(idx, n, p)
    if plan.recv_total >= margin * (n - n // p):
        return None
    return plan
