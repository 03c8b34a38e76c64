"""The traffic generator: right-hand sides and the sample of answers, from
``--seed``.

Every mix (``mixes/<name>.json``) is a closed loop of one caller, each call
a solve of ``A x = b`` for a fresh ``b``.  Call ``i`` takes right-hand side
``i mod pool``: ``b = A x`` with ``x`` standard normal, drawn in blocks of
:data:`BLOCK` from a generator seeded by ``(seed, block)`` on the device,
and ``A x`` the reference's float64 product, rounded to the program's
dtype.  So a seed fixes every right-hand side, and the same ``x`` can be
drawn again after the window to judge the answers.  Every seed gives the
same sizes and the same number of calls' work; only the values differ.
"""

from __future__ import annotations

import hashlib
import random

import torch

__all__ = ["BLOCK", "substream", "solutions", "solution", "rhs_pool",
           "Reservoir"]

#: right-hand sides drawn by one generator
BLOCK = 16


def substream(seed, *tags):
    """A 63-bit seed for the stream ``tags`` of ``--seed`` (any integer,
    also beyond 64 bits)."""
    text = ":".join(str(t) for t in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def _block(seed, j, n, device):
    g = torch.Generator(device=device)
    g.manual_seed(substream(seed, "rhs", j))
    return torch.randn(BLOCK, n, generator=g, device=device,
                       dtype=torch.float64)


def solutions(seed, n, count, device):
    """``(start, x)`` blocks of the first ``count`` solutions, ``x`` of
    shape ``(m, n)`` in float64."""
    for j in range(-(-count // BLOCK)):
        x = _block(seed, j, n, device)
        yield j * BLOCK, x[:min(BLOCK, count - j * BLOCK)]


def solution(seed, n, i, device):
    """Solution ``i`` (float64), drawn again."""
    return _block(seed, i // BLOCK, n, device)[i % BLOCK]


def rhs_pool(seed, n, count, matvec, dtype, device):
    """``(count, n)`` right-hand sides ``A x_i`` in ``dtype``."""
    pool = torch.empty(count, n, dtype=dtype, device=device)
    for start, x in solutions(seed, n, count, device):
        pool[start:start + len(x)] = matvec(x.T.contiguous()).T.to(dtype)
    return pool


class Reservoir:
    """A uniform sample of at most ``size`` answers of a window whose
    length is not known beforehand, drawn from the seed."""

    def __init__(self, size, seed):
        self.size = int(size)
        self.rng = random.Random(substream(seed, "sample"))
        self.items = {}
        self.seen = 0

    def offer(self, key, value):
        if len(self.items) < self.size:
            self.items[key] = value
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                del self.items[sorted(self.items)[j]]
                self.items[key] = value
        self.seen += 1
