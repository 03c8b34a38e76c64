"""A host capture in place of ``graphs.CudaCapture`` for the CPU tests of
the compiled loops (``tests/test_torch_capture_loops.py``,
``tests/test_torch_dist_capture.py``).

``capture(body)`` hands back a replay that calls the body.  The body reads
and writes the same static buffers a graph would, so the loops' bookkeeping
(the first step run eagerly, whole chunks, the rest a step a replay, the
rows copied out after each replay, the tolerance loop's return to a chunk's
start) runs as on the card, with the plain versions of the kernels and the
collectives of gloo.  This module imports the port and torch only, so that
spawned gloo ranks load no JAX.
"""

import contextlib

from new_cg_variants_tpu_torch.solvers import graphs


class HostCapture:
    """A stand-in for ``graphs.CudaCapture``: ``capture(body)`` returns a
    replay that calls the body."""

    def __init__(self):
        self.captured, self.replays = [], 0

    def side(self):
        return contextlib.nullcontext()

    def keep(self, t):
        return t

    def capture(self, body):
        self.captured.append(body)

        def replay():
            body()
            self.replays += 1

        return replay


def host_runner(chunk, hooked=False, made=None):
    """A ``graphs.Runner`` of host captures (appended to ``made``)."""

    def make():
        cap = HostCapture()
        if made is not None:
            made.append(cap)
        return cap

    return graphs.Runner(make, chunk=chunk, k_on_device=hooked)
