"""What the traced run reads from inside the program, without editing it.

* ``graphs.runner`` wrapped, so that each :class:`CudaCapture` a solve makes
  is kept and its ``capture_seconds`` / ``instantiate_seconds`` read after
  the call (the counters ``capture_ms.*`` report);
* host spans (``torch.profiler.record_function``) around a solve's loop
  start, each capture and each replay, by which the profile's idle gaps are
  labelled.

Installed for the traced run only, after the warm-up; :meth:`Hooks.remove`
puts every wrapped name back.
"""

from __future__ import annotations

import functools

from torch.profiler import record_function

__all__ = ["Hooks", "SPANS"]

#: span name -> (module path, attribute path) of the wrapped callable
SPANS = {
    "loop.start": ("new_cg_variants_tpu_torch.solvers.graphs", "Runner.start"),
    "capture": ("new_cg_variants_tpu_torch.solvers.graphs",
                "CudaCapture.capture"),
    "replay": ("new_cg_variants_tpu_torch.solvers.graphs", "Loop._run"),
}


def _spanned(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapper


class Hooks:
    def __init__(self):
        import importlib

        from new_cg_variants_tpu_torch.solvers import graphs

        self._undo = []
        self.captures = []
        runner = graphs.runner

        @functools.wraps(runner)
        def counted(*args, **kwargs):
            r = runner(*args, **kwargs)
            if r is not None:
                make = r.capture

                def capture():
                    c = make()
                    self.captures.append(c)
                    return c
                r.capture = capture
            return r

        self._set(graphs, "runner", counted)
        for name, (mod, attr) in SPANS.items():
            owner = importlib.import_module(mod)
            *path, last = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            self._set(owner, last, _spanned(name, getattr(owner, last)))

    def _set(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def capture_seconds(self):
        """Capture and instantiation seconds of every capture so far, and
        forget them."""
        s = sum(c.capture_seconds + c.instantiate_seconds
                for c in self.captures)
        self.captures.clear()
        return s

    def remove(self):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
        self._undo.clear()
