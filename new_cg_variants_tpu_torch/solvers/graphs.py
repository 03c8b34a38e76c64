"""CUDA graphs of the solver loops: the port's counterpart of ``jax.jit``
over ``lax.scan`` / ``fori_loop`` / ``while_loop``.

The JAX package hands each iteration loop to XLA as one program: the host
dispatches once per chunk, not once per kernel.  Here ``use_jit=True`` on
the card (the default of :func:`~.api.run`, :func:`~.api.solve` and
:func:`~..harness.scaling.time_variant`) captures a chunk of :data:`CHUNK`
steps as a CUDA graph once and replays it; the kernels, their order and
their arguments are those of the eager loop, so the bits are too.  On the
CPU, or with ``use_jit=False``, the loops of :mod:`.engine` run eagerly.
The mesh loops (:func:`~..parallel.dist.dist_run`,
:func:`~..parallel.dist.dist_solve`, ``time_variant(mesh=)``) take the
same runner on the card, as the JAX package jits its ``shard_map``: a
step's NCCL collectives are captured into the graph with its kernels.

A :class:`Loop` holds the solver state in static buffers, which every
captured step reads and the end of every captured chunk writes:

* *Warm-up.*  The loop's first step runs eagerly, on the stream that then
  captures, so that what a step builds at first use (a kernel library,
  cuBLAS' workspace of that stream, the ticket counter of rows 2 and 11,
  NCCL's communicator at a group's first collective) exists outside the
  graphs' memory pool and before any capture begins.  That step is the run's own
  first step, not a throwaway one.
* *Collectives.*  ``torch.distributed`` on NCCL captures a collective: its
  stream joins the capture through the events it waits on and records,
  and a started all-reduce's ``wait()`` becomes an edge of the graph, not
  a host wait.  The captures run in ``thread_local`` mode, so that NCCL's
  watchdog thread may query the events of earlier eager work meanwhile.
  Every collective of a step is waited for inside the step, so no replay
  leaves one running when the next begins.
* *Buffer handoff.*  A step returns fresh tensors; a captured chunk copies
  its last state into the buffers it read, one copy of each state tensor a
  chunk (:data:`CHUNK` steps), inside the graph.  Two graphs alternating
  between two buffer sets would need the same copy, since a captured step
  cannot be told where to write.
* *``k``.*  The iteration counter stays a host integer, advanced by the
  steps a replay makes.  A gv replacement hook is called with ``k`` at
  capture, so under capture it gets ``k`` as a 0-d int64 device tensor that
  the graph advances, and must answer with a tensor (:func:`checked_hook`).
* *Rows.*  A chunk writes each step's probe rows (or its convergence norm)
  into preallocated ``(chunk, ...)`` device buffers; the caller copies them
  out after the replay, on the device.
* *Store.*  A loop whose graphs read nothing outside its buffers but what
  a key names (:func:`capture_key`: the context's own key, the step, the
  state's shapes and dtypes, the rows, the chunk) leaves them in its
  device's :class:`Store`, and a later loop of the same key replays them
  instead of capturing: repeated solves on one operator capture once.
  Only ``engine.tolerance_loop`` names its rows; every other loop, and a
  context that names nothing (a mesh, double words, a Jacobi diagonal),
  captures its own, as before.
* *Counters.*  Replays, captures, their seconds, the capture pool's
  growth, the loops that found their graphs stored and the steps
  :meth:`Loop.restore` takes back count in :mod:`..utils.profiling`, under
  the spans ``loop.start``, ``capture``, ``replay`` and ``restore``.

A capture, instantiation or replay that fails raises with its CUDA error;
nothing runs eagerly in its place.  :class:`Runner` takes the capture as an
object (:class:`CudaCapture` on the card), so that the chunk logic of
:mod:`.engine` is tested on the CPU with one that calls the chunk's body
directly (``tests/test_torch_capture_loops.py``).
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref

import torch

from ..ops import _kernels
from ..ops.doublefloat import DF
from ..utils.profiling import count, span

__all__ = ["CHUNK", "STORE_SIZE", "Runner", "Loop", "CudaCapture", "Store",
           "capture_key", "runner", "checked_hook"]

#: steps a captured chunk makes (the fewer when the loop has fewer left)
CHUNK = 32
#: captured loops a device's :class:`Store` keeps
STORE_SIZE = 4

#: the :class:`Store` of each CUDA device
_STORES = {}
#: captures under way: no store destroys an entry meanwhile
_CAPTURING = [0]


def runner(device, use_jit, hooked=False):
    """The :class:`Runner` of a loop on ``device``, with the device's
    :class:`Store`, or ``None`` (the eager loop) on the CPU or with
    ``use_jit=False``.  ``hooked``: the step calls a gv replacement hook,
    so the graph carries ``k`` on the device."""
    if not use_jit or device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    store = _STORES.get(device)
    if store is None:
        store = _STORES[device] = Store()
    return Runner(lambda: CudaCapture(device), k_on_device=hooked,
                  store=store)


def checked_hook(w_replace, stateful):
    """``w_replace`` as a captured loop calls it: with ``k`` a 0-d int64
    device tensor, its answer (the first of a stateful hook's pair) a
    tensor, else ``TypeError``.  A captured step runs the hook once, at
    capture, so a Python answer would be frozen into every replay."""

    def hook(k, view, *rep):
        out = w_replace(k, view, *rep)
        answer = out[0] if stateful else out
        if not isinstance(answer, torch.Tensor):
            raise TypeError(
                f"w_replace answered {type(answer).__name__} in a captured "
                "loop (use_jit=True, or dist_run on the card): it is called "
                "once, at capture, with k a device tensor, so it must "
                "answer with a bool tensor (the step selects with "
                "torch.where); pass use_jit=False (dist_run: "
                "device='cpu') to branch in Python")
        return out

    return hook


# ---------------------------------------------------------------------------
# the state as a flat list of tensors
# ---------------------------------------------------------------------------


def _flatten(x, leaves):
    """Append ``x``'s tensors to ``leaves``; return its structure."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return None
    if isinstance(x, DF):
        return (DF, (_flatten(x.hi, leaves), _flatten(x.lo, leaves)))
    if isinstance(x, dict):
        keys = sorted(x, key=str)
        return (dict, tuple(keys), tuple(_flatten(x[k], leaves)
                                         for k in keys))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    raise TypeError(
        f"a captured loop carries tensors, not {type(x).__name__}: pass "
        "use_jit=False")


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    if spec[0] is DF:
        return DF(*(_unflatten(s, it) for s in spec[1]))
    if spec[0] is dict:
        return {k: _unflatten(s, it) for k, s in zip(spec[1], spec[2])}
    return spec[0](_unflatten(s, it) for s in spec[1])


def _on_device(x, device):
    """Every number of a hook's state a 0-d tensor on ``device`` (as a JAX
    loop carries them as arrays)."""
    if isinstance(x, dict):
        return {k: _on_device(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_on_device(v, device) for v in x)
    if isinstance(x, (torch.Tensor, DF)):
        return x
    return torch.as_tensor(x, device=device)


# ---------------------------------------------------------------------------
# the store of captured loops
# ---------------------------------------------------------------------------


def capture_key(ctx, step_fn, state, *parts):
    """The key of what a captured step reads outside the loop's buffers:
    the context's own key (``ctx.graph_key()``), ``step_fn`` (by weak
    reference), the state's structure, shapes and dtypes, and ``parts``;
    ``None`` where the context names none (it has no ``graph_key``, or
    answers ``None``), or the step or the state cannot be named."""
    graph_key = getattr(ctx, "graph_key", None)
    if graph_key is None:
        return None
    leaves = []
    try:
        ctx_key = graph_key()
        key = (ctx_key, weakref.ref(step_fn), _flatten(state, leaves),
               tuple((t.shape, t.dtype, t.device) for t in leaves), parts)
        hash(key)
    except TypeError:  # no weak reference to the operator or the step, a
        return None    # number in the state
    return None if ctx_key is None else key


class _Graphs:
    """A loop's capture and the buffers its graphs read and write: the
    state's, the checkpoint's, the rows' and the replays (both by step
    count).  ``lessee`` is a weak reference to the loop that replays them:
    the bodies read that loop's context, step and rows, never the one that
    captured."""

    def __init__(self, cap, spec, bufs, saved, loop):
        self.cap, self.spec, self.bufs, self.saved = cap, spec, bufs, saved
        self.row_bufs, self.replay = {}, {}
        self.lessee = weakref.ref(loop)
        self.finalizer = None

    def tensors(self):
        """Every buffer (a later loop marks each for its own stream)."""
        yield from self.bufs
        yield from self.saved or ()
        for rows in self.row_bufs.values():
            yield from rows.values()


class Store:
    """Captured loops kept for later loops of the same :func:`capture_key`:
    at most :data:`STORE_SIZE`, the least recently used out.

    An entry is leased to one live loop at a time.  It holds no strong
    reference to the operator or the context it was captured on: when the
    operator is freed its entries go, and where that happens during a
    capture, at the store's next lease, so that nothing is destroyed inside
    a capture."""

    def __init__(self):
        self._entries = collections.OrderedDict()
        self._dead = []

    def __len__(self):
        return len(self._entries)

    def lease(self, key, loop):
        """The entry of ``key``, leased to ``loop``; ``None`` where there is
        none or a live loop holds it."""
        while self._dead:
            self._entries.pop(self._dead.pop(), None)
        g = self._entries.get(key)
        if g is None or g.lessee() is not None:
            return None
        self._entries.move_to_end(key)
        g.lessee = weakref.ref(loop)
        return g

    def put(self, key, g, owner):
        """Keep ``g`` under ``key`` until ``owner`` is freed; ``False``
        where a live loop holds an entry of ``key``."""
        if key in self._entries:
            return False
        self._entries[key] = g
        g.finalizer = weakref.finalize(owner, self._forget, key)
        while len(self._entries) > STORE_SIZE:
            self._entries.popitem(last=False)[1].finalizer.detach()
        return True

    def discard(self, g):
        """Forget ``g`` (its capture failed)."""
        for key, entry in list(self._entries.items()):
            if entry is g:
                del self._entries[key]
                g.finalizer.detach()

    def _forget(self, key):
        if _CAPTURING[0]:
            self._dead.append(key)
        else:
            self._entries.pop(key, None)


# ---------------------------------------------------------------------------
# captures
# ---------------------------------------------------------------------------


class CudaCapture:
    """Captures CUDA graphs on a stream of its own, into one memory pool.

    Replays run on the caller's current stream, one after another.  The
    launches of rows 2 (with its scalar epilogue) and 11 in a graph take
    this object's own ticket counter
    (:class:`..ops._kernels.CaptureTickets`), allocated zeroed before any
    capture: no eager launch on any stream uses it, so none can run while a
    replay does.  ``capture_seconds`` / ``instantiate_seconds`` add up the
    host time of the captures' bodies and of ending them (which instantiates
    the graph); each capture also adds its two to the counter
    ``capture_s``, and the growth of the card's reserved memory over it to
    ``pool_bytes`` (:mod:`..utils.profiling`)."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        self.tickets = None
        self.capture_seconds = 0.0
        self.instantiate_seconds = 0.0

    @contextlib.contextmanager
    def side(self):
        """Work on the capture stream, after the caller's pending work and
        before its next (the warm-up step and the buffers)."""
        main = self.main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)

    def keep(self, t):
        """A tensor made on the capture stream (within :meth:`side`) that
        the caller's stream uses: its memory is not reused before that
        use."""
        t.record_stream(self.main)
        return t

    def capture(self, body):
        """Capture ``body`` (which reads and writes only the loop's buffers)
        as a graph; return its replay."""
        if self.tickets is None:
            with self.side():
                self.tickets = self.keep(torch.zeros(
                    1, dtype=torch.int32, device=self.device))
        g = torch.cuda.CUDAGraph()
        reserved = _reserved(self.device)
        with self.side(), _kernels.CaptureTickets(self.stream,
                                                  self.tickets):
            t0 = time.perf_counter()
            g.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                body()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    g.capture_end()  # an invalidated capture raises again
                raise
            t1 = time.perf_counter()
            g.capture_end()
            t2 = time.perf_counter()
            self.capture_seconds += t1 - t0
            self.instantiate_seconds += t2 - t1
        count("capture_s", (t1 - t0) + (t2 - t1))
        grown = _reserved(self.device) - reserved
        if grown > 0:
            count("pool_bytes", grown)
        self.graphs.append(g)
        return g.replay


def _reserved(device):
    """``torch.cuda.memory_reserved(device)`` without flattening every
    statistic into a sorted dict (on an H100's host 21 us a call against
    136)."""
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return stats["reserved_bytes"]["all"]["current"]


class Runner:
    """Starts :class:`Loop` objects: ``capture()`` makes each loop's capture
    (:class:`CudaCapture` on the card: ``side()``, ``keep(t)``,
    ``capture(body)``), ``chunk`` steps a captured chunk.  Given a
    :class:`Store`, a loop whose caller names its rows keeps its graphs
    there, or replays those of an earlier loop of its key."""

    def __init__(self, capture, chunk=CHUNK, k_on_device=False, store=None):
        self.capture = capture
        self.chunk = chunk
        self.k_on_device = k_on_device
        self.store = store

    def start(self, ctx, step_fn, state, rows=None, horizon=0,
              checkpoint=False, rows_key=None):
        """A :class:`Loop` from ``state``, after its first step.
        ``rows_key``: a key of ``rows`` (two calls' rows of one key compute
        the same from the context and the state), or ``None``: the loop's
        graphs are then its own."""
        with span("loop.start"):
            return Loop(self, ctx, step_fn, state, rows or {}, horizon,
                        checkpoint, rows_key)


class Loop:
    """``step_fn`` from ``state``, advanced by replays of captured chunks.

    The first step runs eagerly (the warm-up); ``first_rows`` holds its
    rows.  ``rows`` maps a name to ``fn(ctx, state) -> tensor``, evaluated
    after every step.  ``horizon``: the steps the caller may still take,
    which bounds the chunk (:attr:`chunk`).  With ``checkpoint`` a chunk
    first copies the state it starts from aside, so that :meth:`restore`
    can take it back (the tolerance loop's overshoot).  With a
    ``rows_key`` and the runner's store, the graphs, buffers and capture
    may be an earlier loop's of the same :func:`capture_key` (the warm-up
    step's state is then copied into its buffers: ``capture_hits``), and
    stay in the store for a later one.
    """

    def __init__(self, runner, ctx, step_fn, state, rows, horizon,
                 checkpoint, rows_key=None):
        self.ctx, self.step_fn, self.rows = ctx, step_fn, rows
        self.chunk = max(1, min(runner.chunk, horizon))
        self.k_on_device = runner.k_on_device
        state = dict(state)
        self.k = state.pop("k")
        store = runner.store
        key = (None if store is None or rows_key is None
               else capture_key(ctx, step_fn, state, rows_key, self.chunk,
                                checkpoint, self.k_on_device))
        g = store.lease(key, self) if key is not None else None
        if g is not None:
            count("capture_hits")
        self.cap = runner.capture() if g is None else g.cap
        if self.k_on_device and "wrep" in state:
            state["wrep"] = _on_device(state["wrep"], _device_of(state))
        with self.cap.side():
            state["k"] = (torch.tensor(self.k, dtype=torch.int64,
                                       device=_device_of(state))
                          if self.k_on_device else self.k)
            s = step_fn(ctx, state)
            k1 = s.pop("k")
            self.k += 1
            keep = self.cap.keep
            self.first_rows = {name: keep(fn(ctx, s))
                               for name, fn in rows.items()}
            if self.k_on_device:
                s["k"] = k1
            leaves = []
            spec = _flatten(s, leaves)
            if g is None:
                g = _Graphs(self.cap, spec, [keep(t.clone()) for t in leaves],
                            ([keep(torch.empty_like(t)) for t in leaves]
                             if checkpoint else None), self)
                kept = key is not None and store.put(key, g, ctx.op)
            else:
                if spec != g.spec:
                    raise TypeError("a step changed the state's structure: "
                                    "pass use_jit=False")
                for t in g.tensors():
                    keep(t)
                for d, t in zip(g.bufs, leaves):
                    d.copy_(t)
                kept = True
        self._g, self._store = g, store if kept else None
        self.spec, self.bufs, self.saved = g.spec, g.bufs, g.saved
        self._replay, self._row_bufs = g.replay, g.row_bufs  # by steps
        self._state = state  # read on the capture stream: keep it alive

    def _body(self, steps):
        """The chunk: ``steps`` steps from the buffers and back into them
        (the state it starts from copied aside first, for a checkpointed
        loop's chunk), by the context, step and rows of the loop that
        replays it."""
        g, rows = self._g, self._row_bufs[steps]
        bufs = g.bufs
        save = g.saved is not None and steps == self.chunk

        def body():
            loop = g.lessee()
            if save:
                for d, t in zip(g.saved, bufs):
                    d.copy_(t)
            s = _unflatten(g.spec, iter(bufs))
            if not loop.k_on_device:
                s["k"] = loop.k  # the host counter; nothing reads it
            for i in range(steps):
                s = loop.step_fn(loop.ctx, s)
                for name, fn in loop.rows.items():
                    rows[name][i].copy_(fn(loop.ctx, s))
            if not loop.k_on_device:
                s.pop("k")
            leaves = []
            if _flatten(s, leaves) != g.spec:
                raise TypeError("a step changed the state's structure: "
                                "pass use_jit=False")
            # a value passed through unchanged is one of the buffers: read
            # it before the buffers are overwritten
            held = {b.data_ptr() for b in bufs}
            leaves = [t.clone() if t.data_ptr() in held else t
                      for t in leaves]
            for d, t in zip(bufs, leaves):
                d.copy_(t)

        return body

    def _run(self, steps):
        replay = self._replay.get(steps)
        if replay is None:
            with self.cap.side():
                self._row_bufs[steps] = {
                    name: self.cap.keep(r.new_empty((steps, *r.shape)))
                    for name, r in self.first_rows.items()}
            with span("capture", steps=steps):
                _CAPTURING[0] += 1
                try:
                    replay = self._replay[steps] = self.cap.capture(
                        self._body(steps))
                except BaseException:
                    if self._store is not None:
                        self._store.discard(self._g)
                    raise
                finally:
                    _CAPTURING[0] -= 1
            count("captures")
        with span("replay", "replays", steps=steps):
            replay()
        self.k += steps
        return self._row_bufs[steps]

    def replay_chunk(self):
        """:attr:`chunk` steps (one replay); returns the rows, ``(chunk,
        ...)`` buffers that the next replay of the chunk overwrites."""
        return self._run(self.chunk)

    def replay_one(self):
        """One step (one replay of a one-step graph); returns its rows as
        ``(1, ...)`` buffers."""
        return self._run(1)

    def restore(self):
        """Back to the state the last chunk started from; its steps count
        in ``steps_taken_back``."""
        with span("restore"):
            for d, t in zip(self.bufs, self.saved):
                d.copy_(t)
        self.k -= self.chunk
        count("steps_taken_back", self.chunk)

    def advance(self, steps, sink=None):
        """``steps`` more steps: whole chunks, then single steps.  After
        each replay ``sink(k, rows, m)`` gets its ``m`` rows, of the steps
        that end at iterations ``k + 1 .. k + m``."""
        while steps > 0:
            m = self.chunk if steps >= self.chunk else 1
            k = self.k
            rows = self._run(m)
            if sink is not None:
                sink(k, rows, m)
            steps -= m

    def load(self, state):
        """Start again from ``state`` (of the same structure)."""
        state = dict(state)
        k = state.pop("k")
        if self.k_on_device:
            state["k"] = torch.as_tensor(k, dtype=torch.int64,
                                         device=self.bufs[0].device)
            if "wrep" in state:
                state["wrep"] = _on_device(state["wrep"],
                                           self.bufs[0].device)
        leaves = []
        if _flatten(state, leaves) != self.spec:
            raise ValueError("the state to load has another structure")
        for d, t in zip(self.bufs, leaves):
            d.copy_(t)
        self.k = int(k)

    def state(self):
        """The state in the buffers (``k`` a host integer), which a later
        replay overwrites; a copy of it where a store keeps the buffers for
        a later loop."""
        bufs = (self.bufs if self._store is None
                else [t.clone() for t in self.bufs])
        s = _unflatten(self.spec, iter(bufs))
        s["k"] = self.k
        return s


def _device_of(state):
    leaves = []
    _flatten({k: v for k, v in state.items() if k != "wrep"}, leaves)
    return leaves[0].device
