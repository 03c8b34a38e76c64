"""Reading the profiler's trace of the traced window.

The arithmetic of ``chip_smoke.py:device_activity`` (the union of the CUDA
events' spans: kernels, copies, sets), restricted to the window the harness
marks with :data:`WINDOW`, and the breakdown: device time by operation, and
the device's idle gaps by what the host was doing meanwhile (the innermost
host span of :mod:`.program_hooks` or of the harness, and the innermost
host operation, around each gap's middle).
"""

from __future__ import annotations

__all__ = ["WINDOW", "CALL", "read", "Trace"]

#: host span around the traced window, and around each call in it
WINDOW = "h100_bench.window"
CALL = "solve"
#: host spans that name what a gap waited on (program_hooks.SPANS and CALL)
LABELS = ("loop.start", "capture", "replay", CALL)
#: every host span the harness and the hooks open
SPANS = LABELS + (WINDOW,)
#: entries of each breakdown list
TOP = 10


class Trace:
    """``busy_s``, ``window_s``, ``events`` (CUDA events in the window),
    ``device_ops`` and ``idle_gaps`` (``[name, seconds]``, longest first)."""

    def __init__(self, busy_s, window_s, events, device_ops, idle_gaps):
        self.busy_s, self.window_s, self.events = busy_s, window_s, events
        self.device_ops, self.idle_gaps = device_ops, idle_gaps


def _union(spans):
    """Merged ``(start, end)`` segments of ``spans`` (sorted)."""
    out = []
    for a, z in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return out


def _labels(host, times):
    """For each of the sorted ``times``: the innermost span of
    :data:`LABELS` and the innermost other host event around it (``host``:
    ``(start, end, name)`` sorted by start), swept once."""
    out, active, j = [], [], 0
    for t in times:
        while j < len(host) and host[j][0] <= t:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= t]
        span = next((n for _, _, n in reversed(active) if n in LABELS), None)
        op = next((n for _, _, n in reversed(active)
                   if n not in LABELS and n != WINDOW), None)
        out.append(f"{span or 'harness'} / {op or 'python'}")
    return out


def read(events, device_type_cuda):
    """A :class:`Trace` of ``events`` (``prof.events()``), or ``None`` when
    it holds no window or no CUDA event in it."""
    window = None
    device, host = [], []
    for e in events:
        a, z = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == device_type_cuda:
            # the device-side shadow of a host span covers the work it
            # launched, idle gaps too: no operation of its own
            if e.name not in SPANS and not getattr(e, "is_user_annotation",
                                                   False):
                device.append((a, z, e.name))
        else:
            if e.name == WINDOW:
                window = (a, z)
            host.append((a, z, e.name))
    if window is None:
        return None
    w0, w1 = window
    inside = [(max(a, w0), min(z, w1), name) for a, z, name in device
              if z > w0 and a < w1]
    if not inside:
        return None
    by_name = {}
    for a, z, name in inside:
        by_name[name] = by_name.get(name, 0.0) + (z - a)
    segments = _union([(a, z) for a, z, _ in inside])
    busy = sum(z - a for a, z in segments)
    host = [h for h in host if h[1] > w0 and h[0] < w1]
    host.sort()
    edges = [w0] + [t for seg in segments for t in seg] + [w1]
    idle = [(a, z) for a, z in zip(edges[0::2], edges[1::2]) if z > a]
    gaps = {}
    for (a, z), key in zip(idle, _labels(host, [(a + z) / 2
                                                for a, z in idle])):
        gaps[key] = gaps.get(key, 0.0) + (z - a)
    top = lambda d: [[k[:160], v * 1e-6] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(busy * 1e-6, (w1 - w0) * 1e-6, len(inside), top(by_name),
                 top(gaps))
