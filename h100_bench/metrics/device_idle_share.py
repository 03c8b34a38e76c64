"""``device_idle_share.iter`` and ``device_idle_share.solve``: the traced
window's share in which no CUDA event ran, ``100 (1 - busy_s / window_s)``."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
