"""CUDA events (kernels, copies, sets) in the traced window over the
iterations its calls completed."""


def read(obs):
    trace = obs.get("trace")
    iters = sum(c["iterations"] for c in obs["calls"] if c["profiled"])
    if trace is None or not iters:
        return None
    return trace.events / iters
