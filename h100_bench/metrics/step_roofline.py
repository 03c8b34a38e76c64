"""Share of the device-busy time an iteration that the step's least bytes
(``roofline.step_bytes``) need at the card's published bandwidth
(``roofline.HBM_BYTES_PER_S``): ``100 t_bytes / (busy_s / iterations)``."""


def read(obs):
    trace = obs.get("trace")
    iters = sum(c["iterations"] for c in obs["calls"] if c["profiled"])
    if trace is None or not iters or trace.busy_s <= 0:
        return None
    least_s = obs["step_bytes"] / obs["peak_bytes_per_s"]
    return 100.0 * least_s / (trace.busy_s / iters)
