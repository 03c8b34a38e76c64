"""90th percentile (nearest rank) of the host milliseconds of every solve
in the window, from the call to its return after the card finished."""

import math


def read(obs):
    ms = sorted((c["t1"] - c["t0"]) * 1e3 for c in obs["calls"])
    return ms[math.ceil(0.9 * len(ms)) - 1]
