"""Milliseconds an iteration: the window's host seconds, from the first
call's start to the last call's return, over every iteration its calls
completed.  Each call's capture, initialisation and final sync are in."""


def read(obs):
    iters = sum(c["iterations"] for c in obs["calls"])
    return obs["window_s"] * 1e3 / iters if iters else None
