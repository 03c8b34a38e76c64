"""Solves completed in the window over the window's host seconds."""


def read(obs):
    return len(obs["calls"]) / obs["window_s"]
