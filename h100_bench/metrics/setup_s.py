"""Set-up seconds: process start (before ``import torch``) to the end of
the warm-up call, all of it before the window: imports, the kernels'
build where it is missing, the operator, the right-hand sides, one call."""


def read(obs):
    return obs["setup_s"]
