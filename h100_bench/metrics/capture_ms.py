"""``capture_ms.iter`` and ``capture_ms.solve``: milliseconds a call of the
program's CUDA graph captures and instantiations
(``solvers/graphs.py:CudaCapture``'s ``capture_seconds`` +
``instantiate_seconds``), or ``None`` where no call captured."""


def read(obs):
    seen = [c for c in obs["calls"] if c.get("captures")]
    if not seen:
        return None
    return sum(c["capture_s"] for c in obs["calls"]) * 1e3 / len(obs["calls"])
