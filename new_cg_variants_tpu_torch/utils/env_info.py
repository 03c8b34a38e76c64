"""Runtime environment capture.

The port of the JAX package's ``utils/env_info.py``.  The reference records
its software/hardware configuration alongside the results
(``scaling_experiments_petsc/config_info/``: PETSc configure log, Slurm
environment dumps) and writes exact reproduction commands as ``.call``
files (``strong_scaling_tests.py:98-103``).  :func:`env_info` is the
port's snapshot — torch, CUDA, the card, ``nvidia-smi``'s name and power
limit line (every timing stands beside it), and the host's long double (the
oracle's precision) — and :func:`write_call_file` records the exact CLI
invocation next to each result set.
"""

from __future__ import annotations

import json
import pathlib
import platform
import shutil
import subprocess
import sys

import numpy as np
import torch

__all__ = ["env_info", "write_env_info", "write_call_file", "nvidia_smi_line"]


def nvidia_smi_line():
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    lines joined by ``"; "``, or ``None`` where there is no ``nvidia-smi``
    or it fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    proc = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    if proc.returncode != 0:
        return None
    return "; ".join(ln.strip() for ln in proc.stdout.splitlines()
                     if ln.strip())


def _cuda_devices():
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        out.append({"name": p.name, "capability": f"{p.major}.{p.minor}",
                    "total_memory_bytes": int(p.total_memory),
                    "multiprocessors": int(p.multi_processor_count)})
    return out


def env_info() -> dict:
    ld = np.finfo(np.longdouble)
    devices = _cuda_devices()
    return {
        "python": sys.version,
        "platform": platform.platform(),
        "machine": platform.machine(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": bool(devices),
        "device_count": len(devices),
        "devices": devices,
        "nvidia_smi": nvidia_smi_line(),
        "numpy": np.__version__,
        "longdouble": {"dtype": str(np.dtype(np.longdouble)),
                       "bits": int(np.dtype(np.longdouble).itemsize * 8),
                       "eps": float(ld.eps), "precision": int(ld.precision),
                       "nmant": int(ld.nmant)},
        "torch_threads": torch.get_num_threads(),
    }


def write_env_info(data_dir) -> pathlib.Path:
    d = pathlib.Path(data_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / "env_info.json"
    path.write_text(json.dumps(env_info(), indent=1))
    return path


def write_call_file(data_dir, name: str, argv=None) -> pathlib.Path:
    """Record the exact invocation (the reference's ``.call`` files)."""
    d = pathlib.Path(data_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{name}.call"
    path.write_text(" ".join(argv if argv is not None else sys.argv) + "\n")
    return path
