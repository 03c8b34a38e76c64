"""Strong-scaling plots: runtime + error vs device count.

The port of the JAX package's ``harness/scaling_plots.py``, over the JSON
trial files of :func:`~.scaling.save_result` (the same file names and keys
in both packages):

* ``scaling_experiments_mpi4py/scaling_plots.py`` — min-over-trials
  runtime (log2 axes) next to mean forward error, so a fast-but-wrong
  variant is visible (``scaling_plots.py:53-54,66,86``).
* ``scaling_experiments_petsc/strong_scaling_plots.py`` — runtime and
  speedup-over-1-device panels (``strong_scaling_plots.py:88-127``).

Failed/missing trials are tolerated with NaN + nanmin, the reference's
analysis-layer failure handling (``scaling_plots.py:42-51``).  matplotlib
is imported only when a figure is drawn.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

__all__ = ["load_results", "plot_strong_scaling"]


def load_results(data_dir):
    """{variant: {n_devices: (best_time, error)}} from saved JSON trials."""
    out = {}
    for f in pathlib.Path(data_dir).glob("*_p*_n*.json"):
        try:
            d = json.loads(f.read_text())
        except Exception:
            continue  # unreadable trial -> treated as missing (NaN later)
        out.setdefault(d["variant"], {})[int(d["n_devices"])] = (
            float(d["best"]), float(d["error"]),
        )
    return out


def plot_strong_scaling(data_dir, fig_dir="./figures", title="strong_scale"):
    """Three-panel figure: runtime, speedup over 1 device, forward error."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results = load_results(data_dir)
    if not results:
        raise FileNotFoundError(f"no scaling results under {data_dir}")
    device_counts = sorted({p for v in results.values() for p in v})

    f, (ax_t, ax_s, ax_e) = plt.subplots(1, 3, figsize=(15, 4))
    for variant, by_p in sorted(results.items()):
        times = np.array(
            [by_p.get(p, (np.nan, np.nan))[0] for p in device_counts]
        )
        errs = np.array(
            [by_p.get(p, (np.nan, np.nan))[1] for p in device_counts]
        )
        ax_t.plot(device_counts, times, marker="o", label=variant)
        base = times[0] if np.isfinite(times[0]) else np.nanmin(times)
        ax_s.plot(device_counts, base / times, marker="o", label=variant)
        ax_e.plot(device_counts, errs, marker="o", label=variant)

    for ax, ylab in ((ax_t, "runtime (s)"), (ax_s, "speedup vs 1 device"),
                     (ax_e, "forward error")):
        ax.set_xlabel("devices")
        ax.set_ylabel(ylab)
        ax.set_xscale("log", base=2)
        ax.grid(True, linestyle=":")
    ax_t.set_yscale("log", base=2)
    ax_e.set_yscale("log")
    ax_s.plot(device_counts, device_counts, linestyle=":", color="gray",
              label="ideal")
    ax_t.legend()

    out = pathlib.Path(fig_dir)
    out.mkdir(parents=True, exist_ok=True)
    for ext in ("pdf", "svg"):
        f.savefig(out / f"{title}.{ext}", bbox_inches="tight")
    plt.close(f)
    return out / f"{title}.pdf"
