"""Figure generation: convergence plots matching the reference figure set.

The port of the JAX package's ``harness/plotting.py``: the plotting layer of
``numerical_experiments/figure_gen.py`` (``varaint_styles`` :127-141,
``add_plot`` downsampling :144-160, ``plot_matrix_test`` :164-195,
``plot_matrices_test`` :198-238) without the LaTeX text dependency
(``usetex`` needs a TeX install; labels use mathtext instead).  It reads the
trial files of :mod:`.convergence` (either package's) on the host;
matplotlib is imported only when a figure is drawn (:func:`_mpl`), so the
rest of the harness runs where matplotlib is not installed.
"""

from __future__ import annotations

import pathlib

import numpy as np

__all__ = ["VARIANT_STYLES", "add_plot", "plot_matrix_test", "plot_matrices_test"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


#: per-variant plot styles (figure_gen.py:127-141); shared by *_cg twins.
VARIANT_STYLES = {
    "exact_pcg": dict(label="exact", linestyle=":", marker=None, color="#93a1a1", offset=0),
    "hs_pcg": dict(label="HS-CG", linestyle="-", marker="o", color="#93a1a1", offset=0),
    "cg_pcg": dict(label="CG-CG", linestyle="-", marker="^", color="#93a1a1", offset=0.25),
    "m_pcg": dict(label="M-CG", linestyle="-", marker="v", color="#93a1a1", offset=0.5),
    "gv_pcg": dict(label="GV-CG", linestyle="-", marker="s", color="#93a1a1", offset=0.75),
    "pipe_p_m_pcg": dict(label="pipe-P-M-CG", linestyle="-", marker=None, color="#6c71c4", offset=0),
    "pipe_pr_m_pcg": dict(label="pipe-PR-M-CG", linestyle=":", marker=None, color="#859900", offset=0),
    "pr_pcg": dict(label="PR-CG", linestyle=":", marker=None, color="#073642", offset=0),
    "pipe_p_pcg": dict(label="pipe-P-CG", linestyle="-", marker=None, color="#2aa198", offset=0),
    "pipe_pr_pcg": dict(label="pipe-PR-CG", linestyle="-", marker=None, color="#073642", offset=0),
}


def _style_for(name: str) -> dict:
    if name in VARIANT_STYLES:
        return VARIANT_STYLES[name]
    if name.endswith("_cg"):  # unpreconditioned twin: same style
        twin = name[: -len("_cg")] + "_pcg"
        if twin in VARIANT_STYLES:
            return {**VARIANT_STYLES[twin], "label": twin[:-4].upper().replace("_", "-") + "-CG"}
    return dict(label=name, linestyle="-", marker=None, color="#268bd2", offset=0)


def add_plot(trial, quantity, ax, num_markers=5):
    """Downsampled relative-quantity line (figure_gen.py:144-160)."""
    styles = _style_for(trial["name"])
    vo = styles["offset"] / num_markers
    skip = max(1, trial["max_iter"] // 1000)
    xs = np.arange(trial["max_iter"])[::skip]
    ys = np.asarray(trial[quantity])[::skip] / trial[quantity][0]
    num_pts = len(xs)
    ax.plot(
        xs, ys,
        label=styles["label"], linestyle=styles["linestyle"],
        color=styles["color"], marker=styles["marker"],
        markevery=(int(vo * num_pts), max(1, num_pts // num_markers)),
    )


def _load(data_dir, title, preconditioner, variant):
    p = pathlib.Path(data_dir) / f"{title}_{preconditioner}" / f"{variant}.npy"
    return np.load(p, allow_pickle=True).item()


def plot_matrix_test(
    title, preconditioner=None, quantity="error_A_norm", variants=(),
    data_dir="./data", fig_dir="./figures", ylabel=True,
):
    """Single-panel convergence figure (figure_gen.py:164-195)."""
    plt = _mpl()
    f, ax = plt.subplots(1, 1, figsize=(6, 4))
    for variant in variants:
        add_plot(_load(data_dir, title, preconditioner, variant), quantity, ax)
    ax.set_yscale("log")
    ax.set_ylim(1e-16, 5)
    if ylabel:
        ax.set_ylabel(r"$\mathbf{A}$-norm of error: $\|\mathbf{x}-\mathbf{x}_k\|_\mathbf{A}$")
        handles, labels = ax.get_legend_handles_labels()
        ax.legend(handles[::-1], labels[::-1], loc="upper left", bbox_to_anchor=(1, 1))
    else:
        ax.yaxis.set_ticklabels([])
    ax.set_xlabel("iteration $k$")
    ax.grid(True, linestyle=":")
    out = pathlib.Path(fig_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = f"{title}_{preconditioner}_{quantity}" + ("" if ylabel else "_nolbl")
    for ext in ("pdf", "svg"):
        f.savefig(out / f"{stem}.{ext}", bbox_inches="tight")
    plt.close(f)
    return out / f"{stem}.pdf"


def plot_matrices_test(
    titles, preconditioners, quantity="error_A_norm", variants=(),
    data_dir="./data", fig_dir="./figures",
):
    """2x2 grouped figure (figure_gen.py:198-238)."""
    plt = _mpl()
    f, axs = plt.subplots(2, 2, sharey=True, figsize=(11, 7.5))
    flat = axs.flatten()
    for k, ax in enumerate(flat):
        if k >= len(titles):
            continue
        for variant in variants:
            trial = _load(data_dir, titles[k], preconditioners[k], variant)
            add_plot(trial, quantity, ax)
        pc = preconditioners[k]
        ax.set_title(f"{titles[k]}" + (f", prec.={str(pc).capitalize()}" if pc else ""))
        ax.set_xlabel("iteration $k$")
        ax.grid(True, linestyle=":")
    axs[0, 0].set_yscale("log")
    axs[0, 0].set_ylim(1e-16, 5)
    for row in range(2):
        axs[row, 0].set_ylabel(r"$\|\mathbf{x}-\mathbf{x}_k\|_\mathbf{A}$")
    handles, labels = axs[0, 0].get_legend_handles_labels()
    axs[0, 0].legend(handles[::-1], labels[::-1], loc="lower left")
    out = pathlib.Path(fig_dir)
    out.mkdir(parents=True, exist_ok=True)
    stem = "-".join(titles) + "_" + "-".join(str(p) for p in preconditioners) + f"_{quantity}"
    plt.subplots_adjust(wspace=0.05, hspace=0.35)
    for ext in ("pdf", "svg"):
        f.savefig(out / f"{stem}.{ext}", bbox_inches="tight")
    plt.close(f)
    return out / f"{stem}.pdf"
