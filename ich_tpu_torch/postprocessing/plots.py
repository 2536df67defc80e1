"""Plotting helpers of the experiment reports and figures, copied from
``ich_tpu/postprocessing/plots.py`` (the reference's ``plot_utils.py``):
fold curves with CI bands, grouped barplots with jittered points and
pairwise significance markers, prediction overlays, t-SNE scatters,
prediction GIFs, box-histograms and the curved flow band.

matplotlib (and imageio for :func:`pred2gif`) is imported inside each
function, so that the module imports where neither is installed; each
function raises ``ImportError`` there. The artists drawn are the JAX
helpers' on the same data."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def pyplot():
    """matplotlib's ``pyplot`` on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_curved_rect(
    x0: float, x1: float, y0_l: float, y1_l: float, y0_r: float, y1_r: float,
    ax=None, color: str = "gray", alpha: float = 0.3, n: int = 50,
):
    """Filled band between two verticals whose top and bottom edges are
    smoothstep-eased curves (the reference's flow-diagram primitive,
    ``plot_utils.py:20``)."""
    ax = ax or pyplot().gca()
    t = np.linspace(0, 1, n)
    ease = t * t * (3 - 2 * t)  # smoothstep
    xs = x0 + (x1 - x0) * t
    top = y1_l + (y1_r - y1_l) * ease
    bot = y0_l + (y0_r - y0_l) * ease
    ax.fill_between(xs, bot, top, color=color, alpha=alpha, linewidth=0)
    return ax


def curve_std(
    series: Sequence[np.ndarray],
    names: Sequence[str],
    colors: Optional[Sequence[str]] = None,
    ax=None,
    ci: float = 1.96,
    plot_rep: bool = True,
    legend: bool = True,
):
    """Mean ± ci·std curves over repetitions. Each element of ``series`` is
    (n_points, 1 + n_rep): column 0 is x, columns 1.. one curve per fold or
    repetition (NaN padded)."""
    ax = ax or pyplot().gca()
    colors = colors or [f"C{i}" for i in range(len(series))]
    for data, name, color in zip(series, names, colors):
        x, ys = data[:, 0], data[:, 1:].astype(float)
        mean = np.nanmean(ys, axis=1)
        std = np.nanstd(ys, axis=1)
        if plot_rep:
            for j in range(ys.shape[1]):
                ax.plot(x, ys[:, j], color=color, alpha=0.25, lw=0.7)
        ax.plot(x, mean, color=color, lw=1.5, label=name)
        ax.fill_between(x, mean - ci * std, mean + ci * std, color=color, alpha=0.15)
    if legend:
        ax.legend(frameon=False)
    return ax


def metric_barplot(
    groups: Sequence[np.ndarray],
    serie_names: Sequence[str],
    group_names: Sequence[str],
    colors: Optional[Sequence[str]] = None,
    ax=None,
    jitter: bool = True,
    display_val: bool = False,
):
    """Grouped bars of column means with 95% CI whiskers and, with
    ``jitter``, the raw points. ``groups[i]`` is (n_samples,
    n_group_names) for series i."""
    ax = ax or pyplot().gca()
    colors = colors or [f"C{i}" for i in range(len(groups))]
    n_series, n_groups = len(groups), len(group_names)
    width = 0.8 / n_series
    xs = np.arange(n_groups)
    rng = np.random.default_rng(0)
    for i, (data, name, color) in enumerate(zip(groups, serie_names, colors)):
        data = np.asarray(data, dtype=float)
        mean = np.nanmean(data, axis=0)
        ci = 1.96 * np.nanstd(data, axis=0) / max(np.sqrt(len(data)), 1)
        pos = xs + (i - (n_series - 1) / 2) * width
        ax.bar(pos, mean, width=width * 0.9, yerr=ci, color=color, label=name, capsize=2)
        if jitter:
            for g in range(n_groups):
                jx = pos[g] + rng.uniform(-width / 4, width / 4, size=len(data))
                ax.scatter(jx, data[:, g], s=4, color="gray", alpha=0.25, zorder=3)
        if display_val:
            for g in range(n_groups):
                ax.text(pos[g], mean[g], f"{mean[g]:.2f}", ha="center", va="bottom", fontsize=7)
    ax.set_xticks(xs)
    ax.set_xticklabels(group_names)
    ax.legend(frameon=False)
    return ax


def add_stat_significance(pairs, data, ax=None, test: str = "mannwhitneyu"):
    """Annotate pairwise significance between series (reference
    ``add_stat_significance:241``). ``pairs``: (i, j) series index pairs;
    ``data``: one 1D sample per series. Returns the p-values."""
    from scipy import stats

    ax = ax or pyplot().gca()
    ps = []
    y0 = max(np.nanmax(d) for d in data) * 1.05
    for n, (i, j) in enumerate(pairs):
        if test == "mannwhitneyu":
            p = stats.mannwhitneyu(data[i], data[j]).pvalue
        else:
            p = stats.ttest_ind(data[i], data[j], nan_policy="omit").pvalue
        ps.append(float(p))
        stars = "***" if p < 1e-3 else "**" if p < 1e-2 else "*" if p < 0.05 else "ns"
        y = y0 * (1 + 0.08 * n)
        ax.plot([i, j], [y, y], color="black", lw=0.8)
        ax.text((i + j) / 2, y, stars, ha="center", va="bottom", fontsize=8)
    return ps


def imshow_pred(
    image: np.ndarray,
    pred: np.ndarray,
    target: Optional[np.ndarray] = None,
    ax=None,
    pred_color: str = "tomato",
    target_color: str = "forestgreen",
    alpha: float = 0.6,
):
    """A grayscale slice with the prediction (and target) mask overlaid
    (reference ``imshow_pred:344``)."""
    from matplotlib.colors import to_rgba

    ax = ax or pyplot().gca()
    ax.imshow(image, cmap="gray", vmin=0, vmax=1)
    overlay = np.zeros(image.shape + (4,))
    if target is not None:
        overlay[target > 0] = to_rgba(target_color, alpha)
    overlay_p = np.zeros(image.shape + (4,))
    overlay_p[pred > 0] = to_rgba(pred_color, alpha)
    ax.imshow(overlay)
    ax.imshow(overlay_p)
    ax.set_xticks([])
    ax.set_yticks([])
    return ax


def plot_tsne(
    embedding: np.ndarray,
    labels: Optional[np.ndarray] = None,
    ax=None,
    legend_names: Optional[Sequence[str]] = None,
    s: float = 4.0,
):
    """A 2D embedding scattered, coloured by label (reference
    ``plot_tsne:396``)."""
    ax = ax or pyplot().gca()
    if labels is None:
        ax.scatter(embedding[:, 0], embedding[:, 1], s=s, alpha=0.6)
    else:
        labels = np.asarray(labels)
        for i, lab in enumerate(np.unique(labels)):
            m = labels == lab
            name = legend_names[i] if legend_names else str(lab)
            ax.scatter(embedding[m, 0], embedding[m, 1], s=s, alpha=0.6, label=name)
        ax.legend(frameon=False, markerscale=3)
    ax.set_xticks([])
    ax.set_yticks([])
    return ax


def pred2gif(
    images: Sequence[np.ndarray],
    preds: Sequence[np.ndarray],
    save_fn: str,
    targets: Optional[Sequence[np.ndarray]] = None,
    fps: int = 4,
):
    """A stack of slice predictions animated into a GIF (reference
    ``pred2GIF:52``)."""
    import imageio.v2 as imageio

    plt = pyplot()
    frames = []
    for i in range(len(images)):
        fig, ax = plt.subplots(figsize=(4, 4), dpi=80)
        imshow_pred(images[i], preds[i], targets[i] if targets is not None else None, ax=ax)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
        plt.close(fig)
    imageio.mimsave(save_fn, frames, duration=1000 / fps)


def boxplot_hist(
    data: Sequence[np.ndarray],
    names: Sequence[str],
    ax=None,
    bins: int = 30,
    colors: Optional[Sequence[str]] = None,
    horizontal: bool = False,
):
    """Boxplots with marginal histograms (reference ``boxplot_hist:428`` and
    ``boxplot_hist_h:524``, merged by ``horizontal``)."""
    ax = ax or pyplot().gca()
    colors = colors or [f"C{i}" for i in range(len(data))]
    ax.boxplot(data, tick_labels=names, vert=not horizontal, showfliers=False)
    for i, (d, c) in enumerate(zip(data, colors)):
        hist, edges = np.histogram(d[~np.isnan(d)], bins=bins)
        hist = hist / max(hist.max(), 1) * 0.35
        centers = (edges[:-1] + edges[1:]) / 2
        if horizontal:
            ax.barh(i + 1 + 0.05, 0, 0)  # anchor
            ax.bar(centers, hist, width=(edges[1] - edges[0]), bottom=i + 1 + 0.05,
                   color=c, alpha=0.4)
        else:
            ax.barh(centers, hist, height=(edges[1] - edges[0]), left=i + 1 + 0.05,
                    color=c, alpha=0.4)
    return ax
