"""Generic trajectory and tube plotting, plain NumPy and matplotlib (the
port's copy of `robust_nonlinear_mpc_tpu/utils/plotting.py`). Every function
imports matplotlib inside its body, so importing this module needs none."""

from __future__ import annotations

import numpy as np


def plot_nominal_trajectory(X, dt=0.05, time=None, ax=None, labels=None):
    """X: (nx, T) nominal trajectory."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=(10, 6))
    X = np.asarray(X)
    if time is None:
        time = np.arange(X.shape[1]) * dt
    colors = plt.cm.viridis(np.linspace(0, 1, X.shape[0] + 2))
    for i in range(X.shape[0]):
        lbl = labels[i] if labels else None
        ax.plot(time, X[i], color=colors[i + 1], label=lbl)
    if labels:
        ax.legend()
    return ax


def plot_tube(backoff, center, dt=0.05, time=None, ax=None, alpha=0.5, margin=1e-6):
    """fill_between center +- backoff per state (reference util/plot.py:38)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=(10, 6))
    backoff = np.asarray(backoff)
    center = np.asarray(center)
    if backoff.shape[0] != center.shape[0]:
        backoff = backoff.T
    if time is None:
        time = np.arange(center.shape[1]) * dt
    colors = plt.cm.viridis(np.linspace(0, 1, center.shape[0] + 2))
    for i in range(center.shape[0]):
        lo = center[i] - backoff[i] + margin
        hi = center[i] + backoff[i] - margin
        ax.fill_between(time, lo, hi, color=colors[i + 1], alpha=alpha)
    return ax


def add_footnote_time(fig):
    """Timestamp footnote (reference util/footnote.py)."""
    from datetime import datetime

    fig.text(
        0.99, 0.01, datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        ha="right", va="bottom", fontsize=6, alpha=0.5,
    )


def rectangle_coordinates(center, width, height):
    """Corner coordinates of an axis-aligned rectangle
    (reference util/rectangle_coordinates.py, without its import-time demo)."""
    cx, cy = center
    return np.array(
        [
            [cx - width / 2, cy - height / 2],
            [cx + width / 2, cy - height / 2],
            [cx + width / 2, cy + height / 2],
            [cx - width / 2, cy + height / 2],
        ]
    )


# ----------------------------------------------------------------------
# Normalized-coordinate helpers + alpha-gradient tube fans (capability
# parity with the reference rocket figure pipeline,
# expe/main_rocket_robust_closed_loop.py:211-454)
# ----------------------------------------------------------------------
def affine_to_unit(x, lb, ub):
    """Map [lb, ub] -> [-1, 1] (reference _affine_to_unit, :21-23)."""
    x = np.asarray(x, float)
    span = ub - lb
    span = span if span != 0 else 1.0
    return 2.0 * (x - lb) / span - 1.0


def halfwidth_to_unit(halfw, lb, ub):
    """Tube half-width in [-1, 1] units (reference _tube_halfwidth_to_unit)."""
    span = ub - lb
    span = span if span != 0 else 1.0
    return 2.0 * np.asarray(halfw, float) / span


def draw_alpha_gradient_tube(ax, t, lo, hi, color, a_start=0.35, a_end=0.05,
                             zorder=1.0, segments_per_step=4):
    """Tube between lo(t) and hi(t) whose opacity fades from a_start at the
    left edge to a_end at the right edge — the reference's horizon-fan
    visual (its implementation clips an RGBA image to a polygon; here each
    inter-sample span is a short fill_between with interpolated alpha,
    which renders identically and needs no raster image)."""
    t = np.asarray(t, float)
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    n = t.size
    if n < 2 or lo.shape != t.shape or hi.shape != t.shape:
        return
    m = max(1, int(segments_per_step))
    tt = np.linspace(t[0], t[-1], (n - 1) * m + 1)
    lo_f = np.interp(tt, t, lo)
    hi_f = np.interp(tt, t, hi)
    alphas = np.linspace(a_start, a_end, tt.size - 1)
    for i, a in enumerate(alphas):
        ax.fill_between(
            tt[i : i + 2], lo_f[i : i + 2], hi_f[i : i + 2],
            color=color, alpha=float(max(a, 0.0)), linewidth=0.0,
            zorder=zorder,
        )


def compact_dual_legend(ax, style_names=("robust", "soft"),
                        styles=("-", "--"), title=None, ncol=3):
    """Two stacked legends: colored variable entries (deduplicated from the
    '(robust)' series) plus a grey linestyle key (reference
    main_rocket_compare_closed_loop.py:21-44)."""
    from matplotlib.lines import Line2D

    handles, labels_ = ax.get_legend_handles_labels()
    tag = f"({style_names[0]})"
    hv = [h for h, l in zip(handles, labels_) if tag in l]
    lv = [l.replace(f" {tag}", "") for l in labels_ if tag in l]
    if hv:
        leg1 = ax.legend(
            hv, lv, title=title, loc="upper left", ncol=ncol,
            handlelength=1.0, handletextpad=0.3, columnspacing=0.6,
            labelspacing=0.2, borderpad=0.3, framealpha=0.8,
        )
        ax.add_artist(leg1)
    ax.legend(
        [Line2D([], [], linestyle=s, color="0.3") for s in styles],
        list(style_names),
        loc="lower right", handlelength=1.2, framealpha=0.8,
    )
