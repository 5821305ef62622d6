"""Shared experiment plumbing: save a run as a timestamped npz with the
reference field names, load the newest, plot the newest (the port's copy of
`robust_nonlinear_mpc_tpu/expe/_common.py`; plotting imports matplotlib
inside its body)."""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np


def save_results(folder: str, prefix: str, results: dict) -> str:
    os.makedirs(folder, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(folder, f"{prefix}_{stamp}.npz")
    np.savez(path, **results)
    print(f"Results saved to {path}")
    return path


def load_latest(folder: str):
    """Newest npz in `folder` by ctime, or None."""
    if not os.path.isdir(folder):
        return None
    files = [f for f in os.listdir(folder) if f.endswith(".npz")]
    if not files:
        return None
    latest = max(files, key=lambda f: os.path.getctime(os.path.join(folder, f)))
    return np.load(os.path.join(folder, latest))


def plot_closed_loop(folder: str, tube_frequency: int = 5, show: bool = True):
    """Generic tube + trajectory plot of the newest run in `folder`: every
    `tube_frequency`-th step's horizon as a fan fading along the horizon and
    across later fans, the closed-loop states on top."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from robust_nonlinear_mpc_torch.utils.plotting import (
        add_footnote_time,
        draw_alpha_gradient_tube,
    )

    sol = load_latest(folder)
    if sol is None:
        print("No data files found in the directory.")
        return None
    dt = float(sol["dt"])
    nx = int(sol["nx"])
    T = int(sol["simulation_time_steps"])
    N = int(sol["N"])
    state = sol["state_trajectory"]
    nom_x = sol["nominal_trajectory_x"]
    bo_x = sol["backoff_trajectory_x"]

    fig, ax = plt.subplots(1, 1, figsize=(12, 7))
    time = np.arange(T) * dt
    colors = plt.cm.viridis(np.linspace(0, 1, nx + 2))
    denom_t = max(1, T - 1)
    for t0 in range(0, T, tube_frequency):
        horizon_time = (t0 + np.arange(N + 1)) * dt
        scale = 1.0 - 0.4 * (t0 / denom_t)
        for i in range(nx):
            draw_alpha_gradient_tube(
                ax, horizon_time,
                nom_x[i, :, t0] - bo_x[i, :, t0],
                nom_x[i, :, t0] + bo_x[i, :, t0],
                colors[i + 1], a_start=0.35 * scale, a_end=0.05 * scale,
            )
    for i in range(nx):
        ax.plot(time, state[i], color=colors[i + 1], lw=1.5)
    ax.set_xlabel("time [s]")
    ax.set_ylabel("state")
    add_footnote_time(fig)
    if show:
        plt.show()
    return fig
