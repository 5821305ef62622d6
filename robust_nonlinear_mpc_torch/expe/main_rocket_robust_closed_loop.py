"""Rocket ("rockETH") robust closed loop, the headline RTI configuration
(port of `robust_nonlinear_mpc_tpu/expe/main_rocket_robust_closed_loop.py`:
`--run` generates a run, without it the newest run is plotted).

N = 15, Q = diag(10,10,10, 1x3, 1x4, 1,5,5, 1x4), R = I4, Qf = 10 Q,
regularizers 1e4 I, rti = 1, fast_sls_rti_steps = 1, E = dt * diag(...),
the hardcoded 17-dim x0, 30 steps with uniform noise x+ = f(x, u) + E w,
w ~ U[-1, 1]^nx from RandomState(0), float64.

Usage:  python -m robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop --run
            [--N 15] [--steps 30] [--device cuda|cpu]
        python -m robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop   # plot
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from robust_nonlinear_mpc_torch.utils.device import checked_device

FOLDER = "rockETH_robust_closed_loop"

X0 = [
    1.75729, 4.15951, 4.72757,
    -0.18913, -0.38367, -0.08697,
    -0.79487, 0.00768, -0.21110, -0.56883,
    -0.12752, -0.58026, -0.76542,
    0.20555, 0.54610, -0.40116, -0.35401,
]


def make_rocket_problem(N=15, device="cuda", dtype=torch.float64):
    """Model + solver with the reference rocket experiment settings, on the
    card unless `device` says otherwise."""
    from robust_nonlinear_mpc_torch.models.rocket import Rocket
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver

    device = checked_device(device)
    m = Rocket(dtype=dtype, device=device)
    Q = np.diag(
        [10.0, 10.0, 10.0,
         1.0, 1.0, 1.0,
         1.0, 1.0, 1.0, 1.0,
         1.0, 5.0, 5.0,
         1.0, 1.0, 1.0, 1.0]
    )
    R = np.diag([1.0, 1.0, 1.0, 1.0])
    Qf = 10 * Q
    m.dt = 0.05
    sigma_theta = np.deg2rad(2.0)
    q_vec_std = 0.5 * sigma_theta
    q_w_std = 0.1 * q_vec_std
    E = m.dt * np.diag(
        [0.20, 0.20, 0.20,
         0.2, 0.20, 0.20,
         q_vec_std, q_vec_std, q_vec_std, q_w_std,
         0.2, 0.2, 0.2,
         0.8, 0.2, 0.04, 0.04]
    )
    m.E = torch.as_tensor(E, dtype=dtype, device=device)
    solver = SCPSLSSolver(
        N, Q, R, m, Qf,
        Q_reg=1e4 * np.eye(m.nx), R_reg=1e4 * np.eye(m.nu),
        Q_reg_f=1e4 * np.eye(m.nx),
        rti=1, fast_sls_rti_steps=1, verbose=True,
        dtype=dtype, device=device,
    )
    return m, solver


def generate(N: int | None = None, sim_steps: int = 30, device="cuda"):
    from robust_nonlinear_mpc_torch.expe._common import save_results
    from robust_nonlinear_mpc_torch.sim.closed_loop import run_closed_loop

    np.random.seed(0)
    m, solver = make_rocket_problem(int(N) if N is not None else 15, device=device)
    results = run_closed_loop(m, solver, np.array(X0), sim_steps, noise="uniform",
                              rng=np.random.RandomState(0), verbose=True)
    return save_results(FOLDER, "rockETH_robust_closed_loop", results)


def plot(tube_frequency: int = 5, show: bool = True):
    """The 2x3 rocket figure of the newest run: five grouped state panels
    and one normalized-input panel; every `tube_frequency`-th step's
    predicted horizon as an alpha-gradient tube fan (fading along the
    horizon, earlier fans more opaque), constraint lines in red, the
    closed-loop trajectory on top. Saves trajectory_plot_closed_loop.{pdf,png}
    next to the npz. The bounds are the run's own (its saved g)."""
    import os

    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from robust_nonlinear_mpc_torch.expe._common import load_latest
    from robust_nonlinear_mpc_torch.models.rocket import Rocket, split_box_bounds
    from robust_nonlinear_mpc_torch.utils.plotting import (
        affine_to_unit,
        draw_alpha_gradient_tube,
        halfwidth_to_unit,
    )

    sol = load_latest(FOLDER)
    if sol is None:
        print("No data files found in the directory.")
        return None
    nx, nu = int(sol["nx"]), int(sol["nu"])
    dt = float(sol["dt"])
    T = int(sol["simulation_time_steps"])
    N = int(sol["N"])
    nom_x = sol["nominal_trajectory_x"]
    nom_u = sol["nominal_trajectory_u"]
    bo_x = sol["backoff_trajectory_x"]
    bo_u = sol["backoff_trajectory_u"]
    X_all = sol["state_trajectory"]
    U_all = sol["input_trajectory"]
    lb_x, ub_x, lb_u, ub_u = split_box_bounds(sol["g"], nx, nu)

    groups = list(Rocket.state_groups.items())[:5]
    glabels = Rocket._GROUP_LABELS
    gylabs = Rocket._GROUP_YLABELS[:4] + ["Actuators (norm.) [-]"]
    input_labels = [r"$T_{in}$", r"$\tau_{in}$", r"$\theta_{1,in}$", r"$\theta_{2,in}$"]
    viridis = plt.cm.viridis
    grid_kw = dict(alpha=0.3, linestyle="--")

    fig, axs = plt.subplots(2, 3, figsize=(20, 10), sharex=True)
    axs = axs.flatten()

    # horizon tube fans, every tube_frequency-th step
    a_start, a_end = 0.35, 0.05
    denom_t = max(1, T - 1)
    for i in range(0, T, tube_frequency):
        t_h = (i + np.arange(N + 1)) * dt
        scale = 1.0 - 0.4 * (i / denom_t)    # later fans fade overall
        zi = 1.0 + (denom_t - i) * 1e-3
        for k, (ax, (name, sl)) in enumerate(zip(axs[:5], groups)):
            colors = viridis(np.linspace(0.3, 0.7, sl.stop - sl.start))
            for ci, idx in enumerate(range(sl.start, sl.stop)):
                c = nom_x[idx, :, i]
                b = bo_x[idx, :, i]
                if k == 4:  # actuator panel normalized to [-1, 1]
                    c = affine_to_unit(c, lb_x[idx], ub_x[idx])
                    b = halfwidth_to_unit(b, lb_x[idx], ub_x[idx])
                draw_alpha_gradient_tube(axs[k], t_h, c - b, c + b, colors[ci],
                                         a_start=a_start * scale, a_end=a_end * scale, zorder=zi)
        t_u = t_h[:-1]
        colors_u = viridis(np.linspace(0.3, 0.7, nu))
        for j in range(nu):
            c = affine_to_unit(nom_u[j, :, i], lb_u[j], ub_u[j])
            b = halfwidth_to_unit(bo_u[j, :, i], lb_u[j], ub_u[j])
            draw_alpha_gradient_tube(axs[5], t_u, c - b, c + b, colors_u[j],
                                     a_start=a_start * scale, a_end=a_end * scale, zorder=zi)

    # the closed loop on top
    t_all = np.arange(T) * dt
    styles = ["-", "--", "-.", ":"]
    for k, (ax, (name, sl)) in enumerate(zip(axs[:5], groups)):
        colors = viridis(np.linspace(0.3, 0.7, sl.stop - sl.start))
        for ci, (idx, lbl) in enumerate(zip(range(sl.start, sl.stop), glabels[k])):
            x = X_all[idx]
            if k == 4:
                x = affine_to_unit(x, lb_x[idx], ub_x[idx])
            ax.plot(t_all, x, label=lbl, linewidth=2.5, color=colors[ci],
                    linestyle=styles[ci % 4])
            if k in (1, 3):  # vel / omega: absolute constraint lines
                ax.hlines([lb_x[idx], ub_x[idx]], t_all[0], t_all[-1], colors="red",
                          linestyles=[":"], linewidth=2.5)
        if k == 4:
            ax.hlines([-1, 1], t_all[0], t_all[-1], colors="red", linestyles=[":"],
                      linewidth=2.5)
            ax.set_ylim(-1.1, 1.1)
        ax.set_ylabel(gylabs[k])
        ax.grid(True, **grid_kw)
        ax.legend(loc="best", fontsize=11)

    colors_u = viridis(np.linspace(0.3, 0.7, nu))
    for j in range(nu):
        u = affine_to_unit(U_all[j], lb_u[j], ub_u[j])
        axs[5].plot(t_all[:-1], u, label=input_labels[j], linewidth=2.5, color=colors_u[j],
                    linestyle=styles[j % 4])
    axs[5].hlines([-1, 1], t_all[0], t_all[-1], colors="red", linestyles=[":"], linewidth=2.5)
    axs[5].set_ylim(-1.1, 1.1)
    axs[5].set_ylabel("Inputs (norm.) [-]")
    axs[5].grid(True, **grid_kw)
    axs[5].legend(loc="best", fontsize=11)
    for k in (3, 4, 5):
        axs[k].set_xlabel("Time [s]")

    fig.tight_layout(pad=1.5)
    for ext in ("pdf", "png"):
        fig.savefig(os.path.join(FOLDER, f"trajectory_plot_closed_loop.{ext}"),
                    dpi=300, bbox_inches="tight")
    if show:
        plt.show()
    return fig


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--run", action="store_true",
                   help="generate and save a run (else plot the newest run)")
    p.add_argument("--N", type=int, default=None)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.run:
        generate(args.N, args.steps, device=args.device)
    else:
        plot()
