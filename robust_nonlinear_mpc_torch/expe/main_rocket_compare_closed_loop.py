"""Rocket robust (SCP-SLS) against the soft-constrained NLP baseline (port of
`robust_nonlinear_mpc_tpu/expe/main_rocket_compare_closed_loop.py`).

Both controllers run from the same fixed x0 under the same constant
disturbance sequence W = -0.8 * ones: the robust one with RTI 1/1
(`make_rocket_problem`), reset warm start at every step after the first,
the soft one with rho_soft = rho_soft_l1 = 1e6 (`NLPSoftSolver`). The npz
holds both trajectories and the stage, terminal and total closed-loop costs.
Float64; on the card unless `--device cpu`.

Usage:  python -m robust_nonlinear_mpc_torch.expe.main_rocket_compare_closed_loop --run
            [--N 15] [--steps 30] [--device cuda|cpu]
        python -m robust_nonlinear_mpc_torch.expe.main_rocket_compare_closed_loop [--vel-omega]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
    X0,
    make_rocket_problem,
)

FOLDER = "rockETH_compare_closed_loop"


def _compute_closed_loop_cost(X_all, U_all, Q, R, Qf):
    """(stage, terminal, total) cost of a closed loop X (nx, T), U (nu, T-1)."""
    T = X_all.shape[1]
    J = 0.0
    for t in range(T - 1):
        J += float(X_all[:, t] @ Q @ X_all[:, t]) + float(U_all[:, t] @ R @ U_all[:, t])
    J_terminal = float(X_all[:, -1] @ Qf @ X_all[:, -1])
    return J, J_terminal, J + J_terminal


def generate(N: int = 15, T: int = 30, device="cuda", kkt: str | None = None):
    """Run both controllers for T - 1 steps and save the npz; returns its
    path. `kkt`: the robust solver's Newton solves (`IPMOptions.kkt`; its
    own default, "riccati", when None). Each step runs inside the stages
    "compare.robust" and "compare.soft" (`utils.stages`)."""
    from robust_nonlinear_mpc_torch.expe._common import save_results
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import NLPSoftSolver
    from robust_nonlinear_mpc_torch.utils.stages import stage

    x0 = np.array(X0)
    dtype = torch.float64
    m, robust_solver = make_rocket_problem(N, device=device, dtype=dtype)
    opts = robust_solver.opts._replace(verbose=False)
    if kkt is not None:
        opts = opts._replace(ipm=opts.ipm._replace(kkt=kkt))
    robust_solver.opts = opts
    host = lambda a: a.detach().cpu().numpy()
    Q, R, Qf = host(robust_solver.Q), host(robust_solver.R), host(robust_solver.Qf)
    E = host(m.E)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=m.G.device)

    # the same disturbance sequence for both controllers
    W = -0.8 * np.ones((T - 1, m.nx))

    def run(controller_step, name):
        X = np.zeros((m.nx, T))
        U = np.zeros((m.nu, T - 1))
        Xn = np.zeros((m.nx, N + 1, T - 1))
        Un = np.zeros((m.nu, N, T - 1))
        bx = np.zeros((m.nx, N + 1, T - 1))
        bu = np.zeros((m.nu, N, T - 1))
        x = x0.copy()
        X[:, 0] = x
        for i in range(T - 1):
            with stage(name):
                sol = controller_step(i, x)
            Xn[:, :, i] = sol["primal_x"]
            Un[:, :, i] = sol["primal_u"]
            if "backoff_x" in sol:
                bx[:, :, i] = sol["backoff_x"].T
                bu[:, :, i] = sol["backoff_u"].T
            u0 = sol["primal_u"][:, 0]
            U[:, i] = u0
            x = host(m.ddyn(as_t(x), as_t(u0))) + E @ W[i]
            X[:, i + 1] = x
        return dict(
            state_trajectory=X, input_trajectory=U,
            nominal_trajectory_x=Xn, nominal_trajectory_u=Un,
            backoff_trajectory_x=bx, backoff_trajectory_u=bu,
        )

    def robust_step(i, x):
        if i > 0:
            robust_solver.reset_warm_start()
        return robust_solver.solve(x)

    print("[compare] running robust SCP-SLS ...")
    robust_res = run(robust_step, "compare.robust")

    soft_solver = NLPSoftSolver(N, Q, R, m, Qf, rho_soft=1e6, rho_soft_l1=1e6)

    def soft_step(i, x):
        sol = soft_solver.solve(x)
        if not sol.get("success", False):
            if not np.all(np.isfinite(sol["primal_u"])):
                raise RuntimeError(f"Soft-constrained NLP failed at step {i}.")
            # persistent worst-case disturbances push the plant into
            # infeasible territory; the best iterate is still the baseline's
            # meaningful action
            print(f"[compare] soft NLP step {i}: accepting best iterate "
                  "(SQP not fully converged)")
        return sol

    print("[compare] running soft-constrained NLP baseline ...")
    soft_res = run(soft_step, "compare.soft")

    Jr_s, Jr_T, Jr = _compute_closed_loop_cost(
        robust_res["state_trajectory"], robust_res["input_trajectory"], Q, R, Qf)
    Js_s, Js_T, Js = _compute_closed_loop_cost(
        soft_res["state_trajectory"], soft_res["input_trajectory"], Q, R, Qf)
    print(f"[compare] robust closed-loop cost: {Jr:.4e}  (stage {Jr_s:.4e} + terminal {Jr_T:.4e})")
    print(f"[compare] soft   closed-loop cost: {Js:.4e}  (stage {Js_s:.4e} + terminal {Js_T:.4e})")

    results = {
        **{f"r_{k}": v for k, v in robust_res.items()},
        **{f"s_{k}": v for k, v in soft_res.items()},
        "dt": m.dt, "g": host(m.g), "nx": m.nx, "nu": m.nu,
        "simulation_time_steps": T, "N": N, "x0": x0, "W": W,
        "Jr_stage": Jr_s, "Jr_terminal": Jr_T, "Jr_total": Jr,
        "Js_stage": Js_s, "Js_terminal": Js_T, "Js_total": Js,
    }
    return save_results(FOLDER, "rockETH_compare_closed_loop", results)


def plot(show: bool = True):
    """States (solid robust, dashed soft) and inputs of the newest run."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from robust_nonlinear_mpc_torch.expe._common import load_latest
    from robust_nonlinear_mpc_torch.utils.plotting import add_footnote_time

    data = load_latest(FOLDER)
    if data is None:
        print("No data files found in the directory.")
        return None
    dt = float(data["dt"])
    T = int(data["simulation_time_steps"])
    t = np.arange(T) * dt
    fig, axes = plt.subplots(2, 1, figsize=(12, 9), sharex=True)
    nx = int(data["nx"])
    colors = plt.cm.viridis(np.linspace(0, 1, nx + 2))
    for i in range(nx):
        axes[0].plot(t, data["r_state_trajectory"][i], color=colors[i + 1])
        axes[0].plot(t, data["s_state_trajectory"][i], "--", color=colors[i + 1])
    axes[0].set_ylabel("states (solid robust, dashed soft)")
    for j in range(int(data["nu"])):
        axes[1].plot(t[:-1], data["r_input_trajectory"][j], label=f"u{j} robust")
        axes[1].plot(t[:-1], data["s_input_trajectory"][j], "--", label=f"u{j} soft")
    axes[1].legend(ncol=4, fontsize=8)
    axes[1].set_xlabel("time [s]")
    axes[1].set_ylabel("inputs")
    fig.suptitle(
        f"robust J = {float(data['Jr_total']):.3e}   soft J = {float(data['Js_total']):.3e}"
    )
    add_footnote_time(fig)
    if show:
        plt.show()
    return fig


def plot_vel_omega_inputs(show: bool = True):
    """Velocity / angular-velocity comparison figure with compact dual
    legends: robust solid, soft dashed, one color per variable, red
    constraint lines. Saves trajectory_plot_compare_vel_omega.pdf next to
    the npz."""
    import os

    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from robust_nonlinear_mpc_torch.expe._common import load_latest
    from robust_nonlinear_mpc_torch.utils.plotting import compact_dual_legend

    data = load_latest(FOLDER)
    if data is None:
        print("No data files found in the directory.")
        return None

    g = data["g"]
    nx, nu = int(data["nx"]), int(data["nu"])
    dt = float(data["dt"])
    Xr = data["r_state_trajectory"]
    Xs = data["s_state_trajectory"]
    ub_x = g[:nx]
    lb_x = -g[nx + nu:nx + nu + nx]

    viridis = plt.cm.viridis
    grid_kw = dict(alpha=0.3, linestyle="--")
    t = np.arange(Xr.shape[1]) * dt
    fig, axs = plt.subplots(1, 2, figsize=(10, 5))
    panels = [
        (axs[0], range(3, 6), [r"$v_x$", r"$v_y$", r"$v_z$"], "Velocity [m/s]"),
        (axs[1], range(10, 13), [r"$\omega_x$", r"$\omega_y$", r"$\omega_z$"],
         "Angular vel. [rad/s]"),
    ]
    for ax, idxs, lbls, ylab in panels:
        colors = viridis(np.linspace(0.3, 0.7, len(lbls)))
        for idx, lbl, color in zip(idxs, lbls, colors):
            ax.plot(t, Xr[idx], label=f"{lbl} (robust)", linewidth=2.5, color=color,
                    linestyle="-")
            ax.plot(t, Xs[idx], label=f"{lbl} (soft)", linewidth=2.5, color=color,
                    linestyle="--")
            ax.hlines([lb_x[idx], ub_x[idx]], t[0], t[-1], colors="red", linestyles=[":"],
                      linewidth=2.5)
        ax.set_ylabel(ylab)
        ax.set_xlabel("Time [s]")
        ax.grid(True, **grid_kw)
        compact_dual_legend(ax, ncol=3)

    fig.tight_layout(pad=1.2)
    fig.savefig(os.path.join(FOLDER, "trajectory_plot_compare_vel_omega.pdf"),
                dpi=300, bbox_inches="tight")
    if show:
        plt.show()
    return fig


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--run", action="store_true",
                   help="generate and save a run (else plot the newest run)")
    p.add_argument("--N", type=int, default=15)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--vel-omega", action="store_true",
                   help="plot the velocity/omega comparison figure")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.run:
        generate(args.N, args.steps, device=args.device)
    elif args.vel_omega:
        plot_vel_omega_inputs()
    else:
        plot()
