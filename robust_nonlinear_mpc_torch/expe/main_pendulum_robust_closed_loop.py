"""Pendulum robust closed loop (port of
`robust_nonlinear_mpc_tpu/expe/main_pendulum_robust_closed_loop.py`: `--run`
generates a run, without it the newest run is plotted).

N = 15, Q = I, R = I, Qf = 10 I, Q_reg = R_reg = 1e3 I, Q_reg_f = 1e4 I,
rti = 3, fast_sls_rti_steps = 2, E = 0.003 I, dt = 0.05, x0 = [0.5, 0.5, 0,
0], 60 noise-free steps, float64.

Usage:  python -m robust_nonlinear_mpc_torch.expe.main_pendulum_robust_closed_loop --run
            [--N 15] [--steps 60] [--device cuda|cpu]
        python -m robust_nonlinear_mpc_torch.expe.main_pendulum_robust_closed_loop   # plot
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

FOLDER = "pendulum_robust_closed_loop"


def make_pendulum_problem(N=15, device="cuda", dtype=torch.float64, verbose=True):
    """Model + solver with the reference pendulum experiment settings."""
    from robust_nonlinear_mpc_torch.models.pendulum import Pendulum
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver

    m = Pendulum(dtype=dtype, device=device)
    m.E = torch.as_tensor(0.003 * np.eye(m.nx), dtype=dtype, device=m.G.device)
    m.dt = 0.05
    x_max = 10 * np.ones(m.nx)
    u_max = 5 * np.ones(m.nu)
    m.replace_constraints(x_max, -x_max, u_max, -u_max, x_max, -x_max)
    solver = SCPSLSSolver(
        N, np.eye(m.nx), np.eye(m.nu), m, 10 * np.eye(m.nx),
        Q_reg=1e3 * np.eye(m.nx), R_reg=1e3 * np.eye(m.nu), Q_reg_f=1e4 * np.eye(m.nx),
        rti=3, fast_sls_rti_steps=2, verbose=verbose, dtype=dtype, device=m.G.device,
    )
    return m, solver


def generate(N: int | None = None, sim_steps: int = 60, device="cuda"):
    from robust_nonlinear_mpc_torch.expe._common import save_results
    from robust_nonlinear_mpc_torch.sim.closed_loop import run_closed_loop

    np.random.seed(0)
    m, solver = make_pendulum_problem(int(N) if N is not None else 15, device=device)
    x0 = np.array([0.5, 0.5, 0.0, 0.0])
    results = run_closed_loop(m, solver, x0, sim_steps, noise="none", verbose=True)
    return save_results(FOLDER, "pendulum_robust_closed_loop", results)


def plot(show: bool = True):
    from robust_nonlinear_mpc_torch.expe._common import plot_closed_loop

    return plot_closed_loop(FOLDER, show=show)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--run", action="store_true",
                   help="generate and save a run (else plot the newest run)")
    p.add_argument("--N", type=int, default=None)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    if args.run:
        generate(args.N, args.steps, device=args.device)
    else:
        plot()
