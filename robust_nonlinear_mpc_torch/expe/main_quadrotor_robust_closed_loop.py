"""Quadrotor robust closed loop (port of
`robust_nonlinear_mpc_tpu/expe/main_quadrotor_robust_closed_loop.py`:
`--run` generates a run, without it the newest run is plotted).

N = 15, Q = diag(10,10,10, 1,1,1, 1,1,1,1, 2,2,2), R = I, Qf = 10 Q,
regularizers 1e4 I, rti = 3, fast_sls_rti_steps = 2, E = dt*5*diag(...), 30
noise-free steps, float64, x0 drawn within half the state bounds with a unit
quaternion from `np.random.default_rng(seed)`.

Usage:  python -m robust_nonlinear_mpc_torch.expe.main_quadrotor_robust_closed_loop --run
            [--N 15] [--steps 30] [--device cuda|cpu]
        python -m robust_nonlinear_mpc_torch.expe.main_quadrotor_robust_closed_loop   # plot
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

FOLDER = "quadrotor_robust_closed_loop"
Q_DIAG = [10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0]


def make_quadrotor_problem(N=15, device="cuda", dtype=torch.float64, verbose=True):
    """Model + solver with the reference quadrotor experiment settings."""
    from robust_nonlinear_mpc_torch.models.quadrotor import Quadrotor
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver

    m = Quadrotor(dtype=dtype, device=device)
    Q = np.diag(Q_DIAG)
    m.dt = 0.05
    sigma_theta = np.deg2rad(2.0)
    q_vec_std = 0.5 * sigma_theta
    q_w_std = 0.1 * q_vec_std
    E = m.dt * 5 * np.diag(
        [0.10, 0.10, 0.10,
         0.15, 0.15, 0.15,
         q_w_std, q_vec_std, q_vec_std, q_vec_std,
         0.2, 0.2, 0.2]
    )
    m.E = torch.as_tensor(E, dtype=dtype, device=m.G.device)
    solver = SCPSLSSolver(
        N, Q, np.eye(4), m, 10 * Q,
        Q_reg=1e4 * np.eye(m.nx), R_reg=1e4 * np.eye(m.nu), Q_reg_f=1e4 * np.eye(m.nx),
        rti=3, fast_sls_rti_steps=2, verbose=verbose, dtype=dtype, device=m.G.device,
    )
    return m, solver


def random_x0(m, seed=1234):
    """x0 within half the state bounds with a unit quaternion."""
    g = m.g.cpu().numpy()
    ub_x = g[: m.nx]
    lb_x = -g[m.nx + m.nu : m.nx + m.nu + m.nx]
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(lb_x / 2, ub_x / 2)
    q_rand = rng.normal(size=4)
    nrm = np.linalg.norm(q_rand)
    x0[6:10] = q_rand / nrm if nrm > 1e-12 else np.array([1.0, 0, 0, 0])
    return x0


def generate(N: int | None = None, sim_steps: int = 30, seed: int | None = 1234, device="cuda"):
    from robust_nonlinear_mpc_torch.expe._common import save_results
    from robust_nonlinear_mpc_torch.sim.closed_loop import run_closed_loop

    np.random.seed(0)
    m, solver = make_quadrotor_problem(int(N) if N is not None else 15, device=device)
    results = run_closed_loop(m, solver, random_x0(m, seed), sim_steps, noise="none",
                              verbose=True)
    return save_results(FOLDER, "quadrotor_robust_closed_loop", results)


def plot(show: bool = True):
    from robust_nonlinear_mpc_torch.expe._common import plot_closed_loop

    return plot_closed_loop(FOLDER, show=show)


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
